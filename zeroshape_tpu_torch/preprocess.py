"""Background removal, then a recentred square crop (counterpart of ``preprocess.py``).

    python -m zeroshape_tpu_torch.preprocess --indir=raw_images [--outdir=my_examples] [--size=224]

Each ``.png`` / ``.jpg`` / ``.jpeg`` of ``--indir``, in name order: segment
the salient object, crop a 1.2x square around it, resize it to ``--size``
and write ``images/<stem>.png`` (RGB) and ``masks/<stem>.png`` (L) under
``--outdir``: what the demo reads. The files, names, order and messages are
the JAX CLI's.

Segmentation is rembg where it is installed, else OpenCV's GrabCut seeded
from a rectangle 5% inside the border (the JAX CLI's exact call: rembg's
model is downloaded at first use, so GrabCut keeps the CLI usable offline).
This is the one place the port imports cv2, lazily, as it imports rembg:
an own copy of GrabCut would segment differently. With neither installed
the CLI raises and names both.

Reading: PNG through the port's decoder (``data.common.load_image``, alpha
dropped as PIL's ``convert("RGB")`` drops it); JPEG through ``cv2.imdecode``
without EXIF rotation (PIL's ``Image.open`` does not rotate either).
Resizing: PIL's premultiplied bicubic RGBA resize as the demo reproduces it
(``data.common.resize_rgba``, within 3/255). Writing: the port's PNG writer.
"""

from __future__ import annotations

import argparse
import importlib.util
import os

import numpy as np

from zeroshape_tpu_torch.data import common


def segment_rembg(rgb):
    """Alpha ``[H, W]`` uint8 of rembg's foreground for uint8 RGB ``[H, W, 3]``."""
    from rembg import remove

    return np.asarray(remove(rgb))[..., 3]


def segment_grabcut(rgb, iters=5):
    """Foreground ``[H, W]`` (255 / 0) of OpenCV's GrabCut on uint8 RGB ``[H, W,
    3]``, initialised with the rectangle 5% inside the border."""
    import cv2

    arr = np.ascontiguousarray(rgb[:, :, ::-1])
    mask = np.zeros(arr.shape[:2], np.uint8)
    h, w = mask.shape
    rect = (int(w * 0.05), int(h * 0.05), int(w * 0.9), int(h * 0.9))
    bgd, fgd = np.zeros((1, 65), np.float64), np.zeros((1, 65), np.float64)
    cv2.grabCut(arr, mask, rect, bgd, fgd, iters, cv2.GC_INIT_WITH_RECT)
    fg = np.where((mask == cv2.GC_FGD) | (mask == cv2.GC_PR_FGD), 255, 0)
    return fg.astype(np.uint8)


def segmenter():
    """``(segment, message)``: rembg where installed, else GrabCut; raises
    where neither rembg nor cv2 can be imported."""
    if importlib.util.find_spec("rembg") is not None:
        return segment_rembg, "using rembg for background removal"
    if importlib.util.find_spec("cv2") is not None:
        return segment_grabcut, "rembg not installed; using cv2 GrabCut fallback"
    raise RuntimeError("background removal needs rembg or OpenCV (cv2); neither is installed")


def read_rgb(path):
    """uint8 RGB ``[H, W, 3]`` of a PNG (the port's decoder) or a JPEG (cv2, no EXIF rotation)."""
    if path.lower().endswith(".png"):
        return common.load_image(path, mode="RGB")
    import cv2

    bgr = cv2.imdecode(np.fromfile(path, np.uint8), cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
    if bgr is None:
        raise ValueError(f"cannot decode {path}")
    return np.ascontiguousarray(bgr[:, :, ::-1])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--indir", required=True)
    ap.add_argument("--outdir", default="my_examples")
    ap.add_argument("--size", type=int, default=224)
    args = ap.parse_args(argv)

    os.makedirs(os.path.join(args.outdir, "images"), exist_ok=True)
    os.makedirs(os.path.join(args.outdir, "masks"), exist_ok=True)
    segment, message = segmenter()
    print(message)

    names = [n for n in sorted(os.listdir(args.indir)) if n.lower().endswith((".png", ".jpg", ".jpeg"))]
    for name in names:
        rgb = read_rgb(os.path.join(args.indir, name))
        alpha = segment(rgb)
        mask = (alpha > 127).astype(np.float32)
        bbox = common.get_bbox_from_mask(mask, 0.5)
        if bbox is None:
            print(f"skipping {name}: empty mask")
            continue
        rgba = np.concatenate([rgb, (mask * 255).astype(np.uint8)[..., None]], axis=-1)
        crop = common.square_crop(rgba, bbox)
        if crop.shape[:2] != (args.size, args.size):
            crop = common.resize_rgba(crop, (args.size, args.size))
        stem = os.path.splitext(name)[0]
        common.write_png(os.path.join(args.outdir, "images", stem + ".png"), crop[..., :3])
        common.write_png(os.path.join(args.outdir, "masks", stem + ".png"), crop[..., 3])
        print(f"processed {name}")
    print(f"wrote {args.outdir}/images and {args.outdir}/masks")


if __name__ == "__main__":
    main()
