"""Single-image shape reconstruction CLI (the shape task of ``demo.py``, fast path).

    python -m zeroshape_tpu_torch.demo --yaml=options/shape.yaml --datadir=examples \\
        [--eval.vox_res=128] [--ckpt=<reference .ckpt>] [--device=cpu]

Each ``<datadir>/images/<name>.png|jpg`` with its ``<datadir>/masks/<name>.png``
is cropped around the mask (1.2x square), resized to the model input,
composited on the background colour, and reconstructed through
``recon.reconstruct`` (hierarchical decode through the fused decoder
kernel on CUDA). The mesh goes to ``<datadir>/preds/<name>_mesh.ply``.

Without ``--ckpt`` the weights are seeded random and the logits sharpened
x25 (the benchmark's proxy for a trained field). The attention GIFs of the
JAX demo (``eval.dump_attn``) are not ported yet. PIL is imported here
only, PyYAML only to read the ``--yaml`` file.
"""

from __future__ import annotations

import os
import shutil
import sys
import time

import numpy as np
import torch

from zeroshape_tpu_torch import recon, weights
from zeroshape_tpu_torch.config import load_options, override_options, parse_arguments
from zeroshape_tpu_torch.ops.marching_cubes import marching_cubes_mesh, write_ply_mesh


# ---------------------------------------------------------------------------
# Inputs (a copy of demo.py:28-44 and data/common.py)
# ---------------------------------------------------------------------------

def _bbox(mask):
    """(x0, y0, x1, y1) tight bbox of mask > 0.5."""
    m = mask > 0.5
    if not m.any():
        raise ValueError("empty mask")
    xs, ys = np.flatnonzero(m.any(axis=0)), np.flatnonzero(m.any(axis=1))
    return xs[0], ys[0], xs[-1], ys[-1]


def _square_crop(arr, bbox, expand=1.2):
    """1.2x square crop around the bbox; out-of-bounds regions become zeros."""
    x1, y1, x2, y2 = bbox
    yc, xc = (y1 + y2) / 2, (x1 + x2) / 2
    S = max(y2 - y1, x2 - x1) * expand
    top, left, size = int(yc - S / 2), int(xc - S / 2), int(S)
    out = np.zeros((size, size) + arr.shape[2:], arr.dtype)
    y0, x0 = max(top, 0), max(left, 0)
    y1_, x1_ = min(top + size, arr.shape[0]), min(left + size, arr.shape[1])
    if y1_ > y0 and x1_ > x0:
        out[y0 - top : y1_ - top, x0 - left : x1_ - left] = arr[y0:y1_, x0:x1_]
    return out


def get_image(opt, image_fname, mask_fname):
    """(rgb [H, W, 3], mask [H, W, 1]) float32 in [0, 1]."""
    import PIL.Image

    image = PIL.Image.open(image_fname).convert("RGB")
    mask = PIL.Image.open(mask_fname).convert("L")
    mask_np = (np.asarray(mask) >= 127).astype(np.float32)
    rgba = PIL.Image.merge("RGBA", (*image.split(), mask))
    rgba = PIL.Image.fromarray(_square_crop(np.asarray(rgba), _bbox(mask_np)))
    if rgba.size != (opt.W, opt.H):
        rgba = rgba.resize((opt.W, opt.H))
    arr = np.asarray(rgba, dtype=np.float32) / 255.0
    rgb, m = arr[..., :3], arr[..., 3:]
    if opt.get("data", {}).get("bgcolor") is not None:
        rgb = rgb * m + opt.data.bgcolor * (1 - m)
        m = (m > 0.5).astype(np.float32)
    return rgb, m


def main(argv=None):
    opt = parse_arguments(sys.argv[1:] if argv is None else argv)
    opt = override_options(load_options(opt.yaml), opt) if opt.get("yaml") else opt
    if opt.get("task", "shape") != "shape":
        raise ValueError("only the shape task is ported")
    opt.H, opt.W = opt.image_size
    if opt.eval.get("dump_attn", True):
        print("note: attention GIFs are not ported; writing meshes only")

    model = recon.build(opt, device=opt.get("device"), seed=opt.get("seed") or 0)
    if opt.get("ckpt"):
        ckpt = torch.load(opt.ckpt, map_location="cpu", weights_only=False)
        weights.load(model.graph, ckpt.get("graph", ckpt))
        model.sharpen = 1.0  # a trained field is already saturated
        model.repack()
        print(f"==> checkpoint loaded: {opt.ckpt}")

    img_dir = os.path.join(opt.datadir, "images")
    names = sorted(n for n in os.listdir(img_dir) if n.endswith((".png", ".jpg")))
    save_folder = os.path.join(opt.datadir, "preds")
    shutil.rmtree(save_folder, ignore_errors=True)
    os.makedirs(save_folder)
    vox = opt.eval.vox_res
    lo, hi = opt.eval.range
    gen = torch.Generator(device=model.device).manual_seed(0)
    per_image_s = []
    for i, image_name in enumerate(names):
        name = image_name[:-4]
        rgb, m = get_image(opt, os.path.join(img_dir, image_name), os.path.join(opt.datadir, "masks", name + ".png"))
        t0 = time.perf_counter()
        *_, level = recon.reconstruct(
            model, {"rgb_input_map": rgb[None], "mask_input_map": m[None]}, gen, vox_res=vox,
            capacity=opt.eval.get("hier_capacity"), num_points=opt.eval.num_points, rng=(lo, hi),
            return_level=True,
        )
        level = level[0].float().cpu().numpy()  # the host copy closes the timing window
        per_image_s.append(time.perf_counter() - t0)
        verts, faces = marching_cubes_mesh(level)
        write_ply_mesh(os.path.join(save_folder, f"{name}_mesh.ply"), verts / (vox + 1) * (hi - lo) + lo, faces)
        print(f"[{i + 1}/{len(names)}] {name} done ({per_image_s[-1]:.3f} s recon, {len(faces)} faces)")
    if len(per_image_s) > 1:
        print(f"==> reconstruction: {np.median(per_image_s[1:]):.3f} s/image steady-state "
              f"(first: {per_image_s[0]:.3f} s)")
    print(f"==> results saved at folder: {save_folder}")


if __name__ == "__main__":
    main()
