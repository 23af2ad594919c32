"""Single-image inference CLI (counterpart of ``demo.py``), both tasks.

    python -m zeroshape_tpu_torch.demo --task=shape --datadir=examples [--eval.vox_res=128] [--ckpt=FILE] \\
        [--eval.dump_attn!] [--device=cpu]
    python -m zeroshape_tpu_torch.demo --task=depth --datadir=examples [--ckpt=FILE]
    python -m zeroshape_tpu_torch.demo --yaml=options/shape.yaml --task=shape --datadir=examples ...

Each ``<datadir>/images/<name>.png|jpg`` with its ``<datadir>/masks/<name>.png``
is cropped around the mask (1.2x square), resized to the model input,
composited on the background colour, and reconstructed. The files go to
``<datadir>/preds/`` (emptied first), under the JAX demo's names:

* shape task, ``eval.dump_attn`` (the default): one dense decode of the
  ``(vox_res + 1)^3`` grid with attention (``recon.reconstruct_with_attn``);
  ``{name}_image_input.png``, ``_mask_input.png``, ``_attn.gif`` (the
  attention sweep), ``_mesh.ply`` and ``_mesh_viz.gif`` (a turntable);
* shape task, ``--eval.dump_attn!``: the fast path, ``recon.reconstruct``
  (coarse-to-fine, the fused decoder kernel on CUDA); the same files but
  the attention GIF;
* depth task: ``_image_input.png``, ``_mask_input.png``, ``_depth_est.png``
  and the textured seen surfaces ``_seen_surface_fixed.obj/.mtl`` and
  ``_seen_surface_pred.obj/.mtl``, unprojected with the fixed and the
  predicted intrinsics.

Options: ``--yaml`` (read with PyYAML, imported for it only) or, where
PyYAML is missing, the task's preset: ``config.eval_opt(config.full_opt())``
(the shipped shape model and the eval section of ``options/shape.yaml``,
``eval.dump_attn`` on) or ``config.depth_opt()`` (``options/depth.yaml``).
Without ``--ckpt`` the weights are seeded random and the shape logits
sharpened x25 (the benchmark's proxy for a trained field). ``--ckpt`` is a
reference ``.ckpt`` read with ``weights_only=True`` (``runtime/checkpoint``):
a file that pickles anything besides tensors is refused, and one that lacks
keys of the task's graph raises. Nothing here imports PIL, cv2 or matplotlib.
"""

from __future__ import annotations

import os
import shutil
import sys
import time

import numpy as np
import torch

from zeroshape_tpu_torch import camera, config, recon, resolve_device, vis
from zeroshape_tpu_torch.config import load_options, override_options, parse_arguments
from zeroshape_tpu_torch.data import common
from zeroshape_tpu_torch.metrics.eval3d import attention_frames
from zeroshape_tpu_torch.models import resolve_compute_dtype
from zeroshape_tpu_torch.models.graph_depth import DepthGraph
from zeroshape_tpu_torch.ops.marching_cubes import marching_cubes_mesh
from zeroshape_tpu_torch.runtime import checkpoint
from zeroshape_tpu_torch.weights import init_like_flax


# ---------------------------------------------------------------------------
# Inputs (demo.py:28-68)
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


def crop_rgba(image_fname, mask_fname):
    """The image (RGB) with its mask (L) as alpha, uint8 RGBA, cropped 1.2x
    square around the mask's box (``mask >= 127``)."""
    image = common.load_image(image_fname, mode="RGB")
    mask = common.load_image(mask_fname, mode="L")
    return _square_crop(np.concatenate([image, mask], axis=-1), _bbox((mask[..., 0] >= 127).astype(np.float32)))


def resize_rgba(rgba, out_hw):
    """PIL's resize of an RGBA image: to premultiplied ``RGBa``
    (``c * a / 255`` rounded), resized (``common.resize_u8``), and back
    (``255 * c // a``, clipped; unchanged where a is 0 or 255)."""
    a = rgba[..., 3:].astype(np.int32)
    t = rgba[..., :3].astype(np.int32) * a + 128
    pm = np.concatenate([((t >> 8) + t) >> 8, a], axis=-1).astype(np.uint8)
    out = common.resize_u8(pm, out_hw).astype(np.int32)
    a = out[..., 3:]
    rgb = np.where((a == 0) | (a == 255), out[..., :3], np.minimum(255 * out[..., :3] // np.maximum(a, 1), 255))
    return np.concatenate([rgb, a], axis=-1).astype(np.uint8)


def get_image(opt, image_fname, mask_fname):
    """(rgb [H, W, 3], mask [H, W, 1]) float32 in [0, 1]."""
    rgba = crop_rgba(image_fname, mask_fname)
    if rgba.shape[:2] != (opt.H, opt.W):
        rgba = resize_rgba(rgba, (opt.H, opt.W))
    arr = rgba.astype(np.float32) / 255.0
    rgb, m = arr[..., :3], arr[..., 3:]
    if opt.get("data", {}).get("bgcolor") is not None:
        rgb = rgb * m + opt.data.bgcolor * (1 - m)
        m = (m > 0.5).astype(np.float32)
    return rgb, m


def prepare_data(opt):
    """``(samples, names)``: each image's ``rgb_input_map [1, H, W, 3]``,
    ``mask_input_map [1, H, W, 1]``, fixed ``intr [1, 3, 3]`` and ``idx``
    (1-based), in file-name order."""
    img_dir = os.path.join(opt.datadir, "images")
    names = sorted(n for n in os.listdir(img_dir) if n.endswith((".png", ".jpg")))
    samples = []
    for i, image_name in enumerate(names):
        rgb, m = get_image(opt, os.path.join(img_dir, image_name),
                           os.path.join(opt.datadir, "masks", image_name[:-4] + ".png"))
        samples.append({"rgb_input_map": rgb[None], "mask_input_map": m[None],
                        "intr": common.fixed_intrinsics(opt.H, opt.W)[None], "idx": np.asarray([i + 1], np.int64)})
    return samples, [n[:-4] for n in names]


# ---------------------------------------------------------------------------
# Options, weights
# ---------------------------------------------------------------------------

def options(argv):
    """The ``--yaml`` file or the task's preset, with the CLI over it; the
    task of the file's name must be ``--task``'s (demo.py:73-77)."""
    cli = parse_arguments(argv)
    if cli.get("yaml"):
        opt = override_options(load_options(cli.yaml), cli)
        if os.path.basename(opt.yaml).split(".")[0].split("_")[0] != opt.get("task"):
            raise ValueError("Detected different tasks between specified and the yaml, please double check!")
    elif cli.get("task", "shape") == "depth":
        opt = override_options(config.depth_opt(), cli)
    else:
        opt = override_options(config.eval_opt(config.full_opt()), {"task": "shape", "seed": 0, "arch": {"dtype": "auto"}})
        opt = override_options(opt, cli)
    if opt.get("task") not in ("shape", "depth"):
        raise ValueError(f"the task is shape or depth, not {opt.get('task')!r}")
    if opt.get("image_size"):
        opt.H, opt.W = opt.image_size
    return opt


def load_ckpt(graph, ckpt, path):
    """``--ckpt`` (read by :func:`main`, tensors only, before the graph was
    built) into the task's graph: every key of the graph present
    (``checkpoint.apply_weights(strict=True)``); prints the JAX demo's resume
    line where the file has its counters."""
    meta = checkpoint.apply_weights(graph, ckpt, strict=True, path=path)
    if meta.get("epoch") is not None:
        print("resuming from epoch {} (iteration {}, best_val {:.4f})".format(
            meta["epoch"] + 1, meta["iter"], meta["best_val"]))
    print("==> checkpoint loaded")


# ---------------------------------------------------------------------------
# The two tasks
# ---------------------------------------------------------------------------

def _shape(opt, samples, names, ckpt):
    model = recon.build(opt, device=opt.get("device"), seed=opt.get("seed") or 0)
    if ckpt is not None:
        load_ckpt(model.graph, ckpt, opt.ckpt)
        model.sharpen = 1.0  # a trained field is already saturated
        model.repack()
    vox, (lo, hi) = opt.eval.vox_res, opt.eval.range
    dump_attn = bool(opt.eval.get("dump_attn", True))
    per_image_s = []
    for i, (var, name) in enumerate(zip(samples, names)):
        gen = torch.Generator(device=model.device).manual_seed(i)
        batch = {k: var[k] for k in ("rgb_input_map", "mask_input_map")}
        t0 = time.perf_counter()
        if dump_attn:
            _, level, _, attn = recon.reconstruct_with_attn(model, batch, gen, vox_res=vox,
                                                            num_points=opt.eval.num_points, rng=(lo, hi))
        else:
            *_, level = recon.reconstruct(model, batch, gen, vox_res=vox, capacity=opt.eval.get("hier_capacity"),
                                          num_points=opt.eval.num_points, rng=(lo, hi), return_level=True)
        level = level[0].float().cpu().numpy()  # the host copy closes the timing window
        per_image_s.append(time.perf_counter() - t0)
        verts, faces = marching_cubes_mesh(level)
        mesh = (verts / (vox + 1) * (hi - lo) + lo, faces)
        vis.dump_images(opt.datadir, [name], "image_input", var["rgb_input_map"], folder="preds")
        vis.dump_images(opt.datadir, [name], "mask_input", var["mask_input_map"], folder="preds")
        if dump_attn:
            frames = attention_frames(attn[0].cpu().numpy(), var["rgb_input_map"][0], vox, opt.H // opt.arch.win_size)
            vis.dump_attentions(opt.datadir, [name], "attn", [frames], folder="preds")
        vis.dump_meshes(opt.datadir, [name], "mesh", [mesh], folder="preds")
        vis.dump_meshes_viz(opt.datadir, [name], "mesh_viz", [mesh], folder="preds", device=model.device)
        print(f"[{i + 1}/{len(samples)}] {name} done ({per_image_s[-1]:.3f} s recon)")
    return per_image_s


def _depth(opt, samples, names, ckpt):
    dev = resolve_device(opt.get("device"))
    graph = DepthGraph.from_opt(opt, dtype=resolve_compute_dtype(opt, dev))
    graph = init_like_flax(graph, opt.get("seed") or 0).to(dev).eval()
    if ckpt is not None:
        load_ckpt(graph, ckpt, opt.ckpt)
    per_image_s = []
    for i, (var, name) in enumerate(zip(samples, names)):
        batch = {k: torch.as_tensor(var[k], device=dev) for k in ("rgb_input_map", "mask_input_map", "intr")}
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = graph(batch, train=False)
            depth = out["depth_pred"][..., 0].float()  # [1, H, W]
            seen_fixed = camera.unproj_depth(depth, batch["intr"]).reshape(opt.H, opt.W, 3).cpu().numpy()
            seen_pred = camera.unproj_depth(depth, out["intr_pred"]).reshape(opt.H, opt.W, 3).cpu().numpy()
        per_image_s.append(time.perf_counter() - t0)
        m = var["mask_input_map"][0]
        seen_fixed = seen_fixed * m + (1 - m) * -1
        seen_pred = seen_pred * m + (1 - m) * -1
        vis.dump_images(opt.datadir, [name], "image_input", var["rgb_input_map"], folder="preds")
        vis.dump_images(opt.datadir, [name], "mask_input", var["mask_input_map"], folder="preds")
        vis.dump_depths(opt.datadir, [name], "depth_est", out["depth_pred"], var["mask_input_map"], rescale=True,
                        folder="preds")
        vis.dump_seen_surface(opt.datadir, [name], "seen_surface_fixed", "image_input", [seen_fixed], folder="preds")
        vis.dump_seen_surface(opt.datadir, [name], "seen_surface_pred", "image_input", [seen_pred], folder="preds")
        print(f"[{i + 1}/{len(samples)}] {name} done ({per_image_s[-1]:.3f} s recon)")
    return per_image_s


def main(argv=None):
    """Run the demo; returns the seconds each image took (the reconstruction
    up to its host copy, as the JAX demo times it)."""
    opt = options(sys.argv[1:] if argv is None else argv)
    resolve_device(opt.get("device"))
    # read first: a file that is refused costs no model build
    ckpt = checkpoint.load_reference_ckpt(opt.ckpt) if opt.get("ckpt") else None
    samples, names = prepare_data(opt)
    print(f"==> sample data loaded from folder: {opt.datadir}")
    out_dir = os.path.join(opt.datadir, "preds")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    per_image_s = (_depth if opt.task == "depth" else _shape)(opt, samples, names, ckpt)
    if len(per_image_s) > 1:
        # the first image includes the warm-up; the steady state is the headline number
        print(f"==> reconstruction: {np.median(per_image_s[1:]):.3f} s/image steady-state "
              f"(first incl. compile: {per_image_s[0]:.1f} s)")
    print(f"==> results saved at folder: {opt.datadir}/preds")
    return per_image_s


if __name__ == "__main__":
    main()
