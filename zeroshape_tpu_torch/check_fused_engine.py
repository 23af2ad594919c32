"""K1 against the plain decode of the same graph on the hierarchical path
(counterpart of ``scripts/check_fused_engine.py``).

    python -m zeroshape_tpu_torch.check_fused_engine [--ckpt=FILE | --resume --name=shape_gen_staged] \\
        [--task=shape] [--data.root=DIR] [--device=cpu]

Two models share one graph: the engine's (K1, ``recon.decode_points``) and
``ReconModel(fused=False)``, which decodes with the plain ``Implicit.decode``
in the compute dtype (bf16 on the card), as ``bench ab`` does. On one image,
with one set of latent caches, they are compared:

1. the raw logits on the 33^3 coarse lattice of vox 128, at the
   pre-sharpen scale: max, mean and p99 of |K1 - plain|;
2. the 129^3 level grid of the coarse-to-fine decode (capacity 4096)
   binarised at 0.5: the share of voxels whose side differs, and
   ``n_active`` of both.

The yardstick is a third decode of the same caches, the plain decoder in
fp32 (the kernel's own plain version). K1 passes when it is no farther from
it than the plain bf16 decode is: its max and mean logit error on the
lattice, and its flipped voxels, each at most the bf16 decode's. (An
absolute bound does not carry over from the JAX script's random field: on a
trained field bf16 rounding of the larger activations moves logits by tenths,
and a field's share of voxels near 0.5 sets its flips.)

With ``--ckpt`` or ``--resume`` the field is the trained checkpoint's
(options as the train CLI's, unchecked; the first test view under
``data.root``, else the synthetic image), at sharpen 1. Without either it is
``recon.synthetic_setup()``'s calibrated random field at sharpen 25, which
cannot show a trained field's saturation: most of its lattice lies within a
few logits of the surface. Exits non-zero when K1 is farther. On the CPU
(``--device=cpu``) the engine's model decodes plainly too, so this checks
the harness.
"""

from __future__ import annotations

import copy
import os
import sys

import numpy as np
import torch

from zeroshape_tpu_torch import recon, resolve_device
from zeroshape_tpu_torch.config import synthetic_image
from zeroshape_tpu_torch.metrics.eval3d import occupancy_grid_hierarchical, resolve_hier_capacity

VOX, CAP = 128, 4096


def _fp32_twin(impl):
    """A copy of the decoder ``impl`` that decodes in fp32."""
    twin = copy.deepcopy(impl).float()
    twin.dtype = torch.float32
    return twin


def compare(model, batch, vox=VOX, capacity=CAP):
    """The two checks of ``model`` (decoding through K1 where it can) against
    its plain-decode twin on ``batch``, each also against the fp32 decode.
    Returns a dict: the coarse-lattice logit deltas at the pre-sharpen scale
    (``max``, ``mean``, ``p99`` of |K1 - plain|; ``err_k1`` and ``err_plain``,
    the (max, mean) distance of each from fp32), the binarised grid's flips
    between K1 and plain (``flips``, ``flip_share``), against fp32
    (``flips_k1``, ``flips_plain``), ``n_active`` of each decode, and
    ``ok``: K1 no farther from fp32 than the plain decode on all three."""
    plain = recon.ReconModel(model.graph, None, model.sharpen, model.device, fused=False).repack()
    exact = _fp32_twin(model.graph.impl_network)
    with torch.inference_mode():
        caches = model.graph.encode_latents(model.graph.encode_image(recon._inputs(batch, model.device)))
        caches32 = [(k.float(), v.float()) for k, v in caches]
        decode = {"k1": lambda pts: recon.decode_points(model, caches, pts).float(),
                  "plain": lambda pts: recon.decode_points(plain, caches, pts).float(),
                  "fp32": lambda pts: exact.decode(caches32, pts)[0].float()}
        pts = recon.coarse_lattice(vox, recon.RANGE, recon.FACTOR, model.device)[None]
        logits = {k: fn(pts)[0] for k, fn in decode.items()}
        tile = resolve_hier_capacity(vox, capacity, recon.FACTOR) * (recon.FACTOR + 1) ** 3
        grids = {}
        for k, fn in decode.items():
            level, n_active = occupancy_grid_hierarchical(
                lambda p, fn=fn: model.sharpen * fn(p), vox, recon.RANGE, batch_size=1, factor=recon.FACTOR,
                capacity=capacity, margin=recon.MARGIN, tile_points=tile, return_stats=True, device=model.device)
            grids[k] = ((level[0] > 0.5).cpu().numpy(), int(n_active[0]))
    d = (logits["k1"] - logits["plain"]).abs().cpu().numpy()
    err = {k: (float((logits[k] - logits["fp32"]).abs().max()), float((logits[k] - logits["fp32"]).abs().mean()))
           for k in ("k1", "plain")}
    flips = {k: int((grids[k][0] != grids["fp32"][0]).sum()) for k in ("k1", "plain")}
    n_flip = int((grids["k1"][0] != grids["plain"][0]).sum())
    ok = err["k1"][0] <= err["plain"][0] and err["k1"][1] <= err["plain"][1] and flips["k1"] <= flips["plain"]
    return {"max": float(d.max()), "mean": float(d.mean()), "p99": float(np.percentile(d, 99)),
            "err_k1": err["k1"], "err_plain": err["plain"], "flips": n_flip, "flip_share": n_flip / grids["k1"][0].size,
            "flips_k1": flips["k1"], "flips_plain": flips["plain"], "n_active_fused": grids["k1"][1],
            "n_active_plain": grids["plain"][1], "n_active_fp32": grids["fp32"][1], "ok": ok}


def trained_setup(opt, dev):
    """``(model, batch)``: the checkpoint's weights at sharpen 1 and the first
    test view of ``opt.data.root`` (else the synthetic image)."""
    from zeroshape_tpu_torch.evaluate import graph_for
    from zeroshape_tpu_torch.runtime import engine_base

    model = recon.ReconModel(graph_for(opt, dev), None, 1.0, dev).repack()
    if os.path.isdir(opt.data.root):
        s = engine_base.load_dataset(opt, eval_split="test", load_train=False)[1][0]
        batch = {k: np.asarray(s[k])[None] for k in ("rgb_input_map", "mask_input_map")}
        print(f"trained field: {opt.get('ckpt') or os.path.join(opt.output_path, 'best.ckpt')}, "
              f"the first test view of {opt.data.root}")
    else:
        rgb, mask = synthetic_image(opt.H, seed=0)
        batch = {"rgb_input_map": rgb, "mask_input_map": mask}
        print(f"trained field, on the synthetic image ({opt.data.root} not found)")
    return model, batch


def main(argv=None):
    from zeroshape_tpu_torch.train import options

    opt = options(sys.argv[1:] if argv is None else argv, safe_check=False)
    dev = resolve_device(opt.get("device"))
    if opt.get("ckpt") or opt.get("resume"):
        model, batch = trained_setup(opt, dev)
        scale = 1.0
    else:
        model, batch, _, (shift, scale, n_cal) = recon.synthetic_setup(dev)
        print(f"calibrated random field (shift {shift:.4f}, gain {scale:g}, {n_cal} active cells): not a trained "
              "field, so its many voxels near the 0.5 level flip under rounding; only a trained field can show a "
              "saturated field's agreement")
    r = compare(model, batch)
    print(f"coarse logit |diff| (pre-sharpen): max {r['max'] / scale:.5f}, mean {r['mean'] / scale:.6f}, "
          f"p99 {r['p99'] / scale:.5f}; from the fp32 decode (max, mean): K1 "
          f"({r['err_k1'][0] / scale:.5f}, {r['err_k1'][1] / scale:.6f}), plain "
          f"({r['err_plain'][0] / scale:.5f}, {r['err_plain'][1] / scale:.6f})")
    print(f"n_active: plain {r['n_active_plain']}, fused {r['n_active_fused']}, fp32 {r['n_active_fp32']}")
    print(f"binarized grid mismatches: {r['flips']} / {(VOX + 1) ** 3} ({r['flip_share']:.2e}); against the fp32 "
          f"decode: K1 {r['flips_k1']}, plain {r['flips_plain']}")
    if not r["ok"]:
        raise SystemExit("FUSED ENGINE PATH FAILED: K1 is farther from the fp32 decode than the plain decode")
    print("FUSED ENGINE PATH OK")
    return r


if __name__ == "__main__":
    main()
