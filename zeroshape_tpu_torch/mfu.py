"""FLOP accounting and model FLOP utilisation of the hot programs on the
card (counterpart of ``scripts/mfu.py``).

    python -m zeroshape_tpu_torch.mfu [train|depth|recon|all]

Rows: ``train_step_b28`` (one training step of the shipped shape graph,
bf16, batch 28 of ``graft_entry._batch``), ``depth_step_b44`` (a
``DepthGraph`` step, loss weights depth 1 / intr 10, batch 44, or
``MFU_DEPTH_B``) and ``recon_vox128_hier_fused`` (the headline
reconstruction of ``bench``). Each gives ``flops``, ``flops_source``,
``seconds`` (the median of ``MFU_REPS`` (9) calls after a warm-up, host
clock, each ending in a sync), ``tflops_per_s``, ``mfu_pct_h100_bf16``
against the H100's dense bf16 peak of 989 TFLOP/s, ``img_per_s`` and the
card's name and power limit; the last line is the JSON list.

FLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` (matmuls,
convolutions and attention, forward and backward; elementwise work is not
counted). K1 is a kernel the counter cannot see, so the reconstruction's
count is that of the same reconstruction with the plain decode
(``bench.build(use_fused=False)``), while its time is measured on the K1
path: the reported share is a lower bound for the K1 path. The decoder's
part of that count is held to :func:`decoder_flops` within 1%.

Counting also works on the CPU (the tests use it); timing needs the card.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from zeroshape_tpu_torch import recon, resolve_device

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak of an H100 SXM


def count_flops(fn, *args, **kwargs):
    """FLOPs of one call ``fn(*args, **kwargs)`` as ``FlopCounterMode`` counts them."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return counter.get_total_flops()


def decoder_flops(P, L, C=256, n_blocks=2, hidden=1024, n_linears=9, skip_in=(2, 4, 6)):
    """Operations the decoder needs for P points against L latent keys: the
    point projection, each block's qkv, scores and weighted values against the
    L keys, projection and MLP, then the skip MLP's linears."""
    per = 2 * 3 * C  # point_proj
    per += n_blocks * (2 * C * 3 * C + 2 * (2 * C * L) + 2 * C * C + 2 * (2 * C * hidden))
    for l in range(n_linears):
        fan_in = 3 + C if l == 0 else C + (3 + C if l in skip_in else 0)
        per += 2 * fan_in * (1 if l == n_linears - 1 else C)
    return P * per


def recon_flops(model, batch, generator):
    """``(all FLOPs, the decoder's FLOPs, decoded points, latent keys)`` of one
    ``recon.reconstruct`` of ``model`` (which must decode plainly: the
    counter cannot see K1). The decoder's part is counted by a second
    counter around each call of the model's ``Implicit.decode``."""
    if recon.uses_kernel(model):
        raise ValueError("K1 is invisible to the FLOP counter: count the plain-decode variant")
    impl = model.graph.impl_network
    seen = {"flops": 0, "points": 0, "keys": 0}

    def counted(caches, pts):
        with FlopCounterMode(display=False) as inner:
            out = type(impl).decode(impl, caches, pts)
        seen["flops"] += inner.get_total_flops()
        seen["points"] += pts.shape[0] * pts.shape[1]
        seen["keys"] = caches[0][0].shape[2]
        return out

    impl.decode = counted  # this instance only, for this call
    try:
        total = count_flops(recon.reconstruct, model, batch, generator)
    finally:
        del impl.decode
    return total, seen["flops"], seen["points"], seen["keys"]


def _seconds(fn, reps, warmup=2):
    """Median host-clock seconds of ``reps`` calls after ``warmup``, each ending in a sync."""
    from zeroshape_tpu_torch.bench import host_seconds

    for _ in range(warmup):
        fn()
    return float(np.median(host_seconds(fn, reps)))


def _row(name, flops, source, seconds, images, smi, **extra):
    return {"name": name, "flops": flops, "flops_source": source, "seconds": seconds,
            "tflops_per_s": flops / seconds / 1e12, "mfu_pct_h100_bf16": 100 * flops / seconds / H100_BF16_FLOPS,
            "img_per_s": images / seconds, "card": smi, **extra}


def _step_row(name, graph, opt, batch, reps, smi, **step_kw):
    """The row of ``parallel.train.train_step`` on ``graph`` (``step_kw`` its
    loss or stochastic depth): FLOPs of one step, then its median time."""
    from zeroshape_tpu_torch.parallel import train as ptrain

    optimizer = ptrain.make_optimizer(graph, opt.optim)

    def step():
        ptrain.train_step(graph, optimizer, batch, opt, **step_kw)

    step()  # the first step allocates the optimizer's state
    flops = count_flops(step)
    seconds = _seconds(step, reps)
    B = batch["rgb_input_map"].shape[0]
    return _row(name, flops, "FlopCounterMode (forward and backward)", seconds, B, smi,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def mfu_train(reps, dev, smi):
    """One ``shape_gen``-style step of the shipped graph at batch 28, bf16."""
    from zeroshape_tpu_torch.graft_entry import _batch, _full_opt
    from zeroshape_tpu_torch.models.graph_shape import ShapeGraph
    from zeroshape_tpu_torch.runtime.shape_engine import step_generator
    from zeroshape_tpu_torch.weights import init_like_flax

    B, opt = 28, _full_opt()
    graph = init_like_flax(ShapeGraph.from_opt(opt, dtype=torch.bfloat16), seed=0).to(dev).train()
    batch = _batch(B=B, H=opt.H, n_pts=opt.training.n_sdf_points, device=dev)
    torch.cuda.reset_peak_memory_stats()
    return _step_row(f"train_step_b{B}", graph, opt, batch, reps, smi, generator=step_generator(2, 0, dev))


def mfu_depth(reps, dev, smi):
    """A depth-pretraining step at the reference batch (``options/depth.yaml``:
    44, loss weights depth 1 / intr 10), bf16."""
    from zeroshape_tpu_torch.graft_entry import _batch, _full_opt
    from zeroshape_tpu_torch.models import graph_depth
    from zeroshape_tpu_torch.models.graph_depth import DepthGraph
    from zeroshape_tpu_torch.runtime.depth_engine import MODEL_KEYS
    from zeroshape_tpu_torch.weights import init_like_flax

    B = int(os.environ.get("MFU_DEPTH_B", "44"))
    opt = _full_opt()
    opt.loss_weight = {"shape": None, "depth": 1, "intr": 10}
    graph = init_like_flax(DepthGraph.from_opt(opt, dtype=torch.bfloat16), seed=0).to(dev).train()
    batch = {k: v for k, v in _batch(B=B, H=opt.H, n_pts=16, device=dev).items() if k in MODEL_KEYS}
    torch.cuda.reset_peak_memory_stats()
    return _step_row(f"depth_step_b{B}", graph, opt, batch, reps, smi, loss_fn=graph_depth.compute_loss,
                     metrics_fn=None)


def mfu_recon(reps, dev, smi):
    """The headline reconstruction: FLOPs of its plain-decode variant, the time of the K1 path."""
    from zeroshape_tpu_torch import bench

    reconstruct, fused, batch = bench.build(use_fused=True, device=dev)
    plain = bench.variant(fused, use_fused=False)
    flops, dec, points, keys = recon_flops(plain, batch, torch.Generator(device=dev).manual_seed(0))
    want = decoder_flops(points, keys)
    if abs(dec - want) > 0.01 * want:
        raise RuntimeError(f"the decoder's counted FLOPs {dec} are not within 1% of decoder_flops {want}")
    gen = torch.Generator(device=dev).manual_seed(0)
    seconds = _seconds(lambda: reconstruct(fused, batch, gen), reps, warmup=3)
    return _row("recon_vox128_hier_fused", flops, "FlopCounterMode (plain-decode variant; K1 time)", seconds, 1, smi,
                decoder_flops_counted=dec, decoder_flops_analytic=want, decoded_points=points)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    dev = resolve_device(None)  # timing needs the card
    from zeroshape_tpu_torch.bench import card

    what = argv[0] if argv else "all"
    if what not in ("train", "depth", "recon", "all"):
        raise SystemExit(f"unknown row {what!r}: train, depth, recon or all")
    reps = int(os.environ.get("MFU_REPS", "9"))
    smi = card()
    rows = []
    for name, fn in (("train", mfu_train), ("depth", mfu_depth), ("recon", mfu_recon)):
        if what in (name, "all"):
            rows.append(fn(reps, dev, smi))
            torch.cuda.empty_cache()
    for r in rows:
        print(f"{r['name']}: {r['flops'] / 1e9:.1f} GFLOP ({r['flops_source']}), {r['seconds'] * 1e3:.1f} ms -> "
              f"{r['tflops_per_s']:.2f} TFLOP/s = {r['mfu_pct_h100_bf16']:.2f}% of the H100's bf16 peak "
              f"({r['img_per_s']:.1f} img/s; {smi})", flush=True)
    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
