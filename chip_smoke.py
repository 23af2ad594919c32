"""Drive the PyTorch/CUDA port on one GPU: build its kernels, hold each
against its plain version, run the full-size main path and export a mesh,
run the scoring and evaluation path at full size, then shape training, the
accuracy gate, depth pretraining and its staging into shape training, the
CLIs on datasets written to disk, in one process and in two, the visual
layer: the turntable renderer, the dense decode with attention, the demo
CLI's three runs and the engines' dumps, the non-default encoders, then the
benchmark, FLOP accounting and the dry run over two ranks.

    python3 chip_smoke.py

Phases (one line or more each, any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi); which of PIL, cv2,
     matplotlib, PyYAML and TensorBoard the host has;
  2. build the kernels from csrc/ with nvcc, one process per source, all
     started together: the fused implicit decoder (K1) and the Chamfer
     kernels (K2, K3); ptxas's register and spill lines; beside them the GIF
     encoder (csrc/gif.cpp, g++);
  3. K1: the SASS counts of its tensor-core (HGMMA) and bulk-copy (UBLKCP)
     instructions where cuobjdump exists; K1 against its plain version
     (``Implicit.decode`` in fp32) at full width (C=256, 8 heads, 2 blocks,
     9 linears, L=197) at the sizes the paths give it: the 35,937 points of
     the coarse 33^3 lattice (a partial last tile), the 512,000 points of a
     vox-128 fine pass and the 2,146,689 points of the dense 129^3 grid;
     bf16 bounds of tests/test_implicit_kernel.py; rolled rows and a second
     launch bit-equal; CUDA-event times at the three sizes, each with its
     bound, TFLOP/s, share of the bound and the bytes it streams from L2
     (counted from shapes); the plain version's time at 512,000 points;
  4. the main path: ``recon.synthetic_setup`` at full size (224^2, vox 128,
     capacity 4096, 10k points, sharpen 25) on a seeded synthetic masked
     image, the random field calibrated to a trained field's inside share
     and active-cell count (``recon.calibrate_random_field``); kernel launches counted over
     one reconstruction; a surface must exist; median seconds;
  5. marching-cubes mesh export of the level grid to a PLY file (not empty);
     the dense sampler run twice on that grid with one seed: the draws must
     be bit-equal (and whether torch.cumsum of its areas is, for the record);
  6. K2 (nearest neighbour + argmin, exact refinement) against its plain
     version at the exact brute-force stage's shape (B=48, N=M=10,000) and at
     a ragged one (B=3, N=1,000, M=777), on unit-scale clouds, and at the
     exact stage's real distribution: 48 rotations of a unit-normalised
     10,000-point torus surface cloud against a shared (stride-0) GT cloud of
     10,000, in both directions: refined distances within 1e-5; argmins
     equal on >= 99.9% of points and, where they differ, equally near within
     1e-5; rolling the rows of x1 rolls the results exactly;
  7. K3 (bf16 cross term, min only) against its plain version at the coarse
     stage's shape (B=192, N=M=1,024) and at B=3, N=1,000, M=777, within 1e-5;
  8. a planted rotation: a GT cloud of 10,000 points on an analytic torus and
     an independent 10,000-point draw of it turned by the inverse of sphere
     rotation k; exhaustive and pruned brute force both find a CD no larger
     than rotation k's (+1e-6), which lies near the sampling floor (< 0.01),
     and report the same best CD; ICP from a 5-degree misalignment lowers the
     CD;
  9. the evaluation path (``runtime/shape_engine.evaluate``) with the main
     path's calibrated model on 4 analytic test samples at eval batch 2, in
     both postures: final (dense decode through K1, exhaustive brute force
     through K2) and validation (coarse-to-fine decode, pruned brute force
     with K3 in the coarse stage and K2 in the exact one); kernel launches
     against what the code implies; finite metrics; the three result files
     written and parsed back; seconds per sample;
 10. CUDA-event times of K2 and K3 at the exact and coarse shapes of 6 and 7
     (the kernels from a CUDA graph of 20 launches, so the host's launch cost
     stays out), of their plain versions and of the library yardstick
     (``torch.cdist`` then ``.min``); two bounds each: the JAX CostEstimate's
     FLOP at the fp32 SIMT peak, and the card bound (the product at the
     tensor-core rate, one comparison a pair at the SIMT issue rate, the
     bytes), with the share of the card bound; K2's time per final-posture
     sample (288 launches) beside that posture's seconds per sample;
 11. training (``runtime/shape_engine.train``, the ``shape_gen`` recipe at
     full width, bf16 autocast) on ``data.analytic.train_samples(4, 8, 224)``:
     28 training and 4 validation views; 2 epochs of 3 steps at batch 8,
     validation before the first step and after epoch 2 (vox 128, batch 1,
     no brute force); the s/step median over steps 2-6 (host clock, each
     step ending in a sync), samples/s, peak memory, the losses; K1/K2/K3
     launches in the train steps (0: the step decodes with the plain decoder,
     which has a backward) and in validation (K1 and K2, no K3); a batch-28
     step with the shape loss only (``options/shape.yaml``'s batch), timed
     with its peak memory; 20 steps on one fixed batch of 8, whose last 5
     losses must average below the first 5; one fp32 step at tiny width on
     the card and on the CPU (TF32 off, the same weights, batch and
     stochastic-depth masks): updated parameters within 1e-4; a checkpoint
     written, read back into a fresh graph and optimizer, the same state;
 12. the accuracy gate (tests/test_accuracy_gate.py) through
     ``shape_engine.train`` with ``config.accuracy_gate_opt()``: 24 epochs of
     2 steps at 64^2 from random weights, bf16; its decoder (C=64) is not
     K1's, so its two validations decode plainly (counted) and score through
     K2; the best CD must be below 0.11;
 13. depth pretraining (``runtime/depth_engine.train``, the ``depth_gen``
     recipe at full width, bf16, batch 8) on phase 11's data: 2 epochs of 3
     steps, validation before the first step and after epoch 2, then the
     final metrics written to ``best_val.txt``; s/step, samples/s, peak
     memory, losses and every depth metric; no K1/K2/K3 launch; its visual
     dumps (``vis_log/iter_0``, ``dump_synthetic``);
 14. 20 depth steps on one fixed batch of 8, continuing the run's optimizer:
     the last 5 losses must average below 0.9x the first 5;
 15. one fp32 depth step at H=64 on the card and on the CPU (TF32 off, the
     same weights and batch), held to ``step_disagreements``;
 16. a ``shape_gen`` run staged from the depth run's ``best.ckpt``
     (``pretrain.depth``): before its first step the DPT and intrinsics head
     equal the checkpoint's bit for bit and the rest ``init_like_flax``'s;
     1 epoch of 3 steps whose validations launch K1 and K2, nothing plain;
 17. ``--load`` of that run's ``latest.ckpt`` into a fresh run: its first
     step starts from those weights with an optimizer that took no step;
 18. the held-out analytic tree on disk (``data.analytic.generate_dataset``,
     4 + 2 objects x 8 views at 224^2): its loader's samples equal phase
     11's in-memory split bit for bit; which image decoder ran;
 19. ``python -m zeroshape_tpu_torch.train --task=shape`` on the tree (in
     this process): 1 epoch of 3 steps at batch 8, validation on the 4 seen
     and 16 held-out views before and after; s/step, the loader's wait and
     its share of the steps' time, the launches of validation and of the
     train-split metrics (K1 and K2 in both); ``train/dist_acc`` and
     ``eval/dist_acc`` finite; with ``eval.n_vis=2`` and ``freq.save_vis=2``
     (phase 27);
 20. ``python -m zeroshape_tpu_torch.evaluate --resume`` of that run in the
     final posture with brute force: the result files parsed back,
     ``cd_cat.txt`` with ``prim``, ``ho0`` and ``ho1``; s/sample;
 21. Pix3D (256^2 images: the loader resizes), OCRTOC and OmniObject3D
     trees of analytic renders, PNG only, each through the evaluate CLI in
     the validation posture (coarse-to-fine decode, pruned brute force);
 22. two ranks on the one card (``torch.distributed.run``, gloo by the
     backend rule): ``python -m zeroshape_tpu_torch.dist_check``'s fp32 step
     against one rank's (each gradient leaf within 1e-4 of its norm, or 4x
     the one-rank step's card-vs-CPU difference) and its evaluation (CD
     1e-3); the evaluate CLI on two ranks against phase 20 (CD 1e-3 a sample);
 23. the turntable renderer on phase 5's mesh (15 views, 320^2, 2^18
     points): the card against the CPU on the same injected uniforms, >= 99%
     of pixels equal; its CUDA-event time and the GIF encoder's seconds;
 24. the dense 129^3 decode with attention (``recon.reconstruct_with_attn``)
     of the main path's model and image: its occupancy against sigmoid(25 x
     K1) of the same caches (within 1e-6 wherever K1's logit is over 2 from
     0, inside/outside equal on 98% of the grid: bf16 autocast rounds every
     activation, K1 keeps fp32 accumulators), attention finite in [0, 1],
     the card against the CPU in fp32 at vox 16 (level and attention 1e-4);
     seconds and peak memory;
 25. ``python -m zeroshape_tpu_torch.demo`` in subprocesses on a copy of
     ``examples/`` at 224^2, vox 128, with PIL, cv2 and matplotlib blocked
     and a checkpoint of calibrated random weights: the attention path,
     ``--eval.dump_attn!`` (K1, 2 launches an image) and the depth task; every file the JAX demo writes, parsed back
     (PNGs by the port's decoder, GIF frames counted by walking the blocks:
     272 an attention sweep, 15 a turntable; PLY and OBJ headers); seconds
     an image;
 26. the evaluation dumps of phases 9 and 20-22: every sample's files in
     ``dump_{dataset}/`` (phases 9 and 21, on calibrated fields: a mesh and
     a 15-frame turntable for every sample) and ``results_test.html``; the
     dumps' seconds a sample and their share of the CLI's time; two ranks
     dump each sample once;
 27. the training-time dumps of phase 19: ``vis_0/`` and ``vis_1/`` with two
     attention GIFs each and their galleries, ``vis_log/iter_0`` and
     ``vis_log/iter_2``;
 28. the non-default encoders at full width, ``config.encoders_opt()`` (both
     12-block transformer encoders, dsp 2, a semantic decoder at K1's
     width), after a printed prediction: (a) ``encode_image`` on the card
     against the CPU in fp32, TF32 off, each latent stream within 1e-4 of
     its norm, for it and for the RGB-resnet variant (eval BatchNorm); (b)
     ``recon.synthetic_setup(opt=encoders_opt())``: one reconstruction
     launches K1 2 and decodes plainly 0 times, a surface exists, the median
     of 5 beside phase 4's; (c) with ``posenc_3D`` 4 and ``posenc_perlayer``
     K1 is not built for the decoder: K1 0, plain 2, a surface after
     calibration; (d) ``shape_engine.evaluate`` of (b)'s model in the
     validation posture on phase 9's samples, launches as the code implies;
     (e) ``shape_gen`` with the variant's encoders on phase 11's data, 1
     epoch of 3 steps validated before and after: s/step, peak memory,
     finite losses, launches, the device kernels of a step by
     ``torch.profiler``; a tiny fp32 step with both transformer encoders on
     the card and the CPU with every stochastic-depth mask given, held to
     ``step_disagreements``;
 29. the bench family, each a subprocess parsed back: ``python -m
     zeroshape_tpu_torch.bench`` (its last line the four keys of the JSON
     headline, value finite and positive, K1 2 launches a reconstruction,
     n_active <= 4096, beside phase 4's median), ``bench throughput 1 8``
     (images/s, K1 2 B a call), ``bench ab 5`` (the K1 and plain-decode
     medians and each pair's ratio), ``mfu all`` (each row's FLOPs, seconds,
     TFLOP/s and share of the bf16 peak under 100%; the reconstruction's
     decoder count within 1% of ``mfu.decoder_flops``);
 30. the dry run, ``graft_entry.dryrun_multichip(2, full=True)``: two ranks
     on the one card (gloo by the backend rule), one training step of the
     shipped graph at 224^2 and the dense evaluation at vox 32, a finite loss
     and two finite CDs, K1 once a rank; its seconds;
 31. the two-stage chain at full width, cut in data and epochs
     (``chain_phase``): ``python -m zeroshape_tpu_torch.round5 run`` on a
     2 + 1 held-out object tree at 224^2 with one epoch of one step a
     training, two stages at a time (depth, staged and scratch shape runs,
     both arms' evaluations, the exact brute force, ``measure_hier`` on both
     arms, the random floor, ``calibrate_gate 2``), then ``check_fused_engine``
     on the calibrated field and ``time_bf``: every stage exits 0, both arms'
     checkpoints hold the shape graph's keys, the result files parse, each
     gate seed below 0.11; one step leaves each arm a random field whose
     every coarse cell is active at sharpen 1, so ``measure_hier`` is then
     run again on both arms' weights calibrated as in phase 21 and must
     report n_active <= 4096; the launches of these subprocesses
     (``ZS_LAUNCH_LOG``) join the kernel line's sums;
 32. the measurement tools (``timers_phase``): every subcommand of
     ``time_train`` (batch, windows, parts, loader, midas, the depth probe)
     and ``time_recon`` (components, hier_parts, decode, sampling,
     k1_builds on the shipped source against itself) as subprocesses at cut
     sizes, two subprocesses at a time, and ``analyze_trace`` on 2 traced
     ``profile_train`` steps: each
     last line parsed, its keys present and its numbers finite; the midas
     medians bit-equal, both K1 builds within their bounds, the trace's
     spans holding >= 95% of its device busy time; the launches join the
     kernel line's sums.
Then the script's seconds, one JSON line of kernel numbers, the nvidia-smi line again, and the
result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

H100_BF16_FLOPS = 989e12  # dense tensor-core peak (NVIDIA data sheet, SXM)
H100_TF32_FLOPS = 495e12
H100_FP32_FLOPS = 67e12  # fp32 outside the tensor cores (SIMT)
H100_LANE_OPS_PER_S = 132 * 4 * 32 * 1.98e9  # lane-instructions: SMs x schedulers x lanes x boost clock
H100_BYTES_PER_S = 3.35e12
N_EVAL = 4  # analytic test samples per evaluation posture


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, warmup=2, iters=10):
    """Mean milliseconds per call over ``iters`` calls, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def agree(got, ref, what):
    """Hold K1's logits to the plain version's within the bf16 bounds of
    tests/test_implicit_kernel.py (``time_recon.k1_agreement``); returns the
    max |d|."""
    from zeroshape_tpu_torch.time_recon import k1_agreement

    ok, dmax, dmean, corr = k1_agreement(got, ref)
    print(f"K1 vs plain fp32 on the {what}, P={len(got)}: max|d| {dmax:.3e} mean|d| {dmean:.3e} "
          f"corr {corr:.6f} (logit std {float(ref.double().std()):.3f})")
    if not ok:
        fail(f"K1 disagrees with its plain version on the {what} beyond rtol 8e-2, atol 2e-2, "
             "corr 0.9999, mean 5e-3, or gave a non-finite logit")
    return dmax


def sass_counts(lib):
    """Counts of tensor-core and copy instructions in a built library's SASS
    (``cuobjdump`` of the toolkit, else Triton's copy); None without one."""
    from torch.utils.cpp_extension import CUDA_HOME

    tools = [os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")]
    try:
        import triton

        tools.append(os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    tool = next((t for t in tools if os.path.exists(t)), None)
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True).stdout
    words = [w.strip(";") for line in sass.splitlines() for w in line.split()]
    count = {op: sum(w.startswith(op) for w in words)
             for op in ("HGMMA", "HMMA", "UBLKCP", "UTMALDG", "SYNCS.ARRIVE.TRANS64", "SYNCS.PHASECHK")}
    return tool, count


def k1_bound(P, L, packed):
    """(bound ms, bound_by, FLOP, bytes) of K1 on P points against L keys."""
    from zeroshape_tpu_torch.mfu import decoder_flops

    flops = decoder_flops(P, L)
    nbytes = P * 3 * 4 + P * 4 + 2 * 2 * 8 * L * 32 * 2
    for v in packed.values():
        for t in v if isinstance(v, list) else [v]:
            nbytes += 0 if t is None else t.numel() * t.element_size()
    by = "operations" if flops / H100_BF16_FLOPS > nbytes / H100_BYTES_PER_S else "bytes"
    return max(flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S) * 1e3, by, flops, nbytes


def check_k1(dev):
    """K1 vs its plain version at full width; returns the kernel's numbers."""
    from zeroshape_tpu_torch.metrics.eval3d import coarse_lattice, get_dense_3D_grid
    from zeroshape_tpu_torch.ops import _build
    from zeroshape_tpu_torch.ops import implicit_kernel as ik
    from zeroshape_tpu_torch.time_recon import K1_POINTS, k1_case

    found = sass_counts(_build.library_path(ik._NAME))
    if found is None:
        print("K1 SASS: no cuobjdump found")
    else:
        print(f"K1 SASS ({found[0]}): {found[1]}")
    # bf16-valued weights, caches and points with logits that vary by more
    # than bf16 noise; P: the fine pass of a vox-128, capacity-4096 decode
    impl, caches, packed, points = k1_case(dev)
    P = K1_POINTS
    coarse = coarse_lattice(128, device=dev)  # the coarse pass: 33^3 points
    with torch.inference_mode():
        err_coarse = agree(ik.fused_decode(impl, caches, coarse, packed),
                           impl.decode(caches, coarse[None])[0][0], "coarse lattice")
        dense = get_dense_3D_grid(128, device=dev)  # the dense decode: one launch
        err_dense = agree(ik.fused_decode(impl, caches, dense, packed),
                          torch.cat([impl.decode(caches, c[None])[0][0] for c in dense.split(P)]), "dense 129^3 grid")
        got = ik.fused_decode(impl, caches, points, packed)
        torch.cuda.synchronize()
        ref = impl.decode(caches, points[None])[0][0]
        err = agree(got, ref, "random points")
        shift = 37
        rolled = ik.fused_decode(impl, caches, torch.roll(points, shift, 0), packed)
        again = ik.fused_decode(impl, caches, points, packed)
        sizes = {"coarse lattice": coarse, "random points": points, "dense 129^3 grid": dense}
        times = {what: cuda_ms(lambda x=x: ik.fused_decode(impl, caches, x, packed), iters=10 if len(x) <= P else 4)
                 for what, x in sizes.items()}
        plain_ms = cuda_ms(lambda: impl.decode(caches, points[None]), warmup=1, iters=3)
        impl.dtype = torch.bfloat16
        ref_bf16 = impl.decode(caches, points[None])[0][0]
        plain_bf16_ms = cuda_ms(lambda: impl.decode(caches, points[None]), warmup=1, iters=3)
    d16 = float((got - ref_bf16).abs().max())
    print(f"K1 vs plain bf16 at P={P}: max|d| {d16:.3e}")
    if not torch.equal(rolled, torch.roll(got, shift, 0)):
        fail("K1 logits depend on the row a point lands in")
    if not torch.equal(again, got):
        fail("two K1 launches on the same points gave different logits")
    print(f"K1 determinism at P={P}: rolled rows bit-equal, a second launch bit-equal")

    L = caches[0][0].shape[2]
    for what, x in sizes.items():
        n = len(x)
        b_ms, b_by, flops, nbytes = k1_bound(n, L, packed)
        ms = times[what]
        print(f"K1 time on the {what}, P={n}: {ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}: {flops / 1e12:.3f} TFLOP, "
              f"{nbytes / 1e6:.2f} MB), {flops / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.1%} of the bound; "
              f"L2 stream {ik.streamed_bytes(n) / 1e9:.3f} GB (counted from shapes: "
              f"{-(-n // ik.TILE_POINTS)} tiles x {2 * (ik.STREAM_ELEMS + ik.CACHE_ELEMS)} bytes), "
              f"{ik.streamed_bytes(n) / ms / 1e9:.2f} TB/s")
    ms = times["random points"]
    bound_ms, bound_by, flops, nbytes = k1_bound(P, L, packed)
    print(f"K1 time at P={P}: kernel {ms:.3f} ms, plain fp32 {plain_ms:.3f} ms, plain bf16 {plain_bf16_ms:.3f} ms")
    return {
        "name": "implicit_decoder",
        "route": "cuda",
        "source": "zeroshape_tpu_torch/csrc/implicit_decoder.cu",
        "replaces": "zeroshape_tpu/ops/implicit_kernel.py:162",
        "max_abs_err": max(err, err_coarse, err_dense),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "card_bound_ms": bound_ms,  # its products already run on the tensor cores
        "library_ms": None,  # no single PyTorch call computes the decoder
    }


def main_path(dev):
    """The full-size 128^3 reconstruction through ``recon``; returns (model,
    launches, level, batch, median seconds)."""
    from zeroshape_tpu_torch import recon
    from zeroshape_tpu_torch.ops.implicit_kernel import fused_decode

    t0 = time.perf_counter()
    model, batch, gen, (shift, gain, n_calibrated) = recon.synthetic_setup(dev)
    print(f"main path: model built, calibrated and warmed up in {time.perf_counter() - t0:.1f} s; "
          f"output layer shifted by {-shift:.4f} and scaled by {gain:g} for {n_calibrated} active "
          f"cells (target {recon.ACTIVE_TARGET}, {recon.INSIDE:g} of the coarse lattice inside)")

    fused_decode.launches = 0
    world, depth, intr, n_active, level = recon.reconstruct(model, batch, gen, return_level=True)
    torch.cuda.synchronize()
    launches = fused_decode.launches
    # one decode call per pass: the coarse 33^3 lattice, then 4096 cells x 5^3
    if launches != 2:
        fail(f"expected 2 kernel launches (coarse + fine pass), counted {launches}")
    if tuple(world.shape) != (recon.NUM_POINTS, 3) or not torch.isfinite(world).all():
        fail(f"surface points not finite [{recon.NUM_POINTS}, 3]: {tuple(world.shape)}")
    if world.abs().max() > 1.5 or not torch.isfinite(intr).all() or not torch.isfinite(depth).all():
        fail("points outside the grid range or non-finite depth / intrinsics")
    n_act = int(n_active.max())
    if n_act == 0:
        fail("no active cell: the field has no surface to refine or sample")
    warn = " WARNING: active cells exceed capacity; surface may be under-refined" if n_act > recon.CAPACITY else ""
    print(f"main path: K1 launches {launches} (coarse + fine); n_active {n_act} / capacity {recon.CAPACITY}{warn}")

    times = recon.time_reconstructions(model, batch, gen, reps=5)
    print(f"main path: median {np.median(times):.4f} s/reconstruction over {len(times)} reps "
          f"(min {min(times):.4f}, max {max(times):.4f})")
    return model, launches, level[0].float().cpu().numpy(), batch, float(np.median(times))


def sampler_determinism(level, dev):
    """Does the dense sampler repeat bit for bit? Two draws on one level grid
    with the same generator seed, and the area CDF they rest on computed
    twice; returns the finding as a short string."""
    from zeroshape_tpu_torch.ops.marching_cubes import fixed_order_cumsum, sample_surface_points, triangle_areas

    lv = torch.as_tensor(level, device=dev)
    with torch.inference_mode():
        areas = triangle_areas(lv)
        library = [torch.cumsum(areas, dim=0) for _ in range(2)]  # what the sampler used to sum with
        fixed = [fixed_order_cumsum(areas) for _ in range(2)]
        draws = [sample_surface_points(lv, torch.Generator(device=dev).manual_seed(0)) for _ in range(2)]
    gap = float((library[0] - library[1]).abs().max())
    finding = (f"torch.cumsum of the {areas.numel()} slot areas bit-equal twice: {torch.equal(*library)} "
               f"(max |d| {gap:.3e}); fixed_order_cumsum bit-equal twice: {torch.equal(*fixed)}; "
               f"10,000 draws bit-equal twice: {torch.equal(*draws)}")
    print(f"dense sampler determinism on the main path's {tuple(lv.shape)} level grid: {finding}")
    if not (torch.equal(*fixed) and torch.equal(*draws)):
        fail("the dense sampler's CDF or draws differ between two runs with one seed")
    return finding


def build_kernels():
    """Build every kernel library, one nvcc per source, all started together."""
    from zeroshape_tpu_torch.ops import _build, chamfer, implicit_kernel

    sources = {"implicit_decoder.cu": implicit_kernel.build, "chamfer.cu": chamfer.build,
               "gif.cpp": lambda: _build.build("gif.cpp", "zsgif")}
    with ThreadPoolExecutor(len(sources)) as pool:
        futures = {name: pool.submit(fn) for name, fn in sources.items()}
    for name, fut in futures.items():
        seconds, log = fut.result()
        print(f"build: {name} in {seconds:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")


def unit_clouds(B, N, M, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(B, N, 3, generator=g) * 2 - 1).cuda(), (torch.randn(B, M, 3, generator=g) * 0.5).cuda()


def surface_clouds(dev, n=10000, n_rot=48, seed=12):
    """The exact brute-force stage's inputs: ``n_rot`` rotations of one
    unit-normalised analytic torus cloud ``[n_rot, n, 3]`` and a GT cloud
    drawn independently from the same surface, ``[n_rot, n, 3]`` at batch
    stride 0."""
    from zeroshape_tpu_torch.camera import get_rotation_sphere
    from zeroshape_tpu_torch.data import analytic
    from zeroshape_tpu_torch.metrics import eval3d

    rng = np.random.default_rng(seed)
    sdf, _ = analytic.make_sdf("torus", rng)
    pred = torch.as_tensor(analytic.surface_points(sdf, n, rng), device=dev)
    gt = torch.as_tensor(analytic.surface_points(sdf, n, rng), device=dev)
    R = get_rotation_sphere(24, 24, 12, device=dev)[::144][:n_rot]
    return eval3d.normalize_pc(eval3d._rotate(R, pred)), eval3d.normalize_pc(gt[None]).expand(n_rot, -1, -1)


def check_k2(x1, x2, what):
    """K2 against its plain version; returns the max |d| of the refined distances."""
    from zeroshape_tpu_torch.ops import chamfer as ch

    dist, idx = ch.nn_one_way(x1, x2)
    torch.cuda.synchronize()
    _, ref_idx = ch._nn_one_way_plain(x1, x2)
    ref = ch._refine(x1, x2, ref_idx)
    err = float((dist - ref).abs().max())
    same = idx == ref_idx
    share = float(same.float().mean())
    gap = float((dist - ref)[~same].abs().max()) if not bool(same.all()) else 0.0
    print(f"K2 vs plain, {what}: max|d| {err:.3e}; argmins equal on {share:.6f} of {same.numel()} points, "
          f"{int((~same).sum())} differ with max |d| {gap:.3e} between the two candidates")
    if not torch.isfinite(dist).all() or int(idx.min()) < 0 or int(idx.max()) >= x2.shape[1]:
        fail(f"K2 gave non-finite distances or indices out of range on {what}")
    if err > 1e-5 or share < 0.999 or gap >= 1e-5:
        fail(f"K2 disagrees with its plain version on {what} (atol 1e-5, 99.9% equal argmins)")
    shift = 37
    r_dist, r_idx = ch.nn_one_way(torch.roll(x1, shift, 1), x2)
    if not (torch.equal(r_dist, torch.roll(dist, shift, 1)) and torch.equal(r_idx, torch.roll(idx, shift, 1))):
        fail(f"K2 results depend on the row a point lands in ({what})")
    return err


def check_k3(x1, x2, what):
    """K3 against its plain version; returns the max |d|."""
    from zeroshape_tpu_torch.ops import chamfer as ch

    got = ch.nn_min_squared_fast(x1, x2)
    torch.cuda.synchronize()
    err = float((got - ch._nn_min_plain(x1, x2)).abs().max())
    print(f"K3 vs plain, {what}: max|d| {err:.3e}")
    if not torch.isfinite(got).all() or err > 1e-5:
        fail(f"K3 disagrees with its plain version on {what} beyond atol 1e-5")
    return err


def launch_counts():
    """The kernels' launch counts and the plain decodes of decoders K1 is not built for."""
    from zeroshape_tpu_torch import bench

    return bench.launch_counts()


def reset_counts():
    from zeroshape_tpu_torch import bench

    bench.reset_counts()


def summed(counts):
    """The sum of a list of :func:`launch_counts` dicts."""
    return {k: sum(n[k] for n in counts) for k in ("K1", "K2", "K3", "plain")}


@contextlib.contextmanager
def instrumented(engine, validation):
    """Wrap ``parallel.train.train_step`` so that each step is timed from 0
    launches to its sync, and ``engine``'s ``validation`` function so that its
    launches are counted; yields the lists ``steps`` (``(seconds, counts)``)
    and ``vals`` (counts) that the calls fill. The engines call both through
    their modules."""
    from zeroshape_tpu_torch.parallel import train as ptrain

    steps, vals = [], []
    step, validate = ptrain.train_step, getattr(engine, validation)

    def timed_step(*args, **kwargs):
        reset_counts()
        t = time.perf_counter()
        out = step(*args, **kwargs)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t, launch_counts()))
        return out

    def counted_validation(*args, **kwargs):
        reset_counts()
        out = validate(*args, **kwargs)
        torch.cuda.synchronize()
        vals.append(launch_counts())
        return out

    ptrain.train_step = timed_step
    setattr(engine, validation, counted_validation)
    try:
        yield steps, vals
    finally:
        ptrain.train_step = step
        setattr(engine, validation, validate)


def planted_rotation(dev, k=1234):
    """Brute force must recover a rotation planted in an analytic cloud pair."""
    from zeroshape_tpu_torch.camera import get_rotation_sphere
    from zeroshape_tpu_torch.data import analytic
    from zeroshape_tpu_torch.metrics import eval3d

    rng = np.random.default_rng(11)
    sdf, _ = analytic.make_sdf("torus", rng)  # its 10k-point sampling floor is under 0.01
    gt = torch.as_tensor(analytic.surface_points(sdf, 10000, rng), device=dev)
    draw = torch.as_tensor(analytic.surface_points(sdf, 10000, rng), device=dev)
    R = get_rotation_sphere(24, 24, 12, device=dev)
    pred = draw @ R[k]  # R_k^T applied to every point: rotation k undoes it
    with torch.inference_mode():
        acc, comp = eval3d.chamfer_eval(eval3d.normalize_pc(eval3d._rotate(R[k : k + 1], pred)),
                                        eval3d.normalize_pc(gt[None]))
        cd_k = float((acc.mean() + comp.mean()) / 2)
        found = {}
        for name, prune in (("exhaustive", None), ("pruned", (1024, 128))):
            reset_counts()
            t0 = time.perf_counter()
            res = eval3d.brute_force_search(pred, gt, prune=prune, fast_coarse=True)
            cd = float((res["acc"] + res["comp"]) / 2)
            seconds = time.perf_counter() - t0
            found[name] = cd
            n = launch_counts()
            print(f"planted rotation {k}: {name} search CD {cd:.6f} (rotation k {cd_k:.6f}) in {seconds:.3f} s; "
                  f"launches K2 {n['K2']}, K3 {n['K3']}")
            want = {"K2": 288, "K3": 0} if prune is None else {"K2": 6, "K3": 72}
            if {key: n[key] for key in want} != want:
                fail(f"{name} search launched {n}, expected {want}")
            if not cd <= cd_k + 1e-6:
                fail(f"{name} search missed the planted rotation: CD {cd} > {cd_k}")
        if cd_k >= 0.01 or abs(found["exhaustive"] - found["pruned"]) > 1e-6:
            fail(f"rotation k's CD {cd_k} not near the sampling floor, or pruned and exhaustive differ: {found}")
        # ICP from a 5-degree misalignment about z of the normalised draw
        a = np.deg2rad(5.0)
        tilt = torch.tensor([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]],
                            dtype=torch.float32, device=dev)
        gt_n = eval3d.normalize_pc(gt[None])
        start = eval3d.normalize_pc(draw[None]) @ tilt.T
        reset_counts()
        aligned = eval3d.icp(start, gt_n)
        cds = [float(sum(d.mean() for d in eval3d.chamfer_eval(x, gt_n)) / 2) for x in (start, aligned)]
        print(f"ICP (50 iterations, K2 launches {launch_counts()['K2']}): CD {cds[0]:.6f} -> {cds[1]:.6f}")
        if not np.isfinite(cds[1]) or cds[1] >= cds[0]:
            fail("ICP did not lower the CD of a misaligned cloud")


def parse_results(tmp, res, thresholds):
    """Read the three result files back and hold them to the returned metrics."""
    n = len(res["acc"])
    rows = open(os.path.join(tmp, "synthetic_full_results.txt")).read().split("\n")
    if rows[0] != "IND, CD, ACC, COMP, " + ", ".join(f"F-score@{t * 100:.2f}" for t in thresholds):
        fail(f"full-results header {rows[0]!r}")
    for i, row in enumerate(rows[1:]):
        cols = row.split("\t")
        vals = np.array([float(c) for c in cols[1:]])
        want = np.concatenate([[(res["acc"][i] + res["comp"][i]) / 2, res["acc"][i], res["comp"][i]], res["f_score"][i]])
        if int(cols[0]) != res["idx"][i] or len(cols) != 4 + len(thresholds) or np.abs(vals - want).max() > 6e-5:
            fail(f"full-results row {row!r} does not match the metrics")
    cat = open(os.path.join(tmp, "cd_cat.txt")).read().splitlines()
    quant = open(os.path.join(tmp, "quantitative_synthetic.txt")).read().splitlines()
    if len(rows) != n + 1 or cat[0] != "CD     Acc    Comp   Count Cat" or cat[1].split()[3:] != [str(n), "prim"]:
        fail(f"result rows {len(rows) - 1} or cd_cat.txt {cat}")
    if abs(float(quant[1].split()[0]) - np.mean(res["acc"]) / 2 - np.mean(res["comp"]) / 2) > 6e-5 or len(quant) != 2 + len(thresholds):
        fail(f"quantitative file {quant}")


def evaluate_posture(model, samples, training, what=""):
    """One evaluation of ``samples`` through ``bench.evaluate_posture``
    (``shape_engine.evaluate`` at vox 128, eval batch 2, brute force); holds
    its launches, metrics and result files; returns its launches and its
    seconds per sample. ``what`` names the model in the printed line."""
    from zeroshape_tpu_torch import bench
    from zeroshape_tpu_torch.runtime import shape_engine

    name = "validation" if training else "final"
    with tempfile.TemporaryDirectory() as tmp:
        res, opt, n, seconds = bench.evaluate_posture(model, samples, training, tmp)
        thresholds = tuple(opt.eval.f_thresholds)
        if training:  # validation writes no result files (shape_engine.py:605, 711): write them here
            if os.listdir(tmp):
                fail(f"validation wrote {os.listdir(tmp)}")
            with open(os.path.join(tmp, "synthetic_full_results.txt"), "w") as f:
                f.write(shape_engine.full_results_header(thresholds))
                for i in range(len(res["acc"])):
                    f.write(shape_engine.full_results_line(res["idx"][i], res["acc"][i], res["comp"][i], res["f_score"][i]))
            shape_engine.write_summaries(tmp, opt, ["prim"], res["acc"], res["comp"], res["f_score"],
                                         res["category_label"], res["val_metric"])
        else:  # the main path's calibrated field: a mesh and a turntable for every sample
            eval_dumps(tmp, opt.data.dataset_test, res["idx"], "the final posture", meshes=True)
        parse_results(tmp, res, thresholds)
    k = len(samples)
    want = bench.expected_launches(k, training)  # the shipped decoder decodes through K1 only
    print(f"{what}evaluation, {name} posture ({'coarse-to-fine decode, pruned' if training else 'dense decode, exhaustive'} "
          f"search), {k} samples at batch 2: CD {res['val_metric']:.6f}, launches {n} (expected {want}); "
          f"{seconds / k:.3f} s/sample over the run, per batch {[round(x, 4) for x in res['s_per_sample']]}"
          + ("" if training else f"; the dumps {res['dump_seconds'] / k:.4f} s/sample, "
                                 f"{res['dump_seconds'] / seconds:.1%} of the run"))
    if n != want:
        fail(f"{name} posture launched {n}, expected {want}")
    if not all(np.isfinite(res[x]).all() for x in ("acc", "comp", "f_score")):
        fail(f"{name} posture gave non-finite metrics")
    return n, seconds / k


def time_chamfer(x1, x2, fast):
    """(kernel ms, plain ms, library ms, bound ms, bound_by, card bound ms) of K2 (or K3 with ``fast``)."""
    from zeroshape_tpu_torch.compare_chamfer import graph_ms
    from zeroshape_tpu_torch.ops import chamfer as ch

    if fast:
        ms = graph_ms(lambda: ch.nn_min_squared_fast(x1, x2))
        plain_ms = cuda_ms(lambda: ch._nn_min_plain(x1, x2), warmup=1, iters=3)
    else:
        ms = graph_ms(lambda: ch.nn_one_way(x1, x2))
        plain_ms = cuda_ms(lambda: ch._refine(x1, x2, ch._nn_one_way_plain(x1, x2)[1]), warmup=1, iters=3)
    library_ms = cuda_ms(lambda: torch.cdist(x1, x2).min(dim=-1), warmup=1, iters=3)
    torch.cuda.empty_cache()
    B, N, M = x1.shape[0], x1.shape[1], x2.shape[1]
    pairs = B * N * M
    flops = (7 if fast else 9) * pairs  # the JAX CostEstimate per pair (chamfer.py:127-131, 183-187)
    nbytes = (x1.numel() + x2.numel()) * 4 + B * N * (4 if fast else 12)
    bound_ms = max(flops / H100_FP32_FLOPS, nbytes / H100_BYTES_PER_S) * 1e3
    bound_by = "operations" if flops / H100_FP32_FLOPS > nbytes / H100_BYTES_PER_S else "bytes"
    # the card bound: [a, 1].[-2b, |b|^2] on the tensor cores (depth 4 in TF32,
    # 3 in bf16 for K3), one comparison a pair on the SIMT pipes, the bytes
    parts = {"tensor": 2 * (3 if fast else 4) * pairs / (H100_BF16_FLOPS if fast else H100_TF32_FLOPS),
             "comparisons": pairs / H100_LANE_OPS_PER_S, "bytes": nbytes / H100_BYTES_PER_S}
    card_ms = max(parts.values()) * 1e3
    name = "K3" if fast else "K2"
    print(f"{name} time at B={B}, N={N}, M={M}: kernel {ms:.4f} ms (CUDA graph of 20), plain {plain_ms:.3f} ms, "
          f"library (cdist + min) {library_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP "
          f"at fp32 SIMT, {nbytes / 1e6:.2f} MB), {bound_ms / ms:.1%} of it; card bound {card_ms:.4f} ms "
          f"({max(parts, key=parts.get)}: {', '.join(f'{k} {v * 1e3:.4f}' for k, v in parts.items())} ms), "
          f"{card_ms / ms:.1%} of it")
    return ms, plain_ms, library_ms, bound_ms, bound_by, card_ms


def train_run(dev):
    """The ``shape_gen`` recipe through ``shape_engine.train`` for 2 epochs of 3
    steps at batch 8; returns (the run's result, its data, its options, the
    validations' launches summed)."""
    from zeroshape_tpu_torch import config
    from zeroshape_tpu_torch.data import analytic
    from zeroshape_tpu_torch.runtime import shape_engine

    t0 = time.perf_counter()
    data = analytic.train_samples(n_objects=4, n_views=8, H=224, seed=0)
    print(f"training data: {len(data)} training and {len(data.val)} validation views (224^2) made in "
          f"{time.perf_counter() - t0:.1f} s")
    opt = config.override_options(config.shape_gen_opt(), {  # no viz samples: phase 19 dumps them
        "max_epoch": 2, "tb": None, "eval": {"n_vis": 0}, "freq": {"print": 1, "scalar": 3, "ckpt_latest": 1000,
                                                                    "eval": 2}})
    out = tempfile.mkdtemp()  # checkpoints of ~2.3 GB each: removed at once
    try:
        with instrumented(shape_engine, "validate") as (steps, vals):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = shape_engine.train(opt, data, out, device=dev)
            seconds = time.perf_counter() - t0
        files = sorted(os.path.relpath(os.path.join(d, f), out) for d, _, fs in os.walk(out) for f in fs)
    finally:
        shutil.rmtree(out)
    peak = torch.cuda.max_memory_allocated() / 2**30
    s_step = [s for s, _ in steps]
    med = float(np.median(s_step[1:6]))
    in_steps, in_val = summed([n for _, n in steps]), summed(vals)
    print(f"training (shape_gen recipe, batch {opt.batch_size}, bf16 autocast): {len(steps)} steps, median "
          f"{med:.4f} s/step over steps 2-{len(s_step)} (per step {[round(x, 4) for x in s_step]}), "
          f"{opt.batch_size / med:.2f} samples/s; peak memory {peak:.2f} GiB; the whole run {seconds:.1f} s with "
          f"{len(vals)} validations; files written {files}")
    print(f"training losses: {[round(x, 5) for x in res['losses']]}; validation CD {res['val']}; "
          f"best {res['best_val']:.6f} @ epoch {res['best_ep']}")
    print(f"training launches: in the train steps {in_steps}, in validation {in_val} ({len(data.val)} samples each)")
    if len(steps) != 6 or not np.isfinite(res["losses"]).all() or len(res["losses"]) != 6:
        fail(f"training took {len(steps)} steps, losses {res['losses']}")
    if not all(np.isfinite(cd) for _, cd in res["val"]) or [ep for ep, _ in res["val"]] != [0, 2]:
        fail(f"validation {res['val']}")
    if any(in_steps.values()) or in_val["K1"] == 0 or in_val["K2"] == 0 or in_val["K3"] or in_val["plain"]:
        fail(f"launches in the train steps {in_steps} (want none), in validation {in_val} (want K1, K2, no K3, "
             "no plain decode)")
    if sorted(files) != ["best.ckpt", "checkpoint/ep1.ckpt", "latest.ckpt"]:
        fail(f"checkpoint files {files}")
    return res, data, opt, in_val


def train_steps(dev, res, data, opt):
    """:func:`overfit` on the trained graph, then a batch-28 step with the
    shape loss only; returns the batch-28 step's seconds."""
    from zeroshape_tpu_torch import config
    from zeroshape_tpu_torch.parallel import train as ptrain
    from zeroshape_tpu_torch.runtime import shape_engine

    graph = res["graph"]
    overfit(dev, graph, res["optimizer"], data, opt)
    big = config.override_options(copy.deepcopy(opt), {"batch_size": 28, "loss_weight": {"depth": None, "intr": None}})
    batch = shape_engine.to_device(data.batch(np.arange(28), 0, 0, opt.training.n_sdf_points), dev)
    optimizer = ptrain.make_optimizer(graph, big.optim)
    times = []
    for it in range(2):  # a warm-up step at the new shape, then the timed one
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics, _ = ptrain.train_step(graph, optimizer, batch, big, shape_engine.step_generator(0, it, dev))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"batch-28 step (shape loss only): {times[1]:.4f} s ({28 / times[1]:.2f} samples/s; warm-up step "
          f"{times[0]:.4f} s), peak memory {peak:.2f} GiB, loss {float(metrics['loss_all']):.5f}")
    del batch, optimizer, metrics
    torch.cuda.empty_cache()
    return times[1]


def overfit(dev, graph, optimizer, data, opt):
    """20 steps on one fixed batch of 8, continuing the training run's
    optimizer, with every decoder block kept, so that only the updates change
    the loss: the mean of the last 5 losses must fall below 0.9 x the mean
    of the first 5. (A fresh optimizer would first move every parameter by
    lr at once, and the loss jumps before it falls.)"""
    from zeroshape_tpu_torch.parallel import train as ptrain
    from zeroshape_tpu_torch.runtime import shape_engine

    batch = shape_engine.to_device(data.batch(data.batch_order(0, 8, 0)[0], 0, 0, opt.training.n_sdf_points), dev)
    impl = graph.impl_network
    keep = [torch.full((8,), 1 / (1 - impl.drop_path), device=dev) for _ in impl.blocks_attn]
    losses = []
    for _ in range(20):
        metrics, _ = ptrain.train_step(graph, optimizer, batch, opt, dp_masks=keep)
        losses.append(float(metrics["loss_all"]))
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    print(f"overfit on one batch of 8, 20 steps at lr {optimizer.lr():g}, no block dropped: losses "
          f"{[round(x, 5) for x in losses]}; mean of the first 5 {first:.5f}, of the last 5 {last:.5f} "
          f"({last / first:.4f} of it)")
    if not np.isfinite(losses).all() or not last < 0.9 * first:
        fail("20 steps on one fixed batch did not lower the loss below 0.9 x its start")


def tiny_step_case(seed=2):
    """The step that the card and the CPU both take: ``config.tiny_opt(64)``
    in fp32 with every loss weighted as in ``shape_gen`` and lr 1e-2;
    numpy-seeded random weights as the CPU parity tests draw them (parameters
    and running means N(0, 0.05), running variances U(0.6, 1.4)), the depth
    head's last conv scaled into its clamp so that every encoder gets a
    gradient; a random batch of 4 whose samples differ in brightness and mask
    rate; shared stochastic-depth masks. Returns ``(opt, graph, batch, masks)``."""
    from zeroshape_tpu_torch import config
    from zeroshape_tpu_torch.models.graph_shape import ShapeGraph

    H, B, n_pts = 64, 4, 64
    opt = config.tiny_opt(H)
    opt.arch.dtype = "float32"
    opt.loss_weight = {"shape": 1, "depth": 1, "intr": 10}
    opt.optim.lr = opt.optim.lr_ft = 1e-2
    graph = ShapeGraph.from_opt(opt)
    rng = np.random.default_rng(seed)
    numpy_weights(graph, rng)
    batch = step_batch(rng, H, B, n_pts)
    masks = [torch.tensor([1 / 0.9, 0.0, 1 / 0.9, 1 / 0.9]), torch.tensor([0.0, 1 / 0.9, 1 / 0.9, 0.0])]
    return opt, graph, batch, masks


def numpy_weights(graph, rng):
    """Draw ``graph``'s weights from ``rng`` as the CPU parity tests do
    (parameters and running means N(0, 0.05), running variances U(0.6, 1.4))
    and scale its depth head's last conv into the head's clamp."""
    params = dict(graph.named_parameters())
    with torch.no_grad():
        for k, t in graph.state_dict().items():
            if k.endswith("running_var"):
                t.copy_(torch.from_numpy(rng.uniform(0.6, 1.4, t.shape).astype(np.float32)))
            elif k in params or k.endswith("running_mean"):
                t.copy_(torch.from_numpy(rng.normal(0.0, 0.05, t.shape).astype(np.float32)))
        head = graph.dpt_depth.scratch.output_conv[4]
        head.weight.mul_(1e-2)
        head.bias.fill_(0.5)


def step_batch(rng, H, B, n_pts):
    """A random training batch of ``B`` samples at ``H`` whose samples differ
    in brightness and mask rate, drawn from ``rng``, as CPU tensors."""
    f = 1.3875 * H
    K = np.array([[f, 0, H / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    pose = np.concatenate([np.eye(3), [[0.0], [0.0], [1.78]]], axis=1)
    batch = {
        "rgb_input_map": rng.uniform(0, 1, (B, H, H, 3)) * np.linspace(0.3, 1.0, B)[:, None, None, None],
        "mask_input_map": rng.uniform(size=(B, H, H, 1)) < np.linspace(0.2, 0.9, B)[:, None, None, None],
        "depth_input_map": rng.uniform(0.4, 1, (B, H, H, 1)),
        "intr": np.tile(K, (B, 1, 1)),
        "pose_gt": np.tile(pose, (B, 1, 1)),
        "gt_sample_points": rng.normal(size=(B, n_pts, 3)) * 0.3,
        "gt_sample_sdf": rng.normal(size=(B, n_pts)) * 0.05,
    }
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in batch.items()}


def masks_to(masks, where):
    """Stochastic-depth masks (a list, a dict by module, tuples of a block's
    two) moved to ``where``; None stays None."""
    if masks is None:
        return None
    if isinstance(masks, dict):
        return {k: masks_to(v, where) for k, v in masks.items()}
    if isinstance(masks, (list, tuple)):
        return type(masks)(masks_to(m, where) for m in masks)
    return masks.to(where)


def step_on(where, opt, graph, batch, masks, threads=None, **step_kw):
    """One :func:`tiny_step_case` (or :func:`depth_step_case`, without
    ``masks``, with its ``loss_fn``) step on ``where`` (on the CPU with
    ``threads`` threads if given): ``(state dict, gradients, metrics)``, all on
    the CPU."""
    from zeroshape_tpu_torch.parallel import train as ptrain

    n = torch.get_num_threads()
    torch.set_num_threads(threads or n)
    try:
        g = copy.deepcopy(graph).to(where).train()
        optimizer = ptrain.make_optimizer(g, opt.optim)
        grads = ptrain.capture_grads(g, optimizer)
        metrics, _ = ptrain.train_step(g, optimizer, {k: v.to(where) for k, v in batch.items()}, opt,
                                       dp_masks=masks_to(masks, where), **step_kw)
    finally:
        torch.set_num_threads(n)
    return ({k: v.cpu() for k, v in g.state_dict().items()}, {k: v.cpu() for k, v in grads.items()},
            {k: float(v) for k, v in metrics.items()})


def step_disagreements(opt, graph, cpu, card, cpu_1, min_live=500):
    """What differs between the CPU's and the card's step beyond the stated
    tolerances, as a list of strings, and a summary dict. ``cpu_1`` is the
    CPU's step on one thread: the gradient of an fp32 step is only as
    reproducible as its sums' order allows, and the coordinate encoder's
    (BatchNorm over 4 samples on 1x1 maps) moves by some 2e-2 of its norm
    between thread counts, while the other modules move by ~1e-5. So each
    module (a top-level child of the graph) gets a relative tolerance r, 1e-3
    or 4x what the two CPU runs differ by, relative to its gradient norm,
    where that is larger:

    * losses: 1e-4 relative;
    * each module's gradient: the norm of the difference within r x its
      gradient norm;
    * each parameter's gradient: max |d| within r x its norm + 1e-5 x its
      module's + 4 x the CPU runs' max |d|;
    * the update: the card's parameters against the CPU optimizer applied to
      the card's gradients, 1e-4, which is 1% of AdamW's first step at lr
      1e-2 (against the CPU's own step, an element whose gradient lies
      within rounding of zero may move by +-lr either way);
    * BatchNorm statistics: 1e-4, relative above 1;
    * at least ``min_live`` parameters with a nonzero gradient.
    """
    from zeroshape_tpu_torch.parallel import train as ptrain

    (cpu_sd, cpu_g, cpu_m), (card_sd, card_g, card_m), one_g = cpu, card, cpu_1[1]
    bad = [f"loss {k}: {card_m[k]} vs {v}" for k, v in cpu_m.items() if abs(card_m[k] - v) > 1e-4 * max(1.0, abs(v))]
    if not card_g.keys() == cpu_g.keys() == one_g.keys():
        return bad + ["different parameters have gradients"], {}

    def dist(x, y, ks):
        return float(torch.sqrt(sum((x[k].double() - y[k].double()).square().sum() for k in ks)))

    mods = {}
    for k in cpu_g:
        mods.setdefault(k.split(".")[0], []).append(k)
    summary = {"live": sum(float(v.norm()) > 0 for v in cpu_g.values()), "modules": {}}
    zero = {k: torch.zeros_like(v) for k, v in cpu_g.items()}
    for m, ks in mods.items():
        norm, diff, spread = dist(cpu_g, zero, ks), dist(card_g, cpu_g, ks), dist(one_g, cpu_g, ks)
        rel = max(1e-3, 4 * spread / max(norm, 1e-30))
        summary["modules"][m] = (diff / max(norm, 1e-30), spread / max(norm, 1e-30), norm)
        if diff > rel * norm:
            bad.append(f"module {m}: |d| {diff:.3e} of a gradient norm {norm:.3e} (CPU runs {spread:.3e})")
        for k in ks:
            d = float((card_g[k] - cpu_g[k]).abs().max())
            if d > rel * float(cpu_g[k].norm()) + 1e-5 * norm + 4 * float((one_g[k] - cpu_g[k]).abs().max()):
                bad.append(f"gradient {k}: max|d| {d:.3e}, norm {float(cpu_g[k].norm()):.3e}")
    ref = copy.deepcopy(graph).train()
    ref_opt = ptrain.make_optimizer(ref, opt.optim)
    for n, p in ref.named_parameters():
        p.grad = card_g.get(n)
    ref_opt.step()
    summary["update"] = max(float((card_sd[n] - p.detach()).abs().max()) for n, p in ref.named_parameters())
    summary["stats"] = max(float(((card_sd[k] - v).abs() / v.abs().clamp(min=1)).max()) for k, v in cpu_sd.items()
                           if "running_" in k)
    if not summary["update"] <= 1e-4:
        bad.append(f"update max|d| {summary['update']:.3e}")
    if not summary["stats"] <= 1e-4:
        bad.append(f"BatchNorm statistics max|d| {summary['stats']:.3e}")
    if summary["live"] < min_live:
        bad.append(f"only {summary['live']} parameters have a gradient")
    return bad, summary


def cuda_against_cpu(dev):
    """:func:`tiny_step_case`'s step on the card and on the CPU (and on one
    CPU thread), TF32 off, held to :func:`step_disagreements`; returns the
    max |d| of the update."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opt, graph, batch, masks = tiny_step_case()
    cpu = step_on("cpu", opt, graph, batch, masks)
    cpu_1 = step_on("cpu", opt, graph, batch, masks, threads=1)
    card = step_on(dev, opt, graph, batch, masks)
    bad, summary = step_disagreements(opt, graph, cpu, card, cpu_1)
    mods = ", ".join(f"{m} {r:.2e} (CPU runs {x:.2e}, norm {n:.3g})" for m, (r, x, n) in
                     summary.get("modules", {}).items())
    print(f"train step at tiny width (fp32, TF32 off, H=64, batch 4, lr 1e-2), card against CPU: loss "
          f"{card[2]['loss_all']:.6f} vs {cpu[2]['loss_all']:.6f}; {summary.get('live')} parameters with a gradient; "
          f"gradient |d| / norm by module: {mods}; update against the CPU optimizer on the card's gradients max|d| "
          f"{summary.get('update', float('nan')):.3e}; BatchNorm statistics max rel|d| "
          f"{summary.get('stats', float('nan')):.3e}")
    if bad:
        fail(f"the training step on the card disagrees with the CPU: {bad[:6]} ({len(bad)} in all)")
    return summary["update"]


def checkpoint_round_trip(res, opt):
    """Save the trained graph and optimizer, load both into fresh ones, compare."""
    from zeroshape_tpu_torch.models import resolve_compute_dtype
    from zeroshape_tpu_torch.models.graph_shape import ShapeGraph
    from zeroshape_tpu_torch.parallel import train as ptrain
    from zeroshape_tpu_torch.runtime import engine_base

    graph, optimizer = res["graph"], res["optimizer"]
    dev = next(graph.parameters()).device
    out = tempfile.mkdtemp()
    try:
        t0 = time.perf_counter()
        path = engine_base.save_checkpoint(out, graph, optimizer, 1, res["it"], res["best_val"], res["best_ep"],
                                           latest=True)
        size = os.path.getsize(path)
        fresh = ShapeGraph.from_opt(opt, dtype=resolve_compute_dtype(opt, dev)).to(dev)
        fresh_opt = ptrain.make_optimizer(fresh, opt.optim)
        meta = engine_base.restore_checkpoint(path, fresh, fresh_opt)
        seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(out)
    want = graph.state_dict()
    same = all(torch.equal(v, want[k]) for k, v in fresh.state_dict().items())
    st, st_want = fresh_opt.state_dict()["adamw"]["state"], optimizer.state_dict()["adamw"]["state"]
    same_opt = st.keys() == st_want.keys() and all(
        torch.equal(st[i][n], st_want[i][n]) for i in st for n in ("exp_avg", "exp_avg_sq"))
    print(f"checkpoint round trip: {size / 2**30:.2f} GiB written and read back in {seconds:.1f} s; "
          f"state dict equal {same}, optimizer state equal {same_opt}, meta {meta}")
    if not (same and same_opt and meta["iter"] == res["it"]):
        fail("the checkpoint did not round-trip")


GATE_CD_BOUND = 0.11  # tests/test_accuracy_gate.py's CD_BOUND


def accuracy_gate(dev):
    """The accuracy gate (``tests/test_accuracy_gate.py``) through
    ``shape_engine.train``: ``config.accuracy_gate_opt()`` from random
    weights, bf16 autocast, on ``train_samples(4, 6, 64, seed=0,
    n_pc_points=2048, n_sdf_points=4096, val_views=1)``, 24 epochs of 2
    steps, validated before the first step and after the last. Fails unless
    the best CD is below 0.11. Its decoder (C=64) is not K1's: its
    validations decode plainly and score through K2. Returns the
    validations' launches summed."""
    from zeroshape_tpu_torch import config
    from zeroshape_tpu_torch.data import analytic
    from zeroshape_tpu_torch.runtime import shape_engine

    data = analytic.train_samples(4, 6, 64, seed=0, n_pc_points=2048, n_sdf_points=4096, val_views=1)
    opt = config.accuracy_gate_opt()
    out = tempfile.mkdtemp()
    try:
        with instrumented(shape_engine, "validate") as (steps, vals):
            t0 = time.perf_counter()
            res = shape_engine.train(opt, data, out, device=dev)
            seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(out)
    s_step = [s for s, _ in steps]
    in_steps, in_val = summed([n for _, n in steps]), summed(vals)
    print(f"accuracy gate ({len(data)} training views of 64^2, batch {opt.batch_size}, {opt.max_epoch} epochs, "
          f"bf16 autocast): {len(steps)} steps, median {np.median(s_step[1:]):.4f} s/step (first "
          f"{s_step[0]:.4f}), the whole run {seconds:.1f} s; losses first 4 "
          f"{[round(x, 4) for x in res['losses'][:4]]}, last 4 {[round(x, 4) for x in res['losses'][-4:]]}")
    for (ep, cd), n in zip(res["val"], vals):
        print(f"accuracy gate validation at epoch {ep}: CD {cd:.6f}; launches {n}")
    print(f"accuracy gate: best CD {res['best_val']:.6f} @ epoch {res['best_ep']} (bound {GATE_CD_BOUND}); "
          f"launches in the train steps {in_steps}, in validation {in_val}")
    if len(steps) != 48 or [ep for ep, _ in res["val"]] != [0, opt.max_epoch]:
        fail(f"the gate took {len(steps)} steps and validated at {[ep for ep, _ in res['val']]}")
    if any(in_steps.values()) or in_val["K1"] or not in_val["K2"] or in_val["K3"] or not in_val["plain"]:
        fail(f"gate launches in steps {in_steps} (want none), in validation {in_val} (want K2 and plain decodes)")
    if not np.isfinite(res["losses"]).all() or not res["best_val"] < GATE_CD_BOUND:
        fail(f"the accuracy gate's best CD {res['best_val']} is not below {GATE_CD_BOUND}")
    return in_val


def depth_run(dev, data, out):
    """The ``depth_gen`` recipe through ``depth_engine.train`` at full width
    (224^2, bf16 autocast, batch 8) on the training run's data: 2 epochs of 3
    steps, validation before the first step and after epoch 2; then the
    final-metrics evaluation of the trained graph, which writes
    ``best_val.txt``. Checkpoints stay in ``out``. Returns (the run's
    result, its options)."""
    from zeroshape_tpu_torch import config
    from zeroshape_tpu_torch.metrics.depth_metrics import metric_keys
    from zeroshape_tpu_torch.runtime import depth_engine, engine_base

    opt = config.override_options(config.depth_gen_opt(), {
        "max_epoch": 2, "tb": None, "freq": {"print": 1, "scalar": 3, "ckpt_latest": 1000, "eval": 2}})
    keys = metric_keys(tuple(opt.eval.d_thresholds))
    reset_counts()
    with instrumented(depth_engine, "evaluate") as (steps, vals):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = depth_engine.train(opt, data, out, device=dev)
        seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    reset_counts()
    final = depth_engine.evaluate(res["graph"], data.val, opt, out, training=False, device=dev)
    torch.cuda.synchronize()
    every = summed([n for _, n in steps] + vals + [launch_counts()])
    files = sorted(os.path.relpath(os.path.join(d, f), out) for d, _, fs in os.walk(out) for f in fs)
    s_step = [s for s, _ in steps]
    med = float(np.median(s_step[1:6]))
    print(f"depth training (depth_gen recipe, batch {opt.batch_size}, bf16 autocast): {len(steps)} steps, median "
          f"{med:.4f} s/step over steps 2-{len(s_step)} (per step {[round(x, 4) for x in s_step]}), "
          f"{opt.batch_size / med:.2f} samples/s; peak memory {peak:.2f} GiB; the whole run {seconds:.1f} s with "
          f"{len(vals)} validations; files written {files}")
    print(f"depth training losses: {[round(x, 5) for x in res['losses']]}; best l1_err {res['best_val']:.6f} @ "
          f"epoch {res['best_ep']}")
    for ep, scalars in res["val_scalars"]:
        print(f"depth validation at epoch {ep}: " + ", ".join(f"{k} {scalars['eval/' + k]:.6f}" for k in keys))
    written = dict(line.split(": ") for line in open(os.path.join(out, "best_val.txt")).read().splitlines())
    print(f"depth final metrics ({len(data.val)} samples): {final}; best_val.txt {written}; launches {every}")
    if len(steps) != 6 or not np.isfinite(res["losses"]).all() or [ep for ep, _ in res["val"]] != [0, 2]:
        fail(f"depth training took {len(steps)} steps, losses {res['losses']}, validations {res['val']}")
    if not all(np.isfinite(list(v.values())).all() for _, v in res["val_scalars"]) or not np.isfinite(
            list(final.values())).all():
        fail("depth metrics not finite")
    if list(written) != keys or any(abs(float(written[k]) - final[k]) > 1e-6 for k in keys):
        fail(f"best_val.txt {written} does not hold the final metrics {final}")
    viz = [int(s["idx"][0]) for s in engine_base.viz_samples(data.val, opt.eval.n_vis)]
    want = ["best.ckpt", "best_val.txt", "checkpoint/ep1.ckpt", "latest.ckpt"]
    want += [f"vis_log/iter_0/{i}_{f}" for i in viz for f in ("depth_est.png", "depth_input.png", "image_input.png",
                                                              "mask_input.png", "seen_surface.ply")]
    want += [f"dump_synthetic/{int(s['idx'])}_{f}" for s in data.val for f in ("depth_est.png", "image_input.png")]
    if sorted(files) != sorted(want):
        fail(f"depth run files {files}, want {sorted(want)}")
    check_dumps(out)
    if any(every.values()):
        fail(f"the depth run launched {every}: it has no kernel and no implicit decoder")
    return res, opt


def depth_overfit(dev, res, data, opt):
    """20 depth steps on one fixed batch of 8, continuing the depth run's
    optimizer: the mean of the last 5 losses must fall below 0.9 x the mean
    of the first 5."""
    from zeroshape_tpu_torch.models import graph_depth
    from zeroshape_tpu_torch.parallel import train as ptrain
    from zeroshape_tpu_torch.runtime import depth_engine, shape_engine

    batch = shape_engine.to_device(data.batch(data.batch_order(0, 8, 0)[0], 0, 0), dev, depth_engine.MODEL_KEYS)
    graph, optimizer = res["graph"], res["optimizer"]
    losses = []
    for _ in range(20):
        metrics, _ = ptrain.train_step(graph, optimizer, batch, opt, loss_fn=graph_depth.compute_loss,
                                       metrics_fn=None)
        losses.append(float(metrics["loss_all"]))
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    print(f"depth overfit on one batch of 8, 20 steps at lr {optimizer.lr():g}: losses "
          f"{[round(x, 5) for x in losses]}; mean of the first 5 {first:.5f}, of the last 5 {last:.5f} "
          f"({last / first:.4f} of it)")
    if not np.isfinite(losses).all() or not last < 0.9 * first:
        fail("20 depth steps on one fixed batch did not lower the loss below 0.9 x its start")


def depth_step_case(seed=3):
    """The depth step that the card and the CPU both take: the depth graph of
    ``config.depth_gen_opt(64)`` in fp32 at lr 1e-2, with weights drawn as
    :func:`tiny_step_case` draws them and its depth head scaled into its
    clamp, and a random batch of 4 (:func:`step_batch`). Returns ``(opt, graph,
    batch)``."""
    from zeroshape_tpu_torch import config
    from zeroshape_tpu_torch.models.graph_depth import DepthGraph
    from zeroshape_tpu_torch.runtime import depth_engine

    opt = config.depth_gen_opt(64)
    opt.arch.dtype = "float32"
    opt.optim.lr = 1e-2
    graph = DepthGraph.from_opt(opt)
    rng = np.random.default_rng(seed)
    numpy_weights(graph, rng)
    batch = step_batch(rng, 64, 4, 1)
    return opt, graph, {k: batch[k] for k in depth_engine.MODEL_KEYS}


def depth_against_cpu(dev):
    """:func:`depth_step_case`'s step on the card and on the CPU (and on one
    CPU thread), TF32 off, held to :func:`step_disagreements`, every
    parameter that the step can reach with a gradient."""
    from zeroshape_tpu_torch.models import graph_depth

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opt, graph, batch = depth_step_case()
    kw = dict(loss_fn=graph_depth.compute_loss, metrics_fn=None)
    cpu = step_on("cpu", opt, graph, batch, None, **kw)
    cpu_1 = step_on("cpu", opt, graph, batch, None, threads=1, **kw)
    reset_counts()
    card = step_on(dev, opt, graph, batch, None, **kw)
    torch.cuda.synchronize()
    n = launch_counts()
    # all but the never-run refinenet4 unit and the ViT's last LayerNorm, whose output the DPT does not read
    reachable = sum(not any(u in k for u in ("refinenet4.resConfUnit1.", "pretrained.model.norm."))
                    for k, _ in graph.named_parameters())
    bad, summary = step_disagreements(opt, graph, cpu, card, cpu_1, min_live=reachable)
    mods = ", ".join(f"{m} {r:.2e} (CPU runs {x:.2e}, norm {nrm:.3g})" for m, (r, x, nrm) in
                     summary.get("modules", {}).items())
    print(f"depth step (fp32, TF32 off, H=64, batch 4, lr 1e-2), card against CPU: loss {card[2]['loss_all']:.6f} "
          f"vs {cpu[2]['loss_all']:.6f}; {summary.get('live')} of {reachable} parameters with a gradient; gradient "
          f"|d| / norm by module: {mods}; update max|d| {summary.get('update', float('nan')):.3e}; BatchNorm "
          f"statistics max rel|d| {summary.get('stats', float('nan')):.3e}; launches {n}")
    if bad or any(n.values()):
        fail(f"the depth step on the card disagrees with the CPU or launched {n}: {bad[:6]} ({len(bad)} in all)")


class _Stop(Exception):
    """Ends a run at its first step, once that step's inputs were checked."""


@contextlib.contextmanager
def first_step_check(check):
    """Hand ``check(graph, optimizer)`` the graph and optimizer of the first
    ``parallel.train.train_step`` call; ``check`` returns whether the run
    goes on (else it ends with :class:`_Stop`)."""
    from zeroshape_tpu_torch.parallel import train as ptrain

    step, seen = ptrain.train_step, []

    def checked(graph, optimizer, *args, **kwargs):
        if not seen:
            seen.append(1)
            if not check(graph, optimizer):
                raise _Stop
        return step(graph, optimizer, *args, **kwargs)

    ptrain.train_step = checked
    try:
        yield seen
    finally:
        ptrain.train_step = step


def differing(graph, want, prefixes):
    """The keys under ``prefixes`` where ``graph``'s state differs from ``want``'s, bit for bit."""
    got = graph.state_dict()
    return [k for k in got if k.startswith(prefixes) and not torch.equal(got[k].cpu(), want[k])]


def staged_run(dev, data, depth_ckpt, out):
    """A ``shape_gen`` run with ``pretrain.depth`` set to the depth run's
    ``best.ckpt``: before its first step its DPT and intrinsics head
    (parameters and BatchNorm statistics) must equal the checkpoint's and
    the rest ``init_like_flax(seed)``'s, bit for bit; 1 epoch of 3 steps and
    its validations must launch K1 and K2 and decode nothing plainly.
    Checkpoints go to ``out``. Returns the validations' launches summed."""
    from zeroshape_tpu_torch import config
    from zeroshape_tpu_torch.models.graph_shape import ShapeGraph
    from zeroshape_tpu_torch.runtime import shape_engine
    from zeroshape_tpu_torch.weights import init_like_flax

    opt = config.override_options(config.shape_gen_opt(), {
        "max_epoch": 1, "tb": None, "pretrain": {"depth": depth_ckpt}, "eval": {"n_vis": 0},
        "freq": {"print": 1, "scalar": 3, "ckpt_latest": 1000, "eval": 1}})
    pre = torch.load(depth_ckpt, map_location="cpu", weights_only=True)["graph"]
    fresh = init_like_flax(ShapeGraph.from_opt(opt), opt.seed).state_dict()
    found = {}

    def check(graph, _):
        found["staged"] = differing(graph, pre, ("dpt_depth.", "intr_head.", "intr_proj."))
        found["fresh"] = differing(graph, fresh, ("coord_encoder.", "impl_network."))
        found["n"] = sum(k.startswith(("dpt_depth.", "intr_head.", "intr_proj.")) for k in graph.state_dict())
        return True

    with first_step_check(check), instrumented(shape_engine, "validate") as (steps, vals):
        res = shape_engine.train(opt, data, out, device=dev)
    in_steps, in_val = summed([n for _, n in steps]), summed(vals)
    print(f"staged shape run (pretrain.depth = the depth run's best.ckpt): before the first step "
          f"{found['n'] - len(found['staged'])} of {found['n']} dpt_depth / intr_head / intr_proj tensors equal the "
          f"checkpoint's bit for bit, coord_encoder / impl_network differ from init_like_flax at "
          f"{len(found['fresh'])} tensors; {len(steps)} steps, losses {[round(x, 5) for x in res['losses']]}; "
          f"validation CD {res['val']}; launches in the steps {in_steps}, in validation {in_val}")
    if found["staged"] or found["fresh"] or not found["n"]:
        fail(f"staging: differing {found['staged'][:5]} from the checkpoint, {found['fresh'][:5]} from the init")
    if len(steps) != 3 or not np.isfinite(res["losses"]).all():
        fail(f"the staged run took {len(steps)} steps, losses {res['losses']}")
    if any(in_steps.values()) or not in_val["K1"] or not in_val["K2"] or in_val["K3"] or in_val["plain"]:
        fail(f"staged run launches in steps {in_steps}, in validation {in_val} (want K1 and K2, nothing plain)")
    return in_val


def load_run(dev, data, ckpt):
    """A fresh ``shape_gen`` run with ``load`` set to ``ckpt`` must start
    from its weights, bit for bit, with an optimizer that has taken no
    step; the run ends at its first step."""
    from zeroshape_tpu_torch import config
    from zeroshape_tpu_torch.runtime import shape_engine

    opt = config.override_options(config.shape_gen_opt(), {"max_epoch": 1, "tb": None, "debug": True, "load": ckpt})
    want = torch.load(ckpt, map_location="cpu", weights_only=True)["graph"]
    found = {}

    def check(graph, optimizer):
        found["differ"] = differing(graph, want, ("",))
        found["optimizer"] = (optimizer.updates, len(optimizer.adamw.state))
        return False

    out = tempfile.mkdtemp()
    try:
        with first_step_check(check):
            try:
                shape_engine.train(opt, data, out, device=dev)
            except _Stop:
                pass
    finally:
        shutil.rmtree(out)
    print(f"--load of the staged run's latest.ckpt: {len(want) - len(found.get('differ', want))} of {len(want)} "
          f"tensors equal the checkpoint's at the first step; optimizer (updates, states) {found.get('optimizer')}")
    if "differ" not in found or found["differ"] or found["optimizer"] != (0, 0):
        fail(f"--load did not start from the checkpoint's weights with a fresh optimizer: {found}")


# ---------------------------------------------------------------------------
# datasets on disk, the CLIs and two ranks (phases 18-22)
# ---------------------------------------------------------------------------

TREE = dict(n_objects=4, n_views=8, H=224, seed=0, n_pc_points=10000, n_sdf_points=20000, val_views=1,
            holdout_objects=2)


def write_tree(root, data):
    """Phase 18: the held-out analytic tree (4 + 2 objects x 8 views) on disk;
    its loader's samples must equal the in-memory split of phase 11 (the same
    draws for the seen objects) bit for bit, but for the category label."""
    from zeroshape_tpu_torch import config
    from zeroshape_tpu_torch.data import analytic, native
    from zeroshape_tpu_torch.data.synthetic import SyntheticDataset

    t0 = time.perf_counter()
    analytic.generate_dataset(root, **TREE)
    seconds = time.perf_counter() - t0
    opt = config.Config({"H": 224, "W": 224, "seed": 0, "training": {"n_sdf_points": 4096},
                         "data": {"root": root, "synthetic": {"subset": "analytic", "percentage": 1}}})
    train, test = SyntheticDataset(opt, split="train"), SyntheticDataset(opt, split="test")
    decoder = "zsdl" if native.available() else f"the port's PNG decoder (zsdl: {native.unavailable_reason().splitlines()[0]})"
    t0 = time.perf_counter()
    pairs = [(train[i], data.sample(i, 0, 0, 4096)) for i in (0, 13, 27)]
    load_s = (time.perf_counter() - t0) / 3
    pairs += [(test[16 + i], data.val[i]) for i in range(len(data.val))]
    bad = [k for got, want in pairs for k in want if k not in ("idx", "category_label", "dpc")
           and not np.array_equal(got[k], want[k])]
    bad += ["dpc" for got, want in pairs if "dpc" in want and not np.array_equal(got["dpc"]["points"],
                                                                                 want["dpc"]["points"])]
    print(f"dataset tree: {len(train)} training and {len(test)} validation views (categories {test.label2cat}) "
          f"written in {seconds:.1f} s; images decoded by {decoder}, {load_s * 1e3:.1f} ms a training sample; "
          f"{len(pairs)} samples against the in-memory split: {len(bad)} keys differ")
    if len(train) != 28 or len(test) != 20 or test.label2cat != ["ho0", "ho1", "prim"] or bad:
        fail(f"the tree's loader: {len(train)} / {len(test)} samples, {test.label2cat}, differing {bad[:5]}")


def cli_argv(root, out):
    """The train CLI's arguments of phase 19 (and of its two-rank run in phase 22)."""
    return ["--task=shape", f"--data.root={root}", f"--output_path={out}", "--max_epoch=1", "--tb=null",
            "--freq.print=1", "--freq.scalar=1", "--freq.ckpt_latest=1000", "--freq.eval=1"]


def train_cli(root, out):
    """Phase 19: ``python -m zeroshape_tpu_torch.train --task=shape`` on the
    tree: 1 epoch of 3 steps at batch 8, validation on the 20 views before
    and after, the train-split metrics every step. Returns (the validation and
    train-metric launches summed, the run's result)."""
    from zeroshape_tpu_torch import train
    from zeroshape_tpu_torch.runtime import shape_engine

    argv = cli_argv(root, out) + ["--eval.n_vis=2", "--freq.save_vis=2"]  # the dumps of phase 27
    metric_calls, metrics_fn = [], shape_engine.train_metrics

    def counted(*args, **kwargs):
        reset_counts()
        got = metrics_fn(*args, **kwargs)
        torch.cuda.synchronize()
        metric_calls.append(launch_counts())
        return got

    shape_engine.train_metrics = counted
    try:
        with instrumented(shape_engine, "validate") as (steps, vals):
            t0 = time.perf_counter()
            res = train.main(argv)
            seconds = time.perf_counter() - t0
    finally:
        shape_engine.train_metrics = metrics_fn
    s_step = [s for s, _ in steps]
    wait = res["loader_wait"]
    share = wait / (wait + sum(s_step))
    in_val, in_metrics = summed(vals), summed(metric_calls)
    train_scalars = [s for _, s in res["train_scalars"]]
    print(f"train CLI on the tree (shape_gen, batch 8, bf16): {len(s_step)} steps, {[round(x, 4) for x in s_step]} "
          f"s/step (median {np.median(s_step):.4f}); waited {wait:.4f} s for the loader, {share:.1%} of the steps' "
          f"time; the run {seconds:.1f} s; validation CD {res['val']}")
    print(f"train CLI scalars: train/dist_acc {[round(s['train/dist_acc'], 5) for s in train_scalars]}, "
          f"eval/dist_acc {[round(s['eval/dist_acc'], 5) for _, s in res['val_scalars']]}; launches in "
          f"{len(vals)} validations {in_val}, in {len(metric_calls)} train-split metrics {in_metrics}")
    finite = all(np.isfinite(s.get("train/dist_acc", np.nan)) for s in train_scalars) and all(
        np.isfinite(s["eval/dist_acc"]) for _, s in res["val_scalars"])
    if len(s_step) != 3 or not finite or len(train_scalars) != 3 or len(vals) != 2:
        fail(f"train CLI: {len(s_step)} steps, scalars {train_scalars}, validations {res['val_scalars']}")
    if not in_val["K1"] or not in_val["K2"] or not in_metrics["K1"] or not in_metrics["K2"] or in_val["plain"]:
        fail(f"train CLI launches: validation {in_val}, train-split metrics {in_metrics} (want K1 and K2)")
    training_dumps(root, out)
    return summed([in_val, in_metrics]), res


def read_results(out, dataset):
    """``{idx: CD}`` of ``{dataset}_full_results.txt`` and the rows of ``cd_cat.txt``."""
    rows = open(os.path.join(out, f"{dataset}_full_results.txt")).read().split("\n")[1:]
    cds = {int(r.split("\t")[0]): float(r.split("\t")[1]) for r in rows}
    cats = [line.split() for line in open(os.path.join(out, "cd_cat.txt")).read().splitlines()[1:]]
    return cds, cats


def evaluate_cli(argv, what, n):
    """``python -m zeroshape_tpu_torch.evaluate`` in this process; returns
    (its result, launches, seconds a sample)."""
    from zeroshape_tpu_torch import evaluate

    reset_counts()
    t0 = time.perf_counter()
    res = evaluate.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    n_launch = launch_counts()
    res["seconds"] = seconds
    print(f"evaluate CLI, {what}: {len(res['acc'])} samples, CD {res['val_metric']:.6f}, {seconds:.1f} s with the "
          f"graph's set-up, {np.mean(res['s_per_sample']):.4f} s/sample in the loop; launches {n_launch}; the dumps "
          f"{res['dump_seconds'] / n:.4f} s/sample, {res['dump_seconds'] / seconds:.1%} of the CLI's time")
    if len(res["acc"]) != n or not all(np.isfinite(res[k]).all() for k in ("acc", "comp", "f_score")):
        fail(f"evaluate CLI, {what}: {len(res['acc'])} samples, metrics {res['acc']}")
    return res, n_launch


def evaluate_tree(root, out):
    """Phase 20: the evaluate CLI with ``--resume`` of phase 19's run (its
    ``best.ckpt`` in ``out``, where the result files go too), final posture
    with brute force, at eval batch 2; result files parsed back."""
    argv = ["--task=shape", f"--data.root={root}", f"--output_path={out}", "--resume", "--eval.brute_force",
            "--eval.batch_size=2"]
    res, n = evaluate_cli(argv, "the tree, --resume, final posture with brute force", 20)
    cds, cats = read_results(out, "synthetic")
    print(f"evaluate CLI: files in the run's directory {sorted(os.listdir(out))}; cd_cat.txt {cats}")
    if sorted(c[4] for c in cats) != ["ho0", "ho1", "prim"] or [int(c[3]) for c in cats] != [8, 8, 4]:
        fail(f"cd_cat.txt rows {cats}")
    if sorted(cds) != list(range(20)) or max(abs(cds[i] - (res["acc"][i] + res["comp"][i]) / 2) for i in cds) > 6e-5:
        fail("the full results do not hold the returned metrics")
    if n["K1"] != 20 or n["K2"] != 288 * 20 or n["K3"]:
        fail(f"final posture launches {n}, expected K1 20, K2 {288 * 20}, K3 0")
    eval_dumps(out, "synthetic", res["idx"], "the evaluate CLI on the tree")
    return res, n


def write_layout_trees(root):
    """Phase 21's trees from analytic renders, PNG only: Pix3D (images and
    masks at 256^2, so the loader resizes to 224), OCRTOC (every 5th of 10
    views) and OmniObject3D (4 views)."""
    import json

    from zeroshape_tpu_torch.data import analytic
    from zeroshape_tpu_torch.data.common import write_png

    def render(size, k):
        rng = np.random.default_rng(100 + k)
        sdf, albedo = analytic.make_sdf(analytic.SDF_KINDS[k % 5], rng)
        f = 1.3875 * size
        K = np.array([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]], np.float32)
        pose = analytic.look_at_pose(analytic._camera_ring(8, rng)[k % 8])
        rgb, depth, _ = analytic.render_scene(sdf, albedo, K, pose, size, size)
        return (rgb * 255).astype(np.uint8), depth, pose, analytic.surface_points(sdf, 10000, rng)

    base = os.path.join(root, "Pix3D")
    for k, c in enumerate(("chair", "table")):
        for sub in ("lists", f"annotation/{c}", f"img_processed/{c}", f"mask_processed/{c}", f"pointclouds/{c}/m"):
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        rgb, depth, pose, pc = render(256, k)
        write_png(os.path.join(base, f"img_processed/{c}/0000.png"), rgb)
        write_png(os.path.join(base, f"mask_processed/{c}/0000.png"), ((depth > 0) * 255).astype(np.uint8))
        with open(os.path.join(base, f"annotation/{c}/0000.json"), "w") as f:
            json.dump({"img": f"img/{c}/0000.png", "mask": f"mask/{c}/0000.png", "model": f"model/{c}/m/model.obj",
                       "rot_mat": pose[:, :3].tolist()}, f)
        np.save(os.path.join(base, f"pointclouds/{c}/m/model.npy"), pc)
        with open(os.path.join(base, "lists", f"{c}_test.txt"), "w") as f:
            f.write("0000")
    for dirname, depth_dir, n in (("Ocrtoc", "depth_np", 10), ("OmniObject3D", "depth", 4)):
        base = os.path.join(root, dirname)
        for sub in ("lists", "images_processed/mug", f"{depth_dir}/mug", "camera_data/extr/mug", "pointclouds/mug"):
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        for i in range(n):
            rgb, depth, pose, pc = render(224, 2 + i)
            write_png(os.path.join(base, f"images_processed/mug/mug1_{i:03d}.png"), rgb)
            np.save(os.path.join(base, f"{depth_dir}/mug/mug1_{i:03d}.npy"), depth)
            np.save(os.path.join(base, f"camera_data/extr/mug/mug1_{i:03d}.npy"), pose)
        np.save(os.path.join(base, "pointclouds/mug/mug1.npy"), pc)
        with open(os.path.join(base, "lists", "mug_test.list"), "w") as f:
            f.write("\n".join(f"mug1_{i:03d}.png" for i in range(n)))


def calibrated_checkpoint(root, out, src=None, dst=None, what="phase 19's"):
    """Phase 19's ``best.ckpt`` (or ``src``) with its random field calibrated on
    the tree's first validation view (``recon.calibrate_random_field`` at
    sharpen 1, the CLI's): a trained field's active cells, so the
    coarse-to-fine decode keeps within its capacity. Written to
    ``out/calibrated.ckpt`` (or ``dst``); returns the file's path."""
    from zeroshape_tpu_torch import config, recon
    from zeroshape_tpu_torch.data.synthetic import SyntheticDataset
    from zeroshape_tpu_torch.models.graph_shape import ShapeGraph

    opt = config.shape_gen_opt()
    graph = ShapeGraph.from_opt(opt, dtype=torch.bfloat16)
    graph.load_state_dict(torch.load(src or os.path.join(out, "best.ckpt"), map_location="cpu",
                                     weights_only=True)["graph"])
    model = recon.ReconModel(graph.cuda().eval(), None, 1.0, torch.device("cuda")).repack()
    opt.data.root = root
    view = SyntheticDataset(opt, split="test")[0]
    shift, gain, n = recon.calibrate_random_field(model, {k: view[k][None] for k in ("rgb_input_map", "mask_input_map")})
    path = dst or os.path.join(out, "calibrated.ckpt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"graph": graph.state_dict()}, path)
    print(f"calibrated {what} weights: output layer shifted by {-shift:.4f}, scaled by {gain:g}: {n} active cells")
    del model, graph
    torch.cuda.empty_cache()
    return path


def evaluate_layouts(root, out):
    """Phase 21: the evaluate CLI on the Pix3D, OCRTOC and OmniObject3D trees
    with :func:`calibrated_checkpoint`'s weights, in the validation posture
    (coarse-to-fine decode, pruned brute force)."""
    ckpt = calibrated_checkpoint(root, out)
    counts = []
    for dataset, extra, n in (("pix3d", ["--data.pix3d.cat=chair,table"], 2), ("ocrtoc", ["--data.ocrtoc.erode_mask=10"], 2),
                              ("omniobj3d", [], 4)):
        dump = os.path.join(out, dataset)
        argv = ["--task=shape", f"--data.root={root}", f"--data.dataset_test={dataset}", f"--output_path={dump}",
                f"--ckpt={ckpt}", "--eval.brute_force", "--eval.hier_final", "--eval.bf_prune=[1024,128]",
                "--eval.batch_size=2", "--eval.vox_res=128"] + extra
        _, n_launch = evaluate_cli(argv, f"{dataset} tree, validation posture", n)
        cds, cats = read_results(dump, dataset)
        eval_dumps(dump, dataset, sorted(cds), f"the {dataset} tree", meshes=True)
        want = {"K1": 2 * n, "K2": 6 * n, "K3": 72 * n, "plain": 0}
        if len(cds) != n or n_launch != want:
            fail(f"{dataset}: {len(cds)} result rows, launches {n_launch}, expected {want}")
        counts.append(n_launch)
    return summed(counts)


def two_ranks(root, out, one_rank, cli_run):
    """Phase 22: two ranks on the one card (gloo by the backend rule) in one
    launch of ``dist_check --full``: one fp32 step of the shipped model at
    224^2 (TF32 off, a global batch of 4) and an evaluation, then the train
    CLI with phase 19's arguments (shape_gen, bf16, batch 8; validation at
    eval batch 2) on the same ranks. Held against one rank: the step's well-conditioned pieces
    (``dist_check.parts``) each leaf within 1e-4 of its norm + 1e-7 of the
    piece's gradient, their outputs and statistics within 1e-5; the whole
    step the same, or 4x the card-vs-CPU difference of the one-rank step
    where that is larger (train-mode BatchNorm amplifies rounding); the
    evaluation's CD within 1e-3; the train CLI against phase 19's run, its
    first loss (the same weights on the same batch) within 1e-2 and first
    validation within 1e-3 (bf16), ``latest.ckpt`` with the same tensors,
    each within AdamW's reach of phase 19's (3 lr a step). Then the evaluate
    CLI under two ranks against phase 20's one rank: CD within 1e-3 a sample."""
    from zeroshape_tpu_torch import config, dist_check

    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2", "-m"]
    one, two, cpu, two_train = (os.path.join(out, d) for d in ("dc1", "dc2", "dc_cpu", "two_rank_train"))
    t0 = time.perf_counter()
    # validation at eval batch 2 (one view a rank; phase 19's is 1): the surface draws follow each sample's index
    argv = ["zeroshape_tpu_torch.dist_check", two, "--full", "train"] + cli_argv(root, two_train) + [
        "--eval.batch_size=2", "--eval.n_vis=0"]
    launch = subprocess.run(run + argv, env=env, capture_output=True, text=True, timeout=900)
    if launch.returncode:
        fail(f"two-rank dist_check and train CLI failed:\n{launch.stdout[-3000:]}\n{launch.stderr[-3000:]}")
    launch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dist_check.main([one, "--full"])
    one_s = time.perf_counter() - t0
    dist_check.main([cpu, "--full", "--device=cpu"])
    ref, got, spread = (torch.load(os.path.join(d, "step.pt"), weights_only=True) for d in (one, two, cpu))
    bad, bad_bn, within, worst = dist_check.disagreements(ref, got, spread, tol=1e-4, bn_tol=1e-4)
    pieces = []
    ref_p, got_p = (torch.load(os.path.join(d, "parts.pt"), weights_only=False) for d in (one, two))
    for name in ref_p:
        p_bad, p_bad_bn, _, p_worst = dist_check.disagreements(ref_p[name], got_p[name], tol=1e-4, bn_tol=1e-5)
        o_gap = float(np.linalg.norm(got_p[name]["out"] - ref_p[name]["out"]) / np.linalg.norm(ref_p[name]["out"]))
        pieces.append((name, p_worst, o_gap, p_bad + p_bad_bn))
    e1, e2 = (torch.load(os.path.join(d, "eval.pt"), weights_only=True) for d in (one, two))
    eval_gap = float(((e1["acc"] + e1["comp"]) / 2 - (e2["acc"] + e2["comp"]) / 2).abs().max())
    print(f"two ranks, one card ({[ln for ln in launch.stdout.splitlines() if 'backend' in ln]}): dist_check --full "
          f"and the train CLI in {launch_s:.1f} s (one rank's dist_check {one_s:.1f} s); step loss {ref['loss']:.6f} "
          f"(1 rank) / {got['loss']:.6f} (2 ranks); pieces (largest |d|/|leaf|, output gap): "
          + ", ".join(f"{n} {w:.3e} {o:.3e}" for n, w, o, _ in pieces)
          + f"; whole step: largest |d|/|leaf| {worst:.3e}, {within:.1%} of {len(ref['grads'])} leaves within 1e-4 "
          f"alone, outside the bound {bad[:5]}, statistics {bad_bn[:5]}; evaluation's CD gap {eval_gap:.3e}")
    if (bad or bad_bn or any(b or o > 1e-5 for _, _, o, b in pieces) or "backend gloo" not in launch.stdout
            or eval_gap > 1e-3 or abs(got["loss"] - ref["loss"]) > 1e-4 * abs(ref["loss"])):
        fail("two ranks disagree with one")

    run2 = torch.load(os.path.join(two, "train.pt"), weights_only=False)
    a, b = (torch.load(os.path.join(d, "latest.ckpt"), map_location="cpu", weights_only=True, mmap=True)
            for d in (out, two_train))
    lr = config.shape_gen_opt().optim.lr
    reach = [float((b["graph"][k].float() - v.float()).abs().max()) / lr for k, v in a["graph"].items()
             if v.is_floating_point() and "running" not in k]
    loss_gap = abs(run2["losses"][0] - cli_run["losses"][0]) / cli_run["losses"][0]
    val_gap = abs(run2["val"][0][1] - cli_run["val"][0][1])
    print(f"train CLI on two ranks: losses {[round(x, 6) for x in run2['losses']]} (1 rank: "
          f"{[round(x, 6) for x in cli_run['losses']]}), first loss off by {loss_gap:.3e} of it; validation CD "
          f"{[(e, round(v, 6)) for e, v in run2['val']]} (1 rank: {[(e, round(v, 6)) for e, v in cli_run['val']]}); "
          f"latest.ckpt: {len(reach)} tensors, largest gap to one rank's {max(reach):.3f} lr after {run2['it']} steps")
    if (run2["it"] != cli_run["it"] or len(run2["losses"]) != len(cli_run["losses"]) or loss_gap > 1e-2
            or not np.isfinite(run2["losses"]).all() or val_gap > 1e-3 or a["graph"].keys() != b["graph"].keys()
            or (b["iter"], b["best_ep"]) != (a["iter"], a["best_ep"]) or max(reach) > 3 * run2["it"]):
        fail("the train CLI on two ranks does not follow one rank's run")
    del a, b
    shutil.rmtree(two_train)

    dump = os.path.join(out, "two_rank_eval")
    t0 = time.perf_counter()
    launch = subprocess.run(run + ["zeroshape_tpu_torch.evaluate", "--task=shape", f"--data.root={root}",
                                   f"--output_path={dump}", f"--ckpt={os.path.join(out, 'best.ckpt')}",
                                   "--eval.brute_force", "--eval.batch_size=2"], env=env, capture_output=True,
                            text=True, timeout=900)
    if launch.returncode:
        fail(f"two-rank evaluate CLI failed:\n{launch.stdout[-3000:]}\n{launch.stderr[-3000:]}")
    cds, _ = read_results(dump, "synthetic")
    one_files, two_files = (sorted(os.listdir(os.path.join(d, "dump_synthetic"))) for d in (out, dump))
    eval_dumps(dump, "synthetic", sorted(cds), "the evaluate CLI on two ranks")
    print(f"two ranks' dumps: {len(two_files)} files of {len({f.split('_')[0] for f in two_files})} samples, "
          f"the same names as one rank's: {one_files == two_files}")
    if one_files != two_files:
        fail("two ranks did not dump every sample once, as one rank does")
    gap = max(abs(cds[i] - (one_rank["acc"][i] + one_rank["comp"][i]) / 2) for i in range(len(one_rank["acc"])))
    print(f"evaluate CLI on two ranks (one card): {len(cds)} rows in {time.perf_counter() - t0:.1f} s, files "
          f"{sorted(os.listdir(dump))}; largest CD gap to one rank {gap:.3e} (printed at 4 decimals)")
    if len(cds) != len(one_rank["acc"]) or gap > 1e-3:
        fail(f"two-rank evaluation off one rank's by {gap}")


# ---------------------------------------------------------------------------
# the visual layer (phases 23-27)
# ---------------------------------------------------------------------------

def check_dumps(folder):
    """Parse every dump file under ``folder`` back: PNGs through the port's
    decoder, GIFs by walking their blocks, PLY and OBJ headers. Returns
    ``{relative path: GIF frames}``."""
    from zeroshape_tpu_torch import gif
    from zeroshape_tpu_torch.data import native

    frames = {}
    for d, _, fs in os.walk(folder):
        for f in fs:
            path = os.path.join(d, f)
            if f.endswith(".png"):
                img = native.decode_png(path)
                if img.ndim != 3 or img.dtype != np.uint8 or min(img.shape[:2]) < 8:
                    fail(f"{path}: a PNG of {img.shape} {img.dtype}")
            elif f.endswith(".gif"):
                info = gif.info(path)
                if info["loop"] != 0 or not info["frames"]:
                    fail(f"{path}: {info['frames']} frames, loop {info['loop']}")
                frames[os.path.relpath(path, folder)] = info["frames"]
            elif f.endswith(".ply"):
                with open(path, "rb") as fh:
                    if fh.read(36) != b"ply\nformat binary_little_endian 1.0\n":
                        fail(f"{path}: not a binary PLY")
            elif f.endswith(".obj"):
                with open(path) as fh:
                    if not fh.readline().startswith("mtllib "):
                        fail(f"{path}: not a textured OBJ")
    return frames


EVAL_DUMPS = ("depth_est.png", "image_input.png", "mask_input.png", "pointclouds_comp.ply")


def eval_dumps(out, dataset, idx, what, meshes=False):
    """``dump_{dataset}/`` holds every sample's files of a final evaluation
    (the mesh and its 15-frame turntable where marching cubes found a
    surface; with ``meshes``, for every sample: calibrated weights) and
    ``results_test.html`` lists every 10th sample."""
    import re

    folder = os.path.join(out, f"dump_{dataset}")
    files = sorted(os.listdir(folder))
    frames = check_dumps(folder)
    with_mesh = [i for i in idx if f"{i}_mesh.ply" in files]
    want = sorted([f"{i}_{f}" for i in idx for f in EVAL_DUMPS]
                  + [f"{i}_{f}" for i in with_mesh for f in ("mesh.ply", "mesh_viz.gif")])
    html = open(os.path.join(out, "results_test.html")).read()
    listed = [int(x) for x in re.findall(r"<tr><th>(\d+)</th>", html)]
    print(f"dumps of {what}: {len(files)} files in dump_{dataset}/ for {len(idx)} samples ({len(with_mesh)} with a "
          f"mesh and turntable); results_test.html {len(html)} bytes, samples {listed}")
    if files != want or listed != sorted(int(i) for i in idx)[::10] or any(n != 15 for n in frames.values()):
        fail(f"dumps of {what}: {files} (want {want}), html samples {listed}, turntable frames {set(frames.values())}")
    if meshes and len(with_mesh) != len(idx):
        fail(f"dumps of {what}: meshes and turntables for {with_mesh} of {list(idx)}")


def training_dumps(root, out):
    """Phase 27: the train CLI's ``vis_0/``, ``vis_1/`` (validations), their
    galleries and ``vis_log/iter_0``, ``vis_log/iter_2`` (``freq.save_vis=2``),
    each with both viz samples' files and 272-frame attention GIFs."""
    from zeroshape_tpu_torch import config
    from zeroshape_tpu_torch.data.synthetic import SyntheticDataset
    from zeroshape_tpu_torch.runtime import engine_base

    opt = config.shape_gen_opt()
    opt.data.root = root
    viz = [int(s["idx"][0]) for s in engine_base.viz_samples(SyntheticDataset(opt, split="test"), 2)]
    names = ("attn.gif", "depth_est.png", "image_input.png", "mask_input.png", "pointclouds_comp.ply",
             "seen_surface.ply")
    folders = ["vis_0", "vis_1", "vis_log/iter_0", "vis_log/iter_2"]
    for folder in folders:
        files = sorted(os.listdir(os.path.join(out, folder)))
        want = sorted([f"{i}_{f}" for i in viz for f in names] + [f"{i}_mesh.ply" for i in viz
                                                                  if f"{i}_mesh.ply" in files])
        frames = check_dumps(os.path.join(out, folder))
        if files != want or sorted(frames.values()) != [272, 272]:
            fail(f"training dumps in {folder}: {files} (want {want}), GIF frames {frames}")
    pages = [f for f in sorted(os.listdir(out)) if f.endswith(".html")]
    print(f"training dumps (phase 27): viz samples {viz}; {folders} each with two 272-frame attention GIFs; "
          f"galleries {pages}")
    if pages != ["results_ep0.html", "results_ep1.html"] or sorted(os.listdir(os.path.join(out, "vis_log"))) != [
            "iter_0", "iter_2"]:
        fail(f"training galleries {pages} or vis_log {os.listdir(os.path.join(out, 'vis_log'))}")


def renderer(dev, verts, faces):
    """Phase 23: the turntable of the main path's mesh on the card against the
    CPU with the same uniforms; the card's CUDA-event time; the GIF encoder's."""
    from zeroshape_tpu_torch import gif
    from zeroshape_tpu_torch.ops import render

    v = verts - verts.mean(0)
    tri = render.mesh_triangles(v / (np.abs(v).max() + 1e-8), faces)
    n, views, size = 1 << 18, 15, 320
    g = torch.Generator().manual_seed(0)
    u, r = torch.rand(n, generator=g), torch.rand(n, 2, generator=g)
    card = render.render_turntable(tri, n_views=views, image_size=size, n_points=n, u=u, r=r, device=dev).cpu()
    cpu = render.render_turntable(tri, n_views=views, image_size=size, n_points=n, u=u, r=r, device="cpu")
    equal = float((card == cpu).all(-1).float().mean())
    step = int((card.int() - cpu.int()).abs().max())
    tri_dev, gen = torch.as_tensor(tri, device=dev), torch.Generator(device=dev).manual_seed(0)
    ms = cuda_ms(lambda: render.render_turntable(tri_dev, gen, n_views=views, image_size=size, n_points=n,
                                                 device=dev), warmup=2, iters=5)
    t0 = time.perf_counter()
    data = gif.encode(card.numpy(), 100)
    gif_s = time.perf_counter() - t0
    covered = float((card != 255).any(-1).float().mean())
    print(f"renderer ({len(tri)} faces, {views} views, {size}^2, {n} points): the card equals the CPU on {equal:.6f} "
          f"of pixels (largest |d| {step}), the mesh covers {covered:.3f} of them; {ms:.3f} ms a turntable "
          f"(CUDA events); its GIF encoded in {gif_s:.3f} s, {len(data)} bytes")
    if equal < 0.99 or covered < 0.01 or gif.info(data)["frames"] != views:
        fail(f"renderer: {equal} of pixels equal to the CPU's, coverage {covered}")
    return ms


CONFIDENT, FLIPS = 2.0, 2e-2  # phase 24: past the pass's largest bf16 logit error (1.35); a share of the grid


def attention_pass(dev, model, batch):
    """Phase 24: ``recon.reconstruct_with_attn`` at vox 128 on the main path's
    model and image; its occupancy against K1's on the dense grid; the card
    against the CPU in fp32 at vox 16."""
    from zeroshape_tpu_torch import config, recon
    from zeroshape_tpu_torch.metrics import eval3d
    from zeroshape_tpu_torch.models.graph_shape import ShapeGraph

    gen = torch.Generator(device=dev).manual_seed(0)
    recon.reconstruct_with_attn(model, batch, gen, vox_res=16)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out, level, world, attn = recon.reconstruct_with_attn(model, batch, gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - before) / 2**30
    S = recon.VOX_RES + 1
    with torch.inference_mode():
        caches = model.graph.encode_latents(out)
        k1 = recon.decode_points(model, caches, eval3d.get_dense_3D_grid(recon.VOX_RES, device=dev)[None])[0]
    # the pass's own occupancy against K1's of the same caches, sharpened alike. The pass decodes under bf16
    # autocast (the JAX path's arithmetic): every activation is rounded to bf16 where K1 keeps fp32
    # accumulators, 0.22 logit apart on average and 1.35 at most (PERF.md), so the two may part only near
    # the surface: where K1's logit is over CONFIDENT from 0 both must saturate alike (within 1e-6), and
    # inside/outside may differ on at most FLIPS of the grid. A pass without its sharpen would be at least
    # 1 - sigmoid(2) = 0.12 off there; the same level one x-slice out of place must fail the bound too.
    occ, k1 = level.reshape(-1).double(), k1.double()
    ref = torch.sigmoid(model.sharpen * k1)
    d = (occ - ref).abs()
    sure = k1.abs() > CONFIDENT
    d_sure = float(d[sure].max())
    d_rolled = float((level.roll(1, 1).reshape(-1).double() - ref).abs()[sure].max())
    flips = float(((occ > 0.5) != (k1 > 0)).double().mean())
    print(f"dense decode with attention: its occupancy against sigmoid({model.sharpen:g} x K1) of the same caches, "
          f"P={len(occ)}: max|d| {float(d.max()):.3e}, mean|d| {float(d.mean()):.3e}; where |K1 logit| > "
          f"{CONFIDENT:g} ({float(sure.double().mean()):.4f} of the grid, logit std {float(k1.std()):.3f}): max|d| "
          f"{d_sure:.3e} (the level one x-slice out of place: {d_rolled:.3e}); inside/outside differ on "
          f"{flips:.5f} of the grid")
    if not torch.isfinite(occ).all() or d_sure > 1e-6 or flips >= FLIPS:
        fail(f"the attention pass does not decode K1's field (max |d| 1e-6 where |logit| > {CONFIDENT:g}, "
             f"flips {FLIPS:g})")
    if d_rolled <= 1e-6:
        fail("phase 24's bound does not see the level one x-slice out of place")
    a_min, a_max = float(attn.min()), float(attn.max())
    inside = float((level > 0.5).float().mean())
    print(f"dense decode with attention (vox 128, {S ** 3} points, {tuple(attn.shape)} attention): {seconds:.3f} s, "
          f"peak {peak:.2f} GiB above the model; attention in [{a_min:.3e}, {a_max:.3e}], {inside:.4f} of the grid "
          f"inside; world points {tuple(world.shape)}")
    if not torch.isfinite(attn).all() or a_min < 0 or a_max > 1 or not torch.isfinite(world).all():
        fail("attention maps not finite in [0, 1], or world points not finite")
    # the card against the CPU in fp32 at vox 16, unsharpened
    g32 = ShapeGraph.from_opt(config.full_opt(), dtype=torch.float32)
    g32.load_state_dict(model.graph.state_dict())
    got = {}
    for where in (dev, torch.device("cpu")):
        m = recon.ReconModel(copy.deepcopy(g32).to(where).eval(), None, 1.0, where)
        _, lv, _, at = recon.reconstruct_with_attn(m, batch, torch.Generator(device=where).manual_seed(0),
                                                   vox_res=16, num_points=1000)
        got[where.type] = (lv.cpu(), at.cpu())
    d_level = float((got["cuda"][0] - got["cpu"][0]).abs().max())
    d_attn = float((got["cuda"][1] - got["cpu"][1]).abs().max())
    print(f"dense decode with attention, fp32 at vox 16: the card against the CPU, level max|d| {d_level:.3e}, "
          f"attention max|d| {d_attn:.3e}")
    if d_level > 1e-4 or d_attn > 1e-4:
        fail("the attention pass on the card disagrees with the CPU beyond 1e-4")
    return seconds, peak


DEMO_RUN = (  # with PIL, cv2 and matplotlib blocked, whether the host has them or not
    "import json, sys\n"
    "for m in ('PIL', 'cv2', 'matplotlib'):\n"
    "    sys.modules[m] = None\n"
    "from zeroshape_tpu_torch import demo\n"
    "from zeroshape_tpu_torch.ops.implicit_kernel import fused_decode\n"
    "s = demo.main(sys.argv[1:])\n"
    "print(json.dumps({'per_image_s': s, 'K1': fused_decode.launches}))\n"
)
DEMO_FILES = {  # the files of an image, as the JAX demo writes them (demo.py:201-250)
    "attn": ("image_input.png", "mask_input.png", "attn.gif", "mesh.ply", "mesh_viz.gif"),
    "fast": ("image_input.png", "mask_input.png", "mesh.ply", "mesh_viz.gif"),
    "depth": ("image_input.png", "mask_input.png", "depth_est.png", "seen_surface_fixed.obj",
              "seen_surface_fixed.mtl", "seen_surface_pred.obj", "seen_surface_pred.mtl"),
}


def demo_cli(dev):
    """Phase 25: the demo CLI in a subprocess a run, on a copy of ``examples/``
    at 224^2, vox 128: the shape task with attention (the default) and
    without (K1, 2 launches an image), with seeded random weights calibrated
    on the first image and given as ``--ckpt``, and the depth task. Returns
    the fast path's K1 launches."""
    from zeroshape_tpu_torch import demo, recon

    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp()
    try:
        data = os.path.join(tmp, "examples")
        shutil.copytree(os.path.join(here, "examples"), data, ignore=shutil.ignore_patterns("preds"))
        names = sorted(n[:-4] for n in os.listdir(os.path.join(data, "images")))
        opt = demo.options([f"--datadir={data}", "--eval.vox_res=128"])
        samples, _ = demo.prepare_data(opt)
        model = recon.build(opt, device=dev)
        model.sharpen = 1.0  # the demo's posture with a checkpoint
        shift, gain, n_act = recon.calibrate_random_field(model, samples[0])
        ckpt = os.path.join(tmp, "calibrated.ckpt")
        torch.save({"graph": model.graph.state_dict(), "epoch": 0, "iter": 0, "best_val": 1.0, "best_ep": 0}, ckpt)
        del model
        torch.cuda.empty_cache()
        print(f"demo: seeded random weights calibrated on {names[0]} (shift {-shift:.4f}, gain {gain:g}, {n_act} "
              f"active cells) as {os.path.getsize(ckpt) / 2**20:.0f} MiB of --ckpt")
        fast_k1 = 0
        for run, args in (("attn", [f"--ckpt={ckpt}"]), ("fast", [f"--ckpt={ckpt}", "--eval.dump_attn!"]),
                          ("depth", ["--task=depth"])):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-c", DEMO_RUN, f"--datadir={data}", "--eval.vox_res=128"] + args,
                                  cwd=here, capture_output=True, text=True, timeout=600)
            seconds = time.perf_counter() - t0
            if proc.returncode:
                fail(f"demo ({run}) failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
            got = json.loads(proc.stdout.strip().splitlines()[-1])
            empty = proc.stdout.count("Mesh is empty!")
            preds = os.path.join(data, "preds")
            files = sorted(os.listdir(preds))
            frames = check_dumps(preds)
            meshes = [n for n in names if f"{n}_mesh.ply" in files]
            want = sorted(f"{n}_{f}" for n in names for f in DEMO_FILES[run]
                          if n in meshes or f not in ("mesh.ply", "mesh_viz.gif"))
            s = got["per_image_s"]
            print(f"demo CLI, {run}: {len(files)} files, {len(meshes)} meshes ({empty} empty); GIF frames "
                  f"{sorted(set(frames.values()))}; K1 launches {got['K1']}; seconds an image {[round(x, 4) for x in s]} "
                  f"(steady {np.median(s[1:]):.4f}); the process {seconds:.1f} s")
            if files != want or (run != "depth" and (empty != len(names) - len(meshes) or not meshes)):
                fail(f"demo ({run}) wrote {files}, want {want}")
            gif_frames = {f: n for f, n in frames.items()}
            if any(n != (272 if f.endswith("attn.gif") else 15) for f, n in gif_frames.items()):
                fail(f"demo ({run}) GIF frames {gif_frames}")
            if got["K1"] != (2 * len(names) if run == "fast" else 0):
                fail(f"demo ({run}) launched K1 {got['K1']} times")
            if run == "fast":
                fast_k1 = got["K1"]
        return fast_k1
    finally:
        shutil.rmtree(tmp)


# ---------------------------------------------------------------------------
# phase 28: the non-default encoders
# ---------------------------------------------------------------------------

def encode_card_cpu(dev, graph, what, batch):
    """``encode_image`` of ``graph`` (fp32, eval) on the card and on the CPU
    with TF32 off; each latent stream within 1e-4 of the CPU's norm."""
    from zeroshape_tpu_torch.recon import _inputs

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            cpu = graph.cpu().eval().encode_image(_inputs(batch, "cpu"))
            card = graph.to(dev).encode_image(_inputs(batch, dev))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    rel = {k: float((card[k].cpu() - cpu[k]).norm() / cpu[k].norm()) for k in ("latent_depth", "latent_semantic")}
    print(f"encoders {what}: encode_image card against CPU (fp32, TF32 off): |d| / |CPU| latent_depth "
          f"{rel['latent_depth']:.3e} {tuple(cpu['latent_depth'].shape)}, latent_semantic {rel['latent_semantic']:.3e} "
          f"{tuple(cpu['latent_semantic'].shape)}")
    if not all(np.isfinite(list(rel.values()))) or max(rel.values()) > 1e-4:
        fail(f"encode_image of the {what} on the card disagrees with the CPU: {rel}")


def variant_step_case(seed=4):
    """:func:`tiny_step_case` with both transformer encoders (2 blocks each,
    dsp 2): the fp32 step card and CPU take, with every stochastic-depth mask
    given (the decoder's and each encoder block's two), each keeping some
    samples and dropping others."""
    from zeroshape_tpu_torch import config
    from zeroshape_tpu_torch.models.graph_shape import ShapeGraph

    H, B, n_pts = 64, 4, 64
    opt = config.override_options(config.tiny_opt(H), {"arch": {
        "dtype": "float32", "depth": {"encoder": "transformer", "n_blocks": 2, "dsp": 2},
        "rgb": {"encoder": "transformer", "n_blocks": 2}}})
    opt.loss_weight = {"shape": 1, "depth": 1, "intr": 10}
    opt.optim.lr = opt.optim.lr_ft = 1e-2
    graph = ShapeGraph.from_opt(opt)
    rng = np.random.default_rng(seed)
    numpy_weights(graph, rng)
    batch = step_batch(rng, H, B, n_pts)
    keep = 1 / 0.9

    def mask(i):
        return torch.tensor([keep * ((i + j) % 3 != 0) for j in range(B)], dtype=torch.float32)

    masks = {"impl_network": [mask(0), mask(1)],
             "coord_encoder": [(mask(2), mask(3)), (mask(4), mask(5))],
             "rgb_encoder": [(mask(6), mask(7)), (mask(8), mask(9))]}
    return opt, graph, batch, masks


def kernels_in_a_step(graph, optimizer, batch, opt, dev):
    """Device kernels of one train step, counted by ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    from zeroshape_tpu_torch.parallel import train as ptrain
    from zeroshape_tpu_torch.runtime import shape_engine

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ptrain.train_step(graph, optimizer, batch, opt, shape_engine.step_generator(0, 99, dev))
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.count for e in prof.key_averages() if e.device_type == cuda and not e.is_user_annotation)


def encoders_phase(dev, main_median, samples, data):
    """Phase 28: ``config.encoders_opt()`` at full width through the port's
    entry points. Returns its launches (one reconstruction, the evaluation,
    the training run's validations)."""
    from zeroshape_tpu_torch import config, recon
    from zeroshape_tpu_torch.models.graph_shape import ShapeGraph
    from zeroshape_tpu_torch.parallel import train as ptrain
    from zeroshape_tpu_torch.runtime import shape_engine
    from zeroshape_tpu_torch.weights import init_like_flax

    print("encoders prediction (from the numbers PERF.md records): the variant's reconstruction 0.04-0.075 s "
          "(the main path's 0.036-0.065 s plus ~370 more launches in encode_image, which stays host-bound at "
          "~2,000); a bf16 train step at batch 8 0.15-0.30 s with 6,500-8,000 device kernels (the two 12-block "
          "ViTs add ~550 launches forward where the coordinate ResNet-50 leaves ~300)")
    t0 = time.perf_counter()
    opt = config.encoders_opt()
    model, batch, gen, (shift, gain, n_cal) = recon.synthetic_setup(dev, opt=opt)
    impl = model.graph.impl_network
    print(f"encoders (b): encoders_opt() built, calibrated ({n_cal} active cells) and warmed up in "
          f"{time.perf_counter() - t0:.1f} s; K1 packed {model.packed is not None}, decoder semantic {impl.semantic}, "
          f"latent projection {impl.latent_proj.in_features} -> {impl.latent_proj.out_features}")

    # (a) encode_image, card against CPU, fp32: this model's weights, and the RGB-resnet variant's
    g32 = ShapeGraph.from_opt(opt, dtype=torch.float32)
    g32.load_state_dict(model.graph.state_dict())
    encode_card_cpu(dev, g32, "encoders_opt()", batch)
    del g32
    res_opt = config.override_options(config.full_opt(), {"arch": {"rgb": {"encoder": "resnet", "n_blocks": 12}}})
    encode_card_cpu(dev, init_like_flax(ShapeGraph.from_opt(res_opt), seed=1), "RGB-resnet variant", batch)
    torch.cuda.empty_cache()

    # (b) one reconstruction through K1, then the median of 5
    reset_counts()
    world, _, _, n_active = recon.reconstruct(model, batch, gen)
    torch.cuda.synchronize()
    rec = launch_counts()
    if (rec["K1"], rec["plain"]) != (2, 0):
        fail(f"the encoders' reconstruction launched {rec}, expected K1 2 and no plain decode")
    if int(n_active.max()) == 0 or not torch.isfinite(world).all() or tuple(world.shape) != (recon.NUM_POINTS, 3):
        fail(f"the encoders' reconstruction has no surface (n_active {n_active.tolist()}) or bad points")
    times = recon.time_reconstructions(model, batch, gen, reps=5)
    print(f"encoders (b): reconstruction launches {rec}; n_active {int(n_active.max())}; median "
          f"{np.median(times):.4f} s/reconstruction over 5 reps (min {min(times):.4f}, max {max(times):.4f}) "
          f"beside the main path's {main_median:.4f} s in this call")

    # (c) the posenc variant: K1 is not built for it (as the JAX gate says): plain decodes
    pos_opt = config.override_options(config.encoders_opt(), {"arch": {"impl": {"posenc_3D": 4,
                                                                                   "posenc_perlayer": True}}})
    pos, pos_batch, pos_gen, (_, _, pos_cal) = recon.synthetic_setup(dev, opt=pos_opt)
    reset_counts()
    world, _, _, n_active = recon.reconstruct(pos, pos_batch, pos_gen)
    torch.cuda.synchronize()
    pn = launch_counts()
    pos_times = recon.time_reconstructions(pos, pos_batch, pos_gen, reps=3)
    print(f"encoders (c): posenc_3D 4 + posenc_perlayer: K1 packed {pos.packed is not None}, reconstruction "
          f"launches {pn}, n_active {int(n_active.max())} after calibration ({pos_cal}); median "
          f"{np.median(pos_times):.4f} s/reconstruction over 3 reps")
    if pos.packed is not None or (pn["K1"], pn["plain"]) != (0, 2):
        fail(f"the posenc variant decoded with {pn}, expected K1 0 and plain 2")
    if int(n_active.max()) == 0 or not torch.isfinite(world).all():
        fail("the posenc variant's reconstruction has no surface")
    del pos
    torch.cuda.empty_cache()

    # (d) the validation posture of shape_engine.evaluate on phase 9's samples
    val, _ = evaluate_posture(model, samples, training=True, what="encoders_opt() ")
    del model
    torch.cuda.empty_cache()

    # (e) shape_gen with the variant on phase 11's data: 1 epoch of 3 steps, validated before and after
    train_opt = config.override_options(config.shape_gen_opt(), {
        "arch": {"depth": dict(opt.arch.depth), "rgb": dict(opt.arch.rgb)}, "max_epoch": 1, "tb": None, "eval": {"n_vis": 0},
        "freq": {"print": 1, "scalar": 3, "ckpt_latest": 1000, "eval": 1}})
    out = tempfile.mkdtemp()
    try:
        with instrumented(shape_engine, "validate") as (steps, vals):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = shape_engine.train(train_opt, data, out, device=dev)
            seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(out)
    peak = torch.cuda.max_memory_allocated() / 2**30
    s_step = [s for s, _ in steps]
    in_steps, in_val = summed([n for _, n in steps]), summed(vals)
    step_batch_ = shape_engine.to_device(data.batch(np.arange(8), 0, 0, train_opt.training.n_sdf_points), dev)
    n_kernels = kernels_in_a_step(res["graph"], res["optimizer"], step_batch_, train_opt, dev)
    print(f"encoders (e): shape_gen with encoders_opt()'s encoders, batch 8, bf16: {len(steps)} steps, median "
          f"{np.median(s_step[1:]):.4f} s/step over steps 2-{len(s_step)} (per step {[round(x, 4) for x in s_step]}); "
          f"peak memory {peak:.2f} GiB; the run {seconds:.1f} s with {len(vals)} validations; losses "
          f"{[round(x, 5) for x in res['losses']]}; validation CD {res['val']}; launches in the steps {in_steps}, "
          f"in validation {in_val}; device kernels in a step (torch.profiler) {n_kernels} (the shipped graph: "
          f"6,955 by profile_train, PERF.md)")
    if len(steps) != 3 or not np.isfinite(res["losses"]).all() or not all(np.isfinite(cd) for _, cd in res["val"]):
        fail(f"the encoders' training took {len(steps)} steps, losses {res['losses']}, validation {res['val']}")
    if any(in_steps.values()) or in_val["K1"] == 0 or in_val["K2"] == 0 or in_val["plain"]:
        fail(f"the encoders' training launched {in_steps} in its steps (want none), {in_val} in validation")
    del res, step_batch_
    torch.cuda.empty_cache()

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    step_opt, graph, sbatch, masks = variant_step_case()
    cpu = step_on("cpu", step_opt, graph, sbatch, masks)
    cpu_1 = step_on("cpu", step_opt, graph, sbatch, masks, threads=1)
    card = step_on(dev, step_opt, graph, sbatch, masks)
    # 492 parameters, of which 6 never take a gradient (the DPT ViT's last
    # norm, refinenet4's first unit)
    bad, summary = step_disagreements(step_opt, graph, cpu, card, cpu_1, min_live=486)
    mods = ", ".join(f"{m} {r:.2e} (CPU runs {x:.2e})" for m, (r, x, _) in summary.get("modules", {}).items())
    print(f"encoders (e): fp32 step at tiny width with both transformer encoders, card against CPU, the same "
          f"stochastic-depth masks: loss {card[2]['loss_all']:.6f} vs {cpu[2]['loss_all']:.6f}; gradient |d| / norm "
          f"by module: {mods}; update max|d| {summary.get('update', float('nan')):.3e}")
    if bad:
        fail(f"the encoders' training step on the card disagrees with the CPU: {bad[:6]} ({len(bad)} in all)")
    return summed([rec, val, in_val])


def run_module(args, timeout=600, env=None):
    """``python -m zeroshape_tpu_torch.<args>`` from the checkout's root; its
    stdout lines and seconds. Fails unless it exits 0."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", f"zeroshape_tpu_torch.{args[0]}", *args[1:]], capture_output=True,
                         text=True, timeout=timeout, cwd=os.path.dirname(os.path.abspath(__file__)),
                         env=dict(os.environ, **(env or {})))
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"{' '.join(args)} exited {res.returncode}:\n{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    return res.stdout.strip().splitlines(), res.stderr, seconds


def bench_family(main_median):
    """Phase 29: ``bench`` (the headline), ``bench throughput 1 8``, ``bench ab
    5`` and ``mfu all``, each in a subprocess and parsed back. Returns the
    launches these runs counted from 0 (the headline's counted
    reconstruction, the throughput calls, the A/B's K1 warm-up)."""
    import re

    from zeroshape_tpu_torch.mfu import H100_BF16_FLOPS, decoder_flops

    print("bench prediction (PERF.md §6): value 0.034-0.065 s/image (vs_baseline 15-30); recon ~2.7 TFLOP "
          "of decode at 4-8% of the bf16 peak; the batch-28 step ~0.18 s at a low single-digit share")
    lines, err, seconds = run_module(["bench"])
    line = json.loads(lines[-1])
    card_line = next((x for x in lines if x.startswith("bench: card ")), "")
    found = re.search(r"K1 launches a reconstruction (\d+); n_active (\d+)", card_line)
    if set(line) != {"metric", "value", "unit", "vs_baseline"} or line["metric"] != "shape_recon_latency_vox128" \
            or line["unit"] != "s/image" or not (np.isfinite(line["value"]) and line["value"] > 0):
        fail(f"bench's last line {line}")
    if found is None or int(found[1]) != 2 or int(found[2]) > 4096:
        fail(f"bench's card line {card_line!r}: want K1 2 launches a reconstruction, n_active <= 4096")
    spread = next((x for x in err.splitlines() if x.startswith("bench: median")), "")
    print(f"bench (subprocess, {seconds:.1f} s): {lines[-1]}; {card_line}; {spread}; "
          f"phase 4's median in this call {main_median:.4f} s")
    launches = {"K1": 2, "K2": 0, "K3": 0}

    lines, _, seconds = run_module(["bench", "throughput", "1", "8"])
    sizes = json.loads(lines[-1])["sizes"]
    for B in (1, 8):
        r = sizes[str(B)]
        if r["k1_per_call"] != 2 * B or not r["img_per_s"] > 0:
            fail(f"bench throughput B={B}: {r}")
        launches["K1"] += int(r["k1_per_call"])
    print(f"bench throughput (subprocess, {seconds:.1f} s): " + "; ".join(
        f"B={B} {sizes[str(B)]['img_per_s']:.2f} img/s ({sizes[str(B)]['s_per_batch']:.4f} s a call, K1 "
        f"{sizes[str(B)]['k1_per_call']:g})" for B in (1, 8)))

    lines, _, seconds = run_module(["bench", "ab", "5"])
    ab = json.loads(lines[-1])
    pairs = np.asarray(ab["pair_ratios"])
    if len(pairs) != 5 or not np.isfinite(pairs).all():
        fail(f"bench ab: {ab}")
    launches["K1"] += 2
    print(f"bench ab (subprocess, {seconds:.1f} s): median fused {ab['median']['fused']:.4f} s, plain "
          f"{ab['median']['plain']:.4f} s, fused/plain {ab['ratio']:.3f}; pairs {np.round(pairs, 3).tolist()} "
          f"(spread {pairs.min():.3f}-{pairs.max():.3f})")

    lines, _, seconds = run_module(["mfu", "all"], env={"MFU_REPS": "5"})
    rows = {r["name"]: r for r in json.loads(lines[-1])}
    if set(rows) != {"train_step_b28", "depth_step_b44", "recon_vox128_hier_fused"}:
        fail(f"mfu rows {sorted(rows)}")
    for r in rows.values():
        if not (r["flops"] > 0 and r["seconds"] > 0 and 0 < r["mfu_pct_h100_bf16"] < 100) or \
                abs(r["tflops_per_s"] - r["flops"] / r["seconds"] / 1e12) > 1e-6 * r["tflops_per_s"] or \
                abs(r["mfu_pct_h100_bf16"] - 100 * r["flops"] / r["seconds"] / H100_BF16_FLOPS) > 1e-6:
            fail(f"mfu row {r}")
        print(f"mfu {r['name']}: {r['flops'] / 1e9:.1f} GFLOP ({r['flops_source']}), {r['seconds']:.4f} s, "
              f"{r['tflops_per_s']:.2f} TFLOP/s, {r['mfu_pct_h100_bf16']:.2f}% of the bf16 peak, "
              f"{r['img_per_s']:.1f} img/s" + (f", peak {r['peak_gib']:.2f} GiB" if "peak_gib" in r else ""))
    rec = rows["recon_vox128_hier_fused"]
    want = decoder_flops(rec["decoded_points"], 197)
    if abs(rec["decoder_flops_counted"] - want) > 0.01 * want:
        fail(f"the recon row's decoder count {rec['decoder_flops_counted']} is not within 1% of decoder_flops {want}")
    print(f"mfu (subprocess, {seconds:.1f} s): the recon row's decoder {rec['decoder_flops_counted'] / 1e12:.4f} "
          f"TFLOP counted at {rec['decoded_points']} points against decoder_flops {want / 1e12:.4f} "
          f"({rec['decoder_flops_counted'] / want - 1:+.2e}); the rest of the count (encoding) "
          f"{(rec['flops'] - rec['decoder_flops_counted']) / 1e9:.1f} GFLOP")
    return launches


def dry_run():
    """Phase 30: ``graft_entry.dryrun_multichip(2, full=True)``, both ranks on
    the one card (gloo by the backend rule); returns its evaluation's launches."""
    from zeroshape_tpu_torch import graft_entry

    t0 = time.perf_counter()
    res = graft_entry.dryrun_multichip(2, full=True, timeout=600)
    seconds = time.perf_counter() - t0
    cds = np.asarray(res["cd"])
    print(f"dry run: 2 ranks ({res['backend']}), loss_all {res['loss']:.6f}, per-sample CD {cds.tolist()}, "
          f"launches in the ranks' evaluation {res['launches']}; step {res['step_seconds']:.2f} s, evaluation "
          f"{res['eval_seconds']:.2f} s, the call {seconds:.1f} s")
    if not np.isfinite(res["loss"]) or cds.shape != (2,) or not np.isfinite(cds).all():
        fail(f"the dry run gave loss {res['loss']}, CDs {cds}")
    if res["launches"]["K1"] != 2 or res["launches"]["plain"] != 0:
        fail(f"the dry run's evaluation launched {res['launches']}: want K1 once a rank (the dense grid)")
    return {k: res["launches"][k] for k in ("K1", "K2", "K3")}


def chain_phase(log_dir=None):
    """Phase 31: the two-stage chain at full width, cut in data and epochs.
    ``generalize_e2e gen --n_objects=2 --holdout_objects=1`` at 224^2 (14
    training views, 10 test views) into a temporary directory; ``round5 run``
    on it with ``--max_epoch=1 --freq.eval=1`` (one step an epoch at batch 8,
    validated before and after), two stages at a time, into a temporary
    ``output_root`` (removed at the end); then ``check_fused_engine`` on the
    calibrated field and ``time_bf``. Each is a subprocess whose launches come
    back through ``ZS_LAUNCH_LOG``. Every stage must exit 0, both arms'
    checkpoints hold every key of the shape graph, the result files parse and
    each gate seed is below the gate's bound; ``measure_hier`` on both arms'
    weights with their one-step fields calibrated (:func:`calibrated_checkpoint`)
    must count at most 4096 active cells.
    Returns the launches summed over the subprocesses."""
    import re

    from zeroshape_tpu_torch import LAUNCH_LOG, config
    from zeroshape_tpu_torch.models.graph_shape import ShapeGraph
    from zeroshape_tpu_torch.runtime import checkpoint

    t0 = time.perf_counter()
    root, out = tempfile.mkdtemp(), tempfile.mkdtemp()
    launch_log = os.path.join(root, "launches.jsonl")
    env = {LAUNCH_LOG: launch_log}
    try:
        free = shutil.disk_usage(out).free / 2**30
        data = os.path.join(root, "gen")
        _, _, seconds = run_module(["generalize_e2e", "gen", data, "--n_objects=2", "--holdout_objects=1"], env=env)
        print(f"chain: the tree (2 + 1 held-out objects x 8 views, 224^2) in {seconds:.1f} s; {free:.0f} GiB free "
              f"where the runs go")
        logs = log_dir or os.path.join(out, "round5")
        cmd = [sys.executable, "-m", "zeroshape_tpu_torch.round5", "run", f"--data.root={data}", f"--output_root={out}",
               f"--log_dir={logs}", "--max_epoch=1", "--freq.eval=1", "--jobs=2", "--gate_seeds=2"]
        t1 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=os.path.dirname(
            os.path.abspath(__file__)), env=dict(os.environ, **env))
        chain_s = time.perf_counter() - t1
        lines = proc.stdout.strip().splitlines()
        print("\n".join(x for x in lines if x.startswith("[chain]") and " exit " in x))
        if proc.returncode != 0:
            for name in os.listdir(logs) if os.path.isdir(logs) else ():
                print(f"--- {name} (tail)\n" + open(os.path.join(logs, name)).read()[-3000:])
            fail(f"round5 run exited {proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        res = json.loads(lines[-1])
        bad = {n: s for n, s in res["stages"].items() if s["status"] != "ok" or s["rc"] != 0}
        if len(res["stages"]) != 10 or bad:
            fail(f"chain stages not all run and 0: {res['stages']}")
        with torch.device("meta"):
            want = checkpoint._expected(ShapeGraph.from_opt(config.shape_gen_opt()))
        for arm in ("shape_gen_staged", "shape_gen"):
            sd, meta, _ = checkpoint.load_reference_ckpt(os.path.join(out, "shape", arm, "best.ckpt"))
            missing = [k for k in want if k not in sd]
            if missing:
                fail(f"{arm}/best.ckpt lacks {len(missing)} keys of the shape graph: {missing[:5]}")
            print(f"chain: {arm}/best.ckpt holds all {len(want)} keys of the shape graph (epoch {meta['epoch']}, "
                  f"best {meta['best_val']:.4f} @ {meta['best_ep']})")
        cds = {k: res[k]["cd"] for k in ("eval_staged", "eval_scratch", "bf", "floor")}
        if not np.isfinite(list(cds.values())).all() or res["eval_staged"]["seen"] is None or \
                res["eval_staged"]["unseen"] is None or not res["bf"]["f_score"]:
            fail(f"chain result files: {cds}, {res['eval_staged']}")
        hier = res["hier"]
        if sorted(hier) != ["shape_gen", "shape_gen_staged"] or max(h["max"] for h in hier.values()) > 32768:
            fail(f"measure_hier: {hier}")
        # one step leaves a random field, which at sharpen 1 marks every coarse cell active; measure_hier is
        # held to the capacity on the arms' weights with their fields calibrated as phase 21 does
        cal = [calibrated_checkpoint(data, None, os.path.join(out, "shape", arm, "best.ckpt"),
                                     os.path.join(out, "calibrated", arm, "best.ckpt"), f"the chain's {arm}")
               for arm in ("shape_gen_staged", "shape_gen")]
        lines, _, seconds = run_module(["measure_hier", "--task=shape", f"--data.root={data}", f"--output_root={out}",
                                        "--name=shape_gen_staged", f"--ckpt={cal[0]}", f"--extra_ckpts={cal[1]}"],
                                       env=env)
        from zeroshape_tpu_torch.round5 import hier_result

        cal_hier = hier_result("\n".join(lines))
        if sorted(cal_hier) != ["shape_gen", "shape_gen_staged"] or max(h["max"] for h in cal_hier.values()) > 4096:
            fail(f"measure_hier on the calibrated arms: {cal_hier}")
        print(f"measure_hier ({seconds:.1f} s): the chain's one-step fields {hier}; calibrated {cal_hier}")
        seeds = res["gate"]["seeds"]
        if len(seeds) != 2 or not all(c < GATE_CD_BOUND for c in seeds):
            fail(f"calibrate_gate 2: seeds {seeds} (bound {GATE_CD_BOUND})")
        for k in ("depth", "staged", "scratch"):
            if [e for e, _ in res[k]["curve"]] != [0, 1] or not np.isfinite([v for _, v in res[k]["curve"]]).all():
                fail(f"chain {k} validations {res[k]}")
        print(f"chain (round5 run, {chain_s:.1f} s, 2 jobs): depth l1_err {res['depth']['l1_err_epoch0']:.4f} -> "
              f"{res['depth']['l1_err_best']:.4f}; val CD staged {res['staged']['cd_epoch0']:.4f} -> "
              f"{res['staged']['cd_best']:.4f}, scratch {res['scratch']['cd_epoch0']:.4f} -> "
              f"{res['scratch']['cd_best']:.4f}; evaluate CD staged {cds['eval_staged']:.4f} (seen "
              f"{res['eval_staged']['seen']:.4f}, unseen {res['eval_staged']['unseen']:.4f}), scratch "
              f"{cds['eval_scratch']:.4f}; brute force {cds['bf']:.4f} (F@5% {res['bf']['f_score'].get('5.00')}); "
              f"floor {cds['floor']:.4f}; gate seeds {seeds}")
        print("chain stage seconds: " + ", ".join(f"{n} {s['seconds']}" for n, s in res["stages"].items()))

        lines, _, seconds = run_module(["check_fused_engine"], env=env)
        found = [x for x in lines if x.startswith(("coarse logit", "n_active", "binarized"))]
        if lines[-1] != "FUSED ENGINE PATH OK" or len(found) != 3:
            fail(f"check_fused_engine: {lines[-6:]}")
        print(f"check_fused_engine (calibrated field, {seconds:.1f} s): " + "; ".join(found))
        lines, _, seconds = run_module(["time_bf"], env=env)
        rows = [x for x in lines if x.startswith("rot_batch=")]
        if len(rows) != 6 or not lines[-1].startswith("rot_batch changes nothing: True; no prune beats the "
                                                      "exhaustive search"):
            fail(f"time_bf: {lines}")
        print(f"time_bf ({seconds:.1f} s): " + "; ".join(rows + lines[-1:]))
        counts = [json.loads(x) for x in open(launch_log)]
        launches = {k: sum(c[k] for c in counts) for k in ("K1", "K2", "K3", "plain")}
        by_module = {}
        for c in counts:
            mod = re.sub(r".*zeroshape_tpu_torch[./]", "", c["argv"][0]).removesuffix(".py")
            by_module[mod] = {k: by_module.get(mod, {}).get(k, 0) + c[k] for k in ("K1", "K2", "K3", "plain")}
        print(f"chain phase launches over {len(counts)} processes: {launches}; by module {by_module}")
        if min(launches[k] for k in ("K1", "K2", "K3")) == 0:
            fail(f"phase 31 left a kernel unlaunched: {launches}")
    finally:
        shutil.rmtree(root)
        shutil.rmtree(out)
    print(f"phase 31 took {time.perf_counter() - t0:.1f} s")
    return {k: launches[k] for k in ("K1", "K2", "K3")}


# phase 32: the keys each tool's last line must hold (beside "card"), and
# the device time the trace's spans must hold
TIMER_KEYS = {
    "batch": ("rows",), "windows": ("rows",), "parts": ("fwd_loss_ms", "fwd_bwd_ms", "step_ms", "sync_every_step_ms",
                                                         "sync_once_ms", "step_interpolate_ms", "step_separable_ms"),
    "loader": ("img_s", "decode_numpy_png_img_s", "gap_median_ms", "gap_p95_ms", "step_ms"),
    "midas": ("rows",), "depth": ("dead", "identical", "s_per_step", "runs"),
    "components": ("encode_image_ms", "encode_latents_ms", "dense_decode_ms", "dense_sample_ms", "k1_launches"),
    "hier_parts": ("select_ms", "gather_ms", "upsample_nearest_ms", "scatter_ms", "sigmoid_ms"),
    "decode": ("dense_k1_ms", "hier_k1_ms", "hier_sign_agree", "dense_plain_ms", "hier_plain_ms", "tiles"),
    "sampling": ("launch_floor_ms", "triangle_areas_slab8_ms", "cumsum_ms", "draw_slots_ms", "sample_from_tris_ms",
                 "sample_surface_points_ms", "sample_surface_points_cells_ms"),
    "k1_builds": ("builds",), "analyze_trace": ("device_busy_ms", "span_sum_ms", "span_share", "spans", "top"),
}
SPAN_SHARE = 0.95


def timers_phase():
    """Phase 32: every subcommand of ``time_train``, ``time_recon`` and
    ``analyze_trace`` as a subprocess at cut sizes, in two lanes side by
    side: the training timers at batch 8 with 2-3 repetitions, the loader
    and the depth probe (2 runs of 150 steps) on a 2 + 1 object tree, the
    reconstruction timers on the main path's model, ``k1_builds`` on the
    shipped source against itself, and ``analyze_trace`` on a trace of 2
    ``profile_train`` steps that the phase captures. Each tool's last line
    must parse, hold its keys and only finite numbers; the midas medians
    must agree bit for bit, each K1 build must pass its check, and the
    trace's spans must hold at least 95% of its device busy time, each of
    the step's four a part. Returns the launches (``ZS_LAUNCH_LOG``)."""
    from zeroshape_tpu_torch import LAUNCH_LOG
    from zeroshape_tpu_torch.ops import _build
    from zeroshape_tpu_torch.ops import implicit_kernel as ik
    from zeroshape_tpu_torch.timing import finite_numbers

    t0 = time.perf_counter()
    root = tempfile.mkdtemp()
    launch_log = os.path.join(root, "launches.jsonl")
    env = {LAUNCH_LOG: launch_log}
    records = {}

    def run(name, args, timeout=600):
        lines, _, seconds = run_module(args, timeout, env)
        try:
            rec = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            fail(f"{' '.join(args)}: no JSON last line: {lines[-5:]}")
        missing = [k for k in TIMER_KEYS[name] if k not in rec]
        numbers = finite_numbers({k: v for k, v in rec.items() if k != "card"})
        if missing or not numbers or not np.isfinite(numbers).all() or not rec.get("card"):
            fail(f"{' '.join(args)}: missing {missing} or a number not finite in {lines[-1][:2000]}")
        records[name] = rec
        print(f"{name} ({seconds:.1f} s): {lines[-1][:600]}")
        return rec

    def training_lane():
        batch = run("batch", ["time_train", "batch", "8", "--task=shape", "--reps=2", "--warmup=2"])
        run("loader", ["time_train", "loader", f"--data.root={data}", "--batch_size=4", "--epochs=2",
                       f"--step_ms={batch['rows'][0]['ms_synced']}"])
        run("windows", ["time_train", "windows", "--windows=2", "--K=3", "--batch_size=8"])
        run("parts", ["time_train", "parts", "--batch_size=8", "--reps=2", "--K=2"])
        trace = os.path.join(root, "train.pt.trace.json")
        _, _, seconds = run_module(["profile_train", "--steps=2", f"--trace={trace}"], env=env)
        print(f"profile_train: 2 traced shape_gen steps at batch 8 in {seconds:.1f} s")
        summary = run("analyze_trace", ["analyze_trace", trace, "10"])
        # the step's spans, each with the kernels launched anywhere inside it
        # (AdamW's own span sits inside optimizer_step)
        spans = {k: summary["spans_outer"].get(k, 0.0) for k in ("train_forward", "train_loss", "train_backward",
                                                                 "optimizer_step")}
        if summary["span_share"] < SPAN_SHARE or min(spans.values()) <= 0:
            fail(f"analyze_trace: the spans hold {summary['span_sum_ms']:.3f} of {summary['device_busy_ms']:.3f} ms "
                 f"of device time (below {SPAN_SHARE:.0%}) or a step span has none: {spans}")

    def probe_and_recon_lane():
        midas = run("midas", ["time_train", "midas", "8", "--reps=2"])
        if not all(r["equal"] for r in midas["rows"]):
            fail(f"midas: the bisection median and the sort median disagree: {midas['rows']}")
        run("depth", ["time_train", "depth", f"--data.root={data}", "--repeats=2", "--steps=150"])
        run("components", ["time_recon", "components", "--reps=2"])
        run("hier_parts", ["time_recon", "hier_parts", "--reps=3"])
        run("decode", ["time_recon", "decode", "--reps=2"])
        run("sampling", ["time_recon", "sampling", "--reps=2"])
        shipped = os.path.join(_build.CSRC, ik._SOURCE)
        builds = run("k1_builds", ["time_recon", "k1_builds", shipped, shipped, "--reps=3", "--rounds=1"])
        if len(builds["builds"]) != 2 or not all(b["ok"] for b in builds["builds"]):
            fail(f"k1_builds: {builds['builds']}")

    try:
        data = os.path.join(root, "gen")
        run_module(["generalize_e2e", "gen", data, "--n_objects=2", "--holdout_objects=1"], env=env)
        # two lanes of subprocesses side by side to fit the script's time: the
        # numbers are a smoke check here, each tool's own run measures alone
        with ThreadPoolExecutor(2) as pool:
            for lane in [pool.submit(training_lane), pool.submit(probe_and_recon_lane)]:
                lane.result()  # a lane's fail() exits through here
        counts = [json.loads(x) for x in open(launch_log)]
        launches = {k: sum(c[k] for c in counts) for k in ("K1", "K2", "K3", "plain")}
        print(f"timers phase launches over {len(counts)} processes: {launches}")
        if launches["K1"] == 0:
            fail(f"phase 32 never launched K1: {launches}")
    finally:
        shutil.rmtree(root)
    print(f"phase 32 took {time.perf_counter() - t0:.1f} s")
    return {k: launches[k] for k in ("K1", "K2", "K3")}


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    t_start = time.perf_counter()
    from zeroshape_tpu_torch import resolve_device
    from zeroshape_tpu_torch.data import analytic
    from zeroshape_tpu_torch.ops.marching_cubes import marching_cubes_mesh, write_ply_mesh

    from zeroshape_tpu_torch.bench import card

    dev = resolve_device(None)
    smi = card()
    print(f"card: {smi}")
    import importlib.util

    found = {m: importlib.util.find_spec(m) is not None for m in ("PIL", "cv2", "matplotlib", "yaml", "tensorboard")}
    print(f"host modules (the port needs none of them): {found}")

    build_kernels()
    k1 = check_k1(dev)
    model, main_launches, level, batch, main_median = main_path(dev)

    verts, faces = marching_cubes_mesh(level)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mesh.ply")
        write_ply_mesh(path, verts / level.shape[0] * 3.0 - 1.5, faces)
        size = os.path.getsize(path)
    if len(faces) == 0 or not np.isfinite(verts).all():
        fail("mesh empty or its vertices not finite")
    print(f"mesh: {len(verts)} vertices, {len(faces)} faces, {size} bytes of PLY")
    sampler_determinism(level, dev)
    renderer(dev, verts / level.shape[0] * 3.0 - 1.5, faces)

    with torch.inference_mode():
        exact = unit_clouds(48, 10000, 10000, seed=5)  # one exact brute-force batch
        rot, gt = surface_clouds(dev)
        k2_err = max(check_k2(*exact, "B=48, N=M=10,000"), check_k2(*unit_clouds(3, 1000, 777, seed=6), "B=3, N=1,000, M=777"),
                     check_k2(rot, gt, "48 rotations of a torus cloud -> shared GT, N=M=10,000"),
                     check_k2(gt, rot, "shared GT -> 48 rotations of a torus cloud, N=M=10,000"))
        del rot, gt
        coarse = unit_clouds(192, 1024, 1024, seed=7)  # one coarse batch
        k3_err = max(check_k3(*coarse, "B=192, N=M=1,024"), check_k3(*unit_clouds(3, 1000, 777, seed=8), "B=3, N=1,000, M=777"))
    planted_rotation(dev)
    attention_pass(dev, model, batch)

    t0 = time.perf_counter()
    samples = analytic.eval_samples(n_objects=N_EVAL, n_views=2, H=224, seed=0)
    print(f"evaluation: {len(samples)} analytic test samples (224^2, 10,000 GT points) made in "
          f"{time.perf_counter() - t0:.1f} s")
    final, final_s = evaluate_posture(model, samples, training=False)
    val, _ = evaluate_posture(model, samples, training=True)

    with torch.inference_mode():
        k2_times = time_chamfer(*exact, fast=False)
        k3_times = time_chamfer(*coarse, fast=True)
    k2_sample = 288 * k2_times[0] / 1e3
    print(f"final posture: K2 takes 288 x {k2_times[0]:.4f} ms = {k2_sample:.4f} s a sample of the posture's "
          f"{final_s:.4f} s ({k2_sample / final_s:.1%}); the rest, {final_s - k2_sample:.4f} s, is K1's dense "
          f"decode, the encoder, the sampler and the search's host loop")

    res, data, opt, train_val = train_run(dev)
    train_steps(dev, res, data, opt)
    cuda_against_cpu(dev)
    checkpoint_round_trip(res, opt)
    del res
    torch.cuda.empty_cache()

    gate_val = accuracy_gate(dev)
    out = tempfile.mkdtemp()  # the depth run's and the staged run's checkpoints
    try:
        depth_res, depth_opt = depth_run(dev, data, os.path.join(out, "depth"))
        depth_overfit(dev, depth_res, data, depth_opt)
        del depth_res
        torch.cuda.empty_cache()
        depth_against_cpu(dev)
        staged_val = staged_run(dev, data, os.path.join(out, "depth", "best.ckpt"), os.path.join(out, "shape"))
        load_run(dev, data, os.path.join(out, "shape", "latest.ckpt"))
    finally:
        shutil.rmtree(out)

    root, out = tempfile.mkdtemp(), tempfile.mkdtemp()  # the trees; the CLI run's checkpoints (~2.3 GB each)
    try:
        write_tree(root, data)
        cli_val, cli_run = train_cli(root, out)
        cli_run = {k: cli_run[k] for k in ("losses", "val", "it")}  # the trained graph and optimizer go
        torch.cuda.empty_cache()
        tree_res, tree_eval = evaluate_tree(root, out)
        write_layout_trees(root)
        layout_eval = evaluate_layouts(root, out)
        two_ranks(root, out, tree_res, cli_run)
    finally:
        shutil.rmtree(root)
        shutil.rmtree(out)
    demo_k1 = demo_cli(dev)
    del model
    torch.cuda.empty_cache()
    enc_launches = encoders_phase(dev, main_median, samples, data)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bench_launches = bench_family(main_median)
    print(f"phase 29 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    dry_launches = dry_run()
    torch.cuda.empty_cache()
    chain_launches = chain_phase()
    timer_launches = timers_phase()

    # launches: the sum over the path runs (main path, final and validation
    # posture, the validations of the training run, the gate and the staged
    # run, the train CLI's validations and train-split metrics, the evaluate
    # CLI on the tree and on the three layouts, the demo's fast path, the
    # encoders' reconstruction, evaluation and training validations, the
    # bench family's counted runs, the dry run's evaluation, the chain's
    # subprocesses, the timers' subprocesses), each counted from 0
    launches = {k: (main_launches + demo_k1) * (k == "K1") + sum(
        n[k] for n in (final, val, train_val, gate_val, staged_val, cli_val, tree_eval, layout_eval, enc_launches,
                       bench_launches, dry_launches, chain_launches, timer_launches))
        for k in ("K1", "K2", "K3")}
    k1["launches"] = launches["K1"]
    kernels = [k1]
    for name, key, times, err, line in (
        ("chamfer_nn", "K2", k2_times, k2_err, 63), ("chamfer_nn_min_bf16", "K3", k3_times, k3_err, 138),
    ):
        ms, plain_ms, library_ms, bound_ms, bound_by, card_ms = times
        kernels.append({
            "name": name, "route": "cuda", "source": "zeroshape_tpu_torch/csrc/chamfer.cu",
            "replaces": f"zeroshape_tpu/ops/chamfer.py:{line}", "launches": launches[key], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "card_bound_ms": card_ms,
            "library_ms": library_ms,
        })
    if min(launches.values()) == 0:
        fail(f"a kernel of the paths was never launched: {launches}")

    print(f"chip_smoke: phases 1-32 took {time.perf_counter() - t_start:.1f} s")
    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
             "bound_ms", "bound_by", "card_bound_ms", "library_ms"]
    print(json.dumps({"kernels": [{k: kern[k] for k in order} for kern in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
