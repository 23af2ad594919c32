"""Drive the PyTorch/CUDA port on one GPU: build its kernels, hold each
against its plain version, run the full-size main path and export a mesh,
then run the scoring and evaluation path at full size.

    python3 chip_smoke.py

Phases (one line or more each, any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build the kernels from csrc/ with nvcc, one process per source, all
     started together: the fused implicit decoder (K1) and the Chamfer
     kernels (K2, K3); ptxas's register and spill lines;
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
     a ragged one (B=3, N=1,000, M=777), on unit-scale clouds: refined
     distances within 1e-5; argmins equal on >= 99.9% of points and, where
     they differ, equally near within 1e-5; rolling the rows of x1 rolls the
     results exactly;
  7. K3 (bf16 cross term, min only) against its plain version at the coarse
     stage's shape (B=192, N=M=1,024), within 1e-5;
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
 10. CUDA-event times of K2 and K3 at the shapes of 6 and 7, of their plain
     versions and of the library yardstick (``torch.cdist`` then ``.min``),
     and the bounds.
Then one JSON line of kernel numbers, the nvidia-smi line again, and the
result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

H100_BF16_FLOPS = 989e12  # dense tensor-core peak (NVIDIA data sheet, SXM)
H100_FP32_FLOPS = 67e12  # fp32 outside the tensor cores (SIMT)
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


def decoder_flops(P, L, C=256, n_blocks=2, hidden=1024, n_linears=9, skip_in=(2, 4, 6)):
    """Operations the decoder needs for P points against L latent keys."""
    per = 2 * 3 * C  # point_proj
    per += n_blocks * (2 * C * 3 * C + 2 * (2 * C * L) + 2 * C * C + 2 * (2 * C * hidden))
    for l in range(n_linears):
        fan_in = 3 + C if l == 0 else C + (3 + C if l in skip_in else 0)
        per += 2 * fan_in * (1 if l == n_linears - 1 else C)
    return P * per


def agree(got, ref, what):
    """Hold K1's logits to the plain version's within the bf16 bounds of
    tests/test_implicit_kernel.py; returns the max |d|."""
    a, b = got.double().cpu().numpy(), ref.double().cpu().numpy()
    d = np.abs(a - b)
    corr = float(np.corrcoef(a, b)[0, 1])
    print(f"K1 vs plain fp32 on the {what}, P={len(a)}: max|d| {d.max():.3e} mean|d| {d.mean():.3e} "
          f"corr {corr:.6f} (logit std {b.std():.3f})")
    if not np.isfinite(a).all():
        fail(f"K1 gave non-finite logits on the {what}")
    if not np.allclose(a, b, rtol=8e-2, atol=2e-2) or corr <= 0.9999 or d.mean() >= 5e-3:
        fail(f"K1 disagrees with its plain version on the {what} beyond rtol 8e-2, atol 2e-2, "
             "corr 0.9999, mean 5e-3")
    return float(d.max())


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
    from zeroshape_tpu_torch.models.implicit import Implicit
    from zeroshape_tpu_torch.ops import _build
    from zeroshape_tpu_torch.ops import implicit_kernel as ik
    from zeroshape_tpu_torch.weights import init_like_flax

    found = sass_counts(_build.library_path(ik._NAME))
    if found is None:
        print("K1 SASS: no cuobjdump found")
    else:
        print(f"K1 SASS ({found[0]}): {found[1]}")
    g = torch.Generator().manual_seed(1)
    impl = init_like_flax(Implicit(num_patches=196, latent_dim=256), seed=1)
    with torch.no_grad():
        for name, prm in impl.named_parameters():  # non-zero biases
            if name.endswith("bias"):
                prm.add_(0.05 * torch.randn(prm.shape, generator=g))
        # a random decoder's field is nearly flat across points (logit std
        # ~0.1); a stronger point embedding makes the logits vary by more
        # than bf16 noise, as a trained field does
        impl.point_proj.proj.weight.mul_(8.0)
        # the kernel's operands are bf16: the plain version gets the same
        # bf16-valued weights (and caches, below), so the comparison measures
        # the kernel's arithmetic rather than the rounding of its inputs
        for prm in impl.parameters():
            prm.copy_(prm.to(torch.bfloat16).float())
    impl = impl.to(dev).eval()
    P = 4096 * 125  # the fine pass of a vox-128, capacity-4096 hierarchical decode
    latent = torch.randn(1, 197, 256, generator=g).to(dev)
    points = (torch.rand(P, 3, generator=g) * 3.0 - 1.5).to(dev)
    coarse = coarse_lattice(128, device=dev)  # the coarse pass: 33^3 points
    with torch.inference_mode():
        caches = [(k.bfloat16().float(), v.bfloat16().float()) for k, v in impl.encode(latent)]
        packed = ik.pack_decoder_params(impl)
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
        "library_ms": None,  # no single PyTorch call computes the decoder
    }


def main_path(dev):
    """The full-size 128^3 reconstruction through ``recon``; returns (model, launches, level)."""
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
    return model, launches, level[0].float().cpu().numpy()


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
    from zeroshape_tpu_torch.ops import chamfer, implicit_kernel

    sources = {"implicit_decoder.cu": implicit_kernel.build, "chamfer.cu": chamfer.build}
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
    from zeroshape_tpu_torch.ops.chamfer import nn_min_squared_fast, nn_one_way
    from zeroshape_tpu_torch.ops.implicit_kernel import fused_decode

    return {"K1": fused_decode.launches, "K2": nn_one_way.launches, "K3": nn_min_squared_fast.launches}


def reset_counts():
    from zeroshape_tpu_torch.ops.chamfer import nn_min_squared_fast, nn_one_way
    from zeroshape_tpu_torch.ops.implicit_kernel import fused_decode

    fused_decode.launches = nn_one_way.launches = nn_min_squared_fast.launches = 0


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


def evaluate_posture(model, samples, training):
    """One evaluation of ``samples`` through ``shape_engine.evaluate``; returns its launches."""
    from zeroshape_tpu_torch import recon
    from zeroshape_tpu_torch.config import eval_opt, full_opt
    from zeroshape_tpu_torch.runtime import shape_engine

    name = "validation" if training else "final"
    opt = eval_opt(full_opt(), vox_res=recon.VOX_RES, brute_force=True, batch_size=2)
    thresholds = tuple(opt.eval.f_thresholds)
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        t0 = time.perf_counter()
        res = shape_engine.evaluate(model, samples, opt, tmp, ["prim"], training=training)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        n = launch_counts()
        if training:  # validation writes no result files (shape_engine.py:605, 711): write them here
            if os.listdir(tmp):
                fail(f"validation wrote {os.listdir(tmp)}")
            with open(os.path.join(tmp, "synthetic_full_results.txt"), "w") as f:
                f.write(shape_engine.full_results_header(thresholds))
                for i in range(len(res["acc"])):
                    f.write(shape_engine.full_results_line(res["idx"][i], res["acc"][i], res["comp"][i], res["f_score"][i]))
            shape_engine.write_summaries(tmp, opt, ["prim"], res["acc"], res["comp"], res["f_score"],
                                         res["category_label"], res["val_metric"])
        parse_results(tmp, res, thresholds)
    k = len(samples)
    want = {"K1": k, "K2": 288 * k, "K3": 0} if not training else {"K1": 2 * k, "K2": 6 * k, "K3": 72 * k}
    print(f"evaluation, {name} posture ({'coarse-to-fine decode, pruned' if training else 'dense decode, exhaustive'} "
          f"search), {k} samples at batch 2: CD {res['val_metric']:.6f}, launches {n} (expected {want}); "
          f"{seconds / k:.3f} s/sample over the run, per batch {[round(x, 4) for x in res['s_per_sample']]}")
    if n != want:
        fail(f"{name} posture launched {n}, expected {want}")
    if not all(np.isfinite(res[x]).all() for x in ("acc", "comp", "f_score")):
        fail(f"{name} posture gave non-finite metrics")
    return n


def time_chamfer(x1, x2, fast):
    """(kernel ms, plain ms, library ms, bound ms, bound_by) of K2 (or K3 with ``fast``)."""
    from zeroshape_tpu_torch.ops import chamfer as ch

    if fast:
        ms = cuda_ms(lambda: ch.nn_min_squared_fast(x1, x2))
        plain_ms = cuda_ms(lambda: ch._nn_min_plain(x1, x2), warmup=1, iters=3)
    else:
        ms = cuda_ms(lambda: ch.nn_one_way(x1, x2))
        plain_ms = cuda_ms(lambda: ch._refine(x1, x2, ch._nn_one_way_plain(x1, x2)[1]), warmup=1, iters=3)
    library_ms = cuda_ms(lambda: torch.cdist(x1, x2).min(dim=-1), warmup=1, iters=3)
    torch.cuda.empty_cache()
    B, N, M = x1.shape[0], x1.shape[1], x2.shape[1]
    flops = (7 if fast else 9) * B * N * M  # the JAX CostEstimate per pair (chamfer.py:127-131, 183-187)
    nbytes = (x1.numel() + x2.numel()) * 4 + B * N * (4 if fast else 12)
    bound_ms = max(flops / H100_FP32_FLOPS, nbytes / H100_BYTES_PER_S) * 1e3
    bound_by = "operations" if flops / H100_FP32_FLOPS > nbytes / H100_BYTES_PER_S else "bytes"
    print(f"{'K3' if fast else 'K2'} time at B={B}, N={N}, M={M}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"library (cdist + min) {library_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP "
          f"at fp32 SIMT, {nbytes / 1e6:.2f} MB); {flops / ms / 1e9:.1f} TFLOP/s achieved")
    return ms, plain_ms, library_ms, bound_ms, bound_by


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    from zeroshape_tpu_torch import resolve_device
    from zeroshape_tpu_torch.data import analytic
    from zeroshape_tpu_torch.ops.marching_cubes import marching_cubes_mesh, write_ply_mesh

    dev = resolve_device(None)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")

    build_kernels()
    k1 = check_k1(dev)
    model, main_launches, level = main_path(dev)

    verts, faces = marching_cubes_mesh(level)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mesh.ply")
        write_ply_mesh(path, verts / level.shape[0] * 3.0 - 1.5, faces)
        size = os.path.getsize(path)
    if len(faces) == 0 or not np.isfinite(verts).all():
        fail("mesh empty or its vertices not finite")
    print(f"mesh: {len(verts)} vertices, {len(faces)} faces, {size} bytes of PLY")
    sampler_determinism(level, dev)

    with torch.inference_mode():
        exact = unit_clouds(48, 10000, 10000, seed=5)  # one exact brute-force batch
        k2_err = max(check_k2(*exact, "B=48, N=M=10,000"), check_k2(*unit_clouds(3, 1000, 777, seed=6), "B=3, N=1,000, M=777"))
        coarse = unit_clouds(192, 1024, 1024, seed=7)  # one coarse batch
        k3_err = max(check_k3(*coarse, "B=192, N=M=1,024"), check_k3(*unit_clouds(3, 1000, 777, seed=8), "B=3, N=1,000, M=777"))
    planted_rotation(dev)

    t0 = time.perf_counter()
    samples = analytic.eval_samples(n_objects=N_EVAL, n_views=2, H=224, seed=0)
    print(f"evaluation: {len(samples)} analytic test samples (224^2, 10,000 GT points) made in "
          f"{time.perf_counter() - t0:.1f} s")
    final = evaluate_posture(model, samples, training=False)
    val = evaluate_posture(model, samples, training=True)

    with torch.inference_mode():
        k2_times = time_chamfer(*exact, fast=False)
        k3_times = time_chamfer(*coarse, fast=True)

    # launches: the sum over the path runs (main path, final and validation
    # posture), each counted from 0
    launches = {k: main_launches * (k == "K1") + final[k] + val[k] for k in ("K1", "K2", "K3")}
    k1["launches"] = launches["K1"]
    kernels = [k1]
    for name, key, times, err, line in (
        ("chamfer_nn", "K2", k2_times, k2_err, 63), ("chamfer_nn_min_bf16", "K3", k3_times, k3_err, 138),
    ):
        ms, plain_ms, library_ms, bound_ms, bound_by = times
        kernels.append({
            "name": name, "route": "cuda", "source": "zeroshape_tpu_torch/csrc/chamfer.cu",
            "replaces": f"zeroshape_tpu/ops/chamfer.py:{line}", "launches": launches[key], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        })
    if min(launches.values()) == 0:
        fail(f"a kernel of the paths was never launched: {launches}")

    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: kern[k] for k in order} for kern in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
