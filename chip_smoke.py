"""Drive the PyTorch/CUDA port on one GPU: build its kernel, hold it against
its plain version, run the full-size main path, export a mesh.

    python3 chip_smoke.py

Phases (one line each, any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build the fused implicit-decoder kernel from csrc/ with nvcc;
  3. K1 against its plain version (``Implicit.decode`` in fp32) at full width
     (C=256, 8 heads, 2 blocks, 9 linears, L=197) at the two sizes the main
     path gives it: the 35,937 points of the coarse 33^3 lattice (a partial
     last tile) and the 512,000 points of a vox-128 fine pass; bf16 bounds
     of tests/test_implicit_kernel.py; CUDA-event times of the kernel and
     the plain version at 512,000 points, and the bound;
  4. the main path: ``recon.synthetic_setup`` at full size (224^2, vox 128,
     capacity 4096, 10k points, sharpen 25) on a seeded synthetic masked
     image, the random field calibrated to a trained field's inside share
     and active-cell count (``recon.calibrate_random_field``); kernel launches counted over
     one reconstruction; a surface must exist; median seconds;
  5. marching-cubes mesh export of the level grid to a PLY file (not empty).
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

import numpy as np
import torch

H100_BF16_FLOPS = 989e12  # dense tensor-core peak (NVIDIA data sheet, SXM)
H100_BYTES_PER_S = 3.35e12


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


def check_k1(dev):
    """K1 vs its plain version at full width; returns the kernel's numbers."""
    from zeroshape_tpu_torch.metrics.eval3d import coarse_lattice
    from zeroshape_tpu_torch.models.implicit import Implicit
    from zeroshape_tpu_torch.ops import implicit_kernel as ik
    from zeroshape_tpu_torch.weights import init_like_flax

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
        got = ik.fused_decode(impl, caches, points, packed)
        torch.cuda.synchronize()
        ref = impl.decode(caches, points[None])[0][0]
        err = agree(got, ref, "random points")
        shift = 37
        rolled = ik.fused_decode(impl, caches, torch.roll(points, shift, 0), packed)
        ms = cuda_ms(lambda: ik.fused_decode(impl, caches, points, packed))
        plain_ms = cuda_ms(lambda: impl.decode(caches, points[None]), warmup=1, iters=3)
        impl.dtype = torch.bfloat16
        ref_bf16 = impl.decode(caches, points[None])[0][0]
        plain_bf16_ms = cuda_ms(lambda: impl.decode(caches, points[None]), warmup=1, iters=3)
    d16 = float((got - ref_bf16).abs().max())
    print(f"K1 vs plain bf16 at P={P}: max|d| {d16:.3e}")
    if not torch.equal(rolled, torch.roll(got, shift, 0)):
        fail("K1 logits depend on the row a point lands in")

    L = caches[0][0].shape[2]
    flops = decoder_flops(P, L)
    nbytes = P * 3 * 4 + P * 4 + 2 * 2 * 8 * L * 32 * 2
    for v in packed.values():
        for t in v if isinstance(v, list) else [v]:
            nbytes += 0 if t is None else t.numel() * t.element_size()
    bound_ms = max(flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S) * 1e3
    bound_by = "operations" if flops / H100_BF16_FLOPS > nbytes / H100_BYTES_PER_S else "bytes"
    print(
        f"K1 time at P={P}: kernel {ms:.3f} ms, plain fp32 {plain_ms:.3f} ms, plain bf16 "
        f"{plain_bf16_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}: {flops / 1e12:.3f} TFLOP, "
        f"{nbytes / 1e6:.2f} MB); {flops / ms / 1e9:.1f} TFLOP/s achieved"
    )
    return {
        "name": "implicit_decoder",
        "route": "cuda",
        "source": "zeroshape_tpu_torch/csrc/implicit_decoder.cu",
        "replaces": "zeroshape_tpu/ops/implicit_kernel.py:162",
        "max_abs_err": max(err, err_coarse),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes the decoder
    }


def main_path(dev):
    """The full-size 128^3 reconstruction through ``recon``; returns (launches, level)."""
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
    return launches, level[0].float().cpu().numpy()


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    from zeroshape_tpu_torch import resolve_device
    from zeroshape_tpu_torch.ops import implicit_kernel
    from zeroshape_tpu_torch.ops.marching_cubes import marching_cubes_mesh, write_ply_mesh

    dev = resolve_device(None)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")

    seconds, log = implicit_kernel.build()
    print(f"build: implicit_decoder.cu in {seconds:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    k1 = check_k1(dev)
    launches, level = main_path(dev)
    k1["launches"] = launches

    verts, faces = marching_cubes_mesh(level)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mesh.ply")
        write_ply_mesh(path, verts / level.shape[0] * 3.0 - 1.5, faces)
        size = os.path.getsize(path)
    if len(faces) == 0 or not np.isfinite(verts).all():
        fail("mesh empty or its vertices not finite")
    print(f"mesh: {len(verts)} vertices, {len(faces)} faces, {size} bytes of PLY")

    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: k1[k] for k in order}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
