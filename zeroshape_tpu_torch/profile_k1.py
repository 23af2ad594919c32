"""Where the fused implicit decoder (K1) spends its time inside one launch.

    python -m zeroshape_tpu_torch.profile_k1 [P]

Builds a second copy of ``csrc/implicit_decoder.cu`` with ``-DZS_PROFILE``:
the first thread of every consumer warpgroup adds the cycles (``clock64``)
between consecutive marks of its program to one counter per phase. Runs it
on P points (default 512,000, a vox-128 fine pass) of the full-width decoder
``chip_smoke.py`` holds against its plain version, and prints each phase's
share of the consumers' time, beside the CUDA-event times of the plain build
and the profiled one (the counters' atomics cost a few percent). A "mma"
phase is the wait for the weight ring plus the tensor-core work; the others
are the epilogues between products.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from zeroshape_tpu_torch.models.implicit import Implicit
from zeroshape_tpu_torch.ops import _build
from zeroshape_tpu_torch.ops import implicit_kernel as ik
from zeroshape_tpu_torch.weights import init_like_flax

# the PROF(k) marks of csrc/implicit_decoder.cu, in program order
PHASES = (
    "point embedding", "LN1 + park residual", "qkv mma", "qkv bias, q/k.q/v", "scores mma", "softmax",
    "P@V mma", "attention out store", "attention barrier", "unpark residual", "proj mma + bias", "LN2",
    "fc1 mma", "fc1 bias + GELU", "fc2 mma", "final LN", "skip-MLP mma", "skip-MLP point rows",
    "skip-MLP bias + softplus", "skip-MLP state store", "output linear",
)


def _time(fn, iters=5):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(P=512_000):
    if not torch.cuda.is_available():
        raise SystemExit("profile_k1 needs a CUDA device")
    signatures = dict(ik._SIGNATURES, zs_prof_read=[ctypes.c_void_p], zs_prof_reset=[])
    prof = _build.library(ik._SOURCE, ik._NAME + "_prof", signatures, flags=["-DZS_PROFILE"])
    g = torch.Generator().manual_seed(1)
    impl = init_like_flax(Implicit(num_patches=196, latent_dim=256), seed=1).cuda().eval()
    with torch.inference_mode():
        caches = impl.encode(torch.randn(1, 197, 256, generator=g).cuda())
        packed = ik.pack_decoder_params(impl)
        points = (torch.rand(P, 3, generator=g) * 3.0 - 1.5).cuda()
        out = torch.empty(P, device="cuda")
        plain_ms = _time(lambda: ik.launch(ik._library(), caches, points, packed, out))
        prof_ms = _time(lambda: ik.launch(prof, caches, points, packed, out))
        prof.zs_prof_reset()
        ik.launch(prof, caches, points, packed, out)
        torch.cuda.synchronize()
    counts = (ctypes.c_ulonglong * 24)()
    if prof.zs_prof_read(ctypes.addressof(counts)) != 0:
        raise RuntimeError("reading the phase counters failed")
    cycles = np.array(counts[: len(PHASES)], dtype=np.float64)
    print(f"K1 on {P} points: {plain_ms:.3f} ms, {prof_ms:.3f} ms with the phase counters "
          f"({torch.cuda.get_device_name(0)})")
    for name, c in sorted(zip(PHASES, cycles), key=lambda x: -x[1]):
        print(f"  {name:26s} {c / cycles.sum():6.1%}")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
