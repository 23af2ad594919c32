"""PyTorch/CUDA port of zeroshape_tpu (single-image 3D shape reconstruction).

The JAX package ``zeroshape_tpu`` is the reference; this package mirrors its
layout module for module (``models/``, ``ops/``, ``metrics/``, ``camera.py``,
``config.py``) and imports only torch, numpy and the standard library.

Entry points take ``device=None``, which means CUDA. The CPU runs only when a
caller asks for it (``device="cpu"``), as the tests do; with no GPU present a
default-device call raises instead of silently running on the CPU.
"""

from __future__ import annotations

import atexit
import os

import torch

# With ZS_LAUNCH_LOG set, each process appends its kernel launch counts to
# that file when it exits: how a driver counts the launches of the
# subprocesses it starts (chip_smoke.py's chain phase).
LAUNCH_LOG = "ZS_LAUNCH_LOG"


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``. Raises when CUDA is asked for but absent.

    On CUDA this also pins the TF32 policy: float32 matmuls and cuDNN
    convolutions run in full float32 (the bf16 compute path is chosen by the
    dtype policy, never by TF32 rounding of float32 work).
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def _append_launches(path):
    """Append ``{"argv", "K1", "K2", "K3", "plain"}`` of this process to ``path``
    (a JSON line): the launch counts of the kernel wrappers it imported."""
    import json
    import sys

    ik, ch, rc = (sys.modules.get(f"zeroshape_tpu_torch.{m}") for m in ("ops.implicit_kernel", "ops.chamfer", "recon"))
    line = {"argv": sys.argv, "K1": ik.fused_decode.launches if ik else 0, "K2": ch.nn_one_way.launches if ch else 0,
            "K3": ch.nn_min_squared_fast.launches if ch else 0, "plain": rc.decode_points.plain_decodes if rc else 0}
    with open(path, "a") as f:
        f.write(json.dumps(line) + "\n")


if os.environ.get(LAUNCH_LOG):
    atexit.register(_append_launches, os.environ[LAUNCH_LOG])
