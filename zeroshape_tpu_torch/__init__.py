"""PyTorch/CUDA port of zeroshape_tpu (single-image 3D shape reconstruction).

The JAX package ``zeroshape_tpu`` is the reference; this package mirrors its
layout module for module (``models/``, ``ops/``, ``metrics/``, ``camera.py``,
``config.py``) and imports only torch, numpy and the standard library.

Entry points take ``device=None``, which means CUDA. The CPU runs only when a
caller asks for it (``device="cpu"``), as the tests do; with no GPU present a
default-device call raises instead of silently running on the CPU.
"""

from __future__ import annotations

import torch


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
