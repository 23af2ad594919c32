"""Model stack — DPT depth, coordinate encoder, implicit decoder.

Also hosts the compute-dtype policy (counterpart of
``zeroshape_tpu/models/__init__.py:13-30``): ``arch.dtype: auto`` means bf16
compute on CUDA and fp32 on the CPU. Parameters and geometry stay fp32; the
bf16 compute runs under ``torch.autocast``.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_compute_dtype(opt, device) -> torch.dtype:
    """Map ``opt.arch.dtype`` to the compute dtype on ``device``."""
    name = (opt.get("arch") or {}).get("dtype") or "auto"
    if name == "auto":
        return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    return getattr(torch, name)


def compute_autocast(device, dtype):
    """Autocast context for ``dtype`` compute; a no-op for fp32."""
    if dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(torch.device(device).type, dtype=dtype)


def fp32_region(device):
    """Context that turns autocast off (geometry runs in fp32)."""
    return torch.autocast(torch.device(device).type, enabled=False)
