"""Image resampling with torch interpolation semantics (NCHW).

Counterpart of ``zeroshape_tpu/ops/image.py``. The JAX package builds
explicit interpolation matrices because ``jax.image.resize`` only has
half-pixel centres; here ``F.interpolate`` is the very semantics those
matrices reproduce: ``align_corners=True`` for the DPT fusion upsample,
``align_corners=False`` (no antialias) for the pos-embed resize.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def resize_bilinear(x, out_hw, align_corners=False):
    """Bilinear resize of NCHW ``x`` to ``out_hw``, computed in fp32."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    y = F.interpolate(x.float(), size=tuple(out_hw), mode="bilinear", align_corners=align_corners)
    return y.to(x.dtype)


@lru_cache(maxsize=128)
def linear_resize_matrix(in_size, out_size, align_corners):
    """``[out_size, in_size]`` float32 linear-interpolation weights (a copy of
    ``zeroshape_tpu/ops/image.py:_linear_resize_matrix``)."""
    W = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        W[:, 0] = 1.0
        return W
    for o in range(out_size):
        if align_corners:
            src = o * (in_size - 1) / max(out_size - 1, 1)
        else:
            src = (o + 0.5) * in_size / out_size - 0.5
        src = min(max(src, 0.0), in_size - 1)
        lo = int(np.floor(src))
        hi = min(lo + 1, in_size - 1)
        frac = src - lo
        W[o, lo] += 1.0 - frac
        W[o, hi] += frac
    return W


def resize_bilinear_separable(x, out_hw, align_corners=False):
    """Bilinear resize of fp32 maps ``x [N, h, w]`` to ``[N, *out_hw]`` as the JAX
    package computes it: rows, then columns, through the interpolation
    matrices, each output summed in input order in fp32 (a multiply, then an
    add). On the CPU this gives the JAX resize bit for bit, where
    ``F.interpolate`` lands an ulp away; the attention frames truncate
    ``255 * map`` to a colour-table index, so an ulp can change a colour."""
    N, h, w = x.shape
    Wh = torch.from_numpy(linear_resize_matrix(h, out_hw[0], align_corners)).to(x.device)
    Ww = torch.from_numpy(linear_resize_matrix(w, out_hw[1], align_corners)).to(x.device)
    rows = torch.zeros(N, out_hw[0], w, dtype=torch.float32, device=x.device)
    for k in range(h):
        rows = rows + Wh[None, :, k, None] * x[:, k, None, :]
    out = torch.zeros(N, out_hw[0], out_hw[1], dtype=torch.float32, device=x.device)
    for k in range(w):
        out = out + Ww[None, None, :, k] * rows[:, :, k, None]
    return out


def upsample2x(x, align_corners=True):
    """2x bilinear upsample (the DPT fusion-block step)."""
    h, w = x.shape[-2:]
    return resize_bilinear(x, (2 * h, 2 * w), align_corners=align_corners)


def adaptive_avg_pool_11(x):
    """NCHW global average pool to ``[B, C]``."""
    return x.mean(dim=(2, 3))


def interpolate_coordmap(coord_map, mask_map, out_hw):
    """Masked bilinear downsample of a coordinate map and its mask (NCHW).

    The coord map is multiplied by the mask, resized, then renormalised by
    the resized mask so invalid pixels don't bleed in (reference
    utils/util.py:336-345). Identity when the shapes already match.
    Returns ``(coord_dsp, mask_dsp)``, the mask binarised at 0.5.
    """
    if tuple(coord_map.shape[-2:]) == tuple(out_hw):
        return coord_map, mask_map
    num = resize_bilinear(coord_map * mask_map, out_hw, align_corners=False)
    den = resize_bilinear(mask_map, out_hw, align_corners=False)
    coord_dsp = num / torch.clamp(den, min=1e-6)
    mask_dsp = (den > 0.5).to(mask_map.dtype)
    return coord_dsp * mask_dsp, mask_dsp
