"""Image resampling with torch interpolation semantics (NCHW).

Counterpart of ``zeroshape_tpu/ops/image.py``. The JAX package builds
explicit interpolation matrices because ``jax.image.resize`` only has
half-pixel centres; here ``F.interpolate`` is the very semantics those
matrices reproduce: ``align_corners=True`` for the DPT fusion upsample,
``align_corners=False`` (no antialias) for the pos-embed resize.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x, out_hw, align_corners=False):
    """Bilinear resize of NCHW ``x`` to ``out_hw``, computed in fp32."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    y = F.interpolate(x.float(), size=tuple(out_hw), mode="bilinear", align_corners=align_corners)
    return y.to(x.dtype)


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
