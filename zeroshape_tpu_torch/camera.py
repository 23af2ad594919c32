"""Camera geometry in fp32 (counterpart of ``zeroshape_tpu/camera.py:69-141``).

Points are ``[..., N, 3]``, intrinsics ``[..., 3, 3]``. The pixel grid is
integer pixel coordinates (x, y, 1) with no half-pixel offset.
"""

from __future__ import annotations

import torch


def valid_norm_fac(seen_points, mask, eps=0.0):
    """Masked per-sample mean and max radius of the visible surface.

    ``seen_points [B, HW, 3]``, ``mask [B, HW]`` -> (means [B, 3],
    max_dists [B]). Empty samples give mean 0 and scale 1.
    """
    B, N = seen_points.shape[:2]
    mask_f = mask.reshape(B, N).to(seen_points.dtype)
    count = mask_f.sum(dim=1, keepdim=True)
    means = (seen_points * mask_f[..., None]).sum(dim=1) / torch.clamp(count, min=1.0)
    centered = seen_points - means[:, None, :]
    dist = torch.sqrt((centered * centered).sum(dim=-1))
    dist = torch.where(mask_f > 0, dist, torch.full_like(dist, float("-inf")))
    max_dists = torch.where(count[:, 0] > 0, dist.max(dim=1).values, torch.ones_like(count[:, 0]))
    if eps:
        max_dists = torch.clamp(max_dists, min=eps)
    return means, max_dists


def normalize_seen_points(seen_points, mask):
    """Centre/scale the visible surface to the unit sphere; zero the background.

    Returns (normalized [B, HW, 3], mean [B, 3], scale [B]).
    """
    B, N = seen_points.shape[:2]
    mask_f = mask.reshape(B, N)
    mean, scale = valid_norm_fac(seen_points, mask_f)
    # an (untrained / degenerate) all-zero depth map gives scale 0
    scale = torch.clamp(scale, min=1e-8)
    out = (seen_points - mean[:, None, :]) / scale[:, None, None]
    return out * (mask_f > 0).to(out.dtype)[..., None], mean, scale


def get_pixel_grid(H, W, device=None, dtype=torch.float32):
    """``[H*W, 3]`` homogeneous pixel coordinates (x, y, 1)."""
    y = torch.arange(H, device=device, dtype=dtype)
    x = torch.arange(W, device=device, dtype=dtype)
    Y, X = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([X, Y, torch.ones_like(Y)], dim=-1).reshape(-1, 3)


def unproj_depth(depth, intr):
    """Unproject ``depth [B, H, W]`` with ``intr [B, 3, 3]`` -> camera-frame ``[B, H*W, 3]``."""
    B, H, W = depth.shape
    K_inv = torch.linalg.inv(intr.float())
    pix = get_pixel_grid(H, W, device=depth.device)
    rays = torch.einsum("nk,bjk->bnj", pix, K_inv)
    return rays * depth.float().reshape(B, H * W, 1)
