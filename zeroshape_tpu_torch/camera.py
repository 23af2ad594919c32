"""Camera geometry in fp32 (counterpart of ``zeroshape_tpu/camera.py``).

Points are ``[..., N, 3]``, poses ``[..., 3, 4]`` (R | t), intrinsics
``[..., 3, 3]``. The pixel grid is integer pixel coordinates (x, y, 1) with
no half-pixel offset.
"""

from __future__ import annotations

import numpy as np
import torch

from zeroshape_tpu_torch import resolve_device


# ---------------------------------------------------------------------------
# pose utilities (camera.py:25-66; the reference's utils/camera.py Pose)
# ---------------------------------------------------------------------------


def pose_from(R=None, t=None):
    """A ``[..., 3, 4]`` pose from ``R [..., 3, 3]`` and/or ``t [..., 3]``:
    the identity rotation where ``R`` is None, a zero translation where
    ``t`` is."""
    if R is None and t is None:
        raise ValueError("need R or t")
    if R is None:
        t = torch.as_tensor(t, dtype=torch.float32)
        R = torch.eye(3, dtype=torch.float32, device=t.device).expand(*t.shape[:-1], 3, 3)
    elif t is None:
        R = torch.as_tensor(R, dtype=torch.float32)
        t = torch.zeros(R.shape[:-1], dtype=torch.float32, device=R.device)
    else:
        R, t = torch.as_tensor(R, dtype=torch.float32), torch.as_tensor(t, dtype=torch.float32)
    return torch.cat([R, t[..., None]], dim=-1)


def pose_invert(pose):
    """The inverse of a rigid ``[..., 3, 4]`` pose (R orthonormal): ``(R^T | -R^T t)``."""
    R, t = pose[..., :3], pose[..., 3:]
    R_inv = R.transpose(-1, -2)
    return pose_from(R=R_inv, t=(-R_inv @ t)[..., 0])


def pose_compose_pair(pose_a, pose_b):
    """The pose x -> pose_b(pose_a(x))."""
    R_a, t_a = pose_a[..., :3], pose_a[..., 3:]
    R_b, t_b = pose_b[..., :3], pose_b[..., 3:]
    return pose_from(R=R_b @ R_a, t=(R_b @ t_a + t_b)[..., 0])


def pose_compose(pose_list):
    """The poses of ``pose_list`` applied in order (the first innermost)."""
    pose_new = pose_list[0]
    for p in pose_list[1:]:
        pose_new = pose_compose_pair(pose_new, p)
    return pose_new


def to_hom(X):
    """``[..., 3]`` -> homogeneous ``[..., 4]`` (a trailing 1)."""
    return torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)


def world2cam(X_world, pose):
    """World points ``[B, N, 3]`` into the frame of ``pose [B, 3, 4]``."""
    return to_hom(X_world) @ pose.transpose(-1, -2)


def proj_points(points, intr, pose):
    """World points ``[B, N, 3]`` -> (pixel coordinates ``[B, N, 2]``, camera
    depth ``[B, N]``) through ``pose [B, 3, 4]`` and ``intr [B, 3, 3]``."""
    points_cam = world2cam(points, pose)
    points_img = cam2img(points_cam, intr)
    return points_img[..., :2] / points_img[..., 2:], points_cam[..., 2]


# ---------------------------------------------------------------------------
# the visible surface, unprojection (camera.py:69-154)
# ---------------------------------------------------------------------------


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
    # sqrt has an infinite gradient at 0, where an all-zero depth map lands:
    # the double where keeps value and gradient finite (camera.py:86-89)
    sq = (centered * centered).sum(dim=-1)
    dist = torch.where(sq > 0, torch.sqrt(torch.where(sq > 0, sq, 1.0)), 0.0)
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


def cam2img(X_cam, intr):
    """Camera-frame points ``[B, N, 3]`` -> homogeneous image coordinates (camera.py:153-154)."""
    return X_cam @ intr.transpose(-1, -2)


# ---------------------------------------------------------------------------
# rotation builders and the brute-force rotation sphere (camera.py:169-243)
# ---------------------------------------------------------------------------


def _rot(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _rot_azim(angles_deg):
    """Rotations about y by ``angles_deg [...]`` -> ``[..., 3, 3]``."""
    a = torch.deg2rad(angles_deg)
    c, s, z, o = torch.cos(a), torch.sin(a), torch.zeros_like(a), torch.ones_like(a)
    return _rot([[c, z, s], [z, o, z], [-s, z, c]])


def _rot_elev(angles_deg):
    """Rotations about x by ``angles_deg [...]`` -> ``[..., 3, 3]``."""
    a = torch.deg2rad(angles_deg)
    c, s, z, o = torch.cos(a), torch.sin(a), torch.zeros_like(a), torch.ones_like(a)
    return _rot([[o, z, z], [z, c, -s], [z, s, c]])


def _rot_roll(angles_deg):
    """Rotations about z by ``angles_deg [...]`` -> ``[..., 3, 3]``."""
    a = torch.deg2rad(angles_deg)
    c, s, z, o = torch.cos(a), torch.sin(a), torch.zeros_like(a), torch.ones_like(a)
    return _rot([[c, s, z], [-s, c, z], [z, z, o]])


# axis permutation applied before the Euler product (reference camera.py:223-227)
R_PERMUTE = np.array([[-1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, -1.0, 0.0]], dtype=np.float32)


def get_rotation_sphere(azim_sample=4, elev_sample=4, roll_sample=4, scales=1.0, device=None):
    """All rotations ``R = scale * Rz(roll) Rx(elev) Ry(azim) R_PERMUTE``.

    Returns ``[len(scales) * azim * elev * roll, 3, 3]`` fp32 on ``device``
    (None -> cuda), ordered scale-major, then azim > elev > roll: 6912
    rotations at (24, 24, 12).
    """
    device = resolve_device(device)
    if isinstance(scales, (int, float)):
        scales = (float(scales),)
    grid = [np.linspace(0.0, 360.0, num=n, endpoint=False) for n in (azim_sample, elev_sample, roll_sample)]
    A, E, RL = (torch.as_tensor(x.reshape(-1), dtype=torch.float32, device=device)
                for x in np.meshgrid(*grid, indexing="ij"))
    R = _rot_roll(RL) @ _rot_elev(E) @ _rot_azim(A) @ torch.as_tensor(R_PERMUTE, device=device)
    return torch.cat([s * R for s in scales], dim=0)
