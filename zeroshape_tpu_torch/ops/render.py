"""Turntable renderer by surface splatting with a z-buffer (counterpart of
``zeroshape_tpu/ops/render.py``).

The mesh surface is sampled area-uniformly (an inverse CDF over the face
areas), every view's points are rotated at once, and hidden surfaces go by
one ``scatter_reduce_(..., "amin")`` over a packed int32 key (22 depth bits,
then 8 shade bits), all views of a mesh in one pass on its device. Shading
is two-sided Lambertian from the face normals with a headlight term.

The JAX module pads the triangle soup to power-of-two face counts
(``pad_mesh``) only to bound ``jit`` recompiles. Here :func:`mesh_triangles`
gathers the soup without padding: zero-area padding never draws a point,
and the face CDF (``fixed_order_cumsum``) of the real faces is the same with
or without it, so the frames are the same (``tests/test_torch_port_render.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from zeroshape_tpu_torch import resolve_device
from zeroshape_tpu_torch.ops.marching_cubes import fixed_order_cumsum

DEPTH_BITS = 22
SHADE_BITS = 8
BG_KEY = (1 << (DEPTH_BITS + SHADE_BITS)) - 1
BASE_RGB = (0.784, 0.784, 0.863)  # #c8c8dc
LIGHT = (-0.4, -0.65, 0.65)


def _orbit_rotations(n_views, elev_deg, device=None):
    """``[n_views, 3, 3]`` world->camera rotations of an azimuth orbit at a fixed
    elevation (matplotlib's ``view_init(elev, azim)``: the camera orbits the
    z-up mesh; rotate about z by -azim, then tilt about x by elev)."""
    azim = torch.arange(n_views, dtype=torch.float32, device=device) * (2.0 * math.pi / n_views)
    el = torch.tensor(np.deg2rad(elev_deg), dtype=torch.float32, device=device)
    ca, sa = torch.cos(azim), torch.sin(azim)
    ce, se = torch.cos(el), torch.sin(el)
    zero, one = torch.zeros_like(ca), torch.ones_like(ca)
    rz = torch.stack([ca, sa, zero, -sa, ca, zero, zero, zero, one], dim=-1).reshape(n_views, 3, 3)
    rx = torch.stack([one[0], zero[0], zero[0], zero[0], ce, se, zero[0], -se, ce]).reshape(3, 3)
    return (rx[None, :, :, None] * rz[:, None, :, :]).sum(dim=2)


def _sample_surface(tri, n_points, generator=None, u=None, r=None):
    """Area-uniform surface points and their face normals (``[N, 3]``, ``[N, 3]``).

    Stratified inverse-CDF draws: point n takes ``(n + u[n]) / N`` of the
    total area. ``u [N]`` and the barycentric uniforms ``r [N, 2]`` come from
    ``generator`` unless given (a test injects the JAX draws). Zero-area
    triangles are never drawn.
    """
    dev = tri.device
    e1, e2 = tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    cr = torch.linalg.cross(e1, e2)
    area2 = torch.linalg.vector_norm(cr, dim=-1)  # twice the face area
    normals = cr / (area2[:, None] + 1e-12)
    cdf = fixed_order_cumsum(area2)
    if u is None:
        u = torch.rand(n_points, generator=generator, device=dev)
    if r is None:
        r = torch.rand(n_points, 2, generator=generator, device=dev)
    u = (torch.arange(n_points, dtype=torch.float32, device=dev) + u) / n_points
    fid = torch.clamp(torch.searchsorted(cdf, u * cdf[-1]), 0, tri.shape[0] - 1)
    s = torch.sqrt(r[:, :1])
    bary = torch.cat([1.0 - s, s * (1.0 - r[:, 1:]), s * r[:, 1:]], dim=-1)
    t = tri[fid]
    pts = bary[:, 0:1] * t[:, 0] + bary[:, 1:2] * t[:, 1] + bary[:, 2:3] * t[:, 2]
    return pts, normals[fid]


def _rotate(R, x):
    """``x [N, 3]`` in each frame of ``R [V, 3, 3]`` -> ``[V, N, 3]`` (``x @ R.T``),
    summed elementwise in fp32 in one order on every device, whatever the
    matmul precision setting."""
    x, R = x[None, :, None, :], R[:, None, :, :]
    return x[..., 0] * R[..., 0] + x[..., 1] * R[..., 1] + x[..., 2] * R[..., 2]


def render_turntable(tri, generator=None, n_views=15, image_size=320, n_points=1 << 18, elev_deg=15.0, u=None,
                     r=None, device=None):
    """``n_views`` orbit frames of a mesh, uint8 ``[n_views, H, W, 3]`` on ``device`` (None -> cuda).

    ``tri [F, 3, 3]`` is the triangle soup (:func:`mesh_triangles`) of a mesh
    centred and scaled to max-abs 1 (``vis.dump_meshes_viz``). The surface
    draws come from ``generator`` (on ``device``), or ``u``/``r``
    (:func:`_sample_surface`). Each point splats a 2x2 footprint, clamped to
    the image border.
    """
    dev = resolve_device(device)
    tri = torch.as_tensor(tri).to(dev, torch.float32)
    if u is not None:
        u, r = torch.as_tensor(u).to(dev), torch.as_tensor(r).to(dev)
    H = W = image_size
    pts, nrm = _sample_surface(tri, n_points, generator, u, r)
    rots = _orbit_rotations(n_views, elev_deg, dev)
    p, n = _rotate(rots, pts), _rotate(rots, nrm)  # [V, N, 3]: x right, z up, y into the screen
    light = torch.tensor(LIGHT, dtype=torch.float32, device=dev)
    light = light / torch.linalg.vector_norm(light)
    lam = 0.55 * torch.abs(n[..., 0] * light[0] + n[..., 1] * light[1] + n[..., 2] * light[2]) + 0.45 * torch.abs(
        n[..., 1])
    shade = torch.clamp(0.25 + 0.75 * lam, 0.0, 1.0)
    sx = (p[..., 0] * 0.42 + 0.5) * W
    sy = (0.5 - p[..., 2] * 0.42) * H
    ix = torch.clamp(sx.to(torch.int32), 0, W - 2)
    iy = torch.clamp(sy.to(torch.int32), 0, H - 2)
    zmax = (1 << DEPTH_BITS) - 2
    zq = torch.clamp(((p[..., 1] + 1.5) / 3.0 * zmax).to(torch.int32), 0, zmax)
    sq = torch.clamp((shade * 255.0).to(torch.int32), 0, 255)
    key = (zq << SHADE_BITS) | sq
    view = torch.arange(n_views, device=dev, dtype=torch.int64)[:, None] * (H * W)
    pix = view + iy.long() * W + ix.long()
    index = torch.cat([pix, pix + 1, pix + W, pix + W + 1], dim=1).reshape(-1)  # the 2x2 footprint
    buf = torch.full((n_views * H * W,), BG_KEY, dtype=torch.int32, device=dev)
    buf.scatter_reduce_(0, index, key.repeat(1, 4).reshape(-1), reduce="amin")
    hit = buf != BG_KEY
    sh = (buf & ((1 << SHADE_BITS) - 1)).float() / 255.0
    base = torch.tensor(BASE_RGB, dtype=torch.float32, device=dev)
    rgb = torch.where(hit[:, None], sh[:, None] * base[None, :], torch.ones((), device=dev))
    return (rgb * 255.0).to(torch.uint8).reshape(n_views, H, W, 3)


def mesh_triangles(verts, faces):
    """The triangle soup ``[F, 3, 3]`` float32 of a mesh (numpy)."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int64).reshape(-1, 3)
    return np.ascontiguousarray(verts[faces]) if len(faces) else np.zeros((0, 3, 3), np.float32)
