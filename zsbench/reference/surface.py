"""Plain surface sampling of a level grid, as the published protocol draws it.

Area-uniform points on the isosurface of a level grid ``[S, S, S]`` at 0.5:
every cube's candidate marching-cubes triangles (``mc_tables``, ``MAX_TRIS``
slots a cube, cube-major order), the CDF of their areas (float64, kept in
float32), ``num_points`` uniforms inverted through it to pick triangles, and
two more uniforms a point for its barycentric position (the square-root
trick). Given the same grid and the same generator state it draws the same
points as an implementation of the same protocol; the benchmark runs it on
the program's own level grid, so the comparison holds the sampler alone.
Points are in grid-index coordinates ``[0, S - 1]``.
"""

import torch

from zsbench.reference.mc_tables import CORNERS, EDGES, MAX_TRIS, TRI_TABLE

ISO = 0.5
SLAB = 1 << 18  # cubes a block of the area pass


def corner_values(level, base):
    """The 8 corner values ``[M, 8]`` of the cubes at origins ``base [M, 3]``."""
    S = level.shape[0]
    idx = base[:, None, :].long() + torch.as_tensor(CORNERS, device=level.device).long()[None]
    return level.reshape(-1)[(idx[..., 0] * S + idx[..., 1]) * S + idx[..., 2]]


def triangles(vals, origin):
    """Candidate triangles ``[M, MAX_TRIS, 3, 3]`` and their validity
    ``[M, MAX_TRIS]`` of cubes with corner values ``vals [M, 8]`` at
    ``origin [M, 3]`` (float)."""
    dev = vals.device
    case = ((vals >= ISO).long() * (1 << torch.arange(8, device=dev))).sum(dim=-1)
    ea, eb = (torch.as_tensor(EDGES[:, i], device=dev).long() for i in (0, 1))
    va, vb = vals[:, ea], vals[:, eb]
    denom = vb - va
    t = torch.where(denom.abs() > 1e-12, (ISO - va) / torch.where(denom == 0, torch.ones_like(denom), denom),
                    torch.full_like(denom, 0.5)).clamp(0.0, 1.0)
    corners = torch.as_tensor(CORNERS, device=dev).float()
    pa = origin[:, None, :] + corners[ea]
    pb = origin[:, None, :] + corners[eb]
    edge_pts = pa + t[..., None] * (pb - pa)  # [M, 12, 3]
    tri_edges = torch.as_tensor(TRI_TABLE, device=dev).long()[case]  # [M, MAX_TRIS, 3]
    verts = edge_pts[torch.arange(vals.shape[0], device=dev)[:, None, None], tri_edges.clamp(min=0)]
    return verts, tri_edges[..., 0] >= 0


def areas(vals):
    """Triangle areas ``[M, MAX_TRIS]`` (0 for unused slots) of cubes ``vals [M, 8]``."""
    verts, valid = triangles(vals, vals.new_zeros(vals.shape[0], 3))
    cross = torch.linalg.cross(verts[..., 1, :] - verts[..., 0, :], verts[..., 2, :] - verts[..., 0, :])
    return torch.where(valid, 0.5 * torch.sqrt((cross * cross).sum(dim=-1)), torch.zeros_like(valid, dtype=vals.dtype))


def draw(level, base, generator, num_points):
    """``num_points`` area-uniform points on the triangles of the cubes at ``base [M, 3]``."""
    a = torch.cat([areas(corner_values(level, base[i: i + SLAB])) for i in range(0, base.shape[0], SLAB)])
    cdf = torch.cumsum(a.reshape(-1).double(), dim=0).float()
    dev = level.device
    u = torch.rand(num_points, generator=generator, device=dev)
    r = torch.rand(num_points, 2, generator=generator, device=dev)
    total = cdf[-1]
    slot = torch.searchsorted(cdf, u * (total * (1.0 - 2.0**-22)), right=True).clamp(max=cdf.shape[0] - 1)
    cube, tri = slot // MAX_TRIS, slot % MAX_TRIS
    b = base[cube]
    verts, _ = triangles(corner_values(level, b), b.float())
    v = verts[torch.arange(num_points, device=dev), tri]  # [P, 3, 3]
    su = torch.sqrt(r[:, :1])
    pts = (1.0 - su) * v[:, 0] + (su * (1.0 - r[:, 1:])) * v[:, 1] + (su * r[:, 1:]) * v[:, 2]
    return torch.where(total > 0, pts, torch.zeros_like(pts))


def sample_dense(level, generator, num_points):
    """Points on the isosurface of every cube of ``level [S, S, S]``, cubes x-major."""
    n = level.shape[0] - 1
    i = torch.arange(n, device=level.device)
    base = torch.stack(torch.meshgrid(i, i, i, indexing="ij"), dim=-1).reshape(-1, 3)
    return draw(level, base, generator, num_points)


def sample_cells(level, cell_ids, generator, num_points, factor):
    """Points on the isosurface inside the coarse cells ``cell_ids [K]`` (flat
    ids of an ``(S - 1) / factor`` grid), cell by cell in that order and the
    cubes of a cell x-major."""
    nc = (level.shape[0] - 1) // factor
    ids = cell_ids.long()
    cell = torch.stack([ids // (nc * nc), (ids // nc) % nc, ids % nc], dim=-1)
    o = torch.arange(factor, device=level.device)
    local = torch.stack(torch.meshgrid(o, o, o, indexing="ij"), dim=-1).reshape(-1, 3)
    base = (cell[:, None, :] * factor + local[None]).reshape(-1, 3)
    return draw(level, base, generator, num_points)


def far_share(a, b, tol):
    """Share of the points of ``a [P, 3]`` farther than ``tol`` from the point
    of ``b`` at the same index (a point that is not finite is far)."""
    d = (a.float() - b.float()).norm(dim=-1)
    return float((~(d <= tol)).float().mean())


def to_world(pts, vox, rng):
    return pts / (vox + 1) * (rng[1] - rng[0]) + rng[0]

