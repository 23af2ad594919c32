"""Marching-cubes surface sampling and mesh export.

Counterpart of ``zeroshape_tpu/ops/marching_cubes.py:36-401``. Evaluation
never needs the mesh, only ``num_points`` area-uniform samples of the
isosurface: compute every candidate triangle's area (zero for inactive
table slots), build the CDF, invert it at uniform draws, and rebuild only
the chosen triangles. Mesh export (:func:`marching_cubes_mesh`) is host
numpy. Vertices live in grid-index coordinates ``[0, S-1]`` (PyMCubes'
convention); callers rescale with ``verts / S * (max - min) + min``.

Random draws come from a ``torch.Generator``; tests may inject the uniforms
(``u_slots [P]``, ``r_bary [P, 2]``) so both packages see the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from zeroshape_tpu_torch.ops.mc_tables import CORNERS, EDGES, MAX_TRIS, TRI_TABLE

_CORNER_OFF = CORNERS.astype(np.int64)


def _case_index(corner_vals, isoval):
    """Case id in [0, 256): bit i set iff corner i is inside (>= isoval)."""
    bits = (corner_vals >= isoval).long()
    weights = torch.tensor([1 << i for i in range(8)], device=corner_vals.device)
    return (bits * weights).sum(dim=-1)


def _edge_vertices(corner_vals, base_idx, isoval):
    """Isosurface vertex on each of the 12 edges of each cube (valid where crossed).

    ``corner_vals [..., 8]``, ``base_idx [..., 3]`` (cube origins) ->
    ``[..., 12, 3]`` grid-index positions.
    """
    dev = corner_vals.device
    ea, eb = torch.from_numpy(EDGES[:, 0]).long().to(dev), torch.from_numpy(EDGES[:, 1]).long().to(dev)
    va, vb = corner_vals[..., ea], corner_vals[..., eb]
    denom = vb - va
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    t = torch.where(denom.abs() > 1e-12, (isoval - va) / safe, torch.full_like(denom, 0.5))
    t = t.clamp(0.0, 1.0)
    corners = torch.from_numpy(CORNERS).to(dev)
    pa = base_idx[..., None, :].float() + corners[ea]
    pb = base_idx[..., None, :].float() + corners[eb]
    return pa + t[..., None] * (pb - pa)


def _cube_triangles(corner_vals, base_idx, isoval):
    """All candidate triangles of the cubes: ([..., T, 3, 3] vertices, [..., T] valid)."""
    case = _case_index(corner_vals, isoval)
    everts = _edge_vertices(corner_vals, base_idx, isoval)  # [..., 12, 3]
    tri_edges = torch.from_numpy(TRI_TABLE).to(case.device).long()[case]  # [..., T, 3]
    valid = tri_edges[..., 0] >= 0
    idx = tri_edges.clamp(min=0).reshape(*case.shape, MAX_TRIS * 3, 1).expand(*case.shape, MAX_TRIS * 3, 3)
    verts = torch.gather(everts, -2, idx).reshape(*case.shape, MAX_TRIS, 3, 3)
    return verts, valid


def _corner_areas(vals, isoval):
    """Per-triangle areas ``[..., MAX_TRIS]`` (0 for inactive slots) from the
    8 corner-value arrays (CORNERS order) of any common shape. Areas are
    translation invariant, so vertices are taken relative to each cube."""
    corner_vals = torch.stack(vals, dim=-1)
    base = torch.zeros(corner_vals.shape[:-1] + (3,), device=corner_vals.device)
    tri, valid = _cube_triangles(corner_vals, base, isoval)
    cross = torch.linalg.cross(tri[..., 1, :] - tri[..., 0, :], tri[..., 2, :] - tri[..., 0, :])
    area = 0.5 * torch.sqrt((cross * cross).sum(dim=-1))
    return torch.where(valid, area, torch.zeros_like(area))


def _gather_corners(level, base_idx):
    """The 8 corner values ``[M, 8]`` of the cubes at integer origins ``base_idx [M, 3]``."""
    S = level.shape[0]
    off = torch.from_numpy(_CORNER_OFF).to(level.device)
    idx = base_idx[:, None, :].long() + off[None]
    return level.reshape(-1)[(idx[..., 0] * S + idx[..., 1]) * S + idx[..., 2]]


def triangle_areas(level, isoval=0.5, slab=8):
    """Areas of all candidate triangles of the dense grid, ``[n^3 * MAX_TRIS]``.

    The grid goes ``slab`` planes of cubes at a time along its first axis
    (the largest divisor of n not above ``slab``), which bounds the
    temporaries to one slab (``marching_cubes.py:187-204``).
    """
    n = level.shape[0] - 1
    slab = max(d for d in range(1, min(slab, n) + 1) if n % d == 0)
    areas = []
    for i0 in range(0, n, slab):
        vals = [
            level[i0 + dx : i0 + dx + slab, dy : dy + n, dz : dz + n] for dx, dy, dz in _CORNER_OFF.tolist()
        ]
        areas.append(_corner_areas(vals, isoval).reshape(-1))
    return torch.cat(areas)


_SCAN_ROW = 4096


def fixed_order_cumsum(x):
    """Inclusive cumsum of the 1-D ``x``, summed in float64 in an order that
    depends only on ``len(x)``, returned in ``x``'s dtype.

    On the card ``torch.cumsum`` of a 1-D tensor is a look-back scan whose
    float sums change from run to run, so one seed drew other surface points
    in two runs; a scan along the rows of a 2-D tensor has a fixed order.
    Rows of 4096 entries are scanned, then their totals, recursively (two
    rows at least: a single row would be a 1-D scan again).
    """
    n = x.shape[0]
    rows = max(2, -(-n // _SCAN_ROW))
    part = torch.nn.functional.pad(x.double(), (0, rows * _SCAN_ROW - n)).reshape(rows, _SCAN_ROW).cumsum(dim=1)
    if n > _SCAN_ROW:
        totals = fixed_order_cumsum(part[:, -1])
        part[1:] += totals[:-1, None]
    return part.reshape(-1)[:n].to(x.dtype)


def _draw_slots(cdf, u):
    """Inverse-CDF slot draw from uniforms ``u`` in [0, 1), kept STRICTLY below
    the total: at u == total, searchsorted would land on the trailing
    (usually inactive) slot; the (1 - 2^-22) factor and ``right=True``
    always land on a positive-area slot (marching_cubes.py:241-253)."""
    total = cdf[-1]
    u = u * (total * (1.0 - 2.0**-22))
    return torch.clamp(torch.searchsorted(cdf, u, right=True), max=cdf.shape[0] - 1)


def _sample_from_tris(level, base_idx, tri_ids, r, isoval):
    """One uniform point on each chosen triangle (sqrt-trick barycentrics,
    ``r [P, 2]`` uniforms); shared by the samplers."""
    tri_verts, _ = _cube_triangles(_gather_corners(level, base_idx), base_idx, isoval)
    tri = tri_verts[torch.arange(tri_ids.shape[0], device=tri_ids.device), tri_ids]  # [P, 3, 3]
    su = torch.sqrt(r[:, :1])
    b0 = 1.0 - su
    b1 = su * (1.0 - r[:, 1:])
    b2 = su * r[:, 1:]
    return b0 * tri[:, 0] + b1 * tri[:, 1] + b2 * tri[:, 2]


def sample_surface_points(level, generator=None, num_points=10000, isoval=0.5, u_slots=None, r_bary=None):
    """Area-uniform points on the isosurface of the dense grid ``level [S, S, S]``
    (``marching_cubes.py:207-238``): every cube's triangle areas in z-slabs,
    their CDF, inverse-CDF draws, and only the drawn triangles rebuilt.

    ``generator`` and the injected uniforms ``u_slots [num_points]``,
    ``r_bary [num_points, 2]`` are as for :func:`sample_surface_points_cells`.
    Returns ``[num_points, 3]`` in grid-index coordinates, zeros if the grid
    has no surface.
    """
    n = level.shape[0] - 1
    dev = level.device
    cdf = fixed_order_cumsum(triangle_areas(level, isoval))
    total = cdf[-1]
    if u_slots is None:
        u_slots = torch.rand(num_points, generator=generator, device=dev)
    if r_bary is None:
        r_bary = torch.rand(num_points, 2, generator=generator, device=dev)
    slots = _draw_slots(cdf, u_slots)
    cube = slots // MAX_TRIS
    base = torch.stack([cube // (n * n), (cube // n) % n, cube % n], dim=-1)
    pts = _sample_from_tris(level, base, slots % MAX_TRIS, r_bary, isoval)
    return torch.where(total > 0, pts, torch.zeros_like(pts))


def sample_surface_points_cells(
    level, cell_ids, cell_valid, generator=None, num_points=10000, isoval=0.5, factor=4,
    u_slots=None, r_bary=None,
):
    """Area-uniform isosurface samples restricted to the given coarse cells.

    Companion of ``metrics/eval3d.occupancy_grid_hierarchical``: only the
    active cells' cubes enter the area pass. The CDF is cell-major in the
    order of ``cell_ids``.

    Args:
      level: [S, S, S] sigmoid occupancies, S = nc * factor + 1.
      cell_ids: [K] flat coarse-cell ids (x-major over an nc^3 grid).
      cell_valid: [K] bool; padding entries contribute zero area.
      generator: ``torch.Generator`` on ``level``'s device for the draws.
      u_slots, r_bary: optional injected uniforms ``[num_points]`` and
        ``[num_points, 2]`` in [0, 1) instead of drawing them.
    Returns:
      [num_points, 3] points in grid-index coordinates (zeros if no surface).
    """
    S = level.shape[0]
    n = S - 1
    if n % factor:
        raise ValueError(f"grid size {S} does not fit factor {factor}")
    nc = n // factor
    f1 = factor + 1
    dev = level.device
    cell_ids = cell_ids.long()
    cell = torch.stack([cell_ids // (nc * nc), (cell_ids // nc) % nc, cell_ids % nc], dim=-1)
    base = cell * factor  # [K, 3]
    r = torch.arange(f1, device=dev)
    bx, by, bz = (base[:, i, None] + r for i in range(3))  # [K, f1]
    blocks = level[bx[:, :, None, None], by[:, None, :, None], bz[:, None, None, :]]
    vals = [
        blocks[:, dx : dx + factor, dy : dy + factor, dz : dz + factor]
        for dx, dy, dz in _CORNER_OFF.tolist()
    ]
    areas = _corner_areas(vals, isoval) * cell_valid[:, None, None, None, None]
    cdf = fixed_order_cumsum(areas.reshape(-1))
    total = cdf[-1]

    if u_slots is None:
        u_slots = torch.rand(num_points, generator=generator, device=dev)
    if r_bary is None:
        r_bary = torch.rand(num_points, 2, generator=generator, device=dev)
    slots = _draw_slots(cdf, u_slots)
    tri_ids = slots % MAX_TRIS
    cube_local = slots // MAX_TRIS  # index into [K, f, f, f]
    k_idx = cube_local // factor**3
    rem = cube_local % factor**3
    local = torch.stack([rem // (factor * factor), (rem // factor) % factor, rem % factor], dim=-1)
    pts = _sample_from_tris(level, base[k_idx] + local, tri_ids, r_bary, isoval)
    return torch.where(total > 0, pts, torch.zeros_like(pts))


def marching_cubes_mesh(level, isoval=0.5):
    """Host-side mesh extraction (numpy): returns (vertices [V, 3], faces [F, 3]).

    Triangles reference vertices by canonical global grid edge (lowest grid
    endpoint, axis), so welding is integer-exact and the mesh is watertight.
    """
    level = np.asarray(level)
    S = level.shape[0]
    n = S - 1
    base = np.stack(np.meshgrid(np.arange(n), np.arange(n), np.arange(n), indexing="ij"), -1).reshape(-1, 3)
    corner_vals = np.take(
        level.reshape(-1),
        (base[:, None, 0] + _CORNER_OFF[None, :, 0]) * S * S
        + (base[:, None, 1] + _CORNER_OFF[None, :, 1]) * S
        + (base[:, None, 2] + _CORNER_OFF[None, :, 2]),
    )  # [M, 8]
    case = ((corner_vals >= isoval) << np.arange(8)).sum(axis=1)
    tri_edges = TRI_TABLE[case]  # [M, T, 3] cube-local edge ids
    valid = tri_edges[..., 0] >= 0
    if not valid.any():
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    ca = CORNERS[EDGES[:, 0]].astype(np.int64)  # [12, 3]
    cb = CORNERS[EDGES[:, 1]].astype(np.int64)
    lo_corner = np.minimum(ca, cb)
    axis = np.argmax(np.abs(ca - cb), axis=1)
    cube_idx, tri_idx = np.nonzero(valid)
    e_local = tri_edges[cube_idx, tri_idx]  # [F, 3]
    b = base[cube_idx].astype(np.int64)
    lo = b[:, None, :] + lo_corner[e_local]  # [F, 3, 3]
    gid = ((lo[..., 0] * S + lo[..., 1]) * S + lo[..., 2]) * 3 + axis[e_local]

    uniq, inv = np.unique(gid.reshape(-1), return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)
    axis_u = (uniq % 3).astype(np.int64)
    q = uniq // 3
    lo_pt = np.stack([q // (S * S), (q // S) % S, q % S], axis=-1)
    hi_pt = lo_pt.copy()
    hi_pt[np.arange(len(uniq)), axis_u] += 1
    va = level[lo_pt[:, 0], lo_pt[:, 1], lo_pt[:, 2]]
    vb = level[hi_pt[:, 0], hi_pt[:, 1], hi_pt[:, 2]]
    denom = vb - va
    t = np.where(np.abs(denom) > 1e-12, (isoval - va) / np.where(denom == 0, 1, denom), 0.5)
    t = np.clip(t, 0.0, 1.0)
    verts = lo_pt.astype(np.float64) + t[:, None] * (hi_pt - lo_pt)
    good = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    return verts.astype(np.float32), faces[good]


def write_ply_mesh(fname, vertices, faces):
    """Binary little-endian PLY mesh (copy of ``zeroshape_tpu/vis.py:95``)."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    with open(fname, "wb") as f:
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(vertices)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        f.write(header.encode())
        f.write(vertices.astype("<f4").tobytes())
        face_block = np.empty(len(faces), dtype=[("n", "u1"), ("idx", "<i4", (3,))])
        face_block["n"] = 3
        face_block["idx"] = faces
        f.write(face_block.tobytes())
