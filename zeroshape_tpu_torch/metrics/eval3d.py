"""Occupancy-grid decode (counterpart of ``zeroshape_tpu/metrics/eval3d.py:32-280``).

``decode_fn`` maps points ``[B, T, 3]`` to logits ``[B, T]`` (a closure over
the latent caches). :func:`occupancy_grid_hierarchical` decodes a stride-4
coarse lattice, selects the coarse cells whose corners are not all
confidently on one side of 0.5, decodes those cells at full resolution,
and fills the rest from the owning cell's nearest coarse corner.
"""

from __future__ import annotations

import torch

from zeroshape_tpu_torch import resolve_device


def get_dense_3D_grid(vox_res, rng=(-1.5, 1.5), device=None):
    """``[(N+1)^3, 3]`` grid points, x-major (reference eval_3D.py:10-20)."""
    g = torch.linspace(rng[0], rng[1], vox_res + 1, device=resolve_device(device))
    X, Y, Z = torch.meshgrid(g, g, g, indexing="ij")
    return torch.stack([X, Y, Z], dim=-1).reshape(-1, 3)


def _decode_tiles(decode_fn, points, tile_points):
    """Logits ``[B, P]`` for per-sample points ``[B, P, 3]``, decoded
    ``tile_points`` at a time (the last tile is ragged, never padded)."""
    P = points.shape[1]
    tp = max(1, min(tile_points, P))
    return torch.cat([decode_fn(points[:, i : i + tp]) for i in range(0, P, tp)], dim=1)


def occupancy_grid(decode_fn, points, batch_size, tile_points=16641):
    """Sigmoid occupancies ``[B, P]`` of a flat point set ``[P, 3]`` shared by the batch."""
    pts = points[None].expand(batch_size, -1, -1)
    return torch.sigmoid(_decode_tiles(decode_fn, pts, tile_points))


def _upsample_nearest(level_c, factor):
    """``[Sc, Sc, Sc]`` -> ``[(Sc-1)*factor+1]^3`` nearest-lower-corner upsample.

    Fine index i takes coarse corner ``min(i // factor, Sc - 2)``: the owning
    cell's lower corner, and on the far boundary plane the last cell's near
    corner (the edge pad of eval3d.py:79-92).
    """
    n = level_c.shape[0] - 1
    idx = torch.clamp(torch.arange(n * factor + 1, device=level_c.device) // factor, max=n - 1)
    return level_c[idx][:, idx][:, :, idx]


def resolve_hier_capacity(vox_res, capacity=None, factor=4):
    """The refined-cell budget the hierarchical decode uses: None -> 1/8 of
    the coarse cells (4096 at vox 128), clamped to the cell count."""
    nc = vox_res // factor
    if capacity is None:
        capacity = max(256, nc**3 // 8)
    return max(1, min(capacity, nc**3))


def hier_decode_saves_work(vox_res, capacity=None, factor=4, tile_points=16641):
    """Whether the coarse-to-fine decode issues fewer decoded queries than
    the dense one, counting the tile padding each pays in the JAX package."""

    def tiled(P):
        tp = max(1, min(tile_points, P))
        return -(-P // tp) * tp

    cap = resolve_hier_capacity(vox_res, capacity, factor)
    nc = vox_res // factor
    hier_queries = tiled(cap * (factor + 1) ** 3) + tiled((nc + 1) ** 3)
    return hier_queries < (vox_res + 1) ** 3


def coarse_lattice(vox_res, rng=(-1.5, 1.5), factor=4, device=None):
    """``[(vox_res // factor + 1)^3, 3]`` points: every ``factor``-th point of
    the ``vox_res`` grid along each axis, x-major (the coarse pass's input)."""
    gc = torch.linspace(rng[0], rng[1], vox_res + 1, device=resolve_device(device))[::factor]
    return torch.stack(torch.meshgrid(gc, gc, gc, indexing="ij"), dim=-1).reshape(-1, 3)


def _select_active_cells(occ_c, margin, capacity):
    """Coarse cells that may contain the isosurface (eval3d.py:135-169).

    Active: the 8 corners are not all confidently on one side of 0.5.
    Overflow ranking: straddling cells first, then the cell whose closest
    corner is nearest 0.5, then the lower cell id.

    Returns (flat cell ids [capacity], valid [capacity], n_active []).
    """
    n = occ_c.shape[0] - 1
    corners = torch.stack(
        [occ_c[dx : dx + n, dy : dy + n, dz : dz + n] for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
    )
    cmin, cmax = corners.min(dim=0).values, corners.max(dim=0).values
    amin = (corners - 0.5).abs().min(dim=0).values
    active = (cmin < 0.5 + margin) & (cmax > 0.5 - margin)
    straddle = (cmin < 0.5) & (cmax >= 0.5)
    score = torch.where(active, straddle.float() - amin, torch.full_like(amin, float("-inf"))).reshape(-1)
    # stable sort: among tied scores the lower cell id wins, as in lax.top_k
    top, ids = torch.sort(score, descending=True, stable=True)
    return ids[:capacity], top[:capacity] > float("-inf"), active.sum()


def occupancy_grid_hierarchical(
    decode_fn,
    vox_res,
    rng=(-1.5, 1.5),
    batch_size=1,
    factor=4,
    capacity=None,
    margin=0.45,
    tile_points=16641,
    return_stats=False,
    return_cells=False,
    device=None,
):
    """Coarse-to-fine occupancy decode: ``[B, S, S, S]`` sigmoid, S = vox_res + 1.

    Args:
      decode_fn: points [B, T, 3] -> logits [B, T].
      capacity: max refined cells per sample (default 1/8 of the cells).
      return_stats: also return n_active [B], the demand before clamping;
        n_active > capacity means cells were dropped.
      return_cells: also return (cell_ids [B, K], valid [B, K]) for
        ``ops/marching_cubes.sample_surface_points_cells``.
    """
    if vox_res % factor:
        raise ValueError(f"vox_res {vox_res} is not a multiple of factor {factor}")
    dev = resolve_device(device)
    S = vox_res + 1
    nc = vox_res // factor
    Sc = nc + 1
    capacity = resolve_hier_capacity(vox_res, capacity, factor)

    g = torch.linspace(rng[0], rng[1], S, device=dev)
    coarse_pts = coarse_lattice(vox_res, rng, factor, dev)
    occ_c = occupancy_grid(decode_fn, coarse_pts, batch_size, tile_points).reshape(batch_size, Sc, Sc, Sc)

    sel = [_select_active_cells(o, margin, capacity) for o in occ_c]
    ids = torch.stack([s[0] for s in sel])  # [B, K]
    valid = torch.stack([s[1] for s in sel])
    n_active = torch.stack([s[2] for s in sel])

    # fine lattice of each selected cell: (factor+1)^3 points, sharing the
    # neighbours' boundary planes (duplicates write equal values)
    f1 = factor + 1
    off = torch.arange(f1, device=dev)
    cell = torch.stack([ids // (nc * nc), (ids // nc) % nc, ids % nc], dim=-1)  # [B, K, 3]
    fidx = cell[..., None, :] * factor + torch.stack(
        torch.meshgrid(off, off, off, indexing="ij"), dim=-1
    ).reshape(-1, 3)  # [B, K, f1^3, 3]
    ax, ay, az = (g[cell[..., i, None] * factor + off] for i in range(3))  # [B, K, f1]
    B, K = ax.shape[:2]
    shape = (B, K, f1, f1, f1)
    pts = torch.stack(
        [
            ax[:, :, :, None, None].expand(shape),
            ay[:, :, None, :, None].expand(shape),
            az[:, :, None, None, :].expand(shape),
        ],
        dim=-1,
    ).reshape(B, K * f1**3, 3)
    occ_f = torch.sigmoid(_decode_tiles(decode_fn, pts, tile_points))  # [B, K * f1^3]

    fill = torch.stack([_upsample_nearest(o, factor) for o in occ_c]).reshape(B, -1)
    # padding cells write to one extra trailing slot, dropped afterwards
    level = torch.cat([fill, fill.new_zeros(B, 1)], dim=1)
    flat = ((fidx[..., 0] * S + fidx[..., 1]) * S + fidx[..., 2]).reshape(B, -1)
    keep = valid[:, :, None].expand(B, K, f1**3).reshape(B, -1)
    level.scatter_(1, torch.where(keep, flat, S**3), occ_f.to(level.dtype))
    level = level[:, :-1].reshape(B, S, S, S)
    out = (level,)
    if return_stats:
        out = out + (n_active,)
    if return_cells:
        out = out + (ids, valid)
    return out if len(out) > 1 else level
