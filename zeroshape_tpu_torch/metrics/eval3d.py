"""Occupancy-grid decode and 3D scoring (counterpart of ``zeroshape_tpu/metrics/eval3d.py``).

``decode_fn`` maps points ``[B, T, 3]`` to logits ``[B, T]`` (a closure over
the latent caches). :func:`occupancy_grid_hierarchical` decodes a stride-4
coarse lattice, selects the coarse cells whose corners are not all
confidently on one side of 0.5, decodes those cells at full resolution,
and fills the rest from the owning cell's nearest coarse corner.

Scoring (``eval3d.py:348-548``): :func:`chamfer_eval` and
:func:`compute_fscore` on normalised clouds, :func:`brute_force_batch`
(the reference's best-of-6912-rotations alignment, exhaustive or pruned
coarse-to-fine, for a batch in each kernel call; :func:`brute_force_search`
is its one-sample case), :func:`icp` and :func:`transform_gt_to_view`. The nearest
neighbours come from the K2/K3 kernels of ``ops/chamfer.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from zeroshape_tpu_torch import resolve_device
from zeroshape_tpu_torch.camera import get_rotation_sphere
from zeroshape_tpu_torch.ops.chamfer import chamfer_distance, nn_min_squared_fast, nn_one_way
from zeroshape_tpu_torch.ops.image import resize_bilinear_separable
from zeroshape_tpu_torch.vis import show_att_on_image

DEFAULT_F_THRESHOLDS = (0.005, 0.01, 0.02, 0.05, 0.1, 0.2)
ROT_BATCH = 48  # rotations per exact brute-force batch; the coarse stage takes 4x


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
    """``[..., Sc, Sc, Sc]`` -> ``[..., S, S, S]``, S = (Sc-1)*factor+1:
    nearest-lower-corner upsample of each grid of the batch at once (the
    JAX ``vmap``, eval3d.py:264-265).

    Fine index i takes coarse corner ``min(i // factor, Sc - 2)``: the owning
    cell's lower corner, and on the far boundary plane the last cell's near
    corner (the edge pad of eval3d.py:79-92).
    """
    n = level_c.shape[-1] - 1
    idx = torch.clamp(torch.arange(n * factor + 1, device=level_c.device) // factor, max=n - 1)
    return level_c[..., idx, :, :][..., idx, :][..., idx]


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
    """Coarse cells that may contain the isosurface (eval3d.py:135-169), for
    each coarse grid ``occ_c [..., Sc, Sc, Sc]`` of a batch at once (the JAX
    ``vmap``, eval3d.py:225-227) or for one grid.

    Active: the 8 corners are not all confidently on one side of 0.5.
    Overflow ranking: straddling cells first, then the cell whose closest
    corner is nearest 0.5, then the lower cell id. Every step is exact
    (comparisons and a sort), so a grid's cells do not depend on the batch.

    Returns (flat cell ids [..., capacity], valid [..., capacity], n_active [...]).
    """
    n = occ_c.shape[-1] - 1
    corners = torch.stack([occ_c[..., dx : dx + n, dy : dy + n, dz : dz + n]
                           for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)])
    cmin, cmax = corners.min(dim=0).values, corners.max(dim=0).values
    amin = (corners - 0.5).abs().min(dim=0).values
    active = (cmin < 0.5 + margin) & (cmax > 0.5 - margin)
    straddle = (cmin < 0.5) & (cmax >= 0.5)
    score = torch.where(active, straddle.float() - amin, torch.full_like(amin, float("-inf"))).flatten(-3)
    # stable sort along each grid's cells: among tied scores the lower cell id wins, as in lax.top_k
    top, ids = torch.sort(score, dim=-1, descending=True, stable=True)
    return ids[..., :capacity], top[..., :capacity] > float("-inf"), active.sum(dim=(-3, -2, -1))


def _fine_points(ids, g, nc, factor):
    """The fine lattice of each selected cell: (factor+1)^3 points, sharing
    the neighbours' boundary planes (duplicates write equal values).
    ``ids [B, K]`` flat cell ids of an ``nc^3`` grid, ``g`` the fine axis.
    Returns points ``[B, K * (factor+1)^3, 3]`` and their fine-grid indices
    ``[B, K, (factor+1)^3, 3]``."""
    f1 = factor + 1
    off = torch.arange(f1, device=ids.device)
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
    return pts, fidx


def _scatter_fine(occ_c, fidx, valid, occ_f, factor):
    """The level grid ``[B, S, S, S]``: the coarse grid ``occ_c [B, Sc, Sc,
    Sc]`` upsampled (nearest), the valid cells' fine values ``occ_f [B,
    K * (factor+1)^3]`` written over it at ``fidx``."""
    B, K = fidx.shape[:2]
    S = (occ_c.shape[1] - 1) * factor + 1
    fill = _upsample_nearest(occ_c, factor).reshape(B, -1)
    # padding cells write to one extra trailing slot, dropped afterwards
    level = torch.cat([fill, fill.new_zeros(B, 1)], dim=1)
    flat = ((fidx[..., 0] * S + fidx[..., 1]) * S + fidx[..., 2]).reshape(B, -1)
    keep = valid[:, :, None].expand(B, K, fidx.shape[2]).reshape(B, -1)
    level.scatter_(1, torch.where(keep, flat, S**3), occ_f.to(level.dtype))
    return level[:, :-1].reshape(B, S, S, S)


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

    ids, valid, n_active = _select_active_cells(occ_c, margin, capacity)  # [B, K], [B, K], [B]

    pts, fidx = _fine_points(ids, g, nc, factor)
    occ_f = torch.sigmoid(_decode_tiles(decode_fn, pts, tile_points))  # [B, K * f1^3]
    level = _scatter_fine(occ_c, fidx, valid, occ_f, factor)
    out = (level,)
    if return_stats:
        out = out + (n_active,)
    if return_cells:
        out = out + (ids, valid)
    return out if len(out) > 1 else level


def occupancy_grid_with_attn(decode_fn, points, batch_size, vox_res, slices=1):
    """The dense grid decode that also z-averages the decoder's attention
    (``eval3d.py:283-308``; reference eval_3D.py:50-52).

    ``decode_fn`` maps points ``[B, T, 3]`` to ``(logits [B, T], attn [B, T, L])``;
    ``points`` is the x-major ``[(N+1)^3, 3]`` grid (:func:`get_dense_3D_grid`).
    A tile of ``slices`` x-slices of ``S^2`` points is decoded at a time and
    its attention averaged over z at once, so the whole ``[B, S^3, L]``
    attention is never held. Returns ``(occ [B, S^3] sigmoid, attn_xy
    [B, S, S, L] fp32)``, ``attn_xy[b, x, y]`` averaged over z.
    """
    S = vox_res + 1
    occ, attn_xy = [], []
    for x0 in range(0, S, slices):
        n = min(slices, S - x0)
        tile = points[x0 * S * S : (x0 + n) * S * S]
        logits, attn = decode_fn(tile[None].expand(batch_size, -1, -1))
        occ.append(logits)
        attn_xy.append(attn.float().reshape(batch_size, n, S, S, -1).mean(dim=3))
    return torch.sigmoid(torch.cat(occ, dim=1)), torch.cat(attn_xy, dim=1)


def attention_frames(attn_xy, image, vox_res, feat_res, n_global=1):
    """The serpentine sweep of attention overlays (``eval3d.py:311-338``;
    reference eval_3D.py:60-80).

    ``attn_xy [S, S, n_global + feat_res^2]`` is one sample's z-averaged
    attention, ``image [H, W, 3]`` its float RGB in [0, 1]. Every 8th row of
    the grid's y, the columns of x in steps of 8, left to right on rows
    divisible by 16 and back on the others: each map (the global tokens'
    sum added to every patch) resized to the image bilinearly
    (``align_corners=False``, ``ops.image.resize_bilinear_separable``),
    divided by its maximum and laid over the image (``vis.show_att_on_image``). Returns a list of ``[H, W, 3]`` float32
    frames.
    """
    image = np.asarray(image, np.float32)
    H, W = image.shape[:2]
    N = vox_res
    attn_xy = torch.as_tensor(np.asarray(attn_xy, np.float32))
    S = attn_xy.shape[0]
    attn_global = attn_xy[..., :n_global].sum(-1, keepdim=True)
    attn_vis = attn_global[..., None] + attn_xy[..., n_global:].reshape(S, S, feat_res, feat_res)
    cells = []
    for row in range(0, N, 8):
        cols = range(0, N // 8 * 8 + 1, 8) if row % 16 == 0 else range(N // 8 * 8, -1, -8)
        cells += [(col, row) for col in cols]  # x is the column
    if not cells:
        return []
    maps = resize_bilinear_separable(torch.stack([attn_vis[c, r] for c, r in cells]), (H, W)).numpy()
    frames = []
    for cur in maps:
        cur = cur / max(cur.max(), 1e-12)
        frames.append(show_att_on_image(image, cur))
    return frames


# ---------------------------------------------------------------------------
# scoring (eval3d.py:348-548)
# ---------------------------------------------------------------------------


def normalize_pc(pc):
    """Centre ``pc [B, N, 3]`` on its mean and scale by its largest xy extent
    (reference eval_3D.py:93-102), through :func:`_normalize_planes`. An
    all-zero cloud stays zero."""
    if pc.dim() != 3:
        raise ValueError(f"expected [B, N, 3], got {tuple(pc.shape)}")
    return _normalize_planes(_planar(pc)).transpose(-1, -2).contiguous()


def compute_fscore(dist1, dist2, thresholds=DEFAULT_F_THRESHOLDS):
    """F-score ``[B, len(thresholds)]`` of the NN distances; 0 where precision
    and recall are both 0 (reference eval_3D.py:215-231)."""
    scores = []
    for t in thresholds:
        precision = (dist1 < t).float().mean(dim=1)
        recall = (dist2 < t).float().mean(dim=1)
        denom = precision + recall
        f = 2 * precision * recall / torch.clamp(denom, min=1e-12)
        scores.append(torch.where(denom > 0, f, torch.zeros_like(f)))
    return torch.stack(scores, dim=1)


def chamfer_eval(pc_pred, pc_gt):
    """(acc ``[B, N]``, comp ``[B, M]``): sqrt NN distances pred -> gt and gt -> pred."""
    d1, d2, _, _ = chamfer_distance(pc_pred, pc_gt)
    return d1, d2


def _planar(pc):
    """Clouds ``[..., P, 3]`` -> their coordinate planes ``[..., 3, P]``."""
    return pc.transpose(-1, -2).contiguous()


def _rows(planes):
    """Coordinate planes ``[..., 3, P]`` -> the kernels' clouds ``[N, P, 3]``."""
    return planes.transpose(-1, -2).reshape(-1, planes.shape[-1], 3)


def _rotate_planes(R, planes):
    """``R [B or 1, r, 3, 3]`` applied to each sample's planes ``[B, 3, P]``
    -> ``[B, r, 3, P]``: coordinate i is ``(R_i0 x + R_i1 y) + R_i2 z``,
    elementwise in that order, so a sample's result does not depend on the
    batch it is in (a matrix product's order may depend on its shape)."""
    prod = planes[:, None, None] * R[..., None]  # [B, r, 3, 3, P]
    return prod[..., 0, :] + prod[..., 1, :] + prod[..., 2, :]


def _normalize_planes(c):
    """The normalisation of :func:`normalize_pc` on planar clouds ``[..., 3,
    P]`` (``(x - mean) / (max xy extent + 1e-7)``): each mean and
    extent is a reduction along the contiguous last axis, one row a cloud and
    coordinate, whose order does not depend on how many rows the call has
    (along a strided axis the CPU sums some rows in vector lanes and the rest
    apart, depending on the count)."""
    c = c - c.mean(dim=-1, keepdim=True)
    extent = lambda i: c[..., i, :].amax(dim=-1) - c[..., i, :].amin(dim=-1)  # noqa: E731
    return c / (torch.maximum(extent(0), extent(1))[..., None, None] + 1e-7)


def _normalize_each(planes):
    """:func:`_normalize_planes` of each sample's ``[3, P]`` planes alone:
    a reduction over few rows may be laid out by their count on the card, so
    the per-sample clouds (one row a coordinate) are normalised one sample a
    call, as the one-sample search does."""
    return torch.cat([_normalize_planes(c[None]) for c in planes])


def _pad_rotations(R, multiple):
    """Pad ``R [..., n, 3, 3]`` with copies of its first rotation to a multiple of ``multiple``."""
    n = R.shape[-3]
    pad = -(-n // multiple) * multiple - n
    return torch.cat([R, R[..., :1, :, :].expand(*R.shape[:-3], pad, 3, 3)], dim=-3)


def _per_row(clouds, r):
    """Each sample's cloud ``[B, M, 3]`` repeated for its ``r`` rotations:
    ``[B * r, M, 3]``, read in place (batch stride 0) for one sample and
    copied once for a batch (the kernels take one batch stride)."""
    B, M = clouds.shape[:2]
    return clouds[:, None].expand(B, r, M, 3).reshape(B * r, M, 3)


def brute_force_batch(
    pc_pred,
    pc_gt,
    thresholds=DEFAULT_F_THRESHOLDS,
    rot_samples=(24, 24, 12),
    prune=(1024, 128),
    fast_coarse=True,
    rot_batch=ROT_BATCH,
):
    """Best-of-rotations alignment of each sample of ``pc_pred [B, P, 3]``
    against ``pc_gt [B, G, 3]``, the whole batch in each kernel call
    (``make_brute_force_batch``, ``eval3d.py:485-519``, a ``vmap`` of
    ``brute_force_search_impl`` ``:376-474``, without a mesh: ranks stand in
    for it, ``parallel/dist.py``).

    Every rotation of the sphere is applied to each predicted cloud, both
    clouds are normalised, and the rotation with the least CD wins. With
    ``prune = (m, K)`` the search is coarse-to-fine: every rotation is first
    scored on an m-point subsample of both clouds (a prefix of the i.i.d.
    predicted cloud, an evenly strided gather of the GT cloud), through K3
    when ``fast_coarse`` and else through K2, and each sample's best K
    (a stable top-K of its own scores) are rescored with the exact
    full-cloud Chamfer (K2). ``prune=None`` is the exhaustive reference
    protocol. The reported metrics always come from the exact pass.

    Rotations go ``rot_batch`` (default :data:`ROT_BATCH`) at a time through
    the exact pass and ``4 * rot_batch`` at a time through the coarse one,
    padded with the first rotation; a chunk is one K3 call in each direction
    (``B * 4 * rot_batch`` rows) or one K2 call in each direction (``B *
    rot_batch`` rows) for the whole batch, each sample's GT cloud repeated
    for its rows (:func:`_per_row`). The result does not depend on
    ``rot_batch``, and a sample's result is bit for bit that of the search
    on it alone (:func:`brute_force_search`): the kernels' rows are
    independent of their batch index, and every other step is elementwise,
    a reduction along a row, or done one sample at a time.

    Returns a dict of per-sample results stacked along the batch axis:
    ``acc [B]``, ``comp [B]``, ``f_score [B, n_thr]``, ``pc_pred [B, P, 3]``
    (rotated and normalised), ``pc_gt [B, G, 3]`` (normalised) and
    ``rotation [B, 3, 3]``.
    """
    dev = pc_pred.device
    B = pc_pred.shape[0]
    rotations = get_rotation_sphere(*rot_samples, device=dev)
    n_rot = rotations.shape[0]
    pred_planes = _planar(pc_pred)
    gt_n = _rows(_normalize_each(_planar(pc_gt))).reshape(pc_gt.shape)

    if prune is not None and prune[1] < n_rot:
        m, K = prune
        m = min(m, pc_pred.shape[1], pc_gt.shape[1])
        pred_sub = pred_planes[..., :m]
        gt_idx = np.round(np.linspace(0, pc_gt.shape[1] - 1, m)).astype(np.int64)
        gt_sub = _rows(_normalize_each(_planar(pc_gt[:, torch.as_tensor(gt_idx, device=dev)]))).reshape(B, m, 3)
        cb = min(rot_batch * 4, n_rot)
        gt_rep = _per_row(gt_sub, cb)
        cd_coarse = []
        for R in _pad_rotations(rotations, cb).split(cb):
            rot = _rows(_normalize_planes(_rotate_planes(R[None], pred_sub)))  # [B * cb, m, 3]
            if fast_coarse:
                acc_d = torch.sqrt(nn_min_squared_fast(rot, gt_rep))
                comp_d = torch.sqrt(nn_min_squared_fast(gt_rep, rot))
            else:
                acc_d, comp_d = chamfer_eval(rot, gt_rep)
            cd_coarse.append(((acc_d.mean(dim=1) + comp_d.mean(dim=1)) / 2.0).reshape(B, cb))
        cd_coarse = torch.cat(cd_coarse, dim=1)[:, :n_rot]
        # lax.top_k(-cd, K) of each sample: a stable descending sort, so the lower index wins a tie
        top = torch.sort(-cd_coarse, dim=1, descending=True, stable=True).indices[:, :K]
        candidates = rotations[top]  # [B, K, 3, 3]
    else:
        candidates = rotations.expand(B, n_rot, 3, 3)

    n_cand = candidates.shape[1]
    rb = min(rot_batch, n_cand)
    cand_p = _pad_rotations(candidates, rb)
    gt_rep = _per_row(gt_n, rb)
    accs, comps, fs = [], [], []
    for R in cand_p.split(rb, dim=1):
        acc_d, comp_d = chamfer_eval(_rows(_normalize_planes(_rotate_planes(R, pred_planes))), gt_rep)
        accs.append(acc_d.mean(dim=1).reshape(B, rb))
        comps.append(comp_d.mean(dim=1).reshape(B, rb))
        fs.append(compute_fscore(acc_d, comp_d, thresholds).reshape(B, rb, -1))
    accs, comps = torch.cat(accs, dim=1)[:, :n_cand], torch.cat(comps, dim=1)[:, :n_cand]
    fs = torch.cat(fs, dim=1)[:, :n_cand]
    best = torch.argmin((accs + comps) / 2.0, dim=1)  # the first index on ties, as jnp.argmin
    pick = torch.arange(B, device=dev)
    R_best = cand_p[pick, best]
    pred_best = _rotate_planes(R_best[:, None], pred_planes)[:, 0]
    return {
        "acc": accs[pick, best],
        "comp": comps[pick, best],
        "f_score": fs[pick, best],
        "pc_pred": _rows(_normalize_each(pred_best)).reshape(pc_pred.shape),
        "pc_gt": gt_n,
        "rotation": R_best,
    }


def brute_force_search(pc_pred, pc_gt, **kw):
    """Best-of-rotations alignment of one sample (``eval3d.py:376-474``):
    :func:`brute_force_batch` of the batch of one, ``pc_pred [P, 3]``,
    ``pc_gt [G, 3]``, and the same keywords. Returns a dict: ``acc``,
    ``comp``, ``f_score [n_thr]``, ``pc_pred [P, 3]`` (rotated and
    normalised), ``pc_gt`` (normalised) and ``rotation [3, 3]``."""
    return {k: v[0] for k, v in brute_force_batch(pc_pred[None], pc_gt[None], **kw).items()}


def icp(X1, X2, num_iter=50):
    """SVD ICP aligning ``X1 [B, N, 3]`` onto ``X2 [B, M, 3]`` (eval_3D.py:271-284).

    Each step matches every point of X1 to its nearest point of X2 (K2) and
    applies the Kabsch rotation of the matched pairs, its determinant fixed
    to +1 by flipping V's last column.
    """
    for _ in range(num_iter):
        _, idx = nn_one_way(X1, X2)
        X2c = torch.gather(X2, 1, idx[..., None].expand(-1, -1, 3))
        t1, t2 = X1.mean(dim=-2, keepdim=True), X2c.mean(dim=-2, keepdim=True)
        H = torch.einsum("bni,bnj->bij", X1 - t1, X2c - t2)
        U, _, Vt = torch.linalg.svd(H)
        V = Vt.transpose(-1, -2)
        det = torch.linalg.det(torch.einsum("bij,bkj->bik", V, U))
        sign = torch.where(det < 0, -1.0, 1.0)
        V = torch.cat([V[:, :, :2], V[:, :, 2:] * sign[:, None, None]], dim=-1)
        R = torch.einsum("bij,bkj->bik", V, U)
        X1 = (X1 - t1) @ R.transpose(-1, -2) + t2
    return X1


def transform_gt_to_view(dpc_points, pose_gt, flip_xy=False):
    """GT cloud ``[B, N, 3]`` -> the view frame of ``pose_gt [B, 3, 4]``
    (eval_3D.py:120-123, 187-190); ``flip_xy`` negates x and y (Pix3D)."""
    pts = dpc_points @ pose_gt[..., :3].transpose(-1, -2)
    if flip_xy:
        pts = pts * torch.tensor([-1.0, -1.0, 1.0], device=pts.device)
    return pts
