"""Plain reconstruction arithmetic: the grid's points, the coarse-to-fine
cell selection, the random field's calibration, and decodes in blocks.

The grid convention is the reference's (``eval_3D.py:10-20``): ``vox + 1``
points an axis over ``rng``, x-major. The coarse pass takes every
``factor``-th point an axis; a coarse cell is active when its 8 corners are
not all confidently on one side of 0.5 (within ``0.5 +- margin``), and when
more cells are active than the capacity holds, straddling cells come first,
then the cell whose closest corner is nearest 0.5, then the lower cell id.
"""

import torch

DECODE_BLOCK = 1 << 16  # points a decode call of the reference


def axis(vox, rng, device):
    return torch.linspace(rng[0], rng[1], vox + 1, device=device)


def lattice(vox, rng, factor, device):
    """``[(vox // factor + 1)^3, 3]`` coarse points, x-major."""
    g = axis(vox, rng, device)[::factor]
    return torch.stack(torch.meshgrid(g, g, g, indexing="ij"), dim=-1).reshape(-1, 3)


def dense_grid(vox, rng, device):
    g = axis(vox, rng, device)
    return torch.stack(torch.meshgrid(g, g, g, indexing="ij"), dim=-1).reshape(-1, 3)


def select_cells(occ_c, margin, capacity):
    """Active cells of one coarse grid ``occ_c [Sc, Sc, Sc]``: ``(ids [K],
    n_active)`` with ``K = min(n_active, capacity)`` in the ranking order
    (the score ``straddle - nearest`` in float32, ties to the lower id)."""
    n = occ_c.shape[-1] - 1
    corners = torch.stack([occ_c[dx: dx + n, dy: dy + n, dz: dz + n]
                           for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)])
    cmin, cmax = corners.min(dim=0).values, corners.max(dim=0).values
    nearest = (corners - 0.5).abs().min(dim=0).values
    active = (cmin < 0.5 + margin) & (cmax > 0.5 - margin)
    straddle = (cmin < 0.5) & (cmax >= 0.5)
    score = torch.where(active, straddle.float() - nearest, torch.full_like(nearest, float("-inf"))).flatten()
    n_active = int(active.sum())
    ids = torch.sort(score, descending=True, stable=True).indices[: min(n_active, capacity)]
    return ids, n_active


def cell_points(ids, vox, rng, factor):
    """The fine points of coarse cells ``ids``: ``(points [K (f+1)^3, 3],
    flat grid indices [K (f+1)^3])``."""
    nc, S = vox // factor, vox + 1
    off = torch.arange(factor + 1, device=ids.device)
    cell = torch.stack([ids // (nc * nc), (ids // nc) % nc, ids % nc], dim=-1)
    o = torch.stack(torch.meshgrid(off, off, off, indexing="ij"), dim=-1).reshape(-1, 3)
    idx = (cell[:, None, :] * factor + o[None]).reshape(-1, 3)
    g = axis(vox, rng, ids.device)
    return g[idx], (idx[:, 0] * S + idx[:, 1]) * S + idx[:, 2]


def decode(graph, kvs, points):
    """Raw decoder logits ``[P]`` of one sample's ``points [P, 3]``, in blocks."""
    if points.shape[0] == 0:
        return points.new_zeros(0)
    return torch.cat([graph.impl_network.decode(kvs, points[None, i: i + DECODE_BLOCK])[0]
                      for i in range(0, points.shape[0], DECODE_BLOCK)])


def sample_kvs(kvs, b):
    return [(k[b: b + 1], v[b: b + 1]) for k, v in kvs]


@torch.no_grad()
def calibrate(graph, rgb, mask, sharpen, vox, rng, factor, margin, target, inside):
    """Set the random decoder's output layer so that this image's field looks
    like a trained one on the coarse lattice: its zero level encloses the top
    ``inside`` share of the lattice points, and the least power-of-two gain
    of 1 .. 2^12 brings the active cells to at most ``target``. Returns
    ``(shift, gain, n_active)`` and changes ``graph`` in place."""
    _, _, latent = graph.encode_image(rgb, mask)
    kvs = graph.impl_network.encode(latent)
    logits = decode(graph, sample_kvs(kvs, 0), lattice(vox, rng, factor, rgb.device))
    n = vox // factor + 1
    shift = float(torch.quantile(logits, 1.0 - inside))
    for gain in (2.0 ** k for k in range(13)):
        occ = torch.sigmoid(sharpen * gain * (logits - shift)).reshape(n, n, n)
        count = select_cells(occ, margin, 1)[1]
        if count <= target:
            break
    out = graph.impl_network.impl_mlp.layers[-1]
    out.weight.mul_(gain)
    out.bias.sub_(shift).mul_(gain)
    return shift, gain, count
