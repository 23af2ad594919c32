"""Plain scoring by the published protocol (``eval_3D.py``): the rotation
sphere, the normalisation, nearest-neighbour distances in float32 blocks
(the nearest few found by the product expansion, their distances taken again
from coordinate differences), the F-scores, and a best-of-rotations search.

The search is held against the program's, not copied from it: every
rotation of the sphere is scored on a prefix of the predicted cloud and an
even subsample of the GT (float32 ``cdist``), and the ``top`` best of that
pass, with any rotations the caller adds, are scored on the full clouds.
Its least Chamfer distance is one that an exhaustive search over the
sphere can only match or beat.
"""

import numpy as np
import torch

CHUNK = 2048  # rows of a nearest-neighbour block
NEAREST = 4  # candidates a point whose distances are taken again from differences
ROT_CHUNK = 64  # rotations a block of the search
R_PERMUTE = ((-1.0, 0.0, 0.0), (0.0, 0.0, -1.0), (0.0, -1.0, 0.0))  # reference camera.py:223-227


def _stack(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotation_sphere(azim, elev, roll, device):
    """``[azim * elev * roll, 3, 3]``: ``Rz(roll) Rx(elev) Ry(azim) R_PERMUTE``
    over even angles, azimuth-major, then elevation, then roll."""
    grid = [np.linspace(0.0, 360.0, num=n, endpoint=False) for n in (azim, elev, roll)]
    a, e, r = (torch.deg2rad(torch.as_tensor(x.reshape(-1), dtype=torch.float32, device=device))
               for x in np.meshgrid(*grid, indexing="ij"))
    z, o = torch.zeros_like(a), torch.ones_like(a)
    ry = _stack([[a.cos(), z, a.sin()], [z, o, z], [-a.sin(), z, a.cos()]])
    rx = _stack([[o, z, z], [z, e.cos(), -e.sin()], [z, e.sin(), e.cos()]])
    rz = _stack([[r.cos(), r.sin(), z], [-r.sin(), r.cos(), z], [z, z, o]])
    return rz @ rx @ ry @ torch.tensor(R_PERMUTE, device=device)


def normalize(pc):
    """Centre each cloud ``[..., P, 3]`` on its mean and scale it by its
    largest xy extent (reference ``eval_3D.py:93-102``)."""
    c = pc - pc.mean(dim=-2, keepdim=True)
    ext = torch.maximum(c[..., 0].amax(-1) - c[..., 0].amin(-1), c[..., 1].amax(-1) - c[..., 1].amin(-1))
    return c / (ext[..., None, None] + 1e-7)


def nn_dist(a, b):
    """Distance from each point of ``a [N, 3]`` to its nearest point of ``b
    [M, 3]``. ``cdist``'s product expansion ``|a|^2 + |b|^2 - 2ab`` finds the
    ``NEAREST`` candidates; their distances are taken again from the
    coordinate differences, which the expansion rounds away near 0."""
    out = []
    for i in range(0, a.shape[0], CHUNK):
        x = a[i: i + CHUNK]
        idx = torch.cdist(x, b).topk(min(NEAREST, b.shape[0]), dim=1, largest=False).indices
        out.append((x[:, None, :] - b[idx]).norm(dim=-1).min(dim=1).values)
    return torch.cat(out)


def chamfer(pred, gt):
    """``(acc, comp)`` mean distances and the per-point distances of both directions."""
    acc_d, comp_d = nn_dist(pred, gt), nn_dist(gt, pred)
    return acc_d.mean(), comp_d.mean(), acc_d, comp_d


def fscore(acc_d, comp_d, thresholds):
    out = []
    for t in thresholds:
        p, r = (acc_d < t).float().mean(), (comp_d < t).float().mean()
        out.append(2 * p * r / (p + r) if p + r > 0 else torch.zeros_like(p))
    return torch.stack(out)


def rotated(pw, rotations):
    """``normalize(pw @ R^T)`` for each rotation: ``[r, P, 3]``."""
    return normalize(torch.einsum("pj,rij->rpi", pw, rotations))


def closest_rotation(pw, cloud, rotations):
    """The index of the rotation that brings ``normalize(R pw)`` nearest to
    ``cloud [P, 3]`` (mean squared distance), and that rotated cloud."""
    best, best_d = None, float("inf")
    for i in range(0, rotations.shape[0], ROT_CHUNK):
        d = (rotated(pw, rotations[i: i + ROT_CHUNK]) - cloud).square().sum(-1).mean(-1)
        j = int(d.argmin())
        if float(d[j]) < best_d:
            best, best_d = i + j, float(d[j])
    return best, rotated(pw, rotations[best: best + 1])[0]


def least_cd(pw, gt_n, rotations, top=32, prefix=1024, extra=()):
    """The least CD ``(acc + comp) / 2`` that the reference finds over
    ``rotations`` for the predicted cloud ``pw [P, 3]`` against the
    normalised GT ``gt_n [G, 3]``, and the rotation's index."""
    m = min(prefix, pw.shape[0], gt_n.shape[0])
    g_sub = gt_n[torch.as_tensor(np.round(np.linspace(0, gt_n.shape[0] - 1, m)).astype(np.int64), device=gt_n.device)]
    coarse = []
    for i in range(0, rotations.shape[0], ROT_CHUNK):
        sub = rotated(pw, rotations[i: i + ROT_CHUNK])[:, :m]
        d = torch.cdist(sub, g_sub[None].expand(sub.shape[0], m, 3))  # a ranking: the expansion will do
        coarse.append((d.min(dim=2).values.mean(-1) + d.min(dim=1).values.mean(-1)) / 2)
    coarse = torch.cat(coarse)
    cand = sorted(set(torch.argsort(coarse)[:top].tolist()) | {int(i) for i in extra})
    cds = {}
    for i in cand:
        acc, comp, _, _ = chamfer(rotated(pw, rotations[i: i + 1])[0], gt_n)
        cds[i] = float((acc + comp) / 2)
    best = min(cds, key=cds.get)
    return cds[best], best
