"""Analytic-SDF scenes with exact ground truth (numpy only), on disk or in memory.

A copy of ``zeroshape_tpu/data/analytic.py`` (SDF primitives, ``make_sdf``,
``_normals``, ``look_at_pose``, ``render_scene``, ``surface_points``,
``sdf_samples``, ``_camera_ring``, ``generate_dataset`` with its held-out
objects) and of ``data/common.py:pose_from_Rt``. :func:`generate_dataset`
writes the tree that ``data.synthetic`` reads. Without files,
:func:`eval_samples` gives the samples that tree's
``SyntheticDataset(split="test")`` would load, and :func:`train_samples`
the training split with its loader order and per-epoch SDF subsets
(``SyntheticDataset(split="train")`` and ``data/base.py:DataLoader``).

Conventions: the object is centred at the origin with radius <= ~0.5; the
camera is OpenCV-style (x right, y down, z forward) and ``pose`` is the
world->camera ``[R|t]``; depth maps hold z-depth at integer pixel coordinates.
"""

from __future__ import annotations

import os

import numpy as np

from zeroshape_tpu_torch.data import base
from zeroshape_tpu_torch.data.common import write_png

SDF_KINDS = ("sphere", "box", "torus", "capsule", "box_sphere")
VAL_CAP = 10  # test images per category (data/synthetic.py:39-41)


def _sdf_sphere(p, r):
    return np.linalg.norm(p, axis=-1) - r


def _sdf_box(p, half, round_r=0.02):
    q = np.abs(p) - (np.asarray(half) - round_r)
    outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
    inside = np.minimum(np.max(q, axis=-1), 0.0)
    return outside + inside - round_r


def _sdf_torus(p, R, r):
    q = np.stack([np.linalg.norm(p[..., [0, 2]], axis=-1) - R, p[..., 1]], axis=-1)
    return np.linalg.norm(q, axis=-1) - r


def _sdf_capsule(p, a, b, r):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    pa, ba = p - a, b - a
    h = np.clip((pa @ ba) / (ba @ ba), 0.0, 1.0)
    return np.linalg.norm(pa - h[..., None] * ba, axis=-1) - r


def make_sdf(kind, rng=None):
    """An SDF callable and an albedo for one of :data:`SDF_KINDS`; with
    ``rng`` the shape parameters are jittered."""
    u = (lambda lo, hi: float(rng.uniform(lo, hi))) if rng is not None else (lambda lo, hi: 0.5 * (lo + hi))
    if kind == "sphere":
        r = u(0.3, 0.45)
        sdf = lambda p: _sdf_sphere(p, r)  # noqa: E731
        albedo = (0.9, 0.3, 0.25)
    elif kind == "box":
        half = (u(0.2, 0.42), u(0.2, 0.42), u(0.2, 0.42))
        sdf = lambda p: _sdf_box(p, half)  # noqa: E731
        albedo = (0.25, 0.55, 0.9)
    elif kind == "torus":
        R, r = u(0.26, 0.36), u(0.1, 0.16)
        sdf = lambda p: _sdf_torus(p, R, r)  # noqa: E731
        albedo = (0.3, 0.85, 0.4)
    elif kind == "capsule":
        h, r = u(0.18, 0.3), u(0.12, 0.2)
        a, b = (0.0, -h, 0.0), (0.0, h, 0.0)
        sdf = lambda p: _sdf_capsule(p, a, b, r)  # noqa: E731
        albedo = (0.9, 0.75, 0.2)
    elif kind == "box_sphere":  # union: a box with a sphere cap on top (-y)
        half = (u(0.24, 0.34), u(0.14, 0.2), u(0.24, 0.34))
        r = u(0.16, 0.24)
        c = (0.0, -(half[1] + 0.6 * r), 0.0)
        sdf = lambda p: np.minimum(_sdf_box(p, half), _sdf_sphere(p - np.asarray(c), r))  # noqa: E731
        albedo = (0.75, 0.4, 0.85)
    else:
        raise ValueError(f"unknown SDF kind {kind!r} (one of {SDF_KINDS})")
    return sdf, np.asarray(albedo, np.float32)


def _normals(sdf, p, eps=1e-4):
    e = np.zeros((3, 3))
    np.fill_diagonal(e, eps)
    n = np.stack([sdf(p + e[i]) - sdf(p - e[i]) for i in range(3)], axis=-1)
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)


def look_at_pose(cam_pos):
    """World->camera ``[R|t]`` (3x4) of an OpenCV camera at ``cam_pos``
    looking at the origin, world +y mapping to image up."""
    C = np.asarray(cam_pos, np.float64)
    f = -C / np.linalg.norm(C)
    up = np.array([0.0, 1.0, 0.0])
    if abs(f @ up) > 0.98:
        up = np.array([0.0, 0.0, 1.0])
    r = np.cross(up, f)
    r /= np.linalg.norm(r)
    d = np.cross(f, r)
    R = np.stack([r, d, f], axis=0)
    t = -R @ C
    return np.concatenate([R, t[:, None]], axis=1).astype(np.float32)


def render_scene(sdf, albedo, K, pose, H, W, n_steps=128, s_max=6.0, hit_eps=5e-4):
    """Sphere-trace ``sdf`` through the camera (K, pose) -> (rgb [H, W, 3] in
    [0, 1] on white, z-depth [H, W] with 0 on the background, mask [H, W])."""
    pose = np.asarray(pose, np.float64)
    R, t = pose[:, :3], pose[:, 3]
    C = -R.T @ t
    xs, ys = np.meshgrid(np.arange(W), np.arange(H))
    pix = np.stack([xs, ys, np.ones_like(xs)], axis=-1).reshape(-1, 3)
    r_cam = pix @ np.linalg.inv(np.asarray(K, np.float64)).T
    d_w = r_cam @ R  # R^T r, unnormalised: s is exactly z-depth
    d_norm = np.linalg.norm(d_w, axis=-1)

    s = np.full(len(d_w), 1e-4)
    alive = np.ones(len(d_w), bool)
    for _ in range(n_steps):
        x = C + s[alive, None] * d_w[alive]
        dist = sdf(x)
        s[alive] = s[alive] + dist / d_norm[alive]
        sub = (np.abs(dist) > hit_eps) & (s[alive] < s_max)
        if not sub.any():
            break
        alive[alive] = sub
    x = C + s[:, None] * d_w
    hit = (np.abs(sdf(x)) <= 10 * hit_eps) & (s < s_max) & (s > 0)

    depth = np.where(hit, s, 0.0).reshape(H, W).astype(np.float32)
    rgb = np.ones((H * W, 3), np.float32)
    if hit.any():
        n = _normals(sdf, x[hit])
        light = np.array([0.4, -0.7, -0.6])
        light = light / np.linalg.norm(light)
        lam = np.clip((n @ light), 0.0, 1.0)
        fill = 0.5 * np.clip(n @ np.array([-0.6, 0.2, -0.77]), 0.0, 1.0)
        rgb[hit] = np.clip(albedo * (0.25 + 0.65 * lam + fill)[:, None], 0, 1)
    return rgb.reshape(H, W, 3), depth, hit.reshape(H, W)


def surface_points(sdf, n, rng, box=0.65, newton_iters=10, tol=1e-3):
    """``n`` surface points: uniform seeds projected along the SDF gradient."""
    out = []
    got = 0
    while got < n:
        x = rng.uniform(-box, box, size=(4 * n, 3))
        for _ in range(newton_iters):
            x = x - sdf(x)[:, None] * _normals(sdf, x)
        x = x[np.abs(sdf(x)) < tol]
        out.append(x)
        got += len(x)
        if len(x) == 0:
            raise RuntimeError("surface projection found no surface")
    return np.concatenate(out)[:n].astype(np.float32)


def sdf_samples(sdf, n, rng, box=0.7, near_sigma=0.05):
    """SDF supervision samples: half uniform, half near the surface; values
    carry the +0.003 that the loader subtracts."""
    n_uni = n // 2
    pts_u = rng.uniform(-box, box, size=(n_uni, 3))
    surf = surface_points(sdf, n - n_uni, rng)
    pts_s = surf + rng.normal(0.0, near_sigma, size=surf.shape)
    pts = np.concatenate([pts_u, pts_s]).astype(np.float32)
    return pts, (sdf(pts) + 0.003).astype(np.float32)


def _camera_ring(n_views, rng, dist=1.78):
    """Camera centres on a ring of azimuths and jittered elevations."""
    cams = []
    for v in range(n_views):
        az = 2 * np.pi * (v + rng.uniform(-0.2, 0.2)) / n_views
        el = np.deg2rad(rng.uniform(-35.0, 35.0))
        cams.append(dist * np.array([np.cos(el) * np.sin(az), np.sin(el), -np.cos(el) * np.cos(az)]))
    return cams


def pose_from_Rt(Rt):
    """``[R|t]`` -> the loaders' 3x4 pose (``data/common.py:105-110``)."""
    pose = np.zeros((3, 4), np.float32)
    pose[:3, :3] = Rt[:3, :3]
    pose[:3, 3] = Rt[:3, 3]
    return pose


def _intrinsics(H, focal):
    f = focal * H
    return np.array([[f, 0, H / 2], [0, f, H / 2], [0, 0, 1]], np.float32)


def _view(rgb, depth, pose):
    """One rendered view as the loader reads it back: the RGB through the
    uint8 round trip of the PNG, ``mask = depth != 0``."""
    return {
        "pose_gt": pose_from_Rt(pose),
        "rgb_input_map": (rgb * 255).astype(np.uint8).astype(np.float32) / 255.0,
        "mask_input_map": (depth != 0).astype(np.float32)[..., None],
        "depth_input_map": depth.astype(np.float32)[..., None],
    }


def _objects(n_objects, holdout_objects, category):
    """``(category, kind, held out)`` of each object the writer makes, in order:
    the seen objects in ``category``, then one ``ho{i}`` category a held-out object."""
    for o in range(n_objects + holdout_objects):
        held_out = o >= n_objects
        yield (f"ho{o - n_objects}" if held_out else category), SDF_KINDS[o % len(SDF_KINDS)], held_out


def generate_dataset(root, n_objects=5, n_views=8, H=224, seed=0, subset="analytic", category="prim",
                     n_pc_points=10000, n_sdf_points=20000, val_views=1, focal=1.3875, holdout_objects=0):
    """Write an analytic synthetic-data tree under ``root`` in the reference
    layout (``zeroshape_tpu/data/analytic.py:245-337``), for ``data.root =
    root`` and ``data.synthetic.subset = subset``.

    The last ``val_views`` views of every object go to the val list. With
    ``holdout_objects``, that many more objects (fresh draws of the same
    primitive families) each get a category ``ho{i}`` whose views all go to
    its val list (its train list is empty): scoring them scores objects the
    model never saw, beside the seen objects' views of ``category``
    (``cd_cat.txt`` has a row for each). Images and masks are PNG files of
    :func:`data.common.write_png`; the draws, renders, pixels and arrays
    equal the JAX writer's. Returns the subset directory.
    """
    rng = np.random.default_rng(seed)
    out = os.path.join(root, "train_data", subset)
    os.makedirs(os.path.join(out, "lists"), exist_ok=True)
    K = _intrinsics(H, focal)
    lists = {}  # category -> (train lines, val lines)
    for o, (cat, kind, held_out) in enumerate(_objects(n_objects, holdout_objects, category)):
        if cat not in lists:
            for sub in ("images_processed", "masks", "depth", "pointclouds", "gt_sdf", "camera_data/intr",
                        "camera_data/extr"):
                os.makedirs(os.path.join(out, sub, cat), exist_ok=True)
            lists[cat] = ([], [])
        train_lines, val_lines = lists[cat]
        sdf, albedo = make_sdf(kind, rng)
        obj = f"{kind}{o}"
        np.save(os.path.join(out, "pointclouds", cat, f"{cat}_{obj}.npy"), surface_points(sdf, n_pc_points, rng))
        pts, vals = sdf_samples(sdf, n_sdf_points, rng)
        np.save(os.path.join(out, "gt_sdf", cat, f"{cat}_{obj}.npy"), {"sample_pt": pts, "sample_sdf": vals})
        for v, cam in enumerate(_camera_ring(n_views, rng)):
            pose = look_at_pose(cam)
            rgb, depth, mask = render_scene(sdf, albedo, K, pose, H, H)
            stem = f"{cat}_{obj}_{v:03d}"
            write_png(os.path.join(out, "images_processed", cat, stem + ".png"), (rgb * 255).astype(np.uint8))
            write_png(os.path.join(out, "masks", cat, stem + ".png"), (mask * 255).astype(np.uint8))
            np.save(os.path.join(out, "depth", cat, stem + ".npy"), depth)
            np.save(os.path.join(out, "camera_data", "intr", cat, stem + ".npy"), K)
            np.save(os.path.join(out, "camera_data", "extr", cat, stem + ".npy"), pose)
            (val_lines if held_out or v >= n_views - val_views else train_lines).append(stem + ".png")
    for cat, (train_lines, val_lines) in lists.items():
        for split, lines in (("train", train_lines), ("val", val_lines)):
            with open(os.path.join(out, "lists", f"{cat}_{split}.list"), "w") as fh:
                fh.write("\n".join(lines) + "\n")
    return out


class TrainSet(base.Dataset):
    """An analytic training split in memory, read as the JAX loader reads it.

    ``views`` hold each training view's images, depth, intrinsics, pose and
    object; ``objects`` each object's SDF samples (the stored values minus
    the loader's 0.003, ``data/synthetic.py:179-182``); ``val`` the
    validation samples in :func:`eval_samples`'s layout; ``label2cat`` the
    categories in the loader's order. As a :class:`base.Dataset` it gives
    :meth:`sample` for the loader's epoch, with the seed and SDF count of
    the options its loader was made with (:meth:`setup_loader`).
    """

    def __init__(self, views, objects, val, label2cat=("prim",)):
        super().__init__(None, "train")
        self.views, self.objects, self.val = views, objects, val
        self.label2cat = list(label2cat)
        self.seed, self.n_sdf_points = 0, None

    def __len__(self):
        return len(self.views)

    def __getitem__(self, idx):
        return self.sample(idx, self._epoch, self.seed, self.n_sdf_points)

    def setup_loader(self, opt, **kw):
        self.opt, self.seed, self.n_sdf_points = opt, opt.get("seed") or 0, opt.training.get("n_sdf_points")
        return super().setup_loader(opt, **kw)

    def sample(self, idx, epoch, seed=0, n_sdf_points=None):
        """Training sample ``idx`` in ``epoch`` (``synthetic.py:185-221``):
        its ``n_sdf_points`` SDF samples drawn by ``default_rng((seed, idx,
        epoch))``, ``seed`` being the run's ``opt.seed``."""
        view = self.views[idx]
        pts, sdf = self.objects[view["object"]]
        if n_sdf_points:
            sel = np.random.default_rng((seed, idx, epoch)).permutation(pts.shape[0])[:n_sdf_points]
            pts, sdf = pts[sel], sdf[sel]
        out = {k: v for k, v in view.items() if k != "object"}
        return dict(out, idx=np.int64(idx), gt_sample_points=pts, gt_sample_sdf=sdf)

    def batch_order(self, epoch, batch_size, seed=0):
        """The loader's batches of one epoch (``data/base.py:110-126``): indices
        shuffled by ``default_rng(seed * 100003 + epoch)``, the short tail dropped."""
        order = np.arange(len(self))
        np.random.default_rng(seed * 100003 + epoch).shuffle(order)
        return [order[i : i + batch_size] for i in range(0, len(order) - batch_size + 1, batch_size)]

    def batch(self, indices, epoch, seed=0, n_sdf_points=None):
        """The samples ``indices`` stacked into one batch of numpy arrays."""
        samples = [self.sample(int(i), epoch, seed, n_sdf_points) for i in indices]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def train_samples(n_objects=5, n_views=8, H=224, seed=0, n_pc_points=10000, n_sdf_points=20000, val_views=1,
                  focal=1.3875, holdout_objects=0):
    """The training and validation splits of an analytic dataset, as the loader would give them.

    Walks the draws of :func:`generate_dataset` with the same arguments and
    renders every view without writing files: the first ``n_views -
    val_views`` views of each seen object are training views
    (``SyntheticDataset(split="train")``); the validation samples
    (``split="test"``) are the val lists of the categories in the loader's
    order (sorted list names: ``ho{i}`` before ``prim``), at most 10 a
    category, with their ``dpc``. Returns a :class:`TrainSet`.
    """
    rng = np.random.default_rng(seed)
    K = _intrinsics(H, focal)
    views, objects, val = [], [], {}
    cats = [c for c, _, _ in _objects(n_objects, holdout_objects, "prim")]
    label2cat = sorted(dict.fromkeys(cats), key=lambda c: f"{c}_train.list")
    for o, (cat, kind, held_out) in enumerate(_objects(n_objects, holdout_objects, "prim")):
        sdf, albedo = make_sdf(kind, rng)
        pc = surface_points(sdf, n_pc_points, rng)
        pts, vals = sdf_samples(sdf, n_sdf_points, rng)
        objects.append((pts, vals - 0.003))
        for v, cam in enumerate(_camera_ring(n_views, rng)):
            pose = look_at_pose(cam)
            rgb, depth, _ = render_scene(sdf, albedo, K, pose, H, H)
            view = dict(_view(rgb, depth, pose), intr=K, category_label=np.int64(label2cat.index(cat)))
            if not held_out and v < n_views - val_views:
                views.append(dict(view, object=o))
            elif len(val.setdefault(cat, [])) < VAL_CAP:
                val[cat].append(dict(view, dpc={"points": pc}))
    val = [s for cat in label2cat for s in val.get(cat, [])]
    return TrainSet(views, objects, [dict(s, idx=np.int64(i)) for i, s in enumerate(val)], label2cat)


def eval_samples(n_objects=2, n_views=2, H=224, seed=0, n_pc_points=10000, n_sdf_points=20000, focal=1.3875):
    """The test split of an analytic dataset, as the loader would give it.

    Walks the generator of ``generate_dataset(root, n_objects, n_views, H,
    seed, n_pc_points=..., n_sdf_points=..., val_views=1)`` with the same rng
    draws, renders only each object's last view (the test view) and returns
    the samples ``SyntheticDataset(opt, split="test")`` loads, at most 10:
    ``rgb_input_map [H, H, 3]`` through the uint8 round trip of the PNG,
    ``mask_input_map = depth != 0`` ``[H, H, 1]``, ``pose_gt [3, 4]``,
    ``dpc = {"points": [n_pc_points, 3]}``, ``idx`` and ``category_label``
    (0, category ``"prim"``).
    """
    rng = np.random.default_rng(seed)
    K = _intrinsics(H, focal)
    samples = []
    for o in range(min(n_objects, VAL_CAP)):
        sdf, albedo = make_sdf(SDF_KINDS[o % len(SDF_KINDS)], rng)
        pc = surface_points(sdf, n_pc_points, rng)
        sdf_samples(sdf, n_sdf_points, rng)  # the writer's draws, to keep the stream
        pose = look_at_pose(_camera_ring(n_views, rng)[-1])
        rgb, depth, _ = render_scene(sdf, albedo, K, pose, H, H)
        view = {k: v for k, v in _view(rgb, depth, pose).items() if k != "depth_input_map"}
        samples.append(dict(view, idx=np.int64(len(samples)), category_label=np.int64(0), dpc={"points": pc}))
    return samples
