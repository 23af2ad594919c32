"""The general traffic generator: analytic objects rendered on the device.

Every traffic mix is a data file of parameters that this module reads; a
cell's seed gives the same pool on every run. An object is one of five
analytic SDF primitives with jittered sizes, seen from cameras on a ring
around it; a view is rendered by sphere tracing on the device (z-depth,
shaded RGB on white through the uint8 round trip of a PNG, the mask where
the ray hit). Objects also carry a ground-truth cloud (uniform seeds
projected onto the surface along the SDF gradient) and SDF supervision
samples (half uniform in a box, half near the surface). These follow the
JAX package's ``data/analytic.py``, computed in torch so that the pool is
made in a few large calls on the card.
"""

import numpy as np
import torch

KINDS = ("sphere", "box", "torus", "capsule", "box_sphere")
FOCAL = 1.3875  # focal length over the image side (reference graph_shape.py:98)


def _sphere(p, r):
    return p.norm(dim=-1) - r


def _box(p, half, round_r=0.02):
    q = p.abs() - (torch.tensor(half, device=p.device) - round_r)
    return q.clamp(min=0).norm(dim=-1) + q.max(dim=-1).values.clamp(max=0) - round_r


def _torus(p, R, r):
    q = torch.stack([p[..., [0, 2]].norm(dim=-1) - R, p[..., 1]], dim=-1)
    return q.norm(dim=-1) - r


def _capsule(p, h, r):
    a = torch.tensor([0.0, -h, 0.0], device=p.device)
    ba = torch.tensor([0.0, 2 * h, 0.0], device=p.device)
    t = ((p - a) @ ba / (ba @ ba)).clamp(0.0, 1.0)
    return (p - a - t[..., None] * ba).norm(dim=-1) - r


def make_object(kind, rng):
    """An SDF callable on ``[..., 3]`` tensors and its albedo, sizes drawn from ``rng``."""
    u = lambda lo, hi: float(rng.uniform(lo, hi))  # noqa: E731
    if kind == "sphere":
        r = u(0.3, 0.45)
        return (lambda p: _sphere(p, r)), (0.9, 0.3, 0.25)
    if kind == "box":
        half = (u(0.2, 0.42), u(0.2, 0.42), u(0.2, 0.42))
        return (lambda p: _box(p, half)), (0.25, 0.55, 0.9)
    if kind == "torus":
        R, r = u(0.26, 0.36), u(0.1, 0.16)
        return (lambda p: _torus(p, R, r)), (0.3, 0.85, 0.4)
    if kind == "capsule":
        h, r = u(0.18, 0.3), u(0.12, 0.2)
        return (lambda p: _capsule(p, h, r)), (0.9, 0.75, 0.2)
    half = (u(0.24, 0.34), u(0.14, 0.2), u(0.24, 0.34))
    r = u(0.16, 0.24)
    c = (0.0, -(half[1] + 0.6 * r), 0.0)
    return (lambda p: torch.minimum(_box(p, half), _sphere(p - torch.tensor(c, device=p.device), r))), \
        (0.75, 0.4, 0.85)


def _normals(sdf, p, eps=1e-4):
    e = torch.eye(3, device=p.device) * eps
    n = torch.stack([sdf(p + e[i]) - sdf(p - e[i]) for i in range(3)], dim=-1)
    return n / n.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def look_at(cam):
    """World->camera ``[R|t]`` (3x4) of an OpenCV camera at ``cam`` looking at the origin."""
    C = np.asarray(cam, np.float64)
    f = -C / np.linalg.norm(C)
    up = np.array([0.0, 1.0, 0.0]) if abs(f[1]) <= 0.98 else np.array([0.0, 0.0, 1.0])
    r = np.cross(up, f)
    r /= np.linalg.norm(r)
    R = np.stack([r, np.cross(f, r), f])
    return np.concatenate([R, (-R @ C)[:, None]], axis=1).astype(np.float32)


def camera_ring(n_views, rng, dist=1.78):
    cams = []
    for v in range(n_views):
        az = 2 * np.pi * (v + rng.uniform(-0.2, 0.2)) / n_views
        el = np.deg2rad(rng.uniform(-35.0, 35.0))
        cams.append(dist * np.array([np.cos(el) * np.sin(az), np.sin(el), -np.cos(el) * np.cos(az)]))
    return cams


def intrinsics(H):
    f = FOCAL * H
    return torch.tensor([[f, 0, H / 2], [0, f, H / 2], [0, 0, 1]], dtype=torch.float32)


def render(sdf, albedo, K, poses, H, n_steps=128, s_max=6.0, hit_eps=5e-4):
    """Sphere-trace the views ``poses [V, 3, 4]`` of one object: ``(rgb [V, H,
    H, 3], depth [V, H, H], mask [V, H, H])``."""
    dev = K.device
    V = poses.shape[0]
    R, t = poses[:, :, :3], poses[:, :, 3]
    C = -(R.transpose(1, 2) @ t[..., None])[..., 0]  # [V, 3]
    ys, xs = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                            torch.arange(H, device=dev, dtype=torch.float32), indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1).reshape(-1, 3)
    d = (pix @ torch.linalg.inv(K).T)[None] @ R  # [V, HH, 3] world directions; s is exactly z-depth
    d_norm = d.norm(dim=-1)
    s = torch.full((V, H * H), 1e-4, device=dev)
    for _ in range(n_steps):
        s = (s + sdf(C[:, None] + s[..., None] * d) / d_norm).clamp(max=s_max)
    x = C[:, None] + s[..., None] * d
    hit = (sdf(x).abs() <= 10 * hit_eps) & (s < s_max) & (s > 0)
    n = _normals(sdf, x)
    light = torch.tensor([0.4, -0.7, -0.6], device=dev)
    lam = (n @ (light / light.norm())).clamp(0.0, 1.0)
    fill = 0.5 * (n @ torch.tensor([-0.6, 0.2, -0.77], device=dev)).clamp(0.0, 1.0)
    shade = (torch.tensor(albedo, device=dev) * (0.25 + 0.65 * lam + fill)[..., None]).clamp(0, 1)
    rgb = torch.where(hit[..., None], shade, torch.ones_like(shade))
    rgb = torch.round(rgb * 255) / 255.0  # the PNG's uint8 round trip
    depth = torch.where(hit, s, torch.zeros_like(s))
    return rgb.reshape(V, H, H, 3), depth.reshape(V, H, H), hit.reshape(V, H, H)


def surface_points(sdf, n, gen, device, box=0.65, iters=10, tol=1e-3):
    """``n`` surface points: uniform seeds projected along the SDF gradient."""
    got = []
    total = 0
    while total < n:
        x = (torch.rand(4 * n, 3, generator=gen, device=device) * 2 - 1) * box
        for _ in range(iters):
            x = x - sdf(x)[:, None] * _normals(sdf, x)
        x = x[sdf(x).abs() < tol]
        got.append(x)
        total += x.shape[0]
    return torch.cat(got)[:n]


def sdf_samples(sdf, n, gen, device, box=0.7, near_sigma=0.05):
    """``n`` SDF supervision samples and their values: half uniform, half near the surface."""
    uni = (torch.rand(n // 2, 3, generator=gen, device=device) * 2 - 1) * box
    surf = surface_points(sdf, n - n // 2, gen, device)
    near = surf + torch.randn(surf.shape, generator=gen, device=device) * near_sigma
    pts = torch.cat([uni, near])
    return pts, sdf(pts)


def make_pool(seed, H, n_objects, views_per_object, device, gt_points=0, sdf_points=0):
    """A pool of ``n_objects x views_per_object`` views as batch rows: NHWC
    ``rgb_input_map``, ``mask_input_map``, ``depth_input_map``, ``intr``,
    ``pose_gt`` and the row's ``object``; with ``gt_points`` each row's
    object cloud (``gt_points [N, P, 3]``), with ``sdf_points`` its own
    draw of SDF samples (``gt_sample_points``, ``gt_sample_sdf``)."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    K = intrinsics(H).to(device)
    rows = {k: [] for k in ("rgb_input_map", "mask_input_map", "depth_input_map", "pose_gt", "object")}
    clouds, samples = [], []
    for o in range(n_objects):
        sdf, albedo = make_object(KINDS[o % len(KINDS)], rng)
        poses = torch.from_numpy(np.stack([look_at(c) for c in camera_ring(views_per_object, rng)])).to(device)
        rgb, depth, hit = render(sdf, albedo, K, poses, H)
        rows["rgb_input_map"].append(rgb)
        rows["mask_input_map"].append(hit.float()[..., None])
        rows["depth_input_map"].append(depth[..., None])
        rows["pose_gt"].append(poses)
        rows["object"].append(torch.full((views_per_object,), o, device=device))
        if gt_points:
            clouds.append(surface_points(sdf, gt_points, gen, device).expand(views_per_object, -1, -1))
        for _ in range(views_per_object if sdf_points else 0):
            samples.append(sdf_samples(sdf, sdf_points, gen, device))
    pool = {k: torch.cat(v) for k, v in rows.items()}
    pool["intr"] = K.expand(pool["object"].shape[0], 3, 3).contiguous()
    if clouds:
        pool["gt_points"] = torch.cat(clouds)
    if samples:
        pool["gt_sample_points"] = torch.stack([p for p, _ in samples])
        pool["gt_sample_sdf"] = torch.stack([v for _, v in samples])
    return pool


def draw_order(seed, n_rows, n_draws, batch):
    """``n_draws`` batches of ``batch`` row indices: a seeded permutation of
    the pool, cycled, so consecutive batches share no row until the pool is
    spent."""
    g = np.random.default_rng(seed)
    perm = np.concatenate([g.permutation(n_rows) for _ in range(-(-n_draws * batch // n_rows))])
    return [perm[i * batch: (i + 1) * batch] for i in range(n_draws)]

