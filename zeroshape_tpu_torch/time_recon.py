"""Stage timers of the reconstruction on the card (counterparts of
``scripts/time_components.py``, ``time_hier_parts.py``,
``time_decode_hier.py``, ``time_sampling.py``, ``time_decode.py``,
``time_decode_xla.py``, part 2 of ``time_r2.py`` and
``bench_attn_modes.py``).

    python -m zeroshape_tpu_torch.time_recon components [--reps=5] [--vox_res=128]
    python -m zeroshape_tpu_torch.time_recon hier_parts [--reps=10] [--vox_res=128]
    python -m zeroshape_tpu_torch.time_recon decode [--reps=5] [--vox_res=128]
    python -m zeroshape_tpu_torch.time_recon sampling [--reps=5] [--vox_res=128]
    python -m zeroshape_tpu_torch.time_recon k1_builds [SOURCE.cu ...] [--reps=10] [--rounds=2]

Each stage is timed alone on the host clock, each call ending in a sync
(the median of ``reps``); the last line is one JSON object with the card's
name and power limit. ``--device=cpu`` and dotted options over
``config.full_opt()`` (the main path's model) run them small on the CPU.

* ``components``: ``ShapeGraph.encode_image``, ``encode_latents``
  (``Implicit.encode``), the dense ``(vox_res+1)^3`` decode through K1 (one
  launch) and the dense surface sampler, on ``recon.synthetic_setup``'s
  calibrated model and image.
* ``hier_parts``: the hierarchical decode's other stages on a random coarse
  grid (as the JAX script), each the batched call the decode makes:
  ``eval3d._select_active_cells`` at the capacity,
  the fine-point gather (``_fine_points``), ``_upsample_nearest``, the
  fine-value scatter (``_scatter_fine``) and the sigmoid of the fine values.
  The JAX script also timed ``_upsample_trilinear``, which
  ``zeroshape_tpu/metrics/eval3d.py`` no longer has: it is not here.
* ``decode``: the dense grid against the hierarchical decode, both through
  K1, and their agreement on the inside/outside of every grid point; K1
  against the plain bf16 ``Implicit.decode`` over the dense grid; the plain
  decode's tile sweep (the default 16,641 points, a z-slice, and smaller
  and larger tiles); the hierarchical decode with K1 against the plain
  decode as its ``decode_fn``.
* ``sampling``: a trivial launch's floor, then each stage of
  ``ops/marching_cubes.sample_surface_points``: ``triangle_areas`` (slabs of
  4, 8, 16, 32 planes), ``fixed_order_cumsum``, ``_draw_slots``,
  ``_sample_from_tris``, the whole sampler, and the hierarchical posture's
  ``sample_surface_points_cells``, on an analytic sphere's level grid.
* ``k1_builds``: K1 has one layout on Hopper, so its A/B is of builds: each
  given source of ``implicit_decoder.cu`` (the same C entry point; default
  the shipped one) is built (one ``nvcc`` each, all at once), held to the
  plain fp32 decode at P = 512,000 points with K1's bf16 bounds, and timed
  with CUDA events in turns (forward order, then reversed, ``rounds``
  times). It needs the card.
"""

from __future__ import annotations

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from zeroshape_tpu_torch import config, recon, resolve_device
from zeroshape_tpu_torch.metrics import eval3d
from zeroshape_tpu_torch.ops import marching_cubes as mc
from zeroshape_tpu_torch.timing import emit, event_ms, host_ms, median

TOOL = "time_recon"
K1_POINTS = 4096 * 125  # the fine pass of a vox-128, capacity-4096 hierarchical decode
K1_RTOL, K1_ATOL, K1_CORR, K1_MEAN = 8e-2, 2e-2, 0.9999, 5e-3  # tests/test_implicit_kernel.py's bf16 bounds


def _ms(fn, dev, reps, warmup=1):
    return median(host_ms(fn, dev, reps, warmup))


def _decode_fn(model, caches):
    return lambda pts: model.sharpen * recon.decode_points(model, caches, pts)


def _setup(opt, dev):
    model, batch, gen, _ = recon.synthetic_setup(dev, opt)
    with torch.inference_mode():
        out = model.graph.encode_image(recon._inputs(batch, dev))
        caches = model.graph.encode_latents(out)
    return model, batch, gen, out, caches


@torch.inference_mode()
def components(opt=None, device=None, vox_res=recon.VOX_RES, reps=5):
    """``{encode_image_ms, encode_latents_ms, dense_decode_ms, dense_sample_ms,
    k1_launches, points}``."""
    from zeroshape_tpu_torch.ops.implicit_kernel import fused_decode

    dev = resolve_device(device)
    model, batch, gen, out, caches = _setup(opt, dev)
    inputs = recon._inputs(batch, dev)
    S = vox_res + 1
    grid = eval3d.get_dense_3D_grid(vox_res, recon.RANGE, device=dev)
    decode_fn = _decode_fn(model, caches)

    def dense():
        return eval3d.occupancy_grid(decode_fn, grid, 1, tile_points=grid.shape[0]).reshape(S, S, S)

    res = {"vox_res": vox_res, "encode_image_ms": _ms(lambda: model.graph.encode_image(inputs), dev, reps),
           "encode_latents_ms": _ms(lambda: model.graph.encode_latents(out), dev, reps)}
    fused_decode.launches = 0
    res["dense_decode_ms"] = _ms(dense, dev, reps)
    res["k1_launches"] = fused_decode.launches
    level = dense()
    res["dense_sample_ms"] = _ms(lambda: mc.sample_surface_points(level, gen, recon.NUM_POINTS), dev, reps)
    res["points"] = int(grid.shape[0])
    print(f"image -> latents {res['encode_image_ms']:.2f} ms; latent encode {res['encode_latents_ms']:.2f} ms; "
          f"grid decode {S}^3 {res['dense_decode_ms']:.2f} ms ({res['k1_launches']} K1 launches over "
          f"{reps + 1} decodes); surface sampling 10k {res['dense_sample_ms']:.2f} ms", flush=True)
    return res


@torch.inference_mode()
def hier_parts(device=None, vox_res=recon.VOX_RES, reps=10, capacity=recon.CAPACITY, factor=recon.FACTOR):
    """The hierarchical decode's other stages, each the call the decode
    makes for a batch (here of one random coarse grid), in ms."""
    dev = resolve_device(device)
    nc = vox_res // factor
    f1 = factor + 1
    g = torch.Generator().manual_seed(0)
    occ_c = torch.rand(1, nc + 1, nc + 1, nc + 1, generator=g).to(dev)
    axis = torch.linspace(*recon.RANGE, vox_res + 1, device=dev)
    ids, valid, n_active = eval3d._select_active_cells(occ_c, recon.MARGIN, capacity)
    pts, fidx = eval3d._fine_points(ids, axis, nc, factor)
    vals = torch.rand(1, ids.shape[1] * f1**3, generator=g).to(dev)
    res = {"vox_res": vox_res, "capacity": capacity, "n_active": int(n_active[0]),
           "fine_points": int(pts.shape[1]),
           "select_ms": _ms(lambda: eval3d._select_active_cells(occ_c, recon.MARGIN, capacity), dev, reps),
           "gather_ms": _ms(lambda: eval3d._fine_points(ids, axis, nc, factor), dev, reps),
           "upsample_nearest_ms": _ms(lambda: eval3d._upsample_nearest(occ_c, factor), dev, reps),
           "scatter_ms": _ms(lambda: eval3d._scatter_fine(occ_c, fidx, valid, vals, factor), dev, reps),
           "sigmoid_ms": _ms(lambda: torch.sigmoid(vals), dev, reps)}
    print(f"select_active (sort of {nc**3} cells, capacity {capacity}): {res['select_ms']:.3f} ms; point gather "
          f"({res['fine_points']}) {res['gather_ms']:.3f} ms; fill nearest {res['upsample_nearest_ms']:.3f} ms; "
          f"scatter {res['scatter_ms']:.3f} ms; sigmoid {res['sigmoid_ms']:.3f} ms", flush=True)
    return res


def tile_sizes(vox_res):
    """The plain decode's tiles of the sweep: a z-slice of the grid (the
    default) and 1/4, 1/2, 2, 4, 8 and 16 of it."""
    S2 = (vox_res + 1) ** 2
    return [S2 // 4, S2 // 2, S2, 2 * S2, 4 * S2, 8 * S2, 16 * S2]


@torch.inference_mode()
def decode(opt=None, device=None, vox_res=recon.VOX_RES, reps=5):
    """Dense against hierarchical, K1 against the plain decode, the tile sweep."""
    from zeroshape_tpu_torch.bench import variant

    dev = resolve_device(device)
    model, _, _, _, caches = _setup(opt, dev)
    plain = variant(model, use_fused=False)
    S = vox_res + 1
    grid = eval3d.get_dense_3D_grid(vox_res, recon.RANGE, device=dev)

    def dense(m, tile):
        return eval3d.occupancy_grid(_decode_fn(m, caches), grid, 1, tile_points=tile).reshape(S, S, S)

    def hier(m):
        tile = eval3d.resolve_hier_capacity(vox_res, recon.CAPACITY, recon.FACTOR) * (recon.FACTOR + 1) ** 3
        return eval3d.occupancy_grid_hierarchical(
            _decode_fn(m, caches), vox_res, recon.RANGE, batch_size=1, factor=recon.FACTOR, capacity=recon.CAPACITY,
            margin=recon.MARGIN, tile_points=tile, device=dev)[0]

    ld, lh, lp = dense(model, grid.shape[0]), hier(model), hier(plain)
    res = {"vox_res": vox_res, "dense_k1_ms": _ms(lambda: dense(model, grid.shape[0]), dev, reps),
           "hier_k1_ms": _ms(lambda: hier(model), dev, reps),
           "hier_sign_agree": float(((ld >= 0.5) == (lh >= 0.5)).float().mean()),
           "dense_plain_ms": _ms(lambda: dense(plain, S * S), dev, reps),
           "hier_plain_ms": _ms(lambda: hier(plain), dev, reps),
           "hier_k1_plain_sign_agree": float(((lh >= 0.5) == (lp >= 0.5)).float().mean())}
    res["tiles"] = []
    for tile in tile_sizes(vox_res):
        try:
            ms = _ms(lambda: dense(plain, tile), dev, reps)
        except torch.cuda.OutOfMemoryError:
            print(f"plain decode tile={tile}: out of memory", flush=True)
            torch.cuda.empty_cache()
            continue
        res["tiles"].append({"tile": tile, "ms": ms})
        print(f"plain decode tile={tile}: {ms:.1f} ms", flush=True)
    print(f"dense {S}^3 through K1 {res['dense_k1_ms']:.2f} ms, plain bf16 {res['dense_plain_ms']:.2f} ms; "
          f"hierarchical through K1 {res['hier_k1_ms']:.2f} ms (inside/outside as the dense grid on "
          f"{res['hier_sign_agree']:.6f}), with the plain decode {res['hier_plain_ms']:.2f} ms (as K1's on "
          f"{res['hier_k1_plain_sign_agree']:.6f})", flush=True)
    return res


def sphere_level(vox_res, device):
    """The JAX script's level grid: a soft unit sphere (sigmoid of 8 (1 - r))."""
    g = torch.linspace(*recon.RANGE, vox_res + 1, device=device)
    X, Y, Z = torch.meshgrid(g, g, g, indexing="ij")
    return torch.sigmoid((1.0 - torch.sqrt(X**2 + Y**2 + Z**2)) * 8.0)


@torch.inference_mode()
def sampling(device=None, vox_res=recon.VOX_RES, reps=5, num_points=recon.NUM_POINTS):
    """Each stage of the samplers, in ms."""
    dev = resolve_device(device)
    level = sphere_level(vox_res, dev)
    n = vox_res
    gen = torch.Generator(device=dev).manual_seed(0)
    small = torch.zeros(8, 128, device=dev)
    res = {"vox_res": vox_res, "launch_floor_ms": _ms(lambda: small + 1.0, dev, reps)}
    for slab in (4, 8, 16, 32):
        res[f"triangle_areas_slab{slab}_ms"] = _ms(lambda s=slab: mc.triangle_areas(level, slab=s), dev, reps)
    areas = mc.triangle_areas(level)
    res["cumsum_ms"] = _ms(lambda: mc.fixed_order_cumsum(areas), dev, reps)
    cdf = mc.fixed_order_cumsum(areas)
    u = torch.rand(num_points, generator=gen, device=dev)
    r = torch.rand(num_points, 2, generator=gen, device=dev)
    res["draw_slots_ms"] = _ms(lambda: mc._draw_slots(cdf, u), dev, reps)
    slots = mc._draw_slots(cdf, u)
    cube = slots // mc.MAX_TRIS
    base = torch.stack([cube // (n * n), (cube // n) % n, cube % n], dim=-1)
    res["sample_from_tris_ms"] = _ms(lambda: mc._sample_from_tris(level, base, slots % mc.MAX_TRIS, r, 0.5), dev, reps)
    res["sample_surface_points_ms"] = _ms(lambda: mc.sample_surface_points(level, gen, num_points), dev, reps)
    coarse = level[:: recon.FACTOR, :: recon.FACTOR, :: recon.FACTOR]
    ids, valid, n_active = eval3d._select_active_cells(coarse, recon.MARGIN, recon.CAPACITY)
    res["n_active"] = int(n_active)
    res["sample_surface_points_cells_ms"] = _ms(
        lambda: mc.sample_surface_points_cells(level, ids, valid, gen, num_points, factor=recon.FACTOR), dev, reps)
    res["triangle_slots"] = int(areas.shape[0])
    print("; ".join(f"{k[:-3]} {v:.3f} ms" for k, v in res.items() if k.endswith("_ms")), flush=True)
    return res


def k1_case(device, P=K1_POINTS, seed=1):
    """K1's operands at full width on random weights (C=256, 8 heads, 2
    blocks, 9 linears, L=197): the decoder with non-zero biases and an 8x
    point embedding (a random field is nearly flat across points; this one
    varies by more than bf16 noise, as a trained field does), its weights,
    latent caches and points rounded to bf16 values (the plain version then
    reads the kernel's very operands), and ``P`` points in the grid's cube.
    Returns ``(impl, caches, packed, points)``."""
    from zeroshape_tpu_torch.models.implicit import Implicit
    from zeroshape_tpu_torch.ops import implicit_kernel as ik
    from zeroshape_tpu_torch.weights import init_like_flax

    g = torch.Generator().manual_seed(seed)
    impl = init_like_flax(Implicit(num_patches=196, latent_dim=256), seed=seed)
    with torch.no_grad():
        for name, prm in impl.named_parameters():
            if name.endswith("bias"):
                prm.add_(0.05 * torch.randn(prm.shape, generator=g))
        impl.point_proj.proj.weight.mul_(8.0)
        for prm in impl.parameters():
            prm.copy_(prm.to(torch.bfloat16).float())
    impl = impl.to(device).eval()
    latent = torch.randn(1, 197, 256, generator=g).to(device)
    points = (torch.rand(P, 3, generator=g) * 3.0 - 1.5).to(device)
    with torch.inference_mode():
        caches = [(k.bfloat16().float(), v.bfloat16().float()) for k, v in impl.encode(latent)]
        packed = ik.pack_decoder_params(impl) if torch.device(device).type == "cuda" else None
    return impl, caches, packed, points


def k1_agreement(got, ref):
    """``(ok, max |d|, mean |d|, corr)`` of K1's logits against the plain
    version's under K1's bf16 bounds."""
    a, b = got.double().cpu().numpy(), ref.double().cpu().numpy()
    d = np.abs(a - b)
    corr = float(np.corrcoef(a, b)[0, 1])
    ok = bool(np.isfinite(a).all() and np.allclose(a, b, rtol=K1_RTOL, atol=K1_ATOL) and corr > K1_CORR
              and d.mean() < K1_MEAN)
    return ok, float(d.max()), float(d.mean()), corr


def library_names(sources):
    """The library name of each source: the shipped source keeps the name
    the main path's build has (no second build of it), every other one its
    own ``zs_k1_cmp{k}``."""
    from zeroshape_tpu_torch.ops import _build
    from zeroshape_tpu_torch.ops import implicit_kernel as ik

    shipped = os.path.realpath(os.path.join(_build.CSRC, ik._SOURCE))
    return [ik._NAME if os.path.realpath(s) == shipped else f"zs_k1_cmp{k}" for k, s in enumerate(sources)]


def k1_builds(sources, device=None, reps=10, rounds=2, P=K1_POINTS):
    """Build, check and time each K1 source; returns its JSON fields."""
    from zeroshape_tpu_torch.ops import _build
    from zeroshape_tpu_torch.ops import implicit_kernel as ik

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("k1_builds builds CUDA sources of K1: it needs the card")
    sources = [os.path.abspath(s) for s in sources]
    names = library_names(sources)
    unique = dict(zip(names, sources))
    with ThreadPoolExecutor(len(unique)) as pool:
        built = dict(zip(unique, pool.map(lambda ns: _build.build(ns[1], ns[0]), unique.items())))
    for name, (seconds, log) in built.items():
        print(f"build: {unique[name]} as lib{name}.so in {seconds:.1f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}", flush=True)
    libs = [_build.library(s, n, ik.SINGLE_SIGNATURE) for s, n in zip(sources, names)]
    impl, caches, packed, points = k1_case(dev, P)
    rows = []
    with torch.inference_mode():
        ref = impl.decode(caches, points[None])[0][0]
        for src, lib in zip(sources, libs):
            out = torch.empty(P, device=dev)
            ik.launch(lib, caches, points, packed, out)
            ok, dmax, dmean, corr = k1_agreement(out, ref)
            rows.append({"source": src, "ok": ok, "max_abs_err": dmax, "mean_abs_err": dmean, "corr": corr,
                         "ms": []})
            print(f"{os.path.basename(src)}: against the plain fp32 decode max|d| {dmax:.3e} mean|d| {dmean:.3e} "
                  f"corr {corr:.6f}: {'ok' if ok else 'FAILED'}", flush=True)
        out = torch.empty(P, device=dev)
        order = list(range(len(libs)))
        for r in range(rounds):
            for k in order + order[::-1]:
                ms = event_ms(lambda: ik.launch(libs[k], caches, points, packed, out), dev, reps, 2)
                rows[k]["ms"].append(ms)
                print(f"round {r}: {os.path.basename(sources[k])} {ms:.3f} ms at P={P}", flush=True)
    for row in rows:
        row["ms_mean"] = float(np.mean(row["ms"]))
    return {"points": P, "reps": reps, "rounds": rounds, "builds": rows}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    subs = ("components", "hier_parts", "decode", "sampling", "k1_builds")
    if not argv or argv[0] not in subs:
        raise SystemExit(__doc__)
    sub, rest = argv[0], argv[1:]
    args = config.parse_arguments([a for a in rest if a.startswith("--")])
    dev = resolve_device(args.pop("device", None))
    reps, vox = int(args.pop("reps", 10 if sub in ("hier_parts", "k1_builds") else 5)), int(args.pop("vox_res", 128))
    if sub == "k1_builds":
        from zeroshape_tpu_torch.ops import _build
        from zeroshape_tpu_torch.ops import implicit_kernel as ik

        sources = [a for a in rest if not a.startswith("--")] or [os.path.join(_build.CSRC, ik._SOURCE)]
        out = k1_builds(sources, dev, reps, int(args.pop("rounds", 2)))
        emit(TOOL, sub, dev, **out)
        sys.exit(0 if all(b["ok"] for b in out["builds"]) else 1)
    opt = config.override_options(config.full_opt(), args)
    if sub == "components":
        out = components(opt, dev, vox, reps)
    elif sub == "hier_parts":
        out = hier_parts(dev, vox, reps)
    elif sub == "decode":
        out = decode(opt, dev, vox, reps)
    else:
        out = sampling(dev, vox, reps)
    emit(TOOL, sub, dev, reps=reps, **out)


if __name__ == "__main__":
    main()
