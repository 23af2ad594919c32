"""PyTorch port vs the JAX package: hierarchical grid decode and surface sampler.

The grid decode runs with fixed analytic ``decode_fn``s so it does not depend
on a model. ``lax.top_k`` and ``torch.topk`` may order tied cells
differently, so active cells are compared as sets. The samplers get JAX's
cell ids and the uniforms JAX draws internally from its key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeroshape_tpu.metrics import eval3d as je
from zeroshape_tpu.ops import marching_cubes as jmc
from zeroshape_tpu_torch.metrics import eval3d as te
from zeroshape_tpu_torch.ops import marching_cubes as tmc

from test_torch_harness import close, np32, t
from test_torch_harness import give_memory_back  # noqa: F401 (autouse: frees the module's memory at its end)

VOX = 32
CENTERS = np.asarray([[0.0, 0.0, 0.0], [0.8, 0.6, -0.4], [-0.7, -0.9, 0.8]], np.float32)
RADII = np.asarray([0.55, 0.3, 0.18], np.float32)


def sphere(xp):
    return lambda pts: 25.0 * (0.9 - xp.linalg.norm(pts, axis=-1))


def blobs(xp):
    c, r = xp.asarray(CENTERS), xp.asarray(RADII)

    def fn(pts):
        d = xp.linalg.norm(pts[..., None, :] - c, axis=-1) - r
        return -12.0 * d.min(axis=-1) if xp is np else -12.0 * jnp.min(d, axis=-1)

    return fn


def torch_field(name):
    c, r = torch.from_numpy(CENTERS), torch.from_numpy(RADII)
    if name == "sphere":
        return lambda pts: 25.0 * (0.9 - torch.linalg.norm(pts, dim=-1))
    return lambda pts: -12.0 * (torch.linalg.norm(pts[..., None, :] - c, dim=-1) - r).min(dim=-1).values


def jax_field(name):
    return sphere(jnp) if name == "sphere" else blobs(jnp)


def test_dense_grid_and_occupancy():
    close(te.get_dense_3D_grid(16, device="cpu"), je.get_dense_3D_grid(16), 1e-6)
    pts = je.get_dense_3D_grid(8)
    got = te.occupancy_grid(torch_field("blobs"), t(pts), 2, tile_points=100)
    want = je.occupancy_grid(jax_field("blobs"), pts, 2, tile_points=100)
    close(got, want, 1e-6)


@pytest.mark.parametrize("vox,capacity", [(128, None), (128, 4096), (16, None), (32, 10**6)])
def test_capacity_and_work_rules(vox, capacity):
    assert te.resolve_hier_capacity(vox, capacity) == je.resolve_hier_capacity(vox, capacity)
    assert te.hier_decode_saves_work(vox, capacity) == je.hier_decode_saves_work(vox, capacity)


def test_upsample_nearest():
    c = np.random.default_rng(0).uniform(size=(5, 5, 5)).astype(np.float32)
    close(te._upsample_nearest(t(c), 4), je._upsample_nearest(jnp.asarray(c), 4), 0)


@pytest.mark.parametrize("capacity", [40, 4096])
def test_select_active_cells(capacity):
    occ = np.random.default_rng(1).uniform(size=(9, 9, 9)).astype(np.float32) ** 3
    ids, valid, n = te._select_active_cells(t(occ), 0.45, capacity=min(capacity, 512))
    jids, jvalid, jn = je._select_active_cells(jnp.asarray(occ), 0.45, min(capacity, 512))
    assert int(n) == int(jn)
    assert set(ids[valid].tolist()) == set(np.asarray(jids)[np.asarray(jvalid)].tolist())


@pytest.mark.parametrize("field", ["sphere", "blobs"])
@pytest.mark.parametrize("capacity", [None, 50])  # 50 overflows: ranking decides
def test_hierarchical_decode(field, capacity):
    kw = dict(batch_size=1, capacity=capacity, tile_points=(VOX + 1) ** 2, return_stats=True, return_cells=True)
    level, n_act, ids, valid = te.occupancy_grid_hierarchical(torch_field(field), VOX, device="cpu", **kw)
    jlevel, jn_act, jids, jvalid = je.occupancy_grid_hierarchical(jax_field(field), VOX, **kw)
    close(level, jlevel, 1e-6)
    assert n_act.tolist() == np.asarray(jn_act).tolist()
    assert set(ids[0][valid[0]].tolist()) == set(np.asarray(jids)[0][np.asarray(jvalid)[0]].tolist())


@pytest.fixture(scope="module")
def blob_level():
    """JAX's hierarchical level grid and active cells for the blobs field."""
    level, _, ids, valid = je.occupancy_grid_hierarchical(
        jax_field("blobs"), VOX, batch_size=1, tile_points=(VOX + 1) ** 2, return_stats=True, return_cells=True
    )
    return np32(level[0]), np.asarray(ids[0]), np.asarray(valid[0])


def test_triangle_areas_and_cdf(blob_level):
    level = blob_level[0]
    n = level.shape[0] - 1
    vals = [level[dx : dx + n, dy : dy + n, dz : dz + n] for dx, dy, dz in jmc._CORNER_OFF.tolist()]
    got = tmc._corner_areas([t(v) for v in vals], 0.5)
    want = jmc._corner_areas([jnp.asarray(v) for v in vals], 0.5)
    close(got, want, 1e-5)
    close(torch.cumsum(got.reshape(-1), 0), jnp.cumsum(want.reshape(-1)), 1e-5)
    close(tmc.triangle_areas(t(level)), jmc.triangle_areas(jnp.asarray(level)), 1e-5)


def test_case_index_and_edge_vertices(blob_level):
    level = blob_level[0]
    base = np.random.default_rng(2).integers(0, level.shape[0] - 1, (500, 3)).astype(np.int32)
    cv = jmc._gather_corners(jnp.asarray(level), jnp.asarray(base))
    close(tmc._gather_corners(t(level), torch.from_numpy(base)), cv, 0)
    assert tmc._case_index(t(cv), 0.5).tolist() == np.asarray(jmc._case_index(cv, 0.5)).tolist()
    close(tmc._edge_vertices(t(cv), torch.from_numpy(base), 0.5), jmc._edge_vertices(cv, jnp.asarray(base), 0.5), 1e-5)


def test_sampler_matches_jax_with_injected_uniforms(blob_level):
    level, ids, valid = blob_level
    key = jax.random.PRNGKey(7)
    want = jmc.sample_surface_points_cells(jnp.asarray(level), jnp.asarray(ids), jnp.asarray(valid), key, 2000)
    k1, k2 = jax.random.split(key)  # the draws the JAX sampler makes from its key
    u = np32(jax.random.uniform(k1, (2000,)))
    r = np32(jax.random.uniform(k2, (2000, 2)))
    got = tmc.sample_surface_points_cells(
        t(level), torch.from_numpy(ids), torch.from_numpy(valid), num_points=2000, u_slots=t(u), r_bary=t(r)
    )
    close(got, want, 1e-4)


def test_sampler_draws_from_generator_and_empty_surface(blob_level):
    level, ids, valid = blob_level
    run = lambda seed: tmc.sample_surface_points_cells(  # noqa: E731
        t(level), torch.from_numpy(ids), torch.from_numpy(valid), torch.Generator().manual_seed(seed), 300)
    a, b = run(0), run(0)
    assert torch.equal(a, b) and a.shape == (300, 3) and torch.isfinite(a).all()
    assert not torch.equal(a, run(1))
    empty = tmc.sample_surface_points_cells(
        torch.zeros(VOX + 1, VOX + 1, VOX + 1), torch.from_numpy(ids), torch.from_numpy(valid), num_points=10)
    assert torch.equal(empty, torch.zeros(10, 3))


def test_marching_cubes_mesh_matches_jax(blob_level, tmp_path):
    level = blob_level[0]
    v, f = tmc.marching_cubes_mesh(level)
    jv, jf = jmc.marching_cubes_mesh(level)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_allclose(v, jv, atol=1e-6)
    path = tmp_path / "mesh.ply"
    tmc.write_ply_mesh(path, v, f)
    from zeroshape_tpu import vis

    vis.write_ply_mesh(tmp_path / "ref.ply", jv, jf)
    assert path.read_bytes() == (tmp_path / "ref.ply").read_bytes()


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 3 * 4096 * 4096 // 7])
def test_fixed_order_cumsum_is_the_float64_cumsum(n):
    """The samplers' CDF: the float64 prefix sum rounded once to float32,
    for lengths on either side of the 4096-entry rows and past 4096 rows."""
    x = np.random.default_rng(n).random(n).astype(np.float32)
    got = tmc.fixed_order_cumsum(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.cumsum(x.astype(np.float64)).astype(np.float32))
