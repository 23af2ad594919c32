"""PyTorch port vs the JAX package: the turntable renderer, the attention grid,
its frames, and the dense reconstruction with attention (the slice as a whole).

Tolerances: orbit rotations 1e-6; turntable frames (JAX's own uniforms
injected) equal on >= 99% of pixels and elsewhere one shade step (1/255 of
the grey), padded or not; the attention grid's occupancy and z-averaged
attention 1e-5 (fp32); the attention frames 1e-5; ``recon.
reconstruct_with_attn`` against ``Runner._recon_attn_fn``: level 1e-4,
``attn_xy`` 1e-5. The surface draws of the reconstructions are not compared
(jax.random and torch draw differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _batch, _tiny_opt
from zeroshape_tpu.metrics import eval3d as jeval3d
from zeroshape_tpu.models.graph_shape import ShapeGraph as JShapeGraph
from zeroshape_tpu.models.implicit import Implicit as JImplicit
from zeroshape_tpu.ops import render as jrender
from zeroshape_tpu.runtime.shape_engine import Runner
from zeroshape_tpu_torch import config, recon, weights
from zeroshape_tpu_torch.metrics import eval3d
from zeroshape_tpu_torch.models.graph_shape import ShapeGraph
from zeroshape_tpu_torch.models.implicit import Implicit
from zeroshape_tpu_torch.ops import render
from zeroshape_tpu_torch.ops.marching_cubes import marching_cubes_mesh

from test_torch_harness import close, random_variables, t
from test_torch_harness import few_threads, give_memory_back  # noqa: F401 (autouse: two threads; memory back at the end)

H = 32
VOX = 8


def _mesh():
    """An ellipsoid's marching-cubes mesh, centred and scaled to max-abs 1 (as
    ``vis.dump_meshes_viz`` hands meshes to the renderer)."""
    g = np.linspace(-1, 1, 24)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    level = (1 / (1 + np.exp(20 * (np.sqrt(X**2 + (1.5 * Y) ** 2 + Z**2) - 0.7)))).astype(np.float32)
    v, f = marching_cubes_mesh(level)
    v = v - v.mean(0)
    return v / (np.abs(v).max() + 1e-8), f


def test_orbit_rotations_match_jax():
    for n in (3, 15):
        close(render._orbit_rotations(n, 15.0), jrender._orbit_rotations(n, 15.0), 1e-6)


@pytest.mark.parametrize("padded", [True, False])
def test_turntable_matches_jax(padded):
    v, f = _mesh()
    n, size, views = 4096, 64, 3
    key = jax.random.PRNGKey(3)
    ku, kb = jax.random.split(key)  # the draws of ops/render.py:70-79
    u = np.array(jax.random.uniform(ku, (n,)))
    r = np.array(jax.random.uniform(kb, (n, 2)))
    tri_j = jrender.pad_mesh(v, f)
    want = np.asarray(jrender.render_turntable(jnp.asarray(tri_j), key, n_views=views, image_size=size, n_points=n))
    tri = tri_j if padded else render.mesh_triangles(v, f)
    got = render.render_turntable(t(tri), n_views=views, image_size=size, n_points=n, u=t(u), r=t(r),
                                  device="cpu").numpy()
    assert got.shape == want.shape == (views, size, size, 3) and got.dtype == np.uint8
    assert (got == want).all(-1).mean() >= 0.99
    assert np.abs(got.astype(int) - want).max() <= 1
    assert (got != 255).any(-1).mean() > 0.1  # the mesh covers the frames


@pytest.fixture(scope="module")
def implicit():
    """A small decoder (L = 1 + 4^2) in both packages."""
    m = JImplicit(num_patches=16, latent_dim=32, n_channels=64, n_blocks_attn=2, n_layers_mlp=4, num_heads=4,
                  skip_in=(2,))
    rng = np.random.default_rng(0)
    latent = rng.normal(size=(1, 17, 32)).astype(np.float32)
    v = random_variables(m, jnp.asarray(latent), None, jnp.zeros((1, 8, 3)))
    for name in ("block0", "block1"):  # unit LayerNorm gains: attention maps with contrast
        v["params"][name]["norm1"]["scale"] = np.ones_like(v["params"][name]["norm1"]["scale"])
    port = Implicit(num_patches=16, latent_dim=32, n_channels=64, n_blocks_attn=2, n_layers_mlp=4, num_heads=4,
                    skip_in=(2,))
    weights.load(port, weights.convert(weights.map_implicit("", (), 2, 5), jax.tree.map(np.asarray, v["params"])))
    return m, v, port.eval(), latent


def test_occupancy_grid_with_attn_matches_jax(implicit):
    m, v, port, latent = implicit
    caches_j = m.apply(v, jnp.asarray(latent), method=lambda md, lat: md.encode(lat))

    def decode_j(pts):
        return m.apply(v, caches_j, pts, method=lambda md, c, p: md.decode(c, p))

    grid = jeval3d.get_dense_3D_grid(VOX)
    occ_j, attn_j = jeval3d.occupancy_grid_with_attn(decode_j, grid, 1, VOX, tile_points=(VOX + 1) ** 2)
    with torch.no_grad():
        caches = port.encode(t(latent))
        for slices in (1, 4):
            occ, attn = eval3d.occupancy_grid_with_attn(lambda p: port.decode(caches, p),
                                                        eval3d.get_dense_3D_grid(VOX, device="cpu"), 1, VOX, slices)
            close(occ, occ_j, 1e-5)
            close(attn, attn_j, 1e-5)
    assert attn.shape == (1, VOX + 1, VOX + 1, 17) and float(attn.std()) > 1e-3


def test_attention_frames_match_jax():
    rng = np.random.default_rng(1)
    vox, fr = 24, 4
    attn = rng.uniform(size=(vox + 1, vox + 1, 1 + fr * fr)).astype(np.float32)
    image = rng.uniform(size=(40, 40, 3)).astype(np.float32)
    want = jeval3d.attention_frames(attn, image, vox, fr)
    got = eval3d.attention_frames(attn, image, vox, fr)
    assert len(got) == len(want) == 3 * 4  # rows 0, 8, 16; 4 columns each
    for g, w in zip(got, want):
        close(g, w, 1e-5)


@pytest.fixture(scope="module")
def graphs():
    """``_tiny_opt(32)`` in both packages with the weights of
    ``tests/test_torch_port_graph.py`` (the depth head kept inside its clamp)."""
    opt = _tiny_opt(H).unfrozen_copy()
    opt.eval = {"vox_res": VOX, "range": [-1.5, 1.5], "num_points": 50}
    jmodel = JShapeGraph.from_opt(opt)
    # the decoder's parameters exist only when the init batch carries supervision
    v = random_variables(jmodel, _batch(B=1, H=H, n_pts=8), train=False, seed=3)
    head = v["params"]["dpt_depth"]["head_conv3"]
    head["kernel"] = head["kernel"] * 1e-2
    head["bias"] = np.full_like(head["bias"], 0.5)
    # unit LayerNorm gains and larger qkv weights: attention maps with contrast
    for name in ("block0", "block1"):
        blk = v["params"]["impl_network"][name]
        blk["norm1"]["scale"] = np.ones_like(blk["norm1"]["scale"])
        blk["qkv"]["kernel"] = blk["qkv"]["kernel"] * 5.0
    port = ShapeGraph.from_opt(config.tiny_opt(H))
    weights.load(port, weights.from_flax(v["params"], v["batch_stats"], impl_blocks=2, impl_mlp_linears=5))
    rgb, mask = config.synthetic_image(H, seed=4)
    return opt, jmodel, v, port.eval(), {"rgb_input_map": rgb, "mask_input_map": mask}


def test_reconstruct_with_attn_matches_the_jax_runner(graphs):
    """The slice as a whole: forward, latent trunk, the dense decode with
    attention, the sampler and world points, against ``_recon_attn_fn``."""
    opt, jmodel, v, port, batch = graphs
    recon_attn = Runner.for_inference(opt, jmodel)._recon_attn_fn(1)
    out_j, level_j, world_j, attn_j = recon_attn(v, {k: jnp.asarray(x) for k, x in batch.items()},
                                                 jax.random.PRNGKey(0))
    model = recon.ReconModel(port, None, 1.0, torch.device("cpu"))
    out, level, world, attn = recon.reconstruct_with_attn(model, batch, torch.Generator().manual_seed(0),
                                                          vox_res=VOX, num_points=50)
    close(level, level_j, 1e-4)
    close(attn, attn_j, 1e-5)
    close(out["depth_pred"], out_j["depth_pred"], 1e-3)
    assert level.shape == (1, VOX + 1, VOX + 1, VOX + 1) and attn.shape == (1, VOX + 1, VOX + 1, 1 + (H // 16) ** 2)
    assert world.shape == np.asarray(world_j).shape and torch.isfinite(world).all()
    assert float(level.std()) > 1e-4 and float(attn.std()) > 1e-2  # a field and maps that vary
