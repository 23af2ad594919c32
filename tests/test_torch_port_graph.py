"""PyTorch port vs the JAX package: DPT, coordinate encoder, intrinsics head,
``encode_image``, the supervision half of the graph (``gt_supervision``, the
training forward, ``attn_geo_stats``, BatchNorm on batch statistics) and the
reconstruction path, at H=64 (as tests/test_graphs.py).

One set of random JAX variables (tiny decoder, full-width encoders) goes to
the port through ``weights.from_flax``. Tolerances follow
tests/test_torch_parity.py: 1e-4 per module tap, 1e-3 end to end.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _batch
from zeroshape_tpu.metrics import eval3d as je
from zeroshape_tpu.models.coord_enc import CoordEncRes as JCoordEncRes
from zeroshape_tpu.models.dpt import DPTDepthModel as JDPT
from zeroshape_tpu.models.dpt import HybridViT as JHybridViT
from zeroshape_tpu.models.graph_shape import IntrHead as JIntrHead
from zeroshape_tpu.models.graph_shape import ShapeGraph as JShapeGraph
from zeroshape_tpu.models.graph_shape import attn_geo_stats as j_attn_geo_stats
from zeroshape_tpu.runtime.checkpoint import convert_torch_state_dict
from zeroshape_tpu_torch import config, recon, weights
from zeroshape_tpu_torch.models.graph_shape import ShapeGraph, attn_geo_stats

from test_torch_harness import close, nchw, nhwc, random_variables
from test_torch_harness import give_memory_back  # noqa: F401 (autouse: frees the module's memory at its end)

H = 64
SHARPEN = 25.0


@pytest.fixture(scope="module")
def graphs():
    opt = config.tiny_opt(H)
    jmodel = JShapeGraph.from_opt(opt)
    b = _batch(B=1, H=H, n_pts=8)
    v = random_variables(jmodel, b, train=False, seed=3)
    # keep the random depth head inside the [0, 1] clamp with spread
    # (tests/test_torch_parity.py:_tame_depth_head)
    head = v["params"]["dpt_depth"]["head_conv3"]
    head["kernel"] = head["kernel"] * 1e-2
    head["bias"] = np.full_like(head["bias"], 0.5)
    port = ShapeGraph.from_opt(opt)
    weights.load(port, weights.from_flax(v["params"], v["batch_stats"], impl_blocks=2, impl_mlp_linears=5))
    rgb, mask = config.synthetic_image(H, seed=4)
    return jmodel, v, port.eval(), {"rgb_input_map": rgb, "mask_input_map": mask}


def test_dpt_backbone_taps(graphs):
    _, v, port, batch = graphs
    xs = batch["rgb_input_map"] * 2.0 - 1.0
    want = JHybridViT().apply({"params": v["params"]["dpt_depth"]["dpt"]["pretrained"]}, jnp.asarray(xs))
    with torch.no_grad():
        got = port.dpt_depth.pretrained.model(nchw(xs))
    close(nhwc(got[0]), want[0], 1e-4, "ResNetV2 stage0 tap")
    close(nhwc(got[1]), want[1], 1e-4, "ResNetV2 stage1 tap")
    close(got[2], want[2], 1e-4, "ViT block-8 tap")
    close(got[3], want[3], 1e-4, "ViT block-11 tap")


def test_dpt_depth_and_intr_feature(graphs):
    _, v, port, batch = graphs
    depth_j, feat_j = JDPT().apply({"params": v["params"]["dpt_depth"]}, jnp.asarray(batch["rgb_input_map"]))
    with torch.no_grad():
        depth, feat = port.dpt_depth(nchw(batch["rgb_input_map"]))
    assert float(depth.std()) > 1e-3  # a live depth map, not a clamped constant
    close(nhwc(feat), feat_j, 1e-4, "reassembled layer4 (intrinsics feature)")
    close(nhwc(depth), depth_j, 1e-3, "depth")


def test_coord_encoder(graphs):
    _, v, port, _ = graphs
    rng = np.random.default_rng(5)
    cm = rng.normal(size=(2, H, H, 3)).astype(np.float32)
    mask = (rng.uniform(size=(2, H, H, 1)) > 0.4).astype(np.float32)
    want = JCoordEncRes(latent_dim=64).apply(
        {"params": v["params"]["coord_encoder"], "batch_stats": v["batch_stats"]["coord_encoder"]},
        jnp.asarray(cm), jnp.asarray(mask), False,
    )
    with torch.no_grad():
        got = port.coord_encoder(nchw(cm), nchw(mask))
    close(got, want, 1e-4)


def test_intr_head(graphs):
    _, v, port, _ = graphs
    feat = np.random.default_rng(6).normal(size=(2, 2, 2, 768)).astype(np.float32)
    want = JIntrHead().apply(
        {"params": v["params"]["intr_head"], "batch_stats": v["batch_stats"]["intr_head"]}, jnp.asarray(feat), False
    )
    with torch.no_grad():
        got = port.intr_proj(port.intr_head(nchw(feat)))
    close(got, want, 1e-4)


def test_encode_image_end_to_end(graphs):
    jmodel, v, port, batch = graphs
    want = jmodel.apply(v, {k: jnp.asarray(x) for k, x in batch.items()}, method=lambda m, b: m.encode_image(b))
    with torch.no_grad():
        got = port.encode_image({k: torch.from_numpy(x) for k, x in batch.items()})
    for k in ("depth_pred", "intr_pred", "validity_mask", "seen_points", "latent_depth"):
        close(got[k], want[k], 1e-3, k)


def test_weight_round_trip(graphs):
    """Port state dict -> the JAX package's torch importer -> the original trees."""
    _, v, port, _ = graphs
    sd = {k: x.numpy() for k, x in port.state_dict().items()}
    params, stats, report = convert_torch_state_dict(sd, graph="shape", impl_blocks=2, impl_mlp_linears=5)
    assert report["missing"] == []
    assert report["unconsumed"] == []
    for coll, got in (("params", params), ("batch_stats", stats)):
        want = jax.tree_util.tree_flatten_with_path(v[coll])[0]
        got_flat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert len(got_flat) == len(want)
        for path, leaf in want:
            np.testing.assert_array_equal(got_flat[path], np.asarray(leaf), err_msg=str(path))


def test_seeded_init_follows_the_jax_initialisers():
    """``weights.init_like_flax`` draws every tensor as the JAX module's own
    init does: constants (zero biases, unit norms, the depth head's 0.05 bias,
    the zero intrinsics projection) equal, random tensors with the same mean
    and spread."""
    opt = config.tiny_opt(H)
    jmodel = JShapeGraph.from_opt(opt)
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    init = jax.jit(lambda r, b: jmodel.init(r, b, train=False))  # faster than eager init
    v = jax.tree.map(np.asarray, init(rngs, _batch(B=1, H=H, n_pts=8)))
    want = weights.from_flax(v["params"], v["batch_stats"], impl_blocks=2, impl_mlp_linears=5)
    got = weights.init_like_flax(ShapeGraph.from_opt(opt), seed=0).state_dict()
    n_random = 0
    for k, w in want.items():
        g = got[k]
        if torch.all(w == w.reshape(-1)[0]):
            assert torch.equal(g, w), k
        elif w.numel() >= 1000:
            n_random += 1
            s = float(w.std())
            assert abs(float(g.std()) - s) < 0.1 * s, k
            assert abs(float(g.mean()) - float(w.mean())) < 0.1 * s, k
    assert n_random > 100


def test_calibrate_random_field_sets_the_active_cells():
    """``calibrate_random_field`` puts the top ``INSIDE`` share of the coarse
    lattice inside the zero level and steepens the field until at most the
    target count of cells is active; the reconstruction then finds exactly
    that count and samples a surface."""
    model = recon.build(config.tiny_opt(32), device="cpu", seed=0)
    rgb, mask = config.synthetic_image(32, seed=1)
    batch = {"rgb_input_map": rgb, "mask_input_map": mask}
    target = 32  # of the 64 coarse cells at vox 16
    _, gain, n_calibrated = recon.calibrate_random_field(model, batch, target=target, vox_res=16)
    world, _, _, n_active, level = recon.reconstruct(
        model, batch, torch.Generator().manual_seed(0), vox_res=16, capacity=64, num_points=200,
        return_level=True,
    )
    assert 0 < n_calibrated <= target and gain >= 1
    assert int(n_active[0]) == n_calibrated
    inside = float((level[0, ::4, ::4, ::4] >= 0.5).float().mean())
    assert abs(inside - recon.INSIDE) < 0.03
    assert world.std(dim=0).min() > 0  # samples spread over a surface, not one fill value


def test_reconstruct_level_grid_matches_jax(graphs):
    """Image -> latents -> caches -> hierarchical level grid at vox 16, through
    ``recon.reconstruct`` on the CPU against the same pipeline in JAX."""
    jmodel, v, port, batch = graphs
    vox, capacity = 16, 40
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    latent = jmodel.apply(v, jb, method=lambda m, b: m.encode_image(b))["latent_depth"]
    caches = jmodel.apply(v, latent, method=lambda m, l: m.impl_network.encode(l))

    def j_decode(pts):
        return SHARPEN * jmodel.apply(v, caches, pts, method=lambda m, c, p: m.impl_network.decode(c, p)[0])

    jlevel, jn, jids, jvalid = je.occupancy_grid_hierarchical(
        j_decode, vox, capacity=capacity, return_stats=True, return_cells=True
    )
    model = recon.ReconModel(port, None, SHARPEN, torch.device("cpu"))
    world, depth, intr, n_active, level = recon.reconstruct(
        model, batch, torch.Generator().manual_seed(0), vox_res=vox, capacity=capacity,
        num_points=500, return_level=True,
    )
    close(level, jlevel, 1e-3, "level grid")
    assert n_active.tolist() == np.asarray(jn).tolist()
    assert world.shape == (500, 3) and torch.isfinite(world).all() and world.abs().max() <= 1.5
    assert intr.shape == (1, 3, 3) and depth.shape == (1, H, H, 1)


def test_reconstruct_dense_level_grid_matches_jax(graphs):
    """The dense decode posture (``hier=False``): the full (vox+1)^3 grid
    through the decoder and the dense sampler, against the JAX dense decode."""
    jmodel, v, port, batch = graphs
    vox = 16
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    latent = jmodel.apply(v, jb, method=lambda m, b: m.encode_image(b))["latent_depth"]
    caches = jmodel.apply(v, latent, method=lambda m, l: m.impl_network.encode(l))

    def j_decode(pts):
        return SHARPEN * jmodel.apply(v, caches, pts, method=lambda m, c, p: m.impl_network.decode(c, p)[0])

    S = vox + 1
    jlevel = je.occupancy_grid(j_decode, je.get_dense_3D_grid(vox), 1, tile_points=S * S).reshape(1, S, S, S)
    model = recon.ReconModel(port, None, SHARPEN, torch.device("cpu"))
    world, _, _, n_active, level = recon.reconstruct(
        model, batch, torch.Generator().manual_seed(0), vox_res=vox, num_points=300, return_level=True, hier=False,
    )
    close(level, jlevel, 1e-3, "dense level grid")
    assert n_active is None
    assert world.shape == (300, 3) and torch.isfinite(world).all() and world.abs().max() <= 1.5


def _supervised_batch(B=2, n_pts=300, seed=7):
    """``_batch`` at H=64 with ties in ``|sdf|`` (150 zeros: the top 100 are a
    tie broken by index) and a third of the SDF points on the visible depth
    surface, so that ``attn_geo_seen`` counts some."""
    b = {k: np.array(x) for k, x in _batch(B=B, H=H, n_pts=n_pts, seed=seed).items()}
    rng = np.random.default_rng(seed)
    b["gt_sample_sdf"][:, 50:200] = 0.0
    K_inv = np.linalg.inv(b["intr"][0])
    for i in range(B):
        u, v = rng.integers(0, H, (2, n_pts // 3))
        z = b["depth_input_map"][i, v, u, 0]
        cam = (np.stack([u, v, np.ones_like(u)], -1) @ K_inv.T) * z[:, None]
        b["gt_sample_points"][i, : n_pts // 3] = cam - b["pose_gt"][i, :, 3]  # R = I
    return b


def test_gt_supervision_matches_jax(graphs):
    jmodel, v, port, _ = graphs
    b = _supervised_batch()
    want = jmodel.apply(v, {k: jnp.asarray(x) for k, x in b.items()}, method=lambda m, x: m.gt_supervision(x))
    got = port.gt_supervision({k: torch.from_numpy(x) for k, x in b.items()})
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k], 1e-5, k)


def test_attn_geo_stats_matches_jax(graphs):
    """``attn_geo_stats`` of both packages on the same supervision and a random
    attention map ``[B, N, L]`` (the forward that makes them is held to JAX by
    tests/test_torch_port_train.py)."""
    jmodel, v, _, _ = graphs
    b = _supervised_batch()
    jb = {k: jnp.asarray(x) for k, x in b.items()}
    sup = jmodel.apply(v, jb, method=lambda m, x: m.gt_supervision(x))
    attn = np.random.default_rng(8).dirichlet(np.ones(17), size=(2, 300))[..., :16].astype(np.float32)
    jout = dict(sup, attn=jnp.asarray(attn))
    want = j_attn_geo_stats(None, jb, jout)
    got = attn_geo_stats(None, {k: torch.from_numpy(x) for k, x in b.items()},
                         {k: torch.from_numpy(np.array(x)) for k, x in jout.items()})
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k], 1e-5, k)
    assert float(got["attn_geo_seen"]) > 0


def _distinct_maps(B, C, seed):
    """NHWC maps whose samples differ in scale and mask rate, so that every
    BatchNorm channel has a well-conditioned batch variance."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, H, C)).astype(np.float32) * np.linspace(0.5, 2.0, B, dtype=np.float32)[:, None, None, None]
    mask = (rng.uniform(size=(B, H, H, 1)) < np.linspace(0.3, 0.9, B)[:, None, None, None]).astype(np.float32)
    return x, mask


def _bn_stats_close(port_module, entries, mutated):
    """The port module's running statistics against the JAX ``batch_stats`` after one train-mode call."""
    sd = port_module.state_dict()
    n = 0
    for key, coll, path, _ in entries:
        if coll == "batch_stats":
            node = mutated
            for k in path:
                node = node[k]
            close(sd[key], node, 1e-4, key)
            n += 1
    assert n > 0


def test_coord_encoder_and_intr_head_use_batch_statistics_in_train_mode(graphs):
    """Under ``.train()`` the port's BatchNorms normalise with the batch
    statistics and move their running statistics by the flax rule (momentum
    0.9 in flax terms, the biased batch variance), as the JAX modules do under
    ``train=True``."""
    _, v, port, _ = graphs
    port = copy.deepcopy(port)
    cm, mask = _distinct_maps(4, 3, 8)
    jvars = {"params": v["params"]["coord_encoder"], "batch_stats": v["batch_stats"]["coord_encoder"]}
    want, mut = jax.jit(lambda vs, c, m: JCoordEncRes(latent_dim=64).apply(vs, c, m, True, mutable=["batch_stats"]))(
        jvars, jnp.asarray(cm), jnp.asarray(mask))
    port.coord_encoder.train()
    with torch.no_grad():
        got = port.coord_encoder(nchw(cm), nchw(mask))
    close(got, want, 1e-4, "coord encoder tokens")
    _bn_stats_close(port.coord_encoder, weights.map_coord_encoder(""), mut["batch_stats"])

    feat, _ = _distinct_maps(4, 768, 9)
    feat = feat[:, :4, :4]
    jvars = {"params": v["params"]["intr_head"], "batch_stats": v["batch_stats"]["intr_head"]}
    want, mut = JIntrHead().apply(jvars, jnp.asarray(feat), True, mutable=["batch_stats"])
    port.intr_head.train()
    with torch.no_grad():
        got = port.intr_proj(port.intr_head(nchw(feat)))
    close(got, want, 1e-4, "intrinsics parameters")
    entries = weights._bottleneck_conv("0", ("bottleneck1",)) + weights._bottleneck_conv("1", ("bottleneck2",))
    _bn_stats_close(port.intr_head, entries, mut["batch_stats"])
