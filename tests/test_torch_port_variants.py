"""PyTorch port vs the JAX package: the shape graph's non-default architectures.

``ShapeGraph.from_opt`` of ``config.tiny_opt(32)`` (C 64, full-width DPT) in
two variants that hold the cases of tests/test_graphs.py:155-186 and the
posenc options: both transformer encoders (the coordinate map downsampled
by 2; ``config.encoders_opt`` at tiny width), and the ResNet RGB encoder
with the decoder's 3D positional encoding added at every layer. Each runs
on numpy-drawn JAX variables converted by ``weights.from_flax(opt=)``:

* ``encode_image``: ``latent_semantic`` (the RGB encoder on the image, one
  module) 1e-4, ``latent_depth`` (through the DPT, the unprojection and the
  coordinate encoder) 1e-3; the eval forward's ``pred_sample_occ`` 1e-3;
* the AdamW group of every parameter equals the JAX ``param_group_labels``;
* ``recon.reconstruct`` of the semantic graph on the CPU against the same
  pipeline in JAX (latents, caches, hierarchical level grid);
* a checkpoint written by the port's trainer and read by the JAX importer
  (``load_torch_checkpoint``: nothing missing, the RGB encoder the only
  keys it does not know) and by the port's own loader.

The training step of these encoders is tests/test_torch_port_variants_step.py.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _batch
from zeroshape_tpu.metrics import eval3d as je
from zeroshape_tpu.models.graph_shape import ShapeGraph as JShapeGraph
from zeroshape_tpu.parallel import train as jtrain
from zeroshape_tpu.runtime.checkpoint import load_torch_checkpoint
from zeroshape_tpu_torch import config, recon, weights
from zeroshape_tpu_torch.models.graph_shape import ShapeGraph
from zeroshape_tpu_torch.parallel import train as ptrain
from zeroshape_tpu_torch.runtime import checkpoint, engine_base

from test_torch_harness import close, random_variables
from test_torch_harness import few_threads, give_memory_back  # noqa: F401 (autouse fixtures)

H = 32
SHARPEN = 25.0
VARIANTS = {
    "transformers": {"depth": {"encoder": "transformer", "n_blocks": 2, "dsp": 2},
                     "rgb": {"encoder": "transformer", "n_blocks": 2}},
    "rgb_resnet_posenc": {"rgb": {"encoder": "resnet", "n_blocks": 2},
                          "impl": {"posenc_3D": 4, "posenc_perlayer": True}},
}


def variant_opt(name):
    return config.override_options(config.tiny_opt(H), {"arch": copy.deepcopy(VARIANTS[name])})


_BUILT = {}


@pytest.fixture(scope="module", autouse=True)
def _drop_built():
    yield
    _BUILT.clear()


def built(name):
    """The variant's options, JAX graph and variables, port graph and batch,
    built once for the module (each holds ~1.3 GB: the DPT twice)."""
    if name not in _BUILT:
        _BUILT[name] = _build(name)
    return _BUILT[name]


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant(request):
    return built(request.param)


def _build(name):
    opt = variant_opt(name)
    jmodel = JShapeGraph.from_opt(opt)
    b = _batch(B=2, H=H, n_pts=40, seed=1)
    v = random_variables(jmodel, b, train=False, seed=4)
    head = v["params"]["dpt_depth"]["head_conv3"]  # inside the depth head's clamp, with spread
    head["kernel"] = head["kernel"] * 1e-2
    head["bias"] = np.full_like(head["bias"], 0.5)
    port = weights.load(ShapeGraph.from_opt(opt), weights.from_flax(v["params"], v["batch_stats"], opt=opt)).eval()
    rgb, mask = config.synthetic_image(H, seed=4, B=2)
    b = {k: np.asarray(x) for k, x in b.items()}
    b.update(rgb_input_map=rgb, mask_input_map=mask)
    return name, opt, jmodel, v, port, b


def test_forward_matches_jax(variant):
    name, opt, jmodel, v, port, b = variant
    want = jax.jit(lambda vs, x: jmodel.apply(vs, x, train=False))(v, {k: jnp.asarray(x) for k, x in b.items()})
    with torch.no_grad():
        got = port({k: torch.tensor(x) for k, x in b.items()}, train=False)
    assert got["latent_depth"].shape == (2, 1 + (H // 16) ** 2, 64)
    close(got["latent_depth"], want["latent_depth"], 1e-3, f"{name}: latent_depth")
    if want["latent_semantic"] is None:
        assert got["latent_semantic"] is None
    else:
        assert got["latent_semantic"].shape == got["latent_depth"].shape
        close(got["latent_semantic"], want["latent_semantic"], 1e-4, f"{name}: latent_semantic")
    assert float(got["pred_sample_occ"].std()) > 1e-3  # a live field
    close(got["pred_sample_occ"], want["pred_sample_occ"], 1e-3, f"{name}: pred_sample_occ")
    close(got["attn"], want["attn"], 1e-3, f"{name}: attention")


def test_param_groups_match_jax(variant):
    """Every parameter lands in the AdamW group the JAX rules give its leaf:
    the cls tokens ``[1, 1, C]`` decay, the invalid-coordinate token ``[C]``
    does not."""
    _, opt, _, v, port, _ = variant
    jlabels = dict(jax.tree_util.tree_flatten_with_path(jtrain.param_group_labels(v["params"]))[0])
    labels = ptrain.param_group_labels(port)
    seen = set()
    for key, coll, path, _ in weights.map_shape_graph(opt=opt):
        if coll == "params":
            assert labels[key] == jlabels[tuple(jax.tree_util.DictKey(k) for k in path)], key
            seen.add(key)
    assert len(seen) == len(jlabels)
    rest = set(labels) - seen  # refinenet4's first unit, never executed, has no JAX leaf
    assert rest and all("refinenet4.resConfUnit1." in k for k in rest)
    for k, lab in labels.items():
        if k.endswith("cls_token") and not k.startswith("dpt_depth."):
            assert lab == "scratch_decay", k
        if k.endswith("invalid_coord_token"):
            assert lab == "scratch_nodecay", k


def test_reconstruct_semantic_graph_matches_jax():
    """Image -> both latent streams -> caches -> hierarchical level grid at
    vox 16 through ``recon.reconstruct`` on the CPU (the plain decode: K1
    takes only a CUDA tensor) against the same pipeline in JAX."""
    _, opt, jmodel, v, port, b = built("transformers")
    vox, capacity = 16, 40
    one = {k: b[k][:1] for k in ("rgb_input_map", "mask_input_map")}
    caches = jax.jit(lambda vs, x: jmodel.apply(vs, x, method=lambda m, b: m.impl_network.encode(
        *(lambda o: (o["latent_depth"], o["latent_semantic"]))(m.encode_image(b)))))(
        v, {k: jnp.asarray(x) for k, x in one.items()})
    decode = jax.jit(lambda vs, c, p: jmodel.apply(vs, c, p, method=lambda m, c, p: m.impl_network.decode(c, p)[0]))

    def j_decode(pts):
        return SHARPEN * decode(v, caches, pts)

    jlevel, jn = je.occupancy_grid_hierarchical(j_decode, vox, capacity=capacity, return_stats=True)
    model = recon.ReconModel(port, None, SHARPEN, torch.device("cpu")).repack()
    assert model.packed is None  # K1's weights are packed on CUDA only
    world, _, _, n_active, level = recon.reconstruct(model, one, torch.Generator().manual_seed(0), vox_res=vox,
                                                     capacity=capacity, num_points=300, return_level=True)
    close(level, jlevel, 1e-3, "level grid")
    assert n_active.tolist() == np.asarray(jn).tolist()
    assert world.shape == (300, 3) and torch.isfinite(world).all()


def test_checkpoint_round_trip(tmp_path):
    """The trainer's checkpoint of a semantic graph: the JAX importer (which
    maps the ResNet coordinate encoder only) maps every leaf it knows with
    nothing missing, and its only unknown keys are the RGB encoder's; the
    port's own loader (``--load``, strict) restores every tensor bit for
    bit."""
    _, opt, _, v, port, _ = built("rgb_resnet_posenc")
    path = engine_base.save_checkpoint(str(tmp_path), port, ptrain.make_optimizer(port, opt.optim), 1, 7, 0.5, 1,
                                       latest=True)
    try:
        params, stats, report, meta = load_torch_checkpoint(path, graph="shape", impl_blocks=2, impl_mlp_linears=5)
        assert report["missing"] == []
        assert report["unconsumed"] and all(k.startswith("rgb_encoder.") for k in report["unconsumed"])
        assert {k for k in port.state_dict() if k.startswith("rgb_encoder.")
                and not k.endswith("num_batches_tracked")} == set(report["unconsumed"])
        assert meta["iter"] == 7
        for coll, got in (("params", params), ("batch_stats", stats)):
            want = {p: leaf for p, leaf in jax.tree_util.tree_flatten_with_path(v[coll])[0]
                    if p[0].key != "rgb_encoder"}
            got_flat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
            assert set(got_flat) == set(want)
            for p, leaf in want.items():
                np.testing.assert_array_equal(got_flat[p], np.asarray(leaf), err_msg=str(p))
        fresh = ShapeGraph.from_opt(opt)
        checkpoint.apply_weights(fresh, checkpoint.load_reference_ckpt(path), strict=True)
        want = port.state_dict()
        assert all(torch.equal(x, want[k]) for k, x in fresh.state_dict().items())
    finally:
        for f in tmp_path.iterdir():
            f.unlink()
