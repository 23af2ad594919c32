"""PyTorch port vs the JAX package: the non-default encoders' modules.

The NeRF positional encoding (its feature order exactly), ``BottleneckLinear``,
the two CLIP fusion blocks, ``ViTBlock``'s stochastic depth, ``CoordEmb``,
``CoordEncAtt``, ``RGBEncRes``, ``RGBEncAtt`` and the decoder options of
``Implicit`` (``posenc_3D``, ``pos_perlayer``, ``n_layers_mlp`` 0, the
semantic stream), at ``_tiny_opt`` widths (C 64, 2 blocks, 32^2 maps). The
JAX variables are drawn with numpy and reach the port through
``weights``' maps; fp32, 1e-4 per module.

Train mode runs both packages with the same stochastic depth: an
interceptor on the JAX ``DropPath.__call__`` hands each call with a rate its
fixed ``mask=`` (``Implicit._dp_masks`` for the decoder, as
tests/test_torch_port_train.py does), and the port gets the same masks as
``dp_masks``. Gradients of one module loss are compared leaf by leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from zeroshape_tpu.models import layers as jl
from zeroshape_tpu.models.coord_enc import CoordEmb as JCoordEmb
from zeroshape_tpu.models.coord_enc import CoordEncAtt as JCoordEncAtt
from zeroshape_tpu.models.implicit import Implicit as JImplicit
from zeroshape_tpu.models.rgb_enc import RGBEncAtt as JRGBEncAtt
from zeroshape_tpu.models.rgb_enc import RGBEncRes as JRGBEncRes
from zeroshape_tpu_torch import weights as W
from zeroshape_tpu_torch.models import layers as tl
from zeroshape_tpu_torch.models.coord_enc import CoordEmb, CoordEncAtt
from zeroshape_tpu_torch.models.implicit import Implicit
from zeroshape_tpu_torch.models.rgb_enc import RGBEncAtt, RGBEncRes

from test_torch_harness import close, load_port, nchw, random_variables, t
from test_torch_harness import few_threads, give_memory_back  # noqa: F401 (autouse fixtures)

TOL = 1e-4
C, HEADS, BLOCKS, H = 64, 4, 2, 32


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def masks_for(paths, B, rate, seed):
    """``{DropPath path: [B] mask}``: each mask keeps some samples (scaled by
    1 / keep) and drops others, so both paths of every residual run."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, p in enumerate(paths):
        keep = rng.uniform(size=B) < 0.5
        keep[i % B], keep[(i + 1) % B] = True, False
        out[p] = (keep / (1.0 - rate)).astype(np.float32)
    return out


def vit_paths(prefix, n_blocks):
    return [prefix + (f"block{i}", f"drop_path{j}") for i in range(n_blocks) for j in (1, 2)]


def port_masks(masks, prefix, n_blocks):
    """The port's ``dp_masks`` of a ViT trunk: each block's two masks."""
    return [(t(masks[prefix + (f"block{i}", "drop_path1")]), t(masks[prefix + (f"block{i}", "drop_path2")]))
            for i in range(n_blocks)]


def inject_drop_path(masks):
    """A ``flax.linen.intercept_methods`` interceptor that gives each JAX
    ``DropPath`` call with a rate and no mask its mask from ``masks`` (by
    the module's path)."""
    def inject(next_fun, args, kwargs, context):
        mod = context.module
        if (isinstance(mod, jl.DropPath) and context.method_name == "__call__" and mod.rate > 0
                and kwargs.get("mask") is None):
            kwargs = dict(kwargs, mask=jnp.asarray(masks[tuple(mod.path)]))
        return next_fun(*args, **kwargs)
    return inject


def grads_match(entries, jgrads, port, tol=TOL):
    """Each port parameter's gradient against the JAX gradient leaf mapped to
    it, within ``tol`` of the leaf's norm (+1e-7 of the whole gradient's)."""
    want = W.convert(entries, jgrads)
    total = float(np.sqrt(sum(float((g.double() ** 2).sum()) for g in want.values())))
    got = dict(port.named_parameters())
    assert set(want) == set(got), set(want) ^ set(got)
    bad = {k: float((got[k].grad - g).abs().max() / g.norm()) for k, g in want.items()
           if float((got[k].grad - g).abs().max()) > tol * float(g.norm()) + 1e-7 * total}
    assert not bad, f"gradient leaves off by more than {tol} of their norm: {bad}"
    assert sum(float(g.norm()) > 0 for g in want.values()) >= len(want) - 2  # the graph reaches the leaves


# ---------------------------------------------------------------------------
# layers.py
# ---------------------------------------------------------------------------

def test_nerf_posenc_feature_order_is_the_jax_order():
    """[x, sin(x), cos(x) at 2^0, sin, cos at 2^1, ...]: the order checked
    exactly against torch's own sin and cos of each frequency band, the
    values against the JAX encoding (XLA's sin and cos may land an ulp
    away; a feature out of order would be off by O(1)), and the widths."""
    x = _x((5, 7, 3))
    got = tl.nerf_posenc(t(x), 4).numpy()
    np.testing.assert_allclose(got, np.asarray(jl.nerf_posenc(jnp.asarray(x), 4)), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[..., :3], x)
    for f in range(4):
        xb = t(x) * 2.0**f
        np.testing.assert_array_equal(got[..., 3 + 6 * f: 6 + 6 * f], torch.sin(xb).numpy())
        np.testing.assert_array_equal(got[..., 6 + 6 * f: 9 + 6 * f], torch.cos(xb).numpy())
    np.testing.assert_allclose(tl.nerf_posenc(t(x), 2, include_input=False).numpy(),
                               np.asarray(jl.nerf_posenc(jnp.asarray(x), 2, include_input=False)), rtol=0, atol=1e-6)
    assert tl.nerf_posenc(t(x), 0) is not None and torch.equal(tl.nerf_posenc(t(x), 0), t(x))
    for F, inc in ((0, True), (4, True), (3, False)):
        assert tl.nerf_posenc_dim(3, F, inc) == jl.nerf_posenc_dim(3, F, inc) == tl.nerf_posenc(t(x), F, inc).shape[-1]


def test_bottleneck_linear():
    x = _x((2, 5, C))
    mod = jl.BottleneckLinear()
    v = random_variables(mod, jnp.asarray(x))
    port = load_port(tl.BottleneckLinear(C), W.map_bottleneck_linear("", ()), v)
    with torch.no_grad():
        close(port(t(x)), mod.apply(v, jnp.asarray(x)), TOL)


@pytest.mark.parametrize("attn, act", [(False, True), (False, False), (True, True), (True, False)])
def test_clip_fusion_blocks(attn, act):
    sem, clip = _x((2, 5, C), 1), _x((2, C), 2)
    mod = jl.CLIPFusionBlockAttn(2, HEADS, act) if attn else jl.CLIPFusionBlockConcat(2, act)
    v = random_variables(mod, jnp.asarray(sem), jnp.asarray(clip))
    port = tl.CLIPFusionBlockAttn(C, 2, HEADS, act) if attn else tl.CLIPFusionBlockConcat(C, 2, act)
    port = load_port(port, W.map_clip_fusion("", (), 2, attn), v)
    with torch.no_grad():
        close(port(t(sem), t(clip)), mod.apply(v, jnp.asarray(sem), jnp.asarray(clip)), TOL)
    port.train()  # the JAX blocks always run without their drop path
    with torch.no_grad():
        close(port(t(sem), t(clip)), mod.apply(v, jnp.asarray(sem), jnp.asarray(clip)), TOL)


def test_vit_block_drop_path_and_draws():
    """Both branches scaled by their own mask, as flax's ``drop_path1`` /
    ``drop_path2``; rate 0 and eval draw nothing; a generator's draws are
    the global batch's rows."""
    x = _x((3, 9, C))
    mod = jl.ViTBlock(num_heads=HEADS, drop_path=0.5)
    v = random_variables(mod, jnp.asarray(x))
    masks = masks_for([("drop_path1",), ("drop_path2",)], 3, 0.5, seed=4)
    with fnn.intercept_methods(inject_drop_path(masks)):
        want = mod.apply(v, jnp.asarray(x), deterministic=False)
    port = load_port(tl.ViTBlock(C, HEADS, drop_path=0.5), W._vit_block("", ()), v).train()
    with torch.no_grad():
        close(port(t(x), (t(masks[("drop_path1",)]), t(masks[("drop_path2",)]))), want, TOL, "masked")
        port.eval()
        close(port(t(x)), mod.apply(v, jnp.asarray(x)), TOL, "eval")
    assert port.dp_masks(3, torch.Generator().manual_seed(0)) == (None, None)
    g = torch.Generator().manual_seed(0)
    assert tl.ViTBlock(C, HEADS).train().dp_masks(3, g) == (None, None) and g.initial_seed() == 0
    m1, m2 = port.train().dp_masks(3, torch.Generator().manual_seed(1))
    draw = torch.rand(6, generator=torch.Generator().manual_seed(1))
    assert torch.equal(m1, (draw[:3] < 0.5).float() / 0.5) and torch.equal(m2, (draw[3:] < 0.5).float() / 0.5)


# ---------------------------------------------------------------------------
# coord_enc.py and rgb_enc.py
# ---------------------------------------------------------------------------

def _coord_inputs(B=2, seed=5):
    rng = np.random.default_rng(seed)
    cm = rng.normal(size=(B, H, H, 3)).astype(np.float32) * 0.5
    mask = rng.uniform(size=(B, H, H)) > np.linspace(0.3, 0.7, B)[:, None, None]
    return cm, mask


def test_coord_emb_windows_and_tokens():
    cm, mask = _coord_inputs()
    mod = JCoordEmb(C, 8, HEADS)
    v = random_variables(mod, jnp.asarray(cm), jnp.asarray(mask))
    port = load_port(CoordEmb(C, 8, HEADS), W.map_coord_emb("", ()), v)
    with torch.no_grad():
        got = port(nchw(cm), t(mask).bool())
    close(got, jax.jit(mod.apply)(v, jnp.asarray(cm), jnp.asarray(mask)), TOL)
    assert got.shape == (2, (H // 8) ** 2, C)
    assert "two_d_pos_embed" not in port.state_dict()  # a fixed table, not a weight
    assert {n for n, _ in port.named_parameters()} >= {"invalid_coord_token", "cls_token", "pos_embed.weight"}


@pytest.fixture(scope="module")
def coord_att():
    cm, mask = _coord_inputs(B=3, seed=6)
    mod = JCoordEncAtt(C, BLOCKS, HEADS, 8)
    v = random_variables(mod, jnp.asarray(cm), jnp.asarray(mask))
    entries = W.map_coord_encoder_att("", (), BLOCKS)
    port = load_port(CoordEncAtt(C, BLOCKS, HEADS, 8), entries, v)
    return mod, v, port, entries, cm, mask


def test_coord_enc_att_eval(coord_att):
    mod, v, port, _, cm, mask = coord_att
    with torch.no_grad():
        got = port(nchw(cm), t(mask).bool())
    close(got, jax.jit(mod.apply)(v, jnp.asarray(cm), jnp.asarray(mask)), TOL)
    assert got.shape == (3, 1 + (H // 8) ** 2, C)


def test_coord_enc_att_train_masks_and_gradients(coord_att):
    mod, v, port, entries, cm, mask = coord_att
    masks = masks_for(vit_paths((), BLOCKS), 3, 0.1, seed=7)
    w = _x((3, 1 + (H // 8) ** 2, C), 8)

    def loss(params):
        out = mod.apply({"params": params}, jnp.asarray(cm), jnp.asarray(mask), deterministic=False)
        return jnp.sum(out * w), out

    with fnn.intercept_methods(inject_drop_path(masks)):
        (_, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"])
    port.train().zero_grad()
    try:
        out = port(nchw(cm), t(mask).bool(), dp_masks=port_masks(masks, (), BLOCKS))
        (out * t(w)).sum().backward()
    finally:
        port.eval()
    close(out.detach(), want, TOL)
    grads_match(entries, jgrads, port)


def _rgb(B=3, seed=9):
    x = np.random.default_rng(seed).uniform(0, 1, (B, H, H, 3)).astype(np.float32)
    return x * np.linspace(0.3, 1.0, B)[:, None, None, None].astype(np.float32)


@pytest.mark.parametrize("train", [False, True])
def test_rgb_enc_res(train):
    """Eval: running statistics. Train: batch statistics by the flax rule and
    the running statistics they move. At 64^2 on 4 samples that differ in
    scale (as tests/test_torch_port_graph.py conditions the coordinate
    encoder's ResNet): the deepest maps are 2x2 and the pooled ones 1x1, so
    nearly alike samples would leave the batch variances ill-conditioned."""
    Hr, B = 64, 4
    rng = np.random.default_rng(9)
    x = (rng.normal(size=(B, Hr, Hr, 3)) * np.linspace(0.5, 2.0, B)[:, None, None, None]).astype(np.float32)
    mod = JRGBEncRes(latent_dim=C)
    v = random_variables(mod, jnp.asarray(x), False)
    entries = W.map_coord_encoder("", (), proj="rgb_feat_proj")
    port = load_port(RGBEncRes(C), entries, v).train(train)
    with torch.no_grad():
        got = port(nchw(x))
    if train:
        want, mut = jax.jit(lambda vs, r: mod.apply(vs, r, True, mutable=["batch_stats"]))(v, jnp.asarray(x))
        stats = W.convert([e for e in entries if e[1] == "batch_stats"], {}, mut["batch_stats"])
        sd = port.state_dict()
        for k, s in stats.items():
            close(sd[k], s, TOL, k)
    else:
        want = jax.jit(lambda vs, r: mod.apply(vs, r, False))(v, jnp.asarray(x))
    close(got, want, TOL)
    assert got.shape == (B, 1 + (Hr // 16) ** 2, C)


@pytest.fixture(scope="module")
def rgb_att():
    x = _rgb(seed=10)
    mod = JRGBEncAtt(img_size=H, embed_dim=C, n_blocks=BLOCKS, num_heads=HEADS, win_size=8)
    v = random_variables(mod, jnp.asarray(x))
    entries = W.map_rgb_encoder_att("", (), BLOCKS)
    port = load_port(RGBEncAtt(H, C, BLOCKS, HEADS, 8), entries, v)
    return mod, v, port, entries, x


def test_rgb_enc_att_eval(rgb_att):
    mod, v, port, _, x = rgb_att
    with torch.no_grad():
        got = port(nchw(x))
    close(got, mod.apply(v, jnp.asarray(x)), TOL)
    assert got.shape == (3, 1 + (H // 8) ** 2, C)
    assert "pos_embed" not in port.state_dict()  # a fixed table, not a weight


def test_rgb_enc_att_train_masks_and_gradients(rgb_att):
    mod, v, port, entries, x = rgb_att
    masks = masks_for(vit_paths((), BLOCKS), 3, 0.1, seed=11)
    w = _x((3, 1 + (H // 8) ** 2, C), 12)

    def loss(params):
        out = mod.apply({"params": params}, jnp.asarray(x), deterministic=False)
        return jnp.sum(out * w), out

    with fnn.intercept_methods(inject_drop_path(masks)):
        (_, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"])
    port.train().zero_grad()
    try:
        out = port(nchw(x), dp_masks=port_masks(masks, (), BLOCKS))
        (out * t(w)).sum().backward()
    finally:
        port.eval()
    close(out.detach(), want, TOL)
    grads_match(entries, jgrads, port)


# ---------------------------------------------------------------------------
# implicit.py: the decoder options
# ---------------------------------------------------------------------------

IMPLICIT_CASES = {
    "posenc_3D": dict(posenc_3D=4),
    "pos_perlayer": dict(pos_perlayer=True),
    "pred_head": dict(n_layers_mlp=0),
    "semantic": dict(semantic=True),
}


@pytest.mark.parametrize("case", sorted(IMPLICIT_CASES))
def test_implicit_option(case):
    """Eval decode (logits and attention), and the training forward with the
    JAX decoder's ``_dp_masks`` injected: value and every gradient leaf."""
    kw = IMPLICIT_CASES[case]
    n_mlp = kw.get("n_layers_mlp", 4)
    semantic = kw.get("semantic", False)
    latent_dim = 2 * 32 if semantic else 32
    jkw = dict(num_patches=16, latent_dim=latent_dim, n_channels=C, n_blocks_attn=2, n_layers_mlp=n_mlp,
               num_heads=HEADS, skip_in=(2,), drop_path=0.1, semantic=semantic,
               posenc_3D=kw.get("posenc_3D", 0), pos_perlayer=kw.get("pos_perlayer", False))
    m = JImplicit(**jkw)
    rng = np.random.default_rng(13)
    ld = rng.normal(size=(2, 17, 32)).astype(np.float32)
    ls = rng.normal(size=(2, 17, 32)).astype(np.float32) if semantic else None
    pts = rng.normal(size=(2, 50, 3)).astype(np.float32) * 0.5
    jls = None if ls is None else jnp.asarray(ls)
    v = random_variables(m, jnp.asarray(ld), jls, jnp.asarray(pts))
    entries = W.map_implicit("", (), 2, n_mlp + 1 if n_mlp else 0)
    port = Implicit(num_patches=16, latent_dim=latent_dim, n_channels=C, n_blocks_attn=2, n_layers_mlp=n_mlp,
                    num_heads=HEADS, skip_in=(2,), semantic=semantic, posenc_3D=jkw["posenc_3D"],
                    pos_perlayer=jkw["pos_perlayer"])
    load_port(port, entries, v)
    assert (port.pred_head is not None) == (n_mlp == 0) and (port.impl_mlp is None) == (n_mlp == 0)
    pls = None if ls is None else t(ls)
    want = jax.jit(m.apply)(v, jnp.asarray(ld), jls, jnp.asarray(pts))
    with torch.no_grad():
        got = port.decode(port.encode(t(ld), pls), t(pts))
    close(got[0], want[0], TOL, "logits")
    close(got[1], want[1], TOL, "attention")

    masks = [np.array([1 / 0.9, 0.0], np.float32), np.array([0.0, 1 / 0.9], np.float32)]
    w = rng.normal(size=(2, 50)).astype(np.float32)

    def inject(next_fun, args, kwargs, context):
        if isinstance(context.module, JImplicit) and context.method_name == "_dp_masks":
            return [jnp.asarray(mk) for mk in masks]
        return next_fun(*args, **kwargs)

    def loss(params):
        occ, _ = m.apply({"params": params}, jnp.asarray(ld), jls, jnp.asarray(pts), deterministic=False)
        return jnp.sum(occ * w), occ

    with fnn.intercept_methods(inject):
        (_, occ_j), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"])
    port.train().zero_grad()
    try:
        occ, _ = port(t(ld), pls, t(pts), train=True, dp_masks=[t(mk) for mk in masks])
        (occ * t(w)).sum().backward()
    finally:
        port.eval()
    close(occ.detach(), occ_j, TOL, "training logits")
    grads_match(entries, jgrads, port)
    if semantic:
        with pytest.raises(ValueError, match="latent_semantic"):
            port.encode(t(ld))


# ---------------------------------------------------------------------------
# seeded initialisation of the new modules
# ---------------------------------------------------------------------------

def test_seeded_init_of_the_new_modules():
    """``weights.init_like_flax`` draws the new parameters as flax does: the
    cls and invalid-coordinate tokens normal(0.02), Dense and conv kernels
    lecun-normal, ``pred_head`` xavier-uniform; biases zero, norms identity."""
    cm, mask = _coord_inputs()
    cases = [
        (JCoordEncAtt(C, BLOCKS, HEADS, 8), CoordEncAtt(C, BLOCKS, HEADS, 8),
         W.map_coord_encoder_att("", (), BLOCKS), (jnp.asarray(cm), jnp.asarray(mask))),
        (JRGBEncAtt(img_size=H, embed_dim=C, n_blocks=BLOCKS, num_heads=HEADS, win_size=8),
         RGBEncAtt(H, C, BLOCKS, HEADS, 8), W.map_rgb_encoder_att("", (), BLOCKS), (jnp.asarray(_rgb()),)),
        (JImplicit(num_patches=16, latent_dim=32, n_channels=C, n_layers_mlp=0, num_heads=HEADS),
         Implicit(num_patches=16, latent_dim=32, n_channels=C, n_layers_mlp=0, num_heads=HEADS),
         W.map_implicit("", (), 2, 0), (jnp.zeros((1, 17, 32)), None, jnp.zeros((1, 5, 3)))),
    ]
    for jmod, port, entries, args in cases:
        v = jax.tree.map(np.asarray, jax.jit(jmod.init)({"params": jax.random.PRNGKey(0)}, *args))
        want = W.convert(entries, v["params"])
        got = W.init_like_flax(port, seed=0).state_dict()
        for k, w in want.items():
            g = got[k]
            if torch.all(w == w.reshape(-1)[0]):
                assert torch.equal(g, w), k
            elif w.numel() >= 64:  # two draws of n: within 4 standard errors of each other
                s, n = float(w.std()), w.numel()
                assert abs(float(g.std()) - s) < 4 * s / np.sqrt(n), k
                assert abs(float(g.mean()) - float(w.mean())) < 4 * s * np.sqrt(2 / n), k
