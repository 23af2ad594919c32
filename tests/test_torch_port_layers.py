"""PyTorch port vs the JAX package: layers, image ops, ResNets, camera (fp32, 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeroshape_tpu import camera as jcam
from zeroshape_tpu.models import layers as jl
from zeroshape_tpu.models import resnet as jr
from zeroshape_tpu.models.graph_shape import intr_param2mtx as j_intr_param2mtx
from zeroshape_tpu.ops import image as jimg
from zeroshape_tpu_torch import camera as tcam
from zeroshape_tpu_torch import weights as W
from zeroshape_tpu_torch.models import layers as tl
from zeroshape_tpu_torch.models import resnet as tr
from zeroshape_tpu_torch.models.graph_shape import intr_param2mtx as t_intr_param2mtx
from zeroshape_tpu_torch.ops import image as timg

from test_torch_harness import close, load_port, nchw, nhwc, random_variables, t
from test_torch_harness import give_memory_back  # noqa: F401 (autouse: frees the module's memory at its end)

TOL = 1e-5


def _x(shape, seed=0, lo=None):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape).astype(np.float32) if lo is None else rng.uniform(lo, 1, shape).astype(np.float32)


@pytest.mark.parametrize("grid,cls", [(14, True), (4, False)])
def test_sincos_pos_embed(grid, cls):
    np.testing.assert_array_equal(
        tl.get_2d_sincos_pos_embed(256, grid, cls), jl.get_2d_sincos_pos_embed(256, grid, cls)
    )


def test_gelu_and_softplus():
    x = _x((4096,)) * 3
    close(tl.gelu_exact(t(x)), jl.gelu_exact(jnp.asarray(x)), TOL)
    x = _x((4096,)) * 0.3  # both sides of the 20/beta linear switch
    close(tl.softplus_beta(t(x), 100.0), jl.softplus_beta(jnp.asarray(x), 100.0), TOL)


def test_vit_block():
    x = _x((2, 9, 64))
    mod = jl.ViTBlock(num_heads=4)
    v = random_variables(mod, jnp.asarray(x))
    port = load_port(tl.ViTBlock(64, 4), W._vit_block("", ()), v)
    with torch.no_grad():
        close(port(t(x)), mod.apply(v, jnp.asarray(x)), TOL)


@pytest.mark.parametrize("kernel,stride,bias", [(3, 1, True), (3, 2, False), (1, 1, True)])
def test_conv_torch_padding(kernel, stride, bias):
    x = _x((2, 9, 9, 8))
    mod = jl.Conv(16, kernel, stride, use_bias=bias)
    v = random_variables(mod, jnp.asarray(x))
    port = load_port(tl.Conv(8, 16, kernel, stride, bias), W._conv("", (), bias=bias), v)
    with torch.no_grad():
        close(nhwc(port(nchw(x))), mod.apply(v, jnp.asarray(x)), TOL)


@pytest.mark.parametrize("kernel,stride,size", [(7, 2, 16), (3, 2, 15), (1, 2, 16), (3, 1, 8)])
def test_std_conv_same(kernel, stride, size):
    x = _x((1, size, size, 8))
    mod = jl.StdConvSame(16, kernel, stride)
    v = random_variables(mod, jnp.asarray(x))
    port = tl.StdConvSame(8, 16, kernel, stride)
    load_port(port, [("weight", "params", ("kernel",), W._CONV)], v)
    with torch.no_grad():
        close(nhwc(port(nchw(x))), mod.apply(v, jnp.asarray(x)), TOL)


@pytest.mark.parametrize("size", [15, 16])
def test_max_pool_same(size):
    x = _x((2, size, size, 4))
    close(nhwc(tl.max_pool_same(nchw(x), 3, 2)), jl.max_pool_same(jnp.asarray(x), 3, 2), TOL)


@pytest.mark.parametrize("kernel,flat", [(3, False), (1, True)])
def test_bottleneck_conv(kernel, flat):
    x = _x((3, 16) if flat else (2, 5, 5, 16))
    mod = jl.BottleneckConv(kernel=kernel)
    v = random_variables(mod, jnp.asarray(x))
    port = load_port(tl.BottleneckConv(16, kernel), W._bottleneck_conv("", ()), v)
    with torch.no_grad():
        y = port(t(x)) if flat else nhwc(port(nchw(x)))
    close(y, mod.apply(v, jnp.asarray(x)), TOL)


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("out_hw", [(13, 10), (4, 3)])
def test_resize_bilinear(align, out_hw):
    x = _x((2, 7, 6, 3))
    close(
        nhwc(timg.resize_bilinear(nchw(x), out_hw, align)),
        jimg.resize_bilinear(jnp.asarray(x), out_hw, align),
        TOL,
    )


def test_upsample_pool_and_coordmap():
    x = _x((2, 5, 6, 3))
    close(nhwc(timg.upsample2x(nchw(x))), jimg.upsample2x(jnp.asarray(x)), TOL)
    close(timg.adaptive_avg_pool_11(nchw(x)), jimg.adaptive_avg_pool_11(jnp.asarray(x)), TOL)
    cm = _x((1, 16, 16, 3))
    mask = (_x((1, 16, 16, 1), seed=1) > 0).astype(np.float32)
    for hw in ((8, 8), (16, 16)):
        got = timg.interpolate_coordmap(nchw(cm), nchw(mask), hw)
        want = jimg.interpolate_coordmap(jnp.asarray(cm), jnp.asarray(mask), hw)
        for g, w in zip(got, want):
            close(nhwc(g), w, TOL)


def _sub_entries(entries, prefix, n_path):
    """The entries under torch ``prefix``, re-rooted at that submodule."""
    return [(k[len(prefix):], c, p[n_path:], tf) for k, c, p, tf in entries if k.startswith(prefix)]


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_bottleneck_stride2(version):
    """The first block of stage 2: downsampling shortcut, stride on the 3x3."""
    x = _x((1, 8, 8, 256))
    if version == "v1":
        jmod, tmod = jr.BottleneckV1(mid=128, out=512, stride=2), tr.BottleneckV1(256, 128, 512, 2)
        entries = _sub_entries(W.map_resnet50("", ()), "layer2.0.", 1)
    else:
        jmod, tmod = jr.BottleneckV2(out=512, stride=2), tr.BottleneckV2(256, 512, 2)
        entries = _sub_entries(W.map_hybrid_vit("", ()), "patch_embed.backbone.stages.1.blocks.0.", 2)
    v = random_variables(jmod, jnp.asarray(x))
    port = load_port(tmod, entries, v)
    with torch.no_grad():
        close(nhwc(port(nchw(x))), jmod.apply(v, jnp.asarray(x)), 1e-4)


def test_resnetv2_stem_taps():
    x = _x((1, 32, 32, 3))
    mod = jr.ResNetV2Stem()
    v = random_variables(mod, jnp.asarray(x))
    entries = _sub_entries(W.map_hybrid_vit("", ()), "patch_embed.backbone.", 1)
    port = load_port(tr.ResNetV2Stem(), entries, v)
    with torch.no_grad():
        got = port(nchw(x))
    for g, w in zip(got, mod.apply(v, jnp.asarray(x))):
        close(nhwc(g), w, 1e-4)


def test_resnet50_trunk():
    x = _x((1, 32, 32, 3))
    mod = jr.ResNet50()
    v = random_variables(mod, jnp.asarray(x))
    port = load_port(tr.ResNet50(), W.map_resnet50("", ()), v)
    with torch.no_grad():
        feats, pooled = port(nchw(x))
    jfeats, jpooled = mod.apply(v, jnp.asarray(x))
    close(nhwc(feats["layer3"]), jfeats["layer3"], 1e-4)
    close(pooled, jpooled, 1e-4)


def test_intr_param2mtx():
    p = _x((4, 3))
    close(t_intr_param2mtx(t(p), 64, 48), j_intr_param2mtx(jnp.asarray(p), 64, 48), TOL)


def test_camera_geometry():
    rng = np.random.default_rng(0)
    depth = rng.uniform(0.5, 1.5, (2, 8, 6)).astype(np.float32)
    f = 1.3875 * 8
    intr = np.tile(np.array([[f, 0, 3.2], [0, f * 1.1, 4.1], [0, 0, 1]], np.float32), (2, 1, 1))
    close(tcam.get_pixel_grid(8, 6), jcam.get_pixel_grid(8, 6), 0)
    pts_t = tcam.unproj_depth(t(depth), t(intr))
    pts_j = jcam.unproj_depth(jnp.asarray(depth), jnp.asarray(intr))
    close(pts_t, pts_j, TOL)
    mask = (rng.uniform(size=(2, 48)) > 0.4).astype(np.float32)
    mask[1] = 0.0  # an empty sample: mean 0, scale 1
    for g, w in zip(tcam.valid_norm_fac(pts_t, t(mask)), jcam.valid_norm_fac(pts_j, jnp.asarray(mask))):
        close(g, w, TOL)
    for g, w in zip(tcam.normalize_seen_points(pts_t, t(mask)), jcam.normalize_seen_points(pts_j, jnp.asarray(mask))):
        close(g, w, TOL)


@pytest.mark.parametrize("shape", [(4, 5, 5, 8), (6, 1, 1, 16)])
def test_batchnorm_train_mode_follows_the_flax_rule(shape):
    """Train mode: batch statistics for the output, running statistics moved by
    flax's rule (momentum 0.9 in flax terms, the biased batch variance), not
    by ``nn.BatchNorm2d``'s (the unbiased one)."""
    x = _x(shape, 11) * 2.0 + 0.5
    mod = jl.BatchNorm()
    v = random_variables(mod, jnp.asarray(x), use_running_average=True)
    want, mut = mod.apply(v, jnp.asarray(x), use_running_average=False, mutable=["batch_stats"])
    port = load_port(tl.BatchNorm(shape[-1]), W._bn("", ()), v).train()
    with torch.no_grad():
        got = port(nchw(x))
    close(nhwc(got), want, TOL)
    close(port.running_mean, mut["batch_stats"]["bn"]["mean"], TOL)
    close(port.running_var, mut["batch_stats"]["bn"]["var"], TOL)
    torch_rule = torch.nn.BatchNorm2d(shape[-1]).train()
    torch_rule.load_state_dict(load_port(tl.BatchNorm(shape[-1]), W._bn("", ()), v).state_dict())
    with torch.no_grad():
        torch_rule(nchw(x))
    assert not torch.allclose(torch_rule.running_var, port.running_var)  # the known deviation


def test_drop_path_with_a_given_mask_and_drawn_masks():
    x = _x((4, 6, 8), 12)
    mask = np.array([1 / 0.9, 0.0, 1 / 0.9, 0.0], np.float32)
    want = jl.DropPath(0.1).apply({}, jnp.asarray(x), deterministic=False, mask=jnp.asarray(mask))
    dp = tl.DropPath(0.1).train()
    close(dp(t(x), t(mask)), want, TOL)
    np.testing.assert_array_equal(dp.eval()(t(x)).numpy(), x)  # identity outside training
    draws = tl.make_drop_path_mask(torch.Generator().manual_seed(0), 20000, 0.1)
    assert set(np.unique(draws.numpy()).tolist()) == {0.0, np.float32(1 / 0.9)}
    assert abs(float((draws > 0).float().mean()) - 0.9) < 0.01
