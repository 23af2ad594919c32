"""PyTorch port vs the JAX package: the implicit decoder and its kernel's packing.

The plain ``Implicit.decode`` is held to the JAX XLA decode (fp32, 1e-4) and
to the JAX Pallas kernel in interpret mode (bf16 bounds of
tests/test_implicit_kernel.py). The CUDA kernel cannot run here; its weight
packing is held to the plain decode through a PyTorch emulation of the
kernel's arithmetic that reads only the packed arrays. The kernel itself is
compared on the card (tests/test_torch_port_gpu.py and chip_smoke.py).
"""

import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from zeroshape_tpu.models.implicit import Implicit as JImplicit
from zeroshape_tpu.ops.implicit_kernel import fused_decode as j_fused_decode
from zeroshape_tpu.ops.implicit_kernel import fused_supported as j_fused_supported
from zeroshape_tpu.ops.implicit_kernel import pack_decoder_params as j_pack
from zeroshape_tpu_torch import config
from zeroshape_tpu_torch import weights as W
from zeroshape_tpu_torch.models.graph_shape import ShapeGraph
from zeroshape_tpu_torch.models.implicit import Implicit
from zeroshape_tpu_torch.ops import implicit_kernel as ik

from test_torch_harness import close, np32, t
from test_torch_harness import give_memory_back  # noqa: F401 (autouse: frees the module's memory at its end)


def _bf16_bounds(got, want):
    a, b = np32(got), np32(want)
    np.testing.assert_allclose(a, b, rtol=8e-2, atol=2e-2)
    assert np.corrcoef(a, b)[0, 1] > 0.9999
    assert np.abs(a - b).mean() < 5e-3


@pytest.fixture(scope="module")
def small():
    """The fixture of tests/test_implicit_kernel.py:12-28, in both packages."""
    m = JImplicit(num_patches=16, latent_dim=32, n_channels=64, n_blocks_attn=2, n_layers_mlp=4,
                  num_heads=4, skip_in=(2,), drop_path=0.1)
    rng = np.random.default_rng(0)
    latent = rng.normal(size=(1, 17, 32)).astype(np.float32)
    points = rng.normal(size=(1, 300, 3)).astype(np.float32)
    v = m.init(jax.random.PRNGKey(0), jnp.asarray(latent), None, jnp.asarray(points))
    params = jax.tree.map(np.asarray, v["params"])
    port = Implicit(num_patches=16, latent_dim=32, n_channels=64, n_blocks_attn=2, n_layers_mlp=4,
                    num_heads=4, skip_in=(2,))
    W.load(port, W.convert(W.map_implicit("", (), 2, 5), params))
    return m, v, port.eval(), latent, points


def test_encode_caches_match_jax(small):
    m, v, port, latent, _ = small
    j_caches = m.apply(v, jnp.asarray(latent), method=lambda md, l: md.encode(l))
    with torch.no_grad():
        caches = port.encode(t(latent))
    for (k, vv), (jk, jv) in zip(caches, j_caches):
        close(k, jk, 1e-5)
        close(vv, jv, 1e-5)


def test_plain_decode_matches_jax_xla(small):
    m, v, port, latent, points = small
    occ_j, attn_j = m.apply(v, jnp.asarray(latent), None, jnp.asarray(points))
    with torch.no_grad():
        occ, attn = port.decode(port.encode(t(latent)), t(points))
    close(occ, occ_j, 1e-4)
    close(attn, attn_j, 1e-4)


@pytest.mark.parametrize("attn_mode", ["perhead", "blockdiag", "grouped"])
def test_plain_decode_matches_jax_pallas_interpret(small, attn_mode):
    m, v, port, latent, points = small
    caches = m.apply(v, jnp.asarray(latent), method=lambda md, l: md.encode(l))
    occ_k = j_fused_decode(
        jnp.asarray(points[0]), caches, j_pack(v["params"], n_blocks=2, n_mlp_linears=5),
        latent_len=17, n_blocks=2, n_heads=4, skip_in=(2,), n_mlp_linears=5, tile=128,
        interpret=True, attn_mode=attn_mode,
    )
    with torch.no_grad():
        occ, _ = port.decode(port.encode(t(latent)), t(points))
    _bf16_bounds(occ[0], occ_k)


def test_wrapper_on_cpu_is_the_plain_decode(small):
    _, _, port, latent, points = small
    with torch.no_grad():
        caches = port.encode(t(latent))
        got = ik.fused_decode(port, caches, t(points[0]))
        want = port.decode(caches, t(points))[0][0]
    assert torch.equal(got, want)


@pytest.mark.parametrize(
    "key, value",
    [
        (None, None),
        ("latent_dim", 64),
        ("num_heads", 4),
        ("impl.n_channels", 128),
        ("impl.att_blocks", 3),
        ("impl.mlp_layers", 4),
        ("impl.mlp_ratio", 2.0),
        ("impl.skip_in", [2]),
        ("rgb.encoder", "resnet"),
        ("rgb.encoder", "transformer"),
        ("depth.encoder", "transformer"),
        ("depth.encoder", None),
        ("impl.posenc_3D", 4),
        ("impl.posenc_perlayer", True),
        ("impl.mlp_layers", 0),
    ],
)
def test_fused_gate_matches_jax(key, value):
    """``kernel_supported`` is the JAX ``fused_supported``, and the packer
    accepts exactly the decoders it accepts, for the decoder that
    ``ShapeGraph.from_opt`` builds. A semantic decoder (an RGB encoder) is
    K1's: its trunk takes both streams outside the kernel. One with 3D
    positional encoding or without a skip MLP is not."""
    opt = config.full_opt()
    if key is not None:
        node, *path = [opt.arch] + key.split(".")
        for p in path[:-1]:
            node = node[p]
        node[path[-1]] = value
    with torch.device("meta"):  # shapes only; the decoder alone gets (uninitialised) storage
        graph = ShapeGraph.from_opt(opt)
    port = graph.impl_network.to_empty(device="cpu")
    assert ik.kernel_supported(port) == j_fused_supported(opt)
    if j_fused_supported(opt):
        ik.pack_decoder_params(port)
    else:
        with pytest.raises(ValueError, match="built for"):
            ik.pack_decoder_params(port)


def test_packing_rejects_unsupported_config(small):
    with pytest.raises(ValueError, match="built for"):
        ik.pack_decoder_params(small[2])


def _bf(x):
    return x.to(torch.bfloat16).float()


def emulate_kernel(packed, caches, pts, heads=8, hd=32):
    """The kernel's arithmetic on its packed operands, in PyTorch: bf16 matrix
    operands with fp32 accumulation, fp32 LayerNorm / softmax / residual.
    The operands are read back from the packed tile layouts."""
    k, v = (x[0].float() for x in ik.unpack_caches(*ik.pack_caches(caches)))  # the one sample's blocks
    packed = ik.unpack_decoder_params(packed)

    def w(name, *idx):
        x = packed[name]
        for i in idx:
            x = x[i]
        return x.float()

    def ln(x, gb):
        return _bf(F.layer_norm(x, x.shape[-1:], gb[0], gb[1], 1e-6))

    scale = hd**-0.5
    p = _bf(pts) @ w("point_w") + packed["point_b"]
    for blk in range(2):
        n = ln(p, packed["ln1"][blk])
        heads_out = []
        for h in range(heads):
            qkv = n @ w("qkv_w", blk, h) + packed["qkv_b"][blk, h]
            q, kk, vv = qkv[:, :hd], qkv[:, hd : 2 * hd], qkv[:, 2 * hd :]
            s = _bf(q) @ k[blk, h].T * scale
            s_self = (q * kk).sum(-1, keepdim=True) * scale
            mx = torch.maximum(s.max(-1, keepdim=True).values, s_self)
            e, e_self = torch.exp(s - mx), torch.exp(s_self - mx)
            den = e.sum(-1, keepdim=True) + e_self
            heads_out.append(_bf(e / den) @ v[blk, h] + e_self / den * vv)
        p = p + _bf(torch.cat(heads_out, -1)) @ w("proj_w", blk) + packed["proj_b"][blk]
        hid = _bf(F.gelu(ln(p, packed["ln2"][blk]) @ w("fc1_w", blk) + packed["fc1_b"][blk]))
        p = p + hid @ w("fc2_w", blk) + packed["fc2_b"][blk]
    x = ln(p, packed["lnf"])
    h = None
    for l in range(9):
        wl, wp, b = w("mlp_w", l), packed["mlp_wp"][l], packed["mlp_b"][l]
        if l == 0:
            y = x @ wl + _bf(pts) @ wp.float() + b
        elif wp is not None:  # skip layer: [state | pts | trunk] / sqrt(2)
            y = (torch.cat([h, x], -1) @ wl + _bf(pts) @ wp.float()) / math.sqrt(2.0) + b
        elif l == 8:
            y = h @ wl[:, None] + b
        else:
            y = h @ wl + b
        h = _bf(F.softplus(y, 100, 20)) if l < 8 else y
    return h[:, 0]


def _full_width_decoder():
    g = torch.Generator().manual_seed(1)
    impl = W.init_like_flax(Implicit(num_patches=196, latent_dim=256), seed=1).eval()
    with torch.no_grad():
        for name, prm in impl.named_parameters():
            if name.endswith("bias"):
                prm.add_(0.05 * torch.randn(prm.shape, generator=g))
    return impl, g


def test_packed_layout_round_trips_exactly_at_full_width():
    """pack -> unpack gives back every [in, out] matrix of the decoder bit for
    bit, built here from the module without the packer's helpers."""
    impl, g = _full_width_decoder()
    got = ik.unpack_decoder_params(ik.pack_decoder_params(impl))
    packed = ik.pack_decoder_params(impl)
    assert packed["stream"].dtype == torch.bfloat16 and packed["stream"].numel() * 2 == 4_587_520

    def want(lin):
        return lin.weight.detach().t().to(torch.bfloat16)

    for blk, b in enumerate(impl.blocks_attn):
        qkv = want(b.attn.qkv)
        for h in range(8):
            cols = [qkv[:, j * 256 + h * 32 : j * 256 + (h + 1) * 32] for j in range(3)]
            assert torch.equal(got["qkv_w"][blk, h], torch.cat(cols, 1))
        assert torch.equal(got["proj_w"][blk], want(b.attn.proj))
        assert torch.equal(got["fc1_w"][blk], want(b.mlp.fc1))
        assert torch.equal(got["fc2_w"][blk], want(b.mlp.fc2))
    for l, lin in enumerate(impl.impl_mlp.layers):
        w = want(lin)
        main = {0: w[3:], 8: w[:, 0]}.get(l, torch.cat([w[:256], w[259:]]) if l in (2, 4, 6) else w)
        assert torch.equal(got["mlp_w"][l], main)
    # the latent caches' tiles round-trip too, at L = 197 and at the most the kernel takes
    for L in (197, ik.MAX_LATENT):
        caches = [tuple(torch.randn(1, 8, L, 32, generator=g) for _ in range(2)) for _ in range(2)]
        flat, n = ik.pack_caches(caches)
        assert n == L and flat.numel() == 2 * 8 * 32 * (ik.MAX_LATENT + ik.V_KEYS)
        k, v = (x[0] for x in ik.unpack_caches(flat, L))  # [B, NB, H, L, hd] of the one sample
        for blk, (kk, vv) in enumerate(caches):
            assert torch.equal(k[blk], kk[0].to(torch.bfloat16))
            assert torch.equal(v[blk], vv[0].to(torch.bfloat16))


def test_kmajor_layout_is_the_swizzled_tile_layout():
    """Element (k, n) of a packed [K, N] matrix sits where the kernel's
    64-byte-swizzle wgmma descriptors read it: chunk k // 32, row n, 16-byte
    unit ((k % 32) // 8) ^ ((n // 2) % 4), element k % 8."""
    K, N = 64, 24
    w = torch.arange(K * N, dtype=torch.float32).reshape(K, N)
    flat = ik._kmajor(w)
    for k in range(K):
        for n in range(N):
            unit = ((k % 32) // 8) ^ ((n // 2) % 4)
            assert flat[(k // 32) * N * 32 + n * 32 + unit * 8 + k % 8] == w[k, n]


def test_packed_layout_matches_plain_decode_at_full_width():
    """Full width (C=256, 8 heads, L=197): the packed per-head qkv columns,
    the [state | trunk] skip rows and the separate point rows reproduce the
    plain decode within the kernel's bf16 bounds, read back from the packed
    tile layouts."""
    impl, g = _full_width_decoder()
    with torch.no_grad():
        impl.point_proj.proj.weight.mul_(8.0)
        for prm in impl.parameters():  # the kernel's operands are bf16-valued
            prm.copy_(_bf(prm))
        latent = torch.randn(1, 197, 256, generator=g)
        pts = torch.rand(1000, 3, generator=g) * 3 - 1.5
        caches = [(_bf(k), _bf(v)) for k, v in impl.encode(latent)]
        want = impl.decode(caches, pts[None])[0][0]
        got = emulate_kernel(ik.pack_decoder_params(impl), caches, pts)
    _bf16_bounds(got, want)


def test_ctypes_struct_and_constants_match_the_kernel_source():
    """The wrapper's ctypes mirror of ``struct DecoderParams`` and the layout
    constants the packer shares with the CUDA source agree with that source
    (which cannot be compiled here)."""
    src = open(os.path.join(os.path.dirname(ik.__file__), "..", "csrc", "implicit_decoder.cu")).read()
    body = src[src.index("struct DecoderParams {") : src.index("};", src.index("struct DecoderParams {"))]
    fields = re.findall(r"\*\s*(\w+)(?:\[NLIN\])?;", body)
    assert fields == [name for name, _ in ik._DecoderParams._fields_]
    const = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(const["MAX_LP"]) == ik.MAX_LATENT and int(const["V_KEYS"]) == ik.V_KEYS
    assert int(const["FC_CHUNK"]) == ik.FC_CHUNK and int(const["C"]) == ik.C and int(const["HID"]) == ik.HIDDEN
    assert int(const["ROWS"]) * int(const["NCONS"]) == ik.TILE_POINTS


def test_training_forward_matches_jax_with_shared_drop_path_masks(small):
    """``Implicit.forward(train=True)`` against ``__call__(deterministic=False)``
    with the same stochastic depth: an interceptor hands the JAX decoder's
    ``_dp_masks`` fixed masks (one sample dropped in each block), the port
    gets them as ``dp_masks``. Value and gradient with respect to the points."""
    from flax import linen as fnn

    m, v, port, latent, points = small
    latent2 = np.concatenate([latent, latent[:, ::-1] * 0.5])
    points2 = np.concatenate([points, points * 0.7])
    masks = [np.array([1 / 0.9, 0.0], np.float32), np.array([0.0, 1 / 0.9], np.float32)]

    def inject(next_fun, args, kwargs, context):
        if isinstance(context.module, JImplicit) and context.method_name == "_dp_masks":
            return [jnp.asarray(mk) for mk in masks]
        return next_fun(*args, **kwargs)

    w = np.random.default_rng(3).normal(size=(2, 300)).astype(np.float32)

    def run(p):
        return m.apply(v, jnp.asarray(latent2), None, p, deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})

    with fnn.intercept_methods(inject):
        occ_j, attn_j = jax.jit(run)(jnp.asarray(points2))
        grad_j = jax.jit(jax.grad(lambda p: jnp.sum(run(p)[0] * w)))(jnp.asarray(points2))
    port.train()
    try:
        pts = t(points2).requires_grad_(True)
        occ, attn = port(t(latent2), None, pts, train=True, dp_masks=[t(mk) for mk in masks])
        (occ * t(w)).sum().backward()
    finally:
        port.eval()
    close(occ.detach(), occ_j, 1e-4, "logits")
    close(attn.detach(), attn_j, 1e-4, "attention")
    close(pts.grad, grad_j, 1e-4, "gradient")
