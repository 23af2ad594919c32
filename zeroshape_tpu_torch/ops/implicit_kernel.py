"""Fused implicit-decoder kernel: weight packing, build, and wrapper.

Counterpart of ``zeroshape_tpu/ops/implicit_kernel.py`` (``fused_decode``,
``fused_decode_batched``, ``pack_decoder_params``; :func:`kernel_supported`
is ``fused_supported``).
The kernel itself is CUDA C++ for ``sm_90a`` in ``csrc/implicit_decoder.cu``;
its header comment gives the design and the bound. It is compiled with
``nvcc`` at first use into ``csrc/build/`` and bound with ctypes.

:func:`fused_decode` (one sample) and :func:`fused_decode_batched` (B
samples, one launch) take a CPU tensor to the plain ``Implicit.decode``; a
CUDA tensor goes to the kernel, or the wrapper raises. They never fall back.
"""

from __future__ import annotations

import ctypes

import torch

from zeroshape_tpu_torch.ops import _build

_SOURCE, _NAME = "implicit_decoder.cu", "zs_implicit_decoder"

# the shapes the kernel is compiled for (the shipped decoder)
C, N_HEADS, HEAD_DIM, N_BLOCKS, HIDDEN, N_LINEARS = 256, 8, 32, 2, 1024, 9
SKIP_IN = (2, 4, 6)
MAX_LATENT = 208  # latent keys the kernel's score product covers (its N)
V_KEYS = 224  # latent rows of a packed V tile (7 chunks of 32)
FC_CHUNK = 64  # hidden columns of one fc1 / fc2 product pair


def kernel_supported(impl) -> bool:
    """Whether ``impl`` has the shapes the kernel is built for: the port's
    ``fused_supported`` (``zeroshape_tpu/ops/implicit_kernel.py:54-72``).
    A decoder without them decodes with the plain ``Implicit.decode``.

    The latent trunk runs outside the kernel, so a semantic decoder (whose
    trunk takes both streams, 2 x 256 wide) is accepted like any other with
    256-wide latents per stream. The skip MLP must take the raw points: a
    first linear of 3 + C inputs (no 3D positional encoding), and there must
    be one (``mlp_layers`` 8, not 0)."""
    blocks, mlp = impl.blocks_attn, impl.impl_mlp
    return (
        impl.latent_proj.in_features == 256 * (2 if impl.semantic else 1)
        and impl.point_proj.proj.out_features == C
        and impl.num_heads == N_HEADS
        and len(blocks) == N_BLOCKS
        and blocks[0].mlp.fc1.out_features == HIDDEN
        and mlp is not None
        and len(mlp.layers) == N_LINEARS
        and mlp.layers[0].in_features == 3 + C
        and tuple(mlp.skip_in) == SKIP_IN
    )


def _check_module(impl):
    """Raise unless :func:`kernel_supported`."""
    if not kernel_supported(impl):
        raise ValueError(
            "the fused decoder kernel is built for latent_dim 256, C=256, 8 heads, 2 blocks, "
            "mlp_ratio 4, 9 skip-MLP linears with skips at (2, 4, 6), no 3D positional encoding"
        )


def _swizzle(x):
    """Move the four 16-byte units of each 64-byte row n of ``x [..., N, 4,
    8]`` to unit ``u ^ ((n // 2) % 4)``, the 64-byte swizzle of the wgmma
    descriptors; it is its own inverse."""
    N = x.shape[-3]
    idx = torch.arange(4, device=x.device) ^ ((torch.arange(N, device=x.device) >> 1) & 3)[:, None]
    return torch.gather(x, -2, idx[..., None].expand(x.shape))


def _kmajor(w):
    """``w [..., K, N]`` -> flat ``[..., K * N]`` in the kernel's shared-memory
    layout: 32-deep K chunks, each N rows of 32 values (64 bytes), swizzled.
    A tile of kt rows of K is kt / 32 consecutive chunks."""
    *b, K, N = w.shape
    return _swizzle(w.transpose(-1, -2).reshape(*b, N, K // 32, 4, 8).transpose(-3, -4)).reshape(*b, -1)


def _unkmajor(flat, K, N):
    """Inverse of :func:`_kmajor` for one ``[K, N]`` matrix."""
    return _swizzle(flat.reshape(K // 32, N, 4, 8)).transpose(0, 1).reshape(N, K).t()


def _stream_plan():
    """The weight stream's matrices in the kernel's read order: ``(name,
    block or layer, index, K, N)``; ``index`` is the head pair (qkv) or the
    64-column hidden chunk (fc1, fc2)."""
    plan = []
    for blk in range(N_BLOCKS):
        plan += [("qkv_w", blk, hp, C, 6 * HEAD_DIM) for hp in range(N_HEADS // 2)]
        plan.append(("proj_w", blk, None, C, C))
        for ch in range(HIDDEN // FC_CHUNK):
            plan += [("fc1_w", blk, ch, C, FC_CHUNK), ("fc2_w", blk, ch, FC_CHUNK, C)]
    plan += [("mlp_w", l, None, 2 * C if l in SKIP_IN else C, C) for l in range(N_LINEARS - 1)]
    return plan


STREAM_ELEMS = sum(K * N for *_, K, N in _stream_plan())  # 2,293,760 bf16 = 4,587,520 bytes
CACHE_ELEMS = N_BLOCKS * N_HEADS * HEAD_DIM * (MAX_LATENT + V_KEYS)  # 221,184 bf16 = 442,368 bytes a sample
TILE_POINTS = 128  # points a block decodes per pass over the weight stream


def streamed_bytes(P):
    """Bytes one launch on P points streams from L2 into shared memory: every
    128-point tile reads all weight and cache tiles once. A count from
    shapes, not a measurement."""
    return -(-P // TILE_POINTS) * 2 * (STREAM_ELEMS + CACHE_ELEMS)


def _matrices(impl):
    """The decoder's bf16 ``[in, out]`` matrices and fp32 vectors, as
    :func:`unpack_decoder_params` returns them.

    qkv columns are regrouped per head into ``[q_h | k_h | v_h]``. Skip
    layers take the reference concat order ``[state | pts | trunk]``
    (``implicit.py:143-145``); their point rows move to a separate ``[3, C]``
    array and the rest keep ``[state | trunk]`` (cf. the reorder at
    ``implicit_kernel.py:433-441``). The last linear is a ``[C]`` vector.
    """
    def wt(lin):  # torch [out, in] -> [in, out]
        return lin.weight.detach().t().float()

    def bf(x):
        return x.to(torch.bfloat16).contiguous()

    def f32(x):
        return x.detach().float().contiguous()

    def ln(norm):
        return torch.stack([norm.weight.detach(), norm.bias.detach()])

    blocks = impl.blocks_attn
    head_cols = [
        torch.cat([torch.arange(j * C + h * HEAD_DIM, j * C + (h + 1) * HEAD_DIM) for j in range(3)])
        for h in range(N_HEADS)
    ]
    m = {
        "point_w": bf(wt(impl.point_proj.proj)),
        "point_b": f32(impl.point_proj.proj.bias),
        "ln1": f32(torch.stack([ln(b.norm1) for b in blocks])),
        "qkv_w": bf(torch.stack([torch.stack([wt(b.attn.qkv)[:, c] for c in head_cols]) for b in blocks])),
        "qkv_b": f32(torch.stack([torch.stack([b.attn.qkv.bias[c] for c in head_cols]) for b in blocks])),
        "proj_w": bf(torch.stack([wt(b.attn.proj) for b in blocks])),
        "proj_b": f32(torch.stack([b.attn.proj.bias for b in blocks])),
        "ln2": f32(torch.stack([ln(b.norm2) for b in blocks])),
        "fc1_w": bf(torch.stack([wt(b.mlp.fc1) for b in blocks])),
        "fc1_b": f32(torch.stack([b.mlp.fc1.bias for b in blocks])),
        "fc2_w": bf(torch.stack([wt(b.mlp.fc2) for b in blocks])),
        "fc2_b": f32(torch.stack([b.mlp.fc2.bias for b in blocks])),
        "lnf": f32(ln(impl.norm)),
        "mlp_w": [],
        "mlp_wp": [],
        "mlp_b": [],
    }
    for l, lin in enumerate(impl.impl_mlp.layers):
        w = wt(lin)
        if l == 0:  # rows [pts | trunk]
            main, pts_rows = w[3:], w[:3]
        elif l in SKIP_IN:  # rows [state | pts | trunk]
            main, pts_rows = torch.cat([w[:C], w[C + 3 :]]), w[C : C + 3]
        else:
            main, pts_rows = w, None
        if l == N_LINEARS - 1:
            main = main[:, 0]
        m["mlp_w"].append(bf(main))
        m["mlp_wp"].append(None if pts_rows is None else bf(pts_rows))
        m["mlp_b"].append(f32(lin.bias))
    return m


def _plan_matrix(m, name, i, j):
    """The ``[K, N]`` matrix of one entry of :func:`_stream_plan`."""
    if name == "qkv_w":
        return torch.cat([m["qkv_w"][i, 2 * j], m["qkv_w"][i, 2 * j + 1]], 1)
    if name == "fc1_w":
        return m["fc1_w"][i][:, j * FC_CHUNK : (j + 1) * FC_CHUNK]
    if name == "fc2_w":
        return m["fc2_w"][i][j * FC_CHUNK : (j + 1) * FC_CHUNK]
    return m[name][i]


def pack_decoder_params(impl) -> dict:
    """The decoder's weights in the kernel's layout (on its device).

    Every matrix the kernel multiplies by goes, in bf16 and in the order the
    kernel reads it (:func:`_stream_plan`), into one flat ``"stream"``: the
    qkv columns of a head pair, proj, then fc1 and fc2 in 64-column chunks of
    the hidden layer, for each block; then the 8 hidden skip-MLP linears.
    Each matrix is laid out as :func:`_kmajor` says, so that the kernel copies
    it tile by tile into shared memory as it is. Biases, LayerNorms, the
    point rows of the skip MLP and the width-1 last linear (``"out_w"``) stay
    apart, fp32 or bf16 as :func:`_matrices` gives them.
    """
    _check_module(impl)
    m = _matrices(impl)
    stream = torch.cat([_kmajor(_plan_matrix(m, name, i, j)) for name, i, j, _, _ in _stream_plan()])
    packed = {k: v for k, v in m.items() if k not in ("qkv_w", "proj_w", "fc1_w", "fc2_w", "mlp_w")}
    packed["stream"] = stream
    packed["out_w"] = m["mlp_w"][N_LINEARS - 1]
    return packed


def unpack_decoder_params(packed) -> dict:
    """Inverse of the layout of :func:`pack_decoder_params`: the bf16 ``[in,
    out]`` matrices of :func:`_matrices` (bit for bit) and the rest as
    packed."""
    m = {k: v for k, v in packed.items() if k not in ("stream", "out_w")}
    dev = packed["stream"].device
    bf = torch.bfloat16
    m["qkv_w"] = torch.empty(N_BLOCKS, N_HEADS, C, 3 * HEAD_DIM, dtype=bf, device=dev)
    m["proj_w"] = torch.empty(N_BLOCKS, C, C, dtype=bf, device=dev)
    m["fc1_w"] = torch.empty(N_BLOCKS, C, HIDDEN, dtype=bf, device=dev)
    m["fc2_w"] = torch.empty(N_BLOCKS, HIDDEN, C, dtype=bf, device=dev)
    m["mlp_w"] = [None] * N_LINEARS
    at = 0
    for name, i, j, K, N in _stream_plan():
        w = _unkmajor(packed["stream"][at : at + K * N], K, N)
        at += K * N
        if name == "mlp_w":
            m["mlp_w"][i] = w.contiguous()
        elif name == "qkv_w":
            m["qkv_w"][i, 2 * j].copy_(w[:, : 3 * HEAD_DIM])
            m["qkv_w"][i, 2 * j + 1].copy_(w[:, 3 * HEAD_DIM :])
        else:
            _plan_matrix(m, name, i, j).copy_(w)
    m["mlp_w"][N_LINEARS - 1] = packed["out_w"]
    return m


def pack_caches(caches):
    """Per-block (k, v) ``[B, H, L, hd]`` -> the kernel's bf16 cache tiles
    ``[B, CACHE_ELEMS]`` (B samples' blocks, one after another) and ``L``, in
    one pass for the batch. For each sample, block and head: K^T (``[hd,
    208]``, the B of the scores, latent rows zero-padded to ``MAX_LATENT``)
    then V (``[224, hd]``, the B of P @ V, zero-padded to 7 chunks of 32
    rows), each laid out by :func:`_kmajor`."""
    L = caches[0][0].shape[2]
    if L > MAX_LATENT:
        raise ValueError(f"at most {MAX_LATENT} latent tokens, got {L}")
    k = torch.stack([c[0] for c in caches], 1).to(torch.bfloat16)  # [B, NB, H, L, hd]
    v = torch.stack([c[1] for c in caches], 1).to(torch.bfloat16)
    k = torch.nn.functional.pad(k, (0, 0, 0, MAX_LATENT - L))
    v = torch.nn.functional.pad(v, (0, 0, 0, V_KEYS - L))
    return torch.cat([_kmajor(k.transpose(-1, -2)), _kmajor(v)], -1).reshape(k.shape[0], -1), L


def unpack_caches(flat, L):
    """Inverse of :func:`pack_caches`: bf16 K and V ``[..., NB, H, L, hd]``
    of ``flat [..., CACHE_ELEMS]``."""
    lead = flat.shape[:-1]
    tiles = flat.reshape(-1, HEAD_DIM * (MAX_LATENT + V_KEYS))
    nk = HEAD_DIM * MAX_LATENT
    k = torch.stack([_unkmajor(x[:nk], HEAD_DIM, MAX_LATENT).t()[:L] for x in tiles])
    v = torch.stack([_unkmajor(x[nk:], V_KEYS, HEAD_DIM)[:L] for x in tiles])
    shape = (*lead, N_BLOCKS, N_HEADS, L, HEAD_DIM)
    return k.reshape(shape), v.reshape(shape)


class _DecoderParams(ctypes.Structure):
    """Mirror of ``struct DecoderParams`` in ``csrc/implicit_decoder.cu``."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (
            "stream", "caches", "point_w", "point_b", "ln1", "qkv_b", "proj_b", "ln2",
            "fc1_b", "fc2_b", "lnf", "out_w",
        )
    ] + [(name, ctypes.c_void_p * N_LINEARS) for name in ("mlp_wp", "mlp_b")]


def build():
    """Compile the kernel library if it is missing or older than its source.

    Returns ``(seconds spent building, compiler output)``; 0 and "" when the
    library was already current. Raises ``RuntimeError`` if ``nvcc`` fails.
    """
    return _build.build(_SOURCE, _NAME)


# the one-sample entry, which every build of the kernel has (time_recon
# k1_builds binds old sources by it alone), and the batched one
SINGLE_SIGNATURE = {
    "zs_implicit_decode": [
        ctypes.POINTER(_DecoderParams), ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ],
}
_SIGNATURES = dict(SINGLE_SIGNATURE, zs_implicit_decode_batched=[
    ctypes.POINTER(_DecoderParams), ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
])


def _library():
    return _build.library(_SOURCE, _NAME, _SIGNATURES)


def _ptr(t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous() or t.device != device:
        raise ValueError(f"kernel operand must be contiguous {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    return t.data_ptr()


# fp32 per consumer warpgroup of a block: its parked [64, 256] residual
PARK_FLOATS = 2 * 64 * C


def fused_decode(impl, caches, points, packed=None):
    """Occupancy logits ``[P]`` for ``points [P, 3]`` against the latent caches.

    ``caches`` is ``Implicit.encode``'s per-block (k, v) list for one sample
    (each ``[1, H, L, hd]``); ``packed`` is :func:`pack_decoder_params` of
    ``impl`` (needed on CUDA only). On the CPU this is ``impl.decode``.
    """
    if points.dim() != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be [P, 3], got {tuple(points.shape)}")
    return fused_decode_batched(impl, caches, points[None], packed)[0]


def fused_decode_batched(impl, caches, points, packed=None):
    """Occupancy logits ``[B, P]`` for ``points [B, P, 3]``, sample b against
    its own latent caches: one launch for the batch.

    ``caches`` is ``Implicit.encode``'s per-block (k, v) list for B samples
    (each ``[B, H, L, hd]``); ``packed`` is :func:`pack_decoder_params` of
    ``impl`` (needed on CUDA only). On CUDA each sample's logits equal, bit
    for bit, those of a launch of that sample alone (the kernel's rows are
    independent of their tile); the launch is counted in
    ``fused_decode.launches``. On the CPU this is ``impl.decode`` one sample
    at a time, which keeps that property: the CPU's batched products are not
    batch-invariant (a batch of 8 moved some logits by an ulp).
    """
    if points.dim() != 3 or points.shape[2] != 3:
        raise ValueError(f"points must be [B, P, 3], got {tuple(points.shape)}")
    if points.device.type == "cpu":
        return torch.cat([impl.decode([(k[b : b + 1], v[b : b + 1]) for k, v in caches], points[b : b + 1])[0]
                          for b in range(points.shape[0])])
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    if packed is None:
        raise ValueError("the CUDA kernel needs pack_decoder_params(impl)")
    B, P = points.shape[:2]
    k0 = caches[0][0]
    if len(caches) != N_BLOCKS or tuple(k0.shape[:2]) != (B, N_HEADS) or k0.shape[3] != HEAD_DIM:
        raise ValueError(f"caches must be 2 blocks of (k, v) [{B}, 8, L, 32]")
    out = torch.empty(B, P, device=points.device, dtype=torch.float32)
    if B * P == 0:
        return out

    launch(_library(), caches, points, packed, out)
    fused_decode.launches += 1
    return out


fused_decode.launches = 0


def launch(lib, caches, points, packed, out):
    """Launch ``lib``'s K1 (the kernel, or a variant of it built with other
    flags) on CUDA operands; raises on a refused launch. ``points [P, 3]``
    (caches of one sample) -> ``out [P]`` through ``zs_implicit_decode``,
    the entry every build of the kernel has; ``points [B, P, 3]`` -> ``out
    [B, P]`` through ``zs_implicit_decode_batched``, one launch."""
    dev = points.device
    batched = points.dim() == 3
    B, P = points.shape[:2] if batched else (1, points.shape[0])
    kv, L = pack_caches(caches)
    bf, f32 = torch.bfloat16, torch.float32
    prm = _DecoderParams()
    prm.stream = _ptr(packed["stream"], bf, (STREAM_ELEMS,), dev)
    prm.caches = _ptr(kv, bf, (B, CACHE_ELEMS), dev)
    prm.point_w = _ptr(packed["point_w"], bf, (3, C), dev)
    prm.point_b = _ptr(packed["point_b"], f32, (C,), dev)
    prm.ln1 = _ptr(packed["ln1"], f32, (N_BLOCKS, 2, C), dev)
    prm.qkv_b = _ptr(packed["qkv_b"], f32, (N_BLOCKS, N_HEADS, 3 * HEAD_DIM), dev)
    prm.proj_b = _ptr(packed["proj_b"], f32, (N_BLOCKS, C), dev)
    prm.ln2 = _ptr(packed["ln2"], f32, (N_BLOCKS, 2, C), dev)
    prm.fc1_b = _ptr(packed["fc1_b"], f32, (N_BLOCKS, HIDDEN), dev)
    prm.fc2_b = _ptr(packed["fc2_b"], f32, (N_BLOCKS, C), dev)
    prm.lnf = _ptr(packed["lnf"], f32, (2, C), dev)
    prm.out_w = _ptr(packed["out_w"], bf, (C,), dev)
    for l in range(N_LINEARS):
        wp = packed["mlp_wp"][l]
        prm.mlp_wp[l] = None if wp is None else _ptr(wp, bf, (3, C), dev)
        prm.mlp_b[l] = _ptr(packed["mlp_b"][l], f32, (1,) if l == N_LINEARS - 1 else (C,), dev)
    pts = points.contiguous()  # a batch expanded from one point set is copied once a sample
    _ptr(pts, f32, points.shape, dev)
    _ptr(out, f32, points.shape[:-1], dev)
    # one parking slot per block of the persistent grid (at most one block an SM)
    n_slots = torch.cuda.get_device_properties(dev).multi_processor_count
    scratch = torch.empty(n_slots * PARK_FLOATS, device=dev, dtype=f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if batched:
        err = lib.zs_implicit_decode_batched(ctypes.byref(prm), pts.data_ptr(), out.data_ptr(), B, P, L,
                                             scratch.data_ptr(), n_slots, stream)
    else:
        err = lib.zs_implicit_decode(ctypes.byref(prm), pts.data_ptr(), out.data_ptr(), P, L,
                                     scratch.data_ptr(), n_slots, stream)
    if err != 0:
        raise RuntimeError(f"implicit decoder kernel launch failed: cudaError_t {err}")
