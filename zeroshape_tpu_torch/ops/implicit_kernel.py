"""Fused implicit-decoder kernel: weight packing, build, and wrapper.

Counterpart of ``zeroshape_tpu/ops/implicit_kernel.py`` (``fused_decode``,
``pack_decoder_params``; ``_check_module`` is the gate of ``fused_supported``).
The kernel itself is CUDA C++ for ``sm_90a`` in ``csrc/implicit_decoder.cu``;
its header comment gives the design and the bound. It is compiled with
``nvcc`` at first use into ``csrc/build/`` and bound with ctypes.

:func:`fused_decode` takes a CPU tensor to the plain ``Implicit.decode``;
a CUDA tensor goes to the kernel, or the wrapper raises. It never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from zeroshape_tpu_torch.ops import _build

_SOURCE, _NAME = "implicit_decoder.cu", "zs_implicit_decoder"

# the shapes the kernel is compiled for (the shipped decoder)
C, N_HEADS, HEAD_DIM, N_BLOCKS, HIDDEN, N_LINEARS = 256, 8, 32, 2, 1024, 9
SKIP_IN = (2, 4, 6)
MAX_LATENT = 208  # padded latent rows the kernel's shared-memory layout fits


def _check_module(impl):
    """Raise unless ``impl`` has the shapes the kernel is built for (the gate
    of ``fused_supported``, ``zeroshape_tpu/ops/implicit_kernel.py:54-72``)."""
    blocks = impl.blocks_attn
    ok = (
        impl.latent_proj.in_features == 256
        and impl.point_proj.proj.out_features == C
        and impl.num_heads == N_HEADS
        and len(blocks) == N_BLOCKS
        and blocks[0].mlp.fc1.out_features == HIDDEN
        and len(impl.impl_mlp.layers) == N_LINEARS
        and tuple(impl.impl_mlp.skip_in) == SKIP_IN
    )
    if not ok:
        raise ValueError(
            "the fused decoder kernel is built for latent_dim 256, C=256, 8 heads, 2 blocks, "
            "mlp_ratio 4, 9 skip-MLP linears with skips at (2, 4, 6)"
        )


def pack_decoder_params(impl) -> dict:
    """Stack the decoder's weights into the kernel's layout (on its device).

    Matrices go to bf16 as ``[in, out]``; biases and LayerNorms stay fp32.
    qkv columns are regrouped per head into ``[q_h | k_h | v_h]``. Skip
    layers take the reference concat order ``[state | pts | trunk]``
    (``implicit.py:143-145``); their point rows move to a separate ``[3, C]``
    array and the rest keep ``[state | trunk]`` (cf. the reorder at
    ``implicit_kernel.py:433-441``).
    """
    _check_module(impl)

    def wt(lin):  # torch [out, in] -> [in, out]
        return lin.weight.detach().t().float()

    def bf(x):
        return x.to(torch.bfloat16).contiguous()

    def f32(x):
        return x.detach().float().contiguous()

    def ln(norm):
        return torch.stack([norm.weight.detach(), norm.bias.detach()])

    blocks = impl.blocks_attn
    qkv_w, qkv_b = [], []
    for blk in blocks:
        w, b = wt(blk.attn.qkv), blk.attn.qkv.bias.detach()
        cols = [
            torch.cat([torch.arange(j * C + h * HEAD_DIM, j * C + (h + 1) * HEAD_DIM) for j in range(3)])
            for h in range(N_HEADS)
        ]
        qkv_w.append(torch.stack([w[:, c] for c in cols]))  # [H, C, 96]
        qkv_b.append(torch.stack([b[c] for c in cols]))  # [H, 96]
    packed = {
        "point_w": bf(wt(impl.point_proj.proj)),
        "point_b": f32(impl.point_proj.proj.bias),
        "ln1": f32(torch.stack([ln(b.norm1) for b in blocks])),
        "qkv_w": bf(torch.stack(qkv_w)),
        "qkv_b": f32(torch.stack(qkv_b)),
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
        packed["mlp_w"].append(bf(main))
        packed["mlp_wp"].append(None if pts_rows is None else bf(pts_rows))
        packed["mlp_b"].append(f32(lin.bias))
    return packed


def pack_caches(caches):
    """Per-block (k, v) ``[1, H, L, hd]`` -> bf16 ``[NB, H, Lp, hd]`` K and V,
    zero-padded to ``Lp`` (a multiple of 16) latent rows, and ``L``."""
    L = caches[0][0].shape[2]
    Lp = -(-L // 16) * 16

    def stack(i):
        x = torch.stack([c[i][0] for c in caches]).to(torch.bfloat16)
        return torch.nn.functional.pad(x, (0, 0, 0, Lp - L)).contiguous()

    return stack(0), stack(1), L


class _DecoderParams(ctypes.Structure):
    """Mirror of ``struct DecoderParams`` in ``csrc/implicit_decoder.cu``."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (
            "point_w", "point_b", "ln1", "qkv_w", "qkv_b", "proj_w", "proj_b", "ln2",
            "fc1_w", "fc1_b", "fc2_w", "fc2_b", "lnf", "k_cache", "v_cache",
        )
    ] + [(name, ctypes.c_void_p * N_LINEARS) for name in ("mlp_w", "mlp_wp", "mlp_b")]


def build():
    """Compile the kernel library if it is missing or older than its source.

    Returns ``(seconds spent building, compiler output)``; 0 and "" when the
    library was already current. Raises ``RuntimeError`` if ``nvcc`` fails.
    """
    return _build.build(_SOURCE, _NAME)


def _library():
    return _build.library(_SOURCE, _NAME, {
        "zs_implicit_decode": [
            ctypes.POINTER(_DecoderParams), ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ],
    })


def _ptr(t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous() or t.device != device:
        raise ValueError(f"kernel operand must be contiguous {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    return t.data_ptr()


def fused_decode(impl, caches, points, packed=None):
    """Occupancy logits ``[P]`` for ``points [P, 3]`` against the latent caches.

    ``caches`` is ``Implicit.encode``'s per-block (k, v) list for one sample
    (each ``[1, H, L, hd]``); ``packed`` is :func:`pack_decoder_params` of
    ``impl`` (needed on CUDA only). On the CPU this is ``impl.decode``.
    """
    if points.device.type == "cpu":
        return impl.decode(caches, points[None])[0][0]
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    if packed is None:
        raise ValueError("the CUDA kernel needs pack_decoder_params(impl)")
    dev = points.device
    P = points.shape[0]
    if points.dim() != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be [P, 3], got {tuple(points.shape)}")
    if len(caches) != N_BLOCKS or tuple(caches[0][0].shape[:2]) != (1, N_HEADS) or caches[0][0].shape[3] != HEAD_DIM:
        raise ValueError("caches must be 2 blocks of (k, v) [1, 8, L, 32]")
    k, v, L = pack_caches(caches)
    Lp = k.shape[2]
    if L > MAX_LATENT:
        raise ValueError(f"at most {MAX_LATENT} latent tokens, got {L}")
    out = torch.empty(P, device=dev, dtype=torch.float32)
    if P == 0:
        return out

    bf, f32 = torch.bfloat16, torch.float32
    prm = _DecoderParams()
    prm.point_w = _ptr(packed["point_w"], bf, (3, C), dev)
    prm.point_b = _ptr(packed["point_b"], f32, (C,), dev)
    prm.ln1 = _ptr(packed["ln1"], f32, (N_BLOCKS, 2, C), dev)
    prm.qkv_w = _ptr(packed["qkv_w"], bf, (N_BLOCKS, N_HEADS, C, 3 * HEAD_DIM), dev)
    prm.qkv_b = _ptr(packed["qkv_b"], f32, (N_BLOCKS, N_HEADS, 3 * HEAD_DIM), dev)
    prm.proj_w = _ptr(packed["proj_w"], bf, (N_BLOCKS, C, C), dev)
    prm.proj_b = _ptr(packed["proj_b"], f32, (N_BLOCKS, C), dev)
    prm.ln2 = _ptr(packed["ln2"], f32, (N_BLOCKS, 2, C), dev)
    prm.fc1_w = _ptr(packed["fc1_w"], bf, (N_BLOCKS, C, HIDDEN), dev)
    prm.fc1_b = _ptr(packed["fc1_b"], f32, (N_BLOCKS, HIDDEN), dev)
    prm.fc2_w = _ptr(packed["fc2_w"], bf, (N_BLOCKS, HIDDEN, C), dev)
    prm.fc2_b = _ptr(packed["fc2_b"], f32, (N_BLOCKS, C), dev)
    prm.lnf = _ptr(packed["lnf"], f32, (2, C), dev)
    prm.k_cache = _ptr(k, bf, (N_BLOCKS, N_HEADS, Lp, HEAD_DIM), dev)
    prm.v_cache = _ptr(v, bf, (N_BLOCKS, N_HEADS, Lp, HEAD_DIM), dev)
    for l in range(N_LINEARS):
        rows = 2 * C if l in SKIP_IN else C
        shape = (C,) if l == N_LINEARS - 1 else (rows, C)
        prm.mlp_w[l] = _ptr(packed["mlp_w"][l], bf, shape, dev)
        wp = packed["mlp_wp"][l]
        prm.mlp_wp[l] = None if wp is None else _ptr(wp, bf, (3, C), dev)
        prm.mlp_b[l] = _ptr(packed["mlp_b"][l], f32, (1,) if l == N_LINEARS - 1 else (C,), dev)
    pts = points.contiguous()
    _ptr(pts, f32, (P, 3), dev)

    err = _library().zs_implicit_decode(
        ctypes.byref(prm), pts.data_ptr(), out.data_ptr(), P, L, Lp,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"implicit decoder kernel launch failed: cudaError_t {err}")
    fused_decode.launches += 1
    return out


fused_decode.launches = 0
