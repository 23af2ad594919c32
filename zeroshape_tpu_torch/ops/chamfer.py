"""Chamfer nearest-neighbour distances: the K2/K3 kernels, their plain versions, autograd.

Counterpart of ``zeroshape_tpu/ops/chamfer.py``. For each point of cloud A,
the squared distance to (and index of) its nearest neighbour in cloud B.

- :func:`nn_one_way` is K2 plus the exact winner refinement (``:240-248``):
  the argmin is found in the expanded form ``|a|^2 + |b|^2 - 2 a.b`` and the
  winner's distance is then recomputed exactly.
- :func:`nn_min_squared_fast` is K3: the min only, with a bf16 cross term,
  for ranking candidates that are rescored exactly later.

Both kernels are CUDA C++ for ``sm_90a`` in ``csrc/chamfer.cu`` (its header
gives the design and the bound), built at first use and bound with ctypes.
A CPU tensor runs the plain version; a CUDA tensor launches the kernel or the
wrapper raises. Clouds are ``[B, N, 3]`` fp32; the kernels take a batch
stride, so a cloud shared by the batch (``expand``, stride 0) is read in
place.
"""

from __future__ import annotations

import ctypes

import torch

from zeroshape_tpu_torch.ops import _build

_SOURCE, _NAME = "chamfer.cu", "zs_chamfer"
PLAIN_TILE = 1024  # rows of A per step of the plain versions: [B, 1024, M] temporaries


def build():
    """Compile ``csrc/chamfer.cu``; ``(seconds, compiler output)`` as ``_build.build``."""
    return _build.build(_SOURCE, _NAME)


_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {  # the C entry points of csrc/chamfer.cu
    "zs_nn_one_way": [_p, _p, _ll, _ll, _i, _i, _i, _p, _p, _p],
    "zs_nn_min_fast": [_p, _p, _ll, _ll, _i, _i, _i, _p, _p],
}


def _library():
    return _build.library(_SOURCE, _NAME, SIGNATURES)


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the reference the kernels are held to)
# ---------------------------------------------------------------------------


def _sq_norm(x):
    """``(x*x + y*y) + z*z`` over the last axis, in that order (as the kernels)."""
    return x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2]


def _nn_one_way_plain(x1, x2):
    """K2's plain version (``_nn_one_way_xla``, ``chamfer.py:38-56``):
    ``x1 [B, N, 3], x2 [B, M, 3]`` -> (min expanded-form distance ``[B, N]``
    clamped at 0, argmin ``[B, N]`` int64, the first index on ties)."""
    n2 = _sq_norm(x2)
    dists, idxs = [], []
    for i in range(0, x1.shape[1], PLAIN_TILE):
        a = x1[:, i : i + PLAIN_TILE]
        d = _sq_norm(a)[..., None] + n2[:, None, :] - 2.0 * torch.einsum("bnd,bmd->bnm", a, x2)
        m, j = d.min(dim=-1)
        dists.append(m)
        idxs.append(j)
    return torch.clamp(torch.cat(dists, dim=1), min=0.0), torch.cat(idxs, dim=1)


def _nn_min_plain(x1, x2):
    """K3's plain version (``_nn_min_xla``, ``chamfer.py:193-213``): min over
    B of ``|a|^2 + |b|^2 - 2 bf16(a).bf16(b)`` clamped at 0, ``[B, N]``.

    The cross term rounds both operands to bf16 and sums the three products,
    each exact in fp32, in the order ``(x + y) + z``: what an fp32-accumulated
    bf16 dot gives, without depending on how a backend multiplies bf16."""
    n2 = _sq_norm(x2)
    b16 = x2.to(torch.bfloat16).float()[:, None]  # [B, 1, M, 3]
    out = []
    for i in range(0, x1.shape[1], PLAIN_TILE):
        a = x1[:, i : i + PLAIN_TILE]
        a16 = a.to(torch.bfloat16).float()[:, :, None]  # [B, t, 1, 3]
        cross = a16[..., 0] * b16[..., 0] + a16[..., 1] * b16[..., 1] + a16[..., 2] * b16[..., 2]
        out.append((_sq_norm(a)[..., None] + n2[:, None, :] - 2.0 * cross).min(dim=-1).values)
    return torch.clamp(torch.cat(out, dim=1), min=0.0)


def _refine(x1, x2, idx):
    """Exact ``|a - b|^2`` to each point's chosen neighbour (``chamfer.py:240-248``)."""
    nn = torch.gather(x2, 1, idx[..., None].expand(-1, -1, 3))
    return _sq_norm(x1 - nn)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check(x1, x2):
    """Raise unless ``x1 [B, N, 3]``, ``x2 [B, M >= 1, 3]`` are fp32 on one device."""
    if x1.dim() != 3 or x2.dim() != 3 or x1.shape[2] != 3 or x2.shape[2] != 3:
        raise ValueError(f"clouds must be [B, N, 3], got {tuple(x1.shape)} and {tuple(x2.shape)}")
    if x1.shape[0] != x2.shape[0] or x2.shape[1] < 1:
        raise ValueError(f"batch sizes differ or cloud B is empty: {tuple(x1.shape)}, {tuple(x2.shape)}")
    if x1.dtype != torch.float32 or x2.dtype != torch.float32:
        raise ValueError(f"clouds must be float32, got {x1.dtype} and {x2.dtype}")
    if x1.device != x2.device:
        raise ValueError(f"clouds on different devices: {x1.device} and {x2.device}")
    if x1.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x1.device}")


def _operand(x):
    """``x`` as the kernel reads it, and its batch stride in floats. The rows
    must be contiguous ``[N, 3]``: a cloud whose rows are not is copied once.
    The batch stride may be anything, 0 for a cloud expanded over the batch,
    which the kernel then reads in place rather than as B copies."""
    if (x.shape[1] > 1 and x.stride(1) != 3) or (x.shape[1] > 0 and x.stride(2) != 1):
        x = x.contiguous()
    return x, 0 if x.shape[0] == 1 else x.stride(0)


def nn_one_way(x1, x2):
    """K2: for each point of ``x1 [B, N, 3]``, its exact squared distance to
    the nearest point of ``x2 [B, M, 3]`` and that point's index (int64).

    The argmin is taken in the expanded form, the lower index winning a tie,
    and the winner's distance is recomputed exactly. A CPU tensor runs the
    plain version; a CUDA tensor launches the kernel (which fuses the
    refinement) or raises.
    """
    _check(x1, x2)
    if x1.device.type == "cpu":
        _, idx = _nn_one_way_plain(x1, x2)
        return _refine(x1, x2, idx), idx
    B, N, M = x1.shape[0], x1.shape[1], x2.shape[1]
    (x1, s1), (x2, s2) = _operand(x1), _operand(x2)
    dist = torch.empty(B, N, device=x1.device, dtype=torch.float32)
    idx = torch.empty(B, N, device=x1.device, dtype=torch.int64)
    if B * N == 0:
        return dist, idx
    err = _library().zs_nn_one_way(
        x1.data_ptr(), x2.data_ptr(), s1, s2, B, N, M, dist.data_ptr(), idx.data_ptr(),
        torch.cuda.current_stream(x1.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"nn_one_way kernel launch failed: cudaError_t {err}")
    nn_one_way.launches += 1
    return dist, idx


nn_one_way.launches = 0


def nn_min_squared_fast(x1, x2):
    """K3: ranking-grade min squared NN distances ``[B, N]`` of ``x1`` in ``x2``.

    bf16 cross term with fp32 accumulation, no argmin and no refinement:
    absolute error ~1e-3 from the input rounding (``chamfer.py:216-230``). A
    CPU tensor runs the plain version; a CUDA tensor launches the kernel or
    raises.
    """
    _check(x1, x2)
    if x1.device.type == "cpu":
        return _nn_min_plain(x1, x2)
    B, N, M = x1.shape[0], x1.shape[1], x2.shape[1]
    (x1, s1), (x2, s2) = _operand(x1), _operand(x2)
    dist = torch.empty(B, N, device=x1.device, dtype=torch.float32)
    if B * N == 0:
        return dist
    err = _library().zs_nn_min_fast(
        x1.data_ptr(), x2.data_ptr(), s1, s2, B, N, M, dist.data_ptr(),
        torch.cuda.current_stream(x1.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"nn_min_squared_fast kernel launch failed: cudaError_t {err}")
    nn_min_squared_fast.launches += 1
    return dist


nn_min_squared_fast.launches = 0


# ---------------------------------------------------------------------------
# both directions, with the gradient of chamfer.py:275-290
# ---------------------------------------------------------------------------


class _ChamferSquared(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x1, x2):
        d1, i1 = nn_one_way(x1, x2)
        d2, i2 = nn_one_way(x2, x1)
        ctx.save_for_backward(x1, x2, i1, i2)
        ctx.mark_non_differentiable(i1, i2)
        return d1, d2, i1, i2

    @staticmethod
    def backward(ctx, g1, g2, _gi1, _gi2):
        x1, x2, i1, i2 = ctx.saved_tensors
        B, N, M = x1.shape[0], x1.shape[1], x2.shape[1]
        g1 = torch.zeros(B, N, dtype=x1.dtype, device=x1.device) if g1 is None else g1
        g2 = torch.zeros(B, M, dtype=x2.dtype, device=x2.device) if g2 is None else g2
        # d1_i = |x1_i - x2_{i1_i}|^2  ->  dx1_i += 2 g1_i (x1_i - x2_{i1_i}),
        # and the neighbour x2_{i1_i} gets the opposite (a scatter-add)
        diff1 = 2.0 * g1[..., None] * (x1 - torch.gather(x2, 1, i1[..., None].expand(-1, -1, 3)))
        diff2 = 2.0 * g2[..., None] * (x2 - torch.gather(x1, 1, i2[..., None].expand(-1, -1, 3)))
        dx1 = diff1.reshape(B * N, 3).clone()
        dx2 = diff2.reshape(B * M, 3).clone()
        batch = torch.arange(B, device=x1.device)[:, None]
        dx2.index_add_(0, (i1 + batch * M).reshape(-1), -diff1.reshape(B * N, 3))
        dx1.index_add_(0, (i2 + batch * N).reshape(-1), -diff2.reshape(B * M, 3))
        return dx1.reshape(B, N, 3), dx2.reshape(B, M, 3)


def chamfer_squared(x1, x2):
    """Bidirectional NN squared distances of ``x1 [B, N, 3]`` and ``x2 [B, M, 3]``:
    ``(d1 [B, N], d2 [B, M], idx1 [B, N], idx2 [B, M])``, differentiable in
    both clouds through the saved argmins."""
    return _ChamferSquared.apply(x1, x2)


def chamfer_distance(x1, x2):
    """The reference's Chamfer (``utils/eval_3D.py:265-269``): sqrt of the squared NN distances."""
    d1, d2, i1, i2 = chamfer_squared(x1, x2)
    return torch.sqrt(d1), torch.sqrt(d2), i1, i2
