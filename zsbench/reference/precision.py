"""The control's lower precision: every linear and convolution of the
reference computed as an fp8 GEMM path computes it. The forward takes its
input and weight rounded to e4m3, the backward its incoming gradient
rounded to e5m2 (with the forward's rounded operands), each under a
per-tensor scale, as fp8 training recipes do; products accumulate in
float32."""

import contextlib

import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_input, conv2d_weight

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x, dtype, top):
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).float() * scale


def e4m3(x):
    return _round(x, torch.float8_e4m3fn, E4M3_MAX)


def e5m2(x):
    return _round(x, torch.float8_e5m2, E5M2_MAX)


class _Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        qx, qw = e4m3(x), e4m3(w)
        ctx.save_for_backward(qx, qw)
        ctx.has_bias = b is not None
        return _linear(qx, qw, b)

    @staticmethod
    def backward(ctx, g):
        qx, qw = ctx.saved_tensors
        qg = e5m2(g)
        gx = qg @ qw
        gw = qg.reshape(-1, qg.shape[-1]).T @ qx.reshape(-1, qx.shape[-1])
        gb = g.reshape(-1, g.shape[-1]).sum(0) if ctx.has_bias else None
        return gx, gw, gb


class _Conv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, stride, padding, dilation, groups):
        qx, qw = e4m3(x), e4m3(w)
        ctx.save_for_backward(qx, qw)
        ctx.conf = (stride, padding, dilation, groups)
        ctx.has_bias = b is not None
        return _conv2d(qx, qw, b, stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, g):
        qx, qw = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.conf
        qg = e5m2(g)
        gx = conv2d_input(qx.shape, qw, qg, stride, padding, dilation, groups)
        gw = conv2d_weight(qx, qw.shape, qg, stride, padding, dilation, groups)
        gb = g.sum(dim=(0, 2, 3)) if ctx.has_bias else None
        return gx, gw, gb, None, None, None, None


_linear, _conv2d = F.linear, F.conv2d


def _fp8_linear(x, w, b=None):
    return _Linear.apply(x, w, b)


def _fp8_conv2d(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
    if isinstance(padding, str):
        raise ValueError("the fp8 control takes numeric padding only")
    return _Conv2d.apply(x, w, b, stride, padding, dilation, groups)


@contextlib.contextmanager
def fp8_matmuls():
    """Inside, ``F.linear`` and ``F.conv2d`` (and so every ``nn.Linear`` and
    ``nn.Conv2d``) compute from fp8 operands, forward and backward."""
    F.linear, F.conv2d = _fp8_linear, _fp8_conv2d
    try:
        yield
    finally:
        F.linear, F.conv2d = _linear, _conv2d


@contextlib.contextmanager
def exact_fp32():
    """float32 matrix products with TF32 off, restored on the way out."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
