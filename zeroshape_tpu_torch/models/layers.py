"""Shared building blocks (counterpart of ``zeroshape_tpu/models/layers.py``).

ViT blocks (with stochastic depth), conv-BN residual bottlenecks,
weight-standardised convs with TF-SAME padding (the ResNetV2 hybrid stem),
the sin-cos and NeRF positional encodings, the LayerNorm-MLP bottleneck and
the CLIP fusion blocks. Modules are NCHW inside; submodule names follow the
reference torch state-dict layout so released checkpoints load without
renaming.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from zeroshape_tpu_torch.parallel import dist


# ---------------------------------------------------------------------------
# Positional embeddings (layers.py:32-50)
# ---------------------------------------------------------------------------

def get_1d_sincos_pos_embed_from_grid(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int, cls_token: bool = False) -> np.ndarray:
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0)  # w first
    grid = grid.reshape([2, 1, grid_size, grid_size])
    emb_h = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[0])
    emb_w = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[1])
    pos_embed = np.concatenate([emb_h, emb_w], axis=1)
    if cls_token:
        pos_embed = np.concatenate([np.zeros([1, embed_dim]), pos_embed], axis=0)
    return pos_embed.astype(np.float32)


def nerf_posenc(x, num_freqs: int, include_input: bool = True):
    """NeRF sin/cos frequency encoding (layers.py:53-63): ``[x, enc]`` where
    ``enc`` holds, frequency by frequency (``2**f`` in ``x``'s dtype), the
    sines of every coordinate, then their cosines."""
    if num_freqs <= 0:
        return x
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * freqs[:, None]  # [..., F, D]
    enc = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-1).reshape(*x.shape[:-1], -1)
    return torch.cat([x, enc], dim=-1) if include_input else enc


def nerf_posenc_dim(input_dim: int, num_freqs: int, include_input: bool = True) -> int:
    """The width :func:`nerf_posenc` gives ``input_dim`` features (layers.py:66-69)."""
    if num_freqs <= 0:
        return input_dim
    return input_dim * (2 * num_freqs + (1 if include_input else 0))


# ---------------------------------------------------------------------------
# Transformer layers (layers.py:74-162)
# ---------------------------------------------------------------------------

def gelu_exact(x):
    """torch ``nn.GELU`` (exact erf form), as the reference trains with."""
    return F.gelu(x)


def make_drop_path_mask(generator, batch: int, rate: float, device=None):
    """Per-sample stochastic-depth keep mask ``[batch]``, pre-scaled by
    ``1 / keep`` (layers.py:81-85), drawn from ``generator``. ``batch`` is
    this rank's: every rank draws the global batch's masks and keeps its
    own rows, so the masks do not depend on the number of ranks."""
    keep = 1.0 - rate
    r, n = dist.rank(), dist.world()
    draw = torch.rand(batch * n, generator=generator, device=device)[r * batch: (r + 1) * batch]
    return (draw < keep).float() / keep


class DropPath(nn.Module):
    """Per-sample stochastic depth (timm DropPath semantics, layers.py:88-100):
    ``x`` times a ``[B]`` keep mask from :func:`make_drop_path_mask`. Identity
    without a mask, with rate 0, or outside training."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, mask=None):
        if mask is None or self.rate == 0.0 or not self.training:
            return x
        return x * mask.reshape((x.shape[0],) + (1,) * (x.dim() - 1))


def softplus_beta(x, beta: float = 100.0):
    """torch Softplus(beta): log(1 + exp(beta x)) / beta, linear above 20/beta."""
    return F.softplus(x, beta=beta, threshold=20.0)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2 (timm Mlp)."""

    def __init__(self, dim: int, hidden_dim: int, out_dim: int | None = None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim or dim)

    def forward(self, x):
        return self.fc2(gelu_exact(self.fc1(x)))


def split_heads(qkv, num_heads: int):
    """[B, N, 3C] -> q, k, v each [B, H, N, hd]."""
    B, N, C3 = qkv.shape
    t = qkv.reshape(B, N, 3, num_heads, C3 // (3 * num_heads)).permute(2, 0, 3, 1, 4)
    return t[0], t[1], t[2]


class Attention(nn.Module):
    """Multi-head self-attention (timm vision_transformer.Attention)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        q, k, v = split_heads(self.qkv(x), self.num_heads)
        attn = (q @ k.transpose(-2, -1)) * (C // self.num_heads) ** -0.5
        attn = attn.float().softmax(dim=-1).to(v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(B, N, C)
        return self.proj(out)


class ViTBlock(nn.Module):
    """Pre-norm block: x += dp1(attn(LN(x))); x += dp2(mlp(LN(x))), LayerNorm
    eps 1e-6 (layers.py:144-162).

    Stochastic depth at rate ``drop_path``: ``drop_path1`` scales the
    attention branch and ``drop_path2`` the MLP branch, each by its own
    per-sample mask. ``forward`` takes the two masks, or in training draws
    them from the default generator (:meth:`dp_masks`).
    """

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path: float = 0.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.drop_path1 = DropPath(drop_path)
        self.drop_path2 = DropPath(drop_path)

    def dp_masks(self, batch, generator=None, device=None):
        """The block's two masks, drawn from ``generator`` for the attention
        branch then the MLP branch; Nones outside training or at rate 0."""
        rate = self.drop_path1.rate
        if not self.training or rate == 0.0:
            return None, None
        return tuple(make_drop_path_mask(generator, batch, rate, device) for _ in range(2))

    def forward(self, x, masks=None):
        m1, m2 = masks if masks is not None else self.dp_masks(x.shape[0], device=x.device)
        x = x + self.drop_path1(self.attn(self.norm1(x)), m1)
        return x + self.drop_path2(self.mlp(self.norm2(x)), m2)


def block_masks(blocks, batch, generator=None, device=None, given=None):
    """Each of ``blocks``' (ViTBlocks) two stochastic-depth masks: ``given``
    where set, else drawn from ``generator`` block by block."""
    return given if given is not None else [blk.dp_masks(batch, generator, device) for blk in blocks]


# ---------------------------------------------------------------------------
# Convolutions (layers.py:169-248)
# ---------------------------------------------------------------------------

class Conv(nn.Conv2d):
    """Conv2d with torch-style symmetric padding ``kernel // 2``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1, bias: bool = True):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=kernel // 2, bias=bias)


def _same_pad_amount(size: int, k: int, s: int) -> int:
    return max((math.ceil(size / s) - 1) * s + k - size, 0)


def pad_same(x, kernel: int, stride: int, value: float = 0.0):
    """TF-SAME padding of NCHW ``x``: the odd pixel goes to the bottom/right."""
    ph = _same_pad_amount(x.shape[-2], kernel, stride)
    pw = _same_pad_amount(x.shape[-1], kernel, stride)
    return F.pad(x, [pw // 2, pw - pw // 2, ph // 2, ph - ph // 2], value=value)


class StdConvSame(nn.Conv2d):
    """Weight-standardised conv with TF-SAME padding (timm StdConv2dSame).

    The kernel is standardised per output channel over (in, kh, kw) with
    eps 1e-6, in fp32, before the (possibly bf16) convolution.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1, eps: float = 1e-6):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=0, bias=False)
        self.eps = eps

    def forward(self, x):
        w = self.weight.float()
        var, mean = torch.var_mean(w.reshape(w.shape[0], -1), dim=1, unbiased=False)
        w = (w - mean.reshape(-1, 1, 1, 1)) / torch.sqrt(var.reshape(-1, 1, 1, 1) + self.eps)
        x = pad_same(x, self.kernel_size[0], self.stride[0])
        return F.conv2d(x, w, None, self.stride)


def max_pool_same(x, kernel: int = 3, stride: int = 2):
    """TF-SAME max pool (timm MaxPool2dSame)."""
    return F.max_pool2d(pad_same(x, kernel, stride, value=float("-inf")), kernel, stride)


# ---------------------------------------------------------------------------
# Conv-BN bottleneck (layers.py:251-295)
# ---------------------------------------------------------------------------

class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch normalisation over the global batch of all ranks (as
    ``SyncBatchNorm``): the forward all-reduces each channel's count, sum and
    sum of squares, the backward the sums of ``dy`` and ``dy * (x - mean)``,
    so every rank's input gradient carries every rank's loss. Statistics in
    float64; on gloo the reductions go through the host."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        xf = x.double()
        n = torch.tensor([x.numel() // x.shape[1]], dtype=torch.float64, device=x.device)
        stats = dist.all_reduce_(torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)), n]))
        C = x.shape[1]
        count = stats[2 * C]
        mean = stats[:C] / count
        var = (stats[C: 2 * C] / count - mean * mean).clamp_min(0)
        invstd = (var + eps).rsqrt()
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.count = count
        shape = (1, -1, 1, 1)
        y = (xf - mean.view(shape)) * (invstd * weight.double()).view(shape) + bias.double().view(shape)
        mean, var = mean.float(), var.float()
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd = ctx.saved_tensors
        shape = (1, -1, 1, 1)
        dyf, xmu = dy.double(), x.double() - mean.view(shape)
        sum_dy, sum_dy_xmu = dyf.sum((0, 2, 3)), (dyf * xmu).sum((0, 2, 3))
        grad_w, grad_b = (sum_dy_xmu * invstd).to(weight.dtype), sum_dy.to(weight.dtype)
        C = x.shape[1]
        sums = dist.all_reduce_(torch.cat([sum_dy, sum_dy_xmu]))
        mean_dy, mean_dy_xmu = sums[:C] / ctx.count, sums[C:] / ctx.count
        dx = (dyf - mean_dy.view(shape) - xmu * (invstd * invstd * mean_dy_xmu).view(shape)) \
            * (invstd * weight.double()).view(shape)
        return dx.to(x.dtype), grad_w, grad_b, None


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d (eps 1e-5, momentum 0.1) with the running-statistics rule
    of the JAX package (flax ``BatchNorm(momentum=0.9)``, layers.py:251-268).

    In eval it is ``nn.BatchNorm2d``. In training it normalises with the
    batch statistics, as torch does, but updates ``running_var`` with the
    *biased* batch variance, as flax does; ``nn.BatchNorm2d`` would use the
    unbiased one (a known deviation from the torch reference). The batch is
    reduced once: the running statistics move from the mean and inverse
    standard deviation that the normalisation saved (biased variance =
    invstd^-2 - eps). Under several ranks the statistics are those of the
    global batch, as flax's over the sharded batch (:class:`_GlobalBatchNorm`).
    """

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if dist.world() > 1:
            out, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps)
        else:
            out, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            if dist.world() == 1:
                var = invstd.pow(-2).sub_(self.eps)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return out


class BottleneckConv(nn.Module):
    """conv-BN-ReLU residual bottleneck (reference utils/layers.py:76-100).

    Accepts ``[B, C]`` or ``[B, C, H, W]``; 2D inputs are lifted to 1x1 maps.
    """

    def __init__(self, channels: int, kernel: int = 1):
        super().__init__()
        self.linear1 = Conv(channels, channels, kernel, bias=False)
        self.bn1 = BatchNorm(channels)
        self.linear2 = Conv(channels, channels, kernel, bias=False)
        self.bn2 = BatchNorm(channels)

    def forward(self, x):
        squeeze = x.dim() == 2
        if squeeze:
            x = x[:, :, None, None]
        h = F.relu(self.bn1(self.linear1(x)))
        h = self.bn2(self.linear2(h))
        out = F.relu(h + x)
        return out[:, :, 0, 0] if squeeze else out


# ---------------------------------------------------------------------------
# LayerNorm-MLP bottleneck and the CLIP fusion blocks (layers.py:298-357)
# ---------------------------------------------------------------------------

class BottleneckLinear(nn.Module):
    """x + linear2(gelu(linear1(LN(x)))), LayerNorm eps 1e-6 (reference
    utils/layers.py:64-74)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.linear1 = nn.Linear(dim, dim)
        self.linear2 = nn.Linear(dim, dim)

    def forward(self, x):
        return x + self.linear2(gelu_exact(self.linear1(self.norm(x))))


class CLIPFusionBlockConcat(nn.Module):
    """Fuse semantic tokens ``[B, N, C]`` with a global CLIP latent ``[B, C]``:
    concat on the feature axis, ``n_layers`` :class:`BottleneckLinear` of
    width 2C, a linear back to C, an exact GELU if ``act`` (reference
    utils/layers.py:102-122). No graph of the package uses it."""

    def __init__(self, dim: int, n_layers: int = 1, act: bool = True):
        super().__init__()
        self.act = act
        self.bottlenecks = nn.ModuleList(BottleneckLinear(2 * dim) for _ in range(n_layers))
        self.proj = nn.Linear(2 * dim, dim)

    def forward(self, sem_latent, clip_latent):
        h = torch.cat([sem_latent, clip_latent[:, None, :].expand_as(sem_latent)], dim=-1)
        for blk in self.bottlenecks:
            h = blk(h)
        h = self.proj(h)
        return gelu_exact(h) if self.act else h


class CLIPFusionBlockAttn(nn.Module):
    """Fuse through ``n_layers`` ViT blocks over ``[clip token | semantic
    tokens]``, the semantic rows out, an exact GELU if ``act`` (reference
    utils/layers.py:124-147). The blocks carry drop path 0.1 but, as in the
    JAX package, always run without it. No graph of the package uses it."""

    def __init__(self, dim: int, n_layers: int = 1, num_heads: int = 8, act: bool = True):
        super().__init__()
        self.act = act
        self.blocks = nn.ModuleList(ViTBlock(dim, num_heads, 4.0, drop_path=0.1) for _ in range(n_layers))

    def forward(self, sem_latent, clip_latent):
        h = torch.cat([clip_latent[:, None, :].to(sem_latent.dtype), sem_latent], dim=1)
        for blk in self.blocks:
            h = blk(h, (None, None))
        out = h[:, 1:, :]
        return gelu_exact(out) if self.act else out
