"""Implicit occupancy decoder with masked joint attention.

Counterpart of ``zeroshape_tpu/models/implicit.py:44-259``. Information
flows one way in the reference's joint sequence (latents -> points), so the
latent trunk runs once: :meth:`Implicit.encode` returns each block's latent
K/V cache, and :meth:`Implicit.decode` scores any number of query points
against the caches. Each point attends to the cached latent keys plus its
own key in one joint softmax. In training (:meth:`Implicit.forward`)
both streams take stochastic depth, one keep mask per block shared by the
latent and point streams of a sample.

:meth:`Implicit.decode` is the plain version of the fused decoder kernel
(``ops/implicit_kernel.py``): the CPU runs it, and the kernel is held to it.
Names follow the reference layout: ``point_proj.proj``, ``latent_proj``,
the ``pos_embed`` buffer, ``blocks_attn.{i}.{norm1,attn.qkv,attn.proj,norm2,
mlp.fc1,mlp.fc2}``, ``norm``, ``impl_mlp.layers.{l}`` or, without an MLP,
``pred_head``.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from zeroshape_tpu_torch.models import compute_autocast
from zeroshape_tpu_torch.models.layers import (
    DropPath,
    Mlp,
    get_2d_sincos_pos_embed,
    make_drop_path_mask,
    nerf_posenc,
    nerf_posenc_dim,
    softplus_beta,
    split_heads,
)


class ImplicitBlock(nn.Module):
    """One pre-norm block over the (latents | points) masked joint sequence."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, drop_path: float = 0.1,
                 last_layer: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.last_layer = last_layer
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = nn.Module()
        self.attn.qkv = nn.Linear(dim, 3 * dim)
        self.attn.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.dp = DropPath(drop_path)

    def latent_step(self, h, dp_mask=None):
        """Latent self-attention update; returns (h_new, (k, v) [B, H, L, hd]).
        ``dp_mask`` is the block's stochastic-depth mask (training only)."""
        q, k, v = split_heads(self.attn.qkv(self.norm1(h)), self.num_heads)
        if self.last_layer:
            # the last block only produces point outputs; the latent state is
            # dead once its k/v are cached (reference implicit.py:59-63)
            return h, (k, v)
        attn = ((q @ k.transpose(-2, -1)) * self.scale).float().softmax(dim=-1).to(v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(h.shape)
        h = h + self.dp(self.attn.proj(out), dp_mask)
        return h + self.dp(self.mlp(self.norm2(h)), dp_mask), (k, v)

    def point_step(self, p, cache, dp_mask=None):
        """Cross-attention to the cached latents plus the point's self term.

        Returns (p_new, attn_vis [B, P, L]): the head mean of the normalised
        cross-attention weights.
        """
        kh, vh = cache
        qp, kp, vp = split_heads(self.attn.qkv(self.norm1(p)), self.num_heads)
        cross = (qp @ kh.transpose(-2, -1)) * self.scale  # [B, H, P, L]
        self_s = (qp * kp).sum(dim=-1, keepdim=True) * self.scale  # [B, H, P, 1]
        joint = torch.cat([cross, self_s], dim=-1).float().softmax(dim=-1).to(vh.dtype)
        out = joint[..., :-1] @ vh + joint[..., -1:] * vp
        attn_vis = joint[..., :-1].float().mean(dim=1)
        p = p + self.dp(self.attn.proj(out.transpose(1, 2).reshape(p.shape)), dp_mask)
        return p + self.dp(self.mlp(self.norm2(p)), dp_mask), attn_vis


class MLPBlocks(nn.Module):
    """Skip-connected occupancy MLP (reference implicit.py:133-184).

    ``num_hidden_layers`` hidden linears plus the output linear, Softplus
    (beta 100); the input ``[points | trunk]`` is re-concatenated after the
    state (scaled by 1/sqrt(2)) at the ``skip_in`` layers. With
    ``posenc_res`` > 0 the points enter NeRF-encoded (``nerf_posenc``, fp32)
    in the input and in every skip.
    """

    def __init__(self, num_hidden_layers: int, n_channels: int, skip_in=(), posenc_res: int = 0):
        super().__init__()
        self.skip_in = tuple(skip_in)
        self.posenc_res = posenc_res
        dims = [nerf_posenc_dim(3, posenc_res) + n_channels] + [n_channels] * num_hidden_layers + [1]
        self.layers = nn.ModuleList(
            nn.Linear(dims[l] + (dims[0] if l in self.skip_in else 0), dims[l + 1])
            for l in range(len(dims) - 1)
        )

    def forward(self, points, trunk_feat):
        if self.posenc_res > 0:
            points = nerf_posenc(points.float(), self.posenc_res)
        inputs = torch.cat([points.to(trunk_feat.dtype), trunk_feat], dim=-1)
        x = inputs
        for l, lin in enumerate(self.layers):
            if l in self.skip_in:
                x = torch.cat([x, inputs.to(x.dtype)], dim=-1) / math.sqrt(2.0)
            x = lin(x)
            if l < len(self.layers) - 1:
                x = softplus_beta(x, 100.0)
        return x


class Implicit(nn.Module):
    """Implicit occupancy function conditioned on visible-surface latents.

    ``dtype`` is the compute dtype (bf16 runs under autocast); parameters
    stay fp32. ``drop_path`` is the stochastic-depth rate of training
    (implicit.py:168). The options of ``zeroshape_tpu/models/implicit.py``:

    * ``semantic``: the latent trunk takes ``[latent_depth |
      latent_semantic]`` on the feature axis; ``latent_dim`` is then the
      width of both together;
    * ``posenc_3D``: NeRF frequencies of the points in the skip MLP;
    * ``pos_perlayer``: the pos-embed is added before every block, not only
      the first;
    * ``n_layers_mlp == 0``: a linear ``pred_head`` (xavier) replaces the
      skip MLP.
    """

    def __init__(
        self,
        num_patches=196,
        latent_dim=256,
        n_channels=256,
        n_blocks_attn=2,
        n_layers_mlp=8,
        num_heads=8,
        mlp_ratio=4.0,
        skip_in=(2, 4, 6),
        drop_path=0.1,
        dtype=torch.float32,
        semantic=False,
        posenc_3D=0,
        pos_perlayer=False,
    ):
        super().__init__()
        self.dtype = dtype
        self.drop_path = drop_path
        self.num_heads = num_heads
        self.semantic = semantic
        self.pos_perlayer = pos_perlayer
        self.point_proj = nn.Module()
        self.point_proj.proj = nn.Linear(3, n_channels)
        self.latent_proj = nn.Linear(latent_dim, n_channels)
        pe = get_2d_sincos_pos_embed(n_channels, int(num_patches**0.5), cls_token=True)
        self.register_buffer("pos_embed", torch.from_numpy(pe)[None])
        self.blocks_attn = nn.ModuleList(
            ImplicitBlock(n_channels, num_heads, mlp_ratio, drop_path, last_layer=(i == n_blocks_attn - 1))
            for i in range(n_blocks_attn)
        )
        self.norm = nn.LayerNorm(n_channels, eps=1e-6)
        if n_layers_mlp > 0:
            self.impl_mlp, self.pred_head = MLPBlocks(n_layers_mlp, n_channels, skip_in, posenc_3D), None
        else:
            self.impl_mlp, self.pred_head = None, nn.Linear(n_channels, 1)

    @property
    def output_layer(self):
        """The linear that gives the logits: the skip MLP's last, or ``pred_head``."""
        return self.pred_head if self.impl_mlp is None else self.impl_mlp.layers[-1]

    def dp_masks(self, batch, generator=None, device=None):
        """One stochastic-depth mask per block, shared by the latent and point
        streams of a sample (implicit.py:211-221); Nones outside training."""
        if not self.training or self.drop_path == 0.0:
            return [None] * len(self.blocks_attn)
        return [make_drop_path_mask(generator, batch, self.drop_path, device) for _ in self.blocks_attn]

    def encode(self, latent_depth, latent_semantic=None, dp_masks=None):
        """Run the latent trunk once; returns the per-block (k, v) caches.
        A semantic decoder takes ``latent_semantic`` beside ``latent_depth``."""
        if self.semantic and latent_semantic is None:
            raise ValueError("a semantic decoder needs latent_semantic")
        dp_masks = dp_masks or [None] * len(self.blocks_attn)
        with compute_autocast(latent_depth.device, self.dtype):
            latent = latent_depth
            if self.semantic:
                latent = torch.cat([latent_depth, latent_semantic.to(latent_depth.dtype)], dim=-1)
            h = self.latent_proj(latent)
            caches = []
            for l, (blk, m) in enumerate(zip(self.blocks_attn, dp_masks)):
                if self.pos_perlayer or l == 0:
                    h = h + self.pos_embed.to(h.dtype)
                h, cache = blk.latent_step(h, m)
                caches.append(cache)
        return caches

    def decode(self, caches, points_3D, dp_masks=None):
        """Score ``points_3D [B, P, 3]`` against the caches -> (logits [B, P], attn_vis [B, P, L])."""
        dp_masks = dp_masks or [None] * len(self.blocks_attn)
        with compute_autocast(points_3D.device, self.dtype):
            p = self.point_proj.proj(points_3D)
            attn_vis = []
            for blk, cache, m in zip(self.blocks_attn, caches, dp_masks):
                p, attn = blk.point_step(p, cache, m)
                attn_vis.append(attn)
            out = self.norm(p)
            occ = self.pred_head(out) if self.impl_mlp is None else self.impl_mlp(points_3D, out)
        return occ[..., 0].float(), torch.stack(attn_vis, dim=-1).mean(dim=-1)

    def forward(self, latent_depth, latent_semantic, points_3D, train=False, generator=None, dp_masks=None):
        """The training forward (implicit.py:256-259): latent trunk then the
        plain decode, with autograd; stochastic depth under ``train``, from
        ``dp_masks`` if given, else drawn from ``generator``. Never the
        fused kernel, which has no backward. ``latent_semantic`` is None
        unless the decoder is semantic."""
        if train != self.training:
            raise ValueError(f"forward(train={train}) on a module in {'train' if self.training else 'eval'} mode")
        if dp_masks is None:
            dp_masks = self.dp_masks(points_3D.shape[0], generator, points_3D.device)
        return self.decode(self.encode(latent_depth, latent_semantic, dp_masks), points_3D, dp_masks)
