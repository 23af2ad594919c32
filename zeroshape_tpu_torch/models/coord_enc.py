"""Visible-surface coordinate encoders (counterpart of ``models/coord_enc.py``).

* :class:`CoordEncRes` (the shipped configuration) — a ResNet-50 on the
  masked coordinate map; the global token comes from the pooled trunk
  through two conv bottlenecks and a linear, the local tokens from the
  stride-16 (layer3) features through two conv bottlenecks and a 1x1 conv
  (reference model/shape/seen_coord_enc.py:141-194). Names follow the
  reference layout: ``encoder.*``, ``encoder.fc.{0,1,2}``,
  ``depth_feat_proj.{0,1,2}``.
* :class:`CoordEncAtt` (``arch.depth.encoder: transformer``) — each
  ``win_size``-square window of the coordinate map becomes one token
  (:class:`CoordEmb`), then a cls token, ``n_blocks`` ViT blocks and a
  LayerNorm (seen_coord_enc.py:13-139). The reference's torch names of this
  encoder are not recorded in the repo; the port uses timm's layout:
  ``coord_embed.{pos_embed, invalid_coord_token, cls_token, blocks.0.*}``,
  ``cls_token``, ``blocks.{i}.{norm1, attn.qkv, attn.proj, norm2, mlp.fc1,
  mlp.fc2}``, ``norm``. The fixed sin-cos table is a buffer outside the
  state dict.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from zeroshape_tpu_torch.models.layers import BottleneckConv, ViTBlock, block_masks, get_2d_sincos_pos_embed
from zeroshape_tpu_torch.models.resnet import ResNet50


def resnet_with_heads(latent_dim, win_size):
    """The ResNet-50 trunk with the global-token head in its ``fc`` slot (as
    the reference hangs it), and the local-token head for the stride-
    ``win_size`` stage."""
    encoder = ResNet50()
    encoder.fc = nn.Sequential(BottleneckConv(2048), BottleneckConv(2048), nn.Linear(2048, latent_dim))
    tap_ch = 1024 if win_size == 16 else 2048
    return encoder, nn.Sequential(BottleneckConv(tap_ch), BottleneckConv(tap_ch), nn.Conv2d(tap_ch, latent_dim, 1))


def resnet_tokens(encoder, feat_proj, x, win_size):
    """NCHW ``x`` -> ``[B, 1 + (H/ws)(W/ws), latent_dim]``: the global token,
    then the local tokens in row-major order."""
    feats, pooled = encoder(x)
    g = encoder.fc(pooled)[:, None, :]
    tap = feats["layer3"] if win_size == 16 else feats["layer4"]
    l = feat_proj(tap).flatten(2).transpose(1, 2)
    return torch.cat([g.to(l.dtype), l], dim=1)


class CoordEncRes(nn.Module):
    """NCHW coord map + mask -> ``[B, 1 + (H/ws)(W/ws), latent_dim]`` tokens."""

    def __init__(self, latent_dim: int = 256, win_size: int = 16):
        super().__init__()
        self.win_size = win_size
        self.encoder, self.depth_feat_proj = resnet_with_heads(latent_dim, win_size)

    def forward(self, coord_map, mask_map):
        x = coord_map * mask_map.to(coord_map.dtype)
        return resnet_tokens(self.encoder, self.depth_feat_proj, x, self.win_size)


def sincos_table(embed_dim, grid):
    """The fixed ``[1, 1 + grid^2, C]`` sin-cos table with its zero cls row."""
    return torch.from_numpy(get_2d_sincos_pos_embed(embed_dim, grid, cls_token=True))[None]


class CoordEmb(nn.Module):
    """Window-attention patch embedding (coord_enc.py:59-90): every
    ``win_size``-square window of the coordinate map becomes one token.

    A linear ``pos_embed`` lifts each point to C; pixels off the mask take
    the learnt ``invalid_coord_token``; each window's ws^2 tokens get the
    fixed sin-cos grid of side ws and a cls token (with the grid's zero cls
    row), go through one ViT block (mlp ratio 2, no drop path), and the cls
    token comes out.
    """

    def __init__(self, embed_dim: int, win_size: int = 8, num_heads: int = 8):
        super().__init__()
        self.win_size = win_size
        self.pos_embed = nn.Linear(3, embed_dim)
        self.invalid_coord_token = nn.Parameter(torch.zeros(embed_dim))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.register_buffer("two_d_pos_embed", sincos_table(embed_dim, win_size), persistent=False)
        self.blocks = nn.ModuleList([ViTBlock(embed_dim, num_heads, 2.0)])

    def forward(self, coord_map, mask):
        """``coord_map [B, 3, H, W]``, boolean ``mask [B, H, W]`` ->
        ``[B, (H/ws)(W/ws), C]``, windows in row-major order."""
        B, _, H, W = coord_map.shape
        ws, C = self.win_size, self.invalid_coord_token.shape[0]
        emb = self.pos_embed(coord_map.permute(0, 2, 3, 1))
        m = mask[..., None].to(emb.dtype)
        emb = emb * m + self.invalid_coord_token.to(emb.dtype) * (1.0 - m)
        emb = emb.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)
        pe = self.two_d_pos_embed
        emb = emb + pe[:, 1:].to(emb.dtype)
        cls = (self.cls_token + pe[:, :1]).to(emb.dtype).expand(emb.shape[0], -1, -1)
        emb = self.blocks[0](torch.cat([cls, emb], dim=1), (None, None))
        return emb[:, 0].reshape(B, (H // ws) * (W // ws), C)


class CoordEncAtt(nn.Module):
    """Transformer visible-surface encoder (coord_enc.py:93-121): NCHW coord
    map + boolean mask -> ``[B, 1 + (H/ws)(W/ws), embed_dim]``.

    ``forward`` takes each block's two stochastic-depth masks as
    ``dp_masks`` or draws them from ``generator`` in training
    (``layers.block_masks``).
    """

    def __init__(self, embed_dim: int = 768, n_blocks: int = 12, num_heads: int = 12, win_size: int = 8,
                 drop_path: float = 0.1):
        super().__init__()
        self.coord_embed = CoordEmb(embed_dim, win_size, num_heads)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.blocks = nn.ModuleList(ViTBlock(embed_dim, num_heads, 4.0, drop_path=drop_path) for _ in range(n_blocks))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward(self, coord_map, mask, generator=None, dp_masks=None):
        emb = self.coord_embed(coord_map, mask)
        B = emb.shape[0]
        emb = torch.cat([self.cls_token.to(emb.dtype).expand(B, -1, -1), emb], dim=1)
        for blk, m in zip(self.blocks, block_masks(self.blocks, B, generator, emb.device, dp_masks)):
            emb = blk(emb, m)
        return self.norm(emb)
