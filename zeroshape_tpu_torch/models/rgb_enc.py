"""RGB (semantic) encoders (counterpart of ``zeroshape_tpu/models/rgb_enc.py``),
selected by ``arch.rgb.encoder``; the shipped configuration has none.

* :class:`RGBEncRes` (``resnet``) — the coordinate encoder's ResNet-50 with
  the same two heads, on the RGB image. Its BatchNorm follows the module's
  mode (batch statistics by the flax rule in training, over the global
  batch under several ranks).
* :class:`RGBEncAtt` (``transformer``) — a ViT over ``win_size``-square
  patches with the fixed sin-cos grid and its cls row, ``n_blocks`` blocks
  with stochastic depth and a LayerNorm.

The reference's torch names of these modules are not recorded in the repo.
The port uses the coordinate encoder's layout for :class:`RGBEncRes`
(``encoder.*``, ``encoder.fc.{0,1,2}``, ``rgb_feat_proj.{0,1,2}``) and timm's
for :class:`RGBEncAtt` (``patch_embed.proj``, ``cls_token``,
``blocks.{i}.{norm1, attn.qkv, attn.proj, norm2, mlp.fc1, mlp.fc2}``,
``norm``); the sin-cos table is a buffer outside the state dict.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from zeroshape_tpu_torch.models.coord_enc import resnet_tokens, resnet_with_heads, sincos_table
from zeroshape_tpu_torch.models.layers import ViTBlock, block_masks


class RGBEncRes(nn.Module):
    """NCHW RGB -> ``[B, 1 + (H/ws)(W/ws), latent_dim]`` tokens (rgb_enc.py:23-43)."""

    def __init__(self, latent_dim: int = 256, win_size: int = 16):
        super().__init__()
        self.win_size = win_size
        self.encoder, self.rgb_feat_proj = resnet_with_heads(latent_dim, win_size)

    def forward(self, rgb):
        return resnet_tokens(self.encoder, self.rgb_feat_proj, rgb, self.win_size)


class RGBEncAtt(nn.Module):
    """NCHW RGB -> ``[B, 1 + (H/ws)(W/ws), embed_dim]`` (rgb_enc.py:46-84).

    ``forward`` takes each block's two stochastic-depth masks as
    ``dp_masks`` or draws them from ``generator`` in training.
    """

    def __init__(self, img_size: int = 224, embed_dim: int = 768, n_blocks: int = 12, num_heads: int = 12,
                 win_size: int = 16, drop_path: float = 0.1):
        super().__init__()
        self.win_size = win_size
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, embed_dim, win_size, stride=win_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.register_buffer("pos_embed", sincos_table(embed_dim, img_size // win_size), persistent=False)
        self.blocks = nn.ModuleList(ViTBlock(embed_dim, num_heads, 4.0, drop_path=drop_path) for _ in range(n_blocks))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward(self, rgb, generator=None, dp_masks=None):
        """``rgb [B, 3, img_size, img_size]`` -> tokens."""
        B = rgb.shape[0]
        emb = self.patch_embed.proj(rgb).flatten(2).transpose(1, 2)
        pe = self.pos_embed
        emb = emb + pe[:, 1:].to(emb.dtype)
        cls = (self.cls_token + pe[:, :1]).to(emb.dtype).expand(B, -1, -1)
        emb = torch.cat([cls, emb], dim=1)
        for blk, m in zip(self.blocks, block_masks(self.blocks, B, generator, emb.device, dp_masks)):
            emb = blk(emb, m)
        return self.norm(emb)
