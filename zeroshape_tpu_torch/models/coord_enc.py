"""Visible-surface coordinate encoder (counterpart of ``models/coord_enc.py:31-56``).

:class:`CoordEncRes` — a ResNet-50 on the masked coordinate map; the global
token comes from the pooled trunk through two conv bottlenecks and a linear,
the local tokens from the stride-16 (layer3) features through two conv
bottlenecks and a 1x1 conv (reference model/shape/seen_coord_enc.py:141-194).
Names follow the reference layout: ``encoder.*``, ``encoder.fc.{0,1,2}``,
``depth_feat_proj.{0,1,2}``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from zeroshape_tpu_torch.models.layers import BottleneckConv
from zeroshape_tpu_torch.models.resnet import ResNet50


class CoordEncRes(nn.Module):
    """NCHW coord map + mask -> ``[B, 1 + (H/ws)(W/ws), latent_dim]`` tokens."""

    def __init__(self, latent_dim: int = 256, win_size: int = 16):
        super().__init__()
        self.win_size = win_size
        self.encoder = ResNet50()
        # the reference hangs the global-token head on the trunk's ``fc`` slot
        self.encoder.fc = nn.Sequential(
            BottleneckConv(2048), BottleneckConv(2048), nn.Linear(2048, latent_dim)
        )
        tap_ch = 1024 if win_size == 16 else 2048
        self.depth_feat_proj = nn.Sequential(
            BottleneckConv(tap_ch), BottleneckConv(tap_ch), nn.Conv2d(tap_ch, latent_dim, 1)
        )

    def forward(self, coord_map, mask_map):
        x = coord_map * mask_map.to(coord_map.dtype)
        feats, pooled = self.encoder(x)
        g = self.encoder.fc(pooled)[:, None, :]
        tap = feats["layer3"] if self.win_size == 16 else feats["layer4"]
        l = self.depth_feat_proj(tap).flatten(2).transpose(1, 2)
        return torch.cat([g.to(l.dtype), l], dim=1)
