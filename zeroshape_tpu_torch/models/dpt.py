"""DPT monocular depth stack (counterpart of ``zeroshape_tpu/models/dpt.py``).

Hybrid ViT-B/16 over a ResNetV2-50 stem, project-readout reassembly, four
fusion blocks and the depth head. Submodule names follow the reference
state-dict layout (``pretrained.model.*``, ``pretrained.act_postprocess{3,4}``,
``scratch.*``); the paramless slots of the reference ``Sequential``s are
``nn.Identity`` placeholders so the indices line up.

Pipeline at 224x224 (hooks at blocks 8 and 11):
  stage0 [B, 256, 56, 56], stage1 [B, 512, 28, 28] (ResNetV2 taps);
  block-8 / block-11 tokens -> readout -> [B, 768, 14, 14] / stride-2 conv;
  3x3 "scratch" convs to 256 ch -> fusion cascade (align_corners=True)
  -> head conv(128) -> 2x up -> conv(32) -> relu -> conv(1) -> relu -> clamp.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from zeroshape_tpu_torch.models.layers import Conv, ViTBlock
from zeroshape_tpu_torch.models.resnet import ResNetV2Stem
from zeroshape_tpu_torch.ops.image import resize_bilinear, upsample2x


class HybridViT(nn.Module):
    """ViT-B/16 over the ResNetV2 stem (timm vit_base_resnet50_384).

    Returns the four DPT taps: (stage0, stage1, tokens@block8,
    tokens@block11), token taps ``[B, 1 + (H/16)(W/16), 768]`` with cls.
    """

    def __init__(self, embed_dim=768, depth=12, num_heads=12, hooks=(8, 11), native_grid=24):
        super().__init__()
        self.patch_embed = nn.Module()
        self.patch_embed.backbone = ResNetV2Stem()
        self.patch_embed.proj = nn.Conv2d(1024, embed_dim, 1)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + native_grid**2, embed_dim))
        self.blocks = nn.ModuleList([ViTBlock(embed_dim, num_heads) for _ in range(depth)])
        # final norm exists for checkpoint parity; the DPT taps are pre-norm
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)
        self.hooks = hooks
        self.native_grid = native_grid

    def forward(self, x):
        B = x.shape[0]
        stage0, stage1, feat = self.patch_embed.backbone(x)
        tokens = self.patch_embed.proj(feat)
        gs = tuple(tokens.shape[-2:])
        tokens = tokens.flatten(2).transpose(1, 2)
        tokens = torch.cat([self.cls_token.expand(B, -1, -1).to(tokens.dtype), tokens], dim=1)
        tokens = tokens + _resize_pos_embed(self.pos_embed, self.native_grid, gs).to(tokens.dtype)
        taps = {}
        for i, block in enumerate(self.blocks):
            tokens = block(tokens)
            if i in self.hooks:
                taps[i] = tokens
        return stage0, stage1, taps[self.hooks[0]], taps[self.hooks[1]]


def _resize_pos_embed(pos_embed, native_grid: int, out_grid):
    """Bilinear pos-embed grid resize (align_corners=False), cls passed through."""
    if (native_grid, native_grid) == tuple(out_grid):
        return pos_embed
    tok, grid = pos_embed[:, :1], pos_embed[:, 1:]
    C = pos_embed.shape[-1]
    grid = grid.reshape(1, native_grid, native_grid, C).permute(0, 3, 1, 2)
    grid = resize_bilinear(grid, out_grid, align_corners=False)
    grid = grid.flatten(2).transpose(1, 2)
    return torch.cat([tok, grid], dim=1)


class ProjectReadout(nn.Module):
    """Fuse the cls token into every patch token: Linear([t; cls]) + GELU."""

    def __init__(self, dim=768):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, tokens):
        patches = tokens[:, 1:]
        readout = tokens[:, :1].expand_as(patches)
        return self.project(torch.cat([patches, readout], dim=-1))


class ResidualConvUnit(nn.Module):
    """relu-conv-relu-conv + skip (reference blocks.py:232-289, bn=False)."""

    def __init__(self, features=256):
        super().__init__()
        self.conv1 = Conv(features, features, 3)
        self.conv2 = Conv(features, features, 3)

    def forward(self, x):
        h = self.conv1(F.relu(x))
        h = self.conv2(F.relu(h))
        return h + x


class FeatureFusionBlock(nn.Module):
    """RCU fusion + 2x bilinear upsample (align_corners=True) + 1x1 out conv.

    ``resConfUnit1`` only runs when a skip input is given; the first block
    of the cascade (refinenet4) keeps it for the checkpoint layout.
    """

    def __init__(self, features=256):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = Conv(features, features, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        return self.out_conv(upsample2x(x, align_corners=True))


def _tokens_to_map(tokens, gs):
    B, N, C = tokens.shape
    return tokens.transpose(1, 2).reshape(B, C, gs[0], gs[1])


class DPTDepthModel(nn.Module):
    """DPT + depth head; input in [0, 1] is shifted to [-1, 1], output clamped to [0, 1].

    ``forward(image NCHW)`` returns (depth [B, 1, H, W], intr_feat
    [B, 768, H/32, W/32]); the latter is the deepest reassembled tap, which
    the intrinsics head consumes (dpt.py:193-232). ``head_init_scale`` is
    applied by the initialiser (``weights.init_like_flax``).
    """

    def __init__(self, features=256, dim=768, head_init_scale=1.0):
        super().__init__()
        self.head_init_scale = head_init_scale
        self.pretrained = nn.Module()
        self.pretrained.model = HybridViT(embed_dim=dim)
        ident = nn.Identity
        self.pretrained.act_postprocess3 = nn.Sequential(
            ProjectReadout(dim), ident(), ident(), nn.Conv2d(dim, dim, 1)
        )
        self.pretrained.act_postprocess4 = nn.Sequential(
            ProjectReadout(dim), ident(), ident(), nn.Conv2d(dim, dim, 1),
            nn.Conv2d(dim, dim, 3, stride=2, padding=1),
        )
        self.scratch = nn.Module()
        self.scratch.layer1_rn = Conv(256, features, 3, bias=False)
        self.scratch.layer2_rn = Conv(512, features, 3, bias=False)
        self.scratch.layer3_rn = Conv(dim, features, 3, bias=False)
        self.scratch.layer4_rn = Conv(dim, features, 3, bias=False)
        for n in range(1, 5):
            setattr(self.scratch, f"refinenet{n}", FeatureFusionBlock(features))
        self.scratch.output_conv = nn.Sequential(
            Conv(features, 128, 3), ident(), Conv(128, 32, 3), nn.ReLU(), nn.Conv2d(32, 1, 1), nn.ReLU()
        )

    def forward(self, image):
        x = image * 2.0 - 1.0
        B, _, H, W = x.shape
        gs = (H // 16, W // 16)
        pre = self.pretrained
        stage0, stage1, tap3, tap4 = pre.model(x)
        ap3, ap4 = pre.act_postprocess3, pre.act_postprocess4
        layer3 = ap3[3](_tokens_to_map(ap3[0](tap3), gs))
        layer4 = ap4[4](ap4[3](_tokens_to_map(ap4[0](tap4), gs)))

        sc = self.scratch
        path4 = sc.refinenet4(sc.layer4_rn(layer4))
        path3 = sc.refinenet3(path4, sc.layer3_rn(layer3))
        path2 = sc.refinenet2(path3, sc.layer2_rn(stage1))
        path1 = sc.refinenet1(path2, sc.layer1_rn(stage0))
        oc = sc.output_conv
        h = upsample2x(oc[0](path1), align_corners=True)
        h = F.relu(oc[2](h))
        h = F.relu(oc[4](h))
        return torch.clamp(h, 0.0, 1.0), layer4
