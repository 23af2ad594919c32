"""Plain DPT depth stack of the shipped ZeroShape (ViT-B/16 over a ResNet-50 stem).

A frozen copy of the repository's torch oracle of the reference DPT
(``vit_base_resnet50_384`` semantics and the reference DPT decoder), with the
released state-dict key layout: ``pretrained.model.patch_embed.backbone.*``,
``pretrained.model.{cls_token,pos_embed,blocks.*,norm}``,
``pretrained.act_postprocess{3,4}.*``, ``scratch.*``. Plain torch in float32;
it imports nothing of the program under test.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# timm layer semantics
# ---------------------------------------------------------------------------

class StdConv2dSame(nn.Conv2d):
    """Weight-standardized conv with TF-SAME dynamic padding (timm StdConv2dSame)."""

    def __init__(self, in_ch, out_ch, k, stride=1, bias=False, eps=1e-6):
        super().__init__(in_ch, out_ch, k, stride=stride, padding=0, bias=bias)
        self.eps = eps

    def forward(self, x):
        w = self.weight
        var, mean = torch.var_mean(w.reshape(w.shape[0], -1), dim=1, unbiased=False)
        w = (w - mean.reshape(-1, 1, 1, 1)) / torch.sqrt(
            var.reshape(-1, 1, 1, 1) + self.eps
        )
        x = _pad_same(x, self.kernel_size, self.stride)
        return F.conv2d(x, w, self.bias, self.stride, 0)


def _pad_same(x, kernel, stride, value=0.0):
    ih, iw = x.shape[-2:]
    pad_h = _same_pad_amount(ih, kernel[0], stride[0])
    pad_w = _same_pad_amount(iw, kernel[1], stride[1])
    return F.pad(
        x,
        [pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2],
        value=value,
    )


def _same_pad_amount(size, k, s):
    return max((math.ceil(size / s) - 1) * s + k - size, 0)


class MaxPool2dSame(nn.Module):
    def __init__(self, k=3, stride=2):
        super().__init__()
        self.k, self.stride = (k, k), (stride, stride)

    def forward(self, x):
        x = _pad_same(x, self.k, self.stride, value=float("-inf"))
        return F.max_pool2d(x, self.k, self.stride, 0)


class GroupNormAct(nn.GroupNorm):
    def __init__(self, channels, act=True):
        super().__init__(32, channels, eps=1e-5)
        self.act = act

    def forward(self, x):
        x = super().forward(x)
        return F.relu(x) if self.act else x


class BottleneckV2(nn.Module):
    """timm ResNetV2 post-activation bottleneck (preact=False)."""

    def __init__(self, in_ch, out_ch, stride=1):
        super().__init__()
        mid = out_ch // 4
        self.conv1 = StdConv2dSame(in_ch, mid, 1)
        self.norm1 = GroupNormAct(mid)
        self.conv2 = StdConv2dSame(mid, mid, 3, stride=stride)
        self.norm2 = GroupNormAct(mid)
        self.conv3 = StdConv2dSame(mid, out_ch, 1)
        self.norm3 = GroupNormAct(out_ch, act=False)
        if in_ch != out_ch or stride != 1:
            self.downsample = nn.Module()
            self.downsample.conv = StdConv2dSame(in_ch, out_ch, 1, stride=stride)
            self.downsample.norm = GroupNormAct(out_ch, act=False)
        else:
            self.downsample = None

    def forward(self, x):
        short = x
        if self.downsample is not None:
            short = self.downsample.norm(self.downsample.conv(x))
        h = self.norm1(self.conv1(x))
        h = self.norm2(self.conv2(h))
        h = self.norm3(self.conv3(h))
        return F.relu(h + short)


class ResNetV2Backbone(nn.Module):
    """Hybrid stem: stages (3, 4, 9), widths (256, 512, 1024), stride 16."""

    def __init__(self):
        super().__init__()
        self.stem = nn.Module()
        self.stem.conv = StdConv2dSame(3, 64, 7, stride=2)
        self.stem.norm = GroupNormAct(64)
        self.pool = MaxPool2dSame(3, 2)
        self.stages = nn.ModuleList()
        in_ch = 64
        for s, (n_blocks, width) in enumerate(zip((3, 4, 9), (256, 512, 1024))):
            stage = nn.Module()
            stage.blocks = nn.ModuleList()
            for b in range(n_blocks):
                stride = 2 if (s > 0 and b == 0) else 1
                stage.blocks.append(BottleneckV2(in_ch, width, stride))
                in_ch = width
            self.stages.append(stage)

    def forward(self, x):
        h = self.pool(self.stem.norm(self.stem.conv(x)))
        taps = []
        for stage in self.stages:
            for block in stage.blocks:
                h = block(h)
            taps.append(h)
        return taps  # [stage0, stage1, stage2]


class ViTBlock(nn.Module):
    def __init__(self, dim=768, heads=12):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = nn.Module()
        self.attn.qkv = nn.Linear(dim, dim * 3, bias=True)
        self.attn.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(dim, dim * 4)
        self.mlp.fc2 = nn.Linear(dim * 4, dim)
        self.heads = heads

    def _attention(self, x):
        B, N, C = x.shape
        hd = C // self.heads
        qkv = self.attn.qkv(x).reshape(B, N, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        a = (q @ k.transpose(-2, -1)) * hd**-0.5
        a = a.softmax(dim=-1)
        out = (a @ v).transpose(1, 2).reshape(B, N, C)
        return self.attn.proj(out)

    def forward(self, x):
        x = x + self._attention(self.norm1(x))
        x = x + self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))
        return x


class HybridViT(nn.Module):
    """vit_base_resnet50_384 semantics with multi-level taps returned
    (the reference taps these via forward hooks, model/depth/vit.py:362-370)."""

    def __init__(self, depth=12, dim=768, native_grid=24, hooks=(8, 11)):
        super().__init__()
        self.patch_embed = nn.Module()
        self.patch_embed.backbone = ResNetV2Backbone()
        self.patch_embed.proj = nn.Conv2d(1024, dim, 1)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + native_grid**2, dim))
        self.blocks = nn.ModuleList([ViTBlock(dim) for _ in range(depth)])
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.native_grid = native_grid
        self.hooks = hooks

    def _resized_pos_embed(self, gs_h, gs_w):
        # reference vit.py:101-115: bilinear grid resize, cls passed through
        tok, grid = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        if (gs_h, gs_w) == (self.native_grid, self.native_grid):
            return self.pos_embed
        grid = grid.reshape(1, self.native_grid, self.native_grid, -1).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, size=(gs_h, gs_w), mode="bilinear", align_corners=False)
        grid = grid.flatten(2).transpose(1, 2)
        return torch.cat([tok, grid], dim=1)

    def forward(self, x):
        B = x.shape[0]
        taps_cnn = self.patch_embed.backbone(x)
        feat = taps_cnn[-1]
        gs_h, gs_w = feat.shape[-2:]
        tokens = self.patch_embed.proj(feat).flatten(2).transpose(1, 2)
        tokens = torch.cat([self.cls_token.expand(B, -1, -1), tokens], dim=1)
        tokens = tokens + self._resized_pos_embed(gs_h, gs_w)
        taps_vit = {}
        for i, block in enumerate(self.blocks):
            tokens = block(tokens)
            if i in self.hooks:
                taps_vit[i] = tokens
        self.norm(tokens)  # checkpoint parity; DPT taps are pre-norm
        return taps_cnn[0], taps_cnn[1], taps_vit[self.hooks[0]], taps_vit[self.hooks[1]]


# ---------------------------------------------------------------------------
# DPT decoder semantics (reference model/depth/blocks.py, vit.py:376-461)
# ---------------------------------------------------------------------------

class ProjectReadout(nn.Module):
    def __init__(self, dim=768):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, tokens):
        readout = tokens[:, :1].expand_as(tokens[:, 1:])
        return self.project(torch.cat([tokens[:, 1:], readout], dim=-1))


class TokensToMap(nn.Module):
    """Transpose+unflatten placeholder (Sequential indices 1-2, paramless)."""

    def __init__(self, gs):
        super().__init__()
        self.gs = gs

    def forward(self, t):
        B, N, C = t.shape
        return t.transpose(1, 2).reshape(B, C, self.gs[0], self.gs[1])


class ResidualConvUnit(nn.Module):
    def __init__(self, features=256):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        h = self.conv1(F.relu(x))
        h = self.conv2(F.relu(h))
        return h + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, features=256):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        return self.out_conv(x)


class DPTDepth(nn.Module):
    """Reference DPTDepthModel semantics with the released key layout.

    forward(x in [0,1]) -> (depth [B,1,H,W] clamped to [0,1],
    layer_4 reassembled feature [B,768,H/32,W/32]) — the get_feat=True
    return pair of reference dpt_depth.py:115-123.
    """

    def __init__(self, H=64, W=64, features=256, dim=768):
        super().__init__()
        gs = (H // 16, W // 16)
        self.pretrained = nn.Module()
        self.pretrained.model = HybridViT()
        self.pretrained.act_postprocess3 = nn.Sequential(
            ProjectReadout(dim), TokensToMap(gs), nn.Identity(), nn.Conv2d(dim, dim, 1)
        )
        self.pretrained.act_postprocess4 = nn.Sequential(
            ProjectReadout(dim), TokensToMap(gs), nn.Identity(), nn.Conv2d(dim, dim, 1),
            nn.Conv2d(dim, dim, 3, stride=2, padding=1),
        )
        self.scratch = nn.Module()
        self.scratch.layer1_rn = nn.Conv2d(256, features, 3, padding=1, bias=False)
        self.scratch.layer2_rn = nn.Conv2d(512, features, 3, padding=1, bias=False)
        self.scratch.layer3_rn = nn.Conv2d(dim, features, 3, padding=1, bias=False)
        self.scratch.layer4_rn = nn.Conv2d(dim, features, 3, padding=1, bias=False)
        self.scratch.refinenet1 = FeatureFusionBlock(features)
        self.scratch.refinenet2 = FeatureFusionBlock(features)
        self.scratch.refinenet3 = FeatureFusionBlock(features)
        self.scratch.refinenet4 = FeatureFusionBlock(features)
        self.scratch.output_conv = nn.Sequential(
            nn.Conv2d(features, 128, 3, padding=1),
            nn.Identity(),  # Interpolate(scale=2, align_corners=True)
            nn.Conv2d(128, 32, 3, padding=1),
            nn.ReLU(),
            nn.Conv2d(32, 1, 1),
            nn.ReLU(),
        )

    def forward(self, x):
        x = x * 2.0 - 1.0
        l1, l2, t3, t4 = self.pretrained.model(x)
        l3 = self.pretrained.act_postprocess3(t3)
        l4 = self.pretrained.act_postprocess4(t4)
        r1 = self.scratch.layer1_rn(l1)
        r2 = self.scratch.layer2_rn(l2)
        r3 = self.scratch.layer3_rn(l3)
        r4 = self.scratch.layer4_rn(l4)
        path4 = self.scratch.refinenet4(r4)
        path3 = self.scratch.refinenet3(path4, r3)
        path2 = self.scratch.refinenet2(path3, r2)
        path1 = self.scratch.refinenet1(path2, r1)
        oc = self.scratch.output_conv
        h = oc[0](path1)
        h = F.interpolate(h, scale_factor=2, mode="bilinear", align_corners=True)
        h = oc[3](oc[2](h))
        h = oc[5](oc[4](h))
        return torch.clamp(h, 0.0, 1.0), l4
