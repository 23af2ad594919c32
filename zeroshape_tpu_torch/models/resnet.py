"""ResNet backbones (counterpart of ``zeroshape_tpu/models/resnet.py``).

  * :class:`ResNet50` — torchvision layout (BatchNorm, stride on the 3x3),
    the coordinate encoder's trunk; returns the stage features and the pool.
  * :class:`ResNetV2Stem` — the timm ``vit_base_resnet50_384`` hybrid stem:
    weight-standardised TF-SAME convs, GroupNorm(32), stages (3, 4, 9),
    total stride 16. Stages 0 and 1 are the DPT's first two feature taps.

Submodule names follow torchvision / timm so the reference state dict loads
as is.
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from zeroshape_tpu_torch.models.layers import BatchNorm, Conv, StdConvSame, max_pool_same


# ---------------------------------------------------------------------------
# Classic ResNet-50 (resnet.py:35-93)
# ---------------------------------------------------------------------------

class BottleneckV1(nn.Module):
    def __init__(self, in_ch: int, mid: int, out: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv(in_ch, mid, 1, bias=False)
        self.bn1 = BatchNorm(mid)
        self.conv2 = Conv(mid, mid, 3, stride=stride, bias=False)
        self.bn2 = BatchNorm(mid)
        self.conv3 = Conv(mid, out, 1, bias=False)
        self.bn3 = BatchNorm(out)
        self.downsample = None
        if in_ch != out or stride != 1:
            self.downsample = nn.Sequential(Conv(in_ch, out, 1, stride=stride, bias=False), BatchNorm(out))

    def forward(self, x):
        short = x if self.downsample is None else self.downsample(x)
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return F.relu(h + short)


class ResNet50(nn.Module):
    """torchvision resnet50 trunk. Returns (stage features dict, pooled [B, 2048])."""

    def __init__(self, layers=(3, 4, 6, 3)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        in_ch = 64
        for stage, (n_blocks, width) in enumerate(zip(layers, (256, 512, 1024, 2048))):
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                blocks.append(BottleneckV1(in_ch, width // 4, width, stride))
                in_ch = width
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        feats = {}
        for stage in range(1, 5):
            h = getattr(self, f"layer{stage}")(h)
            feats[f"layer{stage}"] = h
        return feats, h.mean(dim=(2, 3))


# ---------------------------------------------------------------------------
# ResNetV2 hybrid stem (resnet.py:100-160)
# ---------------------------------------------------------------------------

class GNAct(nn.GroupNorm):
    """GroupNorm(32, eps 1e-5) with an optional ReLU."""

    def __init__(self, channels: int, act: bool = True):
        super().__init__(32, channels, eps=1e-5)
        self.act = act

    def forward(self, x):
        x = super().forward(x)
        return F.relu(x) if self.act else x


class BottleneckV2(nn.Module):
    """timm ResNetV2 post-activation bottleneck (preact=False)."""

    def __init__(self, in_ch: int, out: int, stride: int = 1):
        super().__init__()
        mid = out // 4
        self.conv1 = StdConvSame(in_ch, mid, 1)
        self.norm1 = GNAct(mid)
        self.conv2 = StdConvSame(mid, mid, 3, stride=stride)
        self.norm2 = GNAct(mid)
        self.conv3 = StdConvSame(mid, out, 1)
        self.norm3 = GNAct(out, act=False)
        self.downsample = None
        if in_ch != out or stride != 1:
            self.downsample = nn.ModuleDict(
                {"conv": StdConvSame(in_ch, out, 1, stride=stride), "norm": GNAct(out, act=False)}
            )

    def forward(self, x):
        short = x
        if self.downsample is not None:
            short = self.downsample["norm"](self.downsample["conv"](x))
        h = self.norm1(self.conv1(x))
        h = self.norm2(self.conv2(h))
        h = self.norm3(self.conv3(h))
        return F.relu(h + short)


class ResNetV2Stem(nn.Module):
    """Returns (stage0 [B, 256, H/4, W/4], stage1 [B, 512, H/8, W/8],
    final [B, 1024, H/16, W/16])."""

    def __init__(self, layers=(3, 4, 9), widths=(256, 512, 1024)):
        super().__init__()
        self.stem = nn.ModuleDict({"conv": StdConvSame(3, 64, 7, stride=2), "norm": GNAct(64)})
        self.stages = nn.ModuleList()
        in_ch = 64
        for s, (n_blocks, width) in enumerate(zip(layers, widths)):
            blocks = nn.ModuleList()
            for b in range(n_blocks):
                blocks.append(BottleneckV2(in_ch, width, 2 if (s > 0 and b == 0) else 1))
                in_ch = width
            self.stages.append(nn.ModuleDict({"blocks": blocks}))

    def forward(self, x):
        h = max_pool_same(self.stem["norm"](self.stem["conv"](x)), 3, 2)
        taps = []
        for stage in self.stages:
            for block in stage["blocks"]:
                h = block(h)
            taps.append(h)
        return taps[0], taps[1], h
