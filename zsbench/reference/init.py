"""Seeded weights, made on the device in one draw.

The rules follow the JAX package's initialisers as the shipped model starts
from them: kernels lecun-normal (std 1 / sqrt(fan_in)); the implicit
decoder's projections, attention and skip MLP xavier-normal; norms identity
and BatchNorm statistics (0, 1); the ViT position embedding, the cls tokens
and the invalid-coordinate token normal(0.02). Four departures, so that
the comparison reaches every layer and the untrained network behaves as a
trained one does under rounding:

* the last layer of every residual branch is scaled by :data:`RESIDUAL`
  (0.1): the attention projection and second MLP linear of each ViT block
  (the DPT's and the transformer encoders'), the last GroupNorm of each
  ResNetV2 bottleneck, the last BatchNorm of each ResNet-50 bottleneck and
  the second conv of each DPT residual unit, as LayerScale and timm's
  ``zero_init_last`` start them. At full scale the untrained ViT's tokens
  collapse onto one another and its LayerNorms amplify rounding about
  forty times: bf16 and fp8 then read alike (a relative depth gap of 0.17
  against 0.52), and no comparison could tell a lower precision;
* biases are normal(0.01) instead of zero;
* the intrinsics projection is lecun-normal scaled by 0.1 instead of zero;
* the depth head's last conv is lecun-normal scaled by 0.1 with bias 0.5
  instead of 1 and 0.05, so that the predicted depth lies inside (0, 1)
  rather than on the ReLU's and the clamp's edges (a map that is zero over a
  whole mask leaves the visible surface without a scale). Every random number comes from
one ``torch.randn`` call of a ``torch.Generator`` on the device.
"""

import math

import torch
import torch.nn as nn

from zsbench.reference.dpt import BottleneckV2, DPTDepth, HybridViT, ResidualConvUnit
from zsbench.reference.dpt import ViTBlock as DPTBlock
from zsbench.reference.parts import Bottleneck, CoordEmb, CoordEncAtt, Implicit, RGBEncAtt, ViTBlock

RESIDUAL = 0.1
BIAS_STD = 0.01
TOKEN_STD = 0.02


def _fans(w):
    receptive = w[0][0].numel() if w.dim() > 2 else 1
    return w.shape[1] * receptive, w.shape[0] * receptive


def init_weights(graph, seed, device):
    """Fill ``graph``'s parameters and BatchNorm statistics from ``seed``; returns ``graph``."""
    xavier = set()
    for mod in graph.modules():
        if isinstance(mod, Implicit):
            xavier |= {id(mod.point_proj.proj), id(mod.latent_proj)} | {id(l) for l in mod.impl_mlp.layers}
            for blk in mod.blocks_attn:
                xavier |= {id(blk.attn.qkv), id(blk.attn.proj)}
    draws = []  # (tensor, std): filled with std * normal
    with torch.no_grad():
        for mod in graph.modules():
            if isinstance(mod, (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                if isinstance(mod, nn.BatchNorm2d):
                    mod.running_mean.zero_()
                    mod.running_var.fill_(1.0)
            elif isinstance(mod, (nn.Linear, nn.Conv2d)):
                fan_in, fan_out = _fans(mod.weight)
                std = math.sqrt(2.0 / (fan_in + fan_out)) if id(mod) in xavier else math.sqrt(1.0 / fan_in)
                draws.append((mod.weight, std))
                if mod.bias is not None:
                    draws.append((mod.bias, BIAS_STD))
            if isinstance(mod, HybridViT):
                draws += [(mod.pos_embed, TOKEN_STD), (mod.cls_token, TOKEN_STD)]
            if isinstance(mod, CoordEmb):
                draws += [(mod.invalid_coord_token, TOKEN_STD), (mod.cls_token, TOKEN_STD)]
            if isinstance(mod, (CoordEncAtt, RGBEncAtt)):
                draws.append((mod.cls_token, TOKEN_STD))
        noise = torch.randn(sum(t.numel() for t, _ in draws), generator=torch.Generator(device=device).manual_seed(seed),
                            device=device)
        off = 0
        for t, std in draws:
            t.copy_(noise[off: off + t.numel()].view_as(t) * std)
            off += t.numel()
        for mod in graph.modules():
            if isinstance(mod, (DPTBlock, ViTBlock)):
                mod.attn.proj.weight.mul_(RESIDUAL)
                mod.mlp.fc2.weight.mul_(RESIDUAL)
            elif isinstance(mod, BottleneckV2):
                mod.norm3.weight.mul_(RESIDUAL)
            elif isinstance(mod, Bottleneck):
                mod.bn3.weight.mul_(RESIDUAL)
            elif isinstance(mod, ResidualConvUnit):
                mod.conv2.weight.mul_(RESIDUAL)
            if isinstance(mod, DPTDepth):
                mod.scratch.output_conv[4].weight.mul_(0.1)
                mod.scratch.output_conv[4].bias.fill_(0.5)
        graph.intr.intr_proj.weight.mul_(0.1)
    return graph


def build_reference(cfg, seed, device):
    """The plain graph of configuration ``cfg`` (its file's ``options``) on
    ``device`` in float32 with the seed's weights, in eval mode."""
    from zsbench.reference.graph import ShapeGraph

    with torch.device(device):
        graph = ShapeGraph(cfg)
    # buffers made from numpy stay on the host under the device context
    return init_weights(graph.to(device), seed, device).eval()
