"""Plain versions of the shape graph's other parts: the coordinate encoders,
the RGB encoder, the intrinsics head and the implicit decoder.

The ResNet-50 coordinate encoder, the intrinsics head and the decoder's
block are frozen copies of the repository's torch oracles of the reference
(``model/shape/seen_coord_enc.py``, ``graph_shape.py``,
``model/shape/implicit.py``), with the released state-dict key layout. The
decoder is split into its latent trunk (:meth:`Implicit.encode`) and the
decode of query points (:meth:`Implicit.decode`), which is the same
arithmetic as the oracle's one joint sequence: latents never attend to
points, and each point attends to the latents and to itself only. The
transformer encoders (``arch.depth.encoder: transformer``,
``arch.rgb.encoder: transformer``) follow the reference's
``seen_coord_enc.py:13-139`` and ``rgb_enc.py:46-84`` with timm's key
layout. Stochastic depth takes its per-sample masks as arguments; None is
the identity. Plain torch in float32; nothing of the program is imported.
"""

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def _keep(x, mask):
    """``x`` times a per-sample stochastic-depth mask ``[B]`` (None: identity)."""
    return x if mask is None else x * mask.reshape((x.shape[0],) + (1,) * (x.dim() - 1))


# ---------------------------------------------------------------------------
# torchvision-style ResNet-50 (BN, v1.5: stride on the 3x3)
# ---------------------------------------------------------------------------

class Bottleneck(nn.Module):
    def __init__(self, in_ch, mid, out_ch, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, mid, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(mid)
        self.conv2 = nn.Conv2d(mid, mid, 3, stride=stride, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(mid)
        self.conv3 = nn.Conv2d(mid, out_ch, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out_ch)
        if in_ch != out_ch or stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, out_ch, 1, stride=stride, bias=False),
                nn.BatchNorm2d(out_ch),
            )
        else:
            self.downsample = None

    def forward(self, x):
        short = self.downsample(x) if self.downsample is not None else x
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return F.relu(h + short)


class ResNet50(nn.Module):
    """torchvision resnet50 trunk; forward returns (stage features, pooled)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        in_ch = 64
        for stage, (n_blocks, width) in enumerate(zip((3, 4, 6, 3), (256, 512, 1024, 2048))):
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                blocks.append(Bottleneck(in_ch, width // 4, width, stride))
                in_ch = width
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        feats = {}
        for stage in range(1, 5):
            h = getattr(self, f"layer{stage}")(h)
            feats[f"layer{stage}"] = h
        pooled = F.adaptive_avg_pool2d(h, 1).flatten(1)
        return feats, pooled


class BottleneckConv(nn.Module):
    """Reference utils/layers.py:76-100 Bottleneck_Conv."""

    def __init__(self, channels, kernel_size=1):
        super().__init__()
        p = kernel_size // 2
        self.linear1 = nn.Conv2d(channels, channels, kernel_size, padding=p, bias=False)
        self.bn1 = nn.BatchNorm2d(channels)
        self.linear2 = nn.Conv2d(channels, channels, kernel_size, padding=p, bias=False)
        self.bn2 = nn.BatchNorm2d(channels)

    def forward(self, x):
        squeeze = x.dim() == 2
        if squeeze:
            x = x[:, :, None, None]
        h = F.relu(self.bn1(self.linear1(x)))
        h = self.bn2(self.linear2(h))
        out = F.relu(h + x)
        return out[:, :, 0, 0] if squeeze else out


class CoordEncRes(nn.Module):
    """Reference model/shape/seen_coord_enc.py:141-194 (win_size=16)."""

    def __init__(self, latent_dim=256):
        super().__init__()
        self.encoder = ResNet50()
        self.encoder.fc = nn.Sequential(BottleneckConv(2048), BottleneckConv(2048), nn.Linear(2048, latent_dim))
        self.depth_feat_proj = nn.Sequential(BottleneckConv(1024), BottleneckConv(1024), nn.Conv2d(1024, latent_dim, 1))

    def forward(self, coord_map, mask_map, dp_masks=None):
        x = coord_map * mask_map.float()
        feats, pooled = self.encoder(x)
        g = self.encoder.fc(pooled)[:, None, :]  # [B, 1, C]
        l = self.depth_feat_proj(feats["layer3"])  # [B, C, H/16, W/16]
        l = l.flatten(2).transpose(1, 2)  # [B, N, C]
        return torch.cat([g, l], dim=1)


class IntrHead(nn.Module):
    """Reference graph_shape.py:19-28: 2x Bottleneck_Conv(768, k=3) + pool +
    a linear to the 3 intrinsics parameters."""

    def __init__(self, channels=768):
        super().__init__()
        self.intr_head = nn.Sequential(BottleneckConv(channels, 3), BottleneckConv(channels, 3))
        self.intr_proj = nn.Linear(channels, 3)

    def forward(self, feat):
        h = self.intr_head(feat)
        h = F.adaptive_avg_pool2d(h, 1).flatten(1)
        return self.intr_proj(h)


def sincos_pos_embed(embed_dim, grid_size, cls_token=True):
    """Reference utils/pos_embed.py:21-47 (independent reimplementation)."""

    def emb_1d(pos):
        omega = np.arange(embed_dim // 4, dtype=np.float64) / (embed_dim / 4.0)
        omega = 1.0 / 10000**omega
        out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid_w, grid_h = np.meshgrid(np.arange(grid_size, dtype=np.float32), np.arange(grid_size, dtype=np.float32))
    pe = np.concatenate([emb_1d(grid_w), emb_1d(grid_h)], axis=1)
    if cls_token:
        pe = np.concatenate([np.zeros([1, embed_dim]), pe], axis=0)
    return torch.from_numpy(pe.astype(np.float32))[None]


# ---------------------------------------------------------------------------
# transformer encoders (timm ViT blocks with per-branch stochastic depth)
# ---------------------------------------------------------------------------

class ViTBlock(nn.Module):
    """Pre-norm block; ``masks`` is the (attention, MLP) branch's keep mask pair."""

    def __init__(self, dim, heads, mlp_ratio=4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = nn.Module()
        self.attn.qkv = nn.Linear(dim, dim * 3, bias=True)
        self.attn.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp.fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        self.heads = heads

    def _attention(self, x):
        B, N, C = x.shape
        hd = C // self.heads
        qkv = self.attn.qkv(x).reshape(B, N, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        a = ((qkv[0] @ qkv[1].transpose(-2, -1)) * hd**-0.5).softmax(dim=-1)
        return self.attn.proj((a @ qkv[2]).transpose(1, 2).reshape(B, N, C))

    def forward(self, x, masks=(None, None)):
        x = x + _keep(self._attention(self.norm1(x)), masks[0])
        return x + _keep(self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x)))), masks[1])


class CoordEmb(nn.Module):
    """Each ``win``-square window of the coordinate map -> one token: a
    linear lift of each point, the learnt token on pixels off the mask, the
    window's fixed sin-cos grid and a cls token, one block (MLP ratio 2), the
    cls token out (seen_coord_enc.py:59-90)."""

    def __init__(self, dim, win, heads):
        super().__init__()
        self.win = win
        self.pos_embed = nn.Linear(3, dim)
        self.invalid_coord_token = nn.Parameter(torch.zeros(dim))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.register_buffer("grid_pe", sincos_pos_embed(dim, win), persistent=False)
        self.blocks = nn.ModuleList([ViTBlock(dim, heads, 2.0)])

    def forward(self, coord_map, mask):
        B, _, H, W = coord_map.shape
        ws, C = self.win, self.invalid_coord_token.shape[0]
        emb = self.pos_embed(coord_map.permute(0, 2, 3, 1))
        m = mask[..., None].float()
        emb = emb * m + self.invalid_coord_token * (1.0 - m)
        emb = emb.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)
        emb = emb + self.grid_pe[:, 1:]
        cls = (self.cls_token + self.grid_pe[:, :1]).expand(emb.shape[0], -1, -1)
        emb = self.blocks[0](torch.cat([cls, emb], dim=1))
        return emb[:, 0].reshape(B, (H // ws) * (W // ws), C)


class CoordEncAtt(nn.Module):
    """Transformer coordinate encoder (seen_coord_enc.py:93-121)."""

    def __init__(self, dim, n_blocks, heads, win):
        super().__init__()
        self.coord_embed = CoordEmb(dim, win, heads)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.blocks = nn.ModuleList(ViTBlock(dim, heads, 4.0) for _ in range(n_blocks))
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, coord_map, mask, dp_masks=None):
        emb = self.coord_embed(coord_map, mask[:, 0] > 0.5)
        emb = torch.cat([self.cls_token.expand(emb.shape[0], -1, -1), emb], dim=1)
        for i, blk in enumerate(self.blocks):
            emb = blk(emb, dp_masks[i] if dp_masks is not None else (None, None))
        return self.norm(emb)


class RGBEncAtt(nn.Module):
    """Transformer RGB encoder over ``win``-square patches (rgb_enc.py:46-84)."""

    def __init__(self, img_size, dim, n_blocks, heads, win):
        super().__init__()
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, dim, win, stride=win)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.register_buffer("grid_pe", sincos_pos_embed(dim, img_size // win), persistent=False)
        self.blocks = nn.ModuleList(ViTBlock(dim, heads, 4.0) for _ in range(n_blocks))
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, rgb, dp_masks=None):
        emb = self.patch_embed.proj(rgb).flatten(2).transpose(1, 2) + self.grid_pe[:, 1:]
        cls = (self.cls_token + self.grid_pe[:, :1]).expand(rgb.shape[0], -1, -1)
        emb = torch.cat([cls, emb], dim=1)
        for i, blk in enumerate(self.blocks):
            emb = blk(emb, dp_masks[i] if dp_masks is not None else (None, None))
        return self.norm(emb)


# ---------------------------------------------------------------------------
# Implicit decoder (reference model/shape/implicit.py)
# ---------------------------------------------------------------------------

class ImplBlock(nn.Module):
    def __init__(self, dim=256, heads=8, mlp_ratio=4.0, last_layer=False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = nn.Module()
        self.attn.qkv = nn.Linear(dim, dim * 3, bias=True)
        self.attn.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp.fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        self.heads = heads
        self.last_layer = last_layer

    def _heads(self, x):
        B, N, C = x.shape
        t = self.attn.qkv(self.norm1(x)).reshape(B, N, 3, self.heads, C // self.heads).permute(2, 0, 3, 1, 4)
        return t[0], t[1], t[2]

    def _mlp(self, x):
        return self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))

    def latent(self, lat, mask=None):
        """The latent stream's update (latents attend to latents only) and its
        keys and values for the points."""
        ql, kl, vl = self._heads(lat)
        if self.last_layer:
            return lat, (kl, vl)
        B, L, C = lat.shape
        w = ((ql @ kl.transpose(-2, -1)) * (C // self.heads) ** -0.5).softmax(dim=-1)
        lat = lat + _keep(self.attn.proj((w @ vl).transpose(1, 2).reshape(B, L, C)), mask)
        return lat + _keep(self._mlp(lat), mask), (kl, vl)

    def points(self, pts, kv, mask=None):
        """The point stream: one joint softmax over the latents' keys and the point's own key."""
        kl, vl = kv
        qp, kp, vp = self._heads(pts)
        B, P, C = pts.shape
        scale = (C // self.heads) ** -0.5
        cross = (qp @ kl.transpose(-2, -1)) * scale
        self_w = (qp * kp).sum(-1, keepdim=True) * scale
        joint = torch.cat([cross, self_w], dim=-1).softmax(dim=-1)
        out = (joint[..., :-1] @ vl + joint[..., -1:] * vp).transpose(1, 2).reshape(B, P, C)
        pts = pts + _keep(self.attn.proj(out), mask)
        return pts + _keep(self._mlp(pts), mask)


class Implicit(nn.Module):
    """Reference Implicit (implicit.py:186-288): ``n_blocks`` blocks, C
    channels, a skip MLP of ``n_hidden`` hidden linears with skips at
    ``skip_in``, posenc off, the pos-embed before the first block only. A
    semantic decoder takes ``[latent_depth | latent_semantic]``
    (``latent_dim`` is their joint width)."""

    def __init__(self, num_patches=196, latent_dim=256, n_channels=256, n_blocks=2, heads=8, n_hidden=8,
                 skip_in=(2, 4, 6), mlp_ratio=4.0):
        super().__init__()
        self.point_proj = nn.Module()
        self.point_proj.proj = nn.Linear(3, n_channels)
        self.latent_proj = nn.Linear(latent_dim, n_channels)
        self.register_buffer("pos_embed", sincos_pos_embed(n_channels, int(num_patches**0.5)))
        self.blocks_attn = nn.ModuleList(
            [ImplBlock(n_channels, heads, mlp_ratio, last_layer=(i == n_blocks - 1)) for i in range(n_blocks)]
        )
        self.norm = nn.LayerNorm(n_channels, eps=1e-6)
        self.impl_mlp = nn.Module()
        dims = [3 + n_channels] + [n_channels] * n_hidden + [1]
        self.skip_in = tuple(skip_in)
        self.impl_mlp.layers = nn.ModuleList(
            nn.Linear(dims[l] + (dims[0] if l in self.skip_in else 0), dims[l + 1]) for l in range(len(dims) - 1)
        )

    def encode(self, latent, dp_masks=None):
        """``[B, L, latent_dim]`` -> each block's latent keys and values."""
        masks = dp_masks or [None] * len(self.blocks_attn)
        h = self.latent_proj(latent)
        h = h + self.pos_embed
        kvs = []
        for blk, m in zip(self.blocks_attn, masks):
            h, kv = blk.latent(h, m)
            kvs.append(kv)
        return kvs

    def decode(self, kvs, points, dp_masks=None):
        """Logits ``[B, P]`` of ``points [B, P, 3]``."""
        masks = dp_masks or [None] * len(self.blocks_attn)
        x = self.point_proj.proj(points)
        for blk, kv, m in zip(self.blocks_attn, kvs, masks):
            x = blk.points(x, kv, m)
        x = self.norm(x)
        inputs = torch.cat([points, x], dim=-1)
        h = inputs
        n = len(self.impl_mlp.layers)
        for l, layer in enumerate(self.impl_mlp.layers):
            if l in self.skip_in:
                h = torch.cat([h, inputs], dim=-1) / math.sqrt(2.0)
            h = layer(h)
            if l < n - 1:
                h = F.softplus(h, beta=100)
        return h[..., 0]
