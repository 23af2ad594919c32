"""Shape reconstruction graph, encoder half (counterpart of ``models/graph_shape.py``).

DPT depth + intrinsics head -> unproject and unit-sphere normalise -> coordinate
encoder -> latent tokens; the implicit decoder is held alongside
(``impl_network``). Ported for the shipped configuration: the ResNet
coordinate encoder and no RGB encoder. Submodules carry the reference names
(``dpt_depth``, ``intr_head``, ``intr_proj``, ``coord_encoder``,
``impl_network``), so a reference ``.ckpt`` state dict loads as is.

Batch layout at the boundary (NHWC, as the JAX package):
  rgb_input_map [B, H, W, 3] in [0, 1], mask_input_map [B, H, W, 1].
"""

from __future__ import annotations

import torch
import torch.nn as nn

from zeroshape_tpu_torch import camera
from zeroshape_tpu_torch.models import compute_autocast, fp32_region
from zeroshape_tpu_torch.models.coord_enc import CoordEncRes
from zeroshape_tpu_torch.models.dpt import DPTDepthModel
from zeroshape_tpu_torch.models.implicit import Implicit
from zeroshape_tpu_torch.models.layers import BottleneckConv
from zeroshape_tpu_torch.ops.image import adaptive_avg_pool_11, interpolate_coordmap

FOCAL_BASE = 1.3875  # reference graph_shape.py:98


def intr_param2mtx(intr_params, H, W):
    """``[B, 3]`` (scale_f, dcx, dcy) -> ``[B, 3, 3]`` intrinsics (graph_shape.py:35-52).

    Focal = 1.3875 * W * 4^tanh(p0); principal point shifted by tanh * half-extent.
    """
    p = intr_params.float()
    scale_f = torch.pow(4.0, torch.tanh(p[:, 0]))
    fx = FOCAL_BASE * W * scale_f
    fy = FOCAL_BASE * H * scale_f
    cx = W / 2.0 + torch.tanh(p[:, 1]) * W / 2.0
    cy = H / 2.0 + torch.tanh(p[:, 2]) * H / 2.0
    zeros, ones = torch.zeros_like(fx), torch.ones_like(fx)
    return torch.stack(
        [
            torch.stack([fx, zeros, cx], dim=-1),
            torch.stack([zeros, fy, cy], dim=-1),
            torch.stack([zeros, zeros, ones], dim=-1),
        ],
        dim=-2,
    )


class IntrHead(nn.Sequential):
    """Two 3x3 conv bottlenecks + global pool (graph_shape.py:55-71).

    The zero-init linear to the 3 intrinsics parameters sits beside it as
    ``ShapeGraph.intr_proj``, where the reference keeps it.
    """

    def __init__(self, channels: int = 768):
        super().__init__(BottleneckConv(channels, 3), BottleneckConv(channels, 3))

    def forward(self, feat):
        return adaptive_avg_pool_11(super().forward(feat))


class ShapeGraph(nn.Module):
    """Single-image shape reconstruction model (inference)."""

    def __init__(
        self,
        H=224,
        W=224,
        latent_dim=256,
        win_size=16,
        num_heads=8,
        impl_n_channels=256,
        impl_att_blocks=2,
        impl_mlp_layers=8,
        impl_mlp_ratio=4.0,
        impl_skip_in=(2, 4, 6),
        depth_head_init_scale=1.0,
        dtype=torch.float32,
    ):
        super().__init__()
        self.H, self.W = H, W
        self.dtype = dtype
        self.dpt_depth = DPTDepthModel(head_init_scale=depth_head_init_scale)
        self.intr_head = IntrHead(768)
        self.intr_proj = nn.Linear(768, 3)
        self.coord_encoder = CoordEncRes(latent_dim, win_size)
        self.impl_network = Implicit(
            num_patches=(H // win_size) ** 2,
            latent_dim=latent_dim,
            n_channels=impl_n_channels,
            n_blocks_attn=impl_att_blocks,
            n_layers_mlp=impl_mlp_layers,
            num_heads=num_heads,
            mlp_ratio=impl_mlp_ratio,
            skip_in=impl_skip_in,
            dtype=dtype,
        )

    @classmethod
    def from_opt(cls, opt, dtype=torch.float32):
        arch = opt.arch
        impl = arch.impl
        if arch.depth.encoder != "resnet" or arch.rgb.encoder is not None:
            raise NotImplementedError("only the resnet coordinate encoder without an RGB encoder is ported")
        if int(impl.get("posenc_3D") or 0) != 0 or impl.get("posenc_perlayer"):
            raise NotImplementedError("3D positional encoding options are not ported")
        return cls(
            H=opt.H,
            W=opt.W,
            latent_dim=arch.latent_dim,
            win_size=arch.win_size,
            num_heads=arch.num_heads,
            impl_n_channels=impl.n_channels,
            impl_att_blocks=impl.att_blocks,
            impl_mlp_layers=impl.mlp_layers,
            impl_mlp_ratio=impl.mlp_ratio,
            impl_skip_in=tuple(impl.skip_in),
            depth_head_init_scale=arch.depth.get("head_init_scale", 1.0) or 1.0,
            dtype=dtype,
        )

    def encode_image(self, batch):
        """Image -> predictions dict (graph_shape.py:172-214).

        Returns NHWC ``depth_pred [B, H, W, 1]``, ``intr_pred [B, 3, 3]``,
        ``validity_mask [B, HW]``, ``seen_points [B, HW, 3]`` and
        ``latent_depth [B, N, C]``.
        """
        rgb = batch["rgb_input_map"].permute(0, 3, 1, 2)
        mask = batch["mask_input_map"].permute(0, 3, 1, 2)
        B = rgb.shape[0]
        dev = rgb.device
        out = {}
        with compute_autocast(dev, self.dtype):
            depth_pred, intr_feat = self.dpt_depth(rgb)
            intr_params = self.intr_proj(self.intr_head(intr_feat))
        out["depth_pred"] = depth_pred.float().permute(0, 2, 3, 1)
        with fp32_region(dev):
            out["intr_pred"] = intr_param2mtx(intr_params, self.H, self.W)
            validity_mask = (mask > 0.5).reshape(B, -1).float()
            out["validity_mask"] = validity_mask
            seen = camera.unproj_depth(depth_pred[:, 0].float(), out["intr_pred"])
            seen_norm, _, _ = camera.normalize_seen_points(seen, validity_mask)
            out["seen_points"] = seen_norm
            seen_map = seen_norm.reshape(B, self.H, self.W, 3).permute(0, 3, 1, 2)
            seen_dsp, mask_dsp = interpolate_coordmap(seen_map, (mask > 0.5).float(), (self.H, self.W))
        with compute_autocast(dev, self.dtype):
            out["latent_depth"] = self.coord_encoder(seen_dsp, mask_dsp)
        return out
