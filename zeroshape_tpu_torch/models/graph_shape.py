"""Shape reconstruction graph (counterpart of ``models/graph_shape.py``).

DPT depth + intrinsics head -> unproject and unit-sphere normalise -> coordinate
encoder -> latent tokens -> implicit decoder on the GT-normalised SDF samples
(the training forward), with the loss terms (:func:`compute_loss`) and the
attention statistics (:func:`attn_geo_stats`). Inference decodes through
``recon``. Every architecture of the JAX ``ShapeGraph.from_opt`` builds:
the coordinate encoder ``arch.depth.encoder`` (``resnet``, or
``transformer`` over the map downsampled by ``dsp``; None means
``transformer``), the optional RGB encoder ``arch.rgb.encoder`` (``resnet``
or ``transformer``, whose tokens the decoder takes beside the coordinate
tokens) and the decoder options ``arch.impl.posenc_3D``,
``posenc_perlayer`` and ``mlp_layers`` (0: a linear head). Submodules carry
the reference names (``dpt_depth``, ``intr_head``, ``intr_proj``,
``coord_encoder``, ``rgb_encoder``, ``impl_network``), so a reference
``.ckpt`` state dict of the shipped configuration loads as is.

Batch layout at the boundary (NHWC, as the JAX package):
  rgb_input_map [B, H, W, 3] in [0, 1], mask_input_map [B, H, W, 1]; for
  supervision also depth_input_map [B, H, W, 1], intr [B, 3, 3],
  pose_gt [B, 3, 4], gt_sample_points [B, N, 3], gt_sample_sdf [B, N].

BatchNorm and stochastic depth follow the module's mode, as the JAX modules
follow ``train``: batch statistics after ``.train()``, running statistics
after ``.eval()``. The stochastic-depth masks of a training forward come
from one ``generator``, drawn in the order the modules run (RGB encoder,
coordinate encoder, decoder), or are given as ``dp_masks``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from zeroshape_tpu_torch import camera, losses
from zeroshape_tpu_torch.models import compute_autocast, fp32_region
from zeroshape_tpu_torch.models.coord_enc import CoordEncAtt, CoordEncRes
from zeroshape_tpu_torch.models.dpt import DPTDepthModel
from zeroshape_tpu_torch.models.implicit import Implicit
from zeroshape_tpu_torch.models.layers import BottleneckConv
from zeroshape_tpu_torch.models.rgb_enc import RGBEncAtt, RGBEncRes
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


def architecture(opt):
    """The :class:`ShapeGraph` keywords of ``opt``'s architecture, with the
    JAX ``ShapeGraph.from_opt``'s defaults (graph_shape.py:98-124): the
    coordinate encoder ``depth.encoder`` or ``transformer``, its
    downsampling ``dsp`` 1 for ``resnet``, block counts 12 where unset."""
    arch, impl = opt.arch, opt.arch.impl
    return dict(
        H=opt.H,
        W=opt.W,
        latent_dim=arch.latent_dim,
        win_size=arch.win_size,
        num_heads=arch.num_heads,
        depth_encoder=arch.depth.encoder or "transformer",
        depth_enc_blocks=arch.depth.get("n_blocks", 12),
        depth_dsp=1 if arch.depth.encoder == "resnet" else arch.depth.get("dsp", 1),
        rgb_encoder=arch.rgb.encoder,
        rgb_enc_blocks=arch.rgb.get("n_blocks", 12),
        impl_n_channels=impl.n_channels,
        impl_att_blocks=impl.att_blocks,
        impl_mlp_layers=impl.mlp_layers,
        impl_mlp_ratio=impl.mlp_ratio,
        impl_posenc_3D=int(impl.get("posenc_3D") or 0),
        impl_posenc_perlayer=bool(impl.get("posenc_perlayer")),
        impl_skip_in=tuple(impl.skip_in),
        depth_head_init_scale=arch.depth.get("head_init_scale", 1.0) or 1.0,
    )


def stochastic_depth_masks(dp_masks):
    """``dp_masks`` of a training forward by module: a dict with any of
    ``rgb_encoder``, ``coord_encoder`` (each a list of a block's two masks)
    and ``impl_network`` (a list of a block's mask); a list alone is the
    decoder's. What is missing is drawn."""
    if dp_masks is None:
        return {}
    return dict(dp_masks) if isinstance(dp_masks, dict) else {"impl_network": dp_masks}


class ShapeGraph(nn.Module):
    """Single-image shape reconstruction model."""

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
        depth_encoder="resnet",
        depth_enc_blocks=12,
        depth_dsp=1,
        rgb_encoder=None,
        rgb_enc_blocks=12,
        impl_posenc_3D=0,
        impl_posenc_perlayer=False,
    ):
        super().__init__()
        if depth_encoder not in ("resnet", "transformer") or rgb_encoder not in (None, "resnet", "transformer"):
            raise ValueError(f"unknown encoder: depth {depth_encoder!r}, rgb {rgb_encoder!r}")
        self.H, self.W = H, W
        self.dtype = dtype
        self.depth_encoder, self.depth_dsp, self.rgb_encoder_kind = depth_encoder, depth_dsp, rgb_encoder
        self.dpt_depth = DPTDepthModel(head_init_scale=depth_head_init_scale)
        self.intr_head = IntrHead(768)
        self.intr_proj = nn.Linear(768, 3)
        if depth_encoder == "resnet":
            self.coord_encoder = CoordEncRes(latent_dim, win_size)
        else:
            self.coord_encoder = CoordEncAtt(latent_dim, depth_enc_blocks, num_heads, win_size // depth_dsp)
        if rgb_encoder == "resnet":
            self.rgb_encoder = RGBEncRes(latent_dim, win_size)
        elif rgb_encoder == "transformer":
            self.rgb_encoder = RGBEncAtt(H, latent_dim, rgb_enc_blocks, num_heads, win_size)
        else:
            self.rgb_encoder = None
        self.impl_network = Implicit(
            num_patches=(H // win_size) ** 2,
            latent_dim=latent_dim * (2 if rgb_encoder else 1),
            n_channels=impl_n_channels,
            n_blocks_attn=impl_att_blocks,
            n_layers_mlp=impl_mlp_layers,
            num_heads=num_heads,
            mlp_ratio=impl_mlp_ratio,
            skip_in=impl_skip_in,
            dtype=dtype,
            semantic=rgb_encoder is not None,
            posenc_3D=impl_posenc_3D,
            pos_perlayer=impl_posenc_perlayer,
        )

    @classmethod
    def from_opt(cls, opt, dtype=torch.float32):
        return cls(**architecture(opt), dtype=dtype)

    def encode_image(self, batch, generator=None, dp_masks=None):
        """Image -> predictions dict (graph_shape.py:172-214).

        Returns NHWC ``depth_pred [B, H, W, 1]``, ``intr_pred [B, 3, 3]``,
        ``validity_mask [B, HW]``, ``seen_points [B, HW, 3]``,
        ``latent_depth [B, N, C]`` and ``latent_semantic`` (``[B, N, C]``,
        None without an RGB encoder). In training the transformer encoders'
        stochastic depth comes from ``dp_masks`` (by module, as in
        :func:`stochastic_depth_masks`) or ``generator``.
        """
        rgb = batch["rgb_input_map"].permute(0, 3, 1, 2)
        mask = batch["mask_input_map"].permute(0, 3, 1, 2)
        B = rgb.shape[0]
        dev = rgb.device
        masks = stochastic_depth_masks(dp_masks)
        out = {"latent_semantic": None}
        with compute_autocast(dev, self.dtype):
            if self.rgb_encoder_kind == "transformer":
                out["latent_semantic"] = self.rgb_encoder(rgb, generator, masks.get("rgb_encoder"))
            elif self.rgb_encoder_kind == "resnet":
                out["latent_semantic"] = self.rgb_encoder(rgb)
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
            dsp_hw = (self.H // self.depth_dsp, self.W // self.depth_dsp)
            seen_dsp, mask_dsp = interpolate_coordmap(seen_map, (mask > 0.5).float(), dsp_hw)
        with compute_autocast(dev, self.dtype):
            if self.depth_encoder == "resnet":
                out["latent_depth"] = self.coord_encoder(seen_dsp, mask_dsp)
            else:
                out["latent_depth"] = self.coord_encoder(seen_dsp, mask_dsp[:, 0] > 0.5, generator,
                                                         masks.get("coord_encoder"))
        return out

    def encode_latents(self, out, dp_masks=None):
        """The decoder's per-block K/V caches of ``encode_image``'s ``out``
        (its latent trunk, with the semantic tokens where it takes them)."""
        return self.impl_network.encode(out["latent_depth"], out["latent_semantic"], dp_masks)

    def gt_supervision(self, batch):
        """GT-normalised camera-frame SDF sample points, without gradient
        (graph_shape.py:216-246). The 100 samples nearest the surface are the
        top 100 of ``-|sdf|``, ties to the lower index as in ``lax.top_k``."""
        mask = batch["mask_input_map"]
        B = mask.shape[0]
        with torch.no_grad(), fp32_region(mask.device):
            validity = (mask > 0.5).reshape(B, -1).float()
            seen_gt = camera.unproj_depth(batch["depth_input_map"][..., 0], batch["intr"])
            seen_gt_norm, mean_gt, scale_gt = camera.normalize_seen_points(seen_gt, validity)
            pose = batch["pose_gt"]
            pts_cam = torch.einsum("bij,bnj->bni", pose[..., :3], batch["gt_sample_points"]) + pose[:, None, :, 3]
            gt_points_cam = (pts_cam - mean_gt[:, None, :]) / scale_gt[:, None, None]
            sdf = batch["gt_sample_sdf"]
            order = torch.sort(-sdf.abs(), dim=1, descending=True, stable=True).indices[:, : min(100, sdf.shape[1])]
            gt_surf_points = torch.gather(gt_points_cam, 1, order[..., None].expand(-1, -1, 3))
        return {
            "seen_points_gt": seen_gt_norm,
            "gt_points_cam": gt_points_cam,
            "gt_surf_points": gt_surf_points,
            "gt_norm_mean": mean_gt,
            "gt_norm_scale": scale_gt,
        }

    def forward(self, batch, train=False, with_supervision=None, generator=None, dp_masks=None):
        """Full forward (graph_shape.py:248-263): ``encode_image``, then, with
        supervision (default: when the batch has SDF samples), the decoder's
        logits ``pred_sample_occ [B, N]`` and attention ``attn [B, N, L]``
        at the GT-normalised sample points. ``train`` must match the module's
        mode; it turns on the stochastic depth of the decoder and the
        transformer encoders, from ``dp_masks`` (a list: the decoder's; a
        dict: by module, :func:`stochastic_depth_masks`) or drawn from
        ``generator``."""
        if train != self.training:
            raise ValueError(f"forward(train={train}) on a module in {'train' if self.training else 'eval'} mode")
        masks = stochastic_depth_masks(dp_masks)
        out = self.encode_image(batch, generator, masks)
        if with_supervision is None:
            with_supervision = "gt_sample_points" in batch and "gt_sample_sdf" in batch
        if with_supervision:
            out.update(self.gt_supervision(batch))
            out["pred_sample_occ"], out["attn"] = self.impl_network(
                out["latent_depth"], out["latent_semantic"], out["gt_points_cam"], train, generator,
                masks.get("impl_network"),
            )
        return out


def compute_loss(opt, batch, out, training=False):
    """Unweighted loss terms (graph_shape.py:266-293): depth whenever it has
    a weight, intrinsics and shape in training."""
    loss = {}
    lw, tr = opt.loss_weight, opt.training
    with fp32_region(out["depth_pred"].device):
        if lw.get("depth") is not None:
            dl = tr.depth_loss
            loss["depth"] = losses.depth_loss(
                out["depth_pred"].permute(0, 3, 1, 2),
                batch["depth_input_map"].permute(0, 3, 1, 2),
                batch["mask_input_map"].permute(0, 3, 1, 2),
                grad_reg=dl.grad_reg, depth_inv=dl.depth_inv, mask_shrink=dl.mask_shrink,
            )
        if lw.get("intr") is not None and training:
            loss["intr"] = losses.intr_loss(out["seen_points"], out["seen_points_gt"], out["validity_mask"])
        if lw.get("shape") is not None and training:
            sl = tr.shape_loss
            loss["shape"] = losses.shape_loss(
                out["pred_sample_occ"], batch["gt_sample_sdf"], impt_thres=sl.impt_thres, impt_weight=sl.impt_weight
            )
    return loss


@torch.no_grad()
def attn_geo_stats(opt, batch, out, depth_eps=0.05):
    """The mean attention mass that query points place on the geometry
    tokens, over all SDF queries (``attn_geo_avg``) and split into queries
    near the visible surface (``seen``), occupied and unseen (``occl``) and
    unoccupied (``bg``) (graph_shape.py:296-353). ``{}`` without an
    attention map."""
    if "attn" not in out:
        return {}
    geo_mass = out["attn"].float().sum(dim=-1)  # [B, N]
    occupied = batch["gt_sample_sdf"] < 0
    pts = out["gt_points_cam"] * out["gt_norm_scale"][:, None, None] + out["gt_norm_mean"][:, None, :]
    uv = camera.cam2img(pts, batch["intr"].float())
    z = pts[..., 2]
    u = uv[..., 0] / torch.clamp(uv[..., 2], min=1e-8)
    v = uv[..., 1] / torch.clamp(uv[..., 2], min=1e-8)
    H, W = batch["depth_input_map"].shape[1:3]
    ui = torch.clamp(torch.round(u).to(torch.int64), 0, W - 1)
    vi = torch.clamp(torch.round(v).to(torch.int64), 0, H - 1)
    in_bounds = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1) & (z > 0)

    def gather_map(m):  # [B, H, W, 1] -> [B, N]
        return torch.gather(m[..., 0].float().reshape(m.shape[0], -1), 1, vi * W + ui)

    seen = in_bounds & (gather_map(batch["mask_input_map"]) > 0.5)
    seen &= (z - gather_map(batch["depth_input_map"])).abs() < depth_eps

    def masked_mean(m):
        cnt = m.sum()
        return torch.where(cnt > 0, (geo_mass * m).sum() / torch.clamp(cnt, min=1), 0.0)

    return {
        "attn_geo_avg": geo_mass.mean(),
        "attn_geo_seen": masked_mean(seen.float()),
        "attn_geo_occl": masked_mean((occupied & ~seen).float()),
        "attn_geo_bg": masked_mean((~occupied).float()),
    }
