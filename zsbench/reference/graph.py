"""The plain shape graph: DPT depth and intrinsics, unprojection and unit-
sphere normalisation, the coordinate encoder (and the RGB encoder where the
configuration has one), the implicit decoder, the GT block and the shape
loss of a training step.

The camera arithmetic, the GT block and the loss are frozen copies of the
repository's torch oracle of the reference graph (``graph_shape.py:115-202``,
``utils/camera.py:52-108``, ``utils/loss.py:8-42``), including the per-sample
loop of ``valid_norm_fac``. Batches are NHWC at the boundary, as the program
takes them. Plain torch in float32; nothing of the program is imported.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from zsbench.reference.dpt import DPTDepth
from zsbench.reference.parts import CoordEncAtt, CoordEncRes, Implicit, IntrHead, RGBEncAtt

FOCAL_BASE = 1.3875  # reference graph_shape.py:98


def intr_param2mtx(intr_params, H, W):
    B = intr_params.shape[0]
    scale_f = torch.pow(4.0, torch.tanh(intr_params[:, 0]))
    fx = FOCAL_BASE * W * scale_f
    fy = FOCAL_BASE * H * scale_f
    cx = W / 2.0 + torch.tanh(intr_params[:, 1]) * W / 2.0
    cy = H / 2.0 + torch.tanh(intr_params[:, 2]) * H / 2.0
    K = torch.zeros(B, 3, 3, device=intr_params.device)
    K[:, 0, 0], K[:, 0, 2] = fx, cx
    K[:, 1, 1], K[:, 1, 2] = fy, cy
    K[:, 2, 2] = 1.0
    return K


def unproj_depth(depth, intr):
    """depth [B, H, W], intr [B, 3, 3] -> camera-frame points [B, HW, 3]."""
    B, H, W = depth.shape
    y, x = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=depth.device),
                          torch.arange(W, dtype=torch.float32, device=depth.device), indexing="ij")
    pix = torch.stack([x, y, torch.ones_like(x)], dim=-1).reshape(-1, 3)
    rays = torch.einsum("nk,bjk->bnj", pix, torch.linalg.inv(intr))
    return rays * depth.reshape(B, H * W, 1)


def valid_norm_fac(seen_points, mask):
    """Per-sample python loop, like the reference (camera.py:63-73). A depth
    map that is 0 over a whole mask puts every visible point on the camera
    and gives scale 0; the scale is clamped at 1e-8 there, as the JAX
    package and the port clamp it (the reference divides by 0)."""
    means, scales = [], []
    for b in range(seen_points.shape[0]):
        valid = seen_points[b][mask[b] > 0.5]
        mean = valid.mean(dim=0)
        means.append(mean)
        scales.append((valid - mean).norm(dim=-1).max().clamp(min=1e-8))
    return torch.stack(means), torch.stack(scales)


def normalize_seen(seen_points, mask):
    mean, scale = valid_norm_fac(seen_points, mask)
    out = (seen_points - mean[:, None, :]) / scale[:, None, None]
    return out * (mask > 0.5).float()[..., None], mean, scale


def interpolate_coordmap(coord_map, mask_map, out_hw):
    """Masked bilinear downsample of a coordinate map (reference utils/util.py:336-345)."""
    if tuple(coord_map.shape[-2:]) == tuple(out_hw):
        return coord_map, mask_map
    num = F.interpolate(coord_map * mask_map, size=out_hw, mode="bilinear", align_corners=False)
    den = F.interpolate(mask_map, size=out_hw, mode="bilinear", align_corners=False)
    mask_dsp = (den > 0.5).float()
    return num / torch.clamp(den, min=1e-6) * mask_dsp, mask_dsp


def shape_loss(logits, sdf, impt_thres=0.01, impt_weight=1.0):
    gt_occ = (sdf < 0).float()
    loss = F.binary_cross_entropy_with_logits(logits, gt_occ, reduction="none")
    weight = torch.where(sdf.abs() < impt_thres, torch.full_like(sdf, impt_weight), torch.ones_like(sdf))
    return (loss * weight).mean()


class ShapeGraph(nn.Module):
    """The reference ``graph_shape.Graph`` for a configuration's ``arch``
    section (``cfg``: the configuration file's ``options``)."""

    def __init__(self, cfg):
        super().__init__()
        arch = cfg["arch"]
        impl = arch["impl"]
        self.H, self.W = cfg["H"], cfg["W"]
        ws, dim, heads = arch["win_size"], arch["latent_dim"], arch["num_heads"]
        self.depth_kind, self.rgb_kind = arch["depth"]["encoder"], arch["rgb"]["encoder"]
        self.dsp = 1 if self.depth_kind == "resnet" else arch["depth"]["dsp"]
        self.dpt_depth = DPTDepth(H=self.H, W=self.W)
        self.intr = IntrHead()
        if self.depth_kind == "resnet":
            self.coord_encoder = CoordEncRes(dim)
        else:
            self.coord_encoder = CoordEncAtt(dim, arch["depth"]["n_blocks"], heads, ws // self.dsp)
        if self.rgb_kind == "transformer":
            self.rgb_encoder = RGBEncAtt(self.H, dim, arch["rgb"]["n_blocks"], heads, ws)
        elif self.rgb_kind is not None:
            raise ValueError(f"no plain RGB encoder {self.rgb_kind!r}")
        self.impl_network = Implicit(
            num_patches=(self.H // ws) ** 2, latent_dim=dim * (2 if self.rgb_kind else 1),
            n_channels=impl["n_channels"], n_blocks=impl["att_blocks"], heads=heads,
            n_hidden=impl["mlp_layers"], skip_in=impl["skip_in"], mlp_ratio=impl["mlp_ratio"],
        )

    def reference_state(self):
        """``{name: tensor}`` in the released layout: every parameter and the
        BatchNorm statistics (the intrinsics head's keys unprefixed, as the
        reference graph holds them beside the DPT)."""
        out = {}
        for name, t in list(self.named_parameters()) + [
            (n, b) for n, b in self.named_buffers() if n.endswith(("running_mean", "running_var"))
        ]:
            out[name[len("intr."):] if name.startswith("intr.") else name] = t
        return out

    def reference_state_params(self):
        """``(name, parameter)`` pairs by the released names (as :meth:`reference_state`)."""
        return [(n[len("intr."):] if n.startswith("intr.") else n, p) for n, p in self.named_parameters()]

    def encode_image(self, rgb, mask, dp_masks=None):
        """NHWC ``rgb [B, H, W, 3]``, ``mask [B, H, W, 1]`` -> ``depth [B, H, W]``,
        ``intr [B, 3, 3]``, the decoder's latent ``[B, L, C]``."""
        depth, intr_feat = self.dpt_depth(rgb.permute(0, 3, 1, 2))
        intr = intr_param2mtx(self.intr(intr_feat), self.H, self.W)
        return depth[:, 0], intr, self.latent(depth[:, 0], intr, rgb, mask, dp_masks)

    def latent(self, depth, intr, rgb, mask, dp_masks=None):
        """The decoder's latent from a depth map ``[B, H, W]`` and intrinsics:
        unprojection, normalisation, the coordinate (and RGB) encoder."""
        dp = dp_masks or {}
        rgb = rgb.permute(0, 3, 1, 2)
        mask = mask.permute(0, 3, 1, 2)
        B = rgb.shape[0]
        validity = (mask > 0.5).reshape(B, -1).float()
        seen, _, _ = normalize_seen(unproj_depth(depth, intr), validity)
        seen_map = seen.reshape(B, self.H, self.W, 3).permute(0, 3, 1, 2)
        seen_map, mask_map = interpolate_coordmap(seen_map, (mask > 0.5).float(),
                                                  (self.H // self.dsp, self.W // self.dsp))
        latent = self.coord_encoder(seen_map, mask_map, dp.get("coord_encoder"))
        if self.rgb_kind:
            latent = torch.cat([latent, self.rgb_encoder(rgb, dp.get("rgb_encoder"))], dim=-1)
        return latent

    def train_loss(self, batch, dp_masks=None, impt_thres=0.01, impt_weight=1.0):
        """The shape loss of a training batch (graph_shape.py:115-202)."""
        dp = dp_masks or {}
        _, _, latent = self.encode_image(batch["rgb_input_map"], batch["mask_input_map"], dp)
        mask = batch["mask_input_map"]
        B = mask.shape[0]
        with torch.no_grad():
            validity = (mask > 0.5).reshape(B, -1).float()
            seen_gt = unproj_depth(batch["depth_input_map"][..., 0], batch["intr"])
            _, mean_gt, scale_gt = normalize_seen(seen_gt, validity)
            pose = batch["pose_gt"]
            pts_cam = torch.einsum("bij,bnj->bni", pose[..., :3], batch["gt_sample_points"]) + pose[:, None, :, 3]
            gt_points_cam = (pts_cam - mean_gt[:, None, :]) / scale_gt[:, None, None]
        masks = dp.get("impl_network")
        logits = self.impl_network.decode(self.impl_network.encode(latent, masks), gt_points_cam, masks)
        return shape_loss(logits, batch["gt_sample_sdf"], impt_thres, impt_weight)
