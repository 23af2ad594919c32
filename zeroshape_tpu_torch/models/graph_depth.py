"""Depth + intrinsics pretraining graph (counterpart of ``models/graph_depth.py``).

DPT depth prediction with an optional intrinsics head; with intrinsics, the
predicted and (given depth) GT visible surfaces are unprojected and
unit-sphere normalised for the intrinsics loss. Submodules carry the
reference names (``dpt_depth``, ``intr_head``, ``intr_proj``), so its state
dict is the reference depth graph's and ``load_torch_checkpoint(path,
graph="depth")`` reads its checkpoints.

Batch layout at the boundary (NHWC, as the JAX package):
  rgb_input_map [B, H, W, 3] in [0, 1], mask_input_map [B, H, W, 1]; for
  supervision also depth_input_map [B, H, W, 1] and intr [B, 3, 3].
"""

from __future__ import annotations

import torch
import torch.nn as nn

from zeroshape_tpu_torch import camera, losses
from zeroshape_tpu_torch.models import compute_autocast, fp32_region
from zeroshape_tpu_torch.models.dpt import DPTDepthModel
from zeroshape_tpu_torch.models.graph_shape import IntrHead, intr_param2mtx


class DepthGraph(nn.Module):
    """DPT depth and, with ``predict_intr``, the intrinsics head."""

    def __init__(self, H=224, W=224, predict_intr=True, depth_head_init_scale=1.0, dtype=torch.float32):
        super().__init__()
        self.H, self.W = H, W
        self.predict_intr = predict_intr
        self.dtype = dtype
        self.dpt_depth = DPTDepthModel(head_init_scale=depth_head_init_scale)
        if predict_intr:
            self.intr_head = IntrHead(768)
            self.intr_proj = nn.Linear(768, 3)

    @classmethod
    def from_opt(cls, opt, dtype=torch.float32):
        return cls(
            H=opt.H,
            W=opt.W,
            predict_intr=opt.loss_weight.get("intr") is not None,
            depth_head_init_scale=opt.arch.depth.get("head_init_scale", 1.0) or 1.0,
            dtype=dtype,
        )

    def forward(self, batch, train=False):
        """``depth_pred [B, H, W, 1]``; with intrinsics also ``intr_pred [B, 3,
        3]``, ``validity_mask [B, HW]``, ``seen_points_pred [B, HW, 3]`` and,
        given ``depth_input_map``, ``seen_points_gt`` (graph_depth.py:44-70),
        the geometry in fp32. ``train`` must match the module's mode (it
        sets BatchNorm's)."""
        if train != self.training:
            raise ValueError(f"forward(train={train}) on a module in {'train' if self.training else 'eval'} mode")
        rgb = batch["rgb_input_map"].permute(0, 3, 1, 2)
        mask = batch["mask_input_map"]
        B = rgb.shape[0]
        dev = rgb.device
        with compute_autocast(dev, self.dtype):
            depth_pred, intr_feat = self.dpt_depth(rgb)
            intr_params = self.intr_proj(self.intr_head(intr_feat)) if self.predict_intr else None
        out = {"depth_pred": depth_pred.float().permute(0, 2, 3, 1)}
        if not self.predict_intr:
            return out
        with fp32_region(dev):
            out["intr_pred"] = intr_param2mtx(intr_params, self.H, self.W)
            validity = (mask > 0.5).reshape(B, -1).float()
            out["validity_mask"] = validity
            seen = camera.unproj_depth(depth_pred[:, 0].float(), out["intr_pred"])
            out["seen_points_pred"], _, _ = camera.normalize_seen_points(seen, validity)
            if "depth_input_map" in batch:
                seen_gt = camera.unproj_depth(batch["depth_input_map"][..., 0].float(), batch["intr"].float())
                out["seen_points_gt"], _, _ = camera.normalize_seen_points(seen_gt, validity)
        return out


def compute_loss(opt, batch, out, training=False):
    """Unweighted loss terms (graph_depth.py:73-91): the depth loss and the
    intrinsics loss wherever they have a weight, in evaluation too."""
    loss = {}
    lw = opt.loss_weight
    with fp32_region(out["depth_pred"].device):
        if lw.get("depth") is not None:
            dl = opt.training.depth_loss
            loss["depth"] = losses.depth_loss(
                out["depth_pred"].permute(0, 3, 1, 2),
                batch["depth_input_map"].permute(0, 3, 1, 2),
                batch["mask_input_map"].permute(0, 3, 1, 2),
                grad_reg=dl.grad_reg, depth_inv=dl.depth_inv, mask_shrink=dl.mask_shrink,
            )
        if lw.get("intr") is not None:
            loss["intr"] = losses.intr_loss(out["seen_points_pred"], out["seen_points_gt"], out["validity_mask"])
    return loss
