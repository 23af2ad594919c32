"""Loss functions (counterpart of ``zeroshape_tpu/losses.py``).

Occupancy BCE with the near-surface weight, the intrinsics loss, and the
MiDaS scale-and-shift-invariant depth loss with multi-scale gradient
matching (reference ``utils/loss.py`` and ``model/depth/midas_loss.py``).
Masked arithmetic on fixed shapes, as in the JAX package, so every term has
the same value and gradient there and here. Depth maps are ``[B, 1, H, W]``.

A term that divides a sum over the batch by another (the masked means) is
the global batch's ratio under several ranks (:func:`batch_ratio`), as in
the JAX package's single program over the sharded batch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from zeroshape_tpu_torch.parallel import dist


def batch_ratio(num, den, eps=0.0):
    """``num / (den + eps)`` of two sums over the batch's rows, for the global
    batch: under ``W`` ranks each rank returns ``W * num / (sum of den over
    the ranks + eps)``, so the mean over the ranks is the global ratio and the
    averaged gradients are its gradients (``den`` holds no gradient)."""
    if dist.world() == 1:
        return num / (den + eps)
    return num * dist.world() / (dist.all_reduce_(den.detach().clone()) + eps)


def shape_loss(pred_occ_logits, gt_sdf, impt_thres=0.01, impt_weight=1.0):
    """BCE with logits on ``occ = (sdf < 0)``, near-surface samples weighted
    by ``impt_weight`` (losses.py:21-34). ``[B, N]`` logits and SDF values."""
    if pred_occ_logits.dim() != 2 or gt_sdf.dim() != 2:
        raise ValueError("shape_loss takes [B, N] logits and SDF values")
    x = pred_occ_logits
    gt_occ = (gt_sdf < 0).to(x.dtype)
    loss = torch.clamp(x, min=0) - x * gt_occ + torch.log1p(torch.exp(-x.abs()))
    weight = torch.where(gt_sdf.abs() < impt_thres, float(impt_weight), 1.0)
    return (loss * weight).mean()


def intr_loss(seen_pred, seen_gt, mask):
    """Masked MSE of the normalised visible surfaces ``[B, HW, 3]`` (losses.py:41-47)."""
    distance = ((seen_pred - seen_gt) ** 2).sum(dim=-1)
    return batch_ratio((distance * mask).sum(), mask.sum(), 1e-8)


def _order_keys(x):
    """fp32 -> int64 keys in [0, 2^32) that sort as the floats do (the
    sign-fold of losses.py:82-84: set the top bit of a non-negative, invert a
    negative), so -0.0 sorts below +0.0."""
    u = x.float().contiguous().view(torch.int32).long()  # sign-extended
    return torch.where(u < 0, ~u, u + 2**31) & 0xFFFFFFFF


def _from_keys(key):
    """Inverse of :func:`_order_keys`."""
    u = torch.where(key >= 2**31, key - 2**31, ~key & 0xFFFFFFFF)
    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32).view(torch.float32)


def _masked_median(x_flat, mask_flat):
    """Lower median of the masked elements of each row; 0 on an empty row.

    ``x_flat``, ``mask_flat``: ``[B, N]``. The value is the k-th smallest
    masked element, k = (count - 1) // 2, taken with ``torch.kthvalue`` on
    order-preserving integer keys; it equals the JAX bisection over the same
    keys (losses.py:65-110) bit for bit. The gradient goes as there: to the
    mean of the masked elements equal to the median.
    """
    x32 = x_flat.float()
    key = torch.where(mask_flat, _order_keys(x32.detach()), 0xFFFFFFFF)  # unmasked sort last
    count = mask_flat.sum(dim=-1)
    k = torch.clamp((count - 1) // 2, min=0)
    sorted_keys = torch.sort(key, dim=-1).values
    med = _from_keys(sorted_keys.gather(-1, k[:, None])[:, 0])
    is_med = mask_flat & (x32 == med[:, None])
    n_med = torch.clamp(is_med.sum(dim=-1), min=1)
    med_grad = torch.where(is_med, x32, 0.0).sum(dim=-1) / n_med
    med = med_grad + (med - med_grad).detach()
    return torch.where(count > 0, med, 0.0).to(x_flat.dtype)


def masked_shift_and_scale(depth_pred, depth_gt, mask_valid):
    """Median / mean-absolute-deviation alignment of both maps (losses.py:113-131).

    The divisor is the count of valid pixels plus one, as in the reference.
    """
    B = depth_pred.shape[0]
    m = mask_valid.reshape(B, -1)
    mask_diff = m.sum(dim=-1) + 1.0

    def align(d):
        d_f = d.reshape(B, -1)
        t = _masked_median(d_f, m > 0)
        s = ((d_f - t[:, None]).abs() * (m > 0)).sum(dim=-1) / mask_diff
        return (d - t[:, None, None, None]) / (s[:, None, None, None] + 1e-6)

    return align(depth_pred), align(depth_gt)


def masked_l1_loss(pred, target, mask_valid):
    return batch_ratio(((pred - target).abs() * mask_valid).sum(), mask_valid.sum(), 1e-6)


def compute_scale_and_shift(prediction, target, mask, det_eps=1e-6):
    """Per-image least-squares scale and shift of ``prediction`` onto
    ``target`` over ``mask`` (``[B, H, W]`` each; losses.py:139-153)."""
    dims = (1, 2)
    a_00 = (mask * prediction * prediction).sum(dim=dims)
    a_01 = (mask * prediction).sum(dim=dims)
    a_11 = mask.sum(dim=dims)
    b_0 = (mask * prediction * target).sum(dim=dims)
    b_1 = (mask * target).sum(dim=dims)
    det = a_00 * a_11 - a_01 * a_01
    valid = det != 0
    x_0 = torch.where(valid, (a_11 * b_0 - a_01 * b_1) / (det + det_eps), 0.0)
    x_1 = torch.where(valid, (-a_01 * b_0 + a_00 * b_1) / (det + det_eps), 0.0)
    return x_0, x_1


def _gradient_loss_single_scale(diff_masked, mask):
    grad_x = (diff_masked[:, :, 1:] - diff_masked[:, :, :-1]).abs()
    mask_x = mask[:, :, 1:] * mask[:, :, :-1]
    grad_y = (diff_masked[:, 1:, :] - diff_masked[:, :-1, :]).abs()
    mask_y = mask[:, 1:, :] * mask[:, :-1, :]
    image_loss = (mask_x * grad_x).sum(dim=(1, 2)) + (mask_y * grad_y).sum(dim=(1, 2))
    return image_loss, mask.sum(dim=(1, 2))


def gradient_matching_term(prediction, target, mask, scales=4, reduction="image-based"):
    """Multi-scale gradient matching (losses.py:171-187)."""
    total = 0.0
    for scale in range(scales):
        step = 2**scale
        p, t, m = (x[:, ::step, ::step] for x in (prediction, target, mask))
        image_loss, M = _gradient_loss_single_scale(m * (p - t), m)
        if reduction == "batch-based":
            divisor = dist.all_reduce_(M.sum().detach().clone())  # the global batch's
            total = total + torch.where(divisor == 0, 0.0, image_loss.sum() * dist.world() / torch.clamp(divisor, min=1.0))
        else:
            total = total + torch.where(M > 0, image_loss / torch.clamp(M, min=1.0), image_loss).mean()
    return total


def erode_mask(mask, max_pool_size=4):
    """A pixel stays valid only if its whole ``max_pool_size`` cell is valid
    (losses.py:190-201): max-pool of the invalid map, nearest resize back.
    ``[B, 1, H, W]`` -> boolean."""
    H, W = mask.shape[-2:]
    pooled = F.max_pool2d(1.0 - mask.float(), max_pool_size)
    idx_h = torch.as_tensor(np.floor(np.arange(H) * (pooled.shape[-2] / H)).astype(np.int64), device=mask.device)
    idx_w = torch.as_tensor(np.floor(np.arange(W) * (pooled.shape[-1] / W)).astype(np.int64), device=mask.device)
    return pooled[:, :, idx_h][:, :, :, idx_w] == 0


def midas_loss(pred_raw, target_raw, mask_raw, alpha=0.1, scales=4, reduction="image-based",
               inverse_depth=True, shrink_mask=False):
    """SSI mean absolute error + ``alpha`` x multi-scale gradient matching
    (losses.py:204-236). ``[B, 1, H, W]`` each."""
    mask = erode_mask(mask_raw).float() if shrink_mask else (mask_raw > 0.5).float()
    pred_aligned, gt_aligned = masked_shift_and_scale(pred_raw, target_raw, mask)
    ssi = masked_l1_loss(pred_aligned, gt_aligned, mask)
    if alpha <= 0:
        return ssi
    if inverse_depth:
        prediction, target = 1.0 / (pred_raw[:, 0] + 1e-6), 1.0 / (target_raw[:, 0] + 1e-6)
    else:
        prediction, target = pred_raw[:, 0], target_raw[:, 0]
    m2 = mask[:, 0]
    scale, shift = compute_scale_and_shift(prediction, target, m2)
    prediction_ssi = scale[:, None, None] * prediction + shift[:, None, None]
    return ssi + alpha * gradient_matching_term(prediction_ssi, target, m2, scales=scales, reduction=reduction)


def depth_loss(pred_depth, gt_depth, mask, grad_reg=0.1, depth_inv=True, mask_shrink=False):
    """Reference ``Loss.depth_loss`` (losses.py:239-249)."""
    if not pred_depth.dim() == gt_depth.dim() == mask.dim() == 4:
        raise ValueError("depth_loss takes [B, 1, H, W] maps")
    return midas_loss(pred_depth, gt_depth, mask, alpha=grad_reg, inverse_depth=depth_inv, shrink_mask=mask_shrink)


def summarize_loss(loss_dict, loss_weights):
    """Weighted sum of the loss terms that have a weight (losses.py:252-259)."""
    total = 0.0
    for key, value in loss_dict.items():
        w = loss_weights.get(key)
        if w is not None:
            total = total + float(w) * value.mean()
    return total
