"""Depth metrics after disparity-space least-squares alignment (counterpart of
``metrics/depth_metrics.py``, the reference's ``utils/eval_depth.py``).

The prediction becomes disparity, is aligned to the GT disparity by a
per-image scale and shift fitted by least squares over the valid pixels,
goes back to depth, and is scored with masked delta-threshold, rmse, l1 and
abs_rel metrics, each a per-sample mean over the valid pixels.
"""

from __future__ import annotations

import torch

DEFAULT_THRESHOLDS = (1.02, 1.05, 1.1, 1.2)


def _scale_and_shift(prediction, target, mask):
    """Per-image least-squares ``(scale, shift)`` of ``prediction`` onto
    ``target`` over ``mask`` (eval_depth.py:12-33): a row is solved only where
    ``det > 0``, with no eps on ``det``; other rows get (0, 0)."""
    a_00 = torch.sum(mask * prediction * prediction, dim=(1, 2))
    a_01 = torch.sum(mask * prediction, dim=(1, 2))
    a_11 = torch.sum(mask, dim=(1, 2))
    b_0 = torch.sum(mask * prediction * target, dim=(1, 2))
    b_1 = torch.sum(mask * target, dim=(1, 2))
    det = a_00 * a_11 - a_01 * a_01
    valid = det > 0
    safe_det = torch.where(valid, det, 1.0)
    x_0 = torch.where(valid, (a_11 * b_0 - a_01 * b_1) / safe_det, 0.0)
    x_1 = torch.where(valid, (-a_01 * b_0 + a_00 * b_1) / safe_det, 0.0)
    return x_0, x_1


def metric_keys(thresholds=DEFAULT_THRESHOLDS):
    return [f"d>{t}" for t in thresholds] + ["rmse", "l1_err", "abs_rel"]


def compute_depth_metrics(prediction, target, mask, thresholds=DEFAULT_THRESHOLDS, depth_cap=None,
                          prediction_type="depth"):
    """Per-sample depth metrics of ``prediction``, ``target`` and ``mask``
    (each ``[B, 1, H, W]``). Returns ``(metrics {key: [B]}, aligned
    prediction depth [B, 1, H, W], zero off the mask)``."""
    if not (prediction.shape == target.shape == mask.shape and prediction.dim() == 4):
        raise ValueError(f"shapes {prediction.shape}, {target.shape}, {mask.shape}: want three equal [B, 1, H, W]")
    prediction = prediction[:, 0].float()
    target = target[:, 0].float()
    m = (mask[:, 0] > 0.5).float()

    if prediction_type == "depth":
        pred_disp = m * (1.0 / (prediction + 1e-6))
    elif prediction_type == "disparity":
        pred_disp = m * prediction
    else:
        raise ValueError(f"unknown prediction type {prediction_type}")
    # the GT disparity over valid pixels only (no 1/0 on the background)
    target_disp = m * (1.0 / torch.where(m > 0, target, 1.0))

    scale, shift = _scale_and_shift(pred_disp, target_disp, m)
    pred_aligned = scale[:, None, None] * pred_disp + shift[:, None, None]
    if depth_cap is not None:
        pred_aligned = torch.clamp(pred_aligned, min=1.0 / depth_cap)
    # the aligned disparity can be 0 off the mask, where it is masked out
    pred_depth = 1.0 / torch.where(pred_aligned != 0, pred_aligned, 1.0)

    n_valid = torch.sum(m, dim=(1, 2))
    safe_n = torch.clamp(n_valid, min=1.0)
    safe_target = torch.where(m > 0, target, 1.0)
    safe_pred = torch.where(m > 0, pred_depth, 1.0)

    metrics = {}
    ratio = torch.maximum(safe_pred / safe_target, safe_target / safe_pred)
    for t in thresholds:
        metrics[f"d>{t}"] = torch.sum((ratio > t).float() * m, dim=(1, 2)) / safe_n
    metrics["rmse"] = torch.sqrt(torch.sum((pred_depth - target) ** 2 * m, dim=(1, 2)) / safe_n)
    metrics["l1_err"] = torch.sum(torch.abs(pred_depth - target) * m, dim=(1, 2)) / safe_n
    metrics["abs_rel"] = torch.sum(torch.abs(pred_depth - target) / safe_target * m, dim=(1, 2)) / safe_n
    return metrics, (pred_depth * m)[:, None]
