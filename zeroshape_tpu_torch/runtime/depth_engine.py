"""The depth engine (counterpart of ``zeroshape_tpu/runtime/depth_engine.py``):
depth + intrinsics pretraining, and its evaluation, in one process or several.

:func:`train` is stage 1 of the two-stage recipe (``options/depth_gen.yaml``,
then a shape run with ``pretrain.depth`` set to its ``best.ckpt``): the
shape engine's loop (:func:`engine_base.train_loop`) over the depth graph,
validated by :func:`evaluate`, the best checkpoint chosen on ``l1_err``.

:func:`evaluate` (``Runner.evaluate``, ``:254-294``) computes the aligned
depth metrics per sample and averages them over the samples.

The visual dumps are the JAX engine's: a final evaluation writes its first
batch's input images and depth estimates into ``dump_{dataset}/`` (each
rank its rows); training writes, on rank 0, ``vis_log/iter_{it}/`` at the
``freq.save_vis`` cadence (:func:`save_vis`: images, both depths and the
seen surfaces of ``eval.n_vis`` validation samples) and TensorBoard grids at
``freq.vis`` (:func:`visualize_train_batch`).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from zeroshape_tpu_torch import resolve_device, vis
from zeroshape_tpu_torch.data.base import DataLoader
from zeroshape_tpu_torch.metrics.depth_metrics import DEFAULT_THRESHOLDS, compute_depth_metrics, metric_keys
from zeroshape_tpu_torch.models import graph_depth, resolve_compute_dtype
from zeroshape_tpu_torch.models.graph_depth import DepthGraph
from zeroshape_tpu_torch.parallel import dist
from zeroshape_tpu_torch.parallel import train as ptrain
from zeroshape_tpu_torch.runtime import checkpoint, engine_base
from zeroshape_tpu_torch.runtime.logging import log_print
from zeroshape_tpu_torch.runtime.shape_engine import to_device
from zeroshape_tpu_torch.weights import init_like_flax

MODEL_KEYS = ("rgb_input_map", "mask_input_map", "depth_input_map", "intr")


def dump_eval_batch(opt, output_path, batch, depth_pred, n):
    """The first ``n`` rows' input images and depth estimates into
    ``dump_{dataset}/`` (``_dump_eval_batch``, ``depth_engine.py:296-319``)."""
    if n <= 0:
        return
    folder = f"dump_{opt.data.dataset_test}"
    idx = np.asarray(batch["idx"])[:n]
    vis.dump_images(output_path, idx, "image_input", np.asarray(batch["rgb_input_map"])[:n], folder=folder)
    vis.dump_depths(output_path, idx, "depth_est", depth_pred[:n], np.asarray(batch["mask_input_map"])[:n],
                    rescale=True, folder=folder)


def evaluate(graph, samples, opt, output_path, training=False, device=None):
    """The aligned depth metrics of ``graph`` (a :class:`DepthGraph` on
    ``device``, None -> cuda) on ``samples`` (a dataset or list of dicts with
    ``rgb_input_map``, ``mask_input_map``, ``depth_input_map``, ``intr``, and
    ``mask_eroded`` where a dataset erodes its masks, which then scores in
    place of the mask), global batches of ``opt.eval.batch_size`` with each
    rank scoring its rows, ``eval.d_thresholds`` and ``eval.depth_cap``.
    The per-sample metrics are gathered over the ranks and the padding of an
    uneven tail dropped, so the means are over exactly the samples given.
    Final metrics (``training=False``) write ``best_val.txt`` into
    ``output_path`` in the JAX engine's format (``depth_engine.py:290-293``;
    rank 0) and the first batch's dumps (:func:`dump_eval_batch`).

    Returns ``{key: mean}`` over :func:`metric_keys`.
    """
    dev = resolve_device(device)
    thresholds = tuple(opt.eval.get("d_thresholds") or DEFAULT_THRESHOLDS)
    keys = metric_keys(thresholds)
    eval_bs, N = opt.eval.batch_size, len(samples)
    loader = DataLoader(samples, eval_bs, num_workers=(opt.get("data") or {}).get("num_workers", 4),
                        process_index=dist.rank(), process_count=dist.world())
    sums, count = {k: 0.0 for k in keys}, 0
    was_training = graph.training
    graph.eval()
    try:
        with torch.inference_mode():
            for it, batch in enumerate(loader):
                B0 = min(eval_bs, N - it * eval_bs)
                names = MODEL_KEYS + (("mask_eroded",) if "mask_eroded" in batch else ())
                b = to_device(batch, dev, names)
                out = graph(b, train=False)
                mask = b.get("mask_eroded", b["mask_input_map"])
                metrics, _ = compute_depth_metrics(
                    out["depth_pred"].permute(0, 3, 1, 2), b["depth_input_map"].permute(0, 3, 1, 2),
                    mask.permute(0, 3, 1, 2), thresholds=thresholds, depth_cap=opt.eval.get("depth_cap"),
                )
                got = dist.gather_rows({k: metrics[k].double().cpu().numpy() for k in keys})
                for k in keys:
                    sums[k] += float(got[k][:B0].sum())
                count += B0
                if not training and it == 0:
                    dump_eval_batch(opt, output_path, batch, out["depth_pred"], dist.local_valid_rows(B0, len(mask)))
                if it % opt.freq.print_eval == 0:
                    log_print(f"Eval Iter {it}/{len(loader)} @ {count} samples")
    finally:
        graph.train(was_training)
    assert count == N, (count, N)
    means = {k: v / max(count, 1) for k, v in sums.items()}
    for k in keys:
        log_print(f"eval {k}: {means[k]:.4f}")
    if not training and dist.is_main():
        with open(os.path.join(output_path, "best_val.txt"), "w") as f:
            for k in keys:
                f.write(f"{k}: {means[k]:.6f}\n")
    return means


def _forward(graph, batch, device):
    """The graph's eval-mode outputs for a host batch; the graph's mode is kept."""
    was_training = graph.training
    graph.eval()
    try:
        with torch.inference_mode():
            return graph(to_device(batch, device, MODEL_KEYS), train=False)
    finally:
        graph.train(was_training)


def save_vis(graph, viz, opt, output_path, device, it):
    """``vis_log/iter_{it}/`` (``vis_train_iter``, ``depth_engine.py:209-245``;
    rank 0): each ``viz`` sample's image, mask, estimated and GT depth and,
    where the graph gave them, the seen surfaces (red prediction, green GT)."""
    if not dist.is_main():
        return
    folder = os.path.join("vis_log", f"iter_{it}")
    for sample in viz:
        out = _forward(graph, sample, device)
        idx = np.asarray(sample["idx"])[:1]
        mask = np.asarray(sample["mask_input_map"])[:1]
        vis.dump_images(output_path, idx, "image_input", np.asarray(sample["rgb_input_map"])[:1], folder=folder)
        vis.dump_images(output_path, idx, "mask_input", mask, folder=folder)
        vis.dump_depths(output_path, idx, "depth_est", out["depth_pred"][:1], mask, rescale=True, folder=folder)
        vis.dump_depths(output_path, idx, "depth_input", np.asarray(sample["depth_input_map"])[:1], mask,
                        rescale=True, folder=folder)
        if "seen_points_pred" in out and "seen_points_gt" in out:
            vis.dump_pointclouds_compare(output_path, idx, "seen_surface", out["seen_points_pred"][:1],
                                         out["seen_points_gt"][:1], folder=folder)


def visualize_train_batch(graph, batch, opt, tb, step, device):
    """TensorBoard grids of a host training batch at ``freq.vis``
    (``depth_engine.py:183-207``): images, masks, the estimated and the GT depth."""
    out = _forward(graph, batch, device)
    ni = tuple((opt.get("tb") or {}).get("num_images") or (4, 8))
    vis.tb_image(tb, step, "train", "image_input_map", batch["rgb_input_map"], num_images=ni)
    vis.tb_image(tb, step, "train", "mask_input_map", batch["mask_input_map"], num_images=ni)
    vis.tb_image(tb, step, "train", "depth_est_map", out["depth_pred"], num_images=ni)
    vis.tb_image(tb, step, "train", "depth_input_map", batch["depth_input_map"], num_images=ni)


def train(opt, data, output_path, device=None):
    """Train the depth graph under ``opt`` (e.g. ``config.depth_gen_opt()``
    with overrides) on ``data`` (samples with depth maps and intrinsics, a
    ``data.analytic.TrainSet`` for one), validated on ``data.val``; with
    ``data`` None on the datasets ``opt.data`` names
    (:func:`engine_base.load_dataset`). Checkpoints (the reference depth
    graph's ``.ckpt`` layout) and event files go to ``output_path``.

    A fresh run starts from ``weights.init_like_flax(seed=opt.seed)`` with
    ``arch.depth.pretrained`` staged over it (:func:`checkpoint.
    stage_pretrained`); then ``opt.resume`` or ``opt.load``, as in the shape
    engine. Validation (:func:`evaluate` on ``data.val``) runs before the
    first step and every ``freq.eval`` epochs; the lowest ``l1_err`` is kept
    as ``best.ckpt``. The loop and its cadences are :func:`engine_base.
    train_loop`'s over the training set's loader, a step
    :func:`parallel.train.train_step` with the depth graph's loss.

    Returns :func:`engine_base.train_loop`'s dict; ``val_scalars`` holds
    every metric of each validation.
    """
    dev = resolve_device(device)
    os.makedirs(output_path, exist_ok=True)
    if not opt.get("resume"):
        engine_base.clear_event_files(output_path)
    seed = opt.get("seed") or 0
    train_data, val_data = (data, data.val) if data is not None else engine_base.load_dataset(opt)
    loader = train_data.setup_loader(opt, shuffle=True, drop_last=True, pin_memory=dev.type == "cuda")
    n_batches = engine_base.count_batches(train_data, opt.batch_size)
    graph = DepthGraph.from_opt(opt, dtype=resolve_compute_dtype(opt, dev))
    graph = init_like_flax(graph, seed).to(dev).train()
    checkpoint.stage_pretrained(graph, opt, "depth")
    optimizer = ptrain.make_optimizer(graph, opt.optim, n_batches, opt.max_epoch)
    start = engine_base.start_run(opt, output_path, graph, optimizer)

    def step(batch, it, with_stats):
        metrics, _ = ptrain.train_step(graph, optimizer, batch, opt, loss_fn=graph_depth.compute_loss,
                                       metrics_fn=None)
        return metrics

    def run_validation(ep):
        means = evaluate(graph, val_data, opt, output_path, training=True, device=dev)
        return means["l1_err"], {f"eval/{k}": v for k, v in means.items()}

    viz = engine_base.viz_samples(val_data, opt.eval.get("n_vis"))
    return engine_base.train_loop(opt, loader, output_path, graph, optimizer,
                                  lambda batch: to_device(batch, dev, MODEL_KEYS), step, run_validation, "l1_err",
                                  start, visualize=lambda batch, it, tb: visualize_train_batch(graph, batch, opt, tb,
                                                                                               it, dev),
                                  save_vis=lambda it: save_vis(graph, viz, opt, output_path, dev, it))
