"""The depth engine (counterpart of ``zeroshape_tpu/runtime/depth_engine.py``):
depth + intrinsics pretraining on one card, and its evaluation.

:func:`train` is stage 1 of the two-stage recipe (``options/depth_gen.yaml``,
then a shape run with ``pretrain.depth`` set to its ``best.ckpt``): the
shape engine's loop (:func:`engine_base.train_loop`) over the depth graph,
validated by :func:`evaluate`, the best checkpoint chosen on ``l1_err``.

:func:`evaluate` (``Runner.evaluate``, ``:254-294``) computes the aligned
depth metrics per sample and averages them over the samples.

Not here: the train-time and evaluation visual dumps (they wait for the
port's ``vis``) and multi-process runs.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from zeroshape_tpu_torch import resolve_device
from zeroshape_tpu_torch.metrics.depth_metrics import DEFAULT_THRESHOLDS, compute_depth_metrics, metric_keys
from zeroshape_tpu_torch.models import graph_depth, resolve_compute_dtype
from zeroshape_tpu_torch.models.graph_depth import DepthGraph
from zeroshape_tpu_torch.parallel import train as ptrain
from zeroshape_tpu_torch.runtime import checkpoint, engine_base
from zeroshape_tpu_torch.runtime.shape_engine import to_device
from zeroshape_tpu_torch.weights import init_like_flax

MODEL_KEYS = ("rgb_input_map", "mask_input_map", "depth_input_map", "intr")


def _batches(samples, batch_size):
    """Stack samples into batches of ``batch_size`` (the last may be short):
    the model keys and ``mask_eroded`` where the samples have it."""
    keys = MODEL_KEYS + (("mask_eroded",) if samples and "mask_eroded" in samples[0] else ())
    for i in range(0, len(samples), batch_size):
        group = samples[i : i + batch_size]
        yield {k: np.stack([s[k] for s in group]) for k in keys}


def evaluate(graph, samples, opt, output_path, training=False, device=None):
    """The aligned depth metrics of ``graph`` (a :class:`DepthGraph` on
    ``device``, None -> cuda) on ``samples`` (dicts with ``rgb_input_map``,
    ``mask_input_map``, ``depth_input_map``, ``intr``, and ``mask_eroded``
    where a dataset erodes its masks, which then scores in place of the
    mask), ``opt.eval.batch_size`` at a time, with ``eval.d_thresholds`` and
    ``eval.depth_cap``. The means are over exactly the samples given. Final
    metrics (``training=False``) write ``best_val.txt`` into ``output_path``
    in the JAX engine's format (``depth_engine.py:290-293``).

    Returns ``{key: mean}`` over :func:`metric_keys`.
    """
    dev = resolve_device(device)
    thresholds = tuple(opt.eval.get("d_thresholds") or DEFAULT_THRESHOLDS)
    keys = metric_keys(thresholds)
    sums, count = {k: 0.0 for k in keys}, 0
    was_training = graph.training
    graph.eval()
    try:
        with torch.inference_mode():
            for it, batch in enumerate(_batches(list(samples), opt.eval.batch_size)):
                b = to_device(batch, dev, tuple(batch))
                out = graph(b, train=False)
                mask = b.get("mask_eroded", b["mask_input_map"])
                metrics, _ = compute_depth_metrics(
                    out["depth_pred"].permute(0, 3, 1, 2), b["depth_input_map"].permute(0, 3, 1, 2),
                    mask.permute(0, 3, 1, 2), thresholds=thresholds, depth_cap=opt.eval.get("depth_cap"),
                )
                for k in keys:
                    sums[k] += float(metrics[k].double().sum())
                count += len(batch["rgb_input_map"])
                if it % opt.freq.print_eval == 0:
                    print(f"Eval Iter {it} @ {count} samples")
    finally:
        graph.train(was_training)
    means = {k: v / max(count, 1) for k, v in sums.items()}
    for k in keys:
        print(f"eval {k}: {means[k]:.4f}")
    if not training:
        with open(os.path.join(output_path, "best_val.txt"), "w") as f:
            for k in keys:
                f.write(f"{k}: {means[k]:.6f}\n")
    return means


def train(opt, data, output_path, device=None):
    """Train the depth graph on ``data`` (a ``data.analytic.TrainSet``, whose
    samples carry depth maps and intrinsics) under ``opt`` (e.g.
    ``config.depth_gen_opt()`` with overrides); checkpoints (the reference
    depth graph's ``.ckpt`` layout) and event files go to ``output_path``.

    A fresh run starts from ``weights.init_like_flax(seed=opt.seed)`` with
    ``arch.depth.pretrained`` staged over it (:func:`checkpoint.
    stage_pretrained`); then ``opt.resume`` or ``opt.load``, as in the shape
    engine. Validation (:func:`evaluate` on ``data.val``) runs before the
    first step and every ``freq.eval`` epochs; the lowest ``l1_err`` is kept
    as ``best.ckpt``. The loop and its cadences are :func:`engine_base.
    train_loop`'s, a step :func:`parallel.train.train_step` with the depth
    graph's loss.

    Returns :func:`engine_base.train_loop`'s dict; ``val_scalars`` holds
    every metric of each validation.
    """
    dev = resolve_device(device)
    os.makedirs(output_path, exist_ok=True)
    if not opt.get("resume"):
        engine_base.clear_event_files(output_path)
    seed = opt.get("seed") or 0
    n_batches = engine_base.count_batches(data, opt.batch_size)
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
        means = evaluate(graph, data.val, opt, output_path, training=True, device=dev)
        return means["l1_err"], {f"eval/{k}": v for k, v in means.items()}

    return engine_base.train_loop(
        opt, data, output_path, graph, optimizer,
        lambda idx, ep: to_device(data.batch(idx, ep, seed), dev, MODEL_KEYS), step, run_validation, "l1_err",
        start,
    )
