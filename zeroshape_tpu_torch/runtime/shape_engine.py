"""The shape engine (counterpart of ``zeroshape_tpu/runtime/shape_engine.py``):
the single-card train loop and the evaluation.

:func:`train` (``Runner.train`` / ``train_epoch`` / ``train_iteration``,
``:450-575``) takes optimizer steps epoch by epoch on an analytic training
split, with the print / scalar / latest-checkpoint / validation cadences of
``opt.freq``, validates through :func:`evaluate` and keeps the best.

:func:`evaluate` (``Runner.evaluate``, ``:578-713``) walks a test set batch by batch: reconstruction in the
decode posture of ``_recon_fn`` (coarse-to-fine for in-training validation,
the dense grid for final metrics), the GT cloud moved into the view frame,
then either the normalised Chamfer / F-score with optional ICP
(``_score_fn``) or the best-of-rotations brute-force alignment
(``_brute_force_fn``). Final metric runs write the reference's result files:
``{dataset}_full_results.txt``, ``cd_cat.txt`` and
``quantitative_{dataset}.txt``.

Not here: multi-process training and evaluation, the profiler schedule, the
train-time and per-sample dumps (meshes, images, turntables) and the HTML
gallery.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from zeroshape_tpu_torch import recon, resolve_device
from zeroshape_tpu_torch.metrics import eval3d
from zeroshape_tpu_torch.models import resolve_compute_dtype
from zeroshape_tpu_torch.models.graph_shape import ShapeGraph
from zeroshape_tpu_torch.parallel import train as ptrain
from zeroshape_tpu_torch.runtime import checkpoint, engine_base
from zeroshape_tpu_torch.weights import init_like_flax

SAMPLE_SEED = 7  # the generator of the surface samples (the JAX engine's PRNGKey(7))
MODEL_KEYS = ("rgb_input_map", "mask_input_map", "depth_input_map", "intr", "pose_gt", "gt_sample_points",
              "gt_sample_sdf")


def use_hier_decode(opt, training):
    """The decode posture (``shape_engine.py:172-181``): coarse-to-fine for
    in-training validation (``eval.hier_decode``), the dense grid for final
    metrics unless ``eval.hier_final``, and only where it saves work."""
    vox = opt.eval.vox_res
    allowed = opt.eval.get("hier_decode", True) if training else bool(opt.eval.get("hier_final", False))
    return bool(allowed) and vox % 4 == 0 and eval3d.hier_decode_saves_work(vox, opt.eval.get("hier_capacity"))


def brute_force_prune(opt, training):
    """The search posture (``shape_engine.py:436-445``): exhaustive for final
    metrics, (1024, 128) pruning in validation; ``eval.bf_prune`` overrides both."""
    prune = opt.eval.get("bf_prune")
    if prune is None and training:
        prune = (1024, 128)
    return tuple(prune) if prune else None


def score(pred_world, gt_view, thresholds, use_icp=False):
    """Per-sample (acc [B], comp [B], f-score [B, n_thr]) of normalised clouds,
    the prediction first aligned by ICP if asked (``shape_engine.py:334-341``)."""
    pred_n = eval3d.normalize_pc(pred_world)
    gt_n = eval3d.normalize_pc(gt_view)
    if use_icp:
        pred_n = eval3d.icp(pred_n, gt_n)
    acc_d, comp_d = eval3d.chamfer_eval(pred_n, gt_n)
    return acc_d.mean(dim=1), comp_d.mean(dim=1), eval3d.compute_fscore(acc_d, comp_d, thresholds)


def check_hier_overflow(n_active, opt, training, warned):
    """Capacity overflow of the coarse-to-fine decode (``shape_engine.py:851-873``):
    raise for final metrics, warn once in validation. Returns whether a warning
    has been given."""
    cap = eval3d.resolve_hier_capacity(opt.eval.vox_res, opt.eval.get("hier_capacity"))
    n = int(n_active.max())
    if n <= cap:
        return warned
    msg = (
        f"hier_decode active cells ({n}) exceed eval.hier_capacity ({cap}); surface may be "
        "under-refined. Raise eval.hier_capacity or use the dense decode (--eval.hier_final! / "
        "--eval.hier_decode!)."
    )
    if not training:
        raise RuntimeError(msg)
    if not warned:
        print("WARNING: " + msg)
    return True


def _batches(samples, batch_size):
    """Stack samples in the dataset layout into batches of ``batch_size`` (the last may be short)."""

    def stack(group):
        out = {k: np.stack([s[k] for s in group]) for k in
               ("rgb_input_map", "mask_input_map", "pose_gt", "idx", "category_label")}
        out["dpc_points"] = np.stack([np.asarray(s["dpc"]["points"], np.float32) for s in group])
        return out

    group = []
    for s in samples:
        group.append(s)
        if len(group) == batch_size:
            yield stack(group)
            group = []
    if group:
        yield stack(group)


def full_results_header(thresholds):
    return "IND, CD, ACC, COMP, " + ", ".join(f"F-score@{t * 100:.2f}" for t in thresholds)


def full_results_line(idx, acc, comp, f):
    """One sample's row of ``{dataset}_full_results.txt`` (``shape_engine.py:680-690``)."""
    return "\n{:d}\t{:.4f}\t{:.4f}\t{:.4f}\t".format(int(idx), (acc + comp) / 2, acc, comp) + "\t".join(
        f"{x:.4f}" for x in f
    )


def write_summaries(output_path, opt, label2cat, acc, comp, f, cat, val_metric):
    """``cd_cat.txt`` and ``quantitative_{dataset}.txt`` (``shape_engine.py:743-771``)."""
    with open(os.path.join(output_path, "cd_cat.txt"), "w") as outfile:
        outfile.write("CD     Acc    Comp   Count Cat\n")
        for i in range(opt.data.get("num_classes_test", len(label2cat))):
            sel = cat == i
            if sel.sum() == 0 or i >= len(label2cat):
                continue
            acc_i, comp_i = acc[sel].mean(), comp[sel].mean()
            outfile.write("%.4f %.4f %.4f %5d %s\n" % ((acc_i + comp_i) / 2, acc_i, comp_i, sel.sum(), label2cat[i]))
    f_avg = f.mean(axis=0)
    print("##############################")
    for i, t in enumerate(opt.eval.f_thresholds):
        print("F-score @ %.2f: %.4f" % (t * 100, f_avg[i]))
    print("##############################")
    with open(os.path.join(output_path, f"quantitative_{opt.data.dataset_test}.txt"), "w") as outfile:
        outfile.write("CD     Acc    Comp \n")
        outfile.write("%.4f %.4f %.4f\n" % (val_metric, acc.mean(), comp.mean()))
        for i, t in enumerate(opt.eval.f_thresholds):
            outfile.write("F-score @ %.2f: %.4f\n" % (t * 100, f_avg[i]))


def evaluate(model, samples, opt, output_path, label2cat, training=False, device=None):
    """Score ``model`` (a ``recon.ReconModel``) on ``samples``.

    ``samples`` is any iterable of sample dicts in the dataset layout
    (``rgb_input_map [H, W, 3]``, ``mask_input_map [H, W, 1]``, ``pose_gt
    [3, 4]``, ``dpc = {"points": [G, 3]}``, ``idx``, ``category_label``);
    they go ``opt.eval.batch_size`` at a time. ``training`` picks the
    validation posture; final metrics (``training=False``) also write the
    result files into ``output_path``. Surface samples are drawn from one
    ``torch.Generator`` seeded with ``SAMPLE_SEED``, batch after batch. ``device``
    (None -> cuda) must be the model's.

    Returns a dict: ``val_metric`` (mean CD), per-sample ``acc``, ``comp``,
    ``f_score``, ``idx``, ``category_label`` (numpy), and ``s_per_sample``,
    the host-clock seconds per sample of each batch.
    """
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"the model lives on {model.device}, not on {dev}")
    ev = opt.eval
    thresholds = tuple(ev.f_thresholds)
    hier = use_hier_decode(opt, training)
    flip = opt.data.dataset_test == "pix3d"
    generator = torch.Generator(device=dev).manual_seed(SAMPLE_SEED)
    rows = {k: [] for k in ("acc", "comp", "f_score", "idx", "category_label")}
    s_per_sample, warned = [], False
    results_file = None
    if not training:
        results_file = open(os.path.join(output_path, f"{opt.data.dataset_test}_full_results.txt"), "w")
        results_file.write(full_results_header(thresholds))
    try:
        for batch in _batches(samples, ev.batch_size):
            t0 = time.perf_counter()
            _, _, pred_world, n_active = recon.reconstruct_batch(
                model, batch, generator, ev.vox_res, ev.get("hier_capacity"), ev.num_points, tuple(ev.range), hier
            )
            with torch.inference_mode():
                gt_view = eval3d.transform_gt_to_view(
                    torch.as_tensor(batch["dpc_points"], device=dev),
                    torch.as_tensor(batch["pose_gt"], dtype=torch.float32, device=dev), flip,
                )
                if ev.get("brute_force"):
                    res = eval3d.brute_force_batch(
                        pred_world, gt_view, thresholds=thresholds, prune=brute_force_prune(opt, training),
                        fast_coarse=bool(ev.get("bf_fast_coarse", True)),
                    )
                    accs, comps, fs = res["acc"], res["comp"], res["f_score"]
                else:
                    accs, comps, fs = score(pred_world, gt_view, thresholds, bool(ev.get("icp")))
            accs, comps, fs = (x.float().cpu().numpy() for x in (accs, comps, fs))
            if n_active is not None:
                warned = check_hier_overflow(n_active, opt, training, warned)
            s_per_sample.append((time.perf_counter() - t0) / len(accs))
            for k, v in (("acc", accs), ("comp", comps), ("f_score", fs), ("idx", batch["idx"]),
                         ("category_label", batch["category_label"])):
                rows[k].append(v)
            if results_file is not None:
                for b in range(len(accs)):
                    results_file.write(full_results_line(batch["idx"][b], accs[b], comps[b], fs[b]))
                results_file.flush()
    finally:
        if results_file is not None:
            results_file.close()
    out = {k: np.concatenate(v) for k, v in rows.items()}
    val_metric = (out["acc"].mean() + out["comp"].mean()) / 2
    print(f"CD. ACC: {out['acc'].mean():.4f}, COMP: {out['comp'].mean():.4f}")
    if not training:
        write_summaries(output_path, opt, label2cat, out["acc"], out["comp"], out["f_score"],
                        out["category_label"], val_metric)
    return dict(out, val_metric=float(val_metric), s_per_sample=s_per_sample)


def to_device(batch, device, keys=MODEL_KEYS):
    """The model ``keys`` of a numpy batch as fp32 tensors on ``device``
    (pinned and copied asynchronously to a GPU)."""
    out = {}
    for k in keys:
        x = torch.as_tensor(np.asarray(batch[k], np.float32))
        out[k] = x.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else x
    return out


def step_generator(seed, it, device):
    """The generator of step ``it``'s stochastic depth, a function of the seed
    and the step alone (the JAX engine's ``fold_in(PRNGKey(seed), it)``), so a
    resumed run draws what the uninterrupted one did."""
    return torch.Generator(device=device).manual_seed(seed * 2**32 + it)


def validate(graph, data, opt, output_path, device):
    """In-training validation (``training=True``) of ``graph`` on ``data.val``:
    the graph is switched to eval, its K1 weights packed anew, its logits not
    sharpened, and switched back to train. Returns :func:`evaluate`'s dict."""
    graph.eval()
    try:
        model = recon.ReconModel(graph, None, 1.0, device).repack()
        return evaluate(model, data.val, opt, output_path, data.label2cat, training=True, device=device)
    finally:
        graph.train()


def train(opt, data, output_path, device=None):
    """Train the shape graph on ``data`` (a ``data.analytic.TrainSet``) under
    ``opt`` (e.g. ``config.shape_gen_opt()`` with overrides); checkpoints and
    event files go to ``output_path``.

    A fresh run starts from ``weights.init_like_flax(seed=opt.seed)`` with
    the pretrained weights that ``opt`` names staged over it
    (:func:`checkpoint.stage_pretrained`: ``pretrain.depth``, else
    ``arch.depth.pretrained``); ``opt.resume`` then continues from
    ``latest.ckpt``, or ``opt.load`` restores a checkpoint's weights
    (:func:`engine_base.start_run`). The loop and its cadences are
    :func:`engine_base.train_loop`'s; a step is :func:`parallel.train.
    train_step` with the stochastic depth of :func:`step_generator` and, at
    the scalar cadence, the attention statistics; validation is
    :func:`validate`, the best CD kept (``shape_engine.py:460-549``).

    Returns :func:`engine_base.train_loop`'s dict.
    """
    dev = resolve_device(device)
    os.makedirs(output_path, exist_ok=True)
    if not opt.get("resume"):
        engine_base.clear_event_files(output_path)
    seed, n_sdf = opt.get("seed") or 0, opt.training.get("n_sdf_points")
    n_batches = engine_base.count_batches(data, opt.batch_size)
    graph = ShapeGraph.from_opt(opt, dtype=resolve_compute_dtype(opt, dev))
    graph = init_like_flax(graph, seed).to(dev).train()
    checkpoint.stage_pretrained(graph, opt, "shape")
    optimizer = ptrain.make_optimizer(graph, opt.optim, n_batches, opt.max_epoch)
    start = engine_base.start_run(opt, output_path, graph, optimizer)

    def step(batch, it, with_stats):
        metrics, _ = ptrain.train_step(graph, optimizer, batch, opt, step_generator(seed, it, dev),
                                       with_stats=with_stats)
        return metrics

    def run_validation(ep):
        cd = validate(graph, data, opt, output_path, dev)["val_metric"]
        return cd, {"eval/cd": cd}

    return engine_base.train_loop(
        opt, data, output_path, graph, optimizer, lambda idx, ep: to_device(data.batch(idx, ep, seed, n_sdf), dev),
        step, run_validation, "CD", start,
    )
