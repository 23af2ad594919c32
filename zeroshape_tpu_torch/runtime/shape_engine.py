"""The shape engine (counterpart of ``zeroshape_tpu/runtime/shape_engine.py``):
the train loop and the evaluation, in one process or several.

:func:`train` (``Runner.train`` / ``train_epoch`` / ``train_iteration``,
``:450-575``) takes optimizer steps epoch by epoch on a training set (the
dataset ``opt`` names on disk, or a ``data.analytic.TrainSet``), with the
print / scalar / latest-checkpoint / validation cadences of ``opt.freq``,
validates through :func:`evaluate` and keeps the best. Its scalars are the
JAX engine's: ``train/<metrics of the step>``, and at the scalar cadence
``train/dist_acc`` / ``train/dist_cov``, a reconstruction and score of the
first ``eval.batch_size`` training samples (:func:`train_metrics`);
``eval/dist_acc`` / ``eval/dist_cov`` at each validation.

:func:`evaluate` (``Runner.evaluate``, ``:578-713``) walks a test set batch by batch: reconstruction in the
decode posture of ``_recon_fn`` (coarse-to-fine for in-training validation,
the dense grid for final metrics), the GT cloud moved into the view frame,
then either the normalised Chamfer / F-score with optional ICP
(``_score_fn``) or the best-of-rotations brute-force alignment
(``_brute_force_fn``). Under several ranks each scores its rows of every
global batch and the per-sample metrics are gathered. Final metric runs
write the reference's result files (rank 0): ``{dataset}_full_results.txt``,
``cd_cat.txt`` and ``quantitative_{dataset}.txt``.

Not here: the train-time and per-sample dumps (meshes, images, turntables)
and the HTML gallery; they wait for the port's ``vis``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from zeroshape_tpu_torch import recon, resolve_device, vis
from zeroshape_tpu_torch.data.base import DataLoader
from zeroshape_tpu_torch.metrics import eval3d
from zeroshape_tpu_torch.models import resolve_compute_dtype
from zeroshape_tpu_torch.models.graph_shape import ShapeGraph
from zeroshape_tpu_torch.ops.marching_cubes import marching_cubes_mesh
from zeroshape_tpu_torch.parallel import dist
from zeroshape_tpu_torch.parallel import train as ptrain
from zeroshape_tpu_torch.runtime import checkpoint, engine_base
from zeroshape_tpu_torch.runtime.logging import MetricLogger, log_print
from zeroshape_tpu_torch.weights import init_like_flax

SAMPLE_SEED = 7  # the surface draws of evaluation (the JAX engine's PRNGKey(7))
TRAIN_METRIC_SEED = 13  # those of the train-split metrics (its PRNGKey(13))
MODEL_KEYS = recon.MODEL_KEYS


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
    the prediction first aligned by ICP if asked (``shape_engine.py:334-341``),
    and the two clouds as scored (``pred_n``, ``gt_n``)."""
    pred_n = eval3d.normalize_pc(pred_world)
    gt_n = eval3d.normalize_pc(gt_view)
    if use_icp:
        pred_n = eval3d.icp(pred_n, gt_n)
    acc_d, comp_d = eval3d.chamfer_eval(pred_n, gt_n)
    return acc_d.mean(dim=1), comp_d.mean(dim=1), eval3d.compute_fscore(acc_d, comp_d, thresholds), pred_n, gt_n


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


def sample_generators(idx, device, seed=SAMPLE_SEED):
    """One generator a sample, seeded by ``seed`` and the sample's dataset
    index: the surface draws, and so the metrics, depend on neither the batch
    order, the eval batch size nor the number of ranks."""
    return [torch.Generator(device=device).manual_seed(seed * 2**32 + int(i)) for i in np.asarray(idx)]


def score_batch(model, batch, opt, training, seed=SAMPLE_SEED, keep=False):
    """Reconstruct and score one host batch (``rgb_input_map``,
    ``mask_input_map``, ``pose_gt``, ``idx``, ``dpc = {"points"}``) in the
    posture of ``training``. Returns numpy ``acc [B]``, ``comp [B]``,
    ``f_score [B, n_thr]`` and the active cells ``[B]`` (None for the dense
    decode); with ``keep``, also what :func:`dump_results` draws (a dict of
    the graph's outputs, the level grids and the scored clouds, on the device)."""
    ev, dev = opt.eval, model.device
    thresholds = tuple(ev.f_thresholds)
    out, level, pred_world, n_active = recon.reconstruct_batch(
        model, batch, sample_generators(batch["idx"], dev, seed), ev.vox_res, ev.get("hier_capacity"),
        ev.num_points, tuple(ev.range), use_hier_decode(opt, training),
    )
    with torch.inference_mode():
        gt_view = eval3d.transform_gt_to_view(
            torch.as_tensor(np.asarray(batch["dpc"]["points"], np.float32), device=dev),
            torch.as_tensor(np.asarray(batch["pose_gt"], np.float32), device=dev),
            opt.data.dataset_test == "pix3d",
        )
        if ev.get("brute_force"):
            res = eval3d.brute_force_batch(pred_world, gt_view, thresholds=thresholds,
                                           prune=brute_force_prune(opt, training),
                                           fast_coarse=bool(ev.get("bf_fast_coarse", True)))
            accs, comps, fs, pred_n, gt_n = res["acc"], res["comp"], res["f_score"], res["pc_pred"], res["pc_gt"]
        else:
            accs, comps, fs, pred_n, gt_n = score(pred_world, gt_view, thresholds, bool(ev.get("icp")))
    accs, comps, fs = (x.float().cpu().numpy() for x in (accs, comps, fs))
    got = accs, comps, fs, None if n_active is None else n_active.cpu().numpy()
    return got + ({"out": out, "level": level, "pred_n": pred_n, "gt_n": gt_n},) if keep else got


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


def dump_results(opt, output_path, batch, drawn, n, folder, train=False, device=None):
    """The first ``n`` rows' dumps into ``output_path/folder``
    (``Runner.dump_results``, ``shape_engine.py:778-824``): the input image and
    mask, the mesh (marching cubes of the level grid in world units), its
    turntable (every row of a final evaluation unless ``eval.dump_mesh_viz``
    is false; in training only where it is true), the depth estimate and the
    scored clouds (red prediction, green GT). ``drawn`` is
    :func:`score_batch`'s fourth result; the turntables render on ``device``.
    A rank whose rows all pad an uneven tail (``n`` 0) dumps nothing."""
    if n <= 0:
        return
    idx = np.asarray(batch["idx"])[:n]
    vis.dump_images(output_path, idx, "image_input", np.asarray(batch["rgb_input_map"])[:n], folder=folder)
    vis.dump_images(output_path, idx, "mask_input", np.asarray(batch["mask_input_map"])[:n], folder=folder)
    lo, hi = opt.eval.range
    S = opt.eval.vox_res + 1
    level = drawn["level"][:n].float().cpu().numpy()
    meshes = [(v / S * (hi - lo) + lo, f) for v, f in (marching_cubes_mesh(lv) for lv in level)]
    vis.dump_meshes(output_path, idx, "mesh", meshes, folder=folder)
    dump_viz = opt.eval.get("dump_mesh_viz")
    if (dump_viz is None and not train) or dump_viz:
        vis.dump_meshes_viz(output_path, idx, "mesh_viz", meshes, folder=folder, device=device)
    if "depth_pred" in drawn["out"]:
        vis.dump_depths(output_path, idx, "depth_est", drawn["out"]["depth_pred"][:n],
                        np.asarray(batch["mask_input_map"])[:n], rescale=True, folder=folder)
    vis.dump_pointclouds_compare(output_path, idx, "pointclouds_comp", drawn["pred_n"][:n], drawn["gt_n"][:n],
                                 folder=folder)


def dump_viz_samples(model, viz, opt, output_path, folder):
    """The training-time dumps of the ``viz`` samples (batches of one) into
    ``output_path/folder`` (``_dump_viz_samples``, ``shape_engine.py:887-927``):
    the dense reconstruction with attention (``recon.reconstruct_with_attn``,
    the surface drawn from the sample's index), :func:`dump_results`, the
    attention sweep ``attn.gif`` and, where the graph gave them, the seen
    surface against the GT surface points."""
    ev, dev = opt.eval, model.device
    for sample in viz:
        generator = torch.Generator(device=dev).manual_seed(int(np.asarray(sample["idx"])[0]))
        out, level, world, attn_xy = recon.reconstruct_with_attn(model, sample, generator, ev.vox_res, ev.num_points,
                                                                 tuple(ev.range))
        with torch.inference_mode():
            pred_n = eval3d.normalize_pc(world)
            gt_n = pred_n
            if "dpc" in sample:
                gt_n = eval3d.normalize_pc(eval3d.transform_gt_to_view(
                    torch.as_tensor(np.asarray(sample["dpc"]["points"], np.float32), device=dev),
                    torch.as_tensor(np.asarray(sample["pose_gt"], np.float32), device=dev),
                    opt.data.dataset_test == "pix3d"))
        drawn = {"out": out, "level": level, "pred_n": pred_n, "gt_n": gt_n}
        dump_results(opt, output_path, sample, drawn, 1, folder, train=True, device=dev)
        frames = eval3d.attention_frames(attn_xy[0].cpu().numpy(), np.asarray(sample["rgb_input_map"])[0], ev.vox_res,
                                         opt.H // opt.arch.win_size)
        idx = np.asarray(sample["idx"])[:1]
        vis.dump_attentions(output_path, idx, "attn", [frames], folder=folder)
        if "gt_surf_points" in out and "seen_points" in out:
            vis.dump_pointclouds_compare(output_path, idx, "seen_surface", out["seen_points"][:1],
                                         out["gt_surf_points"][:1], folder=folder)


def dump_viz(model, viz, opt, output_path, ep):
    """``vis_{ep}/`` and its gallery ``results_ep{ep}.html`` (``_dump_viz``,
    ``shape_engine.py:875-885``); rank 0 only."""
    if not viz or not dist.is_main():
        return
    log_print("visualizing and saving results...")
    dump_viz_samples(model, viz, opt, output_path, f"vis_{ep}")
    vis.create_gif_html(os.path.join(output_path, f"vis_{ep}"), os.path.join(output_path, f"results_ep{ep}.html"))


def evaluate(model, samples, opt, output_path, label2cat, training=False, device=None, seed=SAMPLE_SEED):
    """Score ``model`` (a ``recon.ReconModel``) on ``samples``.

    ``samples`` is a sequence of sample dicts in the dataset layout (a
    dataset or a list: ``rgb_input_map [H, W, 3]``, ``mask_input_map [H,
    W, 1]``, ``pose_gt [3, 4]``, ``dpc = {"points": [G, 3]}``, ``idx``,
    ``category_label``); they go through a ``data.base.DataLoader`` of
    global batches of ``opt.eval.batch_size``, each rank scoring its rows
    (:func:`score_batch`), the per-sample metrics gathered and the padding
    of an uneven tail dropped. ``training`` picks the validation posture;
    final metrics (``training=False``) also write the result files into
    ``output_path`` (rank 0) and the dumps of :func:`dump_results` into
    ``output_path/dump_{dataset}/`` (each rank the samples it scored), then,
    once every rank's are on disk, ``results_test.html`` over every 10th
    sample (rank 0). Surface samples are drawn by
    :func:`sample_generators` from ``seed``. ``device`` (None -> cuda) must
    be the model's.

    Returns a dict: ``val_metric`` (mean CD), per-sample ``acc``, ``comp``,
    ``f_score``, ``idx``, ``category_label`` and ``hier_n_active``
    (numpy, the dataset's order), ``s_per_sample``, the host-clock
    seconds per sample of each batch, and ``dump_seconds``, this rank's
    seconds in :func:`dump_results`.
    """
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"the model lives on {model.device}, not on {dev}")
    ev = opt.eval
    thresholds = tuple(ev.f_thresholds)
    loader = DataLoader(samples, ev.batch_size, num_workers=(opt.get("data") or {}).get("num_workers", 4),
                        process_index=dist.rank(), process_count=dist.world())
    N = len(samples)
    keys = ("acc", "comp", "f_score", "idx", "category_label", "hier_n_active")
    rows = {k: [] for k in keys}
    s_per_sample, warned, logger, dump_seconds = [], False, MetricLogger(), 0.0
    results_file = None
    if not training and dist.is_main():
        results_file = open(os.path.join(output_path, f"{opt.data.dataset_test}_full_results.txt"), "w")
        results_file.write(full_results_header(thresholds))
    try:
        t0 = time.perf_counter()
        for it, batch in enumerate(loader):
            B0 = min(ev.batch_size, N - it * ev.batch_size)  # the valid rows of this global batch
            accs, comps, fs, n_active, *drawn = score_batch(model, batch, opt, training, seed, keep=not training)
            got = dist.gather_rows({
                "acc": accs, "comp": comps, "f_score": fs, "idx": np.asarray(batch["idx"], np.int64),
                "category_label": np.asarray(batch["category_label"], np.int64),
                "hier_n_active": np.full(len(accs), -1, np.int64) if n_active is None else n_active.astype(np.int64),
            })
            if n_active is not None:
                warned = check_hier_overflow(got["hier_n_active"], opt, training, warned)
            for k in keys:
                rows[k].append(got[k][:B0])
            now = time.perf_counter()
            s_per_sample.append((now - t0) / B0)
            t0 = now
            acc, comp = got["acc"][:B0].mean(), got["comp"][:B0].mean()
            logger.update(ACC=acc, COMP=comp, CD=(acc + comp) / 2, s_smp=s_per_sample[-1])
            if it % ((opt.get("freq") or {}).get("print_eval") or 1) == 0:
                log_print(f"Eval Iter {it}/{len(loader)}: {logger}")
            if results_file is not None:
                for b in range(B0):
                    results_file.write(full_results_line(got["idx"][b], got["acc"][b], got["comp"][b],
                                                         got["f_score"][b]))
                results_file.flush()
            if not training:
                t_dump = time.perf_counter()
                dump_results(opt, output_path, batch, drawn[0], dist.local_valid_rows(B0, len(accs)),
                             f"dump_{opt.data.dataset_test}", device=dev)
                dump_seconds += time.perf_counter() - t_dump
    finally:
        if results_file is not None:
            results_file.close()
    out = {k: np.concatenate(v) for k, v in rows.items()}
    assert len(out["acc"]) == N, (len(out["acc"]), N)
    val_metric = (out["acc"].mean() + out["comp"].mean()) / 2
    log_print(f"CD. ACC: {out['acc'].mean():.4f}, COMP: {out['comp'].mean():.4f}")
    if not training:
        dist.barrier()  # every rank's dumps are on disk before the gallery reads them
    if not training and dist.is_main():
        write_summaries(output_path, opt, label2cat, out["acc"], out["comp"], out["f_score"],
                        out["category_label"], val_metric)
        vis.create_gif_html(os.path.join(output_path, f"dump_{opt.data.dataset_test}"),
                            os.path.join(output_path, "results_test.html"), skip_every=10)
    return dict(out, val_metric=float(val_metric), s_per_sample=s_per_sample, dump_seconds=dump_seconds)


def to_device(batch, device, keys=MODEL_KEYS):
    """The model ``keys`` of a host batch (numpy, or pinned tensors from a
    pinning loader) as fp32 tensors on ``device``, copied to a GPU from
    pinned memory without blocking."""
    out = {}
    for k in keys:
        x = torch.as_tensor(np.asarray(batch[k], np.float32) if isinstance(batch[k], np.ndarray) else batch[k])
        if device.type == "cuda":
            x = (x if x.is_pinned() else x.pin_memory()).to(device, non_blocking=True)
        out[k] = x
    return out


def step_generator(seed, it, device):
    """The generator of step ``it``'s stochastic depth, a function of the seed
    and the step alone (the JAX engine's ``fold_in(PRNGKey(seed), it)``), so a
    resumed run draws what the uninterrupted one did."""
    return torch.Generator(device=device).manual_seed(seed * 2**32 + it)


def recon_model(graph, device):
    """``graph`` switched to eval as a ``recon.ReconModel`` at sharpen 1 with
    its K1 weights packed anew (the posture of validation)."""
    graph.eval()
    return recon.ReconModel(graph, None, 1.0, device).repack()


def validate(graph, data, opt, output_path, device, ep=None, viz=()):
    """In-training validation (``training=True``) of ``graph`` on ``data``
    (a sequence of samples): the graph is switched to eval, its K1 weights
    packed anew, its logits not sharpened, and switched back to train. With
    ``ep``, rank 0 then dumps the ``viz`` samples into ``vis_{ep}/``
    (:func:`dump_viz`). Returns :func:`evaluate`'s dict."""
    try:
        model = recon_model(graph, device)
        res = evaluate(model, data, opt, output_path, getattr(data, "label2cat", None), training=True, device=device)
        if ep is not None:
            dump_viz(model, viz, opt, output_path, ep)
        return res
    finally:
        graph.train()


def save_vis(graph, viz, opt, output_path, device, it):
    """``vis_log/iter_{it}/``: the ``viz`` samples' dumps at the
    ``freq.save_vis`` cadence (``vis_train_iter``, ``shape_engine.py:929-934``);
    rank 0 only."""
    if not viz or not dist.is_main():
        return
    try:
        dump_viz_samples(recon_model(graph, device), viz, opt, output_path, os.path.join("vis_log", f"iter_{it}"))
    finally:
        graph.train()


def visualize_train_batch(graph, batch, opt, tb, step, device):
    """TensorBoard grids of a host training batch at ``freq.vis``
    (``visualize_train_batch``, ``shape_engine.py:936-970``): the input images,
    masks, the depth estimate (the graph in eval mode, without supervision)
    and the GT depth."""
    graph.eval()
    try:
        with torch.inference_mode():
            out = graph(to_device(batch, device, ("rgb_input_map", "mask_input_map")), train=False,
                        with_supervision=False)
    finally:
        graph.train()
    ni = tuple((opt.get("tb") or {}).get("num_images") or (4, 8))
    vis.tb_image(tb, step, "train", "image_input_map", batch["rgb_input_map"], num_images=ni)
    vis.tb_image(tb, step, "train", "mask_input_map", batch["mask_input_map"], num_images=ni)
    vis.tb_image(tb, step, "train", "depth_est_map", out["depth_pred"], num_images=ni)
    if "depth_input_map" in batch:
        vis.tb_image(tb, step, "train", "depth_input_map", batch["depth_input_map"], num_images=ni)


def train_metrics(graph, batch, opt, device):
    """``train/dist_acc`` and ``train/dist_cov`` of a host training batch
    (``_log_train_shape_metrics``, ``shape_engine.py:826-849``): its first
    ``eval.batch_size // world`` rows on each rank reconstructed and scored
    in the validation posture with the fixed seed :data:`TRAIN_METRIC_SEED`,
    the scores gathered over the ranks. Empty where the batch has no ``dpc``
    (the in-memory split) or too few rows."""
    k = opt.eval.batch_size // dist.world()
    if "dpc" not in batch or k == 0 or len(batch["idx"]) < k:
        return {}
    rows = {key: batch[key][:k] for key in ("rgb_input_map", "mask_input_map", "pose_gt", "idx")}
    rows["dpc"] = {"points": batch["dpc"]["points"][:k]}
    try:
        accs, comps, _, _ = score_batch(recon_model(graph, device), rows, opt, True, TRAIN_METRIC_SEED)
    finally:
        graph.train()
    got = dist.gather_rows({"acc": accs, "comp": comps})
    return {"train/dist_acc": float(got["acc"].mean()), "train/dist_cov": float(got["comp"].mean())}


def train(opt, data, output_path, device=None):
    """Train the shape graph under ``opt`` (e.g. ``config.shape_gen_opt()`` with
    overrides) on ``data``, validated on ``data.val``; with ``data`` None on
    the datasets ``opt.data`` names (:func:`engine_base.load_dataset`).
    Checkpoints and event files go to ``output_path``.

    A fresh run starts from ``weights.init_like_flax(seed=opt.seed)`` with
    the pretrained weights that ``opt`` names staged over it
    (:func:`checkpoint.stage_pretrained`: ``pretrain.depth``, else
    ``arch.depth.pretrained``); ``opt.resume`` then continues from
    ``latest.ckpt``, or ``opt.load`` restores a checkpoint's weights
    (:func:`engine_base.start_run`). The loop and its cadences are
    :func:`engine_base.train_loop`'s over the training set's loader (global
    batch ``opt.batch_size``, each rank its rows); a step is
    :func:`parallel.train.train_step` with the stochastic depth of
    :func:`step_generator` and, at the scalar cadence, the attention
    statistics and :func:`train_metrics`; validation is :func:`validate`,
    which logs ``eval/dist_acc`` and ``eval/dist_cov``, the best CD kept
    (``shape_engine.py:460-549``), and dumps ``vis_{ep}/`` from the first
    ``eval.n_vis`` validation samples (:func:`engine_base.viz_samples`);
    :func:`save_vis` and :func:`visualize_train_batch` run at their cadences.

    Returns :func:`engine_base.train_loop`'s dict.
    """
    dev = resolve_device(device)
    os.makedirs(output_path, exist_ok=True)
    if not opt.get("resume"):
        engine_base.clear_event_files(output_path)
    train_data, val_data = (data, data.val) if data is not None else engine_base.load_dataset(opt)
    seed = opt.get("seed") or 0
    loader = train_data.setup_loader(opt, shuffle=True, drop_last=True, pin_memory=dev.type == "cuda")
    n_batches = engine_base.count_batches(train_data, opt.batch_size)
    graph = ShapeGraph.from_opt(opt, dtype=resolve_compute_dtype(opt, dev))
    graph = init_like_flax(graph, seed).to(dev).train()
    checkpoint.stage_pretrained(graph, opt, "shape")
    optimizer = ptrain.make_optimizer(graph, opt.optim, n_batches, opt.max_epoch)
    start = engine_base.start_run(opt, output_path, graph, optimizer)

    def step(batch, it, with_stats):
        metrics, _ = ptrain.train_step(graph, optimizer, batch, opt, step_generator(seed, it, dev),
                                       with_stats=with_stats)
        return metrics

    viz = engine_base.viz_samples(val_data, opt.eval.get("n_vis"))

    def run_validation(ep):
        res = validate(graph, val_data, opt, output_path, dev, ep, viz)
        acc, comp = float(res["acc"].mean()), float(res["comp"].mean())
        return res["val_metric"], {"eval/dist_acc": acc, "eval/dist_cov": comp}

    return engine_base.train_loop(
        opt, loader, output_path, graph, optimizer, lambda batch: to_device(batch, dev), step, run_validation, "CD",
        start, train_scalars=lambda batch, it: train_metrics(graph, batch, opt, dev),
        visualize=lambda batch, it, tb: visualize_train_batch(graph, batch, opt, tb, it, dev),
        save_vis=lambda it: save_vis(graph, viz, opt, output_path, dev, it),
    )
