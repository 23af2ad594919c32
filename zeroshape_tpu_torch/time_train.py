"""Training-time measurements on the card, and the depth head's probe
(counterparts of ``scripts/bench_train_step.py``, ``time_train.py``,
``diag_train_windows.py``, ``time_train_parts.py``, part 1 of ``time_r2.py``,
``bench_loader.py`` and ``bench_midas.py``).

    python -m zeroshape_tpu_torch.time_train batch [B ...] [--reps=10] [--warmup=3] [--task=shape,depth]
    python -m zeroshape_tpu_torch.time_train windows [--windows=4] [--K=10] [--batch_size=28] [--task=shape]
    python -m zeroshape_tpu_torch.time_train parts [--batch_size=28] [--reps=5] [--K=10] [--task=shape]
    python -m zeroshape_tpu_torch.time_train loader [--data.root=DIR] [--workers=6] [--batch_size=28] \\
        [--epochs=3] [--step_ms=MS]
    python -m zeroshape_tpu_torch.time_train midas [B ...] [--reps=7]
    python -m zeroshape_tpu_torch.time_train depth [--repeats=8] [--steps=300] [--deterministic] \\
        [--data.root=DIR] [--seed=0]

Every subcommand takes ``--device=cpu`` (tiny runs on the CPU) and dotted
options over the task's preset (``config.shape_gen_opt`` /
``depth_gen_opt``, as the train CLI), and prints one JSON line last, with
the card's name and power limit:

* ``batch``: ms/step and images/s of ``parallel.train.train_step`` at full
  width, bf16, for each batch size (default 8 16 28 44) and task: the
  steps pipelined with one sync for ``reps`` steps (as ``engine_base.
  train_loop`` syncs at its cadences), and the median of ``reps`` steps that
  each end in a sync; the peak memory. A size that runs out of memory is
  reported so.
* ``windows``: ``windows`` windows of ``K`` pipelined steps, each timed on its
  own (its enqueue time and its time to the sync of its stacked losses):
  warm-up against steady state.
* ``parts``: each part in its own synchronized window, the median of
  ``reps``: forward + loss (no gradient), forward + loss + backward, the
  full step; ``K`` steps with a sync each against ``K`` with one sync; and
  the full step with the DPT's resizes as ``F.interpolate``
  (``ops/image.resize_bilinear``) against ``ops/image.
  resize_bilinear_separable`` (patched into ``models/dpt`` in this process
  only), in turns.
* ``loader``: the full-sample rate of ``data.base.DataLoader`` over the
  ``synthetic`` tree at ``data.root`` (``generalize_e2e gen``) for
  ``epochs`` epochs, the last one's; the decode rate of the tree's PNGs by
  zsdl (where it is built) and by the port's numpy decoder; the gaps
  between batches while a consumer holds each batch for ``step_ms`` (by
  default the median of 3 measured ``shape_gen`` steps at this batch size).
* ``midas``: ``losses.midas_loss`` forward + backward at ``[B, 1, 224,
  224]`` with the port's sort median (``losses._masked_median``) against
  a 32-step bisection over the same order keys (:func:`bisection_median`,
  the JAX formulation, ``zeroshape_tpu/losses.py:65-110``), the same
  inputs; the two must agree bit for bit.
* ``depth``: the probe of the depth recipe's first steps (``depth_gen`` on
  ``data.root``'s tree): ``repeats`` runs of its first ``steps`` steps from
  the same initial weights over the same batches (the engine's loader
  order, held on the card). A line a step: the losses, the global gradient
  norm, the head's bias, the share of masked pixels whose head output
  before its ReLU is <= 0 (``dead_share``) and the share where it is above
  1 (``clamp_share``, the clamp's flat side). A run is dead when, over its
  last 50 steps, ``loss_depth`` stays at or above 1.0 (the loss of a
  constant map) and the head passes no gradient: the two shares sum above
  0.99, or the global gradient norm stays below 1e-3 (a map flattened onto
  the head's bias). Runs were seen to die each of the three ways.
  ``--deterministic`` sets ``torch.backends.cudnn.deterministic`` and
  ``torch.use_deterministic_algorithms(True)`` (with a cuBLAS workspace
  that allows it) and resizes the DPT's maps with the separable resize,
  since bilinear ``F.interpolate`` has no deterministic backward on CUDA:
  its runs must then be bit-identical.
"""

from __future__ import annotations

import contextlib
import glob
import os
import sys
import time

import numpy as np
import torch

from zeroshape_tpu_torch import config, losses, profile_train, resolve_device
from zeroshape_tpu_torch.recon import sync
from zeroshape_tpu_torch.timing import emit, host_ms, median

TOOL = "time_train"
DEAD_SHARE, DEAD_LOSS, DEAD_GRAD, DEAD_WINDOW = 0.99, 1.0, 1e-3, 50


def _peak_gib(dev):
    return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0


def _pipelined_ms(opt, graph, optimizer, batch, n, first_it=0):
    """Milliseconds a step over ``n`` steps enqueued back to back and one
    sync of their stacked losses at the end (the engine's cadence)."""
    t0 = time.perf_counter()
    found = [profile_train.step(opt, graph, optimizer, batch, it)["loss_all"] for it in range(first_it, first_it + n)]
    torch.stack(found).cpu()
    return (time.perf_counter() - t0) * 1e3 / n


def batch_sweep(sizes, reps=10, warmup=3, tasks=("shape", "depth"), device=None, overrides=None):
    """Rows ``{task, batch, ms_pipelined, ms_synced, img_s, peak_gib}`` (or
    ``{task, batch, failed}`` for a size that does not fit)."""
    rows = []
    for task in tasks:
        opt, graph, optimizer = profile_train.build(device, task, overrides)
        dev = next(graph.parameters()).device
        for B in sizes:
            batch = None
            try:
                batch = profile_train.make_batch(opt, graph, B)
                if dev.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(dev)
                _pipelined_ms(opt, graph, optimizer, batch, warmup)
                ms = _pipelined_ms(opt, graph, optimizer, batch, reps, warmup)
                synced = host_ms(lambda: profile_train.step(opt, graph, optimizer, batch, 0), dev, reps, 0)
                row = {"task": task, "batch": B, "ms_pipelined": ms, "ms_synced": median(synced),
                       "img_s": B / ms * 1e3, "peak_gib": _peak_gib(dev)}
                print(f"{task} B={B:3d}: {ms:8.2f} ms/step pipelined ({row['img_s']:.1f} img/s), "
                      f"{row['ms_synced']:8.2f} ms synced each step, peak {row['peak_gib']:.2f} GiB", flush=True)
            except torch.cuda.OutOfMemoryError as e:
                row = {"task": task, "batch": B, "failed": f"out of memory: {str(e)[:80]}"}
                print(f"{task} B={B:3d}: FAILED ({row['failed']})", flush=True)
            rows.append(row)
            del batch
            optimizer.adamw.zero_grad(set_to_none=True)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        del graph, optimizer
    return rows


def windows(K=10, W=4, batch_size=28, task="shape", device=None, overrides=None):
    """Rows ``{window, ms_enqueue, ms_synced, img_s}`` of ``W`` windows of ``K`` steps."""
    opt, graph, optimizer, batch = profile_train.setup(batch_size, device, task, overrides)
    dev = batch["intr"].device
    t0 = time.perf_counter()
    profile_train.step(opt, graph, optimizer, batch, 0)
    sync(dev)
    print(f"first step {time.perf_counter() - t0:.2f} s", flush=True)
    rows, it = [], 1
    for w in range(W):
        t0 = time.perf_counter()
        found = []
        for _ in range(K):
            found.append(profile_train.step(opt, graph, optimizer, batch, it)["loss_all"])
            it += 1
        enq = time.perf_counter() - t0
        torch.stack(found).cpu()
        tot = time.perf_counter() - t0
        rows.append({"window": w, "ms_enqueue": enq / K * 1e3, "ms_synced": tot / K * 1e3,
                     "img_s": batch_size * K / tot})
        print(f"window {w}: enqueue {rows[-1]['ms_enqueue']:8.2f} ms/step, synced {rows[-1]['ms_synced']:8.2f} "
              f"ms/step ({rows[-1]['img_s']:.1f} img/s)", flush=True)
    return rows


def _separable_nchw(x, out_hw, align_corners=False):
    """``ops/image.resize_bilinear_separable`` on an NCHW map of any dtype."""
    from zeroshape_tpu_torch.ops.image import resize_bilinear_separable

    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    N, C, h, w = x.shape
    y = resize_bilinear_separable(x.reshape(N * C, h, w).float(), tuple(out_hw), align_corners)
    return y.reshape(N, C, *out_hw).to(x.dtype)


@contextlib.contextmanager
def separable_resize():
    """The DPT's resizes (the fusion upsample and the pos-embed resize) as
    the separable matrix resize, in this process, for the block's length."""
    from zeroshape_tpu_torch.models import dpt

    saved = dpt.resize_bilinear, dpt.upsample2x
    dpt.resize_bilinear = _separable_nchw
    dpt.upsample2x = lambda x, align_corners=True: _separable_nchw(x, (2 * x.shape[-2], 2 * x.shape[-1]),
                                                                   align_corners)
    try:
        yield
    finally:
        dpt.resize_bilinear, dpt.upsample2x = saved


def parts(batch_size=28, reps=5, K=10, task="shape", device=None, overrides=None):
    """The step's parts, each a median of ``reps`` synchronized windows (ms)."""
    from zeroshape_tpu_torch.losses import summarize_loss
    from zeroshape_tpu_torch.models import graph_depth, graph_shape
    from zeroshape_tpu_torch.runtime import shape_engine

    opt, graph, optimizer, batch = profile_train.setup(batch_size, device, task, overrides)
    dev = batch["intr"].device
    depth = task == "depth"
    loss_fn = graph_depth.compute_loss if depth else graph_shape.compute_loss

    def forward_loss():
        kw = {} if depth else {"generator": shape_engine.step_generator(0, 0, dev)}
        return summarize_loss(loss_fn(opt, batch, graph(batch, train=True, **kw), training=True),
                              dict(opt.loss_weight))

    def forward_backward():
        forward_loss().backward()
        optimizer.adamw.zero_grad(set_to_none=True)

    def no_grad_forward():
        with torch.no_grad():
            forward_loss()

    def full():
        profile_train.step(opt, graph, optimizer, batch, 0)

    def k_synced():
        for it in range(K):
            float(profile_train.step(opt, graph, optimizer, batch, it)["loss_all"])

    out = {"batch": batch_size, "task": task}
    for name, fn in (("fwd_loss_ms", no_grad_forward), ("fwd_bwd_ms", forward_backward), ("step_ms", full)):
        out[name] = median(host_ms(fn, dev, reps, 1))
        print(f"{name[:-3]}: {out[name]:.2f} ms", flush=True)
    out["sync_every_step_ms"] = median(host_ms(k_synced, dev, reps, 0)) / K
    out["sync_once_ms"] = median([_pipelined_ms(opt, graph, optimizer, batch, K) for _ in range(reps)])
    print(f"{K} steps: {out['sync_every_step_ms']:.2f} ms/step with a sync each, {out['sync_once_ms']:.2f} with one",
          flush=True)
    # the resize A/B in turns: interpolate, separable, separable, interpolate, ...
    ab = {"interpolate": [], "separable": []}
    for r in range(max(reps // 2, 1)):
        for name in ("interpolate", "separable", "separable", "interpolate"):
            with separable_resize() if name == "separable" else contextlib.nullcontext():
                ab[name] += host_ms(full, dev, 1, 0)
    out["step_interpolate_ms"], out["step_separable_ms"] = median(ab["interpolate"]), median(ab["separable"])
    print(f"step with the DPT's resizes by F.interpolate {out['step_interpolate_ms']:.2f} ms, separable "
          f"{out['step_separable_ms']:.2f} ms", flush=True)
    return out


def _png_files(root, n):
    files = sorted(glob.glob(os.path.join(root, "**", "images_processed", "**", "*.png"), recursive=True))
    if not files:
        raise FileNotFoundError(f"no images_processed/*.png under {root}; run python -m "
                                f"zeroshape_tpu_torch.generalize_e2e gen {root}")
    return (files * -(-n // len(files)))[:n]


def loader(root, workers=6, batch_size=28, epochs=3, step_ms=None, device=None, overrides=None):
    """The loader's rates and the batch gaps under a consumer (see the module doc)."""
    from zeroshape_tpu_torch.data import native
    from zeroshape_tpu_torch.runtime import engine_base

    dev = resolve_device(device)
    opt = config.override_options(config.shape_gen_opt(), dict(overrides or {}, batch_size=batch_size, data={
        "root": root, "num_workers": workers, "dataset_train": "synthetic", "dataset_test": "synthetic"}))
    if step_ms is None:
        o, graph, optimizer, batch = profile_train.setup(batch_size, dev, "shape", overrides)
        step_ms = median(host_ms(lambda: profile_train.step(o, graph, optimizer, batch, 0), dev, 3, 2))
        del graph, optimizer, batch
    train, _ = engine_base.load_dataset(opt)
    it = train.setup_loader(opt, shuffle=True, drop_last=True)
    if len(it) < 1:
        raise ValueError(f"{len(train)} samples make no batch of {batch_size}")
    out = {"samples": len(train), "workers": workers, "batch": batch_size, "native_zsdl": native.available()}
    for ep in range(epochs):
        it.set_epoch(ep)
        t0, count = time.perf_counter(), 0
        for b in it:
            count += b["rgb_input_map"].shape[0]
        rate = count / (time.perf_counter() - t0)
        print(f"epoch {ep}: {count} samples, {rate:.1f} img/s", flush=True)
    out["img_s"] = rate

    files = _png_files(root, 64)
    lib = native.library()
    decoders = {"numpy_png": native.decode_png}
    if lib is not None:
        decoders["zsdl"] = lambda f: native._zsdl_decode(lib, f, *native.image_info(f)[1:3], 3)
    for name, decode in decoders.items():
        t0 = time.perf_counter()
        for f in files:
            decode(f)
        out[f"decode_{name}_img_s"] = len(files) / (time.perf_counter() - t0)
        print(f"decode {name}: {out[f'decode_{name}_img_s']:.1f} img/s", flush=True)
    out["decode_zsdl_img_s"] = out.get("decode_zsdl_img_s")  # None where zsdl is not built

    it.set_epoch(epochs)
    gaps, prev = [], time.perf_counter()
    for _ in it:
        now = time.perf_counter()
        gaps.append(now - prev)
        time.sleep(step_ms / 1e3)  # the consumer's step
        prev = time.perf_counter()
    gaps = np.asarray(gaps[1:]) * 1e3  # the first includes the epoch's start
    out.update(step_ms=step_ms, gap_median_ms=float(np.median(gaps)) if gaps.size else 0.0,
               gap_p95_ms=float(np.percentile(gaps, 95)) if gaps.size else 0.0, gaps=int(gaps.size),
               step_img_s=batch_size / step_ms * 1e3)
    print(f"gaps under a {step_ms:.1f} ms consumer: median {out['gap_median_ms']:.2f} ms, p95 "
          f"{out['gap_p95_ms']:.2f} ms over {gaps.size} batches; loader {out['img_s']:.1f} img/s against "
          f"the step's {out['step_img_s']:.1f}", flush=True)
    return out


def _kth_key_by_bisection(key, k):
    """The k-th smallest of each row's order keys by a 32-step bisection
    over the key space: each step counts the keys at or below the middle
    of the interval that holds the answer."""
    lo = torch.zeros_like(k)
    hi = torch.full_like(k, 0xFFFFFFFF)
    for _ in range(32):
        mid = lo + (hi - lo) // 2
        left = (key <= mid[:, None]).sum(dim=-1) >= k + 1
        lo, hi = torch.where(left, lo, mid + 1), torch.where(left, mid, hi)
    return hi


def bisection_median(x_flat, mask_flat):
    """``losses._masked_median`` with the k-th smallest key found by a 32-step
    bisection (the JAX formulation, losses.py:65-110) instead of a sort. The
    value and its gradient are the sort's, bit for bit."""
    return losses.masked_median_by(x_flat, mask_flat, _kth_key_by_bisection)


@contextlib.contextmanager
def median_by(fn):
    """``losses._masked_median`` as ``fn`` in this process, for the block's length."""
    saved = losses._masked_median
    losses._masked_median = fn
    try:
        yield
    finally:
        losses._masked_median = saved


def midas_inputs(B, H=224, seed=0, device="cpu"):
    """``bench_midas.py``'s inputs: a box mask, GT depth in [0.4, 1.2] over it,
    the prediction the GT plus N(0, 0.05), clipped at 0."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((B, 1, H, H), np.float32)
    mask[:, :, 40 * H // 224:190 * H // 224, 50 * H // 224:200 * H // 224] = 1.0
    gt = (rng.uniform(0.4, 1.2, mask.shape) * mask).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, 0.05, gt.shape), 0, None).astype(np.float32)
    return [torch.tensor(a, device=device) for a in (pred, gt, mask)]


def midas(sizes=(8, 44), reps=7, device=None, H=224):
    """Rows ``{batch, sort_ms, bisection_ms, ratio, value, equal}``: the loss's
    forward + backward with each median, and whether value and gradient agree
    bit for bit."""
    dev = resolve_device(device)
    rows = []
    for B in sizes:
        pred, gt, mask = midas_inputs(B, H, device=dev)

        def value_and_grad():
            p = pred.clone().requires_grad_(True)
            v = losses.midas_loss(p, gt, mask, alpha=0.1)
            v.backward()
            return v.detach(), p.grad

        got = {}
        for name, fn in (("sort", losses._masked_median), ("bisection", bisection_median)):
            with median_by(fn):
                got[name] = value_and_grad()
                got[f"{name}_ms"] = median(host_ms(value_and_grad, dev, reps, 1))
        equal = bool(torch.equal(got["sort"][0], got["bisection"][0]) and torch.equal(got["sort"][1],
                                                                                      got["bisection"][1]))
        rows.append({"batch": B, "sort_ms": got["sort_ms"], "bisection_ms": got["bisection_ms"],
                     "ratio": got["bisection_ms"] / got["sort_ms"], "value": float(got["sort"][0]), "equal": equal})
        print(f"B={B}: midas fwd+bwd sort {got['sort_ms']:.2f} ms, bisection {got['bisection_ms']:.2f} ms "
              f"({rows[-1]['ratio']:.2f}x); value {rows[-1]['value']:.6f}; bit-equal {equal}", flush=True)
    return rows


def _deterministic():
    """Deterministic algorithms for the rest of the process (see the module doc)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)


def probe_batches(opt, n, dev):
    """The first ``n`` batches of the depth engine's loader (its epochs'
    orders, as ``engine_base.train_loop`` walks them), on ``dev``."""
    from zeroshape_tpu_torch.runtime import depth_engine, engine_base

    train, _ = engine_base.load_dataset(opt)
    it = train.setup_loader(opt, shuffle=True, drop_last=True)
    if len(it) < 1:
        raise ValueError(f"{len(train)} training samples make no batch of {opt.batch_size}")
    out, ep = [], 0
    while len(out) < n:
        it.set_epoch(ep)
        for b in it:
            out.append(depth_engine.to_device(b, dev, depth_engine.MODEL_KEYS))
            if len(out) == n:
                break
        ep += 1
    return out


def probe_run(opt, graph, start, batches, label=""):
    """One run of the probe from the weights ``start``; returns its per-step
    rows ``{loss_all, loss_depth, loss_intr, grad_norm, bias, dead_share,
    clamp_share}``."""
    from zeroshape_tpu_torch.models import graph_depth
    from zeroshape_tpu_torch.parallel import train as ptrain

    graph.load_state_dict(start)
    graph.train()
    optimizer = ptrain.make_optimizer(graph, opt.optim)
    head = graph.dpt_depth.scratch.output_conv[4]
    seen = {}
    hook = head.register_forward_hook(lambda m, a, out: seen.__setitem__("pre_relu", out.detach()))
    step, norms = optimizer.step, []

    def step_with_norm():  # the global norm of the gradients AdamW is handed
        grads = [p.grad for p in optimizer.params() if p.grad is not None]
        norms.append(torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])))
        return step()

    optimizer.step = step_with_norm
    rows = []
    try:
        for it, batch in enumerate(batches):
            metrics, _ = ptrain.train_step(graph, optimizer, batch, opt, loss_fn=graph_depth.compute_loss,
                                           metrics_fn=None)
            mask = batch["mask_input_map"].permute(0, 3, 1, 2) > 0.5
            n = mask.sum().clamp(min=1)
            low, high = ((seen["pre_relu"] <= 0) & mask).sum() / n, ((seen["pre_relu"] > 1) & mask).sum() / n
            rows.append(torch.stack([metrics["loss_all"], metrics["loss_depth"], metrics["loss_intr"], norms[-1],
                                     head.bias.detach()[0].float(), low.float(), high.float()]))
    finally:
        hook.remove()
    table = torch.stack(rows).cpu().numpy()  # one sync a run
    keys = ("loss_all", "loss_depth", "loss_intr", "grad_norm", "bias", "dead_share", "clamp_share")
    for it, r in enumerate(table):
        print(f"{label}step {it}: " + "  ".join(f"{k} {v:.6g}" for k, v in zip(keys, r)), flush=True)
    return {k: table[:, i] for i, k in enumerate(keys)}


def is_dead(run, window=DEAD_WINDOW):
    """Dead: over the last ``window`` steps ``loss_depth`` >= 1.0 throughout,
    and either the head's output is <= 0 or above 1 (no gradient through its
    ReLU and clamp) on more than 0.99 of the masked pixels, or the global
    gradient norm is below 1e-3 (a flat map)."""
    flat = run["dead_share"][-window:] + run["clamp_share"][-window:]
    silent = (flat > DEAD_SHARE).all() or (run["grad_norm"][-window:] < DEAD_GRAD).all()
    return bool(silent and (run["loss_depth"][-window:] >= DEAD_LOSS).all())


def depth_probe(repeats=8, steps=300, deterministic=False, device=None, overrides=None):
    """The probe (see the module doc); returns its JSON fields."""
    from zeroshape_tpu_torch.models import resolve_compute_dtype
    from zeroshape_tpu_torch.models.graph_depth import DepthGraph
    from zeroshape_tpu_torch.weights import init_like_flax

    dev = resolve_device(device)
    if deterministic:
        _deterministic()
    opt = config.override_options(config.depth_gen_opt(), overrides or {})
    if not os.path.isdir(opt.data.root):
        raise FileNotFoundError(f"no tree at {opt.data.root}; run python -m zeroshape_tpu_torch.generalize_e2e gen "
                                f"{opt.data.root}")
    t0 = time.perf_counter()
    batches = probe_batches(opt, steps, dev)
    graph = init_like_flax(DepthGraph.from_opt(opt, dtype=resolve_compute_dtype(opt, dev)), opt.seed or 0).to(dev)
    start = {k: v.clone() for k, v in graph.state_dict().items()}
    print(f"probe: {steps} batches of {opt.batch_size} from {opt.data.root} and the graph in "
          f"{time.perf_counter() - t0:.1f} s; deterministic {deterministic}", flush=True)
    runs, seconds = [], []
    with separable_resize() if deterministic else contextlib.nullcontext():
        for r in range(repeats):
            t0 = time.perf_counter()
            runs.append(probe_run(opt, graph, start, batches, label=f"run {r} "))
            seconds.append(time.perf_counter() - t0)
            print(f"run {r}: dead {is_dead(runs[-1])}; loss_depth {runs[-1]['loss_depth'][-1]:.4f}, bias "
                  f"{runs[-1]['bias'][-1]:.6f}, shares <= 0 {runs[-1]['dead_share'][-1]:.4f} and > 1 "
                  f"{runs[-1]['clamp_share'][-1]:.4f} at the last step; {seconds[-1]:.1f} s", flush=True)
    identical = all(np.array_equal(r["loss_all"], runs[0]["loss_all"]) for r in runs[1:])
    dead = [is_dead(r) for r in runs]
    summary = [{"dead": d, "loss_depth_last": float(r["loss_depth"][-1]), "bias_last": float(r["bias"][-1]),
                "bias_min": float(r["bias"].min()), "dead_share_last": float(r["dead_share"][-1]),
                "clamp_share_last": float(r["clamp_share"][-1]), "loss_depth_min": float(r["loss_depth"].min()),
                "grad_norm_last": float(r["grad_norm"][-1])} for d, r in zip(dead, runs)]
    print(f"probe: {sum(dead)} dead of {repeats} runs of {steps} steps (deterministic {deterministic}); runs "
          f"bit-identical: {identical}", flush=True)
    return {"repeats": repeats, "steps": steps, "deterministic": deterministic, "seed": opt.seed or 0,
            "dead": sum(dead), "identical": identical, "s_per_step": median(seconds) / steps, "runs": summary}


def _pop(args, key, default, cast=None):
    v = args.pop(key, default)
    return cast(v) if cast and v is not None else v


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in ("batch", "windows", "parts", "loader", "midas", "depth"):
        raise SystemExit(__doc__)
    sub, rest = argv[0], argv[1:]
    sizes = [int(a) for a in rest if not a.startswith("--")]
    args = config.parse_arguments([a for a in rest if a.startswith("--")])
    dev = resolve_device(args.pop("device", None))
    if sub == "batch":
        tasks = str(_pop(args, "task", "shape,depth")).split(",")
        reps, warmup = _pop(args, "reps", 10, int), _pop(args, "warmup", 3, int)
        rows = batch_sweep(sizes or [8, 16, 28, 44], reps, warmup, tasks, dev, args)
        emit(TOOL, sub, dev, reps=reps, rows=rows)
    elif sub == "windows":
        K, W = _pop(args, "K", 10, int), _pop(args, "windows", 4, int)
        B, task = _pop(args, "batch_size", 28, int), _pop(args, "task", "shape")
        emit(TOOL, sub, dev, K=K, batch=B, task=task, rows=windows(K, W, B, task, dev, args))
    elif sub == "parts":
        B, reps, K = _pop(args, "batch_size", 28, int), _pop(args, "reps", 5, int), _pop(args, "K", 10, int)
        emit(TOOL, sub, dev, reps=reps, K=K, **parts(B, reps, K, _pop(args, "task", "shape"), dev, args))
    elif sub == "loader":
        root = args.get("data", {}).get("root") or "/tmp/gen_data"
        args.get("data", {}).pop("root", None)
        out = loader(root, _pop(args, "workers", 6, int), _pop(args, "batch_size", 28, int),
                     _pop(args, "epochs", 3, int), _pop(args, "step_ms", None, float), dev, args)
        emit(TOOL, sub, dev, **out)
    elif sub == "midas":
        reps = _pop(args, "reps", 7, int)
        emit(TOOL, sub, dev, reps=reps, rows=midas(sizes or [8, 44], reps, dev, _pop(args, "H", 224, int)))
    else:
        repeats, steps = _pop(args, "repeats", 8, int), _pop(args, "steps", 300, int)
        deterministic = bool(args.pop("deterministic", False))
        emit(TOOL, sub, dev, **depth_probe(repeats, steps, deterministic, dev, args))


if __name__ == "__main__":
    main()
