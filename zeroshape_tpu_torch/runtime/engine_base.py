"""What the training loop takes from the JAX ``RunnerBase``
(``zeroshape_tpu/runtime/engine_base.py``): the datasets by name
(:func:`load_dataset`), the buffered finite-loss gate, checkpoints in the
reference ``.ckpt`` layout, the scalar log, the start of a run (resume or
``--load``), the profiler schedule, and the epoch loop both engines share
(:func:`train_loop`). Under several ranks (``parallel.dist``) only rank 0
writes checkpoints, event files and the log.

Checkpoints are torch pickles of ``{"graph": state_dict, "epoch", "iter",
"best_val", "best_ep", "optim": optimizer state}`` written as
``latest.ckpt``, ``best.ckpt`` (a byte copy) and ``checkpoint/ep{N}.ckpt``
(``checkpoint.py:54-88``), so ``zeroshape_tpu.runtime.checkpoint.
load_torch_checkpoint`` reads them. ``iter`` counts the steps taken: a run
resumed from a checkpoint continues at that step of the saved loader order.
"""

from __future__ import annotations

import importlib
import os
import shutil
import time

import numpy as np
import torch

from zeroshape_tpu_torch.data.base import default_collate
from zeroshape_tpu_torch.parallel import dist
from zeroshape_tpu_torch.runtime import checkpoint
from zeroshape_tpu_torch.runtime.logging import log_print

DATASETS = {
    "synthetic": "zeroshape_tpu_torch.data.synthetic",
    "pix3d": "zeroshape_tpu_torch.data.pix3d",
    "ocrtoc": "zeroshape_tpu_torch.data.ocrtoc",
    "omniobj3d": "zeroshape_tpu_torch.data.omniobj3d",
}


def load_dataset(opt, eval_split="test", load_train=True):
    """``(training set or None, test set)``: the ``Dataset`` classes that
    ``data.dataset_train`` and ``data.dataset_test`` name, over ``data.root``
    (``engine_base.py:25-73``)."""
    train = None
    if load_train:
        log_print("loading training data...")
        train = importlib.import_module(DATASETS[opt.data.dataset_train]).Dataset(opt, split="train")
    log_print("loading test data...")
    test = importlib.import_module(DATASETS[opt.data.dataset_test]).Dataset(opt, split=eval_split)
    return train, test


def viz_samples(data, n_vis):
    """The samples the training-time dumps draw: ``n_vis`` of ``data`` at a
    stride of ``len // n_vis``, each a batch of one (``_collect_viz_data``,
    ``engine_base.py:75-86``); none when ``n_vis`` is 0 or unset."""
    n = len(data) if n_vis else 0
    return [default_collate([data[i]]) for i in range(0, n, max(n // n_vis, 1))][:n_vis] if n else []



class LossGate:
    """The buffered finite-loss gate (``engine_base.py:97-121``).

    Each step's loss stays on the device; :meth:`flush`, called at the
    print / scalar / checkpoint boundaries, averages the buffered losses over
    the ranks in one all-reduce, brings them to the host in one transfer,
    raises if any is not finite, and returns them with the host-clock
    seconds a step since the last flush or :meth:`reset_clock`.
    """

    def __init__(self):
        self._buf = []
        self._t0 = None

    def note(self, loss):
        self._buf.append(loss.detach())

    def reset_clock(self):
        """Leave what follows (checkpoints, logging, validation) out of the next window."""
        self._t0 = time.perf_counter()

    def flush(self, it):
        """``(losses, seconds a step or None)``; ``([], None)`` when nothing is buffered."""
        if not self._buf:
            return [], None
        n = len(self._buf)
        vals = (dist.all_reduce_(torch.stack(self._buf).float()) / dist.world()).cpu().numpy()
        self._buf.clear()
        if not np.isfinite(vals).all():
            raise FloatingPointError(f"loss is not finite within {n} iters of iter {it}")
        now = time.perf_counter()
        s_it = None if self._t0 is None else (now - self._t0) / n
        self._t0 = now
        return vals.tolist(), s_it


def save_checkpoint(output_path, graph, optimizer, ep, it, best_val, best_ep, latest=False, best=False):
    """Write ``latest.ckpt`` (``latest``) or ``checkpoint/ep{ep}.ckpt``, and with
    ``best`` copy it to ``best.ckpt``; each through a ``.tmp`` file renamed
    into place. Returns the path written; None on ranks other than 0, which
    write nothing."""
    if not dist.is_main():
        return None
    payload = {
        "graph": graph.state_dict(),
        "epoch": int(ep),
        "iter": int(it),
        "best_val": float(best_val),
        "best_ep": int(best_ep),
        "optim": optimizer.state_dict(),
    }
    path = os.path.join(os.path.abspath(output_path), "latest.ckpt" if latest else f"checkpoint/ep{ep}.ckpt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)  # a crash leaves the old file or the new one
    if best:
        best_path = os.path.join(os.path.abspath(output_path), "best.ckpt")
        shutil.copyfile(path, best_path + ".tmp")
        os.replace(best_path + ".tmp", best_path)
    return path


def restore_checkpoint(path, graph, optimizer=None):
    """Load a checkpoint this package wrote into ``graph`` (and ``optimizer``);
    returns its ``epoch``, ``iter``, ``best_val`` and ``best_ep``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    graph.load_state_dict(ckpt["graph"])
    if optimizer is not None:
        optimizer.load_state_dict(ckpt["optim"])
    return {k: ckpt[k] for k in ("epoch", "iter", "best_val", "best_ep")}


def scalar_writer(output_path, enabled):
    """A TensorBoard writer into ``output_path``, imported here only; None when
    not ``enabled``, on ranks other than 0, or without TensorBoard (scalars
    then go to stdout only)."""
    if not enabled or not dist.is_main():
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        print(f"tensorboard unavailable ({e}); scalar logging to stdout only")
        return None
    return SummaryWriter(log_dir=output_path, flush_secs=10)


def clear_event_files(output_path):
    """Remove TensorBoard event files of an earlier run (``engine_base.py:38-45``); rank 0 only."""
    for name in os.listdir(output_path) if dist.is_main() else ():
        if "tfevents" in name:
            os.remove(os.path.join(output_path, name))


def count_batches(data, batch_size):
    """Full global batches an epoch of ``data`` gives; raises if there are
    none, or if the batch does not divide over the ranks."""
    dist.local_batch(batch_size)
    n = len(data) // batch_size
    if n == 0:
        raise ValueError(f"{len(data)} training samples fill no batch of {batch_size}")
    return n


class ProfilerSchedule:
    """The ``--debug --profile`` schedule (``shape_engine.py:494-530``): the
    reference's ``torch.profiler.schedule(wait=3, warmup=3, active=5,
    repeat=2)``, with :meth:`step` called after each training step. Each
    active window's trace goes to ``debug/profiler_log/window_{i}``; the run
    exits once the second is written. :meth:`close` writes an open window,
    once, for a run shorter than the schedule."""

    WAIT, WARMUP, ACTIVE, REPEAT = 3, 3, 5, 2

    def __init__(self):
        acts = [torch.profiler.ProfilerActivity.CPU] + (
            [torch.profiler.ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        schedule = torch.profiler.schedule(wait=self.WAIT, warmup=self.WARMUP, active=self.ACTIVE, repeat=self.REPEAT)
        self.windows = 0
        self.prof = torch.profiler.profile(activities=acts, schedule=schedule, on_trace_ready=self._write)
        self.prof.start()

    def _write(self, prof):
        torch.profiler.tensorboard_trace_handler(os.path.join("debug", "profiler_log", f"window_{self.windows}"))(prof)
        log_print(f"profiler window {self.windows} captured")
        self.windows += 1

    def step(self):
        self.prof.step()
        if self.windows == self.REPEAT:
            self.close()
            log_print("profiler traces written to debug/profiler_log; exiting")
            raise SystemExit(0)

    def close(self):
        if self.prof is not None:
            self.prof.stop()
            self.prof = None


def start_run(opt, output_path, graph, optimizer):
    """Where a run starts (``restore_checkpoint``, ``engine_base.py:173-192``):
    ``opt.resume`` restores ``latest.ckpt`` (weights, optimizer, counters);
    otherwise ``opt.load`` restores the weights of a reference ``.ckpt``
    (:func:`checkpoint.load_weights`) and not the optimizer. Returns ``(it,
    best_val, best_ep)``."""
    if opt.get("resume"):
        meta = restore_checkpoint(os.path.join(output_path, "latest.ckpt"), graph, optimizer)
        log_print(f"resumed at iteration {meta['iter']} (best {meta['best_val']:.4f} @ epoch {meta['best_ep']})")
        return meta["iter"], meta["best_val"], meta["best_ep"]
    if opt.get("load"):
        log_print(f"loading weights from {opt.load}...")
        checkpoint.load_weights(graph, opt.load)
    return 0, float("inf"), 1


def train_loop(opt, loader, output_path, graph, optimizer, batch_fn, step_fn, validate_fn, metric, start,
               train_scalars=None, visualize=None, save_vis=None):
    """The epochs of a run (``Runner.train`` / ``train_epoch`` /
    ``train_iteration`` of both JAX engines).

    Each epoch walks ``loader`` (a ``data.base.DataLoader`` of global batches,
    each rank given its rows) after ``set_epoch``; a resumed run starts
    inside its epoch without loading the batches it took. ``batch_fn(batch)``
    moves a host batch to the device, ``step_fn(batch, it, with_stats)``
    takes one step and returns its metrics (``loss_all`` and more, device
    scalars), ``validate_fn(ep)`` validates and returns ``(value, scalars)``,
    lower values better, and ``train_scalars(batch, it)``, where given, adds
    scalars of the host batch at the scalar cadence; ``visualize(batch, it,
    tb)`` draws TensorBoard grids at ``freq.vis`` where a writer takes images, and
    ``save_vis(it)`` dumps at ``freq.save_vis``. The cadences are
    ``opt.freq``'s: losses, averaged over the ranks, reach the host and pass
    the finite gate every ``print`` / ``scalar`` / ``ckpt_latest`` steps (and
    at each epoch's end); ``latest.ckpt`` every ``ckpt_latest`` steps; the
    scalars (averaged over the ranks) every ``scalar`` steps, to stdout and,
    where ``opt.tb`` is set and TensorBoard is installed, to event files;
    validation before the first step and every ``eval`` epochs, the best
    ``metric`` kept as ``best.ckpt``; ``checkpoint/ep{N}.ckpt`` at the end.
    ``opt.debug`` skips the first validation, the scalars, the visual dumps
    and ``latest.ckpt``; with ``opt.profile`` too it runs
    :class:`ProfilerSchedule`. ``start`` is :func:`start_run`'s.

    Returns a dict: ``graph`` and ``optimizer``, ``losses`` (every step's
    loss), ``val`` (``(epoch, value)`` of each validation), ``val_scalars``
    (``(epoch, scalars)``), ``train_scalars`` (``(it, scalars)``),
    ``best_val``, ``best_ep``, ``it`` (the steps taken) and ``loader_wait``
    (seconds the steps waited for a batch).
    """
    freq, debug = opt.freq, opt.get("debug")
    n_batches = count_batches(loader.dataset, opt.batch_size)
    it, best_val, best_ep = start
    tb = None if debug else scalar_writer(output_path, opt.get("tb") is not None)
    gate, losses, vals, val_scalars, step_scalars = LossGate(), [], [], [], []
    profiler = ProfilerSchedule() if debug and opt.get("profile") else None

    def flush(at):
        got, s_it = gate.flush(at)
        losses.extend(got)
        return s_it

    def run_validation(ep):
        value, scalars = validate_fn(ep)
        vals.append((ep, value))
        val_scalars.append((ep, scalars))
        for k, v in scalars.items() if tb is not None else ():
            tb.add_scalar(k, v, ep)
        return value

    log_print("TRAINING START")
    if it == 0 and not debug:
        run_validation(0)
    ep_start, skip = divmod(it, n_batches)
    ep = ep_start
    try:
        for ep in range(ep_start, opt.max_epoch):
            loader.set_epoch(ep)
            log_print(f"training epoch {ep + 1}")
            gate.reset_clock()
            for batch in loader.epoch(skip):
                scalar_it = it % freq.scalar == 0 and not debug
                metrics = step_fn(batch_fn(batch), it, scalar_it)
                gate.note(metrics["loss_all"])
                boundary = it % freq.print == 0 or it % freq.scalar == 0 or it % freq.ckpt_latest == 0
                s_it = flush(it) if boundary else None
                if it % freq.ckpt_latest == 0 and not debug:
                    save_checkpoint(output_path, graph, optimizer, ep, it + 1, best_val, best_ep, latest=True)
                if scalar_it:
                    scalars = dist.mean_over_ranks({f"train/{k}": float(v) for k, v in metrics.items()})
                    scalars.update(train_scalars(batch, it) if train_scalars else {})
                    step_scalars.append((it, scalars))
                    log_print(f"scalars @ iter {it}: " + "  ".join(f"{k} {v:.6f}" for k, v in scalars.items()))
                    for k, v in scalars.items() if tb is not None else ():
                        tb.add_scalar(k, v, it)
                if it % freq.print == 0:
                    timing = "" if s_it is None else f"  s_it {s_it:.4f}"
                    log_print(f"Train Iter {it}/{n_batches * opt.max_epoch}: lr {optimizer.lr():.6f}  "
                              f"loss {losses[-1]:.4f}{timing}")
                if not debug:
                    if visualize is not None and hasattr(tb, "add_image") and freq.get("vis") and it % freq.vis == 0:
                        visualize(batch, it, tb)
                    # every freq.save_vis steps, the period stretched 10x per 10k steps (shape_engine.py:561-568)
                    if save_vis is not None and freq.get("save_vis") and it % (
                            freq.save_vis * (it // 10000 * 10 + 1)) == 0:
                        save_vis(it)
                if boundary:
                    gate.reset_clock()
                it += 1
                if profiler is not None:
                    profiler.step()
            skip = 0
            flush(it)
            if (ep + 1) % freq.eval == 0:
                log_print(f"validating epoch {ep + 1}")
                value = run_validation(ep + 1)
                if value < best_val:
                    best_val, best_ep = value, ep + 1
                    save_checkpoint(output_path, graph, optimizer, ep, it, best_val, best_ep, latest=True, best=True)
                    log_print("Saving the current model as the best...")
    finally:
        if profiler is not None:
            profiler.close()  # a run shorter than the schedule writes its open window
    flush(it)
    save_checkpoint(output_path, graph, optimizer, ep, it, best_val, best_ep)
    if tb is not None:
        tb.flush()
    log_print("TRAINING DONE")
    log_print("Best %s: %.4f @ epoch %d" % (metric, best_val, best_ep))
    return {"graph": graph, "optimizer": optimizer, "losses": losses, "val": vals, "val_scalars": val_scalars,
            "train_scalars": step_scalars, "best_val": best_val, "best_ep": best_ep, "it": it,
            "loader_wait": loader.wait}
