"""What the single-card training loop takes from the JAX ``RunnerBase``
(``zeroshape_tpu/runtime/engine_base.py``): the buffered finite-loss gate,
checkpoints in the reference ``.ckpt`` layout, the scalar log, the start of
a run (resume or ``--load``), and the epoch loop both engines share
(:func:`train_loop`).

Checkpoints are torch pickles of ``{"graph": state_dict, "epoch", "iter",
"best_val", "best_ep", "optim": optimizer state}`` written as
``latest.ckpt``, ``best.ckpt`` (a byte copy) and ``checkpoint/ep{N}.ckpt``
(``checkpoint.py:54-88``), so ``zeroshape_tpu.runtime.checkpoint.
load_torch_checkpoint`` reads them. ``iter`` counts the steps taken: a run
resumed from a checkpoint continues at that step of the saved loader order.
"""

from __future__ import annotations

import os
import shutil
import time

import numpy as np
import torch

from zeroshape_tpu_torch.runtime import checkpoint


class LossGate:
    """The buffered finite-loss gate (``engine_base.py:97-121``).

    Each step's loss stays on the device; :meth:`flush`, called at the
    print / scalar / checkpoint boundaries, brings every buffered loss to the
    host in one transfer, raises if any is not finite, and returns them with
    the host-clock seconds a step since the last flush or :meth:`reset_clock`.
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
        vals = torch.stack(self._buf).float().cpu().numpy()
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
    into place. Returns the path written."""
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
    not ``enabled`` or without TensorBoard (scalars then go to stdout only)."""
    if not enabled:
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        print(f"tensorboard unavailable ({e}); scalar logging to stdout only")
        return None
    return SummaryWriter(log_dir=output_path, flush_secs=10)


def clear_event_files(output_path):
    """Remove TensorBoard event files of an earlier run (``engine_base.py:38-45``)."""
    for name in os.listdir(output_path):
        if "tfevents" in name:
            os.remove(os.path.join(output_path, name))


def count_batches(data, batch_size):
    """Full batches an epoch of ``data`` gives; raises if there are none."""
    n = len(data) // batch_size
    if n == 0:
        raise ValueError(f"{len(data)} training samples fill no batch of {batch_size}")
    return n


def start_run(opt, output_path, graph, optimizer):
    """Where a run starts (``restore_checkpoint``, ``engine_base.py:173-192``):
    ``opt.resume`` restores ``latest.ckpt`` (weights, optimizer, counters);
    otherwise ``opt.load`` restores the weights of a reference ``.ckpt``
    (:func:`checkpoint.load_weights`) and not the optimizer. Returns ``(it,
    best_val, best_ep)``."""
    if opt.get("resume"):
        meta = restore_checkpoint(os.path.join(output_path, "latest.ckpt"), graph, optimizer)
        print(f"resumed at iteration {meta['iter']} (best {meta['best_val']:.4f} @ epoch {meta['best_ep']})")
        return meta["iter"], meta["best_val"], meta["best_ep"]
    if opt.get("load"):
        print(f"loading weights from {opt.load}...")
        checkpoint.load_weights(graph, opt.load)
    return 0, float("inf"), 1


def train_loop(opt, data, output_path, graph, optimizer, batch_fn, step_fn, validate_fn, metric, start):
    """The epochs of a run (``Runner.train`` / ``train_epoch`` /
    ``train_iteration`` of both JAX engines).

    Each epoch walks the loader order of ``data.batch_order``;
    ``batch_fn(indices, ep)`` gives a batch on the device, ``step_fn(batch,
    it, with_stats)`` takes one step and returns its metrics (``loss_all``
    and more, device scalars), ``validate_fn(ep)`` validates and returns
    ``(value, scalars)``, lower values better. The cadences are ``opt.freq``'s:
    losses reach the host and pass the finite gate every ``print`` /
    ``scalar`` / ``ckpt_latest`` steps (and at each epoch's end);
    ``latest.ckpt`` every ``ckpt_latest`` steps; the scalars every ``scalar``
    steps, to stdout and, where ``opt.tb`` is set and TensorBoard is
    installed, to event files; validation before the first step and every
    ``eval`` epochs, the best ``metric`` kept as ``best.ckpt``;
    ``checkpoint/ep{N}.ckpt`` at the end. ``opt.debug`` skips the first
    validation, the scalars and ``latest.ckpt``. ``start`` is
    :func:`start_run`'s.

    Returns a dict: ``graph`` and ``optimizer``, ``losses`` (every step's
    loss), ``val`` (``(epoch, value)`` of each validation), ``val_scalars``
    (``(epoch, scalars)``), ``best_val``, ``best_ep`` and ``it`` (the steps
    taken).
    """
    seed, freq, debug, bs = opt.get("seed") or 0, opt.freq, opt.get("debug"), opt.batch_size
    n_batches = count_batches(data, bs)
    it, best_val, best_ep = start
    tb = None if debug else scalar_writer(output_path, opt.get("tb") is not None)
    gate, losses, vals, val_scalars = LossGate(), [], [], []

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

    print("TRAINING START")
    if it == 0 and not debug:
        run_validation(0)
    ep_start, skip = divmod(it, n_batches)
    ep = ep_start
    for ep in range(ep_start, opt.max_epoch):
        print(f"training epoch {ep + 1}")
        gate.reset_clock()
        for idx in data.batch_order(ep, bs, seed)[skip:]:
            scalar_it = it % freq.scalar == 0 and not debug
            metrics = step_fn(batch_fn(idx, ep), it, scalar_it)
            gate.note(metrics["loss_all"])
            boundary = it % freq.print == 0 or it % freq.scalar == 0 or it % freq.ckpt_latest == 0
            s_it = flush(it) if boundary else None
            if it % freq.ckpt_latest == 0 and not debug:
                save_checkpoint(output_path, graph, optimizer, ep, it + 1, best_val, best_ep, latest=True)
            if scalar_it:
                scalars = {f"train/{k}": float(v) for k, v in metrics.items()}
                print(f"scalars @ iter {it}: " + "  ".join(f"{k} {v:.6f}" for k, v in scalars.items()))
                for k, v in scalars.items() if tb is not None else ():
                    tb.add_scalar(k, v, it)
            if it % freq.print == 0:
                timing = "" if s_it is None else f"  s_it {s_it:.4f}"
                print(f"Train Iter {it}/{n_batches * opt.max_epoch}: lr {optimizer.lr():.6f}  "
                      f"loss {losses[-1]:.4f}{timing}")
            if boundary:
                gate.reset_clock()
            it += 1
        skip = 0
        flush(it)
        if (ep + 1) % freq.eval == 0:
            print(f"validating epoch {ep + 1}")
            value = run_validation(ep + 1)
            if value < best_val:
                best_val, best_ep = value, ep + 1
                save_checkpoint(output_path, graph, optimizer, ep, it, best_val, best_ep, latest=True, best=True)
                print("Saving the current model as the best...")
    flush(it)
    save_checkpoint(output_path, graph, optimizer, ep, it, best_val, best_ep)
    if tb is not None:
        tb.flush()
    print("TRAINING DONE")
    print("Best %s: %.4f @ epoch %d" % (metric, best_val, best_ep))
    return {"graph": graph, "optimizer": optimizer, "losses": losses, "val": vals, "val_scalars": val_scalars,
            "best_val": best_val, "best_ep": best_ep, "it": it}
