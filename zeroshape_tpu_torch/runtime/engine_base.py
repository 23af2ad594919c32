"""What the single-card training loop takes from the JAX ``RunnerBase``
(``zeroshape_tpu/runtime/engine_base.py``): the buffered finite-loss gate,
checkpoints in the reference ``.ckpt`` layout, and the scalar log.

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
