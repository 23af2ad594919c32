"""Where one full-width training step spends its time on the card.

    python -m zeroshape_tpu_torch.profile_train [--task=shape|depth] [--steps=5] [--batch_size=8] \
        [--trace=FILE.pt.trace.json] [--arch.depth.encoder=transformer --arch.rgb.encoder=resnet ...]

Builds the ``shape_gen`` model (or with ``--task=depth`` the ``depth_gen``
depth graph; full width, bf16 autocast, seeded weights; any other dotted
option goes over the preset, as on the train CLI) and one batch of
analytic training views at 224^2, takes two warm-up steps,
then traces ``steps`` steps with ``torch.profiler``. Prints, per step: the
host-clock median (each step ending in a sync), the device time under each
span of ``parallel.train.train_step`` (train_forward, train_loss,
train_backward, optimizer_step), the device's busy and idle share, and the
device kernels that take the most time. ``--trace`` also writes the traced
steps as a Chrome trace (``python -m zeroshape_tpu_torch.analyze_trace
FILE`` reads it).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from zeroshape_tpu_torch import config, resolve_device
from zeroshape_tpu_torch.data import analytic
from zeroshape_tpu_torch.models import graph_depth, resolve_compute_dtype
from zeroshape_tpu_torch.models.graph_depth import DepthGraph
from zeroshape_tpu_torch.models.graph_shape import ShapeGraph
from zeroshape_tpu_torch.parallel import train as ptrain
from zeroshape_tpu_torch.runtime import depth_engine, shape_engine
from zeroshape_tpu_torch.weights import init_like_flax

SPANS = ("train_forward", "train_loss", "train_backward", "optimizer_step")


def build(device=None, task="shape", overrides=None):
    """(opt, graph, optimizer) of a full-width ``shape_gen`` step, or with
    ``task="depth"`` a ``depth_gen`` step, on ``device`` (None -> cuda):
    seeded weights, bf16 autocast on the card; ``overrides`` (nested
    options) go over the preset."""
    dev = resolve_device(device)
    depth = task == "depth"
    opt = config.override_options(config.depth_gen_opt() if depth else config.shape_gen_opt(), overrides or {})
    graph = (DepthGraph if depth else ShapeGraph).from_opt(opt, dtype=resolve_compute_dtype(opt, dev))
    graph = init_like_flax(graph, 0).to(dev).train()
    return opt, graph, ptrain.make_optimizer(graph, opt.optim)


def make_batch(opt, graph, batch_size):
    """A batch of ``batch_size`` analytic training views at ``opt.H`` on the
    graph's device (four objects, as many views as it takes)."""
    n_views = -(-batch_size // 4) + 1  # four objects, one validation view each
    data = analytic.train_samples(n_objects=4, n_views=n_views, H=opt.H, seed=0)
    keys = depth_engine.MODEL_KEYS if isinstance(graph, DepthGraph) else shape_engine.MODEL_KEYS
    dev = next(graph.parameters()).device
    return shape_engine.to_device(data.batch(np.arange(batch_size), 0, 0, opt.training.n_sdf_points), dev, keys)


def setup(batch_size=8, device=None, task="shape", overrides=None):
    """(opt, graph, optimizer, batch): :func:`build` and :func:`make_batch`."""
    opt, graph, optimizer = build(device, task, overrides)
    return opt, graph, optimizer, make_batch(opt, graph, batch_size)


def step(opt, graph, optimizer, batch, it):
    """One train step (``parallel.train.train_step``) of iteration ``it``:
    the depth graph's loss, or the shape graph's stochastic depth drawn for
    ``it`` as the engine draws it. Returns the metrics (device scalars)."""
    if isinstance(graph, DepthGraph):
        kw = dict(loss_fn=graph_depth.compute_loss, metrics_fn=None)
    else:
        kw = dict(generator=shape_engine.step_generator(0, it, batch["intr"].device))
    return ptrain.train_step(graph, optimizer, batch, opt, **kw)[0]


def timed_steps(opt, graph, optimizer, batch, steps, first_it=0):
    """Host-clock seconds of ``steps`` train steps, each ending in a sync."""
    seconds = []
    for it in range(first_it, first_it + steps):
        t0 = time.perf_counter()
        step(opt, graph, optimizer, batch, it)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return seconds


def main(argv=None):
    args = config.parse_arguments(sys.argv[1:] if argv is None else argv)
    steps, batch_size, task = args.pop("steps", 5), args.pop("batch_size", 8), args.pop("task", "shape")
    trace = args.pop("trace", None)
    opt, graph, optimizer, batch = setup(batch_size, task=task, overrides=args)
    timed_steps(opt, graph, optimizer, batch, 2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = timed_steps(opt, graph, optimizer, batch, steps, first_it=2)
    if trace:
        prof.export_chrome_trace(trace)
    events = prof.key_averages()
    print(f"profile: {steps} {task} train steps at batch {batch_size}, host-clock median {np.median(wall) * 1e3:.2f} ms "
          f"(traced); {torch.cuda.get_device_name(0)}")
    cuda = torch.autograd.DeviceType.CUDA
    # a span appears twice: on the host (its kernels' summed time) and on the
    # device timeline (first kernel start to last kernel end)
    spans = {(e.key, e.device_type == cuda): e for e in events if e.key in SPANS}
    for name in SPANS:
        host, dev = spans.get((name, False)), spans.get((name, True))
        if host is None:
            continue
        span = f"{dev.device_time_total / steps / 1e3:8.3f}" if dev is not None else "     n/a"
        print(f"  span {name:15s} kernels {host.device_time_total / steps / 1e3:8.3f} ms, "
              f"device span {span} ms, host {host.cpu_time_total / steps / 1e3:8.3f} ms")
    kernels = [e for e in events if e.device_type == cuda and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in kernels) / steps / 1e3
    traced_ms = sum(wall) / steps * 1e3
    n_kernels = sum(e.count for e in kernels) / steps
    print(f"  device busy {busy_ms:.2f} ms of {traced_ms:.2f} ms per step "
          f"(idle share {1 - busy_ms / traced_ms:.3f}), {n_kernels:.0f} device kernels")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  kernel {e.self_device_time_total / steps / 1e3:8.3f} ms x{e.count // steps:5d}  {e.key[:90]}")


if __name__ == "__main__":
    main()
