"""The flagship forward and the dry run over N ranks (counterpart of
``__graft_entry__.py``).

    python -m zeroshape_tpu_torch.graft_entry dryrun N [--full] [--device=cpu] [--timeout=SECONDS]

:func:`_full_opt` / :func:`_tiny_opt` / :func:`_batch` are the shared
fixtures of both packages' tests and scripts: the same options key for key,
and the same numpy draws in the same order, so a seed gives both packages
bit-equal batches. :func:`entry` is the flagship ``ShapeGraph`` with its
forward and an example batch.

:func:`dryrun_multichip` is one call that starts ``n_devices`` ranks itself
(``torch.multiprocessing`` spawn, a free localhost port, the backend of
``parallel.dist.backend_for``: gloo on the CPU or where ranks share a card,
cards taken round-robin) and has them take one training step of the full
(224^2) or tiny (32^2) graph on their rows of ``_batch(B=n)``, then score
one sample a rank in the JAX dry run's evaluation settings (dense decode,
no ICP, per-sample CDs gathered). It raises if a rank fails or the ranks
outlive ``timeout``; a rank that dies takes the others down with it.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np
import torch

from zeroshape_tpu_torch import config, resolve_device

DRYRUN_TIMEOUT = 1800.0  # seconds the ranks of a dry run may take together


def _full_opt(H=224):
    """The flagship shape model's options (``config.full_opt``)."""
    return config.full_opt(H)


def _tiny_opt(H=32):
    """The tiny decoder of the fast tests (``config.tiny_opt``)."""
    return config.tiny_opt(H)


def _batch(B, H, n_pts, seed=0, device="cpu"):
    """A random batch in the JAX batch layout (NHWC), as fp32 tensors on
    ``device``: ``__graft_entry__._batch``'s numpy draws in its order."""
    rng = np.random.default_rng(seed)
    f = 1.3875 * H
    K = np.array([[f, 0, H / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    pose = np.concatenate([np.eye(3), [[0.0], [0.0], [1.78]]], axis=1).astype(np.float32)
    batch = {
        "rgb_input_map": rng.uniform(0, 1, (B, H, H, 3)).astype(np.float32),
        "mask_input_map": (rng.uniform(size=(B, H, H, 1)) > 0.3).astype(np.float32),
        "depth_input_map": rng.uniform(0.4, 1, (B, H, H, 1)).astype(np.float32),
        "intr": np.tile(K, (B, 1, 1)),
        "pose_gt": np.tile(pose[None], (B, 1, 1)),
        "gt_sample_points": (rng.normal(size=(B, n_pts, 3)) * 0.3).astype(np.float32),
        "gt_sample_sdf": (rng.normal(size=(B, n_pts)) * 0.05).astype(np.float32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def entry(device=None, opt=None):
    """``(forward, (graph, batch))``: the flagship ``ShapeGraph`` (``opt``,
    default :func:`_full_opt`) in eval mode with seeded weights on ``device``
    (None -> cuda), and ``forward(graph, batch)``, which returns
    ``(pred_sample_occ, depth_pred, intr_pred)``, with its example batch."""
    from zeroshape_tpu_torch.models.graph_shape import ShapeGraph
    from zeroshape_tpu_torch.weights import init_like_flax

    dev = resolve_device(device)
    opt = opt or _full_opt()
    graph = init_like_flax(ShapeGraph.from_opt(opt), seed=0).to(dev).eval()
    batch = _batch(B=1, H=opt.H, n_pts=opt.training.n_sdf_points, device=dev)

    def forward(graph, batch):
        with torch.inference_mode():
            out = graph(batch, train=False)
        return out["pred_sample_occ"], out["depth_pred"], out["intr_pred"]

    return forward, (graph, batch)


def eval_options(opt, n_devices, full):
    """``opt`` with the dry run's evaluation section (``__graft_entry__.py:203-215``)."""
    return config.override_options(opt, {"eval": {
        "vox_res": 32 if full else 16, "range": [-1.5, 1.5], "num_points": 1024 if full else 256,
        "f_thresholds": [0.01, 0.05, 0.2], "icp": False, "hier_decode": False, "hier_final": False,
        "batch_size": n_devices,
    }})


def _rank(rank, n_devices, full, device_type, port, threads, out):
    """One rank of :func:`dryrun_multichip`; rank 0 prints and writes ``out/result.pt``."""
    from zeroshape_tpu_torch import bench, recon
    from zeroshape_tpu_torch.metrics import eval3d
    from zeroshape_tpu_torch.models.graph_shape import ShapeGraph
    from zeroshape_tpu_torch.parallel import dist
    from zeroshape_tpu_torch.parallel import train as ptrain
    from zeroshape_tpu_torch.runtime import shape_engine
    from zeroshape_tpu_torch.weights import init_like_flax

    torch.set_num_threads(threads)
    cards = torch.cuda.device_count() if device_type == "cuda" else 0
    if cards:
        torch.cuda.set_device(rank % cards)
    dev = resolve_device(device_type)
    torch.distributed.init_process_group(dist.backend_for(n_devices, cards), init_method=f"tcp://127.0.0.1:{port}",
                                         rank=rank, world_size=n_devices)
    try:
        t0 = time.perf_counter()
        opt = _full_opt() if full else _tiny_opt()
        graph = init_like_flax(ShapeGraph.from_opt(opt), seed=0).to(dev).train()
        optimizer = ptrain.make_optimizer(graph, opt.optim)
        batch = _batch(B=n_devices, H=opt.H, n_pts=16)
        local = dist.local_batch(n_devices)
        rows = {k: v[rank * local: (rank + 1) * local].to(dev) for k, v in batch.items()}
        metrics, _ = ptrain.train_step(graph, optimizer, rows, opt, shape_engine.step_generator(2, 0, dev))
        loss = dist.mean_over_ranks({"loss": float(metrics["loss_all"])})["loss"]
        if not np.isfinite(loss):
            raise FloatingPointError(f"loss_all {loss}")
        arch = "full H=224" if full else "tiny H=32"
        if dist.is_main():
            print(f"dryrun_multichip({n_devices}, {arch}): loss_all={loss:.4f} OK", flush=True)
        step_seconds = time.perf_counter() - t0

        # the inference surface on the same ranks: the dense reconstruction,
        # the GT view transform and the scorer, one sample a rank
        eopt = eval_options(opt, n_devices, full)
        ev = eopt.eval
        model = recon.ReconModel(graph.eval(), None, 1.0, dev).repack()
        gt_pc = (np.random.default_rng(3).normal(size=(n_devices, 1024, 3)) * 0.3).astype(np.float32)
        idx = np.arange(rank * local, (rank + 1) * local)
        bench.reset_counts()
        t0 = time.perf_counter()
        _, _, pred_world, _ = recon.reconstruct_batch(
            model, rows, shape_engine.sample_generators(idx, dev), ev.vox_res, None, ev.num_points,
            tuple(ev.range), hier=False)
        with torch.inference_mode():
            gt_view = eval3d.transform_gt_to_view(torch.from_numpy(gt_pc[idx]).to(dev), rows["pose_gt"], False)
            accs, comps, _, _, _ = shape_engine.score(pred_world, gt_view, tuple(ev.f_thresholds))
        counts = bench.launch_counts()
        got = dist.gather_rows({"acc": accs.float().cpu().numpy(), "comp": comps.float().cpu().numpy(),
                                "launches": np.array([[counts[k] for k in bench.COUNTED]], np.int64)})
        eval_seconds = time.perf_counter() - t0
        accs, comps = got["acc"], got["comp"]
        if accs.shape != (n_devices,) or comps.shape != (n_devices,):
            raise ValueError(f"gathered metrics of shapes {accs.shape}, {comps.shape}, want ({n_devices},)")
        if not (np.isfinite(accs).all() and np.isfinite(comps).all()):
            raise FloatingPointError(f"non-finite metrics: acc {accs}, comp {comps}")
        cds = (accs + comps) / 2
        if dist.is_main():
            print(f"dryrun_multichip({n_devices}, {arch}) eval: per-sample CD [{cds.min():.4f}, {cds.max():.4f}] "
                  f"over {n_devices} sharded samples OK", flush=True)
            launches = dict(zip(bench.COUNTED, got["launches"].sum(axis=0).tolist()))
            torch.save({"loss": loss, "cd": cds.tolist(), "launches": launches, "step_seconds": step_seconds,
                        "eval_seconds": eval_seconds, "backend": torch.distributed.get_backend()},
                       os.path.join(out, "result.pt"))
    finally:
        torch.distributed.destroy_process_group()


def dryrun_multichip(n_devices: int, full: bool = True, device=None, timeout: float = DRYRUN_TIMEOUT,
                     rank_fn=_rank) -> dict:
    """One training step and one evaluation over ``n_devices`` ranks that this
    call starts (``__graft_entry__.dryrun_multichip``); ``device`` None ->
    the card(s), ``"cpu"`` -> CPU processes. ``rank_fn`` is what each rank
    runs (:func:`_rank`'s arguments). Raises if a rank fails or the ranks
    take longer than ``timeout`` seconds.

    Returns rank 0's record: the loss averaged over the ranks, the ``n``
    per-sample CDs, the K1/K2/K3 launches and plain decodes of the ranks'
    evaluation, the seconds of the step and of the evaluation, the backend.
    """
    from torch import multiprocessing as mp

    from zeroshape_tpu_torch.parallel import dist

    dev = resolve_device(device)
    threads = max(1, torch.get_num_threads() // n_devices)
    with tempfile.TemporaryDirectory() as out:
        ctx = mp.spawn(rank_fn, args=(n_devices, full, dev.type, dist.free_port(), threads, out), nprocs=n_devices,
                       join=False)
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(f"the dry run's {n_devices} ranks took longer than {timeout} s")
        return torch.load(os.path.join(out, "result.pt"), weights_only=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] != "dryrun" or len(argv) < 2:
        raise SystemExit("usage: python -m zeroshape_tpu_torch.graft_entry dryrun N [--full] [--device=cpu] "
                         "[--timeout=SECONDS]")
    flags = dict(a[2:].split("=", 1) if "=" in a else (a[2:], True) for a in argv[2:] if a.startswith("--"))
    res = dryrun_multichip(int(argv[1]), full=bool(flags.get("full")), device=flags.get("device"),
                           timeout=float(flags.get("timeout", DRYRUN_TIMEOUT)))
    print(f"dryrun: launches {res['launches']}; step {res['step_seconds']:.2f} s, evaluation "
          f"{res['eval_seconds']:.2f} s ({res['backend']})")


if __name__ == "__main__":
    main()
