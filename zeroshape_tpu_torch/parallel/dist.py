"""Several processes, one rank each (counterpart of ``zeroshape_tpu/parallel/mesh.py``).

The JAX package runs one SPMD program over a device mesh; the port runs one
process a rank under ``torch.distributed``, launched by ``torchrun``:

* :func:`init_distributed_from_env` joins the process group that
  ``torchrun``'s variables describe (a no-op without them);
* the backend follows a rule: ``nccl`` where each rank has a card of its
  own, ``gloo`` on the CPU or where ranks share a card (NCCL refuses two
  ranks on one device);
* a global batch divides evenly over the ranks, or :func:`local_batch`
  raises (``mesh.py:70-80``);
* :func:`gather_rows` all-gathers small per-sample rows in rank order
  (``replicate_to_host``, ``mesh.py:156-173``), :func:`all_reduce_` sums a
  tensor over the ranks and :func:`average_gradients` averages gradients
  in buckets;
* only rank 0 writes files (:func:`is_main`).

Without a process group every function is the single-process identity.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

BUCKET_BYTES = 32 * 2**20


def initialized():
    return dist.is_available() and dist.is_initialized()


def rank():
    return dist.get_rank() if initialized() else 0


def world():
    return dist.get_world_size() if initialized() else 1


def is_main():
    """Rank 0, the only writer of checkpoints, result files and ``data_list.txt``."""
    return rank() == 0


def barrier():
    """Wait for every rank (a no-op in one process)."""
    if initialized():
        dist.barrier()


def local_valid_rows(n_valid, n_local):
    """How many of this rank's ``n_local`` rows of a global batch fall inside
    its first ``n_valid`` rows (the rest pad an uneven tail)."""
    return max(0, min(n_local, n_valid - rank() * n_local)) if initialized() else min(n_local, n_valid)


def backend_for(local_world, cuda_devices):
    """``nccl`` when each of the node's ``local_world`` ranks has a card of its
    own, else ``gloo``."""
    return "nccl" if cuda_devices > 0 and cuda_devices >= local_world else "gloo"


def init_distributed_from_env():
    """Join the process group of ``torchrun``'s ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``; a no-op without them.

    The rank's card is ``cuda:{LOCAL_RANK}`` (``LOCAL_RANK`` modulo the cards
    where ranks share them), made current, so ``cuda`` names it. Returns
    whether a process group was joined.
    """
    env = os.environ
    if initialized() or not all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")):
        return False
    n_rank, n_world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local_rank = int(env.get("LOCAL_RANK", n_rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", n_world))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend = backend_for(local_world, cards)
    if cards:
        torch.cuda.set_device(local_rank % cards)
    dist.init_process_group(backend, init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                            rank=n_rank, world_size=n_world)
    print(f"rank {n_rank} of {n_world}: backend {backend}"
          + (f", cuda:{local_rank % cards}" if cards else ", CPU"), flush=True)
    return True


def local_batch(global_batch):
    """This rank's rows of a global batch; raises unless it divides evenly."""
    n = world()
    if global_batch % n:
        raise ValueError(f"global batch_size {global_batch} must divide evenly over {n} processes")
    return global_batch // n


def _comm_device(t=None):
    """Where the backend reduces: the host for gloo (a CUDA tensor goes
    through the CPU there), the rank's card for nccl."""
    if dist.get_backend() == "gloo":
        return torch.device("cpu")
    return t.device if t is not None and t.is_cuda else torch.device("cuda", torch.cuda.current_device())


def all_reduce_(t, op=None):
    """Sum ``t`` over the ranks in place (``op``, a ``ReduceOp``, otherwise)."""
    if not initialized():
        return t
    op = dist.ReduceOp.SUM if op is None else op
    dev = _comm_device(t)
    if dev == t.device:
        dist.all_reduce(t, op=op)
    else:
        host = t.to(dev)
        dist.all_reduce(host, op=op)
        t.copy_(host)
    return t


def mean_over_ranks(values):
    """``{name: float}`` averaged over the ranks (one all-reduce)."""
    if not initialized() or not values:
        return dict(values)
    keys = list(values)  # every rank builds the dict in the same order
    t = all_reduce_(torch.tensor([float(values[k]) for k in keys], dtype=torch.float64))
    return {k: float(v) / world() for k, v in zip(keys, t.tolist())}


def gather_rows(rows):
    """``{name: numpy [n, ...]}`` of this rank -> the ranks' rows concatenated
    in rank order, on every rank. Every rank holds the same ``n``."""
    if not initialized():
        return {k: np.asarray(v) for k, v in rows.items()}
    dev, out = _comm_device(), {}
    for k in sorted(rows):
        t = torch.as_tensor(np.ascontiguousarray(rows[k])).to(dev)
        parts = [torch.empty_like(t) for _ in range(world())]
        dist.all_gather(parts, t)
        out[k] = torch.cat(parts).cpu().numpy()
    return out


def average_gradients(grads):
    """Average the tensors ``grads`` over the ranks in place, a bucket of up
    to :data:`BUCKET_BYTES` at a time, each bucket one flat all-reduce."""
    n = world()
    if n == 1 or not grads:
        return
    bucket, size = [], 0
    for g in grads + [None]:
        if g is not None and (not bucket or (g.dtype == bucket[0].dtype and size + g.numel() * g.element_size()
                                              <= BUCKET_BYTES)):
            bucket.append(g)
            size += g.numel() * g.element_size()
            continue
        if bucket:
            flat = torch.cat([b.reshape(-1) for b in bucket])
            all_reduce_(flat).div_(n)
            for b, part in zip(bucket, flat.split([b.numel() for b in bucket])):
                b.copy_(part.view_as(b))
        bucket, size = ([g], g.numel() * g.element_size()) if g is not None else ([], 0)

