"""The brute-force search over ``rot_batch`` and prune settings
(counterpart of ``scripts/time_bf.py``).

    python -m zeroshape_tpu_torch.time_bf [--device=cpu] [--n=10000]

Two seeded blobby clouds of ``n`` points (an anisotropic Gaussian each, so
the best rotation is not trivial) go through ``eval3d.brute_force_search``
(6,912 rotations) in the JAX script's five ``(rot_batch, prune)`` variants
and the exhaustive search. Each is timed as the median of 5 calls after a
warm-up, every call closed by ``torch.cuda.synchronize()`` on the host
clock; each line says ``SAME`` or ``DIFF`` against the first variant's best
CD, as the JAX script's do. It exits non-zero unless the two invariants of
the search hold (within 1e-6): variants that differ only in ``rot_batch``
find the same best CD, and no pruned variant finds a lower CD than the
exhaustive search. A coarser prune may find a higher one: it keeps fewer
rotations, or ranks them on fewer points, and on these clouds many
rotations lie within 1e-4 of the best. On the card the pruned variants rank
rotations with K3 and rescore the survivors with K2; the exhaustive search
runs K2 alone.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from zeroshape_tpu_torch import recon, resolve_device
from zeroshape_tpu_torch.config import parse_arguments
from zeroshape_tpu_torch.metrics import eval3d

N = 10000
VARIANTS = ((48, (1024, 128)), (128, (1024, 128)), (128, (512, 128)), (128, (1024, 64)), (256, (1024, 128)),
            (48, None))
TOL = 1e-6


def clouds(n=N, seed=0):
    """The two clouds of the JAX script: numpy ``pred [n, 3]``, ``gt [n, 3]``."""
    rng = np.random.default_rng(seed)
    pred = rng.normal(size=(n, 3)).astype(np.float32)
    pred[:, 0] *= 2.0
    gt = rng.normal(size=(n, 3)).astype(np.float32)
    gt[:, 1] *= 2.0
    return pred, gt


def sweep(pred, gt, variants=VARIANTS, reps=5, **search):
    """``[(rot_batch, prune, median seconds, cd)]`` for each variant; one
    line each, with ``SAME`` or ``DIFF`` against the first variant's CD."""
    rows, ref = [], None
    for rot_batch, prune in variants:
        def call():
            out = eval3d.brute_force_search(pred, gt, prune=prune, rot_batch=rot_batch, **search)
            recon.sync(pred.device)
            return out

        call()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = call()
            times.append(time.perf_counter() - t0)
        cd = float((out["acc"] + out["comp"]) / 2.0)
        ref = cd if ref is None else ref
        same = "SAME" if abs(cd - ref) < TOL else f"DIFF({cd:.6f} vs {ref:.6f})"
        t = float(np.median(times))
        print(f"rot_batch={rot_batch} prune={prune}: {t * 1e3:.1f} ms  cd={cd:.6f} {same}", flush=True)
        rows.append((rot_batch, prune, t, cd))
    return rows


def invariants(rows):
    """Whether variants that differ only in ``rot_batch`` agree, and whether no
    pruned variant beats the exhaustive one (``prune`` None), within :data:`TOL`."""
    by_prune = {}
    for _, prune, _, cd in rows:
        by_prune.setdefault(prune, []).append(cd)
    same_prune = all(max(cds) - min(cds) < TOL for cds in by_prune.values())
    exhaustive = min(by_prune.get(None, [float("-inf")]))
    return same_prune, all(cd >= exhaustive - TOL for prune, cds in by_prune.items() if prune for cd in cds)


def main(argv=None):
    cli = parse_arguments(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(cli.get("device"))
    pred, gt = (torch.as_tensor(x, device=dev) for x in clouds(int(cli.get("n") or N)))
    with torch.inference_mode():
        rows = sweep(pred, gt)
    same_prune, not_below = invariants(rows)
    exhaustive = next(r[3] for r in rows if r[1] is None)
    print(f"rot_batch changes nothing: {same_prune}; no prune beats the exhaustive search ({exhaustive:.6f}): "
          f"{not_below}; gaps " + ", ".join(f"{r[1]}: {r[3] - exhaustive:+.2e}" for r in rows if r[1]))
    if not (same_prune and not_below):
        raise SystemExit("the brute-force search's invariants do not hold")
    return rows


if __name__ == "__main__":
    main()
