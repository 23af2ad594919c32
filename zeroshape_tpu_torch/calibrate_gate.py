"""Calibrate the accuracy gate's bound over seeds (counterpart of
``scripts/calibrate_gate.py``).

    python -m zeroshape_tpu_torch.calibrate_gate [n_seeds=3] [--device=cpu]

Runs the gate's exact recipe (``config.accuracy_gate_opt()``: 24 epochs
from random weights at 64^2, the narrow decoder, Chamfer-scored) once per
seed 0..n-1, in one process, on the tree
``data.analytic.generate_dataset(n_objects=4, n_views=6, H=64, seed=0,
n_pc_points=2048, n_sdf_points=4096, val_views=1)`` written into a temporary
directory, and prints each seed's best CD and seconds, then the mean, the
standard deviation (``ddof=1``; 0 for one seed) and mean + 3 sigma. A
report only: ``chip_smoke.py``'s gate bound (0.11) is not read from it.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time

import numpy as np

from zeroshape_tpu_torch import config, resolve_device
from zeroshape_tpu_torch.data.analytic import generate_dataset
from zeroshape_tpu_torch.runtime import shape_engine

TREE = dict(n_objects=4, n_views=6, H=64, seed=0, n_pc_points=2048, n_sdf_points=4096, val_views=1)


def run_seed(seed, tmp, data_root, device):
    """The gate recipe from ``seed``; its best validation CD."""
    opt = config.accuracy_gate_opt()
    opt.seed, opt.name = seed, f"accgate_s{seed}"
    opt.data.root, opt.data.num_workers = data_root, 2
    res = shape_engine.train(opt, None, os.path.join(tmp, f"seed{seed}"), device=device)
    if not np.isfinite(res["best_val"]):
        raise FloatingPointError(f"seed {seed}: best CD {res['best_val']}")
    return float(res["best_val"])


def summary(cds):
    """The JAX script's closing lines for the CDs ``cds``."""
    cds = np.asarray(cds, np.float64)
    mu, sd = cds.mean(), cds.std(ddof=1) if len(cds) > 1 else 0.0
    return [f"\nseeds: {[round(c, 4) for c in cds.tolist()]}", f"mean {mu:.4f}, sigma {sd:.4f}",
            f"suggested CD_BOUND = mean + 3*sigma = {mu + 3 * sd:.4f} (random-init floor ~0.155)"]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    n_seeds = int(next((a for a in argv if not a.startswith("--")), 3))
    device = resolve_device(config.parse_arguments([a for a in argv if a.startswith("--")]).get("device"))
    tmp = tempfile.mkdtemp(prefix="gate_cal_")
    try:
        data_root = os.path.join(tmp, "data")
        generate_dataset(data_root, **TREE)
        cds = []
        for seed in range(n_seeds):
            t0 = time.time()
            cds.append(run_seed(seed, tmp, data_root, device))
            print(f"seed {seed}: best CD {cds[-1]:.4f} ({time.time() - t0:.0f} s)", flush=True)
    finally:
        shutil.rmtree(tmp)
    print("\n".join(summary(cds)))
    return cds


if __name__ == "__main__":
    main()
