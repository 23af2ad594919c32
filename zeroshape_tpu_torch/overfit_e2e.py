"""Write the overfit tree (counterpart of ``scripts/overfit_e2e.py``).

    python -m zeroshape_tpu_torch.overfit_e2e gen [root] [--H=224] [--n_objects=5] ...

5 analytic objects x 8 views at 224^2 (the last view of each for
validation), seed 0, 10,000 GT surface points and 20,000 SDF samples an
object, into ``root`` (default ``/tmp/overfit_data``), in the layout
``data.synthetic`` reads (``data.analytic.generate_dataset``, whose
arguments the ``--key=value`` options override, as in ``generalize_e2e``).
``options/shape_overfit.yaml`` trains on this tree and
``bench._real_sample`` reads its first view before ``/tmp/gen_data``'s:

    python -m zeroshape_tpu_torch.train --yaml=options/shape_overfit.yaml
    python -m zeroshape_tpu_torch.evaluate --yaml=options/shape_overfit.yaml --resume

The ground truth is exact (analytic SDFs), so the scores measure the whole
stack on trained weights.
"""

from __future__ import annotations

import sys
import time

from zeroshape_tpu_torch.config import parse_arguments
from zeroshape_tpu_torch.data.analytic import generate_dataset

TREE = dict(n_objects=5, n_views=8, H=224, seed=0, n_pc_points=10000, n_sdf_points=20000, val_views=1)
ROOT = "/tmp/overfit_data"


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if (argv[0] if argv else "gen") != "gen":
        raise SystemExit(__doc__)
    root = argv[1] if len(argv) > 1 and not argv[1].startswith("--") else ROOT
    tree = dict(TREE, **parse_arguments([a for a in argv[1:] if a.startswith("--")]))
    t0 = time.perf_counter()
    base = generate_dataset(root, **tree)
    print(f"wrote {base} in {time.perf_counter() - t0:.1f} s")
    return base


if __name__ == "__main__":
    main()
