"""Write the held-out-object analytic tree (counterpart of ``scripts/generalize_e2e.py``).

    python -m zeroshape_tpu_torch.generalize_e2e gen [root] [--H=224] [--n_objects=40] [--holdout_objects=8] ...

40 analytic objects x 8 views at 224^2 (the last view of each for
validation) and 8 held-out objects (categories ``ho0``..``ho7``, every view
in validation), seed 0, 10,000 GT surface points and 20,000 SDF samples an
object, in the layout ``data.synthetic`` reads (``data.analytic.
generate_dataset``, whose arguments the ``--key=value`` options override:
a tiny CPU run reads a tree at its own image size). Then the two-stage
recipe and its scores:

    python -m zeroshape_tpu_torch.train --task=depth                       # stage 1: depth + intrinsics
    python -m zeroshape_tpu_torch.train --task=shape --name=shape_gen_staged \\
        --pretrain.depth=output/depth/depth_gen/best.ckpt                   # stage 2: shape, staged
    python -m zeroshape_tpu_torch.evaluate --task=shape --name=shape_gen_staged --resume

``cd_cat.txt`` separates the seen (``prim``) from the unseen (``ho*``) objects.
"""

from __future__ import annotations

import sys
import time

from zeroshape_tpu_torch.config import parse_arguments
from zeroshape_tpu_torch.data.analytic import generate_dataset

TREE = dict(n_objects=40, n_views=8, H=224, seed=0, n_pc_points=10000, n_sdf_points=20000, val_views=1,
            holdout_objects=8)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if (argv[0] if argv else "gen") != "gen":
        raise SystemExit(__doc__)
    root = argv[1] if len(argv) > 1 and not argv[1].startswith("--") else "/tmp/gen_data"
    tree = dict(TREE, **parse_arguments([a for a in argv[1:] if a.startswith("--")]))
    t0 = time.perf_counter()
    base = generate_dataset(root, **tree)
    print(f"wrote {base} in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
