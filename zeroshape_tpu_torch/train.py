"""Shape training CLI (the shape engine of ``train.py``, one card).

    python -m zeroshape_tpu_torch.train [--yaml=options/shape_gen.yaml] [--max_epoch=2] \\
        [--optim.lr=1.e-4] [--data.analytic.n_objects=4] [--device=cpu] [--output_path=DIR]

The options are ``config.shape_gen_opt()``: the full-width shape model
under the ``options/shape_gen.yaml`` recipe. A ``--yaml`` file (read with
PyYAML, imported for it only) and then the dotted ``--key=value``
overrides go over them. The data is the analytic split that
``scripts/generalize_e2e.py`` writes (``data.analytic``: 40 objects x 8
views at the model's size, seed 0, the last view of each object for
validation), made in memory by ``data.analytic.train_samples``; its
held-out objects are not made here. Checkpoints and event files go to
``output_path`` (default ``{output_root}/{group}/{name}``). Pretrained
weights (``pretrain.depth``, ``arch.depth.pretrained``) are not ported:
set, they raise.
"""

from __future__ import annotations

import os
import sys
import time

from zeroshape_tpu_torch import config
from zeroshape_tpu_torch.data import analytic
from zeroshape_tpu_torch.runtime import shape_engine

ANALYTIC = {"n_objects": 40, "n_views": 8, "seed": 0, "n_pc_points": 10000, "n_sdf_points": 20000, "val_views": 1}


def options(argv):
    """``shape_gen_opt`` with the ``--yaml`` file and the CLI overrides over it."""
    cli = config.parse_arguments(argv)
    opt = config.override_options(config.shape_gen_opt(), {"group": "shape", "output_root": "output",
                                                            "data": {"analytic": ANALYTIC}})
    if cli.get("yaml"):
        opt = config.override_options(opt, config.load_options(cli.yaml))
    opt = config.override_options(opt, cli)
    if opt.get("image_size"):
        opt.H, opt.W = opt.image_size
    if (opt.get("pretrain") or {}).get("depth") or opt.arch.depth.get("pretrained"):
        raise NotImplementedError("pretrained weights (pretrain.depth, arch.depth.pretrained) are not ported")
    opt.setdefault("output_path", os.path.join(opt.output_root, opt.group, opt.name))
    return opt


def main(argv=None):
    opt = options(sys.argv[1:] if argv is None else argv)
    t0 = time.perf_counter()
    a = opt.data.analytic
    data = analytic.train_samples(a.n_objects, a.n_views, opt.H, a.seed, a.n_pc_points, a.n_sdf_points,
                                  a.val_views)
    print(f"analytic data: {len(data)} training views, {len(data.val)} validation views "
          f"({opt.H}^2) made in {time.perf_counter() - t0:.1f} s")
    return shape_engine.train(opt, data, opt.output_path, device=opt.get("device"))


if __name__ == "__main__":
    main()
