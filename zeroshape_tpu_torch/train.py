"""Training CLI (the shape and depth engines of ``train.py``, one card).

    python -m zeroshape_tpu_torch.train [--yaml=options/shape_gen.yaml | --task=depth] [--max_epoch=2] \\
        [--optim.lr=1.e-4] [--data.analytic.n_objects=4] [--pretrain.depth=DIR/best.ckpt] [--load=FILE] \\
        [--device=cpu] [--output_path=DIR]

The engine follows the JAX rule (``train.py:55``): the first ``_`` token of
the ``--yaml`` file's name, ``depth`` or ``shape`` (``shape`` without a
file). ``--task=depth|shape`` names it without a file, for machines without
PyYAML. The base options are ``config.depth_gen_opt()`` for the depth engine
and ``config.shape_gen_opt()`` for the shape engine: the full-width models
under the analytic two-stage recipe (``options/depth_gen.yaml``,
``options/shape_gen.yaml``). The ``--yaml`` file (read with PyYAML,
imported for it only) and then the dotted ``--key=value`` overrides go over
them. A shape run stages ``pretrain.depth`` (a depth run's ``best.ckpt``)
or ``arch.depth.pretrained`` into its fresh graph; ``--load`` restores a
checkpoint's weights, ``--resume`` the run in ``output_path``.

The data is the analytic split that ``scripts/generalize_e2e.py`` writes
(``data.analytic``: 40 objects x 8 views at the model's size, seed 0, the
last view of each object for validation), made in memory by
``data.analytic.train_samples``; its held-out objects are not made here.
Checkpoints and event files go to ``output_path`` (default
``{output_root}/{group}/{name}``).
"""

from __future__ import annotations

import os
import sys
import time

from zeroshape_tpu_torch import config
from zeroshape_tpu_torch.data import analytic
from zeroshape_tpu_torch.runtime import depth_engine, shape_engine

ANALYTIC = {"n_objects": 40, "n_views": 8, "seed": 0, "n_pc_points": 10000, "n_sdf_points": 20000, "val_views": 1}
ENGINES = {"depth": depth_engine, "shape": shape_engine}


def task_of(cli):
    """The engine's name: ``--task``, else the ``--yaml`` file name's first
    ``_`` token, else ``shape``."""
    if cli.get("task"):
        task = cli.task
    elif cli.get("yaml"):
        task = os.path.basename(cli.yaml).split(".")[0].split("_")[0]
    else:
        task = "shape"
    if task not in ENGINES:
        raise ValueError(f"no {task!r} engine: the task is one of {sorted(ENGINES)}")
    return task


def options(argv):
    """The task's preset with the ``--yaml`` file and the CLI overrides over it."""
    cli = config.parse_arguments(argv)
    task = task_of(cli)
    base = config.depth_gen_opt() if task == "depth" else config.shape_gen_opt()
    opt = config.override_options(base, {"group": task, "output_root": "output", "data": {"analytic": ANALYTIC}})
    if cli.get("yaml"):
        opt = config.override_options(opt, config.load_options(cli.yaml))
    opt = config.override_options(opt, cli)
    opt.task = task
    if opt.get("image_size"):
        opt.H, opt.W = opt.image_size
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
    return ENGINES[opt.task].train(opt, data, opt.output_path, device=opt.get("device"))


if __name__ == "__main__":
    main()
