"""Training CLI (the shape and depth engines of ``train.py``), in one process or several.

    python -m zeroshape_tpu_torch.train [--yaml=options/shape_gen.yaml | --task=depth] [--data.root=DIR] \\
        [--max_epoch=2] [--optim.lr=1.e-4] [--pretrain.depth=DIR/best.ckpt] [--load=FILE] [--resume] \\
        [--device=cpu] [--output_path=DIR]
    torchrun --nproc_per_node=N -m zeroshape_tpu_torch.train ...     # N ranks (DDP-style data parallel)

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

The data are the datasets ``data.dataset_train`` / ``data.dataset_test``
name (``synthetic``, ``pix3d``, ``ocrtoc``, ``omniobj3d``) under
``data.root``, as ``train.py`` reads them; the recipes' root is the tree
``python -m zeroshape_tpu_torch.generalize_e2e gen`` writes
(``/tmp/gen_data``: 40 analytic objects x 8 views and 8 held-out objects).
Overrides are checked: a key that neither the preset nor the ``--yaml``
file holds raises ``KeyError`` naming it. Rank 0 writes the resolved options
to ``output_path/options.yaml`` before training, printing the key-level diff
against an earlier file there. Under ``torchrun`` each rank joins the
process group first (``parallel.dist.init_distributed_from_env``), trains
on its rows of every global batch of ``batch_size``, and only rank 0
writes. Checkpoints and event files go to ``output_path`` (default
``{output_root}/{group}/{name}``).
"""

from __future__ import annotations

import os
import sys

from zeroshape_tpu_torch import config
from zeroshape_tpu_torch.parallel.dist import init_distributed_from_env, is_main
from zeroshape_tpu_torch.runtime import depth_engine, shape_engine

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


# the port's own CLI keys, which no preset or YAML file holds
CLI_KEYS = ("task", "device", "yaml", "output_path")


def options(argv, safe_check=True):
    """The task's preset with the ``--yaml`` file and the CLI overrides over it.

    With ``safe_check`` (the train CLI, as JAX ``train.py:51``) an override
    that names a key neither the preset nor the file holds raises
    ``KeyError`` (``CLI_KEYS`` pass), and :func:`config.process_options`
    derives the run's name suffix and ``freq.eval``; the evaluate and demo
    CLIs pass ``safe_check=False``, as JAX ``evaluate.py:25`` does.
    ``--output_path`` is kept where given; otherwise it is
    ``{output_root}/{group}/{name}``."""
    cli = config.parse_arguments(argv)
    task = task_of(cli)
    base = config.depth_gen_opt() if task == "depth" else config.shape_gen_opt()
    opt = config.override_options(base, {"group": task, "output_root": "output"})
    if cli.get("yaml"):
        opt = config.override_options(opt, config.load_options(cli.yaml))
    own = {k: cli.pop(k) for k in CLI_KEYS if k in cli}
    opt = config.override_options(opt, cli, safe_check=safe_check)
    opt.update(own)
    opt.task = task
    if safe_check:
        config.process_options(opt)
    if opt.get("image_size"):
        opt.H, opt.W = opt.image_size
    opt.setdefault("output_path", os.path.join(opt.output_root, opt.group, opt.name))
    return opt


def main(argv=None):
    init_distributed_from_env()
    opt = options(sys.argv[1:] if argv is None else argv)
    if is_main():
        config.save_options_file(opt)
    return ENGINES[opt.task].train(opt, None, opt.output_path, device=opt.get("device"))


if __name__ == "__main__":
    main()
