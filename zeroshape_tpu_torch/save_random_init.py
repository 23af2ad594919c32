"""Save a random-init checkpoint (counterpart of ``scripts/save_random_init.py``).

    python -m zeroshape_tpu_torch.save_random_init [--task=shape | --yaml=options/shape_gen.yaml] \\
        --name=shape_gen_rand [--seed=0] [--output_root=output] [--device=cpu]

Builds the task's graph as a fresh training run does (``weights.
init_like_flax(seed)`` with the pretrained weights the options name staged
over it) and its optimizer, and writes them through ``engine_base.
save_checkpoint(best=True)`` to ``<output_path>/best.ckpt`` (and the
engine's ``checkpoint/ep0.ckpt``), whose path it prints. The options are the
train CLI's, unchecked. The untrained floor is then scored through the
production CLI, which reads every key of the file:

    python -m zeroshape_tpu_torch.evaluate --task=shape --name=shape_gen_rand \\
        --ckpt=output/shape/shape_gen_rand/best.ckpt --eval.dump_mesh_viz!
"""

from __future__ import annotations

import os
import sys

from zeroshape_tpu_torch import resolve_device
from zeroshape_tpu_torch.models import resolve_compute_dtype
from zeroshape_tpu_torch.models.graph_depth import DepthGraph
from zeroshape_tpu_torch.models.graph_shape import ShapeGraph
from zeroshape_tpu_torch.parallel import train as ptrain
from zeroshape_tpu_torch.runtime import checkpoint, engine_base
from zeroshape_tpu_torch.train import options
from zeroshape_tpu_torch.weights import init_like_flax


def main(argv=None):
    opt = options(sys.argv[1:] if argv is None else argv, safe_check=False)
    dev = resolve_device(opt.get("device"))
    cls = DepthGraph if opt.task == "depth" else ShapeGraph
    graph = init_like_flax(cls.from_opt(opt, dtype=resolve_compute_dtype(opt, dev)), opt.get("seed") or 0).to(dev)
    checkpoint.stage_pretrained(graph, opt, opt.task)
    optimizer = ptrain.make_optimizer(graph, opt.optim)
    engine_base.save_checkpoint(opt.output_path, graph, optimizer, ep=0, it=0, best_val=float("inf"), best_ep=0,
                                best=True)
    path = os.path.join(opt.output_path, "best.ckpt")
    print(path)
    return path


if __name__ == "__main__":
    main()
