"""Evaluation CLI (counterpart of ``evaluate.py:16-55``), in one process or several.

    python -m zeroshape_tpu_torch.evaluate [--yaml=options/shape_gen.yaml | --task=shape] \\
        [--data.dataset_test=pix3d] [--data.root=DIR] [--ckpt=FILE | --resume] [--eval.brute_force] \\
        [--eval.vox_res=128] [--device=cpu] [--output_path=DIR]
    torchrun --nproc_per_node=N -m zeroshape_tpu_torch.evaluate ...     # N ranks

The options and the engine are the train CLI's, unchecked
(``train.options``: the ``--yaml`` file name's first ``_`` token or
``--task``, over the ``shape_gen`` / ``depth_gen`` presets), with
``eval.n_vis = 1`` (``evaluate.py:29``). The test split of ``data.dataset_test`` under
``data.root`` is loaded; rank 0 writes its ``data_list.txt`` into
``output_path``. The weights come from ``--ckpt`` (a reference ``.ckpt``,
as ``--load`` reads it) or, with ``--resume``, from ``output_path``'s
``best.ckpt``, over the fresh graph of the training engine. Then the
engine's final evaluation: the shape engine writes
``{dataset}_full_results.txt``, ``cd_cat.txt`` and
``quantitative_{dataset}.txt``, the depth engine ``best_val.txt``, in the
JAX formats, from rank 0. Under ``torchrun`` each rank scores its rows of
every global batch of ``eval.batch_size``. The visual dumps go to
``output_path/dump_{dataset}/``: every sample's image, mask, mesh,
turntable GIF, depth and point-cloud comparison and rank 0's
``results_test.html`` (shape), the first batch's images and depths
(depth); each rank writes the samples it scored.
"""

from __future__ import annotations

import os
import sys
import time

from zeroshape_tpu_torch import recon, resolve_device
from zeroshape_tpu_torch.models import resolve_compute_dtype
from zeroshape_tpu_torch.models.graph_depth import DepthGraph
from zeroshape_tpu_torch.models.graph_shape import ShapeGraph
from zeroshape_tpu_torch.parallel import dist
from zeroshape_tpu_torch.runtime import checkpoint, depth_engine, engine_base, shape_engine
from zeroshape_tpu_torch.runtime.logging import log_print
from zeroshape_tpu_torch.train import options
from zeroshape_tpu_torch.weights import init_like_flax


def graph_for(opt, device):
    """The task's graph with its weights: ``init_like_flax`` with the
    pretrained weights staged over it, then ``--ckpt`` or the run's ``best.ckpt``."""
    cls = DepthGraph if opt.task == "depth" else ShapeGraph
    graph = init_like_flax(cls.from_opt(opt, dtype=resolve_compute_dtype(opt, device)), opt.get("seed") or 0)
    graph = graph.to(device)
    checkpoint.stage_pretrained(graph, opt, opt.task)
    if opt.get("ckpt"):
        log_print(f"loading weights from {opt.ckpt}...")
        checkpoint.load_weights(graph, opt.ckpt)
    elif opt.get("resume"):
        path = os.path.join(opt.output_path, "best.ckpt")
        log_print(f"resuming from {path}...")
        engine_base.restore_checkpoint(path, graph)
    else:
        log_print("no --ckpt or --resume: evaluating the initial weights")
    return graph.eval()


def main(argv=None):
    dist.init_distributed_from_env()
    opt = options(sys.argv[1:] if argv is None else argv, safe_check=False)
    opt.eval.n_vis = 1
    dev = resolve_device(opt.get("device"))
    os.makedirs(opt.output_path, exist_ok=True)
    _, test_data = engine_base.load_dataset(opt, eval_split="test", load_train=False)
    if dist.is_main():
        test_data.id_filename_mapping(opt, os.path.join(opt.output_path, "data_list.txt"))
    graph = graph_for(opt, dev)
    t0 = time.perf_counter()
    if opt.task == "depth":
        res = depth_engine.evaluate(graph, test_data, opt, opt.output_path, training=False, device=dev)
    else:
        model = recon.ReconModel(graph, None, 1.0, dev).repack()
        res = shape_engine.evaluate(model, test_data, opt, opt.output_path, test_data.label2cat, training=False,
                                    device=dev)
    log_print(f"evaluated {len(test_data)} samples in {time.perf_counter() - t0:.1f} s")
    return res


if __name__ == "__main__":
    main()
