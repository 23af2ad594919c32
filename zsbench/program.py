"""The system under test, reached through its normal entry points.

This is the only module of the benchmark that imports the PyTorch and CUDA
port ``zeroshape_tpu_torch``. It builds the port's options from a
configuration file's ``options`` (over ``config.full_opt``), the port's
shape graph with the benchmark's weights loaded, and hands out the entry
points the windows drive: ``recon.reconstruct_batch``,
``parallel/train.train_step`` with ``make_optimizer``, and
``runtime/shape_engine.score_batch``.
"""

import copy

import torch

from zeroshape_tpu_torch import config, recon
from zeroshape_tpu_torch.models import resolve_compute_dtype
from zeroshape_tpu_torch.models.graph_shape import ShapeGraph
from zeroshape_tpu_torch.parallel import train as port_train
from zeroshape_tpu_torch.runtime import shape_engine

reconstruct_batch = recon.reconstruct_batch
train_step = port_train.train_step
score_batch = shape_engine.score_batch


def options(cfg, **sections):
    """The port's options: ``config.full_opt`` with the configuration's
    ``options`` set over it (every key must exist there), then ``sections``."""
    opt = config.full_opt(cfg["H"])
    config.override_options(opt, copy.deepcopy(cfg), safe_check=True)
    return config.override_options(opt, sections) if sections else opt


def build_graph(opt, state, device, train=False):
    """The port's shape graph on ``device`` with ``state`` (the benchmark's
    weights by the released key names) loaded; only the decoder's fixed
    sin-cos buffer and BatchNorm's counters may be left to the module."""
    with torch.device(device):
        graph = ShapeGraph.from_opt(opt, dtype=resolve_compute_dtype(opt, device))
    graph = graph.to(device)  # buffers made from numpy stay on the host under the device context
    res = graph.load_state_dict(state, strict=False)
    missing = [k for k in res.missing_keys if not (k.endswith("num_batches_tracked") or k == "impl_network.pos_embed")]
    if missing or res.unexpected_keys:
        raise KeyError(f"weights do not fit the port's graph: missing {missing[:5]}, unexpected "
                       f"{res.unexpected_keys[:5]}")
    return graph.train(train)


def recon_model(graph, sharpen, device):
    """The reconstruction model of ``recon`` over ``graph``, with K1's packed weights."""
    return recon.ReconModel(graph, None, sharpen, torch.device(device)).repack()


def make_optimizer(graph, opt):
    return port_train.make_optimizer(graph, opt.optim)


def eval_options(opt, **ev):
    return config.eval_opt(opt, **ev)
