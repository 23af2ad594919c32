"""Pretrained weights into a fresh graph, and ``--load`` (counterpart of
``stage_pretrained``, ``_load_pretrain_subtrees``, ``merge_params`` and
``load_torch_checkpoint`` in ``zeroshape_tpu/runtime/checkpoint.py:381-504``,
and of ``RunnerBase.load_weights``, ``engine_base.py:195-211``).

The port's modules carry the reference torch names, so a reference ``.ckpt``
loads without conversion. :func:`load_reference_ckpt` reads the three
layouts the JAX importer reads: ``{"graph": state_dict, ...}`` (the
reference's and the port's own checkpoints), ``{"model_state_dict": ...}``
(the omnidata DPT weights, keys unprefixed) and a bare state dict.

JAX (orbax) checkpoint directories are not read: that needs orbax and JAX,
which the port does not import.
"""

from __future__ import annotations

import os

import torch

from zeroshape_tpu_torch import weights

# the subtrees a stage-1 depth checkpoint gives a shape graph
DEPTH_SUBTREES = ("dpt_depth", "intr_head", "intr_proj")


def _check_path(path):
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"pretrained checkpoint not found: {path!r}. Stage-1 weights must exist before the run: "
            "pretrain.depth comes from a depth pretraining run (best.ckpt), arch.depth.pretrained is the "
            "omnidata DPT file. Unset the option to train from scratch."
        )
    if os.path.isdir(path):
        raise ValueError(
            f"{path!r} is a directory: JAX (orbax) checkpoint directories are not read by the PyTorch port, "
            "which would need orbax and JAX for it; give a reference .ckpt file"
        )


def load_reference_ckpt(path):
    """``(state dict, meta, layout)`` of a reference ``.ckpt`` file.

    ``layout`` is ``"graph"`` (meta: ``epoch``, ``iter``, ``best_val``,
    ``best_ep``), ``"omnidata"`` (the DPT's keys under ``dpt_depth.``, meta
    empty) or ``"state_dict"`` (meta empty); tensors stay on the CPU.
    """
    _check_path(path)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if "graph" in ckpt:
        return dict(ckpt["graph"]), {k: ckpt.get(k) for k in ("epoch", "iter", "best_val", "best_ep")}, "graph"
    if "model_state_dict" in ckpt:
        return weights.omnidata_keys(ckpt["model_state_dict"]), {}, "omnidata"
    return dict(ckpt), {}, "state_dict"


def _expected(graph, subtrees=None):
    """The keys of ``graph``'s ``subtrees`` (None: all) that a checkpoint must
    hold: not the BatchNorm counters, fixed buffers or the never-run
    refinenet4 unit, which the JAX trees do not have."""
    buffers = dict(graph.named_buffers())
    prefixes = tuple(f"{s}." for s in subtrees or ())
    return [k for k in graph.state_dict()
            if (not prefixes or k.startswith(prefixes)) and not weights.unmapped(k, buffers)]


def _copy_in(graph, sd, keys):
    """Copy ``sd[k]`` for ``keys`` into ``graph`` in place; raises on a shape mismatch."""
    target = graph.state_dict()
    bad = [f"{k}: {tuple(target[k].shape)} vs {tuple(sd[k].shape)}" for k in keys if target[k].shape != sd[k].shape]
    if bad:
        raise ValueError(f"shape mismatch at {len(bad)} tensors (first: {bad[:3]})")
    with torch.no_grad():
        for k in keys:
            target[k].copy_(sd[k])


def load_subtrees(graph, path, subtrees):
    """Load ``graph``'s ``subtrees`` (parameters and BatchNorm statistics)
    from the reference ``.ckpt`` at ``path``, strictly
    (``_load_pretrain_subtrees``, ``checkpoint.py:381-440``): a missing key
    or a shape mismatch raises. Keys of other subtrees in the file are left."""
    sd, _, _ = load_reference_ckpt(path)
    want = _expected(graph, subtrees)
    missing = [k for k in want if k not in sd]
    if missing:
        raise ValueError(
            f"checkpoint {path} is missing {len(missing)} expected keys (first: {missing[:5]}); refusing a "
            "partial pretrained load"
        )
    prefixes = tuple(f"{s}." for s in subtrees)
    _copy_in(graph, sd, [k for k in graph.state_dict() if k.startswith(prefixes) and k in sd])


def stage_pretrained(graph, opt, kind="shape"):
    """Load the pretrained weights that ``opt`` names into a fresh ``graph``
    (``stage_pretrained``, ``checkpoint.py:448-482``):

    * ``kind="shape"``: ``opt.pretrain.depth`` (a depth run's checkpoint)
      loads ``dpt_depth``, ``intr_head`` and ``intr_proj``; failing that,
      ``opt.arch.depth.pretrained`` (the omnidata file) loads ``dpt_depth``;
    * ``kind="depth"``: ``opt.arch.depth.pretrained`` loads ``dpt_depth``.

    A path that is set but absent raises. Returns the path loaded, or None.
    """
    pre = (opt.get("pretrain") or {}).get("depth") if kind == "shape" else None
    omni = opt.arch.depth.get("pretrained")
    if pre:
        print(f"loading pretrained dpt depth + intr head from {pre}...")
        load_subtrees(graph, pre, DEPTH_SUBTREES)
        return pre
    if omni:
        print(f"loading pretrained dpt depth from {omni}...")
        load_subtrees(graph, omni, ("dpt_depth",))
        return omni
    return None


def load_weights(graph, path):
    """``--load``: the weights of the reference ``.ckpt`` at ``path`` over
    ``graph`` (``RunnerBase.load_weights``, ``engine_base.py:195-211``); see
    :func:`apply_weights`. Returns the file's meta (``load_reference_ckpt``)."""
    return apply_weights(graph, load_reference_ckpt(path), path=path)


def apply_weights(graph, ckpt, strict=False, path="the checkpoint"):
    """Copy ``ckpt`` (:func:`load_reference_ckpt`'s result) into ``graph``:
    every tensor of the file that the graph has, a shape mismatch raising;
    for the graph's keys the file lacks, a warning, or with ``strict`` an
    error that names them (the demo: a checkpoint of the other task). No
    optimizer state. Returns the file's meta."""
    sd, meta, layout = ckpt
    want = _expected(graph, ("dpt_depth",) if layout == "omnidata" else None)
    missing = [k for k in want if k not in sd]
    if missing and strict:
        raise ValueError(f"{path} lacks {len(missing)} keys of the graph (first: {missing[:5]})")
    if missing:
        print(f"warning: {len(missing)} keys missing from ckpt")
    target = graph.state_dict()
    _copy_in(graph, sd, [k for k in target if k in sd])
    return meta
