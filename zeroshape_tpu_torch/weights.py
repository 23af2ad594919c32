"""Weights: the JAX package's trees -> this port's state dict, and seeded init.

:func:`from_flax` takes the JAX shape or depth graph's ``params`` /
``batch_stats`` trees (nested dicts of numpy arrays) and returns the port's
state dict. The
port's module names are the reference torch layout, so the mapping is the
inverse of the JAX package's torch importer (``runtime/checkpoint.py:227-336``):
Flax Dense ``[in, out]`` becomes torch ``[out, in]``, HWIO convs become OIHW.

:func:`init_like_flax` gives a model seeded random weights drawn with the
JAX package's initialisers, for runs without a checkpoint.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

# an entry: (torch key, flax collection, flax path, transform)
_LINEAR = lambda w: np.transpose(w, (1, 0))  # noqa: E731
_CONV = lambda w: np.transpose(w, (3, 2, 0, 1))  # noqa: E731


def _p(prefix, name):
    return f"{prefix}.{name}" if prefix else name


def _linear(tk, path, bias=True):
    out = [(_p(tk, "weight"), "params", path + ("kernel",), _LINEAR)]
    return out + ([(_p(tk, "bias"), "params", path + ("bias",), None)] if bias else [])


def _conv(tk, path, bias=True, wrapped=True):
    """The JAX ``Conv`` module nests an ``nn.Conv`` named 'conv'; a raw ``nn.Conv`` doesn't."""
    sub = path + ("conv",) if wrapped else path
    out = [(_p(tk, "weight"), "params", sub + ("kernel",), _CONV)]
    return out + ([(_p(tk, "bias"), "params", sub + ("bias",), None)] if bias else [])


def _norm(tk, path):  # LayerNorm / GroupNorm
    return [(_p(tk, "weight"), "params", path + ("scale",), None), (_p(tk, "bias"), "params", path + ("bias",), None)]


def _bn(tk, path):
    p = path + ("bn",)
    return [
        (_p(tk, "weight"), "params", p + ("scale",), None),
        (_p(tk, "bias"), "params", p + ("bias",), None),
        (_p(tk, "running_mean"), "batch_stats", p + ("mean",), None),
        (_p(tk, "running_var"), "batch_stats", p + ("var",), None),
    ]


def _bottleneck_conv(tk, path):
    return (
        _conv(_p(tk, "linear1"), path + ("linear1",), bias=False) + _bn(_p(tk, "bn1"), path + ("bn1",))
        + _conv(_p(tk, "linear2"), path + ("linear2",), bias=False) + _bn(_p(tk, "bn2"), path + ("bn2",))
    )


def _vit_block(tk, path):
    return (
        _norm(_p(tk, "norm1"), path + ("norm1",))
        + _linear(_p(tk, "attn.qkv"), path + ("attn", "qkv"))
        + _linear(_p(tk, "attn.proj"), path + ("attn", "proj"))
        + _norm(_p(tk, "norm2"), path + ("norm2",))
        + _linear(_p(tk, "mlp.fc1"), path + ("mlp", "fc1"))
        + _linear(_p(tk, "mlp.fc2"), path + ("mlp", "fc2"))
    )


def map_hybrid_vit(tp, path=()):
    """``HybridViT`` (with its ResNetV2 stem) under torch prefix ``tp``."""
    bb, bp = _p(tp, "patch_embed.backbone"), path + ("backbone",)
    out = [(f"{bb}.stem.conv.weight", "params", bp + ("stem_conv", "kernel"), _CONV)]
    out += _norm(f"{bb}.stem.norm", bp + ("stem_norm", "gn"))
    for s, n_blocks in enumerate((3, 4, 9)):
        for b in range(n_blocks):
            blp, tb = bp + (f"stage{s}_{b}",), f"{bb}.stages.{s}.blocks.{b}"
            for ci in (1, 2, 3):
                out.append((f"{tb}.conv{ci}.weight", "params", blp + (f"conv{ci}", "kernel"), _CONV))
                out += _norm(f"{tb}.norm{ci}", blp + (f"norm{ci}", "gn"))
            if b == 0:
                out.append((f"{tb}.downsample.conv.weight", "params", blp + ("downsample_conv", "kernel"), _CONV))
                out += _norm(f"{tb}.downsample.norm", blp + ("downsample_norm", "gn"))
    out += _conv(_p(tp, "patch_embed.proj"), path + ("patch_embed_proj",), wrapped=False)
    out += [
        (_p(tp, "cls_token"), "params", path + ("cls_token",), None),
        (_p(tp, "pos_embed"), "params", path + ("pos_embed",), None),
    ]
    for i in range(12):
        out += _vit_block(_p(tp, f"blocks.{i}"), path + (f"block{i}",))
    return out + _norm(_p(tp, "norm"), path + ("norm",))


def map_dpt_depth(tp, path=()):
    """``DPTDepthModel``. ``scratch.refinenet4.resConfUnit1`` never runs and
    has no JAX counterpart; it keeps the port's own values."""
    dpt = path + ("dpt",)
    out = map_hybrid_vit(_p(tp, "pretrained.model"), dpt + ("pretrained",))
    for tap, tname in (("act3", "act_postprocess3"), ("act4", "act_postprocess4")):
        out += _linear(_p(tp, f"pretrained.{tname}.0.project.0"), dpt + (f"{tap}_readout", "project"))
        out += _conv(_p(tp, f"pretrained.{tname}.3"), dpt + (f"{tap}_conv",))
    out += _conv(_p(tp, "pretrained.act_postprocess4.4"), dpt + ("act4_down",))
    for n in range(1, 5):
        out += _conv(_p(tp, f"scratch.layer{n}_rn"), dpt + (f"layer{n}_rn",), bias=False)
        rp, trp = dpt + (f"refinenet{n}",), _p(tp, f"scratch.refinenet{n}")
        for u in (1, 2) if n != 4 else (2,):
            for c in (1, 2):
                out += _conv(f"{trp}.resConfUnit{u}.conv{c}", rp + (f"res_conv_unit{u}", f"conv{c}"))
        out += _conv(f"{trp}.out_conv", rp + ("out_conv",))
    out += _conv(_p(tp, "scratch.output_conv.0"), path + ("head_conv1",))
    out += _conv(_p(tp, "scratch.output_conv.2"), path + ("head_conv2",))
    return out + _conv(_p(tp, "scratch.output_conv.4"), path + ("head_conv3",), wrapped=False)


def map_resnet50(tp, path=()):
    out = [(_p(tp, "conv1.weight"), "params", path + ("conv1", "kernel"), _CONV)]
    out += _bn(_p(tp, "bn1"), path + ("bn1",))
    for s, n_blocks in enumerate((3, 4, 6, 3)):
        for b in range(n_blocks):
            bp, tb = path + (f"layer{s + 1}_{b}",), _p(tp, f"layer{s + 1}.{b}")
            for ci in (1, 2, 3):
                out += _conv(f"{tb}.conv{ci}", bp + (f"conv{ci}",), bias=False)
                out += _bn(f"{tb}.bn{ci}", bp + (f"bn{ci}",))
            if b == 0:
                out += _conv(f"{tb}.downsample.0", bp + ("downsample_conv",), bias=False)
                out += _bn(f"{tb}.downsample.1", bp + ("downsample_bn",))
    return out


def map_coord_encoder(tp, path=(), proj="depth_feat_proj"):
    """``CoordEncRes``, or with ``proj="rgb_feat_proj"`` ``RGBEncRes``."""
    out = map_resnet50(_p(tp, "encoder"), path + ("encoder",))
    out += _bottleneck_conv(_p(tp, "encoder.fc.0"), path + ("fc_bottleneck1",))
    out += _bottleneck_conv(_p(tp, "encoder.fc.1"), path + ("fc_bottleneck2",))
    out += _linear(_p(tp, "encoder.fc.2"), path + ("fc_linear",))
    out += _bottleneck_conv(_p(tp, f"{proj}.0"), path + ("feat_bottleneck1",))
    out += _bottleneck_conv(_p(tp, f"{proj}.1"), path + ("feat_bottleneck2",))
    return out + _conv(_p(tp, f"{proj}.2"), path + ("feat_proj",), wrapped=False)


def _param(tk, path):
    return [(tk, "params", path, None)]


def map_vit_trunk(tp, path, n_blocks):
    """The cls token, ``n_blocks`` ViT blocks and the final norm of
    ``CoordEncAtt`` / ``RGBEncAtt``."""
    out = _param(_p(tp, "cls_token"), path + ("cls_token",))
    for i in range(n_blocks):
        out += _vit_block(_p(tp, f"blocks.{i}"), path + (f"block{i}",))
    return out + _norm(_p(tp, "norm"), path + ("norm",))


def map_coord_emb(tp, path=()):
    """``CoordEmb``, the window embedding of ``CoordEncAtt``."""
    out = _linear(_p(tp, "pos_embed"), path + ("pos_embed",))
    out += _param(_p(tp, "invalid_coord_token"), path + ("invalid_coord_token",))
    out += _param(_p(tp, "cls_token"), path + ("cls_token",))
    return out + _vit_block(_p(tp, "blocks.0"), path + ("block0",))


def map_coord_encoder_att(tp, path=(), n_blocks=12):
    """``CoordEncAtt``: the window embedding ``coord_embed``, then the trunk."""
    return map_coord_emb(_p(tp, "coord_embed"), path + ("coord_embed",)) + map_vit_trunk(tp, path, n_blocks)


def map_rgb_encoder_att(tp, path=(), n_blocks=12):
    """``RGBEncAtt``: the patch conv, then the trunk."""
    return _conv(_p(tp, "patch_embed.proj"), path + ("patch_embed",), wrapped=False) + map_vit_trunk(tp, path, n_blocks)


def map_bottleneck_linear(tp, path=()):
    return (_norm(_p(tp, "norm"), path + ("norm",)) + _linear(_p(tp, "linear1"), path + ("linear1",))
            + _linear(_p(tp, "linear2"), path + ("linear2",)))


def map_clip_fusion(tp, path=(), n_layers=1, attn=False):
    """``CLIPFusionBlockConcat`` or, with ``attn``, ``CLIPFusionBlockAttn``
    (used by no graph of the package)."""
    if attn:
        return [e for i in range(n_layers) for e in _vit_block(_p(tp, f"blocks.{i}"), path + (f"block{i}",))]
    out = [e for i in range(n_layers) for e in map_bottleneck_linear(_p(tp, f"bottlenecks.{i}"), path + (f"bottleneck{i}",))]
    return out + _linear(_p(tp, "proj"), path + ("proj",))


def map_implicit(tp, path=(), n_blocks=2, n_mlp_linears=9):
    """``Implicit``; the ``pos_embed`` buffer is a fixed sin-cos table, not a
    weight. ``n_mlp_linears`` 0: the linear ``pred_head`` in place of the MLP."""
    out = _linear(_p(tp, "point_proj.proj"), path + ("point_proj",))
    out += _linear(_p(tp, "latent_proj"), path + ("latent_proj",))
    for i in range(n_blocks):
        bp, tb = path + (f"block{i}",), _p(tp, f"blocks_attn.{i}")
        out += _norm(f"{tb}.norm1", bp + ("norm1",))
        out += _linear(f"{tb}.attn.qkv", bp + ("qkv",))
        out += _linear(f"{tb}.attn.proj", bp + ("proj",))
        out += _norm(f"{tb}.norm2", bp + ("norm2",))
        out += _linear(f"{tb}.mlp.fc1", bp + ("mlp", "fc1"))
        out += _linear(f"{tb}.mlp.fc2", bp + ("mlp", "fc2"))
    out += _norm(_p(tp, "norm"), path + ("norm",))
    for l in range(n_mlp_linears):
        out += _linear(_p(tp, f"impl_mlp.layers.{l}"), path + ("impl_mlp", f"lin{l}"))
    if n_mlp_linears == 0:
        out += _linear(_p(tp, "pred_head"), path + ("pred_head",))
    return out


def map_intr_head(head_prefix, proj_prefix, path=()):
    return (
        _bottleneck_conv(f"{head_prefix}.0", path + ("bottleneck1",))
        + _bottleneck_conv(f"{head_prefix}.1", path + ("bottleneck2",))
        + _linear(proj_prefix, path + ("proj",))
    )


def map_shape_graph(impl_blocks=2, impl_mlp_linears=9, opt=None):
    """Every entry of the shape graph. Without ``opt``: the resnet coordinate
    encoder, no RGB encoder and the given decoder depths. With ``opt`` (the
    options ``ShapeGraph.from_opt`` reads), the entries of the graph it
    builds: either coordinate encoder and its depth, the RGB encoder if any
    and its depth, the decoder's blocks and its MLP or ``pred_head``."""
    from zeroshape_tpu_torch.models.graph_shape import architecture

    depth, depth_blocks, rgb, rgb_blocks = "resnet", 12, None, 12
    if opt is not None:
        a = architecture(opt)
        depth, depth_blocks, rgb, rgb_blocks = a["depth_encoder"], a["depth_enc_blocks"], a["rgb_encoder"], \
            a["rgb_enc_blocks"]
        impl_blocks, impl_mlp_linears = a["impl_att_blocks"], a["impl_mlp_layers"] + (a["impl_mlp_layers"] > 0)
    out = map_dpt_depth("dpt_depth", ("dpt_depth",)) + map_intr_head("intr_head", "intr_proj", ("intr_head",))
    if depth == "resnet":
        out += map_coord_encoder("coord_encoder", ("coord_encoder",))
    else:
        out += map_coord_encoder_att("coord_encoder", ("coord_encoder",), depth_blocks)
    if rgb == "resnet":
        out += map_coord_encoder("rgb_encoder", ("rgb_encoder",), proj="rgb_feat_proj")
    elif rgb == "transformer":
        out += map_rgb_encoder_att("rgb_encoder", ("rgb_encoder",), rgb_blocks)
    return out + map_implicit("impl_network", ("impl_network",), impl_blocks, impl_mlp_linears)


def map_depth_graph():
    """Every entry of the depth graph: ``dpt_depth`` and the intrinsics head,
    whose projection the JAX ``DepthGraph`` keeps inside ``intr_head``."""
    return map_dpt_depth("dpt_depth", ("dpt_depth",)) + map_intr_head("intr_head", "intr_proj", ("intr_head",))


def omnidata_keys(state_dict):
    """An omnidata file's ``model_state_dict`` (the DPT's keys, unprefixed, as
    ``convert_torch_state_dict(graph="omnidata_dpt")`` reads it,
    ``checkpoint.py:354``) -> the keys of a graph's ``dpt_depth``."""
    return {f"dpt_depth.{k}": v for k, v in state_dict.items()}


def convert(entries, params, batch_stats=None):
    """Apply mapping ``entries`` to the flax trees -> {torch key: fp32 tensor}."""
    trees = {"params": params, "batch_stats": batch_stats or {}}
    sd = {}
    for key, coll, path, transform in entries:
        node = trees[coll]
        for k in path:
            node = node[k]
        arr = np.asarray(node, np.float32)
        sd[key] = torch.tensor(transform(arr) if transform else arr)
    return sd


def from_flax(params, batch_stats, impl_blocks=2, impl_mlp_linears=9, graph="shape", opt=None):
    """The JAX ``graph``'s (``"shape"`` or ``"depth"``) ``params`` /
    ``batch_stats`` -> this port's state dict; a shape graph's entries
    follow ``opt``'s architecture where given (:func:`map_shape_graph`)."""
    if graph == "depth":
        return convert(map_depth_graph(), params, batch_stats)
    if graph != "shape":
        raise ValueError(f"unknown graph {graph!r}")
    return convert(map_shape_graph(impl_blocks, impl_mlp_linears, opt), params, batch_stats)


def unmapped(key, buffers):
    """Keys a converted state dict leaves to the module: BatchNorm counters,
    the implicit decoder's fixed sin-cos buffer, and the never-executed first
    residual unit of refinenet4."""
    return (
        key.endswith("num_batches_tracked")
        or (key in buffers and key.endswith("pos_embed"))
        or "refinenet4.resConfUnit1." in key
    )


def load(module, state_dict):
    """``load_state_dict`` that allows only the unmapped keys to be missing."""
    res = module.load_state_dict(state_dict, strict=False)
    buffers = dict(module.named_buffers())
    bad = [k for k in res.missing_keys if not unmapped(k, buffers)]
    if bad or res.unexpected_keys:
        raise KeyError(f"missing {bad[:5]}, unexpected {res.unexpected_keys[:5]}")
    return module


# ---------------------------------------------------------------------------
# Seeded initialisation with the JAX package's initialisers
# ---------------------------------------------------------------------------

def _lecun_normal_(w, g, scale=1.0):
    """flax variance_scaling(scale, fan_in, truncated_normal), drawn by the
    inverse CDF on [-2 std, 2 std]: one uniform draw an element, so a seed
    gives the same weights under every torch version (``nn.init.
    trunc_normal_`` changed its algorithm, and so its draws, between them)."""
    std = math.sqrt(scale / w[0].numel()) / 0.87962566103423978
    lo, hi = ((1.0 + math.erf(x / math.sqrt(2.0))) / 2.0 for x in (-2.0, 2.0))  # the normal CDF at -+2
    w.uniform_(2 * lo - 1, 2 * hi - 1, generator=g).erfinv_().mul_(std * math.sqrt(2.0))
    w.clamp_(min=-2 * std, max=2 * std)


def init_like_flax(model, seed=0):
    """Seeded random weights drawn as the JAX modules initialise them.

    Kernels lecun-normal, biases zero, norms identity, BatchNorm statistics
    (0, 1); the implicit decoder's projections and skip MLP or ``pred_head``
    xavier-uniform (implicit.py:41); the ViT pos-embed normal(0.02); the cls
    and invalid-coordinate tokens of the transformer encoders normal(0.02);
    the depth head's last conv scaled by ``head_init_scale`` with bias
    0.05; the intrinsics projection zero (graph_shape.py:65-71).
    """
    from zeroshape_tpu_torch.models.coord_enc import CoordEmb, CoordEncAtt
    from zeroshape_tpu_torch.models.dpt import DPTDepthModel, HybridViT
    from zeroshape_tpu_torch.models.implicit import Implicit
    from zeroshape_tpu_torch.models.rgb_enc import RGBEncAtt

    g = torch.Generator().manual_seed(seed)
    xavier = set()
    for mod in model.modules():
        if isinstance(mod, Implicit):
            xavier |= {id(mod.point_proj.proj), id(mod.latent_proj), id(mod.output_layer)}
            xavier |= {id(l) for l in (mod.impl_mlp.layers if mod.impl_mlp is not None else ())}
            for blk in mod.blocks_attn:
                xavier |= {id(blk.attn.qkv), id(blk.attn.proj)}
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                if id(mod) in xavier:
                    nn.init.xavier_uniform_(mod.weight, generator=g)
                else:
                    _lecun_normal_(mod.weight, g)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d)):
                mod.reset_parameters()
            if isinstance(mod, nn.BatchNorm2d):
                mod.reset_running_stats()
        # after the generic pass, which would reset these children again
        for mod in model.modules():
            if isinstance(mod, HybridViT):
                nn.init.normal_(mod.pos_embed, std=0.02, generator=g)
                mod.cls_token.zero_()
            if isinstance(mod, CoordEmb):
                nn.init.normal_(mod.invalid_coord_token, std=0.02, generator=g)
            if isinstance(mod, (CoordEmb, CoordEncAtt, RGBEncAtt)):
                nn.init.normal_(mod.cls_token, std=0.02, generator=g)
            if isinstance(mod, DPTDepthModel):
                head = mod.scratch.output_conv[4]
                _lecun_normal_(head.weight, g, mod.head_init_scale**2)
                head.bias.fill_(0.05)
        if hasattr(model, "intr_proj"):
            model.intr_proj.weight.zero_()
            model.intr_proj.bias.zero_()
    return model
