"""Attribute-dict config, the model configurations the port ships (the shipped
shape model, its tiny-decoder test size, the non-default encoders), the
evaluation options, the training recipes (``shape_gen``, ``depth`` and
``depth_gen``, the accuracy gate's), and the CLI options.

Counterpart of ``zeroshape_tpu/config.py`` (the ``Config`` tree, the YAML
loader with ``_parent_`` inheritance and dotted CLI overrides) and of the
option builders in ``__graft_entry__.py`` (``_full_opt``, ``_tiny_opt``).
PyYAML is imported only to read a YAML file and to write ``options.yaml``
(which has a form of its own without it); CLI values are parsed without it,
so the CLIs run where PyYAML is absent.
"""

from __future__ import annotations

import copy
import os
import random
import string
import sys
import time

import numpy as np


class Config(dict):
    """Nested dict with attribute access; nested dicts become Configs."""

    def __init__(self, d=None):
        super().__init__()
        for k, v in (d or {}).items():
            self[k] = v

    def __setitem__(self, key, value):
        if isinstance(value, dict) and not isinstance(value, Config):
            value = Config(value)
        super().__setitem__(key, value)

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key, value):
        self[key] = value

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self):
        return {k: (v.to_dict() if isinstance(v, Config) else v) for k, v in self.items()}


def full_opt(H=224):
    """The shipped shape model (resnet coordinate encoder, no RGB encoder)."""
    return Config(
        {
            "H": H,
            "W": H,
            "arch": {
                "num_heads": 8,
                "latent_dim": 256,
                "win_size": 16,
                "depth": {"encoder": "resnet", "n_blocks": 12, "dsp": 1},
                "rgb": {"encoder": None, "n_blocks": 12},
                "impl": {
                    "n_channels": 256,
                    "att_blocks": 2,
                    "mlp_ratio": 4.0,
                    "posenc_perlayer": False,
                    "mlp_layers": 8,
                    "posenc_3D": 0,
                    "skip_in": [2, 4, 6],
                },
            },
            "training": {
                "n_sdf_points": 512,
                "shape_loss": {"impt_weight": 1, "impt_thres": 0.01},
                "depth_loss": {"grad_reg": 0.1, "depth_inv": True, "mask_shrink": False},
            },
            "loss_weight": {"shape": 1, "depth": None, "intr": None},
            "optim": {
                "lr": 3e-5,
                "lr_ft": 1e-5,
                "weight_decay": 0.05,
                "fix_dpt": False,
                "clip_norm": None,
                "accum": 1,
                "sched": False,
            },
        }
    )


def tiny_opt(H=32):
    """Narrow decoder for fast tests (same encoder architecture)."""
    opt = copy.deepcopy(full_opt(H))
    opt.arch.latent_dim = 64
    opt.arch.impl.n_channels = 64
    opt.arch.impl.mlp_layers = 4
    opt.arch.impl.skip_in = [2]
    opt.arch.depth.n_blocks = 2
    return opt


def encoders_opt(H=224):
    """``full_opt`` with the non-default encoders at ``options/shape.yaml``'s
    own depths: the transformer coordinate encoder (12 blocks over the
    coordinate map downsampled by ``dsp`` 2: 112^2 at 224^2, windows of 8,
    196 window tokens + cls) and the transformer RGB encoder (12 blocks over
    16^2 patches: 196 + cls). The decoder takes both streams (a 512-wide
    latent projection) and is K1's shape otherwise: latent 256, 8 heads,
    C=256, L=197."""
    opt = full_opt(H)
    opt.arch.depth = Config({"encoder": "transformer", "n_blocks": 12, "dsp": 2})
    opt.arch.rgb = Config({"encoder": "transformer", "n_blocks": 12})
    return opt


def eval_opt(opt, **eval_overrides):
    """``opt`` with the evaluation sections of ``options/shape.yaml`` (``eval``
    and the ``data`` keys the evaluator reads), ``eval`` keys overridden by
    ``eval_overrides``. A copy; ``opt`` is not changed."""
    opt = copy.deepcopy(opt)
    opt.eval = {
        "batch_size": 2,
        "brute_force": False,
        "vox_res": 64,
        "num_points": 10000,
        "range": [-1.5, 1.5],
        "icp": False,
        "bf_prune": None,
        "bf_fast_coarse": True,
        "hier_decode": True,
        "hier_final": False,
        "hier_capacity": None,
        "f_thresholds": [0.005, 0.01, 0.02, 0.05, 0.1, 0.2],
        "n_vis": 50,
        "dump_attn": True,
        **eval_overrides,
    }
    opt.data = {"root": "data", "num_classes_test": 15, "max_img_cat": None, "dataset_train": "synthetic",
                "dataset_test": "synthetic", "num_workers": 6, "bgcolor": 1, "pix3d": {"cat": None},
                "ocrtoc": {"cat": None, "erode_mask": None},
                "synthetic": {"subset": "objaverse_LVIS,ShapeNet55", "percentage": 1}}
    return opt


def synthetic_image(H, seed=0, B=1):
    """A seeded masked image: a soft-shaded ellipsoid over a white background.

    Returns numpy NHWC ``rgb [B, H, H, 3]`` in [0, 1] and ``mask [B, H, H, 1]``
    (a compact object, not noise), the batch layout of ``encode_image``.
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(H), np.arange(H), indexing="ij")
    rgbs, masks = [], []
    for _ in range(B):
        cy, cx = rng.uniform(0.4, 0.6, 2) * H
        ry, rx = rng.uniform(0.2, 0.35, 2) * H
        d = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
        m = (d <= 1.0).astype(np.float32)
        shade = np.sqrt(np.clip(1.0 - d, 0.0, 1.0))
        color = rng.uniform(0.2, 0.9, 3)
        rgb = shade[..., None] * color + rng.normal(0, 0.02, (H, H, 3))
        rgb = rgb * m[..., None] + (1.0 - m[..., None])
        rgbs.append(np.clip(rgb, 0.0, 1.0))
        masks.append(m[..., None])
    return np.stack(rgbs).astype(np.float32), np.stack(masks).astype(np.float32)


def shape_gen_opt(H=224):
    """``full_opt`` under the recipe of ``options/shape_gen.yaml`` over
    ``options/shape.yaml``, on the analytic tree of ``/tmp/gen_data``:
    batch 8, 4096 SDF points, loss weights shape 1 / depth 1 / intr 10,
    lr = lr_ft = 1e-4, weight decay 0.05, the depth head initialised at
    0.001, validation at vox 128, batch 1, without brute force. It holds
    every key of those files that the port reads, so the train CLI's checked
    overrides take them without a ``--yaml``."""
    return override_options(eval_opt(full_opt(H), batch_size=1, vox_res=128, brute_force=False, n_vis=2), {
        "group": "shape", "load": None, "yaml": None, "task": "shape", "datadir": None, "ckpt": None,
        "profile": False, "image_size": [H, H], "output_root": "output",
        "name": "shape_gen",
        "batch_size": 8,
        "max_epoch": 200,
        "seed": 0,
        "resume": False,
        "debug": False,
        "pretrain": {"depth": None},
        "arch": {"dtype": "auto", "depth": {"pretrained": None, "head_init_scale": 0.001}},
        "training": {"n_sdf_points": 4096},
        "loss_weight": {"shape": 1, "depth": 1, "intr": 10},
        "optim": {"lr": 1e-4, "lr_ft": 1e-4},
        "data": {"root": "/tmp/gen_data", "num_workers": 4, "dataset_train": "synthetic",
                 "synthetic": {"subset": "analytic"}},
        "tb": {"num_images": [4, 8]},
        "freq": {"print": 200, "print_eval": 20, "scalar": 500, "vis": 5000, "save_vis": 20000,
                 "ckpt_latest": 500, "eval": 50},
    })


def depth_opt(H=224):
    """``full_opt`` under ``options/depth.yaml``, the depth + intrinsics
    pretraining recipe: batch 44, lr 3e-5 for every group (no ``lr_ft``),
    weight decay 0.05, no schedule, loss weights depth 1 / intr 10 (no shape
    loss), the omnidata DPT weights as ``arch.depth.pretrained``, validation
    at eval batch 44 with the delta thresholds (1.02, 1.05, 1.1, 1.2) and no
    depth cap, every epoch."""
    return override_options(full_opt(H), {
        "group": "depth", "name": "depth_est", "load": None, "yaml": None, "task": "depth", "datadir": None,
        "ckpt": None, "batch_size": 44, "debug": False, "profile": False, "image_size": [H, H], "max_epoch": 15,
        "output_root": "output", "resume": False, "seed": 0,
        "arch": {"dtype": "auto", "depth": {"pretrained": "weights/omnidata_dpt_depth_v2.ckpt"}},
        "eval": {"batch_size": 44, "n_vis": 50, "depth_cap": None, "d_thresholds": [1.02, 1.05, 1.1, 1.2]},
        "data": {"root": "data", "num_classes_test": 15, "max_img_cat": None, "dataset_train": "synthetic",
                 "dataset_test": "synthetic", "num_workers": 6, "bgcolor": 1, "pix3d": {"cat": None},
                 "ocrtoc": {"cat": None, "erode_mask": 10},
                 "synthetic": {"subset": "objaverse_LVIS,ShapeNet55", "percentage": 1}},
        "training": {"n_sdf_points": 4096},
        "loss_weight": {"shape": None, "depth": 1, "intr": 10},
        "optim": {"lr": 3e-5, "lr_ft": None, "weight_decay": 0.05, "fix_dpt": False, "clip_norm": None, "accum": 1,
                  "sched": False},
        "tb": {"num_images": [4, 8]},
        "freq": {"print": 200, "print_eval": 100, "scalar": 1000, "vis": 1000, "save_vis": 1000,
                 "ckpt_latest": 1000, "eval": 1},
    })


def depth_gen_opt(H=224):
    """:func:`depth_opt` under ``options/depth_gen.yaml``, stage 1 of the
    analytic two-stage recipe: from random weights (no omnidata file), the
    depth head initialised at 0.001, batch 8, lr 1e-4, eval batch 8,
    validation every 25 epochs. Its ``best.ckpt`` feeds a shape run's
    ``pretrain.depth``."""
    return override_options(depth_opt(H), {
        "name": "depth_gen", "batch_size": 8, "max_epoch": 100,
        "arch": {"depth": {"pretrained": None, "head_init_scale": 0.001}},
        "data": {"root": "/tmp/gen_data", "num_workers": 4, "synthetic": {"subset": "analytic"}},
        "eval": {"batch_size": 8, "n_vis": 2},
        "optim": {"lr": 1e-4},
        "freq": {"print": 100, "print_eval": 20, "scalar": 500, "vis": 5000, "save_vis": 20000,
                 "ckpt_latest": 500, "eval": 25},
    })


GATE_EPOCHS = 24


def accuracy_gate_opt():
    """The model and recipe of the accuracy gate (``tests/test_accuracy_gate.py``):
    the shape graph at 64^2 with a narrow decoder (latent 64, C=64, mlp
    ratio 2, 4 MLP linears, skip at 2) over the full-width encoders, trained
    from random weights for 24 epochs at batch 8, lr = lr_ft = 1e-3, no
    schedule, 512 SDF points a sample, all three losses; validated before
    the first step and after the last epoch at vox 32, 2,048 points, eval
    batch 4, no brute force. Its data is ``data.analytic.train_samples(4, 6,
    64, seed=0, n_pc_points=2048, n_sdf_points=4096, val_views=1)``; the
    gate passes at a best CD below 0.11."""
    H = 64
    return override_options(eval_opt(full_opt(H)), {
        "group": "shape", "name": "accgate", "yaml": None, "load": None, "resume": False, "debug": False,
        "profile": False, "seed": 0, "batch_size": 8, "image_size": [H, H], "max_epoch": GATE_EPOCHS,
        "arch": {
            "num_heads": 8, "latent_dim": 64, "win_size": 16,
            "depth": {"encoder": "resnet", "n_blocks": 2, "dsp": 1, "pretrained": None, "head_init_scale": 0.001},
            "rgb": {"encoder": None, "n_blocks": 2},
            "impl": {"n_channels": 64, "att_blocks": 2, "mlp_ratio": 2.0, "posenc_perlayer": False,
                     "mlp_layers": 4, "posenc_3D": 0, "skip_in": [2]},
        },
        "eval": {"batch_size": 4, "brute_force": False, "n_vis": 0, "vox_res": 32, "num_points": 2048,
                 "range": [-1.5, 1.5], "icp": False, "f_thresholds": [0.01, 0.05, 0.2]},
        "data": {"num_classes_test": 2, "max_img_cat": None, "dataset_train": "synthetic",
                 "dataset_test": "synthetic", "bgcolor": 1, "synthetic": {"subset": "analytic", "percentage": 1}},
        "training": {"n_sdf_points": 512, "shape_loss": {"impt_weight": 1, "impt_thres": 0.01},
                     "depth_loss": {"grad_reg": 0.1, "depth_inv": True, "mask_shrink": False}},
        "loss_weight": {"shape": 1, "depth": 1, "intr": 10},
        "optim": {"lr": 1e-3, "lr_ft": 1e-3, "weight_decay": 0.05, "fix_dpt": False, "clip_norm": None,
                  "accum": 1, "sched": False},
        "freq": {"print": 10, "print_eval": 10, "scalar": 1000, "vis": 100000, "save_vis": 100000,
                 "ckpt_latest": 1000, "eval": GATE_EPOCHS},
    })


# ---------------------------------------------------------------------------
# Options from YAML files and the command line (zeroshape_tpu/config.py:84-149)
# ---------------------------------------------------------------------------

def parse_value(text):
    """A CLI value: ``true`` / ``false``, ``null`` / ``~``, an int, a float
    (``1.e-4``), a ``[a, b]`` list of values, else the string."""
    t = text.strip()
    low = t.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "~", ""):
        return None
    if t.startswith("[") and t.endswith("]"):
        return [parse_value(x) for x in t[1:-1].split(",")] if t[1:-1].strip() else []
    for cast in (int, float):
        try:
            return cast(t)
        except ValueError:
            pass
    return t.strip("'\"")


def parse_arguments(args):
    """``--a.b=value`` -> nested Config; ``--flag`` is True, ``--flag!`` False."""
    opt_cmd = {}
    for arg in args:
        if not arg.startswith("--"):
            raise ValueError(f"argument must start with '--': {arg!r}")
        if "=" not in arg[2:]:
            key_str, value = (arg[2:-1], "false") if arg.endswith("!") else (arg[2:], "true")
        else:
            key_str, value = arg[2:].split("=", 1)
        keys = key_str.split(".")
        sub = opt_cmd
        for k in keys[:-1]:
            sub = sub.setdefault(k, {})
        if keys[-1] in sub:
            raise ValueError(f"duplicate CLI key: {key_str}")
        sub[keys[-1]] = parse_value(value)
    return Config(opt_cmd)


def override_options(opt, opt_over, key_stack=(), safe_check=False):
    """``opt`` with the nested values of ``opt_over`` set over it (in place).

    With ``safe_check`` (the train CLI's overrides, ``config.py:128-149``) a
    leaf key that ``opt`` does not hold raises ``KeyError`` naming its dotted
    path, so a mistyped option fails instead of training the default."""
    for key, value in opt_over.items():
        if isinstance(value, dict):
            sub = opt.get(key)
            opt[key] = override_options(sub if isinstance(sub, Config) else Config(), value, key_stack + (key,),
                                        safe_check)
        else:
            if safe_check and key not in opt:
                raise KeyError(f"config key {'.'.join(key_stack + (key,))!r} not found in the options; "
                               "check its spelling, or add it to the --yaml file")
            opt[key] = value
    return opt


def load_options(fname):
    """Load a YAML file, resolving ``_parent_`` bases (relative to the file or the cwd)."""
    import yaml

    with open(fname) as f:
        opt = Config(yaml.safe_load(f))
    parents = opt.pop("_parent_", None)
    if parents:
        base = Config()
        for parent in [parents] if isinstance(parents, str) else parents:
            cand = parent if os.path.isfile(parent) else os.path.join(os.path.dirname(os.path.abspath(fname)), parent)
            base = override_options(base, load_options(cand))
        opt = override_options(base, opt)
    return opt


def process_options(opt):
    """The train CLI's derived fields (``config.py:180-195``): a random
    four-letter suffix to ``name`` when ``seed`` is None, and ``freq.eval``
    of None set to ``max(max_epoch // 20, 1)``. In place; returns ``opt``."""
    if opt.get("seed") is None:
        opt.name = f"{opt.get('name', 'run')}_{''.join(random.choice(string.ascii_uppercase) for _ in range(4))}"
    freq = opt.get("freq")
    if freq is not None and freq.get("eval") is None:
        freq.eval = max(opt.get("max_epoch", 1) // 20, 1)
    return opt


def _plain(x):
    """``x`` as plain dicts, lists and scalars (tuples become lists)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _yaml_scalar(x):
    """One value in a form that both ``json.loads`` and ``yaml.safe_load`` read
    back as itself: floats always carry a ``.`` (PyYAML reads ``1e-05`` as a
    string), strings are double-quoted."""
    import json

    if isinstance(x, float):
        r = repr(x)
        return r.replace("e", ".0e", 1) if "e" in r and "." not in r else r
    return json.dumps(x)


def _yaml_text(x, indent=0):
    """``x`` (plain, :func:`_plain`) as indented JSON whose floats PyYAML reads
    as floats: the options file where PyYAML is not installed."""
    pad = " " * (indent + 4)
    if isinstance(x, dict):
        if not x:
            return "{}"
        items = [f"{pad}{_yaml_scalar(str(k))}: {_yaml_text(v, indent + 4)}" for k, v in sorted(x.items())]
        return "{\n" + ",\n".join(items) + "\n" + " " * indent + "}"
    if isinstance(x, list):
        return "[" + ", ".join(_yaml_text(v, indent) for v in x) + "]"
    return _yaml_scalar(x)


def _read_options_file(path):
    """The dict an options file holds: with PyYAML any YAML; without it the
    JSON form :func:`_yaml_text` writes, else None (not comparable)."""
    import json

    with open(path) as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        try:
            return json.loads(text)
        except ValueError:
            return None
    return yaml.safe_load(text) or {}


def _diff_options(old, new, path=""):
    """Flat list of 'key: old -> new' lines between two plain dicts."""
    lines = []
    for key in sorted(set(old) | set(new)):
        full = f"{path}.{key}" if path else str(key)
        a, b = old.get(key, "<absent>"), new.get(key, "<absent>")
        if isinstance(a, dict) and isinstance(b, dict):
            lines += _diff_options(a, b, full)
        elif a != b:
            lines.append(f"  {full}: {a!r} -> {b!r}")
    return lines


def save_options_file(opt, path=None, grace_seconds=10):
    """Write the resolved options to ``<output_path>/options.yaml``
    (``save_options_file``, ``config.py:221-271``).

    Over an existing file that differs, print the key-level diff first, and
    where stdin is a TTY and ``debug`` is off, wait ``grace_seconds`` for a
    ctrl-c (a mistyped ``--name`` would otherwise overwrite another run's
    record). The file is PyYAML's block YAML, or without PyYAML indented
    JSON that ``yaml.safe_load`` reads back equal. Returns the path."""
    path = path or os.path.join(opt.output_path, "options.yaml")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    new = _plain(opt.to_dict())
    if os.path.isfile(path):
        old = _read_options_file(path)
        diff = None if old is None else _diff_options(old, new)
        if old is None:
            print("existing options file found (not compared: PyYAML is not installed)")
        elif diff:
            print("existing options file found (different from current one):")
            print("\n".join(diff))
            if not opt.get("debug") and grace_seconds and hasattr(sys.stdin, "isatty") and sys.stdin.isatty():
                print(f"please cancel (ctrl-c) within {grace_seconds} seconds if you do not want to override...")
                time.sleep(grace_seconds)
        else:
            print("existing options file found (identical)")
    try:
        import yaml
    except ImportError:
        text = _yaml_text(new) + "\n"
    else:
        text = yaml.safe_dump(new, default_flow_style=False, indent=4)
    with open(path, "w") as f:
        f.write(text)
    return path
