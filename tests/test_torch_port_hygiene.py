"""The PyTorch port stands alone: no JAX, no JAX-package modules, no silent CPU."""

import os
import subprocess
import sys

import pytest
import torch

from __graft_entry__ import _full_opt, _tiny_opt
from zeroshape_tpu_torch import camera, config, dist_check, recon
from zeroshape_tpu_torch import evaluate as evaluate_cli
from zeroshape_tpu_torch.metrics import eval3d
from zeroshape_tpu_torch.runtime import depth_engine, shape_engine
from zeroshape_tpu_torch.models import resolve_compute_dtype

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "zeroshape_tpu_torch")


def _port_modules():
    mods = []
    for root, _, files in os.walk(PACKAGE):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3].replace(os.sep, ".")
                mods.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    return sorted(mods)


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'zeroshape_tpu', "
        "'PIL', 'yaml')]\n"
        "print(repr(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_port_sources_name_no_jax_package():
    for root, _, files in os.walk(PACKAGE):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(root, f)).read()
                for word in ("import jax", "from jax", "import flax", "from flax", "import zeroshape_tpu\n", "from zeroshape_tpu."):
                    assert word not in src, (f, word)
    src = open(os.path.join(REPO, "chip_smoke.py")).read()
    assert "jax" not in src and "zeroshape_tpu." not in src


@pytest.mark.parametrize(
    "entry",
    [
        lambda: recon.build(config.tiny_opt(32)),
        lambda: eval3d.get_dense_3D_grid(4),
        lambda: eval3d.occupancy_grid_hierarchical(lambda p: p[..., 0], 8),
        lambda: camera.get_rotation_sphere(2, 2, 2),
        lambda: shape_engine.evaluate(None, [], config.eval_opt(config.tiny_opt(32)), ".", ["prim"]),
        lambda: shape_engine.train(config.shape_gen_opt(32), None, "unused"),
        lambda: depth_engine.train(config.depth_gen_opt(32), None, "unused"),
        lambda: depth_engine.evaluate(None, [], config.depth_gen_opt(32), "unused"),
        lambda: evaluate_cli.main(["--task=shape", "--data.root=unused"]),
        lambda: dist_check.main(["unused"]),
    ],
)
def test_default_device_needs_cuda(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_compute_dtype_policy():
    opt = config.full_opt()
    assert resolve_compute_dtype(opt, "cpu") == torch.float32
    assert resolve_compute_dtype(opt, "cuda") == torch.bfloat16
    opt.arch.dtype = "float32"
    assert resolve_compute_dtype(opt, "cuda") == torch.float32


@pytest.mark.parametrize("ours,theirs", [(config.full_opt, _full_opt), (config.tiny_opt, _tiny_opt)])
def test_configs_match_the_jax_entry(ours, theirs):
    assert ours(64).to_dict() == theirs(64).to_dict()
