"""The PyTorch port stands alone: no JAX, no JAX-package modules, no PIL, cv2 or
matplotlib, no silent CPU."""

import os
import subprocess
import sys

import pytest
import torch

from __graft_entry__ import _full_opt, _tiny_opt
from zeroshape_tpu_torch import camera, config, demo, dist_check, recon
from zeroshape_tpu_torch import evaluate as evaluate_cli
from zeroshape_tpu_torch.metrics import eval3d
from zeroshape_tpu_torch.ops import render
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
    assert {"zeroshape_tpu_torch.models.rgb_enc", "zeroshape_tpu_torch.models.coord_enc"} <= set(_port_modules())
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'zeroshape_tpu', "
        "'PIL', 'yaml', 'cv2', 'matplotlib')]\n"
        "print(repr(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


BLOCKED = """
import sys
for name in ("PIL", "cv2", "matplotlib"):
    sys.modules[name] = None  # any import of them raises
import os, tempfile
import numpy as np
from zeroshape_tpu_torch import demo, gif, vis
from zeroshape_tpu_torch.data import native
from zeroshape_tpu_torch.ops.marching_cubes import marching_cubes_mesh
tmp = tempfile.TemporaryDirectory()  # removed at exit
out = tmp.name
rng = np.random.default_rng(0)
vis.dump_images(out, [0], "image_input", rng.uniform(size=(1, 16, 16, 3)))
vis.dump_depths(out, [0], "depth_est", rng.uniform(size=(1, 16, 16, 1)), rng.uniform(size=(1, 16, 16, 1)), rescale=True)
vis.dump_pointclouds(out, [0], "pc", rng.normal(size=(1, 8, 3)), colors=rng.uniform(size=(1, 8, 1)))
vis.dump_pointclouds_compare(out, [0], "cmp", rng.normal(size=(1, 8, 3)), rng.normal(size=(1, 5, 3)))
xyz = np.concatenate([rng.uniform(size=(16, 16, 2)) * 0.001, np.ones((16, 16, 1))], -1)
vis.dump_seen_surface(out, [0], "seen", "image_input", [xyz])
frames = [vis.show_att_on_image(rng.uniform(size=(16, 16, 3)), rng.uniform(size=(16, 16))) for _ in range(3)]
vis.dump_attentions(out, [0], "attn", [frames])
g = np.linspace(-1, 1, 12)
X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
mesh = marching_cubes_mesh((X**2 + Y**2 + Z**2 < 0.5).astype(np.float32))
vis.dump_meshes_viz(out, [0], "mesh_viz", [mesh], image_size=32, device="cpu")
vis.create_gif_html(os.path.join(out, "dump"), os.path.join(out, "gallery.html"))
opt = demo.options(["--datadir=examples", "--device=cpu", "--image_size=[32,32]"])
samples, names = demo.prepare_data(opt)
assert len(samples) == 3 and samples[0]["rgb_input_map"].shape == (1, 32, 32, 3)
assert native.decode_png(os.path.join(out, "dump", "0_depth_est.png")).shape == (16, 16, 4)  # RGBA, as imsave
assert gif.info(os.path.join(out, "dump", "0_mesh_viz.gif"))["frames"] == 15
print(sorted(os.listdir(os.path.join(out, "dump"))))
"""


def test_writers_renderer_and_demo_inputs_run_without_pil_cv2_matplotlib():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", BLOCKED], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == repr(["0_attn.gif", "0_cmp.ply", "0_depth_est.png", "0_image_input.png",
                                       "0_mesh_viz.gif", "0_pc.ply", "0_seen.mtl", "0_seen.obj"])


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
        lambda: demo.main(["--datadir=unused"]),
        lambda: render.render_turntable(torch.zeros(1, 3, 3)),
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
