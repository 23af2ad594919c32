"""The port's demo CLI: option loading, input preparation, and a CPU run."""

import os
import shutil

import numpy as np

import demo as jdemo
from zeroshape_tpu.config import load_options as j_load_options
from zeroshape_tpu_torch import demo

from test_torch_harness import give_memory_back  # noqa: F401 (autouse: frees the module's memory at its end)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "options", "shape.yaml")


def test_options_match_the_jax_loader():
    opt = demo.override_options(demo.load_options(YAML), demo.parse_arguments(["--eval.vox_res=64", "--eval.dump_attn!"]))
    ref = j_load_options(YAML)
    ref["eval"]["vox_res"], ref["eval"]["dump_attn"] = 64, False
    assert opt.to_dict() == ref.to_dict()


def test_input_preparation_matches_the_jax_demo():
    opt = demo.load_options(YAML)
    opt.H, opt.W = 96, 96
    name = sorted(os.listdir(os.path.join(REPO, "examples", "images")))[0]
    args = (os.path.join(REPO, "examples", "images", name), os.path.join(REPO, "examples", "masks", name[:-4] + ".png"))
    for got, want in zip(demo.get_image(opt, *args), jdemo.get_image(opt, *args)):
        np.testing.assert_array_equal(got, want)


def test_demo_writes_meshes_on_cpu(tmp_path):
    data = tmp_path / "examples"
    shutil.copytree(os.path.join(REPO, "examples"), data, ignore=shutil.ignore_patterns("preds"))
    demo.main([f"--yaml={YAML}", f"--datadir={data}", "--device=cpu", "--image_size=[64,64]",
               "--eval.vox_res=16", "--eval.num_points=100"])
    names = sorted(os.listdir(data / "images"))
    for n in names:
        ply = (data / "preds" / f"{n[:-4]}_mesh.ply").read_bytes()
        assert ply.startswith(b"ply\nformat binary_little_endian 1.0\n")
