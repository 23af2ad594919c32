"""The port's demo CLI: option loading, input preparation, and a CPU run."""

import os
import shutil

import numpy as np

from PIL import Image

import demo as jdemo
from zeroshape_tpu.config import load_options as j_load_options
from zeroshape_tpu.data import common as jcommon
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
    """The crop before resizing is the JAX demo's exactly; after the resize
    (PIL's premultiplied bicubic there, torch's antialiased bicubic on the
    premultiplied uint8 image here, as the loaders resize) the image is within
    3/255 and the binarised mask equal on >= 99.5% of pixels."""
    opt = demo.load_options(YAML)
    opt.H, opt.W = 96, 96
    for name in sorted(os.listdir(os.path.join(REPO, "examples", "images"))):
        args = (os.path.join(REPO, "examples", "images", name),
                os.path.join(REPO, "examples", "masks", name[:-4] + ".png"))
        image, mask = Image.open(args[0]).convert("RGB"), Image.open(args[1]).convert("L")
        bbox = jcommon.get_bbox_from_mask((np.array(mask) >= 127).astype(np.float32), 0.5, min_pixels=0)
        crop = np.asarray(jcommon.square_crop(Image.merge("RGBA", (*image.split(), mask)), bbox))
        assert crop.shape[:2] != (96, 96)  # the resize runs
        np.testing.assert_array_equal(demo.crop_rgba(*args), crop)
        (rgb, m), (rgb_j, m_j) = demo.get_image(opt, *args), jdemo.get_image(opt, *args)
        assert rgb.shape == rgb_j.shape and m.shape == m_j.shape
        assert np.abs(rgb - rgb_j).max() <= 3 / 255 + 1e-6, (name, np.abs(rgb - rgb_j).max())
        assert (m == m_j).mean() >= 0.995, (name, (m == m_j).mean())


def test_demo_writes_meshes_on_cpu(tmp_path, capsys):
    """A mesh a image, or, as the JAX demo does for a level grid without a
    surface, "Mesh is empty!" and no file (``vis.dump_meshes``)."""
    data = tmp_path / "examples"
    shutil.copytree(os.path.join(REPO, "examples"), data, ignore=shutil.ignore_patterns("preds"))
    demo.main([f"--yaml={YAML}", f"--datadir={data}", "--device=cpu", "--image_size=[64,64]",
               "--eval.vox_res=16", "--eval.num_points=100"])
    names = sorted(os.listdir(data / "images"))
    meshes = [n for n in names if (data / "preds" / f"{n[:-4]}_mesh.ply").exists()]
    assert meshes and capsys.readouterr().out.count("Mesh is empty!") == len(names) - len(meshes)
    for n in meshes:
        ply = (data / "preds" / f"{n[:-4]}_mesh.ply").read_bytes()
        assert ply.startswith(b"ply\nformat binary_little_endian 1.0\n")
