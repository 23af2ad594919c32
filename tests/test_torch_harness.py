"""Shared helpers for the PyTorch-port parity tests (no tests here).

Both packages get the same inputs, made from a numpy seed, and the same
weights: the JAX module's variables are drawn at random with numpy and go
to the port through ``zeroshape_tpu_torch.weights``. Arrays cross between
the two as numpy.
"""

import ctypes
import gc
import json
import os

import jax
import numpy as np
import pytest
import torch

from zeroshape_tpu_torch import weights


@pytest.fixture(scope="module", autouse=True)
def give_memory_back():
    """At the end of a test module, hand what it freed back to the system.

    A module that imports this fixture gets it for all its tests. glibc keeps
    freed heap pages (torch's and XLA's host buffers) in its arenas, so an
    xdist worker would otherwise hold a module's peak (up to ~8 GB for the
    full train step) for the rest of the run, beside the other workers and
    the 20 GB subprocess of ``test_graft_entry.py``'s dry run.
    """
    yield
    gc.collect()
    jax.clear_caches()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):  # not glibc: nothing to trim
        pass


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for a module that imports this fixture. The six
    xdist workers share the host's cores; with torch's default of a thread
    a core, a CPU-heavy module runs several times slower whenever the
    workers overlap, while two threads cost it little alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def random_variables(module, *init_args, seed=0, **init_kw):
    """Variables of a flax ``module`` with numpy-random values.

    Shapes come from ``jax.eval_shape`` (no initialiser runs). As in the
    repo's torch-oracle fixtures (tests/torch_oracle_shape.py), every
    parameter and running mean ~ N(0, 0.05) and running variances
    ~ U(0.6, 1.4).
    """
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda: module.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                            *init_args, **init_kw)
    )

    def fill(path, leaf):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.6, 1.4, leaf.shape).astype(np.float32)
        return rng.normal(0.0, 0.05, leaf.shape).astype(np.float32)

    out = jax.tree_util.tree_map_with_path(fill, shapes)
    return {k: dict(v) for k, v in out.items()}


def load_port(module, entries, variables):
    """Load the flax ``variables`` into the port ``module`` through ``entries``."""
    sd = weights.convert(entries, variables["params"], variables.get("batch_stats"))
    return weights.load(module, sd).eval()


def np32(x):
    return np.asarray(x, np.float32)


def t(x):
    """numpy -> fp32 CPU tensor."""
    return torch.from_numpy(np.ascontiguousarray(np32(x)))


def nchw(x):
    """NHWC numpy -> NCHW tensor."""
    return t(x).permute(0, 3, 1, 2)


def nhwc(x):
    """NCHW tensor -> NHWC numpy."""
    return x.detach().permute(0, 2, 3, 1).numpy()


def close(got, want, tol, msg=""):
    np.testing.assert_allclose(np32(got), np32(want), rtol=tol, atol=tol, err_msg=msg)


# ---------------------------------------------------------------------------
# dataset trees in each loader's layout (after tests/test_datasets.py:13-160)
# ---------------------------------------------------------------------------

def data_opt(root, H=32, **data):
    """Options both packages' loaders read (``tests/test_datasets.py:base_opt``)."""
    return {"H": H, "W": H, "seed": 0, "batch_size": 2, "image_size": [H, H], "training": {"n_sdf_points": 16},
            "data": {"root": str(root), "num_workers": 2, "bgcolor": 1, "max_img_cat": None, "pix3d": {"cat": None},
                     "ocrtoc": {"cat": None, "erode_mask": 2}, "synthetic": {"subset": "analytic", "percentage": 1},
                     **data}}


def analytic_render(H, seed):
    """One analytic view: uint8 RGB ``[H, H, 3]``, z-depth ``[H, H]``, the 3x4
    pose and a surface cloud of 256 points (from ``data.analytic``)."""
    from zeroshape_tpu_torch.data import analytic

    rng = np.random.default_rng(seed)
    sdf, albedo = analytic.make_sdf(analytic.SDF_KINDS[seed % len(analytic.SDF_KINDS)], rng)
    f = 1.3875 * H
    K = np.array([[f, 0, H / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    pose = analytic.look_at_pose(analytic._camera_ring(3, rng)[seed % 3])
    rgb, depth, _ = analytic.render_scene(sdf, albedo, K, pose, H, H)
    return (rgb * 255).astype(np.uint8), depth, pose, analytic.surface_points(sdf, 256, rng)


def write_pix3d(root, H=32, img_size=48, ext=".png", cats=("chair", "sofa"), n=2):
    """A Pix3D tree: per category ``n`` images of ``img_size`` (a size other
    than ``H``: the loader resizes) as ``ext``, their masks as PNG."""
    from zeroshape_tpu_torch.data.common import resize_u8, write_png

    base = os.path.join(root, "Pix3D")
    for c in cats:
        for sub in ("lists", f"annotation/{c}", f"img_processed/{c}", f"mask_processed/{c}"):
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        names = []
        for i in range(n):
            name = f"{i:04d}"
            names.append(name)
            rgb, depth, pose, pc = analytic_render(img_size, seed=len(c) + i)
            mask = resize_u8(((depth > 0) * 255).astype(np.uint8)[..., None], (img_size, img_size))[..., 0]
            img_path = os.path.join(base, f"img_processed/{c}", name + ext)
            if ext == ".png":
                write_png(img_path, rgb)
            else:
                from PIL import Image

                Image.fromarray(rgb).save(img_path, quality=95)
            write_png(os.path.join(base, f"mask_processed/{c}", name + ".png"), mask)
            meta = {"img": f"img/{c}/{name}{ext}", "mask": f"mask/{c}/{name}.png", "model": f"model/{c}/m{i}/model.obj",
                    "rot_mat": pose[:, :3].tolist()}
            with open(os.path.join(base, f"annotation/{c}", name + ".json"), "w") as f:
                json.dump(meta, f)
            os.makedirs(os.path.join(base, "pointclouds", c, f"m{i}"), exist_ok=True)
            np.save(os.path.join(base, "pointclouds", c, f"m{i}", "model.npy"), pc)
        with open(os.path.join(base, "lists", f"{c}_test.txt"), "w") as f:
            f.write("\n".join(names))
    return base


def write_ocrtoc(root, dirname="Ocrtoc", depth_dir="depth_np", H=32, cats=("mug", "box"), n=6):
    """An OCRTOC (or, with ``OmniObject3D`` / ``depth``, an OmniObject3D) tree:
    ``n`` views an object, PNG images, depth ``.npy``, extrinsics, one cloud."""
    from zeroshape_tpu_torch.data.common import write_png

    base = os.path.join(root, dirname)
    for c in cats:
        for sub in ("lists", f"images_processed/{c}", f"{depth_dir}/{c}", f"camera_data/extr/{c}", f"pointclouds/{c}"):
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        names = []
        for i in range(n):
            name = f"{c}1_{i:03d}"
            names.append(name + ".png")
            rgb, depth, pose, pc = analytic_render(H, seed=len(c) + i)
            write_png(os.path.join(base, f"images_processed/{c}", name + ".png"), rgb)
            np.save(os.path.join(base, depth_dir, c, name + ".npy"), depth)
            np.save(os.path.join(base, f"camera_data/extr/{c}", name + ".npy"), pose)
        np.save(os.path.join(base, f"pointclouds/{c}", f"{c}1.npy"), pc)
        with open(os.path.join(base, "lists", f"{c}_test.list"), "w") as f:
            f.write("\n".join(names))
    return base
