"""PyTorch port vs the JAX package: the visual writers of ``zeroshape_tpu_torch.vis``
against ``zeroshape_tpu.vis`` (which writes through PIL, matplotlib and cv2).

Bounds: PLY (meshes, points, coloured and compared clouds), the seen-surface
OBJ/MTL and the HTML gallery byte-equal; image PNGs pixel-equal to PIL's;
depth PNGs equal to ``plt.imsave``'s RGBA on >= 99.9% of pixels and elsewhere
one colour-table step; the three colour tables exact over all 256 inputs;
``show_att_on_image`` within 1e-6; the TensorBoard grid equal. GIFs, decoded
by PIL: frames, durations and loop equal to the JAX writer's; mean |d| to
the source frames no worse than PIL's own GIF + 1/255; at most 3x PIL's
size; the demo's 272-frame 224^2 attention GIF written in 2 s at most.
"""

import io
import os
import time

import cv2
import matplotlib
import numpy as np
import pytest
from matplotlib import colormaps as mpl_colormaps
from PIL import Image, ImageSequence

from zeroshape_tpu import vis as jvis
from zeroshape_tpu_torch import gif, vis
from zeroshape_tpu_torch.ops import colormaps

matplotlib.use("Agg")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _same_files(a, b, names):
    for n in names:
        assert _read(os.path.join(a, n)) == _read(os.path.join(b, n)), n


@pytest.fixture
def dirs(tmp_path):
    return str(tmp_path / "port"), str(tmp_path / "jax")


def test_colour_tables_are_the_libraries():
    x = np.arange(256)
    assert np.array_equal(colormaps.VIRIDIS, mpl_colormaps["viridis"](x, bytes=True)[:, :3])
    assert np.array_equal(colormaps.JET, mpl_colormaps["jet"](x, bytes=True)[:, :3])
    assert np.array_equal(colormaps.CV2_JET, cv2.applyColorMap(x.astype(np.uint8)[:, None], cv2.COLORMAP_JET)[:, 0, ::-1])
    u = np.random.default_rng(0).uniform(-0.2, 1.2, 5000).astype(np.float32)
    u[:3] = (0.0, 1.0, 255 / 256)
    for table, name in ((colormaps.VIRIDIS, "viridis"), (colormaps.JET, "jet")):
        assert np.array_equal(colormaps.lookup(table, u), mpl_colormaps[name](u, bytes=True)[:, :3])


def test_ply_writers_are_byte_equal(dirs):
    port, jax_dir = dirs
    rng = np.random.default_rng(0)
    verts = rng.normal(size=(50, 3)).astype(np.float32)
    faces = rng.integers(0, 50, (40, 3)).astype(np.int32)
    pcs = rng.normal(size=(2, 30, 3)).astype(np.float32)
    gts = rng.normal(size=(2, 20, 3)).astype(np.float32)
    cols = rng.uniform(size=(2, 30, 1)).astype(np.float32)
    for mod, d in ((vis, port), (jvis, jax_dir)):
        mod.dump_meshes(d, [3, 7], "mesh", [(verts, faces), (np.zeros((0, 3)), np.zeros((0, 3)))])
        mod.dump_pointclouds(d, np.array([1, 2]), "pc", pcs)
        mod.dump_pointclouds(d, np.array([1, 2]), "pc_jet", pcs, colors=cols)
        mod.dump_pointclouds_compare(d, ["a", "b"], "cmp", pcs, gts)
    names = ["3_mesh.ply", "1_pc.ply", "2_pc.ply", "1_pc_jet.ply", "2_pc_jet.ply", "a_cmp.ply", "b_cmp.ply"]
    assert sorted(os.listdir(os.path.join(port, "dump"))) == sorted(os.listdir(os.path.join(jax_dir, "dump"))) == sorted(names)
    _same_files(os.path.join(port, "dump"), os.path.join(jax_dir, "dump"), names)


def test_seen_surface_obj_is_byte_equal(dirs):
    port, jax_dir = dirs
    rng = np.random.default_rng(1)
    H, W = 24, 20
    ys, xs = np.mgrid[0:H, 0:W]
    xyz = np.stack([xs * 0.002, ys * 0.002, 1.0 + 0.001 * rng.normal(size=(H, W))], -1).astype(np.float32)
    xyz[rng.uniform(size=(H, W)) < 0.15, 2] = -1.0  # holes
    xyz[10:, 12:, 2] += 0.02  # an edge wider than connect_thres
    xyz[3, :, 0] += 0.0045  # near the threshold
    for mod, d in ((vis, port), (jvis, jax_dir)):
        mod.dump_seen_surface(d, [5], "seen_surface", "image_input", [xyz], folder="preds")
    _same_files(os.path.join(port, "preds"), os.path.join(jax_dir, "preds"), ["5_seen_surface.obj", "5_seen_surface.mtl"])
    obj = _read(os.path.join(port, "preds", "5_seen_surface.obj")).decode()
    assert obj.count("\nf ") > 100 and obj.count("\nv ") == int((xyz[..., 2] > 0).sum())


def test_images_and_depths_against_pil_and_matplotlib(dirs):
    port, jax_dir = dirs
    rng = np.random.default_rng(2)
    imgs = rng.uniform(-0.1, 1.1, (2, 17, 23, 3)).astype(np.float32)
    masks = (rng.uniform(size=(2, 17, 23, 1)) > 0.3).astype(np.float32)
    depths = rng.uniform(0.3, 0.9, (2, 17, 23, 1)).astype(np.float32)
    for mod, d in ((vis, port), (jvis, jax_dir)):
        mod.dump_images(d, [0, 1], "image_input", imgs)
        mod.dump_images(d, [0, 1], "mask_input", masks)
        mod.dump_depths(d, [0, 1], "depth_est", depths, masks, rescale=True)
        mod.dump_depths(d, [0, 1], "depth_raw", depths)
    n_px = n_eq = 0
    for name in ("image_input", "mask_input", "depth_est", "depth_raw"):
        for i in (0, 1):
            got, want = (np.asarray(Image.open(os.path.join(d, "dump", f"{i}_{name}.png"))) for d in (port, jax_dir))
            assert got.shape == want.shape and got.dtype == want.dtype, (name, got.shape, want.shape)
            if name.startswith("depth"):
                assert got.shape[-1] == 4 and (got[..., 3] == 255).all()
                n_px += got.shape[0] * got.shape[1]
                n_eq += (got == want).all(-1).sum()
                step = np.abs(colormaps.VIRIDIS.astype(int)[1:] - colormaps.VIRIDIS[:-1]).max()
                assert np.abs(got.astype(int) - want).max() <= step
            else:
                np.testing.assert_array_equal(got, want)
    assert n_eq / n_px >= 0.999


def test_show_att_on_image_matches_cv2():
    rng = np.random.default_rng(3)
    img = rng.uniform(size=(30, 40, 3)).astype(np.float32)
    att = rng.uniform(size=(30, 40)).astype(np.float32)
    att /= att.max()
    np.testing.assert_allclose(vis.show_att_on_image(img, att), jvis.show_att_on_image(img, att), atol=1e-6, rtol=0)


class Recorder:
    def __init__(self):
        self.images = []

    def add_image(self, tag, img, step, dataformats="HWC"):
        self.images.append((tag, np.array(img), step, dataformats))


@pytest.mark.parametrize("n", [3, 12])
def test_tb_image_grid(n):
    rng = np.random.default_rng(4)
    imgs = rng.uniform(size=(n, 8, 6, 1)).astype(np.float32)
    got, want = Recorder(), Recorder()
    vis.tb_image(got, 5, "train", "depth_est_map", imgs, num_images=(2, 4))
    jvis.tb_image(want, 5, "train", "depth_est_map", imgs, num_images=(2, 4))
    (tg, g, sg, fg), (tw, w, sw, fw) = got.images[0], want.images[0]
    assert (tg, sg, fg) == (tw, sw, fw) and g.shape == w.shape
    np.testing.assert_array_equal(g, w)


def test_gallery_html_is_byte_equal(tmp_path):
    d = str(tmp_path)
    rng = np.random.default_rng(5)
    for i in range(12):
        vis.dump_images(d, [i], "image_input", rng.uniform(size=(1, 8, 8, 3)), folder="dump_synthetic")
    vis.dump_attentions(d, [0, 3], "attn", [[rng.uniform(size=(8, 8, 3)) for _ in range(3)]] * 2,
                        folder="dump_synthetic")
    vis.write_ply_points(os.path.join(d, "dump_synthetic", "0_pc.ply"), rng.normal(size=(4, 3)))
    for skip in (1, 10):
        vis.create_gif_html(os.path.join(d, "dump_synthetic"), os.path.join(d, f"port_{skip}.html"), skip)
        jvis.create_gif_html(os.path.join(d, "dump_synthetic"), os.path.join(d, f"jax_{skip}.html"), skip)
        assert _read(os.path.join(d, f"port_{skip}.html")) == _read(os.path.join(d, f"jax_{skip}.html"))
    assert _read(os.path.join(d, "port_10.html")).count(b"<tr>") == 2


def _decode(data):
    im = Image.open(io.BytesIO(data))
    return [np.asarray(f.convert("RGB")).astype(np.float32) for f in ImageSequence.Iterator(im)], im.info


def _attention_frames(n, H, seed):
    """Attention overlays of the demo's kind: a bilinear 14^2 map over an image."""
    rng = np.random.default_rng(seed)
    img = np.clip(np.kron(rng.uniform(0.1, 0.9, (14, 14, 3)), np.ones((H // 14, H // 14, 1))), 0, 1).astype(np.float32)
    frames = []
    for _ in range(n):
        att = cv2.resize(rng.uniform(size=(14, 14)).astype(np.float32), (H, H), interpolation=cv2.INTER_LINEAR)
        frames.append(jvis._to_uint8(jvis.show_att_on_image(img, att / att.max())))
    return np.stack(frames)


def _turntable_frames():
    from zeroshape_tpu_torch.ops import render
    from zeroshape_tpu_torch.ops.marching_cubes import marching_cubes_mesh
    import torch

    g = np.linspace(-1, 1, 20)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    v, f = marching_cubes_mesh((np.sqrt(X**2 + (1.4 * Y) ** 2 + Z**2) < 0.7).astype(np.float32))
    v = (v - v.mean(0)) / np.abs(v - v.mean(0)).max()
    tri = torch.from_numpy(render.mesh_triangles(v, f))
    return render.render_turntable(tri, torch.Generator().manual_seed(0), n_views=15, image_size=128,
                                   n_points=1 << 15, device="cpu").numpy()


@pytest.mark.parametrize("kind", ["attention", "turntable", "repeats"])
def test_gif_against_pil(tmp_path, kind):
    if kind == "attention":
        frames, duration = _attention_frames(12, 112, seed=6), 50
    elif kind == "turntable":
        frames, duration = _turntable_frames(), 100
    else:  # equal neighbours merge into one frame of their summed duration, as PIL does
        a = _attention_frames(3, 56, seed=7)
        frames, duration = np.stack([a[0], a[0], a[1], a[2], a[2], a[2]]), 50
    ours, theirs = str(tmp_path / "ours.gif"), str(tmp_path / "theirs.gif")
    vis.dump_gif(ours, frames, duration=duration)
    jvis.dump_gif(theirs, list(frames), duration=duration)
    got, got_info = _decode(_read(ours))
    want, want_info = _decode(_read(theirs))
    assert len(got) == len(want) and got_info["loop"] == want_info["loop"] == 0
    info = gif.info(ours)
    assert info["frames"] == len(want) and info["loop"] == 0 and info["size"] == frames.shape[2:0:-1]
    with Image.open(theirs) as im:
        want_durations = [f.info["duration"] for f in ImageSequence.Iterator(im)]
    assert info["durations"] == want_durations, (info["durations"], want_durations)
    # compare each decoded frame with the source frame it stands for
    src = [frames[0]] + [frames[i] for i in range(1, len(frames)) if not np.array_equal(frames[i], frames[i - 1])]
    err_got = np.mean([np.abs(g - s).mean() for g, s in zip(got, src)])
    err_want = np.mean([np.abs(w - s).mean() for w, s in zip(want, src)])
    assert err_got <= err_want + 1.0, (err_got, err_want)  # in uint8 units: PIL's + 1/255
    assert os.path.getsize(ours) <= 3 * os.path.getsize(theirs)


def test_the_demos_attention_gif_is_fast(tmp_path):
    frames = _attention_frames(272, 224, seed=8)
    vis.dump_gif(str(tmp_path / "warm.gif"), frames[:2])  # the first call builds the encoder
    t0 = time.perf_counter()
    vis.dump_gif(str(tmp_path / "attn.gif"), frames, duration=50)
    seconds = time.perf_counter() - t0
    assert gif.info(str(tmp_path / "attn.gif"))["frames"] == 272
    assert seconds <= 2.0, seconds
