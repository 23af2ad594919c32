"""The port's data layer against the JAX package's: the image decoders, the
four dataset loaders on trees written in each layout, the loader's batches
and per-process slices, the analytic tree writer with held-out objects, and
the profiler schedule.

Tolerances: PNG and ``.npy`` samples are bit-equal; an image resized to the
model's size (PIL's bicubic in the JAX package, torch's antialiased bicubic
in the port) within 3/255, its mask on >= 99.5% of pixels; a JPEG decoded by
zsdl and by PIL within 3/255.
"""

import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from zeroshape_tpu.config import Config as JConfig
from zeroshape_tpu_torch.config import Config
from zeroshape_tpu_torch.data import base, common, native

from test_torch_harness import data_opt, write_ocrtoc, write_pix3d

RESIZE_TOL = 3 / 255


def _equal_samples(got, want, tol=0.0, path=""):
    assert list(got) == list(want), (path, list(got), list(want))
    for k, v in want.items():
        if isinstance(v, dict):
            _equal_samples(got[k], v, tol, path + k + ".")
            continue
        g, w = np.asarray(got[k]), np.asarray(v)
        assert g.dtype == w.dtype and g.shape == w.shape, (path + k, g.dtype, w.dtype, g.shape, w.shape)
        if tol and k == "rgb_input_map":
            assert np.abs(g - w).max() <= tol, (path + k, np.abs(g - w).max())
        elif tol and k == "mask_input_map":
            assert (g == w).mean() >= 0.995, (path + k, (g == w).mean())
        else:
            np.testing.assert_array_equal(g, w, err_msg=path + k)


# ---------------------------------------------------------------------------
# decoders
# ---------------------------------------------------------------------------

def _png_with_filters(path, img, color, palette=None):
    """An 8-bit PNG whose rows cycle through the five filters (libpng and PIL
    write adaptive filters, never all five in one image)."""
    h, w = img.shape[:2]
    bpp = img.shape[2] if img.ndim == 3 else 1
    rows = img.reshape(h, w * bpp).astype(np.int32)
    out, prev = [], np.zeros(w * bpp, np.int32)
    for y in range(h):
        kind, x = y % 5, rows[y]
        a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (a + prev) // 2
        else:
            p = a + prev - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        out.append(bytes([kind]) + ((x - pred) % 256).astype(np.uint8).tobytes())
        prev = x

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    data = native.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
    if palette is not None:
        data += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    with open(path, "wb") as f:
        f.write(data + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("color, channels", [(0, 1), (4, 2), (2, 3), (6, 4), (3, 1)])
def test_png_decoder_is_exact_for_every_color_type_and_filter(tmp_path, color, channels):
    """The port's zlib + numpy PNG decoder, zsdl and PIL give the same pixels,
    in both modes, for each color type with rows of all five filters."""
    rng = np.random.default_rng(color)
    smooth = np.add.outer(np.arange(23), np.arange(31)) * 4 % 256
    img = ((smooth[..., None] + rng.integers(0, 40, (23, 31, channels))) % 256).astype(np.uint8)
    palette = rng.integers(0, 256, (256, 3)) if color == 3 else None
    path = str(tmp_path / "f.png")
    _png_with_filters(path, img[..., 0] if channels == 1 else img, color, palette)
    for mode in ("RGB", "L"):
        want = np.asarray(Image.open(path).convert(mode)).reshape(23, 31, -1)
        np.testing.assert_array_equal(native.to_mode(native.decode_png(path), mode), want)
        np.testing.assert_array_equal(native.load_image(path, mode), want)


def test_without_zsdl_png_decodes_and_jpeg_raises(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (20, 24, 3), dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "a.png")
    Image.fromarray(img).save(tmp_path / "a.jpg", quality=95)
    assert native.available()  # libpng / libjpeg here
    np.testing.assert_array_equal(native.load_image(str(tmp_path / "a.png")), img)
    jpeg = native.load_image(str(tmp_path / "a.jpg")).astype(int)
    assert np.abs(jpeg - np.asarray(Image.open(tmp_path / "a.jpg"))).max() <= 3
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_reason", "g++ could not build zsdl (missing png.h, jpeglib.h)")
    np.testing.assert_array_equal(common.load_image(str(tmp_path / "a.png")), img)
    with pytest.raises(RuntimeError, match="cannot decode the JPEG .*missing png.h, jpeglib.h"):
        common.load_rgb(str(tmp_path / "a.jpg"))
    arr = rng.normal(size=(5, 3)).astype(np.float32)
    np.save(tmp_path / "a.npy", arr)
    np.testing.assert_array_equal(common.load_npy_f32(str(tmp_path / "a.npy")), arr)


def test_resize_erosion_and_writer_against_pil_and_cv2(tmp_path):
    from zeroshape_tpu.data.common import erode_mask_np

    rng = np.random.default_rng(1)
    img = np.asarray(Image.fromarray(rng.integers(0, 256, (12, 16, 3), dtype=np.uint8)).resize((70, 50)))
    for size in ((32, 32), (64, 90)):
        want = np.asarray(Image.fromarray(img).resize(size[::-1]))
        assert np.abs(common.resize_u8(img, size).astype(int) - want).max() <= 3
    mask = np.zeros((40, 40), np.float32)
    mask[5:30, 8:33] = rng.uniform(size=(25, 25)) > 0.1
    for it in (1, 2, 10, 40):
        np.testing.assert_array_equal(common.erode_mask_np(mask, it), erode_mask_np(mask, it))
    for arr in (img, img[..., 1]):
        common.write_png(str(tmp_path / "w.png"), arr)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "w.png")), arr)


# ---------------------------------------------------------------------------
# loaders against the JAX loaders
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The analytic tree of each package's writer (3 + 2 held-out objects)."""
    from zeroshape_tpu.data.analytic import generate_dataset as jax_generate
    from zeroshape_tpu_torch.data.analytic import generate_dataset

    kw = dict(n_objects=3, n_views=3, H=32, seed=0, n_pc_points=200, n_sdf_points=300, holdout_objects=2)
    jax_root, port_root = tmp_path_factory.mktemp("jax_tree"), tmp_path_factory.mktemp("port_tree")
    jax_generate(str(jax_root), **kw)
    generate_dataset(str(port_root), **kw)
    return jax_root, port_root, kw


@pytest.mark.parametrize("split", ["train", "test"])
def test_synthetic_loader_and_generator_match_jax(trees, split):
    """The port's ``SyntheticDataset`` on the JAX writer's tree, and the JAX
    ``SyntheticDataset`` on the port writer's tree, against the JAX loader
    on the JAX tree: bit-equal samples in two epochs, held-out categories
    included; ``id_filename_mapping`` byte-equal."""
    from zeroshape_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
    from zeroshape_tpu_torch.data.synthetic import SyntheticDataset

    jax_root, port_root, _ = trees
    want = JaxSynthetic(JConfig(data_opt(jax_root)), split=split)
    ours = SyntheticDataset(Config(data_opt(jax_root)), split=split)
    theirs = JaxSynthetic(JConfig(data_opt(port_root)), split=split)
    assert want.label2cat == ours.label2cat == theirs.label2cat == ["ho0", "ho1", "prim"]
    assert len(want) == len(ours) == len(theirs) == (6 if split == "train" else 3 + 6)
    for epoch in (0, 1):
        for d in (want, ours, theirs):
            d.set_epoch(epoch)
        for i in range(len(want)):
            _equal_samples(ours[i], want[i])
            _equal_samples(theirs[i], want[i])
    want.id_filename_mapping(None, str(port_root / "want.txt"))
    ours.id_filename_mapping(None, str(port_root / "ours.txt"))
    assert open(port_root / "ours.txt").read() == open(port_root / "want.txt").read()


def test_train_samples_with_held_out_objects_match_the_loader(trees):
    """``train_samples`` with held-out objects: the validation samples per
    category (``ho*`` first, at most 10 each) and the training samples."""
    from zeroshape_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
    from zeroshape_tpu_torch.data.analytic import train_samples

    jax_root, _, kw = trees
    ours = train_samples(**kw)
    opt = data_opt(jax_root)
    ours.setup_loader(Config(opt))
    assert ours.label2cat == ["ho0", "ho1", "prim"]
    train, val = JaxSynthetic(JConfig(opt), split="train"), JaxSynthetic(JConfig(opt), split="test")
    for i in range(len(train)):
        got, want = ours[i], train[i]
        assert set(got) <= set(want)
        for k, v in got.items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert len(ours.val) == len(val)
    for got, i in zip(ours.val, range(len(val))):
        want = val[i]
        for k in ("idx", "category_label", "pose_gt", "rgb_input_map", "mask_input_map", "depth_input_map", "intr"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got["dpc"]["points"], want["dpc"]["points"])


@pytest.mark.parametrize("ext", [".png", ".jpg"])
def test_pix3d_loader_matches_jax(tmp_path, ext):
    """Images of 48^2 resized to 32^2: RGB within 3/255 of PIL's bicubic,
    masks equal on >= 99.5% of pixels; everything else bit-equal."""
    from zeroshape_tpu.data.pix3d import Pix3DDataset as JaxPix3D
    from zeroshape_tpu_torch.data.pix3d import Pix3DDataset

    write_pix3d(str(tmp_path), ext=ext)
    opt = data_opt(tmp_path, pix3d={"cat": "chair,sofa"})
    want, ours = JaxPix3D(JConfig(opt)), Pix3DDataset(Config(opt))
    assert ours.label2cat == want.label2cat == ["chair", "sofa"] and len(ours) == len(want) == 4
    for i in range(len(want)):
        _equal_samples(ours[i], want[i], tol=RESIZE_TOL)
    want.id_filename_mapping(None, str(tmp_path / "want.txt"))
    ours.id_filename_mapping(None, str(tmp_path / "ours.txt"))
    assert open(tmp_path / "ours.txt").read() == open(tmp_path / "want.txt").read()


@pytest.mark.parametrize("name", ["ocrtoc", "omniobj3d"])
def test_ocrtoc_and_omniobj3d_loaders_match_jax(tmp_path, name):
    """Bit-equal samples (eroded masks in OCRTOC), the subsample, the data list."""
    import importlib

    jax_mod = importlib.import_module(f"zeroshape_tpu.data.{name}")
    port_mod = importlib.import_module(f"zeroshape_tpu_torch.data.{name}")
    if name == "ocrtoc":
        write_ocrtoc(str(tmp_path))
    else:
        write_ocrtoc(str(tmp_path), "OmniObject3D", "depth")
    opt = data_opt(tmp_path)
    want, ours = jax_mod.Dataset(JConfig(opt)), port_mod.Dataset(Config(opt))
    assert len(ours) == len(want) == (4 if name == "ocrtoc" else 12) and ours.label2cat == want.label2cat
    for i in range(len(want)):
        _equal_samples(ours[i], want[i])
    assert ("mask_eroded" in ours[0]) == (name == "ocrtoc")
    want.id_filename_mapping(None, str(tmp_path / "want.txt"))
    ours.id_filename_mapping(None, str(tmp_path / "ours.txt"))
    assert open(tmp_path / "ours.txt").read() == open(tmp_path / "want.txt").read()


@pytest.mark.parametrize("n, batch, drop_last, shuffle", [(10, 4, False, False), (12, 4, False, True),
                                                          (10, 4, True, True), (9, 8, False, True)])
@pytest.mark.parametrize("world", [1, 2, 4])
def test_loader_batches_and_rank_slices_match_jax(n, batch, drop_last, shuffle, world):
    """Each rank's batch indices equal the JAX loader's for its process,
    an uneven tail padded to the full global batch."""
    from zeroshape_tpu.data.base import DataLoader as JaxLoader

    data = list(range(n))
    for rank in range(world):
        kw = dict(batch_size=batch, shuffle=shuffle, drop_last=drop_last, seed=5, process_index=rank,
                  process_count=world)
        ours, want = base.DataLoader(data, **kw), JaxLoader(data, **kw)
        for epoch in (0, 3):
            ours.set_epoch(epoch)
            want.set_epoch(epoch)
            got = ours._batch_indices()
            assert len(got) == len(want._batch_indices()) == (len(ours) if world == 1 else len(got))
            for g, w in zip(got, want._batch_indices(), strict=True):
                np.testing.assert_array_equal(g, w)


def test_loader_threads_epochs_errors_and_abandon():
    class Data(base.Dataset):
        def __init__(self):
            super().__init__(None)

        def __len__(self):
            return 7

        def __getitem__(self, i):
            if i == 5 and self._epoch == 1:
                raise KeyError("sample 5")
            return {"x": np.full(2, i + 10 * self._epoch, np.float32), "n": {"i": np.int64(i)}, "s": str(i)}

    loader = base.DataLoader(Data(), batch_size=3, num_workers=3, prefetch=1)
    batches = list(loader)
    assert [b["n"]["i"].tolist() for b in batches] == [[0, 1, 2], [3, 4, 5], [6]]
    assert batches[1]["s"] == ["3", "4", "5"] and batches[0]["x"].shape == (3, 2)
    assert [b["n"]["i"].tolist() for b in loader.epoch(skip=2)] == [[6]]
    loader.set_epoch(1)
    with pytest.raises(KeyError, match="sample 5"):
        list(loader)
    it = loader.epoch()
    assert next(it)["x"][0, 0] == 10
    it.close()  # the producer stops instead of blocking on the full queue
    assert loader.wait >= 0


# ---------------------------------------------------------------------------
# the profiler schedule (tests/test_profiler_schedule.py's two cases)
# ---------------------------------------------------------------------------

def _schedule(monkeypatch, tmp_path):
    """The schedule on a real ``torch.profiler`` session (CPU activity), its
    trace handler replaced by a recorder of the windows it is asked to write."""
    from zeroshape_tpu_torch.runtime import engine_base

    written = []
    monkeypatch.setattr(torch.profiler, "tensorboard_trace_handler",
                        lambda logdir: lambda prof: written.append((logdir, prof.step_num)))
    monkeypatch.chdir(tmp_path)
    return engine_base.ProfilerSchedule(), written


def test_profiler_schedule_windows(monkeypatch, tmp_path):
    schedule, written = _schedule(monkeypatch, tmp_path)
    steps_ran = 0
    with pytest.raises(SystemExit):
        for _ in range(100):
            torch.ones(4).sum()  # the step
            steps_ran += 1
            schedule.step()
    assert steps_ran == 22  # (wait 3 + warmup 3 + active 5) x 2, then the exit
    # window 0 traced steps 6-10 and is written after them, window 1 steps 17-21
    assert written == [(os.path.join("debug", "profiler_log", "window_0"), 11),
                       (os.path.join("debug", "profiler_log", "window_1"), 22)]
    assert schedule.prof is None


def test_profiler_close_flushes_open_window(monkeypatch, tmp_path):
    schedule, written = _schedule(monkeypatch, tmp_path)
    for _ in range(7):  # wait 3 + warmup 3 + the first traced step: the trace is open
        torch.ones(4).sum()
        schedule.step()
    assert written == []
    schedule.close()
    assert written == [(os.path.join("debug", "profiler_log", "window_0"), 7)]
    schedule.close()  # idempotent
    assert len(written) == 1
