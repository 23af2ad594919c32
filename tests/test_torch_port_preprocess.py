"""``python -m zeroshape_tpu_torch.preprocess`` against ``python preprocess.py``.

Both CLIs run as fresh processes on one input directory: two of
``examples/`` pasted onto a textured background off-centre, one saved as an
RGBA PNG (its alpha dropped on reading, as PIL's ``convert("RGB")`` drops
it), one as a JPEG; and a flat image whose GrabCut mask is empty. Fresh
processes matter: GrabCut's k-means draws from OpenCV's per-process RNG, so
both CLIs call it in the same order from its default state. The two must
write the same files and print the same messages; masks equal on >= 99.5%
of pixels and RGB within 3/255 (the demo's resize bound; the port's resize
is PIL's bit for bit, and on these inputs the outputs are equal)."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("prim_box1", "prim_capsule3")
WRITTEN = ("a_prim_box1", "b_prim_capsule3")


def _texture(H, W, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    base = (0.5 + 0.25 * np.sin(xx / 7.0)[..., None] * np.array([1.0, 0.6, 0.3])
            + 0.25 * np.cos(yy / 11.0)[..., None] * np.array([0.2, 0.7, 1.0]))
    return np.clip(base + rng.normal(0, 0.04, (H, W, 3)), 0, 1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("preprocess")
    indir = root / "in"
    indir.mkdir()
    for i, name in enumerate(EXAMPLES):
        img = np.asarray(Image.open(os.path.join(REPO, "examples/images", name + ".png")).convert("RGB")) / 255.0
        m = (np.asarray(Image.open(os.path.join(REPO, "examples/masks", name + ".png")).convert("L")) > 127)[..., None]
        H, W = img.shape[:2]
        canvas = _texture(320, 360, i)
        y0, x0 = 40 + 20 * i, 60
        canvas[y0:y0 + H, x0:x0 + W] = np.where(m, img, canvas[y0:y0 + H, x0:x0 + W])
        out = (canvas * 255).round().astype(np.uint8)
        if i == 0:
            alpha = np.full(out.shape[:2] + (1,), 255, np.uint8)
            alpha[:10] = 0
            Image.fromarray(np.concatenate([out, alpha], -1), "RGBA").save(indir / f"a_{name}.png")
        else:
            Image.fromarray(out).save(indir / f"b_{name}.jpg", quality=92)
    Image.fromarray(np.full((96, 128, 3), (120, 130, 140), np.uint8)).save(indir / "c_flat.png")
    env = dict(os.environ, PYTHONPATH=REPO)
    got = {}
    for which, cmd in (("jax", [os.path.join(REPO, "preprocess.py")]),
                       ("port", ["-m", "zeroshape_tpu_torch.preprocess"])):
        cwd = root / which
        cwd.mkdir()
        out = subprocess.run([sys.executable, *cmd, f"--indir={indir}", "--outdir=out"], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        got[which] = (out.stdout.splitlines(), cwd / "out")
    return got


def _read(path):
    from PIL import Image

    return np.asarray(Image.open(path)).astype(np.int64)


def test_same_messages(runs):
    assert runs["port"][0] == runs["jax"][0]
    assert runs["jax"][0] == ["rembg not installed; using cv2 GrabCut fallback", "processed a_prim_box1.png",
                              "processed b_prim_capsule3.jpg", "skipping c_flat.png: empty mask",
                              "wrote out/images and out/masks"]


def test_same_files(runs):
    for sub in ("images", "masks"):
        want = sorted(os.listdir(runs["jax"][1] / sub))
        assert sorted(os.listdir(runs["port"][1] / sub)) == want == [n + ".png" for n in WRITTEN]


@pytest.mark.parametrize("name", WRITTEN)
def test_masks_agree(runs, name):
    want, got = (_read(runs[w][1] / "masks" / (name + ".png")) for w in ("jax", "port"))
    assert got.shape == want.shape == (224, 224)
    assert (got == want).mean() >= 0.995
    assert 0.05 < (want > 127).mean() < 0.95  # an object, not an empty or full frame


@pytest.mark.parametrize("name", WRITTEN)
def test_images_agree(runs, name):
    want, got = (_read(runs[w][1] / "images" / (name + ".png")) for w in ("jax", "port"))
    assert got.shape == want.shape == (224, 224, 3)
    assert np.abs(got - want).max() <= 3


def test_jpeg_is_read_without_its_exif_rotation(tmp_path):
    """PIL's ``Image.open`` ignores the EXIF orientation; so must the port's
    JPEG reading (``cv2.imread`` would rotate by it)."""
    from PIL import Image

    from zeroshape_tpu_torch.preprocess import read_rgb

    rng = np.random.default_rng(1)
    img = (np.clip(_texture(60, 90, 2) + rng.normal(0, 0.01, (60, 90, 3)), 0, 1) * 255).astype(np.uint8)
    exif = Image.Exif()
    exif[0x0112] = 6  # rotate 90 degrees clockwise to display
    path = str(tmp_path / "rotated.jpg")
    Image.fromarray(img).save(path, quality=95, exif=exif)
    want = np.asarray(Image.open(path).convert("RGB")).astype(np.int64)
    got = read_rgb(path).astype(np.int64)
    assert got.shape == want.shape == (60, 90, 3)
    assert np.abs(got - want).max() <= 3


@pytest.mark.parametrize("hw, out, mode", [((37, 53), (224, 224), "RGBA"), ((301, 280), (224, 224), "RGBA"),
                                           ((640, 480), (224, 224), "RGBA"), ((90, 70), (33, 120), "RGB"),
                                           ((16, 400), (16, 31), "L")])
def test_resize_is_pil_bit_for_bit(hw, out, mode):
    """``data.common.resize_rgba`` / ``resize_u8_pil`` against PIL's
    ``Image.resize`` (bicubic, premultiplied for RGBA): equal, up- and
    downscaling, one axis alone."""
    from PIL import Image

    from zeroshape_tpu_torch.data import common

    rng = np.random.default_rng(sum(hw))
    C = {"RGBA": 4, "RGB": 3, "L": 1}[mode]
    img = rng.integers(0, 256, hw + (C,)).astype(np.uint8)
    if mode == "RGBA":  # transparent and partly transparent pixels
        img[..., 3] = np.where(rng.uniform(size=hw) < 0.3, 0, img[..., 3])
        got = common.resize_rgba(img, out)
    else:
        got = common.resize_u8_pil(img, out)
    want = np.asarray(Image.fromarray(img[..., 0] if C == 1 else img, mode).resize(out[::-1]))
    np.testing.assert_array_equal(got, want.reshape(got.shape))
