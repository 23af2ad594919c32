"""Image and array utilities of the dataset loaders (counterpart of
``zeroshape_tpu/data/common.py``), NHWC numpy.

Decoding is :mod:`data.native`'s (zsdl or the port's PNG decoder, never
PIL). Where an image must change size, :func:`resize_u8` stands in for
PIL's ``Image.resize`` (bicubic with antialiasing, PIL's default filter):
torch's antialiased bicubic on the uint8 image. The two are not bit-equal:
within 2/255, on more than 99% of pixels equal (``tests/test_torch_port_data.py``).
:func:`write_png` replaces the writers' ``PIL.Image.save`` (the loaders' test
trees and the visual dumps of :mod:`zeroshape_tpu_torch.vis`).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from zeroshape_tpu_torch.data import native


def resize_u8(img, out_hw):
    """uint8 ``[H, W, C]`` -> uint8 ``[*out_hw, C]``: torch's antialiased bicubic
    on the uint8 image, which rounds to uint8 as PIL does (a float resize
    rounded afterwards lands up to 17/255 off PIL on sharp edges)."""
    x = torch.from_numpy(np.array(img, np.uint8)).permute(2, 0, 1)[None].contiguous(memory_format=torch.channels_last)
    y = torch.nn.functional.interpolate(x, size=tuple(out_hw), mode="bicubic", antialias=True, align_corners=False)
    return np.ascontiguousarray(y[0].permute(1, 2, 0).numpy())


def load_image(path, out_hw=None, mode="RGB"):
    """uint8 ``[H, W, C]`` of ``path`` in PIL's ``mode``, resized to ``out_hw``
    only where its size differs."""
    img = native.load_image(path, mode)
    if out_hw is not None and img.shape[:2] != tuple(out_hw):
        img = resize_u8(img, out_hw)
    return img


def to_float(img):
    """uint8 HWC -> float32 in [0, 1] (torchvision ``to_tensor``, NHWC)."""
    return img.astype(np.float32) / np.float32(255.0)


def load_rgb(path, out_hw=None):
    """float32 ``[H, W, 3]`` in [0, 1], decoded at the file's size and resized
    only when that differs from ``out_hw`` (``common.py:11-30``)."""
    return to_float(load_image(path, out_hw, "RGB"))


def load_npy_f32(path):
    return np.load(path).astype(np.float32)


def check_depth_size(depth, opt):
    """A stored depth map is not resized: it must be at the model's size."""
    if depth.shape[:2] != (opt.H, opt.W):
        raise ValueError(f"depth map of {depth.shape[:2]}, the model takes {(opt.H, opt.W)}")


def get_1d_bounds(arr):
    nz = np.flatnonzero(arr)
    return nz[0], nz[-1]


def get_bbox_from_mask(mask, thr=0.5, min_pixels=10):
    """``(x0, y0, x1, y1)``, the tight box of ``mask > thr``; None if nearly empty."""
    m = (mask > thr).astype(np.float32)
    if m.sum() <= min_pixels:
        return None
    x0, x1 = get_1d_bounds(m.sum(axis=-2))
    y0, y1 = get_1d_bounds(m.sum(axis=-1))
    return x0, y0, x1, y1


def erode_mask_np(mask_hw, iterations=5):
    """3x3 erosion, ``iterations`` times, backing off while it empties the
    mask (``cv2.erode`` with its default border, which never erodes; the
    reference's ``ocrtoc.py:103-110``)."""
    m = mask_hw.astype(np.uint8)
    while iterations > 0:
        eroded = m
        for _ in range(iterations):
            p = np.pad(eroded, 1, constant_values=255)
            H, W = eroded.shape
            eroded = np.min([p[dy: dy + H, dx: dx + W] for dy in range(3) for dx in range(3)], axis=0)
        if eroded.sum() > 0:
            return eroded.astype(np.float32)
        iterations -= 1
    return m.astype(np.float32)


def fixed_intrinsics(H, W, f=1.3875):
    return np.array([[f * W, 0, W / 2], [0, f * H, H / 2], [0, 0, 1]], dtype=np.float32)


def pose_from_Rt(Rt):
    """``[R|t]`` -> the loaders' 3x4 pose (``common.py:105-110``)."""
    pose = np.zeros((3, 4), np.float32)
    pose[:3, :3] = Rt[:3, :3]
    pose[:3, 3] = Rt[:3, 3]
    return pose


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def write_png(path, img):
    """Write uint8 ``[H, W]`` (L), ``[H, W, 3]`` (RGB) or ``[H, W, 4]`` (RGBA)
    as an 8-bit PNG, every row with filter 0 (none)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    h, w = img.shape[:2]
    color = 0 if img.ndim == 2 else {3: 2, 4: 6}[img.shape[-1]]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)
    with open(path, "wb") as f:
        f.write(native.PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))
