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


PIL_PRECISION_BITS = 22  # fixed-point bits of PIL's 8-bit resampling (Resample.c)


def _pil_bicubic(x):
    x = np.abs(x)
    return np.where(x < 1.0, ((1.5 * x - 2.5) * x) * x + 1.0,
                    np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * -0.5, 0.0))


def _pil_coefficients(in_size, out_size):
    """``(first tap [out], fixed-point weights [out, taps])`` of PIL's bicubic
    resampling of one axis (``precompute_coeffs``, ``normalize_coeffs_8bpc``)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    taps = np.arange(int(np.ceil(support)) * 2 + 1)
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    n = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    w = _pil_bicubic(((taps[None] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(taps[None] < n[:, None], w, 0.0)
    total = np.zeros(out_size)
    for t in taps:  # summed in PIL's order
        total = total + w[:, t]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    scaled = w * float(1 << PIL_PRECISION_BITS)
    return xmin, np.trunc(np.where(w < 0, scaled - 0.5, scaled + 0.5)).astype(np.int64)


def _pil_resample_axis(img, out_size, axis):
    """One pass of PIL's 8-bit bicubic resampling along ``axis`` (0 or 1) of uint8 ``[H, W, C]``."""
    xmin, k = _pil_coefficients(img.shape[axis], out_size)
    idx = np.minimum(xmin[:, None] + np.arange(k.shape[1])[None], img.shape[axis] - 1)
    x = np.moveaxis(img.astype(np.int64), axis, 0)[idx]  # [out, taps, other, C]
    acc = (1 << (PIL_PRECISION_BITS - 1)) + np.einsum("otwc,ot->owc", x, k)
    return np.moveaxis(np.clip(acc >> PIL_PRECISION_BITS, 0, 255).astype(np.uint8), 0, axis)


def resize_u8_pil(img, out_hw):
    """uint8 ``[H, W, C]`` -> uint8 ``[*out_hw, C]`` bit for bit as PIL's
    ``Image.resize`` with its default bicubic filter: the horizontal pass,
    then the vertical one, each rounded to 8 bits, on PIL's fixed-point
    weights (``Resample.c``). Numpy on the host."""
    img = np.asarray(img, np.uint8)
    if img.shape[1] != out_hw[1]:
        img = _pil_resample_axis(img, out_hw[1], 1)
    if img.shape[0] != out_hw[0]:
        img = _pil_resample_axis(img, out_hw[0], 0)
    return img


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


def square_crop(arr, bbox, expand=1.2):
    """The 1.2x square crop of ``arr [H, W, ...]`` around ``bbox`` (``x0, y0,
    x1, y1``); out-of-bounds regions become zeros (``common.py:64-83``)."""
    x1, y1, x2, y2 = bbox
    yc, xc = (y1 + y2) / 2, (x1 + x2) / 2
    S = max(y2 - y1, x2 - x1) * expand
    top, left, size = int(yc - S / 2), int(xc - S / 2), int(S)
    out = np.zeros((size, size) + arr.shape[2:], arr.dtype)
    y0, x0 = max(top, 0), max(left, 0)
    y1_, x1_ = min(top + size, arr.shape[0]), min(left + size, arr.shape[1])
    if y1_ > y0 and x1_ > x0:
        out[y0 - top : y1_ - top, x0 - left : x1_ - left] = arr[y0:y1_, x0:x1_]
    return out


def resize_rgba(rgba, out_hw):
    """PIL's resize of an RGBA image, bit for bit: to premultiplied ``RGBa``
    (``c * a / 255`` rounded), resized (:func:`resize_u8_pil`), and back
    (``255 * c // a``, clipped; unchanged where a is 0 or 255)."""
    a = rgba[..., 3:].astype(np.int32)
    t = rgba[..., :3].astype(np.int32) * a + 128
    pm = np.concatenate([((t >> 8) + t) >> 8, a], axis=-1).astype(np.uint8)
    out = resize_u8_pil(pm, out_hw).astype(np.int32)
    a = out[..., 3:]
    rgb = np.where((a == 0) | (a == 255), out[..., :3], np.minimum(255 * out[..., :3] // np.maximum(a, 1), 255))
    return np.concatenate([rgb, a], axis=-1).astype(np.uint8)


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
