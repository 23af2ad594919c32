"""The port's image decoder (counterpart of ``zeroshape_tpu/data/native.py``).

Two decoders, and no third:

* ``csrc/zsdl.cpp`` (the port's copy of ``native/zsdl.cpp``), built at first
  use with ``g++ ... -lpng -ljpeg -lz -pthread`` into ``csrc/build/`` and
  bound with ctypes. It decodes PNG and JPEG outside the GIL.
* Where that library cannot be built (no libpng / libjpeg or their
  headers, as on a machine with only zlib), PNG files go through
  :func:`decode_png`, a decoder on the standard library's ``zlib`` and
  numpy that gives the same bytes as libpng for 8-bit gray, gray + alpha,
  RGB, RGBA and palette images, all five row filters. A JPEG then raises,
  naming what is missing. Nothing falls back to PIL.

Images come back as uint8 ``[H, W, C]`` in PIL's ``convert`` semantics of
the ``mode`` asked for: ``"RGB"`` (gray replicated, alpha dropped, palette
looked up) or ``"L"`` (colour by PIL's ``L = (19595 R + 38470 G + 7471 B +
2^15) >> 16``).
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import threading
import zlib

import numpy as np

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
LIB_PATH = os.path.join(CSRC, "build", "libzsdl.so")
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

_lib = None
_reason = None  # why zsdl is unavailable, once a build failed
_lock = threading.Lock()


def _build():
    """Compile ``csrc/zsdl.cpp`` into ``csrc/build/libzsdl.so`` (``native/Makefile:3``)."""
    src = os.path.join(CSRC, "zsdl.cpp")
    if os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= os.path.getmtime(src):
        return
    os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-fPIC", "-std=c++17", "-shared", "-o", tmp, src, "-lpng", "-ljpeg", "-lz", "-pthread"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise OSError(f"no C++ compiler to build zsdl ({e})") from e
    if res.returncode != 0:
        missing = [h for h in ("png.h", "jpeglib.h", "zlib.h", "-lpng", "-ljpeg", "-lz") if h in res.stderr]
        raise OSError(f"g++ could not build zsdl (missing {', '.join(missing) or 'see the compiler output'}):\n"
                      f"{res.stderr[-2000:]}")
    os.replace(tmp, LIB_PATH)


def library():
    """The loaded zsdl library, built first if needed; None when it cannot be
    built or loaded (:func:`unavailable_reason` says why)."""
    global _lib, _reason
    if _lib is not None or _reason is not None:
        return _lib
    with _lock:
        if _lib is not None or _reason is not None:
            return _lib
        try:
            _build()
            lib = ctypes.CDLL(LIB_PATH)
        except OSError as e:
            _reason = str(e)
            print(f"zsdl unavailable: PNG decodes with the port's zlib decoder, JPEG raises ({_reason.splitlines()[0]})")
            return None
        lib.zsdl_decode_image.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_float)]
        lib.zsdl_decode_image.restype = ctypes.c_int
        _lib = lib
    return _lib


def available():
    return library() is not None


def unavailable_reason():
    library()
    return _reason


# ---------------------------------------------------------------------------
# Headers: size and colour without decoding
# ---------------------------------------------------------------------------

def image_info(path):
    """``(kind, H, W, channels)`` from the file's header: ``kind`` is ``"png"``
    or ``"jpeg"``; ``channels`` the stored colour channels (a palette counts 3)."""
    with open(path, "rb") as f:
        head = f.read(33)
        if head[:8] == PNG_SIGNATURE:
            w, h, _, color = struct.unpack(">IIBB", head[16:26])
            return "png", h, w, {0: 1, 2: 3, 3: 3, 4: 2, 6: 4}[color]
        if head[:2] != b"\xff\xd8":
            raise ValueError(f"{path}: neither PNG nor JPEG")
        f.seek(2)
        while True:
            marker = f.read(2)
            if len(marker) < 2 or marker[0] != 0xFF:
                raise ValueError(f"{path}: no JPEG frame header")
            if marker[1] in (0xD8, 0x01) or 0xD0 <= marker[1] <= 0xD7:
                continue
            (length,) = struct.unpack(">H", f.read(2))
            if 0xC0 <= marker[1] <= 0xCF and marker[1] not in (0xC4, 0xC8, 0xCC):
                _, h, w, comps = struct.unpack(">BHHB", f.read(6))
                return "jpeg", h, w, comps
            f.seek(length - 2, 1)


# ---------------------------------------------------------------------------
# The port's PNG decoder (standard-library zlib + numpy)
# ---------------------------------------------------------------------------

def _paeth(a, b, c):
    a, b, c = (x.astype(np.int16) for x in (a, b, c))
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c)).astype(np.uint8)


def _unfilter(raw, h, stride, bpp):
    """Undo the per-row filters of the inflated scanlines ``raw``
    ([h, 1 + stride] uint8, the filter byte first)."""
    kinds = raw[:, 0]
    data = raw[:, 1:]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {int(kinds.max())} is not one of 0-4")
    if not np.isin(kinds, (3, 4)).any():
        out = np.empty_like(data)
        prev = np.zeros(stride, np.uint8)
        for y in range(h):  # none, sub and up are whole-row operations
            row, k = data[y], kinds[y]
            if k == 1:
                row = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
            elif k == 2:
                row = row + prev
            out[y] = prev = row
        return out
    # average and Paeth read the left neighbour: walk the anti-diagonals of
    # the pixel grid, on which no pixel depends on another
    w = stride // bpp
    px = data.reshape(h, w, bpp)
    out = np.zeros((h + 1, w + 1, bpp), np.uint8)  # a zero row above and column left
    ys_all = np.arange(h)
    for d in range(h + w - 1):
        ys = ys_all[max(0, d - w + 1): min(h, d + 1)]
        xs = d - ys
        a, b, c = out[ys + 1, xs], out[ys, xs + 1], out[ys, xs]
        k = kinds[ys][:, None]
        pred = np.where(k == 1, a, np.where(k == 2, b, np.where(
            k == 3, ((a.astype(np.uint16) + b) >> 1).astype(np.uint8), np.where(k == 4, _paeth(a, b, c), 0))))
        out[ys + 1, xs + 1] = px[ys, xs] + pred.astype(np.uint8)
    return out[1:, 1:].reshape(h, stride)


def decode_png(path):
    """An 8-bit PNG as uint8 ``[H, W, C]``: C = 1 gray, 2 gray + alpha, 3 RGB,
    4 RGBA; a palette image gives RGB, or RGBA where it has a ``tRNS``
    chunk (as libpng's ``png_set_palette_to_rgb`` + ``png_set_tRNS_to_alpha``)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, palette, trns, ihdr = 8, [], None, None, None
    while pos < len(buf):
        length, kind = struct.unpack(">I4s", buf[pos: pos + 8])
        body = buf[pos + 8: pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, color, _, _, interlace = ihdr
    if depth != 8 or interlace != 0:
        raise ValueError(f"{path}: the port's PNG decoder reads 8-bit, non-interlaced images "
                         f"(bit depth {depth}, interlace {interlace})")
    bpp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw[: h * (1 + w * bpp)].reshape(h, 1 + w * bpp), h, w * bpp, bpp).reshape(h, w, bpp)
    if color == 3:
        idx = img[..., 0]
        rgb = palette[idx]
        if trns is None:
            return rgb
        alpha = np.full(len(palette), 255, np.uint8)
        alpha[: len(trns)] = trns[: len(palette)]
        return np.concatenate([rgb, alpha[idx][..., None]], axis=-1)
    if trns is not None and color in (0, 2):  # a colour key: libpng's tRNS -> alpha
        key = np.frombuffer(trns.tobytes(), ">u2").astype(np.uint8)
        alpha = np.where((img == key).all(axis=-1), 0, 255).astype(np.uint8)
        return np.concatenate([img, alpha[..., None]], axis=-1)
    return img


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------

def to_mode(img, mode):
    """uint8 ``[H, W, C]`` (C = 1-4) -> PIL's ``convert(mode)`` for ``"RGB"`` / ``"L"``."""
    c = img.shape[-1]
    if mode == "RGB":
        return np.repeat(img[..., :1], 3, axis=-1) if c <= 2 else np.ascontiguousarray(img[..., :3])
    if mode == "L":
        if c <= 2:
            return np.ascontiguousarray(img[..., :1])
        rgb = img[..., :3].astype(np.uint32)
        return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)[
            ..., None]
    raise ValueError(f"mode {mode!r} is not RGB or L")


def _zsdl_decode(lib, path, h, w, channels):
    out = np.empty((h, w, channels), np.float32)
    if lib.zsdl_decode_image(path.encode(), h, w, channels, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))):
        raise ValueError(f"zsdl could not decode {path}")
    return np.rint(out * 255.0).astype(np.uint8)


def load_image(path, mode="RGB"):
    """The image at ``path`` as uint8 ``[H, W, 3]`` (``"RGB"``) or ``[H, W, 1]``
    (``"L"``) at its own size: zsdl where it is built, else the port's PNG
    decoder; a JPEG without zsdl raises."""
    kind, h, w, c = image_info(path)
    lib = library()
    if lib is not None:
        # zsdl's channel fan-out repeats the last channel: ask it for what
        # PIL's convert reads (gray for gray sources, RGB for colour ones)
        return to_mode(_zsdl_decode(lib, path, h, w, 1 if c <= 2 else 3), mode)
    if kind == "png":
        return to_mode(decode_png(path), mode)
    raise RuntimeError(f"cannot decode the JPEG {path}: zsdl, the port's JPEG decoder, is not built "
                       f"({unavailable_reason().splitlines()[0]})")

