"""GIF files without PIL: :func:`write` encodes RGB frames through
``csrc/gif.cpp`` (built with ``g++`` at first use into ``csrc/build/``, bound
with ctypes; a failed build raises), and :func:`info` walks a GIF's blocks.

The encoder does what ``PIL.Image.save(format="GIF", save_all=True,
duration=..., loop=0)`` does for the JAX package's dumps: an adaptive palette
of at most 256 colours a frame, equal neighbouring frames merged (their
durations summed), later frames cropped to what changed, a looping GIF89a.
Its palettes and LZW stream are its own, so the bytes differ from PIL's.
"""

from __future__ import annotations

import ctypes

import numpy as np

from zeroshape_tpu_torch.ops import _build

_SIGNATURES = {
    "zs_gif_encode": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int64],
}


def _library():
    return _build.library("gif.cpp", "zsgif", _SIGNATURES, restype=ctypes.c_int64)


def encode(frames, duration=100):
    """The GIF bytes of ``frames`` (a sequence of uint8 ``[H, W, 3]``, or one
    ``[N, H, W, 3]`` array), each shown ``duration`` ms (PIL's
    ``int(duration / 10)`` hundredths of a second), looping forever."""
    frames = np.ascontiguousarray(np.stack([np.asarray(f) for f in frames]) if isinstance(frames, (list, tuple))
                                  else frames, np.uint8)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"frames of shape {frames.shape}, want [N, H, W, 3]")
    n, H, W, _ = frames.shape
    delays = np.full(n, int(duration / 10), np.int32)
    # a frame takes at most 12 bits a pixel, its sub-block lengths, a palette and its headers
    cap = n * (H * W * 2 + 4096) + 4096
    out = np.empty(cap, np.uint8)
    size = _library().zs_gif_encode(frames.ctypes.data, n, H, W, delays.ctypes.data, out.ctypes.data, cap)
    if not 0 < size <= cap:
        raise RuntimeError(f"zs_gif_encode returned {size} for frames of shape {frames.shape} ({cap} bytes of room)")
    return out[:size].tobytes()


def write(path, frames, duration=100):
    with open(path, "wb") as f:
        f.write(encode(frames, duration))


def info(data):
    """``{"frames", "durations" (ms), "loop", "size" (W, H)}`` of GIF bytes (or
    a path), read by walking its blocks; raises on a malformed file."""
    if isinstance(data, str):
        with open(data, "rb") as f:
            data = f.read()
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF")
    W, H, flags = int.from_bytes(data[6:8], "little"), int.from_bytes(data[8:10], "little"), data[10]
    pos = 13 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
    frames, durations, loop, delay = 0, [], None, 0

    def skip_sub_blocks(p):
        while data[p]:
            p += data[p] + 1
        return p + 1

    while True:
        kind = data[pos]
        if kind == 0x3B:
            break
        if kind == 0x21:
            label, size = data[pos + 1], data[pos + 2]
            if label == 0xF9:
                delay = int.from_bytes(data[pos + 4:pos + 6], "little")
            elif label == 0xFF and data[pos + 3:pos + 3 + size] == b"NETSCAPE2.0":
                loop = int.from_bytes(data[pos + 3 + size + 2:pos + 3 + size + 4], "little")
            pos = skip_sub_blocks(pos + 3 + size)
        elif kind == 0x2C:
            local = data[pos + 9]
            pos += 10 + (3 << ((local & 7) + 1) if local & 0x80 else 0)
            pos = skip_sub_blocks(pos + 1)  # the LZW minimum code size, then the data
            frames += 1
            durations.append(delay * 10)
        else:
            raise ValueError(f"unknown GIF block 0x{kind:02x} at byte {pos}")
    return {"frames": frames, "durations": durations, "loop": loop, "size": (W, H)}
