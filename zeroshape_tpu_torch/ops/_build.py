"""Build a CUDA source of ``csrc/`` into a shared library at first use, and load it.

Every kernel of the port is CUDA C++ for ``sm_90a`` with a plain C interface
(each entry point returns its ``cudaError_t``). ``nvcc`` compiles a source
into ``csrc/build/lib<name>.so`` when the library is missing or older than its
source, and ``ctypes`` loads it once per process.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")

_LOADED = {}


def library_path(name):
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def build(source, name):
    """Compile ``csrc/<source>`` into ``lib<name>.so`` if it is missing or stale.

    Returns ``(seconds spent building, compiler output)``; 0 and "" when the
    library was already current. The output holds ``ptxas``'s register and
    spill report (``-Xptxas -v``). Raises ``RuntimeError`` if ``nvcc`` fails.
    """
    src, lib = os.path.join(CSRC, source), library_path(name)
    if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
        return 0.0, ""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "nvcc")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [
        nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, src,
    ]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} ({res.returncode}):\n{log}")
    os.replace(tmp, lib)
    return seconds, log


def library(source, name, signatures):
    """The loaded ``lib<name>.so``, built first if needed.

    ``signatures`` maps each C entry point to its ctypes ``argtypes``; every
    entry point returns an ``int`` (its ``cudaError_t``).
    """
    lib = _LOADED.get(name)
    if lib is None:
        build(source, name)
        lib = ctypes.CDLL(library_path(name))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LOADED[name] = lib
    return lib
