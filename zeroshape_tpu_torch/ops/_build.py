"""Build a source of ``csrc/`` into a shared library at first use, and load it.

Every kernel of the port is CUDA C++ for ``sm_90a`` with a plain C interface
(each entry point returns its ``cudaError_t``). ``nvcc`` compiles a ``.cu``
source, and ``g++`` a host-only ``.cpp`` one (the GIF encoder), into
``csrc/build/lib<name>.so`` when the library is missing or older than its
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


def build(source, name, flags=()):
    """Compile ``csrc/<source>`` into ``lib<name>.so`` if it is missing or stale.

    ``flags`` are extra compiler arguments (a ``-D`` for a variant). Returns
    ``(seconds spent building, compiler output)``; 0 and "" when the library
    was already current. For a ``.cu`` source the output holds ``ptxas``'s
    register and spill report (``-Xptxas -v``). Raises ``RuntimeError`` if
    the compiler fails or is missing.
    """
    src, lib = os.path.join(CSRC, source), library_path(name)
    if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
        return 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    if source.endswith(".cpp"):
        compiler = "g++"
        cmd = [compiler, "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", *flags, "-o", tmp, src]
    else:
        from torch.utils.cpp_extension import CUDA_HOME

        compiler = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "nvcc")
        cmd = [
            compiler, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", *flags, "-o", tmp, src,
        ]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"no compiler to build {source}: {e}") from e
    seconds = time.perf_counter() - t0
    log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"{os.path.basename(compiler)} failed on {source} ({res.returncode}):\n{log}")
    os.replace(tmp, lib)
    return seconds, log


def library(source, name, signatures, flags=(), restype=ctypes.c_int):
    """The loaded ``lib<name>.so``, built first (with ``flags``) if needed.

    ``signatures`` maps each C entry point to its ctypes ``argtypes``; every
    entry point returns ``restype`` (an ``int``, its ``cudaError_t``, for the
    kernels). They are set at every call, so a library first loaded with
    some of its entry points gains the others' types when asked for them.
    """
    lib = _LOADED.get(name)
    if lib is None:
        build(source, name, flags)
        lib = ctypes.CDLL(library_path(name))
        _LOADED[name] = lib
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib
