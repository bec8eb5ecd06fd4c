"""Build and load the neighbor-aggregation CUDA library.

``nvcc`` compiles ``csrc/neighbor_agg.cu`` (plain C interface, no
PyTorch headers, so the build takes seconds) into a shared library that
``ctypes`` loads.  The build runs at first use, from the sources in the
checkout, into ``_build/`` beside this file (listed in ``.gitignore``);
the library's file name carries a digest of the source and flags, so an
edited source is rebuilt and never loaded stale.  Nothing happens at
import: the CPU tests import this module on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "csrc", "neighbor_agg.cu")
BUILD_DIR = os.path.join(HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (neither on PATH nor at /usr/local/cuda/bin): the "
        "neighbor-aggregation kernel is built from source at first use")


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libneighbor_agg_{digest.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile the library unless this source's build exists; returns its
    path.  The compiler writes to a temporary name that is renamed into
    place, so a concurrent or interrupted build never leaves a partial
    library under the final name."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, SOURCE]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                f"{res.stdout}\n{res.stderr}")
        if verbose:
            print(res.stdout + res.stderr, end="", flush=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def load_library() -> ctypes.CDLL:
    """The built library with its C signature declared (built on first
    call, then cached for the process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            fn = lib.neighbor_agg_forward
            fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib
