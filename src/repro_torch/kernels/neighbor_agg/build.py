"""Build and load the neighbor-aggregation CUDA library.

``nvcc`` compiles every ``csrc/*.cu`` (plain C interfaces, no PyTorch
headers, so the build takes seconds) into one shared library that
``ctypes`` loads: one ``nvcc -c`` per source, all started together, then
one link.  The build runs at first use, from the sources in the
checkout, into ``_build/`` beside this file (listed in ``.gitignore``);
the library's file name carries a digest of every source and header
under ``csrc/`` and of the flags, so an edited source is rebuilt and
never loaded stale.  Nothing happens at import: the CPU tests import
this module on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD_DIR = os.path.join(HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                       + glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0"
                          + f.read())
    return os.path.join(BUILD_DIR,
                        f"libneighbor_agg_{digest.hexdigest()[:16]}.so")


def _run_all(cmds) -> list:
    """Start every command at once; wait for all; raise on the first
    that failed.  Returns their (stdout + stderr) texts."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(c)}\n{out}")
    return outs


def build(verbose: bool = False) -> str:
    """Compile the library unless this digest's build exists; returns its
    path.  The objects and the library are written under temporary names
    and the library is renamed into place, so a concurrent or interrupted
    build never leaves a partial library under the final name."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmpdir = tempfile.mkdtemp(dir=BUILD_DIR)
    nvcc = _nvcc()
    ptxas = ["-Xptxas", "-v"] if verbose else []
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    objs = [os.path.join(tmpdir, os.path.basename(s) + ".o") for s in srcs]
    lib = os.path.join(tmpdir, "lib.so")
    try:
        outs = _run_all([[nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", o, s]
                         for s, o in zip(srcs, objs)])
        outs += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib,
                           *objs]])
        if verbose:
            print("".join(outs), end="", flush=True)
        os.replace(lib, path)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return path


def load_library() -> ctypes.CDLL:
    """The built library with its C signature declared (built on first
    call, then cached for the process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            tail = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p]     # n, b, k, d, stream
            for name, n_ptrs in (("neighbor_agg_forward", 6),
                                 ("neighbor_agg_backward", 10),
                                 ("neighbor_agg_row_forward", 4)):
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * n_ptrs \
                    + tail
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
