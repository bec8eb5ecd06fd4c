"""Build and load the port's CUDA kernel libraries.

Each kernel package keeps its sources under ``csrc/`` beside its
``build.py``.  ``nvcc`` compiles every ``csrc/*.cu`` of a package (plain C
interfaces, no PyTorch headers, so a build takes seconds) into one
shared library that ``ctypes`` loads: one ``nvcc -c`` per source, then one
link per library.  ``build_all`` starts the compiles of every library it
is given at once.  The build runs at first use, from the sources in the
checkout, into ``_build/`` beside the package's ``csrc/`` (listed in
``.gitignore``); the library's file name carries a digest of every
source and header under ``csrc/`` (and the include directories), of the
flags and of the library's extra defines, so an edited source is rebuilt
and never loaded stale, and a checked build (``-DREPRO_PIPELINE_CHECK``)
never shares a file with the normal one.  Nothing happens at import: the
CPU tests import this module on machines without ``nvcc``.
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
from typing import Callable, List, Optional, Sequence

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (neither on PATH nor at /usr/local/cuda/bin): the "
        "CUDA kernels are built from source at first use")


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


class Library:
    """One kernel package's library: ``package_dir/<csrc>/*.cu`` built into
    ``package_dir/_build/lib<name>_<digest>.so``.  ``declare`` sets the
    ``argtypes`` and ``restype`` of every C entry point on the loaded
    library.  ``defines`` are passed as ``-D``; ``include_dirs`` as
    ``-I``, their headers hashed into the digest."""

    def __init__(self, package_dir: str, name: str,
                 declare: Callable[[ctypes.CDLL], None], *,
                 csrc: str = "csrc", defines: Sequence[str] = (),
                 include_dirs: Sequence[str] = ()):
        self.csrc = os.path.join(package_dir, csrc)
        self.build_dir = os.path.join(package_dir, "_build")
        self.name = name
        self.defines = tuple(defines)
        self.include_dirs = tuple(include_dirs)
        self._declare = declare
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None

    def sources(self) -> List[str]:
        return sorted(glob.glob(os.path.join(self.csrc, "*.cu")))

    def flags(self) -> List[str]:
        return [*NVCC_FLAGS, *(f"-D{d}" for d in self.defines),
                *(f"-I{d}" for d in self.include_dirs)]

    def path(self) -> str:
        # the include directories enter by their headers' bytes, not by
        # their paths, so a digest is the same in every checkout
        digest = hashlib.sha256(" ".join(
            [*NVCC_FLAGS, *(f"-D{d}" for d in self.defines)]).encode())
        headers = [h for d in (self.csrc, *self.include_dirs)
                   for h in glob.glob(os.path.join(d, "*.cuh"))]
        for path in sorted(self.sources() + headers):
            with open(path, "rb") as f:
                digest.update(os.path.basename(path).encode() + b"\0"
                              + f.read())
        return os.path.join(self.build_dir,
                            f"lib{self.name}_{digest.hexdigest()[:16]}.so")

    def build(self, verbose: bool = False) -> str:
        return build_all([self], verbose)[0]

    def load(self) -> ctypes.CDLL:
        """The built library with its C signatures declared (built on
        first call, then cached for the process)."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                self._declare(lib)
                self._lib = lib
            return self._lib


def build_all(libs: Sequence[Library], verbose: bool = False) -> List[str]:
    """Compile every library whose digest's build does not exist yet, all
    sources of all of them at once; returns their paths.  Objects and
    libraries are written under temporary names and each library is
    renamed into place, so a concurrent or interrupted build never leaves
    a partial library under the final name."""
    paths = [lib.path() for lib in libs]
    todo = [(lib, p) for lib, p in zip(libs, paths) if not os.path.exists(p)]
    if not todo:
        return paths
    nvcc = _nvcc()
    ptxas = ["-Xptxas", "-v"] if verbose else []
    tmpdirs = []
    try:
        compiles, links = [], []
        for lib, path in todo:
            os.makedirs(lib.build_dir, exist_ok=True)
            tmp = tempfile.mkdtemp(dir=lib.build_dir)
            tmpdirs.append(tmp)
            srcs = lib.sources()
            objs = [os.path.join(tmp, os.path.basename(s) + ".o")
                    for s in srcs]
            compiles += [[nvcc, *lib.flags(), *ptxas, "-c", "-o", o, s]
                         for s, o in zip(srcs, objs)]
            links.append((os.path.join(tmp, "lib.so"), path, objs))
        outs = _run_all(compiles)
        outs += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs]
                          for so, _, objs in links])
        if verbose:
            print("".join(outs), end="", flush=True)
        for so, path, _ in links:
            os.replace(so, path)
    finally:
        for tmp in tmpdirs:
            shutil.rmtree(tmp, ignore_errors=True)
    return paths
