"""The neighbor-aggregation CUDA library (every ``csrc/*.cu`` here: the
tiled forward, the backward, the reverse-index backward and the row
kernel), built and loaded by the shared builder
``repro_torch.kernels.build``."""
from __future__ import annotations

import ctypes
import os

from repro_torch.kernels.build import Library


def _declare(lib: ctypes.CDLL) -> None:
    tail = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]     # n, b, k, d, stream
    for name, n_ptrs in (("neighbor_agg_forward", 6),
                         ("neighbor_agg_backward", 10),
                         ("neighbor_agg_backward_csr", 5),
                         ("neighbor_agg_row_forward", 4)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * n_ptrs + tail
        fn.restype = ctypes.c_int


LIBRARY = Library(os.path.dirname(os.path.abspath(__file__)), "neighbor_agg",
                  _declare)


def build(verbose: bool = False) -> str:
    """Compile the library unless this digest's build exists; returns its
    path."""
    return LIBRARY.build(verbose)


def load_library() -> ctypes.CDLL:
    """The built library with its C signatures declared."""
    return LIBRARY.load()
