"""The flash-attention CUDA library (``csrc/flash_attn.cu`` and
``csrc/flash_attn_wgmma.cu``), built and loaded by the shared builder
``repro_torch.kernels.build``."""
from __future__ import annotations

import ctypes
import os

from repro_torch.kernels.build import Library


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.flash_attn_forward
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4     # dtype, q, k, v, o
                   + [ctypes.c_int] * 6                       # b s hq hkv d window
                   + [ctypes.c_float, ctypes.c_void_p])       # scale, stream
    fn.restype = ctypes.c_int
    fn = lib.flash_attn_wgmma_forward
    fn.argtypes = ([ctypes.c_void_p] * 4                      # q, k, v, o
                   + [ctypes.c_int] * 6                       # b s hq hkv d window
                   + [ctypes.c_float, ctypes.c_void_p])       # scale, stream
    fn.restype = ctypes.c_int
    for name in ("flash_attn_smem_bytes", "flash_attn_wgmma_smem_bytes"):
        fn = getattr(lib, name)                           # head dim
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_longlong


LIBRARY = Library(os.path.dirname(os.path.abspath(__file__)), "flash_attn",
                  _declare)


def load_library() -> ctypes.CDLL:
    """The built library with its C signature declared."""
    return LIBRARY.load()
