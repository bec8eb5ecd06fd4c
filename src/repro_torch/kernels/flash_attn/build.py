"""The flash-attention CUDA library (``csrc/flash_attn.cu`` and
``csrc/flash_attn_wgmma.cu``), built and loaded by the shared builder
``repro_torch.kernels.build``, and its checked build (``CHECKED``: the
same sources with ``-DREPRO_PIPELINE_CHECK``, whose kernels log their
pipelines for ``analysis.kernel_audit.audit_pipelines``; built only when
that check runs, and only at the head dims of ``CHECKED_DIMS``)."""
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


def _declare_checked(lib: ctypes.CDLL) -> None:
    _declare(lib)
    for name in ("flash_attn_forward", "flash_attn_wgmma_forward"):
        fn = getattr(lib, name)                  # + the log, records a block
        fn.argtypes = list(fn.argtypes) + [ctypes.c_void_p, ctypes.c_int]
    lib.pipeline_check_record_bytes.argtypes = []
    lib.pipeline_check_record_bytes.restype = ctypes.c_int


#: the head dims the checked build compiles, by kernel and dtype: those
#: of the pipeline check's cases
CHECKED_DIMS = {"PC_WGMMA_DIMS": (64, 112, 256),
                "PC_F32_DIMS": (16, 32, 64, 256),
                "PC_BF16_DIMS": (64,)}

_DIR = os.path.dirname(os.path.abspath(__file__))
LIBRARY = Library(_DIR, "flash_attn", _declare)
CHECKED = Library(
    _DIR, "flash_attn_checked", _declare_checked,
    defines=("REPRO_PIPELINE_CHECK",) + tuple(
        f"{k}={sum(1 << (d // 16) for d in dims)}"
        for k, dims in CHECKED_DIMS.items()))


def load_library() -> ctypes.CDLL:
    """The built library with its C signature declared."""
    return LIBRARY.load()
