"""The hand-written kernels' byte and operation model on one H100: what
one call of each kernel must move and compute, and the least time that
gives at the card's published peaks.  The kernel table's bounds
(``bound``, ``bound_bwd``, ``bound_bwd_identity``, ``bound_bwd_csr``,
``flash_bound``, which ``chip_smoke.py`` uses) and the dry-run's kernel
bytes and FLOPs (the kernel wrappers' shape-only stand-ins call
``note_kernel`` with this model's counts) come from here.

The rates are one H100 SXM's (NVIDIA's data sheet, dense, at the full
700 W).  A card set below 700 W runs slower under load: state a share of
these peaks beside the card's power limit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

# --- NVIDIA H100 SXM (data sheet, dense) -----------------------------------
BF16_FLOPS_PER_S = 989e12     # bf16 / fp16 tensor cores
F32_FLOPS_PER_S = 67e12       # f32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12     # TF32 tensor cores
#: f32 products on the tensor cores in three-term TF32 (three TF32
#: products for each f32 one): the f32 flash kernel's rate
TF32X3_FLOPS_PER_S = TF32_FLOPS_PER_S / 3
HBM_BYTES_PER_S = 3.35e12     # device memory rate

#: the flop key of f32 work on the CUDA cores (the neighbor-aggregation
#: kernels' FMAs): never TF32
F32_FMA = "float32_fma"
#: the flop key of f32 products in three-term TF32 (the f32 flash kernel)
TF32X3 = "float32_tf32x3"


def note_kernel(name: str, nbytes: int, flops: int, key: str) -> None:
    """Add one kernel call's bytes and FLOPs (``key``: its rate class, a
    dtype's name or ``F32_FMA``) to every dispatch mode active in this
    thread that counts kernel calls (``launch.roofline.TraceCounter``,
    which has a ``note_kernel`` method): a shape-only stand-in's call;
    nothing when no such mode is active."""
    for mode in _get_current_dispatch_mode_stack():
        if hasattr(mode, "note_kernel"):
            mode.note_kernel(name, nbytes, flops, key)


def least_ms(nbytes: float, flops: float, rate: float) -> Tuple[float, str]:
    """The least time (ms) for ``nbytes`` over the HBM rate against
    ``flops`` over ``rate``, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def agg_cost(n: int, b: int, k: int, d: int, el: int,
             out_el: Optional[int] = None, fused: bool = False,
             rows: Optional[int] = None) -> Tuple[int, int]:
    """(bytes, f32 FLOPs) of one tiled forward call: each distinct
    referenced feature row, idx, w and out (and, fused, self_rows and
    w_self) once; a multiply-add per (row, edge, column).  ``el`` /
    ``out_el``: bytes of a table / output element.  ``rows``: the
    distinct referenced rows, counted from the data where there is data;
    without (a shape-only trace) the worst case, every row referenced,
    ``min(n, b·k)``."""
    oel = el if out_el is None else out_el
    rows = min(n, b * k) if rows is None else rows
    nbytes = rows * d * el + b * k * 4 + b * k * el + b * d * oel
    flops = 2 * b * k * d
    if fused:
        nbytes += b * d * oel + b * oel
        flops += 2 * b * d
    return nbytes, flops


def bwd_cost(n: int, b: int, k: int, d: int, el: int, need, fused: bool,
             rows: Optional[int] = None) -> Tuple[int, int]:
    """(bytes, f32 FLOPs) of one backward-kernel call: g, idx and w read,
    the distinct feature rows read (only when dw is asked for; ``rows``
    as in ``agg_cost``), dfeats and dw written once (fused: self_rows and
    w_self read, dself and dw_self written); 2 operations per element
    for dfeats, 2 for dw."""
    nbytes = b * d * el + b * k * 4 + b * k * el
    flops = 0
    if need[0]:
        nbytes += n * d * el
        flops += 2 * b * k * d
    if need[1]:
        rows = min(n, b * k) if rows is None else rows
        nbytes += rows * d * el + b * k * el
        flops += 2 * b * k * d
    if fused:
        nbytes += 2 * b * d * el + 2 * b * el
        flops += 3 * b * d
    return nbytes, flops


def identity_cost(b: int, k: int, d: int, el: int, need,
                  fused: bool) -> Tuple[int, int]:
    """(bytes, f32 FLOPs) of one identity-mode backward call (ids
    ``b·K + k``, no idx read): g read; for dfeats, w read and dfeats
    [B·K, D] written once, one multiply an element; for dw, the table's
    B·K rows read and dw written, a multiply-add an element; fused, for
    dself w_self read and dself written (a multiply an element), for
    dw_self self_rows read and dw_self written (a multiply-add)."""
    nbytes = b * d * el
    flops = 0
    if need[0]:
        nbytes += b * k * el + b * k * d * el
        flops += b * k * d
    if need[1]:
        nbytes += b * k * d * el + b * k * el
        flops += 2 * b * k * d
    if fused and need[2]:
        nbytes += b * el + b * d * el
        flops += b * d
    if fused and need[3]:
        nbytes += b * d * el + b * el
        flops += 2 * b * d
    return nbytes, flops


def csr_cost(n: int, b: int, nnz: int, d: int, el: int) -> Tuple[int, int]:
    """(bytes, f32 FLOPs) of one reverse-index backward call: g, the kept
    edges' weights, indptr and edges read once, dfeats written once; a
    multiply-add per kept edge and column."""
    nbytes = b * d * el + nnz * el + (n + 1) * 4 + nnz * 4 + n * d * el
    return nbytes, 2 * nnz * d


def flash_cost(b: int, s: int, hq: int, hkv: int, d: int, window: int,
               el: int) -> Tuple[int, int]:
    """(bytes, FLOPs) of one flash-attention call: q, k, v and o moved
    once (k and v at Hkv heads, as the kernels read them); 4·D FLOPs for
    each (query, key) pair the causal (window) mask keeps."""
    nbytes = (2 * hq + 2 * hkv) * b * s * d * el
    w = window or s
    pairs = w * (w + 1) // 2 + (s - w) * w if w < s else s * (s + 1) // 2
    return nbytes, 4 * b * hq * pairs * d


def bound(feats, idx, self_rows, out_el=None) -> tuple:
    """The least time for one tiled forward call on these tensors
    (``agg_cost``, the distinct rows counted from ``idx``) against its
    f32 multiply-adds over the f32 rate.  Returns (ms, "bytes" |
    "operations", bytes)."""
    b, k = idx.shape
    n, d = feats.shape
    nbytes, flops = agg_cost(n, b, k, d, feats.element_size(), out_el,
                             self_rows is not None,
                             rows=int(torch.unique(idx).numel()))
    return least_ms(nbytes, flops, F32_FLOPS_PER_S) + (nbytes,)


def bound_bwd(feats, idx, g, self_rows, need) -> tuple:
    """The least time for one backward-kernel call on these tensors
    (``bwd_cost``, the distinct rows counted from ``idx``).  Returns (ms,
    "bytes" | "operations", bytes)."""
    b, k = idx.shape
    n, d = feats.shape
    rows = int(torch.unique(idx).numel()) if need[1] else None
    nbytes, flops = bwd_cost(n, b, k, d, feats.element_size(), need,
                             self_rows is not None, rows)
    return least_ms(nbytes, flops, F32_FLOPS_PER_S) + (nbytes,)


def bound_bwd_identity(w, g, self_rows, need) -> tuple:
    """The least time for one identity-mode backward call on these
    tensors (``identity_cost``).  Returns (ms, "bytes" | "operations",
    bytes)."""
    b, k = w.shape
    nbytes, flops = identity_cost(b, k, g.shape[1], g.element_size(), need,
                                  self_rows is not None)
    return least_ms(nbytes, flops, F32_FLOPS_PER_S) + (nbytes,)


def bound_bwd_csr(rev, d: int, el: int) -> tuple:
    """The least time for one reverse-index backward call (``csr_cost``
    on the index's kept edges).  Returns (ms, "bytes" | "operations",
    bytes)."""
    nbytes, flops = csr_cost(rev.n, rev.b, rev.nnz, d, el)
    return least_ms(nbytes, flops, F32_FLOPS_PER_S) + (nbytes,)


def flash_bound(b, s, hq, hkv, d, window, dtype,
                rate: Optional[float] = None) -> tuple:
    """The least time for one flash-attention call (``flash_cost``) over
    ``rate``, by default the peak rate of the inputs' type: the bf16
    tensor cores, or for f32 the tensor cores in three-term TF32 (f32
    accuracy; ``F32_FLOPS_PER_S`` gives the CUDA cores' bound instead).
    Returns (ms, "bytes" | "operations", bytes, flops)."""
    el = torch.empty((), dtype=dtype).element_size()
    nbytes, flops = flash_cost(b, s, hq, hkv, d, window, el)
    if rate is None:
        rate = (BF16_FLOPS_PER_S if dtype == torch.bfloat16
                else TF32X3_FLOPS_PER_S)
    return least_ms(nbytes, flops, rate) + (nbytes, flops)
