"""Public wrapper of the weighted neighbor aggregation and its gradient.

``neighbor_agg`` mirrors the reference wrapper
(``repro/kernels/neighbor_agg/ops.py:170-202``) and its custom VJP
(``:46-114``):

* ``use_kernel=False`` — the plain version plus the unfused
  ``w_self[:, None] * self_rows`` epilogue (``ops.py:191-193``),
  differentiated by torch autograd;
* ``use_kernel=True`` — a ``torch.autograd.Function`` (``_Agg``, or
  ``_AggSelf`` with the fused epilogue) whose forward is the tiled CUDA
  forward, on the route ``tiled_plan`` picks from the shapes alone: the
  slab route (``csrc/neighbor_agg_slab.cu``, column slabs walked one
  after another) or the direct route (``csrc/neighbor_agg.cu``, whole
  rows in one pass), bit-equal to each other; or, for ``kernel="row"``,
  the row kernel (``csrc/neighbor_agg_row.cu``, self term added outside
  as the reference does).

The backward has three kernels, and each path reaches one for dfeats:

* **the reverse-index kernel** (``csrc/neighbor_agg_bwd_csr.cu``) — the
  full-graph, cluster and sharded full-graph paths, which pass
  ``rev=build_reverse_index(idx, w, n)``: a gather over the transposed
  ELL, one warp per source row, no atomics, bit-identical from run to
  run.  The index is checked against the call: the same ``idx`` object
  at the same version, the same shapes and device, and ``w`` zero on
  every edge the index left out (an on-device assert, no host sync).
* **the identity mode of the backward kernel** (``csrc/neighbor_agg_bwd.cu``,
  ``neighbor_agg_backward_identity``) — the mini-batch paths: ``_wsum``
  calls ``neighbor_agg_batch`` (``_AggBatch``) on an already-gathered
  fan-out level ``[B, K, D]``, flattened to a ``[B·K, D]`` table with the
  identity ids ``b·K + k``; ``neighbor_agg_batch_sharded`` does the same
  shard by shard.  No two edges share a row, so dfeats is
  ``w[b, k]·g[b]`` written once with vector stores in the table's dtype:
  no zero fill, no f32 buffer, no atomics, no cast pass.
* **the general mode of the backward kernel** (``neighbor_agg_backward``)
  — everything else: dw, dself and dw_self (with a null dfeats beside the
  reverse index: GCN's full-graph dself), and dfeats of a direct
  ``neighbor_agg(use_kernel=True)`` call without ``rev``, summed with f32
  vector atomics into a zeroed f32 buffer cast once to ``feats.dtype``.
  No model path reaches its dfeats.

On a CUDA tensor each kernel launches or raises: never a quiet fallback,
and neither the reverse-index kernel nor the identity mode ever gives way
to the general mode.  On a CPU tensor the same Functions run the
kernels' plain versions (``ref.neighbor_agg_ref``,
``ref.neighbor_agg_backward_ref``, ``ref.neighbor_agg_backward_identity_ref``,
``ref.neighbor_agg_backward_csr_ref``), because the tensor lies on the
CPU.

The backward reads ``ctx.needs_input_grad``: no scatter when ``feats``
needs no gradient, no dot when ``w`` needs none (on the model paths the
weights, masks and layer 1's raw feature table never do).  ``dfeats`` is
in ``feats.dtype``; ``dw`` in ``w.dtype``.  The kernels mask ragged
B/K/D themselves, so nothing is padded to tiles.

Shape-only tensors (fake tensors under ``FakeTensorMode``, or meta
tensors: ``device.is_shape_only``), which the dry-run traces, take the
CUDA path up to the launch: each launcher allocates its outputs as it
does for the card, and then, in place of the library call, its
stand-in adds the kernel's bytes and FLOPs (``kernels.cost``'s model,
every referenced row counted once: ``min(N, B·K)``) to the active
``TraceCounter``s and returns the empty outputs.  A real tensor, CPU or
CUDA, never reaches a stand-in, and a stand-in counts no launch.
``build_reverse_index`` of shape-only tensors gives an index of their
shapes with every edge kept (``nnz = B·K``, the worst case).

One launch counter per kernel, changed only where that kernel launches:
``launches`` (tiled forward, both routes), ``backward_launches`` (the
general mode), ``backward_identity_launches``, ``backward_csr_launches``
and ``row_launches``; ``launch_counts()`` also splits the tiled forward
by route (``tiled_slab``, ``tiled_direct``) and counts its launches with
the fused self epilogue (``tiled_fused``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Tuple

import torch

from repro_torch.device import is_shape_only
from repro_torch.kernels import cost
from repro_torch.kernels.neighbor_agg.ref import (
    neighbor_agg_backward_csr_ref, neighbor_agg_backward_identity_ref,
    neighbor_agg_backward_ref, neighbor_agg_ref)

#: launches of the tiled forward kernel (both routes)
launches = 0
#: launches of the tiled forward by route
slab_launches = 0
direct_launches = 0
#: launches of the tiled forward with the fused self epilogue
fused_launches = 0
#: launches of the backward kernel: its general mode
backward_launches = 0
#: launches of the backward kernel's identity mode
backward_identity_launches = 0
#: launches of the reverse-index backward kernel
backward_csr_launches = 0
#: launches of the row kernel
row_launches = 0
_count_lock = threading.Lock()


def reset_launches() -> None:
    """Set every kernel's launch counter to 0."""
    global launches, backward_launches, backward_csr_launches, row_launches
    global slab_launches, direct_launches, fused_launches
    global backward_identity_launches
    with _count_lock:
        launches = backward_launches = backward_csr_launches = 0
        row_launches = slab_launches = direct_launches = fused_launches = 0
        backward_identity_launches = 0


def launch_counts() -> dict:
    """The launch counters by kernel: tiled (both routes), backward (the
    general mode), backward_csr, row, backward_identity; the tiled
    forward by route: tiled_slab, tiled_direct; and its launches with the
    fused self epilogue: tiled_fused."""
    return {"tiled": launches, "backward": backward_launches,
            "backward_csr": backward_csr_launches, "row": row_launches,
            "tiled_slab": slab_launches, "tiled_direct": direct_launches,
            "tiled_fused": fused_launches,
            "backward_identity": backward_identity_launches}


def _count(name: str, fused: bool = False) -> None:
    global launches, backward_launches, backward_csr_launches, row_launches
    global slab_launches, direct_launches, fused_launches
    global backward_identity_launches
    with _count_lock:
        fused_launches += fused
        if name == "tiled_slab":
            launches += 1
            slab_launches += 1
        elif name == "tiled_direct":
            launches += 1
            direct_launches += 1
        elif name == "backward":
            backward_launches += 1
        elif name == "backward_identity":
            backward_identity_launches += 1
        elif name == "backward_csr":
            backward_csr_launches += 1
        else:
            row_launches += 1


@dataclasses.dataclass(frozen=True, eq=False)
class ReverseIndex:
    """The ELL ``(idx [B, K], w [B, K])`` transposed to a CSR over the N
    source rows: row n's edges are ``edges[indptr[n]:indptr[n+1]]``, each
    a flat ELL position ``e = b*K + k`` (so ``b = e // K`` and its weight
    is ``w.view(-1)[e]``), ascending within the row.  Only kept edges
    (``w != 0`` and ``0 <= idx < n``; ``kept`` marks them) are in it.
    ``idx`` is the tensor it was built from and ``idx_version`` that
    tensor's ``_version`` then: a call with another ``idx``, or with this
    one changed in place since, is refused."""
    indptr: torch.Tensor        # [N + 1] int32
    edges: torch.Tensor         # [nnz] int32
    kept: torch.Tensor          # [B, K] bool
    n: int
    b: int
    k: int
    idx: torch.Tensor
    idx_version: int

    @property
    def nnz(self) -> int:
        return self.edges.numel()

    @property
    def nbytes(self) -> int:
        """Device bytes of the index itself (indptr, edges, kept)."""
        return sum(t.numel() * t.element_size()
                   for t in (self.indptr, self.edges, self.kept))


def build_reverse_index(idx: torch.Tensor, w: torch.Tensor,
                        n: int) -> ReverseIndex:
    """The reverse index of the ELL ``(idx, w)`` over ``n`` source rows,
    in plain torch on ``idx``'s device (a one-off layout transform, like
    ``to_ell``; the same code on the CPU and the card): a stable sort of
    the kept edges by source row, then ``bincount`` + ``cumsum`` for
    ``indptr``.  Zero-weight edges are left out: the ELL points every
    padding edge at row 0, and they would all land on that one row."""
    if idx.dim() != 2 or idx.dtype != torch.int32 or w.shape != idx.shape:
        raise ValueError(f"build_reverse_index: idx must be int32 [B, K] "
                         f"and w of its shape, got {idx.dtype} "
                         f"{tuple(idx.shape)} and {tuple(w.shape)}")
    b, k = idx.shape
    if b * k >= 2 ** 31:
        raise ValueError(f"build_reverse_index: B*K = {b * k} edges do "
                         f"not fit the index's int32 positions")
    kept = (w != 0) & (idx >= 0) & (idx < n)
    if is_shape_only(idx):                  # no data: every edge kept
        i32 = dict(dtype=torch.int32, device=idx.device)
        return ReverseIndex(indptr=torch.empty(n + 1, **i32),
                            edges=torch.empty(b * k, **i32), kept=kept,
                            n=int(n), b=b, k=k, idx=idx,
                            idx_version=idx._version)
    pos = torch.nonzero(kept.reshape(-1)).squeeze(1)        # ascending
    src = idx.reshape(-1)[pos].long()
    order = torch.sort(src, stable=True).indices
    indptr = torch.zeros(n + 1, dtype=torch.int32, device=idx.device)
    indptr[1:] = torch.cumsum(torch.bincount(src, minlength=n), 0)
    return ReverseIndex(indptr=indptr, edges=pos[order].to(torch.int32),
                        kept=kept, n=int(n), b=b, k=k, idx=idx,
                        idx_version=idx._version)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the tiled forward's (table dtype, output dtype) pairs and their codes:
#: an f32 output of a bf16 table holds a partial sum unrounded
_FORWARD_CODE = {(torch.float32, torch.float32): 0,
                 (torch.bfloat16, torch.bfloat16): 1,
                 (torch.bfloat16, torch.float32): 2}

#: the routes of the tiled forward
TILED_ROUTES = ("slab", "direct")
#: the slab widths (bytes of a row) the slab kernel takes
SLAB_WIDTHS = (32, 64, 128, 256)
#: the slab width the plan uses: 128 B, one L2 line (PERF.md section 6:
#: each width timed at the full-graph shape on the H100)
SLAB_BYTES = 128
#: L2's line: the plan takes the slab route only where a row is a whole
#: number of lines, so each 128 B slab is whole lines
LINE_BYTES = 128
#: the largest feature table (N * D bytes) the direct route keeps at
#: every shape: at or below it the direct route was as fast or faster
#: (PERF.md section 6)
L2_TABLE_BYTES = 32 * 2 ** 20


@dataclasses.dataclass(frozen=True)
class TiledPlan:
    """How the tiled forward runs at one shape: ``route`` (``"slab"`` or
    ``"direct"``) and the slab route's layout (given whichever route is
    taken, so a forced slab route has it): ``bounds`` = ``((c0, c1),
    ...)`` covering ``[0, D)`` once, each ``slab_cols`` wide but the
    last."""
    route: str
    slab_cols: int
    bounds: Tuple[Tuple[int, int], ...]


def tiled_plan(n: int, b: int, k: int, d: int, dtype: torch.dtype,
               slab_bytes: Optional[int] = None) -> TiledPlan:
    """The route of the tiled forward from the shapes alone: feats
    [n, d] in ``dtype``, idx [b, k].  ``"slab"`` where the call gathers
    for every row of the table (``b >= n``: the full-graph forward) from
    ids that repeat (``b * k > n``), the table is larger than
    ``L2_TABLE_BYTES``, a row is a whole number of L2 lines and spans
    more than one slab; else ``"direct"``.  The mini-batch identity ids
    read each row once, and the serving build's chunks (``b < n``) start
    with L2 cold, where the slab route measured slower.  Slabs are
    ``slab_bytes`` (``SLAB_BYTES`` by default) of a row: 8-byte
    multiples, so every slab starts 8-byte aligned within its row."""
    el = torch.empty((), dtype=dtype).element_size()
    slab_bytes = SLAB_BYTES if slab_bytes is None else slab_bytes
    if slab_bytes not in SLAB_WIDTHS:
        raise ValueError(f"slab_bytes must be one of {SLAB_WIDTHS}, got "
                         f"{slab_bytes}")
    cols = slab_bytes // el
    bounds = tuple((c, min(c + cols, d)) for c in range(0, d, cols))
    slab = (b >= n and b * k > n and n * d * el > L2_TABLE_BYTES
            and d * el % LINE_BYTES == 0 and len(bounds) > 1)
    return TiledPlan("slab" if slab else "direct", cols, bounds)


_forced_route: Optional[Tuple[str, Optional[int]]] = None


@contextlib.contextmanager
def _tiled_route(route: str, slab_bytes: Optional[int] = None):
    """Force the tiled forward's route (and, for ``"slab"``, its slab
    width) on CUDA tensors inside the block, whatever ``tiled_plan``
    says; CPU tensors still take the plain version.  For side-by-side
    timing and tests only; process-wide, not thread-local."""
    global _forced_route
    if route not in TILED_ROUTES:
        raise ValueError(f"route must be one of {TILED_ROUTES}, got "
                         f"{route!r}")
    if slab_bytes is not None and slab_bytes not in SLAB_WIDTHS:
        raise ValueError(f"slab_bytes must be one of {SLAB_WIDTHS}, got "
                         f"{slab_bytes}")
    prev, _forced_route = _forced_route, (route, slab_bytes)
    try:
        yield
    finally:
        _forced_route = prev


def _check_kernel_args(feats, idx, w, self_rows, w_self, rev=None,
                       out_dtype=None) -> None:
    """Raise on anything the kernel does not take (checked on every
    device, so the CPU tests hold the same contract as the card).
    ``out_dtype`` (the tiled forward's output, ``feats.dtype`` when
    None) may be f32 for a bf16 table; ``self_rows`` / ``w_self`` come
    in the output dtype.  A
    reverse index must be the one of this ``idx`` (object and version),
    shapes and device; ``w`` nonzero on an edge it left out fails an
    on-device assert (raised at once on the CPU, by the card's next
    synchronising call on a CUDA tensor).  ``idx=None`` stands for the
    identity ids ``b·K + k`` of ``w`` [B, K], with ``feats`` the
    ``[B·K, D]`` table."""
    def req(cond, msg):
        if not cond:
            raise ValueError(f"neighbor_agg kernel: {msg}")
    req(feats.dim() == 2, f"feats must be [N, D], got {tuple(feats.shape)}")
    req(feats.dtype in _DTYPE_CODE,
        f"feats dtype must be float32 or bfloat16, got {feats.dtype}")
    if idx is None:
        req(w.dim() == 2 and feats.shape[0] == w.numel(),
            f"the table must be [B·K, D] for w [B, K], got "
            f"{tuple(feats.shape)} and {tuple(w.shape)}")
    else:
        req(idx.dim() == 2 and idx.dtype == torch.int32,
            f"idx must be int32 [B, K], got {idx.dtype} {tuple(idx.shape)}")
    shape = w.shape if idx is None else idx.shape
    req(w.shape == shape and w.dtype == feats.dtype,
        f"w must be {feats.dtype} {tuple(shape)}, got {w.dtype} "
        f"{tuple(w.shape)}")
    odt = feats.dtype if out_dtype is None else out_dtype
    req((feats.dtype, odt) in _FORWARD_CODE,
        f"a {feats.dtype} table cannot give a {odt} output")
    ops = [feats, w] + ([] if idx is None else [idx])
    if self_rows is not None:
        b, d = shape[0], feats.shape[1]
        req(self_rows.shape == (b, d) and self_rows.dtype == odt,
            f"self_rows must be {odt} {(b, d)}, got "
            f"{self_rows.dtype} {tuple(self_rows.shape)}")
        req(w_self.shape == (b,) and w_self.dtype == odt,
            f"w_self must be {odt} {(b,)}, got {w_self.dtype} "
            f"{tuple(w_self.shape)}")
        ops += [self_rows, w_self]
    req(all(t.device == feats.device for t in ops),
        "all operands must be on one device")
    req(all(t.is_contiguous() for t in ops), "operands must be contiguous")
    req(feats.shape[0] > 0 or shape[1] == 0,
        "feats has no rows to gather from")
    if rev is None:
        return
    req(isinstance(rev, ReverseIndex),
        f"rev must be a ReverseIndex, got {type(rev).__name__}")
    req(rev.idx is idx, "rev was built for another idx tensor")
    req(idx._version == rev.idx_version,
        "idx was changed in place after its reverse index was built")
    req((rev.n, rev.b, rev.k) == (feats.shape[0],) + tuple(idx.shape),
        f"rev is for N={rev.n}, B={rev.b}, K={rev.k}; the call has "
        f"N={feats.shape[0]}, B={idx.shape[0]}, K={idx.shape[1]}")
    req(rev.indptr.device == feats.device,
        f"rev is on {rev.indptr.device}, the operands on {feats.device}")
    torch._assert_async(~((w != 0) & ~rev.kept).any(),
                        "neighbor_agg kernel: w is nonzero on an edge "
                        "its reverse index left out")


def _launch(feats, idx, w, self_rows, w_self, out_dtype=None):
    """The tiled forward on the route ``tiled_plan`` gives (or the one
    ``_tiled_route`` forces); a failed build or launch raises.  An f32
    output of a bf16 table (``out_dtype``) takes the direct route, the
    one that has it."""
    from repro_torch.kernels.neighbor_agg.build import load_library
    n, d = feats.shape
    b, k = idx.shape
    odt = feats.dtype if out_dtype is None else out_dtype
    forced = _forced_route
    plan = tiled_plan(n, b, k, d, feats.dtype, forced and forced[1])
    route = forced[0] if forced else plan.route
    if odt != feats.dtype:
        if forced and route != "direct":
            raise ValueError(f"neighbor_agg kernel: a {odt} output of a "
                             f"{feats.dtype} table has the direct route "
                             f"only, not {route!r}")
        route = "direct"
    out = torch.empty((b, d), dtype=odt, device=feats.device)
    if b == 0 or d == 0:                         # nothing to compute
        return out
    if is_shape_only(feats):
        _stand_in("tiled_" + route, *cost.agg_cost(
            n, b, k, d, feats.element_size(), out.element_size(),
            self_rows is not None))
        return out
    lib = load_library()
    args = (_FORWARD_CODE[feats.dtype, odt], feats.data_ptr(),
            idx.data_ptr(), w.data_ptr(), _ptr(self_rows), _ptr(w_self),
            out.data_ptr(), n, b, k, d)
    with torch.cuda.device(feats.device):     # launch on the tensors' card
        if route == "slab":
            err = lib.neighbor_agg_forward_slab(*args, plan.slab_cols,
                                                _stream(feats))
        else:
            err = lib.neighbor_agg_forward(*args, _stream(feats))
    _raise_on(err, f"neighbor_agg (tiled, {route} route)", b, k, d, n,
              feats.dtype)
    _count("tiled_" + route, fused=self_rows is not None)
    return out


def _stand_in(name: str, nbytes: int, flops: int) -> None:
    """A shape-only call of kernel ``name``: its bytes and f32 FLOPs to
    the active trace counters; no launch, no count."""
    cost.note_kernel(name, nbytes, flops, cost.F32_FMA)


def _raise_on(err: int, what: str, b, k, d, n, dtype) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} CUDA kernel launch failed with error {err} "
            f"(B={b}, K={k}, D={d}, N={n}, dtype={dtype})")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_row(feats, idx, w):
    from repro_torch.kernels.neighbor_agg.build import load_library
    n, d = feats.shape
    b, k = idx.shape
    out = torch.empty((b, d), dtype=feats.dtype, device=feats.device)
    if b == 0 or d == 0:                         # nothing to compute
        return out
    if is_shape_only(feats):
        _stand_in("row", *cost.agg_cost(n, b, k, d,
                                              feats.element_size()))
        return out
    lib = load_library()
    with torch.cuda.device(feats.device):
        err = lib.neighbor_agg_row_forward(
            _DTYPE_CODE[feats.dtype], feats.data_ptr(), idx.data_ptr(),
            w.data_ptr(), out.data_ptr(), n, b, k, d, _stream(feats))
    _raise_on(err, "neighbor_agg (row)", b, k, d, n, feats.dtype)
    _count("row")
    return out


def _launch_backward(feats, idx, w, g, self_rows, w_self, need):
    """The backward kernel; ``need`` = which of (dfeats, dw, dself,
    dw_self) autograd asked for.  dfeats accumulates in an f32 buffer
    zeroed here and cast to ``feats.dtype`` once."""
    from repro_torch.kernels.neighbor_agg.build import load_library
    n, d = feats.shape
    b, k = idx.shape
    fused = self_rows is not None
    alloc = torch.empty_like if d > 0 else torch.zeros_like
    df32 = (torch.zeros((n, d), dtype=torch.float32, device=feats.device)
            if need[0] else None)
    dw = alloc(w) if need[1] else None
    dself = alloc(self_rows) if fused and need[2] else None
    dws = alloc(w_self) if fused and need[3] else None
    outs = (df32, dw, dself, dws)
    launch = b > 0 and d > 0 and any(o is not None for o in outs)
    if launch and is_shape_only(feats):
        _stand_in("backward", *cost.bwd_cost(
            n, b, k, d, feats.element_size(), need, fused))
    elif launch:
        lib = load_library()
        with torch.cuda.device(feats.device):
            err = lib.neighbor_agg_backward(
                _DTYPE_CODE[feats.dtype], feats.data_ptr(), idx.data_ptr(),
                w.data_ptr(), g.data_ptr(), _ptr(self_rows), _ptr(w_self),
                *(_ptr(o) for o in outs), n, b, k, d, _stream(feats))
        _raise_on(err, "neighbor_agg backward", b, k, d, n, feats.dtype)
        _count("backward")
    dfeats = (df32 if df32 is None or feats.dtype == torch.float32
              else df32.to(feats.dtype))
    return dfeats, dw, dself, dws


def _launch_backward_identity(table, w, g, self_rows, w_self, need):
    """The backward kernel's identity mode (ids ``b·K + k`` of the
    ``[B·K, D]`` table); ``need`` as in ``_launch_backward``.  Every row
    of dfeats is written, in the table's dtype, so nothing is zeroed or
    cast."""
    from repro_torch.kernels.neighbor_agg.build import load_library
    b, k = w.shape
    d = g.shape[1]
    fused = self_rows is not None
    alloc = torch.empty_like if d > 0 else torch.zeros_like
    dfeats = (torch.empty((b * k, d), dtype=table.dtype, device=table.device)
              if need[0] else None)
    dw = alloc(w) if need[1] else None
    dself = alloc(self_rows) if fused and need[2] else None
    dws = alloc(w_self) if fused and need[3] else None
    outs = (dfeats, dw, dself, dws)
    launch = b > 0 and d > 0 and any(o is not None for o in outs)
    if launch and is_shape_only(table):
        _stand_in("backward_identity", *cost.identity_cost(
            b, k, d, table.element_size(), need, fused))
    elif launch:
        lib = load_library()
        with torch.cuda.device(table.device):
            err = lib.neighbor_agg_backward_identity(
                _DTYPE_CODE[table.dtype], table.data_ptr(), w.data_ptr(),
                g.data_ptr(), _ptr(self_rows), _ptr(w_self),
                *(_ptr(o) for o in outs), b, k, d, _stream(table))
        _raise_on(err, "neighbor_agg backward (identity ids)", b, k, d,
                  b * k, table.dtype)
        _count("backward_identity")
    return outs


def _launch_backward_csr(rev, w, g):
    """dfeats [N, D] in g's dtype from the reverse-index kernel; every
    row is written, so nothing is zeroed first."""
    from repro_torch.kernels.neighbor_agg.build import load_library
    d = g.shape[1]
    out = torch.empty((rev.n, d), dtype=g.dtype, device=g.device)
    if rev.n == 0 or d == 0:                     # nothing to compute
        return out
    if is_shape_only(g):
        _stand_in("backward_csr", *cost.csr_cost(
            rev.n, rev.b, rev.nnz, d, g.element_size()))
        return out
    lib = load_library()
    with torch.cuda.device(g.device):
        err = lib.neighbor_agg_backward_csr(
            _DTYPE_CODE[g.dtype], rev.indptr.data_ptr(),
            rev.edges.data_ptr(), w.data_ptr(), g.data_ptr(),
            out.data_ptr(), rev.n, rev.b, rev.k, d, _stream(g))
    _raise_on(err, "neighbor_agg backward (reverse index)", rev.b, rev.k, d,
              rev.n, g.dtype)
    _count("backward_csr")
    return out


def _device_of(feats) -> str:
    """``"cpu"`` (the plain versions) or the kernels' path: ``"cuda"``,
    and ``"meta"`` for shape-only tensors on the trace device (their
    stand-ins)."""
    if feats.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"neighbor_agg kernel: unsupported device "
                         f"{feats.device}")
    return feats.device.type


def _forward(kernel, feats, idx, w, self_rows=None, w_self=None,
             out_dtype=None):
    """The kernel's forward on a CUDA tensor, its plain version on a CPU
    tensor.  ``out_dtype``: the tiled forward's output dtype (see
    ``_check_kernel_args``)."""
    if _device_of(feats) == "cpu":
        return neighbor_agg_ref(feats, idx, w, self_rows, w_self, out_dtype)
    if kernel == "row":
        return _launch_row(feats, idx, w)
    return _launch(feats, idx, w, self_rows, w_self, out_dtype)


def _backward(feats, idx, w, g, self_rows, w_self, need):
    """The backward kernel on a CUDA tensor, its plain version on a CPU
    tensor; cotangents not in ``need`` come back as None."""
    g = g.to(feats.dtype).contiguous()
    if _device_of(feats) == "cpu":
        return neighbor_agg_backward_ref(feats, idx, w, g, self_rows, w_self,
                                         need)
    return _launch_backward(feats, idx, w, g, self_rows, w_self, need)


def _backward_identity(table, w, g, self_rows, w_self, need):
    """The backward kernel's identity mode on a CUDA tensor, its plain
    version on a CPU tensor; cotangents not in ``need`` come back as
    None."""
    g = g.to(table.dtype).contiguous()
    if _device_of(table) == "cpu":
        return neighbor_agg_backward_identity_ref(table, w, g, self_rows,
                                                  w_self, need)
    return _launch_backward_identity(table, w, g, self_rows, w_self, need)


def _grads(feats, idx, w, g, self_rows, w_self, need,
           rev: Optional[ReverseIndex]):
    """``_backward``, with dfeats from the reverse-index kernel (its
    plain version on a CPU tensor) when ``rev`` is given and dfeats is
    asked for; the other cotangents then come from ``_backward`` with
    dfeats not asked for."""
    if rev is None or not need[0]:
        return _backward(feats, idx, w, g, self_rows, w_self, need)
    g = g.to(feats.dtype).contiguous()
    if _device_of(feats) == "cpu":
        dfeats = neighbor_agg_backward_csr_ref(rev, w, g)
    else:
        dfeats = _launch_backward_csr(rev, w, g)
    rest = (False,) + tuple(need[1:])
    if not any(rest):
        return dfeats, None, None, None
    return (dfeats,) + tuple(_backward(feats, idx, w, g, self_rows, w_self,
                                       rest)[1:])


def neighbor_agg_backward(feats, idx, w, g, self_rows=None, w_self=None, *,
                          need=(True, True, True, True), rev=None):
    """The backward of ``neighbor_agg(..., use_kernel=True)`` called
    directly: ``(dfeats, dw, dself, dw_self)`` for the output cotangent
    ``g`` [B, D] (in feats' dtype), each None where ``need`` does not ask
    for it.  The backward kernel on a CUDA tensor, its plain version on a
    CPU tensor; with ``rev``, dfeats from the reverse-index kernel (or
    its plain version)."""
    _check_kernel_args(feats, idx, w, self_rows, w_self, rev)
    b, d = idx.shape[0], feats.shape[1]
    if g.shape != (b, d) or g.dtype != feats.dtype or \
            g.device != feats.device:
        raise ValueError(f"neighbor_agg backward: g must be {feats.dtype} "
                         f"{(b, d)} on {feats.device}, got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")
    return _grads(feats, idx, w, g, self_rows, w_self, need, rev)


def neighbor_agg_backward_identity(table, w, g, self_rows=None,
                                   w_self=None, *,
                                   need=(True, True, True, True)):
    """The backward of ``neighbor_agg_batch`` called directly:
    ``(dfeats [B·K, D], dw, dself, dw_self)`` of ``table`` [B·K, D] (the
    flattened fan-out level) with the identity ids ``b·K + k``, for the
    output cotangent ``g`` [B, D] (in the table's dtype), each None where
    ``need`` does not ask for it.  The backward kernel's identity mode on
    a CUDA tensor, its plain version on a CPU tensor."""
    _check_kernel_args(table, None, w, self_rows, w_self)
    b, d = w.shape[0], table.shape[1]
    if g.shape != (b, d) or g.dtype != table.dtype or \
            g.device != table.device:
        raise ValueError(f"neighbor_agg backward: g must be {table.dtype} "
                         f"{(b, d)} on {table.device}, got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")
    return _backward_identity(table, w, g, self_rows, w_self, need)


class _Agg(torch.autograd.Function):
    """Σ_k w[b,k]·feats[idx[b,k]] through the tiled or row kernel, with
    the backward kernel as its gradient (reference ``_agg``)."""

    @staticmethod
    def forward(ctx, feats, idx, w, kernel, rev):
        ctx.save_for_backward(feats, idx, w)
        ctx.rev = rev
        return _forward(kernel, feats, idx, w)

    @staticmethod
    def backward(ctx, g):
        feats, idx, w = ctx.saved_tensors
        need_f, _, need_w, _, _ = ctx.needs_input_grad
        dfeats, dw, _, _ = _grads(feats, idx, w, g, None, None,
                                  (need_f, need_w, False, False), ctx.rev)
        return dfeats, None, dw, None, None


class _AggSelf(torch.autograd.Function):
    """The fused variant: + w_self[b]·self_rows[b] in the tiled kernel's
    accumulator init (reference ``_agg_self``).  When ``self_rows`` is
    the table itself (GCN), autograd sums dfeats and dself."""

    @staticmethod
    def forward(ctx, feats, idx, w, self_rows, w_self, rev):
        ctx.save_for_backward(feats, idx, w, self_rows, w_self)
        ctx.rev = rev
        return _forward("tiled", feats, idx, w, self_rows, w_self)

    @staticmethod
    def backward(ctx, g):
        feats, idx, w, self_rows, w_self = ctx.saved_tensors
        need_f, _, need_w, need_s, need_ws, _ = ctx.needs_input_grad
        dfeats, dw, dself, dws = _grads(
            feats, idx, w, g, self_rows, w_self,
            (need_f, need_w, need_s, need_ws), ctx.rev)
        return dfeats, None, dw, dself, dws, None


def neighbor_agg(feats, idx, w, self_rows=None, w_self=None, *,
                 use_kernel: bool = False, kernel: str = "tiled",
                 rev: Optional[ReverseIndex] = None):
    """out[b] = Σ_k w[b,k] · feats[idx[b,k]]  [+ w_self[b] · self_rows[b]].

    feats [N, D]; idx [B, K] int32; w [B, K] (0 ⇒ padding edge); the
    optional self_rows [B, D] + w_self [B] ride the tiled kernel's fused
    accumulator init (the plain path and the ``"row"`` kernel add them
    outside, as the reference does).  ``kernel``: ``"tiled"`` (the fast
    one) | ``"row"`` (the reference's seed row kernel).  Differentiable
    with respect to feats, w, self_rows and w_self on every path.
    ``rev`` (kernel path only): the reverse index of ``(idx, w)`` from
    ``build_reverse_index``, which routes dfeats to the reverse-index
    kernel; without it nothing changes."""
    if kernel not in ("row", "tiled"):
        raise ValueError(f"kernel must be 'row' or 'tiled', got {kernel!r}")
    fused = self_rows is not None
    if fused != (w_self is not None):
        raise ValueError("self_rows and w_self must be passed together")
    if not use_kernel:
        if rev is not None:
            raise ValueError("rev routes the kernel path's backward; the "
                             "plain path (use_kernel=False) takes none")
        out = neighbor_agg_ref(feats, idx, w)
        return out + w_self[:, None] * self_rows if fused else out
    _check_kernel_args(feats, idx, w, self_rows, w_self, rev)
    _device_of(feats)
    if kernel == "row":
        out = _Agg.apply(feats, idx, w, "row", rev)
        return out + w_self[:, None] * self_rows if fused else out
    if fused:
        return _AggSelf.apply(feats, idx, w, self_rows, w_self, rev)
    return _Agg.apply(feats, idx, w, "tiled", rev)


# ---------------------------------------------------------------------------
# NODES-partitioned entry points (reference ``ops.py:204-405``)
# ---------------------------------------------------------------------------
# The tiled kernel runs once per shard on that shard's contiguous row
# block of the output / idx / w (+ self_rows / w_self), gathering from
# the whole table, so the forward needs no collective.  Only the table's
# gradient, summed into a table every shard reads, needs a psum; dw /
# dself_rows / dw_self are row-local like their primals.  On a
# process-group mesh each rank passes its own rows and launches once over
# them; the table is its all-gathered copy, whose adjoint (the caller's
# all_gather) sums the table's gradient over the ranks.

@dataclasses.dataclass(frozen=True, eq=False)
class ShardedReverseIndex:
    """The reverse index of each shard's row block of a NODES-sharded ELL
    ``(idx, w)``: ``shard_idx[s]`` is block ``s`` of ``idx`` on shard
    ``s``'s device and ``revs[s]`` its ``ReverseIndex`` over all N table
    rows.  ``idx`` is the global tensor it was built from and
    ``idx_version`` that tensor's ``_version`` then."""
    mesh: object
    idx: torch.Tensor
    idx_version: int
    shard_idx: Tuple[torch.Tensor, ...]
    revs: Tuple[ReverseIndex, ...]

    @property
    def nbytes(self) -> int:
        return sum(r.nbytes for r in self.revs)


def build_sharded_reverse_index(idx: torch.Tensor, w: torch.Tensor, n: int,
                                mesh) -> ShardedReverseIndex:
    """One ``build_reverse_index`` per shard, each over that shard's
    rows of ``(idx, w)`` (rows must divide the shards: pad first) and
    all ``n`` table rows, built on the shard's device; on a process-group
    mesh ``(idx, w)`` are this rank's rows and it builds their one."""
    from repro_torch import sharding as sh
    idx_s = sh.shard_rows(idx, mesh)
    w_s = sh.shard_rows(w, mesh)
    revs = tuple(build_reverse_index(i, ww, n) for i, ww in zip(idx_s, w_s))
    return ShardedReverseIndex(mesh=mesh, idx=idx, idx_version=idx._version,
                               shard_idx=tuple(idx_s), revs=revs)


def _shard_blocks(mesh, *tensors):
    """Per-shard row blocks of each tensor (None stays None), as one
    tuple per shard; on a process-group mesh the tensors are this rank's
    rows, its one block."""
    from repro_torch import sharding as sh
    cols = [sh.shard_rows(t, mesh) if t is not None
            else [None] * len(mesh.traced) for t in tensors]
    return list(zip(*cols))


class _AggSharded(torch.autograd.Function):
    """``neighbor_agg`` with rows split over the NODES shards and the table
    read whole by each (reference ``_agg_sharded``): one tiled launch per
    shard; the backward runs ``_grads`` per shard and psums dfeats."""

    @staticmethod
    def forward(ctx, feats, idx, w, self_rows, w_self, mesh, rev):
        from repro_torch import sharding as sh
        shards = _shard_blocks(mesh, idx, w, self_rows, w_self)
        if rev is not None:
            shards = [(ri,) + blk[1:] for ri, blk in zip(rev.shard_idx,
                                                         shards)]
        outs = []
        for s, (i_s, w_s, sr_s, ws_s) in enumerate(shards):
            f_s = feats.to(mesh.devices[s])
            _check_kernel_args(f_s, i_s, w_s, sr_s, ws_s,
                               rev.revs[s] if rev is not None else None)
            outs.append(_forward("tiled", f_s, i_s, w_s, sr_s, ws_s))
        ctx.save_for_backward(feats, idx, w, self_rows, w_self)
        ctx.mesh, ctx.rev = mesh, rev
        return sh.unshard_rows(outs, feats.device)

    @staticmethod
    def backward(ctx, g):
        from repro_torch import sharding as sh
        feats, idx, w, self_rows, w_self = ctx.saved_tensors
        mesh, rev = ctx.mesh, ctx.rev
        need_f, _, need_w, need_s, need_ws, _, _ = ctx.needs_input_grad
        need = (need_f, need_w, need_s and self_rows is not None,
                need_ws and self_rows is not None)
        shards = _shard_blocks(mesh, idx, w, self_rows, w_self,
                               g.contiguous())
        if rev is not None:
            shards = [(ri,) + blk[1:] for ri, blk in zip(rev.shard_idx,
                                                         shards)]
        grads = []
        for s, (i_s, w_s, sr_s, ws_s, g_s) in enumerate(shards):
            grads.append(_grads(feats.to(mesh.devices[s]), i_s, w_s, g_s,
                                sr_s, ws_s, need,
                                rev.revs[s] if rev is not None else None))
        dfeats = (sh.psum([gr[0] for gr in grads], mesh)[0].to(
            device=feats.device, dtype=feats.dtype) if need[0] else None)

        def rows(j):
            if not need[j]:
                return None
            return sh.unshard_rows([gr[j] for gr in grads], feats.device)
        return dfeats, None, rows(1), rows(2), rows(3), None, None


def neighbor_agg_sharded(feats, idx, w, self_rows=None, w_self=None, *,
                         mesh=None, use_kernel: bool = True,
                         rev: Optional[ShardedReverseIndex] = None):
    """``out[b] = Σ_k w[b,k]·feats[idx[b,k]] [+ w_self[b]·self_rows[b]]``
    partitioned over the NODES shards of ``mesh`` (reference
    ``neighbor_agg_sharded``): output rows / ``idx`` / ``w`` /
    ``self_rows`` / ``w_self`` split into contiguous row blocks, one per
    shard, and every shard gathers from the whole table.  Rows are
    padded with zero-weight edges up to a multiple of the shard count,
    so any B is legal.  ``rev`` (from ``build_sharded_reverse_index`` on
    this ``idx``, whose rows must then divide the shards) sends each
    shard's table gradient through the reverse-index kernel.

    With one shard this is bit-equal to ``neighbor_agg(...,
    use_kernel=True)``, forward and gradients (the psum of one part is
    that part).  ``mesh=None`` or ``use_kernel=False`` call
    ``neighbor_agg`` itself.

    On a process-group mesh ``idx`` / ``w`` / ``self_rows`` / ``w_self``
    and the output are this rank's rows and ``feats`` is its
    all-gathered copy of the whole table: one launch over the rank's
    block, no copy of the table and no collective here (the all-gather's
    adjoint sums the table's gradient over the ranks)."""
    fused = self_rows is not None
    if fused != (w_self is not None):
        raise ValueError("self_rows and w_self must be passed together")
    if mesh is None or not use_kernel:
        if rev is not None:
            raise ValueError("a ShardedReverseIndex needs a mesh and the "
                             "kernel path")
        return neighbor_agg(feats, idx, w, self_rows, w_self,
                            use_kernel=use_kernel, kernel="tiled")
    from repro_torch import sharding as sh
    b = idx.shape[0]
    n_sh = sh.nodes_shards(mesh)
    if rev is not None:
        if not isinstance(rev, ShardedReverseIndex):
            raise ValueError(f"rev must be a ShardedReverseIndex, got "
                             f"{type(rev).__name__}")
        if rev.idx is not idx or rev.idx_version != idx._version \
                or rev.mesh is not mesh:
            raise ValueError("neighbor_agg_sharded: rev was built for "
                             "another idx (or mesh), or idx changed in "
                             "place since")
    if mesh.rank_local:
        return neighbor_agg(feats, idx, w, self_rows, w_self,
                            use_kernel=True, kernel="tiled",
                            rev=None if rev is None else rev.revs[0])
    if rev is None and b % n_sh:
        idx, w = sh.pad_rows(idx, n_sh), sh.pad_rows(w, n_sh)
        if fused:
            self_rows = sh.pad_rows(self_rows, n_sh)
            w_self = sh.pad_rows(w_self, n_sh)
    _device_of(feats)
    out = _AggSharded.apply(feats, idx, w, self_rows, w_self, mesh, rev)
    return out[:b] if out.shape[0] != b else out


class _AggBatchSharded(torch.autograd.Function):
    """The mini-batch twin (reference ``_agg_batch_sharded``): each
    shard flattens its ``[b_loc, K, D]`` block of an already-gathered
    fan-out level to a ``[b_loc·K, D]`` table with identity ids, through
    the tiled forward and the backward kernel's identity mode; no
    collective in either direction."""

    @staticmethod
    def forward(ctx, w, h_nb, h_self, w_self, mesh):
        from repro_torch import sharding as sh
        outs = [_batch_forward(*blk) for blk in _shard_blocks(
            mesh, w, h_nb, h_self, w_self)]
        ctx.save_for_backward(w, h_nb, h_self, w_self)
        ctx.mesh = mesh
        return sh.unshard_rows(outs, h_nb.device)

    @staticmethod
    def backward(ctx, g):
        from repro_torch import sharding as sh
        w, h_nb, h_self, w_self = ctx.saved_tensors
        fused = h_self is not None
        need_w, need_nb, need_s, need_ws, _ = ctx.needs_input_grad
        need = (need_nb, need_w, need_s and fused, need_ws and fused)
        grads = [_batch_backward(*blk, need) for blk in _shard_blocks(
            ctx.mesh, w, h_nb, h_self, w_self, g.contiguous())]

        def rows(j):
            if grads[0][j] is None:
                return None
            return sh.unshard_rows([gr[j] for gr in grads], h_nb.device)
        return rows(0), rows(1), rows(2), rows(3), None


def _batch_forward(w, nb, self_rows, w_self):
    """The tiled forward on ``nb`` [b, K, D] as a [b·K, D] table with the
    identity ids ``b·K + k``."""
    b, k, d = nb.shape
    table = nb.reshape(b * k, d)
    ids = torch.arange(b * k, dtype=torch.int32,
                       device=nb.device).reshape(b, k)
    _check_kernel_args(table, ids, w, self_rows, w_self)
    return _forward("tiled", table, ids, w, self_rows, w_self)


def _batch_backward(w, nb, self_rows, w_self, g, need):
    """``_batch_forward``'s cotangents (dw, dnb [b, K, D], dself_rows,
    dw_self) by the backward kernel's identity mode."""
    dt, dw, dsr, dws = _backward_identity(nb.reshape(-1, nb.shape[-1]), w,
                                          g, self_rows, w_self, need)
    return dw, None if dt is None else dt.reshape(nb.shape), dsr, dws


class _AggBatch(torch.autograd.Function):
    """The weighted sum over an already-gathered fan-out level, unsharded
    (the twin of ``_AggBatchSharded`` on one device): the forward is the
    tiled kernel on the ``[B·K, D]`` table with identity ids, the
    backward the backward kernel's identity mode."""

    @staticmethod
    def forward(ctx, w, h_nb, h_self, w_self):
        ctx.save_for_backward(w, h_nb, h_self, w_self)
        return _batch_forward(w, h_nb, h_self, w_self)

    @staticmethod
    def backward(ctx, g):
        w, h_nb, h_self, w_self = ctx.saved_tensors
        fused = h_self is not None
        need_w, need_nb, need_s, need_ws = ctx.needs_input_grad
        return _batch_backward(w, h_nb, h_self, w_self, g,
                               (need_nb, need_w, need_s and fused,
                                need_ws and fused))


def neighbor_agg_batch(w, h_nb, h_self=None, w_self=None):
    """``out[b] = Σ_k w[b,k]·h_nb[b,k] [+ w_self[b]·h_self[b]]`` over an
    ALREADY-GATHERED fan-out level (``h_nb [B, K, D]``, ``w [B, K]`` [+
    fused ``h_self [B, D]`` / ``w_self [B]``]) through the kernels: the
    tiled forward on ``h_nb`` flattened to a ``[B·K, D]`` table with the
    identity ids ``b·K + k`` (the same launch, route and bits as
    ``neighbor_agg(table, ids, w, ..., use_kernel=True)``), and for its
    gradient the backward kernel's identity mode (no atomics, no zero
    fill).  Plain versions of both on a CPU tensor."""
    fused = h_self is not None
    if fused != (w_self is not None):
        raise ValueError("h_self and w_self must be passed together")
    _device_of(h_nb)
    return _AggBatch.apply(w.contiguous(), h_nb.contiguous(), h_self,
                           w_self)


def neighbor_agg_batch_sharded(w, h_nb, h_self=None, w_self=None, *, mesh):
    """The tiled kernel's weighted sum over an ALREADY-GATHERED fan-out
    level (``h_nb [B, K, D]``, ``w [B, K]`` [+ fused ``h_self [B, D]`` /
    ``w_self [B]``]) with the target rows split over the NODES shards
    (reference ``neighbor_agg_batch_sharded``).  B must be a multiple of
    the shard count (the sharded mini-batch source rounds b up at bind,
    and fan-out products keep every level divisible).  With one shard
    this is bit-equal to the unsharded mini-batch kernel path.  On a
    process-group mesh the operands are this rank's target rows: one
    ``neighbor_agg_batch`` launch over them."""
    fused = h_self is not None
    if fused != (w_self is not None):
        raise ValueError("h_self and w_self must be passed together")
    from repro_torch import sharding as sh
    if mesh.rank_local:
        return neighbor_agg_batch(w, h_nb, h_self, w_self)
    n_sh = sh.nodes_shards(mesh)
    if w.shape[0] % n_sh:
        raise ValueError(
            f"neighbor_agg_batch_sharded: B={w.shape[0]} must be a "
            f"multiple of the {n_sh} NODES shards (the sharded sources "
            f"round b up to a mesh multiple at bind)")
    _device_of(h_nb)
    return _AggBatchSharded.apply(w.contiguous(), h_nb.contiguous(),
                                  h_self, w_self, mesh)


# -- NODES-sharded feature table + degree-ordered hot cache -----------------
# Kept in its own module; re-exported so callers keep one import surface
# for every neighbor-agg front end (as the reference does).
from repro_torch.kernels.neighbor_agg.featshard import (  # noqa: E402
    FeatShardPlan, build_featshard_plan, neighbor_agg_featshard,
    resolve_cache_rows)
