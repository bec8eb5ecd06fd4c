"""Public wrapper of the weighted neighbor aggregation and its gradient.

``neighbor_agg`` mirrors the reference wrapper
(``repro/kernels/neighbor_agg/ops.py:170-202``) and its custom VJP
(``:46-114``):

* ``use_kernel=False`` — the plain version plus the unfused
  ``w_self[:, None] * self_rows`` epilogue (``ops.py:191-193``),
  differentiated by torch autograd;
* ``use_kernel=True`` — a ``torch.autograd.Function`` (``_Agg``, or
  ``_AggSelf`` with the fused epilogue) whose forward is the tiled CUDA
  kernel (``csrc/neighbor_agg.cu``) or, for ``kernel="row"``, the row
  kernel (``csrc/neighbor_agg_row.cu``, self term added outside as the
  reference does), and whose backward is the CUDA backward kernel
  (``csrc/neighbor_agg_bwd.cu``).  On a CUDA tensor each of them
  launches or raises: never a quiet fallback.  On a CPU tensor the same
  Functions run the kernels' plain versions (``ref.neighbor_agg_ref``
  and ``ref.neighbor_agg_backward_ref``), because the tensor lies on the
  CPU.

With a reverse index (``rev=build_reverse_index(idx, w, n)``, the
full-graph path's) dfeats comes instead from the reverse-index backward
kernel (``csrc/neighbor_agg_bwd_csr.cu``; on a CPU tensor its plain
version ``ref.neighbor_agg_backward_csr_ref``): a gather over the
transposed ELL, one warp per source row, no atomics, bit-identical from
run to run.  dw, dself and dw_self still come from the backward kernel,
which then sends no atomics.  The index is checked against the call:
the same ``idx`` object at the same version, the same shapes and device,
and ``w`` zero on every edge the index left out (an on-device assert, no
host sync).  On a CUDA tensor that kernel launches or raises; it never
gives way to the atomic kernel.

The backward reads ``ctx.needs_input_grad``: no scatter when ``feats``
needs no gradient, no dot when ``w`` needs none (on the model paths the
weights, masks and layer 1's raw feature table never do).  ``dfeats`` is
summed in f32 and cast to ``feats.dtype``; ``dw`` is in ``w.dtype``.
The kernels mask ragged B/K/D themselves, so nothing is padded to tiles.

One launch counter per kernel, changed only where that kernel launches:
``launches`` (tiled forward), ``backward_launches``,
``backward_csr_launches`` and ``row_launches``.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import torch

from repro_torch.kernels.neighbor_agg.ref import (
    neighbor_agg_backward_csr_ref, neighbor_agg_backward_ref,
    neighbor_agg_ref)

#: launches of the tiled forward kernel
launches = 0
#: launches of the backward kernel
backward_launches = 0
#: launches of the reverse-index backward kernel
backward_csr_launches = 0
#: launches of the row kernel
row_launches = 0
_count_lock = threading.Lock()


def reset_launches() -> None:
    """Set every kernel's launch counter to 0."""
    global launches, backward_launches, backward_csr_launches, row_launches
    with _count_lock:
        launches = backward_launches = backward_csr_launches = 0
        row_launches = 0


def launch_counts() -> dict:
    """The launch counters by kernel: tiled, backward, backward_csr,
    row."""
    return {"tiled": launches, "backward": backward_launches,
            "backward_csr": backward_csr_launches, "row": row_launches}


def _count(name: str) -> None:
    global launches, backward_launches, backward_csr_launches, row_launches
    with _count_lock:
        if name == "tiled":
            launches += 1
        elif name == "backward":
            backward_launches += 1
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
    pos = torch.nonzero(kept.reshape(-1)).squeeze(1)        # ascending
    src = idx.reshape(-1)[pos].long()
    order = torch.sort(src, stable=True).indices
    indptr = torch.zeros(n + 1, dtype=torch.int32, device=idx.device)
    indptr[1:] = torch.cumsum(torch.bincount(src, minlength=n), 0)
    return ReverseIndex(indptr=indptr, edges=pos[order].to(torch.int32),
                        kept=kept, n=int(n), b=b, k=k, idx=idx,
                        idx_version=idx._version)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_kernel_args(feats, idx, w, self_rows, w_self, rev=None) -> None:
    """Raise on anything the kernel does not take (checked on every
    device, so the CPU tests hold the same contract as the card).  A
    reverse index must be the one of this ``idx`` (object and version),
    shapes and device; ``w`` nonzero on an edge it left out fails an
    on-device assert (raised at once on the CPU, by the card's next
    synchronising call on a CUDA tensor)."""
    def req(cond, msg):
        if not cond:
            raise ValueError(f"neighbor_agg kernel: {msg}")
    req(feats.dim() == 2, f"feats must be [N, D], got {tuple(feats.shape)}")
    req(feats.dtype in _DTYPE_CODE,
        f"feats dtype must be float32 or bfloat16, got {feats.dtype}")
    req(idx.dim() == 2 and idx.dtype == torch.int32,
        f"idx must be int32 [B, K], got {idx.dtype} {tuple(idx.shape)}")
    req(w.shape == idx.shape and w.dtype == feats.dtype,
        f"w must be {feats.dtype} {tuple(idx.shape)}, got {w.dtype} "
        f"{tuple(w.shape)}")
    ops = [feats, idx, w]
    if self_rows is not None:
        b, d = idx.shape[0], feats.shape[1]
        req(self_rows.shape == (b, d) and self_rows.dtype == feats.dtype,
            f"self_rows must be {feats.dtype} {(b, d)}, got "
            f"{self_rows.dtype} {tuple(self_rows.shape)}")
        req(w_self.shape == (b,) and w_self.dtype == feats.dtype,
            f"w_self must be {feats.dtype} {(b,)}, got {w_self.dtype} "
            f"{tuple(w_self.shape)}")
        ops += [self_rows, w_self]
    req(all(t.device == feats.device for t in ops),
        "all operands must be on one device")
    req(all(t.is_contiguous() for t in ops), "operands must be contiguous")
    req(feats.shape[0] > 0 or idx.shape[1] == 0,
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


def _launch(feats, idx, w, self_rows, w_self):
    from repro_torch.kernels.neighbor_agg.build import load_library
    n, d = feats.shape
    b, k = idx.shape
    out = torch.empty((b, d), dtype=feats.dtype, device=feats.device)
    if b == 0 or d == 0:                         # nothing to compute
        return out
    lib = load_library()
    with torch.cuda.device(feats.device):     # launch on the tensors' card
        err = lib.neighbor_agg_forward(
            _DTYPE_CODE[feats.dtype], feats.data_ptr(), idx.data_ptr(),
            w.data_ptr(), _ptr(self_rows), _ptr(w_self), out.data_ptr(), n,
            b, k, d, _stream(feats))
    _raise_on(err, "neighbor_agg (tiled)", b, k, d, n, feats.dtype)
    _count("tiled")
    return out


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
    if b > 0 and d > 0 and any(o is not None for o in outs):
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


def _launch_backward_csr(rev, w, g):
    """dfeats [N, D] in g's dtype from the reverse-index kernel; every
    row is written, so nothing is zeroed first."""
    from repro_torch.kernels.neighbor_agg.build import load_library
    d = g.shape[1]
    out = torch.empty((rev.n, d), dtype=g.dtype, device=g.device)
    if rev.n == 0 or d == 0:                     # nothing to compute
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
    if feats.device.type not in ("cpu", "cuda"):
        raise ValueError(f"neighbor_agg kernel: unsupported device "
                         f"{feats.device}")
    return feats.device.type


def _forward(kernel, feats, idx, w, self_rows=None, w_self=None):
    """The kernel's forward on a CUDA tensor, its plain version on a CPU
    tensor."""
    if _device_of(feats) == "cpu":
        return neighbor_agg_ref(feats, idx, w, self_rows, w_self)
    if kernel == "row":
        return _launch_row(feats, idx, w)
    return _launch(feats, idx, w, self_rows, w_self)


def _backward(feats, idx, w, g, self_rows, w_self, need):
    """The backward kernel on a CUDA tensor, its plain version on a CPU
    tensor; cotangents not in ``need`` come back as None."""
    g = g.to(feats.dtype).contiguous()
    if _device_of(feats) == "cpu":
        return neighbor_agg_backward_ref(feats, idx, w, g, self_rows, w_self,
                                         need)
    return _launch_backward(feats, idx, w, g, self_rows, w_self, need)


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
