"""Public wrapper of the weighted neighbor aggregation.

``neighbor_agg`` is the forward of the reference wrapper
(``repro/kernels/neighbor_agg/ops.py:170-202``):

* ``use_kernel=False`` — the plain version plus the unfused
  ``w_self[:, None] * self_rows`` epilogue (``ops.py:191-193``);
* ``use_kernel=True`` on a CUDA tensor — the hand-written kernel
  (``csrc/neighbor_agg.cu``), fused epilogue included, or an exception:
  never a quiet fallback;
* ``use_kernel=True`` on a CPU tensor — the kernel's plain version
  (``ref.neighbor_agg_ref``), because the tensor lies on the CPU.

The kernel masks ragged B/K/D itself, so nothing is padded to tiles.
``launches`` counts kernel launches; it changes only where one happens.
The backward kernels (scatter-add dfeats, gathered-dot dw) come with the
training part of the port.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels.neighbor_agg.ref import neighbor_agg_ref

#: number of CUDA kernel launches made through ``neighbor_agg``
launches = 0
_count_lock = threading.Lock()

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_kernel_args(feats, idx, w, self_rows, w_self) -> None:
    """Raise on anything the kernel does not take (checked on every
    device, so the CPU tests hold the same contract as the card)."""
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


def _launch(feats, idx, w, self_rows, w_self):
    global launches
    from repro_torch.kernels.neighbor_agg.build import load_library
    n, d = feats.shape
    b, k = idx.shape
    out = torch.empty((b, d), dtype=feats.dtype, device=feats.device)
    if b == 0 or d == 0:                         # nothing to compute
        return out
    lib = load_library()
    fused = self_rows is not None
    with torch.cuda.device(feats.device):     # launch on the tensors' card
        err = lib.neighbor_agg_forward(
            _DTYPE_CODE[feats.dtype], feats.data_ptr(), idx.data_ptr(),
            w.data_ptr(), self_rows.data_ptr() if fused else None,
            w_self.data_ptr() if fused else None, out.data_ptr(), n, b, k,
            d, torch.cuda.current_stream(feats.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"neighbor_agg CUDA kernel launch failed with error {err} "
            f"(B={b}, K={k}, D={d}, N={n}, dtype={feats.dtype})")
    with _count_lock:
        launches += 1
    return out


def neighbor_agg(feats, idx, w, self_rows=None, w_self=None, *,
                 use_kernel: bool = False, kernel: str = "tiled"):
    """out[b] = Σ_k w[b,k] · feats[idx[b,k]]  [+ w_self[b] · self_rows[b]].

    feats [N, D]; idx [B, K] int32; w [B, K] (0 ⇒ padding edge); the
    optional self_rows [B, D] + w_self [B] ride the kernel's fused
    accumulator init (the plain path adds them outside, as the
    reference does).  ``kernel="row"`` (the reference's seed row kernel)
    is not ported yet."""
    if kernel not in ("row", "tiled"):
        raise ValueError(f"kernel must be 'row' or 'tiled', got {kernel!r}")
    fused = self_rows is not None
    if fused != (w_self is not None):
        raise ValueError("self_rows and w_self must be passed together")
    if not use_kernel:
        out = neighbor_agg_ref(feats, idx, w)
        return out + w_self[:, None] * self_rows if fused else out
    if kernel == "row":
        raise NotImplementedError(
            "neighbor_agg(kernel='row'): the row kernel "
            "(neighbor_agg_pallas) is not ported yet — ROADMAP.md Queue 2, "
            "item 2; use kernel='tiled'")
    _check_kernel_args(feats, idx, w, self_rows, w_self)
    if feats.device.type == "cpu":
        return neighbor_agg_ref(feats, idx, w, self_rows, w_self)
    if feats.device.type != "cuda":
        raise ValueError(f"neighbor_agg kernel: unsupported device "
                         f"{feats.device}")
    return _launch(feats, idx, w, self_rows, w_self)
