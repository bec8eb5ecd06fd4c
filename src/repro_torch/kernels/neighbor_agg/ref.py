"""Plain torch versions of the neighbor-aggregation kernels (forward and
backward).

out[b, :] = sum_k w[b, k] * feats[idx[b, k], :]
            (+ w_self[b] * self_rows[b, :])

Gathers, takes the weighted sum in f32 and casts back to ``feats.dtype``
(the reference oracle ``repro/kernels/neighbor_agg/ref.py:12-16``).  With
``self_rows``/``w_self`` the self term joins the f32 sum before the one
cast, as the fused kernel's accumulator init does.  The CPU tests use it,
the kernel wrapper takes it for CPU tensors, and ``chip_smoke.py`` holds
the CUDA kernel against it on the card.

Both routes of the tiled forward (``csrc/neighbor_agg.cu``,
``csrc/neighbor_agg_slab.cu``) are held to ``neighbor_agg_ref`` row by
row with ``FWD_ROW_TOL``.

``neighbor_agg_backward_identity_ref`` is the plain version of the
backward kernel's identity mode (``csrc/neighbor_agg_bwd.cu``, the
mini-batch path's): ids ``b·K + k``, dfeats the broadcast product, no
``index_add_``.

``neighbor_agg_backward_csr_ref`` is the plain version of the
reverse-index backward kernel (``csrc/neighbor_agg_bwd_csr.cu``): dfeats
as a segment sum over the transposed ELL, held row by row with
``row_rel_err``."""
from __future__ import annotations

import torch

#: the limit of ``row_rel_err`` (``kernels/flash_attn/ref.py``) for the
#: reverse-index backward kernel in bf16 against its plain version run in
#: f32 on the same inputs.  The kernel sums in f32 and rounds each output
#: to bf16 once, which moves a value by at most u/(1+u) of it (u = 2^-8),
#: so no row's relative error can reach 2^-8 (f32 sums in another order
#: differ by ~1e-7, far inside the margin of u^2).
CSR_BF16_ROW_TOL = 2.0 ** -8

#: the limits of ``row_rel_err`` for the tiled forward (either route)
#: against its plain version run in f32 on the same inputs: one rounding
#: of each output to bf16 (the argument of ``CSR_BF16_ROW_TOL``), and f32
#: sums in another order (f32).
FWD_ROW_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8}


def neighbor_agg_ref(feats, idx, w, self_rows=None, w_self=None,
                     out_dtype=None):
    """feats [N, D]; idx [B, K] int32/int64; w [B, K] (0 = padding);
    optional self_rows [B, D] + w_self [B]; the sum cast to
    ``out_dtype`` (``feats.dtype`` when None)."""
    b, k = idx.shape
    gathered = torch.index_select(feats, 0, idx.reshape(-1)).reshape(
        b, k, feats.shape[1])                                # [B, K, D]
    acc = torch.einsum("bk,bkd->bd", w.float(), gathered.float())
    if self_rows is not None:
        acc = w_self.float()[:, None] * self_rows.float() + acc
    return acc.to(feats.dtype if out_dtype is None else out_dtype)


def neighbor_agg_backward_ref(feats, idx, w, g, self_rows=None,
                              w_self=None, need=(True, True, True, True)):
    """Cotangents of ``neighbor_agg_ref`` for the output cotangent ``g``
    [B, D]: ``(dfeats [N, D], dw [B, K], dself [B, D], dw_self [B])``,
    each None where ``need`` does not ask for it (the last two always
    None without ``self_rows``)."""
    b, k = idx.shape
    d = feats.shape[1]
    g32 = g.float()
    flat = idx.reshape(-1).long()
    dfeats = dw = dself = dw_self = None
    if need[1]:
        rows = torch.index_select(feats, 0, flat).reshape(b, k, d).float()
        dw = torch.einsum("bd,bkd->bk", g32, rows).to(w.dtype)
    if need[0]:
        contrib = (w.float()[:, :, None] * g32[:, None, :]).reshape(b * k, d)
        dfeats = torch.zeros(feats.shape, dtype=torch.float32,
                             device=feats.device).index_add_(0, flat, contrib)
        dfeats = dfeats.to(feats.dtype)
    if self_rows is not None and need[2]:
        dself = (w_self.float()[:, None] * g32).to(self_rows.dtype)
    if self_rows is not None and need[3]:
        dw_self = torch.einsum("bd,bd->b", g32, self_rows.float()).to(
            w_self.dtype)
    return dfeats, dw, dself, dw_self


def neighbor_agg_backward_identity_ref(table, w, g, self_rows=None,
                                      w_self=None,
                                      need=(True, True, True, True)):
    """Cotangents of ``neighbor_agg_ref(table, ids, w, ...)`` with the
    identity ids ``ids[b, k] = b·K + k`` (``table`` [B·K, D], one row an
    edge), the plain version of the backward kernel's identity mode: no
    id is read and no row is summed into, so dfeats is the broadcast
    product ``w[b, k] · g[b]`` in f32, cast once to ``table``'s dtype
    (zero-weight edges +0, whatever g holds, as the kernel writes them).
    The rest as ``neighbor_agg_backward_ref``."""
    b, k = w.shape
    d = g.shape[1]
    g32 = g.float()
    dfeats = dw = dself = dw_self = None
    if need[1]:
        dw = torch.einsum("bd,bkd->bk", g32,
                          table.reshape(b, k, d).float()).to(w.dtype)
    if need[0]:
        w32 = w.float()[:, :, None]
        dfeats = torch.where(w32 != 0, w32 * g32[:, None, :], 0.0).reshape(
            b * k, d).to(table.dtype)
    if self_rows is not None and need[2]:
        dself = (w_self.float()[:, None] * g32).to(self_rows.dtype)
    if self_rows is not None and need[3]:
        dw_self = torch.einsum("bd,bd->b", g32, self_rows.float()).to(
            w_self.dtype)
    return dfeats, dw, dself, dw_self


def neighbor_agg_backward_csr_ref(rev, w, g):
    """dfeats [N, D] of ``neighbor_agg_ref`` for the output cotangent
    ``g`` [B, D], walked as the reverse-index kernel walks it: for each
    source row n, the edges ``rev.edges[rev.indptr[n]:rev.indptr[n+1]]``
    in that order, each adding ``w[e] * g[e // K]``, summed in f32 and
    cast to ``g``'s dtype once.  Edges of weight 0 add nothing (so a
    non-finite g row behind one does not spread), and a row with no edge
    is 0.  ``rev`` is an ``ops.ReverseIndex``."""
    d = g.shape[1]
    e = rev.edges                  # int32 indexes as it is: no cast pass
    counts = rev.indptr[1:] - rev.indptr[:-1]
    seg = torch.repeat_interleave(
        torch.arange(rev.n, device=g.device), counts)
    we = w.reshape(-1)[e].float()
    nz = we != 0
    e, we, seg = e[nz], we[nz], seg[nz]
    contrib = g.float()[torch.div(e, max(rev.k, 1), rounding_mode="floor")]
    contrib.mul_(we[:, None])
    out = torch.zeros((rev.n, d), dtype=torch.float32, device=g.device)
    return out.index_add_(0, seg, contrib).to(g.dtype)
