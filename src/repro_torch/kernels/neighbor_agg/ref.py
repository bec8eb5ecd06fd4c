"""Plain torch versions of the neighbor-aggregation kernels (forward and
backward).

out[b, :] = sum_k w[b, k] * feats[idx[b, k], :]
            (+ w_self[b] * self_rows[b, :])

Gathers, takes the weighted sum in f32 and casts back to ``feats.dtype``
(the reference oracle ``repro/kernels/neighbor_agg/ref.py:12-16``).  With
``self_rows``/``w_self`` the self term joins the f32 sum before the one
cast, as the fused kernel's accumulator init does.  The CPU tests use it,
the kernel wrapper takes it for CPU tensors, and ``chip_smoke.py`` holds
the CUDA kernel against it on the card."""
from __future__ import annotations

import torch


def neighbor_agg_ref(feats, idx, w, self_rows=None, w_self=None):
    """feats [N, D]; idx [B, K] int32/int64; w [B, K] (0 = padding);
    optional self_rows [B, D] + w_self [B]."""
    b, k = idx.shape
    gathered = torch.index_select(feats, 0, idx.reshape(-1)).reshape(
        b, k, feats.shape[1])                                # [B, K, D]
    acc = torch.einsum("bk,bkd->bd", w.float(), gathered.float())
    if self_rows is not None:
        acc = w_self.float()[:, None] * self_rows.float() + acc
    return acc.to(feats.dtype)


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
