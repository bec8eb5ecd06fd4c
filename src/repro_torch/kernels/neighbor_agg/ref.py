"""Plain torch version of the neighbor-aggregation kernel.

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
