"""Plain torch version of causal, optionally sliding-window, attention
(the reference's oracle ``repro/kernels/flash_attn/ref.py:10-22``):
materialised ``[B, H, S, S]`` scores in f32, a ``-1e30`` mask, softmax,
and the probabilities cast to the input dtype before the PV product."""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q, k, v: [B, H, S, D] -> [B, H, S, D]."""
    s = q.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if causal:
        pos = torch.arange(s, device=q.device)
        mask = pos[None, :] <= pos[:, None]
        if window:
            mask = mask & (pos[None, :] > pos[:, None] - window)
        scores = torch.where(mask, scores, torch.tensor(
            -1e30, dtype=scores.dtype, device=q.device))
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


#: the limit of ``row_rel_err`` for the bf16 tensor-core kernel against
#: this plain version run in f32 on the same bf16 inputs.  The kernel
#: rounds to bf16 twice, P before the PV product and the output at the
#: store, each by at most u = 2^-8 of the value; the limit is 2u.
BF16_ROW_TOL = 2.0 ** -7


def row_rel_err(out, ref) -> float:
    """Largest relative error of one output row of [B, S, H, D]: the max
    over (b, s, h) of ||out - ref|| / ||ref|| along D (0 for a row where
    both are 0).  A limit on it follows the rounding of each row, however
    small the row's values are."""
    if out.numel() == 0:
        return 0.0
    err = (out.float() - ref.float()).norm(dim=-1)
    return float((err / ref.float().norm(dim=-1).clamp_min(1e-30)).max())
