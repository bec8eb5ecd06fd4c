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
