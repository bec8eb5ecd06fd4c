"""Top-1 (Switch-style) Mixture-of-Experts with grouped capacity routing
(reference ``repro/models/moe.py``).

Tokens are routed in groups of ``cfg.moe_group`` (sequence chunks of
each batch element), so the one-hot dispatch einsum stays
O(T * E * C_g * d) with C_g = ceil(cf * T_g / E) tokens an expert a
group.  A token past its expert's capacity is dropped: its output is 0
and the residual carries it.  Parameters keep the reference's layout
(``router [d, E]``, ``w_gate`` and ``w_up [E, d, f]``, ``w_down
[E, f, d]``), so its arrays load unchanged.  On one card the
reference's sharding constraints are the identity and its
``shard_map`` combine needs a mesh: ``_combine`` is its plain einsum.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def init_moe(gen: torch.Generator, cfg: ModelConfig, *, device,
             dtype=torch.float32) -> Dict[str, Any]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    kw = dict(generator=gen, device=device, dtype=dtype)
    sc_in = 1.0 / math.sqrt(d)
    sc_out = 1.0 / math.sqrt(f)
    return {"router": torch.randn(d, e, **kw).mul_(sc_in),
            "w_gate": torch.randn(e, d, f, **kw).mul_(sc_in),
            "w_up": torch.randn(e, d, f, **kw).mul_(sc_in),
            "w_down": torch.randn(e, f, d, **kw).mul_(sc_out)}


def capacity(cfg: ModelConfig, group: int) -> int:
    return max(1, math.ceil(cfg.capacity_factor * group / cfg.n_experts))


def route(params, x, cfg: ModelConfig, expert=None):
    """The routing of ``moe_block``: (dispatch [b, g, t, E, C] in f32,
    gate [b, g, t], each token's expert [b, g, t], aux, groups g, group
    size t).  ``expert`` [b, g, t] sends each token to the given expert
    in place of the router's choice (the router's probability of it
    gates the output); by default the router's argmax."""
    b, s, d = x.shape
    e = cfg.n_experts
    tg = min(cfg.moe_group, s)
    g = s // tg
    if g * tg != s:
        raise ValueError(f"moe_block: sequence {s} is not a multiple of "
                         f"the routing group {tg}")
    c = capacity(cfg, tg)
    xg = x.reshape(b, g, tg, d)
    logits = torch.einsum("bgtd,de->bgte", xg, params["router"].to(x.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    if expert is None:
        expert = probs.argmax(-1)
    gate = probs.gather(-1, expert[..., None])[..., 0]  # [b, g, t]
    onehot = F.one_hot(expert, e).float()

    # Switch-transformer load-balance auxiliary loss
    frac_tokens = onehot.mean(2)                        # [b, g, e]
    frac_probs = probs.mean(2)
    aux = e * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))

    # position of each token in its expert's queue; drop beyond capacity.
    # jax.nn.one_hot gives a zero row for pos -1 (not routed) or >= c
    # (dropped); F.one_hot raises there, so the index is clamped and the
    # rows that are not kept are zeroed by `keep`
    pos = torch.cumsum(onehot, dim=2) * onehot - 1.0   # [b, g, t, e]
    keep = (pos >= 0) & (pos < c)
    pos_oh = F.one_hot(pos.long().clamp(0, c - 1), c).float()
    dispatch = (onehot * keep)[..., None] * pos_oh      # [b, g, t, e, c]
    return dispatch, gate, expert, aux, g, tg


def moe_block(params, x, cfg: ModelConfig):
    """x: [B, S, d] -> (y, aux_loss).  Top-1 capacity routing over
    groups of ``min(moe_group, S)`` tokens; S must divide into them."""
    b, s, d = x.shape
    dt = x.dtype
    dispatch, gate, _, aux, g, tg = route(params, x, cfg)
    combine = (dispatch * gate[..., None, None]).to(dt)
    dispatch = dispatch.to(dt)
    xg = x.reshape(b, g, tg, d)
    xe = torch.einsum("bgtec,bgtd->bgecd", dispatch, xg)
    h = torch.einsum("bgecd,edf->bgecf", xe, params["w_gate"].to(dt))
    h = F.gelu(h, approximate="tanh") if cfg.mlp_act == "gelu" \
        else F.silu(h)
    h = h * torch.einsum("bgecd,edf->bgecf", xe, params["w_up"].to(dt))
    ye = torch.einsum("bgecf,efd->bgecd", h, params["w_down"].to(dt))
    return _combine(combine, ye).reshape(b, s, d), aux


def _combine(combine, ye):
    """Un-dispatch: contract experts x capacity back to tokens."""
    return torch.einsum("bgtec,bgecd->bgtd", combine, ye)
