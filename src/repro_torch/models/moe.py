"""Top-1 (Switch-style) Mixture-of-Experts with grouped capacity routing
(reference ``repro/models/moe.py``).

Tokens are routed in groups of ``cfg.moe_group`` (sequence chunks of
each batch element), so the one-hot dispatch einsum stays
O(T * E * C_g * d) with C_g = ceil(cf * T_g / E) tokens an expert a
group.  A token past its expert's capacity is dropped: its output is 0
and the residual carries it.  Parameters keep the reference's layout
(``router [d, E]``, ``w_gate`` and ``w_up [E, d, f]``, ``w_down
[E, f, d]``), so its arrays load unchanged.

Under a ``model`` axis (``moe_block(..., tp=)``) the experts are split
over the shards where ``E % MODEL_PAR == 0`` (``param_specs``), as the
reference's ``model`` axis holds them: every shard routes the whole
gathered sequence with its copy of the router, runs its own experts'
tokens, and ``_combine``'s partial sums over its experts go back to the
sequence-sharded stream by one ``psum_scatter`` over the routing groups
(reference ``moe.py:87-119``), a ``psum`` where the groups do not split.
The reference moves the tokens to the experts by GSPMD's all-to-all; the
port gathers the sequence instead (one ``all_gather``, as attention
does).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch import sharding as sh
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


def moe_block(params, x, cfg: ModelConfig, *, tp=None, rs: bool = False):
    """x: [B, S, d] -> (y, aux_loss).  Top-1 capacity routing over
    groups of ``min(moe_group, S)`` tokens; S must divide into them.
    With ``tp``: lists (the stream as ``layers`` takes it) -> (y parts,
    aux parts)."""
    if tp is not None:
        return _moe_block_tp(params, x, cfg, tp, rs)
    b, s, d = x.shape
    dispatch, gate, _, aux, g, tg = route(params, x, cfg)
    return _experts(params, x, cfg, dispatch, gate, g, tg).reshape(
        b, s, d), aux


def _experts(params, x, cfg: ModelConfig, dispatch, gate, g: int, tg: int,
             experts: slice = slice(None), f32_out: bool = False):
    """The combined output [b, g, t, d] of ``experts`` (the rows of the
    expert weights in ``params``) for the routing ``dispatch`` / ``gate``
    over all E experts; ``f32_out``: a shard's share of the combine, as
    ``layers.partial_product`` gives it."""
    b, s, d = x.shape
    dt = x.dtype
    dispatch = dispatch[..., experts, :]
    combine = (dispatch * gate[..., None, None]).to(dt)
    dispatch = dispatch.to(dt)
    xg = x.reshape(b, g, tg, d)
    xe = torch.einsum("bgtec,bgtd->bgecd", dispatch, xg)
    h = torch.einsum("bgecd,edf->bgecf", xe, params["w_gate"].to(dt))
    h = F.gelu(h, approximate="tanh") if cfg.mlp_act == "gelu" \
        else F.silu(h)
    h = h * torch.einsum("bgecd,edf->bgecf", xe, params["w_up"].to(dt))
    ye = torch.einsum("bgecf,efd->bgecd", h, params["w_down"].to(dt))
    if f32_out:
        from repro_torch.models.layers import _ProductF32
        if dt == torch.float32:
            return _combine(combine, ye)
        e, c = combine.shape[-2:]
        return _ProductF32.apply(
            combine.reshape(b * g, tg, e * c),
            ye.reshape(b * g, e * c, d)).reshape(b, g, tg, d)
    return _combine(combine, ye)


def _combine(combine, ye):
    """Un-dispatch: contract experts x capacity back to tokens."""
    return torch.einsum("bgtec,bgecd->bgtd", combine, ye)


def _moe_block_tp(params, x, cfg: ModelConfig, tp, rs: bool):
    from repro_torch.models.layers import is_f32_partial, tp_gather, tp_reduce
    xs = tp_gather(x, tp, rs)
    b, s, d = xs[0].shape
    split = tp.size > 1 and cfg.n_experts % sh.MODEL_PAR == 0
    e_loc = params[0]["w_gate"].shape[0]
    parts, auxs = [], []
    for p, xf, pos in zip(params, xs, tp.positions):
        dispatch, gate, _, aux, g, tg = route(p, xf, cfg)
        experts = slice(pos * e_loc, (pos + 1) * e_loc) if split \
            else slice(None)
        parts.append(_experts(p, xf, cfg, dispatch, gate, g, tg, experts,
                              f32_out=split))
        auxs.append(aux)
    dt = xs[0].dtype
    f32p = is_f32_partial(parts[0], dt)
    if split and rs and g % tp.size == 0:
        # the reference's reduce-scatter onto the sequence-group dim
        y = sh.psum_scatter(parts, tp, dim=1, f32_partial=f32p)
        return [t.reshape(b, s // tp.size, d).to(dt) for t in y], auxs
    if split:
        y = [t.reshape(b, s, d).to(dt)
             for t in sh.psum(parts, tp, f32_partial=f32p)]
        return tp_reduce(y, tp, rs, False), auxs
    return tp_reduce([t.reshape(b, s, d) for t in parts], tp, rs,
                     False), auxs
