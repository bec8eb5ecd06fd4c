"""Mamba2 / SSD (state-space duality) block, chunked algorithm (reference
``repro/models/ssm.py``).

Prefill and training use the chunked SSD form (quadratic within a chunk
of ``CHUNK`` positions, a state recurrence between chunks: the
reference's ``lax.scan``, a loop over chunks here); decode is the O(1)
recurrent update.  The projections are separate matmuls (x, BC, dt, z),
as in the reference, and the SSD heads are padded up to a multiple of
``MODEL_PAR`` (mamba2-130m: 24 -> 32) with zero weights, so the
reference's arrays load unchanged; the dead heads stay exactly zero end
to end.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import sharding as sh
from repro_torch.configs.base import ModelConfig

CHUNK = 256
F32 = torch.float32


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_in, heads, head dim, state), padded: the SSD heads pad up to a
    MODEL_PAR multiple."""
    p = cfg.ssm_head_dim
    h = sh.padded_heads((cfg.ssm_expand * cfg.d_model) // p)
    return h * p, h, p, cfg.ssm_state


def ssm_valid_d_in(cfg: ModelConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def init_mamba(gen: torch.Generator, cfg: ModelConfig, *, device,
               dtype=torch.float32) -> Dict[str, Any]:
    d = cfg.d_model
    d_in, h, p, n = ssm_dims(cfg)
    d_valid = ssm_valid_d_in(cfg)
    kw = dict(generator=gen, device=device, dtype=dtype)
    sc = 1.0 / math.sqrt(d)
    chan = (torch.arange(d_in, device=device) < d_valid).to(dtype)
    head = (torch.arange(h, device=device) < d_valid // p).to(dtype)

    def uniform(lo, hi):
        return torch.rand(h, **kw).mul_(hi - lo).add_(lo)
    return {
        "w_z": torch.randn(d, d_in, **kw).mul_(sc) * chan,
        "w_x": torch.randn(d, d_in, **kw).mul_(sc) * chan,
        "w_bc": torch.randn(d, 2 * n, **kw).mul_(sc),
        "w_dt": torch.randn(d, h, **kw).mul_(sc) * head,
        "conv_x": torch.randn(cfg.ssm_conv, d_in, **kw).mul_(0.1) * chan,
        "conv_bc": torch.randn(cfg.ssm_conv, 2 * n, **kw).mul_(0.1),
        "dt_bias": torch.log(torch.expm1(uniform(1e-3, 0.1))),
        "A_log": torch.log(uniform(1.0, 16.0)),
        "D": head,
        "norm": torch.zeros(d_in, device=device, dtype=dtype),
        "w_out": torch.randn(d_in, d, **kw).mul_(1.0 / math.sqrt(d_valid))
        * chan[:, None],
    }


def _causal_conv(x, w):
    """Depthwise causal conv, kernel K (small): x [B,S,C], w [K,C]; the
    taps added in the reference's order."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    s = x.shape[1]
    out = xp[:, 0:s] * w[0].to(x.dtype)
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i].to(x.dtype)
    return out


def _segsum(a):
    """a: [..., c] -> [..., c, c]: out[i,j] = sum_{j<k<=i} a[k]; -inf j>i."""
    c = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(c, c, dtype=torch.bool, device=a.device))
    return seg.masked_fill(~mask, -math.inf)


def ssd_chunked(x, dt, a_neg, bmat, cmat, init_state=None):
    """SSD scan.  x: [B,S,H,P], dt: [B,S,H], a_neg: [H] (negative),
    bmat, cmat: [B,S,N].  S must be a multiple of ``min(CHUNK, S)``.
    Returns (y [B,S,H,P] in x's dtype, final state [B,H,P,N] in f32)."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    c = min(CHUNK, s)
    nz = s // c
    if nz * c != s:
        raise ValueError(f"ssd_chunked: sequence {s} is not a multiple of "
                         f"the chunk {c}")

    da = dt.float() * a_neg.float()[None, None, :]            # [B,S,H] <= 0
    xz = (x.float() * dt.float()[..., None]).reshape(b, nz, c, h, p)
    da = da.reshape(b, nz, c, h)
    bz = bmat.float().reshape(b, nz, c, n)
    cz = cmat.float().reshape(b, nz, c, n)

    # --- intra-chunk (quadratic within the chunk) ---
    decay = torch.exp(_segsum(da.movedim(-1, -2)))           # [B,nz,H,c,c]
    cb = torch.einsum("bzin,bzjn->bzij", cz, bz)             # [B,nz,c,c]
    y_intra = torch.einsum("bzhij,bzjhp->bzihp", cb[:, :, None] * decay, xz)
    del decay

    # --- chunk states ---
    cum = torch.cumsum(da, dim=2)                            # [B,nz,c,H]
    total = cum[:, :, -1]                                    # [B,nz,H]
    decay_to_end = torch.exp(total[:, :, None] - cum)        # [B,nz,c,H]
    states = torch.einsum("bzchp,bzcn->bzhpn",
                          decay_to_end[..., None] * xz, bz)

    # --- inter-chunk recurrence (the state entering each chunk) ---
    carry = (torch.zeros(b, h, p, n, dtype=F32, device=x.device)
             if init_state is None else init_state.float())
    entering = []
    for z in range(nz):
        entering.append(carry)
        carry = torch.exp(total[:, z])[:, :, None, None] * carry \
            + states[:, z]
    entering = torch.stack(entering, 1)                      # [B,nz,H,P,N]

    y_inter = torch.einsum("bzcn,bzhpn->bzchp", cz, entering) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y.to(x.dtype), carry


def mamba_block(params, x, cfg: ModelConfig, state=None, conv_x_state=None,
                conv_bc_state=None, decode: bool = False, *, tp=None,
                rs: bool = False):
    """x: [B,S,d].  Returns (y, (ssm_state, conv_x_state, conv_bc_state)):
    the state after the last position (f32) and the last ``ssm_conv - 1``
    conv inputs.  ``decode``: one position after the given states.

    With ``tp`` (lists; the states too, each shard's heads): where the
    padded heads shard (``param_specs``' ``ssm_ax``) each shard projects
    the gathered sequence onto its heads' channels and its columns of
    B/C, the B/C columns are all-gathered after their conv, the gated
    norm's sum of squares is summed over the shards, and ``w_out``'s
    partial products return to the stream as ``layers.out_proj``'s do
    (reference ``ssm.py:146-156``); elsewhere every shard runs every
    head."""
    if tp is not None:
        return _mamba_block_tp(params, x, cfg, state, conv_x_state,
                               conv_bc_state, decode, tp, rs)
    z, xs_c, bc_c, dt_raw, new_cx, new_cbc = _mamba_in(
        params, x, cfg, conv_x_state, conv_bc_state, decode)
    g, final = _mamba_ssd(params, cfg, z, xs_c, bc_c, dt_raw, state, decode)
    out = _mamba_out(params, g, g.square().sum(-1, keepdim=True), cfg,
                     x.dtype)
    return out, (final, new_cx, new_cbc)


def _mamba_in(params, x, cfg: ModelConfig, conv_x_state, conv_bc_state,
              decode: bool):
    """The projections and the causal convs: (z, x after conv and silu,
    B|C after conv and silu, the raw dt, the new conv states)."""
    dt_ = x.dtype
    z = x @ params["w_z"].to(dt_)
    xs_raw = x @ params["w_x"].to(dt_)
    bc_raw = x @ params["w_bc"].to(dt_)
    dt_raw = x @ params["w_dt"].to(dt_)

    k = cfg.ssm_conv
    if decode:
        fx = torch.cat([conv_x_state.to(dt_), xs_raw], dim=1)
        fb = torch.cat([conv_bc_state.to(dt_), bc_raw], dim=1)
        xs_c = _causal_conv(fx, params["conv_x"])[:, -1:]
        bc_c = _causal_conv(fb, params["conv_bc"])[:, -1:]
        new_cx, new_cbc = fx[:, -(k - 1):], fb[:, -(k - 1):]
    else:
        xs_c = _causal_conv(xs_raw, params["conv_x"])
        bc_c = _causal_conv(bc_raw, params["conv_bc"])
        new_cx, new_cbc = xs_raw[:, -(k - 1):], bc_raw[:, -(k - 1):]
    return z, F.silu(xs_c), F.silu(bc_c), dt_raw, new_cx, new_cbc


def _mamba_ssd(params, cfg: ModelConfig, z, xs_c, bc_c, dt_raw, state,
               decode: bool):
    """The SSD over the heads in ``params`` (their count from
    ``A_log``): (the gated output before its norm, in f32, and the final
    state)."""
    n = cfg.ssm_state
    h, p = params["A_log"].shape[-1], cfg.ssm_head_dim
    dt_ = xs_c.dtype
    bmat, cmat = bc_c[..., :n], bc_c[..., n:]
    bsz, s, _ = xs_c.shape
    xh = xs_c.reshape(bsz, s, h, p)
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float()[None, None])
    a_neg = -torch.exp(params["A_log"].float())

    if decode:
        da = torch.exp(dt[:, 0] * a_neg[None, :])                 # [B,H]
        upd = (dt[:, 0, :, None] * xh[:, 0].float())[..., None] \
            * bmat[:, 0].float()[:, None, None, :]                # [B,H,P,N]
        final = da[:, :, None, None] * state.float() + upd
        y = torch.einsum("bn,bhpn->bhp", cmat[:, 0].float(), final)
        y = y[:, None].to(dt_)                                    # [B,1,H,P]
    else:
        y, final = ssd_chunked(xh, dt, a_neg, bmat, cmat, init_state=state)

    y = y + params["D"].to(dt_)[None, None, :, None] * xh
    y = y.reshape(bsz, s, h * p)
    return (y * F.silu(z)).float(), final


def _mamba_out(params, g, sq_sum, cfg: ModelConfig, dt_,
               f32_out: bool = False):
    """The gated RMSNorm over the VALID channels (the dead padded
    channels are exactly zero and must not dilute the variance; ``sq_sum``
    is the sum of squares over every channel), then ``w_out``
    (``f32_out``: a shard's share, ``layers.partial_product``)."""
    var = sq_sum / ssm_valid_d_in(cfg)
    g = g * torch.rsqrt(var + cfg.norm_eps) * (1.0 + params["norm"].float())
    if f32_out:
        from repro_torch.models.layers import partial_product
        return partial_product(g.to(dt_), params["w_out"].to(dt_))
    return g.to(dt_) @ params["w_out"].to(dt_)


def _mamba_block_tp(params, x, cfg: ModelConfig, state, conv_x_state,
                    conv_bc_state, decode: bool, tp, rs: bool):
    from repro_torch.models.layers import tp_gather, tp_reduce
    n_sh = len(params)
    split = tp.size > 1 and ssm_dims(cfg)[1] % sh.MODEL_PAR == 0
    none = [None] * n_sh
    ins = [_mamba_in(p, xf, cfg, cx, cb, decode) for p, xf, cx, cb in zip(
        params, tp_gather(x, tp, rs), conv_x_state or none,
        conv_bc_state or none)]
    z, xs_c, bc_c, dt_raw, new_cx, new_cbc = (list(t) for t in zip(*ins))
    if split:
        bc_c = sh.all_gather(bc_c, tp, dim=-1)
    ssd = [_mamba_ssd(p, cfg, *a, st, decode) for p, *a, st in zip(
        params, z, xs_c, bc_c, dt_raw, state or none)]
    g, final = (list(t) for t in zip(*ssd))
    sq = [t.square().sum(-1, keepdim=True) for t in g]
    if split:
        sq = sh.psum(sq, tp)
    out = [_mamba_out(p, gg, q, cfg, x[0].dtype, f32_out=split)
           for p, gg, q in zip(params, g, sq)]
    return tp_reduce(out, tp, rs, split, x[0].dtype), (final, new_cx,
                                                        new_cbc)
