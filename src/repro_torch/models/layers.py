"""Core transformer layers (reference ``repro/models/layers.py``):
RMSNorm, RoPE, GQA attention (the flash op for prefill, the reference's
chunked online-softmax path as the plain alternative, direct attention
over the cache for decode and over the encoder frames for whisper's
cross-attention), GeGLU/SwiGLU MLP.

Plain functions on tensors; parameters are dicts of tensors in the
reference's layout (``wq [d, Hq, hd]``, ``wo [Hq, hd, d]``, ``w_gate
[d, f]`` ...), so the reference's arrays load unchanged.  Weights are
cast to the activations' dtype where they are used, as the reference
does (a no-op when they are stored in that dtype).

Under a ``model`` axis (``tp``, a ``sharding.Group``; the reference's
Megatron-SP transitions, ``layers.py:99-157, :291-319``) the blocks take
lists, one entry a shard: each shard's parameters as ``sharding.shard``
split them by ``models.model.param_specs`` and its part of the residual
stream, sequence-sharded ``[B, S/M, d]`` when ``rs`` (``tp_rs``: the
reference's ``_rs_eligible``) and whole ``[B, S, d]`` otherwise.  A
block gathers the sequence once (``all_gather``), runs the heads (or
``d_ff`` columns) of its shard through the one-device code, and returns
its partial product to the stream by ``psum_scatter`` over the sequence
where ``rs`` holds, by ``psum`` where it does not (decode, s = 1), as
GSPMD's all-reduce does.  Heads that do not shard (``shard_heads``) are
run whole by every shard, as the reference replicates them; a shard
whose query heads are split over replicated KV heads reads only the KV
heads its query heads use (``kv_heads``), and caches those.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import sharding as sh
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attn.ops import flash_attention

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out_shape: Tuple[int, ...],
               scale: Optional[float] = None, *, device,
               dtype=torch.float32) -> torch.Tensor:
    """N(0, scale²) of shape ``(d_in, *d_out_shape)``, scale 1/√d_in by
    default, drawn on ``device`` from ``gen`` (a generator of that
    device)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    shape = (d_in,) + tuple(d_out_shape)
    return torch.randn(shape, generator=gen, device=device,
                       dtype=dtype).mul_(scale)


# ---------------------------------------------------------------------------
# norm / rope
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float):
    """x · rsqrt(mean(x²) + eps) · (1 + scale), computed in f32."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return y.to(dt)


def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions: [..., S] (broadcastable).  Rotates the
    two halves of D (not interleaved pairs), in f32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # [D/2]
    angles = positions.to(x.device)[..., None].float() * freqs  # [..., S, D/2]
    angles = angles[..., None, :]                             # [..., S, 1, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def init_attention(gen, cfg: ModelConfig, *, device,
                   dtype=torch.float32) -> Params:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    hq = sh.padded_heads(cfg.n_heads)
    hkv = cfg.n_kv_heads
    kw = dict(device=device, dtype=dtype)
    p = {"wq": dense_init(gen, d, (hq, hd), **kw),
         # kv heads stay unpadded
         "wk": dense_init(gen, d, (hkv, hd), **kw),
         "wv": dense_init(gen, d, (hkv, hd), **kw),
         "wo": dense_init(gen, hq * hd, (d,), **kw).reshape(hq, hd, d)}
    if hq != cfg.n_heads:
        # zero the padded heads end to end: exact numerics, flop padding
        p["wq"][:, cfg.n_heads:] = 0
        p["wo"][cfg.n_heads:] = 0
    return p


def _expand_kv(k, hq: int):
    """[B,S,Hkv,D] -> [B,S,Hq,D] by GQA group broadcast (head h reads KV
    head h // (Hq/Hkv))."""
    b, s, hkv, d = k.shape
    g = hq // hkv
    return k[:, :, :, None, :].expand(b, s, hkv, g, d).reshape(b, s, hq, d)


# ---------------------------------------------------------------------------
# the model axis (Megatron-SP)
# ---------------------------------------------------------------------------

def tp_rs(tp, s: int) -> bool:
    """The reference's ``_rs_eligible`` (``layers.py:124-131``): partial
    products return to a sequence-sharded stream by ``psum_scatter``
    when the sequence splits over the ``model`` shards (``s > 1``)."""
    return tp is not None and tp.size > 1 and s > 1 and s % tp.size == 0


def tp_gather(x, tp, rs: bool):
    """The whole sequence on every shard: one ``all_gather`` of a
    sequence-sharded stream (Megatron-SP's g); a whole stream as it is."""
    return sh.all_gather(x, tp, dim=1) if rs else list(x)


def tp_reduce(parts, tp, rs: bool, partial: bool, dtype=None):
    """Per-shard results back to the stream (in ``dtype`` when given).
    ``partial``: each part is one shard's share of a sum (sharded heads
    or columns): ``psum_scatter`` over the sequence when ``rs``, else
    ``psum``.  Otherwise every part is the whole result (replicated
    weights): each shard keeps its block of the sequence when ``rs``."""
    if partial:
        f32p = is_f32_partial(parts[0], dtype)
        out = sh.psum_scatter(parts, tp, dim=1, f32_partial=f32p) if rs \
            else sh.psum(parts, tp, f32_partial=f32p)
        return out if dtype is None else [t.to(dtype) for t in out]
    if not rs:
        return list(parts)
    m = parts[0].shape[1] // tp.size
    return [p.narrow(1, pos * m, m).clone()
            for p, pos in zip(parts, tp.positions)]


def is_f32_partial(part, dtype) -> bool:
    """Whether ``part`` is an f32 partial product of half-precision
    operands (``partial_product``) on its way back to ``dtype``."""
    return part.dtype == torch.float32 and dtype is not None \
        and dtype != torch.float32


def heads_sharded(tp, n_heads: int) -> bool:
    """Whether a heads-like dim of ``n_heads`` is split over ``tp``
    (``param_specs``: ``shard_heads``)."""
    return tp is not None and tp.size > 1 and sh.shard_heads(n_heads)


class _ProductF32(torch.autograd.Function):
    """``a @ b`` (2-d, or batched 3-d) of bf16 / fp16 operands with the
    GEMM's f32 accumulator as its output (``mm(out_dtype=float32)``; the
    CPU has none: its plain f32 product); the backward takes the
    cotangent in the operands' dtype, as the product rounded to it
    would."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.device.type == "cpu":
            return a.float() @ b.float()
        mm = torch.mm if a.dim() == 2 else torch.bmm
        return mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return (g @ b.transpose(-1, -2) if ctx.needs_input_grad[0] else None,
                a.transpose(-1, -2) @ g if ctx.needs_input_grad[1] else None)


def partial_product(a, b):
    """``a [..., K] @ b [K, N]``, one shard's share of a sum over K: its
    f32 accumulator when the operands are half precision, so the shards'
    shares are summed in f32 and rounded once (``tp_reduce``), as the
    unsplit product rounds once."""
    if a.dtype == torch.float32:
        return a @ b
    lead = a.shape[:-1]
    return _ProductF32.apply(a.reshape(-1, a.shape[-1]), b).reshape(
        *lead, b.shape[-1])


def kv_heads(hq_loc: int, hq: int, hkv: int, pos: int):
    """The replicated KV heads that query heads ``[pos·hq_loc,
    (pos+1)·hq_loc)`` of ``hq`` read (head h reads KV head h // (hq /
    hkv)): a slice when they form whole GQA groups (or lie in one), else
    one KV head a query head (an index tensor).  None: every head."""
    if hq_loc == hq:
        return None
    g = hq // hkv
    first = pos * hq_loc
    if hq_loc % g == 0:
        return slice(first // g, first // g + hq_loc // g)
    if g % hq_loc == 0:
        return slice(first // g, first // g + 1)
    return torch.arange(first, first + hq_loc) // g


def local_attention(p, cfg: ModelConfig, tp, pos: int):
    """One shard's attention weights: its query heads (and ``wo`` rows)
    as stored, and the KV heads they read (``kv_heads``) when the KV
    heads are replicated."""
    hq, hkv = sh.padded_heads(cfg.n_heads), cfg.n_kv_heads
    hq_loc = p["wq"].shape[1]
    if p["wk"].shape[1] != hkv:                 # KV heads sharded too
        return p
    sel = kv_heads(hq_loc, hq, hkv, pos)
    if sel is None:
        return p
    if isinstance(sel, torch.Tensor):
        sel = sel.to(p["wk"].device)
    return dict(p, wk=p["wk"][:, sel], wv=p["wv"][:, sel])


def qkv(params, x, cfg: ModelConfig, positions, use_rope: bool, *,
        tp=None, rs: bool = False):
    """q, k, v of ``x`` [B, S, d] (RoPE'd unless ``use_rope`` is off).
    With ``tp``: lists; ``x`` is the stream (sequence-sharded when
    ``rs``), gathered once, and q / k / v leave with the heads of each
    shard and the whole sequence (reference ``layers.py:99-121``)."""
    if tp is not None:
        xs = tp_gather(x, tp, rs)
        out = [qkv(local_attention(p, cfg, tp, pos), xf, cfg, positions,
                   use_rope)
               for p, xf, pos in zip(params, xs, tp.positions)]
        return tuple(list(t) for t in zip(*out))
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(dt))
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def out_proj(params, attn_out, dtype, *, tp=None, rs: bool = False,
             cfg: Optional[ModelConfig] = None, f32_out: bool = False):
    """``attn_out`` [B, S, H, D] through ``wo``.  With ``tp`` (lists; the
    config's heads decide): each shard's heads give a partial product
    (``partial_product``), reduce-scattered over the sequence onto the
    stream when ``rs``, else summed (reference ``layers.py:134-157``).
    ``f32_out``: one shard's share, as ``partial_product`` gives it."""
    if tp is not None:
        split = heads_sharded(tp, sh.padded_heads(cfg.n_heads))
        parts = [out_proj(p, o, dtype, f32_out=split)
                 for p, o in zip(params, attn_out)]
        return tp_reduce(parts, tp, rs, split, dtype)
    wo = params["wo"].to(dtype)
    if f32_out:
        b, s, h, k = attn_out.shape
        return partial_product(attn_out.reshape(b, s, h * k),
                               wo.reshape(h * k, -1))
    return torch.einsum("bshk,hkd->bsd", attn_out, wo)


def direct_attention(q, k, v, mask, dtype):
    """Materialised-scores attention.  q: [B,Sq,H,D], k, v: [B,Sk,H,D];
    mask broadcastable to [B,H,Sq,Sk] (True = keep)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def chunked_causal_attention(q, k, v, *, q_chunk: int, window: int = 0):
    """The reference model's own attention (``layers.py:171-214``): a loop
    over query chunks, never materialising [S, S].

    q, k, v: [B, S, H, D] (kv already GQA-expanded).  window=0 => global
    causal; window>0 => sliding-window causal (keys within (p-W, p]); each
    chunk then slices a fixed (W + q_chunk) key span.  Scores are
    rounded to the input dtype by the QK product and probabilities
    before the PV product, as in the reference."""
    b, s, h, d = q.shape
    dt = q.dtype
    nq = s // q_chunk
    if nq * q_chunk != s:
        raise ValueError(f"sequence {s} is not a multiple of q_chunk "
                         f"{q_chunk}")
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    outs = []
    for qi in range(nq):
        q_start = qi * q_chunk
        qc = q[:, q_start:q_start + q_chunk]
        qpos = q_start + torch.arange(q_chunk, device=dev)
        if window:
            span = min(window + q_chunk, s)
            k_start = max(q_start + q_chunk - (window + q_chunk), 0)
            kc = k[:, k_start:k_start + span]
            vc = v[:, k_start:k_start + span]
            kpos = k_start + torch.arange(span, device=dev)
            keep = ((kpos[None, :] <= qpos[:, None])
                    & (kpos[None, :] > qpos[:, None] - window))
        else:
            kc, vc = k, v
            kpos = torch.arange(s, device=dev)
            keep = kpos[None, :] <= qpos[:, None]
        scores = torch.einsum("bqhd,bkhd->bhqk", qc, kc).float()
        scores = torch.where(keep, scores * scale,
                             torch.full((), -1e30, device=dev))
        probs = torch.softmax(scores, dim=-1).to(dt)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", probs, vc))
    return torch.cat(outs, dim=1)


def attention_block(params, x, cfg: ModelConfig, layer_type: str, positions,
                    *, nope: bool = False, kernel: bool = True, tp=None,
                    rs: bool = False):
    """Prefill attention ('attn' global or 'local' window).  Returns
    (out, (k, v)) so prefill can build the cache.

    ``kernel=True``: the flash op — the CUDA kernel on a CUDA tensor, its
    plain version on a CPU tensor.  ``kernel=False``: the reference
    model's own plain path, ``chunked_causal_attention``.  With ``tp``
    (lists): each shard runs its heads (one flash call a shard) and its
    partial product returns to the stream (``out_proj``); (k, v) are
    lists of each shard's KV heads."""
    if tp is not None:
        q, k, v = qkv(params, x, cfg, positions, not nope, tp=tp, rs=rs)
        o = [_attend(qs, ks, vs, cfg, layer_type, kernel)
             for qs, ks, vs in zip(q, k, v)]
        return (out_proj(params, o, x[0].dtype, tp=tp, rs=rs, cfg=cfg),
                (k, v))
    q, k, v = qkv(params, x, cfg, positions, not nope)
    return out_proj(params, _attend(q, k, v, cfg, layer_type, kernel),
                    x.dtype), (k, v)


def _attend(q, k, v, cfg: ModelConfig, layer_type: str, kernel: bool):
    window = cfg.sliding_window if layer_type == "local" else 0
    if kernel:
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            window=window, use_kernel=True)
    else:
        hq = q.shape[2]
        o = chunked_causal_attention(q, _expand_kv(k, hq), _expand_kv(v, hq),
                                     q_chunk=cfg.q_chunk, window=window)
    return o


def cross_attention_block(params, x, enc_out, cfg: ModelConfig, *,
                          tp=None, rs: bool = False, f32_out: bool = False):
    """Whisper's decoder cross-attention (reference ``layers.py:232-241``):
    full, non-causal attention over the encoder frames, whose length is
    small (1500), so the scores are materialised (``direct_attention``;
    the reference computes it outside its flash kernel too).  With
    ``tp``: lists; ``enc_out`` whole on every shard; each shard's heads,
    reduced as ``out_proj``."""
    if tp is not None:
        xs = tp_gather(x, tp, rs)
        split = heads_sharded(tp, sh.padded_heads(cfg.n_heads))
        parts = [cross_attention_block(local_attention(p, cfg, tp, pos), xf,
                                       e, cfg, f32_out=split)
                 for p, xf, e, pos in zip(params, xs, enc_out, tp.positions)]
        return tp_reduce(parts, tp, rs, split, x[0].dtype)
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", enc_out, params["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", enc_out, params["wv"].to(dt))
    hq = q.shape[2]
    o = direct_attention(q, _expand_kv(k, hq), _expand_kv(v, hq), None, dt)
    return out_proj(params, o, dt, f32_out=f32_out)


def decode_attention(params, x, cfg: ModelConfig, k_cache, v_cache,
                     cache_positions, pos: int, *, nope: bool = False,
                     window: int = 0, tp=None, f32_out: bool = False):
    """Single-token decode.  x: [B,1,d]; k_cache, v_cache: [B,S,Hkv,D];
    cache_positions: [S] global positions held in each slot (-1 = empty);
    pos: the current position.  Attends over the cache plus the new
    token.  Returns (out, new_k_slot, new_v_slot); the caller owns the
    cache write.

    The query heads of one KV group attend to their KV head as a group
    (no GQA-expanded copy of the cache); the sums are the reference's.

    With ``tp`` (lists): ``x`` whole on every shard, each shard's cache
    holds the KV heads of its query heads; the partial products are
    summed (``psum``: s = 1 does not split)."""
    if tp is not None:
        split = heads_sharded(tp, sh.padded_heads(cfg.n_heads))
        out = [decode_attention(local_attention(p, cfg, tp, ps), xs, cfg,
                                kc, vc, cp, pos, nope=nope, window=window,
                                f32_out=split)
               for p, xs, kc, vc, cp, ps in zip(params, x, k_cache, v_cache,
                                                cache_positions,
                                                tp.positions)]
        o, kn, vn = (list(t) for t in zip(*out))
        return tp_reduce(o, tp, False, split, x[0].dtype), kn, vn
    dt = x.dtype
    q, k_new, v_new = qkv(params, x, cfg,
                          torch.full((1,), pos, device=x.device), not nope)
    b, _, hq, d = q.shape
    hkv = k_cache.shape[2]
    g = hq // hkv
    valid = (cache_positions >= 0) & (cache_positions <= pos)
    if window:
        valid = valid & (cache_positions > pos - window)
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, 1, hkv, g, d)
    scores = torch.einsum("bqngd,bknd->bngqk", qg,
                          k_cache.to(dt)).float() * scale
    scores = scores.reshape(b, hq, 1, -1)                     # [B,H,1,S]
    scores = scores.masked_fill(~valid, -1e30)
    self_score = (torch.einsum("bqhd,bqhd->bhq", q,
                               _expand_kv(k_new, hq)).float()
                  * scale)[..., None]                         # [B,H,1,1]
    scores = torch.cat([scores, self_score], dim=-1)
    probs = torch.softmax(scores, dim=-1).to(dt)
    pc = probs[..., :-1].reshape(b, hkv, g, 1, -1)
    o_cache = torch.einsum("bngqk,bknd->bqngd", pc,
                           v_cache.to(dt)).reshape(b, 1, hq, d)
    p_self = probs[..., -1].movedim(1, 2)[..., None]          # [B,1,H,1]
    o = o_cache + p_self * _expand_kv(v_new, hq)
    return (out_proj(params, o, dt, f32_out=f32_out), k_new[:, 0],
            v_new[:, 0])


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def init_mlp(gen, cfg: ModelConfig, d_ff: Optional[int] = None, *, device,
             dtype=torch.float32) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    kw = dict(device=device, dtype=dtype)
    return {"w_gate": dense_init(gen, d, (f,), **kw),
            "w_up": dense_init(gen, d, (f,), **kw),
            "w_down": dense_init(gen, f, (d,), **kw)}


def mlp_block(params, x, cfg: ModelConfig, *, tp=None, rs: bool = False,
              f32_out: bool = False):
    """GeGLU (tanh-approximate gelu) or SwiGLU (silu) gate times up, then
    down.  With ``tp`` (lists; ``d_ff`` split over the shards, as
    ``param_specs`` always splits it): the sequence gathered once, each
    shard's columns, the partial products of ``w_down`` reduce-scattered
    onto the stream (reference ``layers.py:291-319``).  ``f32_out``: one
    shard's share, as ``partial_product`` gives it."""
    if tp is not None:
        xs = tp_gather(x, tp, rs)
        split = tp.size > 1
        return tp_reduce([mlp_block(p, xf, cfg, f32_out=split)
                          for p, xf in zip(params, xs)], tp, rs, split,
                         x[0].dtype)
    dt = x.dtype
    g = x @ params["w_gate"].to(dt)
    u = x @ params["w_up"].to(dt)
    act = F.gelu(g, approximate="tanh") if cfg.mlp_act == "gelu" \
        else F.silu(g)
    if f32_out:
        return partial_product(act * u, params["w_down"].to(dt))
    return (act * u) @ params["w_down"].to(dt)
