"""Core transformer layers (reference ``repro/models/layers.py``):
RMSNorm, RoPE, GQA attention (the flash op for prefill, the reference's
chunked online-softmax path as the plain alternative, direct attention
over the cache for decode and over the encoder frames for whisper's
cross-attention), GeGLU/SwiGLU MLP.

Plain functions on tensors; parameters are dicts of tensors in the
reference's layout (``wq [d, Hq, hd]``, ``wo [Hq, hd, d]``, ``w_gate
[d, f]`` ...), so the reference's arrays load unchanged.  Weights are
cast to the activations' dtype where they are used, as the reference
does (a no-op when they are stored in that dtype).  The reference's
sharding constraints are the identity on one device and its
``shard_map`` branches need a mesh: neither is here.
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
    angles = positions[..., None].float() * freqs             # [..., S, D/2]
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


def qkv(params, x, cfg: ModelConfig, positions, use_rope: bool):
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(dt))
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def out_proj(params, attn_out, dtype):
    return torch.einsum("bshk,hkd->bsd", attn_out, params["wo"].to(dtype))


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
                    *, nope: bool = False, kernel: bool = True):
    """Prefill attention ('attn' global or 'local' window).  Returns
    (out, (k, v)) so prefill can build the cache.

    ``kernel=True``: the flash op — the CUDA kernel on a CUDA tensor, its
    plain version on a CPU tensor.  ``kernel=False``: the reference
    model's own plain path, ``chunked_causal_attention``."""
    q, k, v = qkv(params, x, cfg, positions, not nope)
    window = cfg.sliding_window if layer_type == "local" else 0
    if kernel:
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            window=window, use_kernel=True)
    else:
        hq = q.shape[2]
        o = chunked_causal_attention(q, _expand_kv(k, hq), _expand_kv(v, hq),
                                     q_chunk=cfg.q_chunk, window=window)
    return out_proj(params, o, x.dtype), (k, v)


def cross_attention_block(params, x, enc_out, cfg: ModelConfig):
    """Whisper's decoder cross-attention (reference ``layers.py:232-241``):
    full, non-causal attention over the encoder frames, whose length is
    small (1500), so the scores are materialised (``direct_attention``;
    the reference computes it outside its flash kernel too)."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", enc_out, params["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", enc_out, params["wv"].to(dt))
    hq = q.shape[2]
    o = direct_attention(q, _expand_kv(k, hq), _expand_kv(v, hq), None, dt)
    return out_proj(params, o, dt)


def decode_attention(params, x, cfg: ModelConfig, k_cache, v_cache,
                     cache_positions, pos: int, *, nope: bool = False,
                     window: int = 0):
    """Single-token decode.  x: [B,1,d]; k_cache, v_cache: [B,S,Hkv,D];
    cache_positions: [S] global positions held in each slot (-1 = empty);
    pos: the current position.  Attends over the cache plus the new
    token.  Returns (out, new_k_slot, new_v_slot); the caller owns the
    cache write.

    The query heads of one KV group attend to their KV head as a group
    (no GQA-expanded copy of the cache); the sums are the reference's."""
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
    return out_proj(params, o, dt), k_new[:, 0], v_new[:, 0]


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


def mlp_block(params, x, cfg: ModelConfig):
    """GeGLU (tanh-approximate gelu) or SwiGLU (silu) gate times up, then
    down."""
    dt = x.dtype
    g = x @ params["w_gate"].to(dt)
    u = x @ params["w_up"].to(dt)
    act = F.gelu(g, approximate="tanh") if cfg.mlp_act == "gelu" \
        else F.silu(g)
    return (act * u) @ params["w_down"].to(dt)
