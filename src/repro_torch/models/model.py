"""The decoder families assembled from a layer-pattern plan (reference
``repro/models/model.py``): dense, MoE (llama4's iRoPE: NoPE on the
global layers), SSM (mamba2), hybrid (zamba2's mamba stack with one
weight-shared attention block), audio (whisper's encoder and decoder
cross-attention) and VLM (patch embeddings through a projector,
prepended to the text).  Its training forward (``forward_train``, the
loss chunked over the sequence) and its serving path, ``prefill`` over a
prompt, then one ``decode_step`` per token.

A config's ``pattern`` (gemma3's 5 x local + 1 x global, zamba2's 6 x
mamba + shared_attn ...) is grouped into runs of consecutive identical
block types; each run's layer parameters are stacked on a leading dim,
as in the reference, so its arrays load unchanged.  Where the reference
scans over that dim, the port loops over it.  A ``shared_attn`` run
holds no parameters: every application reads ``params["shared_attn"]``.

Ring caches: ``decode_step`` writes position ``pos`` to slot
``pos % cap`` and ``prefill`` puts each kept position p in slot
``p % cap`` too.  Here the port departs from the reference on purpose:
the reference's prefill puts the newest ``cap`` positions in slots
``0..cap-1``, so when the prompt length is not a multiple of a local
layer's window its second decode step on overwrites a key still inside
the window.  Where the prompt is a multiple of the capacity the two
layouts are the same.  ``decode_step`` updates the cache tensors in
place (the reference returns new arrays) and returns the same cache.
Mamba layers cache their SSD state (f32) and last ``ssm_conv - 1`` conv
inputs; whisper's decoder caches the cross-attention's K/V of the
encoder output, computed once at prefill.

Prefill runs every causal self-attention through the flash kernel
(``layers.attention_block(kernel=True)``); the encoder, the
cross-attention and decode attend directly, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint
from torch.utils._pytree import tree_map_with_path

from repro_torch import sharding as sh
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.optim.optimizers import dict_keys


F32 = torch.float32
LOSS_CHUNK = 512          # vocab-logit seq chunks (never materialise [B,S,V])


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Run:
    type: str          # attn | local | mamba | shared_attn
    count: int
    shared: bool


def build_plan(cfg: ModelConfig) -> Tuple[Run, ...]:
    runs: List[Run] = []
    for t in cfg.pattern:
        if t == "shared_attn":
            runs.append(Run("shared_attn", 1, True))
        elif runs and runs[-1].type == t and not runs[-1].shared:
            runs[-1] = Run(t, runs[-1].count + 1, False)
        else:
            runs.append(Run(t, 1, False))
    return tuple(runs)


def _vp(cfg: ModelConfig) -> int:
    return sh.pad_to(cfg.vocab_size, sh.MODEL_PAR)


def _dt(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# init and the weight carry-across
# ---------------------------------------------------------------------------

def _init_attn_layer(gen, cfg: ModelConfig, device, dtype, *,
                     moe: bool = False, cross: bool = False):
    d = cfg.d_model
    kw = dict(device=device, dtype=dtype)
    p = {"norm1": torch.zeros(d, **kw), "norm2": torch.zeros(d, **kw),
         "attn": L.init_attention(gen, cfg, **kw)}
    if cross:
        p["normx"] = torch.zeros(d, **kw)
        p["cross"] = L.init_attention(gen, cfg, **kw)
    if moe:
        p["moe"] = MOE.init_moe(gen, cfg, **kw)
    else:
        p["mlp"] = L.init_mlp(gen, cfg, **kw)
    return p


def _init_mamba_layer(gen, cfg: ModelConfig, device, dtype):
    return {"norm1": torch.zeros(cfg.d_model, device=device, dtype=dtype),
            "mamba": SSM.init_mamba(gen, cfg, device=device, dtype=dtype)}


def _stack(count: int, init_fn):
    """``count`` layers from ``init_fn()``, stacked leaf by leaf on a
    leading dim (each layer is stacked and dropped before the next run's
    are drawn)."""
    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return torch.stack(xs, 0)
    return stack(*(init_fn() for _ in range(count)))


def init_model(gen: torch.Generator, cfg: ModelConfig, device="cuda",
               dtype=torch.float32) -> Dict[str, Any]:
    """The parameter tree, drawn on ``device`` from ``gen`` (a generator of
    that device), one tensor at a time, in the reference's layout.  The
    reference keeps f32 master weights and casts at use;
    ``dtype=torch.bfloat16`` stores them in the compute dtype instead
    (what full-width serving does: the casts at use are then no-ops).
    ``torch.Generator`` cannot replay ``jax.random``: parity runs load
    the reference's weights with ``params_from_numpy``."""
    dev = resolve_device(device)
    d = cfg.d_model
    vp = _vp(cfg)
    is_moe = cfg.n_experts > 0
    cross = cfg.n_enc_layers > 0
    params: Dict[str, Any] = {
        "embed": L.dense_init(gen, vp, (d,), d ** -0.5, device=dev,
                              dtype=dtype),
        "final_norm": torch.zeros(d, device=dev, dtype=dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, d, (vp,), d ** -0.5,
                                         device=dev, dtype=dtype)
    run_ps = []
    for run in build_plan(cfg):
        if run.shared:
            if "shared_attn" not in params:
                params["shared_attn"] = _init_attn_layer(gen, cfg, dev,
                                                         dtype)
            run_ps.append({})
        elif run.type == "mamba":
            run_ps.append(_stack(run.count, lambda: _init_mamba_layer(
                gen, cfg, dev, dtype)))
        else:
            run_ps.append(_stack(run.count, lambda: _init_attn_layer(
                gen, cfg, dev, dtype, moe=is_moe, cross=cross)))
    params["runs"] = tuple(run_ps)
    if cross:                           # whisper's encoder
        params["enc"] = {
            "runs": (_stack(cfg.n_enc_layers, lambda: _init_attn_layer(
                gen, cfg, dev, dtype)),),
            "pos_embed": L.dense_init(gen, cfg.enc_seq, (d,), 0.02,
                                      device=dev, dtype=dtype),
            "final_norm": torch.zeros(d, device=dev, dtype=dtype)}
    if cfg.frontend_seq:                # the VLM projector
        params["proj"] = L.dense_init(gen, d, (d,), d ** -0.5, device=dev,
                                      dtype=dtype)
    return params


def causal_attention_layers(cfg: ModelConfig) -> int:
    """The causal self-attention applications of one forward: every layer
    of the pattern but the mamba ones (each application of a shared block
    counts).  A prefill launches the flash kernel this many times."""
    return sum(t != "mamba" for t in cfg.pattern)


def params_from_numpy(params, device="cuda", dtype=torch.float32):
    """The weight carry-across: the reference's ``init_model`` tree
    through ``np.asarray`` (dicts, the ``runs`` tuple with its stacked
    leading layer dim) as tensors of ``dtype`` on ``device``, same keys,
    same layout."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(conv(v) for v in x)
        return torch.tensor(np.asarray(x, np.float32), device=dev,
                            dtype=dtype)
    return conv(params)


def _layer(rp, i: int):
    """Layer ``i`` of a stacked run's parameters (views, no copy)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in rp.items()}


def _map_with_names(fn, tree):
    """``fn(names, leaf)`` over a tree; ``names`` are the dict keys on the
    way to the leaf (``optim.dict_keys``)."""
    return tree_map_with_path(lambda path, leaf: fn(dict_keys(path), leaf),
                              tree)


def param_specs(cfg: ModelConfig, params) -> Any:
    """The reference's logical shardings from parameter names and shapes
    (``model.py:142-210``), as tuples of the logical axis names of
    ``sharding`` (``MODEL``, ``FSDP``) or None, one per dim, in the tree
    of ``params`` (tensors, fake tensors, or anything with ``.shape``).
    On one card nothing places a tensor by them; the dry-run records
    them."""
    ssm_h = SSM.ssm_dims(cfg)[1] if "mamba" in cfg.pattern else 1
    ssm_ax = sh.MODEL if ssm_h % sh.MODEL_PAR == 0 else None

    def fs(dim: int):
        return sh.FSDP if dim % sh.MODEL_PAR == 0 else None

    def rule(names, leaf):
        name = names[-1] if names else ""
        stacked = "runs" in names and "pos_embed" not in names \
            and "final_norm" not in names
        shape = tuple(leaf.shape)
        shp = shape[1:] if stacked else shape
        if name == "embed":
            base = (sh.MODEL, fs(shp[1]))
        elif name == "lm_head":
            base = (fs(shp[0]), sh.MODEL)
        elif name in ("wq", "wk", "wv"):
            ax = sh.MODEL if sh.shard_heads(shp[1]) else None
            base = (fs(shp[0]), ax, None)
        elif name == "wo":
            ax = sh.MODEL if sh.shard_heads(shp[0]) else None
            base = (ax, None, fs(shp[2]))
        elif name in ("w_gate", "w_up", "w_down"):
            if len(shp) == 3:           # moe expert weights [E, a, b]
                e_ax = sh.MODEL if shp[0] % sh.MODEL_PAR == 0 else None
                base = (e_ax, fs(shp[1]), None)
            elif name == "w_down":      # dense mlp [f, d]
                base = (sh.MODEL, fs(shp[1]))
            else:                       # dense mlp [d, f]
                base = (fs(shp[0]), sh.MODEL)
        elif name in ("w_z", "w_x", "w_bc", "w_dt"):
            base = (fs(shp[0]), ssm_ax)
        elif name in ("conv_x", "conv_bc"):
            base = (None, ssm_ax)
        elif name in ("dt_bias", "A_log", "D", "norm"):
            base = (ssm_ax,)            # (norm: the mamba gated-norm scale)
        elif name == "w_out":           # mamba out proj [d_in, d]
            base = (ssm_ax, fs(shp[1]))
        elif name == "proj":            # vlm projector [d, d]
            base = (fs(shp[0]), None)
        else:                           # norms, router, pos_embed
            base = (None,) * len(shp)
        if stacked:
            base = (None,) + base
        if len(base) != len(shape):
            raise ValueError(f"param_specs: {names} {shape} -> {base}")
        return base

    return _map_with_names(rule, params)


# ---------------------------------------------------------------------------
# blocks (train / prefill)
# ---------------------------------------------------------------------------

def _zero(x):
    return torch.zeros((), dtype=F32, device=x.device)


def _attn_mlp_block(lp, x, cfg: ModelConfig, ltype: str, positions,
                    enc_out, nope_global: bool, kernel: bool):
    """One attention layer: self-attention (NoPE on the global layers
    when ``nope_global``), whisper's cross-attention where the layer has
    one, then the MLP or the MoE.  Returns (x, (k, v), aux)."""
    h, kv = L.attention_block(
        lp["attn"], L.rms_norm(x, lp["norm1"], cfg.norm_eps), cfg, ltype,
        positions, nope=nope_global and ltype == "attn", kernel=kernel)
    x = x + h
    if "cross" in lp:
        x = x + L.cross_attention_block(
            lp["cross"], L.rms_norm(x, lp["normx"], cfg.norm_eps), enc_out,
            cfg)
    y = L.rms_norm(x, lp["norm2"], cfg.norm_eps)
    if "moe" in lp:
        h, aux = MOE.moe_block(lp["moe"], y, cfg)
    else:
        h, aux = L.mlp_block(lp["mlp"], y, cfg), _zero(x)
    return x + h, kv, aux


def _run_forward(run: Run, rp, shared_p, x, cfg: ModelConfig, positions,
                 enc_out, collect_kv: bool, kernel: bool,
                 remat: bool = False):
    """One run in prefill (or, with ``remat``, training) mode.  Returns
    (x, the run's cache entries stacked over its layers or None, aux):
    (k, v) of an attention run, (state, conv_x, conv_bc) of a mamba run.
    llama4's iRoPE drops RoPE on the global layers of the MoE family.
    ``remat`` checkpoints each layer (``torch.utils.checkpoint``: only
    the layer's input is kept, the reference's ``jax.checkpoint`` of each
    scanned layer) and collects no cache."""
    nope_global = cfg.family == "moe"
    if run.shared:
        layers, ltype, nope_global = [shared_p], "attn", False
    else:
        layers, ltype = [_layer(rp, i) for i in range(run.count)], run.type

    def body(x, lp):
        if ltype == "mamba":
            h, st = SSM.mamba_block(
                lp["mamba"], L.rms_norm(x, lp["norm1"], cfg.norm_eps), cfg)
            return x + h, st, _zero(x)
        return _attn_mlp_block(lp, x, cfg, ltype, positions, enc_out,
                               nope_global, kernel)

    aux = _zero(x)
    outs = []
    for lp in layers:
        if remat:
            x, a = checkpoint(lambda x, lp: body(x, lp)[::2], x, lp,
                              use_reentrant=False)
        else:
            x, c, a = body(x, lp)
            if collect_kv:
                outs.append(c)
        aux = aux + a
    if not outs:
        return x, None, aux
    return x, tuple(torch.stack(t) for t in zip(*outs)), aux


def _encode(params, cfg: ModelConfig, frames, remat: bool = False):
    """Whisper's encoder over stub frame embeddings [B, enc_seq, d]:
    bidirectional attention, computed directly (the reference's
    ``_encode``, outside its flash kernel)."""
    enc = params["enc"]
    x = frames + enc["pos_embed"][None].to(frames.dtype)
    ep = enc["runs"][0]

    def body(x, lp):
        h = L.rms_norm(x, lp["norm1"], cfg.norm_eps)
        dt = x.dtype
        q, k, v = (torch.einsum("bsd,dhk->bshk", h, lp["attn"][w].to(dt))
                   for w in ("wq", "wk", "wv"))
        hq = q.shape[2]
        o = L.direct_attention(q, L._expand_kv(k, hq), L._expand_kv(v, hq),
                               None, dt)
        x = x + L.out_proj(lp["attn"], o, dt)
        y = L.rms_norm(x, lp["norm2"], cfg.norm_eps)
        return x + L.mlp_block(lp["mlp"], y, cfg)
    for i in range(ep["norm1"].shape[0]):
        lp = _layer(ep, i)
        x = (checkpoint(body, x, lp, use_reentrant=False) if remat
             else body(x, lp))
    return L.rms_norm(x, enc["final_norm"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# embedding / logits
# ---------------------------------------------------------------------------

def embed_tokens(params, cfg: ModelConfig, tokens):
    return params["embed"][tokens.long()].to(_dt(cfg))


def _head_matrix(params, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return params["embed"].T            # [d, Vp]
    return params["lm_head"]


def logits_fn(params, cfg: ModelConfig, hidden):
    logits = hidden @ _head_matrix(params, cfg).to(hidden.dtype)
    vp = logits.shape[-1]
    if vp != cfg.vocab_size:                # mask the vocab padding
        pad = torch.arange(vp, device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


def _loss_chunk(w, hc, lc, vocab: int):
    """One chunk of ``chunked_lm_loss``: (valid count, loss sum, correct
    count), all f32 scalars, from hidden ``hc`` [B, c, d], the head matrix
    ``w`` [d, Vp] and labels ``lc`` [B, c]."""
    lg = hc @ w.to(hc.dtype)
    vp = lg.shape[-1]
    if vp != vocab:                         # mask the vocab padding
        pad = torch.arange(vp, device=lg.device) >= vocab
        lg = lg.masked_fill(pad, -1e30)
    lg = lg.to(F32)
    mask = lc >= 0
    li = torch.clamp(lc, min=0).long()
    logz = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, li[..., None])[..., 0]
    loss_sum = torch.sum((logz - ll) * mask)
    correct = torch.sum((torch.argmax(lg, -1) == li) * mask).to(F32)
    return torch.sum(mask).to(F32), loss_sum, correct


def chunked_lm_loss(params, cfg: ModelConfig, hidden, labels):
    """Mean CE over the vocab and accuracy, without materialising
    [B, S, V]: a loop over sequence chunks of ``LOSS_CHUNK`` (reference
    ``model.py:316-348``).  labels: int [B, S], -1 = ignored position.
    Each chunk runs under ``torch.utils.checkpoint``, so its logits are
    recomputed in the backward and never kept (the reference's
    ``nothing_saveable``): the f32 logits are the largest buffer of a
    train step otherwise.  Returns (loss, acc), f32 scalars."""
    b, s, d = hidden.shape
    c = min(LOSS_CHUNK, s)
    nc = s // c
    if nc * c != s:
        raise ValueError(f"sequence {s} is not a multiple of the loss "
                         f"chunk {c}")
    w = _head_matrix(params, cfg)
    zero = torch.zeros((), dtype=F32, device=hidden.device)
    tot, loss_sum, correct = zero, zero, zero
    for i in range(nc):
        t, ls, cr = checkpoint(_loss_chunk, w, hidden[:, i * c:(i + 1) * c],
                               labels[:, i * c:(i + 1) * c], cfg.vocab_size,
                               use_reentrant=False)
        tot, loss_sum, correct = tot + t, loss_sum + ls, correct + cr
    denom = torch.clamp(tot, min=1.0)
    return loss_sum / denom, correct / denom


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def backbone(params, cfg: ModelConfig, x, positions, enc_out=None,
             collect_kv: bool = False, *, kernel: bool = True,
             remat: bool = False):
    """Every run, then the final norm.  Returns (hidden, per-run cache
    entries or None, the MoE aux loss summed over the layers, f32).
    ``kernel`` picks the causal self-attention of every layer
    (``layers.attention_block``); ``remat`` checkpoints every layer
    (training)."""
    aux_total = _zero(x)
    kvs = []
    for i, run in enumerate(build_plan(cfg)):
        x, kv, aux = _run_forward(run, params["runs"][i],
                                  params.get("shared_attn"), x, cfg,
                                  positions, enc_out, collect_kv, kernel,
                                  remat)
        kvs.append(kv)
        aux_total = aux_total + aux
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), kvs, aux_total


def _inputs(params, cfg: ModelConfig, batch, remat: bool = False):
    """The backbone's input and the encoder's output of a batch: the
    token embeddings, after the projected patch embeddings (VLM, batch
    ``patches`` [B, P, d]); whisper's encoder over ``frames`` [B, enc, d]
    (None for the other families)."""
    dt = _dt(cfg)
    x = embed_tokens(params, cfg, batch["tokens"])
    if cfg.frontend_seq:
        patches = batch["patches"].to(dt) @ params["proj"].to(dt)
        x = torch.cat([patches, x], dim=1)
    enc_out = None
    if cfg.n_enc_layers:
        enc_out = _encode(params, cfg, batch["frames"].to(dt), remat)
    return x, enc_out


def forward_train(params, cfg: ModelConfig, batch):
    """The training forward (reference ``model.py:366-389``): embed (the
    patches first, VLM), the encoder (audio), the backbone through the
    reference model's own chunked attention (the flash kernel has no
    backward and the reference never trains through it), each layer
    checkpointed when ``cfg.remat``, the final norm and
    ``chunked_lm_loss``.  batch: tokens [B, S], labels [B, S] (-1
    ignored), and ``patches`` [B, P, d] (VLM; their positions carry no
    label) or ``frames`` [B, enc_seq, d] (audio).  Returns ``(total,
    {"loss", "aux", "acc"})`` with ``total = loss + 0.01 * aux``, aux the
    MoE load-balance loss (0 without experts)."""
    labels = batch["labels"]
    x, enc_out = _inputs(params, cfg, batch, remat=cfg.remat)
    if cfg.frontend_seq:
        pad = torch.full((labels.shape[0], cfg.frontend_seq), -1,
                         dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    h, _, aux = backbone(params, cfg, x, positions, enc_out, kernel=False,
                         remat=cfg.remat)
    loss, acc = chunked_lm_loss(params, cfg, h, labels)
    total = loss + 0.01 * aux
    return total, {"loss": loss, "aux": aux, "acc": acc}


# --- serving ---------------------------------------------------------------

def cache_capacity(cfg: ModelConfig, run: Run, seq_len: int) -> int:
    if run.type == "local":
        return min(cfg.sliding_window, seq_len)
    return seq_len


def _cross_kv(params, enc_out):
    """Whisper's cross-attention K and V of the encoder output, for every
    decoder layer: [L, B, enc, Hkv, D] each."""
    dt = enc_out.dtype
    cross = params["runs"][0]["cross"]
    return tuple(torch.einsum("bsd,ldhk->lbshk", enc_out, cross[w].to(dt))
                 for w in ("wk", "wv"))


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device="cuda",
               enc_out=None, params=None):
    """Empty caches sized for ``seq_len`` context: ring K/V of the
    attention runs, SSD state and conv inputs of the mamba runs, and for
    whisper the cross-attention's K/V (of ``enc_out`` when it and
    ``params`` are given, else zeros)."""
    dev = resolve_device(device)
    dt = _dt(cfg)
    hd = cfg.resolved_head_dim
    run_caches = []
    for run in build_plan(cfg):
        if run.type == "mamba":
            d_in, h, p, n = SSM.ssm_dims(cfg)
            k1 = cfg.ssm_conv - 1
            run_caches.append({
                "state": torch.zeros(run.count, batch, h, p, n, device=dev,
                                     dtype=F32),
                "conv_x": torch.zeros(run.count, batch, k1, d_in,
                                      device=dev, dtype=dt),
                "conv_bc": torch.zeros(run.count, batch, k1, 2 * n,
                                       device=dev, dtype=dt)})
            continue
        cap = cache_capacity(cfg, run, seq_len)
        shape = (run.count, batch, cap, cfg.n_kv_heads, hd)
        c = {"k": torch.zeros(shape, device=dev, dtype=dt),
             "v": torch.zeros(shape, device=dev, dtype=dt),
             "slot_pos": torch.full((run.count, cap), -1, device=dev,
                                    dtype=torch.int32)}
        if cfg.n_enc_layers:
            if params is not None and enc_out is not None:
                c["ck"], c["cv"] = _cross_kv(params, enc_out)
            else:
                c["ck"] = torch.zeros(run.count, batch, cfg.enc_seq,
                                      cfg.n_kv_heads, hd, device=dev,
                                      dtype=dt)
                c["cv"] = torch.zeros_like(c["ck"])
        run_caches.append(c)
    return {"pos": 0, "runs": tuple(run_caches)}


def cache_specs(cfg: ModelConfig, cache, batch_shardable: bool = True) -> Any:
    """The reference's logical shardings of a cache tree
    (``model.py:443-465``): batch on ``BATCH``, the cache's sequence on
    ``MODEL`` (on every axis, ``ALL``, when the batch cannot shard), as
    tuples in the tree of ``cache``; ``pos`` (a Python int here, a 0-d
    array there) gets ``()``."""
    b_ax = sh.BATCH if batch_shardable else None
    s_ax = sh.MODEL if batch_shardable else sh.ALL
    # divisibility guards: MODEL axis = 16; ALL = up to 512 (2 pods)
    s_div = sh.MODEL_PAR if batch_shardable else 512

    def spec_for(names, leaf):
        name = names[-1] if names else ""
        shape = tuple(getattr(leaf, "shape", ()))
        nd = len(shape)
        if name in ("k", "v", "ck", "cv"):
            s_ok = shape[2] % s_div == 0
            return (None, b_ax, s_ax if s_ok else None) + (None,) * (nd - 3)
        if name == "state":
            return (None, b_ax) + (None,) * (nd - 2)
        if name in ("conv_x", "conv_bc"):
            return (None, b_ax, None, None)
        return (None,) * nd
    return _map_with_names(spec_for, cache)


def prefill(params, cfg: ModelConfig, batch, max_len: Optional[int] = None,
            *, kernel: bool = True):
    """Run the prompt ``batch["tokens"]`` [B, S] (with ``patches`` or
    ``frames`` as ``forward_train`` takes them); returns (last_logits
    [B, Vp], cache).

    ``max_len`` sizes the global-attention caches (prompt + decode
    budget); it defaults to the prompt length (with the patches), and
    continued decoding then rolls the ring (the oldest tokens drop).
    Local-window caches always ring over the window.  ``kernel`` as in
    ``backbone``."""
    x, enc_out = _inputs(params, cfg, batch)
    s = x.shape[1]
    cache_len = max(max_len or s, s)
    positions = torch.arange(s, device=x.device)
    h, kvs, _ = backbone(params, cfg, x, positions, enc_out, collect_kv=True,
                         kernel=kernel)
    last = logits_fn(params, cfg, h[:, -1:, :])[:, 0]
    del h
    cache = init_cache(cfg, x.shape[0], cache_len, x.device, enc_out=enc_out,
                       params=params)
    for run, rc, kv in zip(build_plan(cfg), cache["runs"], kvs):
        if run.type == "mamba":
            rc["state"], rc["conv_x"], rc["conv_bc"] = kv
            continue
        k, v = kv                                     # [L,B,S,Hkv,D]
        cap = cache_capacity(cfg, run, cache_len)
        if cap <= s:
            # the ring holds the newest `cap` positions, position p in
            # slot p % cap as decode writes it: the kept tail rolled by
            # s % cap (the reference puts them in slots 0..cap-1, so its
            # decode overwrites a key still in the window when cap does
            # not divide s)
            shift = s % cap
            rc["k"] = torch.roll(k[:, :, s - cap:], shift, dims=2)
            rc["v"] = torch.roll(v[:, :, s - cap:], shift, dims=2)
            rc["slot_pos"] = torch.roll(
                positions[s - cap:].to(torch.int32), shift).expand(
                run.count, cap).contiguous()
        else:                           # headroom for decode
            rc["k"][:, :, :s] = k
            rc["v"][:, :, :s] = v
            rc["slot_pos"][:, :s] = positions.to(torch.int32)
    cache["pos"] = s
    return last, cache


def decode_step(params, cfg: ModelConfig, cache, token):
    """One decode step.  token: [B, 1] integer ids.  Returns (logits
    [B, Vp], cache) — the same cache, its tensors updated in place and
    ``pos`` advanced."""
    pos = int(cache["pos"])
    x = embed_tokens(params, cfg, token)
    nope_global = cfg.family == "moe"
    for run, rc, rp in zip(build_plan(cfg), cache["runs"], params["runs"]):
        if run.type == "mamba":
            for i in range(run.count):
                lp = _layer(rp, i)
                h, (st, cx, cbc) = SSM.mamba_block(
                    lp["mamba"], L.rms_norm(x, lp["norm1"], cfg.norm_eps),
                    cfg, state=rc["state"][i], conv_x_state=rc["conv_x"][i],
                    conv_bc_state=rc["conv_bc"][i], decode=True)
                x = x + h
                rc["state"][i] = st
                rc["conv_x"][i] = cx
                rc["conv_bc"][i] = cbc
            continue
        layers = ([params["shared_attn"]] if run.shared else
                  [_layer(rp, i) for i in range(run.count)])
        for i, lp in enumerate(layers):
            lc = {k: v[i] for k, v in rc.items()}
            x = _decode_attn_layer_inner(lp, x, cfg, lc, pos, run,
                                         nope_global)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_fn(params, cfg, x)[:, 0]
    return logits, {"pos": pos + 1, "runs": cache["runs"]}


def _decode_attn_layer_inner(lp, x, cfg: ModelConfig, lc, pos: int,
                             run: Run, nope_global: bool):
    """One attention layer of a decode step; writes the new key and value
    to slot ``pos % cap`` of the layer's cache views ``lc`` in place,
    after the attention has read the cache."""
    cap = lc["k"].shape[1]      # [B, cap, Hkv, D]
    h = L.rms_norm(x, lp["norm1"], cfg.norm_eps)
    o, k_new, v_new = L.decode_attention(
        lp["attn"], h, cfg, lc["k"], lc["v"], lc["slot_pos"], pos,
        nope=nope_global and run.type == "attn",
        window=cfg.sliding_window if run.type == "local" else 0)
    x = x + o
    slot = pos % cap
    lc["k"][:, slot] = k_new
    lc["v"][:, slot] = v_new
    lc["slot_pos"][slot] = pos
    if "cross" in lp:
        h = L.rms_norm(x, lp["normx"], cfg.norm_eps)
        x = x + _decode_cross(lp["cross"], h, lc["ck"], lc["cv"])
    y = L.rms_norm(x, lp["norm2"], cfg.norm_eps)
    if "moe" in lp:
        return x + MOE.moe_block(lp["moe"], y, cfg)[0]
    return x + L.mlp_block(lp["mlp"], y, cfg)


def _decode_cross(cp, x, ck, cv):
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, cp["wq"].to(dt))
    hq = q.shape[2]
    o = L.direct_attention(q, L._expand_kv(ck.to(dt), hq),
                           L._expand_kv(cv.to(dt), hq), None, dt)
    return L.out_proj(cp, o, dt)
