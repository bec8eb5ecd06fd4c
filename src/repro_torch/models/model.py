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

The blocks are written once, over per-shard lists.  ``forward_train``,
``prefill`` and ``decode_step`` take a ``mesh`` (tensor parallelism):
the parameters are then one tree a shard, and each block runs
``layers``' Megatron-SP paths over the ``model`` axis.  Without one
they run the same code on a one-shard mesh.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint
from torch.utils._pytree import (tree_flatten, tree_map,
                                  tree_map_with_path, tree_unflatten)

from repro_torch import sharding as sh
from repro_torch.configs.base import ModelConfig
from repro_torch.device import TRACE_DEVICE, resolve_device
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


def _stack(count: int, init_fn, cut=None):
    """``count`` layers from ``init_fn()``, stacked leaf by leaf on a
    leading dim (each layer is stacked and dropped before the next run's
    are drawn).  ``cut``: each layer is split as it is drawn (``cut``
    returns one part a shard) and dropped; then a list, each shard's
    parts stacked."""
    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return torch.stack(xs, 0)
    if cut is None:
        return stack(*(init_fn() for _ in range(count)))
    layers = [cut(init_fn()) for _ in range(count)]
    return [stack(*(layer[i] for layer in layers))
            for i in range(len(layers[0]))]


def init_model(gen: torch.Generator, cfg: ModelConfig, device="cuda",
               dtype=torch.float32, mesh=None) -> Any:
    """The parameter tree, drawn on ``device`` from ``gen`` (a generator of
    that device), one tensor at a time, in the reference's layout.  The
    reference keeps f32 master weights and casts at use;
    ``dtype=torch.bfloat16`` stores them in the compute dtype instead
    (what full-width serving does: the casts at use are then no-ops).
    ``torch.Generator`` cannot replay ``jax.random``: parity runs load
    the reference's weights with ``params_from_numpy``.

    ``mesh`` (a ``sharding.Mesh``): the same draws split as they are
    made, one tree a run shard, equal to ``shard_params`` of the whole
    tree; no more than one layer (or one unstacked leaf) is ever held
    whole, so a rank of a process-group mesh builds its shard without
    the whole model."""
    dev = resolve_device(device)
    d = cfg.d_model
    vp = _vp(cfg)
    is_moe = cfg.n_experts > 0
    cross = cfg.n_enc_layers > 0
    specs = None if mesh is None else model_specs(cfg)
    shards = [{} for _ in (mesh.traced if mesh is not None else (0,))]

    def put(key, tree, spec=None):
        """``tree`` (drawn whole) as ``key`` of every shard's tree."""
        parts = [tree] if mesh is None else sh.shard_tree(
            tree, specs[key] if spec is None else spec, mesh)
        for out, part in zip(shards, parts):
            out[key] = part

    def cutter(spec):
        """A stacked run's layer, split by ``spec`` without the stacked
        dim (None without a mesh)."""
        if mesh is None:
            return None
        layer = tree_map(lambda sp: sp[1:], spec, is_leaf=sh.is_spec)
        return lambda tree: sh.shard_tree(tree, layer, mesh)

    put("embed", L.dense_init(gen, vp, (d,), d ** -0.5, device=dev,
                              dtype=dtype))
    put("final_norm", torch.zeros(d, device=dev, dtype=dtype))
    if not cfg.tie_embeddings:
        put("lm_head", L.dense_init(gen, d, (vp,), d ** -0.5, device=dev,
                                    dtype=dtype))
    runs: List[List[Any]] = [[] for _ in shards]
    for r, run in enumerate(build_plan(cfg)):
        if run.shared:
            if "shared_attn" not in shards[0]:
                put("shared_attn", _init_attn_layer(gen, cfg, dev, dtype))
            parts = [{} for _ in shards]
        else:
            cut = cutter(specs["runs"][r]) if mesh is not None else None
            if run.type == "mamba":
                parts = _stack(run.count, lambda: _init_mamba_layer(
                    gen, cfg, dev, dtype), cut)
            else:
                parts = _stack(run.count, lambda: _init_attn_layer(
                    gen, cfg, dev, dtype, moe=is_moe, cross=cross), cut)
            parts = [parts] if mesh is None else parts
        for out, part in zip(runs, parts):
            out.append(part)
    for out, rs in zip(shards, runs):
        out["runs"] = tuple(rs)
    if cross:                           # whisper's encoder
        put("enc", {
            "runs": (_stack(cfg.n_enc_layers, lambda: _init_attn_layer(
                gen, cfg, dev, dtype)),),
            "pos_embed": L.dense_init(gen, cfg.enc_seq, (d,), 0.02,
                                      device=dev, dtype=dtype),
            "final_norm": torch.zeros(d, device=dev, dtype=dtype)})
    if cfg.frontend_seq:                # the VLM projector
        put("proj", L.dense_init(gen, d, (d,), d ** -0.5, device=dev,
                                 dtype=dtype))
    return shards[0] if mesh is None else shards


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
    ``shard_params`` splits a tree over a ``sharding.Mesh`` by them; the
    dry-run records them."""
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
# blocks (train / prefill), over per-shard lists
# ---------------------------------------------------------------------------
# Every block below runs one data replica as lists, one entry a shard of
# a ``model`` group ``tp`` (a ``sharding.Group``; the reference's
# Megatron-SP, ``model.py:228, :248, :297`` and ``layers.py``): each
# shard's parameters (``shard_params``, FSDP dims already gathered), its
# part of the residual stream (sequence-sharded between blocks when
# ``rs``, ``layers.tp_rs``), its cache.  The embedding is vocab-sharded
# and its partial sums go to the stream by ``psum_scatter``; every block
# is ``layers``' under ``tp``; the loss and the logits are
# vocab-parallel.  The one-device entry points run the same code as the
# one-shard case (``_solo``): a one-shard group's collectives return
# their input and ``layers`` runs its one-device code for it, so the
# arithmetic is the one-device model's.

def _zero(x):
    return torch.zeros((), dtype=F32, device=x.device)


@functools.lru_cache(maxsize=None)
def _solo(device: torch.device) -> sh.Mesh:
    """The one-shard mesh on ``device`` the one-device entry points run
    on."""
    return sh.Mesh((1, 1), ("data", "model"), (device,))


def _solo_group(device) -> sh.Group:
    return _solo(device).group(sh.MODEL, 0)


def _attn_mlp_block(lps, x, cfg: ModelConfig, ltype: str, positions, enc,
                    nope_global: bool, kernel: bool, tp, rs: bool):
    """One attention layer: self-attention (NoPE on the global layers
    when ``nope_global``), whisper's cross-attention where the layer has
    one, then the MLP or the MoE.  Returns (x, (k, v), aux), each a list
    of the shards'."""
    eps = cfg.norm_eps
    h = [L.rms_norm(a, lp["norm1"], eps) for a, lp in zip(x, lps)]
    o, kv = L.attention_block([lp["attn"] for lp in lps], h, cfg, ltype,
                              positions, nope=nope_global and ltype == "attn",
                              kernel=kernel, tp=tp, rs=rs)
    x = [a + b for a, b in zip(x, o)]
    if "cross" in lps[0]:
        hx = [L.rms_norm(a, lp["normx"], eps) for a, lp in zip(x, lps)]
        x = [a + b for a, b in zip(x, L.cross_attention_block(
            [lp["cross"] for lp in lps], hx, enc, cfg, tp=tp, rs=rs))]
    y = [L.rms_norm(a, lp["norm2"], eps) for a, lp in zip(x, lps)]
    if "moe" in lps[0]:
        h, aux = MOE.moe_block([lp["moe"] for lp in lps], y, cfg, tp=tp,
                               rs=rs)
    else:
        h = L.mlp_block([lp["mlp"] for lp in lps], y, cfg, tp=tp, rs=rs)
        aux = [_zero(a) for a in x]
    return [a + b for a, b in zip(x, h)], kv, aux


def _run_forward(run: Run, rps, shared, x, cfg: ModelConfig, positions, enc,
                 collect_kv: bool, kernel: bool, remat: bool, tp, rs: bool):
    """One run in prefill (or, with ``remat``, training) mode.  Returns
    (x, each shard's cache entries of the run stacked over its layers or
    None, aux): (k, v) of an attention run, (state, conv_x, conv_bc) of a
    mamba run.  llama4's iRoPE drops RoPE on the global layers of the MoE
    family.  ``remat`` checkpoints each layer (``torch.utils.checkpoint``:
    only the layer's input is kept, the reference's ``jax.checkpoint`` of
    each scanned layer) and collects no cache."""
    nope_global = cfg.family == "moe"
    if run.shared:
        layers, ltype, nope_global = [shared], "attn", False
    else:
        layers = [[_layer(rp, i) for rp in rps] for i in range(run.count)]
        ltype = run.type

    def body(x, lps):
        if ltype == "mamba":
            h, st = SSM.mamba_block(
                [lp["mamba"] for lp in lps],
                [L.rms_norm(a, lp["norm1"], cfg.norm_eps)
                 for a, lp in zip(x, lps)], cfg, tp=tp, rs=rs)
            return [a + b for a, b in zip(x, h)], st, [_zero(a) for a in x]
        return _attn_mlp_block(lps, x, cfg, ltype, positions, enc,
                               nope_global, kernel, tp, rs)

    aux = [_zero(a) for a in x]
    outs = []
    for lps in layers:
        if remat:
            x, a = checkpoint(lambda x, lps: body(x, lps)[::2], x, lps,
                              use_reentrant=False)
        else:
            x, c, a = body(x, lps)
            if collect_kv:
                outs.append(c)
        aux = [u + v for u, v in zip(aux, a)]
    if not outs:
        return x, None, aux
    return x, [tuple(torch.stack([c[t][j] for c in outs])
                     for t in range(len(outs[0])))
               for j in range(len(x))], aux


def _encode(ps, cfg: ModelConfig, frames, tp, remat: bool):
    """Whisper's encoder over stub frame embeddings [B, enc_seq, d]:
    bidirectional attention, computed directly (the reference's
    ``_encode``, outside its flash kernel).  Returns the encoder output,
    whole on every shard."""
    x = [f + p["enc"]["pos_embed"][None].to(f.dtype)
         for f, p in zip(frames, ps)]
    rs = L.tp_rs(tp, x[0].shape[1])
    x = L.tp_reduce(x, tp, rs, False)
    eps = cfg.norm_eps

    def body(x, lps):
        h = [L.rms_norm(a, lp["norm1"], eps) for a, lp in zip(x, lps)]
        attn = [lp["attn"] for lp in lps]
        q, k, v = L.qkv(attn, h, cfg, None, False, tp=tp, rs=rs)
        o = [L.direct_attention(qq, L._expand_kv(kk, qq.shape[2]),
                                L._expand_kv(vv, qq.shape[2]), None,
                                qq.dtype) for qq, kk, vv in zip(q, k, v)]
        x = [a + b for a, b in zip(x, L.out_proj(attn, o, x[0].dtype, tp=tp,
                                                 rs=rs, cfg=cfg))]
        y = [L.rms_norm(a, lp["norm2"], eps) for a, lp in zip(x, lps)]
        return [a + b for a, b in zip(x, L.mlp_block(
            [lp["mlp"] for lp in lps], y, cfg, tp=tp, rs=rs))]
    for i in range(ps[0]["enc"]["runs"][0]["norm1"].shape[0]):
        lps = [_layer(p["enc"]["runs"][0], i) for p in ps]
        x = (checkpoint(body, x, lps, use_reentrant=False) if remat
             else body(x, lps))
    x = [L.rms_norm(a, p["enc"]["final_norm"], eps) for a, p in zip(x, ps)]
    return L.tp_gather(x, tp, rs)


# ---------------------------------------------------------------------------
# embedding / logits / loss (vocab-parallel)
# ---------------------------------------------------------------------------

def embed_tokens(params, cfg: ModelConfig, tokens):
    return params["embed"][tokens.long()].to(_dt(cfg))


def _head_matrix(params, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return params["embed"].T            # [d, Vp]
    return params["lm_head"]


def _vocab_offsets(ps, tp) -> List[int]:
    v_loc = ps[0]["embed"].shape[0]
    return [pos * v_loc for pos in tp.positions]


def _embed(ps, cfg: ModelConfig, tokens, tp):
    """Each shard's partial embedding [B, S, d]: the rows of the tokens its
    vocab block holds, zero elsewhere (one shard: ``embed_tokens``)."""
    if tp.size == 1:
        return [embed_tokens(ps[0], cfg, tokens[0])]
    out = []
    for p, tok, off in zip(ps, tokens, _vocab_offsets(ps, tp)):
        e = p["embed"]
        ids = tok.long() - off
        ok = (ids >= 0) & (ids < e.shape[0])
        rows = e[ids.clamp(0, e.shape[0] - 1)].to(_dt(cfg))
        out.append(torch.where(ok[..., None], rows,
                               torch.zeros((), dtype=rows.dtype,
                                           device=rows.device)))
    return out


def _logits(ps, cfg: ModelConfig, hidden, tp):
    """Each shard's vocab block of the logits, the vocab padding masked."""
    out = []
    for p, h, off in zip(ps, hidden, _vocab_offsets(ps, tp)):
        lg = h @ _head_matrix(p, cfg).to(h.dtype)
        n = lg.shape[-1]
        if off + n > cfg.vocab_size:        # mask the vocab padding
            col = torch.arange(off, off + n, device=lg.device)
            lg = lg.masked_fill(col >= cfg.vocab_size, -1e30)
        out.append(lg)
    return out


def logits_fn(params, cfg: ModelConfig, hidden):
    return _logits([params], cfg, [hidden], _solo_group(hidden.device))[0]


def _loss_chunk(w, hc, lc, vocab: int):
    """One chunk of the loss on one shard: (valid count, loss sum,
    correct count), all f32 scalars, from hidden ``hc`` [B, c, d], the
    head matrix ``w`` [d, Vp] and labels ``lc`` [B, c]."""
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


def _vp_loss_chunk(ps, hcs, lcs, cfg: ModelConfig, tp):
    """One chunk of the vocab-parallel loss: (valid count, loss sum,
    correct count) of shard 0, f32 scalars.  The max of the logits and
    each shard's argmax go round in one ``all_gather``; the sums of
    exponentials and the label logits in one ``psum``."""
    if tp.size == 1:
        return _loss_chunk(_head_matrix(ps[0], cfg), hcs[0], lcs[0],
                           cfg.vocab_size)
    lgs = [lg.to(F32) for lg in _logits(ps, cfg, hcs, tp)]
    offs = _vocab_offsets(ps, tp)
    stats = [torch.stack([m.detach(), (a + off).to(F32)])
             for (m, a), off in zip((lg.max(-1) for lg in lgs), offs)]
    stats = sh.all_gather(stats, tp, dim=0)
    sums, best = [], None
    for lg, st, lc, off in zip(lgs, stats, lcs, offs):
        st = st.reshape(-1, 2, *st.shape[1:])          # [M, 2, B, c]
        gmax = st[:, 0].max(0).values
        li = torch.clamp(lc, min=0).long() - off
        mine = (li >= 0) & (li < lg.shape[-1])
        ll = torch.gather(lg, -1, li.clamp(0, lg.shape[-1] - 1)[..., None])
        ll = torch.where(mine, ll[..., 0], torch.zeros((), device=lg.device))
        sums.append(torch.stack([torch.exp(lg - gmax[..., None]).sum(-1),
                                 ll]))
        if best is None:                    # shard 0's view of the argmax
            win = (st[:, 0] == gmax).to(F32).argmax(0)
            best = (gmax, st[:, 1].gather(0, win[None])[0])
    tot = sh.psum(sums, tp)[0]
    gmax, amax = best
    mask = lcs[0] >= 0
    logz = gmax + torch.log(tot[0])
    loss_sum = torch.sum((logz - tot[1]) * mask)
    correct = torch.sum((amax.long() == torch.clamp(lcs[0], min=0).long())
                        * mask).to(F32)
    return torch.sum(mask).to(F32), loss_sum, correct


def _loss(ps, cfg: ModelConfig, hidden, labels, tp, rs: bool):
    """The loss's sums (valid count, loss sum, correct count) over the
    vocab-sharded head, without materialising [B, S, V]: a loop over
    sequence chunks of ``LOSS_CHUNK`` (reference ``model.py:316-348``).
    labels: int [B, S], -1 = ignored position.  Each chunk runs under
    ``torch.utils.checkpoint``, so its logits are recomputed in the
    backward and never kept (the reference's ``nothing_saveable``): the
    f32 logits are the largest buffer of a train step otherwise."""
    hs = L.tp_gather(hidden, tp, rs)
    s = hs[0].shape[1]
    c = min(LOSS_CHUNK, s)
    nc = s // c
    if nc * c != s:
        raise ValueError(f"sequence {s} is not a multiple of the loss "
                         f"chunk {c}")
    labs = _on(tp, labels)
    zero = torch.zeros((), dtype=F32, device=tp.devices[0])
    tot, loss_sum, correct = zero, zero, zero
    for i in range(nc):
        t, ls, cr = checkpoint(
            _vp_loss_chunk, ps, [h[:, i * c:(i + 1) * c] for h in hs],
            [lb[:, i * c:(i + 1) * c] for lb in labs], cfg, tp,
            use_reentrant=False)
        tot, loss_sum, correct = tot + t, loss_sum + ls, correct + cr
    return tot, loss_sum, correct


def chunked_lm_loss(params, cfg: ModelConfig, hidden, labels):
    """Mean CE over the vocab and accuracy of ``hidden`` [B, S, d] on one
    device (``_loss``).  Returns (loss, acc), f32 scalars."""
    tot, loss_sum, correct = _loss([params], cfg, [hidden], labels,
                                   _solo_group(hidden.device), False)
    denom = torch.clamp(tot, min=1.0)
    return loss_sum / denom, correct / denom


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _backbone(ps, cfg: ModelConfig, x, positions, enc, collect_kv: bool,
              kernel: bool, remat: bool, tp, rs: bool):
    """Every run, then the final norm.  Returns (hidden, per-run cache
    entries (one a shard) or None, the MoE aux loss summed over the
    layers, f32), lists of the shards'.  ``kernel`` picks the causal
    self-attention of every layer (``layers.attention_block``);
    ``remat`` checkpoints every layer (training)."""
    aux_total = [_zero(a) for a in x]
    kvs = []
    for i, run in enumerate(build_plan(cfg)):
        x, kv, aux = _run_forward(
            run, [p["runs"][i] for p in ps],
            [p.get("shared_attn") for p in ps],
            x, cfg, positions, enc, collect_kv, kernel, remat, tp, rs)
        kvs.append(kv)
        aux_total = [u + v for u, v in zip(aux_total, aux)]
    x = [L.rms_norm(a, p["final_norm"], cfg.norm_eps) for a, p in zip(x, ps)]
    return x, kvs, aux_total


def backbone(params, cfg: ModelConfig, x, positions, enc_out=None,
             collect_kv: bool = False, *, kernel: bool = True,
             remat: bool = False):
    """``_backbone`` on one device: (hidden, per-run cache entries or
    None, the MoE aux loss)."""
    h, kvs, aux = _backbone([params], cfg, [x], positions,
                            None if enc_out is None else [enc_out],
                            collect_kv, kernel, remat, _solo_group(x.device),
                            False)
    return h[0], [None if kv is None else kv[0] for kv in kvs], aux[0]


def _stream(ps, cfg: ModelConfig, batches, tp, remat: bool = False):
    """The backbone's input: the token embeddings, after the projected
    patch embeddings (VLM, batch ``patches`` [B, P, d]; shard 0 carries
    them into the sum); whether it is sequence-sharded; and whisper's
    encoder over ``frames`` [B, enc, d], whole on every shard (None for
    the other families)."""
    dt = _dt(cfg)
    parts = _embed(ps, cfg, [b["tokens"] for b in batches], tp)
    if cfg.frontend_seq:
        pats = []
        for p, bt, pos in zip(ps, batches, tp.positions):
            pat = bt["patches"].to(dt)
            pats.append(pat @ p["proj"].to(dt) if pos == 0
                        else torch.zeros_like(pat))
        parts = [torch.cat([a, x], dim=1) for a, x in zip(pats, parts)]
    rs = L.tp_rs(tp, parts[0].shape[1])
    x = L.tp_reduce(parts, tp, rs, True)
    enc = None
    if cfg.n_enc_layers:
        enc = _encode(ps, cfg, [b["frames"].to(dt) for b in batches], tp,
                      remat)
    return x, rs, enc


def _inputs(params, cfg: ModelConfig, batch, remat: bool = False):
    """``_stream`` on one device: (the backbone's input, the encoder's
    output or None)."""
    x, _, enc = _stream([params], cfg, [batch],
                        _solo_group(batch["tokens"].device), remat)
    return x[0], None if enc is None else enc[0]


def forward_train(params, cfg: ModelConfig, batch, mesh=None):
    """The training forward (reference ``model.py:366-389``): embed (the
    patches first, VLM), the encoder (audio), the backbone through the
    reference model's own chunked attention (the flash kernel has no
    backward and the reference never trains through it), each layer
    checkpointed when ``cfg.remat``, the final norm and the chunked
    loss.  batch: tokens [B, S], labels [B, S] (-1 ignored), and
    ``patches`` [B, P, d] (VLM; their positions carry no label) or
    ``frames`` [B, enc_seq, d] (audio).  Returns ``(total, {"loss",
    "aux", "acc"})`` with ``total = loss + 0.01 * aux``, aux the MoE
    load-balance loss (0 without experts).

    ``mesh`` (a ``sharding.Mesh``): ``params`` one tree a run shard
    (``shard_params``); ``batch``'s rows split over the run data
    replicas, each through the tensor-parallel model; the sums of the
    loss go round the batch axes in one ``psum``."""
    if mesh is None:
        mesh, params = _solo(batch["tokens"].device), [params]
    stats = []
    reps = replicas(mesh)
    for (tp, idx), bt in zip(reps, _replica_rows(batch, mesh, len(reps))):
        ps = [params[i] for i in idx]
        labels = bt["labels"]
        if cfg.frontend_seq:
            pad = torch.full((labels.shape[0], cfg.frontend_seq), -1,
                             dtype=labels.dtype, device=labels.device)
            labels = torch.cat([pad, labels], dim=1)
        parts = [{k: v.to(d) for k, v in bt.items()} for d in tp.devices]
        x, rs, enc = _stream(ps, cfg, parts, tp, remat=cfg.remat)
        positions = torch.arange(labels.shape[1], device=tp.devices[0])
        h, _, aux = _backbone(ps, cfg, x, positions, enc, False, False,
                              cfg.remat, tp, rs)
        tot, ls, cr = _loss(ps, cfg, h, labels, tp, rs)
        stats.append((tot, ls, cr, aux[0].to(tot.device)))
    # the batch's sums over every data replica, on shard 0's replica
    bg = _batch_group(mesh)
    if bg.size == 1:
        tot, ls, cr, aux = stats[0]
    else:
        tot, ls, cr, aux = sh.psum([torch.stack(t) for t in stats], bg)[0]
        aux = aux / bg.size
    denom = torch.clamp(tot, min=1.0)
    loss, acc = ls / denom, cr / denom
    return loss + 0.01 * aux, {"loss": loss, "aux": aux, "acc": acc}


# --- serving ---------------------------------------------------------------

def cache_capacity(cfg: ModelConfig, run: Run, seq_len: int) -> int:
    if run.type == "local":
        return min(cfg.sliding_window, seq_len)
    return seq_len


def _cross_kv(params, enc_out, cfg: Optional[ModelConfig] = None, tp=None,
              pos: int = 0):
    """Whisper's cross-attention K and V of the encoder output, for every
    decoder layer: [L, B, enc, Hkv, D] each (with ``tp``: the KV heads
    shard ``pos``'s query heads read)."""
    dt = enc_out.dtype
    cross = params["runs"][0]["cross"]
    if tp is not None and cross["wk"].shape[2] == cfg.n_kv_heads:
        sel = L.kv_heads(cross["wq"].shape[2], sh.padded_heads(cfg.n_heads),
                         cfg.n_kv_heads, pos)
        if isinstance(sel, torch.Tensor):
            sel = sel.to(enc_out.device)
        if sel is not None:
            cross = {w: cross[w][:, :, sel] for w in ("wk", "wv")}
    return tuple(torch.einsum("bsd,ldhk->lbshk", enc_out, cross[w].to(dt))
                 for w in ("wk", "wv"))


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device="cuda",
               enc_out=None, params=None, *, tp=None, pos: int = 0):
    """Empty caches sized for ``seq_len`` context: ring K/V of the
    attention runs, SSD state and conv inputs of the mamba runs, and for
    whisper the cross-attention's K/V (of ``enc_out`` when it and
    ``params`` are given, else zeros).  With ``tp`` (a ``model`` group)
    and ``pos`` (a shard's position in it): that shard's cache, its KV
    heads and its SSD heads and channels (``_shard_dims``)."""
    dev = resolve_device(device)
    dt = _dt(cfg)
    hd = cfg.resolved_head_dim
    hkv, mamba = _shard_dims(cfg, tp, pos)
    run_caches = []
    for run in build_plan(cfg):
        if run.type == "mamba":
            d_in, h, p, nbc = mamba
            k1 = cfg.ssm_conv - 1
            run_caches.append({
                "state": torch.zeros(run.count, batch, h, p, cfg.ssm_state,
                                     device=dev, dtype=F32),
                "conv_x": torch.zeros(run.count, batch, k1, d_in,
                                      device=dev, dtype=dt),
                "conv_bc": torch.zeros(run.count, batch, k1, nbc,
                                       device=dev, dtype=dt)})
            continue
        cap = cache_capacity(cfg, run, seq_len)
        shape = (run.count, batch, cap, hkv, hd)
        c = {"k": torch.zeros(shape, device=dev, dtype=dt),
             "v": torch.zeros(shape, device=dev, dtype=dt),
             "slot_pos": torch.full((run.count, cap), -1, device=dev,
                                    dtype=torch.int32)}
        if cfg.n_enc_layers:
            if params is not None and enc_out is not None:
                c["ck"], c["cv"] = _cross_kv(params, enc_out, cfg, tp, pos)
            else:
                c["ck"] = torch.zeros(run.count, batch, cfg.enc_seq, hkv, hd,
                                      device=dev, dtype=dt)
                c["cv"] = torch.zeros_like(c["ck"])
        run_caches.append(c)
    return {"pos": 0, "runs": tuple(run_caches)}


def _shard_dims(cfg: ModelConfig, tp=None, pos: int = 0):
    """(the KV heads a shard caches, (d_in, heads, head dim, B|C columns)
    of its SSD) at position ``pos`` of ``tp``; the whole model's without
    ``tp``."""
    hq, hkv = sh.padded_heads(cfg.n_heads), cfg.n_kv_heads
    if L.heads_sharded(tp, hq):
        if L.heads_sharded(tp, hkv):
            hkv //= tp.size
        else:
            sel = L.kv_heads(hq // tp.size, hq, hkv, pos)
            hkv = (len(range(hkv)[sel]) if isinstance(sel, slice)
                   else len(sel))
    mamba = None
    if "mamba" in cfg.pattern:
        d_in, h, p, n = SSM.ssm_dims(cfg)
        if tp is not None and tp.size > 1 and h % sh.MODEL_PAR == 0:
            d_in, h, nbc = d_in // tp.size, h // tp.size, 2 * n // tp.size
        else:
            nbc = 2 * n
        mamba = (d_in, h, p, nbc)
    return hkv, mamba


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
            *, kernel: bool = True, mesh=None):
    """Run the prompt ``batch["tokens"]`` [B, S] (with ``patches`` or
    ``frames`` as ``forward_train`` takes them); returns (last_logits
    [B, Vp], cache).

    ``max_len`` sizes the global-attention caches (prompt + decode
    budget); it defaults to the prompt length (with the patches), and
    continued decoding then rolls the ring (the oldest tokens drop).
    Local-window caches always ring over the window.  ``kernel`` as in
    ``backbone``.

    ``mesh``: ``params`` one tree a run shard; the rows of ``batch`` split
    over the data replicas; returns the logits of every row and one
    cache a run shard, each holding its shard's heads (the reference
    shards the caches' sequence instead, ``cache_specs``)."""
    solo = mesh is None
    if solo:
        mesh, params = _solo(batch["tokens"].device), [params]
    logits, caches = [], [None] * len(mesh.traced)
    reps = replicas(mesh)
    for (tp, idx), bt in zip(reps, _replica_rows(batch, mesh, len(reps))):
        ps = [params[i] for i in idx]
        parts = [{k: v.to(d) for k, v in bt.items()} for d in tp.devices]
        x, rs, enc = _stream(ps, cfg, parts, tp)
        s = x[0].shape[1] * (tp.size if rs else 1)
        cache_len = max(max_len or s, s)
        positions = torch.arange(s, device=tp.devices[0])
        h, kvs, _ = _backbone(ps, cfg, x, positions, enc, True, kernel,
                              False, tp, rs)
        last = [a[:, -1:] for a in h]
        if rs:          # the last position lives on the last shard
            last = [a[:, -1:] for a in sh.all_gather(last, tp, dim=1)]
        lg = sh.all_gather(_logits(ps, cfg, last, tp), tp, dim=-1)
        del h, last     # views of the hidden: free it before the caches
        logits.append(lg[0][:, 0])
        for j, (i, p, pos) in enumerate(zip(idx, ps, tp.positions)):
            cache = init_cache(cfg, x[j].shape[0], cache_len, tp.devices[j],
                               enc_out=None if enc is None else enc[j],
                               params=p, tp=tp, pos=pos)
            _fill_cache(cfg, cache, [None if kv is None else kv[j]
                                     for kv in kvs], s, cache_len,
                        positions.to(tp.devices[j]))
            caches[i] = cache
    return _rows(logits, mesh), caches[0] if solo else caches


def _rows(logits, mesh):
    """The data replicas' logits as one batch, on the first's device (a
    process-group mesh's: all-gathered over the batch axes)."""
    if mesh.rank_local:
        return sh.all_gather(logits, _batch_group(mesh))[0]
    if len(logits) == 1:
        return logits[0]
    return torch.cat([lg.to(logits[0].device) for lg in logits])


def _fill_cache(cfg: ModelConfig, cache, kvs, s: int, cache_len: int,
                positions) -> None:
    """Write a prefill's per-run cache entries ``kvs`` (over ``s``
    positions) into the empty ``cache`` and set its ``pos``."""
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


def decode_step(params, cfg: ModelConfig, cache, token, mesh=None):
    """One decode step.  token: [B, 1] integer ids.  Returns (logits
    [B, Vp], cache) — the cache's tensors updated in place and ``pos``
    advanced.  ``mesh``: ``params`` and ``cache`` one a run shard
    (``prefill(mesh=)``'s), each cache's ``pos`` advanced in place;
    without it the returned cache is a new dict over the same runs."""
    if mesh is None:
        logits, caches = decode_step([params], cfg, [dict(cache)], token,
                                     _solo(token.device))
        return logits, caches[0]
    pos = int(cache[0]["pos"])
    nope_global = cfg.family == "moe"
    logits = []
    reps = replicas(mesh)
    for (tp, idx), bt in zip(reps, _replica_rows({"t": token}, mesh,
                                                 len(reps))):
        ps = [params[i] for i in idx]
        cs = [cache[i] for i in idx]
        x = L.tp_reduce(_embed(ps, cfg, _on(tp, bt["t"]), tp), tp, False,
                        True)
        for r, run in enumerate(build_plan(cfg)):
            rcs = [c["runs"][r] for c in cs]
            if run.type == "mamba":
                for i in range(run.count):
                    lps = [_layer(p["runs"][r], i) for p in ps]
                    h, (st, cx, cbc) = SSM.mamba_block(
                        [lp["mamba"] for lp in lps],
                        [L.rms_norm(a, lp["norm1"], cfg.norm_eps)
                         for a, lp in zip(x, lps)], cfg,
                        state=[c["state"][i] for c in rcs],
                        conv_x_state=[c["conv_x"][i] for c in rcs],
                        conv_bc_state=[c["conv_bc"][i] for c in rcs],
                        decode=True, tp=tp)
                    x = [a + b for a, b in zip(x, h)]
                    for c, s1, s2, s3 in zip(rcs, st, cx, cbc):
                        c["state"][i], c["conv_x"][i], c["conv_bc"][i] = \
                            s1, s2, s3
                continue
            for i in range(run.count):
                lps = [p["shared_attn"] if run.shared
                       else _layer(p["runs"][r], i) for p in ps]
                lcs = [{k: v[i] for k, v in c.items()} for c in rcs]
                x = _decode_layer(lps, x, cfg, lcs, pos, run, nope_global, tp)
        x = [L.rms_norm(a, p["final_norm"], cfg.norm_eps)
             for a, p in zip(x, ps)]
        logits.append(sh.all_gather(_logits(ps, cfg, x, tp), tp,
                                    dim=-1)[0][:, 0])
    for c in cache:
        c["pos"] = pos + 1
    return _rows(logits, mesh), cache


def _decode_layer(lps, x, cfg: ModelConfig, lcs, pos: int, run: Run,
                  nope_global: bool, tp):
    """One attention layer of a decode step (the stream whole on every
    shard: s = 1 does not split); writes the new key and value to slot
    ``pos % cap`` of each shard's cache views ``lcs`` in place, after the
    attention has read the cache."""
    eps = cfg.norm_eps
    h = [L.rms_norm(a, lp["norm1"], eps) for a, lp in zip(x, lps)]
    o, kn, vn = L.decode_attention(
        [lp["attn"] for lp in lps], h, cfg, [c["k"] for c in lcs],
        [c["v"] for c in lcs], [c["slot_pos"] for c in lcs], pos,
        nope=nope_global and run.type == "attn",
        window=cfg.sliding_window if run.type == "local" else 0, tp=tp)
    x = [a + b for a, b in zip(x, o)]
    for c, k, v in zip(lcs, kn, vn):
        slot = pos % c["k"].shape[1]        # [B, cap, Hkv, D]
        c["k"][:, slot] = k
        c["v"][:, slot] = v
        c["slot_pos"][slot] = pos
    if "cross" in lps[0]:
        split = L.heads_sharded(tp, sh.padded_heads(cfg.n_heads))
        parts = [_decode_cross(L.local_attention(lp["cross"], cfg, tp, ps),
                               L.rms_norm(a, lp["normx"], eps), c["ck"],
                               c["cv"], f32_out=split)
                 for lp, a, c, ps in zip(lps, x, lcs, tp.positions)]
        x = [a + b for a, b in zip(x, L.tp_reduce(parts, tp, False, split,
                                                  x[0].dtype))]
    y = [L.rms_norm(a, lp["norm2"], eps) for a, lp in zip(x, lps)]
    if "moe" in lps[0]:
        h = MOE.moe_block([lp["moe"] for lp in lps], y, cfg, tp=tp)[0]
    else:
        h = L.mlp_block([lp["mlp"] for lp in lps], y, cfg, tp=tp)
    return [a + b for a, b in zip(x, h)]


def _decode_cross(cp, x, ck, cv, f32_out: bool = False):
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, cp["wq"].to(dt))
    hq = q.shape[2]
    o = L.direct_attention(q, L._expand_kv(ck.to(dt), hq),
                           L._expand_kv(cv.to(dt), hq), None, dt)
    return L.out_proj(cp, o, dt, f32_out=f32_out)


# ---------------------------------------------------------------------------
# parameters over a sharding.Mesh
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def model_specs(cfg: ModelConfig):
    """``param_specs`` of the whole model's shapes (from a shape-only
    ``init_model``): a shard's own shapes would decide otherwise."""
    return param_specs(cfg, init_model(torch.Generator().manual_seed(0), cfg,
                                       device=TRACE_DEVICE))


def specs_like(tree, cfg: ModelConfig):
    """``model_specs`` in the layout of ``tree`` (a parameter tree or a
    shard's, whatever its dicts' key order), leaf by key path."""
    specs = model_specs(cfg)

    def get(path, _):
        node = specs
        for k in path:
            node = node[k.key] if hasattr(k, "key") else node[k.idx]
        return node
    return tree_map_with_path(get, tree)


def spec_leaves(tree, cfg: ModelConfig) -> List[tuple]:
    """The specs of ``tree``'s leaves, in its flattening order."""
    return tree_flatten(specs_like(tree, cfg), is_leaf=sh.is_spec)[0]


def shard_params(params, cfg: ModelConfig, mesh) -> List[Any]:
    """The parameter tree split over ``mesh`` by ``param_specs``: one tree
    a run shard, each a copy on its shard's device."""
    return sh.shard_tree(params, specs_like(params, cfg), mesh)


def unshard_params(parts, cfg: ModelConfig, mesh, device=None):
    """The parameter tree ``shard_params`` split, whole again."""
    return sh.unshard_tree(parts, specs_like(parts[0], cfg), mesh, device)


def gather_params(params, cfg: ModelConfig, mesh) -> List[Any]:
    """The shards' parameters with every ``FSDP`` dim all-gathered over
    ``data`` (ZeRO-3: before use; its backward reduce-scatters the
    gradients)."""
    if mesh.sizes.get("data", 1) == 1:
        return params
    specs = spec_leaves(params[0], cfg)
    flat = [tree_flatten(p) for p in params]
    leaves = [list(f[0]) for f in flat]
    for i, sp in enumerate(specs):
        if sh.FSDP not in sp:
            continue
        for g in mesh.groups("data"):
            idx = [mesh.traced.index(f) for f in g.members]
            got = sh.all_gather([leaves[t][i] for t in idx], g,
                                sp.index(sh.FSDP))
            for t, o in zip(idx, got):
                leaves[t][i] = o
    return [tree_unflatten(lv, f[1]) for lv, f in zip(leaves, flat)]


def replicas(mesh) -> List[Tuple[Any, List[int]]]:
    """(``model`` group, indices of its shards in the mesh's shard lists)
    of each run data replica, in shard order."""
    return [(g, [mesh.traced.index(f) for f in g.members])
            for g in mesh.groups(sh.MODEL)]


def _batch_group(mesh) -> sh.Group:
    """The group along the batch axes through the mesh's first run
    shard."""
    return mesh.group(sh.batch_mesh_axes(mesh), mesh.traced[0])


def _replica_rows(batch: Dict[str, torch.Tensor], mesh, n: int):
    """The rows of ``batch`` (the global batch) of each of the ``n`` run
    data replicas: ``_split_rows``' blocks, one a replica; a
    process-group mesh runs one replica, and takes the block of its
    position along the batch axes."""
    if mesh.rank_local:
        bg = _batch_group(mesh)
        return [_split_rows(batch, bg.size)[bg.positions[0]]]
    return _split_rows(batch, n)


def _split_rows(batch: Dict[str, torch.Tensor], n: int):
    """dim 0 of every tensor of ``batch`` into ``n`` equal blocks."""
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"a batch of {b} does not split over {n} data "
                         f"replicas")
    m = b // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(n)]


def _on(tp, t):
    return [t.to(d) for d in tp.devices]
