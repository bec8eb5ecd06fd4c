"""The dense decoder assembled from a layer-pattern plan (reference
``repro/models/model.py``, its dense subset) and its serving path:
``prefill`` over a prompt, then one ``decode_step`` per token.

A config's ``pattern`` (gemma3's 5 x local + 1 x global ...) is grouped
into runs of consecutive identical block types; each run's layer
parameters are stacked on a leading dim, as in the reference, so its
arrays load unchanged.  Where the reference scans over that dim, the
port loops over it.

Ring caches: ``decode_step`` writes position ``pos`` to slot
``pos % cap`` and ``prefill`` puts each kept position p in slot
``p % cap`` too.  Here the port departs from the reference on purpose:
the reference's prefill puts the newest ``cap`` positions in slots
``0..cap-1``, so when the prompt length is not a multiple of a local
layer's window its second decode step on overwrites a key still inside
the window.  Where the prompt is a multiple of the capacity the two
layouts are the same.  ``decode_step`` updates the cache tensors in
place (the reference returns new arrays) and returns the same cache.

MoE, mamba, the encoder with cross-attention and the VLM frontend are
later slices and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import sharding as sh
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L


def _unported(what: str):
    raise NotImplementedError(
        f"{what} is not ported yet: a later LM slice (ROADMAP.md Queue 1) "
        f"ports it; the port serves the dense family")


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.n_experts:
        _unported("MoE (n_experts > 0)")
    if "mamba" in cfg.pattern:
        _unported("mamba (SSM) layers")
    if cfg.n_enc_layers:
        _unported("the encoder and cross-attention (audio)")
    if cfg.frontend_seq:
        _unported("the VLM patch frontend")


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

def _init_attn_layer(gen, cfg: ModelConfig, device, dtype):
    d = cfg.d_model
    return {"norm1": torch.zeros(d, device=device, dtype=dtype),
            "norm2": torch.zeros(d, device=device, dtype=dtype),
            "attn": L.init_attention(gen, cfg, device=device, dtype=dtype),
            "mlp": L.init_mlp(gen, cfg, device=device, dtype=dtype)}


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
    that device), one tensor at a time.  The reference keeps f32 master
    weights and casts at use; ``dtype=torch.bfloat16`` stores them in the
    compute dtype instead (what full-width serving does: the casts at use
    are then no-ops).  ``torch.Generator`` cannot replay ``jax.random``:
    parity runs load the reference's weights with ``params_from_numpy``."""
    _check_dense(cfg)
    dev = resolve_device(device)
    plan = build_plan(cfg)
    d = cfg.d_model
    vp = _vp(cfg)
    params: Dict[str, Any] = {
        "embed": L.dense_init(gen, vp, (d,), d ** -0.5, device=dev,
                              dtype=dtype),
        "final_norm": torch.zeros(d, device=dev, dtype=dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, d, (vp,), d ** -0.5,
                                         device=dev, dtype=dtype)
    run_ps = []
    for run in plan:
        if run.shared:
            if "shared_attn" not in params:
                params["shared_attn"] = _init_attn_layer(gen, cfg, dev, dtype)
            run_ps.append({})
        else:
            run_ps.append(_stack(run.count, lambda: _init_attn_layer(
                gen, cfg, dev, dtype)))
    params["runs"] = tuple(run_ps)
    return params


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


# ---------------------------------------------------------------------------
# blocks (prefill)
# ---------------------------------------------------------------------------

def _attn_mlp_block(lp, x, cfg: ModelConfig, ltype: str, positions,
                    kernel: bool):
    h, kv = L.attention_block(
        lp["attn"], L.rms_norm(x, lp["norm1"], cfg.norm_eps), cfg, ltype,
        positions, kernel=kernel)
    x = x + h
    y = L.rms_norm(x, lp["norm2"], cfg.norm_eps)
    return x + L.mlp_block(lp["mlp"], y, cfg), kv


def _run_forward(run: Run, rp, shared_p, x, cfg: ModelConfig, positions,
                 collect_kv: bool, kernel: bool):
    """One run in prefill mode.  Returns (x, (k, v) stacked over the run's
    layers, or None).  Every dense layer uses RoPE (the reference drops
    it only on the global layers of the MoE family)."""
    if run.shared:
        x, (k, v) = _attn_mlp_block(shared_p, x, cfg, "attn", positions,
                                    kernel)
        return x, ((k[None], v[None]) if collect_kv else None)
    ks, vs = [], []
    for i in range(run.count):
        x, (k, v) = _attn_mlp_block(_layer(rp, i), x, cfg, run.type,
                                    positions, kernel)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    return x, ((torch.stack(ks), torch.stack(vs)) if collect_kv else None)


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


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def backbone(params, cfg: ModelConfig, x, positions,
             collect_kv: bool = False, *, kernel: bool = True):
    """Every run, then the final norm.  Returns (hidden, per-run (k, v)
    stacks or None).  The reference also returns the MoE aux loss; the
    dense family has none.  ``kernel`` picks the attention of every
    layer (``layers.attention_block``)."""
    _check_dense(cfg)
    kvs = []
    for i, run in enumerate(build_plan(cfg)):
        x, kv = _run_forward(run, params["runs"][i],
                             params.get("shared_attn"), x, cfg, positions,
                             collect_kv, kernel)
        kvs.append(kv)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), kvs


# --- serving ---------------------------------------------------------------

def cache_capacity(cfg: ModelConfig, run: Run, seq_len: int) -> int:
    if run.type == "local":
        return min(cfg.sliding_window, seq_len)
    return seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device="cuda"):
    """Empty ring caches sized for ``seq_len`` context."""
    _check_dense(cfg)
    dev = resolve_device(device)
    dt = _dt(cfg)
    hd = cfg.resolved_head_dim
    run_caches = []
    for run in build_plan(cfg):
        cap = cache_capacity(cfg, run, seq_len)
        shape = (run.count, batch, cap, cfg.n_kv_heads, hd)
        run_caches.append({
            "k": torch.zeros(shape, device=dev, dtype=dt),
            "v": torch.zeros(shape, device=dev, dtype=dt),
            "slot_pos": torch.full((run.count, cap), -1, device=dev,
                                   dtype=torch.int32)})
    return {"pos": 0, "runs": tuple(run_caches)}


def prefill(params, cfg: ModelConfig, batch, max_len: Optional[int] = None,
            *, kernel: bool = True):
    """Run the prompt ``batch["tokens"]`` [B, S]; returns (last_logits
    [B, Vp], cache).

    ``max_len`` sizes the global-attention caches (prompt + decode
    budget); it defaults to the prompt length, and continued decoding then
    rolls the ring (the oldest tokens drop).  Local-window caches always
    ring over the window.  ``kernel`` as in ``backbone``."""
    x = embed_tokens(params, cfg, batch["tokens"])
    s = x.shape[1]
    cache_len = max(max_len or s, s)
    positions = torch.arange(s, device=x.device)
    h, kvs = backbone(params, cfg, x, positions, collect_kv=True,
                      kernel=kernel)
    last = logits_fn(params, cfg, h[:, -1:, :])[:, 0]
    cache = init_cache(cfg, x.shape[0], cache_len, x.device)
    for run, rc, (k, v) in zip(build_plan(cfg), cache["runs"], kvs):
        cap = cache_capacity(cfg, run, cache_len)     # k, v: [L,B,S,Hkv,D]
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
    _check_dense(cfg)
    pos = int(cache["pos"])
    x = embed_tokens(params, cfg, token)
    for run, rc, rp in zip(build_plan(cfg), cache["runs"], params["runs"]):
        if run.shared:
            lc = {k: rc[k][0] for k in ("k", "v", "slot_pos")}
            x = _decode_attn_layer_inner(params["shared_attn"], x, cfg, lc,
                                         pos, run)
            continue
        for i in range(run.count):
            lc = {k: rc[k][i] for k in ("k", "v", "slot_pos")}
            x = _decode_attn_layer_inner(_layer(rp, i), x, cfg, lc, pos,
                                         run)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_fn(params, cfg, x)[:, 0]
    return logits, {"pos": pos + 1, "runs": cache["runs"]}


def _decode_attn_layer_inner(lp, x, cfg: ModelConfig, lc, pos: int,
                             run: Run):
    """One layer of a decode step; writes the new key and value to slot
    ``pos % cap`` of the layer's cache views ``lc`` in place, after the
    attention has read the cache."""
    cap = lc["k"].shape[1]      # [B, cap, Hkv, D]
    h = L.rms_norm(x, lp["norm1"], cfg.norm_eps)
    o, k_new, v_new = L.decode_attention(
        lp["attn"], h, cfg, lc["k"], lc["v"], lc["slot_pos"], pos,
        window=cfg.sliding_window if run.type == "local" else 0)
    x = x + o
    slot = pos % cap
    lc["k"][:, slot] = k_new
    lc["v"][:, slot] = v_new
    lc["slot_pos"][slot] = pos
    y = L.rms_norm(x, lp["norm2"], cfg.norm_eps)
    return x + L.mlp_block(lp["mlp"], y, cfg)
