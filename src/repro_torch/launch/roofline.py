"""Roofline terms of one device's share of a step on H100s, and the
counters that read a step's FLOPs, bytes, collective bytes and peak
memory from a trace (the port of the reference
``repro.launch.roofline``).

    compute term    = Σ over dtypes of FLOPs / that dtype's peak rate
    memory term     = bytes / HBM rate
    collective term = Σ over mesh axes of their collective bytes / the
                      rate of the link that axis's ring crosses (NVLink
                      inside a host, InfiniBand across hosts; 0 on one
                      card)

The constants are the published peaks of one H100 SXM (NVIDIA's data
sheet, dense, at the full 700 W; the reference's are a TPU v5e's).  A
card set below 700 W runs slower under load: state a share of these
peaks beside the card's power limit.

The reference reads FLOPs, bytes and memory from XLA's
``cost_analysis`` / ``memory_analysis`` of the compiled step.  The port
runs the step eagerly on shape-only tensors under ``TraceCounter``, a
``TorchDispatchMode`` that sees every aten op:

* FLOPs by dtype: ``torch.utils.flop_counter``'s formulas (matmuls,
  convolutions, attention), keyed by the op's input dtype;
* bytes: every op that is not a view or an allocation reads each tensor
  input and writes each output once.  This is the eager, unfused count;
  XLA counts after fusion, so the two are not the same quantity;
* live storage bytes, tracked per storage with ``weakref.finalize``
  (the caller's arguments included), and their peak.

The hand-written kernels add what their byte and operation model
(``kernels.cost``) says one call moves and computes, from their
shape-only stand-ins in the kernel wrappers (``TraceCounter.note_kernel``).
The collectives of a ``sharding.Mesh`` note their wire bytes a device
(``TraceCounter.note_collective``, the reference's ring model), and
``collective_bytes`` sums them with the keys of the reference's HLO
parser: the port counts the collectives its per-shard programs call
(Megatron-SP's, FSDP's and the gradients'), not the ones a partitioner
chose.
"""
from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Any, Dict, Mapping, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten_with_path, tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels.cost import (BF16_FLOPS_PER_S, F32_FLOPS_PER_S,
                                      HBM_BYTES_PER_S, TF32_FLOPS_PER_S,
                                      TF32X3, TF32X3_FLOPS_PER_S)
from repro_torch.optim.optimizers import dict_keys

# --- NVIDIA H100 SXM (data sheet, dense; the compute rates in
# kernels.cost) --------------------------------------------------------------
NVLINK_BYTES_PER_S = 450e9    # to the other cards of a host, each way
HBM_BYTES = 80e9              # device memory
#: to a card of another host, each way: one 400 Gb/s NDR InfiniBand
#: port a card (ConnectX-7; NVIDIA DGX H100 user guide, "Network ports")
IB_BYTES_PER_S = 50e9
LINK_BYTES_PER_S = {"nvlink": NVLINK_BYTES_PER_S, "ib": IB_BYTES_PER_S}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def dtype_key(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def peak_flops(key: str) -> float:
    """The peak rate of FLOPs of one key of ``flops_by_dtype``: bf16 and
    fp16 at the tensor-core rate, f32 matmuls at the f32 rate (TF32's
    when ``torch.backends.cuda.matmul.allow_tf32`` is set), the f32 flash
    kernel's three-term TF32 products at a third of TF32's, the kernels'
    f32 FMAs and anything else at the f32 rate."""
    if key in ("bfloat16", "float16"):
        return BF16_FLOPS_PER_S
    if key == TF32X3:
        return TF32X3_FLOPS_PER_S
    if key == "float32" and torch.backends.cuda.matmul.allow_tf32:
        return TF32_FLOPS_PER_S
    return F32_FLOPS_PER_S


def axes_key(axes) -> str:
    """The key of a group's mesh axes in ``collective_by_axes``."""
    return "+".join(axes)


def link_rate(key: str, links: Optional[Mapping[str, str]]) -> float:
    """The rate of the slowest link a group over the axes ``key`` crosses
    (NVLink when ``links`` is None)."""
    if not links:
        return NVLINK_BYTES_PER_S
    return min(LINK_BYTES_PER_S[links.get(a, "ib")] for a in key.split("+"))


def roofline(flops_by_dtype: Mapping[str, float], bytes_per_dev: float,
             coll_bytes_per_dev: float,
             coll_by_axes: Optional[Mapping[str, float]] = None,
             links: Optional[Mapping[str, str]] = None) -> Dict[str, Any]:
    """The three terms, the dominant one and the bound (the largest),
    with the reference's keys.  ``coll_by_axes`` (a group's axes ->
    bytes, ``TraceCounter.collective_by_axes``) and the layout's
    ``links``: each axis's bytes over its link's rate; else all
    ``coll_bytes_per_dev`` over NVLink's."""
    t_compute = sum(f / peak_flops(k) for k, f in flops_by_dtype.items())
    t_memory = bytes_per_dev / HBM_BYTES_PER_S
    if coll_by_axes is None:
        t_collective = coll_bytes_per_dev / NVLINK_BYTES_PER_S
    else:
        t_collective = sum(b / link_rate(k, links)
                           for k, b in coll_by_axes.items())
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_collective}
    dominant = max(terms, key=terms.get)
    bound_s = max(terms.values())
    return {**terms, "dominant": dominant.replace("_s", ""),
            "bound_s": bound_s,
            "compute_fraction": t_compute / bound_s if bound_s else 0.0}


# ---------------------------------------------------------------------------
# the trace counters
# ---------------------------------------------------------------------------

_NO_TRAFFIC = ("empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "lift_fresh", "_assert_async")


def _tensors(x):
    """The tensors in a tree, and in the dataclasses among its leaves (a
    ``ReverseIndex``)."""
    for leaf in tree_leaves(x):
        if isinstance(leaf, torch.Tensor):
            yield leaf
        elif dataclasses.is_dataclass(leaf) and not isinstance(leaf, type):
            yield from _tensors([getattr(leaf, f.name)
                                 for f in dataclasses.fields(leaf)])


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def resident_bytes(*trees) -> int:
    """The bytes of the distinct storages of the tensors in ``trees``
    (what a step's arguments hold on the device)."""
    return sum({id(t.untyped_storage()): t.untyped_storage().nbytes()
                for t in _tensors(trees)}.values())


class TraceCounter(TorchDispatchMode):
    """FLOPs by dtype, bytes and live storage bytes of everything run
    inside it (see the module docstring).  ``resident``: the trees of
    tensors that are live when the trace starts (the step's arguments):
    their storages start the live count.  After the trace,
    ``flops_by_dtype``, ``bytes``, ``peak_bytes``, ``argument_bytes``
    and ``kernel_calls`` (the stand-ins' calls by kernel) hold the
    counts; ``output_bytes(out)`` gives the bytes of a result's storages
    that are not arguments."""

    def __init__(self, *resident):
        super().__init__()
        self.flops_by_dtype: Dict[str, float] = collections.defaultdict(
            float)
        self.bytes = 0
        self.kernel_calls: Dict[str, int] = collections.Counter()
        self.collective_by_kind: Dict[str, int] = collections.Counter()
        self.collective_by_axes: Dict[str, int] = collections.Counter()
        #: of ``collective_by_kind``, the bytes of f32 partial products
        #: (``sharding.note_collective``'s ``f32_partial``)
        self.collective_f32_partials: Dict[str, int] = collections.Counter()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}
        self._args = set()
        for t in _tensors(resident):
            self._track(t)
            self._args.add(id(t.untyped_storage()))
        self.argument_bytes = self.live_bytes

    def _track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = id(storage)
        if key in self._live:
            return
        n = storage.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(storage, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def output_bytes(self, out) -> int:
        seen = {}
        for t in _tensors(out):
            st = t.untyped_storage()
            if id(st) not in self._args:
                seen[id(st)] = st.nbytes()
        return sum(seen.values())

    def note_kernel(self, name: str, nbytes: int, flops: int,
                    key: str) -> None:
        self.kernel_calls[name] += 1
        self.bytes += nbytes
        self.flops_by_dtype[key] += flops

    def note_collective(self, kind: str, nbytes: int, axes,
                        f32_partial: bool = False) -> None:
        self.collective_by_kind[kind] += nbytes
        self.collective_by_axes[axes_key(axes)] += nbytes
        if f32_partial:
            self.collective_f32_partials[kind] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        ins = list(_tensors((args, kwargs)))
        if packet in flop_registry:
            # a GEMM's f32-output overload (``mm(..., out_dtype=)``) counts
            # as its product: the formulas take no output dtype
            fargs = [a for a in args if not isinstance(a, torch.dtype)]
            fkw = {k: v for k, v in kwargs.items() if k != "out_dtype"}
            self.flops_by_dtype[dtype_key(ins[0].dtype)] += flop_registry[
                packet](*fargs, **fkw, out_val=out)
        outs = list(_tensors(out))
        if not func.is_view and packet.__name__ not in _NO_TRAFFIC:
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        in_storages = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            if id(t.untyped_storage()) not in in_storages:
                self._track(t)
        return out


def collective_bytes(counter: TraceCounter) -> Dict[str, int]:
    """Wire bytes a device of every collective a trace's mesh called, by
    the reference's kind (``COLLECTIVES``) and ``total`` (the reference
    parses them from the partitioned HLO)."""
    out = {c: int(counter.collective_by_kind.get(c, 0)) for c in COLLECTIVES}
    out["total"] = sum(out.values())
    return out


def collective_bytes_bf16_partials(counter: TraceCounter) -> Dict[str, int]:
    """``collective_bytes`` had the f32 partial products of half-precision
    GEMMs (and their gradients) moved in the operands' dtype, as the
    reference's GSPMD moves them: each such call at half its bytes."""
    out = {c: int(counter.collective_by_kind.get(c, 0)
                  - counter.collective_f32_partials.get(c, 0) // 2)
           for c in COLLECTIVES}
    out["total"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference), N = active params
# ---------------------------------------------------------------------------

def count_params(tree, predicate=None) -> int:
    """Elements of the leaves of ``tree`` (tensors, or anything with
    ``.shape``) whose dict-key path ``predicate`` accepts (all when
    None)."""
    total = 0
    for path, leaf in tree_flatten_with_path(tree)[0]:
        if predicate is None or predicate(dict_keys(path)):
            n = 1
            for s in leaf.shape:
                n *= s
            total += n
    return total


def active_param_count(cfg, params_tree) -> Dict[str, int]:
    """Total and ACTIVE (top-k of MoE experts) non-embedding params."""
    total = count_params(params_tree)
    embed = count_params(params_tree, lambda n: bool(n) and n[-1] in (
        "embed", "lm_head"))
    moe = count_params(params_tree, lambda n: "moe" in n)
    router = count_params(params_tree, lambda n: "moe" in n
                          and n[-1] == "router")
    n_e = max(cfg.n_experts, 1)
    active_moe = router + (moe - router) * min(cfg.top_k, n_e) // n_e
    body = total - embed
    return {"total": total, "embedding": embed,
            "active": body - moe + active_moe,
            "dense_equiv": body}


def model_flops(cfg, params_tree, shape) -> float:
    """6·N_active·D for training, 2·N_active·D for inference."""
    counts = active_param_count(cfg, params_tree)
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * counts["active"] * tokens


# ---------------------------------------------------------------------------
# Analytic FLOP model (matmul-dominated terms, per global step), the
# reference's: what this implementation computes, including the chunked
# causal mask's waste (global-attention scores over the full rectangle).
# ---------------------------------------------------------------------------

def analytic_flops(cfg, shape) -> float:
    from repro_torch import sharding as sh

    b = shape.global_batch
    s = 1 if shape.kind == "decode" else shape.seq_len
    t = b * s
    d = cfg.d_model
    fwd = 0.0

    def attn_layer(ctx) -> float:
        hd = cfg.resolved_head_dim
        hq = sh.padded_heads(cfg.n_heads)
        proj = 2 * t * d * hd * (hq + 2 * cfg.n_kv_heads) \
            + 2 * t * hq * hd * d
        scores = 4 * t * ctx * hq * hd
        return proj + scores

    def mlp() -> float:
        if cfg.n_experts:
            cap = max(1, int(cfg.capacity_factor * min(cfg.moe_group, s)
                             / cfg.n_experts))
            router = 2 * t * d * cfg.n_experts
            groups = t // max(min(cfg.moe_group, s), 1)
            dispatch = 2 * 2 * t * cfg.n_experts * cap * d
            expert_tokens = groups * cfg.n_experts * cap
            ffn = 6 * min(expert_tokens, t * cfg.top_k) * d * cfg.d_ff \
                if cfg.capacity_factor <= 2 else 6 * t * cfg.top_k * d \
                * cfg.d_ff
            return router + dispatch + ffn
        return 6 * t * d * cfg.d_ff

    def mamba_layer() -> float:
        d_in = cfg.ssm_expand * d
        h = d_in // cfg.ssm_head_dim
        n = cfg.ssm_state
        p = cfg.ssm_head_dim
        proj = 2 * t * d * (2 * d_in + 2 * n + h) + 2 * t * d_in * d
        if shape.kind == "decode":
            ssd = 4 * b * h * p * n
        else:
            c = min(256, s)
            nz = s // c
            intra = b * nz * (2 * c * c * n + 2 * c * c * h * p)
            states = b * nz * (2 * c * h * p * n) * 2
            ssd = intra + states
        return proj + ssd

    for lt in cfg.pattern:
        if lt == "mamba":
            fwd += mamba_layer()
            continue
        if shape.kind == "decode":
            cap = shape.seq_len if lt in ("attn", "shared_attn") \
                else min(cfg.sliding_window, shape.seq_len)
            ctx = cap
        elif lt == "local" and cfg.sliding_window:
            ctx = min(cfg.sliding_window + cfg.q_chunk, s)
        else:
            ctx = s            # full rectangle (mask waste) per q chunk
        fwd += attn_layer(ctx) + mlp()

    if cfg.n_enc_layers and shape.kind != "decode":
        te = b * cfg.enc_seq
        enc_attn = (2 * te * d * cfg.resolved_head_dim
                    * (sh.padded_heads(cfg.n_heads) + 2 * cfg.n_kv_heads)
                    + 2 * te * d * d
                    + 4 * te * cfg.enc_seq
                    * sh.padded_heads(cfg.n_heads) * cfg.resolved_head_dim)
        fwd += cfg.n_enc_layers * (enc_attn + 6 * te * d * cfg.d_ff)
        # decoder cross-attention over enc_seq keys
        fwd += cfg.n_layers * 4 * t * cfg.enc_seq \
            * sh.padded_heads(cfg.n_heads) * cfg.resolved_head_dim

    vp = ((cfg.vocab_size + sh.MODEL_PAR - 1) // sh.MODEL_PAR) \
        * sh.MODEL_PAR
    head = 2 * t * d * vp
    total_fwd = fwd + head
    return total_fwd * (3.0 if shape.kind == "train" else 1.0)
