"""Dispatch-trace auditor: run ONE real training step of every sweep
variant under a ``TorchDispatchMode`` and walk the aten ops it runs
(the port's counterpart of ``repro.analysis.jaxpr_audit``).

Each variant's source is the one a sweep builds
(``experiment.make_source``), bound by the ``Trainer`` itself, and the
step traced is ``Trainer._step`` on a batch from the source's own
``batches()``; a dispatch mode sees only the thread that entered it, so
the sampling thread's host work stays out of the trace, and
``Trainer.close`` stops it.  The shared eval (``engine._eval_acc``) and
the layer-wise inference chunk (``inference._chunk_apply``) are traced
too.

The CUDA kernels run through ``ctypes``, not as aten ops, so a trace
cannot see them: their launches are read from the kernels' own counters
(``launch_counts()`` of ``neighbor_agg.ops``, ``featshard`` and
``flash_attn.ops``) around the step.  ``NodeMesh``'s collectives are
plain torch ops; the trace counts their calls by name.

Hazard classes, mapped from the reference's:

* **f64 outputs** — any op producing float64 / complex128 (error).  The
  port is an f32 / bf16 code base; a double doubles the bytes.
* **cast round trips** — an ``aten._to_copy`` that changes the dtype of
  the direct output of another such cast back to that cast's source
  dtype: a wasted pass over the array (warning); other cast chains
  (A -> B -> C) are info.
* **host-constant capture** — on the card, a CPU tensor of at least
  ``HOST_CONST_BYTES`` fed to an op on the card inside the step (an H2D
  copy among them) is an error: a host table uploaded every step.  The
  batch's staged upload happens in ``batches()``, outside the step.  On
  the CPU the record says the check does not apply.
* **collectives outside shard_map** — any ``torch.distributed`` (c10d)
  op in a trace is an error: the port's single-controller ``NodeMesh``
  does its collectives as plain ops, and a process-group collective in a
  one-process step is a bug.
* **donation** — eager PyTorch has no buffer donation (``plan.donate``
  updates the parameters in place instead); the record says so.
* **retrace stability** — two fresh sources bound to the same graph must
  run the same op sequence (hash of op, output dtypes and shapes) and
  the same kernel-launch deltas; anything else is an error (a sweep
  point would not run the step the audit saw).

Each record holds the op count, the sequence hash, the kernel launches
by kernel, the mesh collectives by name and the host syncs of the step,
counted twice:

* ``host_syncs``, by op (on either device): the ops that read back to
  the host (``_local_scalar_dense``, ``equal``, a device-to-host copy,
  an upload from pageable host memory) or whose output size the host
  must learn from the data (``nonzero``, ``bincount``, ``unique``,
  ``masked_select``, ``repeat_interleave`` without ``output_size``,
  indexing by a boolean mask) — the op list ``sync_op`` names;
* ``host_syncs_measured``, on the card: the synchronizing CUDA calls
  that ``torch.cuda.set_sync_debug_mode("warn")`` reports while the
  step runs, whichever the list names, by op (``bincount`` makes two:
  it reads the input's minimum and maximum back).  PyTorch hands a
  warning raised inside an op to Python when the call from Python
  returns, so each is counted under the op traced last before it.  The debug mode is a prototype that "does not yet detect
  all synchronizing operations" (its own warning), which is why the op
  list stays; an op in one count and not the other is an info finding.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import warnings
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.analysis.findings import Finding

#: host tensors this large fed to a card op inside a step are flagged
HOST_CONST_BYTES = 4096

F64 = frozenset({torch.float64, torch.complex128})

#: ops that make the host wait for the device whatever their arguments:
#: a read back, or an output sized by the data
SYNC_OPS = frozenset({
    "aten._local_scalar_dense", "aten.equal", "aten.nonzero",
    "aten.bincount", "aten.masked_select", "aten._unique",
    "aten._unique2", "aten.unique_dim", "aten.unique_consecutive"})
#: ops that index by their second argument: a boolean mask there is a
#: ``nonzero`` inside the op
MASK_INDEX_OPS = frozenset({"aten.index", "aten.index_put",
                            "aten.index_put_", "aten._index_put_impl_"})
#: what ``set_sync_debug_mode("warn")`` says for each synchronizing call
SYNC_WARNING = "called a synchronizing CUDA operation"
#: where a sync reported before any traced op is counted
BEFORE_OPS = "before any traced op"

#: the NodeMesh collectives (``repro_torch.sharding``), counted by name
MESH_COLLECTIVES = ("psum", "psum_scatter", "all_gather")


# ---------------------------------------------------------------------------
# variant cube (the committed sweep axes)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Variant:
    paradigm: str           # experiment.PARADIGMS name
    kernel: bool            # cfg.use_agg_kernel
    featshard: bool = False  # cfg.feats_layout == "sharded"
    model: str = "graphsage"

    @property
    def name(self) -> str:
        tags = [self.paradigm, "kernel" if self.kernel else "plain"]
        if self.featshard:
            tags.append("featshard")
        if self.model != "graphsage":
            tags.append(self.model)
        return "+".join(tags)


def sweep_variants() -> List[Variant]:
    """Every committed sweep variant: paradigm x {plain, kernel}, plus the
    featshard layout (fullgraph_sharded x kernel) and one gcn point
    covering the kernel's fused self-row epilogue."""
    from repro_torch.core.experiment import PARADIGMS
    vs = [Variant(p, k) for p in PARADIGMS for k in (False, True)]
    vs.append(Variant("fullgraph_sharded", True, featshard=True))
    vs.append(Variant("fullgraph", True, model="gcn"))
    return vs


def audit_graph(n: int = 192, seed: int = 0):
    """Small synthetic graph with the presets' structure: the ops a step
    runs depend on shapes, not on n, so a small n runs the same code."""
    from repro_torch.data.synth import make_preset
    return make_preset("arxiv-like", n=n, seed=seed)


def variant_cfg(graph, v: Variant, base=None):
    """The variant's config: ``base`` (a ``GNNConfig``) with the
    variant's model, kernel switch and table layout, or the reference
    audit's small config."""
    from repro_torch.configs.base import GNNConfig
    layout = "sharded" if v.featshard else "replicated"
    if base is not None:
        return dataclasses.replace(base, model=v.model,
                                   use_agg_kernel=v.kernel,
                                   feats_layout=layout)
    return GNNConfig(
        name="analyze", model=v.model, n_nodes=graph.n,
        feat_dim=graph.feats.shape[1], hidden=16,
        n_classes=graph.n_classes, n_layers=2, fanout=(4, 3),
        batch_size=32, loss="ce", use_agg_kernel=v.kernel,
        feats_layout=layout)


def _make_source(v: Variant, cfg):
    """The variant's source as a sweep builds it."""
    from repro_torch.core.experiment import make_source
    return make_source(v.paradigm, cfg.batch_size, tuple(cfg.fanout))


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def sync_op(name, func, args, kwargs, ins, outs) -> bool:
    """Whether the op ``name`` makes the host wait for the device on the
    card: a ``SYNC_OPS`` name, a device-to-host copy (not a non-blocking
    one into pinned memory), an upload from pageable host memory,
    ``repeat_interleave`` of tensor repeats without ``output_size``, or
    indexing by a boolean mask."""
    if name in SYNC_OPS:
        return True
    if name in ("aten._to_copy", "aten.copy_"):
        # _to_copy(src, ...) -> out; copy_(dst, src, non_blocking)
        src = args[1] if name == "aten.copy_" else args[0]
        dst = outs[0]
        blocking = not (kwargs.get("non_blocking")
                        or (name == "aten.copy_" and len(args) > 2
                            and args[2]))
        if src.device.type == "cuda" and dst.device.type == "cpu":
            return blocking or not dst.is_pinned()     # a read back
        return (src.device.type == "cpu" and dst.device.type == "cuda"
                and not src.is_pinned())     # an upload from pageable
    if name == "aten.repeat_interleave":
        return (func._overloadname != "self_int"
                and kwargs.get("output_size") is None)
    if name in MASK_INDEX_OPS and len(args) > 1:
        return any(isinstance(t, torch.Tensor) and t.dtype == torch.bool
                   for t in tree_leaves(args[1]))
    return False


class OpTrace(TorchDispatchMode):
    """Every aten op run inside it, with what the hazard walk needs:
    ``ops`` (name, output dtypes, output shapes), ``round_trips`` and
    ``chains`` (casts of a cast's direct output), ``f64`` (float64
    outputs by op), ``host_inputs`` (card ops fed a CPU tensor of
    ``HOST_CONST_BYTES`` or more), ``collectives`` (c10d ops) and
    ``syncs`` (the ops ``sync_op`` names, by name).  With
    ``measure_syncs`` (the card), ``measured_syncs`` counts the
    synchronizing CUDA calls the sync debug mode reports inside the
    block, by the op traced last before each was reported."""

    def __init__(self, measure_syncs: bool = False):
        super().__init__()
        self.measure_syncs = measure_syncs
        self.measured_syncs: Dict[str, int] = collections.Counter()
        self._last_op = BEFORE_OPS
        self._warnings = None
        self._sync_mode = None
        self.ops: List[Tuple[str, Tuple[str, ...], Tuple]] = []
        self.round_trips: List[str] = []
        self.chains: List[str] = []
        self.f64: Dict[str, int] = collections.Counter()
        self.host_inputs: List[str] = []
        self.collectives: Dict[str, int] = collections.Counter()
        self.syncs: Dict[str, int] = collections.Counter()
        # id(cast output) -> (weakref to it, the dtype it was cast from)
        self._cast_src: Dict[int, Tuple[Any, torch.dtype]] = {}

    def __enter__(self):
        if self.measure_syncs:
            self._warnings = warnings.catch_warnings()
            self._warnings.__enter__()
            shown = warnings.showwarning

            def count(message, category, *a, **kw):
                if SYNC_WARNING in str(message):
                    self.measured_syncs[self._last_op] += 1
                else:
                    shown(message, category, *a, **kw)
            warnings.showwarning = count
            warnings.filterwarnings("always", message=f".*{SYNC_WARNING}")
            warnings.filterwarnings(
                "ignore", message="Synchronization debug mode is a "
                                  "prototype")
            self._sync_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            if self.measure_syncs:
                torch.cuda.set_sync_debug_mode(self._sync_mode)
                self._warnings.__exit__(*exc)

    def _cast_source(self, t: torch.Tensor) -> Optional[torch.dtype]:
        hit = self._cast_src.get(id(t))
        if hit is not None and hit[0]() is t:
            return hit[1]
        return None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = f"{func.namespace}.{func._overloadpacket.__name__}"
        self._last_op = name
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        self.ops.append((name, tuple(str(t.dtype) for t in outs),
                         tuple(tuple(t.shape) for t in outs)))
        if func.namespace in ("c10d", "_c10d_functional"):
            self.collectives[name] += 1
        if sync_op(name, func, args, kwargs, ins, outs):
            self.syncs[name] += 1
        for t in outs:
            if t.dtype in F64:
                self.f64[name] += 1
        on_card = any(t.device.type == "cuda" for t in ins + outs)
        if on_card:
            for t in ins:
                if t.device.type == "cpu" and _nbytes(t) >= HOST_CONST_BYTES:
                    self.host_inputs.append(
                        f"{name} {tuple(t.shape)} {t.dtype} "
                        f"({_nbytes(t)} B)")
        if name == "aten._to_copy" and ins and outs \
                and ins[0].dtype != outs[0].dtype:
            src = ins[0].dtype
            prev = self._cast_source(ins[0])
            if prev is not None:
                hop = f"{prev} -> {src} -> {outs[0].dtype}"
                (self.round_trips if outs[0].dtype == prev
                 else self.chains).append(hop)
            o = outs[0]
            self._cast_src[id(o)] = (weakref.ref(o), src)
        return out

    def digest(self) -> str:
        return hashlib.sha256(repr(self.ops).encode()).hexdigest()[:16]


def launch_counts() -> Dict[str, int]:
    """Every kernel counter of the port, by kernel."""
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.kernels.neighbor_agg import featshard
    from repro_torch.kernels.neighbor_agg import ops as na_ops
    out = {f"neighbor_agg.{k}": v for k, v in na_ops.launch_counts().items()}
    out.update({f"featshard.{k}": v
                for k, v in featshard.launch_counts().items()})
    out.update({f"flash_attn.{k}": v
                for k, v in fa_ops.launch_counts().items()})
    return out


@contextlib.contextmanager
def counted_mesh_collectives(counts: Dict[str, int]):
    """Count the calls of ``repro_torch.sharding``'s collectives by name
    inside the block (the module's functions wrapped, then restored)."""
    from repro_torch import sharding as sh
    saved = {n: getattr(sh, n) for n in MESH_COLLECTIVES}

    def wrap(n, fn):
        def counted(*a, **kw):
            counts[n] = counts.get(n, 0) + 1
            return fn(*a, **kw)
        return counted
    try:
        for n, fn in saved.items():
            setattr(sh, n, wrap(n, fn))
        yield counts
    finally:
        for n, fn in saved.items():
            setattr(sh, n, fn)


def traced(fn, *args, device="cpu"):
    """-> (fn(*args), the OpTrace, kernel-launch deltas, mesh collective
    counts), the device synchronised before the launch counts are read.
    On a ``device`` of type cuda the trace also measures the syncs."""
    on_card = torch.device(device).type == "cuda"
    before = launch_counts()
    coll: Dict[str, int] = {}
    with counted_mesh_collectives(coll), OpTrace(on_card) as tr:
        out = fn(*args)
    if on_card:
        torch.cuda.synchronize()
    after = launch_counts()
    deltas = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    return out, tr, deltas, coll


def walk_hazards(tr: OpTrace, site: str, device) -> List[Finding]:
    """The per-trace hazard checks shared by step / eval / inference."""
    out: List[Finding] = []
    for name, cnt in sorted(tr.f64.items()):
        out.append(Finding(
            "trace", "error", site,
            f"{cnt} output(s) of {name} are float64 — implicit widening; "
            f"the hot path is f32/bf16 by design"))
    if tr.round_trips:
        out.append(Finding(
            "trace", "warning", site,
            f"{len(tr.round_trips)} cast round trip(s) on a cast's direct "
            f"output ({tr.round_trips[0]}) — each one is a wasted pass "
            f"over the array"))
    if tr.chains:
        out.append(Finding(
            "trace", "info", site,
            f"{len(tr.chains)} chained cast pair(s) ({tr.chains[0]}) that "
            f"could collapse to one cast"))
    for name, cnt in sorted(tr.collectives.items()):
        out.append(Finding(
            "trace", "error", site,
            f"process-group collective '{name}' appears {cnt}x in a "
            f"one-process step — the NodeMesh does its collectives as "
            f"plain ops"))
    if tr.measure_syncs and set(tr.measured_syncs) != set(tr.syncs):
        out.append(Finding(
            "trace", "info", site,
            f"the sync debug mode reports syncs in "
            f"{dict(tr.measured_syncs)}, the op list names "
            f"{dict(tr.syncs)}"))
    if torch.device(device).type == "cuda" and tr.host_inputs:
        out.append(Finding(
            "trace", "error", site,
            f"{len(tr.host_inputs)} host tensor(s) of >= "
            f"{HOST_CONST_BYTES} B fed to card ops inside the step (first: "
            f"{tr.host_inputs[0]}) — a host table uploaded every call"))
    return out


def _record(site: str, tr: OpTrace, deltas, coll, device) -> Dict:
    on_card = torch.device(device).type == "cuda"
    return {"variant": site, "device": str(device), "n_ops": len(tr.ops),
            "op_hash": tr.digest(), "kernel_launches": dict(deltas),
            "host_syncs": dict(tr.syncs),
            "host_syncs_measured": (dict(tr.measured_syncs) if on_card
                                    else "not measured on the CPU"),
            "mesh_collectives": dict(coll),
            "host_constants": (len(tr.host_inputs) if on_card else
                               "not applicable on the CPU (no upload)"),
            "donation": "not applicable: eager PyTorch has no buffer "
                        "donation (plan.donate updates in place)"}


# ---------------------------------------------------------------------------
# per-variant audit
# ---------------------------------------------------------------------------

def _trace_step(graph, v: Variant, cfg, plan, device):
    """Bind a fresh source through a ``Trainer``, draw its first batch and
    trace one ``Trainer._step``.  -> (trace, launch deltas, collectives)."""
    from repro_torch.core import engine as E
    trainer = E.Trainer(graph, cfg, plan, source=_make_source(v, cfg),
                        callbacks=[], device=device)
    try:
        params = trainer._initial_params()
        opt_state = trainer.opt.init(params)
        batch, _ = next(trainer.source.batches())
        _, tr, deltas, coll = traced(trainer._step, params, opt_state,
                                     batch, device=device)
        trainer.source.done(batch)
        return tr, deltas, coll
    finally:
        trainer.close()


def audit_variant(graph, v: Variant, device="cuda", cfg=None, plan=None
                  ) -> Tuple[List[Finding], Dict]:
    """Trace one step of the variant twice (a fresh source each time) and
    run the hazard walks.  ``cfg``: a base config for the variant (see
    ``variant_cfg``).  -> (findings, record)."""
    from repro_torch.core import engine as E
    if plan is None:
        plan = E.TrainPlan(lr=0.1, n_iters=4, eval_every=1 << 30)
    cfg = variant_cfg(graph, v, cfg)
    site = f"variant:{v.name}"
    tr1, d1, c1 = _trace_step(graph, v, cfg, plan, device)
    tr2, d2, _ = _trace_step(graph, v, cfg, plan, device)
    findings = walk_hazards(tr1, site, device)
    rec = _record(site, tr1, d1, c1, device)
    rec["retrace_stable"] = tr1.digest() == tr2.digest() and d1 == d2
    if tr1.digest() != tr2.digest():
        findings.append(Finding(
            "trace", "error", site,
            f"a second fresh source ran a different op sequence "
            f"({tr1.digest()} != {tr2.digest()}, {len(tr1.ops)} vs "
            f"{len(tr2.ops)} ops) — a sweep point would not run the step "
            f"audited"))
    if d1 != d2:
        findings.append(Finding(
            "trace", "error", site,
            f"a second fresh source launched other kernels ({d1} != "
            f"{d2})"))
    return findings, rec


def audit_eval(graph, v: Variant, device="cuda"
               ) -> Tuple[List[Finding], Dict]:
    """Trace the eval the Trainer runs at ``eval_every`` (full-graph
    accuracy over the validation split) for the variant's source."""
    from repro_torch.core import engine as E
    cfg = variant_cfg(graph, v)
    plan = E.TrainPlan(lr=0.1, n_iters=4, eval_every=1 << 30)
    site = f"eval:{v.name}"
    trainer = E.Trainer(graph, cfg, plan, source=_make_source(v, cfg),
                        callbacks=[], device=device)
    try:
        params = trainer._initial_params()
        val = trainer.source.node_split("val")
        _, tr, deltas, coll = traced(trainer._eval_dev, params, val,
                                     device=device)
    finally:
        trainer.close()
    return walk_hazards(tr, site, device), _record(site, tr, deltas, coll,
                                                   device)


def audit_inference(graph, device="cuda"
                    ) -> Tuple[List[Finding], List[Dict]]:
    """Trace one chunk of the layer-wise inference (the serving tier's
    hot path), plain and through the kernel."""
    from repro_torch.core import engine as E
    from repro_torch.core import gnn as G
    from repro_torch.core import inference as I
    findings: List[Finding] = []
    recs: List[Dict] = []
    idx, w, w_self, feats, _ = E._device_ell(graph, None, device)
    c = min(64, graph.n)
    for kernel in (False, True):
        v = Variant("fullgraph", kernel)
        vcfg = variant_cfg(graph, v)
        params = G.init_gnn(torch.Generator().manual_seed(0), vcfg,
                            graph.feats.shape[1], device=device)
        site = f"inference:chunk+{'kernel' if kernel else 'plain'}"
        rows = torch.arange(c, dtype=torch.int32, device=device)

        def chunk_step():
            with torch.no_grad():
                src, src_agg = I._layer_sources(vcfg, params[0], feats)
                return I._chunk_apply(vcfg, False, params[0], feats, src,
                                      src_agg, rows, idx[:c], w[:c],
                                      w_self[:c])
        _, tr, deltas, coll = traced(chunk_step, device=device)
        findings += walk_hazards(tr, site, device)
        recs.append(_record(site, tr, deltas, coll, device))
    return findings, recs


def audit_traces(n: int = 192, device="cuda"
                 ) -> Tuple[List[Finding], List[Dict]]:
    """The full trace audit on ``audit_graph(n)``: every sweep variant's
    step, the shared eval and the inference chunk."""
    graph = audit_graph(n=n)
    findings: List[Finding] = []
    records: List[Dict] = []
    for v in sweep_variants():
        f, r = audit_variant(graph, v, device)
        findings += f
        records.append(r)
    # eval: one replicated and one sharded (featshard) trace cover the
    # (mesh, feats_plan) dispatch of the one eval function
    for v in (Variant("fullgraph", True),
              Variant("fullgraph_sharded", True, featshard=True)):
        f, r = audit_eval(graph, v, device)
        findings += f
        records.append(r)
    f, rs = audit_inference(graph, device)
    return findings + f, records + rs
