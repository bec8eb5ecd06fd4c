"""Unified training engine on one GPU: one ``Trainer``, pluggable batch
sources and callbacks (torch counterpart of the reference
``repro.core.engine``).  Full-graph training IS mini-batch training at
the (b=n, β=d_max) limit, so both paradigms run through the same loop
and differ only in their ``BatchSource``:

- ``FullGraphSource`` — GD over all training nodes on the device ELL;
- ``SampledSource``   — (b, β) fan-out trees from the numpy CSR sampler,
  staged by a background ``Prefetcher`` into pinned host buffers and
  copied to the card asynchronously.

How the reference's throughput knobs map (PyTorch runs eagerly, so
there is no compiled step to cache):

- ``TrainPlan.donate`` → the optimizer writes parameters and state IN
  PLACE under ``torch.no_grad()`` (``_guarded_update``);
- ``TrainPlan.deferred_sync`` → the host reads record ``i - 1``
  (``.item()``) only after step ``i`` has been dispatched, so the card
  never waits for the host between steps;
- the reference's ``_cached_step`` has no counterpart (a CUDA graph of
  the step is later work).

The non-finite guard is an on-device ``isfinite`` reduction plus a
``torch.where`` select, with no host sync.  ``BadStepPolicy`` takes
``raise`` and ``skip``; rollback, checkpoints (``ckpt_every``) and
``resume_from`` belong to slice 3 and raise ``NotImplementedError``.
Likewise the cluster, importance-sampled and sharded sources.

Initial parameters: the reference draws them from
``jax.random.key(plan.seed)``, which torch cannot replay, so a
``Trainer`` takes carried-across parameters (``params=``, e.g. the
reference's ``init_gnn`` as numpy) and otherwise draws
``init_gnn(torch.Generator().manual_seed(plan.seed))``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable as TCallable, List, Optional, Sequence, \
    Tuple

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.core import gnn as G
from repro_torch.core.graph import Graph, to_ell
from repro_torch.core.metrics import History
from repro_torch.core.prefetch import HostStagingRing, Prefetcher
from repro_torch.core.sampler import FanoutBatch, sample_batch
from repro_torch.device import resolve_device

SLICE3 = "ROADMAP.md Queue 1, slice 3"


# ---------------------------------------------------------------------------
# Device-side helpers (memoized per graph)
# ---------------------------------------------------------------------------

def _resolve_max_deg(graph: Graph, max_deg: Optional[int]) -> int:
    """ELL width for an optional cap (an explicit 0 is an error, not
    "uncapped")."""
    if max_deg is None:
        return graph.d_max
    if max_deg < 1:
        raise ValueError(f"max_deg must be >= 1 (or None for "
                         f"d_max={graph.d_max}), got {max_deg}")
    return int(max_deg)


def _graph_cache(graph: Graph) -> dict:
    cache = getattr(graph, "_torch_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(graph, "_torch_cache", cache)
    return cache


def drop_device_cache(graph: Graph) -> None:
    """Forget the device uploads memoized on ``graph`` (ELL, its reverse
    index, features, labels, node splits), so their memory can be
    freed."""
    object.__setattr__(graph, "_torch_cache", {})


def _device_ell(graph: Graph, max_deg: Optional[int], device):
    """``(idx, w, w_self, feats, labels)`` on ``device``, memoized on the
    graph.  At most one ELL width stays resident per device besides the
    width-independent feature and label uploads; another width evicts it
    together with its reverse index."""
    dev = torch.device(device)
    key = ("ell", str(dev), _resolve_max_deg(graph, max_deg))
    base = ("base", str(dev))
    cache = _graph_cache(graph)
    if base not in cache:
        cache[base] = (torch.as_tensor(graph.feats).to(dev),
                       torch.as_tensor(graph.labels).long().to(dev))
    if key not in cache:
        for stale in [k for k in cache
                      if k[0] in ("ell", "rev") and k[1] == str(dev)]:
            del cache[stale]
        cache[key] = tuple(torch.as_tensor(a).to(dev)
                           for a in to_ell(graph, max_deg=max_deg))
    return cache[key] + cache[base]


def _device_reverse_index(graph: Graph, max_deg: Optional[int], device):
    """The reverse index (``ops.ReverseIndex``) of the device ELL of this
    width, built on ``device`` from that ELL's ``idx`` and ``w`` and
    memoized beside it."""
    from repro_torch.kernels.neighbor_agg.ops import build_reverse_index
    idx, w = _device_ell(graph, max_deg, device)[:2]
    key = ("rev", str(torch.device(device)), _resolve_max_deg(graph, max_deg))
    cache = _graph_cache(graph)
    if key not in cache:
        cache[key] = build_reverse_index(idx, w, graph.n)
    return cache[key]


def _device_nodes(graph: Graph, which: str, device):
    """Device copy (int64) of a node split, uploaded once per graph."""
    key = ("nodes", str(torch.device(device)), which)
    cache = _graph_cache(graph)
    if key not in cache:
        cache[key] = torch.as_tensor(
            getattr(graph, f"{which}_nodes")).long().to(device)
    return cache[key]


def _eval_acc(params, cfg: GNNConfig, ell, nodes):
    """Accuracy over ``nodes`` with ALL neighbors (§4.1), as a device
    scalar (no host sync)."""
    idx, w, w_self, feats, labels = ell
    with torch.no_grad():
        logits = G.full_graph_forward(params, cfg, feats, idx, w, w_self)
        return G.accuracy(logits[nodes], labels[nodes])


def _full_loss(params, cfg: GNNConfig, ell, sel):
    """The full training objective at ``params`` as a device scalar."""
    idx, w, w_self, feats, labels = ell
    with torch.no_grad():
        logits = G.full_graph_forward(params, cfg, feats, idx, w, w_self)
        return G.gnn_loss(logits[sel], labels[sel], cfg.loss, cfg.n_classes)


def evaluate_full(params, cfg: GNNConfig, graph: Graph, ell, nodes
                  ) -> float:
    """Full-neighborhood accuracy of ``params`` on ``nodes`` (§4.1)."""
    dev = ell[0].device
    return float(_eval_acc(params, cfg, ell,
                           torch.as_tensor(np.asarray(nodes)).long().to(dev)))


# ---------------------------------------------------------------------------
# TrainPlan
# ---------------------------------------------------------------------------

class NonFiniteStepError(RuntimeError):
    """A step produced a non-finite loss or gradient and the plan's
    ``BadStepPolicy`` escalated to raise."""

    def __init__(self, it: int, loss: float, consecutive: int):
        super().__init__(
            f"non-finite loss/gradients at iteration {it} "
            f"(loss={loss}, {consecutive} consecutive bad step"
            f"{'s' if consecutive != 1 else ''})")
        self.it = it
        self.loss = loss
        self.consecutive = consecutive


@dataclasses.dataclass(frozen=True)
class BadStepPolicy:
    """What the Trainer does when the step's ``isfinite`` guard trips.

    The guard is always in the step: a bad step leaves params and
    optimizer state UNCHANGED on the card (a ``torch.where`` select), so
    ``"skip"`` is exactly skip-and-resample.

    - ``on_bad="raise"``: abort with ``NonFiniteStepError`` at the first
      bad step (the default).
    - ``on_bad="skip"``: tolerate up to ``max_consecutive`` bad steps in
      a row (History records them in ``bad_steps``), then raise.
    Rollback to a checkpoint belongs to slice 3 and raises
    ``NotImplementedError``."""

    on_bad: str = "raise"            # raise | skip
    max_consecutive: int = 3

    def __post_init__(self):
        if self.on_bad == "rollback":
            raise NotImplementedError(
                f"BadStepPolicy rollback needs checkpoints, which are not "
                f"ported yet ({SLICE3})")
        if self.on_bad not in ("raise", "skip"):
            raise ValueError(f"BadStepPolicy.on_bad must be raise|skip, "
                             f"got {self.on_bad!r}")
        if self.max_consecutive < 1:
            raise ValueError("BadStepPolicy.max_consecutive must be >= 1")


@dataclasses.dataclass(frozen=True)
class TrainPlan:
    """Declarative spec for one training run (reference ``TrainPlan``)."""
    lr: float = 0.3
    n_iters: int = 100
    optimizer: str = "sgd"              # sgd | adamw
    momentum: float = 0.0               # sgd only
    weight_decay: float = 0.0           # adamw only
    schedule: Optional[str] = None      # None/"constant" | "cosine"
    warmup: int = 0
    lr_floor: float = 0.0
    eval_every: int = 10
    track_full_loss_every: int = 0      # mini-batch: full objective cadence
    target_loss: Optional[float] = None  # stop when batch loss <= target
    target_acc: Optional[float] = None   # stop when val acc >= target
    ckpt_every: int = 0                 # > 0 is slice 3: raises
    seed: int = 0
    donate: bool = True                 # in-place optimizer update
    deferred_sync: bool = True          # lag the host read one step
    bad_steps: BadStepPolicy = BadStepPolicy()

    def make_schedule(self):
        if self.schedule in (None, "constant"):
            return self.lr
        if self.schedule == "cosine":
            from repro_torch.optim import cosine_schedule
            return cosine_schedule(self.lr, self.warmup, self.n_iters,
                                   floor=self.lr_floor)
        raise ValueError(f"unknown schedule {self.schedule!r}")

    def make_optimizer(self):
        from repro_torch.optim import adamw, sgd
        lr = self.make_schedule()
        if self.optimizer == "sgd":
            return sgd(lr, momentum=self.momentum)
        if self.optimizer == "adamw":
            return adamw(lr, weight_decay=self.weight_decay)
        raise ValueError(f"unknown optimizer {self.optimizer!r}; "
                         "repro_torch.optim has: sgd, adamw")


def _deferred_mode(plan: TrainPlan) -> bool:
    """The lagged host read needs the loss on the host only one step
    late; stop targets need it at once."""
    return (plan.deferred_sync and plan.target_loss is None
            and plan.target_acc is None)


def _tree_leaves(tree) -> List[torch.Tensor]:
    """Tensors of a nest of dicts and lists, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in tree for x in _tree_leaves(tree[k])]
    return [x for v in tree for x in _tree_leaves(v)]


def _guarded_update(opt, params, opt_state, loss, grads, inplace: bool):
    """The optimizer update behind the non-finite guard: ``good`` is an
    on-device ``isfinite`` reduction over the loss and every gradient,
    and a bad step keeps the old values (``torch.where``).  With
    ``inplace`` (``TrainPlan.donate``) the new values are written into
    the existing parameter and state tensors.  Returns
    (params, opt_state, good)."""
    with torch.no_grad():
        good = torch.isfinite(loss)
        for g in _tree_leaves(grads):
            good = good & torch.all(torch.isfinite(g))
        new_p, new_s = opt.update(grads, opt_state, params)
        if inplace:
            for tree, new in ((params, new_p), (opt_state, new_s)):
                for old, nv in zip(_tree_leaves(tree), _tree_leaves(new)):
                    old.copy_(torch.where(good, nv, old))
            return params, opt_state, good

        def sel(new, old):
            if isinstance(new, torch.Tensor):
                return torch.where(good, new, old)
            if isinstance(new, dict):
                return {k: sel(new[k], old[k]) for k in new}
            return [sel(n, o) for n, o in zip(new, old)]

        params = [{k: v.requires_grad_() for k, v in p.items()}
                  for p in sel(new_p, params)]
        return params, sel(new_s, opt_state), good


# ---------------------------------------------------------------------------
# Batch sources
# ---------------------------------------------------------------------------

class BatchSource:
    """Where batches come from + how the training loss is computed on one.

    ``bind`` attaches graph/cfg/plan/device and uploads whatever is
    constant across iterations; ``batches`` yields ``(device_batch,
    n_nodes)``; ``loss(params, batch)`` is differentiated by the
    Trainer.  ``done(batch)`` is called once the step consuming the batch
    has completed (a host sync point), so sources may recycle staging
    buffers.  ``close()`` is idempotent."""

    #: the per-iteration training loss already IS the full objective
    loss_is_full_loss = False
    name = "source"

    def bind(self, graph: Graph, cfg: GNNConfig, plan: TrainPlan,
             device) -> "BatchSource":
        raise NotImplementedError

    def loss(self, params, batch):
        raise NotImplementedError

    def node_split(self, which: str):
        return _device_nodes(self.graph, which, self.device)

    def batches(self):
        raise NotImplementedError

    def done(self, batch) -> None:
        pass

    def close(self) -> None:
        pass


class FullGraphSource(BatchSource):
    """The (b=n_train, β=d_max) limit: every iteration is GD over ALL
    training nodes on the device ELL; the "batch" is empty.  With
    ``cfg.use_agg_kernel`` it also holds the ELL's reverse index, so the
    aggregation's backward is the reverse-index kernel."""

    loss_is_full_loss = True
    name = "fullgraph"

    def __init__(self, max_deg: Optional[int] = None):
        self.max_deg = max_deg
        self.ell = None
        self.rev = None

    def bind(self, graph, cfg, plan, device):
        self.graph, self.cfg, self.device = graph, cfg, device
        self.ell = _device_ell(graph, self.max_deg, device)
        self.rev = (_device_reverse_index(graph, self.max_deg, device)
                    if cfg.use_agg_kernel else None)
        self.train_nodes = self.node_split("train")
        self.n_nodes = len(graph.train_nodes)
        return self

    def loss(self, params, batch):
        idx, w, w_self, feats, labels = self.ell
        logits = G.full_graph_forward(params, self.cfg, feats, idx, w,
                                      w_self, rev=self.rev)
        sel = self.train_nodes
        return G.gnn_loss(logits[sel], labels[sel], self.cfg.loss,
                          self.cfg.n_classes)

    def batches(self):
        while True:
            yield None, self.n_nodes

    def close(self) -> None:
        self.ell = self.rev = None


class SampledSource(BatchSource):
    """The paper's mini-batch paradigm: per-iteration (b, β) fan-out
    trees from the vectorized CSR sampler, produced ahead of the device
    step by a background ``Prefetcher`` (or inline with
    ``prefetch=False``; both draw the same sequence from
    ``np.random.default_rng(plan.seed)``).

    Host batches are gathered straight into recycled ``HostStagingRing``
    buffers — pinned on the card, so the upload is an asynchronous copy —
    and a slot is released in ``done`` only after the CUDA event behind
    its copy has completed.  Batches of a graph with fewer training
    nodes than ``batch_size`` are padded with masked-out rows (a validity
    column), so every batch has one shape.

    ``timing`` accumulates, per run: ``sample_s`` and ``stage_s`` (host
    sampling and gather/staging, on the worker thread when prefetching;
    ``stage_each_s`` lists the staging time of each batch, whose first
    uses of a ring slot also allocate its pinned buffers),
    ``wait_s`` (the training loop blocked on the next batch) and, on the
    card, ``h2d_ms`` (CUDA-event time of the batch copies)."""

    name = "minibatch"
    depth = 2                            # Prefetcher queue bound

    def __init__(self, batch_size: Optional[int] = None,
                 fanouts: Optional[Sequence[int]] = None,
                 prefetch: bool = True):
        self.batch_size = batch_size
        self.fanouts = tuple(fanouts) if fanouts is not None else None
        self.prefetch = prefetch
        self._pf: Optional[Prefetcher] = None
        self._ring: Optional[HostStagingRing] = None
        self._inflight: List[Tuple[int, Any]] = []  # (slot, copy events)

    def bind(self, graph, cfg, plan, device):
        self.graph, self.cfg, self.device = graph, cfg, device
        n_train = len(graph.train_nodes)
        if n_train == 0:
            raise ValueError(
                f"{type(self).__name__}: graph has no training nodes "
                f"(train_mask selects 0 of {graph.n}) — nothing to sample")
        self.b_request = self.b = self.batch_size or cfg.batch_size
        if self.b < 1:
            raise ValueError(f"{type(self).__name__}: batch_size must be "
                             f">= 1, got {self.b}")
        self.fanouts = self.fanouts or tuple(cfg.fanout)
        assert len(self.fanouts) == cfg.n_layers
        self.n_iters = plan.n_iters
        self.seed = plan.seed
        self.pad = max(0, self.b - n_train)
        self._inflight = []
        self.timing = {"sample_s": 0.0, "stage_s": 0.0, "wait_s": 0.0,
                       "h2d_ms": 0.0, "batches": 0, "stage_each_s": []}
        # queue depth + the batch on the card + the one being staged
        # (+ one more when the host read lags a step)
        extra = 1 if _deferred_mode(plan) else 0
        self._ring = HostStagingRing(
            self.depth + 2 + extra,
            pin_memory=torch.device(device).type == "cuda")
        return self

    def loss(self, params, batch):
        feats, masks, weights, self_w, labels, *rest = batch
        valid = rest[0] if rest else None
        logits = G.minibatch_forward(params, self.cfg, feats, masks,
                                     weights, self_w)
        return G.gnn_loss(logits, labels, self.cfg.loss, self.cfg.n_classes,
                          valid=valid)

    # -- host-side batch assembly --------------------------------------
    def _pad_batch(self, fb: FanoutBatch) -> FanoutBatch:
        """Pad the target axis up to ``self.b`` with masked-out rows."""
        p = self.b - fb.batch_size
        if p <= 0:
            return fb

        def padrow(a):
            return np.pad(a, [(0, p)] + [(0, 0)] * (a.ndim - 1))

        return FanoutBatch(
            nodes=[padrow(x) for x in fb.nodes],
            masks=[padrow(m) for m in fb.masks],
            weights=[padrow(w) for w in fb.weights],
            self_w=[padrow(s) for s in fb.self_w],
            labels=padrow(fb.labels),
            target_w=(padrow(fb.target_w)
                      if fb.target_w is not None else None))

    def _sample(self, rng, graph, batch_size, fanouts) -> FanoutBatch:
        t0 = time.perf_counter()
        fb = sample_batch(rng, graph, batch_size, fanouts)
        self.timing["sample_s"] += time.perf_counter() - t0
        return fb

    def _extra_cols(self, fb: FanoutBatch, valid_n: int) -> Tuple:
        """Columns appended after ``labels`` (the validity column of a
        padded batch)."""
        if not self.pad:
            return ()
        valid = np.zeros(self.b, np.float32)
        valid[:valid_n] = 1.0
        return (valid,)

    def _host_batch(self, graph, fb):
        """``(slot, host arrays in batch order)`` for one batch.  Runs on
        the Prefetcher's worker thread when prefetching."""
        t0 = time.perf_counter()
        try:
            return self._stage(graph, fb)
        finally:
            dt = time.perf_counter() - t0
            self.timing["stage_s"] += dt
            self.timing["stage_each_s"].append(dt)

    def _stage(self, graph, fb):
        valid_n = fb.batch_size
        fb = self._pad_batch(fb)
        extra = tuple(self._extra_cols(fb, valid_n))
        fd = graph.feats.shape[1]
        specs = ([(ids.shape + (fd,), graph.feats.dtype)
                  for ids in fb.nodes]
                 + [(m.shape, np.float32) for m in fb.masks]
                 + [(w.shape, w.dtype) for w in fb.weights]
                 + [(s.shape, s.dtype) for s in fb.self_w]
                 + [(fb.labels.shape, fb.labels.dtype)]
                 + [(v.shape, v.dtype) for v in extra])
        slot = self._ring.acquire()
        try:
            bufs = iter(self._ring.buffers(slot, specs))
            feats = []
            for ids in fb.nodes:      # gather straight into the buffer
                buf = next(bufs)
                np.take(graph.feats, ids.reshape(-1), axis=0,
                        out=buf.reshape(-1, fd))
                feats.append(buf)
            masks = []
            for m in fb.masks:        # in-place bool -> f32 cast
                buf = next(bufs)
                np.copyto(buf, m, casting="unsafe")
                masks.append(buf)
            small = []
            for arrs in (fb.weights, fb.self_w):
                out = []
                for a in arrs:
                    buf = next(bufs)
                    np.copyto(buf, a)
                    out.append(buf)
                small.append(out)
            labels = next(bufs)
            np.copyto(labels, fb.labels)
            tail = []
            for v in extra:
                buf = next(bufs)
                np.copyto(buf, v)
                tail.append(buf)
        except BaseException:
            # a worker dying mid-batch must not strand its staging slot
            self._ring.release(slot)
            raise
        return slot, (feats, masks, small[0], small[1], labels) \
            + tuple(tail)

    def _to_device(self, payload):
        """The batch as device tensors: the slot's own (pinned) tensors
        are copied with ``non_blocking`` and the slot joins an in-flight
        FIFO that ``done`` releases once the copy's event has completed;
        on the CPU the tensors alias the slot."""
        slot, host = payload
        feats, masks, weights, self_w, labels, *extra = host
        flat = iter(self._ring.tensors(slot))
        tgroups = [[next(flat) for _ in g]
                   for g in (feats, masks, weights, self_w, [labels], extra)]
        events = None
        if torch.device(self.device).type == "cuda":
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
            tgroups = [[t.to(self.device, non_blocking=True) for t in g]
                       for g in tgroups]
            events[1].record()
        self._inflight.append((slot, events))
        f, m, w, s, (lab,), ext = tgroups
        return (f, m, w, s, lab) + tuple(ext)

    def batches(self):
        if self.prefetch:
            self._pf = Prefetcher(self.graph, self.b_request, self.fanouts,
                                  seed=self.seed, depth=self.depth,
                                  n_batches=self.n_iters,
                                  payload_fn=self._host_batch,
                                  sample_fn=self._sample)
            try:
                for _ in range(self.n_iters):
                    t0 = time.perf_counter()
                    fb, payload = self._pf.next()
                    self.timing["wait_s"] += time.perf_counter() - t0
                    self.timing["batches"] += 1
                    yield self._to_device(payload), fb.batch_size
            finally:
                self.close()
        else:
            rng = np.random.default_rng(self.seed)
            for _ in range(self.n_iters):
                t0 = time.perf_counter()
                fb = self._sample(rng, self.graph, self.b_request,
                                  self.fanouts)
                payload = self._host_batch(self.graph, fb)
                self.timing["wait_s"] += time.perf_counter() - t0
                self.timing["batches"] += 1
                yield self._to_device(payload), fb.batch_size

    def done(self, batch) -> None:
        if self._inflight:
            slot, events = self._inflight.pop(0)
            if events is not None:
                events[1].synchronize()       # the copy, not the launch
                self.timing["h2d_ms"] += events[0].elapsed_time(events[1])
            self._ring.release(slot)

    def close(self) -> None:
        # idempotent: the Trainer's finally and batches()' finally both
        # land here
        if self._ring is not None:
            self._ring.close()     # wakes a worker blocked in acquire()
        if self._pf is not None:
            pf, self._pf = self._pf, None
            pf.close()


# ---------------------------------------------------------------------------
# Callbacks
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    """Mutable loop state handed to every callback hook."""
    graph: Graph
    cfg: GNNConfig
    plan: TrainPlan
    source: BatchSource
    history: History
    it: int = -1                      # current iteration (0-based)
    params: Any = None
    opt_state: Any = None
    loss: float = float("nan")        # this iteration's training loss
    val_acc: Optional[float] = None   # this iteration's eval (None = none)
    full_loss: Optional[float] = None  # precomputed tracked full loss
    n_nodes: int = 0                  # target nodes in this batch
    full_loss_fn: Optional[TCallable] = None   # params -> full objective
    stop: bool = False
    stop_reason: Optional[str] = None
    step_bad: bool = False            # this step tripped the guard

    def request_stop(self, reason: str) -> None:
        if not self.stop:
            self.stop, self.stop_reason = True, reason


class Callback:
    """Hooks fire in list order; ``on_eval`` only on eval iterations,
    ``on_stop`` once when any callback requested a stop.  With
    ``plan.donate`` the next step updates ``state.params`` in place: a
    hook that keeps them past its return must clone them."""

    def on_train_start(self, state: TrainState) -> None: ...

    def on_step(self, state: TrainState) -> None: ...

    def on_eval(self, state: TrainState) -> None: ...

    def on_stop(self, state: TrainState) -> None: ...

    def on_train_end(self, state: TrainState) -> None: ...


class HistoryCallback(Callback):
    """Per-iteration History rows plus full-objective tracking (every
    iteration for full-graph GD, every ``track_full_loss_every`` for
    mini-batch; the Trainer dispatches the tracked value with the step,
    ``state.full_loss``)."""

    def on_train_start(self, state):
        state.history.start()

    def on_step(self, state):
        state.history.record(state.loss, state.val_acc,
                             nodes=state.n_nodes)
        if state.step_bad:
            state.history.bad_steps.append(state.it + 1)
        if state.source.loss_is_full_loss:
            state.history.full_losses.append(state.loss)
            state.history.full_loss_iters.append(state.it + 1)
        elif (state.plan.track_full_loss_every
              and state.it % state.plan.track_full_loss_every == 0):
            fl = (state.full_loss if state.full_loss is not None
                  else float(state.full_loss_fn(state.params)))
            state.history.full_losses.append(fl)
            state.history.full_loss_iters.append(state.it + 1)


class EarlyStop(Callback):
    """Stop when the batch loss <= target_loss (checked every step,
    after recording) or val acc >= target_acc (on eval iterations)."""

    def on_step(self, state):
        tl = state.plan.target_loss
        if tl is not None and state.loss <= tl:
            state.request_stop(f"target_loss<={tl}")

    def on_eval(self, state):
        ta = state.plan.target_acc
        if ta is not None and state.val_acc is not None \
                and state.val_acc >= ta:
            state.request_stop(f"target_acc>={ta}")


def default_callbacks(plan: TrainPlan) -> List[Callback]:
    return [HistoryCallback(), EarlyStop()]


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainResult:
    params: list
    history: History
    final_test_acc: float
    stop_reason: Optional[str] = None


class Trainer:
    """The single training engine both paradigms run through.

    Per iteration: the step (loss, ``torch.autograd.grad``, guarded
    optimizer update) -> periodic full-neighborhood eval -> ``on_step``
    callbacks -> ``on_eval`` on eval iterations -> stop when a callback
    asked.  With ``plan.deferred_sync`` the host reads each record one
    iteration late.  ``params`` carries initial parameters across (a
    list of per-layer dicts of numpy arrays); ``device`` is where
    the run lives (``cuda`` unless the caller asks for the CPU)."""

    def __init__(self, graph: Graph, cfg: GNNConfig, plan: TrainPlan,
                 source: Optional[BatchSource] = None,
                 callbacks: Optional[Sequence[Callback]] = None,
                 extra_callbacks: Sequence[Callback] = (),
                 params: Optional[Sequence[dict]] = None,
                 device="cuda"):
        if plan.ckpt_every:
            raise NotImplementedError(
                f"TrainPlan.ckpt_every={plan.ckpt_every}: checkpoints are "
                f"not ported yet ({SLICE3})")
        self.device = resolve_device(device)
        self.graph, self.cfg, self.plan = graph, cfg, plan
        self.source = (source or SampledSource()).bind(graph, cfg, plan,
                                                       self.device)
        self.callbacks = (list(callbacks) if callbacks is not None
                          else default_callbacks(plan))
        self.callbacks += list(extra_callbacks)
        self._consec_bad = 0
        self.opt = plan.make_optimizer()
        self._init_params = params
        # eval and full-loss tracking reuse the source's ELL when it has
        # one (a capped max_deg evaluates on the same adjacency)
        self._ell = (getattr(self.source, "ell", None)
                     or _device_ell(graph, None, self.device))

    # ------------------------------------------------------------------
    def _initial_params(self):
        if self._init_params is None:
            params = G.init_gnn(torch.Generator().manual_seed(self.plan.seed),
                                self.cfg, self.graph.feats.shape[1],
                                device=self.device)
        else:
            params = G.params_from_numpy(self._init_params, self.device)
        for v in _tree_leaves(params):
            v.requires_grad_()
        return params

    def _step(self, params, opt_state, batch):
        leaves = _tree_leaves(params)
        loss = self.source.loss(params, batch)
        flat = torch.autograd.grad(loss, leaves, allow_unused=True)
        flat = iter([torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, flat)])
        grads = [{k: next(flat) for k in p} for p in params]
        params, opt_state, good = _guarded_update(
            self.opt, params, opt_state, loss.detach(), grads,
            inplace=self.plan.donate)
        return params, opt_state, loss.detach(), good

    def _eval_dev(self, params, nodes):
        return _eval_acc(params, self.cfg, self._ell, nodes)

    def _full_loss_dev(self, params):
        return _full_loss(params, self.cfg, self._ell,
                          self.source.node_split("train"))

    def evaluate(self, params, nodes) -> float:
        if not isinstance(nodes, torch.Tensor):
            nodes = torch.as_tensor(np.asarray(nodes)).long()
        return float(self._eval_dev(params, nodes.to(self.device)))

    def close(self) -> None:
        """Release the device references this Trainer holds."""
        self._ell = None
        self.source.close()

    def _fire(self, hook: str, state: TrainState) -> None:
        for cb in self.callbacks:
            getattr(cb, hook)(state)

    # ------------------------------------------------------------------
    def _consume(self, rec, state: TrainState) -> None:
        """Read one step record back to the host and fire its callbacks."""
        it, loss, val, fl, n_nodes, batch, good = rec
        state.it = it
        state.loss = float(loss)           # host sync: step finished
        state.step_bad = not bool(good)
        self._consec_bad = self._consec_bad + 1 if state.step_bad else 0
        state.val_acc = float(val) if val is not None else None
        state.full_loss = float(fl) if fl is not None else None
        state.n_nodes = n_nodes
        self.source.done(batch)            # staging slot recyclable
        self._fire("on_step", state)
        if state.val_acc is not None:
            self._fire("on_eval", state)
        if state.step_bad:
            pol = self.plan.bad_steps
            if pol.on_bad == "raise" or self._consec_bad >= \
                    pol.max_consecutive:
                raise NonFiniteStepError(state.it, state.loss,
                                         self._consec_bad)

    def run(self, resume_from: Optional[str] = None) -> TrainResult:
        if resume_from is not None:
            raise NotImplementedError(
                f"Trainer.run(resume_from=...): exact resume is not "
                f"ported yet ({SLICE3})")
        graph, cfg, plan = self.graph, self.cfg, self.plan
        params = self._initial_params()
        opt_state = self.opt.init(params)
        state = TrainState(graph=graph, cfg=cfg, plan=plan,
                           source=self.source, history=History(),
                           params=params, opt_state=opt_state,
                           full_loss_fn=self._full_loss_dev)
        self._fire("on_train_start", state)
        deferred = _deferred_mode(plan)
        track = plan.track_full_loss_every
        track_full = track and not self.source.loss_is_full_loss
        pending = None
        try:
            val_sel = self.source.node_split("val")
            stream = self.source.batches()
            for it in range(plan.n_iters):
                batch, n_nodes = next(stream)
                params, opt_state, loss, good = self._step(
                    params, opt_state, batch)
                # eval / tracked full loss are dispatched here as device
                # scalars; the floats are read in _consume
                val = (self._eval_dev(params, val_sel)
                       if it % plan.eval_every == 0 else None)
                fl = (self._full_loss_dev(params)
                      if track_full and it % track == 0 else None)
                rec = (it, loss, val, fl, n_nodes, batch, good)
                state.params, state.opt_state = params, opt_state
                if deferred:
                    # lagged read: record i-1 while step i is in flight
                    prev, pending = pending, rec
                    if prev is not None:
                        self._consume(prev, state)
                else:
                    self._consume(rec, state)
                if state.stop:
                    break
            if pending is not None:
                # drain the lagged record so History matches the params
                self._consume(pending, state)
            if state.stop:
                self._fire("on_stop", state)
            acc = self.evaluate(params, self.source.node_split("test"))
            state.params = params
            self._fire("on_train_end", state)
        finally:
            self.source.close()
        return TrainResult(params, state.history, acc, state.stop_reason)
