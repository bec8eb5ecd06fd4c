"""Unified training engine on one GPU: one ``Trainer``, pluggable batch
sources and callbacks (torch counterpart of the reference
``repro.core.engine``).  Full-graph training IS mini-batch training at
the (b=n, β=d_max) limit, so both paradigms run through the same loop
and differ only in their ``BatchSource``:

- ``FullGraphSource`` — GD over all training nodes on the device ELL;
- ``SampledSource``   — (b, β) fan-out trees from the numpy CSR sampler,
  staged by a background ``Prefetcher`` into pinned host buffers and
  copied to the card asynchronously;
- ``ImportanceSampledSource`` — score-weighted targets drawn with
  replacement, each row's loss weighted by 1/(n_train·p) (unbiased);
- ``ClusterSource``   — Cluster-GCN: unions of BFS partitions
  (``core.partition``) as block-diagonal batch ELLs, on the full-graph
  forward;
- ``ShardedFullGraphSource`` / ``ShardedSampledSource`` — the same two
  paradigms with their rows laid out over the NODES shards of a
  ``sharding.NodeMesh`` (single-controller: one process drives every
  shard, and a mesh may repeat one card).  With ``cfg.use_agg_kernel``
  the aggregation runs once per shard (``ops.neighbor_agg_sharded`` /
  ``neighbor_agg_batch_sharded``), and under ``cfg.feats_layout ==
  "sharded"`` the full-graph table is row-sharded with a hot cache
  (``featshard``).  The dense parts (``h @ W``, the loss) run on the
  run's device, whole.  On a process-group mesh
  (``sharding.process_node_mesh``, one process a shard) each rank holds
  only its own rows of the ELL, features and labels, runs the dense
  parts on them, and the Trainer all-reduces the loss and the
  gradients; host decisions that could differ between ranks (a bad
  step, a stop, an evaluation) are agreed before they are acted on, and
  rank 0 alone writes checkpoints.

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
``raise``, ``skip`` and ``rollback`` (to the newest checkpoint).  With
``TrainPlan.ckpt_every`` every save is an exact-resume snapshot
(``save_trainer_state``: parameters, optimizer state, the source's
stream position and rng, History), and ``Trainer.run(resume_from=)``
continues a stopped run bit-for-bit.

Initial parameters: the reference draws them from
``jax.random.key(plan.seed)``, which torch cannot replay, so a
``Trainer`` takes carried-across parameters (``params=``, e.g. the
reference's ``init_gnn`` as numpy) and otherwise draws
``init_gnn(torch.Generator().manual_seed(plan.seed))``
(``initial_params``).  It hands the same parameters to its source at
``bind``: ``ImportanceSampledSource(scores="grad")`` scores with them.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from typing import Any, Callable as TCallable, List, Optional, Sequence, \
    Tuple

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.core import gnn as G
from repro_torch.core.graph import Graph, to_ell
from repro_torch.core.metrics import History
from repro_torch.core.prefetch import HostStagingRing, Prefetcher
from repro_torch.core.sampler import FanoutBatch, expand_batch, \
    sample_batch
from repro_torch.device import resolve_device


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
    index, features, labels, node splits) and the cluster partitions, so
    their memory can be freed."""
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


def _sharded_ell(graph: Graph, max_deg: Optional[int], device, mesh):
    """``(idx, w, w_self, feats, labels)`` on ``device`` with rows padded
    by zero-weight rows up to a multiple of ``mesh``'s shards (reference
    ``ShardedFullGraphSource.bind``), memoized on the graph: one
    resident width and mesh per device, evicted with its reverse index
    and featshard plan."""
    from repro_torch import sharding as sh
    dev = torch.device(device)
    key = ("sharded_ell", str(dev), _mesh_key(mesh),
           _resolve_max_deg(graph, max_deg))
    cache = _graph_cache(graph)
    if key not in cache:
        for stale in [k for k in cache if k[0] in (
                "sharded_ell", "sharded_rev", "featshard") and
                k[1] == str(dev)]:
            del cache[stale]
        idx, w, w_self = to_ell(graph, max_deg=max_deg)
        arrs = (idx, w, w_self, graph.feats, graph.labels)
        if mesh.rank_local:
            # the reference's row layout: rank r uploads only its block
            blocks = [sh.rank_block(a, mesh) for a in arrs]
        else:
            blocks = [sh.pad_rows(a, mesh.size) for a in arrs]
        blocks[4] = blocks[4].astype(np.int64)
        cache[key] = tuple(torch.as_tensor(a).to(dev) for a in blocks)
    return cache[key]


def _mesh_key(mesh):
    """What the device caches key a mesh by: its devices, and for a
    process-group mesh its rank and size too."""
    return (mesh.devices, mesh.traced, mesh.size)


def _sharded_reverse_index(graph: Graph, max_deg: Optional[int], device,
                           mesh):
    """The per-shard reverse indexes (``ops.ShardedReverseIndex``) of the
    padded sharded ELL, built on the shards' devices and memoized beside
    it."""
    from repro_torch.kernels.neighbor_agg.ops import \
        build_sharded_reverse_index
    idx, w = _sharded_ell(graph, max_deg, device, mesh)[:2]
    key = ("sharded_rev", str(torch.device(device)), _mesh_key(mesh),
           _resolve_max_deg(graph, max_deg))
    cache = _graph_cache(graph)
    if key not in cache:
        # a rank holds its own rows; its index spans the whole table
        n_pad = idx.shape[0] * (mesh.size if mesh.rank_local else 1)
        cache[key] = build_sharded_reverse_index(idx, w, n_pad, mesh)
    return cache[key]


def _source_mesh(mesh, device):
    """The mesh of a sharded source: ``mesh`` when given, else
    ``node_mesh()`` (every visible card) for a CUDA run and the run's
    own device alone otherwise."""
    from repro_torch import sharding as sh
    dev = torch.device(device)
    if mesh is None:
        mesh = (sh.node_mesh() if dev.type == "cuda"
                else sh.node_mesh(devices=(dev,)))
    if mesh.device_type != dev.type:
        raise ValueError(f"the mesh {mesh} and the run's device {dev} are "
                         f"of different types")
    if mesh.rank_local and mesh.devices[0] != dev:
        raise ValueError(f"the process-group mesh {mesh} runs this rank on "
                         f"{mesh.devices[0]}, the run's device is {dev}")
    return mesh


def _local_nodes(nodes, mesh, m: int):
    """Of the global node ids ``nodes`` (a device tensor), the ones this
    rank of a process-group mesh holds, as local row ids into its ``m``
    rows (``nodes`` itself on any other mesh)."""
    if mesh is None or not mesh.rank_local:
        return nodes
    loc = nodes - mesh.rank * m
    return loc[(loc >= 0) & (loc < m)]


def _eval_acc(params, cfg: GNNConfig, ell, nodes, mesh=None,
              feats_plan=None):
    """Accuracy over ``nodes`` with ALL neighbors (§4.1), as a device
    scalar (no host sync).  ``mesh`` / ``feats_plan``: the sharded
    sources' (see ``full_graph_forward``); on a process-group mesh
    ``ell`` is this rank's rows and the counts are all-reduced."""
    from repro_torch import sharding as sh
    idx, w, w_self, feats, labels = ell
    with torch.no_grad():
        logits = G.full_graph_forward(params, cfg, feats, idx, w, w_self,
                                      mesh=mesh, feats_plan=feats_plan)
        loc = _local_nodes(nodes, mesh, idx.shape[0])
        denom = sh.mean_denom(mesh, nodes.numel())
        if denom is None:
            return G.accuracy(logits[loc], labels[loc])
        # the ranks' hit counts, summed exactly, over the global count
        hits = (torch.argmax(logits[loc], -1) == labels[loc]).float().sum()
        return sh.psum([hits], mesh)[0] / denom


def _full_loss(params, cfg: GNNConfig, ell, sel, mesh=None,
               feats_plan=None):
    """The full training objective at ``params`` as a device scalar."""
    from repro_torch import sharding as sh
    idx, w, w_self, feats, labels = ell
    with torch.no_grad():
        logits = G.full_graph_forward(params, cfg, feats, idx, w, w_self,
                                      mesh=mesh, feats_plan=feats_plan)
        loc = _local_nodes(sel, mesh, idx.shape[0])
        denom = sh.mean_denom(mesh, sel.numel())
        loss = G.gnn_loss(logits[loc], labels[loc], cfg.loss, cfg.n_classes,
                          denom=denom)
        return loss if denom is None else sh.psum([loss], mesh)[0]


def evaluate_full(params, cfg: GNNConfig, graph: Graph, ell, nodes,
                  mesh=None, feats_plan=None) -> float:
    """Full-neighborhood accuracy of ``params`` on ``nodes`` (§4.1);
    ``mesh`` / ``feats_plan`` partition the kernel path as the sharded
    sources do (``feats_plan`` needs that source's padded ``ell``)."""
    dev = ell[0].device
    return float(_eval_acc(params, cfg, ell,
                           torch.as_tensor(np.asarray(nodes)).long().to(dev),
                           mesh, feats_plan))


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
      a row (History records them in ``bad_steps``), then ``escalate``
      ("raise", or "rollback" when checkpointing is on).
    - ``on_bad="rollback"``: skip until ``max_consecutive`` consecutive
      bad steps, then restore params and optimizer state from the newest
      checkpoint and continue with fresh batches; more than
      ``max_rollbacks`` restores abort.  Requires ``ckpt_every > 0``
      (checked when the Trainer is built)."""

    on_bad: str = "raise"            # raise | skip | rollback
    max_consecutive: int = 3         # skip/rollback escalation threshold
    escalate: str = "raise"          # skip's escalation: raise | rollback
    max_rollbacks: int = 3

    def __post_init__(self):
        if self.on_bad not in ("raise", "skip", "rollback"):
            raise ValueError(f"BadStepPolicy.on_bad must be raise|skip|"
                             f"rollback, got {self.on_bad!r}")
        if self.escalate not in ("raise", "rollback"):
            raise ValueError(f"BadStepPolicy.escalate must be raise|"
                             f"rollback, got {self.escalate!r}")
        if self.max_consecutive < 1:
            raise ValueError("BadStepPolicy.max_consecutive must be >= 1")

    def needs_ckpt(self) -> bool:
        return (self.on_bad == "rollback"
                or (self.on_bad == "skip" and self.escalate == "rollback"))


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
    ckpt_every: int = 0                 # exact-resume snapshot cadence
    ckpt_dir: str = "experiments/ckpt"
    seed: int = 0
    donate: bool = True                 # in-place optimizer update
    deferred_sync: bool = True          # lag the host read one step
    ckpt_keep_last: int = 0             # checkpoint retention (0 = all)
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
    late; stop targets and the checkpoint cadence need it at once (a save
    at iteration ``it`` must hold that step's parameters, not the next
    one's)."""
    return (plan.deferred_sync and plan.target_loss is None
            and plan.target_acc is None and plan.ckpt_every == 0)


def initial_params(graph: Graph, cfg: GNNConfig, plan: TrainPlan,
                   params: Optional[Sequence[dict]], device):
    """A run's initial parameters on ``device``: ``params`` (per-layer
    dicts of arrays, e.g. the reference's ``init_gnn`` as numpy) when
    given, else ``init_gnn`` drawn from ``plan.seed`` on the CPU."""
    if params is None:
        return G.init_gnn(torch.Generator().manual_seed(plan.seed), cfg,
                          graph.feats.shape[1], device=device)
    return G.params_from_numpy(params, device)


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


def _copy_into(dst, src) -> None:
    """Write the leaves of ``src`` into the tensors of ``dst`` (the same
    structure) in place: restored parameters and state land in the live
    tensors the step updates."""
    with torch.no_grad():
        for d, v in zip(_tree_leaves(dst), _tree_leaves(src)):
            d.copy_(v)


# ---------------------------------------------------------------------------
# Batch sources
# ---------------------------------------------------------------------------

class BatchSource:
    """Where batches come from + how the training loss is computed on one.

    ``bind`` attaches graph/cfg/plan/device and uploads whatever is
    constant across iterations (``params``: the run's initial
    parameters, for sources that score with them); ``batches`` yields
    ``(device_batch, n_nodes)``; ``loss(params, batch)`` is
    differentiated by the Trainer.  ``done(batch)`` is called once the
    step consuming the batch has completed (a host sync point), so
    sources may recycle staging buffers.  ``close()`` is idempotent."""

    #: the per-iteration training loss already IS the full objective
    loss_is_full_loss = False
    name = "source"
    #: the sharded sources' NODES mesh and featshard plan (set at bind)
    _mesh = None
    feats_plan = None
    #: what divides the loss's row sum: None takes the rows' mean; a
    #: process-group mesh's rank takes its share of the global mean
    #: (``sharding.mean_denom``)
    _loss_denom = None

    def bind(self, graph: Graph, cfg: GNNConfig, plan: TrainPlan,
             device, params: Optional[Sequence[dict]] = None
             ) -> "BatchSource":
        raise NotImplementedError

    def loss(self, params, batch):
        raise NotImplementedError

    def node_split(self, which: str):
        return _device_nodes(self.graph, which, self.device)

    def kernel_mesh(self):
        """The NODES mesh the forward splits its rows over: the source's
        mesh on the kernel path, and a process-group mesh on either path
        (its rows are resident by rank); else None."""
        if self._mesh is None or not (self.cfg.use_agg_kernel
                                      or self._mesh.rank_local):
            return None
        return self._mesh

    def batches(self):
        raise NotImplementedError

    def done(self, batch) -> None:
        pass

    def close(self) -> None:
        pass

    # -- exact-resume hooks --------------------------------------------
    def state_dict(self) -> dict:
        """JSON-serializable batch-stream position, saved inside every
        exact-resume checkpoint (sampled sources: consumed count + the
        rng bit-generator state after the last consumed draw).  Sources
        whose batches are constant across iterations have none."""
        return {}

    def load_state_dict(self, sd: dict) -> None:
        """Restore the stream position saved by ``state_dict`` (called
        between ``bind`` and ``batches`` on resume)."""
        if sd:
            raise ValueError(f"{type(self).__name__} has no stream state "
                             f"to restore, got keys {sorted(sd)}")


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

    def bind(self, graph, cfg, plan, device, params=None):
        self.graph, self.cfg, self.device = graph, cfg, device
        self.ell = _device_ell(graph, self.max_deg, device)
        self.rev = (_device_reverse_index(graph, self.max_deg, device)
                    if cfg.use_agg_kernel else None)
        self.train_nodes = self._loss_rows = self.node_split("train")
        self.n_nodes = len(graph.train_nodes)
        return self

    def loss(self, params, batch):
        idx, w, w_self, feats, labels = self.ell
        logits = G.full_graph_forward(params, self.cfg, feats, idx, w,
                                      w_self, rev=self.rev,
                                      mesh=self.kernel_mesh(),
                                      feats_plan=self.feats_plan)
        sel = self._loss_rows
        return G.gnn_loss(logits[sel], labels[sel], self.cfg.loss,
                          self.cfg.n_classes, denom=self._loss_denom)

    def batches(self):
        while True:
            yield None, self.n_nodes

    def close(self) -> None:
        self.ell = self.rev = None


class ShardedFullGraphSource(FullGraphSource):
    """Full-graph GD with the ELL rows laid out over the NODES shards of
    a ``NodeMesh`` (reference ``ShardedFullGraphSource``): rows are
    padded with zero-weight entries up to a multiple of the shard count,
    and with ``cfg.use_agg_kernel`` each shard's rows run the tiled
    kernel over the whole table and the table's gradient is psum'd (each
    shard's reverse index built once and memoized beside the padded
    ELL).  Under ``cfg.feats_layout == "sharded"`` the table is
    row-sharded instead, through the featshard plan of this (ELL, mesh,
    C), and ``featshard_stats`` holds its bind-time accounting.

    ``mesh=None`` takes every visible card for a CUDA run, the run's
    device alone otherwise.  On one shard the loss sequence is bit-equal
    to ``FullGraphSource``'s.

    On a process-group mesh this rank uploads only its rows of the padded
    ELL, features and labels (reference ``engine.py:569-576``), and its
    loss is the sum over the train nodes it owns divided by the global
    count (the Trainer all-reduces it)."""

    name = "fullgraph_sharded"

    featshard_stats = None

    def __init__(self, max_deg: Optional[int] = None, mesh=None):
        super().__init__(max_deg)
        self.mesh = mesh

    def bind(self, graph, cfg, plan, device, params=None):
        from repro_torch import sharding as sh
        self.graph, self.cfg, self.device = graph, cfg, device
        mesh = self._mesh = _source_mesh(self.mesh, device)
        self.ell = _sharded_ell(graph, self.max_deg, device, mesh)
        #: host seconds of the featshard plan build (0 when memoized)
        self.bind_s = {"featshard_plan": 0.0}
        self.feats_plan = self.featshard_stats = None
        self.rev = None
        if cfg.use_agg_kernel and cfg.feats_layout == "sharded":
            self.feats_plan = self._bind_featshard(graph, cfg, mesh)
        elif cfg.use_agg_kernel:
            self.rev = _sharded_reverse_index(graph, self.max_deg, device,
                                              mesh)
        self.train_nodes = self.node_split("train")
        self.n_nodes = len(graph.train_nodes)
        self._loss_rows = _local_nodes(self.train_nodes, mesh,
                                       self.ell[0].shape[0])
        self._loss_denom = sh.mean_denom(mesh, self.n_nodes)
        return self

    def _bind_featshard(self, graph, cfg, mesh):
        """The featshard plan of this (ELL, mesh, C), memoized on the
        graph beside the padded ELL, and its accounting."""
        from repro_torch.kernels.neighbor_agg import featshard as FS
        key = ("featshard", str(torch.device(self.device)), _mesh_key(mesh),
               _resolve_max_deg(graph, self.max_deg), cfg.feat_cache_rows)
        cache = _graph_cache(graph)
        if key not in cache:
            t0 = time.perf_counter()
            idx_h, w_h, _ = to_ell(graph, max_deg=self.max_deg)
            cache[key] = FS.plan_for(idx_h, w_h, graph.degrees, mesh,
                                     cfg.feat_cache_rows)
            self.bind_s["featshard_plan"] = time.perf_counter() - t0
        fsplan = cache[key]
        self.featshard_stats = fsplan.accounting(
            cfg, graph.feats.shape[1], graph.feats.dtype.itemsize)
        return fsplan


class _StagedSource(BatchSource):
    """A source whose host batches are staged by a background
    ``Prefetcher`` into recycled ``HostStagingRing`` slots — pinned on the
    card, so the upload is an asynchronous copy — and whose slot is
    released in ``done`` only after the CUDA event behind its copy has
    completed.  Holds the stream position for exact resume: batches
    consumed so far and the rng state after the last one's draw.

    ``timing`` accumulates, per run: ``sample_s`` and ``stage_s`` (host
    sampling and gather/staging, on the worker thread when prefetching;
    ``stage_each_s`` lists the staging time of each batch, whose first
    uses of a ring slot also allocate its pinned buffers),
    ``wait_s`` (the training loop blocked on the next batch) and, on the
    card, ``h2d_ms`` (CUDA-event time of the batch copies).  Both threads
    add to it, each addition under ``_timing_lock`` (``_tally``)."""

    depth = 2                            # Prefetcher queue bound

    def _bind_stream(self, graph, cfg, plan, device) -> None:
        self.graph, self.cfg, self.device = graph, cfg, device
        self.n_iters = plan.n_iters
        self.seed = plan.seed
        self._pf: Optional[Prefetcher] = None
        self._inflight: List[Tuple[int, Any]] = []  # (slot, copy events)
        self._consumed = 0               # batches delivered so far
        self._last_rng_state = None      # rng state after last delivery
        self._resume_rng_state = None    # restored position (resume)
        self.timing = {"sample_s": 0.0, "stage_s": 0.0, "wait_s": 0.0,
                       "h2d_ms": 0.0, "batches": 0, "stage_each_s": []}
        self._timing_lock = threading.Lock()
        # queue depth + the batch on the card + the one being staged
        # (+ one more when the host read lags a step)
        extra = 1 if _deferred_mode(plan) else 0
        self._ring = HostStagingRing(
            self.depth + 2 + extra,
            pin_memory=torch.device(device).type == "cuda")

    def _timed_stage(self, stage, *args):
        """``stage(*args)``, its seconds added to the staging timers."""
        t0 = time.perf_counter()
        try:
            return stage(*args)
        finally:
            dt = time.perf_counter() - t0
            self._tally(stage_s=dt, stage_each_s=[dt])

    def _tally(self, **amounts) -> None:
        """Add each amount to its ``timing`` entry (a list entry is
        extended), under the lock: the Prefetcher's worker (sampling,
        staging) and the training loop (waits, batches, copies) both
        add."""
        with self._timing_lock:
            for key, amount in amounts.items():
                self.timing[key] += amount

    def _upload(self, slot: int) -> List[torch.Tensor]:
        """The slot's tensors on the device: copied with ``non_blocking``
        (the slot joins an in-flight FIFO that ``done`` releases once the
        copy's event has completed); on the CPU they alias the slot."""
        tensors = self._ring.tensors(slot)
        events = None
        if torch.device(self.device).type == "cuda":
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
            tensors = [t.to(self.device, non_blocking=True)
                       for t in tensors]
            events[1].record()
        self._inflight.append((slot, events))
        return tensors

    def _prefetched(self, batch_size, fanouts, sample_fn, payload_fn):
        """``(fb, payload)`` pairs for the rest of the run from a
        ``Prefetcher`` resumed at the stream position; counts each
        delivery."""
        remaining = self.n_iters - self._consumed
        self._pf = Prefetcher(self.graph, batch_size, fanouts,
                              seed=self.seed, depth=self.depth,
                              n_batches=remaining, payload_fn=payload_fn,
                              sample_fn=sample_fn,
                              rng_state=self._resume_rng_state)
        try:
            for _ in range(remaining):
                t0 = time.perf_counter()
                fb, payload = self._pf.next()
                self._tally(wait_s=time.perf_counter() - t0, batches=1)
                self._last_rng_state = self._pf.last_rng_state
                self._consumed += 1
                yield fb, payload
        finally:
            self.close()

    def done(self, batch) -> None:
        if self._inflight:
            slot, events = self._inflight.pop(0)
            if events is not None:
                events[1].synchronize()       # the copy, not the launch
                self._tally(h2d_ms=events[0].elapsed_time(events[1]))
            self._ring.release(slot)

    def close(self) -> None:
        # idempotent: the Trainer's finally and batches()' finally both
        # land here
        if self._ring is not None:
            self._ring.close()     # wakes a worker blocked in acquire()
        pf, self._pf = self._pf, None
        if pf is not None:
            pf.close()

    def state_dict(self):
        return {"consumed": self._consumed,
                "rng_state": self._last_rng_state}

    def load_state_dict(self, sd):
        if not sd:
            return
        self._consumed = int(sd["consumed"])
        self._resume_rng_state = sd.get("rng_state")
        if self._consumed and self._resume_rng_state is None:
            raise ValueError(
                f"{type(self).__name__}: checkpoint records "
                f"{self._consumed} consumed batches but no rng state — "
                f"cannot resume the stream exactly")


class SampledSource(_StagedSource):
    """The paper's mini-batch paradigm: per-iteration (b, β) fan-out
    trees from the vectorized CSR sampler, produced ahead of the device
    step by a background ``Prefetcher`` (or inline with
    ``prefetch=False``; both draw the same sequence from
    ``np.random.default_rng(plan.seed)``).

    Host batches are gathered straight into the staging ring's buffers
    (``_StagedSource``).  Batches of a graph with fewer training nodes
    than ``batch_size`` are padded with masked-out rows (a validity
    column), so every batch has one shape."""

    name = "minibatch"

    def __init__(self, batch_size: Optional[int] = None,
                 fanouts: Optional[Sequence[int]] = None,
                 prefetch: bool = True):
        self.batch_size = batch_size
        self.fanouts = tuple(fanouts) if fanouts is not None else None
        self.prefetch = prefetch
        self._pf = None
        self._ring = None

    def bind(self, graph, cfg, plan, device, params=None):
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
        self.pad = max(0, self.b - n_train)
        self._bind_stream(graph, cfg, plan, device)
        return self

    def loss(self, params, batch):
        feats, masks, weights, self_w, labels, *rest = batch
        valid = rest[0] if rest else None
        logits = G.minibatch_forward(params, self.cfg, feats, masks,
                                     weights, self_w,
                                     mesh=self.kernel_mesh())
        return G.gnn_loss(logits, labels, self.cfg.loss, self.cfg.n_classes,
                          valid=valid, denom=self._loss_denom)

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

    def _draw(self, rng, graph, batch_size, fanouts) -> FanoutBatch:
        """How one batch is drawn; subclasses override for non-uniform
        target selection (``batch_size`` is ``b_request``)."""
        return sample_batch(rng, graph, batch_size, fanouts)

    def _sample(self, rng, graph, batch_size, fanouts) -> FanoutBatch:
        t0 = time.perf_counter()
        fb = self._draw(rng, graph, batch_size, fanouts)
        self._tally(sample_s=time.perf_counter() - t0)
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
        return self._timed_stage(self._stage, graph, fb)

    def _stage(self, graph, fb):
        valid_n = fb.batch_size
        fb = self._pad_batch(fb)
        return self._stage_rows(graph, fb, tuple(self._extra_cols(fb,
                                                                  valid_n)))

    def _stage_rows(self, graph, fb, extra):
        """``(slot, host arrays)``: the padded batch ``fb`` and its
        ``extra`` columns gathered into a staging slot."""
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
        """The batch as device tensors, grouped as the host arrays."""
        slot, host = payload
        feats, masks, weights, self_w, labels, *extra = host
        flat = iter(self._upload(slot))
        f, m, w, s, (lab,), ext = [
            [next(flat) for _ in g]
            for g in (feats, masks, weights, self_w, [labels], extra)]
        return (f, m, w, s, lab) + tuple(ext)

    def batches(self):
        # resume-aware: a restored stream starts at batch `_consumed`
        # with the rng fast-forwarded to the checkpointed state
        if self.prefetch:
            for fb, payload in self._prefetched(
                    self.b_request, self.fanouts, self._sample,
                    self._host_batch):
                yield self._to_device(payload), fb.batch_size
            return
        rng = np.random.default_rng(self.seed)
        if self._resume_rng_state is not None:
            rng.bit_generator.state = self._resume_rng_state
        for _ in range(self.n_iters - self._consumed):
            t0 = time.perf_counter()
            fb = self._sample(rng, self.graph, self.b_request, self.fanouts)
            payload = self._host_batch(self.graph, fb)
            self._tally(wait_s=time.perf_counter() - t0, batches=1)
            self._last_rng_state = rng.bit_generator.state
            self._consumed += 1
            yield self._to_device(payload), fb.batch_size


class ShardedSampledSource(SampledSource):
    """Data-parallel mini-batches (reference ``ShardedSampledSource``):
    the batch's target axis is laid out over the NODES shards of a
    ``NodeMesh``.  The host side is ``SampledSource``'s (sampler,
    Prefetcher, staging ring); with ``cfg.use_agg_kernel`` every fan-out
    level runs the tiled kernel once per shard on its own rows
    (``ops.neighbor_agg_batch_sharded``, no collective).

    ``b`` is rounded UP to a multiple of the shard count; the surplus
    rows are masked out (the validity column keeps the loss the unpadded
    mean).  Under ``cfg.feats_layout == "sharded"`` an ``LRURowCache``
    models, on the Prefetcher's worker, which source rows a device cache
    would have served (``feat_cache``; its counters reach
    ``History.counters``).  Exact resume restores the stream and so the
    losses; the LRU model restarts empty, so a resumed run's counters
    cover the resumed part.  On one shard the batches and the loss
    sequence are bit-equal to ``SampledSource``'s.

    On a process-group mesh every rank draws the same whole batch from
    the same seed (so the batches stay the reference's) and stages only
    its own ``b / S`` target rows; its loss is their row sum divided by
    the batch's valid count.  Its evaluations run on its rows of the
    padded full ELL (``ell``)."""

    name = "minibatch_sharded"
    feat_cache = None
    ell = None

    def __init__(self, batch_size: Optional[int] = None,
                 fanouts: Optional[Sequence[int]] = None, mesh=None, **kw):
        super().__init__(batch_size, fanouts, **kw)
        self.mesh = mesh

    def bind(self, graph, cfg, plan, device, params=None):
        from repro_torch import sharding as sh
        super().bind(graph, cfg, plan, device)
        mesh = self._mesh = _source_mesh(self.mesh, device)
        if self.b % mesh.size:           # surplus rows are masked out
            self.b += (-self.b) % mesh.size
        self.pad = max(0, self.b - min(self.b_request,
                                       len(graph.train_nodes)))
        self.feat_cache = None
        if cfg.feats_layout == "sharded":
            from repro_torch.core.featcache import (LRURowCache,
                                                    resolve_cache_rows)
            self.feat_cache = LRURowCache(
                resolve_cache_rows(cfg.feat_cache_rows, graph.n),
                row_bytes=graph.feats.shape[1] * graph.feats.dtype.itemsize)
        self._rows = self.ell = None
        if mesh.rank_local:
            self._rows = sh.rank_rows(self.b, mesh)
            self.ell = _sharded_ell(graph, None, device, mesh)
        # the global mean's share of this rank: b - pad rows are valid
        self._loss_denom = sh.mean_denom(mesh, self.b - self.pad)
        return self

    def _stage(self, graph, fb):
        if self._rows is None:
            return super()._stage(graph, fb)
        valid_n = fb.batch_size
        fb = self._pad_batch(fb)
        lo, hi = self._rows
        extra = self._extra_cols(fb, valid_n)

        def rows(arrs):
            return [a[lo:hi] for a in arrs]
        own = FanoutBatch(nodes=rows(fb.nodes), masks=rows(fb.masks),
                          weights=rows(fb.weights), self_w=rows(fb.self_w),
                          labels=fb.labels[lo:hi], target_w=None)
        return self._stage_rows(graph, own, tuple(rows(extra)))

    def close(self) -> None:
        super().close()
        self.ell = None

    def _host_batch(self, graph, fb):
        if self.feat_cache is not None:
            # one Prefetcher worker (or the loop itself without
            # prefetch) stages every batch in order: no lock needed
            for ids in fb.nodes:
                self.feat_cache.lookup(ids.reshape(-1))
        return super()._host_batch(graph, fb)


class ImportanceSampledSource(SampledSource):
    """Mini-batch SGD with NON-uniform target selection: targets are
    drawn WITH replacement from the training split with probability
    p_j ∝ score_j, and every sampled row carries the loss weight
    w_j = 1 / (n_train · p_j), so the weighted batch mean stays an
    UNBIASED estimator of the full training objective
    (E[1/b Σ w_j ℓ_j] = 1/n Σ ℓ_i) whatever the scores' skew or scale.

    ``scores`` selects the proposal:

    - ``"degree"`` (default): (deg + 1) ** alpha;
    - ``"uniform"``: every training node alike (weights 1);
    - ``"grad"``: per-node gradient norm ‖∂ℓ_i/∂logits_i‖ at the run's
      initial parameters (the ``params`` the Trainer hands to ``bind``,
      or ``initial_params``' draw from the plan's seed): one full-graph
      forward at bind time, through the aggregation kernel when
      ``cfg.use_agg_kernel``;
    - an array of per-node (length n) or per-train-node (length
      n_train) non-negative scores.  Zero scores are floored to a tiny
      positive value: a node with p_j = 0 would never be sampled and the
      estimator would silently drop its loss term.

    Sampling WITH replacement means any ``batch_size`` is valid: b >
    n_train never pads.  Each batch ends with the validity column and
    the row weights, which reach ``gnn_loss(weight=)``."""

    name = "importance"

    def __init__(self, batch_size: Optional[int] = None,
                 fanouts: Optional[Sequence[int]] = None,
                 scores="degree", alpha: float = 1.0, **kw):
        super().__init__(batch_size, fanouts, **kw)
        self.scores = scores
        self.alpha = alpha

    def bind(self, graph, cfg, plan, device, params=None):
        super().bind(graph, cfg, plan, device)
        train = graph.train_nodes
        if isinstance(self.scores, str):
            if self.scores == "degree":
                s = (graph.degrees[train] + 1.0) ** self.alpha
            elif self.scores == "uniform":
                s = np.ones(len(train), np.float64)
            elif self.scores == "grad":
                s = self._grad_norm_scores(graph, cfg, plan, params)
            else:
                raise ValueError(
                    f"ImportanceSampledSource: unknown scores mode "
                    f"{self.scores!r} (have: degree, uniform, grad, or an "
                    f"array)")
        else:
            s = np.asarray(self.scores, np.float64).reshape(-1)
            if s.shape[0] == graph.n:
                s = s[train]
            if s.shape[0] != len(train):
                raise ValueError(
                    f"ImportanceSampledSource: scores must have length "
                    f"n={graph.n} or n_train={len(train)}, got "
                    f"{s.shape[0]}")
        if not np.all(np.isfinite(s)) or (s < 0).any() or s.sum() <= 0:
            raise ValueError(
                "ImportanceSampledSource: scores must be finite, "
                "non-negative, with a positive sum")
        if (s == 0).any():              # p_j = 0 would bias the estimator
            s = np.where(s > 0, s, s[s > 0].min() * 1e-6)
        p = s / s.sum()
        self._p = p
        self._train = train
        # E_p[w] = Σ p_j / (n p_j) = 1: uniform scores give weight 1.0
        self._w = (1.0 / (len(train) * p)).astype(np.float32)
        self.pad = self.b - self.b_request
        return self

    def _grad_norm_scores(self, graph, cfg, plan, params):
        """‖∂ℓ_i/∂logits_i‖ per train node at the initial parameters
        (softmax(z) − onehot for CE, z − onehot for MSE), in float64 on
        the host from the forward's f32 logits."""
        idx, w, w_self, feats, labels = _device_ell(graph, None,
                                                    self.device)
        p0 = initial_params(graph, cfg, plan, params, self.device)
        with torch.no_grad():
            logits = G.full_graph_forward(p0, cfg, feats, idx, w, w_self)
        tr = graph.train_nodes
        lt = logits.float().cpu().numpy()[tr].astype(np.float64)
        onehot = np.zeros_like(lt)
        onehot[np.arange(len(tr)), graph.labels[tr]] = 1.0
        if cfg.loss == "mse":
            g = lt - onehot
        else:
            e = np.exp(lt - lt.max(axis=1, keepdims=True))
            g = e / e.sum(axis=1, keepdims=True) - onehot
        return np.linalg.norm(g, axis=1)

    def _draw(self, rng, graph, batch_size, fanouts):
        sel = rng.choice(len(self._train), size=batch_size, replace=True,
                         p=self._p)
        fb = expand_batch(rng, graph,
                          self._train[sel].astype(np.int32), fanouts)
        fb.target_w = self._w[sel]
        return fb

    def _extra_cols(self, fb, valid_n):
        valid = np.zeros(self.b, np.float32)
        valid[:valid_n] = 1.0
        return (valid, fb.target_w)

    def loss(self, params, batch):
        feats, masks, weights, self_w, labels, valid, row_w = batch
        logits = G.minibatch_forward(params, self.cfg, feats, masks,
                                     weights, self_w)
        return G.gnn_loss(logits, labels, self.cfg.loss, self.cfg.n_classes,
                          valid=valid, weight=row_w)


class ClusterSource(_StagedSource):
    """Cluster-GCN batching: partition once (greedy BFS,
    ``core.partition``), then every iteration trains on the induced
    subgraph of a union of k clusters.  Each cluster's induced ELL block
    is built ONCE at bind and batches assemble block-diagonally
    (cross-cluster edges are dropped — vanilla Cluster-GCN's documented
    approximation).

    The batch is a fixed-shape padded ELL ``[m_max, K]`` (m_max = the k
    largest clusters stacked, K = the widest induced block) plus its
    features, labels and a ``valid`` column (the batch's training rows).
    The loss runs the FULL-GRAPH forward on the batch ELL, masked to
    those rows.  Batches with no training row are rejection-resampled
    from one ordered ``np.random.default_rng(plan.seed)`` stream; the
    choice and the assembly run on a ``Prefetcher`` worker, straight
    into the staging ring (``_StagedSource``).  With
    ``cfg.use_agg_kernel`` each batch's reverse index is built on the
    device (``ops.build_reverse_index``), so the table's gradient comes
    from the reverse-index backward kernel: the batch ELL repeats ids,
    and an atomic sum would land in no fixed order."""

    name = "cluster"

    def __init__(self, batch_size: Optional[int] = None,
                 clusters_per_batch: int = 2,
                 n_parts: Optional[int] = None, partition_seed: int = 0):
        if clusters_per_batch < 1:
            raise ValueError(f"ClusterSource: clusters_per_batch must be "
                             f">= 1, got {clusters_per_batch}")
        if n_parts is not None and n_parts < 1:
            raise ValueError(f"ClusterSource: n_parts must be >= 1, got "
                             f"{n_parts}")
        self.batch_size = batch_size
        self.clusters_per_batch = clusters_per_batch
        self.n_parts = n_parts
        self.partition_seed = partition_seed
        self._pf = None
        self._ring = None

    def bind(self, graph, cfg, plan, device, params=None):
        from repro_torch.core.partition import (bfs_partition,
                                                cluster_ell_blocks)
        self.b = self.batch_size or cfg.batch_size
        k = self.clusters_per_batch
        if self.n_parts is None:
            # expected union size ≈ b: n/P nodes per cluster, k per batch
            n_parts = int(round(graph.n * k / max(self.b, 1)))
        else:
            n_parts = self.n_parts
        n_parts = min(max(n_parts, k), graph.n)
        # the partition and its blocks are host arrays, memoized on the
        # graph beside its device uploads: a sweep's or a resumed run's
        # next bind reuses them
        key = ("partition", n_parts, self.partition_seed)
        cache = _graph_cache(graph)
        #: host seconds of the partition and of the block build (0 when
        #: an earlier bind on this graph built them)
        self.bind_s = {"partition": 0.0, "blocks": 0.0}
        if key not in cache:
            t0 = time.perf_counter()
            part = bfs_partition(graph, n_parts, seed=self.partition_seed)
            t1 = time.perf_counter()
            cache[key] = cluster_ell_blocks(graph, part)
            self.bind_s = {"partition": t1 - t0,
                           "blocks": time.perf_counter() - t1}
        blocks = self.blocks = cache[key]
        self.n_parts_ = len(blocks.clusters)
        self.k = min(k, self.n_parts_)
        self._train_valid = [graph.train_mask[c].astype(np.float32)
                             for c in blocks.clusters]
        self._has_train = np.array([v.sum() > 0 for v in self._train_valid])
        if not self._has_train.any():
            raise ValueError(
                "ClusterSource: no cluster contains a training node "
                f"(n_train={len(graph.train_nodes)}) — nothing to train on")
        self.m_max = int(np.sort(blocks.sizes)[::-1][:self.k].sum())
        self.K = blocks.max_width
        self._labels = [graph.labels[c].astype(np.int32)
                        for c in blocks.clusters]
        self._bind_stream(graph, cfg, plan, device)
        return self

    def loss(self, params, batch):
        idx, w, w_self, feats, labels, valid = batch
        rev = None
        if self.cfg.use_agg_kernel:
            from repro_torch.kernels.neighbor_agg.ops import \
                build_reverse_index
            rev = build_reverse_index(idx, w, idx.shape[0])
        logits = G.full_graph_forward(params, self.cfg, feats, idx, w,
                                      w_self, rev=rev)
        return G.gnn_loss(logits, labels, self.cfg.loss, self.cfg.n_classes,
                          valid=valid)

    def _choose(self, rng, graph, batch_size, fanouts):
        """The clusters of one batch (Prefetcher ``sample_fn``): at least
        one holds a training node."""
        t0 = time.perf_counter()
        train_cluster = int(np.nonzero(self._has_train)[0][0])
        for _ in range(64):          # a batch needs >= 1 training row
            chosen = rng.choice(self.n_parts_, size=self.k, replace=False)
            if self._has_train[chosen].any():
                break
        else:                        # pathological split: force one in
            chosen[0] = train_cluster
        self._tally(sample_s=time.perf_counter() - t0)
        return chosen

    def _assemble(self, graph, chosen):
        """``(slot, n_valid)``: the block-diagonal union of the chosen
        clusters written into a staging slot, padded to ``(m_max, K)``
        (Prefetcher ``payload_fn``, on its worker thread)."""
        fd = graph.feats.shape[1]
        m, kk = self.m_max, self.K
        specs = [((m, kk), np.int32), ((m, kk), np.float32),
                 ((m,), np.float32), ((m, fd), graph.feats.dtype),
                 ((m,), np.int32), ((m,), np.float32)]
        slot = self._ring.acquire()
        try:
            idx, w, w_self, feats, labels, valid = \
                self._ring.buffers(slot, specs)
            for buf in (idx, w, w_self, feats, labels, valid):
                buf.fill(0)
            off = 0
            for ci in chosen:
                bi, bw = self.blocks.idx[ci], self.blocks.w[ci]
                mc, kc = bi.shape
                # local ids -> batch-local ids; padded entries (weight 0)
                # offset too, staying in range for the gather
                idx[off:off + mc, :kc] = bi + off
                w[off:off + mc, :kc] = bw
                w_self[off:off + mc] = self.blocks.w_self[ci]
                np.take(graph.feats, self.blocks.clusters[ci], axis=0,
                        out=feats[off:off + mc])
                labels[off:off + mc] = self._labels[ci]
                valid[off:off + mc] = self._train_valid[ci]
                off += mc
            n_valid = int(valid.sum())
        except BaseException:
            self._ring.release(slot)
            raise
        return slot, n_valid

    def batches(self):
        for _, (slot, n_valid) in self._prefetched(
                self.k, (), self._choose,
                lambda g, chosen: self._timed_stage(self._assemble, g,
                                                    chosen)):
            yield tuple(self._upload(slot)), n_valid


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
    rollback_pending: bool = False    # BadStepPolicy requested a restore

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

    def on_train_end(self, state):
        # feature-shard accounting: the plan's bind-time stats
        # (full-graph) or the host LRU's run totals (sampled) land as
        # run-level counters beside the per-iteration series
        st = getattr(state.source, "featshard_stats", None)
        if st:
            state.history.counters.update(st)
        fc = getattr(state.source, "feat_cache", None)
        if fc is not None:
            state.history.counters.update(fc.stats())


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


def save_trainer_state(state: TrainState, final: bool = False
                       ) -> Optional[str]:
    """One exact-resume snapshot: params + optimizer state in the npz
    (copied to the host now), the engine state (iteration, the source's
    stream position and rng, History) in the step's metadata JSON.
    ``Trainer.run(resume_from=...)`` restores all of it and continues
    bit-for-bit as the run that was not stopped.  On a process-group
    mesh (parameters, state and History are the same on every rank)
    rank 0 writes and every rank waits for the write (None on the
    others)."""
    from repro_torch import sharding as sh
    mesh = state.source._mesh
    if mesh is not None and mesh.rank_local and mesh.rank != 0:
        sh.barrier(mesh)
        return None
    path = _write_trainer_state(state, final)
    sh.barrier(mesh)
    return path


def _write_trainer_state(state: TrainState, final: bool) -> str:
    from repro_torch.checkpoint import save_checkpoint
    meta = {
        "loss": state.loss, "it": state.it, "source": state.source.name,
        "engine_state": {
            "format": 1,
            "it": state.it,
            "seed": state.plan.seed,
            "source": state.source.name,
            "source_state": state.source.state_dict(),
            "history": state.history.to_dict(),
        },
    }
    if final:
        meta["final"] = True
    return save_checkpoint(
        state.plan.ckpt_dir, state.it,
        {"params": state.params, "opt_state": state.opt_state},
        meta, keep_last=state.plan.ckpt_keep_last or None)


class CheckpointCallback(Callback):
    """Periodic exact-resume snapshots (``save_trainer_state``) every
    ``plan.ckpt_every`` iterations (not at iteration 0), and a final one
    at the end of the run."""

    def on_step(self, state):
        every = state.plan.ckpt_every
        if every and state.it and state.it % every == 0:
            save_trainer_state(state)

    def on_train_end(self, state):
        if state.plan.ckpt_every:
            save_trainer_state(state, final=True)


def default_callbacks(plan: TrainPlan) -> List[Callback]:
    cbs: List[Callback] = [HistoryCallback(), EarlyStop()]
    if plan.ckpt_every:
        cbs.append(CheckpointCallback())
    return cbs


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
    callbacks (History, early stop, checkpoint) -> ``on_eval`` on eval
    iterations -> a rollback when the ``BadStepPolicy`` asked -> stop
    when a callback asked.  With ``plan.deferred_sync`` the host reads
    each record one iteration late.  ``params`` carries initial
    parameters across (a list of per-layer dicts of numpy arrays); the
    source gets them at ``bind`` too.  ``device`` is where the run lives
    (``cuda`` unless the caller asks for the CPU)."""

    def __init__(self, graph: Graph, cfg: GNNConfig, plan: TrainPlan,
                 source: Optional[BatchSource] = None,
                 callbacks: Optional[Sequence[Callback]] = None,
                 extra_callbacks: Sequence[Callback] = (),
                 params: Optional[Sequence[dict]] = None,
                 device="cuda"):
        if plan.bad_steps.needs_ckpt() and not plan.ckpt_every:
            raise ValueError(
                "BadStepPolicy escalates to rollback but plan.ckpt_every "
                "is 0 — there would never be a checkpoint to roll back "
                "to; set ckpt_every (and ckpt_dir) or use "
                "on_bad='skip'/'raise'")
        self.device = resolve_device(device)
        self.graph, self.cfg, self.plan = graph, cfg, plan
        self._init_params = params
        self.source = (source or SampledSource()).bind(
            graph, cfg, plan, self.device, params=params)
        self.callbacks = (list(callbacks) if callbacks is not None
                          else default_callbacks(plan))
        self.callbacks += list(extra_callbacks)
        self._consec_bad = 0              # consecutive guard-tripped steps
        self._n_rollbacks = 0
        self.opt = plan.make_optimizer()
        # eval and full-loss tracking reuse the source's ELL when it has
        # one (a capped max_deg evaluates on the same adjacency)
        self._ell = (getattr(self.source, "ell", None)
                     or _device_ell(graph, None, self.device))
        # the sharded sources' kernel path partitions eval and the full
        # loss over their mesh too, and a featshard source's plan (built
        # for its padded ELL, which ``_ell`` then is) row-shards the table
        self._agg_mesh = self.source.kernel_mesh()
        self._feats_plan = self.source.feats_plan
        #: a process-group mesh: gradients and the loss are all-reduced
        #: and host decisions agreed across its ranks
        mesh = self.source._mesh
        self._procs = mesh if mesh is not None and mesh.rank_local else None

    # ------------------------------------------------------------------
    def _initial_params(self):
        params = initial_params(self.graph, self.cfg, self.plan,
                                self._init_params, self.device)
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
        loss = loss.detach()
        if self._procs is not None:
            grads, loss = self._all_reduce(grads, loss)
        params, opt_state, good = _guarded_update(
            self.opt, params, opt_state, loss, grads,
            inplace=self.plan.donate)
        return params, opt_state, loss, good

    def _all_reduce(self, grads, loss):
        """Every rank's gradients and loss share summed over the ranks, in
        one all-reduce of their f32 concatenation, each rounded once to
        its dtype (on one rank: the values themselves)."""
        from repro_torch import sharding as sh
        leaves = _tree_leaves(grads)
        flat = torch.cat([g.reshape(-1).float() for g in leaves]
                         + [loss.reshape(1).float()])
        flat = sh.psum([flat], self._procs)[0]
        out, at = [], 0
        for g in leaves:
            out.append(flat[at:at + g.numel()].view_as(g).to(g.dtype))
            at += g.numel()
        it = iter(out)
        return ([{k: next(it) for k in p} for p in grads],
                flat[at].to(loss.dtype))

    def _eval_dev(self, params, nodes):
        return _eval_acc(params, self.cfg, self._ell, nodes, self._agg_mesh,
                         self._feats_plan)

    def _full_loss_dev(self, params):
        return _full_loss(params, self.cfg, self._ell,
                          self.source.node_split("train"), self._agg_mesh,
                          self._feats_plan)

    def evaluate(self, params, nodes) -> float:
        if not isinstance(nodes, torch.Tensor):
            nodes = torch.as_tensor(np.asarray(nodes)).long()
        return float(self._eval_dev(params, nodes.to(self.device)))

    def close(self) -> None:
        """Release the device references this Trainer holds."""
        self._ell = self._feats_plan = None
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
        if self._procs is not None:
            self._agree(state)
        if state.step_bad:
            self._apply_bad_step_policy(state)

    def _agree(self, state: TrainState) -> None:
        """The ranks' host decisions of one step, summed over the ranks
        before any is acted on: a stop any rank asked for stops all; a
        bad step or an evaluation that not every rank saw is an error."""
        from repro_torch import sharding as sh
        n = self._procs.size
        bad, stop, ev = sh.agree(self._procs, [state.step_bad, state.stop,
                                               state.val_acc is not None])
        if bad not in (0, n) or ev not in (0, n):
            raise RuntimeError(
                f"ranks disagree at iteration {state.it}: {bad:g} of {n} "
                f"saw a bad step, {ev:g} of {n} evaluated")
        if stop and not state.stop:
            state.request_stop("another rank stopped")

    def _apply_bad_step_policy(self, state: TrainState) -> None:
        """A guard-tripped step reached the host.  The guard already made
        it an identity update, so ``skip`` has nothing to undo; after
        ``max_consecutive`` bad steps in a row ``raise`` raises and
        ``rollback`` asks the loop to restore the newest checkpoint."""
        pol = self.plan.bad_steps
        if pol.on_bad == "raise":
            raise NonFiniteStepError(state.it, state.loss,
                                     self._consec_bad)
        if self._consec_bad < pol.max_consecutive:
            return                         # plain skip-and-resample
        escalation = (pol.escalate if pol.on_bad == "skip"
                      else "rollback")
        if escalation == "rollback":
            state.rollback_pending = True
            return
        raise NonFiniteStepError(state.it, state.loss, self._consec_bad)

    def _rollback(self, state: TrainState) -> None:
        """Restore params and optimizer state from the newest checkpoint
        into the live tensors (at most ``max_rollbacks`` times)."""
        from repro_torch.checkpoint import latest_step, restore_checkpoint
        pol = self.plan.bad_steps
        self._n_rollbacks += 1
        if self._n_rollbacks > pol.max_rollbacks:
            raise NonFiniteStepError(state.it, state.loss,
                                     self._consec_bad)
        step = latest_step(self.plan.ckpt_dir)
        if step is None:
            # bad steps piled up before the first checkpoint: nothing to
            # restore, surface the divergence
            raise NonFiniteStepError(state.it, state.loss,
                                     self._consec_bad)
        warnings.warn(
            f"rolling back to checkpoint step {step} after "
            f"{self._consec_bad} consecutive non-finite steps "
            f"(rollback {self._n_rollbacks}/{pol.max_rollbacks})",
            RuntimeWarning, stacklevel=2)
        live = {"params": state.params, "opt_state": state.opt_state}
        _copy_into(live, restore_checkpoint(self.plan.ckpt_dir, live,
                                            step=step))
        self._consec_bad = 0

    def _restore_run_state(self, directory: str, params, opt_state
                           ) -> Tuple[int, History]:
        """Load the newest exact-resume checkpoint of ``directory`` into
        ``params`` and ``opt_state`` (in place) and the source's stream
        position; returns (first iteration to run, History)."""
        from repro_torch.checkpoint import (latest_step, load_metadata,
                                            restore_checkpoint)
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(
                f"resume_from={directory!r}: no completed checkpoints")
        meta = load_metadata(directory, step) or {}
        es = meta.get("engine_state")
        if not es:
            raise ValueError(
                f"checkpoint step {step} in {directory!r} has no "
                f"engine_state — it was not written by the engine's "
                f"CheckpointCallback (params-only checkpoints cannot "
                f"be resumed exactly)")
        if es.get("seed") != self.plan.seed:
            warnings.warn(
                f"resuming a run recorded with seed={es.get('seed')} "
                f"under plan.seed={self.plan.seed}; the continued "
                f"batch stream follows the CHECKPOINT's stream state, "
                f"not the new seed", RuntimeWarning, stacklevel=2)
        live = {"params": params, "opt_state": opt_state}
        _copy_into(live, restore_checkpoint(directory, live, step=step))
        self.source.load_state_dict(es.get("source_state", {}))
        return int(es["it"]) + 1, History.from_dict(es.get("history", {}))

    def run(self, resume_from: Optional[str] = None) -> TrainResult:
        graph, cfg, plan = self.graph, self.cfg, self.plan
        params = self._initial_params()
        opt_state = self.opt.init(params)
        history, start_it = History(), 0
        if resume_from is not None:
            start_it, history = self._restore_run_state(resume_from,
                                                        params, opt_state)
        if self._procs is not None:
            from repro_torch import sharding as sh
            first = sh.agree(self._procs, [start_it])[0]
            if first != start_it * self._procs.size:
                raise RuntimeError(f"ranks resume from different steps "
                                   f"(this rank: {start_it})")
        state = TrainState(graph=graph, cfg=cfg, plan=plan,
                           source=self.source, history=history,
                           params=params, opt_state=opt_state,
                           it=start_it - 1,     # last completed iteration
                           full_loss_fn=self._full_loss_dev)
        if history.losses:
            state.loss = history.losses[-1]
        self._fire("on_train_start", state)
        deferred = _deferred_mode(plan)
        track = plan.track_full_loss_every
        track_full = track and not self.source.loss_is_full_loss
        pending = None
        try:
            val_sel = self.source.node_split("val")
            stream = self.source.batches()
            for it in range(start_it, plan.n_iters):
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
                if state.rollback_pending:
                    # rollback needs ckpt_every > 0, which forces the
                    # synchronous read: the params restored into are this
                    # step's guard-kept values
                    self._rollback(state)
                    state.rollback_pending = False
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
