"""Write-safe cached per-layer embedding tables: versioned snapshots,
a write-ahead update log, and a budgeted refresh scheduler — the torch
counterpart of the reference ``repro.core.embedding_store`` (without its
multi-device feature-sharded build).

``EmbeddingStore`` materializes every layer's [n, d_l] table once (the
layer-wise pass from ``core.inference``) and then keeps them fresh under
point updates without full recomputes.  Invalidation follows the
FORWARD influence cone: a change to node u's layer-(l-1) embedding can
only move layer-l rows that aggregate u — u itself (self-loop) plus the
rows whose ELL lists reference u through a nonzero weight (a scan of
the ELL rows of u's CSR neighbors).  ``refresh()`` therefore re-embeds, per
layer, ``dirty_rows ∪ changed ∪ referencing(changed)`` and carries that
set forward as the next layer's ``changed`` — the k-hop frontier of the
marked nodes, NOT the whole graph.  Re-embeds go through the same
chunk step as the build pass (same chunk padding, same kernel).

Concurrency model:

- **Versioned snapshots** — the serving state is an immutable
  ``TableSnapshot`` (layer tables + a host copy of the final logits +
  a monotonically increasing version), swapped atomically under
  ``_mu``.  ``refresh()``/``build()`` construct the NEXT version off
  the serving path and only publish on success.  torch writes in place,
  so a refresh CLONES each layer table it changes before writing rows
  into it (copy-on-write): a published table is never mutated under a
  live reader.  Publishing is all or nothing: a crash or injected fault
  mid-refresh (failpoints ``store.mid_layer_refresh``,
  ``store.before_swap``) discards the partial version and queries keep
  answering from the old one — no reader can ever observe a torn or
  half-refreshed table.
- **Write-ahead update log** — ``update_features`` / ``add_edges`` /
  ``mark_dirty`` append to the WAL instead of mutating build state, so
  writers never race an in-flight refresh.  Records are applied (graph
  feats / CSR / ELL rows / dirty masks) under ``_refresh_mu``:
  opportunistically right away when no refresh is running (eager
  semantics for single-threaded users), otherwise at
  the next refresh's drain.  Dirty masks are cleared only AFTER a
  successful publish, so an aborted refresh loses no invalidation.
- **Refresh scheduler** — ``start_scheduler()`` runs a daemon thread
  that coalesces pending updates and re-embeds on a budget:
  ``refresh_every_updates`` (count trigger), ``refresh_budget_ms``
  (pacing: at most one scheduled refresh per budget window) and
  ``max_staleness_s`` (proactive refresh at half the SLO bound).
  Transient refresh faults (``faults.TransientRefreshFault``) are
  retried with exponential backoff; any other incremental failure
  degrades to ONE full ``build()`` before surfacing fatal
  (``refresh_with_recovery`` — also used synchronously by
  ``GNNServer`` when the staleness SLO forces a refresh on the batcher
  thread).  ``SimulatedCrash`` is a BaseException and always sails
  through, exactly like a real process death.

Two update channels (tests/test_torch_serving.py validates both
against a from-scratch store on the updated graph):

- ``update_features(nodes, feats)`` / ``mark_dirty(nodes)`` — layer-0
  inputs changed; the ELL is untouched.
- ``add_edges(src, dst)`` — structural: the CSR is rebuilt, and because
  ã weights depend on BOTH endpoint degrees, the re-derived ELL rows are
  the endpoints PLUS every current neighbor of an endpoint (their edge
  weights to the endpoint changed).  Those rows are marked dirty at
  every layer.

``core.serving`` answers classification queries from the current
snapshot via ``predict_meta()`` (host-side argmax over the snapshot's
cached numpy copy — no device work and no refresh on the read path);
``predict()`` keeps the auto-refresh convenience for direct
single-threaded use.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.core import faults
from repro_torch.core.graph import Graph, to_ell
from repro_torch.core.inference import (InferenceRun, _chunk_apply,
                                        _layer_sources, featshard_plan_for,
                                        layerwise_layers)
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TableSnapshot:
    """One immutable, consistent serving state.

    ``layers[l]`` is the layer-(l+1) table the build/refresh that
    published this version produced; ``final_np`` is the host copy of
    ``layers[-1]`` (the logits, read-only) every query slices.
    Snapshots are never mutated after publish — a refresh builds a NEW
    snapshot and swaps the store's pointer, so any reader holding this
    object keeps a consistent view forever."""

    version: int
    layers: Tuple[torch.Tensor, ...]
    final_np: np.ndarray
    published_t: float          # time.monotonic() at publish


class EmbeddingStore:
    """Per-layer embedding cache over a (mutable) graph.

    ``max_deg=None`` keeps full neighborhoods (inference default).
    Tables live on ``device`` (``cuda`` unless the caller passes
    ``"cpu"``).  ``mesh`` (a ``sharding.NodeMesh`` of ``device``'s type)
    splits chunk aggregation over its NODES shards (requires
    ``cfg.use_agg_kernel``); with ``cfg.feats_layout == "sharded"`` the
    full build runs the row-sharded featshard pass instead (no whole
    table per shard), while incremental refreshes keep the chunked path:
    dirty frontiers are small row sets.

    Lock order (never taken in reverse): ``_refresh_mu`` (serializes
    build/refresh/WAL-apply — the only paths that mutate build state)
    then ``_mu`` (short critical sections: WAL append/drain, dirty
    masks, snapshot pointer, counters)."""

    def __init__(self, params, cfg: GNNConfig, graph: Graph, *,
                 chunk_size: int = 1024, max_deg: Optional[int] = None,
                 prefetch: bool = True, device="cuda", mesh=None):
        self.params = params
        self.cfg = cfg
        self.device = resolve_device(device)
        self.graph = graph
        self.max_deg = max_deg
        self.prefetch = prefetch
        self.mesh = mesh
        self.chunk_size = max(1, min(int(chunk_size), graph.n))
        self.idx, self.w, self.w_self = to_ell(graph, max_deg=max_deg)
        self.K = self.idx.shape[1]
        self.feats_plan = featshard_plan_for(
            cfg, graph, (self.idx, self.w, self.w_self), mesh)
        self._replan = False
        # a COPY: on the CPU torch.as_tensor would alias graph.feats,
        # which feature updates write into before the refresh reads them
        self._h0 = torch.tensor(graph.feats, device=self.device)
        self.build_stats: Optional[Dict] = None
        self._dirty_in = np.zeros(graph.n, bool)    # layer-0 inputs moved
        self._dirty_row = np.zeros(graph.n, bool)   # ELL row re-derived
        # -- write-safe serving state --------------------------------
        self._mu = threading.RLock()
        self._refresh_mu = threading.RLock()
        self._snap: Optional[TableSnapshot] = None
        self._version = 0
        self._wal: List[Tuple] = []       # (kind, payload..., t) records
        self._applied_unpublished = 0     # drained but not yet published
        self._dirty_since: Optional[float] = None
        self._counters = {"refreshes": 0, "builds": 0,
                          "transient_retries": 0, "degraded_builds": 0,
                          "sched_refreshes": 0}
        self._last_refresh_error: Optional[BaseException] = None
        self._sched_stop = threading.Event()
        self._sched_cfg: Optional[Dict] = None
        self._sched_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    # snapshot access
    # ------------------------------------------------------------------
    @property
    def layers(self) -> Optional[List[torch.Tensor]]:
        """The current snapshot's layer tables (a fresh list; the store
        never writes into a published table).  ``None`` before the first
        build."""
        with self._mu:
            snap = self._snap
        return None if snap is None else list(snap.layers)

    def snapshot(self) -> Optional[TableSnapshot]:
        """The last consistently published ``TableSnapshot`` (or None
        before the first build).  Safe to hold across updates — it is
        never mutated."""
        with self._mu:
            return self._snap

    @property
    def version(self) -> int:
        """Version of the serving snapshot (0 before the first build)."""
        with self._mu:
            return self._version

    # ------------------------------------------------------------------
    # build
    # ------------------------------------------------------------------
    def build(self) -> InferenceRun:
        """Full layer-wise pass; applies any queued updates first and
        publishes a new snapshot version, resetting all dirty state."""
        with self._refresh_mu:
            self._drain_apply()
            with self._mu:
                self._sync_inputs(self._dirty_in)
            if self._replan:
                self.feats_plan = featshard_plan_for(
                    self.cfg, self.graph, (self.idx, self.w, self.w_self),
                    self.mesh)
                self._replan = False
            run = layerwise_layers(self.params, self.cfg, self._h0,
                                   (self.idx, self.w, self.w_self),
                                   chunk_size=self.chunk_size,
                                   prefetch=self.prefetch,
                                   device=self.device, mesh=self.mesh,
                                   feats_plan=self.feats_plan)
            self._publish(list(run.layers), clear_all=True)
            self.build_stats = run.stats
            with self._mu:
                self._counters["builds"] += 1
            return run

    # ------------------------------------------------------------------
    # write-ahead update log (the writer-facing API)
    # ------------------------------------------------------------------
    def mark_dirty(self, nodes) -> None:
        """Mark nodes whose layer-0 INPUT changed (features already
        written to ``graph.feats``, or changed in place)."""
        nodes = self._node_ids(nodes)
        if nodes.size:
            self._append(("dirty", nodes, time.monotonic()))
            self._try_apply()

    def update_features(self, nodes, feats) -> None:
        """Queue new feature rows; they land in ``graph.feats`` (and the
        dirty mask) when the record is applied — immediately if no
        refresh is running, else at the next refresh's drain.  ``feats``
        broadcasts to ``[len(nodes), feat_dim]``."""
        nodes = self._node_ids(nodes)
        if nodes.size:
            feats = np.array(np.broadcast_to(
                np.asarray(feats, self.graph.feats.dtype),
                (nodes.size,) + self.graph.feats.shape[1:]))
            self._append(("feats", nodes, feats, time.monotonic()))
            self._try_apply()

    def add_edges(self, src: Sequence[int], dst: Sequence[int]) -> None:
        """Queue undirected edges (u, v); duplicates and self-loops are
        dropped.  On apply the CSR is rebuilt and the ELL rows whose
        weights moved (endpoints + every neighbor of an endpoint, since
        ã depends on both endpoint degrees) are re-derived and marked
        dirty."""
        src, dst = self._node_ids(src), self._node_ids(dst)
        if src.size != dst.size:
            raise ValueError(f"add_edges: {src.size} sources against "
                             f"{dst.size} destinations")
        keep = src != dst
        src, dst = src[keep], dst[keep]
        if src.size:
            self._append(("edges", src, dst, time.monotonic()))
            self._try_apply()

    def _node_ids(self, ids) -> np.ndarray:
        """``ids`` as a flat int64 copy, checked to lie in ``[0, n)``
        before a record holding them enters the WAL: a record whose apply
        raises is lost (see ``_drain_apply``), so a bad id fails its own
        writer's call instead."""
        ids = np.array(ids, np.int64, copy=True).ravel()
        if ids.size and (ids.min() < 0 or ids.max() >= self.graph.n):
            raise ValueError(f"node ids must lie in [0, {self.graph.n}); "
                             f"got {ids.min()}..{ids.max()}")
        return ids

    def _append(self, rec: Tuple) -> None:
        with self._mu:
            self._wal.append(rec)
            if self._dirty_since is None:
                self._dirty_since = rec[-1]

    def _try_apply(self) -> None:
        """Opportunistic WAL apply: when no build/refresh is in flight,
        apply queued records right away (eager semantics for
        single-threaded callers); under a concurrent refresh the
        records stay queued for its drain — writers never block."""
        if self._refresh_mu.acquire(blocking=False):
            try:
                self._drain_apply()
            finally:
                self._refresh_mu.release()

    def _drain_apply(self) -> int:
        """Apply every queued WAL record to the mutable build state.
        Serialized with build/refresh via ``_refresh_mu``, so applied
        arrays are never read torn by an in-flight embed.  ``_mu`` is
        held only to read the WAL's head and to retire it: a record stays
        queued, so ``dirty`` and ``pending_updates`` count it, until it
        is applied, and readers (who take ``_mu`` and never read the
        build state) do not wait out an ``add_edges`` CSR rebuild, a
        second at 524,288 nodes.  A record whose apply raises is retired
        and the error raised, as in the reference (which holds ``_mu``
        over the whole drain and pops each record before applying it):
        kept, it would fail every later drain, build and refresh."""
        with self._refresh_mu:
            n = 0
            while True:
                with self._mu:
                    if not self._wal:
                        return n
                    rec = self._wal[0]      # writers only append
                try:
                    if rec[0] == "feats":
                        self._apply_feats(rec[1], rec[2])
                    elif rec[0] == "edges":
                        self._apply_edges(rec[1], rec[2])
                    else:
                        self._apply_dirty(rec[1])
                except BaseException:
                    with self._mu:
                        self._wal.pop(0)
                    raise
                with self._mu:
                    self._wal.pop(0)
                    self._applied_unpublished += 1
                n += 1

    def _apply_dirty(self, nodes: np.ndarray) -> None:
        with self._mu:
            self._dirty_in[nodes] = True

    def _apply_feats(self, nodes: np.ndarray, feats: np.ndarray) -> None:
        with self._mu:
            self.graph.feats[nodes] = feats
            self._dirty_in[nodes] = True

    def _apply_edges(self, src: np.ndarray, dst: np.ndarray) -> None:
        """The new CSR and the re-derived ELL rows, built under
        ``_refresh_mu`` alone (the build state is read under it only);
        ``_mu`` is taken for the swap, where the dirty rows are set."""
        g = self.graph
        old_a = np.repeat(np.arange(g.n, dtype=np.int64), np.diff(g.indptr))
        old_b = g.indices.astype(np.int64)
        a = np.concatenate([old_a, src, dst])
        b = np.concatenate([old_b, dst, src])
        # dedupe + sort by (row, col): the reference's np.unique, as a
        # sort and a neighbor compare (on an H100 machine's host, with
        # numpy 2.3.5, the apply took 52 s with np.unique over the 15M
        # edges of a 524,288-node graph, 1 s with the sort)
        eid = np.sort(a * g.n + b)
        keep = np.ones(eid.size, bool)
        keep[1:] = eid[1:] != eid[:-1]
        eid = eid[keep]
        a = (eid // g.n).astype(np.int64)
        b = (eid % g.n).astype(np.int32)
        indptr = np.zeros(g.n + 1, g.indptr.dtype)
        indptr[1:] = np.cumsum(np.bincount(a, minlength=g.n))
        new_graph = dataclasses.replace(g, indptr=indptr, indices=b)
        # rows whose ã entries moved: endpoints + their (new) neighbors
        touched = np.zeros(g.n, bool)
        ends = np.unique(np.concatenate([src, dst]))
        touched[ends] = True
        for u in ends:
            touched[new_graph.neighbors(u)] = True
        tids = np.nonzero(touched)[0].astype(np.int32)
        idx_t, w_t, ws_t = to_ell(new_graph, max_deg=self.max_deg, rows=tids)
        k_new = idx_t.shape[1]
        with self._mu:
            if k_new > self.K:               # uncapped ELL grew a column
                pad = k_new - self.K
                self.idx = np.pad(self.idx, ((0, 0), (0, pad)))
                self.w = np.pad(self.w, ((0, 0), (0, pad)))
                self.K = k_new
            self.idx[tids, :k_new] = idx_t
            self.w[tids, :k_new] = w_t
            self.w_self[tids] = ws_t
            self.graph = new_graph
            # the featshard plan encodes the ELL: the next full build
            # plans anew (the reference keeps its first plan)
            self._replan = self.feats_plan is not None or self._replan
            self.feats_plan = None
            self._dirty_row[tids] = True

    # ------------------------------------------------------------------
    # dirty tracking / staleness
    # ------------------------------------------------------------------
    @property
    def dirty(self) -> bool:
        with self._mu:
            return (self._snap is None or bool(self._wal)
                    or bool(self._dirty_in.any())
                    or bool(self._dirty_row.any()))

    def pending_updates(self) -> int:
        """Update records the serving snapshot does not reflect yet
        (queued in the WAL + applied but not yet published)."""
        with self._mu:
            return len(self._wal) + self._applied_unpublished

    def staleness_s(self) -> float:
        """Seconds since the OLDEST update the serving snapshot misses
        (0.0 when fully fresh, +inf before the first build)."""
        with self._mu:
            if self._snap is None:
                return float("inf")
            if self._dirty_since is None:
                return 0.0
            return max(0.0, time.monotonic() - self._dirty_since)

    # ------------------------------------------------------------------
    # forward-influence frontier
    # ------------------------------------------------------------------
    def _referencing(self, mask: np.ndarray) -> np.ndarray:
        """Bool mask of ELL rows that aggregate any node in ``mask``
        through a nonzero-weight entry (the self-loop contribution is
        implicit: w_self > 0 always, so a node itself joins the frontier
        through ``changed``).  The graph is undirected and an ELL row
        lists a subset of its CSR row, so only the CSR neighbors of
        ``mask`` can hold it: their ELL rows are scanned, under
        ``_refresh_mu`` (the only lock ``idx`` and ``w`` change under).
        The reference builds a host reverse index instead, anew after
        every ``add_edges`` (3.8 s at 524,288 nodes on an H100 machine's
        host); only the set of rows is used, so both give the same
        frontier."""
        out = np.zeros(self.graph.n, bool)
        ids = np.nonzero(mask)[0]
        if not ids.size:
            return out
        g = self.graph
        starts = g.indptr[ids].astype(np.int64)
        lens = g.indptr[ids + 1] - starts
        # CSR positions of every neighbor: starts[i] + 0 .. lens[i] - 1
        pos = (np.repeat(starts - np.cumsum(lens) + lens, lens)
               + np.arange(int(lens.sum())))
        out[g.indices[pos]] = True
        cand = np.nonzero(out)[0]
        out[cand] = (mask[self.idx[cand]] & (self.w[cand] > 0)).any(axis=1)
        return out

    def frontier(self) -> List[np.ndarray]:
        """Per-layer bool masks of the rows ``refresh()`` would re-embed
        (the k-hop forward-influence cone of the dirty set; queued WAL
        records are applied first so the preview matches the refresh)."""
        with self._refresh_mu:
            self._drain_apply()
            changed = self._dirty_in.copy()
            fronts = []
            for _ in self.params:
                need = (self._dirty_row | changed
                        | self._referencing(changed))
                fronts.append(need)
                changed = need
            return fronts

    # ------------------------------------------------------------------
    # incremental refresh
    # ------------------------------------------------------------------
    def refresh(self) -> Dict:
        """Re-embed only the dirty frontier into the NEXT snapshot
        version; equal (allclose) to a full rebuild.  The serving
        snapshot is untouched until the atomic publish at the end, so a
        crash (failpoints ``store.mid_layer_refresh`` /
        ``store.before_swap``) keeps the old version serving and the
        dirty state intact.  Returns ``{"rows_per_layer": [...],
        "total_rows": t}``."""
        with self._refresh_mu:
            if self._snap is None:
                run = self.build()
                return {"rows_per_layer": [self.graph.n]
                        * len(self.params),
                        "total_rows": self.graph.n * len(self.params),
                        "built": True, "stats": run.stats}
            self._drain_apply()
            with self._mu:
                din = self._dirty_in.copy()
                drow = self._dirty_row.copy()
                snap = self._snap
                self._sync_inputs(din)
            if not (din.any() or drow.any()):
                # every applied record is in the snapshot already: only
                # the queue (appended since the drain) is pending
                with self._mu:
                    self._applied_unpublished = 0
                    self._dirty_since = (self._wal[0][-1] if self._wal
                                         else None)
                return {"rows_per_layer": [0] * len(self.params),
                        "total_rows": 0}
            new_layers = list(snap.layers)
            changed = din.copy()
            rows_per_layer = []
            for li, p in enumerate(self.params):
                h = self._h0 if li == 0 else new_layers[li - 1]
                need = drow | changed | self._referencing(changed)
                ids = np.nonzero(need)[0].astype(np.int32)
                rows_per_layer.append(int(ids.size))
                if ids.size:
                    new_rows = self._embed_rows(li, p, h, ids)
                    # copy-on-write: the reference's .at[].set returns a
                    # new array (embedding_store.py:445); an in-place
                    # write would tear the PUBLISHED table under readers.
                    # Same rows, same values — only the storage differs.
                    table = new_layers[li].clone()
                    table[torch.as_tensor(ids, device=self.device)
                          .long()] = new_rows
                    new_layers[li] = table
                changed = need
                faults.maybe_crash("store.mid_layer_refresh")
            self._publish(new_layers, drained_in=din, drained_row=drow)
            with self._mu:
                self._counters["refreshes"] += 1
            return {"rows_per_layer": rows_per_layer,
                    "total_rows": int(sum(rows_per_layer))}

    def refresh_with_recovery(self, max_retries: int = 2,
                              backoff_s: float = 0.02) -> Dict:
        """``refresh()`` with the transient/fatal split: transient
        faults (``faults.TransientRefreshFault`` /
        ``TransientSamplerFault``) are retried with exponential backoff
        up to ``max_retries`` times; any OTHER incremental failure
        degrades to ONE full ``build()`` (loud RuntimeWarning) before
        surfacing; ``SimulatedCrash`` is a BaseException and always
        propagates with the old snapshot intact."""
        with self._refresh_mu:
            delay = backoff_s
            for attempt in range(max_retries + 1):
                try:
                    return self.refresh()
                except faults.TransientSamplerFault:
                    if attempt >= max_retries:
                        raise
                    with self._mu:
                        self._counters["transient_retries"] += 1
                    time.sleep(delay)
                    delay *= 2
                except Exception as e:
                    with self._mu:
                        self._counters["degraded_builds"] += 1
                    warnings.warn(
                        f"incremental refresh failed "
                        f"({type(e).__name__}: {e}) — DEGRADING to one "
                        f"full build() before surfacing",
                        RuntimeWarning, stacklevel=2)
                    run = self.build()       # raises through if it fails
                    return {"rows_per_layer": [self.graph.n]
                            * len(self.params),
                            "total_rows": self.graph.n * len(self.params),
                            "degraded": True, "stats": run.stats}

    def _sync_inputs(self, din: np.ndarray) -> None:
        """Copy the layer-0 rows marked in ``din`` from ``graph.feats``
        into ``_h0``, the input table of every pass; the caller holds
        ``_refresh_mu`` and ``_mu``.  In place is safe here (unlike the
        layer tables): ``_h0`` is never published and only read under
        ``_refresh_mu``; the reference rebinds it at the same point of
        ``refresh`` (embedding_store.py:430), so an aborted refresh leaves
        the same state.  ``build`` syncs too, where the reference does
        not: its full pass reads ``_h0`` and then clears every dirty
        mask, so rows updated since the last refresh would be lost from
        the table for good."""
        if din.any():
            ids = np.nonzero(din)[0]
            self._h0[torch.as_tensor(ids, device=self.device)] = \
                torch.as_tensor(self.graph.feats[ids], device=self.device)

    def _publish(self, new_layers: List[torch.Tensor],
                 drained_in: Optional[np.ndarray] = None,
                 drained_row: Optional[np.ndarray] = None,
                 clear_all: bool = False) -> None:
        """Atomic snapshot swap; dirty state drained by THIS pass is
        cleared only here, after the new version is consistent, so an
        aborted refresh loses no invalidation."""
        final_np = new_layers[-1].detach().to("cpu", copy=True).numpy()
        final_np.flags.writeable = False
        faults.maybe_crash("store.before_swap")
        with self._mu:
            self._version += 1
            self._snap = TableSnapshot(self._version, tuple(new_layers),
                                       final_np, time.monotonic())
            if clear_all:
                self._dirty_in[:] = False
                self._dirty_row[:] = False
            else:
                self._dirty_in &= ~drained_in
                self._dirty_row &= ~drained_row
            self._applied_unpublished = 0
            self._dirty_since = (self._wal[0][-1] if self._wal else None)
            self._last_refresh_error = None

    def _embed_rows(self, li: int, p, h, ids: np.ndarray):
        """Layer ``li`` rows ``ids`` against the full table ``h``,
        chunk-padded to the build's chunk width, through the build
        pass's ``_chunk_apply``."""
        last = li == len(self.params) - 1
        src, src_agg = _layer_sources(self.cfg, p, h)
        cs = self.chunk_size
        outs = []
        for c0 in range(0, len(ids), cs):
            sel = ids[c0:c0 + cs]
            m = len(sel)
            rows_b = np.zeros(cs, np.int32)
            idx_b = np.zeros((cs, self.K), np.int32)
            w_b = np.zeros((cs, self.K), np.float32)
            ws_b = np.zeros(cs, np.float32)
            rows_b[:m] = sel
            idx_b[:m] = self.idx[sel]
            w_b[:m] = self.w[sel]
            ws_b[:m] = self.w_self[sel]
            out = _chunk_apply(
                self.cfg, last, p, h, src, src_agg,
                *(torch.as_tensor(a, device=self.device)
                  for a in (rows_b, idx_b, w_b, ws_b)), mesh=self.mesh)
            outs.append(out[:m] if m < cs else out)
        return outs[0] if len(outs) == 1 else torch.cat(outs, 0)

    # ------------------------------------------------------------------
    # refresh scheduler (background re-embeds on a budget)
    # ------------------------------------------------------------------
    def start_scheduler(self, *, refresh_every_updates: Optional[int] = None,
                        refresh_budget_ms: Optional[float] = 50.0,
                        max_staleness_s: Optional[float] = None,
                        max_retries: int = 2, backoff_s: float = 0.02,
                        tick_s: float = 0.005) -> None:
        """Start the daemon refresh thread (idempotent).  It refreshes
        when ``refresh_every_updates`` records are pending, when
        staleness crosses HALF of ``max_staleness_s`` (headroom before
        the serving-side hard bound), or — with any update pending —
        once per ``refresh_budget_ms`` pacing window."""
        with self._mu:
            if self._sched_thread is not None:
                return
            self._sched_cfg = dict(every=refresh_every_updates,
                                   budget_ms=refresh_budget_ms,
                                   max_staleness_s=max_staleness_s,
                                   max_retries=max_retries,
                                   backoff_s=backoff_s, tick_s=tick_s)
            self._sched_stop.clear()
            t = threading.Thread(target=self._scheduler_loop, daemon=True)
            self._sched_thread = t
        t.start()

    def stop_scheduler(self, timeout: float = 5.0) -> None:
        """Stop and join the refresh thread (idempotent)."""
        with self._mu:
            t = self._sched_thread
            self._sched_thread = None
        if t is not None:
            self._sched_stop.set()
            t.join(timeout=timeout)

    def _scheduler_loop(self) -> None:
        cfg = self._sched_cfg
        last_end = 0.0
        while not self._sched_stop.wait(cfg["tick_s"]):
            with self._mu:
                if self._last_refresh_error is not None:
                    return           # fatal: stop; serve path surfaces it
                pending = len(self._wal) + self._applied_unpublished
                since = self._dirty_since
            if not pending and since is None:
                continue
            now = time.monotonic()
            stale = (now - since) if since is not None else 0.0
            due = False
            if cfg["every"] is not None and pending >= cfg["every"]:
                due = True
            elif (cfg["max_staleness_s"] is not None
                  and stale >= 0.5 * cfg["max_staleness_s"]):
                due = True
            elif (cfg["budget_ms"] is not None
                  and (now - last_end) * 1000.0 >= cfg["budget_ms"]):
                due = True
            if not due:
                continue
            try:
                self.refresh_with_recovery(
                    max_retries=cfg["max_retries"],
                    backoff_s=cfg["backoff_s"])
            except Exception as e:
                # fatal (retries + degrade exhausted): remember it and
                # stop scheduling — queries keep serving the last good
                # snapshot, and the serving path re-raises when its SLO
                # forces a synchronous refresh.  SimulatedCrash is a
                # BaseException: it kills this thread like a real crash.
                with self._mu:
                    self._last_refresh_error = e
                return
            with self._mu:
                self._counters["sched_refreshes"] += 1
            last_end = time.monotonic()

    @property
    def last_refresh_error(self) -> Optional[BaseException]:
        with self._mu:
            return self._last_refresh_error

    def refresh_stats(self) -> Dict:
        """Counters for the serving tier: snapshot version, pending
        update records, staleness, retry/degrade/build totals."""
        with self._mu:
            out = {"version": self._version,
                   "pending_updates": (len(self._wal)
                                       + self._applied_unpublished),
                   "last_error": (repr(self._last_refresh_error)
                                  if self._last_refresh_error else ""),
                   **dict(self._counters)}
        out["staleness_s"] = self.staleness_s()
        return out

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def predict_meta(self, nodes) -> Tuple[np.ndarray, int, float]:
        """Serve from the CURRENT snapshot without refreshing: argmax
        class per node plus ``(snapshot_version, staleness_s)`` — the
        per-query SLO metadata.  Raises if the store was never built."""
        stale = self.staleness_s()
        with self._mu:
            snap = self._snap
        if snap is None:
            raise RuntimeError(
                "EmbeddingStore has no snapshot yet — build() first")
        nodes = np.asarray(nodes, np.int64)
        return (np.argmax(snap.final_np[nodes], axis=-1),
                snap.version, stale)

    def _final_table(self) -> np.ndarray:
        """Host copy of the final-layer table (auto-refreshes first) —
        the convenience read path for direct callers; the server
        goes through ``predict_meta`` + its own staleness SLO instead."""
        if self.dirty:
            self.refresh()
        return self.snapshot().final_np

    def query_logits(self, nodes) -> np.ndarray:
        """Final-layer logit rows for ``nodes`` (auto-refreshes)."""
        return self._final_table()[np.asarray(nodes, np.int64)]

    def predict(self, nodes) -> np.ndarray:
        """argmax class per queried node (auto-refreshes)."""
        return np.argmax(self.query_logits(nodes), axis=-1)
