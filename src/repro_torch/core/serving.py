"""Batched node-classification serving over an ``EmbeddingStore`` (copy
of the reference ``repro.core.serving``; numpy + threads only).

``GNNServer`` is the query front of the inference tier: callers submit
node-id queries from any thread; a single batcher thread coalesces them
into micro-batches (up to ``max_batch`` queried nodes, or whatever has
arrived within ``max_wait_ms`` of the first request) and answers each
batch with ONE final-layer table lookup + argmax.  Because the store
caches layer-wise embeddings, serving cost is O(queried nodes) — no
fan-out tree, no per-query forward pass; the exponential-neighborhood
cost was paid once at build time (docs/training_api.md "Inference &
serving").

Write-safe serving (docs/training_api.md "Serving under writes"):

- Every batch answers from the store's current immutable
  ``TableSnapshot`` via ``predict_meta`` — never from half-refreshed
  tables — and carries ``(snapshot_version, staleness_s)`` back to the
  caller (``submit(..., with_meta=True)`` → ``ServedAnswer``).
- ``max_staleness_s`` is a HARD serving SLO: when the snapshot is
  older than the bound (relative to the oldest unapplied update), the
  batcher forces a synchronous ``refresh_with_recovery`` before
  answering.  The default ``0.0`` reproduces the eager behavior —
  any pending update refreshes before the next batch; ``None`` never
  refreshes on the serve path (pair it with the store's background
  scheduler).
- Overload protection: ``queue_depth`` bounds the request queue;
  admission past the cap either fast-fails with
  ``ServerOverloadedError`` (``overload="fail"``) or blocks up to
  ``submit_timeout_s`` then fails (``overload="block"``).  Per-request
  deadlines (``deadline_s`` / ``default_deadline_s``) shed requests
  already expired BEFORE any table work, failing their futures with
  ``DeadlineExceededError``.
- ``close()`` never leaks futures: queued-but-unserved requests are
  drained and failed with ``RuntimeError("server closed")``, and the
  ``submit``-vs-close race is closed by taking the admission lock in
  both.

``stats()`` exposes the counters the sweep's inference axis and the
serve benchmarks record: request p50/p99/mean latency (ms, from a
fixed-size reservoir — exact up to ``stats_reservoir`` requests,
uniform sampling beyond), answered queries/s, batch counts and mean
occupancy, plus the serving SLO columns (last/max served staleness,
snapshot version, shed/overload/forced-refresh counts).
"""
from __future__ import annotations

import queue
import threading
import time
from collections import namedtuple
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import faults
from repro_torch.core.embedding_store import EmbeddingStore

_STOP = object()


class ServerOverloadedError(RuntimeError):
    """Admission control rejected the request: the bounded request
    queue stayed full past the configured patience."""


class DeadlineExceededError(RuntimeError):
    """The request's deadline passed before the batcher reached it; it
    was shed without spending a table lookup."""


ServedAnswer = namedtuple("ServedAnswer",
                          ["preds", "snapshot_version", "staleness_s"])


class _Reservoir:
    """Fixed-size uniform sample of a float stream (Vitter's
    algorithm R): exact below ``cap`` observations, each later
    observation replaces a uniformly random slot with probability
    cap/n — bounded memory under days-long traffic while keeping the
    percentile estimates unbiased.  NOT thread-safe: callers hold the
    owning ``ServeStats`` lock."""

    def __init__(self, cap: int = 4096, seed: int = 0):
        self.cap = max(1, int(cap))
        self.n = 0
        self._buf: List[float] = []
        self._rng = np.random.default_rng(seed)

    def add(self, x: float) -> None:
        self.n += 1
        if len(self._buf) < self.cap:
            self._buf.append(x)
        else:
            j = int(self._rng.integers(0, self.n))
            if j < self.cap:
                self._buf[j] = x

    def values(self) -> np.ndarray:
        return np.asarray(self._buf, np.float64)


class ServeStats:
    """Thread-safe latency/throughput/SLO counters (bounded memory)."""

    def __init__(self, reservoir: int = 4096):
        self._lock = threading.Lock()
        self._lat = _Reservoir(reservoir)
        self.n_requests = 0
        self.n_queries = 0
        self.n_batches = 0
        self.n_shed = 0
        self.n_overload = 0
        self.n_forced_refresh = 0
        self._version = 0
        self._staleness_last = 0.0
        self._staleness_max = 0.0
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None

    def record(self, n_requests: int, n_queries: int,
               lat_ms: Sequence[float], t0: float, t1: float, *,
               version: Optional[int] = None,
               staleness_s: Optional[float] = None) -> None:
        with self._lock:
            self.n_requests += n_requests
            self.n_queries += n_queries
            self.n_batches += 1
            for x in lat_ms:
                self._lat.add(x)
            if version is not None:
                self._version = version
            if staleness_s is not None:
                self._staleness_last = staleness_s
                self._staleness_max = max(self._staleness_max,
                                          staleness_s)
            if self._t_first is None:
                self._t_first = t0
            self._t_last = t1

    def record_shed(self, n: int = 1) -> None:
        with self._lock:
            self.n_shed += n

    def record_overload(self) -> None:
        with self._lock:
            self.n_overload += 1

    def record_forced_refresh(self) -> None:
        with self._lock:
            self.n_forced_refresh += 1

    def snapshot(self) -> Dict:
        with self._lock:
            lat = self._lat.values()
            span = ((self._t_last - self._t_first)
                    if self._t_first is not None else 0.0)
            return {
                "n_requests": self.n_requests,
                "n_queries": self.n_queries,
                "n_batches": self.n_batches,
                "mean_batch_queries": (self.n_queries / self.n_batches
                                       if self.n_batches else 0.0),
                "p50_ms": float(np.percentile(lat, 50)) if lat.size else 0.0,
                "p99_ms": float(np.percentile(lat, 99)) if lat.size else 0.0,
                "mean_ms": float(lat.mean()) if lat.size else 0.0,
                "qps": (self.n_queries / span) if span > 0 else 0.0,
                "snapshot_version": self._version,
                "staleness_last_s": self._staleness_last,
                "staleness_max_s": self._staleness_max,
                "n_shed": self.n_shed,
                "n_overload": self.n_overload,
                "n_forced_refresh": self.n_forced_refresh,
            }


class _Request:
    __slots__ = ("nodes", "future", "t", "deadline_t", "with_meta")

    def __init__(self, nodes: np.ndarray,
                 deadline_t: Optional[float] = None,
                 with_meta: bool = False):
        self.nodes = nodes
        self.future: "Future[np.ndarray]" = Future()
        self.t = time.monotonic()
        self.deadline_t = deadline_t
        self.with_meta = with_meta


class GNNServer:
    """Micro-batching query server over a built ``EmbeddingStore``.

    ``start=False`` defers the batcher thread (requests queue up and
    coalesce deterministically once ``start()`` runs — used by the
    batching tests); default is to start immediately.

    ``refresh_every_updates`` / ``refresh_budget_ms`` start the store's
    background refresh scheduler (owned by this server: stopped on
    ``close()``); the serve-path ``max_staleness_s`` bound stays the
    hard backstop either way."""

    def __init__(self, store: EmbeddingStore, *, max_batch: int = 64,
                 max_wait_ms: float = 2.0, start: bool = True,
                 queue_depth: Optional[int] = None,
                 overload: str = "block",
                 submit_timeout_s: float = 1.0,
                 default_deadline_s: Optional[float] = None,
                 max_staleness_s: Optional[float] = 0.0,
                 refresh_every_updates: Optional[int] = None,
                 refresh_budget_ms: Optional[float] = None,
                 refresh_retries: int = 2,
                 refresh_backoff_s: float = 0.02,
                 stats_reservoir: int = 4096):
        if overload not in ("block", "fail"):
            raise ValueError(f"overload={overload!r} (want block|fail)")
        self.store = store
        self.max_batch = max(1, int(max_batch))
        self.max_wait_ms = float(max_wait_ms)
        self.queue_depth = (None if queue_depth is None
                            else max(1, int(queue_depth)))
        self.overload = overload
        self.submit_timeout_s = float(submit_timeout_s)
        self.default_deadline_s = default_deadline_s
        self.max_staleness_s = max_staleness_s
        self.refresh_retries = int(refresh_retries)
        self.refresh_backoff_s = float(refresh_backoff_s)
        self.serve_stats = ServeStats(stats_reservoir)
        self._q: "queue.Queue" = queue.Queue(maxsize=self.queue_depth or 0)
        self._lock = threading.Lock()       # admission: submit vs close
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._owns_scheduler = False
        if refresh_every_updates is not None or refresh_budget_ms is not None:
            store.start_scheduler(
                refresh_every_updates=refresh_every_updates,
                refresh_budget_ms=refresh_budget_ms,
                max_staleness_s=max_staleness_s,
                max_retries=self.refresh_retries,
                backoff_s=self.refresh_backoff_s)
            self._owns_scheduler = True
        if start:
            self.start()

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    # ------------------------------------------------------------------
    # client side
    # ------------------------------------------------------------------
    def submit(self, nodes, *, deadline_s: Optional[float] = None,
               with_meta: bool = False) -> "Future[np.ndarray]":
        """Enqueue a query for ``nodes``; resolves to int predictions
        aligned with the request order (or a ``ServedAnswer`` with SLO
        metadata when ``with_meta=True``).

        Raises ``ServerOverloadedError`` when the bounded queue stays
        full (immediately under ``overload="fail"``, after
        ``submit_timeout_s`` under ``"block"``); an expired
        ``deadline_s`` fails the FUTURE with ``DeadlineExceededError``
        when the batcher sheds it."""
        nodes = np.atleast_1d(np.asarray(nodes, np.int64))
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        deadline_t = (time.monotonic() + deadline_s
                      if deadline_s is not None else None)
        req = _Request(nodes, deadline_t, with_meta)
        with self._lock:
            if self._closed:
                raise RuntimeError("GNNServer is closed")
            if self.queue_depth is None:
                self._q.put(req)
            elif self.overload == "fail":
                try:
                    self._q.put_nowait(req)
                except queue.Full:
                    self.serve_stats.record_overload()
                    raise ServerOverloadedError(
                        f"request queue full (depth={self.queue_depth})"
                    ) from None
            else:
                try:
                    self._q.put(req, timeout=self.submit_timeout_s)
                except queue.Full:
                    self.serve_stats.record_overload()
                    raise ServerOverloadedError(
                        f"request queue full (depth={self.queue_depth}) "
                        f"after {self.submit_timeout_s}s") from None
        return req.future

    def classify(self, nodes, timeout: Optional[float] = 30.0
                 ) -> np.ndarray:
        """Blocking ``submit``."""
        return self.submit(nodes).result(timeout=timeout)

    def stats(self) -> Dict:
        return self.serve_stats.snapshot()

    def close(self, timeout: float = 5.0) -> None:
        """Stop the batcher (and the store scheduler, if this server
        started it), then fail every still-queued request's future with
        ``RuntimeError("server closed")`` — callers never hang on a
        future the server will no longer serve."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        try:
            self._q.put_nowait(_STOP)
        except queue.Full:
            pass                     # batcher's idle timeout sees _closed
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        if self._owns_scheduler:
            self.store.stop_scheduler()
        while True:                  # drain leftovers (batcher is gone)
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is _STOP:
                continue
            if not item.future.done():
                item.future.set_exception(RuntimeError("server closed"))

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------------------
    # batcher thread
    # ------------------------------------------------------------------
    def _loop(self) -> None:
        while True:
            try:
                item = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._closed:
                    return
                continue
            if item is _STOP:
                return
            batch = [item]
            n = len(item.nodes)
            deadline = item.t + self.max_wait_ms / 1000.0
            stop = False
            while n < self.max_batch:
                wait = deadline - time.monotonic()
                if wait <= 0:
                    try:
                        nxt = self._q.get_nowait()
                    except queue.Empty:
                        break
                else:
                    try:
                        nxt = self._q.get(timeout=wait)
                    except queue.Empty:
                        break
                if nxt is _STOP:
                    stop = True
                    break
                batch.append(nxt)
                n += len(nxt.nodes)
            self._serve(batch)
            if stop:
                return

    def _needs_refresh(self) -> bool:
        """Hard staleness SLO: refresh before answering iff there is no
        snapshot yet, or pending updates have aged past
        ``max_staleness_s`` (``None`` → never on the serve path)."""
        if self.store.snapshot() is None:
            return True
        if self.max_staleness_s is None:
            return False
        return (self.store.dirty
                and self.store.staleness_s() >= self.max_staleness_s)

    def _serve(self, batch: List[_Request]) -> None:
        t0 = time.monotonic()
        # shed expired requests BEFORE spending refresh/lookup work
        live = []
        for r in batch:
            if r.deadline_t is not None and t0 > r.deadline_t:
                r.future.set_exception(DeadlineExceededError(
                    f"deadline passed {t0 - r.deadline_t:.3f}s before "
                    "serving"))
                self.serve_stats.record_shed()
            else:
                live.append(r)
        if not live:
            return
        try:
            # the SLO check and the refresh race benignly with writers:
            # an update landing after the check is at most one batch
            # late, and the NEXT check sees its true age
            while self._needs_refresh():
                self.store.refresh_with_recovery(
                    max_retries=self.refresh_retries,
                    backoff_s=self.refresh_backoff_s)
                self.serve_stats.record_forced_refresh()
                if self.store.snapshot() is not None:
                    break
            ids = np.concatenate([r.nodes for r in live])
            preds, version, staleness = self.store.predict_meta(ids)
            faults.maybe_crash("serve.before_reply")
            t1 = time.monotonic()
            off = 0
            lats = []
            for r in live:
                k = len(r.nodes)
                p = preds[off:off + k]
                r.future.set_result(
                    ServedAnswer(p, version, staleness)
                    if r.with_meta else p)
                off += k
                lats.append((t1 - r.t) * 1000.0)
            self.serve_stats.record(len(live), len(ids), lats, t0, t1,
                                    version=version,
                                    staleness_s=staleness)
        except BaseException as e:               # surface on the futures
            for r in live:
                if not r.future.done():
                    r.future.set_exception(e)
