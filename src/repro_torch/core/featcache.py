"""Host-side feature-row caches for the sharded SAMPLED sources (a copy
of the reference ``repro/core/featcache.py``).

The full-graph featshard path (kernels/neighbor_agg/featshard.py) can
classify every gather once per bind because its ELL is static.  Sampled
sources draw a fresh fan-out every step, so their cache is the LRU
variant: the engine's single Prefetcher worker thread
looks every staged batch's source-node ids up in an ``LRURowCache``
before staging, modeling which rows a device-resident cache would have
served locally vs. fetched from the owning shard.  The counters feed the
same ``History.counters`` / bench columns as the full-graph plan's
bind-time stats, which is what the paper's feature-gather traffic
comparison (PAPERS.md, "Comprehensive Evaluation of GNN Training
Systems") needs — the staged arrays themselves travel host->device per
batch either way.

Single-threaded by design: ``lookup`` is only ever called from the one
Prefetcher worker (or inline when prefetch is off), so there is no lock.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from repro_torch.kernels.neighbor_agg.featshard import resolve_cache_rows

__all__ = ["LRURowCache", "DegreeHotRowCache", "resolve_cache_rows"]


class LRURowCache:
    """LRU set of feature-row ids with hit/miss accounting.

    ``capacity`` rows; 0 means no cache (every reference is a miss).
    ``row_bytes`` prices a miss for the remote-gather byte counter
    (feat_dim * itemsize).  Each id in a ``lookup`` batch is counted
    once per REFERENCE (duplicates within a batch hit after the first
    touch, exactly like repeated gathers within a fan-out level).
    """

    def __init__(self, capacity: int, row_bytes: int = 0):
        self.capacity = int(capacity)
        self.row_bytes = int(row_bytes)
        self.hits = 0
        self.misses = 0
        self._rows: OrderedDict = OrderedDict()

    def lookup(self, ids) -> int:
        """Touch every id in order; returns this batch's miss count."""
        ids = np.asarray(ids).reshape(-1)
        rows = self._rows
        misses = 0
        if self.capacity <= 0:
            misses = int(ids.size)
            self.misses += misses
            return misses
        for i in ids.tolist():
            if i in rows:
                rows.move_to_end(i)
                self.hits += 1
            else:
                misses += 1
                rows[i] = True
                if len(rows) > self.capacity:
                    rows.popitem(last=False)
        self.misses += misses
        return misses

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "feat_cache_rows": self.capacity,
            "feat_cache_hits": self.hits,
            "feat_cache_misses": self.misses,
            "feat_cache_hit_rate": self.hits / total if total else 1.0,
            "feat_remote_gather_bytes": self.misses * self.row_bytes,
        }


class DegreeHotRowCache:
    """Static top-C-by-degree membership cache — the host twin of the
    full-graph plan's hot set, for callers that want degree-pinned (not
    recency) accounting over sampled batches."""

    def __init__(self, degrees, capacity: int, row_bytes: int = 0):
        degrees = np.asarray(degrees)
        self.capacity = int(capacity)
        self.row_bytes = int(row_bytes)
        order = np.argsort(-degrees.astype(np.float64), kind="stable")
        self._hot = np.zeros(degrees.shape[0], bool)
        self._hot[order[: self.capacity]] = True
        self.hits = 0
        self.misses = 0

    def lookup(self, ids) -> int:
        ids = np.asarray(ids).reshape(-1)
        hot = self._hot[ids]
        h = int(hot.sum())
        self.hits += h
        misses = int(ids.size - h)
        self.misses += misses
        return misses

    stats = LRURowCache.stats
