"""METIS-free graph partitioning for Cluster-GCN style batching.

Cluster/subgraph batching (Chiang et al., Cluster-GCN; NVIDIA 2025
"Structure-Aware Randomized Mini-Batching") is the other mini-batch
family next to node-wise fan-out sampling: partition the graph once,
then every batch is the induced subgraph of a union of k clusters.  The
paper's (b, β) plane gets a third axis — *which* mini-batch family —
and this module provides the partitioning half of it without a METIS
dependency:

- ``bfs_partition`` — greedy BFS growing: pick an unassigned root,
  flood-fill until the part reaches its target size, repeat.  O(n + m),
  deterministic for a fixed seed, runs once per bind and is cached by
  ``ClusterSource``.
- ``cluster_ell_blocks`` — per-cluster ELL blocks over the INDUCED
  subgraph (cluster-local neighbor ids, induced-degree Ã weights).
  Because each block only contains intra-cluster edges, a batch formed
  from k clusters is exactly the block-diagonal concatenation of its
  blocks (cross-cluster edges are dropped — vanilla Cluster-GCN's
  documented approximation), so blocks are computed ONCE and batches
  assemble by offsetting local ids.

Everything here is plain numpy; the device side lives in
``engine.ClusterSource``.  A copy of the reference
``repro.core.partition`` over the port's ``Graph`` (the port imports
nothing of the reference): the part ids and blocks are array-equal to
the reference's.  ``bfs_partition`` keeps the reference's Python loop
over every edge so it visits nodes in the same order.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import List

import numpy as np

from repro_torch.core.graph import Graph, neighbors_batch


def bfs_partition(graph: Graph, n_parts: int, seed: int = 0) -> np.ndarray:
    """Partition nodes into <= ``n_parts`` contiguous-ish parts by greedy
    BFS growing.  Returns an int32 part id per node (all >= 0).

    Each part grows from a randomly-ordered root until it holds
    ``ceil(n / n_parts)`` nodes (disconnected leftovers start a new BFS
    inside the same part, so parts stay size-balanced even on fragmented
    graphs); the last part absorbs any remainder.  ``n_parts >= n``
    degenerates to single-node parts.
    """
    n = graph.n
    if n_parts < 1:
        raise ValueError(f"bfs_partition: n_parts must be >= 1, got "
                         f"{n_parts}")
    n_parts = min(n_parts, n)
    target = -(-n // n_parts)                      # ceil(n / n_parts)
    part = np.full(n, -1, np.int32)
    order = np.random.default_rng(seed).permutation(n)
    ptr = 0                                        # next root candidate
    assigned = 0
    pid = 0
    while assigned < n:
        budget = n - assigned if pid == n_parts - 1 else target
        size = 0
        q: deque = deque()
        while size < budget:
            if not q:
                while ptr < n and part[order[ptr]] >= 0:
                    ptr += 1
                if ptr == n:
                    break
                root = int(order[ptr])
                part[root] = pid
                size += 1
                assigned += 1
                q.append(root)
                continue
            u = q.popleft()
            for v in graph.neighbors(u):
                if part[v] < 0 and size < budget:
                    part[v] = pid
                    size += 1
                    assigned += 1
                    q.append(v)
        pid += 1
    return part


def partition_clusters(part: np.ndarray) -> List[np.ndarray]:
    """Part-id array -> list of sorted node-id arrays (non-empty parts
    only, in part-id order)."""
    out = []
    for p in range(int(part.max()) + 1):
        c = np.nonzero(part == p)[0].astype(np.int64)
        if c.size:
            out.append(c)
    return out


@dataclasses.dataclass
class ClusterBlocks:
    """Cached per-cluster induced-subgraph ELL blocks (host side).

    ``idx[c]`` holds CLUSTER-LOCAL neighbor ids ([m_c, K_c], int32);
    ``w[c]`` the induced-degree Ã edge weights (zero on padding);
    ``w_self[c]`` the induced self-loop weight 1 / (d_induced + 1).
    A batch of k clusters is the block-diagonal stack: offset each
    block's local ids by the running row count and pad K to the max.
    """
    clusters: List[np.ndarray]
    idx: List[np.ndarray]
    w: List[np.ndarray]
    w_self: List[np.ndarray]

    @property
    def sizes(self) -> np.ndarray:
        return np.array([len(c) for c in self.clusters], np.int64)

    @property
    def max_width(self) -> int:
        return max((b.shape[1] for b in self.idx), default=1)


def cluster_ell_blocks(graph: Graph, part: np.ndarray) -> ClusterBlocks:
    """Induced-subgraph ELL blocks for every cluster of ``part``.

    Weights follow the repo's Ã convention restricted to the induced
    subgraph: w_uv = 1/sqrt((d_u + 1)(d_v + 1)) with d the INDUCED
    degree, w_self = 1/(d_u + 1) — a single-node cluster is the fixed
    point (no edges, w_self = 1).
    """
    clusters = partition_clusters(part)
    loc = np.full(graph.n, -1, np.int64)
    idxs, ws, w_selfs = [], [], []
    for c in clusters:
        loc[c] = np.arange(c.size)
        nb, valid = neighbors_batch(graph, c)      # [m, width], global ids
        lnb = loc[nb]
        inb = valid & (lnb >= 0)                   # in-cluster edges only
        ideg = inb.sum(1).astype(np.int64)         # induced degree
        k = max(int(ideg.max()) if ideg.size else 0, 1)
        # compact in-cluster entries to the front (stable: CSR order kept)
        keep = np.argsort(~inb, axis=1, kind="stable")[:, :k]
        lidx = np.take_along_axis(np.where(inb, lnb, 0), keep, 1)
        m = np.take_along_axis(inb, keep, 1)
        dv = ideg[lidx]                            # neighbor induced degree
        w = (m / np.sqrt((ideg[:, None] + 1.0) * (dv + 1.0))
             ).astype(np.float32)
        idxs.append(lidx.astype(np.int32))
        ws.append(w)
        w_selfs.append((1.0 / (ideg + 1.0)).astype(np.float32))
        loc[c] = -1                                # reset for next cluster
    return ClusterBlocks(clusters=clusters, idx=idxs, w=ws, w_self=w_selfs)
