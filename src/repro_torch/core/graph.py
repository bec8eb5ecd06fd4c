"""Graph containers and normalized adjacency (paper §2); numpy copy of
the reference ``repro.core.graph`` (the port imports nothing of it).

Ã = (D_in + I)^{-1/2} (A + I) (D_out + I)^{-1/2}   (self-loops included)

Two padded device layouts:
  * ELL  — [n, max_deg] neighbor ids + ã weights, for full-graph training
           (fixed-width rows; the paper's irregular graphs are
           handled by masking).
  * fan-out trees — per-hop [b, f1, ..., fd] id/weight tensors produced by
    the sampler for mini-batch training.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Graph:
    """CSR undirected graph with features/labels/splits (host side)."""
    n: int
    indptr: np.ndarray          # [n+1]
    indices: np.ndarray         # [nnz]
    feats: np.ndarray           # [n, r] float32
    labels: np.ndarray          # [n] int32
    train_mask: np.ndarray      # [n] bool
    val_mask: np.ndarray
    test_mask: np.ndarray

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    @property
    def d_max(self) -> int:
        return int(self.degrees.max())

    @property
    def avg_degree(self) -> float:
        return float(self.degrees.mean())

    @property
    def n_classes(self) -> int:
        return int(self.labels.max()) + 1

    @property
    def train_nodes(self) -> np.ndarray:
        return np.nonzero(self.train_mask)[0].astype(np.int32)

    @property
    def test_nodes(self) -> np.ndarray:
        return np.nonzero(self.test_mask)[0].astype(np.int32)

    @property
    def val_nodes(self) -> np.ndarray:
        return np.nonzero(self.val_mask)[0].astype(np.int32)

    def neighbors(self, u: int) -> np.ndarray:
        return self.indices[self.indptr[u]:self.indptr[u + 1]]


def norm_coef(graph: Graph, rows: np.ndarray, cols: np.ndarray,
              row_deg: Optional[np.ndarray] = None) -> np.ndarray:
    """ã weights for edges (rows -> cols): 1/sqrt((din_r+1)(dout_c+1)).
    `row_deg` overrides the row in-degree (mini-batch: # sampled = β)."""
    deg = graph.degrees
    din = deg[rows] if row_deg is None else row_deg
    dout = deg[cols]
    return (1.0 / np.sqrt((din + 1.0) * (dout + 1.0))).astype(np.float32)


def neighbors_batch(graph: Graph, rows: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized ragged CSR gather: padded [m, d_max(rows)] neighbor ids
    plus a validity mask, with NO per-node Python loop.  Column j of row i
    is the j-th CSR neighbor of rows[i] (CSR order preserved)."""
    rows = np.asarray(rows, np.int64)
    start = graph.indptr[rows]
    deg = (graph.indptr[rows + 1] - start).astype(np.int64)
    width = int(deg.max()) if deg.size else 0
    cols = np.arange(max(width, 1), dtype=np.int64)[None, :]
    valid = cols < deg[:, None]
    if graph.indices.size == 0:              # edgeless graph
        return np.zeros(valid.shape, np.int32), valid
    # clamp padded positions to 0 — masked out below, never read OOB
    pos = np.where(valid, start[:, None] + cols, 0)
    nb = graph.indices[pos].astype(np.int32)
    nb[~valid] = 0
    return nb, valid


def to_ell(graph: Graph, max_deg: Optional[int] = None, rows=None
           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Padded neighbor lists with ã weights (+ the self-loop weight).

    Returns (idx [m, K], w [m, K], w_self [m]) where m = len(rows) (default
    all nodes).  Rows with degree > K keep the K highest-weight neighbors
    (documented truncation; max_deg defaults to d_max = no truncation).

    Fully vectorized over rows (batched CSR index arithmetic — the seed
    per-node loop was the full-graph setup hot spot).
    """
    rows = np.arange(graph.n, dtype=np.int32) if rows is None else rows
    # `max_deg or d_max` would silently treat an explicit 0 as "uncapped"
    if max_deg is None:
        k = graph.d_max
    elif max_deg >= 1:
        k = int(max_deg)
    else:
        raise ValueError(f"to_ell: max_deg must be >= 1 (or None for "
                         f"d_max={graph.d_max}), got {max_deg}")
    m = len(rows)
    deg_all = graph.degrees
    nb, valid = neighbors_batch(graph, rows)          # [m, width]
    deg = deg_all[np.asarray(rows, np.int64)]
    cw = (1.0 / np.sqrt((deg[:, None] + 1.0) * (deg_all[nb] + 1.0))
          ).astype(np.float32)
    cw[~valid] = 0.0
    width = nb.shape[1]
    if width > k:
        # keep the K highest-weight neighbors per row (padding sorts last)
        keep = np.argpartition(-cw, k - 1, axis=1)[:, :k]
        nb = np.take_along_axis(nb, keep, axis=1)
        cw = np.take_along_axis(cw, keep, axis=1)
        valid = np.take_along_axis(valid, keep, axis=1)
        nb[~valid] = 0
    idx = np.zeros((m, k), np.int32)
    w = np.zeros((m, k), np.float32)
    idx[:, :min(width, k)] = nb[:, :k]
    w[:, :min(width, k)] = cw[:, :k]
    w_self = (1.0 / (deg + 1.0)).astype(np.float32)
    return idx, w, w_self


def full_adjacency_dense(graph: Graph) -> np.ndarray:
    """Dense Ã (n x n) with self-loops — only for small theory/test graphs
    and the Wasserstein analysis."""
    a = np.zeros((graph.n, graph.n), np.float32)
    for u in range(graph.n):
        nb = graph.neighbors(u)
        a[u, nb] = 1.0
    a[np.arange(graph.n), np.arange(graph.n)] = 1.0
    deg = graph.degrees + 1.0
    dm = 1.0 / np.sqrt(deg)
    return (a * dm[:, None]) * dm[None, :]
