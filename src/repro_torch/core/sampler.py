"""Mini-batch sampling (numpy copy of the reference
``repro.core.sampler``): batch-size b node sampling + fan-out β uniform
neighbor sampling per hop (GraphSAGE semantics, paper §2).

Produces padded fan-out trees: hop d has ids [b, f1, ..., fd], a validity
mask, and ã^mini edge weights computed from the SAMPLED in-degree
(the paper's D_in^mini) and the global out-degree (columns of A_train^mini
live in R^n).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.graph import Graph, norm_coef


@dataclasses.dataclass
class FanoutBatch:
    """One sampled mini-batch (hop 0 = target nodes)."""
    nodes: List[np.ndarray]     # hop d: int32 [b, f1..fd]
    masks: List[np.ndarray]     # hop d >= 1: bool, False = padding
    weights: List[np.ndarray]   # hop d >= 1: float32 ã^mini per edge
    self_w: List[np.ndarray]    # hop d >= 0: float32 self-loop weight
    labels: np.ndarray          # [b]
    #: optional per-target loss weight (importance sampling: 1/(n·p_j),
    #: preserving E[weighted batch loss] == full training loss)
    target_w: Optional[np.ndarray] = None

    @property
    def batch_size(self) -> int:
        return len(self.nodes[0])


def sample_neighbors_loop(rng: np.random.Generator, graph: Graph,
                          src: np.ndarray, fanout: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Seed per-node-loop sampler (one rng.choice per node).  Kept as the
    semantics reference for equivalence tests and the bench_sampler.py
    baseline — use `sample_neighbors` (vectorized CSR) everywhere else."""
    flat = src.reshape(-1)
    out = np.zeros((flat.size, fanout), np.int32)
    mask = np.zeros((flat.size, fanout), bool)
    for i, u in enumerate(flat):
        nb = graph.neighbors(int(u))
        if len(nb) == 0:
            continue
        if len(nb) <= fanout:
            out[i, :len(nb)] = nb
            mask[i, :len(nb)] = True
        else:
            sel = rng.choice(nb, size=fanout, replace=False)
            out[i] = sel
            mask[i] = True
    return (out.reshape(src.shape + (fanout,)),
            mask.reshape(src.shape + (fanout,)))


def sample_neighbors(rng: np.random.Generator, graph: Graph,
                     src: np.ndarray, fanout: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized CSR uniform sampling WITHOUT replacement (DGL semantics,
    identical to `sample_neighbors_loop`): nodes with degree <= β keep ALL
    neighbors; higher-degree nodes get β distinct uniform picks.

    No per-node Python loop: low-degree rows are one batched ragged CSR
    gather; high-degree rows draw random sort keys over their padded
    neighbor lists and argpartition the β smallest (exactly uniform
    without replacement).
    """
    flat = src.reshape(-1).astype(np.int64)
    m = flat.size
    out = np.zeros((m, fanout), np.int32)
    mask = np.zeros((m, fanout), bool)
    indptr, indices = graph.indptr, graph.indices
    if m == 0 or indices.size == 0:          # empty batch / edgeless graph
        return (out.reshape(src.shape + (fanout,)),
                mask.reshape(src.shape + (fanout,)))
    start = indptr[flat]
    deg = (indptr[flat + 1] - start).astype(np.int64)

    small = deg <= fanout
    if small.any():
        s = np.nonzero(small)[0]
        s_deg, s_start = deg[s], start[s]
        cols = np.arange(fanout, dtype=np.int64)[None, :]
        keep = cols < s_deg[:, None]
        pos = np.where(keep, s_start[:, None] + cols, 0)
        out[s] = np.where(keep, indices[pos], 0)
        mask[s] = keep

    big = ~small
    if big.any():
        bidx = np.nonzero(big)[0]
        b_deg, b_start = deg[bidx], start[bidx]
        # bucket rows by degree (width doubles per bucket) so the position
        # matrix is padded to <= 2x each row's degree, not the global max
        # degree — total work stays O(sum deg) on power-law graphs
        order = np.argsort(b_deg, kind="stable")
        sdeg = b_deg[order]
        # one batch of randoms for every swap round of every big row
        # (a single rng call; per-bucket rng calls dominate otherwise)
        u = rng.random((fanout, bidx.size), dtype=np.float32)
        lo = 0
        while lo < order.size:
            d0 = int(sdeg[lo])
            # dense regime (β < deg < 2β), big exact-degree run: sample
            # the (deg - β)-element COMPLEMENT instead — uniform exclusion
            # ⇒ uniform kept set, with deg - β < β swap rounds and a pos
            # matrix of width exactly deg (no padding)
            hi_eq = int(np.searchsorted(sdeg, d0, side="right"))
            if d0 < 2 * fanout and hi_eq - lo >= 96:
                grp = order[lo:hi_eq]
                g_start = b_start[grp]
                gm = grp.size
                k = d0 - fanout
                pdt = (np.int8 if d0 < 2 ** 7 else
                       np.int16 if d0 < 2 ** 15 else np.int32)
                # TRANSPOSED position matrix [d0, gm]: the per-round
                # column ops become contiguous gm-byte slices instead of
                # strided reads that pull a full cache line per element
                pos = np.broadcast_to(
                    np.arange(d0, dtype=pdt)[:, None], (d0, gm)).copy()
                posf = pos.reshape(-1)
                rows = np.arange(gm, dtype=np.int64)
                ug = u[:, grp]
                for j in range(k):
                    tcol = d0 - 1 - j          # FY from the top: move an
                    r = (ug[j] * (d0 - j)).astype(np.int64)  # excluded
                    np.minimum(r, d0 - j - 1, out=r)         # pick to the
                    rf = r * gm + rows                       # tail
                    pj = pos[tcol].copy()
                    pos[tcol] = posf[rf]
                    posf[rf] = pj
                out[bidx[grp]] = indices[g_start[:, None]
                                         + pos[:fanout].T]
                lo = hi_eq
                continue
            width = d0
            hi = int(np.searchsorted(sdeg, 2 * width, side="right"))
            grp = order[lo:hi]
            g_deg, g_start = b_deg[grp], b_start[grp]
            width = int(sdeg[hi - 1])
            # partial Fisher-Yates, vectorized over rows: after β swap
            # rounds, rows [0, β) of the TRANSPOSED [width, gm] position
            # matrix hold a uniform without-replacement draw from each
            # row's first g_deg positions.  Transposed layout + the
            # narrowest dtype that holds a position id (usually int8)
            # keep the per-round traffic at contiguous gm-byte slices
            # plus one random gather + one random scatter.
            gm = grp.size
            pdt = (np.int8 if width < 2 ** 7 else
                   np.int16 if width < 2 ** 15 else np.int32)
            pos = np.broadcast_to(np.arange(width, dtype=pdt)[:, None],
                                  (width, gm)).copy()
            posf = pos.reshape(-1)
            rows = np.arange(gm, dtype=np.int64)
            # all swap targets batched in one vectorized shot:
            # rcols[j] ~ Uniform{j, ..., deg-1} per row, flat-indexed
            # into the transposed matrix (position p of row i = p*gm + i)
            js = np.arange(fanout, dtype=np.int64)[:, None]
            rcols = (u[:, grp] * (g_deg[None, :] - js)).astype(np.int64) + js
            np.minimum(rcols, g_deg[None, :] - 1, out=rcols)  # f32 guard
            rcols *= gm
            rcols += rows[None, :]
            # round 0 reads an untouched permutation: pos[0] == 0 and
            # posf[r] == its own position id — skip both gathers
            r0 = rcols[0]
            pos[0] = (r0 // gm).astype(pdt)
            posf[r0] = 0
            for j in range(1, fanout):
                r = rcols[j]
                pj = pos[j].copy()                       # contiguous
                pos[j] = posf[r]
                posf[r] = pj
            out[bidx[grp]] = indices[g_start[:, None] + pos[:fanout].T]
            lo = hi
        mask[bidx] = True
    return (out.reshape(src.shape + (fanout,)),
            mask.reshape(src.shape + (fanout,)))


NeighborSampler = Callable[[np.random.Generator, Graph, np.ndarray, int],
                           Tuple[np.ndarray, np.ndarray]]


def sample_batch(rng: np.random.Generator, graph: Graph, batch_size: int,
                 fanouts: Sequence[int],
                 neighbor_sampler: Optional[NeighborSampler] = None,
                 strict: bool = False) -> FanoutBatch:
    """Sample b target nodes then β_d neighbors per hop.

    ``batch_size > n_train`` clamps to n_train by default (the engine
    pads such partial batches back up to a fixed compiled width); with
    ``strict=True`` it raises instead.  A graph without training nodes
    always raises — ``rng.choice`` on the empty split used to surface
    it as a bare numpy ValueError deep in the call.
    """
    train = graph.train_nodes
    n_train = len(train)
    if batch_size < 1:
        raise ValueError(f"sample_batch: batch_size must be >= 1, got "
                         f"b={batch_size}")
    if n_train == 0:
        raise ValueError(
            f"sample_batch: graph has no training nodes (b={batch_size}, "
            f"n_train=0) — check graph.train_mask")
    if strict and batch_size > n_train:
        raise ValueError(
            f"sample_batch: batch_size exceeds the training split "
            f"(b={batch_size} > n_train={n_train}); pass a smaller b or "
            f"let the engine pad (strict=False clamps to n_train)")
    b = min(batch_size, n_train)
    targets = rng.choice(train, size=b, replace=False).astype(np.int32)
    return expand_batch(rng, graph, targets, fanouts,
                        neighbor_sampler=neighbor_sampler)


def expand_batch(rng: np.random.Generator, graph: Graph,
                 targets: np.ndarray, fanouts: Sequence[int],
                 neighbor_sampler: Optional[NeighborSampler] = None
                 ) -> FanoutBatch:
    sampler = neighbor_sampler or sample_neighbors
    nodes = [targets]
    masks: List[np.ndarray] = []
    weights: List[np.ndarray] = []
    self_w: List[np.ndarray] = []
    deg = graph.degrees
    self_w.append((1.0 / (deg[targets] + 1.0)).astype(np.float32))
    cur = targets
    for beta in fanouts:
        nb, mk = sampler(rng, graph, cur, beta)
        # D_in^mini: number of actually-sampled in-neighbors per row
        samp_deg = mk.sum(-1).astype(np.float32)
        rows = np.broadcast_to(cur[..., None], nb.shape).reshape(-1)
        row_deg = np.broadcast_to(samp_deg[..., None], nb.shape).reshape(-1)
        w = norm_coef(graph, rows, nb.reshape(-1), row_deg=row_deg)
        w = (w.reshape(nb.shape) * mk).astype(np.float32)
        nodes.append(nb)
        masks.append(mk)
        weights.append(w)
        self_w.append((1.0 / (deg[nb.reshape(-1)] + 1.0))
                      .reshape(nb.shape).astype(np.float32))
        cur = nb
    return FanoutBatch(nodes=nodes, masks=masks, weights=weights,
                       self_w=self_w,
                       labels=graph.labels[targets].astype(np.int32))


def gather_features(graph: Graph, batch: FanoutBatch) -> List[np.ndarray]:
    """Host-side feature gather per hop (the paper's CPU->GPU loading path)."""
    return [graph.feats[ids.reshape(-1)].reshape(ids.shape + (-1,))
            for ids in batch.nodes]
