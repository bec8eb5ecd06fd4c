"""Synthetic data: SBM graphs standing in for the paper's OGB datasets
and the Markov-chain token pipeline of the LM archs (numpy copy of the
reference ``repro.data.synth``).

Features are class-conditioned Gaussians (matches the paper's assumption
that labels are sampled conditioned on features, §2).  Presets mirror each
dataset's *regime* (classes, homophily, average degree), not its size.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.core.graph import Graph


def make_sbm_graph(n: int, n_classes: int, avg_degree: float,
                   homophily: float = 0.8, feat_dim: int = 32,
                   feat_scale: float = 1.0, train_frac: float = 0.5,
                   val_frac: float = 0.1, seed: int = 0,
                   power_law: bool = False) -> Graph:
    """Stochastic block model, undirected, no self-edges in A (the
    normalized adjacency adds self-loops per the paper)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=n).astype(np.int32)

    # per-node degree budget
    if power_law:
        deg = np.minimum(
            (avg_degree / 2.0) * (rng.pareto(2.0, n) + 1.0), n / 4
        ).astype(np.int64)
    else:
        deg = rng.poisson(avg_degree, n).astype(np.int64)
    deg = np.maximum(deg, 1)

    # sample edges: for each node pick targets, homophilous w.p. h
    srcs, dsts = [], []
    by_class = [np.nonzero(labels == c)[0] for c in range(n_classes)]
    for u in range(n):
        k = max(int(deg[u] // 2), 1)
        same = rng.random(k) < homophily
        pool_same = by_class[labels[u]]
        t_same = rng.choice(pool_same, size=int(same.sum()))
        t_rand = rng.integers(0, n, size=int((~same).sum()))
        t = np.concatenate([t_same, t_rand])
        t = t[t != u]
        srcs.append(np.full(len(t), u))
        dsts.append(t)
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    # symmetrize + dedupe
    a = np.concatenate([src, dst])
    b = np.concatenate([dst, src])
    eid = a.astype(np.int64) * n + b
    eid = np.unique(eid)
    a = (eid // n).astype(np.int32)
    b = (eid % n).astype(np.int32)

    order = np.argsort(a, kind="stable")
    a, b = a[order], b[order]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, a + 1, 1)
    indptr = np.cumsum(indptr)
    indices = b

    # class-conditioned Gaussian features
    mus = rng.normal(0, feat_scale, (n_classes, feat_dim)).astype(np.float32)
    feats = (mus[labels]
             + rng.normal(0, 1.0, (n, feat_dim)).astype(np.float32))

    perm = rng.permutation(n)
    n_tr = int(train_frac * n)
    n_va = int(val_frac * n)
    train_mask = np.zeros(n, bool)
    val_mask = np.zeros(n, bool)
    test_mask = np.zeros(n, bool)
    train_mask[perm[:n_tr]] = True
    val_mask[perm[n_tr:n_tr + n_va]] = True
    test_mask[perm[n_tr + n_va:]] = True
    return Graph(n=n, indptr=indptr, indices=indices, feats=feats,
                 labels=labels, train_mask=train_mask, val_mask=val_mask,
                 test_mask=test_mask)


# Presets echo each OGB/reddit dataset's regime (avg degree, classes,
# homophily) at CPU-tractable size.
PRESETS: Dict[str, dict] = {
    # reddit: dense social graph, avg deg ~492 -> scaled to 60
    "reddit-like": dict(n=3000, n_classes=16, avg_degree=60.0,
                        homophily=0.75, feat_dim=64),
    # ogbn-arxiv: citation graph, avg deg ~13.7
    "arxiv-like": dict(n=3000, n_classes=12, avg_degree=14.0,
                       homophily=0.65, feat_dim=64),
    # ogbn-products: co-purchase, avg deg ~50.5
    "products-like": dict(n=4000, n_classes=16, avg_degree=50.0,
                          homophily=0.8, feat_dim=64),
    # ogbn-papers100M: citation, avg deg ~29, many classes, power-law
    "papers-like": dict(n=5000, n_classes=24, avg_degree=29.0,
                        homophily=0.6, feat_dim=64, power_law=True),
}


def make_preset(name: str, seed: int = 0, **overrides) -> Graph:
    kw = dict(PRESETS[name])
    kw.update(overrides)
    return make_sbm_graph(seed=seed, **kw)


# ---------------------------------------------------------------------------
# toy token pipeline for the LM archs (smoke training)
# ---------------------------------------------------------------------------

def token_batches(vocab: int, batch: int, seq: int, seed: int = 0,
                  n_batches: Optional[int] = None) -> Iterator[dict]:
    """Markov-chain synthetic tokens (learnable structure, not uniform
    noise): ``{"tokens", "labels"}`` int32 [batch, seq], labels the
    tokens shifted by one.  Array-equal to the reference's for a seed."""
    rng = np.random.default_rng(seed)
    v_eff = min(vocab, 256)
    trans = rng.dirichlet(np.ones(v_eff) * 0.1, size=v_eff)
    cum = np.cumsum(trans, axis=1)
    i = 0
    while n_batches is None or i < n_batches:
        toks = np.zeros((batch, seq + 1), np.int64)
        toks[:, 0] = rng.integers(0, v_eff, batch)
        u = rng.random((batch, seq))
        for t in range(seq):
            toks[:, t + 1] = (u[:, t:t + 1]
                              < cum[toks[:, t]]).argmax(1)
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
        i += 1
