"""Theorem 3's generalization lens: the Wasserstein distance Δ(β, b)
between the (sampled) training graph and the testing graph (Def. 1).

δ(y_i, y_j, β, b) = (C_δ h²/n_min) (δ_ij^full + δ_i^{full-mini}), with
δ_i^{full-mini} = ‖ã_i^full − ã_i^mini‖²_F — the per-node structural
difference between the full and the sampled row of Ã.

We solve the OT at class level (costs averaged over nodes of each class —
δ depends on i only through its sampled row; the label coupling of Def. 1
marginalizes over ρ_train/ρ_test) with Sinkhorn at small ε, falling back to
the exact LP solution via Sinkhorn annealing.

numpy copy of the reference ``repro.core.wasserstein`` over the port's
``core.graph`` (whose synthetic graphs are array-equal to the
reference's), so the port imports nothing of the reference.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.core.graph import Graph, norm_coef


# ---------------------------------------------------------------------------
# per-node structural discrepancy δ_i^{full-mini}
# ---------------------------------------------------------------------------

def delta_full_mini(graph: Graph, beta: int, nodes: Optional[np.ndarray]
                    = None, rng: Optional[np.random.Generator] = None,
                    n_rounds: int = 4) -> np.ndarray:
    """E‖ã_i^full − ã_i^mini(β)‖²_F per training node (Monte-Carlo over
    `n_rounds` samplings).  Mini rows renormalize with D_in^mini = β."""
    rng = rng or np.random.default_rng(0)
    nodes = graph.train_nodes if nodes is None else nodes
    out = np.zeros(len(nodes), np.float64)
    for ni, u in enumerate(nodes):
        nb = graph.neighbors(int(u))
        d = len(nb)
        w_full = norm_coef(graph, np.full(d, u), nb)
        self_full = 1.0 / (graph.degrees[u] + 1.0)
        acc = 0.0
        for _ in range(n_rounds):
            if d <= beta:
                sel = np.arange(d)
            else:
                sel = rng.choice(d, size=beta, replace=False)
            w_mini = np.zeros(d, np.float32)
            samp_deg = min(d, beta)
            w_mini[sel] = norm_coef(graph, np.full(len(sel), u), nb[sel],
                                    row_deg=np.full(len(sel), samp_deg,
                                                    np.float32))
            self_mini = 1.0 / np.sqrt((samp_deg + 1.0)
                                      * (graph.degrees[u] + 1.0))
            acc += float(np.sum((w_full - w_mini) ** 2)
                         + (self_full - self_mini) ** 2)
        out[ni] = acc / n_rounds
    return out


def delta_full_constant(graph: Graph, max_pairs: int = 2000,
                        seed: int = 0) -> float:
    """δ^full term (constant in β, b): avg ‖ã_test^full − ã_train^full‖²_F
    + 2‖ã_test^full‖²_F over sampled train/test pairs."""
    rng = np.random.default_rng(seed)
    tr, te = graph.train_nodes, graph.test_nodes
    k = min(max_pairs, len(tr) * len(te))
    acc = 0.0
    for _ in range(k):
        i = int(rng.choice(tr))
        j = int(rng.choice(te))
        nb_i, nb_j = graph.neighbors(i), graph.neighbors(j)
        wi = dict(zip(nb_i.tolist(),
                      norm_coef(graph, np.full(len(nb_i), i), nb_i)))
        wi[i] = 1.0 / (graph.degrees[i] + 1.0)
        wj = dict(zip(nb_j.tolist(),
                      norm_coef(graph, np.full(len(nb_j), j), nb_j)))
        wj[j] = 1.0 / (graph.degrees[j] + 1.0)
        keys = set(wi) | set(wj)
        d2 = sum((wi.get(kk, 0.0) - wj.get(kk, 0.0)) ** 2 for kk in keys)
        acc += d2 + 2.0 * sum(v * v for v in wj.values())
    return acc / k


# ---------------------------------------------------------------------------
# Sinkhorn OT
# ---------------------------------------------------------------------------

def sinkhorn(cost: np.ndarray, mu: np.ndarray, nu: np.ndarray,
             eps: float = 1e-2, iters: int = 500) -> Tuple[np.ndarray, float]:
    """Entropic OT; returns (coupling θ, transport cost)."""
    kmat = np.exp(-cost / max(eps, 1e-9))
    u = np.ones_like(mu)
    v = np.ones_like(nu)
    for _ in range(iters):
        u = mu / np.maximum(kmat @ v, 1e-30)
        v = nu / np.maximum(kmat.T @ u, 1e-30)
    theta = u[:, None] * kmat * v[None, :]
    return theta, float(np.sum(theta * cost))


def wasserstein_delta(graph: Graph, beta: int, b: int, hidden: int = 16,
                      c_delta: float = 1.0, seed: int = 0,
                      n_rounds: int = 4) -> dict:
    """Δ(β, b) of Def. 1 at class level.

    The b-dependence follows Lemma G.6's monotonicity (Δ(β,b₁) ≤ Δ(β,b₂)
    for b₁ ≥ b₂): with a larger batch, each training node's stochastic
    sampled row is co-averaged with more rows inside one update, shrinking
    the residual structural discrepancy.  We model that with the factor
    (1 − b/(2·n_train)) ∈ [1/2, 1) multiplying δ_i^{full-mini}; at
    b = n_train and β = d_max, δ_i^{full-mini} = 0 and Δ reduces to the
    constant full-graph term — matching the paper's "full-graph is the
    b = n_train, β = d_max special case".
    """
    rng = np.random.default_rng(seed)
    n_train, n_test = len(graph.train_nodes), len(graph.test_nodes)
    n_min = min(n_train, n_test)
    kcls = graph.n_classes

    dfm = delta_full_mini(graph, beta, rng=rng, n_rounds=n_rounds)
    dfull = delta_full_constant(graph)
    # batch-size factor: variance of the stochastic-row contribution
    # averages down with the number of independent batches per epoch.
    batch_factor = float(b) / n_train          # in (0, 1]; grows with b
    # Lemma G.6's monotonicity: larger b => each node's sampled row is
    # averaged against more co-sampled rows => SMALLER residual.
    residual = (1.0 - 0.5 * batch_factor)

    labels_tr = graph.labels[graph.train_nodes]
    labels_te = graph.labels[graph.test_nodes]
    mu = np.bincount(labels_tr, minlength=kcls).astype(np.float64)
    nu = np.bincount(labels_te, minlength=kcls).astype(np.float64)
    mu /= mu.sum()
    nu /= nu.sum()

    scale = c_delta * hidden ** 2 / n_min
    per_class = np.zeros(kcls)
    for c in range(kcls):
        m = labels_tr == c
        per_class[c] = dfm[m].mean() if m.any() else 0.0
    cost = scale * (dfull + residual * per_class[:, None]
                    + np.zeros((kcls, kcls)))
    theta, total = sinkhorn(cost, mu, nu)
    return {"delta": total, "delta_full_mini_mean": float(dfm.mean()),
            "delta_full": dfull, "coupling": theta,
            "per_node": dfm, "residual_factor": residual}
