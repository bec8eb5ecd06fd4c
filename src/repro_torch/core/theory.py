"""The paper's one-layer theory testbed (§2-§4, App. B-E) and closed-form
iteration-complexity bounds (Theorems 1, 2, B.4, D.2) + the Remark 3.2
slope magnitudes |dT/dβ| (torch copy of the reference
``repro.core.theory``).

Conventions follow the appendix: σ(x) = √2·max(x, 0); MSE carries the 1/2;
CE is binary with the fixed ±1 output vector v.

The testbed is torch on an explicit device; ``init_testbed`` draws from an
explicit ``torch.Generator``, which cannot replay ``jax.random``, so a
comparison with the reference hands both the same numpy W.  The bounds
and slopes are math and numpy, copied as they are.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from repro_torch.device import resolve_device

F32 = torch.float32
SQRT2 = math.sqrt(2.0)


# ---------------------------------------------------------------------------
# one-layer GNN testbed
# ---------------------------------------------------------------------------

def init_testbed(generator: torch.Generator, feat_dim: int, hidden: int,
                 device="cuda") -> torch.Tensor:
    """W ~ N(0, κ² I) with κ = 1 (App. B), drawn on the CPU from
    ``generator`` (a CPU ``torch.Generator``) and moved to ``device``."""
    dev = resolve_device(device)
    return torch.randn((hidden, feat_dim), generator=generator,
                       dtype=F32).to(dev)


def testbed_forward(w, agg_feats):
    """z_i = σ(ã_i X Wᵀ), σ = √2 relu.  agg_feats [m, r] = Ã X rows."""
    return SQRT2 * torch.relu(agg_feats @ w.T)


def testbed_mse_loss(w, agg_feats, onehot):
    """l = ½‖ŷ − y‖²  (App. B: hidden dim h = K classes)."""
    z = testbed_forward(w, agg_feats)
    return 0.5 * torch.mean(torch.sum(torch.square(z - onehot), dim=-1))


def testbed_ce_loss(w, agg_feats, y_pm, v):
    """Binary CE (App. D): ŷ_i = σ(ã_i X Wᵀ)vᵀ, l = log(1+exp(−y ŷ))."""
    z = testbed_forward(w, agg_feats)
    yhat = z @ v
    return torch.mean(torch.log1p(torch.exp(-y_pm * yhat)))


def make_v(hidden: int, device="cuda") -> torch.Tensor:
    """Fixed output vector: half +1 / half −1 (App. D)."""
    v = np.ones(hidden, np.float32)
    v[hidden // 2:] = -1.0
    return torch.as_tensor(v).to(resolve_device(device))


# ---------------------------------------------------------------------------
# Γ, Υ-style graph quantities (App. B/C) — diagnostics
# ---------------------------------------------------------------------------

def gamma_bounds(row_sums: np.ndarray) -> Dict[str, float]:
    """Lemma B.5/C.1: ‖Ã1‖₁/(π m) ≤ Γ ≤ ‖Ã1‖₁/m."""
    m = len(row_sums)
    l1 = float(np.abs(row_sums).sum())
    return {"gamma_lower": l1 / (math.pi * m), "gamma_upper": l1 / m,
            "row_l1": l1}


# ---------------------------------------------------------------------------
# iteration-complexity bounds
# ---------------------------------------------------------------------------

def t_mse_minibatch(n_train: int, h: int, b: int, beta: float,
                    eps: float = 0.1) -> float:
    """Theorem 1:  T = O(n h² b^{5/2} β^{-1/2} ε^{-1} log(h²/ε))."""
    return (n_train * h ** 2 * b ** 2.5 * beta ** -0.5 / eps
            * math.log(h ** 2 / eps))


def t_mse_fullgraph(n_train: int, h: int, d_max: float,
                    eps: float = 0.1) -> float:
    """Theorem B.4:  T = O(n^{7/2} h² d_max^{-1/2} ε^{-1} log(h²/ε))."""
    return (n_train ** 3.5 * h ** 2 * d_max ** -0.5 / eps
            * math.log(h ** 2 / eps))


def t_ce_minibatch(n_train: int, b: int, beta: float, alpha: float = 1.0,
                   eps: float = 0.1) -> float:
    """Theorem 2:  T = O(n² √log n · α⁻² b⁻¹ β^{-5/2} (n² + ε⁻¹))."""
    return (n_train ** 2 * math.sqrt(math.log(max(n_train, 2)))
            / (alpha ** 2 * b * beta ** 2.5)
            * (n_train ** 2 + 1.0 / eps))


def t_ce_fullgraph(n_train: int, d_max: float, alpha: float = 1.0,
                   eps: float = 0.1) -> float:
    """Theorem D.2:  T = O(n √log n · α⁻² d_max^{-5/2} (n² + ε⁻¹))."""
    return (n_train * math.sqrt(math.log(max(n_train, 2)))
            / (alpha ** 2 * d_max ** 2.5) * (n_train ** 2 + 1.0 / eps))


def slope_mse(b: int, beta: float) -> float:
    """Remark 3.2: |∂T/∂β| = O(β^{-3/2} b^{5/2}) under MSE."""
    return beta ** -1.5 * b ** 2.5


def slope_ce(b: int, beta: float) -> float:
    """Remark 3.2: |∂T/∂β| = O(β^{-7/2} b^{-1}) under CE."""
    return beta ** -3.5 / b


def predicted_trends() -> Dict[str, str]:
    """Remark 3.1 qualitative predictions (validated in benchmarks)."""
    return {
        "mse_batch": "increasing b -> MORE iterations (T ~ b^{5/2})",
        "ce_batch": "increasing b -> FEWER iterations (T ~ 1/b)",
        "mse_fanout": "increasing beta -> fewer iterations (T ~ β^{-1/2})",
        "ce_fanout": "increasing beta -> fewer iterations (T ~ β^{-5/2})",
    }
