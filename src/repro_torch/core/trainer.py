"""The paper's two paradigms as one call each — thin wrappers over the
engine (torch copy of the reference ``repro.core.trainer``).

Full-graph: GD over all training nodes each iteration, ELL layout —
``Trainer`` + ``FullGraphSource`` (the (b=n, β=d_max) limit case).
Mini-batch: per-iteration (b, β)-sampled fan-out trees + SGD —
``Trainer`` + ``SampledSource``.

``params`` carries initial parameters across (see ``engine.Trainer``);
``device`` is ``cuda`` unless the caller asks for the CPU.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.configs.base import GNNConfig
from repro_torch.core import gnn as G
from repro_torch.core.engine import (FullGraphSource, SampledSource, Trainer,
                                     TrainPlan, TrainResult, _device_ell,
                                     _device_nodes, evaluate_full)
from repro_torch.core.graph import Graph

__all__ = ["TrainResult", "train_full_graph", "train_minibatch",
           "evaluate_full", "full_graph_train_loss"]


def train_full_graph(graph: Graph, cfg: GNNConfig, lr: float,
                     n_iters: int, eval_every: int = 10, seed: int = 0,
                     target_loss: Optional[float] = None,
                     max_deg: Optional[int] = None, params=None,
                     device="cuda") -> TrainResult:
    """Paper's full-graph paradigm: GD on all n_train nodes, Ã_train^full."""
    plan = TrainPlan(lr=lr, n_iters=n_iters, eval_every=eval_every,
                     seed=seed, target_loss=target_loss)
    return Trainer(graph, cfg, plan, source=FullGraphSource(max_deg=max_deg),
                   params=params, device=device).run()


def train_minibatch(graph: Graph, cfg: GNNConfig, lr: float, n_iters: int,
                    batch_size: Optional[int] = None,
                    fanouts: Optional[Sequence[int]] = None,
                    eval_every: int = 10, seed: int = 0,
                    target_loss: Optional[float] = None,
                    track_full_loss_every: int = 0,
                    prefetch: bool = True, params=None,
                    device="cuda") -> TrainResult:
    """Paper's mini-batch paradigm: per-iteration (b, β) sampling + SGD.
    With ``prefetch`` the host sampling runs on a background thread
    ahead of the device step (same batch sequence as without)."""
    plan = TrainPlan(lr=lr, n_iters=n_iters, eval_every=eval_every,
                     seed=seed, target_loss=target_loss,
                     track_full_loss_every=track_full_loss_every)
    source = SampledSource(batch_size=batch_size, fanouts=fanouts,
                           prefetch=prefetch)
    return Trainer(graph, cfg, plan, source=source, params=params,
                   device=device).run()


def full_graph_train_loss(graph: Graph, params, cfg: GNNConfig,
                          ell=None) -> float:
    """Loss of ``params`` on the full training set — the objective the
    paper measures mini-batch convergence against.  Runs on the
    parameters' device."""
    dev = params[0][next(iter(params[0]))].device
    if ell is None:
        ell = _device_ell(graph, None, dev)
    idx, w, w_self, feats, labels = ell
    sel = _device_nodes(graph, "train", dev)
    logits = G.full_graph_forward(params, cfg, feats, idx, w, w_self)
    return float(G.gnn_loss(logits[sel], labels[sel], cfg.loss,
                            cfg.n_classes))
