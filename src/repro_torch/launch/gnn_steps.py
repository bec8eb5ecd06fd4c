"""GNN step functions for the dry-run (reference
``repro.launch.gnn_steps``): one SGD(0.1) step of each paradigm over
``core.gnn``'s forwards and loss, and the shape-only inputs of the
configured production size.

Full-graph training (the paper's paradigm 1) runs the ELL forward over
every node; with ``cfg.use_agg_kernel`` its aggregations go through the
CUDA gather kernel and the tables' gradients through the reverse-index
backward kernel, with the reverse index built beside the ELL as
``engine.FullGraphSource`` builds it, so the traced step is the step the
card runs.  Mini-batch training (paradigm 2) runs the fan-out-tree
forward over a sampled batch.  On one card the reference's node and
batch shardings place nothing; ``mesh`` is accepted and not read.
"""
from __future__ import annotations

from typing import Any, List, Tuple

import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.core import gnn as G
from repro_torch.device import TRACE_DEVICE
from repro_torch.kernels.neighbor_agg import ops
from repro_torch.optim import sgd, value_and_grad

F32, I32 = torch.float32, torch.int32


def _empty(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=TRACE_DEVICE)


def gnn_abstract_params(cfg: GNNConfig, mesh=None) -> List[dict]:
    """``init_gnn``'s parameter tree as shape-only f32 tensors."""
    return G.init_gnn(torch.Generator().manual_seed(0), cfg, cfg.feat_dim,
                      device=TRACE_DEVICE)


def _sgd_step(forward, cfg: GNNConfig):
    opt = sgd(0.1)

    def loss_fn(p, labels, *inputs):
        logits = forward(p, cfg, *inputs)
        return G.gnn_loss(logits, labels, cfg.loss, cfg.n_classes), None

    def step(params, opt_state, labels, *inputs):
        loss, _, grads = value_and_grad(loss_fn, params, labels, *inputs)
        with torch.no_grad():
            params2, opt2 = opt.update(grads, opt_state, params)
        return params2, opt2, loss

    return opt, step


def make_fullgraph_step(cfg: GNNConfig):
    """``(opt, step)``: ``step(params, opt_state, feats, idx, w, w_self,
    labels, rev=None) -> (params, opt_state, loss)``, one full-graph GD
    step; ``rev``: the ELL's reverse index (``ops.build_reverse_index``)
    on the kernel path, or None."""
    opt, inner = _sgd_step(G.full_graph_forward, cfg)

    def step(params, opt_state, feats, idx, w, w_self, labels, rev=None):
        return inner(params, opt_state, labels, feats, idx, w, w_self,
                     False, rev)
    return opt, step


def fullgraph_input_specs(cfg: GNNConfig, mesh=None) -> Tuple[Any, ...]:
    """(feats [n, r] f32, ELL ids [n, K] int32, weights [n, K] f32,
    self-loop weights [n] f32, labels [n] int32, reverse index) at
    ``cfg.n_nodes``, ``cfg.max_degree`` and ``cfg.feat_dim``; the
    reverse index (every edge kept: the worst case) when
    ``cfg.use_agg_kernel``, else None."""
    n, k, r = cfg.n_nodes, cfg.max_degree, cfg.feat_dim
    idx, w = _empty((n, k), I32), _empty((n, k), F32)
    rev = ops.build_reverse_index(idx, w, n) if cfg.use_agg_kernel else None
    return (_empty((n, r), F32), idx, w, _empty((n,), F32),
            _empty((n,), I32), rev)


def make_minibatch_step(cfg: GNNConfig):
    """``(opt, step)``: ``step(params, opt_state, feats, masks, weights,
    self_w, labels) -> (params, opt_state, loss)``, one mini-batch SGD
    step over a sampled fan-out tree."""
    opt, inner = _sgd_step(G.minibatch_forward, cfg)

    def step(params, opt_state, feats, masks, weights, self_w, labels):
        return inner(params, opt_state, labels, feats, masks, weights,
                     self_w)
    return opt, step


def minibatch_input_specs(cfg: GNNConfig, mesh=None) -> Tuple[Any, ...]:
    """(hop features, masks, weights, self weights, labels) of one batch
    of ``cfg.batch_size`` targets with fan-out ``cfg.fanout``: hop d's
    features [b, f1..fd, r] f32, its masks and weights [b, f1..f(d+1)]
    f32, self weights [b, f1..fd] f32, labels [b] int32."""
    b, r = cfg.batch_size, cfg.feat_dim
    feats, masks, weights, self_w = [], [], [], []
    shape = (b,)
    feats.append(_empty(shape + (r,), F32))
    self_w.append(_empty(shape, F32))
    for beta in cfg.fanout:
        edge = shape + (beta,)
        masks.append(_empty(edge, F32))
        weights.append(_empty(edge, F32))
        shape = edge
        feats.append(_empty(shape + (r,), F32))
        self_w.append(_empty(shape, F32))
    return feats, masks, weights, self_w, _empty((b,), I32)
