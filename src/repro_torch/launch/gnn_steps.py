"""GNN step functions for the dry-run (reference
``repro.launch.gnn_steps``): one SGD(0.1) step of each paradigm over
``core.gnn``'s forwards and loss, and the shape-only inputs of the
configured production size.

Full-graph training (the paper's paradigm 1) runs the ELL forward over
every node; with ``cfg.use_agg_kernel`` its aggregations go through the
CUDA gather kernel and the tables' gradients through the reverse-index
backward kernel, with the reverse index built beside the ELL as
``engine.FullGraphSource`` builds it, so the traced one-card step is the
step the card runs.  Mini-batch training (paradigm 2) runs the
fan-out-tree forward over a sampled batch.

With ``mesh`` (a ``sharding.Mesh`` whose ``model`` axis is 1, or a
layout mesh, which runs shard 0 alone) NODES shards over ``(pod,
data)``, as the reference's (``repro/launch/gnn_steps.py:52-99``); the
weights are replicated, one tree a run shard, and the ``model`` axis
idles.  Inputs are lists, one entry a run shard: its block of the node
rows (full-graph) or of the batch (mini-batch).  A full-graph layer
all-gathers its source table over NODES (the gather the paper puts on
full-graph systems; its backward reduce-scatters the table's gradient)
and aggregates its own rows through ``ops.neighbor_agg`` (the kernel, or
its stand-in on meta tensors); the loss and the gradients are summed
over NODES.  This forward is the layout's own: the sharded sources'
path (``full_graph_forward(mesh=)``, ``ops.neighbor_agg_sharded``) keeps
every row of every table on every shard, so its trace could not give
one device's memory.  Run on values over host shards, the mesh steps
equal the unsharded steps and the reference's
(``tests/test_torch_dryrun_multicard.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import torch
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch import sharding as sh
from repro_torch.configs.base import GNNConfig
from repro_torch.core import gnn as G
from repro_torch.device import TRACE_DEVICE
from repro_torch.kernels.neighbor_agg import ops
from repro_torch.optim import sgd, value_and_grad

F32, I32 = torch.float32, torch.int32


def _empty(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=TRACE_DEVICE)


def gnn_abstract_params(cfg: GNNConfig, mesh=None) -> List[dict]:
    """``init_gnn``'s parameter tree as shape-only f32 tensors (with
    ``mesh``, one copy a run shard)."""
    params = G.init_gnn(torch.Generator().manual_seed(0), cfg, cfg.feat_dim,
                        device=TRACE_DEVICE)
    if mesh is None:
        return params
    return [tree_map(torch.clone, params) for _ in mesh.traced]


def nodes_group(mesh) -> sh.Group:
    """The NODES group of a GNN mesh (its ``model`` axis 1, or a layout
    mesh's shard 0)."""
    if not mesh.layout and mesh.sizes["model"] != 1:
        raise ValueError("the GNN steps run on a mesh whose model axis is "
                         "1 (or a layout mesh): GNN weights replicate")
    return mesh.group(sh.axis_map(mesh)[sh.NODES], mesh.traced[0])


def _blocks(shape, mesh) -> int:
    """Rows a run shard holds of a NODES-sharded dim of ``shape``."""
    g = nodes_group(mesh)
    if shape % g.size:
        raise ValueError(f"{shape} rows do not split over {g.size} NODES "
                         f"shards")
    return shape // g.size


def _mesh_step(forward, cfg: GNNConfig, mesh):
    """One SGD(0.1) step of each run shard on its rows: ``forward``
    returns the shards' logits; the loss is the mean of the shards'
    means (one ``psum``), the gradients ``psum``'d over NODES."""
    opt = sgd(0.1)
    g = nodes_group(mesh)

    def step(params, opt_state, labels, *inputs):
        leaves = [tree_map(lambda x: x.detach().requires_grad_(True), p)
                  for p in params]
        with torch.enable_grad():
            logits = forward(leaves, cfg, *inputs, group=g)
            losses = [G.gnn_loss(lg, lb, cfg.loss, cfg.n_classes)[None]
                      for lg, lb in zip(logits, labels)]
            loss = sh.psum(losses, g)[0][0] / g.size
            flat = [x for p in leaves for x in tree_leaves(p)]
            grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                        materialize_grads=True)
        n = len(flat) // len(leaves)
        with torch.no_grad():
            cols = [sh.psum([grads[t * n + i] for t in range(len(leaves))],
                            g) for i in range(n)]
            out = []
            for t, (p, st) in enumerate(zip(params, opt_state)):
                it = iter([c[t] for c in cols])
                gr = tree_map(lambda _: next(it), p)
                out.append(opt.update(gr, st, p))
        return [o[0] for o in out], [o[1] for o in out], loss.detach()
    return opt, step


def _fullgraph_forward_mesh(params, cfg: GNNConfig, feats, idx, w, w_self,
                            rev, group):
    """``full_graph_forward`` over NODES shards: each shard's rows, the
    source table all-gathered a layer (same arithmetic per row)."""
    h = list(feats)
    maskb = [x > 0 for x in w]
    agg_dt = G.agg_dtype(cfg, h[0].dtype)
    n_layers = len(params[0])
    revs = rev or [None] * len(h)

    def agg(table, i, w_edge, r, self_rows=None, w_self_=None, dt=None):
        if cfg.use_agg_kernel:
            return ops.neighbor_agg(table, i, w_edge, self_rows, w_self_,
                                    use_kernel=True, kernel="tiled",
                                    rev=r).to(dt)
        out = torch.einsum("nk,nkd->nd", w_edge,
                           G.gather_rows(table, i)).to(dt)
        if self_rows is not None:
            out = out + (w_self_[:, None] * self_rows).to(dt)
        return out

    for li in range(n_layers):
        last = li == n_layers - 1
        ps = [p[li] for p in params]
        if cfg.model == "gcn":
            pre = ps[0]["w"].shape[1] < h[0].shape[1]
            src = [x @ p["w"] if pre else x for x, p in zip(h, ps)]
        elif cfg.model == "graphsage":
            pre = ps[0]["w_neigh"].shape[1] < h[0].shape[1]
            src = [x @ p["w_neigh"] if pre else x for x, p in zip(h, ps)]
        else:
            src = h
        srcr = [x.to(agg_dt) for x in src]
        tables = sh.all_gather(srcr, group, dim=0)
        out = []
        for x, p, t, sr, i, ww, mb, ws, r in zip(h, ps, tables, srcr, idx, w,
                                                 maskb, w_self, revs):
            if cfg.model == "gcn":
                a = agg(t, i, ww.to(agg_dt), r, sr, ws.to(agg_dt), x.dtype)
                o = a if pre else a @ p["w"]
            elif cfg.model == "graphsage":
                mask = mb.to(x.dtype)
                cnt = torch.clamp(mask.sum(-1, keepdim=True), min=1.0)
                mean = agg(t, i, mb.to(agg_dt), r, dt=x.dtype) / cnt
                o = x @ p["w_self"] + (mean if pre else mean @ p["w_neigh"])
            else:
                o = G._gat_layer(p, x, G.gather_rows(t, i).to(x.dtype), mb)
                if last:
                    o = o.reshape(o.shape[:-1] + (cfg.gat_heads, -1)).mean(-2)
            out.append(o if last else torch.relu(o))
        h = out
    return h


def _minibatch_forward_mesh(params, cfg: GNNConfig, feats, masks, weights,
                            self_w, group):
    return [G.minibatch_forward(p, cfg, f, m, w, s) for p, f, m, w, s
            in zip(params, feats, masks, weights, self_w)]


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


def make_fullgraph_step(cfg: GNNConfig, mesh=None):
    """``(opt, step)``: ``step(params, opt_state, feats, idx, w, w_self,
    labels, rev=None) -> (params, opt_state, loss)``, one full-graph GD
    step; ``rev``: the ELL's reverse index (``ops.build_reverse_index``)
    on the kernel path, or None.  ``mesh``: every argument a list, one
    entry a run shard (``rev``: each shard's rows' index over all n
    table rows)."""
    if mesh is not None:
        opt, inner = _mesh_step(_fullgraph_forward_mesh, cfg, mesh)

        def step(params, opt_state, feats, idx, w, w_self, labels, rev=None):
            return inner(params, opt_state, labels, feats, idx, w, w_self,
                         rev)
        return opt, step
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
    ``cfg.use_agg_kernel``, else None.  With ``mesh``: lists, one entry
    a run shard, of its block of the rows (its reverse index over all n
    table rows)."""
    n, k, r = cfg.n_nodes, cfg.max_degree, cfg.feat_dim
    if mesh is not None:
        m = _blocks(n, mesh)
        specs = [fullgraph_input_specs(
            dataclasses.replace(cfg, n_nodes=m, use_agg_kernel=False))
            for _ in mesh.traced]
        cols = [list(c) for c in zip(*specs)]
        if cfg.use_agg_kernel:
            cols[5] = [ops.build_reverse_index(i, w, n)
                       for i, w in zip(cols[1], cols[2])]
        return tuple(cols)
    idx, w = _empty((n, k), I32), _empty((n, k), F32)
    rev = ops.build_reverse_index(idx, w, n) if cfg.use_agg_kernel else None
    return (_empty((n, r), F32), idx, w, _empty((n,), F32),
            _empty((n,), I32), rev)


def make_minibatch_step(cfg: GNNConfig, mesh=None):
    """``(opt, step)``: ``step(params, opt_state, feats, masks, weights,
    self_w, labels) -> (params, opt_state, loss)``, one mini-batch SGD
    step over a sampled fan-out tree.  ``mesh``: every argument a list,
    one entry a run shard (its rows of the batch)."""
    if mesh is not None:
        opt, inner = _mesh_step(_minibatch_forward_mesh, cfg, mesh)

        def step(params, opt_state, feats, masks, weights, self_w, labels):
            return inner(params, opt_state, labels, feats, masks, weights,
                         self_w)
        return opt, step
    opt, inner = _sgd_step(G.minibatch_forward, cfg)

    def step(params, opt_state, feats, masks, weights, self_w, labels):
        return inner(params, opt_state, labels, feats, masks, weights,
                     self_w)
    return opt, step


def minibatch_input_specs(cfg: GNNConfig, mesh=None) -> Tuple[Any, ...]:
    """(hop features, masks, weights, self weights, labels) of one batch
    of ``cfg.batch_size`` targets with fan-out ``cfg.fanout``: hop d's
    features [b, f1..fd, r] f32, its masks and weights [b, f1..f(d+1)]
    f32, self weights [b, f1..fd] f32, labels [b] int32.  With ``mesh``:
    lists, one entry a run shard, of its rows of the batch."""
    b, r = cfg.batch_size, cfg.feat_dim
    if mesh is not None:
        one = dataclasses.replace(cfg, batch_size=_blocks(b, mesh))
        return tuple(list(c) for c in zip(*(minibatch_input_specs(one)
                                            for _ in mesh.traced)))
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
