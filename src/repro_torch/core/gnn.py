"""GCN / GraphSAGE(mean) / GAT — the torch counterpart of the reference
``repro.core.gnn``: the full-graph (ELL) forward, the mini-batch
(fan-out tree) forward, and the CE/MSE losses, differentiable on every
path (the kernel path through ``kernels/neighbor_agg``'s autograd
Functions and their CUDA backward kernel).

Parameters keep the reference layout so its arrays load unchanged:
``h @ W`` with ``W`` shaped ``[d_in, d_out]``; GAT's ``w [d_in, H, dh]``,
``a_src``/``a_dst [H, dh]``.  Every cast point of the reference forward is
kept (the ``agg_dt`` cast of the gather source, the single bool-mask
cast, the pre-transform when a layer narrows), so bf16 runs round at the
same places.  The ``h @ W`` products stay ``torch.matmul`` (the reference
leaves them to XLA outside any kernel); on the card run them with
``torch.backends.cuda.matmul.allow_tf32 = False`` (the default) so they
are full f32 like the reference's.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import GNNConfig
from repro_torch.device import resolve_device

F32 = torch.float32


# ---------------------------------------------------------------------------
# init / weight carry-across
# ---------------------------------------------------------------------------

def layer_dims(cfg: GNNConfig, feat_dim: int) -> List[tuple]:
    dims = []
    d_in = feat_dim
    for l in range(cfg.n_layers):
        d_out = cfg.n_classes if l == cfg.n_layers - 1 else cfg.hidden
        dims.append((d_in, d_out))
        d_in = d_out
    return dims


def init_gnn(generator: torch.Generator, cfg: GNNConfig, feat_dim: int,
             device="cuda") -> List[Dict[str, torch.Tensor]]:
    """Random parameters in the reference layout and scale.  Drawn on the
    CPU from ``generator`` (a CPU ``torch.Generator``) and moved to
    ``device``, so a seed gives the same weights on every device.  torch
    cannot replay ``jax.random``: for parity with the reference, load its
    parameters with ``params_from_numpy`` instead."""
    dev = resolve_device(device)

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=F32)

    params = []
    for li, (d_in, d_out) in enumerate(layer_dims(cfg, feat_dim)):
        sc = 1.0 / math.sqrt(d_in)
        if cfg.model == "gcn":
            p = {"w": sc * normal(d_in, d_out)}
        elif cfg.model == "graphsage":
            p = {"w_self": sc * normal(d_in, d_out),
                 "w_neigh": sc * normal(d_in, d_out)}
        else:  # gat
            h = cfg.gat_heads
            last = li == cfg.n_layers - 1
            # hidden layers concat heads (dh = d_out/h); the last layer
            # emits full class logits per head and averages them.
            dh = d_out if last else max(d_out // h, 1)
            p = {"w": sc * normal(d_in, h, dh),
                 "a_src": 0.1 * normal(h, dh),
                 "a_dst": 0.1 * normal(h, dh)}
        params.append({k: v.to(dev) for k, v in p.items()})
    return params


def params_from_numpy(params: Sequence[Dict[str, Any]], device="cuda"
                      ) -> List[Dict[str, torch.Tensor]]:
    """The weight carry-across: a list of per-layer dicts of arrays (the
    reference's ``init_gnn`` output through ``np.asarray``) as float32
    tensors on ``device``, same keys, same layout."""
    dev = resolve_device(device)
    return [{k: torch.tensor(np.asarray(v, np.float32), device=dev)
             for k, v in p.items()} for p in params]


# ---------------------------------------------------------------------------
# layer primitives
# ---------------------------------------------------------------------------

def _kernel_agg(cfg: GNNConfig, table, idx, w, self_rows=None,
                w_self=None, rev=None, mesh=None):
    """Σ_k w[b,k] · table[idx[b,k]] (+ fused w_self[b] · self_rows[b]
    epilogue) through the hand-written kernel (its plain version on a
    CPU tensor); ``rev``, the reverse index of ``(idx, w)``, sends the
    table's gradient through the reverse-index backward kernel.  With
    ``mesh`` the rows split over its NODES shards, one launch per shard
    over the whole table, and the table's gradient is psum'd (``rev`` is
    then a ``ShardedReverseIndex``).  The reference's ``agg_*`` tile
    fields have no meaning for it."""
    if mesh is not None:
        from repro_torch.kernels.neighbor_agg.ops import \
            neighbor_agg_sharded
        return neighbor_agg_sharded(table, idx, w, self_rows, w_self,
                                    mesh=mesh, rev=rev)
    from repro_torch.kernels.neighbor_agg.ops import neighbor_agg
    return neighbor_agg(table, idx, w, self_rows, w_self, use_kernel=True,
                        kernel="tiled", rev=rev)


def _wsum(cfg: GNNConfig, w_edge, h_nb, h_self=None, w_self=None,
          mesh=None):
    """Weighted neighbor sum over ALREADY-GATHERED features:
    out[..., :] = Σ_k w_edge[..., k] * h_nb[..., k, :]
                  [+ w_self[...] * h_self[..., :]]
    (reference ``gnn.py:81-116``).

    With ``cfg.use_agg_kernel`` the fan-out tree is flattened to a
    [B*K, d] table with identity ids (``neighbor_agg_batch``), so the
    mini-batch path runs the same tiled kernel (zero-weight padding edges
    stay exact) and, for its gradient, the backward kernel's identity
    mode; the optional self term rides the fused epilogue.  With ``mesh``
    the flattened rows split over its NODES shards
    (``neighbor_agg_batch_sharded``: each shard's table derives from its
    own rows, so no collective)."""
    fused = h_self is not None
    if not cfg.use_agg_kernel:
        out = torch.einsum("...k,...kd->...d", w_edge, h_nb)
        return out + w_self[..., None] * h_self if fused else out
    from repro_torch.kernels.neighbor_agg import ops
    k, d = h_nb.shape[-2], h_nb.shape[-1]
    lead = h_nb.shape[:-2]
    b = math.prod(lead)
    args = (w_edge.reshape(b, k), h_nb.reshape(b, k, d),
            h_self.reshape(b, d) if fused else None,
            w_self.reshape(b) if fused else None)
    if mesh is not None:
        out = ops.neighbor_agg_batch_sharded(*args, mesh=mesh)
    else:
        out = ops.neighbor_agg_batch(*args)
    return out.reshape(lead + (d,))


def _gcn_layer(cfg, p, h_self, h_nb, w_edge, w_self, mesh=None):
    """h_self [..., d]; h_nb [..., K, d]; w_edge [..., K]; w_self [...]."""
    return _wsum(cfg, w_edge, h_nb, h_self, w_self, mesh=mesh) @ p["w"]


def _sage_layer(cfg, p, h_self, h_nb, mask, mesh=None):
    cnt = torch.clamp(mask.sum(-1, keepdim=True), min=1.0)
    mean = _wsum(cfg, mask, h_nb, mesh=mesh) / cnt
    return h_self @ p["w_self"] + mean @ p["w_neigh"]


def _gat_layer(p, h_self, h_nb, mask):
    z_s = torch.einsum("...d,dhe->...he", h_self, p["w"])     # [..., H, dh]
    z_n = torch.einsum("...kd,dhe->...khe", h_nb, p["w"])     # [..., K, H, dh]
    e_s = torch.einsum("...he,he->...h", z_s, p["a_src"])     # [..., H]
    e_n = torch.einsum("...khe,he->...kh", z_n, p["a_dst"])   # [..., K, H]
    e = F.leaky_relu(e_s[..., None, :] + e_n, 0.2)
    # a float 0/1 mask (mini-batch path) selects like the bool one
    e = torch.where(mask[..., None].bool(), e, torch.full_like(e, -1e30))
    # self edge always valid (jax.nn.leaky_relu's default slope, 0.01)
    e_self = F.leaky_relu(e_s + torch.einsum("...he,he->...h", z_s,
                                             p["a_dst"]), 0.01)[..., None, :]
    ea = torch.cat([e, e_self], dim=-2)                        # [...,K+1,H]
    alpha = torch.softmax(ea, dim=-2)
    zn_all = torch.cat([z_n, z_s[..., None, :, :]], dim=-3)
    out = torch.einsum("...kh,...khe->...he", alpha, zn_all)
    return out.reshape(out.shape[:-2] + (-1,))                 # concat heads


def _apply_layer(cfg: GNNConfig, p, h_self, h_nb, mask, w_edge, w_self,
                 last: bool, mesh=None):
    if cfg.model == "gcn":
        out = _gcn_layer(cfg, p, h_self, h_nb, w_edge, w_self, mesh=mesh)
    elif cfg.model == "graphsage":
        out = _sage_layer(cfg, p, h_self, h_nb, mask, mesh=mesh)
    else:
        out = _gat_layer(p, h_self, h_nb, mask)
        if last:  # average heads into class logits
            h = cfg.gat_heads
            out = out.reshape(out.shape[:-1] + (h, -1)).mean(-2)
    return out if last else torch.relu(out)


def gather_rows(table, idx):
    """``table[idx]`` for int ids ``idx`` of any shape: rows of ``table``
    [N, d] -> ``idx.shape + (d,)``, with a gradient that sums each row's
    contributions in a fixed order on either device, as exact resume
    and seeded repeats need.  On a CPU tensor it is ``index_select``,
    whose gradient ``index_add_`` adds serially there; the gradient of
    advanced indexing, ``index_put_(accumulate=True)``, adds with
    parallel atomics on the CPU once the gather is large, so a row's
    sum order followed thread scheduling.  On a CUDA tensor it is
    advanced indexing, whose gradient sorts the ids and sums each row
    in that order; ``index_add_`` adds with atomics there.  A
    shape-only tensor on the trace device takes the card's form."""
    ids = idx.reshape(-1).long()
    flat = (torch.index_select(table, 0, ids) if table.device.type == "cpu"
            else table[ids])
    return flat.reshape(tuple(idx.shape) + (table.shape[-1],))


def agg_dtype(cfg: GNNConfig, h_dtype: torch.dtype) -> torch.dtype:
    """The aggregation traffic dtype: bf16 under ``dtype="bfloat16"``,
    else the table's own."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else h_dtype


# ---------------------------------------------------------------------------
# full-graph forward (ELL)
# ---------------------------------------------------------------------------

def full_graph_forward(params, cfg: GNNConfig, feats, ell_idx, ell_w,
                       w_self, return_layers=False, rev=None, mesh=None,
                       feats_plan=None):
    """feats [n, r]; ell_idx [n, K] int32; ell_w [n, K]; w_self [n] ->
    logits [n, C] (reference ``gnn.py:165-298``).  ``rev``: the reverse
    index of ``(ell_idx, ell_w)`` (``ops.build_reverse_index``; with
    ``mesh``, ``ops.build_sharded_reverse_index``), or None.

    * When a layer narrows (d_out < d_in) the linear transform runs
      BEFORE aggregation (Ã(hW) == (Ãh)W for GCN and the GraphSAGE
      neighbor branch), so the gather moves d_out-wide rows.
    * Aggregation traffic runs in ``cfg.dtype`` (bf16 at production
      scale): the gather source is cast once per layer.
    * With ``cfg.use_agg_kernel`` the gcn/graphsage aggregation runs
      through the CUDA gather kernel (no [n, K, d] gather is
      materialized), GCN's self term through its fused epilogue.  GAT
      keeps the einsum path.  With ``rev`` as well, the tables'
      gradients come from the reverse-index backward kernel: both
      aggregations' weights (GraphSAGE's mask, GCN's ``ell_w``) are zero
      wherever ``ell_w`` is, so the index fits them.

    ``mesh`` (the sharded sources) splits the KERNEL path's rows over
    the mesh's NODES shards (``ops.neighbor_agg_sharded``: one launch
    per shard over the whole table, the table's gradient psum'd); the
    einsum path ignores it.  On a process-group mesh (one process a
    shard) every operand is this rank's rows on either path: each layer
    all-gathers the rank's cast table into the whole one its gathers
    read (the reference's GSPMD all-gather; its adjoint reduce-scatters
    the table's gradient back to the owners), and ``h @ W`` runs on the
    rank's rows.  ``feats_plan`` (a ``FeatShardPlan`` built at
    bind under ``cfg.feats_layout == "sharded"``) sends the gcn /
    graphsage kernel path through ``neighbor_agg_featshard`` instead:
    the source table is row-sharded, with the plan's hot cache and one
    compacted miss all_gather per call.  GAT ignores both.

    ``return_layers`` also returns every layer's POST-activation table
    ``[h_1, ..., h_L]`` (``h_L`` = the logits).
    """
    h = feats
    maskb = ell_w > 0
    mask = maskb.to(h.dtype)
    agg_dt = agg_dtype(cfg, h.dtype)
    # aggregation consumes the mask in agg_dt: cast the bool ONCE
    mask_agg = mask if agg_dt == h.dtype else maskb.to(agg_dt)
    n_layers = len(params)
    fs_active = (feats_plan is not None and cfg.use_agg_kernel
                 and cfg.model in ("gcn", "graphsage"))
    from repro_torch import sharding as sh
    ranked = mesh is not None and mesh.rank_local

    def table(srcr):
        """The whole table a rank's gathers read: its rows all-gathered
        on a process-group mesh, ``srcr`` itself otherwise."""
        return sh.all_gather([srcr], mesh)[0] if ranked else srcr

    def agg_w(srcr, w_edge):
        """Σ_k w_edge[n,k] · srcr[ell_idx[n,k]]; ``srcr`` is the already
        cast table."""
        if fs_active:
            from repro_torch.kernels.neighbor_agg.ops import \
                neighbor_agg_featshard
            return neighbor_agg_featshard(srcr, w_edge.to(agg_dt),
                                          feats_plan).to(h.dtype)
        if cfg.use_agg_kernel:
            return _kernel_agg(cfg, table(srcr), ell_idx, w_edge.to(agg_dt),
                               rev=rev, mesh=mesh).to(h.dtype)
        return torch.einsum("nk,nkd->nd", w_edge.to(agg_dt),
                            gather_rows(table(srcr), ell_idx)).to(h.dtype)

    layers = []
    for li, p in enumerate(params):
        last = li == n_layers - 1
        if cfg.model == "gcn":
            w = p["w"]
            pre = w.shape[1] < h.shape[1]
            src = (h @ w) if pre else h
            srcr = src.to(agg_dt)
            if fs_active:
                from repro_torch.kernels.neighbor_agg.ops import \
                    neighbor_agg_featshard
                agg = neighbor_agg_featshard(
                    srcr, ell_w.to(agg_dt), feats_plan, self_rows=srcr,
                    w_self=w_self.to(agg_dt)).to(h.dtype)
            elif cfg.use_agg_kernel:
                # fused epilogue: the self row IS the source table row b
                agg = _kernel_agg(cfg, table(srcr), ell_idx,
                                  ell_w.to(agg_dt), self_rows=srcr,
                                  w_self=w_self.to(agg_dt), rev=rev,
                                  mesh=mesh).to(h.dtype)
            else:
                agg = agg_w(srcr, ell_w) + (w_self.to(agg_dt)[:, None]
                                            * srcr).to(h.dtype)
            out = agg if pre else agg @ w
        elif cfg.model == "graphsage":
            wn = p["w_neigh"]
            pre = wn.shape[1] < h.shape[1]
            src = (h @ wn) if pre else h
            cnt = torch.clamp(mask.sum(-1, keepdim=True), min=1.0)
            mean = agg_w(src.to(agg_dt), mask_agg) / cnt
            out = h @ p["w_self"] + (mean if pre else mean @ wn)
        else:  # gat — gathers the raw h (per-edge attention)
            nb = gather_rows(table(h.to(agg_dt)), ell_idx).to(h.dtype)
            out = _gat_layer(p, h, nb, maskb)
            if last:
                heads = cfg.gat_heads
                out = out.reshape(out.shape[:-1] + (heads, -1)).mean(-2)
        h = out if last else torch.relu(out)
        if return_layers:
            layers.append(h)
    return (h, layers) if return_layers else h


# ---------------------------------------------------------------------------
# mini-batch forward (fan-out tree)
# ---------------------------------------------------------------------------

def minibatch_forward(params, cfg: GNNConfig, hop_feats: Sequence,
                      masks: Sequence, weights: Sequence, self_w: Sequence,
                      mesh=None):
    """hop_feats[d]: [b, f1..fd, r]; masks/weights[d]: [b, f1..f(d+1)].
    Layer l aggregates hop d+1 into hop d for d < L - l (reference
    ``gnn.py:305-324``).  ``mesh`` (the sharded sources) splits the
    kernel path's target rows over its NODES shards; the einsum path
    ignores it.  Like the reference, this path does NOT cast to
    ``agg_dt``: it aggregates in the hop features' own dtype."""
    hs = list(hop_feats)
    n_layers = len(params)
    for li, p in enumerate(params):
        last = li == n_layers - 1
        hs = [_apply_layer(cfg, p, hs[d], hs[d + 1],
                           masks[d].to(hs[d].dtype), weights[d], self_w[d],
                           last, mesh=mesh)
              for d in range(len(hs) - 1)]
    assert len(hs) == 1
    return hs[0]                                      # [b, C]


# ---------------------------------------------------------------------------
# losses (paper: CE and MSE, §3)
# ---------------------------------------------------------------------------

def gnn_loss(logits, labels, kind: str, n_classes: int, valid=None,
             weight=None, denom=None):
    """CE / MSE over target rows (reference ``gnn.py:331-358``).
    ``valid`` (float 0/1 per row, or None) masks padded rows out of the
    mean: they contribute exact zeros and the divisor is the valid
    count.  ``weight`` (float per row, or None) scales each row's loss
    before the mean and does not enter the divisor.  ``denom`` (a count)
    divides the rows' sum instead: one rank's share of a mean over rows
    that several ranks hold."""
    z = logits.to(F32)
    if kind == "mse":
        onehot = F.one_hot(labels.long(), n_classes).to(F32)
        rows = torch.sum(torch.square(z - onehot), dim=-1)
    else:
        logz = torch.logsumexp(z, dim=-1)
        rows = logz - torch.gather(z, -1, labels.long()[..., None])[..., 0]
    if weight is not None:
        rows = rows * weight
    if denom is not None:
        loss = torch.sum(rows if valid is None else rows * valid) / denom
    elif valid is None:
        loss = torch.mean(rows)
    else:
        loss = torch.sum(rows * valid) / torch.sum(valid)
    return 0.5 * loss if kind == "mse" else loss


def accuracy(logits, labels):
    return (torch.argmax(logits, -1) == labels).to(F32).mean()
