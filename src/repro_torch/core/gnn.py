"""GCN / GraphSAGE(mean) / GAT forward on the full graph (ELL layout) —
the torch counterpart of the reference ``repro.core.gnn`` (forward only;
the mini-batch path and the losses come with the training part).

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
                w_self=None):
    """Σ_k w[b,k] · table[idx[b,k]] (+ fused w_self[b] · self_rows[b]
    epilogue) through the hand-written kernel (its plain version on a
    CPU tensor).  The reference's ``agg_*`` tile fields have no meaning
    for it."""
    from repro_torch.kernels.neighbor_agg.ops import neighbor_agg
    return neighbor_agg(table, idx, w, self_rows, w_self, use_kernel=True,
                        kernel="tiled")


def _gat_layer(p, h_self, h_nb, mask):
    z_s = torch.einsum("...d,dhe->...he", h_self, p["w"])     # [..., H, dh]
    z_n = torch.einsum("...kd,dhe->...khe", h_nb, p["w"])     # [..., K, H, dh]
    e_s = torch.einsum("...he,he->...h", z_s, p["a_src"])     # [..., H]
    e_n = torch.einsum("...khe,he->...kh", z_n, p["a_dst"])   # [..., K, H]
    e = F.leaky_relu(e_s[..., None, :] + e_n, 0.2)
    e = torch.where(mask[..., None], e, torch.full_like(e, -1e30))
    # self edge always valid (jax.nn.leaky_relu's default slope, 0.01)
    e_self = F.leaky_relu(e_s + torch.einsum("...he,he->...h", z_s,
                                             p["a_dst"]), 0.01)[..., None, :]
    ea = torch.cat([e, e_self], dim=-2)                        # [...,K+1,H]
    alpha = torch.softmax(ea, dim=-2)
    zn_all = torch.cat([z_n, z_s[..., None, :, :]], dim=-3)
    out = torch.einsum("...kh,...khe->...he", alpha, zn_all)
    return out.reshape(out.shape[:-2] + (-1,))                 # concat heads


def agg_dtype(cfg: GNNConfig, h_dtype: torch.dtype) -> torch.dtype:
    """The aggregation traffic dtype: bf16 under ``dtype="bfloat16"``,
    else the table's own."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else h_dtype


# ---------------------------------------------------------------------------
# full-graph forward (ELL)
# ---------------------------------------------------------------------------

def full_graph_forward(params, cfg: GNNConfig, feats, ell_idx, ell_w,
                       w_self, return_layers=False):
    """feats [n, r]; ell_idx [n, K] int32; ell_w [n, K]; w_self [n] ->
    logits [n, C] (reference ``gnn.py:165-298`` without ``mesh`` /
    ``feats_plan``).

    * When a layer narrows (d_out < d_in) the linear transform runs
      BEFORE aggregation (Ã(hW) == (Ãh)W for GCN and the GraphSAGE
      neighbor branch), so the gather moves d_out-wide rows.
    * Aggregation traffic runs in ``cfg.dtype`` (bf16 at production
      scale): the gather source is cast once per layer.
    * With ``cfg.use_agg_kernel`` the gcn/graphsage aggregation runs
      through the CUDA gather kernel (no [n, K, d] gather is
      materialized), GCN's self term through its fused epilogue.  GAT
      keeps the einsum path.

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

    def agg_w(srcr, w_edge):
        """Σ_k w_edge[n,k] · srcr[ell_idx[n,k]]; ``srcr`` is the already
        cast table."""
        if cfg.use_agg_kernel:
            return _kernel_agg(cfg, srcr, ell_idx,
                               w_edge.to(agg_dt)).to(h.dtype)
        return torch.einsum("nk,nkd->nd", w_edge.to(agg_dt),
                            srcr[ell_idx.long()]).to(h.dtype)

    layers = []
    for li, p in enumerate(params):
        last = li == n_layers - 1
        if cfg.model == "gcn":
            w = p["w"]
            pre = w.shape[1] < h.shape[1]
            src = (h @ w) if pre else h
            srcr = src.to(agg_dt)
            if cfg.use_agg_kernel:
                # fused epilogue: the self row IS the source table row b
                agg = _kernel_agg(cfg, srcr, ell_idx, ell_w.to(agg_dt),
                                  self_rows=srcr,
                                  w_self=w_self.to(agg_dt)).to(h.dtype)
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
            nb = h.to(agg_dt)[ell_idx.long()].to(h.dtype)
            out = _gat_layer(p, h, nb, maskb)
            if last:
                heads = cfg.gat_heads
                out = out.reshape(out.shape[:-1] + (heads, -1)).mean(-2)
        h = out if last else torch.relu(out)
        if return_layers:
            layers.append(h)
    return (h, layers) if return_layers else h


def accuracy(logits, labels):
    return (torch.argmax(logits, -1) == labels).to(F32).mean()
