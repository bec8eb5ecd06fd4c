"""NODES-sharded feature tables with a degree-ordered hot cache (the
torch counterpart of the reference ``repro/kernels/neighbor_agg/
featshard.py``).

``neighbor_agg_sharded`` lets every shard read the whole ``[n, d]``
table.  Here the table is row-sharded instead (row ``i`` is owned by
shard ``i // (n_pad / S)``, the layout ``ShardedFullGraphSource``
uploads), and:

- a **hot cache**, the C highest-degree rows, is rebuilt on every shard
  per call (one ``all_gather`` of each owner's hot rows);
- each shard's ELL entries are split once, at plan build on the host,
  into *hits* (hot or local rows) and *misses* (remote rows): phase 1
  runs the tiled kernel over ``concat(hot, local)``; the misses are
  compacted into per-owner serve lists that move in ONE ``all_gather``,
  and phase 2 runs the tiled kernel over that ``[S·M, d]`` buffer with
  the fused self epilogue as accumulator (``self_rows`` = the phase-1
  output, ``w_self`` = 1);
- the backward sends the table gradient back to the owners: a
  ``psum_scatter`` of the ``[S·M, d]`` serve gradients and a ``psum`` of
  the C hot rows only, never of ``[n, d]``.  Both phases' table
  gradients come from the reverse-index kernel (an index per shard and
  phase, built with the plan).

The tables, the serve buffer and the weights stay in the table's dtype;
each phase's tiled launch writes its sum in f32, so the phase-1 partial
reaches phase 2 unrounded and a row's forward sum rounds to the table's
dtype once, as one unsharded launch rounds it (the reference rounds the
phase-1 partial to the table's dtype).  The backward is the reference's:
each part of the table gradient in the table's dtype, then summed.

On a multi-card layout a shard would hold ``(n/S + C)·d`` table values
(``table_bytes_per_device``) and receive ``(S-1)·(M + C_max)`` rows per
call (``remote_bytes_per_call``); with the shards on one card they
slice one padded table.  On a process-group mesh (one process a shard)
that is what a rank holds: its plan arrays, its ``n_pad / S`` rows of
the table, and the two all-gathers and the backward's ``psum_scatter``
and ``psum`` cross processes; the plan is built on every rank's host
from the global ELL.  The plan is static per (ELL, mesh, C); on
one shard every reference is hot or local, there is no miss, and the op
is bit-equal to the unsharded kernel path, forward and gradients.
Launches: S phase-1 and, with misses, S phase-2 tiled launches per call
(``launch_counts()``, counted where they run the CUDA kernel).
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

#: tiled launches of each phase on CUDA tensors
phase1_launches = 0
phase2_launches = 0
_count_lock = threading.Lock()


def reset_launches() -> None:
    global phase1_launches, phase2_launches
    with _count_lock:
        phase1_launches = phase2_launches = 0


def launch_counts() -> dict:
    """Tiled-kernel launches of each phase (on CUDA tensors; the CPU
    runs the plain version and counts nothing)."""
    return {"phase1": phase1_launches, "phase2": phase2_launches}


def _count(phase: int) -> None:
    global phase1_launches, phase2_launches
    with _count_lock:
        if phase == 1:
            phase1_launches += 1
        else:
            phase2_launches += 1


def resolve_cache_rows(cache_rows: Optional[int], n: int) -> int:
    """Hot-cache size C for ``GNNConfig.feat_cache_rows``: ``-1``/None →
    auto (n // 8, at least 1), ``0`` → no cache, else min(cache_rows, n).
    Only REAL rows (< n) are cacheable; padding rows have no edges."""
    if cache_rows is None or cache_rows < 0:
        return min(n, max(1, n // 8))
    return min(int(cache_rows), n)


# ---------------------------------------------------------------------------
# Host-side plan build (numpy, copied from the reference)
# ---------------------------------------------------------------------------

def _plan_arrays(idx, w, degrees, n_shards: int, cache_rows: int) -> dict:
    """Classify every ELL entry against the (owner-map, hot-set) split and
    build the remapped per-shard index arrays.

    ``idx``/``w`` are the HOST ELL arrays already padded to an
    ``n_shards`` multiple of rows (zero-weight padding entries are
    treated as hits so they never generate serve traffic); ``degrees``
    ranks the n REAL rows for the hot set.
    """
    from repro_torch import sharding as sh
    idx = np.asarray(idx)
    w = np.asarray(w)
    n_pad, K = idx.shape
    S = int(n_shards)
    if n_pad % S:
        raise ValueError(
            f"featshard plan: n_pad={n_pad} rows must divide the {S} "
            f"NODES shards (pad with zero-weight rows first)")
    n_loc = n_pad // S
    n = int(np.asarray(degrees).shape[0])
    C = resolve_cache_rows(cache_rows, n)

    # degree-ordered hot set (stable sort: deterministic under ties)
    order = np.argsort(-np.asarray(degrees, np.float64), kind="stable")
    hot_ids = order[:C].astype(np.int64)
    slot_of = np.full(n_pad, -1, np.int64)
    slot_of[hot_ids] = np.arange(C, dtype=np.int64)

    owner = sh.row_owner(n_pad, S).astype(np.int64)       # owner map
    j = idx.astype(np.int64)
    nz = w != 0
    is_hot = slot_of[j] >= 0
    b_owner = owner[:, None]                              # shard of row b
    is_local = owner[j] == b_owner
    miss = nz & ~(is_hot | is_local)

    # phase 1: indices into concat(hot[C], local[n_loc]).  Every hot or
    # local reference keeps its faithful remap EVEN at zero weight, so
    # dw = <g, table[lidx]> matches the unsharded kernel bit-for-bit
    # wherever the row is reachable; only remote rows (misses, plus
    # zero-weight remote refs that must not join the serve set) point at
    # row 0 with zero effective weight.
    lidx_hot = np.where(is_hot, slot_of[j], C + (j - b_owner * n_loc))
    lidx_hot = np.where(is_hot | is_local, lidx_hot, 0).astype(np.int32)
    hot_mask = (~miss).astype(np.float32)

    # phase 2: compacted per-owner serve lists.  The gathered buffer is
    # laid out [S * M] identically on every shard (owner-major), so miss
    # indices owner*M + pos are shard-independent.
    j_miss = j[miss]
    miss_owner = owner[j_miss]
    serve_ids = [np.unique(j_miss[miss_owner == t]) for t in range(S)]
    M = int(max((len(s) for s in serve_ids), default=0))
    lidx_miss = np.zeros((n_pad, K), np.int32)
    serve_loc = np.zeros((S, max(M, 1)), np.int32)
    if M:
        pos_of = np.zeros(n_pad, np.int64)
        for t, ids in enumerate(serve_ids):               # disjoint by owner
            pos_of[ids] = np.arange(len(ids))
            serve_loc[t, : len(ids)] = ids - t * n_loc
        lidx_miss = np.where(miss, owner[j] * M + pos_of[j], 0
                             ).astype(np.int32)

    # hot-cache (re)build plumbing: which LOCAL rows each shard owns of
    # the hot set, and the static permutation that reassembles the
    # all_gathered owner-major parts back into slot order.
    C_max = 0
    hot_src_loc = hot_slot = hot_valid = hot_perm = None
    if C:
        hot_owner = owner[hot_ids]
        slots_by_t = [np.nonzero(hot_owner == t)[0] for t in range(S)]
        C_max = int(max(len(s) for s in slots_by_t))      # >= 1 when C > 0
        hot_src_loc = np.zeros((S, C_max), np.int32)
        hot_slot = np.zeros((S, C_max), np.int32)
        hot_valid = np.zeros((S, C_max), np.float32)
        hot_perm = np.zeros(C, np.int32)
        for t, slots in enumerate(slots_by_t):
            q = len(slots)
            hot_src_loc[t, :q] = hot_ids[slots] - t * n_loc
            hot_slot[t, :q] = slots
            hot_valid[t, :q] = 1.0
            hot_perm[slots] = t * C_max + np.arange(q)

    nz_total = int(nz.sum())
    n_miss = int(miss.sum())
    n_hot = int((nz & is_hot).sum())
    n_local = int((nz & is_local & ~is_hot).sum())
    stats = {
        "feat_table_shards": S,
        "feat_cache_rows": C,
        "feat_cache_hot_hits": n_hot,
        "feat_cache_local_hits": n_local,
        "feat_cache_misses": n_miss,
        "feat_cache_hit_rate": ((nz_total - n_miss) / nz_total
                                if nz_total else 1.0),
        # rows RECEIVED per device per aggregation call: the serve
        # all_gather ((S-1)·M remote rows) + the hot-cache fill
        # ((S-1)·C_max remote rows)
        "remote_rows_per_call": (S - 1) * (M + C_max),
    }
    return {
        "S": S, "n": n, "n_pad": n_pad, "n_loc": n_loc, "K": K,
        "C": C, "M": M, "C_max": C_max,
        "hot_ids": hot_ids,
        "lidx_hot": lidx_hot, "hot_mask": hot_mask,
        "lidx_miss": lidx_miss, "serve_loc": serve_loc,
        "hot_src_loc": hot_src_loc, "hot_slot": hot_slot,
        "hot_valid": hot_valid, "hot_perm": hot_perm,
        "stats": stats,
    }


# ---------------------------------------------------------------------------
# Device-resident plan
# ---------------------------------------------------------------------------

class FeatShardPlan:
    """The featshard plan of one (ELL, mesh, C) on the mesh's devices:
    per shard its phase-1 ids ``lidx_hot[s]`` [n_loc, K], and with misses
    (M > 0) ``hot_mask[s]``, ``lidx_miss[s]`` and ``serve_loc[s]`` [M];
    with a hot cache (C > 0) ``hot_src_loc[s]`` / ``hot_slot[s]`` /
    ``hot_valid[s]`` [C_max] and ``hot_perm[s]`` [C]; and the reverse
    indexes of both phases (``rev1[s]`` over C + n_loc rows, ``rev2[s]``
    over S·M rows), built once here.  Identity-hashed: the sources
    memoize it per graph."""

    def __init__(self, mesh, host: dict, w_host):
        from repro_torch.kernels.neighbor_agg.ops import build_reverse_index
        self.mesh = mesh
        for k in ("S", "n", "n_pad", "n_loc", "K", "C", "M", "C_max"):
            setattr(self, k, host[k])
        self.hot_ids = host["hot_ids"]
        self.stats = dict(host["stats"])
        n_loc = self.n_loc
        w_host = np.asarray(w_host, np.float32)

        def rows(a, s):
            return a[s * n_loc:(s + 1) * n_loc]

        def put(a, dev, dtype):
            return torch.as_tensor(np.ascontiguousarray(a)).to(
                device=dev, dtype=dtype)

        I32, I64, F32 = torch.int32, torch.int64, torch.float32
        self.lidx_hot, self.hot_mask, self.lidx_miss = [], [], []
        self.serve_loc, self.hot_src_loc, self.hot_slot = [], [], []
        self.hot_valid, self.hot_perm, self.rev1, self.rev2 = [], [], [], []
        for s, dev in zip(mesh.traced, mesh.devices):
            lh = put(rows(host["lidx_hot"], s), dev, I32)
            hm = rows(host["hot_mask"], s)
            w_s = rows(w_host, s)
            self.lidx_hot.append(lh)
            self.rev1.append(build_reverse_index(
                lh, put(w_s * hm, dev, F32), self.C + n_loc))
            if self.M:
                lm = put(rows(host["lidx_miss"], s), dev, I32)
                self.hot_mask.append(put(hm, dev, F32))
                self.lidx_miss.append(lm)
                self.serve_loc.append(put(host["serve_loc"][s], dev, I64))
                self.rev2.append(build_reverse_index(
                    lm, put(w_s * (1.0 - hm), dev, F32), self.S * self.M))
            if self.C:
                self.hot_src_loc.append(put(host["hot_src_loc"][s], dev, I64))
                self.hot_slot.append(put(host["hot_slot"][s], dev, I64))
                self.hot_valid.append(put(host["hot_valid"][s], dev, F32))
                self.hot_perm.append(put(host["hot_perm"], dev, I64))

    def accounting(self, cfg, d: int, feats_itemsize: int) -> dict:
        """The plan's stats with its model of a multi-card layout at table
        width ``d``: ``feat_table_bytes_per_device`` and
        ``feat_remote_gather_bytes``, priced at the aggregation dtype
        (bf16 under ``cfg.dtype == "bfloat16"``, else the features' own
        ``feats_itemsize``).  A model, not the bytes resident here: with
        the shards on one card, they slice one padded table."""
        item = 2 if cfg.dtype == "bfloat16" else int(feats_itemsize)
        return dict(self.stats,
                    feat_table_bytes_per_device=self.table_bytes_per_device(
                        d, item),
                    feat_remote_gather_bytes=self.remote_bytes_per_call(
                        d, item))

    def table_bytes_per_device(self, d: int, itemsize: int = 4) -> int:
        """Resident gather-source bytes per shard: the local row block
        plus the hot cache — (n/S + C)·d, not n·d."""
        return (self.n_loc + self.C) * d * itemsize

    def remote_bytes_per_call(self, d: int, itemsize: int = 4) -> int:
        """Bytes received per shard per aggregation call (the compacted
        serve all_gather and the hot-cache fill)."""
        return self.stats["remote_rows_per_call"] * d * itemsize


def build_featshard_plan(idx, w, degrees, mesh,
                         cache_rows: int = -1) -> FeatShardPlan:
    """The featshard plan from HOST ELL arrays (padded to a shard-count
    multiple of rows; ``ShardedFullGraphSource`` pads at bind) and the
    per-node degrees."""
    from repro_torch import sharding as sh
    host = _plan_arrays(idx, w, degrees, sh.nodes_shards(mesh), cache_rows)
    return FeatShardPlan(mesh, host, w)


def plan_for(idx, w, degrees, mesh, cache_rows: int = -1) -> FeatShardPlan:
    """``build_featshard_plan`` from UNPADDED host ELL arrays: their rows
    are padded with zero-weight entries to a shard-count multiple
    first (the layout the sharded sources and inference use)."""
    from repro_torch import sharding as sh
    return build_featshard_plan(sh.pad_rows(idx, mesh.size),
                                sh.pad_rows(w, mesh.size), degrees, mesh,
                                cache_rows=cache_rows)


# ---------------------------------------------------------------------------
# The two-phase op
# ---------------------------------------------------------------------------

def _hot_tables(plan: FeatShardPlan, local):
    """Each shard's [C, d] hot cache from the sharded table: every shard
    contributes the hot rows it owns, one all_gather of the [S·C_max, d]
    owner-major parts, then the static slot permutation.  Values follow
    the call's table; the id set is fixed per plan."""
    from repro_torch import sharding as sh
    parts = [torch.index_select(f, 0, src)
             for f, src in zip(local, plan.hot_src_loc)]
    gathered = sh.all_gather(parts, plan.mesh)
    return [torch.index_select(g, 0, perm)
            for g, perm in zip(gathered, plan.hot_perm)]


def _serve_buffers(plan: FeatShardPlan, local):
    """The compacted miss move: each shard serves its [M] requested local
    rows, one all_gather -> the owner-major [S·M, d] buffer phase 2
    gathers from."""
    from repro_torch import sharding as sh
    parts = [torch.index_select(f, 0, sl)
             for f, sl in zip(local, plan.serve_loc)]
    return sh.all_gather(parts, plan.mesh)


def _phase_forward(phase: int, table, idx, w, self_rows, w_self):
    """One phase's tiled launch, its output (the partial sum) in f32."""
    from repro_torch.kernels.neighbor_agg.ops import (_check_kernel_args,
                                                      _forward)
    f32 = torch.float32
    _check_kernel_args(table, idx, w, self_rows, w_self, out_dtype=f32)
    out = _forward("tiled", table, idx, w, self_rows, w_self, out_dtype=f32)
    if table.device.type == "cuda":
        _count(phase)
    return out


class _FeatShardAgg(torch.autograd.Function):
    """The two-phase op of one plan (reference ``featshard._make_op``)."""

    @staticmethod
    def forward(ctx, feats, w, self_rows, w_self, plan):
        from repro_torch import sharding as sh
        from repro_torch.kernels.neighbor_agg.ops import _shard_blocks
        blocks = _shard_blocks(plan.mesh, feats, w, self_rows, w_self)
        local = [blk[0] for blk in blocks]
        # the serve gather depends only on the local blocks: issued first
        served = _serve_buffers(plan, local) if plan.M else None
        hot = _hot_tables(plan, local) if plan.C else None
        tables1, w1s, w2s, outs = [], [], [], []
        for s, (f_s, w_s, sr_s, ws_s) in enumerate(blocks):
            table1 = torch.cat([hot[s], f_s], 0) if plan.C else f_s
            w1 = w_s * plan.hot_mask[s].to(w_s.dtype) if plan.M else w_s
            if sr_s is not None:      # the epilogue reads the output dtype
                sr_s, ws_s = sr_s.float(), ws_s.float()
            out = _phase_forward(1, table1, plan.lidx_hot[s], w1, sr_s, ws_s)
            w2 = None
            if plan.M:
                # phase 2 accumulates the cold rows into the same output
                # through the fused epilogue: self_rows = the phase-1
                # partial, w_self = 1
                w2 = w_s * (1.0 - plan.hot_mask[s]).to(w_s.dtype)
                ones = torch.ones(out.shape[0], dtype=out.dtype,
                                  device=out.device)
                out = _phase_forward(2, served[s], plan.lidx_miss[s], w2,
                                     out, ones)
            tables1.append(table1)
            w1s.append(w1)
            w2s.append(w2)
            outs.append(out)
        ctx.save_for_backward(feats, w, self_rows, w_self)
        ctx.plan = plan
        ctx.tables1, ctx.served, ctx.w1s, ctx.w2s = tables1, served, w1s, w2s
        return sh.unshard_rows(outs, feats.device).to(feats.dtype)

    @staticmethod
    def backward(ctx, g):
        from repro_torch import sharding as sh
        from repro_torch.kernels.neighbor_agg.ops import (_grads,
                                                          _shard_blocks)
        feats, w, self_rows, w_self = ctx.saved_tensors
        plan = ctx.plan
        fused = self_rows is not None
        need_f, need_w, need_s, need_ws, _ = ctx.needs_input_grad
        need = (need_f, need_w, need_s and fused, need_ws and fused)
        blocks = _shard_blocks(plan.mesh, self_rows, w_self, g.contiguous())
        df1s, dgaths, dws, dsrs, dwss = [], [], [], [], []
        for s, (sr_s, ws_s, g_s) in enumerate(blocks):
            # phase 2's cotangent into the phase-1 partial is exactly g
            # (w_self = 1), so phase 1 backpropagates g directly
            df1, dw1, dsr, dws_ = _grads(
                ctx.tables1[s], plan.lidx_hot[s], ctx.w1s[s], g_s, sr_s,
                ws_s, need, plan.rev1[s])
            dw = dw1
            if plan.M:
                dgath, dw2, _, _ = _grads(
                    ctx.served[s], plan.lidx_miss[s], ctx.w2s[s], g_s, None,
                    None, (need[0], need[1], False, False), plan.rev2[s])
                dgaths.append(dgath)
                if need[1]:
                    dw = torch.where(plan.hot_mask[s] > 0, dw1, dw2)
            df1s.append(df1)
            dws.append(dw)
            dsrs.append(dsr)
            dwss.append(dws_)
        dfeats = None
        if need[0]:
            C = plan.C
            dloc = [df1[C:] for df1 in df1s]
            if plan.M:
                # the cold-row gradients go back to their OWNERS: each
                # shard gets its [M, d] serve slice summed over requesters
                dserve = sh.psum_scatter(dgaths, plan.mesh)
                for s in range(len(dloc)):
                    dloc[s].index_add_(0, plan.serve_loc[s], dserve[s])
            if C:
                # only the C hot rows cross every shard
                dhot = sh.psum([df1[:C] for df1 in df1s], plan.mesh)
                for s in range(len(dloc)):
                    back = (torch.index_select(dhot[s], 0, plan.hot_slot[s])
                            * plan.hot_valid[s][:, None])
                    dloc[s].index_add_(0, plan.hot_src_loc[s],
                                       back.to(dloc[s].dtype))
            dfeats = sh.unshard_rows(dloc, feats.device)

        def rows(parts, j, like):
            return (sh.unshard_rows(parts, feats.device).to(like.dtype)
                    if need[j] else None)
        return (dfeats, rows(dws, 1, w), rows(dsrs, 2, self_rows),
                rows(dwss, 3, w_self), None)


def neighbor_agg_featshard(feats, w, plan: FeatShardPlan, self_rows=None,
                           w_self=None):
    """``out[b] = Σ_k w[b,k]·feats[idx[b,k]] [+ w_self[b]·self_rows[b]]``
    with the SOURCE TABLE row-sharded over the plan's NODES mesh
    (reference ``neighbor_agg_featshard``): phase 1 over the hot cache
    and the local rows, phase 2 accumulating the cold rows gathered in
    one all_gather, and an owner scatter-add backward.

    ``feats`` [n_pad, d] and ``self_rows`` [n_pad, d] are NODES-row
    sharded; ``w`` [n_pad, K] / ``w_self`` [n_pad] row-sharded with the
    zero pattern the plan was built from (the plan holds the remapped
    ids, so ``ell_idx`` is not an operand).  The output rows stay
    NODES-sharded.  On a process-group mesh every operand and the
    output are this rank's ``n_pad / S`` rows.  On one shard this is
    bit-equal to ``neighbor_agg(..., use_kernel=True)``, forward and
    gradients."""
    fused = self_rows is not None
    if fused != (w_self is not None):
        raise ValueError("self_rows and w_self must be passed together")
    rows = plan.n_loc if plan.mesh.rank_local else plan.n_pad
    if feats.shape[0] != rows or tuple(w.shape) != (rows, plan.K):
        raise ValueError(
            f"neighbor_agg_featshard: operands (feats "
            f"{tuple(feats.shape)}, w {tuple(w.shape)}) do not match the "
            f"plan ({rows} rows, K={plan.K}) — rebuild the plan for "
            f"this ELL/mesh")
    return _FeatShardAgg.apply(feats, w, self_rows, w_self, plan)
