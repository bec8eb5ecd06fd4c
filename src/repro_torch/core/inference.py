"""Layer-wise full-graph GNN inference (the serving tier's embedding
pass) — the torch counterpart of the reference ``repro.core.inference``.

Layer-wise inference materializes ALL nodes' layer-l embeddings before
any layer-(l+1) work, so a k-layer model over n nodes costs O(k · n) ELL
gathers in total and every query afterwards is a table lookup.

The node axis is CHUNKED: each layer streams [chunk_size]-row slices of
the host ELL through the aggregation path — ``cfg.use_agg_kernel``
routes a chunk through the CUDA gather kernel (once per NODES shard of
``mesh`` when one is given), otherwise the einsum gather.  With a
``FeatShardPlan`` (``cfg.feats_layout == "sharded"``) each layer is one
featshard call over the row-sharded table instead, no chunks.  A
background ``Prefetcher`` thread stages the next chunk's ELL
rows into recycled (pinned, on the card) ``HostStagingRing`` buffers
while the device computes the current one; each upload is an
asynchronous copy whose completion event gates the slot's reuse.

Equivalence contract (tests/test_torch_serving.py): per-layer allclose
with ``full_graph_forward`` for every model and both aggregation paths
at any chunk size, and ``prefetch`` on/off bit-identical.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.core import faults
from repro_torch.core import gnn as G
from repro_torch.core.graph import Graph, to_ell
from repro_torch.core.prefetch import HostStagingRing, Prefetcher
from repro_torch.device import resolve_device


# ---------------------------------------------------------------------------
# Per-layer sources and the per-chunk layer step
# ---------------------------------------------------------------------------

def _pre_source(cfg: GNNConfig, p, h):
    """The full forward's width-shrinking trick, once per LAYER (not per
    chunk): when a layer narrows (d_out < d_in) the linear transform
    runs before aggregation (Ã(hW) == (Ãh)W), so every chunk gathers
    d_out-wide rows.  GAT gathers raw ``h`` (per-edge attention)."""
    wmat = p.get("w") if cfg.model == "gcn" else p.get("w_neigh")
    if wmat is not None and wmat.shape[1] < h.shape[1]:
        return h @ wmat
    return h


def _layer_sources(cfg: GNNConfig, p, h):
    """``(src, src_agg)``: the gather source and its ``agg_dt`` cast.
    The reference casts the whole [n, d] table inside every chunk call
    (``inference.py:94,107``); casting it once per layer here gives the
    same numbers (the same elementwise cast of the same table) at O(n)
    instead of O(n²/chunk) cast work."""
    src = _pre_source(cfg, p, h)
    return src, src.to(G.agg_dtype(cfg, h.dtype))


def _chunk_apply(cfg: GNNConfig, last: bool, p, h, src, src_agg, rows, idx,
                 w, w_self, mesh=None):
    """One node-chunk of one layer, mirroring ``full_graph_forward``'s
    per-layer body row-sliced to the chunk (reference
    ``inference.py:71-130``).

    ``h`` [n, d_in] is the full previous-layer table, ``src`` the
    (possibly pre-transformed) gather source and ``src_agg`` its
    ``agg_dt`` cast; ``rows`` [c] are the chunk's global node ids,
    ``idx``/``w`` [c, K] its ELL rows and ``w_self`` [c] the self-loop
    weights.  Padded tail rows carry zero weights and are trimmed by
    the caller.  ``mesh`` splits the kernel path's chunk rows over its
    NODES shards."""
    agg_dt = G.agg_dtype(cfg, h.dtype)
    maskb = w > 0
    mask = maskb.to(h.dtype)
    # cast the bool mask straight to agg_dt where aggregation consumes it
    mask_agg = mask if agg_dt == h.dtype else maskb.to(agg_dt)
    rows_l = rows.long()

    def agg_w(w_edge):
        if cfg.use_agg_kernel:
            return G._kernel_agg(cfg, src_agg, idx, w_edge.to(agg_dt),
                                 mesh=mesh).to(h.dtype)
        return torch.einsum("ck,ckd->cd", w_edge.to(agg_dt),
                            src_agg[idx.long()]).to(h.dtype)

    if cfg.model == "gcn":
        wmat = p["w"]
        pre = wmat.shape[1] < h.shape[1]
        if cfg.use_agg_kernel:
            # fused epilogue: the chunk's self rows come from the same
            # cast source table the kernel gathers from
            agg = G._kernel_agg(cfg, src_agg, idx, w.to(agg_dt),
                                self_rows=src_agg[rows_l],
                                w_self=w_self.to(agg_dt),
                                mesh=mesh).to(h.dtype)
        else:
            agg = agg_w(w) + w_self[:, None] * src[rows_l]
        out = agg if pre else agg @ wmat
    elif cfg.model == "graphsage":
        wn = p["w_neigh"]
        pre = wn.shape[1] < h.shape[1]
        cnt = torch.clamp(mask.sum(-1, keepdim=True), min=1.0)
        mean = agg_w(mask_agg) / cnt
        out = h[rows_l] @ p["w_self"] + (mean if pre else mean @ wn)
    else:  # gat — per-edge softmax attention stays on the einsum path
        h_rows = h[rows_l]
        nb = src_agg[idx.long()].to(h.dtype)      # src is h for GAT
        out = G._gat_layer(p, h_rows, nb, maskb)
        if last:
            heads = cfg.gat_heads
            out = out.reshape(out.shape[:-1] + (heads, -1)).mean(-2)
    return out if last else torch.relu(out)


def _featshard_layer(cfg: GNNConfig, last: bool, fsplan, p, h, w, w_self):
    """One WHOLE layer over the NODES-sharded table (``feats_layout =
    "sharded"``, reference ``inference.py:134-172``): no chunk loop and
    no replicated source; layer l's output feeds layer l+1 as it is.
    Mirrors ``full_graph_forward``'s gcn / graphsage bodies through
    ``neighbor_agg_featshard``; ``fsplan`` is the plan of THIS ELL and
    mesh."""
    from repro_torch.kernels.neighbor_agg.ops import neighbor_agg_featshard
    agg_dt = G.agg_dtype(cfg, h.dtype)
    if cfg.model == "gcn":
        wmat = p["w"]
        pre = wmat.shape[1] < h.shape[1]
        srcr = ((h @ wmat) if pre else h).to(agg_dt)
        agg = neighbor_agg_featshard(
            srcr, w.to(agg_dt), fsplan, self_rows=srcr,
            w_self=w_self.to(agg_dt)).to(h.dtype)
        out = agg if pre else agg @ wmat
    else:  # graphsage
        wn = p["w_neigh"]
        pre = wn.shape[1] < h.shape[1]
        src = (h @ wn) if pre else h
        maskb = w > 0
        mask = maskb.to(h.dtype)
        cnt = torch.clamp(mask.sum(-1, keepdim=True), min=1.0)
        # bool -> agg_dt directly (not via the f32 mask): one cast pass
        mask_agg = mask if agg_dt == h.dtype else maskb.to(agg_dt)
        mean = neighbor_agg_featshard(src.to(agg_dt), mask_agg,
                                      fsplan).to(h.dtype) / cnt
        out = h @ p["w_self"] + (mean if pre else mean @ wn)
    return out if last else torch.relu(out)


# ---------------------------------------------------------------------------
# Chunk staging pipeline (Prefetcher + HostStagingRing reuse)
# ---------------------------------------------------------------------------

class _ChunkStream:
    """Sequential [chunk_size]-row slices of the host ELL, staged into
    recycled ``HostStagingRing`` buffers — by a background ``Prefetcher``
    thread by default, so host-side slicing/padding overlaps the device
    compute of the previous chunk.  The chunk sequence CYCLES: one full
    pass per layer (``passes`` = n_layers), since the ELL rows are
    layer-independent."""

    def __init__(self, ell: Tuple[np.ndarray, np.ndarray, np.ndarray],
                 n: int, chunk_size: int, passes: int, device: torch.device,
                 prefetch: bool = True, depth: int = 2):
        self._idx, self._w, self._w_self = ell
        self.n = n
        self.cs = chunk_size
        self.K = self._idx.shape[1]
        self.n_chunks = -(-n // chunk_size)
        self.device = device
        # queued payloads (depth) + one being staged + one at the consumer
        self._ring = HostStagingRing(depth + 2,
                                     pin_memory=device.type == "cuda")
        counter = itertools.count()

        def sample_fn(rng, graph, batch_size, fanouts):
            return next(counter) % self.n_chunks

        self._sample = sample_fn
        self._pf: Optional[Prefetcher] = None
        if prefetch:
            self._pf = Prefetcher(
                None, 0, (), seed=0, depth=depth,
                n_batches=passes * self.n_chunks,
                payload_fn=self._stage, sample_fn=sample_fn)

    def _stage(self, graph, ci: int):
        """Copy chunk ``ci``'s ELL rows into a staging slot (padded to
        the fixed chunk width with zero-weight rows).  Runs on the
        Prefetcher worker thread."""
        c0 = ci * self.cs
        c1 = min(c0 + self.cs, self.n)
        m = c1 - c0
        specs = [((self.cs,), np.int32), ((self.cs, self.K), np.int32),
                 ((self.cs, self.K), np.float32), ((self.cs,), np.float32)]
        slot = self._ring.acquire()
        try:
            rows_b, idx_b, w_b, ws_b = self._ring.buffers(slot, specs)
            rows_b[:m] = np.arange(c0, c1, dtype=np.int32)
            idx_b[:m] = self._idx[c0:c1]
            w_b[:m] = self._w[c0:c1]
            ws_b[:m] = self._w_self[c0:c1]
            if m < self.cs:          # zero-weight padding rows
                rows_b[m:] = 0
                idx_b[m:] = 0
                w_b[m:] = 0.0
                ws_b[m:] = 0.0
        except BaseException:
            # never strand a slot on a dying worker
            self._ring.release(slot)
            raise
        return slot, m

    def next(self):
        """-> ((rows, idx, w, w_self) device tensors, n_valid, ticket).

        On the CPU the tensors ALIAS the slot's staging memory, so the
        slot stays taken until the chunk's compute has run (torch's CPU
        ops are synchronous: once ``_chunk_apply`` returns).  On the card
        the upload is an asynchronous copy from pinned memory; the
        ticket carries its completion event, and ``release`` waits for
        THAT (the copy), never merely for the launch."""
        if self._pf is not None:
            _, payload = self._pf.next()
        else:
            payload = self._stage(None, self._sample(None, None, 0, ()))
        slot, m = payload
        host = self._ring.tensors(slot)
        if self.device.type == "cpu":
            return tuple(host), m, (slot, None)
        dev = tuple(t.to(self.device, non_blocking=True) for t in host)
        copied = torch.cuda.Event()
        copied.record(torch.cuda.current_stream(self.device))
        return dev, m, (slot, copied)

    def release(self, ticket) -> None:
        slot, copied = ticket
        if copied is not None:
            copied.synchronize()
        self._ring.release(slot)

    def close(self):
        self._ring.close()
        if self._pf is not None:
            pf, self._pf = self._pf, None
            pf.close()


# ---------------------------------------------------------------------------
# Layer-wise inference
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class InferenceRun:
    """Per-layer embedding tables plus timing stats.

    ``layers[l]`` is the POST-activation [n, d_l] table (what feeds
    layer l+1); ``layers[-1]`` are the logits — per-layer equal to
    ``full_graph_forward(..., return_layers=True)``."""
    layers: List[torch.Tensor]
    stats: Dict[str, float]

    @property
    def logits(self):
        return self.layers[-1]


def _featshard_run(params, cfg: GNNConfig, feats, ell, fsplan,
                   dev: torch.device) -> InferenceRun:
    """The featshard inference pass (reference ``inference.py:278-338``):
    the per-layer tables row-sharded over ``fsplan.mesh`` end to end.  No
    chunk stream: each layer is one featshard call (phase 1 over the hot
    cache and local rows, one compacted miss all_gather, phase 2), and a
    shard holds (n/S + C)·d table values, never a whole table."""
    from repro_torch import sharding as sh
    if cfg.model not in ("gcn", "graphsage") or not cfg.use_agg_kernel:
        raise ValueError(
            "featshard inference needs use_agg_kernel=True and a "
            f"gcn/graphsage model, got model={cfg.model!r}, "
            f"use_agg_kernel={cfg.use_agg_kernel} (GAT's attention "
            "gather is not a weighted sum — use the chunked path)")
    _, w, w_self = ell
    n = int(feats.shape[0])
    pad = fsplan.n_pad - n
    if pad < 0 or tuple(w.shape) != (n, fsplan.K):
        raise ValueError(
            f"featshard inference: ELL shape {tuple(w.shape)} does not "
            f"match the plan (n_pad={fsplan.n_pad}, K={fsplan.K}) — build "
            f"the plan from THIS ell/mesh (layerwise_embeddings does)")
    if fsplan.mesh.device_type != dev.type:
        raise ValueError(f"featshard inference: the plan's mesh "
                         f"{fsplan.mesh} and the device {dev} differ")
    # zero rows and weights: padded rows aggregate to zero
    h = sh.pad_rows(torch.as_tensor(feats, device=dev), fsplan.S)
    acct = fsplan.accounting(cfg, h.shape[1], h.element_size())
    w_d = torch.as_tensor(sh.pad_rows(np.asarray(w), fsplan.S)).to(dev)
    ws_d = torch.as_tensor(sh.pad_rows(np.asarray(w_self), fsplan.S)).to(dev)
    layers: List[torch.Tensor] = []
    per_layer: List[float] = []
    t0 = time.perf_counter()
    with torch.no_grad():
        for li, p in enumerate(params):
            lt0 = time.perf_counter()
            last = li == len(params) - 1
            h = _featshard_layer(cfg, last, fsplan, p, h, w_d, ws_d)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            # h stays padded and row-sharded for the next layer; the
            # returned table is trimmed to the real rows
            layers.append(h[:n] if pad else h)
            per_layer.append(round(time.perf_counter() - lt0, 6))
            faults.maybe_crash("infer.after_layer")
    total = time.perf_counter() - t0
    stats = {
        "n_nodes": n, "n_layers": len(params), "chunk_size": n,
        "n_chunks": 1, "chunk_steps": len(params),
        "total_s": round(total, 6), "per_layer_s": per_layer,
        "ms_per_node": round(1000.0 * total / n, 6), **acct,
    }
    return InferenceRun(layers=layers, stats=stats)


def layerwise_layers(params, cfg: GNNConfig, feats,
                     ell: Tuple[np.ndarray, np.ndarray, np.ndarray], *,
                     chunk_size: int = 1024, prefetch: bool = True,
                     device="cuda", mesh=None,
                     feats_plan=None) -> InferenceRun:
    """Layer-wise inference over host ELL arrays ``(idx, w, w_self)``.

    ``feats`` is a numpy array or a tensor (moved to ``device``).  Per
    layer: the (optional) width-shrinking pre-transform and the
    ``agg_dt`` cast run ONCE on the full table, then every node chunk
    aggregates against it; the concatenated rows become the next
    layer's table.  Memory high-water mark is O(n · d) tables plus one
    [chunk, K, d] gather on the einsum path (none on the kernel path).
    ``mesh`` splits each chunk's kernel launches over its NODES shards.

    ``feats_plan`` (a ``FeatShardPlan`` built from THIS ell) switches to
    the row-sharded table pass (``_featshard_run``): chunking and
    ``mesh`` are ignored — the plan's mesh partitions everything."""
    dev = resolve_device(device)
    if feats_plan is not None:
        return _featshard_run(params, cfg, feats, ell, feats_plan, dev)
    n = int(feats.shape[0])
    if n == 0:
        raise ValueError("layerwise_layers: empty graph (n=0)")
    cs = max(1, min(int(chunk_size) if chunk_size else n, n))
    h = torch.as_tensor(feats, device=dev)
    stream = _ChunkStream(ell, n, cs, passes=len(params), device=dev,
                          prefetch=prefetch)
    layers: List[torch.Tensor] = []
    per_layer: List[float] = []
    t0 = time.perf_counter()
    try:
        for li, p in enumerate(params):
            lt0 = time.perf_counter()
            last = li == len(params) - 1
            src, src_agg = _layer_sources(cfg, p, h)
            outs = []
            for _ in range(stream.n_chunks):
                (rows, cidx, cw, cws), m, ticket = stream.next()
                out = _chunk_apply(cfg, last, p, h, src, src_agg, rows,
                                   cidx, cw, cws, mesh=mesh)
                stream.release(ticket)
                outs.append(out if m == cs else out[:m])
            h = outs[0] if len(outs) == 1 else torch.cat(outs, 0)
            if dev.type == "cuda":           # the layer time is device time
                torch.cuda.synchronize(dev)
            layers.append(h)
            per_layer.append(round(time.perf_counter() - lt0, 6))
            faults.maybe_crash("infer.after_layer")
    finally:
        stream.close()
    total = time.perf_counter() - t0
    stats = {
        "n_nodes": n, "n_layers": len(params), "chunk_size": cs,
        "n_chunks": stream.n_chunks,
        "chunk_steps": len(params) * stream.n_chunks,
        "total_s": round(total, 6),
        "per_layer_s": per_layer,
        "ms_per_node": round(1000.0 * total / n, 6),
    }
    return InferenceRun(layers=layers, stats=stats)


def featshard_plan_for(cfg: GNNConfig, graph: Graph, ell, mesh):
    """The featshard plan of an inference ELL ``(idx, w, w_self)`` when
    ``cfg`` asks for the row-sharded table (``feats_layout ==
    "sharded"``, the kernel on, gcn / graphsage) on ``mesh``; else
    None.  Built from THIS ELL (the full neighborhood has its own K),
    not reused from training."""
    if not (cfg.feats_layout == "sharded" and cfg.use_agg_kernel
            and mesh is not None and cfg.model in ("gcn", "graphsage")):
        return None
    from repro_torch.kernels.neighbor_agg.featshard import plan_for
    idx, w, _ = ell
    return plan_for(idx, w, graph.degrees, mesh, cfg.feat_cache_rows)


def layerwise_embeddings(params, cfg: GNNConfig, graph: Graph, *,
                         max_deg: Optional[int] = None,
                         chunk_size: int = 1024, prefetch: bool = True,
                         device="cuda", mesh=None,
                         feats_plan=None) -> InferenceRun:
    """Layer-wise inference straight from a ``Graph`` (ELL derived here;
    ``max_deg=None`` keeps ALL neighbors — inference uses the full
    neighborhood, §4.1).  Under ``cfg.feats_layout == "sharded"`` with
    the kernel on and a ``mesh``, a featshard plan is built from this
    ELL and the row-sharded table pass runs instead of the chunks."""
    ell = to_ell(graph, max_deg=max_deg)
    if feats_plan is None:
        feats_plan = featshard_plan_for(cfg, graph, ell, mesh)
    return layerwise_layers(params, cfg, graph.feats, ell,
                            chunk_size=chunk_size, prefetch=prefetch,
                            device=device, mesh=mesh,
                            feats_plan=feats_plan)


def layerwise_logits(params, cfg: GNNConfig, graph: Graph,
                     **kw) -> torch.Tensor:
    """Final-layer logits [n, C] only."""
    return layerwise_embeddings(params, cfg, graph, **kw).logits
