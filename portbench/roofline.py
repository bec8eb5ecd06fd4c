"""The yardstick's arithmetic: one H100's peaks, the neighbor-aggregation
kernels' byte and operation model, and the FLOPs of a full-graph
training step of GCN and GraphSAGE, all counted from shapes.

The peaks, ``least_ms``, ``agg_cost``, ``csr_cost`` and the two bounds
are a frozen copy of the port's ``src/repro_torch/kernels/cost.py``, so
that a later change to the port's model cannot move this benchmark's
numbers: each function names the lines it was copied from.  One
departure: ``agg_cost`` counts the edges a call needs where ``cost.py``
counts the padded ELL's ``b * k`` slots, so that a kernel is held to
the work of its inputs whatever layout it reads them in.  The step's
layer plan follows ``src/repro_torch/core/gnn.py:full_graph_forward``
(a layer that narrows, ``d_out < d_in``, transforms before it
aggregates; GCN adds its self term in the kernel's fused epilogue).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# --- NVIDIA H100 SXM (data sheet, dense); cost.py:22-28 ---------------------
F32_FLOPS_PER_S = 67e12       # f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12     # device memory rate


def least_ms(nbytes: float, flops: float, rate: float) -> Tuple[float, str]:
    """The least time (ms) for ``nbytes`` over the HBM rate against
    ``flops`` over ``rate``, and which of the two bounds it
    (``cost.py:52-57``)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def agg_cost(n: int, b: int, edges: int, d: int, el: int,
             out_el: Optional[int] = None, fused: bool = False,
             rows: Optional[int] = None) -> Tuple[int, int]:
    """(bytes, f32 FLOPs) of one tiled forward call over ``edges`` kept
    edges: each distinct referenced feature row, the edges' ids and
    weights and out (and, fused, self_rows and w_self) once; a
    multiply-add per (edge, column) (``cost.py:60-77``, which counts the
    ELL's ``b * k`` slots: here the padding's ids and weights are not
    counted, as no input needs them)."""
    oel = el if out_el is None else out_el
    rows = min(n, edges) if rows is None else rows
    nbytes = rows * d * el + edges * 4 + edges * el + b * d * oel
    flops = 2 * edges * d
    if fused:
        nbytes += b * d * oel + b * oel
        flops += 2 * b * d
    return nbytes, flops


def csr_cost(n: int, b: int, nnz: int, d: int, el: int) -> Tuple[int, int]:
    """(bytes, f32 FLOPs) of one reverse-index backward call: g, the kept
    edges' weights, indptr and edges read once, dfeats written once; a
    multiply-add per kept edge and column (``cost.py:124-130``)."""
    nbytes = b * d * el + nnz * el + (n + 1) * 4 + nnz * 4 + n * d * el
    return nbytes, 2 * nnz * d


def bound(n: int, b: int, edges: int, d: int, el: int, rows: int,
          fused: bool, out_el: Optional[int] = None) -> tuple:
    """The least time for one tiled forward call on a table [n, d] of
    ``el``-byte elements, ``b`` output rows over ``edges`` kept edges
    that reference ``rows`` distinct rows, against its f32 multiply-adds
    over the f32 rate (``cost.py:144-154``, with the tensors replaced by
    their sizes).  Returns (ms, "bytes" | "operations", bytes)."""
    nbytes, flops = agg_cost(n, b, edges, d, el, out_el, fused, rows=rows)
    return least_ms(nbytes, flops, F32_FLOPS_PER_S) + (nbytes,)


def bound_bwd_csr(n: int, b: int, nnz: int, d: int, el: int) -> tuple:
    """The least time for one reverse-index backward call over ``nnz``
    kept edges (``cost.py:181-187``, with the index replaced by its
    sizes).  Returns (ms, "bytes" | "operations", bytes)."""
    nbytes, flops = csr_cost(n, b, nnz, d, el)
    return least_ms(nbytes, flops, F32_FLOPS_PER_S) + (nbytes,)


# --- a full-graph training step ---------------------------------------------

def layer_dims(feat_dim: int, hidden: int, n_classes: int,
               n_layers: int) -> List[Tuple[int, int]]:
    """(d_in, d_out) of each layer (``core/gnn.py:layer_dims``)."""
    dims, d_in = [], feat_dim
    for li in range(n_layers):
        d_out = n_classes if li == n_layers - 1 else hidden
        dims.append((d_in, d_out))
        d_in = d_out
    return dims


def layer_plan(model: str, dims) -> List[Dict]:
    """What each layer of a full-graph step runs: the aggregation's
    width ``agg_d``, whether its self term is fused (GCN), whether the
    backward aggregates (the table needs a gradient: a layer past the
    first, or one that transformed before it aggregated), and the
    ``(a, b)`` of each dense product ``[n, a] @ [a, b]`` (or its
    transposes), forward and backward, every one with ``n`` rows."""
    if model not in ("gcn", "graphsage"):
        raise ValueError(f"no step model for {model!r}")
    plan = []
    for li, (d_in, d_out) in enumerate(dims):
        pre = d_out < d_in
        first = li == 0
        agg_bwd = pre or not first
        if model == "gcn":
            fwd = [(d_in, d_out)]
            # dW; then dh (through W before the aggregation when pre,
            # after it otherwise), needed past the first layer only
            bwd = [(d_in, d_out)] + ([] if first else [(d_out, d_in)])
        else:
            fwd = [(d_in, d_out), (d_in, d_out)]     # h @ Ws, (.) @ Wn
            bwd = [(d_in, d_out), (d_in, d_out)]     # dWs, dWn
            if not first:                            # dh through both
                bwd += [(d_out, d_in), (d_out, d_in)]
        plan.append({"agg_d": d_out if pre else d_in, "fused": model == "gcn",
                     "agg_bwd": agg_bwd, "fwd": fwd, "bwd": bwd})
    return plan


def product_cost(n: int, a: int, b: int) -> Tuple[int, int]:
    """(bytes, FLOPs) of one f32 product with ``n`` rows: its three
    operands moved once, a multiply-add per (row, a, b)."""
    return 4 * (n * a + n * b + a * b), 2 * n * a * b


def step_flops(model: str, dims, n: int, kept: int,
               train: bool = True) -> Dict[str, int]:
    """FLOPs of one full-graph step (``train``: forward and backward) or
    of one evaluation forward, counted from the shapes: ``dense`` the
    products, ``agg`` the aggregations' multiply-adds over the ``kept``
    edges (and, for GCN, the ``n`` self rows), forward and, where the
    backward aggregates, backward.  Recomputation, the loss and
    elementwise work are not counted."""
    dense = agg = 0
    for lp in layer_plan(model, dims):
        edges = kept + (n if lp["fused"] else 0)
        agg += 2 * edges * lp["agg_d"]
        dense += sum(product_cost(n, a, b)[1] for a, b in lp["fwd"])
        if train:
            if lp["agg_bwd"]:
                agg += 2 * edges * lp["agg_d"]
            dense += sum(product_cost(n, a, b)[1] for a, b in lp["bwd"])
    return {"dense": dense, "agg": agg, "total": dense + agg}


def gemm_bound_ms(model: str, dims, n: int, train: bool = True) -> float:
    """The least time (ms) of a step's dense products, each bounded by
    its FLOPs at the f32 rate or its bytes at the HBM rate."""
    total = 0.0
    for lp in layer_plan(model, dims):
        for a, b in lp["fwd"] + (lp["bwd"] if train else []):
            nbytes, flops = product_cost(n, a, b)
            total += least_ms(nbytes, flops, F32_FLOPS_PER_S)[0]
    return total


def agg_calls(model: str, dims, n: int, kept: int, rows: int, el: int,
              train: bool = True) -> Dict[str, list]:
    """The aggregation kernel calls of one step (``train``) or one
    evaluation forward: ``fwd`` the tiled forward calls' bounds (ms) and
    ``bwd_csr`` the reverse-index backward calls' bounds (ms), each over
    the ``kept`` edges whatever the ELL's width; ``rows``: the distinct
    rows the edges reference; ``el``: bytes of an element of the
    aggregation's traffic."""
    fwd, bwd = [], []
    for lp in layer_plan(model, dims):
        d = lp["agg_d"]
        fwd.append(bound(n, n, kept, d, el, rows, lp["fused"])[0])
        if train and lp["agg_bwd"]:
            bwd.append(bound_bwd_csr(n, n, kept, d, el)[0])
    return {"fwd": fwd, "bwd_csr": bwd}
