"""Full-graph GCN and GraphSAGE-mean training, written plainly: the
normalised adjacency re-derived from the CSR, the forward and its
backward by hand in f32, and SGD or AdamW, for the first steps of a run.

What the configuration states, and so what this follows:

* Ã = (D + I)^-1/2 (A + I) (D + I)^-1/2: edge weight
  ``1 / sqrt((deg_r + 1)(deg_c + 1))``, self weight ``1 / (deg + 1)``.
* With an ELL cap ``K`` a row of degree above ``K`` keeps the ``K``
  neighbours of largest weight; ties between neighbours of equal degree
  are broken as numpy's ``argpartition`` breaks them on the row laid out
  as the port lays it out (its CSR neighbours in order, zero-padded to
  the graph's largest degree), which this module reproduces row by row.
* GraphSAGE-mean: ``h W_self + mean_kept(h) W_neigh``; GCN: ``Ã h W``;
  ReLU between layers, cross-entropy over the training nodes.  A layer
  that narrows (``d_out < d_in``) transforms before it aggregates.
* Aggregation traffic in the configuration's dtype (bf16 or f32): the
  gathered table is rounded to it, each row's sum is taken in f32 and
  rounded to it once, and so is each sum of the backward.
* Dense products in f32, TF32 off (``precision="tf32"`` turns it on:
  the control).
* SGD ``p - lr g``; AdamW with global-norm clipping as the configuration
  states its constants.

Aggregations are products with the kept edges as CSR matrices
(``torch.sparse.mm``, f32 sums in another order than the program's: a
few ulp of f32).  Nothing of the program's run is taken: the CSR,
features, labels, split and initial parameters are the benchmark's own.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

F32 = torch.float32


# ---------------------------------------------------------------------------
# the kept edges
# ---------------------------------------------------------------------------

def over_cap_choice(indptr: np.ndarray, indices: np.ndarray,
                    cap: Optional[int], block: int = 1 << 18) -> np.ndarray:
    """The CSR positions of the edges that rows of degree above ``cap``
    keep: the ``cap`` neighbours that ``argpartition`` picks by weight on
    the row laid out over the graph's largest degree (empty when no row
    exceeds ``cap``)."""
    deg = np.diff(indptr).astype(np.int64)
    width = int(deg.max()) if deg.size else 0
    if cap is None or width <= cap:
        return np.zeros(0, np.int64)
    over = np.nonzero(deg > cap)[0]
    cols = np.arange(width, dtype=np.int64)[None, :]
    out = []
    for s in range(0, over.size, block):
        blk = over[s:s + block]
        d = deg[blk]
        valid = cols < d[:, None]
        pos = np.where(valid, indptr[blk][:, None] + cols, 0)
        nb = indices[pos].astype(np.int32)
        nb[~valid] = 0
        cw = (1.0 / np.sqrt((d[:, None] + 1.0) * (deg[nb] + 1.0))
              ).astype(np.float32)
        cw[~valid] = 0.0
        sel = np.argpartition(-cw, cap - 1, axis=1)[:, :cap]
        out.append(np.take_along_axis(pos, sel, axis=1).ravel())
    return np.concatenate(out)


def _crow(rows, n):
    crow = torch.zeros(n + 1, dtype=torch.int64, device=rows.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    return crow


def _csr(crow, cols, values, n):
    """A CSR [n, n] (entries sorted by row) over the given index tensors,
    which matrices of the same pattern share."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Sparse CSR tensor support",
                                UserWarning)
        warnings.filterwarnings("ignore", "Sparse invariant checks",
                                UserWarning)
        return torch.sparse_csr_tensor(crow, cols, values, (n, n),
                                       check_invariants=False)


@dataclasses.dataclass
class Edges:
    """The kept edges on the device as sparse matrices: ``a`` with Ã's
    edge weights, ``m`` with ones (GraphSAGE's mask), and their
    transposes; Ã's self weights and each row's kept count."""
    n: int
    a: torch.Tensor
    at: torch.Tensor
    m: torch.Tensor
    mt: torch.Tensor
    w_self: torch.Tensor        # [n] f32
    cnt: torch.Tensor           # [n, 1] f32, kept edges a row (at least 1)
    rows_referenced: int        # distinct rows the port's ELL ids name


def build_edges(indptr, indices, cap: Optional[int], device) -> Edges:
    """The kept edges of the CSR on ``device``: the rows over ``cap``
    choose on the host (``over_cap_choice``), the rest is laid out on
    the device."""
    n = indptr.size - 1
    dev = torch.device(device)
    ip = torch.as_tensor(indptr, device=dev)
    deg = ip[1:] - ip[:-1]
    rows = torch.repeat_interleave(torch.arange(n, device=dev), deg)
    cols = torch.as_tensor(indices, device=dev).long()
    if cap is not None and n and int(deg.max()) > cap:
        keep = deg[rows] <= cap
        keep[torch.as_tensor(over_cap_choice(indptr, indices, cap),
                             device=dev)] = True
        rows, cols = rows[keep], cols[keep]
        del keep
    w = (1.0 / torch.sqrt((deg[rows] + 1.0).double()
                          * (deg[cols] + 1.0).double())).to(F32)
    kept = torch.bincount(rows, minlength=n)
    # the port's ELL points padding at row 0: named whenever a row is short
    width = int(kept.max()) if cap is None and n else (cap or 0)
    seen = torch.zeros(n, dtype=torch.bool, device=dev)
    seen[cols] = True
    if n and bool((kept < width).any()):
        seen[0] = True
    ones = torch.ones_like(w)
    order = torch.sort(cols, stable=True).indices
    crow, crow_t, ct = _crow(rows, n), _crow(cols[order], n), rows[order]
    out = Edges(n=n, a=_csr(crow, cols, w, n),
                at=_csr(crow_t, ct, w[order], n), m=_csr(crow, cols, ones, n),
                mt=_csr(crow_t, ct, ones, n),
                w_self=(1.0 / (deg.double() + 1.0)).to(F32),
                cnt=torch.clamp(kept.to(F32), min=1.0)[:, None],
                rows_referenced=int(seen.sum()))
    return out


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(F32)


@contextlib.contextmanager
def _tf32(on: bool):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _mm(a, b, precision: str):
    """``a @ b`` in f32 (TF32 off) or, for ``"tf32"``, on the card's TF32
    path (on the CPU: its operands rounded to TF32)."""
    tf32 = precision == "tf32"
    if tf32 and a.device.type == "cpu":
        a, b = _round_tf32(a), _round_tf32(b)
    with _tf32(tf32 and a.device.type == "cuda"):
        return a @ b


def aggregate(table, e: Edges, weighted: bool, self_w: bool):
    """Σ_kept w · table[col] (+ w_self · table[row]) for each row, summed
    in f32 and rounded once to ``table``'s dtype, returned in f32."""
    out = torch.sparse.mm(e.a if weighted else e.m, table.to(F32))
    if self_w:
        out = e.w_self[:, None] * table.to(F32) + out
    return out.to(table.dtype).to(F32)


def aggregate_t(g, e: Edges, weighted: bool, self_w: bool, dtype):
    """The transposed aggregation of the cotangent ``g`` (f32) with the
    program's rounding: ``g`` rounded to the traffic ``dtype``; the
    neighbour part and (``self_w``) the self part each summed in f32 and
    rounded to ``dtype`` once, then added in ``dtype``."""
    gd = g.to(dtype).to(F32)
    out = torch.sparse.mm(e.at if weighted else e.mt, gd).to(dtype)
    if self_w:
        out = out + (e.w_self[:, None] * gd).to(dtype)
    return out.to(F32)


# ---------------------------------------------------------------------------
# one step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Model:
    """The model as the configuration states it."""
    kind: str                   # gcn | graphsage
    dtype: torch.dtype          # aggregation traffic
    n_classes: int


def forward_backward(params, x, labels, train, e: Edges, m: Model,
                     precision: str = "f32", fault: Optional[str] = None):
    """The loss over ``train`` and its gradients (a list of dicts like
    ``params``).  ``fault`` plants a known fault (``"half_batch"``: the
    loss over the first half of ``train`` only; ``"altered_rows"``:
    rows 127 mod 128 of every aggregation's output zeroed)."""
    gcn = m.kind == "gcn"
    mm = lambda a, b: _mm(a, b, precision)           # noqa: E731

    def agg(src):
        out = aggregate(src.to(m.dtype), e, weighted=gcn, self_w=gcn)
        if fault == "altered_rows":
            out[127::128] = 0.0
        return out if gcn else out / e.cnt

    if fault == "half_batch":
        train = train[:train.numel() // 2]
    saved, h = [], x
    for li, p in enumerate(params):
        last = li == len(params) - 1
        if gcn:
            w = p["w"]
            pre = w.shape[1] < w.shape[0]
            a = agg(mm(h, w) if pre else h)
            z = a if pre else mm(a, w)
            saved.append((h, None if pre else a))
        else:
            ws, wn = p["w_self"], p["w_neigh"]
            pre = wn.shape[1] < wn.shape[0]
            mean = agg(mm(h, wn) if pre else h)
            z = mm(h, ws) + (mean if pre else mm(mean, wn))
            saved.append((h, None if pre else mean))
        h = z if last else torch.relu(z)
        del z
    logits = h[train].to(F32)
    logz = torch.logsumexp(logits, dim=-1)
    lab = labels[train].long()
    loss = torch.mean(logz - logits.gather(-1, lab[:, None])[:, 0])
    dl = torch.softmax(logits, dim=-1)
    dl[torch.arange(lab.numel(), device=dl.device), lab] -= 1.0
    dz = torch.zeros_like(h)
    dz[train] = dl / lab.numel()
    del logits, dl, h

    grads: List[Dict[str, torch.Tensor]] = [dict() for _ in params]
    for li in range(len(params) - 1, -1, -1):
        p, (h, a) = params[li], saved[li]
        first = li == 0
        if gcn:
            w = p["w"]
            pre = w.shape[1] < w.shape[0]
            if pre:
                ds = aggregate_t(dz, e, True, True, m.dtype)
                grads[li]["w"] = mm(h.t(), ds)
                dh = None if first else mm(ds, w.t())
            else:
                grads[li]["w"] = mm(a.t(), dz)
                dh = None if first else aggregate_t(mm(dz, w.t()), e, True,
                                                    True, m.dtype)
        else:
            ws, wn = p["w_self"], p["w_neigh"]
            pre = wn.shape[1] < wn.shape[0]
            grads[li]["w_self"] = mm(h.t(), dz)
            if pre:
                ds = aggregate_t(dz / e.cnt, e, False, False, m.dtype)
                grads[li]["w_neigh"] = mm(h.t(), ds)
                dh = None if first else mm(dz, ws.t()) + mm(ds, wn.t())
            else:
                grads[li]["w_neigh"] = mm(a.t(), dz)
                dh = None if first else mm(dz, ws.t()) + aggregate_t(
                    mm(dz, wn.t()) / e.cnt, e, False, False, m.dtype)
        saved[li] = None
        if dh is not None:
            dz = dh * (h > 0)
        del dh
    return loss, grads


# ---------------------------------------------------------------------------
# the optimizers and the first steps
# ---------------------------------------------------------------------------

def _leaves(tree) -> List[torch.Tensor]:
    return [layer[k] for layer in tree for k in layer]


def sgd_step(params, grads, st, lr: float):
    return [{k: p[k] - lr * g[k] for k in p}
            for p, g in zip(params, grads)], st, grads


def adamw_step(params, grads, st, lr: float, b1: float, b2: float,
               eps: float, weight_decay: float, clip_norm: Optional[float],
               fault: Optional[str] = None):
    """One AdamW update; returns (params, state, the gradients as the
    update used them, after clipping).  ``fault`` plants a known fault
    of the later updates: ``"adam_reset"``, the moments the first update
    left are dropped before the second; ``"adam_t1"``, the step count
    (and so the bias correction) held at 1."""
    if clip_norm is not None:
        gn = torch.sqrt(sum(torch.sum(g * g) for g in _leaves(grads)))
        scale = torch.clamp(clip_norm / (gn + 1e-9), max=1.0)
        grads = [{k: g[k] * scale for k in g} for g in grads]
    t = 1 if fault == "adam_t1" else st["t"] + 1
    reset = fault == "adam_reset" and st["t"] == 1
    c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    out, mu, nu = [], [], []
    for p, g, m1, v1 in zip(params, grads, st["mu"], st["nu"]):
        lp, lm, lv = {}, {}, {}
        for k in p:
            m_old, v_old = (0.0, 0.0) if reset else (m1[k], v1[k])
            lm[k] = b1 * m_old + (1 - b1) * g[k]
            lv[k] = b2 * v_old + (1 - b2) * g[k] * g[k]
            delta = (lm[k] / c1) / (torch.sqrt(lv[k] / c2) + eps)
            if weight_decay:
                delta = delta + weight_decay * p[k]
            lp[k] = p[k] - lr * delta
        out.append(lp)
        mu.append(lm)
        nu.append(lv)
    return out, {"t": st["t"] + 1, "mu": mu, "nu": nu}, grads


def follow(graph, edges: Edges, model: Model, plan: dict, params0,
           steps: int = 3, precision: str = "f32",
           fault: Optional[str] = None, device="cuda") -> dict:
    """The first ``steps`` steps of full-graph training from ``params0``
    (numpy, the benchmark's): each step's loss, the gradient the first
    update used, and the parameters' change after the first and after
    the last step, each as a list of tensors in ``params0``'s leaf
    order."""
    dev = torch.device(device)
    x = torch.as_tensor(graph.feats, device=dev)
    labels = torch.as_tensor(graph.labels, device=dev)
    train = torch.as_tensor(np.nonzero(graph.train_mask)[0], device=dev)
    params = [{k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
               for k, v in layer.items()} for layer in params0]
    p0 = [t.clone() for t in _leaves(params)]
    if plan["optimizer"] == "sgd":
        step_fn = lambda p, g, s: sgd_step(p, g, s, plan["lr"])  # noqa: E731
        st = {}
    else:
        step_fn = lambda p, g, s: adamw_step(            # noqa: E731
            p, g, s, plan["lr"], plan["b1"], plan["b2"], plan["eps"],
            plan["weight_decay"], plan["clip_norm"], fault)
        st = {"t": 0, "mu": [{k: torch.zeros_like(v) for k, v in p.items()}
                             for p in params],
              "nu": [{k: torch.zeros_like(v) for k, v in p.items()}
                     for p in params]}
    losses, first, delta1 = [], None, None
    with torch.no_grad():
        for i in range(steps):
            loss, grads = forward_backward(params, x, labels, train, edges,
                                           model, precision, fault)
            params, st, used = step_fn(params, grads, st)
            losses.append(float(loss))
            if i == 0:
                first = [g.clone() for g in _leaves(used)]
                delta1 = [p - q for p, q in zip(_leaves(params), p0)]
    return {"losses": losses, "grad": first, "delta1": delta1,
            "delta": [p - q for p, q in zip(_leaves(params), p0)]}
