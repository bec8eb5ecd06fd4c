"""The seeded stochastic-block-model graph of a cell, made on the device
with ``torch`` in a few large calls and handed back as numpy arrays.

It keeps the semantics of the port's ``data/synth.make_sbm_graph``
(``src/repro_torch/data/synth.py:20-91``), vectorised over nodes:

* labels uniform over the classes;
* a Poisson degree budget per node (at least 1), each node drawing
  ``max(budget // 2, 1)`` targets, each of the node's own class with
  probability ``homophily`` (uniform within the class), otherwise
  uniform over all nodes;
* self-edges dropped, the edges symmetrised and deduplicated into a CSR
  whose columns ascend within a row;
* features drawn from class-conditioned Gaussians (class means
  ``N(0, feat_scale)``, unit noise);
* the train / val / test split from one seeded permutation, by counts.

The structure (labels and edges) is drawn from one fixed stream,
``STRUCTURE_SEED``, and ``seed`` relabels its nodes and draws the
features, the split and the parameters: every seed gives the same sizes
(the degree multiset, the largest degree, the edges an ELL cap keeps),
so the same work, in another order.  The random streams are torch's,
so a seed gives the same graph on the same kind of device, not the port
generator's graph.  Nothing here imports the port.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

#: the stream the graph's structure is drawn from, whatever the seed
STRUCTURE_SEED = 0x5B1


@dataclasses.dataclass
class HostGraph:
    """The generated graph on the host: CSR, features, labels, splits."""
    n: int
    indptr: np.ndarray          # [n + 1] int64
    indices: np.ndarray         # [nnz] int32, ascending within a row
    feats: np.ndarray           # [n, r] float32
    labels: np.ndarray          # [n] int32
    train_mask: np.ndarray      # [n] bool
    val_mask: np.ndarray
    test_mask: np.ndarray


def split_counts(n: int, split: Dict[str, int]) -> tuple:
    """(train, val) node counts at ``n`` nodes: the published counts
    scaled by ``n / split["total"]`` and rounded down."""
    total = int(split["total"])
    return (n * int(split["train"]) // total, n * int(split["val"]) // total)


def make_graph(graph: dict, n: int, feat_dim: int, n_classes: int,
               seed: int, device) -> HostGraph:
    """The graph of ``graph`` (a configuration's ``graph`` entry:
    ``avg_degree``, ``homophily``, ``feat_scale``, ``split``) at ``n``
    nodes, from ``seed`` on ``device``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(STRUCTURE_SEED)
    i64 = dict(dtype=torch.int64, device=dev)

    labels = torch.randint(0, n_classes, (n,), generator=gen, **i64)
    rate = torch.full((n,), float(graph["avg_degree"]), dtype=torch.float64,
                      device=dev)
    budget = torch.poisson(rate, generator=gen).to(torch.int64).clamp_(min=1)
    k = torch.clamp(budget // 2, min=1)
    src = torch.repeat_interleave(torch.arange(n, **i64), k)
    t = src.numel()

    # targets: the source's class with probability h, else any node
    same = torch.rand(t, generator=gen, dtype=torch.float64,
                      device=dev) < float(graph["homophily"])
    by_class = torch.argsort(labels, stable=True)
    counts = torch.bincount(labels, minlength=n_classes)
    starts = torch.cumsum(counts, 0) - counts
    lab = labels[src]
    pick = torch.rand(t, generator=gen, dtype=torch.float64, device=dev)
    off = torch.minimum((pick * counts[lab]).to(torch.int64), counts[lab] - 1)
    t_same = by_class[starts[lab] + off]
    del pick, off, lab
    t_rand = torch.randint(0, n, (t,), generator=gen, **i64)
    dst = torch.where(same, t_same, t_rand)
    del same, t_same, t_rand
    keep = dst != src
    src, dst = src[keep], dst[keep]
    del keep

    # symmetrise and deduplicate: unique (row, col) ids
    eid = torch.unique(torch.cat([src * n + dst, dst * n + src]))
    del src, dst

    # the seed relabels the nodes: node i becomes new[i]
    gen.manual_seed(int(seed) % 2 ** 63)
    new = torch.randperm(n, generator=gen, device=dev)
    labels = torch.empty_like(labels).index_put_((new,), labels)
    rows = torch.div(eid, n, rounding_mode="floor")
    eid = new[rows] * n + new[eid - rows * n]
    eid = torch.sort(eid).values
    rows = torch.div(eid, n, rounding_mode="floor")
    indices = (eid - rows * n).to(torch.int32)
    del eid, new
    indptr = torch.zeros(n + 1, **i64)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    del rows

    mus = float(graph.get("feat_scale", 1.0)) * torch.randn(
        (n_classes, feat_dim), generator=gen, dtype=torch.float32,
        device=dev)
    feats = torch.randn((n, feat_dim), generator=gen, dtype=torch.float32,
                        device=dev)
    feats += mus[labels]

    perm = torch.randperm(n, generator=gen, device=dev)
    n_tr, n_va = split_counts(n, graph["split"])
    part = torch.full((n,), 2, dtype=torch.int8, device=dev)
    part[perm[:n_tr]] = 0
    part[perm[n_tr:n_tr + n_va]] = 1
    part = part.cpu().numpy()
    return HostGraph(n=n, indptr=indptr.cpu().numpy(),
                     indices=indices.cpu().numpy(),
                     feats=feats.cpu().numpy(),
                     labels=labels.to(torch.int32).cpu().numpy(),
                     train_mask=part == 0, val_mask=part == 1,
                     test_mask=part == 2)


def init_params(dims, model: str, seed: int, device) -> list:
    """Initial parameters from ``seed`` in the port's layout and scale
    (``h @ W`` with ``W`` [d_in, d_out], entries ``N(0, 1/d_in)``; GCN
    ``{"w"}``, GraphSAGE ``{"w_self", "w_neigh"}``), drawn on ``device``
    from a stream of their own and returned as numpy float32 arrays."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed((int(seed) + 0x5EED) % 2 ** 63)
    keys = ("w",) if model == "gcn" else ("w_self", "w_neigh")
    out = []
    for d_in, d_out in dims:
        layer = {}
        for key in keys:
            w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                            device=device) * (1.0 / d_in ** 0.5)
            layer[key] = w.cpu().numpy()
        out.append(layer)
    return out
