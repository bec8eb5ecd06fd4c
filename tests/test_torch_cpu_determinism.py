"""The plain (no-kernel) full-graph path gives the same bits on the CPU
however torch schedules its threads: exact resume
(``launch/train.py --resume``) promises bit-equality, and its full-graph
leg runs this path.  The gather of the ELL rows used to be advanced
indexing, whose gradient adds with parallel atomics on the CPU; a graph
whose rows all point at a few hub rows makes the atomics collide on
every call, so the old code failed here in one call of two or more."""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.core import gnn as G


def _hub_graph(n=4096, k=16, hubs=4, feat=64, seed=0):
    rng = np.random.default_rng(seed)
    idx = torch.tensor(rng.integers(0, hubs, size=(n, k)), dtype=torch.int32)
    w = torch.tensor(rng.random(size=(n, k)), dtype=torch.float32)
    w_self = torch.tensor(rng.random(size=n), dtype=torch.float32)
    feats = torch.tensor(rng.normal(size=(n, feat)), dtype=torch.float32)
    return feats, idx, w, w_self


@pytest.mark.parametrize("model", ["graphsage", "gcn", "gat"])
def test_fullgraph_grads_repeat_bit_for_bit_on_cpu(model):
    if torch.get_num_threads() < 2:
        torch.set_num_threads(2)       # the fault needs parallel adds
    feats, idx, w, w_self = _hub_graph()
    cfg = GNNConfig(name="det", model=model, n_nodes=feats.shape[0],
                    feat_dim=feats.shape[1], hidden=32, n_classes=8,
                    n_layers=2, fanout=(4, 4), batch_size=32)
    params = G.init_gnn(torch.Generator().manual_seed(0), cfg,
                        feats.shape[1], device="cpu")
    leaves = [v.requires_grad_() for p in params for v in p.values()]
    labels = torch.arange(feats.shape[0]) % cfg.n_classes

    def grads():
        logits = G.full_graph_forward(params, cfg, feats, idx, w, w_self)
        loss = G.gnn_loss(logits, labels, "ce", cfg.n_classes)
        return torch.autograd.grad(loss, leaves)

    first = grads()
    for _ in range(4):
        for a, b in zip(first, grads()):
            assert torch.equal(a, b)


def test_gather_rows_is_plain_indexing():
    feats, idx, _, _ = _hub_graph(n=64, k=5, hubs=64, feat=7, seed=1)
    assert torch.equal(G.gather_rows(feats, idx), feats[idx.long()])
