"""gnn-papers100m-like  [gnn]: the paper's own system at production scale
(copy of the reference ``repro.configs.gnn_papers100m``).

Mirrors ogbn-papers100M's regime scaled:
16M nodes, 128-dim features, 172 classes, GraphSAGE-mean 2-layer,
fan-out (15, 10) / batch 8192 for mini-batch; ELL max_degree=32 for
full-graph.  [paper: Liu et al. 2026; dataset: Hu et al. 2020]
"""
from repro_torch.configs.base import GNNConfig


def full_config() -> GNNConfig:
    return GNNConfig(
        name="gnn-papers100m",
        model="graphsage",
        n_nodes=16_777_216,
        feat_dim=128,
        hidden=256,
        n_classes=172,
        n_layers=2,
        fanout=(15, 10),
        batch_size=8192,
        max_degree=32,
        dtype="bfloat16",   # aggregation traffic dtype
        # the hand-written CUDA gather kernel carries the aggregation
        use_agg_kernel=True,
        agg_interpret=False,
        source="Liu et al. 2026 / ogbn-papers100M (Hu et al. 2020)",
    )


def smoke_config() -> GNNConfig:
    return GNNConfig(
        name="gnn-papers100m",
        model="graphsage",
        n_nodes=512,
        feat_dim=32,
        hidden=64,
        n_classes=8,
        n_layers=2,
        fanout=(5, 3),
        batch_size=32,
        max_degree=16,
        source="(reduced)",
    )
