"""The port's METIS-free partition (``repro_torch.core.partition``, the
host half of ``ClusterSource``) against the live reference: part ids,
clusters and per-cluster ELL blocks array-equal at the same seed, and the
reference's own partition cases (tests/test_partition.py) on the port."""
import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import partition as RP  # noqa: E402
from repro.data import make_sbm_graph as ref_make  # noqa: E402

from repro_torch.core import partition as TP  # noqa: E402
from repro_torch.core.graph import Graph  # noqa: E402
from repro_torch.data.synth import make_sbm_graph  # noqa: E402

SMALL = dict(n=300, n_classes=4, avg_degree=10, feat_dim=16, seed=1)


@pytest.fixture(scope="module")
def graphs():
    return ref_make(**SMALL), make_sbm_graph(**SMALL)


def _path_graph():
    """0 - 1 - 2 undirected path, everything in the train split."""
    return Graph(n=3,
                 indptr=np.array([0, 1, 3, 4], np.int64),
                 indices=np.array([1, 0, 2, 1], np.int32),
                 feats=np.ones((3, 2), np.float32),
                 labels=np.array([0, 1, 0], np.int32),
                 train_mask=np.ones(3, bool),
                 val_mask=np.zeros(3, bool),
                 test_mask=np.zeros(3, bool))


@pytest.mark.parametrize("n_parts,seed", [(1, 0), (7, 3), (16, 9),
                                          (75, 1), (300, 0), (350, 2)])
def test_partition_and_blocks_equal_reference(graphs, n_parts, seed):
    rg, tg = graphs
    want = RP.bfs_partition(rg, n_parts, seed=seed)
    got = TP.bfs_partition(tg, n_parts, seed=seed)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for a, b in zip(TP.partition_clusters(got),
                    RP.partition_clusters(want), strict=True):
        np.testing.assert_array_equal(a, b)
    tb = TP.cluster_ell_blocks(tg, got)
    rb = RP.cluster_ell_blocks(rg, want)
    for field in ("clusters", "idx", "w", "w_self"):
        for a, b in zip(getattr(tb, field), getattr(rb, field),
                        strict=True):
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
    np.testing.assert_array_equal(tb.sizes, rb.sizes)
    assert tb.max_width == rb.max_width


def test_bfs_partition_covers_all_nodes_and_balances(graphs):
    g = graphs[1]
    n_parts = 7
    part = TP.bfs_partition(g, n_parts, seed=3)
    assert part.shape == (g.n,)
    assert part.min() >= 0 and part.max() < n_parts
    target = -(-g.n // n_parts)
    sizes = np.bincount(part)
    assert sizes.sum() == g.n
    assert sizes.max() <= target           # BFS growing respects budget
    assert sizes.min() >= 1


def test_bfs_partition_deterministic(graphs):
    a = TP.bfs_partition(graphs[1], 5, seed=9)
    b = TP.bfs_partition(graphs[1], 5, seed=9)
    np.testing.assert_array_equal(a, b)


def test_bfs_partition_singletons_and_bounds(graphs):
    g = graphs[1]
    part = TP.bfs_partition(g, g.n + 50, seed=0)   # n_parts clamps to n
    assert np.bincount(part).max() == 1            # every part one node
    with pytest.raises(ValueError, match="n_parts"):
        TP.bfs_partition(g, 0)


def test_partition_clusters_sorted_nonempty(graphs):
    part = TP.bfs_partition(graphs[1], 6, seed=1)
    clusters = TP.partition_clusters(part)
    assert sum(len(c) for c in clusters) == graphs[1].n
    for c in clusters:
        assert len(c) >= 1
        assert np.all(np.diff(c) > 0)              # sorted, unique


def test_cluster_ell_blocks_induced_weights():
    g = _path_graph()
    part = np.array([0, 0, 1], np.int32)           # {0, 1} and {2}
    blocks = TP.cluster_ell_blocks(g, part)
    assert len(blocks.clusters) == 2
    # cluster {0, 1}: one induced edge, induced degree 1 on both ends
    np.testing.assert_array_equal(blocks.idx[0], [[1], [0]])
    np.testing.assert_allclose(blocks.w[0], 0.5)           # 1/sqrt(2*2)
    np.testing.assert_allclose(blocks.w_self[0], 0.5)      # 1/(1+1)
    # singleton cluster {2}: the 1 - 2 edge is cross-cluster -> dropped
    assert blocks.idx[1].shape == (1, 1)
    np.testing.assert_allclose(blocks.w[1], 0.0)
    np.testing.assert_allclose(blocks.w_self[1], 1.0)      # 1/(0+1)


def test_cluster_ell_blocks_local_ids_in_range(graphs):
    part = TP.bfs_partition(graphs[1], 8, seed=2)
    blocks = TP.cluster_ell_blocks(graphs[1], part)
    for c, idx, w in zip(blocks.clusters, blocks.idx, blocks.w):
        assert idx.min() >= 0 and idx.max() < len(c)
        assert (w >= 0).all() and w.shape == idx.shape
