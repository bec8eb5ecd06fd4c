"""The port's numpy host layer (graph, synth, sampler, prefetch, config)
is array-equal to the reference at the same seed."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.configs import base as ref_base  # noqa: E402
from repro.configs import gnn_papers100m as ref_papers  # noqa: E402
from repro.core import graph as ref_graph  # noqa: E402
from repro.core import prefetch as ref_prefetch  # noqa: E402
from repro.core import sampler as ref_sampler  # noqa: E402
from repro.data import synth as ref_synth  # noqa: E402

from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.core import graph as t_graph  # noqa: E402
from repro_torch.core import prefetch as t_prefetch  # noqa: E402
from repro_torch.core import sampler as t_sampler  # noqa: E402
from repro_torch.data import synth as t_synth  # noqa: E402

SMALL = dict(n=300, n_classes=4, avg_degree=10, feat_dim=16, seed=1)

GRAPH_FIELDS = ("n", "indptr", "indices", "feats", "labels", "train_mask",
                "val_mask", "test_mask")


def _assert_graph_equal(a, b):
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


@pytest.fixture(scope="module")
def graphs():
    return (ref_synth.make_sbm_graph(**SMALL),
            t_synth.make_sbm_graph(**SMALL))


def test_sbm_graph_equal(graphs):
    _assert_graph_equal(*graphs)


@pytest.mark.parametrize("name", sorted(ref_synth.PRESETS))
def test_presets_equal(name):
    assert t_synth.PRESETS[name] == ref_synth.PRESETS[name]
    n = 480
    _assert_graph_equal(ref_synth.make_preset(name, n=n, seed=3),
                        t_synth.make_preset(name, n=n, seed=3))


@pytest.mark.parametrize("max_deg", [None, 4, 1])
def test_ell_equal(graphs, max_deg):
    rg, tg = graphs
    for a, b in zip(ref_graph.to_ell(rg, max_deg=max_deg),
                    t_graph.to_ell(tg, max_deg=max_deg)):
        np.testing.assert_array_equal(a, b)
    rows = np.array([5, 0, 299, 17], np.int32)
    for a, b in zip(ref_graph.to_ell(rg, max_deg=max_deg, rows=rows),
                    t_graph.to_ell(tg, max_deg=max_deg, rows=rows)):
        np.testing.assert_array_equal(a, b)


def test_graph_helpers_equal(graphs):
    rg, tg = graphs
    rows = np.arange(0, 300, 7)
    for a, b in zip(ref_graph.neighbors_batch(rg, rows),
                    t_graph.neighbors_batch(tg, rows)):
        np.testing.assert_array_equal(a, b)
    cols = rg.indices[:rows.size]
    np.testing.assert_array_equal(ref_graph.norm_coef(rg, rows, cols),
                                  t_graph.norm_coef(tg, rows, cols))
    np.testing.assert_array_equal(ref_graph.full_adjacency_dense(rg),
                                  t_graph.full_adjacency_dense(tg))
    with pytest.raises(ValueError, match="max_deg must be >= 1"):
        t_graph.to_ell(tg, max_deg=0)


def _batch_equal(a, b):
    for fa, fb in ((a.nodes, b.nodes), (a.masks, b.masks),
                   (a.weights, b.weights), (a.self_w, b.self_w)):
        assert len(fa) == len(fb)
        for x, y in zip(fa, fb):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.labels, b.labels)


@pytest.mark.parametrize("fanouts", [(4, 3), (15, 10), (1,)])
def test_sample_batch_equal(graphs, fanouts):
    rg, tg = graphs
    ra = np.random.default_rng(7)
    rb = np.random.default_rng(7)
    for _ in range(3):
        fa = ref_sampler.sample_batch(ra, rg, 32, fanouts)
        fb = t_sampler.sample_batch(rb, tg, 32, fanouts)
        _batch_equal(fa, fb)
        for x, y in zip(ref_sampler.gather_features(rg, fa),
                        t_sampler.gather_features(tg, fb)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("fanout", [2, 8, 40])
def test_sample_neighbors_equal(graphs, fanout):
    rg, tg = graphs
    src = np.arange(0, 300, 3, dtype=np.int32)
    for ref_fn, t_fn in ((ref_sampler.sample_neighbors,
                          t_sampler.sample_neighbors),
                         (ref_sampler.sample_neighbors_loop,
                          t_sampler.sample_neighbors_loop)):
        a = ref_fn(np.random.default_rng(2), rg, src, fanout)
        b = t_fn(np.random.default_rng(2), tg, src, fanout)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_prefetcher_sequence_equal(graphs):
    """Same seed, same batch sequence through both Prefetchers."""
    rg, tg = graphs
    with ref_prefetch.Prefetcher(rg, 16, (3, 2), seed=5, n_batches=4) as pa, \
            t_prefetch.Prefetcher(tg, 16, (3, 2), seed=5,
                                  n_batches=4) as pb:
        got_a, got_b = list(pa), list(pb)
    assert len(got_a) == len(got_b) == 4
    for (fa, ha), (fb, hb) in zip(got_a, got_b):
        _batch_equal(fa, fb)
        for x, y in zip(ha, hb):
            np.testing.assert_array_equal(x, y)


def test_staging_ring_buffers_are_tensor_views():
    ring = t_prefetch.HostStagingRing(2)
    slot = ring.acquire()
    specs = [((3,), np.int32), ((2, 4), np.float32)]
    a, b = ring.buffers(slot, specs)
    a[:] = [1, 2, 3]
    b[:] = 7.0
    ta, tb = ring.tensors(slot)
    assert ta.tolist() == [1, 2, 3] and float(tb.sum()) == 56.0
    # same specs: the same memory comes back
    a2, _ = ring.buffers(slot, specs)
    assert a2.ctypes.data == a.ctypes.data
    ring.release(slot)
    with pytest.raises(ValueError):
        t_prefetch.HostStagingRing(0)


def _cfg_dict(**kw):
    d = dict(name="c", model="gcn", n_nodes=100, feat_dim=16, hidden=8,
             n_classes=4, n_layers=2, fanout=(4, 3), batch_size=32,
             use_agg_kernel=True, agg_b_tile=4, agg_d_tile=8,
             agg_k_slab=2, dtype="bfloat16")
    d.update(kw)
    return d


def test_config_same_fields_and_validation():
    ref_fields = [(f.name, f.default) for f in
                  dataclasses.fields(ref_base.GNNConfig)]
    t_fields = [(f.name, f.default) for f in
                dataclasses.fields(t_base.GNNConfig)]
    assert ref_fields == t_fields
    a = ref_base.GNNConfig(**_cfg_dict())
    b = t_base.GNNConfig(**_cfg_dict())
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    b.validate()
    for bad in (dict(model="mlp"), dict(fanout=(4,)), dict(agg_b_tile=0),
                dict(batch_size=1000), dict(max_degree=0),
                dict(feats_layout="x")):
        with pytest.raises(ValueError) as ea:
            ref_base.GNNConfig(**_cfg_dict(**bad)).validate()
        with pytest.raises(ValueError) as eb:
            t_base.GNNConfig(**_cfg_dict(**bad)).validate()
        assert str(ea.value) == str(eb.value)


@pytest.mark.parametrize("smoke", [False, True])
def test_papers100m_config_equal(smoke):
    want = (ref_papers.smoke_config() if smoke
            else ref_papers.full_config())
    got = t_base.get_config("gnn-papers100m", smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert t_base.get_config("gnn_papers100m") == t_base.get_config(
        "gnn-papers100m")
    assert t_base.list_archs() == (
        "gnn-papers100m", "gemma3-12b", "gemma-7b", "granite-3-2b",
        "stablelm-1.6b", "internvl2-76b", "llama4-maverick-400b-a17b",
        "llama4-scout-17b-a16e", "mamba2-130m", "whisper-medium",
        "zamba2-7b")
    with pytest.raises(KeyError):
        t_base.get_config("llama")
