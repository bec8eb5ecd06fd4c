"""The port's ``EmbeddingStore`` against the live reference: the
scenarios of tests/test_embedding_store.py that tests/test_torch_serving.py
does not already hold (edge updates moving the neighbors' weights, the
empty update, a whole-graph dirty set, the frontier preview, the query
read path, the write-ahead log's counters, stale reads through
``predict_meta`` and a degree-capped store), and a repair of the port:
a full ``build()`` serves feature rows updated since the last refresh.

Each scenario runs on a port store and on a reference store built from
the same graph (the port's ``make_sbm_graph`` at the conftest's
arguments, array-equal to the reference's ``small_graph``) and the
reference's ``init_gnn`` parameters carried across with
``params_from_numpy``.  Deterministic outcomes are compared exactly:
dirty masks, frontier arrays, rows refreshed per layer, versions,
pending-update counts, predictions (up to ties within 1e-5 of the top
reference logit).  Tables: port against reference at 1e-5 (f32, rtol =
atol); a refreshed store against a fresh one at the reference test's
rtol 1e-4 / atol 1e-5 (edge rebuilds reorder CSR neighbor lists, which
permutes float sums)."""
import dataclasses
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.configs.base import GNNConfig as RefConfig  # noqa: E402
from repro.core import gnn as RG  # noqa: E402
from repro.core.embedding_store import EmbeddingStore as RefStore  # noqa: E402

from repro_torch.configs.base import GNNConfig  # noqa: E402
from repro_torch.core import gnn as TG  # noqa: E402
from repro_torch.core.embedding_store import EmbeddingStore  # noqa: E402
from repro_torch.data.synth import make_sbm_graph  # noqa: E402

TOL = 1e-5
TIE = 1e-5
FRESH = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def graph(small_graph):
    g = make_sbm_graph(n=300, n_classes=4, avg_degree=10, feat_dim=16,
                       seed=1)
    for f in dataclasses.fields(g):
        np.testing.assert_array_equal(getattr(g, f.name),
                                      getattr(small_graph, f.name))
    return g


def _copy(g):
    return dataclasses.replace(g, feats=g.feats.copy(),
                               indptr=g.indptr.copy(),
                               indices=g.indices.copy())


def _kw(g, **kw):
    base = dict(name="es", model="graphsage", n_nodes=g.n,
                feat_dim=g.feats.shape[1], hidden=8, n_classes=g.n_classes,
                n_layers=2, fanout=(4, 3), batch_size=32, loss="ce",
                use_agg_kernel=False, agg_interpret=True, agg_b_tile=4,
                agg_d_tile=8, agg_k_slab=2)
    base.update(kw)
    return base


@dataclasses.dataclass
class Pair:
    port: EmbeddingStore
    ref: RefStore
    params: list                # the port's tensors
    kw: dict

    def both(self):
        return (self.port, self.ref)


def _pair(graph, key, max_deg=None, **kw) -> Pair:
    kw = _kw(graph, **kw)
    ref_params = RG.init_gnn(jax.random.key(key), RefConfig(**kw),
                             graph.feats.shape[1])
    params = TG.params_from_numpy(
        [{k: np.asarray(v) for k, v in p.items()} for p in ref_params],
        device="cpu")
    port = EmbeddingStore(params, GNNConfig(**kw), _copy(graph),
                          chunk_size=48, max_deg=max_deg, device="cpu")
    ref = RefStore(ref_params, RefConfig(**kw), _copy(graph),
                   chunk_size=48, max_deg=max_deg)
    port.build()
    ref.build()
    _assert_tables(port, ref)
    return Pair(port, ref, params, kw)


def _assert_tables(port, ref):
    assert len(port.layers) == len(ref.layers)
    for li, (a, b) in enumerate(zip(port.layers, ref.layers)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL,
                                   atol=TOL, err_msg=f"layer {li}")


def _assert_matches_fresh(p: Pair, max_deg=None):
    fresh = EmbeddingStore(p.params, GNNConfig(**p.kw), _copy(p.port.graph),
                           chunk_size=48, max_deg=max_deg, device="cpu")
    fresh.build()
    for li, (a, b) in enumerate(zip(p.port.layers, fresh.layers)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   err_msg=f"layer {li}", **FRESH)


def _is_argmax(preds, logits) -> bool:
    preds = np.asarray(preds)
    got = logits[np.arange(len(preds)), preds]
    return bool(np.all(got >= logits.max(-1) - TIE))


def _rows(seed, n):
    return np.random.default_rng(seed).normal(size=(n, 16)) \
        .astype(np.float32)


def test_edge_update_affects_neighbor_weights(graph):
    """ã depends on both endpoint degrees: adding one edge (u, v)
    re-derives the ELL rows of u, v and their existing neighbors."""
    p = _pair(graph, key=2)
    u = int(np.argmax(graph.degrees))            # has neighbors for sure
    v = int((u + graph.n // 2) % graph.n)
    if v in set(graph.neighbors(u)) or v == u:
        v = (v + 1) % graph.n
    nb = set(p.port.graph.neighbors(u))
    for s in p.both():
        s.add_edges([u], [v])
    dirty = set(np.nonzero(p.port._dirty_row)[0])
    assert {u, v} <= dirty and nb <= dirty
    np.testing.assert_array_equal(p.port._dirty_row, p.ref._dirty_row)
    np.testing.assert_array_equal(p.port.idx, p.ref.idx)
    np.testing.assert_array_equal(p.port.w, p.ref.w)
    np.testing.assert_array_equal(p.port.w_self, p.ref.w_self)
    infos = [s.refresh() for s in p.both()]
    assert infos[0]["rows_per_layer"] == infos[1]["rows_per_layer"]
    _assert_tables(p.port, p.ref)
    _assert_matches_fresh(p)


def test_empty_update_is_noop(graph):
    p = _pair(graph, key=3)
    before = [np.asarray(t).copy() for t in p.port.layers]
    infos = [s.refresh() for s in p.both()]
    assert infos[0] == infos[1]
    assert infos[0]["total_rows"] == 0
    assert infos[0]["rows_per_layer"] == [0, 0]
    for a, b in zip(p.port.layers, before):
        assert np.array_equal(np.asarray(a), b)
    # add_edges with only self-loops is a no-op too
    for s in p.both():
        s.add_edges([1, 2], [1, 2])
        assert not s.dirty
    assert p.port.version == p.ref.version == 1


def test_whole_graph_dirty_equals_rebuild(graph):
    p = _pair(graph, key=4)
    for s in p.both():
        s.mark_dirty(np.arange(graph.n))
    infos = [s.refresh() for s in p.both()]
    assert infos[0]["rows_per_layer"] == infos[1]["rows_per_layer"] \
        == [graph.n] * 2
    _assert_tables(p.port, p.ref)
    _assert_matches_fresh(p)


@pytest.mark.parametrize("marked", [[0, 7], [3, 150, 299]])
def test_frontier_preview_matches_refresh(graph, marked):
    p = _pair(graph, key=5)
    fronts = []
    for s in p.both():
        s.mark_dirty(marked)
        fronts.append(s.frontier())
    # the preview is the reference's, array for array
    assert len(fronts[0]) == len(fronts[1]) == 2
    for a, b in zip(*fronts):
        np.testing.assert_array_equal(a, b)
    infos = [s.refresh() for s in p.both()]
    assert [int(f.sum()) for f in fronts[0]] == infos[0]["rows_per_layer"] \
        == infos[1]["rows_per_layer"]
    _assert_tables(p.port, p.ref)


def test_query_autorefresh_and_predict(graph):
    p = _pair(graph, key=6)
    preds = []
    for s in p.both():
        s.update_features([3], _rows(7, 1))
        assert s.dirty
        preds.append(s.predict([0, 3, 11]))      # triggers the refresh
        assert not s.dirty and s.version == 2
    fresh = RefStore(RG.init_gnn(jax.random.key(6), RefConfig(**p.kw), 16),
                     RefConfig(**p.kw), _copy(p.ref.graph), chunk_size=48)
    fresh.build()
    want = np.asarray(fresh.layers[-1])
    assert _is_argmax(preds[0], want[[0, 3, 11]])
    np.testing.assert_array_equal(preds[0], preds[1])
    logits = [s.query_logits([5, 3]) for s in p.both()]
    np.testing.assert_allclose(logits[0], np.asarray(p.port.layers[-1])
                               [[5, 3]], rtol=1e-6)
    np.testing.assert_allclose(logits[0], logits[1], rtol=TOL, atol=TOL)


def test_wal_pending_updates_and_staleness(graph):
    """Writers append to the WAL; ``pending_updates`` / ``staleness_s``
    track what the serving snapshot does not reflect yet, and a
    successful refresh zeroes both."""
    p = _pair(graph, key=10)
    seen = []
    for s in p.both():
        assert s.version == 1
        assert s.pending_updates() == 0
        assert s.staleness_s() == 0.0
        s.update_features([1], _rows(10, 1))
        s.mark_dirty([2])
        pending = s.pending_updates()
        assert pending == 2
        assert s.staleness_s() > 0.0
        st = s.refresh_stats()
        assert st["pending_updates"] == 2 and st["staleness_s"] > 0.0
        info = s.refresh()
        assert s.version == 2
        assert s.pending_updates() == 0
        assert s.staleness_s() == 0.0
        seen.append((pending, info["rows_per_layer"], s.version))
    assert seen[0] == seen[1]
    _assert_tables(p.port, p.ref)
    _assert_matches_fresh(p)


def test_predict_meta_serves_stale_without_refresh(graph):
    """``predict_meta`` answers from the current snapshot with its
    version and staleness; only ``predict`` / ``query_logits``
    auto-refresh."""
    p = _pair(graph, key=11)
    seen = []
    for s in p.both():
        before = np.argmax(s.snapshot().final_np, -1)
        s.update_features(np.arange(8), _rows(11, 8))
        preds, ver, stale = s.predict_meta(np.arange(graph.n))
        assert ver == 1 and stale > 0.0
        assert np.array_equal(preds, before)     # old version, not refreshed
        assert s.dirty
        s.predict([0])                           # auto-refreshes
        assert not s.dirty
        after = s.predict_meta(np.arange(graph.n))
        assert after[1] == 2 and after[2] == 0.0
        seen.append((preds, after[0]))
    np.testing.assert_array_equal(seen[0][0], seen[1][0])
    np.testing.assert_array_equal(seen[0][1], seen[1][1])


def test_capped_max_deg_store(graph):
    """A degree-capped store stays consistent with a capped fresh
    rebuild through updates (the truncated ELL is the documented
    layout)."""
    p = _pair(graph, key=8, max_deg=6)
    assert p.port.K == p.ref.K == 6
    np.testing.assert_array_equal(p.port.idx, p.ref.idx)
    infos = []
    for s in p.both():
        s.update_features([2, 4], _rows(9, 2))
        infos.append(s.refresh())
    assert infos[0]["rows_per_layer"] == infos[1]["rows_per_layer"]
    _assert_tables(p.port, p.ref)
    _assert_matches_fresh(p, max_deg=6)


@pytest.mark.parametrize("built_first", [True, False])
def test_build_after_feature_updates_serves_them(graph, built_first):
    """A full ``build()`` reads the updated input rows: updates applied
    before the first build, or since the last refresh (as a degrade
    build meets them), land in the table it publishes.  The oracle is
    the reference's plain forward on the updated graph, not the
    reference store: its ``build`` reads ``_h0``, which
    ``jnp.asarray(graph.feats)`` aliases on the CPU only when the array
    happens to be 64-byte aligned, so it drops these rows or not by the
    allocation's address."""
    import jax.numpy as jnp
    from repro.core.graph import to_ell as ref_to_ell

    kw = _kw(graph)
    ref_params = RG.init_gnn(jax.random.key(12), RefConfig(**kw), 16)
    params = TG.params_from_numpy(
        [{k: np.asarray(v) for k, v in p.items()} for p in ref_params],
        device="cpu")
    store = EmbeddingStore(params, GNNConfig(**kw), _copy(graph),
                           chunk_size=48, device="cpu")
    if built_first:
        store.build()
    store.update_features([0, 1, 2, 3], 5.0 * _rows(12, 4))
    store.build()
    assert not store.dirty and store.version == 1 + built_first
    idx, w, ws = ref_to_ell(store.graph)
    want = np.asarray(RG.full_graph_forward(
        ref_params, RefConfig(**kw), jnp.asarray(store.graph.feats),
        jnp.asarray(idx), jnp.asarray(w), jnp.asarray(ws)))
    np.testing.assert_allclose(store.snapshot().final_np, want, rtol=TOL,
                               atol=TOL)


def test_readers_do_not_wait_out_an_edge_apply(graph, monkeypatch):
    """While a writer's ``add_edges`` rebuilds the CSR (held here inside
    its ``to_ell`` call), a reader's ``predict_meta``, ``dirty`` and
    ``pending_updates`` answer at once from the old snapshot, and the
    record still counts as pending; the apply then lands as before.
    (The reference holds ``_mu`` over the whole apply.)"""
    import threading

    from repro_torch.core import embedding_store as ES

    p = _pair(graph, key=13)
    store = p.port
    inside, release = threading.Event(), threading.Event()
    real = ES.to_ell

    def held(*a, **kw):
        inside.set()
        assert release.wait(timeout=30.0)
        return real(*a, **kw)

    monkeypatch.setattr(ES, "to_ell", held)
    writer = threading.Thread(target=store.add_edges, args=([0], [150]))
    writer.start()
    try:
        assert inside.wait(timeout=30.0)
        seen = {}

        def read():
            seen["meta"] = store.predict_meta([0, 1])
            seen["dirty"], seen["pending"] = store.dirty, \
                store.pending_updates()

        reader = threading.Thread(target=read)
        reader.start()
        reader.join(timeout=10.0)
        assert not reader.is_alive(), "a reader waited out the apply"
    finally:
        release.set()
        writer.join(timeout=30.0)
    assert not writer.is_alive()
    assert seen["meta"][1] == 1 and seen["dirty"] and seen["pending"] == 1
    p.ref.add_edges([0], [150])
    np.testing.assert_array_equal(store.idx, p.ref.idx)
    np.testing.assert_array_equal(store._dirty_row, p.ref._dirty_row)
    assert store.pending_updates() == p.ref.pending_updates() == 1
    infos = [s.refresh() for s in p.both()]
    assert infos[0]["rows_per_layer"] == infos[1]["rows_per_layer"]
    _assert_tables(p.port, p.ref)


def _bad_writes(n):
    """Writes the store refuses, and whether the reference raises on them
    too (it pops the record, then its apply raises)."""
    return [(lambda s: s.update_features([n], _rows(14, 1)), True),
            (lambda s: s.update_features([2, 3], np.ones((2, 5),
                                                         np.float32)), True),
            (lambda s: s.update_features([-1], _rows(14, 1)), False),
            (lambda s: s.mark_dirty([n + 3]), False),
            (lambda s: s.add_edges([0], [n]), False),
            (lambda s: s.add_edges([0, 1], [2]), False)]


def test_bad_writes_are_refused_and_the_store_serves_on(graph):
    """A write with a node id outside ``[0, n)``, feature rows of the
    wrong width or unpaired edge lists fails its own call and queues
    nothing: later updates, ``refresh()`` and a ``GNNServer`` with a
    staleness bound serve on, against the reference given the same
    writes (it raises on the first two from its apply, after popping the
    record)."""
    from repro_torch.core.serving import GNNServer

    p = _pair(graph, key=14)
    for write, ref_raises in _bad_writes(graph.n):
        with pytest.raises(ValueError):
            write(p.port)
        if ref_raises:
            with pytest.raises((IndexError, ValueError)):
                write(p.ref)
        assert p.port.pending_updates() == 0 and not p.port.dirty
        assert p.port.staleness_s() == 0.0
    infos = []
    for s in p.both():
        s.update_features([5, 6], _rows(15, 2))
        s.add_edges([0], [150])
        infos.append(s.refresh())
    assert infos[0]["rows_per_layer"] == infos[1]["rows_per_layer"]
    assert p.port.version == p.ref.version == 2
    assert p.port.staleness_s() == 0.0
    _assert_tables(p.port, p.ref)

    server = GNNServer(p.port, max_batch=8, max_wait_ms=1.0,
                       max_staleness_s=0.05)
    try:
        for s in p.both():
            s.update_features([9], _rows(16, 1))
        time.sleep(0.06)
        ans = server.submit(np.arange(graph.n), with_meta=True) \
            .result(timeout=30.0)
    finally:
        server.close()
    p.ref.refresh()
    assert ans.snapshot_version == p.ref.version == 3
    assert _is_argmax(ans.preds, np.asarray(p.ref.layers[-1]))
    assert server.stats()["n_forced_refresh"] == 1
    _assert_tables(p.port, p.ref)


def test_a_record_whose_apply_raises_is_retired(graph, monkeypatch):
    """An apply that raises (here injected into the port's feature
    apply) surfaces to the writer and retires its record, as in the
    reference: the WAL does not stick, staleness settles at the next
    refresh, and the store then matches the reference given the same
    writes that landed."""
    p = _pair(graph, key=15)
    real = p.port._apply_feats

    def once(*a):
        monkeypatch.setattr(p.port, "_apply_feats", real)
        raise RuntimeError("apply failed")

    monkeypatch.setattr(p.port, "_apply_feats", once)
    with pytest.raises(RuntimeError, match="apply failed"):
        p.port.update_features([4], _rows(17, 1))
    assert p.port.pending_updates() == 0 and not p.port.dirty
    assert p.port.refresh()["total_rows"] == 0
    assert p.port.staleness_s() == 0.0 and p.port.version == 1
    infos = []
    for s in p.both():
        s.update_features([4, 8], _rows(18, 2))
        infos.append(s.refresh())
    assert infos[0]["rows_per_layer"] == infos[1]["rows_per_layer"]
    assert p.port.staleness_s() == 0.0 and p.port.version == 2
    _assert_tables(p.port, p.ref)
