"""Write-safe serving under chaos, on the port, held against the live
reference: every scenario of tests/test_serving_chaos.py.

Each test runs its scenario on the port's ``EmbeddingStore`` /
``GNNServer``.  Where the reference's outcome does not depend on thread
timing (snapshot versions, rows refreshed per layer, the ``degraded``
flag, the ``ServeStats`` counters and the answers), the same scenario
also runs on the reference's store and server, and the two are
compared.  Where it does (the background scheduler, concurrent writers
and readers), the oracle is the reference's plain ``full_graph_forward``
at each prefix of the update stream: every port answer must be the
argmax of some prefix.

Inputs: the port's ``make_sbm_graph`` at the conftest's arguments
(array-equal to the reference's ``small_graph``), each store on its own
copy of the arrays; parameters from the reference's ``init_gnn`` carried
across with ``params_from_numpy``.  Tolerances: logits 1e-5 (f32,
``rtol`` = ``atol``); an argmax may take either class where the top two
reference logits lie within ``TIE`` = 1e-5 of each other.  Every join,
``result()`` and wait has a timeout of its own."""
import dataclasses
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import GNNConfig as RefConfig  # noqa: E402
from repro.core import faults as ref_faults  # noqa: E402
from repro.core import gnn as RG  # noqa: E402
from repro.core.embedding_store import EmbeddingStore as RefStore  # noqa: E402
from repro.core.graph import to_ell as ref_to_ell  # noqa: E402
from repro.core.serving import GNNServer as RefServer  # noqa: E402
from repro.core.serving import ServeStats as RefStats  # noqa: E402
from repro.core.serving import _Reservoir as RefReservoir  # noqa: E402

from repro_torch.configs.base import GNNConfig  # noqa: E402
from repro_torch.core import faults  # noqa: E402
from repro_torch.core import gnn as TG  # noqa: E402
from repro_torch.core.embedding_store import EmbeddingStore  # noqa: E402
from repro_torch.core.graph import Graph  # noqa: E402
from repro_torch.core.serving import (DeadlineExceededError,  # noqa: E402
                                      GNNServer, ServedAnswer,
                                      ServerOverloadedError, ServeStats,
                                      _Reservoir)
from repro_torch.data.synth import make_sbm_graph  # noqa: E402

TOL = 1e-5          # f32 logits, port against reference
TIE = 1e-5          # an argmax within TIE of the top logit is a tie
WAIT = 30.0         # seconds any single future / join may take


@pytest.fixture(autouse=True)
def _no_armed_failpoints():
    yield
    faults.disarm()
    ref_faults.disarm()


@pytest.fixture(autouse=True)
def _quiet_thread_crashes(monkeypatch):
    """Injected SimulatedCrash kills daemon threads by design; keep the
    default excepthook traceback out of the test output."""
    monkeypatch.setattr(threading, "excepthook", lambda args: None)


@pytest.fixture(scope="module")
def graph(small_graph):
    g = make_sbm_graph(n=300, n_classes=4, avg_degree=10, feat_dim=16,
                       seed=1)
    for f in dataclasses.fields(g):
        np.testing.assert_array_equal(getattr(g, f.name),
                                      getattr(small_graph, f.name))
    return g


def _copy(g) -> Graph:
    return dataclasses.replace(g, feats=g.feats.copy(),
                               indptr=g.indptr.copy(),
                               indices=g.indices.copy())


def _kw(g):
    return dict(name="chaos-srv", model="graphsage", n_nodes=g.n,
                feat_dim=g.feats.shape[1], hidden=8, n_classes=g.n_classes,
                n_layers=2, fanout=(4, 3), batch_size=32, loss="ce")


@dataclasses.dataclass
class Built:
    port: EmbeddingStore
    ref: object                 # the reference store, or None
    ref_params: list
    kw: dict


def _built(graph, key, with_ref=True) -> Built:
    """A built port store and (``with_ref``) the reference's, from the
    same graph and the reference's ``init_gnn(key)``."""
    kw = _kw(graph)
    ref_params = RG.init_gnn(jax.random.key(key), RefConfig(**kw),
                             graph.feats.shape[1])
    params = TG.params_from_numpy(
        [{k: np.asarray(v) for k, v in p.items()} for p in ref_params],
        device="cpu")
    port = EmbeddingStore(params, GNNConfig(**kw), _copy(graph),
                          chunk_size=64, device="cpu")
    port.build()
    ref = None
    if with_ref:
        ref = RefStore(ref_params, RefConfig(**kw), _copy(graph),
                       chunk_size=64)
        ref.build()
        np.testing.assert_allclose(port.snapshot().final_np,
                                   ref.snapshot().final_np, rtol=TOL,
                                   atol=TOL)
    return Built(port, ref, ref_params, kw)


def _both(b: Built):
    """(store, its faults module) for the port, then the reference."""
    return ((b.port, faults), (b.ref, ref_faults))


def _ref_logits(b: Built, graph) -> np.ndarray:
    """The reference's plain full-graph forward on ``graph``."""
    idx, w, ws = ref_to_ell(graph)
    return np.asarray(RG.full_graph_forward(
        b.ref_params, RefConfig(**b.kw), jnp.asarray(graph.feats),
        jnp.asarray(idx), jnp.asarray(w), jnp.asarray(ws)))


def _is_argmax(preds, logits) -> bool:
    """``preds`` is a row argmax of ``logits``, up to ties within TIE."""
    preds = np.asarray(preds)
    got = logits[np.arange(len(preds)), preds]
    return bool(np.all(got >= logits.max(-1) - TIE))


def _assert_close(a, b, what=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL,
                               atol=TOL, err_msg=what)


def _rows(n):
    return np.random.default_rng(n).normal(size=(n, 16)).astype(np.float32)


# ---------------------------------------------------------------------------
# versioned snapshots: crashes mid-refresh never tear the serving state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fp", ["store.mid_layer_refresh",
                                "store.before_swap"])
def test_crash_mid_refresh_keeps_old_snapshot(graph, fp):
    b = _built(graph, key=0)
    out = {}
    for store, F in _both(b):
        snap0 = store.snapshot()
        final0 = snap0.final_np.copy()
        rng = np.random.default_rng(0)
        store.update_features([3, 9], rng.normal(size=(2, 16))
                              .astype(np.float32))
        with F.armed(fp):
            with pytest.raises(F.SimulatedCrash):
                store.refresh()
        # partial version discarded: same snapshot object, same version,
        # byte-identical final table, dirty info intact
        assert store.snapshot() is snap0
        assert store.version == snap0.version
        np.testing.assert_array_equal(store.snapshot().final_np, final0)
        assert store.dirty
        preds, ver, _ = store.predict_meta(np.arange(store.graph.n))
        assert ver == snap0.version
        np.testing.assert_array_equal(preds, np.argmax(final0, -1))
        # the WAL / dirty masks were not lost: the retry catches up
        info = store.refresh()
        assert store.version == snap0.version + 1 and not store.dirty
        out[store is b.port] = (snap0.version, info["rows_per_layer"],
                                store.snapshot().final_np)
    port, ref = out[True], out[False]
    assert port[:2] == ref[:2]
    _assert_close(port[2], ref[2], "final table after the retry")
    want = _ref_logits(b, b.port.graph)
    assert _is_argmax(b.port.predict_meta(np.arange(graph.n))[0], want)


def test_snapshot_immutable_across_versions(graph):
    b = _built(graph, key=1)
    versions = []
    for store, _ in _both(b):
        snap1 = store.snapshot()
        final1 = snap1.final_np.copy()
        store.update_features(np.arange(10), _rows(10))
        store.refresh()
        snap2 = store.snapshot()
        assert snap2.version == snap1.version + 1
        assert snap2 is not snap1
        # the old snapshot a reader may still hold is untouched
        np.testing.assert_array_equal(snap1.final_np, final1)
        with pytest.raises(dataclasses.FrozenInstanceError):
            snap2.version = 99
        versions.append((snap1.version, snap2.version))
    assert versions[0] == versions[1]
    _assert_close(b.port.snapshot().final_np, b.ref.snapshot().final_np)


def test_transient_refresh_fault_retried(graph):
    b = _built(graph, key=2)
    out = []
    for store, F in _both(b):
        rng = np.random.default_rng(2)
        store.update_features([5], rng.normal(size=(1, 16))
                              .astype(np.float32))
        with F.armed("store.mid_layer_refresh", at_hits=(0,),
                     exc=F.TransientRefreshFault):
            info = store.refresh_with_recovery(max_retries=2,
                                               backoff_s=0.001)
        assert info["total_rows"] > 0 and "degraded" not in info
        assert store.refresh_stats()["transient_retries"] == 1
        assert not store.dirty
        st = store.refresh_stats()
        out.append((info["rows_per_layer"], store.version,
                    {k: st[k] for k in ("refreshes", "builds",
                                        "transient_retries",
                                        "degraded_builds")}))
    assert out[0] == out[1]
    _assert_close(b.port.snapshot().final_np, b.ref.snapshot().final_np)
    assert _is_argmax(b.port.predict_meta(np.arange(20))[0],
                      _ref_logits(b, b.port.graph)[:20])


def test_fatal_refresh_degrades_to_one_full_build(graph):
    b = _built(graph, key=3)
    out = []
    for store, F in _both(b):
        rng = np.random.default_rng(3)
        store.update_features([4], rng.normal(size=(1, 16))
                              .astype(np.float32))
        with F.armed("store.mid_layer_refresh", at_hits=(0,),
                     exc=F.FatalSamplerFault):
            with pytest.warns(RuntimeWarning, match="DEGRADING"):
                info = store.refresh_with_recovery(max_retries=1,
                                                   backoff_s=0.001)
        assert info.get("degraded") is True
        st = store.refresh_stats()
        assert st["degraded_builds"] == 1 and not store.dirty
        out.append((info["degraded"], info["rows_per_layer"],
                    info["total_rows"], store.version,
                    {k: st[k] for k in ("refreshes", "builds",
                                        "transient_retries",
                                        "degraded_builds",
                                        "pending_updates")}))
    assert out[0] == out[1]
    _assert_close(b.port.snapshot().final_np, b.ref.snapshot().final_np)
    assert _is_argmax(b.port.predict_meta(np.arange(20))[0],
                      _ref_logits(b, b.port.graph)[:20])


def test_fatal_after_degrade_surfaces_and_server_closes(graph):
    """before_swap armed at hits {0, 1}: the incremental publish dies,
    the degrade-to-build publish dies too, so the fault surfaces on the
    query future; the server stays closeable and the old snapshot is
    still the serving state."""
    b = _built(graph, key=4)
    out = []
    for (store, F), Server in zip(_both(b), (GNNServer, RefServer)):
        v0 = store.version
        rng = np.random.default_rng(4)
        server = Server(store, max_batch=8, max_wait_ms=1.0)
        try:
            first = server.classify([0, 1], timeout=WAIT)
            store.update_features([7], rng.normal(size=(1, 16))
                                  .astype(np.float32))
            with F.armed("store.before_swap", at_hits=(0, 1),
                         exc=F.FatalSamplerFault):
                fut = server.submit([2, 3])
                with pytest.warns(RuntimeWarning, match="DEGRADING"):
                    with pytest.raises(F.FatalSamplerFault):
                        fut.result(timeout=WAIT)
            assert store.version == v0       # both partial versions dropped
            st = store.refresh_stats()
        finally:
            server.close()
        assert np.array_equal(store.predict_meta([2, 3])[0],
                              np.argmax(store.snapshot().final_np[[2, 3]],
                                        -1))
        out.append((first.tolist(), v0, store.version, store.dirty,
                     st["degraded_builds"], server.stats()["n_requests"]))
    assert out[0] == out[1]


def test_serve_before_reply_failpoint(graph):
    b = _built(graph, key=5)
    expect = _ref_logits(b, b.port.graph)
    out = []
    for (store, F), Server in zip(_both(b), (GNNServer, RefServer)):
        with Server(store, max_batch=4, max_wait_ms=1.0) as server:
            with F.armed("serve.before_reply", at_hits=(0,)):
                with pytest.raises(F.SimulatedCrash):
                    server.classify([1, 2], timeout=WAIT)
            # the next batch is healthy: the failed reply leaked no state
            got = server.classify([1, 2], timeout=WAIT)
            st = server.stats()
        assert _is_argmax(got, expect[[1, 2]])
        out.append((got.tolist(), st["n_requests"], st["n_queries"],
                    st["n_batches"], st["snapshot_version"]))
    assert out[0] == out[1]


def test_scheduler_thread_killed_by_crash_old_snapshot_serves(graph):
    b = _built(graph, key=6)
    out = []
    for store, F in _both(b):
        v0 = store.version
        final0 = store.snapshot().final_np.copy()
        rng = np.random.default_rng(6)
        store.start_scheduler(refresh_every_updates=1,
                              refresh_budget_ms=None, tick_s=0.002)
        try:
            with F.armed("store.mid_layer_refresh", at_hits=(0,)):
                store.update_features([11], rng.normal(size=(1, 16))
                                      .astype(np.float32))
                t = store._sched_thread
                t.join(timeout=WAIT)            # SimulatedCrash kills it
                assert not t.is_alive()
            assert store.version == v0 and store.dirty
            np.testing.assert_array_equal(store.snapshot().final_np, final0)
        finally:
            store.stop_scheduler(timeout=WAIT)
        info = store.refresh()                   # recovery after "restart"
        out.append((v0, store.version, info["rows_per_layer"]))
    assert out[0] == out[1]
    _assert_close(b.port.snapshot().final_np, b.ref.snapshot().final_np)
    assert _is_argmax(b.port.predict_meta(np.arange(30))[0],
                      _ref_logits(b, b.port.graph)[:30])


def test_scheduler_background_refresh_converges(graph):
    """The scheduler's timing is the port's own, so the oracle is the
    reference forward before and after the update: every answer read
    while it converges is one of the two."""
    b = _built(graph, key=7, with_ref=False)
    store = b.port
    probe = np.arange(30)
    prefixes = [_ref_logits(b, store.graph)[probe]]
    rng = np.random.default_rng(7)
    rows = rng.normal(size=(4, 16)).astype(np.float32)
    shadow = _copy(store.graph)
    shadow.feats[np.arange(4)] = rows
    prefixes.append(_ref_logits(b, shadow)[probe])
    answers = []
    store.start_scheduler(refresh_every_updates=2, refresh_budget_ms=5.0,
                          tick_s=0.002)
    try:
        store.update_features(np.arange(4), rows)
        deadline = time.monotonic() + 20.0
        while store.dirty and time.monotonic() < deadline:
            answers.append(store.predict_meta(probe))
            time.sleep(0.005)
    finally:
        store.stop_scheduler(timeout=WAIT)
    assert not store.dirty
    st = store.refresh_stats()
    assert st["sched_refreshes"] >= 1 and st["pending_updates"] == 0
    for preds, ver, _ in answers:
        assert any(_is_argmax(preds, p) for p in prefixes), ver
    assert _is_argmax(store.predict_meta(probe)[0], prefixes[-1])


# ---------------------------------------------------------------------------
# staleness SLO
# ---------------------------------------------------------------------------

def test_max_staleness_forces_synchronous_refresh(graph):
    b = _built(graph, key=8)
    out = []
    for (store, _), Server in zip(_both(b), (GNNServer, RefServer)):
        rng = np.random.default_rng(8)
        with Server(store, max_batch=8, max_wait_ms=1.0,
                    max_staleness_s=0.05) as server:
            server.classify([0], timeout=WAIT)
            store.update_features([6], rng.normal(size=(1, 16))
                                  .astype(np.float32))
            time.sleep(0.1)                      # age past the bound
            ans = server.submit([6, 7], with_meta=True).result(timeout=WAIT)
            assert type(ans).__name__ == "ServedAnswer"
            assert store is not b.port or isinstance(ans, ServedAnswer)
            # the hard SLO: the breach forced a refresh, so the answer is
            # fresh, from the new version
            assert ans.staleness_s <= 0.05
            assert ans.snapshot_version == 2
            assert server.stats()["n_forced_refresh"] >= 1
        out.append((ans.preds.tolist(), ans.snapshot_version))
    assert out[0] == out[1]
    assert _is_argmax(out[0][0], _ref_logits(b, b.port.graph)[[6, 7]])


def test_max_staleness_none_serves_stale(graph):
    b = _built(graph, key=9)
    before = _ref_logits(b, b.port.graph)
    out = []
    for (store, _), Server in zip(_both(b), (GNNServer, RefServer)):
        rng = np.random.default_rng(9)
        with Server(store, max_batch=8, max_wait_ms=1.0,
                    max_staleness_s=None) as server:
            store.update_features([2], rng.normal(size=(1, 16))
                                  .astype(np.float32))
            time.sleep(0.02)
            ans = server.submit([2], with_meta=True).result(timeout=WAIT)
            # no refresh on the serve path: old version, staleness reported
            assert ans.snapshot_version == 1
            assert ans.staleness_s > 0.0
            assert server.stats()["n_forced_refresh"] == 0
        assert store.dirty                       # still pending
        out.append((ans.preds.tolist(), ans.snapshot_version,
                    store.pending_updates()))
    assert out[0] == out[1]
    assert _is_argmax(out[0][0], before[[2]])


# ---------------------------------------------------------------------------
# overload protection
# ---------------------------------------------------------------------------

def test_overload_fail_fast(graph):
    b = _built(graph, key=10)
    expect = _ref_logits(b, b.port.graph)
    out = []
    for (store, _), Server in zip(_both(b), (GNNServer, RefServer)):
        server = Server(store, max_batch=4, queue_depth=2,
                        overload="fail", start=False)
        futs = [server.submit([i]) for i in range(2)]
        with pytest.raises(Exception) as e:
            server.submit([2])
        assert type(e.value).__name__ == "ServerOverloadedError"
        assert server.stats()["n_overload"] == 1
        server.start()
        try:
            got = [f.result(timeout=WAIT)[0] for f in futs]
        finally:
            server.close()
        assert _is_argmax(got, expect[:2])
        st = server.stats()
        out.append((got, st["n_overload"], st["n_requests"]))
    assert isinstance(e.value, RuntimeError)
    assert out[0] == out[1]
    assert issubclass(ServerOverloadedError, RuntimeError)


def test_overload_block_times_out(graph):
    b = _built(graph, key=11)
    out = []
    for (store, _), Server in zip(_both(b), (GNNServer, RefServer)):
        server = Server(store, queue_depth=1, overload="block",
                        submit_timeout_s=0.05, start=False)
        f0 = server.submit([0])
        t0 = time.monotonic()
        with pytest.raises(Exception) as e:
            server.submit([1])
        assert type(e.value).__name__ == "ServerOverloadedError"
        assert time.monotonic() - t0 >= 0.04     # blocked, then failed
        server.close()
        with pytest.raises(RuntimeError, match="server closed"):
            f0.result(timeout=5.0)
        out.append(server.stats()["n_overload"])
    assert out == [1, 1]


def test_deadline_shed_before_lookup(graph):
    b = _built(graph, key=12)
    expect = _ref_logits(b, b.port.graph)
    out = []
    for (store, _), Server in zip(_both(b), (GNNServer, RefServer)):
        server = Server(store, max_batch=8, max_wait_ms=1.0, start=False)
        expired = server.submit([0], deadline_s=0.01)
        live = server.submit([1])
        time.sleep(0.05)
        server.start()
        try:
            with pytest.raises(Exception) as e:
                expired.result(timeout=WAIT)
            assert type(e.value).__name__ == "DeadlineExceededError"
            got = live.result(timeout=WAIT)[0]
            st = server.stats()
        finally:
            server.close()
        assert _is_argmax([got], expect[[1]])
        out.append((int(got), st["n_shed"], st["n_requests"],
                    st["n_queries"]))
    assert isinstance(e.value, RuntimeError)
    assert out[0] == out[1] and out[0][1] == 1
    assert issubclass(DeadlineExceededError, RuntimeError)


def test_close_drains_queue_and_fails_futures(graph):
    b = _built(graph, key=13, with_ref=False)
    server = GNNServer(b.port, start=False)
    futs = [server.submit([i]) for i in range(3)]
    server.close()
    for f in futs:
        with pytest.raises(RuntimeError, match="server closed"):
            f.result(timeout=5.0)
    with pytest.raises(RuntimeError, match="closed"):
        server.submit([0])
    server.close()                            # idempotent
    assert server._thread is None             # never started
    assert server.stats()["n_requests"] == 0


# ---------------------------------------------------------------------------
# bounded stats
# ---------------------------------------------------------------------------

def test_reservoir_bounds_latency_memory():
    got, want = _Reservoir(cap=16, seed=0), RefReservoir(cap=16, seed=0)
    for i in range(1000):
        got.add(float(i))
        want.add(float(i))
    assert got.n == 1000 and len(got.values()) == 16
    # a uniform sample: it spans the stream, not just the head
    assert got.values().max() > 500
    np.testing.assert_array_equal(got.values(), want.values())

    stats, ref = ServeStats(reservoir=8), RefStats(reservoir=8)
    for b in range(50):
        for s in (stats, ref):
            s.record(1, 4, [1.0, 2.0, 3.0, 4.0], 0.0, 1.0,
                     version=b, staleness_s=0.01 * b)
    snap = stats.snapshot()
    assert len(stats._lat._buf) == 8          # bounded under traffic
    for key in ("n_requests", "n_queries", "n_batches",
                "mean_batch_queries", "p50_ms", "p99_ms", "mean_ms",
                "qps", "snapshot_version", "staleness_last_s",
                "staleness_max_s", "n_shed", "n_overload",
                "n_forced_refresh"):
        assert key in snap, key
    assert snap["n_requests"] == 50 and snap["snapshot_version"] == 49
    assert snap["staleness_max_s"] == pytest.approx(0.49)
    assert snap == ref.snapshot()


# ---------------------------------------------------------------------------
# the headline property: concurrent writers against queries
# ---------------------------------------------------------------------------

def _update_stream(n, feat_dim, rng):
    updates = []
    for i in range(6):
        if i % 3 == 2:                        # every third is structural
            src = rng.choice(n, size=2, replace=False)
            dst = rng.choice(n, size=2, replace=False)
            updates.append(("edges", src, dst))
        else:
            nodes = rng.choice(n, size=4, replace=False)
            feats = rng.normal(size=(4, feat_dim)).astype(np.float32)
            updates.append(("feats", nodes, feats))
    return updates


def _apply(store, update):
    kind, a, c = update
    if kind == "feats":
        store.update_features(a, c)
    else:
        store.add_edges(a, c)


def _prefix_logits(b: Built, graph, updates):
    """The reference forward at every prefix of ``updates``: a reference
    store marched through the stream gives each prefix's graph."""
    shadow = RefStore(b.ref_params, RefConfig(**b.kw), _copy(graph),
                      chunk_size=64)
    out = [_ref_logits(b, shadow.graph)]
    for u in updates:
        _apply(shadow, u)
        shadow._drain_apply()
        out.append(_ref_logits(b, shadow.graph))
    return out


def test_concurrent_writers_vs_queries_prefix_consistent(graph):
    """A writer streams feature and edge updates while two query threads
    hammer the server: no crash, and every answer is the reference
    forward's argmax at some prefix of the stream (a torn snapshot
    matches none)."""
    rng = np.random.default_rng(42)
    updates = _update_stream(graph.n, 16, rng)
    b = _built(graph, key=20, with_ref=False)
    prefixes = _prefix_logits(b, graph, updates)
    store = b.port
    qnodes = np.arange(0, graph.n, 7)         # fixed probe set
    want = [p[qnodes] for p in prefixes]
    answers, errors = [], []
    stop = threading.Event()

    server = GNNServer(store, max_batch=32, max_wait_ms=0.5,
                       max_staleness_s=0.25,
                       refresh_every_updates=2, refresh_budget_ms=20.0)
    try:
        def writer():
            try:
                for u in updates:
                    _apply(store, u)
                    time.sleep(0.02)
            except Exception as e:            # pragma: no cover
                errors.append(e)
            finally:
                stop.set()

        def querier():
            try:
                while not stop.is_set() or len(answers) < 3:
                    answers.append(server.submit(qnodes, with_meta=True)
                                   .result(timeout=WAIT))
                    if len(answers) > 400:
                        break
            except Exception as e:            # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=writer)] + \
            [threading.Thread(target=querier) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        assert not any(t.is_alive() for t in threads)
        # let the scheduler catch up; then a query must match the fully
        # applied state
        deadline = time.monotonic() + 20.0
        while store.dirty and time.monotonic() < deadline:
            time.sleep(0.01)
        final = server.classify(qnodes, timeout=WAIT)
    finally:
        server.close()

    assert not errors, errors
    assert len(answers) >= 3
    for ans in answers:
        assert any(_is_argmax(ans.preds, w) for w in want), \
            "answer matches no prefix of the stream (torn snapshot?)"
        assert ans.staleness_s <= 0.25 + 0.2  # SLO + scheduling slack
    assert _is_argmax(final, want[-1])
    # the incremental end state equals a from-scratch recompute
    _assert_close(store.snapshot().final_np, prefixes[-1],
                  "final table vs the reference forward on the final graph")
    assert not store.dirty and store.pending_updates() == 0
