"""The supervised prefetcher under worker faults, on the port, held
against the live reference: the five prefetcher scenarios of
tests/test_chaos.py, and one more, a transient fault after the batch's
draw (in the gather), which only the rng's rewind replays: the
reference's faults all fire before the draw.

Each scenario runs on the port's ``Prefetcher`` and on the reference's,
with the same graph (the port's ``make_sbm_graph`` at the conftest's
arguments, array-equal to the reference's ``small_graph``), the same
seed and the same armed fault schedule (``faults.flaky`` on each
package's own ``sample_batch`` or ``gather_features``).  The outcome is deterministic: the
delivered batches (every hop's node ids and the gathered features) are
array-equal, and the restart counts, the calls the schedule saw and the
errors raised are the same.

Unlike the reference test, the budget test enters ``pytest.warns``
before the prefetcher starts its worker: a worker that fails at once
can warn before a block entered afterwards is listening.  Every
``next()`` that may block runs with a deadline."""
import dataclasses
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.core import faults as ref_faults  # noqa: E402
from repro.core.prefetch import Prefetcher as RefPrefetcher  # noqa: E402
from repro.core.sampler import gather_features as ref_gather_features  # noqa: E402,E501
from repro.core.sampler import sample_batch as ref_sample_batch  # noqa: E402

from repro_torch.core import faults  # noqa: E402
from repro_torch.core.prefetch import Prefetcher  # noqa: E402
from repro_torch.core.sampler import gather_features, sample_batch  # noqa: E402,E501
from repro_torch.data.synth import make_sbm_graph  # noqa: E402

WAIT = 30.0

#: (Prefetcher, sample_batch, faults) of the port, then the reference
PACKAGES = ((Prefetcher, sample_batch, faults),
            (RefPrefetcher, ref_sample_batch, ref_faults))


@pytest.fixture(autouse=True)
def _no_armed_failpoints():
    yield
    faults.disarm()
    ref_faults.disarm()


@pytest.fixture(scope="module")
def graph(small_graph):
    g = make_sbm_graph(n=300, n_classes=4, avg_degree=10, feat_dim=16,
                       seed=1)
    for f in dataclasses.fields(g):
        np.testing.assert_array_equal(getattr(g, f.name),
                                      getattr(small_graph, f.name))
    return g


def _next(pf):
    """``pf.next()`` on a helper thread, bounded by WAIT: the outcome
    (("ok", item) or ("raised", exception))."""
    box = {}

    def call():
        try:
            box["out"] = ("ok", pf.next())
        except BaseException as e:          # noqa: BLE001 - the outcome
            box["out"] = ("raised", e)

    t = threading.Thread(target=call, daemon=True)
    t.start()
    t.join(timeout=WAIT)
    assert not t.is_alive(), "Prefetcher.next() blocked"
    return box["out"]


def _drain(pf, limit=16):
    """Every batch until the stream ends: ([(fb, payload)], final
    exception)."""
    got = []
    for _ in range(limit):
        kind, item = _next(pf)
        if kind == "raised":
            return got, item
        got.append(item)
    raise AssertionError("stream did not end")


def _assert_batches_equal(a, b):
    assert len(a) == len(b)
    for (fa, pa), (fb, pb) in zip(a, b):
        assert len(fa.nodes) == len(fb.nodes)
        for x, y in zip(fa.nodes, fb.nodes):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        assert len(pa) == len(pb)
        for x, y in zip(pa, pb):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_transient_worker_fault_restart_preserves_sequence(graph):
    out = []
    for P, sample, F in PACKAGES:
        clean = P(graph, 16, (3,), seed=0, n_batches=6)
        try:
            want, end = _drain(clean)
        finally:
            clean.close()
        assert isinstance(end, StopIteration)
        flaky = F.flaky(sample, fail_at={2})
        with pytest.warns(RuntimeWarning, match="transient"):
            pf = P(graph, 16, (3,), seed=0, n_batches=6, sample_fn=flaky,
                   backoff=0.001)
            try:
                got, end = _drain(pf)
            finally:
                pf.close()
        assert isinstance(end, StopIteration)
        assert pf.restarts == 1
        # batch 2 replayed, not skipped: the sequence of a clean run
        _assert_batches_equal(got, want)
        out.append((got, pf.restarts, flaky.calls["n"]))
    _assert_batches_equal(out[0][0], out[1][0])
    assert out[0][1:] == out[1][1:] == (1, 7)


def test_transient_payload_fault_replays_the_draw(graph):
    """A transient fault after the batch's draw (in the gather): the
    restarted worker rewinds the rng to before that draw, so the batch is
    drawn again, not skipped; the sequence is a clean run's and the
    reference's."""
    out = []
    for (P, _, F), gather in zip(PACKAGES, (gather_features,
                                            ref_gather_features)):
        clean = P(graph, 16, (3,), seed=0, n_batches=6)
        try:
            want, _ = _drain(clean)
        finally:
            clean.close()
        flaky = F.flaky(gather, fail_at={2})
        with pytest.warns(RuntimeWarning, match="transient"):
            pf = P(graph, 16, (3,), seed=0, n_batches=6, payload_fn=flaky,
                   backoff=0.001)
            try:
                got, end = _drain(pf)
            finally:
                pf.close()
        assert isinstance(end, StopIteration) and pf.restarts == 1
        _assert_batches_equal(got, want)
        out.append(got)
    _assert_batches_equal(out[0], out[1])


def test_restart_budget_exhaustion_escalates_to_fatal(graph):
    out = []
    for P, sample, F in PACKAGES:
        flaky = F.flaky(sample, fail_at=range(10))
        with pytest.warns(RuntimeWarning, match="transient") as seen:
            pf = P(graph, 16, (3,), n_batches=4, sample_fn=flaky,
                   max_restarts=2, backoff=0.001)
            try:
                got, end = _drain(pf)
            finally:
                pf.close()
        assert got == []
        assert isinstance(end, F.TransientSamplerFault)
        out.append((pf.restarts, flaky.calls["n"],
                    sum("transient" in str(w.message) for w in seen)))
    assert out[0] == out[1] == (2, 3, 2)


def test_fatal_worker_fault_surfaces_immediately(graph):
    out = []
    for P, sample, F in PACKAGES:
        flaky = F.flaky(sample, fail_at={1}, exc=F.FatalSamplerFault)
        pf = P(graph, 16, (3,), n_batches=4, sample_fn=flaky)
        try:
            got, end = _drain(pf)            # batch 0 fine, then fatal
        finally:
            pf.close()
        assert len(got) == 1
        assert isinstance(end, F.FatalSamplerFault)
        assert pf.restarts == 0              # fatal is not transient
        out.append((got, flaky.calls["n"]))
    _assert_batches_equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1] == 2


def test_next_after_sentinel_raises_immediately(graph):
    """Post-exhaustion next() re-raises at once instead of blocking on
    the drained queue."""
    out = []
    for P, _, _ in PACKAGES:
        pf = P(graph, 16, (3,), n_batches=2)
        try:
            got, end = _drain(pf)
            assert isinstance(end, StopIteration)
            t0 = time.perf_counter()
            for _ in range(3):
                kind, exc = _next(pf)
                assert kind == "raised" and isinstance(exc, StopIteration)
            assert time.perf_counter() - t0 < 2.0
        finally:
            pf.close()
        out.append(got)
    _assert_batches_equal(out[0], out[1])


def test_fatal_error_reraised_after_sentinel(graph):
    out = []
    for P, sample, F in PACKAGES:
        flaky = F.flaky(sample, fail_at={0}, exc=F.FatalSamplerFault)
        pf = P(graph, 16, (3,), n_batches=2, sample_fn=flaky)
        try:
            errors = [_next(pf) for _ in range(3)]
        finally:
            pf.close()
        # every call: the same stored error
        assert all(k == "raised" for k, _ in errors)
        assert all(e is errors[0][1] for _, e in errors)
        assert isinstance(errors[0][1], F.FatalSamplerFault)
        out.append((str(errors[0][1]), flaky.calls["n"]))
    assert out[0] == out[1]
