"""The engine's lifecycle on the port, held against the live reference:
the scenarios of tests/test_engine_throughput.py whose mechanism the port
has (in-place updates and the deferred host read changing nothing, the
drain of the lagged record, the synchronous fallback of stop targets,
padded partial batches, the staging ring's extra slot, the device ELL's
eviction, idempotent closes).

Runs go through both packages' ``Trainer`` from the same initial
parameters (the reference's ``init_gnn``, carried across as numpy) on
the same graph (each package's ``make_sbm_graph`` at the reference
test's arguments, array-equal).  Losses are compared at 1e-4 (f32; the
frameworks sum in other orders and SGD compounds that over the steps);
lengths, stop reasons and ``nodes_processed`` exactly.

Not ported from that file: ``test_step_cached_across_trainers_and_compiles_once``
and ``test_fn_cache_evicts_stale_consts_entries`` test JAX's compiled-step
caches, which the eager port has no counterpart of; the engine bench's
two tests drive ``benchmarks/bench_engine.py``, the reference's bench.
Its ``ShardedFullGraphSource`` tests are held by
tests/test_torch_sharded_kernel.py (one shard bit-equal to the unsharded
path, four shards against the reference, the memoized uploads)."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.configs.base import GNNConfig as RefConfig  # noqa: E402
from repro.core import engine as RE  # noqa: E402
from repro.core import gnn as RG  # noqa: E402
from repro.data import make_sbm_graph as ref_make  # noqa: E402

from repro_torch.configs.base import GNNConfig  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.data.synth import make_sbm_graph  # noqa: E402

LOSS_TOL = 1e-4


def _graphs(n=240, seed=11):
    kw = dict(n=n, n_classes=4, avg_degree=8, feat_dim=16, seed=seed)
    rg, tg = ref_make(**kw), make_sbm_graph(**kw)
    for f in dataclasses.fields(tg):
        np.testing.assert_array_equal(getattr(tg, f.name),
                                      getattr(rg, f.name))
    return rg, tg


def _kw(g, **kw):
    base = dict(name="tp", model="graphsage", n_nodes=g.n,
                feat_dim=g.feats.shape[1], hidden=32,
                n_classes=g.n_classes, n_layers=2, fanout=(5, 3),
                batch_size=64, loss="ce")
    base.update(kw)
    return base


def _init(kw, seed=0):
    params = RG.init_gnn(jax.random.key(seed), RefConfig(**kw),
                         kw["feat_dim"])
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


def _runs(rg, tg, kw, plan_kw, ref_source, port_source, port_cbs=(),
          ref_cbs=()):
    """The same plan on both Trainers: (port result, reference result)."""
    want = RE.Trainer(rg, RefConfig(**kw), RE.TrainPlan(**plan_kw),
                      source=ref_source, extra_callbacks=list(ref_cbs)).run()
    got = TE.Trainer(tg, GNNConfig(**kw), TE.TrainPlan(**plan_kw),
                     source=port_source, extra_callbacks=list(port_cbs),
                     params=_init(kw), device="cpu").run()
    return got, want


def _assert_losses(got, want):
    assert len(got.history.losses) == len(want.history.losses)
    np.testing.assert_allclose(got.history.losses, want.history.losses,
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    assert got.history.nodes_processed == want.history.nodes_processed
    assert got.stop_reason == want.stop_reason


@pytest.mark.parametrize("name", ["FullGraphSource", "SampledSource"])
def test_fast_path_off_is_identical(name):
    """In-place updates (``donate``) and the lagged host read
    (``deferred_sync``) change no loss, accuracy or tracked full loss:
    bit-equal with both off, and the reference's at 1e-4."""
    rg, tg = _graphs(seed=12)
    kw = _kw(rg)
    on = dict(lr=0.3, n_iters=8, eval_every=3, seed=0,
              track_full_loss_every=4)
    off = dict(on, donate=False, deferred_sync=False)
    got, want = _runs(rg, tg, kw, on, getattr(RE, name)(),
                      getattr(TE, name)())
    plain = TE.Trainer(tg, GNNConfig(**kw), TE.TrainPlan(**off),
                       source=getattr(TE, name)(), params=_init(kw),
                       device="cpu").run()
    assert got.history.losses == plain.history.losses
    assert got.history.val_accs == plain.history.val_accs
    assert got.history.full_losses == plain.history.full_losses
    assert got.final_test_acc == plain.final_test_acc
    _assert_losses(got, want)
    np.testing.assert_allclose(got.history.full_losses,
                               want.history.full_losses, rtol=LOSS_TOL,
                               atol=LOSS_TOL)


def test_deferred_sync_drains_pending_on_callback_stop():
    """A callback stop mid-pipeline drains the lagged record: History
    stays aligned with the params the run returns."""
    rg, tg = _graphs(seed=13)
    kw = _kw(rg)

    def stop_at_3(base):
        class StopAt3(base):
            def on_step(self, state):
                if state.it == 3:
                    state.request_stop("by-callback")
        return StopAt3()

    got, want = _runs(rg, tg, kw, dict(lr=0.3, n_iters=20, eval_every=100,
                                       seed=0),
                      RE.FullGraphSource(), TE.FullGraphSource(),
                      port_cbs=[stop_at_3(TE.Callback)],
                      ref_cbs=[stop_at_3(RE.Callback)])
    assert TE._deferred_mode(TE.TrainPlan(n_iters=20))
    assert got.stop_reason == "by-callback"
    # record 3 triggered the stop while step 4 was already dispatched;
    # the drain records it, so params == params after the last row
    assert len(got.history.losses) == 5
    _assert_losses(got, want)


def test_stop_targets_fall_back_to_synchronous():
    """A target_loss run needs the loss on the host at once: History
    ends exactly at the crossing iteration."""
    rg, tg = _graphs(seed=14)
    plan = dict(lr=0.3, n_iters=100, target_loss=1.0, seed=0)
    assert not TE._deferred_mode(TE.TrainPlan(**plan))
    got, want = _runs(rg, tg, _kw(rg), plan, RE.FullGraphSource(),
                      TE.FullGraphSource())
    assert got.history.losses[-1] <= 1.0
    assert all(loss > 1.0 for loss in got.history.losses[:-1])
    _assert_losses(got, want)


def test_partial_batch_pads_to_plan_batch_size():
    """b > n_train: every batch pads up to b with masked-out rows (one
    batch shape for the whole run), the loss sequence matches the
    exact-fit batch size to float-sum tolerance, and nodes_processed
    records the valid count."""
    rg, tg = _graphs(n=60, seed=16)
    n_train = len(tg.train_nodes)
    b = n_train + 18
    kw = _kw(rg, n_layers=2, fanout=(4, 2), batch_size=b)
    plan = dict(lr=0.3, n_iters=6, eval_every=3, seed=0)
    src = TE.SampledSource(batch_size=b)
    shapes, to_device = [], src._to_device

    def recording(payload):
        batch = to_device(payload)
        shapes.append(tuple(t.shape[0] for t in batch[0]))
        return batch

    src._to_device = recording
    got, want = _runs(rg, tg, kw, plan, RE.SampledSource(batch_size=b), src)
    assert shapes == [(b, b, b)] * 6
    assert src.pad == 18
    assert got.history.nodes_processed[0] == n_train
    _assert_losses(got, want)
    exact = TE.Trainer(tg, GNNConfig(**kw), TE.TrainPlan(**plan),
                       source=TE.SampledSource(batch_size=n_train),
                       params=_init(kw), device="cpu").run()
    np.testing.assert_allclose(got.history.losses, exact.history.losses,
                               atol=1e-6, rtol=1e-6)


def test_sampled_ring_grows_one_slot_under_deferred_sync():
    rg, tg = _graphs(seed=17)
    kw = _kw(rg)
    cfg = GNNConfig(**kw)
    deferred = TE.SampledSource().bind(tg, cfg, TE.TrainPlan(n_iters=2),
                                       "cpu")
    synced = TE.SampledSource().bind(
        tg, cfg, TE.TrainPlan(n_iters=2, deferred_sync=False), "cpu")
    ref_deferred = RE.SampledSource().bind(rg, RefConfig(**kw),
                                           RE.TrainPlan(n_iters=2))
    ref_synced = RE.SampledSource().bind(
        rg, RefConfig(**kw), RE.TrainPlan(n_iters=2, deferred_sync=False))
    sizes = [s._ring._free.qsize() for s in (deferred, synced)]
    assert sizes[0] == sizes[1] + 1
    assert sizes == [s._ring._free.qsize()
                     for s in (ref_deferred, ref_synced)]
    for s in (deferred, synced, ref_deferred, ref_synced):
        s.close()


def test_device_ell_evicts_stale_keys():
    """One resident ELL width besides the width-free uploads: a sweep
    over distinct max_deg values does not accrete one [n, K] upload per
    grid point."""
    _, g = _graphs(seed=18)
    cache = TE._graph_cache(g)

    def widths():
        return sorted(k[2] for k in cache if k[0] == "ell")

    TE._device_ell(g, 4, "cpu")
    assert widths() == [4]
    TE._device_ell(g, 6, "cpu")
    assert widths() == [6]
    assert ("base", "cpu") in cache
    TE._device_ell(g, None, "cpu")        # full width evicts the capped
    assert widths() == [g.d_max]
    # the reverse index lives beside its ELL and goes with it
    TE._device_reverse_index(g, None, "cpu")
    assert ("rev", "cpu", g.d_max) in cache
    TE._device_ell(g, 4, "cpu")
    assert widths() == [4] and not any(k[0] == "rev" for k in cache)
    idx = TE._device_ell(g, 4, "cpu")[0]
    assert tuple(idx.shape) == (g.n, 4)


def test_source_close_is_idempotent():
    _, g = _graphs(seed=19)
    cfg = GNNConfig(**_kw(g))
    plan = TE.TrainPlan(lr=0.3, n_iters=3, seed=0)
    for src in (TE.FullGraphSource(), TE.SampledSource()):
        t = TE.Trainer(g, cfg, plan, source=src, device="cpu")
        t.run()                          # run() closes in its finally
        src.close()                      # and closing again is a no-op
        src.close()
        t.close()
        t.close()
    assert TE.FullGraphSource().bind(g, cfg, plan, "cpu").ell is not None


def test_trainer_close_releases_ell_reference():
    _, g = _graphs(seed=20)
    t = TE.Trainer(g, GNNConfig(**_kw(g)),
                   TE.TrainPlan(lr=0.3, n_iters=2, seed=0),
                   source=TE.FullGraphSource(), device="cpu")
    t.run()
    t.close()
    assert t._ell is None and t.source.ell is None
    assert t._feats_plan is None
