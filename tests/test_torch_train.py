"""The port's training slice against the live reference: the engine's
four scenarios of tests/test_engine.py (run on both packages from the
same carried-across initial parameters), batch streams array-equal,
``run_experiment``/``sweep`` rows, the launch entry point, and the engine's
own contracts (guarded update, refusals of what is not ported).

Tolerances: losses and tracked full losses 1e-4 (f32; the two
frameworks sum in other orders, and 12 SGD steps compound that), the
validation/test accuracies within one node's share of their split, and
``nodes_processed`` exactly.  The reference runs its plain (einsum)
path; the port runs its plain path, or its kernel path through the
kernels' plain versions on these CPU tensors."""
import dataclasses
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs.base import GNNConfig as RefConfig  # noqa: E402
from repro.core import engine as RE  # noqa: E402
from repro.core import experiment as RX  # noqa: E402
from repro.core import gnn as RG  # noqa: E402
from repro.core import trainer as RT  # noqa: E402

from repro_torch.configs.base import GNNConfig  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core import experiment as TX  # noqa: E402
from repro_torch.core import trainer as TT  # noqa: E402
from repro_torch.core.metrics import History  # noqa: E402
from repro_torch.data.synth import make_sbm_graph  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402

LOSS_TOL = 1e-4


@pytest.fixture(scope="module")
def graphs():
    """The conftest graph on both packages (array-equal by
    tests/test_torch_host.py)."""
    from repro.data import make_sbm_graph as ref_make
    kw = dict(n=300, n_classes=4, avg_degree=10, feat_dim=16, seed=1)
    return ref_make(**kw), make_sbm_graph(**kw)


def _kw(g, **kw):
    base = dict(name="t", model="graphsage", n_nodes=g.n,
                feat_dim=g.feats.shape[1], hidden=32,
                n_classes=g.n_classes, n_layers=2, fanout=(5, 3),
                batch_size=64, loss="ce")
    base.update(kw)
    return base


def _init(kw, seed):
    """The reference Trainer's own initial parameters for ``seed``, as
    numpy: what the port's Trainer is handed."""
    params = RG.init_gnn(jax.random.key(seed), RefConfig(**kw),
                         kw["feat_dim"])
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


def _assert_history_close(got, want, n_split, name):
    hg, hw = got.history, want.history
    assert len(hg.losses) == len(hw.losses), name
    np.testing.assert_allclose(hg.losses, hw.losses, rtol=LOSS_TOL,
                               atol=LOSS_TOL, err_msg=name)
    np.testing.assert_allclose(hg.full_losses, hw.full_losses,
                               rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=name)
    assert hg.full_loss_iters == hw.full_loss_iters, name
    assert hg.val_acc_iters == hw.val_acc_iters, name
    share = 1.0 / n_split[0] + 1e-6
    np.testing.assert_allclose(hg.val_accs, hw.val_accs, atol=share,
                               rtol=0, err_msg=name)
    assert hg.nodes_processed == hw.nodes_processed, name
    assert abs(got.final_test_acc - want.final_test_acc) <= \
        1.0 / n_split[1] + 1e-6, name
    assert got.stop_reason == want.stop_reason, name


def _splits(g):
    return len(g.val_nodes), len(g.test_nodes)


@pytest.mark.parametrize("kernel", [False, True])
def test_fullgraph_matches_reference(graphs, kernel):
    """train_full_graph, 12 iterations: reference plain path vs the
    port's plain path and its kernel path (autograd Function + plain
    backward on CPU)."""
    rg, tg = graphs
    kw = _kw(rg)
    want = RT.train_full_graph(rg, RefConfig(**kw), lr=0.3, n_iters=12,
                               eval_every=5, seed=0)
    got = TT.train_full_graph(tg, GNNConfig(**dict(kw, use_agg_kernel=kernel)),
                              lr=0.3, n_iters=12, eval_every=5, seed=0,
                              params=_init(kw, 0), device="cpu")
    _assert_history_close(got, want, _splits(rg), "full_graph")
    assert len(got.history.losses) == 12
    assert got.history.full_losses == got.history.losses


def test_fullgraph_target_loss_matches_reference(graphs):
    rg, tg = graphs
    kw = _kw(rg)
    want = RT.train_full_graph(rg, RefConfig(**kw), lr=0.3, n_iters=50,
                               eval_every=10, seed=0, target_loss=1.2)
    got = TT.train_full_graph(tg, GNNConfig(**kw), lr=0.3, n_iters=50,
                              eval_every=10, seed=0, target_loss=1.2,
                              params=_init(kw, 0), device="cpu")
    _assert_history_close(got, want, _splits(rg), "full_graph_target")
    assert got.stop_reason == "target_loss<=1.2"
    assert len(got.history.losses) < 50


@pytest.mark.parametrize("prefetch", [False, True])
def test_minibatch_matches_reference(graphs, prefetch):
    rg, tg = graphs
    kw = _kw(rg)
    want = RT.train_minibatch(rg, RefConfig(**kw), lr=0.3, n_iters=12,
                              eval_every=5, seed=0, track_full_loss_every=4,
                              prefetch=prefetch)
    got = TT.train_minibatch(tg, GNNConfig(**kw), lr=0.3, n_iters=12,
                             eval_every=5, seed=0, track_full_loss_every=4,
                             prefetch=prefetch, params=_init(kw, 0),
                             device="cpu")
    _assert_history_close(got, want, _splits(rg), f"minibatch {prefetch}")
    assert got.history.full_loss_iters == [1, 5, 9]


def test_minibatch_explicit_b_fanout_matches_reference(graphs):
    rg, tg = graphs
    kw = _kw(rg)
    want = RT.train_minibatch(rg, RefConfig(**kw), lr=0.3, n_iters=8,
                              batch_size=32, fanouts=(4, 2), eval_every=3,
                              seed=7, prefetch=True)
    got = TT.train_minibatch(tg, GNNConfig(**dict(kw, use_agg_kernel=True)),
                             lr=0.3, n_iters=8, batch_size=32,
                             fanouts=(4, 2), eval_every=3, seed=7,
                             prefetch=True, params=_init(kw, 7),
                             device="cpu")
    _assert_history_close(got, want, _splits(rg), "minibatch_b32")
    assert got.history.nodes_processed == [32] * 8


def _stream(source, bind_args, n):
    """The first ``n`` host batches of a bound source, copied out (the
    staging slots are recycled by ``done``)."""
    src = source.bind(*bind_args)
    out = []
    gen = src.batches()
    for _ in range(n):
        batch, nodes = next(gen)
        flat = []
        for leaf in batch:
            for x in (leaf if isinstance(leaf, (list, tuple)) else [leaf]):
                flat.append(np.array(x))
        out.append((flat, nodes))
        src.done(batch)
    gen.close()
    src.close()
    return out


@pytest.mark.parametrize("b,prefetch", [(64, False), (64, True),
                                        (500, True)])
def test_batch_streams_are_array_equal(graphs, b, prefetch):
    """Same seed, same batches, in the sync path and through the
    Prefetcher; b > n_train pads with a validity column on both."""
    rg, tg = graphs
    kw = _kw(rg)
    plan_r = RE.TrainPlan(n_iters=4, seed=3)
    plan_t = TE.TrainPlan(n_iters=4, seed=3)
    want = _stream(RE.SampledSource(batch_size=b, prefetch=prefetch),
                   (rg, RefConfig(**kw), plan_r), 4)
    got = _stream(TE.SampledSource(batch_size=b, prefetch=prefetch),
                  (tg, GNNConfig(**kw), plan_t, torch.device("cpu")), 4)
    for (fw, nw), (fg, ng) in zip(want, got):
        assert nw == ng
        assert len(fw) == len(fg) == (2 * 3 + 2 * 2 + 1
                                      + (1 if b > len(rg.train_nodes)
                                         else 0))
        for a, c in zip(fw, fg):
            assert a.dtype == c.dtype
            np.testing.assert_array_equal(c, a)


def _metric_cols(row):
    keep = ("paradigm", "b", "fanouts", "seed", "iters", "stop_reason")
    return {k: row[k] for k in keep}


def test_sweep_rows_match_reference(graphs):
    """A 2 x 2 (b, β) grid plus the full-graph corner: same points, same
    labels, losses within 1e-4, test accuracy within one node's share."""
    rg, tg = graphs
    kw = _kw(rg)
    plan_r = RE.TrainPlan(lr=0.3, n_iters=4, eval_every=2)
    plan_t = TE.TrainPlan(lr=0.3, n_iters=4, eval_every=2)
    grid = dict(batch_sizes=[32, 64], fanout_grid=[(3, 2), (4, 2)],
                include_fullgraph=True)
    want = RX.sweep(rg, RefConfig(**kw), plan_r, **grid)
    got = TX.sweep(tg, GNNConfig(**kw), plan_t, **grid,
                   init_params=lambda s: _init(kw, s), device="cpu")
    assert len(got) == len(want) == 5
    share = 1.0 / len(rg.test_nodes) + 1e-6
    for rgot, rwant in zip(got, want):
        assert _metric_cols(rgot) == _metric_cols(rwant)
        for k in ("first_loss", "final_loss"):
            assert rgot[k] == pytest.approx(rwant[k], abs=LOSS_TOL,
                                            rel=LOSS_TOL)
        assert abs(rgot["test_acc"] - rwant["test_acc"]) <= share
        assert rgot["throughput_nodes_s"] > 0


def test_run_experiment_reports_targets_and_inference(graphs):
    rg, tg = graphs
    kw = _kw(rg)
    row = TX.run_experiment(tg, GNNConfig(**kw),
                            TE.TrainPlan(lr=0.3, n_iters=6, eval_every=2),
                            paradigm="minibatch", b=32, fanouts=(3, 2),
                            report_loss=1.3, report_acc=0.5,
                            inference=True, serve_queries=8,
                            keep_result=True, device="cpu")
    want = RX.run_experiment(rg, RefConfig(**kw),
                             RE.TrainPlan(lr=0.3, n_iters=6, eval_every=2),
                             paradigm="minibatch", b=32, fanouts=(3, 2),
                             report_loss=1.3, report_acc=0.5,
                             inference=True, serve_queries=8)
    # initial parameters differ (torch generator), so compare the schema
    assert sorted(k for k in row if k != "_result") == sorted(want)
    assert row["fanouts"] == "3x2" and row["b"] == 32
    assert isinstance(row["_result"], TE.TrainResult)
    assert 0.0 <= row["serve_acc"] <= 1.0


def test_sweep_propagates_kernel_failure_without_retry(graphs,
                                                       monkeypatch):
    """No degrade path: a kernel error raises out of sweep at the first
    point and no point is retried without the kernel."""
    _, tg = graphs
    calls = []

    def boom(*a, **kw):
        calls.append(kw)
        raise RuntimeError("triton kernel failed to compile")

    monkeypatch.setattr(TX, "run_experiment", boom)
    cfg = GNNConfig(**_kw(tg, use_agg_kernel=True))
    with pytest.raises(RuntimeError, match="triton"):
        TX.sweep(tg, cfg, TE.TrainPlan(n_iters=2), batch_sizes=[32, 64],
                 fanout_grid=[(3, 2)], device="cpu")
    assert len(calls) == 1


def test_launch_train_smoke_prints_both_paradigms():
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert launch_train.main(["--arch", "gnn-papers100m", "--smoke",
                                  "--device", "cpu", "--steps", "3"]) == 0
    out = json.loads(buf.getvalue())
    assert out["device"] == "cpu"
    for k in ("full_graph", "mini_batch"):
        assert np.isfinite(out[k]["final_loss"])
        assert 0.0 <= out[k]["test_acc"] <= 1.0


@pytest.mark.parametrize("argv,exc,match", [
    (["--arch", "granite-3-2b"], NotImplementedError, "slice 6"),
    (["--arch", "gnn-papers100m", "--smoke", "--device", "cpu",
      "--resume"], NotImplementedError, "slice 3"),
    (["--arch", "gnn-papers100m", "--smoke", "--device", "cpu",
      "--ckpt-every", "5"], NotImplementedError, "slice 3"),
])
def test_launch_train_refuses_what_is_not_ported(argv, exc, match):
    with pytest.raises(exc, match=match):
        launch_train.main(argv)


def test_launch_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        launch_train.main(["--arch", "gnn-papers100m", "--smoke",
                           "--steps", "2"])


def test_engine_refuses_slice3_features(graphs):
    _, tg = graphs
    cfg = GNNConfig(**_kw(tg))
    with pytest.raises(NotImplementedError, match="slice 3"):
        TE.Trainer(tg, cfg, TE.TrainPlan(ckpt_every=2), device="cpu")
    with pytest.raises(NotImplementedError, match="slice 3"):
        TE.BadStepPolicy(on_bad="rollback")
    tr = TE.Trainer(tg, cfg, TE.TrainPlan(n_iters=1),
                    source=TE.FullGraphSource(), device="cpu")
    with pytest.raises(NotImplementedError, match="slice 3"):
        tr.run(resume_from="somewhere")
    for paradigm in ("cluster", "importance", "minibatch_sharded"):
        with pytest.raises(NotImplementedError, match="slice"):
            TX.make_source(paradigm)
    with pytest.raises(NotImplementedError, match="slice 3"):
        TX.sweep(tg, cfg, TE.TrainPlan(), batch_sizes=[8],
                 fanout_grid=[2], journal="j.jsonl", device="cpu")


@pytest.mark.parametrize("inplace", [True, False])
def test_guarded_update_keeps_params_on_a_bad_step(inplace):
    """A non-finite gradient leaves parameters and optimizer state
    bit-for-bit unchanged (on-device select, no host sync); a good step
    applies the update."""
    from repro_torch.optim import sgd
    opt = sgd(0.5, momentum=0.9)
    params = [{"w": torch.ones(3, 2, requires_grad=True)}]
    state = opt.init(params)
    before = params[0]["w"].detach().clone()
    bad = [{"w": torch.full((3, 2), float("nan"))}]
    params, state, good = TE._guarded_update(
        opt, params, state, torch.tensor(1.0), bad, inplace)
    assert not bool(good)
    assert torch.equal(params[0]["w"].detach(), before)
    assert int(state["step"]) == 0 and torch.all(state["vel"][0]["w"] == 0)
    ok = [{"w": torch.ones(3, 2)}]
    params, state, good = TE._guarded_update(
        opt, params, state, torch.tensor(1.0), ok, inplace)
    assert bool(good) and int(state["step"]) == 1
    torch.testing.assert_close(params[0]["w"].detach(), before - 0.5)
    assert params[0]["w"].requires_grad


def test_skip_policy_records_bad_steps(graphs):
    """on_bad="skip": a step whose loss is NaN is recorded in
    History.bad_steps and training goes on from the kept params."""
    _, tg = graphs
    cfg = GNNConfig(**_kw(tg))

    class NanOnce(TE.FullGraphSource):
        calls = 0

        def loss(self, params, batch):
            NanOnce.calls += 1
            out = super().loss(params, batch)
            return out * float("nan") if NanOnce.calls == 2 else out

    plan = TE.TrainPlan(n_iters=4, eval_every=100,
                        bad_steps=TE.BadStepPolicy(on_bad="skip"))
    res = TE.Trainer(tg, cfg, plan, source=NanOnce(), device="cpu").run()
    assert res.history.bad_steps == [2]
    assert np.isnan(res.history.losses[1])
    assert np.isfinite(res.history.losses[3])
    plan_raise = dataclasses.replace(plan, bad_steps=TE.BadStepPolicy())
    NanOnce.calls = 0
    with pytest.raises(TE.NonFiniteStepError):
        TE.Trainer(tg, cfg, plan_raise, source=NanOnce(),
                   device="cpu").run()


@pytest.mark.parametrize("deferred", [False, True])
def test_deferred_and_sync_reads_give_one_history(graphs, deferred):
    _, tg = graphs
    kw = _kw(tg)
    plan = TE.TrainPlan(lr=0.3, n_iters=5, eval_every=2,
                        deferred_sync=deferred,
                        track_full_loss_every=2)
    a = TE.Trainer(tg, GNNConfig(**kw), plan,
                   source=TE.SampledSource(prefetch=False),
                   params=_init(kw, 0), device="cpu").run()
    b = TE.Trainer(tg, GNNConfig(**kw),
                   dataclasses.replace(plan, deferred_sync=not deferred,
                                       donate=not deferred),
                   source=TE.SampledSource(prefetch=False),
                   params=_init(kw, 0), device="cpu").run()
    assert a.history.losses == b.history.losses
    assert a.history.full_losses == b.history.full_losses
    assert a.history.val_accs == b.history.val_accs


def test_history_roundtrip_and_metrics():
    from repro.core.metrics import History as RefHistory
    from repro_torch.core import metrics as TM
    from repro.core import metrics as RM
    h = History()
    h.start()
    for i, (l, v) in enumerate([(1.5, 0.2), (1.1, None), (0.8, 0.7)]):
        h.record(l, v, nodes=10 + i)
    h.full_losses, h.full_loss_iters = [1.4, 0.9], [1, 3]
    d = h.to_dict()
    assert json.loads(json.dumps(d)) == d
    assert History.from_dict(d).to_dict() == d
    r = RefHistory.from_dict(d)
    for name in ("iteration_to_loss", "iteration_to_full_loss",
                 "iteration_to_accuracy"):
        assert getattr(TM, name)(h, 1.0 if "loss" in name else 0.5) == \
            getattr(RM, name)(r, 1.0 if "loss" in name else 0.5)
    assert TM.time_to_accuracy(h, 0.5) == RM.time_to_accuracy(r, 0.5)
    assert TM.throughput_nodes_per_sec(h) == \
        RM.throughput_nodes_per_sec(r)
    assert TM.simulated_time_to_acc(10, 64.0, 1e3) == \
        RM.simulated_time_to_acc(10, 64.0, 1e3)


def test_full_graph_train_loss_matches_reference(graphs):
    rg, tg = graphs
    kw = _kw(rg)
    p = _init(kw, 2)
    want = RT.full_graph_train_loss(
        rg, [{k: jax.numpy.asarray(v) for k, v in q.items()} for q in p],
        RefConfig(**kw))
    from repro_torch.core.gnn import params_from_numpy
    got = TT.full_graph_train_loss(tg, params_from_numpy(p, device="cpu"),
                                   GNNConfig(**kw))
    assert got == pytest.approx(want, rel=1e-5, abs=1e-5)


def test_save_rows_matches_reference(tmp_path):
    """JSON + CSV side by side, private "_" keys dropped, the union of
    columns in first-seen order — byte-equal to the reference's files."""
    rows = [{"paradigm": "fullgraph", "b": 300, "final_loss": 0.5,
             "_result": object()},
            {"paradigm": "minibatch", "b": 32, "final_loss": 0.7,
             "iter_to_loss": None}]
    got = TX.save_rows("grid", rows, out_dir=str(tmp_path / "t"))
    want = RX.save_rows("grid", rows, out_dir=str(tmp_path / "r"))
    for kind in ("json", "csv"):
        with open(got[kind]) as a, open(want[kind]) as b:
            assert a.read() == b.read()
    assert json.load(open(got["json"]))[1]["iter_to_loss"] is None
