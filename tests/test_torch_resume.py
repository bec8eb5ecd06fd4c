"""The port's fault-tolerance layer, the reference's cases
(tests/test_resume.py, tests/test_chaos.py) on the port's ``Trainer`` on
the CPU:

- exact resume: ``Trainer.run(resume_from=...)`` continues a
  checkpointed run bit-for-bit as the run that was not stopped (History,
  params, test accuracy) for the full-graph, mini-batch, importance and
  cluster sources, with and without the kernels' plain versions, after a
  kill in the middle of a save too;
- the non-finite ``BadStepPolicy`` under ``faults.poison_batches``:
  skip (synchronous and lagged reads), raise, escalation, rollback;
- the sweep's JSONL journal: completed points skipped on rerun, failing
  points recorded as error rows and retried;
- ``launch/train.py --ckpt-every/--resume/--journal``."""
import dataclasses
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import latest_step, save_checkpoint
from repro_torch.configs.base import GNNConfig
from repro_torch.core import engine as E
from repro_torch.core import experiment as X
from repro_torch.core import faults
from repro_torch.data.synth import make_sbm_graph
from repro_torch.launch import train as launch_train

SOURCES = {"fullgraph": E.FullGraphSource, "minibatch": E.SampledSource,
           "importance": E.ImportanceSampledSource,
           "cluster": lambda: E.ClusterSource(batch_size=64)}


@pytest.fixture(scope="module")
def graph():
    return make_sbm_graph(n=300, n_classes=4, avg_degree=10, feat_dim=16,
                          seed=1)


def _cfg(g, **kw):
    base = dict(name="resume", model="graphsage", n_nodes=g.n,
                feat_dim=g.feats.shape[1], hidden=16,
                n_classes=g.n_classes, n_layers=2, fanout=(4, 3),
                batch_size=32, loss="ce")
    base.update(kw)
    return GNNConfig(**base)


@pytest.fixture(autouse=True)
def _no_armed_failpoints():
    yield
    faults.disarm()


def _run(g, cfg, plan, source, **kw):
    return E.Trainer(g, cfg, plan, source=source, device="cpu").run(**kw)


def _params_equal(a, b) -> bool:
    return all(torch.equal(x, y) for p, q in zip(a, b)
               for x, y in zip(p.values(), q.values()))


def _assert_same_run(golden, resumed):
    hg, hr = golden.history, resumed.history
    assert hr.losses == hg.losses
    assert hr.val_accs == hg.val_accs
    assert hr.val_acc_iters == hg.val_acc_iters
    assert hr.full_losses == hg.full_losses
    assert hr.full_loss_iters == hg.full_loss_iters
    assert hr.nodes_processed == hg.nodes_processed
    assert hr.bad_steps == hg.bad_steps
    assert _params_equal(resumed.params, golden.params)
    assert resumed.final_test_acc == golden.final_test_acc


# ---------------------------------------------------------------------------
# exact resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("name", sorted(SOURCES))
def test_resume_equals_uninterrupted(graph, tmp_path, name, kernel):
    g, cfg = graph, _cfg(graph, use_agg_kernel=kernel)
    make = SOURCES[name]
    plan = E.TrainPlan(lr=0.3, n_iters=9, seed=0, eval_every=4,
                       track_full_loss_every=3, ckpt_every=3,
                       ckpt_dir=str(tmp_path / "golden"))
    golden = _run(g, cfg, plan, make())
    # the stopped run: n_iters=4 stands in for a kill at it=4 (its final
    # save lands at it=3)
    d = str(tmp_path / "stopped")
    _run(g, cfg, dataclasses.replace(plan, n_iters=4, ckpt_dir=d), make())
    assert latest_step(d) == 3
    resumed = _run(g, cfg, dataclasses.replace(plan, ckpt_dir=d), make(),
                   resume_from=d)
    _assert_same_run(golden, resumed)


@pytest.mark.parametrize("name", ["minibatch", "cluster"])
def test_kill_mid_checkpoint_then_resume_equals_uninterrupted(
        graph, tmp_path, name):
    g, cfg = graph, _cfg(graph)
    make = SOURCES[name]
    plan = E.TrainPlan(lr=0.3, n_iters=9, seed=0, eval_every=4,
                       ckpt_every=3, ckpt_dir=str(tmp_path / "golden"))
    golden = _run(g, cfg, plan, make())
    crash = str(tmp_path / "crash")
    plan2 = dataclasses.replace(plan, ckpt_dir=crash)
    # a kill in the middle of the it=6 save
    with faults.armed("ckpt.before_npz_rename", at_hits=(1,)):
        with pytest.raises(faults.SimulatedCrash):
            _run(g, cfg, plan2, make())
    assert latest_step(crash) == 3
    _assert_same_run(golden, _run(g, cfg, plan2, make(),
                                  resume_from=crash))


def test_resume_prefetch_off_matches_prefetch_on(graph, tmp_path):
    """The inline path checkpoints and resumes the same stream state as
    the prefetched path."""
    g, cfg = graph, _cfg(graph)
    plan = E.TrainPlan(lr=0.3, n_iters=8, seed=0, eval_every=100,
                       ckpt_every=3, ckpt_dir=str(tmp_path / "g"))
    golden = _run(g, cfg, plan, E.SampledSource(prefetch=False))
    d = str(tmp_path / "i")
    _run(g, cfg, dataclasses.replace(plan, n_iters=4, ckpt_dir=d),
         E.SampledSource(prefetch=False))
    resumed = _run(g, cfg, dataclasses.replace(plan, ckpt_dir=d),
                   E.SampledSource(prefetch=True), resume_from=d)
    assert resumed.history.losses == golden.history.losses
    assert _params_equal(resumed.params, golden.params)


def test_checkpoint_cadence_reads_synchronously(graph, tmp_path):
    """ckpt_every turns the lagged host read off, so the save at
    iteration it holds that step's parameters: they equal a run of it+1
    steps."""
    g, cfg = graph, _cfg(graph)
    plan = E.TrainPlan(lr=0.3, n_iters=6, seed=0, eval_every=100,
                       ckpt_every=2, ckpt_dir=str(tmp_path))
    assert not E._deferred_mode(plan)
    _run(g, cfg, plan, E.SampledSource())
    from repro_torch.checkpoint import restore_checkpoint
    short = _run(g, cfg, E.TrainPlan(lr=0.3, n_iters=5, seed=0,
                                     eval_every=100), E.SampledSource())
    like = {"params": short.params,
            "opt_state": E.TrainPlan().make_optimizer().init(short.params)}
    saved = restore_checkpoint(str(tmp_path), like, step=4)
    assert _params_equal(saved["params"], short.params)


def test_resume_missing_directory_raises(graph, tmp_path):
    with pytest.raises(FileNotFoundError, match="no completed"):
        _run(graph, _cfg(graph), E.TrainPlan(n_iters=4),
             E.FullGraphSource(), resume_from=str(tmp_path / "nope"))


def test_resume_params_only_checkpoint_rejected(graph, tmp_path):
    """Checkpoints without engine state cannot be resumed exactly."""
    g, cfg = graph, _cfg(graph)
    params = _run(g, cfg, E.TrainPlan(n_iters=1), E.FullGraphSource()).params
    save_checkpoint(str(tmp_path), 0, {"params": params, "opt_state": {}},
                    {"loss": 1.0})
    with pytest.raises(ValueError, match="engine_state"):
        _run(g, cfg, E.TrainPlan(n_iters=4), E.FullGraphSource(),
             resume_from=str(tmp_path))


def test_resume_seed_mismatch_warns(graph, tmp_path):
    g, cfg = graph, _cfg(graph)
    d = str(tmp_path)
    plan = E.TrainPlan(lr=0.3, n_iters=4, seed=0, ckpt_every=3, ckpt_dir=d)
    _run(g, cfg, plan, E.SampledSource())
    other = dataclasses.replace(plan, n_iters=6, seed=1)
    with pytest.warns(RuntimeWarning, match="seed"):
        _run(g, cfg, other, E.SampledSource(), resume_from=d)


def test_stream_state_without_rng_is_refused(graph):
    src = E.SampledSource().bind(graph, _cfg(graph), E.TrainPlan(), "cpu")
    with pytest.raises(ValueError, match="no rng state"):
        src.load_state_dict({"consumed": 3, "rng_state": None})
    with pytest.raises(ValueError, match="no stream state"):
        E.FullGraphSource().load_state_dict({"consumed": 3})


# ---------------------------------------------------------------------------
# BadStepPolicy under poisoned batches
# ---------------------------------------------------------------------------

class _ParamTrace(E.Callback):
    """Copies of state.params at each consumed record."""

    def __init__(self):
        self.at = {}

    def on_step(self, state):
        self.at[state.it] = [{k: v.detach().clone() for k, v in p.items()}
                             for p in state.params]


@pytest.mark.parametrize("name", ["minibatch", "importance", "cluster"])
@pytest.mark.parametrize("deferred", [False, True],
                         ids=["sync", "deferred"])
def test_nan_step_skip_policy(graph, deferred, name):
    """A NaN batch at step k: its loss is recorded as nan, the step in
    bad_steps, params unchanged across it, and training goes on."""
    k = 3
    plan = E.TrainPlan(lr=0.3, n_iters=8, seed=0, eval_every=100,
                       deferred_sync=deferred,
                       bad_steps=E.BadStepPolicy(on_bad="skip",
                                                 max_consecutive=4))
    src = faults.poison_batches(SOURCES[name](), at_iters=[k])
    trace = _ParamTrace()
    res = E.Trainer(graph, _cfg(graph), plan, source=src,
                    extra_callbacks=[trace], device="cpu").run()
    assert len(res.history.losses) == 8
    assert np.isnan(res.history.losses[k])
    assert all(np.isfinite(x) for i, x in enumerate(res.history.losses)
               if i != k)
    assert res.history.bad_steps == [k + 1]          # 1-based
    # under the lagged read the trace is one step ahead of its record
    off = 1 if deferred else 0
    assert _params_equal(trace.at[k - off], trace.at[k - 1 - off])
    assert not _params_equal(trace.at[k + 1 - off], trace.at[k - off])


def test_poison_passes_full_graph_batches_through(graph):
    src = faults.poison_batches(E.FullGraphSource(), at_iters=[0, 1])
    res = _run(graph, _cfg(graph), E.TrainPlan(n_iters=3, eval_every=100),
               src)
    assert res.history.bad_steps == []


def test_nan_step_raise_policy_default(graph):
    plan = E.TrainPlan(lr=0.3, n_iters=6, seed=0, eval_every=100,
                       deferred_sync=False)
    src = faults.poison_batches(E.SampledSource(), at_iters=[2])
    with pytest.raises(E.NonFiniteStepError, match="iteration 2"):
        _run(graph, _cfg(graph), plan, src)


def test_nan_streak_escalates_after_max_consecutive(graph):
    plan = E.TrainPlan(lr=0.3, n_iters=10, seed=0, eval_every=100,
                       deferred_sync=False,
                       bad_steps=E.BadStepPolicy(on_bad="skip",
                                                 max_consecutive=2))
    src = faults.poison_batches(E.SampledSource(), at_iters=[3, 4, 5])
    with pytest.raises(E.NonFiniteStepError) as ei:
        _run(graph, _cfg(graph), plan, src)
    assert ei.value.consecutive == 2


@pytest.mark.parametrize("policy", [
    E.BadStepPolicy(on_bad="rollback", max_consecutive=2),
    E.BadStepPolicy(on_bad="skip", max_consecutive=2, escalate="rollback")],
    ids=["rollback", "skip_escalates"])
@pytest.mark.parametrize("name", ["minibatch", "cluster"])
def test_nan_streak_rollback_policy(graph, tmp_path, policy, name):
    """k consecutive NaN steps with checkpointing on: the engine restores
    the newest checkpoint into the live tensors and finishes finite."""
    bad = {4 + i for i in faults.FaultSchedule(7).consecutive(n=6, k=2)}
    plan = E.TrainPlan(lr=0.3, n_iters=12, seed=0, eval_every=100,
                       ckpt_every=3, ckpt_dir=str(tmp_path),
                       bad_steps=policy)
    src = faults.poison_batches(SOURCES[name](), at_iters=sorted(bad))
    trainer = E.Trainer(graph, _cfg(graph), plan, source=src, device="cpu")
    with pytest.warns(RuntimeWarning, match="rolling back"):
        res = trainer.run()
    assert trainer._n_rollbacks == 1
    assert len(res.history.bad_steps) == 2
    assert len(res.history.losses) == 12
    assert all(torch.isfinite(v).all() for p in res.params
               for v in p.values())


def test_rollback_restores_the_checkpointed_values(graph, tmp_path):
    """Right after a rollback the live params and optimizer state equal
    the newest save, in the same tensors."""
    from repro_torch.checkpoint import restore_checkpoint

    class Watched(E.Trainer):
        def _rollback(self, state):
            ids = [id(v) for p in state.params for v in p.values()]
            super()._rollback(state)
            assert ids == [id(v) for p in state.params for v in p.values()]
            self.after = [v.detach().clone() for v in E._tree_leaves(
                {"params": state.params, "opt_state": state.opt_state})]

    plan = E.TrainPlan(lr=0.3, n_iters=8, seed=0, eval_every=100,
                       momentum=0.9, ckpt_every=3, ckpt_dir=str(tmp_path),
                       bad_steps=E.BadStepPolicy(on_bad="rollback",
                                                 max_consecutive=2))
    src = faults.poison_batches(E.SampledSource(), at_iters=[4, 5])
    tr = Watched(graph, _cfg(graph), plan, source=src, device="cpu")
    with pytest.warns(RuntimeWarning, match="checkpoint step 3"):
        tr.run()
    params = E.initial_params(graph, _cfg(graph), plan, None, "cpu")
    like = {"params": params,
            "opt_state": plan.make_optimizer().init(params)}
    saved = E._tree_leaves(restore_checkpoint(str(tmp_path), like, step=3))
    assert len(saved) == len(tr.after) == 9    # 4 weights, 4 vel, step
    assert all(torch.equal(a, b) for a, b in zip(tr.after, saved))


def test_rollback_bounded_by_max_rollbacks(graph, tmp_path):
    plan = E.TrainPlan(lr=0.3, n_iters=12, seed=0, eval_every=100,
                       ckpt_every=2, ckpt_dir=str(tmp_path),
                       bad_steps=E.BadStepPolicy(on_bad="rollback",
                                                 max_consecutive=1,
                                                 max_rollbacks=1))
    src = faults.poison_batches(E.SampledSource(), at_iters=[3, 5])
    with pytest.warns(RuntimeWarning, match="rolling back"):
        with pytest.raises(E.NonFiniteStepError):
            _run(graph, _cfg(graph), plan, src)


def test_rollback_before_any_checkpoint_raises(graph, tmp_path):
    plan = E.TrainPlan(lr=0.3, n_iters=6, seed=0, eval_every=100,
                       ckpt_every=4, ckpt_dir=str(tmp_path),
                       bad_steps=E.BadStepPolicy(on_bad="rollback",
                                                 max_consecutive=1))
    src = faults.poison_batches(E.SampledSource(), at_iters=[1])
    with pytest.raises(E.NonFiniteStepError, match="iteration 1"):
        _run(graph, _cfg(graph), plan, src)


def test_rollback_policy_requires_checkpoints(graph):
    for pol in (E.BadStepPolicy(on_bad="rollback"),
                E.BadStepPolicy(on_bad="skip", escalate="rollback")):
        with pytest.raises(ValueError, match="ckpt_every"):
            E.Trainer(graph, _cfg(graph),
                      E.TrainPlan(n_iters=4, bad_steps=pol),
                      source=E.FullGraphSource(), device="cpu")


def test_bad_step_policy_validation():
    with pytest.raises(ValueError):
        E.BadStepPolicy(on_bad="explode")
    with pytest.raises(ValueError):
        E.BadStepPolicy(escalate="shrug")
    with pytest.raises(ValueError):
        E.BadStepPolicy(max_consecutive=0)
    assert E.BadStepPolicy(on_bad="rollback").needs_ckpt()
    assert not E.BadStepPolicy(on_bad="skip").needs_ckpt()


def test_fault_schedule_deterministic():
    a, b = faults.FaultSchedule(11), faults.FaultSchedule(11)
    assert a.pick(100, 5) == b.pick(100, 5)
    assert a.consecutive(50, 4) == b.consecutive(50, 4)
    run = sorted(faults.FaultSchedule(3).consecutive(50, 4))
    assert run == list(range(run[0], run[0] + 4))


# ---------------------------------------------------------------------------
# crash-safe sweeps
# ---------------------------------------------------------------------------

def _sweep_args(g, sources=("minibatch",)):
    cfg = _cfg(g, n_layers=1, fanout=(3,))
    plan = E.TrainPlan(lr=0.3, n_iters=2, eval_every=100)
    return cfg, plan, dict(batch_sizes=[16, 32], fanout_grid=[(3,)],
                           sources=list(sources), device="cpu")


WALL = ("wall_time_s", "throughput_nodes_s", "time_to_acc_s")


def _no_wall(rows):
    return [{k: v for k, v in r.items() if k not in WALL} for r in rows]


@pytest.mark.parametrize("sources", [("minibatch",),
                                     ("cluster", "importance")])
def test_sweep_journal_resume_skips_completed(graph, tmp_path, sources):
    cfg, plan, kw = _sweep_args(graph, sources)
    journal = str(tmp_path / "sweep.jsonl")
    with faults.armed("sweep.after_point", at_hits=(0,)):
        with pytest.raises(faults.SimulatedCrash):
            X.sweep(graph, cfg, plan, journal=journal, **kw)
    lines = [json.loads(x) for x in open(journal)]
    assert [x["status"] for x in lines] == ["ok"]
    rows = X.sweep(graph, cfg, plan, journal=journal, **kw)
    lines = [json.loads(x) for x in open(journal)]
    straight = X.sweep(graph, cfg, plan, **kw)
    assert len(rows) == len(lines) == len(straight)   # point 1 NOT rerun
    assert rows[0] == lines[0]["row"]        # journaled row returned as-is
    assert _no_wall(rows) == _no_wall(straight)


def test_sweep_isolates_point_failure_into_error_row(graph, tmp_path,
                                                     monkeypatch):
    cfg, plan, kw = _sweep_args(graph)
    journal = str(tmp_path / "sweep.jsonl")
    real = X.run_experiment

    def exploding(graph_, cfg_, plan_, **kwargs):
        if kwargs.get("b") == 16:
            raise RuntimeError("boom at b=16")
        return real(graph_, cfg_, plan_, **kwargs)

    monkeypatch.setattr(X, "run_experiment", exploding)
    rows = X.sweep(graph, cfg, plan, journal=journal, **kw)
    assert rows[0]["status"] == "error" and "boom" in rows[0]["error"]
    assert rows[1].get("status") != "error"
    # error points are RETRIED on resume (only ok rows are skipped)
    monkeypatch.setattr(X, "run_experiment", real)
    rows2 = X.sweep(graph, cfg, plan, journal=journal, **kw)
    assert all(r.get("status") != "error" for r in rows2)


def test_sweep_journal_skips_a_torn_line(graph, tmp_path):
    cfg, plan, kw = _sweep_args(graph)
    journal = tmp_path / "sweep.jsonl"
    X.sweep(graph, cfg, plan, journal=str(journal), **kw)
    first = journal.read_text().splitlines()[0]
    journal.write_text(first + "\n" + '{"key": "minibatch|32')
    rows = X.sweep(graph, cfg, plan, journal=str(journal), **kw)
    assert len(rows) == 2 and rows[0] == json.loads(first)["row"]


def test_sweep_without_journal_fails_fast(graph, monkeypatch):
    cfg, plan, kw = _sweep_args(graph)

    def exploding(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(X, "run_experiment", exploding)
    with pytest.raises(RuntimeError, match="boom"):
        X.sweep(graph, cfg, plan, **kw)


def test_sweep_checkpoints_each_point_in_its_own_directory(graph,
                                                           tmp_path):
    cfg, plan, kw = _sweep_args(graph, ("minibatch", "cluster"))
    plan = dataclasses.replace(plan, ckpt_every=1, ckpt_dir=str(tmp_path))
    X.sweep(graph, cfg, plan, include_fullgraph=True, **kw)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "b16_f3_s0", "b32_f3_s0", "cluster_b16_f3_s0", "cluster_b32_f3_s0",
        "fullgraph_s0"]


# ---------------------------------------------------------------------------
# launch/train.py
# ---------------------------------------------------------------------------

def _launch(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert launch_train.main(argv) == 0
    return json.loads(buf.getvalue()[buf.getvalue().index("{"):])


def test_launch_train_checkpoints_and_resumes(tmp_path):
    """--ckpt-every writes one namespace per paradigm; --resume from a
    run stopped at 4 steps ends where the 6-step run ends."""
    base = ["--arch", "gnn-papers100m", "--smoke", "--device", "cpu",
            "--ckpt-every", "2", "--log-every", "100"]
    full = _launch(base + ["--steps", "6", "--ckpt-dir",
                           str(tmp_path / "full")])
    short = str(tmp_path / "short")
    _launch(base + ["--steps", "4", "--ckpt-dir", short, "--keep-last",
                    "1"])
    assert sorted(p.name for p in (tmp_path / "short").iterdir()) == \
        ["fullgraph", "minibatch"]
    assert latest_step(str(tmp_path / "short" / "minibatch")) == 3
    resumed = _launch(base + ["--steps", "6", "--ckpt-dir", short,
                              "--resume"])
    assert resumed["full_graph"] == full["full_graph"]
    assert resumed["mini_batch"] == full["mini_batch"]


def test_launch_train_sweep_with_journal(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["--arch", "gnn-papers100m", "--smoke", "--device", "cpu",
            "--steps", "2", "--sweep-bs", "16", "--sweep-fanout", "3",
            "--journal", "j.jsonl"]
    out = _launch(argv)
    assert out["sweep_rows"] == 2
    lines = [json.loads(x) for x in open(tmp_path / "j.jsonl")]
    assert [x["status"] for x in lines] == ["ok", "ok"]
    assert _launch(argv)["sweep_rows"] == 2
    assert len(open(tmp_path / "j.jsonl").readlines()) == 2
