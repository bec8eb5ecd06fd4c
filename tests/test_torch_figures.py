"""The port's figure benches (``repro_torch.bench``) against the
reference's (``benchmarks/``), at a tiny ``make_preset`` size patched in
both packages: the port's module-level ``QUICK`` tables, the reference's
``make_preset`` in its bench module's namespace.  Each port run starts
from the reference Trainer's own initial parameters, handed over
through the ``Env.init_params`` hook.

* fig1, fig6, thm3 and theory_slopes row by row against the reference
  module: discrete columns equal, losses within 1e-4 (f32; the two
  frameworks sum in other orders), ``test_acc`` within one node's share
  of the test split, wall-clock columns by schema only.
* fig2 through its ``_best_over_lr`` helper against the reference's.
* fig3, fig4, fig5 and table1 end to end on the CPU at the patched size
  (and fewer iterations) against the reference's row schema and count:
  the reference module runs with its training calls stubbed, so it
  builds its rows without training.
* ``bench.run``: the nine benches, the CLI's refusal to run without a
  card, and its exit code when a bench fails.
"""
import dataclasses
import math
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
try:
    from benchmarks import (bench_fig1_metric_stability as R1,  # noqa: E402
                            bench_fig2_convergence as R2,
                            bench_fig3_generalization as R3,
                            bench_fig4_multilayer as R4,
                            bench_fig5_iter_to_acc as R5,
                            bench_fig6_throughput as R6,
                            bench_table1_tuned as RTAB,
                            bench_theory_slopes as RSL,
                            bench_thm3_wasserstein as RTH)
    import benchmarks.common as RC  # noqa: E402
finally:
    sys.path.remove(REPO)

from repro.configs.base import GNNConfig as RefConfig  # noqa: E402
from repro.core import gnn as RG  # noqa: E402
from repro.core.engine import TrainResult as RefResult  # noqa: E402
from repro.core.metrics import History as RefHistory  # noqa: E402
from repro.data import make_preset as ref_make_preset  # noqa: E402

from repro_torch.bench import (bench_fig1_metric_stability as T1,  # noqa: E402
                               bench_fig2_convergence as T2,
                               bench_fig3_generalization as T3,
                               bench_fig4_multilayer as T4,
                               bench_fig5_iter_to_acc as T5,
                               bench_fig6_throughput as T6,
                               bench_table1_tuned as TTAB,
                               bench_theory_slopes as TSL,
                               bench_thm3_wasserstein as TTH)
from repro_torch.bench import run as TRUN  # noqa: E402
from repro_torch.bench.common import Env  # noqa: E402
from repro_torch.data.synth import make_preset  # noqa: E402

LOSS_TOL = 1e-4
TINY_N = 200
#: iterations of the schema-only runs (fig3, fig4, fig5, table1)
TINY_ITERS = 6
#: wall-clock columns: compared by schema only
WALL = ("throughput_nodes_s", "wall_time_s", "wall_s")
LOSSES = ("first_loss", "final_loss")


def _ref_init(cfg, seed):
    """The reference Trainer's initial parameters for ``cfg`` at
    ``seed``, as numpy."""
    params = RG.init_gnn(jax.random.key(seed),
                         RefConfig(**dataclasses.asdict(cfg)), cfg.feat_dim)
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


@pytest.fixture
def env(tmp_path):
    return Env(device="cpu", init_params=_ref_init, out_dir=str(tmp_path))


def _tiny(monkeypatch, tmp_path, tmod, rmod, n=TINY_N, **quick):
    """Patch both packages' bench module to ``n`` nodes (and the port's
    other QUICK entries to ``quick``); the reference writes under
    ``tmp_path``."""
    monkeypatch.setitem(tmod.QUICK, "n", n)
    for k, v in quick.items():
        monkeypatch.setitem(tmod.QUICK, k, v)
    monkeypatch.setattr(RC, "OUT_DIR", str(tmp_path / "ref"))
    if rmod is not None and hasattr(rmod, "make_preset"):
        monkeypatch.setattr(
            rmod, "make_preset",
            lambda name, **kw: ref_make_preset(name, **dict(kw, n=n)))


def _share(graph):
    return 1.0 / len(graph.test_nodes) + 1e-6


def _assert_rows(got, want, share):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            if k in WALL:
                continue
            if k in LOSSES:
                assert g[k] == pytest.approx(w[k], rel=LOSS_TOL,
                                             abs=LOSS_TOL), k
            elif k == "test_acc":
                assert abs(g[k] - w[k]) <= share, k
            else:
                assert g[k] == w[k], (k, g, w)


def test_fig6_rows_match_reference(monkeypatch, tmp_path, env):
    _tiny(monkeypatch, tmp_path, T6, R6)
    want = R6.run(quick=True)
    got = T6.run(quick=True, env=env)
    _assert_rows(got, want, _share(make_preset("products-like", n=TINY_N)))
    assert [r["sweep"] for r in got][-1] == "fullgraph"
    assert os.path.isfile(os.path.join(env.out_dir, "fig6_throughput.csv"))


def test_fig1_rows_match_reference(monkeypatch, tmp_path, env):
    _tiny(monkeypatch, tmp_path, T1, R1)
    want = R1.run(quick=True)
    got = T1.run(quick=True, env=env)
    _assert_rows(got, want, 0.0)
    assert len(got) == 3


def test_thm3_rows_equal_reference(monkeypatch, tmp_path, env):
    _tiny(monkeypatch, tmp_path, TTH, RTH)
    assert TTH.run(quick=True, env=env) == RTH.run(quick=True)


def test_theory_slopes_rows_equal_reference(monkeypatch, tmp_path,
                                            env):
    monkeypatch.setattr(RC, "OUT_DIR", str(tmp_path / "ref"))
    assert TSL.run(quick=True, env=env) == RSL.run(quick=True)


@pytest.mark.parametrize("loss,b,fanouts,target", [
    ("ce", 32, (10,), 0.6),
    ("mse", 128, (3,), 0.45),
])
def test_fig2_best_over_lr_matches_reference(env, loss, b, fanouts, target):
    """The lr grid's best iteration-to-full-loss at one point, 40
    iterations over two seeds: the same best lr and seed-averaged
    iteration count, the final full loss within 1e-4."""
    rg = ref_make_preset("products-like", seed=0, n=TINY_N, homophily=0.6,
                         feat_scale=0.45)
    tg = make_preset("products-like", seed=0, n=TINY_N, homophily=0.6,
                     feat_scale=0.45)
    kw = dict(n_layers=1, loss=loss)
    want = R2._best_over_lr(rg, RC.gnn_cfg(rg, **kw), b, fanouts, 40,
                            target, (0, 1))
    got = T2._best_over_lr(env, tg, T2.gnn_cfg(env, tg, **kw), b, fanouts,
                           40, target, (0, 1))
    assert got[:2] == want[:2]
    assert got[1] is not None
    assert got[2] == pytest.approx(want[2], rel=LOSS_TOL, abs=LOSS_TOL)


def _stub(full):
    """A stand-in for the reference's ``run_minibatch`` / ``run_fullgraph``:
    a TrainResult with a two-step History, what the reference's row code
    reads, without training (a full-graph History tracks its loss as the
    full loss, as the engine's does)."""
    def run(*a, **kw):
        h = RefHistory(losses=[1.0, 0.5], val_accs=[0.5], val_acc_iters=[1],
                       times=[0.1, 0.2], nodes_processed=[8, 8])
        if full:
            h.full_losses, h.full_loss_iters = [1.0, 0.5], [1, 2]
        return RefResult(params=None, history=h, final_test_acc=0.5), 0.2
    return run


def _ref_schema(monkeypatch, rmod):
    """The reference module's rows with its training calls stubbed."""
    for name, full in (("run_minibatch", False), ("run_fullgraph", True)):
        if hasattr(rmod, name):
            monkeypatch.setattr(rmod, name, _stub(full))
    return rmod.run(quick=True)


@pytest.mark.parametrize("tmod,rmod", [(T3, R3), (T4, R4), (T5, R5),
                                       (TTAB, RTAB)],
                         ids=["fig3", "fig4", "fig5", "table1"])
def test_figure_runs_end_to_end_with_reference_schema(monkeypatch, tmp_path,
                                                      env, tmod, rmod):
    _tiny(monkeypatch, tmp_path, tmod, rmod, iters=TINY_ITERS)
    want = _ref_schema(monkeypatch, rmod)
    got = tmod.run(quick=True, env=env)
    assert len(got) == len(want)
    assert [list(r) for r in got] == [list(r) for r in want]
    for r in got:
        for k in LOSSES:
            if k in r:
                assert math.isfinite(r[k]), (k, r)
        if "iters" in r:
            assert r["iters"] == TINY_ITERS
    for r in got:
        for k in ("full_graph_acc", "mini_batch_best_acc", "test_acc"):
            if k in r:
                assert 0.0 <= r[k] <= 1.0


def test_kernel_switch_sets_the_config_for_gcn_and_graphsage_only():
    g = make_preset("arxiv-like", n=TINY_N)
    on, off = Env(device="cpu", kernel=True), Env(device="cpu")
    assert T6.gnn_cfg(on, g).use_agg_kernel
    assert T6.gnn_cfg(on, g, model="gcn").use_agg_kernel
    assert not T6.gnn_cfg(on, g, model="gat").use_agg_kernel
    assert not T6.gnn_cfg(off, g).use_agg_kernel


def test_fig6_kernel_switch_on_the_cpu_matches_plain(monkeypatch, tmp_path):
    """With the switch on, the CPU runs the kernels' plain versions: the
    rows equal the plain path's to 1e-4."""
    _tiny(monkeypatch, tmp_path, T6, None, iters=10)
    plain = T6.run(quick=True, env=Env(device="cpu", init_params=_ref_init,
                                       out_dir=str(tmp_path)))
    kern = T6.run(quick=True, env=Env(device="cpu", kernel=True,
                                      init_params=_ref_init,
                                      out_dir=str(tmp_path)))
    _assert_rows(kern, plain, 0.0)


def test_run_lists_the_nine_figure_benches():
    assert [n for n, _ in TRUN.BENCHES] == [
        "fig1_metric_stability", "fig2_convergence", "fig3_generalization",
        "fig4_multilayer", "fig5_iter_to_acc", "fig6_throughput",
        "table1_tuned", "thm3_wasserstein", "theory_slopes"]
    assert TRUN.selected(["fig2", "table"]) == ["fig2_convergence",
                                                "table1_tuned"]


def test_run_cli_defaults_to_the_card_and_exits_1_on_failure(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit) as e:
        TRUN.main(["--only", "fig6"])
    assert e.value.code == 1
    assert "error" in capsys.readouterr().out


def test_run_cli_runs_a_host_only_bench_on_the_cpu(monkeypatch, tmp_path,
                                                   capsys):
    monkeypatch.chdir(tmp_path)
    TRUN.main(["--only", "theory_slopes", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "theory_slopes" in out and "'ok', 30" in out
    assert (tmp_path / "experiments/bench_torch/theory_slopes.csv").is_file()
