"""The port's entry points outside the library: the four examples
(``repro_torch.examples``) and the CI runner with its smokes
(``repro_torch.ci``), on the CPU.

Each example runs in-process at a tiny size with ``--device cpu`` and
must print the reference example's lines (the same formats) or keys
(the result rows of ``full_vs_minibatch`` have the reference
``run_experiment`` rows' keys; ``lm_pretrain_smoke`` ends with the
reference launcher's JSON keys); without ``--device`` each asks for the
card and raises where there is none.  The CI runner is held to its
contract with planted failures: any failing command of any stage makes
it exit nonzero and stops it there, and a fixture that does not make the
analysis gate fire (or crashes instead) fails the ``analyze`` stage."""
import json
import re
import sys

import numpy as np
import pytest
import torch

from repro_torch.ci import __main__ as ci
from repro_torch.ci import sweep_resume_smoke, sweep_smoke
from repro_torch.examples import (full_vs_minibatch, lm_pretrain_smoke,
                                  quickstart, serve_batched)

NUM = r"-?[0-9.]+"
EXAMPLES = (quickstart, full_vs_minibatch, serve_batched, lm_pretrain_smoke)


def _lines(capsys):
    return capsys.readouterr().out.strip().splitlines()


@pytest.mark.parametrize("kernel", [False, True])
def test_quickstart_prints_the_reference_lines(capsys, kernel):
    assert quickstart.main(["--device", "cpu", "--n", "200", "--iters",
                            "5"] + (["--kernel"] if kernel else [])) == 0
    out = _lines(capsys)
    assert re.fullmatch(r"graph: n=200 avg_deg=[0-9.]+ d_max=\d+ "
                        r"classes=\d+", out[0])
    for line, name in zip(out[1:3], ("full-graph ", "mini-batch ")):
        assert re.fullmatch(
            rf"{name} loss {NUM} -> {NUM}  iter-to-loss\(0\.5\)=(\d+|None)"
            rf"  test acc {NUM}", line), line
    assert out[3] == ""
    assert out[4].startswith("Paper's takeaway: tune (b, beta)")


def test_full_vs_minibatch_rows_have_the_reference_keys(capsys):
    jax = pytest.importorskip("jax")
    from repro.configs.base import GNNConfig as RefConfig
    from repro.core.engine import TrainPlan as RefPlan
    from repro.core.experiment import run_experiment as ref_run
    from repro.data import make_preset as ref_preset

    assert full_vs_minibatch.main(
        ["--device", "cpu", "--n", "200", "--iters", "4", "--b", "32",
         "--beta", "3", "2", "--kernel"]) == 0
    text = capsys.readouterr().out
    head, _, body = text.partition("\n{")
    assert head.splitlines() == [
        "== full-graph GD (4 iters, b=n_train=100, beta=d_max=32)",
        "== mini-batch SGD (b=32, beta=(3, 2))"]
    report = json.loads("{" + body)
    assert set(report) == {"full_graph", "mini_batch", "thm3_delta(beta,b)",
                           "delta_full_mini_mean"}
    g = ref_preset("products-like", n=200, seed=0)
    cfg = RefConfig(name="e2e", model="graphsage", n_nodes=g.n,
                    feat_dim=g.feats.shape[1], hidden=8,
                    n_classes=g.n_classes, n_layers=2, fanout=(3, 2),
                    batch_size=32, loss="ce")
    plan = RefPlan(lr=0.3, n_iters=2, eval_every=5)
    want = {p: ref_run(g, cfg, plan, paradigm=p, b=32 if p != "fullgraph"
                       else None, fanouts=(3, 2) if p != "fullgraph"
                       else None, report_loss=0.5, report_acc=0.6)
            for p in ("fullgraph", "minibatch")}
    assert list(report["full_graph"]) == list(want["fullgraph"])
    assert list(report["mini_batch"]) == list(want["minibatch"])
    assert report["full_graph"]["b"] == want["fullgraph"]["b"] == 100
    assert np.isfinite(report["thm3_delta(beta,b)"])
    del jax


@pytest.mark.parametrize("kernel", [False, True])
def test_serve_batched_prints_the_reference_lines(capsys, kernel):
    assert serve_batched.main(["--device", "cpu", "--gen", "5"]
                              + (["--kernel"] if kernel else [])) == 0
    out = _lines(capsys)
    assert re.fullmatch(r"prefill: [0-9.]+s \(batch=4, prompt=64\)", out[0])
    assert re.fullmatch(r"decode: 5 steps, [0-9.]+ tok/s \(batched\)",
                        out[1])
    sample = json.loads(out[2][len("sample: "):])
    assert out[2].startswith("sample: ") and len(sample) == 5
    assert all(0 <= t < 512 for t in sample)


def test_serve_batched_sampling_is_seeded(capsys):
    """The continuation comes from an explicit, seeded generator: two
    runs print the same tokens (the kernel switch does not move them on
    the CPU, where both run the plain attention)."""
    outs = []
    for kernel in ([], ["--kernel"], []):
        serve_batched.main(["--device", "cpu", "--gen", "6"] + kernel)
        outs.append(_lines(capsys)[2])
    assert outs[0] == outs[1] == outs[2]


def test_lm_pretrain_smoke_prints_the_launchers_keys(capsys):
    assert lm_pretrain_smoke.main(["--device", "cpu", "--steps", "2"]) == 0
    out = _lines(capsys)
    assert re.fullmatch(rf"step +0 loss +{NUM} acc {NUM} tok/s [0-9,]+",
                        out[0])
    result = json.loads(out[-1])
    assert list(result) == ["arch", "first_loss", "final_loss", "steps"]
    assert result["arch"] == "mamba2-130m" and result["steps"] == 2


@pytest.mark.parametrize("example", EXAMPLES, ids=lambda m: m.__name__)
def test_examples_ask_for_the_card(example):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        example.main([])


@pytest.mark.parametrize("kernel", [False, True])
def test_sweep_resume_smoke_on_cpu(capsys, kernel):
    argv = ["--device", "cpu"] + (["--kernel"] if kernel else [])
    assert sweep_resume_smoke.main(argv) == 0
    out = capsys.readouterr().out
    assert "journal: skipping completed point" in out
    assert out.strip().endswith("grid completed)")


def test_sweep_smoke_on_cpu(capsys, monkeypatch):
    """The Makefile's sweep points and the featshard point, whose mesh
    has four shards of the CPU."""
    from repro_torch.core import experiment
    meshes = []
    real = experiment.sweep

    def sweep(*a, **kw):
        meshes.append(kw.get("mesh"))
        return real(*a, **kw)

    monkeypatch.setattr(experiment, "sweep", sweep)
    assert sweep_smoke.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip().endswith("(7 rows in 4 calls)")
    assert meshes[:3] == [None] * 3
    assert [str(d) for d in meshes[3].devices] == ["cpu"] * 4


def _stub(rc):
    return ci.Step([sys.executable, "-c", f"import sys; sys.exit({rc})"])


def _gate_stub(code):
    return ci.Step([sys.executable, "-c", code], gate=True)


@pytest.mark.parametrize("planted", ci.STAGES)
def test_ci_runner_stops_nonzero_at_a_planted_failure(monkeypatch, capsys,
                                                      planted):
    def stages(device):
        return {name: [_stub(0), _stub(7 if name == planted else 0)]
                for name in ci.STAGES}

    monkeypatch.setattr(ci, "stages", stages)
    assert ci.main(["--device", "cpu"]) == 7
    ran = re.findall(r"ci: stage (\S+) rc=(\d+)", capsys.readouterr().out)
    k = ci.STAGES.index(planted)
    assert ran == [(s, "0") for s in ci.STAGES[:k]] + [(planted, "7")]


@pytest.mark.parametrize("code,fires", [
    ("print('-- 2 error(s), 0 warning(s), 0 info'); raise SystemExit(1)",
     True),
    ("print('-- 0 error(s), 0 warning(s), 0 info'); raise SystemExit(0)",
     False),                              # the gate stayed quiet
    ("raise ValueError('crash')", False),  # exit 1, but no finding
])
def test_ci_gate_step_needs_a_finding(monkeypatch, capsys, code, fires):
    monkeypatch.setattr(ci, "stages", lambda device: {
        name: [_gate_stub(code)] if name == "analyze" else [_stub(0)]
        for name in ci.STAGES})
    rc = ci.main(["--device", "cpu", "--only", "analyze,chaos"])
    ran = re.findall(r"ci: stage (\S+) rc=(\d+)", capsys.readouterr().out)
    if fires:
        assert rc == 0 and ran == [("analyze", "0"), ("chaos", "0")]
    else:
        assert rc == 1 and ran == [("analyze", "1")]


def test_ci_stage_commands():
    """The stages run what the reference's ``make check`` runs, on the
    port: every port test file, the analysis and its fixtures, the sweep
    and serve smokes, the chaos suites and the resume smoke; no bench."""
    cpu, card = ci.stages("cpu"), ci.stages("cuda")
    assert tuple(cpu) == ci.STAGES
    tests = cpu["tests"][0].argv
    assert "tests/test_torch_serving_chaos.py" in tests
    assert all(a.startswith("tests/test_torch_") for a in tests[4:])
    fixtures = [s.argv[-1] for s in card["analyze"] if s.gate]
    assert fixtures == ["thread", "f64", "constant", "kernel", "pipeline"]
    assert [s.argv[-1] for s in cpu["analyze"] if s.gate] == [
        "thread", "f64", "kernel", "pipeline"]
    assert len(cpu["serve-smoke"]) == 2
    assert "--kernel" in cpu["serve-smoke"][1].argv
    chaos = " ".join(" ".join(s.argv) for s in cpu["chaos"])
    for part in ("test_torch_chaos.py", "test_torch_serving_chaos.py",
                 "test_torch_resume.py", "test_torch_checkpoint.py",
                 "repro_torch.ci.sweep_resume_smoke"):
        assert part in chaos
    every = " ".join(" ".join(s.argv) for st in card.values() for s in st)
    assert "benchmarks" not in every and "bench." not in every
    assert all("--device cuda" in " ".join(s.argv)
               for name in ("sweep-smoke", "serve-smoke")
               for s in card[name])
