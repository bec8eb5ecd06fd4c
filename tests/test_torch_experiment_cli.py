"""The port's experiment CLI (``repro_torch.core.experiment.main``)
against the reference's ``repro.core.experiment.main`` on the same tiny
argv: the same grid points, the same row schema and the same JSON line,
the port on ``--device cpu`` with and without ``--kernel`` (the kernel
path's plain versions on CPU tensors).  Initial parameters differ (the
CLI draws its own in each package), so no loss is compared here:
``tests/test_torch_train.py`` holds ``sweep``'s numbers to the
reference's.  Also: ``--sources cluster importance`` gives the
reference's grid points, ``--journal`` skips completed points on a rerun,
the sharded sources and the feature-sharded layout give the reference's
grid points (the port's mesh is the one CPU device under ``--device
cpu``, as the reference's is one CPU device here), and without
``--device`` the CLI asks for the card."""
import io
import json
import math
from contextlib import redirect_stdout

import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core import experiment as RX  # noqa: E402

from repro_torch.core import experiment as TX  # noqa: E402

ARGV = ["--preset", "arxiv-like", "--n", "200", "--iters", "3",
        "--bs", "16", "32", "--fanout", "3", "--fullgraph"]
POINT = ("paradigm", "b", "fanouts", "seed")


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rows = main(argv)
    return rows, json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def ref_rows(tmp_path_factory):
    """The reference's rows for ARGV and the 2-layer variant (its plain
    path), run once."""
    import os
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("ref"))
    try:
        return {layers: _run(RX.main, ARGV + ["--layers", str(layers)])
                for layers in (1, 2)}
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("kernel", [False, True])
def test_cli_rows_match_reference_points_and_schema(ref_rows, tmp_path,
                                                    monkeypatch, kernel,
                                                    layers):
    want, want_line = ref_rows[layers]
    monkeypatch.chdir(tmp_path)
    argv = ARGV + ["--layers", str(layers), "--device", "cpu"] + \
        (["--kernel"] if kernel else [])
    got, line = _run(TX.main, argv)
    assert [tuple(r[k] for k in POINT) for r in got] == \
        [tuple(r[k] for k in POINT) for r in want]
    assert [list(r) for r in got] == [list(r) for r in want]
    for r in got:
        assert math.isfinite(r["first_loss"])
        assert math.isfinite(r["final_loss"])
        assert r["iters"] == 3
    assert line.keys() == want_line.keys() and line["rows"] == len(want)
    assert (tmp_path / line["json"]).is_file()
    assert (tmp_path / line["csv"]).is_file()
    assert json.loads((tmp_path / line["json"]).read_text())[0].keys() == \
        got[0].keys()


@pytest.mark.parametrize("kernel", [False, True])
def test_cli_cluster_and_importance_sources_match_reference_points(
        tmp_path, monkeypatch, kernel):
    extra = ["--sources", "cluster", "importance"]
    monkeypatch.chdir(tmp_path)
    want, want_line = _run(RX.main, ARGV + extra)
    got, line = _run(TX.main, ARGV + extra + ["--device", "cpu"] +
                     (["--kernel"] if kernel else []))
    assert [tuple(r[k] for k in POINT) for r in got] == \
        [tuple(r[k] for k in POINT) for r in want]
    assert [list(r) for r in got] == [list(r) for r in want]
    assert {r["paradigm"] for r in got} == {"fullgraph", "cluster",
                                            "importance"}
    assert all(math.isfinite(r["final_loss"]) for r in got)
    assert line.keys() == want_line.keys()


def test_cli_journal_skips_completed_points(tmp_path, monkeypatch):
    from repro_torch.core import faults
    monkeypatch.chdir(tmp_path)
    argv = ARGV + ["--device", "cpu", "--journal", "sweep.jsonl"]
    with faults.armed("sweep.after_point", at_hits=(1,)):
        with pytest.raises(faults.SimulatedCrash):
            TX.main(argv)
    assert len((tmp_path / "sweep.jsonl").read_text().splitlines()) == 2
    rows, line = _run(TX.main, argv)
    lines = [json.loads(x) for x in
             (tmp_path / "sweep.jsonl").read_text().splitlines()]
    assert line["rows"] == len(rows) == len(lines) == 3
    assert [x["status"] for x in lines] == ["ok"] * 3
    assert rows[:2] == [x["row"] for x in lines[:2]]


@pytest.mark.parametrize("extra,paradigms", [
    (["--sources", "minibatch", "minibatch_sharded"],
     {"fullgraph", "minibatch", "minibatch_sharded"}),
    (["--sources", "fullgraph_sharded"], {"fullgraph", "fullgraph_sharded"}),
    (["--feats-layout", "sharded", "--kernel", "--sources",
      "minibatch_sharded", "fullgraph_sharded"],
     {"fullgraph", "minibatch_sharded", "fullgraph_sharded"}),
])
def test_cli_refuses_what_is_not_ported(tmp_path, monkeypatch, extra,
                                        paradigms):
    """The paths this test once found refused (the sharded sources and
    the feature-sharded layout) run: the reference's grid points, row
    schema and JSON line."""
    monkeypatch.chdir(tmp_path)
    want, want_line = _run(RX.main, ARGV + extra)
    got, line = _run(TX.main, ARGV + ["--device", "cpu"] + extra)
    assert [tuple(r[k] for k in POINT) for r in got] == \
        [tuple(r[k] for k in POINT) for r in want]
    assert [list(r) for r in got] == [list(r) for r in want]
    assert {r["paradigm"] for r in got} == paradigms
    assert all(math.isfinite(r["final_loss"]) for r in got)
    assert line.keys() == want_line.keys()
    assert not (tmp_path / "sweep.jsonl").exists()


def test_cli_defaults_to_the_card(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        TX.main(ARGV)
