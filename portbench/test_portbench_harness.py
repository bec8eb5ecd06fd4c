"""CPU tests of the port's benchmark: the generator, the cell files and
their discovery, the arithmetic, and what the harness imports.

    PYTHONPATH=src python -m pytest -q portbench/
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from portbench import harness as H
from portbench import roofline as R
from portbench import trace as T
from portbench.traffic.generator import make_graph, split_counts

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SPLIT = {"train": 10, "val": 3, "test": 87, "total": 100}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(ROOT, "src"), ROOT])
    return env


# --- the generator ----------------------------------------------------------

def test_generator_degree_homophily_and_split():
    n, c, lam, h = 6000, 8, 20.0, 0.7
    g = make_graph({"avg_degree": lam, "homophily": h, "split": SPLIT}, n,
                   16, c, seed=2 ** 31 + 11, device="cpu")
    deg = np.diff(g.indptr)
    # each node draws max(budget // 2, 1) targets, then edges are symmetrised
    pois = np.random.default_rng(0).poisson(lam, 1_000_000)
    expect = 2 * np.maximum(np.maximum(pois, 1) // 2, 1).mean()
    assert abs(deg.mean() - expect) / expect < 0.03
    rows = np.repeat(np.arange(n), deg)
    same = (g.labels[rows] == g.labels[g.indices]).mean()
    assert abs(same - (h + (1 - h) / c)) < 0.03
    n_tr, n_va = split_counts(n, SPLIT)
    assert (g.train_mask.sum(), g.val_mask.sum()) == (n_tr, n_va) == (600,
                                                                      180)
    assert not (g.train_mask & g.val_mask).any()
    assert (g.train_mask | g.val_mask | g.test_mask).all()
    # a CSR of an undirected graph without self-edges, columns ascending
    assert (rows != g.indices).all()
    pairs = set(zip(rows.tolist(), g.indices.tolist()))
    assert all((b, a) in pairs for a, b in list(pairs)[:5000])
    assert all((np.diff(g.indices[g.indptr[u]:g.indptr[u + 1]]) > 0).all()
               for u in range(0, n, 97))
    assert g.feats.dtype == np.float32 and g.feats.shape == (n, 16)


def test_generator_is_a_function_of_the_seed_with_sizes_fixed():
    """A seed gives the same graph every time; another seed gives the
    same sizes (degree multiset, labels' counts, split) in another
    order, so the same work."""
    spec = {"avg_degree": 8.0, "homophily": 0.5, "split": SPLIT}
    a = make_graph(spec, 500, 4, 3, seed=7, device="cpu")
    b = make_graph(spec, 500, 4, 3, seed=7, device="cpu")
    c = make_graph(spec, 500, 4, 3, seed=2 ** 31 + 8, device="cpu")
    assert np.array_equal(a.indices, b.indices)
    assert np.array_equal(a.feats, b.feats)
    assert not np.array_equal(a.labels, c.labels)
    assert not np.array_equal(a.indptr, c.indptr)
    assert np.array_equal(np.sort(np.diff(a.indptr)),
                          np.sort(np.diff(c.indptr)))
    assert np.array_equal(np.bincount(a.labels), np.bincount(c.labels))
    assert a.train_mask.sum() == c.train_mask.sum()


# --- the cell files -----------------------------------------------------------

def test_benchmark_cells_are_the_workload_files():
    bench = _bench()
    names = sorted(os.path.basename(p)[:-5] for p in
                   os.listdir(os.path.join(HERE, "workloads")))
    assert sorted(w["name"] for w in bench["workloads"]) == [
        n for n in names]
    configs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        cell = H.load_cell(w["name"])
        assert cell.workload["config"] == w["config"] in configs
        assert cell.workload["traffic"] == w["traffic"]
        assert cell.workload["chips"] == w["chips"] == 1
        assert cell.workload["why"] == w["why"]
        assert set(cell.workload["limits"]) == {
            "loss_gap", "loss0_gap", "grad_gap", "change_gap",
            "change1_median_gap"}
        conf = configs[w["config"]]
        assert conf["file"] == f"portbench/configs/{w['config']}.json"
        assert cell.config["source"] == conf["source"]
        assert sorted(cell.config["reduced"]) == sorted(conf["reduced"])


def test_every_metric_has_a_reader_found_by_name():
    bench = _bench()
    readers = H.metric_readers()
    assert sorted(readers) == sorted(m["name"] for m in bench["per_layer"])
    for m in bench["per_layer"]:
        assert readers[m["name"]].UNIT == m["unit"]
        assert set(m["workloads"]) <= {w["name"] for w in bench["workloads"]}


def test_papers_config_is_the_ports_own():
    from repro_torch.configs.gnn_papers100m import full_config
    ref = full_config()
    cfg = H.load_json("configs", "gnn-papers100m")
    for key in ("model", "feat_dim", "hidden", "n_classes", "n_layers",
                "max_degree", "dtype", "use_agg_kernel", "batch_size"):
        assert cfg[key] == getattr(ref, key), key
    assert tuple(cfg["fanout"]) == ref.fanout
    assert cfg["reduced"] == ["n_nodes"] and ref.n_nodes == 16_777_216
    assert cfg["n_nodes"] == ref.n_nodes // 2


def test_a_new_cell_config_and_metric_are_found_as_new_files(tmp_path):
    """A copy of the benchmark with one more configuration, cell and
    per-layer metric added as files runs the new cell (on the CPU, at a
    tiny size) and reports the new metric."""
    root = tmp_path / "portbench"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns(
        "__pycache__", "_cache", "test_*"))
    conf = H.load_json("configs", "gcn-ogbn-products")
    conf.update(name="tiny-gcn", n_nodes=900, hidden=32, feat_dim=16,
                n_classes=5)
    (root / "configs" / "tiny-gcn.json").write_text(json.dumps(conf))
    (root / "workloads" / "tiny-gcn.fullgraph.json").write_text(json.dumps({
        "config": "tiny-gcn", "traffic": "fullgraph", "chips": 1,
        "why": "a test", "limits": {"loss_gap": 1e-4}}))
    (root / "metrics" / "test.steps.py").write_text(
        'UNIT = "steps"\n\ndef read(record):\n    return record["steps"]\n')
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(tmp_path)!r}]\n"
        "from portbench.harness import load_cell, run_cell, metric_readers\n"
        "assert 'test.steps' in metric_readers()\n"
        "out = run_cell(load_cell('tiny-gcn.fullgraph'), 5, 0.3, True,"
        " device='cpu')\n"
        "print(json.dumps({'m': out['metrics'], 'c': out['correct']}))\n")
    res = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["c"] is True
    assert out["m"]["test.steps"] == {"value": 10, "unit": "steps"}


# --- the arithmetic ---------------------------------------------------------

def test_frozen_costs_equal_the_ports_model_today():
    from repro_torch.kernels import cost
    assert (R.F32_FLOPS_PER_S, R.HBM_BYTES_PER_S) == (
        cost.F32_FLOPS_PER_S, cost.HBM_BYTES_PER_S)
    for args in [(1000, 1000, 32, 128, 2, 2, False, 990),
                 (500, 500, 90, 47, 4, 4, True, 500)]:
        # the port's model counts the ELL's b * k slots as edges
        n, b, k = args[:3]
        assert R.agg_cost(n, b, b * k, *args[3:6], fused=args[6],
                          rows=args[7]) == \
            cost.agg_cost(*args[:6], fused=args[6], rows=args[7])
    assert R.csr_cost(1000, 1000, 27000, 172, 2) == \
        cost.csr_cost(1000, 1000, 27000, 172, 2)


def test_roofline_by_hand():
    # one tiled forward: n = b = 1000, 27,000 kept edges (an ELL of
    # K = 32 pads them to 32,000 slots), D = 128 bf16, 990 rows
    nbytes = 990 * 128 * 2 + 27000 * 4 + 27000 * 2 + 1000 * 128 * 2
    assert R.agg_cost(1000, 1000, 27000, 128, 2, rows=990) == (
        nbytes, 2 * 27000 * 128)
    ms, by, b = R.bound(1000, 1000, 27000, 128, 2, 990, False)
    assert by == "bytes" and b == nbytes and ms == nbytes / 3.35e12 * 1e3
    ms, by, _ = R.bound_bwd_csr(1000, 1000, 27000, 172, 2)
    assert ms == pytest.approx((1000 * 172 * 2 * 2 + 27000 * 6 + 1001 * 4)
                               / 3.35e12 * 1e3)
    # an f32 product [n, a] @ [a, b]: FLOP-bound at these widths
    assert R.product_cost(10, 3, 4) == (4 * (30 + 40 + 12), 240)


def test_step_flops_by_hand():
    n, kept = 1000, 27_000
    sage = R.step_flops("graphsage", [(128, 256), (256, 172)], n, kept)
    # forward 2·2·128·256 + 2·2·256·172, backward dW of both layers and
    # dh of the second through both weights: 307,200 + 483,328 a node
    assert sage["dense"] == (307_200 + 483_328) * n
    # layer 0 aggregates 128 columns forward only; layer 1 (narrowing,
    # transform first) aggregates 172 columns forward and backward
    assert sage["agg"] == 2 * kept * (128 + 172 + 172)
    gcn = R.step_flops("gcn", [(100, 256), (256, 256), (256, 47)], n, kept)
    dense = 2 * n * (100 * 256 * 2 + 256 * 256 * 3 + 256 * 47 * 3)
    assert gcn["dense"] == dense == 567_808 * n
    edges = kept + n        # the fused self term is a multiply-add a row
    assert gcn["agg"] == 2 * edges * (100 + 2 * 256 + 2 * 47)
    ev = R.step_flops("gcn", [(100, 256), (256, 256), (256, 47)], n, kept,
                      train=False)
    assert ev["dense"] == 2 * n * (100 * 256 + 256 * 256 + 256 * 47)
    assert ev["agg"] == 2 * edges * (100 + 256 + 47)


def _record(**kw):
    rec = {"model": "graphsage", "dims": [(128, 256), (256, 172)],
           "n": 1000, "kept": 27_000, "rows": 1000, "el": 2,
           "steps": 10, "evals": 1, "window_s": 0.01,
           "device_events": [], "host_events": [],
           "launches": {"tiled": 22, "backward_csr": 10, "backward": 0},
           "setup": {"bind_s": 1.5, "warm_s": 2.5}}
    rec.update(kw)
    return rec


def test_readers_by_hand():
    rd = H.metric_readers()
    # kernels of 1 ms each: two GEMMs, a forward, a backward, overlapping
    # copies; 4 ms busy in a 10 ms window
    dev = [("sm90_xmma_gemm_f32", 0.0, 1000.0),
           ("ampere_sgemm_128x64", 1000.0, 2000.0),
           ("void neighbor_agg_slab_kernel<bf16>", 2000.0, 3000.0),
           ("neighbor_agg_bwd_csr_kernel", 3000.0, 4000.0),
           ("Memcpy DtoD", 3500.0, 3900.0)]
    rec = _record(device_events=dev)
    assert rd["step.device_ms"].read(rec) == pytest.approx(0.4)
    assert rd["device.idle_share"].read(rec) == pytest.approx(60.0)
    assert rd["ops.launches_per_step"].read(rec) == pytest.approx(3.2)
    assert rd["setup.bind_s"].read(rec) == 1.5
    dims = rec["dims"]
    least = 10 * R.gemm_bound_ms("graphsage", dims, 1000) + \
        R.gemm_bound_ms("graphsage", dims, 1000, train=False)
    assert rd["gemm_roofline"].read(rec) == pytest.approx(100 * least / 2.0)
    fwd = R.agg_calls("graphsage", dims, 1000, 27_000, 1000, 2)["fwd"]
    assert rd["agg_fwd_roofline"].read(rec) == pytest.approx(
        100 * 11 * sum(fwd) / 1.0)
    bwd = R.agg_calls("graphsage", dims, 1000, 27_000, 1000, 2)
    assert rd["agg_bwd_roofline"].read(rec) == pytest.approx(
        100 * 10 * sum(bwd["bwd_csr"]) / 1.0)
    flops = 10 * R.step_flops("graphsage", dims, 1000, 27_000)["total"] + \
        R.step_flops("graphsage", dims, 1000, 27_000, train=False)["total"]
    # over the 4 ms the device was busy, not the 10 ms window
    assert rd["step_mfu"].read(rec) == pytest.approx(
        100 * flops / (0.004 * 67e12))
    # a count that disagrees with the calls, or nothing traced: no number
    assert rd["agg_fwd_roofline"].read(_record(
        device_events=dev, launches={"tiled": 21, "backward_csr": 10})) \
        is None
    assert rd["gemm_roofline"].read(_record()) is None
    assert rd["step.device_ms"].read(_record()) is None


def test_trace_intervals():
    evs = [("a", 0.0, 2.0), ("b", 1.0, 3.0), ("c", 5.0, 6.0),
           ("a", 10.0, 11.0)]
    assert T.union(evs) == [(0.0, 3.0), (5.0, 6.0), (10.0, 11.0)]
    assert T.busy_s(evs) == pytest.approx(5e-6)
    assert T.by_name(evs)[0] == ["a", pytest.approx(3e-6)]
    gaps = T.idle_gaps(evs, [("cpu_op x", 6.0, 10.0), ("outer", 0.0, 20.0)])
    assert gaps == [["cpu_op x", pytest.approx(4e-6)],
                    ["outer", pytest.approx(2e-6)]]


# --- what runs --------------------------------------------------------------

def test_the_harness_loads_no_jax_and_the_reference_not_the_port():
    code = (
        "import json, sys\n"
        "from portbench.reference import gnn\n"
        "from portbench.traffic import generator\n"
        "from portbench import roofline, trace\n"
        "ref_only = sorted({m.split('.')[0] for m in sys.modules})\n"
        "from portbench import harness, controls\n"
        "from portbench.run import loaded_forbidden\n"
        "cell = harness.load_cell('gnn-papers100m.fullgraph')\n"
        "cell.config['n_nodes'] = 600\n"
        "harness.metric_readers()\n"
        "out = harness.run_cell(cell, 3, 0.2, False, device='cpu')\n"
        "print(json.dumps({'ref': ref_only, 'bad': loaded_forbidden(),"
        " 'all': sorted({m.split('.')[0] for m in sys.modules})}))\n")
    res = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert not {"jax", "jaxlib", "flax", "repro"} & set(out["all"])
    assert "repro_torch" in out["all"]
    assert not {"repro_torch", "repro", "jax"} & set(out["ref"])


def test_run_refuses_without_a_card_and_without_the_program(tmp_path):
    cmd = [sys.executable, "portbench/run.py", "--workload",
           "gnn-papers100m.fullgraph", "--seed", str(2 ** 31 + 5),
           "--seconds", "1", "--trace", "0"]
    # the card hidden, so that a host with one refuses too
    res = subprocess.run(cmd, cwd=ROOT,
                         env={**_env(), "CUDA_VISIBLE_DEVICES": ""},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and res.stdout == ""
    # a directory with only BENCHMARK.json and the benchmark's files
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0 and res.stdout == ""
    assert "repro_torch" in res.stderr
