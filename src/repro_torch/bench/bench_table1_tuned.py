"""Table 1: best test accuracy of full-graph vs TUNED mini-batch (grid
search over b and β) for multi-layer GraphSAGE on the four presets
(torch copy of the reference ``benchmarks/bench_table1_tuned.py``)."""
from __future__ import annotations

from repro_torch.bench.common import (Env, gnn_cfg, print_rows,
                                      run_fullgraph, run_minibatch,
                                      write_csv)
from repro_torch.data.synth import PRESETS, make_preset

QUICK = {"n": 1200, "iters": 120, "grid_b": [64, 256],
         "grid_beta": [(5, 3), (10, 5)]}
FULL = {"n": 3000, "iters": 400, "grid_b": [64, 128, 256, 512],
        "grid_beta": [(5, 3), (10, 5), (15, 10), (20, 10)]}


def run(quick: bool = True, seed: int = 0, env: Env = None):
    env = env or Env()
    sz = QUICK if quick else FULL
    rows = []
    iters = sz["iters"]
    presets = list(PRESETS)
    for preset in presets:
        graph = make_preset(preset, seed=seed, n=sz["n"],
                            homophily=0.55, feat_scale=0.3,
                            train_frac=0.3)
        cfg = gnn_cfg(env, graph, n_layers=2, loss="ce", fanout=(10, 5))
        rf, _ = run_fullgraph(env, graph, cfg, iters, seed=seed)
        best = {"acc": -1.0}
        for b in sz["grid_b"]:
            for fo in sz["grid_beta"]:
                rm, _ = run_minibatch(env, graph, cfg, b, fo, iters,
                                      seed=seed)
                if rm.final_test_acc > best["acc"]:
                    best = {"acc": rm.final_test_acc, "b": b, "fanout": fo}
        rows.append({
            "preset": preset,
            "full_graph_acc": round(rf.final_test_acc, 4),
            "mini_batch_best_acc": round(best["acc"], 4),
            "best_b": best["b"],
            "best_fanout": str(best["fanout"]),
            "mini_minus_full": round(best["acc"] - rf.final_test_acc, 4),
        })
    write_csv(env, "table1_tuned", rows)
    print_rows("table1", rows)
    return rows


if __name__ == "__main__":
    run()
