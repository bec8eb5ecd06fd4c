"""Fig. 1 / §5.1: hardware-(in)dependence of the metrics (torch copy of
the reference ``benchmarks/bench_fig1_metric_stability.py``).

This reproduces the paper's own non-rigorous §5.1 derivation: the SAME
iteration-to-accuracy measurements are combined with different
bandwidth/compute models; the time-to-accuracy RANKING of full-graph vs
mini-batch flips across bandwidths while iteration-to-accuracy is
bandwidth-invariant by construction.
"""
from __future__ import annotations

from repro_torch.bench.common import (Env, gnn_cfg, print_rows,
                                      run_fullgraph, run_minibatch,
                                      write_csv)
from repro_torch.core.metrics import (iteration_to_accuracy,
                                      simulated_time_to_acc)
from repro_torch.data.synth import make_preset

QUICK = {"n": 1500, "iters": 150}
FULL = {"n": 3000, "iters": 400}


def run(quick: bool = True, seed: int = 0, env: Env = None):
    env = env or Env()
    sz = QUICK if quick else FULL
    graph = make_preset("arxiv-like", seed=seed, n=sz["n"],
                        homophily=0.55, feat_scale=0.3, train_frac=0.3)
    iters = sz["iters"]
    target = 0.7
    cfg = gnn_cfg(env, graph, n_layers=1, loss="ce")
    rf, _ = run_fullgraph(env, graph, cfg, iters, seed=seed, eval_every=1)
    rm, _ = run_minibatch(env, graph, cfg, 128, (10,), iters, seed=seed,
                          eval_every=1)
    it_full = iteration_to_accuracy(rf.history, target) or iters
    it_mini = iteration_to_accuracy(rm.history, target) or iters
    nodes_full = len(graph.train_nodes) * graph.avg_degree
    nodes_mini = 128 * 10
    rows = []
    for bw_name, bw in [("bw_high(1e6)", 1e6), ("bw_mid(1e4)", 1e4),
                        ("bw_low(1e2)", 1e2)]:
        t_full = simulated_time_to_acc(it_full, nodes_full, bw)
        t_mini = simulated_time_to_acc(it_mini, nodes_mini, bw)
        rows.append({
            "bandwidth": bw_name,
            "iter_to_acc_full": it_full, "iter_to_acc_mini": it_mini,
            "time_to_acc_full_s": round(t_full, 4),
            "time_to_acc_mini_s": round(t_mini, 4),
            "faster_paradigm": "full" if t_full < t_mini else "mini",
        })
    # iteration-to-acc is identical across rows by construction; the
    # winner by time flips -> the paper's point.
    write_csv(env, "fig1_metric_stability", rows)
    print_rows("fig1", rows)
    return rows


if __name__ == "__main__":
    run()
