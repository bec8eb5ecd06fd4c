"""Fig. 6(c,d) / §5.4: training throughput (target nodes/s) across batch
and fan-out sizes — computational-efficiency claims: throughput rises
with b, falls with β; mini-batch beats full-graph per-node (torch copy of
the reference ``benchmarks/bench_fig6_throughput.py``)."""
from __future__ import annotations

from repro_torch.bench.common import (Env, gnn_cfg, print_rows,
                                      run_fullgraph, run_minibatch,
                                      summarize, write_csv)
from repro_torch.data.synth import make_preset

QUICK = {"n": 1600, "iters": 60}
FULL = {"n": 4000, "iters": 150}


def run(quick: bool = True, seed: int = 0, env: Env = None):
    env = env or Env()
    sz = QUICK if quick else FULL
    graph = make_preset("products-like", seed=seed, n=sz["n"])
    iters = sz["iters"]
    rows = []
    cfg = gnn_cfg(env, graph, n_layers=1, loss="ce")
    for b in [32, 128, 512, len(graph.train_nodes)]:
        res, wall = run_minibatch(env, graph, cfg, b, (10,), iters,
                                  seed=seed, eval_every=10 ** 9)
        rows.append({"sweep": "batch", "b": b, "beta": 10,
                     **summarize(res), "wall_s": round(wall, 2)})
    for beta in [2, 5, 10, 20]:
        res, wall = run_minibatch(env, graph, cfg, 128, (beta,), iters,
                                  seed=seed, eval_every=10 ** 9)
        rows.append({"sweep": "fanout", "b": 128, "beta": beta,
                     **summarize(res), "wall_s": round(wall, 2)})
    res, wall = run_fullgraph(env, graph, cfg, iters, seed=seed,
                              eval_every=10 ** 9)
    rows.append({"sweep": "fullgraph", "b": len(graph.train_nodes),
                 "beta": graph.d_max, **summarize(res),
                 "wall_s": round(wall, 2)})
    write_csv(env, "fig6_throughput", rows)
    print_rows("fig6", rows)
    return rows


if __name__ == "__main__":
    run()
