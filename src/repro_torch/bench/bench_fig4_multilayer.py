"""Fig. 4: multi-layer (2-layer) GraphSAGE iteration-to-loss across batch
and fan-out sizes, CE and MSE — confirms the one-layer theory trends
survive depth (torch copy of the reference
``benchmarks/bench_fig4_multilayer.py``)."""
from __future__ import annotations

from repro_torch.bench.common import (Env, gnn_cfg, print_rows,
                                      run_fullgraph, run_minibatch,
                                      summarize, write_csv)
from repro_torch.data.synth import make_preset

QUICK = {"n": 1500, "iters": 150}
FULL = {"n": 3000, "iters": 400}


def run(quick: bool = True, seed: int = 0, env: Env = None):
    env = env or Env()
    sz = QUICK if quick else FULL
    graph = make_preset("arxiv-like", seed=seed, n=sz["n"])
    iters = sz["iters"]
    rows = []
    target = {"ce": 0.6, "mse": 0.45}
    for loss in ("ce", "mse"):
        cfg = gnn_cfg(env, graph, n_layers=2, loss=loss, fanout=(10, 5))
        for b in [32, 128, len(graph.train_nodes)]:
            res, _ = run_minibatch(env, graph, cfg, b, (10, 5), iters,
                                   seed=seed)
            rows.append({"loss": loss, "sweep": "batch", "b": b,
                         "beta": "10/5",
                         **summarize(res, target_loss=target[loss])})
        for beta in [2, 5, 10]:
            res, _ = run_minibatch(env, graph, cfg, 128, (beta, beta), iters,
                                   seed=seed)
            rows.append({"loss": loss, "sweep": "fanout", "b": 128,
                         "beta": beta,
                         **summarize(res, target_loss=target[loss])})
        # full-graph = the (b=n_train, beta=d_max) corner
        res, _ = run_fullgraph(env, graph, cfg, iters, seed=seed)
        rows.append({"loss": loss, "sweep": "fullgraph",
                     "b": len(graph.train_nodes), "beta": graph.d_max,
                     **summarize(res, target_loss=target[loss])})
    write_csv(env, "fig4_multilayer", rows)
    print_rows("fig4", rows)
    return rows


if __name__ == "__main__":
    run()
