"""Fig. 3 / Thm 3: test accuracy of one-layer GraphSAGE (MSE) across batch
sizes and fan-out sizes (products-like + reddit-like presets), torch copy
of the reference ``benchmarks/bench_fig3_generalization.py``.

Validates Remark 4.1 (larger b or β -> better generalization, with
possible degradation at the extremes) and Obs.2 (β moves accuracy more
than b)."""
from __future__ import annotations

from repro_torch.bench.common import (Env, gnn_cfg, print_rows,
                                      run_minibatch, summarize, write_csv)
from repro_torch.data.synth import make_preset

QUICK = {"n": 1600, "iters": 150}
FULL = {"n": 4000, "iters": 400}


def run(quick: bool = True, seed: int = 0, env: Env = None):
    env = env or Env()
    sz = QUICK if quick else FULL
    rows = []
    iters = sz["iters"]
    for preset in ("products-like", "reddit-like"):
        graph = make_preset(preset, seed=seed, n=sz["n"],
                            homophily=0.6, feat_scale=0.35, train_frac=0.3)
        for loss in ("mse", "ce"):
            cfg = gnn_cfg(env, graph, n_layers=1, loss=loss)
            for b in [32, 128, 512, len(graph.train_nodes)]:
                res, _ = run_minibatch(env, graph, cfg, b, (10,), iters,
                                       seed=seed)
                rows.append({"preset": preset, "loss": loss,
                             "sweep": "batch", "b": b, "beta": 10,
                             **summarize(res)})
            for beta in [1, 2, 5, 10, min(25, graph.d_max)]:
                res, _ = run_minibatch(env, graph, cfg, 128, (beta,), iters,
                                       seed=seed)
                rows.append({"preset": preset, "loss": loss,
                             "sweep": "fanout", "b": 128, "beta": beta,
                             **summarize(res)})
    write_csv(env, "fig3_generalization", rows)
    print_rows("fig3", rows)
    return rows


if __name__ == "__main__":
    run()
