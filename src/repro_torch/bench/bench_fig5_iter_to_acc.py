"""Fig. 5 / §5.1: iteration-to-accuracy vs time-to-accuracy across batch
and fan-out sizes (reddit-like preset) — the paper's hardware-agnostic
metric argument (torch copy of the reference
``benchmarks/bench_fig5_iter_to_acc.py``)."""
from __future__ import annotations

from repro_torch.bench.common import (Env, gnn_cfg, print_rows,
                                      run_minibatch, summarize, write_csv)
from repro_torch.data.synth import make_preset

QUICK = {"n": 1600, "iters": 150}
FULL = {"n": 4000, "iters": 400}


def run(quick: bool = True, seed: int = 0, env: Env = None):
    env = env or Env()
    sz = QUICK if quick else FULL
    graph = make_preset("reddit-like", seed=seed, n=sz["n"],
                        homophily=0.6, feat_scale=0.35, train_frac=0.3)
    iters = sz["iters"]
    target_acc = 0.72
    rows = []
    for loss in ("ce", "mse"):
        cfg = gnn_cfg(env, graph, n_layers=1, loss=loss)
        for b in [32, 128, 512]:
            res, _ = run_minibatch(env, graph, cfg, b, (10,), iters,
                                   seed=seed, eval_every=1)
            rows.append({"loss": loss, "sweep": "batch", "b": b, "beta": 10,
                         **summarize(res, target_acc=target_acc)})
        for beta in [2, 5, 15]:
            res, _ = run_minibatch(env, graph, cfg, 128, (beta,), iters,
                                   seed=seed, eval_every=1)
            rows.append({"loss": loss, "sweep": "fanout", "b": 128,
                         "beta": beta,
                         **summarize(res, target_acc=target_acc)})
    write_csv(env, "fig5_iter_to_acc", rows)
    print_rows("fig5", rows)
    return rows


if __name__ == "__main__":
    run()
