"""Fig. 2 / Thm 1-2: iteration-to-loss of one-layer GraphSAGE under CE and
MSE across batch sizes and fan-out sizes (products-like regime), torch
copy of the reference ``benchmarks/bench_fig2_convergence.py``.

Methodology matches the paper's "across varying learning rates": the
theory's T(b, β) holds for lr tuned within a (b, β)-dependent stability
range (App. B-E set η ∈ [C β³/(π n b²), b/(6π β n)]), so each sweep point
reports the BEST iteration-to-loss over an lr grid, seed-averaged, with
the loss measured on the FULL training objective (per-batch losses are
noisy and their first crossings bias small batches early).

Validates Remark 3.1:
  * MSE: larger b -> MORE iterations; larger β -> fewer.
  * CE:  larger b -> fewer iterations; larger β -> fewer.
"""
from __future__ import annotations

import numpy as np

from repro_torch.bench.common import Env, gnn_cfg, print_rows, write_csv
from repro_torch.core.metrics import iteration_to_full_loss
from repro_torch.core.trainer import train_minibatch
from repro_torch.data.synth import make_preset

LR_GRID = {
    "ce": (0.02, 0.06, 0.2, 0.6),
    "mse": (0.004, 0.012, 0.04, 0.12),
}

QUICK = {"n": 1600, "iters": 250, "seeds": (0, 1)}
FULL = {"n": 4000, "iters": 600, "seeds": (0, 1, 2, 3)}


def _one(env, graph, cfg, b, fanouts, iters, lr, seed):
    return train_minibatch(graph, cfg, lr=lr, n_iters=iters, batch_size=b,
                           fanouts=fanouts, seed=seed, eval_every=10 ** 9,
                           track_full_loss_every=5,
                           params=env.params(cfg, seed), device=env.device)


def _best_over_lr(env, graph, cfg, b, fanouts, iters, target, seeds):
    best_it, best_lr, best_final = iters * 2, None, float("inf")
    for lr in LR_GRID[cfg.loss]:
        its, finals = [], []
        for s in seeds:
            r = _one(env, graph, cfg, b, fanouts, iters, lr, s)
            fl = r.history.full_losses
            if not np.isfinite(fl[-1]):           # diverged
                its.append(iters * 2)
                finals.append(float("inf"))
                continue
            it = iteration_to_full_loss(r.history, target)
            its.append(it if it is not None else iters * 2)
            finals.append(fl[-1])
        m = float(np.mean(its))
        if m < best_it:
            best_it, best_lr, best_final = m, lr, float(np.mean(finals))
    return best_it, best_lr, best_final


def run(quick: bool = True, seed: int = 0, env: Env = None):
    env = env or Env()
    sz = QUICK if quick else FULL
    graph = make_preset("products-like", seed=seed, n=sz["n"],
                        homophily=0.6, feat_scale=0.45)
    iters = sz["iters"]
    seeds = sz["seeds"]
    rows = []
    batches = [32, 128, 512, len(graph.train_nodes)]
    fanouts = [2, 5, 10, min(20, graph.d_max)]
    for loss in ("ce", "mse"):
        cfg = gnn_cfg(env, graph, n_layers=1, loss=loss)
        # target: what the reference config (b=128, β=10) reaches at 60%
        # budget under ITS best lr
        ref_best = float("inf")
        for lr in LR_GRID[loss]:
            r = _one(env, graph, cfg, 128, (10,), iters, lr, 99)
            fl = [x for x in r.history.full_losses if np.isfinite(x)]
            if fl and fl[int(len(fl) * 0.6)] < ref_best:
                ref_best = fl[int(len(fl) * 0.6)]
        target = ref_best
        for b in batches:
            it, lr, flv = _best_over_lr(env, graph, cfg, b, (10,), iters,
                                        target, seeds)
            rows.append({"sweep": "batch", "loss": loss, "b": b, "beta": 10,
                         "target": round(target, 4),
                         "iter_to_loss": round(it, 1), "best_lr": lr,
                         "final_loss": round(flv, 4)})
        for beta in fanouts:
            it, lr, flv = _best_over_lr(env, graph, cfg, 128, (beta,), iters,
                                        target, seeds)
            rows.append({"sweep": "fanout", "loss": loss, "b": 128,
                         "beta": beta, "target": round(target, 4),
                         "iter_to_loss": round(it, 1), "best_lr": lr,
                         "final_loss": round(flv, 4)})
    write_csv(env, "fig2_convergence", rows)
    print_rows("fig2", rows)
    return rows


if __name__ == "__main__":
    run()
