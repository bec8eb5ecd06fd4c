"""Thm 3 / Def. 1: Δ(β, b) Wasserstein curves and per-node
δ_i^{full-mini}(β) — the generalization-analysis quantities (torch-side
copy of the reference ``benchmarks/bench_thm3_wasserstein.py``; numpy on
the host, no device work)."""
from __future__ import annotations

from repro_torch.bench.common import Env, print_rows, write_csv
from repro_torch.core.wasserstein import wasserstein_delta
from repro_torch.data.synth import make_preset

QUICK = {"n": 1200}
FULL = {"n": 3000}


def run(quick: bool = True, seed: int = 0, env: Env = None):
    env = env or Env()
    sz = QUICK if quick else FULL
    graph = make_preset("arxiv-like", seed=seed, n=sz["n"])
    rows = []
    betas = [1, 2, 5, 10, 15, graph.d_max]
    for beta in betas:
        w = wasserstein_delta(graph, beta=beta, b=128)
        rows.append({"sweep": "fanout", "beta": beta, "b": 128,
                     "delta": round(w["delta"], 6),
                     "delta_full_mini_mean":
                     round(w["delta_full_mini_mean"], 6)})
    n_tr = len(graph.train_nodes)
    for b in [32, 128, 512, n_tr]:
        w = wasserstein_delta(graph, beta=5, b=b)
        rows.append({"sweep": "batch", "beta": 5, "b": b,
                     "delta": round(w["delta"], 6),
                     "delta_full_mini_mean":
                     round(w["delta_full_mini_mean"], 6)})
    write_csv(env, "thm3_wasserstein", rows)
    print_rows("thm3", rows)
    return rows


if __name__ == "__main__":
    run()
