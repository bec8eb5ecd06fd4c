"""End-to-end example: a few hundred training steps of the paper's two
paradigms at the largest CPU-tractable preset, with the full metric
suite — iteration-to-loss/accuracy, time-to-accuracy, throughput — and
the Theorem-3 Wasserstein diagnostic for the chosen (b, beta).  The port
of the reference's ``examples/full_vs_minibatch.py``.

Runs entirely through the unified engine: ``run_experiment`` drives one
``Trainer`` per paradigm; ``--sweep`` additionally runs a small (b, β)
grid through ``repro_torch.core.experiment.sweep`` and writes JSON/CSV
rows::

    PYTHONPATH=src python -m repro_torch.examples.full_vs_minibatch \\
        --preset products-like --iters 300 --b 256 --beta 10 5 --kernel
    PYTHONPATH=src python -m repro_torch.examples.full_vs_minibatch --sweep
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.configs.base import GNNConfig
from repro_torch.core.engine import TrainPlan
from repro_torch.core.experiment import run_experiment, save_rows, sweep
from repro_torch.core.wasserstein import wasserstein_delta
from repro_torch.data.synth import make_preset
from repro_torch.device import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="products-like")
    ap.add_argument("--n", type=int, default=3000)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--b", type=int, default=256)
    ap.add_argument("--beta", type=int, nargs="+", default=[10, 5])
    ap.add_argument("--loss", default="ce", choices=["ce", "mse"])
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--sweep", action="store_true",
                    help="also run a small (b, β) grid and write JSON/CSV")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless told otherwise)")
    ap.add_argument("--kernel", action="store_true",
                    help="aggregate through the CUDA kernels (their plain "
                         "versions on the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    graph = make_preset(args.preset, n=args.n, seed=0)
    cfg = GNNConfig(name="e2e", model="graphsage", n_nodes=graph.n,
                    feat_dim=graph.feats.shape[1], hidden=64,
                    n_classes=graph.n_classes, n_layers=len(args.beta),
                    fanout=tuple(args.beta), batch_size=args.b,
                    loss=args.loss, use_agg_kernel=args.kernel)
    plan = TrainPlan(lr=args.lr, n_iters=args.iters, eval_every=5)

    # report iteration-to-* against the paper's targets without stopping
    # early — the runs go the full --iters like the reference example
    report = dict(report_loss=0.5, report_acc=0.6)
    print(f"== full-graph GD ({args.iters} iters, b=n_train="
          f"{len(graph.train_nodes)}, beta=d_max={graph.d_max})")
    row_full = run_experiment(graph, cfg, plan, paradigm="fullgraph",
                              device=dev, **report)
    print(f"== mini-batch SGD (b={args.b}, beta={tuple(args.beta)})")
    row_mini = run_experiment(graph, cfg, plan, paradigm="minibatch",
                              b=args.b, fanouts=tuple(args.beta),
                              device=dev, **report)

    report = {"full_graph": row_full, "mini_batch": row_mini}
    w = wasserstein_delta(graph, beta=args.beta[0], b=args.b)
    report["thm3_delta(beta,b)"] = round(w["delta"], 6)
    report["delta_full_mini_mean"] = round(w["delta_full_mini_mean"], 6)
    print(json.dumps(report, indent=2))

    if args.sweep:
        grid_bs = sorted({max(args.b // 4, 8), args.b})
        grid_fo = [tuple(max(f // 2, 1) for f in args.beta),
                   tuple(args.beta)]
        # grid runs use the engine's early stop: each point trains until
        # the target loss (the paper's iteration-to-loss protocol)
        plan = TrainPlan(lr=args.lr, n_iters=args.iters, eval_every=5,
                         target_loss=0.5)
        rows = sweep(graph, cfg, plan, batch_sizes=grid_bs,
                     fanout_grid=grid_fo, include_fullgraph=True,
                     verbose=True, device=dev)
        paths = save_rows("full_vs_minibatch_sweep", rows)
        print(json.dumps({"sweep_rows": len(rows), **paths}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
