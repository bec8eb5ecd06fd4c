"""Quickstart: train a GraphSAGE model with the paper's two paradigms on a
synthetic ogbn-arxiv-like graph and compare them — both run through the
same engine (``repro_torch.core.engine.Trainer``); only the BatchSource
differs.  The port of the reference's ``examples/quickstart.py``::

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --kernel
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

``--n`` and ``--iters`` (defaults: the reference's 1500 nodes and 100
iterations) size the run.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.configs.base import GNNConfig
from repro_torch.core.engine import (FullGraphSource, SampledSource, Trainer,
                                     TrainPlan)
from repro_torch.core.metrics import iteration_to_loss
from repro_torch.data.synth import make_preset
from repro_torch.device import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1500)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless told otherwise)")
    ap.add_argument("--kernel", action="store_true",
                    help="aggregate through the CUDA kernels (their plain "
                         "versions on the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    graph = make_preset("arxiv-like", n=args.n, seed=0)
    print(f"graph: n={graph.n} avg_deg={graph.avg_degree:.1f} "
          f"d_max={graph.d_max} classes={graph.n_classes}")

    cfg = GNNConfig(name="quickstart", model="graphsage",
                    n_nodes=graph.n, feat_dim=graph.feats.shape[1],
                    hidden=64, n_classes=graph.n_classes, n_layers=2,
                    fanout=(10, 5), batch_size=256, loss="ce",
                    use_agg_kernel=args.kernel)
    plan = TrainPlan(lr=0.3, n_iters=args.iters)

    # full-graph GD is the (b=n_train, beta=d_max) limit of mini-batch:
    # same Trainer, different BatchSource.
    full = Trainer(graph, cfg, plan, source=FullGraphSource(),
                   device=dev).run()
    mini = Trainer(graph, cfg, plan, source=SampledSource(),
                   device=dev).run()

    for name, res in [("full-graph", full), ("mini-batch", mini)]:
        itl = iteration_to_loss(res.history, 0.5)
        print(f"{name:11s} loss {res.history.losses[0]:.3f} -> "
              f"{res.history.losses[-1]:.3f}  "
              f"iter-to-loss(0.5)={itl}  test acc {res.final_test_acc:.3f}")
    print("\nPaper's takeaway: tune (b, beta) before assuming full-graph "
          "wins — see repro_torch.core.experiment.sweep and "
          "repro_torch.bench for the full grids.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
