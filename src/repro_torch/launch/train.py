"""Training entry point of the port, GNN family: runs the paper's two
paradigms (full-graph GD and (b, β) mini-batch SGD) through one
``Trainer`` on a synthetic preset and prints the final loss and test
accuracy of each as JSON (the port of the reference
``repro.launch.train.train_gnn``).

    # on the card (default --device cuda)
    PYTHONPATH=src python -m repro_torch.launch.train --arch gnn-papers100m
    # on the CPU, reduced config
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch gnn-papers100m --smoke --device cpu --steps 20

``--sweep-bs`` / ``--sweep-fanout`` run a (b, β) grid (plus the
full-graph corner) through ``core.experiment.sweep`` and save its rows.
The LM family (slice 6) and ``--ckpt-every`` / ``--resume`` /
``--journal`` (slice 3) are not ported and raise.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from repro_torch.configs.base import LM_ARCHS, get_config
from repro_torch.data.synth import make_preset
from repro_torch.device import resolve_device


def train_gnn(args) -> dict:
    from repro_torch.core.engine import (SLICE3, FullGraphSource,
                                         SampledSource, Trainer, TrainPlan)
    from repro_torch.core.experiment import save_rows, sweep

    for flag, on in (("--ckpt-every", args.ckpt_every),
                     ("--resume", args.resume),
                     ("--journal", args.journal)):
        if on:
            raise NotImplementedError(
                f"{flag}: checkpoints, resume and the sweep journal are "
                f"not ported yet ({SLICE3})")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    graph = make_preset(args.preset, seed=args.seed)
    cfg_run = dataclasses.replace(cfg, n_classes=graph.n_classes,
                                  feat_dim=graph.feats.shape[1])
    plan = TrainPlan(lr=args.lr, n_iters=args.steps, seed=args.seed,
                     eval_every=args.log_every)
    if args.sweep_bs or args.sweep_fanout:
        # each --sweep-fanout value is ONE grid point, broadcast to all
        # hops by sweep()
        rows = sweep(graph, cfg_run, plan,
                     batch_sizes=args.sweep_bs or [cfg_run.batch_size],
                     fanout_grid=[int(f) for f in args.sweep_fanout]
                     if args.sweep_fanout else [cfg_run.fanout],
                     include_fullgraph=True, verbose=True, device=dev)
        paths = save_rows(f"{args.arch}_sweep", rows)
        result = {"arch": args.arch, "sweep_rows": len(rows), **paths}
        print(json.dumps(result, indent=2))
        return result
    rf = Trainer(graph, cfg_run, plan, source=FullGraphSource(),
                 device=dev).run()
    rm = Trainer(graph, cfg_run, plan, source=SampledSource(),
                 device=dev).run()
    result = {
        "arch": args.arch, "preset": args.preset, "device": str(dev),
        "full_graph": {"final_loss": rf.history.losses[-1],
                       "test_acc": rf.final_test_acc},
        "mini_batch": {"final_loss": rm.history.losses[-1],
                       "test_acc": rm.final_test_acc},
    }
    print(json.dumps(result, indent=2))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--preset", default="arxiv-like")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless told otherwise)")
    ap.add_argument("--sweep-bs", type=int, nargs="*", default=None,
                    help="batch sizes for a (b, β) sweep")
    ap.add_argument("--sweep-fanout", type=int, nargs="*", default=None,
                    help="fan-out grid values; each value is one grid "
                         "point, broadcast to every hop")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="not ported yet (slice 3): raises when > 0")
    ap.add_argument("--resume", action="store_true",
                    help="not ported yet (slice 3): raises")
    ap.add_argument("--journal", default=None,
                    help="not ported yet (slice 3): raises")
    args = ap.parse_args(argv)
    if args.arch.replace("_", "-") in LM_ARCHS:
        raise NotImplementedError(
            f"--arch {args.arch}: the LM family is not ported yet "
            f"(ROADMAP.md Queue 1, slice 6)")
    train_gnn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
