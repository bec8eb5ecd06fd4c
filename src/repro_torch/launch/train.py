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
full-graph corner) through ``core.experiment.sweep`` and save its rows;
``--journal`` makes that sweep crash-safe.  ``--ckpt-every`` writes
exact-resume checkpoints under ``--ckpt-dir`` (one namespace per
paradigm, ``--keep-last`` retention) and ``--resume`` continues each
paradigm from its newest one.  The LM family (slice 6) is not ported and
raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from repro_torch.configs.base import LM_ARCHS, get_config
from repro_torch.data.synth import make_preset
from repro_torch.device import resolve_device


def train_gnn(args) -> dict:
    from repro_torch.core.engine import (FullGraphSource, SampledSource,
                                         Trainer, TrainPlan)
    from repro_torch.core.experiment import save_rows, sweep

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    graph = make_preset(args.preset, seed=args.seed)
    cfg_run = dataclasses.replace(cfg, n_classes=graph.n_classes,
                                  feat_dim=graph.feats.shape[1])
    plan = TrainPlan(lr=args.lr, n_iters=args.steps, seed=args.seed,
                     eval_every=args.log_every,
                     ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
                     ckpt_keep_last=args.keep_last)
    if args.sweep_bs or args.sweep_fanout:
        # each --sweep-fanout value is ONE grid point, broadcast to all
        # hops by sweep()
        rows = sweep(graph, cfg_run, plan,
                     batch_sizes=args.sweep_bs or [cfg_run.batch_size],
                     fanout_grid=[int(f) for f in args.sweep_fanout]
                     if args.sweep_fanout else [cfg_run.fanout],
                     include_fullgraph=True, verbose=True,
                     journal=args.journal, device=dev)
        paths = save_rows(f"{args.arch}_sweep", rows)
        result = {"arch": args.arch, "sweep_rows": len(rows), **paths}
        print(json.dumps(result, indent=2))
        return result

    # the two paradigms' Trainers share plan.ckpt_dir: namespace their
    # checkpoints (and any --resume) per paradigm so the manifests do not
    # clobber each other
    def _plan_for(tag):
        if not (plan.ckpt_every or args.resume):
            return plan
        return dataclasses.replace(
            plan, ckpt_dir=os.path.join(plan.ckpt_dir, tag))

    pf, pm = _plan_for("fullgraph"), _plan_for("minibatch")
    rf = Trainer(graph, cfg_run, pf, source=FullGraphSource(),
                 device=dev).run(
        resume_from=pf.ckpt_dir if args.resume else None)
    rm = Trainer(graph, cfg_run, pm, source=SampledSource(),
                 device=dev).run(
        resume_from=pm.ckpt_dir if args.resume else None)
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
                    help="exact-resume checkpoint cadence in steps "
                         "(0 = off)")
    ap.add_argument("--ckpt-dir", default="experiments/ckpt")
    ap.add_argument("--keep-last", type=int, default=0,
                    help="checkpoint retention: keep only the newest K "
                         "steps (0 = keep all)")
    ap.add_argument("--resume", action="store_true",
                    help="resume each paradigm from the newest checkpoint "
                         "under its --ckpt-dir namespace (exact resume: "
                         "continues the stopped run bit-for-bit)")
    ap.add_argument("--journal", default=None,
                    help="sweeps: JSONL completion journal for crash-safe "
                         "resume (see core.experiment.sweep)")
    args = ap.parse_args(argv)
    if args.arch.replace("_", "-") in LM_ARCHS:
        raise NotImplementedError(
            f"--arch {args.arch}: the LM family is not ported yet "
            f"(ROADMAP.md Queue 1, slice 6)")
    train_gnn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
