"""Smoke for crash-safe sweeps, the port of the reference's
``scripts/sweep_resume_smoke.py``.

Simulates the real failure mode end to end: a sweep over two grid
points is killed right after the first point finishes (armed
``sweep.after_point`` failpoint -> ``SimulatedCrash``), then rerun with
the same journal.  The resumed sweep must (a) not rerun the completed
point — its row comes back from the journal — and (b) finish the grid,
leaving exactly one journal line per point::

    PYTHONPATH=src python -m repro_torch.ci.sweep_resume_smoke --device cpu
    PYTHONPATH=src python -m repro_torch.ci.sweep_resume_smoke --kernel

``--kernel`` aggregates through the CUDA kernels (their plain versions
on the CPU).  The journal lives in a temporary directory.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from repro_torch.configs.base import GNNConfig
from repro_torch.core import faults
from repro_torch.core.engine import TrainPlan
from repro_torch.core.experiment import sweep
from repro_torch.data.synth import make_preset
from repro_torch.device import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless told otherwise)")
    ap.add_argument("--kernel", action="store_true",
                    help="aggregate through the CUDA kernels")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    graph = make_preset("arxiv-like", n=200, seed=0)
    cfg = GNNConfig(name="smoke", model="graphsage", n_nodes=graph.n,
                    feat_dim=graph.feats.shape[1], hidden=16,
                    n_classes=graph.n_classes, n_layers=1, fanout=(3,),
                    batch_size=32, loss="ce", use_agg_kernel=args.kernel)
    plan = TrainPlan(lr=0.3, n_iters=3, eval_every=2)
    kw = dict(batch_sizes=[16, 32], fanout_grid=[(3,)], verbose=True,
              device=dev)

    with tempfile.TemporaryDirectory() as d:
        journal = os.path.join(d, "sweep.jsonl")

        # -- run 1: killed right after point 1 is journaled ------------
        crashed = False
        try:
            with faults.armed("sweep.after_point", at_hits=(0,)):
                sweep(graph, cfg, plan, journal=journal, **kw)
        except faults.SimulatedCrash:
            crashed = True
        assert crashed, "failpoint sweep.after_point did not fire"
        with open(journal) as f:
            lines = [json.loads(line) for line in f]
        assert len(lines) == 1 and lines[0]["status"] == "ok", lines
        first_row = lines[0]["row"]

        # -- run 2: same journal — resume must skip point 1 ------------
        rows = sweep(graph, cfg, plan, journal=journal, **kw)
        with open(journal) as f:
            lines = [json.loads(line) for line in f]
        assert len(rows) == 2, rows
        # one journal line per point: point 1 was not rerun
        assert len(lines) == 2, lines
        assert [line["status"] for line in lines] == ["ok", "ok"]
        # the skipped point's row is the journaled one, verbatim
        assert rows[0] == first_row, (rows[0], first_row)

    print("sweep_resume_smoke: OK (point 1 journaled once, "
          "resume skipped it, grid completed)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
