"""The port's ``make sweep-smoke``: the reference Makefile's three
``repro.core.experiment.main`` calls on ``repro_torch.core.experiment.main``
(two mini-batch grid points; one point of each scenario source —
cluster, importance, minibatch_sharded; one sharded point through the
kernels), plus its feature-sharded point (the CLI's ``--feats-layout
sharded``, fullgraph_sharded, kernels on) through ``sweep(mesh=)`` on a
four-shard mesh of the run's device::

    PYTHONPATH=src python -m repro_torch.ci.sweep_smoke --device cpu

Rows land under ``experiments/bench_torch/ci_sweep_smoke*``.  Exit 0
when every call returns its rows and no row is an error row.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.configs.base import GNNConfig
from repro_torch.core import experiment
from repro_torch.core.engine import TrainPlan
from repro_torch.data.synth import make_preset
from repro_torch.device import resolve_device
from repro_torch.sharding import node_mesh

COMMON = ["--preset", "arxiv-like", "--n", "300", "--iters", "3",
          "--fanout", "3", "--layers", "1"]

CALLS = (
    ["--bs", "16", "32", "--out", "ci_sweep_smoke"],
    ["--bs", "32", "--sources", "cluster", "importance",
     "minibatch_sharded", "--out", "ci_sweep_smoke_sources"],
    ["--bs", "32", "--kernel", "--sources", "minibatch_sharded",
     "--out", "ci_sweep_smoke_sharded_kernel"],
)
#: rows each call gives: its grid points
ROWS = (2, 3, 1)


def featshard_point(device) -> list:
    """The featshard call, ``COMMON`` + ``--bs 32 --kernel --feats-layout
    sharded --sources fullgraph_sharded``, on four shards of ``device``."""
    dev = resolve_device(device)
    graph = make_preset("arxiv-like", n=300, seed=0)
    cfg = GNNConfig(name="sweep", model="graphsage", n_nodes=graph.n,
                    feat_dim=graph.feats.shape[1], hidden=32,
                    n_classes=graph.n_classes, n_layers=1, fanout=(5,),
                    batch_size=64, loss="ce", use_agg_kernel=True,
                    feats_layout="sharded")
    rows = experiment.sweep(graph, cfg, TrainPlan(lr=0.3, n_iters=3,
                                                  eval_every=2),
                            batch_sizes=[32], fanout_grid=[(3,)],
                            sources=["fullgraph_sharded"], verbose=True,
                            device=dev, mesh=node_mesh(devices=(dev,) * 4))
    paths = experiment.save_rows("ci_sweep_smoke_featshard", rows)
    print(json.dumps({"rows": len(rows), **paths}))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless told otherwise)")
    args = ap.parse_args(argv)
    got = [(call[-1], n, experiment.main(COMMON + call
                                         + ["--device", args.device]))
           for call, n in zip(CALLS, ROWS)]
    got.append(("ci_sweep_smoke_featshard", 1, featshard_point(args.device)))
    for name, n, rows in got:
        bad = [r for r in rows if r.get("status") == "error"]
        if len(rows) != n or bad:
            print(f"sweep_smoke: {name} gave {len(rows)} rows "
                  f"(want {n}), errors {bad}", file=sys.stderr)
            return 1
    print(f"sweep_smoke: OK ({sum(ROWS) + 1} rows in {len(got)} calls)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
