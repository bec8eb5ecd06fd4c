"""Shared helpers of the port's figure benches (torch copy of the
reference ``benchmarks/common.py``): runs through the engine, the metric
row, CSV output.

What the reference fixes per process, a bench here takes from an ``Env``
its caller builds: the device (``cuda`` unless told otherwise), the
kernel switch (the reference CLI's ``--kernel``: every GCN or GraphSAGE
config a figure builds sets ``use_agg_kernel``; off by default, as the
reference's benches run), an optional ``init_params(cfg, seed)`` hook
whose parameters each run starts from (``Trainer(params=)``; without it
the port draws its own), and the output directory, by default
``experiments/bench_torch/`` beside the reference's ``experiments/bench/``.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.configs.base import GNNConfig
from repro_torch.core.engine import (FullGraphSource, SampledSource, Trainer,
                                     TrainPlan, TrainResult)
from repro_torch.core.experiment import metrics_row, save_rows

OUT_DIR = os.environ.get("BENCH_OUT", "experiments/bench_torch")

# tuned learning rates per loss (the paper tunes lr per setting; App. N)
LR = {"ce": 0.3, "mse": 0.05}

#: the models whose aggregation the kernel switch sends to the kernels
KERNEL_MODELS = ("gcn", "graphsage")


@dataclasses.dataclass(frozen=True)
class Env:
    """Where and how a bench runs (see the module docstring)."""
    device: str = "cuda"
    kernel: bool = False
    init_params: Optional[Callable[[GNNConfig, int], Sequence[dict]]] = None
    out_dir: str = OUT_DIR

    def params(self, cfg: GNNConfig, seed: int):
        """The initial parameters of a run of ``cfg`` at ``seed``, or
        None for the port's own draw."""
        return None if self.init_params is None else \
            self.init_params(cfg, seed)


def gnn_cfg(env: Env, graph, model="graphsage", n_layers=1, loss="ce",
            fanout=(10,), batch=256, hidden=64) -> GNNConfig:
    return GNNConfig(name="bench", model=model, n_nodes=graph.n,
                     feat_dim=graph.feats.shape[1], hidden=hidden,
                     n_classes=graph.n_classes, n_layers=n_layers,
                     fanout=tuple(fanout), batch_size=batch, loss=loss,
                     use_agg_kernel=env.kernel and model in KERNEL_MODELS)


def run_minibatch(env: Env, graph, cfg, b, fanouts, iters, seed=0,
                  eval_every=10):
    plan = TrainPlan(lr=LR[cfg.loss], n_iters=iters, eval_every=eval_every,
                     seed=seed)
    t0 = time.perf_counter()
    res = Trainer(graph, cfg, plan,
                  source=SampledSource(batch_size=b, fanouts=fanouts),
                  params=env.params(cfg, seed), device=env.device).run()
    return res, time.perf_counter() - t0


def run_fullgraph(env: Env, graph, cfg, iters, seed=0, eval_every=10):
    plan = TrainPlan(lr=LR[cfg.loss], n_iters=iters, eval_every=eval_every,
                     seed=seed)
    t0 = time.perf_counter()
    res = Trainer(graph, cfg, plan, source=FullGraphSource(),
                  params=env.params(cfg, seed), device=env.device).run()
    return res, time.perf_counter() - t0


def summarize(res: TrainResult, target_loss: Optional[float] = None,
              target_acc: Optional[float] = None) -> Dict:
    """One metric row — the experiment module's shared schema."""
    return metrics_row(res, target_loss, target_acc)


def write_csv(env: Env, name: str, rows: List[Dict]) -> str:
    """CSV (+ JSON sibling) via the experiment module's writer."""
    path = os.path.join(env.out_dir, f"{name}.csv")
    if rows:
        path = save_rows(name, rows, out_dir=env.out_dir)["csv"]
    return path


def print_rows(name: str, rows: Sequence[Dict]):
    for r in rows:
        kv = ",".join(f"{k}={v}" for k, v in r.items())
        print(f"{name},{kv}", flush=True)
