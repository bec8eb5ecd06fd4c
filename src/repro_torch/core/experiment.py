"""The (b, β) experiment runner on top of the ``Trainer`` (torch copy of
the reference ``repro.core.experiment``): every figure of the paper's §5
is a grid over batch size b and fan-out β, with full-graph GD as the
(b=n, β=d_max) corner.

    plan = TrainPlan(lr=0.3, n_iters=200, eval_every=10)
    row  = run_experiment(graph, cfg, plan, b=256, fanouts=(10, 5))
    rows = sweep(graph, cfg, plan, batch_sizes=[64, 256],
                 fanout_grid=[(5, 3), (10, 5)], include_fullgraph=True)
    save_rows("fig2_sweep", rows)          # JSON + CSV side by side

Deliberately NOT carried over: the reference sweep's degrade path
(``experiment.py:356-383``), which retries a grid point with
``use_agg_kernel=False`` when the kernel fails.  Here a kernel failure
raises out of ``sweep``.  The completion journal (``journal=``) and the
cluster, importance and sharded paradigms belong to later slices and
raise ``NotImplementedError``.
"""
from __future__ import annotations

import csv
import dataclasses
import itertools
import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import GNNConfig
from repro_torch.core.engine import (SLICE3, BatchSource, Callback,
                                     FullGraphSource, SampledSource, Trainer,
                                     TrainPlan, TrainResult)
from repro_torch.core.graph import Graph
from repro_torch.core.metrics import (iteration_to_accuracy,
                                      iteration_to_full_loss,
                                      iteration_to_loss,
                                      throughput_nodes_per_sec,
                                      time_to_accuracy)

OUT_DIR = os.environ.get("BENCH_OUT", "experiments/bench")

#: paradigms of the reference and the slice that ports each
PARADIGMS = {"fullgraph": None, "minibatch": None, "cluster": SLICE3,
             "importance": SLICE3,
             "fullgraph_sharded": "ROADMAP.md Queue 1, slice 4",
             "minibatch_sharded": "ROADMAP.md Queue 1, slice 4"}


def metrics_row(res: TrainResult, target_loss: Optional[float] = None,
                target_acc: Optional[float] = None) -> Dict:
    """Metric columns for one TrainResult — the row schema shared by
    run_experiment and sweep."""
    h = res.history
    row: Dict = {
        "iters": len(h.losses),
        "first_loss": round(h.losses[0], 6),
        "final_loss": round(h.losses[-1], 6),
        "test_acc": round(res.final_test_acc, 6),
        "throughput_nodes_s": round(throughput_nodes_per_sec(h), 1),
        "wall_time_s": round(h.times[-1], 4) if h.times else 0.0,
        "stop_reason": res.stop_reason or "",
    }
    if target_loss is not None:
        row["iter_to_loss"] = iteration_to_loss(h, target_loss)
        if h.full_losses:
            row["iter_to_full_loss"] = iteration_to_full_loss(
                h, target_loss)
    if target_acc is not None:
        row["iter_to_acc"] = iteration_to_accuracy(h, target_acc)
        row["time_to_acc_s"] = time_to_accuracy(h, target_acc)
    return row


def inference_metrics(graph: Graph, cfg: GNNConfig, params, *,
                      serve_queries: int = 64, seed: int = 0,
                      chunk_size: Optional[int] = None) -> Dict:
    """The sweep's serving-cost columns for one trained model: the
    layer-wise embedding build (``inference_ms_per_node``),
    ``serve_queries`` 8-node queries through ``GNNServer`` (p50/p99/qps)
    and the cached logits' test accuracy (``serve_acc``).  Runs on the
    parameters' device."""
    from repro_torch.core.embedding_store import EmbeddingStore
    from repro_torch.core.serving import GNNServer

    dev = params[0][next(iter(params[0]))].device
    params = [{k: v.detach() for k, v in p.items()} for p in params]
    store = EmbeddingStore(params, cfg, graph,
                           chunk_size=chunk_size or min(graph.n, 512),
                           device=dev)
    run = store.build()
    test = graph.test_nodes
    pool = test if len(test) else np.arange(graph.n)
    rng = np.random.default_rng(seed)
    server = GNNServer(store, max_batch=32, max_wait_ms=1.0)
    try:
        futs = [server.submit(rng.choice(pool, size=8))
                for _ in range(serve_queries)]
        for f in futs:
            f.result(timeout=60.0)
    finally:
        server.close()
    st = server.stats()
    acc = (float((store.predict(test) == graph.labels[test]).mean())
           if len(test) else 0.0)
    return {
        "inference_ms_per_node": round(run.stats["ms_per_node"], 5),
        "serve_p50_ms": round(st["p50_ms"], 4),
        "serve_p99_ms": round(st["p99_ms"], 4),
        "serve_qps": round(st["qps"], 1),
        "serve_acc": round(acc, 6),
        "serve_snapshot_version": int(st["snapshot_version"]),
        "serve_staleness_max_s": round(st["staleness_max_s"], 4),
        "serve_shed": int(st["n_shed"]),
        "serve_forced_refresh": int(st["n_forced_refresh"]),
    }


def make_source(paradigm: str, b: Optional[int] = None,
                fanouts: Optional[Sequence[int]] = None) -> BatchSource:
    """The paradigm-name -> BatchSource mapping."""
    if paradigm == "fullgraph":
        return FullGraphSource()
    if paradigm == "minibatch":
        return SampledSource(batch_size=b, fanouts=fanouts)
    if paradigm in PARADIGMS:
        raise NotImplementedError(
            f"paradigm {paradigm!r} is not ported yet ({PARADIGMS[paradigm]})")
    raise ValueError(
        f"paradigm must be one of {tuple(PARADIGMS)}, got {paradigm!r}")


def run_experiment(graph: Graph, cfg: GNNConfig, plan: TrainPlan,
                   paradigm: str = "minibatch",
                   b: Optional[int] = None,
                   fanouts: Optional[Sequence[int]] = None,
                   source: Optional[BatchSource] = None,
                   callbacks: Sequence[Callback] = (),
                   report_loss: Optional[float] = None,
                   report_acc: Optional[float] = None,
                   keep_result: bool = False,
                   inference: bool = False,
                   serve_queries: int = 64,
                   params=None, device="cuda") -> Dict:
    """One grid point -> one structured row (spec + metrics).

    ``paradigm`` is "minibatch" or "fullgraph"; a custom ``source``
    overrides it.  ``report_loss`` / ``report_acc`` add iteration-to-*
    metrics without stopping the run.  ``keep_result`` keeps the
    TrainResult under "_result"; ``inference`` appends the serving-cost
    columns.  ``params`` carries initial parameters across."""
    if b is not None or fanouts is not None:
        cfg = dataclasses.replace(
            cfg,
            batch_size=cfg.batch_size if b is None else b,
            fanout=cfg.fanout if fanouts is None else tuple(fanouts))
    cfg.validate()
    if source is None:
        source = make_source(paradigm, b=b, fanouts=fanouts)
    trainer = Trainer(graph, cfg, plan, source=source,
                      extra_callbacks=callbacks, params=params,
                      device=device)
    try:
        res = trainer.run()
    finally:
        trainer.close()
    name = getattr(source, "name", "custom")
    if name == "fullgraph":
        spec = {"paradigm": name, "b": len(graph.train_nodes),
                "fanouts": f"d_max={graph.d_max}"}
    else:
        spec = {"paradigm": name,
                "b": getattr(source, "b", b or cfg.batch_size),
                "fanouts": "x".join(map(str, getattr(source, "fanouts",
                                                     None) or fanouts
                                        or cfg.fanout))}
    row = {**spec, "seed": plan.seed, **metrics_row(
        res,
        plan.target_loss if report_loss is None else report_loss,
        plan.target_acc if report_acc is None else report_acc)}
    if inference:
        row.update(inference_metrics(graph, cfg, res.params,
                                     serve_queries=serve_queries,
                                     seed=plan.seed))
    if keep_result:
        row["_result"] = res
    return row


def sweep(graph: Graph, cfg: GNNConfig, plan: TrainPlan,
          batch_sizes: Sequence[int] = (),
          fanout_grid: Sequence[Sequence[int]] = (),
          include_fullgraph: bool = False,
          sources: Sequence[str] = ("minibatch",),
          seeds: Sequence[int] = (0,),
          verbose: bool = False,
          journal: Optional[str] = None,
          inference: bool = False,
          serve_queries: int = 64,
          init_params: Optional[Callable[[int], Sequence[dict]]] = None,
          device="cuda") -> List[Dict]:
    """Run the (b, β, sampler) product grid (the paper's §5 plane).

    ``fanout_grid`` entries are per-hop fan-out tuples (an int entry is
    broadcast to all ``cfg.n_layers`` hops); full-graph collapses to one
    point.  ``init_params(seed)`` gives each point's carried-across
    initial parameters.  A failing point raises out of the sweep — a
    kernel failure included: there is no retry without the kernel.
    ``journal`` (crash-safe resume) is slice 3 and raises."""
    if journal is not None:
        raise NotImplementedError(
            f"sweep(journal=...): the completion journal is not ported "
            f"yet ({SLICE3})")
    points: List[Tuple[str, Optional[int], Optional[Tuple[int, ...]]]] = []
    seen = set()
    if include_fullgraph:
        points.append(("fullgraph", None, None))
        seen.add("fullgraph")
    for b, beta, src in itertools.product(batch_sizes, fanout_grid,
                                          sources):
        fo = (tuple(beta) if isinstance(beta, (tuple, list))
              else (int(beta),) * cfg.n_layers)
        if src.startswith("fullgraph"):
            if src in seen:
                continue
            seen.add(src)
            points.append((src, None, None))
            continue
        points.append((src, int(b), fo))
    rows: List[Dict] = []
    for paradigm, b, fo in points:
        for seed in seeds:
            row = run_experiment(
                graph, cfg, dataclasses.replace(plan, seed=seed),
                paradigm=paradigm, b=b, fanouts=fo, inference=inference,
                serve_queries=serve_queries,
                params=init_params(seed) if init_params else None,
                device=device)
            rows.append(row)
            if verbose:
                print(",".join(f"{k}={v}" for k, v in row.items()
                               if not k.startswith("_")), flush=True)
    return rows


def save_rows(name: str, rows: List[Dict], out_dir: str = OUT_DIR
              ) -> Dict[str, str]:
    """Structured outputs: <name>.json (row list) + <name>.csv."""
    os.makedirs(out_dir, exist_ok=True)
    rows = [{k: v for k, v in r.items() if not k.startswith("_")}
            for r in rows]
    jpath = os.path.join(out_dir, f"{name}.json")
    with open(jpath, "w") as f:
        json.dump(rows, f, indent=1)
    cpath = os.path.join(out_dir, f"{name}.csv")
    keys: List[str] = []
    for r in rows:
        for k in r:
            if k not in keys:
                keys.append(k)
    with open(cpath, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys, restval="")
        w.writeheader()
        w.writerows(rows)
    return {"json": jpath, "csv": cpath}
