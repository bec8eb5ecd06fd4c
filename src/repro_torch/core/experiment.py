"""The (b, β) experiment runner on top of the ``Trainer`` (torch copy of
the reference ``repro.core.experiment``): every figure of the paper's §5
is a grid over batch size b and fan-out β, with full-graph GD as the
(b=n, β=d_max) corner.

    plan = TrainPlan(lr=0.3, n_iters=200, eval_every=10)
    row  = run_experiment(graph, cfg, plan, b=256, fanouts=(10, 5))
    rows = sweep(graph, cfg, plan, batch_sizes=[64, 256],
                 fanout_grid=[(5, 3), (10, 5)], include_fullgraph=True)
    save_rows("fig2_sweep", rows)          # JSON + CSV side by side

CLI, the reference's flags and JSON line plus ``--device`` (``cuda``
unless told otherwise); ``--kernel`` runs the aggregation through the
CUDA kernels:

    PYTHONPATH=src python -m repro_torch.core.experiment \
        --preset arxiv-like --n 400 --iters 4 --bs 32 64 --fanout 3 \
        --device cpu

The sharded paradigms (``--sources fullgraph_sharded minibatch_sharded``,
``--feats-layout sharded``) run on ``node_mesh()``: every visible card
under ``--device cuda``, the one device otherwise; a ``mesh=`` argument
of ``sweep`` / ``make_source`` picks another (``node_mesh(devices=
("cuda:0",) * 4)`` is four shards on one card).

Under ``torchrun`` (``python -m torch.distributed.run --nproc-per-node S
-m repro_torch.core.experiment ...``) the sharded paradigms bind to the
process-group mesh of the S ranks (``launch.procs``): each rank holds
its own rows, on its own card under ``--device cuda`` (nccl), on one
shared card under ``--device cuda:0`` (the host-staged transport) or on
the CPU (gloo).  Only rank 0 prints and writes rows and the journal.

``sweep(journal=)`` / ``--journal`` make a sweep crash-safe: every
finished point is appended to a JSONL journal, and a rerun with the same
journal skips the points recorded ``ok``.

Deliberately NOT carried over: the reference sweep's degrade path
(``experiment.py:356-383``), which retries a grid point with
``use_agg_kernel=False`` when the kernel fails.  Here a kernel failure
raises out of ``sweep`` (without a journal) or becomes the point's error
row (with one).
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import itertools
import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import GNNConfig
from repro_torch.core import faults
from repro_torch.core.engine import (BatchSource, Callback, ClusterSource,
                                     FullGraphSource,
                                     ImportanceSampledSource, SampledSource,
                                     ShardedFullGraphSource,
                                     ShardedSampledSource, Trainer,
                                     TrainPlan, TrainResult)
from repro_torch.core.graph import Graph
from repro_torch.core.metrics import (iteration_to_accuracy,
                                      iteration_to_full_loss,
                                      iteration_to_loss,
                                      throughput_nodes_per_sec,
                                      time_to_accuracy)

#: beside the reference's ``experiments/bench``, never over it
OUT_DIR = os.environ.get("BENCH_OUT", "experiments/bench_torch")

#: every paradigm name `make_source` dispatches on — the sampler axis of
#: the (b, β, sampler) cube `sweep(sources=...)` runs
PARADIGMS = ("fullgraph", "fullgraph_sharded", "minibatch",
             "minibatch_sharded", "cluster", "importance")


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
                fanouts: Optional[Sequence[int]] = None,
                mesh=None) -> BatchSource:
    """The paradigm-name -> BatchSource mapping.  ``mesh`` (a
    ``sharding.NodeMesh``) is the sharded paradigms' NODES mesh; None
    gives ``node_mesh()`` on a CUDA run, the run's device alone
    otherwise."""
    if paradigm == "fullgraph":
        return FullGraphSource()
    if paradigm == "fullgraph_sharded":
        return ShardedFullGraphSource(mesh=mesh)
    if paradigm == "minibatch":
        return SampledSource(batch_size=b, fanouts=fanouts)
    if paradigm == "minibatch_sharded":
        return ShardedSampledSource(batch_size=b, fanouts=fanouts, mesh=mesh)
    if paradigm == "cluster":
        return ClusterSource(batch_size=b)
    if paradigm == "importance":
        return ImportanceSampledSource(batch_size=b, fanouts=fanouts)
    raise ValueError(
        f"paradigm must be one of {PARADIGMS}, got {paradigm!r}")


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
                   params=None, device="cuda", mesh=None) -> Dict:
    """One grid point -> one structured row (spec + metrics).

    ``paradigm`` is one of ``PARADIGMS``; a custom ``source`` overrides
    it.  ``report_loss`` / ``report_acc`` add iteration-to-* metrics
    without stopping the run.  ``keep_result`` keeps the TrainResult
    under "_result"; ``inference`` appends the serving-cost columns.
    ``params`` carries initial parameters across; ``mesh`` is the
    sharded paradigms' NODES mesh."""
    if b is not None or fanouts is not None:
        cfg = dataclasses.replace(
            cfg,
            batch_size=cfg.batch_size if b is None else b,
            fanout=cfg.fanout if fanouts is None else tuple(fanouts))
    cfg.validate()
    if source is None:
        source = make_source(paradigm, b=b, fanouts=fanouts, mesh=mesh)
    trainer = Trainer(graph, cfg, plan, source=source,
                      extra_callbacks=callbacks, params=params,
                      device=device)
    try:
        res = trainer.run()
    finally:
        trainer.close()
    name = getattr(source, "name", "custom")
    if name.startswith("fullgraph"):
        spec = {"paradigm": name, "b": len(graph.train_nodes),
                "fanouts": f"d_max={graph.d_max}"}
    elif name == "cluster":
        # fan-out does not apply: the batch structure is k-of-P clusters
        spec = {"paradigm": name, "b": getattr(source, "b", b),
                "fanouts": f"clusters(k={getattr(source, 'k', '?')}"
                           f"/P={getattr(source, 'n_parts_', '?')})"}
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


# ---------------------------------------------------------------------------
# (b, β) sweep — crash-safe via a JSONL completion journal
# ---------------------------------------------------------------------------

def _point_key(paradigm: str, b: Optional[int],
               fo: Optional[Tuple[int, ...]], seed: int) -> str:
    """Stable journal identity of one grid point (the reference's)."""
    fos = "x".join(map(str, fo)) if fo else "-"
    return f"{paradigm}|{b if b is not None else '-'}|{fos}|{seed}"


def _load_journal(path: Optional[str]) -> Dict[str, Dict]:
    """Completed rows keyed by point, from a previous (crashed) sweep.
    Only ``status == "ok"`` records count as done — error rows are
    RETRIED on resume.  A torn final line (crash mid-append) is skipped,
    not fatal: its point simply reruns."""
    done: Dict[str, Dict] = {}
    if not path or not os.path.exists(path):
        return done
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec.get("status") == "ok" and "key" in rec:
                done[rec["key"]] = rec.get("row", {})
    return done


def _append_journal(path: str, rec: Dict) -> None:
    """Durable append: one JSON line, flushed + fsynced before the sweep
    moves on, so a kill after this point cannot lose the record.  Rank 0
    alone writes (its points' rows are every rank's)."""
    from repro_torch.launch.procs import rank_zero
    if not rank_zero():
        return
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
        f.flush()
        os.fsync(f.fileno())


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
          device="cuda", mesh=None) -> List[Dict]:
    """Run the (b, β, sampler) product grid (the paper's §5 plane plus a
    sampler axis: ``sources`` from ``PARADIGMS``).

    ``fanout_grid`` entries are per-hop fan-out tuples (an int entry is
    broadcast to all ``cfg.n_layers`` hops); full-graph collapses to one
    point, and cluster to one point per b (fan-out does not apply).
    ``init_params(seed)`` gives each point's carried-across initial
    parameters.  ``mesh`` is the sharded paradigms' NODES mesh (see
    ``make_source``).  With ``plan.ckpt_every`` each point checkpoints
    under a directory of its own below ``plan.ckpt_dir``.

    ``journal`` makes the sweep CRASH-SAFE: every completed point is
    appended to the JSONL file (flushed + fsynced) before the next one
    starts, a rerun with the same path skips points already recorded
    ``ok`` (their journaled rows are returned in grid order), and a
    failing point becomes a ``status="error"`` row instead of ending the
    grid (error points are retried on resume).  Without a journal a
    failing point raises out of the sweep — a kernel failure included:
    there is no retry without the kernel."""
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
        if src == "cluster":
            if (src, int(b)) in seen:
                continue
            seen.add((src, int(b)))
        points.append((src, int(b), fo))
    done = _load_journal(journal)
    rows: List[Dict] = []
    for paradigm, b, fo in points:
        for seed in seeds:
            key = _point_key(paradigm, b, fo, seed)
            if key in done:
                rows.append(done[key])
                if verbose:
                    print(f"journal: skipping completed point {key}",
                          flush=True)
                continue
            plan_pt = dataclasses.replace(plan, seed=seed)
            if plan.ckpt_every:
                # namespace checkpoints per grid point/seed so runs don't
                # overwrite each other's ckpt_{step}.npz files
                tag = (paradigm if paradigm.startswith("fullgraph")
                       else f"b{b}_f{'x'.join(map(str, fo))}"
                       if paradigm == "minibatch"
                       else f"{paradigm}_b{b}_f{'x'.join(map(str, fo))}")
                plan_pt = dataclasses.replace(
                    plan_pt, ckpt_dir=os.path.join(plan.ckpt_dir,
                                                   f"{tag}_s{seed}"))
            try:
                row = run_experiment(
                    graph, cfg, plan_pt, paradigm=paradigm, b=b,
                    fanouts=fo, inference=inference,
                    serve_queries=serve_queries,
                    params=init_params(seed) if init_params else None,
                    device=device, mesh=mesh)
            except Exception as e:
                # without a journal the sweep is interactive: fail fast.
                # With one it is a long unattended grid: record the
                # failure and go on (retried on resume).  Injected crashes
                # (core.faults) are BaseExceptions and pass through.
                if journal is None:
                    raise
                row = {"paradigm": paradigm, "b": b,
                       "fanouts": "x".join(map(str, fo)) if fo else "",
                       "seed": seed, "status": "error",
                       "error": f"{type(e).__name__}: {e}"}
                _append_journal(journal, {"key": key, "status": "error",
                                          "error": row["error"]})
                rows.append(row)
                if verbose:
                    print(f"point {key} FAILED: {row['error']}",
                          flush=True)
                continue
            if journal is not None:
                _append_journal(journal, {
                    "key": key, "status": "ok",
                    "row": {k: v for k, v in row.items()
                            if not k.startswith("_")}})
                done[key] = row
            rows.append(row)
            if verbose:
                print(",".join(f"{k}={v}" for k, v in row.items()
                               if not k.startswith("_")), flush=True)
            # chaos-test crash site: a kill here (point finished AND
            # journaled) must lose no work on resume
            faults.maybe_crash("sweep.after_point")
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


# ---------------------------------------------------------------------------
# CLI — the reference's sweep smoke
# ---------------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    from repro_torch.data.synth import make_preset
    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--preset", default="arxiv-like")
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--bs", type=int, nargs="+", default=[32, 64])
    ap.add_argument("--fanout", type=int, nargs="+", default=[3])
    ap.add_argument("--sources", nargs="+", default=["minibatch"],
                    help="sampler axis of the grid (see PARADIGMS): "
                         "minibatch, minibatch_sharded, cluster, "
                         "importance, fullgraph, fullgraph_sharded; the "
                         "sharded ones run on node_mesh(): every visible "
                         "card under --device cuda, else the one device")
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--eval-every", type=int, default=2)
    ap.add_argument("--fullgraph", action="store_true")
    ap.add_argument("--kernel", action="store_true",
                    help="run every grid point's aggregation through the "
                         "CUDA kernels (their plain versions on the CPU)")
    ap.add_argument("--feats-layout", default="replicated",
                    choices=["replicated", "sharded"],
                    help="gather-source table layout of the sharded "
                         "paradigms' kernel path: 'sharded' rows the "
                         "table over the NODES shards with a degree-"
                         "ordered hot cache (full-graph) / host LRU "
                         "accounting (sampled); pair with --kernel")
    ap.add_argument("--cache-rows", type=int, default=-1,
                    help="hot-cache size C for --feats-layout sharded "
                         "(-1 auto = n//8, 0 off)")
    ap.add_argument("--journal", default=None,
                    help="JSONL completion journal: crash-safe sweeps "
                         "— rerunning with the same path skips points "
                         "already recorded ok")
    ap.add_argument("--inference", action="store_true",
                    help="append the serving-cost columns to every row")
    ap.add_argument("--serve-queries", type=int, default=32)
    ap.add_argument("--out", default="sweep_smoke")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless told otherwise)")
    args = ap.parse_args(argv)

    from repro_torch.launch import procs
    mesh = None
    if procs.in_torchrun():
        from repro_torch import sharding as sh
        mesh = sh.process_node_mesh(procs.init(device=args.device))
        dev = mesh.devices[0]
    else:
        dev = resolve_device(args.device)
    lead = procs.rank_zero()
    graph = make_preset(args.preset, n=args.n, seed=0)
    cfg = GNNConfig(name="sweep", model="graphsage", n_nodes=graph.n,
                    feat_dim=graph.feats.shape[1], hidden=32,
                    n_classes=graph.n_classes, n_layers=args.layers,
                    fanout=(5,) * args.layers, batch_size=64, loss="ce",
                    use_agg_kernel=args.kernel,
                    feats_layout=args.feats_layout,
                    feat_cache_rows=args.cache_rows)
    plan = TrainPlan(lr=args.lr, n_iters=args.iters,
                     eval_every=args.eval_every)
    fo = (tuple(args.fanout) * args.layers if len(args.fanout) == 1
          else tuple(args.fanout))
    rows = sweep(graph, cfg, plan, batch_sizes=args.bs, fanout_grid=[fo],
                 include_fullgraph=args.fullgraph, sources=args.sources,
                 verbose=lead, journal=args.journal,
                 inference=args.inference,
                 serve_queries=args.serve_queries, device=dev, mesh=mesh)
    if lead:
        paths = save_rows(args.out, rows)
        print(json.dumps({"rows": len(rows), **paths}))
    procs.close()
    return rows


if __name__ == "__main__":
    main()
