"""One run of one cell: the cell's files by name, the program built from
them, its training run with a window and (``trace``) a profiled
stretch, the check against the plain reference, and the result line.

The program is the port, ``repro_torch``: its ``Trainer`` over a
``FullGraphSource``, driven through ``Trainer.run`` exactly as a user
runs it.  The benchmark adds a callback (``Tap``) that stamps the
window and stops the run, and a source that only snapshots the
parameters and optimizer state before steps 1 and 3 (its batches are
``FullGraphSource``'s).  Everything else is the cell's files:

* ``workloads/<cell>.json``: the configuration, the traffic, the chips,
  why, and the limits of the check;
* ``configs/<config>.json``: the model, its widths, the graph regime,
  the training plan;
* ``traffic/<traffic>.json``: how the run is driven (source, warm-up and
  traced steps);
* ``metrics/<metric>.py``: one reader for each per-layer metric.
"""
from __future__ import annotations

import dataclasses
import gc
import glob
import importlib.util
import json
import math
import os
import statistics
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

#: the launch counters of ``ops.launch_counts()`` that each count a launch
#: once (the route and epilogue counters split ``tiled``)
LAUNCH_KEYS = ("tiled", "backward", "backward_csr", "row",
               "backward_identity")


# ---------------------------------------------------------------------------
# the cell's files
# ---------------------------------------------------------------------------

def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict


def load_cell(name: str) -> Cell:
    """The cell ``name`` and the configuration and traffic it names."""
    wl = load_json("workloads", name)
    return Cell(name=name, workload=wl,
                config=load_json("configs", wl["config"]),
                traffic=load_json("traffic", wl["traffic"]))


def metric_readers() -> Dict[str, object]:
    """Every per-layer reader under ``metrics/``, by the metric's name
    (its file's name): a module with ``UNIT`` and ``read(record) ->
    float | None``."""
    out = {}
    for path in sorted(glob.glob(os.path.join(HERE, "metrics", "*.py"))):
        name = os.path.basename(path)[:-3]
        if name.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod
    return out


def dims_of(config: dict):
    from portbench.roofline import layer_dims
    return layer_dims(config["feat_dim"], config["hidden"],
                      config["n_classes"], config["n_layers"])


def gnn_config(config: dict):
    """The port's ``GNNConfig`` of a configuration file."""
    from repro_torch.configs.base import GNNConfig
    return GNNConfig(name=config["name"], model=config["model"],
                     n_nodes=config["n_nodes"], feat_dim=config["feat_dim"],
                     hidden=config["hidden"], n_classes=config["n_classes"],
                     n_layers=config["n_layers"],
                     max_degree=config["max_degree"] or 0,
                     dtype=config["dtype"], loss="ce",
                     use_agg_kernel=config["use_agg_kernel"],
                     agg_interpret=False, source=config["source"])


def train_plan(config: dict, seed: int, n_iters: int):
    """The port's ``TrainPlan`` of a configuration file's ``plan``.  The
    optimizer constants the port fixes (AdamW's betas, eps, clipping)
    are stated in the file for the reference and not passed."""
    from repro_torch.core.engine import TrainPlan
    p = config["plan"]
    kw = dict(lr=p["lr"], n_iters=n_iters, optimizer=p["optimizer"],
              eval_every=p["eval_every"], seed=seed)
    if p["optimizer"] == "adamw":
        kw["weight_decay"] = p["weight_decay"]
    return TrainPlan(**kw)


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------

def _leaves(tree) -> list:
    return [layer[k] for layer in tree for k in layer]


class Tap:
    """The benchmark's callback on the port's ``Trainer`` (it has every
    hook of ``engine.Callback``).  With deferred sync ``on_step(i)``
    fires while step ``i + 1`` is in flight, so after a synchronise
    steps ``0 .. i + 1`` are done.  The warm-up ends (``t_warm``) at the
    ``on_step`` after which ``warm`` steps are done; the window opens
    once ``on_open`` (the profiler's start, when traced) has returned
    and closes at the first ``on_step`` past ``seconds`` (or, traced,
    after ``trace_steps`` steps), synchronising at both ends; it then
    asks the run to stop."""

    def __init__(self, warm: int, seconds: Optional[float],
                 trace_steps: Optional[int], sync: Callable[[], None],
                 on_open: Callable[[], None] = lambda: None,
                 on_close: Callable[[], None] = lambda: None):
        self.warm, self.seconds, self.trace_steps = warm, seconds, trace_steps
        self.sync, self.on_open, self.on_close = sync, on_open, on_close
        self.losses: Dict[int, float] = {}
        self.snaps: Dict[int, dict] = {}
        self.t_run = self.t_warm = self.t0 = self.t1 = None
        self.n0 = self.n1 = None
        self.bad = 0
        self.state = None
        self.warm_at = []

    # Callback hooks -----------------------------------------------------
    def on_train_start(self, state):
        self.state = state
        self.t_run = time.perf_counter()

    def on_step(self, state):
        it = state.it
        if it < 3:
            self.losses[it] = state.loss
        if it < self.warm:
            self.warm_at.append(time.perf_counter() - self.t_run)
        if self.t0 is None:
            if self.seconds is not None and it + 2 == self.warm:
                self.sync()
                self.t_warm = time.perf_counter()
                self.on_open()
                self.t0, self.n0 = time.perf_counter(), it + 2
            return
        if self.t1 is not None:
            return
        self.bad += int(state.step_bad)
        done = it + 2 - self.n0
        if (self.trace_steps is not None and done >= self.trace_steps) or (
                self.trace_steps is None
                and time.perf_counter() - self.t0 >= self.seconds):
            self.sync()
            self.t1, self.n1 = time.perf_counter(), it + 2
            self.on_close()
            state.request_stop("window closed")

    def on_eval(self, state): ...

    def on_stop(self, state): ...

    def on_train_end(self, state): ...

    # the source's tap -----------------------------------------------------
    def before_step(self, it: int) -> None:
        """Before step ``it`` is dispatched: keep copies of the state the
        steps before it left (queued behind them on the device)."""
        if it not in (1, 3) or self.state is None:
            return
        st = self.state
        mu = (st.opt_state.get("mu") if isinstance(st.opt_state, dict)
              else None)
        self.snaps[it] = {
            "params": [p.detach().clone() for p in _leaves(st.params)],
            "mu": None if mu is None else [m.clone() for m in _leaves(mu)]}


def tap_source(max_deg, tap: Tap):
    """The port's ``FullGraphSource`` whose batch stream first calls
    ``tap.before_step``; its batches and loss are the source's own."""
    from repro_torch.core.engine import FullGraphSource

    class TapSource(FullGraphSource):
        def batches(self):
            it = 0
            for batch in super().batches():
                tap.before_step(it)
                it += 1
                yield batch

    return TapSource(max_deg=max_deg)


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------

def _norm(t) -> float:
    import torch
    return float(torch.linalg.vector_norm(t.double()))


def program_readings(tap: Tap, params0, plan: dict) -> dict:
    """What the program's state says after its first steps: each of the
    first three losses, the first gradient as the optimizer got it
    (SGD: ``(p0 - p1) / lr``; AdamW: its first moment over ``1 - b1``)
    and the parameters' change after three steps, as leaf norms."""
    import torch
    dev = tap.snaps[1]["params"][0].device
    p0 = [torch.as_tensor(np.asarray(v, np.float32), device=dev)
          for layer in params0 for v in layer.values()]
    if plan["optimizer"] == "sgd":
        grad = [(a - b).double() / plan["lr"]
                for a, b in zip(p0, tap.snaps[1]["params"])]
    else:
        grad = [m.double() / (1.0 - plan["b1"]) for m in tap.snaps[1]["mu"]]
    return {"losses": [tap.losses.get(i, math.nan) for i in range(3)],
            "grad": [_norm(g) for g in grad],
            "delta1": [_norm(b - a)
                       for a, b in zip(p0, tap.snaps[1]["params"])],
            "delta": [_norm(b - a)
                      for a, b in zip(p0, tap.snaps[3]["params"])]}


def reference_readings(ref: dict) -> dict:
    return {"losses": ref["losses"],
            **{k: [_norm(t) for t in ref[k]]
               for k in ("grad", "delta1", "delta")}}


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers a cell may compare: ``loss_gap``, the largest relative
    gap of the first three losses, and ``loss0_gap``, the first's alone;
    ``grad_gap`` (the first gradient) and ``change_gap`` (the parameters'
    change after three steps), each the largest gap between a leaf's
    norm in the program and in the reference over the larger of the
    reference's norm of that leaf and of the median leaf; and
    ``change1_median_gap``, the median leaf's such gap of the change
    after one step.  A leaf whose reference gradient is under a
    thousandth of the median leaf's moves by round-off alone and is left
    out of the changes."""
    def rel(p, r):
        return abs(p - r) / abs(r) if math.isfinite(p) else math.inf

    def by_leaf(a, b, leaves):
        med = statistics.median([b[i] for i in leaves])
        return [abs(a[i] - b[i]) / max(b[i], med) if math.isfinite(a[i])
                else math.inf for i in leaves]

    g_ref = ref["grad"]
    med = statistics.median(g_ref)
    moved = [i for i, g in enumerate(g_ref) if g >= 1e-3 * med]
    return {"loss_gap": max(rel(p, r) for p, r in zip(prog["losses"],
                                                      ref["losses"])),
            "loss0_gap": rel(prog["losses"][0], ref["losses"][0]),
            "grad_gap": max(by_leaf(prog["grad"], g_ref, range(len(g_ref)))),
            "change_gap": max(by_leaf(prog["delta"], ref["delta"], moved)),
            "change1_median_gap": statistics.median(
                by_leaf(prog["delta1"], ref["delta1"], moved))}


def judge(numbers: Dict[str, float], limits: Dict[str, Optional[float]]):
    """(correct, checks): every number with a limit at or under it; a
    number whose limit is null is shown and not compared."""
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in numbers.items()}
    ok = all(c["limit"] is None or (math.isfinite(c["value"])
                                    and c["value"] <= c["limit"])
             for c in checks.values())
    return ok, checks


def reference_model(config: dict):
    import torch
    from portbench.reference.gnn import Model
    return Model(kind=config["model"],
                 dtype={"float32": torch.float32,
                        "bfloat16": torch.bfloat16}[config["dtype"]],
                 n_classes=config["n_classes"])


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def _graph(host):
    from repro_torch.core.graph import Graph
    return Graph(n=host.n, indptr=host.indptr, indices=host.indices,
                 feats=host.feats, labels=host.labels,
                 train_mask=host.train_mask, val_mask=host.val_mask,
                 test_mask=host.test_mask)


def make_inputs(cfg: dict, seed: int, device):
    """The graph (host arrays) and the initial parameters (numpy) of a
    configuration for ``seed``, made on ``device``."""
    from portbench.traffic.generator import init_params, make_graph
    host = make_graph(cfg["graph"], cfg["n_nodes"], cfg["feat_dim"],
                      cfg["n_classes"], seed, device)
    return host, init_params(dims_of(cfg), cfg["model"], seed, device)


def _log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def run_cell(cell: Cell, seed: int, seconds: Optional[float], trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             steps_only: bool = False) -> dict:
    """One run of ``cell``: the result line's fields (without the check
    of imports, which the caller makes once everything has run).
    ``steps_only`` runs the first steps and the check, with no window
    (the readings of ``controls.py``)."""
    import torch
    from portbench import roofline
    from portbench.reference import gnn as ref
    from repro_torch.core.engine import Trainer, drop_device_cache
    from repro_torch.kernels.neighbor_agg import ops

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize()) if cuda else (lambda: None)
    cfg, trf = cell.config, cell.traffic
    if trf["source"] != "fullgraph":
        raise ValueError(f"traffic {cell.workload['traffic']!r}: this "
                         f"harness runs no source {trf['source']!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dims = dims_of(cfg)
    n = cfg["n_nodes"]
    host, params0 = make_inputs(cfg, seed, device)
    graph = _graph(host)
    _log(f"graph n={n} nnz={host.indices.size} d_max="
         f"{int(np.diff(host.indptr).max())} made "
         f"{time.perf_counter() - t_start:.3f} s after start")
    deg = np.diff(host.indptr)
    k = int(cfg["max_degree"] or deg.max())
    kept = int(np.minimum(deg, k).sum())
    n_train = int(host.train_mask.sum())
    if cuda:
        sync()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    prof = {}

    def on_open():
        if trace:
            from portbench import trace as tr
            ops.reset_launches()
            prof["p"] = tr.start()

    def on_close():
        if trace:
            from portbench import trace as tr
            prof["events"] = tr.stop(prof.pop("p"))
            counts = ops.launch_counts()
            prof["launches"] = {kk: counts[kk] for kk in LAUNCH_KEYS}

    warm = int(trf["warm_steps"])
    if warm < 5:
        raise ValueError("warm_steps must be at least 5: the check reads "
                         "the state before steps 1 and 3")
    tap = Tap(warm=warm, seconds=None if steps_only else (seconds or 0.0),
              trace_steps=int(trf["trace_steps"]) if trace else None,
              sync=sync, on_open=on_open, on_close=on_close)
    n_iters = 4 if steps_only else 10 ** 9
    t_bind = time.perf_counter()
    trainer = Trainer(graph, gnn_config(cfg),
                      train_plan(cfg, seed, n_iters),
                      source=tap_source(cfg["max_degree"], tap),
                      extra_callbacks=[tap], params=params0, device=device)
    sync()
    bind_s = time.perf_counter() - t_bind
    _log(f"Trainer built in {bind_s:.3f} s")
    trainer.run()
    sync()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    _log(f"run ended {time.perf_counter() - t_start:.3f} s after start; "
         f"first on_step calls at {[round(t, 3) for t in tap.warm_at]} s "
         f"into the run; window {tap.n0}..{tap.n1} steps; peak {peak} B")
    prog = program_readings(tap, params0, cfg["plan"])
    trainer.close()
    del trainer, tap.snaps, tap.state
    drop_device_cache(graph)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    edges = ref.build_edges(host.indptr, host.indices, cfg["max_degree"],
                            device)
    model = reference_model(cfg)
    refr = reference_readings(ref.follow(host, edges, model, cfg["plan"],
                                         params0, device=device))
    _log(f"reference took {time.perf_counter() - t_ref:.3f} s; program "
         f"{json.dumps(prog)}; reference {json.dumps(refr)}")
    numbers = gaps(prog, refr)
    correct, checks = judge(numbers, cell.workload["limits"])
    out = {"correct": correct, "numbers": numbers, "checks": checks,
           "program": prog, "reference": refr,
           "memory_peak_bytes": int(peak)}
    if steps_only:
        return out

    steps = tap.n1 - tap.n0
    window_s = tap.t1 - tap.t0
    every = cfg["plan"]["eval_every"]
    evals = sum(1 for it in range(tap.n0, tap.n1) if it % every == 0)
    out.update(attempted=steps, failed=tap.bad)
    if not trace:
        flops = roofline.step_flops(cfg["model"], dims, n, kept)["total"]
        out["metrics"] = {
            "train_nodes_per_s": {"value": steps * n_train / window_s,
                                  "unit": "nodes/s"},
            "mfu": {"value": 100.0 * steps * flops
                    / (window_s * roofline.F32_FLOPS_PER_S), "unit": "%"},
            "setup_s": {"value": tap.t0 - t_start, "unit": "s"}}
        return out
    from portbench import trace as tr
    evs = prof["events"]
    record = {
        "model": cfg["model"], "dims": dims, "n": n, "kept": kept,
        "rows": edges.rows_referenced,
        "el": 2 if cfg["dtype"] == "bfloat16" else 4,
        "steps": steps, "evals": evals, "window_s": window_s,
        "device_events": evs["device"], "host_events": evs["host"],
        "launches": prof["launches"],
        "setup": {"bind_s": bind_s, "warm_s": tap.t_warm - tap.t_run}}
    metrics = {}
    for name, reader in metric_readers().items():
        v = reader.read(record)
        if v is not None:
            metrics[name] = {"value": v, "unit": reader.UNIT}
    out["metrics"] = metrics
    out["busy_s"] = tr.busy_s(evs["device"])
    out["window_s"] = window_s
    out["breakdown"] = {"device_ops": tr.by_name(evs["device"]),
                        "idle_gaps": tr.idle_gaps(evs["device"],
                                                  evs["host"])}
    return out

