"""Runs the port's figure benches — one module per paper table/figure
(torch copy of the reference ``benchmarks/run.py``; the reference's
kernel microbench and roofline report are not ported).

    PYTHONPATH=src python -m repro_torch.bench.run            # quick, card
    PYTHONPATH=src python -m repro_torch.bench.run --full
    PYTHONPATH=src python -m repro_torch.bench.run --only fig2,table1
    PYTHONPATH=src python -m repro_torch.bench.run --kernel   # CUDA kernels
    PYTHONPATH=src python -m repro_torch.bench.run --only fig6 --device cpu

CSV (and JSON) outputs land in experiments/bench_torch/.
"""
from __future__ import annotations

import argparse
import importlib
import time
import traceback
from typing import Dict, List, Optional, Sequence

from repro_torch.bench.common import Env

BENCHES = [
    ("fig1_metric_stability", "repro_torch.bench.bench_fig1_metric_stability"),
    ("fig2_convergence", "repro_torch.bench.bench_fig2_convergence"),
    ("fig3_generalization", "repro_torch.bench.bench_fig3_generalization"),
    ("fig4_multilayer", "repro_torch.bench.bench_fig4_multilayer"),
    ("fig5_iter_to_acc", "repro_torch.bench.bench_fig5_iter_to_acc"),
    ("fig6_throughput", "repro_torch.bench.bench_fig6_throughput"),
    ("table1_tuned", "repro_torch.bench.bench_table1_tuned"),
    ("thm3_wasserstein", "repro_torch.bench.bench_thm3_wasserstein"),
    ("theory_slopes", "repro_torch.bench.bench_theory_slopes"),
]


def selected(only: Sequence[str] = ()) -> List[str]:
    """The bench names matching any of the substring filters ``only``
    (all of them when it is empty), in ``BENCHES`` order."""
    return [name for name, _ in BENCHES
            if not only or any(s in name for s in only)]


def run_one(name: str, quick: bool = True, env: Optional[Env] = None
            ) -> List[Dict]:
    """One bench's rows; its failure raises."""
    mod = importlib.import_module(dict(BENCHES)[name])
    return mod.run(quick=quick, env=env or Env())


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="paper-scale sweeps (slow)")
    ap.add_argument("--only", default="",
                    help="comma-separated substring filters")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless told otherwise)")
    ap.add_argument("--kernel", action="store_true",
                    help="GCN/GraphSAGE aggregation through the CUDA "
                         "kernels (their plain versions on the CPU)")
    args = ap.parse_args(argv)
    env = Env(device=args.device, kernel=args.kernel)

    results = {}
    for name in selected([s for s in args.only.split(",") if s]):
        t0 = time.time()
        try:
            rows = run_one(name, quick=not args.full, env=env)
            results[name] = ("ok", len(rows), time.time() - t0)
        except Exception as e:  # noqa: BLE001 — report, run the rest
            traceback.print_exc()
            results[name] = ("error", str(e)[:100], time.time() - t0)
        print(f"== {name}: {results[name]}", flush=True)

    print("\n=== benchmark summary ===")
    for name, r in results.items():
        print(f"{name:24s} {r}")
    if any(r[0] == "error" for r in results.values()):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
