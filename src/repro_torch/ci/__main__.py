"""The port's CI runner, the counterpart of the reference's ``make
check`` (``scripts/ci.sh``)::

    PYTHONPATH=src python -m repro_torch.ci [--device cpu|cuda]
                                            [--only STAGE[,STAGE...]]

Runs the stages below in order, each command as a subprocess from the
root of the checkout, and prints one line a stage with its exit code and
seconds; it stops, and exits nonzero, at the first stage that fails.

1. ``tests`` — ``pytest -q tests/test_torch_*.py``;
2. ``analyze`` — ``python -m repro_torch.analysis`` must pass, and each
   seeded-broken fixture must make the gate fire (exit 1 with a gating
   finding in its report; a crash does not count).  The ``constant``
   fixture needs the card: under ``--device cpu`` it is not run, and the
   stage says so;
3. ``sweep-smoke`` — ``repro_torch.ci.sweep_smoke`` (the Makefile's
   three sweep calls and the featshard point on a four-shard mesh);
4. ``serve-smoke`` — the Makefile's two ``serve-smoke`` commands on
   ``repro_torch.launch.serve``;
5. ``chaos`` — the port's chaos suites (prefetcher worker faults,
   serving under chaos, checkpoints, exact resume) and
   ``repro_torch.ci.sweep_resume_smoke``.

``--device`` (``cuda`` unless told otherwise) goes to every entry point;
the tests choose their devices themselves.  No stage runs a benchmark.
"""
from __future__ import annotations

import argparse
import glob
import os
import re
import subprocess
import sys
import time
from typing import Dict, List, NamedTuple

from repro_torch.device import resolve_device

#: the root of the checkout (``src/repro_torch/ci`` is three levels down)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
#: seconds any one command may take
TIMEOUT = 3600
GATE = re.compile(r"-- (\d+) error\(s\), (\d+) warning\(s\)")


class Step(NamedTuple):
    argv: List[str]
    gate: bool = False          # must exit 1 with a gating finding


def _py(*args: str) -> List[str]:
    return [sys.executable, *args]


def stages(device: str) -> Dict[str, List[Step]]:
    """Each stage's commands on ``device``, in run order."""
    from repro_torch.analysis.fixtures import FIXTURES

    tests = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
        os.path.join(ROOT, "tests", "test_torch_*.py")))
    fixtures = [f for f in FIXTURES if device != "cpu" or f != "constant"]
    serve = _py("-m", "repro_torch.launch.serve", "--smoke", "--device",
                device)
    return {
        "tests": [Step(_py("-m", "pytest", "-q", *tests))],
        "analyze": [Step(_py("-m", "repro_torch.analysis", "--device",
                             device))]
        + [Step(_py("-m", "repro_torch.analysis", "--device", device,
                    "--fixture", f), gate=True) for f in fixtures],
        "sweep-smoke": [Step(_py("-m", "repro_torch.ci.sweep_smoke",
                                 "--device", device))],
        "serve-smoke": [
            Step(serve + ["--nodes", "300", "--chunk", "64", "--queries",
                          "32", "--updates", "4"]),
            Step(serve + ["--kernel", "--nodes", "200", "--chunk", "64",
                          "--queries", "16", "--updates", "4"])],
        "chaos": [
            Step(_py("-m", "pytest", "-x", "-q", "tests/test_torch_chaos.py",
                     "tests/test_torch_checkpoint.py",
                     "tests/test_torch_resume.py",
                     "tests/test_torch_serving_chaos.py")),
            Step(_py("-m", "repro_torch.ci.sweep_resume_smoke", "--device",
                     device))],
    }


STAGES = ("tests", "analyze", "sweep-smoke", "serve-smoke", "chaos")


def run_step(step: Step, env: dict) -> int:
    """One command's exit code; a gate step passes (0) only when it
    exits 1 with a gating finding in its report."""
    if not step.gate:
        return subprocess.run(step.argv, cwd=ROOT, env=env,
                              timeout=TIMEOUT).returncode
    out = subprocess.run(step.argv, cwd=ROOT, env=env, timeout=TIMEOUT,
                         capture_output=True, text=True)
    sys.stdout.write(out.stdout)
    sys.stdout.flush()
    m = GATE.search(out.stdout)
    fired = (out.returncode == 1 and m is not None
             and int(m.group(1)) + int(m.group(2)) > 0)
    if not fired:
        sys.stderr.write(out.stderr[-4000:])
        print(f"ci: {' '.join(step.argv[1:])} did not make the gate fire "
              f"(rc {out.returncode})", flush=True)
    return 0 if fired else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="device of every entry point (default cuda)")
    ap.add_argument("--only", default=",".join(STAGES),
                    help="comma-separated stages to run, in run order "
                         f"(default all: {','.join(STAGES)})")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    only = [s for s in args.only.split(",") if s]
    unknown = sorted(set(only) - set(STAGES))
    if unknown:
        ap.error(f"unknown stage(s) {unknown}; have {list(STAGES)}")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    plan = stages(args.device)
    if args.device == "cpu" and "analyze" in only:
        print("ci: analyze: the constant fixture needs the card; not run "
              "under --device cpu", flush=True)
    for name in STAGES:
        if name not in only:
            continue
        t0 = time.perf_counter()
        rc = 0
        for step in plan[name]:
            rc = run_step(step, env)
            if rc:
                break
        print(f"ci: stage {name} rc={rc} seconds="
              f"{time.perf_counter() - t0:.1f}", flush=True)
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
