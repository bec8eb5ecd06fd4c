"""Static-audit command line of ``repro_torch.analysis`` (the
counterpart of the reference's ``scripts/analyze.py``)::

    python -m repro_torch.analysis [--json] [--fixture NAME] [--no-cache]
                                   [--device cpu|cuda]

Runs the three checkers over the port and exits nonzero iff a gating
finding (severity error / warning) survives ``allowlist.toml``:

* **trace** — one step of every sweep variant, the shared eval and the
  inference chunk under a dispatch trace (``trace_audit``);
* **kernel** — the CUDA kernels' budgets by formula and their launch
  constants against the sources; on the card, every symbol of the built
  libraries as ``cuobjdump`` reads it and the pipeline check (the
  checked build of both flash kernels, every case of
  ``kernel_audit.pipeline_cases``, its logs held to the pairing rules);
  the index tables of the audit graph (``kernel_audit``);
* **thread** — AST concurrency lint over the thread-crossing modules.

``--device`` defaults to ``cuda`` and raises on a machine without a
card; ``--device cpu`` runs what the CPU can: the resource half and the
pipeline check of the kernel audit need the card and its toolkit and are
then reported as not measured.  The trace audit is cached in
``experiments/.analysis_cache_torch.json``, keyed by a sha256 over every
``src/repro_torch/**/*.{py,cu,cuh}`` (path and bytes), ``torch.__version__``
and the device; ``--no-cache`` retraces.  The audit graph has
``trace_audit.audit_graph``'s 192 nodes.  ``--json`` writes the
findings, the budget and resource tables and the trace records to
``ANALYSIS_report_torch.json`` at the root of the checkout.
``--fixture NAME`` runs one seeded-broken fixture instead and must exit
nonzero.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

from repro_torch.analysis.thread_audit import package_root

ROOT = os.path.dirname(os.path.dirname(package_root()))
ALLOWLIST = os.path.join(package_root(), "analysis", "allowlist.toml")
REPORT = os.path.join(ROOT, "ANALYSIS_report_torch.json")
CACHE = os.path.join(ROOT, "experiments", ".analysis_cache_torch.json")
SOURCE_SUFFIXES = (".py", ".cu", ".cuh")


def source_digest(extra: str = "") -> str:
    """sha256 over every port source (relpath + bytes), the torch version
    and ``extra`` — the trace-audit cache key."""
    import torch
    h = hashlib.sha256((torch.__version__ + extra).encode())
    root = package_root()
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", "_build"))
        for fn in sorted(filenames):
            if not fn.endswith(SOURCE_SUFFIXES):
                continue
            p = os.path.join(dirpath, fn)
            h.update(os.path.relpath(p, root).encode())
            with open(p, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def run_trace_audit(use_cache: bool, device):
    """-> (findings, records, cache_hit, digest)."""
    from repro_torch.analysis.findings import Finding
    from repro_torch.analysis.trace_audit import audit_traces
    digest = source_digest(str(device))
    if use_cache and os.path.exists(CACHE):
        try:
            with open(CACHE) as f:
                blob = json.load(f)
        except (OSError, ValueError):   # stale or corrupt cache: retrace
            blob = None
        if blob and blob.get("digest") == digest:
            fs = [Finding(**d) for d in blob["findings"]]
            return fs, blob["records"], True, digest
    t0 = time.time()
    fs, records = audit_traces(device=device)
    os.makedirs(os.path.dirname(CACHE), exist_ok=True)
    tmp = f"{CACHE}.{os.getpid()}.new"
    with open(tmp, "w") as f:
        json.dump({"digest": digest, "device": str(device),
                   "trace_s": round(time.time() - t0, 1),
                   "findings": [x.as_dict() for x in fs],
                   "records": records}, f, indent=1, sort_keys=True)
    os.replace(tmp, CACHE)              # atomic: a crash keeps the old key
    return fs, records, False, digest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", action="store_true",
                    help=f"write the machine-readable run log to {REPORT}")
    ap.add_argument("--no-cache", action="store_true",
                    help="ignore and rebuild the trace-audit cache")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="where the traced steps run (default cuda)")
    from repro_torch.analysis.fixtures import FIXTURES
    ap.add_argument("--fixture", choices=FIXTURES,
                    help="run one seeded-broken fixture instead of the "
                         "port (must exit nonzero)")
    args = ap.parse_args(argv)

    from repro_torch.analysis import findings as F
    from repro_torch.device import resolve_device
    device = resolve_device(args.device)

    if args.fixture:
        from repro_torch.analysis.fixtures import run_fixture
        fs = run_fixture(args.fixture, device)
        print(F.render_report(fs))
        return 1 if F.gating(fs) else 0

    t0 = time.time()
    from repro_torch.analysis import kernel_audit as KA
    from repro_torch.analysis import thread_audit as TA
    from repro_torch.analysis.trace_audit import audit_graph

    entries, findings = F.load_allowlist(ALLOWLIST)
    table = KA.default_budget_table()
    findings += KA.audit_budgets(table) + KA.audit_sources()
    if device.type == "cuda":
        rfs, resources = KA.audit_built()
        pfs, pipelines = KA.audit_pipelines(device=device)
        findings += rfs + pfs
    else:
        resources = ("not measured: the built libraries' resources are "
                     "read with cuobjdump on the card's machine")
        pipelines = ("not measured: the checked build of the flash kernels "
                     "runs on the card")
    findings += KA.audit_index_tables(audit_graph())
    findings += TA.audit_threads()
    tfs, records, cached, digest = run_trace_audit(not args.no_cache,
                                                   device)
    findings += tfs

    kept, suppressed = F.apply_allowlist(findings, entries)
    print(F.render_report(kept, suppressed, extra={
        "trace cache": ("hit" if cached else "miss")
                       + f" (src digest {digest[:12]})",
        "variants traced": len(records),
        "pipeline check": pipelines if isinstance(pipelines, str) else
        ", ".join(f"{k} {r['cases']} cases, {r['events']} events, "
                  f"{r['findings']} findings"
                  for k, r in pipelines["kernels"].items()),
        "device": str(device),
        "elapsed": f"{time.time() - t0:.1f}s",
    }))
    if args.json:
        import torch
        report = {
            "findings": [x.as_dict() for x in kept],
            "suppressed": [x.as_dict() for x in suppressed],
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "budget_table": table,
            "resource_table": resources,
            "pipeline_check": pipelines,
            "trace_records": records,
            "src_digest": digest,
        }
        tmp = REPORT + ".new"
        with open(tmp, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, REPORT)
        print(f"-- wrote {os.path.relpath(REPORT, ROOT)}")

    gate = F.gating(kept)
    if gate:
        print(f"ANALYZE: FAIL ({len(gate)} gating finding(s))",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
