"""The readings the limits of a cell's check are set from, on the card at
the cell's own size.  Not run by the benchmark's runs.

    python3 portbench/controls.py --workload <cell> --seeds 1,2,3 \\
        --modes program,tf32,half_batch,altered_rows [--out <file.jsonl>]

For each seed and mode one JSON line with the numbers that the check
compares (``harness.gaps``):

* ``program``: the program's first steps (``run_cell(steps_only=True)``)
  against the reference: the sound runs, whose largest reading is a
  limit's lower end;
* ``tf32``: the control, the reference with its products on the card's
  TF32 path, put in the program's place;
* ``half_batch``: the reference with half of the training nodes left
  out of the loss, the mean taken over the rest;
* ``altered_rows``: the reference with rows 127 mod 128 of every
  aggregation's output zeroed, an answer altered where it is produced;
* ``adam_reset`` / ``adam_t1`` (AdamW cells): the reference with the
  moments of the first update dropped before the second, or with the
  step count held at 1: faults that the first step cannot show.

A state left unchanged reads 1 in ``grad_gap`` and ``change_gap`` by
their definition and needs no run.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="program,tf32,half_batch,altered_rows")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    from portbench import harness as H
    from portbench.reference import gnn as ref

    cell = H.load_cell(args.workload)
    cfg = cell.config
    modes = args.modes.split(",")
    sink = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        rows = []
        if "program" in modes:
            t = time.perf_counter()
            out = H.run_cell(cell, seed, None, False, device="cuda",
                             steps_only=True)
            rows.append({"mode": "program", "numbers": out["numbers"],
                         "program": out["program"],
                         "reference": out["reference"],
                         "memory_peak_bytes": out["memory_peak_bytes"],
                         "s": time.perf_counter() - t})
        others = [m for m in modes if m != "program"]
        if others:
            t = time.perf_counter()
            host, params0 = H.make_inputs(cfg, seed, "cuda")
            edges = ref.build_edges(host.indptr, host.indices,
                                    cfg["max_degree"], "cuda")
            model = H.reference_model(cfg)
            base = H.reference_readings(ref.follow(
                host, edges, model, cfg["plan"], params0,
                device="cuda"))
            for m in others:
                r = H.reference_readings(ref.follow(
                    host, edges, model, cfg["plan"], params0,
                    precision="tf32" if m == "tf32" else "f32",
                    fault=None if m == "tf32" else m, device="cuda"))
                rows.append({"mode": m, "numbers": H.gaps(r, base),
                             "readings": r})
            rows.append({"mode": "reference", "readings": base,
                         "s": time.perf_counter() - t})
            del host, edges
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
        for r in rows:
            line = json.dumps({"workload": args.workload, "seed": seed, **r})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
