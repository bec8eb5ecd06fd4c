"""Remark 3.2: |dT/dβ| slope magnitudes — closed-form bound slopes vs the
empirical iteration-to-loss differences from the Fig.-2 sweep (copy of
the reference ``benchmarks/bench_theory_slopes.py``; closed forms on the
host, no device work)."""
from __future__ import annotations

from repro_torch.bench.common import Env, print_rows, write_csv
from repro_torch.core import theory as T


def run(quick: bool = True, seed: int = 0, env: Env = None):
    env = env or Env()
    rows = []
    n, h = 2000, 16
    for loss, slope in (("mse", T.slope_mse), ("ce", T.slope_ce)):
        for b in (32, 128, 512):
            for beta in (2, 5, 10, 20):
                rows.append({"loss": loss, "b": b, "beta": beta,
                             "abs_dT_dbeta": f"{slope(b, beta):.4g}"})
    # bound values themselves (normalized so trends are inspectable)
    t0 = T.t_mse_minibatch(n, h, 128, 10)
    for b in (32, 128, 512):
        rows.append({"loss": "mse_T", "b": b, "beta": 10,
                     "abs_dT_dbeta":
                     f"{T.t_mse_minibatch(n, h, b, 10) / t0:.4g}"})
    t1 = T.t_ce_minibatch(n, 128, 10)
    for b in (32, 128, 512):
        rows.append({"loss": "ce_T", "b": b, "beta": 10,
                     "abs_dT_dbeta":
                     f"{T.t_ce_minibatch(n, b, 10) / t1:.4g}"})
    write_csv(env, "theory_slopes", rows)
    print_rows("slopes", rows)
    return rows


if __name__ == "__main__":
    run()
