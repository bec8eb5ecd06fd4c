"""Percent of their roofline that the dense products reached: the least
time of the traced steps' products (training steps and evaluation
forwards; each bounded by its FLOPs at the f32 rate or its bytes at the
HBM rate, ``roofline.gemm_bound_ms``) over the summed device time of the
kernels whose names are below (cuBLAS's, as ``core/gnn.py``'s
``h @ W`` calls them).  Nothing matched: not reported."""
from portbench import roofline, trace

UNIT = "%"
#: lower-case parts of the product kernels' names
KERNELS = ("gemm", "gemv", "splitkreduce")


def read(record):
    evs = trace.matching(record["device_events"], KERNELS)
    if not evs:
        return None
    spent_ms = sum(e - s for _, s, e in evs) / 1e3
    args = (record["model"], record["dims"], record["n"])
    least = (record["steps"] * roofline.gemm_bound_ms(*args)
             + record["evals"] * roofline.gemm_bound_ms(*args, train=False))
    return 100.0 * least / spent_ms
