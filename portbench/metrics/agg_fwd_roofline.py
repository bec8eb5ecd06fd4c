"""Percent of its roofline that the tiled forward reached, both routes
(``neighbor_agg.cu``, ``neighbor_agg_slab.cu``): ``roofline.bound`` of
every call the traced steps made (each layer's forward in every step and
in every evaluation among them), counted over the kept edges and not the
ELL's padded slots, over the summed device time of the kernels named
below.  Not reported where no kernel matched or the
launch counter disagrees with the calls counted."""
from portbench import roofline, trace

UNIT = "%"
KERNELS = ("neighbor_agg_kernel", "neighbor_agg_slab_kernel")


def read(record):
    evs = trace.matching(record["device_events"], KERNELS)
    args = (record["model"], record["dims"], record["n"], record["kept"],
            record["rows"], record["el"])
    step = roofline.agg_calls(*args)["fwd"]
    ev = roofline.agg_calls(*args, train=False)["fwd"]
    calls = record["steps"] * len(step) + record["evals"] * len(ev)
    if not evs or record["launches"].get("tiled") != calls:
        return None
    spent_ms = sum(e - s for _, s, e in evs) / 1e3
    least = record["steps"] * sum(step) + record["evals"] * sum(ev)
    return 100.0 * least / spent_ms
