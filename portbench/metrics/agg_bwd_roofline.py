"""Percent of its roofline that the reverse-index backward reached
(``neighbor_agg_bwd_csr.cu``): the frozen ``bound_bwd_csr`` of every
call the traced steps made over the summed device time of the kernel
named below.  Not reported where no kernel matched or the launch
counter disagrees with the calls counted."""
from portbench import roofline, trace

UNIT = "%"
KERNELS = ("neighbor_agg_bwd_csr_kernel",)


def read(record):
    evs = trace.matching(record["device_events"], KERNELS)
    calls = roofline.agg_calls(record["model"], record["dims"], record["n"],
                               record["kept"], record["rows"],
                               record["el"])["bwd_csr"]
    if not evs or record["launches"].get("backward_csr") != (
            record["steps"] * len(calls)):
        return None
    spent_ms = sum(e - s for _, s, e in evs) / 1e3
    return 100.0 * record["steps"] * sum(calls) / spent_ms
