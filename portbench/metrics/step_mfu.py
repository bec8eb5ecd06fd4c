"""Percent of the card's f32 peak (67 TFLOP/s) that the traced steps'
work reached while the device was busy: the FLOPs of their training
steps and of the evaluation forwards among them, counted from the shapes
(``roofline.step_flops``), over the union of the device's work intervals
in the trace (``trace.busy_s``) times the peak.  The whole step's share,
beside the kernels' rooflines: a kernel taken off the path leaves its
roofline silent, and this still bounds it."""
from portbench import roofline, trace

UNIT = "%"


def read(record):
    if not record["device_events"] or not record["steps"]:
        return None
    args = (record["model"], record["dims"], record["n"], record["kept"])
    flops = (record["steps"] * roofline.step_flops(*args)["total"]
             + record["evals"] * roofline.step_flops(*args, train=False)
             ["total"])
    busy = trace.busy_s(record["device_events"])
    return 100.0 * flops / (busy * roofline.F32_FLOPS_PER_S)
