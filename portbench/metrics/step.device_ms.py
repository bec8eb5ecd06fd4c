"""Device milliseconds a step: the union of the device's work intervals
in the traced steps (kernels, copies and fills, the evaluations that
fall among them included) over the number of steps."""
from portbench import trace

UNIT = "ms"


def read(record):
    if not record["device_events"] or not record["steps"]:
        return None
    return 1e3 * trace.busy_s(record["device_events"]) / record["steps"]
