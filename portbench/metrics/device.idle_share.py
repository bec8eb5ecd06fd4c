"""Percent of the traced window in which nothing ran on the device: one
minus the union of the device's work intervals over the window's
length."""
from portbench import trace

UNIT = "%"


def read(record):
    if not record["device_events"] or record["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s(record["device_events"])
                    / record["window_s"])
