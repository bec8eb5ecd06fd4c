"""Launches of the port's neighbor-aggregation kernels a step: the sum of
``ops.launch_counts()``'s per-kernel counters over the traced steps (the
evaluations' forwards among them included), over the number of steps."""
UNIT = "launches"


def read(record):
    if not record["steps"] or record.get("launches") is None:
        return None
    return sum(record["launches"].values()) / record["steps"]
