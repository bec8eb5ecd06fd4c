"""Seconds of the first steps, from ``Trainer.run``'s start to the end
of the warm steps (synchronised), before the profiler starts: the
kernel library's load (and, in a fresh checkout, its build), the first
launches, the allocator's growth and the first evaluation."""
UNIT = "s"


def read(record):
    return record["setup"]["warm_s"]
