"""The traced window: a ``torch.profiler`` trace of the device, read back
from its Chrome-trace export, and the arithmetic on its intervals that
the per-layer readers and the ``breakdown`` share."""
from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Tuple

#: trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: trace categories of what the host was doing
HOST_CATS = ("cpu_op", "cuda_runtime", "user_annotation")

Event = Tuple[str, float, float]          # (name, start us, end us)


def start():
    """A running profiler of the host and the card."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def stop(prof) -> Dict[str, List[Event]]:
    """Stop ``prof`` and return its events by side: ``device`` (kernels,
    copies, fills) and ``host`` (operators and runtime calls).  The
    export goes through a file under ``TMPDIR`` that is removed at
    once."""
    prof.__exit__(None, None, None)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    evs = data["traceEvents"] if isinstance(data, dict) else data
    out: Dict[str, List[Event]] = {"device": [], "host": []}
    for e in evs:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        side = ("device" if e.get("cat") in DEVICE_CATS
                else "host" if e.get("cat") in HOST_CATS else None)
        if side:
            ts = float(e["ts"])
            out[side].append((str(e.get("name", "")), ts,
                              ts + float(e["dur"])))
    return out


def union(events: List[Event]) -> List[Tuple[float, float]]:
    """The disjoint intervals (us) that ``events`` cover, in order."""
    spans: List[Tuple[float, float]] = []
    for _, s, e in sorted(events, key=lambda x: x[1]):
        if spans and s <= spans[-1][1]:
            if e > spans[-1][1]:
                spans[-1] = (spans[-1][0], e)
        else:
            spans.append((s, e))
    return spans


def busy_s(events: List[Event]) -> float:
    """Seconds in which at least one of ``events`` ran."""
    return sum(e - s for s, e in union(events)) / 1e6


def by_name(events: List[Event], top: int = 10) -> List[list]:
    """The ``top`` names with the most summed time: [[name, seconds]]."""
    tot: Dict[str, float] = {}
    for name, s, e in events:
        tot[name] = tot.get(name, 0.0) + (e - s) / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
            [:top]]


def idle_gaps(device: List[Event], host: List[Event],
              top: int = 10) -> List[list]:
    """The ``top`` longest gaps between device work, each named by what
    the host was doing at the gap's middle: the shortest host event that
    covers it, or else ``after <the host event that began last before
    it>``: [[name, seconds]]."""
    spans = union(device)
    gaps = [(spans[i][1], spans[i + 1][0]) for i in range(len(spans) - 1)]
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:top]:
        mid = 0.5 * (s + e)
        cover = [h for h in host if h[1] <= mid <= h[2]]
        before = [h for h in host if h[1] <= mid]
        name = (min(cover, key=lambda h: h[2] - h[1])[0] if cover
                else "after " + max(before, key=lambda h: h[1])[0] if before
                else "host: no traced call")
        out.append([name, (e - s) / 1e6])
    return out


def matching(events: List[Event], names) -> List[Event]:
    """The events whose name holds one of ``names`` (lower case)."""
    return [ev for ev in events if any(k in ev[0].lower() for k in names)]
