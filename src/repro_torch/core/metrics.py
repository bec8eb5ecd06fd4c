"""The paper's evaluation metrics (§5.1): iteration-to-loss,
iteration-to-accuracy, time-to-accuracy, throughput — and the cost model
of the Fig.-1-style bandwidth thought experiment.  Pure Python copy of
the reference ``repro.core.metrics``."""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional


@dataclasses.dataclass
class History:
    """Per-iteration training record."""
    losses: List[float] = dataclasses.field(default_factory=list)
    full_losses: List[float] = dataclasses.field(default_factory=list)
    full_loss_iters: List[int] = dataclasses.field(default_factory=list)
    val_accs: List[float] = dataclasses.field(default_factory=list)
    val_acc_iters: List[int] = dataclasses.field(default_factory=list)
    times: List[float] = dataclasses.field(default_factory=list)
    nodes_processed: List[int] = dataclasses.field(default_factory=list)
    #: 1-based iterations whose step produced a non-finite loss/grad and
    #: was skipped by the engine's BadStepPolicy
    bad_steps: List[int] = dataclasses.field(default_factory=list)
    #: run-level scalar counters (not per-iteration)
    counters: dict = dataclasses.field(default_factory=dict)
    _t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def to_dict(self) -> dict:
        """JSON-serializable snapshot (floats round-trip exactly through
        ``json``; ``times`` restart from the wall clock of a resume)."""
        return {f.name: (dict(v) if isinstance(v, dict) else list(v))
                for f in dataclasses.fields(self)
                if not f.name.startswith("_")
                for v in (getattr(self, f.name),)}

    @classmethod
    def from_dict(cls, d: dict) -> "History":
        h = cls()
        for f in dataclasses.fields(cls):
            if not f.name.startswith("_") and f.name in d:
                v = d[f.name]
                setattr(h, f.name, dict(v) if isinstance(v, dict)
                        else list(v))
        return h

    def record(self, loss: float, val_acc: Optional[float] = None,
               nodes: int = 0):
        self.losses.append(float(loss))
        if val_acc is not None:
            self.val_accs.append(float(val_acc))
            # evals happen every eval_every iterations: keep the 1-based
            # iteration of each so the *_to_accuracy helpers report true
            # iteration numbers
            self.val_acc_iters.append(len(self.losses))
        self.times.append(time.perf_counter() - (self._t0 or 0.0))
        self.nodes_processed.append(nodes)


def iteration_to_loss(hist: History, target: float) -> Optional[int]:
    """# iterations until train loss <= target (None = never)."""
    for i, l in enumerate(hist.losses):
        if l <= target:
            return i + 1
    return None


def iteration_to_full_loss(hist: History, target: float) -> Optional[int]:
    """# iterations until the FULL training objective <= target — the
    paper's iteration-to-loss."""
    for it, l in zip(hist.full_loss_iters, hist.full_losses):
        if l <= target:
            return it
    return None


def iteration_to_accuracy(hist: History, target: float) -> Optional[int]:
    """# iterations until val accuracy >= target (None = never), by the
    recorded ``val_acc_iters`` (index + 1 for hand-built Histories
    without them)."""
    iters = (hist.val_acc_iters
             if len(hist.val_acc_iters) == len(hist.val_accs)
             else range(1, len(hist.val_accs) + 1))
    for it, a in zip(iters, hist.val_accs):
        if a >= target:
            return it
    return None


def time_to_accuracy(hist: History, target: float) -> Optional[float]:
    it = iteration_to_accuracy(hist, target)
    if it is None:
        return None
    return hist.times[min(it, len(hist.times)) - 1]


def throughput_nodes_per_sec(hist: History) -> float:
    """Training throughput = target nodes processed / wall time (§5.4)."""
    total = sum(hist.nodes_processed)
    t = hist.times[-1] if hist.times else 0.0
    return total / t if t > 0 else 0.0


def simulated_time_to_acc(iter_to_acc: int, nodes_per_iter: float,
                          bandwidth_nodes_per_sec: float) -> float:
    """§5.1's derivation: time = iters * nodes / bandwidth (the Fig. 1
    hardware-(in)dependence demonstration)."""
    return iter_to_acc * nodes_per_iter / bandwidth_nodes_per_sec
