"""Deterministic fault injection: failpoints + seeded chaos schedules
(copy of the reference ``repro.core.faults``; ``poison_batches`` rewrites
the port's tensor batches).

The resilience layer (exact-resume checkpoints, non-finite step guards,
supervised prefetch, crash-safe sweeps) is only trustworthy if its
recovery paths are *exercised*, deterministically, in CI.  This module
is the injection side of that contract:

- **Failpoints** — named crash sites compiled into the production code
  (``_maybe_crash("ckpt.after_npz_rename")`` in ``checkpoint.ckpt``,
  ``"sweep.after_point"`` in ``core.experiment``).  They are inert
  no-ops (one dict lookup on an empty dict) until a test ``arm()``s
  them, after which the N-th hit raises ``SimulatedCrash`` — a
  ``BaseException`` so it sails through ``except Exception`` recovery
  code exactly like a SIGKILL would end the process.
- **Flaky callables** — ``flaky(fn, fail_at={...})`` wraps a sampler /
  payload function so specific *invocations* raise.  Transient faults
  (``TransientSamplerFault``) drive the Prefetcher's supervised
  restart; ``FatalSamplerFault`` (or any other exception) must surface
  to the caller instead.
- **Batch poisoning** — ``poison_batches(source, at_iters)`` rewrites a
  ``BatchSource``'s device batches so every float tensor at the chosen
  iterations is NaN, driving the engine's non-finite step guard and
  ``BadStepPolicy`` without touching model code.
- **Seeded schedules** — ``FaultSchedule(seed)`` picks *which* batches
  / calls / steps to break from a fixed-seed rng, so a chaos suite is
  reproducible: same fault seed, same faults, same recovery sequence.

Everything here is test/ops tooling: importing it pulls in nothing
heavier than numpy, and with no failpoints armed the production-code
hooks cost one ``dict.get`` on an empty dict.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Dict, Iterable, Optional, Set

import numpy as np


class SimulatedCrash(BaseException):
    """An injected hard crash (kill -9 stand-in).  Deliberately NOT an
    ``Exception``: recovery code that catches ``Exception`` (the sweep's
    per-point isolation, the Prefetcher's restart supervision) must let
    a real process death through, and tests verify exactly that."""


class TransientSamplerFault(RuntimeError):
    """A worker error the Prefetcher classifies as TRANSIENT: the
    supervised worker restarts (bounded exponential backoff) and replays
    the same batch from the pre-draw rng snapshot."""


class FatalSamplerFault(RuntimeError):
    """A worker error the Prefetcher classifies as FATAL: stored and
    re-raised on every subsequent ``next()``."""


class TransientRefreshFault(TransientSamplerFault):
    """A serving-side refresh error classified as TRANSIENT: the
    embedding store's ``refresh_with_recovery`` retries it with
    exponential backoff (same transient/fatal split as the sampler)."""


# ---------------------------------------------------------------------------
# Failpoints
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FailPoint:
    name: str
    at_hits: Set[int]
    exc: Callable[[str], BaseException]
    hits: int = 0

    def check(self) -> None:
        idx, self.hits = self.hits, self.hits + 1
        if idx in self.at_hits:
            raise self.exc(f"failpoint {self.name!r} hit #{idx}")


_ACTIVE: Dict[str, FailPoint] = {}


def arm(name: str, at_hits: Iterable[int] = (0,),
        exc: Callable[[str], BaseException] = SimulatedCrash) -> FailPoint:
    """Arm failpoint ``name``: its ``at_hits``-th invocations (0-based,
    counted from arming) raise ``exc(message)``."""
    fp = FailPoint(name, set(int(i) for i in at_hits), exc)
    _ACTIVE[name] = fp
    return fp


def disarm(name: Optional[str] = None) -> None:
    """Disarm one failpoint (or all of them with ``name=None``)."""
    if name is None:
        _ACTIVE.clear()
    else:
        _ACTIVE.pop(name, None)


def maybe_crash(name: str) -> None:
    """The production-code hook: no-op unless ``name`` is armed."""
    fp = _ACTIVE.get(name)
    if fp is not None:
        fp.check()


@contextlib.contextmanager
def armed(name: str, at_hits: Iterable[int] = (0,),
          exc: Callable[[str], BaseException] = SimulatedCrash):
    """``with faults.armed("ckpt.after_npz_rename"): ...`` — arm for the
    block, always disarm on exit (even when the crash propagates)."""
    fp = arm(name, at_hits, exc)
    try:
        yield fp
    finally:
        disarm(name)


# ---------------------------------------------------------------------------
# Flaky callables
# ---------------------------------------------------------------------------

def flaky(fn: Callable, fail_at: Iterable[int],
          exc: Callable[[str], BaseException] = TransientSamplerFault
          ) -> Callable:
    """Wrap ``fn`` so its ``fail_at``-th *invocations* (0-based) raise.

    Retries count as new invocations: with ``fail_at={2}`` call #2
    raises and the retry (call #3, typically replaying the same batch
    from a restored rng state) succeeds — the shape of a transient
    fault."""
    hit = set(int(i) for i in fail_at)
    calls = {"n": 0}

    @functools.wraps(fn)
    def wrapper(*a, **kw):
        idx, calls["n"] = calls["n"], calls["n"] + 1
        if idx in hit:
            raise exc(f"injected fault at call #{idx} of "
                      f"{getattr(fn, '__name__', fn)!r}")
        return fn(*a, **kw)

    wrapper.calls = calls
    return wrapper


# ---------------------------------------------------------------------------
# Batch poisoning (NaN-at-step-k)
# ---------------------------------------------------------------------------

def _nanify(tree):
    """``tree`` (nested tuples / lists / dicts of tensors) with every
    floating tensor replaced by a NaN tensor of its shape, dtype and
    device; other leaves pass through."""
    import torch
    if isinstance(tree, torch.Tensor):
        return (torch.full_like(tree, float("nan"))
                if tree.is_floating_point() else tree)
    if isinstance(tree, dict):
        return {k: _nanify(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_nanify(v) for v in tree)
    return tree


def poison_batches(source, at_iters: Iterable[int]):
    """Rewrite ``source.batches()`` so the device batch at each 0-based
    iteration in ``at_iters`` has every float tensor replaced by NaN —
    the deterministic NaN-at-step-k injection driving the engine's
    non-finite guard.  Applies to sources whose batches are tensor
    tuples (every sampled source); a ``None`` batch (full-graph GD)
    passes through untouched.  Returns the source for chaining."""
    at = set(int(i) for i in at_iters)
    orig = source.batches

    def batches():
        for i, (batch, n_nodes) in enumerate(orig()):
            if i in at and batch is not None:
                batch = _nanify(batch)
            yield batch, n_nodes

    source.batches = batches
    return source


# ---------------------------------------------------------------------------
# Seeded schedules
# ---------------------------------------------------------------------------

class FaultSchedule:
    """Deterministic chooser of *which* events to break: a fixed fault
    seed yields a fixed schedule, so every chaos test run injects the
    identical fault sequence (the acceptance criterion's "deterministic
    under a fixed fault seed")."""

    def __init__(self, seed: int):
        self.seed = int(seed)
        self._rng = np.random.default_rng(self.seed)

    def pick(self, n: int, k: int) -> Set[int]:
        """``k`` distinct event indices out of ``range(n)``."""
        k = min(int(k), int(n))
        return set(int(i) for i in
                   self._rng.choice(int(n), size=k, replace=False))

    def consecutive(self, n: int, k: int) -> Set[int]:
        """A run of ``k`` consecutive indices inside ``range(n)`` —
        e.g. k consecutive NaN steps to trip rollback escalation."""
        k = min(int(k), int(n))
        start = int(self._rng.integers(0, int(n) - k + 1))
        return set(range(start, start + k))
