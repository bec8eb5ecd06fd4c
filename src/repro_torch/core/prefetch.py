"""Async mini-batch prefetch pipeline (DGL-dataloader style), supervised.

Copy of the reference ``repro.core.prefetch``; the one change is that
``HostStagingRing`` can hand out PINNED host buffers (torch page-locked
memory) so uploads to the card run as asynchronous copies.

The paper attributes the mini-batch paradigm's per-iteration overhead to
CPU-side sampling + feature loading (§5 throughput analysis).  Overlapping
that host work with the device step hides it almost entirely: a background
thread runs sample -> gather and double-buffers the results in a bounded
queue while the accelerator consumes the previous batch.

Batches are produced by ONE thread from ONE rng, in order, so a run with
`Prefetcher` consumes the identical batch sequence as the synchronous
sample-in-the-loop path with the same seed.

Fault tolerance (docs/training_api.md "Fault tolerance"):

- worker errors are CLASSIFIED: exception types in ``transient`` (by
  default ``faults.TransientSamplerFault`` plus ``MemoryError``) get the
  worker restarted with bounded exponential backoff — the rng is rewound
  to the snapshot taken before the failed draw, so the replacement
  worker REPLAYS the same batch and the consumed sequence is identical
  to a fault-free run (test-enforced).  Anything else is FATAL: stored
  and re-raised from ``next()``.
- ``next()`` after the end-of-stream sentinel (or a fatal error) has
  been consumed re-raises ``StopIteration`` / the stored error
  IMMEDIATELY instead of blocking forever on the drained queue.
- every delivered batch carries the rng state captured AFTER its draw
  (``last_rng_state``), and a Prefetcher can be constructed from such a
  state (``rng_state=``) — the exact-resume hook: a restored run's
  batch stream continues bit-for-bit where the checkpoint left off.
"""
from __future__ import annotations

import queue
import sys
import threading
import time
import traceback
import warnings
from typing import List, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from repro_torch.core import faults
from repro_torch.core.graph import Graph
from repro_torch.core.sampler import FanoutBatch, gather_features, sample_batch

#: worker exceptions restarted-with-backoff instead of surfaced
DEFAULT_TRANSIENT: Tuple[Type[BaseException], ...] = (
    faults.TransientSamplerFault, MemoryError)


class HostStagingRing:
    """Reusable host-side staging buffers for device uploads.

    Batch/chunk shapes are constant across iterations, so the host
    arrays feeding the device upload are allocated ONCE per shape and
    recycled instead of freshly allocated every batch.

    ``acquire()`` hands out a free slot; ``buffers(slot, specs)`` returns
    the slot's once-allocated numpy buffers for producers to FILL in
    place; ``tensors(slot)`` returns the same memory as torch tensors
    (the upload source); ``release(slot)`` makes the slot reusable.  With
    ``pin_memory=True`` the buffers are page-locked, so
    ``tensor.to("cuda", non_blocking=True)`` is a true asynchronous DMA
    — and the slot must then stay unreleased until that copy has
    COMPLETED (a CUDA event), not merely been enqueued, or the producer
    overwrites memory the DMA is still reading.  Slot handout is a
    blocking queue, so a producer that runs ahead of ``release``
    backpressures instead of overwriting in-flight data.  Thread-safe:
    acquire/release may run on different threads; ``close()`` wakes any
    blocked ``acquire``.
    """

    def __init__(self, n_slots: int, pin_memory: bool = False):
        if n_slots < 1:
            raise ValueError(f"HostStagingRing: n_slots must be >= 1, "
                             f"got {n_slots}")
        self.pin_memory = bool(pin_memory)
        self._free: "queue.Queue[int]" = queue.Queue()
        for i in range(n_slots):
            self._free.put(i)
        self._bufs = {}          # slot -> list of torch staging tensors
        self._closed = False

    def acquire(self) -> int:
        while True:
            try:
                return self._free.get(timeout=0.1)
            except queue.Empty:
                if self._closed:
                    raise RuntimeError("HostStagingRing closed")

    def buffers(self, slot: int, specs) -> List[np.ndarray]:
        """The slot's buffers for ``specs`` = [(shape, dtype), ...] as
        numpy views — allocated on first use, reused verbatim while specs
        match."""
        bufs = self._bufs.get(slot)
        if bufs is None or len(bufs) != len(specs) or any(
                tuple(b.shape) != tuple(s)
                or b.numpy().dtype != np.dtype(d)
                for b, (s, d) in zip(bufs, specs)):
            bufs = [torch.from_numpy(np.empty(s, d)) for s, d in specs]
            if self.pin_memory:
                bufs = [b.pin_memory() for b in bufs]
            self._bufs[slot] = bufs
        return [b.numpy() for b in bufs]

    def tensors(self, slot: int) -> List[torch.Tensor]:
        """The slot's buffers as torch tensors (same memory as
        ``buffers``), pinned when the ring is."""
        return list(self._bufs[slot])

    def close(self) -> None:
        self._closed = True

    def release(self, slot: int) -> None:
        self._free.put(slot)


class Prefetcher:
    """Supervised double-buffered background sampler + feature gather.

    Yields (FanoutBatch, payload) tuples, where payload is the gathered
    hop features by default; `payload_fn(graph, fb)` overrides the
    per-batch host work so callers can move feature gather + staging
    onto this background thread (see `engine.SampledSource`).
    `sample_fn(rng, graph, batch_size, fanouts)` overrides how batches
    are drawn (same signature as `sample_batch`, the default) so
    scenario sources — cluster unions, importance-weighted targets —
    keep the one-thread/one-rng ordering guarantee.  `depth` is the
    queue bound (2 = classic double buffering: one batch in flight on
    the host while the device consumes the other).

    `max_restarts` bounds how many transient worker deaths are absorbed
    (each restart replays the failed batch from the pre-draw rng
    snapshot after an exponential-backoff pause of
    ``backoff * 2**attempt``, capped at ``backoff_cap`` seconds);
    `transient` is the tuple of exception types classified transient.
    `rng_state` (a ``numpy`` bit-generator state dict, as exposed by
    `last_rng_state`) resumes the batch stream mid-sequence.
    """

    _SENTINEL = object()

    def __init__(self, graph: Graph, batch_size: int,
                 fanouts: Sequence[int], seed: int = 0, depth: int = 2,
                 n_batches: Optional[int] = None,
                 payload_fn=None, sample_fn=None,
                 max_restarts: int = 3,
                 backoff: float = 0.05, backoff_cap: float = 2.0,
                 transient: Tuple[Type[BaseException], ...]
                 = DEFAULT_TRANSIENT,
                 rng_state: Optional[dict] = None):
        self.graph = graph
        self.batch_size = batch_size
        self.fanouts = tuple(fanouts)
        self.n_batches = n_batches
        self.payload_fn = payload_fn or gather_features
        self.sample_fn = sample_fn or sample_batch
        self.max_restarts = max_restarts
        self.backoff = backoff
        self.backoff_cap = backoff_cap
        self.transient = tuple(transient)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._rng = np.random.default_rng(seed)
        if rng_state is not None:
            self._rng.bit_generator.state = rng_state
        #: rng state after the draw of the most recently DELIVERED batch
        #: (feed back in as ``rng_state=`` to resume the sequence there)
        self.last_rng_state: Optional[dict] = rng_state
        #: completed transient restarts so far
        self.restarts = 0
        self._produced = 0               # survives worker restarts
        self._finished = False           # end-of-stream sentinel consumed
        self._pre_draw_state: Optional[dict] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    def _produce_loop(self):
        while not self._stop.is_set():
            if self.n_batches is not None \
                    and self._produced >= self.n_batches:
                return
            # snapshot BEFORE the draw: a transient failure anywhere in
            # sample/payload rewinds here, so the restarted worker
            # replays this very batch and ordering is preserved
            self._pre_draw_state = self._rng.bit_generator.state
            fb = self.sample_fn(self._rng, self.graph,
                                self.batch_size, self.fanouts)
            payload = self.payload_fn(self.graph, fb)
            post_state = self._rng.bit_generator.state
            # blocking put with timeout so close() can interrupt
            while not self._stop.is_set():
                try:
                    self._q.put((fb, payload, post_state), timeout=0.1)
                    break
                except queue.Full:
                    continue
            else:
                return
            self._produced += 1

    def _worker(self):
        try:
            self._produce_loop()
        except self.transient as e:
            if self.restarts < self.max_restarts \
                    and not self._stop.is_set():
                self.restarts += 1
                delay = min(self.backoff * (2 ** (self.restarts - 1)),
                            self.backoff_cap)
                warnings.warn(
                    f"Prefetcher worker hit transient "
                    f"{type(e).__name__}: {e} — restart "
                    f"{self.restarts}/{self.max_restarts} in "
                    f"{delay:.2f}s (batch {self._produced} will be "
                    f"replayed)", RuntimeWarning, stacklevel=2)
                if self._stop.wait(delay):      # closed during backoff
                    self._put_sentinel()
                    return
                if self._pre_draw_state is not None:
                    self._rng.bit_generator.state = self._pre_draw_state
                t = threading.Thread(target=self._worker, daemon=True)
                self._thread = t
                t.start()
                return                           # old thread retires
            # restart budget exhausted: escalate to fatal
            self._err = e
            self._put_sentinel()
        except BaseException as e:               # fatal: surfaced on next()
            self._err = e
            self._put_sentinel()
        else:
            self._put_sentinel()

    def _put_sentinel(self):
        while True:
            try:
                self._q.put(self._SENTINEL, timeout=0.1)
                break
            except queue.Full:
                if self._stop.is_set():
                    break

    # ------------------------------------------------------------------
    def next(self) -> Tuple[FanoutBatch, List[np.ndarray]]:
        if self._finished:
            # post-sentinel calls re-raise IMMEDIATELY (the stored fatal
            # error, or StopIteration) instead of blocking forever on
            # the drained queue
            if self._err is not None:
                raise self._err
            raise StopIteration
        item = self._q.get()
        if item is self._SENTINEL:
            self._finished = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        fb, payload, post_state = item
        self.last_rng_state = post_state
        return fb, payload

    def __iter__(self):
        while True:
            try:
                yield self.next()
            except StopIteration:
                return

    def close(self, timeout: float = 5.0):
        self._stop.set()
        # drain so a blocked put wakes up
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            # don't return silently leaking a live thread: surface WHERE
            # the worker is stuck (it is a daemon, so it cannot block
            # interpreter exit, but a wedged sample_fn/payload_fn would
            # otherwise go unnoticed until batches stop arriving)
            frame = sys._current_frames().get(self._thread.ident)
            where = ("".join(traceback.format_stack(frame))
                     if frame is not None else "<no stack available>")
            warnings.warn(
                f"Prefetcher worker did not exit within {timeout:.1f}s of "
                f"close(); the thread is stuck in:\n{where}",
                RuntimeWarning, stacklevel=2)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
