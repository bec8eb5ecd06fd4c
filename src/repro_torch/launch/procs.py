"""Starting the ranks of a process-group NODES mesh: one process a
shard, each holding only its own rows (the reference's row layout, which
its single controller lays over the devices of a mesh), the collectives
on a ``torch.distributed`` process group.

``init`` starts a rank's process group, from ``torchrun``'s environment
(``python -m torch.distributed.run``, which ships with PyTorch) or from
an explicit ``(rank, world, init_method)``, and returns its
``Transport``; ``sharding.process_node_mesh(transport)`` is the mesh the
sharded sources bind to.  The transport follows from the layout, and
nothing switches it afterwards:

- ``nccl``: each rank has a card of its own (``device="cuda"``: local
  rank ``i`` on ``cuda:<i>``).  A failed NCCL init raises
  (the communicator is made at ``init``, not at the first collective).
- ``gloo``: the ranks run on the CPU (``device="cpu"``).
- ``host``: several ranks of one host share one card (``device=
  "cuda:<i>"`` with more than one local rank).  NCCL refuses two ranks on
  one card and gloo has no CUDA ``all_gather`` or ``reduce_scatter``, so
  each collective copies the CUDA part to pinned host memory, runs the
  gloo collective there and copies the result back.  It exists to check
  the layout on one card: its times are not a multi-card layout's.

Each collective of the three (``all_gather``, ``all_reduce``,
``reduce_scatter``) runs over the world or over a subgroup
(``new_group``: every rank makes every subgroup, in one order), sizes
its result by that group and sums in f32, rounding once to the part's
dtype: nccl in its own order, gloo (and so the host transport) in rank
order, the single-controller mesh's.  ``barrier`` is the world's.
Every process group has a ``timeout``: a rank stuck in a collective
fails instead of hanging.  ``spawn`` runs a
function in ``world`` fresh processes (the tests' and
``chip_smoke.py``'s launcher) and ends the others when one raises.
"""
from __future__ import annotations

import datetime
import os
import queue
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

#: seconds a collective may wait for the other ranks before it raises
TIMEOUT_S = 120.0
#: the transports (``Transport.name``)
TRANSPORTS = ("nccl", "gloo", "host")
#: process groups of the same ranks a gloo collective's spans go over at
#: once (its lanes), and the bytes below which a span is not split off
GLOO_LANES = 4
LANE_MIN_BYTES = 1 << 20

# torch >= 2.13 renamed the two fused collectives; older ones have only
# the first names
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


class Transport:
    """The collectives of one rank's process group: ``rank`` of ``world``
    on ``device``.  Each collective runs over ``group`` (what
    ``new_group`` returns; the world when None).  ``nccl`` hands the
    parts to its own collectives, which sum in its order; ``gloo`` moves
    them and sums here, in group rank order ((p0 + p1) + p2 ..., in f32,
    as the single-controller mesh sums its shards), so a process mesh
    over it gives the single controller's bits.

    A group is a tuple of process groups of the same ranks, its lanes:
    one for nccl, ``GLOO_LANES`` for gloo, which moves a collective over
    one TCP stream a peer at a time; a large part splits into one span a
    lane, all in flight together."""

    def __init__(self, name: str, rank: int, world: int, device,
                 timeout_s: float = TIMEOUT_S):
        if name not in TRANSPORTS:
            raise ValueError(f"transport must be one of {TRANSPORTS}, got "
                             f"{name!r}")
        self.name, self.rank, self.world = name, int(rank), int(world)
        self.device = torch.device(device)
        self.timeout = datetime.timedelta(seconds=timeout_s)
        self.lanes = 1 if name == "nccl" or world == 1 else GLOO_LANES
        # the world's lanes: the default group and its copies
        self._world = (None,) + tuple(
            dist.new_group(ranks=list(range(world)), timeout=self.timeout)
            for _ in range(self.lanes - 1))

    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        """The part as the backend takes it."""
        return t.contiguous()

    def _unstage(self, t: torch.Tensor) -> torch.Tensor:
        """A result back on the rank's device."""
        return t

    def _empty(self, shape, like: torch.Tensor) -> torch.Tensor:
        """A buffer for a result beside the staged part ``like``."""
        return like.new_empty(shape)

    def _rank_sum(self, parts: torch.Tensor, out=None) -> torch.Tensor:
        """``parts`` [n, ...] summed over dim 0 in order, ((p0 + p1) +
        p2) + ..., into ``out`` (a new buffer when None)."""
        acc = self._empty(parts.shape[1:], parts) if out is None else out
        acc.copy_(parts[0])
        for p in parts[1:]:
            acc += p
        return acc

    def new_group(self, ranks: Sequence[int]) -> tuple:
        """A group of ``ranks`` (global ranks, ascending: group rank ``i``
        is ``ranks[i]``): its lanes, process groups on the world's
        backend with its timeout.  Every rank must call it, in the same
        order, for every group, its own or not."""
        return tuple(dist.new_group(ranks=list(ranks), timeout=self.timeout)
                     for _ in range(self.lanes))

    def _lanes(self, group) -> tuple:
        return self._world if group is None else group

    def size(self, group=None) -> int:
        """The ranks of ``group`` (the world when None)."""
        pg = self._lanes(group)[0]
        return self.world if pg is None else dist.get_world_size(pg)

    def _spans(self, group, n: int, nbytes: int) -> list:
        """(lane, start, end): ``n`` elements of a collective moving
        ``nbytes`` a rank, one span a lane (no span of less than
        ``LANE_MIN_BYTES``)."""
        lanes = self._lanes(group)
        k = max(1, min(len(lanes), n, nbytes // LANE_MIN_BYTES))
        edges = [n * i // k for i in range(k + 1)]
        return list(zip(lanes, edges[:-1], edges[1:]))

    @staticmethod
    def _wait(works) -> None:
        for w in works:
            w.wait()

    def _gather(self, x: torch.Tensor, group) -> torch.Tensor:
        """Every rank's ``x`` (contiguous), stacked [n, *x.shape] in group
        rank order."""
        n = self.size(group)
        out = self._empty((n,) + tuple(x.shape), x)
        spans = self._spans(group, x.numel(), out.numel() * x.element_size())
        src, dst = x.view(-1), out.view(n, -1)
        if len(spans) == 1:
            _all_gather(out.view(-1), src, group=spans[0][0])
        else:
            self._wait([dist.all_gather([dst[r, a:b] for r in range(n)],
                                        src[a:b], group=pg, async_op=True)
                        for pg, a, b in spans])
        return out

    def _scatter_sum(self, x: torch.Tensor, group) -> torch.Tensor:
        """``x`` [n, L], row ``r`` for group rank ``r``: the rank-order sum
        of the rows the group's ranks sent this rank [L] (an all-to-all;
        gloo has only its one-tensor form, so a lane's span of each row
        goes through a buffer of its own)."""
        spans = self._spans(group, x.shape[1], x.numel() * x.element_size())
        if len(spans) == 1:
            got = self._empty(x.shape, x)
            dist.all_to_all_single(got, x, group=spans[0][0])
            return self._rank_sum(got)
        out, sent = self._empty(x.shape[1:], x), []
        for pg, a, b in spans:
            src = self._empty((x.shape[0], b - a), x)
            src.copy_(x[:, a:b])
            got = self._empty(src.shape, x)
            sent.append((a, b, got, src, dist.all_to_all_single(
                got, src, group=pg, async_op=True)))
        for a, b, got, _, work in sent:
            work.wait()
            self._rank_sum(got, out[a:b])
        return out

    def all_gather(self, t: torch.Tensor, dim: int = 0, group=None
                   ) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in group rank
        order."""
        x = self._stage(t.movedim(dim, 0))
        out = self._gather(x, group).view((-1,) + tuple(x.shape[1:]))
        return self._unstage(out).movedim(0, dim).contiguous()

    def all_reduce(self, t: torch.Tensor, group=None) -> torch.Tensor:
        """The sum over ranks of ``t``, in f32, rounded once."""
        x = self._stage(t.to(torch.float32, copy=True))
        if self.name == "nccl":
            dist.all_reduce(x, group=self._lanes(group)[0])
        else:
            x = self._rank_sum(self._gather(x, group))
        return self._unstage(x).to(t.dtype)

    def reduce_scatter(self, t: torch.Tensor, dim: int = 0, group=None
                       ) -> torch.Tensor:
        """Block (group rank) along ``dim`` of the sum over ranks of
        ``t``, in f32, rounded once."""
        n = self.size(group)
        if t.shape[dim] % n:
            raise ValueError(f"reduce_scatter: dim {dim} of "
                             f"{tuple(t.shape)} does not split over "
                             f"{n} ranks")
        x = self._stage(t.movedim(dim, 0).to(torch.float32))
        shape = (x.shape[0] // n,) + tuple(x.shape[1:])
        if self.name == "nccl":
            out = x.new_empty(shape)
            _reduce_scatter(out, x, group=self._lanes(group)[0])
        else:
            out = self._scatter_sum(x.view(n, -1), group).view(shape)
        return self._unstage(out).to(t.dtype).movedim(0, dim).contiguous()

    def barrier(self) -> None:
        if self.name == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def __repr__(self) -> str:
        return (f"Transport({self.name}, rank {self.rank} of {self.world} "
                f"on {self.device})")


class HostStagedTransport(Transport):
    """The ``host`` transport: gloo over pinned host copies of the CUDA
    parts of ranks that share a card."""

    def __init__(self, rank: int, world: int, device,
                 timeout_s: float = TIMEOUT_S):
        super().__init__("host", rank, world, device, timeout_s)

    def _stage(self, t):
        h = self._empty(t.shape, t)
        h.copy_(t)
        return h

    def _empty(self, shape, like):
        # pinned: the copies to and from the card are DMA, no host copy
        return torch.empty(shape, dtype=like.dtype, pin_memory=True)

    def _unstage(self, t):
        return t.to(self.device)


def layout(device, local_rank: int, local_world: int) -> tuple:
    """``(transport name, the rank's device)`` for a rank asking for
    ``device``: ``cpu`` -> gloo; ``cuda`` -> nccl on ``cuda:<local_rank>``
    (raises when the host has fewer cards than ranks); ``cuda:<i>`` ->
    that card, nccl for one local rank and the host-staged transport when
    several share it."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "gloo", dev
    if dev.type != "cuda":
        raise ValueError(f"procs.layout: device {dev} is neither cpu nor "
                         f"cuda")
    if not torch.cuda.is_available():
        raise RuntimeError(f"procs.layout: device {str(dev)!r} requested "
                           f"but torch.cuda.is_available() is False; pass "
                           f"device='cpu' to run the ranks on the CPU")
    count = torch.cuda.device_count()
    if dev.index is None:
        if local_world > count:
            raise RuntimeError(
                f"procs.layout: {local_world} ranks on this host but "
                f"{count} cards: one card a rank needs as many cards; name "
                f"one card (cuda:0) to run every rank on it")
        return "nccl", torch.device("cuda", local_rank)
    if dev.index >= count:
        raise RuntimeError(f"procs.layout: {dev} of {count} cards")
    return ("nccl" if local_world == 1 else "host"), dev


def init(rank: Optional[int] = None, world: Optional[int] = None,
         init_method: Optional[str] = None, *, device="cuda",
         timeout_s: float = TIMEOUT_S) -> Transport:
    """Start this rank's process group and return its transport.  With
    ``rank`` / ``world`` / ``init_method`` None, they (and the local rank
    and local world size) come from ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``env://``);
    otherwise every rank is on this host.  ``device`` picks the layout
    (``layout``).  A failed init raises."""
    env = os.environ
    if rank is None:
        if "WORLD_SIZE" not in env:
            raise RuntimeError("procs.init: no rank given and no torchrun "
                               "environment (WORLD_SIZE) to read one from")
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        local_rank = int(env.get("LOCAL_RANK", rank))
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
        init_method = init_method or "env://"
    elif world is None or init_method is None:
        raise ValueError("procs.init: give rank, world and init_method "
                         "together")
    else:
        local_rank, local_world = rank, world
    name, dev = layout(device, local_rank, local_world)
    kw = dict(init_method=init_method, rank=rank, world_size=world,
              timeout=datetime.timedelta(seconds=timeout_s))
    if name == "nccl":
        torch.cuda.set_device(dev)
        # device_id makes the communicator now: a failed init raises here
        dist.init_process_group("nccl", device_id=dev, **kw)
        return Transport("nccl", rank, world, dev, timeout_s)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", **kw)
    if name == "host":
        return HostStagedTransport(rank, world, dev, timeout_s)
    return Transport("gloo", rank, world, dev, timeout_s)


def close() -> None:
    """End this rank's process group (a no-op when there is none)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def rank_zero() -> bool:
    """True unless this process is a rank above 0 of a process group."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def in_torchrun() -> bool:
    """True when ``torchrun`` started this process."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


class RankError(RuntimeError):
    """A rank of ``spawn`` raised (or died): ``rank`` and its traceback."""

    def __init__(self, rank: int, text: str):
        super().__init__(f"rank {rank} failed:\n{text}")
        self.rank = rank


def _rank_main(fn, rank, world, init_method, args, results) -> None:
    try:
        out = fn(rank, world, init_method, *args)
    except BaseException as e:              # noqa: BLE001 - sent on
        results.put((rank, False, f"{type(e).__name__}: {e}\n"
                                  f"{traceback.format_exc()}"))
        close()
        sys.exit(1)
    results.put((rank, True, out))
    close()


def _end(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)


def spawn(fn: Callable, world: int, args: Sequence[Any] = (), *,
          init_dir: str, timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(rank, world, init_method, *args)`` in ``world`` fresh
    processes (start method ``spawn``: ``fn`` and ``args`` must pickle,
    ``fn`` by its module's name) and return their results in rank order.
    ``init_method`` is a new ``file://`` path under ``init_dir`` (an
    existing directory of the caller's) for ``init``.  The first rank that raises, or
    dies, ends the others and raises ``RankError`` here with its
    traceback; a run past ``timeout_s`` ends them all and raises
    ``TimeoutError``.  Every process it starts has ended when it
    returns."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    path = tempfile.mktemp(prefix="pg_", dir=init_dir)
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, f"file://{path}", tuple(args),
                               results))
             for r in range(world)]
    out: dict = {}
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            try:
                rank, ok, val = results.get(timeout=0.2)
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r not in out and p.exitcode not in (None, 0):
                        # give a message on its way a moment to land
                        try:
                            rank, ok, val = results.get(timeout=2.0)
                            break
                        except queue.Empty:
                            raise RankError(r, f"died with exit code "
                                               f"{p.exitcode}") from None
                else:
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"spawn: {world - len(out)} of {world} ranks "
                            f"still running after {timeout_s} s")
                    continue
            if not ok:
                raise RankError(rank, val)
            out[rank] = val
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        _end(procs)
        results.close()
    return [out[r] for r in range(world)]
