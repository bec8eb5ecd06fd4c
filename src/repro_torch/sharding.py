"""Sharding of the port: the reference's padding rules for the LM
parameter shapes and its logical axis names (``repro/sharding.py:17-48``)
and its NODES mesh
(``:119-210``), copied, since that module imports jax.

The NODES mesh is single-controller, as the reference's is: one process
drives every shard.  A ``NodeMesh`` is a tuple of torch devices in a
fixed shard order, and it may repeat a device: ``node_mesh(devices=
("cuda:0",) * 4)`` runs four shards one after another on one card, as
the reference's CPU tests run four shards on one host with
``--xla_force_host_platform_device_count=4``.  A NODES-sharded array is
one tensor whose rows split into ``S`` contiguous blocks of
``n_pad / S`` rows, block ``s`` owned by shard ``s`` (the layout jax
gives a row-sharded array).  The three collectives the reference's
sharded kernels use (``all_gather``, ``psum``, ``psum_scatter``) are
written over lists of per-shard tensors; each sums in shard order, so a
run repeats bit for bit.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# The reference's production tensor-parallel degree.  Head and vocab dims
# are padded against it so parameter shapes equal the reference's.
MODEL_PAR = 16

# The reference's logical axis names (``repro/sharding.py:17-19,47-48``).
# On one card nothing places a tensor by them; ``models.model.param_specs``
# and ``cache_specs`` return them as plain data, which the dry-run records.
BATCH = "batch"    # data-parallel axis (pod x data)
MODEL = "model"    # tensor-parallel axis
ALL = "all"        # every mesh axis (unshardable-batch decode caches)
FSDP = "fsdp"      # weight sharding over the data axis (ZeRO-3 style)


def pad_to(n: int, m: int = MODEL_PAR) -> int:
    return ((n + m - 1) // m) * m


def shard_heads(n: int) -> bool:
    """Shard a heads-like dim over ``model`` only when it stays
    divisible."""
    return n % MODEL_PAR == 0


def padded_heads(n: int) -> int:
    """Query heads are padded up to a MODEL_PAR multiple when big enough to
    shard (llama4: 40 -> 48); small head counts stay as they are."""
    if n % MODEL_PAR == 0 or n < MODEL_PAR:
        return n
    return pad_to(n)


# ---------------------------------------------------------------------------
# The NODES mesh
# ---------------------------------------------------------------------------

class NodeMesh:
    """A one-axis mesh of torch devices in a fixed shard order (shard
    ``s`` runs on ``devices[s]``); a device may appear more than once.
    Compared and hashed by identity: ``node_mesh`` memoizes, so every
    bind of a source gets the same object back."""

    def __init__(self, devices: Sequence):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("NodeMesh: needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"NodeMesh: devices must share one type, got "
                             f"{[str(d) for d in devs]}")
        self.devices: Tuple[torch.device, ...] = devs

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    def __repr__(self) -> str:
        return f"NodeMesh({[str(d) for d in self.devices]})"


@functools.lru_cache(maxsize=None)
def _node_mesh_cached(devices: Tuple[str, ...]) -> NodeMesh:
    return NodeMesh(devices)


def _canonical(d) -> str:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return str(d)


def node_mesh(n: Optional[int] = None,
              devices: Optional[Sequence] = None) -> NodeMesh:
    """The NODES mesh (reference ``node_mesh``): over the first ``n`` (all
    by default) visible CUDA devices, or over ``devices`` as given (a
    device may repeat: ``("cuda:0",) * 4`` is four shards on one card,
    ``("cpu",) * 4`` four on the host).  Memoized per device tuple, so
    repeated binds (every sweep point binds its source anew) get the
    same mesh object, and the caches keyed on it keep hitting."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError(
                "node_mesh(): no CUDA device is visible; pass devices= "
                "(e.g. ('cpu',) * 4) for a mesh on the host")
        count = count if n is None else n
        if not 1 <= count <= torch.cuda.device_count():
            raise ValueError(f"node_mesh: n={n} of "
                             f"{torch.cuda.device_count()} CUDA devices")
        devices = [f"cuda:{i}" for i in range(count)]
    elif n is not None and n != len(devices):
        raise ValueError(f"node_mesh: n={n} but {len(devices)} devices")
    return _node_mesh_cached(tuple(_canonical(d) for d in devices))


def nodes_shards(mesh: NodeMesh) -> int:
    """Number of shards along the NODES axis."""
    return mesh.size


def row_owner(n_pad: int, n_shards: int) -> np.ndarray:
    """``owner[i]``: the shard holding row ``i`` of an [n_pad, ...]
    NODES-row-sharded table over ``n_shards`` shards (contiguous blocks
    of ``n_pad / n_shards`` rows; the reference's ``row_owner`` takes
    the mesh, this its shard count)."""
    if n_pad % n_shards:
        raise ValueError(
            f"row_owner: n_pad={n_pad} rows must divide the {n_shards} "
            f"NODES shards (pad first)")
    return (np.arange(n_pad) // (n_pad // n_shards)).astype(np.int32)


def pad_rows(x, mult: int):
    """``x`` (tensor or numpy array) with zero rows appended up to a
    multiple of ``mult`` rows (reference ``ops._pad_to`` on axis 0);
    ``x`` itself when it already is one.  Zero-weight ELL rows
    aggregate to zero, so padded rows change no real row."""
    pad = (-x.shape[0]) % mult
    if not pad:
        return x
    if isinstance(x, np.ndarray):
        return np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))
    return F.pad(x, (0, 0) * (x.dim() - 1) + (0, pad))


def shard_rows(x: torch.Tensor, mesh: NodeMesh) -> List[torch.Tensor]:
    """The row blocks of ``x`` [S·m, ...], block ``s`` on ``devices[s]``
    (a view where the device is ``x``'s own)."""
    s = mesh.size
    if x.shape[0] % s:
        raise ValueError(f"shard_rows: {x.shape[0]} rows do not divide the "
                         f"{s} NODES shards")
    m = x.shape[0] // s
    return [x[i * m:(i + 1) * m].to(dev) for i, dev in enumerate(mesh.devices)]


def unshard_rows(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The row blocks concatenated in shard order on ``device``."""
    parts = [p.to(device) for p in parts]
    return parts[0] if len(parts) == 1 else torch.cat(parts, 0)


# ---------------------------------------------------------------------------
# Collectives over per-shard tensors
# ---------------------------------------------------------------------------

def _per_device(mesh: NodeMesh, make) -> List[torch.Tensor]:
    """``make(device)`` once per distinct device, one entry per shard:
    shards on one device share the (read-only) result."""
    made = {}
    out = []
    for dev in mesh.devices:
        key = str(dev)
        if key not in made:
            made[key] = make(dev)
        out.append(made[key])
    return out


def all_gather(parts: Sequence[torch.Tensor], mesh: NodeMesh
               ) -> List[torch.Tensor]:
    """Each shard gets every shard's part, concatenated along dim 0 in
    shard order (the reference's tiled ``all_gather``)."""
    _check_parts(parts, mesh, "all_gather")

    def make(dev):
        moved = [p.to(dev) for p in parts]
        return moved[0] if len(moved) == 1 else torch.cat(moved, 0)
    return _per_device(mesh, make)


def _shard_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of the parts in shard order, ((p0 + p1) + p2) + ..., in
    f32 and cast back to the parts' dtype once, on the first part's
    device."""
    if len(parts) == 1:
        return parts[0]
    dev, dt = parts[0].device, parts[0].dtype
    acc = parts[0].float()
    for p in parts[1:]:
        acc = acc + p.to(dev).float()
    return acc.to(dt)


def psum(parts: Sequence[torch.Tensor], mesh: NodeMesh
         ) -> List[torch.Tensor]:
    """Each shard gets the sum over shards (in shard order)."""
    _check_parts(parts, mesh, "psum")
    total = _shard_sum(parts)
    return _per_device(mesh, lambda dev: total.to(dev))


def psum_scatter(parts: Sequence[torch.Tensor], mesh: NodeMesh
                 ) -> List[torch.Tensor]:
    """The sum over shards (in shard order), split along dim 0 into S
    blocks: shard ``s`` gets block ``s`` (the reference's tiled
    ``psum_scatter``)."""
    _check_parts(parts, mesh, "psum_scatter")
    total = _shard_sum(parts)
    s = mesh.size
    if total.shape[0] % s:
        raise ValueError(f"psum_scatter: dim 0 of {tuple(total.shape)} "
                         f"does not split over {s} shards")
    m = total.shape[0] // s
    return [total[i * m:(i + 1) * m].to(dev)
            for i, dev in enumerate(mesh.devices)]


def _check_parts(parts, mesh: NodeMesh, what: str) -> None:
    if len(parts) != mesh.size:
        raise ValueError(f"{what}: {len(parts)} parts for a mesh of "
                         f"{mesh.size} shards")
