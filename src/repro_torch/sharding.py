"""Sharding of the port: the reference's padding rules for the LM
parameter shapes, its logical axis names and their resolution onto a
mesh (``repro/sharding.py:17-66, :109-110``) and its NODES mesh
(``:119-210``), copied, since that module imports jax, over one
named-axis ``Mesh``.

A ``Mesh`` has named axes, ``("data", "model")`` or ``("pod", "data",
"model")``, over torch devices in row-major order, and it is
single-controller, as the reference's is: one process drives every
shard.  A device may repeat: ``("cuda:0",) * 2`` is two model shards on
one card, ``("cpu",) * 4`` four on the host, as the reference's CPU
tests run four shards on one host with
``--xla_force_host_platform_device_count=4``.  A tensor sharded over it
is a list of parts, one per shard (``shard`` / ``unshard`` by a logical
spec), and per-shard programs meet in three collectives over a
``Group``, the shards of one or more axes (``Mesh.group``).  A mesh
that repeats a device emulates the layout's arithmetic and its
collectives on that device, one shard after another: it does not model
the layout's speed.  A process-group mesh (``process_mesh``, and the
``NodeMesh`` of ``process_node_mesh``) is PyTorch's idiom for the same
layout: one process a shard, each holding only its own shard and rows
and running its shard alone (``traced`` is its rank), the collectives
going through ``torch.distributed`` on a ``launch.procs`` transport,
each ``Group`` on a process group of its own ranks (made when the mesh
is, by every rank, for every group of every axis set).
``layout_mesh`` is the dry-run's: a production
layout (256 or 512 cards) of which only shard 0 is run, on meta
tensors, so a trace holds one device's tensors and work; its
collectives give shard 0 the shapes of their results and note their
bytes.

A ``NodeMesh`` (``node_mesh``) is the one-axis case: a ``Mesh`` of shape
``(S, 1)`` whose ``data`` axis carries NODES.  A NODES-sharded array is
one tensor whose rows split into ``S`` contiguous blocks of
``n_pad / S`` rows, block ``s`` owned by shard ``s`` (the layout jax
gives a row-sharded array).  Its groups share results: the shards of
one device get one read-only copy of a collective's result (four NODES
shards on one card would otherwise hold four copies of every gathered
table), and gradients flow through the collectives' plain ops.

The collectives (``all_gather``, ``psum``, ``psum_scatter``) are written
once, over lists of per-shard tensors; each sums in f32 in shard order
and rounds once, so a run repeats bit for bit.  Each call notes its wire
bytes a device under the reference's ring model
(``repro/launch/roofline.py:52-61``: all-reduce 2 x the operand,
reduce-scatter 1 x the operand, all-gather 1 x the output) to every
active ``launch.roofline.TraceCounter`` and to ``collective_counts()``.
Where results are not shared they are autograd functions whose backward
is the adjoint collective (all-gather <-> reduce-scatter, all-reduce <->
all-reduce), noted in the same way.  Over a process group the parts are
cast to f32, summed (over gloo in shard order, as here; over nccl in
its own order) and cast back once; one shard returns its part as it
is.
"""
from __future__ import annotations

import collections
import functools
import math
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_flatten, tree_unflatten

# The reference's production tensor-parallel degree.  Head and vocab dims
# are padded against it so parameter shapes equal the reference's.
MODEL_PAR = 16

# The reference's logical axis names (``repro/sharding.py:17-19,47-48``).
# ``models.model.param_specs`` and ``cache_specs`` give them per dim;
# ``resolve`` maps them onto a ``Mesh``'s axes and ``shard`` splits a
# tensor by them.
BATCH = "batch"    # data-parallel axis (pod x data)
MODEL = "model"    # tensor-parallel axis
NODES = "nodes"    # GNN node-parallel axis (alias of the batch axes)
ALL = "all"        # every mesh axis (unshardable-batch decode caches)
FSDP = "fsdp"      # weight sharding over the data axis (ZeRO-3 style);
#                    not over "pod": cross-pod traffic stays gradient-only


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
# Named-axis meshes (reference ``repro/sharding.py:50-66, :109-110``)
# ---------------------------------------------------------------------------

MESH_AXES = ("pod", "data", "model")


def axis_map(mesh) -> dict:
    """The mesh axes each logical name resolves onto: the batch (and
    NODES) over ``("pod", "data")`` on a multi-pod mesh, ``"data"``
    otherwise; ``FSDP`` over ``"data"`` only."""
    if "pod" in mesh.axis_names:
        batch_axes: Any = ("pod", "data")
        all_axes: Any = ("pod", "data", "model")
    else:
        batch_axes = "data"
        all_axes = ("data", "model")
    return {BATCH: batch_axes, NODES: batch_axes, MODEL: "model",
            ALL: all_axes, FSDP: "data"}


def resolve(logical: Sequence[Optional[str]], mesh) -> tuple:
    """A logical spec as mesh axes, one entry a dim: an axis name, a
    tuple of them, or None (the reference's ``PartitionSpec``)."""
    m = axis_map(mesh)
    return tuple(m.get(ax) if ax is not None else None for ax in logical)


def batch_mesh_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else "data"


def _axes(ax) -> Tuple[str, ...]:
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


class Mesh:
    """Named axes over torch devices (the reference's jax ``Mesh``).

    ``shape`` and ``axis_names`` as the reference's (``("data",
    "model")`` or ``("pod", "data", "model")``); shard ``f`` (row-major
    over ``shape``) runs on ``devices[f]``, and a device may repeat.
    ``layout=True`` makes the dry-run's mesh: ``devices`` is one meta
    device and only shard 0 is run (``traced``); collectives give it
    their results' shapes (``layout_mesh``).  Compared and hashed by
    identity."""

    #: whether the shards of one device share a collective's result
    #: (``NodeMesh``) or each get their own with autograd adjoints
    shares_results = False

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Sequence, *, layout: bool = False,
                 transport=None):
        shape = tuple(int(n) for n in shape)
        names = tuple(axis_names)
        if len(shape) != len(names) or len(set(names)) != len(names) \
                or not set(names) <= set(MESH_AXES) or "model" not in names:
            raise ValueError(f"Mesh: axes {names} of shape {shape}; want "
                             f"('data', 'model') or ('pod', 'data', "
                             f"'model')")
        if min(shape) < 1:
            raise ValueError(f"Mesh: shape {shape}")
        devs = tuple(torch.device(d) for d in devices)
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"Mesh: devices must share one type, got "
                             f"{[str(d) for d in devs]}")
        n = math.prod(shape)
        if layout:
            if len(devs) != 1 or devs[0].type != "meta":
                raise ValueError("a layout mesh runs shard 0 alone, on one "
                                 "meta device")
            self.traced: Tuple[int, ...] = (0,)
        elif transport is not None:
            if len(devs) != 1 or transport.world != n:
                raise ValueError(f"a process-group mesh runs one shard a "
                                 f"process: one device and {n} ranks, got "
                                 f"{len(devs)} devices and "
                                 f"{transport.world} ranks")
            self.traced = (int(transport.rank),)
        else:
            if len(devs) != n:
                raise ValueError(f"Mesh: {len(devs)} devices for a "
                                 f"{' x '.join(map(str, shape))} mesh")
            self.traced = tuple(range(n))
        self.shape, self.axis_names, self.devices = shape, names, devs
        self.layout = layout
        #: the ``launch.procs`` transport of a process-group mesh, else None
        self.transport = transport
        self.sizes: Dict[str, int] = dict(zip(names, shape))
        self._groups: Dict[Tuple[Tuple[str, ...], int], "Group"] = {}
        #: a process-group mesh's subgroups by their ranks (``_make_pgs``)
        self._pgs: Dict[Tuple[int, ...], Any] = {}
        if transport is not None:
            self._make_pgs()

    @property
    def size(self) -> int:
        """The number of shards (devices of the layout)."""
        return math.prod(self.shape)

    @property
    def rank_local(self) -> bool:
        """True for a process-group mesh: this process runs one shard and
        holds only that shard's rows."""
        return self.transport is not None

    def _full(self, axes: Tuple[str, ...], flat: int) -> List[int]:
        """The flat shards of the group along ``axes`` (in mesh order)
        through shard ``flat``, in group order (ascending)."""
        c = self.coords(flat)
        full = []
        for pos in range(math.prod(self.sizes[a] for a in axes)):
            cc = dict(c)
            cc.update(zip(axes, (int(x) for x in np.unravel_index(
                pos, tuple(self.sizes[a] for a in axes)))))
            full.append(int(np.ravel_multi_index(
                tuple(cc[a] for a in self.axis_names), self.shape)))
        return full

    def pg_plan(self) -> List[Tuple[int, ...]]:
        """The process groups a process-group mesh makes, in the order
        every rank makes them: for each nonempty set of the mesh's axes
        (in mesh order, fewest axes first: whatever the model code runs
        a collective over, ``model``, ``data``, the batch axes, the axes
        a parameter is replicated on, every axis), its groups in order
        of their first shard; a group of one rank, of every rank (the
        world's own) or already made is left out."""
        names = self.axis_names
        masks = sorted(range(1, 2 ** len(names)),
                       key=lambda m: (bin(m).count("1"), m))
        plan: List[Tuple[int, ...]] = []
        for axes in (tuple(a for i, a in enumerate(names) if m >> i & 1)
                     for m in masks):
            for flat in range(self.size):
                ranks = tuple(self._full(axes, flat))
                if 1 < len(ranks) < self.size and ranks not in plan:
                    plan.append(ranks)
        return plan

    def _make_pgs(self) -> None:
        """Every rank makes every group of ``pg_plan``, in its order,
        after the ranks agree on that plan (a rank that would make them
        otherwise fails here, at once, instead of leaving the others in
        a ``new_group`` until the timeout)."""
        tr, plan = self.transport, self.pg_plan()
        if not plan:
            return
        digest = zlib.crc32(repr((self.shape, plan)).encode())
        mine = torch.tensor([digest], dtype=torch.int64, device=tr.device)
        got = [int(x) for x in tr.all_gather(mine).cpu()]
        if len(set(got)) != 1:
            raise RuntimeError(f"{self}: the ranks' process-group plans "
                               f"differ (digests by rank {got}): every "
                               f"rank must make the same groups in the "
                               f"same order")
        for ranks in plan:
            self._pgs[ranks] = tr.new_group(ranks)

    def coords(self, flat: int) -> Dict[str, int]:
        return dict(zip(self.axis_names,
                        (int(c) for c in np.unravel_index(flat, self.shape))))

    def device_of(self, flat: int) -> torch.device:
        return self.devices[self.traced.index(flat)]

    def group(self, axes, flat: int) -> "Group":
        """The shards along ``axes`` (a name or a tuple of names) through
        shard ``flat``: the other coordinates fixed, ``axes`` row-major
        in mesh order.  Made once a mesh (a step asks for its groups
        every call)."""
        key = (_axes(axes), flat)
        if key not in self._groups:
            self._groups[key] = self._group(*key)
        return self._groups[key]

    def _group(self, want: Tuple[str, ...], flat: int) -> "Group":
        axes = tuple(a for a in self.axis_names if a in want)
        if len(axes) != len(want):
            raise ValueError(f"Mesh.group: {want} not all in "
                             f"{self.axis_names}")
        full = self._full(axes, flat)
        members = tuple(f for f in full if f in self.traced)
        return Group(self, axes, len(full), members,
                     tuple(full.index(f) for f in members),
                     self._pgs.get(tuple(full)))

    def groups(self, axes) -> List["Group"]:
        """The distinct groups along ``axes`` that hold a traced shard,
        in order of their first traced shard."""
        out, seen = [], set()
        for f in self.traced:
            g = self.group(axes, f)
            if g.members not in seen:
                seen.add(g.members)
                out.append(g)
        return out

    def __repr__(self) -> str:
        kind = "layout" if self.layout else str(self.devices[0])
        return (f"Mesh({dict(zip(self.axis_names, self.shape))}, "
                f"{kind}{'' if self.layout else ' x ' + str(self.size)})")


class Group:
    """The shards of one or more axes of a ``Mesh`` with the others
    fixed: ``size`` shards, of which ``members`` (flat shard ids, in
    group order, at ``positions``) are run here, on ``devices``.
    ``share``: the mesh's ``shares_results``; ``pg``: the subgroup its
    collectives run on (``Mesh.pg_plan``)."""

    def __init__(self, mesh: Mesh, axes: Tuple[str, ...], size: int,
                 members: Tuple[int, ...], positions: Tuple[int, ...],
                 pg=None):
        self.mesh, self.axes, self.size = mesh, axes, size
        self.members, self.positions = members, positions
        self.devices = tuple(mesh.device_of(f) for f in members)
        self.share = mesh.shares_results
        self.transport = mesh.transport
        #: its ``torch.distributed`` process group on a process-group mesh
        #: (None: the world's, or no process group)
        self.pg = pg

    @property
    def virtual(self) -> bool:
        """True when only part of the group is run and the rest is not run
        anywhere (a layout mesh; a process-group mesh's other shards run
        in the other ranks)."""
        return len(self.members) < self.size and self.transport is None

    def __repr__(self) -> str:
        return f"Group({self.axes}, size {self.size}, run {self.members})"


def layout_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """A production layout of which only shard 0 runs, on meta tensors
    (the dry-run's)."""
    return Mesh(shape, axis_names, ("meta",), layout=True)


def spec_axes(logical: Sequence[Optional[str]], mesh: Mesh
              ) -> Tuple[str, ...]:
    """Every mesh axis a logical spec splits a tensor over."""
    return tuple(a for ax in resolve(logical, mesh) for a in _axes(ax))


def _position(mesh: Mesh, flat: int, axes: Tuple[str, ...]) -> int:
    c = mesh.coords(flat)
    return int(np.ravel_multi_index(tuple(c[a] for a in axes),
                                    tuple(mesh.sizes[a] for a in axes))) \
        if axes else 0


def shard(x: torch.Tensor, logical: Sequence[Optional[str]], mesh: Mesh
          ) -> List[torch.Tensor]:
    """``x`` split by a logical spec (``models.model.param_specs``), one
    part a run shard, each a copy on the shard's device: the dims the
    spec puts on mesh axes split into equal blocks, block ``i`` to the
    shard at position ``i`` along those axes."""
    axes = resolve(logical, mesh)
    if len(axes) != x.dim():
        raise ValueError(f"shard: spec {tuple(logical)} for a "
                         f"{x.dim()}-d tensor")
    parts = []
    for f, dev in zip(mesh.traced, mesh.devices):
        part = x
        for dim, ax in enumerate(axes):
            names = tuple(a for a in mesh.axis_names if a in _axes(ax))
            k = math.prod(mesh.sizes[a] for a in names)
            if k == 1:
                continue
            if x.shape[dim] % k:
                raise ValueError(
                    f"shard: dim {dim} of {tuple(x.shape)} ({logical[dim]}"
                    f" over {names}) does not divide into {k} shards")
            m = x.shape[dim] // k
            part = part.narrow(dim, _position(mesh, f, names) * m, m)
        parts.append(part.to(dev, copy=True))
    return parts


def unshard(parts: Sequence[torch.Tensor], logical: Sequence[Optional[str]],
            mesh: Mesh, device=None) -> torch.Tensor:
    """The tensor ``shard`` split, from the parts of every shard (not a
    layout mesh), on ``device`` (the first shard's by default).  On a
    process-group mesh ``parts`` is this rank's one part, all-gathered
    over the axes of each dim the spec splits (every rank calls it, and
    every rank gets the whole; not tallied)."""
    if mesh.layout:
        raise ValueError("unshard: a layout mesh runs shard 0 alone")
    axes = resolve(logical, mesh)
    if mesh.rank_local:
        out = parts[0]
        for dim, ax in enumerate(axes):
            names = tuple(a for a in mesh.axis_names if a in _axes(ax))
            if math.prod(mesh.sizes[a] for a in names) > 1:
                g = mesh.group(names, mesh.traced[0])
                out = mesh.transport.all_gather(out, dim, g.pg)
        return out.to(device or mesh.devices[0])
    spec = set(spec_axes(logical, mesh))
    device = device or mesh.devices[0]
    shape = list(parts[0].shape)
    for dim, ax in enumerate(axes):
        shape[dim] *= math.prod(mesh.sizes[a] for a in _axes(ax))
    out = parts[0].new_empty(shape, device=device)
    for f, part in zip(mesh.traced, parts):
        c = mesh.coords(f)
        if any(c[a] for a in mesh.axis_names if a not in spec):
            continue                        # a replica
        view = out
        for dim, ax in enumerate(axes):
            names = tuple(a for a in mesh.axis_names if a in _axes(ax))
            if names:
                m = part.shape[dim]
                view = view.narrow(dim, _position(mesh, f, names) * m, m)
        view.copy_(part)
    return out


def is_spec(x) -> bool:
    """A logical spec: a tuple of axis names and Nones."""
    return isinstance(x, tuple) and all(e is None or isinstance(e, str)
                                        for e in x)


def shard_tree(tree, specs, mesh: Mesh) -> List[Any]:
    """``shard`` over a tree of tensors and its tree of specs: one tree
    a run shard."""
    leaves, spec = tree_flatten(tree)
    sleaves = tree_flatten(specs, is_leaf=is_spec)[0]
    if len(sleaves) != len(leaves):
        raise ValueError("shard_tree: specs do not match the tree")
    cols = [shard(x, sp, mesh) for x, sp in zip(leaves, sleaves)]
    return [tree_unflatten([c[i] for c in cols], spec)
            for i in range(len(mesh.traced))]


def unshard_tree(parts: Sequence[Any], specs, mesh: Mesh, device=None):
    """``unshard`` over the per-shard trees ``shard_tree`` made."""
    flat = [tree_flatten(p)[0] for p in parts]
    spec = tree_flatten(parts[0])[1]
    sleaves = tree_flatten(specs, is_leaf=is_spec)[0]
    return tree_unflatten(
        [unshard([f[i] for f in flat], sp, mesh, device)
         for i, sp in enumerate(sleaves)], spec)


# ---------------------------------------------------------------------------
# The NODES mesh
# ---------------------------------------------------------------------------

class NodeMesh(Mesh):
    """The NODES mesh: a ``Mesh`` of shape ``(S, 1)`` over ``("data",
    "model")``, NODES resolving onto ``data``, of torch devices in a fixed
    shard order (shard ``s`` runs on ``devices[s]``); a device may appear
    more than once.  Its collectives (``nodes``) give the shards of one
    device one shared, read-only result and carry plain autograd.
    Compared and hashed by identity: ``node_mesh`` memoizes, so every
    bind of a source gets the same object back."""

    shares_results = True

    def __init__(self, devices: Sequence, transport=None):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("NodeMesh: needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"NodeMesh: devices must share one type, got "
                             f"{[str(d) for d in devs]}")
        # a process-group mesh's shards are in other processes: each
        # gets its own result, with the adjoint collectives
        self.shares_results = transport is None
        shards = len(devs) if transport is None else transport.world
        super().__init__((shards, 1), ("data", "model"), devs,
                         transport=transport)

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    @property
    def rank(self) -> int:
        """The shard this process runs (0 on a single-controller mesh)."""
        return self.traced[0] if self.rank_local else 0

    @property
    def nodes(self) -> "Group":
        """The group of every shard along NODES."""
        return self.group(axis_map(self)[NODES], 0)

    def __repr__(self) -> str:
        if self.rank_local:
            return (f"NodeMesh(rank {self.rank} of {self.size} on "
                    f"{self.devices[0]}, {self.transport.name})")
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


def process_node_mesh(transport) -> NodeMesh:
    """The NODES mesh of an initialised process group: ``transport.world``
    shards, one a process, this process's shard ``transport.rank`` on
    ``transport.device`` (``launch.procs.init`` makes the transport)."""
    return NodeMesh((transport.device,), transport=transport)


def process_mesh(shape: Sequence[int], axis_names: Sequence[str],
                 transport) -> Mesh:
    """The ``(data, model)`` or ``(pod, data, model)`` mesh of an
    initialised process group (``launch.procs.init``): one shard a
    process, shard ``transport.rank`` here on ``transport.device``.
    Every rank builds it with the same shape: it makes the subgroups of
    every axis set, a collective of every rank."""
    return Mesh(shape, axis_names, (transport.device,), transport=transport)


def rank_rows(n_pad: int, mesh: NodeMesh) -> Tuple[int, int]:
    """``(lo, hi)``: the rows of an [n_pad, ...] NODES-sharded table that
    this rank of a process-group mesh holds (``row_owner``'s block)."""
    if not mesh.rank_local:
        raise ValueError(f"rank_rows: {mesh} is not a process-group mesh")
    if n_pad % mesh.size:
        raise ValueError(f"rank_rows: n_pad={n_pad} rows must divide the "
                         f"{mesh.size} NODES shards (pad first)")
    m = n_pad // mesh.size
    return mesh.rank * m, (mesh.rank + 1) * m


def rank_block(a: np.ndarray, mesh: NodeMesh) -> np.ndarray:
    """This rank's row block of the host array ``a`` padded with zero rows
    to a multiple of the shards (``pad_rows``), read without padding or
    copying the whole (a memory-mapped ``a`` reads only the block)."""
    n_pad = a.shape[0] + (-a.shape[0]) % mesh.size
    lo, hi = rank_rows(n_pad, mesh)
    block = np.array(a[lo:min(hi, a.shape[0])])      # a copy of the rows
    return pad_rows(block, hi - lo) if block.shape[0] < hi - lo else block


def barrier(mesh) -> None:
    """Wait for every rank of a process-group mesh (no-op for any other
    mesh or None)."""
    if mesh is not None and mesh.rank_local:
        mesh.transport.barrier()


def agree(mesh, flags: Sequence[float]) -> List[float]:
    """Each host value summed over the ranks of a process-group mesh (the
    values themselves otherwise): how ranks agree on a host decision
    before acting on it.  Not a NODES collective: not tallied."""
    if not mesh.rank_local or mesh.size == 1:
        return [float(f) for f in flags]
    t = torch.tensor([float(f) for f in flags], dtype=torch.float32,
                     device=mesh.devices[0])
    return [float(x) for x in mesh.transport.all_reduce(t).cpu()]


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
    """The row blocks of a NODES-sharded ``x`` that this process runs:
    on a single-controller mesh ``x`` is the whole table [S·m, ...] and
    block ``s`` lands on ``devices[s]`` (a view where the device is
    ``x``'s own); on a process-group mesh ``x`` already is this rank's
    rows, its one block."""
    if mesh.rank_local:
        return [x.to(mesh.devices[0])]
    s = mesh.size
    if x.shape[0] % s:
        raise ValueError(f"shard_rows: {x.shape[0]} rows do not divide the "
                         f"{s} NODES shards")
    m = x.shape[0] // s
    return [x[i * m:(i + 1) * m].to(dev) for i, dev in enumerate(mesh.devices)]


def mean_denom(mesh, n: int) -> Optional[int]:
    """The divisor that makes a rank's row sum its share of a mean over
    ``n`` rows the ranks of a process-group mesh hold between them (the
    shares then sum to the mean); None, each call's own mean, on any
    other mesh, on one rank and without a mesh."""
    return n if mesh is not None and mesh.rank_local and mesh.size > 1 \
        else None


def unshard_rows(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The row blocks concatenated in shard order on ``device``."""
    parts = [p.to(device) for p in parts]
    return parts[0] if len(parts) == 1 else torch.cat(parts, 0)


# ---------------------------------------------------------------------------
# Collectives over per-shard tensors
# ---------------------------------------------------------------------------

#: the collectives' wire bytes a device by kind, summed over every call
#: since ``reset_collectives`` (the reference's ``collective_bytes`` keys)
_TALLY: Dict[str, int] = collections.Counter()


def reset_collectives() -> None:
    _TALLY.clear()


def collective_counts() -> Dict[str, int]:
    """Wire bytes a device of every collective since the last
    ``reset_collectives``, by kind ("all-reduce", "all-gather",
    "reduce-scatter") and "calls" (over a mesh with several groups of an
    axis, the sum over the groups' calls); "f32-partial": of those
    bytes, the f32 partial products' (``note_collective``)."""
    return dict(_TALLY)


def note_collective(kind: str, nbytes: int, axes: Tuple[str, ...],
                    f32_partial: bool = False) -> None:
    """One collective call's wire bytes a device, to the tally and to
    every active dispatch mode that counts collectives
    (``launch.roofline.TraceCounter.note_collective``).  ``f32_partial``:
    it carries the f32 partial products of half-precision GEMMs
    (``layers.partial_product``) or their gradients, which the
    reference's GSPMD moves in the operands' dtype, at half the bytes."""
    _TALLY[kind] += nbytes
    _TALLY["calls"] += 1
    if f32_partial:
        _TALLY["f32-partial"] += nbytes
    for mode in _get_current_dispatch_mode_stack():
        if hasattr(mode, "note_collective"):
            mode.note_collective(kind, nbytes, axes, f32_partial)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _results(t: torch.Tensor, group: "Group") -> List[torch.Tensor]:
    """``t`` for each run shard of ``group``.  A group that shares
    results gives the shards of one device one read-only copy; otherwise
    each shard gets a tensor of its own (shards never share a result a
    shard may write or free)."""
    if group.share:
        made: Dict[str, torch.Tensor] = {}
        for d in group.devices:
            if str(d) not in made:
                made[str(d)] = t.to(d)
        return [made[str(d)] for d in group.devices]
    return [t if j == 0 and t.device == torch.device(d)
            else t.to(d, copy=True) for j, d in enumerate(group.devices)]


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


def _gather_values(parts, group: "Group", dim: int, f32_partial=False):
    if group.transport is not None:
        out = [group.transport.all_gather(parts[0], dim, group.pg)]
    elif group.virtual:
        shape = list(parts[0].shape)
        shape[dim] *= group.size
        out = [parts[0].new_empty(shape)]
    else:
        out = _results(torch.cat([p.to(group.devices[0]) for p in parts],
                                 dim), group)
    note_collective("all-gather", _nbytes(out[0]), group.axes, f32_partial)
    return out


def _sum_values(parts, group: "Group", f32_partial=False):
    if group.transport is not None:
        out = [group.transport.all_reduce(parts[0], group.pg)]
    elif group.virtual:
        out = [parts[0].new_empty(parts[0].shape)]
    else:
        out = _results(_shard_sum(parts), group)
    note_collective("all-reduce", 2 * _nbytes(parts[0]), group.axes,
                    f32_partial)
    return out


def _scatter_values(parts, group: "Group", dim: int, f32_partial=False):
    n = parts[0].shape[dim]
    if n % group.size:
        raise ValueError(f"psum_scatter: dim {dim} of "
                         f"{tuple(parts[0].shape)} does not split over "
                         f"{group.size} shards")
    if group.transport is not None:
        out = [group.transport.reduce_scatter(parts[0], dim, group.pg)]
    elif group.virtual:
        shape = list(parts[0].shape)
        shape[dim] = n // group.size
        out = [parts[0].new_empty(shape)]
    else:
        blocks = _shard_sum(parts).split(n // group.size, dim)
        out = [blocks[p].to(d, copy=not group.share)
               for p, d in zip(group.positions, group.devices)]
    note_collective("reduce-scatter", _nbytes(parts[0]), group.axes,
                    f32_partial)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, f32_partial, dim, *parts):
        ctx.args = group, dim, f32_partial
        return tuple(_gather_values(parts, group, dim, f32_partial))

    @staticmethod
    def backward(ctx, *grads):
        return (None,) * 3 + tuple(_scatter_values(grads, *ctx.args))


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, f32_partial, *parts):
        ctx.args = group, f32_partial
        return tuple(_sum_values(parts, group, f32_partial))

    @staticmethod
    def backward(ctx, *grads):
        return (None,) * 2 + tuple(_sum_values(grads, *ctx.args))


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, f32_partial, dim, *parts):
        ctx.args = group, dim, f32_partial
        return tuple(_scatter_values(parts, group, dim, f32_partial))

    @staticmethod
    def backward(ctx, *grads):
        return (None,) * 3 + tuple(_gather_values(grads, *ctx.args))


MeshLike = Union[NodeMesh, Group]


def _group(mesh: MeshLike, parts, what: str) -> Group:
    """The group a collective runs over (a ``NodeMesh``: its NODES
    group), checked against the parts."""
    g = mesh.nodes if isinstance(mesh, NodeMesh) else mesh
    if len(parts) != len(g.devices):
        raise ValueError(f"{what}: {len(parts)} parts for a mesh of "
                         f"{len(g.devices)} shards")
    return g


def _collective(fn, values, g: Group, parts, f32_partial: bool, *args
                ) -> List[torch.Tensor]:
    """A collective over ``g``: the parts themselves on one shard; where
    ``g`` shares results, its values through plain autograd; else the
    autograd function ``fn`` (the adjoint collective in its backward,
    noted with the same ``f32_partial``)."""
    if g.size == 1:
        return list(parts)
    if g.share:
        return values(parts, g, *args, f32_partial)
    return list(fn.apply(g, f32_partial, *args, *parts))


def all_gather(parts: Sequence[torch.Tensor], mesh: MeshLike, dim: int = 0
               ) -> List[torch.Tensor]:
    """Each shard gets every shard's part, concatenated along ``dim`` in
    shard order (the reference's tiled ``all_gather``).  ``mesh``: a
    ``Group`` of a ``Mesh``, or a ``NodeMesh`` (its NODES group); the
    backward is ``psum_scatter``."""
    g = _group(mesh, parts, "all_gather")
    return _collective(_AllGather, _gather_values, g, parts, False, dim)


def psum(parts: Sequence[torch.Tensor], mesh: MeshLike, *,
         f32_partial: bool = False) -> List[torch.Tensor]:
    """Each shard gets the sum over shards (in shard order, in f32,
    rounded once); the backward is ``psum``.  ``f32_partial``: as
    ``note_collective`` takes it."""
    return _collective(_Psum, _sum_values, _group(mesh, parts, "psum"),
                       parts, f32_partial)


def psum_scatter(parts: Sequence[torch.Tensor], mesh: MeshLike,
                 dim: int = 0, *, f32_partial: bool = False
                 ) -> List[torch.Tensor]:
    """The sum over shards (in shard order), split along ``dim`` into
    one block a shard: shard ``s`` gets block ``s`` (the reference's
    tiled ``psum_scatter``); the backward is ``all_gather``.
    ``f32_partial``: as ``note_collective`` takes it."""
    g = _group(mesh, parts, "psum_scatter")
    return _collective(_PsumScatter, _scatter_values, g, parts,
                       f32_partial, dim)
