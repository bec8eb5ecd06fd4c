"""Meshes of the port (reference ``repro.launch.mesh``).

``make_host_mesh`` is the ``(data, model)`` mesh over the cards present,
or over the devices given: a device may repeat, so ``make_host_mesh(2,
devices=("cuda:0",) * 2)`` is two model shards on one card and
``("cpu",) * 4`` four on the host (``sharding.Mesh``), one process
driving every shard.  ``make_process_mesh`` is the same layout over the
ranks of a process group, one shard a process (``sharding.process_mesh``).
``make_production_mesh`` is a layout the dry-run models: one H100
(``1xH100``, the default), a pod of 16 x 16 = 256 cards
(``16x16xH100``, axes ``("data", "model")``) or two of them
(``2x16x16xH100``, ``("pod", "data", "model")``), as the reference's
16 x 16 and 2 x 16 x 16 TPU meshes.  A multi-card layout carries the
link each axis's ring crosses: cards sit eight to an NVLink host, in
row-major order, so an axis whose shards span more than one host (every
axis of both layouts: ``model`` is 16 wide) runs at the network's rate.
Its ``mesh`` is a ``sharding.layout_mesh``: the dry-run runs one
device's share on meta tensors.  Functions, not module constants:
importing this module touches no device.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch import sharding as sh
from repro_torch.launch.roofline import HBM_BYTES

#: cards a host joins by NVLink (an HGX H100 board)
CARDS_PER_HOST = 8


@dataclasses.dataclass(frozen=True)
class CardLayout:
    """The layout a dry-run record models: ``chips`` cards of
    ``hbm_bytes`` each, keyed ``name`` in the record's file name, with
    the mesh axes ``axis_names`` of sizes ``shape`` (none for one
    card)."""
    name: str
    chips: int
    hbm_bytes: float
    shape: Tuple[int, ...] = ()
    axis_names: Tuple[str, ...] = ()

    @property
    def links(self) -> Dict[str, str]:
        """The link each axis's ring crosses: ``"nvlink"`` when the
        axis's shards (its size times the inner axes' sizes, row-major)
        stay in one host of ``CARDS_PER_HOST`` cards, else ``"ib"``."""
        return {a: "nvlink" if math.prod(self.shape[i:]) <= CARDS_PER_HOST
                else "ib" for i, a in enumerate(self.axis_names)}

    @functools.cached_property
    def mesh(self) -> Optional[sh.Mesh]:
        """The layout's ``sharding.layout_mesh`` (None for one card)."""
        if self.chips == 1:
            return None
        return sh.layout_mesh(self.shape, self.axis_names)


LAYOUTS = {
    "1xH100": CardLayout("1xH100", 1, HBM_BYTES),
    "16x16xH100": CardLayout("16x16xH100", 256, HBM_BYTES, (16, 16),
                             ("data", "model")),
    "2x16x16xH100": CardLayout("2x16x16xH100", 512, HBM_BYTES, (2, 16, 16),
                               ("pod", "data", "model")),
}


def layout_name(name: str) -> str:
    """A layout's name from its own or the reference's (``16x16``,
    ``2x16x16``)."""
    name = name if name in LAYOUTS else f"{name}xH100"
    if name not in LAYOUTS:
        raise ValueError(f"unknown layout {name!r}; have {sorted(LAYOUTS)}")
    return name


def make_production_mesh(*, multi_pod: bool = False,
                         layout: Optional[str] = None) -> CardLayout:
    """``layout`` by name (``1xH100``, ``16x16``, ``2x16x16``, with or
    without ``xH100``); else ``2x16x16xH100`` when ``multi_pod``, else
    one card."""
    if layout is not None:
        return LAYOUTS[layout_name(layout)]
    return LAYOUTS["2x16x16xH100" if multi_pod else "1xH100"]


def make_host_mesh(model_par: int = 1, devices: Optional[Sequence] = None,
                   ) -> sh.Mesh:
    """The ``(data, model)`` mesh over every visible card (raises without
    one) or over ``devices`` (a device may repeat): ``model_par`` model
    shards, the rest data replicas, as the reference's."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "make_host_mesh(): no CUDA device is visible; pass devices= "
                "(e.g. ('cpu',) * 2) for a mesh on the host")
        devices = [f"cuda:{i}" for i in range(n)]
    n = len(devices)
    if model_par < 1 or n % model_par:
        raise ValueError(f"make_host_mesh: model_par={model_par} must "
                         f"divide the {n} devices")
    return sh.Mesh((n // model_par, model_par), ("data", "model"), devices)


def make_process_mesh(model_par: int, transport) -> sh.Mesh:
    """The ``(world // model_par, model_par)`` mesh over the ranks of an
    initialised process group (``launch.procs.init``'s ``transport``),
    one shard a rank, rank ``r`` at flat shard ``r``: ``model_par``
    model shards, the rest data replicas, as ``make_host_mesh`` lays
    them over cards.  Every rank must build it (it makes the mesh's
    subgroups)."""
    n = transport.world
    if model_par < 1 or n % model_par:
        raise ValueError(f"make_process_mesh: model_par={model_par} must "
                         f"divide the {n} ranks")
    return sh.process_mesh((n // model_par, model_par), ("data", "model"),
                           transport)
