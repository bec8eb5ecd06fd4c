"""Meshes of the port (reference ``repro.launch.mesh``).

``make_host_mesh`` is the NODES mesh over the cards present
(``sharding.node_mesh``).  ``make_production_mesh`` is the layout the
dry-run models: one H100, named ``1xH100`` (the reference's are a
16 x 16 pod of TPU v5e and two of them).  A multi-card layout needs a
``torch.distributed`` backend (ROADMAP.md Queue 1 item 5); modelling it
with single-controller shards on one card would report one card's
memory as the mesh's, so it raises.  Functions, not module constants:
importing this module touches no device.
"""
from __future__ import annotations

import dataclasses

from repro_torch import sharding as sh
from repro_torch.launch.roofline import HBM_BYTES


@dataclasses.dataclass(frozen=True)
class CardLayout:
    """The layout a dry-run record models: ``chips`` cards of
    ``hbm_bytes`` each, keyed ``name`` in the record's file name."""
    name: str
    chips: int
    hbm_bytes: float


def _no_multi_card(what: str):
    raise NotImplementedError(
        f"{what}: the port has one card and no torch.distributed backend "
        f"(ROADMAP.md Queue 1 item 5)")


def make_production_mesh(*, multi_pod: bool = False) -> CardLayout:
    if multi_pod:
        _no_multi_card("a multi-pod (multi-card) production mesh")
    return CardLayout(name="1xH100", chips=1, hbm_bytes=HBM_BYTES)


def make_host_mesh(model_par: int = 1) -> sh.NodeMesh:
    """The NODES mesh over every visible card (raises without one)."""
    if model_par != 1:
        _no_multi_card(f"model_par={model_par}")
    return sh.node_mesh()
