"""Optimizers without a library: AdamW, SGD(+momentum), schedules and
global-norm clipping (torch copy of the reference
``repro.optim.optimizers``).

Parameters and states are trees of tensors (the reference's pytrees):
dicts, lists and tuples, a GNN's list of per-layer dicts or an LM's
nested dict, walked with ``torch.utils._pytree``.
``Optimizer.update(grads, state, params)`` is functional and returns
``(new_params, new_state)``; the engine writes the results into the
parameter and state tensors IN PLACE under
``torch.no_grad()`` (``engine._guarded_update``), which is the port's
form of the reference's buffer donation (``TrainPlan.donate``).

The step counter is a 0-d int32 tensor on the parameters' device and is
incremented BEFORE the schedule reads it, as in the reference; schedules
take it as a tensor, so nothing is read back to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch
from torch.utils._pytree import MappingKey, tree_leaves, tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., tuple]   # (grads, state, params,
    #                                global_norm=None) -> (new_params,
    #                                new_state); global_norm: the
    #                                gradients' norm over every shard


def dict_keys(path) -> tuple:
    """The dict keys of a ``tree_flatten_with_path`` key path (list and
    tuple positions dropped, as the reference's ``p.key`` filter drops
    them)."""
    return tuple(p.key for p in path if isinstance(p, MappingKey))


def value_and_grad(fn, params, *args):
    """``fn(params, *args) -> (value, aux)``'s value (detached), its aux
    as ``fn`` returned it, and the value's gradients with respect to
    every leaf of ``params`` (a tree like it): the reference steps'
    ``jax.value_and_grad(..., has_aux=True)``.  The caller's tensors are
    not marked: the graph runs on detached aliases of them."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    tracked = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        value, aux = fn(tracked, *args)
        grads = torch.autograd.grad(value, leaves)
    it = iter(grads)
    return value.detach(), aux, tree_map(lambda _: next(it), params)


def _step0(params):
    dev = tree_leaves(params)[0].device if tree_leaves(params) else "cpu"
    return torch.zeros((), dtype=torch.int32, device=dev)


def constant_schedule(lr: float) -> Callable[[Any], Any]:
    """A Python float: torch multiplies an f32 tensor by it in f32, as
    the reference does with its f32 scalar, and making a device scalar
    per step would cost a host-to-device copy."""
    return lambda step: float(lr)


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor: float = 0.0) -> Callable[[Any], Any]:
    def fn(step):
        step = torch.as_tensor(step).to(F32)
        warm = peak * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return fn


def clip_by_global_norm(grads, max_norm: float, gn=None):
    """``grads`` scaled to a global norm of at most ``max_norm``, and that
    norm; ``gn``: the norm, when it is computed elsewhere (over the
    shards of a mesh)."""
    if gn is None:
        gn = torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                            for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: (g.to(F32) * scale).to(g.dtype), grads), gn


def adamw(lr: Callable | float, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          clip_norm: Optional[float] = 1.0) -> Optimizer:
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=F32,  # noqa: E731
                                      device=p.device)
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "step": _step0(params)}

    def update(grads, state, params, global_norm=None):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm, global_norm)
        step = state["step"] + 1
        lr_t = sched(step)
        t = step.to(F32)
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t
        def upd(p, g, mu, nu):
            g = g.to(F32)
            mu2 = b1 * mu + (1 - b1) * g
            nu2 = b2 * nu + (1 - b2) * torch.square(g)
            delta = (mu2 / c1) / (torch.sqrt(nu2 / c2) + eps)
            if weight_decay:
                delta = delta + weight_decay * p.to(F32)
            return (p.to(F32) - lr_t * delta).to(p.dtype), mu2, nu2

        out = tree_map(upd, params, grads, state["mu"], state["nu"])
        new_p, new_mu, new_nu = (tree_map(lambda _, o: o[i], params, out)
                                 for i in range(3))
        return new_p, {"mu": new_mu, "nu": new_nu, "step": step}

    return Optimizer(init, update)


def sgd(lr: Callable | float, momentum: float = 0.0) -> Optimizer:
    """Plain (S)GD — the paper's optimizer for full-graph GD and
    mini-batch SGD (App. N)."""
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        if momentum:
            return {"vel": tree_map(lambda p: torch.zeros(
                p.shape, dtype=F32, device=p.device), params),
                "step": _step0(params)}
        return {"step": _step0(params)}

    def update(grads, state, params, global_norm=None):
        step = state["step"] + 1
        lr_t = sched(step)
        if momentum:
            vel = tree_map(lambda v, g: momentum * v + g.to(F32),
                       state["vel"], grads)
            new_p = tree_map(lambda p, v: (p.to(F32) - lr_t * v).to(p.dtype),
                         params, vel)
            return new_p, {"vel": vel, "step": step}
        new_p = tree_map(lambda p, g: (p.to(F32) - lr_t * g.to(F32)).to(
            p.dtype), params, grads)
        return new_p, {"step": step}

    return Optimizer(init, update)
