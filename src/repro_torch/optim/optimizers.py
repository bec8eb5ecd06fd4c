"""Optimizers without a library: AdamW, SGD(+momentum), schedules and
global-norm clipping (torch copy of the reference
``repro.optim.optimizers``).

Parameters and states are lists of per-layer dicts of tensors (the
reference's pytrees).  ``Optimizer.update(grads, state, params)`` is
functional and returns ``(new_params, new_state)``; the engine writes the
results into the parameter and state tensors IN PLACE under
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

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]   # (grads, state, params) ->
    #                                            (new_params, new_state)


def _map(fn, *trees):
    """``fn`` over the leaves of parallel lists of dicts of tensors."""
    return [{k: fn(*(t[i][k] for t in trees)) for k in trees[0][i]}
            for i in range(len(trees[0]))]


def _leaves(tree):
    return [v for p in tree for v in p.values()]


def _step0(params):
    dev = _leaves(params)[0].device if _leaves(params) else "cpu"
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


def clip_by_global_norm(grads, max_norm: float):
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                        for g in _leaves(grads)))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return _map(lambda g: (g.to(F32) * scale).to(g.dtype), grads), gn


def adamw(lr: Callable | float, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          clip_norm: Optional[float] = 1.0) -> Optimizer:
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=F32,  # noqa: E731
                                      device=p.device)
        return {"mu": _map(zeros, params), "nu": _map(zeros, params),
                "step": _step0(params)}

    def update(grads, state, params):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        step = state["step"] + 1
        lr_t = sched(step)
        t = step.to(F32)
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t
        new_p, new_mu, new_nu = [], [], []
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            pp, mm, nn = {}, {}, {}
            for k in p:
                gk = g[k].to(F32)
                mm[k] = b1 * mu[k] + (1 - b1) * gk
                nn[k] = b2 * nu[k] + (1 - b2) * torch.square(gk)
                delta = (mm[k] / c1) / (torch.sqrt(nn[k] / c2) + eps)
                if weight_decay:
                    delta = delta + weight_decay * p[k].to(F32)
                pp[k] = (p[k].to(F32) - lr_t * delta).to(p[k].dtype)
            new_p.append(pp)
            new_mu.append(mm)
            new_nu.append(nn)
        return new_p, {"mu": new_mu, "nu": new_nu, "step": step}

    return Optimizer(init, update)


def sgd(lr: Callable | float, momentum: float = 0.0) -> Optimizer:
    """Plain (S)GD — the paper's optimizer for full-graph GD and
    mini-batch SGD (App. N)."""
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        if momentum:
            return {"vel": _map(lambda p: torch.zeros(
                p.shape, dtype=F32, device=p.device), params),
                "step": _step0(params)}
        return {"step": _step0(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = sched(step)
        if momentum:
            vel = _map(lambda v, g: momentum * v + g.to(F32),
                       state["vel"], grads)
            new_p = _map(lambda p, v: (p.to(F32) - lr_t * v).to(p.dtype),
                         params, vel)
            return new_p, {"vel": vel, "step": step}
        new_p = _map(lambda p, g: (p.to(F32) - lr_t * g.to(F32)).to(
            p.dtype), params, grads)
        return new_p, {"step": step}

    return Optimizer(init, update)
