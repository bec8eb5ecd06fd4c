"""Step functions of the LM (reference ``repro/models/steps.py``): the
AdamW ``train_step`` (loss, gradients, optional gradient accumulation
over micro-batches), ``prefill_step`` and ``serve_step``; and the
shape-only inputs of every assigned input shape for the dry-run
(``batch_specs``, ``cache_shape_specs``, ``abstract_state``), which
allocate nothing.

The reference returns ``ShapeDtypeStruct``s with shardings attached.
Here they are meta tensors (``device.TRACE_DEVICE``; fake tensors when
called under ``FakeTensorMode``) with the reference's shapes and
dtypes.

``mesh`` (a ``sharding.Mesh``) runs every step tensor-parallel: the
parameters and the optimizer state are one tree a run shard
(``model.shard_params``), split over ``model`` and, on ``FSDP`` dims,
over ``data``.  A step all-gathers the FSDP dims before use (their
gradients come back reduce-scattered by the gather's backward), sums
every gradient over the axes its parameter is replicated on (``model``
for the replicated weights, the batch axes for the rest), clips by the
norm over every shard and runs AdamW shard by shard.  A batch's rows
split over the run data replicas; on a layout mesh (the dry-run's, one
shard run) the shape-only inputs are one device's: its rows of the
batch, its shard of every weight and cache."""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch import sharding as sh
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.device import TRACE_DEVICE
from repro_torch.models import model as M
from repro_torch.optim import adamw, cosine_schedule, value_and_grad

F32 = torch.float32
METRICS = ("loss", "aux", "acc")


def _value_and_grad(params, cfg: ModelConfig, batch, mesh=None):
    """The gradients of ``forward_train``'s total and its metrics (with
    ``mesh``: of each shard's stored parameters, FSDP dims gathered in
    the forward; a shard's copy that nothing read gets zeros).  The
    total is one value the collectives hand every shard a copy of: its
    cotangent enters once, at shard 0's copy (a process-group mesh's
    other ranks seed theirs with 0), and the collectives' adjoints carry
    it to every shard, as in the single controller."""
    if mesh is None:
        _, metrics, grads = value_and_grad(
            lambda p: M.forward_train(p, cfg, batch), params)
        return grads, {k: metrics[k].detach() for k in METRICS}
    leaves, spec = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        total, metrics = M.forward_train(
            M.gather_params(tree_unflatten(leaves, spec), cfg, mesh), cfg,
            batch, mesh)
        seed = torch.ones_like(total) if mesh.traced[0] == 0 \
            else torch.zeros_like(total)
        grads = torch.autograd.grad(total, leaves, seed, allow_unused=True,
                                    materialize_grads=True)
    return (tree_unflatten(list(grads), spec),
            {k: metrics[k].detach() for k in METRICS})


def reduce_grads(grads, cfg: ModelConfig, mesh):
    """Each shard's gradients summed over the mesh axes its parameter is
    replicated on (``psum``): ``model`` for the weights ``param_specs``
    does not split, the batch axes for every weight not split over
    ``data`` (an FSDP weight's gradient is reduce-scattered over ``data``
    already)."""
    flat = [tree_flatten(g) for g in grads]
    leaves = [list(f[0]) for f in flat]
    for i, sp in enumerate(M.spec_leaves(grads[0], cfg)):
        axes = tuple(a for a in mesh.axis_names
                     if a not in sh.spec_axes(sp, mesh))
        if math.prod(mesh.sizes[a] for a in axes) == 1:
            continue
        for g in mesh.groups(axes):
            idx = [mesh.traced.index(f) for f in g.members]
            for t, o in zip(idx, sh.psum([leaves[t][i] for t in idx], g)):
                leaves[t][i] = o
    return [tree_unflatten(lv, f[1]) for lv, f in zip(leaves, flat)]


def global_norms(grads, cfg: ModelConfig, mesh):
    """The gradients' global norm, on every run shard: each shard's sum
    of squares, a replicated block weighted by 1 / its copies, summed
    over every shard (one ``psum`` over all axes)."""
    specs = M.spec_leaves(grads[0], cfg)
    sq = []
    for g in grads:
        acc = None
        for x, sp in zip(tree_flatten(g)[0], specs):
            part = torch.sum(torch.square(x.to(F32))) * (math.prod(
                mesh.sizes[a] for a in sh.spec_axes(sp, mesh)) / mesh.size)
            acc = part if acc is None else acc + part
        sq.append(acc)
    total = sh.psum(sq, mesh.group(mesh.axis_names, mesh.traced[0]))
    return [torch.sqrt(t) for t in total]


def accumulate_grads(params, cfg: ModelConfig, batch, microbatches: int = 1,
                     mesh=None):
    """``(grads, metrics)`` of one train step before its update: with
    ``microbatches > 1`` the batch splits along dim 0 and the gradients
    accumulate in f32 over the micro-batches, one after another (the
    reference's ``lax.scan``: it bounds activation memory at a fixed
    global batch); gradients and metrics are divided by the count.
    ``mesh``: ``params`` one tree a run shard, the gradients likewise
    (before ``reduce_grads``)."""
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    if microbatches == 1:
        return _value_and_grad(params, cfg, batch, mesh)
    b = next(iter(batch.values())).shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} does not split into "
                         f"{microbatches} micro-batches")
    m = b // microbatches
    grads, msum = None, None
    for i in range(microbatches):
        mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
        g, mets = _value_and_grad(params, cfg, mb, mesh)
        if grads is None:
            grads = tree_map(lambda x: x.to(F32), g)
            msum = mets
        else:
            tree_map(lambda a, x: a.add_(x.to(F32)), grads, g)
            msum = {k: msum[k] + mets[k] for k in METRICS}
        del g           # free before the next micro-batch's backward
    grads = tree_map(lambda x: x.div_(microbatches), grads)
    return grads, {k: v / microbatches for k, v in msum.items()}


def make_train_step(cfg: ModelConfig, optimizer=None, microbatches: int = 1,
                    mesh=None):
    """``(opt, train_step)``: AdamW (``cosine_schedule(3e-4, 100,
    10_000)``, weight decay 0.1) unless ``optimizer`` is given, and
    ``train_step(params, opt_state, batch) -> (new_params, new_state,
    metrics)``, the update of ``accumulate_grads``' gradients.  The
    update is functional, as the reference's: the caller's trees are
    left as they were.  ``mesh``: parameters and state one tree a run
    shard (``opt.init`` of each), updated shard by shard after
    ``reduce_grads`` with the norm of ``global_norms``."""
    opt = optimizer or adamw(cosine_schedule(3e-4, 100, 10_000),
                             weight_decay=0.1)
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")

    def train_step(params, opt_state, batch):
        grads, metrics = accumulate_grads(params, cfg, batch, microbatches,
                                          mesh)
        with torch.no_grad():
            if mesh is None:
                new_params, new_state = opt.update(grads, opt_state, params)
                return new_params, new_state, metrics
            grads = reduce_grads(grads, cfg, mesh)
            out = [opt.update(g, st, p, global_norm=gn) for g, st, p, gn
                   in zip(grads, opt_state, params,
                          global_norms(grads, cfg, mesh))]
        return [o[0] for o in out], [o[1] for o in out], metrics

    return opt, train_step


def make_prefill_step(cfg: ModelConfig, mesh=None):
    """``prefill_step(params, batch, max_len=None) -> (last_logits,
    cache)``, the flash-attention kernel in every causal self-attention;
    ``batch`` holds ``patches`` (VLM) or ``frames`` (audio) beside the
    tokens where the family takes them.  ``mesh``: one flash call a
    shard on its heads; the FSDP dims gathered first; one cache a run
    shard."""
    def prefill_step(params, batch, max_len: Optional[int] = None):
        if mesh is None:
            return M.prefill(params, cfg, batch, max_len)
        return M.prefill(M.gather_params(params, cfg, mesh), cfg, batch,
                         max_len, mesh=mesh)
    return prefill_step


def make_serve_step(cfg: ModelConfig, mesh=None):
    """``serve_step(params, cache, token) -> (logits, cache)``."""
    def serve_step(params, cache, token):
        if mesh is None:
            return M.decode_step(params, cfg, cache, token)
        return M.decode_step(M.gather_params(params, cfg, mesh), cfg, cache,
                             token, mesh)
    return serve_step


# ---------------------------------------------------------------------------
# shape-only inputs (reference ``steps.py:84-159``)
# ---------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, shape: InputShape, mesh=None,
                kind: Optional[str] = None) -> Dict[str, Any]:
    """The data batch of ``shape`` (reference ``steps.py:84-110``): tokens
    (and labels, training) int32 [B, S - frontend_seq], with the VLM's
    ``patches`` [B, frontend_seq, d] and whisper's ``frames`` [B,
    enc_seq, d] in the compute dtype; or the decode token int32 [B, 1].
    On a layout ``mesh``: one device's rows (``local_batch``)."""
    kind = kind or shape.kind
    b, s = local_batch(shape, mesh), shape.seq_len
    i32, dt = torch.int32, M._dt(cfg)

    def empty(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device=TRACE_DEVICE)
    if kind not in ("train", "prefill"):
        return {"token": empty((b, 1), i32)}
    s_text = s - (cfg.frontend_seq or 0)
    out = {"tokens": empty((b, s_text), i32)}
    if kind == "train":
        out["labels"] = empty((b, s_text), i32)
    if cfg.frontend_seq:
        out["patches"] = empty((b, cfg.frontend_seq, cfg.d_model), dt)
    if cfg.n_enc_layers:
        out["frames"] = empty((b, cfg.enc_seq, cfg.d_model), dt)
    return out


def local_batch(shape: InputShape, mesh=None) -> int:
    """The rows of ``shape``'s batch the run shards hold: a layout mesh's
    shard 0 holds its block over the batch axes (the whole batch when it
    does not divide, as ``long_500k``'s one row); otherwise all."""
    b = shape.global_batch
    if mesh is None or not mesh.layout:
        return b
    dp = math.prod(mesh.sizes[a] for a in sh._axes(sh.batch_mesh_axes(mesh)))
    return b // dp if b % dp == 0 else b


def cache_shape_specs(cfg: ModelConfig, shape: InputShape, mesh=None):
    """The empty decode cache at ``shape`` (``init_cache``'s tree; its
    ``pos`` is the Python int 0); with ``mesh``, one a run shard, at its
    replica's rows and its heads."""
    if mesh is None:
        return M.init_cache(cfg, shape.global_batch, shape.seq_len,
                            device=TRACE_DEVICE)
    reps = M.replicas(mesh)
    b = local_batch(shape, mesh) // len(reps)
    out = [None] * len(mesh.traced)
    for tp, idx in reps:
        for i, pos in zip(idx, tp.positions):
            out[i] = M.init_cache(cfg, b, shape.seq_len, device=TRACE_DEVICE,
                                  tp=tp, pos=pos)
    return out


def abstract_state(cfg: ModelConfig, mesh=None, with_opt: bool = True,
                   seed: int = 0):
    """``(params, opt_state)`` as shape-only tensors: training keeps f32
    master weights and f32 AdamW ``mu`` / ``nu`` (and an int32 step);
    serving (``with_opt=False``) models a deployment checkpoint in the
    compute dtype, and ``opt_state`` is None.  ``mesh``: one tree a run
    shard of each (``model.shard_params``)."""
    serve_dt = torch.bfloat16 if cfg.dtype == "bfloat16" else F32
    params = M.init_model(torch.Generator().manual_seed(seed), cfg,
                          device=TRACE_DEVICE,
                          dtype=F32 if with_opt else serve_dt)
    if mesh is not None:
        params = M.shard_params(params, cfg, mesh)
        if not with_opt:
            return params, None
        return params, [adamw(0.0).init(p) for p in params]
    if not with_opt:
        return params, None
    return params, adamw(0.0).init(params)
