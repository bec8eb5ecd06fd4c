"""Step functions of the LM (reference ``repro/models/steps.py``): the
AdamW ``train_step`` (loss, gradients, optional gradient accumulation
over micro-batches), ``prefill_step`` and ``serve_step``; and the
shape-only inputs of every assigned input shape for the dry-run
(``batch_specs``, ``cache_shape_specs``, ``abstract_state``), which
allocate nothing.

The reference returns ``ShapeDtypeStruct``s with shardings attached.
Here they are meta tensors (``device.TRACE_DEVICE``; fake tensors when
called under ``FakeTensorMode``) with the reference's shapes and
dtypes.  On one card
a mesh places nothing, so ``mesh`` is accepted and not read."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils._pytree import tree_map

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.device import TRACE_DEVICE
from repro_torch.models import model as M
from repro_torch.optim import adamw, cosine_schedule, value_and_grad

F32 = torch.float32
METRICS = ("loss", "aux", "acc")


def _value_and_grad(params, cfg: ModelConfig, batch):
    """The gradients of ``forward_train``'s total and its metrics."""
    _, metrics, grads = value_and_grad(
        lambda p: M.forward_train(p, cfg, batch), params)
    return grads, {k: metrics[k].detach() for k in METRICS}


def accumulate_grads(params, cfg: ModelConfig, batch, microbatches: int = 1):
    """``(grads, metrics)`` of one train step before its update: with
    ``microbatches > 1`` the batch splits along dim 0 and the gradients
    accumulate in f32 over the micro-batches, one after another (the
    reference's ``lax.scan``: it bounds activation memory at a fixed
    global batch); gradients and metrics are divided by the count."""
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    if microbatches == 1:
        return _value_and_grad(params, cfg, batch)
    b = next(iter(batch.values())).shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} does not split into "
                         f"{microbatches} micro-batches")
    m = b // microbatches
    grads, msum = None, None
    for i in range(microbatches):
        mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
        g, mets = _value_and_grad(params, cfg, mb)
        if grads is None:
            grads = tree_map(lambda x: x.to(F32), g)
            msum = mets
        else:
            tree_map(lambda a, x: a.add_(x.to(F32)), grads, g)
            msum = {k: msum[k] + mets[k] for k in METRICS}
        del g           # free before the next micro-batch's backward
    grads = tree_map(lambda x: x.div_(microbatches), grads)
    return grads, {k: v / microbatches for k, v in msum.items()}


def make_train_step(cfg: ModelConfig, optimizer=None, microbatches: int = 1):
    """``(opt, train_step)``: AdamW (``cosine_schedule(3e-4, 100,
    10_000)``, weight decay 0.1) unless ``optimizer`` is given, and
    ``train_step(params, opt_state, batch) -> (new_params, new_state,
    metrics)``, the update of ``accumulate_grads``' gradients.  The
    update is functional, as the reference's: the caller's trees are
    left as they were."""
    opt = optimizer or adamw(cosine_schedule(3e-4, 100, 10_000),
                             weight_decay=0.1)
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")

    def train_step(params, opt_state, batch):
        grads, metrics = accumulate_grads(params, cfg, batch, microbatches)
        with torch.no_grad():
            new_params, new_state = opt.update(grads, opt_state, params)
        return new_params, new_state, metrics

    return opt, train_step


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, batch, max_len=None) -> (last_logits,
    cache)``, the flash-attention kernel in every causal self-attention;
    ``batch`` holds ``patches`` (VLM) or ``frames`` (audio) beside the
    tokens where the family takes them."""
    def prefill_step(params, batch, max_len: Optional[int] = None):
        return M.prefill(params, cfg, batch, max_len)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """``serve_step(params, cache, token) -> (logits, cache)``."""
    def serve_step(params, cache, token):
        return M.decode_step(params, cfg, cache, token)
    return serve_step


# ---------------------------------------------------------------------------
# shape-only inputs (reference ``steps.py:84-159``)
# ---------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, shape: InputShape, mesh=None,
                kind: Optional[str] = None) -> Dict[str, Any]:
    """The data batch of ``shape`` (reference ``steps.py:84-110``): tokens
    (and labels, training) int32 [B, S - frontend_seq], with the VLM's
    ``patches`` [B, frontend_seq, d] and whisper's ``frames`` [B,
    enc_seq, d] in the compute dtype; or the decode token int32 [B, 1]."""
    kind = kind or shape.kind
    b, s = shape.global_batch, shape.seq_len
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


def cache_shape_specs(cfg: ModelConfig, shape: InputShape, mesh=None):
    """The empty decode cache at ``shape`` (``init_cache``'s tree; its
    ``pos`` is the Python int 0)."""
    return M.init_cache(cfg, shape.global_batch, shape.seq_len,
                        device=TRACE_DEVICE)


def abstract_state(cfg: ModelConfig, mesh=None, with_opt: bool = True,
                   seed: int = 0):
    """``(params, opt_state)`` as shape-only tensors: training keeps f32
    master weights and f32 AdamW ``mu`` / ``nu`` (and an int32 step);
    serving (``with_opt=False``) models a deployment checkpoint in the
    compute dtype, and ``opt_state`` is None."""
    serve_dt = torch.bfloat16 if cfg.dtype == "bfloat16" else F32
    params = M.init_model(torch.Generator().manual_seed(seed), cfg,
                          device=TRACE_DEVICE,
                          dtype=F32 if with_opt else serve_dt)
    if not with_opt:
        return params, None
    return params, adamw(0.0).init(params)
