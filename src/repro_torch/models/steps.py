"""Serving step functions of the LM (reference ``repro/models/steps.py:63-72``):
``make_prefill_step`` and ``make_serve_step``.  The train step (loss,
gradients, AdamW on the LM tree) comes with the LM training slice."""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, batch, max_len=None) -> (last_logits,
    cache)``, the flash-attention kernel in every layer."""
    def prefill_step(params, batch, max_len: Optional[int] = None):
        return M.prefill(params, cfg, batch, max_len)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """``serve_step(params, cache, token) -> (logits, cache)``."""
    def serve_step(params, cache, token):
        return M.decode_step(params, cfg, cache, token)
    return serve_step
