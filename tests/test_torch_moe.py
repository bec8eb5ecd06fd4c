"""The port's MoE block (``repro_torch.models.moe``) against the live
reference (``repro.models.moe``) on the same numpy inputs and the
reference's weights: the output and the load-balance aux at 1e-5 (f32),
the cases of tests/test_moe.py (one expert with room for every token is
its dense FFN, a capacity that drops overflow to zero rows, one token
per group in decode), an index past the capacity that F.one_hot would
refuse, and the gradients of the output and the aux against
``jax.grad`` at 1e-3."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as ref_get_config  # noqa: E402
from repro.models import moe as RMOE  # noqa: E402

from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402


def _cfgs(**kw):
    rcfg = dataclasses.replace(
        ref_get_config("llama4-scout-17b-a16e", smoke=True), **kw)
    return rcfg, ModelConfig(**dataclasses.asdict(rcfg))


def _params(rcfg, seed=0):
    ref = RMOE.init_moe(jax.random.key(seed), rcfg)
    return ref, {k: torch.tensor(np.asarray(v)) for k, v in ref.items()}


def _x(rng, b, s, d):
    return rng.normal(size=(b, s, d)).astype(np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("kw,s", [({}, 64), ({}, 32), ({"moe_group": 16}, 64),
                                  ({"capacity_factor": 0.5}, 64),
                                  ({"mlp_act": "gelu"}, 64)])
def test_moe_block_matches_reference(kw, s, rng):
    """Output and aux at 1e-5 over groups of 32 (and 16), at the smoke
    capacity factor, one that drops many tokens, and with GeGLU."""
    rcfg, cfg = _cfgs(**kw)
    ref, port = _params(rcfg)
    x = _x(rng, 2, s, cfg.d_model)
    want, waux = RMOE.moe_block(ref, jnp.asarray(x), rcfg)
    got, aux = MOE.moe_block(port, torch.tensor(x), cfg)
    assert got.shape == (2, s, cfg.d_model)
    _close(got, want, 1e-5)
    _close(aux, waux, 1e-5)


def test_init_moe_layout_equals_reference():
    rcfg, cfg = _cfgs()
    ref = RMOE.init_moe(jax.random.key(0), rcfg)
    got = MOE.init_moe(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in ref.items()}
    assert MOE.capacity(cfg, 32) == RMOE.capacity(rcfg, 32) == 10


def test_one_expert_with_room_for_all_is_its_dense_ffn(rng):
    """With a single expert and a huge capacity, MoE == its FFN."""
    rcfg, cfg = _cfgs(n_experts=1, capacity_factor=64.0)
    ref, port = _params(rcfg)
    x = _x(rng, 1, 32, cfg.d_model)
    got, _ = MOE.moe_block(port, torch.tensor(x), cfg)
    t = torch.tensor(x)
    dense = (torch.nn.functional.silu(t @ port["w_gate"][0])
             * (t @ port["w_up"][0])) @ port["w_down"][0]
    _close(got, dense, 1e-4)
    _close(got, RMOE.moe_block(ref, jnp.asarray(x), rcfg)[0], 1e-5)


def test_overflow_drops_to_zero_rows(rng):
    """A capacity factor of ~0 clamps to one slot an expert a group: most
    tokens are dropped (zero rows), the same ones as in the reference."""
    rcfg, cfg = _cfgs(capacity_factor=1e-9)
    ref, port = _params(rcfg)
    x = _x(rng, 1, 64, cfg.d_model)
    got, _ = MOE.moe_block(port, torch.tensor(x), cfg)
    want, _ = RMOE.moe_block(ref, jnp.asarray(x), rcfg)
    zero = got.abs().sum(-1) < 1e-6
    assert float(zero.float().mean()) > 0.3
    np.testing.assert_array_equal(
        zero.numpy(), np.abs(np.asarray(want)).sum(-1) < 1e-6)
    _close(got, want, 1e-5)


def test_dropped_and_unrouted_tokens_give_zero_dispatch_rows(rng):
    """Queue positions of -1 (another expert) and >= capacity (dropped)
    both give zero dispatch rows, as ``jax.nn.one_hot`` does; every kept
    token has exactly one slot."""
    _, cfg = _cfgs(capacity_factor=0.25)
    _, port = _params(_cfgs(capacity_factor=0.25)[0])
    x = torch.tensor(_x(rng, 2, 64, cfg.d_model))
    dispatch, _, expert, _, g, tg = MOE.route(port, x, cfg)
    per_token = dispatch.sum((-1, -2))                  # [b, g, t]
    assert set(per_token.unique().tolist()) <= {0.0, 1.0}
    assert 0 < float(per_token.mean()) < 1
    onehot = torch.nn.functional.one_hot(expert, cfg.n_experts)
    assert bool((dispatch.sum(-1) <= onehot).all())
    assert int(dispatch.sum((2, 4)).max()) <= MOE.capacity(cfg, tg)


def test_decode_single_token_is_never_dropped(rng):
    rcfg, cfg = _cfgs()
    ref, port = _params(rcfg)
    x = _x(rng, 4, 1, cfg.d_model)
    got, _ = MOE.moe_block(port, torch.tensor(x), cfg)
    assert got.shape == (4, 1, cfg.d_model)
    assert float(got.abs().sum(-1).min()) > 0
    _close(got, RMOE.moe_block(ref, jnp.asarray(x), rcfg)[0], 1e-5)


def test_group_must_divide_the_sequence(rng):
    _, cfg = _cfgs()
    _, port = _params(_cfgs()[0])
    with pytest.raises(ValueError, match="routing group"):
        MOE.moe_block(port, torch.tensor(_x(rng, 1, 48, cfg.d_model)), cfg)


def test_gradients_match_jax_grad(rng):
    """d(sum(y * c) + aux) / d(params, x) against ``jax.grad`` at 1e-3 of
    each leaf's largest element."""
    rcfg, cfg = _cfgs()
    ref, port = _params(rcfg)
    x = _x(rng, 2, 64, cfg.d_model)
    c = rng.normal(size=x.shape).astype(np.float32)

    def rloss(p, xx):
        y, aux = RMOE.moe_block(p, xx, rcfg)
        return jnp.sum(y * c) + aux
    gp, gx = jax.grad(rloss, argnums=(0, 1))(ref, jnp.asarray(x))
    tp = {k: v.clone().requires_grad_(True) for k, v in port.items()}
    tx = torch.tensor(x, requires_grad=True)
    y, aux = MOE.moe_block(tp, tx, cfg)
    (torch.sum(y * torch.tensor(c)) + aux).backward()
    for k in tp:
        want = np.asarray(gp[k])
        np.testing.assert_allclose(tp[k].grad.numpy(), want,
                                   atol=1e-3 * np.abs(want).max(), rtol=0)
    want = np.asarray(gx)
    np.testing.assert_allclose(tx.grad.numpy(), want,
                               atol=1e-3 * np.abs(want).max(), rtol=0)
