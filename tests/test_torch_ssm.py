"""The port's Mamba2 / SSD block (``repro_torch.models.ssm``) against the
live reference (``repro.models.ssm``) on the same numpy inputs and the
reference's weights, f32 at 1e-5: ``ssd_chunked`` at S < 256 (one
chunk of S), 256 and 512 (two chunks: the inter-chunk recurrence), with
and without an initial state; ``mamba_block`` prefill, then decode steps
against the reference's decode and against a prefill over the longer
sequence; gradients against ``jax.grad`` at 1e-3; and the SSD heads
padded to a multiple of 16 (24 -> 32) staying exactly zero, with the
gated norm over the valid channels only (the padded block equals the
same block built without padding)."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as ref_get_config  # noqa: E402
from repro.models import ssm as RSSM  # noqa: E402

from repro_torch import sharding as sh  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=tol)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _ssd_inputs(rng, b, s, h, p, n):
    return (rng.normal(size=(b, s, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.2, size=(b, s, h)).astype(np.float32),
            -rng.uniform(0.5, 2.0, size=(h,)).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32))


@pytest.mark.parametrize("s", [32, 100, 256, 512])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(s, with_state, rng):
    b, h, p, n = 2, 3, 4, 8
    ins = _ssd_inputs(rng, b, s, h, p, n)
    st = rng.normal(size=(b, h, p, n)).astype(np.float32) \
        if with_state else None
    want_y, want_st = RSSM.ssd_chunked(
        *(jnp.asarray(a) for a in ins),
        init_state=None if st is None else jnp.asarray(st))
    got_y, got_st = SSM.ssd_chunked(*(_t(a) for a in ins),
                                    init_state=None if st is None else _t(st))
    assert got_st.dtype == torch.float32
    _close(got_y, want_y, 1e-5)
    _close(got_st, want_st, 1e-5)


def test_ssd_chunked_continues_from_its_state(rng):
    """ssd(x[:256]) then ssd(x[256:], state) equals ssd(x) over 512."""
    ins = [_t(a) for a in _ssd_inputs(rng, 1, 512, 2, 4, 8)]
    y_all, fin_all = SSM.ssd_chunked(*ins)
    first = [a[:, :256] if a.dim() > 1 else a for a in ins]
    rest = [a[:, 256:] if a.dim() > 1 else a for a in ins]
    y1, st = SSM.ssd_chunked(*first)
    y2, fin = SSM.ssd_chunked(*rest, init_state=st)
    _close(torch.cat([y1, y2], 1), y_all, 1e-5)
    _close(fin, fin_all, 1e-5)


def test_ssd_chunked_refuses_a_ragged_sequence(rng):
    ins = [_t(a) for a in _ssd_inputs(rng, 1, 300, 2, 4, 8)]
    with pytest.raises(ValueError, match="chunk"):
        SSM.ssd_chunked(*ins)


def _cfgs(**kw):
    rcfg = dataclasses.replace(ref_get_config("mamba2-130m", smoke=True),
                               **kw)
    return rcfg, ModelConfig(**dataclasses.asdict(rcfg))


def _mamba(rcfg, seed=0):
    ref = RSSM.init_mamba(jax.random.key(seed), rcfg)
    return ref, {k: _t(v) for k, v in ref.items()}


@pytest.mark.parametrize("kw", [{}, {"d_model": 96, "ssm_head_dim": 8}])
def test_prefill_then_decode_match_reference(kw, rng):
    """Prefill over 128 positions, then 4 decode steps from its states:
    output and every state against the reference's, and each decode
    step's output and state against a prefill over the sequence up to
    its position (one chunk of 129-132 positions)."""
    rcfg, cfg = _cfgs(**kw)
    ref, port = _mamba(rcfg)
    s, extra = 128, 4
    x = rng.normal(size=(2, s + extra, cfg.d_model)).astype(np.float32)
    want, (wst, wcx, wcb) = RSSM.mamba_block(ref, jnp.asarray(x[:, :s]), rcfg)
    got, (st, cx, cb) = SSM.mamba_block(port, _t(x[:, :s]), cfg)
    for a, c in ((got, want), (st, wst), (cx, wcx), (cb, wcb)):
        _close(a, c, 1e-5)
    for t in range(extra):
        xt = x[:, s + t:s + t + 1]
        want, (wst, wcx, wcb) = RSSM.mamba_block(
            ref, jnp.asarray(xt), rcfg, state=wst, conv_x_state=wcx,
            conv_bc_state=wcb, decode=True)
        got, (st, cx, cb) = SSM.mamba_block(
            port, _t(xt), cfg, state=st, conv_x_state=cx, conv_bc_state=cb,
            decode=True)
        for a, c in ((got, want), (st, wst), (cx, wcx), (cb, wcb)):
            _close(a, c, 1e-5)
        # the same position through one prefill of the extended sequence
        full, (fst, _, _) = SSM.mamba_block(port, _t(x[:, :s + t + 1]), cfg)
        _close(got[:, 0], full[:, -1], 1e-4)
        _close(st, fst, 1e-4)


def test_prefill_over_two_chunks_matches_reference(rng):
    rcfg, cfg = _cfgs()
    ref, port = _mamba(rcfg, 3)
    x = rng.normal(size=(1, 512, cfg.d_model)).astype(np.float32)
    want, (wst, _, _) = RSSM.mamba_block(ref, jnp.asarray(x), rcfg)
    got, (st, _, _) = SSM.mamba_block(port, _t(x), cfg)
    _close(got, want, 1e-5)
    _close(st, wst, 1e-5)


def test_gradients_match_jax_grad(rng):
    rcfg, cfg = _cfgs()
    ref, port = _mamba(rcfg, 1)
    x = rng.normal(size=(2, 64, cfg.d_model)).astype(np.float32)
    c = rng.normal(size=x.shape).astype(np.float32)

    def rloss(p, xx):
        return jnp.sum(RSSM.mamba_block(p, xx, rcfg)[0] * c)
    gp, gx = jax.grad(rloss, argnums=(0, 1))(ref, jnp.asarray(x))
    tp = {k: v.clone().requires_grad_(True) for k, v in port.items()}
    tx = _t(x).requires_grad_(True)
    torch.sum(SSM.mamba_block(tp, tx, cfg)[0] * _t(c)).backward()
    for k in tp:
        want = np.asarray(gp[k])
        np.testing.assert_allclose(tp[k].grad.numpy(), want,
                                   atol=1e-3 * max(np.abs(want).max(), 1e-30),
                                   rtol=0, err_msg=k)
    want = np.asarray(gx)
    np.testing.assert_allclose(tx.grad.numpy(), want,
                               atol=1e-3 * np.abs(want).max(), rtol=0)


def test_padded_heads_stay_zero_and_norm_over_valid_channels(rng,
                                                             monkeypatch):
    """d_model 96, expand 2, head dim 8: 24 SSD heads padded to 32, as
    mamba2-130m's 24 are.  The dead heads' weights, state and outputs
    are exactly zero; the block equals the reference's at 1e-5 and the
    same block built without padding (the valid slices of every weight)
    at 1e-5, so the gated norm divides by the 192 valid channels."""
    rcfg, cfg = _cfgs(d_model=96, ssm_head_dim=8)
    d_in, h, p, n = SSM.ssm_dims(cfg)
    assert (d_in, h, p) == (256, 32, 8) and SSM.ssm_valid_d_in(cfg) == 192
    ref, port = _mamba(rcfg, 2)
    got_init = SSM.init_mamba(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    assert {k: tuple(v.shape) for k, v in got_init.items()} == \
        {k: v.shape for k, v in ref.items()}
    for params in (port, got_init):
        for k in ("w_z", "w_x", "conv_x"):
            assert bool((params[k][:, 192:] == 0).all()), k
        assert bool((params["w_out"][192:] == 0).all())
        assert bool((params["w_dt"][:, 24:] == 0).all())
        assert bool((params["D"][24:] == 0).all())
    x = rng.normal(size=(2, 256, cfg.d_model)).astype(np.float32)
    got, (st, cx, _) = SSM.mamba_block(port, _t(x), cfg)
    _close(got, RSSM.mamba_block(ref, jnp.asarray(x), rcfg)[0], 1e-5)
    assert bool((st[:, 24:] == 0).all()) and bool((cx[..., 192:] == 0).all())
    # the same block with no head padding: the valid slices only
    monkeypatch.setattr(sh, "padded_heads", lambda n_: n_)
    assert SSM.ssm_dims(cfg)[:2] == (192, 24)
    valid = {k: v for k, v in port.items()}
    for k in ("w_z", "w_x", "conv_x"):
        valid[k] = port[k][:, :192]
    for k in ("dt_bias", "A_log", "D"):
        valid[k] = port[k][:24]
    valid["w_dt"] = port["w_dt"][:, :24]
    valid["norm"] = port["norm"][:192]
    valid["w_out"] = port["w_out"][:192]
    unpadded, (ust, _, _) = SSM.mamba_block(valid, _t(x), cfg)
    _close(got, unpadded, 1e-5)
    _close(st[:, :24], ust, 1e-5)
