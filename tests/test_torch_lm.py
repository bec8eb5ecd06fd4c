"""The port's dense decoder against the live reference (``repro.models``):
the layers at 1e-5 (f32), then the serving path of the gemma3-12b,
granite-3-2b and stablelm-1.6b smoke configs with the reference's own
weights carried over by ``params_from_numpy`` — the prefill's last
logits and every cache leaf, then 8 greedy decode steps with equal
tokens — at 1e-4 (f32; sums taken in another order), and one bf16
variant at 2e-2 (relative max error: bf16 rounds at other points in the
two frameworks).  On these CPU tensors the flash op takes its plain
version; the CUDA kernel is held against it on the card by chip_smoke.py
and tests/test_torch_cuda.py."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as ref_get_config  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402

from repro_torch.configs.base import LM_ARCHS, ModelConfig, get_config  # noqa: E402
from repro_torch.kernels.flash_attn import ops as fa  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import steps  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
DENSE = ["gemma3-12b", "granite-3-2b", "stablelm-1.6b"]


def _np(x):
    return np.asarray(x, np.float32)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma3-12b", "gemma-7b", "granite-3-2b",
                                  "stablelm-1.6b"])
@pytest.mark.parametrize("smoke", [False, True])
def test_dense_configs_equal_reference(arch, smoke):
    got = get_config(arch, smoke=smoke)
    assert isinstance(got, ModelConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        ref_get_config(arch, smoke=smoke))


@pytest.mark.parametrize("arch", sorted(set(LM_ARCHS) - {
    "gemma3-12b", "gemma-7b", "granite-3-2b", "stablelm-1.6b"}))
def test_non_dense_archs_raise(arch):
    with pytest.raises(NotImplementedError, match="later LM slice"):
        get_config(arch)
    cfg = ref_get_config(arch, smoke=True)
    port_cfg = ModelConfig(**dataclasses.asdict(cfg))
    with pytest.raises(NotImplementedError, match="later LM slice"):
        M.init_model(torch.Generator().manual_seed(0), port_cfg, CPU)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _layer_cfg(arch="gemma3-12b"):
    return ref_get_config(arch, smoke=True), get_config(arch, smoke=True)


def test_rms_norm_and_rope(rng):
    x = rng.normal(size=(2, 8, 4, 32)).astype(np.float32)
    s = rng.normal(size=(32,)).astype(np.float32)
    _close(L.rms_norm(_t(x), _t(s), 1e-6),
           RL.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6), 1e-5)
    pos = np.arange(100, 108)
    _close(L.apply_rope(_t(x), torch.tensor(pos), 10000.0),
           RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0), 1e-5)
    _close(L.apply_rope(_t(x), torch.tensor(pos), 1_000_000.0),
           RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1_000_000.0),
           1e-5)


def _attn_params(cfg, seed=1):
    ref = RL.init_attention(jax.random.key(seed), cfg)
    return ref, {k: _t(v) for k, v in ref.items()}


def test_qkv_and_out_proj(rng):
    rcfg, cfg = _layer_cfg()
    ref, port = _attn_params(rcfg)
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    pos = np.arange(16)
    want = RL.qkv(ref, jnp.asarray(x), rcfg, jnp.asarray(pos), True)
    got = L.qkv(port, _t(x), cfg, torch.tensor(pos), True)
    for a, b in zip(got, want):
        _close(a, b, 1e-5)
    _close(L.out_proj(port, got[0], torch.float32),
           RL.out_proj(ref, want[0], jnp.float32), 1e-5)


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_mlp_block(act, rng):
    rcfg = dataclasses.replace(ref_get_config("gemma3-12b", smoke=True),
                               mlp_act=act)
    cfg = ModelConfig(**dataclasses.asdict(rcfg))
    ref = RL.init_mlp(jax.random.key(2), rcfg)
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    _close(L.mlp_block({k: _t(v) for k, v in ref.items()}, _t(x), cfg),
           RL.mlp_block(ref, jnp.asarray(x), rcfg), 1e-5)


@pytest.mark.parametrize("ltype", ["local", "attn"])
@pytest.mark.parametrize("kernel", [True, False])
def test_attention_block(ltype, kernel, rng):
    """Both of the port's attention paths (the flash op, here its plain
    version, and the chunked path) against the reference's chunked path;
    s = 128 with the smoke window 64 and q_chunk 32."""
    rcfg, cfg = _layer_cfg()
    ref, port = _attn_params(rcfg, 3)
    x = rng.normal(size=(2, 128, cfg.d_model)).astype(np.float32)
    pos = np.arange(128)
    want, (wk, wv) = RL.attention_block(ref, jnp.asarray(x), rcfg, ltype,
                                        jnp.asarray(pos))
    got, (k, v) = L.attention_block(port, _t(x), cfg, ltype,
                                    torch.tensor(pos), kernel=kernel)
    _close(got, want, 1e-5)
    _close(k, wk, 1e-5)
    _close(v, wv, 1e-5)


def test_direct_attention(rng):
    q, k, v = (rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
               for _ in range(3))
    mask = rng.random((1, 1, 5, 5)) > 0.3
    mask[..., 0] = True
    _close(L.direct_attention(_t(q), _t(k), _t(v), torch.tensor(mask),
                              torch.float32),
           RL.direct_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(mask),
                               jnp.float32), 1e-5)


def test_init_attention_zeroes_padded_query_heads():
    """20 query heads pad to 32 (a multiple of 16); the padded heads are
    zero in wq and wo, as in the reference, and the shapes match."""
    rcfg = dataclasses.replace(ref_get_config("granite-3-2b", smoke=True),
                               n_heads=20, n_kv_heads=4, head_dim=8)
    cfg = ModelConfig(**dataclasses.asdict(rcfg))
    ref = RL.init_attention(jax.random.key(0), rcfg)
    got = L.init_attention(torch.Generator().manual_seed(0), cfg,
                           device=CPU)
    for name in ref:
        assert tuple(got[name].shape) == ref[name].shape
    assert got["wq"].shape[1] == 32
    assert bool((got["wq"][:, 20:] == 0).all())
    assert bool((got["wo"][20:] == 0).all())
    assert bool((got["wq"][:, :20] != 0).any())


@pytest.mark.parametrize("window", [0, 64])
def test_decode_attention(window, rng):
    rcfg, cfg = _layer_cfg()
    ref, port = _attn_params(rcfg, 4)
    b, cap, pos = 2, 96, 90
    x = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
    kc = rng.normal(size=(b, cap, cfg.n_kv_heads, 32)).astype(np.float32)
    vc = rng.normal(size=(b, cap, cfg.n_kv_heads, 32)).astype(np.float32)
    slots = np.where(np.arange(cap) < 80, np.arange(cap), -1).astype(np.int32)
    want = RL.decode_attention(ref, jnp.asarray(x), rcfg, jnp.asarray(kc),
                               jnp.asarray(vc), jnp.asarray(slots), pos,
                               window=window)
    got = L.decode_attention(port, _t(x), cfg, _t(kc), _t(vc),
                             torch.tensor(slots), pos, window=window)
    for a, c in zip(got, want):
        _close(a, c, 1e-5)


# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------

def _models(arch, dtype="float32"):
    """Reference and port configs and weights of a smoke config;
    ``<arch>+shared_attn`` puts a weight-shared attention block between
    two layers."""
    base, _, shared = arch.partition("+")
    rcfg = dataclasses.replace(ref_get_config(base, smoke=True), dtype=dtype)
    if shared:
        rcfg = dataclasses.replace(rcfg, n_layers=3, layer_pattern=(
            "attn", "shared_attn", "attn"))
    cfg = ModelConfig(**dataclasses.asdict(rcfg))
    ref = RM.init_model(jax.random.key(1), rcfg)
    port = M.params_from_numpy(jax.tree.map(np.asarray, ref), CPU)
    return rcfg, cfg, ref, port


def _leaves_close(got_cache, want_cache, tol):
    assert int(got_cache["pos"]) == int(want_cache["pos"])
    for rc, wc in zip(got_cache["runs"], want_cache["runs"]):
        assert set(rc) == set(wc)
        for key in rc:
            _close(rc[key], wc[key], tol)
        np.testing.assert_array_equal(rc["slot_pos"].numpy(),
                                      np.asarray(wc["slot_pos"]))


@pytest.mark.parametrize("arch", DENSE + ["granite-3-2b+shared_attn"])
def test_prefill_and_greedy_decode_match_reference(arch, rng):
    rcfg, cfg, ref, port = _models(arch)
    b, s, gen = 2, 64, 8
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    want, wcache = jax.jit(lambda p, bb: RM.prefill(p, rcfg, bb,
                                                    max_len=s + gen))(
        ref, {"tokens": jnp.asarray(toks)})
    prefill = steps.make_prefill_step(cfg)
    decode = steps.make_serve_step(cfg)
    with torch.inference_mode():
        got, cache = prefill(port, {"tokens": torch.tensor(toks)}, s + gen)
    _close(got, want, 1e-4)
    _leaves_close(cache, wcache, 1e-4)

    rdec = jax.jit(lambda p, c, t: RM.decode_step(p, rcfg, c, t))
    wtok = jnp.argmax(want, -1)[:, None].astype(jnp.int32)
    tok = got.argmax(-1)[:, None]
    for i in range(gen):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(wtok),
                                      err_msg=f"{arch} step {i}")
        want, wcache = rdec(ref, wcache, wtok)
        with torch.inference_mode():
            got, cache = decode(port, cache, tok)
        _close(got, want, 1e-4)
        wtok = jnp.argmax(want, -1)[:, None].astype(jnp.int32)
        tok = got.argmax(-1)[:, None]
    _leaves_close(cache, wcache, 1e-4)


def test_bf16_prefill_and_decode_match_reference(rng):
    """gemma3-12b smoke in bf16 (f32 master weights cast at use on both
    sides), teacher-forced with the same tokens: relative max error of
    every logit row within 2e-2."""
    rcfg, cfg, ref, port = _models("gemma3-12b", "bfloat16")
    b, s = 2, 64
    toks = rng.integers(0, cfg.vocab_size, (b, s + 4)).astype(np.int32)
    want, wcache = RM.prefill(ref, rcfg, {"tokens": jnp.asarray(
        toks[:, :s])}, max_len=s + 4)
    with torch.inference_mode():
        got, cache = M.prefill(port, cfg, {"tokens": torch.tensor(
            toks[:, :s])}, s + 4)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float(), want) <= 2e-2
    for t in range(4):
        nxt = toks[:, s + t:s + t + 1]
        want, wcache = RM.decode_step(ref, rcfg, wcache, jnp.asarray(nxt))
        with torch.inference_mode():
            got, cache = M.decode_step(port, cfg, cache, torch.tensor(nxt))
        assert _rel(got.float(), want) <= 2e-2, t


@pytest.mark.parametrize("arch", ["gemma3-12b", "gemma-7b", "granite-3-2b",
                                  "stablelm-1.6b"])
def test_decode_matches_forward(arch, rng):
    """The port of tests/test_attention.py::test_decode_matches_forward
    for the dense archs: teacher-forced decode logits equal the full
    forward's (s = 64, a multiple of the smoke window)."""
    cfg = get_config(arch, smoke=True)
    params = M.init_model(torch.Generator().manual_seed(1), cfg, CPU)
    b, s, extra = 2, 64, 32
    toks = torch.tensor(rng.integers(1, cfg.vocab_size, (b, s + extra)))
    with torch.inference_mode():
        x = M.embed_tokens(params, cfg, toks)
        hid, _ = M.backbone(params, cfg, x, torch.arange(s + extra))
        ref_logits = M.logits_fn(params, cfg, hid)
        last, cache = M.prefill(params, cfg, {"tokens": toks[:, :s]},
                                max_len=s + extra)
        _close(last, ref_logits[:, s - 1], 2e-3)
        for t in range(extra):
            lg, cache = M.decode_step(params, cfg, cache,
                                      toks[:, s + t:s + t + 1])
            _close(lg, ref_logits[:, s + t], 8e-3)


def test_prefill_paths_agree_and_count_no_launch_on_cpu(rng):
    """The flash op (its plain version on CPU) and the chunked path give
    the same prefill; on CPU tensors the kernel's counter stays put."""
    _, cfg, _, port = _models("gemma3-12b")
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 96)))
    before = fa.launches
    with torch.inference_mode():
        a, ca = M.prefill(port, cfg, {"tokens": toks}, kernel=True)
        c, cc = M.prefill(port, cfg, {"tokens": toks}, kernel=False)
    assert fa.launches == before
    _close(a, c, 1e-5)
    _leaves_close(ca, cc, 1e-5)


def test_vocab_padding_is_masked():
    cfg = dataclasses.replace(get_config("granite-3-2b", smoke=True),
                              vocab_size=500)
    params = M.init_model(torch.Generator().manual_seed(0), cfg, CPU)
    assert params["embed"].shape[0] == 512
    with torch.inference_mode():
        last, _ = M.prefill(params, cfg, {"tokens": torch.zeros(
            1, 32, dtype=torch.long)})
    assert bool((last[:, 500:] == -1e30).all())
    assert bool(torch.isfinite(last[:, :500]).all())


def test_serve_cli_prints_reference_keys():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"),
                                         env.get("PYTHONPATH", "")])
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma3-12b", "--smoke", "--device", "cpu", "--temperature", "0",
         "--gen", "6"], cwd=REPO, capture_output=True, text=True, env=env,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout)
    assert {"arch", "prefill_s", "decode_tok_per_s", "generated_shape",
            "sample_tokens"} <= set(res)
    assert res["generated_shape"] == [4, 6]
    assert all(0 <= t < 512 for t in res["sample_tokens"])


@pytest.mark.parametrize("s", [96, 100, 128])
def test_ring_placement_mirrors_reference_at_ragged_prompt(rng, s):
    """The ring caches hold position p in slot p % cap after prefill as
    after decode, also when the prompt (s = 96, 100) is not a multiple of
    the smoke window 64: 8 decode steps equal the port's full forward
    over the extended sequence at 1e-4.  The reference's prefill puts the
    newest 64 positions in slots 0..63, so from its second decode step on
    it overwrites a key still inside the window (ROADMAP.md Queue 3): the
    port leaves it there on purpose, and equals its decode only where the
    layouts agree, at a multiple of the window (s = 128), at 1e-4."""
    rcfg, cfg, ref, port = _models("gemma3-12b")
    b, extra = 2, 8
    toks = rng.integers(0, cfg.vocab_size, (b, s + extra)).astype(np.int32)
    with_ref = s % cfg.sliding_window == 0  # (its prefill takes no s = 100)
    if with_ref:
        _, wcache = RM.prefill(ref, rcfg,
                               {"tokens": jnp.asarray(toks[:, :s])},
                               max_len=s + extra)
    with torch.inference_mode():
        _, cache = M.prefill(port, cfg, {"tokens": torch.tensor(
            toks[:, :s])}, s + extra)
        x = M.embed_tokens(port, cfg, torch.tensor(toks))
        hid, _ = M.backbone(port, cfg, x, torch.arange(s + extra))
        fwd = M.logits_fn(port, cfg, hid)
    for t in range(extra):
        nxt = toks[:, s + t:s + t + 1]
        with torch.inference_mode():
            got, cache = M.decode_step(port, cfg, cache, torch.tensor(nxt))
        _close(got, fwd[:, s + t], 1e-4)
        if with_ref:
            want, wcache = RM.decode_step(ref, rcfg, wcache,
                                          jnp.asarray(nxt))
            _close(got, want, 1e-4)
