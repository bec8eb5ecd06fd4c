"""The port's MoE, SSM, hybrid, audio and VLM families against the live
reference (``repro.models``), for the six smoke configs
(llama4-scout-17b-a16e, llama4-maverick-400b-a17b, mamba2-130m,
zamba2-7b, whisper-medium, internvl2-76b), f32, the reference's weights
carried over by ``params_from_numpy`` and the same numpy inputs (random
patch and frame embeddings for the VLM and whisper):

* the parameter tree's names and shapes, ``param_specs`` and
  ``cache_specs`` equal to the reference's tuples;
* ``forward_train``'s loss, aux and accuracy at 1e-5, and its gradients
  against ``jax.grad`` at 1e-3 of each leaf's largest element;
* the prefill's last logits and every cache leaf at 1e-5, then greedy
  decode steps against the reference's decode (equal tokens) at a prompt
  of 64 positions, a multiple of the smoke window, where the two ring
  layouts agree;
* the dry-run's records on the smoke configs (the flash stand-in once
  per causal self-attention) and its arithmetic on the full configs
  (parameter counts, analytic FLOPs) against the reference's;
* ``launch/train.py --smoke --device cpu`` and ``launch/serve.py`` for
  mamba2-130m and llama4-scout-17b-a16e.

On these CPU tensors the flash op takes its plain version; the CUDA
kernels are held to it on the card by chip_smoke.py (phase 14) and
tests/test_torch_cuda.py."""
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import INPUT_SHAPES as RSHAPES  # noqa: E402
from repro.configs.base import get_config as ref_get_config  # noqa: E402
from repro.launch import roofline as RR  # noqa: E402
from repro.models import model as RM  # noqa: E402

from repro_torch.configs.base import INPUT_SHAPES, InputShape, get_config  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import roofline as R  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import steps as S  # noqa: E402

CPU = torch.device("cpu")
ARCHS = ["llama4-scout-17b-a16e", "llama4-maverick-400b-a17b", "mamba2-130m",
         "zamba2-7b", "whisper-medium", "internvl2-76b"]
PROMPT = 64         # a multiple of the smoke window (64) and q_chunk (32)


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(e is None or isinstance(e, str)
                                        for e in x)


def _flat(tree, prefix=(), leaf=lambda x: False):
    """{path: leaf} of nested dicts / tuples / lists."""
    if leaf(tree) or not isinstance(tree, (dict, tuple, list)):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat(v, prefix + (k,), leaf))
    return out


_MODELS = {}


def _models(arch):
    """(reference config, port config, reference params, port params),
    built once an arch."""
    if arch not in _MODELS:
        rcfg = ref_get_config(arch, smoke=True)
        cfg = get_config(arch, smoke=True)
        ref = RM.init_model(jax.random.key(1), rcfg)
        port = M.params_from_numpy(jax.tree.map(np.asarray, ref), CPU)
        _MODELS[arch] = (rcfg, cfg, ref, port)
    return _MODELS[arch]


def _batch(cfg, seed, b, s, train=False):
    """numpy batch of ``s`` positions (text after the VLM's patches)."""
    rng = np.random.default_rng(seed)
    text = s - cfg.frontend_seq
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, text)).astype(
        np.int32)}
    if train:
        lab = rng.integers(0, cfg.vocab_size, (b, text)).astype(np.int32)
        lab[:, :3] = -1
        out["labels"] = lab
    if cfg.frontend_seq:
        out["patches"] = rng.normal(size=(b, cfg.frontend_seq,
                                          cfg.d_model)).astype(np.float32)
    if cfg.n_enc_layers:
        out["frames"] = rng.normal(size=(b, cfg.enc_seq,
                                         cfg.d_model)).astype(np.float32)
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# parameters and specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_and_specs_equal_reference(arch):
    """The port's own ``init_model`` draws a tree of the reference's names
    and shapes; ``param_specs`` gives the reference's tuples."""
    rcfg, cfg, ref, port = _models(arch)
    want = {k: v.shape for k, v in _flat(jax.tree.map(np.asarray, ref))
            .items()}
    drawn = M.init_model(torch.Generator().manual_seed(0), cfg, CPU)
    assert {k: tuple(v.shape) for k, v in _flat(drawn).items()} == want
    assert {k: tuple(v.shape) for k, v in _flat(port).items()} == want
    got = _flat(M.param_specs(cfg, port), leaf=_is_spec)
    rspecs = _flat(RM.param_specs(rcfg, ref), leaf=_is_spec)
    assert got == rspecs


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_reference(arch):
    rcfg, cfg, ref, port = _models(arch)
    for b, batch_ok in ((2, True), (1, False)):
        cache = M.init_cache(cfg, b, 128, CPU)
        rcache = RM.init_cache(rcfg, b, 128)
        assert {k: tuple(np.shape(v)) for k, v in _flat(cache).items()} == \
            {k: tuple(np.shape(v)) for k, v in _flat(rcache).items()}
        assert _flat(M.cache_specs(cfg, cache, batch_ok), leaf=_is_spec) == \
            _flat(RM.cache_specs(rcfg, rcache, batch_ok), leaf=_is_spec)


# ---------------------------------------------------------------------------
# training forward and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_and_gradients_match_reference(arch):
    rcfg, cfg, ref, port = _models(arch)
    batch = _batch(cfg, 3, 2, PROMPT, train=True)
    (wtotal, wm), wgrads = jax.jit(jax.value_and_grad(
        lambda p, bb: RM.forward_train(p, rcfg, bb), has_aux=True))(
        ref, _j(batch))
    params = jax.tree.map(lambda t: t.clone().requires_grad_(True), port)
    total, m = M.forward_train(params, cfg, _t(batch))
    total.backward()
    _close(total, wtotal, 1e-5)
    for k in ("loss", "aux", "acc"):
        _close(m[k], wm[k], 1e-5)
    if cfg.n_experts:
        assert float(m["aux"].detach()) > 0
    want = _flat(jax.tree.map(np.asarray, wgrads))
    for path, leaf in _flat(params).items():
        w = want[path]
        np.testing.assert_allclose(
            leaf.grad.numpy(), w, rtol=0,
            atol=1e-3 * max(float(np.abs(w).max()), 1e-30), err_msg=path)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _caches_close(cache, wcache, tol):
    assert int(cache["pos"]) == int(wcache["pos"])
    got, want = _flat(cache["runs"]), _flat(wcache["runs"])
    assert set(got) == set(want)
    for path in got:
        if path[-1] == "slot_pos":
            np.testing.assert_array_equal(got[path].numpy(),
                                          np.asarray(want[path]))
        else:
            _close(got[path], want[path], tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match_reference(arch):
    rcfg, cfg, ref, port = _models(arch)
    gen = 4
    batch = _batch(cfg, 5, 2, PROMPT)
    want, wcache = jax.jit(lambda p, bb: RM.prefill(p, rcfg, bb,
                                                    max_len=PROMPT + gen))(
        ref, _j(batch))
    with torch.inference_mode():
        got, cache = S.make_prefill_step(cfg)(port, _t(batch), PROMPT + gen)
    _close(got, want, 1e-5)
    _caches_close(cache, wcache, 1e-5)
    rdec = jax.jit(lambda p, c, t: RM.decode_step(p, rcfg, c, t))
    decode = S.make_serve_step(cfg)
    wtok = jnp.argmax(want, -1)[:, None].astype(jnp.int32)
    tok = got.argmax(-1)[:, None]
    for i in range(gen):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(wtok),
                                      err_msg=f"{arch} step {i}")
        want, wcache = rdec(ref, wcache, wtok)
        with torch.inference_mode():
            got, cache = decode(port, cache, tok)
        _close(got, want, 1e-5)
        wtok = jnp.argmax(want, -1)[:, None].astype(jnp.int32)
        tok = got.argmax(-1)[:, None]
    _caches_close(cache, wcache, 1e-5)


@pytest.mark.parametrize("arch", ["zamba2-7b", "llama4-scout-17b-a16e",
                                  "whisper-medium", "internvl2-76b"])
def test_prefill_paths_agree_and_count_no_launch_on_cpu(arch):
    """The flash op (its plain version here) and the plain chunked path
    give the same prefill; the kernel counters stay put on the CPU."""
    from repro_torch.kernels.flash_attn import ops as fa
    _, cfg, _, port = _models(arch)
    batch = _t(_batch(cfg, 7, 2, PROMPT))
    before = fa.launch_counts()
    with torch.inference_mode():
        a, _ = M.prefill(port, cfg, batch, kernel=True)
        c, _ = M.prefill(port, cfg, batch, kernel=False)
    assert fa.launch_counts() == before
    _close(a, c, 1e-5)


# ---------------------------------------------------------------------------
# the dry-run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_records_on_the_smoke_configs(arch):
    """Train, prefill and decode records of each smoke config at small
    shapes: ``ok``, the reference's parameter specs and totals, and the
    flash stand-in once per causal self-attention of the prefill."""
    rcfg, cfg, ref, _ = _models(arch)
    rspecs = jax.tree_util.tree_map(list, RM.param_specs(rcfg, ref),
                                    is_leaf=_is_spec)
    rtotal = RR.active_param_count(rcfg, ref)
    for kind, s, b in (("train", 128, 4), ("prefill", 128, 2),
                       ("decode", 256, 2)):
        shape = InputShape(f"{kind}_small", kind, s, b)
        rec = DR.dryrun_lm(arch, shape, cfg=cfg)
        assert rec["status"] == "ok", rec
        assert rec["params_total"] == rtotal["total"]
        assert rec["params_active"] == rtotal["active"]
        assert _flat(rec["param_specs"], leaf=lambda x: isinstance(
            x, list) and all(e is None or isinstance(e, str) for e in x)) == \
            _flat(rspecs, leaf=lambda x: isinstance(x, list) and all(
                e is None or isinstance(e, str) for e in x))
        calls = rec["kernel_calls"]
        if kind == "prefill":
            n = M.causal_attention_layers(cfg)
            assert calls == ({"flash_tf32x3": n} if n else {}), calls
        else:
            assert not calls, calls
        assert rec["device_bytes_total"] > 0 and isinstance(
            rec["fits_hbm"], bool)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_flops_equal_reference_on_full_configs(arch):
    """Shape-only parameters of the full config (nothing allocated): the
    reference's totals and active counts, its analytic FLOPs and model
    FLOPs at every input shape, and the same applicability."""
    from repro_torch.configs.base import shape_applicable
    from repro.configs.base import shape_applicable as rapplicable
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    params, _ = S.abstract_state(cfg, with_opt=False)
    rparams = jax.eval_shape(lambda k: RM.init_model(k, rcfg),
                             jax.random.key(0))
    assert R.active_param_count(cfg, params) == \
        RR.active_param_count(rcfg, rparams)
    for name in INPUT_SHAPES:
        shape, rshape = INPUT_SHAPES[name], RSHAPES[name]
        assert shape_applicable(cfg, shape) == rapplicable(rcfg, rshape)
        assert R.analytic_flops(cfg, shape) == RR.analytic_flops(rcfg,
                                                                 rshape)
        assert R.model_flops(cfg, params, shape) == RR.model_flops(
            rcfg, rparams, rshape)


def test_batch_specs_carry_patches_and_frames():
    shape = InputShape("prefill_small", "prefill", 256, 2)
    vlm = S.batch_specs(get_config("internvl2-76b", smoke=True), shape)
    assert tuple(vlm["tokens"].shape) == (2, 240)
    assert tuple(vlm["patches"].shape) == (2, 16, 128)
    audio = S.batch_specs(get_config("whisper-medium"), INPUT_SHAPES[
        "train_4k"])
    assert tuple(audio["frames"].shape) == (256, 1500, 1024)
    assert audio["frames"].dtype == torch.bfloat16
    assert tuple(audio["labels"].shape) == (256, 4096)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2-130m", "llama4-scout-17b-a16e"])
def test_launch_train_smoke_on_cpu(arch):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert launch_train.main(["--arch", arch, "--smoke", "--device",
                                  "cpu", "--steps", "3", "--seq", "64",
                                  "--batch", "2"]) == 0
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert res["arch"] == arch and res["steps"] == 3
    assert np.isfinite(res["first_loss"]) and np.isfinite(res["final_loss"])


@pytest.mark.parametrize("arch", ["mamba2-130m", "llama4-scout-17b-a16e"])
def test_launch_serve_smoke_on_cpu(arch):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert launch_serve.main(["--arch", arch, "--smoke", "--device",
                                  "cpu", "--temperature", "0", "--gen", "3",
                                  "--batch", "2", "--prompt-len", "64"]) == 0
    res = json.loads(buf.getvalue())
    assert res["generated_shape"] == [2, 3]
    assert all(0 <= t < 512 for t in res["sample_tokens"])


def test_stub_inputs_are_zeros_of_the_reference_shapes():
    for arch, key, shape in (("internvl2-76b", "patches", (3, 16, 128)),
                             ("whisper-medium", "frames", (3, 64, 128))):
        out = launch_serve.stub_inputs(get_config(arch, smoke=True), 3, CPU)
        assert set(out) == {key}
        assert tuple(out[key].shape) == shape and not out[key].any()
    assert launch_serve.stub_inputs(get_config("zamba2-7b", smoke=True), 3,
                                    CPU) == {}
