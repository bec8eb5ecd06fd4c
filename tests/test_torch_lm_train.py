"""The port's LM training against the live reference (``repro.models``),
on the smoke configs of the four dense archs with the reference's own
weights carried over by ``params_from_numpy``:

* ``forward_train``'s loss, aux and accuracy: 1e-5 in f32 (every smoke
  config is f32), 2e-2 relative for a bf16 variant (bf16 rounds at other
  points in the two frameworks);
* ``chunked_lm_loss`` alone with ``-1`` labels, against the reference's
  and against the plain CE over every valid position;
* the gradients against ``jax.grad``: 1e-3;
* three ``make_train_step`` steps against the reference's: losses 1e-5
  relative, parameters 1e-3, under an AdamW whose steps are large enough
  for the parameter limit to see a fault (the default schedule's first
  rates, 3e-6 to 9e-6, move no parameter by more than about 2e-5,
  whatever the gradient): a constant 3e-3 with weight decay, and a
  cosine schedule with a short warm-up;
* ``microbatches=2`` against 1 under ``adamw(3e-3)`` at the reference's
  own limits (``tests/test_archs.py:89-105``: loss rtol 1e-4, parameters
  5e-3), and against the reference's two-micro-batch step; the
  accumulated gradients of 2 micro-batches against 1 and against the
  mean of ``jax.grad`` over the reference's two halves: 1e-3;
* ``token_batches`` array-equal; the reference's loss-falls case
  (granite smoke, 30 steps, ``adamw(3e-3)``, down by 0.5);
* ``launch/train.py`` for an LM arch in a subprocess: the reference's
  JSON keys, ``--ckpt-every``, ``--model-par 2`` (a tensor-parallel run
  on two CPU shards, ``tests/test_torch_tensor_parallel.py``), and no run
  on the CPU without ``--device cpu``."""
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
from repro.data import token_batches as ref_token_batches  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import steps as RS  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim import cosine_schedule as ref_cosine  # noqa: E402

from repro_torch.checkpoint import available_steps  # noqa: E402
from repro_torch.configs.base import ModelConfig, get_config  # noqa: E402
from repro_torch.data.synth import token_batches  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import steps as S  # noqa: E402
from repro_torch.optim import adamw, cosine_schedule  # noqa: E402
from repro_torch.optim import value_and_grad  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
DENSE = ["gemma3-12b", "gemma-7b", "granite-3-2b", "stablelm-1.6b"]


def _np(x):
    return np.asarray(x, np.float32)


def _pairs(got, want):
    """(port leaf, reference leaf) pairs as float32 numpy, walking the
    port tree's keys (jax rebuilds dicts in sorted key order)."""
    if isinstance(got, dict):
        assert set(got) == set(want)
        return [x for k in got for x in _pairs(got[k], want[k])]
    if isinstance(got, (list, tuple)):
        assert len(got) == len(want)
        return [x for g, w in zip(got, want) for x in _pairs(g, w)]
    return [(_np(got.detach() if isinstance(got, torch.Tensor) else got),
             _np(want))]


def _setup(arch, dtype=None, seed=0, b=2, s=64, masked_rows=1):
    """(port cfg, reference cfg, port params, reference params, port
    batch, reference batch): the reference's initial weights, a token
    batch whose first ``masked_rows`` rows have their first 5 labels
    ignored."""
    rcfg = ref_get_config(arch, smoke=True)
    if dtype:
        rcfg = dataclasses.replace(rcfg, dtype=dtype)
    cfg = ModelConfig(**dataclasses.asdict(rcfg))
    rp = RM.init_model(jax.random.key(seed), rcfg)
    p = M.params_from_numpy(jax.tree.map(np.asarray, rp), CPU)
    hb = next(token_batches(cfg.vocab_size, b, s, seed=seed + 1))
    hb["labels"][:masked_rows, :5] = -1
    return (cfg, rcfg, p, rp, {k: torch.tensor(v) for k, v in hb.items()},
            {k: jnp.asarray(v) for k, v in hb.items()})


@pytest.mark.parametrize("arch", DENSE)
def test_forward_train_matches_reference(arch):
    cfg, rcfg, p, rp, tb, jb = _setup(arch)
    assert cfg.dtype == "float32"
    total, m = M.forward_train(p, cfg, tb)
    rtotal, rm = jax.jit(lambda q, b: RM.forward_train(q, rcfg, b))(rp, jb)
    for got, want in ((total, rtotal), (m["loss"], rm["loss"]),
                      (m["aux"], rm["aux"]), (m["acc"], rm["acc"])):
        np.testing.assert_allclose(float(got), float(want), atol=1e-5,
                                   rtol=1e-5)


def test_forward_train_bf16_matches_reference():
    cfg, rcfg, p, rp, tb, jb = _setup("granite-3-2b", dtype="bfloat16")
    _, m = M.forward_train(p, cfg, tb)
    _, rm = jax.jit(lambda q, b: RM.forward_train(q, rcfg, b))(rp, jb)
    assert abs(float(m["loss"]) - float(rm["loss"])) \
        <= 2e-2 * abs(float(rm["loss"]))
    assert abs(float(m["acc"]) - float(rm["acc"])) <= 2e-2


def test_chunked_lm_loss_masks_ignored_labels():
    """Three chunks of 512 with ignored positions across them, against
    the reference's scan and the plain CE over the valid positions."""
    cfg, rcfg, p, rp, _, _ = _setup("stablelm-1.6b")
    rng = np.random.default_rng(3)
    hidden = rng.normal(size=(2, 1536, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (2, 1536)).astype(np.int32)
    labels[0, 100:700] = -1
    labels[1, -3:] = -1
    loss, acc = M.chunked_lm_loss(p, cfg, torch.tensor(hidden),
                                  torch.tensor(labels))
    rloss, racc = RM.chunked_lm_loss(rp, rcfg, jnp.asarray(hidden),
                                     jnp.asarray(labels))
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    np.testing.assert_allclose(float(acc), float(racc), atol=1e-6)
    logits = torch.tensor(hidden) @ p["lm_head"]
    valid = torch.tensor(labels) >= 0
    ce = torch.nn.functional.cross_entropy(
        logits[valid], torch.tensor(labels).long()[valid])
    np.testing.assert_allclose(float(loss), float(ce), rtol=1e-5)


@pytest.mark.parametrize("arch", DENSE)
def test_gradients_match_jax_grad(arch):
    cfg, rcfg, p, rp, tb, jb = _setup(arch)
    _, _, grads = value_and_grad(lambda q: M.forward_train(q, cfg, tb), p)
    rgrads = jax.jit(jax.grad(
        lambda q: RM.forward_train(q, rcfg, jb)[0]))(rp)
    for got, want in _pairs(grads, rgrads):
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)


#: (port, reference) AdamW of the three-step comparison: a constant 3e-3
#: with weight decay, and a cosine schedule whose rates at steps 1-3 are
#: 1.5e-3, 3e-3 and 2.97e-3
OPTIMIZERS = {
    "constant": lambda: (adamw(3e-3, weight_decay=0.1),
                         ref_adamw(3e-3, weight_decay=0.1)),
    "cosine": lambda: (adamw(cosine_schedule(3e-3, 2, 20)),
                       ref_adamw(ref_cosine(3e-3, 2, 20))),
}


@pytest.mark.parametrize("opt_name", sorted(OPTIMIZERS))
@pytest.mark.parametrize("arch", DENSE)
def test_three_train_steps_match_reference(arch, opt_name):
    cfg, rcfg, p, rp, tb, jb = _setup(arch)
    popt, ropt_ = OPTIMIZERS[opt_name]()
    opt, step = S.make_train_step(cfg, optimizer=popt)
    ropt, rstep = RS.make_train_step(rcfg, optimizer=ropt_)
    st, rst = opt.init(p), ropt.init(rp)
    rstep = jax.jit(rstep)
    for _ in range(3):
        p, st, m = step(p, st, tb)
        rp, rst, rm = rstep(rp, rst, jb)
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                   rtol=1e-5)
    for got, want in _pairs(p, rp):
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    for got, want in _pairs({"mu": st["mu"], "nu": st["nu"]},
                            {"mu": rst["mu"], "nu": rst["nu"]}):
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    assert int(st["step"]) == 3


def test_microbatched_train_step_matches_plain():
    """The reference's case (granite smoke, b = 4), under ``adamw(3e-3)``:
    2 micro-batches against 1 at its limits, and against the reference's
    own two-micro-batch step.  Every row ignores as many labels, so the
    mean of the halves' mean losses is the batch's (a step of
    micro-batches averages per micro-batch, as the reference's)."""
    cfg, rcfg, p, rp, tb, jb = _setup("granite-3-2b", b=4, masked_rows=4)
    opt1, s1 = S.make_train_step(cfg, optimizer=adamw(3e-3),
                                 microbatches=1)
    opt2, s2 = S.make_train_step(cfg, optimizer=adamw(3e-3),
                                 microbatches=2)
    p1, _, m1 = s1(p, opt1.init(p), tb)
    p2, st2, m2 = s2(p, opt2.init(p), tb)
    assert np.isclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-4)
    assert max(float(np.abs(a - b).max())
               for a, b in _pairs(p1, p2)) < 5e-3
    ropt, rs2 = RS.make_train_step(rcfg, optimizer=ref_adamw(3e-3),
                                   microbatches=2)
    rp2, _, rm2 = jax.jit(rs2)(rp, ropt.init(rp), jb)
    np.testing.assert_allclose(float(m2["loss"]), float(rm2["loss"]),
                               rtol=1e-5)
    for got, want in _pairs(p2, rp2):
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    with pytest.raises(ValueError, match="micro-batches"):
        S.make_train_step(cfg, microbatches=3)[1](p, opt1.init(p), tb)


def test_microbatched_gradients_match_plain_and_reference():
    """The f32 gradients ``accumulate_grads`` hands the update: 2
    micro-batches against 1, and against the mean of ``jax.grad`` over
    the reference's two halves of the batch (its ``lax.scan``
    accumulation), each within 1e-3; the metrics are the halves' mean.
    Both halves hold as many valid labels (see above)."""
    cfg, rcfg, p, rp, tb, jb = _setup("granite-3-2b", b=4, masked_rows=4)
    g1, m1 = S.accumulate_grads(p, cfg, tb, 1)
    g2, m2 = S.accumulate_grads(p, cfg, tb, 2)
    for got, want in _pairs(g2, g1):
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    halves = [{k: v[i:i + 2] for k, v in jb.items()} for i in (0, 2)]
    rgrad = jax.jit(jax.grad(
        lambda q, b: RM.forward_train(q, rcfg, b)[0]))
    rg = jax.tree.map(lambda a, b: (a + b) / 2,
                      *(rgrad(rp, h) for h in halves))
    for got, want in _pairs(g2, rg):
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    rloss = [float(RM.forward_train(rp, rcfg, h)[1]["loss"])
             for h in halves]
    np.testing.assert_allclose(float(m2["loss"]), np.mean(rloss),
                               rtol=1e-5)
    assert all(v.dtype == torch.float32 for v in jax.tree.leaves(
        g2, is_leaf=lambda x: isinstance(x, torch.Tensor)))


@pytest.mark.parametrize("vocab,batch,seq,seed",
                         [(512, 2, 64, 0), (100_352, 3, 40, 7),
                          (128, 8, 16, 3)])
def test_token_batches_equal_reference(vocab, batch, seq, seed):
    got = list(token_batches(vocab, batch, seq, seed=seed, n_batches=3))
    want = list(ref_token_batches(vocab, batch, seq, seed=seed,
                                  n_batches=3))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"tokens", "labels"}
        for k in g:
            assert g[k].dtype == w[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], w[k])


def test_lm_loss_decreases_over_steps():
    """The reference's ``test_lm_loss_decreases_over_steps``: granite
    smoke, 30 steps of ``adamw(3e-3)`` on the Markov tokens, the loss
    down by 0.5 (weights from the reference's initialisation)."""
    rcfg = ref_get_config("granite-3-2b", smoke=True)
    cfg = get_config("granite-3-2b", smoke=True)
    p = M.params_from_numpy(jax.tree.map(
        np.asarray, RM.init_model(jax.random.key(0), rcfg)), CPU)
    opt, step = S.make_train_step(cfg, optimizer=adamw(3e-3))
    st = opt.init(p)
    losses = []
    for hb in token_batches(cfg.vocab_size, 8, 64, n_batches=30):
        p, st, m = step(p, st, {k: torch.tensor(v) for k, v in hb.items()})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::10]


def _train(args, **kw):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"),
                                         env.get("PYTHONPATH", "")])
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], cwd=REPO, capture_output=True, text=True,
                          env=env, timeout=600, **kw)


def test_launch_train_lm_cli(tmp_path):
    ck = str(tmp_path / "ck")
    out = _train(["--arch", "stablelm-1.6b", "--smoke", "--device", "cpu",
                  "--steps", "5", "--ckpt-every", "2", "--ckpt-dir", ck])
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(rec) == {"arch", "first_loss", "final_loss", "steps"}
    assert rec["arch"] == "stablelm-1.6b" and rec["steps"] == 5
    assert np.isfinite(rec["first_loss"]) and np.isfinite(rec["final_loss"])
    assert available_steps(ck) == [2, 4]

    out = _train(["--arch", "stablelm-1.6b", "--smoke", "--device", "cpu",
                  "--steps", "2", "--model-par", "2"])
    assert out.returncode == 0, out.stderr[-2000:]
    two = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(two) == {"arch", "first_loss", "final_loss", "steps"}
    assert two["steps"] == 2 and np.isclose(two["first_loss"],
                                            rec["first_loss"], rtol=1e-5)


def test_launch_train_lm_does_not_run_on_the_cpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _train(["--arch", "stablelm-1.6b", "--smoke", "--steps", "2"])
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
    assert '"first_loss"' not in out.stdout
