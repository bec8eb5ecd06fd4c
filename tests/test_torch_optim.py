"""The port's optimizers against the live reference: N updates of
``sgd`` (with and without momentum) and ``adamw`` (with and without
weight decay, clipping on), under the constant and cosine schedules,
from the same parameters and the same gradient sequence (numpy), and the
schedules and ``clip_by_global_norm`` alone.  Tolerance 1e-6: both run
the same f32 arithmetic, only in another order."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as ref_optim  # noqa: E402

from repro_torch import optim as t_optim  # noqa: E402

TOL = 1e-6


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return [{"w_self": rng.normal(size=(6, 4)).astype(np.float32),
             "w_neigh": rng.normal(size=(6, 4)).astype(np.float32)},
            {"w": rng.normal(size=(4, 3)).astype(np.float32)}]


def _grads(step, scale=1.0):
    rng = np.random.default_rng(100 + step)
    return [{k: (scale * rng.normal(size=v.shape)).astype(np.float32)
             for k, v in p.items()} for p in _params()]


def _run(mod, to_t, opt_name, sched, n=6, scale=1.0, **kw):
    lr = sched(mod) if callable(sched) else sched
    opt = getattr(mod, opt_name)(lr, **kw)
    params = [{k: to_t(v) for k, v in p.items()} for p in _params()]
    state = opt.init(params)
    for s in range(n):
        grads = [{k: to_t(v) for k, v in p.items()}
                 for p in _grads(s, scale)]
        params, state = opt.update(grads, state, params)
    return [{k: np.asarray(v) for k, v in p.items()} for p in params], state


def _cosine(mod):
    return mod.cosine_schedule(0.1, 2, 6, floor=0.01)


@pytest.mark.parametrize("sched", [0.05, _cosine], ids=["const", "cosine"])
@pytest.mark.parametrize("opt_name,kw", [
    ("sgd", {}), ("sgd", {"momentum": 0.9}),
    ("adamw", {}), ("adamw", {"weight_decay": 0.01}),
    ("adamw", {"clip_norm": None})])
def test_updates_match_reference(opt_name, kw, sched):
    # large gradients so adamw's global-norm clip (1.0) is active
    scale = 3.0 if opt_name == "adamw" else 1.0
    want, wstate = _run(ref_optim, jnp.asarray, opt_name, sched,
                        scale=scale, **kw)
    got, gstate = _run(t_optim, torch.as_tensor, opt_name, sched,
                       scale=scale, **kw)
    for pw, pg in zip(want, got):
        for k in pw:
            np.testing.assert_allclose(pg[k], pw[k], rtol=TOL, atol=TOL,
                                       err_msg=k)
    assert int(gstate["step"]) == int(wstate["step"]) == 6
    assert gstate["step"].dtype == torch.int32


def test_schedules_match_reference():
    """The step counter is incremented before the schedule reads it, so
    step 0 is never read; cover warmup, decay, the floor and beyond."""
    ref = ref_optim.cosine_schedule(0.3, 3, 10, floor=0.02)
    ours = t_optim.cosine_schedule(0.3, 3, 10, floor=0.02)
    for step in range(0, 14):
        assert float(ours(torch.tensor(step, dtype=torch.int32))) == \
            pytest.approx(float(ref(jnp.asarray(step, jnp.int32))),
                          rel=TOL, abs=TOL)
        assert float(ours(step)) == pytest.approx(float(ref(step)),
                                                  rel=TOL, abs=TOL)
    assert t_optim.constant_schedule(0.25)(torch.tensor(3)) == \
        pytest.approx(float(ref_optim.constant_schedule(0.25)(3)))


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _grads(0)
    want, wn = ref_optim.clip_by_global_norm(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in g], max_norm)
    got, gn = t_optim.clip_by_global_norm(
        [{k: torch.as_tensor(v) for k, v in p.items()} for p in g],
        max_norm)
    assert float(gn) == pytest.approx(float(wn), rel=TOL)
    for pw, pg in zip(want, got):
        for k in pw:
            np.testing.assert_allclose(pg[k].numpy(), np.asarray(pw[k]),
                                       rtol=TOL, atol=TOL)


def test_state_layout_mirrors_params():
    params = [{k: torch.as_tensor(v) for k, v in p.items()}
              for p in _params()]
    st = t_optim.sgd(0.1, momentum=0.5).init(params)
    assert [sorted(p) for p in st["vel"]] == [sorted(p) for p in params]
    st = t_optim.adamw(0.1).init(params)
    assert all(v.dtype == torch.float32 and v.shape == params[i][k].shape
               for i, p in enumerate(st["mu"]) for k, v in p.items())
    assert set(t_optim.sgd(0.1).init(params)) == {"step"}
