"""The port's theory side against the live reference: the one-layer
testbed (forward, both losses and their gradients from
``torch.autograd`` against ``jax.grad``, on the same numpy W, within
1e-5), the closed-form bounds and slopes (equal, over the grid of
``bench_theory_slopes``), and the Wasserstein quantities of Thm 3 on the
same ``make_preset`` graph (equal, or within 1e-12)."""
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import theory as RT  # noqa: E402
from repro.core import wasserstein as RW  # noqa: E402
from repro.data import make_preset as ref_make_preset  # noqa: E402

from repro_torch.core import theory as TT  # noqa: E402
from repro_torch.core import wasserstein as TW  # noqa: E402
from repro_torch.data.synth import make_preset  # noqa: E402

TESTBED_TOL = 1e-5
W_TOL = 1e-12


def _testbed_inputs(seed, m=48, r=16, h=8):
    rng = np.random.default_rng(seed)
    return dict(
        w=rng.normal(size=(h, r)).astype(np.float32),
        agg=rng.normal(size=(m, r)).astype(np.float32),
        onehot=np.eye(h, dtype=np.float32)[rng.integers(0, h, m)],
        y_pm=rng.choice([-1.0, 1.0], m).astype(np.float32))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=TESTBED_TOL, atol=TESTBED_TOL,
                               err_msg=what)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_testbed_forward_losses_and_grads_match_reference(seed):
    x = _testbed_inputs(seed)
    h = x["w"].shape[0]
    jw, jagg = jnp.asarray(x["w"]), jnp.asarray(x["agg"])
    tw = torch.tensor(x["w"], requires_grad=True)
    tagg = torch.as_tensor(x["agg"])
    _close(TT.testbed_forward(tw, tagg).detach(),
           RT.testbed_forward(jw, jagg), "forward")

    onehot = x["onehot"]
    t_mse = TT.testbed_mse_loss(tw, tagg, torch.as_tensor(onehot))
    r_mse, r_gmse = jax.value_and_grad(RT.testbed_mse_loss)(
        jw, jagg, jnp.asarray(onehot))
    (t_gmse,) = torch.autograd.grad(t_mse, tw)
    _close(t_mse.item(), float(r_mse), "mse loss")
    _close(t_gmse, r_gmse, "mse grad")

    tv = TT.make_v(h, device="cpu")
    np.testing.assert_array_equal(tv.numpy(), np.asarray(RT.make_v(h)))
    t_ce = TT.testbed_ce_loss(tw, tagg, torch.as_tensor(x["y_pm"]), tv)
    r_ce, r_gce = jax.value_and_grad(RT.testbed_ce_loss)(
        jw, jagg, jnp.asarray(x["y_pm"]), RT.make_v(h))
    (t_gce,) = torch.autograd.grad(t_ce, tw)
    _close(t_ce.item(), float(r_ce), "ce loss")
    _close(t_gce, r_gce, "ce grad")


def test_init_testbed_draws_from_its_generator():
    a = TT.init_testbed(torch.Generator().manual_seed(3), 16, 8,
                        device="cpu")
    b = TT.init_testbed(torch.Generator().manual_seed(3), 16, 8,
                        device="cpu")
    assert a.shape == (8, 16) and a.dtype == torch.float32
    assert a.device.type == "cpu"
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_testbed_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        TT.init_testbed(torch.Generator().manual_seed(0), 4, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        TT.make_v(4)


#: the grid of bench_theory_slopes (n = 2000, h = 16)
SLOPE_GRID = [(loss, b, beta) for loss in ("mse", "ce")
              for b in (32, 128, 512) for beta in (2, 5, 10, 20)]


@pytest.mark.parametrize("loss,b,beta", SLOPE_GRID)
def test_bounds_and_slopes_equal_reference(loss, b, beta):
    n, h = 2000, 16
    slope = {"mse": "slope_mse", "ce": "slope_ce"}[loss]
    assert getattr(TT, slope)(b, beta) == getattr(RT, slope)(b, beta)
    assert TT.t_mse_minibatch(n, h, b, beta) == \
        RT.t_mse_minibatch(n, h, b, beta)
    assert TT.t_ce_minibatch(n, b, beta) == RT.t_ce_minibatch(n, b, beta)
    assert TT.t_mse_fullgraph(n, h, beta) == RT.t_mse_fullgraph(n, h, beta)
    assert TT.t_ce_fullgraph(n, beta) == RT.t_ce_fullgraph(n, beta)
    rows = np.random.default_rng(b * 100 + beta).random(b)
    assert TT.gamma_bounds(rows) == RT.gamma_bounds(rows)
    assert TT.predicted_trends() == RT.predicted_trends()
    assert math.isfinite(TT.t_ce_minibatch(n, b, beta))


@pytest.fixture(scope="module")
def preset_graphs():
    kw = dict(seed=0, n=300)
    return ref_make_preset("arxiv-like", **kw), make_preset("arxiv-like",
                                                           **kw)


@pytest.mark.parametrize("beta", [1, 3, 8, 10 ** 6])
def test_delta_full_mini_equals_reference(preset_graphs, beta):
    rg, tg = preset_graphs
    beta = min(beta, tg.d_max)
    got = TW.delta_full_mini(tg, beta, rng=np.random.default_rng(5))
    want = RW.delta_full_mini(rg, beta, rng=np.random.default_rng(5))
    np.testing.assert_allclose(got, want, rtol=0, atol=W_TOL)


def test_delta_full_constant_and_sinkhorn_equal_reference(preset_graphs):
    rg, tg = preset_graphs
    assert TW.delta_full_constant(tg, max_pairs=300, seed=2) == \
        pytest.approx(RW.delta_full_constant(rg, max_pairs=300, seed=2),
                      rel=0, abs=W_TOL)
    rng = np.random.default_rng(0)
    cost = rng.random((5, 6))
    mu, nu = rng.dirichlet(np.ones(5)), rng.dirichlet(np.ones(6))
    t_theta, t_total = TW.sinkhorn(cost, mu, nu)
    r_theta, r_total = RW.sinkhorn(cost, mu, nu)
    np.testing.assert_allclose(t_theta, r_theta, rtol=0, atol=W_TOL)
    assert t_total == pytest.approx(r_total, rel=0, abs=W_TOL)


@pytest.mark.parametrize("beta,b", [(2, 128), (5, 32), (5, 10 ** 6)])
def test_wasserstein_delta_equals_reference(preset_graphs, beta, b):
    rg, tg = preset_graphs
    b = min(b, len(tg.train_nodes))
    got = TW.wasserstein_delta(tg, beta=beta, b=b, n_rounds=2)
    want = RW.wasserstein_delta(rg, beta=beta, b=b, n_rounds=2)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=W_TOL,
                                   err_msg=k)
