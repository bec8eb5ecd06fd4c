"""The backward kernel's identity mode on the CPU (its plain version
``ref.neighbor_agg_backward_identity_ref``; tests/test_torch_cuda.py and
chip_smoke.py hold the CUDA kernel to it on the card).

* The plain version against the general backward's plain version
  (``neighbor_agg_backward_ref``) on the identity ids ``b·K + k``:
  ``torch.equal`` for every ``need``, fused and plain, f32 and bf16,
  D in {1, 33, 172, 256}, K in {0, 1, 15}, zero weights among them.
* Both against the reference's VJP (``jax.vjp`` of
  ``repro.kernels.neighbor_agg.ops.neighbor_agg(..., use_kernel=True,
  interpret=True)``, the Pallas kernel in interpret mode, as
  tests/test_kernels.py runs it) on the same numpy inputs: 1e-5 in f32,
  2e-2 in bf16 (one rounding of each cotangent).  K = 0 is held to the
  general plain version only: neither of the reference's paths traces
  an empty K axis.
* The mini-batch paths take the identity route: one GraphSAGE and one
  GCN step with ``use_agg_kernel`` give the gradients of the previous
  route (``_wsum`` through ``neighbor_agg`` on ``arange`` ids, a copy
  kept here) bit for bit, call the identity plain version and never the
  general one; ``neighbor_agg_batch_sharded`` is bit-equal at S = 1 and
  within 1e-5 (forward) / 1e-3 (gradients) at S = 4 CPU shards.
* The cost model of the identity mode, by hand, at the mini-batch path's
  layer-2 shape.

Inputs come from numpy with a seed."""
import itertools

import numpy as np
import pytest
import torch

from repro_torch import sharding as sh
from repro_torch.configs.base import GNNConfig
from repro_torch.core import gnn as G
from repro_torch.kernels import cost as C
from repro_torch.kernels.neighbor_agg import ops
from repro_torch.kernels.neighbor_agg.ref import (
    neighbor_agg_backward_identity_ref, neighbor_agg_backward_ref)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
NEEDS = list(itertools.product((False, True), repeat=4))
NAMES = ("dfeats", "dw", "dself", "dw_self")


def _case(seed, b, k, d, fused, zero=0.3):
    """Numpy inputs of one identity-id call: the [B·K, D] table, w with
    a share ``zero`` of zero weights (a whole row of them in row 0), g
    and, fused, self_rows and w_self."""
    rng = np.random.default_rng(seed)
    w = (rng.random((b, k)) * (rng.random((b, k)) > zero)).astype(
        np.float32)
    w[0] = 0.0
    out = [rng.normal(size=(b * k, d)).astype(np.float32), w,
           rng.normal(size=(b, d)).astype(np.float32)]
    if fused:
        out += [rng.normal(size=(b, d)).astype(np.float32),
                rng.random(b).astype(np.float32)]
    return out


def _torch(arrays, dtype):
    table, w, g, *rest = (torch.tensor(a).to(DTYPES[dtype]) for a in arrays)
    b, k = w.shape
    ids = torch.arange(b * k, dtype=torch.int32).reshape(b, k)
    sr, ws = rest if rest else (None, None)
    return table, ids, w, g, sr, ws


def _equal(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("k", [0, 1, 15])
@pytest.mark.parametrize("d", [1, 33, 172, 256])
def test_identity_plain_version_equals_general_on_arange_ids(d, k, fused,
                                                             dtype):
    """Every ``need`` combination: the two plain versions give the same
    bits, and the identity one writes zero-weight edges' rows as 0."""
    b = 6
    table, ids, w, g, sr, ws = _torch(_case(d * 16 + k, b, k, d, fused),
                                      dtype)
    for need in NEEDS:
        got = neighbor_agg_backward_identity_ref(table, w, g, sr, ws, need)
        want = neighbor_agg_backward_ref(table, ids, w, g, sr, ws, need)
        for name, a, c in zip(NAMES, got, want):
            _equal(a, c)
        if need[0]:
            assert got[0].shape == (b * k, d)
            assert bool((got[0][(w == 0).reshape(-1)] == 0).all())


def test_identity_plain_version_writes_zero_behind_zero_weights():
    """A non-finite g row behind an edge of weight 0 stays out of its
    dfeats row (+0), as the kernel writes it; a nonzero weight spreads
    it."""
    table, _, w, g, _, _ = _torch(_case(3, 4, 5, 8, False), "float32")
    w[1] = torch.tensor([0.0, 0.5, 0.0, 0.0, 0.0])
    g[1, 2] = float("nan")
    df = neighbor_agg_backward_identity_ref(table, w, g)[0]
    assert torch.equal(df[5], torch.zeros(8))
    assert bool(torch.isnan(df[6, 2])) and int(torch.isnan(df).sum()) == 1


def _jax_vjp(arrays, dtype, k):
    """The reference's cotangents on the same numpy inputs: the Pallas
    kernel's VJP in interpret mode."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.kernels.neighbor_agg.ops import neighbor_agg as jax_agg
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    table, w, g, *rest = arrays
    b = w.shape[0]
    ids = jnp.asarray(np.arange(b * k, dtype=np.int32).reshape(b, k))
    diff = [jnp.asarray(a, jdt) for a in (table, w, *rest)]

    def fn(tab, ww, *sr):
        return jax_agg(tab, ids, ww, *sr, use_kernel=True, interpret=True,
                       d_tile=128)
    _, vjp = jax.vjp(fn, *diff)
    return [np.asarray(x, np.float32) for x in vjp(jnp.asarray(g, jdt))]


@pytest.mark.parametrize("dtype,d,k,fused", [
    ("float32", 1, 15, True), ("float32", 33, 1, True),
    ("float32", 172, 15, False), ("float32", 256, 15, True),
    ("float32", 256, 1, False), ("bfloat16", 172, 15, True),
    ("bfloat16", 256, 1, False), ("bfloat16", 1, 15, True)])
def test_identity_and_general_plain_versions_match_reference_vjp(dtype, d,
                                                                 k, fused):
    arrays = _case(d + k + 7, 5, k, d, fused)
    want = _jax_vjp(arrays, dtype, k)
    table, ids, w, g, sr, ws = _torch(arrays, dtype)
    got_i = [x for x in neighbor_agg_backward_identity_ref(
        table, w, g, sr, ws) if x is not None]
    got_g = [x for x in neighbor_agg_backward_ref(table, ids, w, g, sr, ws)
             if x is not None]
    assert len(got_i) == len(got_g) == len(want) == (4 if fused else 2)
    for name, a, c, ref in zip(NAMES, got_i, got_g, want):
        assert a.dtype == DTYPES[dtype], name
        for x in (a, c):
            np.testing.assert_allclose(x.float().numpy(), ref,
                                       atol=TOL[dtype], rtol=TOL[dtype],
                                       err_msg=name)


# ---------------------------------------------------------------------------
# the mini-batch paths take the identity route
# ---------------------------------------------------------------------------

def _wsum_through_neighbor_agg(cfg, w_edge, h_nb, h_self=None, w_self=None,
                               mesh=None):
    """The mini-batch kernel route before the identity mode: ``_wsum``
    through ``neighbor_agg`` on ``arange`` ids (its gradient from the
    general backward)."""
    fused = h_self is not None
    k, d = h_nb.shape[-2], h_nb.shape[-1]
    lead = h_nb.shape[:-2]
    table = h_nb.reshape(-1, d)
    b = table.shape[0] // k
    idx = torch.arange(b * k, dtype=torch.int32).reshape(b, k)
    out = ops.neighbor_agg(table, idx, w_edge.reshape(b, k),
                           h_self.reshape(b, d) if fused else None,
                           w_self.reshape(b) if fused else None,
                           use_kernel=True)
    return out.reshape(lead + (d,))


def _mb_case(model, seed=4, b=10, fanouts=(5, 3), r=12):
    rng = np.random.default_rng(seed)
    cfg = GNNConfig(name="t", model=model, n_nodes=100, feat_dim=r,
                    hidden=16, n_classes=5, n_layers=2, fanout=fanouts,
                    batch_size=b, use_agg_kernel=True)
    shapes = [(b,), (b, fanouts[0]), (b,) + tuple(fanouts)]
    feats = [torch.tensor(rng.normal(size=s + (r,)), dtype=torch.float32)
             for s in shapes]
    masks = [torch.tensor(rng.random(s) > 0.3, dtype=torch.float32)
             for s in shapes[1:]]
    weights = [m * torch.tensor(rng.random(m.shape), dtype=torch.float32)
               for m in masks]
    self_w = [torch.tensor(rng.random(s), dtype=torch.float32)
              for s in shapes]
    labels = torch.tensor(rng.integers(0, 5, b), dtype=torch.int32)
    params = G.init_gnn(torch.Generator().manual_seed(seed), cfg, r,
                        device="cpu")
    return cfg, params, (feats, masks, weights, self_w, labels)


def _mb_grads(cfg, params, batch):
    leaves = [v.requires_grad_() for p in params for v in p.values()]
    feats, masks, weights, self_w, labels = batch
    logits = G.minibatch_forward(params, cfg, feats, masks, weights, self_w)
    loss = G.gnn_loss(logits, labels, cfg.loss, cfg.n_classes)
    return [logits.detach(), loss.detach()] + list(
        torch.autograd.grad(loss, leaves))


@pytest.mark.parametrize("model", ["graphsage", "gcn"])
def test_minibatch_step_takes_the_identity_route(monkeypatch, model):
    cfg, params, batch = _mb_case(model)
    calls = {"identity": [], "general": []}

    def spy(kind, fn):
        def wrapped(*a, **kw):
            calls[kind].append(kw.get("need", a[-1] if len(a) > 5 else None))
            return fn(*a, **kw)
        return wrapped

    with monkeypatch.context() as m:
        m.setattr(ops, "neighbor_agg_backward_identity_ref",
                  spy("identity", neighbor_agg_backward_identity_ref))
        m.setattr(ops, "neighbor_agg_backward_ref",
                  spy("general", neighbor_agg_backward_ref))
        got = _mb_grads(cfg, params, batch)
    assert calls["identity"] and not calls["general"]
    assert any(need[0] for need in calls["identity"])
    with monkeypatch.context() as m:
        m.setattr(G, "_wsum", _wsum_through_neighbor_agg)
        want = _mb_grads(cfg, params, batch)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("shards", [1, 4])
def test_batch_sharded_op_takes_the_identity_route(shards, fused):
    """``neighbor_agg_batch_sharded`` against ``neighbor_agg_batch``:
    forward and every gradient bit-equal at S = 1, within 1e-5 / 1e-3 at
    S = 4; its backward runs the identity plain version."""
    rng = np.random.default_rng(9)
    b, k, d = 8, 5, 19
    arrs = [rng.normal(size=(b, k)), rng.normal(size=(b, k, d))]
    if fused:
        arrs += [rng.normal(size=(b, d)), rng.normal(size=(b,))]

    def run(fn):
        args = [torch.tensor(a, dtype=torch.float32).requires_grad_()
                for a in arrs]
        out = fn(*args)
        return [out.detach()] + list(torch.autograd.grad(
            (out ** 2).sum(), args))
    base = run(ops.neighbor_agg_batch)
    ops.reset_launches()
    got = run(lambda *a: ops.neighbor_agg_batch_sharded(
        *a, mesh=sh.node_mesh(devices=("cpu",) * shards)))
    assert set(ops.launch_counts().values()) == {0}
    for i, (a, c) in enumerate(zip(got, base)):
        if shards == 1:
            assert torch.equal(a, c)
        tol = 1e-5 if i == 0 else 1e-3
        torch.testing.assert_close(a, c, atol=tol, rtol=tol)


def test_neighbor_agg_batch_equals_neighbor_agg_on_arange_ids():
    """The forward is the tiled route on the flattened table (the same
    bits), and the entry checks its arguments."""
    rng = np.random.default_rng(2)
    w = torch.tensor(rng.random((6, 4)), dtype=torch.float32)
    nb = torch.tensor(rng.normal(size=(6, 4, 7)), dtype=torch.float32)
    ids = torch.arange(24, dtype=torch.int32).reshape(6, 4)
    assert torch.equal(ops.neighbor_agg_batch(w, nb),
                       ops.neighbor_agg(nb.reshape(24, 7), ids, w,
                                        use_kernel=True))
    with pytest.raises(ValueError, match="together"):
        ops.neighbor_agg_batch(w, nb, h_self=nb[:, 0])
    with pytest.raises(ValueError, match=r"\[B·K, D\]"):
        ops.neighbor_agg_backward_identity(nb.reshape(24, 7)[:20], w,
                                           torch.zeros(6, 7))
    df, dw, _, _ = ops.neighbor_agg_backward_identity(
        nb.reshape(24, 7), w, torch.ones(6, 7))
    assert df.shape == (24, 7) and dw.shape == (6, 4)


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------

def test_identity_cost_by_hand_at_the_minibatch_shape():
    """Mini-batch layer 2 (f32, B 8,192, K 15, D 256), dfeats only: g
    (8,388,608 B) + w (491,520 B) + dfeats (125,829,120 B), no idx; one
    multiply an element; 0.0402 ms at 3.35 TB/s, bound by bytes."""
    b, k, d = 8192, 15, 256
    nbytes, flops = C.identity_cost(b, k, d, 4, (True, False, False, False),
                                    False)
    assert nbytes == b * d * 4 + b * k * 4 + b * k * d * 4 == 134_709_248
    assert flops == b * k * d == 31_457_280
    ms, by = C.least_ms(nbytes, flops, C.F32_FLOPS_PER_S)
    assert (round(ms, 4), by) == (0.0402, "bytes")
    # dw reads the table rows and writes dw; the fused terms add theirs
    assert C.identity_cost(b, k, d, 4, (False, True, False, False),
                           False) == (b * d * 4 + b * k * d * 4 + b * k * 4,
                                      2 * b * k * d)
    assert C.identity_cost(b, k, d, 2, (False, False, True, True),
                           True) == (b * d * 2 + 2 * (b * d * 2 + b * 2),
                                     3 * b * d)
    g = torch.zeros(b, d)
    assert C.bound_bwd_identity(torch.zeros(b, k), g, None,
                                (True, False, False, False))[2] == nbytes


def test_identity_stand_in_is_noted_on_meta_tensors():
    """On shape-only tensors the identity mode notes its cost under
    ``backward_identity`` and launches nothing."""
    from repro_torch.launch import roofline as R
    w = torch.rand(6, 4, device="meta")
    nb = torch.rand(6, 4, 7, device="meta", requires_grad=True)
    ops.reset_launches()
    with R.TraceCounter() as tc:
        out = ops.neighbor_agg_batch(w, nb)
        (dnb,) = torch.autograd.grad(out.sum(), nb)
    assert dnb.shape == nb.shape and dnb.device.type == "meta"
    assert dict(tc.kernel_calls) == {"tiled_direct": 1,
                                     "backward_identity": 1}
    assert ops.launch_counts()["backward_identity"] == 0
