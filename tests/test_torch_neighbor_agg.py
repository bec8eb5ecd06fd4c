"""The port's neighbor aggregation against the live reference: the sweeps
of tests/test_kernels.py, run through the JAX wrapper's plain path
(``use_kernel=False``) and — on a few cases, since each interpret-mode
compile costs seconds — its Pallas kernels in interpret mode, and through
the port's plain path and kernel path (its plain versions on these CPU
tensors).  Forward tolerances: 1e-5 for f32, 2e-2 for bf16 (bf16
rounds the output once; summation order differs).  Gradient tolerances:
1e-3 (f32), as tests/test_kernels.py uses for the reference's VJP, and
2e-2 (bf16, one rounding of each cotangent).  The CUDA kernels
themselves are held against their plain versions on the card by
chip_smoke.py and tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.neighbor_agg import ops as jax_ops  # noqa: E402
from repro.kernels.neighbor_agg.ops import neighbor_agg as jax_agg  # noqa: E402

from repro_torch.kernels.neighbor_agg import ops  # noqa: E402
from repro_torch.kernels.neighbor_agg.ops import neighbor_agg  # noqa: E402
from repro_torch.kernels.neighbor_agg.ref import (  # noqa: E402
    neighbor_agg_backward_ref, neighbor_agg_ref)

DT = {"float32": (jnp.float32, torch.float32, 1e-5),
      "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, n, d, b, k, density=0.3, fused=False):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, d)).astype(np.float32)
    idx = rng.integers(0, n, (b, k)).astype(np.int32)
    w = (rng.random((b, k)) * (rng.random((b, k)) > density)
         ).astype(np.float32)
    if not fused:
        return feats, idx, w
    return (feats, idx, w, rng.normal(size=(b, d)).astype(np.float32),
            rng.random(b).astype(np.float32))


def _jax(arrays, jdt, **kw):
    feats, idx, w, *rest = arrays
    rest = [jnp.asarray(r, jdt) for r in rest]
    return np.asarray(jax_agg(jnp.asarray(feats, jdt), jnp.asarray(idx),
                              jnp.asarray(w, jdt), *rest, **kw), np.float32)


def _torch(arrays, tdt, **kw):
    feats, idx, w, *rest = arrays
    rest = [torch.tensor(r).to(tdt) for r in rest]
    return neighbor_agg(torch.tensor(feats).to(tdt), torch.tensor(idx),
                        torch.tensor(w).to(tdt), *rest, **kw).float().numpy()


def _close(a, b, tol):
    np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,b,k,interpret", [
    (64, 32, 8, 4, False),
    (128, 128, 16, 5, False),
    (50, 96, 4, 3, False),
    (200, 256, 32, 15, True),  # paper's beta=15, against the Pallas kernel
    (16, 8, 16, 1, False),
])
def test_matches_reference(n, d, b, k, interpret, dtype):
    jdt, tdt, tol = DT[dtype]
    arrays = _inputs(n + d, n, d, b, k)
    want_plain = _jax(arrays, jdt, use_kernel=False)
    _close(_torch(arrays, tdt, use_kernel=False), want_plain, tol)
    _close(_torch(arrays, tdt, use_kernel=True), want_plain, tol)
    if interpret:
        want_kernel = _jax(arrays, jdt, use_kernel=True, interpret=True,
                           kernel="tiled", d_tile=128)
        _close(_torch(arrays, tdt, use_kernel=True), want_kernel, tol)


def test_ragged_tiles():
    """B/D/K that divide no reference tile (b_tile=4, k_slab=2, d_tile
    128 against B=13, K=7, D=80): the port masks instead of padding, and
    must agree with the reference's padded kernel."""
    arrays = _inputs(11, 100, 80, 13, 7, density=0.4)
    want = _jax(arrays, jnp.float32, use_kernel=True, interpret=True,
                kernel="tiled", b_tile=4, k_slab=2)
    _close(_torch(arrays, torch.float32, use_kernel=True), want, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zero_weights_give_zero(dtype):
    _, tdt, _ = DT[dtype]
    feats, idx, _ = _inputs(3, 32, 64, 4, 6)
    out = _torch((feats, idx, np.zeros((4, 6), np.float32)), tdt,
                 use_kernel=True)
    np.testing.assert_array_equal(out, 0.0)


def test_is_gcn_aggregation(small_graph):
    """The paper's Ã-weighted aggregation on the conftest graph's ELL."""
    from repro.core.graph import to_ell
    idx, w, _ = to_ell(small_graph)
    arrays = (small_graph.feats, idx, w)
    want = _jax(arrays, jnp.float32, use_kernel=False)
    _close(_torch(arrays, torch.float32, use_kernel=True), want, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,b,k,interpret", [
    (64, 32, 8, 4, False),
    (100, 80, 13, 7, True),    # B/D/K all padded by the reference
    (200, 256, 32, 15, False),
])
def test_fused_self_epilogue(n, d, b, k, interpret, dtype):
    """The fused w_self·self_rows epilogue (accumulator init) against the
    reference's fused kernel and its aggregate-then-add plain path."""
    jdt, tdt, tol = DT[dtype]
    arrays = _inputs(n * k, n, d, b, k, fused=True)
    want_plain = _jax(arrays, jdt, use_kernel=False)
    _close(_torch(arrays, tdt, use_kernel=False), want_plain, tol)
    _close(_torch(arrays, tdt, use_kernel=True), want_plain, tol)
    if interpret:
        _close(_torch(arrays, tdt, use_kernel=True),
               _jax(arrays, jdt, use_kernel=True, interpret=True,
                    kernel="tiled"), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,b,k,fused", [
    (64, 32, 8, 4, False),
    (50, 96, 4, 3, True),      # D padded to d_tile by the reference
])
def test_row_kernel_matches_reference(n, d, b, k, fused, dtype):
    """kernel="row" against the reference's row kernel in interpret mode
    (its self term added outside the kernel on both sides)."""
    jdt, tdt, tol = DT[dtype]
    arrays = _inputs(n + k, n, d, b, k, fused=fused)
    want = _jax(arrays, jdt, use_kernel=True, interpret=True, kernel="row")
    before = ops.row_launches
    _close(_torch(arrays, tdt, use_kernel=True, kernel="row"), want, tol)
    assert ops.row_launches == before          # CPU: the plain version


def test_row_kernel_dispatch():
    feats, idx, w = (torch.tensor(a) for a in _inputs(1, 8, 4, 2, 3))
    torch.testing.assert_close(
        neighbor_agg(feats, idx, w, use_kernel=True, kernel="row"),
        neighbor_agg_ref(feats, idx, w), rtol=0, atol=0)
    with pytest.raises(ValueError, match="'row' or 'tiled'"):
        neighbor_agg(feats, idx, w, use_kernel=True, kernel="flash")


GTOL = {"float32": 1e-3, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [False, True])
def test_plain_backward_matches_reference_bwd(fused, dtype):
    """ref.neighbor_agg_backward_ref against the reference's _agg_bwd /
    _agg_self_bwd (plain jnp, no Pallas) on the same numpy inputs,
    repeated ids included (so dfeats sums several edges per row)."""
    jdt, tdt, _ = DT[dtype]
    tol = GTOL[dtype]
    arrays = _inputs(7, 30, 40, 24, 9, fused=True)
    feats, idx, w, sr, ws = arrays
    g = np.random.default_rng(8).normal(size=(24, 40)).astype(np.float32)
    j = [jnp.asarray(a, jdt) if a.dtype == np.float32 else jnp.asarray(a)
         for a in (feats, idx, w, sr, ws, g)]
    t = [torch.tensor(a) if a.dtype == np.int32 else torch.tensor(a).to(tdt)
         for a in (feats, idx, w, sr, ws, g)]
    if fused:
        want = jax_ops._agg_self_bwd(None, tuple(j[:5]), j[5])
        want = (want[0], want[2], want[3], want[4])
        got = neighbor_agg_backward_ref(t[0], t[1], t[2], t[5], t[3], t[4])
    else:
        want = jax_ops._agg_bwd(None, tuple(j[:3]), j[5])
        want = (want[0], want[2])
        got = neighbor_agg_backward_ref(t[0], t[1], t[2], t[5])[:2]
    for name, a, b in zip(("dfeats", "dw", "dself", "dw_self"), got, want):
        assert a.dtype == tdt, name
        _close(a.float().numpy(), np.asarray(b, np.float32), tol)


def _grads_jax(arrays, g, kernel, fused):
    feats, idx, w, *rest = [jnp.asarray(a) for a in arrays]

    def loss(*diff):
        out = jax_agg(diff[0], idx, diff[1], *diff[2:], use_kernel=True,
                      interpret=True, kernel=kernel)
        return jnp.sum(out * jnp.asarray(g))

    diff = (feats, w, *rest) if fused else (feats, w)
    return [np.asarray(x) for x in
            jax.grad(loss, argnums=tuple(range(len(diff))))(*diff)]


def _grads_torch(arrays, g, kernel, fused):
    t = [torch.tensor(a) for a in arrays]
    diff = [x.requires_grad_() for i, x in enumerate(t) if i != 1]
    if not fused:
        diff = diff[:2]
    out = neighbor_agg(t[0], t[1], t[2], *(t[3:] if fused else ()),
                       use_kernel=True, kernel=kernel)
    return [x.numpy() for x in
            torch.autograd.grad(out, diff, torch.tensor(g))]


@pytest.mark.parametrize("kernel,fused", [("tiled", False), ("tiled", True),
                                          ("row", False)])
def test_vjp_matches_reference_kernel_vjp(kernel, fused):
    """The port's VJP (the autograd Function; its backward's plain
    version on CPU) against jax.grad through the reference's Pallas
    kernel in interpret mode: every cotangent at 1e-3."""
    arrays = _inputs(21, 40, 48, 12, 5, fused=fused)
    g = np.random.default_rng(22).normal(size=(12, 48)).astype(np.float32)
    want = _grads_jax(arrays, g, kernel, fused)
    got = _grads_torch(arrays, g, kernel, fused)
    assert len(got) == len(want) == (4 if fused else 2)
    for a, b in zip(got, want):
        _close(a, b, 1e-3)


@pytest.mark.parametrize("fused", [False, True])
def test_plain_backward_is_autograd_of_plain_forward(fused):
    """In f32 the explicit plain backward equals torch autograd through
    neighbor_agg_ref (the same function, differentiated)."""
    t = [torch.tensor(a) for a in _inputs(5, 25, 16, 10, 6, fused=fused)]
    g = torch.randn(10, 16, generator=torch.Generator().manual_seed(0))
    diff = [x.requires_grad_() for i, x in enumerate(t) if i != 1]
    want = torch.autograd.grad(neighbor_agg_ref(*t), diff, g)
    got = [x for x in neighbor_agg_backward_ref(t[0], t[1], t[2], g, *t[3:])
           if x is not None]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_backward_asks_only_for_needed_cotangents(monkeypatch):
    """needs_input_grad reaches the backward: with only the table
    requiring a gradient (the model paths) the dot for dw is not asked
    for, and with only w the scatter is not."""
    seen = []
    real = ops._backward

    def spy(feats, idx, w, g, self_rows, w_self, need):
        seen.append(tuple(need))
        return real(feats, idx, w, g, self_rows, w_self, need)

    monkeypatch.setattr(ops, "_backward", spy)
    feats, idx, w, sr, ws = (torch.tensor(a) for a in
                             _inputs(3, 20, 8, 6, 4, fused=True))
    f = feats.clone().requires_grad_()
    out = neighbor_agg(f, idx, w, use_kernel=True)
    (df,) = torch.autograd.grad(out.sum(), [f])
    ww = w.clone().requires_grad_()
    out = neighbor_agg(feats, idx, ww, sr, ws, use_kernel=True)
    (dw,) = torch.autograd.grad(out.sum(), [ww])
    assert seen == [(True, False, False, False),
                    (False, True, False, False)]
    assert df.shape == feats.shape and dw.shape == w.shape


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gcn_table_used_twice_sums_both_cotangents(dtype):
    """GCN's fused epilogue feeds the source table as both the gathered
    table and self_rows: its gradient is dfeats + dself, as autograd of
    the reference's plain path gives."""
    jdt, tdt, _ = DT[dtype]
    rng = np.random.default_rng(9)
    table = rng.normal(size=(30, 12)).astype(np.float32)
    idx = rng.integers(0, 30, (30, 5)).astype(np.int32)
    w = rng.random((30, 5)).astype(np.float32)
    ws = rng.random(30).astype(np.float32)
    g = rng.normal(size=(30, 12)).astype(np.float32)

    def jloss(tab):
        out = jax_agg(tab, jnp.asarray(idx), jnp.asarray(w, jdt), tab,
                      jnp.asarray(ws, jdt))
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(table, jdt)), np.float32)
    tab = torch.tensor(table).to(tdt).requires_grad_()
    out = neighbor_agg(tab, torch.tensor(idx), torch.tensor(w).to(tdt), tab,
                       torch.tensor(ws).to(tdt), use_kernel=True)
    (got,) = torch.autograd.grad(out.float(), [tab], torch.tensor(g))
    _close(got.float().numpy(), want, GTOL[dtype])


def test_cpu_takes_plain_version_without_launch():
    arrays = _inputs(2, 40, 24, 9, 5, fused=True)
    before = ops.launches
    t = [torch.tensor(a) for a in arrays]
    out = neighbor_agg(*t, use_kernel=True)
    assert ops.launches == before
    torch.testing.assert_close(out, neighbor_agg_ref(*t), rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["idx64", "w_dtype", "shape", "noncontig",
                                 "self_only", "feats_f16", "self_shape"])
def test_kernel_path_rejects_what_the_kernel_does_not_take(bad):
    feats, idx, w, sr, ws = (torch.tensor(a) for a in
                             _inputs(4, 20, 16, 6, 3, fused=True))
    args = [feats, idx, w, sr, ws]
    if bad == "idx64":
        args[1] = idx.long()
    elif bad == "w_dtype":
        args[2] = w.double()
    elif bad == "shape":
        args[2] = w[:, :2]
    elif bad == "noncontig":
        args[0] = torch.tensor(np.asfortranarray(feats.numpy()))
        assert not args[0].is_contiguous()
    elif bad == "self_only":
        args[4] = None
    elif bad == "feats_f16":
        args = [a.half() if a.is_floating_point() else a for a in args]
    elif bad == "self_shape":
        args[3] = sr[:, :8].contiguous()
    with pytest.raises(ValueError):
        neighbor_agg(*args, use_kernel=True)


@pytest.mark.parametrize("fused", [False, True])
def test_f32_output_of_a_bf16_table_is_the_unrounded_sum(fused):
    """A bf16 table with an f32 output (the featshard phases' partial
    sums): the f32 sum of the bf16 values, which rounds to the bf16
    output bit for bit."""
    arrays = _inputs(5, 40, 24, 9, 5, fused=fused)
    bf, f32 = torch.bfloat16, torch.float32
    feats, idx, w = (torch.tensor(arrays[0]).to(bf), torch.tensor(arrays[1]),
                     torch.tensor(arrays[2]).to(bf))
    rest = [torch.tensor(a).to(bf) for a in arrays[3:]]
    rest32 = [r.float() for r in rest]
    ops._check_kernel_args(feats, idx, w, *(rest32 or [None, None]),
                           out_dtype=f32)
    got = ops._forward("tiled", feats, idx, w, *rest32, out_dtype=f32)
    assert got.dtype == f32
    want = neighbor_agg_ref(feats.float(), idx, w.float(), *rest32)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.equal(got.to(bf),
                       ops._forward("tiled", feats, idx, w, *rest))


@pytest.mark.parametrize("bad", ["f32_table_bf16_out", "self_rows_bf16",
                                 "w_self_bf16"])
def test_f32_output_takes_f32_epilogue_operands_only(bad):
    feats, idx, w, sr, ws = (torch.tensor(a) for a in
                             _inputs(6, 20, 16, 6, 3, fused=True))
    bf = torch.bfloat16
    out_dtype = torch.float32
    if bad == "f32_table_bf16_out":
        out_dtype = bf
    else:
        feats, w = feats.to(bf), w.to(bf)
        if bad == "self_rows_bf16":
            sr = sr.to(bf)
        else:
            ws = ws.to(bf)
    with pytest.raises(ValueError):
        ops._check_kernel_args(feats, idx, w, sr, ws, out_dtype=out_dtype)
