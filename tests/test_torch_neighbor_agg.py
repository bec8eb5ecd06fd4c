"""The port's neighbor aggregation against the live reference: the sweeps
of tests/test_kernels.py, run through the JAX wrapper's plain path
(``use_kernel=False``) and — on a few cases, since each interpret-mode
compile costs seconds — its Pallas kernel in interpret mode, and through
the port's plain path and kernel path (its plain version on these CPU
tensors).  Tolerances: 1e-5 for f32, 2e-2 for bf16 (bf16
rounds the output once; summation order differs).  The CUDA kernel
itself is held against its plain version on the card by chip_smoke.py
and tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.neighbor_agg.ops import neighbor_agg as jax_agg  # noqa: E402

from repro_torch.kernels.neighbor_agg import ops  # noqa: E402
from repro_torch.kernels.neighbor_agg.ops import neighbor_agg  # noqa: E402
from repro_torch.kernels.neighbor_agg.ref import neighbor_agg_ref  # noqa: E402

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


def test_row_kernel_not_ported():
    feats, idx, w = (torch.tensor(a) for a in _inputs(1, 8, 4, 2, 3))
    with pytest.raises(NotImplementedError, match="Queue 2"):
        neighbor_agg(feats, idx, w, use_kernel=True, kernel="row")
    with pytest.raises(ValueError, match="'row' or 'tiled'"):
        neighbor_agg(feats, idx, w, use_kernel=True, kernel="flash")


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
