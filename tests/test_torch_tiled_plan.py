"""The tiled forward's plan (``ops.tiled_plan``): the route it picks from
the shapes alone and the slab route's column slabs, checked on the CPU.

* The slabs cover each column once, start 8-byte aligned within a row
  and are ``slab_bytes`` wide but the last; the plain version run slab
  by slab on them and concatenated equals the whole call bit for bit,
  fused and unfused.  The inputs are small integers and weights in
  eighths, so every sum is exact: the CPU's einsum sums in an order that
  depends on the slice width, which would move random f32 sums in the
  last bit, while a column taken twice, left out or shifted still shows.
* Identity-id shapes (the mini-batch levels), the serving build's chunks
  (B < N) and tables that fit L2 take the direct route; the full-graph
  shape at D = 128 bf16 the slab route, where rows are whole L2 lines;
  D = 172 the direct route (its rows straddle lines).
* The private route override does nothing on CPU tensors and refuses an
  unknown route or width.
* A small ELL graph at odd D through the port's kernel path (its plain
  version on these CPU tensors) against the reference's tiled Pallas
  kernel in interpret mode: 1e-5 (f32), 2e-2 (bf16, one rounding of the
  output; summation order differs).

The slab kernel itself is held against the plain version and the direct
route on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import numpy as np
import pytest
import torch

from repro_torch.core.graph import to_ell
from repro_torch.data.synth import make_sbm_graph
from repro_torch.kernels.neighbor_agg import ops
from repro_torch.kernels.neighbor_agg.ops import neighbor_agg, tiled_plan
from repro_torch.kernels.neighbor_agg.ref import neighbor_agg_ref

DTYPES = [torch.float32, torch.bfloat16]
N_FULL = 524_288            # the full-graph shape's nodes (gnn-papers100m cut)


def _exact_inputs(seed, n, b, k, d, fused):
    """Small integers and weights in eighths: every product and sum of
    the plain version is exact in f32, whatever its order."""
    rng = np.random.default_rng(seed)
    out = [rng.integers(-8, 9, (n, d)).astype(np.float32),
           rng.integers(0, n, (b, k)).astype(np.int32),
           (rng.integers(0, 9, (b, k)) / 8).astype(np.float32)]
    if fused:
        out += [rng.integers(-8, 9, (b, d)).astype(np.float32),
                (rng.integers(0, 9, b) / 8).astype(np.float32)]
    return out


@pytest.mark.parametrize("slab_bytes", ops.SLAB_WIDTHS)
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1, 37, 43, 128, 172, 256, 300])
def test_plan_covers_each_column_once(d, dtype, fused, slab_bytes):
    el = torch.empty((), dtype=dtype).element_size()
    plan = tiled_plan(N_FULL, N_FULL, 32, d, dtype, slab_bytes)
    assert plan.slab_cols * el == slab_bytes
    cols = [c for lo, hi in plan.bounds for c in range(lo, hi)]
    assert cols == list(range(d))
    for i, (lo, hi) in enumerate(plan.bounds):
        assert lo * el % 8 == 0                      # 8-byte aligned start
        assert hi - lo == (plan.slab_cols if i < len(plan.bounds) - 1
                           else d - lo)
    assert len(plan.bounds) == -(-d * el // slab_bytes)
    assert tiled_plan(N_FULL, N_FULL, 32, d, dtype).slab_cols * el == \
        ops.SLAB_BYTES
    # the plain version slab by slab on these bounds, concatenated
    t = [torch.tensor(a) for a in _exact_inputs(d, 400, 150, 33, d, fused)]
    feats, idx, w, *rest = [x if x.dtype == torch.int32 else x.to(dtype)
                            for x in t]
    self_rows, w_self = rest if fused else (None, None)
    parts = [neighbor_agg_ref(
        feats[:, lo:hi].contiguous(), idx, w,
        None if self_rows is None else self_rows[:, lo:hi].contiguous(),
        w_self) for lo, hi in plan.bounds]
    assert torch.equal(torch.cat(parts, 1),
                       neighbor_agg_ref(feats, idx, w, self_rows, w_self))


@pytest.mark.parametrize("n,b,k,d,dtype,route", [
    # the full-graph shape, layers 1 and 2 (bf16 gathers): 256 B rows are
    # two whole L2 lines (slab); 344 B rows straddle lines (direct)
    (N_FULL, N_FULL, 32, 128, torch.bfloat16, "slab"),
    (N_FULL, N_FULL, 32, 172, torch.bfloat16, "direct"),
    # the serving build's chunks (B < N: L2 cold at each chunk's gather),
    # and the f32 fused cell (688 B rows)
    (N_FULL, 65_536, 32, 128, torch.bfloat16, "direct"),
    (N_FULL, 65_536, 32, 172, torch.bfloat16, "direct"),
    (N_FULL, 65_536, 32, 172, torch.float32, "direct"),
    # GCN's serving build, f32: a 32 MiB table stays direct, 64 MiB not
    (65_536, 65_536, 32, 128, torch.float32, "direct"),
    (65_536, 65_536, 32, 256, torch.float32, "slab"),
    # the mini-batch levels at b = 8192, fan-out (15, 10): identity ids
    (8192 * 15, 8192, 15, 128, torch.float32, "direct"),
    (8192 * 150, 8192 * 15, 10, 128, torch.float32, "direct"),
    (8192 * 15, 8192, 15, 256, torch.float32, "direct"),
    # tables that fit L2
    (4096, 4096, 32, 128, torch.bfloat16, "direct"),
    (65_536, 65_536, 32, 64, torch.float32, "direct"),
    # one slab spans the row: nothing to cut
    (N_FULL, N_FULL, 32, 64, torch.bfloat16, "direct"),
])
def test_plan_routes_by_shape(n, b, k, d, dtype, route):
    assert tiled_plan(n, b, k, d, dtype).route == route


def test_plan_thresholds():
    """The L2 budget, ``b >= n`` and ``b * k > n`` are the edges of the
    slab route, on either side."""
    el = 2
    d = 128
    n_fit = ops.L2_TABLE_BYTES // (d * el)
    assert tiled_plan(n_fit, n_fit, 32, d, torch.bfloat16).route == "direct"
    assert tiled_plan(n_fit + 1, n_fit + 1, 32, d,
                      torch.bfloat16).route == "slab"
    assert tiled_plan(N_FULL, N_FULL - 1, 32, d,
                      torch.bfloat16).route == "direct"
    assert tiled_plan(N_FULL, N_FULL + 1, 32, d,
                      torch.bfloat16).route == "slab"
    assert tiled_plan(N_FULL, N_FULL, 1, d,
                      torch.bfloat16).route == "direct"
    assert tiled_plan(N_FULL, N_FULL, 2, d,
                      torch.bfloat16).route == "slab"
    with pytest.raises(ValueError, match="slab_bytes"):
        tiled_plan(N_FULL, N_FULL, 32, d, torch.bfloat16, 48)


@pytest.mark.parametrize("route", ["slab", "direct"])
def test_route_override_is_a_no_op_on_cpu(route):
    feats, idx, w = (torch.tensor(a) for a in
                     _exact_inputs(5, 60, 20, 7, 43, False))
    ops.reset_launches()
    with ops._tiled_route(route):
        out = neighbor_agg(feats, idx, w, use_kernel=True)
    with ops._tiled_route(route, 32):
        out32 = neighbor_agg(feats, idx, w, use_kernel=True)
    want = neighbor_agg_ref(feats, idx, w)
    assert torch.equal(out, want) and torch.equal(out32, want)
    assert set(ops.launch_counts().values()) == {0}
    assert ops._forced_route is None                # restored on exit


def test_route_override_refuses_unknown_names():
    with pytest.raises(ValueError, match="route"):
        with ops._tiled_route("simt"):
            pass
    with pytest.raises(ValueError, match="slab_bytes"):
        with ops._tiled_route("slab", 96):
            pass
    assert ops._forced_route is None


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_small_ell_graph_matches_reference_kernel(dtype, tol, fused):
    """A 300-node SBM graph's ELL (GCN weights; the self term fused) at
    D = 43 through the port's kernel path, against the reference's
    tiled Pallas kernel in interpret mode."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.neighbor_agg.ops import neighbor_agg as jax_agg
    g = make_sbm_graph(n=300, n_classes=4, avg_degree=10, feat_dim=43,
                       seed=3)
    idx, w, w_self = to_ell(g, max_deg=16)
    feats = g.feats.astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    self_args = (feats, w_self) if fused else ()
    want = np.asarray(jax_agg(
        jnp.asarray(feats, jdt), jnp.asarray(idx), jnp.asarray(w, jdt),
        *(jnp.asarray(a, jdt) for a in self_args), use_kernel=True,
        interpret=True, kernel="tiled"), np.float32)
    got = neighbor_agg(torch.tensor(feats).to(tdt), torch.tensor(idx),
                       torch.tensor(w).to(tdt),
                       *(torch.tensor(a).to(tdt) for a in self_args),
                       use_kernel=True).float().numpy()
    assert feats.shape[1] == 43 and idx.shape == (300, 16)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
