"""Card-only tests of the port (skipped without CUDA; no JAX needed, so
they run on the card's machine):

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

The CUDA neighbor-aggregation kernels (tiled forward, backward, row)
against their plain versions at the model paths' widths (the backward's
identity mode bit-equal to its plain version and to the general mode,
the row kernel bit-equal to the direct route), a small serving
build whose kernel path must launch the kernel and match the plain
forward, and one training step whose gradients through the kernels must
match the plain path.  Forward tolerances: 1e-5 (f32), 2e-2 (bf16).
Backward: 1e-3 (f32; dfeats sums with atomics in an order that changes
from run to run), 2e-2 (bf16).  The reverse-index backward kernel (the
full-graph path's dfeats) row by row against its plain version in f32
(``row_rel_err``): 1e-5 in f32, 2^-8 (one bf16 rounding) in bf16, rows
with no edge exactly 0, repeat calls bit-equal, and a full-graph training
step that launches it once and the atomic kernel never.  The tiled
forward's slab route row by row against the plain version in f32 (the
same limits) at ragged shapes and every slab width, bit-equal to the
direct route and to itself, and the launch counts by route.  The
cluster source's steps launch the reverse-index backward once each and
the planned tiled routes; the cluster and importance sources agree
between the CPU and the card at 1e-4; exact resume on the card is
bit-equal for all four sources.

The CUDA flash-attention kernels against their plain version (2e-5 f32,
3e-2 bf16, the tolerances of tests/test_flash_attn.py; the tensor-core
kernel also row by row against the plain version in f32, at most 2^-7 of
each row, ``ref.row_rel_err``): every input goes
to the kernel ``kernel_route`` names (the tensor-core kernel for bf16 at
head dims 64-256, 112 among them, the tf32x3 kernel for the rest), with
cases at zamba2-7b's head dim 112 and cases that wrap the
tensor-core kernel's ring and cross its masks, two calls bit-equal, the
argument checks, a small-config prefill that launches the routed
kernel once per layer, and zamba2-7b's smoke config with the kernel
against without it."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.core import gnn as G
from repro_torch.core.embedding_store import EmbeddingStore
from repro_torch.data.synth import make_sbm_graph
from repro_torch.kernels.neighbor_agg import ops
from repro_torch.kernels.neighbor_agg.ops import neighbor_agg
from repro_torch.kernels.neighbor_agg.ref import (neighbor_agg_backward_ref,
                                                  neighbor_agg_ref)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, n, d, b, k, fused):
    rng = np.random.default_rng(seed)
    out = [rng.normal(size=(n, d)).astype(np.float32),
           rng.integers(0, n, (b, k)).astype(np.int32),
           (rng.random((b, k)) * (rng.random((b, k)) > 0.3)
            ).astype(np.float32)]
    if fused:
        out += [rng.normal(size=(b, d)).astype(np.float32),
                rng.random(b).astype(np.float32)]
    return out


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n,d,b,k", [(4096, 128, 1000, 32),
                                     (4096, 172, 777, 32),
                                     (300, 300, 13, 33)])
def test_kernel_matches_plain_version(cuda, n, d, b, k, dtype, tol, fused):
    t = [torch.tensor(a, device=cuda) for a in
         _inputs(d + k, n, d, b, k, fused)]
    t = [x if x.dtype == torch.int32 else x.to(dtype) for x in t]
    before = ops.launches
    out = neighbor_agg(*t, use_kernel=True)
    assert ops.launches == before + 1
    torch.testing.assert_close(out.float(), neighbor_agg_ref(*t).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("n,d,b,k", [(4096, 128, 1000, 32),
                                     (4096, 172, 777, 32)])
def test_f32_output_kernel_matches_plain_version(cuda, n, d, b, k, fused):
    """A bf16 table with f32 self_rows / w_self / out (the featshard
    phases): within 1e-5 of the plain version's f32 sum, and rounded to
    bf16 bit-equal to the bf16 launch (one accumulation chain); direct
    route only."""
    bf, f32 = torch.bfloat16, torch.float32
    arrays = [torch.tensor(a, device=cuda)
              for a in _inputs(3, n, d, b, k, fused)]
    feats, idx, w = arrays[0].to(bf), arrays[1], arrays[2].to(bf)
    rest = [a.to(bf) for a in arrays[3:]]
    rest32 = [r.float() for r in rest]
    ops.reset_launches()
    got = ops._forward("tiled", feats, idx, w, *rest32, out_dtype=f32)
    assert got.dtype == f32 and ops.launch_counts()["tiled_direct"] == 1
    want = neighbor_agg_ref(feats.float(), idx, w.float(), *rest32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got.to(bf),
                       ops._forward("tiled", feats, idx, w, *rest))
    with ops._tiled_route("slab"), pytest.raises(ValueError):
        ops._forward("tiled", feats, idx, w, *rest32, out_dtype=f32)


def test_kernel_rejects_mixed_devices(cuda):
    feats, idx, w = (torch.tensor(a) for a in _inputs(0, 10, 8, 4, 3, False))
    with pytest.raises(ValueError, match="one device"):
        neighbor_agg(feats.to(cuda), idx, w.to(cuda), use_kernel=True)


@pytest.mark.parametrize("model,dtype", [("graphsage", "bfloat16"),
                                         ("gcn", "float32")])
def test_serving_build_launches_kernel(cuda, model, dtype):
    g = make_sbm_graph(n=3000, n_classes=6, avg_degree=12, feat_dim=48,
                       seed=2)
    cfg = GNNConfig(name="c", model=model, n_nodes=g.n, feat_dim=48,
                    hidden=64, n_classes=g.n_classes, n_layers=2,
                    fanout=(4, 3), batch_size=32, dtype=dtype,
                    use_agg_kernel=True)
    params = G.init_gnn(torch.Generator().manual_seed(0), cfg, 48,
                        device=cuda)
    store = EmbeddingStore(params, cfg, g, chunk_size=700, max_deg=16,
                           device=cuda)
    before = ops.launches
    run = store.build()
    assert ops.launches - before == 2 * run.stats["n_chunks"]
    plain = dataclasses.replace(cfg, use_agg_kernel=False)
    t = [torch.as_tensor(a, device=cuda)
         for a in (g.feats, store.idx, store.w, store.w_self)]
    _, want = G.full_graph_forward(params, plain, *t, return_layers=True)
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    for a, b in zip(run.layers, want):
        torch.testing.assert_close(a, b, atol=tol, rtol=tol)


SHAPES = [(4096, 128, 1000, 32), (4096, 172, 777, 32), (300, 300, 13, 33),
          (50, 20, 5, 0)]


def _cast(t, dtype):
    return [x if x.dtype == torch.int32 else x.to(dtype) for x in t]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n,d,b,k", SHAPES)
def test_backward_kernel_matches_plain_version(cuda, n, d, b, k, dtype, tol,
                                               fused):
    t = _cast([torch.tensor(a, device=cuda) for a in
               _inputs(d + k + 1, n, d, b, k, fused)], dtype)
    g = torch.randn(b, d, device=cuda).to(dtype)
    diff = [x.requires_grad_() for i, x in enumerate(t) if i != 1]
    before = ops.backward_launches
    out = neighbor_agg(*t, use_kernel=True)
    got = torch.autograd.grad(out, diff, g)
    assert ops.backward_launches == before + 1
    want = [x for x in neighbor_agg_backward_ref(
        *[x.detach() for x in t[:3]], g, *[x.detach() for x in t[3:]])
        if x is not None]
    for a, c in zip(got, want):
        assert a.dtype == c.dtype
        torch.testing.assert_close(a.float(), c.float(), atol=tol, rtol=tol)


def test_backward_identity_ids_are_deterministic(cuda):
    """The mini-batch route: identity ids, so no two edges share a row
    and the atomics land in a fixed order."""
    b, k, d = 512, 10, 256
    table = torch.randn(b * k, d, device=cuda, requires_grad=True)
    idx = torch.arange(b * k, dtype=torch.int32, device=cuda).reshape(b, k)
    w = torch.rand(b, k, device=cuda)
    g = torch.randn(b, d, device=cuda)
    runs = [torch.autograd.grad(neighbor_agg(table, idx, w,
                                             use_kernel=True), table, g)[0]
            for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    torch.testing.assert_close(
        runs[0], neighbor_agg_backward_ref(table.detach(), idx, w, g)[0],
        atol=1e-6, rtol=1e-6)


def test_backward_zero_weights_and_bad_id(cuda):
    feats = torch.randn(64, 40, device=cuda, requires_grad=True)
    idx = torch.randint(0, 64, (16, 5), device=cuda, dtype=torch.int32)
    w = torch.zeros(16, 5, device=cuda, requires_grad=True)
    g = torch.randn(16, 40, device=cuda)
    df, _ = torch.autograd.grad(neighbor_agg(feats, idx, w,
                                             use_kernel=True), (feats, w), g)
    assert bool((df == 0).all())
    idx[3, 2] = 64
    w2 = torch.rand(16, 5, device=cuda, requires_grad=True)
    df, dw = torch.autograd.grad(
        neighbor_agg(feats, idx, w2, use_kernel=True), (feats, w2), g)
    assert bool(torch.isnan(dw[3, 2])) and int(torch.isnan(dw).sum()) == 1
    keep = torch.ones(16, dtype=torch.bool, device=cuda)
    keep[3] = False
    want = neighbor_agg_backward_ref(feats.detach(), idx[keep],
                                     w2.detach()[keep], g[keep])
    torch.testing.assert_close(dw[keep], want[1], atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n,d,b,k", SHAPES)
def test_row_kernel_matches_plain_version(cuda, n, d, b, k, dtype, tol):
    t = _cast([torch.tensor(a, device=cuda) for a in
               _inputs(d + k + 2, n, d, b, k, False)], dtype)
    before = ops.row_launches
    out = neighbor_agg(*t, use_kernel=True, kernel="row")
    assert ops.row_launches == before + 1
    torch.testing.assert_close(out.float(), neighbor_agg_ref(*t).float(),
                               atol=tol, rtol=tol)


def _identity_case(seed, b, k, d, dtype, fused, device, offset=0):
    """Identity-id inputs (table [b*k, d], w with 30 % zeros, g, and
    fused self_rows / w_self) on the card; ``offset`` elements in front
    of the table's and g's storage, so their rows start unaligned."""
    rng = np.random.default_rng(seed)
    w = (rng.random((b, k)) * (rng.random((b, k)) > 0.3)).astype(np.float32)

    def put(a):
        flat = torch.zeros(a.size + offset, dtype=dtype, device=device)
        flat[offset:] = torch.tensor(a.reshape(-1), device=device).to(dtype)
        return flat[offset:].view(a.shape)
    out = [put(rng.normal(size=(b * k, d)).astype(np.float32)),
           torch.tensor(w, device=device).to(dtype),
           put(rng.normal(size=(b, d)).astype(np.float32))]
    if fused:
        out += [torch.tensor(rng.normal(size=(b, d)), device=device).to(
            dtype), torch.tensor(rng.random(b), device=device).to(dtype)]
    else:
        out += [None, None]
    return out


IDENTITY_NEEDS = [(True, False, False, False), (False, True, False, False),
                  (True, True, False, False), (True, True, True, True),
                  (False, False, True, True), (True, False, True, False)]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,k,d,offset", [(300, 15, 256, 0),
                                          (257, 15, 172, 0),
                                          (100, 10, 64, 0),
                                          (77, 7, 37, 0), (50, 1, 1, 0),
                                          (40, 3, 300, 0), (33, 15, 172, 1),
                                          (33, 15, 256, 2), (9, 0, 40, 0)])
def test_identity_kernel_equals_plain_and_general_mode(cuda, b, k, d,
                                                       offset, dtype, fused):
    """The backward kernel's identity mode at aligned rows (16-byte
    lanes), bf16 D = 172 (8-byte), odd D and rows offset by one or two
    elements (narrower lanes), for each ``need``: dfeats and dself
    ``torch.equal`` to the plain version and every output to the general
    mode on ``arange`` ids (the same __fmul_rn / __fmaf_rn chains); dw
    and dw_self, dot products summed in another order than the plain
    version's, within 1e-5 / 2e-2 of it."""
    table, w, g, sr, ws = _identity_case(b + k + d, b, k, d, dtype, fused,
                                         cuda, offset)
    ids = torch.arange(b * k, dtype=torch.int32, device=cuda).reshape(b, k)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    from repro_torch.kernels.neighbor_agg.ref import \
        neighbor_agg_backward_identity_ref
    for need in IDENTITY_NEEDS:
        if not fused and not any(need[:2]):
            continue
        before = ops.launch_counts()
        got = ops.neighbor_agg_backward_identity(table, w, g, sr, ws,
                                                 need=need)
        after = ops.launch_counts()
        assert after["backward_identity"] == before["backward_identity"] + 1
        assert after["backward"] == before["backward"]
        plain = neighbor_agg_backward_identity_ref(table, w, g, sr, ws, need)
        general = ops.neighbor_agg_backward(table, ids, w, g, sr, ws,
                                            need=need)
        for j, (a, p, q) in enumerate(zip(got, plain, general)):
            assert (a is None) == (p is None) == (q is None), (need, j)
            if a is None:
                continue
            assert a.dtype == p.dtype and torch.equal(a, q), (need, j)
            if j in (0, 2):
                assert torch.equal(a, p), (need, j)
            else:
                torch.testing.assert_close(a.float(), p.float(), atol=tol,
                                           rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_identity_kernel_streaming_stores_and_zero_weights(cuda, dtype):
    """dfeats through the streaming stores: a NaN in g behind an edge
    of weight 0 stays out of its row (+0), as in the general mode, and
    reaches the row of an edge of nonzero weight."""
    table, w, g, _, _ = _identity_case(4, 64, 15, 172, dtype, False, cuda)
    need = (True, False, False, False)
    w[3, :5] = 0
    w[3, 5] = 0.5
    g[3, 7] = float("nan")
    cs = ops._launch_backward_identity(table, w, g, None, None, need)[0]
    assert bool((cs[3 * 15: 3 * 15 + 5] == 0).all())
    assert not bool(torch.signbit(cs[3 * 15: 3 * 15 + 5]).any())
    assert bool(torch.isnan(cs[3 * 15 + 5, 7]))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [1, 2, 6, 37, 64, 172, 256, 300])
def test_general_mode_vector_atomics_at_ragged_d(cuda, d, dtype, tol):
    """The general mode's dfeats through vector reductions (float4 /
    float2, scalar where D allows neither) with ids that repeat (a 50-row
    table under 400 x 12 edges): within 1e-3 / 2e-2 of the plain
    version."""
    feats, idx, w, g = _csr_case(d, 50, 400, 12, d, dtype, cuda)
    feats = torch.randn(50, d, device=cuda).to(dtype)
    got = ops.neighbor_agg_backward(feats, idx, w, g)
    want = neighbor_agg_backward_ref(feats, idx, w, g)
    for a, c in zip(got[:2], want[:2]):
        assert a.dtype == c.dtype
        torch.testing.assert_close(a.float(), c.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,b,k", SHAPES + [(4096, 256, 999, 15),
                                              (500, 37, 65, 33),
                                              (300, 600, 20, 9)])
def test_row_kernel_equals_direct_route(cuda, n, d, b, k, dtype):
    """The row kernel and the tiled forward's direct route take the same
    __fmaf_rn chain in k order: bit-equal; an id outside [0, N) poisons
    its row with NaN in both."""
    t = _cast([torch.tensor(a, device=cuda) for a in
               _inputs(d + k + 3, n, d, b, k, False)], dtype)
    row = neighbor_agg(*t, use_kernel=True, kernel="row")
    with ops._tiled_route("direct"):
        direct = neighbor_agg(*t, use_kernel=True)
    assert torch.equal(row, direct)
    if b > 1 and k > 0:
        t[1][1, k - 1] = n
        row = neighbor_agg(*t, use_kernel=True, kernel="row")
        assert bool(torch.isnan(row[1]).all())
        assert bool(torch.isfinite(row[0]).all())


@pytest.mark.parametrize("model,dtype", [("graphsage", "bfloat16"),
                                         ("gcn", "float32")])
def test_training_step_grads_kernel_match_plain(cuda, model, dtype):
    """One full-graph and one mini-batch step's parameter gradients with
    the kernels on against the plain path (relative max error 2e-2 with
    bf16 aggregation, 1e-4 in f32)."""
    from repro_torch.core import engine as E
    g = make_sbm_graph(n=3000, n_classes=6, avg_degree=12, feat_dim=48,
                       seed=3)
    cfg = GNNConfig(name="c", model=model, n_nodes=g.n, feat_dim=48,
                    hidden=64, n_classes=g.n_classes, n_layers=2,
                    fanout=(5, 3), batch_size=256, dtype=dtype,
                    use_agg_kernel=True)
    plan = E.TrainPlan(n_iters=1, seed=0)
    params = G.init_gnn(torch.Generator().manual_seed(0), cfg, 48,
                        device=cuda)
    leaves = [v.requires_grad_() for p in params for v in p.values()]
    for src, tol in ((E.FullGraphSource(max_deg=16),
                      2e-2 if dtype == "bfloat16" else 1e-4),
                     (E.SampledSource(prefetch=False), 1e-4)):
        src.bind(g, cfg, plan, cuda)
        batch, _ = next(src.batches())
        grads = {}
        for kernel in (True, False):
            src.cfg = dataclasses.replace(cfg, use_agg_kernel=kernel)
            ops.reset_launches()
            grads[kernel] = torch.autograd.grad(src.loss(params, batch),
                                                leaves)
            n = ops.launch_counts()
            if not kernel:
                assert n["backward"] == n["backward_csr"] == 0
                assert n["backward_identity"] == 0
            elif isinstance(src, E.FullGraphSource):
                # dfeats by the reverse index; GCN's dself by the atomic
                # kernel, which then sends no atomics
                assert n["backward_csr"] == 1
                assert n["backward"] == (1 if model == "gcn" else 0)
                assert n["backward_identity"] == 0
            else:
                # the identity mode, never the atomic kernel
                assert n["backward_identity"] > 0
                assert n["backward"] == 0 and n["backward_csr"] == 0
        for a, b in zip(grads[True], grads[False]):
            err = float((a - b).abs().max() / b.abs().max())
            assert err <= tol, (type(src).__name__, err)
        src.done(batch)
        src.close()


def _csr_case(seed, n, b, k, d, dtype, device, empty_rows=0):
    """Inputs of the reverse-index backward: ids avoiding the last
    ``empty_rows`` rows (so they have no edge), 30 % zero weights."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, max(n - empty_rows, 1), (b, k)).astype(np.int32)
    w = (rng.random((b, k)) * (rng.random((b, k)) > 0.3)).astype(np.float32)
    g = rng.normal(size=(b, d)).astype(np.float32)
    feats = torch.zeros(n, d, device=device, dtype=dtype)
    return (feats, torch.tensor(idx, device=device),
            torch.tensor(w, device=device).to(dtype),
            torch.tensor(g, device=device).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,b,k,d,empty", [(4096, 4096, 32, 172, 0),
                                           (4096, 1000, 32, 128, 96),
                                           (1000, 1001, 7, 37, 10),
                                           (300, 13, 33, 300, 0),
                                           (50, 5, 0, 20, 0),
                                           (100, 77, 45, 256, 3)])
def test_backward_csr_kernel_matches_plain_version(cuda, n, b, k, d, empty,
                                                   dtype):
    from repro_torch.kernels.flash_attn.ref import row_rel_err
    from repro_torch.kernels.neighbor_agg.ref import (
        CSR_BF16_ROW_TOL, neighbor_agg_backward_csr_ref)
    feats, idx, w, g = _csr_case(n + b + k + d, n, b, k, d, dtype, cuda,
                                 empty)
    rev = ops.build_reverse_index(idx, w, n)
    before = ops.backward_csr_launches
    got = ops.neighbor_agg_backward(feats, idx, w, g, rev=rev,
                                    need=(True, False, False, False))[0]
    assert ops.backward_csr_launches == before + 1
    assert got.dtype == dtype
    ref32 = neighbor_agg_backward_csr_ref(rev, w.float(), g.float())
    tol = CSR_BF16_ROW_TOL if dtype == torch.bfloat16 else 1e-5
    assert row_rel_err(got, ref32) <= tol
    no_edge = rev.indptr[1:] == rev.indptr[:-1]
    assert int(no_edge.sum()) >= empty
    assert bool((got[no_edge] == 0).all())
    want = neighbor_agg_backward_ref(feats, idx, w, g,
                                     need=(True, False, False, False))[0]
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_csr_kernel_is_deterministic(cuda, dtype):
    """Edges added in the index's order: repeat calls are bit-equal, also
    where many edges share a row (the atomic kernel's are not)."""
    feats, idx, w, g = _csr_case(5, 2000, 20000, 32, 172, dtype, cuda)
    rev = ops.build_reverse_index(idx, w, 2000)
    runs = [ops.neighbor_agg_backward(feats, idx, w, g, rev=rev,
                                      need=(True, False, False, False))[0]
            for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])


def test_backward_csr_kernel_skips_zero_weights_on_bad_rows(cuda):
    """A non-finite g row behind an edge of weight 0 adds nothing, as in
    the atomic kernel."""
    feats, idx, w, g = _csr_case(6, 64, 16, 5, 40, torch.float32, cuda)
    rev = ops.build_reverse_index(idx, w, 64)
    w[0].zero_()
    g[0] = float("nan")
    got = ops.neighbor_agg_backward(feats, idx, w, g, rev=rev,
                                    need=(True, False, False, False))[0]
    assert bool(torch.isfinite(got).all())
    g[0] = 0
    want = neighbor_agg_backward_ref(feats, idx, w, g,
                                     need=(True, False, False, False))[0]
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_fullgraph_step_launches_reverse_index_kernel(cuda):
    """One full-graph GraphSAGE step (bf16 aggregation) through the
    Trainer: the tiled forward, the reverse-index backward once, the
    atomic backward never; a mini-batch step the backward kernel's
    identity mode once, and neither of the others."""
    from repro_torch.core import engine as E
    g = make_sbm_graph(n=3000, n_classes=6, avg_degree=12, feat_dim=48,
                       seed=4)
    cfg = GNNConfig(name="c", model="graphsage", n_nodes=g.n, feat_dim=48,
                    hidden=64, n_classes=g.n_classes, n_layers=2,
                    fanout=(5, 3), batch_size=256, dtype="bfloat16",
                    use_agg_kernel=True)
    plan = E.TrainPlan(n_iters=1, eval_every=1, seed=0)
    for src, want in ((E.FullGraphSource(max_deg=16),
                       {"backward_csr": 1, "backward": 0,
                        "backward_identity": 0}),
                      (E.SampledSource(prefetch=False),
                       {"backward_csr": 0, "backward": 0,
                        "backward_identity": 1})):
        tr = E.Trainer(g, cfg, plan, source=src, device=cuda)
        ops.reset_launches()
        res = tr.run()
        n = ops.launch_counts()
        assert np.isfinite(res.history.losses).all()
        assert n["tiled"] > 0
        assert {key: n[key] for key in want} == want, n
        tr.close()


# ---------------------------------------------------------------------------
# the cluster and importance sources, exact resume
# ---------------------------------------------------------------------------

def _sources_case(kernel=True):
    from repro_torch.core import engine as E
    g = make_sbm_graph(n=3000, n_classes=6, avg_degree=12, feat_dim=48,
                       seed=5)
    cfg = GNNConfig(name="c", model="graphsage", n_nodes=g.n, feat_dim=48,
                    hidden=64, n_classes=g.n_classes, n_layers=2,
                    fanout=(5, 3), batch_size=256, use_agg_kernel=kernel)
    return E, g, cfg


def test_cluster_steps_launch_the_reverse_index_kernel(cuda):
    """Each cluster step builds its batch's reverse index: dfeats by the
    reverse-index backward once a step, the atomic backward never, and
    every tiled forward on the route ``tiled_plan`` gives at its shape
    (the steps' batch ELL; the two evaluations' full-graph ELL)."""
    E, g, cfg = _sources_case()
    steps = 4
    src = E.ClusterSource(batch_size=512)
    tr = E.Trainer(g, cfg, E.TrainPlan(n_iters=steps, eval_every=100),
                   source=src, device=cuda)
    ops.reset_launches()
    res = tr.run()
    n = ops.launch_counts()
    assert np.isfinite(res.history.losses).all()
    assert n["backward_csr"] == steps and n["backward"] == 0, n
    widths = (cfg.feat_dim, cfg.n_classes)
    want = {"tiled_slab": 0, "tiled_direct": 0}
    for rows, k, forwards in ((src.m_max, src.K, steps),
                              (g.n, g.d_max, 2)):
        for d in widths:
            route = ops.tiled_plan(rows, rows, k, d, torch.float32).route
            want[f"tiled_{route}"] += forwards
    assert {key: n[key] for key in want} == want, n
    tr.close()


@pytest.mark.parametrize("name", ["cluster", "importance"])
def test_sources_agree_between_cpu_and_card(cuda, name):
    """Three steps of each source from one seed: the card (kernels) and
    the CPU (their plain versions) give the same batches and losses
    within 1e-4 relative."""
    E, g, cfg = _sources_case()
    make = {"cluster": lambda: E.ClusterSource(batch_size=512),
            "importance": lambda: E.ImportanceSampledSource(
                batch_size=256, scores="grad")}[name]
    plan = E.TrainPlan(n_iters=3, eval_every=2, seed=1)
    runs = {dev: E.Trainer(g, cfg, plan, source=make(), device=dev).run()
            for dev in ("cpu", cuda)}
    a, b = runs["cpu"].history, runs[cuda].history
    assert a.nodes_processed == b.nodes_processed
    np.testing.assert_allclose(b.losses, a.losses, rtol=1e-4, atol=1e-4)
    for p, q in zip(runs[cuda].params, runs["cpu"].params):
        for k in p:
            err = float((p[k].detach().cpu() - q[k].detach()).abs().max()
                        / q[k].detach().abs().max())
            assert err <= 1e-4, (name, k, err)


@pytest.mark.parametrize("name", ["fullgraph", "minibatch", "importance",
                                  "cluster"])
def test_resume_on_the_card_is_bit_equal(cuda, tmp_path, name):
    """A run stopped after its it=3 save and resumed ends bit-equal to
    the run that was not stopped, kernels on."""
    import dataclasses as dc
    E, g, cfg = _sources_case()
    make = {"fullgraph": lambda: E.FullGraphSource(max_deg=16),
            "minibatch": lambda: E.SampledSource(batch_size=256),
            "importance": lambda: E.ImportanceSampledSource(batch_size=256),
            "cluster": lambda: E.ClusterSource(batch_size=512)}[name]
    plan = E.TrainPlan(lr=0.3, n_iters=7, seed=0, eval_every=3,
                       ckpt_every=3, ckpt_dir=str(tmp_path / "golden"))
    golden = E.Trainer(g, cfg, plan, source=make(), device=cuda).run()
    d = str(tmp_path / "stopped")
    E.Trainer(g, cfg, dc.replace(plan, n_iters=4, ckpt_dir=d),
              source=make(), device=cuda).run()
    res = E.Trainer(g, cfg, dc.replace(plan, ckpt_dir=d), source=make(),
                    device=cuda).run(resume_from=d)
    assert res.history.losses == golden.history.losses
    assert res.history.val_accs == golden.history.val_accs
    assert res.final_test_acc == golden.final_test_acc
    for p, q in zip(res.params, golden.params):
        for k in p:
            assert torch.equal(p[k], q[k]), (name, k)


# ---------------------------------------------------------------------------
# the tiled forward's slab route
# ---------------------------------------------------------------------------

def _routed(case, route, slab_bytes=None):
    with ops._tiled_route(route, slab_bytes):
        return neighbor_agg(*case, use_kernel=True)


@pytest.mark.parametrize("slab_bytes", [32, 64, 128, 256])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,b,k", [(4096, 128, 1000, 32),
                                     (4096, 172, 777, 32),
                                     (1000, 37, 1001, 7),
                                     (300, 300, 13, 33),
                                     (100, 43, 77, 45),
                                     (50, 20, 5, 0)])
def test_slab_route_matches_plain_version(cuda, n, d, b, k, dtype, fused,
                                          slab_bytes):
    """Row by row against the plain version in f32 (``FWD_ROW_TOL``) at
    ragged B, K and D (odd D: rows not 8-byte aligned) and K = 0; bit-equal
    to the direct route; one launch of the slab route each call."""
    from repro_torch.kernels.flash_attn.ref import row_rel_err
    from repro_torch.kernels.neighbor_agg.ref import FWD_ROW_TOL
    t = [torch.tensor(a, device=cuda) for a in
         _inputs(n + d + k, n, d, b, k, fused)]
    t = _cast(t, dtype)
    counts = ops.launch_counts()
    slab = _routed(t, "slab", slab_bytes)
    assert ops.launch_counts() == dict(
        counts, tiled=counts["tiled"] + 1,
        tiled_slab=counts["tiled_slab"] + 1,
        tiled_fused=counts["tiled_fused"] + fused)
    ref32 = neighbor_agg_ref(*[x if x.dtype == torch.int32 else x.float()
                               for x in t])
    assert row_rel_err(slab, ref32) <= FWD_ROW_TOL[dtype]
    assert torch.equal(slab, _routed(t, "direct"))
    assert torch.equal(slab, _routed(t, "slab", slab_bytes))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slab_route_zero_weights_and_bad_id(cuda, dtype):
    """All-zero weights give exactly 0; an id outside [0, N) makes its
    row NaN in every slab and leaves the others as the direct route has
    them."""
    feats, idx, w = _cast([torch.tensor(a, device=cuda) for a in
                           _inputs(7, 64, 300, 16, 5, False)], dtype)
    for sb in ops.SLAB_WIDTHS:
        assert bool((_routed((feats, idx, torch.zeros_like(w)), "slab",
                             sb) == 0).all())
    idx[3, 2] = 64
    direct = _routed((feats, idx, w), "direct")
    keep = torch.arange(16, device=cuda) != 3
    for sb in ops.SLAB_WIDTHS:
        slab = _routed((feats, idx, w), "slab", sb)
        assert bool(torch.isnan(slab[3]).all())
        assert torch.equal(slab[keep], direct[keep])


def test_tiled_forward_launches_the_planned_route(cuda):
    """Without an override each call launches the route ``tiled_plan``
    gives: slab where the call gathers for every row of a table larger
    than the L2 budget, rows are whole lines and ids repeat; direct for a
    chunk of the rows, at identity ids and at small tables.  The override
    changes only the route; ``tiled`` counts both routes."""
    n_slab = ops.L2_TABLE_BYTES // 256 + 1
    for want, n, d, b in (("slab", n_slab, 128, n_slab),
                          ("direct", n_slab, 128, 8192),
                          ("direct", 4096, 128, 4096)):
        feats = torch.randn(n, d, device=cuda).to(torch.bfloat16)
        idx = torch.randint(0, n, (b, 32), device=cuda, dtype=torch.int32)
        w = torch.rand(b, 32, device=cuda).to(torch.bfloat16)
        assert ops.tiled_plan(n, b, 32, d, torch.bfloat16).route == want
        counts = ops.launch_counts()
        out = neighbor_agg(feats, idx, w, use_kernel=True)
        got = ops.launch_counts()
        assert got[f"tiled_{want}"] == counts[f"tiled_{want}"] + 1
        assert got["tiled"] == counts["tiled"] + 1
        other = "direct" if want == "slab" else "slab"
        assert torch.equal(out, _routed((feats, idx, w), other))
        assert ops.launch_counts()[f"tiled_{other}"] == \
            counts[f"tiled_{other}"] + 1
    ident = torch.arange(8192 * 15, dtype=torch.int32,
                         device=cuda).reshape(8192, 15)
    assert ops.tiled_plan(8192 * 15, 8192, 15, 256,
                          torch.float32).route == "direct"
    counts = ops.launch_counts()
    neighbor_agg(torch.randn(8192 * 15, 256, device=cuda), ident,
                 torch.ones(8192, 15, device=cuda), use_kernel=True)
    got = ops.launch_counts()
    assert got["tiled_direct"] == counts["tiled_direct"] + 1
    assert got["tiled"] == counts["tiled"] + 1
    ops.reset_launches()
    assert set(ops.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _qkv(seed, b, s, hq, hkv, d, dtype, device):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(size=(b, s, h, d)).astype(np.float32),
                         device=device).to(dtype)
            for h in (hq, hkv, hkv)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("d", [32, 64, 128, 256, 16, 112])
@pytest.mark.parametrize("s,window", [(256, 0), (256, 64), (1100, 1000),
                                      (200, 0), (77, 64), (1, 0)])
def test_flash_kernel_matches_plain_version(cuda, s, window, d, dtype, tol):
    """Ragged S (200, 77, 1, 1100), windows that are and are not a
    multiple of the 64-key tile, GQA 4/2, every head dim."""
    from repro_torch.kernels.flash_attn import ops as fa
    q, k, v = _qkv(s + d + window, 2, s, 4, 2, d, dtype, cuda)
    before, counts = fa.launches, fa.launch_counts()
    out = fa.flash_attention(q, k, v, window=window, use_kernel=True)
    assert fa.launches == before + 1
    route = fa.kernel_route(dtype, d)
    assert fa.launch_counts()[route] == counts[route] + 1
    want = fa.flash_attention(q, k, v, window=window, use_kernel=False)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), want.float(), atol=tol,
                               rtol=tol)
    if route == "wgmma":
        _assert_rows_within_bf16_rounding(out, q, k, v, window)


def _assert_rows_within_bf16_rounding(out, q, k, v, window):
    """The tensor-core kernel against the plain version in f32 on the
    same bf16 inputs, row by row: two bf16 roundings at most."""
    from repro_torch.kernels.flash_attn import ops as fa
    from repro_torch.kernels.flash_attn.ref import BF16_ROW_TOL, row_rel_err
    ref32 = fa.flash_attention(q.float(), k.float(), v.float(),
                               window=window, use_kernel=False)
    err = row_rel_err(out, ref32)
    assert err <= BF16_ROW_TOL, err


@pytest.mark.parametrize("b,s,hq,hkv,d,window", [
    # ragged S around the 64-key tile and the 128-row query tile
    (2, 1, 4, 2, 256, 0), (2, 63, 4, 2, 256, 0), (2, 65, 4, 2, 128, 0),
    (2, 127, 4, 2, 64, 0), (1, 129, 4, 2, 256, 0), (1, 129, 4, 2, 64, 100),
    # the ring wrapped many times (64 key tiles for the last query tile)
    (1, 4096, 2, 1, 256, 0), (1, 4096, 2, 1, 128, 1000),
    # MHA, and 16 query heads on one KV head
    (1, 300, 4, 4, 256, 0), (1, 300, 16, 1, 128, 64),
    # windows of 1, not a multiple of the tile, and longer than S
    (1, 700, 4, 2, 256, 1), (2, 333, 4, 2, 64, 1), (1, 700, 4, 2, 128, 100),
    (1, 1500, 4, 2, 256, 1000), (1, 200, 4, 2, 256, 5000),
])
def test_flash_wgmma_kernel_ring_and_masks(cuda, b, s, hq, hkv, d, window):
    """bf16 at head dims 64-256 runs on the tensor-core kernel and matches
    the plain version at 3e-2, and the plain version in f32 to 2^-7 of
    each row."""
    from repro_torch.kernels.flash_attn import ops as fa
    q, k, v = _qkv(s + hq + d + window, b, s, hq, hkv, d, torch.bfloat16,
                   cuda)
    counts = fa.launch_counts()
    out = fa.flash_attention(q, k, v, window=window, use_kernel=True)
    assert fa.launch_counts() == dict(counts, wgmma=counts["wgmma"] + 1)
    want = fa.flash_attention(q, k, v, window=window, use_kernel=False)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), want.float(), atol=3e-2,
                               rtol=3e-2)
    _assert_rows_within_bf16_rounding(out, q, k, v, window)


@pytest.mark.parametrize("window", [0, 1000])
def test_flash_wgmma_kernel_is_deterministic(cuda, window):
    from repro_torch.kernels.flash_attn import ops as fa
    q, k, v = _qkv(7, 2, 2048, 8, 4, 256, torch.bfloat16, cuda)
    a = fa.flash_attention(q, k, v, window=window, use_kernel=True)
    b = fa.flash_attention(q, k, v, window=window, use_kernel=True)
    assert torch.equal(a, b)


@pytest.mark.parametrize("b,s,hq,hkv,d,window", [
    # 16 query heads on one KV head, at the wide and a narrow tile
    (1, 700, 16, 1, 256, 0), (2, 333, 16, 1, 112, 100),
    (1, 1000, 16, 1, 64, 0),
    # ragged S around the 128-row and 32-key tiles of D = 256, MHA
    (2, 127, 4, 4, 256, 0), (1, 129, 8, 8, 256, 31), (1, 2050, 2, 1, 256, 1),
    # a window longer than S; one of a single key
    (1, 300, 4, 2, 128, 5000), (1, 500, 4, 2, 16, 1),
])
def test_flash_tf32x3_kernel_cases(cuda, b, s, hq, hkv, d, window):
    """f32 on the three-term TF32 kernel against the plain version at the
    f32 tolerance (2e-5): GQA 16, ragged S, windows of 1, 31, 100 and
    longer than S."""
    from repro_torch.kernels.flash_attn import ops as fa
    q, k, v = _qkv(s + hq + d + window, b, s, hq, hkv, d, torch.float32,
                   cuda)
    counts = fa.launch_counts()
    out = fa.flash_attention(q, k, v, window=window, use_kernel=True)
    assert fa.launch_counts() == dict(counts, tf32x3=counts["tf32x3"] + 1)
    want = fa.flash_attention(q, k, v, window=window, use_kernel=False)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("window", [0, 1000])
def test_flash_tf32x3_kernel_is_deterministic(cuda, window):
    from repro_torch.kernels.flash_attn import ops as fa
    q, k, v = _qkv(8, 2, 2048, 8, 4, 256, torch.float32, cuda)
    a = fa.flash_attention(q, k, v, window=window, use_kernel=True)
    b = fa.flash_attention(q, k, v, window=window, use_kernel=True)
    assert torch.equal(a, b)


def test_flash_kernels_agree_on_bf16(cuda):
    """The two kernels on the same bf16 inputs (the tf32x3 kernel launched
    directly, as chip_smoke.py times it), each against the plain
    version."""
    from repro_torch.kernels.flash_attn import ops as fa
    q, k, v = _qkv(9, 2, 700, 8, 4, 256, torch.bfloat16, cuda)
    want = fa.flash_attention(q, k, v, window=300, use_kernel=False)
    counts = fa.launch_counts()
    for kern in fa.ROUTES:
        out = fa._launch(q, k, v, 300, kern)
        torch.testing.assert_close(out.float(), want.float(), atol=3e-2,
                                   rtol=3e-2)
    assert fa.launch_counts() == {r: n + 1 for r, n in counts.items()}


def test_flash_kernel_rejects_bad_inputs(cuda):
    from repro_torch.kernels.flash_attn.ops import flash_attention
    q, k, v = _qkv(0, 1, 64, 4, 2, 32, torch.float32, cuda)
    with pytest.raises(ValueError, match="one device"):
        flash_attention(q, k.cpu(), v, use_kernel=True)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k,
                        v, use_kernel=True)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q.half(), k.half(), v.half(), use_kernel=True)
    with pytest.raises(ValueError, match="share a dtype"):
        flash_attention(q, k.bfloat16(), v, use_kernel=True)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(*_qkv(0, 1, 64, 4, 2, 48, torch.float32, cuda),
                        use_kernel=True)
    flat = torch.zeros(1 + q.numel(), device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(flat[1:].view(q.shape), k, v, use_kernel=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_launches_flash_once_per_layer(cuda, dtype):
    """A small-config prefill runs the kernel once per layer and matches
    the plain path (the reference model's chunked attention): 1e-4 in
    f32, relative max error 2e-2 in bf16."""
    import dataclasses as dc
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attn import ops as fa
    from repro_torch.models import model as M
    cfg = dc.replace(get_config("gemma3-12b", smoke=True), dtype=dtype)
    params = M.init_model(torch.Generator(device=cuda).manual_seed(0), cfg,
                          cuda, dtype=M._dt(cfg))
    toks = torch.randint(0, cfg.vocab_size, (2, 128), device=cuda)
    route = fa.kernel_route(M._dt(cfg), cfg.resolved_head_dim)
    with torch.inference_mode():
        before, counts = fa.launches, fa.launch_counts()
        got, _ = M.prefill(params, cfg, {"tokens": toks}, kernel=True)
        assert fa.launches - before == cfg.n_layers
        assert fa.launch_counts()[route] - counts[route] == cfg.n_layers
        want, _ = M.prefill(params, cfg, {"tokens": toks}, kernel=False)
        assert fa.launches - before == cfg.n_layers
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        err = float((got.float() - want.float()).abs().max()
                    / want.float().abs().max())
        assert err <= 2e-2, err


def test_prefill_launches_wgmma_kernel_once_per_layer(cuda):
    """The small config at head dim 64 in bf16: every layer's prefill
    attention runs on the tensor-core kernel and none on the f32 one;
    relative max error against the plain path 2e-2.  The tokens come
    from a seeded generator: drawn from the card's global generator they
    changed with whatever ran before, and the reading with them."""
    import dataclasses as dc
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attn import ops as fa
    from repro_torch.models import model as M
    cfg = dc.replace(get_config("gemma3-12b", smoke=True), dtype="bfloat16",
                     head_dim=64)
    params = M.init_model(torch.Generator(device=cuda).manual_seed(0), cfg,
                          cuda, dtype=M._dt(cfg))
    toks = torch.randint(0, cfg.vocab_size, (2, 192), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(0))
    with torch.inference_mode():
        counts = fa.launch_counts()
        got, _ = M.prefill(params, cfg, {"tokens": toks}, kernel=True)
        assert fa.launch_counts() == dict(
            counts, wgmma=counts["wgmma"] + cfg.n_layers)
        want, _ = M.prefill(params, cfg, {"tokens": toks}, kernel=False)
    err = float((got.float() - want.float()).abs().max()
                / want.float().abs().max())
    assert err <= 2e-2, err


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 3e-2),
                                       (torch.float32, 2e-5)])
@pytest.mark.parametrize("b,s,hq,hkv,window", [
    (2, 256, 4, 4, 0), (1, 333, 8, 2, 100), (2, 1, 4, 2, 0),
    (1, 1100, 4, 1, 1000), (2, 129, 32, 32, 64)])
def test_flash_kernels_at_head_dim_112(cuda, b, s, hq, hkv, window, dtype,
                                       tol):
    """zamba2-7b's head dim on both kernels (bf16 on the tensor-core
    kernel in its 128-column layout, f32 on the tf32x3 kernel) against the
    plain version; the tensor-core kernel also row by row against the
    plain version in f32.  Every head's 112 columns are compared, so a
    store past them into the next head would show."""
    from repro_torch.kernels.flash_attn import ops as fa
    q, k, v = _qkv(s + hq + window, b, s, hq, hkv, 112, dtype, cuda)
    route = fa.kernel_route(dtype, 112)
    counts = fa.launch_counts()
    out = fa.flash_attention(q, k, v, window=window, use_kernel=True)
    assert fa.launch_counts() == dict(counts, **{route: counts[route] + 1})
    want = fa.flash_attention(q, k, v, window=window, use_kernel=False)
    assert out.shape == q.shape and torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), want.float(), atol=tol,
                               rtol=tol)
    if route == "wgmma":
        _assert_rows_within_bf16_rounding(out, q, k, v, window)


@pytest.mark.parametrize("dtype,head_dim", [("float32", 0),
                                            ("bfloat16", 112)])
def test_zamba2_smoke_prefill_with_the_kernel_against_without(cuda, dtype,
                                                              head_dim):
    """zamba2-7b's smoke config (mamba, shared attention, mamba), in f32
    at its head dim 32 and in bf16 at the full config's 112: the prefill
    launches the routed kernel once (the shared block's one application)
    and matches the plain path, 1e-4 in f32, relative max error 2e-2 in
    bf16; a teacher-forced decode step matches the forward."""
    import dataclasses as dc
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attn import ops as fa
    from repro_torch.models import model as M
    cfg = dc.replace(get_config("zamba2-7b", smoke=True), dtype=dtype,
                     head_dim=head_dim)
    params = M.init_model(torch.Generator(device=cuda).manual_seed(0), cfg,
                          cuda, dtype=M._dt(cfg))
    toks = torch.randint(0, cfg.vocab_size, (2, 257), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(0))
    route = fa.kernel_route(M._dt(cfg), cfg.resolved_head_dim)
    with torch.inference_mode():
        counts = fa.launch_counts()
        got, cache = M.prefill(params, cfg, {"tokens": toks[:, :256]},
                               max_len=257, kernel=True)
        assert fa.launch_counts() == dict(counts, **{route: counts[route]
                                                     + 1})
        want, _ = M.prefill(params, cfg, {"tokens": toks[:, :256]},
                            kernel=False)
        step, _ = M.decode_step(params, cfg, cache, toks[:, 256:])
        x = M.embed_tokens(params, cfg, toks[:, :256])
        hid, _, _ = M.backbone(params, cfg, x,
                               torch.arange(256, device=cuda))
    v = cfg.vocab_size

    def rel(a, b_):
        a, b_ = a[..., :v].float(), b_[..., :v].float()
        return float((a - b_).abs().max() / b_.abs().max())
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert rel(got, want) <= tol
    assert rel(got, M.logits_fn(params, cfg, hid[:, -1])) <= tol
    assert torch.isfinite(step).all()


# ---------------------------------------------------------------------------
# the figures' shapes: full-graph ELLs of K = d_max in the hundreds
# ---------------------------------------------------------------------------

def _large_k_case(case, device):
    """``(feats [n, 64], idx, w, w_self)`` of a wide ELL: papers-like's
    real one at the figures' size (power-law degrees, K = d_max = 144),
    or random ids at K = 384 with 30 % zero weights."""
    from repro_torch.core.graph import to_ell
    from repro_torch.data.synth import make_preset
    rng = np.random.default_rng(11)
    if case == "papers-like":
        g = make_preset("papers-like", n=1500, seed=0, homophily=0.55,
                        feat_scale=0.3, train_frac=0.3)
        idx, w, w_self = to_ell(g)
        n = g.n
    else:
        n, k = 2000, 384
        idx = rng.integers(0, n, (n, k)).astype(np.int32)
        w = (rng.random((n, k)) * (rng.random((n, k)) > 0.3)
             ).astype(np.float32)
        w_self = rng.random(n).astype(np.float32)
    feats = rng.normal(size=(n, 64)).astype(np.float32)
    return tuple(torch.tensor(a, device=device)
                 for a in (feats, idx, w, w_self))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["papers-like", "random-k384"])
def test_fullgraph_kernels_at_large_ell_width(cuda, case, dtype):
    """The full-graph forward (plain and fused), the reverse index and
    both backward kernels at K >= 128, against their plain versions run
    in f32: the forward and the reverse-index backward row by row
    (``row_rel_err``: 1e-5 f32, 2^-8 bf16, the limits the card holds the
    full-graph shape to; a sum of hundreds of terms differs by more than
    1e-5 elementwise in f32 where it cancels), the atomic backward
    elementwise (1e-3 f32, 2e-2 bf16)."""
    from repro_torch.kernels.flash_attn.ref import row_rel_err
    from repro_torch.kernels.neighbor_agg.ref import (
        CSR_BF16_ROW_TOL, FWD_ROW_TOL, neighbor_agg_backward_csr_ref)
    feats, idx, w, w_self = _large_k_case(case, cuda)
    n, k = idx.shape
    assert k >= 128
    assert ops.tiled_plan(n, n, k, 64, dtype).route == "direct"
    feats, w, w_self = feats.to(dtype), w.to(dtype), w_self.to(dtype)
    for self_rows, ws in ((None, None), (feats, w_self)):
        got = neighbor_agg(feats, idx, w, self_rows, ws, use_kernel=True)
        want = neighbor_agg_ref(feats.float(), idx, w.float(),
                                None if ws is None else feats.float(),
                                None if ws is None else w_self.float())
        assert row_rel_err(got, want) <= FWD_ROW_TOL[dtype]

    rev = ops.build_reverse_index(idx, w, n)
    kept = (w != 0)
    assert rev.nnz == int(kept.sum())
    assert bool((rev.indptr[1:] >= rev.indptr[:-1]).all())
    rows = torch.repeat_interleave(
        torch.arange(n, device=cuda),
        (rev.indptr[1:] - rev.indptr[:-1]).long())
    assert torch.equal(idx.reshape(-1)[rev.edges.long()].long(), rows)

    g = torch.randn(n, 64, device=cuda).to(dtype)
    need = (True, False, False, False)
    csr = ops.neighbor_agg_backward(feats, idx, w, g, rev=rev, need=need)[0]
    ref32 = neighbor_agg_backward_csr_ref(rev, w.float(), g.float())
    assert row_rel_err(csr, ref32) <= (CSR_BF16_ROW_TOL
                                       if dtype == torch.bfloat16 else 1e-5)
    atomic = ops.neighbor_agg_backward(feats, idx, w, g, need=need)[0]
    btol = 2e-2 if dtype == torch.bfloat16 else 1e-3
    torch.testing.assert_close(atomic.float(), ref32, atol=btol, rtol=btol)


def test_fig6_kernel_switch_matches_plain_on_the_card(cuda, tmp_path,
                                                      monkeypatch):
    """fig6 at a tiny size with the kernel switch on and off, from the
    same initial parameters: the rows agree (losses 1e-3 relative, test
    accuracy within one node's share) and the switch launches the
    forward and, in the full-graph run, the reverse-index backward (the
    one-layer mini-batch runs aggregate raw features, which take no
    gradient)."""
    from repro_torch.bench import bench_fig6_throughput as F6
    from repro_torch.bench.common import Env
    monkeypatch.setitem(F6.QUICK, "n", 400)
    monkeypatch.setitem(F6.QUICK, "iters", 12)
    ops.reset_launches()
    on = F6.run(env=Env(device="cuda", kernel=True, out_dir=str(tmp_path)))
    n = ops.launch_counts()
    assert n["tiled"] > 0 and n["backward_csr"] > 0, n
    ops.reset_launches()
    off = F6.run(env=Env(device="cuda", out_dir=str(tmp_path)))
    assert ops.launch_counts()["tiled"] == 0
    from repro_torch.data.synth import make_preset
    share = 1.0 / len(make_preset("products-like", n=400).test_nodes) + 1e-6
    assert len(on) == len(off) == 9
    for a, b in zip(on, off):
        for key in ("first_loss", "final_loss"):
            assert a[key] == pytest.approx(b[key], rel=1e-3), (key, a, b)
        assert abs(a["test_acc"] - b["test_acc"]) <= share


# ---------------------------------------------------------------------------
# the NODES-sharded ops and sources, S shards on one card
# ---------------------------------------------------------------------------

def _card_mesh(cuda, s):
    from repro_torch import sharding as sh
    return sh.node_mesh(devices=(cuda,) * s)


def _sharded_case(cuda, fused, dtype=torch.bfloat16, n=4096, k=16, d=128,
                  seed=9):
    """A square ELL (B = N) with 30 % zero weights and its reverse
    indexes: ``(feats, idx, w, extra, rev)``."""
    rng = np.random.default_rng(seed)
    feats = torch.tensor(rng.normal(size=(n, d)), dtype=dtype, device=cuda)
    idx = torch.tensor(rng.integers(0, n, size=(n, k)), dtype=torch.int32,
                       device=cuda)
    w = torch.tensor(rng.random((n, k)) * (rng.random((n, k)) > 0.3),
                     dtype=dtype, device=cuda)
    extra = []
    if fused:
        extra = [torch.tensor(rng.normal(size=(n, d)), dtype=dtype,
                              device=cuda),
                 torch.tensor(rng.random(n), dtype=dtype, device=cuda)]
    return feats, idx, w, extra


def _fwd_bwd(fn, feats, w, extra):
    args = [t.clone().requires_grad_() for t in [feats, w] + extra]
    out = fn(*args)
    g = torch.ones_like(out)
    return out.detach(), torch.autograd.grad(out, args, g)


@pytest.mark.parametrize("model", ["graphsage", "gcn", "gat"])
def test_plain_fullgraph_grads_repeat_bit_for_bit_on_the_card(cuda, model):
    """The plain full-graph path (no kernel; GAT always) repeats its
    gradients bit for bit on the card, as exact resume needs: every row
    of a hub graph points at one of four rows, so a gather gradient that
    added with atomics would sum those rows in a new order each call."""
    rng = np.random.default_rng(0)
    n, k, feat = 4096, 16, 64
    idx = torch.tensor(rng.integers(0, 4, size=(n, k)), dtype=torch.int32,
                       device=cuda)
    w = torch.tensor(rng.random(size=(n, k)), dtype=torch.float32,
                     device=cuda)
    w_self = torch.tensor(rng.random(size=n), dtype=torch.float32,
                          device=cuda)
    feats = torch.tensor(rng.normal(size=(n, feat)), dtype=torch.float32,
                         device=cuda)
    cfg = GNNConfig(name="det", model=model, n_nodes=n, feat_dim=feat,
                    hidden=32, n_classes=8, n_layers=2, fanout=(4, 4),
                    batch_size=32, use_agg_kernel=False)
    params = G.init_gnn(torch.Generator().manual_seed(0), cfg, feat,
                        device=cuda)
    leaves = [v.requires_grad_() for p in params for v in p.values()]
    labels = torch.arange(n, device=cuda) % cfg.n_classes

    def grads():
        logits = G.full_graph_forward(params, cfg, feats, idx, w, w_self)
        loss = G.gnn_loss(logits, labels, "ce", cfg.n_classes)
        return torch.autograd.grad(loss, leaves)

    first = grads()
    for _ in range(4):
        for a, b in zip(first, grads()):
            assert torch.equal(a, b)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("shards", [1, 4])
def test_sharded_op_on_the_card(cuda, shards, fused):
    """One tiled launch per shard (and a reverse-index backward per
    shard); at S = 1 bit-equal to the unsharded kernel path with its
    reverse index, forward and gradients; at S = 4 the forward
    bit-equal (each row is the same sum) and the gradients within 2e-2
    (bf16: the table gradient is summed over shards)."""
    feats, idx, w, extra = _sharded_case(cuda, fused)
    rev1 = ops.build_reverse_index(idx, w, feats.shape[0])
    base, gb = _fwd_bwd(lambda f, ww, *r: neighbor_agg(
        f, idx, ww, *r, use_kernel=True, rev=rev1), feats, w, extra)
    mesh = _card_mesh(cuda, shards)
    rev = ops.build_sharded_reverse_index(idx, w, feats.shape[0], mesh)
    ops.reset_launches()
    out, gs = _fwd_bwd(lambda f, ww, *r: ops.neighbor_agg_sharded(
        f, idx, ww, *r, mesh=mesh, rev=rev), feats, w, extra)
    n = ops.launch_counts()
    assert n["tiled"] == shards and n["backward_csr"] == shards, n
    assert torch.equal(out, base)
    for a, b in zip(gs, gb):
        if shards == 1:
            assert torch.equal(a, b)
        rel = float((a.float() - b.float()).abs().max()
                    / b.float().abs().max())
        assert rel <= 2e-2, rel


@pytest.mark.parametrize("shards", [1, 4])
def test_batch_sharded_op_on_the_card(cuda, shards):
    rng = np.random.default_rng(2)
    b, k, d = 256, 10, 128
    nb = torch.tensor(rng.normal(size=(b, k, d)), dtype=torch.float32,
                      device=cuda)
    w = torch.tensor(rng.random((b, k)), dtype=torch.float32, device=cuda)
    ids = torch.arange(b * k, dtype=torch.int32, device=cuda).reshape(b, k)
    base = neighbor_agg(nb.reshape(-1, d), ids, w, use_kernel=True)
    ops.reset_launches()
    out = ops.neighbor_agg_batch_sharded(w, nb, mesh=_card_mesh(cuda, shards))
    assert ops.launch_counts()["tiled"] == shards
    assert torch.equal(out, base)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("shards", [1, 4])
def test_featshard_op_on_the_card(cuda, shards, fused):
    """S = 1: bit-equal to the unsharded kernel path with its reverse
    index (no miss, phase 1 only); S = 4: phase 2 launches on the card,
    the forward within 2e-2 of the plain version (bf16), the gradients
    within 2e-2 of the unsharded kernel path's."""
    from repro_torch.kernels.neighbor_agg import featshard as fs
    feats, idx, w, extra = _sharded_case(cuda, fused, seed=3)
    idx_h, w_h = idx.cpu().numpy(), w.float().cpu().numpy()
    degrees = np.bincount(idx_h.reshape(-1), minlength=feats.shape[0])
    plan = fs.build_featshard_plan(idx_h, w_h, degrees,
                                   _card_mesh(cuda, shards))
    rev1 = ops.build_reverse_index(idx, w, feats.shape[0])
    base, gb = _fwd_bwd(lambda f, ww, *r: neighbor_agg(
        f, idx, ww, *r, use_kernel=True, rev=rev1), feats, w, extra)
    fs.reset_launches()
    out, gs = _fwd_bwd(lambda f, ww, *r: fs.neighbor_agg_featshard(
        f, ww, plan, *r), feats, w, extra)
    n = fs.launch_counts()
    assert n["phase1"] == shards
    assert n["phase2"] == (shards if plan.M else 0) and \
        (shards == 1) == (plan.M == 0), (n, plan.M)
    if shards == 1:
        assert torch.equal(out, base)
        for a, b in zip(gs, gb):
            assert torch.equal(a, b)
        return
    want = neighbor_agg_ref(feats.float(), idx, w.float(),
                            *[t.float() for t in extra])
    assert torch.allclose(out.float(), want, atol=2e-2, rtol=2e-2)
    nz = w != 0
    for i, (a, b) in enumerate(zip(gs, gb)):
        if i == 1:
            a, b = a[nz], b[nz]
        rel = float((a.float() - b.float()).abs().max()
                    / b.float().abs().max())
        assert rel <= 2e-2, (i, rel)


@pytest.mark.parametrize("layout", ["replicated", "sharded"])
def test_sharded_sources_on_the_card(cuda, layout):
    """Three steps: at S = 1 the sharded sources' losses bit-equal to the
    unsharded sources'; at S = 4 the full-graph source launches each
    kernel four times as often (replicated table), and both give finite
    losses that repeat bit for bit from the seed."""
    E, g, cfg = _sources_case()
    cfg = dataclasses.replace(cfg, dtype="bfloat16", feats_layout=layout)
    plan = E.TrainPlan(lr=0.3, n_iters=3, eval_every=2, seed=0)

    def run(src):
        ops.reset_launches()
        res = E.Trainer(g, cfg, plan, source=src, device=cuda).run()
        return res.history.losses, ops.launch_counts()
    fg, n_fg = run(E.FullGraphSource(max_deg=16))
    mb, _ = run(E.SampledSource(batch_size=256))
    m1, m4 = _card_mesh(cuda, 1), _card_mesh(cuda, 4)
    assert run(E.ShardedFullGraphSource(max_deg=16, mesh=m1))[0] == fg
    assert run(E.ShardedSampledSource(batch_size=256, mesh=m1))[0] == mb
    l4, n4 = run(E.ShardedFullGraphSource(max_deg=16, mesh=m4))
    assert np.isfinite(l4).all()
    assert run(E.ShardedFullGraphSource(max_deg=16, mesh=m4))[0] == l4
    if layout == "replicated":
        assert n4["tiled"] == 4 * n_fg["tiled"], (n4, n_fg)
        assert n4["backward_csr"] == 4 * n_fg["backward_csr"], (n4, n_fg)
    lm4, _ = run(E.ShardedSampledSource(batch_size=256, mesh=m4))
    assert np.isfinite(lm4).all()


# ---------------------------------------------------------------------------
# the static audits' card half (repro_torch.analysis)
# ---------------------------------------------------------------------------

def test_resource_table_covers_every_built_symbol(cuda):
    """Every kernel symbol of both built libraries joins a formula row
    (a symbol without one is a gating finding), every kernel of the
    budget table is built, and nothing but the allowlisted one-block-per-
    SM headroom of the flash kernels gates."""
    from repro_torch.analysis import findings as AF
    from repro_torch.analysis import kernel_audit as KA
    fs, rows = KA.audit_built()
    usage = {}
    for path in KA.built_libraries().values():
        usage.update(KA.resource_usage(path))
    assert len(rows) == len(usage) > 0
    assert {r["kernel"] for r in rows} == {
        r["kernel"] for r in KA.default_budget_table()}
    assert {f.site.split("[")[0] for f in AF.gating(fs)} <= {
        "kernel:headroom:flash_attn_kernel",
        "kernel:headroom:flash_attn_wgmma_kernel"}
    flash = [r for r in rows if r["kernel"] in KA.SMEM_QUERIES]
    assert flash and all(r["shared_dynamic_built"] == r["shared_dynamic"]
                         for r in flash), flash


def test_trace_measures_the_syncs_of_a_step(cuda):
    """The sync debug mode counts a step's syncs on the card, also those
    inside an op (``bincount`` reads its maximum back), and none where a
    step has none; the op list names the same ops."""
    from repro_torch.analysis import trace_audit as TR
    x = torch.arange(64, device=cuda) % 5

    def syncing(t):
        return torch.bincount(t), torch.nonzero(t), t.sum().item()

    _, tr, _, _ = TR.traced(syncing, x, device=cuda)
    assert tr.syncs == {"aten.bincount": 1, "aten.nonzero": 1,
                        "aten._local_scalar_dense": 1}, tr.syncs
    assert set(tr.measured_syncs) == set(tr.syncs), tr.measured_syncs
    assert TR.walk_hazards(tr, "syncing", cuda) == []
    upload = torch.arange(64.0)
    _, tr, _, _ = TR.traced(lambda t: t.to(cuda) * 2, upload, device=cuda)
    assert tr.syncs == {"aten._to_copy": 1} == tr.measured_syncs
    _, tr, _, _ = TR.traced(lambda t: t * 2 + 1, x, device=cuda)
    assert tr.syncs == {} == tr.measured_syncs
    assert torch.cuda.get_sync_debug_mode() == 0


def test_constant_fixture_is_flagged_on_the_card(cuda):
    """A step that uploads a 16 KiB host table on every call."""
    from repro_torch.analysis import fixtures as AFX
    fs = AFX.run_fixture("constant", cuda)
    assert fs and all(f.severity == "error" for f in fs), fs
    assert "host tensor" in fs[0].detail


def test_pipeline_fixture_is_flagged_on_the_card(cuda):
    """The three planted pipeline faults run on the card, each flagged by
    name; the short copy as a timeout of the bounded wait, not a hang."""
    from repro_torch.analysis import fixtures as AFX
    fs = AFX.run_fixture("pipeline", cuda)
    assert fs and all(f.severity == "error" for f in fs)
    for name in AFX.PIPELINE_FAULTS:
        assert any(f":fixture:{name}:" in f.site for f in fs), name
    assert any(f.site.endswith(":timeout") for f in fs
               if ":ring_short_copy:" in f.site)


def test_pipeline_check_is_clean_on_the_card(cuda):
    """The checked build of both flash kernels at the ring's warm-up,
    wrap and ragged tail: no finding, outputs bit-equal to the normal
    build's."""
    from repro_torch.analysis import kernel_audit as KA
    cases = [c for c in KA.pipeline_cases() if c.s in (64, 320)
             and c.d in (64, 256)]
    fs, summary = KA.audit_pipelines(cases, device=cuda)
    assert fs == [], [str(f) for f in fs]
    assert all(r["bit_equal"] == r["cases"]
               for r in summary["kernels"].values())
