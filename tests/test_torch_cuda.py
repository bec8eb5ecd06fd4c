"""Card-only tests of the port (skipped without CUDA; no JAX needed, so
they run on the card's machine):

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

The CUDA neighbor-aggregation kernels (tiled forward, backward, row)
against their plain versions at the model paths' widths, a small serving
build whose kernel path must launch the kernel and match the plain
forward, and one training step whose gradients through the kernels must
match the plain path.  Forward tolerances: 1e-5 (f32), 2e-2 (bf16).
Backward: 1e-3 (f32; dfeats sums with atomics in an order that changes
from run to run), 2e-2 (bf16).  The reverse-index backward kernel (the
full-graph path's dfeats) row by row against its plain version in f32
(``row_rel_err``): 1e-5 in f32, 2^-8 (one bf16 rounding) in bf16, rows
with no edge exactly 0, repeat calls bit-equal, and a full-graph training
step that launches it once and the atomic kernel never.

The CUDA flash-attention kernels against their plain version (2e-5 f32,
3e-2 bf16, the tolerances of tests/test_flash_attn.py; the tensor-core
kernel also row by row against the plain version in f32, at most 2^-7 of
each row, ``ref.row_rel_err``): every input goes
to the kernel ``kernel_route`` names (the tensor-core kernel for bf16 at
head dims 64-256, the f32 kernel for the rest), with cases that wrap the
tensor-core kernel's ring and cross its masks, two calls bit-equal, the
argument checks, and a small-config prefill that launches the routed
kernel once per layer."""
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
            elif isinstance(src, E.FullGraphSource):
                # dfeats by the reverse index; GCN's dself by the atomic
                # kernel, which then sends no atomics
                assert n["backward_csr"] == 1
                assert n["backward"] == (1 if model == "gcn" else 0)
            else:
                assert n["backward"] > 0 and n["backward_csr"] == 0
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
    atomic backward never; a mini-batch step the reverse."""
    from repro_torch.core import engine as E
    g = make_sbm_graph(n=3000, n_classes=6, avg_degree=12, feat_dim=48,
                       seed=4)
    cfg = GNNConfig(name="c", model="graphsage", n_nodes=g.n, feat_dim=48,
                    hidden=64, n_classes=g.n_classes, n_layers=2,
                    fanout=(5, 3), batch_size=256, dtype="bfloat16",
                    use_agg_kernel=True)
    plan = E.TrainPlan(n_iters=1, eval_every=1, seed=0)
    for src, want in ((E.FullGraphSource(max_deg=16),
                       {"backward_csr": 1, "backward": 0}),
                      (E.SampledSource(prefetch=False),
                       {"backward_csr": 0, "backward": 1})):
        tr = E.Trainer(g, cfg, plan, source=src, device=cuda)
        ops.reset_launches()
        res = tr.run()
        n = ops.launch_counts()
        assert np.isfinite(res.history.losses).all()
        assert n["tiled"] > 0
        assert {key: n[key] for key in want} == want, n
        tr.close()


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
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("s,window", [(256, 0), (256, 64), (1100, 1000),
                                      (200, 0), (77, 64), (1, 0)])
def test_flash_kernel_matches_plain_version(cuda, s, window, d, dtype, tol):
    """Ragged S (200, 77, 1, 1100), windows that are and are not a
    multiple of the 64-key tile, GQA 4/2."""
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


def test_flash_kernels_agree_on_bf16(cuda):
    """The two kernels on the same bf16 inputs (the f32 kernel launched
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
    relative max error against the plain path 2e-2."""
    import dataclasses as dc
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attn import ops as fa
    from repro_torch.models import model as M
    cfg = dc.replace(get_config("gemma3-12b", smoke=True), dtype="bfloat16",
                     head_dim=64)
    params = M.init_model(torch.Generator(device=cuda).manual_seed(0), cfg,
                          cuda, dtype=M._dt(cfg))
    toks = torch.randint(0, cfg.vocab_size, (2, 192), device=cuda)
    with torch.inference_mode():
        counts = fa.launch_counts()
        got, _ = M.prefill(params, cfg, {"tokens": toks}, kernel=True)
        assert fa.launch_counts() == dict(
            counts, wgmma=counts["wgmma"] + cfg.n_layers)
        want, _ = M.prefill(params, cfg, {"tokens": toks}, kernel=False)
    err = float((got.float() - want.float()).abs().max()
                / want.float().abs().max())
    assert err <= 2e-2, err
