"""Card-only tests of the port (skipped without CUDA; no JAX needed, so
they run on the card's machine):

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

The CUDA neighbor-aggregation kernels (tiled forward, backward, row)
against their plain versions at the model paths' widths, a small serving
build whose kernel path must launch the kernel and match the plain
forward, and one training step whose gradients through the kernels must
match the plain path.  Forward tolerances: 1e-5 (f32), 2e-2 (bf16).
Backward: 1e-3 (f32; dfeats sums with atomics in an order that changes
from run to run), 2e-2 (bf16)."""
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
            before = ops.backward_launches
            grads[kernel] = torch.autograd.grad(src.loss(params, batch),
                                                leaves)
            assert (ops.backward_launches > before) == kernel
        for a, b in zip(grads[True], grads[False]):
            err = float((a - b).abs().max() / b.abs().max())
            assert err <= tol, (type(src).__name__, err)
        src.done(batch)
        src.close()
