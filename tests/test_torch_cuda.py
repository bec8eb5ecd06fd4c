"""Card-only tests of the port (skipped without CUDA; no JAX needed, so
they run on the card's machine):

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

The CUDA neighbor-aggregation kernel against its plain version at the
serving path's widths, and a small serving build whose kernel path must
launch the kernel and match the plain forward.  Tolerances: 1e-5 (f32),
2e-2 (bf16)."""
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
from repro_torch.kernels.neighbor_agg.ref import neighbor_agg_ref


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
