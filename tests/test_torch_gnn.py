"""The port's full-graph forward against the live reference: logits and
every layer (``return_layers``) for gcn/graphsage/gat × f32/bf16 ×
``use_agg_kernel`` on/off, from the reference's ``init_gnn`` parameters
carried across with ``params_from_numpy``.

The reference side runs its plain (einsum) path; its Pallas kernel path
(interpret mode, seconds per compile) runs for one case per model that
has it, and equals its plain path within the reference's own tests.
Tolerances: 1e-5 in f32; 2e-2 in bf16, where the aggregation rounds to
bf16 and the two frameworks sum in different orders."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import GNNConfig as RefConfig  # noqa: E402
from repro.core import gnn as RG  # noqa: E402
from repro.core.graph import to_ell  # noqa: E402
from repro.data.synth import make_sbm_graph  # noqa: E402

from repro_torch.configs.base import GNNConfig  # noqa: E402
from repro_torch.core import gnn as TG  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
_REF = {}


@pytest.fixture(scope="module")
def graph():
    return make_sbm_graph(n=150, n_classes=5, avg_degree=8, feat_dim=24,
                          seed=4)


def _cfg_kw(g, **kw):
    d = dict(name="t", model="gcn", n_nodes=g.n, feat_dim=24, hidden=16,
             n_classes=g.n_classes, n_layers=2, fanout=(4, 3),
             batch_size=32, gat_heads=2, agg_b_tile=4, agg_d_tile=8,
             agg_k_slab=2)
    d.update(kw)
    return d


def _ref_layers(params, cfg_kw, g, ell):
    cfg = RefConfig(**cfg_kw)
    idx, w, ws = ell
    logits, layers = RG.full_graph_forward(
        params, cfg, jnp.asarray(g.feats), jnp.asarray(idx), jnp.asarray(w),
        jnp.asarray(ws), return_layers=True)
    return np.asarray(logits), [np.asarray(x) for x in layers]


def _port_layers(params_np, cfg_kw, g, ell):
    cfg = GNNConfig(**cfg_kw)
    params = TG.params_from_numpy(params_np, device="cpu")
    t = [torch.as_tensor(a) for a in (g.feats, *ell)]
    logits, layers = TG.full_graph_forward(params, cfg, *t,
                                           return_layers=True)
    return logits.numpy(), [x.numpy() for x in layers]


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", ["gcn", "graphsage", "gat"])
def test_full_graph_forward_matches_reference(graph, model, dtype, kernel):
    kw = _cfg_kw(graph, model=model, dtype=dtype, use_agg_kernel=kernel)
    params = RG.init_gnn(jax.random.key(0), RefConfig(**kw),
                         graph.feats.shape[1])
    params_np = [{k: np.asarray(v) for k, v in p.items()} for p in params]
    ell = to_ell(graph, max_deg=6)
    # the reference's kernel path in interpret mode for one dtype only;
    # its plain path is shared by the kernel on/off cases
    ref_kernel = kernel and dtype == "float32" and model != "gat"
    key = (model, dtype, ref_kernel)
    if key not in _REF:
        _REF[key] = _ref_layers(params, dict(kw, use_agg_kernel=ref_kernel),
                                graph, ell)
    want_logits, want = _REF[key]
    got_logits, got = _port_layers(params_np, kw, graph, ell)
    tol = TOL[dtype]
    assert len(got) == len(want) == 2
    for li, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol,
                                   err_msg=f"layer {li}")
    np.testing.assert_allclose(got_logits, want_logits, rtol=tol, atol=tol)


def test_width_shrinking_three_layers(graph):
    """hidden < feat_dim on every layer: the pre-aggregation transform."""
    for model in ("gcn", "graphsage"):
        kw = _cfg_kw(graph, model=model, n_layers=3, fanout=(4, 3, 3),
                     hidden=8)
        params = RG.init_gnn(jax.random.key(1), RefConfig(**kw), 24)
        ell = to_ell(graph)
        _, want = _ref_layers(params, kw, graph, ell)
        _, got = _port_layers(
            [{k: np.asarray(v) for k, v in p.items()} for p in params],
            dict(kw, use_agg_kernel=True), graph, ell)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_params_layout_and_accuracy(graph):
    kw = _cfg_kw(graph, model="gat")
    cfg_r, cfg_t = RefConfig(**kw), GNNConfig(**kw)
    assert TG.layer_dims(cfg_t, 24) == RG.layer_dims(cfg_r, 24)
    ref = RG.init_gnn(jax.random.key(2), cfg_r, 24)
    ours = TG.init_gnn(torch.Generator().manual_seed(2), cfg_t, 24,
                       device="cpu")
    loaded = TG.params_from_numpy(
        [{k: np.asarray(v) for k, v in p.items()} for p in ref],
        device="cpu")
    for pr, po, pl in zip(ref, ours, loaded):
        assert sorted(pr) == sorted(po) == sorted(pl)
        for k in pr:
            assert tuple(po[k].shape) == pr[k].shape
            np.testing.assert_array_equal(pl[k].numpy(), np.asarray(pr[k]))
    # same seed, same weights: the generator is the only source
    again = TG.init_gnn(torch.Generator().manual_seed(2), cfg_t, 24,
                        device="cpu")
    assert all(torch.equal(a[k], b[k]) for a, b in zip(ours, again)
               for k in a)
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(40, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 40).astype(np.int32)
    assert float(TG.accuracy(torch.as_tensor(logits),
                             torch.as_tensor(labels))) == pytest.approx(
        float(RG.accuracy(jnp.asarray(logits), jnp.asarray(labels))))


def test_cuda_requested_without_card_raises(graph):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = GNNConfig(**_cfg_kw(graph))
    with pytest.raises(RuntimeError, match="cuda"):
        TG.init_gnn(torch.Generator().manual_seed(0), cfg, 24)
    with pytest.raises(RuntimeError, match="cuda"):
        TG.params_from_numpy([{"w": np.zeros((2, 2))}])


def test_bf16_config_casts_like_reference(graph):
    """Under dtype="bfloat16" the tables stay f32 and only the
    aggregation traffic is bf16 (the agg_dt cast points)."""
    kw = _cfg_kw(graph, model="graphsage", dtype="bfloat16",
                 use_agg_kernel=True)
    cfg = GNNConfig(**kw)
    assert TG.agg_dtype(cfg, torch.float32) == torch.bfloat16
    assert TG.agg_dtype(dataclasses.replace(cfg, dtype="float32"),
                        torch.float32) == torch.float32
    params = TG.init_gnn(torch.Generator().manual_seed(0), cfg, 24,
                         device="cpu")
    t = [torch.as_tensor(a) for a in (graph.feats, *to_ell(graph))]
    assert TG.full_graph_forward(params, cfg, *t).dtype == torch.float32
