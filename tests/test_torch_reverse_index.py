"""The reverse index of the full-graph ELL and the backward that uses it,
on the CPU (the reverse-index CUDA kernel takes its plain version here;
tests/test_torch_cuda.py and chip_smoke.py hold the kernel on the card).

``ops.build_reverse_index`` against a numpy construction;
``ref.neighbor_agg_backward_csr_ref`` against the atomic backward's plain
version and the reference's ``_agg_bwd`` / ``_agg_self_bwd`` (1e-5 in
f32, 2e-2 in bf16: one rounding of each cotangent, the tolerance of
tests/test_torch_neighbor_agg.py); ``neighbor_agg(..., rev=...)`` under
autograd against the same call without the index; the index's contract
(refusals); its memo on the graph; and full-graph training with it
against the reference.  Inputs come from numpy with a seed."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.core import engine as E
from repro_torch.core import gnn as G
from repro_torch.core.graph import to_ell
from repro_torch.data.synth import make_sbm_graph
from repro_torch.kernels.neighbor_agg import ops
from repro_torch.kernels.neighbor_agg.ops import (ReverseIndex,
                                                  build_reverse_index,
                                                  neighbor_agg,
                                                  neighbor_agg_backward)
from repro_torch.kernels.neighbor_agg.ref import (
    neighbor_agg_backward_csr_ref, neighbor_agg_backward_ref)

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def graph():
    return make_sbm_graph(n=240, n_classes=4, avg_degree=9, feat_dim=12,
                          seed=4)


def _ell(seed, n, b, k, zero=0.3, bad=0):
    """Random ids and weights, a share ``zero`` of them 0 and ``bad`` ids
    outside [0, n) with nonzero weights."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, max(n, 1), (b, k)).astype(np.int32)
    w = (rng.random((b, k)) * (rng.random((b, k)) > zero)).astype(np.float32)
    flat = idx.reshape(-1)
    for i, p in enumerate(rng.choice(b * k, size=bad, replace=False)):
        flat[p] = -1 if i % 2 else n + i
        w.reshape(-1)[p] = 0.5
    return idx, w


def _numpy_index(idx, w, n):
    kept = (w != 0) & (idx >= 0) & (idx < n)
    pos = np.flatnonzero(kept)
    src = idx.reshape(-1)[pos]
    edges = pos[np.argsort(src, kind="stable")]
    indptr = np.concatenate([[0], np.cumsum(np.bincount(src, minlength=n))])
    return indptr, edges, kept


@pytest.mark.parametrize("n,b,k,bad", [(30, 24, 9, 0), (50, 40, 7, 5),
                                       (64, 8, 33, 2), (10, 6, 0, 0),
                                       (200, 12, 3, 0)])
def test_build_matches_numpy_construction(n, b, k, bad):
    """indptr, the edges' order (ascending positions within a row) and
    the exclusion of zero-weight and out-of-range edges; rows no edge
    names (n = 200 of 36 edges) are empty."""
    idx, w = _ell(n + b + k, n, b, k, bad=bad)
    rev = build_reverse_index(torch.tensor(idx), torch.tensor(w), n)
    indptr, edges, kept = _numpy_index(idx, w, n)
    assert rev.indptr.dtype == rev.edges.dtype == torch.int32
    np.testing.assert_array_equal(rev.indptr.numpy(), indptr)
    np.testing.assert_array_equal(rev.edges.numpy(), edges)
    np.testing.assert_array_equal(rev.kept.numpy(), kept)
    assert (rev.n, rev.b, rev.k, rev.nnz) == (n, b, k, int(kept.sum()))
    assert rev.nbytes == 4 * (n + 1) + 4 * rev.nnz + b * k
    for row in range(n):                        # each edge names its row
        e = edges[indptr[row]:indptr[row + 1]]
        assert (idx.reshape(-1)[e] == row).all()
        assert (np.diff(e) > 0).all()


def test_build_leaves_out_the_ell_padding(graph):
    """The ELL points every padding edge at row 0 with weight 0: none of
    them lands in the index."""
    idx, w, _ = to_ell(graph, max_deg=8)
    rev = build_reverse_index(torch.tensor(idx), torch.tensor(w), graph.n)
    assert rev.nnz == int((w != 0).sum()) < w.size
    row0 = rev.edges[:int(rev.indptr[1])].numpy()
    assert (w.reshape(-1)[row0] != 0).all()


def _case(seed, n, b, k, d, dtype, fused=False):
    idx, w = _ell(seed, n, b, k)
    rng = np.random.default_rng(seed + 1)
    arrays = [rng.normal(size=(n, d)).astype(np.float32), idx, w]
    if fused:
        arrays += [rng.normal(size=(b, d)).astype(np.float32),
                   rng.random(b).astype(np.float32)]
    g = rng.normal(size=(b, d)).astype(np.float32)
    t = [torch.tensor(a) if a.dtype == np.int32 else
         torch.tensor(a).to(dtype) for a in arrays]
    return arrays, g, t, torch.tensor(g).to(dtype)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,b,k,d", [(30, 24, 9, 40), (7, 50, 5, 33),
                                     (40, 12, 0, 16)])
def test_csr_plain_version_matches_plain_backward(n, b, k, d, dtype):
    """The CSR walk equals the atomic backward's plain version (an
    ``index_add_`` in b, k order) on the same inputs."""
    tdt = DTYPES[dtype]
    _, _, (feats, idx, w), g = _case(n * b + k, n, b, k, d, tdt)
    rev = build_reverse_index(idx, w, n)
    got = neighbor_agg_backward_csr_ref(rev, w, g)
    want = neighbor_agg_backward_ref(feats, idx, w, g,
                                     need=(True, False, False, False))[0]
    assert got.dtype == tdt and got.shape == (n, d)
    _close(got.float(), want.float(), TOL[tdt])


def _graph_weights(graph, kind):
    """An ELL of ``graph`` with the weights a model path aggregates with:
    GCN's ``ell_w`` and its self weights, or GraphSAGE's mask."""
    idx, w, w_self = to_ell(graph, max_deg=8)
    if kind == "sage_mask":
        w = (w > 0).astype(np.float32)
    return idx, w, w_self


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["gcn_fused", "sage_mask"])
def test_csr_plain_version_matches_reference_bwd(graph, kind, dtype):
    """Against the reference's ``_agg_bwd`` (GraphSAGE's mask weights)
    and ``_agg_self_bwd`` (GCN's weights with the fused self term; its
    dfeats half) on a graph's ELL."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.neighbor_agg import ops as jax_ops
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = DTYPES[dtype]
    idx, w, w_self = _graph_weights(graph, kind)
    rng = np.random.default_rng(11)
    d = 24
    table = rng.normal(size=(graph.n, d)).astype(np.float32)
    g = rng.normal(size=(graph.n, d)).astype(np.float32)
    j = [jnp.asarray(a, jdt) for a in (table, w, table, w_self, g)]
    if kind == "gcn_fused":
        want = jax_ops._agg_self_bwd(
            None, (j[0], jnp.asarray(idx), j[1], j[2], j[3]), j[4])[0]
    else:
        want = jax_ops._agg_bwd(None, (j[0], jnp.asarray(idx), j[1]),
                                j[4])[0]
    tw = torch.tensor(w).to(tdt)
    rev = build_reverse_index(torch.tensor(idx), tw, graph.n)
    got = neighbor_agg_backward_csr_ref(rev, tw, torch.tensor(g).to(tdt))
    _close(got.float(), np.asarray(want, np.float32), TOL[tdt])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [False, True])
def test_autograd_with_index_matches_without(fused, dtype):
    """``neighbor_agg(..., use_kernel=True, rev=...)``: dfeats from the
    CSR walk equals the atomic path's; dw, dself and dw_self come from
    the same backward either way and are equal."""
    tdt = DTYPES[dtype]
    _, _, t, g = _case(3, 30, 24, 9, 16, tdt, fused=fused)
    rev = build_reverse_index(t[1], t[2], 30)
    grads = []
    for r in (rev, None):
        diff = [x.clone().requires_grad_() for i, x in enumerate(t)
                if i != 1]
        out = neighbor_agg(diff[0], t[1], *diff[1:2], *diff[2:],
                           use_kernel=True, rev=r)
        grads.append(torch.autograd.grad(out, diff, g))
    with_rev, without = grads
    _close(with_rev[0].float(), without[0].float(), TOL[tdt])
    for a, b in zip(with_rev[1:], without[1:]):
        assert torch.equal(a, b)


def test_direct_backward_with_index_routes_only_dfeats(monkeypatch):
    """``neighbor_agg_backward(..., rev=...)``: dfeats from the CSR walk,
    and the atomic backward is asked for the rest without dfeats."""
    seen = []
    real = ops._backward

    def spy(feats, idx, w, g, self_rows, w_self, need):
        seen.append(tuple(need))
        return real(feats, idx, w, g, self_rows, w_self, need)

    monkeypatch.setattr(ops, "_backward", spy)
    _, _, t, g = _case(5, 20, 16, 6, 8, torch.float32, fused=True)
    rev = build_reverse_index(t[1], t[2], 20)
    all4 = (True, True, True, True)
    got = neighbor_agg_backward(*t[:3], g, *t[3:], need=all4, rev=rev)
    want = neighbor_agg_backward_ref(*t[:3], g, *t[3:])
    only_df = neighbor_agg_backward(*t[:3], g, need=(True, False, False,
                                                     False), rev=rev)
    assert seen == [(False, True, True, True)]
    assert only_df[1:] == (None, None, None)
    torch.testing.assert_close(only_df[0], got[0], rtol=0, atol=0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad", ["other_idx", "idx_in_place", "shape",
                                 "not_an_index", "plain_path"])
def test_index_that_does_not_fit_the_call_is_refused(bad):
    _, _, (feats, idx, w), g = _case(6, 20, 16, 6, 8, torch.float32)
    rev = build_reverse_index(idx, w, 20)
    kw = dict(use_kernel=True, rev=rev)
    if bad == "other_idx":
        idx = idx.clone()
    elif bad == "idx_in_place":
        idx[0, 0] = 1
    elif bad == "shape":
        feats = feats[:19].contiguous()
    elif bad == "not_an_index":
        kw["rev"] = (rev.indptr, rev.edges)
    else:
        kw["use_kernel"] = False
    with pytest.raises(ValueError):
        neighbor_agg(feats, idx, w, **kw)
    if bad != "plain_path":
        with pytest.raises(ValueError):
            neighbor_agg_backward(feats, idx, w, g, rev=kw["rev"])


def test_weight_outside_the_index_fails_the_device_assert():
    """A nonzero weight on an edge the index left out (a zero weight at
    build time, or an out-of-range id) is an error, never a dropped term:
    the on-device assert raises at once on the CPU."""
    _, _, (feats, idx, w), g = _case(7, 20, 16, 6, 8, torch.float32)
    rev = build_reverse_index(idx, w, 20)
    zero = (w == 0).nonzero()[0]
    w2 = w.clone()
    w2[zero[0], zero[1]] = 0.25
    with pytest.raises(RuntimeError, match="left out"):
        neighbor_agg(feats, idx, w2, use_kernel=True, rev=rev)
    idx[2, 3] = 20                              # out of range, weight kept
    w3 = w.clone()
    w3[2, 3] = 0.5
    rev = build_reverse_index(idx, w3, 20)
    assert not bool(rev.kept[2, 3])
    with pytest.raises(RuntimeError, match="left out"):
        neighbor_agg_backward(feats, idx, w3, g, rev=rev)


def test_launch_counts_name_the_new_kernel():
    """``backward_csr`` is counted beside the others; on CPU tensors no
    kernel launches."""
    ops.reset_launches()
    assert ops.launch_counts() == {"tiled": 0, "backward": 0,
                                   "backward_csr": 0, "row": 0}
    _, _, (feats, idx, w), g = _case(8, 20, 16, 6, 8, torch.float32)
    rev = build_reverse_index(idx, w, 20)
    f = feats.clone().requires_grad_()
    torch.autograd.grad(neighbor_agg(f, idx, w, use_kernel=True, rev=rev),
                        f, g)
    assert set(ops.launch_counts().values()) == {0}


def _cfg(graph, model, kernel=True, dtype="float32"):
    return GNNConfig(name="t", model=model, n_nodes=graph.n,
                     feat_dim=graph.feats.shape[1], hidden=16,
                     n_classes=graph.n_classes, n_layers=2, fanout=(4, 3),
                     batch_size=32, dtype=dtype, use_agg_kernel=kernel)


def test_fullgraph_source_memoizes_the_index(graph, monkeypatch):
    """Built once per graph and ELL width, from that ELL's idx and w;
    another width evicts it with its ELL; ``drop_device_cache`` drops
    it; a config without the kernel holds none."""
    built = []
    real = ops.build_reverse_index

    def counting(idx, w, n):
        built.append((idx, w))
        return real(idx, w, n)

    monkeypatch.setattr(ops, "build_reverse_index", counting)
    E.drop_device_cache(graph)
    cfg = _cfg(graph, "graphsage")
    plan = E.TrainPlan(n_iters=1)
    a = E.FullGraphSource(max_deg=8).bind(graph, cfg, plan, "cpu")
    b = E.FullGraphSource(max_deg=8).bind(graph, cfg, plan, "cpu")
    assert len(built) == 1 and a.rev is b.rev
    assert isinstance(a.rev, ReverseIndex)
    assert built[0][0] is a.ell[0] and built[0][1] is a.ell[1]
    c = E.FullGraphSource(max_deg=6).bind(graph, cfg, plan, "cpu")
    assert len(built) == 2 and c.rev.k == 6
    assert not any(key[0] == "rev" and key[2] == 8
                   for key in graph._torch_cache)
    E.drop_device_cache(graph)
    E.FullGraphSource(max_deg=6).bind(graph, cfg, plan, "cpu")
    assert len(built) == 3
    plain = E.FullGraphSource(max_deg=6).bind(
        graph, _cfg(graph, "graphsage", kernel=False), plan, "cpu")
    assert plain.rev is None and len(built) == 3
    c.close()
    assert c.rev is None and c.ell is None
    E.drop_device_cache(graph)


@pytest.mark.parametrize("model,dtype", [("graphsage", "bfloat16"),
                                         ("gcn", "float32"),
                                         ("gcn", "bfloat16")])
def test_full_graph_gradients_with_index_match_without(graph, model, dtype):
    """One full-graph loss's parameter gradients through the index (the
    GraphSAGE mask and GCN's fused call) equal those without it: f32 at
    1e-5, bf16 aggregation at 2e-2, relative max error."""
    cfg = _cfg(graph, model, dtype=dtype)
    params = G.init_gnn(torch.Generator().manual_seed(0), cfg,
                        graph.feats.shape[1], device="cpu")
    leaves = [v.requires_grad_() for p in params for v in p.values()]
    src = E.FullGraphSource(max_deg=8).bind(graph, cfg, E.TrainPlan(),
                                            "cpu")
    assert src.rev is not None
    grads = []
    for rev in (src.rev, None):
        src.rev = rev
        grads.append(torch.autograd.grad(src.loss(params, None), leaves))
    tol = TOL[DTYPES[dtype]]
    for a, b in zip(*grads):
        assert float((a - b).abs().max() / b.abs().max()) <= tol
    src.close()
    E.drop_device_cache(graph)


@pytest.mark.parametrize("model", ["gcn", "graphsage"])
def test_fullgraph_trainer_with_index_matches_reference(model):
    """``train_full_graph`` on the kernel path, whose source now carries
    the reverse index, against the reference's plain path: losses at
    1e-4 over 8 iterations (the tolerance of tests/test_torch_train.py;
    it checks GraphSAGE on its own graph, this adds GCN's fused call)."""
    pytest.importorskip("jax")
    import jax
    from repro.configs.base import GNNConfig as RefConfig
    from repro.core import gnn as RG
    from repro.core import trainer as RT
    from repro.data import make_sbm_graph as ref_make
    from repro_torch.core import trainer as TT
    kw = dict(n=300, n_classes=4, avg_degree=10, feat_dim=16, seed=1)
    rg, tg = ref_make(**kw), make_sbm_graph(**kw)
    ckw = dict(name="t", model=model, n_nodes=rg.n, feat_dim=16, hidden=32,
               n_classes=rg.n_classes, n_layers=2, fanout=(5, 3),
               batch_size=64, loss="ce")
    want = RT.train_full_graph(rg, RefConfig(**ckw), lr=0.3, n_iters=8,
                               eval_every=4, seed=0)
    init = [{k: np.asarray(v) for k, v in p.items()} for p in
            RG.init_gnn(jax.random.key(0), RefConfig(**ckw), 16)]
    cfg = GNNConfig(**dict(ckw, use_agg_kernel=True))
    got = TT.train_full_graph(tg, cfg, lr=0.3, n_iters=8, eval_every=4,
                              seed=0, params=init, device="cpu")
    np.testing.assert_allclose(got.history.losses, want.history.losses,
                               rtol=1e-4, atol=1e-4)
    src = E.FullGraphSource().bind(tg, cfg, E.TrainPlan(), "cpu")
    assert src.rev is not None and src.rev.idx is src.ell[0]
    E.drop_device_cache(tg)


def test_fullgraph_source_index_fits_dataclass_replace(graph):
    """A config switched to the plain path after ``bind`` ignores the
    index (the gradient checks of chip_smoke.py do this)."""
    cfg = _cfg(graph, "graphsage")
    src = E.FullGraphSource(max_deg=8).bind(graph, cfg, E.TrainPlan(),
                                            "cpu")
    params = G.init_gnn(torch.Generator().manual_seed(1), cfg,
                        graph.feats.shape[1], device="cpu")
    with_kernel = src.loss(params, None)
    src.cfg = dataclasses.replace(cfg, use_agg_kernel=False)
    plain = src.loss(params, None)
    torch.testing.assert_close(with_kernel, plain, rtol=1e-5, atol=1e-5)
    E.drop_device_cache(graph)
