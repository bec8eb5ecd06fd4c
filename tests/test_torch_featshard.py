"""The port's NODES-sharded feature table with its hot cache
(``kernels/neighbor_agg/featshard.py``, ``core/featcache.py``): the
cases of tests/test_featshard.py on the port, on meshes of CPU shards.

- The host plan: ``_plan_arrays`` array-equal to the reference's at
  S in {1, 2, 4} for Zipf degrees, C = 0 and C = n, and its hit-rate,
  miss and byte accounting.
- The LRU and degree caches: the reference's cases, and counters equal
  to the reference's over one id stream.
- The op: at S = 1 bit-equal to the port's unsharded kernel path,
  forward and gradients, fused and not, for C auto / 0 / n; against the
  live reference (its featshard op on a one-device mesh, and at S = 4
  its unsharded op) within 1e-5 forward and 1e-3 gradients (f32; dw
  where w != 0, as the reference's own 4-device test compares it).
- The engine, inference and the store on the featshard layout."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import sharding as rsh  # noqa: E402
from repro.configs.base import GNNConfig as RefConfig  # noqa: E402
from repro.core import engine as RE  # noqa: E402
from repro.core import featcache as rfc  # noqa: E402
from repro.core import gnn as RG  # noqa: E402
from repro.kernels.neighbor_agg import featshard as rfs  # noqa: E402
from repro.kernels.neighbor_agg import ops as rops  # noqa: E402

from repro_torch import sharding as sh  # noqa: E402
from repro_torch.configs.base import GNNConfig  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core import gnn as G  # noqa: E402
from repro_torch.core.embedding_store import EmbeddingStore  # noqa: E402
from repro_torch.core.featcache import (DegreeHotRowCache,  # noqa: E402
                                        LRURowCache)
from repro_torch.core.graph import to_ell  # noqa: E402
from repro_torch.core.inference import layerwise_embeddings  # noqa: E402
from repro_torch.data.synth import make_sbm_graph  # noqa: E402
from repro_torch.kernels.neighbor_agg import ops  # noqa: E402
from repro_torch.kernels.neighbor_agg.featshard import (  # noqa: E402
    _plan_arrays, build_featshard_plan, neighbor_agg_featshard,
    resolve_cache_rows)

KW = dict(interpret=True, d_tile=8, b_tile=4, k_slab=2)
FWD_TOL, GRAD_TOL, LOSS_TOL = 1e-5, 1e-3, 1e-5


def _mesh(s):
    return sh.node_mesh(devices=("cpu",) * s)


def _zipf_ell(n=256, k=8, seed=0, a=1.3):
    rng = np.random.default_rng(seed)
    ranks = np.minimum(rng.zipf(a, size=(n, k)) - 1, n - 1)
    idx = ranks.astype(np.int32)
    w = rng.normal(size=(n, k)).astype(np.float32)
    w[rng.random(size=w.shape) < 0.1] = 0.0
    degrees = np.bincount(idx.reshape(-1), minlength=n)
    return idx, w, degrees


# ---------------------------------------------------------------------------
# host plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache_rows", [-1, 0, 256])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_plan_arrays_equal_reference(shards, cache_rows):
    idx, w, degrees = _zipf_ell()
    got = _plan_arrays(idx, w, degrees, shards, cache_rows)
    want = rfs._plan_arrays(idx, w, degrees, shards, cache_rows)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


def test_plan_hot_cache_hit_rate_on_zipf_degrees():
    idx, w, degrees = _zipf_ell()
    st = _plan_arrays(idx, w, degrees, 4, -1)["stats"]
    assert st["feat_cache_rows"] == 32
    assert st["feat_cache_hit_rate"] >= 0.75, st
    st0 = _plan_arrays(idx, w, degrees, 4, 0)["stats"]
    assert st["feat_cache_hit_rate"] >= st0["feat_cache_hit_rate"] + 0.3
    assert (st["feat_cache_hot_hits"] + st["feat_cache_local_hits"]
            + st["feat_cache_misses"]) == int((w != 0).sum())


def test_plan_cache_size_zero_all_nonlocal_miss():
    idx, w, degrees = _zipf_ell(n=64, k=4, seed=1)
    host = _plan_arrays(idx, w, degrees, 4, 0)
    owner = np.arange(64) // 16
    assert host["C"] == 0 and host["M"] > 0
    assert host["stats"]["feat_cache_misses"] == int(
        ((w != 0) & (owner[idx] != owner[:, None])).sum())


def test_plan_cache_covers_all_no_miss():
    idx, w, degrees = _zipf_ell(n=64, k=4, seed=2)
    host = _plan_arrays(idx, w, degrees, 4, 64)
    assert host["M"] == 0 and host["stats"]["feat_cache_hit_rate"] == 1.0


def test_plan_rejects_indivisible_rows():
    idx, w, degrees = _zipf_ell(n=66, k=4, seed=3)
    with pytest.raises(ValueError, match="divide"):
        _plan_arrays(idx, w, degrees, 4, 0)


@pytest.mark.parametrize("c,n", [(-1, 256), (None, 256), (-1, 4), (0, 256),
                                 (1000, 256), (7, 256)])
def test_resolve_cache_rows(c, n):
    assert resolve_cache_rows(c, n) == rfs.resolve_cache_rows(c, n)


def test_table_bytes_and_remote_bytes_host_arithmetic():
    idx, w, degrees = _zipf_ell()
    plan = build_featshard_plan(idx, w, degrees, _mesh(4))
    d, item = 32, 2
    assert plan.table_bytes_per_device(d, item) == \
        (256 // 4 + 32) * d * item < 256 * d * item
    assert plan.remote_bytes_per_call(d, item) == \
        3 * (plan.M + plan.C_max) * d * item


# ---------------------------------------------------------------------------
# host caches
# ---------------------------------------------------------------------------

def test_lru_cache_hits_misses_and_eviction():
    c = LRURowCache(capacity=2, row_bytes=8)
    assert c.lookup([1, 2]) == 2
    assert c.lookup([1, 2]) == 0
    c.lookup([3])
    assert c.lookup([1]) == 1
    st = c.stats()
    assert st["feat_cache_hits"] == 2 and st["feat_cache_misses"] == 4
    assert st["feat_remote_gather_bytes"] == 4 * 8


def test_lru_cache_capacity_zero_all_miss():
    c = LRURowCache(capacity=0, row_bytes=4)
    assert c.lookup([5, 5, 5]) == 3
    assert c.stats()["feat_cache_hit_rate"] == 0.0


def test_lru_duplicate_ids_hit_after_first_touch():
    assert LRURowCache(capacity=4).lookup([7, 7, 7]) == 1


def test_degree_hot_cache_membership():
    c = DegreeHotRowCache(degrees=[5, 1, 9, 3], capacity=2)
    c.lookup([2, 0, 1, 3])
    st = c.stats()
    assert st["feat_cache_hits"] == 2 and st["feat_cache_misses"] == 2


@pytest.mark.parametrize("capacity", [0, 8, 64])
def test_cache_counters_equal_reference(capacity):
    rng = np.random.default_rng(capacity)
    stream = [rng.zipf(1.5, size=40) % 100 for _ in range(6)]
    degrees = np.bincount(np.concatenate(stream), minlength=100)
    for mine, ref in ((LRURowCache(capacity, 16),
                       rfc.LRURowCache(capacity, 16)),
                      (DegreeHotRowCache(degrees, capacity, 16),
                       rfc.DegreeHotRowCache(degrees, capacity, 16))):
        assert [mine.lookup(s) for s in stream] == \
            [ref.lookup(s) for s in stream]
        assert mine.stats() == ref.stats()


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------

def _operands(fused, n=40, d=12, k=5, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, d)).astype(np.float32)
    idx = rng.integers(0, n, size=(n, k)).astype(np.int32)
    w = rng.normal(size=(n, k)).astype(np.float32)
    w[rng.random(size=w.shape) < 0.15] = 0.0
    degrees = np.bincount(idx.reshape(-1), minlength=n)
    extra = []
    if fused:
        extra = [rng.normal(size=(n, d)).astype(np.float32),
                 rng.normal(size=(n,)).astype(np.float32)]
    return feats, idx, w, degrees, extra


def _port(fn, feats, w, extra):
    args = [torch.tensor(a).requires_grad_() for a in [feats, w] + extra]
    out = fn(*args)
    return out.detach(), torch.autograd.grad((out ** 2).sum(), args)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("cache_rows", [-1, 0, 40])
def test_featshard_op_bit_equal_on_one_device_mesh(fused, cache_rows):
    feats, idx, w, degrees, extra = _operands(fused)
    plan = build_featshard_plan(idx, w, degrees, _mesh(1),
                                cache_rows=cache_rows)
    assert plan.M == 0
    tidx = torch.tensor(idx)
    base, gb = _port(lambda f, ww, *r: ops.neighbor_agg(
        f, tidx, ww, *r, use_kernel=True), feats, w, extra)
    got, gs = _port(lambda f, ww, *r: neighbor_agg_featshard(
        f, ww, plan, *r), feats, w, extra)
    assert torch.equal(base, got)
    for a, b in zip(gb, gs):
        assert torch.equal(a, b)
    # the reference's featshard op on its one-device mesh
    rplan = rops.build_featshard_plan(idx, w, degrees, rsh.node_mesh(1),
                                      cache_rows=cache_rows)
    jargs = [jnp.asarray(a) for a in [feats, w] + extra]
    rout = rops.neighbor_agg_featshard(jargs[0], jargs[1], rplan,
                                       *jargs[2:], **KW)
    _close(got, rout, FWD_TOL)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("cache_rows", [-1, 0])
def test_featshard_op_on_four_shards_matches_reference(fused, cache_rows):
    feats, idx, w, degrees, extra = _operands(fused, seed=4)
    plan = build_featshard_plan(idx, w, degrees, _mesh(4),
                                cache_rows=cache_rows)
    assert plan.M > 0                      # the miss path runs
    got, gs = _port(lambda f, ww, *r: neighbor_agg_featshard(
        f, ww, plan, *r), feats, w, extra)
    jargs = [jnp.asarray(a) for a in [feats, w] + extra]
    jidx = jnp.asarray(idx)

    def ref(f, ww, *r):
        return rops.neighbor_agg(f, jidx, ww, *r)
    argnums = tuple(range(len(jargs)))
    rg = jax.grad(lambda *a: (ref(*a) ** 2).sum(), argnums=argnums)(*jargs)
    _close(got, ref(*jargs), FWD_TOL)
    nz = w != 0
    for i, (a, b) in enumerate(zip(gs, rg)):
        a, b = a.numpy(), np.asarray(b)
        if i == 1:        # dw: zero-weight remote refs never join the serve
            a, b = a[nz], b[nz]
        _close(a, b, GRAD_TOL)


def test_featshard_partial_reaches_phase_two_unrounded():
    """bf16: the phase-1 partial goes to phase 2 in f32, so a row whose
    hits and misses cancel keeps what one unsharded launch keeps.  Row 0
    reads local row 1 (a hit: (1 + 2^-7)^2 = 1 + 2^-6 + 2^-14, exact in
    f32) and remote row 2 (a miss: -(1 + 2^-6)); the sum is 2^-14, where
    a partial rounded to bf16 (1 + 2^-6) would leave 0."""
    bf = torch.bfloat16
    a, b = 1 + 2.0 ** -7, 1 + 2.0 ** -6
    feats = torch.tensor([[0, 0], [a, 1], [-b, 0], [0, 0]]).to(bf)
    idx = np.array([[1, 2], [0, 0], [3, 3], [2, 2]], np.int32)
    w = torch.tensor([[a, 1], [1, 1], [1, 1], [1, 1]]).to(bf)
    plan = build_featshard_plan(idx, w.float().numpy(),
                                np.ones(4, np.int64), _mesh(2),
                                cache_rows=0)
    assert plan.M > 0
    got = neighbor_agg_featshard(feats, w, plan)
    assert float(got[0, 0]) == 2.0 ** -14
    assert torch.equal(got, ops.neighbor_agg(feats, torch.tensor(idx), w,
                                             use_kernel=True))


def test_featshard_rejects_mismatched_operands():
    feats, idx, w, degrees, _ = _operands(False)
    plan = build_featshard_plan(idx, w, degrees, _mesh(2), cache_rows=0)
    f, ww = torch.tensor(feats), torch.tensor(w)
    with pytest.raises(ValueError, match="rebuild the plan"):
        neighbor_agg_featshard(f[:20], ww, plan)
    with pytest.raises(ValueError, match="rebuild the plan"):
        neighbor_agg_featshard(f, ww[:, :3], plan)
    with pytest.raises(ValueError, match="together"):
        neighbor_agg_featshard(f, ww, plan, self_rows=f)


# ---------------------------------------------------------------------------
# engine, inference, store
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def graphs():
    from repro.data import make_sbm_graph as ref_make
    kw = dict(n=120, n_classes=4, avg_degree=8, feat_dim=16, seed=7)
    return ref_make(**kw), make_sbm_graph(**kw)


def _kw(g, **kw):
    base = dict(name="fs", model="gcn", n_nodes=g.n,
                feat_dim=g.feats.shape[1], hidden=16,
                n_classes=g.n_classes, n_layers=2, fanout=(4, 3),
                batch_size=32, loss="ce", use_agg_kernel=True)
    base.update(kw)
    return base


def _init(kw, seed=0):
    params = RG.init_gnn(jax.random.key(seed), RefConfig(**kw),
                         kw["feat_dim"])
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


@pytest.mark.parametrize("model", ["gcn", "graphsage"])
def test_featshard_fullgraph_bit_equal_one_device(graphs, model):
    _, g = graphs
    cfg = GNNConfig(**_kw(g, model=model))
    fscfg = dataclasses.replace(cfg, feats_layout="sharded")
    plan = TE.TrainPlan(lr=0.3, n_iters=4, eval_every=2, seed=0)
    r1 = TE.Trainer(g, cfg, plan, source=TE.ShardedFullGraphSource(
        mesh=_mesh(1)), device="cpu").run()
    r2 = TE.Trainer(g, fscfg, plan, source=TE.ShardedFullGraphSource(
        mesh=_mesh(1)), device="cpu").run()
    assert r1.history.losses == r2.history.losses
    assert r1.history.val_accs == r2.history.val_accs
    assert r1.final_test_acc == r2.final_test_acc
    c = r2.history.counters
    assert c["feat_cache_hit_rate"] == 1.0
    assert c["feat_table_bytes_per_device"] == (120 + 15) * 16 * 4
    assert r1.history.counters == {}


@pytest.mark.parametrize("model", ["gcn", "graphsage"])
def test_featshard_on_four_shards_trains_as_reference(graphs, model):
    rg, tg = graphs
    kw = _kw(rg, model=model)
    plan_r = RE.TrainPlan(lr=0.3, n_iters=4, eval_every=2, seed=0)
    plan_t = TE.TrainPlan(lr=0.3, n_iters=4, eval_every=2, seed=0)
    want = RE.Trainer(rg, RefConfig(**dict(kw, use_agg_kernel=False)),
                      plan_r, source=RE.FullGraphSource()).run()
    src = TE.ShardedFullGraphSource(mesh=_mesh(4))
    got = TE.Trainer(tg, GNNConfig(**dict(kw, feats_layout="sharded")),
                     plan_t, source=src, params=_init(kw),
                     device="cpu").run()
    _close(got.history.losses, want.history.losses, LOSS_TOL)
    assert src.feats_plan.M > 0 and src.feats_plan.S == 4
    assert got.history.counters["feat_table_shards"] == 4


def test_featshard_sampled_source_lru_counters(graphs):
    _, g = graphs
    cfg = GNNConfig(**_kw(g, feats_layout="sharded", feat_cache_rows=16))
    plan = TE.TrainPlan(lr=0.3, n_iters=3, eval_every=100, seed=0)
    res = TE.Trainer(g, cfg, plan, source=TE.ShardedSampledSource(
        batch_size=32, mesh=_mesh(4)), device="cpu").run()
    c = res.history.counters
    assert c["feat_cache_rows"] == 16
    assert c["feat_cache_hits"] + c["feat_cache_misses"] > 0
    assert 0.0 <= c["feat_cache_hit_rate"] <= 1.0
    assert c["feat_remote_gather_bytes"] == (c["feat_cache_misses"]
                                             * g.feats.shape[1] * 4)


@pytest.mark.parametrize("model", ["gcn", "graphsage"])
def test_featshard_inference_layers_match_forward(graphs, model):
    rg, g = graphs
    kw = _kw(g, model=model)
    cfg = GNNConfig(**dict(kw, feats_layout="sharded"))
    params = G.params_from_numpy(_init(kw), "cpu")
    idx, w, w_self = (torch.tensor(a) for a in to_ell(g))
    feats = torch.tensor(g.feats)
    _, want = G.full_graph_forward(params, GNNConfig(**kw), feats, idx, w,
                                   w_self, return_layers=True)
    run = layerwise_embeddings(params, cfg, g, mesh=_mesh(1), device="cpu")
    assert run.stats["n_chunks"] == 1 and run.stats["chunk_steps"] == 2
    for a, b in zip(run.layers, want):
        assert torch.equal(a, b)
    run4 = layerwise_embeddings(params, cfg, g, mesh=_mesh(4), device="cpu")
    assert run4.stats["feat_table_bytes_per_device"] == \
        (30 + 15) * 16 * 4
    from repro.core.inference import layerwise_embeddings as ref_layers
    rrun = ref_layers(_init(kw), RefConfig(**dict(kw, use_agg_kernel=False)),
                      rg)
    for a, b in zip(run4.layers, rrun.layers):
        _close(a, b, FWD_TOL)


def test_featshard_store_builds_as_replicated_and_replans(graphs):
    _, g0 = graphs
    g = dataclasses.replace(g0, feats=g0.feats.copy())
    kw = _kw(g, model="graphsage")
    params = G.params_from_numpy(_init(kw), "cpu")
    cfg = GNNConfig(**kw)
    fs = EmbeddingStore(params, dataclasses.replace(
        cfg, feats_layout="sharded"), g, chunk_size=32, device="cpu",
        mesh=_mesh(4))
    assert fs.feats_plan is not None and fs.feats_plan.S == 4
    rep = EmbeddingStore(params, cfg, g, chunk_size=32, device="cpu")
    run = fs.build()
    rep.build()
    assert run.stats["feat_table_shards"] == 4
    for a, b in zip(fs.layers, rep.layers):
        _close(a, b, FWD_TOL)
    fs.add_edges([0, 5], [77, 100])
    rep.add_edges([0, 5], [77, 100])
    assert fs.feats_plan is None
    fs.build()
    rep.build()
    assert fs.feats_plan is not None
    for a, b in zip(fs.layers, rep.layers):
        _close(a, b, FWD_TOL)
    fs.update_features([3], np.ones((1, 16), np.float32))
    rep.update_features([3], np.ones((1, 16), np.float32))
    fs.refresh()
    rep.refresh()
    for a, b in zip(fs.layers, rep.layers):
        _close(a, b, FWD_TOL)
