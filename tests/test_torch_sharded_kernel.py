"""The port's NODES-partitioned aggregation (``ops.neighbor_agg_sharded``,
``ops.neighbor_agg_batch_sharded``) and the sharded sources' kernel path,
the cases of tests/test_sharded_kernel.py on the port, on meshes of CPU
shards (``node_mesh(devices=("cpu",) * S)``; the kernels take their plain
versions on these CPU tensors).

- S = 1: bit-equal to the port's unsharded kernel path, forward and
  gradients, fused and not; the loss sequences of both sharded sources
  bit-equal to the unsharded sources'.
- Against the live reference: its sharded op on a one-device mesh (its
  Pallas kernel in interpret mode) and at S = 4 its unsharded op, 1e-5
  forward and 1e-3 gradients (f32; the frameworks sum in other orders,
  so the port is not bit-equal to the reference); both sharded sources'
  losses at S = 4 within 1e-5 of the reference's sources.
- Row padding to a shard multiple, the refusals, and the per-shard
  reverse index."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import sharding as rsh  # noqa: E402
from repro.configs.base import GNNConfig as RefConfig  # noqa: E402
from repro.core import engine as RE  # noqa: E402
from repro.core import gnn as RG  # noqa: E402
from repro.kernels.neighbor_agg import ops as rops  # noqa: E402

from repro_torch import sharding as sh  # noqa: E402
from repro_torch.configs.base import GNNConfig  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.data.synth import make_sbm_graph  # noqa: E402
from repro_torch.kernels.neighbor_agg import ops  # noqa: E402

KW = dict(interpret=True, d_tile=8, b_tile=4, k_slab=2)
FWD_TOL, GRAD_TOL, LOSS_TOL = 1e-5, 1e-3, 1e-5


def _mesh(s):
    return sh.node_mesh(devices=("cpu",) * s)


def _operands(fused, b=26, n=37, d=19, k=5, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(n, d)).astype(np.float32),
            rng.integers(0, n, size=(b, k)).astype(np.int32),
            rng.normal(size=(b, k)).astype(np.float32)]
    if fused:
        arrs += [rng.normal(size=(b, d)).astype(np.float32),
                 rng.normal(size=(b,)).astype(np.float32)]
    return arrs


def _t(arrs):
    out = [torch.tensor(a) for a in arrs]
    for i, x in enumerate(out):
        if i != 1:
            x.requires_grad_()
    return out


def _grads(fn, args):
    """out, and the gradients of sum(out²) for every float operand."""
    out = fn(*args)
    diff = [a for i, a in enumerate(args) if i != 1]
    return out.detach(), torch.autograd.grad((out ** 2).sum(), diff)


def _ref_grads(fn, arrs):
    jargs = [jnp.asarray(a) for a in arrs]
    diff = tuple(i for i in range(len(arrs)) if i != 1)
    out = fn(*jargs)
    g = jax.grad(lambda *a: (fn(*a) ** 2).sum(), argnums=diff)(*jargs)
    return np.asarray(out), [np.asarray(x) for x in g]


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# op level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
def test_sharded_op_bit_equal_on_one_device_mesh(fused):
    arrs = _operands(fused)
    base, gb = _grads(lambda *a: ops.neighbor_agg(*a, use_kernel=True),
                      _t(arrs))
    shrd, gs = _grads(lambda *a: ops.neighbor_agg_sharded(
        *a, mesh=_mesh(1)), _t(arrs))
    assert torch.equal(base, shrd)
    for a, b in zip(gb, gs):
        assert torch.equal(a, b)
    # the reference's sharded op on its one-device mesh (Pallas interpret)
    rout, rg = _ref_grads(lambda *a: rops.neighbor_agg_sharded(
        *a, mesh=rsh.node_mesh(1), **KW), arrs)
    _close(shrd, rout, FWD_TOL)
    for a, b in zip(gs, rg):
        _close(a, b, GRAD_TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_sharded_op_on_four_shards_matches_reference(fused):
    """B = 26 does not divide the 4 shards: rows pad internally."""
    arrs = _operands(fused, seed=1)
    out, gs = _grads(lambda *a: ops.neighbor_agg_sharded(
        *a, mesh=_mesh(4)), _t(arrs))
    assert out.shape[0] == 26
    rout, rg = _ref_grads(lambda *a: rops.neighbor_agg(*a), arrs)
    _close(out, rout, FWD_TOL)
    for a, b in zip(gs, rg):
        _close(a, b, GRAD_TOL)


def _batch_operands(fused, b=8, k=5, d=19, seed=3):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(b, k)).astype(np.float32),
            rng.normal(size=(b, k, d)).astype(np.float32)]
    if fused:
        arrs += [rng.normal(size=(b, d)).astype(np.float32),
                 rng.normal(size=(b,)).astype(np.float32)]
    return arrs


def _unsharded_batch(w, nb, *rest):
    b, k, d = nb.shape
    ids = torch.arange(b * k, dtype=torch.int32).reshape(b, k)
    return ops.neighbor_agg(nb.reshape(-1, d), ids, w, *rest,
                            use_kernel=True)


@pytest.mark.parametrize("fused", [False, True])
def test_batch_sharded_op_bit_equal_on_one_device_mesh(fused):
    arrs = _batch_operands(fused)

    def grads(fn):
        args = [torch.tensor(a).requires_grad_() for a in arrs]
        out = fn(*args)
        return out.detach(), torch.autograd.grad((out ** 2).sum(), args)
    base, gb = grads(_unsharded_batch)
    for s in (1, 4):
        shrd, gs = grads(lambda *a: ops.neighbor_agg_batch_sharded(
            *a, mesh=_mesh(s)))
        if s == 1:
            assert torch.equal(base, shrd)
        _close(shrd, base, FWD_TOL)
        for a, b in zip(gb, gs):
            if s == 1:
                assert torch.equal(a, b)
            _close(a, b, GRAD_TOL)
    # the reference's batch-sharded op on its one-device mesh
    jargs = [jnp.asarray(a) for a in arrs]
    rout = rops.neighbor_agg_batch_sharded(*jargs, mesh=rsh.node_mesh(1),
                                           **KW)
    _close(base, rout, FWD_TOL)


def test_batch_sharded_op_rejects_indivisible_rows():
    w, nb = [torch.tensor(a) for a in _batch_operands(False, b=6)]
    with pytest.raises(ValueError, match="multiple of the 4"):
        ops.neighbor_agg_batch_sharded(w, nb, mesh=_mesh(4))


def test_sharded_op_pads_rows_to_mesh_multiple():
    arrs = [torch.tensor(a) for a in _operands(False, b=7)]
    out = ops.neighbor_agg_sharded(*arrs, mesh=_mesh(4))
    assert out.shape[0] == 7
    _close(out, ops.neighbor_agg(*arrs, use_kernel=True), FWD_TOL)


def test_sharded_op_refuses_mismatched_arguments():
    arrs = [torch.tensor(a) for a in _operands(False, b=8)]
    with pytest.raises(ValueError, match="together"):
        ops.neighbor_agg_sharded(*arrs, self_rows=arrs[0][:8],
                                 mesh=_mesh(2))
    rev = ops.build_sharded_reverse_index(arrs[1], arrs[2], 37, _mesh(2))
    with pytest.raises(ValueError, match="another idx"):
        ops.neighbor_agg_sharded(arrs[0], arrs[1].clone(), arrs[2],
                                 mesh=_mesh(2), rev=rev)
    with pytest.raises(ValueError, match="another idx"):
        ops.neighbor_agg_sharded(*arrs, mesh=_mesh(4), rev=rev)
    with pytest.raises(ValueError, match="needs a mesh"):
        ops.neighbor_agg_sharded(*arrs, rev=rev)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_reverse_index_routes_dfeats(shards):
    """With each shard's reverse index the table gradient is the same as
    without it (both sum each row's edges in ascending ELL order in f32
    on the CPU), and each shard's index covers its own rows only."""
    arrs = _operands(False, b=8, seed=5)
    arrs[2][np.random.default_rng(0).random(arrs[2].shape) < 0.3] = 0.0
    t = _t(arrs)
    rev = ops.build_sharded_reverse_index(t[1], t[2].detach(), 37,
                                          _mesh(shards))
    assert len(rev.revs) == shards and rev.nbytes > 0
    assert sum(r.nnz for r in rev.revs) == int((arrs[2] != 0).sum())
    _, g_rev = _grads(lambda *a: ops.neighbor_agg_sharded(
        *a, mesh=_mesh(shards), rev=rev), t)
    _, g_plain = _grads(lambda *a: ops.neighbor_agg_sharded(
        *a, mesh=_mesh(shards)), _t(arrs))
    for a, b in zip(g_rev, g_plain):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# engine level
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def graphs():
    from repro.data import make_sbm_graph as ref_make
    kw = dict(n=122, n_classes=4, avg_degree=8, feat_dim=16, seed=7)
    return ref_make(**kw), make_sbm_graph(**kw)


def _kw(g, **kw):
    base = dict(name="sk", model="gcn", n_nodes=g.n,
                feat_dim=g.feats.shape[1], hidden=16,
                n_classes=g.n_classes, n_layers=2, fanout=(4, 3),
                batch_size=32, loss="ce")
    base.update(kw)
    return base


def _init(kw, seed=0):
    params = RG.init_gnn(jax.random.key(seed), RefConfig(**kw),
                         kw["feat_dim"])
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


def _run(g, cfg, plan, source, params=None):
    return TE.Trainer(g, cfg, plan, source=source, params=params,
                      device="cpu").run()


def _same(a, b):
    ha, hb = a.history, b.history
    assert ha.losses == hb.losses
    assert ha.val_accs == hb.val_accs
    assert ha.full_losses == hb.full_losses
    assert a.final_test_acc == b.final_test_acc


@pytest.mark.parametrize("model", ["gcn", "graphsage"])
def test_sharded_fullgraph_kernel_bit_equal_one_device(graphs, model):
    _, g = graphs
    cfg = GNNConfig(**_kw(g, model=model, use_agg_kernel=True))
    plan = TE.TrainPlan(lr=0.3, n_iters=4, eval_every=2, seed=0)
    _same(_run(g, cfg, plan, TE.FullGraphSource()),
          _run(g, cfg, plan, TE.ShardedFullGraphSource(mesh=_mesh(1))))


@pytest.mark.parametrize("model", ["gcn", "graphsage"])
def test_sharded_minibatch_kernel_bit_equal_one_device(graphs, model):
    _, g = graphs
    cfg = GNNConfig(**_kw(g, model=model, use_agg_kernel=True))
    plan = TE.TrainPlan(lr=0.3, n_iters=4, eval_every=2, seed=0,
                        track_full_loss_every=2)
    _same(_run(g, cfg, plan, TE.SampledSource(batch_size=32)),
          _run(g, cfg, plan, TE.ShardedSampledSource(batch_size=32,
                                                     mesh=_mesh(1))))


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("name", ["fullgraph_sharded", "minibatch_sharded"])
def test_sharded_sources_on_four_shards_match_reference(graphs, name,
                                                        kernel):
    """The reference's sources (its mesh here is one CPU device) and the
    port's on 4 CPU shards, from the same initial parameters: losses and
    tracked full losses within 1e-5; b = 30 rounds up to 32 on 4
    shards, the surplus rows masked out."""
    rg, tg = graphs
    kw = _kw(rg)
    plan_r = RE.TrainPlan(lr=0.3, n_iters=4, eval_every=2, seed=0,
                          track_full_loss_every=2)
    plan_t = TE.TrainPlan(lr=0.3, n_iters=4, eval_every=2, seed=0,
                          track_full_loss_every=2)
    if name == "fullgraph_sharded":
        ref_src, src = RE.ShardedFullGraphSource(), \
            TE.ShardedFullGraphSource(mesh=_mesh(4))
    else:
        ref_src = RE.ShardedSampledSource(batch_size=32)
        src = TE.ShardedSampledSource(batch_size=30, mesh=_mesh(4))
    want = RE.Trainer(rg, RefConfig(**kw), plan_r, source=ref_src).run()
    cfg = GNNConfig(**_kw(tg, use_agg_kernel=kernel))
    got = _run(tg, cfg, plan_t, src, params=_init(kw))
    if name == "minibatch_sharded":
        assert src.b == 32 and src.pad == 2
    else:
        ell = TE._sharded_ell(tg, None, "cpu", _mesh(4))
        assert ell[0].shape[0] == 124                # 122 padded to 4 x 31
        return _close(got.history.losses, want.history.losses, LOSS_TOL)
    # b = 30 on 4 shards draws 30 targets and masks 2 rows: its stream
    # is the reference's at b = 30, not at b = 32
    want30 = RE.Trainer(rg, RefConfig(**kw), plan_r,
                        source=RE.ShardedSampledSource(batch_size=30)).run()
    _close(got.history.losses, want30.history.losses, LOSS_TOL)
    _close(got.history.full_losses, want30.history.full_losses, LOSS_TOL)
    assert want.history.losses != want30.history.losses


def test_sharded_source_memoizes_its_upload_and_index(graphs):
    _, g = graphs
    cfg = GNNConfig(**_kw(g, use_agg_kernel=True))
    plan = TE.TrainPlan(n_iters=1)
    a = TE.ShardedFullGraphSource(mesh=_mesh(4)).bind(g, cfg, plan, "cpu")
    b = TE.ShardedFullGraphSource(mesh=_mesh(4)).bind(g, cfg, plan, "cpu")
    assert a.ell is b.ell and a.rev is b.rev
    assert a.rev.mesh is _mesh(4) and len(a.rev.revs) == 4
    c = TE.ShardedFullGraphSource(mesh=_mesh(2)).bind(g, cfg, plan, "cpu")
    assert c.ell is not a.ell and c.ell[0].shape[0] == 122
    plain = TE.ShardedFullGraphSource(mesh=_mesh(2)).bind(
        g, dataclasses.replace(cfg, use_agg_kernel=False), plan, "cpu")
    assert plain.rev is None


def test_sharded_source_refuses_a_mesh_of_another_device_type(graphs):
    _, g = graphs
    cfg = GNNConfig(**_kw(g))
    mesh = sh.NodeMesh(("meta",))
    with pytest.raises(ValueError, match="different types"):
        TE.ShardedFullGraphSource(mesh=mesh).bind(g, cfg, TE.TrainPlan(),
                                                  "cpu")


@pytest.mark.parametrize("model", ["gcn", "graphsage"])
def test_layerwise_inference_on_a_mesh_matches_one_device(graphs, model):
    """The chunked layer-wise pass with each chunk's launches split over
    4 shards (chunks of 50 rows pad to 52) equals the pass without a
    mesh, and the reference's layers within 1e-5."""
    from repro.core.inference import layerwise_embeddings as ref_layers
    from repro_torch.core import gnn as G
    from repro_torch.core.inference import layerwise_embeddings
    rg, g = graphs
    kw = _kw(g, model=model, use_agg_kernel=True)
    params = G.params_from_numpy(_init(kw), "cpu")
    cfg = GNNConfig(**kw)
    one = layerwise_embeddings(params, cfg, g, chunk_size=50, device="cpu")
    four = layerwise_embeddings(params, cfg, g, chunk_size=50, device="cpu",
                                mesh=_mesh(4))
    want = ref_layers(_init(kw), RefConfig(**dict(kw, use_agg_kernel=False)),
                      rg)
    for a, b, c in zip(four.layers, one.layers, want.layers):
        _close(a, b, FWD_TOL)
        _close(a, c, FWD_TOL)
