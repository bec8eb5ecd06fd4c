"""The port's cluster and importance-sampled sources against the live
reference: batch streams array-equal at the same seed (the cluster
source's block-diagonal batch ELL; the importance source's targets, row
weights and validity column), ``grad`` scores, 5-step losses from the
reference's initial parameters, the refusals' messages, and the
reference's own source cases (tests/test_sources.py) on the port.

Tolerances: losses 1e-5 (f32, 5 steps), ``grad`` scores 1e-5 relative,
test accuracy within one node's share of its split.  The reference runs
its plain path; the port its plain path, or its kernel path through the
kernels' plain versions on these CPU tensors."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs.base import GNNConfig as RefConfig  # noqa: E402
from repro.core import engine as RE  # noqa: E402
from repro.core import gnn as RG  # noqa: E402

from repro_torch.configs.base import GNNConfig  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core import experiment as TX  # noqa: E402
from repro_torch.core.gnn import gnn_loss  # noqa: E402
from repro_torch.data.synth import make_sbm_graph  # noqa: E402

LOSS_TOL = 1e-5


@pytest.fixture(scope="module")
def graphs():
    from repro.data import make_sbm_graph as ref_make
    kw = dict(n=240, n_classes=4, avg_degree=8, feat_dim=16, seed=31)
    return ref_make(**kw), make_sbm_graph(**kw)


def _kw(g, **kw):
    base = dict(name="src", model="graphsage", n_nodes=g.n,
                feat_dim=g.feats.shape[1], hidden=16,
                n_classes=g.n_classes, n_layers=2, fanout=(5, 3),
                batch_size=64, loss="ce")
    base.update(kw)
    return base


def _init(kw, seed):
    """The reference Trainer's initial parameters for ``seed`` as numpy."""
    params = RG.init_gnn(jax.random.key(seed), RefConfig(**kw),
                         kw["feat_dim"])
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


def _no_train(g):
    return dataclasses.replace(g, train_mask=np.zeros(g.n, bool))


def _flat(batch):
    out = []
    for leaf in batch:
        for x in (leaf if isinstance(leaf, (list, tuple)) else [leaf]):
            out.append(np.array(x))
    return out


def _stream(src, n):
    """The first ``n`` batches of a bound source (either package),
    copied out (the staging slots are recycled by ``done``)."""
    gen = src.batches()
    out = []
    for _ in range(n):
        batch, nodes = next(gen)
        out.append((_flat(batch), nodes))
        src.done(batch)
    gen.close()
    src.close()
    return out


def _assert_streams_equal(got, want):
    assert len(got) == len(want)
    for (g, gn), (w, wn) in zip(got, want):
        assert gn == wn
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# parity: batches, scores, losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,k,n_parts", [(64, 2, None), (48, 3, None),
                                         (None, 2, 240), (200, 1, 5)])
def test_cluster_batches_equal_reference(graphs, b, k, n_parts):
    rg, tg = graphs
    kw = _kw(rg)
    plan = dict(n_iters=5, seed=4)
    rs = RE.ClusterSource(batch_size=b, clusters_per_batch=k,
                          n_parts=n_parts).bind(rg, RefConfig(**kw),
                                                RE.TrainPlan(**plan))
    ts = TE.ClusterSource(batch_size=b, clusters_per_batch=k,
                          n_parts=n_parts).bind(
        tg, GNNConfig(**kw), TE.TrainPlan(**plan), "cpu")
    assert (ts.m_max, ts.K, ts.k, ts.n_parts_) == \
        (rs.m_max, rs.K, rs.k, rs.n_parts_)
    _assert_streams_equal(_stream(ts, 5), _stream(rs, 5))


@pytest.mark.parametrize("scores", ["degree", "uniform", "array", "zeros"])
@pytest.mark.parametrize("b,prefetch", [(32, True), (32, False),
                                        (300, True)])
def test_importance_batches_equal_reference(graphs, scores, b, prefetch):
    rg, tg = graphs
    kw = _kw(rg)
    s = {"degree": "degree", "uniform": "uniform",
         "array": np.random.default_rng(5).random(rg.n),
         "zeros": np.where(np.arange(rg.n) % 3 == 0, 0.0,
                           1.0 + np.arange(rg.n) % 7)}[scores]
    plan = dict(n_iters=4, seed=6)
    rs = RE.ImportanceSampledSource(batch_size=b, scores=s,
                                    prefetch=prefetch).bind(
        rg, RefConfig(**kw), RE.TrainPlan(**plan))
    ts = TE.ImportanceSampledSource(batch_size=b, scores=s,
                                    prefetch=prefetch).bind(
        tg, GNNConfig(**kw), TE.TrainPlan(**plan), "cpu")
    np.testing.assert_array_equal(ts._p, rs._p)
    np.testing.assert_array_equal(ts._w, rs._w)
    assert ts.pad == rs.pad == 0
    got, want = _stream(ts, 4), _stream(rs, 4)
    _assert_streams_equal(got, want)
    # the last two columns: validity, then the 1/(n_train p) row weights
    assert np.all(got[0][0][-2] == 1.0)
    assert got[0][0][-1].shape == (b,)


@pytest.mark.parametrize("loss", ["ce", "mse"])
def test_grad_scores_match_reference(graphs, loss):
    rg, tg = graphs
    kw = _kw(rg, loss=loss)
    rs = RE.ImportanceSampledSource(scores="grad").bind(
        rg, RefConfig(**kw), RE.TrainPlan(seed=2))
    ts = TE.ImportanceSampledSource(scores="grad").bind(
        tg, GNNConfig(**kw), TE.TrainPlan(seed=2), "cpu",
        params=_init(kw, 2))
    np.testing.assert_allclose(ts._p, rs._p, rtol=LOSS_TOL, atol=0)
    ts.close()
    rs.close()


def test_trainer_hands_its_params_to_the_grad_scores(graphs):
    """The Trainer binds its source with the run's initial parameters:
    with ``params=`` those, else the ones it draws from the seed."""
    _, tg = graphs
    kw = _kw(tg)
    given = TE.Trainer(tg, GNNConfig(**kw), TE.TrainPlan(seed=2),
                       source=TE.ImportanceSampledSource(scores="grad"),
                       params=_init(kw, 2), device="cpu").source
    alone = TE.ImportanceSampledSource(scores="grad").bind(
        tg, GNNConfig(**kw), TE.TrainPlan(seed=2), "cpu",
        params=_init(kw, 2))
    np.testing.assert_array_equal(given._p, alone._p)
    drawn = TE.Trainer(tg, GNNConfig(**kw), TE.TrainPlan(seed=2),
                       source=TE.ImportanceSampledSource(scores="grad"),
                       device="cpu").source
    unbound = TE.ImportanceSampledSource(scores="grad").bind(
        tg, GNNConfig(**kw), TE.TrainPlan(seed=2), "cpu")
    np.testing.assert_array_equal(drawn._p, unbound._p)
    for s in (given, alone, drawn, unbound):
        s.close()


def _sources():
    return {
        "cluster": (lambda m: m.ClusterSource(batch_size=64)),
        "cluster_k3": (lambda m: m.ClusterSource(batch_size=48,
                                                 clusters_per_batch=3)),
        "importance": (lambda m: m.ImportanceSampledSource(batch_size=32)),
        "importance_uniform": (lambda m: m.ImportanceSampledSource(
            batch_size=32, scores="uniform")),
        "importance_grad": (lambda m: m.ImportanceSampledSource(
            batch_size=32, scores="grad")),
    }


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("name", sorted(_sources()))
def test_five_step_losses_match_reference(graphs, name, kernel):
    rg, tg = graphs
    kw = _kw(rg)
    make = _sources()[name]
    plan = dict(lr=0.3, n_iters=5, eval_every=2, seed=3,
                track_full_loss_every=2)
    want = RE.Trainer(rg, RefConfig(**kw), RE.TrainPlan(**plan),
                      source=make(RE)).run()
    got = TE.Trainer(tg, GNNConfig(**dict(kw, use_agg_kernel=kernel)),
                     TE.TrainPlan(**plan), source=make(TE),
                     params=_init(kw, 3), device="cpu").run()
    hg, hw = got.history, want.history
    np.testing.assert_allclose(hg.losses, hw.losses, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(hg.full_losses, hw.full_losses,
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    assert hg.nodes_processed == hw.nodes_processed
    assert hg.val_acc_iters == hw.val_acc_iters
    share = 1.0 / len(tg.test_nodes) + 1e-6
    assert abs(got.final_test_acc - want.final_test_acc) <= share


@pytest.mark.parametrize("bad", ["negative", "length", "mode", "nan",
                                 "all_zero"])
def test_score_refusals_match_reference(graphs, bad):
    rg, tg = graphs
    kw = _kw(rg)
    s = {"negative": -np.ones(rg.n), "length": np.ones(7), "mode": "nope",
         "nan": np.full(rg.n, np.nan), "all_zero": np.zeros(rg.n)}[bad]
    with pytest.raises(ValueError) as want:
        RE.ImportanceSampledSource(scores=s).bind(
            rg, RefConfig(**kw), RE.TrainPlan(n_iters=1))
    with pytest.raises(ValueError) as got:
        TE.ImportanceSampledSource(scores=s).bind(
            tg, GNNConfig(**kw), TE.TrainPlan(n_iters=1), "cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("make", [
    lambda m: m.ClusterSource(clusters_per_batch=0),
    lambda m: m.ClusterSource(n_parts=0)], ids=["k0", "parts0"])
def test_cluster_refusals_match_reference(make):
    with pytest.raises(ValueError) as want:
        make(RE)
    with pytest.raises(ValueError) as got:
        make(TE)
    assert str(got.value) == str(want.value)


def test_cluster_requires_a_train_cluster_like_reference(graphs):
    rg, tg = graphs
    kw = _kw(rg)
    with pytest.raises(ValueError) as want:
        RE.ClusterSource().bind(_no_train(rg), RefConfig(**kw),
                                RE.TrainPlan(n_iters=1))
    with pytest.raises(ValueError) as got:
        TE.ClusterSource().bind(_no_train(tg), GNNConfig(**kw),
                                TE.TrainPlan(n_iters=1), "cpu")
    assert str(got.value) == str(want.value)
    assert "no cluster contains" in str(got.value)


# ---------------------------------------------------------------------------
# the reference's source cases on the port
# ---------------------------------------------------------------------------

def test_cluster_source_trains_and_is_deterministic(graphs):
    _, g = graphs
    cfg = GNNConfig(**_kw(g))
    plan = TE.TrainPlan(lr=0.3, n_iters=6, eval_every=3, seed=0)
    r1 = TE.Trainer(g, cfg, plan, source=TE.ClusterSource(),
                    device="cpu").run()
    r2 = TE.Trainer(g, cfg, plan, source=TE.ClusterSource(),
                    device="cpu").run()
    assert r1.history.losses == r2.history.losses
    assert r1.history.val_accs == r2.history.val_accs
    assert r1.final_test_acc == r2.final_test_acc
    assert all(np.isfinite(r1.history.losses))
    assert all(n >= 1 for n in r1.history.nodes_processed)


def test_cluster_batches_have_one_fixed_shape(graphs):
    _, g = graphs
    src = TE.ClusterSource().bind(g, GNNConfig(**_kw(g)),
                                  TE.TrainPlan(n_iters=5), "cpu")
    shapes = {tuple(x.shape for x in flat) for flat, _ in _stream(src, 5)}
    assert len(shapes) == 1
    assert next(iter(shapes))[0] == (src.m_max, src.K)


def test_cluster_source_single_node_clusters(graphs):
    """n_parts = n: every batch is k isolated nodes with w_self = 1."""
    _, g = graphs
    src = TE.ClusterSource(clusters_per_batch=4, n_parts=g.n)
    res = TE.Trainer(g, GNNConfig(**_kw(g)),
                     TE.TrainPlan(lr=0.3, n_iters=4, seed=0), source=src,
                     device="cpu").run()
    assert all(len(c) == 1 for c in src.blocks.clusters)
    assert src.m_max == 4 and src.K == 1
    assert all(np.isfinite(res.history.losses))


def test_cluster_loss_builds_a_reverse_index_with_the_kernel(graphs,
                                                             monkeypatch):
    """With ``use_agg_kernel`` the cluster loss hands the batch ELL's
    reverse index to the forward (so dfeats takes the reverse-index
    backward); without it, none."""
    _, g = graphs
    seen = []
    real = TE.G.full_graph_forward

    def spy(*a, rev=None, **k):
        seen.append(rev)
        return real(*a, rev=rev, **k)

    monkeypatch.setattr(TE.G, "full_graph_forward", spy)
    for kernel in (True, False):
        src = TE.ClusterSource().bind(
            g, GNNConfig(**_kw(g, use_agg_kernel=kernel)),
            TE.TrainPlan(n_iters=1), "cpu")
        batch, _ = next(src.batches())
        params = TE.initial_params(g, src.cfg, TE.TrainPlan(), None, "cpu")
        src.loss(params, batch)
        src.done(batch)
        src.close()
    assert seen[0] is not None and seen[0].idx is not None
    assert seen[0].n == src.m_max and seen[1] is None


def test_cluster_source_through_run_experiment(graphs):
    _, g = graphs
    row = TX.run_experiment(g, GNNConfig(**_kw(g)),
                            TE.TrainPlan(lr=0.3, n_iters=3),
                            paradigm="cluster", b=48, device="cpu")
    assert row["paradigm"] == "cluster"
    assert row["fanouts"].startswith("clusters(k=")
    assert row["iters"] == 3


def test_importance_weights_are_unbiased_by_construction(graphs):
    _, g = graphs
    src = TE.ImportanceSampledSource().bind(g, GNNConfig(**_kw(g)),
                                            TE.TrainPlan(n_iters=1), "cpu")
    assert np.isclose(float((src._p * src._w).sum()), 1.0)
    assert (src._w > 0).all()


def test_importance_deterministic_and_scale_free(graphs):
    """Same seed, same run; scores scaled by a constant, the same run."""
    _, g = graphs
    cfg = GNNConfig(**_kw(g))
    plan = TE.TrainPlan(lr=0.3, n_iters=5, eval_every=4, seed=0)
    s = (g.degrees + 1).astype(np.float64)
    r = [TE.Trainer(g, cfg, plan, device="cpu",
                    source=TE.ImportanceSampledSource(scores=sc)).run()
         for sc in ("degree", "degree", s, 17.0 * s)]
    assert r[0].history.losses == r[1].history.losses
    assert r[0].final_test_acc == r[1].final_test_acc
    np.testing.assert_allclose(r[2].history.losses, r[3].history.losses,
                               rtol=1e-6, atol=1e-6)


def test_importance_batch_larger_than_train_split(graphs):
    _, g = graphs
    b = len(g.train_nodes) + 16
    src = TE.ImportanceSampledSource(batch_size=b)
    res = TE.Trainer(g, GNNConfig(**_kw(g, batch_size=b)),
                     TE.TrainPlan(lr=0.3, n_iters=3, seed=0), source=src,
                     device="cpu").run()
    assert src.pad == 0
    assert res.history.nodes_processed[0] == b
    assert all(np.isfinite(res.history.losses))


def test_weighted_batch_mean_is_the_hand_sum(graphs):
    """On one batch: the loss is Σ_j w_j ℓ_j / b with ℓ_j the rows'
    cross-entropy computed by hand from the same logits."""
    _, g = graphs
    cfg = GNNConfig(**_kw(g))
    src = TE.ImportanceSampledSource(batch_size=40).bind(
        g, cfg, TE.TrainPlan(n_iters=1), "cpu")
    batch, _ = next(src.batches())
    params = TE.initial_params(g, cfg, TE.TrainPlan(), None, "cpu")
    got = float(src.loss(params, batch))
    feats, masks, weights, self_w, labels, valid, row_w = batch
    z = TE.G.minibatch_forward(params, cfg, feats, masks, weights,
                               self_w).double().detach().numpy()
    lab = labels.numpy()
    rows = np.log(np.exp(z).sum(-1)) - z[np.arange(len(lab)), lab]
    want = float((row_w.numpy() * rows).sum() / 40)
    src.done(batch)
    src.close()
    assert abs(got - want) <= 1e-5 * abs(want)


def test_gnn_loss_weight_oracle():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(8, 3)).astype(np.float32)
    labels = rng.integers(0, 3, 8).astype(np.int32)
    w = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    t = torch.from_numpy
    got = float(gnn_loss(t(logits), t(labels), "ce", 3,
                         valid=torch.ones(8), weight=t(w)))
    z = logits.astype(np.float64)
    rows = np.log(np.exp(z).sum(-1)) - z[np.arange(8), labels]
    assert np.isclose(got, float((rows * w).mean()), atol=1e-5)
    plain = float(gnn_loss(t(logits), t(labels), "ce", 3))
    ones = float(gnn_loss(t(logits), t(labels), "ce", 3,
                          weight=torch.ones(8)))
    assert plain == ones


def test_sweep_runs_the_sampler_cube_without_duplicate_clusters(graphs):
    _, g = graphs
    rows = TX.sweep(g, GNNConfig(**_kw(g, n_layers=1, fanout=(3,))),
                    TE.TrainPlan(lr=0.3, n_iters=2, eval_every=100),
                    batch_sizes=[32], fanout_grid=[(3,), (5,)],
                    sources=["minibatch", "cluster", "importance"],
                    device="cpu")
    names = [r["paradigm"] for r in rows]
    assert names.count("cluster") == 1
    assert names.count("minibatch") == names.count("importance") == 2
    assert all(np.isfinite(r["final_loss"]) for r in rows)


@pytest.mark.parametrize("paradigm,cls", [
    ("fullgraph", TE.FullGraphSource), ("minibatch", TE.SampledSource),
    ("cluster", TE.ClusterSource),
    ("importance", TE.ImportanceSampledSource)])
def test_make_source_dispatches(paradigm, cls):
    src = TX.make_source(paradigm, b=16, fanouts=(3,))
    assert type(src) is cls and src.name == paradigm
