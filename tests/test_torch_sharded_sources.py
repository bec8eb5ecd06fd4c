"""What the sharded sources add, on meshes of CPU shards, against the live
reference where it has the same thing:

- ``minibatch_sharded``'s batches array-equal to the reference's
  ``ShardedSampledSource``'s at one seed (b a multiple of the shards), and
  at a b that is not (rounded up, the surplus rows masked) equal to the
  unsharded stream padded;
- ``sweep(sources=[...sharded])`` rows equal to the reference's: the same
  points and labels, losses within 1e-5, test accuracy within one node's
  share of the split;
- exact resume of both sharded sources (replicated table and the
  featshard layout, the kernels' plain versions on these CPU tensors),
  after a kill in the middle of a save too: History, parameters and test
  accuracy bit-equal to the run that was not stopped."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs.base import GNNConfig as RefConfig  # noqa: E402
from repro.core import engine as RE  # noqa: E402
from repro.core import experiment as RX  # noqa: E402
from repro.core import gnn as RG  # noqa: E402

from repro_torch import sharding as sh  # noqa: E402
from repro_torch.checkpoint import latest_step  # noqa: E402
from repro_torch.configs.base import GNNConfig  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core import experiment as TX  # noqa: E402
from repro_torch.core import faults  # noqa: E402
from repro_torch.data.synth import make_sbm_graph  # noqa: E402

LOSS_TOL = 1e-5


def _mesh(s):
    return sh.node_mesh(devices=("cpu",) * s)


@pytest.fixture(scope="module")
def graphs():
    from repro.data import make_sbm_graph as ref_make
    kw = dict(n=240, n_classes=4, avg_degree=8, feat_dim=16, seed=31)
    return ref_make(**kw), make_sbm_graph(**kw)


@pytest.fixture(autouse=True)
def _no_armed_failpoints():
    yield
    faults.disarm()


def _kw(g, **kw):
    base = dict(name="shs", model="graphsage", n_nodes=g.n,
                feat_dim=g.feats.shape[1], hidden=16,
                n_classes=g.n_classes, n_layers=2, fanout=(5, 3),
                batch_size=64, loss="ce")
    base.update(kw)
    return base


def _init(kw, seed):
    params = RG.init_gnn(jax.random.key(seed), RefConfig(**kw),
                         kw["feat_dim"])
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


def _flat(batch):
    out = []
    for leaf in batch:
        for x in (leaf if isinstance(leaf, (list, tuple)) else [leaf]):
            out.append(np.array(x))
    return out


def _stream(src, n):
    gen = src.batches()
    out = []
    for _ in range(n):
        batch, nodes = next(gen)
        out.append((_flat(batch), nodes))
        src.done(batch)
    gen.close()
    src.close()
    return out


@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("shards", [1, 4])
def test_minibatch_sharded_batches_equal_reference(graphs, shards, prefetch):
    rg, tg = graphs
    kw = _kw(rg, batch_size=32)
    plan_r = RE.TrainPlan(n_iters=3, seed=5)
    plan_t = TE.TrainPlan(n_iters=3, seed=5)
    want = _stream(RE.ShardedSampledSource(prefetch=prefetch).bind(
        rg, RefConfig(**kw), plan_r), 3)
    got = _stream(TE.ShardedSampledSource(
        prefetch=prefetch, mesh=_mesh(shards)).bind(
        tg, GNNConfig(**kw), plan_t, "cpu"), 3)
    for (a, na), (b, nb) in zip(got, want):
        assert na == nb and len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_minibatch_sharded_rounds_b_up_and_masks_the_surplus(graphs):
    _, tg = graphs
    kw = _kw(tg, batch_size=30)
    plan = TE.TrainPlan(n_iters=2, seed=2)
    src = TE.ShardedSampledSource(mesh=_mesh(4)).bind(
        tg, GNNConfig(**kw), plan, "cpu")
    assert (src.b, src.b_request, src.pad) == (32, 30, 2)
    got = _stream(src, 2)
    plain = _stream(TE.SampledSource().bind(tg, GNNConfig(**kw), plan,
                                            "cpu"), 2)
    for (a, na), (b, nb) in zip(got, plain):
        assert na == nb == 30
        valid = a[-1]
        np.testing.assert_array_equal(valid, [1.0] * 30 + [0.0] * 2)
        for x, y in zip(a[:-1], b):
            np.testing.assert_array_equal(x[:30], y)
        # the surplus rows gather node 0's features but have no edge,
        # weight or label
        for x in a[3:-1]:
            assert not x[30:].any()


def _metric_cols(row):
    keep = ("paradigm", "b", "fanouts", "seed", "iters", "stop_reason")
    return {k: row[k] for k in keep}


@pytest.mark.parametrize("kernel", [False, True])
def test_sweep_sharded_rows_match_reference(graphs, kernel):
    """The reference's sharded sources on its one-device mesh; the port's
    on its CPU device and, with the kernels, on 4 CPU shards (b = 32 and
    64 divide them, so the streams stay the reference's)."""
    rg, tg = graphs
    kw = _kw(rg)
    plan_r = RE.TrainPlan(lr=0.3, n_iters=4, eval_every=2)
    plan_t = TE.TrainPlan(lr=0.3, n_iters=4, eval_every=2)
    grid = dict(batch_sizes=[32, 64], fanout_grid=[(3, 2)],
                sources=["minibatch_sharded", "fullgraph_sharded"])
    want = RX.sweep(rg, RefConfig(**kw), plan_r, **grid)
    got = TX.sweep(tg, GNNConfig(**dict(kw, use_agg_kernel=kernel)), plan_t,
                   **grid, init_params=lambda s: _init(kw, s),
                   device="cpu", mesh=_mesh(4) if kernel else None)
    assert len(got) == len(want) == 3
    share = 1.0 / len(rg.test_nodes) + 1e-6
    for rgot, rwant in zip(got, want):
        assert _metric_cols(rgot) == _metric_cols(rwant)
        for k in ("first_loss", "final_loss"):
            assert rgot[k] == pytest.approx(rwant[k], abs=LOSS_TOL,
                                            rel=LOSS_TOL)
        assert abs(rgot["test_acc"] - rwant["test_acc"]) <= share


def test_make_source_gives_the_sharded_sources():
    mesh = _mesh(2)
    fg = TX.make_source("fullgraph_sharded", mesh=mesh)
    mb = TX.make_source("minibatch_sharded", b=16, fanouts=(2, 2),
                        mesh=mesh)
    assert type(fg) is TE.ShardedFullGraphSource and fg.mesh is mesh
    assert type(mb) is TE.ShardedSampledSource and mb.mesh is mesh
    assert (mb.batch_size, mb.fanouts) == (16, (2, 2))
    assert set(TX.PARADIGMS) == set(RX.PARADIGMS)
    with pytest.raises(ValueError, match="paradigm must be one of"):
        TX.make_source("fullgraph_replicated")


# ---------------------------------------------------------------------------
# exact resume
# ---------------------------------------------------------------------------

SOURCES = {
    "fullgraph_sharded": lambda: TE.ShardedFullGraphSource(mesh=_mesh(4)),
    "featshard": lambda: TE.ShardedFullGraphSource(mesh=_mesh(4)),
    "minibatch_sharded": lambda: TE.ShardedSampledSource(mesh=_mesh(4)),
}


def _cfg(g, name):
    kw = _kw(g, batch_size=30, use_agg_kernel=True)
    if name == "featshard":
        kw["feats_layout"] = "sharded"
    return GNNConfig(**kw)


def _run(g, cfg, plan, source, **kw):
    return TE.Trainer(g, cfg, plan, source=source, device="cpu").run(**kw)


def _assert_same_run(golden, resumed):
    hg, hr = golden.history, resumed.history
    for f in ("losses", "val_accs", "val_acc_iters", "full_losses",
              "full_loss_iters", "nodes_processed", "bad_steps"):
        assert getattr(hr, f) == getattr(hg, f), f
    for p, q in zip(resumed.params, golden.params):
        for k in p:
            assert torch.equal(p[k], q[k]), k
    assert resumed.final_test_acc == golden.final_test_acc


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_resume_of_sharded_sources_equals_uninterrupted(graphs, tmp_path,
                                                        name):
    _, g = graphs
    cfg = _cfg(g, name)
    make = SOURCES[name]
    plan = TE.TrainPlan(lr=0.3, n_iters=7, seed=0, eval_every=3,
                        track_full_loss_every=2, ckpt_every=2,
                        ckpt_dir=str(tmp_path / "golden"))
    golden = _run(g, cfg, plan, make())
    d = str(tmp_path / "stopped")
    _run(g, cfg, dataclasses.replace(plan, n_iters=4, ckpt_dir=d), make())
    assert latest_step(d) == 3
    resumed = _run(g, cfg, dataclasses.replace(plan, ckpt_dir=d), make(),
                   resume_from=d)
    _assert_same_run(golden, resumed)


@pytest.mark.parametrize("name", ["fullgraph_sharded", "minibatch_sharded"])
def test_kill_mid_checkpoint_then_resume_sharded(graphs, tmp_path, name):
    _, g = graphs
    cfg = _cfg(g, name)
    make = SOURCES[name]
    plan = TE.TrainPlan(lr=0.3, n_iters=7, seed=0, eval_every=3,
                        ckpt_every=2, ckpt_dir=str(tmp_path / "golden"))
    golden = _run(g, cfg, plan, make())
    crash = str(tmp_path / "crash")
    plan2 = dataclasses.replace(plan, ckpt_dir=crash)
    with faults.armed("ckpt.before_npz_rename", at_hits=(1,)):
        with pytest.raises(faults.SimulatedCrash):
            _run(g, cfg, plan2, make())
    assert latest_step(crash) == 2
    _assert_same_run(golden, _run(g, cfg, plan2, make(),
                                  resume_from=crash))
