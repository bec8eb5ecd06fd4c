"""The NODES-sharded paths one process a rank (``launch.procs``,
``sharding.process_node_mesh``) on the CPU over gloo, held against the
single-process port and the reference's 4-device CPU mesh:

(a) the three collectives and their adjoints at world size 2 and 4
    against the single-controller ``Mesh`` on the same parts;
(b) ``fullgraph_sharded`` (plain and kernel path, graphsage and gcn) at
    world size 1 bit-equal to ``FullGraphSource``, at 2 and 4 within 1e-5
    of the reference's ``ShardedFullGraphSource`` on 4 CPU devices;
(c) ``minibatch_sharded`` at b = 30: world size 1 bit-equal to
    ``SampledSource``, 4 ranks (padded to 32) within 1e-5 of the
    reference's multi-device run;
(d) the featshard layout at world size 2 and 4 against the reference's
    featshard run on 4 CPU devices;
(e) residency: each rank's ELL, feature and label tensors have
    ``n_pad / S`` rows, its featshard plan and mini-batch rows likewise;
(f) a rank that raises, or leaves the others in a collective, fails the
    run within its timeout, and no rank is left running;
(g) a 2-rank run killed after a checkpoint and resumed has the losses of
    the run that was not stopped.

Every rank runs in a process of its own (``procs.spawn``), its process
group initialised from a ``file://`` path under ``tmp_path``; the
reference runs once, in a subprocess with four virtual CPU devices,
started when the module's first test starts.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch import sharding as sh
from repro_torch.configs.base import GNNConfig
from repro_torch.core import engine as E
from repro_torch.core import faults
from repro_torch.core import gnn as G
from repro_torch.data.synth import make_sbm_graph
from repro_torch.launch import procs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-5
JOIN_S = 120          # a spawn's join: a hang fails the test
GRAPH = dict(n=240, n_classes=4, avg_degree=8, feat_dim=16, seed=5)
ITERS = 4
FS_ITERS = 2          # the reference's featshard run is in interpret mode

_REF_SCRIPT = r"""
import dataclasses, json
import jax, numpy as np
assert len(jax.devices()) == 4, jax.devices()
from repro.data import make_sbm_graph
from repro.configs.base import GNNConfig
from repro.core import gnn as RG
from repro.core.engine import (ShardedFullGraphSource, ShardedSampledSource,
                               Trainer, TrainPlan)
g = make_sbm_graph(**GRAPH)
base = GNNConfig(name="md", model="graphsage", n_nodes=g.n, feat_dim=16,
                 hidden=32, n_classes=g.n_classes, n_layers=2,
                 fanout=(5, 3), batch_size=30, loss="ce")
out = {}
def run(key, cfg, src, iters):
    r = Trainer(g, cfg, TrainPlan(lr=0.3, n_iters=iters, eval_every=2,
                                  seed=0), source=src).run()
    out[key] = {"losses": r.history.losses, "val_accs": r.history.val_accs,
                "test_acc": float(r.final_test_acc)}
    return src
for model in ("graphsage", "gcn"):
    cfg = dataclasses.replace(base, model=model)
    out["params_" + model] = [
        {k: np.asarray(v).tolist() for k, v in p.items()}
        for p in RG.init_gnn(jax.random.key(0), cfg, 16)]
    run("fg_" + model, cfg, ShardedFullGraphSource(), ITERS)
src = run("mb", base, ShardedSampledSource(batch_size=30), ITERS)
assert src.b == 32 and src.pad == 2, (src.b, src.pad)
fs = dataclasses.replace(base, model="gcn", use_agg_kernel=True,
                         agg_interpret=True, feats_layout="sharded",
                         feat_cache_rows=-1)
run("fs_gcn", fs, ShardedFullGraphSource(), FS_ITERS)
print("REF_JSON " + json.dumps(out))
"""


# ---------------------------------------------------------------------------
# the reference, once, in the background
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The module's own runs on one intra-op thread, as every rank: the
    ranks do not crowd the host's cores, and a CPU reduction's order
    (which follows the thread count) is the same here and in a rank."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.fixture(scope="module", autouse=True)
def _reference_proc(tmp_path_factory):
    """The reference's 4-device run, started before the module's first
    test and read by ``reference``."""
    pytest.importorskip("jax")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep \
        + env.get("PYTHONPATH", "")
    script = (f"GRAPH = {GRAPH!r}\nITERS = {ITERS}\nFS_ITERS = {FS_ITERS}\n"
              + _REF_SCRIPT)
    log = tmp_path_factory.mktemp("ref") / "out.txt"
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, "-c", script], stdout=f,
                                stderr=subprocess.STDOUT, env=env)
    yield proc, log
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def reference(_reference_proc):
    proc, log = _reference_proc
    try:
        proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    text = log.read_text()
    assert proc.returncode == 0, text[-3000:]
    line = [ln for ln in text.splitlines() if ln.startswith("REF_JSON ")]
    assert line, text[-3000:]
    return json.loads(line[-1][len("REF_JSON "):])


# ---------------------------------------------------------------------------
# what the ranks run (module level: spawn imports them by name)
# ---------------------------------------------------------------------------

def _graph():
    return make_sbm_graph(**GRAPH)


def _cfg(g, **kw):
    base = dict(name="md", model="graphsage", n_nodes=g.n, feat_dim=16,
                hidden=32, n_classes=g.n_classes, n_layers=2, fanout=(5, 3),
                batch_size=30, loss="ce")
    base.update(kw)
    return GNNConfig(**base)


#: case -> (source kind, config fields, iterations)
CASES = {
    "fg_graphsage": ("fg", dict(model="graphsage"), ITERS),
    "fg_graphsage_kernel": ("fg", dict(model="graphsage",
                                       use_agg_kernel=True), ITERS),
    "fg_gcn": ("fg", dict(model="gcn"), ITERS),
    "fg_gcn_kernel": ("fg", dict(model="gcn", use_agg_kernel=True), ITERS),
    "mb": ("mb", dict(model="graphsage"), ITERS),
    "mb_kernel": ("mb", dict(model="graphsage", use_agg_kernel=True), ITERS),
    "fs_gcn": ("fg", dict(model="gcn", use_agg_kernel=True,
                          feats_layout="sharded", feat_cache_rows=-1),
               FS_ITERS),
}


def _source(kind, mesh):
    if kind == "mb":
        return E.ShardedSampledSource(batch_size=30, mesh=mesh)
    return E.ShardedFullGraphSource(mesh=mesh)


def _plan(iters, **kw):
    return E.TrainPlan(lr=0.3, n_iters=iters, eval_every=2, seed=0, **kw)


def _summary(res):
    return {"losses": res.history.losses, "val_accs": res.history.val_accs,
            "test_acc": res.final_test_acc,
            "params": [{k: v.detach().numpy() for k, v in p.items()}
                       for p in res.params]}


def _residency(g, mesh):
    """Rows of what this rank holds: the full-graph source's ELL,
    features and labels, its featshard plan's phase-1 ids and its
    reverse index, the mini-batch source's staged targets."""
    out = {}
    src = E.ShardedFullGraphSource(mesh=mesh).bind(
        g, _cfg(g, use_agg_kernel=True), _plan(1), "cpu")
    out["ell"] = [tuple(t.shape) for t in src.ell]
    out["rev"] = [(r.b, r.n) for r in src.rev.revs]
    src.close()
    src = E.ShardedFullGraphSource(mesh=mesh).bind(
        g, _cfg(g, use_agg_kernel=True, feats_layout="sharded"), _plan(1),
        "cpu")
    out["plan"] = [tuple(t.shape) for t in src.feats_plan.lidx_hot]
    src.close()
    src = E.ShardedSampledSource(batch_size=30, mesh=mesh).bind(
        g, _cfg(g), _plan(1), "cpu")
    out["eval_ell"] = [tuple(t.shape) for t in src.ell]
    stream = src.batches()
    batch, _ = next(stream)
    out["batch"] = [tuple(t.shape) for t in batch[0]] + [
        tuple(batch[4].shape)]
    src.done(batch)
    stream.close()
    return out


def _mesh(rank, world, init, **kw):
    """This rank's process-group mesh on the CPU, on one intra-op thread
    (as the module runs: see ``_one_thread``)."""
    torch.set_num_threads(1)
    return sh.process_node_mesh(procs.init(rank, world, init, device="cpu",
                                           **kw))


def _train_ranks(rank, world, init, params):
    """Every case on this rank's process-group mesh; the residency."""
    mesh = _mesh(rank, world, init)
    g = _graph()
    out = {}
    for name, (kind, kw, iters) in CASES.items():
        cfg = _cfg(g, **kw)
        out[name] = _summary(E.Trainer(
            g, cfg, _plan(iters), source=_source(kind, mesh),
            params=params[cfg.model], device="cpu").run())
    out["residency"] = _residency(g, mesh)
    return out


def _collective_ranks(rank, world, init):
    """all_gather / psum / psum_scatter of this rank's part and their
    adjoints, for each dtype and dim: outputs and part gradients."""
    mesh = _mesh(rank, world, init)
    out = {}
    for key, parts, cots in _collective_inputs(world):
        op, dtype, dim = key
        x = parts[rank].clone().requires_grad_()
        y = _apply(op, [x], mesh, dim)[0]
        (y.float() * cots[rank]).sum().backward()
        out[key] = (y.detach().float().numpy(), x.grad.float().numpy())
    return out


def _collective_inputs(world):
    rng = np.random.default_rng(7)
    for op in ("all_gather", "psum", "psum_scatter"):
        for dtype in (torch.float32, torch.bfloat16):
            for dim in (0, 1):
                shape = (4 * world, 3 * world)
                parts = [torch.tensor(rng.normal(size=shape).astype(
                    np.float32)).to(dtype) for _ in range(world)]
                n = {"all_gather": world, "psum": 1,
                     "psum_scatter": 1}[op]
                oshape = list(shape)
                oshape[dim] = (shape[dim] * n if op == "all_gather" else
                               shape[dim] // world if op == "psum_scatter"
                               else shape[dim])
                cots = [torch.tensor(rng.normal(size=oshape).astype(
                    np.float32)) for _ in range(world)]
                yield (op, str(dtype), dim), parts, cots


def _apply(op, parts, mesh, dim):
    if op == "all_gather":
        return sh.all_gather(parts, mesh, dim)
    if op == "psum":
        return sh.psum(parts, mesh)
    return sh.psum_scatter(parts, mesh, dim)


def _fail_ranks(rank, world, init, how):
    """Rank 1 raises (``raise``) or returns (``leave``) while rank 0
    waits in an all_gather."""
    mesh = _mesh(rank, world, init, timeout_s=5)
    if rank == 1:
        if how == "raise":
            raise ValueError("planted failure on rank 1")
        return "left"
    sh.all_gather([torch.ones(2, 2)], mesh)
    return "gathered"


class _Kill(E.Callback):
    """A kill after the step ``at``: every rank stops there."""

    def __init__(self, at):
        self.at = at

    def on_step(self, state):
        if state.it == self.at:
            raise faults.SimulatedCrash(f"killed after step {self.at}")


def _resume_ranks(rank, world, init, params, root):
    mesh = _mesh(rank, world, init)
    g = _graph()
    out = {}
    for kind in ("fg", "mb"):
        cfg = _cfg(g, use_agg_kernel=True)

        def trainer(ckpt, extra=()):
            plan = _plan(6, ckpt_every=2,
                         ckpt_dir=os.path.join(root, f"{kind}_{ckpt}"))
            return E.Trainer(g, cfg, plan, source=_source(kind, mesh),
                             params=params, device="cpu",
                             extra_callbacks=extra)
        golden = trainer("golden").run()
        try:
            trainer("killed", [_Kill(3)]).run()
            raise AssertionError("the kill did not happen")
        except faults.SimulatedCrash:
            pass
        resumed = trainer("killed").run(
            resume_from=os.path.join(root, f"{kind}_killed"))
        out[kind] = (_summary(golden), _summary(resumed))
    return out


# ---------------------------------------------------------------------------
# runs shared by the tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def train_runs(reference, tmp_path_factory):
    """world -> every rank's results of ``_train_ranks``."""
    params = {m: reference["params_" + m] for m in ("graphsage", "gcn")}
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = procs.spawn(
                _train_ranks, world, (params,), timeout_s=JOIN_S,
                init_dir=str(tmp_path_factory.mktemp(f"pg{world}")))
        return cache[world]
    return get


@pytest.fixture(scope="module")
def single(reference):
    """The single-process port on the CPU: case -> (run of the unsharded
    source, of the single-controller sharded source on 1 shard)."""
    g = _graph()
    params = {m: reference["params_" + m] for m in ("graphsage", "gcn")}
    out = {}
    for name, (kind, kw, iters) in CASES.items():
        cfg = _cfg(g, **kw)
        plain = (E.SampledSource(batch_size=30) if kind == "mb"
                 else E.FullGraphSource())
        out[name] = _summary(E.Trainer(g, cfg, _plan(iters), source=plain,
                                       params=params[cfg.model],
                                       device="cpu").run())
    return out


# ---------------------------------------------------------------------------
# (a) the collectives and their adjoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_collectives_and_adjoints_match_the_single_controller_mesh(
        world, tmp_path):
    got = procs.spawn(_collective_ranks, world, timeout_s=JOIN_S,
                      init_dir=str(tmp_path))
    mesh = sh.Mesh((world, 1), ("data", "model"), ("cpu",) * world)
    group = mesh.group("data", 0)
    for key, parts, cots in _collective_inputs(world):
        op, dtype, dim = key
        xs = [p.clone().requires_grad_() for p in parts]
        ys = _apply(op, xs, group, dim)
        sum((y.float() * c).sum() for y, c in zip(ys, cots)).backward()
        tol = dict(rtol=1e-6, atol=1e-6) if dtype == str(torch.float32) \
            else dict(rtol=1e-2, atol=1e-2)
        for r in range(world):
            y, g = got[r][key]
            if op == "all_gather":
                np.testing.assert_array_equal(y, ys[r].detach().float())
            else:
                np.testing.assert_allclose(y, ys[r].detach().float(),
                                           err_msg=str(key), **tol)
            np.testing.assert_allclose(g, xs[r].grad.float(),
                                       err_msg=str(key), **tol)


def test_one_rank_collectives_return_the_part(tmp_path):
    """World size 1: every collective returns its part itself (the
    bit-equality of one shard)."""
    got = procs.spawn(_collective_ranks, 1, timeout_s=JOIN_S,
                      init_dir=str(tmp_path))[0]
    for key, parts, _ in _collective_inputs(1):
        np.testing.assert_array_equal(got[key][0], parts[0].float())


# ---------------------------------------------------------------------------
# (f) failures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("how", ["raise", "leave"])
def test_a_failing_rank_fails_the_run_within_its_timeout(tmp_path, how):
    t0 = time.monotonic()
    with pytest.raises(procs.RankError) as err:
        procs.spawn(_fail_ranks, 2, (how,), timeout_s=JOIN_S,
                    init_dir=str(tmp_path))
    assert time.monotonic() - t0 < JOIN_S
    if how == "raise":
        assert err.value.rank == 1 and "planted failure" in str(err.value)
    else:
        assert err.value.rank == 0       # its collective timed out


def test_spawn_leaves_no_process_running(tmp_path):
    import multiprocessing as mp
    with pytest.raises(procs.RankError):
        procs.spawn(_fail_ranks, 2, ("raise",), timeout_s=JOIN_S,
                    init_dir=str(tmp_path))
    assert mp.active_children() == []


def test_layout_names_its_transport_and_never_switches(monkeypatch):
    """The CPU takes gloo; a card asked for where there is none raises
    (no quiet CPU run); ``init`` with no rank needs torchrun's
    environment."""
    assert procs.layout("cpu", 0, 4) == ("gloo", torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in ("cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="is_available"):
            procs.layout(dev, 0, 2)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="WORLD_SIZE"):
        procs.init(device="cpu")


# ---------------------------------------------------------------------------
# (e) the row blocks, and the loss shares
# ---------------------------------------------------------------------------

def test_rank_rows_and_blocks_cover_the_table_once():
    """``rank_rows`` / ``rank_block`` give rank r the block ``row_owner``
    assigns it, with the padding rows on the last rank."""
    a = np.arange(10 * 3).reshape(10, 3)

    class _T:
        def __init__(self, rank, world):
            self.rank, self.world, self.device = rank, world, "cpu"
            self.name = "gloo"
    for world in (1, 3, 4):
        padded = sh.pad_rows(a, world)
        owner = sh.row_owner(padded.shape[0], world)
        blocks = []
        for r in range(world):
            mesh = sh.process_node_mesh(_T(r, world))
            lo, hi = sh.rank_rows(padded.shape[0], mesh)
            assert (owner[lo:hi] == r).all()
            blocks.append(sh.rank_block(a, mesh))
            # a rank's rows are its one block of a NODES-sharded table
            (own,) = sh.shard_rows(torch.as_tensor(blocks[-1]), mesh)
            assert own.shape == (hi - lo, 3)
        np.testing.assert_array_equal(np.concatenate(blocks), padded)


def test_loss_denominator_is_a_share_of_the_mean():
    """``gnn_loss(denom=)``: ranks' shares of row sums add up to the
    mean over all rows, for CE and MSE, with and without a mask."""
    gen = torch.Generator().manual_seed(0)
    z = torch.randn(12, 5, generator=gen)
    y = torch.randint(0, 5, (12,), generator=gen)
    valid = (torch.arange(12) < 10).float()
    for kind in ("ce", "mse"):
        for v in (None, valid):
            whole = G.gnn_loss(z, y, kind, 5, valid=v)
            n = 12 if v is None else 10
            parts = sum(G.gnn_loss(z[i:i + 4], y[i:i + 4], kind, 5,
                                   valid=None if v is None else v[i:i + 4],
                                   denom=n) for i in range(0, 12, 4))
            torch.testing.assert_close(parts, whole, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# (b)-(d) training against the single process and the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_world_one_is_bit_equal_to_the_unsharded_source(train_runs, single,
                                                         case):
    got = train_runs(1)[0][case]
    want = single[case]
    assert got["losses"] == want["losses"]
    assert got["val_accs"] == want["val_accs"]
    assert got["test_acc"] == want["test_acc"]
    for a, b in zip(got["params"], want["params"]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("world", [2, 4])
def test_ranks_match_the_reference_four_device_mesh(train_runs, reference,
                                                    world, case):
    """Every rank logs the same all-reduced losses, within 1e-5 of the
    reference's run on its 4-device CPU mesh (the kernel paths against
    the reference's einsum path, which its own tests hold to its kernel
    path; the featshard layout against its featshard run)."""
    runs = train_runs(world)
    want = reference[case.replace("_kernel", "")]
    for r in runs:
        assert r[case]["losses"] == runs[0][case]["losses"]
        assert r[case]["val_accs"] == runs[0][case]["val_accs"]
    np.testing.assert_allclose(runs[0][case]["losses"], want["losses"],
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(runs[0][case]["val_accs"], want["val_accs"],
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(runs[0][case]["test_acc"], want["test_acc"],
                               rtol=LOSS_TOL, atol=LOSS_TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_end_with_the_same_parameters(train_runs, single, world):
    """The optimizer step is replicated: every rank's final parameters
    are the same bits, and within 1e-5 of the single process's."""
    runs = train_runs(world)
    for case in CASES:
        for r in runs[1:]:
            for a, b in zip(r[case]["params"], runs[0][case]["params"]):
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
        for a, b in zip(runs[0][case]["params"], single[case]["params"]):
            for k in a:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# (e) residency
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [1, 2, 4])
def test_each_rank_holds_its_own_rows(train_runs, world):
    g = _graph()
    n_pad = g.n + (-g.n) % world
    m = n_pad // world
    k = g.d_max
    for r in train_runs(world):
        res = r["residency"]
        assert res["ell"] == [(m, k), (m, k), (m,), (m, 16), (m,)]
        assert res["rev"] == [(m, n_pad)]            # rows m, table n_pad
        assert res["plan"] == [(m, k)]
        b = 30 + (-30) % world
        assert [s[0] for s in res["batch"]] == [b // world] * 4
        assert res["eval_ell"][3] == (m, 16)


# ---------------------------------------------------------------------------
# (g) kill and resume
# ---------------------------------------------------------------------------

def test_killed_and_resumed_ranks_repeat_the_uninterrupted_run(
        reference, tmp_path):
    params = reference["params_graphsage"]
    got = procs.spawn(_resume_ranks, 2, (params, str(tmp_path / "ck")),
                      timeout_s=JOIN_S, init_dir=str(tmp_path))
    for r in got:
        for kind in ("fg", "mb"):
            golden, resumed = r[kind]
            assert resumed["losses"] == golden["losses"], kind
            assert resumed["val_accs"] == golden["val_accs"], kind
            assert resumed["test_acc"] == golden["test_acc"], kind
            for a, b in zip(resumed["params"], golden["params"]):
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
    # rank 0 alone wrote the checkpoints
    for kind in ("fg", "mb"):
        files = os.listdir(tmp_path / "ck" / f"{kind}_golden")
        assert any(f.startswith("ckpt_") for f in files), files
