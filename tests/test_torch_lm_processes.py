"""The LM's tensor parallelism one process a shard
(``sharding.process_mesh``, ``launch.mesh.make_process_mesh``, the
per-axis subgroups of ``launch.procs``) on the CPU over gloo, held
against the single-controller ``Mesh`` of the same shape (one process
driving every shard) and against the live reference's single-device
functions on the same weights and batches:

(a) the subgroup collectives (all-gather, psum, psum-scatter over
    ``model`` and over ``data``) and their adjoints at ``(2, 2)`` against
    the single-controller mesh's; a value planted in one replica stays
    out of the other replica's ``model`` group; ranks that would make
    the subgroups in another order fail at once, and none hangs;
(b) stablelm-1.6b, llama4-scout (MoE: experts over ``model``) and
    mamba2-130m (SSD heads over ``model``), smoke configs in f32 with
    16 heads so ``param_specs`` splits them: ``forward_train``'s loss and
    gradients (after ``reduce_grads``, and whole again through the
    process mesh's ``unshard_params``), the global norm, ``prefill``'s
    logits of every row and each rank's cache, two decode steps and
    three AdamW steps of ``make_train_step`` (two micro-batches).  At
    ``(1, 2)`` over 2 ranks and at ``(2, 2)`` over 4 every number is
    bit-equal to the single-controller mesh's: each rank runs its
    shard's ops, and the gloo transport sums in rank order, as the
    single controller sums its shards (the four-way psums too).  Both
    within 1e-5 of the reference (loss, gradients, logits, decode
    steps);
(c) residency: each rank's parameter and AdamW leaves have the shapes
    ``shard`` gives its flat shard (a quarter of the elements of a leaf
    split over ``model`` and, FSDP, over ``data`` at ``(2, 2)``), the
    replicated leaves whole, and ``init_model(mesh=)`` draws the shard
    ``shard_params`` cuts from the whole tree;
(d) ``launch.train.main --model-par 2`` in 2 ranks with torchrun's
    environment: one JSON line, the one-process ``--model-par 2`` run's
    losses, and rank 0 alone writes a checkpoint equal to that run's.

Ranks run in processes of their own (``procs.spawn``), one intra-op
thread each, as the module itself runs; each mesh shape is one spawn.
"""
import dataclasses
import io
import json
import os
import socket
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
from torch.utils._pytree import keystr, tree_flatten, tree_flatten_with_path

from repro_torch import sharding as sh
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.device import TRACE_DEVICE
from repro_torch.launch import procs
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_process_mesh
from repro_torch.models import model as M
from repro_torch.models import steps as S
from repro_torch.optim import adamw

REF_TOL = 1e-5          # against the reference: loss, gradients, logits
JOIN_S = 240                        # a spawn's join: a hang fails the test
SHAPES = [(1, 2), (2, 2)]
IDS = ["d1m2", "d2m2"]

#: the configs of ``test_torch_tensor_parallel.py``: each sharded dim
#: divides MODEL_PAR = 16, so the weights really split
CFGS = {
    "dense": ("stablelm-1.6b", dict(n_heads=16, n_kv_heads=4, head_dim=16)),
    "moe": ("llama4-scout-17b-a16e", dict(n_heads=16, n_kv_heads=2,
                                          head_dim=16, n_experts=16)),
    "ssm": ("mamba2-130m", dict(d_model=256)),
}
B, S_TRAIN, S_PRE, CAP = 4, 32, 32, 36
#: ``launch.train``'s arguments of the launcher's runs (and --ckpt-dir)
LAUNCH = ["--arch", "stablelm-1.6b", "--smoke", "--device", "cpu",
          "--model-par", "2", "--steps", "3", "--ckpt-every", "2",
          "--log-every", "1"]


def _cfg(kind) -> ModelConfig:
    arch, kw = CFGS[kind]
    return dataclasses.replace(get_config(arch, smoke=True), **kw)


def _inputs(cfg):
    """(train batch, prefill tokens, the two decode tokens) as numpy, from
    a fixed seed."""
    rng = np.random.default_rng(30)
    toks = rng.integers(0, cfg.vocab_size, (B, S_TRAIN)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S_TRAIN)).astype(np.int32)
    labels[0, :5] = -1
    pre = rng.integers(0, cfg.vocab_size, (B, S_PRE + 2)).astype(np.int32)
    return ({"tokens": toks, "labels": labels}, pre[:, :S_PRE],
            [pre[:, i:i + 1] for i in (S_PRE, S_PRE + 1)])


def _t(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _leaves(tree):
    return [x.detach().numpy().copy() for x in tree_flatten(tree)[0]]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The module's own runs on one intra-op thread, as every rank: a CPU
    reduction's order follows the thread count, and bit-equality with
    the ranks needs the same."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


# ---------------------------------------------------------------------------
# what the model runs, on any mesh (module level: the ranks import it)
# ---------------------------------------------------------------------------

def _model_run(kind, weights, mesh):
    """Every number of (b) on ``mesh``, for its run shards: the loss, the
    reduced gradients of each shard, the whole gradients, the global
    norm, the prefill's logits and each shard's cache, two decode steps,
    three AdamW steps' losses and parameters, and each shard's parameter
    and AdamW leaf shapes."""
    cfg = _cfg(kind)
    tb, pre, dec = _inputs(cfg)
    whole = M.params_from_numpy(weights, "cpu")
    stored = M.shard_params(whole, cfg, mesh)
    del whole
    out = {}
    total, metrics = M.forward_train(M.gather_params(stored, cfg, mesh), cfg,
                                     _t(tb), mesh)
    out["loss"] = [float(total)] + [float(metrics[k]) for k in S.METRICS]
    grads, _ = S.accumulate_grads(stored, cfg, _t(tb), 1, mesh)
    grads = S.reduce_grads(grads, cfg, mesh)
    out["grads"] = [_leaves(g) for g in grads]
    out["grads_whole"] = _leaves(M.unshard_params(grads, cfg, mesh))
    out["norm"] = [float(n) for n in S.global_norms(grads, cfg, mesh)]
    ps = M.gather_params(stored, cfg, mesh)
    logits, caches = M.prefill(ps, cfg, {"tokens": torch.tensor(pre)}, CAP,
                               kernel=False, mesh=mesh)
    out["prefill"] = logits.numpy().copy()
    out["cache"] = [_leaves([r for r in c["runs"]]) for c in caches]
    serve = S.make_serve_step(cfg, mesh)
    out["decode"] = []
    for t in dec:
        lg, caches = serve(stored, caches, torch.tensor(t))
        out["decode"].append(lg.numpy().copy())
    opt, step = S.make_train_step(cfg, adamw(3e-3, weight_decay=0.1),
                                  microbatches=2, mesh=mesh)
    params, state = stored, [opt.init(p) for p in stored]
    out["train_losses"] = []
    for _ in range(3):
        params, state, m = step(params, state, _t(tb))
        out["train_losses"].append(float(m["loss"]))
    out["train_params"] = [_leaves(p) for p in params]
    out["shapes"] = [(_shapes(p), {k: _shapes(st[k]) for k in ("mu", "nu")})
                     for p, st in zip(params, state)]
    return out


def _shapes(tree):
    """Each leaf's shape by its path."""
    return {keystr(k): tuple(x.shape)
            for k, x in tree_flatten_with_path(tree)[0]}


#: the subgroup collectives' cases: (op, axis, dim)
COLLECTIVES = [(op, axis, dim) for op in ("all_gather", "psum",
                                          "psum_scatter")
               for axis in ("model", "data") for dim in (0, 1)]


def _collective_parts(flat, op, dim):
    """Shard ``flat``'s part and the cotangent of its result (2-member
    groups): [4, 6] f32 from a seed of the shard and the case."""
    rng = np.random.default_rng([flat, COLLECTIVES.index((op, "model", dim))])
    part = rng.normal(size=(4, 6)).astype(np.float32)
    oshape = [4, 6]
    if op == "all_gather":
        oshape[dim] *= 2
    elif op == "psum_scatter":
        oshape[dim] //= 2
    return torch.tensor(part), torch.tensor(
        rng.normal(size=oshape).astype(np.float32))


def _apply(op, parts, group, dim):
    if op == "all_gather":
        return sh.all_gather(parts, group, dim)
    if op == "psum":
        return sh.psum(parts, group)
    return sh.psum_scatter(parts, group, dim)


def _collective_run(mesh):
    """Each case's result and part gradient on this rank, and the
    planted-value psum over ``model``."""
    rank = mesh.traced[0]
    out = {}
    for op, axis, dim in COLLECTIVES:
        part, cot = _collective_parts(rank, op, dim)
        x = part.clone().requires_grad_()
        y = _apply(op, [x], mesh.group(axis, rank), dim)[0]
        (y * cot).sum().backward()
        out[(op, axis, dim)] = (y.detach().numpy(), x.grad.numpy())
    planted = torch.full((3,), 1e6 if mesh.coords(rank)["data"] == 0
                         else 1.0)
    out["planted"] = sh.psum([planted], mesh.group("model", rank))[0].numpy()
    return out


def _mesh_rank(rank, world, init, shape, **kw):
    """This rank's process mesh over gloo, one intra-op thread.  Every
    collective of more than 4 KiB a lane splits over the lanes (by
    default 1 MiB a lane), so the smoke shapes take the split path
    too."""
    torch.set_num_threads(1)
    procs.LANE_MIN_BYTES = 4096
    tr = procs.init(rank, world, init, device="cpu", **kw)
    return sh.process_mesh(shape, ("data", "model"), tr)


def _ranks(rank, world, init, shape, weights):
    """One rank of a mesh shape: the subgroups it made, the collectives
    (at ``(2, 2)``), the model runs of every kind."""
    mesh = _mesh_rank(rank, world, init, shape)
    out = {"pgs": sorted(mesh._pgs),
           "kinds": {k: _model_run(k, weights[k], mesh) for k in CFGS}}
    if shape == (2, 2):
        out["collectives"] = _collective_run(mesh)
    return out


def _misordered_ranks(rank, world, init):
    """Rank 3 would make the (2, 2) mesh's subgroups in reverse order."""
    if rank == 3:
        plan = sh.Mesh.pg_plan
        sh.Mesh.pg_plan = lambda self: plan(self)[::-1]
    mesh = _mesh_rank(rank, world, init, (2, 2), timeout_s=5)
    sh.psum([torch.ones(2)], mesh.group("model", rank))
    return "made"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_main(argv):
    """``launch.train.main(argv)``: (its stdout, ``train_lm``'s result)."""
    got = {}
    orig = launch_train.train_lm

    def keep(args, optimizer=None):
        got["result"] = orig(args, optimizer)
        return got["result"]
    launch_train.train_lm = keep
    buf = io.StringIO()
    try:
        with redirect_stdout(buf):
            assert launch_train.main(argv) == 0
    finally:
        launch_train.train_lm = orig
    return buf.getvalue(), got["result"]


def _torchrun_rank(rank, world, init, port, argv):
    """``launch.train.main(argv)`` under torchrun's environment: its
    stdout, its result and the checkpoint steps this rank wrote."""
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    from repro_torch import checkpoint
    wrote = []
    save = checkpoint.save_checkpoint

    def counted(directory, step, *a, **kw):
        wrote.append(step)
        return save(directory, step, *a, **kw)
    checkpoint.save_checkpoint = counted
    text, result = _run_main(argv)
    return text, result, wrote


# ---------------------------------------------------------------------------
# runs shared by the tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_models():
    """kind -> (the reference's config, its ``init_model`` tree)."""
    jax = pytest.importorskip("jax")
    from repro.configs.base import get_config as ref_get_config
    from repro.models import model as RM
    out = {}
    for kind, (arch, kw) in CFGS.items():
        rcfg = dataclasses.replace(ref_get_config(arch, smoke=True), **kw)
        assert dataclasses.asdict(rcfg) == dataclasses.asdict(_cfg(kind))
        out[kind] = rcfg, RM.init_model(jax.random.key(0), rcfg)
    return out


@pytest.fixture(scope="module")
def spawned(reference_models, tmp_path_factory):
    """The module's spawns, started together in the background as soon as
    the reference's weights exist (the reference's runs and the
    single-controller runs go on meanwhile): each mesh shape's ranks
    (``_ranks``) and the launcher's two ranks under torchrun's
    environment (``_torchrun_rank``), as futures; and the weights as
    numpy (``params_from_numpy`` makes the port's tree of them)."""
    import jax
    weights = {k: jax.tree.map(np.asarray, rp)
               for k, (_, rp) in reference_models.items()}
    root = tmp_path_factory.mktemp("launch")
    pool = ThreadPoolExecutor(len(SHAPES) + 1)
    futures = {shape: pool.submit(
        procs.spawn, _ranks, shape[0] * shape[1], (shape, weights),
        timeout_s=JOIN_S, init_dir=str(tmp_path_factory.mktemp("pg")))
        for shape in SHAPES}
    futures["torchrun"] = pool.submit(
        procs.spawn, _torchrun_rank, 2,
        (_free_port(), LAUNCH + ["--ckpt-dir", str(root / "ranks")]),
        timeout_s=JOIN_S, init_dir=str(root))
    yield futures, weights, root
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def models(reference_models, spawned):
    """kind -> the reference's jitted results: the forward's total and
    metrics, jax.grad's gradients as port leaves, the prefill's logits,
    two decode steps' logits."""
    import jax
    import jax.numpy as jnp
    from repro.models import model as RM
    out = {}
    for kind, (rcfg, rp) in reference_models.items():
        tb, pre, dec = _inputs(_cfg(kind))
        jb = {k: jnp.asarray(v) for k, v in tb.items()}
        total, metrics = jax.jit(lambda q, b: RM.forward_train(q, rcfg, b))(
            rp, jb)
        grads = jax.jit(jax.grad(lambda q: RM.forward_train(q, rcfg, jb)[0]))(
            rp)
        lg, wc = RM.prefill(rp, rcfg, {"tokens": jnp.asarray(pre)},
                            max_len=CAP)
        steps = []
        for t in dec:
            d, wc = RM.decode_step(rp, rcfg, wc, jnp.asarray(t))
            steps.append(np.asarray(d))
        out[kind] = {
            "loss": [float(total)] + [float(metrics[k]) for k in S.METRICS],
            "grads": _leaves(M.params_from_numpy(
                jax.tree.map(np.asarray, grads), "cpu")),
            "prefill": np.asarray(lg), "decode": steps}
    return out


@pytest.fixture(scope="module")
def runs(spawned, models):
    """shape -> (every rank's ``_ranks``, the single-controller mesh's
    ``_model_run`` of every kind).  After the reference's runs: they
    and these go on while the ranks run."""
    futures, weights, _ = spawned
    cache = {}

    def get(shape):
        if shape not in cache:
            one = sh.Mesh(shape, ("data", "model"),
                          ("cpu",) * (shape[0] * shape[1]))
            mine = {k: _model_run(k, weights[k], one) for k in CFGS}
            cache[shape] = futures[shape].result(), mine
        return cache[shape]
    return get


def _equal(got, want, what):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


# ---------------------------------------------------------------------------
# (a) the subgroups and their collectives
# ---------------------------------------------------------------------------

def test_process_mesh_plans_its_subgroups_in_one_order():
    """The groups each mesh shape makes: none at (1, 2) and (2, 1) (a
    group of two ranks is the world's), the two ``data`` then the two
    ``model`` groups at (2, 2); at (2, 2, 2) the groups of each single
    axis, then of each pair of axes, none twice."""
    def plan(shape, names=("data", "model")):
        return sh.Mesh(shape, names, ("cpu",) * int(np.prod(shape))
                       ).pg_plan()
    assert plan((1, 2)) == [] and plan((2, 1)) == []
    assert plan((2, 2)) == [(0, 2), (1, 3), (0, 1), (2, 3)]
    pod = plan((2, 2, 2), ("pod", "data", "model"))
    assert pod[:4] == [(0, 4), (1, 5), (2, 6), (3, 7)]     # pod
    assert (0, 1, 2, 3) in pod and (0, 2, 4, 6) in pod     # pod x data
    assert len(pod) == len(set(pod)) == 4 * 3 + 2 * 3


@pytest.mark.parametrize("op,axis,dim", COLLECTIVES)
def test_subgroup_collectives_match_the_single_controller_mesh(runs, op,
                                                               axis, dim):
    got, _ = runs((2, 2))
    mesh = sh.Mesh((2, 2), ("data", "model"), ("cpu",) * 4)
    for g in mesh.groups(axis):
        xs, cots = zip(*(_collective_parts(f, op, dim) for f in g.members))
        xs = [x.clone().requires_grad_() for x in xs]
        ys = _apply(op, xs, g, dim)
        sum((y * c).sum() for y, c in zip(ys, cots)).backward()
        for f, y, x in zip(g.members, ys, xs):
            y_r, g_r = got[f]["collectives"][(op, axis, dim)]
            _equal(y_r, y.detach(), f"{op} over {axis}, rank {f}")
            _equal(g_r, x.grad, f"{op}'s adjoint over {axis}, rank {f}")


def test_a_planted_value_stays_in_its_replica(runs):
    """psum over ``model``: ranks 0 and 1 (data 0) hold 1e6, ranks 2 and 3
    (data 1) hold 1: the second replica's sum is 2."""
    got, _ = runs((2, 2))
    assert [r["pgs"] for r in got] == [[(0, 1), (0, 2), (1, 3), (2, 3)]] * 4
    for r, want in zip(got, (2e6, 2e6, 2.0, 2.0)):
        _equal(r["collectives"]["planted"], np.full(3, want, np.float32),
               "planted")


def test_subgroups_made_out_of_order_fail_at_once(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(procs.RankError, match="plans differ"):
        procs.spawn(_misordered_ranks, 4, timeout_s=JOIN_S,
                    init_dir=str(tmp_path))
    assert time.monotonic() - t0 < JOIN_S / 2


# ---------------------------------------------------------------------------
# (b) the model against the single-controller mesh and the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(CFGS))
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_forward_and_gradients_match_one_process(runs, shape, kind):
    got, one = runs(shape)
    want = one[kind]
    for r, rk in enumerate(got):
        mine = rk["kinds"][kind]
        _equal(mine["loss"], want["loss"], f"{kind} loss, rank {r}")
        for i, (a, b) in enumerate(zip(mine["grads"][0], want["grads"][r])):
            _equal(a, b, f"{kind} reduced gradient leaf {i}, rank {r}")
        for i, (a, b) in enumerate(zip(mine["grads_whole"],
                                       want["grads_whole"])):
            _equal(a, b, f"{kind} whole gradient leaf {i}, rank {r}")
        _equal(mine["norm"], want["norm"][r:r + 1], f"{kind} norm, rank {r}")


@pytest.mark.parametrize("kind", list(CFGS))
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_prefill_cache_and_decode_match_one_process(runs, shape, kind):
    """Every row's logits on every rank, each rank's cache (its heads)
    against the single-controller mesh's shard of the same flat id, two
    decode steps."""
    got, one = runs(shape)
    want = one[kind]
    for r, rk in enumerate(got):
        mine = rk["kinds"][kind]
        _equal(mine["prefill"], want["prefill"], f"{kind} prefill, rank {r}")
        assert len(mine["cache"]) == 1
        for i, (a, b) in enumerate(zip(mine["cache"][0], want["cache"][r])):
            assert a.shape == b.shape
            _equal(a, b, f"{kind} cache leaf {i}, rank {r}")
        for i, (a, b) in enumerate(zip(mine["decode"], want["decode"])):
            _equal(a, b, f"{kind} decode step {i}, rank {r}")


@pytest.mark.parametrize("kind", list(CFGS))
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_three_adamw_steps_match_one_process(runs, shape, kind):
    got, one = runs(shape)
    want = one[kind]
    for r, rk in enumerate(got):
        mine = rk["kinds"][kind]
        _equal(mine["train_losses"], want["train_losses"],
             f"{kind} losses, rank {r}")
        for i, (a, b) in enumerate(zip(mine["train_params"][0],
                                       want["train_params"][r])):
            _equal(a, b, f"{kind} parameter leaf {i} after 3 steps, rank {r}")


@pytest.mark.parametrize("kind", list(CFGS))
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_ranks_match_the_reference(runs, models, shape, kind):
    """Rank 0's loss and metrics, gradients (whole again), every row's
    prefill logits and the two decode steps against the reference's
    single-device functions."""
    got, _ = runs(shape)
    want = models[kind]
    mine = got[0]["kinds"][kind]
    np.testing.assert_allclose(mine["loss"], want["loss"], rtol=REF_TOL,
                               atol=REF_TOL)
    assert len(mine["grads_whole"]) == len(want["grads"])
    for a, b in zip(mine["grads_whole"], want["grads"]):
        np.testing.assert_allclose(a, b, rtol=REF_TOL, atol=REF_TOL)
    np.testing.assert_allclose(mine["prefill"], want["prefill"],
                               rtol=REF_TOL, atol=REF_TOL)
    for a, b in zip(mine["decode"], want["decode"]):
        np.testing.assert_allclose(a, b, rtol=REF_TOL, atol=REF_TOL)


# ---------------------------------------------------------------------------
# (c) residency
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(CFGS))
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_each_rank_holds_only_its_shard(runs, shape, kind):
    """Each rank's parameters and AdamW moments after three steps have
    the shapes ``shard`` gives its flat shard of the whole leaf: a
    quarter of a leaf split over both axes at (2, 2), half of one split
    over one, the replicated leaves whole."""
    got, _ = runs(shape)
    cfg = _cfg(kind)
    whole = M.init_model(torch.Generator().manual_seed(0), cfg,
                         TRACE_DEVICE)
    mesh = sh.Mesh(shape, ("data", "model"), ("meta",) * len(got))
    split = {}
    for r, rk in enumerate(got):
        params, moments = rk["kinds"][kind]["shapes"][0]
        want = {}
        for (k, x), sp in zip(tree_flatten_with_path(whole)[0],
                              M.spec_leaves(whole, cfg)):
            want[keystr(k)] = tuple(sh.shard(x, sp, mesh)[r].shape)
            n = int(np.prod(want[keystr(k)]))
            split[keystr(k)] = (x.numel() // n, sh.spec_axes(sp, mesh))
        assert params == want
        assert moments == {"mu": want, "nu": want}
    for k, (parts, axes) in split.items():
        assert parts == int(np.prod([mesh.sizes[a] for a in axes])), k
    if shape == (2, 2):
        assert any(p == 4 for p, _ in split.values())
    assert any(p == 1 for p, _ in split.values())


def test_init_model_on_a_mesh_draws_the_shards_of_the_whole():
    for kind in CFGS:
        cfg = _cfg(kind)
        mesh = sh.Mesh((2, 2), ("data", "model"), ("cpu",) * 4)
        want = M.shard_params(M.init_model(torch.Generator().manual_seed(4),
                                           cfg, "cpu"), cfg, mesh)
        got = M.init_model(torch.Generator().manual_seed(4), cfg, "cpu",
                           mesh=mesh)
        for a, b in zip(got, want):
            assert tree_flatten(a)[1] == tree_flatten(b)[1]
            for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]):
                assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# (d) launch/train.py under torchrun
# ---------------------------------------------------------------------------

def test_launch_train_under_torchrun_is_one_tensor_parallel_run(spawned):
    """2 ranks, --model-par 2: one JSON line, the one-process --model-par
    2 run's losses on every rank, and rank 0 alone writes a checkpoint
    (step 2) whose arrays equal that run's."""
    futures, _, root = spawned
    ranks = futures["torchrun"].result()
    lines = [ln for text, _, _ in ranks for ln in text.splitlines()]
    printed = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert len(printed) == 1 and ranks[1][0] == ""
    assert [w for _, _, w in ranks] == [[2], []]
    text, one = _run_main(LAUNCH + ["--ckpt-dir", str(root / "one")])
    assert printed[0] == json.loads(text.splitlines()[-1])
    for _, result, _ in ranks:
        assert result["losses"] == one["losses"] and len(one["losses"]) == 3
    assert sorted(os.listdir(root / "ranks")) == sorted(
        os.listdir(root / "one"))
    got = np.load(root / "ranks" / "ckpt_00000002.npz")
    want = np.load(root / "one" / "ckpt_00000002.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        _equal(got[k], want[k], k)


def test_make_process_mesh_needs_model_par_to_divide_the_ranks():
    class _Tr:
        world, rank, device = 4, 0, torch.device("cpu")
    with pytest.raises(ValueError, match="divide"):
        make_process_mesh(3, _Tr())
