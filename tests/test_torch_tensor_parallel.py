"""Tensor parallelism of the port (``sharding.Mesh``, the ``tp`` paths of
``models/{layers,moe,ssm,model,steps}.py``, ``launch/train.py
--model-par``) against the live reference's single-device functions on
the same numpy inputs, and against the port at M = 1.

Each case runs on meshes of CPU shards: ``model`` M in {1, 2, 4} and one
``(data 2, model 2)`` mesh, with configs small enough for the CPU whose
sharded dims divide 16 (``MODEL_PAR``), so ``param_specs`` really splits
them: 16 query heads over 4 (dense) or 2 (MoE) replicated KV heads, 16
experts, 16 SSD heads, ``d_ff`` 256 and a 512-token vocab.  Each test
asserts that the weights it names were split.  Tolerances: 1e-5 for the
f32 forward, 1e-3 for gradients (``tests/test_kernels.py``'s)."""
import dataclasses
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as ref_get_config  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import moe as RMOE  # noqa: E402
from repro.models import ssm as RSSM  # noqa: E402

from repro_torch import sharding as sh  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models import steps as S  # noqa: E402

F32_TOL, GRAD_TOL = 1e-5, 1e-3
MESHES = [(1, 1), (1, 2), (1, 4), (2, 2)]
IDS = ["m1", "m2", "m4", "d2m2"]

#: the configs: each sharded dim divides MODEL_PAR = 16
CFGS = {
    "dense": ("stablelm-1.6b", dict(n_heads=16, n_kv_heads=4, head_dim=16)),
    "moe": ("llama4-scout-17b-a16e", dict(n_heads=16, n_kv_heads=2,
                                          head_dim=16, n_experts=16)),
    "ssm": ("mamba2-130m", dict(d_model=256)),
}


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


_MODELS = {}
_REFS = {}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny tensors on many shards: one intra-op thread is faster, and
    leaves the CPU to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref(key, fn):
    """``fn()``'s value (a reference computation), once for every mesh of
    a test."""
    if key not in _REFS:
        _REFS[key] = fn()
    return _REFS[key]


def _model(kind):
    """(port cfg, reference cfg, port params, reference params): the
    reference's initial weights carried over."""
    if kind not in _MODELS:
        arch, kw = CFGS[kind]
        rcfg = dataclasses.replace(ref_get_config(arch, smoke=True), **kw)
        cfg = ModelConfig(**dataclasses.asdict(rcfg))
        rp = RM.init_model(jax.random.key(0), rcfg)
        _MODELS[kind] = (cfg, rcfg, M.params_from_numpy(
            jax.tree.map(np.asarray, rp), "cpu"), rp)
    return _MODELS[kind]


def _mesh(shape):
    return sh.Mesh(shape, ("data", "model"),
                   ("cpu",) * (shape[0] * shape[1]))


def _shards(kind, shape):
    """(cfg, rcfg, full port params, reference params, mesh, per-shard
    params with the FSDP dims gathered)."""
    cfg, rcfg, p, rp = _model(kind)
    mesh = _mesh(shape)
    return cfg, rcfg, p, rp, mesh, M.gather_params(
        M.shard_params(p, cfg, mesh), cfg, mesh)


def _layer0(ps, tp, idx, key):
    return [M._layer(ps[i]["runs"][0], 0)[key] for i in idx]


def _stream(x, tp, rs):
    """A whole [B, S, d] tensor as the stream's parts."""
    if not rs:
        return [x.clone() for _ in tp.devices]
    m = x.shape[1] // tp.size
    return [x[:, p * m:(p + 1) * m].clone() for p in tp.positions]


def _whole(parts, tp, rs):
    return torch.cat(parts, 1) if rs else parts[0]


def _x(seed, b, s, d):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(
        np.float32)


def _split_weights(local, full, m):
    """``local`` holds 1/m of ``full``'s elements."""
    assert local.numel() * m == full.numel(), (local.shape, full.shape)


# ---------------------------------------------------------------------------
# the mesh, shard / unshard and the collectives over a Group
# ---------------------------------------------------------------------------

def test_shard_unshard_roundtrip_by_spec():
    mesh = _mesh((2, 2))
    x = torch.arange(32 * 8, dtype=torch.float32).reshape(32, 8)
    parts = sh.shard(x, (sh.FSDP, sh.MODEL), mesh)
    assert [tuple(p.shape) for p in parts] == [(16, 4)] * 4
    assert torch.equal(parts[3], x[16:, 4:])
    assert torch.equal(sh.unshard(parts, (sh.FSDP, sh.MODEL), mesh), x)
    with pytest.raises(ValueError, match="does not divide"):
        sh.shard(torch.zeros(3, 8), (sh.MODEL, None), mesh)


def test_axis_map_resolves_as_the_reference():
    two = sh.layout_mesh((16, 16), ("data", "model"))
    pod = sh.layout_mesh((2, 16, 16), ("pod", "data", "model"))
    assert sh.resolve((sh.BATCH, sh.MODEL, sh.FSDP, None), two) == (
        "data", "model", "data", None)
    assert sh.resolve((sh.BATCH, sh.ALL, sh.NODES), pod) == (
        ("pod", "data"), ("pod", "data", "model"), ("pod", "data"))
    assert sh.batch_mesh_axes(pod) == ("pod", "data")
    assert pod.traced == (0,) and pod.size == 512
    g = pod.group(("model", "pod"), 0)
    assert (g.axes, g.size, g.members, g.virtual) == (("pod", "model"), 32,
                                                       (0,), True)
    with pytest.raises(ValueError, match="not all in"):
        two.group("pod", 0)


@pytest.mark.parametrize("kind", ["all_gather", "psum", "psum_scatter"])
def test_group_collectives_and_their_backward(kind):
    """Values as the NODES collectives give them, each shard its own
    tensor, the backward the adjoint collective, the bytes noted by the
    ring model."""
    mesh = _mesh((1, 4))
    g = mesh.group("model", 0)
    rng = np.random.default_rng(3)
    parts = [torch.tensor(rng.normal(size=(8, 4)), dtype=torch.float32,
                          requires_grad=True) for _ in range(4)]
    fn = getattr(sh, kind)
    want = fn([p.detach() for p in parts], sh.node_mesh(
        devices=("cpu",) * 4))
    sh.reset_collectives()
    out = fn(parts, g) if kind == "psum" else fn(parts, g, dim=0)
    for o, w in zip(out, want):
        assert torch.equal(o, w)
    assert len({id(o) for o in out}) == 4
    counts = sh.collective_counts()
    nbytes = 8 * 4 * 4
    assert counts == {"all_gather": {"all-gather": 4 * nbytes},
                      "psum": {"all-reduce": 2 * nbytes},
                      "psum_scatter": {"reduce-scatter": nbytes}}[kind] | {
        "calls": 1}
    cot = [torch.tensor(rng.normal(size=o.shape), dtype=torch.float32)
           for o in out]
    grads = torch.autograd.grad(out, parts, cot)
    total = sum(cot)
    for s, gr in enumerate(grads):
        if kind == "all_gather":
            _close(gr, total[8 * s:8 * s + 8], 1e-6)
        elif kind == "psum":
            _close(gr, total, 1e-6)
        else:
            _close(gr, torch.cat(cot, 0), 1e-6)


def test_layout_mesh_collectives_give_shapes_and_bytes():
    mesh = sh.layout_mesh((2, 16, 16), ("pod", "data", "model"))
    g = mesh.group("model", 0)
    x = torch.empty(2, 32, 8, device="meta")
    sh.reset_collectives()
    assert sh.all_gather([x], g, dim=1)[0].shape == (2, 512, 8)
    assert sh.psum_scatter([x], g, dim=1)[0].shape == (2, 2, 8)
    assert sh.psum([x], mesh.group(("pod", "data"), 0))[0].shape == x.shape
    n = 2 * 32 * 8 * 4
    assert sh.collective_counts() == {"all-gather": 16 * n,
                                      "reduce-scatter": n,
                                      "all-reduce": 2 * n, "calls": 3}


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_qkv_matches_reference(shape):
    cfg, rcfg, p, rp, mesh, ps = _shards("dense", shape)
    tp, idx = M.replicas(mesh)[0]
    m = tp.size
    attn = _layer0(ps, tp, idx, "attn")
    _split_weights(attn[0]["wq"], p["runs"][0]["attn"]["wq"][0], m)
    assert attn[0]["wk"].shape[1] == cfg.n_kv_heads      # replicated
    x = _x(1, 2, 32, cfg.d_model)
    pos = np.arange(32)
    rs = L.tp_rs(tp, 32)
    sh.reset_collectives()
    q, k, v = L.qkv(attn, _stream(torch.tensor(x), tp, rs), cfg,
                    torch.tensor(pos), True, tp=tp, rs=rs)
    assert bool(sh.collective_counts()) == (m > 1)
    rq, rk, rv = _ref("qkv", lambda: RL.qkv(
        jax.tree.map(lambda t: t[0], rp["runs"][0]["attn"]), jnp.asarray(x),
        rcfg, jnp.asarray(pos), True))
    hq = 16 // m
    for j, s in enumerate(tp.positions):
        _close(q[j], np.asarray(rq)[:, :, s * hq:(s + 1) * hq], F32_TOL)
        sel = L.kv_heads(hq, 16, cfg.n_kv_heads, s)
        sel = slice(None) if sel is None else sel
        _close(k[j], np.asarray(rk)[:, :, sel], F32_TOL)
        _close(v[j], np.asarray(rv)[:, :, sel], F32_TOL)
    q1, _, _ = L.qkv(M._layer(p["runs"][0], 0)["attn"], torch.tensor(x), cfg,
                     torch.tensor(pos), True)
    _close(torch.cat(q, 2) if m > 1 else q[0], q1, F32_TOL)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_out_proj_matches_reference(shape):
    cfg, rcfg, p, rp, mesh, ps = _shards("dense", shape)
    tp, idx = M.replicas(mesh)[0]
    attn = _layer0(ps, tp, idx, "attn")
    _split_weights(attn[0]["wo"], p["runs"][0]["attn"]["wo"][0], tp.size)
    o = np.random.default_rng(2).normal(size=(2, 32, 16, 16)).astype(
        np.float32)
    hq = 16 // tp.size
    rs = L.tp_rs(tp, 32)
    got = L.out_proj(attn, [torch.tensor(o[:, :, s * hq:(s + 1) * hq])
                            for s in tp.positions], torch.float32, tp=tp,
                     rs=rs, cfg=cfg)
    assert rs == (tp.size > 1)
    want = _ref("out_proj", lambda: RL.out_proj(
        jax.tree.map(lambda t: t[0], rp["runs"][0]["attn"]), jnp.asarray(o),
        jnp.float32))
    _close(_whole(got, tp, rs), want, F32_TOL)
    _close(_whole(got, tp, rs), L.out_proj(M._layer(p["runs"][0], 0)["attn"],
                                           torch.tensor(o), torch.float32),
           F32_TOL)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_attention_block_flash_per_shard_matches_reference(shape):
    """The prefill attention with the flash op (its plain version on the
    CPU) on each shard's heads, against the reference's chunked block."""
    cfg, rcfg, p, rp, mesh, ps = _shards("dense", shape)
    tp, idx = M.replicas(mesh)[0]
    x = _x(4, 2, 32, cfg.d_model)
    rs = L.tp_rs(tp, 32)
    got, (k, _) = L.attention_block(_layer0(ps, tp, idx, "attn"),
                                    _stream(torch.tensor(x), tp, rs), cfg,
                                    "attn", torch.arange(32), tp=tp, rs=rs)
    assert k[0].shape[2] == max(1, cfg.n_kv_heads // tp.size)
    want, _ = _ref("attention_block", lambda: RL.attention_block(
        jax.tree.map(lambda t: t[0], rp["runs"][0]["attn"]), jnp.asarray(x),
        rcfg, "attn", jnp.arange(32)))
    _close(_whole(got, tp, rs), want, F32_TOL)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_mlp_block_matches_reference(shape):
    cfg, rcfg, p, rp, mesh, ps = _shards("dense", shape)
    tp, idx = M.replicas(mesh)[0]
    mlp = _layer0(ps, tp, idx, "mlp")
    for w in ("w_gate", "w_up", "w_down"):
        _split_weights(mlp[0][w], p["runs"][0]["mlp"][w][0], tp.size)
    x = _x(5, 2, 32, cfg.d_model)
    rs = L.tp_rs(tp, 32)
    got = L.mlp_block(mlp, _stream(torch.tensor(x), tp, rs), cfg, tp=tp,
                      rs=rs)
    want = _ref("mlp", lambda: RL.mlp_block(
        jax.tree.map(lambda t: t[0], rp["runs"][0]["mlp"]), jnp.asarray(x),
        rcfg))
    _close(_whole(got, tp, rs), want, F32_TOL)
    _close(_whole(got, tp, rs), L.mlp_block(M._layer(p["runs"][0], 0)["mlp"],
                                            torch.tensor(x), cfg), F32_TOL)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_moe_block_matches_reference(shape):
    """Experts over ``model`` (16 / M a shard), the combine
    reduce-scattered onto the routing groups: output and aux."""
    cfg, rcfg, p, rp, mesh, ps = _shards("moe", shape)
    tp, idx = M.replicas(mesh)[0]
    moe = _layer0(ps, tp, idx, "moe")
    assert moe[0]["w_gate"].shape[0] == 16 // tp.size
    assert moe[0]["router"].shape == (cfg.d_model, 16)
    x = _x(6, 2, 128, cfg.d_model)
    rs = L.tp_rs(tp, 128)
    got, aux = MOE.moe_block(moe, _stream(torch.tensor(x), tp, rs), cfg,
                             tp=tp, rs=rs)
    want, raux = _ref("moe", lambda: RMOE.moe_block(
        jax.tree.map(lambda t: t[0], rp["runs"][0]["moe"]), jnp.asarray(x),
        rcfg))
    _close(_whole(got, tp, rs), want, F32_TOL)
    for a in aux:
        _close(a, raux, F32_TOL)
    one, _ = MOE.moe_block(M._layer(p["runs"][0], 0)["moe"], torch.tensor(x),
                           cfg)
    _close(_whole(got, tp, rs), one, F32_TOL)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_mamba_block_matches_reference(shape):
    """The SSD heads over ``model`` (16 / M a shard; B/C all-gathered,
    the gated norm's sum of squares summed): output and final states."""
    cfg, rcfg, p, rp, mesh, ps = _shards("ssm", shape)
    tp, idx = M.replicas(mesh)[0]
    mb = _layer0(ps, tp, idx, "mamba")
    assert SSM.ssm_dims(cfg)[1] == 16
    assert mb[0]["A_log"].shape == (16 // tp.size,)
    _split_weights(mb[0]["w_bc"], p["runs"][0]["mamba"]["w_bc"][0], tp.size)
    x = _x(7, 2, 64, cfg.d_model)
    rs = L.tp_rs(tp, 64)
    got, (st, cx, _) = SSM.mamba_block(mb, _stream(torch.tensor(x), tp, rs),
                                       cfg, tp=tp, rs=rs)
    want, (rst, rcx, _) = _ref("mamba", lambda: jax.jit(
        lambda q, xx: RSSM.mamba_block(q, xx, rcfg))(
        jax.tree.map(lambda t: t[0], rp["runs"][0]["mamba"]),
        jnp.asarray(x)))
    _close(_whole(got, tp, rs), want, F32_TOL)
    _close(torch.cat(st, 1) if tp.size > 1 else st[0], rst, F32_TOL)
    _close(torch.cat(cx, -1) if tp.size > 1 else cx[0], rcx, F32_TOL)


# ---------------------------------------------------------------------------
# the model and its steps
# ---------------------------------------------------------------------------

def _batch(cfg, b=4, s=64, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[0, :5] = -1
    return ({"tokens": torch.tensor(toks), "labels": torch.tensor(labels)},
            {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})


@pytest.mark.parametrize("kind", ["dense", "moe"])
@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_forward_train_matches_reference(shape, kind):
    cfg, rcfg, p, rp, mesh, ps = _shards(kind, shape)
    _split_weights(ps[0]["embed"], p["embed"], mesh.sizes["model"])
    tb, jb = _batch(cfg)
    sh.reset_collectives()
    total, m = M.forward_train(ps, cfg, tb, mesh)
    rtotal, rm = _ref(("forward", kind), lambda: jax.jit(
        lambda q, b: RM.forward_train(q, rcfg, b))(rp, jb))
    for got, want in ((total, rtotal), (m["loss"], rm["loss"]),
                      (m["aux"], rm["aux"]), (m["acc"], rm["acc"])):
        _close(float(got), float(want), F32_TOL)
    one, _ = M.forward_train(p, cfg, tb)
    _close(float(total), float(one), F32_TOL)
    assert bool(sh.collective_counts()) == (mesh.size > 1)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_gradients_match_jax_grad(shape):
    """Each shard's gradients after ``reduce_grads`` (FSDP's
    reduce-scatter, the psums over the replicated axes), whole again,
    against ``jax.grad``; and the global norm against the whole tree's."""
    cfg, rcfg, p, rp, mesh, _ = _shards("dense", shape)
    stored = M.shard_params(p, cfg, mesh)
    assert stored[0]["runs"][0]["attn"]["wq"].shape[1:3] == (
        cfg.d_model // mesh.sizes["data"], 16 // mesh.sizes["model"])
    tb, jb = _batch(cfg)
    grads, _ = S.accumulate_grads(stored, cfg, tb, 1, mesh)
    grads = S.reduce_grads(grads, cfg, mesh)
    whole = M.unshard_params(grads, cfg, mesh)
    rg = _ref("grad", lambda: jax.jit(jax.grad(
        lambda q: RM.forward_train(q, rcfg, jb)[0]))(rp))
    got, spec = tree_flatten(whole)
    want = tree_flatten(M.params_from_numpy(jax.tree.map(np.asarray, rg),
                                            "cpu"))[0]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, GRAD_TOL)
    gn = S.global_norms(grads, cfg, mesh)
    full = torch.sqrt(sum(torch.sum(torch.square(g)) for g in got))
    for n in gn:
        _close(n, full, GRAD_TOL)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_prefill_matches_reference(shape):
    """The prefill's last logits, each shard's head-sharded KV cache
    against the reference's cache heads; then two decode steps
    (``test_two_decode_steps_match_reference``)."""
    cfg, rcfg, p, rp, mesh, ps = _shards("dense", shape)
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (4, 32))
    want, wcache = _ref("prefill", lambda: RM.prefill(
        rp, rcfg, {"tokens": jnp.asarray(toks)}, max_len=36))
    got, caches = M.prefill(ps, cfg, {"tokens": torch.tensor(toks)}, 36,
                            kernel=False, mesh=mesh)
    _close(got, want, F32_TOL)
    flash, _ = M.prefill(ps, cfg, {"tokens": torch.tensor(toks)}, 36,
                         mesh=mesh)
    _close(flash, want, 1e-4)
    assert len(caches) == mesh.size
    for (tp, idx), rows in zip(M.replicas(mesh), np.split(
            np.asarray(wcache["runs"][0]["k"]), mesh.sizes["data"], 1)):
        for i, pos in zip(idx, tp.positions):
            sel = L.kv_heads(16 // tp.size, 16, cfg.n_kv_heads, pos)
            sel = slice(None) if sel is None else sel
            assert caches[i]["runs"][0]["k"].shape[3] == \
                rows[:, :, :, sel].shape[3]
            _close(caches[i]["runs"][0]["k"], rows[:, :, :, sel], F32_TOL)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_two_decode_steps_match_reference(shape):
    cfg, rcfg, p, rp, mesh, ps = _shards("dense", shape)
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (4, 34))
    def ref():
        _, wc = RM.prefill(rp, rcfg, {"tokens": jnp.asarray(toks[:, :32])},
                           max_len=36)
        out = []
        for i in (32, 33):
            lg, wc = RM.decode_step(rp, rcfg, wc, jnp.asarray(
                toks[:, i:i + 1].astype(np.int32)))
            out.append(lg)
        return out
    wants = _ref("decode", ref)
    _, caches = M.prefill(ps, cfg, {"tokens": torch.tensor(toks[:, :32])},
                          36, kernel=False, mesh=mesh)
    _, one = M.prefill(p, cfg, {"tokens": torch.tensor(toks[:, :32])}, 36,
                       kernel=False)
    serve = S.make_serve_step(cfg, mesh)
    for i, want in zip((32, 33), wants):
        t = toks[:, i:i + 1].astype(np.int32)
        got, caches = serve(M.shard_params(p, cfg, mesh), caches,
                            torch.tensor(t))
        _close(got, want, F32_TOL)
        lone, one = M.decode_step(p, cfg, one, torch.tensor(t))
        _close(got, lone, F32_TOL)
    assert all(c["pos"] == 34 for c in caches)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_moe_and_ssm_prefill_decode_match_reference(shape):
    """The MoE family (NoPE global layers, a sliding window) and the SSM
    family through prefill and one decode step."""
    for kind in ("moe", "ssm"):
        cfg, rcfg, p, rp, mesh, ps = _shards(kind, shape)
        toks = np.random.default_rng(10).integers(0, cfg.vocab_size, (2, 33))
        t = toks[:, 32:].astype(np.int32)

        def ref():
            lg, wc = RM.prefill(rp, rcfg, {"tokens": jnp.asarray(
                toks[:, :32])}, max_len=40)
            return lg, RM.decode_step(rp, rcfg, wc, jnp.asarray(t))[0]
        want, want_dec = _ref(("serve", kind), ref)
        got, caches = M.prefill(ps, cfg, {"tokens": torch.tensor(
            toks[:, :32])}, 40, kernel=False, mesh=mesh)
        _close(got, want, F32_TOL)
        want = want_dec
        got, _ = M.decode_step(ps, cfg, caches, torch.tensor(t), mesh)
        _close(got, want, F32_TOL)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_train_steps_match_the_port_at_m1(shape):
    """Three AdamW steps (clipped by the norm over every shard, two
    micro-batches) against the unsharded step: losses 1e-5, parameters
    1e-3."""
    from repro_torch.optim import adamw
    cfg, _, p, _, mesh, _ = _shards("dense", shape)
    tb, _ = _batch(cfg)
    opt, step = S.make_train_step(cfg, adamw(3e-3, weight_decay=0.1),
                                  microbatches=2)
    st, want = opt.init(p), p
    opt_m, step_m = S.make_train_step(cfg, adamw(3e-3, weight_decay=0.1),
                                      microbatches=2, mesh=mesh)
    got = M.shard_params(p, cfg, mesh)
    stm = [opt_m.init(x) for x in got]
    for _ in range(3):
        want, st, wm = step(want, st, tb)
        got, stm, gm = step_m(got, stm, tb)
        _close(float(gm["loss"]), float(wm["loss"]), F32_TOL)
    for g, w in zip(tree_flatten(M.unshard_params(got, cfg, mesh))[0],
                    tree_flatten(want)[0]):
        _close(g, w, GRAD_TOL)


# ---------------------------------------------------------------------------
# launch/train.py --model-par
# ---------------------------------------------------------------------------

def _main(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert launch_train.main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_launch_train_model_par_2_matches_model_par_1():
    """stablelm smoke (4 heads: replicated; d_ff 256 and the 512-token
    vocab split) on a (1, 2) mesh of CPU shards: 5 losses within 1e-5 of
    the one-device run, the reference's JSON keys."""
    base = ["--arch", "stablelm-1.6b", "--smoke", "--device", "cpu",
            "--steps", "5", "--log-every", "100"]
    one = _main(base)
    two = _main(base + ["--model-par", "2"])
    assert set(two) == {"arch", "first_loss", "final_loss", "steps"}
    for k in ("first_loss", "final_loss"):
        _close(two[k], one[k], F32_TOL)
    cfg = launch_train.get_config("stablelm-1.6b", smoke=True)
    specs = M.model_specs(cfg)
    assert specs["runs"][0]["attn"]["wq"][2] is None      # 4 heads
    assert specs["runs"][0]["mlp"]["w_up"][2] == sh.MODEL
    assert specs["embed"][0] == sh.MODEL


#: the other families, each with 16 heads: the hybrid (zamba2: SSD heads
#: that do not divide, so replicated, and the shared block), audio
#: (whisper: the encoder and cross-attention), VLM (internvl2: the
#: projected patches) and gemma3's sliding window
FAMILIES = {
    "hybrid": ("zamba2-7b", dict(n_heads=16, n_kv_heads=16, head_dim=16)),
    "audio": ("whisper-medium", dict(n_heads=16, n_kv_heads=16,
                                     head_dim=16)),
    "vlm": ("internvl2-76b", dict(n_heads=16, n_kv_heads=4, head_dim=16)),
    "local": ("gemma3-12b", dict(n_heads=16, n_kv_heads=8, head_dim=16)),
}
CFGS.update(FAMILIES)


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_families_match_reference(fam, shape=(2, 2)):
    """forward_train's total, the prefill's last logits and one decode
    step of each other family against the reference at 1e-5."""
    cfg, rcfg, p, rp, mesh, ps = _shards(fam, shape)
    rng = np.random.default_rng(11)
    b, s = 2, 64 - (cfg.frontend_seq or 0)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    extra = {}
    if cfg.frontend_seq:
        extra["patches"] = rng.normal(size=(b, cfg.frontend_seq,
                                            cfg.d_model)).astype(np.float32)
    if cfg.n_enc_layers:
        extra["frames"] = rng.normal(size=(b, cfg.enc_seq,
                                           cfg.d_model)).astype(np.float32)
    tb = {"tokens": toks[:, :s], "labels": labels, **extra}
    pre = {"tokens": toks[:, :s], **extra}
    cap = 64 + 4

    def ref():
        jb = {k: jnp.asarray(v) for k, v in tb.items()}
        total = jax.jit(lambda q, bb: RM.forward_train(q, rcfg, bb)[0])(rp,
                                                                        jb)
        lg, wc = jax.jit(lambda q, bb: RM.prefill(
            q, rcfg, bb, max_len=cap))(rp, {k: jnp.asarray(v)
                                            for k, v in pre.items()})
        dec, _ = jax.jit(lambda q, c, t: RM.decode_step(q, rcfg, c, t))(
            rp, wc, jnp.asarray(toks[:, s:]))
        return total, lg, dec
    total, lg, dec = _ref(("family", fam), ref)
    got, _ = M.forward_train(ps, cfg, {k: torch.tensor(v)
                                       for k, v in tb.items()}, mesh)
    _close(float(got), float(total), F32_TOL)
    last, caches = M.prefill(ps, cfg, {k: torch.tensor(v)
                                       for k, v in pre.items()}, cap,
                             kernel=False, mesh=mesh)
    _close(last, lg, F32_TOL)
    step, _ = M.decode_step(ps, cfg, caches, torch.tensor(toks[:, s:]),
                            mesh)
    _close(step, dec, F32_TOL)
    attn = (ps[0]["shared_attn"]["attn"] if fam == "hybrid"
            else M._layer(ps[0]["runs"][0], 0)["attn"])
    assert attn["wq"].shape[1] == 16 // mesh.sizes["model"]
