"""The dry-run's multi-card layouts (``launch/mesh.py``'s ``16x16xH100``
and ``2x16x16xH100``, ``launch/dryrun.py`` on a ``sharding.layout_mesh``,
``launch/roofline.py``'s ``collective_bytes``) against hand counts:

* the collective bytes of one attention + MLP layer (forward, forward
  and backward, one decode step) equal the Megatron-SP transitions',
  by kind, under the ring model;
* a record's per-device memory: its argument bytes equal each weight's
  bytes over the shards its spec splits it into, plus the optimizer
  state and the device's rows of the batch, to the byte;
* the CLI in a subprocess for the reference's two CLI combinations
  (``tests/test_dryrun_cli.py:13-19``) at the port's layouts;
* the NODES-sharded GNN steps the dry-run traces, run on values over
  four host shards against the unsharded step and the reference's."""
import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten

from repro_torch import sharding as sh
from repro_torch.configs.base import InputShape, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as MESH
from repro_torch.launch import roofline as R
from repro_torch.models import layers as L
from repro_torch.models import model as M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: stablelm's smoke config with 16 heads: every sharded dim divides 16
TINY = dataclasses.replace(get_config("stablelm-1.6b", smoke=True),
                           n_heads=16, n_kv_heads=16, head_dim=16)


def _layer_bytes(m, b, s, backward=False, cfg=TINY):
    """One attention + MLP layer of ``cfg`` on a layout mesh of ``m``
    model shards, traced on meta tensors: the collectives' bytes, by
    axes, and as ``collective_bytes_bf16_partials`` counts them."""
    mesh = sh.layout_mesh((1, m), ("data", "model"))
    tp = mesh.group("model", 0)
    params = M.shard_params(M.init_model(torch.Generator(), cfg,
                                         device="meta"), cfg, mesh)
    lp = [M._layer(params[0]["runs"][0], 0)]
    rs = L.tp_rs(tp, s)
    x = torch.empty(b, s // m if rs else s, cfg.d_model, device="meta",
                    dtype=M._dt(cfg), requires_grad=backward)
    with R.TraceCounter() as tc:
        if s > 1:
            out, _, _ = M._attn_mlp_block(
                lp, [x], cfg, "attn", torch.arange(s, device="meta"), None,
                False, False, tp, rs)
            if backward:
                torch.autograd.grad(out[0].sum(), x)
        else:
            out = M._decode_layer(lp, [x], cfg, [
                {"k": torch.zeros(b, 8, 16 // m, 16, device="meta"),
                 "v": torch.zeros(b, 8, 16 // m, 16, device="meta"),
                 "slot_pos": torch.zeros(8, dtype=torch.int32,
                                         device="meta")}], 4,
                M.Run("attn", 1, False), False, tp)
    return (R.collective_bytes(tc), dict(tc.collective_by_axes),
            R.collective_bytes_bf16_partials(tc))


@pytest.mark.parametrize("m", [2, 4, 16])
def test_layer_collectives_equal_the_megatron_sp_hand_count(m):
    """Forward: the sequence all-gathered once before attention and once
    before the MLP (1 x the output, [B, S, d]), each partial product
    reduce-scattered (1 x the operand, [B, S, d]); the backward adds the
    adjoints (a reduce-scatter for each gather, a gather for each
    reduce-scatter)."""
    b, s, d = 2, 64, TINY.d_model
    full = b * s * d * 4
    got, axes, same = _layer_bytes(m, b, s)
    assert got == {"all-reduce": 0, "all-gather": 2 * full,
                   "reduce-scatter": 2 * full, "all-to-all": 0,
                   "collective-permute": 0, "total": 4 * full}
    assert axes == {"model": 4 * full} and same == got     # f32: no halves
    got, _, _ = _layer_bytes(m, b, s, backward=True)
    assert (got["all-gather"], got["reduce-scatter"], got["total"]) == (
        4 * full, 4 * full, 8 * full)


def test_decode_layer_collectives_are_two_all_reduces():
    """s = 1 does not split: the partial products of attention and the MLP
    are summed by two all-reduces of [B, 1, d] (2 x the operand each)."""
    b, d = 4, TINY.d_model
    got, _, _ = _layer_bytes(4, b, 1)
    assert got["all-reduce"] == got["total"] == 2 * 2 * b * d * 4


def test_one_device_layout_has_no_collectives():
    got, axes, _ = _layer_bytes(1, 2, 64)
    assert got["total"] == 0 and axes == {}


@pytest.mark.parametrize("backward", [False, True])
def test_bf16_partials_halve_the_partial_products(backward):
    """A bf16 layer: the two gathers move the bf16 stream (2 bytes an
    element), the two reduce-scatters the shards' f32 partial products
    (4 bytes), and the backward the adjoints of each in the same dtypes;
    ``collective_bytes_bf16_partials`` moves the partial products (and
    their adjoints) in bf16, as the reference's GSPMD does."""
    cfg = dataclasses.replace(TINY, dtype="bfloat16")
    b, s, d = 2, 64, cfg.d_model
    el = b * s * d
    got, _, bf16 = _layer_bytes(4, b, s, backward=backward, cfg=cfg)
    k = 2 if backward else 1
    assert (got["all-gather"], got["reduce-scatter"]) == (
        2 * el * 2 + (k - 1) * 2 * el * 4,
        2 * el * 4 + (k - 1) * 2 * el * 2)
    assert (bf16["all-gather"], bf16["reduce-scatter"]) == (
        k * 2 * el * 2, k * 2 * el * 2)
    assert bf16["total"] == k * 4 * el * 2 < got["total"]


def _hand_weight_bytes(cfg, layout, dtype_bytes):
    """Each weight's bytes over the shards its spec splits it into."""
    mesh = layout.mesh
    whole = M.init_model(torch.Generator(), cfg, device="meta")
    specs = M.spec_leaves(whole, cfg)
    total = 0
    for x, sp in zip(tree_flatten(whole)[0], specs):
        k = math.prod(mesh.sizes[a] for a in sh.spec_axes(sp, mesh))
        assert x.numel() % k == 0
        total += x.numel() // k * dtype_bytes
    return total


@pytest.mark.parametrize("layout", ["16x16", "2x16x16"])
def test_train_record_memory_is_one_devices_share(layout):
    """argument bytes = the weights over their shards (``model`` and, on
    FSDP dims, ``data``) + AdamW's mu and nu alike + its step + the
    device's rows of tokens and labels, to the byte."""
    lay = MESH.make_production_mesh(layout=layout)
    shape = InputShape("tiny_train", "train", 128, 64)
    rec = D.dryrun_lm("stablelm-1.6b", shape, cfg=TINY, layout=layout)
    assert rec["status"] == "ok" and rec["chips"] == lay.chips
    dp = 16 * (2 if layout == "2x16x16" else 1)
    b = 64 // dp
    assert rec["batch_per_device"] == b
    weights = _hand_weight_bytes(TINY, lay, 4)
    want = 3 * weights + 4 + 2 * b * 128 * 4
    assert rec["memory"]["argument_size_in_bytes"] == want
    assert rec["device_bytes_total"] >= want
    assert rec["fits_hbm"] is True
    # every dim it splits: heads, d_ff and vocab over 16, d_model over 16
    whole = sum(x.numel() for x in tree_flatten(M.init_model(
        torch.Generator(), TINY, device="meta"))[0]) * 4
    assert weights < whole / 16
    coll = rec["collective_bytes_per_device"]
    assert coll["total"] > 0 and coll["reduce-scatter"] > 0
    assert set(rec["collective_bytes_by_axes"]) >= {"model", "data"}
    assert rec["roofline"]["collective_s"] > 0


def test_decode_record_memory_holds_the_shards_caches():
    """A decode record's arguments: the serving weights (bf16) over their
    shards, each KV cache's heads over ``model`` and rows over ``data``,
    the token rows."""
    cfg = dataclasses.replace(TINY, dtype="bfloat16")
    shape = InputShape("tiny_decode", "decode", 256, 32)
    rec = D.dryrun_lm("stablelm-1.6b", shape, cfg=cfg, layout="16x16")
    assert rec["status"] == "ok"
    lay = MESH.make_production_mesh(layout="16x16")
    b = 32 // 16
    kv = cfg.n_layers * 2 * b * 256 * (16 // 16) * 16 * 2 \
        + cfg.n_layers * 256 * 4
    want = _hand_weight_bytes(cfg, lay, 2) + kv + b * 4
    assert rec["memory"]["argument_size_in_bytes"] == want


def test_layouts_and_their_links():
    one, two, pod = (MESH.make_production_mesh(layout=n)
                     for n in ("1xH100", "16x16", "2x16x16"))
    assert (one.chips, two.chips, pod.chips) == (1, 256, 512)
    assert one.mesh is None and one.links == {}
    assert two.mesh.shape == (16, 16) and pod.mesh.axis_names == (
        "pod", "data", "model")
    assert set(two.links.values()) == {"ib"}          # model spans 2 hosts
    small = MESH.CardLayout("x", 16, 80e9, (4, 4), ("data", "model"))
    assert small.links == {"data": "ib", "model": "nvlink"}
    r = R.roofline({}, 0.0, 100e9, {"model": 50e9, "data": 50e9},
                   {"model": "nvlink", "data": "ib"})
    assert r["collective_s"] == pytest.approx(50e9 / R.NVLINK_BYTES_PER_S
                                              + 50e9 / R.IB_BYTES_PER_S)


# ---------------------------------------------------------------------------
# the CLI (the reference's two combinations, at the port's layouts)
# ---------------------------------------------------------------------------

def _cli(args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)


@pytest.mark.parametrize("args,tag,chips", [
    (["--arch", "mamba2-130m", "--shape", "decode_32k", "--mesh", "16x16"],
     "mamba2-130m__decode_32k__16x16xH100", 256),
    (["--arch", "gnn-papers100m", "--shape", "minibatch_train",
      "--multi-pod"], "gnn-papers100m__minibatch_train__2x16x16xH100", 512),
])
def test_dryrun_cli_multicard(tmp_path, args, tag, chips):
    out = _cli([*args, "--out", str(tmp_path)])
    assert out.returncode == 0, out.stderr[-2000:]
    assert os.listdir(tmp_path) == [tag + ".json"]
    rec = json.load(open(tmp_path / f"{tag}.json"))
    assert rec["status"] == "ok", rec
    assert rec["chips"] == chips and rec["mesh"] == tag.split("__")[-1]
    assert rec["per_device_flops"] > 0 and rec["per_device_bytes"] > 0
    assert set(rec["roofline"]) >= {"compute_s", "memory_s", "collective_s",
                                    "dominant", "bound_s"}
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["device_bytes_total"] >= rec["memory"][
        "argument_size_in_bytes"]
    coll = rec["collective_bytes_per_device"]
    assert set(coll) == set(R.COLLECTIVES) | {"total"}
    assert coll["total"] == sum(coll[c] for c in R.COLLECTIVES) > 0
    assert sum(rec["collective_bytes_by_axes"].values()) == coll["total"]
    cfg = get_config(rec["arch"])
    if cfg.family == "gnn":
        # weights replicated (SGD: a step counter), one device's 256 of
        # the 8192 targets: its fan-out tree in f32, labels in int32
        b = 8192 // 32
        w = sum(a * o for a, o in ((128, 256), (128, 256), (256, 172),
                                   (256, 172))) * 4
        tree = b * (1 + 15 + 150) * 128 * 4 + 2 * b * (15 + 150) * 4 \
            + b * (1 + 15 + 150) * 4 + b * 4
        assert rec["memory"]["argument_size_in_bytes"] == w + 4 + tree
        assert set(rec["collective_bytes_by_axes"]) == {"pod+data"}
    else:
        # mamba2-130m serving: its bf16 weights over their shards; each
        # device's 8 of the 128 rows, its 2 of the 32 padded SSD heads
        # (f32 state), their conv inputs and 16 of the 256 B|C columns
        lay = MESH.make_production_mesh(layout="16x16")
        el = 2 if cfg.dtype == "bfloat16" else 4
        weights = _hand_weight_bytes(cfg, lay, el)
        p, n, k1 = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv - 1
        h = sh.padded_heads(cfg.ssm_expand * cfg.d_model // p) // 16
        b = 128 // 16
        assert rec["batch_per_device"] == b and h == 2
        cache = cfg.n_layers * b * (h * p * n * 4 + k1 * h * p * el
                                    + k1 * 2 * n // 16 * el)
        assert rec["memory"]["argument_size_in_bytes"] == \
            weights + cache + b * 4


@pytest.mark.parametrize("batched", [False, True])
def test_f32_partial_products_count_as_their_gemm(batched):
    """A shard's partial product of bf16 operands leaves its GEMM in f32
    (``mm`` / ``bmm`` with ``out_dtype``); the trace counts its FLOPs as
    the bf16 product's, 2·M·N·K, and its output in f32."""
    lead = (3,) if batched else ()
    a = torch.empty(*lead, 64, 32, dtype=torch.bfloat16, device="meta")
    b = torch.empty(*lead, 32, 16, dtype=torch.bfloat16, device="meta")
    with R.TraceCounter() as tc:
        out = (L._ProductF32.apply(a, b) if batched
               else L.partial_product(a, b))
    assert out.dtype == torch.float32 and out.shape == (*lead, 64, 16)
    assert dict(tc.flops_by_dtype) == {
        "bfloat16": 2 * 64 * 16 * 32 * (3 if batched else 1)}


# ---------------------------------------------------------------------------
# the NODES-sharded GNN steps on values
# ---------------------------------------------------------------------------

N_GNN, K_GNN, SHARDS = 64, 6, 4
GNN_KW = dict(name="t", n_nodes=N_GNN, feat_dim=12, hidden=8, n_classes=5,
              n_layers=2, fanout=(4, 3), batch_size=16, max_degree=K_GNN,
              gat_heads=2)


def _gnn_arrays(cfg, seed=0):
    """(feats, ELL ids, weights, self weights, labels) of a random graph,
    numpy."""
    rng = np.random.default_rng(seed)
    n, k = cfg.n_nodes, cfg.max_degree
    w = (rng.random((n, k)) * (rng.random((n, k)) > 0.3)).astype(np.float32)
    return (rng.normal(size=(n, cfg.feat_dim)).astype(np.float32),
            rng.integers(0, n, (n, k)).astype(np.int32), w,
            rng.random(n).astype(np.float32),
            rng.integers(0, cfg.n_classes, n).astype(np.int32))


def _tree_arrays(layers):
    """A GNN parameter tree's leaves, layer by layer in key order."""
    return [np.asarray(d[k], np.float64) for d in layers for k in sorted(d)]


def _check_step(got_loss, got_params, want_loss, want_params, params0):
    """The loss at 1e-5 and the gradient each update implies (SGD(0.1):
    (p - p') / 0.1) at 1e-3 of its largest entry."""
    assert abs(float(got_loss) - float(want_loss)) <= 1e-5
    for g, w, p in zip(_tree_arrays(got_params), _tree_arrays(want_params),
                       _tree_arrays(params0)):
        gg, gw = (p - g) / 0.1, (p - w) / 0.1
        assert np.max(np.abs(gg - gw)) <= 1e-3 * max(np.max(np.abs(gw)),
                                                     1e-6)


def _reference_step(kind, kw, params_np, arrays):
    jnp = pytest.importorskip("jax.numpy")
    from repro.configs.base import GNNConfig as RefConfig
    from repro.launch import gnn_steps as RGS
    cfg = RefConfig(**kw)
    make = RGS.make_fullgraph_step if kind == "fullgraph" \
        else RGS.make_minibatch_step
    opt, step = make(cfg)
    p = [{k: jnp.asarray(v) for k, v in d.items()} for d in params_np]
    args = [[jnp.asarray(x) for x in a] if isinstance(a, list)
            else jnp.asarray(a) for a in arrays]
    p2, _, loss = step(p, opt.init(p), *args)
    return float(loss), [{k: np.asarray(v) for k, v in d.items()}
                         for d in p2]


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("model", ["gcn", "graphsage", "gat"])
def test_fullgraph_mesh_step_matches_unsharded_and_reference(model, kernel):
    """``make_fullgraph_step(mesh=)`` on four NODES shards on the host
    (each shard's rows, the source table all-gathered a layer, the loss
    and gradients psum'd) against the unsharded step on the same inputs
    and the reference's step: loss at 1e-5, gradients at 1e-3."""
    pytest.importorskip("jax")
    from repro_torch.configs.base import GNNConfig
    from repro_torch.core import gnn as G
    from repro_torch.kernels.neighbor_agg import ops
    from repro_torch.launch import gnn_steps
    kw = dict(GNN_KW, model=model, use_agg_kernel=kernel)
    cfg = GNNConfig(**kw)
    params = G.init_gnn(torch.Generator().manual_seed(0), cfg, cfg.feat_dim,
                        "cpu")
    params_np = [{k: v.numpy().copy() for k, v in d.items()}
                 for d in params]
    arrays = _gnn_arrays(cfg)
    feats, idx, w, ws, lab = (torch.from_numpy(a) for a in arrays)
    rev = ops.build_reverse_index(idx, w, N_GNN) if kernel else None
    opt, step = gnn_steps.make_fullgraph_step(cfg)
    p1, _, loss1 = step(params, opt.init(params), feats, idx, w, ws, lab,
                        rev)

    mesh = MESH.make_host_mesh(1, devices=("cpu",) * SHARDS)
    m = N_GNN // SHARDS
    blocks = [[t[i * m:(i + 1) * m] for i in range(SHARDS)]
              for t in (feats, idx, w, ws, lab)]
    revs = [ops.build_reverse_index(i, ww, N_GNN)
            for i, ww in zip(blocks[1], blocks[2])] if kernel else None
    ps = [G.params_from_numpy(params_np, device="cpu")
          for _ in range(SHARDS)]
    opt, mstep = gnn_steps.make_fullgraph_step(cfg, mesh)
    sh.reset_collectives()
    p4, _, loss4 = mstep(ps, [opt.init(p) for p in ps], *blocks, revs)
    assert sh.collective_counts()["all-gather"] > 0     # it did shard
    for p in p4:
        _check_step(loss4, p, loss1, p1, params)
    rloss, rp = _reference_step("fullgraph", dict(kw, use_agg_kernel=False),
                                params_np, arrays)
    _check_step(loss4, p4[0], rloss, rp, params)


@pytest.mark.parametrize("model", ["gcn", "graphsage", "gat"])
def test_minibatch_mesh_step_matches_unsharded_and_reference(model):
    """``make_minibatch_step(mesh=)``: each of four shards its quarter of
    the batch's fan-out trees, the loss and gradients psum'd, against
    the unsharded step and the reference's."""
    pytest.importorskip("jax")
    from repro_torch.configs.base import GNNConfig
    from repro_torch.core import gnn as G
    from repro_torch.launch import gnn_steps
    kw = dict(GNN_KW, model=model)
    cfg = GNNConfig(**kw)
    params = G.init_gnn(torch.Generator().manual_seed(0), cfg, cfg.feat_dim,
                        "cpu")
    params_np = [{k: v.numpy().copy() for k, v in d.items()}
                 for d in params]
    rng = np.random.default_rng(1)
    b, r = cfg.batch_size, cfg.feat_dim
    shape, feats, masks, weights, self_w = (b,), [], [], [], []
    feats.append(rng.normal(size=shape + (r,)).astype(np.float32))
    self_w.append(rng.random(shape).astype(np.float32))
    for beta in cfg.fanout:
        edge = shape + (beta,)
        mk = (rng.random(edge) > 0.2).astype(np.float32)
        masks.append(mk)
        weights.append((rng.random(edge) * mk).astype(np.float32))
        shape = edge
        feats.append(rng.normal(size=shape + (r,)).astype(np.float32))
        self_w.append(rng.random(shape).astype(np.float32))
    labels = rng.integers(0, cfg.n_classes, b).astype(np.int32)
    arrays = (feats, masks, weights, self_w, labels)
    t = [[torch.from_numpy(x) for x in a] for a in arrays[:4]] \
        + [torch.from_numpy(labels)]
    opt, step = gnn_steps.make_minibatch_step(cfg)
    p1, _, loss1 = step(params, opt.init(params), *t)

    mesh = MESH.make_host_mesh(1, devices=("cpu",) * SHARDS)
    m = b // SHARDS
    shards = [[[x[i * m:(i + 1) * m] for x in a] for i in range(SHARDS)]
              for a in t[:4]] + [[t[4][i * m:(i + 1) * m]
                                  for i in range(SHARDS)]]
    ps = [G.params_from_numpy(params_np, device="cpu")
          for _ in range(SHARDS)]
    opt, mstep = gnn_steps.make_minibatch_step(cfg, mesh)
    sh.reset_collectives()
    p4, _, loss4 = mstep(ps, [opt.init(p) for p in ps], *shards)
    assert sh.collective_counts()["all-reduce"] > 0
    for p in p4:
        _check_step(loss4, p, loss1, p1, params)
    rloss, rp = _reference_step("minibatch", kw, params_np, arrays)
    _check_step(loss4, p4[0], rloss, rp, params)
