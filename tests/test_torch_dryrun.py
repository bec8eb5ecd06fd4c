"""The port's dry-run layer (``launch/{roofline,gnn_steps,mesh,dryrun}``,
``configs.base.INPUT_SHAPES``, ``models.steps``' shape-only inputs)
against the live reference where the two compute the same thing, and
against hand counts where they do not (the reference lowers for 512
virtual devices, the port traces one card):

* ``INPUT_SHAPES`` and ``shape_applicable`` equal, reason included;
* ``active_param_count``, ``model_flops`` and ``analytic_flops`` equal
  for every dense arch and shape at full width, each side from abstract
  shapes (``jax.eval_shape`` / meta tensors);
* ``param_specs`` / ``cache_specs`` equal as tuples;
* ``batch_specs`` / ``cache_shape_specs`` / ``abstract_state`` with the
  reference's shapes and dtypes;
* the trace's FLOPs of a smoke full-graph and mini-batch step equal to a
  hand count of their GEMMs and of the aggregation kernels' model;
* the trace's live-bytes peak on fake tensors equal to the same
  counter's peak on a real CPU run (kernels off: a real tensor never
  reaches a stand-in);
* a trace of the kernel path holds no [B, K, D] gather;
* rows of the kernel table (``PERF.md`` section 6) from their shapes;
* the CLI in a subprocess (a GNN and an LM decode combination), and
  ``--multi-pod``'s 2x16x16xH100 record (the multi-card layouts:
  ``tests/test_torch_dryrun_multicard.py``)."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map_only

jax = pytest.importorskip("jax")

from repro.configs import base as RB  # noqa: E402
from repro.launch import roofline as RR  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import steps as RS  # noqa: E402

from repro_torch.configs import base as B  # noqa: E402
from repro_torch.core import gnn as G  # noqa: E402
from repro_torch.kernels.neighbor_agg import ops  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import gnn_steps  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.kernels import cost as C  # noqa: E402
from repro_torch.launch import roofline as R  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import steps as S  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DENSE = ["gemma3-12b", "gemma-7b", "granite-3-2b", "stablelm-1.6b"]
F32 = C.F32_FMA


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name


def _walk(got, want):
    """(port leaf, reference leaf) pairs walking the port tree's keys."""
    if isinstance(got, dict):
        assert set(got) == set(want), (sorted(got), sorted(want))
        return [x for k in got for x in _walk(got[k], want[k])]
    if isinstance(got, (list, tuple)) and not _is_spec(got):
        assert len(got) == len(want)
        return [x for g, w in zip(got, want) for x in _walk(g, w)]
    return [(got, want)]


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(e is None or isinstance(e, str)
                                        for e in x)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_input_shapes_and_applicability_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in B.INPUT_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in RB.INPUT_SHAPES.items()}
    for arch in B.list_archs():
        cfg, rcfg = B.get_config(arch), RB.get_config(arch)
        for name in B.INPUT_SHAPES:
            assert B.shape_applicable(cfg, B.INPUT_SHAPES[name]) == \
                RB.shape_applicable(rcfg, RB.INPUT_SHAPES[name]), (arch, name)


# ---------------------------------------------------------------------------
# roofline arithmetic on the configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_param_counts_and_flops_equal_reference(arch):
    cfg, rcfg = B.get_config(arch), RB.get_config(arch)
    params, _ = S.abstract_state(cfg, with_opt=False)
    rparams = jax.eval_shape(lambda k: RM.init_model(k, rcfg),
                             jax.random.key(0))
    assert R.active_param_count(cfg, params) == \
        RR.active_param_count(rcfg, rparams)
    for name in B.INPUT_SHAPES:
        shape, rshape = B.INPUT_SHAPES[name], RB.INPUT_SHAPES[name]
        assert R.analytic_flops(cfg, shape) == RR.analytic_flops(rcfg,
                                                                 rshape)
        assert R.model_flops(cfg, params, shape) == \
            RR.model_flops(rcfg, rparams, rshape)


@pytest.mark.parametrize("arch", DENSE)
def test_param_and_cache_specs_equal_reference(arch):
    cfg, rcfg = B.get_config(arch), RB.get_config(arch)
    params, _ = S.abstract_state(cfg, with_opt=False)
    rparams = jax.eval_shape(lambda k: RM.init_model(k, rcfg),
                             jax.random.key(0))
    pairs = _walk(M.param_specs(cfg, params), RM.param_specs(rcfg, rparams))
    assert pairs and all(g == w for g, w in pairs), [
        (g, w) for g, w in pairs if g != w]
    shape = B.INPUT_SHAPES["decode_32k"]
    cache = S.cache_shape_specs(cfg, shape)
    rcache = jax.eval_shape(lambda: RM.init_cache(rcfg, shape.global_batch,
                                                  shape.seq_len))
    for shardable in (True, False):
        pairs = _walk(M.cache_specs(cfg, cache, shardable),
                      RM.cache_specs(rcfg, rcache, shardable))
        assert pairs and all(g == w for g, w in pairs), pairs


@pytest.mark.parametrize("arch", ["gemma3-12b", "granite-3-2b"])
def test_shape_only_inputs_match_reference(arch):
    """batch_specs, cache_shape_specs and abstract_state (f32 master
    weights and AdamW state when training, the serving dtype without)
    with the reference's shapes and dtypes, on meta tensors."""
    cfg, rcfg = B.get_config(arch), RB.get_config(arch)
    mesh = make_host_mesh()
    for name in B.INPUT_SHAPES:
        got = S.batch_specs(cfg, B.INPUT_SHAPES[name])
        want = RS.batch_specs(rcfg, RB.INPUT_SHAPES[name], mesh)
        for g, w in _walk(got, want):
            assert g.device.type == "meta"
            assert (tuple(g.shape), _dtype_name(g.dtype)) == \
                (tuple(w.shape), _dtype_name(w.dtype))
    shape = B.INPUT_SHAPES["decode_32k"]
    got = S.cache_shape_specs(cfg, shape)
    want = RS.cache_shape_specs(rcfg, RB.INPUT_SHAPES["decode_32k"], mesh)
    assert got["pos"] == 0 and want["pos"].shape == ()
    for g, w in _walk(got["runs"], want["runs"]):
        assert (tuple(g.shape), _dtype_name(g.dtype)) == \
            (tuple(w.shape), _dtype_name(w.dtype))
    for with_opt in (True, False):
        p, st = S.abstract_state(cfg, None, with_opt=with_opt)
        rp, rst = RS.abstract_state(rcfg, mesh, with_opt=with_opt)
        for g, w in _walk(p, rp):
            assert (tuple(g.shape), _dtype_name(g.dtype)) == \
                (tuple(w.shape), _dtype_name(w.dtype))
        if not with_opt:
            assert st is None and rst is None
            continue
        assert set(st) == set(rst) == {"mu", "nu", "step"}
        for g, w in _walk(st, rst):
            assert (tuple(g.shape), _dtype_name(g.dtype)) == \
                (tuple(w.shape), _dtype_name(w.dtype))


def test_roofline_terms():
    r = R.roofline({"bfloat16": 989e12, F32: 67e12}, 3.35e12, 0)
    assert set(r) == {"compute_s", "memory_s", "collective_s", "dominant",
                      "bound_s", "compute_fraction"}
    assert r["compute_s"] == pytest.approx(2.0) and r["dominant"] == "compute"
    assert r["bound_s"] == pytest.approx(2.0)
    assert r["memory_s"] == pytest.approx(1.0)
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        assert R.peak_flops("float32") == 67e12
        torch.backends.cuda.matmul.allow_tf32 = True
        assert R.peak_flops("float32") == 495e12
        assert R.peak_flops(F32) == 67e12
        assert R.peak_flops(C.TF32X3) == pytest.approx(495e12 / 3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_kernel_table_bounds_from_shapes():
    """Rows of PERF.md's kernel table from their shapes: the full-graph
    D = 128 forward (bf16, B = N = 524,288, K = 32, every row referenced)
    0.1102 ms, bytes; the D = 256 window-0 flash (B 2, S 4096, Hq 16, Hkv
    8) 0.2780 ms in bf16, and in f32 1.6663 ms at the 3xTF32 rate and
    4.1037 ms at the f32-FMA rate, operations; zamba2-7b's f32 flash (Hq =
    Hkv = 32, D 112) 1.4580 ms."""
    n = 524_288
    ms, by = C.least_ms(*C.agg_cost(n, n, 32, 128, 2), C.F32_FLOPS_PER_S)
    assert (round(ms, 4), by) == (0.1102, "bytes")
    ms, by, _, _ = C.flash_bound(2, 4096, 16, 8, 256, 0, torch.bfloat16)
    assert (round(ms, 4), by) == (0.2780, "operations")
    ms, by, _, _ = C.flash_bound(2, 4096, 16, 8, 256, 0, torch.float32)
    assert (round(ms, 4), by) == (1.6663, "operations")
    ms = C.flash_bound(2, 4096, 16, 8, 256, 0, torch.float32,
                       rate=C.F32_FLOPS_PER_S)[0]
    assert round(ms, 4) == 4.1037
    ms = C.flash_bound(2, 4096, 32, 32, 112, 0, torch.float32)[0]
    assert round(ms, 4) == 1.4580
    # bound() counts the distinct rows from the ids, agg_cost takes them
    rng = np.random.default_rng(0)
    feats = torch.zeros((500, 64), dtype=torch.bfloat16)
    idx = torch.tensor(rng.integers(0, 500, (300, 8)), dtype=torch.int32)
    rows = int(torch.unique(idx).numel())
    assert C.bound(feats, idx, None)[2] == C.agg_cost(500, 300, 8, 64, 2,
                                                      rows=rows)[0]


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

def _gnn_cfg(kernel: bool):
    return dataclasses.replace(B.get_config("gnn-papers100m", smoke=True),
                               use_agg_kernel=kernel)


def test_traced_flops_equal_hand_count_fullgraph():
    """GraphSAGE smoke (n 512, K 16, 32 -> 64 -> 8), kernels on: layer 1
    aggregates the 32-wide input (no gradient), layer 2 transforms first
    (64 -> 8 narrows) and its table's gradient takes the reverse-index
    kernel over every ELL edge (the stand-in's worst case)."""
    cfg = _gnn_cfg(True)
    n, k, r, h, c = cfg.n_nodes, cfg.max_degree, cfg.feat_dim, cfg.hidden, \
        cfg.n_classes
    rec = D.dryrun_gnn("gnn-papers100m", "fullgraph_train", cfg=cfg)
    gemm_fwd = 2 * (2 * n * r * h) + 2 * (2 * n * h * c)
    gemm_bwd = 2 * (2 * n * r * h) + 4 * (2 * n * h * c)
    agg = 2 * n * k * r + 2 * n * k * c + 2 * (n * k) * c
    assert rec["flops_by_dtype"] == {"float32": gemm_fwd + gemm_bwd,
                                     F32: agg}
    assert rec["kernel_calls"] == {"tiled_direct": 2, "backward_csr": 1}
    assert rec["status"] == "ok" and rec["fits_hbm"]


def test_traced_flops_equal_hand_count_minibatch():
    """The smoke batch (b 32, fan-out (5, 3)), kernels on: layer 1 runs
    on hops 0 and 1 (no gradient to the hop features), layer 2 on hop 0,
    its neighbor table's gradient through the backward kernel's identity
    mode (one multiply an element of the [b·f1, h] table)."""
    cfg = _gnn_cfg(True)
    b, (f1, f2), r, h, c = cfg.batch_size, cfg.fanout, cfg.feat_dim, \
        cfg.hidden, cfg.n_classes
    rec = D.dryrun_gnn("gnn-papers100m", "minibatch_train", cfg=cfg)
    l1 = 2 * (2 * b * r * h) + 2 * (2 * b * f1 * r * h)
    l2 = 2 * (2 * b * h * c)
    agg = 2 * b * f1 * r + 2 * (b * f1) * f2 * r + 2 * b * f1 * h
    assert rec["flops_by_dtype"] == {"float32": 2 * l1 + 3 * l2,
                                     F32: agg + b * f1 * h}
    assert rec["kernel_calls"] == {"tiled_direct": 3,
                                   "backward_identity": 1}


def _gnn_inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    n, k = cfg.n_nodes, cfg.max_degree
    w = rng.random((n, k)).astype(np.float32) * (rng.random((n, k)) > 0.3)
    return (torch.tensor(rng.normal(size=(n, cfg.feat_dim)),
                         dtype=torch.float32),
            torch.tensor(rng.integers(0, n, (n, k)), dtype=torch.int32),
            torch.tensor(w), torch.tensor(rng.random(n), dtype=torch.float32),
            torch.tensor(rng.integers(0, cfg.n_classes, n), dtype=torch.int32))


def _peak(step, args):
    with R.TraceCounter(*args) as tc:
        out = step(*args)
    return tc.peak_bytes, tc.argument_bytes, tc.output_bytes(out)


@pytest.mark.parametrize("kind", ["fullgraph", "lm"])
def test_fake_trace_peak_equals_real_cpu_run(kind):
    """The same step on real CPU tensors and on fake CPU tensors (kernels
    off): the counter's peak, argument and output bytes are equal."""
    if kind == "fullgraph":
        cfg = _gnn_cfg(False)
        params = G.init_gnn(torch.Generator().manual_seed(0), cfg,
                            cfg.feat_dim, "cpu")
        opt, step = gnn_steps.make_fullgraph_step(cfg)
        args = (params, opt.init(params), *_gnn_inputs(cfg))
    else:
        cfg = B.get_config("stablelm-1.6b", smoke=True)
        params = M.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
        opt, step = S.make_train_step(cfg, microbatches=2)
        toks = torch.randint(0, cfg.vocab_size, (4, 64),
                             generator=torch.Generator().manual_seed(1),
                             dtype=torch.int32)
        args = (params, opt.init(params), {"tokens": toks, "labels": toks})
    real = _peak(step, args)
    with FakeTensorMode() as mode:
        fargs = _to_fake(mode, args)
        fake = _peak(step, fargs)
    assert real == fake and real[0] > real[1] > 0


def _to_fake(mode, tree):
    return tree_map_only(torch.Tensor, mode.from_tensor, tree)


class _Shapes(TorchDispatchMode):
    """Every output shape of every op run inside it."""

    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else [out]):
            if isinstance(t, torch.Tensor):
                self.shapes.add(tuple(t.shape))
        return out


@pytest.mark.parametrize("kernel", [True, False])
def test_kernel_path_trace_has_no_gather(kernel):
    """The full-graph step on meta tensors: with the kernel path no op
    makes an [n, K, d] (or flattened [n*K, d]) tensor; the plain path
    does (its einsum's gather), so the check can see one."""
    cfg = dataclasses.replace(_gnn_cfg(kernel), n_nodes=1000, max_degree=24)
    n, k = cfg.n_nodes, cfg.max_degree
    params = gnn_steps.gnn_abstract_params(cfg)
    _, step = gnn_steps.make_fullgraph_step(cfg)
    args = gnn_steps.fullgraph_input_specs(cfg)
    assert (args[-1] is not None) == kernel
    with _Shapes() as rec:
        step(params, sgd(0.1).init(params), *args)
    widths = (cfg.feat_dim, cfg.hidden, cfg.n_classes)
    gathers = {s for s in rec.shapes for d in widths
               if s in ((n, k, d), (n * k, d))}
    assert bool(gathers) == (not kernel), gathers


def test_stand_ins_only_for_shape_only_tensors():
    """A real CPU tensor takes the plain version and reaches no
    stand-in: nothing is noted, the launch counters stay 0; a meta
    tensor is noted and launches nothing."""
    feats = torch.randn(50, 8)
    idx = torch.randint(0, 50, (20, 4), dtype=torch.int32)
    w = torch.rand(20, 4)
    ops.reset_launches()
    with R.TraceCounter() as tc:
        out = ops.neighbor_agg(feats, idx, w, use_kernel=True)
    assert out.device.type == "cpu" and not tc.kernel_calls
    with R.TraceCounter() as tc:
        mo = ops.neighbor_agg(*(t.to("meta") for t in (feats, idx, w)),
                              use_kernel=True)
    assert mo.device.type == "meta" and mo.shape == out.shape
    assert dict(tc.kernel_calls) == {"tiled_direct": 1}
    assert tc.flops_by_dtype[F32] == 2 * 20 * 4 * 8
    assert ops.launch_counts()["tiled"] == 0


def test_meshes():
    """The one-card layout as it was; the multi-pod layout and the host
    mesh of ``--model-par`` as the reference's (2 x 16 x 16 with a "pod"
    axis; (devices / model_par, model_par))."""
    m = MESH.make_production_mesh()
    assert (m.name, m.chips, m.hbm_bytes) == ("1xH100", 1, 80e9)
    assert m.mesh is None
    mp = MESH.make_production_mesh(multi_pod=True)
    assert (mp.name, mp.chips, mp.hbm_bytes) == ("2x16x16xH100", 512, 80e9)
    assert (mp.mesh.axis_names, mp.mesh.shape) == (
        ("pod", "data", "model"), (2, 16, 16))
    host = MESH.make_host_mesh(model_par=2, devices=("cpu",) * 4)
    assert (host.axis_names, host.shape) == (("data", "model"), (2, 2))
    with pytest.raises(ValueError, match="must divide"):
        MESH.make_host_mesh(model_par=3, devices=("cpu",) * 4)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _cli(args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)


@pytest.mark.parametrize("args,tag", [
    (["--arch", "gnn-papers100m", "--shape", "minibatch_train",
      "--single-pod"], "gnn-papers100m__minibatch_train__1xH100"),
    (["--arch", "granite-3-2b", "--shape", "decode_32k"],
     "granite-3-2b__decode_32k__1xH100"),
])
def test_dryrun_cli(tmp_path, args, tag):
    out = _cli([*args, "--out", str(tmp_path)])
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.load(open(tmp_path / f"{tag}.json"))
    assert rec["status"] == "ok", rec
    assert rec["per_device_flops"] > 0
    assert set(rec["roofline"]) >= {"compute_s", "memory_s", "collective_s",
                                    "dominant", "bound_s"}
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["device_bytes_total"] >= rec["memory"][
        "argument_size_in_bytes"]
    assert rec["collective_bytes_per_device"]["total"] == 0


def test_dryrun_cli_refuses_multi_pod(tmp_path):
    """``--multi-pod`` is no longer refused: it writes the 2x16x16xH100
    records, one device's share of 512 cards, and no 1xH100 one."""
    out = _cli(["--arch", "gnn-papers100m", "--multi-pod", "--out",
                str(tmp_path)])
    assert out.returncode == 0, out.stderr[-2000:]
    assert sorted(os.listdir(tmp_path)) == [
        f"gnn-papers100m__{s}__2x16x16xH100.json"
        for s in ("fullgraph_train", "minibatch_train")]
    for name in os.listdir(tmp_path):
        rec = json.load(open(tmp_path / name))
        assert rec["status"] == "ok" and rec["chips"] == 512
        assert rec["collective_bytes_per_device"]["total"] > 0
