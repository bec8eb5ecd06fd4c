"""The port's static audits (``repro_torch.analysis``) against the
reference's (``repro.analysis``) on the CPU.

* ``findings`` — the port's copy gives the reference's results on the
  same inputs (exact);
* ``thread`` — the port's ``analyze_source`` gives the reference's
  findings on ``BROKEN_THREAD_SRC`` and on the reference's six module
  sources (exact, no extra line); on the port's modules it sees every
  ``Prefetcher`` callback's worker side (through ``_prefetched``,
  lambdas and base classes), and after the ``timing`` repair the repo is
  clean with no ``thread`` allowlist entry;
* ``kernel`` — the H100 budget formulas, the gate over and near a limit,
  the ``cuobjdump -res-usage`` parser on canned text, the launch
  constants against the ``.cu`` sources, and the index-table bounds
  against the reference's on the same arrays and graph;
* ``trace`` — one step of each paradigm traced twice: no float64, one
  op sequence; planted float64 and cast round trips flagged;
* the fixtures and the CLI (``python -m repro_torch.analysis --device
  cpu``): the tree exits 0, the CPU fixtures nonzero.

The checks are exact (no tolerance applies) except where a number is
compared, and those are integers.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro.analysis import findings as RF
from repro.analysis import fixtures as RFX
from repro.analysis import pallas_audit as RPA
from repro.analysis import thread_audit as RTA
from repro_torch.analysis import findings as F
from repro_torch.analysis import fixtures as FX
from repro_torch.analysis import kernel_audit as KA
from repro_torch.analysis import thread_audit as TA
from repro_torch.analysis import trace_audit as TR
from repro_torch.core.experiment import PARADIGMS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALLOWLIST = os.path.join(REPO, "src", "repro_torch", "analysis",
                         "allowlist.toml")


def _kept(findings):
    entries, bad = F.load_allowlist(ALLOWLIST)
    assert not bad, [str(b) for b in bad]
    kept, _ = F.apply_allowlist(findings, entries)
    return kept


def _key(f):
    return (f.checker, f.severity, f.site, f.detail)


# ---------------------------------------------------------------------------
# findings: parity with the reference's copy
# ---------------------------------------------------------------------------

ALLOW_TEXT = """
# comment
[[allow]]
checker = "thread"   # trailing comment
site = "mod.Cls.attr"
reason = "a # inside quotes stays"

[[allow]]
checker = "kernel"
site = "kernel:headroom:"
"""


def test_parse_allowlist_matches_reference():
    assert F.parse_allowlist(ALLOW_TEXT) == RF.parse_allowlist(ALLOW_TEXT)
    (e, _) = F.parse_allowlist(ALLOW_TEXT)
    assert e == {"checker": "thread", "site": "mod.Cls.attr",
                 "reason": "a # inside quotes stays"}


@pytest.mark.parametrize("bad", [
    "[[allow]]\nchecker = unquoted\n",
    "stray line\n",
    "checker = \"thread\"\n",          # a key before any [[allow]]
])
def test_parse_allowlist_rejects_as_reference(bad):
    with pytest.raises(ValueError):
        RF.parse_allowlist(bad)
    with pytest.raises(ValueError):
        F.parse_allowlist(bad)


def test_load_allowlist_reports_missing_keys_as_reference(tmp_path):
    p = tmp_path / "allow.toml"
    p.write_text(ALLOW_TEXT)
    entries, bad = F.load_allowlist(str(p))
    r_entries, r_bad = RF.load_allowlist(str(p))
    assert entries == r_entries
    assert [_key(b) for b in bad] == [_key(b) for b in r_bad]
    assert [b.site for b in bad] == ["allowlist:kernel:headroom:"]
    assert F.load_allowlist(str(tmp_path / "missing.toml")) == ([], [])


def _both(rows):
    return ([F.Finding(*r) for r in rows], [RF.Finding(*r) for r in rows])


FINDINGS = [("thread", "error", "mod.Cls.attr", "x"),
            ("thread", "info", "mod.Cls.attr2", "y"),
            ("kernel", "warning", "mod.Cls.attr", "z"),
            ("trace", "error", "variant:fullgraph+kernel", "w")]


def test_apply_allowlist_gating_and_reports_match_reference():
    port, ref = _both(FINDINGS)
    entries = [{"checker": "thread", "site": "mod.Cls.attr", "reason": "r"}]
    kept, supp = F.apply_allowlist(port, entries)
    r_kept, r_supp = RF.apply_allowlist(ref, entries)
    # prefix match: both thread sites go, the kernel one stays
    assert [_key(f) for f in kept] == [_key(f) for f in r_kept]
    assert [_key(f) for f in supp] == [_key(f) for f in r_supp]
    assert [f.checker for f in kept] == ["kernel", "trace"]
    assert [_key(f) for f in F.gating(port)] == \
        [_key(f) for f in RF.gating(ref)]
    extra = {"device": "cpu"}
    assert F.render_report(kept, supp, extra) == \
        RF.render_report(r_kept, r_supp, extra)
    assert F.as_json(kept, supp, extra) == RF.as_json(r_kept, r_supp, extra)
    assert json.loads(F.as_json(kept, supp))["suppressed"][0]["site"] == \
        "mod.Cls.attr"


def test_finding_rejects_bad_severity():
    with pytest.raises(ValueError):
        F.Finding("trace", "fatal", "s", "d")


# ---------------------------------------------------------------------------
# thread: parity on the reference's sources
# ---------------------------------------------------------------------------

def test_broken_thread_fixture_matches_reference():
    assert FX.BROKEN_THREAD_SRC == RFX.BROKEN_THREAD_SRC
    port = TA.analyze_source(FX.BROKEN_THREAD_SRC, "fixture_mod")
    ref = RTA.analyze_source(RFX.BROKEN_THREAD_SRC, "fixture_mod")
    assert [_key(f) for f in port] == [_key(f) for f in ref]
    assert [f.site for f in port] == ["fixture_mod.LossyCounter.count"]


@pytest.mark.parametrize("rel", RTA.AUDITED_MODULES)
def test_thread_audit_matches_reference_on_its_modules(rel):
    """The port's extra resolutions find nothing more in the reference's
    own modules (it hands its callbacks over by keyword)."""
    path = os.path.join(REPO, "src", "repro", rel)
    mod = "repro." + rel[:-3].replace("/", ".")
    with open(path) as f:
        src = f.read()
    port = sorted(_key(f) for f in TA.analyze_source(src, mod))
    ref = sorted(_key(f) for f in RTA.analyze_source(src, mod))
    assert port == ref


def _port_src(rel):
    with open(os.path.join(TA.package_root(), rel)) as f:
        return f.read()


@pytest.mark.parametrize("cls,want", [
    ("SampledSource", {"_sample", "_host_batch", "_timed_stage", "_stage",
                       "_tally"}),
    ("ShardedSampledSource", {"_sample", "_host_batch", "_timed_stage",
                              "_stage", "SampledSource._host_batch"}),
    ("ImportanceSampledSource", {"_sample", "_host_batch", "_timed_stage",
                                 "_draw", "_stage"}),
    ("ClusterSource", {"_choose", "_assemble", "_timed_stage", "_tally"}),
])
def test_worker_side_of_the_staged_sources(cls, want):
    info = TA.class_info(_port_src("core/engine.py"), cls)
    assert want <= info.worker_side()
    # the training loop's side stays off the worker
    assert not {"batches", "_prefetched", "done", "_upload"} \
        & info.worker_side()


def test_worker_side_of_the_inference_stager():
    info = TA.class_info(_port_src("core/inference.py"), "_ChunkStream")
    assert info.worker_side() == {"_stage"}


def test_lambda_and_forwarder_resolution():
    """A callback given by position to a forwarding method, or inside a
    lambda, is a worker entry; a bound method passed to another call is
    a call edge; a base class in the module lends its methods."""
    src = '''
class Base:
    def _hand(self, n, fn):
        return Prefetcher(payload_fn=fn)

    def _timed(self, f, *a):
        self.t = 1
        return f(*a)


class Src(Base):
    def go(self):
        self._hand(3, lambda g, x: self._timed(self._build, g, x))

    def _build(self, g, x):
        self.rows = x

    def reset(self):
        self.rows = None
        self.t = 0
'''
    info = TA.class_info(src, "Src")
    assert {"_timed", "_build"} <= info.worker_side()
    sites = {f.site: f.severity for f in TA.analyze_source(src, "m")}
    assert sites == {"m.Src.rows": "error", "m.Src.t": "error"}


def test_repo_thread_audit_clean():
    assert not F.gating(_kept(TA.audit_threads()))


def test_timing_race_is_repaired():
    """The staged sources' ``timing`` dict is written under a lock from
    both threads: no finding of any severity is left on it."""
    sites = [f.site for f in TA.audit_threads()]
    assert not [s for s in sites if s.endswith(".timing")]


def test_tally_under_contention():
    """``_tally`` from more threads than cores with a short switch
    interval loses no update."""
    from repro_torch.core.engine import _StagedSource
    src = _StagedSource.__new__(_StagedSource)
    src.timing = {"batches": 0, "stage_each_s": []}
    src._timing_lock = threading.Lock()
    n_threads, n_adds = (os.cpu_count() or 2) * 2, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [
            src._tally(batches=1, stage_each_s=[0.0])
            for _ in range(n_adds)]) for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert src.timing["batches"] == n_threads * n_adds
    assert len(src.timing["stage_each_s"]) == n_threads * n_adds


def test_allowlist_stays_small_with_reasons():
    entries, bad = F.load_allowlist(ALLOWLIST)
    assert not bad
    assert 1 <= len(entries) <= 3
    assert all(e["reason"] for e in entries)
    assert not [e for e in entries if e["checker"] == "thread"]


# ---------------------------------------------------------------------------
# kernel: budgets, resources, sources
# ---------------------------------------------------------------------------

def test_flash_budget_formulas_at_d256():
    assert sum(KA.flash_wgmma_smem(256).values()) == 197_696
    assert sum(KA.flash_tf32x3_smem(256).values()) == 199_680
    rows = {(r["kernel"], r["head_dim"]): r
            for r in KA.default_budget_table()}
    assert rows[("flash_attn_wgmma_kernel", 256)]["smem_bytes"] == 197_696
    assert rows[("flash_attn_kernel", 256)]["smem_bytes"] == 199_680
    # D = 112 runs in the 128-column layout
    assert rows[("flash_attn_wgmma_kernel", 112)]["smem_bytes"] == \
        rows[("flash_attn_wgmma_kernel", 128)]["smem_bytes"]
    assert rows[("neighbor_agg_kernel", None)]["smem_bytes"] == 0
    assert {r["kernel"] for r in rows.values()} == {
        "neighbor_agg_kernel", "neighbor_agg_slab_kernel",
        "neighbor_agg_bwd_kernel", "neighbor_agg_bwd_identity_kernel",
        "neighbor_agg_bwd_csr_kernel", "neighbor_agg_row_kernel",
        "flash_attn_kernel",
        "flash_attn_wgmma_kernel"}


def test_budget_gate_fires_over_limit_and_warns_near_it():
    over = KA.budget_row("huge", "case", "x.cu", 256,
                         {"tile": KA.H100["smem_per_block"] + 1})
    near = KA.budget_row("big", "case", "x.cu", 256, {
        "tile": int(KA.H100["smem_per_block"] * (KA.WARN_FRACTION + 0.01))})
    threads = KA.budget_row("wide", "case", "x.cu", 2048, {})
    (e,) = [f for f in KA.audit_budgets([over]) if f.severity == "error"
            and "per block" in f.detail]
    assert e.site == "kernel:limit:huge[case]" and "exceeds" in e.detail
    (w,) = KA.audit_budgets([near])
    assert w.severity == "warning" and w.site.startswith("kernel:headroom:")
    (t,) = KA.audit_budgets([threads])
    assert t.severity == "error" and "threads" in t.detail


def test_repo_budgets_warn_only_where_allowlisted():
    fs = KA.audit_budgets() + KA.audit_sources()
    assert {f.site for f in F.gating(fs)} == {
        "kernel:headroom:flash_attn_kernel[f32 tiles D=256]",
        "kernel:headroom:flash_attn_wgmma_kernel[bf16 D=256]"}
    assert not F.gating(_kept(fs))


def test_source_constants_match_the_cuda_sources(tmp_path):
    assert KA.audit_sources() == []
    # an edited launch constant is caught
    root = tmp_path / "pkg"
    for rel in KA.SOURCE_CONSTANTS:
        dst = root / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(open(os.path.join(TA.package_root(), rel)).read())
    wg = root / "kernels/flash_attn/csrc/flash_attn_wgmma.cu"
    wg.write_text(wg.read_text().replace("kStages = 2;", "kStages = 3;"))
    (f,) = KA.audit_sources(str(root))
    assert f.severity == "error" and "kStages" in f.site


NA_RES = """
Resource usage:
 Common:
  GLOBAL:0
 Function _ZN48_GLOBAL__N__80813b8e_15_neighbor_agg_cu_a2ecb65019neighbor_agg_kernelI13__nv_bfloat16fLi8ELb0EEEvPKT_PKiS4_PKT0_S9_PS7_llii:
  REG:32 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:600 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _ZN46_GLOBAL__N__da1df631_13_flash_attn_cu_19d3340f17flash_attn_kernelIfLi112EEEvPKT_S3_S3_PS1_iiiif:
  REG:166 STACK:0 SHARED:1024 LOCAL:16 CONSTANT[0]:580 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _ZN38_GLOBAL__N__9aba3876_6_oob_cu_a387fcb516smem_race_kernelEPKfPf:
  REG:14 STACK:0 SHARED:2048 LOCAL:0 CONSTANT[0]:544 TEXTURE:0 SURFACE:0 SAMPLER:0
"""


def test_res_usage_parser_and_join():
    usage = KA.parse_res_usage(NA_RES)
    assert len(usage) == 3
    sym = next(s for s in usage if "neighbor_agg_kernel" in s)
    assert usage[sym] == {"REG": 32, "STACK": 0, "SHARED": 0, "LOCAL": 0}
    assert KA.symbol_kernel(sym, ["neighbor_agg_kernel"]) == (
        "neighbor_agg_kernel", ("bf16", "f32", 8, 0))
    fs, rows = KA.audit_resources(usage)
    by = {r["symbol"]: r for r in rows}
    f32 = by["flash_attn_kernel<f32,112>"]
    assert f32["regs_per_block"] == 168 * 128        # 166 -> 168 a thread
    assert f32["shared_dynamic"] == 89_088
    assert by["neighbor_agg_kernel<bf16,f32,8,0>"]["threads"] == 256
    sev = {(f.severity, f.site.split(":")[1]) for f in fs}
    # a symbol of no formula row is an error; spills are info
    assert ("error", "symbol") in sev and ("info", "spill") in sev
    assert len(F.gating(fs)) == 1


def test_static_smem_must_match_the_formula():
    text = NA_RES.replace("SHARED:1024", "SHARED:4096")
    fs, _ = KA.audit_resources(KA.parse_res_usage(text))
    assert any(f.site.startswith("kernel:static_smem:flash_attn_kernel")
               for f in F.gating(fs))


def test_launch_smem_must_match_the_formula():
    """The flash launches' ``kSmem`` as the built library reports it is
    held to the formula rows: equal is clean; a byte off, or a head dim
    the build lacks, is an error."""
    table = KA.default_budget_table()
    built = {(r["kernel"], r["head_dim"]): r["dyn_smem"] for r in table
             if r["kernel"] in KA.SMEM_QUERIES}
    assert len(built) == len(KA.FLASH_HEAD_DIMS) + len(KA.WGMMA_HEAD_DIMS)
    assert KA.audit_launch_smem(built, table) == []
    off = dict(built)
    off[("flash_attn_wgmma_kernel", 256)] += 8
    del off[("flash_attn_kernel", 16)]
    fs = KA.audit_launch_smem(off, table)
    assert sorted(f.site for f in F.gating(fs)) == [
        "kernel:dyn_smem:flash_attn_kernel[f32 tiles D=16]",
        "kernel:dyn_smem:flash_attn_wgmma_kernel[bf16 D=256]"]


def test_kernel_fixture_is_over_the_register_file():
    fs = F.gating(FX.run_fixture("kernel"))
    assert any(f.severity == "error" and "76800 exceeds" in f.detail
               for f in fs), [str(f) for f in fs]


# ---------------------------------------------------------------------------
# kernel: index bounds against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arr,n", [
    (np.array([[0, 3], [1, 2]], np.int32), 4),
    (np.array([4], np.int32), 4),
    (np.array([-1], np.int32), 4),
    (np.zeros((0,), np.int32), 0),
])
def test_check_index_bounds_matches_reference(arr, n):
    port = KA.check_index_bounds(arr, n, "s")
    ref = RPA.check_index_bounds(arr, n, "s")
    assert [(f.severity, f.site) for f in port] == \
        [(f.severity, f.site) for f in ref]
    assert [f.checker for f in port] == ["kernel"] * len(ref)


@pytest.fixture(scope="module")
def graphs():
    from repro.analysis.jaxpr_audit import audit_graph
    ref = audit_graph(n=96)
    port = TR.audit_graph(n=96)
    for f in dataclasses.fields(port):
        np.testing.assert_array_equal(getattr(port, f.name),
                                      getattr(ref, f.name))
    return port, ref


def test_index_tables_clean_as_reference(graphs):
    port, ref = graphs
    assert RPA.audit_index_tables(ref) == []
    assert KA.audit_index_tables(port) == []


def test_index_tables_on_four_shards_clean():
    from repro_torch import sharding as sh
    g = TR.audit_graph(n=96)
    assert KA.audit_index_tables(g, sh.node_mesh(devices=("cpu",) * 4)) \
        == []


def test_planted_bad_ids_are_flagged(graphs):
    port, _ = graphs
    from repro_torch.core.graph import to_ell
    from repro_torch.kernels.neighbor_agg.ops import build_reverse_index
    idx, w, _ = to_ell(port)
    bad = idx.copy()
    bad[3, 0] = port.n
    (f,) = KA.check_index_bounds(bad, port.n, "bounds:ell.idx")
    assert f.severity == "error" and f"{port.n}]" in f.detail
    rev = build_reverse_index(torch.as_tensor(idx), torch.as_tensor(w),
                              port.n)
    assert KA.check_reverse_index(rev) == []
    rev.indptr[5] = rev.indptr[6] + 1             # a decreasing step
    rev.edges[0] = idx.size                        # past B*K
    sites = {f.site for f in KA.check_reverse_index(rev)}
    assert sites == {"bounds:reverse_index.indptr",
                     "bounds:reverse_index.edges"}


# ---------------------------------------------------------------------------
# trace
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def audit_graph():
    return TR.audit_graph(n=192)


@pytest.mark.parametrize("paradigm", PARADIGMS)
def test_trace_one_variant_per_paradigm(audit_graph, paradigm):
    fs, rec = TR.audit_variant(audit_graph, TR.Variant(paradigm, True),
                               device="cpu")
    assert not F.gating(_kept(fs)), [str(f) for f in fs]
    assert rec["retrace_stable"] is True
    assert rec["n_ops"] > 0 and len(rec["op_hash"]) == 16
    assert rec["kernel_launches"] == {}          # CPU: the plain versions
    assert "not applicable" in rec["host_constants"]
    assert "not applicable" in rec["donation"]


def test_trace_counts_mesh_collectives_and_syncs(audit_graph):
    _, rec = TR.audit_variant(
        audit_graph, TR.Variant("fullgraph_sharded", True, featshard=True),
        device="cpu")
    assert rec["mesh_collectives"].get("all_gather", 0) > 0
    _, rec = TR.audit_variant(audit_graph, TR.Variant("cluster", True),
                              device="cpu")
    # the batch's reverse index is built inside the step: nonzero and
    # bincount size their outputs on the host; on the CPU the backward of
    # each of the 2 layers is the kernel's plain version, whose
    # repeat_interleave and three boolean-mask indexings would sync too
    assert rec["host_syncs"] == {"aten.nonzero": 1, "aten.bincount": 1,
                                 "aten.repeat_interleave": 2,
                                 "aten.index": 6}
    assert rec["host_syncs_measured"] == "not measured on the CPU"


@pytest.mark.parametrize("fn,want", [
    (lambda x: x[x > 2], {"aten.index": 1}),
    (lambda x: torch.masked_select(x, x > 2), {"aten.masked_select": 1}),
    (lambda x: torch.unique(x), {"aten._unique2": 1}),
    (lambda x: torch.bincount(x), {"aten.bincount": 1}),
    (lambda x: x.sum().item(), {"aten._local_scalar_dense": 1}),
    (lambda x: torch.repeat_interleave(x), {"aten.repeat_interleave": 1}),
    (lambda x: torch.repeat_interleave(x, x, output_size=int(x.sum())),
     {"aten._local_scalar_dense": 1}),
    (lambda x: x.repeat_interleave(2), {}),
    (lambda x: x[x.long()] * 2 + x.sum(), {}),
])
def test_sync_ops_are_named(fn, want):
    """The op list names each op that syncs the card: a read back, or an
    output the host must size from the data (not the same ops with their
    size given)."""
    x = torch.tensor([3, 0, 1, 4, 2, 1])
    _, tr, _, _ = TR.traced(fn, x)
    assert dict(tr.syncs) == want, dict(tr.syncs)




def test_eval_and_inference_traces_clean(audit_graph):
    fs, rec = TR.audit_eval(audit_graph, TR.Variant("fullgraph", True),
                            device="cpu")
    assert not F.gating(fs) and rec["n_ops"] > 0
    fs, recs = TR.audit_inference(audit_graph, device="cpu")
    assert not F.gating(fs) and len(recs) == 2


@pytest.mark.parametrize("make,detail,severity", [
    (FX.make_f64_fn, "float64", "error"),
    (FX.make_round_trip_fn, "round trip", "warning"),
])
def test_planted_trace_hazards_are_flagged(make, detail, severity):
    fn, arg = make()
    _, tr, _, _ = TR.traced(fn, arg("cpu"))
    fs = TR.walk_hazards(tr, "fixture", "cpu")
    assert any(f.severity == severity and detail in f.detail for f in fs), \
        [str(f) for f in fs]


def test_constant_fixture_refuses_the_cpu():
    with pytest.raises(ValueError, match="needs the card"):
        FX.run_fixture("constant", "cpu")


def test_host_table_on_a_card_op_is_an_error():
    """The walk's card rule on a recorded trace: a 16 KiB host input of a
    card op (here written into the record, as the CPU cannot run one)."""
    tr = TR.OpTrace()
    tr.host_inputs.append("aten._to_copy (4096,) torch.float32 (16384 B)")
    (f,) = TR.walk_hazards(tr, "fixture:constant", "cuda")
    assert f.severity == "error" and "host tensor" in f.detail
    assert TR.walk_hazards(tr, "fixture:constant", "cpu") == []


# ---------------------------------------------------------------------------
# fixtures and the CLI
# ---------------------------------------------------------------------------

def _cli(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src"), env.get("PYTHONPATH", "")])
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           *args], cwd=REPO, capture_output=True, text=True,
                          env=env, timeout=300)


@pytest.mark.parametrize("name", ["thread", "f64", "kernel"])
def test_cli_fixture_exits_nonzero(name):
    out = _cli("--device", "cpu", "--fixture", name)
    assert out.returncode == 1, out.stdout + out.stderr
    assert "error(s)" in out.stdout


def test_cli_clean_tree_exits_zero():
    out = _cli("--device", "cpu", "--no-cache")
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "0 error(s), 0 warning(s)" in out.stdout
    assert "variants traced: 18" in out.stdout


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _cli("--fixture", "thread")
    assert out.returncode != 0 and "torch.cuda.is_available" in out.stderr
