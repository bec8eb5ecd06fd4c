"""The port's pipeline check (``kernel_audit`` part 4: the checked build's
event logs held to the pairing rules), the counterpart of the reference's
DMA/semaphore pairing check (``repro.analysis.pallas_audit``'s
``simulate_dma_pairing`` / ``_check_pane``), on the CPU:

* the logs the checked build wrote on the card
  (``tests/data/pipeline_logs.npz``, ``kernel_audit.record_pipeline_logs``:
  two blocks of each flash kernel at D = 64, S = 64 and 320, window 0 and
  96) pass the checker;
* mutated copies of them are flagged, one case a fault class, each by its
  own rule and finding text;
* the record decoder on canned bytes; the builder's digest of a checked
  library against a normal one;
* the ``pipeline`` fixture's CPU half (the logs its three planted kernels
  write) and its CLI, and beside it the reference's ``dma`` fixture under
  the reference's check: both flag the copy left in flight at the tile's
  end.

The card's half (the checked launches, their bit-equality with the normal
build, the planted kernels) runs in ``chip_smoke.py`` phase 15.  The
checks are exact: findings are matched by rule and text, no tolerance
applies.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.analysis import fixtures as RFX
from repro.analysis import pallas_audit as RPA
from repro_torch.analysis import findings as F
from repro_torch.analysis import fixtures as FX
from repro_torch.analysis import kernel_audit as KA
from repro_torch.kernels.build import Library
from repro_torch.kernels.flash_attn import build as fb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGS = os.path.join(REPO, "tests", "data", "pipeline_logs.npz")


@pytest.fixture(scope="module")
def logs():
    return KA.load_pipeline_logs(LOGS)


def _rules(findings):
    return {f.site.rsplit(":", 1)[1] for f in findings}


def _block(events):
    return {"block": 0, "taken": len(events), "overflow": False,
            "events": list(events), "torn": []}


# ---------------------------------------------------------------------------
# the card's logs
# ---------------------------------------------------------------------------

def test_committed_logs_are_the_recorded_cases(logs):
    assert [lg["case"] for lg in logs] == list(KA.RECORDED_CASES)
    for lg in logs:
        assert len(lg["blocks"]) == 2
        assert len(lg["digest"]) == 16 and int(lg["digest"], 16) >= 0
        kinds = {e.kind for b in lg["blocks"] for e in b["events"]}
        if lg["case"].kernel == "wgmma":
            assert kinds == {"layout", "init", "expect_tx", "tma", "wait",
                             "arrive", "mma_commit", "mma_retire"}
        else:
            assert kinds == {"layout", "load", "commit", "wait_group",
                             "sync", "read"}


@pytest.mark.parametrize("i", range(len(KA.RECORDED_CASES)))
def test_committed_log_passes(logs, i):
    lg = logs[i]
    assert KA.check_case_log(lg["case"], lg["blocks"]) == []
    # the block ids are the launch's: the band each block walked is the
    # kernel's formula's
    case = lg["case"]
    for blk in lg["blocks"]:
        want = KA.pipeline_block_tiles(case, blk["block"])
        if case.kernel == "wgmma":
            fills = [e for e in blk["events"]
                     if e.kind == "expect_tx" and e.bytes == 64 * 64 * 2]
            assert len(fills) == 2 * want          # K and V a tile
        else:
            loads = [e.tile for e in blk["events"]
                     if e.kind == "load" and e.actor == 0]
            assert sorted(loads) == sorted(want["Q"] + want["K"]
                                           + want["V"])


def _first(events, pred):
    return next(i for i, e in enumerate(events) if pred(e))


def _drop(events, i):
    return events[:i] + events[i + 1:]


def _swap_seq(events, i, j):
    out = list(events)
    out[i], out[j] = (events[i]._replace(seq=events[j].seq),
                      events[j]._replace(seq=events[i].seq))
    return out


def _ring_consumers():
    return KA.pipeline_spec("wgmma").consumers


def _dropped_wait(ev):
    prod = _ring_consumers()
    return _drop(ev, _first(ev, lambda e: e.kind == "wait"
                            and e.actor == prod))


def _wrong_parity(ev):
    i = _first(ev, lambda e: e.kind == "wait" and e.actor == 0)
    return ev[:i] + [ev[i]._replace(parity=1 - ev[i].parity)] + ev[i + 1:]


def _short_expect_tx(ev):
    i = _first(ev, lambda e: e.kind == "expect_tx")
    box = [e.bytes for e in ev if e.kind == "tma"][0]
    return ev[:i] + [ev[i]._replace(bytes=ev[i].bytes - box)] + ev[i + 1:]


def _dropped_arrival(ev):
    return _drop(ev, _first(ev, lambda e: e.kind == "arrive"))


def _early_arrival(ev):
    # a consumer's arrival moved before the retire of the wgmma that read
    # the stage
    last = {}
    for i, e in enumerate(ev):
        if e.kind == "arrive" and e.actor in last \
                and ev[last[e.actor]].kind == "mma_retire":
            return _swap_seq(ev, last[e.actor], i)
        last[e.actor] = i
    raise AssertionError("no arrival after a retire")


def _timeout(ev):
    i = _first(ev, lambda e: e.kind == "wait" and e.actor == 0)
    return ev[:i] + [ev[i]._replace(kind="timeout")] + ev[i + 1:]


def _read_before_wait_group(ev):
    return _drop(ev, _first(ev, lambda e: e.kind == "wait_group"
                            and e.actor == 0))


def _refill_without_barrier(ev):
    # warp 0 issues its first K refill before the barrier after the reads
    i = _first(ev, lambda e: e.kind == "sync" and e.actor == 0
               and e.parity == 2)
    j = next(k for k in range(i + 1, len(ev))
             if ev[k].kind == "load" and ev[k].actor == 0)
    return _swap_seq(ev, i, j)


def _in_flight_at_exit(ev):
    i = max(k for k, e in enumerate(ev) if e.kind == "wait_group"
            and e.actor == 0)
    return _drop(ev, i)


#: fault class -> (kernel it applies to or None for both, mutation of a
#: block's events or None for the overflow flag, rule, finding text)
MUTATIONS = {
    "dropped_wait": ("wgmma", _dropped_wait, "dropped_wait",
                     "a dropped wait"),
    "wrong_parity": ("wgmma", _wrong_parity, "parity",
                     "completes the phase of parity"),
    "short_expect_tx": ("wgmma", _short_expect_tx, "bytes",
                        "the phase completes before its last box lands"),
    "dropped_arrival": ("wgmma", _dropped_arrival, "arrivals",
                        "arrivals at exit"),
    "early_arrival": ("wgmma", _early_arrival, "arrive_in_flight",
                      "the producer may refill the stage under it"),
    "timeout": ("wgmma", _timeout, "timeout", "timed out"),
    "full_log": (None, None, "overflow", "log is full"),
    "read_before_wait_group": ("tf32x3", _read_before_wait_group,
                               "read_before_wait",
                               "a read needs every warp's wait_group"),
    "refill_without_barrier": ("tf32x3", _refill_without_barrier,
                               "refill_race", "a write-after-read race"),
    "in_flight_at_exit": ("tf32x3", _in_flight_at_exit, "in_flight",
                          "in flight at block exit"),
}


@pytest.mark.parametrize("fault", sorted(MUTATIONS))
def test_mutated_log_is_flagged(logs, fault):
    kernel, mutate, rule, text = MUTATIONS[fault]
    hit = 0
    for lg in logs:
        case = lg["case"]
        if kernel not in (None, case.kernel):
            continue
        for blk in lg["blocks"]:
            bad = dict(blk, events=sorted(blk["events"],
                                          key=lambda e: e.seq))
            if mutate is None:
                bad["overflow"] = True
            else:
                bad["events"] = mutate(bad["events"])
            fs = KA.check_case_log(case, [bad])
            assert F.gating(fs) == fs and rule in _rules(fs), \
                (case.name, fault, [str(f) for f in fs])
            assert any(text in f.detail for f in fs
                       if f.site.endswith(":" + rule)), (case.name, fault)
            # the untouched twin stays clean
            assert KA.check_case_log(case, [blk]) == []
            hit += 1
    assert hit >= 8


# ---------------------------------------------------------------------------
# the decoder and the builder
# ---------------------------------------------------------------------------

def test_decoder_on_canned_bytes():
    cap, nf = 3, len(KA.PC_FIELDS)
    raw = np.zeros((3, cap + 1, nf), np.int32)
    # block 0: two records, written out of order in memory by seq
    raw[0, 0, :2] = (2, 0)
    raw[0, 1] = (0, 0, 1, 1024, 2048, 3072, 4096, 128)   # layout
    raw[0, 2] = (1, 8, 3, 4096, -1, -1, 16384, -1)       # expect_tx
    # block 1: five records asked for, three kept, the flag raised
    raw[1, 0, :2] = (5, 1)
    for i in range(cap):
        raw[1, 1 + i] = (i, 2, 13, -1, -1, 1, 0, i)      # sync
    # block 2: two taken, the second slot never written
    raw[2, 0, :2] = (2, 0)
    raw[2, 1] = (0, 0, 10, 1024, -1, -1, 0, 3)           # load
    blocks = KA.decode_pipeline_log(raw, cap)
    assert [b["block"] for b in blocks] == [0, 1, 2]
    b0, b1, b2 = blocks
    assert b0["taken"] == 2 and not b0["overflow"] and b0["torn"] == []
    assert b0["events"] == [
        KA.PcEvent(0, 0, "layout", 1024, 2048, 3072, 4096, 128),
        KA.PcEvent(1, 8, "expect_tx", 4096, -1, -1, 16384, -1)]
    assert b1["overflow"] and b1["taken"] == 5
    assert [e.kind for e in b1["events"]] == ["sync"] * 3
    assert b2["torn"] == [1] and [e.kind for e in b2["events"]] == ["load"]
    # from the bytes as the card leaves them
    again = KA.decode_pipeline_log(
        np.frombuffer(raw.tobytes(), np.int32), cap)
    assert again == blocks
    # a full or torn block is reported, not checked
    fs = KA.check_pipeline_log(blocks[1:], KA.pipeline_spec("tf32x3", 64))
    assert _rules(fs) == {"overflow", "torn"}


def test_record_layout_matches_the_header():
    src = open(os.path.join(os.path.dirname(fb.__file__), "csrc",
                            "pipeline_check.cuh")).read()
    kinds = src[src.index("enum Kind"):src.index("};", src.index(
        "enum Kind"))]
    names = [ln.strip().split()[0].rstrip(",").split("=")[0].strip()
             for ln in kinds.splitlines()[1:] if ln.strip().startswith("k")]
    assert [n[1:].lower() for n in names] == [
        k.replace("_", "") for k in KA.PC_KINDS]
    assert "constexpr int kFields = 8;" in src
    assert len(KA.PC_FIELDS) == 8


def _decl(lib):
    pass


def test_checked_library_digest_differs_and_is_stable(tmp_path):
    assert fb.CHECKED.path() != fb.LIBRARY.path()
    assert fb.CHECKED.path() == fb.CHECKED.path()
    assert os.path.dirname(fb.CHECKED.path()) == os.path.dirname(
        fb.LIBRARY.path())
    assert "REPRO_PIPELINE_CHECK" in fb.CHECKED.defines
    pkg = os.path.dirname(fb.__file__)
    normal = Library(pkg, "flash_attn", _decl)
    checked = Library(pkg, "flash_attn", _decl,
                      defines=fb.CHECKED.defines)
    assert normal.path() == fb.LIBRARY.path()
    assert checked.path() != normal.path()
    assert Library(pkg, "flash_attn", _decl,
                   defines=fb.CHECKED.defines).path() == checked.path()
    # one define more or less is another library
    assert Library(pkg, "flash_attn", _decl,
                   defines=fb.CHECKED.defines[:1]).path() != checked.path()


def test_include_dirs_enter_the_digest_by_their_headers(tmp_path):
    inc = os.path.join(os.path.dirname(fb.__file__), "csrc")
    digests = []
    for name in ("a", "b"):
        pkg = tmp_path / name
        (pkg / "fixtures_csrc").mkdir(parents=True)
        (pkg / "fixtures_csrc" / "k.cu").write_text("// k\n")
        copy = tmp_path / (name + "_inc")
        copy.mkdir()
        for h in ("pipeline_check.cuh", "wgmma.cuh"):
            (copy / h).write_text(open(os.path.join(inc, h)).read())
        lib = Library(str(pkg), "faults", _decl, csrc="fixtures_csrc",
                      include_dirs=(str(copy),))
        assert lib.flags()[-1] == f"-I{copy}"
        digests.append(os.path.basename(lib.path()))
    assert digests[0] == digests[1]                # not by their paths
    (tmp_path / "b_inc" / "wgmma.cuh").write_text("// edited\n")
    lib = Library(str(tmp_path / "b"), "faults", _decl,
                  csrc="fixtures_csrc",
                  include_dirs=(str(tmp_path / "b_inc"),))
    assert os.path.basename(lib.path()) != digests[0]
    assert os.path.basename(FX.fault_library().path()).startswith(
        "libpipeline_faults_")


def test_checked_build_compiles_the_cases_head_dims():
    masks = dict(d.split("=") for d in fb.CHECKED.defines if "=" in d)
    assert set(masks) == set(fb.CHECKED_DIMS)
    for key, dims in fb.CHECKED_DIMS.items():
        # PC_BUILT(mask, d): bit d / 16
        built = {d for d in KA.FLASH_HEAD_DIMS
                 if int(masks[key]) >> (d // 16) & 1}
        assert built == set(dims)
    need = {("PC_WGMMA_DIMS" if c.kernel == "wgmma" else
             "PC_F32_DIMS" if c.dtype == "float32" else "PC_BF16_DIMS", c.d)
            for c in KA.pipeline_cases()}
    assert need == {(k, d) for k, ds in fb.CHECKED_DIMS.items() for d in ds}


def test_pipeline_cases_cover_both_kernels():
    cases = KA.pipeline_cases()
    assert len(cases) == len(set(cases)) == 57
    wg = [c for c in cases if c.kernel == "wgmma"]
    tf = [c for c in cases if c.kernel == "tf32x3"]
    assert {(c.d, c.s, c.window) for c in wg} == {
        (d, s, w) for d in (64, 112, 256) for s in (64, 128, 320, 200)
        for w in (0, 96)}
    assert {c.dtype for c in wg} == {"bfloat16"}
    assert {(c.d, c.s, c.window) for c in tf if c.dtype == "float32"} == {
        (d, s, w) for d in (16, 32, 64, 256) for s in (64, 128, 320, 200)
        for w in (0, 96)}
    assert [c for c in tf if c.dtype == "bfloat16"] == [
        KA.PipelineCase("tf32x3", "bfloat16", 64, 320, 96)]
    assert all((c.b, c.hq, c.hkv) == (1, 4, 2) for c in cases)
    # at most a few dozen blocks a case, each logged in full
    assert max(KA.pipeline_grid(c) for c in cases) == 12


@pytest.mark.parametrize("kernel,s,window,block,want", [
    ("wgmma", 64, 0, 0, 1), ("wgmma", 128, 0, 0, 2),
    ("wgmma", 320, 0, 0, 5), ("wgmma", 320, 0, 8, 2),
    ("wgmma", 320, 96, 0, 3), ("wgmma", 200, 96, 0, 4),
    ("tf32x3", 320, 96, 0, (2, 5, 9)), ("tf32x3", 200, 96, 0, (1, 1, 6)),
    ("tf32x3", 64, 0, 3, (0, 0, 1)), ("tf32x3", 320, 0, 11, (0, 0, 3)),
])
def test_block_tiles_follow_the_kernels_band(kernel, s, window, block, want):
    case = KA.PipelineCase(kernel, "float32", 64, s, window)
    got = KA.pipeline_block_tiles(case, block)
    if kernel == "wgmma":
        assert got == want
    else:
        qi, lo, hi = want
        assert got == {"Q": [qi], "K": list(range(lo, hi + 1)),
                       "V": list(range(lo, hi + 1))}


def test_specs_read_the_source_constants():
    assert KA.SOURCE_CONSTANTS[KA.WGMMA_SRC]["kConsumerWarps"] == 8
    assert KA.audit_sources() == []
    assert KA.pipeline_spec("wgmma") == KA.PipelineSpec(
        "ring", stages=2, consumers=8)
    assert KA.pipeline_spec("tf32x3", 64).warps == 4
    assert KA.pipeline_spec("tf32x3", 256).warps == 8
    assert KA.pipeline_spec("fixture_ring").consumers == 2
    with pytest.raises(ValueError):
        KA.pipeline_spec("row")


def test_run_pipeline_check_refuses_the_cpu():
    with pytest.raises(ValueError, match="on the card"):
        KA.run_pipeline_check("wgmma", KA.pipeline_cases()[0], "cpu")


# ---------------------------------------------------------------------------
# the pipeline fixture, and the reference's dma fixture beside it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,rules", [
    ("ring_skip_empty_wait", {"dropped_wait", "rearm"}),
    ("ring_short_copy", {"timeout", "bytes", "in_flight"}),
    ("cp_async_no_barrier", {"refill_race"}),
])
def test_pipeline_fixture_flags_each_planted_kernel(name, rules):
    fs = F.gating(FX.run_fixture("pipeline", "cpu"))
    mine = [f for f in fs if f":fixture:{name}:" in f.site]
    assert rules <= _rules(mine), [str(f) for f in mine]


@pytest.mark.parametrize("log,kernel", [
    (FX.fault_ring_log, "fixture_ring"),
    (lambda: FX.fault_cp_async_log(barrier=True), "fixture_cp_async"),
])
def test_planted_kernels_without_their_fault_pass(log, kernel):
    name = {"fixture_ring": "ring_short_copy",
            "fixture_cp_async": "cp_async_no_barrier"}[kernel]
    assert KA.check_pipeline_log(
        [_block(log())], KA.pipeline_spec(kernel),
        tiles=lambda _b: FX.fault_tiles(name)) == []


def test_reference_dma_fixture_and_the_port_flag_the_same_leak():
    # the reference's fixture consumes its last slab unwaited: the copy
    # leaks past the output tile; the port's counterpart is a cp.async
    # group never retired at block exit
    ref = RPA.audit_dma_pairing(RFX.make_unmatched_wait_kernel)
    assert any("never waited within its output tile" in f.detail
               for f in ref)
    ev = FX.fault_cp_async_log(barrier=True)
    last = max(i for i, e in enumerate(ev) if e.kind == "wait_group"
               and e.actor == 0)
    fs = KA.check_pipeline_log(
        [_block(ev[:last] + ev[last + 1:])],
        KA.pipeline_spec("fixture_cp_async"))
    assert "in_flight" in _rules(fs)
    assert any("in flight at block exit" in f.detail for f in fs)


def test_cli_pipeline_fixture_exits_nonzero():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src"), env.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "--device", "cpu", "--fixture", "pipeline"],
                         cwd=REPO, capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 1, out.stdout + out.stderr
    assert "kernel:pipeline:fixture:ring_short_copy" in out.stdout


def test_fault_library_declares_its_entries():
    class Fake:
        def __init__(self):
            for n in ("pipeline_fault_ring", "pipeline_fault_cp_async",
                      "pipeline_check_record_bytes"):
                setattr(self, n, type("Fn", (), {})())
    lib = Fake()
    FX._declare_faults(lib)
    assert lib.pipeline_fault_ring.argtypes[0] is ctypes.c_int
    assert len(lib.pipeline_fault_cp_async.argtypes) == 6
    assert lib.pipeline_check_record_bytes.restype is ctypes.c_int
