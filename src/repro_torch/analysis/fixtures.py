"""Deliberately broken inputs for the ``repro_torch.analysis`` checkers.

Each fixture seeds exactly one hazard class and is used from two places:
``python -m repro_torch.analysis --fixture <name>`` (must exit nonzero —
the self-test that the gate gates) and ``tests/test_torch_analysis.py``
(asserts the specific finding).

* ``thread`` (CPU) — a class whose worker thread and main thread both
  rebind one attribute (the reference's ``BROKEN_THREAD_SRC``).
* ``f64`` (CPU) — a torch step that widens to float64.
* ``constant`` (card) — a step that uploads a 4,096-element numpy table
  on every call; on the CPU there is no upload to see, so it refuses to
  run there.
* ``kernel`` (CPU) — ``cuobjdump -res-usage`` text for the tensor-core
  flash kernel at 200 registers a thread: 200 x 384 threads overflow the
  SM's 65,536 registers.  (A kernel with an out-of-bounds read that
  ``compute-sanitizer``'s memcheck must flag waits for a sanitizer that
  runs on the H100: ROADMAP.)
* ``pipeline`` (card and CPU; the reference's ``dma`` fixture) — three
  planted pipeline faults (``fixtures_csrc/pipeline_faults.cu``): an
  mbarrier ring whose producer skips its wait on ``empty``, the same
  ring whose last fill is one box short of its ``expect_tx`` (a timeout
  of the checked build's bounded wait), and a ``cp.async`` double buffer
  refilled with no barrier after the last read.  On the card the
  kernels run and log; on the CPU the checker reads the logs the same
  kernels write, built by ``fault_ring_log`` / ``fault_cp_async_log``.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

#: elements of the uploaded table: 16 KiB of f32, past HOST_CONST_BYTES
CAPTURED_TABLE_ELEMS = 4096


def make_constant_upload_fn():
    """-> (fn, example arg factory): ``fn`` uploads a 16 KiB host
    ``np.ndarray`` into every call — the trace checker must report the
    host tensor fed to a card op."""
    table = np.arange(CAPTURED_TABLE_ELEMS, dtype=np.float32)

    def step(x):
        return x * 2.0 + torch.as_tensor(table).to(x.device)

    return step, (lambda dev: torch.ones(CAPTURED_TABLE_ELEMS, device=dev))


def make_f64_fn():
    """-> (fn, example arg factory): widens to float64."""

    def f(x):
        return x.to(torch.float64) * 2.0

    return f, (lambda dev: torch.ones(8, device=dev))


def make_round_trip_fn():
    """-> (fn, example arg factory): casts f32 -> bf16 -> f32 on the
    cast's direct output (a wasted pass the trace checker warns about)."""

    def f(x):
        return x.to(torch.bfloat16).to(torch.float32) + 1.0

    return f, (lambda dev: torch.ones(8, device=dev))


#: the tensor-core flash kernel at D = 256 compiled to 200 registers a
#: thread (the layout of ``cuobjdump -res-usage`` on the H100's build)
OVER_REGISTER_RES_USAGE = """\

Fatbin elf code:
================
arch = sm_90a
code version = [1,7]
host = linux
compile_size = 64bit

Resource usage:
 Common:
  GLOBAL:0
 Function _ZN52_GLOBAL__N__7eab6371_19_flash_attn_wgmma_cu_364b44bc23flash_attn_wgmma_kernelILi256EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16iiiif:
  REG:200 STACK:0 SHARED:1024 LOCAL:0 CONSTANT[0]:988 TEXTURE:0 SURFACE:0 SAMPLER:0
"""


# ---------------------------------------------------------------------------
# thread: shared attribute written from both sides
# ---------------------------------------------------------------------------

#: a worker thread and the main thread both rebind ``self.count``
#: without any lock/queue discipline — the thread checker must emit an
#: error for ``fixture_mod.LossyCounter.count``
BROKEN_THREAD_SRC = '''\
import threading


class LossyCounter:
    def __init__(self):
        self._thread = None
        self.count = 0

    def start(self):
        self._thread = threading.Thread(target=self._run)
        self._thread.start()

    def _run(self):
        while True:
            self.count = self.count + 1

    def reset(self):
        self.count = 0
'''


# ---------------------------------------------------------------------------
# pipeline: three planted faults of the asynchronous pipelines
# ---------------------------------------------------------------------------

#: tiles each planted kernel walks
FAULT_TILES = 6
#: the planted kernels by fixture site: (entry, ring mode, spec kernel)
PIPELINE_FAULTS = {
    "ring_skip_empty_wait": ("pipeline_fault_ring", 0, "fixture_ring"),
    "ring_short_copy": ("pipeline_fault_ring", 1, "fixture_ring"),
    "cp_async_no_barrier": ("pipeline_fault_cp_async", None,
                            "fixture_cp_async"),
}


def _fault_const(name: str) -> int:
    from repro_torch.analysis import kernel_audit as KA
    return KA.SOURCE_CONSTANTS[KA.FAULTS_SRC][name]


class _LogBuilder:
    """Records in the order a run of the kernel could log them."""

    def __init__(self):
        self.events = []

    def __call__(self, actor, kind, obj=-1, stage=-1, parity=-1, nbytes=0,
                 tile=-1):
        from repro_torch.analysis.kernel_audit import PcEvent
        self.events.append(PcEvent(len(self.events), actor, kind, obj, stage,
                                   parity, nbytes, tile))


def fault_ring_log(n_tiles: int = FAULT_TILES, fault=None) -> list:
    """The log ``pipeline_faults.cu``'s ``ring_kernel`` writes: ``fault``
    None (the correct ring), "skip_empty_wait" (mode 0: the producer
    re-arms a stage once its own copy landed, racing ahead of the
    consumers) or "short_copy" (mode 1: the last fill one box short, so
    the consumers' wait on it times out)."""
    n_st, n_c = _fault_const("kStages"), _fault_const("kConsumerWarps")
    box = 4 * _fault_const("kBoxFloats")
    boxes = _fault_const("kBoxes")
    stage = boxes * box
    sk, bar = 1024, 1024 + n_st * stage          # shared addresses
    full = lambda st: bar + 8 * st                 # noqa: E731
    empty = lambda st: bar + 8 * (2 * n_st + st)   # noqa: E731
    log, prod = _LogBuilder(), n_c
    log(0, "layout", -1, sk, -1, bar, stage)
    for st in range(n_st):
        log(0, "init", full(st), nbytes=1)
        log(0, "init", empty(st), nbytes=n_c)

    def fill(it):
        st, ph = it % n_st, (it // n_st) & 1
        if fault != "skip_empty_wait":
            log(prod, "wait", empty(st), parity=ph ^ 1)
        elif it >= n_st:
            log(prod, "wait", full(st), parity=ph ^ 1)
        log(prod, "expect_tx", full(st), nbytes=stage)
        short = fault == "short_copy" and it == n_tiles - 1
        for p in range(boxes - 1 if short else boxes):
            log(prod, "tma", full(st), sk + st * stage + p * box,
                nbytes=box)

    ahead = n_tiles if fault == "skip_empty_wait" else min(n_st, n_tiles)
    for it in range(ahead):
        fill(it)
    for it in range(n_tiles):
        st = it % n_st
        for c in range(n_c):
            gave_up = fault == "short_copy" and it == n_tiles - 1
            log(c, "timeout" if gave_up else "wait", full(st),
                parity=(it // n_st) & 1)
            log(c, "read", sk + st * stage, tile=it)
            log(c, "arrive", empty(st))
        if it + n_st >= ahead and it + n_st < n_tiles:
            fill(it + n_st)
    return log.events


def fault_cp_async_log(n_tiles: int = FAULT_TILES, barrier: bool = False
                       ) -> list:
    """The log ``pipeline_faults.cu``'s ``cp_async_kernel`` writes; with
    ``barrier`` the log of the correct kernel, which has a
    ``__syncthreads`` after each tile's reads."""
    warps = _fault_const("kCpThreads") // 32
    bufs = (1024, 1024 + 4 * _fault_const("kCpFloats"))
    log = _LogBuilder()
    log(0, "layout", bufs[0], bufs[1], -1, -1, 0)
    for w in range(warps):
        log(w, "load", bufs[0], tile=0)
        log(w, "commit", tile=0)
    for t in range(n_tiles):
        for w in range(warps):
            if t + 1 < n_tiles:
                log(w, "load", bufs[(t + 1) % 2], tile=t + 1)
                log(w, "commit", tile=t + 1)
                log(w, "wait_group", parity=1, tile=t)
            else:
                log(w, "wait_group", parity=0, tile=t)
        for w in range(warps):
            log(w, "sync", parity=1, tile=t)
        for w in range(warps):
            log(w, "read", bufs[t % 2], tile=t)
        if barrier:
            for w in range(warps):
                log(w, "sync", parity=2, tile=t)
    return log.events


def fault_tiles(name: str):
    """What a planted kernel's block must load: the ring's tiles, or each
    buffer's tiles of the double buffer."""
    if PIPELINE_FAULTS[name][2] == "fixture_ring":
        return FAULT_TILES
    return {"buf0": list(range(0, FAULT_TILES, 2)),
            "buf1": list(range(1, FAULT_TILES, 2))}


def _declare_faults(lib) -> None:
    fn = lib.pipeline_fault_ring
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.pipeline_fault_cp_async
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.pipeline_check_record_bytes.argtypes = []
    lib.pipeline_check_record_bytes.restype = ctypes.c_int


def fault_library():
    """The planted kernels' library (``fixtures_csrc/``, always checked),
    built into ``analysis/_build/`` at first use."""
    from repro_torch.kernels.build import Library
    from repro_torch.kernels.flash_attn import build as fb
    return Library(os.path.dirname(os.path.abspath(__file__)),
                   "pipeline_faults", _declare_faults, csrc="fixtures_csrc",
                   defines=("REPRO_PIPELINE_CHECK",),
                   include_dirs=(os.path.join(os.path.dirname(fb.__file__),
                                              "csrc"),))


def _fault_logs_on_card(dev) -> dict:
    """{site name: decoded blocks} of each planted kernel's launch."""
    from repro_torch.analysis import kernel_audit as KA
    lib = fault_library().load()
    if lib.pipeline_check_record_bytes() != 4 * len(KA.PC_FIELDS):
        raise RuntimeError("the fault library's log records are not the "
                           "decoder's")
    src = torch.randn(FAULT_TILES * 4 * _fault_const("kCpFloats"),
                      device=dev)
    out = torch.zeros(1024, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    logs = {}
    for name, (entry, mode, _) in PIPELINE_FAULTS.items():
        log = torch.zeros((KA.PC_CAP + 1) * len(KA.PC_FIELDS),
                          dtype=torch.int32, device=dev)
        args = (src.data_ptr(), out.data_ptr(), FAULT_TILES, log.data_ptr(),
                KA.PC_CAP, stream)
        err = getattr(lib, entry)(*((mode,) if mode is not None else ()),
                                  *args)
        if err != 0:
            raise RuntimeError(f"planted kernel {name} failed to launch: "
                               f"error {err}")
        torch.cuda.synchronize(dev)
        logs[name] = KA.decode_pipeline_log(log.cpu().numpy(), KA.PC_CAP)
    return logs


def run_pipeline_fixture(device="cpu") -> list:
    """The planted faults through ``check_pipeline_log``: run on the card
    (a CUDA ``device``), or the logs the kernels write read on the CPU.
    Every kernel must be flagged; its findings' sites name it."""
    from repro_torch.analysis import kernel_audit as KA
    dev = torch.device(device)
    if dev.type == "cuda":
        logs = _fault_logs_on_card(dev)
    else:
        models = {"ring_skip_empty_wait": fault_ring_log(
                      fault="skip_empty_wait"),
                  "ring_short_copy": fault_ring_log(fault="short_copy"),
                  "cp_async_no_barrier": fault_cp_async_log()}
        logs = {name: [{"block": 0, "taken": len(ev), "overflow": False,
                        "events": ev, "torn": []}]
                for name, ev in models.items()}
    out = []
    for name, blocks in logs.items():
        out += KA.check_pipeline_log(
            blocks, KA.pipeline_spec(PIPELINE_FAULTS[name][2]),
            tiles=lambda _b, n=name: fault_tiles(n),
            site=f"kernel:pipeline:fixture:{name}")
    return out


# ---------------------------------------------------------------------------
# runners — shared by ``python -m repro_torch.analysis --fixture`` and the
# tests
# ---------------------------------------------------------------------------

FIXTURES = ("thread", "f64", "constant", "kernel", "pipeline")


def run_fixture(name: str, device="cpu"):
    """Run one seeded-broken fixture through its checker on ``device``.
    -> list[Finding]; the caller asserts / gates on non-emptiness."""
    from repro_torch.analysis import kernel_audit, thread_audit
    from repro_torch.analysis import trace_audit as T
    from repro_torch.device import resolve_device

    if name == "thread":
        return thread_audit.analyze_source(BROKEN_THREAD_SRC, "fixture_mod")
    if name == "kernel":
        return kernel_audit.audit_resources(
            kernel_audit.parse_res_usage(OVER_REGISTER_RES_USAGE))[0]
    dev = resolve_device(device)
    if name == "pipeline":
        return run_pipeline_fixture(dev)
    if name == "f64":
        fn, arg = make_f64_fn()
    elif name == "constant":
        if dev.type != "cuda":
            raise ValueError("the constant fixture needs the card: on the "
                             "CPU no table is uploaded, so nothing shows")
        fn, arg = make_constant_upload_fn()
    else:
        raise ValueError(f"unknown fixture {name!r} "
                         f"(expected one of {'|'.join(FIXTURES)})")
    _, tr, _, _ = T.traced(fn, arg(dev), device=dev)
    return T.walk_hazards(tr, f"fixture:{name}", dev)
