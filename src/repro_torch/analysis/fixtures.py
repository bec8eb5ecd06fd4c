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
  SM's 65,536 registers.  (Its planned card half, a kernel with an
  out-of-bounds read and a shared-memory race that ``compute-sanitizer``
  must flag, waits for a sanitizer that runs on the H100: ROADMAP.)
"""
from __future__ import annotations

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
# runners — shared by ``python -m repro_torch.analysis --fixture`` and the
# tests
# ---------------------------------------------------------------------------

FIXTURES = ("thread", "f64", "constant", "kernel")


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
