"""How much of the tensor-core flash kernel's time its loads take alone.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attn.loads_only

Needs one CUDA card and ``nvcc``.  Builds a copy of
``csrc/flash_attn_wgmma.cu`` whose consumer warpgroups skip both
products and the softmax (they only wait for each K/V tile and release
it, so the producer's TMA ring runs at the pace of the loads alone),
next to the library as it is, into the ignored ``_build/``.  Times both
with CUDA events, in turns (kernel, loads only, loads only, kernel), at
gemma3-12b's prefill shape (bf16, B 2, S 4096, Hq 16, Hkv 8, D 256) and
at D 128, windows 0 and 1024, and prints one JSON line per shape with
the card's name and power limit.  The copy's output is not attention
and is not checked.
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import shutil
import subprocess
import sys

import torch

from repro_torch.kernels.build import Library, build_all
from repro_torch.kernels.flash_attn import build as fa_build
from repro_torch.kernels.flash_attn import ops as fa

# the consumers' branch that runs both products for a tile they need
PRODUCT_BRANCH = "      if (need) {"


def loads_only_library() -> Library:
    pkg = os.path.dirname(os.path.abspath(__file__))
    copy = os.path.join(pkg, "_build", "loads_only")
    os.makedirs(os.path.join(copy, "csrc"), exist_ok=True)
    shutil.copy(os.path.join(pkg, "csrc", "wgmma.cuh"),
                os.path.join(copy, "csrc"))
    with open(os.path.join(pkg, "csrc", "flash_attn_wgmma.cu")) as f:
        src = f.read()
    if src.count(PRODUCT_BRANCH) != 1:
        raise SystemExit(f"flash_attn_wgmma.cu no longer has one "
                         f"{PRODUCT_BRANCH.strip()!r}: update this script")
    with open(os.path.join(copy, "csrc", "flash_attn_wgmma.cu"), "w") as f:
        f.write(src.replace(PRODUCT_BRANCH, "      if (false && need) {"))

    def declare(lib):
        fn = lib.flash_attn_wgmma_forward
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return Library(copy, "flash_attn_loads_only", declare)


def time_ms(fn, iters=20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    copy = loads_only_library()
    build_all([fa_build.LIBRARY, copy])
    lib = copy.load()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for d in (256, 128):
        q, k, v = (torch.randn(2, 4096, h, d, generator=gen,
                               device=dev).bfloat16() for h in (16, 8, 8))
        out = torch.empty_like(q)
        for w in (0, 1024):
            def kernel():
                fa.flash_attention(q, k, v, window=w, use_kernel=True)

            def loads():
                err = lib.flash_attn_wgmma_forward(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), 2, 4096, 16, 8, d, w,
                    1.0 / math.sqrt(d),
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: {err}")
            ts = [time_ms(f) for f in (kernel, loads, loads, kernel)]
            print(json.dumps({
                "shape": f"bf16 B=2 S=4096 Hq=16 Hkv=8 D={d} window={w}",
                "kernel_ms": [ts[0], ts[3]], "loads_only_ms": [ts[1], ts[2]],
                "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
