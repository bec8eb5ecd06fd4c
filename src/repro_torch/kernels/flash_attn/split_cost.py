"""What the three-term TF32 split costs the f32 flash kernel, and the
ceiling ``mma.sync`` sets it.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attn.split_cost

Needs one CUDA card and ``nvcc``.  Builds, into the ignored ``_build/``,
copies of ``csrc/flash_attn.cu`` beside the library as it is:

* ``small_unrounded``: the small part of each operand passed on as
  ``x - big`` without its own rounding (the tensor core then drops its
  13 low bits: truncation, not cvt.rna), two integer instructions fewer
  a value;
* ``kv_unsplit``: K and V passed to the tensor core as they are, with no
  split and no small(K) / small(V) product: two products instead of
  three and no K/V split.  Its output is not f32-accurate (plain TF32 in
  K and V) and is only timed;
* ``fresh_accumulators``: each three-term product (one 8-wide k-step)
  summed in registers that start at 0 and then added to S or O in f32,
  instead of accumulated into them on the tensor core, whose f32
  accumulation of a small addend into a large sum is not rounded to
  nearest;

and a kernel that issues nothing but independent ``mma.sync`` m16n8k8
TF32 instructions, whose rate is the most any kernel built on them can
reach.  Times each copy with CUDA events, in turns (as is, copies, copies
in reverse, as is), at the f32 rows of the kernel table: gemma3-12b's
prefill (B 2, S 4096, Hq 16, Hkv 8, D 256, windows 0 and 1024) and
zamba2-7b's (B 2, S 4096, Hq = Hkv = 32, D 112), reads the max abs error
of the kernel as is, of ``fresh_accumulators`` and of the plain version
against attention in float64, and prints one JSON line per shape and one
for the ``mma.sync`` rate, with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
import sys

import torch

from repro_torch.kernels.build import Library, build_all
from repro_torch.kernels.flash_attn import build as fa_build
from repro_torch.kernels.flash_attn import ops as fa

SMALL = "      small[i] = to_tf32(x[i] - __uint_as_float(big[i]));\n"
SPLIT_K = "          Sp::of(bk, bb, bs);\n"
SPLIT_V = "          Sp::of(bv, bb, bs);\n"
RAW = ("#pragma unroll\n          for (int i = 0; i < 4; ++i) "
       "bb[i] = __float_as_uint({});\n")
MMA3 = ("template <bool A_SMALL, bool B_SMALL>\n"
        "__device__ __forceinline__ void mma3(")
FRESH = r"""
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}
template <bool A_SMALL, bool B_SMALL>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  float t[4];
  if constexpr (A_SMALL) {
    mma0(t, as, bb);
    if constexpr (B_SMALL) mma(t, ab, bs);
    mma(t, ab, bb);
  } else {
    mma0(t, ab, bb);
  }
  for (int i = 0; i < 4; ++i) d[i] += t[i];
}
template <bool A_SMALL, bool B_SMALL>
__device__ __forceinline__ void mma3_accumulated("""
COPIES = {
    "small_unrounded": [(SMALL, SMALL.replace(
        "to_tf32(x[i] - __uint_as_float(big[i]))",
        "__float_as_uint(x[i] - __uint_as_float(big[i]))"))],
    "kv_unsplit": [(SPLIT_K, RAW.format("bk[i]")),
                   (SPLIT_V, RAW.format("bv[i]")),
                   ("mma3<kSmall, kSmall>(", "mma3<kSmall, false>("),
                   ("mma3<true, kSmall>(", "mma3<true, false>(")],
    "fresh_accumulators": [(MMA3, FRESH)],
}
MMA_PEAK = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int ACC>
__global__ void mma_peak(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = threadIdx.x * 3 + i;
  for (int i = 0; i < 2; ++i) b[i] = threadIdx.x * 7 + i;
  float d[ACC][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < ACC; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < ACC; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run_mma_peak(float* out, int blocks, int threads, int iters) {
  mma_peak<16><<<blocks, threads>>>(out, iters);
  return (int)cudaGetLastError();
}
"""
SHAPES = ((2, 4096, 16, 8, 256, 0), (2, 4096, 16, 8, 256, 1024),
          (2, 4096, 32, 32, 112, 0))


def _declare_forward(lib):
    fn = lib.flash_attn_forward
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int


def _declare_peak(lib):
    lib.run_mma_peak.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3
    lib.run_mma_peak.restype = ctypes.c_int


def _copy(name: str, files: dict, declare) -> Library:
    """A library under ``_build/<name>/`` built from ``files``."""
    pkg = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(pkg, "_build", name)
    os.makedirs(os.path.join(root, "csrc"), exist_ok=True)
    for fname, text in files.items():
        with open(os.path.join(root, "csrc", fname), "w") as f:
            f.write(text)
    return Library(root, f"flash_{name}", declare)


def libraries() -> dict:
    pkg = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(pkg, "csrc", "flash_attn.cu")) as f:
        src = f.read()
    libs = {}
    for name, edits in COPIES.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"flash_attn.cu no longer has {old!r}: "
                                 f"update this script")
            text = text.replace(old, new)
        libs[name] = _copy(name, {"flash_attn.cu": text}, _declare_forward)
    libs["mma_peak"] = _copy("mma_peak", {"mma_peak.cu": MMA_PEAK},
                             _declare_peak)
    return libs


def attention_f64(q, k, v, window: int) -> torch.Tensor:
    """Causal (window) attention in float64, one (batch, head) at a
    time."""
    b, s, hq, d = q.shape
    g = hq // k.shape[2]
    pos = torch.arange(s, device=q.device)
    keep = pos[None, :] <= pos[:, None]
    if window:
        keep &= pos[None, :] > pos[:, None] - window
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    for bi in range(b):
        for h in range(hq):
            sc = (q[bi, :, h].double() @ k[bi, :, h // g].double().T
                  / math.sqrt(d)).masked_fill(~keep, -math.inf)
            out[bi, :, h] = torch.softmax(sc, -1) @ v[bi, :, h // g].double()
    return out


def time_ms(fn, iters=10) -> float:
    for _ in range(2):
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
    libs = libraries()
    build_all([fa_build.LIBRARY, *libs.values()])
    forward = {"as_is": fa_build.load_library().flash_attn_forward}
    forward.update({n: libs[n].load().flash_attn_forward for n in COPIES})
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for b, s, hq, hkv, d, w in SHAPES:
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device=dev)
                   for h in (hq, hkv, hkv))
        out = torch.empty_like(q)

        def run(fn):
            err = fn(0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), b, s, hq, hkv, d, w, 1.0 / math.sqrt(d),
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")
        order = list(forward) + list(reversed(forward))
        ms = {n: [] for n in forward}
        for n in order:
            ms[n].append(time_ms(lambda: run(forward[n])))
        want = attention_f64(q, k, v, w)
        err = {"plain": float((fa.flash_attention(q, k, v, window=w)
                               .double() - want).abs().max())}
        for n in ("as_is", "fresh_accumulators"):
            run(forward[n])
            err[n] = float((out.double() - want).abs().max())
        del want
        print(json.dumps({
            "shape": f"f32 B={b} S={s} Hq={hq} Hkv={hkv} D={d} window={w}",
            "ms": ms, "max_abs_err_vs_f64": err, "card": card}), flush=True)
    peak = libs["mma_peak"].load()
    blocks, threads, iters = 132 * 8, 512, 2000
    buf = torch.empty(blocks * threads, device=dev)
    ms = time_ms(lambda: peak.run_mma_peak(buf.data_ptr(), blocks, threads,
                                           iters), 3)
    flops = 2 * 16 * 8 * 8 * 16 * iters * blocks * threads // 32
    print(json.dumps({"mma_sync_tf32_tflops": flops / ms / 1e9,
                      "tf32_peak_tflops": 495.0, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
