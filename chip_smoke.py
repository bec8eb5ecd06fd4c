#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (both kernel libraries are built from
the sources in this checkout at first use, one ``nvcc`` per source, all
started together); exits nonzero without a card.  Imports nothing of JAX
or of the reference package ``repro``.

1. Builds the neighbor-aggregation and flash-attention kernel libraries
   (``nvcc``, sm_90a).
2. Tiled-kernel phase: the forward kernel against its plain torch
   version (``neighbor_agg_ref``) — D = 128 and 172, K = 32, B = 65,536,
   f32 and bf16, fused epilogue on and off — plus ragged B/K/D, K = 0,
   an out-of-range id and an all-zero-weight case that must be exactly
   0.  Tolerance: 1e-5 (f32) and 2e-2 (bf16), atol = rtol.
3. Row-kernel phase: ``kernel="row"`` forward and its gradients against
   the plain versions at the same shapes and ragged ones.
4. Backward-kernel phase: every cotangent (dfeats, dw, dself, dw_self)
   against the plain backward (``neighbor_agg_backward_ref``) at the
   same shapes, ragged ones, K = 0 and all-zero weights (dfeats exactly
   0), and at the two training-path shapes with only dfeats asked for,
   as autograd asks there: full-graph layer 2 on the real ELL of the
   524,288-node graph (bf16, D = 172) and mini-batch layer 2 (identity
   ids, B = 8,192, K = 15, D = 256, f32, deterministic).  Tolerance:
   1e-3 (f32; atomics land in no fixed order) and 2e-2 (bf16).
   The reverse-index backward kernel (``neighbor_agg_bwd_csr.cu``,
   dfeats of the full-graph path) on the same inputs, against its plain
   version (``neighbor_agg_backward_csr_ref``) run in f32, row by row
   (``row_rel_err``): at most 1e-5 in f32 at the cell and ragged shapes
   (K = 0, all-zero weights, an out-of-range id left out of the index,
   rows with no edges, which must be exactly 0) and at most 2^-8 (one
   bf16 rounding) in bf16, there and at the full-graph layer-2 shape,
   with the mask weights and with random weights on the same edges;
   the 2e-2 check against the atomic backward's plain version as well.
   Planted faults at that shape (a dropped edge a row, a row's first
   edge twice, every edge's b off by one, random weights in place of the
   mask's) must each break the 2^-8 limit, and two calls must be
   bit-equal.  The index build is timed once and its bytes stated.  The
   tiled forward is timed at the full-graph shape (B = N = 524,288,
   D = 128 and 172, bf16) as well.
   Every timed variant is timed with CUDA events beside its plain
   version, one PyTorch library call (``embedding_bag`` forward, or its
   backward) and the bound; at the full-graph shape the reverse-index
   kernel beside the atomic one, both plain versions and
   ``embedding_bag``'s backward.
5. Training phase at full width: gnn-papers100m (GraphSAGE, feat 128,
   hidden 256, 172 classes, 2 layers, ELL K = 32, bf16 full-graph
   aggregation, kernels on) on a 524,288-node graph through the port's
   ``Trainer``: 5 full-graph GD steps and 20 mini-batch SGD steps at
   b = 8192, fan-out (15, 10), prefetcher on.  The launch counts are
   reset just before and read after each paradigm: the full-graph steps
   must launch the tiled forward and the reverse-index backward once a
   step and the atomic backward never; the mini-batch steps the tiled
   forward and the atomic backward, and the reverse-index kernel never.
   Losses must be finite and the last full-graph loss below the first;
   one step's parameter gradients with the kernels on must match the
   plain path (relative max error 2e-2 for bf16 full-graph, 1e-4 for f32
   mini-batch).  One full-graph step (forward, backward and update) is
   timed with CUDA events with the reverse index and without it (the
   atomic backward), in turns on the same parameters, and traced with
   ``torch.profiler`` (device time by kernel).  The steady ms/step read
   from ``History.times`` spans one step fewer than it divides by (with
   the deferred sync each record is stamped when the next step has
   ended; 3/4 of a step over 5 steps): it is printed as before, for
   comparison with earlier runs.
6. Full-width serving phase on the same graph: ``EmbeddingStore``
   build, 256 queries from 4 client threads through ``GNNServer``, two
   incremental ``update_features`` + ``refresh`` rounds, checked against
   the plain forward (2e-2), the snapshot's argmax and a fresh rebuild.
7. GCN phase (fused epilogue on the path): GCN in f32, hidden 256, at
   n = 65,536, checked against the plain forward at 1e-4.
8. Flash-attention phase: the two CUDA kernels against their plain
   version (``flash_attention_ref``).  Every call goes to the kernel
   ``kernel_route`` names, and the per-kernel launch counts must show
   it: bf16 at D = 64, 128 and 256 on the tensor-core kernel
   (``flash_attn_wgmma.cu``), f32 and D = 16 or 32 on the f32 kernel
   (``flash_attn.cu``).  Cases: gemma3-12b's prefill shape (B = 2,
   S = 4096, Hq = 16, Hkv = 8, D = 256; window 0 and 1024; bf16 and
   f32), D = 64 and 128, the reference test's shapes (B 2, Hq 4, Hkv 2,
   D 32, S 64-256, window 64), ragged S (1, 63, 65, 127, 129, 333, 777,
   1000), S = 16,384 at B = 1 (the ring wrapped 256 times), Hq = Hkv
   and Hq/Hkv = 16, windows of 1, 100 and 1000 and one longer than S.
   Tolerance: 2e-5 (f32) and 3e-2 (bf16), atol = rtol.  Every case of
   the tensor-core kernel is also held, row by row, to the plain version
   run in f32 on the same bf16 inputs: ||err|| / ||row|| at most 2^-7,
   two bf16 roundings (``ref.row_rel_err``); at the main shapes, faults
   planted in the output (the second half's rows off by 2 % and 10 %,
   those rows skipping the first 64 keys they keep, the window's edge
   one key out) must each break that limit.  Two calls of the
   tensor-core kernel at the main shape must be bit-equal.  The
   main shapes are timed with CUDA events beside the plain version,
   one ``scaled_dot_product_attention`` call (``is_causal``, or a
   boolean band mask for the window) and the bound; in bf16 the f32
   kernel is timed on the same inputs as well.
9. LM serving phase at full width: gemma3-12b (48 layers, d_model 3840,
   16/8 heads of 256, d_ff 15360, vocab 262,144, 5 local : 1 global),
   bf16 weights drawn on the card from a seeded generator, through the
   port's ``models.steps``: prefill of 2 x 4096 tokens, then 32 greedy
   decode steps.  The flash kernels' launch counts are reset just
   before and read just after: one launch of the tensor-core kernel per
   layer of the prefill (48) and none of the f32 kernel.  The
   prefill's last logits with the kernel must match the plain path
   (the reference model's chunked attention) to a relative max error of
   5e-2 in bf16 and, with the same model drawn in f32 (whose prefill,
   counted the same way, must launch the f32 kernel 48 times and the
   tensor-core kernel never), 1e-3; every logit
   finite and every token within the vocab; 8 teacher-forced decode
   steps must match the forward over the extended sequence to a relative
   max error of 5e-2.  One prefill and one decode step are traced with
   ``torch.profiler`` (device time by kernel).

Every failed check raises.  The last stdout line is
``{"ok": true, "device": {...}}``; the line before it names the card and
its power limit, and a ``{"kernels": [...]}`` line precedes that.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import engine as E  # noqa: E402
from repro_torch.core import gnn as G  # noqa: E402
from repro_torch.core.embedding_store import EmbeddingStore  # noqa: E402
from repro_torch.core.graph import to_ell  # noqa: E402
from repro_torch.core.serving import GNNServer  # noqa: E402
from repro_torch.data.synth import make_preset  # noqa: E402
from repro_torch.kernels.build import build_all  # noqa: E402
from repro_torch.kernels.flash_attn import build as fa_build  # noqa: E402
from repro_torch.kernels.flash_attn import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attn.ref import (  # noqa: E402
    BF16_ROW_TOL, row_rel_err)
from repro_torch.kernels.neighbor_agg import build as na_build  # noqa: E402
from repro_torch.kernels.neighbor_agg import ops  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import steps  # noqa: E402
from repro_torch.kernels.neighbor_agg.ref import (  # noqa: E402
    CSR_BF16_ROW_TOL, neighbor_agg_backward_csr_ref,
    neighbor_agg_backward_ref, neighbor_agg_ref)

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# gradients: dfeats sums with f32 atomics in no fixed order (f32); one
# rounding of each cotangent to bf16 (bf16)
GTOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
# the reverse-index backward, row by row against its plain version in
# f32: f32 sums in another order (f32), one rounding to bf16 (bf16)
CSR_ROW_TOL = {torch.float32: 1e-5, torch.bfloat16: CSR_BF16_ROW_TOL}
DFEATS = (True, False, False, False)     # what autograd asks on the paths
TRAIN_LR = 0.3                 # the reference TrainPlan's default
CSRC = "src/repro_torch/kernels/neighbor_agg/csrc/"
FA_CSRC = "src/repro_torch/kernels/flash_attn/csrc/"
REF_AGG = "src/repro/kernels/neighbor_agg/"
# flash attention: the tolerances of tests/test_flash_attn.py
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# LM checks, relative max error (max|a - b| / max|b|) of logits.  The plain
# path (the reference model's chunked attention) rounds scores and
# probabilities to bf16 where the kernel keeps f32, and the difference
# compounds over 48 layers of random weights: 2.5e-2 on the card in bf16,
# so bf16 is held to 5e-2 and the same comparison in f32 to 1e-3.
LM_PLAIN_TOL = {torch.bfloat16: 5e-2, torch.float32: 1e-3}
LM_DECODE_TOL = 5e-2    # teacher-forced decode vs forward, bf16


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Shapes of one run: ``FULL`` on the card; ``TINY`` only rehearses
    the control flow on the CPU (the kernels then take their plain
    versions, so nothing is measured)."""
    agg_n: int = 524_288           # feature-table rows of the kernel phases
    agg_b: int = 65_536            # = the serving chunk
    agg_k: int = 32
    agg_d: tuple = (128, 172)      # GraphSAGE layer 1 / layer 2 widths
    n_serve: int = 524_288         # the graph of training and serving
    chunk: int = 65_536
    n_gcn: int = 65_536
    queries: int = 256
    updates: int = 64
    iters: int = 20
    path_iters: int = 5            # timing runs at the training shapes
    full_steps: int = 5
    mb_steps: int = 20
    mb_b: int = 8192
    mb_fanout: tuple = (15, 10)
    # flash attention (B, S, Hq, Hkv, D) and its windows: gemma3-12b prefill
    fa_shape: tuple = (2, 4096, 16, 8, 256)
    fa_windows: tuple = (0, 1024)
    fa_iters: int = 10
    # the long case that wraps the tensor-core kernel's ring (B, S, Hq, Hkv, D)
    fa_long: tuple = (1, 16384, 2, 1, 256)
    # LM serving: gemma3-12b full config (smoke config when lm_smoke)
    lm_smoke: bool = False
    lm_b: int = 2
    lm_s: int = 4096       # a multiple of q_chunk 512 and the window 1024
    lm_gen: int = 32
    lm_tf: int = 8         # teacher-forced decode steps checked


FULL = Sizes()
TINY = Sizes(agg_n=600, agg_b=300, n_serve=3_000, chunk=700,
             n_gcn=1_000, queries=24, updates=8, iters=2, path_iters=1,
             full_steps=3, mb_steps=4, mb_b=64, fa_shape=(1, 192, 4, 2, 64),
             fa_windows=(0, 64), fa_iters=2, fa_long=(1, 640, 2, 1, 64),
             lm_smoke=True, lm_s=128,
             lm_gen=4, lm_tf=3)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, dev: torch.device, iters: int, warmup: int = 3) -> float:
    """Mean time of one ``fn()`` over ``iters`` back-to-back runs: CUDA
    events on the card, the host clock on the CPU (rehearsal only)."""
    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(feats, idx, self_rows) -> tuple:
    """The least time for one call: the bytes it must move (each distinct
    referenced feature row, idx, w, out and, fused, self_rows + w_self,
    once each) over the HBM rate, against its f32 multiply-adds over the
    f32 rate.  Returns (ms, "bytes" | "operations", bytes)."""
    b, k = idx.shape
    d = feats.shape[1]
    el = feats.element_size()
    rows = int(torch.unique(idx).numel())
    nbytes = rows * d * el + b * k * 4 + b * k * el + b * d * el
    flops = 2 * b * k * d
    if self_rows is not None:
        nbytes += b * d * el + b * el
        flops += 2 * b * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def bound_bwd(feats, idx, g, self_rows, need) -> tuple:
    """The least time for one backward call: g, idx and w read, the
    distinct feature rows read (only when dw is asked for), dfeats and dw
    written once (fused: self_rows and w_self read, dself and dw_self
    written), over the HBM rate, against its f32 operations (2 per
    element for dfeats, 2 for dw) over the f32 rate.  Returns (ms,
    "bytes" | "operations", bytes)."""
    b, k = idx.shape
    n, d = feats.shape
    el = feats.element_size()
    nbytes = b * d * el + b * k * 4 + b * k * el
    flops = 0
    if need[0]:
        nbytes += n * d * el
        flops += 2 * b * k * d
    if need[1]:
        nbytes += int(torch.unique(idx).numel()) * d * el + b * k * el
        flops += 2 * b * k * d
    if self_rows is not None:
        nbytes += 2 * b * d * el + 2 * b * el
        flops += 3 * b * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def make_case(gen, dev, n, b, k, d, dtype, fused, zero=False):
    feats = torch.randn(n, d, generator=gen, device=dev).to(dtype)
    idx = torch.randint(0, n, (b, k), generator=gen, device=dev,
                        dtype=torch.int32)
    keep = torch.rand(b, k, generator=gen, device=dev) > 0.3
    w = (torch.rand(b, k, generator=gen, device=dev) * keep).to(dtype)
    if zero:
        w = torch.zeros_like(w)
    if not fused:
        return feats, idx, w, None, None
    self_rows = torch.randn(b, d, generator=gen, device=dev).to(dtype)
    w_self = torch.rand(b, generator=gen, device=dev).to(dtype)
    return feats, idx, w, self_rows, w_self


def compare(name, dtype, out, ref, tol=None) -> float:
    tol = TOL[dtype] if tol is None else tol
    err = float((out.float() - ref.float()).abs().max()) if out.numel() \
        else 0.0
    check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
    check(torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol),
          f"{name}: max_abs_err {err} beyond {tol}")
    return err


def kernel_phase(dev, sz: Sizes) -> dict:
    """Kernel vs plain version at the serving path's shapes and ragged
    ones; returns the measured main variants keyed (dtype, d, fused)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    agg = lambda *a: ops.neighbor_agg(*a, use_kernel=True)  # noqa: E731
    measured = {}
    for dtype in (torch.float32, torch.bfloat16):
        for d in sz.agg_d:
            for fused in (False, True):
                case = make_case(gen, dev, sz.agg_n, sz.agg_b, sz.agg_k, d,
                                 dtype, fused)
                name = (f"{str(dtype)[6:]} D={d} "
                        f"{'fused' if fused else 'unfused'} "
                        f"B={sz.agg_b} K={sz.agg_k} N={sz.agg_n}")
                err = compare(name, dtype, agg(*case),
                              neighbor_agg_ref(*case))
                feats, idx, w, self_rows, _ = case
                k_ms = time_ms(lambda: agg(*case), dev, sz.iters)
                p_ms = time_ms(lambda: neighbor_agg_ref(*case), dev,
                               sz.iters)
                lib_ms = None
                if not fused:        # no single call fuses the epilogue
                    lib_ms = time_ms(
                        lambda: torch.nn.functional.embedding_bag(
                            idx, feats, mode="sum", per_sample_weights=w),
                        dev, sz.iters)
                b_ms, b_by, nbytes = bound(feats, idx, self_rows)
                measured[(dtype, d, fused)] = dict(
                    max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib_ms)
                print(f"kernel {name}: max_err={err:.3g} "
                      f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                      f"library_ms="
                      f"{'n/a' if lib_ms is None else f'{lib_ms:.4f}'} "
                      f"bound_ms={b_ms:.4f} (bound by {b_by}: {nbytes} B "
                      f"= distinct feats rows + idx + w + out"
                      f"{' + self_rows + w_self' if fused else ''}, "
                      f"at 3.35 TB/s)", flush=True)
        # ragged B/K/D (B not a multiple of the 8-row block, K past one
        # 32-wide id load, D past one 256-wide tile), K = 0
        for n, b, k, d in ((1000, 1001, 7, 37), (300, 13, 33, 300),
                           (50, 5, 0, 20), (100, 77, 45, 172)):
            for fused in (False, True):
                case = make_case(gen, dev, n, b, k, d, dtype, fused)
                name = (f"ragged {str(dtype)[6:]} N={n} B={b} K={k} D={d} "
                        f"{'fused' if fused else 'unfused'}")
                err = compare(name, dtype, agg(*case),
                              neighbor_agg_ref(*case))
                print(f"kernel {name}: max_err={err:.3g}", flush=True)
        # all-zero weights: exactly 0, not merely close
        feats, idx, w, _, _ = make_case(gen, dev, 64, 100, sz.agg_k, 172,
                                        dtype, False, zero=True)
        out = agg(feats, idx, w)
        check(bool((out == 0).all()), f"zero weights {dtype}: not all 0")
        print(f"kernel zero-weights {str(dtype)[6:]}: exactly 0", flush=True)
        # an id outside [0, N) poisons its row instead of reading memory
        feats, idx, w, _, _ = make_case(gen, dev, 64, 16, 5, 40, dtype,
                                        False)
        if dev.type == "cuda":
            idx[3, 2] = 64
            out = agg(feats, idx, w)
            check(bool(torch.isnan(out[3]).all()),
                  "out-of-range id did not poison its row")
            keep = torch.ones(16, dtype=torch.bool, device=dev)
            keep[3] = False
            compare(f"out-of-range id {dtype}", dtype, out[keep],
                    neighbor_agg_ref(feats, idx[keep], w[keep]))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return measured


def library_ms(fn, dev, iters):
    """Time of one PyTorch library call (a yardstick the port never
    calls), or None where the library does not take these inputs."""
    try:
        return time_ms(fn, dev, iters)
    except (RuntimeError, NotImplementedError) as e:
        print(f"library call not timed: {type(e).__name__}: {e}",
              flush=True)
        return None


def fmt(ms):
    return "n/a" if ms is None else f"{ms:.4f}"


def row_phase(dev, sz: Sizes) -> dict:
    """The row kernel (``kernel="row"``) against its plain version:
    forward and, through its autograd Function, the gradients (whose
    backward is the backward kernel)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    row = lambda f, i, w: ops.neighbor_agg(  # noqa: E731
        f, i, w, use_kernel=True, kernel="row")

    def grads_err(name, dtype, feats, idx, w):
        f = feats.clone().requires_grad_()
        ww = w.clone().requires_grad_()
        out = row(f, idx, ww)
        g = torch.randn(out.shape, generator=gen, device=dev).to(dtype)
        got = torch.autograd.grad(out, (f, ww), g)
        want = neighbor_agg_backward_ref(feats, idx, w, g)[:2]
        return max(compare(f"{name} {c}", dtype, a, b, GTOL[dtype])
                   for c, a, b in zip(("dfeats", "dw"), got, want))

    measured = {}
    for dtype in (torch.float32, torch.bfloat16):
        for d in sz.agg_d:
            feats, idx, w, _, _ = make_case(gen, dev, sz.agg_n, sz.agg_b,
                                            sz.agg_k, d, dtype, False)
            name = (f"row {str(dtype)[6:]} D={d} B={sz.agg_b} K={sz.agg_k} "
                    f"N={sz.agg_n}")
            err = compare(name, dtype, row(feats, idx, w),
                          neighbor_agg_ref(feats, idx, w))
            gerr = grads_err(name, dtype, feats, idx, w)
            k_ms = time_ms(lambda: row(feats, idx, w), dev, sz.iters)
            p_ms = time_ms(lambda: neighbor_agg_ref(feats, idx, w), dev,
                           sz.iters)
            lib = library_ms(lambda: torch.nn.functional.embedding_bag(
                idx, feats, mode="sum", per_sample_weights=w), dev, sz.iters)
            b_ms, b_by, nbytes = bound(feats, idx, None)
            measured[(dtype, d)] = dict(
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib)
            print(f"{name}: max_err={err:.3g} grad_max_err={gerr:.3g} "
                  f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                  f"library_ms={fmt(lib)} (embedding_bag) "
                  f"bound_ms={b_ms:.4f} (bound by {b_by}: {nbytes} B)",
                  flush=True)
        for n, b, k, d in ((1000, 1001, 7, 37), (300, 13, 33, 300),
                           (50, 5, 0, 20), (100, 77, 45, 172)):
            feats, idx, w, _, _ = make_case(gen, dev, n, b, k, d, dtype,
                                            False)
            name = f"row ragged {str(dtype)[6:]} N={n} B={b} K={k} D={d}"
            err = compare(name, dtype, row(feats, idx, w),
                          neighbor_agg_ref(feats, idx, w))
            gerr = grads_err(name, dtype, feats, idx, w)
            print(f"{name}: max_err={err:.3g} grad_max_err={gerr:.3g}",
                  flush=True)
        feats, idx, w, _, _ = make_case(gen, dev, 64, 100, sz.agg_k, 172,
                                        dtype, False, zero=True)
        check(bool((row(feats, idx, w) == 0).all()),
              f"row zero weights {dtype}: not all 0")
        if dev.type == "cuda":
            feats, idx, w, _, _ = make_case(gen, dev, 64, 16, 5, 40, dtype,
                                            False)
            idx[3, 2] = -1
            check(bool(torch.isnan(row(feats, idx, w)[3]).all()),
                  "row: out-of-range id did not poison its row")
        print(f"row zero-weights {str(dtype)[6:]}: exactly 0; "
              f"out-of-range id: NaN row", flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return measured


def bound_bwd_csr(rev, d: int, el: int) -> tuple:
    """The least time for one reverse-index backward call: g, the kept
    edges' weights, indptr and edges read once, dfeats written once,
    over the HBM rate, against its f32 multiply-adds (2 per kept edge
    and column) over the f32 rate.  Returns (ms, "bytes" |
    "operations", bytes)."""
    nbytes = (rev.b * d * el + rev.nnz * el + (rev.n + 1) * 4
              + rev.nnz * 4 + rev.n * d * el)
    flops = 2 * rev.nnz * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def csr_dfeats(feats, idx, w, g, rev):
    """dfeats through the reverse-index route of the kernel wrapper."""
    return ops.neighbor_agg_backward(feats, idx, w, g, need=DFEATS,
                                     rev=rev)[0]


def check_csr(name, dtype, feats, idx, w, g) -> float:
    """The reverse-index kernel's dfeats on its index of ``(idx, w)``:
    row by row against its plain version run in f32 (``CSR_ROW_TOL``),
    against the atomic backward's plain version (``GTOL``), and exactly
    0 on rows with no edge.  Returns the row error and the number of
    such rows."""
    rev = ops.build_reverse_index(idx, w, feats.shape[0])
    got = csr_dfeats(feats, idx, w, g, rev)
    err = row_rel_err(got, neighbor_agg_backward_csr_ref(rev, w.float(),
                                                         g.float()))
    check(err <= CSR_ROW_TOL[dtype],
          f"{name}: row error {err} beyond {CSR_ROW_TOL[dtype]}")
    compare(name, dtype, got, neighbor_agg_backward_ref(
        feats, idx, w, g, need=DFEATS)[0], GTOL[dtype])
    empty = rev.indptr[1:] == rev.indptr[:-1]
    check(bool((got[empty] == 0).all()), f"{name}: a row with no edge is "
          f"not 0")
    return err, int(empty.sum())


def planted_index(rev, extra: int):
    """A faulty copy of ``rev``: each row's first edge dropped
    (``extra`` = -1) or counted twice (+1)."""
    counts = (rev.indptr[1:] - rev.indptr[:-1]).long()
    has = counts > 0
    reps = torch.ones(rev.nnz, dtype=torch.long, device=counts.device)
    reps[rev.indptr[:-1][has].long()] += extra
    indptr = torch.zeros_like(rev.indptr)
    indptr[1:] = torch.cumsum(counts + extra * has, 0)
    return dataclasses.replace(
        rev, indptr=indptr, edges=rev.edges.repeat_interleave(reps))


def csr_full_graph(dev, sz: Sizes, gen, name, feats, idx, w, g) -> dict:
    """The reverse-index kernel at the full-graph layer-2 shape: the index
    build (timed once), the row check against the plain version in f32
    with the mask weights and with random weights on the same edges,
    the 2e-2 check, planted faults, determinism and timings beside its
    plain version and the bound.  The atomic kernel and
    ``embedding_bag``'s backward are timed on the same inputs by the
    caller."""
    dtype = feats.dtype
    n, d = feats.shape
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    rev = ops.build_reverse_index(idx, w, n)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    build_ms = 1e3 * (time.perf_counter() - t0)
    got = csr_dfeats(feats, idx, w, g, rev)
    check(torch.equal(got, csr_dfeats(feats, idx, w, g, rev)),
          f"{name}: two calls of the reverse-index kernel differ")
    ref32 = neighbor_agg_backward_csr_ref(rev, w.float(), g.float())
    row_err = row_rel_err(got, ref32)
    abs_err = compare(f"{name} reverse index", dtype, got,
                      neighbor_agg_backward_ref(feats, idx, w, g,
                                                need=DFEATS)[0], GTOL[dtype])
    check(row_err <= CSR_BF16_ROW_TOL,
          f"{name}: reverse-index row error {row_err} beyond "
          f"{CSR_BF16_ROW_TOL}")
    # random weights on the same edges, so that a weight fault shows
    w_rand = ((torch.rand(w.shape, generator=gen, device=dev) * 0.9 + 0.1)
              * (w != 0)).to(dtype)
    ref_rand = neighbor_agg_backward_csr_ref(rev, w_rand.float(), g.float())
    rand_err = row_rel_err(csr_dfeats(feats, idx, w_rand, g, rev), ref_rand)
    check(rand_err <= CSR_BF16_ROW_TOL,
          f"{name}: reverse-index row error with random weights {rand_err}"
          f" beyond {CSR_BF16_ROW_TOL}")
    del ref_rand
    faults = {}
    for fault, args in (
            ("one dropped edge a row", (w, g, planted_index(rev, -1))),
            ("a row's first edge twice", (w, g, planted_index(rev, 1))),
            ("every edge's b off by one", (w, g.roll(1, 0), rev)),
            ("random weights for the mask's", (w_rand, g, rev))):
        r = row_rel_err(csr_dfeats(feats, idx, args[0], args[1], args[2]),
                        ref32)
        check(r > CSR_BF16_ROW_TOL, f"{name}: the row check passes the "
              f"planted fault '{fault}' ({r} <= {CSR_BF16_ROW_TOL})")
        faults[fault] = r
    del got, ref32, w_rand
    k_ms = time_ms(lambda: csr_dfeats(feats, idx, w, g, rev), dev,
                   sz.path_iters, 1)
    p_ms = time_ms(lambda: neighbor_agg_backward_csr_ref(rev, w, g), dev,
                   sz.path_iters, 1)
    b_ms, b_by, nbytes = bound_bwd_csr(rev, d, feats.element_size())
    print(f"{name} (reverse-index kernel): index of {rev.nnz} kept edges "
          f"built in {build_ms:.3f} ms ({rev.nbytes} B: indptr "
          f"{4 * (rev.n + 1)} + edges {4 * rev.nnz} + mask {rev.b * rev.k}); "
          f"row error {row_err:.4g} (random weights {rand_err:.4g}; limit "
          f"{CSR_BF16_ROW_TOL}), max_err={abs_err:.3g} (limit "
          f"{GTOL[dtype]}), bit-equal repeat; planted faults {faults}; "
          f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} "
          f"(bound by {b_by}: {nbytes} B = g + kept w + indptr + edges + "
          f"dfeats)", flush=True)
    return dict(max_abs_err=abs_err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, row_rel_err=row_err,
                row_rel_err_random_weights=rand_err,
                row_check_limit=CSR_BF16_ROW_TOL, planted_faults=faults,
                deterministic=True, index_build_ms=build_ms,
                index_bytes=rev.nbytes, index_nnz=rev.nnz)


def fullgraph_forward_times(dev, sz: Sizes, gen, idx, w) -> dict:
    """The tiled forward at the full-graph shape (B = N, the real ELL),
    bf16 at layer 1's and layer 2's gather widths: checked against its
    plain version and timed beside it, ``embedding_bag`` and the bound."""
    out = {}
    n = idx.shape[0]
    for d in sz.agg_d:
        feats = torch.randn(n, d, generator=gen, device=dev).to(
            torch.bfloat16)
        name = (f"tiled forward at the full-graph shape: bf16 N=B={n} "
                f"K={idx.shape[1]} D={d}")
        run = lambda: ops.neighbor_agg(feats, idx, w,  # noqa: E731
                                       use_kernel=True)
        err = compare(name, torch.bfloat16, run(),
                      neighbor_agg_ref(feats, idx, w))
        k_ms = time_ms(run, dev, sz.path_iters, 1)
        p_ms = time_ms(lambda: neighbor_agg_ref(feats, idx, w), dev,
                       sz.path_iters, 1)
        lib = library_ms(lambda: torch.nn.functional.embedding_bag(
            idx, feats, mode="sum", per_sample_weights=w), dev,
            sz.path_iters)
        b_ms, b_by, nbytes = bound(feats, idx, None)
        out[d] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                      bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                      shape=name[len("tiled forward at the full-graph "
                                     "shape: "):])
        print(f"{name}: max_err={err:.3g} kernel_ms={k_ms:.4f} "
              f"plain_ms={p_ms:.4f} library_ms={fmt(lib)} (embedding_bag) "
              f"bound_ms={b_ms:.4f} (bound by {b_by}: {nbytes} B)",
              flush=True)
        del feats
    return out


def backward_phase(dev, sz: Sizes, graph) -> dict:
    """The backward kernel against the plain backward: every cotangent at
    the kernel-cell shapes and ragged ones (through the autograd
    Functions), then the two training-path shapes with only dfeats asked
    for (timed through the kernel's wrapper)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    all4 = (True, True, True, True)

    def check_grads(name, dtype, case):
        feats, idx, w, sr, ws = case
        fused = sr is not None
        diff = [x.clone().requires_grad_() for x in (feats, w, sr, ws)
                if x is not None]
        out = ops.neighbor_agg(diff[0], idx, diff[1], *diff[2:],
                               use_kernel=True)
        g = torch.randn(out.shape, generator=gen, device=dev).to(dtype)
        got = torch.autograd.grad(out, diff, g)
        want = neighbor_agg_backward_ref(feats, idx, w, g, sr, ws)
        names = ("dfeats", "dw", "dself", "dw_self")[:4 if fused else 2]
        return g, max(compare(f"{name} {c}", dtype, a, b, GTOL[dtype])
                      for c, a, b in zip(names, got, want))

    measured = {}
    csr_errs = {torch.float32: [], torch.bfloat16: []}
    for dtype in (torch.float32, torch.bfloat16):
        for d in sz.agg_d:
            for fused in (False, True):
                case = make_case(gen, dev, sz.agg_n, sz.agg_b, sz.agg_k, d,
                                 dtype, fused)
                feats, idx, w, sr, ws = case
                name = (f"backward {str(dtype)[6:]} D={d} "
                        f"{'fused' if fused else 'unfused'} "
                        f"B={sz.agg_b} K={sz.agg_k} N={sz.agg_n}")
                g, err = check_grads(name, dtype, case)
                if not fused:
                    csr_errs[dtype].append(check_csr(
                        f"{name} reverse index", dtype, feats, idx, w, g))
                k_ms = time_ms(lambda: ops.neighbor_agg_backward(
                    feats, idx, w, g, sr, ws, need=all4), dev, sz.iters)
                p_ms = time_ms(lambda: neighbor_agg_backward_ref(
                    feats, idx, w, g, sr, ws), dev, sz.iters)
                lib = None
                if not fused:       # no single call fuses the epilogue
                    fe = feats.clone().requires_grad_()
                    we = w.clone().requires_grad_()
                    eb = torch.nn.functional.embedding_bag(
                        idx, fe, mode="sum", per_sample_weights=we)
                    lib = library_ms(lambda: torch.autograd.grad(
                        eb, (fe, we), g, retain_graph=True), dev, sz.iters)
                b_ms, b_by, nbytes = bound_bwd(feats, idx, g, sr, all4)
                measured[(dtype, d, fused)] = dict(
                    max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib)
                print(f"{name}: max_err={err:.3g} kernel_ms={k_ms:.4f} "
                      f"plain_ms={p_ms:.4f} library_ms={fmt(lib)} "
                      f"(embedding_bag backward) bound_ms={b_ms:.4f} "
                      f"(bound by {b_by}: {nbytes} B)", flush=True)
        for n, b, k, d in ((1000, 1001, 7, 37), (300, 13, 33, 300),
                           (50, 5, 0, 20), (100, 77, 45, 172)):
            for fused in (False, True):
                case = make_case(gen, dev, n, b, k, d, dtype, fused)
                name = (f"backward ragged {str(dtype)[6:]} N={n} B={b} K={k}"
                        f" D={d} {'fused' if fused else 'unfused'}")
                g, err = check_grads(name, dtype, case)
                if not fused:
                    csr_errs[dtype].append(check_csr(
                        f"{name} reverse index", dtype, *case[:3], g))
                print(f"{name}: max_err={err:.3g}", flush=True)
        feats, idx, w, _, _ = make_case(gen, dev, 64, 100, sz.agg_k, 172,
                                        dtype, False, zero=True)
        g = torch.randn(100, 172, generator=gen, device=dev).to(dtype)
        df = ops.neighbor_agg_backward(feats, idx, w, g, need=all4)[0]
        check(bool((df == 0).all()), f"backward zero weights {dtype}: "
              f"dfeats not all 0")
        rev = ops.build_reverse_index(idx, w, 64)
        check(rev.nnz == 0 and bool((csr_dfeats(feats, idx, w, g, rev) == 0
                                     ).all()),
              f"reverse index, zero weights {dtype}: dfeats not all 0")
        if dev.type == "cuda":
            feats, idx, w, _, _ = make_case(gen, dev, 64, 16, 5, 40, dtype,
                                            False)
            g = torch.randn(16, 40, generator=gen, device=dev).to(dtype)
            idx[3, 2] = 64
            df, dw, _, _ = ops.neighbor_agg_backward(feats, idx, w, g,
                                                     need=all4)
            check(bool(torch.isnan(dw[3, 2])) and
                  int(torch.isnan(dw).sum()) == 1,
                  "backward: out-of-range id did not poison its dw only")
            # the index leaves the out-of-range edge out, as the atomics
            # do; a nonzero weight on it would fail the wrapper's device
            # assert, so the reverse-index call gets it as 0
            rev = ops.build_reverse_index(idx, w, 64)
            check(not bool(rev.kept[3, 2]),
                  "reverse index kept an out-of-range id")
            w0 = w.clone()
            w0[3, 2] = 0
            compare(f"reverse index out-of-range id {dtype} dfeats", dtype,
                    csr_dfeats(feats, idx, w0, g, rev), df, GTOL[dtype])
            idx[3, 2], w[3, 2] = 0, 0
            compare(f"backward out-of-range id {dtype} dfeats", dtype, df,
                    neighbor_agg_backward_ref(feats, idx, w, g)[0],
                    GTOL[dtype])
        print(f"backward zero-weights {str(dtype)[6:]}: dfeats exactly 0 "
              f"(both kernels); out-of-range id: NaN dw, no atomics, left "
              f"out of the reverse index", flush=True)
        errs, empties = zip(*csr_errs[dtype])
        print(f"reverse-index kernel {str(dtype)[6:]}: {len(errs)} cases, "
              f"largest row error {max(errs):.4g} (limit "
              f"{CSR_ROW_TOL[dtype]}); {sum(empties)} rows with no edge, "
              f"all exactly 0", flush=True)

    # ---- the training-path shapes: autograd asks for dfeats only
    need = DFEATS
    idx_h, w_h, _ = to_ell(graph, max_deg=32)
    n = graph.n
    mb_k, mb_b = sz.mb_fanout[0], sz.mb_b
    paths = {
        "fullgraph_l2": (
            "full-graph layer 2 (real ELL, GraphSAGE mask weights)",
            torch.randn(n, 172, generator=gen, device=dev).to(torch.bfloat16),
            torch.as_tensor(idx_h, device=dev),
            torch.as_tensor(w_h > 0, device=dev).to(torch.bfloat16)),
        "minibatch_l2": (
            "mini-batch layer 2 (identity ids)",
            torch.randn(mb_b * mb_k, 256, generator=gen, device=dev),
            torch.arange(mb_b * mb_k, dtype=torch.int32,
                         device=dev).reshape(mb_b, mb_k),
            (torch.rand(mb_b, mb_k, generator=gen, device=dev) > 0.1
             ).float()),
    }
    del idx_h, w_h
    for key, (what, feats, idx, w) in paths.items():
        dtype = feats.dtype
        b, k = idx.shape
        name = (f"backward path {what}: {str(dtype)[6:]} N={feats.shape[0]} "
                f"B={b} K={k} D={feats.shape[1]}, dfeats only")
        g = torch.randn(b, feats.shape[1], generator=gen,
                        device=dev).to(dtype)
        got = ops.neighbor_agg_backward(feats, idx, w, g, need=need)[0]
        want = neighbor_agg_backward_ref(feats, idx, w, g, need=need)[0]
        err = compare(name, dtype, got, want, GTOL[dtype])
        if key == "minibatch_l2" and dev.type == "cuda":
            again = ops.neighbor_agg_backward(feats, idx, w, g,
                                              need=need)[0]
            check(torch.equal(got, again),
                  "identity-id backward is not deterministic")
        del got, want
        k_ms = time_ms(lambda: ops.neighbor_agg_backward(
            feats, idx, w, g, need=need), dev, sz.path_iters, 1)
        p_ms = time_ms(lambda: neighbor_agg_backward_ref(
            feats, idx, w, g, need=need), dev, sz.path_iters, 1)
        fe = feats.clone().requires_grad_()
        eb = torch.nn.functional.embedding_bag(idx, fe, mode="sum",
                                               per_sample_weights=w)
        lib = library_ms(lambda: torch.autograd.grad(
            eb, fe, g, retain_graph=True), dev, sz.path_iters)
        del fe, eb
        b_ms, b_by, nbytes = bound_bwd(feats, idx, g, None, need)
        measured[key] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                             shape=name[len("backward path "):])
        print(f"{name}: max_err={err:.3g} kernel_ms={k_ms:.4f} "
              f"plain_ms={p_ms:.4f} library_ms={fmt(lib)} (embedding_bag "
              f"backward) bound_ms={b_ms:.4f} (bound by {b_by}: {nbytes} B "
              f"= g + idx + w + dfeats)"
              f"{', deterministic' if key == 'minibatch_l2' else ''}",
              flush=True)
        if key == "fullgraph_l2":
            measured["csr"] = dict(
                csr_full_graph(dev, sz, gen, name, feats, idx, w, g),
                library_ms=lib, shape=measured[key]["shape"])
            measured["fullgraph_fwd"] = fullgraph_forward_times(
                dev, sz, gen, idx, w)
    del paths
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    return measured


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def training_phase(dev, sz: Sizes, graph) -> dict:
    """gnn-papers100m through the port's Trainer: full-graph GD then
    mini-batch SGD, the main path of the training slice."""
    cfg = dataclasses.replace(get_config("gnn-papers100m"), n_nodes=graph.n,
                              feat_dim=128, n_classes=172)
    check(cfg.model == "graphsage" and cfg.dtype == "bfloat16"
          and cfg.use_agg_kernel and cfg.max_degree == 32
          and tuple(cfg.fanout) == sz.mb_fanout
          and cfg.batch_size == FULL.mb_b,
          f"unexpected gnn-papers100m config {cfg}")
    plan_f = E.TrainPlan(lr=TRAIN_LR, n_iters=sz.full_steps,
                         eval_every=sz.full_steps, seed=0)
    plan_m = E.TrainPlan(lr=TRAIN_LR, n_iters=sz.mb_steps,
                         eval_every=sz.mb_steps, seed=0)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def per_step_ms(hist):
        t = hist.times
        return 1e3 * (t[-1] - t[0]) / max(len(t) - 1, 1)

    tr_f = E.Trainer(graph, cfg, plan_f,
                     source=E.FullGraphSource(max_deg=cfg.max_degree),
                     device=dev)
    src_m = E.SampledSource(batch_size=sz.mb_b, fanouts=sz.mb_fanout,
                            prefetch=True)
    tr_m = E.Trainer(graph, cfg, plan_m, source=src_m, device=dev)

    # ---- the main path, between the launch-count reset and its read
    ops.reset_launches()
    sync()
    t0 = time.perf_counter()
    res_f = tr_f.run()
    sync()
    wall_f = time.perf_counter() - t0
    after_f = ops.launch_counts()
    t0 = time.perf_counter()
    res_m = tr_m.run()
    sync()
    wall_m = time.perf_counter() - t0
    counts = ops.launch_counts()
    # ---- end of the main path

    lf, lm = res_f.history.losses, res_m.history.losses
    launches_m = {k: counts[k] - after_f[k] for k in counts}
    print(f"train: full-graph GD, {len(lf)} steps on n={graph.n} "
          f"(K={cfg.max_degree}, bf16 aggregation): losses "
          f"{[round(x, 5) for x in lf]}, {per_step_ms(res_f.history):.2f} "
          f"ms/step steady, run {wall_f:.3f} s, launches {after_f} "
          f"({after_f['tiled'] / len(lf):.2f} tiled + "
          f"{after_f['backward_csr'] / len(lf):.2f} reverse-index "
          f"backward + {after_f['backward'] / len(lf):.2f} atomic backward "
          f"per step, eval included), test_acc={res_f.final_test_acc:.4f}",
          flush=True)
    tm = src_m.timing
    nb = max(tm["batches"], 1)
    print(f"train: mini-batch SGD, {len(lm)} steps, b={sz.mb_b} fan-out "
          f"{sz.mb_fanout} (prefetch on): first/last loss {lm[0]:.5f} / "
          f"{lm[-1]:.5f}, {per_step_ms(res_m.history):.2f} ms/step steady, "
          f"run {wall_m:.3f} s, launches {launches_m} "
          f"({launches_m['tiled'] / len(lm):.2f} tiled + "
          f"{launches_m['backward'] / len(lm):.2f} atomic backward per "
          f"step, eval included), test_acc={res_m.final_test_acc:.4f}",
          flush=True)
    print(f"train: mini-batch per batch: host sampling "
          f"{1e3 * tm['sample_s'] / nb:.2f} ms + staging (gather into "
          f"pinned buffers) {1e3 * tm['stage_s'] / nb:.2f} ms on the "
          f"prefetch thread; training loop waited "
          f"{1e3 * tm['wait_s'] / nb:.2f} ms; H2D copy "
          f"{tm['h2d_ms'] / nb:.3f} ms (CUDA events)", flush=True)
    each = [round(1e3 * x, 1) for x in tm["stage_each_s"]]
    print(f"train: mini-batch staging per batch (ms, in order; a slot's "
          f"first use allocates its pinned buffers): {each}", flush=True)
    check(all(np.isfinite(lf)) and all(np.isfinite(lm)),
          "a training loss is not finite")
    check(lf[-1] < lf[0], f"full-graph loss did not fall: {lf}")
    check(0.0 <= res_f.final_test_acc <= 1.0
          and 0.0 <= res_m.final_test_acc <= 1.0, "test accuracy out of range")
    if dev.type == "cuda":
        check(after_f["tiled"] > 0 and after_f["backward"] == 0
              and after_f["backward_csr"] == len(lf),
              f"full-graph steps launched the kernels {after_f}: not the "
              f"reverse-index backward once a step and the atomic one never")
        check(launches_m["tiled"] > 0 and launches_m["backward"] > 0
              and launches_m["backward_csr"] == 0,
              f"mini-batch steps launched the kernels {launches_m}: not "
              f"the atomic backward alone")

    # ---- checks and timings outside the counted window
    params = res_m.params
    leaves = [v for p in params for v in p.values()]
    out = {"counts": counts, "counts_full": after_f,
           "counts_mb": launches_m, "full_ms": per_step_ms(res_f.history),
           "mb_ms": per_step_ms(res_m.history)}
    for label, src, tol in (
            ("full-graph (bf16 aggregation)",
             E.FullGraphSource(max_deg=cfg.max_degree), 2e-2),
            ("mini-batch (f32)",
             E.SampledSource(batch_size=sz.mb_b, fanouts=sz.mb_fanout,
                             prefetch=False), 1e-4)):
        src.bind(graph, cfg, plan_m, dev)
        batch, _ = next(src.batches())
        grads = {}
        for kernel in (True, False):
            src.cfg = dataclasses.replace(cfg, use_agg_kernel=kernel)
            grads[kernel] = torch.autograd.grad(src.loss(params, batch),
                                                leaves)
            sync()
        err = max(rel_err(a, b) for a, b in zip(grads[True], grads[False]))
        print(f"train: {label} step, parameter gradients with the kernels "
              f"vs the plain path: relative max error {err:.3g} "
              f"(limit {tol})", flush=True)
        check(err <= tol, f"{label}: gradient rel err {err} beyond {tol}")
        if label.startswith("full"):
            # one full-graph step (forward + backward + update) timed with
            # CUDA events and traced, through a Trainer bound like tr_f
            # through a Trainer bound like tr_f; in turns with its source's
            # reverse index and without it (the atomic backward, as before
            # the index), on the same parameters
            tr_p = E.Trainer(graph, cfg, plan_f, source=E.FullGraphSource(
                max_deg=cfg.max_degree), device=dev)
            opt_state = tr_p.opt.init(params)
            rev = tr_p.source.rev

            def step(r=rev):
                tr_p.source.rev = r
                return tr_p._step(params, opt_state, None)

            turns = {"reverse_index": [], "atomic": []}
            for which in ("reverse_index", "atomic", "atomic",
                          "reverse_index"):
                r = rev if which == "reverse_index" else None
                turns[which].append(time_ms(lambda: step(r), dev, 5, 1))
            out["full_device_ms"] = float(np.mean(turns["reverse_index"]))
            out["full_device_ms_atomic"] = float(np.mean(turns["atomic"]))
            print(f"train: full-graph device step (forward + backward + "
                  f"update, CUDA events, in turns on the same parameters): "
                  f"{turns['reverse_index']} ms with the reverse-index "
                  f"backward, {turns['atomic']} ms with the atomic one",
                  flush=True)
            prof = profile_device(dev, step) if dev.type == "cuda" else {}
            if prof:
                print(f"train: profiled full-graph step: wall "
                      f"{prof['wall_ms']:.2f} ms (traced), device time "
                      f"{prof['device_ms']:.2f} ms; largest kernels (name, "
                      f"ms, calls): {prof['top']}", flush=True)
            tr_p.close()
        if label.startswith("mini"):
            src.cfg = cfg
            opt_state = tr_m.opt.init(params)
            step_ms = time_ms(lambda: tr_m._step(params, opt_state, batch),
                              dev, 5, 1)
            out["mb_device_ms"] = step_ms
            print(f"train: mini-batch device step (forward + backward + "
                  f"update on a staged batch, CUDA events) {step_ms:.3f} ms",
                  flush=True)
        src.done(batch)
        src.close()
        del grads, batch
    tr_f.close()
    tr_m.close()
    E.drop_device_cache(graph)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def make_graph(sz: Sizes):
    """The papers-like graph shared by the training and serving phases."""
    t0 = time.perf_counter()
    graph = make_preset("papers-like", n=sz.n_serve, n_classes=172,
                        feat_dim=128, power_law=False, seed=0)
    gen_s = time.perf_counter() - t0
    print(f"graph: n={graph.n} avg_deg={graph.avg_degree:.2f} "
          f"d_max={graph.d_max} (generated in {gen_s:.1f} s)", flush=True)
    return graph


def serving_phase(dev, sz: Sizes, graph) -> dict:
    """gnn-papers100m's widths through build -> queries -> refresh."""
    cfg = dataclasses.replace(get_config("gnn-papers100m"),
                              n_nodes=sz.n_serve)
    check(cfg.model == "graphsage" and cfg.dtype == "bfloat16"
          and cfg.use_agg_kernel and cfg.max_degree == 32,
          f"unexpected gnn-papers100m config {cfg}")
    params = G.init_gnn(torch.Generator().manual_seed(0), cfg, 128,
                        device=dev)
    t0 = time.perf_counter()
    store = EmbeddingStore(params, cfg, graph, chunk_size=sz.chunk,
                           max_deg=cfg.max_degree, device=dev)
    ell_s = time.perf_counter() - t0
    print(f"serve: ELL K={store.K} in {ell_s:.1f} s", flush=True)

    rng = np.random.default_rng(1)
    queries = [rng.integers(0, graph.n, size=int(rng.integers(1, 9)))
               for _ in range(sz.queries)]
    upd = [rng.choice(graph.n, size=sz.updates, replace=False)
           for _ in range(2)]
    upd_rows = [rng.normal(size=(sz.updates, 128)).astype(np.float32)
                for _ in range(2)]

    # ---- the main path, between the launch-count reset and its read
    ops.reset_launches()
    t0 = time.perf_counter()
    run = store.build()
    build_s = time.perf_counter() - t0
    build_launches = ops.launches
    snap0 = store.snapshot()
    feats0 = graph.feats.copy()                 # the update writes in place
    server = GNNServer(store, max_batch=64, max_wait_ms=2.0)
    try:
        with ThreadPoolExecutor(max_workers=4) as pool:
            answers = list(pool.map(
                lambda q: server.submit(q, with_meta=True)
                .result(timeout=120.0), queries))
    finally:
        server.close()
    st = server.stats()
    infos = []
    for nodes, rows in zip(upd, upd_rows):   # the first refresh also
        store.update_features(nodes, rows)   # builds the reverse index
        t0 = time.perf_counter()
        infos.append((store.refresh(), time.perf_counter() - t0))
    launches = ops.launches
    # ---- end of the main path

    print(f"serve: build {build_s:.3f} s "
          f"({1e3 * build_s / graph.n:.6f} ms/node, per layer "
          f"{run.stats['per_layer_s']}, {run.stats['n_chunks']} chunks of "
          f"{run.stats['chunk_size']}), kernel launches: build "
          f"{build_launches}, main path {launches}", flush=True)
    print(f"serve: {st['n_requests']} requests / {st['n_queries']} nodes "
          f"in {st['n_batches']} batches: p50_ms={st['p50_ms']:.4f} "
          f"p99_ms={st['p99_ms']:.4f} qps={st['qps']:.1f}", flush=True)
    for i, (info, secs) in enumerate(infos):
        print(f"serve: refresh {i + 1} ({'cold' if i == 0 else 'warm'}) of "
              f"{sz.updates} updated nodes re-embedded "
              f"{info['rows_per_layer']} rows in {secs:.3f} s", flush=True)
    if dev.type == "cuda":
        check(launches > 0 and build_launches > 0,
              f"serving path launched the kernel {launches} times")

    # ---- checks (outside the counted window)
    plain = dataclasses.replace(cfg, use_agg_kernel=False)
    ell = [torch.as_tensor(a, device=dev)
           for a in (store.idx, store.w, store.w_self)]
    _, want = G.full_graph_forward(params, plain,
                                   torch.as_tensor(feats0, device=dev),
                                   *ell, return_layers=True)
    for li, (a, b) in enumerate(zip(snap0.layers, want)):
        err = compare(f"serve layer {li + 1} vs plain forward",
                      torch.bfloat16, a, b)
        print(f"serve: layer {li + 1} {tuple(a.shape)} max_abs_err vs "
              f"plain forward {err:.4g}", flush=True)
    del want
    expect = np.argmax(snap0.final_np, -1)
    check(all(a.snapshot_version == snap0.version
              and np.array_equal(a.preds, expect[q])
              for a, q in zip(answers, queries)),
          "a served answer differs from the snapshot's argmax")
    check(st["n_queries"] == sum(len(q) for q in queries),
          f"server counted {st['n_queries']} queries")
    for info, _ in infos:
        check(0 < info["total_rows"] < graph.n * cfg.n_layers,
              f"refresh re-embedded {info['total_rows']} rows, not fewer "
              f"than n x layers = {graph.n * cfg.n_layers}")
    fresh = EmbeddingStore(params, cfg, store.graph, chunk_size=sz.chunk,
                           max_deg=cfg.max_degree, device=dev)
    t0 = time.perf_counter()
    fresh.build()
    print(f"serve: warm build (fresh store, same shapes) "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    for li, (a, b) in enumerate(zip(store.layers, fresh.layers)):
        err = compare(f"refreshed layer {li + 1} vs full rebuild",
                      torch.bfloat16, a, b)
        print(f"serve: refreshed layer {li + 1} max_abs_err vs full "
              f"rebuild {err:.4g}", flush=True)
    return dict(launches=launches, build_s=build_s, stats=st)


def gcn_phase(dev, sz: Sizes) -> dict:
    """GCN in f32: the fused self epilogue on the serving path."""
    cfg = dataclasses.replace(get_config("gnn-papers100m"), name="gcn-f32",
                              model="gcn", dtype="float32",
                              n_nodes=sz.n_gcn)
    graph = make_preset("papers-like", n=sz.n_gcn, n_classes=172,
                        feat_dim=128, power_law=False, seed=1)
    params = G.init_gnn(torch.Generator().manual_seed(1), cfg, 128,
                        device=dev)
    store = EmbeddingStore(params, cfg, graph, chunk_size=sz.chunk,
                           max_deg=cfg.max_degree, device=dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    run = store.build()
    build_s = time.perf_counter() - t0
    launches = ops.launches
    print(f"gcn: n={graph.n} build {build_s:.3f} s, per layer "
          f"{run.stats['per_layer_s']}, kernel launches {launches}",
          flush=True)
    if dev.type == "cuda":
        check(launches > 0, f"GCN path launched the kernel {launches} times")
    t0 = time.perf_counter()
    warm = store.build()
    print(f"gcn: warm build {time.perf_counter() - t0:.3f} s, per layer "
          f"{warm.stats['per_layer_s']}", flush=True)
    plain = dataclasses.replace(cfg, use_agg_kernel=False)
    t = [torch.as_tensor(a, device=dev)
         for a in (graph.feats, store.idx, store.w, store.w_self)]
    _, want = G.full_graph_forward(params, plain, *t, return_layers=True)
    for li, (a, b) in enumerate(zip(run.layers, want)):
        err = float((a - b).abs().max())
        check(torch.allclose(a, b, rtol=1e-4, atol=1e-4),
              f"gcn layer {li + 1}: max_abs_err {err} beyond 1e-4")
        print(f"gcn: layer {li + 1} {tuple(a.shape)} max_abs_err vs plain "
              f"forward {err:.4g}", flush=True)
    return dict(launches=launches)


def flash_bound(b, s, hq, hkv, d, window, dtype) -> tuple:
    """The least time for one flash-attention call: q, k, v and o moved
    once (k and v at Hkv heads, as the kernel reads them) over the HBM
    rate, against 4·D flops for each (query, key) pair the mask keeps over
    the peak rate of the inputs' type (bf16 tensor cores, or f32).
    Returns (ms, "bytes" | "operations", bytes, flops)."""
    el = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * hq + 2 * hkv) * b * s * d * el
    w = window or s
    pairs = w * (w + 1) // 2 + (s - w) * w if w < s else s * (s + 1) // 2
    flops = 4 * b * hq * pairs * d
    rate = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def _plain_keep(q, k, v, keep):
    """The plain version's attention with any mask: ``keep[s, t]`` says
    query s attends to key t ([B, S, H, D], GQA repeated)."""
    g = q.shape[2] // k.shape[2]
    k, v = (x.repeat_interleave(g, dim=2) for x in (k, v))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() \
        / q.shape[-1] ** 0.5
    p = torch.softmax(scores.masked_fill(~keep, -1e30), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _sdpa(q, k, v, window):
    """One PyTorch call for the same function (a yardstick the port never
    calls): is_causal, or a boolean band mask for a window."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if not window:
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    pos = torch.arange(q.shape[1], device=q.device)
    band = ((pos[None, :] <= pos[:, None])
            & (pos[None, :] > pos[:, None] - window))
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=band, enable_gqa=True)


def flash_phase(dev, sz: Sizes) -> dict:
    """The flash-attention kernel against its plain version; the main
    shapes timed.  Returns the measured main variants keyed (dtype,
    window)."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(3)
    kern = lambda q, k, v, w: fa.flash_attention(  # noqa: E731
        q, k, v, window=w, use_kernel=True)
    # the plain version (``ref.flash_attention_ref`` after the GQA repeat)
    plain = lambda q, k, v, w: fa.flash_attention(  # noqa: E731
        q, k, v, window=w, use_kernel=False)

    def simt(q, k, v, w):
        """The f32-FMA kernel on inputs the router sends elsewhere, to
        time the two kernels on the same inputs (the plain version on the
        CPU, as the wrapper would take)."""
        if dev.type != "cuda":
            return kern(q, k, v, w)
        return fa._launch(q, k, v, w, "simt")

    def qkv(b, s, hq, hkv, d, dtype):
        return [torch.randn(b, s, h, d, generator=gen, device=dev).to(dtype)
                for h in (hq, hkv, hkv)]

    def one(name, b, s, hq, hkv, d, w, dtype, faults=False):
        """One case: the routed kernel against the plain version at
        FA_TOL and, on the tensor-core kernel, row by row against the
        plain version in f32 (and, with ``faults``, the planted faults
        against the same limit).  Returns the inputs, the output, the
        max abs error, the largest row error (None off that kernel) and
        the planted faults' readings."""
        q, k, v = qkv(b, s, hq, hkv, d, dtype)
        want = plain(q, k, v, w)
        route = fa.kernel_route(dtype, d)
        counts = fa.launch_counts()
        out = kern(q, k, v, w)
        launched = 1 if dev.type == "cuda" else 0   # CPU: the plain version
        check(fa.launch_counts() == dict(counts, **{route: counts[route]
                                                    + launched}),
              f"{name}: not one launch of the {route} kernel "
              f"({counts} -> {fa.launch_counts()})")
        err = compare(name, dtype, out, want, FA_TOL[dtype])
        row_err, planted = None, None
        if route == "wgmma":
            q32, k32, v32 = (x.float() for x in (q, k, v))
            ref32 = plain(q32, k32, v32, w)
            row_err = row_rel_err(out, ref32)
            # on the CPU ``out`` is the plain version, whose scores are
            # rounded to bf16: the limit is the kernel's alone
            check(not launched or row_err <= BF16_ROW_TOL,
                  f"{name}: row error {row_err} beyond {BF16_ROW_TOL}")
            if faults:
                planted = planted_faults(name, (q32, k32, v32), w, out,
                                         ref32, want)
            del q32, k32, v32, ref32
        del want
        return (q, k, v), out, err, row_err, planted

    def planted_faults(name, qkv32, w, out, ref32, want):
        """Outputs a faulty kernel could give, each of which the row
        check must reject: the second half's rows mis-normalised by 2 %
        and 10 %, those rows skipping the first 64 keys they keep, and
        with a window its edge one key out.  Returns each fault's row
        error and whether the FA_TOL check would have passed it."""
        s = out.shape[1]
        bad = {}
        for f in (1.02, 1.1):
            x = out.clone()
            x[:, s // 2:] = (x[:, s // 2:].float() * f).to(out.dtype)
            bad[f"late rows x{f}"] = x
        pos = torch.arange(s, device=dev)
        row, key = pos[:, None], pos[None, :]
        lo = (row - w + 1).clamp_min(0) if w else torch.zeros_like(row)
        keep = (key <= row) & (key >= lo) & ~(
            (row >= s // 2) & (key < lo + 64))
        bad["late rows skip their first 64 keys"] = _plain_keep(
            *qkv32, keep).to(out.dtype)
        if w:
            bad["window edge one key out"] = plain(*qkv32, w + 1).to(
                out.dtype)
        readings = {}
        for fault, x in bad.items():
            r = row_rel_err(x, ref32)
            check(r > BF16_ROW_TOL, f"{name}: the row check passes the "
                  f"planted fault '{fault}' ({r} <= {BF16_ROW_TOL})")
            readings[fault] = {
                "row_rel_err": r,
                "passes_fa_tol": bool(torch.allclose(
                    x.float(), want.float(), atol=FA_TOL[out.dtype],
                    rtol=FA_TOL[out.dtype]))}
        return readings

    measured = {}
    row_errs = []            # every case of the tensor-core kernel
    b, s, hq, hkv, d = sz.fa_shape
    for dtype in (torch.bfloat16, torch.float32):
        for w in sz.fa_windows:
            name = (f"flash {str(dtype)[6:]} B={b} S={s} Hq={hq} Hkv={hkv} "
                    f"D={d} window={w}")
            (q, k, v), out, err, row_err, planted = one(
                name, b, s, hq, hkv, d, w, dtype, faults=True)
            route = fa.kernel_route(dtype, d)
            if route == "wgmma":
                row_errs.append(row_err)
                print(f"{name}: row error {row_err:.6g} (limit "
                      f"{BF16_ROW_TOL}); planted faults: "
                      f"{json.dumps(planted)}", flush=True)
            simt_err = None
            if route == "wgmma":
                check(torch.equal(out, kern(q, k, v, w)),
                      f"{name}: two calls of the kernel differ")
                simt_err = compare(f"{name} (f32 kernel)", dtype,
                                   simt(q, k, v, w), plain(q, k, v, w),
                                   FA_TOL[dtype])
            del out
            b_ms, b_by, nbytes, flops = flash_bound(b, s, hq, hkv, d, w,
                                                    dtype)
            # in bf16 the two kernels in turns on the same inputs
            k_ms = time_ms(lambda: kern(q, k, v, w), dev, sz.fa_iters)
            simt_ms = None
            if route == "wgmma":
                simt_ms = time_ms(lambda: simt(q, k, v, w), dev, sz.fa_iters)
                k_ms = (k_ms + time_ms(lambda: kern(q, k, v, w), dev,
                                       sz.fa_iters)) / 2
            p_ms = time_ms(lambda: plain(q, k, v, w), dev,
                           max(sz.fa_iters // 2, 1), 1)
            lib = library_ms(_sdpa(q, k, v, w), dev, sz.fa_iters)
            measured[(dtype, w)] = dict(
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib, simt_ms=simt_ms,
                simt_max_abs_err=simt_err)
            if route == "wgmma":
                measured[(dtype, w)].update(row_rel_err=row_err,
                                            planted_faults=planted)
            print(f"{name}: {route} kernel max_err={err:.3g} "
                  f"kernel_ms={k_ms:.4f} f32 kernel on the same inputs: "
                  f"ms={fmt(simt_ms)} max_err={simt_err} plain_ms={p_ms:.4f} "
                  f"library_ms={fmt(lib)} (scaled_dot_product_attention) "
                  f"bound_ms={b_ms:.4f} (bound by {b_by}: {nbytes} B = q + "
                  f"k + v + o at 3.35 TB/s; {flops} flops at "
                  f"{'989' if dtype == torch.bfloat16 else '67'} TFLOP/s) "
                  f"= {flops / k_ms / 1e9:.1f} TFLOP/s achieved", flush=True)
            del q, k, v
    # other head dims, the reference test's shapes, ragged S, windows
    # that are not a multiple of the 64-key tile
    cases = [(b, s, hq, hkv, dd, w, torch.bfloat16)
             for dd in (64, 128) for w in sz.fa_windows]
    cases += [(2, ss, 4, 2, 32, w, dt) for ss in (64, 128, 256)
              for w in (0, 64) for dt in (torch.float32, torch.bfloat16)]
    cases += [(2, 1000, 16, 8, 256, 0, torch.bfloat16),
              (1, 333, 8, 2, 128, 100, torch.float32),
              (3, 1, 4, 4, 64, 0, torch.float32),
              (1, 2048, 16, 8, 256, 1000, torch.bfloat16),
              (2, 777, 4, 1, 16, 100, torch.float32)]
    # the tensor-core kernel's ring and masks: ragged S around its 64-key
    # and 128-row tiles, a long S, MHA and 16 query heads a KV head,
    # windows of 1, 100 and 1000 and one longer than S
    bf = torch.bfloat16
    cases += [(2, 1, 4, 2, 256, 0, bf), (2, 63, 4, 2, 256, 0, bf),
              (2, 65, 4, 2, 128, 0, bf), (2, 127, 4, 2, 64, 0, bf),
              (2, 129, 4, 2, 256, 64, bf), (*sz.fa_long, 0, bf),
              (1, 1000, 8, 8, 256, 0, bf), (1, 1000, 16, 1, 256, 1024, bf),
              (1, 1100, 4, 2, 256, 1, bf), (2, 700, 8, 4, 128, 100, bf),
              (1, 1500, 8, 2, 64, 1000, bf), (1, 500, 4, 2, 256, 4096, bf)]
    for cb, cs, chq, chkv, cd, cw, dt in cases:
        name = (f"flash {str(dt)[6:]} B={cb} S={cs} Hq={chq} Hkv={chkv} "
                f"D={cd} window={cw}")
        _, _, err, row_err, _ = one(name, cb, cs, chq, chkv, cd, cw, dt)
        rows = ""
        if row_err is not None:
            row_errs.append(row_err)
            rows = f" row error {row_err:.6g}"
        print(f"{name}: {fa.kernel_route(dt, cd)} kernel max_err={err:.3g}"
              f"{rows}", flush=True)
    measured["wgmma_rows"] = {"row_rel_err_max": max(row_errs),
                              "limit": BF16_ROW_TOL, "cases": len(row_errs)}
    print(f"flash: tensor-core kernel's largest row error "
          f"{max(row_errs):.6g} over {len(row_errs)} cases, limit "
          f"{BF16_ROW_TOL} (against the plain version in f32)", flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    return measured


def _device_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        val = getattr(evt, attr, None)
        if val is not None:
            return float(val)
    return 0.0


def profile_device(dev, fn) -> dict:
    """Device time of one ``fn()`` by kernel, from a ``torch.profiler``
    trace, beside its wall time: the flash kernel's part, the largest
    kernels.  Only the trace's device events are summed (the operators
    that launch them carry the same time again).  A trace that cannot be
    taken leaves the numbers out ("not measured"); it does not stop the
    run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        evs = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA
               and _device_us(e) > 0]
    except RuntimeError as e:               # the tracer, not the port
        print(f"profiler trace failed ({e}): not measured", flush=True)
        return {}
    total = sum(_device_us(e) for e in evs)
    flash = sum(_device_us(e) for e in evs if "flash_attn" in e.key)
    top = sorted(evs, key=_device_us, reverse=True)[:8]
    return {"wall_ms": 1e3 * wall, "device_ms": total / 1e3,
            "flash_ms": flash / 1e3,
            "top": [(e.key[:70], round(_device_us(e) / 1e3, 3), e.count)
                    for e in top]}


def _print_profile(what, prof) -> None:
    if not prof or not prof["device_ms"]:
        print(f"lm: profiled {what}: device time not measured", flush=True)
        return
    print(f"lm: profiled {what}: wall {prof['wall_ms']:.2f} ms (traced), "
          f"device time {prof['device_ms']:.2f} ms "
          f"({prof['device_ms'] / prof['wall_ms']:.3f} of the wall), "
          f"flash kernels {prof['flash_ms']:.2f} ms "
          f"({prof['flash_ms'] / prof['device_ms']:.3f} of device time); "
          f"largest kernels (name, ms, calls): {prof['top']}", flush=True)


def lm_phase(dev, sz: Sizes) -> dict:
    """gemma3-12b through the port's serving steps: prefill then decode,
    the main path of the LM serving slice."""
    cfg = get_config("gemma3-12b", smoke=sz.lm_smoke)
    if not sz.lm_smoke:
        check(cfg.n_layers == 48 and cfg.d_model == 3840
              and cfg.n_heads == 16 and cfg.n_kv_heads == 8
              and cfg.resolved_head_dim == 256 and cfg.d_ff == 15360
              and cfg.vocab_size == 262_144 and cfg.sliding_window == 1024
              and cfg.dtype == "bfloat16" and cfg.tie_embeddings
              and cfg.pattern.count("local") == 40,
              f"unexpected gemma3-12b config {cfg}")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    params = M.init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                          dev, dtype=M._dt(cfg))
    sync()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"lm: {cfg.name} {'smoke' if sz.lm_smoke else 'full'} config, "
          f"{n_params} parameters in {M._dt(cfg)} drawn on {dev} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    b, s, ngen, ntf = sz.lm_b, sz.lm_s, sz.lm_gen, sz.lm_tf
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s + ntf)),
                           device=dev)
    prompt = {"tokens": toks[:, :s]}
    prefill = steps.make_prefill_step(cfg)
    decode = steps.make_serve_step(cfg)
    with torch.inference_mode():
        # ---- the main path, between the launch-count reset and its read
        fa.reset_launches()
        sync()
        t0 = time.perf_counter()
        last, cache = prefill(params, prompt, s + ngen)
        sync()
        prefill_s = time.perf_counter() - t0
        prefill_launches = fa.launches
        prefill_counts = fa.launch_counts()
        tok = last.argmax(-1, keepdim=True)
        gen_toks, finite = [], torch.isfinite(last).all()
        t0 = time.perf_counter()
        for _ in range(ngen):
            gen_toks.append(tok)
            logits, cache = decode(params, cache, tok)
            finite &= torch.isfinite(logits).all()
            tok = logits.argmax(-1, keepdim=True)
        sync()
        decode_s = time.perf_counter() - t0
        launches = fa.launches
        counts = fa.launch_counts()
        # ---- end of the main path
        gen_toks = torch.cat(gen_toks, 1)
        del cache
        print(f"lm: prefill {b} x {s} tokens in {prefill_s:.3f} s "
              f"({b * s / prefill_s:.1f} tokens/s, first call); "
              f"{ngen} greedy decode steps in {decode_s:.3f} s "
              f"({1e3 * decode_s / ngen:.2f} ms/step, "
              f"{b * ngen / decode_s:.1f} tokens/s); flash launches: "
              f"prefill {prefill_launches} {prefill_counts}, main path "
              f"{launches} {counts}", flush=True)
        if dev.type == "cuda":
            route = fa.kernel_route(M._dt(cfg), cfg.resolved_head_dim)
            want_counts = {r: cfg.n_layers if r == route else 0
                           for r in fa.ROUTES}
            check(prefill_launches == cfg.n_layers and
                  launches == cfg.n_layers and prefill_counts == want_counts
                  and counts == want_counts,
                  f"prefill launched the flash kernels {prefill_counts} "
                  f"(main path {counts}), not the {route} kernel once per "
                  f"layer ({cfg.n_layers}) and no other")
        check(bool(finite), "a prefill or decode logit is not finite")
        check(bool(((gen_toks >= 0) & (gen_toks < cfg.vocab_size)).all()),
              "a generated token is outside the vocab")

        # ---- checks and timings outside the counted window
        sync()
        t0 = time.perf_counter()
        plain_last, _ = M.prefill(params, cfg, prompt, kernel=False)
        sync()
        plain_s = time.perf_counter() - t0
        check_plain(cfg, last, plain_last, f"plain path {plain_s:.3f} s")
        del plain_last
        # teacher-forced decode against the forward over prompt + ntf
        sync()
        t0 = time.perf_counter()
        last2, cache = prefill(params, prompt, s + ntf)
        sync()
        prefill2_s = time.perf_counter() - t0
        x = M.embed_tokens(params, cfg, toks)
        hid, _ = M.backbone(params, cfg, x,
                            torch.arange(s + ntf, device=dev))
        want = M.logits_fn(params, cfg, hid[:, s - 1:]).float()
        del x, hid
        errs = [rel_err(last2.float(), want[:, 0])]
        for t in range(ntf):
            lg, cache = decode(params, cache, toks[:, s + t:s + t + 1])
            errs.append(rel_err(lg.float(), want[:, t + 1]))
        del want
        prof_decode = ({} if dev.type != "cuda" else profile_device(
            dev, lambda: decode(params, cache, toks[:, -1:])))
        del cache
        print(f"lm: second prefill {prefill2_s:.3f} s "
              f"({b * s / prefill2_s:.1f} tokens/s); teacher-forced decode "
              f"vs the forward over {s + ntf} tokens, relative max error "
              f"by step (prefill first): {[f'{e:.3g}' for e in errs]} "
              f"(limit {LM_DECODE_TOL})", flush=True)
        check(max(errs) <= LM_DECODE_TOL,
              f"teacher-forced decode rel err {max(errs)} beyond "
              f"{LM_DECODE_TOL}")
        out = dict(launches=launches, counts=counts, prefill_s=prefill_s,
                   prefill2_s=prefill2_s, decode_ms=1e3 * decode_s / ngen)
        if dev.type == "cuda":
            _print_profile("prefill", profile_device(
                dev, lambda: prefill(params, prompt)))
            _print_profile("decode step", prof_decode)
            print(f"lm: max memory allocated "
                  f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
                  flush=True)
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if M._dt(cfg) == torch.float32:           # the main path was f32 already
        out["counts_f32"] = counts
    else:
        # the same comparison with the model drawn in f32, where neither
        # path rounds to bf16
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        params = M.init_model(torch.Generator(device=dev).manual_seed(0),
                              cfg32, dev, dtype=torch.float32)
        with torch.inference_mode():
            # ---- the f32 model's prefill, between a reset and a read
            fa.reset_launches()
            got, _ = steps.make_prefill_step(cfg32)(params, prompt)
            sync()
            out["counts_f32"] = fa.launch_counts()
            # ---- end of the f32 model's prefill
            want, _ = M.prefill(params, cfg32, prompt, kernel=False)
        print(f"lm: f32 model prefill flash launches {out['counts_f32']}",
              flush=True)
        if dev.type == "cuda":
            route = fa.kernel_route(torch.float32, cfg.resolved_head_dim)
            check(out["counts_f32"] == {r: cfg.n_layers if r == route else 0
                                        for r in fa.ROUTES},
                  f"f32 prefill launched the flash kernels "
                  f"{out['counts_f32']}, not the {route} kernel once per "
                  f"layer")
        check_plain(cfg32, got, want, "f32 model")
        del params, got, want
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def check_plain(cfg, got, want, what) -> None:
    """The prefill's last logits with the kernel against the plain path."""
    dt = M._dt(cfg)
    err = rel_err(got.float(), want.float())
    print(f"lm: prefill last logits ({str(dt)[6:]}), flash kernel vs the "
          f"plain path (chunked attention; {what}): relative max error "
          f"{err:.4g} (limit {LM_PLAIN_TOL[dt]})", flush=True)
    check(err <= LM_PLAIN_TOL[dt],
          f"prefill kernel vs plain rel err {err} beyond {LM_PLAIN_TOL[dt]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def run(dev: torch.device, sz: Sizes) -> dict:
    # full f32 products everywhere (TF32 off), bf16 GEMMs reduce in f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    measured = kernel_phase(dev, sz)
    row = row_phase(dev, sz)
    graph = make_graph(sz)
    bwd = backward_phase(dev, sz, graph)
    train = training_phase(dev, sz, graph)
    serve = serving_phase(dev, sz, graph)
    gcn = gcn_phase(dev, sz)
    del graph
    flash = flash_phase(dev, sz)
    lm = lm_phase(dev, sz)
    d = max(sz.agg_d)
    b, s, hq, hkv, hd = sz.fa_shape
    w1 = sz.fa_windows[1]
    cell = f"B={sz.agg_b} K={sz.agg_k} D={d} N={sz.agg_n}"
    tf, tm = train["counts_full"], train["counts_mb"]
    kernels = [
        {"name": "neighbor_agg_tiled", "route": "cuda",
         "source": CSRC + "neighbor_agg.cu",
         "replaces": REF_AGG + "neighbor_agg.py:192",
         "launches": train["counts"]["tiled"],
         "launches_by_path": {"train_fullgraph": tf["tiled"],
                              "train_minibatch": tm["tiled"],
                              "serve": serve["launches"]},
         **measured[(torch.bfloat16, d, False)],
         "shape": f"bf16, unfused, {cell} (the serving chunk)",
         "by_shape": {
             f"fullgraph_d{dd}": dict(
                 m, launches=f"{tf['tiled']} over both widths (one each "
                             f"a full-graph forward)")
             for dd, m in bwd["fullgraph_fwd"].items()}},
        {"name": "neighbor_agg_tiled_fused", "route": "cuda",
         "source": CSRC + "neighbor_agg.cu",
         "replaces": REF_AGG + "neighbor_agg.py:192",
         "launches": gcn["launches"],
         "launches_by_path": {"gcn_serve": gcn["launches"]},
         **measured[(torch.float32, d, True)],
         "shape": f"f32, fused self epilogue, {cell}"},
        {"name": "neighbor_agg_backward", "route": "cuda",
         "source": CSRC + "neighbor_agg_bwd.cu",
         "replaces": REF_AGG + "ops.py:55",
         "launches": train["counts"]["backward"],
         "launches_by_path": {"train_fullgraph": tf["backward"],
                              "train_minibatch": tm["backward"]},
         **bwd["minibatch_l2"],
         "by_shape": {
             "minibatch_l2": dict(bwd["minibatch_l2"],
                                  launches=tm["backward"]),
             "fullgraph_l2": dict(
                 bwd["fullgraph_l2"], launches=tf["backward"],
                 note="dfeats of the full-graph path goes to "
                      "neighbor_agg_backward_csr; timed here on its "
                      "inputs")}},
        {"name": "neighbor_agg_backward_csr", "route": "cuda",
         "source": CSRC + "neighbor_agg_bwd_csr.cu",
         "replaces": REF_AGG + "ops.py:55",
         "launches": train["counts"]["backward_csr"],
         "launches_by_path": {"train_fullgraph": tf["backward_csr"],
                              "train_minibatch": tm["backward_csr"]},
         **bwd["csr"],
         "atomic_ms_same_inputs": bwd["fullgraph_l2"]["ms"],
         "atomic_plain_ms_same_inputs": bwd["fullgraph_l2"]["plain_ms"]},
        {"name": "neighbor_agg_row", "route": "cuda",
         "source": CSRC + "neighbor_agg_row.cu",
         "replaces": REF_AGG + "neighbor_agg.py:85",
         "launches": train["counts"]["row"],
         "launches_by_path": {"train": train["counts"]["row"],
                              "note": "on no model path: reached only "
                                      "through neighbor_agg(kernel='row')"},
         **row[(torch.bfloat16, d)],
         "shape": f"bf16, {cell}"},
        {"name": "flash_attention_wgmma", "route": "cuda",
         "source": FA_CSRC + "flash_attn_wgmma.cu",
         "replaces": "src/repro/kernels/flash_attn/flash_attn.py:78",
         "launches": lm["counts"]["wgmma"],
         "launches_by_path": {
             "lm_serve_bf16": lm["counts"]["wgmma"],
             "lm_prefill_f32_model": lm["counts_f32"]["wgmma"]},
         **_own(flash[(torch.bfloat16, 0)]),
         "shape": f"bf16, B={b} S={s} Hq={hq} Hkv={hkv} D={hd}, window 0",
         f"window_{w1}": _own(flash[(torch.bfloat16, w1)]),
         "row_check": flash["wgmma_rows"]},
        {"name": "flash_attention", "route": "cuda",
         "source": FA_CSRC + "flash_attn.cu",
         "replaces": "src/repro/kernels/flash_attn/flash_attn.py:78",
         "launches": lm["counts_f32"]["simt"],
         "launches_by_path": {
             "lm_serve_bf16": lm["counts"]["simt"],
             "lm_prefill_f32_model": lm["counts_f32"]["simt"],
             "note": "serves f32 and D = 16 or 32 only; launches are the "
                     "f32 model's prefill, the bf16 main path runs none"},
         **_simt_on_bf16(flash[(torch.bfloat16, 0)]),
         "shape": f"bf16, B={b} S={s} Hq={hq} Hkv={hkv} D={hd}, window 0 "
                  f"(the same inputs as flash_attention_wgmma)",
         f"window_{w1}": _simt_on_bf16(flash[(torch.bfloat16, w1)]),
         "f32_window_0": _own(flash[(torch.float32, 0)]),
         f"f32_window_{w1}": _own(flash[(torch.float32, w1)])},
    ]
    return {"kernels": kernels}


def _own(m: dict) -> dict:
    """A measured main shape's numbers for the kernel that served it."""
    return {k: v for k, v in m.items() if not k.startswith("simt_")}


def _simt_on_bf16(m: dict) -> dict:
    """The f32 kernel's numbers on the bf16 inputs of a measured main
    shape: its own time and error; the plain, bound and library times are
    those of the same inputs."""
    own = {k: v for k, v in _own(m).items()
           if k not in ("row_rel_err", "planted_faults")}
    return dict(own, ms=m["simt_ms"], max_abs_err=m["simt_max_abs_err"])


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card "
                         "(torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    libs = build_all([na_build.LIBRARY, fa_build.LIBRARY], verbose=True)
    print(f"build: {libs} in {time.perf_counter() - t0:.1f} s", flush=True)
    result = run(dev, FULL)
    check(threading.active_count() == 1,
          f"threads left running: {threading.enumerate()}")
    print(json.dumps(result))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
