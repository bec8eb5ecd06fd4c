#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (the kernel library is built from the
sources in this checkout at first use, one ``nvcc`` per source, all
started together); exits nonzero without a card.  Imports nothing of JAX
or of the reference package ``repro``.

1. Builds the neighbor-aggregation kernel library (``nvcc``, sm_90a).
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
   Every timed variant is timed with CUDA events beside its plain
   version, one PyTorch library call (``embedding_bag`` forward, or its
   backward) and the bound.
5. Training phase at full width: gnn-papers100m (GraphSAGE, feat 128,
   hidden 256, 172 classes, 2 layers, ELL K = 32, bf16 full-graph
   aggregation, kernels on) on a 524,288-node graph through the port's
   ``Trainer``: 5 full-graph GD steps and 20 mini-batch SGD steps at
   b = 8192, fan-out (15, 10), prefetcher on.  The tiled-forward and
   backward launch counts are reset just before and read just after;
   both must be > 0.  Losses must be finite and the last full-graph loss
   below the first; one step's parameter gradients with the kernels on
   must match the plain path (relative max error 2e-2 for bf16
   full-graph, 1e-4 for f32 mini-batch).
6. Full-width serving phase on the same graph: ``EmbeddingStore``
   build, 256 queries from 4 client threads through ``GNNServer``, two
   incremental ``update_features`` + ``refresh`` rounds, checked against
   the plain forward (2e-2), the snapshot's argmax and a fresh rebuild.
7. GCN phase (fused epilogue on the path): GCN in f32, hidden 256, at
   n = 65,536, checked against the plain forward at 1e-4.

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
from repro_torch.kernels.neighbor_agg import ops  # noqa: E402
from repro_torch.kernels.neighbor_agg.build import build  # noqa: E402
from repro_torch.kernels.neighbor_agg.ref import (  # noqa: E402
    neighbor_agg_backward_ref, neighbor_agg_ref)

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# gradients: dfeats sums with f32 atomics in no fixed order (f32); one
# rounding of each cotangent to bf16 (bf16)
GTOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
TRAIN_LR = 0.3                 # the reference TrainPlan's default
CSRC = "src/repro_torch/kernels/neighbor_agg/csrc/"
REF_AGG = "src/repro/kernels/neighbor_agg/"


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


FULL = Sizes()
TINY = Sizes(agg_n=600, agg_b=300, n_serve=3_000, chunk=700,
             n_gcn=1_000, queries=24, updates=8, iters=2, path_iters=1,
             full_steps=3, mb_steps=4, mb_b=64)


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
                _, err = check_grads(name, dtype, case)
                print(f"{name}: max_err={err:.3g}", flush=True)
        feats, idx, w, _, _ = make_case(gen, dev, 64, 100, sz.agg_k, 172,
                                        dtype, False, zero=True)
        g = torch.randn(100, 172, generator=gen, device=dev).to(dtype)
        df = ops.neighbor_agg_backward(feats, idx, w, g, need=all4)[0]
        check(bool((df == 0).all()), f"backward zero weights {dtype}: "
              f"dfeats not all 0")
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
            idx[3, 2], w[3, 2] = 0, 0
            compare(f"backward out-of-range id {dtype} dfeats", dtype, df,
                    neighbor_agg_backward_ref(feats, idx, w, g)[0],
                    GTOL[dtype])
        print(f"backward zero-weights {str(dtype)[6:]}: dfeats exactly 0; "
              f"out-of-range id: NaN dw, no atomics", flush=True)

    # ---- the training-path shapes: autograd asks for dfeats only
    need = (True, False, False, False)
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
          f"{after_f['backward'] / len(lf):.2f} backward per step, eval "
          f"included), test_acc={res_f.final_test_acc:.4f}", flush=True)
    tm = src_m.timing
    nb = max(tm["batches"], 1)
    print(f"train: mini-batch SGD, {len(lm)} steps, b={sz.mb_b} fan-out "
          f"{sz.mb_fanout} (prefetch on): first/last loss {lm[0]:.5f} / "
          f"{lm[-1]:.5f}, {per_step_ms(res_m.history):.2f} ms/step steady, "
          f"run {wall_m:.3f} s, launches {launches_m} "
          f"({launches_m['tiled'] / len(lm):.2f} tiled + "
          f"{launches_m['backward'] / len(lm):.2f} backward per step, eval "
          f"included), test_acc={res_m.final_test_acc:.4f}", flush=True)
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
        check(counts["tiled"] > 0 and counts["backward"] > 0,
              f"training path launched the kernels {counts}")

    # ---- checks and timings outside the counted window
    params = res_m.params
    leaves = [v for p in params for v in p.values()]
    out = {"counts": counts, "full_ms": per_step_ms(res_f.history),
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
    d = max(sz.agg_d)
    cell = f"B={sz.agg_b} K={sz.agg_k} D={d} N={sz.agg_n}"
    kernels = [
        {"name": "neighbor_agg_tiled", "route": "cuda",
         "source": CSRC + "neighbor_agg.cu",
         "replaces": REF_AGG + "neighbor_agg.py:192",
         "launches": train["counts"]["tiled"],
         "launches_by_path": {"train": train["counts"]["tiled"],
                              "serve": serve["launches"]},
         **measured[(torch.bfloat16, d, False)],
         "shape": f"bf16, unfused, {cell}"},
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
         "launches_by_path": {"train": train["counts"]["backward"]},
         **bwd["fullgraph_l2"]},
        {"name": "neighbor_agg_row", "route": "cuda",
         "source": CSRC + "neighbor_agg_row.cu",
         "replaces": REF_AGG + "neighbor_agg.py:85",
         "launches": train["counts"]["row"],
         "launches_by_path": {"train": train["counts"]["row"],
                              "note": "on no model path: reached only "
                                      "through neighbor_agg(kernel='row')"},
         **row[(torch.bfloat16, d)],
         "shape": f"bf16, {cell}"},
    ]
    return {"kernels": kernels}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card "
                         "(torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    print(f"build: {build(verbose=True)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
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
