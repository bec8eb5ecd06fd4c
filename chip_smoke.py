#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (the kernel library is built from the
sources in this checkout at first use); exits nonzero without a card.
Imports nothing of JAX or of the reference package ``repro``.

1. Builds the neighbor-aggregation kernel library (``nvcc``, sm_90a).
2. Kernel phase: holds the CUDA kernel against its plain torch version
   (``neighbor_agg_ref``) on the card — D = 128 and 172, K = 32,
   B = 65,536, f32 and bf16, fused epilogue on and off — plus ragged
   B/K/D, K = 0, an out-of-range id and an all-zero-weight case that must
   be exactly 0.  Tolerance: 1e-5 (f32) and 2e-2 (bf16), atol = rtol.
   Times each main variant with CUDA events (after warm-up) beside the
   plain version, one ``embedding_bag`` call (a yardstick the port never
   calls) and the byte bound.
3. Full-width serving phase: gnn-papers100m's widths (GraphSAGE, feat
   128, hidden 256, 172 classes, 2 layers, ELL K = 32, bf16, kernel on)
   on a 524,288-node synthetic graph: ``EmbeddingStore`` build, 256
   queries from 4 client threads through ``GNNServer``, an incremental
   ``update_features`` + ``refresh`` (twice: the first refresh also
   builds the store's reverse index).  The kernel's launch count is
   reset just before and read just after, and must be > 0.  Then every
   layer is checked against the plain forward (2e-2), every answer
   against the snapshot's argmax, and the refreshed tables against a
   fresh full rebuild (2e-2).
4. GCN phase (fused epilogue on the path): GCN in f32, hidden 256, on the
   same generator at n = 65,536, checked against the plain forward at
   1e-4, with its own launch count.

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
from repro_torch.core import gnn as G  # noqa: E402
from repro_torch.core.embedding_store import EmbeddingStore  # noqa: E402
from repro_torch.core.serving import GNNServer  # noqa: E402
from repro_torch.data.synth import make_preset  # noqa: E402
from repro_torch.kernels.neighbor_agg import ops  # noqa: E402
from repro_torch.kernels.neighbor_agg.build import build  # noqa: E402
from repro_torch.kernels.neighbor_agg.ref import neighbor_agg_ref  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
SOURCE = "src/repro_torch/kernels/neighbor_agg/csrc/neighbor_agg.cu"
REPLACES = "src/repro/kernels/neighbor_agg/neighbor_agg.py:192"


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Shapes of one run: ``FULL`` on the card; ``TINY`` only rehearses
    the control flow on the CPU (the kernel then takes its plain
    version, so nothing is measured)."""
    agg_n: int = 524_288           # feature-table rows of the kernel phase
    agg_b: int = 65_536            # = the serving chunk
    agg_k: int = 32
    agg_d: tuple = (128, 172)      # GraphSAGE layer 1 / layer 2 widths
    n_serve: int = 524_288
    chunk: int = 65_536
    n_gcn: int = 65_536
    queries: int = 256
    updates: int = 64
    iters: int = 20


FULL = Sizes()
TINY = Sizes(agg_n=600, agg_b=300, n_serve=3_000, chunk=700,
             n_gcn=1_000, queries=24, updates=8, iters=2)


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


def compare(name, dtype, out, ref) -> float:
    tol = TOL[dtype]
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


def serving_phase(dev, sz: Sizes) -> dict:
    """gnn-papers100m's widths through build -> queries -> refresh."""
    cfg = dataclasses.replace(get_config("gnn-papers100m"),
                              n_nodes=sz.n_serve)
    check(cfg.model == "graphsage" and cfg.dtype == "bfloat16"
          and cfg.use_agg_kernel and cfg.max_degree == 32,
          f"unexpected gnn-papers100m config {cfg}")
    t0 = time.perf_counter()
    graph = make_preset("papers-like", n=sz.n_serve, n_classes=172,
                        feat_dim=128, power_law=False, seed=0)
    gen_s = time.perf_counter() - t0
    params = G.init_gnn(torch.Generator().manual_seed(0), cfg, 128,
                        device=dev)
    t0 = time.perf_counter()
    store = EmbeddingStore(params, cfg, graph, chunk_size=sz.chunk,
                           max_deg=cfg.max_degree, device=dev)
    ell_s = time.perf_counter() - t0
    print(f"serve: graph n={graph.n} avg_deg={graph.avg_degree:.2f} "
          f"d_max={graph.d_max} (generated in {gen_s:.1f} s, ELL K="
          f"{store.K} in {ell_s:.1f} s)", flush=True)

    rng = np.random.default_rng(1)
    queries = [rng.integers(0, graph.n, size=int(rng.integers(1, 9)))
               for _ in range(sz.queries)]
    upd = [rng.choice(graph.n, size=sz.updates, replace=False)
           for _ in range(2)]
    upd_rows = [rng.normal(size=(sz.updates, 128)).astype(np.float32)
                for _ in range(2)]

    # ---- the main path, between the launch-count reset and its read
    ops.launches = 0
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
    ops.launches = 0
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
    serve = serving_phase(dev, sz)
    gcn = gcn_phase(dev, sz)
    d = max(sz.agg_d)
    kernels = []
    for name, key, launches, variant in (
            ("neighbor_agg_tiled", (torch.bfloat16, d, False),
             serve["launches"], "bf16, unfused"),
            ("neighbor_agg_tiled_fused", (torch.float32, d, True),
             gcn["launches"], "f32, fused self epilogue")):
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": launches,
            **measured[key],
            "shape": f"{variant}, B={sz.agg_b} K={sz.agg_k} D={d} "
                     f"N={sz.agg_n}"})
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
