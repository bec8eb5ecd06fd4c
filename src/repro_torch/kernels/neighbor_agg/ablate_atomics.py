"""Vector against scalar atomics in the backward kernel's general mode, on
the same inputs in one process (one H100).

The general mode (``csrc/neighbor_agg_bwd.cu``, ``neighbor_agg_backward``)
sums dfeats with Hopper's vector reductions (``red_add``: ``atomicAdd`` on
``float4`` / ``float2``).  This script builds the library twice from the
checkout's sources, once as it stands and once with ``red_add`` rewritten
to one scalar ``atomicAdd`` a column (``scalar_red_add_source``), and
times both in turns at the full-graph layer-2 shape: the papers-like
graph of 524,288 nodes as a degree-capped ELL (K = 32, GraphSAGE mask
weights), bf16, D = 172, dfeats only.  Each timed call zeroes the f32
buffer and launches, as the wrapper does; both results are held against
the plain version (``allclose`` at 2e-2, bf16, as ``chip_smoke.py``
does).  Prints one JSON line.

    PYTHONPATH=src python -m repro_torch.kernels.neighbor_agg.ablate_atomics
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import time

import torch

#: ``red_add`` in ``neighbor_agg_bwd.cu``: its template line to the
#: closing brace at the start of a line
_RED_ADD = re.compile(r"template <int V>\n__device__ __forceinline__ void "
                      r"red_add\(float\* p, const float\* v\) \{\n.*?\n\}\n",
                      re.S)
_SCALAR = """template <int V>
__device__ __forceinline__ void red_add(float* p, const float* v) {
#pragma unroll
  for (int i = 0; i < V; ++i) atomicAdd(p + i, v[i]);
}
"""


def scalar_red_add_source(src: str) -> str:
    """``neighbor_agg_bwd.cu``'s text with ``red_add`` as one scalar
    ``atomicAdd`` a column; raises if the function is not found once."""
    out, n = _RED_ADD.subn(_SCALAR, src)
    if n != 1:
        raise RuntimeError(f"red_add found {n} times, not once")
    return out


def _libraries():
    """The library as it stands and its scalar-atomics variant, built
    together (the variant's sources under ``_build/scalar_atomics``)."""
    from repro_torch.kernels.build import Library, build_all
    from repro_torch.kernels.neighbor_agg import build as nb
    here = os.path.dirname(os.path.abspath(__file__))
    var_dir = os.path.join(here, "_build", "scalar_atomics")
    shutil.rmtree(var_dir, ignore_errors=True)
    shutil.copytree(os.path.join(here, "csrc"), os.path.join(var_dir, "csrc"))
    path = os.path.join(var_dir, "csrc", "neighbor_agg_bwd.cu")
    with open(path) as f:
        text = scalar_red_add_source(f.read())
    with open(path, "w") as f:
        f.write(text)
    libs = [nb.LIBRARY, Library(var_dir, "neighbor_agg", nb._declare)]
    t0 = time.perf_counter()
    build_all(libs)
    return [lib.load() for lib in libs], time.perf_counter() - t0


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
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
        print("ablate_atomics: no CUDA device", flush=True)
        return 1
    from repro_torch.core.graph import to_ell
    from repro_torch.data.synth import make_preset
    from repro_torch.kernels.neighbor_agg.ref import neighbor_agg_backward_ref
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    (vec_lib, sc_lib), build_s = _libraries()
    graph = make_preset("papers-like", n=524_288, n_classes=172,
                        feat_dim=128, power_law=False, seed=0)
    idx_h, w_h, _ = to_ell(graph, max_deg=32)
    gen = torch.Generator(device=dev).manual_seed(2)
    n, d = graph.n, 172
    feats = torch.randn(n, d, generator=gen, device=dev).to(torch.bfloat16)
    idx = torch.as_tensor(idx_h, device=dev)
    w = torch.as_tensor(w_h > 0, device=dev).to(torch.bfloat16)
    b, k = idx.shape
    g = torch.randn(b, d, generator=gen, device=dev).to(torch.bfloat16)
    df = torch.empty(n, d, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(lib):
        df.zero_()
        err = lib.neighbor_agg_backward(
            1, feats.data_ptr(), idx.data_ptr(), w.data_ptr(), g.data_ptr(),
            None, None, df.data_ptr(), None, None, None, n, b, k, d, stream)
        if err:
            raise RuntimeError(f"neighbor_agg_backward returned {err}")

    want = neighbor_agg_backward_ref(
        feats, idx, w, g, need=(True, False, False, False))[0].float()
    errs = {}
    for label, lib in (("vector", vec_lib), ("scalar", sc_lib)):
        run(lib)
        torch.cuda.synchronize(dev)
        got = df.to(torch.bfloat16).float()
        errs[label] = float((got - want).abs().max())
        if not torch.allclose(got, want, atol=2e-2, rtol=2e-2):
            raise RuntimeError(f"{label} atomics: max error {errs[label]} "
                               f"beyond 2e-2")
    turns = {"vector": [], "scalar": []}
    for label in ("vector", "scalar", "scalar", "vector", "vector",
                  "scalar"):
        turns[label].append(_time_ms(
            lambda: run(vec_lib if label == "vector" else sc_lib), 10))
    out = {"card": card, "shape": f"bf16 N={n} B={b} K={k} D={d}, real ELL "
           f"(papers-like, GraphSAGE mask weights), dfeats only",
           "build_s": build_s, "max_abs_err": errs, "turns_ms": turns,
           "mean_ms": {k_: sum(v) / len(v) for k_, v in turns.items()}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
