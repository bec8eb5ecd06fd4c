"""Serving entry point, the torch counterpart of ``repro.launch.serve``:
the GNN family (layer-wise embed -> EmbeddingStore -> GNNServer) and the
decoders of every LM family (prefill + decode steps):

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \
        --smoke --device cpu --temperature 0
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --batch 2 --prompt-len 4096 --temperature 0

The smoke path builds a small synthetic graph, runs the layer-wise
embedding pass, CHECKS it per layer against the plain full-graph forward,
answers N micro-batched queries (from concurrent client threads),
verifies every answer against the forward's argmax, then mutates a few
node features and re-serves through the incremental re-embed path.  A
write-load phase follows: a writer thread streams feature updates
through the WAL while concurrent clients query, with one injected
mid-refresh crash (``store.mid_layer_refresh``) killing the background
refresh scheduler — answers must keep coming from the last consistent
snapshot; then a tight ``max_staleness_s`` SLO forces a synchronous
refresh and the served answers must match the fully updated forward.
Exit is nonzero on any mismatch.

The decoder path serves randomly initialised weights drawn from
``--seed`` (as the reference does), in the config's dtype: a random
prompt of ``--batch`` x ``--prompt-len`` tokens through ``prefill`` (the
flash-attention kernel in every layer on the card), then ``--gen``
decode steps, greedy at ``--temperature 0`` and sampled with a seeded
``torch.Generator`` above it; the VLM's patches and whisper's frames are
zeros of the reference's shapes.  It prints the reference's JSON keys.
Runs on ``cuda`` unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device


def serve_gnn(args, cfg) -> int:
    from repro_torch.core import faults
    from repro_torch.core import gnn as G
    from repro_torch.core.embedding_store import EmbeddingStore
    from repro_torch.core.serving import GNNServer
    from repro_torch.data.synth import make_preset

    if not args.smoke:
        raise SystemExit(
            "gnn serving currently has only the synthetic --smoke path; "
            "re-run with --smoke")
    dev = resolve_device(args.device)
    # the h @ W products are full f32, like the reference's
    torch.backends.cuda.matmul.allow_tf32 = False

    graph = make_preset(args.preset, n=args.nodes, seed=args.seed)
    cfg = dataclasses.replace(
        cfg, n_nodes=graph.n, feat_dim=graph.feats.shape[1],
        n_classes=graph.n_classes, use_agg_kernel=args.kernel)
    params = G.init_gnn(torch.Generator().manual_seed(args.seed), cfg,
                        graph.feats.shape[1], device=dev)

    def forward(return_layers=False):
        plain = dataclasses.replace(cfg, use_agg_kernel=False)
        t = [torch.as_tensor(a, device=dev) for a in
             (store.graph.feats, store.idx, store.w, store.w_self)]
        return G.full_graph_forward(params, plain, *t,
                                    return_layers=return_layers)

    def argmax(x):
        return np.argmax(x.cpu().numpy(), -1)

    store = EmbeddingStore(params, cfg, graph, chunk_size=args.chunk,
                           device=dev)
    run = store.build()

    # layer-wise output must equal the plain full-graph forward
    naive_logits, naive_layers = forward(return_layers=True)
    layers_ok = all(torch.allclose(a, b, rtol=1e-5, atol=1e-5)
                    for a, b in zip(run.layers, naive_layers))
    expect = argmax(naive_logits)

    # batched queries from concurrent clients through the micro-batcher
    rng = np.random.default_rng(args.seed + 1)
    queries = [rng.integers(0, graph.n, size=rng.integers(1, 9))
               for _ in range(args.queries)]
    server = GNNServer(store, max_batch=args.max_batch,
                       max_wait_ms=args.max_wait_ms)
    try:
        with ThreadPoolExecutor(max_workers=args.concurrency) as pool:
            answers = list(pool.map(
                lambda q: server.classify(q, timeout=60.0), queries))
    finally:
        server.close()
    st = server.stats()
    serve_ok = all(np.array_equal(a, expect[q])
                   for a, q in zip(answers, queries))
    counters_ok = (st["n_queries"] == sum(len(q) for q in queries)
                   and st["n_batches"] >= 1 and st["p99_ms"] > 0.0
                   and st["p99_ms"] >= st["p50_ms"])

    # incremental path: perturb features, re-serve, re-verify
    upd = rng.choice(graph.n, size=args.updates, replace=False)
    store.update_features(
        upd, rng.normal(size=(args.updates, graph.feats.shape[1]))
        .astype(np.float32))
    refresh = store.refresh()
    post_expect = argmax(forward())
    check = rng.integers(0, graph.n, size=64)
    update_ok = np.array_equal(store.predict(check), post_expect[check])
    incremental = 0 < refresh["total_rows"] < graph.n * cfg.n_layers

    # ---- write-load phase A: concurrent writer + queries + one injected
    # mid-refresh crash.  The scheduler thread dies on its first
    # re-embed attempt, so NO new version can be published — every
    # concurrent answer must come from the last consistent snapshot.
    v0 = store.version
    old_hook = threading.excepthook
    threading.excepthook = lambda a: None     # the injected crash is loud
    wserver = GNNServer(store, max_batch=args.max_batch,
                        max_wait_ms=args.max_wait_ms,
                        max_staleness_s=30.0,      # loose: scheduler owns
                        refresh_every_updates=4)   # the refresh cadence
    try:
        faults.arm("store.mid_layer_refresh", at_hits=(0,))

        def _writer():
            w_rng = np.random.default_rng(args.seed + 2)
            for _ in range(8):
                nodes = w_rng.choice(graph.n, size=2, replace=False)
                store.update_features(
                    nodes, w_rng.normal(size=(2, graph.feats.shape[1]))
                    .astype(np.float32))
                time.sleep(0.003)

        wt = threading.Thread(target=_writer)
        wt.start()
        wqueries = [rng.integers(0, graph.n, size=8) for _ in range(32)]
        with ThreadPoolExecutor(max_workers=args.concurrency) as pool:
            wanswers = list(pool.map(
                lambda q: wserver.submit(q, with_meta=True)
                .result(timeout=60.0), wqueries))
        wt.join(timeout=60.0)
        sched = store._sched_thread
        if sched is not None:
            sched.join(timeout=30.0)          # killed by the failpoint
    finally:
        faults.disarm()
        wserver.close()
        threading.excepthook = old_hook
    chaos_ok = (store.version == v0 and store.dirty
                and all(a.snapshot_version == v0
                        and np.array_equal(a.preds, post_expect[q])
                        for a, q in zip(wanswers, wqueries)))

    # recovery: a manual refresh catches up on everything the crashed
    # scheduler left in the WAL/dirty masks
    store.refresh()
    rec_expect = argmax(forward())
    recovery_ok = (store.version == v0 + 1 and not store.dirty
                   and np.array_equal(store.predict_meta(check)[0],
                                      rec_expect[check]))

    # ---- write-load phase B: hard staleness SLO — aged updates force a
    # synchronous refresh on the serve path, so the answer is fresh
    slo_server = GNNServer(store, max_batch=args.max_batch,
                           max_wait_ms=args.max_wait_ms,
                           max_staleness_s=0.05)
    try:
        upd2 = rng.choice(graph.n, size=4, replace=False)
        store.update_features(
            upd2, rng.normal(size=(4, graph.feats.shape[1]))
            .astype(np.float32))
        time.sleep(0.1)                       # age past the bound
        ans = slo_server.submit(check, with_meta=True).result(timeout=60.0)
        slo_stats = slo_server.stats()
    finally:
        slo_server.close()
    slo_expect = argmax(forward())
    slo_ok = (ans.staleness_s <= 0.05
              and ans.snapshot_version == store.version
              and slo_stats["n_forced_refresh"] >= 1
              and np.array_equal(ans.preds, slo_expect[check]))

    ok = (layers_ok and serve_ok and counters_ok and update_ok
          and chaos_ok and recovery_ok and slo_ok)
    print(json.dumps({
        "arch": args.arch, "family": "gnn", "model": cfg.model,
        "device": str(dev), "n_nodes": graph.n, "n_layers": cfg.n_layers,
        "kernel": bool(cfg.use_agg_kernel),
        "embed_ms_per_node": run.stats["ms_per_node"],
        "n_chunks": run.stats["n_chunks"],
        "layerwise_matches_naive": layers_ok,
        "serve": {k: round(v, 3) if isinstance(v, float) else v
                  for k, v in st.items()},
        "serve_answers_match_forward": serve_ok,
        "counters_populated": counters_ok,
        "update_reembedded_rows": refresh["total_rows"],
        "update_incremental": incremental,
        "post_update_answers_match_forward": update_ok,
        "write_phase": {
            "chaos_answers": len(wanswers),
            "chaos_served_version": int(v0),
            "chaos_old_snapshot_consistent": chaos_ok,
            "recovery_refresh_consistent": recovery_ok,
            "slo_forced_refreshes": int(slo_stats["n_forced_refresh"]),
            "slo_staleness_s": round(float(ans.staleness_s), 4),
            "slo_fresh_and_consistent": slo_ok,
        },
        "ok": ok,
    }, indent=2))
    return 0 if ok else 1


def stub_inputs(cfg, batch: int, device) -> dict:
    """The stub frontends' inputs (reference ``launch/serve.py:246-250``):
    zero patch embeddings [B, frontend_seq, d] for the VLM, zero frame
    embeddings [B, enc_seq, d] for whisper, in the compute dtype."""
    from repro_torch.models.model import _dt
    out = {}
    if cfg.frontend_seq:
        out["patches"] = torch.zeros(batch, cfg.frontend_seq, cfg.d_model,
                                     dtype=_dt(cfg), device=device)
    if cfg.n_enc_layers:
        out["frames"] = torch.zeros(batch, cfg.enc_seq, cfg.d_model,
                                    dtype=_dt(cfg), device=device)
    return out


def serve_decoder(args, cfg) -> int:
    """Prefill + decode of any decoder family (reference
    ``launch/serve.py:230-283``); the VLM and whisper take zeros for
    their stub frontends' embeddings."""
    from repro_torch.models import model as M
    from repro_torch.models import steps

    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = M.init_model(gen, cfg, dev, dtype=M._dt(cfg))
    rng = np.random.default_rng(args.seed)
    b, s = args.batch, args.prompt_len
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (b, s)), device=dev)}
    batch.update(stub_inputs(cfg, b, dev))
    prefill = steps.make_prefill_step(cfg)
    decode = steps.make_serve_step(cfg)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def pick(logits):
        if args.temperature > 0:
            probs = torch.softmax(logits.float() / args.temperature, -1)
            return torch.multinomial(probs, 1, generator=gen)
        return logits.argmax(-1, keepdim=True)

    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch)
        sync()
        t_prefill = time.perf_counter() - t0

        toks = []
        tok = logits.argmax(-1, keepdim=True)
        t0 = time.perf_counter()
        for _ in range(args.gen):
            toks.append(tok[:, 0])
            logits, cache = decode(params, cache, tok)
            tok = pick(logits)
        sync()
        t_dec = time.perf_counter() - t0

    out = torch.stack(toks, 1).cpu().numpy()
    print(json.dumps({
        "arch": args.arch,
        "device": str(dev),
        "prefill_s": round(t_prefill, 4),
        "decode_tok_per_s": round(args.batch * args.gen / t_dec, 2),
        "generated_shape": list(out.shape),
        "sample_tokens": out[0][:16].tolist(),
    }, indent=2))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gnn-papers100m",
                    help="config name (default: the GNN serving smoke)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless told otherwise)")
    # decoder knobs
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=1.0)
    # gnn serving knobs
    ap.add_argument("--preset", default="arxiv-like")
    ap.add_argument("--nodes", type=int, default=400,
                    help="synthetic graph size for the smoke")
    ap.add_argument("--chunk", type=int, default=128,
                    help="layer-wise inference chunk size")
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--concurrency", type=int, default=4)
    ap.add_argument("--updates", type=int, default=6,
                    help="feature updates for the incremental re-serve")
    ap.add_argument("--kernel", action="store_true",
                    help="route aggregation through the CUDA kernel "
                         "(its plain version on the CPU)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family == "gnn":
        return serve_gnn(args, cfg)
    return serve_decoder(args, cfg)


if __name__ == "__main__":
    sys.exit(main())
