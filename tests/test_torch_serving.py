"""The port's serving path — layer-wise inference, EmbeddingStore,
GNNServer, the serve smoke — against the live reference on the CPU.

Parameters come from the reference's ``init_gnn`` (carried across with
``params_from_numpy``); the reference oracle is its plain full-graph
forward.  Tolerance 1e-5 (f32) for layer tables; refreshed tables vs a
fresh store at rtol 1e-4 / atol 1e-5, as the reference's own store tests
(edge rebuilds reorder CSR neighbor lists, which permutes float sums)."""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import GNNConfig as RefConfig  # noqa: E402
from repro.core import gnn as RG  # noqa: E402
from repro.core.embedding_store import EmbeddingStore as RefStore  # noqa: E402
from repro.core.graph import to_ell  # noqa: E402
from repro.core.serving import GNNServer as RefServer  # noqa: E402

from repro_torch.configs.base import GNNConfig  # noqa: E402
from repro_torch.core import faults  # noqa: E402
from repro_torch.core import gnn as TG  # noqa: E402
from repro_torch.core.embedding_store import EmbeddingStore  # noqa: E402
from repro_torch.core.graph import Graph  # noqa: E402
from repro_torch.core.inference import (  # noqa: E402
    layerwise_embeddings, layerwise_layers, layerwise_logits)
from repro_torch.core.serving import GNNServer  # noqa: E402
from repro_torch.launch import serve  # noqa: E402


def _kw(g, **kw):
    d = dict(name="srv", model="gcn", n_nodes=g.n, feat_dim=g.feats.shape[1],
             hidden=8, n_classes=g.n_classes, n_layers=2, fanout=(4, 3),
             batch_size=32, loss="ce", use_agg_kernel=False,
             agg_interpret=True, agg_b_tile=4, agg_d_tile=8, agg_k_slab=2)
    d.update(kw)
    return d


def _port_graph(g) -> Graph:
    """A port ``Graph`` with its own copies of the reference graph's
    arrays (stores write feature updates into ``graph.feats``)."""
    return Graph(**{f.name: (np.array(getattr(g, f.name), copy=True)
                             if f.name != "n" else g.n)
                    for f in dataclasses.fields(g)})


def _params(kw, g, seed=0):
    ref = RG.init_gnn(jax.random.key(seed), RefConfig(**kw),
                      g.feats.shape[1])
    return ref, TG.params_from_numpy(
        [{k: np.asarray(v) for k, v in p.items()} for p in ref],
        device="cpu")


def _ref_naive(params, kw, g):
    idx, w, ws = to_ell(g)
    _, layers = RG.full_graph_forward(
        params, RefConfig(**dict(kw, use_agg_kernel=False)),
        jnp.asarray(g.feats), jnp.asarray(idx), jnp.asarray(w),
        jnp.asarray(ws), return_layers=True)
    return [np.asarray(x) for x in layers]


def _assert_layers_close(got, want, rtol=1e-5, atol=1e-5):
    assert len(got) == len(want)
    for li, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=atol, err_msg=f"layer {li}")


_NAIVE = {}


@pytest.mark.parametrize("model,kernel", [
    ("gcn", False), ("gcn", True),
    ("graphsage", False), ("graphsage", True),
    ("gat", False),
])
# 37 does not divide n=300, 150 does, 999 > n collapses to one chunk
@pytest.mark.parametrize("chunk", [37, 150, 999])
def test_layerwise_matches_reference(small_graph, model, kernel, chunk):
    kw = _kw(small_graph, model=model, use_agg_kernel=kernel)
    ref_params, params = _params(kw, small_graph)
    if model not in _NAIVE:
        _NAIVE[model] = _ref_naive(ref_params, kw, small_graph)
    run = layerwise_embeddings(params, GNNConfig(**kw),
                               _port_graph(small_graph), chunk_size=chunk,
                               device="cpu")
    _assert_layers_close(run.layers, _NAIVE[model])
    assert run.stats["n_chunks"] == -(-small_graph.n
                                      // min(chunk, small_graph.n))
    assert run.stats["chunk_steps"] == 2 * run.stats["n_chunks"]
    assert run.stats["total_s"] > 0 and run.stats["ms_per_node"] > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layerwise_equals_port_forward(small_graph, dtype):
    """Chunked layer-wise == the port's own full-graph forward on the
    kernel path (bf16 too: the per-layer cast happens once, as the
    forward's does, so the two agree to the last bit)."""
    kw = _kw(small_graph, model="graphsage", dtype=dtype,
             use_agg_kernel=True, hidden=32)
    _, params = _params(kw, small_graph, seed=5)
    cfg = GNNConfig(**kw)
    g = _port_graph(small_graph)
    got = layerwise_embeddings(params, cfg, g, chunk_size=64,
                               device="cpu").layers
    t = [torch.as_tensor(a) for a in (g.feats, *to_ell(small_graph))]
    _, want = TG.full_graph_forward(params, cfg, *t, return_layers=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_layerwise_three_layers_width_shrink(small_graph):
    for model in ("gcn", "graphsage"):
        kw = _kw(small_graph, model=model, n_layers=3, fanout=(4, 3, 3),
                 use_agg_kernel=True)
        ref_params, params = _params(kw, small_graph, seed=1)
        run = layerwise_embeddings(params, GNNConfig(**kw),
                                   _port_graph(small_graph), chunk_size=64,
                                   device="cpu")
        _assert_layers_close(run.layers,
                             _ref_naive(ref_params, kw, small_graph))


def test_layerwise_logits_and_prefetch_off_bit_identical(small_graph):
    kw = _kw(small_graph, model="graphsage", use_agg_kernel=True)
    _, params = _params(kw, small_graph, seed=3)
    cfg, g = GNNConfig(**kw), _port_graph(small_graph)
    r1 = layerwise_embeddings(params, cfg, g, chunk_size=40, prefetch=True,
                              device="cpu")
    r2 = layerwise_embeddings(params, cfg, g, chunk_size=40, prefetch=False,
                              device="cpu")
    for a, b in zip(r1.layers, r2.layers):
        assert torch.equal(a, b)
    assert torch.equal(layerwise_logits(params, cfg, g, chunk_size=40,
                                        device="cpu"), r1.logits)


def test_empty_graph_rejected(small_graph):
    kw = _kw(small_graph)
    _, params = _params(kw, small_graph)
    with pytest.raises(ValueError, match="n=0"):
        layerwise_layers(params, GNNConfig(**kw),
                         np.zeros((0, 16), np.float32), to_ell(small_graph),
                         device="cpu")


def _stores(small_graph, **kw):
    kw = _kw(small_graph, **kw)
    ref_params, params = _params(kw, small_graph)
    ref = RefStore(ref_params, RefConfig(**kw), _port_graph(small_graph),
                   chunk_size=48)
    ours = EmbeddingStore(params, GNNConfig(**kw), _port_graph(small_graph),
                          chunk_size=48, device="cpu")
    ref.build()
    ours.build()
    return ref, ours, params, GNNConfig(**kw)


def _assert_matches_fresh(store, params, cfg):
    fresh = EmbeddingStore(params, cfg, _port_graph(store.graph),
                           chunk_size=48, device="cpu")
    fresh.build()
    _assert_layers_close(store.layers, fresh.layers, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("model,kernel", [("graphsage", False),
                                          ("gcn", False), ("gcn", True)])
def test_store_feature_update_refresh(small_graph, model, kernel):
    ref, ours, params, cfg = _stores(small_graph, model=model,
                                     use_agg_kernel=kernel)
    _assert_layers_close(ours.layers, ref.layers)
    rng = np.random.default_rng(1)
    nodes = rng.choice(small_graph.n, size=6, replace=False)
    rows = rng.normal(size=(6, 16)).astype(np.float32)
    for s in (ref, ours):
        s.update_features(nodes, rows)
        assert s.dirty
    info_ref, info = ref.refresh(), ours.refresh()
    assert not ours.dirty
    assert info["rows_per_layer"] == info_ref["rows_per_layer"]
    assert info["total_rows"] < small_graph.n * cfg.n_layers
    _assert_layers_close(ours.layers, ref.layers)
    _assert_matches_fresh(ours, params, cfg)


def test_store_edge_update_refresh(small_graph):
    ref, ours, params, cfg = _stores(small_graph, model="graphsage")
    src, dst = [0, 5, 17, 200], [150, 9, 299, 3]
    for s in (ref, ours):
        s.add_edges(src, dst)
    np.testing.assert_array_equal(ours.idx, ref.idx)
    np.testing.assert_array_equal(ours.w, ref.w)
    info_ref, info = ref.refresh(), ours.refresh()
    assert info["rows_per_layer"] == info_ref["rows_per_layer"]
    _assert_layers_close(ours.layers, ref.layers)
    _assert_matches_fresh(ours, params, cfg)
    # nothing pending: a refresh is a 0-row no-op
    assert ours.refresh()["total_rows"] == 0


def test_snapshot_tables_immutable_across_refresh(small_graph):
    """torch writes in place: a refresh must clone each table it changes
    (copy-on-write), so a reader holding the old snapshot never sees a
    row move.  A store writing refreshed rows straight into the
    published tables fails here."""
    _, ours, _, _ = _stores(small_graph, model="gcn", use_agg_kernel=True)
    held = ours.snapshot()
    before = [t.clone() for t in held.layers]
    final_before = held.final_np.copy()
    rng = np.random.default_rng(2)
    ours.update_features(rng.choice(small_graph.n, 10, replace=False),
                         rng.normal(size=(10, 16)).astype(np.float32))
    info = ours.refresh()
    assert info["total_rows"] > 0
    new = ours.snapshot()
    assert new.version == held.version + 1
    for t_old, t_was, t_new in zip(held.layers, before, new.layers):
        assert torch.equal(t_old, t_was)          # untouched
        assert not torch.equal(t_new, t_was)      # the refresh did land
        assert t_new.data_ptr() != t_old.data_ptr()
    np.testing.assert_array_equal(held.final_np, final_before)
    assert not held.final_np.flags.writeable


def test_crash_before_swap_keeps_old_snapshot(small_graph):
    _, ours, _, _ = _stores(small_graph)
    v0, snap0 = ours.version, ours.snapshot()
    ours.update_features([3, 4], np.ones((2, 16), np.float32))
    with faults.armed("store.before_swap"):
        with pytest.raises(faults.SimulatedCrash):
            ours.refresh()
    assert ours.version == v0 and ours.snapshot() is snap0 and ours.dirty
    ours.refresh()
    assert ours.version == v0 + 1 and not ours.dirty


def test_transient_refresh_fault_is_retried(small_graph):
    _, ours, _, _ = _stores(small_graph)
    ours.update_features([7], np.ones((1, 16), np.float32))
    with faults.armed("store.mid_layer_refresh", at_hits=(0,),
                      exc=faults.TransientRefreshFault):
        info = ours.refresh_with_recovery(backoff_s=0.001)
    assert info["total_rows"] > 0 and not ours.dirty
    assert ours.refresh_stats()["transient_retries"] == 1


def test_server_answers_equal_reference_server(small_graph):
    ref, ours, _, _ = _stores(small_graph, model="graphsage",
                              use_agg_kernel=True)
    rng = np.random.default_rng(0)
    queries = [rng.integers(0, small_graph.n, size=rng.integers(1, 12))
               for _ in range(12)]
    with RefServer(ref, max_batch=16, max_wait_ms=1.0) as rs, \
            GNNServer(ours, max_batch=16, max_wait_ms=1.0) as ts:
        want = [rs.classify(q) for q in queries]
        got = [ts.submit(q, with_meta=True).result(timeout=30.0)
               for q in queries]
        st = ts.stats()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.preds, b)
        assert a.snapshot_version == 1 and a.staleness_s == 0.0
    assert st["n_requests"] == 12 and st["p99_ms"] >= st["p50_ms"] > 0.0


@pytest.mark.parametrize("kernel", [False, True])
def test_serve_smoke_on_cpu(kernel, capsys):
    argv = ["--smoke", "--device", "cpu", "--nodes", "300", "--queries",
            "24"] + (["--kernel"] if kernel else [])
    assert serve.main(argv) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["ok"] and out["device"] == "cpu"
    assert out["kernel"] is kernel and out["update_incremental"]


def test_store_requires_card_unless_told_cpu(small_graph):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    kw = _kw(small_graph)
    _, params = _params(kw, small_graph)
    with pytest.raises(RuntimeError, match="cuda"):
        EmbeddingStore(params, GNNConfig(**kw), _port_graph(small_graph))


def test_chip_smoke_rehearsal_on_cpu():
    """chip_smoke.py's phases at a tiny size on the CPU (the kernels take
    their plain versions here, so this checks control flow, checks and
    the result line's keys — not the kernels)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    # one intra-op thread: its many small ops do not gain from more, and
    # beside other test workers on the host's cores more make them crawl
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        result = chip_smoke.run(torch.device("cpu"), chip_smoke.TINY)
    finally:
        torch.set_num_threads(threads)
    keys = {"name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms"}
    assert [k["name"] for k in result["kernels"]] == [
        "neighbor_agg_tiled", "neighbor_agg_tiled_fused",
        "neighbor_agg_backward", "neighbor_agg_backward_csr",
        "neighbor_agg_row", "flash_attention_wgmma", "flash_attention",
        "neighbor_agg_tiled_slab", "neighbor_agg_backward_identity"]
    for k in result["kernels"]:
        assert keys <= set(k) and k["route"] == "cuda"
        assert os.path.exists(k["source"])
        assert os.path.exists(k["replaces"].split(":")[0])
    # the gathers are bound by bytes; attention by bytes or operations
    # depending on S and D (operations at the full size)
    assert [k["bound_by"] for k in result["kernels"][:5]] == ["bytes"] * 5
    for k in result["kernels"][5:]:
        assert k["bound_by"] in ("bytes", "operations")
        assert k["launches"] == 0          # CPU: the plain version
    assert result["kernels"][5]["launches_by_path"] == {
        "lm_serve_bf16": 0, "lm_prefill_f32_model": 0, "zamba2_serve": 0,
        "zamba2_prefill_f32_model": 0, "llama4_serve": 0,
        "llama4_prefill_f32_model": 0, "mamba2_serve": 0,
        "whisper_serve": 0, "internvl2_serve": 0}
    rows = result["kernels"][5]["row_check"]
    assert rows["cases"] > 0 and rows["limit"] == 2.0 ** -7
    # the aggregation backward by shape, the reverse-index kernel's row
    # check and planted faults
    bwd, csr = result["kernels"][2], result["kernels"][3]
    assert set(bwd["by_shape"]) == {"minibatch_l2", "fullgraph_l2"}
    assert csr["row_check_limit"] == 2.0 ** -8
    assert csr["row_rel_err"] <= 2.0 ** -8 < min(
        csr["planted_faults"].values())
    assert len(csr["planted_faults"]) == 4 and csr["deterministic"]
    # the tiled forward: both routes, by shape, with the row check
    tiled, fused = result["kernels"][0], result["kernels"][1]
    cluster = sorted(x for x in tiled["by_shape"]
                     if x.startswith("cluster_batch_"))
    assert [x[x.rindex("_"):] for x in cluster] == ["_d128", "_d172"]
    # phase 12: one shard's shapes (the full-graph shard, featshard's
    # phase 1, the mini-batch levels at b/S)
    shard = sorted(x for x in tiled["by_shape"] if x.startswith(
        ("fullgraph_shard_", "featshard_", "minibatch_shard_")))
    assert [x[:x.index("_n") if "_n" in x else x.index("_b")]
            for x in shard] == ["featshard_phase1", "fullgraph_shard",
                                "fullgraph_shard", "minibatch_shard",
                                "minibatch_shard", "minibatch_shard"]
    assert set(tiled["by_shape"]) - set(cluster) - set(shard) == {
        "fullgraph_d128", "fullgraph_d172", "serving_chunk_d128",
        "serving_chunk_d172", "minibatch_l1_hop0", "minibatch_l1_hop1",
        "minibatch_l2_hop0"}
    assert [x[x.rindex("_"):] for x in csr["by_shape"]] == ["_d172"] * 2
    assert any(x.startswith("fullgraph_shard_") for x in csr["by_shape"])
    phase2 = set(fused["by_shape"]) - {"gcn_l1_d128", "gcn_l2_d172"}
    assert len(phase2) == 1 and phase2.pop().startswith("featshard_phase2")
    for m in [tiled, fused, *tiled["by_shape"].values(),
              *fused["by_shape"].values()]:
        if m["shape"].startswith("bf16 table, f32 sum: featshard"):
            # a featshard phase: its f32 sum has the direct route only
            assert "routes" not in m
            assert m["row_rel_err"] <= m["row_check_limit"] == 1e-5
            continue
        assert {"slab", "direct"} <= set(m["routes"])
        assert max(m["row_rel_err_by_route"].values()) <= \
            m["row_check_limit"]
    for d in ("fullgraph_d128", "fullgraph_d172"):
        faults = tiled["by_shape"][d]["planted_faults"]
        assert len(faults) == 4 and min(faults.values()) > 2.0 ** -8
        assert set(tiled["by_shape"][d]["routes"]["slab_width_ms"]) == {
            "32", "64", "128", "256"}
    # the top-level numbers are the serving chunk's; the slab kernel's
    # own entry is the full-graph shape of layer 1
    assert tiled["shape"].endswith("(the serving chunk)")
    slab = result["kernels"][7]
    assert slab["source"].endswith("neighbor_agg_slab.cu")
    assert slab["row_rel_err"] <= slab["row_check_limit"] < min(
        slab["planted_faults"].values())
    assert set(slab["slab_width_ms"]) == {"32", "64", "128", "256"}
    assert set(slab["launches_by_path"]) == set(
        tiled["launches_by_path_and_route"])
    assert set(tiled["sources"]) == {"slab", "direct"}
    assert set(tiled["launches_by_path_and_route"]) == {
        "train_fullgraph", "train_minibatch", "train_cluster",
        "train_importance", "serve", "gcn_serve",
        "train_fullgraph_sharded_s1", "train_featshard_s1",
        "train_minibatch_sharded_s1", "train_fullgraph_sharded_s4",
        "train_featshard_s4", "train_minibatch_sharded_s4",
        "serve_featshard_s4"}
    assert tiled["l2_table_sweep"]
    # the backward kernel's identity mode, last: its library call is the
    # broadcast product, the general mode timed beside it on its inputs
    ident = result["kernels"][8]
    assert ident["source"] == bwd["source"]
    assert ident["library_call"].startswith("torch.mul")
    assert ident["general_mode_ms_same_inputs"] == \
        bwd["by_shape"]["minibatch_l2"]["ms"]
    assert set(ident["figure_shapes"]) == {"minibatch_b128_k10_d64"}
    assert result["kernels"][4]["bit_equal_direct_route"]
