"""Dry-run of a step on one H100 or on a multi-card layout, with its
roofline (the port of the reference ``repro.launch.dryrun``).

For every (architecture x input shape) combination this runs the real
step function once on shape-only tensors (meta tensors on
``device.TRACE_DEVICE``: nothing is allocated and no card is needed)
under ``roofline.TraceCounter``, and stores one JSON
record per combination under ``--out`` (existing records are skipped
unless ``--force``):

* ``per_device_flops`` and ``flops_by_dtype`` (matmul FLOPs by input
  dtype, the kernels' from their byte and operation model),
  ``per_device_bytes`` (``bytes_model`` says how it counts);
* ``memory``: the arguments' bytes, the outputs' (new storages the step
  returns) and the temporaries' (the rest of the peak);
  ``device_bytes_total`` (the peak of live bytes) and ``fits_hbm``
  against the card's 80 GB;
* ``roofline`` (``roofline.roofline``: compute, memory and collective
  terms, dominant, bound); ``collective_bytes_per_device`` with the
  reference's keys (``roofline.collective_bytes``), all 0 on one card;
* for the LM ``params_total``, ``params_active``, ``model_flops_global``
  and ``model_vs_hlo_flops``; ``compile_seconds`` is the trace's time.

The kernel path stays as the config sets it (``gnn-papers100m``:
``use_agg_kernel=True``): the kernels' shape-only stand-ins take the
place of the launches, so no [n, K, d] gather is traced.  The reference
turns its kernel off for the dry-run because Mosaic does not lower on
the CPU.  Records are keyed ``arch__shape__<layout>``.

The layouts are ``launch.mesh``'s: ``1xH100`` (the default,
``--single-pod``), ``16x16xH100`` (``--mesh 16x16``) and
``2x16x16xH100`` (``--multi-pod`` or ``--mesh 2x16x16``); ``--all``
writes every arch at all three unless a layout is named.  A multi-card
record is one device's share: the step runs tensor-parallel
(``models.steps`` with the layout's mesh; the GNN NODES-sharded,
``gnn_steps``) on one shard's meta tensors (``sharding.layout_mesh``),
so ``per_device_flops``, ``per_device_bytes``, ``memory`` and
``device_bytes_total`` are that device's, ``fits_hbm`` holds them to one
card's 80 GB, the collective bytes are those its collectives noted
(``collective_bytes_by_axes`` beside them: the roofline divides each
axis's bytes by its link's rate; ``collective_bytes_bf16_partials``:
what they would be with the f32 partial products of a half-precision
model moved in its dtype, as the reference moves them) and ``chips`` is
the layout's.  The
data axes are traced as one data replica at its rows of the batch: every
replica runs the same program.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch gnn-papers100m --shape fullgraph_train --out /tmp/d
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch mamba2-130m --shape decode_32k --mesh 16x16 --out /tmp/d
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

from torch.utils._pytree import tree_map

from repro_torch.configs.base import (INPUT_SHAPES, InputShape, get_config,
                                      list_archs, shape_applicable)
from repro_torch.launch import gnn_steps
from repro_torch.launch.mesh import LAYOUTS, layout_name, \
    make_production_mesh
from repro_torch.launch.roofline import (
    TraceCounter, active_param_count, collective_bytes,
    collective_bytes_bf16_partials, model_flops, roofline)

BYTES_MODEL = ("eager, unfused: each aten op that is not a view or an "
               "allocation reads every tensor input and writes every "
               "output once; each kernel call adds its byte model "
               "(launch/roofline.py)")

GNN_SHAPES = ("fullgraph_train", "minibatch_train")


# gradient-accumulation depth for the train dry-runs: keeps activation
# memory bounded at the assigned global batch (256).  Big models use
# more micro-batches; the global batch and numerics are unchanged.
def microbatches_for(cfg, shape) -> int:
    if shape.kind != "train":
        return 1
    big = cfg.d_model * cfg.n_layers
    if big >= 3840 * 48:        # >= gemma3-12b scale
        return 8
    if big >= 2048 * 24:
        return 4
    return 2


def _trace(step, args, mesh, t0, extra: Dict[str, Any]) -> Dict[str, Any]:
    """Run ``step(*args)`` under a ``TraceCounter`` and make the record
    (``mesh``: the ``CardLayout``)."""
    with TraceCounter(*args) as tc:
        out = step(*args)
    out_b = tc.output_bytes(out)
    mem = {"argument_size_in_bytes": tc.argument_bytes,
           "output_size_in_bytes": out_b,
           "temp_size_in_bytes": tc.peak_bytes - tc.argument_bytes - out_b}
    flops = dict(tc.flops_by_dtype)
    coll = collective_bytes(tc)
    by_axes = dict(tc.collective_by_axes) if mesh.chips > 1 else None
    rec = {
        "per_device_flops": float(sum(flops.values())),
        "flops_by_dtype": flops,
        "per_device_bytes": float(tc.bytes),
        "bytes_model": BYTES_MODEL,
        "collective_bytes_per_device": coll,
        "memory": mem,
        "device_bytes_total": tc.peak_bytes,
        "fits_hbm": tc.peak_bytes < mesh.hbm_bytes,
        "roofline": roofline(flops, tc.bytes, coll["total"], by_axes,
                             mesh.links if by_axes is not None else None),
        "kernel_calls": dict(tc.kernel_calls),
        "compile_seconds": time.time() - t0,
        "status": "ok",
        "chips": mesh.chips,
    }
    if by_axes is not None:
        rec["collective_bytes_by_axes"] = by_axes
        rec["collective_bytes_bf16_partials"] = \
            collective_bytes_bf16_partials(tc)
        rec["links"] = mesh.links
    rec.update(extra)
    return rec


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(e is None or isinstance(e, str)
                                        for e in x)


def _specs_json(tree):
    """A tree of spec tuples as JSON data (each spec a list)."""
    return tree_map(list, tree, is_leaf=_is_spec)


def dryrun_lm(arch: str, shape: InputShape, multi_pod: bool = False,
              cfg=None, layout: Optional[str] = None) -> Dict[str, Any]:
    """One LM record: the train step (AdamW, ``microbatches_for``
    micro-batches), the prefill step (the flash kernel's stand-in in
    every layer) or one decode step over an empty cache of
    ``shape.seq_len``.  ``cfg``: a config to trace in place of the
    arch's (a cut size); ``layout``: a ``launch.mesh`` layout's name
    (else ``multi_pod`` picks)."""
    from repro_torch.models import model as M
    from repro_torch.models import steps as S

    cfg = cfg or get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod, layout=layout)
    m = mesh.mesh
    t0 = time.time()
    extra: Dict[str, Any] = {}
    params, opt_state = S.abstract_state(cfg, m,
                                         with_opt=(shape.kind == "train"))
    batch = S.batch_specs(cfg, shape, m)
    if shape.kind == "train":
        mb = microbatches_for(cfg, shape)
        _, step = S.make_train_step(cfg, microbatches=mb, mesh=m)
        args = (params, opt_state, batch)
        extra["microbatches"] = mb
    elif shape.kind == "prefill":
        step, args = S.make_prefill_step(cfg, m), (params, batch)
    else:
        cache = S.cache_shape_specs(cfg, shape, m)
        step = S.make_serve_step(cfg, m)
        args = (params, cache, batch["token"])
        whole = cache if m is None else S.cache_shape_specs(cfg, shape)
        extra["cache_specs"] = _specs_json(M.cache_specs(cfg, whole))
    whole = params if m is None else S.abstract_state(cfg, with_opt=False)[0]
    pc = active_param_count(cfg, whole)
    extra.update(params_total=pc["total"], params_active=pc["active"],
                 model_flops_global=model_flops(cfg, whole, shape),
                 param_specs=_specs_json(M.param_specs(cfg, whole)))
    del whole
    if m is not None:
        extra["batch_per_device"] = S.local_batch(shape, m)
    rec = _trace(step, args, mesh, t0, extra)
    hlo_global = rec["per_device_flops"] * mesh.chips
    rec["model_vs_hlo_flops"] = (rec["model_flops_global"] / hlo_global
                                 if hlo_global else 0.0)
    return rec


def dryrun_gnn(arch: str, gnn_shape: str, multi_pod: bool = False,
               cfg=None, layout: Optional[str] = None) -> Dict[str, Any]:
    """One GNN record: a full-graph GD step over ``cfg.n_nodes`` nodes or
    a mini-batch SGD step over ``cfg.batch_size`` targets, with
    ``use_agg_kernel`` as the config sets it.  ``cfg``: a config to
    trace in place of the arch's (a cut size); ``layout`` as
    ``dryrun_lm``'s (NODES over the batch axes)."""
    from repro_torch.optim import sgd

    cfg = cfg or get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod, layout=layout)
    m = mesh.mesh
    t0 = time.time()
    params = gnn_steps.gnn_abstract_params(cfg, m)
    opt_state = (sgd(0.1).init(params) if m is None
                 else [sgd(0.1).init(p) for p in params])
    if gnn_shape == "fullgraph_train":
        _, step = gnn_steps.make_fullgraph_step(cfg, m)
        args = (params, opt_state, *gnn_steps.fullgraph_input_specs(cfg, m))
        tokens = cfg.n_nodes
    elif gnn_shape == "minibatch_train":
        _, step = gnn_steps.make_minibatch_step(cfg, m)
        args = (params, opt_state, *gnn_steps.minibatch_input_specs(cfg, m))
        tokens = cfg.batch_size
    else:
        raise ValueError(f"unknown GNN shape {gnn_shape!r}; have "
                         f"{GNN_SHAPES}")
    return _trace(step, args, mesh, t0, {
        "gnn_nodes_per_step": tokens, "use_agg_kernel": cfg.use_agg_kernel})


def combos(archs=None, shapes=None):
    """(arch, shape, skip reason or None) for every ported arch (or
    ``archs``) and its shapes (or ``shapes``)."""
    for arch in archs or list_archs():
        cfg = get_config(arch)
        if cfg.family == "gnn":
            for s in shapes or GNN_SHAPES:
                if s in GNN_SHAPES:
                    yield arch, s, None
            continue
        for s in shapes or list(INPUT_SHAPES):
            if s in INPUT_SHAPES:
                ok, why = shape_applicable(cfg, INPUT_SHAPES[s])
                yield arch, s, (None if ok else why)


def run_one(arch: str, shape_name: str, skip_reason: Optional[str],
            layout: str = "1xH100") -> Dict[str, Any]:
    meta = {"arch": arch, "shape": shape_name,
            "mesh": make_production_mesh(layout=layout).name}
    if skip_reason:
        return {**meta, "status": "skipped", "reason": skip_reason}
    try:
        if get_config(arch).family == "gnn":
            rec = dryrun_gnn(arch, shape_name, layout=layout)
        else:
            rec = dryrun_lm(arch, INPUT_SHAPES[shape_name], layout=layout)
        rec.update(meta)
        return rec
    except Exception as e:
        # deliberately broad: the dry-run matrix records every
        # arch x shape outcome side by side, so any per-cell failure
        # becomes an "error" row instead of aborting the whole report
        return {**meta, "status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append")
    ap.add_argument("--shape", action="append")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16xH100 layout (512 cards)")
    ap.add_argument("--single-pod", action="store_true",
                    help="the one-card layout, 1xH100")
    ap.add_argument("--mesh", action="append",
                    choices=("1xH100", "16x16", "2x16x16"),
                    help="a layout by name (repeatable)")
    ap.add_argument("--all", action="store_true",
                    help="every arch; every layout unless one is named")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    layouts = [layout_name(n) for n in args.mesh or ()]
    if args.single_pod:
        layouts.append("1xH100")
    if args.multi_pod:
        layouts.append("2x16x16xH100")
    if not layouts:
        layouts = list(LAYOUTS) if args.all else ["1xH100"]
    layouts = list(dict.fromkeys(layouts))

    os.makedirs(args.out, exist_ok=True)
    todo = [(c, lay) for lay in layouts
            for c in combos(None if args.all else args.arch, args.shape)]
    print(f"dry-run: {len(todo)} combos -> {args.out}", flush=True)
    for (arch, shape_name, skip), lay in todo:
        tag = f"{arch}__{shape_name}__{lay}"
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path) and not args.force:
            print(f"[skip-existing] {tag}", flush=True)
            continue
        t0 = time.time()
        rec = run_one(arch, shape_name, skip, lay)
        with open(path, "w") as f:
            json.dump(rec, f, indent=2)
        status = rec["status"]
        extra = ""
        if status == "ok":
            r = rec["roofline"]
            extra = (f" dom={r['dominant']} bound={r['bound_s']:.4f}s"
                     f" fits={rec['fits_hbm']}"
                     f" mem={rec['device_bytes_total'] / 2 ** 30:.2f}GiB")
        elif status == "error":
            extra = " " + rec["error"][:120]
        print(f"[{status}] {tag} ({time.time() - t0:.0f}s){extra}",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
