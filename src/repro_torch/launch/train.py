"""Training entry point of the port (reference ``repro.launch.train``).

GNN family: runs the paper's two paradigms (full-graph GD and (b, β)
mini-batch SGD) through one ``Trainer`` on a synthetic preset and prints
the final loss and test accuracy of each as JSON (``train_gnn``).
LM families (every arch but the GNN; the VLM's patches and whisper's
frames are zeros of the reference's shapes): the Markov-chain token
pipeline into the AdamW ``train_step`` (``models/steps.py``, every layer
checkpointed when the config's ``remat`` is set), optional checkpoints,
and the reference's JSON line ``{"arch", "first_loss", "final_loss", "steps"}``
(``train_lm``).

    # on the card (default --device cuda)
    PYTHONPATH=src python -m repro_torch.launch.train --arch gnn-papers100m
    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
        --batch 8 --seq 4096 --microbatches 4 --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --batch 8 --seq 2048 --steps 10
    # on the CPU, reduced configs
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch gnn-papers100m --smoke --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch stablelm-1.6b --smoke --device cpu --steps 5

``--sweep-bs`` / ``--sweep-fanout`` run a (b, β) grid (plus the
full-graph corner) through ``core.experiment.sweep`` and save its rows;
``--journal`` makes that sweep crash-safe.  ``--ckpt-every`` writes
exact-resume checkpoints under ``--ckpt-dir`` (one namespace per
paradigm, ``--keep-last`` retention) and ``--resume`` continues each
paradigm from its newest one (GNN only; the LM saves its parameters
every ``--ckpt-every`` steps, as the reference does).

Under ``torchrun`` (a ``WORLD_SIZE`` in the environment) the GNN
paradigms run NODES-sharded, one process a shard
(``ShardedFullGraphSource`` / ``ShardedSampledSource`` on the
process-group mesh of ``launch.procs``): each rank holds only its rows.
``--device cuda`` gives each rank its own card (nccl), ``--device
cuda:0`` puts every rank on that card (the host-staged gloo transport,
a check of the layout, not of its speed), ``--device cpu`` runs them on
the CPU (gloo).  Only rank 0 prints and writes.

    python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train --arch gnn-papers100m --smoke \
        --device cpu --steps 20

``--model-par M`` (LM) trains tensor-parallel.  In one process it runs
on a ``(1, M)`` mesh (``launch.mesh.make_host_mesh``) whose shards all
sit on the run's device: on the card it repeats the card M times, as the
S = 4 NODES paths do, so the run emulates the layout's arithmetic and
collectives one shard after another (not its speed).  Under
``torchrun`` it runs one process a shard on the ``(world // M, M)``
process-group mesh (``launch.mesh.make_process_mesh``, the reference's
``make_host_mesh`` over its devices): each rank draws only its own
parameter shard from ``--seed``, keeps only its own gradient and AdamW
shards, and trains on its data replica's rows of the global batch, the
collectives running on a subgroup of each mesh axis; ``--device`` picks
the transport as for the GNN.  Only rank 0 prints, and it alone writes
each checkpoint, of the whole tree (all-gathered), while the others
wait at a barrier.  The JSON line keeps its keys.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch stablelm-1.6b --smoke --device cpu --model-par 2 --steps 5
    python -m torch.distributed.run --nproc-per-node 4 \\
        -m repro_torch.launch.train --arch stablelm-1.6b --smoke \\
        --device cpu --model-par 2 --steps 5
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.data.synth import make_preset, token_batches
from repro_torch.device import resolve_device


def train_lm(args, optimizer=None) -> dict:
    """Train an LM arch of any family on synthetic tokens (reference
    ``train_lm``): random weights from ``--seed`` (torch's generator, not
    the reference's draws), ``--steps`` steps of ``--batch`` x ``--seq``
    tokens, ``--microbatches`` micro-batches a step, the default AdamW
    of ``make_train_step`` unless ``optimizer`` is given.  Prints a log
    line every ``--log-every`` steps and the reference's JSON line;
    returns that line's keys plus ``losses`` and, on the card, each
    step's device time ``step_ms`` (CUDA events).  With ``--model-par``
    above 1, or under ``torchrun``, the parameters are split over the
    mesh as they are drawn (``model.init_model(mesh=)``) and saved
    whole; under ``torchrun`` every rank returns the same losses."""
    from repro_torch import sharding as sh
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.launch import procs
    from repro_torch.launch.mesh import make_host_mesh, make_process_mesh
    from repro_torch.launch.serve import stub_inputs
    from repro_torch.models import model as M
    from repro_torch.models import steps as S

    cfg = get_config(args.arch, smoke=args.smoke)
    mesh = None
    ranks = procs.in_torchrun()
    if ranks:
        mesh = make_process_mesh(args.model_par,
                                 procs.init(device=args.device))
        dev = mesh.devices[0]
    else:
        dev = resolve_device(args.device)
        if args.model_par != 1:
            mesh = make_host_mesh(args.model_par,
                                  devices=(dev,) * args.model_par)
    lead = procs.rank_zero()
    params = M.init_model(torch.Generator(device=dev).manual_seed(args.seed),
                          cfg, dev, mesh=mesh)
    opt, train_step = S.make_train_step(cfg, optimizer,
                                        microbatches=args.microbatches,
                                        mesh=mesh)
    opt_state = (opt.init(params) if mesh is None
                 else [opt.init(p) for p in params])
    gen = token_batches(cfg.vocab_size, args.batch, args.seq, seed=args.seed)
    losses, events = [], []
    t0 = time.perf_counter()
    for it in range(args.steps):
        # the global batch on every rank: each takes its replica's rows
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(gen).items()}
        batch.update(stub_inputs(cfg, args.batch, dev))
        if dev.type == "cuda":
            pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            pair[0].record()
        params, opt_state, metrics = train_step(params, opt_state, batch)
        if dev.type == "cuda":
            pair[1].record()
            events.append(pair)
        loss = float(metrics["loss"])
        losses.append(loss)
        if lead and it % args.log_every == 0:
            tok_s = (args.batch * args.seq * (it + 1)
                     / (time.perf_counter() - t0))
            print(f"step {it:5d} loss {loss:8.4f} "
                  f"acc {float(metrics['acc']):.3f} tok/s {tok_s:,.0f}",
                  flush=True)
        if args.ckpt_every and it and it % args.ckpt_every == 0:
            tree = (params if mesh is None
                    else M.unshard_params(params, cfg, mesh))
            if lead:
                save_checkpoint(args.ckpt_dir, it, tree,
                                {"arch": args.arch, "loss": loss},
                                keep_last=args.keep_last or None)
            del tree
            sh.barrier(mesh)
    result = {"arch": args.arch, "first_loss": losses[0],
              "final_loss": losses[-1], "steps": len(losses)}
    if lead:
        print(json.dumps(result), flush=True)
    if events:
        torch.cuda.synchronize(dev)
    if ranks:
        procs.close()
    return dict(result, losses=losses,
                step_ms=[a.elapsed_time(b) for a, b in events] or None)


def train_gnn(args) -> dict:
    from repro_torch.core.engine import (FullGraphSource, SampledSource,
                                         ShardedFullGraphSource,
                                         ShardedSampledSource, Trainer,
                                         TrainPlan)
    from repro_torch.core.experiment import save_rows, sweep
    from repro_torch.launch import procs

    mesh = None
    if procs.in_torchrun():
        from repro_torch import sharding as sh
        mesh = sh.process_node_mesh(procs.init(device=args.device))
        dev = mesh.devices[0]
    else:
        dev = resolve_device(args.device)
    lead = procs.rank_zero()
    cfg = get_config(args.arch, smoke=args.smoke)
    graph = make_preset(args.preset, seed=args.seed)
    cfg_run = dataclasses.replace(cfg, n_classes=graph.n_classes,
                                  feat_dim=graph.feats.shape[1])
    plan = TrainPlan(lr=args.lr, n_iters=args.steps, seed=args.seed,
                     eval_every=args.log_every,
                     ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
                     ckpt_keep_last=args.keep_last)
    if args.sweep_bs or args.sweep_fanout:
        # each --sweep-fanout value is ONE grid point, broadcast to all
        # hops by sweep()
        rows = sweep(graph, cfg_run, plan,
                     batch_sizes=args.sweep_bs or [cfg_run.batch_size],
                     fanout_grid=[int(f) for f in args.sweep_fanout]
                     if args.sweep_fanout else [cfg_run.fanout],
                     include_fullgraph=mesh is None,
                     sources=(("minibatch",) if mesh is None else
                              ("fullgraph_sharded", "minibatch_sharded")),
                     verbose=lead, journal=args.journal, device=dev,
                     mesh=mesh)
        result = {"arch": args.arch, "sweep_rows": len(rows)}
        if lead:
            result.update(save_rows(f"{args.arch}_sweep", rows))
            print(json.dumps(result, indent=2))
        procs.close()
        return result

    # the two paradigms' Trainers share plan.ckpt_dir: namespace their
    # checkpoints (and any --resume) per paradigm so the manifests do not
    # clobber each other
    def _plan_for(tag):
        if not (plan.ckpt_every or args.resume):
            return plan
        return dataclasses.replace(
            plan, ckpt_dir=os.path.join(plan.ckpt_dir, tag))

    pf, pm = _plan_for("fullgraph"), _plan_for("minibatch")
    full, mini = ((FullGraphSource(), SampledSource()) if mesh is None else
                  (ShardedFullGraphSource(mesh=mesh),
                   ShardedSampledSource(mesh=mesh)))
    rf = Trainer(graph, cfg_run, pf, source=full, device=dev).run(
        resume_from=pf.ckpt_dir if args.resume else None)
    rm = Trainer(graph, cfg_run, pm, source=mini, device=dev).run(
        resume_from=pm.ckpt_dir if args.resume else None)
    result = {
        "arch": args.arch, "preset": args.preset, "device": str(dev),
        "full_graph": {"final_loss": rf.history.losses[-1],
                       "test_acc": rf.final_test_acc},
        "mini_batch": {"final_loss": rm.history.losses[-1],
                       "test_acc": rm.final_test_acc},
    }
    if mesh is not None:
        result["ranks"] = mesh.size
    if lead:
        print(json.dumps(result, indent=2))
    procs.close()
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8, help="LM only")
    ap.add_argument("--seq", type=int, default=128, help="LM only")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="LM only: gradient-accumulation micro-batches a "
                         "step")
    ap.add_argument("--model-par", type=int, default=1,
                    help="LM only: tensor-parallel degree; under "
                         "torchrun one process a shard on a (world // M, "
                         "M) mesh, else one process whose model shards "
                         "repeat the run's device (one card emulates the "
                         "layout's arithmetic, not its speed)")
    ap.add_argument("--lr", type=float, default=0.5, help="GNN only")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--preset", default="arxiv-like")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless told otherwise)")
    ap.add_argument("--sweep-bs", type=int, nargs="*", default=None,
                    help="batch sizes for a (b, β) sweep")
    ap.add_argument("--sweep-fanout", type=int, nargs="*", default=None,
                    help="fan-out grid values; each value is one grid "
                         "point, broadcast to every hop")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="exact-resume checkpoint cadence in steps "
                         "(0 = off)")
    ap.add_argument("--ckpt-dir", default="experiments/ckpt")
    ap.add_argument("--keep-last", type=int, default=0,
                    help="checkpoint retention: keep only the newest K "
                         "steps (0 = keep all)")
    ap.add_argument("--resume", action="store_true",
                    help="resume each paradigm from the newest checkpoint "
                         "under its --ckpt-dir namespace (exact resume: "
                         "continues the stopped run bit-for-bit)")
    ap.add_argument("--journal", default=None,
                    help="sweeps: JSONL completion journal for crash-safe "
                         "resume (see core.experiment.sweep)")
    args = ap.parse_args(argv)
    if get_config(args.arch, smoke=args.smoke).family == "gnn":
        train_gnn(args)
    else:
        train_lm(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
