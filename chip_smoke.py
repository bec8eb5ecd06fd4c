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
   0.  Tolerance: 1e-5 (f32) and 2e-2 (bf16), atol = rtol.  Both routes
   of the tiled forward (``ops.tiled_plan``: the slab route,
   ``neighbor_agg_slab.cu``, and the direct route, ``neighbor_agg.cu``)
   on every case, forced through ``ops._tiled_route``: row by row
   against the plain version run in f32 (``row_rel_err`` at most
   ``FWD_ROW_TOL``: 2^-8 in bf16, 1e-5 in f32), the slab route bit-equal
   to the direct route and to a second call; the out-of-range id's row
   NaN in every slab at every slab width.  Both routes timed beside each
   other, back to back and with a 128 MB L2 flush before each launch; a
   sweep of tables from 8 to 256 MiB times both routes (the plan's L2
   budget).
3. Row-kernel phase: ``kernel="row"`` forward and its gradients against
   the plain versions at the same shapes and ragged ones; the forward
   bit-equal to the tiled forward's direct route on the same inputs,
   timed beside it, its plain version, ``embedding_bag`` and the bound.
4. Backward-kernel phase: every cotangent (dfeats, dw, dself, dw_self)
   of the general mode (f32 vector atomics) against the plain backward
   (``neighbor_agg_backward_ref``) at the same shapes, ragged ones, K = 0
   and all-zero weights (dfeats exactly 0), and at the full-graph
   layer-2 shape with only dfeats asked for, as autograd asks there: the
   real ELL of the 524,288-node graph (bf16, D = 172), forced (the path
   takes the reverse-index kernel).  Tolerance: 1e-3 (f32; atomics land
   in no fixed order) and 2e-2 (bf16).  The identity mode
   (``neighbor_agg_backward_identity``) at the levels' widths and ragged
   shapes (odd D, bf16 D = 172's 8-byte rows, K = 0, fused, every
   cotangent): dfeats and dself bit-equal to its plain version
   (``neighbor_agg_backward_identity_ref``), every output bit-equal to
   the general mode on ``arange`` ids, dw and dw_self within 1e-5 / 2e-2
   of the plain version; then at mini-batch layer 2 (f32, B = 8,192,
   K = 15, D = 256, dfeats only) bit-equal to both and to itself, timed
   beside the broadcast ``torch.mul`` (its library call),
   ``embedding_bag``'s backward, the general mode on the same inputs and
   the bound.
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
   tiled forward at the full-graph shape (B = N = 524,288, D = 128 and
   172, bf16, the real ELL): both routes row by row as in phase 2, four
   planted faults (a dropped edge a row, a row's first edge twice, slab
   0 read one column off, the last slab skipped over random values) that
   must each break 2^-8, the routes timed as in phase 2 and the slab
   route at every width (32, 64, 128, 256 B).
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
   forward and the backward kernel's identity mode once a step, and the
   atomic backward and the reverse-index kernel never.
   The tiled forward's route counts must be the plan's: at the full-graph
   widths (slab at D = 128, direct at D = 172) in every full-graph
   forward, evaluations included, and direct at every mini-batch level.
   The mini-batch levels' own shapes (f32, identity ids) are checked and
   timed on both routes as in phase 2.
   Losses must be finite and the last full-graph loss below the first;
   one step's parameter gradients with the kernels on must match the
   plain path (relative max error 2e-2 for bf16 full-graph, 1e-4 for f32
   mini-batch).  One full-graph step (forward, backward and update) is
   timed with CUDA events with the reverse index and without it (the
   atomic backward), in turns on the same parameters, then in turns with
   the tiled forward as planned and forced to each route, and traced with
   ``torch.profiler`` (device time by kernel); one mini-batch step on a
   staged batch (the identity backward) timed and traced likewise.  The
   steady ms/step read from ``History.times`` spans one step fewer than
   it divides by (with the deferred sync each record is stamped when
   the next step has ended; 3/4 of a step over 5 steps): it is printed
   as before, for comparison with earlier runs.
6. Full-width serving phase on the same graph: ``EmbeddingStore``
   build, 256 queries from 4 client threads through ``GNNServer``, two
   incremental ``update_features`` + ``refresh`` rounds, checked against
   the plain forward (2e-2), the snapshot's argmax and a fresh rebuild.
   Its gathers (chunks and refreshed rows, B < N) must all take the
   direct route.
7. GCN phase (fused epilogue on the path): GCN in f32, hidden 256, at
   n = 65,536, checked against the plain forward at 1e-4; both routes at
   its two gathers' shapes checked and timed as in phase 2.
8. Flash-attention phase: the two CUDA kernels against their plain
   version (``flash_attention_ref``).  Every call goes to the kernel
   ``kernel_route`` names, and the per-kernel launch counts must show
   it: bf16 at D = 64, 128 and 256 on the tensor-core kernel
   (``flash_attn_wgmma.cu``), f32 and D = 16 or 32 on the three-term
   TF32 kernel (``flash_attn.cu``, route ``tf32x3``).  Cases:
   gemma3-12b's prefill shape (B = 2, S = 4096, Hq = 16, Hkv = 8, D =
   256; window 0 and 1024; bf16 and f32), D = 64 and 128, the reference
   test's shapes (B 2, Hq 4, Hkv 2, D 32, S 64-256, window 64), ragged S
   (1, 63, 65, 127, 129, 333, 777, 1000), S = 16,384 at B = 1 (the ring
   wrapped 256 times), Hq = Hkv and Hq/Hkv = 16, windows of 1, 100 and
   1000 and one longer than S.
   Tolerance: 2e-5 (f32) and 3e-2 (bf16), atol = rtol.  Every case of
   the tensor-core kernel is also held, row by row, to the plain version
   run in f32 on the same bf16 inputs: ||err|| / ||row|| at most 2^-7,
   two bf16 roundings (``ref.row_rel_err``); at the main shapes, faults
   planted in the output (the second half's rows off by 2 % and 10 %,
   those rows skipping the first 64 keys they keep, the window's edge
   one key out) must each break that limit.  Two calls of each kernel
   at the main shapes must be bit-equal.  The main shapes are timed
   with CUDA events beside the plain version, one
   ``scaled_dot_product_attention`` call (``is_causal``, or a boolean
   band mask for the window) and the bound (f32: at the 3xTF32 rate,
   and at the f32-FMA rate beside it); in bf16 the tf32x3 kernel is
   timed on the same inputs as well.
9. LM serving phase at full width: gemma3-12b (48 layers, d_model 3840,
   16/8 heads of 256, d_ff 15360, vocab 262,144, 5 local : 1 global),
   bf16 weights drawn on the card from a seeded generator, through the
   port's ``models.steps``: prefill of 2 x 4096 tokens, then 32 greedy
   decode steps.  The flash kernels' launch counts are reset just
   before and read just after: one launch of the tensor-core kernel per
   layer of the prefill (48) and none of the tf32x3 kernel.  The
   prefill's last logits with the kernel must match the plain path
   (the reference model's chunked attention) to a relative max error of
   5e-2 in bf16 and, with the same model drawn in f32 (whose prefill,
   counted the same way, must launch the tf32x3 kernel 48 times and the
   tensor-core kernel never), 1e-3; every logit
   finite and every token within the vocab; 8 teacher-forced decode
   steps must match the forward over the extended sequence to a relative
   max error of 5e-2.  One prefill and one decode step are traced with
   ``torch.profiler`` (device time by kernel).

10. Figures phase: the paper's figures through the port's experiment
   layer, the CUDA aggregation kernels on (``--kernel`` /
   ``Env(kernel=True)``).  (a) The experiment CLI
   (``repro_torch.core.experiment.main``) with the reference's default
   grid plus the full-graph corner, 1 and 2 layers: every row ok with
   finite losses, its JSON and CSV written, the tiled forward launched.
   (b) ``sweep`` at full width on the shared graph (gnn-papers100m,
   bf16 aggregation): the full-graph corner (K = d_max, as the
   reference's sweep builds it) and b in {1024, 8192} x fan-out in
   {(5, 5), (15, 10)}, 10 steps each, evaluation every 5,
   ``inference=True``; each point's launches counted alone: the
   full-graph point the reverse-index backward and no atomic one, the
   mini-batch points the backward kernel's identity mode and no atomic
   backward, every point the tiled forward;
   losses finite.  (c) The nine figure benches in quick mode (for the
   run's time fig2 cut to 50 iterations and one seed, from 250 and two,
   fig3 to 75 iterations from 150, table1 to 60 from 120:
   ``QUICK_CUTS``) through
   ``repro_torch.bench.run``: each figure's seconds, Trainer runs,
   steps per second, rows and launches; the reference's row count,
   finite losses where the reference reports numbers, the tiled forward
   launched by every figure that trains, every prefetch thread ended
   and device memory back within 64 MiB of where it was after each
   figure; the peak after (c).  (d) fig6 and fig1 again with the switch
   off: run by run, first and last loss within 1e-3 relative and test
   accuracy within one node of its split.  Then the kernels at the
   figures' shapes (f32: the forward on table1's papers-like ELL, K =
   d_max, D = 64, and on fig6's mini-batch level b = 128, K = 10,
   D = 64; the reverse-index backward on that ELL at D = 24; the
   identity backward at the mini-batch level, bit-equal to its plain
   version, the broadcast ``torch.mul`` and the general mode timed beside
   it) against their plain versions, timed beside them, the bound and
   ``embedding_bag``: the kernels line's ``figure_shapes``.  Last, a
   ``torch.profiler`` trace of 100 warm steps of a fig2 grid point (b =
   128, β = 10) and of fig1's full-graph run gives the device's busy
   share.  Each phase's seconds and each figure's seconds and steps per
   second are printed before the result lines.
11. Sources and fault-tolerance phase on the shared graph at
   gnn-papers100m's widths (bf16 full-graph aggregation, kernels on).
   (a) ``ClusterSource`` at b = 8192 (two clusters a batch, 128 BFS
   parts): the partition's and the blocks' host seconds, the batch ELL's
   m_max and K and the tiled routes the plan gives there; 20 steps
   between a launch-count reset and its read: the reverse-index backward
   once a step (each batch's index built on the card), the atomic
   backward never, the tiled forward on the planned routes (steps and
   the two evaluations); ms/step, the index build's ms a batch, finite
   losses, a second run from the seed bit-equal, one step's gradients
   with the kernels within 2e-2 relative of the plain path, and the
   kernels at the batch's shapes (forward D = 128 and 172, the
   reverse-index backward at D = 172) against their plain versions row
   by row, timed beside the bound and ``embedding_bag``.
   (b) ``ImportanceSampledSource`` (degree scores) at b = 8192, fan-out
   (15, 10), 20 steps: the identity backward once a step, no atomic or
   reverse-index one, sampling and staging split, a 5-step second run
   bit-equal to the first run's prefix, gradients within 1e-4, the
   ``grad`` bind's seconds (one full-graph forward through the kernel)
   and, on one batch, the weighted batch mean against Σ w_j ℓ_j / b by
   hand in float64 (1e-5).  (c) Full-graph and cluster runs of 6 steps
   with ``ckpt_every=2``, killed by an armed ``SimulatedCrash`` in the
   step-4 save and resumed from the directory: History, parameters and
   test accuracy bit-equal to the run that was not stopped; a mini-batch
   run with a NaN batch (``faults.poison_batches``) under
   ``on_bad="rollback"`` ends with one rollback and finite losses but
   the poisoned step's.  (d) A 3-point ``sweep`` (full-graph corner,
   cluster, importance) with a journal, killed after point 1, rerun:
   point 1 skipped, rows equal to an uninterrupted sweep's but for the
   wall-clock columns.  Checkpoints and the journal live in a temporary
   directory under ``experiments/bench_torch/chip_smoke_ckpt``.
12. The NODES-sharded paradigms on the shared graph at gnn-papers100m's
   widths (bf16 full-graph aggregation, K = 32; b = 8192, fan-out
   (15, 10)), on single-controller meshes whose shards all sit on the
   one card (``node_mesh(devices=(card,) * S)``: the shards run one
   after another, so no time here is a multi-card time).  (a) S = 1:
   ``ShardedFullGraphSource`` (5 steps; replicated table and the
   featshard layout) and ``ShardedSampledSource`` (10 steps) from the
   unsharded sources' initial parameters: History, parameters and test
   accuracy bit-equal to ``FullGraphSource`` / ``SampledSource``, the
   launches by kernel and route equal (featshard: by kernel; its
   concat(hot, local) table may take another bit-equal route).  (b)
   S = 4: fullgraph_sharded and the featshard layout (C auto = n // 8)
   run 5 steps with finite, falling losses, launch S times each kernel
   per call (featshard: S phase-1 and S phase-2 launches, the miss path
   on the card, each phase's sum in f32 from the bf16 tables), repeat bit
   for bit from the
   seed, and one step's
   parameter gradients lie within 2e-2 relative of the unsharded kernel
   path; the plan's accounting equals the host arithmetic ((n/S + C)·d·2
   table bytes a shard, (S - 1)·(M + C_max) rows a call);
   minibatch_sharded runs 10 steps with gradients within 1e-4 (f32
   levels); the kernels at one shard's shapes (the full-graph shard's
   forward at D = 128 / 172 and reverse-index backward at D = 172,
   featshard's phase 1 and fused phase 2, the mini-batch levels at b/S)
   against their plain versions, timed beside the bound and
   ``embedding_bag``.  (c) ``EmbeddingStore`` with the featshard layout
   on S = 4 shards against the replicated build (2e-2), then 64
   queries; beside it the readings that limit sits between (the build
   with its phase-1 partial rounded to bf16, the reference's arithmetic,
   and to 4 significant bits, a control the limit must refuse; each
   build against an f32 witness).  Each ms/step line names the card and
   its power limit.
13. LM training and the dry-run against the card.  (a) stablelm-1.6b at
   full width and depth (bf16 compute, f32 master weights and AdamW
   state, every layer checkpointed) through ``launch/train.py``'s
   ``train_lm``: batch 8 at sequence 4096 (train_4k's sequence, its
   global batch of 256 cut to 8 for one card), ``microbatches_for``'s 4
   micro-batches, 10 steps of ``adamw(3e-3)`` on ``token_batches``:
   losses finite, the mean of the last 3 below the first, no kernel
   launched (training attends through the chunked path); ms/step by
   CUDA events, tokens/s, ``max_memory_allocated``; then one step with
   1 and with 2 micro-batches on one batch (the default optimizer):
   loss within 1e-4 relative, parameters within 5e-3.  (b) ``python -m
   repro_torch.launch.dryrun`` for gnn-papers100m's two GNN shapes at
   its full n, stablelm-1.6b train_4k and gemma3-12b prefill_32k and
   decode_32k: every record ``ok``; the full-graph record beside the
   plain path's.  (c) the dry-run at the sizes the card runs against
   one measured step (the peak with the arguments resident): the
   full-graph step at the shared graph's n with the reverse index, the
   mini-batch step at b = 8192, fan-out (15, 10), and (a)'s step, each
   ``device_bytes_total`` within [0.8, 1.25] of the measured peak, its
   time beside ``bound_s``, the traced kernel calls equal to the
   launches; the steps on meta copies of their arguments (the kernels'
   shape-only stand-ins) give outputs of the real steps' shapes and
   dtypes, and so does every kernel entry.  (d) the reading of
   ``tests/test_torch_cuda.py::test_prefill_launches_wgmma_kernel_once_per_layer``
   with seeded tokens: three times with seed 0, then for 16 seeds.
14. The MoE, SSM, hybrid, audio and VLM families, each through
   ``serve_case`` (phase 9's checks: the flash launches of a prefill
   counted from the layer plan, one per causal self-attention on the
   routed kernel and none on the other, the calls' windows and head dims
   as the plan says, the last logits against the plain path, a
   teacher-forced decode against the forward, profiler tables), random
   weights in bf16 from seeded generators: (a) zamba2-7b at full width
   and depth (81 layers: 70 mamba, 11 applications of one shared
   attention block at head dim 112), batch 2, prompt 4096, 32 greedy
   decode steps: 11 launches of the tensor-core kernel a prefill; the
   model drawn again in f32, 11 of the tf32x3 kernel, held at 1e-3; the
   prefill's peak device bytes.  (b) llama4-scout-17b-a16e at full width,
   depth cut to one iRoPE period (3 local layers at window 8192, 1
   global NoPE layer; 16 experts), batch 1, prompt 16384: 4 launches
   (3 at window 8192, 1 at 0); the drop share by layer; the f32 twin.
   (c) mamba2-130m at full width and depth, batch 2, prompt 4096: no
   launch; then ``train_lm`` for 10 ``adamw(3e-3)`` steps at batch 8,
   sequence 2048 (losses finite and falling; ms/step, tokens/s, peak).
   (d) whisper-medium (24 encoder and 24 decoder layers; frames [2,
   1500, 1024]), decoder prompt 448: 24 launches at head dim 64.  (e)
   internvl2-76b at full width, depth cut to 8, batch 2, 1024 patch
   embeddings and 3072 tokens: 8 launches at head dim 128.  (f) the
   dry-run CLI for the six archs at every input shape (records ``ok``
   or skipped where ``shape_applicable`` says, each stating
   ``fits_hbm``); (a)'s prefill traced at the card's shapes, its
   ``device_bytes_total`` within [0.8, 1.25] of the measured peak and
   its traced flash calls equal to the launches.  Then the flash
   kernel at each new prefill shape (time, bound, plain version,
   ``scaled_dot_product_attention``), with a row check at head dim 112
   in f32 and planted faults that must break it.
15. The static audits (``repro_torch.analysis``): (a) every CUDA kernel
   case's shared memory and threads by formula against the H100's
   limits, the formulas' launch constants against the ``.cu`` sources,
   then every kernel symbol of both built libraries as ``cuobjdump
   -res-usage`` reads it (registers x threads within the register file,
   the measured static shared memory equal to the formula's, spills:
   none allowed in a flash kernel) and the dynamic shared memory each
   flash launch asks for (the
   library's ``kSmem`` query at every head dim) equal to the formula's,
   each symbol joined to its formula row, printed as ``15a resources``
   lines; the index tables of the audit graph; the thread audit of the
   thread-crossing modules; the five fixtures, each of which must make
   the gate fire (the ``constant`` one uploads a host table inside a
   step on the card; the ``pipeline`` one runs three planted pipeline
   faults, each flagged by name, the short copy as a timeout).  (b) the dispatch-trace audit of the whole variant
   cube (every paradigm, plain and kernel, featshard, gcn), the shared
   eval and the inference chunk on the card at n = 192: no float64, no
   cast round trip, no host table fed to the card inside a step, no
   process-group collective, two fresh binds with one op sequence and
   one set of kernel launches, and kernel launches exactly on the
   kernel variants; each record counts the host syncs by op and as the
   sync debug mode reports them.  (c) the same trace audit of one step of each
   paradigm's kernel variant at gnn-papers100m's widths on the shared
   graph.  (d) the pipeline check: the checked build of both flash
   kernels (``-DREPRO_PIPELINE_CHECK``, compiled here and timed) at
   every case of ``kernel_audit.pipeline_cases`` (the ``wgmma`` ring at
   D = 64, 112, 256 and the ``tf32x3`` cp.async groups at D = 16, 32,
   64, 256 in f32 and once on bf16, each at S = 64, 128, 320, 200 and
   window 0, 96), every block's event log held to the pairing rules,
   every output bit-equal to the normal build's; one ``15d pipeline``
   line a kernel (cases, blocks, events, findings, seconds, checked and
   normal kernel ms) and whether ``tests/data/pipeline_logs.npz`` comes
   from the current sources.  Any gating finding left after
   ``allowlist.toml`` fails the run.  (``compute-sanitizer``'s memcheck
   is not here: the sanitizer refuses this machine's H100.)
16. The fault-tolerance surface under concurrency, gnn-papers100m at full
   width on the shared graph.  (a) An ``EmbeddingStore`` behind a
   ``GNNServer`` with ``max_staleness_s``, ``refresh_every_updates`` and
   ``refresh_budget_ms`` set (the store's background scheduler on): one
   writer streams 64 updates (feature rows of 256 nodes; every fourth
   ``add_edges`` of 64 edges) while 4 clients send 1,024-node queries
   with deadlines for 20 s.  No error but overload and deadline errors;
   every answer equals the argmax of the ``final_np`` of the version it
   names (each published version's table is kept); staleness within the
   bound plus the reference test's 0.2 s slack; once the WAL has drained,
   every layer table within 2^-8 ``row_rel_err`` of a fresh plain-path
   build on the final graph; the tiled forward launched, no backward
   kernel; the scheduler's, batcher's and chunk stream's threads ended.
   It prints p50, p99, qps, the refreshes, the mean incremental refresh
   time, the largest staleness and the shed and overload counts.  (b)
   Crashes armed at ``store.mid_layer_refresh`` and ``store.before_swap``
   inside the scheduler thread, and a fatal refresh fault whose degrade
   build dies after its first layer (``infer.after_layer``, the chunk
   stream's worker live): the old snapshot serves bit-equal at its
   version, no thread is left; then ``refresh_with_recovery`` under a
   fatal fault degrades to one full build, bit-equal to a second
   ``build()``; device memory back within 64 MiB of where 16a started.
   (c) ``repro_torch.ci.sweep_resume_smoke --kernel``.  (d) The four
   examples (``repro_torch.examples``) in-process at the reference's
   default sizes, each with exit code 0 and its output parsed: the GNN
   examples with ``--kernel`` launch the tiled forward, ``serve_batched``
   a flash kernel in its prefill, ``lm_pretrain_smoke`` no kernel.  The
   ``{"kernels": [...]}`` line gives each kernel's ``launches_phase16``
   by path.
17. Tensor parallelism on a ``model = 2`` mesh whose two shards both sit
   on the card (``launch.mesh.make_host_mesh(2, devices=(card,) * 2)``:
   the layout's arithmetic and collectives, one shard after another).
   (a) stablelm-1.6b at full width and depth in bf16, one prefill of
   2 x 4096 tokens: the weights split by ``param_specs`` (16 of the 32
   heads a shard, half of ``d_ff`` and of the vocab), the ``wgmma`` flash
   kernel launched once a shard a layer (48) and nothing else, each
   shard's KV cache holding its 16 heads; the last logits within 2e-2
   (relative, over the vocab) of the same weights' ``model = 1`` prefill;
   both also read against the same weights run in f32 (bf16's own
   rounding, printed).
   (b) three train steps of stablelm-1.6b (f32 master weights, bf16
   compute, ``make_train_step``'s AdamW) at 2 x 2048 tokens, each loss
   within 2e-2 of the ``model = 1`` run's from the same weights and
   batches.  (c) llama4-scout at 14b's depth (4 layers), one prefill of
   4096 tokens with 8 of the 16 experts a shard and the combine
   reduce-scattered, its MoE routing replayed from the ``model = 1`` run
   (``observed``), the last logits within 2e-2.  Each part prints its
   wall time, the collective bytes the mesh counted
   (``sharding.collective_counts``) and the flash launches; the kernels
   line gives each kernel's ``launches_phase17`` by path.
18. The NODES-sharded paths one process a rank (``launch.procs``,
   ``sharding.process_node_mesh``): the shared graph's arrays written
   once to a temporary directory and memory-mapped by each rank, which
   uploads only its ``n_pad / S`` rows.  (a) World size 1 over NCCL
   (each collective called once): ``fullgraph_sharded`` (5 steps) and
   ``minibatch_sharded`` (b = 8192, fan-out (15, 10), 10 steps) bit-equal
   to phase 12a's one-shard runs (losses, evaluations, test accuracy,
   parameters) with equal launches.  (b) Four processes on the card over
   the host-staged transport, ``fullgraph_sharded`` with the kernels, 5
   steps: every rank the same losses and parameters, within 2e-2 of phase
   12b's single-process S = 4 run; each rank's tiled-forward and
   reverse-index-backward launches those of the unsharded run (one a
   call, on its own block); each rank holding a quarter of the padded ELL,
   features and labels; each rank's peak bytes beside 12b's and its
   ms/step (time-sliced on one card, not a four-card time).  (c) Two
   processes, ``minibatch_sharded`` (1e-4) and the featshard layout
   (2e-2) against 12b, three steps each.  A rank's failure fails the
   phase.  The kernels line gives each kernel's ``launches_phase18`` by
   path, summed over the ranks.
19. The LM's tensor parallelism one process a shard
   (``launch.mesh.make_process_mesh``: the ``(world // 2, 2)`` mesh over
   the ranks, a ``torch.distributed`` subgroup for each group of each
   axis set), the ranks sharing the card over the host-staged transport.
   Phase 17 runs before phase 18, and these cases run in phase 18's
   spawns after its GNN cases (18c's two ranks: 19a and 19c; 18b's four:
   19b), so they pay no start-up of their own; each rank draws only its
   own shard of phase 17's weights from the seed (``init_model(mesh=)``).
   (a) stablelm-1.6b at full width and depth, bf16, ``(1, 2)`` over 2
   ranks: one prefill of 17a's 2 x 4096 prompt, then two decode steps.
   Each rank launches the ``wgmma`` kernel once a layer (24) and nothing
   else and caches its 16 heads; the last logits are bit-equal to 17a's
   one-process ``model = 2`` prefill and within 2e-2 of its ``model =
   1``; each rank's collective tally equals 17a's (the batch axes have
   size 1, so no logits gather is added); the decode logits are within
   5e-2 of 17a's ``model = 1`` decode of the same tokens.  (b) three
   train steps of stablelm-1.6b (17b's f32 weights and batches, one row
   a data replica) on ``(2, 2)`` over 4 ranks: every rank the same
   losses and replicated leaves, the losses within 2e-2 of 17b's ``model
   = 1`` and 1e-4 relative of its ``model = 2``, each rank holding a
   quarter of the leaves split over both axes; each rank's peak bytes
   and wall ms a step (time-sliced, host-staged: not a four-card time).
   (c) llama4-scout at 4 layers, one prefill of 4096 tokens on ``(1,
   2)``, its MoE routing replayed from 17c's ``model = 1`` run: within
   2e-2 of it, 4 flash launches a rank.  A rank's failure fails the
   phase; the kernels line gives ``launches_phase19`` by path, summed
   over the ranks.

Every failed check raises.  The last stdout line is
``{"ok": true, "device": {...}}``; the line before it names the card and
its power limit, and a ``{"kernels": [...]}`` line precedes that.  In
it ``neighbor_agg_tiled`` keeps its top-level numbers on the serving
chunk at D = 172 (bf16, unfused), with both routes by shape under
``by_shape``; the slab kernel (``neighbor_agg_slab.cu``) has an entry of
its own, ``neighbor_agg_tiled_slab``, at the full-graph shape of layer 1.
``neighbor_agg_backward`` (the general mode) keeps its top-level numbers
on the full-graph layer-2 shape; the identity mode, last, has its own
entry, ``neighbor_agg_backward_identity``, at mini-batch layer 2, with
the broadcast ``torch.mul`` as its library call.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import gc
import importlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map_only

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch import sharding as SH  # noqa: E402
from repro_torch.analysis import findings as AF  # noqa: E402
from repro_torch.analysis import fixtures as AFX  # noqa: E402
from repro_torch.analysis import kernel_audit as KA  # noqa: E402
from repro_torch.analysis import thread_audit as TA  # noqa: E402
from repro_torch.analysis import trace_audit as TR  # noqa: E402
from repro_torch.bench import run as brun  # noqa: E402
from repro_torch.bench.common import Env  # noqa: E402
from repro_torch.checkpoint import latest_step  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import engine as E  # noqa: E402
from repro_torch.core import experiment as X  # noqa: E402
from repro_torch.core import faults  # noqa: E402
from repro_torch.core import gnn as G  # noqa: E402
from repro_torch.core.embedding_store import EmbeddingStore  # noqa: E402
from repro_torch.core.graph import Graph, to_ell  # noqa: E402
from repro_torch.core.serving import (  # noqa: E402
    DeadlineExceededError, GNNServer, ServerOverloadedError)
from repro_torch.data.synth import make_preset, token_batches  # noqa: E402
from repro_torch.device import TRACE_DEVICE  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    make_host_mesh, make_process_mesh)
from repro_torch.kernels.build import build_all  # noqa: E402
from repro_torch.kernels.flash_attn import build as fa_build  # noqa: E402
from repro_torch.kernels.flash_attn import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attn.ref import (  # noqa: E402
    BF16_ROW_TOL, row_rel_err)
from repro_torch.kernels.neighbor_agg import build as na_build  # noqa: E402
from repro_torch.kernels.neighbor_agg import featshard as FS  # noqa: E402
from repro_torch.kernels.neighbor_agg import ops  # noqa: E402
from repro_torch.launch import procs  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import steps  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    INPUT_SHAPES, InputShape, shape_applicable)
from repro_torch.data.synth import token_batches  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import gnn_steps  # noqa: E402
from repro_torch.launch import roofline as R  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.kernels.neighbor_agg.ref import (  # noqa: E402
    CSR_BF16_ROW_TOL, FWD_ROW_TOL, neighbor_agg_backward_csr_ref,
    neighbor_agg_backward_identity_ref, neighbor_agg_backward_ref,
    neighbor_agg_ref)
# the card's peak rates and the kernels' byte and operation model: the
# kernel table's bounds and the dry-run's kernel bytes come from one place
from repro_torch.kernels.cost import (  # noqa: E402,F401
    BF16_FLOPS_PER_S, F32_FLOPS_PER_S, HBM_BYTES_PER_S, bound, bound_bwd,
    bound_bwd_csr, bound_bwd_identity, flash_bound)

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
# zeroed between timed launches to take the 50 MB L2 cold
L2_FLUSH_BYTES = 128 * 2 ** 20
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
    # tables of the direct-vs-slab sweep (B = N rows, K = agg_k)
    sweep_n: tuple = (32_768, 65_536, 131_072, 262_144)
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
    # figures: the benches' QUICK sizes unless fig_n / fig_iters are set
    fig_n: int = 0
    fig_iters: int = 0
    # the full-width sweep on the shared graph (gnn-papers100m)
    fw_bs: tuple = (1024, 8192)
    fw_fanouts: tuple = ((5, 5), (15, 10))
    fw_steps: int = 10
    fw_eval: int = 5
    # phase 11 (b and fan-out are mb_b and mb_fanout)
    cl_steps: int = 20             # cluster run
    im_steps: int = 20             # importance run
    repeat_steps: int = 5          # importance's second run from the seed
    ft_steps: int = 6              # the fault-tolerance runs
    jr_steps: int = 3              # each point of the journal sweep
    # phase 12 (b and fan-out are mb_b and mb_fanout)
    sh_shards: int = 4             # NODES shards of 12b-c, all on one card
    sh_fg_steps: int = 5           # full-graph runs
    sh_mb_steps: int = 5           # mini-batch runs
    sh_queries: int = 64           # queries to the featshard store
    # phase 13: LM training (stablelm-1.6b, train_4k's sequence, its
    # global batch 256 cut to 8 for one card)
    lt_arch: str = "stablelm-1.6b"
    lt_smoke: bool = False
    lt_b: int = 8
    lt_s: int = 4096
    lt_steps: int = 5
    # phase 14: the MoE, SSM, hybrid, audio and VLM families (full
    # configs at the depths below; smoke configs when fam_smoke)
    fam_smoke: bool = False
    fam_gen: int = 32
    fam_tf: int = 8
    zb_b: int = 2                  # zamba2-7b (14a) and mamba2-130m (14c)
    zb_s: int = 4096
    l4_layers: int = 4             # llama4-scout (14b): one iRoPE period
    l4_s: int = 16384              # two windows of 8192
    wh_s: int = 448                # whisper-medium's decoder prompt (14d)
    vl_layers: int = 8             # internvl2-76b (14e)
    vl_text: int = 3072            # after its 1024 patch embeddings
    m2_b: int = 8                  # mamba2-130m training (14c)
    m2_s: int = 2048
    m2_steps: int = 10
    fam_shapes: tuple = ()         # 14f's input shapes (): all of them
    # phase 16: serving under chaos (gnn-papers100m on the shared graph)
    ch_secs: float = 20.0          # the clients query this long
    ch_updates: int = 64           # the writer's updates over that time
    ch_rows: int = 256             # feature rows an update
    ch_edges: int = 64             # new edges an add_edges update
    ch_query: int = 1024           # nodes a query
    ch_clients: int = 4
    ch_deadline_s: float = 1.0     # each query's deadline
    ch_stale_s: float = 5.0        # the server's max_staleness_s
    ex_tiny: bool = False          # the examples at tiny sizes (CPU)
    # phase 17: tensor parallelism, model = 2 on the one card (and phase
    # 19, one process a shard, at the same sizes)
    tp_smoke: bool = False         # smoke configs (16 heads) on the CPU
    tp_b: int = 2
    tp_s: int = 4096               # 17a's prompt
    tp_train_s: int = 2048         # 17b's sequence
    tp_steps: int = 3
    tp_l4_s: int = 4096            # 17c's prompt (llama4-scout, 4 layers)


FULL = Sizes()
TINY = Sizes(agg_n=600, agg_b=300, sweep_n=(64, 128), n_serve=3_000,
             chunk=700,
             n_gcn=1_000, queries=24, updates=8, iters=2, path_iters=1,
             full_steps=3, mb_steps=4, mb_b=64, fa_shape=(1, 192, 4, 2, 64),
             fa_windows=(0, 64), fa_iters=2, fa_long=(1, 640, 2, 1, 64),
             lm_smoke=True, lm_s=128,
             lm_gen=4, lm_tf=3, fig_n=160, fig_iters=4, fw_bs=(16, 64),
             fw_steps=4, fw_eval=2, cl_steps=4, im_steps=4, repeat_steps=2,
             sh_fg_steps=3, sh_mb_steps=3, sh_queries=8, lt_smoke=True,
             lt_b=4, lt_s=128, lt_steps=4, fam_smoke=True, fam_gen=4,
             fam_tf=3, zb_s=256, l4_s=128, wh_s=64, vl_text=112, m2_b=2,
             m2_s=256, m2_steps=8, fam_shapes=("decode_32k", "long_500k"),
             ch_secs=2.0, ch_updates=8, ch_rows=8, ch_edges=4, ch_query=32,
             ch_stale_s=2.0, ex_tiny=True, tp_smoke=True, tp_s=128,
             tp_train_s=128, tp_l4_s=128)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, dev: torch.device, iters: int, warmup: int = 3,
            flush=None) -> float:
    """Mean time of one ``fn()`` over ``iters`` back-to-back runs: CUDA
    events on the card, the host clock on the CPU (rehearsal only).  With
    ``flush`` (a tensor larger than L2), the tensor is zeroed before each
    run and an event pair times each run alone."""
    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(dev)
    if flush is not None:
        pairs = []
        for _ in range(iters):
            flush.zero_()
            pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            pair[0].record()
            fn()
            pair[1].record()
            pairs.append(pair)
        torch.cuda.synchronize(dev)
        return sum(a.elapsed_time(b) for a, b in pairs) / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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


_FLUSH = {}


def flush_buffer(dev):
    """A tensor larger than L2, zeroed between timed launches (a small
    one on the CPU, where nothing is cached that matters)."""
    if dev not in _FLUSH:
        n = L2_FLUSH_BYTES // 4 if dev.type == "cuda" else 1024
        _FLUSH[dev] = torch.empty(n, dtype=torch.float32, device=dev)
    return _FLUSH[dev]


def tiled(case, route=None, slab_bytes=None):
    """The tiled forward through its wrapper: on the route ``tiled_plan``
    gives, or forced to ``route`` (at ``slab_bytes``) for the
    side-by-side checks and times."""
    if route is None:
        return ops.neighbor_agg(*case, use_kernel=True)
    with ops._tiled_route(route, slab_bytes):
        return ops.neighbor_agg(*case, use_kernel=True)


def as_f32(case):
    return [x if x is None or x.dtype == torch.int32 else x.float()
            for x in case]


def plan_of(case):
    feats, idx = case[0], case[1]
    return ops.tiled_plan(feats.shape[0], idx.shape[0], idx.shape[1],
                          feats.shape[1], feats.dtype)


def check_routes(name, case, ref32=None) -> dict:
    """Both routes of the tiled forward on ``case``, row by row against
    the plain version run in f32 (``FWD_ROW_TOL``); the slab route
    bit-equal to the direct route and to a second call of itself.
    Returns each route's row error."""
    dtype = case[0].dtype
    want = neighbor_agg_ref(*as_f32(case)) if ref32 is None else ref32
    got = {r: tiled(case, r) for r in ops.TILED_ROUTES}
    errs = {r: row_rel_err(out, want) for r, out in got.items()}
    for r, err in errs.items():
        check(err <= FWD_ROW_TOL[dtype], f"{name}: {r} route row error "
              f"{err} beyond {FWD_ROW_TOL[dtype]}")
    check(torch.equal(got["slab"], got["direct"]),
          f"{name}: the slab and direct routes differ")
    check(torch.equal(got["slab"], tiled(case, "slab")),
          f"{name}: two calls of the slab route differ")
    return errs


def time_routes(case, dev, iters, warmup=3, widths=False) -> dict:
    """Both routes on the same inputs, back to back and with L2 flushed
    before each launch; beside them the route and slab layout the plan
    gives.  With ``widths``, the slab route at every slab width too (back
    to back)."""
    plan = plan_of(case)
    flush = flush_buffer(dev)
    out = {"planned": plan.route, "slab_bytes": ops.SLAB_BYTES,
           "slab_passes": len(plan.bounds)}
    for r in ops.TILED_ROUTES:
        out[r] = {"ms": time_ms(lambda: tiled(case, r), dev, iters, warmup),
                  "ms_l2_flushed": time_ms(lambda: tiled(case, r), dev,
                                           iters, 1, flush)}
    if widths:
        out["slab_width_ms"] = {
            str(sb): time_ms(lambda: tiled(case, "slab", sb), dev, iters, 1)
            for sb in ops.SLAB_WIDTHS}
    return out


def routes_line(t: dict, errs: dict) -> str:
    return (f"planned {t['planned']}; slab {t['slab']['ms']:.4f} ms "
            f"({t['slab']['ms_l2_flushed']:.4f} L2 flushed, row error "
            f"{errs['slab']:.4g}), direct {t['direct']['ms']:.4f} ms "
            f"({t['direct']['ms_l2_flushed']:.4f} L2 flushed, row error "
            f"{errs['direct']:.4g}), bit-equal"
            + (f"; slab by width (B): "
               f"{ {k: round(v, 4) for k, v in t['slab_width_ms'].items()} }"
               if "slab_width_ms" in t else ""))


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
                rows = check_routes(name, case)
                routes = time_routes(case, dev, sz.iters)
                measured[(dtype, d, fused)] = dict(
                    max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib_ms,
                    row_rel_err=rows[routes["planned"]],
                    row_rel_err_by_route=rows,
                    row_check_limit=FWD_ROW_TOL[dtype], routes=routes)
                print(f"kernel {name}: routes: {routes_line(routes, rows)}",
                      flush=True)
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
                rows = check_routes(name, case)
                print(f"kernel {name}: max_err={err:.3g}; row error slab "
                      f"{rows['slab']:.4g} direct {rows['direct']:.4g} "
                      f"(limit {FWD_ROW_TOL[dtype]}), bit-equal", flush=True)
        # all-zero weights: exactly 0, not merely close
        feats, idx, w, _, _ = make_case(gen, dev, 64, 100, sz.agg_k, 172,
                                        dtype, False, zero=True)
        for route in (None,) + ops.TILED_ROUTES:
            out = tiled((feats, idx, w), route)
            check(bool((out == 0).all()),
                  f"zero weights {dtype} ({route or 'planned'}): not all 0")
        print(f"kernel zero-weights {str(dtype)[6:]}: exactly 0 (both "
              f"routes)", flush=True)
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
            # D = 40 spans 2 (bf16) or 3 (f32) slabs of 32 B and more of
            # narrower ones: the row is NaN in every slab
            for sb in ops.SLAB_WIDTHS:
                slab = tiled((feats, idx, w), "slab", sb)
                check(bool(torch.isnan(slab[3]).all())
                      and torch.equal(slab[keep], out[keep]),
                      f"slab route at {sb} B: out-of-range id did not "
                      f"poison its whole row, or other rows moved")
    measured["sweep"] = table_sweep(dev, sz, gen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return measured


def table_sweep(dev, sz: Sizes, gen) -> list:
    """Both routes at tables around L2's size (B = N rows, K = agg_k,
    random ids): where the direct route keeps up, the plan's
    ``L2_TABLE_BYTES``."""
    rows = []
    for dtype, d in ((torch.bfloat16, 128), (torch.float32, 128),
                     (torch.float32, 256)):
        for n in sz.sweep_n:
            case = make_case(gen, dev, n, n, sz.agg_k, d, dtype, False)
            t = {r: time_ms(lambda: tiled(case, r), dev, sz.iters)
                 for r in ops.TILED_ROUTES}
            table = n * d * case[0].element_size()
            rows.append(dict(dtype=str(dtype)[6:], n=n, d=d,
                             table_bytes=table, planned=plan_of(case).route,
                             slab_ms=t["slab"], direct_ms=t["direct"]))
            print(f"kernel sweep {str(dtype)[6:]} B=N={n} K={sz.agg_k} D={d}"
                  f" (table {table / 2 ** 20:.0f} MiB): slab "
                  f"{t['slab']:.4f} ms, direct {t['direct']:.4f} ms, "
                  f"planned {rows[-1]['planned']}", flush=True)
            del case
    return rows


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
    backward is the backward kernel's general mode); bit-equal to the
    tiled forward's direct route on the same inputs (the same f32
    chain), timed beside it."""
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
            out = row(feats, idx, w)
            err = compare(name, dtype, out, neighbor_agg_ref(feats, idx, w))
            check(torch.equal(out, tiled((feats, idx, w), "direct")),
                  f"{name}: the row kernel and the direct route differ")
            del out
            gerr = grads_err(name, dtype, feats, idx, w)
            k_ms = time_ms(lambda: row(feats, idx, w), dev, sz.iters)
            d_ms = time_ms(lambda: tiled((feats, idx, w), "direct"), dev,
                           sz.iters)
            p_ms = time_ms(lambda: neighbor_agg_ref(feats, idx, w), dev,
                           sz.iters)
            lib = library_ms(lambda: torch.nn.functional.embedding_bag(
                idx, feats, mode="sum", per_sample_weights=w), dev, sz.iters)
            b_ms, b_by, nbytes = bound(feats, idx, None)
            measured[(dtype, d)] = dict(
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib, direct_route_ms=d_ms,
                bit_equal_direct_route=True)
            print(f"{name}: max_err={err:.3g} grad_max_err={gerr:.3g} "
                  f"kernel_ms={k_ms:.4f} direct_route_ms={d_ms:.4f} "
                  f"(bit-equal) plain_ms={p_ms:.4f} "
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
            check(torch.equal(row(feats, idx, w),
                              tiled((feats, idx, w), "direct")),
                  f"{name}: the row kernel and the direct route differ")
            gerr = grads_err(name, dtype, feats, idx, w)
            print(f"{name}: max_err={err:.3g} grad_max_err={gerr:.3g}, "
                  f"bit-equal to the direct route", flush=True)
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


def forward_faults(name, case, ref32) -> dict:
    """Outputs a faulty slab kernel could give at this shape, each of
    which the row check must reject: one dropped edge a row (edge 0),
    a row's first edge taken twice, slab 0 reading its columns shifted by
    one (the last of them its neighbour's first column), and the last
    slab skipped over an output of random values.  Returns each fault's
    row error."""
    feats, idx, w = case[:3]
    dtype = feats.dtype
    lo, hi = plan_of(case).bounds[0]
    shifted = feats.clone()
    shifted[:, lo:hi] = feats[:, lo + 1:hi + 1]
    skipped = tiled(case, "slab").clone()
    last = plan_of(case).bounds[-1][0]
    skipped[:, last:] = torch.randn_like(skipped[:, last:].float()).to(dtype)
    bad = {"one dropped edge a row": tiled(
               (feats, idx, torch.cat([torch.zeros_like(w[:, :1]), w[:, 1:]],
                                      1)), "slab"),
           "a row's first edge twice": tiled(
               (feats, idx, torch.cat([w[:, :1] * 2, w[:, 1:]], 1)), "slab"),
           "slab 0 shifted by one column": tiled((shifted, idx, w), "slab"),
           "last slab skipped": skipped}
    faults = {}
    for fault, out in bad.items():
        r = row_rel_err(out, ref32)
        check(r > FWD_ROW_TOL[dtype], f"{name}: the row check passes the "
              f"planted fault '{fault}' ({r} <= {FWD_ROW_TOL[dtype]})")
        faults[fault] = r
    return faults


def fullgraph_forward_times(dev, sz: Sizes, gen, idx, w) -> dict:
    """The tiled forward at the full-graph shape (B = N, the real ELL),
    bf16 at layer 1's and layer 2's gather widths: checked against its
    plain version (2e-2, and row by row against it in f32 on both
    routes, with planted faults), and timed beside it, ``embedding_bag``
    and the bound, both routes with and without an L2 flush and the slab
    route at every width."""
    out = {}
    n = idx.shape[0]
    for d in sz.agg_d:
        feats = torch.randn(n, d, generator=gen, device=dev).to(
            torch.bfloat16)
        case = (feats, idx, w)
        name = (f"tiled forward at the full-graph shape: bf16 N=B={n} "
                f"K={idx.shape[1]} D={d}")
        run = lambda: ops.neighbor_agg(feats, idx, w,  # noqa: E731
                                       use_kernel=True)
        err = compare(name, torch.bfloat16, run(),
                      neighbor_agg_ref(feats, idx, w))
        ref32 = neighbor_agg_ref(*as_f32(case))
        rows = check_routes(name, case, ref32)
        faults = forward_faults(name, case, ref32)
        del ref32
        routes = time_routes(case, dev, sz.path_iters, 1, widths=True)
        k_ms = time_ms(run, dev, sz.path_iters, 1)
        p_ms = time_ms(lambda: neighbor_agg_ref(feats, idx, w), dev,
                       sz.path_iters, 1)
        lib = library_ms(lambda: torch.nn.functional.embedding_bag(
            idx, feats, mode="sum", per_sample_weights=w), dev,
            sz.path_iters)
        b_ms, b_by, nbytes = bound(feats, idx, None)
        out[d] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                      bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                      row_rel_err=rows[routes["planned"]],
                      row_rel_err_by_route=rows,
                      row_check_limit=FWD_ROW_TOL[torch.bfloat16],
                      planted_faults=faults, routes=routes,
                      shape=name[len("tiled forward at the full-graph "
                                     "shape: "):])
        print(f"{name}: routes: {routes_line(routes, rows)}; planted "
              f"faults (slab route, row error) {faults}", flush=True)
        print(f"{name}: max_err={err:.3g} kernel_ms={k_ms:.4f} "
              f"plain_ms={p_ms:.4f} library_ms={fmt(lib)} (embedding_bag) "
              f"bound_ms={b_ms:.4f} (bound by {b_by}: {nbytes} B)",
              flush=True)
        del feats, case
    return out


def minibatch_levels(sz: Sizes, widths) -> list:
    """The tiled forwards of one mini-batch step (``core/gnn.py``
    ``minibatch_forward``: layer l aggregates hop h+1 into hop h for
    h < L - l, through ``_wsum`` with identity ids over the flattened
    fan-out tree, so N = B * K): (label, B, K, D) with D the layer's
    input width."""
    fan = tuple(sz.mb_fanout)
    out = []
    for layer, d in enumerate(widths):
        for hop in range(len(fan) - layer):
            out.append((f"minibatch_l{layer + 1}_hop{hop}",
                        sz.mb_b * math.prod(fan[:hop]), fan[hop], d))
    return out


def minibatch_forward_times(dev, sz: Sizes, widths) -> dict:
    """The tiled forward at the mini-batch levels' own shapes (f32,
    identity ids, GraphSAGE mask weights): both routes checked and timed
    beside the plain version, ``embedding_bag`` and the bound."""
    gen = torch.Generator(device=dev).manual_seed(4)
    out = {}
    for label, b, k, d in minibatch_levels(sz, widths):
        feats = torch.randn(b * k, d, generator=gen, device=dev)
        idx = torch.arange(b * k, dtype=torch.int32,
                           device=dev).reshape(b, k)
        w = (torch.rand(b, k, generator=gen, device=dev) > 0.1).float()
        case = (feats, idx, w)
        name = (f"tiled forward at the mini-batch level {label}: f32 "
                f"N={b * k} B={b} K={k} D={d}, identity ids")
        err = compare(name, torch.float32, tiled(case),
                      neighbor_agg_ref(*case))
        rows = check_routes(name, case)
        routes = time_routes(case, dev, sz.iters)
        p_ms = time_ms(lambda: neighbor_agg_ref(*case), dev, sz.iters)
        lib = library_ms(lambda: torch.nn.functional.embedding_bag(
            idx, feats, mode="sum", per_sample_weights=w), dev, sz.iters)
        b_ms, b_by, nbytes = bound(feats, idx, None)
        out[label] = dict(max_abs_err=err,
                          ms=routes[routes["planned"]]["ms"], plain_ms=p_ms,
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                          row_rel_err=rows[routes["planned"]],
                          row_rel_err_by_route=rows,
                          row_check_limit=FWD_ROW_TOL[torch.float32],
                          routes=routes, shape=name[len(
                              "tiled forward at the mini-batch level "):])
        print(f"{name}: routes: {routes_line(routes, rows)}; "
              f"max_err={err:.3g} plain_ms={p_ms:.4f} library_ms={fmt(lib)} "
              f"(embedding_bag) bound_ms={b_ms:.4f} (bound by {b_by}: "
              f"{nbytes} B)", flush=True)
        del feats, idx, w, case
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

    measured["identity_cases"] = identity_cases(dev, sz, gen)

    # ---- the training-path shapes: autograd asks for dfeats only.  The
    # full-graph shape runs the general mode (forced: the path itself
    # takes the reverse-index kernel), the mini-batch one the identity mode
    need = DFEATS
    idx_h, w_h, _ = to_ell(graph, max_deg=32)
    n = graph.n
    feats = torch.randn(n, 172, generator=gen, device=dev).to(torch.bfloat16)
    idx = torch.as_tensor(idx_h, device=dev)
    w = torch.as_tensor(w_h > 0, device=dev).to(torch.bfloat16)
    del idx_h, w_h
    dtype = feats.dtype
    b, k = idx.shape
    name = (f"backward path full-graph layer 2 (real ELL, GraphSAGE mask "
            f"weights), general mode: {str(dtype)[6:]} N={n} B={b} K={k} "
            f"D={feats.shape[1]}, dfeats only")
    g = torch.randn(b, feats.shape[1], generator=gen, device=dev).to(dtype)
    got = ops.neighbor_agg_backward(feats, idx, w, g, need=need)[0]
    want = neighbor_agg_backward_ref(feats, idx, w, g, need=need)[0]
    err = compare(name, dtype, got, want, GTOL[dtype])
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
    measured["fullgraph_l2"] = dict(
        max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib,
        shape=name[len("backward path "):])
    print(f"{name}: max_err={err:.3g} kernel_ms={k_ms:.4f} "
          f"plain_ms={p_ms:.4f} library_ms={fmt(lib)} (embedding_bag "
          f"backward) bound_ms={b_ms:.4f} (bound by {b_by}: {nbytes} B "
          f"= g + idx + w + dfeats)", flush=True)
    measured["csr"] = dict(
        csr_full_graph(dev, sz, gen, name, feats, idx, w, g),
        library_ms=lib, shape=measured["fullgraph_l2"]["shape"])
    measured["fullgraph_fwd"] = fullgraph_forward_times(dev, sz, gen, idx, w)
    del feats, idx, w, g
    measured["minibatch_l2"] = identity_path(dev, sz, gen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    return measured


def identity_inputs(gen, dev, b, k, d, dtype, fused=False):
    """A fan-out level's identity-id inputs: the [b·k, d] table, mask
    weights (a tenth 0), g and, fused, self_rows / w_self."""
    table = torch.randn(b * k, d, generator=gen, device=dev).to(dtype)
    w = (torch.rand(b, k, generator=gen, device=dev) > 0.1).to(dtype)
    g = torch.randn(b, d, generator=gen, device=dev).to(dtype)
    if not fused:
        return table, w, g, None, None
    return (table, w, g, torch.randn(b, d, generator=gen, device=dev).to(
        dtype), torch.rand(b, generator=gen, device=dev).to(dtype))


def arange_ids(w):
    b, k = w.shape
    return torch.arange(b * k, dtype=torch.int32,
                        device=w.device).reshape(b, k)


def check_identity(name, dtype, case, need) -> float:
    """The identity mode on ``case`` against its plain version and the
    general mode on ``arange`` ids: dfeats and dself bit-equal to both,
    dw and dw_self (dot products) bit-equal to the general mode and
    within ``TOL`` of the plain version.  Returns the largest error."""
    table, w, g, sr, ws = case
    got = ops.neighbor_agg_backward_identity(table, w, g, sr, ws, need=need)
    plain = neighbor_agg_backward_identity_ref(table, w, g, sr, ws, need)
    general = ops.neighbor_agg_backward(table, arange_ids(w), w, g, sr, ws,
                                        need=need)
    err = 0.0
    for j, (c, a, p, q) in enumerate(zip(("dfeats", "dw", "dself",
                                          "dw_self"), got, plain, general)):
        check((a is None) == (p is None) == (q is None),
              f"{name} {c}: outputs missing")
        if a is None:
            continue
        check(torch.equal(a, q), f"{name} {c}: not bit-equal to the "
              f"general mode")
        if j in (0, 2):
            check(torch.equal(a, p), f"{name} {c}: not bit-equal to the "
                  f"plain version")
        err = max(err, compare(f"{name} {c}", dtype, a, p))
    return err


def identity_cases(dev, sz: Sizes, gen) -> dict:
    """The identity mode at the levels' widths and ragged shapes (odd D,
    bf16 D = 172's 8-byte rows, K = 0, fused), every cotangent."""
    all4 = (True, True, True, True)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for b, k, d in ((4096, 10, 128), (4096, 15, 172), (2048, 15, 256),
                        (777, 7, 37), (300, 33, 300), (50, 0, 20),
                        (64, 3, 1)):
            b = min(b, sz.agg_b // 4)
            for fused in (False, True):
                name = (f"identity backward {str(dtype)[6:]} B={b} K={k} "
                        f"D={d} {'fused' if fused else 'unfused'}")
                errs[name] = check_identity(name, dtype, identity_inputs(
                    gen, dev, b, k, d, dtype, fused), all4)
    print(f"identity backward: {len(errs)} cases (every cotangent), dfeats "
          f"and dself bit-equal to the plain version and every output to "
          f"the general mode; largest dw / dw_self error "
          f"{max(errs.values()):.3g}", flush=True)
    return errs


def identity_path(dev, sz: Sizes, gen) -> dict:
    """Mini-batch layer 2 (f32, B = mb_b, K = fan-out[0], D = 256, mask
    weights, dfeats only, as autograd asks there) through the identity
    mode: bit-equal to its plain version, to the general mode forced on
    the same inputs and to itself; timed beside the plain version, the
    broadcast ``torch.mul`` (its library call), ``embedding_bag``'s
    backward, the general (atomic) mode on the same inputs and the
    bound."""
    b, k, d = sz.mb_b, sz.mb_fanout[0], 256
    dtype = torch.float32
    table, w, g, _, _ = identity_inputs(gen, dev, b, k, d, dtype)
    ids = arange_ids(w)
    need = DFEATS
    name = (f"backward path mini-batch layer 2 (identity ids): f32 "
            f"B={b} K={k} D={d}, dfeats only")
    err = check_identity(name, dtype, (table, w, g, None, None), need)
    got = ops.neighbor_agg_backward_identity(table, w, g, need=need)[0]
    check(torch.equal(got, ops.neighbor_agg_backward_identity(
        table, w, g, need=need)[0]), f"{name}: two calls differ")
    del got
    # the kernel's time: its dispatch (the launcher on the card), whose
    # host work stays below the kernel's; the public wrapper's checks
    # make a loop of it host-bound (wrapper_ms)
    k_ms = time_ms(lambda: ops._backward_identity(
        table, w, g, None, None, need), dev, sz.iters)
    w_ms = time_ms(lambda: ops.neighbor_agg_backward_identity(
        table, w, g, need=need), dev, sz.iters)
    p_ms = time_ms(lambda: neighbor_agg_backward_identity_ref(
        table, w, g, need=need), dev, sz.iters)
    lib = library_ms(lambda: torch.mul(w[:, :, None], g[:, None, :]), dev,
                     sz.iters)
    atomic_ms = time_ms(lambda: ops.neighbor_agg_backward(
        table, ids, w, g, need=need), dev, sz.iters)
    fe = table.clone().requires_grad_()
    eb = torch.nn.functional.embedding_bag(ids, fe, mode="sum",
                                           per_sample_weights=w)
    eb_ms = library_ms(lambda: torch.autograd.grad(
        eb, fe, g, retain_graph=True), dev, sz.iters)
    del fe, eb
    b_ms, b_by, nbytes = bound_bwd_identity(w, g, None, need)
    print(f"{name}: kernel_ms={k_ms:.4f} (launcher) wrapper_ms={w_ms:.4f} "
          f"plain_ms={p_ms:.4f} library_ms={fmt(lib)} (broadcast torch.mul) "
          f"embedding_bag_backward_ms={fmt(eb_ms)} general_mode_ms="
          f"{atomic_ms:.4f} (zero fill + atomics, same inputs) "
          f"bound_ms={b_ms:.4f} (bound by {b_by}: {nbytes} B = g + w + "
          f"dfeats); bit-equal to the plain version, the general mode and "
          f"itself", flush=True)
    return dict(max_abs_err=err, ms=k_ms, wrapper_ms=w_ms, plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                general_mode_ms_same_inputs=atomic_ms,
                embedding_bag_backward_ms=eb_ms,
                shape=name[len("backward path "):])


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
          f"+ {after_f['backward_identity'] / len(lf):.2f} identity "
          f"backward per step, eval included), "
          f"test_acc={res_f.final_test_acc:.4f}",
          flush=True)
    tm = src_m.timing
    nb = max(tm["batches"], 1)
    print(f"train: mini-batch SGD, {len(lm)} steps, b={sz.mb_b} fan-out "
          f"{sz.mb_fanout} (prefetch on): first/last loss {lm[0]:.5f} / "
          f"{lm[-1]:.5f}, {per_step_ms(res_m.history):.2f} ms/step steady, "
          f"run {wall_m:.3f} s, launches {launches_m} "
          f"({launches_m['tiled'] / len(lm):.2f} tiled + "
          f"{launches_m['backward_identity'] / len(lm):.2f} identity "
          f"backward + {launches_m['backward'] / len(lm):.2f} atomic "
          f"backward per step, eval included), "
          f"test_acc={res_m.final_test_acc:.4f}",
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
    # the tiled forward's routes the plan gives at the full-graph widths
    # (layer 1 gathers the input width, layer 2 the classes: GraphSAGE's
    # narrowing layer transforms first) and at the mini-batch levels.
    # Evaluation runs full-graph forwards in both runs: the mini-batch
    # run's launches are its steps' levels, then those forwards.
    fg_routes = [ops.tiled_plan(graph.n, graph.n, cfg.max_degree, d,
                                torch.bfloat16).route
                 for d in (cfg.feat_dim, cfg.n_classes)]
    levels = minibatch_levels(sz, (cfg.feat_dim, cfg.hidden))
    mb_routes = {ops.tiled_plan(b * k, b, k, d, torch.float32).route
                 for _, b, k, d in levels}
    mb_steps = len(lm) * len(levels)

    def want_routes(forwards, direct=0):
        return {f"tiled_{r}": forwards * fg_routes.count(r)
                + (direct if r == "direct" else 0) for r in ops.TILED_ROUTES}
    want_f = want_routes(after_f["tiled"] // len(fg_routes))
    want_m = want_routes((launches_m["tiled"] - mb_steps) // len(fg_routes),
                         mb_steps)
    print(f"train: tiled forward routes: full-graph {fg_routes} (layers 1, "
          f"2), mini-batch levels {sorted(mb_routes)}; expected launches "
          f"{want_f} full-graph run, {want_m} mini-batch run ({mb_steps} at "
          f"the levels, the rest its full-graph evaluations)", flush=True)
    if dev.type == "cuda":
        check(after_f["tiled"] > 0 and after_f["backward"] == 0
              and after_f["backward_csr"] == len(lf)
              and after_f["backward_identity"] == 0,
              f"full-graph steps launched the kernels {after_f}: not the "
              f"reverse-index backward once a step and the atomic one and "
              f"the identity mode never")
        check(after_f["tiled"] % len(fg_routes) == 0
              and {k: after_f[k] for k in want_f} == want_f,
              f"full-graph steps launched the tiled forward's routes "
              f"{after_f}, not the planned {fg_routes} in every forward")
        check(mb_routes == {"direct"}
              and (launches_m["tiled"] - mb_steps) % len(fg_routes) == 0
              and {k: launches_m[k] for k in want_m} == want_m,
              f"mini-batch run launched the tiled forward's routes "
              f"{launches_m}: not the direct route at every level "
              f"({mb_steps}) and the planned {fg_routes} in its "
              f"evaluations")
        check(launches_m["tiled"] > 0
              and launches_m["backward_identity"] == len(lm)
              and launches_m["backward"] == 0
              and launches_m["backward_csr"] == 0,
              f"mini-batch steps launched the kernels {launches_m}: not "
              f"the identity backward once a step and the atomic and "
              f"reverse-index ones never")

    # ---- checks and timings outside the counted window
    out_mb = minibatch_forward_times(dev, sz, (cfg.feat_dim, cfg.hidden))
    params = res_m.params
    leaves = [v for p in params for v in p.values()]
    out = {"counts": counts, "counts_full": after_f,
           "counts_mb": launches_m, "full_ms": per_step_ms(res_f.history),
           "mb_ms": per_step_ms(res_m.history), "mb_forward": out_mb}
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
            # the tiled forward's routes in turns: as planned, and every
            # forward forced to one route
            by_route = {"planned": [], "direct": [], "slab": []}
            for which in ("planned", "direct", "slab", "slab", "direct",
                          "planned"):
                with (contextlib.nullcontext() if which == "planned"
                      else ops._tiled_route(which)):
                    by_route[which].append(time_ms(lambda: step(rev), dev,
                                                   5, 1))
            out["full_device_ms_by_route"] = {
                k: float(np.mean(v)) for k, v in by_route.items()}
            print(f"train: full-graph device step by tiled-forward route "
                  f"(CUDA events, in turns on the same parameters): "
                  f"{by_route} ms", flush=True)
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
            # the device's own time for one step (the events above also
            # count the host's dispatch)
            prof = (profile_device(dev, lambda: tr_m._step(
                params, opt_state, batch)) if dev.type == "cuda" else {})
            if prof:
                print(f"train: profiled mini-batch step: wall "
                      f"{prof['wall_ms']:.2f} ms, device time "
                      f"{prof['device_ms']:.3f} ms, aggregation kernels "
                      f"{prof['agg_ms']:.3f} ms; largest kernels (name, ms, "
                      f"calls): {prof['top']}", flush=True)
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
    for nodes, rows in zip(upd, upd_rows):
        store.update_features(nodes, rows)
        t0 = time.perf_counter()
        infos.append((store.refresh(), time.perf_counter() - t0))
    launches = ops.launches
    counts = ops.launch_counts()
    # ---- end of the main path

    print(f"serve: build {build_s:.3f} s "
          f"({1e3 * build_s / graph.n:.6f} ms/node, per layer "
          f"{run.stats['per_layer_s']}, {run.stats['n_chunks']} chunks of "
          f"{run.stats['chunk_size']}), kernel launches: build "
          f"{build_launches}, main path {launches} (tiled forward by "
          f"route: slab {counts['tiled_slab']}, direct "
          f"{counts['tiled_direct']})", flush=True)
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
        # the build's chunks and the refreshes gather for fewer rows than
        # the table has (B < N): the plan's direct route
        check(sz.chunk >= graph.n or counts["tiled_slab"] == 0,
              f"serving path launched the tiled forward's routes {counts}: "
              f"not the direct route at B < N")

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
    return dict(launches=launches, counts=counts, build_s=build_s, stats=st)


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
    counts = ops.launch_counts()
    print(f"gcn: n={graph.n} build {build_s:.3f} s, per layer "
          f"{run.stats['per_layer_s']}, kernel launches {launches} (tiled "
          f"forward by route: slab {counts['tiled_slab']}, direct "
          f"{counts['tiled_direct']})", flush=True)
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
    # both routes at the build's own shapes: each layer's gather source
    # (layer 2 transforms first: 256 -> 172 narrows), the chunk's ELL
    # rows, its self rows fused
    idx, w, w_self = t[1:]
    by_shape = {}
    for li, table in enumerate((t[0], run.layers[0] @ params[1]["w"])):
        c = sz.chunk
        case = (table, idx[:c], w[:c], table[:c], w_self[:c])
        name = (f"gcn layer {li + 1} gather: f32 fused N={graph.n} B={c} "
                f"K={idx.shape[1]} D={table.shape[1]}")
        rows = check_routes(name, case)
        routes = time_routes(case, dev, sz.iters)
        b_ms, b_by, _ = bound(table, idx[:c], table[:c])
        by_shape[f"gcn_l{li + 1}_d{table.shape[1]}"] = dict(
            ms=routes[routes["planned"]]["ms"], bound_ms=b_ms, bound_by=b_by,
            plain_ms=time_ms(lambda: neighbor_agg_ref(*case), dev,
                             sz.iters),
            library_ms=None, row_rel_err=rows[routes["planned"]],
            row_rel_err_by_route=rows, row_check_limit=FWD_ROW_TOL[
                torch.float32], routes=routes, shape=name[len("gcn "):])
        print(f"{name}: routes: {routes_line(routes, rows)}; bound_ms="
              f"{b_ms:.4f} (bound by {b_by})", flush=True)
    return dict(launches=launches, counts=counts, by_shape=by_shape)


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

    def tf32x3(q, k, v, w):
        """The three-term TF32 kernel on inputs the router sends
        elsewhere, to time the two kernels on the same inputs (the plain
        version on the CPU, as the wrapper would take)."""
        if dev.type != "cuda":
            return kern(q, k, v, w)
        return fa._launch(q, k, v, w, "tf32x3")

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
            # each kernel twice on the same inputs: the same bits
            check(torch.equal(out, kern(q, k, v, w)),
                  f"{name}: two calls of the kernel differ")
            tf32x3_err = None
            if route == "wgmma":
                tf32x3_err = compare(f"{name} (tf32x3 kernel)", dtype,
                                     tf32x3(q, k, v, w), plain(q, k, v, w),
                                     FA_TOL[dtype])
            del out
            b_ms, b_by, nbytes, flops = flash_bound(b, s, hq, hkv, d, w,
                                                    dtype)
            # in bf16 the two kernels in turns on the same inputs
            k_ms = time_ms(lambda: kern(q, k, v, w), dev, sz.fa_iters)
            tf32x3_ms = None
            if route == "wgmma":
                tf32x3_ms = time_ms(lambda: tf32x3(q, k, v, w), dev,
                                    sz.fa_iters)
                k_ms = (k_ms + time_ms(lambda: kern(q, k, v, w), dev,
                                       sz.fa_iters)) / 2
            p_ms = time_ms(lambda: plain(q, k, v, w), dev,
                           max(sz.fa_iters // 2, 1), 1)
            lib = library_ms(_sdpa(q, k, v, w), dev, sz.fa_iters)
            measured[(dtype, w)] = dict(
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib, tf32x3_ms=tf32x3_ms,
                tf32x3_max_abs_err=tf32x3_err)
            rate = "989 TFLOP/s (bf16)"
            same = ""
            if route == "wgmma":
                measured[(dtype, w)].update(row_rel_err=row_err,
                                            planted_faults=planted)
                same = (f" tf32x3 kernel on the same inputs: ms="
                        f"{tf32x3_ms:.4f} max_err={tf32x3_err:.3g}")
            else:
                measured[(dtype, w)]["bound_fma_ms"] = fma_ms = flash_bound(
                    b, s, hq, hkv, d, w, dtype, rate=F32_FLOPS_PER_S)[0]
                rate = (f"495/3 TFLOP/s (3xTF32; at the f32-FMA rate of 67 "
                        f"TFLOP/s the bound is {fma_ms:.4f} ms)")
            print(f"{name}: {route} kernel max_err={err:.3g} "
                  f"kernel_ms={k_ms:.4f} (two calls bit-equal){same} "
                  f"plain_ms={p_ms:.4f} "
                  f"library_ms={fmt(lib)} (scaled_dot_product_attention) "
                  f"bound_ms={b_ms:.4f} (bound by {b_by}: {nbytes} B = q + "
                  f"k + v + o at 3.35 TB/s; {flops} flops at {rate}) "
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
    trace, beside its wall time: the flash and aggregation kernels'
    parts, the largest kernels.  Only the trace's device events are
    summed (the operators that launch them carry the same time again).
    A trace that cannot be taken leaves the numbers out ("not
    measured"); it does not stop the run."""
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
    agg = sum(_device_us(e) for e in evs if "neighbor_agg" in e.key)
    top = sorted(evs, key=_device_us, reverse=True)[:8]
    return {"wall_ms": 1e3 * wall, "device_ms": total / 1e3,
            "flash_ms": flash / 1e3, "agg_ms": agg / 1e3,
            "top": [(e.key[:70], round(_device_us(e) / 1e3, 3), e.count)
                    for e in top]}


def _print_profile(what, prof, label: str = "lm") -> None:
    if not prof or not prof["device_ms"]:
        print(f"{label}: profiled {what}: device time not measured",
              flush=True)
        return
    print(f"{label}: profiled {what}: wall {prof['wall_ms']:.2f} ms (traced), "
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
    return serve_case(dev, cfg, "lm", b=sz.lm_b, s=sz.lm_s, ngen=sz.lm_gen,
                      ntf=sz.lm_tf, f32_twin=True)


def stub_inputs(cfg, b: int, dev, seed: int) -> dict:
    """The stub frontends' embeddings of a batch of ``b``, drawn from a
    seeded generator: the VLM's patches [b, frontend_seq, d], whisper's
    frames [b, enc_seq, d] (nothing for the other families)."""
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    out = {}
    for key, n in (("patches", cfg.frontend_seq), ("frames", cfg.enc_seq)):
        if n and (key == "patches" or cfg.n_enc_layers):
            out[key] = torch.randn(b, n, cfg.d_model, generator=gen,
                                   device=dev).to(M._dt(cfg))
    return out


@contextlib.contextmanager
def observed(replay=None):
    """While open, records every flash-attention call of the model's
    layers as (window, head dim) and every MoE layer's expert a token
    ([B, S]) and dropped share (``moe.route``).  With ``replay`` (the
    experts an earlier run recorded, one [B, S] a MoE call, in order, or
    positions of them) each MoE call sends its tokens to those experts
    instead of the router's choice: two runs then route alike, and a
    comparison of them sees the kernels' rounding alone (a router near a
    tie flips an expert under another rounding, which moves that
    token's output by O(1)).  Launches nothing and counts nothing (the
    checks use it, never a counted window)."""
    seen = {"flash": [], "experts": [], "dropped": []}
    orig_fa, orig_route = L.flash_attention, MOE.route
    forced = iter(replay) if replay is not None else None

    def fa_obs(q, k, v, *, window=0, use_kernel=False):
        seen["flash"].append((window, q.shape[-1]))
        return orig_fa(q, k, v, window=window, use_kernel=use_kernel)

    def route_obs(params, x, cfg, expert=None):
        b, s = x.shape[:2]
        if forced is not None:
            expert = next(forced).reshape(b, -1, min(cfg.moe_group, s))
        out = orig_route(params, x, cfg, expert)
        seen["experts"].append(out[2].reshape(b, s))
        seen["dropped"].append(1.0 - float(out[0].sum()) / (b * s))
        return out
    L.flash_attention, MOE.route = fa_obs, route_obs
    try:
        yield seen
    finally:
        L.flash_attention, MOE.route = orig_fa, orig_route


def plain_cfg(cfg, s: int):
    """The config of the plain path at a prompt of ``s`` positions: its
    query chunk cut to divide ``s`` (whisper's 448 tokens against 512),
    which tiles the same function."""
    return dataclasses.replace(cfg, q_chunk=math.gcd(cfg.q_chunk, s))


def plan_flash_calls(cfg) -> collections.Counter:
    """The (window, head dim) of every causal self-attention of one
    forward, from the layer plan."""
    return collections.Counter(
        (cfg.sliding_window if t == "local" else 0, cfg.resolved_head_dim)
        for t in cfg.pattern if t != "mamba")


def serve_case(dev, cfg, label: str, *, b: int, s: int, ngen: int,
               ntf: int, f32_twin: bool = False, hold_tf: bool = True,
               measure_peak: bool = False) -> dict:
    """One model through the port's serving steps (``models.steps``),
    random weights drawn on the card from a seeded generator in the
    config's dtype: prefill of ``b`` x ``s`` tokens (after the VLM's
    patches, beside whisper's frames) then ``ngen`` greedy decode steps,
    between a reset and a read of the flash launch counts (the main
    path): one launch of the routed kernel per causal self-attention of
    the plan and none of the other.  Outside that window: the flash
    calls' windows and head dims against the plan; the prefill's last
    logits against the plain path (LM_PLAIN_TOL); ``ntf`` teacher-forced
    decode steps against the forward over the prompt and ``ext`` more
    tokens (256 where MoE groups or SSD chunks need a multiple of 256,
    with the MoE's capacity factor raised to its expert count, under
    which nothing drops and decode computes the same function); profiler
    tables of one prefill and one decode step.  The run compared with the
    kernel's replays its MoE routing (``observed(replay=)``).  With
    ``f32_twin`` the model is drawn again in f32, its prefill counted the
    same way (the tf32x3 kernel) and held to the plain path at 1e-3;
    without ``hold_tf`` the bf16 teacher-forced reading is printed, not
    held, and the f32 twin's is held at 1e-3 instead (zamba2-7b: the
    rounding of 81 random bf16 layers, carried in the SSD and KV caches
    from step to step, reads 5.5e-2 by step 7).  With ``measure_peak``
    the prefill's peak device bytes are measured."""
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
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"{label}: {cfg.name} {cfg.n_layers} layers, {n_params} "
          f"parameters in {M._dt(cfg)} drawn on {dev} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ext = 256 if cfg.n_experts or "mamba" in cfg.pattern else ntf
    p0 = cfg.frontend_seq
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s + ext)),
                           device=dev)
    full = {"tokens": toks, **stub_inputs(cfg, b, dev, 0)}
    prompt = dict(full, tokens=toks[:, :s])
    prefill = steps.make_prefill_step(cfg)
    decode = steps.make_serve_step(cfg)
    n_attn = M.causal_attention_layers(cfg)
    route = fa.kernel_route(M._dt(cfg), cfg.resolved_head_dim) \
        if n_attn else None
    want_counts = {r: n_attn if r == route else 0 for r in fa.ROUTES}
    out = {}
    with torch.inference_mode():
        # ---- the main path, between the launch-count reset and its read
        fa.reset_launches()
        sync()
        t0 = time.perf_counter()
        last, cache = prefill(params, prompt, p0 + s + ngen)
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
        print(f"{label}: prefill {b} x {p0 + s} tokens in {prefill_s:.3f} s "
              f"({b * (p0 + s) / prefill_s:.1f} tokens/s, first call); "
              f"{ngen} greedy decode steps in {decode_s:.3f} s "
              f"({1e3 * decode_s / ngen:.2f} ms/step, "
              f"{b * ngen / decode_s:.1f} tokens/s); flash launches: "
              f"prefill {prefill_launches} {prefill_counts}, main path "
              f"{launches} {counts}", flush=True)
        if dev.type == "cuda":
            check(prefill_launches == n_attn and launches == n_attn
                  and prefill_counts == want_counts and counts == want_counts,
                  f"{label}: prefill launched the flash kernels "
                  f"{prefill_counts} (main path {counts}), not the {route} "
                  f"kernel once per causal self-attention ({n_attn}) and no "
                  f"other")
        check(bool(finite), f"{label}: a prefill or decode logit is not "
              f"finite")
        check(bool(((gen_toks >= 0) & (gen_toks < cfg.vocab_size)).all()),
              f"{label}: a generated token is outside the vocab")

        # ---- checks and timings outside the counted window
        with observed() as seen_k:
            sync()
            t0 = time.perf_counter()
            k_last, _ = prefill(params, prompt)
            sync()
            prefill2_s = time.perf_counter() - t0
        calls = collections.Counter(seen_k["flash"])
        check(calls == plan_flash_calls(cfg),
              f"{label}: flash calls (window, head dim) {dict(calls)} "
              f"against the plan's {dict(plan_flash_calls(cfg))}")
        with observed(replay=seen_k["experts"]):
            sync()
            t0 = time.perf_counter()
            plain_last, _ = M.prefill(params, plain_cfg(cfg, p0 + s),
                                      prompt, kernel=False)
            sync()
            plain_s = time.perf_counter() - t0
        if cfg.n_experts:
            print(f"{label}: tokens dropped at capacity factor "
                  f"{cfg.capacity_factor}, by MoE layer: "
                  f"{[round(x, 6) for x in seen_k['dropped']]}", flush=True)
            out["dropped"] = seen_k["dropped"]
        check_plain(cfg, k_last, plain_last, f"{label}, plain path "
                    f"{plain_s:.3f} s")
        out["plain_rel_err"] = logits_err(cfg, k_last, plain_last)
        del k_last, plain_last, seen_k
        if measure_peak:
            out["peak_bytes"], out["peak_counts"], _ = measured_step(
                dev, prefill, (params, prompt), 0)
        print(f"{label}: second prefill {prefill2_s:.3f} s "
              f"({b * (p0 + s) / prefill2_s:.1f} tokens/s)", flush=True)
        bf16 = M._dt(cfg) == torch.bfloat16
        errs, cache = teacher_forced(
            params, cfg, label, full, s, ext, ntf,
            (LM_DECODE_TOL if hold_tf else None) if bf16
            else LM_PLAIN_TOL[torch.float32])
        prof_decode = ({} if dev.type != "cuda" else profile_device(
            dev, lambda: decode(params, cache, toks[:, -1:])))
        del cache
        out.update(launches=launches, counts=counts, prefill_s=prefill_s,
                   prefill2_s=prefill2_s, decode_ms=1e3 * decode_s / ngen,
                   tokens=b * (p0 + s), tf_errs=errs,
                   flash_calls={f"{w}/{d}": n for (w, d), n in calls.items()},
                   flash_shapes=[(b, p0 + s, SH.padded_heads(cfg.n_heads),
                                  cfg.n_kv_heads, d, w, n)
                                 for (w, d), n in sorted(calls.items())])
        if dev.type == "cuda":
            _print_profile("prefill", profile_device(
                dev, lambda: prefill(params, prompt)), label)
            _print_profile("decode step", prof_decode, label)
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated(
                dev)
            print(f"{label}: max memory allocated "
                  f"{out['max_memory_allocated'] / 2**30:.2f} GiB",
                  flush=True)
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if not f32_twin:
        return out
    if M._dt(cfg) == torch.float32:           # the main path was f32 already
        out["counts_f32"] = counts
        return out
    # the same comparison with the model drawn in f32, where neither path
    # rounds to bf16
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = M.init_model(torch.Generator(device=dev).manual_seed(0),
                          cfg32, dev, dtype=torch.float32)
    prompt32 = {k: v.float() if v.is_floating_point() else v
                for k, v in prompt.items()}
    with torch.inference_mode():
        # ---- the f32 model's prefill, between a reset and a read
        fa.reset_launches()
        t0 = time.perf_counter()
        with observed() as seen_k:
            got, _ = steps.make_prefill_step(cfg32)(params, prompt32)
        sync()
        out["prefill_s_f32"] = time.perf_counter() - t0
        out["counts_f32"] = fa.launch_counts()
        # ---- end of the f32 model's prefill
        with observed(replay=seen_k["experts"]):
            want, _ = M.prefill(params, plain_cfg(cfg32, p0 + s), prompt32,
                                kernel=False)
    print(f"{label}: f32 model prefill flash launches {out['counts_f32']}, "
          f"{out['prefill_s_f32']:.4f} s (first call, host clock)",
          flush=True)
    if dev.type == "cuda":
        route = fa.kernel_route(torch.float32, cfg.resolved_head_dim)
        check(out["counts_f32"] == {r: n_attn if r == route else 0
                                    for r in fa.ROUTES},
              f"{label}: f32 prefill launched the flash kernels "
              f"{out['counts_f32']}, not the {route} kernel once per causal "
              f"self-attention")
    check_plain(cfg32, got, want, f"{label}, f32 model")
    out["plain_rel_err_f32"] = logits_err(cfg, got, want)
    del got, want
    if not hold_tf:
        full32 = {k: v.float() if v.is_floating_point() else v
                  for k, v in full.items()}
        with torch.inference_mode():
            out["tf_errs_f32"], _ = teacher_forced(
                params, cfg32, f"{label} f32 model", full32, s, ext, ntf,
                LM_PLAIN_TOL[torch.float32])
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def teacher_forced(params, cfg, label: str, full: dict, s: int, ext: int,
                   ntf: int, limit):
    """``ntf`` teacher-forced decode steps after a prefill of the first
    ``s`` tokens of ``full`` against the forward over all of them (``s +
    ext``), relative max error of each step's logits (the prefill's
    first).  An MoE runs with its capacity factor raised to its expert
    count, under which nothing drops and decode computes the forward's
    function, and the prefill and each step replay the forward's routing
    of their positions.  Held at ``limit`` (printed only when None).
    Returns (errors, the decode cache)."""
    dev = full["tokens"].device
    toks = full["tokens"]
    p0 = cfg.frontend_seq
    tcfg = dataclasses.replace(cfg, capacity_factor=float(
        cfg.n_experts)) if cfg.n_experts else cfg
    with observed() as seen:
        x, enc = M._inputs(params, tcfg, full)
        hid, _, _ = M.backbone(params, tcfg, x,
                               torch.arange(x.shape[1], device=dev), enc)
        want = M.logits_fn(params, tcfg,
                           hid[:, p0 + s - 1:p0 + s + ntf]).float()
    del x, hid, enc
    experts = seen["experts"]
    with observed(replay=[e[:, :p0 + s] for e in experts]):
        last, cache = M.prefill(params, tcfg, dict(full, tokens=toks[:, :s]),
                                p0 + s + ext)
    errs = [logits_err(cfg, last, want[:, 0])]
    for t in range(ntf):
        with observed(replay=[e[:, p0 + s + t] for e in experts]):
            lg, cache = M.decode_step(params, tcfg, cache,
                                      toks[:, s + t:s + t + 1])
        errs.append(logits_err(cfg, lg, want[:, t + 1]))
    print(f"{label}: teacher-forced decode vs the forward over "
          f"{p0 + s + ext} tokens"
          f"{' (capacity factor = experts)' if cfg.n_experts else ''}, "
          f"relative max error by step (prefill first): "
          f"{[f'{e:.3g}' for e in errs]} "
          f"({f'limit {limit}' if limit else 'printed, not held'})",
          flush=True)
    if limit:
        check(max(errs) <= limit, f"{label}: teacher-forced decode rel "
              f"err {max(errs)} beyond {limit}")
    return errs, cache


def logits_err(cfg, got, want) -> float:
    """Relative max error of logits over the vocab (the padding columns
    hold -1e30 and would swamp the denominator)."""
    v = cfg.vocab_size
    return rel_err(got[..., :v].float(), want[..., :v].float())


def check_plain(cfg, got, want, what) -> None:
    """The prefill's last logits with the kernel against the plain
    path."""
    dt = M._dt(cfg)
    err = logits_err(cfg, got, want)
    print(f"lm: prefill last logits ({str(dt)[6:]}), flash kernel vs the "
          f"plain path (chunked attention; {what}): relative max error "
          f"{err:.4g} (limit {LM_PLAIN_TOL[dt]})", flush=True)
    check(err <= LM_PLAIN_TOL[dt],
          f"prefill kernel vs plain rel err {err} beyond {LM_PLAIN_TOL[dt]}")


# ---------------------------------------------------------------------------
# phase 10: the paper's figures
# ---------------------------------------------------------------------------

#: the reference's row count of each figure bench (quick or full)
FIG_ROWS = {"fig1_metric_stability": 3, "fig2_convergence": 16,
            "fig3_generalization": 36, "fig4_multilayer": 14,
            "fig5_iter_to_acc": 12, "fig6_throughput": 9,
            "table1_tuned": 4, "thm3_wasserstein": 10, "theory_slopes": 30}
#: the figure benches that train no model (numpy and closed forms)
HOST_ONLY = ("thm3_wasserstein", "theory_slopes")
#: the figures run a second time with the kernel switch off (10d)
PATH_FIGS = ("fig6_throughput", "fig1_metric_stability")
#: kernel path against plain path: first and last loss, relative (f32)
PATH_TOL = 1e-3
#: where the figure benches write their CSV and JSON files (the CLI
#: writes to its own default, experiments/bench_torch/)
FIG_OUT = "experiments/bench_torch/chip_smoke"


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def check_launch(dev, cond, msg: str) -> None:
    """A launch-count check: on the card only (the CPU runs the kernels'
    plain versions, which count nothing)."""
    check(dev.type != "cuda" or cond, msg)


#: the figure benches' QUICK tables at full size, cut for the run's time:
#: fig2 from 250 iterations and seeds (0, 1) to 100 and one seed for
#: phase 16 (the whole run near 1,000 s), then with fig3 (150) and
#: table1 (120) to give phase 19 its room
QUICK_CUTS = {
    "repro_torch.bench.bench_fig2_convergence": dict(iters=50, seeds=(0,)),
    "repro_torch.bench.bench_fig3_generalization": dict(iters=75),
    "repro_torch.bench.bench_table1_tuned": dict(iters=60),
}


@contextlib.contextmanager
def bench_sizes(sz: Sizes):
    """The figure benches' ``QUICK`` tables cut to ``sz.fig_n`` nodes and
    ``sz.fig_iters`` iterations inside the block (the CPU rehearsal);
    when ``fig_n`` is 0, only those of ``QUICK_CUTS``, as it says."""
    saved = []
    if sz.fig_n:
        for _, mod_name in brun.BENCHES:
            quick = getattr(importlib.import_module(mod_name), "QUICK", None)
            if quick is None:
                continue
            saved.append((quick, dict(quick)))
            quick["n"] = sz.fig_n
            if "iters" in quick:
                quick["iters"] = sz.fig_iters
    else:
        for mod_name, cut in QUICK_CUTS.items():
            quick = importlib.import_module(mod_name).QUICK
            saved.append((quick, dict(quick)))
            quick.update(cut)
    try:
        yield
    finally:
        for quick, old in saved:
            quick.clear()
            quick.update(old)


@contextlib.contextmanager
def trainer_runs():
    """Every ``Trainer.run`` inside the block, in order: its steps, first
    and last loss, whether every loss was finite, its test accuracy and
    the size of its test split."""
    runs = []
    orig = E.Trainer.run

    def run(self, *a, **kw):
        res = orig(self, *a, **kw)
        losses = res.history.losses
        runs.append({"steps": len(losses), "first_loss": losses[0],
                     "final_loss": losses[-1],
                     "finite": bool(np.isfinite(losses).all()),
                     "test_acc": res.final_test_acc,
                     "n_test": len(self.graph.test_nodes)})
        return res

    E.Trainer.run = run
    try:
        yield runs
    finally:
        E.Trainer.run = orig


def cli_phase(dev) -> dict:
    """10a: the experiment CLI with the reference's default grid (and a
    2-layer variant), the kernels on: every row ok with finite losses,
    its JSON and CSV files written, the tiled forward launched."""
    out = {}
    for layers in (1, 2):
        argv = ["--preset", "arxiv-like", "--kernel", "--fullgraph",
                "--device", dev.type, "--layers", str(layers),
                "--out", f"cli_layers{layers}"]
        ops.reset_launches()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rows = X.main(argv)
        sync(dev)
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        lines = buf.getvalue().strip().splitlines()
        for line in lines:
            print(f"cli layers={layers}: {line}", flush=True)
        paths = json.loads(lines[-1])
        check(paths["rows"] == len(rows) == 3,
              f"cli: {len(rows)} rows, not the default grid's 3")
        for r in rows:
            check(r.get("status", "ok") == "ok", f"cli: row not ok: {r}")
            check(math.isfinite(r["first_loss"])
                  and math.isfinite(r["final_loss"]),
                  f"cli: a loss is not finite: {r}")
        check(os.path.isfile(paths["json"]) and os.path.isfile(paths["csv"]),
              f"cli: {paths} not written")
        check_launch(dev, counts["tiled"] > 0,
                     f"cli: no tiled launch: {counts}")
        print(f"cli layers={layers}: {len(rows)} rows ok in {secs:.2f} s, "
              f"launches {counts}", flush=True)
        out[f"layers{layers}"] = dict(seconds=secs, launches=counts)
    return out


def sweep_phase(dev, sz: Sizes, graph) -> dict:
    """10b: ``sweep`` at full width (gnn-papers100m: GraphSAGE, feat 128,
    hidden 256, 172 classes, 2 layers, bf16 aggregation, kernels on) on
    the shared graph: the full-graph corner, then b x fan-out points,
    each with ``inference=True``, its launches counted alone.  The
    full-graph corner's ELL is the reference sweep's, K = d_max."""
    cfg = get_config("gnn-papers100m")
    cfg = dataclasses.replace(cfg, n_nodes=graph.n, feat_dim=128,
                              n_classes=172,
                              batch_size=min(cfg.batch_size, graph.n))
    check(cfg.dtype == "bfloat16" and cfg.use_agg_kernel
          and cfg.hidden == 256 and cfg.n_layers == 2,
          f"unexpected gnn-papers100m config {cfg}")
    plan = E.TrainPlan(lr=TRAIN_LR, n_iters=sz.fw_steps,
                       eval_every=sz.fw_eval, seed=0)
    grids = [("fullgraph", dict(include_fullgraph=True))] + [
        (f"b={b} fan-out {'x'.join(map(str, fo))}",
         dict(batch_sizes=[b], fanout_grid=[fo]))
        for b in sz.fw_bs for fo in sz.fw_fanouts]
    out = {}
    for label, grid in grids:
        ops.reset_launches()
        sync(dev)
        t0 = time.perf_counter()
        (row,) = X.sweep(graph, cfg, plan, inference=True, serve_queries=32,
                         device=dev, **grid)
        sync(dev)
        secs = time.perf_counter() - t0
        n = ops.launch_counts()
        print(f"sweep {label} (K={graph.d_max} full-graph ELL): {secs:.2f} s,"
              f" launches {n}; row {json.dumps(row)}", flush=True)
        check(math.isfinite(row["first_loss"])
              and math.isfinite(row["final_loss"]),
              f"sweep {label}: a loss is not finite: {row}")
        check_launch(dev, n["tiled"] > 0,
                     f"sweep {label}: no tiled launch: {n}")
        if label == "fullgraph":
            check_launch(dev, n["backward_csr"] > 0 and n["backward"] == 0
                         and n["backward_identity"] == 0,
                         f"sweep {label}: wants the reverse-index backward "
                         f"and no atomic or identity one: {n}")
        else:
            check_launch(dev, n["backward_identity"] > 0
                         and n["backward"] == 0,
                         f"sweep {label}: wants the identity backward and "
                         f"no atomic one: {n}")
        out[label] = dict(seconds=secs, launches=n, row=row)
    E.drop_device_cache(graph)
    return out


def _finite_numbers(name, rows) -> None:
    """The losses a figure reports are finite wherever the reference
    reports a number (fig2 reports inf where no lr of its grid reached
    the target: ``best_lr`` None)."""
    for r in rows:
        for k in ("first_loss", "final_loss"):
            if k in r and not (name == "fig2_convergence"
                               and r["best_lr"] is None):
                check(math.isfinite(r[k]), f"{name}: {k} not finite: {r}")


def figures_phase(dev, sz: Sizes) -> dict:
    """10c: every figure bench in quick mode, the kernel switch on,
    through ``repro_torch.bench.run`` (each bench prints its rows): the
    reference's row count, finite losses, kernel launches for every
    figure that trains, every prefetch thread ended and device memory
    back to where it was after each figure."""
    env = Env(device=str(dev), kernel=True, out_dir=FIG_OUT)
    threads = threading.active_count()
    gc.collect()
    base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out = {}
    for name in brun.selected():
        ops.reset_launches()
        sync(dev)
        t0 = time.perf_counter()
        with trainer_runs() as runs:
            rows = brun.run_one(name, quick=True, env=env)
        sync(dev)
        secs = time.perf_counter() - t0
        n = ops.launch_counts()
        steps = sum(r["steps"] for r in runs)
        gc.collect()
        alloc = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
        print(f"figure {name}: {secs:.2f} s, {len(runs)} runs, {steps} steps "
              f"({steps / secs:.1f} steps/s), {len(rows)} rows, launches "
              f"tiled {n['tiled']} backward {n['backward']} backward_csr "
              f"{n['backward_csr']} backward_identity "
              f"{n['backward_identity']} ({n}), device memory after "
              f"{alloc / 2 ** 20:.1f} MiB (before 10c "
              f"{base / 2 ** 20:.1f})", flush=True)
        check(len(rows) == FIG_ROWS[name],
              f"{name}: {len(rows)} rows, the reference has "
              f"{FIG_ROWS[name]}")
        _finite_numbers(name, rows)
        check(all(r["finite"] for r in runs),
              f"{name}: a training loss is not finite")
        if name not in HOST_ONLY:
            check(len(runs) > 0, f"{name}: no Trainer run")
            check_launch(dev, n["tiled"] > 0,
                         f"{name}: trained without the tiled kernel: {n}")
        check(threading.active_count() == threads,
              f"{name}: threads left running: {threading.enumerate()}")
        check(alloc <= base + 64 * 2 ** 20,
              f"{name}: device memory grew from {base} to {alloc} B")
        out[name] = dict(seconds=secs, runs=len(runs), steps=steps,
                         steps_per_s=steps / secs, rows=len(rows),
                         launches=n, row_data=rows, run_records=runs)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    print(f"figures: peak device memory {peak / 2 ** 20:.1f} MiB over 10c",
          flush=True)
    out["peak_bytes"] = peak
    return out


def path_phase(dev, figures: dict) -> dict:
    """10d: fig6 and fig1 again with the kernel switch off, from the same
    initial parameters (each run's own seed): run by run, the first and
    last loss within 1e-3 relative and the test accuracy within one node
    of its split against 10c's kernel runs."""
    env = Env(device=str(dev), kernel=False, out_dir=FIG_OUT + "/plain")
    out = {}
    for name in PATH_FIGS:
        ops.reset_launches()
        with trainer_runs() as runs:
            rows = brun.run_one(name, quick=True, env=env)
        check(ops.launch_counts()["tiled"] == 0,
              f"{name}: the plain path launched a kernel")
        kern = figures[name]["run_records"]
        check(len(runs) == len(kern), f"{name}: {len(runs)} plain runs, "
              f"{len(kern)} kernel runs")
        worst, acc = 0.0, 0.0
        for a, b in zip(kern, runs):
            check(a["steps"] == b["steps"], f"{name}: steps differ {a} {b}")
            for k in ("first_loss", "final_loss"):
                rel = abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                worst = max(worst, rel)
                check(rel <= PATH_TOL, f"{name}: {k} kernel {a[k]} plain "
                      f"{b[k]} (relative {rel:.3g} > {PATH_TOL})")
            d = abs(a["test_acc"] - b["test_acc"])
            acc = max(acc, d)
            check(d <= 1.0 / a["n_test"] + 1e-6,
                  f"{name}: test_acc kernel {a['test_acc']} plain "
                  f"{b['test_acc']} differ by more than one node")
        print(f"path {name}: kernel vs plain over {len(runs)} runs: worst "
              f"loss relative difference {worst:.3g} (limit {PATH_TOL}), "
              f"test_acc difference at most {acc:.4g}; plain rows "
              f"{[json.dumps(r) for r in rows]}", flush=True)
        out[name] = dict(worst_loss_rel=worst, worst_acc=acc, runs=len(runs))
    return out


def figure_shapes(dev, sz: Sizes) -> dict:
    """The kernels at shapes the figures give them (f32): the full-graph
    forward on table1's papers-like ELL (power-law degrees, K = d_max)
    at D = 64 (layer 1) and its reverse-index backward at D = 24 (layer
    2's narrowed table), fig6's mini-batch level (b = 128, β = 10,
    D = 64, identity ids) forward and its backward through the backward
    kernel's identity mode at fig4's layer 2 (the same shape; the general
    mode timed beside it).  Each against its plain version, timed
    beside it, the bound and ``embedding_bag`` (forward and backward)."""
    gen = torch.Generator(device=dev).manual_seed(7)
    table1 = importlib.import_module("repro_torch.bench.bench_table1_tuned")
    g = make_preset("papers-like", seed=0, n=table1.QUICK["n"],
                    homophily=0.55, feat_scale=0.3, train_frac=0.3)
    idx, w, _ = (torch.as_tensor(a).to(dev) for a in to_ell(g))
    n, k = idx.shape
    mb_b, mb_k, d = 128, 10, 64
    cases = {
        f"fullgraph_papers_like_n{n}_k{k}_d64": (
            torch.randn(n, d, generator=gen, device=dev), idx,
            (w > 0).float()),
        f"minibatch_b{mb_b}_k{mb_k}_d64": (
            torch.randn(mb_b * mb_k, d, generator=gen, device=dev),
            torch.arange(mb_b * mb_k, dtype=torch.int32,
                         device=dev).reshape(mb_b, mb_k),
            (torch.rand(mb_b, mb_k, generator=gen, device=dev) > 0.1
             ).float())}
    out = {"forward": {}, "backward_identity": {}, "backward_csr": {}}
    for label, case in cases.items():
        feats, cidx, cw = case
        err = compare(f"figure shape {label}", torch.float32, tiled(case),
                      neighbor_agg_ref(*case))
        check(plan_of(case).route == "direct",
              f"figure shape {label}: planned {plan_of(case).route}")
        k_ms = time_ms(lambda: tiled(case), dev, sz.iters)
        p_ms = time_ms(lambda: neighbor_agg_ref(*case), dev, sz.iters)
        lib = library_ms(lambda: torch.nn.functional.embedding_bag(
            cidx, feats, mode="sum", per_sample_weights=cw), dev, sz.iters)
        b_ms, b_by, nbytes = bound(feats, cidx, None)
        out["forward"][label] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                                     bound_ms=b_ms, bound_by=b_by,
                                     library_ms=lib)
        print(f"figure shape {label}: tiled forward (direct) "
              f"max_err={err:.3g} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
              f"library_ms={fmt(lib)} (embedding_bag) bound_ms={b_ms:.4f} "
              f"(bound by {b_by}: {nbytes} B)", flush=True)
        dg = 24 if label.startswith("fullgraph") else d
        tab = torch.randn(feats.shape[0], dg, generator=gen, device=dev)
        gr = torch.randn(cidx.shape[0], dg, generator=gen, device=dev)
        fe = tab.clone().requires_grad_()
        eb = torch.nn.functional.embedding_bag(cidx, fe, mode="sum",
                                               per_sample_weights=cw)
        lib = library_ms(lambda: torch.autograd.grad(
            eb, fe, gr, retain_graph=True), dev, sz.iters)
        want = neighbor_agg_backward_ref(tab, cidx, cw, gr, need=DFEATS)[0]
        label = f"{label[:label.rindex('_d')]}_d{dg}"
        if label.startswith("fullgraph"):
            rev = ops.build_reverse_index(cidx, cw, n)
            run = lambda: csr_dfeats(tab, cidx, cw, gr, rev)  # noqa: E731
            plain = lambda: neighbor_agg_backward_csr_ref(  # noqa: E731
                rev, cw, gr)
            row_err = row_rel_err(run(), plain())
            check(row_err <= CSR_ROW_TOL[torch.float32],
                  f"figure shape {label}: reverse-index row error "
                  f"{row_err}")
            b_ms, b_by, nbytes = bound_bwd_csr(rev, dg, 4)
            key, what = "backward_csr", "reverse-index backward"
        else:
            run = lambda: ops.neighbor_agg_backward_identity(  # noqa: E731
                tab, cw, gr, need=DFEATS)[0]
            plain = lambda: neighbor_agg_backward_identity_ref(  # noqa: E731
                tab, cw, gr, need=DFEATS)[0]
            check(torch.equal(run(), plain()), f"figure shape {label}: the "
                  f"identity backward differs from its plain version")
            row_err = row_rel_err(run(), want)
            b_ms, b_by, nbytes = bound_bwd_identity(cw, gr, None, DFEATS)
            key, what = "backward_identity", "identity backward"
        err = compare(f"figure shape {label} {what}", torch.float32, run(),
                      want, GTOL[torch.float32])
        k_ms = time_ms(run, dev, sz.iters)
        p_ms = time_ms(plain, dev, sz.iters)
        out[key][label] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                               bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                               row_rel_err=row_err)
        extra = ""
        if key == "backward_identity":
            # its library call is the broadcast product; embedding_bag's
            # backward and the general (atomic) mode beside it
            out[key][label].update(
                embedding_bag_backward_ms=lib, library_ms=library_ms(
                    lambda: torch.mul(cw[:, :, None], gr[:, None, :]), dev,
                    sz.iters),
                general_mode_ms_same_inputs=time_ms(
                    lambda: ops.neighbor_agg_backward(
                        tab, cidx, cw, gr, need=DFEATS), dev, sz.iters))
            extra = (f" (broadcast torch.mul "
                     f"{fmt(out[key][label]['library_ms'])}, general mode "
                     f"{out[key][label]['general_mode_ms_same_inputs']:.4f})")
        print(f"figure shape {label}: {what} max_err={err:.3g} row error "
              f"{row_err:.3g} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
              f"library_ms={fmt(lib)} (embedding_bag backward){extra} "
              f"bound_ms={b_ms:.4f} (bound by {b_by}: {nbytes} B)",
              flush=True)
        del fe, eb
    return out


def figure_traces(dev, steps: int = 100) -> dict:
    """The device's busy share in two figure runs with the kernels on,
    from a ``torch.profiler`` trace of ``steps`` steps after a 5-step
    warm-up run (uploads, allocator): one of fig2's grid points (b = 128,
    β = 10, lr 0.2, the full loss tracked every 5 steps) and fig1's
    full-graph run (an evaluation every step).  On the card only."""
    if dev.type != "cuda":
        return {}
    from repro_torch.bench import bench_fig1_metric_stability as F1
    from repro_torch.bench import bench_fig2_convergence as F2
    from repro_torch.bench import common as C
    env = Env(device=str(dev), kernel=True)
    g2 = make_preset("products-like", seed=0, n=F2.QUICK["n"],
                     homophily=0.6, feat_scale=0.45)
    cfg2 = C.gnn_cfg(env, g2, n_layers=1, loss="ce")
    g1 = make_preset("arxiv-like", seed=0, n=F1.QUICK["n"], homophily=0.55,
                     feat_scale=0.3, train_frac=0.3)
    cfg1 = C.gnn_cfg(env, g1, n_layers=1, loss="ce")
    runs = {
        "fig2 grid point b=128 beta=10": lambda n: F2._one(
            env, g2, cfg2, 128, (10,), n, 0.2, 0),
        "fig1 full-graph run": lambda n: C.run_fullgraph(
            env, g1, cfg1, n, eval_every=1)}
    out = {}
    for label, run in runs.items():
        run(5)
        prof = profile_device(dev, lambda: run(steps))
        if not prof or not prof["device_ms"]:
            print(f"trace {label}: device time not measured", flush=True)
            continue
        busy = prof["device_ms"] / prof["wall_ms"]
        print(f"trace {label}: wall {prof['wall_ms']:.2f} ms over {steps} "
              f"steps ({prof['wall_ms'] / steps:.3f} ms/step, traced), "
              f"device time {prof['device_ms']:.2f} ms (busy {busy:.4f}, "
              f"idle {1 - busy:.4f}), aggregation kernels "
              f"{prof['agg_ms']:.3f} ms; largest kernels (name, ms, calls):"
              f" {prof['top']}", flush=True)
        out[label] = dict(prof, steps=steps, busy=busy)
    return out


def figure_phase(dev, sz: Sizes, graph) -> dict:
    """Phase 10: 10a the CLI, 10b the full-width sweep, 10c every figure,
    10d the kernel path against the plain path; then the kernels at the
    figures' shapes and two traced figure runs."""
    secs = {}
    out = {}
    with bench_sizes(sz):
        for key, fn, args in (("10a cli", cli_phase, (dev,)),
                              ("10b sweep", sweep_phase, (dev, sz, graph)),
                              ("10c figures", figures_phase, (dev, sz))):
            t0 = time.perf_counter()
            out[key] = fn(*args)
            secs[key] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["10d path"] = path_phase(dev, out["10c figures"])
        secs["10d path"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["shapes"] = figure_shapes(dev, sz)
        secs["10 shapes"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["traces"] = figure_traces(dev)
        secs["10 traces"] = time.perf_counter() - t0
    out["seconds"] = secs
    return out


# ---------------------------------------------------------------------------
# phase 11: the cluster and importance sources, fault tolerance, journal
# ---------------------------------------------------------------------------

FT_OUT = "experiments/bench_torch/chip_smoke_ckpt"
#: the sweep columns that read the wall clock
WALL = ("wall_time_s", "throughput_nodes_s", "time_to_acc_s")


def papers_cfg(graph, sz: Sizes):
    return dataclasses.replace(get_config("gnn-papers100m"), n_nodes=graph.n,
                               feat_dim=128, n_classes=172,
                               batch_size=sz.mb_b)


def counted_run(dev, trainer, **kw):
    """``trainer.run(**kw)`` between a launch-count reset and its read:
    (result, launch counts, wall seconds)."""
    ops.reset_launches()
    sync(dev)
    t0 = time.perf_counter()
    res = trainer.run(**kw)
    sync(dev)
    return res, ops.launch_counts(), time.perf_counter() - t0


def steady_ms(hist) -> float:
    t = hist.times
    return 1e3 * (t[-1] - t[0]) / max(len(t) - 1, 1)


def expect_crash(fn, what: str) -> None:
    """``fn()`` must end in the armed failpoint's ``SimulatedCrash``."""
    try:
        fn()
    except faults.SimulatedCrash:
        return
    check(False, f"{what}: the armed failpoint did not fire")


def same_run(got, want, what: str) -> None:
    """History, final parameters and test accuracy bit-equal."""
    hg, hw = got.history, want.history
    for f in ("losses", "val_accs", "val_acc_iters", "full_losses",
              "full_loss_iters", "nodes_processed", "bad_steps"):
        check(getattr(hg, f) == getattr(hw, f),
              f"{what}: History.{f} {getattr(hg, f)} != {getattr(hw, f)}")
    for p, q in zip(got.params, want.params):
        for k in p:
            check(torch.equal(p[k], q[k]), f"{what}: parameter {k} differs "
                  f"(max {float((p[k] - q[k]).detach().abs().max())})")
    check(got.final_test_acc == want.final_test_acc,
          f"{what}: test accuracy {got.final_test_acc} != "
          f"{want.final_test_acc}")


def grads_vs_plain(src, cfg, params, batch, tol, label) -> float:
    """One step's parameter gradients with the kernels against the plain
    path on the same batch: the relative max error, held to ``tol``."""
    leaves = [v for p in params for v in p.values()]
    grads = {}
    for kernel in (True, False):
        src.cfg = dataclasses.replace(cfg, use_agg_kernel=kernel)
        grads[kernel] = torch.autograd.grad(src.loss(params, batch), leaves)
    src.cfg = cfg
    err = max(rel_err(a, b) for a, b in zip(grads[True], grads[False]))
    print(f"{label}: one step's parameter gradients with the kernels vs "
          f"the plain path: relative max error {err:.3g} (limit {tol})",
          flush=True)
    check(err <= tol, f"{label}: gradient rel err {err} beyond {tol}")
    return err


def planned_tiled(steps_routes, evals, eval_routes) -> dict:
    """The tiled launches by route a run should make: each step's
    forwards on ``steps_routes`` and ``evals`` full-graph forwards on
    ``eval_routes``."""
    want = {f"tiled_{r}": 0 for r in ops.TILED_ROUTES}
    for routes, n in ((steps_routes, 1), (eval_routes, evals)):
        for r, count in routes.items():
            want[f"tiled_{r}"] += count * n
    return want


def cluster_shapes(dev, sz: Sizes, idx, w) -> dict:
    """The kernels at the cluster batch's shapes (bf16, the batch ELL's
    ids and GraphSAGE mask weights): the tiled forward at D = 128 and 172
    on both routes (checked and timed as in phase 2) and the
    reverse-index backward at D = 172 (layer 2's narrowed table), each
    against its plain version row by row in f32, timed beside it, the
    bound and ``embedding_bag``."""
    gen = torch.Generator(device=dev).manual_seed(11)
    bf = torch.bfloat16
    m, k = idx.shape
    mask = (w > 0).to(bf)
    out = {"forward": {}, "backward_csr": {}}
    for d in (128, 172):
        feats = torch.randn(m, d, generator=gen, device=dev).to(bf)
        case = (feats, idx, mask)
        label = f"cluster_batch_m{m}_k{k}_d{d}"
        ref32 = neighbor_agg_ref(*as_f32(case))
        err = compare(label, bf, tiled(case), ref32)
        rows = check_routes(label, case, ref32)
        routes = time_routes(case, dev, sz.iters)
        p_ms = time_ms(lambda: neighbor_agg_ref(*case), dev, sz.iters)
        lib = library_ms(lambda: torch.nn.functional.embedding_bag(
            idx, feats, mode="sum", per_sample_weights=mask), dev, sz.iters)
        b_ms, b_by, nbytes = bound(feats, idx, None)
        out["forward"][label] = dict(
            max_abs_err=err, ms=routes[routes["planned"]]["ms"],
            plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
            row_rel_err=rows[routes["planned"]], row_rel_err_by_route=rows,
            row_check_limit=FWD_ROW_TOL[bf], routes=routes,
            shape=f"bf16, the cluster batch ELL N=B={m} K={k} D={d}")
        print(f"11a {label}: routes: {routes_line(routes, rows)}; "
              f"max_err={err:.3g} plain_ms={p_ms:.4f} library_ms={fmt(lib)} "
              f"(embedding_bag) bound_ms={b_ms:.4f} (bound by {b_by}: "
              f"{nbytes} B)", flush=True)
    d = 172
    tab = torch.zeros(m, d, device=dev, dtype=bf)
    g = torch.randn(m, d, generator=gen, device=dev).to(bf)
    rev = ops.build_reverse_index(idx, mask, m)
    got = csr_dfeats(tab, idx, mask, g, rev)
    check(torch.equal(got, csr_dfeats(tab, idx, mask, g, rev)),
          "cluster batch: two calls of the reverse-index kernel differ")
    row = row_rel_err(got, neighbor_agg_backward_csr_ref(rev, mask.float(),
                                                         g.float()))
    check(row <= CSR_BF16_ROW_TOL, f"cluster batch: reverse-index row "
          f"error {row} beyond {CSR_BF16_ROW_TOL}")
    err = compare("cluster batch reverse-index backward", bf, got,
                  neighbor_agg_backward_ref(tab, idx, mask, g,
                                            need=DFEATS)[0], GTOL[bf])
    k_ms = time_ms(lambda: csr_dfeats(tab, idx, mask, g, rev), dev,
                   sz.iters)
    p_ms = time_ms(lambda: neighbor_agg_backward_csr_ref(rev, mask, g), dev,
                   sz.iters)
    fe = tab.clone().requires_grad_()
    eb = torch.nn.functional.embedding_bag(idx, fe, mode="sum",
                                           per_sample_weights=mask)
    lib = library_ms(lambda: torch.autograd.grad(eb, fe, g,
                                                 retain_graph=True),
                     dev, sz.iters)
    b_ms, b_by, nbytes = bound_bwd_csr(rev, d, 2)
    label = f"cluster_batch_m{m}_k{k}_d{d}"
    out["backward_csr"][label] = dict(
        max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib, row_rel_err=row, index_nnz=rev.nnz)
    print(f"11a {label}: reverse-index backward ({rev.nnz} kept edges) "
          f"max_err={err:.3g} row error {row:.4g}, bit-equal repeat; "
          f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={fmt(lib)} "
          f"(embedding_bag backward) bound_ms={b_ms:.4f} (bound by {b_by}: "
          f"{nbytes} B)", flush=True)
    return out


def cluster_phase(dev, sz: Sizes, graph) -> dict:
    """11a: Cluster-GCN at gnn-papers100m's widths on the shared graph."""
    cfg = papers_cfg(graph, sz)
    widths = (cfg.feat_dim, cfg.n_classes)
    plan = E.TrainPlan(lr=TRAIN_LR, n_iters=sz.cl_steps,
                       eval_every=sz.cl_steps, seed=0)
    src = E.ClusterSource(batch_size=sz.mb_b)
    tr = E.Trainer(graph, cfg, plan, source=src, device=dev)
    m, kk = src.m_max, src.K
    bf = torch.bfloat16
    routes = [ops.tiled_plan(m, m, kk, d, bf).route for d in widths]
    eval_routes = [ops.tiled_plan(graph.n, graph.n, graph.d_max, d,
                                  bf).route for d in widths]
    print(f"11a cluster: partition of n={graph.n} into {src.n_parts_} parts "
          f"in {src.bind_s['partition']:.3f} s (host, Python BFS), blocks "
          f"in {src.bind_s['blocks']:.3f} s; k={src.k} clusters a batch, "
          f"batch ELL m_max={m} K={kk}; tiled routes at the batch shape "
          f"{routes} (D {widths}), at the evaluations' full-graph shape "
          f"{eval_routes}", flush=True)

    # ---- the main path, between the launch-count reset and its read
    res, counts, wall = counted_run(dev, tr)
    # ---- end of the main path
    losses = res.history.losses
    steps = len(losses)
    # evaluations: the validation at iteration 0 and the final test
    want = planned_tiled({r: routes.count(r) * steps for r in set(routes)},
                         2, {r: eval_routes.count(r)
                             for r in set(eval_routes)})
    print(f"11a cluster: {steps} steps at b={sz.mb_b}: losses "
          f"{[round(x, 5) for x in losses]}, {steady_ms(res.history):.2f} "
          f"ms/step steady, run {wall:.3f} s ({1e3 * wall / steps:.2f} "
          f"ms/step with the evaluations), launches {counts} (expected "
          f"tiled {want}, backward_csr {steps}, backward 0), "
          f"test_acc={res.final_test_acc:.4f}", flush=True)
    tm = src.timing
    nb = max(tm["batches"], 1)
    print(f"11a cluster per batch: choice {1e3 * tm['sample_s'] / nb:.3f} ms "
          f"+ assembly into pinned buffers {1e3 * tm['stage_s'] / nb:.2f} ms "
          f"on the prefetch thread; loop waited {1e3 * tm['wait_s'] / nb:.2f}"
          f" ms; H2D {tm['h2d_ms'] / nb:.3f} ms", flush=True)
    check(all(np.isfinite(losses)), f"cluster losses not finite: {losses}")
    check_launch(dev, counts["backward_csr"] == steps
                 and counts["backward"] == 0
                 and {k: counts[k] for k in want} == want,
                 f"cluster steps launched {counts}: not the reverse-index "
                 f"backward once a step, no atomic backward and the tiled "
                 f"routes {want}")
    again = E.Trainer(graph, cfg, plan, source=E.ClusterSource(
        batch_size=sz.mb_b), device=dev).run()
    check(again.history.losses == losses,
          "cluster: two runs from one seed gave different losses")
    print("11a cluster: a second run from the seed: losses bit-equal",
          flush=True)

    # ---- one batch: gradients, index build, device step, kernel shapes
    one = E.ClusterSource(batch_size=sz.mb_b).bind(graph, cfg, plan, dev)
    batch, _ = next(one.batches())
    params = [{k: v.detach().clone().requires_grad_() for k, v in p.items()}
              for p in res.params]
    err = grads_vs_plain(one, cfg, params, batch, 2e-2,
                         "11a cluster (bf16 aggregation)")
    idx, w = batch[0], batch[1]
    index_ms = time_ms(lambda: ops.build_reverse_index(idx, w, m), dev,
                       sz.iters)
    opt_state = tr.opt.init(params)
    step_ms = time_ms(lambda: tr._step(params, opt_state, batch), dev, 5, 1)
    print(f"11a cluster: reverse index of the batch built in "
          f"{index_ms:.4f} ms (CUDA events, per batch); device step "
          f"(forward + backward + update, index build included) "
          f"{step_ms:.3f} ms", flush=True)
    shapes = cluster_shapes(dev, sz, idx, w)
    one.done(batch)
    one.close()
    tr.close()
    return {"counts": counts, "steps": steps, "ms_step": steady_ms(
        res.history), "wall_s": wall, "device_step_ms": step_ms,
        "index_ms": index_ms, "grad_err": err, "m_max": m, "K": kk,
        "n_parts": src.n_parts_, "bind_s": src.bind_s, "routes": routes,
        "shapes": shapes}


def importance_phase(dev, sz: Sizes, graph) -> dict:
    """11b: importance-sampled mini-batches (degree scores) at
    gnn-papers100m's widths, b and fan-out on the shared graph."""
    cfg = papers_cfg(graph, sz)
    widths = (cfg.feat_dim, cfg.n_classes)
    plan = E.TrainPlan(lr=TRAIN_LR, n_iters=sz.im_steps,
                       eval_every=sz.im_steps, seed=0)
    src = E.ImportanceSampledSource(batch_size=sz.mb_b,
                                    fanouts=sz.mb_fanout)
    tr = E.Trainer(graph, cfg, plan, source=src, device=dev)

    # ---- the main path, between the launch-count reset and its read
    res, counts, wall = counted_run(dev, tr)
    # ---- end of the main path
    losses = res.history.losses
    steps = len(losses)
    levels = minibatch_levels(sz, (cfg.feat_dim, cfg.hidden))
    lv_routes = [ops.tiled_plan(b * k, b, k, d, torch.float32).route
                 for _, b, k, d in levels]
    eval_routes = [ops.tiled_plan(graph.n, graph.n, graph.d_max, d,
                                  torch.bfloat16).route for d in widths]
    want = planned_tiled({r: lv_routes.count(r) * steps
                          for r in set(lv_routes)},
                         2, {r: eval_routes.count(r)
                             for r in set(eval_routes)})
    tm = src.timing
    nb = max(tm["batches"], 1)
    print(f"11b importance: {steps} steps at b={sz.mb_b} fan-out "
          f"{sz.mb_fanout}, degree scores: first/last loss {losses[0]:.5f} / "
          f"{losses[-1]:.5f}, {steady_ms(res.history):.2f} ms/step steady, "
          f"run {wall:.3f} s, launches {counts} (expected tiled {want}), "
          f"test_acc={res.final_test_acc:.4f}", flush=True)
    print(f"11b importance per batch: host sampling "
          f"{1e3 * tm['sample_s'] / nb:.2f} ms + staging "
          f"{1e3 * tm['stage_s'] / nb:.2f} ms on the prefetch thread; loop "
          f"waited {1e3 * tm['wait_s'] / nb:.2f} ms; H2D "
          f"{tm['h2d_ms'] / nb:.3f} ms", flush=True)
    check(all(np.isfinite(losses)), f"importance losses not finite: {losses}")
    check_launch(dev, counts["backward_identity"] == len(losses)
                 and counts["backward"] == 0 and counts["backward_csr"] == 0
                 and {k: counts[k] for k in want} == want,
                 f"importance steps launched {counts}: not the identity "
                 f"backward once a step alone and the tiled routes {want}")
    again = E.Trainer(graph, cfg, dataclasses.replace(
        plan, n_iters=sz.repeat_steps), source=E.ImportanceSampledSource(
            batch_size=sz.mb_b, fanouts=sz.mb_fanout), device=dev).run()
    check(again.history.losses == losses[:sz.repeat_steps],
          "importance: two runs from one seed gave different losses")
    print(f"11b importance: a second run from the seed, {sz.repeat_steps} "
          f"steps: losses bit-equal to the first run's", flush=True)

    # ---- the grad-scores bind: one full-graph forward through the kernel
    ops.reset_launches()
    sync(dev)
    t0 = time.perf_counter()
    gsrc = E.ImportanceSampledSource(batch_size=sz.mb_b, fanouts=sz.mb_fanout,
                                     scores="grad").bind(graph, cfg, plan,
                                                         dev)
    sync(dev)
    grad_s = time.perf_counter() - t0
    gcounts = ops.launch_counts()
    gsrc.close()
    print(f"11b importance: grad-scores bind {grad_s:.3f} s, launches "
          f"{gcounts}; p in [{gsrc._p.min():.3g}, {gsrc._p.max():.3g}]",
          flush=True)
    check(np.all(np.isfinite(gsrc._p)) and np.all(gsrc._p > 0),
          "grad scores not finite and positive")
    check_launch(dev, gcounts["tiled"] == len(widths),
                 f"grad-scores bind launched {gcounts}, not one full-graph "
                 f"forward's {len(widths)} tiled forwards")

    # ---- one batch: gradients, the weighted mean by hand
    one = E.ImportanceSampledSource(batch_size=sz.mb_b, fanouts=sz.mb_fanout,
                                    prefetch=False).bind(graph, cfg, plan,
                                                         dev)
    batch, _ = next(one.batches())
    params = [{k: v.detach().clone().requires_grad_() for k, v in p.items()}
              for p in res.params]
    err = grads_vs_plain(one, cfg, params, batch, 1e-4,
                         "11b importance (f32)")
    feats, masks, weights, self_w, labels, valid, row_w = batch
    with torch.no_grad():
        loss = float(one.loss(params, batch))
        z = G.minibatch_forward(params, cfg, feats, masks, weights,
                                self_w).double().cpu().numpy()
    lab = labels.long().cpu().numpy()
    zmax = z.max(-1, keepdims=True)
    rows = (np.log(np.exp(z - zmax).sum(-1)) + zmax[:, 0]
            - z[np.arange(len(lab)), lab])
    hand = float((row_w.double().cpu().numpy() * rows).sum() / sz.mb_b)
    mean_err = abs(loss - hand) / abs(hand)
    print(f"11b importance: weighted batch mean {loss:.7f}, by hand "
          f"(float64, Σ w_j ℓ_j / b) {hand:.7f}: relative error "
          f"{mean_err:.3g} (limit 1e-5)", flush=True)
    check(mean_err <= 1e-5, f"weighted mean {loss} != hand sum {hand}")
    one.done(batch)
    one.close()
    tr.close()
    return {"counts": counts, "steps": steps,
            "ms_step": steady_ms(res.history), "wall_s": wall,
            "grad_err": err, "grad_bind_s": grad_s, "timing": {
                k: v for k, v in tm.items() if k != "stage_each_s"}}


def resume_case(dev, sz: Sizes, graph, cfg, make, root: str, label: str):
    """A run with ``ckpt_every=2`` killed by an armed failpoint in the
    middle of its second save, resumed from the directory: bit-equal to
    the run that was not stopped."""
    plan = E.TrainPlan(lr=TRAIN_LR, n_iters=sz.ft_steps, eval_every=2,
                       seed=0, ckpt_every=2,
                       ckpt_dir=os.path.join(root, label, "golden"))
    golden = E.Trainer(graph, cfg, plan, source=make(), device=dev).run()
    crash = dataclasses.replace(plan, ckpt_dir=os.path.join(root, label,
                                                            "crash"))
    with faults.armed("ckpt.before_npz_rename", at_hits=(1,)):
        expect_crash(lambda: E.Trainer(graph, cfg, crash, source=make(),
                                       device=dev).run(),
                     f"{label} at the step-4 save")
    step = latest_step(crash.ckpt_dir)
    check(step == 2, f"{label}: newest checkpoint {step} after the crash")
    t0 = time.perf_counter()
    res = E.Trainer(graph, cfg, crash, source=make(), device=dev).run(
        resume_from=crash.ckpt_dir)
    resume_s = time.perf_counter() - t0
    same_run(res, golden, f"11c {label} resume")
    print(f"11c {label}: {sz.ft_steps} steps, ckpt_every 2, killed in the "
          f"step-4 save, resumed from step {step} in {resume_s:.3f} s: "
          f"History, parameters and test accuracy bit-equal to the run "
          f"that was not stopped (losses {res.history.losses})", flush=True)
    return {"losses": res.history.losses, "resume_s": resume_s}


def fault_phase(dev, sz: Sizes, graph, root: str) -> dict:
    """11c: exact resume after a kill mid-save (full-graph, cluster) and
    a rollback under a poisoned mini-batch, at full width."""
    cfg = papers_cfg(graph, sz)
    out = {
        "fullgraph": resume_case(dev, sz, graph, cfg, lambda: E.FullGraphSource(
            max_deg=cfg.max_degree), root, "fullgraph"),
        "cluster": resume_case(dev, sz, graph, cfg, lambda: E.ClusterSource(
            batch_size=sz.mb_b), root, "cluster")}
    plan = E.TrainPlan(lr=TRAIN_LR, n_iters=sz.ft_steps, eval_every=100,
                       seed=0, ckpt_every=2,
                       ckpt_dir=os.path.join(root, "rollback"),
                       bad_steps=E.BadStepPolicy(on_bad="rollback",
                                                 max_consecutive=1))
    bad = 3
    src = faults.poison_batches(E.SampledSource(batch_size=sz.mb_b,
                                                fanouts=sz.mb_fanout), [bad])
    tr = E.Trainer(graph, cfg, plan, source=src, device=dev)
    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        res = tr.run()
    tr.close()
    losses = res.history.losses
    said = [str(w.message) for w in ws if "rolling back" in str(w.message)]
    print(f"11c mini-batch: NaN batch at step {bad} under on_bad=rollback: "
          f"bad steps {res.history.bad_steps}, rollbacks {tr._n_rollbacks} "
          f"({said}), losses {losses}", flush=True)
    check(tr._n_rollbacks == 1 and len(said) == 1
          and res.history.bad_steps == [bad + 1],
          f"rollback: {tr._n_rollbacks} rollbacks, bad steps "
          f"{res.history.bad_steps}")
    check(len(losses) == sz.ft_steps and np.isnan(losses[bad])
          and all(np.isfinite(x) for i, x in enumerate(losses) if i != bad),
          f"rollback run losses {losses}")
    check(all(bool(torch.isfinite(v).all()) for p in res.params
              for v in p.values()), "rollback run: parameters not finite")
    out["rollback"] = {"losses": losses, "rollbacks": tr._n_rollbacks}
    return out


def journal_phase(dev, sz: Sizes, graph, root: str) -> dict:
    """11d: a 3-point sweep (the full-graph corner, cluster and importance
    at b and fan-out of gnn-papers100m) with a journal, killed after its
    first point, rerun: the first point is skipped and the rows equal an
    uninterrupted sweep's but for the wall-clock columns."""
    cfg = papers_cfg(graph, sz)
    plan = E.TrainPlan(lr=TRAIN_LR, n_iters=sz.jr_steps,
                       eval_every=sz.jr_steps)
    kw = dict(batch_sizes=[sz.mb_b], fanout_grid=[sz.mb_fanout],
              include_fullgraph=True, sources=["cluster", "importance"],
              device=dev)
    journal = os.path.join(root, "sweep.jsonl")
    t0 = time.perf_counter()
    with faults.armed("sweep.after_point", at_hits=(0,)):
        expect_crash(lambda: X.sweep(graph, cfg, plan, journal=journal, **kw),
                     "the sweep after point 1")
    with open(journal) as f:
        first = [json.loads(x) for x in f]
    check([x["status"] for x in first] == ["ok"],
          f"journal after the kill: {first}")
    rows = X.sweep(graph, cfg, plan, journal=journal, **kw)
    resumed_s = time.perf_counter() - t0
    with open(journal) as f:
        lines = [json.loads(x) for x in f]
    t0 = time.perf_counter()
    straight = X.sweep(graph, cfg, plan, **kw)
    straight_s = time.perf_counter() - t0

    def no_wall(rs):
        return [{k: v for k, v in r.items() if k not in WALL} for r in rs]

    print(f"11d journal: 3-point sweep killed after point 1, rerun: "
          f"{len(lines)} journal lines, point 1 from the journal; "
          f"{resumed_s:.2f} s killed + rerun, {straight_s:.2f} s "
          f"uninterrupted; rows {no_wall(rows)}", flush=True)
    check(len(lines) == len(rows) == len(straight) == 3
          and all(x["status"] == "ok" for x in lines)
          and rows[0] == first[0]["row"],
          f"journal rerun: {len(lines)} lines, {len(rows)} rows")
    check(no_wall(rows) == no_wall(straight),
          "journal rerun rows differ from the uninterrupted sweep's")
    return {"rows": len(rows), "resumed_s": resumed_s,
            "straight_s": straight_s}


def sources_phase(dev, sz: Sizes, graph) -> dict:
    """Phase 11: 11a cluster, 11b importance, 11c fault tolerance, 11d the
    sweep journal, on the shared graph at gnn-papers100m's widths."""
    secs = {}
    out = {}
    os.makedirs(FT_OUT, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=FT_OUT) as root:
        for key, fn, args in (
                ("11a cluster", cluster_phase, (dev, sz, graph)),
                ("11b importance", importance_phase, (dev, sz, graph)),
                ("11c faults", fault_phase, (dev, sz, graph, root)),
                ("11d journal", journal_phase, (dev, sz, graph, root))):
            t0 = time.perf_counter()
            out[key] = fn(*args)
            secs[key] = time.perf_counter() - t0
    E.drop_device_cache(graph)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["seconds"] = secs
    return out


# ---------------------------------------------------------------------------
# phase 12: the NODES-sharded paradigms, S shards on one card
# ---------------------------------------------------------------------------

def shard_mesh(dev, shards: int):
    """``shards`` NODES shards, all on ``dev`` (the single-controller mesh
    of one card)."""
    return SH.node_mesh(devices=(dev,) * shards)


def sharded_counts() -> dict:
    """The kernel wrapper's launch counts and the featshard phases'."""
    return dict(ops.launch_counts(), **{
        f"featshard_{k}": v for k, v in FS.launch_counts().items()})


def sharded_run(dev, graph, cfg, plan, source):
    """One Trainer run between a launch-count reset and its read (the
    kernel wrapper's and featshard's counters): (result, counts, wall
    seconds, the bound source)."""
    tr = E.Trainer(graph, cfg, plan, source=source, device=dev)
    ops.reset_launches()
    FS.reset_launches()
    sync(dev)
    t0 = time.perf_counter()
    try:
        res = tr.run()
        sync(dev)
    finally:
        tr.close()
    return res, sharded_counts(), time.perf_counter() - t0, source


def kernel_counts(c: dict) -> dict:
    return {k: c[k] for k in ("tiled", "backward", "backward_csr", "row",
                              "backward_identity")}


def times_shards(got: dict, want: dict, s: int) -> bool:
    """Every kernel launched exactly ``s`` times as often as in ``want``
    (one launch per shard per call)."""
    return all(got[k] == s * want[k] for k in kernel_counts(want))


def falling(losses) -> bool:
    return all(np.isfinite(losses)) and losses[-1] < losses[0]


def sharded_grads(loss_a, loss_b, params, tol, label) -> float:
    """One step's parameter gradients of two loss closures on the same
    parameters: the relative max error, held to ``tol``."""
    leaves = [v for p in params for v in p.values()]
    ga = torch.autograd.grad(loss_a(params), leaves)
    gb = torch.autograd.grad(loss_b(params), leaves)
    err = max(rel_err(a, b) for a, b in zip(ga, gb))
    print(f"{label}: one step's parameter gradients against the unsharded "
          f"kernel path: relative max error {err:.3g} (limit {tol})",
          flush=True)
    check(err <= tol, f"{label}: gradient rel err {err} beyond {tol}")
    return err


def run_record(res) -> dict:
    """What phase 18 holds a run to: History's losses and evaluations,
    the test accuracy and the final parameters on the host."""
    h = res.history
    return {"losses": list(h.losses), "val_accs": list(h.val_accs),
            "test_acc": res.final_test_acc,
            "params": [{k: v.detach().float().cpu().numpy()
                        for k, v in p.items()} for p in res.params]}


def peak_reset(dev) -> int:
    """Reset the card's peak-memory counter; the bytes allocated now (0
    on the CPU)."""
    if dev.type != "cuda":
        return 0
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def fresh_params(res):
    return [{k: v.detach().clone().requires_grad_() for k, v in p.items()}
            for p in res.params]


@functools.lru_cache(maxsize=None)
def card_tag() -> str:
    """The card's name and power limit for the lines that carry a time
    (the CPU rehearsal has no card)."""
    return card_line() if torch.cuda.is_available() else "the CPU"


def shard_label(s: int) -> str:
    return f"{s} shard{'s' if s > 1 else ''} on one card: {card_tag()}"


def sharded_s1(dev, sz: Sizes, graph) -> dict:
    """12a: one shard on the card is the unsharded path, bit for bit:
    fullgraph_sharded (both layouts) and minibatch_sharded against
    FullGraphSource and SampledSource, losses and launches."""
    cfg = papers_cfg(graph, sz)
    fs_cfg = dataclasses.replace(cfg, feats_layout="sharded")
    mesh = shard_mesh(dev, 1)
    fplan = E.TrainPlan(lr=TRAIN_LR, n_iters=sz.sh_fg_steps,
                        eval_every=sz.sh_fg_steps, seed=0)
    mplan = E.TrainPlan(lr=TRAIN_LR, n_iters=sz.sh_mb_steps,
                        eval_every=sz.sh_mb_steps, seed=0)
    out = {}
    k = cfg.max_degree
    base = sharded_run(dev, graph, cfg, fplan, E.FullGraphSource(max_deg=k))
    for key, c in (("fullgraph_sharded", cfg), ("featshard", fs_cfg)):
        src = E.ShardedFullGraphSource(max_deg=k, mesh=mesh)
        res, counts, wall, src = sharded_run(dev, graph, c, fplan, src)
        same_run(res, base[0], f"12a {key} S=1 vs fullgraph")
        want = kernel_counts(base[1])
        if key == "fullgraph_sharded":
            # the same kernels on the same shapes: the same routes too
            check_launch(dev, counts == base[1], f"12a {key}: launches "
                         f"{counts} != the unsharded run's {base[1]}")
        else:
            # phase 1's table is concat(hot, local): the plan may route
            # it otherwise (the routes are bit-equal); no miss, no phase 2
            check_launch(dev, kernel_counts(counts) == want
                         and counts["featshard_phase2"] == 0,
                         f"12a {key}: launches {counts}, want {want} and "
                         f"no phase 2")
        out[key] = dict(counts=counts, wall_s=wall, ms_step=steady_ms(
            res.history), stats=src.featshard_stats, bind_s=src.bind_s,
            run=run_record(res))
        print(f"12a {key} S=1: {len(res.history.losses)} steps, losses "
              f"bit-equal to FullGraphSource "
              f"{[round(x, 6) for x in res.history.losses]}, launches "
              f"{counts} (unsharded {base[1]}), {out[key]['ms_step']:.2f} "
              f"ms/step ({shard_label(1)})", flush=True)
    mb = sharded_run(dev, graph, cfg, mplan,
                     E.SampledSource(batch_size=sz.mb_b))
    res, counts, wall, _ = sharded_run(
        dev, graph, cfg, mplan,
        E.ShardedSampledSource(batch_size=sz.mb_b, mesh=mesh))
    same_run(res, mb[0], "12a minibatch_sharded S=1 vs minibatch")
    check_launch(dev, counts == mb[1], f"12a minibatch_sharded: launches "
                 f"{counts} != the unsharded run's {mb[1]}")
    print(f"12a minibatch_sharded S=1: {len(res.history.losses)} steps "
          f"bit-equal to SampledSource, launches {counts}, "
          f"{steady_ms(res.history):.2f} ms/step ({shard_label(1)})",
          flush=True)
    out["minibatch_sharded"] = dict(counts=counts, wall_s=wall,
                                    ms_step=steady_ms(res.history),
                                    run=run_record(res))
    out["fullgraph"] = dict(counts=base[1], ms_step=steady_ms(
        base[0].history), params=fresh_params(base[0]))
    out["minibatch"] = dict(counts=mb[1], ms_step=steady_ms(mb[0].history))
    return out


def sharded_s4(dev, sz: Sizes, graph, s1: dict) -> dict:
    """12b: S shards on the card: fullgraph_sharded, the featshard layout
    and minibatch_sharded run, hold their gradients to the unsharded
    kernel path's, launch once per shard per call and repeat bit for
    bit from a seed."""
    s = sz.sh_shards
    cfg = papers_cfg(graph, sz)
    fs_cfg = dataclasses.replace(cfg, feats_layout="sharded")
    mesh = shard_mesh(dev, s)
    fplan = E.TrainPlan(lr=TRAIN_LR, n_iters=sz.sh_fg_steps,
                        eval_every=sz.sh_fg_steps, seed=0)
    mplan = E.TrainPlan(lr=TRAIN_LR, n_iters=sz.sh_mb_steps,
                        eval_every=sz.sh_mb_steps, seed=0)
    params = s1["fullgraph"]["params"]
    k = cfg.max_degree
    plain_src = E.FullGraphSource(max_deg=k).bind(graph, cfg, fplan, dev)
    want = s1["fullgraph"]["counts"]
    out = {}
    for key, c in (("fullgraph_sharded", cfg), ("featshard", fs_cfg)):
        def source():
            return E.ShardedFullGraphSource(max_deg=k, mesh=mesh)
        base_bytes = peak_reset(dev)
        res, counts, wall, src = sharded_run(dev, graph, c, fplan, source())
        peak = (torch.cuda.max_memory_allocated(dev) - base_bytes
                if dev.type == "cuda" else 0)
        losses = res.history.losses
        check(falling(losses), f"12b {key}: losses {losses} not finite "
              f"and falling")
        if key == "fullgraph_sharded":
            check_launch(dev, times_shards(counts, want, s),
                         f"12b {key}: launches {counts}, not {s} x the "
                         f"unsharded run's {want}")
        else:
            # every aggregation: S phase-1 launches, and with misses S
            # phase-2 launches; their table gradients likewise
            phases = 2 if src.feats_plan.M else 1
            fs_want = {"featshard_phase1": s * want["tiled"],
                       "featshard_phase2": s * want["tiled"] * (phases - 1),
                       "tiled": phases * s * want["tiled"],
                       "backward_csr": phases * s * want["backward_csr"],
                       "backward": s * want["backward"]}
            check_launch(dev, counts["featshard_phase2"] > 0
                         and {q: counts[q] for q in fs_want} == fs_want,
                         f"12b featshard: launches {counts}, want {fs_want} "
                         f"(the miss path must run on the card)")
        again, _, _, _ = sharded_run(dev, graph, c, fplan, source())
        same_run(again, res, f"12b {key}: a second run from the seed")
        one = source().bind(graph, c, fplan, dev)
        err = sharded_grads(lambda p: one.loss(p, None),
                            lambda p: plain_src.loss(p, None), params,
                            2e-2, f"12b {key} S={s} (bf16 aggregation)")
        entry = dict(counts=counts, wall_s=wall, losses=losses,
                     ms_step=steady_ms(res.history), grad_err=err,
                     bind_s=src.bind_s, run=run_record(res),
                     peak_bytes=peak)
        if key == "featshard":
            entry.update(featshard_check(graph, c, src))
            entry["plan"] = src.feats_plan
        out[key] = entry
        print(f"12b {key} S={s}: {len(losses)} steps, losses "
              f"{[round(x, 6) for x in losses]}, a second seeded run "
              f"bit-equal; launches {counts}; {entry['ms_step']:.2f} "
              f"ms/step steady, run {wall:.3f} s (serial shards, "
              f"{shard_label(s)})", flush=True)
        one.close()
    plain_src.close()

    res, counts, wall, src = sharded_run(
        dev, graph, cfg, mplan,
        E.ShardedSampledSource(batch_size=sz.mb_b, mesh=mesh))
    losses = res.history.losses
    check(all(np.isfinite(losses)), f"12b minibatch_sharded: losses "
          f"{losses} not finite")
    check_launch(dev, times_shards(counts, s1["minibatch"]["counts"], s),
                 f"12b minibatch_sharded: launches {counts}, not {s} x the "
                 f"unsharded run's {s1['minibatch']['counts']}")
    one = E.ShardedSampledSource(batch_size=sz.mb_b, mesh=mesh).bind(
        graph, cfg, mplan, dev)
    batch, _ = next(one.batches())

    def mb_loss(mesh_):
        def loss(p):
            feats, masks, weights, self_w, labels, *rest = batch
            logits = G.minibatch_forward(p, cfg, feats, masks, weights,
                                         self_w, mesh=mesh_)
            return G.gnn_loss(logits, labels, cfg.loss, cfg.n_classes,
                              valid=rest[0] if rest else None)
        return loss
    err = sharded_grads(mb_loss(mesh), mb_loss(None), fresh_params(res),
                        1e-4, f"12b minibatch_sharded S={s} (f32 levels)")
    one.done(batch)
    one.close()
    out["minibatch_sharded"] = dict(counts=counts, wall_s=wall,
                                    losses=losses, grad_err=err,
                                    ms_step=steady_ms(res.history),
                                    run=run_record(res))
    print(f"12b minibatch_sharded S={s}: {len(losses)} steps at "
          f"b={src.b}, losses {[round(x, 5) for x in losses]}; launches "
          f"{counts}; {out['minibatch_sharded']['ms_step']:.2f} ms/step "
          f"steady (host-bound, serial shards, {shard_label(s)})",
          flush=True)
    return out


def featshard_check(graph, cfg, src) -> dict:
    """The featshard plan's accounting against the host arithmetic:
    (n_loc + C)·d·2 table bytes a shard, (S - 1)·(M + C_max) rows
    received a call: the plan's model of a multi-card layout.  Beside
    it, the gather-source bytes one call of the op holds here, read off
    its autograd context: shard 0's concat(hot, local) table, the serve
    buffer (one for the shards on one card) and the padded table every
    shard slices."""
    p = src.feats_plan
    st = src.featshard_stats
    d = graph.feats.shape[1]
    feats = torch.zeros(p.n_pad, d, device=src.device,
                        dtype=torch.bfloat16, requires_grad=True)
    w = E._sharded_ell(graph, cfg.max_degree, src.device, p.mesh)[1]
    y = FS.neighbor_agg_featshard(feats, w.to(torch.bfloat16), p)
    ctx = y.grad_fn
    held = {"table1_shard0": ctx.tables1[0].nbytes,
            "serve_buffer": ctx.served[0].nbytes if p.M else 0,
            "padded_table": feats.nbytes}
    del y, ctx
    want_c = max(1, graph.n // 8) if cfg.feat_cache_rows < 0 else \
        min(cfg.feat_cache_rows, graph.n)
    want = {"feat_table_bytes_per_device": (p.n_loc + want_c) * d * 2,
            "remote_rows_per_call": (p.S - 1) * (p.M + p.C_max),
            "feat_remote_gather_bytes": (p.S - 1) * (p.M + p.C_max) * d * 2,
            "feat_cache_rows": want_c, "feat_table_shards": p.S}
    for k, v in want.items():
        check(st[k] == v, f"featshard stats: {k} = {st[k]}, host "
              f"arithmetic {v}")
    print(f"12b featshard plan: S={p.S} n_loc={p.n_loc} C={p.C} "
          f"C_max={p.C_max} M={p.M}, built in "
          f"{src.bind_s['featshard_plan']:.3f} s (host plan + per-shard "
          f"reverse indexes); hit rate {st['feat_cache_hit_rate']:.4f} "
          f"(hot {st['feat_cache_hot_hits']}, local "
          f"{st['feat_cache_local_hits']}, misses "
          f"{st['feat_cache_misses']}); the plan's model of a multi-card "
          f"layout: {st['feat_table_bytes_per_device']} table bytes a "
          f"shard, {st['feat_remote_gather_bytes']} B received a call, "
          f"equal to the host arithmetic; held by one call here (serial "
          f"shards on one card): {held} B", flush=True)
    return {"stats": st, "M": p.M, "C": p.C, "C_max": p.C_max,
            "held_bytes": held}


def forward_shape(dev, sz: Sizes, case, label: str, shape: str,
                  tag: str) -> dict:
    """The tiled forward at one shape (checked against its plain version
    row by row on both routes, timed as in phase 2) beside its plain
    version, the bound and ``embedding_bag`` (unfused only: no single
    call fuses the epilogue)."""
    feats, idx, w, self_rows, _ = case
    dt = feats.dtype
    ref32 = neighbor_agg_ref(*as_f32(case))
    err = compare(label, dt, tiled(case), ref32)
    rows = check_routes(label, case, ref32)
    routes = time_routes(case, dev, sz.iters)
    p_ms = time_ms(lambda: neighbor_agg_ref(*case), dev, sz.iters)
    lib = None if self_rows is not None else library_ms(
        lambda: torch.nn.functional.embedding_bag(
            idx, feats, mode="sum", per_sample_weights=w), dev, sz.iters)
    b_ms, b_by, nbytes = bound(feats, idx, self_rows)
    print(f"{tag} {label}: routes: {routes_line(routes, rows)}; "
          f"max_err={err:.3g} plain_ms={p_ms:.4f} library_ms={fmt(lib)} "
          f"(embedding_bag) bound_ms={b_ms:.4f} (bound by {b_by}: "
          f"{nbytes} B)", flush=True)
    return dict(max_abs_err=err, ms=routes[routes["planned"]]["ms"],
                plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib, row_rel_err=rows[routes["planned"]],
                row_rel_err_by_route=rows, row_check_limit=FWD_ROW_TOL[dt],
                routes=routes, shape=shape)


def phase_shape(dev, sz: Sizes, phase: int, case, label: str,
                shape: str) -> dict:
    """One featshard phase's tiled launch at shard 0's shape: a bf16
    table whose sum comes out in f32 (the direct route, the one that has
    it), held against its plain version on the f32 values (1e-5, row by
    row) and against a second call of itself, timed beside its plain
    version, the bound and, unfused, ``embedding_bag`` on the bf16
    table."""
    feats, idx, w, self_rows, _ = case
    f32 = torch.float32

    def run():
        return FS._phase_forward(phase, *case)
    got = run()
    ref32 = neighbor_agg_ref(*as_f32(case))
    err = compare(label, f32, got, ref32)
    row = row_rel_err(got, ref32)
    check(row <= FWD_ROW_TOL[f32], f"{label}: row error {row} beyond "
          f"{FWD_ROW_TOL[f32]}")
    check(torch.equal(got, run()), f"{label}: two calls differ")
    k_ms = time_ms(run, dev, sz.iters)
    k_fl = time_ms(run, dev, sz.iters, 1, flush_buffer(dev))
    p_ms = time_ms(lambda: neighbor_agg_ref(*case, out_dtype=f32), dev,
                   sz.iters)
    lib = None if self_rows is not None else library_ms(
        lambda: torch.nn.functional.embedding_bag(
            idx, feats, mode="sum", per_sample_weights=w), dev, sz.iters)
    b_ms, b_by, nbytes = bound(feats, idx, self_rows, out_el=4)
    print(f"12b {label}: direct route {k_ms:.4f} ms ({k_fl:.4f} L2 "
          f"flushed), row error {row:.4g}, bit-equal repeat; "
          f"max_err={err:.3g} plain_ms={p_ms:.4f} library_ms={fmt(lib)} "
          f"(embedding_bag, bf16 out) bound_ms={b_ms:.4f} (bound by "
          f"{b_by}: {nbytes} B)", flush=True)
    return dict(max_abs_err=err, ms=k_ms, ms_l2_flushed=k_fl, plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                row_rel_err=row, row_check_limit=FWD_ROW_TOL[f32],
                shape=shape)


def shard_shapes(dev, sz: Sizes, graph, s4: dict) -> dict:
    """The kernels at the shapes one shard of 12b gives them (shard 0,
    bf16, the real ELL with GraphSAGE's mask weights): the tiled forward
    of fullgraph_sharded (N table rows, N/S ELL rows) at D = 128 and
    172, featshard's phase 1 (concat(hot, local)) and phase 2 (the
    [S·M, d] serve buffer, fused epilogue) at D = 128, the mini-batch
    levels at b/S; and the reverse-index backward of a shard at D = 172.
    Each against its plain version, timed beside the bound and
    ``embedding_bag``."""
    gen = torch.Generator(device=dev).manual_seed(12)
    bf = torch.bfloat16
    s = sz.sh_shards
    n = graph.n
    mesh = shard_mesh(dev, s)
    kk = papers_cfg(graph, sz).max_degree
    idx, w = [t[: n // s] for t in E._sharded_ell(graph, kk, dev, mesh)[:2]]
    mask = (w > 0).to(bf).contiguous()
    out = {"forward": {}, "fused": {}, "backward_csr": {}}
    for d in (128, 172):
        feats = torch.randn(n, d, generator=gen, device=dev).to(bf)
        label = f"fullgraph_shard_n{n}_b{n // s}_k{idx.shape[1]}_d{d}"
        out["forward"][label] = forward_shape(
            dev, sz, (feats, idx, mask, None, None), label,
            f"bf16, one of {s} shards: N={n} B={n // s} K={idx.shape[1]} "
            f"D={d}", "12b")
    p = s4["featshard"]["plan"]
    d = 128
    h = p.C + p.n_loc
    table1 = torch.randn(h, d, generator=gen, device=dev).to(bf)
    w1 = (mask * p.hot_mask[0].to(bf)) if p.M else mask
    label = f"featshard_phase1_n{h}_b{p.n_loc}_k{p.K}_d{d}"
    out["forward"][label] = phase_shape(
        dev, sz, 1, (table1, p.lidx_hot[0], w1.contiguous(), None, None),
        label, f"bf16 table, f32 sum: featshard phase 1 of shard 0, "
        f"concat(hot C={p.C}, local {p.n_loc}) K={p.K} D={d}")
    if p.M:
        served = torch.randn(s * p.M, d, generator=gen, device=dev).to(bf)
        w2 = (mask * (1 - p.hot_mask[0]).to(bf)).contiguous()
        part = torch.randn(p.n_loc, d, generator=gen, device=dev)
        ones = torch.ones(p.n_loc, device=dev)
        label = f"featshard_phase2_n{s * p.M}_b{p.n_loc}_k{p.K}_d{d}"
        out["fused"][label] = phase_shape(
            dev, sz, 2, (served, p.lidx_miss[0], w2, part, ones), label,
            f"bf16 table, f32 sum: featshard phase 2 of shard 0, the "
            f"[S·M={s * p.M}, {d}] serve buffer, fused epilogue (self_rows "
            f"= phase 1's f32 partial, w_self = 1)")
    for _, b, k, dd in minibatch_levels(sz, (128, 256)):
        bl = b // s
        tab = torch.randn(bl * k, dd, generator=gen, device=dev)
        ids = torch.arange(bl * k, dtype=torch.int32,
                           device=dev).reshape(bl, k)
        wk = (torch.rand(bl, k, generator=gen, device=dev) > 0.2).float()
        label = f"minibatch_shard_b{bl}_k{k}_d{dd}"
        out["forward"][label] = forward_shape(
            dev, sz, (tab, ids, wk, None, None), label,
            f"f32, one of {s} shards of a mini-batch level: identity ids "
            f"B={bl} K={k} D={dd}", "12b")
    d = 172
    rev = E._sharded_reverse_index(graph, kk, dev, mesh).revs[0]
    tab = torch.zeros(n, d, device=dev, dtype=bf)
    g = torch.randn(n // s, d, generator=gen, device=dev).to(bf)
    i0, m0 = rev.idx, mask
    got = csr_dfeats(tab, i0, m0, g, rev)
    check(torch.equal(got, csr_dfeats(tab, i0, m0, g, rev)),
          "shard 0: two calls of the reverse-index kernel differ")
    row = row_rel_err(got, neighbor_agg_backward_csr_ref(rev, m0.float(),
                                                         g.float()))
    check(row <= CSR_BF16_ROW_TOL, f"shard 0: reverse-index row error "
          f"{row} beyond {CSR_BF16_ROW_TOL}")
    err = compare("shard 0 reverse-index backward", bf, got,
                  neighbor_agg_backward_ref(tab, i0, m0, g,
                                            need=DFEATS)[0], GTOL[bf])
    k_ms = time_ms(lambda: csr_dfeats(tab, i0, m0, g, rev), dev, sz.iters)
    p_ms = time_ms(lambda: neighbor_agg_backward_csr_ref(rev, m0, g), dev,
                   sz.iters)
    fe = tab.clone().requires_grad_()
    eb = torch.nn.functional.embedding_bag(i0, fe, mode="sum",
                                           per_sample_weights=m0)
    lib = library_ms(lambda: torch.autograd.grad(eb, fe, g,
                                                 retain_graph=True),
                     dev, sz.iters)
    b_ms, b_by, nbytes = bound_bwd_csr(rev, d, 2)
    label = f"fullgraph_shard_n{n}_b{n // s}_d{d}"
    out["backward_csr"][label] = dict(
        max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib, row_rel_err=row, index_nnz=rev.nnz,
        shape=f"bf16, one of {s} shards: dfeats N={n} from B={n // s} "
              f"rows, D={d}")
    print(f"12b {label}: reverse-index backward of shard 0 ({rev.nnz} kept "
          f"edges) max_err={err:.3g} row error {row:.4g}, bit-equal "
          f"repeat; kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
          f"library_ms={fmt(lib)} (embedding_bag backward) "
          f"bound_ms={b_ms:.4f} (bound by {b_by}: {nbytes} B)", flush=True)
    return out


def sharded_store(dev, sz: Sizes, graph, s4: dict) -> dict:
    """12c: ``EmbeddingStore`` with the featshard layout on S shards
    against the replicated build (bf16, 2e-2), then queries."""
    s = sz.sh_shards
    cfg = papers_cfg(graph, sz)
    fs_cfg = dataclasses.replace(cfg, feats_layout="sharded")
    params = G.init_gnn(torch.Generator().manual_seed(0), cfg, 128,
                        device=dev)
    rep = EmbeddingStore(params, cfg, graph, chunk_size=sz.chunk,
                         max_deg=cfg.max_degree, device=dev)
    rep.build()
    t0 = time.perf_counter()
    store = EmbeddingStore(params, fs_cfg, graph, chunk_size=sz.chunk,
                           max_deg=cfg.max_degree, device=dev,
                           mesh=shard_mesh(dev, s))
    plan_s = time.perf_counter() - t0
    ops.reset_launches()
    FS.reset_launches()
    t0 = time.perf_counter()
    run = store.build()
    build_s = time.perf_counter() - t0
    counts = sharded_counts()
    check_launch(dev, counts["featshard_phase1"] > 0,
                 f"12c: the featshard build launched {counts}")
    errs = []
    for li, (a, b) in enumerate(zip(store.layers, rep.layers)):
        errs.append(compare(f"12c featshard layer {li + 1} vs replicated",
                            torch.bfloat16, a, b))
    rng = np.random.default_rng(3)
    queries = [rng.integers(0, graph.n, size=8)
               for _ in range(sz.sh_queries)]
    server = GNNServer(store, max_batch=32, max_wait_ms=1.0)
    try:
        answers = [server.submit(q, with_meta=True).result(timeout=120.0)
                   for q in queries]
    finally:
        server.close()
    st = server.stats()
    expect = np.argmax(store.snapshot().final_np, -1)
    check(all(np.array_equal(a.preds, expect[q])
              for a, q in zip(answers, queries)),
          "12c: a served answer differs from the snapshot's argmax")
    readings = limit_readings(params, cfg, graph, sz, dev, store, rep)
    print(f"12c featshard store S={s}: plan in {plan_s:.3f} s, build "
          f"{build_s:.3f} s (per layer {run.stats['per_layer_s']}), layers "
          f"vs the replicated build max_abs_err {errs} (limit 2e-2), "
          f"launches {counts}; {st['n_requests']} queries: p50_ms="
          f"{st['p50_ms']:.4f} p99_ms={st['p99_ms']:.4f} qps="
          f"{st['qps']:.1f} ({shard_label(s)})", flush=True)
    return dict(build_s=build_s, plan_s=plan_s, errs=errs, counts=counts,
                stats=st, readings=readings)


@contextlib.contextmanager
def phase1_rounded(fn):
    """The featshard op with its phase-1 partial passed through ``fn``
    before phase 2 adds to it: a control of 12c's limit, not a path of
    the port."""
    orig = FS._phase_forward

    def rounded(phase, *args):
        out = orig(phase, *args)
        return fn(out) if phase == 1 else out
    FS._phase_forward = rounded
    try:
        yield
    finally:
        FS._phase_forward = orig


def round_bits(x, bits: int):
    """f32 ``x`` rounded to ``bits`` significant bits (nearest, ties away
    from zero)."""
    drop = 24 - bits
    i = x.contiguous().view(torch.int32)
    return ((i + (1 << (drop - 1))) & ~((1 << drop) - 1)).view(torch.float32)


def limit_readings(params, cfg, graph, sz: Sizes, dev, store, rep) -> dict:
    """What 12c's 2e-2 limit sits between: the featshard build rebuilt
    with its phase-1 partial rounded to bf16 (the reference's arithmetic)
    and to 4 significant bits (a control in a lower precision, which the
    limit must refuse), each against the replicated build; and every
    build against a witness computed in f32 (the replicated build with
    f32 aggregation).  A reading is per layer: the max abs error and the
    largest |a - b| / (tol + tol·|b|) (at most 1 within the limit)."""
    tol = TOL[torch.bfloat16]

    def reading(a_layers, b_layers):
        return [dict(max_abs_err=float((a.float() - b.float()).abs().max()),
                     limit_ratio=float(((a.float() - b.float()).abs()
                                        / (tol + tol * b.float().abs()))
                                       .max()))
                for a, b in zip(a_layers, b_layers)]
    builds = {"port": [t.clone() for t in store.layers]}
    for name, fn in (("reference_arith",
                      lambda x: x.to(torch.bfloat16).float()),
                     ("control_4bit", lambda x: round_bits(x, 4))):
        with phase1_rounded(fn):
            store.build()
        builds[name] = [t.clone() for t in store.layers]
    f32 = EmbeddingStore(params, dataclasses.replace(cfg, dtype="float32"),
                         graph, chunk_size=sz.chunk, max_deg=cfg.max_degree,
                         device=dev)
    f32.build()
    out = {f"{k}_vs_replicated": reading(v, rep.layers)
           for k, v in builds.items()}
    out.update({f"{k}_vs_f32": reading(v, f32.layers)
                for k, v in builds.items()})
    out["replicated_vs_f32"] = reading(rep.layers, f32.layers)
    check(max(r["limit_ratio"] for r in out["control_4bit_vs_replicated"])
          > 1, f"12c: the 4-bit control stays within the 2e-2 limit "
          f"({out['control_4bit_vs_replicated']}): the limit cannot tell "
          f"a precision fault")
    for k, v in out.items():
        print(f"12c limit reading {k}: " + ", ".join(
            f"layer {i + 1} max_abs_err {r['max_abs_err']:.6g} limit_ratio "
            f"{r['limit_ratio']:.4g}" for i, r in enumerate(v)) +
            f" ({shard_label(sz.sh_shards)})", flush=True)
    return out


def sharded_phase(dev, sz: Sizes, graph) -> dict:
    """Phase 12: 12a one shard (bit-equal), 12b S shards (training, the
    kernels at the shard shapes), 12c the featshard store."""
    secs, out = {}, {}
    t0 = time.perf_counter()
    out["12a s1"] = sharded_s1(dev, sz, graph)
    secs["12a s1"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["12b s4"] = sharded_s4(dev, sz, graph, out["12a s1"])
    out["12b shapes"] = shard_shapes(dev, sz, graph, out["12b s4"])
    secs["12b s4"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["12c store"] = sharded_store(dev, sz, graph, out["12b s4"])
    secs["12c store"] = time.perf_counter() - t0
    out["12b s4"]["featshard"].pop("plan")
    out["12a s1"]["fullgraph"].pop("params")
    E.drop_device_cache(graph)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["seconds"] = secs
    return out


# ---------------------------------------------------------------------------
# phase 13: LM training and the dry-run against the card
# ---------------------------------------------------------------------------

DRYRUN_OUT = "experiments/dryrun_torch/chip_smoke"
# 13c: the dry-run's device_bytes_total against the measured peak
PEAK_RATIO = (0.8, 1.25)
# 13a: one step with 1 and with 2 micro-batches on one batch: the loss
# and the parameters at the reference's own limits (tests/test_archs.py:
# 89-105), each leaf's accumulated f32 gradient within 1e-3 of its
# largest element
MB_LOSS_RTOL = 1e-4
MB_PARAM_TOL = 5e-3
MB_GRAD_TOL = 1e-3
# 13b: the dry-run CLI's combinations, one invocation each
DRYRUN_CALLS = (["--arch", "gnn-papers100m"],
                ["--arch", "stablelm-1.6b", "--shape", "train_4k"],
                ["--arch", "gemma3-12b", "--shape", "prefill_32k",
                 "--shape", "decode_32k"])
KERNEL_KEYS = ("tiled_slab", "tiled_direct", "backward", "backward_csr",
               "row", "backward_identity")


def lm_args(sz: Sizes, dev, mb: int) -> argparse.Namespace:
    """``launch/train.py``'s arguments for the LM run of 13a."""
    return argparse.Namespace(
        arch=sz.lt_arch, smoke=sz.lt_smoke, steps=sz.lt_steps, batch=sz.lt_b,
        seq=sz.lt_s, microbatches=mb, model_par=1, seed=0, log_every=5,
        ckpt_every=0, ckpt_dir="", keep_last=0, device=str(dev))


def lm_train(dev, sz: Sizes, tag: str) -> dict:
    """13a: ``train_lm``'s code path at full width, then one step with 1
    and with 2 micro-batches on one batch."""
    cfg = get_config(sz.lt_arch, smoke=sz.lt_smoke)
    if not sz.lt_smoke:
        check(cfg.n_layers == 24 and cfg.d_model == 2048
              and cfg.n_heads == 32 and cfg.d_ff == 5632
              and cfg.vocab_size == 100_352 and cfg.dtype == "bfloat16"
              and cfg.remat, f"unexpected stablelm-1.6b config {cfg}")
    shape = InputShape("train_4k", "train", sz.lt_s, sz.lt_b)
    mb = DR.microbatches_for(cfg, shape)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    ops.reset_launches()
    fa.reset_launches()
    # adamw(3e-3), as the reference's loss-falls test (tests/
    # test_system.py:22): the default schedule's warm-up barely moves
    # the loss in so few steps
    res = launch_train.train_lm(lm_args(sz, dev, mb), optimizer=adamw(3e-3))
    run_s = time.perf_counter() - t0
    # training attends through the reference model's chunked attention:
    # no flash launch (its kernel has no backward), no aggregation
    launches = {**ops.launch_counts(), **fa.launch_counts()}
    check_launch(dev, not any(launches.values()),
                 f"13a launched kernels: {launches}")
    losses = res["losses"]
    check(all(math.isfinite(x) for x in losses), f"13a losses {losses}")
    check(np.mean(losses[-3:]) < losses[0],
          f"13a: the loss did not fall: {losses}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    out = {"arch": cfg.name, "microbatches": mb, "losses": losses,
           "run_s": run_s, "peak_bytes": peak, "launches": launches}
    if res["step_ms"]:
        ms = float(np.median(res["step_ms"][1:]))
        out.update(step_ms=ms, tokens_per_s=sz.lt_b * sz.lt_s / ms * 1e3)
        print(f"13a train_lm {cfg.name} b={sz.lt_b} s={sz.lt_s} "
              f"microbatches={mb}: {ms:.2f} ms/step (median of steps "
              f"2-{sz.lt_steps}, CUDA events), "
              f"{out['tokens_per_s']:.0f} tokens/s, max_memory_allocated "
              f"{peak} B, loss {losses[0]:.4f} -> {losses[-1]:.4f} ({tag})",
              flush=True)

    out["microbatch_check"] = microbatch_check(dev, cfg, sz, tag)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _mb_readings(ref_grads, ref_params, ref_loss, grads, params, loss):
    """(loss relative error, gradients: the largest leaf's max|a - b| /
    max|b|, parameters: max|a - b|, parameters beyond MB_PARAM_TOL) of
    one step against another."""
    g_err = max(float((a - b).abs().max()) / float(b.abs().max())
                for a, b in zip(tree_leaves(grads), tree_leaves(ref_grads))
                if bool(b.any()))
    p_diff = [(a - b).abs() for a, b in zip(tree_leaves(params),
                                            tree_leaves(ref_params))]
    return (abs(loss - ref_loss) / abs(ref_loss), g_err,
            max(float(d.max()) for d in p_diff),
            sum(int((d > MB_PARAM_TOL).sum()) for d in p_diff))


def microbatch_check(dev, cfg, sz: Sizes, tag: str) -> dict:
    """13a's check of gradient accumulation: one train step (``steps.
    accumulate_grads``, then the optimizer's update, which is what
    ``make_train_step``'s step does) with 1 and with 2 micro-batches on
    one batch of b = 2, under ``adamw(3e-3)``, whose first update moves
    each parameter by about 3e-3 times the sign of its gradient.  Held
    in f32 (the arch at full width with f32 compute), where a planted
    fault, the gradient of the last micro-batch alone, read the same way,
    must fail the limits.  Under the arch's bf16 compute the reading is
    printed, not held: the two gradients round apart, which flips the
    sign of the first update for elements whose gradient is near 0, and
    such a parameter moves 2 * 3e-3 apart, beyond the reference's
    5e-3."""
    hb = next(token_batches(cfg.vocab_size, 2, sz.lt_s, seed=0))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in hb.items()}
    last = {k: v[1:] for k, v in batch.items()}
    opt = adamw(3e-3)
    limits = (MB_LOSS_RTOL, MB_GRAD_TOL, MB_PARAM_TOL)
    readings = {}
    for dtype, cases in (
            ("float32", (("2 micro-batches", batch, 2),
                         ("planted fault: last micro-batch alone", last,
                          1))),
            ("bfloat16", (("2 micro-batches", batch, 2),))):
        c = dataclasses.replace(cfg, dtype=dtype)
        params = M.init_model(torch.Generator(device=dev).manual_seed(0),
                              c, dev)

        def step(b_, n_mb):
            g, m = steps.accumulate_grads(params, c, b_, n_mb)
            with torch.no_grad():
                new_p = opt.update(g, opt.init(params), params)[0]
            return g, new_p, float(m["loss"])
        ref = step(batch, 1)
        for name, b_, n_mb in cases:
            got = step(b_, n_mb)
            r = readings[f"{dtype}, {name}"] = _mb_readings(*ref, *got)
            del got
            print(f"13a microbatch check, {name} against 1 micro-batch "
                  f"({dtype} compute, b=2, s={sz.lt_s}, adamw(3e-3)): loss "
                  f"rel {r[0]:.4g}, gradients {r[1]:.4g}, parameters "
                  f"{r[2]:.4g} ({r[3]} beyond {MB_PARAM_TOL}); limits "
                  f"{limits}, {'held' if dtype == 'float32' else 'not held'}"
                  f" ({tag})", flush=True)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        del params, ref
    ok = readings["float32, 2 micro-batches"]
    fault = readings["float32, planted fault: last micro-batch alone"]
    check(all(x <= lim for x, lim in zip(ok, limits)),
          f"13a microbatches 1 vs 2: {ok} against {limits}")
    check(fault[1] > MB_GRAD_TOL and fault[2] > MB_PARAM_TOL,
          f"13a: the planted fault passed the limits: {fault}")
    return {"limits": limits, **{k: list(v) for k, v in readings.items()}}


@contextlib.contextmanager
def dryrun_started(calls=DRYRUN_CALLS):
    """``python -m repro_torch.launch.dryrun`` calls at the production
    sizes (13b's by default: gnn-papers100m at its full n), one process
    each, all started at once: they trace on the host's cores while the
    card trains or serves.  Yields (records directory, [(argv,
    process)]); on exit kills any still running and removes the
    records."""
    os.makedirs(DRYRUN_OUT, exist_ok=True)
    out_dir = tempfile.mkdtemp(dir=DRYRUN_OUT)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"),
         os.environ.get("PYTHONPATH", "")]))
    procs = []
    try:
        for argv in calls:
            procs.append((argv, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
                 "--single-pod", "--out", out_dir], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, env=env)))
        yield out_dir, procs
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.communicate()
        shutil.rmtree(out_dir, ignore_errors=True)


def dryrun_cli(tag: str, out_dir: str, procs, t0: float) -> dict:
    """13b: wait for ``dryrun_started``'s processes; every record ``ok``,
    printed, and the full-graph one beside the plain path's."""
    for argv, proc in procs:
        _, err = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"13b dryrun {argv}: {err[-2000:]}")
    secs = time.perf_counter() - t0
    recs = {}
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name)) as f:
            rec = json.load(f)
        check(rec["status"] == "ok",
              f"13b {name}: {rec.get('error')} {rec.get('traceback')}")
        r = rec["roofline"]
        print(f"13b dryrun {rec['arch']} {rec['shape']} {rec['mesh']}: "
              f"device_bytes_total {rec['device_bytes_total']} B, "
              f"fits_hbm {rec['fits_hbm']}, dominant {r['dominant']}, "
              f"bound_s {r['bound_s']:.6g} (at the H100's published "
              f"peaks; run beside {tag}; the trace ran on the host in "
              f"{rec['compile_seconds']:.1f} s)", flush=True)
        recs[f"{rec['arch']}__{rec['shape']}"] = {
            k: rec[k] for k in ("device_bytes_total", "fits_hbm",
                                "per_device_flops", "per_device_bytes",
                                "memory", "roofline", "kernel_calls",
                                "compile_seconds")}
    want = {"gnn-papers100m__fullgraph_train",
            "gnn-papers100m__minibatch_train", "stablelm-1.6b__train_4k",
            "gemma3-12b__prefill_32k", "gemma3-12b__decode_32k"}
    check(set(recs) == want, f"13b records {sorted(recs)}")
    # the reference's choice (its kernel off, dryrun.py:140-147), for the
    # record: the plain path materialises the [n, K, d] gather
    plain = DR.dryrun_gnn("gnn-papers100m", "fullgraph_train",
                          cfg=dataclasses.replace(
                              get_config("gnn-papers100m"),
                              use_agg_kernel=False))
    kern = recs["gnn-papers100m__fullgraph_train"]["device_bytes_total"]
    print(f"13b dryrun gnn-papers100m fullgraph_train on the plain path "
          f"(use_agg_kernel=False): device_bytes_total "
          f"{plain['device_bytes_total']} B against {kern} B on the kernel "
          f"path (run beside {tag})", flush=True)
    return {"records": recs, "seconds_since_start": secs,
            "plain_fullgraph_bytes": plain["device_bytes_total"]}


def measured_step(dev, step, args, reps: int) -> tuple:
    """One ``step(*args)`` with the arguments resident: the step's peak
    device bytes (the arguments' own plus what the step added above what
    was allocated before it), the launch counts of both kernel packages,
    and the mean device time of ``reps`` more steps (CUDA events)."""
    ops.reset_launches()
    fa.reset_launches()
    if dev.type != "cuda":                       # the CPU rehearsal
        step(*args)
        return None, {**ops.launch_counts(), **fa.launch_counts()}, None
    sync(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = step(*args)
    sync(dev)
    counts = {**ops.launch_counts(), **fa.launch_counts()}
    peak = (torch.cuda.max_memory_allocated(dev) - before
            + R.resident_bytes(args))
    del out
    ms = time_ms(lambda: step(*args), dev, reps, warmup=0) if reps else None
    return peak, counts, ms


def meta_of(tree):
    """The tree with every tensor as a meta tensor of its shape and dtype
    (no data); other leaves as they are."""
    return tree_map_only(torch.Tensor,
                         lambda t: torch.empty_like(t, device="meta"), tree)


def prediction_line(label, pred, peak, ms, tag, phase: str = "13c") -> dict:
    """Print and hold one comparison of the dry-run with the card (the
    ratio on the card only: the CPU rehearsal measures no device
    memory)."""
    ratio = pred["device_bytes_total"] / peak if peak else None
    r = pred["roofline"]
    share = r["bound_s"] * 1e3 / ms if ms else None
    print(f"{phase} {label}: dry-run device_bytes_total "
          f"{pred['device_bytes_total']} B, measured peak {peak} B, ratio "
          f"{ratio} (limits {PEAK_RATIO}); step {ms} ms (CUDA events) "
          f"against bound_s {r['bound_s'] * 1e3:.4f} ms ({r['dominant']}), "
          f"share {share} ({tag})", flush=True)
    check(peak is None or PEAK_RATIO[0] <= ratio <= PEAK_RATIO[1],
          f"{phase} {label}: predicted {pred['device_bytes_total']} B against "
          f"{peak} B measured")
    return {"predicted_bytes": pred["device_bytes_total"],
            "measured_peak_bytes": peak, "ratio": ratio, "step_ms": ms,
            "bound_ms": r["bound_s"] * 1e3, "dominant": r["dominant"],
            "bound_share": share, "kernel_calls": pred["kernel_calls"]}


def gnn_checks(dev, sz: Sizes, graph, tag: str) -> dict:
    """13c for the GNN: the full-graph step at the shared graph's n with
    the reverse index, and the mini-batch step at b = mb_b, fan-out
    mb_fanout, each predicted by the dry-run at the same sizes and
    measured; the traced kernel calls against the real launches."""
    cfg = papers_cfg(graph, sz)
    out = {}
    E.drop_device_cache(graph)
    idx, w, w_self, feats, labels = E._device_ell(graph, cfg.max_degree,
                                                  dev)
    rev = ops.build_reverse_index(idx, w, graph.n)
    gen = torch.Generator().manual_seed(0)
    params = G.init_gnn(gen, cfg, cfg.feat_dim, dev)
    opt, step = gnn_steps.make_fullgraph_step(cfg)
    args = (params, opt.init(params), feats, idx, w, w_self,
            labels.to(torch.int32), rev)
    pred = DR.dryrun_gnn("gnn-papers100m", "fullgraph_train",
                         cfg=dataclasses.replace(cfg, max_degree=idx.shape[1]))
    peak, counts, ms = measured_step(dev, step, args, sz.path_iters)
    out["fullgraph"] = prediction_line(
        f"full-graph step n={graph.n} K={idx.shape[1]} (kernels, reverse "
        f"index)", pred, peak, ms, tag)
    out["fullgraph"]["launches"] = counts
    check_launch(dev, all(counts[k] == pred["kernel_calls"].get(k, 0)
                          for k in KERNEL_KEYS),
                 f"13c full-graph: traced {pred['kernel_calls']} against "
                 f"launched {counts}")
    standins = {"fullgraph_step": standin_shapes(step, args)}
    del args, rev, idx, w, w_self, feats, labels
    E.drop_device_cache(graph)

    b, (f1, f2), r = sz.mb_b, sz.mb_fanout, cfg.feat_dim
    tg = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.rand(shape, generator=tg, device=dev)
    masks = [(rand(b, f1) > 0.2).float(), (rand(b, f1, f2) > 0.2).float()]
    batch = ([torch.randn((b, r), generator=tg, device=dev),
              torch.randn((b, f1, r), generator=tg, device=dev),
              torch.randn((b, f1, f2, r), generator=tg, device=dev)],
             masks, [m * rand(*m.shape) for m in masks],
             [rand(b), rand(b, f1), rand(b, f1, f2)],
             torch.randint(0, cfg.n_classes, (b,), generator=tg, device=dev,
                           dtype=torch.int32))
    opt, step = gnn_steps.make_minibatch_step(cfg)
    args = (params, opt.init(params), *batch)
    pred = DR.dryrun_gnn("gnn-papers100m", "minibatch_train", cfg=cfg)
    peak, counts, ms = measured_step(dev, step, args, sz.path_iters)
    out["minibatch"] = prediction_line(
        f"mini-batch step b={b} fan-out {sz.mb_fanout}", pred, peak, ms, tag)
    out["minibatch"]["launches"] = counts
    check_launch(dev, all(counts[k] == pred["kernel_calls"].get(k, 0)
                          for k in KERNEL_KEYS),
                 f"13c mini-batch: traced {pred['kernel_calls']} against "
                 f"launched {counts}")
    standins["minibatch_step"] = standin_shapes(step, args)
    out["standins"] = standins
    return out


def standin_shapes(step, args) -> dict:
    """The step on meta copies of ``args`` (the stand-ins in place of the
    kernels) against the step on the real ones: every output's shape and
    dtype equal."""
    real = step(*args)
    meta_args = list(meta_of(args))
    if isinstance(meta_args[-1], ops.ReverseIndex):
        meta_args[-1] = ops.build_reverse_index(meta_args[3], meta_args[4],
                                                meta_args[-1].n)
    meta = step(*meta_args)
    got = [(tuple(t.shape), t.dtype) for t in tree_leaves(meta)]
    want = [(tuple(t.shape), t.dtype) for t in tree_leaves(real)]
    check(got == want, f"stand-in step outputs {got} against {want}")
    return {"outputs": len(want), "equal": True}


def kernel_standins(dev, sz: Sizes) -> dict:
    """Every kernel entry on shape-only copies of real inputs against its
    launch on the card: output shapes and dtypes equal (the reverse
    index's edges excepted: the stand-in keeps every edge)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    n, k = sz.agg_n, sz.agg_k
    res = {}

    def same(name, fn, *inputs):
        real = fn(*inputs)
        meta = fn(*meta_of(inputs))
        got = [(tuple(t.shape), t.dtype) for t in tree_leaves(meta)
               if t is not None]
        want = [(tuple(t.shape), t.dtype) for t in tree_leaves(real)
                if t is not None]
        check(got == want, f"stand-in {name}: {got} against {want}")
        res[name] = want
    for d, dt in ((128, torch.bfloat16), (172, torch.bfloat16)):
        feats = torch.randn((n, d), generator=gen, device=dev).to(dt)
        idx = torch.randint(0, n, (n, k), generator=gen, device=dev,
                            dtype=torch.int32)
        w = torch.rand((n, k), generator=gen, device=dev).to(dt)
        same(f"tiled_d{d}", lambda f, i, ww: ops.neighbor_agg(
            f, i, ww, use_kernel=True), feats, idx, w)
    sr = torch.randn((sz.agg_b, 172), generator=gen, device=dev)
    ws = torch.rand((sz.agg_b,), generator=gen, device=dev)
    f32 = torch.randn((n, 172), generator=gen, device=dev)
    i32 = idx[:sz.agg_b].contiguous()
    w32 = torch.rand((sz.agg_b, k), generator=gen, device=dev)
    same("tiled_fused_f32", lambda f, i, ww, s_, ws_: ops.neighbor_agg(
        f, i, ww, s_, ws_, use_kernel=True), f32, i32, w32, sr, ws)
    same("row", lambda f, i, ww: ops.neighbor_agg(
        f, i, ww, use_kernel=True, kernel="row"), f32, i32, w32)
    g = torch.randn((sz.agg_b, 172), generator=gen, device=dev)
    same("backward", lambda f, i, ww, gg, s_, ws_: ops.neighbor_agg_backward(
        f, i, ww, gg, s_, ws_), f32, i32, w32, g, sr, ws)

    def csr(f, i, ww, gg):
        rev = ops.build_reverse_index(i, ww, f.shape[0])
        return ops.neighbor_agg_backward(f, i, ww, gg, need=DFEATS, rev=rev)
    same("backward_csr", csr, f32, i32, w32, g)
    same("backward_identity", lambda t, ww, gg, s_, ws_:
         ops.neighbor_agg_backward_identity(t, ww, gg, s_, ws_),
         *identity_inputs(gen, dev, 256, 15, 172, torch.float32, True))
    rev = ops.build_reverse_index(i32, w32, n)
    mrev = ops.build_reverse_index(*meta_of((i32, w32)), n)
    check(mrev.indptr.shape == rev.indptr.shape
          and mrev.kept.shape == rev.kept.shape
          and mrev.edges.shape[0] == i32.numel() >= rev.nnz,
          "stand-in reverse index shapes")
    for (b_, s_, hq, hkv, d), dt in ((sz.fa_shape, torch.bfloat16),
                                     ((1, 256, 4, 2, 32), torch.float32)):
        q = torch.randn((b_, s_, hq, d), generator=gen, device=dev).to(dt)
        kk = torch.randn((b_, s_, hkv, d), generator=gen, device=dev).to(dt)
        vv = torch.randn((b_, s_, hkv, d), generator=gen, device=dev).to(dt)
        same(f"flash_{fa.kernel_route(dt, d)}_{str(dt)[6:]}",
             lambda a, b2, c: fa.flash_attention(a, b2, c, use_kernel=True),
             q, kk, vv)
    sync(dev)
    return res


def lm_check(dev, sz: Sizes, tag: str, train: dict) -> dict:
    """13c for 13a's step: the dry-run at the same batch, sequence and
    micro-batches against one measured step."""
    cfg = get_config(sz.lt_arch, smoke=sz.lt_smoke)
    shape = InputShape("train_4k", "train", sz.lt_s, sz.lt_b)
    pred = DR.dryrun_lm(sz.lt_arch, shape, cfg=cfg)
    check(pred["microbatches"] == train["microbatches"],
          "13c: the dry-run and 13a split the batch alike")
    params = M.init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                          dev)
    opt, step = steps.make_train_step(cfg, adamw(3e-3),
                                      microbatches=pred["microbatches"])
    hb = next(token_batches(cfg.vocab_size, sz.lt_b, sz.lt_s, seed=0))
    args = (params, opt.init(params),
            {k: torch.from_numpy(v).to(dev) for k, v in hb.items()})
    peak, _, _ = measured_step(dev, step, args, 0)
    out = prediction_line(
        f"{cfg.name} train step b={sz.lt_b} s={sz.lt_s} microbatches="
        f"{pred['microbatches']}", pred, peak, train.get("step_ms"), tag)
    del args, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def prefill_readings(dev, tag: str = "", seeds=range(16),
                     repeats: int = 3) -> dict:
    """The reading of tests/test_torch_cuda.py::
    test_prefill_launches_wgmma_kernel_once_per_layer (a bf16 gemma3-12b
    smoke prefill at head dim 64, kernel against the plain path, relative
    max error): tokens from generator seed 0 ``repeats`` times, then one
    reading per token seed in ``seeds``."""
    cfg = dataclasses.replace(get_config("gemma3-12b", smoke=True),
                              dtype="bfloat16", head_dim=64)
    params = M.init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                          dev, dtype=M._dt(cfg))

    def reading(seed):
        toks = torch.randint(0, cfg.vocab_size, (2, 192), device=dev,
                             generator=torch.Generator(
                                 device=dev).manual_seed(seed))
        with torch.inference_mode():
            got, _ = M.prefill(params, cfg, {"tokens": toks}, kernel=True)
            want, _ = M.prefill(params, cfg, {"tokens": toks}, kernel=False)
        return float((got.float() - want.float()).abs().max()
                     / want.float().abs().max())
    rep = [reading(0) for _ in range(repeats)]
    by_seed = [reading(s) for s in seeds]
    print(f"13d flash prefill reading (limit 2e-2): token seed 0 x "
          f"{repeats}: {rep}; seeds {list(seeds)[0]}-{list(seeds)[-1]}: "
          f"max {max(by_seed)}, {by_seed} ({tag or card_tag()})", flush=True)
    return {"seed0": rep, "by_seed": by_seed}


def lm_dryrun_phase(dev, sz: Sizes, graph) -> dict:
    """Phase 13 (13a-13d)."""
    tag = card_tag()
    secs, out = {}, {}
    E.drop_device_cache(graph)
    if dev.type == "cuda":              # the allocator's statistics exist
        torch.zeros(1, device=dev)      # once it has allocated

    def timed(key, fn, *args):
        t0 = time.perf_counter()
        out[key] = fn(*args)
        secs[key] = time.perf_counter() - t0
    with dryrun_started() as (out_dir, procs):
        t0 = time.perf_counter()
        timed("13a lm train", lm_train, dev, sz, tag)
        timed("13b dryrun cli (wait)", dryrun_cli, tag, out_dir, procs, t0)
    timed("13c gnn", gnn_checks, dev, sz, graph, tag)
    timed("13c kernels", kernel_standins, dev, sz)
    timed("13d prefill readings", prefill_readings, dev, tag)
    timed("13c lm", lm_check, dev, sz, tag, out["13a lm train"])
    out["seconds"] = secs
    return out


# ---------------------------------------------------------------------------
# phase 14: the MoE, SSM, hybrid, audio and VLM families
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("zamba2-7b", "llama4-scout-17b-a16e", "mamba2-130m",
                "whisper-medium", "internvl2-76b",
                "llama4-maverick-400b-a17b")
# the plain version of a flash call runs by KV head where its [B, H, S, S]
# f32 scores would pass this (llama4's 48 x 16384^2: 51.5 GB)
PLAIN_SCORES_BYTES = 8 * 2 ** 30


def family_cfg(arch: str, sz: Sizes, layers: int = 0):
    """The arch's full config (its smoke config when ``fam_smoke``), its
    depth cut to the pattern's first ``layers`` layers when given."""
    cfg = get_config(arch, smoke=sz.fam_smoke)
    if layers and not sz.fam_smoke:
        cfg = dataclasses.replace(
            cfg, n_layers=layers, layer_pattern=cfg.layer_pattern[:layers]
            if cfg.layer_pattern else None)
    return cfg


def family_serving(dev, sz: Sizes) -> dict:
    """14a-e's serving cases, each model dropped before the next."""
    fam = dict(ngen=sz.fam_gen, ntf=sz.fam_tf)
    out = {}
    cfg = family_cfg("zamba2-7b", sz)
    if not sz.fam_smoke:
        check(cfg.n_layers == 81 and cfg.d_model == 3584
              and cfg.resolved_head_dim == 112 and cfg.n_kv_heads == 32
              and cfg.pattern.count("mamba") == 70
              and cfg.pattern.count("shared_attn") == 11
              and cfg.ssm_state == 64, f"unexpected zamba2-7b config {cfg}")
    out["14a zamba2"] = serve_case(dev, cfg, "14a zamba2-7b", b=sz.zb_b,
                                   s=sz.zb_s, f32_twin=True, hold_tf=False,
                                   measure_peak=True, **fam)
    cfg = family_cfg("llama4-scout-17b-a16e", sz, sz.l4_layers)
    if not sz.fam_smoke:
        check(cfg.pattern == ("local",) * 3 + ("attn",)
              and cfg.d_model == 5120 and cfg.n_experts == 16
              and cfg.d_ff == 8192 and cfg.sliding_window == 8192
              and cfg.family == "moe", f"unexpected llama4 config {cfg}")
    out["14b llama4"] = serve_case(dev, cfg, "14b llama4-scout", b=1,
                                   s=sz.l4_s, f32_twin=True, **fam)
    cfg = family_cfg("mamba2-130m", sz)
    out["14c mamba2"] = serve_case(dev, cfg, "14c mamba2-130m", b=sz.zb_b,
                                   s=sz.zb_s, **fam)
    cfg = family_cfg("whisper-medium", sz)
    if not sz.fam_smoke:
        check(cfg.n_layers == 24 and cfg.n_enc_layers == 24
              and cfg.enc_seq == 1500 and cfg.d_model == 1024,
              f"unexpected whisper-medium config {cfg}")
    out["14d whisper"] = serve_case(dev, cfg, "14d whisper-medium", b=2,
                                    s=sz.wh_s, **fam)
    cfg = family_cfg("internvl2-76b", sz, sz.vl_layers)
    if not sz.fam_smoke:
        check(cfg.n_layers == 8 and cfg.d_model == 8192
              and cfg.frontend_seq == 1024 and cfg.d_ff == 28672,
              f"unexpected internvl2-76b config {cfg}")
    out["14e internvl2"] = serve_case(dev, cfg, "14e internvl2-76b", b=2,
                                      s=sz.vl_text, **fam)
    return out


def family_train(dev, sz: Sizes, tag: str) -> dict:
    """14c's training: ``train_lm`` on mamba2-130m at full width and
    depth, ``adamw(3e-3)``; losses finite and falling, no kernel
    launched."""
    args = argparse.Namespace(
        arch="mamba2-130m", smoke=sz.fam_smoke, steps=sz.m2_steps,
        batch=sz.m2_b, seq=sz.m2_s, microbatches=1, model_par=1, seed=0,
        log_every=5, ckpt_every=0, ckpt_dir="", keep_last=0, device=str(dev))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    fa.reset_launches()
    res = launch_train.train_lm(args, optimizer=adamw(3e-3))
    launches = {**ops.launch_counts(), **fa.launch_counts()}
    check_launch(dev, not any(launches.values()),
                 f"14c training launched kernels: {launches}")
    losses = res["losses"]
    check(all(math.isfinite(x) for x in losses), f"14c losses {losses}")
    check(np.mean(losses[-3:]) < losses[0],
          f"14c: the loss did not fall: {losses}")
    out = {"losses": losses, "launches": launches}
    if res["step_ms"]:
        ms = float(np.median(res["step_ms"][1:]))
        out.update(step_ms=ms, tokens_per_s=sz.m2_b * sz.m2_s / ms * 1e3,
                   peak_bytes=torch.cuda.max_memory_allocated(dev))
        print(f"14c train_lm mamba2-130m b={sz.m2_b} s={sz.m2_s}: {ms:.2f} "
              f"ms/step (median of steps 2-{sz.m2_steps}, CUDA events), "
              f"{out['tokens_per_s']:.0f} tokens/s, max_memory_allocated "
              f"{out['peak_bytes']} B, loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f} ({tag})", flush=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def family_dryrun_calls(sz: Sizes) -> tuple:
    """14f's dry-run CLI calls: one process an arch, at ``fam_shapes``
    (every input shape when empty; the CPU rehearsal traces the decode
    shapes only, which take a second each)."""
    shapes = [a for sh in sz.fam_shapes for a in ("--shape", sh)]
    return tuple(["--arch", a, *shapes] for a in FAMILY_ARCHS)


def family_dryrun(tag: str, out_dir: str, procs, sz: Sizes) -> dict:
    """14f: wait for the dry-run processes; every combination of the six
    archs and the input shapes recorded, ``ok`` where ``shape_applicable``
    admits it (with ``fits_hbm``) and skipped elsewhere."""
    for argv, proc in procs:
        _, err = proc.communicate(timeout=900)
        check(proc.returncode == 0, f"14f dryrun {argv}: {err[-2000:]}")
    recs = {}
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name)) as f:
            rec = json.load(f)
        key = f"{rec['arch']}__{rec['shape']}"
        ok, _ = shape_applicable(get_config(rec["arch"]),
                                 INPUT_SHAPES[rec["shape"]])
        check(rec["status"] == ("ok" if ok else "skipped"),
              f"14f {name}: {rec['status']} {rec.get('error')} "
              f"{rec.get('traceback')}")
        if not ok:
            recs[key] = {"status": "skipped"}
            continue
        check(isinstance(rec["fits_hbm"], bool), f"14f {name}: fits_hbm")
        r = rec["roofline"]
        print(f"14f dryrun {key} {rec['mesh']}: device_bytes_total "
              f"{rec['device_bytes_total']} B, fits_hbm {rec['fits_hbm']}, "
              f"params {rec['params_total']} (active "
              f"{rec['params_active']}), dominant {r['dominant']}, bound_s "
              f"{r['bound_s']:.6g}, kernel calls {rec['kernel_calls']} (at "
              f"the H100's published peaks; run beside {tag}; traced on the "
              f"host in {rec['compile_seconds']:.1f} s)", flush=True)
        recs[key] = {k: rec[k] for k in (
            "status", "device_bytes_total", "fits_hbm", "params_total",
            "params_active", "per_device_flops", "roofline", "kernel_calls",
            "compile_seconds")}
    want = {f"{a}__{sh}" for a in FAMILY_ARCHS
            for sh in sz.fam_shapes or INPUT_SHAPES}
    check(set(recs) == want, f"14f records {sorted(recs)}")
    return recs


def family_peak(dev, sz: Sizes, tag: str, zamba: dict) -> dict:
    """14f: 14a's prefill traced at the card's shapes against its
    measured peak; the traced flash calls against the launches."""
    cfg = family_cfg("zamba2-7b", sz)
    shape = InputShape("prefill", "prefill", sz.zb_s, sz.zb_b)
    pred = DR.dryrun_lm("zamba2-7b", shape, cfg=cfg)
    out = prediction_line(f"zamba2-7b prefill b={sz.zb_b} s={sz.zb_s}",
                          pred, zamba["peak_bytes"], None, tag, "14f")
    traced = {r: pred["kernel_calls"].get(f"flash_{r}", 0)
              for r in fa.ROUTES}
    launched = {r: zamba["peak_counts"][r] for r in fa.ROUTES}
    check_launch(dev, traced == launched,
                 f"14f: traced flash calls {traced} against launched "
                 f"{launched}")
    return dict(out, traced=traced, launched=launched)


def family_flash(dev, sz: Sizes, rows: list) -> dict:
    """The flash kernel at each prefill shape of phase 14, bf16: against
    the plain version (FA_TOL; by KV head where its scores would pass
    PLAIN_SCORES_BYTES), timed beside it, ``scaled_dot_product_attention``
    and the bound.  At head dim 112: the row check against the plain
    version in f32 (BF16_ROW_TOL), faults planted in the output that must
    break it (the second half's rows off by 2 %, the output's last 16
    real columns zeroed), and the tf32x3 kernel on the same inputs in f32
    (two calls bit-equal; bounds at the 3xTF32 and the f32-FMA rates)."""
    gen = torch.Generator(device=dev).manual_seed(14)
    kern = lambda q, k, v, w: fa.flash_attention(  # noqa: E731
        q, k, v, window=w, use_kernel=True)
    plain = lambda q, k, v, w: fa.flash_attention(  # noqa: E731
        q, k, v, window=w, use_kernel=False)
    out = {}
    for label, b, s, hq, hkv, d, w, n in rows:
        name = f"flash bf16 B={b} S={s} Hq={hq} Hkv={hkv} D={d} window={w}"
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device=dev).to(
            torch.bfloat16) for h in (hq, hkv, hkv))
        route = fa.kernel_route(q.dtype, d)
        counts = fa.launch_counts()
        got = kern(q, k, v, w)
        check_launch(dev, fa.launch_counts()[route] == counts[route] + 1,
                     f"{name}: not one launch of the {route} kernel")
        g = hq // hkv
        parts = (1 if b * hq * s * s * 4 <= PLAIN_SCORES_BYTES else hkv)
        slices = [tuple(x[:, :, i * h_:(i + 1) * h_].contiguous()
                        for x, h_ in ((q, hq // parts), (k, hkv // parts),
                                      (v, hkv // parts)))
                  for i in range(parts)]
        want = torch.cat([plain(*sl, w) for sl in slices], 2)
        err = compare(f"{name} ({label})", q.dtype, got, want,
                      FA_TOL[q.dtype])
        del want
        row = {}
        if d % 64:
            q32, k32, v32 = (x.float() for x in (q, k, v))
            ref32 = plain(q32, k32, v32, w)
            r = row_rel_err(got, ref32)
            check(dev.type != "cuda" or r <= BF16_ROW_TOL,
                  f"{name}: row error {r} beyond {BF16_ROW_TOL}")
            late = got.clone()
            late[:, s // 2:] = (late[:, s // 2:].float() * 1.02).to(
                got.dtype)
            cols = got.clone()
            cols[..., d - 16:] = 0
            faults = {"late rows x1.02": row_rel_err(late, ref32),
                      f"columns {d - 16}-{d - 1} zeroed":
                          row_rel_err(cols, ref32)}
            for fault, x in faults.items():
                check(x > BF16_ROW_TOL, f"{name}: the row check passes the "
                      f"planted fault '{fault}' ({x} <= {BF16_ROW_TOL})")
            del late, cols
            counts = fa.launch_counts()
            got32 = kern(q32, k32, v32, w)
            check_launch(dev, fa.launch_counts()["tf32x3"]
                         == counts["tf32x3"] + 1,
                         f"{name}: f32 not one launch of the tf32x3 kernel")
            err32 = compare(f"{name} in f32", torch.float32, got32, ref32,
                            FA_TOL[torch.float32])
            check(torch.equal(got32, kern(q32, k32, v32, w)),
                  f"{name} in f32: two calls of the kernel differ")
            f32_ms = time_ms(lambda: kern(q32, k32, v32, w), dev,
                             sz.fa_iters)
            p32_ms = time_ms(lambda: plain(q32, k32, v32, w), dev, 1, 1)
            lib32 = library_ms(_sdpa(q32, k32, v32, w), dev, sz.fa_iters)
            b32 = flash_bound(b, s, hq, hkv, d, w, torch.float32)[0]
            fma32 = flash_bound(b, s, hq, hkv, d, w, torch.float32,
                                rate=F32_FLOPS_PER_S)[0]
            row = {"row_rel_err": r, "row_check_limit": BF16_ROW_TOL,
                   "planted_faults": faults, "f32_max_abs_err": err32,
                   "f32_kernel_ms": f32_ms, "f32_plain_ms": p32_ms,
                   "f32_library_ms": lib32, "f32_bound_ms": b32,
                   "f32_bound_fma_ms": fma32}
            print(f"{name}: row error {r:.6g} (limit {BF16_ROW_TOL}); "
                  f"planted faults {faults}; the tf32x3 kernel on the inputs "
                  f"in f32: max_err {err32:.3g} (two calls bit-equal), "
                  f"{f32_ms:.4f} ms, plain {p32_ms:.4f} ms, library "
                  f"{fmt(lib32)} ms, bound {b32:.4f} ms (3xTF32 rate, 495/3 "
                  f"TFLOP/s; {fma32:.4f} ms at the f32-FMA rate)", flush=True)
            del q32, k32, v32, ref32, got32
        del got
        k_ms = time_ms(lambda: kern(q, k, v, w), dev, sz.fa_iters)
        p_ms = sum(time_ms(lambda: plain(*sl, w), dev, 1, 1)
                   for sl in slices)
        del slices
        if w:
            ke, ve = (x.repeat_interleave(g, dim=2) for x in (k, v))
            lib = library_ms(_sdpa(q, ke, ve, w), dev, sz.fa_iters)
            del ke, ve
        else:
            lib = library_ms(_sdpa(q, k, v, w), dev, sz.fa_iters)
        b_ms, b_by, nbytes, flops = flash_bound(b, s, hq, hkv, d, w,
                                                q.dtype)
        out[name] = dict(
            path=label, route=route, launches_per_prefill=n,
            max_abs_err=err, ms=k_ms, plain_ms=p_ms,
            plain_parts=parts, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib, **row)
        print(f"{name} ({label}, {n} a prefill): {route} kernel "
              f"max_err={err:.3g} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f}"
              f"{f' (by {parts} KV heads)' if parts > 1 else ''} "
              f"library_ms={fmt(lib)} (scaled_dot_product_attention"
              f"{', band mask' if w else ''}) bound_ms={b_ms:.4f} (bound by "
              f"{b_by}: {nbytes} B, {flops} flops) = "
              f"{flops / k_ms / 1e9:.1f} TFLOP/s achieved", flush=True)
        del q, k, v
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def family_phase(dev, sz: Sizes) -> dict:
    """Phase 14 (14a-f), the dry-run processes tracing on the host while
    the card serves and trains."""
    tag = card_tag()
    secs, out = {}, {}
    if dev.type == "cuda":              # the allocator's statistics exist
        torch.zeros(1, device=dev)      # once it has allocated

    def timed(key, fn, *args):
        t0 = time.perf_counter()
        out[key] = fn(*args)
        secs[key] = time.perf_counter() - t0
    with dryrun_started(family_dryrun_calls(sz)) as (out_dir, procs):
        timed("14a-e serving", family_serving, dev, sz)
        timed("14c training", family_train, dev, sz, tag)
        rows = [(key, *shape) for key, res in out["14a-e serving"].items()
                for shape in res["flash_shapes"]]
        timed("14 flash shapes", family_flash, dev, sz, rows)
        timed("14f peak", family_peak, dev, sz, tag,
              out["14a-e serving"]["14a zamba2"])
        timed("14f dryrun cli (wait)", family_dryrun, tag, out_dir, procs,
              sz)
    out["seconds"] = secs
    return out


ALLOWLIST = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src",
                         "repro_torch", "analysis", "allowlist.toml")


def gate_findings(label: str, findings) -> list:
    """The findings after the allowlist, printed; any gating one fails
    the run."""
    entries, bad = AF.load_allowlist(ALLOWLIST)
    kept, suppressed = AF.apply_allowlist(list(findings) + bad, entries)
    print(f"{label} findings:\n" + AF.render_report(kept, suppressed),
          flush=True)
    gate = AF.gating(kept)
    check(not gate, f"{label}: {len(gate)} gating finding(s): "
                    f"{[str(f) for f in gate]}")
    return kept


def resource_lines(rows: list, tag: str) -> None:
    """The built kernels' resources: one line per flash symbol, one per
    neighbor-aggregation kernel with its symbols' ranges."""
    by_kernel = collections.defaultdict(list)
    for r in rows:
        by_kernel[r["kernel"]].append(r)
    for kernel, rs in sorted(by_kernel.items()):
        if kernel.startswith("flash_attn"):
            for r in rs:
                print(f"15a resources {r['symbol']}: REG {r['reg']} x "
                      f"{r['threads']} threads = {r['regs_per_block']} "
                      f"regs, SHARED static {r['shared_static']} B + "
                      f"dynamic {r['shared_dynamic']} B (the launch asks "
                      f"{r['shared_dynamic_built']} B), LOCAL "
                      f"{r['local']} B, STACK {r['stack']} B ({tag})",
                      flush=True)
            continue
        regs = [r["reg"] for r in rs]
        print(f"15a resources {kernel}: {len(rs)} symbols, REG "
              f"{min(regs)}-{max(regs)} x {rs[0]['threads']} threads, "
              f"SHARED static {max(r['shared_static'] for r in rs)} B + "
              f"dynamic {rs[0]['shared_dynamic']} B, LOCAL max "
              f"{max(r['local'] for r in rs)} B, STACK max "
              f"{max(r['stack'] for r in rs)} B ({tag})", flush=True)


def trace_checks(label: str, findings, records, variants=None) -> None:
    """A trace audit's records: stable across binds, and kernel launches
    exactly where the variant runs the kernel path (on the card)."""
    gate_findings(label, findings)
    kernel_of = {f"variant:{v.name}": v.kernel
                 for v in (variants or TR.sweep_variants())}
    for rec in records:
        name = rec["variant"]
        print(f"{label} {name}: {rec['n_ops']} ops, hash {rec['op_hash']}, "
              f"launches {rec['kernel_launches']}, syncs by op "
              f"{rec['host_syncs']}, syncs measured "
              f"{rec['host_syncs_measured']}, mesh "
              f"{rec['mesh_collectives']}, host "
              f"constants {rec['host_constants']}", flush=True)
        if "retrace_stable" in rec:
            check(rec["retrace_stable"], f"{label} {name}: not stable")
        if torch.device(rec["device"]).type != "cuda":
            continue
        kernel = kernel_of.get(name, "+kernel" in name)
        launched = sum(n for k, n in rec["kernel_launches"].items()
                       if k.count(".") == 1 and k.split(".")[1] in (
                           "tiled", "backward", "backward_csr", "row",
                           "backward_identity", "phase1", "phase2",
                           "wgmma", "tf32x3"))
        check(bool(launched) == kernel,
              f"{label} {name}: kernel launches {rec['kernel_launches']} "
              f"on a {'kernel' if kernel else 'plain'} variant")


#: the flash cases' logs kept for the CPU tests (recorded on the card by
#: ``kernel_audit.record_pipeline_logs``)
PIPELINE_LOGS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "data", "pipeline_logs.npz")


def pipeline_fixture_checks(fs) -> None:
    """Each planted pipeline fault flagged by a gating finding that names
    it; the short copy as a timeout of the bounded wait."""
    for name in AFX.PIPELINE_FAULTS:
        mine = [f for f in fs if f":fixture:{name}:" in f.site]
        check(mine, f"15a: the planted pipeline fault {name} was not "
                    f"flagged")
        print(f"15a fixture pipeline {name}: {len(mine)} finding(s), "
              f"rules {sorted({f.site.rsplit(':', 1)[1] for f in mine})}",
              flush=True)
    check(any(f.site.endswith(":timeout") for f in fs
              if ":ring_short_copy:" in f.site),
          "15a: the short copy was not flagged as a timeout")


def pipeline_phase(dev) -> dict:
    """15d: the pipeline check (``kernel_audit.audit_pipelines``): the
    checked build of both flash kernels (compiled here, timed) at every
    case, each block's log held to the pairing rules, each output
    bit-equal to the normal build's.  Its launches are no main-path
    launches (it calls the libraries, not the counted wrappers)."""
    if dev.type != "cuda":
        print("15d pipeline check: not measured (the checked build runs on "
              "the card)", flush=True)
        return {"not measured": "the checked build runs on the card"}
    tag = card_tag()
    fs, summary = KA.audit_pipelines(device=dev)
    print(f"15d checked library {summary['library']}: compiled in "
          f"{summary['compile_s']:.2f} s ({tag})", flush=True)
    rows = summary["kernels"]
    for kernel, r in rows.items():
        print(f"15d pipeline {kernel}: {r['cases']} cases, {r['blocks']} "
              f"blocks, {r['events']} events, {r['findings']} findings, "
              f"{r['seconds']:.2f} s; {r['bit_equal']} of {r['cases']} "
              f"outputs bit-equal to the normal build; checked kernels "
              f"{r['checked_ms']:.4f} ms against normal "
              f"{r['normal_ms']:.4f} ms, summed over the cases ({tag})",
              flush=True)
    want = collections.Counter(c.kernel for c in KA.pipeline_cases())
    check({k: r["cases"] for k, r in rows.items()} == dict(want),
          f"15d: cases run {rows}, expected {dict(want)}")
    check(all(r["bit_equal"] == r["cases"] for r in rows.values()),
          f"15d: a checked output differs from the normal build's: {rows}")
    gate_findings("15d", fs)
    digest = KA.checked_digest()
    kept = {lg["digest"] for lg in KA.load_pipeline_logs(PIPELINE_LOGS)
            } if os.path.exists(PIPELINE_LOGS) else set()
    print(f"15d committed logs (tests/data/pipeline_logs.npz): digest "
          f"{sorted(kept)}, the checked build's {digest}: "
          f"{'current' if kept == {digest} else 'stale'}", flush=True)
    return dict(summary, committed_logs_current=kept == {digest})


def audit_phase(dev, sz: Sizes, graph) -> dict:
    """Phase 15 (15a-d): the static audits on the card."""
    tag = card_tag()
    secs, out = {}, {}
    t0 = time.perf_counter()
    findings = KA.audit_budgets() + KA.audit_sources()
    if dev.type == "cuda":
        # a built symbol without a formula row is a gating finding
        rfs, rows = KA.audit_built()
        findings += rfs
        built = {r["kernel"] for r in rows}
        check(built == {r["kernel"] for r in KA.default_budget_table()},
              f"15a: the built libraries hold kernels {sorted(built)}")
        resource_lines(rows, tag)
        # the flash kernels keep their accumulators in registers
        spills = {r["symbol"]: r["local"] for r in rows
                  if r["kernel"] in KA.SMEM_QUERIES and r["local"]}
        check(not spills, f"15a: flash kernels spill (LOCAL bytes): {spills}")
        out["resources"] = rows
    else:
        out["resources"] = "not measured on the CPU"
    findings += KA.audit_index_tables(TR.audit_graph())
    findings += TA.audit_threads()
    gate_findings("15a", findings)
    fixtures = [n for n in AFX.FIXTURES
                if n != "constant" or dev.type == "cuda"]
    for name in fixtures:
        fs = AF.gating(AFX.run_fixture(name, dev))
        check(fs, f"15a: fixture {name} did not make the gate fire")
        print(f"15a fixture {name}: {len(fs)} gating finding(s), first: "
              f"{fs[0].site}: {fs[0].detail}", flush=True)
        if name == "pipeline":
            pipeline_fixture_checks(fs)
    secs["15a kernels + threads"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fs, recs = TR.audit_traces(n=192, device=dev)
    trace_checks("15b", fs, recs)
    out["n192"] = recs
    secs["15b traces n=192"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    variants = [TR.Variant(p, True) for p in X.PARADIGMS]
    base = dataclasses.replace(papers_cfg(graph, sz),
                               fanout=tuple(sz.mb_fanout))
    if dev.type == "cpu":
        # the CPU rehearsal runs the kernels' plain versions, which take
        # bf16 inputs back to f32 in torch (the kernels do it in
        # registers): rehearse the control flow in f32
        base = dataclasses.replace(base, dtype="float32")
    full_fs, full = [], []
    for v in variants:
        f, r = TR.audit_variant(graph, v, dev, base)
        full_fs += f
        full.append(r)
    trace_checks("15c", full_fs, full, variants)
    out["full_width"] = full
    secs["15c traces full width"] = time.perf_counter() - t0
    E.drop_device_cache(graph)
    t0 = time.perf_counter()
    out["pipelines"] = pipeline_phase(dev)
    secs["15d pipeline check"] = time.perf_counter() - t0
    out["seconds"] = secs
    return out


# ---------------------------------------------------------------------------
# phase 16: the fault-tolerance surface under concurrency
# ---------------------------------------------------------------------------

#: the reference chaos test's scheduling slack over the staleness bound
STALE_SLACK_S = 0.2
#: device memory a phase-16 part may leave behind
MEM_SLACK = 64 * 2 ** 20


def threads_now() -> set:
    return {t.ident for t in threading.enumerate()}


def check_threads(before: set, what: str) -> None:
    """Every thread started since ``before`` has ended (the scheduler's,
    the batcher's, the chunk stream's worker)."""
    deadline = time.monotonic() + 10.0
    while threads_now() - before and time.monotonic() < deadline:
        time.sleep(0.01)
    left = [t for t in threading.enumerate() if t.ident not in before]
    check(not left, f"{what}: threads left running: {left}")


def device_bytes(dev) -> int:
    """Bytes the caching allocator holds for live tensors, without
    cuBLAS's workspaces (one a thread that ran a GEMM: the store's
    scheduler and the server's batcher are new threads each time)."""
    if dev.type != "cuda":
        return 0
    gc.collect()
    torch.cuda.synchronize(dev)
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    return torch.cuda.memory_allocated(dev)


def all_counts() -> dict:
    """Every kernel's launch counter, both libraries."""
    return {**ops.launch_counts(), **fa.launch_counts()}


def reset_all() -> None:
    ops.reset_launches()
    fa.reset_launches()


def chaos_updates(sz: Sizes, n: int, rng) -> list:
    """The writer's stream: every fourth update ``add_edges`` of
    ``ch_edges`` new edges, the others ``ch_rows`` nodes' feature rows."""
    out = []
    for i in range(sz.ch_updates):
        if i % 4 == 3:
            out.append(("edges", rng.choice(n, sz.ch_edges, replace=False),
                        rng.choice(n, sz.ch_edges, replace=False)))
        else:
            out.append(("feats", rng.choice(n, sz.ch_rows, replace=False),
                        rng.normal(size=(sz.ch_rows, 128))
                        .astype(np.float32)))
    return out


def watch_versions(store) -> dict:
    """``{version: final_np}`` of every snapshot ``store`` publishes from
    now on (and the current one), recorded by a wrapper around its
    ``_publish`` (which runs under ``_refresh_mu``, so the snapshot read
    right after is the one it published; a reference to the read-only
    table, so the refresh pays for no copy); and, by wrappers
    of the store's methods, the seconds of every incremental refresh,
    of every ``add_edges`` apply (the CSR rebuild) and of every frontier
    scan (``_referencing``, one a layer of a refresh)."""
    seen = {"final": {}, "refresh_s": [], "apply_edges_s": [],
            "frontier_s": []}

    def record():
        snap = store.snapshot()
        seen["final"][snap.version] = snap.final_np

    publish, refresh = store._publish, store.refresh
    apply_edges, referencing = store._apply_edges, store._referencing

    def publishing(*a, **kw):
        publish(*a, **kw)
        record()

    def refreshing():
        t0 = time.perf_counter()
        info = refresh()
        if info["total_rows"] and not info.get("built"):
            seen["refresh_s"].append(time.perf_counter() - t0)
        return info

    def applying_edges(*a):
        t0 = time.perf_counter()
        apply_edges(*a)
        seen["apply_edges_s"].append(time.perf_counter() - t0)

    def scanning(mask):
        t0 = time.perf_counter()
        out = referencing(mask)
        seen["frontier_s"].append(time.perf_counter() - t0)
        return out

    store._publish, store.refresh = publishing, refreshing
    store._apply_edges, store._referencing = applying_edges, scanning
    record()
    return seen


def chaos_serving(dev, sz: Sizes, graph) -> dict:
    """16a: a ``GNNServer`` over a full-width store, its background
    scheduler on, one writer streaming feature and edge updates while
    ``ch_clients`` threads query with deadlines; the answers against the
    versions they name, the drained table against a fresh plain build."""
    cfg = dataclasses.replace(get_config("gnn-papers100m"),
                              n_nodes=sz.n_serve)
    params = G.init_gnn(torch.Generator().manual_seed(16), cfg, 128,
                        device=dev)
    # the store writes feature updates into its graph's table
    g = dataclasses.replace(graph, feats=graph.feats.copy())
    threads0, mem0 = threads_now(), device_bytes(dev)
    store = EmbeddingStore(params, cfg, g, chunk_size=sz.chunk,
                           max_deg=cfg.max_degree, device=dev)
    store.build()
    seen = watch_versions(store)
    rng = np.random.default_rng(16)
    updates = chaos_updates(sz, graph.n, rng)
    answers, errors, counts = [], [], collections.Counter()
    stop = threading.Event()

    def writer():
        try:
            pace = sz.ch_secs / (len(updates) + 1)
            for kind, a, b in updates:
                if kind == "feats":
                    store.update_features(a, b)
                else:
                    store.add_edges(a, b)
                if stop.wait(pace):
                    return
        except Exception as e:               # noqa: BLE001 - reported
            errors.append(e)

    def client(seed):
        crng = np.random.default_rng(seed)
        while not stop.is_set():
            nodes = crng.integers(0, graph.n, sz.ch_query)
            try:
                ans = server.submit(nodes, with_meta=True).result(
                    timeout=120.0)
            except ServerOverloadedError:
                counts["overload"] += 1
                time.sleep(0.005)
                continue
            except DeadlineExceededError:
                counts["deadline"] += 1
                continue
            except Exception as e:           # noqa: BLE001 - reported
                errors.append(e)
                return
            answers.append((nodes, ans))

    # ---- the main path, between the launch-count reset and its read
    reset_all()
    server = GNNServer(store, max_batch=4 * sz.ch_query, max_wait_ms=2.0,
                       queue_depth=2, overload="fail",
                       default_deadline_s=sz.ch_deadline_s,
                       max_staleness_s=sz.ch_stale_s,
                       refresh_every_updates=8, refresh_budget_ms=250.0)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=writer)] + [
        threading.Thread(target=client, args=(100 + i,))
        for i in range(sz.ch_clients)]
    try:
        for t in threads:
            t.start()
        stop.wait(sz.ch_secs)
        stop.set()
        for t in threads:
            t.join(timeout=180.0)
        check(not any(t.is_alive() for t in threads),
              "16a: a writer or client thread did not end")
        wall = time.perf_counter() - t0
        # the WAL drains: the scheduler catches up with the last updates
        deadline = time.monotonic() + 120.0
        while store.dirty and time.monotonic() < deadline:
            time.sleep(0.01)
        check(not store.dirty and store.pending_updates() == 0,
              f"16a: the WAL did not drain: {store.refresh_stats()}")
        last = server.submit(np.arange(min(graph.n, sz.ch_query)),
                             with_meta=True, deadline_s=None
                             ).result(timeout=120.0)
    finally:
        stop.set()
        server.close()
    sync(dev)
    c16 = all_counts()
    # ---- end of the main path
    # the batcher's and the scheduler's threads (and the build's chunk
    # stream worker) have ended
    check_threads(threads0, "16a")
    st, rs = server.stats(), store.refresh_stats()
    check(not errors, f"16a: errors other than overload and deadline: "
                      f"{errors[:3]}")
    check(answers, "16a: no query was answered")
    stale = max(a.staleness_s for _, a in answers)
    # the drained table against a fresh build on the plain path
    plain = dataclasses.replace(cfg, use_agg_kernel=False)
    fresh = EmbeddingStore(params, plain, dataclasses.replace(
        store.graph, feats=store.graph.feats.copy()), chunk_size=sz.chunk,
        max_deg=cfg.max_degree, device=dev)
    fresh.build()
    row_err = [row_rel_err(a, b) for a, b in zip(store.layers, fresh.layers)]
    del fresh

    def mean_max(xs):
        return [sum(xs) / len(xs), max(xs)] if xs else None

    out = dict(
        p50_ms=st["p50_ms"], p99_ms=st["p99_ms"], qps=st["qps"],
        answered=len(answers), requests=st["n_requests"],
        queries=st["n_queries"], batches=st["n_batches"],
        wall_s=wall, versions=len(seen["final"]),
        refreshes=rs["refreshes"], sched_refreshes=rs["sched_refreshes"],
        forced_refreshes=st["n_forced_refresh"],
        builds=rs["builds"], degraded_builds=rs["degraded_builds"],
        refresh_s_mean_max=mean_max(seen["refresh_s"]),
        apply_edges_s_mean_max=mean_max(seen["apply_edges_s"]),
        frontier_scan_s_mean_max=mean_max(seen["frontier_s"]),
        staleness_max_s=stale, staleness_bound_s=sz.ch_stale_s,
        shed=st["n_shed"], overload=st["n_overload"],
        client_deadline=counts["deadline"],
        client_overload=counts["overload"], updates=len(updates),
        row_rel_err_vs_fresh_plain=row_err, counts=c16)
    print(f"16a serving under chaos ({card_tag()}): {len(answers)} answers "
          f"of {sz.ch_query} nodes from {sz.ch_clients} clients in "
          f"{wall:.2f} s beside {len(updates)} updates: "
          f"p50_ms={st['p50_ms']:.4f} p99_ms={st['p99_ms']:.4f} "
          f"qps={st['qps']:.1f}", flush=True)
    print(f"16a refreshes: {rs['refreshes']} incremental "
          f"({rs['sched_refreshes']} by the scheduler, "
          f"{st['n_forced_refresh']} forced by the staleness bound), "
          f"{len(seen['final'])} versions; incremental refresh s [mean, "
          f"max] {out['refresh_s_mean_max']}, of which add_edges applies "
          f"{out['apply_edges_s_mean_max']} and frontier scans (one a "
          f"layer) {out['frontier_scan_s_mean_max']}; largest staleness "
          f"{stale:.3f} s (bound {sz.ch_stale_s} s); shed {st['n_shed']}, "
          f"overload {st['n_overload']}; row_rel_err vs a fresh plain "
          f"build {row_err}; launches {c16}", flush=True)
    argmax = {v: np.argmax(f, -1) for v, f in seen["final"].items()}
    bad = [a.snapshot_version for nodes, a in answers
           if not np.array_equal(a.preds, argmax[a.snapshot_version][nodes])]
    check(not bad, f"16a: {len(bad)} answers differ from the argmax of the "
                   f"version they name (first: {bad[:3]})")
    check(last.snapshot_version == store.version
          and np.array_equal(last.preds, argmax[store.version]
                             [np.arange(len(last.preds))]),
          "16a: the drained answer is not the last version's")
    check(stale <= sz.ch_stale_s + STALE_SLACK_S,
          f"16a: an answer {stale:.3f} s stale, beyond {sz.ch_stale_s} + "
          f"{STALE_SLACK_S} s")
    if dev.type == "cuda":
        check(c16["tiled"] > 0, f"16a: the tiled forward never ran: {c16}")
    check(c16["backward"] == c16["backward_csr"]
          == c16["backward_identity"] == 0,
          f"16a: serving launched a backward kernel: {c16}")
    check(max(row_err) <= FWD_ROW_TOL[torch.bfloat16],
          f"16a: drained table vs a fresh plain build row_rel_err {row_err} "
          f"beyond 2^-8")
    # the class's methods again
    del store._publish, store.refresh, store._apply_edges, \
        store._referencing
    del seen, answers, argmax
    return out, store, threads0, mem0


def chaos_failpoints(dev, sz: Sizes, store) -> dict:
    """16b: crashes in the scheduler thread at each store failpoint (and
    one mid-layer in the degrade build, with the chunk stream's worker
    live) keep the old snapshot serving bit-equal at its version and
    leave no thread; a fatal fault degrades to one full build, bit-equal
    to a second build."""
    rng = np.random.default_rng(161)
    probe = np.arange(min(store.graph.n, sz.ch_query))
    out = {}
    # the injected crash ends the scheduler thread by design: record it
    # instead of printing its traceback
    died = []
    hook, threading.excepthook = threading.excepthook, died.append
    plans = (("store.mid_layer_refresh", faults.SimulatedCrash, ()),
             ("store.before_swap", faults.SimulatedCrash, ()),
             ("store.mid_layer_refresh", faults.FatalSamplerFault,
              ("infer.after_layer",)))
    for fp, exc, also in plans:
        before = threads_now()
        snap0, v0 = store.snapshot(), store.version
        keep = snap0.final_np.copy()
        tables = [t.clone() for t in snap0.layers]
        nodes = rng.choice(store.graph.n, sz.ch_rows, replace=False)
        with contextlib.ExitStack() as armed:
            armed.enter_context(faults.armed(fp, exc=exc))
            for name in also:
                armed.enter_context(faults.armed(name))
            armed.enter_context(warnings.catch_warnings())
            warnings.simplefilter("ignore", RuntimeWarning)
            store.start_scheduler(refresh_every_updates=1,
                                  refresh_budget_ms=None, tick_s=0.002)
            try:
                store.update_features(nodes, rng.normal(
                    size=(sz.ch_rows, 128)).astype(np.float32))
                t = store._sched_thread
                t.join(timeout=120.0)
                check(not t.is_alive(),
                      f"16b {fp}: the scheduler thread survived the crash")
            finally:
                store.stop_scheduler()
        label = fp + ("+" + "+".join(also) if also else "")
        check(store.version == v0 and store.snapshot() is snap0
              and store.dirty, f"16b {label}: the version moved or the "
                               f"update was lost")
        check(np.array_equal(store.snapshot().final_np, keep)
              and all(torch.equal(a, b)
                      for a, b in zip(store.snapshot().layers, tables)),
              f"16b {label}: the serving snapshot changed")
        preds, ver, _ = store.predict_meta(probe)
        check(ver == v0 and np.array_equal(preds,
                                           np.argmax(keep[probe], -1)),
              f"16b {label}: the old snapshot does not answer")
        check_threads(before, f"16b {label}")
        check(len(died) == 1 and died.pop().exc_type is faults.SimulatedCrash,
              f"16b {label}: the scheduler thread did not die of the crash")
        out[label] = {"version": v0, "bit_equal": True}
        del tables
    threading.excepthook = hook
    # a fatal fault: one degrade to a full build, bit-equal to build()
    before = threads_now()
    degraded0 = store.refresh_stats()["degraded_builds"]
    with faults.armed("store.mid_layer_refresh", exc=faults.FatalSamplerFault):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            info = store.refresh_with_recovery(max_retries=1,
                                               backoff_s=0.001)
            sync(dev)
            degrade_s = time.perf_counter() - t0
    check(info.get("degraded") is True and not store.dirty
          and store.refresh_stats()["degraded_builds"] == degraded0 + 1
          and any("DEGRADING" in str(w.message) for w in caught),
          f"16b: the fatal fault did not degrade to one build: {info}")
    first = [t.clone() for t in store.layers]
    store.build()
    check(all(torch.equal(a, b) for a, b in zip(first, store.layers)),
          "16b: the degrade build differs from a second build()")
    check_threads(before, "16b degrade")
    out["degrade"] = {"seconds": degrade_s, "bit_equal_to_build": True,
                      "rows_per_layer": info["rows_per_layer"]}
    print(f"16b failpoints in the scheduler thread: "
          f"{[k for k in out if k != 'degrade']} kept "
          f"the old snapshot bit-equal at its version, no thread left; the "
          f"fatal fault degraded to one build in {degrade_s:.3f} s, "
          f"bit-equal to build()", flush=True)
    return out


def run_main(fn, argv) -> tuple:
    """``fn(argv)`` in-process between a launch-count reset and its read,
    its stdout captured: (rc, stdout, launch counts, seconds)."""
    buf = io.StringIO()
    reset_all()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue(), all_counts(), time.perf_counter() - t0


def example_args(sz: Sizes, dev) -> dict:
    """The examples' argv: the reference's default sizes on the card (the
    CPU rehearsal's are tiny), the kernels on where they have one."""
    argv = {"quickstart": ["--kernel"],
            "full_vs_minibatch": ["--kernel"],
            "serve_batched": ["--kernel"],
            "lm_pretrain_smoke": []}
    if sz.ex_tiny:
        argv["quickstart"] += ["--n", "200", "--iters", "5"]
        argv["full_vs_minibatch"] += ["--n", "200", "--iters", "4", "--b",
                                      "32", "--beta", "3", "2"]
        argv["serve_batched"] += ["--gen", "4"]
        argv["lm_pretrain_smoke"] += ["--steps", "2"]
    return {k: v + ["--device", dev.type] for k, v in argv.items()}


def parse_example(name: str, text: str) -> dict:
    """The numbers each example prints, checked for form and finiteness."""
    lines = text.strip().splitlines()
    if name == "quickstart":
        got = {}
        for line in lines[1:3]:
            m = re.fullmatch(r"(\S+) +loss (\S+) -> (\S+)  iter-to-loss"
                             r"\(0\.5\)=(\S+)  test acc (\S+)", line)
            check(m is not None, f"16d quickstart: line {line!r}")
            got[m.group(1)] = [float(m.group(2)), float(m.group(3)),
                               float(m.group(5))]
        check(set(got) == {"full-graph", "mini-batch"}
              and all(np.isfinite(v).all() for v in got.values()),
              f"16d quickstart: {got}")
        return got
    if name == "full_vs_minibatch":
        report = json.loads(text[text.index("\n{") + 1:])
        rows = (report["full_graph"], report["mini_batch"])
        check(all(np.isfinite(r["final_loss"]) and r["iters"] > 0
                  for r in rows), f"16d full_vs_minibatch: {report}")
        return {k: report[k] for k in ("thm3_delta(beta,b)",
                                       "delta_full_mini_mean")} | {
            p: {k: r[k] for k in ("first_loss", "final_loss", "test_acc",
                                  "throughput_nodes_s")}
            for p, r in zip(("full_graph", "mini_batch"), rows)}
    if name == "serve_batched":
        m = re.fullmatch(r"prefill: (\S+)s \(batch=\d+, prompt=\d+\)",
                         lines[0])
        d = re.fullmatch(r"decode: \d+ steps, (\S+) tok/s \(batched\)",
                         lines[1])
        check(m is not None and d is not None
              and lines[2].startswith("sample: "),
              f"16d serve_batched: {lines}")
        return {"prefill_s": float(m.group(1)),
                "decode_tok_s": float(d.group(1)),
                "sample": json.loads(lines[2][len("sample: "):])}
    result = json.loads(lines[-1])
    check(set(result) == {"arch", "first_loss", "final_loss", "steps"}
          and np.isfinite(result["final_loss"]),
          f"16d lm_pretrain_smoke: {result}")
    return result


def examples_phase(dev, sz: Sizes) -> dict:
    """16d: the four examples in-process at the reference's default sizes,
    each with exit code 0, its output parsed and its launches counted."""
    from repro_torch.examples import (full_vs_minibatch, lm_pretrain_smoke,
                                      quickstart, serve_batched)
    mods = {"quickstart": quickstart, "full_vs_minibatch": full_vs_minibatch,
            "serve_batched": serve_batched,
            "lm_pretrain_smoke": lm_pretrain_smoke}
    out = {}
    for name, argv in example_args(sz, dev).items():
        rc, text, counts, secs = run_main(mods[name].main, argv)
        check(rc == 0, f"16d {name}: exit code {rc}")
        out[name] = {"rc": rc, "seconds": secs, "counts": counts,
                     "output": parse_example(name, text)}
        print(f"16d example {name} {' '.join(argv)}: rc {rc} in {secs:.2f} s, "
              f"launches {counts}, output {out[name]['output']}", flush=True)
    if dev.type == "cuda":
        for name in ("quickstart", "full_vs_minibatch"):
            check(out[name]["counts"]["tiled"] > 0,
                  f"16d {name}: the tiled forward never ran")
        fl = out["serve_batched"]["counts"]
        check(fl["wgmma"] + fl["tf32x3"] > 0,
              f"16d serve_batched: no flash kernel ran: {fl}")
    lm = out["lm_pretrain_smoke"]["counts"]
    check(not any(lm.values()),
          f"16d lm_pretrain_smoke: LM training launched kernels: {lm}")
    return out


def chaos_phase(dev, sz: Sizes, graph) -> dict:
    """Phase 16 (16a-d): serving under chaos, the failpoints in the
    scheduler thread, the sweep-resume smoke, the examples."""
    secs, out = {}, {}
    t0 = time.perf_counter()
    out["16a"], store, threads0, mem0 = chaos_serving(dev, sz, graph)
    secs["16a serving under chaos"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["16b"] = chaos_failpoints(dev, sz, store)
    del store
    check_threads(threads0, "16a-b")
    mem = device_bytes(dev)
    check(mem - mem0 <= MEM_SLACK, f"16a-b: device memory {mem - mem0} B "
                                   f"above where it started")
    out["16a"]["device_bytes_left"] = mem - mem0
    secs["16b failpoints"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    from repro_torch.ci import sweep_resume_smoke
    rc, text, counts, s = run_main(sweep_resume_smoke.main,
                                   ["--device", dev.type, "--kernel"])
    check(rc == 0 and "grid completed" in text
          and "journal: skipping completed point" in text,
          f"16c: the sweep-resume smoke failed: {text[-2000:]}")
    if dev.type == "cuda":
        check(counts["tiled"] > 0, f"16c: the tiled forward never ran")
    out["16c"] = {"rc": rc, "seconds": s, "counts": counts}
    print(f"16c sweep_resume_smoke --kernel: rc {rc} in {s:.2f} s, "
          f"launches {counts}", flush=True)
    secs["16c sweep-resume smoke"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["16d"] = examples_phase(dev, sz)
    secs["16d examples"] = time.perf_counter() - t0
    out["seconds"] = secs
    return out


def phase16_paths(p16: dict) -> dict:
    """Phase 16's paths and the launch counts of each."""
    return {"serve_chaos": p16["16a"]["counts"],
            "sweep_resume_smoke": p16["16c"]["counts"],
            **{f"example_{k}": v["counts"] for k, v in p16["16d"].items()}}


def add_phase16(kernels: list, p16: dict) -> None:
    """Each kernel entry's launches on phase 16's paths, read from its
    counter."""
    paths = phase16_paths(p16)
    for kern in kernels:
        key = PHASE13[kern["name"]][0]
        kern["launches_phase16"] = {p: c[key] for p, c in paths.items()}


# ---------------------------------------------------------------------------
# phase 17: tensor parallelism (model = 2 on the card)
# ---------------------------------------------------------------------------

TP_TOL = 2e-2           # model = 2 against model = 1, bf16


def tp_cfg(arch: str, sz: Sizes, layers: int = 0):
    """The arch's full config (depth cut to ``layers``); on the CPU its
    smoke config with 16 heads of 16, so the heads split as at full
    width."""
    if sz.tp_smoke:
        return dataclasses.replace(get_config(arch, smoke=True), n_heads=16,
                                   n_kv_heads=4, head_dim=16)
    return family_cfg(arch, sz, layers)


def p17_cfg(name: str, sz: Sizes):
    """Phases 17 and 19's configs: ``stablelm`` (stablelm-1.6b whole) or
    ``llama4`` (llama4-scout at ``l4_layers``; on the CPU 2 KV heads and
    16 experts, so both split)."""
    if name == "stablelm":
        return tp_cfg("stablelm-1.6b", sz)
    cfg = tp_cfg("llama4-scout-17b-a16e", sz, sz.l4_layers)
    if sz.tp_smoke:
        cfg = dataclasses.replace(cfg, n_kv_heads=2, n_experts=16)
    return cfg


def tp_counted(dev, fn):
    """``fn()`` between a reset and a read of every launch counter and of
    the mesh's collective tally: (result, seconds, launches, bytes)."""
    ops.reset_launches()
    fa.reset_launches()
    SH.reset_collectives()
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return (out, time.perf_counter() - t0, all_counts(),
            SH.collective_counts())


def tp_line(label: str, secs: float, counts: dict, coll: dict) -> None:
    print(f"{label}: {secs:.3f} s; flash launches wgmma={counts['wgmma']} "
          f"tf32x3={counts['tf32x3']}; collective bytes a device "
          f"{json.dumps(coll)}", flush=True)


def tp_tokens(cfg, b: int, s: int, decode: int = 0):
    """The prompt [b, s] of phases 17 and 19 and ``decode`` decode tokens
    [b, 1], from fixed seeds (numpy)."""
    rng = np.random.default_rng(19)
    return (np.random.default_rng(17).integers(0, cfg.vocab_size, (b, s)),
            [rng.integers(0, cfg.vocab_size, (b, 1)) for _ in range(decode)])


def tp_prefill_case(dev, sz: Sizes, cfg, label: str, s: int, b: int,
                    moe: bool = False, f32_twin: bool = False,
                    decode: int = 0) -> dict:
    """One bf16 prefill at model = 1, then its weights split over a
    ``model = 2`` mesh on the card and the same prefill counted (MoE
    routing replayed from the first run).  ``f32_twin``: both also held
    against the same weights run in f32 (outside the counted window), to
    read the model = 2 gap beside bf16's own rounding.  ``decode``: that
    many decode steps after the model = 1 prefill (its cache sized for
    them), their logits kept for phase 19a."""
    mesh = make_host_mesh(2, devices=(dev, dev))
    params = M.init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                          dev, dtype=M._dt(cfg))
    prompt, dec_toks = tp_tokens(cfg, b, s, decode)
    batch = {"tokens": torch.as_tensor(prompt, device=dev)}
    n_attn = M.causal_attention_layers(cfg)
    route = fa.kernel_route(M._dt(cfg), cfg.resolved_head_dim)
    with torch.inference_mode():
        with observed() as seen:
            (one, cache), one_s, one_counts, _ = tp_counted(
                dev, lambda: steps.make_prefill_step(cfg)(params, batch,
                                                          s + decode))
        serve = steps.make_serve_step(cfg)
        dec_one = []
        for t in dec_toks:
            lg, cache = serve(params, cache, torch.as_tensor(t, device=dev))
            dec_one.append(lg.cpu())
        del cache
        twin = None
        if f32_twin:
            p32 = tree_map_only(torch.Tensor, lambda t: t.float(), params)
            twin = steps.make_prefill_step(dataclasses.replace(
                cfg, dtype="float32"))(p32, batch)[0]
            del p32
        ps = M.shard_params(params, cfg, mesh)
        del params
        attn = ps[0]["runs"][0]["attn"]
        hq = attn["wq"].shape[2]
        check(hq * 2 == SH.padded_heads(cfg.n_heads),
              f"{label}: {hq} query heads a shard of "
              f"{SH.padded_heads(cfg.n_heads)}")
        if moe:
            e_loc = ps[0]["runs"][0]["moe"]["w_gate"].shape[1]
            check(e_loc * 2 == cfg.n_experts,
                  f"{label}: {e_loc} experts a shard of {cfg.n_experts}")
        else:
            check(ps[0]["runs"][0]["mlp"]["w_up"].shape[-1] * 2 == cfg.d_ff,
                  f"{label}: d_ff not split")
        check(ps[0]["embed"].shape[0] * 2 == M._vp(cfg),
              f"{label}: the vocab not split")
        prefill = steps.make_prefill_step(cfg, mesh)
        replay = [e for e in seen["experts"] for _ in range(2)]
        with observed(replay=replay if moe else None):
            (two, caches), two_s, counts, coll = tp_counted(
                dev, lambda: prefill(ps, batch))
    tp_line(f"17 {label} model=1 prefill", one_s, one_counts, {})
    tp_line(f"17 {label} model=2 prefill", two_s, counts, coll)
    want = {r: 2 * n_attn if r == route else 0 for r in fa.ROUTES}
    check_launch(dev, {r: counts[r] for r in fa.ROUTES} == want,
                 f"{label}: flash launches {counts} against {want} (one a "
                 f"shard a layer)")
    check(coll.get("reduce-scatter", 0) > 0 and coll.get("all-gather", 0) > 0,
          f"{label}: no reduce-scatter / all-gather counted: {coll}")
    kv = caches[0]["runs"][0]["k"].shape[3]
    err = logits_err(cfg, two, one)
    print(f"17 {label}: {hq} query heads and {kv} KV heads a shard; "
          f"last logits model=2 vs model=1 relative max error {err:.4g} "
          f"(limit {TP_TOL})", flush=True)
    check(bool(torch.isfinite(two[..., :cfg.vocab_size]).all()),
          f"{label}: a logit is not finite")
    check(err <= TP_TOL, f"{label}: model=2 logits rel err {err} beyond "
          f"{TP_TOL}")
    f32_errs = None
    if twin is not None:
        f32_errs = {"model1_vs_f32": logits_err(cfg, one, twin),
                    "model2_vs_f32": logits_err(cfg, two, twin)}
        print(f"17 {label}: the same weights in f32: model=1 vs f32 "
              f"{f32_errs['model1_vs_f32']:.4g}, model=2 vs f32 "
              f"{f32_errs['model2_vs_f32']:.4g} (bf16's own rounding)",
              flush=True)
        # the split itself adds no error beyond bf16's own (and the f32
        # forward's 1e-5 for its own order of summation)
        check(f32_errs["model2_vs_f32"] <= f32_errs["model1_vs_f32"] + 1e-5,
              f"{label}: model=2 is further from the f32 run than model=1: "
              f"{f32_errs}")
    del ps, caches
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return dict(seconds_model1=one_s, seconds=two_s, counts=counts,
                collective_bytes=coll, rel_err=err, heads_a_shard=hq,
                kv_heads_a_shard=kv, launches=counts[route],
                f32_twin=f32_errs, logits=two.cpu(), logits_model1=one.cpu(),
                decode_model1=dec_one, decode_tokens=dec_toks,
                replay=([e.cpu().numpy() for e in seen["experts"]] if moe
                        else None))


def tp_train_case(dev, sz: Sizes, cfg, label: str) -> dict:
    """``tp_steps`` train steps at model = 1 and at model = 2 from the same
    weights and batches: each loss within ``TP_TOL``."""
    mesh = make_host_mesh(2, devices=(dev, dev))
    gen = token_batches(cfg.vocab_size, sz.tp_b, sz.tp_train_s, seed=17)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in next(gen).items()}
               for _ in range(sz.tp_steps)]

    def fresh():
        return M.init_model(torch.Generator(device=dev).manual_seed(1), cfg,
                            dev)

    def train(mesh_):
        p = fresh()
        if mesh_ is not None:
            p = M.shard_params(p, cfg, mesh_)
        opt, step = steps.make_train_step(cfg, mesh=mesh_)
        st = opt.init(p) if mesh_ is None else [opt.init(x) for x in p]
        losses = []
        for bt in batches:
            p, st, m = step(p, st, bt)
            losses.append(float(m["loss"]))
        return losses
    one, one_s, _, _ = tp_counted(dev, lambda: train(None))
    gc.collect()
    two, two_s, counts, coll = tp_counted(dev, lambda: train(mesh))
    gc.collect()
    tp_line(f"17 {label} model=1 {sz.tp_steps} train steps", one_s, {
        "wgmma": 0, "tf32x3": 0}, {})
    tp_line(f"17 {label} model=2 {sz.tp_steps} train steps", two_s, counts,
            coll)
    errs = [abs(a - b) / abs(b) for a, b in zip(two, one)]
    print(f"17 {label}: losses model=1 {one}, model=2 {two}; relative "
          f"errors {[round(e, 8) for e in errs]} (limit {TP_TOL})",
          flush=True)
    check(all(math.isfinite(x) for x in two), f"{label}: a loss is not "
          f"finite")
    check(max(errs) <= TP_TOL, f"{label}: model=2 losses off by {errs}")
    return dict(seconds_model1=one_s, seconds=two_s, counts=counts,
                collective_bytes=coll, losses=two, losses_model1=one,
                rel_err=max(errs))


def tp_phase(dev, sz: Sizes) -> dict:
    """17: tensor parallelism on a model = 2 mesh on the card."""
    secs = {}
    out = {}
    t0 = time.perf_counter()
    cfg = p17_cfg("stablelm", sz)
    if not sz.tp_smoke:
        check(cfg.n_heads == 32 and cfg.d_model == 2048 and cfg.n_layers == 24
              and cfg.dtype == "bfloat16", f"unexpected stablelm {cfg}")
    out["17a prefill"] = tp_prefill_case(dev, sz, cfg, "17a stablelm-1.6b",
                                         sz.tp_s, sz.tp_b, f32_twin=True,
                                         decode=P19_DECODE)
    secs["17a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["17b train"] = tp_train_case(dev, sz, cfg, "17b stablelm-1.6b")
    secs["17b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = p17_cfg("llama4", sz)
    out["17c moe prefill"] = tp_prefill_case(
        dev, sz, cfg, "17c llama4-scout", sz.tp_l4_s, 1, moe=True)
    secs["17c"] = time.perf_counter() - t0
    rounded = {k: round(v, 2) for k, v in secs.items()}
    print(f"17 seconds: {json.dumps(rounded)}", flush=True)
    out["seconds"] = secs
    return out


def add_phase17(kernels: list, p17: dict) -> None:
    """Each kernel entry's launches on phase 17's paths."""
    paths = {"tp_prefill_stablelm_model2": p17["17a prefill"]["counts"],
             "tp_train_stablelm_model2": p17["17b train"]["counts"],
             "tp_prefill_llama4_model2": p17["17c moe prefill"]["counts"]}
    for kern in kernels:
        key = PHASE13[kern["name"]][0]
        kern["launches_phase17"] = {p: c[key] for p, c in paths.items()}


# ---------------------------------------------------------------------------
# phase 18: the NODES-sharded paths one process a rank
# ---------------------------------------------------------------------------

GRAPH_ARRAYS = ("indptr", "indices", "feats", "labels", "train_mask",
                "val_mask", "test_mask")
#: seconds a phase-18 spawn may take before its ranks are ended
P18_JOIN_S = 400.0
#: 18c's steps of each run
P18C_STEPS = 3


def save_graph(graph, root: str) -> None:
    """The graph's arrays as ``.npy`` files under ``root``, for the
    ranks to memory-map."""
    for name in GRAPH_ARRAYS:
        np.save(os.path.join(root, name + ".npy"), getattr(graph, name))


def load_graph(root: str) -> Graph:
    """The graph ``save_graph`` wrote, its arrays memory-mapped: a rank
    reads its rows of the features and whatever else it touches."""
    arrs = {name: np.load(os.path.join(root, name + ".npy"), mmap_mode="r")
            for name in GRAPH_ARRAYS}
    return Graph(n=int(arrs["labels"].shape[0]), **arrs)


def full_precision() -> None:
    """Full f32 products everywhere (TF32 off), bf16 GEMMs reduce in
    f32: every process of the script runs so."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False


def transport_check(tr) -> dict:
    """One call of each collective of the transport on the rank's device
    (f32 and bf16) and a barrier: at world size 1 each returns its part
    itself."""
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.arange(24, device=tr.device).reshape(6, 4).to(dt)
        want = torch.cat([x] * tr.world)
        out[str(dt)] = (torch.equal(tr.all_gather(x), want)
                        and tr.all_reduce(x).dtype == dt
                        and tr.reduce_scatter(want).dtype == dt)
        if tr.world == 1:
            out[str(dt)] &= (torch.equal(tr.all_reduce(x), x)
                             and torch.equal(tr.reduce_scatter(x), x))
    tr.barrier()
    return out


def phase18_rank(rank, world, init, root, sz, device, cases, threads,
                 lm=()):
    """One rank of phase 18 (run by ``procs.spawn``): its process group
    on ``device``'s layout, the graph memory-mapped from ``root``, and
    each case of ``cases`` trained on the process-group mesh between a
    launch-count reset and its read.  ``threads``: the parent's intra-op
    threads (a CPU reduction's order follows them, and 18a compares bits
    with the parent's runs).  Returns each case's run record, launches,
    wall and steady step times, the card's peak bytes of this process
    and the bytes of the rows it holds.  Then each phase-19 case of
    ``lm`` (``P19_CASES``: name and arguments) on the same transport,
    with its wall seconds."""
    full_precision()
    torch.set_num_threads(threads)
    tr = procs.init(rank, world, init, device=device)
    mesh = SH.process_node_mesh(tr)
    dev = mesh.devices[0]
    graph = load_graph(root)
    cfg = papers_cfg(graph, sz)
    out = {"transport": tr.name, "device": str(dev)}
    if tr.name == "nccl":
        out["nccl_check"] = transport_check(tr)
    for case, steps in cases:
        if case == "minibatch_sharded":
            c = cfg
            plan = E.TrainPlan(lr=TRAIN_LR, n_iters=steps,
                               eval_every=sz.sh_mb_steps, seed=0)
            src = E.ShardedSampledSource(batch_size=sz.mb_b, mesh=mesh)
        else:
            c = (dataclasses.replace(cfg, feats_layout="sharded")
                 if case == "featshard" else cfg)
            plan = E.TrainPlan(lr=TRAIN_LR, n_iters=steps,
                               eval_every=sz.sh_fg_steps, seed=0)
            src = E.ShardedFullGraphSource(max_deg=cfg.max_degree,
                                           mesh=mesh)
        base = peak_reset(dev)
        trainer = E.Trainer(graph, c, plan, source=src, device=dev)
        held = {name: (tuple(t.shape), t.numel() * t.element_size())
                for name, t in zip(("idx", "w", "w_self", "feats",
                                    "labels"), src.ell)}
        ops.reset_launches()
        FS.reset_launches()
        sync(dev)
        t0 = time.perf_counter()
        try:
            res = trainer.run()
            sync(dev)
        finally:
            trainer.close()
        out[case] = dict(
            run=run_record(res), counts=sharded_counts(),
            wall_s=time.perf_counter() - t0, ms_step=steady_ms(res.history),
            held=held, base_bytes=base,
            peak_bytes=(torch.cuda.max_memory_allocated(dev)
                        if dev.type == "cuda" else 0))
        E.drop_device_cache(graph)
    del graph
    for name, kw in lm:
        free_card(dev)
        t0 = time.perf_counter()
        out[name] = P19_CASES[name](tr, sz, **kw)
        out[name]["wall_s"] = time.perf_counter() - t0
    return out


def close_runs(got: dict, want: dict, tol: float, what: str,
               steps: Optional[int] = None) -> float:
    """``got``'s losses (the first ``steps`` of ``want``'s) and, when the
    runs are as long, final parameters within ``tol`` relative of
    ``want``'s: the largest relative error."""
    n = steps or len(want["losses"])
    a = torch.tensor(got["losses"], dtype=torch.float64)
    b = torch.tensor(want["losses"][:n], dtype=torch.float64)
    check(a.shape == b.shape and bool(torch.isfinite(a).all()),
          f"{what}: losses {got['losses']}")
    errs = [rel_err(a, b)]
    if steps is None:
        for p, q in zip(got["params"], want["params"]):
            errs += [rel_err(torch.from_numpy(p[k]).double(),
                             torch.from_numpy(q[k]).double()) for k in p]
    err = max(errs)
    check(err <= tol, f"{what}: relative error {err} beyond {tol} "
          f"(losses {got['losses']} vs {want['losses'][:n]})")
    return err


def equal_runs(got: dict, want: dict, what: str) -> None:
    """Two run records bit-equal: History's losses and evaluations, the
    test accuracy and every final parameter."""
    for f in ("losses", "val_accs", "test_acc"):
        check(got[f] == want[f], f"{what}: {f} {got[f]} != {want[f]}")
    for p, q in zip(got["params"], want["params"]):
        for k in p:
            check(np.array_equal(p[k], q[k]), f"{what}: parameter {k} "
                  f"differs")


def same_on_every_rank(runs: list, case: str) -> None:
    """Every rank logs the same (all-reduced) losses and ends with the
    same parameters."""
    for r in runs[1:]:
        equal_runs(r[case]["run"], runs[0][case]["run"],
                   f"18 {case}: rank vs rank 0")


def procs_18a(sz, root, own, s1) -> dict:
    """18a: world size 1 over the run's own transport (NCCL on the
    card): both paradigms bit-equal to phase 12a's one-shard runs."""
    cases = (("fullgraph_sharded", sz.sh_fg_steps),
             ("minibatch_sharded", sz.sh_mb_steps))
    r = procs.spawn(phase18_rank, 1,
                    (root, sz, own, cases, torch.get_num_threads()),
                    timeout_s=P18_JOIN_S, init_dir=root)[0]
    if own != "cpu":
        check(r["transport"] == "nccl" and all(r["nccl_check"].values()),
              f"18a: transport {r['transport']}, checks {r.get('nccl_check')}")
    for case, _ in cases:
        equal_runs(r[case]["run"], s1[case]["run"],
                   f"18a {case} world 1 vs phase 12a S=1")
        check_launch(torch.device(own),
                     r[case]["counts"] == s1[case]["counts"],
                     f"18a {case}: launches {r[case]['counts']} != phase "
                     f"12a's {s1[case]['counts']}")
        print(f"18a {case} world 1 ({r['transport']}, {r['device']}): "
              f"{len(r[case]['run']['losses'])} steps bit-equal to phase "
              f"12a's one-shard run (and so to the unsharded source), "
              f"launches {r[case]['counts']}, {r[case]['ms_step']:.2f} "
              f"ms/step ({card_tag()})", flush=True)
    return r


def procs_18b(sz, graph, root, shared, s1, s4, p17) -> list:
    """18b: S processes on the one card, fullgraph_sharded with the
    kernels: within 2e-2 of phase 12b's single-process S-shard run, each
    rank launching on its own block and holding 1/S of the rows.  The
    ranks then run phase 19b."""
    s = sz.sh_shards
    runs = procs.spawn(phase18_rank, s,
                       (root, sz, shared, (("fullgraph_sharded",
                                            sz.sh_fg_steps),),
                        torch.get_num_threads(), p19_cases(sz, p17, s)),
                       timeout_s=P18_JOIN_S, init_dir=root)
    case = "fullgraph_sharded"
    same_on_every_rank(runs, case)
    err = close_runs(runs[0][case]["run"], s4[case]["run"], 2e-2,
                     f"18b {case} {s} processes vs phase 12b S={s}")
    want = s1["fullgraph"]["counts"]
    k = papers_cfg(graph, sz).max_degree
    n_pad = graph.n + (-graph.n) % s
    m = n_pad // s
    for r in runs:
        got = r[case]["counts"]
        check_launch(torch.device(shared), all(got[q] == want[q] for q in (
            "tiled", "backward_csr", "backward")),
            f"18b rank launches {got}, want the unsharded run's {want} "
            f"(one launch a call, on the rank's own block)")
        held = r[case]["held"]
        ell = held["idx"][1] + held["w"][1]
        check(held["idx"][0] == (m, k) and held["feats"][0][0] == m
              and held["labels"][0] == (m,) and ell == n_pad * k * 8 // s
              and held["feats"][1] == n_pad * graph.feats.shape[1]
              * graph.feats.dtype.itemsize // s,
              f"18b: a rank holds {held}, not 1/{s} of the padded rows")
    ms = [round(r[case]["ms_step"], 2) for r in runs]
    peaks = [r[case]["peak_bytes"] for r in runs]
    held = runs[0][case]["held"]
    print(f"18b {case} {s} processes on one card ({runs[0]['transport']}): "
          f"{len(runs[0][case]['run']['losses'])} steps, losses "
          f"{[round(x, 6) for x in runs[0][case]['run']['losses']]}, "
          f"within {err:.3g} (limit 2e-2) of phase 12b's S={s} run; each "
          f"rank holds {m} of {n_pad} rows: ELL idx + w "
          f"{held['idx'][1] + held['w'][1]} B, features {held['feats'][1]} "
          f"B ({graph.feats.dtype}), labels {held['labels'][1]} B", flush=True)
    print(f"18b peak device bytes a rank (max_memory_allocated of its "
          f"process): {peaks}; phase 12b's single process, its S={s} "
          f"run's peak above what it held before: "
          f"{s4[case]['peak_bytes']}", flush=True)
    print(f"18b ms/step by rank {ms} ({s} processes time-slicing one card: "
          f"not a {s}-card time; {card_tag()})", flush=True)
    return runs


def procs_18c(sz, root, shared, s4, p17) -> list:
    """18c: two processes on the card, minibatch_sharded and the
    featshard layout, a few steps each, within their phase-12b
    tolerances of the single-process runs.  The ranks then run phase
    19a and 19c."""
    steps = P18C_STEPS
    runs = procs.spawn(phase18_rank, 2,
                       (root, sz, shared, (("minibatch_sharded", steps),
                                           ("featshard", steps)),
                        torch.get_num_threads(), p19_cases(sz, p17, 2)),
                       timeout_s=P18_JOIN_S, init_dir=root)
    for case, tol in (("minibatch_sharded", 1e-4), ("featshard", 2e-2)):
        same_on_every_rank(runs, case)
        err = close_runs(runs[0][case]["run"], s4[case]["run"], tol,
                         f"18c {case} 2 processes vs phase 12b", steps)
        counts = [r[case]["counts"] for r in runs]
        if case == "featshard":
            ok = all(c["featshard_phase1"] > 0 and c["featshard_phase2"] > 0
                     and c["backward_csr"] > 0 for c in counts)
        else:
            ok = all(c["tiled"] > 0 and c["backward_identity"] > 0
                     for c in counts)
        check_launch(torch.device(shared), ok,
                     f"18c {case}: launches by rank {counts}")
        print(f"18c {case} 2 processes: {steps} steps, losses "
              f"{[round(x, 6) for x in runs[0][case]['run']['losses']]} "
              f"within {err:.3g} (limit {tol}) of phase 12b's; launches by "
              f"rank {counts}; ms/step by rank "
              f"{[round(r[case]['ms_step'], 2) for r in runs]} (two "
              f"processes time-slicing one card; {card_tag()})", flush=True)
    return runs


def procs_phase(dev, sz: Sizes, graph, shrd: dict, p17: dict) -> dict:
    """Phase 18: the NODES-sharded paths one process a rank, each rank
    holding only its rows, the graph handed to the ranks as memory-mapped
    files: 18a world size 1 over NCCL, 18b S processes on the card over
    the host-staged transport, 18c two processes (mini-batch and
    featshard).  On the CPU the ranks take gloo.  18b's and 18c's ranks
    then run phase 19's cases (``lm_procs_phase`` holds them to phase
    17's)."""
    cuda = dev.type == "cuda"
    own, shared = ("cuda", "cuda:0") if cuda else ("cpu", "cpu")
    E.drop_device_cache(graph)
    if cuda:
        torch.cuda.empty_cache()
    s1, s4 = shrd["12a s1"], shrd["12b s4"]
    secs, out = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_procs_") as root:
        t0 = time.perf_counter()
        save_graph(graph, root)
        secs["18 graph files"] = time.perf_counter() - t0
        for key, fn, args in (
                ("18a world 1", procs_18a, (sz, root, own, s1)),
                ("18b processes", procs_18b, (sz, graph, root, shared, s1,
                                              s4, p17)),
                ("18c mini-batch featshard", procs_18c, (sz, root, shared,
                                                         s4, p17))):
            t0 = time.perf_counter()
            out[key] = fn(*args)
            secs[key] = time.perf_counter() - t0
    rounded = {k: round(v, 2) for k, v in secs.items()}
    print(f"18 seconds: {json.dumps(rounded)}", flush=True)
    out["seconds"] = secs
    return out


def add_phase18(kernels: list, p18: dict, shards: int) -> None:
    """Each kernel entry's launches on phase 18's paths, summed over the
    ranks of each run."""
    runs = {"procs_w1_fullgraph_sharded": ([p18["18a world 1"]],
                                           "fullgraph_sharded"),
            "procs_w1_minibatch_sharded": ([p18["18a world 1"]],
                                           "minibatch_sharded"),
            f"procs_w{shards}_fullgraph_sharded": (p18["18b processes"],
                                                   "fullgraph_sharded"),
            "procs_w2_minibatch_sharded": (p18["18c mini-batch featshard"],
                                           "minibatch_sharded"),
            "procs_w2_featshard": (p18["18c mini-batch featshard"],
                                   "featshard")}
    for kern in kernels:
        key = PHASE13[kern["name"]][0]
        if key not in ops.launch_counts():
            kern["launches_phase18"] = {p: 0 for p in runs}
            continue
        kern["launches_phase18"] = {
            p: sum(r[case]["counts"][key] for r in ranks)
            for p, (ranks, case) in runs.items()}


# ---------------------------------------------------------------------------
# phase 19: the LM's tensor parallelism one process a shard
# ---------------------------------------------------------------------------

#: decode steps of 17a's model = 1 run and of 19a
P19_DECODE = 2
#: 19a's decode logits against 17a's model = 1 decode (PERF.md §2's
#: decode limit)
P19_DECODE_TOL = 5e-2
#: 19b's losses against 17b's model = 2 run, relative
P19_TRAIN_TOL = 1e-4


def free_card(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def host(t) -> np.ndarray:
    """A tensor as f32 numpy (bf16 exactly): what a rank sends back (a
    torch tensor would go through shared memory its exit frees)."""
    return t.detach().float().cpu().numpy()


def leaf_bytes(leaves) -> int:
    return sum(x.numel() * x.element_size() for x in leaves)


def p19_prefill(tr, sz: Sizes, name: str, s: int, b: int, replay=None,
                decode: int = 0) -> dict:
    """19a / 19c on this rank: phase 17's weights (the same seed), only
    this rank's shard drawn (``init_model(mesh=)``) on the ``(1, 2)``
    process mesh, phase 17's prompt prefilled between a reset and a read
    of the launch counters and the collective tally (the MoE routing
    replayed from 17c's model = 1 run), then ``decode`` decode steps."""
    t0 = time.perf_counter()
    cfg = p17_cfg(name, sz)
    mesh = make_process_mesh(2, tr)
    dev = mesh.devices[0]
    mesh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = M.init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                          dev, dtype=M._dt(cfg), mesh=mesh)
    sync(dev)
    init_s = time.perf_counter() - t0
    prompt, dec_toks = tp_tokens(cfg, b, s, decode)
    batch = {"tokens": torch.as_tensor(prompt, device=dev)}
    prefill = steps.make_prefill_step(cfg, mesh)
    serve = steps.make_serve_step(cfg, mesh)
    replay = None if replay is None else [torch.as_tensor(e, device=dev)
                                          for e in replay]
    with torch.inference_mode():
        with observed(replay=replay):
            (logits, caches), secs, counts, coll = tp_counted(
                dev, lambda: prefill(params, batch, s + decode))
        dec = []
        t0 = time.perf_counter()
        for t in dec_toks:
            lg, caches = serve(params, caches, torch.as_tensor(t, device=dev))
            dec.append(host(lg))
        decode_s = time.perf_counter() - t0
    out = dict(logits=host(logits), decode=dec, seconds=secs, counts=counts,
               mesh_s=mesh_s, init_s=init_s, decode_s=decode_s,
               collective_bytes=coll,
               heads=params[0]["runs"][0]["attn"]["wq"].shape[2],
               kv_heads=caches[0]["runs"][0]["k"].shape[3],
               param_bytes=leaf_bytes(tree_leaves(params[0])))
    del params, caches, logits
    free_card(dev)
    return out


def p19_train(tr, sz: Sizes) -> dict:
    """19b on this rank: 17b's weights (only this rank's f32 shard drawn)
    and batches (the global batch on every rank, one row a data
    replica), ``tp_steps`` steps of ``make_train_step`` on the ``(2, 2)``
    process mesh; the losses, the replicated leaves at the end, the
    bytes of the leaves split over both axes beside the whole's, the
    peak bytes of this process and each step's wall milliseconds."""
    cfg = p17_cfg("stablelm", sz)
    t0 = time.perf_counter()
    mesh = make_process_mesh(2, tr)
    mesh_s = time.perf_counter() - t0
    dev = mesh.devices[0]
    gen = token_batches(cfg.vocab_size, sz.tp_b, sz.tp_train_s, seed=17)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in next(gen).items()}
               for _ in range(sz.tp_steps)]
    base = peak_reset(dev)
    t0 = time.perf_counter()
    params = M.init_model(torch.Generator(device=dev).manual_seed(1), cfg,
                          dev, mesh=mesh)
    opt, step = steps.make_train_step(cfg, mesh=mesh)
    st = [opt.init(p) for p in params]
    sync(dev)
    init_s = time.perf_counter() - t0
    losses, ms = [], []
    reset_all()
    SH.reset_collectives()
    for bt in batches:
        sync(dev)
        t0 = time.perf_counter()
        params, st, m = step(params, st, bt)
        losses.append(float(m["loss"]))
        ms.append(1e3 * (time.perf_counter() - t0))
    counts, coll = all_counts(), SH.collective_counts()
    whole = tree_leaves(M.init_model(torch.Generator().manual_seed(1), cfg,
                                     TRACE_DEVICE))
    mine = tree_leaves(params[0])
    specs = [SH.spec_axes(sp, mesh) for sp in M.spec_leaves(params[0], cfg)]
    both = [i for i, ax in enumerate(specs) if set(ax) == {"data", "model"}]
    out = dict(losses=losses, ms_steps=ms, counts=counts, init_s=init_s,
               mesh_s=mesh_s,
               collective_bytes=coll, base_bytes=base,
               peak_bytes=(torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else 0),
               split_bytes=leaf_bytes(mine[i] for i in both),
               whole_split_bytes=leaf_bytes(whole[i] for i in both),
               param_bytes=leaf_bytes(mine),
               whole_param_bytes=leaf_bytes(whole),
               replicated=[host(x) for x, ax in zip(mine, specs) if not ax])
    del params, st, batches
    free_card(dev)
    return out


#: what a phase-19 case runs in a rank of phase 18's spawns
P19_CASES = {"19a": p19_prefill, "19b": p19_train, "19c": p19_prefill}


def p19_cases(sz: Sizes, p17: dict, world: int) -> tuple:
    """The phase-19 cases of a phase-18 spawn of ``world`` ranks: 19a and
    19c in the two-rank spawn, 19b in the four-rank one."""
    if world == 2:
        return (("19a", dict(name="stablelm", s=sz.tp_s, b=sz.tp_b,
                              decode=P19_DECODE)),
                ("19c", dict(name="llama4", s=sz.tp_l4_s, b=1,
                              replay=p17["17c moe prefill"]["replay"])))
    return (("19b", {}),)


def p19_line(label: str, runs: list, what: str) -> None:
    print(f"19{label}: {what}; s a rank: the process mesh "
          f"{[round(r['mesh_s'], 3) for r in runs]}, weights drawn and split "
          f"{[round(r['init_s'], 3) for r in runs]}, prefill "
          f"{[round(r['seconds'], 3) for r in runs]}, decode "
          f"{[round(r['decode_s'], 3) for r in runs]}; flash "
          f"launches by rank {[r['counts']['wgmma'] for r in runs]} wgmma, "
          f"{[r['counts']['tf32x3'] for r in runs]} tf32x3; collective "
          f"bytes a device {json.dumps(runs[0]['collective_bytes'])}",
          flush=True)


def p19_prefill_checks(dev, sz: Sizes, runs: list, want: dict, name: str,
                       label: str, bit_equal: bool) -> dict:
    """Every rank's prefill against phase 17's: ``bit_equal``, the last
    logits bit-equal to its one-process model = 2 prefill's, and the
    tally equal; within ``TP_TOL`` of its model = 1 logits; the wgmma
    kernel once a layer on each rank and nothing else; each rank's
    cache holding its heads.  Then the decode steps, where there are,
    within ``P19_DECODE_TOL`` of 17a's model = 1 decode."""
    cfg = p17_cfg(name, sz)
    n_attn = M.causal_attention_layers(cfg)
    route = fa.kernel_route(M._dt(cfg), cfg.resolved_head_dim)
    errs, dec_errs = [], []
    for r, got in enumerate(runs):
        lg = torch.from_numpy(got["logits"])
        check(bool(torch.isfinite(lg[..., :cfg.vocab_size]).all()),
              f"19{label} rank {r}: a logit is not finite")
        if bit_equal:
            check(torch.equal(lg, want["logits"].float()),
                  f"19{label} rank {r}: logits differ from phase 17a's "
                  f"one-process model=2 prefill (max abs "
                  f"{(lg - want['logits'].float()).abs().max()})")
            check(got["collective_bytes"] == want["collective_bytes"],
                  f"19{label} rank {r}: tally {got['collective_bytes']} != "
                  f"phase 17's {want['collective_bytes']}")
        errs.append(logits_err(cfg, lg, want["logits_model1"]))
        check(errs[-1] <= TP_TOL, f"19{label} rank {r}: logits rel err "
              f"{errs[-1]} beyond {TP_TOL} of model=1")
        others = {k: v for k, v in got["counts"].items() if k != route and v}
        check_launch(dev, got["counts"][route] == n_attn and not others,
                     f"19{label} rank {r}: launches {got['counts']}, want "
                     f"{n_attn} {route} and nothing else")
        check(got["heads"] * 2 == SH.padded_heads(cfg.n_heads)
              and got["kv_heads"] * 2 == cfg.n_kv_heads,
              f"19{label} rank {r}: {got['heads']} query heads, "
              f"{got['kv_heads']} KV heads cached")
        for a, b in zip(got["decode"], want["decode_model1"]):
            dec_errs.append(logits_err(cfg, torch.from_numpy(a), b))
            check(dec_errs[-1] <= P19_DECODE_TOL, f"19{label} rank {r}: "
                  f"decode rel err {dec_errs[-1]} beyond {P19_DECODE_TOL}")
    return dict(rel_err=max(errs), decode_rel_err=max(dec_errs, default=None),
                bit_equal=bit_equal, counts=[r["counts"] for r in runs],
                collective_bytes=runs[0]["collective_bytes"],
                heads=runs[0]["heads"], kv_heads=runs[0]["kv_heads"],
                param_bytes=[r["param_bytes"] for r in runs],
                seconds=[r["seconds"] for r in runs],
                wall_s=max(r["wall_s"] for r in runs))


def p19_train_checks(dev, sz: Sizes, runs: list, want: dict) -> dict:
    """19b's ranks against 17b: each loss within ``TP_TOL`` of model = 1
    and ``P19_TRAIN_TOL`` relative of model = 2; every rank the same
    losses and replicated leaves; a rank's leaves split over both axes a
    quarter of the whole's; no kernel launched (training attends through
    the chunked path)."""
    losses = runs[0]["losses"]
    for r in runs[1:]:
        check(r["losses"] == losses, f"19b: losses by rank "
              f"{[x['losses'] for x in runs]}")
        check(len(r["replicated"]) == len(runs[0]["replicated"]) and all(
            np.array_equal(a, b) for a, b in zip(r["replicated"],
                                                 runs[0]["replicated"])),
            "19b: a replicated leaf differs between ranks")
    check(all(math.isfinite(x) for x in losses), f"19b: losses {losses}")
    e1 = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                 want["losses_model1"]))
    e2 = max(abs(a - b) / abs(b) for a, b in zip(losses, want["losses"]))
    check(e1 <= TP_TOL, f"19b: losses {losses} off 17b's model=1 "
          f"{want['losses_model1']} by {e1}")
    check(e2 <= P19_TRAIN_TOL, f"19b: losses {losses} off 17b's model=2 "
          f"{want['losses']} by {e2} (limit {P19_TRAIN_TOL})")
    for r in runs:
        check(4 * r["split_bytes"] == r["whole_split_bytes"] > 0,
              f"19b: a rank holds {r['split_bytes']} B of the "
              f"{r['whole_split_bytes']} B split over data and model")
        check_launch(dev, not any(r["counts"].values()),
                     f"19b: launches {r['counts']}")
    ms = [[round(x, 1) for x in r["ms_steps"]] for r in runs]
    peaks = [r["peak_bytes"] for r in runs]
    print(f"19b stablelm-1.6b {len(runs)} processes (2, 2), {sz.tp_steps} "
          f"train steps at {sz.tp_b} x {sz.tp_train_s}: losses {losses}; "
          f"relative error {e1:.3g} to 17b's model=1 (limit {TP_TOL}), "
          f"{e2:.3g} to its model=2 (limit {P19_TRAIN_TOL}); each rank "
          f"holds {runs[0]['param_bytes']} of {runs[0]['whole_param_bytes']} "
          f"parameter bytes, {runs[0]['split_bytes']} of the "
          f"{runs[0]['whole_split_bytes']} split over data and model; "
          f"collective bytes a device {json.dumps(runs[0]['collective_bytes'])}",
          flush=True)
    print(f"19b peak device bytes by rank (max_memory_allocated of its "
          f"process): {peaks}; the process mesh and its subgroups "
          f"{[round(r['mesh_s'], 3) for r in runs]} s, weights drawn and "
          f"split and AdamW state made "
          f"{[round(r['init_s'], 3) for r in runs]} s; wall ms a step by "
          f"rank {ms} ({len(runs)} "
          f"processes time-slicing one card over the host-staged "
          f"transport: not a {len(runs)}-card time; {card_tag()})",
          flush=True)
    return dict(losses=losses, rel_err_model1=e1, rel_err_model2=e2,
                peak_bytes=peaks, ms_steps=ms,
                counts=[r["counts"] for r in runs],
                collective_bytes=runs[0]["collective_bytes"],
                param_bytes=runs[0]["param_bytes"],
                split_bytes=runs[0]["split_bytes"],
                wall_s=max(r["wall_s"] for r in runs))


def lm_procs_phase(dev, sz: Sizes, p17: dict, p18: dict) -> dict:
    """19: the ranks' phase-19 results (run in phase 18's spawns, after
    their GNN cases) held to phase 17's."""
    t0 = time.perf_counter()
    two = p18["18c mini-batch featshard"]
    four = p18["18b processes"]
    out = {}
    a = [r["19a"] for r in two]
    out["19a"] = p19_prefill_checks(dev, sz, a, p17["17a prefill"],
                                    "stablelm", "a", True)
    p19_line("a stablelm-1.6b (1, 2) 2 processes prefill", a,
             f"{out['19a']['heads']} query and {out['19a']['kv_heads']} KV "
             f"heads a rank; last logits bit-equal to 17a's one-process "
             f"model=2, {out['19a']['rel_err']:.4g} from model=1 (limit "
             f"{TP_TOL}); {P19_DECODE} decode steps "
             f"{out['19a']['decode_rel_err']:.4g} from 17a's model=1 decode "
             f"(limit {P19_DECODE_TOL}); parameter bytes by rank "
             f"{out['19a']['param_bytes']}")
    out["19b"] = p19_train_checks(dev, sz, [r["19b"] for r in four],
                                  p17["17b train"])
    c = [r["19c"] for r in two]
    out["19c"] = p19_prefill_checks(dev, sz, c, p17["17c moe prefill"],
                                    "llama4", "c", False)
    p19_line("c llama4-scout (1, 2) 2 processes prefill", c,
             f"routing replayed from 17c's model=1 run; last logits "
             f"{out['19c']['rel_err']:.4g} from model=1 (limit {TP_TOL})")
    secs = {"19a+19c in the 2-rank spawn": max(r["19a"]["wall_s"]
                                               + r["19c"]["wall_s"]
                                               for r in two),
            "19b in the 4-rank spawn": out["19b"]["wall_s"],
            "19 checks": time.perf_counter() - t0}
    secs["19 lm processes"] = sum(secs.values())
    print(f"19 seconds: {json.dumps({k: round(v, 2) for k, v in secs.items()})}"
          f" (19a-c run inside phase 18's spawns, so phase 18's seconds "
          f"include them)", flush=True)
    out["seconds"] = secs
    return out


def add_phase19(kernels: list, p19: dict) -> None:
    """Each kernel entry's launches on phase 19's paths, summed over the
    ranks of each run."""
    paths = {"procs_prefill_stablelm_d1m2": p19["19a"]["counts"],
             "procs_train_stablelm_d2m2": p19["19b"]["counts"],
             "procs_prefill_llama4_d1m2": p19["19c"]["counts"]}
    for kern in kernels:
        key = PHASE13[kern["name"]][0]
        kern["launches_phase19"] = {p: sum(c[key] for c in ranks)
                                    for p, ranks in paths.items()}


def run(dev: torch.device, sz: Sizes) -> dict:
    full_precision()
    secs = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        secs[name] = round(time.perf_counter() - t0, 2)
        return out

    measured = timed("2 tiled kernel", kernel_phase, dev, sz)
    row = timed("3 row kernel", row_phase, dev, sz)
    graph = timed("graph", make_graph, sz)
    bwd = timed("4 backward", backward_phase, dev, sz, graph)
    train = timed("5 training", training_phase, dev, sz, graph)
    serve = timed("6 serving", serving_phase, dev, sz, graph)
    gcn = timed("7 gcn", gcn_phase, dev, sz)
    E.drop_device_cache(graph)
    flash = timed("8 flash", flash_phase, dev, sz)
    lm = timed("9 lm serving", lm_phase, dev, sz)
    figs = timed("10 figures", figure_phase, dev, sz, graph)
    srcs = timed("11 sources", sources_phase, dev, sz, graph)
    shrd = timed("12 sharded", sharded_phase, dev, sz, graph)
    p13 = timed("13 lm train + dry-run", lm_dryrun_phase, dev, sz, graph)
    E.drop_device_cache(graph)          # the families need the memory
    p14 = timed("14 families", family_phase, dev, sz)
    p15 = timed("15 audits", audit_phase, dev, sz, graph)
    p16 = timed("16 chaos", chaos_phase, dev, sz, graph)
    E.drop_device_cache(graph)          # phase 17 needs the memory
    free_card(dev)
    p17 = timed("17 tensor parallel", tp_phase, dev, sz)
    free_card(dev)
    p18 = timed("18 processes", procs_phase, dev, sz, graph, shrd, p17)
    del graph
    p19 = timed("19 checks", lm_procs_phase, dev, sz, p17, p18)
    for ph in (figs, srcs, shrd, p13, p14, p15, p16, p17, p18, p19):
        secs.update({k: round(v, 2) for k, v in ph["seconds"].items()})
    print(f"phase seconds: {json.dumps(secs)}", flush=True)
    fig_runs = figs["10c figures"]
    print("figure seconds and steps/s: " + json.dumps(
        {name: [round(f["seconds"], 2), round(f["steps_per_s"], 1)]
         for name, f in fig_runs.items() if name != "peak_bytes"}),
        flush=True)

    def on_figures(kernel):
        """``kernel``'s launches on each path of phase 10."""
        return {"figures": {name: f["launches"][kernel]
                            for name, f in fig_runs.items()
                            if name != "peak_bytes"},
                "experiment_cli": {k: v["launches"][kernel]
                                   for k, v in figs["10a cli"].items()},
                "sweep_full_width": {k: v["launches"][kernel]
                                     for k, v in figs["10b sweep"].items()}}
    def on_families(route):
        """``route``'s launches on each serving path of phase 14 (and the
        f32 twins' prefills)."""
        out = {}
        for key, res in p14["14a-e serving"].items():
            name = key.split()[1]
            out[f"{name}_serve"] = res["counts"][route]
            if "counts_f32" in res:
                out[f"{name}_prefill_f32_model"] = res["counts_f32"][route]
        return out
    d = max(sz.agg_d)
    b, s, hq, hkv, hd = sz.fa_shape
    w1 = sz.fa_windows[1]
    cell = f"B={sz.agg_b} K={sz.agg_k} D={d} N={sz.agg_n}"
    tf, tm = train["counts_full"], train["counts_mb"]
    tc = srcs["11a cluster"]["counts"]
    ti = srcs["11b importance"]["counts"]
    cl_shapes = srcs["11a cluster"]["shapes"]
    # phase 12's paths: each sharded call launches once per shard
    sh1, sh4 = shrd["12a s1"], shrd["12b s4"]
    ns = sz.sh_shards
    sharded_counts_by_path = {
        "train_fullgraph_sharded_s1": sh1["fullgraph_sharded"]["counts"],
        "train_featshard_s1": sh1["featshard"]["counts"],
        "train_minibatch_sharded_s1": sh1["minibatch_sharded"]["counts"],
        f"train_fullgraph_sharded_s{ns}": sh4["fullgraph_sharded"]["counts"],
        f"train_featshard_s{ns}": sh4["featshard"]["counts"],
        f"train_minibatch_sharded_s{ns}": sh4["minibatch_sharded"]["counts"],
        f"serve_featshard_s{ns}": shrd["12c store"]["counts"]}

    def on_sharded(kernel):
        return {p: c[kernel] for p, c in sharded_counts_by_path.items()}
    sh_shapes = shrd["12b shapes"]
    by_route = {r: {"slab": c["tiled_slab"], "direct": c["tiled_direct"]}
                for r, c in (("train_fullgraph", tf), ("train_minibatch", tm),
                             ("train_cluster", tc), ("train_importance", ti),
                             ("serve", serve["counts"]),
                             ("gcn_serve", gcn["counts"]),
                             *sharded_counts_by_path.items())}
    sources = {"slab": CSRC + "neighbor_agg_slab.cu",
               "direct": CSRC + "neighbor_agg.cu"}
    fg = bwd["fullgraph_fwd"]
    chunk = {f"serving_chunk_d{dd}": dict(
        measured[(torch.bfloat16, dd, False)],
        shape=f"bf16, unfused, B={sz.agg_b} K={sz.agg_k} D={dd} "
              f"N={sz.agg_n}") for dd in sz.agg_d}
    # the top-level numbers are the serving chunk at D = 172, so that
    # lines of different runs compare on one shape; the slab kernel's own
    # entry is the full-graph shape of layer 1, where the plan takes it
    # (the routes are bit-equal, check_routes, so the planned route's
    # max_abs_err is the slab's)
    top = measured[(torch.bfloat16, d, False)]
    fg1 = fg[min(fg)]
    kernels = [
        {"name": "neighbor_agg_tiled", "route": "cuda",
         "source": sources[top["routes"]["planned"]], "sources": sources,
         "replaces": REF_AGG + "neighbor_agg.py:192",
         "launches": train["counts"]["tiled"],
         "launches_by_path": {"train_fullgraph": tf["tiled"],
                              "train_minibatch": tm["tiled"],
                              "train_cluster": tc["tiled"],
                              "train_importance": ti["tiled"],
                              "serve": serve["launches"],
                              **on_figures("tiled"),
                              **on_sharded("tiled"),
                              f"featshard_phases_s{ns}": {
                                  k: sh4["featshard"]["counts"][
                                      f"featshard_{k}"]
                                  for k in ("phase1", "phase2")}},
         "launches_by_path_and_route": by_route,
         **top,
         "shape": f"bf16, unfused, {cell} (the serving chunk)",
         "by_shape": {
             **{f"fullgraph_d{dd}": dict(
                 m, launches=f"{tf['tiled']} over both widths (one each "
                             f"a full-graph forward)")
                for dd, m in fg.items()},
             **chunk, **train["mb_forward"], **cl_shapes["forward"],
             **sh_shapes["forward"]},
         "l2_table_sweep": measured["sweep"],
         "figure_shapes": figs["shapes"]["forward"]},
        {"name": "neighbor_agg_tiled_fused", "route": "cuda",
         "source": sources[measured[(torch.float32, d, True)]["routes"][
             "planned"]], "sources": sources,
         "replaces": REF_AGG + "neighbor_agg.py:192",
         "launches": gcn["launches"],
         "launches_by_path": {
             "gcn_serve": gcn["launches"],
             f"featshard_phase2_s{ns}": sh4["featshard"]["counts"][
                 "featshard_phase2"]},
         "launches_by_path_and_route": {"gcn_serve": by_route["gcn_serve"]},
         **measured[(torch.float32, d, True)],
         "shape": f"f32, fused self epilogue, {cell}",
         "by_shape": {**gcn["by_shape"], **sh_shapes["fused"]}},
        {"name": "neighbor_agg_backward", "route": "cuda",
         "source": CSRC + "neighbor_agg_bwd.cu",
         "replaces": REF_AGG + "ops.py:55",
         "launches": train["counts"]["backward"],
         "launches_by_path": {"train_fullgraph": tf["backward"],
                              "train_minibatch": tm["backward"],
                              "train_cluster": tc["backward"],
                              "train_importance": ti["backward"],
                              **on_figures("backward"),
                              **on_sharded("backward")},
         **bwd["fullgraph_l2"],
         "note": "the general mode: no model path reaches its dfeats "
                 "(full-graph dfeats goes to neighbor_agg_backward_csr, "
                 "mini-batch dfeats to neighbor_agg_backward_identity); "
                 "timed here on the full-graph inputs, forced",
         "by_shape": {
             "fullgraph_l2": dict(bwd["fullgraph_l2"],
                                  launches=tf["backward"]),
             "minibatch_l2": dict(
                 bwd["minibatch_l2"], ms=bwd["minibatch_l2"][
                     "general_mode_ms_same_inputs"], launches=tm["backward"],
                 note="zero fill + f32 atomics on arange ids, the inputs "
                      "of neighbor_agg_backward_identity's entry")}},
        {"name": "neighbor_agg_backward_csr", "route": "cuda",
         "source": CSRC + "neighbor_agg_bwd_csr.cu",
         "replaces": REF_AGG + "ops.py:55",
         "launches": train["counts"]["backward_csr"],
         "launches_by_path": {"train_fullgraph": tf["backward_csr"],
                              "train_minibatch": tm["backward_csr"],
                              "train_cluster": tc["backward_csr"],
                              "train_importance": ti["backward_csr"],
                              **on_figures("backward_csr"),
                              **on_sharded("backward_csr")},
         **bwd["csr"],
         "by_shape": {**cl_shapes["backward_csr"],
                      **sh_shapes["backward_csr"]},
         "figure_shapes": figs["shapes"]["backward_csr"],
         "atomic_ms_same_inputs": bwd["fullgraph_l2"]["ms"],
         "atomic_plain_ms_same_inputs": bwd["fullgraph_l2"]["plain_ms"]},
        {"name": "neighbor_agg_row", "route": "cuda",
         "source": CSRC + "neighbor_agg_row.cu",
         "replaces": REF_AGG + "neighbor_agg.py:85",
         "launches": train["counts"]["row"],
         "launches_by_path": {"train": train["counts"]["row"],
                              "note": "on no model path: reached only "
                                      "through neighbor_agg(kernel='row')"},
         "note": "its gather is the direct route's (common.cuh "
                 "gather_pass), in a kernel symbol of its own",
         **row[(torch.bfloat16, d)],
         "shape": f"bf16, {cell}"},
        {"name": "flash_attention_wgmma", "route": "cuda",
         "source": FA_CSRC + "flash_attn_wgmma.cu",
         "replaces": "src/repro/kernels/flash_attn/flash_attn.py:78",
         "launches": lm["counts"]["wgmma"],
         "launches_by_path": {
             "lm_serve_bf16": lm["counts"]["wgmma"],
             "lm_prefill_f32_model": lm["counts_f32"]["wgmma"],
             **on_families("wgmma")},
         **_own(flash[(torch.bfloat16, 0)]),
         "shape": f"bf16, B={b} S={s} Hq={hq} Hkv={hkv} D={hd}, window 0",
         f"window_{w1}": _own(flash[(torch.bfloat16, w1)]),
         "row_check": flash["wgmma_rows"],
         "family_shapes": p14["14 flash shapes"]},
        {"name": "flash_attention", "route": "cuda",
         "source": FA_CSRC + "flash_attn.cu",
         "replaces": "src/repro/kernels/flash_attn/flash_attn.py:78",
         "launches": lm["counts_f32"]["tf32x3"],
         "launches_by_path": {
             "lm_serve_bf16": lm["counts"]["tf32x3"],
             "lm_prefill_f32_model": lm["counts_f32"]["tf32x3"],
             **on_families("tf32x3"),
             "note": "serves f32 and D = 16 or 32 only; launches are the "
                     "f32 models' prefills, the bf16 main paths run none"},
         **_own(flash[(torch.float32, 0)]),
         "shape": f"f32, B={b} S={s} Hq={hq} Hkv={hkv} D={hd}, window 0 "
                  f"(the f32 model's prefill)",
         f"window_{w1}": _own(flash[(torch.float32, w1)]),
         "bf16_same_inputs_as_wgmma": _tf32x3_on_bf16(
             flash[(torch.bfloat16, 0)]),
         f"bf16_window_{w1}_same_inputs_as_wgmma": _tf32x3_on_bf16(
             flash[(torch.bfloat16, w1)]),
         "family_shapes_f32": {
             k: {f: v for f, v in r.items() if f.startswith("f32_")}
             for k, r in p14["14 flash shapes"].items()
             if "f32_kernel_ms" in r}},
        {"name": "neighbor_agg_tiled_slab", "route": "cuda",
         "source": sources["slab"],
         "replaces": REF_AGG + "neighbor_agg.py:192",
         "launches": train["counts"]["tiled_slab"],
         "launches_by_path": {p: c["slab"] for p, c in by_route.items()},
         **{k: v for k, v in fg1.items() if k != "routes"},
         "ms": fg1["routes"]["slab"]["ms"],
         "ms_l2_flushed": fg1["routes"]["slab"]["ms_l2_flushed"],
         "row_rel_err": fg1["row_rel_err_by_route"]["slab"],
         "direct_route_ms_same_inputs": fg1["routes"]["direct"]["ms"],
         "slab_width_ms": fg1["routes"]["slab_width_ms"],
         "shape": f"bf16, unfused, full-graph {fg1['shape']} (layer 1)"},
        {"name": "neighbor_agg_backward_identity", "route": "cuda",
         "source": CSRC + "neighbor_agg_bwd.cu",
         "replaces": REF_AGG + "ops.py:55",
         "launches": train["counts"]["backward_identity"],
         "launches_by_path": {"train_fullgraph": tf["backward_identity"],
                              "train_minibatch": tm["backward_identity"],
                              "train_cluster": tc["backward_identity"],
                              "train_importance": ti["backward_identity"],
                              **on_figures("backward_identity"),
                              **on_sharded("backward_identity")},
         **bwd["minibatch_l2"],
         "library_call": "torch.mul(w[:, :, None], g[:, None, :])",
         "figure_shapes": figs["shapes"]["backward_identity"],
         "cases_max_abs_err": max(bwd["identity_cases"].values())},
    ]
    add_phase13(kernels, p13)
    add_phase16(kernels, p16)
    add_phase17(kernels, p17)
    add_phase18(kernels, p18, sz.sh_shards)
    add_phase19(kernels, p19)
    return {"kernels": kernels}


#: phase 13's launch-counter key and stand-in checks of each kernel entry
PHASE13 = {
    "neighbor_agg_tiled": ("tiled", ("tiled_d128", "tiled_d172")),
    "neighbor_agg_tiled_fused": ("tiled_fused", ("tiled_fused_f32",)),
    "neighbor_agg_backward": ("backward", ("backward",)),
    "neighbor_agg_backward_csr": ("backward_csr", ("backward_csr",)),
    "neighbor_agg_backward_identity": ("backward_identity",
                                       ("backward_identity",)),
    "neighbor_agg_row": ("row", ("row",)),
    "neighbor_agg_tiled_slab": ("tiled_slab", ("tiled_d128",)),
    "flash_attention_wgmma": ("wgmma", ("flash_wgmma_bfloat16",)),
    "flash_attention": ("tf32x3", ("flash_tf32x3_float32",)),
}


def add_phase13(kernels: list, p13: dict) -> None:
    """Each kernel entry's launches on phase 13's paths (13a's LM
    training, 13c's full-graph and mini-batch steps), read from its
    counter, and the stand-in shapes it was held to."""
    c13 = p13["13c gnn"]
    paths = {"lm_train": p13["13a lm train"]["launches"],
             "dryrun_check_fullgraph": c13["fullgraph"]["launches"],
             "dryrun_check_minibatch": c13["minibatch"]["launches"]}
    for kern in kernels:
        key, names = PHASE13[kern["name"]]
        kern["launches_phase13"] = {p: c[key] for p, c in paths.items()}
        kern["stand_in_shapes_equal"] = {
            n: [[list(sh), str(dt)] for sh, dt in p13["13c kernels"][n]]
            for n in names}


def _own(m: dict) -> dict:
    """A measured main shape's numbers for the kernel that served it."""
    return {k: v for k, v in m.items() if not k.startswith("tf32x3_")}


def _tf32x3_on_bf16(m: dict) -> dict:
    """The tf32x3 kernel's numbers on the bf16 inputs of a measured main
    shape: its own time and error; the plain, bound and library times are
    those of the same inputs."""
    own = {k: v for k, v in _own(m).items()
           if k not in ("row_rel_err", "planted_faults")}
    return dict(own, ms=m["tf32x3_ms"], max_abs_err=m["tf32x3_max_abs_err"])


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
