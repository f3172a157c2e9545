#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``crosscoder_tpu_torch``) on one H100.

``python3 chip_smoke.py`` from the root of a checkout, on a machine with
one NVIDIA Hopper card and the CUDA toolkit:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles every kernel under ``crosscoder_tpu_torch/csrc/`` with
   ``nvcc`` (one process per source, all at once) into ``build/kernels/``;
3. kernels vs their plain PyTorch versions on the card: ragged paged
   attention at the Gemma-2-2B attention shapes (mixed lengths, bf16 on
   its tensor-core kernel and fp32 on its CUDA-core one, each route's
   launch counted; global, windowed, a window shorter than a page, softcap
   on and off; the f32 kernel also checked and timed at the serve lengths,
   beside f32 SDPA), the fused
   encoder→TopK bitwise on exact integer-valued inputs (planted ties, NaN,
   -0.0, a width that is not a tile multiple, k in {1, 32, 128}), on exact
   inputs at the serve shape in bf16 (the tensor-core tile) and f32 (the
   CUDA cores), and on random bf16 at the serve shape; times each kernel (back to back and queued) beside
   its plain version, one library call, the card's bound and, for the
   kernels the bf16 tensor-core tile redesigned, the CUDA-core design's
   time in brackets;
4. serve: two random-init Gemma-2-2B models (bf16, seeds 1 and 2) hooked at
   ``blocks.14.hook_resid_pre``, a 16384-latent topk crosscoder (k=32),
   seq_len 1024, page 64, batch 8: warmup, then micro-batches of mixed
   lengths, a partial bucket and one extend, with both kernels' launch
   counters read around the traffic (every attention launch on the bf16
   tensor-core kernel); one batch re-run with both plain
   versions, and one through the padded (page-free) forward;
5. training kernels vs their plain versions, bitwise, at the training
   shapes: the TopK mask (K5) and the sparsify drain (K8) on bf16 rows
   [4096, 32768] with planted ties, NaN of both signs, -0.0, rows with
   fewer than k positives and (K8) a row past k, k in {1, 32, 128}; K8
   also at the other main-path shapes (bf16 [4096, 131072], f32 [4096,
   16384] and [4096, 32768], on TopK masks and on rows past k whose last
   positive lies in each part of its split route) and on its warp route
   (k past the split route's staging limit), each timed back to back and
   queued; the sorted-pair scatter (K10) with a latent hit by every row, dropped
   indices -1 and n_out, f32 and bf16 rows, and on the AuxK term's filler
   pattern (leg F's shape, 0, 6 and 63 dead latents), timed at the main
   and the AuxK shapes; the fused encoder→TopK (K2) at
   the training shape on exact inputs (bf16 and f32), and at 2^17 and
   2^15 + 128 wide, where its merge takes two levels, timed back to back
   and queued, with a torch.profiler split of its product-and-sort pass
   against its merge; the f32 TopK mask (K6) on f32 rows
   [4096, 16384] and [4096, 384] and the TopK of any width (K7) on bf16
   [4096, 131072], f32 [4096, 32768] and bf16 [512, 65920], on its cluster
   route at every cluster size (1 to 8 blocks a row, bf16 and f32, 16 rows,
   the last slice full and ragged, ties straddling every slice edge) and on
   its streaming route (bf16 [256, 524312], f32 [256, 131080]), bitwise on
   planted ties (inside a row, across the 4096-column stretch edge, far
   from the kth column), NaN of both signs, -0.0, +inf and rows with fewer
   than k positives, k in {1, 32, 128}; each timed beside its plain
   version, one library call and the bound, K7's streaming route at bf16
   [512, 524288];
6. train: two Trainer legs at Gemma-2-2B width (d_in 2304, two models,
   ``blocks.14.hook_resid_pre``), dict 2^15, TopK k=32, batch 4096, bf16
   compute, f32 masters, sparse backward on, AuxK 64 every 2 steps, every
   step of every training leg (here and in phases 6b, 7 and 9) updating
   through O1, the fused clip + Adam + lr kernel, once a step: leg A
   (dense encode, 12 steps) and leg B (fused encoder, 4 steps) over
   synthetic batches made ahead onto the card, with every launch counter
   (and K8's and K11's launches by route) read around the legs, every K8
   launch of a training leg on its split route; then a bare and an aux step re-run from one state
   with the plain versions (bitwise), the fused leg's first bare step
   against leg A's, a whole bare step (update included) bitwise against
   its re-run with the plain versions and the plain update, O1 alone at
   leg A's state and gradients (f32 masters, and once in bf16) bitwise
   against the plain update on both sides of the clip and timed (back to
   back, queued) beside the plain update, ``torch.optim.Adam(fused=True)``
   and the bound, leg A's bare step with O1 against the parent's eager
   update in turns and both profiled, step times, a profiler split and
   peak memory; then,
   over the same batches, leg F: TopK k=32 at f32 compute (K6), dict 2^14,
   AuxK 64 every 2 steps, 8 steps straight against 4 steps, a background
   save, a fresh Trainer with ``resume=True`` and 4 more (bitwise equal
   state), with the save's fetch and write times, the restore time and the
   files' bytes, the AuxK scatter launches counted apart, and one aux
   step's scatters recorded (dead latents, each call's destination
   histogram, its K10 time and index_add_'s); leg W: dict 2^17 (K7), bf16
   compute, f32 masters, 6 steps, one re-run with the plain versions (bitwise) and one through the
   opt-in fused encoder (K2), timed against the dense encode; launches, ms
   per step, peak memory; leg V: f32 compute at dict 2^15 (K7 on f32 rows),
   3 steps;
   before it, the harvest path's kernels vs their plain versions, bitwise:
   the global-threshold BatchTopK select and emit (K9) and the emit alone
   at a fixed threshold, bf16 and f32, [4096, 32768] and [4096, 2432],
   with ties at the threshold, a budget above the count of positives,
   all-negative rows, -0.0 and NaN; the block int8 quantize (K11) on its
   row route (a Gemma-2-2B harvest chunk's rows [8184, 2304]) and its
   column route (the int8 encoder's ``W2.t()``, W2 [4608, 32768], read in
   place), with all-zero blocks, half-way quotients and a NaN block, the
   row route's host time to issue a call, the column route beside
   ``W2.t().contiguous()``, the copy it removes; each timed beside its
   plain version, one library
   call where there is one (the emit's, ``F.threshold``, checked bitwise
   against it), and the bound, and K9/K11 also queued behind a device
   sleep (device time without the host's launch rate); the int8 fused
   encoder (K3) bitwise on random bf16 and f32 inputs ([520, 4608] x
   [4608, 4192]: rows and a width that are not tile multiples, k in {1,
   32, 128}, blocks 128 and 256) and at the edges of its int8 tensor-core
   tile (B 1, 3, 130, width 2^15 + 8, blocks 32, 64, 96 and 256, an
   all-zero block, operands at +-127, a -0.0 and a NaN bias column), its
   training-shape time split by the profiler into the quantization, the
   product-and-sort pass and the merge; the fused BatchTopK select and
   emit (K4) bitwise on exact integer-valued inputs, bf16 and f32 (ties at the
   global threshold, a positive bias over 1000 rows, a width of 4104, a
   budget above the count of positives; the training and the serve
   shapes); K2 and K4 bitwise on exact inputs at the edges of the bf16
   tensor-core tile, bf16 and f32 (B 1, 3 and 130, a contraction of 4104,
   a width of 2^15 + 8, k 1, 32 and 128, ties at every threshold, NaN,
   -0.0, a positive bias over the padded rows); both timed at the training shape
   (back to back and queued) beside their plain versions, one library
   call (K3: bf16 matmul + topk, the exact function it approximates; K4:
   matmul + topk of the flattened ReLU'd rows, matmul + ``F.threshold``)
   and the bound;
7. train on harvested activations: two random-init Gemma-2-2B models
   (bf16, seeds 1 and 2) harvested at ``blocks.14.hook_resid_pre`` from
   seeded token ids (seq_len 1024, some rows ending in PAD runs) into the
   replay buffer (buffer_mult 8: 32 736 rows, a refill every 3 serves;
   norm calibration over 8 chunks of 4), then a 2^15-latent crosscoder
   trained 12 steps a leg at batch 4096: leg H, BatchTopK k=32 over the
   bf16 card store (K9 every step, then the threshold calibrated on 2
   served batches and one eval encode through the K9 emit alone), leg Q,
   ReLU over the int8 card store (K11 on every chunk), with the launch
   counters read around both legs; then each leg's first 6 served batches
   against a host-store buffer built from the same params and tokens,
   byte for byte, and a leg-H step re-run with the plain versions
   (bitwise); fill, serve, refill and step times, peak memory; leg H's
   save at its last step restored into a fresh buffer and Trainer (the
   state bitwise, the buffer's token pointer and normalisation factors as
   saved, 2 more finite steps); over leg H's 6 served batches, leg K:
   BatchTopK with ``fused_encoder='on'`` (K4 every step; no AuxK) beside
   the dense encode (K9) on the same batches, one fused step held against
   leg H's from its state (loss within 1e-3 relative, active-set Jaccard
   >= 0.98), and 2 steps at f32 compute, one fused step profiled (K4
   select, emit, matmul, other); leg I: the train cell (TopK k=32,
   AuxK 64 every 2 steps) with ``quant_encoder`` block 256 (K3 and K10 on
   bare steps, K11's row route on x and column route on W for every K3
   call, K5, K8 and K10 on aux steps) and the quality gate of
   docs/SCALING.md against the exact fused encoder (K2) on one batch
   (selection overlap >= 0.9, value error < 5e-3, loss within 5%); every
   launch counter read around each leg, one step of each profiled;
8. analysis: two random-init Gemma-2-2B models (bf16, seeds 1 and 2, all
   26 blocks) written as HF-layout state dicts and loaded back through
   ``lm.from_torch_state_dict`` (model A through a file: ``torch.save``,
   fsync, its pages dropped from the page cache, a mapped ``torch.load``;
   model B from memory), bitwise to their params, both timed; one
   forward with logits on [4, 1024] tokens timed, with its peak memory;
   over seeded tokens [8, 1024] (BOS first, chunks of 4) at
   ``blocks.14.hook_resid_pre``: the CE-recovered eval with the identity
   reconstructor (spliced CE bitwise the clean CE, recovered 1.0), the zero
   reconstructor (recovered by its formula) and a folded 2^14-latent TopK
   crosscoder (k=32, f32; K6 once a chunk), firing rates over the
   harvested f32 rows (K6 once a batch) and the dashboards of the features
   ``replicate.pick_features`` picks, with the logit lens (K6 once a
   minibatch), the launch counters read around them; one chunk's CEs,
   the firing rates and the dashboards each against a re-run with the
   plain versions, exactly; ``dashboards.html`` written;
9. the compiled data plane, over phase 7's models, corpus and leg H
   config: the corpus's first chunk (4 x 1024) through the paged harvest
   (``run_with_cache_multi_paged``, ``pad_mode="wrap"``), each of its 28
   K1 launches held against the plain attention (2e-2) and the capture
   against its plain-attention re-run (relative error per source, 2e-2);
   chunk times, padded against paged, on that chunk and on an
   all-full-length one; K1 alone at the harvest shape, timed beside its
   plain version, SDPA and the bound; leg S, leg H with
   ``refill_overlap="on"`` (SegmentedHarvest quanta from the dispatcher
   thread), its 12 served batches bitwise leg H's and its step times
   beside leg H's; leg P, ``harvest_runtime="paged"`` with refill
   overlap, BatchTopK over the bf16 card store, 12 steps (finite losses,
   l0 against k, no all-zero store row, 28 K1 launches a chunk on the
   tensor cores, the padding efficiency, the harvest's share of the
   steps), then a save mid shadow cycle and a restore into a fresh buffer
   and Trainer, both through the dispatcher;
10. the trainer's remaining numerics and recovery, over synthetic batches
   made ahead onto the card at the train phase's width (dict 2^15 unless
   stated): leg J, a 4-step BatchTopK run (K9) whose threshold
   ``train/warmstart.py`` calibrates into a JumpReLU θ, 6 JumpReLU steps
   (``l0_coeff`` 1, bandwidth 0.03; finite losses, log_theta moving, the
   first step's L0 beside k), a step against its re-run with the plain
   update (bitwise), 2 steps at bf16 masters with O1 taking the bf16
   weights and the f32 log_theta in one launch (bitwise the plain update;
   O1 timed there beside its bound), one step profiled beside the
   JumpReLU forward and backward timed alone; leg D, ``sparse_decode``
   (TopK k=32) at 2^15 (K5, K8) and 2^17 (K7, K8), 4 steps each, one
   step's loss and gradients against the dense TopK path from the same
   state, step times and peak memory; leg R, leg A's config resampling
   every 4 steps, 8 steps, the revived rows checked right after the edit
   (decoder norms, b_enc, moments, trackers) and the edit re-run from the
   same generator state (bitwise); leg G, leg A's config under the loss
   guard over a source whose serve 9 is all NaN: one rollback, the
   counters as the JAX trainer counts them, the restore timed, the final
   state bitwise a fresh Trainer's restored from the same save with the
   same serves skipped by hand. After phase 4, the replica hand-off: a
   second engine on phase 4's models and crosscoder adopts the 8
   mixed-length requests engine A spools on preemption through a shared
   board, each result bitwise engine A's serving it directly (K1, K2
   launches counted);
11. the parallel trainer on the card, at the one grid one card holds: an
   NCCL group of one rank in this process (a FileStore under ``build/``),
   leg M, leg A's config through the mesh trainer (data 1 x model 1, every
   collective and the merge run) for 12 steps in turns with leg A's
   single-device Trainer over the same batches, loss, metrics and the full
   state bitwise after each step, K5, K8, K10 and O1 launches and the NCCL
   calls a step counted on the mesh path, both step times; 4 BatchTopK
   steps (K9 under the grid's threshold) bitwise the single-device run; a
   save through the gathered path and a restore through the agreement,
   into a mesh Trainer and the single-device one, bitwise, then one more
   step from each; the int8 gradient exchange (``parallel.quant_ar``) at
   n_dev 1 over leg M's four gradient leaves, K11 bitwise the plain
   quantize (means, residuals, q, scales), timed beside its bound and NCCL
   all_reduce in f32 and bf16; then a CPU rehearsal of the multi-rank path
   (this script's ``--cpu-rank`` workers on gloo, no card visible: 2 x 2
   ranks against one at a tiny width, 3 steps, rtol 2e-4 / atol 2e-5);
12. the parallel harvest on the card, at the one grid one card holds (an
   NCCL group of one rank: every collective an identity, no ring hop ever
   runs on the card): leg RA, the ring's fold (``ring_attention.fold_block``)
   over 8 blocks of 1024 in one process at Gemma-2-2B's attention shape (B
   1, S 8192, 8 query heads on 4 KV heads of 256, softcap 50, window 4096)
   against the dense attention over the row, global and local, f32 and
   bf16 and one bf16 case with sharp logits, at K1's bars, timed; leg SP,
   ``run_with_cache_multi_seq_parallel`` of two random-init Gemma-2-2B
   models on a [4, 1024] chunk at ``blocks.14.hook_resid_pre`` against
   ``run_with_cache_multi`` at phase 9's harvest bar (2e-2 relative error
   per source, in norm; the largest error over the largest value logged),
   and against the same forward in f32, where its error, in norm and at
   the worst position, is at most 1.1x the dense harvest's, timed; leg TP,
   the tensor-parallel forward (``shard_params_tp`` over the one-rank
   model group, logits and capture) bitwise the whole
   forward, timed; leg MS, the mesh-sharded stores (bf16 and int8, K11 on
   the int8 refill) 8 serves bitwise the device stores from the same
   tokens, then 6 TopK steps (sparse backward) of a mesh Trainer on each
   bitwise a single-device Trainer on the device store, K11, K5, K8, K10
   and O1 counted; leg SS, ``shard_sources`` on a grid of one, 4 steps
   bitwise the single-device Trainer;
13. the mesh's last refusals on the card (an NCCL group of one rank): leg
   OV, the bf16 and int8 mesh stores fed by a tensor-parallel harvest
   with ``refill_overlap="on"`` (no dispatcher thread: the credit pumped
   inline), 8 serves and 6 TopK steps of a mesh Trainer on each bitwise
   the same with the overlap off; leg PT, the paged harvest (K1) of a [4,
   1024] chunk over tensor-parallel params bitwise the paged harvest over
   whole params, K1's launches counted, timed; leg FM, the mesh trainer at
   Gemma-2-2B width, 4 steps a knob in turns with the single-device
   Trainer, loss, metrics and state bitwise after each step: fused TopK
   (K2), ``quant_encoder`` (K3, K11), fused BatchTopK (K4 select, count
   and emit), ``sparse_decode`` (K5, K8), resampling with a resample in
   the window, and the loss guard with one NaN serve and one rollback
   (dictionary 2^12, its saves and agreed restore kept small); K2, K3 and
   K4's select, count and emit timed at the step's operands (CUDA events);
   then leg FM again at data 1 x model 2 on two gloo ranks sharing the card
   (this process and one more, ``--gloo-rank``), each rank's losses and
   shard of the params against its own single-device run (a loss within
   1e-4 relative, each leaf within 1e-3 relative in norm);
14. the fleet (``train/fleet.py``) at Gemma-2-2B width off a host store
   harvested from the two random-init Gemma-2-2B: cohort C, three TopK
   tenants (k 32, dict 2^15, AuxK) that differ in seed and l1_coeff, on one
   stacked state; bucket BT, BatchTopK at dict 2^14, admitted before round 2
   and retired before round 6; 8 rounds with every kernel's plain version
   made to raise. Each tenant's losses and final state bitwise a solo
   Trainer over the same served batches from the same init; one real serve
   and one host-to-device copy a round; the launches those of the solo
   steps but O1, launched once a cohort and once a bucket a round; the
   cohort's O1 at gradients scaled to straddle the clip bitwise its plain
   version and the three solo launches, timed beside them, PyTorch's fused
   Adam and its bound; a round's ms against the solo steps'; peak memory;
15. the counted wire, the prefetch and the fleet on a grid: leg CM,
   ``comm_model.profile_width`` in a child process (a fake group) at leg
   A's shapes under JAX's base config, DP and the int8 exchange at 2, 4
   and 8 ranks, DP x TP at 4 x 2, the DP and SP harvests of Gemma-2-2B at
   14 layers [4, 1024], bytes by op, wire bytes and ``predict()`` at leg
   A's bare step, the DP step's f32 gradients, the TP step's smaller sum
   and the ring's permutes checked exactly; leg FG, phase 14's cohort C
   over an NCCL group of one rank bitwise the fleet on one device, then a
   TopK cohort and a bucket at data 1 x model 2 on two gloo ranks sharing
   the card (``--fleet-rank``) within leg FM's bars, O1's cohort launches,
   K5, K8 and K10 counted; leg PF, leg A's config (synthetic source) and
   leg H's BatchTopK config (host bf16 store) for PF_STEPS steps with the
   prefetch off, on, off and on, bitwise, the copies on the worker's
   stream, the median loss-to-loss and serve times each way and whether a
   copy
   overlapped a step kernel (``torch.profiler``) printed. Phases 1-14 run
   their Trainers with the prefetch off, as before it was ported;
16. the telemetry plane and the resilience hooks: leg OB, leg A's config
   (dense encode, prefetch on, a log every step) over synthetic batches made
   ahead onto the card, 8 steps with obs off, then 8 with obs on, a profiler
   window over steps 3-4 and a save and a restore after step 1: losses and
   state bitwise, K5, K8, K10 and O1 launched as often both ways,
   ``trace.json`` with the step, wait, save and restore spans, the window's
   Chrome trace naming the four kernels, the memory gauges the card's; the
   loss-to-loss medians each way and the profiled steps' printed; leg RS,
   leg PF H's harvested BatchTopK setup with prefetch on: a clean run, run A
   (a stalled and a failing serve through the watchdog, bitwise the clean
   run), run B (a NaN serve under the guard with save 1 corrupted as it
   lands, dict 2^10: one rollback, one corrupt-save skip, the JAX trainer's
   counters), run C (a stalled and a failing refill chunk through the
   watchdog: the JAX trainer's counters), K9 and O1 launched in each; the
   watchdog's cost a serve printed;
17. elastic membership: leg EL, the preempt drill
   (``resilience/elastic_drill.py``) at Gemma-2-2B width on two gloo ranks
   sharing the card, one rank a host (data 2 x model 1; TopK k 32, dict
   2^14, the sparse backward, AuxK, batch 4096, bf16 compute, f32 masters,
   the synthetic source, a save every 3 steps, the batch prefetch on, as
   the Trainer's default): rank 1 dies at serve 7, rank
   0 finds the loss, shrinks to one rank on the card, restores the newest
   verified save and finishes 8 steps, its losses after the re-mesh
   bitwise a fresh process's restoring the same save; K5, K8, K10 and O1
   launched on both sides of the re-mesh, and 2 steps from the restored
   save bitwise their plain versions; remesh_ms, the detection path, the
   epoch, the gloo step times, the re-mesh's split and each rank's timeline
   printed; leg ES, the stability drill (flaky and slow probes below the
   threshold) on two more gloo ranks, its 8 steps at dict 2^10 and batch
   1024, beside leg EL from the phase's start: zero remeshes, every chaos
   counter at least 1;
18. elastic scale-up: leg EG, the autoscale drill
   (``resilience/elastic_drill.py``) at leg EL's width and config (TopK k
   32, dict 2^14, the sparse backward, AuxK, batch 4096, f32 masters, the
   batch prefetch on) on gloo ranks sharing the card, 2 x 1 -> 1 x 1 -> 2 x
   1, 12 of the drill's 20 steps, a save every 5: rank 1 dies at serve 6,
   rank 0 shrinks and replays, ``return@10`` opens the rejoin window, a
   parked returned rank passes the debounce and rank 0 grows the world
   back at a step boundary through a boundary save both restore; the survivor's losses after the grow bitwise a clean 2 x 1
   world's restoring the same save, the joiner's bitwise the survivor's;
   two remeshes, one grow, no abort, epoch 2; K5, K8, K10 and O1 launched
   on both sides of the grow (and on the joiner), and 2 steps from the
   boundary save bitwise their plain versions; remesh_ms, grow_ms and the
   grow's split (the boundary save, the regroup, the restore) printed, and
   ``FleetPolicy``'s score ranking at 2, 4 and 8 ranks at that width;
19. the tuner (``crosscoder_tpu_torch/tune/``): leg TU at the train
   phase's width and config (TopK k 32, dict 2^15, the sparse backward,
   AuxK 64 every 2, batch 4096, bf16 compute, f32 masters) over the
   synthetic source: ``tune()`` over prefetch x refill_frac x
   refill_dispatch_batch (8 candidates priced on the port's cost model, the
   top 2 and the default knobs gated and measured, 2 + 3 steps a window
   through the Trainer) writes ``TUNED.json``, which ``load_tuned`` and
   ``apply_tuned`` give back exactly; every calibrated candidate passes the
   step-identity gate bitwise, and a step knob (``topk_k``) smuggled past a
   patched ``STEP_FIELDS`` fails it and is counted
   ``tune/rejected_contract`` 1; a Trainer on ``--tuned`` and one on the
   winner's knobs as flags, 2 steps each, bitwise; ``FleetPolicy`` takes the
   pinned artifact's grid; one harvest quantum's host time (the tuner's
   dispatch constant) measured over two random-init Gemma-2-2B; each
   candidate's predicted score, each window's span ``step_ms``, ``wall_s /
   steps``, bubble and effective ms, the gate's ms and the phase's seconds
   printed; K5, K8, K10 and O1 counted;
20. the compile tier (``utils/compile_cache.py`` under ``ops/_build.py``):
   leg CC, over a fresh tier under ``build/``, two fresh processes run
   ``serve.warm_start`` at the serve phase's width (two random-init
   Gemma-2-2B, 14 layers, buckets to 8, seq_len 1024) at the same moment:
   across both, one ``nvcc`` a source (12); then a third fresh process
   (which reached the card beside them and waited) reports 0 compiles and
   12 disk hits; each serves one batch of mixed lengths, bitwise across the
   three, and the first and the third take 2 steps at leg A's config,
   bitwise (losses and every leaf's checksum); K1 and K2 counted in each,
   K5, K8, K10 and O1 in the two that train; warmup_ms cold and warm, each
   process's time and the tier's ptxas sidecars (registers, spills, shared
   memory) printed;
21. the static correctness plane (``crosscoder_tpu_torch/analysis/contracts``):
   the AST lints and the compile tier's key rule over the checkout; the
   step lattice (JAX's knob-off variants and a default-knob
   ``TUNED.json``) recorded at leg A's config at full width, JAX's
   "auto"-dead pairs at their small shape, the fused-live train step at leg
   B's fused TopK shape and the serve encode at the serve phase's [8, 4608]
   x [4608, 16384], each under the step rules (op streams and launches,
   dtypes, donation, no [B, dict] tensor, no host transfer); the kernel
   probes (every library at its main-path and a tail shape on each route,
   captured under ``torch.profiler`` in a fresh process beside the lattice)
   under the kernel rules, and ``compute-sanitizer``'s memcheck and
   racecheck over the tail probes where a control run shows the tool works
   on this machine (else the two rules are skipped with the tool's error);
   fails on any error-severity finding, a missed tail bar or a repeat that
   differs; prints the launch table and the spill warnings; K2, K5, K6,
   K8, K9, K10 and O1 counted on the recorded steps;
22. prints the contracts line (the rules checked, skipped with their
   reasons and suppressed, the launch table) and the kernel table as one
   JSON line each, the card line, and ``{"ok": true, "device": {...}}``
   last.

Any failed check exits nonzero before the last line is printed.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

PEAK_BYTES_S = 3.35e12                       # H100 SXM HBM3
# dense tensor-core bf16 and int8; fp32 off the tensor cores
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
TRAIN = dict(d_in=2304, n_models=2, hook_point="blocks.14.hook_resid_pre", dict_size=2 ** 15,
             topk_k=32, batch_size=4096, enc_dtype="bf16", master_dtype="fp32",
             activation="topk", l1_coeff=0.0, sparse_bwd="on", aux_k=64, aux_every=2,
             aux_dead_steps=4, aux_exact_rank=True, lr=1e-3, log_backend="null",
             prefetch=False)
LEG_A, LEG_B = 12, 4
# the harvest-train phase: Gemma-2-2B width, buffer_mult cut from 128 to 8
# (32 seqs, 32 736 rows, a refill every 3 serves), norm calibration from
# 100 to 8 chunks, 12 steps a leg
HARVEST = dict(d_in=2304, n_models=2, hook_point="blocks.14.hook_resid_pre", dict_size=2 ** 15,
               topk_k=32, batch_size=4096, enc_dtype="bf16", master_dtype="fp32", l1_coeff=0.0,
               lr=1e-3, log_backend="null", seq_len=1024, model_batch_size=4, buffer_mult=8,
               norm_calib_batches=8, prefetch=False)
LEG_H, LEG_Q = 12, 12
# phase 9: leg S (leg H with refill overlap) runs LEG_H steps, leg P (the
# paged harvest with refill overlap) LEG_P; a paged chunk launches K1 once
# a block a model (14 blocks below blocks.14.hook_resid_pre, 2 models); a
# chunk's capture through K1 is held to its plain-attention re-run at this
# relative error per source (bf16 forwards through 14 blocks, each
# attention output within K1's 2e-2)
LEG_P = 12
K1_PER_CHUNK = 2 * 14
HARVEST_REL_TOL = 2e-2
# leg F (K6, checkpoint and resume): TopK at f32 compute, dict 2^14, 8 steps
# straight against 4 + save + restore + 4; leg W (K7): dict 2^17, 6 steps;
# leg V (K7 on f32 rows): f32 compute, dict 2^15, 3 steps. Each takes the
# dense encode, the default of fused_encoder='auto' without its opt-in.
LEG_F = dict(TRAIN, dict_size=2 ** 14, enc_dtype="fp32", fused_encoder="off",
             num_tokens=TRAIN["batch_size"] * 8)
LEG_W = dict(TRAIN, dict_size=2 ** 17, aux_k=0, aux_every=1, fused_encoder="off",
             num_tokens=TRAIN["batch_size"] * 6)
LEG_V = dict(TRAIN, enc_dtype="fp32", aux_k=0, aux_every=1, fused_encoder="off",
             num_tokens=TRAIN["batch_size"] * 3)
STEPS_F, STEPS_W, STEPS_V = 8, 6, 3
# K7's streaming route, timed apart: bf16 rows of 2^19 latents, past the
# reach of a cluster of eight 64 KB slices, fewer rows than a batch
STREAM_ROW = (512, 2 ** 19)
# the dead latents of K10's timed AuxK case, as leg F's recorded aux step
# had them: fewer than aux_k, so every row also sends pairs to the lowest
# live columns (the filler pattern)
AUXK_DEAD = 6
# the device sleep in front of a queued timing: about 25 ms at the H100's
# clocks, longer than the host takes to issue 50 launches of a wrapper
QUEUE_CYCLES = 50_000_000
# the times this script measured for the designs that later kernels
# replaced (H100 80GB HBM3 at 700.00 W): the CUDA-core designs (K2 and K4
# in bf16 before the shared tile, K3 and K1 before theirs) and K1's
# mma.sync design with its page pool (PR 7's, before the wgmma one),
# printed in brackets beside the new ones
# phase 10 at the train phase's width: leg J, JumpReLU (l0_coeff 1, bandwidth
# 0.03) warm-started from a 4-step BatchTopK run, 6 steps, then 2 at bf16
# masters; leg D, sparse_decode (TopK k=32, no AuxK) at dict 2^15 and 2^17, 4
# steps each; leg R, leg A's config resampling every 4 steps (dead after 2
# quiet steps), 8 steps; leg G, leg A's config under the loss guard (a log
# every 2 steps, a save every 4) over a source whose serve 9 is all NaN, 12
# steps (the fault lands past the 8 of the other legs); the replica
# hand-off, 8 mixed-length requests
LEG_BT = dict(TRAIN, activation="batchtopk", aux_k=0, aux_every=1, sparse_bwd="off",
              fused_encoder="off")
LEG_J = dict(LEG_BT, activation="jumprelu", l0_coeff=1.0, jumprelu_bandwidth=0.03)
LEG_D = dict(TRAIN, sparse_decode=True, sparse_bwd="off", fused_encoder="off", aux_k=0,
             aux_every=1)
LEG_R = dict(TRAIN, fused_encoder="off", resample_every=4, resample_dead_steps=2)
LEG_G = dict(TRAIN, fused_encoder="off", guard_loss=True, log_every=2, save_every=4,
             keep_saves=3)
STEPS_BT, STEPS_J, STEPS_JB, STEPS_D, STEPS_R, STEPS_G = 4, 6, 2, 4, 8, 12
NAN_SERVE = 9
N_REPLICA = 8
# leg D against the dense TopK path from one state: the same mask, the
# decode summed in another order and the dense backward's cotangent rounded
# to bf16 for the tensor cores (the sparse one stays f32): the loss within
# 1e-3 relative, each gradient within 2e-2 relative in norm
SPARSE_DECODE_TOL = (1e-3, 2e-2)
# phase 14 at the harvest phase's width over a smaller host store of the two
# random-init Gemma-2-2B (buffer_mult 4: 16 seqs, 16 368 rows, a refill of
# half of it after every serve; norm calibration from 2 chunks): cohort C,
# three TopK tenants (k 32, dict 2^15, AuxK 64 every 2) that differ in seed
# (1, 2, 3) and l1_coeff (0, 0, 3e-4); bucket BT, BatchTopK (k 32, dict 2^14),
# admitted before round 2 and retired before round 6; 8 rounds. The cohort's
# O1 is checked at gradients scaled to global norms of O1_NORMS, one a tenant
FLEET = dict(HARVEST, activation="topk", aux_k=64, aux_every=2, aux_dead_steps=4,
             aux_exact_rank=True, buffer_mult=4, norm_calib_batches=2,
             num_tokens=HARVEST["batch_size"] * 8, fleet="on",
             fleet_tenants="c1:seed=1,l1_coeff=0;c2:seed=2,l1_coeff=0;c3:seed=3,l1_coeff=3e-4")
FLEET_BT = dict(seed=4, activation="batchtopk", dict_size=2 ** 14, aux_k=0, aux_every=1)
ROUNDS_F, BT_IN, BT_OUT = 8, 2, 6
O1_NORMS = (0.5, 4.0, 0.999)
STEP_MS: dict[str, float] = {}
BT_T = 15                    # candidate patterns a bisection pass counts (K9's T)
CUDA_CORE_MS = {"K2 serve": 0.2477, "K2 train": 95.2670, "K4 select": 39.9474,
                "K4 emit": 29.2987, "leg B bare step": 127.4, "leg K step": 104.389,
                "K3 train": 24.1683, "K1 serve": 1.1974, "leg I bare step": 58.3,
                "K1 serve mma.sync": 0.2822, "K1 harvest mma.sync": 0.3042}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps: int, queued: bool = False) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events),
    launched back to back. ``queued``: a device sleep goes first, so the
    host has issued every launch before the first one runs and the events
    see the device's time alone, not the host's launch rate."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(QUEUE_CYCLES)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def host_ms(fn, reps: int) -> float:
    """Host time to issue one call of ``fn``, the card held busy by a
    device sleep so that no launch waits for it."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_CYCLES)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return t


def bound(n_bytes: float, n_ops: float, dtype: str) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_OPS_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain


def check_paged_attention(torch, pa, lengths_serve):
    """K1 at the Gemma-2-2B attention shapes, both routes; returns its
    kernel-table rows (bf16 at the serve shape, f32 at the serve lengths).
    f32 is held to 1e-5 on valid rows; bf16 to 2e-2 on
    valid rows and, per row (a query position and head), to 2e-2 of that
    row's largest output. Random logits are about N(0, 1), where a cap of
    50 moves the output by less than a bf16 ulp, so bf16 adds softcap cases
    with sharp logits (q x 30: up to about +-90 before the cap) and v / 4
    (outputs below 2); there, and in f32's softcap cases, the plain version
    with the cap must differ from the one without by over 5x the bar.
    Both routes also at Gemma-2-27B's heads (lengths 0 to S, k not 16-byte
    aligned); then the bf16 entry's SASS (HGMMA, UTMALDG) and ptxas's
    spills of it, and the timings."""
    from crosscoder_tpu_torch.analysis.contracts import kernel_safety
    from crosscoder_tpu_torch.ops import _build

    D_, S, H, KV, hd, page = 6, 1024, 8, 4, 256, 64
    scale, cap = 256 ** -0.5, 50.0
    gen = torch.Generator(device="cuda").manual_seed(0)
    lens = torch.tensor([1, 63, 64, 65, 1000, 1024], dtype=torch.int32, device="cuda")

    def valid_err(a, b, ln, S=S, H=H):
        """max |a - b| on valid rows, and its largest ratio, row by row, to
        max |b| of the row (documents of length 0 have no valid row)."""
        a = a.float().reshape(a.shape[0], S, H, -1)
        b = b.float().reshape(b.shape[0], S, H, -1)
        worst = rel = 0.0
        for d in range(a.shape[0]):
            if not int(ln[d]):
                continue
            e = (a[d, :int(ln[d])] - b[d, :int(ln[d])]).abs()
            worst = max(worst, float(e.max()))
            peak = b[d, :int(ln[d])].abs().amax(-1).clamp_min(1e-30)
            rel = max(rel, float((e.amax(-1) / peak).max()))
        return worst, rel

    def within(errs, dt, tol):
        return errs[0] <= tol and (dt == torch.float32 or errs[1] <= tol)

    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        q = torch.randn((D_, S, H, hd), generator=gen, device="cuda").to(dt)
        k = torch.randn((D_, S, KV, hd), generator=gen, device="cuda").to(dt)
        v = torch.randn((D_, S, KV, hd), generator=gen, device="cuda").to(dt)
        q_sharp, v_sharp = (q.float() * 30).to(dt), (v.float() / 4).to(dt)
        route = pa.kernel_route(dt)
        cases = [(4096, cap), (0, cap), (256, cap), (20, cap), (0, 0.0)]
        if dt == torch.bfloat16:
            cases += [(0, cap, "sharp"), (20, cap, "sharp")]
        for window, softcap, *sharp in cases:
            qc, vc = (q_sharp, v_sharp) if sharp else (q, v)
            kw = dict(page_size=page, scale=scale, softcap=softcap, window=window)
            before = pa.paged_attention.launches
            got = pa.paged_attention(qc, k, vc, lens, **kw)
            after = (pa.paged_attention.launches, pa.paged_attention.last_route)
            want = pa.paged_attention_plain(qc, k, vc, lens, **kw)
            torch.cuda.synchronize()
            errs = valid_err(got, want, lens.tolist())
            sep = ""
            if softcap and (dt == torch.float32 or sharp):
                uncapped = pa.paged_attention_plain(qc, k, vc, lens, **{**kw, "softcap": 0.0})
                moved = valid_err(uncapped, want, lens.tolist())
                sep = (f"; the cap moves the plain output by {moved[0]:.3e} ({moved[1]:.3e} of "
                       f"a row)")
                if not moved[0] > 5 * tol:
                    fail(f"K1 softcap case cannot see the cap: it moves the output by {moved[0]} "
                         f"<= 5 x {tol}")
            log(f"K1 paged_attention {str(dt)[6:]} ({route}) window={window} softcap={softcap}"
                f"{' sharp logits' if sharp else ''}: max_abs_err={errs[0]:.3e}, row-relative "
                f"{errs[1]:.3e} (tol {tol}{'' if dt == torch.float32 else ' both'}){sep}")
            if not within(errs, dt, tol):
                fail(f"paged attention kernel disagrees with its plain version: {errs} > {tol}")
            if after != (before + 1, route):
                fail(f"paged attention in {dt} did not launch its {route} kernel")
        if dt == torch.float32:
            # the f32 (CUDA-core) kernel at the serve shape's lengths, timed
            lens_s = torch.tensor(lengths_serve, dtype=torch.int32, device="cuda")
            qs, ks, vs = (t[:1].expand(len(lengths_serve), *t.shape[1:]).contiguous()
                          for t in (q, k, v))
            kw = dict(page_size=page, scale=scale, softcap=cap, window=0)
            f32_err = valid_err(pa.paged_attention(qs, ks, vs, lens_s, **kw),
                                pa.paged_attention_plain(qs, ks, vs, lens_s, **kw),
                                lengths_serve)
            if not within(f32_err, dt, tol):
                fail(f"f32 paged attention kernel at the serve lengths: {f32_err} > {tol}")
            f32_ms = time_ms(lambda: pa.paged_attention(qs, ks, vs, lens_s, **kw), 10)
            f32_plain = time_ms(lambda: pa.paged_attention_plain(qs, ks, vs, lens_s, **kw), 3)
            pos = torch.arange(S, device="cuda")
            mask = ((pos[None, :, None] >= pos[None, None, :])
                    & (pos[None, None, :] < lens_s[:, None, None].long()))[:, None]
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (qs, ks, vs))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            f32_lib = time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask, scale=scale,
                                           enable_gqa=True), 10)
            n_tok = sum(lengths_serve)
            pairs = sum(t + 1 for ln in lengths_serve for t in range(ln))
            b_ms, b_by = bound(n_tok * (2 * H + 2 * KV) * hd * 4 + len(lengths_serve) * 4,
                               4 * hd * H * pairs, "fp32")
            log(f"K1 serve shape {len(lengths_serve)}x{S} f32 (cuda_cores): {f32_ms:.4f} ms "
                f"kernel, {f32_plain:.4f} ms plain, {f32_lib:.4f} ms sdpa f32 (explicit mask, "
                f"no softcap), bound {b_ms:.4f} ms by {b_by}")
            row_f32 = {"name": "paged_attention (f32)", "route": "cuda",
                       "source": "crosscoder_tpu_torch/csrc/paged_attention.cu",
                       "replaces": "crosscoder_tpu/ops/paged_attention.py:189",
                       "launches": None, "max_abs_err": f32_err[0], "ms": f32_ms,
                       "plain_ms": f32_plain, "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": f32_lib}
            del qs, ks, vs, qt, kt, vt, mask

    # Gemma-2-27B's heads (32 over 16 KV heads of 128) at its scale 144^-0.5
    # (q * scale rounds in bf16), lengths 0 (all zeros out), 1, around a
    # page, S - 1 and S, k at a storage offset that is not 16-byte aligned
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        S27, H27, KV27, hd27 = 448, 32, 16, 128
        lens27 = [0, 1, 63, 64, 65, S27 - 1, S27]
        q = torch.randn((7, S27, H27, hd27), generator=gen, device="cuda")
        k, v = (torch.randn((7, S27, KV27, hd27), generator=gen, device="cuda") for _ in range(2))
        if dt == torch.bfloat16:
            q, v = q * 30, v / 4
        q, v = q.to(dt), v.to(dt)
        k = torch.cat([torch.zeros(3, dtype=dt, device="cuda"), k.to(dt).flatten()])[3:]
        k = k.view(7, S27, KV27, hd27)
        lens = torch.tensor(lens27, dtype=torch.int32, device="cuda")
        for window in (0, 96):
            kw = dict(page_size=page, scale=144 ** -0.5, softcap=cap, window=window)
            got = pa.paged_attention(q, k, v, lens, **kw)
            want = pa.paged_attention_plain(q, k, v, lens, **kw)
            errs = valid_err(got, want, lens27, S27, H27)
            zeros = not bool(got[0].any())
            log(f"K1 paged_attention {str(dt)[6:]} ({pa.kernel_route(dt)}) Gemma-2-27B heads "
                f"32/16 x 128, scale 144^-0.5, window={window} softcap={cap}"
                f"{' sharp logits' if dt == torch.bfloat16 else ''}, lengths {lens27}: "
                f"max_abs_err={errs[0]:.3e}, row-relative {errs[1]:.3e} (tol {tol}); length 0 "
                f"{'all zeros' if zeros else 'NOT ZERO'}")
            if not (within(errs, dt, tol) and zeros):
                fail(f"paged attention at Gemma-2-27B's heads: {errs} > {tol} or a length-0 "
                     f"document not zero")
    del q, k, v

    # the bf16 entry's SASS: its products on wgmma (HGMMA), its pages by TMA
    # (UTMALDG), in each of its 8 instances (head_dim, page, softcap); and
    # ptxas's spills of it
    lib = _build._lib_path("paged_attention")
    sass = subprocess.run([str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=120).stdout
    counts: dict[str, dict[str, int]] = {}
    inst = None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            inst = (",".join(name.split("rpa_wg_kernelI")[1].split("EEEv")[0]
                             .replace("Li", "").replace("Lb", "").split("E"))
                    if "rpa_wg_kernelI" in name else None)
        elif inst:
            c = counts.setdefault(inst, {"HGMMA": 0, "UTMALDG": 0})
            for op in c:
                c[op] += f" {op}." in line or f" {op} " in line
    rep = kernel_safety.ptxas_report("paged_attention").get("rpa_wg_kernel", {})
    log(f"K1 bf16 entry rpa_wg_kernel<hd,page,softcap> SASS: {counts}; ptxas: "
        f"{rep.get('registers')} registers at entry, spills {rep.get('spill_stores')} B stored "
        f"/ {rep.get('spill_loads')} B loaded")
    if (len(counts) != 8 or any(c[op] == 0 for c in counts.values() for op in c)
            or rep.get("spill_stores", 1) or rep.get("spill_loads", 1)):
        fail(f"K1's bf16 entry: HGMMA/UTMALDG {counts}, ptxas {rep}")

    # the serve shape: 8 documents of the traffic's first micro-batch, bf16
    D_ = len(lengths_serve)
    lens = torch.tensor(lengths_serve, dtype=torch.int32, device="cuda")
    q = torch.randn((D_, S, H, hd), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((D_, S, KV, hd), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((D_, S, KV, hd), generator=gen, device="cuda").to(torch.bfloat16)
    kw = dict(page_size=page, scale=scale, softcap=cap, window=0)
    errs = valid_err(pa.paged_attention(q, k, v, lens, **kw),
                     pa.paged_attention_plain(q, k, v, lens, **kw), lengths_serve)
    if not within(errs, torch.bfloat16, 2e-2):
        fail(f"paged attention kernel at the serve shape: {errs} > 2e-2")
    err = errs[0]
    ms = time_ms(lambda: pa.paged_attention(q, k, v, lens, **kw), 20)
    plain_ms = time_ms(lambda: pa.paged_attention_plain(q, k, v, lens, **kw), 5)
    pos = torch.arange(S, device="cuda")
    mask = ((pos[None, :, None] >= pos[None, None, :])
            & (pos[None, None, :] < lens[:, None, None].long()))[:, None]    # [D,1,S,S]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True), 20)
    n_tok = sum(lengths_serve)
    pairs = sum(t + 1 for ln in lengths_serve for t in range(ln))
    n_bytes = n_tok * (2 * H + 2 * KV) * hd * 2 + D_ * 4
    n_ops = 4 * hd * H * pairs
    b_ms, b_by = bound(n_bytes, n_ops, "bf16")
    log(f"K1 serve shape {D_}x{S} bf16 (tensor_cores, wgmma + TMA): {ms:.4f} ms kernel "
        f"(mma.sync design [{CUDA_CORE_MS['K1 serve mma.sync']}], CUDA-core design "
        f"[{CUDA_CORE_MS['K1 serve']}]), {plain_ms:.4f} ms plain, {library_ms:.4f} ms "
        f"sdpa, bound {b_ms:.4f} ms by {b_by}")
    return {"name": "paged_attention", "route": "cuda",
            "source": "crosscoder_tpu_torch/csrc/paged_attention.cu",
            "replaces": "crosscoder_tpu/ops/paged_attention.py:189",
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}, row_f32


def _bits(t, torch):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)


def check_fused_topk(torch, fek):
    """K2: bitwise on exact inputs, near-tie agreement on random bf16, and
    the serve-shape timing; returns its kernel-table row."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    B, nd, width = 12, 4608, 2 ** 14 + 96
    for dt in (torch.bfloat16, torch.float32):
        x = torch.randint(-3, 4, (B, nd), generator=gen, device="cuda").float()
        W = torch.randint(-3, 4, (nd, width), generator=gen, device="cuda").float()
        b = torch.randint(-8, 9, (width,), generator=gen, device="cuda").float()
        W[:, 100:164] = W[:, 36:100]          # duplicate columns: exact ties
        W[:, 5000] = W[:, 7]
        b[5000] = b[7]
        x[1] = float("nan")                   # a NaN row: every slot NaN, nothing emitted
        x[2] = -0.0                           # a -0.0 row against -0.0 and NaN biases
        b[200] = -0.0
        b[300] = float("nan")                 # a NaN column: takes a slot, dropped at emit
        x[3] = 0.0
        x, W = x.to(dt), W.to(dt)
        for k in (1, 32, 128):
            vk, ik = fek.fused_topk_encode(x, W, b, k)
            vp, ip = fek.fused_topk_encode_plain(x, W, b, k)
            torch.cuda.synchronize()
            same = torch.equal(_bits(vk, torch), _bits(vp, torch)) and torch.equal(ik, ip)
            log(f"K2 fused_topk exact {str(dt)[6:]} k={k}: bitwise {'equal' if same else 'DIFFERENT'}")
            if not same:
                bad = (ik != ip).any(dim=1).nonzero().flatten().tolist()
                fail(f"fused topk kernel not bitwise equal to its plain version (rows {bad})")

    # random bf16 at the serve shape: index sets agree up to near-ties
    B, width, k = 8, 2 ** 14, 32
    W = (torch.randn((nd, width), generator=gen, device="cuda") * nd ** -0.5).to(torch.bfloat16)
    b = torch.zeros(width, device="cuda", dtype=torch.bfloat16)
    rows = agree = 0
    err = 0.0
    for _ in range(8):
        x = torch.randn((B, nd), generator=gen, device="cuda").to(torch.bfloat16)
        vk, ik = fek.fused_topk_encode(x, W, b, k)
        vp, ip = fek.fused_topk_encode_plain(x, W, b, k)
        hf = torch.matmul(x.float(), W.float()) + b.float()
        for r in range(B):
            rows += 1
            sk, sp = set(ik[r].tolist()), set(ip[r].tolist())
            if sk == sp:
                agree += 1
                err = max(err, float((vk[r].float() - vp[r].float()).abs().max()))
                continue
            for i in sk - sp:
                for j in sp - sk:
                    a, c = float(hf[r, i]), float(hf[r, j])
                    ulp = 2.0 ** (math.floor(math.log2(max(abs(a), abs(c), 1e-30))) - 7)
                    if abs(a - c) > ulp:
                        fail(f"fused topk row {r}: latents {i} and {j} differ by "
                             f"{abs(a - c)} > 1 bf16 ulp ({ulp}) yet only one was selected")
    log(f"K2 fused_topk random bf16 [{B},{nd}]x[{nd},{width}] k={k}: index sets agree on "
        f"{agree}/{rows} rows, every other row a near-tie; max |dvals| on agreeing rows {err:.3e}")

    ms = time_ms(lambda: fek.fused_topk_encode(x, W, b, k), 50)
    q_ms = time_ms(lambda: fek.fused_topk_encode(x, W, b, k), 50, queued=True)
    plain_ms = time_ms(lambda: fek.fused_topk_encode_plain(x, W, b, k), 10)
    library_ms = time_ms(lambda: torch.topk(torch.matmul(x, W), k), 50)
    n_bytes = x.numel() * 2 + W.numel() * 2 + width * 4 + B * k * (2 + 4)
    b_ms, b_by = bound(n_bytes, 2 * B * nd * width, "bf16")
    log(f"K2 serve shape: {ms:.4f} ms kernel ({q_ms:.4f} ms queued; CUDA-core design "
        f"[{CUDA_CORE_MS['K2 serve']}]), {plain_ms:.4f} ms plain, {library_ms:.4f} ms "
        f"matmul+topk, bound {b_ms:.4f} ms by {b_by}")
    # exact inputs at the serve shape, both dtypes
    for dt in (torch.bfloat16, torch.float32):
        xe = torch.randint(-2, 3, (B, nd), generator=gen, device="cuda").to(dt)
        We = torch.randint(-2, 3, (nd, width), generator=gen, device="cuda").to(dt)
        be = torch.randint(-8, 9, (width,), generator=gen, device="cuda").float()
        vk, ik = fek.fused_topk_encode(xe, We, be, k)
        vp, ip = fek.fused_topk_encode_plain(xe, We, be, k)
        torch.cuda.synchronize()
        same = torch.equal(_bits(vk, torch), _bits(vp, torch)) and torch.equal(ik, ip)
        log(f"K2 fused_topk serve shape [{B},{nd}]x[{nd},{width}] {str(dt)[6:]} exact: bitwise "
            f"{'equal' if same else 'DIFFERENT'}")
        if not same:
            fail("K2 not bitwise equal to its plain version at the serve shape")
    return {"name": "fused_topk_encode", "route": "cuda",
            "source": "crosscoder_tpu_torch/csrc/fused_topk.cu",
            "replaces": "crosscoder_tpu/ops/fused_encoder_topk.py:353",
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms, "queued_ms": q_ms}


# ---------------------------------------------------------------------------
# phase 4: serve


def check_result(r, k: int, width: int) -> None:
    import numpy as np

    if r.vals.shape != (k,) or r.idx.shape != (k,) or r.diff.shape != (k,):
        fail(f"request {r.request_id}: shapes {r.vals.shape} {r.idx.shape} {r.diff.shape}")
    if not (np.isfinite(r.vals).all() and np.isfinite(r.diff).all()):
        fail(f"request {r.request_id}: non-finite output")
    n = int((r.vals != 0).sum())
    if n == 0 or (r.vals[n:] != 0).any() or (r.idx[n:] != 0).any():
        fail(f"request {r.request_id}: emitted slots not a (0, 0)-padded prefix")
    if not ((r.idx[:n] >= 0).all() and (r.idx[:n] < width).all()
            and (np.diff(r.idx[:n]) > 0).all()):
        fail(f"request {r.request_id}: idx not ascending in [0, {width})")
    if not ((r.diff >= 0).all() and (r.diff <= 1).all()):
        fail(f"request {r.request_id}: diff outside [0, 1]")


def overlap(vals_a, idx_a, vals_b, idx_b) -> float:
    """Jaccard overlap of two rows' emitted latent sets."""
    sa, sb = set(idx_a[vals_a != 0].tolist()), set(idx_b[vals_b != 0].tolist())
    return len(sa & sb) / max(1, len(sa | sb))


def profile_batch(torch, eng, smoke, docs) -> None:
    """Device time by kernel for one full micro-batch (``torch.profiler``),
    grouped into the two ported kernels, matmuls and the rest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    smoke.serve_batch(eng, docs)
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        smoke.serve_batch(eng, docs)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3

    dev_us = _dev_us

    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(dev_us(e) for e in kernels) / 1e3
    if total <= 0:
        log("profile: the profiler recorded no device time (not measured)")
        return
    groups = {"paged_attention (K1)": 0.0, "fused_topk (K2)": 0.0, "matmul": 0.0, "other": 0.0}
    for e in kernels:
        n = e.key.lower()
        g = ("paged_attention (K1)" if "rpa_" in n else
             "fused_topk (K2)" if "topk_tiles" in n or "topk_merge" in n else
             "matmul" if any(t in n for t in ("gemm", "xmma", "cutlass", "nvjet", "cublas"))
             else "other")
        groups[g] += dev_us(e) / 1e3
    log(f"profile: one micro-batch of {len(docs)} requests: {wall_ms:.3f} ms wall unprofiled, "
        f"{prof_wall_ms:.3f} ms profiled, {total:.3f} ms device busy "
        f"({100 * total / prof_wall_ms:.1f}% of the profiled wall)")
    for g, ms in groups.items():
        log(f"profile:   {g}: {ms:.3f} ms ({100 * ms / total:.1f}% of device time)")
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        log(f"profile:   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")


def serve(torch, np, lengths_a):
    from crosscoder_tpu_torch.models import lm
    from crosscoder_tpu_torch.ops import fused_encoder_topk as fek
    from crosscoder_tpu_torch.ops import paged_attention as pa
    from crosscoder_tpu_torch.serve import smoke
    from crosscoder_tpu_torch.utils.dtypes import dtype_of

    t0 = time.perf_counter()
    eng, cfg, lm_cfg, _, _ = smoke.build_engine(
        serve_max_batch=8, seq_len=1024, lm_cfg=lm.LMConfig.gemma2_2b(),
        hook_points=("blocks.14.hook_resid_pre",), device="cuda", seeds=(1, 2, 3),
        dict_size=2 ** 14, topk_k=32, page_size=64, enc_dtype="bf16")
    torch.cuda.synchronize()
    log(f"serve: two random-init Gemma-2-2B (bf16) + crosscoder 16384x{cfg.topk_k} built "
        f"in {time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    t0 = time.perf_counter()
    eng.warmup()
    log(f"serve: warmup of buckets {eng.buckets} in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(5)
    V = lm_cfg.vocab_size

    def docs_of(lengths):
        return [rng.integers(1, V, size=int(n), dtype=np.int32) for n in lengths]

    batch_a = docs_of(lengths_a)
    more = [docs_of(rng.integers(1, 1025, size=8)) for _ in range(3)]
    partial = docs_of([700, 33, 1])
    keep_doc, extra = docs_of([400, 212])

    pa.paged_attention.launches = 0
    pa.paged_attention.by_route.update(dict.fromkeys(pa.paged_attention.by_route, 0))
    fek.fused_topk_encode.launches = 0
    served = [smoke.serve_batch(eng, batch_a)]
    served += [smoke.serve_batch(eng, d) for d in more]
    served.append(smoke.serve_batch(eng, partial))
    rid = eng.submit(keep_doc, keep=True)
    served.append(eng.step(force=True))
    eng.extend(rid, extra)
    ext = eng.step(force=True)
    served.append(ext)
    eng.release(rid)
    torch.cuda.synchronize()
    by_route = dict(pa.paged_attention.by_route)
    launches = {"paged_attention": pa.paged_attention.launches,
                "paged_attention (f32)": by_route["cuda_cores"],
                "fused_topk_encode": fek.fused_topk_encode.launches}
    log(f"serve: {sum(len(s) for s in served)} requests in {len(served)} micro-batches; "
        f"kernel launches {launches}; paged attention by route {by_route}")
    if not (launches["paged_attention"] and launches["fused_topk_encode"]):
        fail(f"a kernel of the serve path never launched: {launches}")
    # the route is the dtype's (kernel_route), and every layer's q is the model's bf16
    if (by_route["tensor_cores"] != launches["paged_attention"]
            or pa.kernel_route(dtype_of(lm_cfg.dtype)) != "tensor_cores"):
        fail(f"the bf16 serve path's attention did not run on the tensor-core kernel alone: "
             f"{by_route}")
    if [r.bucket for r in served[4]] != [4, 4, 4]:
        fail(f"partial batch of 3 served under buckets {[r.bucket for r in served[4]]}")
    if not (len(ext) == 1 and ext[0].extended):
        fail("the extend ticket was not served")
    for batch in served:
        for r in batch:
            check_result(r, cfg.topk_k, cfg.dict_size)

    # batch A again with both plain versions, same device, same packing
    vals_p, idx_p, diff_p, last_p = smoke.serve_plain(eng, batch_a)
    last_k = smoke.serve_docs(eng, batch_a)[3].float()
    rel = float(torch.linalg.norm(last_k - last_p.float()) / torch.linalg.norm(last_p.float()))
    ov = [overlap(r.vals, r.idx, vals_p[i], idx_p[i]) for i, r in enumerate(served[0])]
    log(f"serve vs plain re-run (batch A, lengths {list(lengths_a)}): last-token activation "
        f"relative error {rel:.3e} (tol 5e-2); latent-set overlap mean {np.mean(ov):.3f} "
        f"min {min(ov):.3f} (tol mean >= 0.75)")
    if not (rel <= 5e-2 and np.mean(ov) >= 0.75):
        fail("serve path disagrees with its plain re-run beyond the bf16 tolerance")
    for i, r in enumerate(served[0]):
        common = np.intersect1d(r.idx[r.vals != 0], idx_p[i][vals_p[i] != 0])
        a = r.vals[np.searchsorted(r.idx[r.vals != 0], common)]
        c = vals_p[i][np.searchsorted(idx_p[i][vals_p[i] != 0], common)]
        if not np.allclose(a, c, rtol=5e-2, atol=5e-2 * float(np.abs(c).max())):
            fail(f"request {i}: vals on shared latents differ beyond rtol 5e-2")
        d_a = r.diff[np.searchsorted(r.idx[r.vals != 0], common)]
        d_c = diff_p[i][np.searchsorted(idx_p[i][vals_p[i] != 0], common)]
        if not np.array_equal(d_a, d_c):
            fail(f"request {i}: diff scores on shared latents differ")

    # the partial batch against the padded (page-free) forward
    toks = np.zeros((3, cfg.seq_len), np.int64)
    for i, d in enumerate(partial):
        toks[i, : len(d)] = d
    vals_o, idx_o, _ = smoke.oracle(eng, toks, [len(d) for d in partial])
    ov_o = [overlap(r.vals, r.idx, vals_o[i], idx_o[i]) for i, r in enumerate(served[4])]
    log(f"serve vs padded forward (partial batch): latent-set overlap {ov_o} (tol mean >= 0.75)")
    if np.mean(ov_o) < 0.75:
        fail("paged serve path disagrees with the padded forward")
    profile_batch(torch, eng, smoke, batch_a)
    st = eng.stats()
    log(f"serve: prefill p50 {st['serve/prefill_ms_p50']:.3f} ms, encode p50 "
        f"{st['serve/encode_ms_p50']:.3f} ms over {st['serve/prefill_ms_n']} micro-batches "
        f"(warmup included)")
    return launches, eng


# ---------------------------------------------------------------------------
# phase 5: training kernels vs plain


def _row(name, source, replaces, err, ms, plain_ms, b, library_ms):
    return {"name": name, "route": "cuda", "source": f"crosscoder_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1], "library_ms": library_ms}


def _planted_rows(torch, gen, R, W):
    """Integer-valued bf16 rows with exact ties, rows with fewer than k
    positives, -0.0 and NaN of both signs."""
    h = torch.randint(-6, 7, (R, W), generator=gen, device="cuda").float()
    h[0, : W // 2] = 5.0
    h[1] = -1.0
    h[1, 3] = 2.0
    h[2] = -0.0
    h[3, 5] = float("nan")
    h[5, 100:300] = 6.0
    h = h.to(torch.bfloat16)
    bits = h.view(torch.int16)
    bits[4, 7], bits[4, 9], bits[4, 11] = -1, 0x7FFF, -64       # 0xFFFF, 0x7FFF, 0xFFC0
    bits[6, :] = -64                                            # a row of negative NaNs
    return h


def check_topk_mask_and_sparsify(torch, tp):
    """K5 and K8 bitwise against their plain versions at [4096, 32768] bf16;
    returns their kernel-table rows."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    R, W = TRAIN["batch_size"], TRAIN["dict_size"]
    h = _planted_rows(torch, gen, R, W)
    for k in (1, 32, 128):
        f = tp.topk(h, k)
        same5 = torch.equal(_bits(f, torch), _bits(tp.topk_plain(h, k), torch))
        fo = f.clone()
        fo[0, ::3] = 1.0                                        # a row far past k
        vk, ik = tp.sparsify(fo, k)
        vp, ip = tp.sparsify_plain(fo, k)
        same8 = torch.equal(_bits(vk, torch), _bits(vp, torch)) and torch.equal(ik, ip)
        v32, i32 = tp.sparsify(fo.float(), k)
        w32, j32 = tp.sparsify_plain(fo.float(), k)
        same8 = same8 and torch.equal(_bits(v32, torch), _bits(w32, torch)) and torch.equal(i32, j32)
        torch.cuda.synchronize()
        log(f"K5 topk_mask [{R},{W}] bf16 k={k}: bitwise {'equal' if same5 else 'DIFFERENT'}; "
            f"K8 sparsify bf16+f32: bitwise {'equal' if same8 else 'DIFFERENT'}")
        if not (same5 and same8):
            fail(f"K5/K8 not bitwise equal to their plain versions at k={k}")
    k = TRAIN["topk_k"]
    h = torch.randn((R, W), generator=gen, device="cuda").to(torch.bfloat16)
    f = tp.topk(h, k)
    if not torch.equal(_bits(f, torch), _bits(tp.topk_plain(h, k), torch)):
        fail("K5 not bitwise equal to its plain version on random bf16 rows")
    n = R * W * 2

    def topk_scatter():
        v, i = torch.topk(h, k)
        return torch.zeros_like(h).scatter_(1, i, torch.relu(v))

    ms = time_ms(lambda: tp.topk(h, k), 20)
    plain_ms = time_ms(lambda: tp.topk_plain(h, k), 3)
    lib_ms = time_ms(topk_scatter, 20)
    b = bound(2 * n, 0, "bf16")
    log(f"K5 [{R},{W}] k={k} (topk_slice.cuh, one block a row: cluster size 1): {ms:.4f} ms "
        f"kernel, {plain_ms:.4f} ms plain, {lib_ms:.4f} ms topk+scatter, bound {b[0]:.4f} ms by "
        f"{b[1]}")
    row5 = _row("topk_mask", "topk_mask.cu", "crosscoder_tpu/ops/topk_pallas.py:157", 0.0,
                ms, plain_ms, b, lib_ms)
    vals, idx = tp.sparsify(f, k)
    vp, ip = tp.sparsify_plain(f, k)
    if not (torch.equal(_bits(vals, torch), _bits(vp, torch)) and torch.equal(idx, ip)):
        fail("K8 not bitwise equal to its plain version on the masked random rows")
    return row5, time_sparsify(torch, tp, f, k, "sparsify")


def time_sparsify(torch, tp, f, k, name):
    """K8's kernel-table row at ``f``'s shape: back to back and queued,
    beside its plain version, topk + sort and the bound."""
    R, W = f.shape

    def topk_sort():
        v, i = torch.topk(f, k)
        i, o = torch.sort(i, dim=1)
        return torch.gather(v, 1, o), i

    route = tp.sparsify_plan(W, k, f.dtype)
    ms = time_ms(lambda: tp.sparsify(f, k), 20)
    q_ms = time_ms(lambda: tp.sparsify(f, k), 20, queued=True)
    plain_ms = time_ms(lambda: tp.sparsify_plain(f, k), 3)
    lib_ms = time_ms(topk_sort, 20)
    b = bound(f.numel() * f.element_size() + R * k * (f.element_size() + 4), 0, "bf16")
    log(f"K8 [{R},{W}] {str(f.dtype)[6:]} k={k} (route {route}): {ms:.4f} ms kernel ({q_ms:.4f} "
        f"ms queued), {plain_ms:.4f} ms plain, {lib_ms:.4f} ms topk+sort, bound {b[0]:.4f} ms "
        f"by {b[1]}")
    return {**_row(name, "sparsify.cu", "crosscoder_tpu/ops/topk_pallas.py:662", 0.0, ms,
                   plain_ms, b, lib_ms), "queued_ms": q_ms}


def check_sparsify_shapes(torch, tp):
    """K8 bitwise against its plain version on TopK masks (k = 32) of
    random rows at the other main-path shapes, with a row far past k, a row
    of exactly k and rows past k whose last positive closes each eighth of
    the row (so lies in each part of a split); each timed. Then its warp
    route, for k past the split route's staging limit, at [4096, 32768] bf16.
    Returns their kernel-table rows."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    k = TRAIN["topk_k"]
    rows = []
    for R, W, dt, leg in ((4096, 2 ** 17, torch.bfloat16, "leg W"),
                          (4096, 2 ** 14, torch.float32, "leg F"),
                          (4096, 2 ** 15, torch.float32, "leg V")):
        f = tp.topk(torch.randn((R, W), generator=gen, device="cuda").to(dt), k)
        g = f.clone()
        g[0, ::3] = 1.0                                          # far past k
        for i in range(8):                                       # k + 1, the last in eighth i
            g[1 + i] = 0.0
            g[1 + i, torch.randperm((i + 1) * W // 8, generator=gen, device="cuda")[:k + 1]] = 2.0
            g[1 + i, (i + 1) * W // 8 - 1] = 2.0
        g[9] = 0.0
        g[9, torch.randperm(W, generator=gen, device="cuda")[:k]] = 2.0  # exactly k
        for kk in (1, k, 128):
            vk, ik = tp.sparsify(g, kk)
            vp, ip = tp.sparsify_plain(g, kk)
            if not (torch.equal(_bits(vk, torch), _bits(vp, torch)) and torch.equal(ik, ip)):
                fail(f"K8 not bitwise equal to its plain version at {dt} [{R}, {W}], k={kk}")
        vk, ik = tp.sparsify(f, k)
        vp, ip = tp.sparsify_plain(f, k)
        if not (torch.equal(_bits(vk, torch), _bits(vp, torch)) and torch.equal(ik, ip)):
            fail(f"K8 not bitwise equal to its plain version on {dt} [{R}, {W}] masks")
        log(f"K8 sparsify [{R},{W}] {str(dt)[6:]}: bitwise equal at k 1, 32, 128 on planted "
            f"rows and on TopK masks")
        rows.append(time_sparsify(torch, tp, f, k, f"sparsify ({str(dt)[6:]} [{R}, {W}], {leg})"))
        del f, g, vk, vp
    kw = tp._SPLIT_MAX_K + 1
    f = tp.topk(torch.randn((4096, 2 ** 15), generator=gen, device="cuda").to(torch.bfloat16), kw)
    before = tp.sparsify.by_route["warp"]
    vk, ik = tp.sparsify(f, kw)
    vp, ip = tp.sparsify_plain(f, kw)
    if not (torch.equal(_bits(vk, torch), _bits(vp, torch)) and torch.equal(ik, ip)
            and tp.sparsify.by_route["warp"] == before + 1):
        fail(f"K8's warp route (k={kw}) not bitwise equal to its plain version, or not taken")
    rows.append(time_sparsify(torch, tp, f, kw, f"sparsify (warp route, bf16 [4096, 32768], "
                                               f"k {kw})"))
    return rows


def auxk_pairs(torch, gen, B, H, k_aux, n_dead):
    """The AuxK term's pairs as ``models/crosscoder.get_losses`` makes them:
    ``n_dead`` dead latents at random columns; each row ranks its
    pre-activations with every live latent at ``finfo.min``, keeps its top
    ``k_aux`` by the port's exact ranking (ties to the lowest column) and
    zeroes the values of the live columns that fill its slots."""
    from crosscoder_tpu_torch.models.crosscoder import _exact_topk_indices

    h = torch.randn((B, H), generator=gen, device="cuda")
    dead = torch.zeros(H, dtype=torch.bool, device="cuda")
    dead[torch.randperm(H, generator=gen, device="cuda")[:n_dead]] = True
    ranked = torch.where(dead[None, :], h, torch.finfo(h.dtype).min)
    aidx = _exact_topk_indices(ranked, k_aux)
    avals = torch.where(dead[aidx], torch.gather(h, 1, aidx), 0.0)
    return avals, aidx


def pair_histogram(torch, idx, n_out):
    """The destination histogram of a scatter's pairs."""
    d = idx.reshape(-1).long()
    cnt = torch.bincount(d[(d >= 0) & (d < n_out)], minlength=n_out)
    blocks = torch.nn.functional.pad(cnt, (0, -n_out % 32)).reshape(-1, 32).sum(1)
    return {"pairs": int(cnt.sum()), "destinations": int((cnt > 0).sum()),
            "max": int(cnt.max()), ">128": int((cnt > 128).sum()),
            ">512": int((cnt > 512).sum()), ">2048": int((cnt > 2048).sum()),
            "busiest 32-row block": int(blocks.max())}


def work_list_equal(torch, sg, coeff, idx, n_out):
    """K10's work list built on the card against its plain version."""
    dst = sg.sorted_pairs(coeff, idx, n_out)[0]
    return torch.equal(sg.work_list(dst, n_out), sg.work_list_plain(dst, n_out))


def check_scatter(torch, sg):
    """K10 bitwise against its plain version at the sparse step's shapes
    and at the AuxK term's crowded shape (leg F: f32, dict 2^14, k_aux 64,
    the filler pattern with 0, AUXK_DEAD and 63 dead latents); returns its
    kernel-table rows at the main shape and at the AuxK shape."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    B, k, H = TRAIN["batch_size"], TRAIN["topk_k"], TRAIN["dict_size"]
    nd = TRAIN["n_models"] * TRAIN["d_in"]
    for kk, m, dt in ((k, nd, torch.float32), (k, nd + 128, torch.float32),
                      (TRAIN["aux_k"], nd, torch.float32), (k, nd, torch.bfloat16)):
        cf = torch.randn((B, kk), generator=gen, device="cuda")
        idx = torch.randint(0, H, (B, kk), generator=gen, device="cuda", dtype=torch.int32)
        idx[:, 0] = 3                                   # a latent hit by every row
        idx[0, 1], idx[1, 1] = -1, H                    # dropped
        rows = torch.randn((B, m), generator=gen, device="cuda").to(dt)
        got = sg.scatter_add_rows(cf, idx, rows, H)
        want = sg.scatter_add_rows_plain(cf, idx, rows, H)
        torch.cuda.synchronize()
        same = torch.equal(_bits(got, torch), _bits(want, torch))
        log(f"K10 scatter pairs {B}x{kk} rows [{B},{m}] {str(dt)[6:]}: bitwise "
            f"{'equal' if same else 'DIFFERENT'}")
        if not same:
            fail("K10 not bitwise equal to its plain version")
    H_f, k_aux = LEG_F["dict_size"], LEG_F["aux_k"]
    for n_dead, dt in ((0, torch.float32), (AUXK_DEAD, torch.float32), (63, torch.float32),
                       (AUXK_DEAD, torch.bfloat16)):
        cf, idx = auxk_pairs(torch, gen, B, H_f, k_aux, n_dead)
        rows = torch.randn((B, nd), generator=gen, device="cuda").to(dt)
        got = sg.scatter_add_rows(cf, idx, rows, H_f)
        want = sg.scatter_add_rows_plain(cf, idx, rows, H_f)
        same_list = work_list_equal(torch, sg, cf, idx, H_f)
        torch.cuda.synchronize()
        same = torch.equal(_bits(got, torch), _bits(want, torch))
        log(f"K10 AuxK filler pattern, {n_dead} dead of {H_f}, pairs {B}x{k_aux} rows "
            f"[{B},{nd}] {str(dt)[6:]}: {pair_histogram(torch, idx, H_f)}; bitwise "
            f"{'equal' if same else 'DIFFERENT'}; work list "
            f"{'equal' if same_list else 'DIFFERENT'}")
        if not (same and same_list):
            fail("K10 or its work list not equal to its plain version on the AuxK filler pattern")
    rows_out = []
    # timing on the dW_dec call's shape (random latents, no planted
    # duplicates) and on the AuxK term's (AUXK_DEAD dead latents)
    main_pairs = (torch.randn((B, k), generator=gen, device="cuda"),
                  torch.randint(0, H, (B, k), generator=gen, device="cuda", dtype=torch.int32))
    for label, n_out, (cf, idx) in (("main", H, main_pairs),
                                    ("AuxK", H_f, auxk_pairs(torch, gen, B, H_f, k_aux,
                                                             AUXK_DEAD))):
        kk = idx.shape[1]
        rows = torch.randn((B, nd), generator=gen, device="cuda")
        if not torch.equal(_bits(sg.scatter_add_rows(cf, idx, rows, n_out), torch),
                           _bits(sg.scatter_add_rows_plain(cf, idx, rows, n_out), torch)):
            fail(f"K10 not bitwise equal to its plain version on the {label} timing pairs")
        if not work_list_equal(torch, sg, cf, idx, n_out):
            fail(f"K10's work list differs from its plain version on the {label} pairs")

        def index_add():
            upd = cf.reshape(-1, 1) * rows.repeat_interleave(kk, dim=0)
            return torch.zeros((n_out, nd), device="cuda").index_add_(
                0, idx.reshape(-1).long(), upd)

        def k10():
            return sg.scatter_add_rows(cf, idx, rows, n_out)

        ms = time_ms(k10, 20)
        q_ms = time_ms(k10, 20, queued=True)
        issue_ms = host_ms(k10, 20)
        plain_ms = time_ms(lambda: sg.scatter_add_rows_plain(cf, idx, rows, n_out), 3)
        lib_ms = time_ms(index_add, 5)
        b = bound(B * nd * 4 + B * kk * 8 + n_out * nd * 4, 2 * B * kk * nd, "fp32")
        log(f"K10 {label} shape, pairs {B}x{kk} rows [{B},{nd}] -> [{n_out},{nd}] f32: "
            f"{ms:.4f} ms kernel ({q_ms:.4f} ms queued; the host issues a call in "
            f"{issue_ms:.4f} ms), {plain_ms:.4f} ms plain, {lib_ms:.4f} ms index_add_, bound "
            f"{b[0]:.4f} ms by {b[1]}")
        profile_kernels(torch, k10, f"K10 {label} shape", {"K10 scatter_rows": "scatter_rows"})
        row = {**_row("scatter_add_rows", "scatter_rows.cu",
                      "crosscoder_tpu/ops/sparse_grad.py:212", 0.0, ms, plain_ms, b, lib_ms),
               "queued_ms": q_ms}
        if label == "AuxK":
            row["name"] = "scatter_add_rows (AuxK shape)"
        rows_out.append(row)
    return rows_out


def check_fused_topk_train(torch, fek):
    """K2 at the training shape: bitwise on exact inputs, then timed on
    random bf16; returns its kernel-table row."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    B, H, k = TRAIN["batch_size"], TRAIN["dict_size"], TRAIN["topk_k"]
    nd = TRAIN["n_models"] * TRAIN["d_in"]
    x = torch.randint(-2, 3, (B, nd), generator=gen, device="cuda").to(torch.bfloat16)
    W = torch.randint(-2, 3, (nd, H), generator=gen, device="cuda").to(torch.bfloat16)
    b = torch.randint(-8, 9, (H,), generator=gen, device="cuda").float()
    for dt in (torch.bfloat16, torch.float32):
        vk, ik = fek.fused_topk_encode(x.to(dt), W.to(dt), b, k)
        vp, ip = fek.fused_topk_encode_plain(x.to(dt), W.to(dt), b, k)
        torch.cuda.synchronize()
        same = torch.equal(_bits(vk, torch), _bits(vp, torch)) and torch.equal(ik, ip)
        log(f"K2 fused_topk training shape [{B},{nd}]x[{nd},{H}] k={k} {str(dt)[6:]} exact: "
            f"bitwise {'equal' if same else 'DIFFERENT'}")
        if not same:
            fail("K2 not bitwise equal to its plain version at the training shape")
    # a wide dictionary: the merge takes a first level over groups of tiles
    for Bw, Hw, kw in ((512, LEG_W["dict_size"], k), (512, H + 128, 128)):
        x = torch.randint(-2, 3, (Bw, nd), generator=gen, device="cuda").to(torch.bfloat16)
        W = torch.randint(-2, 3, (nd, Hw), generator=gen, device="cuda").to(torch.bfloat16)
        W[:, Hw - 64:] = W[:, :64]                       # ties across the groups
        b = torch.randint(-8, 9, (Hw,), generator=gen, device="cuda").float()
        vk, ik = fek.fused_topk_encode(x, W, b, kw)
        vp, ip = fek.fused_topk_encode_plain(x, W, b, kw)
        torch.cuda.synchronize()
        same = torch.equal(_bits(vk, torch), _bits(vp, torch)) and torch.equal(ik, ip)
        log(f"K2 fused_topk [{Bw},{nd}]x[{nd},{Hw}] k={kw} exact (two-level merge, "
            f"{-(-Hw // fek._CW)} tiles): bitwise {'equal' if same else 'DIFFERENT'}")
        if not same:
            fail("K2 not bitwise equal to its plain version at a wide dictionary")
    x = torch.randn((B, nd), generator=gen, device="cuda").to(torch.bfloat16)
    W = (torch.randn((nd, H), generator=gen, device="cuda") * nd ** -0.5).to(torch.bfloat16)
    b = torch.zeros(H, device="cuda")
    ms = time_ms(lambda: fek.fused_topk_encode(x, W, b, k), 5)
    q_ms = time_ms(lambda: fek.fused_topk_encode(x, W, b, k), 5, queued=True)
    plain_ms = time_ms(lambda: fek.fused_topk_encode_plain(x, W, b, k), 3)
    lib_ms = time_ms(lambda: torch.topk(torch.matmul(x, W), k), 10)
    bnd = bound(x.numel() * 2 + W.numel() * 2 + H * 4 + B * k * 6, 2 * B * nd * H, "bf16")
    log(f"K2 training shape: {ms:.4f} ms kernel ({q_ms:.4f} ms queued; CUDA-core design "
        f"[{CUDA_CORE_MS['K2 train']}]), {plain_ms:.4f} ms plain, {lib_ms:.4f} ms "
        f"matmul+topk, bound {bnd[0]:.4f} ms by {bnd[1]}")
    profile_kernels(torch, lambda: fek.fused_topk_encode(x, W, b, k), "K2 training shape",
                    {"product + tile sort (topk_tiles_tc)": "topk_tiles",
                     "merge (topk_merge_kernel)": "topk_merge"})
    return {**_row("fused_topk_encode", "fused_topk.cu",
                   "crosscoder_tpu/ops/fused_encoder_topk.py:353", 0.0, ms, plain_ms, bnd,
                   lib_ms), "name": "fused_topk_encode (train shape)", "queued_ms": q_ms}


def _dev_us(e):
    t = getattr(e, "self_device_time_total", None)
    return t if t is not None else getattr(e, "self_cuda_time_total", 0)


def profile_kernels(torch, fn, label, groups):
    """Device time of one call of ``fn`` by kernel, through torch.profiler:
    each group sums the kernels whose name holds its substring; the rest is
    every other kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(_dev_us(e) for e in kernels) / 1e3
    if total <= 0:
        log(f"profile {label}: the profiler recorded no device time (not measured)")
        return
    ms = {g: sum(_dev_us(e) for e in kernels if sub in e.key) / 1e3 for g, sub in groups.items()}
    parts = ", ".join(f"{g} {t:.4f} ms" for g, t in ms.items())
    log(f"profile {label}: {total:.4f} ms of device time: {parts}, the rest (copies, casts) "
        f"{total - sum(ms.values()):.4f} ms")


def _planted_wide(torch, gen, R, W, dtype):
    """Integer-valued rows for K6/K7: ties wider than k, a tie straddling
    the 4096-column stretch boundary, ties far from the kth column, rows
    with fewer than k positives, -0.0, +inf, NaN of both signs and (f32) a
    NaN beside +inf among a row's top k."""
    h = torch.randint(-6, 7, (R, W), generator=gen, device="cuda").float()
    h[0, : W // 2] = 5.0
    h[1] = -1.0
    h[1, 3] = 2.0
    h[2] = -0.0
    h[3, 4091:4101] = 9.0
    h[3, W - 3:] = 9.0
    h[4, 7] = h[4, W - 1] = float("inf")
    h[4, 9] = float("nan")
    h[5, W - 40:] = 8.0
    h[7, 100:300] = 6.0
    h = h.to(dtype)
    if dtype == torch.bfloat16:
        bits = h.view(torch.int16)
        bits[6, 11], bits[6, 12], bits[8, :] = -64, 0x7FFF, -64      # 0xFFC0, 0x7FFF
    else:
        bits = h.view(torch.int32)
        bits[6, 11], bits[6, 12], bits[8, :] = -4194304, 0x7FC00001, -4194304
    return h


def check_topk_wide(torch, tp):
    """K6 (f32 rows that fit shared memory) and K7 (any width, bf16 and
    f32: its cluster route at every cluster size, its streaming route past
    the cluster's reach) bitwise against their plain versions on planted
    rows, then timed on random rows at the legs' shapes and at STREAM_ROW;
    returns the K6, K7 bf16, K7 f32 and K7 streaming rows of the kernel
    table."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    B = TRAIN["batch_size"]
    cases = [("K6", tp.topk_mask_f32, tp.topk_plain, torch.float32, B, LEG_F["dict_size"]),
             ("K6", tp.topk_mask_f32, tp.topk_plain, torch.float32, B, 384),
             ("K7", tp.topk_chunked, tp.topk_chunked_plain, torch.bfloat16, B, LEG_W["dict_size"]),
             ("K7", tp.topk_chunked, tp.topk_chunked_plain, torch.float32, B, 2 ** 15),
             ("K7", tp.topk_chunked, tp.topk_chunked_plain, torch.bfloat16, 512, 2 ** 16 + 384),
             ("K7", tp.topk_chunked, tp.topk_chunked_plain, torch.bfloat16, 256, 2 ** 19 + 24),
             ("K7", tp.topk_chunked, tp.topk_chunked_plain, torch.float32, 256, 2 ** 17 + 8)]
    # K7's cluster route at every cluster size its plan uses, the last
    # slice full and ragged, ties straddling every slice edge
    for dtype in (torch.bfloat16, torch.float32):
        per = tp._SLICE_BYTES // (2 if dtype == torch.bfloat16 else 4)
        for n in range(1, tp._MAX_CLUSTER + 1):
            cases.append(("K7", tp.topk_chunked, tp.topk_chunked_plain, dtype, 16,
                          n * per - 24 * (n % 2)))
    for name, kern, plain, dtype, R, W in cases:
        h = _planted_wide(torch, gen, R, W, dtype)
        plan = tp.topk_plan(W, dtype) if name == "K7" else None
        if plan is not None and plan[1] > 1:
            for e in range(plan[2], W, plan[2]):
                h[3, e - 3: e + 3] = 9.0
                h[5, e - 20: e + 20] = 8.0
        for k in (1, 32, 128):
            got = kern(h, k)
            same = torch.equal(_bits(got, torch), _bits(plain(h, k), torch))
            routed = tp.topk_route(W, k, dtype) == name
            same = same and (not routed or torch.equal(_bits(tp.topk(h, k), torch),
                                                       _bits(got, torch)))
            torch.cuda.synchronize()
            log(f"{name} [{R},{W}] {str(dtype)[6:]} k={k}{' (via topk)' if routed else ''}"
                f"{f' plan {plan}' if plan else ''}: bitwise {'equal' if same else 'DIFFERENT'}; "
                f"kept a row min/max "
                f"{int((got != 0).sum(1).min())}/{int((got != 0).sum(1).max())}")
            if not same:
                bad = (_bits(got, torch) != _bits(plain(h, k), torch)).any(1).nonzero()
                fail(f"{name} not bitwise equal to its plain version at [{R},{W}] {dtype} k={k} "
                     f"(rows {bad.flatten()[:8].tolist()})")
        del h, got
    k = TRAIN["topk_k"]
    rows = []
    for name, kern, plain, dtype, R, W, source, replaces, label in (
            ("topk_mask_f32", tp.topk_mask_f32, tp.topk_plain, torch.float32, B,
             LEG_F["dict_size"], "topk_mask_f32.cu", "crosscoder_tpu/ops/topk_pallas.py:259", "K6"),
            ("topk_chunked", tp.topk_chunked, tp.topk_chunked_plain, torch.bfloat16, B,
             LEG_W["dict_size"], "topk_chunked.cu", "crosscoder_tpu/ops/topk_pallas.py:358", "K7"),
            ("topk_chunked (f32)", tp.topk_chunked, tp.topk_chunked_plain, torch.float32, B,
             2 ** 15, "topk_chunked.cu", "crosscoder_tpu/ops/topk_pallas.py:358", "K7"),
            ("topk_chunked (streaming)", tp.topk_chunked, tp.topk_chunked_plain, torch.bfloat16,
             STREAM_ROW[0], STREAM_ROW[1], "topk_chunked.cu",
             "crosscoder_tpu/ops/topk_pallas.py:358", "K7")):
        h = torch.randn((R, W), generator=gen, device="cuda").to(dtype)
        if not torch.equal(_bits(kern(h, k), torch), _bits(plain(h, k), torch)):
            fail(f"{label} not bitwise equal to its plain version on random {dtype} rows")

        def topk_scatter():
            v, i = torch.topk(h, k)
            return torch.zeros_like(h).scatter_(1, i, torch.relu(v))

        ms = time_ms(lambda: kern(h, k), 20)
        q_ms = time_ms(lambda: kern(h, k), 20, queued=True)
        plain_ms = time_ms(lambda: plain(h, k), 2)
        lib_ms = time_ms(topk_scatter, 10)
        b = bound(2 * h.numel() * h.element_size(), 0, "bf16")
        plan = f", plan {tp.topk_plan(W, dtype)}" if label == "K7" else ""
        log(f"{label} [{R},{W}] {str(dtype)[6:]} k={k}{plan}: {ms:.4f} ms kernel ({q_ms:.4f} ms "
            f"queued), {plain_ms:.4f} ms plain, {lib_ms:.4f} ms topk+scatter, bound {b[0]:.4f} ms "
            f"by {b[1]}")
        rows.append({**_row(name, source, replaces, 0.0, ms, plain_ms, b, lib_ms),
                     "queued_ms": q_ms})
        del h
    return rows


def _planted_bt(torch, gen, R, W, dtype):
    """BatchTopK inputs: quarter-integer rows (exact ties at any threshold),
    an all-negative row, -0.0, +inf, NaN of both signs."""
    h = torch.randint(-40, 41, (R, W), generator=gen, device="cuda").float() / 4
    h[1] = -1.0
    h[2, : W // 3] = -0.0
    h[3, 5] = float("inf")
    h[4, 9] = float("nan")
    h = h.to(dtype)
    if dtype == torch.bfloat16:
        h.view(torch.int16)[5, 11] = -64                     # 0xFFC0, a negative NaN
    else:
        h.view(torch.int32)[5, 11] = -4194304                # 0xFFC00000
    return h


def check_batchtopk(torch, tp):
    """K9 select and emit, bitwise against their plain versions on planted
    inputs (ties at the threshold, a budget above the count of positives,
    all-negative rows, -0.0, NaN, bf16 and f32, [4096, 32768] and a width
    that is not a multiple of 4096), then the emit alone through
    ``batchtopk_fixed``; returns the select and emit rows."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    B, H, k = TRAIN["batch_size"], TRAIN["dict_size"], TRAIN["topk_k"]
    cases = [(B, H, k), (B, 2304 + 128, k), (64, 2304 + 128, 2304 + 128)]
    for dtype in (torch.bfloat16, torch.float32):
        for R, W, kk_k in cases:
            h = _planted_bt(torch, gen, R, W, dtype)
            if kk_k == W:
                h = torch.where(h > 2, h, -h.abs() - 1)      # few positives: kk above them
            kk = tp.batchtopk_budget(h, kk_k)
            kth, want = tp.batchtopk_select(h, kk), tp.batchtopk_select_plain(h, kk)
            out = tp.batchtopk(h, kk_k)
            same = int(kth) == int(want) and torch.equal(
                _bits(out, torch), _bits(tp.batchtopk_emit_plain(h, want), torch))
            for thr in (0.5, 3.0, 0.0, -1.0):
                pat = torch.tensor([tp.fixed_threshold_pattern(thr, dtype)], device="cuda")
                same = same and torch.equal(_bits(tp.batchtopk_fixed(h, thr), torch),
                                            _bits(tp.batchtopk_emit_plain(h, pat), torch))
            torch.cuda.synchronize()
            log(f"K9 batchtopk [{R},{W}] {str(dtype)[6:]} kk={kk} (positives "
                f"{int((h > 0).sum())}): threshold pattern {int(kth)}; select, emit and "
                f"fixed emit bitwise {'equal' if same else 'DIFFERENT'}")
            if not same:
                fail(f"K9 not bitwise equal to its plain version at [{R},{W}] {dtype}")
    h = torch.randn((B, H), generator=gen, device="cuda").to(torch.bfloat16)
    kk = tp.batchtopk_budget(h, k)
    kth = tp.batchtopk_select(h, kk)
    if int(kth) != int(tp.batchtopk_select_plain(h, kk)):
        fail("K9 select disagrees with its plain version on random bf16 rows")
    hp = torch.relu(h).reshape(-1)
    ms = time_ms(lambda: tp.batchtopk_select(h, kk), 20)
    q_ms = time_ms(lambda: tp.batchtopk_select(h, kk), 20, queued=True)
    plain_ms = time_ms(lambda: tp.batchtopk_select_plain(h, kk), 2)
    lib_ms = time_ms(lambda: torch.topk(hp, kk), 5)
    n = B * H * 2
    b = bound(n, 0, "bf16")
    log(f"K9 select [{B},{H}] bf16 kk={kk}: {ms:.4f} ms kernel ({q_ms:.4f} ms queued), "
        f"{plain_ms:.4f} ms plain, {lib_ms:.4f} ms topk of the flattened ReLU'd rows, bound "
        f"{b[0]:.4f} ms by {b[1]}")
    row_s = _row("batchtopk_select", "batchtopk.cu", "crosscoder_tpu/ops/topk_pallas.py:857",
                 0.0, ms, plain_ms, b, lib_ms)
    # the emit as one library call: F.threshold keeps x > t, so t is the
    # bf16 just below the kth pattern's value (0: every positive is kept)
    p = int(kth)
    t = 0.0 if p == 0 else float(torch.tensor([p - 1], dtype=torch.int16).view(torch.bfloat16))
    out = tp.batchtopk_emit(h, kth)
    same = torch.equal(_bits(out, torch), _bits(torch.nn.functional.threshold(h, t, 0.0), torch))
    log(f"K9 emit vs F.threshold(h, {t!r}, 0) (kth pattern {p}): bitwise "
        f"{'equal' if same else 'DIFFERENT'}")
    if not same:
        fail("F.threshold does not compute the K9 emit's function")
    ms = time_ms(lambda: tp.batchtopk_emit(h, kth), 20)
    q_ms = time_ms(lambda: tp.batchtopk_emit(h, kth), 20, queued=True)
    plain_ms = time_ms(lambda: tp.batchtopk_emit_plain(h, kth), 3)
    lib_ms = time_ms(lambda: torch.nn.functional.threshold(h, t, 0.0), 20)
    b = bound(2 * n, 0, "bf16")
    log(f"K9 emit [{B},{H}] bf16: {ms:.4f} ms kernel ({q_ms:.4f} ms queued), {plain_ms:.4f} ms "
        f"plain, {lib_ms:.4f} ms F.threshold, bound {b[0]:.4f} ms by {b[1]}")
    row_e = _row("batchtopk_emit", "batchtopk.cu", "crosscoder_tpu/ops/topk_pallas.py:910",
                 0.0, ms, plain_ms, b, lib_ms)
    return row_s, row_e


def _same_quant(torch, a, b):
    """int8 equal, scales bitwise (a NaN scale against a NaN, whatever its
    payload)."""
    (q, s), (pq, ps) = a, b
    return (torch.equal(q, pq) and torch.equal(torch.isnan(s), torch.isnan(ps))
            and torch.equal(s.nan_to_num(0.0).view(torch.int32), ps.nan_to_num(0.0).view(torch.int32)))


def check_quantize(torch, quant):
    """K11 bitwise (int8 and scales) against its plain version: the row
    route on a Gemma-2-2B harvest chunk's rows and the column route on the
    int8 encoder's transposed weight (``W2.t()``, W2 [4608, 32768]), each
    with all-zero blocks, exact half-way quotients and a NaN block, bf16 and
    f32; each timed back to back and queued, the row route's host time to
    issue a call; then the row route on K3's x operand ([4096, 4608], leg
    I), checked and timed; returns their rows."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    R, d, block = 4 * 1023 * 2, 2304, 256
    nd, H = TRAIN["n_models"] * TRAIN["d_in"], TRAIN["dict_size"]

    def planted(shape, dtype):
        x = torch.randn(shape, generator=gen, device="cuda") * 7
        x[0, :block] = 0.0
        x[5, 512:768] = 0.0
        x[1, :block] = torch.arange(block, device="cuda") % 20 - 9.5
        x[1, 0] = 127.0                                      # scale 1: half-way quotients
        x[2, 3 * block + 7] = float("nan")
        return x.to(dtype)

    for dtype in (torch.bfloat16, torch.float32):
        x = planted((R, d), dtype)
        w = planted((H, nd), dtype).t().contiguous()         # W2 [nd, H]; W2.t() holds the plants
        before = dict(quant.quantize_rows.by_route)
        row = quant.quantize_rows(x, block)
        col = quant.quantize_rows(w.t(), block)
        same_row = _same_quant(torch, row, quant.quantize_blocks(x, block))
        same_col = (_same_quant(torch, col, quant.quantize_blocks(w.t(), block))
                    and _same_quant(torch, col, quant.quantize_rows(w.t().contiguous(), block)))
        torch.cuda.synchronize()
        routes = {r: quant.quantize_rows.by_route[r] - before[r] for r in before}
        log(f"K11 quantize_rows {str(dtype)[6:]} block {block}: row route [{R},{d}] "
            f"{'equal' if same_row else 'DIFFERENT'}, column route W2.t() [{H},{nd}] "
            f"{'equal' if same_col else 'DIFFERENT'} (int8 and scales bitwise; launches by "
            f"route {routes})")
        if not (same_row and same_col and routes == {"row": 2, "column": 1}):
            fail(f"K11 not bitwise equal to its plain version, or off its routes ({dtype})")
        del x, w, row, col
    x = (torch.randn((R, d), generator=gen, device="cuda") * 3).to(torch.bfloat16)
    ms = time_ms(lambda: quant.quantize_rows(x, block), 50)
    q_ms = time_ms(lambda: quant.quantize_rows(x, block), 50, queued=True)
    issue_ms = host_ms(lambda: quant.quantize_rows(x, block), 50)
    plain_ms = time_ms(lambda: quant.quantize_blocks(x, block), 10)
    b = bound(R * d * 3 + R * (d // block) * 4, 0, "bf16")
    log(f"K11 row route [{R},{d}] bf16: {ms:.4f} ms kernel ({q_ms:.4f} ms queued; the host "
        f"issues a call in {issue_ms:.4f} ms), {plain_ms:.4f} ms plain, no single library call, "
        f"bound {b[0]:.4f} ms by {b[1]}")
    row = {**_row("quantize_rows", "quantize_rows.cu", "crosscoder_tpu/ops/quant.py:154", 0.0,
                  ms, plain_ms, b, None), "queued_ms": q_ms}
    W2 = (torch.randn((nd, H), generator=gen, device="cuda") * nd ** -0.5).to(torch.bfloat16)
    ms = time_ms(lambda: quant.quantize_rows(W2.t(), block), 20)
    q_ms = time_ms(lambda: quant.quantize_rows(W2.t(), block), 20, queued=True)
    plain_ms = time_ms(lambda: quant.quantize_blocks(W2.t(), block), 3)
    lib_ms = time_ms(lambda: W2.t().contiguous(), 20)
    b = bound(nd * H * 3 + H * (nd // block) * 4, 0, "bf16")
    log(f"K11 column route W2.t() [{H},{nd}] bf16 (K3's weight operand): {ms:.4f} ms kernel "
        f"({q_ms:.4f} ms queued), {plain_ms:.4f} ms plain, {lib_ms:.4f} ms W2.t().contiguous() "
        f"alone (the copy the route removes), bound {b[0]:.4f} ms by {b[1]}")
    col = {**_row("quantize_rows (column route)", "quantize_rows.cu",
                  "crosscoder_tpu/ops/quant.py:154", 0.0, ms, plain_ms, b, lib_ms),
           "queued_ms": q_ms}
    B = TRAIN["batch_size"]
    x = planted((B, nd), torch.bfloat16)
    if not _same_quant(torch, quant.quantize_rows(x, block), quant.quantize_blocks(x, block)):
        fail(f"K11's row route not bitwise equal to its plain version on x [{B}, {nd}]")
    ms = time_ms(lambda: quant.quantize_rows(x, block), 50)
    q_ms = time_ms(lambda: quant.quantize_rows(x, block), 50, queued=True)
    plain_ms = time_ms(lambda: quant.quantize_blocks(x, block), 10)
    b = bound(B * nd * 3 + B * (nd // block) * 4, 0, "bf16")
    log(f"K11 row route x [{B},{nd}] bf16 (K3's x operand): bitwise equal; {ms:.4f} ms kernel "
        f"({q_ms:.4f} ms queued), {plain_ms:.4f} ms plain, no single library call, bound "
        f"{b[0]:.4f} ms by {b[1]}")
    row_x = {**_row(f"quantize_rows (bf16 [{B}, {nd}], leg I's x)", "quantize_rows.cu",
                    "crosscoder_tpu/ops/quant.py:154", 0.0, ms, plain_ms, b, None),
             "queued_ms": q_ms}
    return row, col, row_x


def check_fused_topk_q(torch, fek):
    """K3 bitwise against its plain version on random bf16 and f32 inputs
    (a width that is not a tile multiple, rows that are not a row-block
    multiple, k in {1, 32, 128}, blocks 128 and 256), at the edges of the
    int8 tensor-core tile (B 1, 3 and 130, a width of 2^15 + 8, blocks 32,
    64 and 96 with a partial last stage, an all-zero block, operands at
    +-127, a -0.0 and a NaN bias column), then timed at the training shape
    with the quantization, the product-and-sort pass and the merge apart;
    returns its row."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    nd = TRAIN["n_models"] * TRAIN["d_in"]
    B, width = 520, 4096 + 96
    for dt in (torch.bfloat16, torch.float32):
        x = torch.randn((B, nd), generator=gen, device="cuda").to(dt)
        W = (torch.randn((nd, width), generator=gen, device="cuda") * nd ** -0.5).to(dt)
        b = torch.randn((width,), generator=gen, device="cuda") * 0.01
        for qb in (128, 256):
            for k in (1, 32, 128):
                vk, ik = fek.fused_topk_encode(x, W, b, k, quant_block=qb)
                vp, ip = fek.fused_topk_encode_q_plain(x, W, b, k, qb)
                torch.cuda.synchronize()
                same = torch.equal(_bits(vk, torch), _bits(vp, torch)) and torch.equal(ik, ip)
                log(f"K3 fused_topk_q [{B},{nd}]x[{nd},{width}] {str(dt)[6:]} block {qb} k={k}: "
                    f"bitwise {'equal' if same else 'DIFFERENT'}")
                if not same:
                    bad = (ik != ip).any(dim=1).nonzero().flatten()[:8].tolist()
                    fail(f"K3 not bitwise equal to its plain version (rows {bad})")
    checked = 0
    width = 2 ** 15 + 8
    for dt in (torch.bfloat16, torch.float32):
        for qb, ndq in ((32, 544), (64, 576), (96, 576), (256, nd)):
            for B in (1, 3, 130):
                x = torch.randn((B, ndq), generator=gen, device="cuda")
                W = torch.randn((ndq, width), generator=gen, device="cuda") * 0.05
                b = torch.randn((width,), generator=gen, device="cuda") * 0.01
                sign = torch.where(torch.arange(ndq, device="cuda") % 3 == 0, -1.0, 1.0)
                x[-1] = 3.0 * sign                       # +-127 in every block
                W[:, 7] = 0.25 * sign
                x[0, :qb] = 0.0                          # an all-zero block: scale 0
                W[qb:2 * qb, 5] = 0.0
                b[11] = -0.0
                b[13] = float("nan")
                x, W = x.to(dt), W.to(dt)
                for k in (1, 32, 128):
                    vk, ik = fek.fused_topk_encode(x, W, b, k, quant_block=qb)
                    vp, ip = fek.fused_topk_encode_q_plain(x, W, b, k, qb)
                    torch.cuda.synchronize()
                    checked += 1
                    if not (torch.equal(_bits(vk, torch), _bits(vp, torch))
                            and torch.equal(ik, ip)):
                        fail(f"K3 at the tile's edge ({dt}, B {B}, nd {ndq}, block {qb}, k {k}) "
                             f"not bitwise equal to its plain version")
                del x, W
    log(f"K3 tile edges: {checked} cases bitwise equal to the plain version (B 1, 3, 130; width "
        f"{width}; blocks 32, 64, 96, 256; k 1, 32, 128; bf16 and f32)")
    B, H, k, qb = TRAIN["batch_size"], TRAIN["dict_size"], TRAIN["topk_k"], 256
    x = torch.randn((B, nd), generator=gen, device="cuda").to(torch.bfloat16)
    W = (torch.randn((nd, H), generator=gen, device="cuda") * nd ** -0.5).to(torch.bfloat16)
    b = torch.zeros(H, device="cuda")
    vk, ik = fek.fused_topk_encode(x, W, b, k, quant_block=qb)
    vp, ip = fek.fused_topk_encode_q_plain(x, W, b, k, qb)
    if not (torch.equal(_bits(vk, torch), _bits(vp, torch)) and torch.equal(ik, ip)):
        fail("K3 not bitwise equal to its plain version at the training shape")
    ms = time_ms(lambda: fek.fused_topk_encode(x, W, b, k, quant_block=qb), 5)
    q_ms = time_ms(lambda: fek.fused_topk_encode(x, W, b, k, quant_block=qb), 5, queued=True)
    quant_ms = time_ms(lambda: fek.q_operands(x, W, qb), 5)
    plain_ms = time_ms(lambda: fek.fused_topk_encode_q_plain(x, W, b, k, qb), 2)
    lib_ms = time_ms(lambda: torch.topk(torch.matmul(x, W), k), 10)
    nb = nd // qb
    n_bytes = B * nd + B * nb * 4 + nd * H + nb * H * 4 + H * 4 + B * k * 6
    bnd = bound(n_bytes, 2 * B * nd * H, "int8")
    log(f"K3 training shape [{B},{nd}]x[{nd},{H}] block {qb} k={k}: {ms:.4f} ms kernel "
        f"({q_ms:.4f} ms queued; the operands' quantization {quant_ms:.4f} ms of it; "
        f"CUDA-core design [{CUDA_CORE_MS['K3 train']}]), {plain_ms:.4f} ms plain, {lib_ms:.4f} "
        f"ms bf16 matmul+topk (the exact function K3 approximates), bound {bnd[0]:.4f} ms by "
        f"{bnd[1]}")
    profile_kernels(torch, lambda: fek.fused_topk_encode(x, W, b, k, quant_block=qb),
                    "K3 training shape",
                    {"quantization (K11, both routes)": "quantize_",
                     "product + tile sort (topk_tiles_q_tc)": "topk_tiles_q",
                     "merge (topk_merge_kernel)": "topk_merge"})
    return {**_row("fused_topk_encode_q", "fused_topk_q.cu",
                   "crosscoder_tpu/ops/fused_encoder_topk.py:362", 0.0, ms, plain_ms, bnd,
                   lib_ms), "queued_ms": q_ms}


def _exact_bt(torch, gen, B, nd, width, dtype, bias):
    """Integer-valued K4 operands (every f32 sum exact) with duplicate
    columns, so the threshold value is held by many entries at once."""
    x = torch.randint(-2, 3, (B, nd), generator=gen, device="cuda").float()
    W = torch.randint(-2, 3, (nd, width), generator=gen, device="cuda").float()
    W[:, 500] = W[:, 9]
    W[:, width - 8:] = W[:, 100:108]
    b = (torch.randint(-8, 9, (width,), generator=gen, device="cuda").float() if bias is None
         else torch.full((width,), float(bias), device="cuda"))
    return x.to(dtype), W.to(dtype), b


def check_fused_batchtopk(torch, fek):
    """K4 select and emit bitwise against their plain versions on exact
    inputs, bf16 and f32: ties at the global threshold, a positive bias
    over a row count that is not a tile multiple (padded rows must not
    count), a width that is not a tile multiple and a budget above the
    count of positives; then timed at the training shape. Returns the
    select and emit rows."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    nd = TRAIN["n_models"] * TRAIN["d_in"]
    k = TRAIN["topk_k"]
    width = 4096 + 8
    for dt in (torch.bfloat16, torch.float32):
        for B, bias, kk_k in ((1000, None, k), (1000, 3.0, k), (200, -60.0, width)):
            x, W, b = _exact_bt(torch, gen, B, nd, width, dt, bias)
            kk = fek.batchtopk_budget(B, width, kk_k)
            kth = fek.fused_batchtopk_select(x, W, b, kk)
            want = fek.fused_batchtopk_select_plain(x, W, b, kk)
            out = fek.fused_batchtopk_emit(x, W, b, kth)
            ref = fek.fused_batchtopk_emit_plain(x, W, b, want)
            torch.cuda.synchronize()
            same = int(kth) == int(want) and torch.equal(_bits(out, torch), _bits(ref, torch))
            h = fek._pre_acts_plain(x, W, b).float()
            thr = float(ref.float()[ref > 0].min()) if bool((ref > 0).any()) else 0.0
            ties = int((h == thr).sum()) if thr > 0 else 0
            pos = int((h > 0).sum())
            log(f"K4 fused_batchtopk [{B},{nd}]x[{nd},{width}] {str(dt)[6:]} bias "
                f"{'random' if bias is None else bias} kk={kk} (positives {pos}): threshold "
                f"{thr} held by {ties} entries, kept {int((out > 0).sum())}; select and emit "
                f"bitwise {'equal' if same else 'DIFFERENT'}")
            if not same:
                fail(f"K4 not bitwise equal to its plain version ({dt}, B {B}, bias {bias})")
            if kk <= pos and ties < 2:
                fail("K4 check: no tie at the global threshold was planted")
    # exact inputs at the training and the serve shapes, both dtypes
    for B, H in ((TRAIN["batch_size"], TRAIN["dict_size"]), (8, 2 ** 14)):
        for dt in (torch.bfloat16, torch.float32):
            x, W, b = _exact_bt(torch, gen, B, nd, H, dt, None)
            kk = fek.batchtopk_budget(B, H, k)
            kth = fek.fused_batchtopk_select(x, W, b, kk)
            want = fek.fused_batchtopk_select_plain(x, W, b, kk)
            out = fek.fused_batchtopk_emit(x, W, b, kth)
            ref = fek.fused_batchtopk_emit_plain(x, W, b, want)
            torch.cuda.synchronize()
            same = int(kth) == int(want) and torch.equal(_bits(out, torch), _bits(ref, torch))
            log(f"K4 fused_batchtopk [{B},{nd}]x[{nd},{H}] {str(dt)[6:]} kk={kk} exact: select "
                f"and emit bitwise {'equal' if same else 'DIFFERENT'}")
            if not same:
                fail(f"K4 not bitwise equal to its plain version at [{B}, {nd}] x [{nd}, {H}]")
            del x, W, out, ref
    B, H = TRAIN["batch_size"], TRAIN["dict_size"]
    kk = fek.batchtopk_budget(B, H, k)
    x = torch.randn((B, nd), generator=gen, device="cuda").to(torch.bfloat16)
    W = (torch.randn((nd, H), generator=gen, device="cuda") * nd ** -0.5).to(torch.bfloat16)
    b = torch.zeros(H, device="cuda")
    kth = fek.fused_batchtopk_select(x, W, b, kk)
    out = fek.fused_batchtopk_emit(x, W, b, kth)
    want = fek.fused_batchtopk_select_plain(x, W, b, kk)
    ref = fek.fused_batchtopk_emit_plain(x, W, b, kth)
    torch.cuda.synchronize()
    kept, kept_ref = (out > 0), (ref > 0)
    jac = float((kept & kept_ref).sum()) / max(float((kept | kept_ref).sum()), 1.0)
    log(f"K4 training shape [{B},{nd}]x[{nd},{H}] bf16 kk={kk} random: threshold pattern "
        f"{int(kth)} vs plain {int(want)}; kept {int(kept.sum())} vs {int(kept_ref.sum())}, "
        f"Jaccard {jac:.5f} (the kernel and the plain matmul sum in other orders)")
    if abs(int(kth) - int(want)) > 1 or jac < 0.99:
        fail("K4 disagrees with its plain version beyond rounding at the training shape")

    def lib_select():
        h = torch.matmul(x, W)
        return torch.topk(torch.relu(h).reshape(-1), kk, sorted=False).values.min()

    t_lib = float(lib_select())

    def lib_emit():
        return torch.nn.functional.threshold(torch.matmul(x, W), t_lib, 0.0)

    rows = []
    n_bytes = x.numel() * 2 + W.numel() * 2 + H * 4
    for name, fn, plain, lib, lib_label, out_bytes, line in (
            ("fused_batchtopk select", lambda: fek.fused_batchtopk_select(x, W, b, kk),
             lambda: fek.fused_batchtopk_select_plain(x, W, b, kk), lib_select,
             "matmul + topk of the flattened ReLU'd rows", 4, 533),
            ("fused_batchtopk emit", lambda: fek.fused_batchtopk_emit(x, W, b, kth),
             lambda: fek.fused_batchtopk_emit_plain(x, W, b, kth), lib_emit,
             "matmul + F.threshold", B * H * 2, 586)):
        ms = time_ms(fn, 5)
        q_ms = time_ms(fn, 5, queued=True)
        plain_ms = time_ms(plain, 2)
        lib_ms = time_ms(lib, 5)
        bnd = bound(n_bytes + out_bytes, 2 * B * nd * H, "bf16")
        log(f"K4 {name.split()[1]} training shape: {ms:.4f} ms kernel ({q_ms:.4f} ms queued; "
            f"CUDA-core design [{CUDA_CORE_MS['K4 ' + name.split()[1]]}]), {plain_ms:.4f} ms "
            f"plain, {lib_ms:.4f} ms {lib_label}, bound {bnd[0]:.4f} ms by {bnd[1]}")
        rows.append({**_row(name, "fused_batchtopk.cu",
                            f"crosscoder_tpu/ops/fused_encoder_topk.py:{line}", 0.0, ms,
                            plain_ms, bnd, lib_ms), "queued_ms": q_ms})
    # the count entry (a pass of the threshold over a rank grid), bitwise on
    # the training shape's exact inputs from 0 and from the exact threshold,
    # timed on the random bf16 operands from 0 (its first pass on a grid)
    top = 0x7FFF
    for dt in (torch.bfloat16, torch.float32):
        xe, We, be = _exact_bt(torch, gen, B, nd, H, dt, None)
        kth_e = int(fek.fused_batchtopk_select_plain(xe, We, be, kk))
        hi = top if dt == torch.bfloat16 else 0x7FFFFFFF
        for lo in (0, kth_e):
            got = fek.fused_batchtopk_count(xe, We, be, lo, hi)
            want = fek.fused_batchtopk_count_plain(xe, We, be, lo, hi)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"K4 count not bitwise equal to its plain version ({dt}, lo {lo}): "
                     f"{got.tolist()} vs {want.tolist()}")
        log(f"K4 count [{B},{nd}]x[{nd},{H}] {str(dt)[6:]} exact, from 0 and from the exact "
            f"threshold {kth_e}: bitwise equal")
        del xe, We
    ms = time_ms(lambda: fek.fused_batchtopk_count(x, W, b, 0, top), 5)
    q_ms = time_ms(lambda: fek.fused_batchtopk_count(x, W, b, 0, top), 5, queued=True)
    plain_ms = time_ms(lambda: fek.fused_batchtopk_count_plain(x, W, b, 0, top), 2)
    bnd = bound(n_bytes + 8 * BT_T, 2 * B * nd * H, "bf16")
    log(f"K4 count training shape (T {BT_T} candidates from [0, {top})): {ms:.4f} ms kernel "
        f"({q_ms:.4f} ms queued), {plain_ms:.4f} ms plain, no single library call, bound "
        f"{bnd[0]:.4f} ms by {bnd[1]}")
    rows.append({**_row("fused_batchtopk count", "fused_batchtopk.cu",
                        "crosscoder_tpu/ops/fused_encoder_topk.py:533", 0.0, ms, plain_ms, bnd,
                        None), "queued_ms": q_ms})
    return rows



def check_tile_edges(torch, fek):
    """K2 and K4 bitwise against their plain versions on exact inputs at
    the edges of the bf16 tensor-core tile, bf16 and f32: B in {1, 3, 130}
    (not multiples of 64 or 128), a contraction of 4104 (not a multiple of
    the 64-deep TMA box; f32 K4 takes 4112, since its CUDA-core tile wants
    nd % 16 == 0), a width of 2^15 + 8 (not a multiple of 128), k in {1,
    32, 128}, every column doubled 16388 columns on (ties at every
    threshold, the pair in different tiles), a NaN row (K2) and a NaN
    bias column, -0.0 in x and in the bias, and a positive bias
    everywhere, which the padded rows of the last row block must not see."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    width = 2 ** 15 + 8
    checked = 0
    for dt, nds in ((torch.bfloat16, {4104: "K2 K4"}), (torch.float32, {4104: "K2", 4112: "K4"})):
        for nd, which in nds.items():
            W = torch.randint(-2, 3, (nd, width), generator=gen, device="cuda").float()
            b = torch.randint(-8, 9, (width,), generator=gen, device="cuda").float()
            half = width // 2                         # 16388: pairs in different tiles
            W[:, half:] = W[:, :half]                 # every value twice: ties at every threshold
            b[half:] = b[:half]
            b[200] = -0.0
            b[300] = float("nan")
            W = W.to(dt)
            for B in (1, 3, 130):
                x = torch.randint(-2, 3, (B, nd), generator=gen, device="cuda").float()
                if B >= 3:
                    x[2] = -0.0
                x_nan = x.clone()
                if B >= 3:
                    x_nan[1] = float("nan")           # every slot NaN, nothing emitted
                x, x_nan = x.to(dt), x_nan.to(dt)
                for bias, label in ((b, "random bias"), (torch.full_like(b, 3.0), "bias +3")):
                    if "K2" in which:
                        for k in ((1, 32, 128) if label == "random bias" else (32,)):
                            vk, ik = fek.fused_topk_encode(x_nan, W, bias, k)
                            vp, ip = fek.fused_topk_encode_plain(x_nan, W, bias, k)
                            torch.cuda.synchronize()
                            checked += 1
                            if not (torch.equal(_bits(vk, torch), _bits(vp, torch))
                                    and torch.equal(ik, ip)):
                                fail(f"K2 at the tile's edge ({dt}, B {B}, nd {nd}, width "
                                     f"{width}, k {k}, {label}) not bitwise equal to its plain "
                                     f"version")
                    if "K4" in which:
                        kk = fek.batchtopk_budget(B, width, 32)
                        kth = fek.fused_batchtopk_select(x, W, bias, kk)
                        want = fek.fused_batchtopk_select_plain(x, W, bias, kk)
                        out = fek.fused_batchtopk_emit(x, W, bias, kth)
                        ref = fek.fused_batchtopk_emit_plain(x, W, bias, want)
                        torch.cuda.synchronize()
                        checked += 1
                        h = fek._pre_acts_plain(x, W, bias).float()
                        thr = float(ref.float()[ref > 0].min()) if bool((ref > 0).any()) else 0.0
                        ties = int((h == thr).sum()) if thr > 0 else 0
                        if not (int(kth) == int(want)
                                and torch.equal(_bits(out, torch), _bits(ref, torch))):
                            fail(f"K4 at the tile's edge ({dt}, B {B}, nd {nd}, {label}) not "
                                 f"bitwise equal to its plain version")
                        if thr > 0 and ties < 2:
                            fail("K4 tile edge check: no tie at the global threshold")
                        log(f"K4 edge {str(dt)[6:]} [{B},{nd}]x[{nd},{width}] {label} kk={kk}: "
                            f"threshold {thr} held by {ties} entries; bitwise equal")
            del W
    log(f"K2/K4 tile edges: {checked} exact cases bitwise equal to the plain versions "
        f"(B 1, 3, 130; nd 4104/4112; width {width}; k 1, 32, 128)")


# ---------------------------------------------------------------------------
# phase 6: train


class DeviceBatches:
    """Synthetic batches made ahead onto the card, served in order; the
    position is the state a checkpoint records."""

    def __init__(self, torch, source, n):
        self.batches = [torch.from_numpy(source.next()).cuda() for _ in range(n)]
        self.i = 0

    def next(self):
        b = self.batches[self.i % len(self.batches)]
        self.i += 1
        return b

    def state_dict(self):
        return {"i": self.i}

    def load_state_dict(self, d):
        self.i = int(d["i"])


@contextlib.contextmanager
def plain_versions(tp, sg, fek):
    """Route the model's kernel calls, the optimizer's O1 included, to
    their plain versions."""
    from crosscoder_tpu_torch.ops import adam

    swaps = [(adam, "adam_update", adam.adam_update_plain), (tp, "topk_mask", tp.topk_plain), (tp, "topk_mask_f32", tp.topk_plain),
             (tp, "topk_chunked", tp.topk_chunked_plain), (tp, "sparsify", tp.sparsify_plain),
             (sg, "scatter_add_rows", sg.scatter_add_rows_plain),
             (fek, "fused_topk_encode", fek.fused_topk_encode_plain),
             (tp, "batchtopk_select", tp.batchtopk_select_plain),
             (tp, "batchtopk_emit", tp.batchtopk_emit_plain),
             (fek, "fused_topk_encode_q", fek.fused_topk_encode_q_plain),
             (fek, "fused_batchtopk_select", fek.fused_batchtopk_select_plain),
             (fek, "fused_batchtopk_count", fek.fused_batchtopk_count_plain),
             (fek, "fused_batchtopk_emit", fek.fused_batchtopk_emit_plain)]
    saved = [(m, name, getattr(m, name)) for m, name, _ in swaps]
    for m, name, plain in swaps:
        setattr(m, name, plain)
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def profile_step(torch, trainer, full_metrics, label):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(trainer.step(full_metrics)["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3

    dev_us = _dev_us

    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(dev_us(e) for e in kernels) / 1e3
    if total <= 0:
        log(f"profile {label}: the profiler recorded no device time (not measured)")
        return
    groups = {"K2 fused_topk": 0.0, "K3 fused_topk_q": 0.0, "K2/K3 merge": 0.0,
              "K4 select": 0.0, "K4 emit": 0.0, "K5 topk_mask": 0.0, "K6 topk_mask_f32": 0.0,
              "K7 topk_chunked": 0.0, "K8 sparsify": 0.0, "K9 select": 0.0, "K9 emit": 0.0,
              "K10 scatter_rows": 0.0,
              "K11 quantize_rows": 0.0, "O1 adam_update": 0.0, "matmul": 0.0, "other": 0.0}
    for e in kernels:
        n = e.key.lower()
        g = ("K6 topk_mask_f32" if "topk_mask_f32" in n else
             # topk_slice.cuh: bf16 blocks alone are K5, the rest K7's cluster route
             "K5 topk_mask" if "topk_slice_kernel<true, false>" in n else
             "K7 topk_chunked" if "topk_chunked" in n or "topk_slice_kernel" in n else
             "K5 topk_mask" if "topk_mask" in n else
             "K3 fused_topk_q" if "topk_tiles_q" in n else
             "K2 fused_topk" if "topk_tiles" in n else
             "K2/K3 merge" if "topk_merge" in n else
             "K9 select" if "bt_hist" in n or "bt_bisect" in n else
             "K9 emit" if "batchtopk_emit" in n else
             "K4 select" if "bt_select" in n or "bt_pass<0>" in n or "bt_pass<1>" in n else
             "K4 emit" if "bt_emit" in n or "bt_pass<2>" in n else
             "K11 quantize_rows" if "quantize_rows" in n or "quantize_cols" in n else
             "K8 sparsify" if "sparsify" in n else
             "K10 scatter_rows" if "scatter_rows" in n else
             "O1 adam_update" if "adam_update" in n else
             "matmul" if any(t in n for t in ("gemm", "xmma", "cutlass", "nvjet", "cublas"))
             else "other")
        groups[g] += dev_us(e) / 1e3
    log(f"profile {label}: {wall:.3f} ms wall profiled, {total:.3f} ms device busy "
        f"({100 * total / wall:.1f}%)")
    for g, t in groups.items():
        log(f"profile {label}:   {g}: {t:.3f} ms ({100 * t / total:.1f}%)")
    for e in sorted(kernels, key=dev_us, reverse=True)[:6]:
        log(f"profile {label}:   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:80]}")
    return total


def same_step(torch, a, b):
    """Bitwise equality of two (loss, losses, grads, dead, aux) results."""
    if not torch.equal(_bits(a[0], torch), _bits(b[0], torch)):
        return False, "loss"
    for k in a[2]:
        if not torch.equal(_bits(a[2][k], torch), _bits(b[2][k], torch)):
            return False, f"gradient of {k}"
    return True, ""


@contextlib.contextmanager
def swapped(module, name, fn):
    """``module.name`` is ``fn`` inside the block."""
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


def check_adam(torch, np, state, grads, lr):
    """O1 (the fused clip + Adam + lr update) at leg A's state and
    gradients: bitwise against its plain version on both sides of the clip
    (the gradients scaled to a global norm of 0.5 and of 4), f32 masters
    and once with the state and gradients in bf16; timed back to back and
    queued beside the plain update, one fused Adam call of PyTorch's and
    the bound (each of p, g, m, v read once, p, m, v written once). Returns
    the f32 row of the kernel table."""
    from crosscoder_tpu_torch.ops import adam
    from crosscoder_tpu_torch.train.state import Optimizer

    def bits(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)

    kw = dict(max_norm=1.0, b1=0.9, b2=0.999, eps=1e-8, bc1=float(np.float32(1 - 0.9 ** 13)),
              bc2=float(np.float32(1 - 0.999 ** 13)), step_size=float(-np.float32(lr)))
    n = sum(v.numel() for v in state.params.values())
    row = None
    before = adam.adam_update.launches
    for dt in (torch.float32, torch.bfloat16):
        p, m, v = ({k: t.to(dt) for k, t in d.items()}
                   for d in (state.params, state.opt_state.mu, state.opt_state.nu))
        g0 = {k: t.to(dt) for k, t in grads.items()}
        norm0 = float(Optimizer.global_norm(g0))
        outs = [tuple({k: torch.empty_like(t) for k, t in p.items()} for _ in range(3))
                for _ in range(2)]
        for target in (0.5, 4.0):
            g = {k: (t.float() * (target / norm0)).to(dt) for k, t in g0.items()}
            norm = Optimizer.global_norm(g)
            adam.adam_update(p, g, m, v, norm, out=outs[0], **kw)
            adam.adam_update_plain(p, g, m, v, norm, out=outs[1], **kw)
            torch.cuda.synchronize()
            same = all(torch.equal(bits(a[k]), bits(b[k])) for a, b in zip(*outs) for k in p)
            err = max(float((a[k].float() - b[k].float()).abs().max())
                      for a, b in zip(*outs) for k in p)
            log(f"O1 adam_update {str(dt)[6:]} masters at leg A's state, gradients at a global "
                f"norm of {float(norm):.4f} ({'clipped' if float(norm) >= 1 else 'not clipped'}): "
                f"{'bitwise equal' if same else 'DIFFERENT'} params and moments to the plain "
                f"update (max_abs_err {err:.3e})")
            if not same:
                fail(f"O1 differs from the plain update in {dt} at norm {float(norm)}")
        if dt != torch.float32:
            continue
        ms = time_ms(lambda: adam.adam_update(p, g, m, v, norm, out=outs[0], **kw), 20)
        ms_q = time_ms(lambda: adam.adam_update(p, g, m, v, norm, out=outs[0], **kw), 20,
                       queued=True)
        plain_ms = time_ms(lambda: adam.adam_update_plain(p, g, m, v, norm, out=outs[1], **kw), 3)
        fused_p = {k: t.clone() for k, t in p.items()}
        for k, t in fused_p.items():
            t.grad = g[k]
        lib = torch.optim.Adam(list(fused_p.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                               fused=True)
        library_ms = time_ms(lib.step, 20)
        del fused_p, lib
        b_ms, b_by = bound(7 * 4 * n, 20 * n, "fp32")
        log(f"O1 adam_update f32 over {len(p)} leaves ({n} values): {ms:.4f} ms back to back, "
            f"{ms_q:.4f} ms queued; the plain update {plain_ms:.4f} ms; torch.optim.Adam "
            f"(fused=True, no clip) {library_ms:.4f} ms; bound {b_ms:.4f} ms by {b_by} "
            f"({7 * 4 * n / 1e9:.3f} GB); {7 * 4 * n / ms / 1e6:.0f} GB/s")
        row = {"name": "adam_update", "route": "cuda",
               "source": "crosscoder_tpu_torch/csrc/adam_update.cu",
               "replaces": "crosscoder_tpu/train/state.py:33 (the optax chain XLA fuses in "
                           "crosscoder_tpu/train/trainer.py:351; no Pallas site)",
               "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}
        del outs
    adam.adam_update.launches = before            # the probe's launches are not the path's
    return row


def next_bare(trainer_mod, cfg, tr):
    """Step ``tr`` through aux steps until its next step is a bare one."""
    while trainer_mod.variant_for_step(cfg, tr._host_step)[1]:
        tr.step(full_metrics=False)


def train(torch, np):
    """The train phase; returns the launch counts of its main path, its
    batches on the card and O1's kernel-table row."""
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
    from crosscoder_tpu_torch.ops import fused_encoder_topk as fek
    from crosscoder_tpu_torch.ops import sparse_grad as sg
    from crosscoder_tpu_torch.ops import topk_pallas as tp
    from crosscoder_tpu_torch.train import trainer as trainer_mod
    from crosscoder_tpu_torch.train.state import Optimizer, init_train_state

    cfg_a = CrossCoderConfig(**TRAIN, fused_encoder="off",
                             num_tokens=TRAIN["batch_size"] * LEG_A)
    cfg_b = cfg_a.replace(fused_encoder="on", num_tokens=TRAIN["batch_size"] * LEG_B)
    t0 = time.perf_counter()
    batches = DeviceBatches(torch, SyntheticActivationSource(cfg_a), LEG_A + 1)
    state0 = init_train_state(cfg_a, Optimizer(cfg_a, lambda s: 0.0), device="cuda")
    torch.cuda.synchronize()
    log(f"train: {LEG_A + 1} synthetic batches [{cfg_a.batch_size}, {cfg_a.n_sources}, "
        f"{cfg_a.d_in}] on the card and a {cfg_a.dict_size}-latent state in "
        f"{time.perf_counter() - t0:.1f} s")

    counters = launch_counters()
    reset_counters(counters)
    torch.cuda.reset_peak_memory_stats()
    # leg A: dense encode + K5 + K8, K10 backward
    tr_a = trainer_mod.Trainer(cfg_a, batches, device="cuda", state=state0)
    losses_a, l0s, bare_ms, aux_ms = [], [], [], []
    for i in range(LEG_A):
        variant = trainer_mod.variant_for_step(cfg_a, i)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        m = tr_a.step(full_metrics=True)
        e1.record()
        torch.cuda.synchronize()
        (aux_ms if variant[1] else bare_ms).append(e0.elapsed_time(e1))
        losses_a.append(float(m["loss"]))
        l0s.append(float(m["l0_loss"]))
    after_a = {n: c.launches for n, c in counters.items()}
    # leg B: the fused encoder on bare steps
    batches.i = 0
    tr_b = trainer_mod.Trainer(cfg_b, batches, device="cuda", state=state0)
    losses_b, fused_ms = [], []
    for i in range(LEG_B):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        m = tr_b.step(full_metrics=True)
        e1.record()
        torch.cuda.synchronize()
        if not trainer_mod.variant_for_step(cfg_b, i)[1]:
            fused_ms.append(e0.elapsed_time(e1))
        losses_b.append(float(m["loss"]))
        l0s.append(float(m["l0_loss"]))
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}
    leg_b = {n: launches[n] - after_a[n] for n in launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"train leg A (dense encode, {LEG_A} steps): losses {[round(v, 4) for v in losses_a]}")
    log(f"train leg B (fused encoder, {LEG_B} steps): losses {[round(v, 4) for v in losses_b]}")
    log(f"train: launches leg A {after_a}, leg B {leg_b}; l0 max {max(l0s):.2f} "
        f"(k={cfg_a.topk_k}); peak memory {peak:.2f} GiB")
    bare, aux = np.mean(bare_ms[1:]), np.mean(aux_ms[1:])
    STEP_MS["leg A bare"] = bare
    log(f"train: ms per step (CUDA events, first of each kind excluded): bare {bare:.3f} "
        f"({len(bare_ms) - 1} steps), aux {aux:.3f} ({len(aux_ms) - 1} steps); "
        f"{cfg_a.batch_size / bare * 1e3:.0f} rows/s on bare steps; leg B bare (fused "
        f"encoder) steps {[round(t, 3) for t in fused_ms]} ms (CUDA-core design "
        f"[{CUDA_CORE_MS['leg B bare step']}]) against the dense bare step {bare:.3f} ms over "
        f"the same batches")
    if not all(np.isfinite(losses_a + losses_b)):
        fail("a train loss is not finite")
    if max(l0s) > cfg_a.topk_k:
        fail(f"l0 {max(l0s)} exceeds k={cfg_a.topk_k}")
    if not all(after_a[n] > 0 for n in ("topk_mask", "sparsify", "scatter_add_rows")):
        fail(f"a kernel of leg A never launched: {after_a}")
    if not (leg_b["fused_topk_encode"] > 0 and leg_b["scatter_add_rows"] > 0
            and leg_b["sparsify"] > 0):
        fail(f"K2, K8 or K10 never launched on leg B: {leg_b}")
    check_o1("leg A", after_a, LEG_A)
    check_o1("leg B", leg_b, LEG_B)
    launches["by route"] = routes = read_routes()
    log(f"train: legs A and B by route {routes}")
    check_routes("legs A and B", launches, routes)
    first, last = np.mean(losses_a[:4]), np.mean(losses_a[-4:])
    log(f"train: leg A mean loss of the first 4 steps {first:.5f}, of the last 4 {last:.5f}")
    if not last < first:
        fail("the loss did not fall over leg A")

    # re-run one bare and one aux step from leg A's final state with the
    # plain versions on the card: same bits
    x = batches.next()
    scale = torch.ones(cfg_a.n_sources, device="cuda")
    opt = Optimizer(cfg_a, lambda s: 0.0)
    for variant, label in (((True, False, True), "bare"), ((True, True, True), "aux")):
        fn = trainer_mod.make_step_body(cfg_a, opt, *variant)
        got = fn.loss_and_grads(tr_a.state, x, scale)
        with plain_versions(tp, sg, fek):
            want = fn.loss_and_grads(tr_a.state, x, scale)
        ok, what = same_step(torch, got, want)
        log(f"train: {label} step at step {tr_a.state.step} (aux {got[4]}) with kernels vs "
            f"plain versions: loss {float(got[0]):.6f} vs {float(want[0]):.6f}, "
            f"{'bitwise equal loss and gradients' if ok else 'DIFFERENT ' + what}")
        if not ok:
            fail(f"the {label} step with kernels differs from the plain versions in {what}")
    # the whole step, the update included (O1 against the plain update), at
    # the schedule's learning rate so the update moves the params
    opt_lr = Optimizer(cfg_a, trainer_mod.schedules.lr_schedule(cfg_a))
    fn = trainer_mod.make_step_body(cfg_a, opt_lr, True, False, True)
    got, _ = fn(tr_a.state, x, scale)
    with plain_versions(tp, sg, fek):
        want, _ = fn(tr_a.state, x, scale)
    ok, what = state_bits_equal(torch, got, want)
    grads = fn.loss_and_grads(tr_a.state, x, scale)[2]
    g_norm = float(opt_lr.global_norm(grads))
    log(f"train: a whole bare step (gradient norm {g_norm:.4f}, clip at {cfg_a.grad_clip}) with "
        f"kernels and O1 vs plain versions and the plain update: "
        f"{'bitwise equal params, moments and aux' if ok else 'DIFFERENT ' + what}")
    if not ok:
        fail(f"the whole step with O1 differs from the plain update in {what}")
    del got, want
    row_o1 = check_adam(torch, np, tr_a.state, grads, 1e-3)
    del grads
    # the fused leg's first bare step against leg A's, from the initial state
    bare_a = trainer_mod.make_step_body(cfg_a, opt, True, False, True)
    bare_b = trainer_mod.make_step_body(cfg_b, opt, True, False, True)
    la = float(bare_a.loss_and_grads(state0, batches.batches[0], scale)[0])
    lb = float(bare_b.loss_and_grads(state0, batches.batches[0], scale)[0])
    rel = abs(la - lb) / abs(la)
    log(f"train: first bare step from the initial state, fused {lb:.6f} vs dense encode "
        f"{la:.6f}: relative difference {rel:.2e} (tol 1e-3: bf16 pre-activations summed in "
        f"another order can flip near-tie selections)")
    if not rel <= 1e-3:
        fail("the fused leg's loss disagrees with leg A's beyond the bf16 tolerance")
    profile_step(torch, tr_a, False, "bare step" if tr_a.state.step % 2 else "aux step")
    profile_step(torch, tr_a, False, "bare step" if tr_a.state.step % 2 else "aux step")
    # leg A's bare step on the parent's path (the eager update: the plain
    # version) against O1, in turns, then each profiled
    from crosscoder_tpu_torch.ops import adam

    times = {"O1": [], "plain": []}
    for route in ("O1", "plain", "plain", "O1", "O1", "plain"):
        next_bare(trainer_mod, cfg_a, tr_a)
        with (swapped(adam, "adam_update", adam.adam_update_plain) if route == "plain"
              else contextlib.nullcontext()):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            tr_a.step(full_metrics=False)
            e1.record()
            torch.cuda.synchronize()
        times[route].append(e0.elapsed_time(e1))
    o1, plain = np.median(times["O1"]), np.median(times["plain"])
    log(f"train: leg A bare step (CUDA events, 3 each, in turns) with O1 {[round(t, 3) for t in times['O1']]} "
        f"ms, with the eager update (the parent's path) {[round(t, 3) for t in times['plain']]} ms; "
        f"medians {o1:.3f} vs {plain:.3f}: the update's share of the parent's bare step about "
        f"{100 * (row_o1['plain_ms']) / plain:.1f}% (the plain update alone, "
        f"{row_o1['plain_ms']:.3f} ms), of the new one {100 * row_o1['ms'] / o1:.1f}%")
    for route in ("plain", "O1"):
        next_bare(trainer_mod, cfg_a, tr_a)
        with (swapped(adam, "adam_update", adam.adam_update_plain) if route == "plain"
              else contextlib.nullcontext()):
            profile_step(torch, tr_a, False,
                         "bare step, eager update" if route == "plain" else "bare step, O1")
    return launches, batches, row_o1


# ---------------------------------------------------------------------------
# phase 6b: TopK at f32 (K6) with checkpoint and resume; a wide dictionary (K7)


def state_bits_equal(torch, a, b):
    """Bitwise equality of two TrainStates: params, moments, count, step,
    aux; returns (equal, what differs)."""
    if (a.step, a.opt_state.count) != (b.step, b.opt_state.count):
        return False, f"step/count {a.step, a.opt_state.count} vs {b.step, b.opt_state.count}"
    for what, x, y in (("params", a.params, b.params), ("mu", a.opt_state.mu, b.opt_state.mu),
                       ("nu", a.opt_state.nu, b.opt_state.nu), ("aux", a.aux or {}, b.aux or {})):
        if set(x) != set(y):
            return False, f"{what} keys"
        for k in x:
            if x[k].dtype != y[k].dtype or not torch.equal(x[k].view(torch.uint8),
                                                           y[k].view(torch.uint8)):
                return False, f"{what}[{k}]"
    return True, ""


def ckpt_dir(root):
    import tempfile

    (root / "build").mkdir(exist_ok=True)
    return Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=root / "build"))


class ScatterCalls:
    """Stands in for ``sparse_grad.scatter_add_rows`` (the models call it
    through the module): splits the real wrapper's K10 launches by k, the
    pairs a batch row sends (the wrapper's count read around each call),
    and keeps each call's inputs while ``keep`` is set."""

    def __init__(self, sg):
        self.sg, self.real = sg, sg.scatter_add_rows
        self.by_k, self.kept, self.keep = {}, [], False
        sg.scatter_add_rows = self

    def __call__(self, coeff, idx, rows, n_out):
        if self.keep:
            self.kept.append((coeff, idx, rows, n_out))
        before = self.real.launches
        out = self.real(coeff, idx, rows, n_out)
        k = coeff.shape[1]
        self.by_k[k] = self.by_k.get(k, 0) + self.real.launches - before
        return out

    def close(self):
        self.sg.scatter_add_rows = self.real


def log_aux_scatters(torch, rec, n_dead, label):
    """The destination histogram and the K10 time of each scatter that one
    recorded step made, with ``index_add_``'s time beside the AuxK one's."""
    for coeff, idx, rows, n_out in rec.kept:
        kk = coeff.shape[1]
        ms = time_ms(lambda: rec.real(coeff, idx, rows, n_out), 5)
        extra = ""
        if kk == LEG_F["aux_k"]:
            def index_add():
                upd = coeff.float().reshape(-1, 1) * rows.float().repeat_interleave(kk, dim=0)
                return torch.zeros((n_out, rows.shape[1]), device="cuda").index_add_(
                    0, idx.reshape(-1).long(), upd)
            extra = f", index_add_ {time_ms(index_add, 3):.4f} ms"
        log(f"{label}: {n_dead} dead latents; K10 pairs {coeff.shape[0]}x{kk} rows "
            f"{list(rows.shape)} -> {n_out}: {pair_histogram(torch, idx, n_out)}; "
            f"{ms:.4f} ms kernel{extra}")
    rec.kept.clear()


def train_wide(torch, np, root, train_batches):
    """Legs F, W and V over the train phase's batches (each leg from the
    first); returns the launch counts of each leg."""
    import copy
    import shutil

    from crosscoder_tpu_torch.checkpoint import Checkpointer
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.models import crosscoder as cc
    from crosscoder_tpu_torch.ops import fused_encoder_topk as fek
    from crosscoder_tpu_torch.ops import sparse_grad as sg
    from crosscoder_tpu_torch.ops import topk_pallas as tp
    from crosscoder_tpu_torch.train import trainer as trainer_mod
    from crosscoder_tpu_torch.train.state import Optimizer, init_train_state

    counters = launch_counters()
    legs = {}

    # leg F: 8 steps straight, against 4 + background save + restore + 4
    cfg = CrossCoderConfig(**LEG_F)
    if cfg.aux_k == cfg.topk_k:
        fail("leg F splits K10's launches by k: its aux_k must differ from topk_k")
    if not (cc.use_factored_decode(cfg) and cc.use_sparse_bwd(cfg, cfg.batch_size)
            and tp.topk_route(cfg.dict_size, cfg.topk_k, torch.float32) == "K6"):
        fail("leg F does not take the factored tier, the sparse plane and K6")
    batches = copy.copy(train_batches)
    batches.i = 0
    state0 = init_train_state(cfg, Optimizer(cfg, lambda s: 0.0), device="cuda")
    reset_counters(counters)
    torch.cuda.reset_peak_memory_stats()
    rec = ScatterCalls(sg)
    straight = trainer_mod.Trainer(cfg, batches, device="cuda", state=state0)
    losses_f, step_ms = [], []
    for _ in range(STEPS_F):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        losses_f.append(float(straight.step()["loss"]))
        e1.record()
        torch.cuda.synchronize()
        step_ms.append(e0.elapsed_time(e1))
    batches.i = 0
    tmp = ckpt_dir(root)
    ck = Checkpointer(base_dir=tmp)
    first = trainer_mod.Trainer(cfg, batches, device="cuda", state=state0, checkpointer=ck)
    for _ in range(STEPS_F // 2):
        first.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first.save(background=True)
    fetch_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ck.wait()
    write_ms = (time.perf_counter() - t0) * 1e3
    vdir = Checkpointer.latest_version_dir(tmp)
    n_bytes = sum(f.stat().st_size for f in vdir.iterdir())
    del first
    batches.i = 10 ** 6                                 # the restore must rewind it
    t0 = time.perf_counter()
    resumed = trainer_mod.Trainer(cfg.replace(resume=True, checkpoint_dir=str(tmp)), batches,
                                  device="cuda", checkpointer=Checkpointer(base_dir=tmp))
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    if (resumed.step_counter, batches.i) != (STEPS_F // 2, STEPS_F // 2):
        fail(f"leg F restored step {resumed.step_counter}, batch position {batches.i}")
    losses_r = [float(resumed.step()["loss"]) for _ in range(STEPS_F // 2)]
    torch.cuda.synchronize()
    legs["F"] = {n: c.launches for n, c in counters.items()}
    legs["F"]["scatter_add_rows (AuxK shape)"] = rec.by_k.get(cfg.aux_k, 0)
    legs["F"]["by route"] = read_routes()
    check_routes("leg F", legs["F"], legs["F"]["by route"])
    check_o1("leg F", legs["F"], 2 * STEPS_F)
    peak_f = torch.cuda.max_memory_allocated() / 2 ** 30
    ok, what = state_bits_equal(torch, straight.state, resumed.state)
    log(f"leg F (TopK f32, dict {cfg.dict_size}, AuxK {cfg.aux_k}): losses "
        f"{[round(v, 4) for v in losses_f]}; resumed run's last 4 {[round(v, 4) for v in losses_r]}")
    log(f"leg F: ms per step (CUDA events, aux steps even) {[round(v, 2) for v in step_ms]}; "
        f"bare {np.mean(step_ms[3::2]):.3f}, aux {np.mean(step_ms[2::2]):.3f} (first two excluded)")
    log(f"leg F save at step {STEPS_F // 2}: fetch to host {fetch_ms:.1f} ms, background write "
        f"{write_ms:.1f} ms, {n_bytes / 1e9:.3f} GB in {sorted(f.name for f in vdir.iterdir())}; "
        f"restore (Trainer with resume=True) {restore_ms:.1f} ms; peak memory {peak_f:.2f} GiB")
    log(f"leg F: state after 4 + save + restore + 4 steps vs 8 straight: "
        f"{'bitwise equal (params, moments, count, step, aux)' if ok else 'DIFFERENT ' + what}; "
        f"launches {legs['F']}")
    shutil.rmtree(tmp)
    if not ok:
        fail(f"leg F: the resumed run differs from the straight run in {what}")
    if not all(np.isfinite(losses_f)) or losses_r != losses_f[STEPS_F // 2:]:
        fail("leg F: losses not finite, or the resumed run's losses differ from the straight run's")
    if not all(legs["F"][n] > 0 for n in ("topk_mask_f32", "sparsify", "scatter_add_rows",
                                          "scatter_add_rows (AuxK shape)")):
        fail(f"K6, K8 or K10 never launched on leg F: {legs['F']}")
    # host steps 8 and 9 after the gate: an aux step (8 % aux_every == 0), then a bare one;
    # the aux step's scatters are kept, then their pairs' histograms logged and each timed
    n_dead = int((resumed.state.aux["steps_since_fired"] >= cfg.aux_dead_steps).sum())
    rec.keep = True
    profile_step(torch, resumed, False, "leg F aux step")
    rec.keep = False
    rec.close()
    log_aux_scatters(torch, rec, n_dead, "leg F aux step")
    profile_step(torch, resumed, False, "leg F bare step")
    del straight, resumed, batches, state0

    # leg W: dict 2^17, the factored tier by auto, K7 every step
    cfg = CrossCoderConfig(**LEG_W)
    if not (cc.use_factored_decode(cfg) and cc.use_sparse_bwd(cfg, cfg.batch_size)
            and tp.topk_route(cfg.dict_size, cfg.topk_k, torch.bfloat16) == "K7"):
        fail("leg W does not take the factored tier, the sparse plane and K7")
    t0 = time.perf_counter()
    batches = copy.copy(train_batches)
    batches.i = 0
    tr = trainer_mod.Trainer(cfg, batches, device="cuda")
    torch.cuda.synchronize()
    log(f"leg W: a {cfg.dict_size}-latent state on the card in {time.perf_counter() - t0:.1f} s")
    reset_counters(counters)
    k7_routes = tp.topk_chunked.by_route
    k7_routes.update(dict.fromkeys(k7_routes, 0))
    torch.cuda.reset_peak_memory_stats()
    losses_w, l0s, step_ms = [], [], []
    for _ in range(STEPS_W):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        m = tr.step(full_metrics=True)
        e1.record()
        torch.cuda.synchronize()
        step_ms.append(e0.elapsed_time(e1))
        losses_w.append(float(m["loss"]))
        l0s.append(float(m["l0_loss"]))
    legs["W"] = {n: c.launches for n, c in counters.items()}
    legs["K7 by route"] = {"W": dict(k7_routes)}
    peak_w = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"leg W (TopK bf16, dict {cfg.dict_size}, f32 masters): losses "
        f"{[round(v, 4) for v in losses_w]}; l0 max {max(l0s):.2f}; ms per step (CUDA events) "
        f"{[round(v, 2) for v in step_ms]}, mean after the first {np.mean(step_ms[1:]):.3f}; "
        f"peak memory {peak_w:.2f} GiB; launches {legs['W']}; K7 by route {k7_routes} "
        f"(plan {tp.topk_plan(cfg.dict_size, torch.bfloat16)})")
    if not all(np.isfinite(losses_w)) or max(l0s) > cfg.topk_k:
        fail("leg W: a loss is not finite or l0 exceeds k")
    if not all(legs["W"][n] > 0 for n in ("topk_chunked", "sparsify", "scatter_add_rows")):
        fail(f"K7, K8 or K10 never launched on leg W: {legs['W']}")
    legs["W"]["by route"] = read_routes()
    check_routes("leg W", legs["W"], legs["W"]["by route"])
    check_o1("leg W", legs["W"], STEPS_W)
    if legs["K7 by route"]["W"]["cluster"] != legs["W"]["topk_chunked"]:
        fail(f"leg W: a K7 launch did not take the cluster route: {legs['K7 by route']}")
    x = batches.next()
    scale = torch.ones(cfg.n_sources, device="cuda")
    fn = trainer_mod.make_step_body(cfg, Optimizer(cfg, lambda s: 0.0), True, True, True)
    got = fn.loss_and_grads(tr.state, x, scale)
    with plain_versions(tp, sg, fek):
        want = fn.loss_and_grads(tr.state, x, scale)
    ok, what = same_step(torch, got, want)
    log(f"leg W step at step {tr.state.step} with kernels vs plain versions: loss "
        f"{float(got[0]):.6f} vs {float(want[0]):.6f}, "
        f"{'bitwise equal loss and gradients' if ok else 'DIFFERENT ' + what}")
    if not ok:
        fail(f"the leg W step with kernels differs from the plain versions in {what}")
    del want
    # the opt-in fused encoder at this width, fused_encoder='on': K2 with
    # its two-level merge on a bare step, against the dense encode, both timed
    cfg_on = cfg.replace(fused_encoder="on")
    fused_fn = trainer_mod.make_step_body(cfg_on, Optimizer(cfg_on, lambda s: 0.0),
                                          True, True, True)
    before = fek.fused_topk_encode.launches
    fused = fused_fn.loss_and_grads(tr.state, x, scale)
    torch.cuda.synchronize()
    launched = fek.fused_topk_encode.launches - before
    rel = abs(float(fused[0]) - float(got[0])) / abs(float(got[0]))
    dense_ms = time_ms(lambda: fn.loss_and_grads(tr.state, x, scale), 2)
    fused_ms = time_ms(lambda: fused_fn.loss_and_grads(tr.state, x, scale), 2)
    log(f"leg W step with fused_encoder='on' (K2 launched {launched}x): loss "
        f"{float(fused[0]):.6f} vs dense encode {float(got[0]):.6f}, relative difference "
        f"{rel:.2e} (tol 1e-3); loss and gradients {fused_ms:.3f} ms fused vs {dense_ms:.3f} "
        f"ms dense (CUDA events, mean of 2)")
    if not (cc.use_fused_encoder(cfg_on, cfg.batch_size) and rel <= 1e-3 and launched > 0):
        fail("leg W: the fused encoder at dict 2^17 did not run or disagrees with the dense encode")
    profile_step(torch, tr, True, "leg W step")
    del tr, got, fused, batches

    # leg V: f32 rows too wide for K6's single block go to K7
    cfg = CrossCoderConfig(**LEG_V)
    if not (cc.use_factored_decode(cfg) and cc.use_sparse_bwd(cfg, cfg.batch_size)
            and tp.topk_route(cfg.dict_size, cfg.topk_k, torch.float32) == "K7"):
        fail("leg V does not take the factored tier, the sparse plane and K7")
    batches = copy.copy(train_batches)
    batches.i = 0
    tr = trainer_mod.Trainer(cfg, batches, device="cuda")
    torch.cuda.synchronize()
    reset_counters(counters)
    k7_routes.update(dict.fromkeys(k7_routes, 0))
    losses_v, step_ms = [], []
    for _ in range(STEPS_V):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        losses_v.append(float(tr.step()["loss"]))
        e1.record()
        torch.cuda.synchronize()
        step_ms.append(e0.elapsed_time(e1))
    legs["V"] = {n: c.launches for n, c in counters.items()}
    legs["K7 by route"]["V"] = dict(k7_routes)
    log(f"leg V (TopK f32, dict {cfg.dict_size}): losses {[round(v, 4) for v in losses_v]}; "
        f"ms per step (CUDA events) {[round(v, 2) for v in step_ms]}; launches {legs['V']}; "
        f"K7 by route {k7_routes} (plan {tp.topk_plan(cfg.dict_size, torch.float32)})")
    if not all(np.isfinite(losses_v)):
        fail("leg V: a loss is not finite")
    if not all(legs["V"][n] > 0 for n in ("topk_chunked", "sparsify", "scatter_add_rows")):
        fail(f"K7, K8 or K10 never launched on leg V: {legs['V']}")
    legs["V"]["by route"] = read_routes()
    check_routes("leg V", legs["V"], legs["V"]["by route"])
    check_o1("leg V", legs["V"], STEPS_V)
    if legs["K7 by route"]["V"]["cluster"] != legs["V"]["topk_chunked"]:
        fail(f"leg V: a K7 launch did not take the cluster route: {legs['K7 by route']}")
    del tr, batches
    return legs


# ---------------------------------------------------------------------------
# phase 7: train on harvested activations


class Recorder:
    """Wraps a replay buffer for the Trainer: times every ``next_raw`` (the
    card synced on both sides, so the serve's share of the incremental
    refill is inside it) and keeps the first ``keep`` batches served
    (``keep_all``: every batch, in ``stream``)."""

    def __init__(self, torch, buffer, keep, keep_all=False):
        self.torch, self.buffer, self.keep, self.keep_all = torch, buffer, keep, keep_all
        self.served, self.serve_ms, self.stream = [], [], []

    @property
    def normalisation_factor(self):
        return self.buffer.normalisation_factor

    def state_dict(self):
        return self.buffer.state_dict()

    def next_raw(self):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.buffer.next_raw()
        self.torch.cuda.synchronize()
        self.serve_ms.append((time.perf_counter() - t0) * 1e3)
        if len(self.served) < self.keep:
            self.served.append(out)
        if self.keep_all:
            self.stream.append(out)
        return out


class SpanCounter:
    """A tracer that counts the buffer's spans (``refill``: completed refill
    cycles, the first fill included); the refill dispatcher's thread
    records spans too, so the count takes a lock."""

    def __init__(self):
        import threading

        self.counts = {}
        self._lock = threading.Lock()

    def span(self, name, **args):
        with self._lock:
            self.counts[name] = self.counts.get(name, 0) + 1
        return contextlib.nullcontext()

    def instant(self, name, **args):
        return None


class Replay:
    """Serves recorded raw batches in order, with their buffer's
    normalisation factor: the trainer's view of a harvested stream."""

    def __init__(self, batches, normalisation_factor):
        self.batches, self.normalisation_factor, self.i = batches, normalisation_factor, 0

    def next_raw(self):
        b = self.batches[self.i % len(self.batches)]
        self.i += 1
        return b


def launch_counters():
    """Every training kernel's launch counter, by name."""
    from crosscoder_tpu_torch.ops import adam
    from crosscoder_tpu_torch.ops import fused_encoder_topk as fek
    from crosscoder_tpu_torch.ops import quant
    from crosscoder_tpu_torch.ops import sparse_grad as sg
    from crosscoder_tpu_torch.ops import topk_pallas as tp

    return {"adam_update": adam.adam_update, "topk_mask": tp.topk, "topk_mask_f32": tp.topk_mask_f32,
            "topk_chunked": tp.topk_chunked, "sparsify": tp.sparsify,
            "scatter_add_rows": sg.scatter_add_rows, "batchtopk_select": tp.batchtopk_select,
            "batchtopk_emit": tp.batchtopk_emit, "quantize_rows": quant.quantize_rows,
            "fused_topk_encode": fek.fused_topk_encode,
            "fused_topk_encode_q": fek.fused_topk_encode_q,
            "fused_batchtopk_select": fek.fused_batchtopk_select,
            "fused_batchtopk_count": fek.fused_batchtopk_count,
            "fused_batchtopk_emit": fek.fused_batchtopk_emit}


def reset_counters(counters):
    """Every launch counter, and the by-route counts kept beside some, to 0."""
    for c in counters.values():
        c.launches = 0
        by_route = getattr(c, "by_route", None)
        if by_route is not None:
            by_route.update(dict.fromkeys(by_route, 0))


def read_routes():
    """K8's and K11's launches by route since the counters were reset."""
    from crosscoder_tpu_torch.ops import quant
    from crosscoder_tpu_torch.ops import topk_pallas as tp

    return {"sparsify": dict(tp.sparsify.by_route),
            "quantize_rows": dict(quant.quantize_rows.by_route)}


def check_routes(label, launches, routes):
    """Every K8 launch of a main path takes its split route (k = 32 at the
    main shapes); fails otherwise."""
    if routes["sparsify"]["split"] != launches.get("sparsify", 0):
        fail(f"{label}: a K8 launch did not take the split route: {routes}")


def check_o1(label, launches, steps):
    """Every training step of a leg launches O1 once; fails otherwise."""
    if launches.get("adam_update", 0) != steps:
        fail(f"{label}: O1 launched {launches.get('adam_update', 0)} times in {steps} steps")


def run_leg(torch, cfg, batches, factor, steps):
    """``steps`` Trainer steps over a replay of ``batches``, every launch
    counter set to 0 just before and read just after; per step the loss,
    l0, whether it was an aux step and its time (CUDA events)."""
    from crosscoder_tpu_torch.train import trainer as trainer_mod

    tr = trainer_mod.Trainer(cfg, Replay(batches, factor), device="cuda")
    torch.cuda.synchronize()
    counters = launch_counters()
    reset_counters(counters)
    out = []
    for i in range(steps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        m = tr.step(full_metrics=True)
        e1.record()
        torch.cuda.synchronize()
        out.append(dict(loss=float(m["loss"]), l0=float(m["l0_loss"]), ms=e0.elapsed_time(e1),
                        aux=trainer_mod.variant_for_step(cfg, i)[1] and cfg.aux_k > 0))
    launches = {n: c.launches for n, c in counters.items() if c.launches}
    launches["by route"] = read_routes()
    check_o1(f"a {cfg.activation} leg of {steps} steps", launches, steps)
    return tr, out, launches


def fused_legs(torch, np, leg_h, cfg_h):
    """Leg K (K4): BatchTopK with fused_encoder='on' over leg H's harvested
    batches, beside the dense encode (K9) over the same batches, one fused
    step held against leg H's from its state, and 2 f32 steps; leg I (K3):
    the train cell with quant_encoder over the same batches, and the
    quality gate against the exact fused encoder (K2). Returns each leg's
    launches."""
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.models import crosscoder as cc
    from crosscoder_tpu_torch.ops import fused_encoder_topk as fek
    from crosscoder_tpu_torch.train import trainer as trainer_mod
    from crosscoder_tpu_torch.train.state import Optimizer

    served, factor = leg_h["rec"].served, leg_h["buffer"].normalisation_factor
    steps = len(served)
    scale = leg_h["scale"][0, :, 0]
    cfg_k = cfg_h.replace(fused_encoder="on", num_tokens=cfg_h.batch_size * steps)
    tr, dense, dense_l = run_leg(torch, cfg_h.replace(num_tokens=cfg_k.num_tokens), served,
                                 factor, steps)
    del tr
    tr_k, fused, leg_k = run_leg(torch, cfg_k, served, factor, steps)
    _, f32, leg_k32 = run_leg(torch, cfg_k.replace(enc_dtype="fp32"), served, factor, 2)
    log(f"leg K (BatchTopK, fused encoder K4, {steps} steps over leg H's harvested batches): "
        f"losses {[round(r['loss'], 4) for r in fused]}; l0 {[round(r['l0'], 1) for r in fused]}; "
        f"launches {leg_k}")
    log(f"leg K: ms per step (CUDA events) fused {[round(r['ms'], 3) for r in fused]} vs the "
        f"dense encode (K9) over the same batches {[round(r['ms'], 3) for r in dense]} "
        f"(launches {dense_l}); mean of steps 2-{steps}: fused "
        f"{np.mean([r['ms'] for r in fused[1:]]):.3f} (CUDA-core design "
        f"[{CUDA_CORE_MS['leg K step']}]), dense {np.mean([r['ms'] for r in dense[1:]]):.3f}")
    log(f"leg K f32 (enc_dtype fp32, 2 steps): losses {[round(r['loss'], 4) for r in f32]}; ms "
        f"{[round(r['ms'], 3) for r in f32]}; launches {leg_k32}")
    if not all(math.isfinite(r["loss"]) for r in fused + f32):
        fail("leg K: a loss is not finite")
    for label, leg in (("leg K's dense encode", dense_l), ("leg K", leg_k), ("leg K f32", leg_k32)):
        check_routes(label, leg, leg["by route"])
    if not (leg_k.get("fused_batchtopk_select") == steps and leg_k.get("fused_batchtopk_emit") == steps
            and leg_k32.get("fused_batchtopk_select") == 2 and "batchtopk_select" not in leg_k):
        fail(f"leg K: K4 did not run on every step: {leg_k}, f32 {leg_k32}")
    # one fused step against leg H's dense step from leg H's state, same batch
    opt = Optimizer(cfg_h, lambda s: 0.0)
    state = leg_h["state"]
    lk = float(trainer_mod.make_step_body(cfg_k, opt).loss_and_grads(state, served[0], scale)[0])
    lh = float(trainer_mod.make_step_body(cfg_h, opt).loss_and_grads(state, served[0], scale)[0])
    x = (served[0].float() * scale[None, :, None]).to(torch.bfloat16)
    cp = cc.cast_params(state.params, torch.bfloat16)
    f_dense = cc.encode(cp, x, cfg_h) > 0
    f_fused = fek.fused_batchtopk_encode(x.reshape(x.shape[0], -1),
                                         cp["W_enc"].reshape(-1, cfg_h.dict_size), cp["b_enc"],
                                         cfg_h.topk_k) > 0
    jac = float((f_dense & f_fused).sum()) / max(float((f_dense | f_fused).sum()), 1.0)
    rel = abs(lk - lh) / abs(lh)
    log(f"leg K: a fused step from leg H's state at step {state.step}: loss {lk:.6f} vs the "
        f"dense encode {lh:.6f}, relative {rel:.2e} (tol 1e-3); active sets {int(f_fused.sum())} "
        f"vs {int(f_dense.sum())}, Jaccard {jac:.5f} (tol >= 0.98: the matmuls sum in other "
        f"orders, so bf16 pre-activations round apart now and then)")
    if not (rel <= 1e-3 and jac >= 0.98):
        fail("leg K: the fused BatchTopK step disagrees with the dense encode")
    profile_step(torch, tr_k, True, "leg K step")
    del tr_k, f_dense, f_fused

    # leg I: the train cell with the int8 fused encoder (K3) on bare steps
    cfg_i = CrossCoderConfig(**TRAIN, fused_encoder="on", quant_encoder=True, quant_block=256,
                             num_tokens=TRAIN["batch_size"] * steps)
    tr_i, legi, leg_i = run_leg(torch, cfg_i, served, factor, steps)
    bare = [r["ms"] for r in legi if not r["aux"]]
    aux = [r["ms"] for r in legi if r["aux"]]
    log(f"leg I (TopK, quant_encoder block 256, {steps} steps over leg H's batches): losses "
        f"{[round(r['loss'], 4) for r in legi]}; l0 {[round(r['l0'], 1) for r in legi]}; "
        f"launches {leg_i}; ms per step (CUDA events) bare (K3) {[round(t, 3) for t in bare]} "
        f"(CUDA-core K3 [{CUDA_CORE_MS['leg I bare step']}]), aux (dense encode) "
        f"{[round(t, 3) for t in aux]}")
    if not all(math.isfinite(r["loss"]) and r["l0"] <= cfg_i.topk_k for r in legi):
        fail("leg I: a loss is not finite or l0 exceeds k")
    if not (leg_i.get("fused_topk_encode_q") == len(bare) and "fused_topk_encode" not in leg_i
            and leg_i.get("topk_mask", 0) > 0 and leg_i.get("sparsify", 0) > 0
            and leg_i.get("scatter_add_rows", 0) > 0):
        fail(f"leg I: K3 on bare steps or K5/K8/K10 on aux steps did not run: {leg_i}")
    q_routes = leg_i["by route"]["quantize_rows"]
    check_routes("leg I", leg_i, leg_i["by route"])
    if not (leg_i.get("quantize_rows") == 2 * len(bare)
            and q_routes == {"row": len(bare), "column": len(bare)}):
        fail(f"leg I: K11 did not quantize x (row route) and W (column route) for every K3 "
             f"call: {leg_i}")
    # the quality gate (docs/SCALING.md): K3 against the exact fused K2 on one batch
    state = tr_i.state
    k = cfg_i.topk_k
    cp = cc.cast_params(state.params, torch.bfloat16)
    x2 = x.reshape(x.shape[0], -1)
    W2 = cp["W_enc"].reshape(-1, cfg_i.dict_size)
    ev, ei = fek.fused_topk_encode(x2, W2, cp["b_enc"], k)
    qv, qi = fek.fused_topk_encode(x2, W2, cp["b_enc"], k, quant_block=cfg_i.quant_block)
    ev, qv, ei, qi = (t.float().cpu().numpy() for t in (ev, qv, ei, qi))
    overlap = np.mean([len(set(qi[r][qv[r] > 0]) & set(ei[r][ev[r] > 0]))
                       / max((ev[r] > 0).sum(), 1) for r in range(len(ev))])
    val_err = float(np.mean(np.abs(qv.sum(1) - ev.sum(1)) / np.maximum(ev.sum(1), 1e-6)))
    lq = float(trainer_mod.make_step_body(cfg_i, opt, True, False, True).loss_and_grads(
        state, served[0], scale)[0])
    le = float(trainer_mod.make_step_body(cfg_i.replace(quant_encoder=False), opt, True, False,
                                          True).loss_and_grads(state, served[0], scale)[0])
    loss_rel = abs(lq - le) / abs(le)
    log(f"leg I quality gate at step {state.step} on a harvested batch: selection overlap "
        f"{overlap:.4f} (>= 0.9), mean value error {val_err:.2e} (< 5e-3), bare-step loss "
        f"{lq:.6f} vs the exact fused tier {le:.6f}, relative {loss_rel:.2e} (< 0.05)")
    if not (overlap >= 0.9 and val_err < 5e-3 and loss_rel < 0.05):
        fail("leg I: the int8 fused encoder failed the quality gate")
    tr_i.step()                                       # an aux step, so the next is bare
    profile_step(torch, tr_i, False, "leg I bare step")
    del tr_i
    return {"K dense": dense_l, "K": leg_k, "K32": leg_k32, "I": leg_i}


def harvest_tokens(np, n_seqs, seq_len, vocab, seed):
    """Seeded synthetic token ids: BOS first, some rows ending in PAD runs."""
    rng = np.random.default_rng(seed)
    t = rng.integers(3, vocab, size=(n_seqs, seq_len), dtype=np.int64)
    t[:, 0] = 2
    for i in range(3, n_seqs, 7):
        t[i, int(rng.integers(seq_len // 4, seq_len)):] = 0
    return t


def harvest_train(torch, np, root):
    """The harvest-train phase: two random-init Gemma-2-2B models harvested
    into the replay buffer, a BatchTopK leg over the bf16 card store (K9 in
    every step, the calibrated eval mode through the K9 emit, a save at its
    last step restored into a fresh buffer and Trainer) and a ReLU leg over
    the int8 card store (K11 on every chunk); returns the launch counts of
    that main path."""
    import shutil

    from crosscoder_tpu_torch.checkpoint import Checkpointer
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.data import buffer as bufmod
    from crosscoder_tpu_torch.models import crosscoder as cc
    from crosscoder_tpu_torch.models import lm
    from crosscoder_tpu_torch.obs import trace
    from crosscoder_tpu_torch.ops import fused_encoder_topk as fek
    from crosscoder_tpu_torch.ops import sparse_grad as sg
    from crosscoder_tpu_torch.ops import topk_pallas as tp
    from crosscoder_tpu_torch.train import trainer as trainer_mod
    from crosscoder_tpu_torch.train.state import Optimizer

    lm_cfg = lm.LMConfig.gemma2_2b()
    t0 = time.perf_counter()
    params = [lm.init_params(lm_cfg, seed=s, device="cuda") for s in (1, 2)]
    tokens = harvest_tokens(np, 256, HARVEST["seq_len"], lm_cfg.vocab_size, 6)
    torch.cuda.synchronize()
    log(f"harvest: two random-init Gemma-2-2B (bf16) built in {time.perf_counter() - t0:.1f} s; "
        f"{len(tokens)} token rows of {HARVEST['seq_len']}, "
        f"{int((tokens == 0).sum())} PAD ids in trailing runs")
    cfg_h = CrossCoderConfig(**HARVEST, activation="batchtopk", buffer_device="hbm",
                             num_tokens=HARVEST["batch_size"] * LEG_H)
    cfg_q = CrossCoderConfig(**HARVEST, activation="relu", buffer_device="hbm",
                             quant_buffer=True, num_tokens=HARVEST["batch_size"] * LEG_Q)

    # one chunk's harvest and one serve gather, alone, for the breakdown
    probe = bufmod.make_buffer(cfg_h, lm_cfg, params, tokens, lazy=True, device="cuda")
    padded, _ = probe._pad_chunk(tokens[:HARVEST["model_batch_size"]])
    chunk_ms = time_ms(lambda: probe._harvest_dev(padded), 3)
    idx = np.arange(HARVEST["batch_size"])
    gather_ms = time_ms(lambda: probe._read_rows(idx), 20)
    del probe
    log(f"harvest: one chunk of {HARVEST['model_batch_size']} x {HARVEST['seq_len']} tokens "
        f"through both models' 14 blocks {chunk_ms:.3f} ms; one {HARVEST['batch_size']}-row "
        f"serve gather {gather_ms:.3f} ms (CUDA events)")

    counters = launch_counters()
    reset_counters(counters)
    legs = {}
    for name, cfg, steps in (("H", cfg_h, LEG_H), ("Q", cfg_q, LEG_Q)):
        spans = SpanCounter()
        prev = trace.set_tracer(spans)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        buffer = bufmod.make_buffer(cfg, lm_cfg, params, tokens, device="cuda")
        torch.cuda.synchronize()
        fill_s = time.perf_counter() - t0
        fills = spans.counts.get("refill", 0)
        rec = Recorder(torch, buffer, keep=6, keep_all=name == "H")
        tr = trainer_mod.Trainer(cfg, rec, device="cuda")
        losses, l0s, step_ms = [], [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = tr.step(full_metrics=True)
            losses.append(float(m["loss"]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            l0s.append(float(m["l0_loss"]))
        trace.set_tracer(prev)
        if name == "H":
            # save at the last step: state, buffer position, norm factors
            tmp = ckpt_dir(root)
            tr.checkpointer = Checkpointer(base_dir=tmp)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.save()
            save_ms = (time.perf_counter() - t0) * 1e3
            vdir = Checkpointer.latest_version_dir(tmp)
            meta_h = json.loads((vdir / "0_meta.json").read_text())
            log(f"harvest leg H save at step {meta_h['step']}: {save_ms:.1f} ms, "
                f"{sum(f.stat().st_size for f in vdir.iterdir()) / 1e9:.3f} GB; buffer state "
                f"token_pointer {meta_h['buffer']['token_pointer']}, normalisation factors "
                f"{[round(v, 4) for v in meta_h['buffer']['normalisation_factor']]}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        cycles = spans.counts.get("refill", 0) - fills
        serve = rec.serve_ms
        log(f"harvest leg {name} ({type(buffer).__name__} on {buffer.store_device}, "
            f"{cfg.activation}): fill (norm "
            f"calibration of {cfg.norm_calib_batches * cfg.model_batch_size} seqs + "
            f"{buffer.buffer_batches} seqs, {buffer.buffer_size} rows, store "
            f"{buffer.store_nbytes() / 2 ** 20:.1f} MiB) {fill_s:.2f} s; {cycles} refill "
            f"cycles in {steps} steps; losses {[round(v, 4) for v in losses]}")
        log(f"harvest leg {name}: ms per step incl. serve (host clock, synced) "
            f"{[round(v, 2) for v in step_ms]}; next_raw ms (synced, refill share inside) "
            f"{[round(v, 2) for v in serve]}; mean l0 {np.mean(l0s):.2f}; peak memory "
            f"{peak:.2f} GiB")
        legs[name] = dict(buffer=buffer, trainer=tr, rec=rec, losses=losses, l0s=l0s,
                          cycles=cycles, step_ms=step_ms, cfg=cfg)
        if name == "H":
            # eval mode: threshold calibrated on 2 served batches, one encode
            # through the fixed threshold (the K9 emit alone)
            scale = tr._device_scale()[None, :, None]
            batches = [buffer.next_raw().float() * scale for _ in range(2)]
            thr = cc.calibrate_batchtopk_threshold(tr.state.params, cfg, batches)
            cp = cc.cast_params(tr.state.params, torch.bfloat16)
            f = cc.encode(cp, batches[0].to(torch.bfloat16), cfg.replace(batchtopk_threshold=thr))
            torch.cuda.synchronize()
            eval_l0 = float((f > 0).float().sum(-1).mean())
            log(f"harvest leg H eval: calibrated threshold {thr:.6f} over 2 served batches; "
                f"fixed-threshold encode l0 {eval_l0:.2f} (k={cfg.topk_k})")
            if not (thr > 0 and math.isfinite(eval_l0) and eval_l0 > 0):
                fail("BatchTopK eval encode produced no activations")
            legs[name].update(trainer=None, state=tr.state, scale=scale)
            del tr, f, batches
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}
    launches["by route"] = routes = read_routes()
    log(f"harvest: main-path kernel launches {launches}; K11 by route {routes['quantize_rows']}")
    check_routes("harvest legs H and Q", launches, routes)
    check_o1("harvest legs H and Q", launches, LEG_H + LEG_Q)

    for name, leg in legs.items():
        if not all(math.isfinite(v) for v in leg["losses"]):
            fail(f"harvest leg {name}: a loss is not finite")
        if leg["cycles"] < 2:
            fail(f"harvest leg {name}: {leg['cycles']} refill cycles, want >= 2")
    if np.mean(legs["H"]["l0s"]) < cfg_h.topk_k:
        fail(f"leg H mean l0 {np.mean(legs['H']['l0s'])} below k={cfg_h.topk_k}")
    if not (launches["batchtopk_select"] >= LEG_H and launches["batchtopk_emit"] > LEG_H
            and launches["quantize_rows"] > 0
            and routes["quantize_rows"]["row"] == launches["quantize_rows"]):
        fail(f"K9 or K11 (row route) never launched on the harvest-train path: {launches}, "
             f"{routes}")

    # the card stores' raw streams against host stores built from the same
    # params and tokens: byte for byte across a refill
    for name, host_cls in (("H", bufmod.PairedActivationBuffer),
                           ("Q", bufmod.QuantPairedActivationBuffer)):
        leg = legs[name]
        host = bufmod.make_buffer(leg["cfg"].replace(buffer_device="host"), lm_cfg, params,
                                  tokens, device="cuda")
        if leg["buffer"].store_device.type != "cuda":
            fail(f"harvest leg {name}: the store is on {leg['buffer'].store_device}, not the card")
        if type(host) is not host_cls or host.store_device.type != "cpu":
            fail(f"make_buffer gave {type(host).__name__} on {host.store_device} for the host "
                 f"store of leg {name}")
        same = all(torch.equal(a.view(torch.int16).cpu(), host.next_raw().view(torch.int16))
                   for a in leg["rec"].served)
        log(f"harvest leg {name}: {type(leg['buffer']).__name__} on the card vs in host RAM, "
            f"{len(leg['rec'].served)} raw serves across a refill: byte-identical "
            f"{'yes' if same else 'NO'}")
        if not same:
            fail(f"harvest leg {name}: the card store's stream differs from the host store's")
        del host

    # leg H's last state re-run with every plain version: same bits
    leg = legs["H"]
    state_h = leg["state"]
    fn = trainer_mod.make_step_body(cfg_h, Optimizer(cfg_h, lambda s: 0.0), True, True, True)
    x = leg["rec"].served[0]
    got = fn.loss_and_grads(leg["state"], x, leg["scale"][0, :, 0])
    with plain_versions(tp, sg, fek):
        want = fn.loss_and_grads(leg["state"], x, leg["scale"][0, :, 0])
    ok, what = same_step(torch, got, want)
    log(f"harvest leg H step at step {leg['state'].step} with kernels vs plain versions: loss "
        f"{float(got[0]):.6f} vs {float(want[0]):.6f}, "
        f"{'bitwise equal loss and gradients' if ok else 'DIFFERENT ' + what}")
    if not ok:
        fail(f"the harvested BatchTopK step with kernels differs from the plain versions in {what}")
    for name, leg in legs.items():
        b = leg["cfg"].batch_size
        per = (leg["buffer"].buffer_size // 2 - b) // b + 1       # serves a refill cycle
        sv = leg["rec"].serve_ms
        cyc = [sum(sv[i:i + per]) for i in range(0, len(sv) - per + 1, per)]
        steady = [a - b for a, b in zip(leg["step_ms"][1:], sv[1:])]
        log(f"harvest leg {name} breakdown: serve+refill per {per}-serve cycle {[round(c, 2) for c in cyc]} "
            f"ms; step without the serve (host clock) mean {np.mean(steady):.3f} ms over "
            f"{len(steady)} steps; {b / np.mean(leg['step_ms'][1:]) * 1e3:.0f} "
            f"rows/s end to end")
    launches["fused legs"] = fused_legs(torch, np, legs["H"], cfg_h)
    leg_h_run = dict(stream=legs["H"]["rec"].stream, step_ms=legs["H"]["step_ms"],
                     serve_ms=legs["H"]["rec"].serve_ms, params=params, tokens=tokens,
                     cfg=cfg_h, lm_cfg=lm_cfg, chunk_ms=chunk_ms)
    # leg H's save restored into a fresh buffer (lazy, filled by the
    # restore from the saved position) and a fresh Trainer with resume
    del legs
    cfg_r = cfg_h.replace(resume=True, checkpoint_dir=str(tmp))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh = bufmod.make_buffer(cfg_r, lm_cfg, params, tokens, device="cuda", lazy=True)
    tr = trainer_mod.Trainer(cfg_r, fresh, device="cuda", checkpointer=Checkpointer(base_dir=tmp))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    st = fresh.state_dict()
    ok, what = state_bits_equal(torch, state_h, tr.state)
    same_buf = (st["token_pointer"] == meta_h["buffer"]["token_pointer"]
                and st["normalisation_factor"] == meta_h["buffer"]["normalisation_factor"])
    losses = [float(tr.step()["loss"]) for _ in range(2)]
    log(f"harvest leg H restore (fresh buffer refilled from token {st['token_pointer']}, fresh "
        f"Trainer) {restore_s:.2f} s: state {'bitwise equal' if ok else 'DIFFERENT ' + what}; "
        f"token_pointer and normalisation factors {'equal' if same_buf else 'DIFFERENT'} to the "
        f"meta; 2 more steps, losses {[round(v, 4) for v in losses]}")
    shutil.rmtree(tmp)
    if not (ok and same_buf and tr.step_counter == LEG_H + 2 and all(map(math.isfinite, losses))):
        fail("harvest leg H: the resume over the harvested buffer failed its gate")
    del tr, fresh
    return launches, leg_h_run


# ---------------------------------------------------------------------------
# phase 8: the analysis path


# the CE eval's crosscoder: TopK k=32 at f32 over 2^14 latents, so its f32
# rows take K6; folded with two seeded factors
ANALYSIS = dict(d_in=2304, n_models=2, hook_point="blocks.14.hook_resid_pre", dict_size=2 ** 14,
                topk_k=32, activation="topk", enc_dtype="fp32", log_backend="null")
ANALYSIS_SEQS, ANALYSIS_CHUNK = 8, 4
_HF_NAMES = {"attn_norm": "input_layernorm", "post_attn_norm": "post_attention_layernorm",
             "pre_ffw_norm": "pre_feedforward_layernorm",
             "post_ffw_norm": "post_feedforward_layernorm", "wq": "self_attn.q_proj",
             "wk": "self_attn.k_proj", "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
             "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj", "w_down": "mlp.down_proj"}


def hf_state_dict(params, n_layers):
    """The inverse of ``lm.from_torch_state_dict``: an HF Gemma2 state dict
    (``[out, in]`` projections, one contiguous tensor each) on the card."""
    sd = {"model.embed_tokens.weight": params["embed"], "model.norm.weight": params["final_norm"]}
    for key, leaf in params["layers"].items():
        for i in range(n_layers):
            t = leaf[i]
            sd[f"model.layers.{i}.{_HF_NAMES[key]}.weight"] = (t.t() if t.dim() == 2
                                                                else t).contiguous()
    return sd


def same_params(torch, a, b):
    """Bitwise equality of two LM param dicts."""
    flat = [(a["embed"], b["embed"]), (a["final_norm"], b["final_norm"])]
    flat += [(a["layers"][k], b["layers"][k]) for k in a["layers"]]
    return all(x.dtype == y.dtype and torch.equal(_bits(x, torch), _bits(y, torch))
               for x, y in flat)


def same_dashboards(np, a, b):
    """Feature activations, top sequences, interval groups and logit-lens
    tables of two ``FeatureVisData``, exactly."""
    return all(fa.feature == fb.feature and np.array_equal(fa.acts_sample, fb.acts_sample)
               and fa.max_act == fb.max_act and fa.top_seqs == fb.top_seqs
               and fa.interval_groups == fb.interval_groups and fa.logit_lens == fb.logit_lens
               for fa, fb in zip(a.features, b.features)) and len(a.features) == len(b.features)


def analysis(torch, np, root):
    """The analysis phase: two random-init Gemma-2-2B models (all 26
    blocks) loaded from HF-layout state dicts (one through a file on disk,
    one in memory) bitwise to their params; one forward with logits timed;
    the CE-recovered eval with the identity, zero and crosscoder
    reconstructors (K6 on every chunk), firing rates and the dashboards,
    each against its re-run with the plain versions. Returns the launch
    counts of its main path (the crosscoder CE eval, firing rates,
    dashboards)."""
    import os
    import shutil

    from crosscoder_tpu_torch import replicate
    from crosscoder_tpu_torch.analysis import ce_eval
    from crosscoder_tpu_torch.analysis.dashboards import FeatureVisConfig, FeatureVisData
    from crosscoder_tpu_torch.analysis.decoder import dead_latent_fraction, firing_rates
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.models import crosscoder as cc
    from crosscoder_tpu_torch.models import lm
    from crosscoder_tpu_torch.ops import fused_encoder_topk as fek
    from crosscoder_tpu_torch.ops import sparse_grad as sg
    from crosscoder_tpu_torch.ops import topk_pallas as tp

    t_phase = time.perf_counter()
    lm_cfg = lm.LMConfig.gemma2_2b()
    hook = ANALYSIS["hook_point"]
    orig = [lm.init_params(lm_cfg, seed=s, device="cuda") for s in (1, 2)]
    tmp = ckpt_dir(root)
    try:
        # model A through a file: torch.save, fsync, the file's pages
        # dropped from the page cache, then a mapped load onto the card
        sd = hf_state_dict(orig[0], lm_cfg.n_layers)
        path = tmp / "model_a.pt"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.save(sd, path)
        fd = os.open(path, os.O_RDONLY)
        os.fsync(fd)
        save_s = time.perf_counter() - t0
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        os.close(fd)
        del sd
        size = path.stat().st_size
        t0 = time.perf_counter()
        sd = torch.load(path, map_location="cpu", mmap=True)
        params_a = lm.from_torch_state_dict(sd, lm_cfg, device="cuda")
        torch.cuda.synchronize()
        disk_s = time.perf_counter() - t0
        del sd
        path.unlink()
        # model B in memory: its state dict on the card
        sd = hf_state_dict(orig[1], lm_cfg.n_layers)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params_b = lm.from_torch_state_dict(sd, lm_cfg, device="cuda")
        torch.cuda.synchronize()
        mem_s = time.perf_counter() - t0
        del sd
        same = [same_params(torch, params_a, orig[0]), same_params(torch, params_b, orig[1])]
        log(f"analysis: two random-init Gemma-2-2B (bf16, {lm_cfg.n_layers} blocks) as HF-layout "
            f"state dicts; "
            f"model A torch.save + fsync {save_s:.2f} s ({size / 1e9:.3f} GB), load from the "
            f"file (page cache dropped, mapped) through from_torch_state_dict {disk_s:.2f} s; "
            f"model B from the state dict in card memory {mem_s:.2f} s; bitwise equal to the "
            f"params {same}")
        if not all(same):
            fail("a model loaded through from_torch_state_dict differs from its params")
        del orig
        params = [params_a, params_b]

        rng = np.random.default_rng(8)
        tokens = rng.integers(3, lm_cfg.vocab_size, size=(ANALYSIS_SEQS, 1024))
        tokens[:, 0] = 2                                         # BOS
        tok = torch.as_tensor(tokens[:ANALYSIS_CHUNK], device="cuda")
        with torch.no_grad():
            lm.forward(params_a, tok, lm_cfg)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            logits, _ = lm.forward(params_a, tok, lm_cfg)
            e1.record()
            torch.cuda.synchronize()
            fwd_ms = e0.elapsed_time(e1)
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            ce = float(lm.loss_fn(logits, tok))
        shape = tuple(logits.shape)
        log(f"analysis: one forward with logits, [{ANALYSIS_CHUNK}, 1024] tokens through "
            f"{lm_cfg.n_layers} blocks and the unembedding, {fwd_ms:.3f} ms (CUDA events); logits {shape} "
            f"{logits.dtype}; peak memory above the weights {peak:.2f} GiB; CE {ce:.4f}")
        if not (shape == (ANALYSIS_CHUNK, 1024, lm_cfg.vocab_size)
                and logits.dtype == torch.float32 and math.isfinite(ce)):
            fail("the forward with logits gave the wrong shape, dtype or a non-finite CE")
        del logits
        profile_kernels(torch, lambda: lm.forward(params_a, tok, lm_cfg), "forward with logits",
                        {"nvjet matmuls": "nvjet", "gemm matmuls": "gemm", "softmax": "softmax",
                         "tanh (softcaps, GELU)": "tanh"})

        # the oracles: identity splices back the clean rows, zero the zeros
        t0 = time.perf_counter()
        m_id = ce_eval.get_ce_recovered_metrics(tokens, lm_cfg, params, hook, lambda r: r,
                                                chunk=ANALYSIS_CHUNK)
        id_s = time.perf_counter() - t0
        m_z = ce_eval.get_ce_recovered_metrics(tokens, lm_cfg, params, hook, torch.zeros_like,
                                               chunk=ANALYSIS_CHUNK)
        ok_id = all(m_id[f"ce_spliced_{t}"] == m_id[f"ce_clean_{t}"]
                    and m_id[f"ce_recovered_{t}"] == 1.0 for t in "AB")
        ok_z = all(m_z[f"ce_recovered_{t}"] == 1.0 - (m_z[f"ce_spliced_{t}"] - m_z[f"ce_clean_{t}"])
                   / (m_z[f"ce_zero_abl_{t}"] - m_z[f"ce_clean_{t}"]) for t in "AB")
        log(f"analysis: CE oracles over {ANALYSIS_SEQS} x 1024 tokens in chunks of "
            f"{ANALYSIS_CHUNK} at {hook}: identity {m_id} ({id_s:.2f} s), spliced == clean "
            f"bitwise and recovered 1.0: {ok_id}; zero {m_z}, recovered by its formula: {ok_z}")
        if not (ok_id and ok_z):
            fail("the CE eval's identity or zero oracle failed")

        cfg = CrossCoderConfig(**ANALYSIS)
        ccp = cc.init_params(cfg, seed=4, device="cuda")
        # per-latent decoder scales a source: the three relative-norm
        # clusters a trained crosscoder shows, so pick_features takes each
        gen = torch.Generator(device="cuda").manual_seed(5)
        scale = 0.05 + 0.95 * torch.rand((cfg.dict_size, cfg.n_sources), generator=gen,
                                         device="cuda")
        ccp["W_dec"] = ccp["W_dec"] * scale[:, :, None]
        factors = rng.uniform(0.2, 0.3, size=2)
        folded = cc.fold_scaling_factors(ccp, factors)
        rec = ce_eval.crosscoder_reconstruct_fn(folded, cfg)
        feats = replicate.pick_features(ccp, k=8)
        vis_cfg = FeatureVisConfig(hook_point=hook, features=feats)

        def row_batches():
            for s in range(0, ANALYSIS_SEQS, ANALYSIS_CHUNK):
                acts = lm.run_with_cache_multi(params, tokens[s:s + ANALYSIS_CHUNK], lm_cfg,
                                               (hook,))
                yield acts[:, 1:].reshape(-1, cfg.n_sources, cfg.d_in).float()

        rows = list(row_batches())
        counters = launch_counters()
        reset_counters(counters)
        k6 = counters["topk_mask_f32"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m_cc = ce_eval.get_ce_recovered_metrics(tokens, lm_cfg, params, hook, rec,
                                                chunk=ANALYSIS_CHUNK)
        cc_s = time.perf_counter() - t0
        ce_launches = k6.launches
        rates = firing_rates(folded, cfg, rows)
        torch.cuda.synchronize()
        fire_launches = k6.launches - ce_launches
        t0 = time.perf_counter()
        dash = FeatureVisData.create(folded, cfg, lm_cfg, params, tokens, vis_cfg)
        dash_s = time.perf_counter() - t0
        launches = {n: c.launches for n, c in counters.items()}
        dash_launches = launches["topk_mask_f32"] - ce_launches - fire_launches
        n_chunks = -(-ANALYSIS_SEQS // ANALYSIS_CHUNK)
        log(f"analysis: crosscoder {cfg.dict_size}x{cfg.topk_k} (f32, folded with factors "
            f"{[round(float(f), 4) for f in factors]}): CE {m_cc} in {cc_s:.2f} s, "
            f"{cc_s / n_chunks * 1e3:.1f} ms a chunk (host clock, 6 forwards with logits and "
            f"one reconstruction a chunk); firing rates over {sum(len(r) for r in rows)} rows: "
            f"dead fraction {dead_latent_fraction(rates):.4f}, median {np.median(rates):.6f}; "
            f"dashboards of features {feats} in {dash_s:.2f} s; K6 launches: CE "
            f"{ce_launches}, firing {fire_launches}, dashboards {dash_launches}; every "
            f"counter {launches}")
        if not all(math.isfinite(v) for v in m_cc.values()):
            fail(f"a crosscoder CE metric is not finite: {m_cc}")
        if (ce_launches, fire_launches, dash_launches) != (n_chunks, len(rows), n_chunks):
            fail(f"K6 launches on the analysis path: CE {ce_launches} (want one a chunk, "
                 f"{n_chunks}), firing {fire_launches} (want {len(rows)}), dashboards "
                 f"{dash_launches} (want {n_chunks})")
        if sum(launches.values()) != launches["topk_mask_f32"]:
            fail(f"a kernel other than K6 launched on the analysis path: {launches}")

        # each against its re-run with the plain versions
        tok = torch.as_tensor(tokens[:ANALYSIS_CHUNK], device="cuda")
        got = ce_eval.chunk_ces(params, rec, tok, lm_cfg, hook)
        with plain_versions(tp, sg, fek):
            want = ce_eval.chunk_ces(params, rec, tok, lm_cfg, hook)
            rates_plain = firing_rates(folded, cfg, rows)
            dash_plain = FeatureVisData.create(folded, cfg, lm_cfg, params, tokens, vis_cfg)
        same_ce = torch.equal(got.view(torch.int32), want.view(torch.int32))
        same_rates = np.array_equal(rates, rates_plain)
        same_dash = same_dashboards(np, dash, dash_plain)
        log(f"analysis: with K6 vs the plain versions: one chunk's [n_models, 3] CEs "
            f"{got.tolist()} {'bitwise equal' if same_ce else 'DIFFERENT'}; firing rates "
            f"{'equal' if same_rates else 'DIFFERENT'}; dashboards (activations, top sequences, "
            f"logit-lens tables) {'equal' if same_dash else 'DIFFERENT'}")
        if not (same_ce and same_rates and same_dash):
            fail("the analysis path with K6 differs from its plain re-run")
        html = dash.save_feature_centric_vis(tmp / "dashboards.html")
        n_bytes = html.stat().st_size
        cards = html.read_text().count('class="card"')
        log(f"analysis: dashboards.html {n_bytes} bytes, {cards} cards; phase wall "
            f"{time.perf_counter() - t_phase:.1f} s")
        if not (n_bytes > 0 and cards == len(feats)):
            fail("dashboards.html is empty or lacks a feature's card")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# phase 9: the compiled data plane


def _k1_err(a, b, lengths, H):
    """max |a - b| on valid rows, and its largest ratio, row by row (a
    query position and head), to max |b| of the row."""
    worst = rel = 0.0
    for d, ln in enumerate(lengths):
        x, y = (t[d, :int(ln)].float().reshape(int(ln), H, -1) for t in (a, b))
        e = (x - y).abs()
        worst = max(worst, float(e.max()))
        rel = max(rel, float((e.amax(-1) / y.abs().amax(-1).clamp_min(1e-30)).max()))
    return worst, rel


def timed_steps(torch, tr, steps):
    """``steps`` Trainer steps: per step the loss, l0 and host-clock ms
    from the previous step's loss read back to this one's, so that the
    harvest a dispatcher thread queues between two steps is counted."""
    losses, l0s, step_ms = [], [], []
    torch.cuda.synchronize()
    t_prev = time.perf_counter()
    for _ in range(steps):
        m = tr.step(full_metrics=True)
        losses.append(float(m["loss"]))
        now = time.perf_counter()
        step_ms.append((now - t_prev) * 1e3)
        t_prev = now
        l0s.append(float(m["l0_loss"]))
    return losses, l0s, step_ms


def _ms_line(np, ms):
    return (f"{[round(t, 2) for t in ms]} ms; steps 2-{len(ms)}: median "
            f"{np.median(ms[1:]):.2f}, max {max(ms[1:]):.2f}")


def data_plane(torch, np, root, leg_h):
    """The compiled data plane over leg H's models, corpus and config: K1
    at the harvest shape (one chunk of the corpus through the paged
    harvest, every launch held against the plain attention, the capture
    against its plain-attention re-run; chunk times paged against padded
    on this corpus and on an all-full-length one); leg S (refill overlap:
    the padded harvest in SegmentedHarvest quanta from the dispatcher
    thread), its served stream bitwise leg H's; leg P (the paged harvest
    through K1 with refill overlap, BatchTopK over the bf16 card store),
    12 steps, a save and a restore through the dispatcher. Returns K1's
    harvest row and the launches of legs S and P."""
    import shutil

    from crosscoder_tpu_torch.checkpoint import Checkpointer
    from crosscoder_tpu_torch.data import buffer as bufmod
    from crosscoder_tpu_torch.data.tokens import valid_lengths
    from crosscoder_tpu_torch.models import lm
    from crosscoder_tpu_torch.obs import trace
    from crosscoder_tpu_torch.ops import paged_attention as pa
    from crosscoder_tpu_torch.train import trainer as trainer_mod

    params, tokens, cfg_h, lm_cfg = leg_h["params"], leg_h["tokens"], leg_h["cfg"], leg_h["lm_cfg"]
    hooks = cfg_h.resolved_hook_points()
    C, S, page = cfg_h.model_batch_size, cfg_h.seq_len, cfg_h.page_size
    H, KV, hd = lm_cfg.n_heads, lm_cfg.n_kv_heads, lm_cfg.head_dim
    n_src = cfg_h.n_sources
    t_phase = time.perf_counter()

    # K1 at the harvest shape: the corpus's first chunk through the paged
    # harvest, each launch against the plain attention on its inputs
    chunk = tokens[:C]
    lengths = valid_lengths(chunk)
    errs = []

    def checked(q, k, v, lens, **kw):
        out = pa.paged_attention(q, k, v, lens, **kw)
        errs.append(_k1_err(out, pa.paged_attention_plain(q, k, v, lens, **kw), lengths, H))
        return out

    pa.paged_attention.launches = 0
    got = lm.run_with_cache_multi_paged(params, chunk, lengths, lm_cfg, hooks, page_size=page,
                                        pad_mode="wrap", out_dtype=torch.bfloat16,
                                        attention=checked)
    n_k1 = pa.paged_attention.launches
    want = lm.run_with_cache_multi_paged(params, chunk, lengths, lm_cfg, hooks, page_size=page,
                                         pad_mode="wrap", out_dtype=torch.bfloat16,
                                         attention=pa.paged_attention_plain)
    rel = [float((got[:, :, i].float() - want[:, :, i].float()).norm()
                 / want[:, :, i].float().norm()) for i in range(n_src)]
    worst = max(e[0] for e in errs), max(e[1] for e in errs)
    log(f"K1 in the paged harvest: one chunk {C}x{S} (lengths {lengths.tolist()}), "
        f"{n_k1} K1 launches ({len(errs)} held against the plain attention: max_abs_err "
        f"{worst[0]:.3e}, row-relative {worst[1]:.3e}, tol 2e-2 both); the capture against "
        f"its plain-attention re-run, relative error per source {[f'{r:.3e}' for r in rel]} "
        f"(tol {HARVEST_REL_TOL})")
    if n_k1 != K1_PER_CHUNK:
        fail(f"the paged harvest of one chunk launched K1 {n_k1} times, want {K1_PER_CHUNK}")
    if not (worst[0] <= 2e-2 and worst[1] <= 2e-2 and max(rel) <= HARVEST_REL_TOL):
        fail("K1 in the paged harvest disagrees with the plain attention")
    del got, want

    # chunk times, padded against paged, on this corpus and an all-full-length one
    full = np.random.default_rng(16).integers(3, lm_cfg.vocab_size, size=(C, S))
    full[:, 0] = 2                                  # BOS, then no PAD
    pad_b = bufmod.make_buffer(cfg_h, lm_cfg, params, tokens, lazy=True, device="cuda")
    pag_b = bufmod.make_buffer(cfg_h.replace(harvest_runtime="paged"), lm_cfg, params, tokens,
                               lazy=True, device="cuda")
    chunk_ms = {}
    for name, toks in (("corpus", chunk), ("full length", full)):
        for runtime, b in (("padded", pad_b), ("paged", pag_b), ("paged ", pag_b),
                           ("padded ", pad_b)):
            chunk_ms.setdefault((name, runtime.strip()), []).append(
                time_ms(lambda: b._harvest_dev(toks), 3))
    del pad_b, pag_b
    for name in ("corpus", "full length"):
        log(f"harvest chunk {C}x{S} on the {name} chunk (CUDA events, mean of 3, two turns "
            f"each): padded {[round(t, 3) for t in chunk_ms[(name, 'padded')]]} ms, paged "
            f"{[round(t, 3) for t in chunk_ms[(name, 'paged')]]} ms")

    # K1 alone at the harvest shape, timed
    gen = torch.Generator(device="cuda").manual_seed(12)
    q = torch.randn((C, S, H, hd), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((C, S, KV, hd), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    lens = torch.as_tensor(lengths, device="cuda")
    kw = dict(page_size=page, scale=lm_cfg.query_pre_attn_scalar ** -0.5,
              softcap=lm_cfg.attn_softcap, window=0)
    err = _k1_err(pa.paged_attention(q, k, v, lens, **kw),
                  pa.paged_attention_plain(q, k, v, lens, **kw), lengths, H)
    if not (err[0] <= 2e-2 and err[1] <= 2e-2):
        fail(f"K1 at the harvest shape: {err} > 2e-2")
    ms = time_ms(lambda: pa.paged_attention(q, k, v, lens, **kw), 20)
    plain_ms = time_ms(lambda: pa.paged_attention_plain(q, k, v, lens, **kw), 5)
    pos = torch.arange(S, device="cuda")
    mask = ((pos[None, :, None] >= pos[None, None, :])
            & (pos[None, None, :] < lens[:, None, None].long()))[:, None]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                      scale=kw["scale"], enable_gqa=True), 20)
    n_tok = int(lengths.sum())
    pairs = sum(t + 1 for ln in lengths for t in range(int(ln)))
    b_ms, b_by = bound(n_tok * (2 * H + 2 * KV) * hd * 2 + C * 4, 4 * hd * H * pairs, "bf16")
    log(f"K1 harvest shape {C}x{S} bf16 (tensor_cores, wgmma + TMA): {ms:.4f} ms kernel "
        f"(mma.sync design [{CUDA_CORE_MS['K1 harvest mma.sync']}]), {plain_ms:.4f} ms plain, "
        f"{library_ms:.4f} ms sdpa (explicit mask, no softcap), bound {b_ms:.4f} ms by {b_by}")
    row_k1 = {"name": "paged_attention (harvest)", "route": "cuda",
              "source": "crosscoder_tpu_torch/csrc/paged_attention.cu",
              "replaces": "crosscoder_tpu/ops/paged_attention.py:189", "launches": None,
              "max_abs_err": max(err[0], worst[0]), "ms": ms, "plain_ms": plain_ms,
              "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}
    del q, k, v, qt, kt, vt, mask

    counters = launch_counters()
    legs = {}
    # leg S: leg H's config with refill overlap: SegmentedHarvest quanta
    # from the dispatcher thread; the served stream must be leg H's
    cfg_s = cfg_h.replace(refill_overlap="on")
    spans = SpanCounter()
    prev = trace.set_tracer(spans)
    reset_counters(counters)
    buffer = bufmod.make_buffer(cfg_s, lm_cfg, params, tokens, device="cuda")
    rec = Recorder(torch, buffer, keep=0, keep_all=True)
    tr = trainer_mod.Trainer(cfg_s, rec, device="cuda")
    losses, l0s, step_ms = timed_steps(torch, tr, LEG_H)
    trace.set_tracer(prev)
    legs["S"] = {n: c.launches for n, c in counters.items() if c.launches}
    same = [torch.equal(a.view(torch.int16), b.view(torch.int16))
            for a, b in zip(rec.stream, leg_h["stream"])]
    cycles = spans.counts.get("refill", 0) - 1
    log(f"leg S (leg H with refill_overlap='on': {buffer._spare_rows} spare rows, "
        f"{spans.counts.get('refill_dispatch', 0)} dispatcher pumps, {cycles} refill cycles): "
        f"losses {[round(x, 4) for x in losses]}; launches {legs['S']}")
    log(f"leg S: {len(same)} served batches against leg H's: "
        f"{'bitwise equal' if all(same) and len(same) == LEG_H else 'DIFFERENT at ' + str(same)}")
    log(f"leg S: ms per step incl. serve (host clock, loss to loss) {_ms_line(np, step_ms)}; next_raw "
        f"{[round(t, 2) for t in rec.serve_ms]} ms")
    log(f"leg H (overlap off) ms per step {_ms_line(np, leg_h['step_ms'])}; next_raw "
        f"{[round(t, 2) for t in leg_h['serve_ms']]} ms")
    buffer.close()
    if not (all(same) and len(same) == LEG_H):
        fail("leg S: the overlapped buffer's served stream differs from leg H's")
    if not (all(map(math.isfinite, losses)) and cycles >= 2
            and spans.counts.get("refill_dispatch", 0) > 0):
        fail(f"leg S: a loss is not finite, or fewer than 2 refill cycles ({cycles}) went "
             f"through the dispatcher")
    check_o1("leg S", legs["S"], LEG_H)
    legs["S ms"] = step_ms
    del tr, rec, buffer

    # leg P: the paged harvest through K1 with refill overlap, BatchTopK
    # over the bf16 card store; a save and a restore through the dispatcher
    cfg_p = cfg_h.replace(harvest_runtime="paged", refill_overlap="on")
    spans = SpanCounter()
    prev = trace.set_tracer(spans)
    reset_counters(counters)
    pa.paged_attention.launches = 0
    pa.paged_attention.by_route.update(dict.fromkeys(pa.paged_attention.by_route, 0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    buffer = bufmod.make_buffer(cfg_p, lm_cfg, params, tokens, device="cuda")
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    tr = trainer_mod.Trainer(cfg_p, buffer, device="cuda")
    chunks0 = buffer._paged_total_tokens // (C * S)
    losses, l0s, step_ms = timed_steps(torch, tr, LEG_P)
    buffer._quiesce_dispatch()
    torch.cuda.synchronize()
    trace.set_tracer(prev)
    legs["P"] = {n: c.launches for n, c in counters.items() if c.launches}
    k1 = pa.paged_attention.launches
    legs["P"]["paged_attention"] = k1
    chunks = buffer._paged_total_tokens // (C * S)
    cycles = spans.counts.get("refill", 0) - 1
    eff = buffer.padding_efficiency()
    live = buffer._row_map
    zero_rows = 0
    for i in range(0, len(live), 4096):
        rows = buffer._store[torch.as_tensor(live[i:i + 4096], device="cuda")]
        zero_rows += int((rows.view(torch.int16).abs().amax(dim=(1, 2)) == 0).sum())
    harvest_ms = (chunks - chunks0) * np.mean(chunk_ms[("corpus", "paged")])
    log(f"leg P (paged harvest through K1, refill overlap, BatchTopK, {type(buffer).__name__} "
        f"on {buffer.store_device}): fill {fill_s:.2f} s; {chunks} chunks harvested ({chunks0} "
        f"by the fill), {cycles} refill cycles; padding efficiency {eff:.4f}; losses "
        f"{[round(x, 4) for x in losses]}; l0 {[round(x, 1) for x in l0s]} (k={cfg_p.topk_k})")
    log(f"leg P: ms per step incl. serve (host clock, loss to loss) {_ms_line(np, step_ms)}; the "
        f"harvest's share of the steps about {100 * harvest_ms / sum(step_ms):.1f}% "
        f"({chunks - chunks0} chunks at the corpus chunk's paged time); launches {legs['P']}; "
        f"K1 by route {pa.paged_attention.by_route}; all-zero live store rows {zero_rows}")
    if not (all(map(math.isfinite, losses)) and np.mean(l0s) >= cfg_p.topk_k):
        fail(f"leg P: a loss is not finite or mean l0 {np.mean(l0s)} below k={cfg_p.topk_k}")
    if (k1 != K1_PER_CHUNK * chunks or pa.paged_attention.by_route["tensor_cores"] != k1
            or chunks == 0):
        fail(f"leg P: K1 launched {k1} times for {chunks} chunks, want {K1_PER_CHUNK} a chunk "
             f"on the tensor cores")
    if zero_rows or cycles < 2 or not 0 < eff < 1:
        fail(f"leg P: {zero_rows} all-zero store rows, {cycles} refill cycles, efficiency {eff}")
    check_o1("leg P", legs["P"], LEG_P)
    legs["P ms"] = step_ms
    tmp = ckpt_dir(root)
    tr.checkpointer = Checkpointer(base_dir=tmp)
    for _ in range(2):                              # into the next shadow cycle
        tr.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.save()                                       # quiesces the dispatcher first
    save_s = time.perf_counter() - t0
    meta = json.loads((Checkpointer.latest_version_dir(tmp) / "0_meta.json").read_text())
    cfg_r = cfg_p.replace(resume=True, checkpoint_dir=str(tmp))
    t0 = time.perf_counter()
    fresh = bufmod.make_buffer(cfg_r, lm_cfg, params, tokens, device="cuda", lazy=True)
    tr2 = trainer_mod.Trainer(cfg_r, fresh, device="cuda",
                              checkpointer=Checkpointer(base_dir=tmp))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    st = fresh.state_dict()
    ok, what = state_bits_equal(torch, tr.state, tr2.state)
    same_buf = (st["token_pointer"] == meta["buffer"]["token_pointer"]
                and st["normalisation_factor"] == meta["buffer"]["normalisation_factor"])
    more = [float(tr2.step()["loss"]) for _ in range(2)]
    log(f"leg P save at step {meta['step']} mid shadow cycle: {save_s:.2f} s; restore into a "
        f"fresh paged overlap buffer and Trainer {restore_s:.2f} s: state "
        f"{'bitwise equal' if ok else 'DIFFERENT ' + what}; token_pointer "
        f"{st['token_pointer']} and normalisation factors {'equal' if same_buf else 'DIFFERENT'} "
        f"to the meta; 2 more steps, losses {[round(x, 4) for x in more]}")
    shutil.rmtree(tmp)
    tr.close()
    tr2.close()
    if not (ok and same_buf and all(map(math.isfinite, more))):
        fail("leg P: the save and restore through the dispatcher failed its gate")
    log(f"data plane phase {time.perf_counter() - t_phase:.1f} s")
    del tr, tr2, buffer, fresh
    return row_k1, legs

# ---------------------------------------------------------------------------
# phase 10: the trainer's remaining numerics and recovery


class PoisonedBatches:
    """Serves ``inner``'s batches, serve ``nan_serve`` (counted from 0 over
    every serve of this wrapper) all NaN; the checkpointed position is the
    inner source's."""

    def __init__(self, inner, nan_serve):
        self.inner, self.nan_serve, self.serves = inner, nan_serve, 0

    def next(self):
        b = self.inner.next()
        if self.serves == self.nan_serve:
            b = b.new_full(b.shape, float("nan"))
        self.serves += 1
        return b

    def state_dict(self):
        return self.inner.state_dict()

    def load_state_dict(self, d):
        self.inner.load_state_dict(d)


class CaptureResample:
    """Stands in for a trainer's resample function: runs it and keeps a
    copy of its input state, the generator's state, the batch and the
    output state (the trainer's next step writes into the output)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, state, batch, scale, gen):
        import copy

        g0 = gen.get_state()
        new, n = self.fn(state, batch, scale, gen)
        self.calls.append(dict(state=copy.deepcopy(state), out=copy.deepcopy(new), n=int(n),
                               gen=g0, batch=batch, scale=scale))
        return new, n


def leg_steps(torch, tr, steps, full=True):
    """``steps`` trainer steps, each timed by CUDA events; the metrics as
    host floats."""
    out = []
    for _ in range(steps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        m = tr.step(full_metrics=full)
        e1.record()
        torch.cuda.synchronize()
        out.append({**{k: float(v) for k, v in m.items()
                       if k != "explained_variance_per_source"}, "ms": e0.elapsed_time(e1)})
    return out


def leg_launches(counters, label, steps, routes=True):
    launches = {n: c.launches for n, c in counters.items() if c.launches}
    launches["by route"] = read_routes()
    check_o1(label, launches, steps)
    if routes:
        check_routes(label, launches, launches["by route"])
    return launches


def jumprelu_leg(torch, np, batches):
    """Leg J: a 4-step BatchTopK run, its θ calibrated into a JumpReLU
    warm start, 6 JumpReLU steps and 2 at bf16 masters (O1 over bf16
    weights and the f32 log_theta in one launch), a step against its
    re-run with the plain update, one step profiled."""
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.models import crosscoder as cc
    from crosscoder_tpu_torch.ops import activations as act
    from crosscoder_tpu_torch.ops import adam
    from crosscoder_tpu_torch.train import trainer as trainer_mod
    from crosscoder_tpu_torch.train.state import Optimizer, TrainState
    from crosscoder_tpu_torch.train.warmstart import jumprelu_warmstart_params

    B = TRAIN["batch_size"]
    cfg_bt = CrossCoderConfig(**LEG_BT, num_tokens=B * STEPS_BT)
    cfg_j = CrossCoderConfig(**LEG_J, num_tokens=B * STEPS_J)
    counters = launch_counters()
    reset_counters(counters)
    batches.i = 0
    tr_bt = trainer_mod.Trainer(cfg_bt, batches, device="cuda")
    bt = leg_steps(torch, tr_bt, STEPS_BT)
    t0 = time.perf_counter()
    params = jumprelu_warmstart_params(tr_bt.state.params, cfg_bt, cfg_j, batches.batches[:2])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    del tr_bt
    lt0 = params["log_theta"].clone()
    opt = Optimizer(cfg_j, trainer_mod.schedules.lr_schedule(cfg_j))
    batches.i = 0
    tr = trainer_mod.Trainer(cfg_j, batches, device="cuda",
                             state=TrainState(params, opt.init(params), 0, None))
    js = leg_steps(torch, tr, STEPS_J)
    launches = leg_launches(counters, "leg J", STEPS_BT + STEPS_J, routes=False)
    theta = float(torch.exp(lt0[0]))
    moved = float((tr.state.params["log_theta"] - lt0).abs().max())
    log(f"leg J: BatchTopK warm-up losses {[round(m['loss'], 4) for m in bt]}; θ calibrated "
        f"at {theta:.6f} in {warm_s:.2f} s; JumpReLU losses "
        f"{[round(m['loss'], 4) for m in js]}, l0 {[round(m['l0_loss'], 1) for m in js]} "
        f"(k={cfg_bt.topk_k}; the first step's L0 {js[0]['l0_loss']:.2f} beside k), "
        f"l2 {[round(m['l2_loss'], 4) for m in js]}; log_theta moved by up to {moved:.3e}; "
        f"ms per step {[round(m['ms'], 3) for m in js]}; launches {launches}")
    if not (all(math.isfinite(m["loss"]) for m in bt + js) and moved > 0):
        fail("leg J: a loss is not finite or log_theta did not move")
    if not launches.get("batchtopk_select"):
        fail(f"leg J: the BatchTopK warm-up never launched K9: {launches}")
    # one step re-run with the plain update: the same bits
    x, scale = batches.next(), torch.ones(cfg_j.n_sources, device="cuda")
    fn = trainer_mod.make_step_body(cfg_j, opt, True, True, True)
    got, _ = fn(tr.state, x, scale)
    with swapped(adam, "adam_update", adam.adam_update_plain):
        want, _ = fn(tr.state, x, scale)
    ok, what = state_bits_equal(torch, got, want)
    log(f"leg J: a step with O1 vs the plain update: "
        f"{'bitwise equal params, log_theta and moments' if ok else 'DIFFERENT ' + what}")
    if not ok:
        fail(f"leg J: the step with O1 differs from the plain update in {what}")
    del got, want
    # bf16 masters beside the f32 log_theta: one O1 launch a step
    cfg_jb = cfg_j.replace(master_dtype="bf16", num_tokens=B * STEPS_JB)
    pb = {k: v.clone() if k == "log_theta" else v.to(torch.bfloat16)
          for k, v in tr.state.params.items()}
    opt_b = Optimizer(cfg_jb, trainer_mod.schedules.lr_schedule(cfg_jb))
    reset_counters(counters)
    tr_b = trainer_mod.Trainer(cfg_jb, batches, device="cuda",
                               state=TrainState(pb, opt_b.init(pb), 0, None))
    jb = leg_steps(torch, tr_b, STEPS_JB)
    launches_b = leg_launches(counters, "leg J at bf16 masters", STEPS_JB, routes=False)
    dts = {k: str(v.dtype)[6:] for k, v in tr_b.state.params.items()}
    fn_b = trainer_mod.make_step_body(cfg_jb, opt_b, True, True, True)
    got, _ = fn_b(tr_b.state, x, scale)
    with swapped(adam, "adam_update", adam.adam_update_plain):
        want, _ = fn_b(tr_b.state, x, scale)
    ok, what = state_bits_equal(torch, got, want)
    log(f"leg J at bf16 masters ({dts}): losses {[round(m['loss'], 4) for m in jb]}, O1 "
        f"launches {launches_b['adam_update']} in {STEPS_JB} steps; a step with O1 over the "
        f"mixed leaves vs the plain update: "
        f"{'bitwise equal' if ok else 'DIFFERENT ' + what}")
    if not (ok and dts["log_theta"] == "float32" and dts["W_enc"] == "bfloat16"
            and all(math.isfinite(m["loss"]) for m in jb)):
        fail(f"leg J at bf16 masters: O1 over mixed leaves failed ({what}, {dts})")
    del got, want
    row = check_adam_mixed(torch, np, tr_b.state, fn_b.loss_and_grads(tr_b.state, x, scale)[2],
                           cfg_jb)
    row["launches"] = launches_b["adam_update"]
    del tr_b, pb
    # the JumpReLU elementwise work's share of a step's device time
    total = profile_step(torch, tr, True, "leg J step")
    cp = cc.cast_params(tr.state.params, torch.bfloat16)
    h = cc.pre_acts(cp, x.to(torch.bfloat16))
    g = torch.randn(h.shape, device="cuda").to(h.dtype)
    lt = tr.state.params["log_theta"]
    one = torch.ones((), device="cuda")

    def jumprelu_fwd_bwd():
        hh, ll = h.detach().requires_grad_(True), lt.detach().requires_grad_(True)
        out = act.jumprelu(hh, ll, cfg_j.jumprelu_bandwidth)
        pen = act.jumprelu_l0(hh, ll, cfg_j.jumprelu_bandwidth)
        torch.autograd.backward([out, pen], [g, one])

    jr_ms = time_ms(jumprelu_fwd_bwd, 5)
    share = f"{100 * jr_ms / total:.1f}%" if total else "not measured"
    log(f"leg J: the JumpReLU forward and backward with the L0 term on h {list(h.shape)} "
        f"{str(h.dtype)[6:]}: {jr_ms:.3f} ms (CUDA events) of a {total or 0:.3f} ms step "
        f"(profiled device time): {share}")
    # the bf16 steps' O1 launches are the mixed row's (`row`), not the f32 row's
    return launches, row


def check_adam_mixed(torch, np, state, grads, cfg):
    """O1 at leg J's bf16 state (bf16 weights, the f32 log_theta): bitwise
    against the plain update, timed back to back and queued beside it, one
    fused Adam call of PyTorch's where it takes the mixed leaves, and the
    bound (each leaf's p, g, m, v read once, p, m, v written once, in its
    own dtype). Returns the kernel-table row."""
    from crosscoder_tpu_torch.ops import adam
    from crosscoder_tpu_torch.train.state import Optimizer

    p, m, v = state.params, state.opt_state.mu, state.opt_state.nu
    t = state.opt_state.count + 1
    kw = dict(max_norm=cfg.grad_clip, b1=cfg.beta1, b2=cfg.beta2, eps=1e-8,
              bc1=float(np.float32(1) - np.float32(cfg.beta1) ** np.float32(t)),
              bc2=float(np.float32(1) - np.float32(cfg.beta2) ** np.float32(t)),
              step_size=float(-np.float32(cfg.lr)))
    norm = Optimizer.global_norm(grads)
    outs = [tuple({k: torch.empty_like(a) for k, a in p.items()} for _ in range(3))
            for _ in range(2)]
    before = adam.adam_update.launches
    adam.adam_update(p, grads, m, v, norm, out=outs[0], **kw)
    adam.adam_update_plain(p, grads, m, v, norm, out=outs[1], **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(a[k].view(torch.uint8), b[k].view(torch.uint8))
               for a, b in zip(*outs) for k in p)
    err = max(float((a[k].float() - b[k].float()).abs().max()) for a, b in zip(*outs) for k in p)
    if not same:
        fail("O1 over bf16 weights and the f32 log_theta differs from the plain update")
    ms = time_ms(lambda: adam.adam_update(p, grads, m, v, norm, out=outs[0], **kw), 20)
    q_ms = time_ms(lambda: adam.adam_update(p, grads, m, v, norm, out=outs[0], **kw), 20,
                   queued=True)
    plain_ms = time_ms(lambda: adam.adam_update_plain(p, grads, m, v, norm, out=outs[1], **kw), 3)
    lib_p = {k: a.clone() for k, a in p.items()}
    for k, a in lib_p.items():
        a.grad = grads[k]
    try:
        lib = torch.optim.Adam(list(lib_p.values()), lr=cfg.lr, betas=(cfg.beta1, cfg.beta2),
                               eps=1e-8, fused=True)
        library_ms = time_ms(lib.step, 20)
    except (RuntimeError, ValueError) as e:
        log(f"O1 mixed: torch.optim.Adam(fused=True) refused the mixed leaves ({e})"[:300])
        library_ms = None
    del lib_p
    adam.adam_update.launches = before            # the probe's launches are not the path's
    n = sum(a.numel() for a in p.values())
    n_bytes = sum(7 * a.element_size() * a.numel() for a in p.values())
    b_ms, b_by = bound(n_bytes, 20 * n, "fp32")
    log(f"O1 adam_update over {len(p)} leaves ({n} values: "
        f"{ {k: str(a.dtype)[6:] for k, a in p.items()} }), bitwise the plain update: "
        f"{ms:.4f} ms back to back, {q_ms:.4f} ms queued; the plain update {plain_ms:.4f} ms; "
        f"torch.optim.Adam(fused=True, no clip) "
        f"{'not measured' if library_ms is None else f'{library_ms:.4f} ms'}; bound "
        f"{b_ms:.4f} ms by {b_by} ({n_bytes / 1e9:.3f} GB)")
    del outs
    return {"name": "adam_update (bf16 masters, f32 log_theta)", "route": "cuda",
            "source": "crosscoder_tpu_torch/csrc/adam_update.cu",
            "replaces": "crosscoder_tpu/train/state.py:33 (the optax chain XLA fuses in "
                        "crosscoder_tpu/train/trainer.py:351; no Pallas site)",
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms, "queued_ms": q_ms}


def sparse_decode_leg(torch, np, batches):
    """Leg D: sparse_decode at dict 2^15 (K5, K8) and 2^17 (K7, K8), 4
    steps each, one step's loss and gradients against the dense TopK path
    from the same state, step times and peak memory."""
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.train import trainer as trainer_mod
    from crosscoder_tpu_torch.train.state import Optimizer

    out = {}
    counters = launch_counters()
    for H, mask in ((2 ** 15, "topk_mask"), (2 ** 17, "topk_chunked")):
        cfg = CrossCoderConfig(**{**LEG_D, "dict_size": H},
                               num_tokens=TRAIN["batch_size"] * STEPS_D)
        batches.i = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters(counters)
        tr = trainer_mod.Trainer(cfg, batches, device="cuda")
        ms = leg_steps(torch, tr, STEPS_D)
        launches = leg_launches(counters, f"leg D at {H}", STEPS_D)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if not (launches.get(mask) and launches.get("sparsify")
                and all(math.isfinite(m["loss"]) for m in ms)):
            fail(f"leg D at {H}: a loss is not finite or the mask ({mask}) or K8 never "
                 f"launched: {launches}")
        x, scale = batches.next(), torch.ones(cfg.n_sources, device="cuda")
        opt = Optimizer(cfg, lambda s: 0.0)
        dense = cfg.replace(sparse_decode=False, factored_decode="off")
        a = trainer_mod.make_step_body(cfg, opt).loss_and_grads(tr.state, x, scale)
        b = trainer_mod.make_step_body(dense, opt).loss_and_grads(tr.state, x, scale)
        rel_loss = abs(float(a[0]) - float(b[0])) / abs(float(b[0]))
        rel_g = {k: float(torch.linalg.norm((a[2][k] - b[2][k]).float())
                          / torch.linalg.norm(b[2][k].float())) for k in a[2]}
        log(f"leg D at dict {H}: losses {[round(m['loss'], 4) for m in ms]}, l0 "
            f"{[round(m['l0_loss'], 2) for m in ms]}; ms per step "
            f"{[round(m['ms'], 3) for m in ms]} (leg A's bare dense step "
            f"{STEP_MS.get('leg A bare', float('nan')):.3f} ms at 2^15); peak memory "
            f"{peak:.2f} GiB; launches {launches}; one step against the dense TopK path: loss "
            f"{float(a[0]):.6f} vs {float(b[0]):.6f} (relative {rel_loss:.2e}, tol "
            f"{SPARSE_DECODE_TOL[0]}), gradients relative in norm "
            f"{ {k: f'{v:.2e}' for k, v in rel_g.items()} } (tol {SPARSE_DECODE_TOL[1]})")
        if not (rel_loss <= SPARSE_DECODE_TOL[0] and max(rel_g.values()) <= SPARSE_DECODE_TOL[1]):
            fail(f"leg D at {H}: sparse_decode disagrees with the dense TopK path")
        if any(m["l0_loss"] > cfg.topk_k for m in ms):
            fail(f"leg D at {H}: l0 above k")
        out[H] = launches
        del tr, a, b
    return out


def resample_leg(torch, np, batches):
    """Leg R: leg A's config resampling every 4 steps, 8 steps; the revived
    rows checked right after the edit and the edit re-run from the same
    generator state."""
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.train import trainer as trainer_mod
    from crosscoder_tpu_torch.train.resample import make_resample_fn

    cfg = CrossCoderConfig(**LEG_R, num_tokens=TRAIN["batch_size"] * STEPS_R)
    counters = launch_counters()
    batches.i = 0
    reset_counters(counters)
    tr = trainer_mod.Trainer(cfg, batches, device="cuda")
    cap = tr._resample_fn = CaptureResample(make_resample_fn(cfg))
    ms = leg_steps(torch, tr, STEPS_R)
    launches = leg_launches(counters, "leg R", STEPS_R)
    res = [(i, int(m["resampled"])) for i, m in enumerate(ms) if "resampled" in m]
    log(f"leg R: losses {[round(m['loss'], 4) for m in ms]}; dead_frac "
        f"{[round(m['dead_frac'], 4) for m in ms]}; resampled (step, latents) {res}; ms per "
        f"step {[round(m['ms'], 3) for m in ms]}; launches {launches}")
    if not (res and all(n > 0 for _, n in res) and all(math.isfinite(m["loss"]) for m in ms)):
        fail(f"leg R: no resample revived a latent, or a loss is not finite: {res}")
    if not all(launches.get(n) for n in ("topk_mask", "sparsify", "scatter_add_rows")):
        fail(f"leg R: a kernel of the path never launched: {launches}")
    c = cap.calls[0]
    dead = c["state"].aux["steps_since_fired"] >= cfg.resample_threshold_steps
    out = c["out"]
    dec = torch.linalg.norm(out.params["W_dec"][dead].float(), dim=-1)
    dec_err = float((dec - cfg.dec_init_norm).abs().max() / cfg.dec_init_norm)
    zero = (not out.params["b_enc"][dead].any()
            and all(not t["W_dec"][dead].any() and not t["W_enc"][..., dead].any()
                    and not t["b_enc"][dead].any() for t in (out.opt_state.mu, out.opt_state.nu))
            and not out.aux["steps_since_fired"][dead].any())
    alive = ~dead
    kept = torch.equal(out.params["W_dec"][alive], c["state"].params["W_dec"][alive])
    gen = torch.Generator(device="cuda")
    gen.set_state(c["gen"])
    again, n2 = make_resample_fn(cfg)(c["state"], c["batch"], c["scale"], gen)
    ok, what = state_bits_equal(torch, again, out)
    log(f"leg R: the resample at step 4 revived {c['n']} latents: decoder norms within "
        f"{dec_err:.2e} of dec_init_norm {cfg.dec_init_norm} (tol 1e-5), b_enc, moments and "
        f"trackers {'0' if zero else 'NOT 0'}, live rows {'untouched' if kept else 'CHANGED'}; "
        f"re-run from the same generator state: {'bitwise equal' if ok else 'DIFFERENT ' + what}")
    if not (c["n"] == int(dead.sum()) == int(n2) and dec_err <= 1e-5 and zero and kept and ok):
        fail("leg R: the revived rows failed their checks or the edit does not re-run bitwise")
    del cap, c, again, tr
    return launches


def guard_leg(torch, np, root, batches):
    """Leg G: leg A's config under the loss guard over a source whose serve
    9 is all NaN; one rollback, the counters as the JAX trainer counts
    them, and the final state bitwise a fresh Trainer's, restored from the
    same save, that skips the same serves by hand."""
    import shutil

    from crosscoder_tpu_torch.checkpoint import Checkpointer
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.train import trainer as trainer_mod

    d = ckpt_dir(root)
    cfg = CrossCoderConfig(**LEG_G, num_tokens=TRAIN["batch_size"] * STEPS_G,
                           checkpoint_dir=str(d))
    ck = Checkpointer(cfg=cfg)
    restores = []
    real_restore = ck.restore

    def timed_restore(*a, **kw):
        # the wait for a background save still writing, then the restore
        t0 = time.perf_counter()
        ck.wait()
        t1 = time.perf_counter()
        state, meta = real_restore(*a, **kw)
        torch.cuda.synchronize()
        restores.append((t1 - t0, time.perf_counter() - t1, meta["save_version"], meta["step"]))
        return state, meta

    ck.restore = timed_restore
    counters = launch_counters()
    batches.i = 0
    src = PoisonedBatches(batches, NAN_SERVE)
    reset_counters(counters)
    t0 = time.perf_counter()
    tr = trainer_mod.Trainer(cfg, src, device="cuda", checkpointer=ck)
    tr.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items() if c.launches}
    launches["by route"] = read_routes()
    check_routes("leg G", launches, launches["by route"])
    snap = tr.resilience.snapshot()
    # the first log step at or after the poisoned one detects; the newest
    # save at or before it (a save every save_every steps) is restored; the
    # serves from there to the detection are skipped
    detect = -(-NAN_SERVE // cfg.log_every) * cfg.log_every
    restored = detect // cfg.save_every * cfg.save_every
    n_skip = detect + 1 - restored
    want = {"resilience/rollbacks": 1, "resilience/skipped_batches": n_skip}
    n_steps = detect + 1 + STEPS_G - restored
    state_bytes = sum(t.numel() * t.element_size() for tree in (
        tr.state.params, tr.state.opt_state.mu, tr.state.opt_state.nu) for t in tree.values())
    log(f"leg G: {tr.step_counter} steps ({n_steps} run: 0..{detect}, then {restored}.."
        f"{STEPS_G - 1}) in {wall:.1f} s with saves; counters {snap} (the JAX trainer's count: "
        f"{want}); serves {src.serves}; the rollback's restore: {restores[0][0]:.2f} s waiting "
        f"for the background save in flight, then {restores[0][1]:.2f} s restoring save "
        f"{restores[0][2]} (step {restores[0][3]}: {state_bytes / 1e9:.2f} GB of state, its "
        f"checksums verified); launches {launches}")
    if not (snap == want and tr.step_counter == STEPS_G and len(restores) == 1
            and restores[0][3] == restored and src.serves == n_steps + n_skip):
        fail(f"leg G: expected one rollback to step {restored} with {want}, got {snap}")
    check_o1("leg G", launches, n_steps)
    # a fresh Trainer from the rollback's save, the poisoned window skipped by hand
    _, _, v, step = restores[0]
    batches.i = 0
    tr2 = trainer_mod.Trainer(cfg.replace(guard_loss=False), batches, device="cuda",
                              checkpointer=Checkpointer(base_dir=d))
    tr2.restore(version_dir=ck.save_dir, save=v)
    for _ in range(n_skip):
        batches.next()
    while tr2.step_counter < STEPS_G:
        tr2.step()
    ok, what = state_bits_equal(torch, tr.state, tr2.state)
    log(f"leg G: a fresh Trainer restored from save {v} (step {step}), {n_skip} serves skipped "
        f"by hand, {STEPS_G - step} steps: final state "
        f"{'bitwise equal' if ok else 'DIFFERENT ' + what} to the guarded run's")
    if not ok:
        fail(f"leg G: the guarded run's final state differs from the replay in {what}")
    del tr, tr2
    shutil.rmtree(d)
    return launches


def replica_leg(torch, np, eng):
    """The replica hand-off: engine A (phase 4's) queues 8 mixed-length
    requests and is preempted; engine B, on the same models and
    crosscoder, adopts them from a shared board and serves them; each
    result bitwise engine A's serving the same request directly."""
    import shutil
    import tempfile

    from crosscoder_tpu_torch.ops import fused_encoder_topk as fek
    from crosscoder_tpu_torch.ops import paged_attention as pa
    from crosscoder_tpu_torch.serve import InferenceEngine, ReplicaBoard, ServeReplica

    eng_b = InferenceEngine(eng.cfg, eng.lm_cfg, eng._lm_params, eng._cc_params,
                            norm_factors=eng._norm.cpu().numpy(), device="cuda")
    rng = np.random.default_rng(13)
    S = eng.cfg.seq_len
    lengths = [1, S] + [int(n) for n in rng.integers(2, S, size=N_REPLICA - 2)]
    docs = [rng.integers(1, eng.lm_cfg.vocab_size, size=n, dtype=np.int32) for n in lengths]
    d = Path(tempfile.mkdtemp(prefix="chip_smoke_board_"))
    board = ReplicaBoard(d)
    rep_a, rep_b = ServeReplica("a", eng, board), ServeReplica("b", eng_b, board)
    pa.paged_attention.launches = 0
    fek.fused_topk_encode.launches = 0
    rep_a.heartbeat()
    rep_b.heartbeat()
    for doc in docs:
        eng.submit(doc)
    spooled = rep_a.preempt()
    adopted = rep_b.heartbeat()
    got = eng_b.step(force=True)
    rids = [eng.submit(doc) for doc in docs]
    direct = {r.request_id: r for r in eng.step(force=True)}
    want = [direct[r] for r in rids]
    torch.cuda.synchronize()
    launches = {"paged_attention": pa.paged_attention.launches,
                "fused_topk_encode": fek.fused_topk_encode.launches}
    same = len(got) == len(want) == N_REPLICA and all(
        np.array_equal(a.vals.view(np.int32), b.vals.view(np.int32))
        and np.array_equal(a.idx, b.idx)
        and np.array_equal(a.diff.view(np.int32), b.diff.view(np.int32))
        for a, b in zip(got, want))
    log(f"replica: lengths {lengths}; A spooled {spooled}, B adopted {adopted} "
        f"(serve/adopted_total {eng_b.stats().get('serve/adopted_total')}), served "
        f"{len(got)} under bucket {sorted({r.bucket for r in got})}; results "
        f"{'bitwise equal' if same else 'DIFFERENT'} to A serving the same requests directly; "
        f"launches {launches}")
    shutil.rmtree(d)
    if not (spooled == adopted == N_REPLICA and same):
        fail("replica: the hand-off lost a request or served it differently")
    if not all(launches.values()):
        fail(f"replica: a serve kernel never launched: {launches}")
    del eng_b
    return launches


def recovery(torch, np, root):
    """Phase 10: legs J, D, R and G over synthetic batches made ahead
    onto the card; returns each leg's launch counts."""
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource

    t_phase = time.perf_counter()
    batches = DeviceBatches(torch, SyntheticActivationSource(CrossCoderConfig(**TRAIN)),
                            STEPS_G + 4)
    legs = {}
    legs["J"], row_o1_mixed = jumprelu_leg(torch, np, batches)
    legs["D"] = sparse_decode_leg(torch, np, batches)
    legs["R"] = resample_leg(torch, np, batches)
    legs["G"] = guard_leg(torch, np, root, batches)
    log(f"recovery phase {time.perf_counter() - t_phase:.1f} s")
    return legs, row_o1_mixed


# ---------------------------------------------------------------------------
# phase 11: the parallel trainer on one card (a grid of one rank over NCCL)

# the CPU rehearsal of the multi-rank path: 2 x 2 gloo ranks against one,
# tiny width, at the JAX mesh test's bar (tests/test_trainer.py)
REHEARSAL = dict(d_in=16, n_models=2, dict_size=64, batch_size=16, num_tokens=16 * 3,
                 enc_dtype="fp32", log_backend="null", seed=7, lr=5e-3, dec_init_norm=0.5,
                 prefetch=False)
REHEARSAL_CONFIGS = {
    "relu": dict(activation="relu", l1_coeff=2.0),
    "topk_auxk": dict(activation="topk", topk_k=4, l1_coeff=0.0, sparse_bwd="on", aux_k=8,
                      aux_dead_steps=1, aux_every=2),
    "batchtopk": dict(activation="batchtopk", topk_k=4, l1_coeff=0.0),
}
REHEARSAL_STEPS, REHEARSAL_TOL = 3, (2e-4, 2e-5)
QUANT_BLOCK = 256


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def cpu_rank_worker(rank, world, port, out, grid):
    """One gloo rank of the CPU rehearsal (``chip_smoke.py --cpu-rank``):
    each config trained ``REHEARSAL_STEPS`` steps on the ``grid``; rank 0
    saves the gathered params and the losses."""
    import torch

    torch.set_num_threads(1)
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
    from crosscoder_tpu_torch.parallel import mesh as mesh_lib
    from crosscoder_tpu_torch.parallel import multihost
    from crosscoder_tpu_torch.train.trainer import Trainer

    multihost.initialize("cpu", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                         rank=rank)
    res = {}
    for name, kw in REHEARSAL_CONFIGS.items():
        cfg = CrossCoderConfig(**REHEARSAL, **kw, data_axis_size=grid[0],
                               model_axis_size=grid[1])
        tr = Trainer(cfg, SyntheticActivationSource(cfg), device="cpu")
        losses = [float(tr.step()["loss"]) for _ in range(REHEARSAL_STEPS)]
        full = mesh_lib.gather_state(tr.mesh, tr.state)
        res[name] = {"losses": losses, "params": {k: v.clone() for k, v in full.params.items()}}
    if rank == 0:
        torch.save(res, out)
    multihost.shutdown()


def cpu_rehearsal(torch, np, root):
    """The multi-rank path on the CPU: 2 x 2 gloo ranks and one rank, each
    a process of this script with no card visible; the grid's params after
    ``REHEARSAL_STEPS`` steps within the JAX mesh test's bar of the one
    rank's. Uses nothing of the card."""
    import os
    import tempfile

    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_rehearsal_", dir=root / "build"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    results = {}
    for grid in ((2, 2), (1, 1)):
        world, port = grid[0] * grid[1], _free_port()
        out = tmp / f"grid{grid[0]}x{grid[1]}.pt"
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--cpu-rank",
                                   str(r), str(world), str(port), str(out), f"{grid[0]}x{grid[1]}"],
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                 for r in range(world)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in procs):
            for r, text in enumerate(outs):
                log(f"rehearsal rank {r}: {text[-2000:]}")
            fail(f"the CPU rehearsal's {grid} grid failed")
        results[grid] = torch.load(out, weights_only=False)
    rtol, atol = REHEARSAL_TOL
    worst = 0.0
    for name in REHEARSAL_CONFIGS:
        got, want = results[(2, 2)][name], results[(1, 1)][name]
        for k, v in want["params"].items():
            a, b = got["params"][k].numpy(), v.numpy()
            if not np.allclose(a, b, rtol=rtol, atol=atol):
                fail(f"CPU rehearsal: {name} {k} on 2 x 2 gloo ranks differs from one rank "
                     f"beyond rtol {rtol} atol {atol}")
            worst = max(worst, float(np.max(np.abs(a - b))))
        log(f"parallel: CPU rehearsal (gloo, on the host's CPU, nothing of the card; torch "
            f"{torch.__version__}) {name}: losses 2x2 {[round(x, 6) for x in got['losses']]} vs "
            f"one rank {[round(x, 6) for x in want['losses']]}")
    log(f"parallel: CPU rehearsal (nothing of the card): 2 x 2 gloo ranks within rtol {rtol} "
        f"atol {atol} of one rank after {REHEARSAL_STEPS} steps for "
        f"{sorted(REHEARSAL_CONFIGS)} (worst param difference {worst:.3e}) in "
        f"{time.perf_counter() - t0:.1f} s")


def _metric_bits(torch, m):
    return {k: (v.detach().float().reshape(-1).cpu().view(torch.int32).tolist()
                if torch.is_tensor(v) else v) for k, v in m.items()}


def _mesh_steps(torch, tr_s, tr_m, steps, label, routes=None):
    """``steps`` steps of the single-device trainer ``tr_s`` and the mesh
    trainer ``tr_m`` in turns, each timed (CUDA events); after each step
    the loss, every metric and the full state bitwise, else fail. Returns
    the two step times and the mesh steps' kernel launches and NCCL calls
    by op (counts from 0 around the mesh steps only); ``routes``, when
    given, sums the mesh steps' K8 and K11 launches by route."""
    from crosscoder_tpu_torch.parallel import collectives as coll

    counters = launch_counters()
    launches, calls = {n: 0 for n in counters}, {}
    t_s, t_m = [], []
    for i in range(steps):
        e = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        e[0].record()
        ms = tr_s.step(full_metrics=True)
        e[1].record()
        reset_counters(counters)
        coll.reset_counts()
        e[2].record()
        mm = tr_m.step(full_metrics=True)
        e[3].record()
        torch.cuda.synchronize()
        for n, c in counters.items():
            launches[n] += c.launches
        if routes is not None:
            for kernel, by in read_routes().items():
                for route, n in by.items():
                    routes.setdefault(kernel, {}).setdefault(route, 0)
                    routes[kernel][route] += n
        for op, n in coll.calls.items():
            calls.setdefault(op, []).append(n)
        t_s.append(e[0].elapsed_time(e[1]))
        t_m.append(e[2].elapsed_time(e[3]))
        if _metric_bits(torch, ms) != _metric_bits(torch, mm):
            fail(f"{label} step {i}: the mesh trainer's metrics differ from the single-device "
                 f"trainer's: {ms} vs {mm}")
        ok, what = state_bits_equal(torch, tr_s.state, tr_m.state)
        if not ok:
            fail(f"{label} step {i}: the mesh trainer's state differs in {what}")
    return t_s, t_m, {n: c for n, c in launches.items() if c}, calls


def _exchange(torch, quant_ar, group, grads, efs):
    """The int8 exchange over every leaf: (means, residuals, phase 1's)."""
    out = {}
    for k in sorted(grads):
        out[k] = quant_ar.quantized_pmean(group, grads[k], efs[k], QUANT_BLOCK)
    return out


def check_exchange(torch, np, mesh, state, cfg, batch):
    """The int8 gradient exchange at n_dev 1 over leg M's four gradient
    leaves: K11 on its quantize phases bitwise the plain exchange (the
    module's quantize swapped for ``quantize_blocks``): means, residuals,
    q and scales; K11's launches counted; timed back to back and queued
    beside the bound and NCCL all_reduce of the same gradients in f32 and
    bf16. Returns K11's kernel-table row for the exchange and the
    exchange's numbers."""
    import torch.distributed as dist

    from crosscoder_tpu_torch.ops import quant
    from crosscoder_tpu_torch.parallel import collectives as coll
    from crosscoder_tpu_torch.parallel import quant_ar
    from crosscoder_tpu_torch.train import trainer as trainer_mod
    from crosscoder_tpu_torch.train.state import Optimizer

    fn = trainer_mod.make_step_body(cfg, Optimizer(cfg, lambda s: 0.0), True, False, True,
                                    mesh=mesh)
    grads = fn.loss_and_grads(state, batch, torch.ones(cfg.n_sources, device="cuda"))[2]
    n_vals = sum(g.numel() for g in grads.values())
    group = mesh.data_group
    efs = {k: torch.zeros((1, quant_ar.padded_len(g.numel(), 1, QUANT_BLOCK)),
                          dtype=torch.float32, device="cuda") for k, g in grads.items()}
    quant.quantize_rows.launches = 0
    got = _exchange(torch, quant_ar, group, grads, efs)
    torch.cuda.synchronize()
    k11 = quant.quantize_rows.launches
    with swapped(quant_ar, "quantize", quant.quantize_blocks):
        want = _exchange(torch, quant_ar, group, grads, efs)
    for k in grads:
        (o1, e1, p1), (o2, e2, p2) = got[k], want[k]
        for what, a, b in (("mean", o1, o2), ("residual", e1, e2), ("q", p1["q"], p2["q"]),
                           ("scales", p1["scales"], p2["scales"])):
            if not torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
                fail(f"exchange {k}: the {what} with K11 differs from the plain exchange")
    if k11 != 2 * len(grads):
        fail(f"exchange: K11 launched {k11} times over {len(grads)} leaves (2 a leaf)")
    worst = max(float((got[k][0].float() - grads[k].float()).abs().max()) for k in grads)
    ms = time_ms(lambda: _exchange(torch, quant_ar, group, grads, efs), 5)
    ms_q = time_ms(lambda: _exchange(torch, quant_ar, group, grads, efs), 5, queued=True)
    with swapped(quant_ar, "quantize", quant.quantize_blocks):
        plain_ms = time_ms(lambda: _exchange(torch, quant_ar, group, grads, efs), 3)
    # read g and ef once, write the mean, the residual, q and the scales once
    n_ef = sum(e.numel() for e in efs.values())
    ex_bytes = 4 * n_vals + 4 * n_ef + 4 * n_vals + 4 * n_ef + n_ef + 4 * n_ef // QUANT_BLOCK
    ex_bound = bound(ex_bytes, 0, "fp32")
    flat = {k: e.reshape(-1)[: grads[k].numel()] for k, e in efs.items()}

    def all_reduce(ts):
        for t in ts:
            dist.all_reduce(t, group=group)

    f32 = [g.clone() for g in grads.values()]
    b16 = [g.to(torch.bfloat16) for g in grads.values()]
    nccl_f32 = time_ms(lambda: all_reduce(f32), 5)
    nccl_bf16 = time_ms(lambda: all_reduce(b16), 5)
    coll.reset_counts()
    # K11 alone on the exchange's phase 1 operands (one call a leaf)
    segs = [(grads[k].reshape(-1).float() + flat[k]).reshape(1, -1) for k in sorted(grads)]
    segs = [torch.nn.functional.pad(s, (0, efs[k].shape[-1] - s.shape[-1]))
            for s, k in zip(segs, sorted(grads))]
    k_ms = time_ms(lambda: [quant.quantize_rows(s, QUANT_BLOCK) for s in segs], 10)
    k_q = time_ms(lambda: [quant.quantize_rows(s, QUANT_BLOCK) for s in segs], 10, queued=True)
    k_plain = time_ms(lambda: [quant.quantize_blocks(s, QUANT_BLOCK) for s in segs], 3)
    k_bound = bound(4 * n_ef + n_ef + 4 * n_ef // QUANT_BLOCK, 0, "fp32")
    log(f"parallel: the int8 exchange (n_dev 1, block {QUANT_BLOCK}) over leg M's 4 gradient "
        f"leaves ({n_vals} values): bitwise the plain exchange (means, residuals, q, scales), "
        f"K11 {k11} launches, worst |mean - gradient| {worst:.3e}; {ms:.4f} ms back to back, "
        f"{ms_q:.4f} queued, plain exchange {plain_ms:.4f}; bound {ex_bound[0]:.4f} ms by "
        f"{ex_bound[1]} ({ex_bytes / 1e9:.3f} GB); NCCL all_reduce of the same gradients at "
        f"world 1: f32 {nccl_f32:.4f} ms, bf16 {nccl_bf16:.4f} ms (one card shows no wire "
        f"saving: that exists only across ranks)")
    log(f"parallel: K11 on the exchange's phase 1 operands (4 rows, {n_ef} values, f32): "
        f"{k_ms:.4f} ms back to back, {k_q:.4f} queued, plain {k_plain:.4f}, bound "
        f"{k_bound[0]:.4f} ms by {k_bound[1]}")
    row = {**_row("quantize_rows (gradient exchange)", "quantize_rows.cu",
                  "crosscoder_tpu/ops/quant.py:154", 0.0, k_ms, k_plain, k_bound, None),
           "launches": k11}
    return row, {"ms": ms, "queued_ms": ms_q, "plain_ms": plain_ms, "bound_ms": ex_bound[0],
                 "nccl_f32_ms": nccl_f32, "nccl_bf16_ms": nccl_bf16}


def parallel(torch, np, root):
    """Phase 11: the mesh trainer at data 1 x model 1 on an NCCL group of
    one rank (a FileStore under the run's build root), leg M against leg
    A's single-device Trainer and 4 BatchTopK steps against theirs, each
    step bitwise; the int8 exchange; a gathered save and an agreed restore
    (into the mesh and the single-device trainer); then the CPU rehearsal
    of the multi-rank path. Returns the mesh legs' launches and K11's
    exchange row."""
    import torch.distributed as dist

    from crosscoder_tpu_torch.checkpoint import Checkpointer
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
    from crosscoder_tpu_torch.parallel import mesh as mesh_lib
    from crosscoder_tpu_torch.parallel import multihost
    from crosscoder_tpu_torch.train import trainer as trainer_mod
    from crosscoder_tpu_torch.train.state import Optimizer, init_train_state

    t_phase = time.perf_counter()
    B = TRAIN["batch_size"]
    cfg_a = CrossCoderConfig(**TRAIN, fused_encoder="off", num_tokens=B * LEG_A)
    cfg_bt = CrossCoderConfig(**LEG_BT, num_tokens=B * STEPS_BT)
    batches = DeviceBatches(torch, SyntheticActivationSource(cfg_a), LEG_A + 1)
    state0 = init_train_state(cfg_a, Optimizer(cfg_a, lambda s: 0.0), device="cuda")
    save_root = ckpt_dir(root)
    # the single-device trainers, built before the group exists (a Trainer
    # built inside a group takes the group's grid)
    tr_a = trainer_mod.Trainer(cfg_a, Replay(batches.batches, None), device="cuda",
                               state=state0, checkpointer=Checkpointer(save_root))
    tr_bt = trainer_mod.Trainer(cfg_bt, Replay(batches.batches, None), device="cuda")
    store_root = ckpt_dir(root)
    multihost.initialize("cuda:0", store=dist.FileStore(str(store_root / "store"), 1),
                         world_size=1, rank=0)
    log(f"parallel: NCCL group of one rank on {torch.cuda.get_device_name(0)} "
        f"(backend {dist.get_backend()}, {multihost.process_info()})")
    mesh = mesh_lib.make_mesh(1, 1)
    tr_m = trainer_mod.Trainer(cfg_a, Replay(batches.batches, None), device="cuda",
                               state=state0, mesh=mesh)
    t_a, t_m, launches, calls = _mesh_steps(torch, tr_a, tr_m, LEG_A, "leg M")
    for n in ("topk_mask", "sparsify", "scatter_add_rows", "adam_update"):
        if not launches.get(n):
            fail(f"leg M: {n} never launched on the mesh path: {launches}")
    check_o1("leg M", launches, LEG_A)
    aux = [trainer_mod.variant_for_step(cfg_a, i)[1] for i in range(LEG_A)]
    med = {}
    for leg, ts in (("A", t_a), ("M", t_m)):
        for kind, on in (("bare", False), ("aux", True)):
            med[f"{leg} {kind}"] = float(np.median([t for t, a in zip(ts[2:], aux[2:])
                                                    if a == on]))
    per_step = {op: sorted(set(n)) for op, n in calls.items()}
    log(f"parallel: leg M (the mesh trainer, data 1 x model 1, NCCL) {LEG_A} steps bitwise "
        f"leg A's single-device Trainer at every step (loss, metrics, params, moments, aux); "
        f"launches {launches}; NCCL calls a step by op {per_step}")
    log(f"parallel: step ms (CUDA events, in turns, first two excluded, median): leg A bare "
        f"{med['A bare']:.3f} aux {med['A aux']:.3f}; leg M bare {med['M bare']:.3f} aux "
        f"{med['M aux']:.3f}; all leg A {[round(t, 3) for t in t_a]}, leg M "
        f"{[round(t, 3) for t in t_m]}")
    STEP_MS["leg M bare"] = med["M bare"]
    # save under the group (the gathered path), restore by agreement into a
    # fresh mesh trainer and into the single-device one
    ck = Checkpointer(save_root)
    tr_m.checkpointer = ck
    t0 = time.perf_counter()
    tr_m.save()
    t_save = time.perf_counter() - t0
    tr_r = trainer_mod.Trainer(cfg_a, Replay(batches.batches, None), device="cuda", mesh=mesh,
                               checkpointer=Checkpointer(save_root))
    t0 = time.perf_counter()
    meta = tr_r.restore()
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    ok, what = state_bits_equal(torch, tr_r.state, tr_m.state)
    if not ok or meta["step"] != LEG_A:
        fail(f"parallel: the agreed restore differs from the saved mesh state in {what}")
    tr_a.restore()
    ok, what = state_bits_equal(torch, tr_a.state, tr_m.state)
    if not ok:
        fail(f"parallel: the mesh save restored into the single-device Trainer differs in {what}")
    tr_r.buffer.i = tr_a.buffer.i = LEG_A
    _mesh_steps(torch, tr_a, tr_r, 1, "leg M restored")
    log(f"parallel: gathered save {t_save:.2f} s, agreed restore {t_restore:.2f} s; the "
        f"restored state bitwise the saved one in the mesh Trainer and in the single-device "
        f"Trainer, and one more step from each bitwise")
    shutil.rmtree(save_root, ignore_errors=True)
    row_k11, exchange = check_exchange(torch, np, mesh, tr_m.state, cfg_a, batches.batches[0])
    del tr_a, tr_r, tr_m
    # BatchTopK through the mesh: K9 selects the threshold of the grid
    tr_btm = trainer_mod.Trainer(cfg_bt, Replay(batches.batches, None), device="cuda",
                                 mesh=mesh)
    tr_btm.state = mesh_lib.shard_state(mesh, tr_bt.state)
    _, _, bt_launches, bt_calls = _mesh_steps(torch, tr_bt, tr_btm, STEPS_BT, "leg M BatchTopK")
    for n in ("batchtopk_select", "batchtopk_emit", "adam_update"):
        if not bt_launches.get(n):
            fail(f"leg M BatchTopK: {n} never launched on the mesh path: {bt_launches}")
    log(f"parallel: leg M BatchTopK {STEPS_BT} steps bitwise the single-device run; launches "
        f"{bt_launches}; NCCL calls a step by op "
        f"{ {op: sorted(set(n)) for op, n in bt_calls.items()} }")
    del tr_bt, tr_btm, batches
    multihost.shutdown()
    shutil.rmtree(store_root, ignore_errors=True)
    cpu_rehearsal(torch, np, root)
    log(f"parallel phase {time.perf_counter() - t_phase:.1f} s")
    return {"M": launches, "M BatchTopK": bt_launches}, row_k11, exchange


# ---------------------------------------------------------------------------
# phase 12: the parallel harvest at world size 1 (one card), and the ring's
# fold over 8 blocks in one process

# leg RA at Gemma-2-2B's attention shape: 8 query heads on 4 KV heads of
# 256, softcap 50, window 4096 (so an 8192-token row has both masks live),
# 8 blocks of 1024; held to K1's bars
RA = dict(B=1, S=8192, blocks=8, H=8, KV=4, hd=256, softcap=50.0, window=4096,
          scale=256.0 ** -0.5)
RA_TOL = {"fp32": 1e-5, "bf16": 2e-2}
# legs SP and TP: a [4, 1024] chunk of phase 7's corpus; TP with logits on 2
# rows (its unembedding's logits are [2, 1024, 256000] f32)
SP_ROWS, TP_ROWS = 4, 2
# leg SP's second bar: its error against an f32 forward of the same models
# at most this multiple of the dense harvest's, in norm and at the worst
# position
SP_F32_RATIO = 1.1
# leg MS: phase 7's harvest config, TopK k=32 with the sparse backward, 8
# serves and 6 steps on each store; leg SS: leg A's config with
# shard_sources, 4 steps
MS = dict(HARVEST, activation="topk", sparse_bwd="on", fused_encoder="off", aux_k=0,
          buffer_device="hbm")
MS_SERVES, MS_STEPS, SS_STEPS = 8, 6, 4


def ring_fold(torch, ra, q, k, v, is_local):
    """Each block's output by folding the blocks it would receive, in ring
    order (its own first), with ``ring_attention.fold_block``; the whole
    ``[B, S, H*hd]`` output and the ms of the last block's 8 folds and of
    all 64 (CUDA events)."""
    S, n = q.shape[1], RA["blocks"]
    Sb = S // n
    outs = []
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    for r in range(n):
        if r == n - 1:
            ev[2].record()
        qb = q[:, r * Sb:(r + 1) * Sb]
        qg = ra.scaled_queries(qb, RA["KV"], RA["scale"])
        q_pos = r * Sb + torch.arange(Sb, device=q.device)
        m, l, o = ra.init_state(q.shape[0], Sb, RA["KV"], RA["H"] // RA["KV"], RA["hd"],
                                q.device)
        for step in range(n):
            owner = (r - step) % n
            blk = slice(owner * Sb, (owner + 1) * Sb)
            k_pos = owner * Sb + torch.arange(Sb, device=q.device)
            m, l, o = ra.fold_block(m, l, o, qg, q_pos, k[:, blk], v[:, blk], k_pos,
                                    softcap=RA["softcap"], sliding_window=RA["window"],
                                    is_local=is_local)
        outs.append(ra.finish(l, o, q.dtype))
    ev[3].record()
    ev[1].record()
    torch.cuda.synchronize()
    out = torch.cat(outs, dim=1).reshape(q.shape[0], S, -1)
    return out, ev[2].elapsed_time(ev[3]), ev[0].elapsed_time(ev[1])


def ring_leg(torch):
    """Leg RA: the ring's fold over 8 blocks against the dense attention
    over the whole row, global and local layers, f32 and bf16, and one
    bf16 case with sharp logits (q x 30, v / 4) so the cap shows."""
    from crosscoder_tpu_torch.ops import paged_attention as pa
    from crosscoder_tpu_torch.parallel import ring_attention as ra

    gen = torch.Generator(device="cuda").manual_seed(12)
    shape = (RA["B"], RA["S"])
    base = [torch.randn((*shape, n, RA["hd"]), generator=gen, device="cuda")
            for n in (RA["H"], RA["KV"], RA["KV"])]
    res = []
    cases = [(dt, loc, False) for dt in ("fp32", "bf16") for loc in (False, True)]
    cases.append(("bf16", True, True))
    ring_fold(torch, ra, *base, False)          # warm-up: the first einsums' set-up
    for dt, is_local, sharp in cases:
        dtype = torch.float32 if dt == "fp32" else torch.bfloat16
        q, k, v = (t.to(dtype) for t in base)
        if sharp:
            q, v = (q.float() * 30).to(dtype), (v.float() / 4).to(dtype)
        got, ms8, ms64 = ring_fold(torch, ra, q, k, v, is_local)
        dense_ms = time_ms(lambda: pa.ragged_attention_reference(
            q, k, v, None, scale=RA["scale"], softcap=RA["softcap"], window=RA["window"],
            is_local=is_local), 2)
        want = pa.ragged_attention_reference(q, k, v, None, scale=RA["scale"],
                                             softcap=RA["softcap"], window=RA["window"],
                                             is_local=is_local)
        err, rel = _k1_err(got, want, [RA["S"]] * RA["B"], RA["H"])
        tol = RA_TOL[dt]
        label = (f"{dt} {'local' if is_local else 'global'}{' sharp' if sharp else ''}")
        if not (err <= tol and (dt == "fp32" or rel <= tol)):
            fail(f"ring leg RA {label}: max |ring - dense| {err:.3e}, row-relative {rel:.3e} "
                 f"over the bar {tol}")
        res.append(f"{label}: err {err:.3e} rel {rel:.3e}, 8 folds {ms8:.3f} ms, 64 folds "
                   f"{ms64:.3f} ms, dense {dense_ms:.3f} ms")
    log(f"parallel harvest: leg RA, the ring fold over {RA['blocks']} blocks of "
        f"{RA['S'] // RA['blocks']} (B {RA['B']}, S {RA['S']}, {RA['H']} heads on {RA['KV']} "
        f"KV of {RA['hd']}, softcap {RA['softcap']}, window {RA['window']}) against the dense "
        f"attention over the row (CUDA events): " + "; ".join(res))


def _rel_errs(got, want):
    """Per source: the relative error in norm (phase 9's harvest measure)
    and max |got - want| over max |want|."""
    g, w = got.float(), want.float()
    out = []
    for s in range(g.shape[2]):
        d = g[:, :, s] - w[:, :, s]
        out.append((float(d.norm() / w[:, :, s].norm()),
                    float(d.abs().max() / w[:, :, s].abs().max())))
    return out


def _pos_errs(got, want):
    """Per source: the largest relative error in norm of one position (the
    norm over ``d_model``), which a fault confined to a few positions
    cannot hide as the norm over the whole chunk does."""
    g, w = got.float(), want.float()
    e = (g - w).norm(dim=-1) / w.norm(dim=-1)
    return [float(e[:, :, s].max()) for s in range(e.shape[2])]


def _f32_params(torch, params):
    return {k: (_f32_params(torch, v) if isinstance(v, dict) else v.float())
            for k, v in params.items()}


def _counted(torch, counters, acc, fn):
    """``fn()`` with every launch counter set to 0 just before and read
    just after, added to ``acc``."""
    reset_counters(counters)
    out = fn()
    torch.cuda.synchronize()
    for n, c in counters.items():
        if c.launches:
            acc[n] = acc.get(n, 0) + c.launches
    return out


def device_leg(torch, lm_cfg, params, tokens, quant):
    """Leg MS's reference for one store format, built before the group is
    joined: the device store make_buffer picks on one rank and a
    single-device Trainer on it, from a fresh state."""
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.data import buffer as bufmod
    from crosscoder_tpu_torch.train import trainer as trainer_mod
    from crosscoder_tpu_torch.train.state import Optimizer, init_train_state

    cfg = CrossCoderConfig(**MS, quant_buffer=quant, num_tokens=MS["batch_size"] * MS_STEPS)
    t0 = time.perf_counter()
    bd = bufmod.make_buffer(cfg, lm_cfg, params, tokens, device="cuda")
    torch.cuda.synchronize()
    fill = time.perf_counter() - t0
    if type(bd).__name__ != ("QuantPairedActivationBuffer" if quant else "PairedActivationBuffer"):
        fail(f"leg MS: make_buffer on one rank picked {type(bd).__name__}")
    state0 = init_train_state(cfg, Optimizer(cfg, lambda s: 0.0), device="cuda")
    tr_d = trainer_mod.Trainer(cfg, bd, device="cuda", state=state0)
    if tr_d.mesh is not None:
        fail("leg MS: the reference Trainer took a grid")
    return dict(cfg=cfg, bd=bd, tr_d=tr_d, state0=state0, fill_dev_s=fill)


def store_leg(torch, np, mesh, lm_cfg, params, tokens, ref):
    """Leg MS for one store format: the mesh-sharded store on the one-rank
    data group from the tokens of the reference device store, 8 serves
    bitwise its serves, then a mesh Trainer on the mesh store in turns with
    the reference's single-device Trainer, 6 steps bitwise. Returns the
    mesh path's launches (its fill, serves and steps) and times."""
    from crosscoder_tpu_torch.data import buffer as bufmod
    from crosscoder_tpu_torch.train import trainer as trainer_mod

    cfg, bd = ref["cfg"], ref["bd"]
    quant = cfg.quant_buffer
    label = f"leg MS {'int8' if quant else 'bf16'}"
    cls = bufmod.QuantMeshPairedActivationBuffer if quant else bufmod.MeshPairedActivationBuffer
    counters = launch_counters()
    acc: dict = {}
    t0 = time.perf_counter()
    bm = _counted(torch, counters, acc, lambda: cls(cfg, lm_cfg, params, tokens, device="cuda",
                                                    mesh=mesh))
    fill_m = time.perf_counter() - t0
    if not np.array_equal(bm.normalisation_factor, bd.normalisation_factor):
        fail(f"{label}: the mesh store's norm factors {bm.normalisation_factor} differ from "
             f"the device store's {bd.normalisation_factor}")
    for i in range(MS_SERVES):
        a = _counted(torch, counters, acc, bm.next_raw)
        b = bd.next_raw()
        if not torch.equal(a.view(torch.int16), b.view(torch.int16)):
            fail(f"{label}: serve {i} of the mesh store differs from the device store's")
    tr_m = trainer_mod.Trainer(cfg, bm, device="cuda", state=ref["state0"], mesh=mesh)
    _, t_m, launches, _ = _mesh_steps(torch, ref["tr_d"], tr_m, MS_STEPS, label)
    for n, c in launches.items():
        acc[n] = acc.get(n, 0) + c
    check_o1(label, launches, MS_STEPS)
    nbytes = bm.store_nbytes()
    del tr_m, bm
    return acc, dict(fill_mesh_s=fill_m, fill_dev_s=ref["fill_dev_s"], step_ms=t_m,
                     nbytes=nbytes)


def parallel_harvest(torch, np, root):
    """Phase 12: the parallel harvest on an NCCL group of one rank: leg RA
    (the ring's fold over 8 blocks, no group), leg SP (the sequence-parallel
    harvest), leg TP (the tensor-parallel LM, bitwise), leg MS (the
    mesh-sharded stores, bf16 and int8, bitwise the device stores, and
    TopK training on their rows) and leg SS (shard_sources, bitwise).
    Returns the launches of the MS and SS paths."""
    import torch.distributed as dist

    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
    from crosscoder_tpu_torch.models import lm
    from crosscoder_tpu_torch.parallel import collectives as coll
    from crosscoder_tpu_torch.parallel import mesh as mesh_lib
    from crosscoder_tpu_torch.parallel import multihost
    from crosscoder_tpu_torch.train import trainer as trainer_mod
    from crosscoder_tpu_torch.train.state import Optimizer, init_train_state

    t_phase = time.perf_counter()
    ring_leg(torch)
    lm_cfg = lm.LMConfig.gemma2_2b()
    params = [lm.init_params(lm_cfg, seed=s, device="cuda") for s in (1, 2)]
    tokens = harvest_tokens(np, 256, HARVEST["seq_len"], lm_cfg.vocab_size, 6)
    # the single-device references, built before the group exists (a
    # Trainer built inside a group takes the group's grid)
    refs = {quant: device_leg(torch, lm_cfg, params, tokens, quant) for quant in (False, True)}
    B = TRAIN["batch_size"]
    cfg_s = CrossCoderConfig(**TRAIN, fused_encoder="off", num_tokens=B * SS_STEPS)
    batches = DeviceBatches(torch, SyntheticActivationSource(cfg_s), SS_STEPS + 1)
    state_s = init_train_state(cfg_s, Optimizer(cfg_s, lambda s: 0.0), device="cuda")
    tr_s = trainer_mod.Trainer(cfg_s, Replay(batches.batches, None), device="cuda",
                               state=state_s)
    store_root = ckpt_dir(root)
    multihost.initialize("cuda:0", store=dist.FileStore(str(store_root / "store"), 1),
                         world_size=1, rank=0)
    mesh = mesh_lib.make_mesh(1, 1)
    hook = (HARVEST["hook_point"],)

    # leg SP: the sequence split over the one-rank data group
    tok = torch.as_tensor(tokens[:SP_ROWS], device="cuda")
    coll.reset_counts()
    sp = lm.run_with_cache_multi_seq_parallel(params, tok, lm_cfg, hook, mesh)
    sp_calls = dict(coll.calls)
    dense = lm.run_with_cache_multi(params, tok, lm_cfg, hook)
    errs = _rel_errs(sp, dense)
    if sp.shape != dense.shape or not max(e[0] for e in errs) <= HARVEST_REL_TOL:
        fail(f"leg SP: the sequence-parallel harvest {tuple(sp.shape)} differs from the dense "
             f"one {tuple(dense.shape)}: relative error per source (in norm, max over max) "
             f"{errs}, bar {HARVEST_REL_TOL} in norm")
    # both bf16 harvests against the same forward in f32
    ref = lm.run_with_cache_multi([_f32_params(torch, p) for p in params], tok,
                                  dataclasses.replace(lm_cfg, dtype="fp32"), hook)
    e32 = {"seq-parallel": _rel_errs(sp, ref), "dense": _rel_errs(dense, ref)}
    p32 = {"seq-parallel": _pos_errs(sp, ref), "dense": _pos_errs(dense, ref)}
    del ref
    # the ring no further from the f32 forward than the dense harvest, in
    # norm and at its worst position
    for what, e in (("in norm", [(a[0], b[0]) for a, b in zip(e32["seq-parallel"],
                                                             e32["dense"])]),
                    ("at the worst position", list(zip(p32["seq-parallel"], p32["dense"])))):
        if not all(a <= SP_F32_RATIO * b for a, b in e):
            fail(f"leg SP: against the f32 forward, {what}, the sequence-parallel harvest's "
                 f"error per source exceeds {SP_F32_RATIO}x the dense harvest's: {e}")
    sp_ms = time_ms(lambda: lm.run_with_cache_multi_seq_parallel(params, tok, lm_cfg, hook,
                                                                 mesh), 2)
    dense_ms = time_ms(lambda: lm.run_with_cache_multi(params, tok, lm_cfg, hook), 2)
    fmt = lambda es: [f"{a:.3e} / {b:.3e}" for a, b in es]   # noqa: E731
    log(f"parallel harvest: leg SP, run_with_cache_multi_seq_parallel of both models on "
        f"[{SP_ROWS}, {HARVEST['seq_len']}] at {hook[0]} over the one-rank data group "
        f"(collectives {sp_calls}) against run_with_cache_multi: relative error per source, "
        f"in norm / max over max, {fmt(errs)} (bar {HARVEST_REL_TOL} in norm, phase 9's "
        f"harvest measure); against the f32 forward: seq-parallel {fmt(e32['seq-parallel'])}, "
        f"dense {fmt(e32['dense'])}; at the worst position, seq-parallel "
        f"{[f'{a:.3e}' for a in p32['seq-parallel']]}, dense "
        f"{[f'{a:.3e}' for a in p32['dense']]} (bar: seq-parallel <= {SP_F32_RATIO}x dense, "
        f"both measures); {sp_ms:.3f} ms against {dense_ms:.3f} ms (CUDA events)")
    del sp, dense

    # leg TP: the tensor-parallel LM over the one-rank model group, bitwise
    tp = lm.shard_params_tp(params[0], mesh, lm_cfg)
    tok2 = torch.as_tensor(tokens[:TP_ROWS], device="cuda")
    with torch.no_grad():
        coll.reset_counts()
        lt, ct = lm.forward(tp, tok2, lm_cfg, capture=hook)
        tp_calls = dict(coll.calls)
        lw, cw = lm.forward(params[0], tok2, lm_cfg, capture=hook)
    if not (torch.equal(lt.view(torch.int32), lw.view(torch.int32))
            and torch.equal(ct[hook[0]].view(torch.int16), cw[hook[0]].view(torch.int16))):
        fail("leg TP: the tensor-parallel forward at one rank differs from the whole forward")
    del lt, ct, lw, cw
    with torch.no_grad():
        tp_ms = time_ms(lambda: lm.forward(tp, tok2, lm_cfg, capture=hook), 2)
        whole_ms = time_ms(lambda: lm.forward(params[0], tok2, lm_cfg, capture=hook), 2)
    log(f"parallel harvest: leg TP, the tensor-parallel forward (logits [{TP_ROWS}, "
        f"{HARVEST['seq_len']}, {lm_cfg.vocab_size}] f32 and {hook[0]}) over the one-rank "
        f"model group bitwise the whole forward; collectives {tp_calls}; {tp_ms:.3f} ms "
        f"against {whole_ms:.3f} ms (CUDA events)")
    del tp

    # leg MS: the mesh-sharded stores
    launches: dict = {}
    ms_info = {}
    for quant in (False, True):
        acc, info = store_leg(torch, np, mesh, lm_cfg, params, tokens, refs.pop(quant))
        ms_info["int8" if quant else "bf16"] = info
        for n, c in acc.items():
            launches[n] = launches.get(n, 0) + c
    if not launches.get("quantize_rows"):
        fail(f"leg MS: K11 never launched on the int8 mesh store's refill: {launches}")
    for n in ("topk_mask", "sparsify", "scatter_add_rows", "adam_update"):
        if not launches.get(n):
            fail(f"leg MS: {n} never launched on the mesh store's steps: {launches}")
    log(f"parallel harvest: leg MS, MeshPairedActivationBuffer and "
        f"QuantMeshPairedActivationBuffer on the one-rank data group, {MS_SERVES} serves "
        f"each bitwise the device store's from the same tokens, then {MS_STEPS} TopK steps "
        f"(sparse backward) each bitwise the single-device Trainer on the device store; "
        f"launches (fills, serves, steps) {launches}; "
        + "; ".join(f"{k}: fill {v['fill_mesh_s']:.2f} s (device store {v['fill_dev_s']:.2f} "
                    f"s), store {v['nbytes'] / 1e6:.1f} MB, mesh step ms "
                    f"{[round(t, 2) for t in v['step_ms']]}" for k, v in ms_info.items()))
    del params

    # leg SS: shard_sources on a grid of one
    tr_ss = trainer_mod.Trainer(cfg_s.replace(shard_sources=True),
                                Replay(batches.batches, None), device="cuda", state=state_s,
                                mesh=mesh)
    _, t_ss, ss_launches, ss_calls = _mesh_steps(torch, tr_s, tr_ss, SS_STEPS, "leg SS")
    check_o1("leg SS", ss_launches, SS_STEPS)
    for n, c in ss_launches.items():
        launches[n] = launches.get(n, 0) + c
    log(f"parallel harvest: leg SS, shard_sources on a grid of one (W_enc split on its "
        f"source axis, the pre-activations summed over model), {SS_STEPS} steps each bitwise "
        f"the single-device Trainer; launches {ss_launches}; NCCL calls a step by op "
        f"{ {op: sorted(set(n)) for op, n in ss_calls.items()} }; step ms "
        f"{[round(t, 2) for t in t_ss]}")
    del tr_s, tr_ss, batches
    multihost.shutdown()
    shutil.rmtree(store_root, ignore_errors=True)
    log(f"parallel harvest phase {time.perf_counter() - t_phase:.1f} s (one card: NCCL at "
        f"world size 1, every collective an identity, no ring hop)")
    return launches


# ---------------------------------------------------------------------------
# phase 13: the mesh's last refusals on one card (an NCCL group of one rank)

# leg OV: phase 12's leg MS config with the refill overlap, fed by
# tensor-parallel params; 8 serves and 6 steps against the overlap off
OV_SERVES, OV_STEPS = 8, 6
# leg PT: the paged harvest of a [4, 1024] chunk of phase 7's corpus, page 64
PT_ROWS, PT_PAGE = 4, 64
# leg FM: each knob at the train phase's width for 4 steps, AuxK off so that
# every step takes the knob's path; the guard at dict 2^12 (its saves and its
# agreed restore are the leg's cost), a log every step, serve 1 all NaN
FM_STEPS = 4
FM_NAN_SERVE = 1
_FM_BASE = dict(TRAIN, aux_k=0, aux_every=1)
FM = {
    "K2": dict(_FM_BASE, fused_encoder="on"),
    "K3": dict(_FM_BASE, fused_encoder="on", quant_encoder=True, quant_block=256),
    "K4": dict(LEG_BT, fused_encoder="on"),
    "D": dict(LEG_D),
    "R": dict(_FM_BASE, fused_encoder="off", resample_every=2, resample_dead_steps=1),
    "G": dict(_FM_BASE, fused_encoder="off", dict_size=2 ** 12, guard_loss=True, log_every=1,
              save_every=100, keep_saves=3),
}


def overlap_leg(torch, np, mesh, lm_cfg, tp_params, tokens, quant):
    """Leg OV for one store format: the mesh store over ``tp_params`` with
    the overlap on and off, 8 serves bitwise, then a mesh Trainer on each
    for 6 steps in turns, bitwise. Returns the overlap-on path's launches
    (its fill, serves and steps) and its times."""
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.data import buffer as bufmod
    from crosscoder_tpu_torch.train import trainer as trainer_mod
    from crosscoder_tpu_torch.train.state import Optimizer, init_train_state

    label = f"leg OV {'int8' if quant else 'bf16'}"
    cls = bufmod.QuantMeshPairedActivationBuffer if quant else bufmod.MeshPairedActivationBuffer
    counters = launch_counters()
    acc: dict = {}
    stores, fill = {}, {}
    for ov in ("off", "on"):
        cfg = CrossCoderConfig(**MS, quant_buffer=quant, refill_overlap=ov,
                               num_tokens=MS["batch_size"] * OV_STEPS)
        t0 = time.perf_counter()
        if ov == "on":
            stores[ov] = _counted(torch, counters, acc, lambda: cls(
                cfg, lm_cfg, tp_params, tokens, device="cuda", mesh=mesh))
        else:
            stores[ov] = cls(cfg, lm_cfg, tp_params, tokens, device="cuda", mesh=mesh)
        torch.cuda.synchronize()
        fill[ov] = time.perf_counter() - t0
    on, off = stores["on"], stores["off"]
    if on._dispatcher is not None or not on._overlap or on._spare_rows == 0:
        fail(f"{label}: the overlap store started a dispatcher thread or has no spare rows")
    serve_ms = {"on": [], "off": []}
    for i in range(OV_SERVES):
        t0 = time.perf_counter()
        a = _counted(torch, counters, acc, on.next_raw)
        serve_ms["on"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        b = off.next_raw()
        torch.cuda.synchronize()
        serve_ms["off"].append((time.perf_counter() - t0) * 1e3)
        if not torch.equal(a.view(torch.int16), b.view(torch.int16)):
            fail(f"{label}: serve {i} with the overlap on differs from the overlap off")
    if on.state_dict() != off.state_dict():
        fail(f"{label}: the stream states differ: {on.state_dict()} vs {off.state_dict()}")
    cfg = on.cfg
    state0 = init_train_state(cfg, Optimizer(cfg, lambda s: 0.0), device="cuda")
    tr_off = trainer_mod.Trainer(cfg.replace(refill_overlap="off"), off, device="cuda",
                                 state=state0, mesh=mesh)
    tr_on = trainer_mod.Trainer(cfg, on, device="cuda", state=state0, mesh=mesh)
    t_off, t_on, launches, _ = _mesh_steps(torch, tr_off, tr_on, OV_STEPS, label)
    check_o1(label, launches, OV_STEPS)
    for n, c in launches.items():
        acc[n] = acc.get(n, 0) + c
    if quant and not acc.get("quantize_rows"):
        fail(f"{label}: K11 never launched on the int8 store's refill: {acc}")
    info = dict(fill_on=fill["on"], fill_off=fill["off"], serve_on=serve_ms["on"],
                serve_off=serve_ms["off"], step_on=t_on, step_off=t_off,
                spare=on._spare_rows, nbytes=on.store_nbytes())
    on.close()
    off.close()
    return acc, info


def paged_tp_leg(torch, np, mesh, lm_cfg, params, tp_params, tokens):
    """Leg PT: the paged harvest of a [4, 1024] chunk over the
    tensor-parallel params, bitwise the paged harvest over the whole params,
    K1's launches counted on the TP run; both timed. Returns K1's launches."""
    from crosscoder_tpu_torch.data.tokens import valid_lengths
    from crosscoder_tpu_torch.models import lm
    from crosscoder_tpu_torch.ops import paged_attention as pa
    from crosscoder_tpu_torch.parallel import collectives as coll

    chunk = tokens[:PT_ROWS]
    lengths = valid_lengths(chunk)
    hooks = (HARVEST["hook_point"],)
    kw = dict(page_size=PT_PAGE, pad_mode="wrap", out_dtype=torch.bfloat16)
    pa.paged_attention.launches = 0
    pa.paged_attention.by_route.update(dict.fromkeys(pa.paged_attention.by_route, 0))
    coll.reset_counts()
    got = lm.run_with_cache_multi_paged(tp_params, chunk, lengths, lm_cfg, hooks, **kw)
    torch.cuda.synchronize()
    k1 = pa.paged_attention.launches
    routes = dict(pa.paged_attention.by_route)
    calls = dict(coll.calls)
    want = lm.run_with_cache_multi_paged(params, chunk, lengths, lm_cfg, hooks, **kw)
    torch.cuda.synchronize()
    if k1 != K1_PER_CHUNK or routes["tensor_cores"] != k1:
        fail(f"leg PT: K1 launched {k1} times ({routes}) on the TP paged harvest, want "
             f"{K1_PER_CHUNK} on the tensor-core route")
    if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
        fail("leg PT: the paged harvest over TP params differs from the one over whole params")
    tp_ms = time_ms(lambda: lm.run_with_cache_multi_paged(tp_params, chunk, lengths, lm_cfg,
                                                          hooks, **kw), 2)
    whole_ms = time_ms(lambda: lm.run_with_cache_multi_paged(params, chunk, lengths, lm_cfg,
                                                             hooks, **kw), 2)
    log(f"mesh rest: leg PT, run_with_cache_multi_paged of both models over TP params (the "
        f"one-rank model group: {lm_cfg.n_heads} query heads on {lm_cfg.n_kv_heads} KV heads a "
        f"rank) on [{PT_ROWS}, {HARVEST['seq_len']}] (lengths {lengths.tolist()}) bitwise the "
        f"whole params' paged harvest; K1 launches {k1} ({routes}); collectives {calls}; "
        f"{tp_ms:.3f} ms against {whole_ms:.3f} ms (CUDA events)")
    return k1


def _fm_trainers(torch, np, root):
    """Leg FM's single-device Trainers, built before the group exists (a
    Trainer built inside a group takes the group's grid), with their
    configs, start states and sources."""
    from crosscoder_tpu_torch.checkpoint import Checkpointer
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
    from crosscoder_tpu_torch.train import trainer as trainer_mod
    from crosscoder_tpu_torch.train.state import Optimizer, init_train_state

    B = TRAIN["batch_size"]
    batches = DeviceBatches(torch, SyntheticActivationSource(CrossCoderConfig(**TRAIN)),
                            2 * FM_STEPS)
    refs = {}
    for name, kw in FM.items():
        cfg = CrossCoderConfig(**kw, num_tokens=B * FM_STEPS)
        state0 = init_train_state(cfg, Optimizer(cfg, lambda s: 0.0), device="cuda")
        if name == "G":
            dirs = [ckpt_dir(root), ckpt_dir(root)]
            cfg = cfg.replace(checkpoint_dir=str(dirs[0]))
            src = copy.copy(batches)
            tr = trainer_mod.Trainer(cfg, PoisonedBatches(src, FM_NAN_SERVE), device="cuda",
                                     state=state0, checkpointer=Checkpointer(cfg=cfg))
            refs[name] = dict(cfg=cfg, state0=state0, tr=tr, dirs=dirs, batches=batches)
        else:
            tr = trainer_mod.Trainer(cfg, Replay(batches.batches, None), device="cuda",
                                     state=state0)
            refs[name] = dict(cfg=cfg, state0=state0, tr=tr)
    return refs, batches


def _fm_kernel_ms(torch, fek, name, tr, batch):
    """The leg's fused kernel timed on the step's operands (the batch and
    the mesh trainer's encoder in the compute dtype), CUDA events."""
    cfg = tr.cfg
    p = tr.state.params
    x2 = batch.reshape(batch.shape[0], -1).to(torch.bfloat16)
    W2 = p["W_enc"].to(torch.bfloat16).reshape(x2.shape[1], -1)
    b = p["b_enc"].float()
    k = cfg.topk_k
    if name == "K2":
        return {"fused_topk_encode": time_ms(lambda: fek.fused_topk_encode(x2, W2, b, k), 5)}
    if name == "K3":
        return {"fused_topk_encode_q": time_ms(
            lambda: fek.fused_topk_encode_q(x2, W2, b, k, cfg.quant_block), 5)}
    kk = fek.batchtopk_budget(x2.shape[0], W2.shape[1], k)
    kth = fek.fused_batchtopk_select(x2, W2, b, kk)
    lo = int(kth)
    return {"fused_batchtopk_select": time_ms(lambda: fek.fused_batchtopk_select(x2, W2, b, kk),
                                              5),
            "fused_batchtopk_count": time_ms(
                lambda: fek.fused_batchtopk_count(x2, W2, b, lo, 0x7FFF), 5),
            "fused_batchtopk_emit": time_ms(lambda: fek.fused_batchtopk_emit(x2, W2, b, kth), 5)}


def guard_mesh_leg(torch, mesh, ref):
    """Leg FM's guard: the single-device and the mesh Trainer each train
    4 steps under the loss guard over a source whose serve 1 is all NaN;
    each rolls back once, to the first save; the final states, the
    counters and the serves bitwise or equal. Returns the mesh run's
    launches and times."""
    from crosscoder_tpu_torch.checkpoint import Checkpointer
    from crosscoder_tpu_torch.train import trainer as trainer_mod

    tr_s = ref["tr"]
    t0 = time.perf_counter()
    tr_s.train()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    cfg = ref["cfg"].replace(checkpoint_dir=str(ref["dirs"][1]))
    src = PoisonedBatches(copy.copy(ref["batches"]), FM_NAN_SERVE)
    src.inner.i = 0
    ck = Checkpointer(cfg=cfg)
    restores = []
    real_restore = ck.restore

    def timed_restore(*a, **kw):
        t = time.perf_counter()
        out = real_restore(*a, **kw)
        torch.cuda.synchronize()
        restores.append(time.perf_counter() - t)
        return out

    ck.restore = timed_restore
    counters = launch_counters()
    reset_counters(counters)
    tr_m = trainer_mod.Trainer(cfg, src, device="cuda", state=ref["state0"], mesh=mesh,
                               checkpointer=ck)
    t0 = time.perf_counter()
    tr_m.train()
    torch.cuda.synchronize()
    wall_m = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items() if c.launches}
    snap_s, snap_m = tr_s.resilience.snapshot(), tr_m.resilience.snapshot()
    ok, what = state_bits_equal(torch, tr_s.state, tr_m.state)
    if not (ok and snap_s == snap_m and snap_m["resilience/rollbacks"] == 1
            and tr_m.step_counter == tr_s.step_counter == FM_STEPS
            and tr_m.buffer.serves == tr_s.buffer.serves and len(restores) == 1):
        fail(f"leg FM guard: the mesh run (counters {snap_m}, {tr_m.step_counter} steps, "
             f"{tr_m.buffer.serves} serves, {len(restores)} restores) differs from the "
             f"single-device run ({snap_s}, {tr_s.step_counter} steps, {tr_s.buffer.serves} "
             f"serves) or its final state differs in {what}")
    state_bytes = sum(t.numel() * t.element_size() for tree in (
        tr_m.state.params, tr_m.state.opt_state.mu, tr_m.state.opt_state.nu)
        for t in tree.values())
    info = dict(wall_s=wall_s, wall_m=wall_m, restore_s=restores[0], snap=snap_m,
                serves=tr_m.buffer.serves, state_gb=state_bytes / 1e9)
    for d in ref["dirs"]:
        shutil.rmtree(d, ignore_errors=True)
    return launches, info


# leg FM at data 1 x model 2: two gloo ranks sharing the card (this process
# and one more of this script, ``--gloo-rank``), the only grid with a sharded
# dictionary one card can run (NCCL refuses two ranks on one device; gloo
# takes CUDA tensors for the all-reduce and all-gather of these paths:
# scripts/gloo_one_card.py). Each rank's losses and its shard of the params
# against its own single-device run: the decode's partial sums add over
# model in another order and a bf16 near-tie may select another latent,
# which moves that latent's update by up to lr, so the bars are a loss
# within 1e-4 relative and each leaf's shard within 1e-3 relative in norm
FM_GRID_TOL = (1e-4, 1e-3)


def _leaf_rel(torch, a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def fm_grid_rank(torch, rank, port, root):
    """One rank of leg FM at 1 x 2 (gloo): each knob's single-device run
    first (before the group), its losses and this rank's shard of its final
    params kept; then the group, and each knob's mesh run from the same
    start state and batches. Returns per knob the launches, the losses and
    the worst leaf error in norm; fails past :data:`FM_GRID_TOL`."""
    import torch.distributed as dist

    from crosscoder_tpu_torch.checkpoint import Checkpointer
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
    from crosscoder_tpu_torch.parallel import mesh as mesh_lib
    from crosscoder_tpu_torch.train import trainer as trainer_mod
    from crosscoder_tpu_torch.train.state import Optimizer, init_train_state

    B = TRAIN["batch_size"]
    batches = DeviceBatches(torch, SyntheticActivationSource(CrossCoderConfig(**TRAIN)),
                            2 * FM_STEPS)
    mine = mesh_lib.Mesh(data_size=1, model_size=2, data_rank=0, model_rank=rank,
                         data_group=None, model_group=None, world_group=None)

    def run(name, cfg, mesh, ckpt):
        state0 = init_train_state(cfg, Optimizer(cfg, lambda s: 0.0), device="cuda")
        if cfg.guard_loss:
            cfg = cfg.replace(checkpoint_dir=str(ckpt))
            src = PoisonedBatches(copy.copy(batches), FM_NAN_SERVE)
            src.inner.i = 0
            tr = trainer_mod.Trainer(cfg, src, device="cuda", state=state0, mesh=mesh,
                                     checkpointer=Checkpointer(cfg=cfg))
            losses = [float(tr.train()["loss"])]
            extra = {"snap": tr.resilience.snapshot(), "serves": src.serves,
                     "steps": tr.step_counter}
        else:
            tr = trainer_mod.Trainer(cfg, Replay(batches.batches, None), device="cuda",
                                     state=state0, mesh=mesh)
            losses = [float(tr.step()["loss"]) for _ in range(FM_STEPS)]
            extra = {}
        st = tr.state if mesh is not None else mesh_lib.shard_state(mine, tr.state)
        shard = {k: v.detach().float().cpu() for k, v in st.params.items()}
        return losses, shard, extra

    refs = {}
    ref_dir = ckpt_dir(root)
    for name, kw in FM.items():
        cfg = CrossCoderConfig(**kw, num_tokens=B * FM_STEPS)
        refs[name] = run(name, cfg, None, ref_dir)
        torch.cuda.empty_cache()
    shutil.rmtree(ref_dir, ignore_errors=True)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    mesh = mesh_lib.make_mesh(1, 2)
    counters = launch_counters()
    guard_dir = root / "build" / f"chip_smoke_grid_guard_{port}"
    out = {}
    for name, kw in FM.items():
        cfg = CrossCoderConfig(**kw, num_tokens=B * FM_STEPS, model_axis_size=2)
        reset_counters(counters)
        t0 = time.perf_counter()
        losses, shard, extra = run(name, cfg, mesh, guard_dir)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: c.launches for n, c in counters.items() if c.launches}
        if name == "K3":
            launches["by route"] = read_routes()
        r_losses, r_shard, r_extra = refs.pop(name)
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses))
        leaf = {k: _leaf_rel(torch, v, r_shard[k]) for k, v in shard.items()}
        out[name] = dict(losses=losses, ref_losses=r_losses, loss_rel=loss_rel, leaf=leaf,
                         launches=launches, wall=wall, **{f"{k}": v for k, v in extra.items()})
        if extra != r_extra or not (loss_rel <= FM_GRID_TOL[0]
                                    and max(leaf.values()) <= FM_GRID_TOL[1]):
            fail(f"leg FM 1x2 rank {rank} {name}: losses {losses} vs single-device {r_losses} "
                 f"(relative {loss_rel:.3e}), leaf errors in norm {leaf}, guard {extra} vs "
                 f"{r_extra}: past the bars {FM_GRID_TOL}")
        torch.cuda.empty_cache()
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        shutil.rmtree(guard_dir, ignore_errors=True)
    return out


def fm_grid(torch, root):
    """Leg FM at 1 x 2 on one card: this process is rank 0, one more process
    of this script rank 1. Returns both ranks' results."""
    port = _free_port()
    out = Path(tempfile.mkdtemp(prefix="chip_smoke_grid_", dir=root / "build")) / "rank1.json"
    torch.cuda.empty_cache()
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--gloo-rank", "1",
                             str(port), str(out)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    try:
        res0 = fm_grid_rank(torch, 0, port, root)
        text = proc.communicate(timeout=600)[0].decode(errors="replace")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode:
        log(f"leg FM 1x2 rank 1: {text[-3000:]}")
        fail(f"leg FM 1x2: rank 1 exited {proc.returncode}")
    res1 = json.loads(out.read_text())
    shutil.rmtree(out.parent, ignore_errors=True)
    return [res0, res1]


def gloo_rank_worker(rank, port, out):
    """Rank ``rank`` of leg FM at 1 x 2 (``chip_smoke.py --gloo-rank``):
    writes its results as JSON to ``out``."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = Path(__file__).resolve().parent
    res = fm_grid_rank(torch, rank, port, root)
    Path(out).write_text(json.dumps(res))


def mesh_rest(torch, np, root):
    """Phase 13: the mesh's last refusals on an NCCL group of one rank: leg
    PT (the paged harvest over TP params, bitwise the whole params', K1
    counted), leg OV (the mesh stores with the refill overlap over a TP
    harvest, bitwise the overlap off) and leg FM (the mesh trainer's
    knobs, each bitwise the single-device Trainer). Returns each leg's
    launches (K1's on leg PT) and the fused kernels' times at the step's
    operands."""
    import torch.distributed as dist

    from crosscoder_tpu_torch.models import lm
    from crosscoder_tpu_torch.ops import fused_encoder_topk as fek
    from crosscoder_tpu_torch.parallel import collectives as coll
    from crosscoder_tpu_torch.parallel import mesh as mesh_lib
    from crosscoder_tpu_torch.parallel import multihost
    from crosscoder_tpu_torch.train import resample
    from crosscoder_tpu_torch.train import trainer as trainer_mod

    t_phase = time.perf_counter()
    n_src, H = TRAIN["n_models"], TRAIN["dict_size"]
    w_bytes = n_src * TRAIN["d_in"] * H * 2                     # W_enc in the bf16 compute dtype
    log(f"mesh rest: under shard_sources a fused tier (K2, K3, K4) gathers W_enc's source slabs "
        f"over model before its launch: at model m each rank receives (m - 1)/m of the bf16 "
        f"W_enc [{n_src}, {TRAIN['d_in']}, {H}] ({w_bytes / 1e6:.1f} MB) a step, "
        f"{w_bytes / 2 / 1e6:.1f} MB at m = 2 (x needs no gather: every rank holds its rows' "
        f"sources); nothing moves at one rank")
    refs, batches = _fm_trainers(torch, np, root)
    lm_cfg = lm.LMConfig.gemma2_2b()
    params = [lm.init_params(lm_cfg, seed=s, device="cuda") for s in (1, 2)]
    tokens = harvest_tokens(np, 256, HARVEST["seq_len"], lm_cfg.vocab_size, 6)
    store_root = ckpt_dir(root)
    multihost.initialize("cuda:0", store=dist.FileStore(str(store_root / "store"), 1),
                         world_size=1, rank=0)
    mesh = mesh_lib.make_mesh(1, 1)
    tp_params = [lm.shard_params_tp(p, mesh, lm_cfg) for p in params]
    legs: dict = {}

    legs["PT"] = {"paged_attention": paged_tp_leg(torch, np, mesh, lm_cfg, params, tp_params,
                                                  tokens)}
    del params
    ov_info = {}
    for quant in (False, True):
        acc, info = overlap_leg(torch, np, mesh, lm_cfg, tp_params, tokens, quant)
        legs[f"OV {'int8' if quant else 'bf16'}"] = acc
        ov_info["int8" if quant else "bf16"] = info
    for n in ("topk_mask", "sparsify", "scatter_add_rows", "adam_update"):
        if not legs["OV bf16"].get(n):
            fail(f"leg OV: {n} never launched on the overlap store's steps: {legs['OV bf16']}")
    log("mesh rest: leg OV, the mesh stores over a TP harvest with refill_overlap='on' (no "
        f"dispatcher thread; the credit pumped inline), {OV_SERVES} serves and {OV_STEPS} "
        f"steps each bitwise the same store with the overlap off; launches "
        f"{ {k: legs[k] for k in ('OV bf16', 'OV int8')} }; "
        + "; ".join(f"{k}: fill on {v['fill_on']:.2f} s / off {v['fill_off']:.2f} s, spare "
                    f"rows {v['spare']}, store {v['nbytes'] / 1e6:.1f} MB, serve ms on "
                    f"{[round(t, 2) for t in v['serve_on']]} off "
                    f"{[round(t, 2) for t in v['serve_off']]}, step ms on "
                    f"{[round(t, 2) for t in v['step_on']]} off "
                    f"{[round(t, 2) for t in v['step_off']]}" for k, v in ov_info.items()))
    del tp_params

    kernel_ms: dict = {}
    need = {"K2": ("fused_topk_encode", "scatter_add_rows"),
            "K3": ("fused_topk_encode_q", "quantize_rows", "scatter_add_rows"),
            "K4": ("fused_batchtopk_select", "fused_batchtopk_count", "fused_batchtopk_emit"),
            "D": ("topk_mask", "sparsify"), "R": ("topk_mask", "sparsify")}
    for name, want in need.items():
        ref = refs.pop(name)
        coll.reset_counts()
        tr_m = trainer_mod.Trainer(ref["cfg"], Replay(batches.batches, None), device="cuda",
                                   state=ref["state0"], mesh=mesh)
        revived = []
        if name == "R":
            fn = resample.make_resample_fn(ref["cfg"], mesh)

            def counted(*a, fn=fn):
                new, n = fn(*a)
                revived.append(int(n))
                return new, n

            tr_m._resample_fn = counted
        routes: dict = {}
        t_s, t_m, launches, calls = _mesh_steps(torch, ref["tr"], tr_m, FM_STEPS,
                                                f"leg FM {name}", routes)
        check_o1(f"leg FM {name}", launches, FM_STEPS)
        for n in want:
            if not launches.get(n):
                fail(f"leg FM {name}: {n} never launched on the mesh path: {launches}")
        if name == "K3":
            launches["by route"] = routes
        legs[f"FM {name}"] = launches
        extra = ""
        if name in ("K2", "K3", "K4"):
            ms = _fm_kernel_ms(torch, fek, name, tr_m, batches.batches[0])
            kernel_ms.update(ms)
            extra = "; at the step's operands " + ", ".join(
                f"{n} {t:.4f} ms" for n, t in ms.items())
        if name == "R":
            if not (revived and all(n > 0 for n in revived)):
                fail(f"leg FM R: no resample in the window revived a latent: {revived}")
            extra = f"; the resample at step 2 revived {revived} latents (the grid's edit)"
        log(f"mesh rest: leg FM {name}, {FM_STEPS} steps of the mesh trainer bitwise the "
            f"single-device Trainer at every step; launches {launches}; NCCL calls a step by "
            f"op { {op: sorted(set(c)) for op, c in calls.items()} }; step ms single "
            f"{[round(t, 2) for t in t_s]} mesh {[round(t, 2) for t in t_m]}{extra}")
        del tr_m, ref
    launches, g = guard_mesh_leg(torch, mesh, refs.pop("G"))
    check_o1("leg FM guard", launches, FM_STEPS + 1 + FM_NAN_SERVE)
    legs["FM G"] = launches
    log(f"mesh rest: leg FM guard (dict {FM['G']['dict_size']}, {g['state_gb']:.2f} GB of "
        f"state), serve "
        f"{FM_NAN_SERVE} all NaN: counters {g['snap']}, {g['serves']} serves, final state "
        f"bitwise the single-device run's; wall {g['wall_m']:.1f} s on the mesh ({g['wall_s']:.1f} "
        f"s single-device) with the first save, the agreed restore ({g['restore_s']:.2f} s) and "
        f"the last save; launches {launches}")
    del batches
    multihost.shutdown()
    shutil.rmtree(store_root, ignore_errors=True)
    t_grid = time.perf_counter()
    grid = fm_grid(torch, root)
    for r, res in enumerate(grid):
        for name, v in res.items():
            legs[f"FM 1x2 {name} rank {r}"] = v["launches"]
        log(f"mesh rest: leg FM at data 1 x model 2, rank {r} of two gloo ranks sharing the "
            f"card (a dictionary of 2^15 split in halves), each knob against the rank's own "
            f"single-device run: " + "; ".join(
                f"{name} losses {[round(x, 6) for x in v['losses']]} vs "
                f"{[round(x, 6) for x in v['ref_losses']]} (relative {v['loss_rel']:.2e}), "
                f"worst leaf in norm {max(v['leaf'].values()):.2e}, {v['wall']:.1f} s, launches "
                f"{v['launches']}" + (f", guard {v['snap']} serves {v['serves']}"
                                      if "snap" in v else "") for name, v in res.items()))
    for name in ("fused_topk_encode", "fused_topk_encode_q", "fused_batchtopk_select",
                 "fused_batchtopk_count", "fused_batchtopk_emit"):
        if not all(any(v["launches"].get(name) for v in res.values()) for res in grid):
            fail(f"leg FM 1x2: {name} never launched on a rank's sharded dictionary")
    log(f"mesh rest: leg FM 1 x 2 took {time.perf_counter() - t_grid:.1f} s; phase "
        f"{time.perf_counter() - t_phase:.1f} s (NCCL at world size 1, then gloo at 2 on one "
        f"card)")
    return legs, kernel_ms


# ---------------------------------------------------------------------------
# phase 14: the fleet (N crosscoders trained off one served stream)


@contextlib.contextmanager
def no_plain_versions(tp, sg, fek):
    """Every kernel's plain version raises inside the block: a wrapper that
    fell back to one, or a tensor that reached the CPU, fails the phase."""
    from crosscoder_tpu_torch.ops import adam

    names = [(adam, "adam_update_plain"), (tp, "topk_plain"), (tp, "topk_chunked_plain"),
             (tp, "sparsify_plain"), (tp, "batchtopk_select_plain"),
             (tp, "batchtopk_emit_plain"), (sg, "scatter_add_rows_plain"),
             (sg, "work_list_plain"), (fek, "fused_topk_encode_plain"),
             (fek, "fused_topk_encode_q_plain"), (fek, "fused_batchtopk_select_plain"),
             (fek, "fused_batchtopk_count_plain"), (fek, "fused_batchtopk_emit_plain")]
    saved = [(m, n, getattr(m, n)) for m, n in names]

    def refuse(name):
        def plain(*a, **k):
            fail(f"phase 14: the fleet's path ran the plain version {name}")
        return plain

    for m, n in names:
        setattr(m, n, refuse(n))
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def _fleet_o1(torch, np, fl, batch, scale):
    """The cohort's O1 at its final state: each member's gradients on the
    last batch, scaled to the norms ``O1_NORMS`` (one tenant clipped),
    stacked; one cohort launch bitwise its plain version and the three solo
    launches, timed beside the plain update, the solo launches, PyTorch's
    fused Adam over the same leaves and the bound. Returns the cohort row
    (launches filled in by the caller)."""
    from crosscoder_tpu_torch.models import stacked
    from crosscoder_tpu_torch.ops import adam
    from crosscoder_tpu_torch.train import trainer as trainer_mod
    from crosscoder_tpu_torch.train.state import Optimizer

    co = fl._cohorts[0]
    st, N = co.state, len(co.members)
    bodies = fl._cohort_fns(co, trainer_mod.variant_for_step(co.cfg, co.members[0].steps_done))
    grads = {k: torch.empty_like(v) for k, v in st.params.items()}
    for i, body in enumerate(bodies):
        g = body.loss_and_grads(stacked.unstack_state(st, i), batch, scale)[2]
        n0 = float(Optimizer.global_norm(g))
        for k, t in g.items():
            grads[k][i].copy_((t.float() * (O1_NORMS[i] / n0)).to(t.dtype))
        del g
    norms = torch.stack([Optimizer.global_norm({k: t[i] for k, t in grads.items()})
                         for i in range(N)])
    lr = float(co.opt.lr_fn(st.opt_state.count))
    t = st.opt_state.count + 1
    kw = dict(max_norm=1.0, b1=0.9, b2=0.999, eps=1e-8,
              bc1=float(np.float32(1) - np.float32(0.9) ** np.float32(t)),
              bc2=float(np.float32(1) - np.float32(0.999) ** np.float32(t)),
              step_size=float(-np.float32(lr)))
    p, m, v = st.params, st.opt_state.mu, st.opt_state.nu
    before = (adam.adam_update.launches, adam.adam_update.cohort_launches)

    def bits(x):
        return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)

    out_k = tuple({k: torch.empty_like(x) for k, x in p.items()} for _ in range(3))
    out_p = tuple({k: torch.empty_like(x) for k, x in p.items()} for _ in range(3))
    adam.adam_update(p, grads, m, v, norms, out=out_k, **kw)
    adam.adam_update_plain(p, grads, m, v, norms, out=out_p, **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(bits(a[k]), bits(b[k])) for a, b in zip(out_k, out_p) for k in p)
    err = max(float((a[k].float() - b[k].float()).abs().max()) for a, b in zip(out_k, out_p)
              for k in p)
    plain_ms = time_ms(lambda: adam.adam_update_plain(p, grads, m, v, norms, out=out_p, **kw), 2)
    del out_p
    clipped = [float(x) >= 1.0 for x in norms]
    log(f"fleet: O1 over the cohort's {N} stacked tenants at norms "
        f"{[round(float(x), 4) for x in norms]} (clipped {clipped}): "
        f"{'bitwise equal' if same else 'DIFFERENT'} params and moments to the plain update "
        f"(max_abs_err {err:.3e})")
    if not same or clipped.count(True) not in range(1, N):
        fail("phase 14: the cohort's O1 differs from its plain version, or the check's norms "
             "did not straddle the clip")
    solo_ms = []
    for i in range(N):
        sl = [{k: x[i] for k, x in d.items()} for d in (p, grads, m, v)]
        out_s = tuple({k: torch.empty_like(x) for k, x in sl[0].items()} for _ in range(3))
        adam.adam_update(*sl, norms[i], out=out_s, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(bits(a[k][i]), bits(b[k])) for a, b in zip(out_k, out_s)
                   for k in p):
            fail(f"phase 14: the cohort's O1 differs from tenant {i}'s solo launch "
                 f"({'clipped' if clipped[i] else 'not clipped'})")
        solo_ms.append(time_ms(lambda: adam.adam_update(*sl, norms[i], out=out_s, **kw), 10))
        del out_s
    log(f"fleet: the cohort's O1 bitwise each tenant's solo launch, clipped and not")
    ms = time_ms(lambda: adam.adam_update(p, grads, m, v, norms, out=out_k, **kw), 10)
    ms_q = time_ms(lambda: adam.adam_update(p, grads, m, v, norms, out=out_k, **kw), 10,
                   queued=True)
    del out_k
    lib_p = {k: x.clone() for k, x in p.items()}
    for k, x in lib_p.items():
        x.grad = grads[k]
    lib = torch.optim.Adam(list(lib_p.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8, fused=True)
    library_ms = time_ms(lib.step, 10)
    del lib_p, lib
    n = sum(x.numel() for x in p.values())
    b_ms, b_by = bound(7 * 4 * n, 20 * n, "fp32")
    log(f"fleet: O1 cohort of {N} over {len(p)} stacked leaves ({n} values): {ms:.4f} ms back "
        f"to back, {ms_q:.4f} queued, {7 * 4 * n / ms / 1e6:.0f} GB/s; bound {b_ms:.4f} ms by "
        f"{b_by} ({7 * 4 * n / 1e9:.3f} GB, {100 * b_ms / ms:.0f}% of it); the {N} solo "
        f"launches {' + '.join(f'{x:.4f}' for x in solo_ms)} = {sum(solo_ms):.4f} ms; the plain "
        f"update {plain_ms:.4f} ms; torch.optim.Adam(fused=True, no clip) {library_ms:.4f} ms")
    adam.adam_update.launches, adam.adam_update.cohort_launches = before
    return {"name": "adam_update (cohort)", "route": "cuda",
            "source": "crosscoder_tpu_torch/csrc/adam_update.cu",
            "replaces": "crosscoder_tpu/train/fleet.py:446 (the vmapped cohort step's optax "
                        "chain, which XLA fuses; no Pallas site)",
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}


def fleet(torch, np, root):
    """Phase 14: the fleet at Gemma-2-2B width off a host store harvested
    from the two random-init Gemma-2-2B: cohort C (three TopK tenants, one
    O1 launch a round) and bucket BT (BatchTopK, admitted before round
    ``BT_IN``, retired before round ``BT_OUT``), ``ROUNDS_F`` rounds with
    every plain version made to raise; each tenant's losses and final state
    bitwise a solo Trainer over the same served batches from the same
    init; one real serve and one host-to-device copy a round; the launches
    those of the solo steps but O1, once a group a round; the cohort's O1
    (:func:`_fleet_o1`). Returns the fleet's launches and the cohort O1
    row."""
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.data import buffer as bufmod
    from crosscoder_tpu_torch.models import lm
    from crosscoder_tpu_torch.obs.registry import MetricsRegistry
    from crosscoder_tpu_torch.ops import adam
    from crosscoder_tpu_torch.ops import fused_encoder_topk as fek
    from crosscoder_tpu_torch.ops import sparse_grad as sg
    from crosscoder_tpu_torch.ops import topk_pallas as tp
    from crosscoder_tpu_torch.train import fleet as fleet_mod

    t_phase = time.perf_counter()
    lm_cfg = lm.LMConfig.gemma2_2b()
    params = [lm.init_params(lm_cfg, seed=s, device="cuda") for s in (1, 2)]
    tokens = harvest_tokens(np, 256, FLEET["seq_len"], lm_cfg.vocab_size, 6)
    cfg = CrossCoderConfig(**FLEET)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    buffer = bufmod.make_buffer(cfg, lm_cfg, params, tokens, device="cuda")
    torch.cuda.synchronize()
    log(f"fleet: two random-init Gemma-2-2B built in {t0 - t_phase:.1f} s; the host store of "
        f"{buffer.buffer_size} rows calibrated and filled in {time.perf_counter() - t0:.2f} s")
    factor = buffer.normalisation_factor
    reg = MetricsRegistry()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fl = fleet_mod.FleetScheduler(cfg, buffer, registry=reg, checkpoint=False, device="cuda")
    if [len(c.members) for c in fl._cohorts] != [3] or fl._buckets:
        fail(f"phase 14: the roster did not form one cohort of 3: {fl._cohorts}, {fl._buckets}")
    batches, serve_ms = [], []
    real_serve, real_copy = fl._serve_round, fleet_mod.to_device

    def serve_round():
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_serve()
        serve_ms.append((time.perf_counter() - t) * 1e3)
        return out

    def device_batch(b, device):
        if b.device.type != "cpu":
            fail("phase 14: the round's batch is not in host memory, so its copy is no "
                 "host-to-device transfer")
        t = time.perf_counter()
        out = real_copy(b, device)
        torch.cuda.synchronize()
        serve_ms[-1] += (time.perf_counter() - t) * 1e3
        batches.append(out)
        return out

    fl._serve_round, fleet_mod.to_device = serve_round, device_batch
    seq0 = buffer._serve_seq
    counters = launch_counters()
    reset_counters(counters)
    cohort0 = adam.adam_update.cohort_launches
    losses, round_ms = {}, []
    late = fleet_mod.TenantSpec("bt", FLEET_BT)
    try:
        with no_plain_versions(tp, sg, fek):
            for r in range(ROUNDS_F):
                if r == BT_IN:
                    fl.admit(late)
                if r == BT_OUT:
                    bt_state = fl.tenant_state("bt")
                    fl.retire("bt", save=False)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mets = fl.step_all(full_metrics=True)
                torch.cuda.synchronize()
                round_ms.append((time.perf_counter() - t0) * 1e3)
                for name, md in mets.items():
                    losses.setdefault(name, []).append(float(md["loss"]))
    finally:
        fleet_mod.to_device = real_copy
    scale = fl._scale(buffer, fl._raw_serving)
    launches = {n: c.launches for n, c in counters.items() if c.launches}
    cohort = adam.adam_update.cohort_launches - cohort0
    peak = torch.cuda.max_memory_allocated()
    states = {n: fl.tenant_state(n) for n in fl.active()}
    states["bt"] = bt_state
    for name, st in states.items():
        if any(x.device.type != "cuda" for x in st.params.values()):
            fail(f"phase 14: tenant {name}'s params left the card")
    n_serves = buffer._serve_seq - seq0
    log(f"fleet: {ROUNDS_F} rounds, {n_serves} real serves, {len(batches)} host-to-device "
        f"copies, comm/h2d_transfers {reg.get_count('comm/h2d_transfers')}; launches {launches}, "
        f"O1 cohort launches {cohort}")
    if not n_serves == len(batches) == reg.get_count("comm/h2d_transfers") == ROUNDS_F:
        fail("phase 14: not one gather and one host-to-device copy a round")
    bt_steps = BT_OUT - BT_IN
    if cohort != ROUNDS_F or launches.get("adam_update") != ROUNDS_F + bt_steps:
        fail(f"phase 14: O1 launched {launches.get('adam_update')} times ({cohort} on the "
             f"cohort), not once a cohort and once a bucket a round")
    for n in ("topk_mask", "batchtopk_select", "batchtopk_emit"):
        if not launches.get(n):
            fail(f"phase 14: {n} never launched on the fleet's path")
    fl.buffer = None
    del buffer, params
    torch.cuda.empty_cache()

    solo, solo_ms = {}, {}
    specs = {s.name: s for s in fleet_mod.parse_tenants(cfg.fleet_tenants)}
    specs["bt"] = late
    for name, spec in specs.items():
        tcfg = fleet_mod.tenant_config(cfg, spec)
        skip, steps = (BT_IN, bt_steps) if name == "bt" else (0, ROUNDS_F)
        tr, out, sl = run_leg(torch, tcfg, batches[skip:skip + steps], factor, steps)
        ok, what = state_bits_equal(torch, states[name], tr.state)
        got = losses[name]
        log(f"fleet: tenant {name} ({'bucket' if name == 'bt' else 'cohort'}, {steps} steps) "
            f"losses {[round(x, 4) for x in got]}; the solo Trainer's "
            f"{'bitwise equal' if got == [o['loss'] for o in out] else 'DIFFERENT'}, final "
            f"state {'bitwise equal' if ok else 'DIFFERENT: ' + what}; solo launches {sl}")
        if got != [o["loss"] for o in out] or not ok:
            fail(f"phase 14: tenant {name} differs from its solo Trainer ({what})")
        solo_ms[name] = [o["ms"] for o in out]
        for k, c in sl.items():
            if k != "by route":
                solo[k] = solo.get(k, 0) + c
        del tr
    o1_solo = solo.pop("adam_update", 0)
    if {k: c for k, c in launches.items() if k != "adam_update"} != solo:
        fail(f"phase 14: the fleet's launches {launches} are not its solo steps' {solo}")
    log(f"fleet: launches but O1 equal the solo steps' ({solo}); O1 {launches['adam_update']} "
        f"against the solo runs' {o1_solo} (one a cohort and one a bucket a round)")
    for r in range(ROUNDS_F):
        solo_sum = sum(solo_ms[n][r] for n in specs if n != "bt")
        n_active = 3
        if BT_IN <= r < BT_OUT:
            solo_sum += solo_ms["bt"][r - BT_IN]
            n_active += 1
        log(f"fleet: round {r}: {round_ms[r]:.2f} ms ({serve_ms[r]:.2f} of it the serve and its "
            f"refill share, and the copy) against {solo_sum:.2f} ms for the {n_active} solo "
            f"steps alone; {solo_sum + n_active * serve_ms[r]:.2f} ms with a serve each")
    log(f"fleet: peak memory allocated {peak / 2 ** 30:.2f} GiB ({(peak - mem0) / 2 ** 30:.2f} "
        f"GiB over the models and the store)")
    row = _fleet_o1(torch, np, fl, batches[-1], scale)
    row["launches"] = cohort
    log(f"fleet phase {time.perf_counter() - t_phase:.1f} s (budget 90 s)")
    return launches, row


# ---------------------------------------------------------------------------
# phase 15: the counted wire, the trainer's one-deep prefetch, the fleet on a
# rank grid

# leg CM: comm_model.profile_width in a child process (a fake group of n ranks
# counts rank 0's program, and this process holds NCCL groups of its own) at
# leg A's shapes under JAX's base config (bf16 encoder and masters): DP and
# the int8 exchange at n = 2, 4, 8, DP x TP at 4 x 2, the DP and SP harvests of
# Gemma-2-2B cut to 14 layers at [4, 1024]
CM_WIDTHS, CM_TP, CM_HARVEST_N = (2, 4, 8), (8, 2), 4
# leg PF: leg A's config over the synthetic source and leg H's BatchTopK config
# over a host bf16 store of the two random-init Gemma-2-2B (buffer_mult cut to
# 4, norm calibration from 2 chunks), PF_STEPS steps a run, the prefetch off
# then on, PF_ROUNDS times (so neither way always runs first)
PF_STEPS, PF_ROUNDS = 5, 2
PF_H = dict(HARVEST, activation="batchtopk", buffer_mult=4, norm_calib_batches=2)
# leg FG: phase 14's cohort C (three TopK tenants, dict 2^15) for FG_ROUNDS
# rounds on one device, then over an NCCL group of one rank; then at data 1 x
# model 2 on two gloo ranks sharing the card: a TopK cohort of two (sparse
# backward) and a bucket at dict 2^14 against each rank's single-device fleet
FG_ROUNDS = 3
FLEET_G = dict(TRAIN, aux_k=0, aux_every=1, fleet="on", num_tokens=TRAIN["batch_size"] * 8,
               fleet_tenants="c1:seed=1;c2:seed=2;w:seed=3,dict_size=16384")


def comm_worker(out):
    """Leg CM's child (``chip_smoke.py --comm-model OUT``): the port's
    ``comm_model.profile_width`` on the card; writes the profiles as JSON."""
    from crosscoder_tpu_torch.parallel import comm_model as cm

    t0 = time.perf_counter()
    shape = dict(dict_size=TRAIN["dict_size"], d_in=TRAIN["d_in"],
                 batch_size=TRAIN["batch_size"])
    profs = []
    for n in CM_WIDTHS:
        profs += cm.profile_width(n, programs=("train", "train_quant"), device="cuda", **shape)
    profs += cm.profile_width(CM_TP[0], model_axis=CM_TP[1], programs=("train_tp",),
                              device="cuda", **shape)
    profs += cm.profile_width(CM_HARVEST_N, programs=("harvest", "sp_harvest"), device="cuda",
                              seq_len=HARVEST["seq_len"], **shape)
    Path(out).write_text(json.dumps({"s": time.perf_counter() - t0,
                                     "profiles": [dataclasses.asdict(p) for p in profs]}))


def start_comm_leg(root):
    out = Path(tempfile.mkdtemp(prefix="chip_smoke_cm_", dir=root / "build")) / "cm.json"
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--comm-model",
                             str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, out


def finish_comm_leg(started, card):
    """Leg CM's profiles: bytes by op, wire bytes and ``predict()`` at leg
    A's bare step of this run. Fails unless the DP step all-reduces
    exactly its f32 gradients (and a few bytes of loss terms) at every
    width with no all-gather, the TP step less, the DP harvest nothing and
    the SP harvest's permutes K and V over n - 1 hops a layer run."""
    from crosscoder_tpu_torch.parallel import comm_model as cm

    proc, out = started
    try:
        text = proc.communicate(timeout=600)[0].decode(errors="replace")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode:
        log(f"leg CM: {text[-3000:]}")
        fail(f"phase 15: leg CM's process exited {proc.returncode}")
    res = json.loads(out.read_text())
    shutil.rmtree(out.parent, ignore_errors=True)
    profs = [cm.CommProfile(**p) for p in res["profiles"]]
    step_ms = float(STEP_MS["leg A bare"])
    din, H = TRAIN["d_in"], TRAIN["dict_size"]
    n_params = 2 * 2 * din * H + H + 2 * din
    for p in profs:
        pred = cm.predict(step_ms, p)
        log(f"leg CM: {p.program} at {p.n_devices} ({p.n_devices // p.model_axis} x "
            f"{p.model_axis}): bytes {p.bytes_by_op}; wire {cm.wire_bytes(p):.0f} bytes; "
            f"predict() at {cm.NVLINK_GBPS} GB/s over leg A's bare step {step_ms:.3f} ms: "
            f"{pred} ({card})")
    dp = [p for p in profs if p.program == "train_dp"]
    if {p.n_devices for p in dp} != set(CM_WIDTHS) or len({p.total_bytes for p in dp}) != 1:
        fail(f"phase 15: leg CM's DP step moves different bytes at different widths: {dp}")
    for p in dp:
        ar = p.bytes_by_op["all-reduce"]
        if p.bytes_by_op["all-gather"] or not 4 * n_params <= ar <= 4 * n_params + 64:
            fail(f"phase 15: leg CM's DP step all-reduced {ar} bytes (the f32 gradients are "
                 f"{4 * n_params}) or gathered {p.bytes_by_op['all-gather']}")
    (tp,) = [p for p in profs if p.program == "train_dp_tp"]
    if not tp.bytes_by_op["all-reduce"] < dp[0].bytes_by_op["all-reduce"]:
        fail(f"phase 15: leg CM's TP step moves no less than DP: {tp.bytes_by_op}")
    (hd,) = [p for p in profs if p.program == "harvest_dp"]
    (sp,) = [p for p in profs if p.program == "harvest_sp"]
    from crosscoder_tpu_torch.models import lm

    from crosscoder_tpu_torch.utils.dtypes import dtype_of

    g = dataclasses.replace(lm.LMConfig.gemma2_2b(), n_layers=14)
    n, S = CM_HARVEST_N, HARVEST["seq_len"]
    # one shard's K (or V): [n, S / n, kv heads, head dim] in the LM's dtype
    shard_kv = n * (S // n) * g.n_kv_heads * g.head_dim * dtype_of(g.dtype).itemsize
    want = 2 * (n - 1) * (g.n_layers - 1) * shard_kv
    if hd.total_bytes or sp.bytes_by_op["collective-permute"] != want:
        fail(f"phase 15: leg CM's harvests: DP {hd.bytes_by_op}, SP permute "
             f"{sp.bytes_by_op['collective-permute']} (K and V, {n - 1} hops, "
             f"{g.n_layers - 1} layers, {shard_kv} bytes a shard: {want})")
    log(f"leg CM: profiled in {res['s']:.1f} s in its own process")
    return {p.program + f" {p.n_devices}": p for p in profs}


def _intervals_overlap(a, b):
    return any(s0 < e1 and s1 < e0 for s0, e0 in a for s1, e1 in b)


def prefetch_run(torch, cfg, src, state0, counters, profile=False):
    """``PF_STEPS`` steps of a Trainer under ``cfg`` over ``src`` from
    ``state0``, the loss read each step; the launch counters set to 0
    just before and read just after. Returns the losses, the loss-to-loss
    ms, the ms of each serve (host clock, on whichever thread served), the
    launches, the trainer and the streams its copies ran on; with
    ``profile``, two more steps under ``torch.profiler`` and whether a
    host-to-device copy overlapped a step kernel on the card."""
    from crosscoder_tpu_torch.train import trainer as trainer_mod

    copies = []
    real = trainer_mod.to_device

    def to_device(b, device):
        copies.append(torch.cuda.current_stream(device).cuda_stream)
        return real(b, device)

    trainer_mod.to_device = to_device
    try:
        tr = trainer_mod.Trainer(cfg, src, device="cuda", state=state0)
        serve_ms = []
        serve_once = tr._serve_once

        def timed_serve(*a, **kw):
            t0 = time.perf_counter()
            b = serve_once(*a, **kw)
            serve_ms.append((time.perf_counter() - t0) * 1e3)
            return b

        tr._serve_once = timed_serve
        torch.cuda.synchronize()
        reset_counters(counters)
        losses, ms = [], []
        t = time.perf_counter()
        for _ in range(PF_STEPS):
            losses.append(float(tr.step(full_metrics=False)["loss"]))
            now = time.perf_counter()
            ms.append((now - t) * 1e3)
            t = now
        launches = {n: c.launches for n, c in counters.items() if c.launches}
        launches["by route"] = read_routes()
        overlap = None
        if profile:
            from torch.profiler import ProfilerActivity, profile as tprofile

            state = copy.copy(tr.state)      # the compared state: the profiled steps copy it
            tr._owns_state = False
            with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(2):
                    float(tr.step(full_metrics=False)["loss"])
            tr.state = state
            spans = {"copy": [], "kernel": []}
            for e in prof.events():
                if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
                    continue
                iv = e.time_range
                kind = "copy" if "Memcpy HtoD" in e.name else "kernel"
                if kind == "kernel" and ("Memcpy" in e.name or "Memset" in e.name):
                    continue
                spans[kind].append((iv.start, iv.end))
            overlap = (len(spans["copy"]), len(spans["kernel"]),
                       _intervals_overlap(spans["copy"], spans["kernel"]))
    finally:
        trainer_mod.to_device = real
    main = torch.cuda.current_stream().cuda_stream
    return dict(losses=losses, ms=ms, serve_ms=serve_ms[:PF_STEPS], launches=launches, tr=tr,
                main=main, copies=copies, overlap=overlap)


def prefetch_leg(torch, np, lm_cfg, params, tokens, card):
    """Leg PF: leg A's config (synthetic source) and leg H's BatchTopK config
    (host bf16 store) for ``PF_STEPS`` steps a run, the prefetch off then on
    ``PF_ROUNDS`` times, every run from the same state over the same
    stream: losses and state bitwise the first run's, each leg's kernels
    launched on their routes in every run, the copies of the runs with
    prefetch on on a stream other than the step's. Prints the median
    loss-to-loss and serve ms each way over steps 2 on of every run, and
    whether a copy overlapped a step kernel. Returns both legs' launches."""
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.data import buffer as bufmod
    from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
    from crosscoder_tpu_torch.train.state import Optimizer, init_train_state

    counters = launch_counters()
    total = {}
    legs = {"A": (dict(TRAIN, fused_encoder="off"), ("topk_mask", "sparsify",
                                                    "scatter_add_rows")),
            "H": (PF_H, ("batchtopk_select", "batchtopk_emit"))}
    for leg, (kw, kernels) in legs.items():
        ref = state0 = None
        ms = {False: [], True: [], "serve False": [], "serve True": []}
        for rnd in range(PF_ROUNDS):
            for pf in (False, True):
                cfg = CrossCoderConfig(**{**kw, "prefetch": pf,
                                          "num_tokens": kw["batch_size"] * 100})
                if state0 is None:
                    state0 = init_train_state(cfg, Optimizer(cfg, lambda s: 0.0), device="cuda")
                if leg == "A":
                    src = SyntheticActivationSource(cfg)
                else:
                    src = bufmod.make_buffer(cfg, lm_cfg, params, tokens, device="cuda")
                r = prefetch_run(torch, cfg, src, state0, counters,
                                 profile=pf and rnd == PF_ROUNDS - 1)
                r["tr"].close()
                what = f"leg PF {leg} (prefetch {'on' if pf else 'off'}, round {rnd})"
                if ref is None:
                    ref = r
                else:
                    ok, diff = state_bits_equal(torch, r["tr"].state, ref["tr"].state)
                    if r["losses"] != ref["losses"] or not ok:
                        fail(f"phase 15: {what} differs from the first run: losses "
                             f"{r['losses']} against {ref['losses']}; state {diff}")
                L = r["launches"]
                check_routes(what, L, L["by route"])
                check_o1(what, L, PF_STEPS)
                for k in kernels:
                    if not L.get(k):
                        fail(f"phase 15: {what} never launched {k}")
                for k, c in L.items():
                    if k != "by route":
                        total[k] = total.get(k, 0) + c
                if pf and (r["tr"]._copy_stream is None
                           or any(st == r["main"] for st in r["copies"])):
                    fail(f"phase 15: {what}'s copies ran on the step's stream")
                if not pf and any(st != r["main"] for st in r["copies"]):
                    fail(f"phase 15: {what} copied off the step's stream")
                ms[pf] += r["ms"][1:]
                ms[f"serve {pf}"] += r["serve_ms"][1:]
                if r["overlap"] is not None:
                    overlap, stream = r["overlap"], (r["copies"][0], r["main"])
        med = {k: float(np.median(v)) for k, v in ms.items()}
        n_copy, n_kern, ov = overlap
        log(f"leg PF {leg}: {PF_ROUNDS} rounds of {PF_STEPS} steps off then on, losses "
            f"{[round(x, 4) for x in ref['losses']]} and state bitwise in every run; loss to "
            f"loss, median of steps 2-{PF_STEPS} of each run: prefetch off {med[False]:.2f} "
            f"ms, on {med[True]:.2f} ms ({'on <= off' if med[True] <= med[False] else 'on > off'}"
            f"; on {[round(x, 2) for x in ms[True]]} against off "
            f"{[round(x, 2) for x in ms[False]]}); the serve, median: off "
            f"{med['serve False']:.2f} ms, on {med['serve True']:.2f} ms; loss to loss beyond "
            f"the serve: off {med[False] - med['serve False']:.2f} ms, on "
            f"{med[True] - med['serve True']:.2f} ms; torch.profiler over 2 more steps with "
            f"prefetch on: {n_copy} host-to-device copies, {n_kern} kernels, a copy "
            f"{'overlapped' if ov else 'did not overlap'} a kernel on the card; copies on "
            f"stream {stream[0]} (the step's {stream[1]}); launches of the last run {L} "
            f"({card})")
        del ref, r, state0
        torch.cuda.empty_cache()
    return total


def _fleet_rounds(fl, rounds):
    losses = {}
    for _ in range(rounds):
        for name, md in fl.step_all().items():
            losses.setdefault(name, []).append(float(md["loss"]))
    return losses


def fleet_one_rank_leg(torch, np, root, lm_cfg, params, tokens):
    """Leg FG at world size 1: phase 14's cohort C for ``FG_ROUNDS`` rounds on
    one device, then over an NCCL group of one rank from the same init over
    the same stream (a host store built again from the same tokens):
    losses and every tenant's state bitwise. Returns the grid run's
    launches and O1 cohort launches."""
    import torch.distributed as dist

    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.data import buffer as bufmod
    from crosscoder_tpu_torch.ops import adam
    from crosscoder_tpu_torch.parallel import mesh as mesh_lib
    from crosscoder_tpu_torch.parallel import multihost
    from crosscoder_tpu_torch.train import fleet as fleet_mod

    cfg = CrossCoderConfig(**FLEET)
    counters = launch_counters()

    def run(mesh):
        buffer = bufmod.make_buffer(cfg, lm_cfg, params, tokens, device="cuda")
        fl = fleet_mod.FleetScheduler(cfg, buffer, checkpoint=False, device="cuda", mesh=mesh)
        torch.cuda.synchronize()
        reset_counters(counters)
        cohort0 = adam.adam_update.cohort_launches
        losses = _fleet_rounds(fl, FG_ROUNDS)
        launches = {n: c.launches for n, c in counters.items() if c.launches}
        launches["O1 cohort"] = adam.adam_update.cohort_launches - cohort0
        fl.buffer = None
        return losses, fl, launches

    ref_losses, ref, ref_launches = run(None)
    store_root = ckpt_dir(root)
    multihost.initialize("cuda:0", store=dist.FileStore(str(store_root / "store"), 1),
                         world_size=1, rank=0)
    try:
        losses, fl, launches = run(mesh_lib.make_mesh(1, 1))
        if fl.mesh is None:
            fail("phase 15: leg FG's fleet took no grid")
    finally:
        multihost.shutdown()
        shutil.rmtree(store_root, ignore_errors=True)
    for name in ref.active():
        ok, what = state_bits_equal(torch, fl.tenant_state(name), ref.tenant_state(name))
        if losses[name] != ref_losses[name] or not ok:
            fail(f"phase 15: leg FG's tenant {name} on an NCCL group of one rank differs from "
                 f"the fleet on one device ({what}; {losses[name]} vs {ref_losses[name]})")
    log(f"leg FG: cohort C {FG_ROUNDS} rounds over an NCCL group of one rank bitwise the "
        f"fleet on one device (losses {ref_losses}); launches on the grid {launches}, on one "
        f"device {ref_launches}")
    if launches["O1 cohort"] != FG_ROUNDS or not launches.get("topk_mask"):
        fail(f"phase 15: leg FG's grid run launched O1 {launches['O1 cohort']} times for "
             f"the cohort in {FG_ROUNDS} rounds, K5 {launches.get('topk_mask')}")
    del fl, ref
    torch.cuda.empty_cache()
    total = dict(launches)
    for k, c in ref_launches.items():
        total[k] = total.get(k, 0) + c
    return total


def fg_grid_rank(torch, rank, port, root):
    """One rank of leg FG at 1 x 2 (gloo): the fleet of ``FLEET_G`` on one
    device first (before the group), its losses and this rank's shard of
    each tenant's final params kept; then the group and the same fleet on
    the grid from the same seeds over the same stream. Returns the
    launches, the losses and the worst leaf error in norm; fails past leg
    FM's bars."""
    import torch.distributed as dist

    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
    from crosscoder_tpu_torch.ops import adam
    from crosscoder_tpu_torch.parallel import mesh as mesh_lib
    from crosscoder_tpu_torch.train import fleet as fleet_mod

    cfg = CrossCoderConfig(**FLEET_G)
    mine = mesh_lib.Mesh(data_size=1, model_size=2, data_rank=0, model_rank=rank,
                         data_group=None, model_group=None, world_group=None)

    def run(c, mesh):
        fl = fleet_mod.FleetScheduler(c, SyntheticActivationSource(cfg), checkpoint=False,
                                      device="cuda", mesh=mesh)
        losses = _fleet_rounds(fl, FG_ROUNDS)
        shards = {}
        for name in fl.active():
            st = fl.tenant_state(name)
            if mesh is None:
                st = mesh_lib.shard_state(mine, st)
            shards[name] = {k: v.detach().float().cpu() for k, v in st.params.items()}
        return losses, shards, fl

    ref_losses, ref_shards, fl = run(cfg, None)
    del fl
    torch.cuda.empty_cache()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    counters = launch_counters()
    reset_counters(counters)
    cohort0 = adam.adam_update.cohort_launches
    t0 = time.perf_counter()
    losses, shards, fl = run(cfg.replace(model_axis_size=2), mesh_lib.make_mesh(1, 2))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items() if c.launches}
    launches["O1 cohort"] = adam.adam_update.cohort_launches - cohort0
    roster = ([[t.name for t in co.members] for co in fl._cohorts],
              [b.tenant.name for b in fl._buckets])
    del fl
    dist.barrier()
    dist.destroy_process_group()
    loss_rel = max(abs(a - b) / abs(b) for n in ref_losses
                   for a, b in zip(losses[n], ref_losses[n]))
    leaf = {f"{n} {k}": _leaf_rel(torch, v, ref_shards[n][k])
            for n in shards for k, v in shards[n].items()}
    out = dict(losses=losses, ref_losses=ref_losses, loss_rel=loss_rel, leaf=leaf,
               launches=launches, wall=wall, roster=roster)
    if roster != ([["c1", "c2"]], ["w"]) or not (
            loss_rel <= FM_GRID_TOL[0] and max(leaf.values()) <= FM_GRID_TOL[1]):
        fail(f"leg FG 1x2 rank {rank}: roster {roster}, losses {losses} vs one device "
             f"{ref_losses} (relative {loss_rel:.3e}), leaf errors in norm {leaf}: past the "
             f"bars {FM_GRID_TOL}")
    torch.cuda.empty_cache()
    return out


def fg_grid(torch, root):
    """Leg FG at 1 x 2 on one card: this process is rank 0, one more process
    of this script (``--fleet-rank``) rank 1. Returns both ranks' results."""
    port = _free_port()
    out = Path(tempfile.mkdtemp(prefix="chip_smoke_fg_", dir=root / "build")) / "rank1.json"
    torch.cuda.empty_cache()
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--fleet-rank", "1",
                             str(port), str(out)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    try:
        res0 = fg_grid_rank(torch, 0, port, root)
    except BaseException:
        proc.kill()
        log(f"leg FG 1x2 rank 1: {proc.communicate()[0].decode(errors='replace')[-3000:]}")
        raise
    try:
        text = proc.communicate(timeout=600)[0].decode(errors="replace")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode:
        log(f"leg FG 1x2 rank 1: {text[-3000:]}")
        fail(f"leg FG 1x2: rank 1 exited {proc.returncode}")
    res1 = json.loads(out.read_text())
    shutil.rmtree(out.parent, ignore_errors=True)
    return [res0, res1]


def fleet_rank_worker(rank, port, out):
    """Rank ``rank`` of leg FG at 1 x 2 (``chip_smoke.py --fleet-rank``):
    writes its results as JSON to ``out``."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = Path(__file__).resolve().parent
    res = fg_grid_rank(torch, rank, port, root)
    Path(out).write_text(json.dumps(res))


def wire(torch, np, root, card):
    """Phase 15: leg CM (the counted wire, in a child process), leg FG (the
    fleet over an NCCL group of one rank bitwise the fleet on one device;
    at 1 x 2 on two gloo ranks within leg FM's bars) and leg PF (the
    prefetch bitwise off). Returns the phase's launches and O1's cohort
    launches."""
    from crosscoder_tpu_torch.models import lm

    t_phase = time.perf_counter()
    lm_cfg = lm.LMConfig.gemma2_2b()
    params = [lm.init_params(lm_cfg, seed=s, device="cuda") for s in (1, 2)]
    tokens = harvest_tokens(np, 256, HARVEST["seq_len"], lm_cfg.vocab_size, 6)
    launches = fleet_one_rank_leg(torch, np, root, lm_cfg, params, tokens)
    for k, c in prefetch_leg(torch, np, lm_cfg, params, tokens, card).items():
        launches[k] = launches.get(k, 0) + c
    del params
    torch.cuda.empty_cache()
    # leg CM's process runs beside the two gloo ranks of leg FG
    cm = start_comm_leg(root)
    t_grid = time.perf_counter()
    try:
        ranks = fg_grid(torch, root)
    except BaseException:
        cm[0].kill()            # a failed leg stops the process it started
        cm[0].wait()
        raise
    for r, res in enumerate(ranks):
        log(f"leg FG 1x2 rank {r}: losses {res['losses']} against one device "
            f"{res['ref_losses']} (worst relative {res['loss_rel']:.3e}, bar "
            f"{FM_GRID_TOL[0]}); worst leaf error in norm {max(res['leaf'].values()):.3e} "
            f"(bar {FM_GRID_TOL[1]}); launches {res['launches']}; {res['wall']:.1f} s")
        L = res["launches"]
        if L["O1 cohort"] != FG_ROUNDS or any(not L.get(k) for k in
                                               ("topk_mask", "sparsify", "scatter_add_rows")):
            fail(f"phase 15: leg FG 1x2 rank {r}'s launches {L}")
        for k, c in L.items():
            launches[k] = launches.get(k, 0) + c
    log(f"leg FG 1x2 took {time.perf_counter() - t_grid:.1f} s")
    profiles = finish_comm_leg(cm, card)
    log(f"wire phase {time.perf_counter() - t_phase:.1f} s (leg CM's profiles "
        f"{sorted(profiles)})")
    return launches


# ---------------------------------------------------------------------------
# phase 16: the telemetry plane and the resilience hooks

# leg OB: leg A's config (dense encode, prefetch on) over OB_BATCHES synthetic
# batches made ahead onto the card, a log every step: OB_MANUAL steps by
# hand, then train() to OB_STEPS; obs off, then obs on with a profiler window
# of OB_WINDOW and, after the manual steps, one save and one restore (the
# final save of train() is left out: a save of this state is 4.8 GB)
OB_STEPS, OB_MANUAL, OB_BATCHES, OB_WINDOW = 8, 2, 4, "3:5"
OB_KERNELS = {"topk_mask": "topk_slice_kernel", "sparsify": "sparsify_split_kernel",
              "scatter_add_rows": "scatter_rows_kernel", "adam_update": "adam_update_kernel"}
OB_SPANS = ("step", "refill_wait", "save", "save_write", "restore")
# leg RS: leg PF H's harvested BatchTopK setup (a host store of the two
# random-init Gemma-2-2B, buffer_mult 4: a fill of chunks 0-3, then two
# chunks a serve), prefetch on, RS_STEPS steps a run: the clean run; run A,
# faults at the serve's entry through the watchdog (bitwise the clean run);
# run B, a NaN serve under the guard with save 1 corrupted as it lands, at
# dict 2^10 (its saves kept small), RS_B_STEPS steps; run C, a stalled and a
# failing harvest chunk of the refill (chunks 5 and 6: the first fill's
# chunks count too, and a fault there raises out of the buffer's constructor,
# which no watchdog watches)
RS_STEPS, RS_B_STEPS = 6, 8
RS_WATCH = dict(harvest_timeout_s=0.5, harvest_retries=3, harvest_backoff_s=0.05)
RS_A, RS_B = "stall@2:1.5,fail@4", "nan@3,corrupt-save@1"
RS_C = "stall-harvest@5:0.7,fail-harvest@6"
RS_B_KW = dict(dict_size=2 ** 10, guard_loss=True, log_every=2, save_every=2, keep_saves=3,
               max_rollbacks=2)
# what the JAX trainer counts for the same specs and schedules
# (tests/test_torch_chaos.py holds the port to it on the CPU)
RS_B_WANT = {"resilience/rollbacks": 1, "resilience/corrupt_artifact_skips": 1,
             "resilience/poisoned_save_skips": 1, "resilience/skipped_batches": 5}
RS_C_WANT = {"resilience/harvest_timeouts": 1, "resilience/harvest_retries": 1}


class LossLog:
    """A logger for ``Trainer.train``: keeps every logged line."""

    def __init__(self):
        self.lines = []

    def log(self, scalars, step):
        self.lines.append(dict(scalars, step=step))

    def close(self):
        pass


def _ob_run(torch, cfg, src, counters, save_restore):
    """One leg OB run: the manual steps (full metrics), the save and the
    restore when asked, then train(); the launch counters set to 0 just
    before the first step and read after the last. Returns the losses,
    the trainer, the logged lines and the launches."""
    from crosscoder_tpu_torch.checkpoint import Checkpointer
    from crosscoder_tpu_torch.train import trainer as trainer_mod

    src.i = 0
    logger = LossLog()
    tr = trainer_mod.Trainer(cfg, src, device="cuda", logger=logger,
                             checkpointer=Checkpointer(cfg=cfg) if save_restore else None)
    torch.cuda.synchronize()
    reset_counters(counters)
    losses = [float(tr.step(full_metrics=True)["loss"]) for _ in range(OB_MANUAL)]
    sr = None
    if save_restore:
        t0 = time.perf_counter()
        tr.save()
        t1 = time.perf_counter()
        tr.restore()
        torch.cuda.synchronize()
        sr = (t1 - t0, time.perf_counter() - t1)
        tr.checkpointer = None          # no final save of 4.8 GB
    tr.train(num_steps=OB_STEPS)
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items() if c.launches}
    losses += [line["loss"] for line in logger.lines]
    return losses, tr, logger.lines, launches, sr


def obs_leg(torch, np, root, card):
    """Leg OB: obs off, then obs on with a window and a save and restore:
    losses and state bitwise, K5, K8, K10 and O1 launched as often both
    ways; ``trace.json`` with the step, wait, save and restore spans; the
    window's Chrome trace naming the four kernels; the memory gauges the
    card's. Returns the on run's launches."""
    import shutil

    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource

    d = ckpt_dir(root)
    base = dict(TRAIN, fused_encoder="off", prefetch=True, log_every=1,
                num_tokens=TRAIN["batch_size"] * OB_STEPS, save_every=10 ** 9,
                checkpoint_dir=str(d))
    src = DeviceBatches(torch, SyntheticActivationSource(CrossCoderConfig(**base)), OB_BATCHES)
    counters = launch_counters()
    off = _ob_run(torch, CrossCoderConfig(**base), src, counters, False)
    on = _ob_run(torch, CrossCoderConfig(**base, obs="on", profile_steps=OB_WINDOW), src,
                 counters, True)
    ok, what = state_bits_equal(torch, on[1].state, off[1].state)
    if on[0] != off[0] or not ok:
        fail(f"phase 16: leg OB with obs on differs from obs off: losses {on[0]} against "
             f"{off[0]}; state {what}")
    L_off, L_on = off[3], on[3]
    for k in OB_KERNELS:
        if not L_on.get(k) or L_on.get(k) != L_off.get(k):
            fail(f"phase 16: leg OB launched {k} {L_on.get(k)} times with obs on, "
                 f"{L_off.get(k)} with it off")
    check_o1("leg OB (obs on)", L_on, OB_STEPS)
    obs_dir = d / "obs"
    spans = {e["name"] for e in json.loads((obs_dir / "trace.json").read_text())["traceEvents"]
             if e["ph"] == "X"}
    if not set(OB_SPANS) <= spans:
        fail(f"phase 16: leg OB's trace.json lacks spans {sorted(set(OB_SPANS) - spans)}")
    (window,) = sorted((obs_dir / "profile").iterdir())
    events = json.loads(window.read_text())["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    found = {k: sum(1 for n in kernels if sym in n) for k, sym in OB_KERNELS.items()}
    if not all(found.values()) or window.name != "window0_steps_3-4.trace.json":
        fail(f"phase 16: leg OB's window {window.name} lacks kernels: {found}")
    n_kernel_events = sum(1 for e in events if e.get("cat") == "kernel")
    rec = on[2][-1]
    hbm = {k: rec.get(k) for k in ("perf/hbm_bytes_in_use", "perf/hbm_peak_bytes",
                                   "perf/hbm_bytes_limit")}
    total = torch.cuda.mem_get_info()[1]
    if not all(v and v > 0 for v in hbm.values()) or hbm["perf/hbm_bytes_limit"] != total:
        fail(f"phase 16: leg OB's memory gauges {hbm} (the card's total {total})")
    # loss to loss: the steps train() ran, a log (and its sync) every step;
    # the window's steps apart
    t_off = [line["step_time_ms"] for line in off[2][1:]]
    t_on = [line["step_time_ms"] for line in on[2][1:]]
    win = [line["step_time_ms"] for line in on[2] if line["step"] in (3, 4)]
    plain = [line["step_time_ms"] for line in on[2][1:] if line["step"] not in (3, 4)]
    log(f"leg OB: {OB_STEPS} steps (leg A's config, prefetch on, a log every step) obs off and "
        f"on, losses {[round(x, 4) for x in on[0]]} and state bitwise; launches both ways "
        f"{L_on}; trace.json spans {sorted(spans)}; window {window.name}: {n_kernel_events} "
        f"kernel events, the port's kernels {found}; gauges {hbm}; the save {on[4][0]:.2f} s, "
        f"the restore {on[4][1]:.2f} s; loss to loss, median of train()'s steps after its "
        f"first: obs off {np.median(t_off):.3f} ms {[round(x, 3) for x in t_off]}, obs on "
        f"{np.median(t_on):.3f} ms {[round(x, 3) for x in t_on]} (outside the window "
        f"{np.median(plain):.3f} ms; the profiled steps {[round(x, 3) for x in win]} ms) "
        f"({card})")
    keys = sorted(k for k in rec if k.startswith(("perf/", "comm/")))
    log(f"leg OB: the last log line's telemetry keys {keys}")
    del off, on, src
    shutil.rmtree(d)
    torch.cuda.empty_cache()
    return L_on


def _rs_run(torch, cfg, lm_cfg, params, tokens, spec, steps, root=None):
    """One leg RS run over a host store built afresh from the same models
    and tokens: ``steps`` steps by hand, or ``train()`` under the guard
    (``root``: its saves under a directory of the build tree); the serve
    ms on the host clock, the launches, the counters and the losses."""
    import shutil

    from crosscoder_tpu_torch.checkpoint import Checkpointer
    from crosscoder_tpu_torch.data import buffer as bufmod
    from crosscoder_tpu_torch.resilience import Chaos
    from crosscoder_tpu_torch.train import trainer as trainer_mod

    chaos = Chaos.parse(spec)
    d = None
    if root is not None:
        d = ckpt_dir(root)
        cfg = cfg.replace(checkpoint_dir=str(d))
    b = bufmod.make_buffer(cfg, lm_cfg, params, tokens, device="cuda", chaos=chaos)
    logger = LossLog()
    tr = trainer_mod.Trainer(cfg, b, device="cuda", chaos=chaos, logger=logger,
                             checkpointer=Checkpointer(cfg=cfg, chaos=chaos) if d else None)
    serve_ms = []
    serve_once = tr._serve_once

    def timed_serve(*a, **kw):
        t0 = time.perf_counter()
        out = serve_once(*a, **kw)
        serve_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    tr._serve_once = timed_serve
    call_ms = []
    if tr._watchdog is not None:
        call = tr._watchdog.call

        def timed_call(fn):
            t0 = time.perf_counter()
            out = call(fn)
            call_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        tr._watchdog.call = timed_call
    counters = launch_counters()
    torch.cuda.synchronize()
    reset_counters(counters)
    t0 = time.perf_counter()
    if d is None:
        losses = [float(tr.step(full_metrics=False)["loss"]) for _ in range(steps)]
        tr.close()
    else:
        tr.train(num_steps=steps)
        losses = [line["loss"] for line in logger.lines]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items() if c.launches}
    if d is not None:
        shutil.rmtree(d)
    return dict(tr=tr, losses=losses, launches=launches, snap=tr.resilience.snapshot(),
                serve_ms=serve_ms, call_ms=call_ms, wall=wall, serves=tr._serve_count)


def resilience_leg(torch, np, root, card):
    """Leg RS: the clean run, runs A, B and C (module constants); returns
    the launches of all four runs."""
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.models import lm

    lm_cfg = lm.LMConfig.gemma2_2b()
    params = [lm.init_params(lm_cfg, seed=s, device="cuda") for s in (1, 2)]
    tokens = harvest_tokens(np, 256, HARVEST["seq_len"], lm_cfg.vocab_size, 6)
    base = dict(PF_H, prefetch=True, num_tokens=PF_H["batch_size"] * 100)
    cfg = CrossCoderConfig(**base)
    runs = {"clean": _rs_run(torch, cfg, lm_cfg, params, tokens, "", RS_STEPS),
            "A": _rs_run(torch, CrossCoderConfig(**base, **RS_WATCH), lm_cfg, params, tokens,
                         RS_A, RS_STEPS),
            "B": _rs_run(torch, CrossCoderConfig(**{**base, **RS_B_KW}), lm_cfg, params, tokens,
                         RS_B, RS_B_STEPS, root=root),
            "C": _rs_run(torch, CrossCoderConfig(**base, **RS_WATCH), lm_cfg, params, tokens,
                         RS_C, RS_STEPS)}
    del params
    total = {}
    for name, r in runs.items():
        L = r["launches"]
        if not (L.get("batchtopk_select") and L.get("batchtopk_emit") and L.get("adam_update")):
            fail(f"phase 16: leg RS run {name} did not launch K9 and O1: {L}")
        for k, c in L.items():
            total[k] = total.get(k, 0) + c
        med = float(np.median(r["serve_ms"][1:])) if len(r["serve_ms"]) > 1 else float("nan")
        log(f"leg RS run {name}: {r['tr'].step_counter} steps, {r['serves']} serves, losses "
            f"{[round(x, 4) for x in r['losses']]}; counters {r['snap']}; serve ms median "
            f"{med:.2f}, max {max(r['serve_ms']):.2f}; {r['wall']:.1f} s; launches {L}")
    clean, a, b, c = runs["clean"], runs["A"], runs["B"], runs["C"]
    ok, what = state_bits_equal(torch, a["tr"].state, clean["tr"].state)
    snap = a["snap"]
    if not ok or a["losses"] != clean["losses"] or snap.get("resilience/harvest_retries") != 1 \
            or snap.get("resilience/harvest_timeouts", 0) < 1:
        fail(f"phase 16: leg RS run A ({RS_A}): state {what or 'equal'}, counters {snap}")
    if b["snap"] != RS_B_WANT or not np.isfinite(b["losses"][-1]) \
            or b["tr"].step_counter != RS_B_STEPS:
        fail(f"phase 16: leg RS run B ({RS_B}): counters {b['snap']} (want {RS_B_WANT}), "
             f"losses {b['losses']}")
    if c["snap"] != RS_C_WANT or not all(np.isfinite(c["losses"])):
        fail(f"phase 16: leg RS run C ({RS_C}): counters {c['snap']} (want {RS_C_WANT})")
    # the watchdog's cost a serve: the watched call's time less the serve's
    # inside it, over run A's serves but the faulted two
    cost = [cm - sm for i, (cm, sm) in enumerate(zip(a["call_ms"], a["serve_ms"]))
            if i not in (2, 4)]
    log(f"leg RS: the watchdog's cost a serve (run A's serves but the faulted ones: the "
        f"watched call less the serve in it) median {np.median(cost):.3f} ms, max "
        f"{max(cost):.3f} ms; the serve itself median {np.median(a['serve_ms']):.2f} ms, "
        f"the clean run's {np.median(clean['serve_ms']):.2f} ms ({card})")
    del runs, clean, a, b, c
    torch.cuda.empty_cache()
    return total


def obs_resilience(torch, np, root, card):
    """Phase 16: leg OB and leg RS. Returns the phase's launches."""
    t_phase = time.perf_counter()
    launches = obs_leg(torch, np, root, card)
    t_rs = time.perf_counter()
    for k, c in resilience_leg(torch, np, root, card).items():
        launches[k] = launches.get(k, 0) + c
    log(f"obs and resilience phase {time.perf_counter() - t_phase:.1f} s (leg OB "
        f"{t_rs - t_phase:.1f} s, leg RS {time.perf_counter() - t_rs:.1f} s)")
    return launches


# phase 17: leg EL, the preempt drill (resilience/elastic_drill.py) at
# Gemma-2-2B width on two gloo ranks sharing the card, one rank a host (data 2
# x model 1): TopK k 32, dict 2^14, the sparse backward, AuxK, batch 4096,
# bf16 compute, f32 masters, the synthetic source, a save every 3 steps, the
# Trainer's default batch prefetch (on); rank 1 dies at serve 7, rank 0
# shrinks to one rank, restores and finishes EL_STEPS steps (8 of the
# drill's 10, cut to pay for phase 20: the survivor resumes from the save of
# step 6, so 2 steps after the re-mesh), a fresh process restores the same
# save; leg ES, the stability drill (flaky and slow probes
# below the threshold, its 8 steps) on two more gloo ranks, run beside leg EL
# from the phase's start at dict 2^10 and batch 1024 (its 0.6 GB gradient
# all-reduce through host memory at EL's shapes slowed EL's 2-rank steps 2x
# and the phase past its budget)
EL = dict(TRAIN, dict_size=2 ** 14, num_tokens=TRAIN["batch_size"] * 200, prefetch=True)
ES = dict(EL, dict_size=2 ** 10, batch_size=1024, num_tokens=1024 * 200)
EL_KERNELS = ("topk_mask", "sparsify", "scatter_add_rows", "adam_update")
EL_STEPS = 8
EL_PHASE_S = 120.0


def _drill_logs(work):
    """The tail of every drill rank's stderr under ``work``."""
    for f in sorted(Path(work).glob("*.err")):
        lines = [ln for ln in f.read_text(errors="replace").splitlines()
                 if "socket.cpp" not in ln and "Warning" not in ln]
        log(f"  {f.name}: " + " | ".join(lines[-12:])[-2500:])


def _run_drill(label, work, fn, overrides, phase=17, **kw):
    """One drill, its ranks' logs printed when it raises; fails the phase."""
    try:
        return fn(workdir=str(work), timeout=400.0, keep_logs=True, device="cuda",
                  overrides=overrides, **kw)
    except Exception as e:  # noqa: BLE001 — reported with the ranks' logs, then fail()
        _drill_logs(work)
        fail(f"phase {phase}: leg {label} raised {type(e).__name__}: {e}"[:2000])


def _timeline(rank, spawned):
    """A drill rank's stamps, in s from its process's spawn."""
    return ", ".join(f"{k} {v - spawned:.1f}" for k, v in rank["stamps"].items())


def el_plain_check(torch, np, vdir, save, leg="EL", phase=17):
    """A drill's restored save, 2 steps (an aux step and a bare one) with
    the kernels and again with their plain versions, bitwise (loss, params,
    moments, trackers): K5, K8, K10 and O1 at leg EL's shapes (leg EG's
    are the same)."""
    from crosscoder_tpu_torch.checkpoint import Checkpointer
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
    from crosscoder_tpu_torch.ops import fused_encoder_topk as fek
    from crosscoder_tpu_torch.ops import sparse_grad as sg
    from crosscoder_tpu_torch.ops import topk_pallas as tp
    from crosscoder_tpu_torch.train import schedules
    from crosscoder_tpu_torch.train import trainer as trainer_mod
    from crosscoder_tpu_torch.train.state import Optimizer

    cfg = CrossCoderConfig(**EL)
    state, meta = Checkpointer(base_dir=vdir.parent).restore(cfg, vdir, save, device="cuda")
    src = SyntheticActivationSource(cfg)
    src.load_state_dict(meta["buffer"])
    batches = [torch.from_numpy(src.next()).cuda() for _ in range(2)]
    scale = torch.ones(cfg.n_sources, device="cuda")
    opt = Optimizer(cfg, schedules.lr_schedule(cfg))
    runs = []
    for ctx in (contextlib.nullcontext(), plain_versions(tp, sg, fek)):
        st, losses = state, []
        with ctx:
            for b in batches:
                key = trainer_mod.variant_for_step(cfg, st.step)
                fn = trainer_mod.make_step_body(cfg, opt, *key)
                st, m = fn(st, b, scale)
                losses.append(_bits(m["loss"], torch).item())
        torch.cuda.synchronize()
        runs.append((losses, st))
    ok, what = state_bits_equal(torch, runs[0][1], runs[1][1])
    if runs[0][0] != runs[1][0] or not ok:
        fail(f"phase {phase}: leg {leg}'s restored steps with the kernels differ from their "
             f"plain versions: losses {runs[0][0]} against {runs[1][0]}; state {what}")
    return [float(np.array(x, np.int32).view(np.float32)) for x in runs[0][0]]


def _split_ms(step_ms):
    """A survivor's logged step times before its re-mesh and after (the
    step index falls back at the restore)."""
    for i in range(1, len(step_ms)):
        if step_ms[i][0] <= step_ms[i - 1][0]:
            return [ms for _, ms in step_ms[1:i]], [ms for _, ms in step_ms[i + 1:]]
    return [ms for _, ms in step_ms[1:]], []


def elastic(torch, np, root, card):
    """Phase 17: legs EL and ES. Returns the launches of leg EL's survivor
    and leg ES's rank 0."""
    from crosscoder_tpu_torch.resilience import elastic_drill as drill

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    (root / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_elastic_", dir=root / "build"))
    # leg ES on its own two ranks beside leg EL (nothing of leg ES is timed;
    # whether it was still running at EL's re-mesh is printed)
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    try:
        es_run = pool.submit(_run_drill, "ES", work / "es", drill.run_stability_drill, ES)
        rep = _run_drill("EL", work / "el", drill.run_drill, EL, steps=EL_STEPS)
        t_el = time.perf_counter() - t_phase
        surv = rep["survivor"]
        if not rep["bitwise_equal"]:
            _drill_logs(work / "el")
            fail(f"phase 17: leg EL's survivor after the re-mesh {rep['post_losses']} is not "
                 f"bitwise the clean restart's {rep['restart_losses']}")
        if rep["epoch"] != 1 or surv["grid"] != [1, 1] \
                or surv["counters"].get("resilience/remeshes") != 1:
            fail(f"phase 17: leg EL's survivor: epoch {rep['epoch']}, grid {surv['grid']}, "
                 f"counters {surv['counters']}")
        before, total = surv["launches_before"], surv["launches"]
        after = {k: total[k] - before[k] for k in total}
        for k in EL_KERNELS:
            if not before[k] or not after[k]:
                fail(f"phase 17: leg EL did not launch {k} on both sides of the re-mesh: "
                     f"before {before}, after {after}")
        plain = el_plain_check(torch, np, work / "el" / "version_0", surv["remesh"]["save"])
        pre, post = _split_ms(surv["step_ms"])
        log(f"leg EL: rank 1 died at serve {drill._DRILL['die_serve']}; rank 0 found it by "
            f"{rep['detected_by']} ({surv.get('cause', '')[:120]}), re-meshed to epoch "
            f"{rep['epoch']} on a {surv['grid'][0]} x {surv['grid'][1]} grid, restored save "
            f"{surv['remesh']['save']} (step {rep['resume_step']}) and finished "
            f"{surv['final_step']} steps; remesh_ms {rep['remesh_ms']} ({card}); losses after "
            f"the re-mesh {[round(float.fromhex(h), 4) for _, h in rep['post_losses']]} "
            f"bitwise the clean restart's; launches before the re-mesh {before}, after "
            f"{after}; 2 restored steps bitwise their plain versions (losses "
            f"{[round(x, 4) for x in plain]}); {t_el:.1f} s")
        split = {k: round(v, 1) for k, v in surv["remesh_split"].items()}
        log(f"leg EL: the survivor's re-mesh {split} ms (the wait for a save in "
            f"flight, the regroup, the restore); its timeline (s from its spawn) "
            f"{_timeline(surv, rep['spawned']['pair'])}; the clean restart's "
            f"{_timeline(rep['restart'], rep['spawned']['clean'])}")
        log(f"leg EL: gloo step time (loss to loss, host clock) at 2 ranks median "
            f"{np.median(pre):.1f} ms {[round(x, 1) for x in pre]}, at 1 rank after the "
            f"re-mesh median {np.median(post) if post else float('nan'):.1f} ms "
            f"{[round(x, 1) for x in post]}; gloo stages every collective through host "
            f"memory, so these say nothing of NCCL's ({card})")
        st = es_run.result()
        if not st["stable"]:
            _drill_logs(work / "es")
            fail(f"phase 17: leg ES was not stable: remeshes {st['remeshes']}, suspects "
                 f"{st['suspects']}, slow probes {st['slow_probes']}, skipped probes "
                 f"{st['skipped_probes']}, finished {st['finished']}")
        es0 = st["procs"][0]
        es_end = max(p["stamps"]["trained"] for p in st["procs"])
        log(f"leg ES: {st['steps']} steps on both ranks, remeshes {st['remeshes']}, rank 0 "
            f"suspects {st['suspects']} and slow probes {st['slow_probes']}, rank 1 skipped "
            f"probes {st['skipped_probes']}; rank 0 counters {es0['counters']}; launches "
            f"{es0['launches']}; its ranks trained until {es_end - rep['spawned']['pair']:.1f} "
            f"s after leg EL's spawn, EL's survivor re-meshed from "
            f"{surv['stamps']['remesh'] - rep['spawned']['pair']:.1f} s (leg ES "
            f"{'still running' if es_end > surv['stamps']['remesh'] else 'done'} then)")
    finally:
        pool.shutdown()
        shutil.rmtree(work, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    log(f"elastic phase {wall:.1f} s (leg EL {t_el:.1f} s; the phase's budget "
        f"{EL_PHASE_S:.0f} s)")
    return {k: total[k] + es0["launches"].get(k, 0) for k in EL_KERNELS}


# ---------------------------------------------------------------------------
# phase 18: leg EG, the autoscale drill (resilience/elastic_drill.py) at leg
# EL's width and config on gloo ranks sharing the card, 2 x 1 -> 1 x 1 -> 2 x
# 1: rank 1 dies at serve 6, rank 0 shrinks and replays, return@10 opens the
# rejoin window, the parked returned rank passes the debounce and rank 0 grows
# the world back through a boundary save; a clean 2 x 1 world restores the
# same save; EG_STEPS steps
# a save every 5 steps, not the drill's 4, and 12 of its 20 steps: a save
# of this state is 1.8 GB, and the phase took 169.1–176.9 s of its 180 at 20
# and 16 steps with a save every 4 (H100 80GB HBM3, 700 W; PERF.md §6), 14
# steps until phase 20 took its time. The newest save before the death at
# serve 6 holds step 5; the grow lands at step 9 or 10, 2 or 3 steps before
# the end
EG = dict(EL, save_every=5)
EG_STEPS = 12
EG_PHASE_S = 180.0
# the score policy's ranking is printed at Gemma-2-2B width for these rank counts
EG_RANKS = (2, 4, 8)


def _eg_ranking():
    """``FleetPolicy``'s score ranking at leg EG's config, as printable
    ``(n, [(data, model, score_ms)])`` rows."""
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.resilience.fleet import FleetPolicy

    pol = FleetPolicy(CrossCoderConfig(**EG, elastic_policy="score"))
    return [(n, [(c.n_data, c.n_model, round(c.score_ms, 3)) for c in pol.rank(n)])
            for n in EG_RANKS]


def autoscale(torch, np, root, card):
    """Phase 18: leg EG. Returns the launches of its survivor and joiner."""
    from crosscoder_tpu_torch.resilience import elastic_drill as drill

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    (root / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_autoscale_", dir=root / "build"))
    try:
        rep = _run_drill("EG", work, drill.run_autoscale_drill, EG, phase=18, steps=EG_STEPS)
        t_eg = time.perf_counter() - t_phase
        surv, join = rep["survivor"], rep["joiner"]
        if not rep["bitwise_equal"] or not rep["joiner_equal"]:
            _drill_logs(work)
            fail(f"phase 18: leg EG after the grow: survivor {rep['post_losses']}, clean "
                 f"{rep['clean_losses']}, joiner {rep['joiner_losses']} (bitwise "
                 f"{rep['bitwise_equal']}, joiner {rep['joiner_equal']})")
        c = surv["counters"]
        if (c.get("resilience/remeshes") != 2 or c.get("resilience/grows") != 1
                or c.get("resilience/grow_aborts") or rep["epoch"] != 2
                or surv["grid"] != [2, 1] or join["grid"] != [2, 1]):
            fail(f"phase 18: leg EG's survivor: counters {c}, epoch {rep['epoch']}, grids "
                 f"{surv['grid']} and {join['grid']}")
        before, total = surv["launches_before_grow"], surv["launches"]
        after = {k: total[k] - before[k] for k in total}
        for k in EL_KERNELS:
            if not before[k] or not after[k] or not join["launches"][k]:
                fail(f"phase 18: leg EG did not launch {k} on both sides of the grow: before "
                     f"{before}, after {after}, on the joiner {join['launches']}")
        grow = surv["grow"]
        plain = el_plain_check(torch, np, Path(grow["version_dir"]), grow["save"], "EG", 18)
        log(f"leg EG: rank 1 died at serve {drill._AUTOSCALE['die_serve']}; rank 0 found it by "
            f"{surv['detected_by']}, shrank to epoch {surv['remesh']['epoch']} and restored "
            f"save {surv['remesh']['save']} (step {surv['remesh']['step']}); return@"
            f"{drill._AUTOSCALE['return_serve']} opened the rejoin window; rank 0 grew to "
            f"epoch {rep['epoch']} on a 2 x 1 grid at step {grow['step']} through boundary save "
            f"{grow['save']}, the joiner at rank {join['rank']}; both finished "
            f"{surv['final_step']} steps; remesh_ms {rep['remesh_ms']}, grow_ms "
            f"{rep['grow_ms']} ({card}); losses after the grow "
            f"{[round(float.fromhex(h), 4) for _, h in rep['post_losses']]} bitwise the clean "
            f"2 x 1 world's and the joiner's; launches before the grow {before}, after "
            f"{after}, on the joiner {join['launches']}; 2 steps from the boundary save "
            f"bitwise their plain versions (losses {[round(x, 4) for x in plain]}); "
            f"{t_eg:.1f} s")
        split = {k: round(v, 1) for k, v in surv["grow_split"].items()}
        rsplit = {k: round(v, 1) for k, v in surv["remesh_split"].items()}
        log(f"leg EG: the grow's split {split} ms (the boundary save, the regroup: the "
            f"admission and the rendezvous, the restore); the shrink's {rsplit} ms; the "
            f"survivor's timeline (s from the spawn) {_timeline(surv, rep['spawned']['pair'])}; "
            f"the joiner's {_timeline(join, rep['spawned']['pair'])}; the clean world's "
            f"rank 0 {_timeline(rep['clean'], rep['spawned']['clean'])}")
        wide = [ms for i, ms in surv["step_ms"] if i > grow["step"]]
        log(f"leg EG: gloo step time at 2 ranks after the grow (loss to loss, host clock) "
            f"median {np.median(wide) if wide else float('nan'):.1f} ms "
            f"{[round(x, 1) for x in wide]}; gloo stages every collective through host memory "
            f"({card})")
        for n, rows in _eg_ranking():
            log(f"leg EG: FleetPolicy score ranking at {n} ranks, Gemma-2-2B width (d_in "
                f"{EG['d_in']}, dict {EG['dict_size']}, batch {EG['batch_size']}; (data, model, "
                f"modeled ms), cheapest first): {rows}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    log(f"autoscale phase {wall:.1f} s (leg EG {t_eg:.1f} s; the phase's budget "
        f"{EG_PHASE_S:.0f} s)")
    return {k: total[k] + join["launches"][k] for k in EL_KERNELS}


# ---------------------------------------------------------------------------
# phase 19: leg TU, the tuner at the train phase's width over the synthetic
# source (its serve of a 4096-row batch, 0.52-0.75 s of host numpy, is the
# windows' pace; PERF.md §5). Windows of 2 + 3 steps and Trainers of 2 (4
# and 4 until phase 20 took its time)
TU = dict(TRAIN)
TU_AXES = {"prefetch": (False, True), "refill_frac": (0.25, 0.5),
           "refill_dispatch_batch": (4, 8)}
TU_TOP_K, TU_STEPS, TU_WARMUP, TU_TRAINER_STEPS = 2, 3, 2, 2
TU_PHASE_S = 60.0


def _flag(k, v):
    """One config knob as ``from_cli`` flags."""
    return [f"--{k.replace('_', '-')}", str(v).lower() if isinstance(v, bool) else str(v)]


def quantum_host_ms(torch, np):
    """One harvest quantum's host time: ``SegmentedHarvest.step()`` of both
    random-init Gemma-2-2B models to block 14 over a [4, 1024] chunk, the
    card idle before each call (a second job, after one whole job as a
    warm-up). Returns every quantum's ms."""
    from crosscoder_tpu_torch.models import lm

    lm_cfg = lm.LMConfig.gemma2_2b()
    params = [lm.init_params(lm_cfg, seed=s, device="cuda") for s in (1, 2)]
    tokens = harvest_tokens(np, HARVEST["model_batch_size"], HARVEST["seq_len"],
                            lm_cfg.vocab_size, 6)
    ms = []
    for _ in range(2):
        job = lm.SegmentedHarvest(params, tokens, lm_cfg, (TU["hook_point"],))
        ms = []
        more = True
        while more:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            more = job.step()
            ms.append((time.perf_counter() - t0) * 1e3)
        job.result()
        torch.cuda.synchronize()
    del params
    torch.cuda.empty_cache()
    return ms


def _tu_trainer(torch, cfg, steps):
    """``steps`` Trainer steps of ``cfg`` over the synthetic source on the
    card: (the losses' bits, the state)."""
    from crosscoder_tpu_torch.train.trainer import Trainer

    tr = Trainer(cfg, device="cuda")
    try:
        bits = [_bits(tr.step()["loss"], torch).item() for _ in range(steps)]
        torch.cuda.synchronize()
        return bits, tr.state
    finally:
        tr.close()


def tuner(torch, np, root, card):
    """Phase 19: leg TU. Returns the launches of K5, K8, K10 and O1."""
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.obs.registry import MetricsRegistry
    from crosscoder_tpu_torch.resilience.fleet import FleetPolicy
    from crosscoder_tpu_torch.tune import apply_tuned, load_tuned, tune
    from crosscoder_tpu_torch.tune import calibrate, lattice

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    (root / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_tune_", dir=root / "build"))
    counters = launch_counters()
    reset_counters(counters)
    cfg = CrossCoderConfig(**TU)
    try:
        ranked = lattice.rank_candidates(lattice.enumerate_lattice(cfg, TU_AXES)[0])
        log("leg TU: stage 1 on the port's cost model (predicted acts/s/chip; step ms): "
            + "; ".join(f"{c.label} {c.score:.1f} ({c.predicted['step_total_ms']:.3f} ms)"
                        for c in ranked))
        windows, gates = [], []

        def measure(c, **kw):
            t0 = time.perf_counter()
            m = calibrate.measure_window(c, device="cuda", **kw)
            windows.append((c, m, time.perf_counter() - t0))
            return m

        def gate(c, knobs=None):
            t0 = time.perf_counter()
            ok, findings = calibrate.step_identity_gate(c, knobs, device="cuda")
            gates.append((knobs, ok, (time.perf_counter() - t0) * 1e3))
            return ok, findings

        path = work / "TUNED.json"
        reg = MetricsRegistry()
        t0 = time.perf_counter()
        art = tune(cfg, "train", axes=TU_AXES, top_k=TU_TOP_K, steps=TU_STEPS,
                   warmup=TU_WARMUP, seed=0, out_path=str(path), registry=reg,
                   measure=measure, gate=gate, device="cuda")
        t_tune = time.perf_counter() - t0
        rows = art.search["candidates"]
        if reg.get_count("tune/rejected_contract") or any(r["gate"] != "pass" for r in rows):
            fail(f"phase 19: leg TU: a calibrated candidate failed the step-identity gate: "
                 f"{rows}")
        if load_tuned(path).knobs != art.knobs:
            fail(f"phase 19: leg TU's TUNED.json reloads {load_tuned(path).knobs}, not "
                 f"{art.knobs}")
        applied = apply_tuned(cfg, path)
        if {k: getattr(applied, k) for k in art.knobs} != art.knobs or applied.tuned != str(path):
            fail(f"phase 19: leg TU: apply_tuned gives {applied}, not the knobs {art.knobs}")
        for c, m, wall in windows:
            log(f"leg TU: window {','.join(f'{k}={getattr(c, k)}' for k in sorted(TU_AXES))}: "
                f"span step_ms {m['step_ms']:.3f}, wall_s / steps {m['wall_step_ms']:.3f} ms, "
                f"bubble {m['bubble_frac']:.4f}, effective {m['effective_step_ms']:.3f} ms "
                f"(scored on the {m['scored_on']}), score {m['score']:.1f} acts/s; the window "
                f"{wall:.2f} s with its Trainer's set-up and close")
        log(f"leg TU: gates {[(k, ok, round(ms, 1)) for k, ok, ms in gates]} (knobs, pass, "
            f"ms); winner {art.knobs} (measured {art.measured['score']:.1f}, predicted "
            f"{art.predicted['score']:.1f} acts/s/chip); counters {reg.snapshot()}; tune() "
            f"{t_tune:.1f} s")

        # the rigged violator: topk_k smuggled past STEP_FIELDS (its default,
        # 32, passes; 16 is set back to it by the projection); a stub race
        reg2 = MetricsRegistry()
        k0 = CrossCoderConfig().topk_k
        saved = lattice.STEP_FIELDS
        lattice.STEP_FIELDS = saved - {"topk_k"}
        try:
            rigged = tune(cfg.replace(topk_k=k0), "train", axes={"topk_k": (k0, 16)}, top_k=2,
                          registry=reg2, measure=lambda c, **kw: {"score": 1.0}, gate=gate,
                          device="cuda")
        finally:
            lattice.STEP_FIELDS = saved
        bad = [r for r in rigged.search["candidates"] if r["gate"] == "rejected"]
        if (reg2.get_count("tune/rejected_contract") != 1 or [r["knobs"] for r in bad]
                != [{"topk_k": 16}] or rigged.knobs != {"topk_k": k0}):
            fail(f"phase 19: leg TU's smuggled topk_k was not rejected once: "
                 f"{reg2.snapshot()}, {rigged.search['candidates']}")
        log(f"leg TU: topk_k=16 smuggled past STEP_FIELDS: rejected, counted "
            f"{reg2.snapshot()}; findings {bad[0]['findings'][:3]}")

        # --tuned against the winner's knobs as flags, through from_cli
        base = work / "train.json"
        cfg.to_json(base)
        cfg_t = CrossCoderConfig.from_cli(["--config-json", str(base), "--tuned", str(path)])
        cfg_h = CrossCoderConfig.from_cli(
            ["--config-json", str(base)] + [x for k, v in art.knobs.items() for x in _flag(k, v)])
        t0 = time.perf_counter()
        bits_t, state_t = _tu_trainer(torch, cfg_t, TU_TRAINER_STEPS)
        bits_h, state_h = _tu_trainer(torch, cfg_h, TU_TRAINER_STEPS)
        same, what = state_bits_equal(torch, state_t, state_h)
        if bits_t != bits_h or not same:
            fail(f"phase 19: leg TU: the --tuned Trainer differs from the hand-flagged one: "
                 f"losses {bits_t} against {bits_h}; state {what}")
        del state_t, state_h
        losses = [float(np.array(b, np.int32).view(np.float32)) for b in bits_t]
        choice = FleetPolicy(cfg_t).choose(1)
        if choice.detail.get("policy") != "tuned":
            fail(f"phase 19: leg TU: FleetPolicy with the artifact pinned chose {choice}")
        flags = {k: getattr(cfg_h, k) for k in sorted(TU_AXES)}
        log(f"leg TU: --tuned and the flags {flags}: {TU_TRAINER_STEPS} steps each, losses {[round(x, 4) for x in losses]} and state "
            f"bitwise ({time.perf_counter() - t0:.1f} s); FleetPolicy.choose(1) {choice}")
        launches = {n: c.launches for n, c in counters.items() if c.launches}
        q_ms = quantum_host_ms(torch, np)
        log(f"leg TU: one harvest quantum's host time (SegmentedHarvest.step(), 3 blocks, "
            f"[4, 1024], the card idle before it): median {np.median(q_ms):.3f} ms over "
            f"{len(q_ms)} quanta {[round(x, 3) for x in q_ms]} ({card})")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for k in EL_KERNELS:
        if not launches.get(k):
            fail(f"phase 19: leg TU did not launch {k}: {launches}")
    wall = time.perf_counter() - t_phase
    log(f"leg TU: launches {launches}; tuner phase {wall:.1f} s (the phase's budget "
        f"{TU_PHASE_S:.0f} s; {card})")
    return {k: launches[k] for k in EL_KERNELS}


# ---------------------------------------------------------------------------
# phase 20: leg CC, the compile tier (utils/compile_cache.py under
# ops/_build.py) in fresh processes over a fresh tier under build/: two cold
# processes run serve.warm_start at the serve phase's full width at the same
# moment (one nvcc a source across both), then a third, warm one (every
# library loaded from the tier, no nvcc); the first and the third also take
# CC_STEPS steps at leg A's config. The warm process reaches the card beside
# the cold pair and waits for the go to touch the tier
CC_SERVE = dict(serve_max_batch=8, seq_len=1024, hook_points=("blocks.14.hook_resid_pre",),
                seeds=(1, 2, 3), dict_size=2 ** 14, topk_k=32, page_size=64, enc_dtype="bf16")
CC_LENGTHS = (1, 1024, 517, 64, 300, 999, 2, 800)
CC_STEPS = 2
CC_ROLES = ("cold-a", "cold-b", "warm")
CC_SERVE_KERNELS = ("paged_attention", "fused_topk_encode")
CC_PHASE_S = 60.0


def _checksum(torch, t):
    """The int64 sum of a tensor's 32-bit (16-bit, byte) words: its bits'
    fingerprint across processes, summed on the card."""
    v = t.detach().contiguous().view(-1)
    w = {4: torch.int32, 2: torch.int16}.get(v.element_size(), torch.uint8)
    return int(v.view(w).to(torch.int64).sum())


def cc_worker(role, tier, out, go):
    """One process of leg CC: ``serve.warm_start.run`` against ``tier`` at
    the serve phase's width, one batch of CC_LENGTHS served, and (cold-a,
    warm) CC_STEPS Trainer steps at leg A's config over the tier; writes its
    report as JSON to ``out``. With ``go`` it first reaches the card, then
    waits for that file before it touches the tier."""
    import hashlib

    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    torch.zeros(1, device="cuda")
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.models import lm
    from crosscoder_tpu_torch.ops import _build
    from crosscoder_tpu_torch.ops import paged_attention as pa
    from crosscoder_tpu_torch.serve import smoke, warm_start
    from crosscoder_tpu_torch.train.trainer import Trainer
    from crosscoder_tpu_torch.utils import compile_cache

    rep = {"role": role, "ready_s": time.perf_counter() - t0}
    if go != "-":
        deadline = time.monotonic() + 600
        while not Path(go).exists():
            if time.monotonic() > deadline:
                raise TimeoutError("leg CC: the warm process got no go")
            time.sleep(0.02)
    t_go = time.perf_counter()
    counters = {**launch_counters(), "paged_attention": pa.paged_attention}
    reset_counters(counters)
    report, eng = warm_start.run(str(tier), return_engine=True, lm_cfg=lm.LMConfig.gemma2_2b(),
                                 device="cuda", **CC_SERVE)
    rng = np.random.default_rng(20)
    docs = [rng.integers(1, eng.lm_cfg.vocab_size, size=n, dtype=np.int32) for n in CC_LENGTHS]
    served = smoke.serve_batch(eng, docs)
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for r in served:
        for a in (r.vals, r.idx, r.diff):
            h.update(np.ascontiguousarray(a).tobytes())
    rep.update(warm_start=report, serve_sha=h.hexdigest(), serve_s=time.perf_counter() - t_go,
               serve_compiles_after_warmup=eng.stats()["serve_compiles_after_warmup"],
               serve_launches={n: c.launches for n, c in counters.items() if c.launches},
               runs_serve=dict(_build.nvcc_runs))
    del eng, served
    torch.cuda.empty_cache()
    if role != "cold-b":
        reset_counters(counters)
        tr = Trainer(CrossCoderConfig(**TRAIN, compile_cache_dir=str(tier)), device="cuda")
        try:
            losses = [float(tr.step()["loss"]).hex() for _ in range(CC_STEPS)]
            torch.cuda.synchronize()
            st = tr.state
            sums = {f"{what}/{k}": _checksum(torch, t)
                    for what, leaves in (("params", st.params), ("mu", st.opt_state.mu),
                                         ("nu", st.opt_state.nu))
                    for k, t in sorted(leaves.items())}
        finally:
            tr.close()
        rep.update(losses=losses, checksums=sums,
                   step_launches={n: c.launches for n, c in counters.items() if c.launches})
    rep.update(runs=dict(_build.nvcc_runs), stats=compile_cache.disk_stats(),
               entries=compile_cache.disk_entry_count(), wall_s=time.perf_counter() - t0)
    if role == "warm":
        rep["costs"] = {n: _build.library_cost(n) for n in _build.kernel_names()}
    Path(out).write_text(json.dumps(rep))


def _kernel_name(mangled):
    """The last name of an Itanium-mangled entry point (its anonymous
    namespaces dropped), with ``<>`` for a template: ``rpa_wg_kernel<>``."""
    i = 3 if mangled.startswith("_ZN") else 2 if mangled.startswith("_Z") else 0
    if not i:
        return mangled
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    return name + ("<>" if mangled[i:i + 1] == "I" else "")


def _cc_logs(work):
    for f in sorted(Path(work).glob("*.err")):
        lines = [ln for ln in f.read_text(errors="replace").splitlines() if ln.strip()]
        log(f"  {f.name}: " + " | ".join(lines[-12:])[-2500:])


def compile_tier(torch, np, root, card):
    """Phase 20: leg CC. Returns each kernel's launches across its processes."""
    from crosscoder_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    (root / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_cc_", dir=root / "build"))
    tier, go = work / "tier", work / "go"
    procs = {}
    try:
        for role in CC_ROLES:
            err = open(work / f"{role}.err", "w")
            cmd = [sys.executable, str(root / "chip_smoke.py"), "--cc-worker", role, str(tier),
                   str(work / f"{role}.json"), str(go) if role == "warm" else "-"]
            procs[role] = (subprocess.Popen(cmd, stdout=err, stderr=subprocess.STDOUT,
                                            cwd=str(root)), err)
        rcs = {role: procs[role][0].wait(timeout=400) for role in CC_ROLES[:2]}
        t_cold = time.perf_counter() - t_phase
        go.write_text("go")
        rcs["warm"] = procs["warm"][0].wait(timeout=300)
        if any(rcs.values()):
            _cc_logs(work)
            fail(f"phase 20: a leg CC process failed: exit codes {rcs}")
        reps = {role: json.loads((work / f"{role}.json").read_text()) for role in CC_ROLES}
    finally:
        for p, err in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            err.close()
        shutil.rmtree(work, ignore_errors=True)
    names = _build.kernel_names()
    a, b, w = (reps[r] for r in CC_ROLES)
    cold_runs = {n: a["runs"].get(n, 0) + b["runs"].get(n, 0) for n in names}
    if cold_runs != dict.fromkeys(names, 1) or set(a["runs"]) | set(b["runs"]) != set(names):
        fail(f"phase 20: the two cold processes ran nvcc {cold_runs} times a source, not once "
             f"each: {a['runs']}, {b['runs']}")
    ws = w["warm_start"]
    if (ws["compiles"], ws["disk_hits"], ws["disk_misses"], w["runs"]) != (0, len(names), 0, {}):
        fail(f"phase 20: the warm process: {ws}, nvcc runs {w['runs']} (want 0 compiles and "
             f"{len(names)} disk hits)")
    for r in (a, b):
        hits, misses = r["stats"]["disk_hit"], r["stats"]["disk_miss"]
        if hits + sum(r["runs"].values()) != len(names) or r["runs"] != r["runs_serve"]:
            fail(f"phase 20: {r['role']}: disk {r['stats']}, nvcc {r['runs']} (after the "
                 f"serve {r['runs_serve']})")
    shas = {r["role"]: r["serve_sha"] for r in (a, b, w)}
    if len(set(shas.values())) != 1:
        fail(f"phase 20: the served results differ across the processes: {shas}")
    if (a["losses"], a["checksums"]) != (w["losses"], w["checksums"]):
        diff = [k for k in a["checksums"] if a["checksums"][k] != w["checksums"].get(k)]
        fail(f"phase 20: the warm process's steps are not the cold one's: losses "
             f"{a['losses']} against {w['losses']}; leaves differing {diff}")
    for r in (a, b, w):
        if r["serve_compiles_after_warmup"] or r["entries"] != len(names):
            fail(f"phase 20: {r['role']}: compiles after the warmup "
                 f"{r['serve_compiles_after_warmup']}, tier entries {r['entries']}")
        if any(not r["serve_launches"].get(k) for k in CC_SERVE_KERNELS):
            fail(f"phase 20: {r['role']} served without a kernel: {r['serve_launches']}")
    for r in (a, w):
        if any(not r["step_launches"].get(k) for k in EL_KERNELS) \
                or r["step_launches"]["adam_update"] != CC_STEPS:
            fail(f"phase 20: {r['role']}'s steps did not launch every kernel of the step: "
                 f"{r['step_launches']}")
    log(f"leg CC: warm_start at Gemma-2-2B width (14 layers, buckets to 8, seq_len 1024): "
        f"warmup_ms cold {a['warm_start']['warmup_ms']} and {b['warm_start']['warmup_ms']} "
        f"(nvcc runs {sum(a['runs'].values())} and {sum(b['runs'].values())}, disk hits "
        f"{a['stats']['disk_hit']} and {b['stats']['disk_hit']}), warm {ws['warmup_ms']} (nvcc "
        f"runs 0, disk hits {ws['disk_hits']}, entries {ws['disk_entries']}) ({card})")
    log(f"leg CC: the served batch (lengths {list(CC_LENGTHS)}) bitwise across the three "
        f"processes (sha256 {a['serve_sha'][:16]}); {CC_STEPS} steps at leg A's config "
        f"bitwise cold and warm (losses {[round(float.fromhex(x), 4) for x in w['losses']]}, "
        f"{len(w['checksums'])} leaves' checksums); launches: serve {a['serve_launches']}, "
        f"{b['serve_launches']}, {w['serve_launches']}; steps {a['step_launches']}, "
        f"{w['step_launches']}")
    log(f"leg CC: processes (s: to the card, wall) "
        f"{[(r['role'], round(r['ready_s'], 1), round(r['wall_s'], 1)) for r in (a, b, w)]}; "
        f"the cold pair done {t_cold:.1f} s into the phase")
    for n in names:
        entries = (w["costs"].get(n) or {}).get("entries", {})
        log(f"leg CC: sidecar {n}: " + "; ".join(
            f"{_kernel_name(fn)} {e['registers']} regs, spill {e.get('spill_stores', 0)}/"
            f"{e.get('spill_loads', 0)} B, smem {e.get('smem_bytes', 0)} B"
            for fn, e in sorted(entries.items()) if "registers" in e))
    wall = time.perf_counter() - t_phase
    log(f"compile tier phase {wall:.1f} s (the phase's budget {CC_PHASE_S:.0f} s; {card})")
    launches = {k: sum(r["serve_launches"].get(k, 0) for r in (a, b, w))
                for k in CC_SERVE_KERNELS}
    launches.update({k: a["step_launches"][k] + w["step_launches"][k] for k in EL_KERNELS})
    return launches


# ---------------------------------------------------------------------------
# phase 21: the static correctness plane (crosscoder_tpu_torch/analysis/
# contracts) on the card: lints and cache keys over the checkout, the step
# lattice at leg A's config, the fused-live train step at leg B's and the
# serve encode at the serve phase's width, the kernel probes in a fresh
# process beside them
CT_SERVE = dict(d_in=2304, n_models=2, hook_point="blocks.14.hook_resid_pre",
                dict_size=2 ** 14, topk_k=32, batch_size=8, enc_dtype="bf16", activation="topk",
                l1_coeff=0.0, sparse_bwd="on", fused_encoder="on", serve="on")
CT_FUSED = dict(TRAIN, fused_encoder="on", aux_k=0, aux_every=1)
CT_STEP_KERNELS = ("topk_mask", "sparsify", "scatter_add_rows", "adam_update",
                   "fused_topk_encode")
CT_PHASE_S = 120.0


def contracts(torch, np, root, card):
    """Phase 21. Returns ``({"main": launches of the recorded train steps,
    "serve": of the serve encode}, the contracts line)``."""
    from crosscoder_tpu_torch.analysis.contracts import (AST_RULES, CACHE_RULES, KERNEL_RULES,
                                                         STEP_RULES, Report,
                                                         build_cache_key_context,
                                                         build_source_context, kernel_safety,
                                                         run_rules, step_rules)
    from crosscoder_tpu_torch.config import CrossCoderConfig

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    report = Report()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        kfut = pool.submit(kernel_safety.run_kernel_probes, "cuda")
        t0 = time.perf_counter()
        report.merge(run_rules(AST_RULES, build_source_context(root)))
        report.merge(run_rules(CACHE_RULES, build_cache_key_context()))
        t_lints = time.perf_counter() - t0
        counters = launch_counters()
        reset_counters(counters)
        t0 = time.perf_counter()
        sctx = step_rules.build_step_context("cuda", full=False, base=dict(TRAIN))
        # leg B's fused TopK step without its AuxK term: an AuxK step keeps the
        # dense encode by design (its dead-latent ranking reads the pre-acts)
        step_rules.add_fused_live(sctx, CrossCoderConfig(**CT_FUSED), "cuda",
                                  label="topk:fused_live (leg B)")
        main_l = {n: c.launches for n, c in counters.items() if c.launches}
        reset_counters(counters)
        scfg = CrossCoderConfig(**CT_SERVE)
        sctx.add("serve:encode_fused", step_rules.record_serve_step(scfg, "cuda"),
                 step_rules.VariantMeta(serve_step=True,
                                        forbid_dense_shape=(scfg.batch_size, scfg.dict_size)))
        serve_l = {n: c.launches for n, c in counters.items() if c.launches}
        torch.cuda.synchronize()
        t_steps = time.perf_counter() - t0
        steps = run_rules(STEP_RULES, sctx)
        report.merge(steps)
        kctx = kfut.result()
    t_kernels = time.perf_counter() - t_phase
    kernels = run_rules(KERNEL_RULES, kctx)
    kernels.info.update(kernel_safety.smem_summary(kctx))
    report.merge(kernels)
    for f in report.findings:
        log(f"contracts: {'ERROR' if f.severity == 'error' else 'warn '} {f}"[:1500])
    skipped = {r: kctx.skip_reasons.get(r, "") for r in report.skipped}
    for r, why in skipped.items():
        log(f"contracts: skipped {r}: {why}")
    table = kernel_safety.launch_table(kctx)
    for row in table:
        log(f"contracts: launch {row['library']}/{row['kernel']} ({row['probe']}): grid "
            f"{row['grid']}, block {row['block']}, cluster {row['cluster']}, "
            f"{row['registers']} regs, smem {row['smem']} B, occupancy {row['occupancy']} "
            f"(trace's estimate {row['est_occupancy_pct']}%)")
    log(f"contracts: tail probes against their plain versions "
        f"{ {k: d for k, (_, d) in sorted(kctx.tail_bars.items())} }; bitwise twice "
        f"{sum(kctx.repeats.values())} of {len(kctx.repeats)}")
    for tool, got in sorted(kctx.sanitizer.items()):
        log(f"contracts: compute-sanitizer --tool {tool}: {got['errors']} errors, exit "
            f"{got['rc']}, {got['seconds']:.1f} s")
    if not report.ok:
        fail(f"phase 21: {sum(f.severity == 'error' for f in report.findings)} error-severity "
             f"contract findings (above)")
    allowed = set(kernel_safety.SANITIZER_RULES.values())
    if set(skipped) - allowed or any(not why for why in skipped.values()):
        fail(f"phase 21: rules skipped on the card: {skipped}")
    missed = [p for p, (ok, _) in kctx.tail_bars.items() if not ok] + [
        p for p, same in kctx.repeats.items() if not same]
    if missed or len(kctx.tail_bars) != len(kernel_safety.tail_probes()):
        fail(f"phase 21: tail probes missed their bar or differed twice: {missed}; checked "
             f"{sorted(kctx.tail_bars)}")
    if any(not main_l.get(k) for k in CT_STEP_KERNELS) or not serve_l.get("fused_topk_encode"):
        fail(f"phase 21: the recorded steps did not launch every kernel: {main_l}, {serve_l}")
    wall = time.perf_counter() - t_phase
    log(f"contracts: {len(report.checked)} rules checked, {len(report.skipped)} skipped, "
        f"{len(report.suppressed)} suppressed, {len(report.findings)} findings (warnings only); "
        f"{len(sctx.ops)} step variants recorded ({len(sctx.identity_pairs)} identity pairs); "
        f"{len(kctx.launches)} kernel launches captured over {len(table)} distinct launches; "
        f"lints and cache keys {t_lints:.1f} s, steps {t_steps:.1f} s, kernel probes done "
        f"{t_kernels:.1f} s into the phase; launches: steps {main_l}, serve encode {serve_l}; "
        f"phase {wall:.1f} s (the phase's budget {CT_PHASE_S:.0f} s; {card})")
    line = {"contracts": {
        "checked": report.checked, "skipped": skipped, "suppressed": report.suppressed,
        "warnings": [str(f) for f in report.findings], "launch_table": table,
        "seconds": round(wall, 1)}}
    return {"main": main_l, "serve": serve_l}, line


def main() -> int:
    if sys.argv[1:2] == ["--gloo-rank"]:     # rank 1 of leg FM at 1 x 2 (phase 13)
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        gloo_rank_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        return 0
    if sys.argv[1:2] == ["--fleet-rank"]:    # rank 1 of leg FG at 1 x 2 (phase 15)
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        fleet_rank_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        return 0
    if sys.argv[1:2] == ["--comm-model"]:    # leg CM's fake group (phase 15)
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        comm_worker(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--cc-worker"]:     # a process of leg CC (phase 20)
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        cc_worker(*sys.argv[2:6])
        return 0
    if sys.argv[1:2] == ["--cpu-rank"]:      # a rank of the CPU rehearsal (phase 11)
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        r, world, port, out, grid = sys.argv[2:7]
        cpu_rank_worker(int(r), int(world), port, out, tuple(int(g) for g in grid.split("x")))
        return 0
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke drives the port on the card")
    root = Path(__file__).resolve().parent
    if not (root / "crosscoder_tpu_torch" / "__init__.py").is_file():
        fail(f"crosscoder_tpu_torch not found beside {Path(__file__).name}")
    sys.path.insert(0, str(root))
    import numpy as np

    from crosscoder_tpu_torch.ops import _build
    from crosscoder_tpu_torch.ops import fused_encoder_topk as fek
    from crosscoder_tpu_torch.ops import paged_attention as pa
    from crosscoder_tpu_torch.ops import quant
    from crosscoder_tpu_torch.ops import sparse_grad as sg
    from crosscoder_tpu_torch.ops import topk_pallas as tp

    # parity is measured in full fp32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} ({card}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    rng = np.random.default_rng(3)
    lengths_a = [1, 1024] + [int(n) for n in rng.integers(2, 1024, size=6)]
    row_k1, row_k1_f32 = check_paged_attention(torch, pa, lengths_a)
    rows = [row_k1, check_fused_topk(torch, fek)]
    row_k10, row_k10_aux = check_scatter(torch, sg)
    train_rows = [*check_topk_mask_and_sparsify(torch, tp), row_k10,
                  check_fused_topk_train(torch, fek)]
    fused_rows = [check_fused_topk_q(torch, fek), *check_fused_batchtopk(torch, fek)]
    check_tile_edges(torch, fek)
    harvest_rows = check_batchtopk(torch, tp)
    quant_rows = check_quantize(torch, quant)
    wide_rows = check_topk_wide(torch, tp)
    drain_rows = check_sparsify_shapes(torch, tp)
    launches, eng = serve(torch, np, lengths_a)
    for row in (*rows, row_k1_f32):
        row["launches"] = launches[row["name"]]
    launches = replica_leg(torch, np, eng)
    del eng
    for row in rows:
        row["launches"] += launches[row["name"]]
    launches, batches, row_o1 = train(torch, np)
    o1 = launches["adam_update"]                 # each leg's O1 launches, counted from 0
    for row in train_rows:
        row["launches"] = launches[row["name"].split()[0]]
    windows = [launches["by route"]]             # K8/K11 by route, each leg's counts from 0
    legs = train_wide(torch, np, root, batches)
    del batches
    wide_rows[0]["launches"] = legs["F"]["topk_mask_f32"]
    wide_rows[1]["launches"] = legs["K7 by route"]["W"]["cluster"]
    wide_rows[2]["launches"] = legs["K7 by route"]["V"]["cluster"]
    wide_rows[3]["launches"] = sum(r["streaming"] for r in legs["K7 by route"].values())
    row_k10_aux["launches"] = legs["F"]["scatter_add_rows (AuxK shape)"]
    for row, leg in zip(drain_rows, ("W", "F", "V")):
        row["launches"] = legs[leg]["sparsify"]
    windows += [legs[leg]["by route"] for leg in ("F", "W", "V")]
    o1 += sum(legs[leg]["adam_update"] for leg in ("F", "W", "V"))
    launches, leg_h = harvest_train(torch, np, root)
    o1 += launches["adam_update"]
    for row in harvest_rows:
        row["launches"] = launches[row["name"]]
    fused = launches["fused legs"]
    o1 += sum(leg["adam_update"] for leg in fused.values())
    windows += [launches["by route"], *(leg["by route"] for leg in fused.values())]
    drain_rows[-1]["launches"] = sum(w["sparsify"]["warp"] for w in windows)
    wide_rows[0]["launches"] += analysis(torch, np, root)["topk_mask_f32"]
    train_rows[1]["launches"] += fused["I"]["sparsify"]  # leg I's aux steps: the same shape, k
    i_routes = fused["I"]["by route"]["quantize_rows"]
    quant_rows[0]["launches"] = launches["quantize_rows"]
    quant_rows[1]["launches"] = i_routes["column"]
    quant_rows[2]["launches"] = i_routes["row"]
    fused_rows[0]["launches"] = fused["I"]["fused_topk_encode_q"]
    fused_rows[1]["launches"] = fused["K"]["fused_batchtopk_select"]
    fused_rows[2]["launches"] = fused["K"]["fused_batchtopk_emit"]
    row_k1_harvest, plane = data_plane(torch, np, root, leg_h)
    del leg_h
    row_k1_harvest["launches"] = plane["P"]["paged_attention"]
    o1 += plane["S"]["adam_update"] + plane["P"]["adam_update"]
    legs, row_o1_mixed = recovery(torch, np, root)
    d15, d17 = legs["D"][2 ** 15], legs["D"][2 ** 17]
    for leg in (d15, legs["R"], legs["G"]):
        for row in train_rows[:3]:
            row["launches"] += leg.get(row["name"].split()[0], 0)
    wide_rows[1]["launches"] += d17.get("topk_chunked", 0)
    drain_rows[0]["launches"] += d17.get("sparsify", 0)
    for row in harvest_rows:
        row["launches"] += legs["J"].get(row["name"], 0)
    row_o1["launches"] = o1 + sum(leg.get("adam_update", 0)
                                  for leg in (legs["J"], d15, d17, legs["R"], legs["G"]))
    mesh_legs, row_k11_exchange, _ = parallel(torch, np, root)
    mesh_legs["MS and SS"] = parallel_harvest(torch, np, root)
    rest, _ = mesh_rest(torch, np, root)
    row_k1_harvest["launches"] += rest.pop("PT")["paged_attention"]
    for row, name in ((train_rows[3], "fused_topk_encode"),
                      (fused_rows[0], "fused_topk_encode_q"),
                      (fused_rows[1], "fused_batchtopk_select"),
                      (fused_rows[2], "fused_batchtopk_emit"),
                      (fused_rows[3], "fused_batchtopk_count")):
        row["launches"] = (row["launches"] or 0) + sum(leg.get(name, 0) for leg in rest.values())
    for leg in rest.values():           # K3's legs: K11 on its operands, by route
        routes = leg.pop("by route", None)
        if routes:
            quant_rows[1]["launches"] += routes["quantize_rows"]["column"]
            quant_rows[2]["launches"] += routes["quantize_rows"]["row"]
    quant_rows[0]["launches"] += rest["OV int8"].get("quantize_rows", 0)
    for name in ("fused_batchtopk_select", "fused_batchtopk_count", "fused_batchtopk_emit"):
        if not rest["FM K4"].get(name):
            fail(f"phase 13: {name} never launched on leg FM's BatchTopK path")
    mesh_legs.update(rest)
    for leg in mesh_legs.values():
        for row in (*train_rows[:3], *harvest_rows):
            row["launches"] += leg.get(row["name"].split()[0], 0)
        row_o1["launches"] += leg.get("adam_update", 0)
    quant_rows[0]["launches"] += mesh_legs["MS and SS"].get("quantize_rows", 0)
    fleet_launches, row_o1_cohort = fleet(torch, np, root)
    for row in (*train_rows[:3], *harvest_rows):
        row["launches"] += fleet_launches.get(row["name"].split()[0], 0)
    # the bucket's O1 launches are solo updates; the cohort's have their row
    row_o1["launches"] += fleet_launches["adam_update"] - row_o1_cohort["launches"]
    wired = wire(torch, np, root, card)
    for row in (*train_rows[:3], *harvest_rows):
        row["launches"] += wired.get(row["name"].split()[0], 0)
    row_o1["launches"] += wired["adam_update"] - wired["O1 cohort"]
    row_o1_cohort["launches"] += wired["O1 cohort"]
    watched = obs_resilience(torch, np, root, card)
    for row in (*train_rows[:3], *harvest_rows):
        row["launches"] += watched.get(row["name"].split()[0], 0)
    row_o1["launches"] += watched["adam_update"]
    shrunk = elastic(torch, np, root, card)
    for row in train_rows[:3]:
        row["launches"] += shrunk[row["name"].split()[0]]
    row_o1["launches"] += shrunk["adam_update"]
    grown = autoscale(torch, np, root, card)
    for row in train_rows[:3]:
        row["launches"] += grown[row["name"].split()[0]]
    row_o1["launches"] += grown["adam_update"]
    tuned = tuner(torch, np, root, card)
    for row in train_rows[:3]:
        row["launches"] += tuned[row["name"].split()[0]]
    row_o1["launches"] += tuned["adam_update"]
    tiered = compile_tier(torch, np, root, card)
    rows[0]["launches"] += tiered["paged_attention"]
    rows[1]["launches"] += tiered["fused_topk_encode"]
    for row in train_rows[:3]:
        row["launches"] += tiered[row["name"].split()[0]]
    row_o1["launches"] += tiered["adam_update"]
    contracted, contracts_line = contracts(torch, np, root, card)
    main_l, serve_l = contracted["main"], contracted["serve"]
    rows[1]["launches"] += serve_l["fused_topk_encode"]
    train_rows[3]["launches"] += main_l["fused_topk_encode"]
    for row in (*train_rows[:3], *harvest_rows):
        row["launches"] += main_l.get(row["name"].split()[0], 0)
    wide_rows[0]["launches"] += main_l.get("topk_mask_f32", 0)
    row_o1["launches"] += main_l["adam_update"]
    rows += ([row_k1_f32, row_k1_harvest, *train_rows, *drain_rows, row_k10_aux, *harvest_rows,
              *quant_rows, row_k11_exchange, *wide_rows, *fused_rows, row_o1, row_o1_mixed,
              row_o1_cohort])
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(contracts_line), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
