#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py        # from the root of a checkout

Phases, each printing one line of results; any failure exits non-zero:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: every CUDA source under src/repro_torch/kernels/csrc compiled by
   nvcc for sm_90a, one nvcc each, in parallel; each redesigned kernel
   instance's registers and spill bytes (none may spill): flash_mma_kernel,
   decode_split_kernel (contiguous and paged), ragged_split_kernel (the
   split walk and the run walk), aot_gather_add_kernel (both gather-adds
   with and without the fused norm, and the norm alone);
3. parity: each kernel's public wrapper against its plain PyTorch version
   on the card at smollm-360m's shapes (both gather-adds bitwise, the
   single-table one's NaN rows for ids outside [-V, V) included; fused
   with the norm, h_out bitwise and x within the tolerance below, the norm
   alone on the sum bitwise that x, the single-table and multi-task
   entries bitwise equal on the same rows; attention and norms within 2e-5
   in float32 and 2e-2 in bfloat16), for both the
   16-byte-load and the one-element-load build where a kernel has both:
   ragged paged attention (every packing of packings(), among them runs
   that the plan gives one cluster each: four chunks at unaligned
   offsets, runs of 1 and 5, a run across pages from position 27, a run
   ending at 1023, positions past the table, dead padding between runs; at
   pages of 16, 8 and 32, hd 60 / 64 / 128 and g 8, and at phase 10's
   heads (h32 kvh8 hd80, h16 kvh16 hd128, h40 kvh8 hd128, the last also
   llama4's) and phase 11's qwen3-moe (h32 kvh4 hd128, g 8), as
   contiguous and paged decode are too; every packing bitwise equal to
   paged decode with cur_len = pos + 1, ROADMAP C4); flash attention
   (causal, full, window; sq = skv
   in {1, 37, 100, 512, 577}, sq != skv either way, hd 32, 60, 96, 128,
   a strided q, a misaligned q, g 8; full mode at g = 1, the encoders' 16
   heads over 16, at s 1, 37, 384, 512 and 577; queries from an offset
   over sq + offset keys, P-Tuning v2's prefill, with and without a
   window, and in full mode at g = 1; phase 10's decoders' heads: h32
   kvh8 hd80 causal and with danube's window of 4096 over 6144, h16 kvh16
   hd128, h40 kvh8 hd128; phase 11's h32 kvh4 hd128 causal at 577 and
   4 x 512; phase 12's recurrentgemma, h16 kvh1 at hd 256 (the hd 256
   build) with its window of 2048 over 4 x 3072, causal and full, at 577,
   hd 250 and misaligned, and hd 256 at g 1 and g 8); contiguous decode
   at hd 256 with g 16 (two clusters of 8 heads), 8 and 3 over
   recurrentgemma's wrapped 2048-row ring and the split cases, hd 250 and
   a misaligned cache, and hd 128 at g 16 and 12 (WIDE_VARIANTS); phase
   13's shapes: flash in full mode at hubert's h16 kvh16 hd80 (g 1) over
   8 x 512 and 577, contiguous decode at paligemma's h8 kvh1 hd256 (g 8)
   over b 4, S 1024, the fused multi-task gather-add at d 2048 over 2
   tasks of V 257216 (bitwise), the single-table gather-add's plain mode
   at d 1280 over V 504 (bitwise), and the route of a bidirectional
   prefix, layers.attention_chunked (plain PyTorch: the wrapper's one
   block and chunks of 128), on the card against layers.attention_ref on
   the card within 2e-5 in float32 at a prefix of 256 over 512 and 577;
   the
   fused multi-task gather-add at phase 11's widths (d 2048
   over V 151936, d 5120 over V 202048, 2 tasks), bitwise; both
   gather-adds in their plain
   mode (no norm: the encoders' post-LN blocks) at d 1024 and the
   encoders' vocabularies 50265 and 128100, bitwise;
   contiguous decode (scalar and per-row lengths with 0, 1 and ragged
   depths, S = 1024; lengths at and on either side of the cluster's block
   boundaries, 0 and S, at S 300, 1000, 1024, 2048); paged decode (length
   0, lengths that straddle pages, depth 1024; pages of 16, 8 and 32; and
   bitwise equal to contiguous decode over the same K/V wherever the
   capacities match: those lengths and every split case at pages of 4-32
   that divide S); NaN in the K/V that nothing may read (past each
   row's length, scratch page 0) leaves contiguous, paged and ragged
   outputs bitwise as zeros there do, kernel and plain version alike;
   and one slot's query rows after a prefix-cache hit packed warm (a
   chunk from the page-aligned hit) and cold (runs from 0, 200 and 8
   before the hit), each within the tolerance and every row bitwise the
   warm packing's; twelve positions of one slot of 800 (0, a tile's
   edges, the cluster blocks' range edges, 799) as single tokens and
   inside runs from p, p - 1, p - 15, p - 16, p - 40 and 0 beside dead
   tokens and another slot's run, every row bitwise paged decode's with
   cur_len = pos + 1 (ROADMAP C4); and the attention softcap
   (tanh(s / 30) * 30, no kernel takes it) through its plain paths on
   CUDA tensors (the whole-sequence oracle, attention_chunked, contiguous,
   paged and ragged decode at smollm's heads) against the same calls on
   the CPU, float32, within 2e-5;
4. kernel times at the serving paths' shapes (device time from
   torch.profiler), beside the plain version's, one PyTorch library call's
   where there is one, and the least time the card could take (bytes at
   3.35 TB/s, operations at the published peak); the fused gather-adds
   also beside the sequence they replace (the gather-add, then the norm as
   layers.apply_norm launches it), F.rms_norm alone, and host microseconds
   per wrapper call; flash also at one prompt of 512 (a whole-prompt
   stream's prefill); the ragged kernel's plan (host microseconds per
   tick, items); at the encoders' shapes, flash in full mode at g = 1
   over (8, 384) and (1, 512) beside SDPA, and the plain-mode gather-adds
   at T 3072, d 1024; at phase 10's, flash over (1, 6144) at danube's
   heads with its window of 4096 beside SDPA with a bool mask, decode over
   danube's full ring (b 4, S 4096) beside SDPA with a length mask, the
   fused multi-task gather-add at T 263, d 2560 and 5120; at phase 11's
   qwen3-moe heads (h32 kvh4 hd128, g 8), flash over (16, 512) causal and
   contiguous decode beside SDPA, paged decode and ragged attention on
   the serving tick's packings, the fused multi-task gather-add at T 263
   over qwen3-moe's and llama4's tables; at phase 12's recurrentgemma
   heads (h16 kvh1 hd256), flash over 4 x 3072 with the window of 2048,
   causal and full beside SDPA, contiguous decode over the full 2048-row
   ring (b 4) beside SDPA, the fused gather-add at d 4096 (2 tasks of V
   256000) and the plain one at xlstm's d 1024 (4 tasks of V 50304); at
   phase 13's, flash in full mode at h16 kvh16 hd80 over 8 x 512 beside
   SDPA non-causal, contiguous decode at h8 kvh1 hd256 over b 4, S 1024
   beside SDPA with a length mask, the fused gather-add at T 2048 over
   paligemma's tables (8 sets of h and ids rotating, so that h is read
   from HBM) beside F.rms_norm, the plain single-table one at T
   4096, d 1280; and (no kernel) attention_chunked at paligemma's prefill
   beside SDPA with the same bool mask;
5. the paged main path: full-width 32-layer smollm-360m in bfloat16 with 4
   fused tasks serving a Poisson stream through the launcher's own code
   (repro_torch.launch.serve, chunked prefill), greedy, then 4 requests
   sampled at temperature 0.8 / top-p 0.9;
5b. the same greedy stream admitted whole: --layout slots (flash prefill,
   contiguous decode) and --layout paged --prefill-chunk 0 (flash prefill,
   ragged ticks);
5c. the static batch (ServeEngine.generate, the paper's Fig. 3 setting):
   16 prompts of 512 tokens with mixed tasks, 64 new tokens; the same
   prompts as per-task batches; the mixed batch over a paged pool
   (Model.decode_step(block_tables=)). Generated tokens/s of each, and
   16 steps of the mixed batch under the profiler, contiguous and paged;
   in 5-5d every request must finish, every pool must drain clean, and
   each kernel must launch exactly 32 times per call that runs it (counts
   zeroed just before each run): on the AoT paths the fused gather-add +
   norm, elsewhere the norm alone (rms_norm);
5d. the paper's Fig. 3 comparison: 5c's prompts through one
   ServeEngine(peft=...) per method (bare backbone, one task's fused AoT
   tables through the single-table gather-add, BitFit, LoRA unfused and
   fused, adapters, P-Tuning v2): generated tokens/s and its ratio to the
   backbone's, kernels per step and device busy ms from a profiled run;
   the AoT engine's tokens must equal the multi-task engine's with every
   task id 0; then Model.logits at benchmarks/speed_overhead.py's grid,
   P-Tuning v1 among the methods (whole sequences only), one counted call
   each (flash 32 per call, or for P-Tuning v1 flash 0 and 32 calls of
   attention_chunked, its prompt being a bidirectional prefix), time
   ratios to the backbone's (reported, no limit);
5e. the faulted tick: phase 5's greedy stream fault-free (the twin), then
   F1 (an injected alloc_failure on one chunk tick and an exception raised
   after 16 layers of another: every stream bitwise the twin's, 2 faults,
   2 retries), F2 (NaN on one row of a decode-only tick: exactly that
   request quarantined, every survivor's tokens through that tick the
   twin's, shutdown releases the hold clean; whole streams reported),
   F3 (a seeded FaultPlan with every kind but crash, then shutdown with
   work live: drained, leak-free, every kind fired, the survivors the
   twin's requests less the disconnected, quarantined and shed; token
   equality reported); each run's kernels launch exactly 32 times per
   dispatch plus the layers a raised attempt reached;
5f. page sharing and admission policy, through the launcher's client loop
   (SHARED_RUNS): a 384-token system prompt per task without and with the
   prefix cache (cold / warm: the warm run packs fewer prompt tokens by
   the hits' tokens; tokens per request and tokens/s compared, reported);
   n = 4 samples sampled, greedy chunked and greedy whole-prompt (flash):
   forks and copy-on-write copies, greedy forked siblings bitwise equal;
   a small pool whose admissions compaction rescues; a priority mix
   against a bounded queue (queue_full and displaced sheds, retries, a
   preemption for admission). Every run's counts must be the CPU
   replay's (SHARED_EXPECT), every request not shed must finish, the
   pool must drain clean and each kernel launch 32 times per call;
5g. observability and crash recovery, through the launcher's code: phase
   5's greedy stream with metrics and the tick trace off and on in turns
   (every stream bitwise phase 5's; tokens/s of each, the median ms of
   each tick span, TTFT / TPOT in ticks and ms, reported); then with the
   request journal: the crash-free twins, crashes after a tick of the
   first chunks, a mixed tick and a decode-only tick (CRASH_RUNS), an
   n = 4 sampled stream crashed while its forked samples decode, a
   slots-layout live snapshot restored through JSON (flash, contiguous
   decode), and F4 (a seeded FaultPlan with crashes through
   run_chaos(sched_factory=...)). Every count must be the CPU replay's
   (RESTORE_EXPECT), every request finish (F4: the twin's less the
   disconnected and quarantined), pools drain clean, the tokens before
   each crash be the twin's and each kernel launch 32 times per dispatch
   or whole prefill; the tokens after a crash are reported; ROADMAP C4's
   gate: the n = 4 crash run and the same stream served again uncrashed,
   each with a KVWatch, must agree on every sample's stream and every
   K/V row bit for bit (a differing one is named with its layer and the
   path that wrote it in each run: the split walk, or the run of 16 from
   its first position);
6. cross-checks at full width with 2 layers, inputs drawn from a
   generator of their own (seed PHASE6_SEED; chip_seeds.py runs this phase
   at other seeds): one mixed tick, and a prefill plus three decode steps
   (for every method of 5d too), through the kernels and through the plain
   versions fed the kernels' tokens (every logit within the bf16
   tolerance, so a token that differs is a near tie; each line counts
   them); paged against contiguous decode steps from one prefill (same
   tokens); a request served warm from the prefix cache against the same
   request cold (first-token logits and the K/V it wrote within the bf16
   tolerance, bitwise shares reported); copy-on-write under the real tick
   (bitwise: rows below the fork depth, every other page, differing
   appends); a request restored from a JSON snapshot against the same
   request served through (the K/V its recompute wrote and the first
   logits row it decodes from, within the bf16 tolerance, bitwise shares
   reported); preempt-and-recompute parity is reported;
7. the paper's method trained, fused and served, through the training
   launcher's functions (repro_torch.launch.train: float32, TF32 off,
   attn_impl="ref", random backbone seed 0): 7a AoT fc and kron (rank 32)
   each 30 steps of LMStream(seed 0) at seq 128, batch 8, lr 5e-3 (every
   loss finite, the first 5 batches' mean loss under the trained
   parameters below their mean in steps 0-4, for kron also the last 5
   steps' mean loss below the first 5's (other batches; fc moves the loss
   less than the batches differ, so that mean is reported for it), the
   frozen backbone bitwise unchanged, no kernel launched; median ms per
   step, peak memory, trainable parameters reported); 7b the paper's
   protocol,
   a classification head on ClassificationTask(seed 3) for AoT fc and
   BitFit, 60 steps at batch 16, lr 8e-3 (held-out accuracy on 4 batches
   of 32, reported only: the backbone is random); 7c 7a's fc and kron
   parameters fused into float32 tables (forward through the tables
   within 2e-5 of forward through the reparametrizations on 4 x 128
   tokens; ROADMAP C5's line, recorded: the same fusion with GEMMs of the
   forward's shapes, chunks of 512 vocabulary rows, and its error), cast to bf16, stacked as two tasks and served as 8 requests
   of phase 5's stream through the paged tick (every request finishes,
   the pool drains clean, the counts are the CPU replay's, the fused
   gather-add + norm and ragged attention launch 32 times per tick; per
   task, the requests' first-token logits no further from Model.logits
   through the reparametrization in float32 than BF16_FACTOR times the
   same logits computed in plain bf16 PyTorch (attn_impl="ref") are, and
   carrying the task's trained effect on them (the float32 logits less
   the backbone's alone) within CARRY_TOL; two control serves, fc's table
   zeroed and the two tables swapped, must fail that gate in exactly the
   tasks they make wrong; against the plain bf16 logits directly: the max
   error and near ties, reported: at 32 layers no two bf16 orders of the
   same function agree to 2e-2);
8. the paper's own encoders (post-LN, LayerNorm, GELU MLP, learned
   positions, an untied head, full attention), random weights: 8a
   roberta-large at full width (24 layers, bf16) through Model.logits at
   speed_overhead.py's grid for the backbone, one fused AoT task, BitFit,
   LoRA unfused and fused, adapters, P-Tuning v2 and a 4-task mixed
   batch: exactly one flash attention (full mode) and, with AoT, one
   plain gather-add per layer per call, finite logits, ms and the ratio
   to the backbone's (reported), the mixed batch with every task id 0
   bitwise the single-table call; 8b the same methods at full width with
   2 layers through the kernels against the plain versions (every logit
   within the bf16 tolerance, near ties counted); 8c deberta-xl at full
   width (48 layers, V 128100) with and without a fused task (its bf16
   table 11.7 GiB) at (8, 384): finite, 48 launches of each kernel, ms
   and peak memory; 8d phase 7b's protocol on roberta-large with mean
   pooling (AoT fc and BitFit, held-out accuracy reported), AoT fc fused
   and served through the kernels' classify in bf16, gated against the
   float32 reparametrized logits as 7c (within BF16_FACTOR x plain bf16's
   error, the task's effect carried), a zeroed table as a control serve
   that must fail the gate;
9. the paper's lifecycle across processes: 9c (run beside phase 5, on its
   engine) the launcher's overload flags: bursts of 6 (--arrivals bursty,
   the gap derived from --rate) against --max-queue 4 with a class mix,
   --deadline-ticks 24 on latency requests, --max-retries 2 --backoff 2,
   --grace-ticks 8 (Scheduler.shutdown), then the same from two
   --arrival-trace files (without and with a class column): every count
   (sheds by reason, retries, requests that gave up, deadline misses,
   aborts by reason, the drain report) the CPU replay's (OVERLOAD_EXPECT),
   every request finished, given up or aborted, no leak, 32 launches per
   tick; 9a (after phase 7) the training launcher in a process of its own
   for 20 steps with --ckpt-dir, then resumed to 30 in a second: the final
   checkpoint bitwise 7a's fc state (parameters, AdamW's mu, nu and step),
   a state saved and restored in process bitwise, the checkpoint's bytes
   and its save and restore ms reported; 9b 7c's float32 fused tables
   (12.08 GB) written through launch.export.export_tasks after a disk
   check, then served through the launcher's functions with --load in
   bf16 on 7c's stream: every token equal to 7c's in-memory serve, every
   request finished, drained clean, 32 launches per tick; seconds to
   write, load and stage, peak memory reported;
10. the decoder variants at full width in bf16, random weights (seed 0),
   fabricated tables drawn layer by layer on the card, each part's memory
   freed before the next: 10a h2o-danube-1.8b (24 layers, 4 tasks,
   max_len 8192, so a 4096-row ring): a static batch of 4 prompts of 6144
   (one task each), 32 greedy steps through ServeEngine.generate (the
   cache 4096 rows; exact launches; the decode over the ring, teacher-
   forced with generate's tokens, must pick exactly those tokens, and its
   logits per prompt must be within BF16_FACTOR times the bf16 whole
   pass's error of a float32 whole-sequence pass with the window and
   carry the window's effect within CARRY_TOL, while the bf16 pass with
   no window, the control, must fail that in every prompt; the decode
   against the bf16 whole pass is reported, not gated),
   a slots stream of 8 requests of 3000-6000 tokens (buckets 4096 and
   8192: past the window) with 16-48 new tokens on 4 slots (every request
   finished, exact launches, each request's tokens equal to its prompt
   served alone but at a near tie), --layout paged refused with
   InvalidConfig; 10b olmo-1b (16 layers, 4 tasks) and 10c qwen2.5-14b (8
   of its 48 layers: one bf16 table at full depth is 75 GB; 2 tasks, QKV
   biases seeded non-zero): phase 5's paged chunked stream (16 / 8
   requests, greedy: every request finished, drained clean, exact
   launches, each request's tokens equal to its prompt served alone but
   at a near tie) and 5c's static mixed batch (16 x 512 + 64 / 4 x 512 +
   32; exact launches); tokens/s, peak memory, seconds and launches
   reported;
11. the mixture-of-experts decoders at full width in bf16, random weights
   (seed 0), fabricated tables, each part's memory freed before the next,
   MoE routing recorded (Model.record_routes): 11a qwen3-moe-30b-a3b
   (16 of 48 layers: 128 experts top-8, d_ff_expert 768, q/k norm, h32
   kvh4 hd128, V 151936, 2 tasks) on phase 5's paged chunked stream at its
   capacity factor 1.25 (every request finished, drained clean, exact
   launches, no decode-only tick dropping an assignment; the dropped
   share per chunk tick over all tokens and over live ones, and requests
   equal to their prompt served alone, reported), the same stream drop-free
   (capacity factor 128: each request's tokens equal to its prompt served
   alone, or diverging at a near tie of the logits or of the router, the
   first routing difference's swapped experts within 10% in probability),
   5c's static mixed batch (16 x 512 + 64: exact
   launches, the prefill's dropped share), 4 of its prompts over a paged
   pool (16 paged decode steps, exact launches) and AoT's effect on
   routing (the
   share of (token, layer) expert sets each task's table changes); 11b
   llama4-maverick-400b-a17b (one interleave unit: a dense layer of d_ff
   16384, a MoE layer of 128 experts top-1 of 8192 plus a shared expert of
   8192; h40 kvh8 hd128, V 202048, 2 tasks): the stream cut to 8 requests
   and a 4 x 512 + 32 static batch, gated as 11a's; 11c phase 6's checks
   on qwen3-moe at full width with 2 layers, drop-free: one mixed tick and
   a prefill plus three decode steps through the kernels, through the
   plain versions in the same packing and through float32 plain PyTorch,
   the latter two fed the kernels' tokens; the tokens whose expert set
   differs per layer reported (each flip between kernels and plain
   versions a near tie of the router, gated); on the rows that routed
   alike in all three, the kernels' error against float32 within 2x plain
   bf16's (7c's rule, gated); 40 live rows after 24 padding rows equal to
   them alone drop-free (gated) and displaced at 1.25 (reported);
12. the recurrent backbones at full width in bf16, random weights (seed
   0), fabricated tables, static batches only (the paged paths refuse
   them): 12a recurrentgemma-9b (8 of 38 layers: two (rglru, rglru, attn)
   units and the (rglru, rglru) remainder; 2 tasks) on a static mixed
   batch of 4 x 3072 + 32 over its 2048-row ring (exact launches: a flash
   and a decode per attention layer, a fused gather-add per layer; each
   task's rows served as a batch of their own equal to the mixed batch's
   or diverging at a near tie; every recurrent state finite; one AoT
   decode step launching exactly 2 decodes and 8 gather-adds; a step's
   host, wall and device ms and the RG-LRU blocks' host share), then one
   unit (3 layers) with 2 prompts of 2040 and 16 steps past the ring's
   wrap, held to Model.logits by 7c's float32 rule; 12b xlstm-350m (two
   7:1 units, 16 of 24 blocks, 4 tasks) on 5c's static mixed batch (16 x
   512 + 64: exact launches, 16 plain-mode gather-adds per call and no
   attention), its
   prefill and decode steps held to Model.logits by 7c's rule with the
   carried share against plain bf16's, each task's rows against the
   mixed batch's within twice plain bf16's error of float32 (xLSTM's
   bf16 orders part by about that), every state finite; the host share
   of the mLSTM and sLSTM blocks in a step and in the prefill;
13. the two front-ends at full width in bf16, random weights (seed 0),
   each part's memory freed before the next: 13a paligemma-3b at full
   depth (18 layers, 2 fabricated tasks: 37.9 GB of tables), a static
   batch of 4 prompts of 256 stub patches (seeded, over sentinel ids)
   and 256 text tokens through Model.prefill(patches=) and 32 greedy
   decode steps (exact launches: per prefill 18 fused multi-task
   gather-adds and 18 attention_chunked calls for the bidirectional
   prefix, no flash; per step 18 contiguous decodes at h8 kvh1 hd256 and
   18 gather-adds; each task's rows alone equal to the mixed batch's or
   diverging at a near tie; decode steps 0, 8 and 31 held to Model.logits
   with the same patches by 7c's float32 rule; tokens/s, a step's host,
   wall and device ms, peak memory reported); 13b hubert-xlarge at full
   depth (48 layers, 1024 learned positions) on seeded frames (8, 512):
   Model.logits for the backbone, unit-AoT (one fused table (48, 504,
   1280) indexed by seeded unit ids through the plain-mode gather-add),
   BitFit, LoRA, adapters, P-Tuning v1 and v2 (exact launches: 48 flash
   in full mode per call, or 48 attention_chunked calls for P-Tuning v1;
   48 gather-adds for unit-AoT), each by 7c's float32 rule (the backbone
   by its error half), ms and the ratio to the backbone's (Fig. 3,
   reported), then classify through a seeded head by the error rule.
14. distribution on a one-rank NCCL mesh (1 x 1, ("data", "model"), the
   group joined at a free local TCP port): 14a smollm-360m at full width
   (32 layers, bf16), 4 fabricated tasks, a (16, 64) batch of mixed task
   ids through Model.logits on the kernels, unsharded and then with the
   parameters, tables and batch laid out by their logical axes under the
   production rules (the wrappers run on local shards): the largest
   difference (0 or within 2e-2, bf16) and launches equal to the
   unsharded call's, 32 flash and 32 fused multi-task gather-adds; 14b the
   training launcher's --mesh 1x1 run (smollm-360m, float32, AoT fc rank
   32, 3 steps) against the same run without --mesh: losses and trainable
   leaves within 2e-5, and whether bitwise; 14e that run's DTensor state
   saved, restored and laid out again, bitwise; 14c qwen3-moe-30b-a3b's
   MoE layer (d 2048, 128 experts, top-8, f 768) on 1024 tokens in bf16,
   apply_moe_ep at M = 1 against apply_moe_gspmd, drop-free (capacity
   factor 8), within 2e-2, and a finite gradient with respect to x; 14d
   all_reduce_compressed over NCCL bitwise compress_decompress. Each line
   carries the card's name and power limit.
15. the dry run (no kernel; ``--phase15`` runs it alone): 15a
   repro_torch.launch.dryrun in a process of its own per cell, no card,
   pod1 (16 x 16 over a fake group of 256): smollm-360m's train_4k,
   prefill_32k and decode_32k and qwen3-moe-30b-a3b's decode_32k, and
   pod2 (2 x 16 x 16 over 512): smollm-360m's train_4k, each line
   argument and peak GB per rank, FLOPs, bytes, collectives by kind and
   the three roofline terms; pod2's train_4k peak per rank at or under
   pod1's (ROADMAP C15); 15b smollm-360m at full width (32
   layers, bf16, one fused AoT task) built as the dry run builds its
   cells, a prefill at 4 x 4096 and a train step at 4 x 2048 (AoT fc
   rank 64, attn_impl="chunked", remat on), each predicted on a 1 x 1
   fake mesh and then run on the card from its specs made real: the
   bytes the arguments take (the allocator's requested bytes) within 1% +
   2 MiB of the prediction (gated), the call's peak beside the predicted
   one, the ms (CUDA events, warmed up) beside the function's roofline
   bound max(model FLOPs / 989e12, (argument + output bytes) / 3.35e12)
   and beside the eager count's max(FLOPs / 989e12, bytes / 3.35e12)
   (reported); 15c smollm-360m's float32 train step (attn_impl="ref",
   AoT fc rank 64, 3 steps at 2 x 512) with remat on and off: losses and
   trainable leaves bitwise (gated), both peaks and step ms reported.

The last two lines are a JSON line of per-kernel numbers (``launches``:
the count on the path each kernel serves; ``launches_by_path``: every
path's, phase 9's ``overload_*`` and ``lifecycle_load_serve`` among them;
``encoder``: phase 4's times at the encoders' shapes and the launches of
one phase 8a call; ``decoders``: phase 4's times at phase 10's shapes and
the launches of the phase 10 path ``DEC_PATH`` names; ``moe``: phase 4's
times at phase 11's shapes and the launches of the phase 11 path
``MOE_PATH`` names; ``recurrent``: phase 4's times at phase 12's shapes
and the launches of the phase 12 path ``REC_PATH`` names; ``frontends``:
phase 4's times at phase 13's shapes and the launches of the phase 13
path ``FRONT_PATH`` names) and ``{"ok":
true, "device": {...}}``. Details go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from statistics import median

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_TENSOR_FLOPS = 989e12         # dense bf16 tensor-core peak
FP32_FLOPS = 67e12                 # float32 outside the tensor cores
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
H, KVH, HD, BS = 15, 5, 64, 16     # smollm-360m attention, page size
ENC_HEADS = (16, 16)               # roberta-large / deberta-xl: g = 1
ENC_D, ENC_VOCABS = 1024, (50265, 128100)   # their width and vocabularies
DANUBE_HEADS, OLMO_HEADS, QWEN_HEADS = (32, 8), (16, 16), (40, 8)
# phase 11: qwen3-moe-30b-a3b h32 kvh4 hd128 (g = 8); llama4-maverick's
# h40 kvh8 hd128 is qwen2.5's QWEN_HEADS
MOE_HEADS = (32, 4)
# phase 11's fused multi-task tables: (tasks, V, d) of qwen3-moe, llama4
MOE_GATHERS = ((2, 151936, 2048), (2, 202048, 5120))
# phase 12: recurrentgemma-9b's local attention, MQA h16 kvh1 at hd 256 (g
# 16) with a window of 2048 over a 2048-row ring
RGEMMA_HEADS, RGEMMA_HD, RGEMMA_WINDOW = (16, 1), 256, 2048
# phase 13: paligemma-3b's MQA h8 kvh1 hd256 (g 8) over a bidirectional
# prefix of 256 patches, its fused tables (tasks, V, d); hubert-xlarge's
# full attention h16 kvh16 hd80 (g 1), its unit-AoT table (V, d)
PALI_HEADS, PALI_HD, PALI_PREFIX = (8, 1), 256, 256
PALI_GATHER = (2, 257216, 2048)
HUBERT_HEADS, HUBERT_HD = (16, 16), 80
HUBERT_GATHER = (504, 1280)
SLOTS, MAX_LEN = 8, 1024
NPAGES = MAX_LEN // BS
NUM_BLOCKS = SLOTS * NPAGES + 1
DEV = "cuda"
ROTATE = 32                        # layers of inputs a timing cycles through
PROFILE_ATTEMPTS = 6               # traces device_ms takes at most
KERNEL_SOURCES = sorted(p.stem for p in (
    ROOT / "src" / "repro_torch" / "kernels" / "csrc").glob("*.cu"))


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def wall_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean wall time per call of fn(i) run back to back, between two CUDA
    events: host launch overhead included."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Mean device time of fn(i), summed over every CUDA kernel it launches
    (torch.profiler, CUPTI). Every call launches at least one kernel, so a
    trace that holds fewer kernels than calls lost records and is taken
    again, up to ``PROFILE_ATTEMPTS`` traces; raises if none is whole or
    none holds kernel time. Unlike wall_ms, host time between launches does
    not count."""
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        us, kernels = 0.0, 0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                us += getattr(e, "self_device_time_total", 0.0) or 0.0
                kernels += e.count
        if kernels >= iters:
            break
    else:
        raise RuntimeError(f"torch.profiler recorded {kernels} kernels for "
                           f"{iters} calls in each of {PROFILE_ATTEMPTS} "
                           "traces")
    if us <= 0:
        raise RuntimeError("torch.profiler recorded no CUDA kernel time")
    return us / iters / 1e3


# ---------------------------------------------------------------------------
# inputs at the serving tick's shapes
# ---------------------------------------------------------------------------

def packings():
    """(token_rows, token_pos) packings over 8 slots of up to 1024 tokens."""
    decode_pos = [0, 16, 99, 254, 255, 510, 776, 1022]
    out = {"decode_only": (list(range(SLOTS)), decode_pos)}
    rows, pos = [0] * 256, list(range(256))                  # a fresh prompt
    rows += list(range(1, SLOTS))
    pos += decode_pos[1:]
    out["chunk256_decode"] = (rows, pos)
    rows, pos = [1] * 100 + [2] * 60 + [3] * 96, \
        list(range(300, 400)) + list(range(60)) + list(range(500, 596))
    rows += [0, 4, 5, 6]
    pos += [15, 16, 31, 1023]
    n_dead = SLOTS - 1 + 256 - len(rows)
    out["chunks_decode_dead"] = (rows + [0] * n_dead, pos + [-1] * n_dead)
    rows = [2] * 33 + [0, 1, 3, 4]
    pos = list(range(8, 41)) + [15, 16, 31, 32]             # across pages
    out["straddle_pages"] = (rows, pos)
    rows = [5] * 256 + [6, 7]
    pos = list(range(768, 1024)) + [1023, 1000]             # depth 1024
    out["deep_1024"] = (rows, pos)
    # the ragged kernel's plan: runs of one slot at consecutive positions
    # go to one cluster each in runs of 16, other tokens walk alone.
    # Four chunks of unequal lengths at token offsets 4, 41, 111, 120
    # after four decode tokens (the multi-prefill budget split), dead
    # padding to 263
    rows, pos = [4, 5, 6, 7], [17, 300, 64, 1021]
    for slot, lo, n in ((0, 100, 37), (1, 0, 70), (2, 500, 9), (3, 883, 140)):
        rows += [slot] * n
        pos += list(range(lo, lo + n))
    out["four_chunks_unaligned"] = (rows + [0] * (263 - len(rows)),
                                    pos + [-1] * (263 - len(pos)))
    # a run of 1 token and a run of 5 between decode tokens
    out["runs_1_and_5"] = ([0, 1, 2, 2, 2, 2, 2, 3, 4],
                           [40, 77, 200, 201, 202, 203, 204, 9, 640])
    # a run that crosses pages, starting at position 27 (not a multiple of
    # 16) at token offset 3
    out["run_crosses_page_unaligned"] = ([0, 1, 2] + [3] * 34,
                                         [5, 16, 700] + list(range(27, 61)))
    # a run ending at 1023, the table's last position
    out["run_ends_1023"] = ([1] + [6] * 24, [3] + list(range(1000, 1024)))
    # positions past the table (1024 of 1024): a run across the end, and a
    # single token far past it; each sees the whole table
    out["past_table"] = ([7] * 11 + [2, 0], list(range(1020, 1031))
                         + [1500, 12])
    # dead padding between runs, the same slot on either side
    out["dead_between_runs"] = ([0] * 20 + [0] * 5 + [0] * 10 + [0] * 3
                                + [1] * 3,
                                list(range(20)) + [-1] * 5
                                + list(range(20, 30)) + [-1] * 3
                                + [50, 51, 52])
    return out


def misaligned(x):
    """A contiguous copy of x whose data starts one element past a 16-byte
    boundary, so that the kernels take their one-element (not 16-byte)
    loads."""
    y = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    y = y.view(x.shape).copy_(x)
    assert y.is_contiguous() and y.data_ptr() % 16 != 0
    return y


def ragged_inputs(gen, rows, pos, dtype, layers=1, hd=HD, bs=BS,
                  heads=(H, KVH)):
    """q (T, h, hd), K/V pools (layers, blocks, bs, kvh, hd) of SLOTS slots
    of MAX_LEN positions in pages of bs, scrambled block tables, and the
    token indices, on the card."""
    dev, T, (h, kvh) = DEV, len(rows), heads
    npages = MAX_LEN // bs
    blocks = SLOTS * npages + 1
    q = torch.randn(T, h, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(layers, blocks, bs, kvh, hd, generator=gen,
                    device=dev).to(dtype)
    v = torch.randn(layers, blocks, bs, kvh, hd, generator=gen,
                    device=dev).to(dtype)
    perm = torch.randperm(blocks - 1, generator=gen, device=dev) + 1
    bt = perm.view(SLOTS, npages).to(torch.int32)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    return q, k, v, bt, i32(rows), i32(pos)


def ragged_bound(rows, pos, dtype, heads=(H, KVH), hd=HD):
    """Least time for one call: each input byte read once (per slot, the
    kv positions its deepest token needs), each output byte written once;
    operations 4 * hd per (query head, visible kv position)."""
    es = torch.finfo(dtype).bits // 8
    T, (h, kvh) = len(rows), heads
    depth = {}
    for r, p in zip(rows, pos):
        if p >= 0:
            depth[r] = max(depth.get(r, 0), p + 1)
    kv = sum(depth.values()) * kvh * hd * es * 2
    nbytes = 2 * T * h * hd * es + kv + 2 * T * 4 + SLOTS * NPAGES * 4
    flops = sum(p + 1 for p in pos if p >= 0) * h * hd * 4
    return bound(nbytes, flops, dtype)


def bound(nbytes, flops, dtype):
    """(least ms, "bytes" or "operations") for one call."""
    peak = BF16_TENSOR_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def gather_inputs(gen, T, h_dtype, tables, sets=1):
    dev = DEV
    n_tasks, V, d = tables.shape
    h = torch.randn(T, d, generator=gen, device=dev).to(h_dtype)
    tasks = [torch.randint(0, n_tasks, (T,), generator=gen, device=dev,
                           dtype=torch.int32) for _ in range(sets)]
    ids = [torch.randint(0, V, (T,), generator=gen, device=dev,
                         dtype=torch.int32) for _ in range(sets)]
    # a few out-of-range indices: the kernel clamps as the XLA gather does
    tasks[0][:3] = torch.tensor([n_tasks, -1, -9], dtype=torch.int32)
    ids[0][:3] = torch.tensor([V + 5, -1, -V - 7], dtype=torch.int32)
    return h, tasks, ids


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def ptxas_kernels(out):
    """{mangled kernel name: (registers, spill bytes stored + loaded)} from
    nvcc's ``-Xptxas -v`` output."""
    kernels, name = {}, None
    for ln in out.splitlines():
        if "Function properties for" in ln:
            name = ln.split("Function properties for")[-1].strip()
        elif name and "spill stores" in ln:
            spill = sum(int(n) for n in re.findall(r"(\d+) bytes spill", ln))
            kernels[name] = (0, spill)
        elif name and "Used" in ln and "registers" in ln:
            regs = int(re.search(r"Used (\d+) registers", ln).group(1))
            kernels[name] = (regs, kernels.get(name, (0, 0))[1])
            name = None
    return kernels


# the tensor-core flash, the cluster decode (contiguous and paged), the
# ragged (split walk and run walk) and the gather-add (with and without
# the fused norm, and the norm alone) kernels, by source: phase 2 lists each
# of their instances' registers and spill bytes (none may spill)
REDESIGNED = {"flash_mma_kernel": "flash_attention",
              "decode_split_kernel": "decode_attention",
              "ragged_split_kernel": "decode_attention",
              "aot_gather_add_kernel": "aot_gather_add"}


def redesigned(logs):
    """{kernel of REDESIGNED: ["<template arguments>:<registers>r/<spill
    bytes>s", ...]} from each source's ``-Xptxas -v`` output in ``logs``.
    Raises if an instance spills, or if a source compiled in this run (not
    ``"cached"``) lacks its kernel."""
    new, spilled = {}, []
    for out in logs.values():
        for fn, (r, sp) in ptxas_kernels(out).items():
            for base in REDESIGNED:
                if base in fn:      # template arguments, mangled
                    args = fn.split(base, 1)[1].split("EEv")[0] + "E"
                    new.setdefault(base, []).append(f"{args}:{r}r/{sp}s")
                    if sp > 0:
                        spilled.append(fn)
    missing = [base for base, src in REDESIGNED.items()
               if logs.get(src, "cached") != "cached" and base not in new]
    if spilled or missing:
        raise AssertionError(f"redesigned kernel instances spill {spilled} "
                             f"or are missing from ptxas's output {missing}")
    return new


def phase_build(names):
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build(names)
    sec = time.perf_counter() - t0
    regs = []
    for name, out in logs.items():
        found = ptxas_kernels(out)
        spill = sum(sp for _, sp in found.values())
        regs.append(f"{name}:{len(found)} kernels, spill bytes {spill}"
                    if found else f"{name}:{out.strip()[:40]}")
    log("2 build", seconds=f"{sec:.1f}", arch="sm_90a",
        sources=",".join(f"{n}.cu" for n in names), ptxas="|".join(regs))
    found = redesigned(logs)
    for base, inst in sorted(found.items()):
        log("2 build", redesigned=base, instances=len(inst),
            registers_spill_bytes=",".join(sorted(inst)))
    return sec, found


def norm_scale(gen, d):
    """A random RMSNorm scale (d,) float32 whose values bf16 holds exactly
    (so that F.rms_norm with a bf16 weight computes the same function)."""
    return (1 + 0.1 * torch.randn(d, generator=gen, device=DEV)).to(
        torch.bfloat16).float()


EPS = 1e-6          # smollm-360m's norm_eps


def check_norm(what, x, want, dtype, report):
    """A fused norm's output against the plain norm's at TOL[dtype], NaN
    rows in the same places. Returns the max abs error over the rest."""
    torch.cuda.synchronize()
    a, b = x.float(), want.float()
    err = (a - b).nan_to_num().abs().max().item()
    report["parity"][what] = err
    if not torch.allclose(a, b, atol=TOL[dtype], rtol=TOL[dtype],
                          equal_nan=True):
        raise AssertionError(f"{what}: max abs err {err} over tol "
                             f"{TOL[dtype]} (or NaN rows differ)")
    return err


def check_fused(what, fused, plain_out, h, scale, report):
    """The fused gather-add + norm's (h_out, x) against the plain sum
    ``plain_out``: h_out bitwise (NaN rows equal), x within TOL of the
    plain norm, and the norm alone (ops.rms_norm) on the sum, in the build
    h took (an input with h's alignment), bitwise that x. Returns x's max
    abs error."""
    from repro_torch.kernels import aot_bias, ops
    h_out, x = fused
    torch.cuda.synchronize()
    if not torch.allclose(h_out, plain_out, rtol=0, atol=0, equal_nan=True):
        raise AssertionError(f"{what}: h_out not bitwise the plain sum")
    err = check_norm(what, x, aot_bias.rms_norm_plain(plain_out, scale, EPS),
                     h.dtype, report)
    same_build = plain_out if h.data_ptr() % 16 == 0 else misaligned(plain_out)
    alone = ops.rms_norm(same_build, scale, EPS)
    torch.cuda.synchronize()
    if not torch.allclose(alone, x, rtol=0, atol=0, equal_nan=True):
        raise AssertionError(f"{what}: rms_norm of the sum is not bitwise "
                             "the fused x")
    return err


def phase_parity(gen, report):
    """Each kernel through its public wrapper (kernels.ops) against its
    plain version. Every kernel has a 16-byte-load build and a
    one-element-load build, picked by width and alignment; the "scalar"
    cases (a width not a multiple of 8, or data one element off a 16-byte
    boundary) hold the second against the plain version too."""
    from repro_torch.kernels import aot_bias, decode_attention, ops
    cases = {"vec": 0, "scalar": 0}
    norm_err, same_rows = {}, 0

    def check_gather(h, tables, task, ids, what):
        out = ops.aot_gather_add_multitask(h, tables, task, ids)
        plain = aot_bias.aot_gather_add_multitask_plain(h, tables, task, ids)
        torch.cuda.synchronize()
        what = f"gather-add {what} h={h.dtype} table={tables.dtype} " \
               f"T={h.shape[0]}"
        if not torch.equal(out, plain):
            raise AssertionError(
                f"{what} not bitwise equal: max err "
                f"{(out.float() - plain.float()).abs().max().item()}")
        scale = norm_scale(gen, h.shape[1])
        fused = ops.aot_gather_add_multitask(h, tables, task, ids,
                                             norm=(scale, EPS))
        err = check_fused(what + " +norm", fused, plain, h, scale, report)
        key = str(h.dtype)[6:]
        norm_err[key] = max(norm_err.get(key, 0.0), err)

    for t_dtype in (torch.bfloat16, torch.float32):
        tables = (torch.randn(4, 49152, 960, generator=gen, device=DEV)
                  * 0.03).to(t_dtype)
        odd = (torch.randn(4, 4096, 962, generator=gen, device=DEV)
               * 0.03).to(t_dtype)                     # d % 8 != 0
        for h_dtype in (torch.bfloat16, torch.float32):
            for T in (8, 263):
                h, tasks, ids = gather_inputs(gen, T, h_dtype, tables)
                check_gather(h, tables, tasks[0], ids[0], "vec")
                cases["vec"] += 1
            same_rows += single_vs_multitask(gen, h, tables, ids[0])
            check_gather(misaligned(h), tables, tasks[0], ids[0],
                         "scalar/misaligned h")
            h, tasks, ids = gather_inputs(gen, 263, h_dtype, odd)
            check_gather(h, odd, tasks[0], ids[0], "scalar/d 962")
            cases["scalar"] += 2
        del tables, odd
    log("3 parity", kernel="aot_gather_add_multitask",
        cases=f"{cases['vec']} vec + {cases['scalar']} scalar",
        result="h_out bitwise equal (with and without the norm)",
        norm_max_abs_err=",".join(f"{k}:{e:.2e}"
                                  for k, e in norm_err.items()),
        rms_norm="bitwise the fused x in every case",
        single_vs_multitask_norm=f"bitwise in {same_rows} cases",
        tables="4x49152x960 (vec, misaligned h), 4x4096x962 (d%8!=0)",
        types="{f32,bf16}^2", T="8,263")
    parity_single_gather(gen, report)
    parity_encoder_gather(gen, report)
    parity_moe_gather(gen, report)

    parity_ragged(gen, report)
    parity_flash(gen, report)
    parity_decode(gen, report)
    parity_decode_wide(gen, report)
    parity_stale_nan(gen, report)
    parity_warm_cold(report)
    parity_run_vs_single(report)
    parity_frontends(gen, report)
    parity_softcap(gen, report)


# ragged and paged parity builds: name -> (hd, data one element off a
# 16-byte boundary, (h, kvh)); each at every page size of PARITY_BS
PARITY_VARIANTS = {"vec": (HD, False, (H, KVH)),
                   "vec_hd128": (128, False, (H, KVH)),
                   "scalar_hd60": (60, False, (H, KVH)),
                   "scalar_misaligned": (HD, True, (H, KVH)),
                   "vec_g8": (HD, False, (8, 1)),
                   # phase 10's decoders: danube hd 80 at g 4, olmo hd 128
                   # at g 1, qwen2.5 hd 128 at g 5 (the g 8 build)
                   "danube_hd80": (80, False, DANUBE_HEADS),
                   "olmo_hd128": (128, False, OLMO_HEADS),
                   "qwen_hd128": (128, False, QWEN_HEADS),
                   # phase 11's qwen3-moe: hd 128 at g 8 (llama4's h40
                   # kvh8 hd128 is qwen_hd128)
                   "qwen3moe_hd128": (128, False, MOE_HEADS)}
PARITY_BS = (16, 8, 32)


def parity_ragged(gen, report):
    """Ragged attention against its plain version on every packing, in
    float32 and bf16, at every build of PARITY_VARIANTS and page size of
    PARITY_BS (the plan built by the wrapper from the indices); dead tokens
    must be exact zeros; and every packing bitwise equal to paged decode of
    the same tokens with cur_len = pos + 1 (ROADMAP C4: a token's row does
    not depend on how the tick packed it)."""
    from repro_torch.kernels import decode_attention, ops
    for variant, (hd, shift, heads) in PARITY_VARIANTS.items():
        for bs in PARITY_BS:
            rcases, bitwise = [], 0
            for name, (rows, pos) in packings().items():
                for dtype in (torch.float32, torch.bfloat16):
                    q, k, v, bt, r, p = ragged_inputs(gen, rows, pos, dtype,
                                                      hd=hd, bs=bs,
                                                      heads=heads)
                    k, v = k[0], v[0]
                    if shift:
                        k, v = misaligned(k), misaligned(v)
                    out = ops.ragged_paged_attention(q, k, v, bt, r, p)
                    plain = decode_attention.ragged_paged_attention_plain(
                        q, k, v, bt, r, p)
                    what = f"ragged/{variant}/bs{bs}/{name}/{dtype}"
                    err = check_close(what, out, plain, dtype, report, p < 0)
                    rcases.append(f"{name}/{str(dtype)[6:]}:{err:.2e}")
                    paged = ops.paged_decode_attention(
                        q, k, v, bt[r.long()].contiguous(),
                        torch.clamp(p + 1, min=0))
                    torch.cuda.synchronize()
                    if not torch.equal(out, paged):
                        raise AssertionError(
                            f"{what}: not bitwise equal to paged decode "
                            f"with cur_len = pos + 1 (max abs diff "
                            f"{(out.float() - paged.float()).abs().max()})")
                    bitwise += 1
            log("3 parity", kernel="ragged_paged_attention", variant=variant,
                bs=bs, shapes=f"h{heads[0]} kvh{heads[1]} hd{hd} "
                f"depth<=1024", bitwise_vs_paged=f"{bitwise}/{len(rcases)}",
                max_abs_err=",".join(rcases))


def check_close(what, out, plain, dtype, report, zero_rows=None):
    """Hold a kernel's output to its plain version's at TOL[dtype]; rows
    flagged in ``zero_rows`` must be exact zeros. Returns the max abs
    error."""
    torch.cuda.synchronize()
    err = (out.float() - plain.float()).abs().max().item()
    report["parity"][what] = err
    tol = TOL[dtype]
    ok = torch.allclose(out.float(), plain.float(), atol=tol, rtol=tol)
    if zero_rows is not None:
        ok = ok and bool((out[zero_rows] == 0).all())
    if not ok:
        raise AssertionError(f"{what}: max abs err {err} over tol {tol} "
                             "(or a row that must be zero is not)")
    return err


def single_vs_multitask(gen, h, tables, ids):
    """The single-table and the multi-task fused entries on the same rows
    (task 1's table, in-range ids) give bitwise the same (h_out, x), as
    phase 5d's token gate needs. Returns the number of cases (1)."""
    from repro_torch.kernels import ops
    ids = ids.clamp(0, tables.shape[1] - 1)
    norm = (norm_scale(gen, h.shape[1]), EPS)
    single = ops.aot_gather_add(h, tables[1], ids, norm=norm)
    multi = ops.aot_gather_add_multitask(h, tables, torch.ones_like(ids),
                                         ids, norm=norm)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(single, multi)):
        raise AssertionError(f"single-table and multi-task norm modes differ "
                             f"(h {h.dtype}, table {tables.dtype}, "
                             f"T {h.shape[0]})")
    return 1


def parity_single_gather(gen, report):
    """The single-table gather-add (one task's fused AoT tables) against
    its plain version, bitwise with NaN rows equal: ids include -1 and -V
    (wrap once) and V, V + 5, -V - 1 (NaN rows, jnp.take's fill); the
    16-byte build at d 960 and the one-element build at d 60 and with h
    one element off a 16-byte boundary; f32 and bf16 h and tables."""
    from repro_torch.kernels import aot_bias, ops
    cases, nan_rows, norm_err = [], 0, {}
    for t_dtype in (torch.bfloat16, torch.float32):
        for vocab, d in ((49152, 960), (4096, 60)):
            table = (torch.randn(vocab, d, generator=gen, device=DEV)
                     * 0.03).to(t_dtype)
            for h_dtype in (torch.bfloat16, torch.float32):
                for T in (16, 263):
                    h = torch.randn(T, d, generator=gen,
                                    device=DEV).to(h_dtype)
                    ids = torch.randint(0, vocab, (T,), generator=gen,
                                        device=DEV, dtype=torch.int32)
                    ids[:6] = torch.tensor([-1, -vocab, vocab, vocab + 5,
                                            -vocab - 1, vocab - 1])
                    variants = {"vec" if d % 8 == 0 else "scalar_d60": h}
                    if d % 8 == 0:
                        variants["scalar_misaligned"] = misaligned(h)
                    for variant, hh in variants.items():
                        out = ops.aot_gather_add(hh, table, ids)
                        plain = aot_bias.aot_gather_add_plain(hh, table, ids)
                        torch.cuda.synchronize()
                        what = (f"single gather-add {variant} h={h_dtype} "
                                f"table={t_dtype} T={T} d={d}")
                        if not torch.allclose(out, plain, rtol=0, atol=0,
                                              equal_nan=True):
                            raise AssertionError(f"{what}: not bitwise equal")
                        nan = out.isnan().all(dim=1)
                        if nan.tolist()[:6] != [False] * 2 + [True] * 3 + [
                                False] or int(nan.sum()) != 3:
                            raise AssertionError(f"{what}: NaN rows "
                                                 f"{nan.nonzero().tolist()}")
                        nan_rows += 3
                        cases.append(variant)
                        scale = norm_scale(gen, d)
                        fused = ops.aot_gather_add(hh, table, ids,
                                                   norm=(scale, EPS))
                        err = check_fused(what + " +norm", fused, plain, hh,
                                          scale, report)
                        if not fused[1].isnan().all(dim=1).equal(nan):
                            raise AssertionError(f"{what}: x's NaN rows "
                                                 "are not h_out's")
                        key = str(h_dtype)[6:]
                        norm_err[key] = max(norm_err.get(key, 0.0), err)
            del table
    report["parity"]["aot_gather_add"] = dict(cases=len(cases),
                                              nan_rows=nan_rows,
                                              norm_max_abs_err=norm_err)
    log("3 parity", kernel="aot_gather_add", cases=len(cases),
        builds=",".join(sorted(set(cases))),
        result="h_out bitwise equal (with and without the norm)",
        norm_max_abs_err=",".join(f"{k}:{e:.2e}"
                                  for k, e in norm_err.items()),
        rms_norm="bitwise the fused x in every case",
        nan_rows=f"{nan_rows} (ids V, V+5, -V-1)",
        tables="49152x960, 4096x60", types="{f32,bf16}^2", T="16,263")


def parity_moe_gather(gen, report, gathers=MOE_GATHERS, mode="moe"):
    """The fused multi-task gather-add at phase 11's widths (MOE_GATHERS:
    qwen3-moe's d 2048 over V 151936, llama4's d 5120 over V 202048, 2
    tasks each; or ``gathers``, phase 13's paligemma), bf16, T 8 and 263,
    with and without the norm: h_out bitwise the plain sum, x within the
    tolerance of the plain norm."""
    from repro_torch.kernels import aot_bias, ops
    cases, norm_err = [], 0.0
    for n_tasks, vocab, d in gathers:
        tables = torch.empty(n_tasks, vocab, d, dtype=torch.bfloat16,
                             device=DEV)
        for t in range(n_tasks):
            tables[t].normal_(0.0, 0.03, generator=gen)
        for T in (8, 263):
            h, tasks, ids = gather_inputs(gen, T, torch.bfloat16, tables)
            out = ops.aot_gather_add_multitask(h, tables, tasks[0], ids[0])
            plain = aot_bias.aot_gather_add_multitask_plain(h, tables,
                                                            tasks[0], ids[0])
            torch.cuda.synchronize()
            what = f"gather-add {mode} d{d} V{vocab} T{T}"
            if not torch.equal(out, plain):
                raise AssertionError(f"{what}: not bitwise equal")
            scale = norm_scale(gen, d)
            fused = ops.aot_gather_add_multitask(h, tables, tasks[0], ids[0],
                                                 norm=(scale, EPS))
            norm_err = max(norm_err, check_fused(what + " +norm", fused,
                                                 plain, h, scale, report))
            cases.append(f"d{d}/T{T}")
        del tables
    report["parity"][f"aot_gather_add_multitask_{mode}"] = dict(
        cases=cases, norm_max_abs_err=norm_err)
    log("3 parity", kernel="aot_gather_add_multitask", mode=mode,
        cases=",".join(cases), result="h_out bitwise equal (with and "
        "without the norm)", norm_max_abs_err=f"bf16:{norm_err:.2e}",
        tables=",".join(f"{n}x{v}x{d}" for n, v, d in gathers) + " bf16")


def parity_encoder_gather(gen, report):
    """Both gather-adds in their plain mode (no fused norm: a post-LN
    encoder has no input norm) at the encoders' width d 1024 and
    vocabularies 50265 and 128100, bitwise against the plain versions:
    one task's table (V, d) and 4 stacked tasks' (4, V, d) in bf16, h in
    bf16 and float32, T 64 and 3072 (8 x 384), ids at both ends of the
    vocabulary and -1 (wraps once); and the single-table entry on task t's
    table bitwise the multi-task entry with every task id t."""
    from repro_torch.kernels import aot_bias, ops
    cases = []
    for vocab in ENC_VOCABS:
        tables = (torch.randn(4, vocab, ENC_D, generator=gen, device=DEV)
                  * 0.03).to(torch.bfloat16)
        for h_dtype in (torch.bfloat16, torch.float32):
            for T in (64, 3072):
                h = torch.randn(T, ENC_D, generator=gen,
                                device=DEV).to(h_dtype)
                ids = torch.randint(0, vocab, (T,), generator=gen,
                                    device=DEV, dtype=torch.int32)
                ids[:3] = torch.tensor([0, vocab - 1, -1])
                task = torch.randint(0, 4, (T,), generator=gen, device=DEV,
                                     dtype=torch.int32)
                task[:2] = 3
                what = f"plain-mode gather-add V={vocab} h={h_dtype} T={T}"
                single = ops.aot_gather_add(h, tables[3], ids)
                multi = ops.aot_gather_add_multitask(h, tables, task, ids)
                three = ops.aot_gather_add_multitask(
                    h, tables, torch.full_like(task, 3), ids)
                torch.cuda.synchronize()
                if not torch.equal(single, aot_bias.aot_gather_add_plain(
                        h, tables[3], ids)):
                    raise AssertionError(f"{what}: single-table not bitwise")
                if not torch.equal(multi, aot_bias.
                                   aot_gather_add_multitask_plain(
                                       h, tables, task, ids)):
                    raise AssertionError(f"{what}: multi-task not bitwise")
                if not torch.equal(single, three):
                    raise AssertionError(f"{what}: single-table on task 3 "
                                         "differs from multi-task at id 3")
                cases.append(f"{vocab}/{str(h_dtype)[6:]}/T{T}")
        del tables
    report["parity"]["encoder_gather"] = cases
    log("3 parity", kernel="aot_gather_add+aot_gather_add_multitask",
        mode="plain (norm=None)", d=ENC_D, cases=len(cases),
        result="bitwise equal; single-table = multi-task at one task id",
        shapes=",".join(cases))


# flash parity cases: name -> (b, sq, skv, hd, causal, window, strided,
# heads, misaligned); smollm's heads (15 over 5) unless a case names
# others. The bf16 kernel's edges: query tiles of 64 (sq 100, 577), kv
# tiles of 64 past either end, hd padded to 64 (hd 32, 60) or 128 (hd 96,
# 128), the element-load build (hd 60, a misaligned q), a strided q
FLASH_CASES = {
    "causal_1": (2, 1, 1, HD, True, 0, False),
    "causal_37": (2, 37, 37, HD, True, 0, False),
    "causal_512": (2, 512, 512, HD, True, 0, False),
    "full_37": (2, 37, 37, HD, False, 0, False),
    "full_512": (1, 512, 512, HD, False, 0, False),
    "window64_512": (2, 512, 512, HD, True, 64, False),
    "causal_sq37_skv100": (2, 37, 100, HD, True, 0, False),
    "causal_sq100_skv37": (2, 100, 37, HD, True, 0, False),
    "full_sq37_skv100": (2, 37, 100, HD, False, 0, False),
    "causal_hd60": (2, 37, 37, 60, True, 0, False),
    "causal_strided_q": (2, 100, 100, HD, True, 0, True),
    "causal_hd128": (2, 100, 100, 128, True, 0, False),    # 4 channels/lane
    "window16_g8": (2, 100, 100, HD, True, 16, False, (8, 1)),
    "full_100": (2, 100, 100, HD, False, 0, False),
    "causal_577": (1, 577, 577, HD, True, 0, False),
    "causal_sq577_skv300": (1, 577, 300, HD, True, 0, False),
    "causal_sq300_skv577": (1, 300, 577, HD, True, 0, False),
    "full_sq577_skv100": (1, 577, 100, HD, False, 0, False),
    "window100_577": (1, 577, 577, HD, True, 100, False),
    "causal_hd32": (2, 100, 100, 32, True, 0, False),
    "causal_hd96": (2, 100, 100, 96, True, 0, False),
    "causal_hd60_577": (1, 577, 577, 60, True, 0, False),
    "causal_hd128_577": (1, 577, 577, 128, True, 0, False),
    "causal_strided_q_577": (1, 577, 577, HD, True, 0, True),
    "causal_misaligned_100": (2, 100, 100, HD, True, 0, False, (H, KVH),
                              True),
    "causal_g8_577": (1, 577, 577, HD, True, 0, False, (8, 1)),
    # the paper's encoders (roberta-large, deberta-xl): full mode, 16 heads
    # over 16 KV heads (g = 1), whole sequences up to 512
    "full_g1_1": (2, 1, 1, HD, False, 0, False, ENC_HEADS),
    "full_g1_37": (2, 37, 37, HD, False, 0, False, ENC_HEADS),
    "full_g1_384": (8, 384, 384, HD, False, 0, False, ENC_HEADS),
    "full_g1_512": (1, 512, 512, HD, False, 0, False, ENC_HEADS),
    "full_g1_577": (1, 577, 577, HD, False, 0, False, ENC_HEADS),
    # phase 10's decoders: h2o-danube-1.8b (h32 kvh8 hd80: hd padded to
    # the 128 build), causal and its window of 4096 over 6144; olmo-1b
    # (h16 kvh16 hd128, g 1), qwen2.5-14b (h40 kvh8 hd128, g 5)
    "danube_causal_577": (1, 577, 577, 80, True, 0, False, DANUBE_HEADS),
    "danube_window4096_6144": (1, 6144, 6144, 80, True, 4096, False,
                               DANUBE_HEADS),
    "olmo_causal_577": (1, 577, 577, 128, True, 0, False, OLMO_HEADS),
    "qwen_causal_577": (1, 577, 577, 128, True, 0, False, QWEN_HEADS),
    # phase 11's qwen3-moe (h32 kvh4 hd128, g 8); llama4 is qwen_causal_577
    "qwen3moe_causal_577": (1, 577, 577, 128, True, 0, False, MOE_HEADS),
    "qwen3moe_causal_512_b4": (4, 512, 512, 128, True, 0, False, MOE_HEADS),
    # phase 12's recurrentgemma-9b (h16 kvh1 hd256, g 16: the hd 256
    # build): its static batch's prefill (4 x 3072, window 2048), causal and
    # full there, query tiles past either end (577), the element-load build
    # at hd 250, and g 1 / g 8 at hd 256
    "rgemma_window2048_3072_b4": (4, 3072, 3072, RGEMMA_HD, True,
                                  RGEMMA_WINDOW, False, RGEMMA_HEADS),
    "rgemma_causal_3072_b4": (4, 3072, 3072, RGEMMA_HD, True, 0, False,
                              RGEMMA_HEADS),
    "rgemma_full_3072_b4": (4, 3072, 3072, RGEMMA_HD, False, 0, False,
                            RGEMMA_HEADS),
    "rgemma_causal_577": (1, 577, 577, RGEMMA_HD, True, 0, False,
                          RGEMMA_HEADS),
    "rgemma_window100_577": (1, 577, 577, RGEMMA_HD, True, 100, False,
                             RGEMMA_HEADS),
    "rgemma_causal_sq577_skv300": (1, 577, 300, RGEMMA_HD, True, 0, False,
                                   RGEMMA_HEADS),
    "rgemma_hd250_100": (2, 100, 100, 250, True, 0, False, RGEMMA_HEADS),
    "rgemma_misaligned_100": (2, 100, 100, RGEMMA_HD, True, 0, False,
                              RGEMMA_HEADS, True),
    "hd256_g1_100": (2, 100, 100, RGEMMA_HD, False, 0, False, (4, 4)),
    "hd256_g8_strided_100": (2, 100, 100, RGEMMA_HD, True, 0, True, (8, 1)),
    # phase 13's hubert-xlarge: full mode at g 1, hd 80 (the 128 build's
    # padding), its frames (8 x 512) and query tiles past either end
    "hubert_full_g1_hd80_512_b8": (8, 512, 512, HUBERT_HD, False, 0, False,
                                   HUBERT_HEADS),
    "hubert_full_g1_hd80_577": (1, 577, 577, HUBERT_HD, False, 0, False,
                                HUBERT_HEADS),
}


# queries from an offset (P-Tuning v2's prefill: sq prompt queries at
# positions q_offset.. over the prefix and the prompt, skv = q_offset + sq):
# name -> (b, sq, q_offset, window[, causal, heads]); causal with smollm's
# heads unless a case says otherwise
FLASH_OFFSET_CASES = {
    "offset20_37": (2, 37, 20, 0),
    "offset37_100": (2, 100, 37, 0),
    "offset20_512": (1, 512, 20, 0),
    "offset20_window16": (2, 100, 20, 16),
    "offset37_window64_512": (1, 512, 37, 64),
    "offset37_window100_577": (1, 577, 37, 100),
    "full_g1_offset20_384": (2, 384, 20, 0, False, ENC_HEADS),  # encoder
}


def flash_inputs(gen, b, sq, skv, hd, dtype, strided=False,
                 heads=(H, KVH), shift=False):
    """q (b, sq, h, hd), k and v (b, skv, kvh, hd); ``strided`` gives q as
    a view with wider head and sequence strides (the kernel reads
    strides); ``shift`` starts all three one element past a 16-byte
    boundary (the element-load build)."""
    h, kvh = heads
    rnd = lambda *shape: torch.randn(*shape, generator=gen,
                                     device=DEV).to(dtype)
    q = rnd(b, sq, h, 2 * hd)[..., :hd] if strided else rnd(b, sq, h, hd)
    k, v = rnd(b, skv, kvh, hd), rnd(b, skv, kvh, hd)
    if shift:
        q, k, v = misaligned(q), misaligned(k), misaligned(v)
    return q, k, v


def parity_flash(gen, report):
    from repro_torch.kernels import flash_attention, ops
    cases = []
    for name, (b, sq, skv, hd, causal, window, *shape) in \
            FLASH_CASES.items():
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(gen, b, sq, skv, hd, dtype, *shape)
            out = ops.flash_attention(q, k, v, causal=causal, window=window)
            plain = flash_attention.flash_attention_plain(
                q, k, v, causal=causal, window=window)
            err = check_close(f"flash/{name}/{dtype}", out, plain, dtype,
                              report)
            cases.append(f"{name}/{str(dtype)[6:]}:{err:.2e}")
    for name, (b, sq, off, window, *mode) in FLASH_OFFSET_CASES.items():
        causal, heads = mode or (True, (H, KVH))
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(gen, b, sq, sq + off, HD, dtype,
                                   heads=heads)
            out = ops.flash_attention(q, k, v, causal=causal, window=window,
                                      q_offset=off)
            plain = flash_attention.flash_attention_plain(
                q, k, v, causal=causal, window=window, q_offset=off)
            err = check_close(f"flash/{name}/{dtype}", out, plain, dtype,
                              report)
            cases.append(f"{name}/{str(dtype)[6:]}:{err:.2e}")
    log("3 parity", kernel="flash_attention",
        shapes="h15 kvh5 hd32|60|64|96|128, h8 kvh1 hd64, h16 kvh16 hd64 "
        "(full); h32 kvh8 hd80 (window 4096 over 6144), h16 kvh16 hd128, "
        "h40 kvh8 hd128; h16 kvh1 hd250|256 (window 2048 over 4 x 3072), "
        "h4 kvh4 / h8 kvh1 hd256, h16 kvh16 hd80 (full); sq 1-6144; "
        "q_offset 20|37",
        max_abs_err=",".join(cases))


DECODE_LENS = [0, 1, 33, 255, 256, 577, 1000, 1024]   # per row, S = 1024
# the contiguous kernel's cluster split (decode_split): S -> per-row
# lengths at and on either side of a block boundary (chunk = ceil(S /
# split): 256 at S 1024 and 2048, 250 at S 1000, 150 at S 300), 0 and S
SPLIT_LENS = {1024: [0, 255, 256, 257, 1024, 1, 511, 769],
              1000: [0, 249, 250, 251, 1000, 1, 749, 751],
              2048: [0, 255, 256, 257, 2048, 1, 1791, 1793],
              300: [0, 149, 150, 151, 300, 1, 299, 64]}
PAGED_LENS = [0, 1, 15, 16, 17, 300, 1000, 1024]      # 8 slots, pages of 16


def decode_inputs(gen, lens, dtype, hd=HD, layers=1, S=MAX_LEN,
                  heads=(H, KVH)):
    b, (h, kvh) = len(lens), heads
    rnd = lambda *shape: torch.randn(*shape, generator=gen,
                                     device=DEV).to(dtype)
    q = rnd(b, h, hd)
    k, v = rnd(layers, b, S, kvh, hd), rnd(layers, b, S, kvh, hd)
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device=DEV)


def paged_copy(gen, k, v, bs, shift):
    """A contiguous cache (b, S, kvh, hd) as a paged pool: pages of bs in a
    scrambled order after scratch page 0, and the (b, S / bs) tables that
    map them. ``shift`` puts the pool one element off a 16-byte
    boundary."""
    b, S, kvh, hd = k.shape
    npages = S // bs
    perm = torch.randperm(b * npages, generator=gen, device=DEV)
    pools = []
    for x in (k, v):
        pool = torch.zeros(b * npages + 1, bs, kvh, hd, dtype=x.dtype,
                           device=DEV)
        pool[perm + 1] = x.reshape(b * npages, bs, kvh, hd)
        pools.append(misaligned(pool) if shift else pool)
    bt = (perm + 1).view(b, npages).to(torch.int32)
    return pools[0], pools[1], bt


def paged_vs_contiguous(gen, dtype, hd, shift, heads):
    """Paged decode over the pages of a contiguous cache against contiguous
    decode of that cache, bitwise: at PAGED_LENS over S 1024 and at every
    SPLIT_LENS case, at every page size of 4, 8, 16, 32 that divides S (the
    capacities match, so the split walks see the same ranges and tiles).
    Returns the number of cases."""
    from repro_torch.kernels import ops
    cases = 0
    for S, lens in [(MAX_LEN, PAGED_LENS)] + list(SPLIT_LENS.items()):
        q, k, v, cur = decode_inputs(gen, lens, dtype, hd, S=S, heads=heads)
        k, v = k[0], v[0]
        kc, vc = (misaligned(k), misaligned(v)) if shift else (k, v)
        want = ops.decode_attention(q, kc, vc, cur)
        for bs in (4, 8, 16, 32):
            if S % bs:
                continue
            kp, vp, bt = paged_copy(gen, k, v, bs, shift)
            got = ops.paged_decode_attention(q, kp, vp, bt, cur)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"paged decode S {S} bs {bs} hd {hd} {dtype} is not "
                    f"bitwise contiguous decode: max abs diff "
                    f"{(got.float() - want.float()).abs().max().item()}")
            cases += 1
    return cases


def parity_decode(gen, report):
    """The contiguous and the paged decode kernel, each through its 16-byte
    load build (hd 64 or 128, aligned) and its one-element build (hd 60, or
    data one element off a 16-byte boundary), at smollm's heads and at the
    kernels' most query heads per KV head (8); paged decode at pages of 16,
    8 and 32, and bitwise against contiguous decode over the same K/V."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    for variant, (hd, shift, heads) in PARITY_VARIANTS.items():
        cases, bitwise = [], 0
        kvh = heads[1]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, lens = decode_inputs(gen, DECODE_LENS, dtype, hd,
                                          heads=heads)
            k, v = k[0], v[0]
            if shift:
                k, v = misaligned(k), misaligned(v)
            for cur in ("per_row", 577, 0):
                arg = lens if cur == "per_row" else cur
                out = ops.decode_attention(q, k, v, arg)
                plain = da.decode_attention_plain(q, k, v, arg)
                zero = (lens <= 0) if cur == "per_row" else None
                if cur == 0:
                    zero = torch.ones(len(lens), dtype=torch.bool, device=DEV)
                err = check_close(f"decode/{variant}/{cur}/{dtype}", out,
                                  plain, dtype, report, zero)
                cases.append(f"decode/{cur}/{str(dtype)[6:]}:{err:.2e}")
            for S, slens in SPLIT_LENS.items():
                sq_, sk, sv, scur = decode_inputs(gen, slens, dtype, hd,
                                                  S=S, heads=heads)
                sk, sv = sk[0], sv[0]
                if shift:
                    sk, sv = misaligned(sk), misaligned(sv)
                out = ops.decode_attention(sq_, sk, sv, scur)
                plain = da.decode_attention_plain(sq_, sk, sv, scur)
                err = check_close(f"decode/{variant}/split_S{S}/{dtype}",
                                  out, plain, dtype, report, scur <= 0)
                cases.append(f"split_S{S}/{str(dtype)[6:]}:{err:.2e}")
            # paged: scrambled pages over 8 slots of 1024 tokens
            plens = torch.tensor(PAGED_LENS, dtype=torch.int32, device=DEV)
            for bs in PARITY_BS:
                npages = MAX_LEN // bs
                kp = torch.randn(SLOTS * npages + 1, bs, kvh, hd,
                                 generator=gen, device=DEV).to(dtype)
                vp = torch.randn(SLOTS * npages + 1, bs, kvh, hd,
                                 generator=gen, device=DEV).to(dtype)
                if shift:
                    kp, vp = misaligned(kp), misaligned(vp)
                perm = torch.randperm(SLOTS * npages, generator=gen,
                                      device=DEV) + 1
                bt = perm.view(SLOTS, npages).to(torch.int32)
                out = ops.paged_decode_attention(q, kp, vp, bt, plens)
                plain = da.paged_decode_attention_plain(q, kp, vp, bt, plens)
                err = check_close(f"paged_decode/{variant}/bs{bs}/{dtype}",
                                  out, plain, dtype, report, plens <= 0)
                cases.append(f"paged_bs{bs}/{str(dtype)[6:]}:{err:.2e}")
            bitwise += paged_vs_contiguous(gen, dtype, hd, shift, heads)
        log("3 parity", kernel="decode_attention+paged_decode_attention",
            variant=variant,
            shapes=f"b8 h{heads[0]} kvh{kvh} hd{hd} S300-2048 bs8|16|32",
            paged_bitwise_contiguous=f"{bitwise} cases",
            max_abs_err=",".join(cases))


# contiguous decode's new instances (phase 12): name -> (hd, data one
# element off a 16-byte boundary, (h, kvh)): the wide walk at hd 256 with G
# 8 (g 16 in two clusters, g 8) and G 4 (g 3), its element-load build (hd
# 250, a misaligned cache), and g 16 / g 12 at hd 128 (two clusters of the
# existing G 8 instance)
WIDE_VARIANTS = {"rgemma_hd256_g16": (RGEMMA_HD, False, RGEMMA_HEADS),
                 "hd256_g8": (RGEMMA_HD, False, (8, 1)),
                 "hd256_g3": (RGEMMA_HD, False, (6, 2)),
                 "scalar_hd250_g16": (250, False, RGEMMA_HEADS),
                 "scalar_misaligned_hd256_g16": (RGEMMA_HD, True,
                                                 RGEMMA_HEADS),
                 "hd128_g16": (128, False, (16, 1)),
                 "hd128_g12": (128, False, (24, 2))}
RING_ROWS = 4       # phase 12's static batch over its 2048-row ring


def parity_decode_wide(gen, report):
    """Contiguous decode at recurrentgemma's heads and the instances they
    added (WIDE_VARIANTS), float32 and bf16, against the plain version:
    the static batch's wrapped ring (b 4, S 2048, every row full, scalar
    and per-row lengths), DECODE_LENS over S 1024 and every SPLIT_LENS
    case."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    for variant, (hd, shift, heads) in WIDE_VARIANTS.items():
        cases = []
        runs = [("ring", RGEMMA_WINDOW, [RGEMMA_WINDOW] * RING_ROWS),
                ("ring_ragged", RGEMMA_WINDOW, [RGEMMA_WINDOW, 1, 1000, 0]),
                ("lens", MAX_LEN, DECODE_LENS)]
        runs += [(f"split_S{S}", S, lens) for S, lens in SPLIT_LENS.items()]
        for dtype in (torch.float32, torch.bfloat16):
            for name, S, lens in runs:
                q, k, v, cur = decode_inputs(gen, lens, dtype, hd, S=S,
                                             heads=heads)
                k, v = k[0], v[0]
                if shift:
                    k, v = misaligned(k), misaligned(v)
                arg = int(cur[0]) if name == "ring" else cur
                out = ops.decode_attention(q, k, v, arg)
                plain = da.decode_attention_plain(q, k, v, arg)
                err = check_close(f"decode/{variant}/{name}/{dtype}", out,
                                  plain, dtype, report, cur <= 0)
                cases.append(f"{name}/{str(dtype)[6:]}:{err:.2e}")
        log("3 parity", kernel="decode_attention", variant=variant,
            shapes=f"h{heads[0]} kvh{heads[1]} hd{hd} S300-2048",
            max_abs_err=",".join(cases))


def poison_past(pool, bt, depth, bs, fill):
    """A copy of a paged pool (blocks, bs, kvh, hd) with ``fill`` on
    scratch page 0 and at every position at or past each row's depth
    (rows of ``bt``: (rows, npages) tables of distinct pages)."""
    npages = bt.shape[1]
    pos = torch.arange(npages * bs, device=DEV).view(npages, bs)
    past = torch.zeros(pool.shape[:2], dtype=torch.bool, device=DEV)
    past[0] = True
    for r in range(bt.shape[0]):
        past[bt[r].long()] = pos >= int(depth[r])
    return torch.where(past[:, :, None, None],
                       torch.full_like(pool, fill), pool)


def parity_stale_nan(gen, report):
    """K/V that nothing may read (past each row's length, scratch page 0)
    set to NaN give bitwise the output of zeros there, through each
    kernel and through its plain version (a retried tick and
    released quarantine pages leave stale rows behind). Contiguous and
    paged decode at DECODE_LENS / PAGED_LENS, ragged attention on three
    packings with chunks, decode tokens and dead padding; f32 and bf16."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    nan = float("nan")
    cases = []

    def same(what, fn):
        outs = [fn(fill) for fill in (0.0, nan)]
        torch.cuda.synchronize()
        for fill, (k_out, p_out) in zip(("0", "nan"), outs):
            if not (torch.isfinite(k_out).all()
                    and torch.isfinite(p_out).all()):
                raise AssertionError(f"{what} fill {fill}: non-finite output")
        if not (torch.equal(outs[0][0], outs[1][0])
                and torch.equal(outs[0][1], outs[1][1])):
            raise AssertionError(f"{what}: NaN past the length changed the "
                                 "output (kernel or plain)")
        report["parity"][f"stale_nan/{what}"] = "bitwise"
        cases.append(what)

    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, lens = decode_inputs(gen, DECODE_LENS, dtype)
        k, v = k[0], v[0]
        past = (torch.arange(MAX_LEN, device=DEV)[None, :]
                >= lens[:, None])[:, :, None, None]

        def contiguous(fill):
            kk = torch.where(past, torch.full_like(k, fill), k)
            vv = torch.where(past, torch.full_like(v, fill), v)
            return (ops.decode_attention(q, kk, vv, lens),
                    da.decode_attention_plain(q, kk, vv, lens))
        same(f"decode/{str(dtype)[6:]}", contiguous)
        plens = torch.tensor(PAGED_LENS, dtype=torch.int32, device=DEV)
        kp, vp, bt = paged_copy(gen, k, v, BS, False)
        bt[0, 1:] = 0                   # unmapped entries point at page 0

        def paged(fill):
            kk = poison_past(kp, bt, PAGED_LENS, BS, fill)
            vv = poison_past(vp, bt, PAGED_LENS, BS, fill)
            return (ops.paged_decode_attention(q, kk, vv, bt, plens),
                    da.paged_decode_attention_plain(q, kk, vv, bt, plens))
        same(f"paged_decode/{str(dtype)[6:]}", paged)
        for name in ("decode_only", "chunks_decode_dead",
                     "four_chunks_unaligned"):
            rows, pos = packings()[name]
            q_r, k_r, v_r, bt_r, r, p = ragged_inputs(gen, rows, pos, dtype)
            depth = [0] * SLOTS
            for row, at in zip(rows, pos):
                depth[row] = max(depth[row], at + 1)

            def ragged(fill):
                kk = poison_past(k_r[0], bt_r, depth, BS, fill)
                vv = poison_past(v_r[0], bt_r, depth, BS, fill)
                return (ops.ragged_paged_attention(q_r, kk, vv, bt_r, r, p),
                        da.ragged_paged_attention_plain(q_r, kk, vv, bt_r,
                                                        r, p))
            same(f"ragged/{name}/{str(dtype)[6:]}", ragged)
    log("3 parity", kernel="decode+paged_decode+ragged (stale NaN)",
        result="kernel and plain bitwise unchanged by NaN past each row's "
        "length and on page 0", cases=len(cases))


# phase 3's warm / cold packings of one slot's query rows: a cached prefix
# of WARM_HIT positions (24 pages of 16), then WARM_TAIL queries (two
# tiles of 16 and a one-token remainder); a cold prefill's second chunk
# starts at COLD_SPLIT when the multi-prefill budget split cuts it there.
# WARM_SWEEP adds hits where a run's visible range crosses a multiple of
# 256 positions (the cluster's blocks' range edges), each against a cold
# run from 0, one from 200 and one from 8 before the hit
WARM_HIT, WARM_TAIL, COLD_SPLIT = 384, 33, 200
WARM_SWEEP = (384, 496, 752)


def parity_warm_cold(report, seed=3):
    """Ragged attention of the same query rows (positions hit .. hit +
    WARM_TAIL - 1 of one slot) over the same resident K/V, packed as a
    warm chunk from the page-aligned hit and as cold runs from position
    0, COLD_SPLIT and hit - 8, at each hit of WARM_SWEEP. Each packing
    within TOL of its plain version; the rows of each cold packing not
    bitwise equal to the warm one's are counted and must be none (ROADMAP
    C4), the smallest input that has one named if one does. Inputs come
    from a generator of their own, so later phases draw what they drew
    before."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    gen = torch.Generator(device=DEV).manual_seed(seed)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=DEV)
    lines, smallest = {}, None
    for dtype in (torch.float32, torch.bfloat16):
        for hit in WARM_SWEEP:
            L = hit + WARM_TAIL
            q, k, v, bt, _, _ = ragged_inputs(gen, [0] * L, list(range(L)),
                                              dtype)
            k, v = k[0], v[0]
            rows = {}
            for lo in (hit, 0, COLD_SPLIT, hit - 8):
                qq = q[lo:].contiguous()
                r, p = i32([0] * (L - lo)), i32(list(range(lo, L)))
                out = ops.ragged_paged_attention(qq, k, v, bt, r, p)
                plain = da.ragged_paged_attention_plain(qq, k, v, bt, r, p)
                check_close(f"ragged warm_cold/hit{hit}/from{lo}/{dtype}",
                            out, plain, dtype, report)
                rows[lo] = out[hit - lo:]
            torch.cuda.synchronize()
            for lo in (0, COLD_SPLIT, hit - 8):
                bad = (rows[lo] != rows[hit]).flatten(1).any(1)
                d = (rows[lo].float() - rows[hit].float()).abs().max().item()
                key = f"{str(dtype)[6:]}/hit{hit}/from{lo}"
                lines[key] = f"{int(bad.sum())}/{WARM_TAIL}"
                report["parity"][f"warm_cold/{key}"] = dict(
                    rows_not_bitwise=int(bad.sum()), rows=WARM_TAIL,
                    max_abs_diff=d)
                if bad.any() and (smallest is None or L < smallest[0]):
                    smallest = (L, f"{key}/position "
                                   f"{hit + int(bad.nonzero()[0])}")
    report["parity"]["warm_cold/smallest"] = smallest and smallest[1]
    log("3 parity", kernel="ragged_paged_attention (warm / cold packings)",
        tail=WARM_TAIL, result="each packing within tolerance of its plain "
        "version", rows_not_bitwise_vs_warm=lines, required="0 each",
        smallest_input="none" if smallest is None else smallest[1])
    if smallest is not None:
        raise AssertionError(f"warm / cold packings part (ROADMAP C4): "
                             f"{smallest[1]}")


# phase 3's single-token-vs-run check over one slot of RUN_L positions:
# RUN_POSITIONS take in 0, a tile's edges (63, 64), the cluster blocks'
# range edges (the capacity of 1024 in 4 blocks of 256) and the last
# position; each is held inside runs starting at the offsets of
# RUN_STARTS before it (and at 0), ending RUN_PAST positions after it
RUN_L = 800
RUN_POSITIONS = (0, 63, 64, 100, 255, 256, 400, 511, 512, 767, 768, 799)
RUN_STARTS = (0, 1, 15, 16, 40)
RUN_PAST = 9


def run_packing(p, start):
    """(rows, pos, index of position p) of a tick that packs slot 0's run
    start .. min(p + RUN_PAST, RUN_L - 1) after three dead tokens and slot
    1's run of 20 at 100 .. 119, then two dead tokens and slot 2's lone
    token at 500."""
    end = min(p + RUN_PAST, RUN_L - 1)
    rows = [0] * 3 + [1] * 20 + [0] * (end - start + 1) + [0, 0, 2]
    pos = [-1] * 3 + list(range(100, 120)) + list(range(start, end + 1)) \
        + [-1, -1, 500]
    return rows, pos, 23 + p - start


def parity_run_vs_single(report, seed=5):
    """ROADMAP C4 on the card: each position of RUN_POSITIONS of one slot
    holding RUN_L positions, as a single token and inside runs starting at
    p, p - 1, p - 15, p - 16, p - 40 and 0 (run_packing: dead tokens and
    another slot's run beside it), bitwise equal to paged decode of the
    same token with cur_len = p + 1, in float32 and bf16; every other
    token of each run packing too. Inputs come from a generator of their
    own."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device=DEV).manual_seed(seed)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=DEV)
    counts = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, bt, _, _ = ragged_inputs(gen, [0] * RUN_L,
                                          list(range(RUN_L)), dtype)
        k, v = k[0], v[0]
        # the query rows of slots 1 and 2's tokens, after slot 0's
        q_all = torch.cat([q, torch.randn(21, *q.shape[1:], generator=gen,
                                          device=DEV).to(dtype)])
        rows_all = [0] * RUN_L + [1] * 20 + [2]
        pos_all = list(range(RUN_L)) + list(range(100, 120)) + [500]
        want = ops.paged_decode_attention(
            q_all, k, v, bt[i32(rows_all).long()].contiguous(),
            i32(pos_all) + 1)
        row_of = {(r, p): i for i, (r, p) in enumerate(zip(rows_all,
                                                           pos_all))}
        n_single, n_runs, bad = 0, 0, []
        for p in RUN_POSITIONS:
            one = ops.ragged_paged_attention(q[p:p + 1].contiguous(), k, v,
                                             bt, i32([0]), i32([p]))
            torch.cuda.synchronize()
            if not torch.equal(one[0], want[p]):
                bad.append(f"p{p}/single")
            n_single += 1
            for start in sorted({max(p - d, 0) for d in RUN_STARTS} | {0}):
                rows, pos, at = run_packing(p, start)
                idx = [row_of.get((r, x), 0) for r, x in zip(rows, pos)]
                out = ops.ragged_paged_attention(
                    q_all[idx].contiguous(), k, v, bt, i32(rows), i32(pos))
                live = torch.tensor([x >= 0 for x in pos], device=DEV)
                torch.cuda.synchronize()
                if not torch.equal(out[at], want[p]):
                    bad.append(f"p{p}/from{start}")
                elif not torch.equal(out[live], want[[i for i, x in
                                                       zip(idx, pos)
                                                       if x >= 0]]) or \
                        bool((out[~live] != 0).any()):
                    bad.append(f"p{p}/from{start}/other rows")
                n_runs += 1
        key = str(dtype)[6:]
        counts[key] = f"{n_single + n_runs - len(bad)}/{n_single + n_runs}"
        report["parity"][f"run_vs_single/{key}"] = dict(
            single=n_single, runs=n_runs, not_bitwise=bad)
        if bad:
            raise AssertionError(f"ROADMAP C4: rows that depend on their "
                                 f"packing ({key}): {bad}")
        del q, k, v, q_all
    log("3 parity", kernel="ragged_paged_attention (single token vs runs)",
        slot_positions=RUN_L, positions=",".join(map(str, RUN_POSITIONS)),
        run_starts="p-{" + ",".join(map(str, RUN_STARTS)) + "} and 0",
        bitwise_vs_paged_decode=counts, required="all")


def flat(res):
    """A kernel's output, or all its outputs (the fused gather-add's
    (h_out, x)) end to end, as one float32 vector."""
    parts = res if isinstance(res, tuple) else (res,)
    return torch.cat([x.float().flatten() for x in parts])


def timed(kern, plain, iters, plain_iters, tol):
    """A kernel's wrapper and its plain version on the same inputs: device
    time per call (``ms``, profiler), wall time per call back to back
    (``wall_ms``, CUDA events, host launch overhead included), their max
    abs difference over every output, which must be within tol (0: bitwise
    equal), and the share of output elements that differ at all
    (``differ``: in bf16, one ulp of rounding apart for most)."""
    res = dict(ms=device_ms(kern, iters),
               plain_ms=device_ms(plain, plain_iters),
               wall_ms=wall_ms(kern, iters),
               plain_wall_ms=wall_ms(plain, plain_iters))
    a, b = flat(kern(0)), flat(plain(0))
    res["err"] = (a - b).abs().max().item()
    res["differ"] = (a != b).float().mean().item()
    ok = (torch.equal(a, b) if tol == 0
          else torch.allclose(a, b, atol=tol, rtol=tol))
    if not ok:
        raise AssertionError(f"timed kernel disagrees with its plain "
                             f"version: max abs err {res['err']}, tol {tol}")
    return res


def fmt_times(r) -> str:
    return (f"{r['ms']:.5f}ms(wall {r['wall_ms']:.4f}; plain "
            f"{r['plain_ms']:.4f}, wall {r['plain_wall_ms']:.4f}; bound "
            f"{r['bound_ms']:.5f}; err {r['err']:.2e}; differ "
            f"{r['differ']:.5f})")


def phase_times(gen, report):
    """Each kernel at the serving tick's shapes (bf16, a 256-token chunk
    plus 7 decode rows: T = 263), inputs rotated so L2 cannot serve
    repeated launches: 8 id sets for the gather-add, 32 pool layers for the
    attention (one per model layer, as the tick walks them)."""
    from repro_torch.kernels import aot_bias, decode_attention, ops
    rows_out = times_single_gather(gen, report)
    dt = torch.bfloat16
    # ---- gather-add fused with the norm: the serving tick (T 263) and a
    # decode tick (T 8)
    tables = (torch.randn(4, 49152, 960, generator=gen, device=DEV)
              * 0.03).to(dt)
    res = {}
    for T in (263, 8):
        h, tasks, ids = gather_inputs(gen, T, dt, tables, sets=8)
        args = lambda i: (h, tables, tasks[i % 8], ids[i % 8])
        res[T] = times_gather_norm(
            gen, h, lambda i, **kw: ops.aot_gather_add_multitask(*args(i),
                                                                 **kw),
            lambda i, **kw: aot_bias.aot_gather_add_multitask_plain(
                *args(i), **kw), 200)
    del tables
    report["times"]["aot_gather_add_multitask"] = res
    log("4 times", kernel="aot_gather_add_multitask", fused="norm",
        **{f"T{T}": fmt_gather_norm(r) for T, r in res.items()})
    rows_out.insert(1, gather_row("aot_gather_add_multitask",
                                  "src/repro/kernels/aot_bias.py:56",
                                  res[263]))
    # ---- ragged attention
    pk = packings()
    res = {}
    for name in ("chunk256_decode", "decode_only"):
        rows, pos = pk[name]
        q, k, v, bt, r, p = ragged_inputs(gen, rows, pos, dt, layers=32)
        # the plan, as the tick builds it on the host and uploads it
        rows_np = np.asarray(rows, np.int32)
        pos_np = np.asarray(pos, np.int32)
        t0 = time.perf_counter()
        for _ in range(1000):
            plan_np = decode_attention.ragged_plan(rows_np, pos_np)
        plan_us = (time.perf_counter() - t0) * 1e3
        plan = torch.from_numpy(plan_np).to(DEV)
        kern = lambda i: ops.ragged_paged_attention(q, k[i % 32], v[i % 32],
                                                    bt, r, p, plan)
        plain = lambda i: decode_attention.ragged_paged_attention_plain(
            q, k[i % 32], v[i % 32], bt, r, p)
        res[name] = timed(kern, plain, 64, 16, tol=TOL[dt])
        res[name]["bound_ms"], res[name]["bound_by"] = ragged_bound(rows, pos,
                                                                    dt)
        res[name]["T"] = len(rows)
        res[name]["plan_host_us"] = plan_us
        res[name]["plan_items"] = int(plan_np.shape[0])
        del q, k, v
    a = res["chunk256_decode"]
    rows_out.append({
        "name": "ragged_paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:286",
        "max_abs_err": a["err"], "ms": a["ms"], "plain_ms": a["plain_ms"],
        "bound_ms": a["bound_ms"], "bound_by": a["bound_by"],
        "library_ms": None})
    log("4 times", kernel="ragged_paged_attention",
        **{n: fmt_times(r) + f"[{r['bound_by']}, T{r['T']}, "
           f"{r['plan_items']} plan items, plan host "
           f"{r['plan_host_us']:.1f}us]" for n, r in res.items()})
    report["times"]["ragged_paged_attention"] = res
    rows_out += times_prefill_decode(gen, report)
    enc = times_encoder(gen, report)
    dec = times_decoders(gen, report)
    moe = times_moe(gen, report)
    rec = times_recurrent(gen, report)
    front = times_frontends(gen, report)
    for row in rows_out:
        if row["name"] in enc:
            row["encoder"] = enc[row["name"]]
        if row["name"] in dec:
            row["decoders"] = dec[row["name"]]
        if row["name"] in moe:
            row["moe"] = moe[row["name"]]
        if row["name"] in rec:
            row["recurrent"] = rec[row["name"]]
        if row["name"] in front:
            row["frontends"] = front[row["name"]]
    return rows_out


def times_encoder(gen, report):
    """The kernels at the paper's encoders' shapes, bf16 (phase 8's path):
    flash in full mode at g = 1 (16 heads over 16, hd 64) over 8 x 384
    (speed_overhead.py's largest cell) and 1 x 512, beside SDPA
    non-causal with no mask; both gather-adds in their plain mode (no
    norm: post-LN) at T 3072 = 8 x 384, d 1024, roberta's vocabulary
    (one task's table; 4 tasks' for the multi-task entry). Inputs rotate
    over 8 sets. Returns {kernel: its times, bound and shapes} for the
    kernels line's ``encoder`` entries (launches added by phase 8)."""
    import torch.nn.functional as F
    from repro_torch.kernels import aot_bias
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    dt, es, (h, kvh) = torch.bfloat16, 2, ENC_HEADS
    out, flash = {}, {}
    for b, s in ((8, 384), (1, 512)):
        qs = [flash_inputs(gen, b, s, s, HD, dt, heads=ENC_HEADS)
              for _ in range(8)]
        kern = lambda i: ops.flash_attention(*qs[i % 8], causal=False)
        plain = lambda i: fa.flash_attention_plain(*qs[i % 8], causal=False)
        r = timed(kern, plain, 32, 8, tol=TOL[dt])
        sdpa = lambda i: F.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in qs[i % 8]))
        r["library_ms"] = device_ms(sdpa, 32)        # yardstick only
        r["bound_ms"], r["bound_by"] = bound(
            b * s * (2 * h + 2 * kvh) * HD * es, 4 * HD * h * s * s * b, dt)
        flash[f"b{b}_s{s}"] = r
        del qs
    log("4 times", kernel="flash_attention", mode="full g1 (encoders)", **{
        k: fmt_times(r) + f"[{r['bound_by']}; library "
        f"{r['library_ms']:.5f}]" for k, r in flash.items()})
    r = flash["b8_s384"]
    out["flash_attention"] = dict(shape="b8 s384 h16 kvh16 hd64 full",
                                  **_enc_row(r), b1_s512=_enc_row(
                                      flash["b1_s512"]))
    T, vocab = 8 * 384, ENC_VOCABS[0]
    tables = (torch.randn(4, vocab, ENC_D, generator=gen, device=DEV)
              * 0.03).to(dt)
    hs = [torch.randn(T, ENC_D, generator=gen, device=DEV).to(dt)
          for _ in range(8)]
    ids = [torch.randint(0, vocab, (T,), generator=gen, device=DEV,
                         dtype=torch.int32) for _ in range(8)]
    tasks = [torch.randint(0, 4, (T,), generator=gen, device=DEV,
                           dtype=torch.int32) for _ in range(8)]
    calls = {
        "aot_gather_add": (
            lambda i: ops.aot_gather_add(hs[i % 8], tables[0], ids[i % 8]),
            lambda i: aot_bias.aot_gather_add_plain(hs[i % 8], tables[0],
                                                    ids[i % 8])),
        "aot_gather_add_multitask": (
            lambda i: ops.aot_gather_add_multitask(hs[i % 8], tables,
                                                   tasks[i % 8], ids[i % 8]),
            lambda i: aot_bias.aot_gather_add_multitask_plain(
                hs[i % 8], tables, tasks[i % 8], ids[i % 8]))}
    gathers = {}
    for name, (kern, plain) in calls.items():
        r = gathers[name] = timed(kern, plain, 200, 50, tol=0)
        r["library_ms"] = None      # no one PyTorch call gathers and adds
        # h and a table row read, the sum written, the ids (and task ids)
        r["bound_ms"] = (3 * T * ENC_D * es + 4 * T * (
            2 if name.endswith("multitask") else 1)) / HBM_BYTES_PER_S * 1e3
        r["bound_by"] = "bytes"
        out[name] = dict(shape=f"T{T} d{ENC_D} V{vocab} plain mode",
                         **_enc_row(r))
    del tables, hs
    log("4 times", kernel="aot_gather_add / _multitask",
        mode="plain (encoders)", **{k: fmt_times(r) + "[bytes; library none]"
                                    for k, r in gathers.items()})
    report["times"]["encoder"] = dict(flash=flash, gathers=gathers)
    return out


def times_decoders(gen, report):
    """The kernels at phase 10's new shapes, bf16: flash over one prompt
    of 6144 at danube's heads (h32 kvh8 hd80) with its window of 4096,
    beside SDPA with a bool mask; contiguous decode over danube's full
    ring (b 4, S 4096) beside SDPA with a length mask; the multi-task
    gather-add fused with the norm at d 2560 (danube, 4 tasks of V 32000)
    and d 5120 (qwen2.5, 2 tasks of V 152064), T 263. Inputs rotate over
    8 sets (decode: ROTATE layers). Returns {kernel: {shape: numbers}} for
    the kernels line's ``decoders`` entries (launches added by phase
    10)."""
    import torch.nn.functional as F
    from repro_torch.kernels import aot_bias
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    dt, es = torch.bfloat16, 2
    (h, kvh), hd, out = DANUBE_HEADS, 80, {}
    # ---- flash: (1, 6144) causal with the window of 4096
    s, window = 6144, 4096
    qs = [flash_inputs(gen, 1, s, s, hd, dt, heads=DANUBE_HEADS)
          for _ in range(4)]
    kern = lambda i: ops.flash_attention(*qs[i % 4], window=window)
    plain = lambda i: fa.flash_attention_plain(*qs[i % 4], window=window)
    r = timed(kern, plain, 16, 2, tol=TOL[dt])
    pos = torch.arange(s, device=DEV)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                             - window)
    sdpa = lambda i: F.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in qs[i % 4]), attn_mask=mask,
        enable_gqa=True)
    r["library_ms"] = device_ms(sdpa, 16)          # yardstick only
    pairs = h * int(mask.sum().item())              # visible (head, q, kv)
    r["bound_ms"], r["bound_by"] = bound(s * (2 * h + 2 * kvh) * hd * es,
                                         4 * hd * pairs, dt)
    out["flash_attention"] = {"danube_b1_s6144_window4096": dict(
        shape="b1 s6144 h32 kvh8 hd80 causal window 4096", **_enc_row(r))}
    log("4 times", kernel="flash_attention", mode="window 4096 (danube)",
        b1_s6144=fmt_times(r) + f"[{r['bound_by']}; library "
        f"{r['library_ms']:.5f}]")
    del qs, mask
    # ---- contiguous decode over the full ring: b 4, S = cur = 4096
    S = window
    q, k, v, cur = decode_inputs(gen, [S] * 4, dt, hd, layers=ROTATE, S=S,
                                 heads=DANUBE_HEADS)
    layer = lambda i: (k[i % ROTATE], v[i % ROTATE])
    kern = lambda i: ops.decode_attention(q, *layer(i), cur)
    plain = lambda i: da.decode_attention_plain(q, *layer(i), cur)
    r = timed(kern, plain, 64, 16, tol=TOL[dt])
    mask = (torch.arange(S, device=DEV)[None, :]
            < cur[:, None])[:, None, None, :]
    sdpa = lambda i: F.scaled_dot_product_attention(
        q[:, :, None], *(x.transpose(1, 2) for x in layer(i)),
        attn_mask=mask, enable_gqa=True)
    r["library_ms"] = device_ms(sdpa, 64)          # yardstick only
    n_kv = 4 * S
    r["bound_ms"], r["bound_by"] = bound(
        2 * 4 * h * hd * es + 2 * n_kv * kvh * hd * es + 16, 4 * hd * h * n_kv,
        dt)
    out["decode_attention"] = {"danube_ring_b4_S4096": dict(
        shape="b4 h32 kvh8 hd80 S4096 (the ring, full)", **_enc_row(r))}
    log("4 times", kernel="decode_attention", mode="ring (danube)",
        b4_S4096=fmt_times(r) + f"[{r['bound_by']}; library "
        f"{r['library_ms']:.5f}]")
    del q, k, v
    # ---- the fused multi-task gather-add at d 2560 and 5120
    gathers = {}
    for d, (n_tasks, vocab) in ((2560, (4, 32000)), (5120, (2, 152064))):
        tables = (torch.randn(n_tasks, vocab, d, generator=gen, device=DEV,
                              dtype=dt) * 0.02)
        hh, tasks, ids = gather_inputs(gen, 263, dt, tables, sets=8)
        args = lambda i: (hh, tables, tasks[i % 8], ids[i % 8])
        r = times_gather_norm(
            gen, hh, lambda i, **kw: ops.aot_gather_add_multitask(*args(i),
                                                                  **kw),
            lambda i, **kw: aot_bias.aot_gather_add_multitask_plain(
                *args(i), **kw), 200)
        r["library_ms"], r["bound_by"] = None, "bytes"
        gathers[f"d{d}"] = r
        out.setdefault("aot_gather_add_multitask", {})[f"T263_d{d}"] = dict(
            shape=f"T263 d{d} {n_tasks} tasks of V{vocab} +norm",
            **_enc_row(r), replaced_ms=r["replaced_ms"],
            library_norm_ms=r["library_norm_ms"])
        del tables, hh
    log("4 times", kernel="aot_gather_add_multitask", fused="norm",
        mode="decoders", **{k: fmt_gather_norm(r)
                            for k, r in gathers.items()})
    report["times"]["decoders"] = dict(out)
    return out


def times_moe(gen, report):
    """The kernels at phase 11's new shapes, bf16, qwen3-moe's heads (h32
    kvh4 hd128, g = 8): flash at its static batch's prefill (16 x 512,
    causal) beside SDPA, contiguous decode at its steps (16 rows at depths
    512-575 of S 1024) beside SDPA with a length mask, paged decode over 8
    slots of depths up to 1024, ragged attention on the serving tick's
    packings (T 263 and a decode-only tick); the multi-task gather-add
    fused with the norm at T 263 over MOE_GATHERS' tables (qwen3-moe d
    2048, llama4 d 5120). Inputs rotate as in phase 4. Returns {kernel:
    {shape: numbers}} for the kernels line's ``moe`` entries (launches
    added by phase 11)."""
    import torch.nn.functional as F
    from repro_torch.kernels import aot_bias
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    dt, es = torch.bfloat16, 2
    (h, kvh), hd, out, text = MOE_HEADS, 128, {}, {}
    shape = f"h{h} kvh{kvh} hd{hd}"

    def keep(kernel, key, desc, r, lib=True):
        out.setdefault(kernel, {})[key] = dict(shape=f"{desc} {shape}",
                                               **_enc_row(r))
        text[f"{kernel}/{key}"] = fmt_times(r) + (
            f"[{r['bound_by']}; library {r['library_ms']:.5f}]"
            if r["library_ms"] is not None else f"[{r['bound_by']}]")
    # ---- flash: (16, 512) causal
    b, s = 16, 512
    qs = [flash_inputs(gen, b, s, s, hd, dt, heads=MOE_HEADS)
          for _ in range(4)]
    r = timed(lambda i: ops.flash_attention(*qs[i % 4], causal=True),
              lambda i: fa.flash_attention_plain(*qs[i % 4], causal=True),
              16, 4, tol=TOL[dt])
    r["library_ms"] = device_ms(lambda i: F.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in qs[i % 4]), is_causal=True,
        enable_gqa=True), 16)                       # yardstick only
    pairs = b * h * s * (s + 1) // 2
    r["bound_ms"], r["bound_by"] = bound(b * s * (2 * h + 2 * kvh) * hd * es,
                                         4 * hd * pairs, dt)
    keep("flash_attention", "b16_s512_causal", "b16 s512 causal", r)
    del qs
    # ---- contiguous decode: 16 rows at depths 512..575 of S 1024
    lens = list(range(512, 576, 4))
    q, k, v, cur = decode_inputs(gen, lens, dt, hd, layers=ROTATE,
                                 heads=MOE_HEADS)
    layer = lambda i: (k[i % ROTATE], v[i % ROTATE])
    r = timed(lambda i: ops.decode_attention(q, *layer(i), cur),
              lambda i: da.decode_attention_plain(q, *layer(i), cur),
              64, 16, tol=TOL[dt])
    mask = (torch.arange(MAX_LEN, device=DEV)[None, :]
            < cur[:, None])[:, None, None, :]
    r["library_ms"] = device_ms(lambda i: F.scaled_dot_product_attention(
        q[:, :, None], *(x.transpose(1, 2) for x in layer(i)),
        attn_mask=mask, enable_gqa=True), 64)     # yardstick only
    n_kv = sum(lens)
    r["bound_ms"], r["bound_by"] = bound(
        2 * len(lens) * h * hd * es + 2 * n_kv * kvh * hd * es
        + 4 * len(lens), 4 * hd * h * n_kv, dt)
    keep("decode_attention", "b16_depth512-575", "b16 depths 512-575", r)
    del q, k, v
    # ---- paged decode: 8 slots of depths up to 1024, scrambled pages
    plens = [1024, 1000, 777, 576, 512, 300, 129, 17]
    q = torch.randn(SLOTS, h, hd, generator=gen, device=DEV).to(dt)
    kp = torch.randn(ROTATE, NUM_BLOCKS, BS, kvh, hd, generator=gen,
                     device=DEV).to(dt)
    vp = torch.randn(ROTATE, NUM_BLOCKS, BS, kvh, hd, generator=gen,
                     device=DEV).to(dt)
    perm = torch.randperm(NUM_BLOCKS - 1, generator=gen, device=DEV) + 1
    bt = perm.view(SLOTS, NPAGES).to(torch.int32)
    cur = torch.tensor(plens, dtype=torch.int32, device=DEV)
    layer = lambda i: (kp[i % ROTATE], vp[i % ROTATE])
    r = timed(lambda i: ops.paged_decode_attention(q, *layer(i), bt, cur),
              lambda i: da.paged_decode_attention_plain(q, *layer(i), bt,
                                                        cur),
              64, 16, tol=TOL[dt])
    r["library_ms"] = None      # no one PyTorch call reads block tables
    n_kv = sum(plens)
    pages_read = sum(-(-n // BS) for n in plens)
    r["bound_ms"], r["bound_by"] = bound(
        2 * SLOTS * h * hd * es + 2 * n_kv * kvh * hd * es
        + 4 * (SLOTS + pages_read), 4 * hd * h * n_kv, dt)
    keep("paged_decode_attention", "slots8_depth<=1024",
         "8 slots depths 17-1024", r)
    del kp, vp
    # ---- ragged attention: the serving tick's packings
    pk = packings()
    for name in ("chunk256_decode", "decode_only"):
        rows, pos = pk[name]
        q, k, v, bt, rr, p = ragged_inputs(gen, rows, pos, dt, layers=ROTATE,
                                           hd=hd, heads=MOE_HEADS)
        plan = torch.from_numpy(da.ragged_plan(
            np.asarray(rows, np.int32), np.asarray(pos, np.int32))).to(DEV)
        r = timed(lambda i: ops.ragged_paged_attention(
            q, k[i % ROTATE], v[i % ROTATE], bt, rr, p, plan),
            lambda i: da.ragged_paged_attention_plain(
                q, k[i % ROTATE], v[i % ROTATE], bt, rr, p),
            64, 16, tol=TOL[dt])
        r["library_ms"] = None
        r["bound_ms"], r["bound_by"] = ragged_bound(rows, pos, dt,
                                                    heads=MOE_HEADS, hd=hd)
        keep("ragged_paged_attention", name, f"{name} T{len(rows)}", r)
        del q, k, v
    # ---- the fused multi-task gather-add at T 263
    for n_tasks, vocab, d in MOE_GATHERS:
        tables = torch.empty(n_tasks, vocab, d, dtype=dt, device=DEV)
        for t in range(n_tasks):
            tables[t].normal_(0.0, 0.02, generator=gen)
        hh, tasks, ids = gather_inputs(gen, 263, dt, tables, sets=8)
        args = lambda i: (hh, tables, tasks[i % 8], ids[i % 8])
        r = times_gather_norm(
            gen, hh, lambda i, **kw: ops.aot_gather_add_multitask(*args(i),
                                                                  **kw),
            lambda i, **kw: aot_bias.aot_gather_add_multitask_plain(
                *args(i), **kw), 200)
        r["library_ms"], r["bound_by"] = None, "bytes"
        out.setdefault("aot_gather_add_multitask", {})[f"T263_d{d}"] = dict(
            shape=f"T263 d{d} {n_tasks} tasks of V{vocab} +norm",
            **_enc_row(r), replaced_ms=r["replaced_ms"],
            library_norm_ms=r["library_norm_ms"])
        text[f"aot_gather_add_multitask/T263_d{d}"] = fmt_gather_norm(r)
        del tables, hh
    for key, line in text.items():
        log("4 times", mode="moe", case=key, times=line)
    report["times"]["moe"] = dict(out)
    return out


def times_recurrent(gen, report):
    """The kernels at phase 12's new shapes, bf16: flash at recurrentgemma's
    heads (h16 kvh1 hd256, the hd 256 build) over its static batch's
    prefill (4 x 3072) with the window of 2048, and causal and full, beside
    SDPA (a bool mask for the window, ``is_causal`` for causal); contiguous
    decode over its wrapped
    2048-row ring (b 4, g 16 in two clusters of 8, the wide walk) beside
    SDPA over the ring; the multi-task gather-add fused with the norm at d
    4096 (2 tasks of V 256000, T 263) and in its plain mode at xlstm's d
    1024 (4 tasks of V 50304, T 263: xLSTM's LayerNorm). Returns {kernel:
    {shape: numbers}} for the kernels line's ``recurrent`` entries
    (launches added by phase 12)."""
    import torch.nn.functional as F
    from repro_torch.kernels import aot_bias
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    dt, es = torch.bfloat16, 2
    (h, kvh), hd, out = RGEMMA_HEADS, RGEMMA_HD, {}
    b, s, window = RING_ROWS, 3072, RGEMMA_WINDOW
    qs = [flash_inputs(gen, b, s, s, hd, dt, heads=RGEMMA_HEADS)
          for _ in range(2)]
    pos = torch.arange(s, device=DEV)
    flash = {}
    for mode, (causal, win) in (("window2048", (True, window)),
                                ("causal", (True, 0)),
                                ("full", (False, 0))):
        kern = lambda i: ops.flash_attention(*qs[i % 2], causal=causal,
                                             window=win)
        plain = lambda i: fa.flash_attention_plain(*qs[i % 2],
                                                   causal=causal, window=win)
        r = timed(kern, plain, 8, 2, tol=TOL[dt])
        mask = torch.ones(s, s, dtype=torch.bool, device=DEV)
        if causal:
            mask &= pos[None, :] <= pos[:, None]
        if win:
            mask &= pos[None, :] > pos[:, None] - win
        sdpa = lambda i: F.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in qs[i % 2]),
            attn_mask=mask if win else None, is_causal=mode == "causal",
            enable_gqa=True)
        r["library_ms"] = device_ms(sdpa, 8)           # yardstick only
        pairs = b * h * int(mask.sum().item())          # visible pairs
        r["bound_ms"], r["bound_by"] = bound(
            b * s * (2 * h + 2 * kvh) * hd * es, 4 * hd * pairs, dt)
        flash[mode] = r
        del mask
    log("4 times", kernel="flash_attention", mode="hd256 (recurrentgemma)",
        **{f"b4_s3072_{k}": fmt_times(r) + f"[{r['bound_by']}; library "
           f"{r['library_ms']:.5f}]" for k, r in flash.items()})
    out["flash_attention"] = {"rgemma_b4_s3072_window2048": dict(
        shape="b4 s3072 h16 kvh1 hd256 causal window 2048",
        **_enc_row(flash["window2048"]),
        causal=_enc_row(flash["causal"]), full=_enc_row(flash["full"]))}
    del qs
    # ---- contiguous decode over the full ring: b 4, S = cur = 2048
    S = window
    q, k, v, cur = decode_inputs(gen, [S] * b, dt, hd, layers=8, S=S,
                                 heads=RGEMMA_HEADS)
    layer = lambda i: (k[i % 8], v[i % 8])
    kern = lambda i: ops.decode_attention(q, *layer(i), cur)
    plain = lambda i: da.decode_attention_plain(q, *layer(i), cur)
    r = timed(kern, plain, 64, 16, tol=TOL[dt])
    mask = (torch.arange(S, device=DEV)[None, :]
            < cur[:, None])[:, None, None, :]
    sdpa = lambda i: F.scaled_dot_product_attention(
        q[:, :, None], *(x.transpose(1, 2) for x in layer(i)),
        attn_mask=mask, enable_gqa=True)
    r["library_ms"] = device_ms(sdpa, 64)              # yardstick only
    n_kv = b * S
    r["bound_ms"], r["bound_by"] = bound(
        2 * b * h * hd * es + 2 * n_kv * kvh * hd * es + 4 * b,
        4 * hd * h * n_kv, dt)
    out["decode_attention"] = {"rgemma_ring_b4_S2048": dict(
        shape="b4 h16 kvh1 hd256 S2048 (the ring, full)", **_enc_row(r))}
    log("4 times", kernel="decode_attention", mode="ring hd256 g16 "
        "(recurrentgemma)", b4_S2048=fmt_times(r) + f"[{r['bound_by']}; "
        f"library {r['library_ms']:.5f}]")
    decode = r
    del q, k, v
    # ---- the gather-adds: fused with RMSNorm at d 4096, plain at d 1024
    gathers = {}
    tables = (torch.randn(2, 256000, 4096, generator=gen, device=DEV,
                          dtype=dt) * 0.02)
    hh, tasks, ids = gather_inputs(gen, 263, dt, tables, sets=8)
    args = lambda i: (hh, tables, tasks[i % 8], ids[i % 8])
    r = times_gather_norm(
        gen, hh, lambda i, **kw: ops.aot_gather_add_multitask(*args(i), **kw),
        lambda i, **kw: aot_bias.aot_gather_add_multitask_plain(*args(i),
                                                                **kw), 200)
    r["library_ms"], r["bound_by"] = None, "bytes"
    gathers["rgemma_d4096_norm"] = r
    del tables, hh
    tables = (torch.randn(4, 50304, 1024, generator=gen, device=DEV,
                          dtype=dt) * 0.02)
    hh, tasks, ids = gather_inputs(gen, 263, dt, tables, sets=8)
    kern = lambda i: ops.aot_gather_add_multitask(*args(i))
    plain = lambda i: aot_bias.aot_gather_add_multitask_plain(*args(i))
    r = timed(kern, plain, 200, 50, tol=0)
    r["library_ms"], r["bound_by"] = None, "bytes"
    r["bound_ms"] = (3 * 263 * 1024 * es + 8 * 263) / HBM_BYTES_PER_S * 1e3
    gathers["xlstm_d1024_plain"] = r
    del tables, hh
    out["aot_gather_add_multitask"] = {
        "T263_d4096": dict(shape="T263 d4096 2 tasks of V256000 +norm",
                           **_enc_row(gathers["rgemma_d4096_norm"])),
        "T263_d1024_plain": dict(shape="T263 d1024 4 tasks of V50304 plain",
                                 **_enc_row(gathers["xlstm_d1024_plain"]))}
    log("4 times", kernel="aot_gather_add_multitask", mode="recurrent",
        rgemma_d4096_norm=fmt_gather_norm(gathers["rgemma_d4096_norm"]),
        xlstm_d1024_plain=fmt_times(gathers["xlstm_d1024_plain"])
        + "[bytes; library none]")
    report["times"]["recurrent"] = dict(flash=flash, decode=decode,
                                        gathers=gathers)
    return out


def _enc_row(r):
    """The numbers of one phase 4 timing that a kernels-line row carries."""
    return {k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                              "bound_by")} | {"max_abs_err": r["err"]}


def times_gather_norm(gen, h, call, plain_call, iters, sets=1):
    """The fused gather-add + norm ``call(i, norm=...)`` (the gather-add
    alone without ``norm``) at h's shape, bf16: device and wall time
    against its plain version ``plain_call`` (h_out bitwise, x within
    TOL); the sequence
    it replaces, the gather-add kernel then the plain norm (what
    ``layers.apply_norm`` launches), timed beside it; F.rms_norm alone on
    the summed h (a yardstick for the norm's half); at T <= HOST_T, host
    microseconds per call by perf_counter (the enqueue, no wait) of the
    fused wrapper, the gather-add wrapper alone and the replaced sequence
    (at larger T the device, not the host, would set the pace); the bound:
    bytes, h and a table row read, h_out and x written, the ids and the
    scale read once. ``sets``: how many input sets ``call(i)`` rotates
    through, so that F.rms_norm rotates as many sums."""
    import torch.nn.functional as F
    from repro_torch.kernels import aot_bias
    T, d = h.shape
    norm = (norm_scale(gen, d), EPS)
    kern = lambda i: call(i, norm=norm)
    plain = lambda i: plain_call(i, norm=norm)
    seq = lambda i: aot_bias.rms_norm_plain(call(i), *norm)
    res = timed(kern, plain, iters, iters // 4, tol=TOL[h.dtype])
    if not torch.equal(kern(0)[0], plain(0)[0]):
        raise AssertionError(f"fused gather-add T {T}: h_out not bitwise "
                             "the plain sum")
    res["replaced_ms"] = device_ms(seq, iters)
    res["replaced_wall_ms"] = wall_ms(seq, iters)
    summed = [call(i) for i in range(sets)]
    w = norm[0].to(h.dtype)
    res["library_norm_ms"] = device_ms(      # yardstick only
        lambda i: F.rms_norm(summed[i % sets], (d,), w, EPS), iters)
    res["host_us"] = {name: host_us(fn) for name, fn in (
        ("fused", kern), ("gather_add_alone", lambda i: call(i)),
        ("replaced", seq))} if T <= HOST_T else None
    es = h.element_size()
    res["bound_ms"] = max((4 * T * d * es + 8 * T + 4 * d) / HBM_BYTES_PER_S,
                          5 * T * d / FP32_FLOPS) * 1e3
    return res


HOST_T = 263        # the largest T whose calls host_us times


def host_us(fn, calls=500):
    """Host microseconds per call of fn(i), back to back without a wait
    (at T <= HOST_T each launch's device time is shorter than its host
    time, so the launch queue never fills)."""
    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        fn(i)
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def fmt_gather_norm(r) -> str:
    host = r["host_us"]
    return fmt_times(r) + (
        f"[replaced {r['replaced_ms']:.5f}ms (wall "
        f"{r['replaced_wall_ms']:.4f}); F.rms_norm "
        f"{r['library_norm_ms']:.5f}" + ("" if host is None else
                                         f"; host us fused {host['fused']:.1f}"
                                         f", gather-add alone "
                                         f"{host['gather_add_alone']:.1f}, "
                                         f"replaced {host['replaced']:.1f}")
        + "]")


def gather_row(name, replaces, r):
    """The kernels line's row of a fused gather-add: no one PyTorch call
    gathers, adds and normalises (F.rms_norm's time for the norm's half
    rides along as ``library_norm_ms``)."""
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/aot_gather_add.cu",
            "replaces": replaces, "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "replaced_ms": r["replaced_ms"],
            "library_norm_ms": r["library_norm_ms"]}


def times_single_gather(gen, report):
    """The single-table gather-add fused with the norm, and the norm alone
    (no table: the input norm of the methods without AoT), at the static
    batch's shapes, bf16: its prefill (T = 16 x 512) and a decode step (T =
    16), one task's table (49152, 960), 8 id sets rotated. The norm alone
    beside F.rms_norm (the same function: the scale's values are bf16's)
    and its bound (bytes: h read, x written). Returns both kernels' rows of
    the kernels line."""
    import torch.nn.functional as F
    from repro_torch.kernels import aot_bias, ops
    dt, d = torch.bfloat16, 960
    table = (torch.randn(49152, d, generator=gen, device=DEV) * 0.03).to(dt)
    res, alone = {}, {}
    for T in (16 * 512, 16):
        h = torch.randn(T, d, generator=gen, device=DEV).to(dt)
        ids = [torch.randint(0, 49152, (T,), generator=gen, device=DEV,
                             dtype=torch.int32) for _ in range(8)]
        res[T] = times_gather_norm(
            gen, h, lambda i, **kw: ops.aot_gather_add(h, table, ids[i % 8],
                                                       **kw),
            lambda i, **kw: aot_bias.aot_gather_add_plain(h, table,
                                                          ids[i % 8], **kw),
            200)
        hs = [torch.randn(T, d, generator=gen, device=DEV).to(dt)
              for _ in range(8)]
        scale = norm_scale(gen, d)
        kern = lambda i: ops.rms_norm(hs[i % 8], scale, EPS)
        plain = lambda i: aot_bias.rms_norm_plain(hs[i % 8], scale, EPS)
        r = alone[T] = timed(kern, plain, 200, 50, tol=TOL[dt])
        w = scale.to(dt)
        r["library_ms"] = device_ms(       # yardstick only
            lambda i: F.rms_norm(hs[i % 8], (d,), w, EPS), 200)
        r["host_us"] = host_us(kern) if T <= HOST_T else None
        r["bound_ms"] = (2 * T * d * 2 + 4 * d) / HBM_BYTES_PER_S * 1e3
        del hs
    del table
    report["times"]["aot_gather_add"] = res
    report["times"]["rms_norm"] = alone
    log("4 times", kernel="aot_gather_add", fused="norm",
        **{f"T{T}": fmt_gather_norm(r) for T, r in res.items()})
    log("4 times", kernel="rms_norm", **{
        f"T{T}": fmt_times(r) + f"[bytes; library {r['library_ms']:.5f}"
        + ("" if r["host_us"] is None else f"; host us {r['host_us']:.1f}")
        + "]" for T, r in alone.items()})
    r = alone[16 * 512]
    return [gather_row("aot_gather_add", "src/repro/kernels/aot_bias.py:27",
                       res[16 * 512]),
            {"name": "rms_norm", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/aot_gather_add.cu",
             "replaces": "src/repro/models/layers.py:57",
             "note": "not a TPU kernel (the reference's norm is XLA's); the "
                     "gather-add's body with no table",
             "max_abs_err": r["err"], "ms": r["ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": "bytes", "library_ms": r["library_ms"]}]


def times_flash_offset(gen, report):
    """Flash attention at P-Tuning v2's prefill shape, bf16: 16 prompts of
    512 queries at positions 20.. over 532 keys (the 20-position prefix
    and the prompt), causal, beside SDPA with the same mask given as an
    explicit boolean mask (a yardstick only)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    dt, es, b, s, off = torch.bfloat16, 2, 16, 512, 20
    qs = [flash_inputs(gen, b, s, s + off, HD, dt) for _ in range(8)]
    kern = lambda i: ops.flash_attention(*qs[i % 8], causal=True,
                                         q_offset=off)
    plain = lambda i: fa.flash_attention_plain(*qs[i % 8], causal=True,
                                               q_offset=off)
    res = timed(kern, plain, 32, 8, tol=TOL[dt])
    mask = (torch.arange(s + off, device=DEV)[None, :]
            <= off + torch.arange(s, device=DEV)[:, None])     # (sq, skv)
    sdpa = lambda i: F.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in qs[i % 8]), attn_mask=mask,
        enable_gqa=True)
    res["library_ms"] = device_ms(sdpa, 32)      # yardstick only
    pairs = b * H * (s * off + s * (s + 1) // 2)   # visible (head, q, kv)
    res["bound_ms"], res["bound_by"] = bound(
        2 * b * s * H * HD * es + 2 * b * (s + off) * KVH * HD * es,
        4 * HD * pairs, dt)
    del qs
    report["times"]["flash_attention_q_offset"] = res
    log("4 times", kernel="flash_attention", shape=f"ptv2 b{b} sq{s} "
        f"skv{s + off} q_offset{off}", times=fmt_times(res)
        + f"[{res['bound_by']}; library {res['library_ms']:.5f}]")


def times_flash_one_prompt(gen, report):
    """Flash attention at a whole-prompt stream's prefill, bf16: one prompt
    of 512, causal (8 query tiles x 15 heads = 120 blocks of the bf16
    kernel on 132 SMs: whether one prompt fills the card), ROTATE layers of
    inputs, beside SDPA (a yardstick only)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    dt, es, s = torch.bfloat16, 2, 512
    qs = [flash_inputs(gen, 1, s, s, HD, dt) for _ in range(ROTATE)]
    kern = lambda i: ops.flash_attention(*qs[i % ROTATE], causal=True)
    plain = lambda i: fa.flash_attention_plain(*qs[i % ROTATE], causal=True)
    res = timed(kern, plain, 64, 16, tol=TOL[dt])
    sdpa = lambda i: F.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in qs[i % ROTATE]), is_causal=True,
        enable_gqa=True)
    res["library_ms"] = device_ms(sdpa, 64)      # yardstick only
    res["bound_ms"], res["bound_by"] = bound(
        s * (2 * H + 2 * KVH) * HD * es, 4 * HD * H * s * (s + 1) // 2, dt)
    del qs
    report["times"]["flash_attention_one_prompt"] = res
    log("4 times", kernel="flash_attention", shape=f"b1 sq{s} causal",
        times=fmt_times(res) + f"[{res['bound_by']}; library "
        f"{res['library_ms']:.5f}]")


def times_prefill_decode(gen, report):
    """The three kernels of the whole-prompt and decode paths at those
    paths' shapes, bf16: flash at the static batch's prefill (16 prompts of
    512, causal), contiguous decode at its steps (16 rows at depths
    512-575 of S = 1024), paged decode over 8 slots of depths up to 1024.
    Inputs rotate over ROTATE layers so L2 cannot serve repeated launches."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    dt, es, rows_out = torch.bfloat16, 2, []
    # ---- flash attention: (16, 512, 15, 64) causal, 8 layers of inputs
    b, s = 16, 512
    qs = [flash_inputs(gen, b, s, s, HD, dt) for _ in range(8)]
    kern = lambda i: ops.flash_attention(*qs[i % 8], causal=True)
    plain = lambda i: fa.flash_attention_plain(*qs[i % 8], causal=True)
    res = timed(kern, plain, 32, 8, tol=TOL[dt])
    sdpa = lambda i: F.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in qs[i % 8]), is_causal=True,
        enable_gqa=True)
    res["library_ms"] = device_ms(sdpa, 32)      # yardstick only
    pairs = b * H * s * (s + 1) // 2               # visible (head, q, kv)
    res["bound_ms"], res["bound_by"] = bound(
        b * s * (2 * H + 2 * KVH) * HD * es, 4 * HD * pairs, dt)
    rows_out.append(dict(name="flash_attention",
                         source="src/repro_torch/kernels/csrc/"
                                "flash_attention.cu",
                         replaces="src/repro/kernels/flash_attention.py:73",
                         res=res))
    del qs
    times_flash_one_prompt(gen, report)
    times_flash_offset(gen, report)
    # ---- contiguous decode: 16 rows at depths 512..575 of S = 1024
    lens = list(range(512, 576, 4))
    q, k, v, cur = decode_inputs(gen, lens, dt, layers=ROTATE)
    layer = lambda i: (k[i % ROTATE], v[i % ROTATE])
    kern = lambda i: ops.decode_attention(q, *layer(i), cur)
    plain = lambda i: da.decode_attention_plain(q, *layer(i), cur)
    res = timed(kern, plain, 64, 16, tol=TOL[dt])
    mask = (torch.arange(MAX_LEN, device=DEV)[None, :]
            < cur[:, None])[:, None, None, :]   # (b, 1, 1, S): visible
    sdpa = lambda i: F.scaled_dot_product_attention(
        q[:, :, None], *(x.transpose(1, 2) for x in layer(i)),
        attn_mask=mask, enable_gqa=True)
    res["library_ms"] = device_ms(sdpa, 64)      # yardstick only
    n_kv = sum(lens)
    res["bound_ms"], res["bound_by"] = bound(
        2 * len(lens) * H * HD * es + 2 * n_kv * KVH * HD * es
        + 4 * len(lens), 4 * HD * H * n_kv, dt)
    rows_out.append(dict(name="decode_attention",
                         source="src/repro_torch/kernels/csrc/"
                                "decode_attention.cu",
                         replaces="src/repro/kernels/decode_attention.py:97",
                         res=res))
    del q, k, v
    # ---- paged decode: 8 slots of depths up to 1024, scrambled pages
    plens = [1024, 1000, 777, 576, 512, 300, 129, 17]
    q = torch.randn(SLOTS, H, HD, generator=gen, device=DEV).to(dt)
    kp = torch.randn(ROTATE, NUM_BLOCKS, BS, KVH, HD, generator=gen,
                     device=DEV).to(dt)
    vp = torch.randn(ROTATE, NUM_BLOCKS, BS, KVH, HD, generator=gen,
                     device=DEV).to(dt)
    perm = torch.randperm(NUM_BLOCKS - 1, generator=gen, device=DEV) + 1
    bt = perm.view(SLOTS, NPAGES).to(torch.int32)
    cur = torch.tensor(plens, dtype=torch.int32, device=DEV)
    layer = lambda i: (kp[i % ROTATE], vp[i % ROTATE])
    kern = lambda i: ops.paged_decode_attention(q, *layer(i), bt, cur)
    plain = lambda i: da.paged_decode_attention_plain(q, *layer(i), bt, cur)
    res = timed(kern, plain, 64, 16, tol=TOL[dt])
    res["library_ms"] = None        # no one PyTorch call reads block tables
    n_kv = sum(plens)
    pages_read = sum(-(-n // BS) for n in plens)
    res["bound_ms"], res["bound_by"] = bound(
        2 * SLOTS * H * HD * es + 2 * n_kv * KVH * HD * es
        + 4 * (SLOTS + pages_read), 4 * HD * H * n_kv, dt)
    rows_out.append(dict(name="paged_decode_attention",
                         source="src/repro_torch/kernels/csrc/"
                                "decode_attention.cu",
                         replaces="src/repro/kernels/decode_attention.py:186",
                         res=res))
    del kp, vp
    out = []
    for row in rows_out:
        r = row.pop("res")
        report["times"][row["name"]] = r
        lib = r["library_ms"]
        log("4 times", kernel=row["name"], times=fmt_times(r) + (
            f"[{r['bound_by']}; library {lib:.5f}]" if lib is not None
            else f"[{r['bound_by']}; library none]"))
        out.append({"name": row["name"], "route": "cuda",
                    "source": row["source"], "replaces": row["replaces"],
                    "max_abs_err": r["err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": lib})
    return out


# the launcher's flags of every served stream: full-width smollm-360m in
# bf16, 4 fused tasks, a Poisson stream of prompts of 4-512 tokens
BASE = ["--arch", "smollm-360m", "--demo", "--tasks", "4",
        "--rate", "0.5", "--slots", str(SLOTS), "--block-size", str(BS),
        "--max-len", str(MAX_LEN), "--prefill-chunk", "256",
        "--max-prefills", "4", "--prompt", "512", "--steps", "48",
        "--dtype", "bfloat16", "--quiet"]
GREEDY = ["--requests", "16"]
# the path run whose count is each kernel's ``launches``
MAIN_PATH = {"aot_gather_add": "peft_aot",
             "aot_gather_add_multitask": "paged_greedy",
             "rms_norm": "peft_none",
             "ragged_paged_attention": "paged_greedy",
             "flash_attention": "static_mixed",
             "decode_attention": "static_mixed",
             "paged_decode_attention": "static_paged"}


def build_engine():
    """The launcher's engine for BASE (random weights, seed 0), and the
    seconds it took."""
    from repro_torch.launch import serve as launcher
    t0 = time.perf_counter()
    engine = launcher.build_engine(launcher.parser().parse_args(BASE))
    torch.cuda.synchronize()
    return engine, time.perf_counter() - t0


def phase_main_path(report, engine, setup_s):
    """The paged streams (chunked prefill): greedy, then sampled."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launcher
    runs = {"greedy": GREEDY,
            "sampled": ["--requests", "4", "--temperature", "0.8",
                        "--top-p", "0.9", "--seed", "100"]}
    layers = engine.model.cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    total, launches = {}, {}
    for label, extra in runs.items():
        args = launcher.parser().parse_args(BASE + extra)
        arrivals = launcher.make_arrivals(args, engine.model.cfg.vocab_size,
                                          args.tasks)
        d0 = engine.dispatches
        torch.cuda.synchronize()
        ops.reset_launches()            # each run's own counts, from 0
        t1 = time.perf_counter()
        sched = launcher.serve(engine, args, arrivals)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t1
        counts = launches[label] = dict(ops.launches())
        dispatched = engine.dispatches - d0
        prompt_toks = sum(len(r.prompt) for _, r in arrivals)
        findings = sched.drain_check()
        log(f"5 main path/{label}", requests=f"{len(sched.finished)}/"
            f"{len(arrivals)}", tokens=sched.tokens_emitted,
            prompt_tokens=prompt_toks, ticks=sched.ticks,
            dispatched=dispatched, preemptions=sched.preemptions,
            seconds=f"{sec:.3f}",
            tokens_per_s=f"{sched.tokens_emitted / sec:.1f}",
            all_tokens_per_s=f"{(sched.tokens_emitted + prompt_toks) / sec:.1f}",
            drain="clean" if not findings else findings,
            launches=counts, finite="all reported rows")
        if len(sched.finished) != len(arrivals) or findings:
            raise AssertionError(f"{label}: unfinished requests or leaks")
        check_launches(label, counts, {
            "aot_gather_add_multitask": layers * dispatched,
            "ragged_paged_attention": layers * dispatched})
        total[label] = dict(requests=len(sched.finished),
                            tokens=sched.tokens_emitted,
                            prompt_tokens=prompt_toks, ticks=sched.ticks,
                            dispatched=dispatched, seconds=sec,
                            tokens_per_s=sched.tokens_emitted / sec,
                            preemptions=sched.preemptions, launches=counts,
                            streams=stream_outs(sched.finished))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log("5 main path", layers=layers, setup_s=f"{setup_s:.1f}",
        peak_memory_gib=f"{peak:.2f}",
        table_gib=f"{engine.tables.numel() * 2 / 2 ** 30:.2f}")
    report["main_path"] = dict(runs=total, peak_memory_gib=peak,
                               setup_s=setup_s)
    # where the time goes: the sampled stream once more under the profiler
    # (its tracing slows the host, so the busy share is a lower bound)
    args = launcher.parser().parse_args(BASE + runs["sampled"])
    arrivals = launcher.make_arrivals(args, engine.model.cfg.vocab_size,
                                      args.tasks)
    report["profile"] = profile_run(
        "5 profile", lambda: launcher.serve(engine, args, arrivals),
        steps=total["sampled"]["ticks"])    # a tick is one step
    return {f"paged_{label}": counts for label, counts in launches.items()}


def check_launches(label, counts, want):
    """Each kernel's launches in one path's run must be exactly ``want``
    (kernels not named there: 0)."""
    for name, c in counts.items():
        if c != want.get(name, 0):
            raise AssertionError(f"{label}: {name} launched {c} times, "
                                 f"expected {want.get(name, 0)}")


def phase_whole_prompt(report, engine):
    """Phase 5's greedy stream with whole-prompt admission: through the
    slotted layout (flash prefill per request, then one contiguous decode
    call per tick) and through the paged layout with --prefill-chunk 0
    (flash prefill scattered into pages, then one ragged tick per tick)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launcher
    layers = engine.model.cfg.num_layers
    runs = {"slots_greedy": ["--layout", "slots", "--prefill-chunk", "0"],
            "paged_whole_greedy": ["--layout", "paged", "--prefill-chunk",
                                   "0"]}
    out = {}
    prefill = engine.prefill_request
    for label, extra in runs.items():
        args = launcher.parser().parse_args(BASE + GREEDY + extra)
        arrivals = launcher.make_arrivals(args, engine.model.cfg.vocab_size,
                                          args.tasks)
        n_pf = [0]

        def counted(*a, **kw):
            n_pf[0] += 1
            return prefill(*a, **kw)
        engine.prefill_request = counted        # counts whole prefills
        d0 = engine.dispatches
        torch.cuda.synchronize()
        ops.reset_launches()
        t1 = time.perf_counter()
        try:
            sched = launcher.serve(engine, args, arrivals)
            torch.cuda.synchronize()
        finally:
            del engine.prefill_request
        sec = time.perf_counter() - t1
        counts = out[label] = dict(ops.launches())
        steps = engine.dispatches - d0 - n_pf[0]   # decode / serve_step calls
        attn = "decode_attention" if args.layout == "slots" \
            else "ragged_paged_attention"
        findings = sched.drain_check()
        prompt_toks = sum(len(r.prompt) for _, r in arrivals)
        log(f"5b whole-prompt/{label}", requests=f"{len(sched.finished)}/"
            f"{len(arrivals)}", tokens=sched.tokens_emitted,
            prompt_tokens=prompt_toks, ticks=sched.ticks, prefills=n_pf[0],
            decode_calls=steps, preemptions=sched.preemptions,
            seconds=f"{sec:.3f}",
            tokens_per_s=f"{sched.tokens_emitted / sec:.1f}",
            all_tokens_per_s=f"{(sched.tokens_emitted + prompt_toks) / sec:.1f}",
            drain="clean" if not findings else findings, launches=counts)
        if len(sched.finished) != len(arrivals) or findings:
            raise AssertionError(f"{label}: unfinished requests or leaks")
        check_launches(label, counts, {
            "flash_attention": layers * n_pf[0], attn: layers * steps,
            "aot_gather_add_multitask": layers * (n_pf[0] + steps)})
        report.setdefault("whole_prompt", {})[label] = dict(
            requests=len(sched.finished), tokens=sched.tokens_emitted,
            prompt_tokens=prompt_toks, ticks=sched.ticks, prefills=n_pf[0],
            decode_calls=steps, seconds=sec,
            tokens_per_s=sched.tokens_emitted / sec,
            preemptions=sched.preemptions, launches=counts,
            streams=sample_outs(sched.finished))
    return out


# ---------------------------------------------------------------------------
# phase 5e: the faulted tick (tick retries, NaN watchdog, chaos, shutdown)
# ---------------------------------------------------------------------------

FAULT_LAYER = 16        # F1's raised attempt runs this many layers, raises
F1_ALLOC_TICK = 4       # F1: alloc_failure on the first chunk tick from here
F1_RAISE_TICK = 12      # F1: the raise on the first chunk tick from here
F2_TICK = 45            # F2: NaN on the first decode-only tick from here
# F3: every kind but crash; the seed is one whose every kind fires on
# phase 5's stream (tests/test_torch_smoke_checks.py replays it on the CPU)
F3_PLAN = dict(seed=32, horizon=64, p_exhaust=0.08, exhaust_pages=480,
               exhaust_ticks=3, p_straggler=0.1, straggler_ms=0.5,
               p_disconnect=0.05, p_malformed=0.08, p_nan=0.05,
               p_alloc_failure=0.05)
F3_KINDS = ("exhaust", "straggler", "disconnect", "malformed", "nan",
            "alloc_failure")
F3_SHUTDOWN_CLOCK = 56  # after the last arrival (43), with work still live
F3_GRACE = 4


def stream_ticks(sched, arrivals, before=None, until=None):
    """Submit and tick as ``run_stream`` does (idle gaps fast-forward),
    calling ``before(sched)`` before each tick; stop when all is served or
    ``until(sched)`` is true."""
    order = sorted(arrivals, key=lambda a: a[0])
    i = 0
    while i < len(order) or sched.busy():
        if until is not None and until(sched):
            return
        if not sched.busy() and order[i][0] > sched.clock:
            sched.clock = order[i][0]
        while i < len(order) and order[i][0] <= sched.clock:
            sched.submit(order[i][1])
            i += 1
        if before is not None:
            before(sched)
        sched.step()


def stream_outs(requests):
    return {r.rid: list(r.out) for r in requests.values()}


def survivors_expected(twin_rids, disconnected, quarantined, shed):
    """F3's survivors: the twin's requests less those a fault or the
    shutdown took."""
    return set(twin_rids) - set(disconnected) - set(quarantined) - set(shed)


def prefix_mismatches(got, twin, ticks_of, tick):
    """Requests of ``got`` whose tokens emitted up to and including
    ``tick`` (``ticks_of[rid]``: the tick of each token) are not the
    twin's."""
    bad = []
    for rid, out in got.items():
        n = sum(t <= tick for t in ticks_of.get(rid, []))
        if out[:n] != twin[rid][:n]:
            bad.append(rid)
    return sorted(bad)


def first_divergence(got, twin, ticks_of):
    """(rid, tick) of the lowest request whose stream differs from the
    twin's, at the tick this run emitted its first differing token (or its
    last, when one stream is a prefix of the other); None if all equal."""
    for rid in sorted(got):
        a, b = got[rid], twin[rid]
        if a != b:
            j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            ticks = ticks_of.get(rid, [])
            return rid, ticks[min(j, len(ticks) - 1)] if ticks else None
    return None


def fault_launches(layers, dispatched, reached):
    """Each main-path kernel's launches in a faulted run: ``layers`` per
    dispatch that ran the whole model, plus the layers that raised
    attempts reached (an injected alloc_failure reaches none)."""
    return layers * dispatched + reached


def f1_before(engine, state):
    """F1's hook: an alloc_failure on the first chunk tick from
    F1_ALLOC_TICK, then the raise between layers armed for the first chunk
    tick from F1_RAISE_TICK (the model's layer hook consumes it)."""
    def before(sched):
        if not sched._prefills:
            return
        if "alloc" not in state and sched.ticks >= F1_ALLOC_TICK:
            engine.inject_fault("alloc_failure")
            state["alloc"] = sched.ticks
        elif "raise" not in state and sched.ticks >= F1_RAISE_TICK:
            state["raise"], state["armed"] = sched.ticks, True
    return before


def f2_before(engine, state):
    """F2's hook: NaN on the middle running row of the first tick from
    F2_TICK that can only be decode-only (nothing chunking or queued)."""
    def before(sched):
        if ("tick" in state or sched.ticks < F2_TICK or sched._prefills
                or sched.queue or len(sched.running) < 3):
            return
        slots = sorted(sched.running)
        slot = slots[len(slots) // 2]
        state.update(tick=sched.ticks, slot=slot, rid=sched.running[slot].rid)
        engine.inject_fault("nan", slot)
    return before


def run_f3(sched, arrivals):
    """F3 on a fresh scheduler: F3_PLAN's faults before every tick until
    the clock reaches F3_SHUTDOWN_CLOCK, then the seized pages back, then
    ``shutdown(F3_GRACE)``."""
    from repro_torch.serve.faults import FaultInjector, FaultPlan
    inj = FaultInjector(sched, FaultPlan(**F3_PLAN))
    stream_ticks(sched, arrivals, lambda s: inj.before_tick(),
                 lambda s: s.clock >= F3_SHUTDOWN_CLOCK)
    inj.finish()
    held = sched.pool.num_quarantined()
    leaks = sched.drain_check()
    rep = sched.shutdown(grace_ticks=F3_GRACE)
    return dict(injector=inj, held=held, leaks_before=leaks, report=rep,
                leaks_after=sched.drain_check())


def f3_failures(sched, twin_rids, res, n_arrivals):
    """F3's required gates, as a list of what failed (empty = passed)."""
    inj, rep = res["injector"], res["report"]
    bad = [f"{k} never fired" for k in F3_KINDS if not inj.applied[k]]
    if not inj.malformed_ok:
        bad.append("a malformed submission was accepted")
    if res["leaks_before"] or not rep.clean or res["leaks_after"]:
        bad.append(f"leaks {res['leaks_before']} / {rep.leak_findings} / "
                   f"{res['leaks_after']}")
    if sched.busy():
        bad.append("not drained")
    if not rep.shed_rids:
        bad.append("no work was live at shutdown")
    seen = (set(sched.finished) | set(sched.aborted)
            | set(sched.quarantined))
    if len(seen) != n_arrivals:
        bad.append(f"{n_arrivals - len(seen)} requests unaccounted for")
    want = survivors_expected(twin_rids, inj.disconnected,
                              sched.quarantined, rep.shed_rids)
    if set(sched.finished) != want:
        bad.append(f"survivors {sorted(sched.finished)} != {sorted(want)}")
    reasons = {r.finish_reason for r in sched.aborted.values()}
    if not reasons <= {"disconnect", "shutdown"}:
        bad.append(f"abort reasons {sorted(reasons)}")
    return bad


def fault_run(engine, args, drive=None):
    """Phase 5's greedy stream on a fresh scheduler, through ``drive(sched,
    arrivals)`` (default: served to the end), recording the tick of every
    token. Returns the scheduler, ``ticks_of``, seconds, dispatches, the
    kernels' launches and what ``drive`` returned."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launcher
    ticks_of = {}
    box = {}

    def on_token(req, tok):
        ticks_of.setdefault(req.rid, []).append(box["sched"].ticks)
    arrivals = launcher.make_arrivals(args, engine.model.cfg.vocab_size,
                                      args.tasks, on_token)
    sched = box["sched"] = launcher.make_scheduler(engine, args)
    d0 = engine.dispatches
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    extra = (drive or stream_ticks)(sched, arrivals)
    torch.cuda.synchronize()
    return dict(sched=sched, arrivals=arrivals, ticks_of=ticks_of,
                seconds=time.perf_counter() - t0,
                dispatched=engine.dispatches - d0,
                counts=dict(ops.launches()), extra=extra)


def fault_line(label, run, card, **kv):
    sched = run["sched"]
    log(f"5e faults/{label}", tokens=sched.tokens_emitted,
        seconds=f"{run['seconds']:.3f}",
        tokens_per_s=f"{sched.tokens_emitted / run['seconds']:.1f}",
        ticks=sched.ticks, dispatched=run["dispatched"],
        dispatch_faults=sched.dispatch_faults,
        retries=sched.tick_retries_used, preemptions=sched.preemptions,
        launches=run["counts"], **kv, card=card)
    return dict(tokens=sched.tokens_emitted, seconds=run["seconds"],
                tokens_per_s=sched.tokens_emitted / run["seconds"],
                ticks=sched.ticks, dispatched=run["dispatched"],
                dispatch_faults=sched.dispatch_faults,
                retries=sched.tick_retries_used,
                preemptions=sched.preemptions, launches=run["counts"],
                **{k: v for k, v in kv.items()})


def phase_faults(report, engine):
    """Phase 5e: phase 5's greedy stream, fault-free (the twin), then F1
    (an injected alloc_failure and an exception raised between two layers
    of another chunk tick: every stream bitwise the twin's), F2 (NaN on one
    decode row of a decode-only tick: that request quarantined, every
    survivor's tokens through that tick the twin's, the hold released
    clean by shutdown), F3 (F3_PLAN's seeded chaos ending in shutdown:
    drained, leak-free, every kind fired, the survivors as
    survivors_expected says). Each run's kernels launch exactly
    fault_launches times."""
    from repro_torch.launch import serve as launcher
    layers = engine.model.cfg.num_layers
    args = launcher.parser().parse_args(BASE + GREEDY)
    card = smi()
    kernels = ("aot_gather_add_multitask", "ragged_paged_attention")
    res, failed = {}, []

    def launches_ok(label, run, reached):
        want = fault_launches(layers, run["dispatched"], reached)
        check_launches(label, run["counts"], {k: want for k in kernels})

    twin = fault_run(engine, args)
    twin_out = stream_outs(twin["sched"].finished)
    if len(twin_out) != args.requests or twin["sched"].drain_check():
        raise AssertionError("5e twin: unfinished requests or leaks")
    launches_ok("5e twin", twin, 0)
    res["twin"] = fault_line("twin", twin, card)

    # F1: raised dispatches, retried
    state = {}
    model = engine.model
    block = model._block

    def hooked(lp, h, sincos, attend, peft, i, aot):
        if i == FAULT_LAYER and state.pop("armed", False):
            raise RuntimeError(f"injected fault after {FAULT_LAYER} layers")
        return block(lp, h, sincos, attend, peft, i, aot)
    model._block = hooked
    try:
        f1 = fault_run(engine, args, lambda s, a: stream_ticks(
            s, a, f1_before(engine, state)))
    finally:
        del model._block
    sched = f1["sched"]
    got = stream_outs(sched.finished)
    n_same = sum(got.get(r) == o for r, o in twin_out.items())
    ok = (n_same == len(twin_out) and "alloc" in state and "raise" in state
          and "armed" not in state and sched.dispatch_faults == 2
          and sched.tick_retries_used == 2 and not sched.drain_check())
    res["F1"] = fault_line(
        "F1", f1, card, alloc_failure_tick=state.get("alloc"),
        raise_tick=state.get("raise"), raised_after_layers=FAULT_LAYER,
        streams_equal=f"{n_same}/{len(twin_out)}",
        required="16/16 bitwise, 2 faults, 2 retries")
    launches_ok("5e F1", f1, FAULT_LAYER)
    if not ok:
        failed.append("F1")

    # F2: the NaN watchdog
    state = {}
    held = {}

    def drive_f2(s, a):
        stream_ticks(s, a, f2_before(engine, state))
        held["pages"] = s.pool.num_quarantined()
        return s.shutdown()
    f2 = fault_run(engine, args, drive_f2)
    sched, rep = f2["sched"], f2["extra"]
    got = stream_outs(sched.finished)
    bad_prefix = prefix_mismatches(got, twin_out, f2["ticks_of"],
                                   state.get("tick", -1))
    div = first_divergence(got, twin_out, f2["ticks_of"])
    ok = ("tick" in state and set(sched.quarantined) == {state["rid"]}
          and held["pages"] > 0 and rep.clean
          and rep.quarantined_pages_released > 0
          and sched.pool.num_quarantined() == 0 and not bad_prefix
          and set(got) == set(twin_out) - {state["rid"]})
    n_same = sum(got[r] == twin_out[r] for r in got)
    res["F2"] = fault_line(
        "F2", f2, card, nan_tick=state.get("tick"), nan_rid=state.get("rid"),
        quarantined=sorted(sched.quarantined), held_pages=held["pages"],
        released=rep.quarantined_pages_released, clean=rep.clean,
        prefix_mismatches=bad_prefix, streams_equal=f"{n_same}/{len(got)}",
        first_divergence="none" if div is None
        else f"rid {div[0]} at tick {div[1]}",
        required="1 quarantined, survivors' prefixes equal, released clean")
    launches_ok("5e F2", f2, 0)
    if not ok:
        failed.append("F2")

    # F3: seeded chaos, then shutdown with work still live
    f3 = fault_run(engine, args, run_f3)
    sched, r3 = f3["sched"], f3["extra"]
    bad = f3_failures(sched, twin_out, r3, args.requests)
    got = stream_outs(sched.finished)
    n_same = sum(got[r] == twin_out[r] for r in got)
    inj, rep = r3["injector"], r3["report"]
    res["F3"] = fault_line(
        "F3", f3, card, applied=inj.applied, disconnected=inj.disconnected,
        quarantined=sorted(sched.quarantined), shed=rep.shed_rids,
        grace_ticks=rep.grace_ticks_used, held_pages=r3["held"],
        released=rep.quarantined_pages_released,
        leaks=r3["leaks_before"] + rep.leak_findings + r3["leaks_after"],
        survivors=len(got), streams_equal=f"{n_same}/{len(got)}",
        failures=bad or "none", required="no failures")
    launches_ok("5e F3", f3, 0)
    if bad:
        failed.append("F3")
    report["faults"] = res
    if failed:
        raise AssertionError(f"phase 5e failed: {failed}")
    return {f"faults_{label}": run["counts"]
            for label, run in (("twin", twin), ("F1", f1), ("F2", f2),
                               ("F3", f3))}


# ---------------------------------------------------------------------------
# phase 5f: shared prefixes, n > 1 samples, compaction, priorities
# ---------------------------------------------------------------------------

SHARED_PROMPT = ["--requests", "16", "--system-prompt", "384",
                 "--prompt", "128"]
# each run's flags after BASE; the --num-blocks values are the CPU replay's
# (tests/test_torch_smoke_checks.py): the first that shows a compaction
# rescue, and one that sheds for a full queue, displaces and preempts for
# admission
SHARED_RUNS = {
    "cold": SHARED_PROMPT + ["--prefix-cache-pages", "0"],
    "warm": SHARED_PROMPT + ["--prefix-cache-pages", "128"],
    "sampled_n4": ["--samples", "4", "--temperature", "0.8", "--top-p",
                   "0.9", "--requests", "4", "--seed", "100"],
    "greedy_n4": ["--samples", "4", "--requests", "4"],
    "greedy_n4_whole": ["--samples", "4", "--requests", "4",
                        "--prefill-chunk", "0"],
    "compaction": SHARED_PROMPT + ["--num-blocks", "140"],
    "priorities": ["--requests", "16", "--priority-mix",
                   "latency=0.25,standard=0.5,best_effort=0.25",
                   "--max-queue", "4", "--rate", "2", "--num-blocks", "160"],
}
# every count of each run, from the CPU replay with a model-less engine
# (the schedules do not depend on the tokens: no stop or end token)
SHARED_EXPECT = {
    "cold": dict(ticks=99, serve_steps=99, prefill_requests=0, sample_firsts=0,
                 prefill_tokens=7248, tokens=507, finished=16, preemptions=0,
                 admission_preemptions=0, shed_queue_full=0, shed_displaced=0,
                 gave_up=0, retries=0, forks=0, cow_copies=0, compactions=4,
                 compaction_rescues=0, pages_deduped=192, forked_samples=[]),
    "warm": dict(ticks=93, serve_steps=93, prefill_requests=0, sample_firsts=0,
                 prefill_tokens=4944, tokens=507, finished=16, preemptions=0,
                 admission_preemptions=0, shed_queue_full=0, shed_displaced=0,
                 gave_up=0, retries=0, forks=0, cow_copies=0, compactions=2,
                 compaction_rescues=0, pages_deduped=144, hits=6, misses=10,
                 hit_tokens=2304, retained=157, evicted=29, forked_samples=[]),
    "sampled_n4": dict(ticks=50, serve_steps=50, prefill_requests=0,
                       sample_firsts=4, prefill_tokens=3561, tokens=324,
                       finished=4, preemptions=0, admission_preemptions=0,
                       shed_queue_full=0, shed_displaced=0, gave_up=0,
                       retries=0, forks=4, cow_copies=4, compactions=4,
                       compaction_rescues=0, pages_deduped=102,
                       forked_samples=['0:1', '0:2', '0:3', '1:1']),
    "greedy_n4": dict(ticks=50, serve_steps=50, prefill_requests=0,
                      sample_firsts=4, prefill_tokens=3561, tokens=324,
                      finished=4, preemptions=0, admission_preemptions=0,
                      shed_queue_full=0, shed_displaced=0, gave_up=0,
                      retries=0, forks=4, cow_copies=4, compactions=4,
                      compaction_rescues=0, pages_deduped=102,
                      forked_samples=['0:1', '0:2', '0:3', '1:1']),
    "greedy_n4_whole": dict(ticks=42, serve_steps=42, prefill_requests=4,
                            sample_firsts=4, prefill_tokens=0, tokens=324,
                            finished=4, preemptions=0, admission_preemptions=0,
                            shed_queue_full=0, shed_displaced=0, gave_up=0,
                            retries=0, forks=12, cow_copies=12, compactions=0,
                            compaction_rescues=0, pages_deduped=0,
                            forked_samples=['0:1', '0:2', '0:3', '1:1', '1:2',
                            '1:3', '2:1', '2:2', '2:3', '3:1', '3:2', '3:3']),
    "compaction": dict(ticks=105, serve_steps=105, prefill_requests=0,
                       sample_firsts=0, prefill_tokens=7248, tokens=507,
                       finished=16, preemptions=0, admission_preemptions=0,
                       shed_queue_full=0, shed_displaced=0, gave_up=0,
                       retries=0, forks=0, cow_copies=0, compactions=10,
                       compaction_rescues=7, pages_deduped=240,
                       forked_samples=[]),
    "priorities": dict(ticks=73, serve_steps=73, prefill_requests=0,
                       sample_firsts=0, prefill_tokens=3470, tokens=369,
                       finished=13, preemptions=1, admission_preemptions=1,
                       shed_queue_full=17, shed_displaced=2, gave_up=3,
                       retries=16, forks=0, cow_copies=0, compactions=0,
                       compaction_rescues=0, pages_deduped=0,
                       forked_samples=[]),
}


def shared_counts(sched, n, ticks_of, gave_up, retries):
    """The counts of one 5f run that the CPU replay fixes."""
    pool = sched.pool
    c = dict(n, ticks=sched.ticks, tokens=sched.tokens_emitted,
             finished=len(sched.finished), preemptions=sched.preemptions,
             gave_up=len(gave_up), retries=retries, forks=pool.forks,
             cow_copies=pool.cow_copies, compactions=pool.compactions,
             pages_deduped=pool.pages_deduped,
             forked_samples=forked_samples(ticks_of))
    cache = pool.prefix_cache
    if cache is not None:
        c.update(hits=cache.hits, misses=cache.misses,
                 hit_tokens=cache.hit_tokens,
                 retained=cache.retained_pages, evicted=cache.evicted_pages)
    return c


def forked_samples(ticks_of):
    """"rid:i" of every sample i > 0 that was forked: its first token came
    in the tick of sample 0's (a requeued sample prefills later)."""
    return sorted(f"{rid}:{i}" for (rid, i), t in ticks_of.items()
                  if i > 0 and t[0] == ticks_of[(rid, 0)][0])


def shared_run(engine, extra):
    """One 5f stream: BASE + ``extra`` through the launcher's scheduler and
    client loop (``run_with_retries``), counting serve_step calls, the
    prompt tokens they packed, whole-prompt prefills, first-token draws,
    sheds by reason, preemptions for admission and admissions that a
    compaction rescued. Returns the
    scheduler, the arrivals, the tick of each sample's tokens, seconds,
    the kernels' launches and ``shared_counts``."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launcher
    args = launcher.parser().parse_args(BASE + extra)
    box, ticks_of, n = {}, {}, dict(serve_steps=0, prefill_tokens=0,
                                     prefill_requests=0, sample_firsts=0,
                                     shed_queue_full=0, shed_displaced=0,
                                     admission_preemptions=0,
                                     compaction_rescues=0)

    def on_token(req, tok):
        ticks_of.setdefault((req.rid, req.sample_idx), []).append(
            box["sched"].ticks)
    arrivals = launcher.make_arrivals(args, engine.model.cfg.vocab_size,
                                      args.tasks, on_token)
    sched = box["sched"] = launcher.make_scheduler(engine, args)
    step, first, prefill = (engine.serve_step, engine.sample_first,
                            engine.prefill_request)
    shed, claim, compact = (sched._shed, sched._preempt_for_admission,
                            sched._try_compact)

    def counted_step(tokens, token_rows, token_pos, *a):
        n["serve_steps"] += 1
        n["prefill_tokens"] += (int((np.asarray(token_pos) >= 0).sum())
                                - len(sched.running))
        return step(tokens, token_rows, token_pos, *a)

    def counted_first(*a, **kw):
        n["sample_firsts"] += 1
        return first(*a, **kw)

    def counted_prefill(*a, **kw):
        n["prefill_requests"] += 1
        return prefill(*a, **kw)

    def counted_shed(req, reason):
        n[f"shed_{reason}"] += 1
        shed(req, reason)

    def counted_claim(head):
        took = claim(head)
        n["admission_preemptions"] += took
        return took
    def counted_compact():
        # a rescue: the pages compaction freed admit the queue's head (the
        # check repeats the scheduler's next one, LRU touches included)
        freed = compact()
        n["compaction_rescues"] += freed and sched._can_admit_chunked(
            sched.queue[0])
        return freed
    sched._shed, sched._preempt_for_admission = counted_shed, counted_claim
    sched._try_compact = counted_compact
    engine.serve_step, engine.sample_first = counted_step, counted_first
    engine.prefill_request = counted_prefill
    try:
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        gave_up, retries, _, _ = launcher.run_with_retries(sched, arrivals)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    finally:
        del engine.serve_step, engine.sample_first, engine.prefill_request
    return dict(sched=sched, arrivals=arrivals, ticks_of=ticks_of,
                seconds=sec, launches=dict(ops.launches()), gave_up=gave_up,
                counts=shared_counts(sched, n, ticks_of, gave_up, retries))


def shared_failures(label, run, layers):
    """5f's gates of one run, as a list of what failed (empty = passed):
    the counts are the replay's, every request that was not shed finished
    (every sample of it), the pool drained clean (a warm cache is
    accounted, not leaked), and each kernel launched exactly ``layers``
    times per call that runs it."""
    sched, c = run["sched"], run["counts"]
    bad = []
    want = SHARED_EXPECT.get(label)
    if c != want:
        diff = {k: (c.get(k), (want or {}).get(k))
                for k in set(c) | set(want or {})
                if c.get(k) != (want or {}).get(k)}
        bad.append(f"counts differ from the replay's (got, want): {diff}")
    served = {r.rid for _, r in run["arrivals"]} - set(run["gave_up"])
    if set(sched.finished) != served or sched.busy():
        bad.append(f"finished {sorted(sched.finished)} != {sorted(served)}")
    for r in sched.finished.values():
        if r.samples is not None and any(s is None for s in r.samples):
            bad.append(f"rid {r.rid}: a sample did not finish")
    if sched.drain_check():
        bad.append(f"leaks {sched.drain_check()}")
    steps, pfs = c["serve_steps"], c["prefill_requests"]
    try:
        check_launches(label, run["launches"], {
            "ragged_paged_attention": layers * steps,
            "aot_gather_add_multitask": layers * (steps + pfs),
            "flash_attention": layers * pfs})
    except AssertionError as e:
        bad.append(str(e))
    return bad


def requeued_tokens(sched, ticks_of):
    """Each requeued sample's tokens ("rid:i" -> tokens): a sample of an
    n > 1 request that found no slot to fork into and prefilled alone."""
    forked = forked_samples(ticks_of)
    return {f"{r.rid}:{i}": list(r.samples[i])
            for r in sched.finished.values() if r.samples is not None
            for i in range(1, len(r.samples))
            if f"{r.rid}:{i}" not in forked}


def sibling_report(sched, ticks_of):
    """n > 1 greedy runs: whether the forked samples of each request are
    bitwise equal to one another (they read the same pages in the same
    ticks), and how many requeued samples equal sample 0."""
    forked = forked_samples(ticks_of)
    unequal = [f"{r.rid}:{i}" for r in sched.finished.values()
               if r.samples is not None for i in range(1, len(r.samples))
               if f"{r.rid}:{i}" in forked and r.samples[i] != r.samples[0]]
    requeued = requeued_tokens(sched, ticks_of)
    same = sum(toks == sched.finished[int(k.split(":")[0])].samples[0]
               for k, toks in requeued.items())
    return unequal, f"{same}/{len(requeued)}"


def phase_shared(report, engine):
    """Phase 5f: SHARED_RUNS through the launcher's own code. cold / warm:
    a 384-token system prompt per task without and with the prefix cache
    (the warm run packs fewer prompt tokens, by the replay's difference;
    tokens compared per request, reported); three n = 4 runs (sampled,
    greedy chunked, greedy whole-prompt through flash): forks and copies
    as replayed, greedy forked siblings bitwise equal; compaction at a
    small pool; the priority mix against a bounded queue. Every run's
    counts are the CPU replay's (SHARED_EXPECT), and shared_failures'
    gates hold."""
    layers = engine.model.cfg.num_layers
    card = smi()
    res, launches, failed = {}, {}, {}
    runs = {}
    for label, extra in SHARED_RUNS.items():
        run = runs[label] = shared_run(engine, extra)
        sched, c = run["sched"], run["counts"]
        bad = shared_failures(label, run, layers)
        kv = {}
        if label.startswith("greedy"):
            unequal, same = sibling_report(sched, run["ticks_of"])
            kv = dict(forked_siblings_unequal=unequal or "none",
                      requeued_equal_sample0=same)
            if unequal:
                bad.append(f"forked siblings differ: {unequal}")
        if label == "warm":
            cold = runs["cold"]
            got = stream_outs(sched.finished)
            twin = stream_outs(cold["sched"].finished)
            ticks = {rid: t for (rid, _), t in run["ticks_of"].items()}
            div = first_divergence(got, twin, ticks)
            n_same = sum(got[r] == twin.get(r) for r in got)
            saved = cold["counts"]["prefill_tokens"] - c["prefill_tokens"]
            speedup = cold["seconds"] / run["seconds"]
            kv = dict(streams_equal_cold=f"{n_same}/{len(got)}",
                      first_divergence="none" if div is None
                      else f"rid {div[0]} at tick {div[1]}",
                      prefill_tokens_saved=saved,
                      speedup_vs_cold=f"{speedup:.3f}")
            if saved != c["hit_tokens"]:
                bad.append(f"warm packed {saved} fewer prompt tokens, "
                           f"hits skipped {c['hit_tokens']}")
        sec = run["seconds"]
        log(f"5f shared/{label}", seconds=f"{sec:.3f}",
            tokens_per_s=f"{sched.tokens_emitted / sec:.1f}",
            **{k: v for k, v in c.items() if k != "forked_samples"},
            forked=",".join(c["forked_samples"]) or "none", **kv,
            launches=run["launches"], failures=bad or "none", card=card)
        res[label] = dict(c, seconds=sec,
                          tokens_per_s=sched.tokens_emitted / sec,
                          launches=run["launches"], failures=bad,
                          requeued_tokens=requeued_tokens(
                              sched, run["ticks_of"]),
                          streams=sample_outs(sched.finished), **kv)
        launches[f"shared_{label}"] = run["launches"]
        if bad:
            failed[label] = bad
    report["shared"] = res
    if failed:
        raise AssertionError(f"phase 5f failed: {failed}")
    return launches


# ---------------------------------------------------------------------------
# phase 5g: observability and crash recovery on the paged tick
# ---------------------------------------------------------------------------

SPANS = ("admission", "ensure_pages", "pack_budget_split", "dispatch",
         "postprocess")
N4_SAMPLED = SHARED_RUNS["sampled_n4"]
SLOTS_LAYOUT = ["--layout", "slots", "--prefill-chunk", "0"]
# each crash run: (flags after BASE, the global tick after which the
# process dies; the launcher's client loop crashes only while arrivals are
# still due). In the CPU replay (tests/test_torch_smoke_checks.py) the
# tick before each crash packs: first_chunks, 1 decode row and 3 prompts
# chunking (the stream's first); mixed, 6 rows and a chunk; decode_only,
# 8 rows and nothing chunking; sampled_n4, request 0's 4 forked samples
# decoding and 3 fresh n = 4 prompts chunking
CRASH_RUNS = {
    "first_chunks": (GREEDY, 3),
    "mixed": (GREEDY, 30),
    "decode_only": (GREEDY, 25),
    "sampled_n4": (N4_SAMPLED, 3),
}
SNAPSHOT_TICK = 20      # the slots stream's live snapshot
# F4: a seeded plan with crashes among the other kinds (F3's less the
# malformed submissions and stragglers); the seed is one whose crash and
# other kinds fire on phase 5's stream in the CPU replay
F4_PLAN = dict(seed=24, horizon=96, p_exhaust=0.04, exhaust_pages=480,
               exhaust_ticks=3, p_straggler=0.0, p_disconnect=0.03,
               p_malformed=0.0, p_nan=0.03, p_alloc_failure=0.03,
               p_crash=0.03)
# every count of each 5g run, from the CPU replay with a model-less engine
# (the schedules do not depend on the tokens: no stop or end token)
RESTORE_EXPECT = {
    "first_chunks": dict(ticks=[3, 72], finished=16, tokens=445,
                         journal=dict(admit=20, emit=445, finish=16,
                         restored=4, submit=16), restored=[dict(live=4,
                         finished=0, aborted=0, shed=0, quarantined=0)],
                         dispatches=dict(serve_step=75, prefill=0,
                         decode_mixed=0, sample_first=0), tick_before=[1, 3]),
    "mixed": dict(ticks=[30, 72], finished=16, tokens=445,
                  journal=dict(admit=23, emit=445, finish=16, restored=7,
                  submit=16), restored=[dict(live=7, finished=3, aborted=0,
                  shed=0, quarantined=0)], dispatches=dict(serve_step=102,
                  prefill=0, decode_mixed=0, sample_first=0), tick_before=[6,
                  1]),
    "decode_only": dict(ticks=[25, 72], finished=16, tokens=445,
                        journal=dict(admit=24, emit=445, finish=16, restored=8,
                        submit=16), restored=[dict(live=8, finished=1,
                        aborted=0, shed=0, quarantined=0)],
                        dispatches=dict(serve_step=97, prefill=0,
                        decode_mixed=0, sample_first=0), tick_before=[8, 0]),
    "sampled_n4": dict(ticks=[3, 47], finished=4, tokens=324,
                       journal=dict(admit=18, emit=324, finish=16, restored=4,
                       submit=4), restored=[dict(live=4, finished=0, aborted=0,
                       shed=0, quarantined=0)], dispatches=dict(serve_step=50,
                       prefill=0, decode_mixed=0, sample_first=4),
                       tick_before=[4, 3]),
    "slots_snapshot": dict(ticks=[20, 71], finished=16, tokens=445,
                           journal=dict(admit=24, emit=445, finish=16,
                           restored=8, submit=16), restored=[dict(live=8,
                           finished=1, aborted=0, shed=0, quarantined=0)],
                           dispatches=dict(serve_step=0, prefill=24,
                           decode_mixed=91, sample_first=0)),
    "F4": dict(ticks=[39, 44, 20], finished=14, tokens=420,
               journal=dict(abort=1, admit=28, emit=420, finish=14,
               quarantine=1, restored=11, submit=16), restored=[dict(live=9,
               finished=5, aborted=0, shed=0, quarantined=0), dict(live=2,
               finished=13, aborted=1, shed=0, quarantined=0)],
               dispatches=dict(serve_step=104, prefill=0, decode_mixed=0,
               sample_first=0)),
}


def sample_outs(finished):
    """Every sample's tokens, keyed "rid:sample"."""
    out = {}
    for r in finished.values():
        for i, s in enumerate(r.samples if r.samples is not None
                              else [r.out]):
            out[f"{r.rid}:{i}"] = list(s)
    return out


def span_ms(tracer):
    """Median ms of each tick span (SPANS) over a run's trace, and how
    many of each."""
    dur = {}
    for ev in tracer.events:
        if ev["ph"] == "X" and ev["name"] in SPANS:
            dur.setdefault(ev["name"], []).append(ev["dur"] / 1e3)
    return {name: (median(dur[name]), len(dur[name])) for name in SPANS
            if name in dur}


def slo_ms(o):
    """TTFT / TPOT p50 / p95 in ticks and ms from a run's SLO tracker."""
    s = o.slo.summary()
    return {k: (s[k]["p50"], s[k]["p95"])
            for k in ("ttft_ticks", "ttft_ms", "tpot_ticks", "tpot_ms")}


def journal_events(path):
    """The journal's events by kind (a restore's resubmission counted as
    ``restored``) and its size in bytes."""
    kinds = {}
    with open(path) as f:
        for line in f:
            e = json.loads(line)
            k = "restored" if e.get("restored") else e["ev"]
            kinds[k] = kinds.get(k, 0) + 1
    return dict(sorted(kinds.items())), Path(path).stat().st_size


def tick_packing(events, tick):
    """(decode rows, prefills) that global tick ``tick`` packed, from the
    run's trace (one pack_budget_split span per tick)."""
    a = [e["args"] for e in events
         if e["name"] == "pack_budget_split"][tick]
    return [a["decode_rows"], a["prefills"]]


class KVWatch:
    """ROADMAP C4's recorder for one 5g stream: which path wrote each K/V
    row of each sample (the ragged kernel's split walk for a slot's lone
    row in a tick, else "tile@p", the run item of 16 from position p),
    and a 64-bit hash of every layer's K and V row of each
    sample as its latest token left them. A row a sample shares with its
    parent (a fork's prompt) is found under the parent's key."""

    def __init__(self):
        self.writer, self.hashes, self.box = {}, {}, None
        self.coef = None

    def wrap(self, serve_step):
        def step(tokens, token_rows, token_pos, *a, **kw):
            rows, pos = np.asarray(token_rows), np.asarray(token_pos)
            sched = self.box["sched"]
            owner = dict(sched.running)     # decoding slots, then prefills
            owner.update({pf.slot: pf.req for pf in sched._prefills})
            for slot in np.unique(rows[pos >= 0]):
                req = owner.get(int(slot))
                if req is None:
                    continue
                p = np.sort(pos[(rows == slot) & (pos >= 0)])
                rec = self.writer.setdefault(f"{req.rid}:{req.sample_idx}",
                                             {})
                for q in p:
                    rec[int(q)] = "split walk" if len(p) == 1 else \
                        f"tile@{int(p[0] + 16 * ((q - p[0]) // 16))}"
            return serve_step(tokens, token_rows, token_pos, *a, **kw)
        return step

    def on_token(self, req):
        pool = self.box["sched"].pool
        key = f"{req.rid}:{req.sample_idx}"
        n = max(self.writer.get(key, {0: 0})) + 1
        k = pool.cache["k"]
        L, bs = k.shape[0], k.shape[2]
        if self.coef is None:
            g = torch.Generator(device=DEV).manual_seed(4)
            self.coef = torch.randint(1, 2 ** 40, (k[0, 0, 0].numel(),),
                                      generator=g, device=DEV)
        pages = torch.as_tensor(pool.block_tables[req.slot][:-(-n // bs)],
                                device=DEV).long()
        self.hashes[key] = torch.stack([
            (pool.cache[name][:, pages].reshape(L, -1, self.coef.numel())
             [:, :n].view(torch.int16).long() * self.coef).sum(-1)
            for name in ("k", "v")])                    # (2, L, n)

    def writer_of(self, key, pos):
        rid = key.split(":")[0]
        for k in [key] + sorted(x for x in self.writer
                               if x.split(":")[0] == rid and x != key):
            if pos in self.writer.get(k, {}):
                return f"{self.writer[k][pos]} ({k})"
        return "unknown"


def kv_divergence(twin_watch, crash_watch, key):
    """C4: the first K/V row (lowest position, then layer; K or V) of
    sample ``key`` whose bits differ between the uncrashed and the
    crashed run, with the path that wrote it in each; None if equal."""
    a, b = twin_watch.hashes.get(key), crash_watch.hashes.get(key)
    if a is None or b is None:
        return {"key": key, "missing": [x is None for x in (a, b)]}
    n = min(a.shape[2], b.shape[2])
    diff = (a[:, :, :n] != b[:, :, :n]).any(0)        # (L, n)
    cols = diff.any(0).nonzero()
    if not len(cols):
        return None
    pos = int(cols[0])
    layer = int(diff[:, pos].nonzero()[0])
    return {"key": key, "position": pos, "layer": layer,
            "uncrashed": twin_watch.writer_of(key, pos),
            "crashed": crash_watch.writer_of(key, pos)}


def restore_run(engine, extra, path, drive, crash_at=None, watch=None):
    """One 5g stream: BASE + ``extra`` on a scheduler with metrics and the
    trace on, journaling to ``path`` (emptied first); ``drive(sched,
    arrivals, make)`` serves it, ``make()`` giving each fresh incarnation.
    Records each sample's token ticks on one global clock (the ticks of
    earlier incarnations added), every incarnation's ticks and what
    restore re-admitted (and, with ``crash_at``, what the tick before the
    crash packed); a ``KVWatch`` ``watch`` records the K/V rows' writers
    and bits. Returns the run and its counts."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launcher
    from repro_torch.obs import ServeObservability
    from repro_torch.serve.recovery import RequestJournal
    args = launcher.parser().parse_args(BASE + extra)
    o = ServeObservability(metrics=True, trace=True)
    box, ticks_of, incs, restored = {"base": 0}, {}, [], []
    Path(path).unlink(missing_ok=True)

    def on_token(req, tok):
        ticks_of.setdefault(f"{req.rid}:{req.sample_idx}", []).append(
            box["base"] + box["sched"].ticks)
        if watch is not None:
            watch.on_token(req)

    def make():
        if "sched" in box:
            incs.append(box["sched"].ticks)
            box["base"] += box["sched"].ticks
        s = box["sched"] = launcher.make_scheduler(
            engine, args, o, RequestJournal(path))
        restore = s.restore

        def counted(snap, **_):     # every restore re-attaches on_token
            c = restore(snap, on_token=on_token)
            restored.append(c)
            return c
        s.restore = counted
        return s
    arrivals = launcher.make_arrivals(args, engine.model.cfg.vocab_size,
                                      args.tasks, on_token)
    if watch is not None:
        watch.box = box
        engine.serve_step = watch.wrap(type(engine).serve_step.__get__(
            engine))
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    try:
        extra_out = drive(make(), arrivals, make)
    finally:
        if watch is not None:
            del engine.serve_step
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    sched = box["sched"]
    sched.journal.close()
    m = o.metrics.snapshot()
    disp = {k: m[f"engine_dispatch_{k}_total"]["value"]
            for k in ("serve_step", "prefill", "decode_mixed",
                      "sample_first")}
    events, nbytes = journal_events(path)
    counts = dict(ticks=incs + [sched.ticks], finished=len(sched.finished),
                  tokens=m["sched_tokens_emitted_total"]["value"],
                  journal=events, restored=restored, dispatches=disp)
    if crash_at is not None:
        counts["tick_before"] = tick_packing(o.tracer.events, crash_at - 1)
    return dict(sched=sched, obs=o, arrivals=arrivals, ticks_of=ticks_of,
                seconds=sec, launches=dict(ops.launches()),
                journal_bytes=nbytes, extra=extra_out, counts=counts)


def serve_crashing(crash_at):
    """``drive`` through the launcher's client loop, its process dying
    after ``crash_at`` global ticks."""
    from repro_torch.launch import serve as launcher

    def drive(sched, arrivals, make):
        return launcher.run_with_retries(sched, arrivals,
                                         crash_at_tick=crash_at,
                                         make_sched=make)[:2]
    return drive


def serve_snapshot(tick, path):
    """``drive``: serve as run_stream does; after ``tick`` ticks write a
    live snapshot to ``path`` as JSON, drop the scheduler's pool, restore
    a fresh one from the file and serve on (the arrivals not yet
    submitted join on the new scheduler's clock, as after a crash)."""
    from repro_torch.serve.recovery import read_snapshot, write_snapshot

    def drive(sched, arrivals, make):
        order = sorted(arrivals, key=lambda a: a[0])
        i, done = 0, False
        while i < len(order) or sched.busy():
            if not sched.busy() and order[i][0] > sched.clock:
                sched.clock = order[i][0]
            while i < len(order) and order[i][0] <= sched.clock:
                sched.submit(order[i][1])
                i += 1
            sched.step()
            if sched.ticks == tick and not done:
                done = True
                write_snapshot(sched.snapshot(), path)
                sched.pool.cache = None
                sched = make()
                sched.restore(read_snapshot(path))
    return drive


def serve_chaos(plan):
    """``drive`` through run_chaos with ``make`` as its sched_factory."""
    from repro_torch.serve.faults import FaultPlan, run_chaos

    def drive(sched, arrivals, make):
        return run_chaos(sched, arrivals, FaultPlan(**plan),
                         sched_factory=make)
    return drive


def restore_failures(label, run, twin, crash_at, layers):
    """5g's gates of one crash run, as a list of what failed (empty =
    passed): every request finished (F4: the twin's less the
    disconnected, quarantined and shed), the pool drained clean, the
    tokens emitted before the crash bitwise the twin's, the counts the
    replay's and each kernel 32 times per dispatch or whole prefill."""
    sched, c = run["sched"], run["counts"]
    bad = []
    want = RESTORE_EXPECT.get(label)
    if c != want:
        diff = {k: (c.get(k), (want or {}).get(k))
                for k in set(c) | set(want or {})
                if c.get(k) != (want or {}).get(k)}
        bad.append(f"counts differ from the replay's (got, want): {diff}")
    got = sample_outs(sched.finished)
    if label == "F4":
        res = run["extra"]
        inj = res["injector"]
        survivors = survivors_expected({int(k.split(":")[0]) for k in twin},
                                       inj.disconnected, sched.quarantined,
                                       res["shed_rids"])
        if set(sched.finished) != survivors:
            bad.append(f"survivors {sorted(sched.finished)} != "
                       f"{sorted(survivors)}")
        if res["crashes"] < 1:
            bad.append("no crash fired")
    elif set(got) != set(twin):
        bad.append(f"finished {sorted(got)} != {sorted(twin)}")
    if sched.busy() or sched.drain_check():
        bad.append(f"not drained clean: {sched.drain_check()}")
    if crash_at is not None:
        early = prefix_mismatches(got, twin, run["ticks_of"], crash_at - 1)
        if early:
            bad.append(f"tokens before the crash differ: {early}")
    d = c["dispatches"]
    steps, pfs = d["serve_step"], d["prefill"]
    try:
        check_launches(label, run["launches"], {
            "ragged_paged_attention": layers * steps,
            "aot_gather_add_multitask": layers * (steps + pfs
                                                  + d["decode_mixed"]),
            "flash_attention": layers * pfs,
            "decode_attention": layers * d["decode_mixed"]})
    except AssertionError as e:
        bad.append(str(e))
    return bad


def restore_line(label, run, twin, bad, card, **kv):
    """Log one 5g run's line; returns its record."""
    sched, c = run["sched"], run["counts"]
    got = sample_outs(sched.finished)
    div = first_divergence(got, twin, run["ticks_of"])
    same = sum(got[k] == twin.get(k) for k in got)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    spans = span_ms(run["obs"].tracer)
    slo = slo_ms(run["obs"])
    sec = run["seconds"]
    log(f"5g restore/{label}", seconds=f"{sec:.3f}",
        tokens_per_s=f"{c['tokens'] / sec:.1f}", ticks=c["ticks"],
        finished=c["finished"], journal=c["journal"],
        journal_bytes=run["journal_bytes"], restored=c["restored"],
        dispatches=c["dispatches"], **kv,
        streams_equal=f"{same}/{len(got)}",
        first_divergence="none" if div is None
        else f"{div[0]} at tick {div[1]}",
        ttft=f"{slo['ttft_ticks']} ticks / {slo['ttft_ms']} ms",
        tpot=f"{slo['tpot_ticks']} ticks / {slo['tpot_ms']} ms",
        span_ms={k: f"{v[0]:.3f}" for k, v in spans.items()},
        peak_memory_gib=f"{peak:.2f}", launches=run["launches"],
        failures=bad or "none", card=card)
    return dict(c, seconds=sec, tokens_per_s=c["tokens"] / sec,
                journal_bytes=run["journal_bytes"], streams_equal=same,
                streams=len(got), first_divergence=div, slo=slo,
                span_ms=spans, peak_memory_gib=peak,
                launches=run["launches"], failures=bad, **kv)


def fresh_peak():
    """Collect the garbage of earlier runs (their schedulers and pools sit
    in reference cycles: requests' callbacks reach the scheduler that
    holds them) and start a new peak-memory window."""
    gc.collect()
    torch.cuda.reset_peak_memory_stats()


def obs_runs(engine):
    """Phase 5's greedy stream with observability off and on (metrics and
    trace), in turns: off, on, on, off. Returns each run's (label,
    seconds, tokens, streams, obs, leak findings)."""
    from repro_torch.launch import serve as launcher
    from repro_torch.obs import ServeObservability
    args = launcher.parser().parse_args(BASE + GREEDY)
    runs = []
    for on in (False, True, True, False):
        o = ServeObservability(metrics=True, trace=True) if on else None
        arrivals = launcher.make_arrivals(args, engine.model.cfg.vocab_size,
                                          args.tasks)
        sched = launcher.make_scheduler(engine, args, o)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        launcher.run_with_retries(sched, arrivals)
        torch.cuda.synchronize()
        runs.append(("on" if on else "off", time.perf_counter() - t0,
                     sched.tokens_emitted, stream_outs(sched.finished), o,
                     sched.drain_check()))
    return runs


def phase_restore(report, engine):
    """Phase 5g: phase 5's greedy stream with metrics and trace on against
    off, in turns (the tokens bitwise phase 5's; tokens/s reported; each
    tick span's median ms, TTFT and TPOT); then crash recovery through the
    launcher's code, each run with metrics and the trace on and its counts
    the CPU replay's (RESTORE_EXPECT): the greedy stream journaled and
    crashed after a tick of its first chunks, a mixed tick and a
    decode-only tick (CRASH_RUNS), n = 4 sampled samples crashed while
    forked samples decode, a slots-layout live snapshot restored through
    JSON (flash and contiguous decode), and F4, a seeded plan with crashes
    through run_chaos(sched_factory=...). Each is held against the same
    stream served without a crash in phase 5, 5f or 5b (its twin);
    restore_failures' gates hold for each; the tokens after a crash are
    reported, not gated."""
    layers = engine.model.cfg.num_layers
    card = smi()
    out_dir = ROOT / "chiprun_out" / "5g"
    out_dir.mkdir(parents=True, exist_ok=True)
    fresh_peak()
    want = report["main_path"]["runs"]["greedy"]["streams"]
    res, launches, failed = {}, {}, {}
    # observability on / off
    runs = obs_runs(engine)
    differ = [f"{label}#{k}" for k, (label, _, _, streams, _, leaks)
              in enumerate(runs) if streams != want or leaks]
    rate = {lab: [t / s for lb, s, t, *_ in runs if lb == lab]
            for lab in ("off", "on")}
    o = runs[1][4]
    spans, slo = span_ms(o.tracer), slo_ms(o)
    o.tracer.write(str(out_dir / "greedy_trace.json"))
    log("5g obs", tokens_per_s_off=[f"{r:.1f}" for r in rate["off"]],
        tokens_per_s_on=[f"{r:.1f}" for r in rate["on"]],
        on_over_off=f"{sum(rate['on']) / sum(rate['off']):.3f}",
        streams_equal_phase5="all" if not differ else differ,
        span_ms={k: f"{v[0]:.3f}x{v[1]}" for k, v in spans.items()},
        ttft=f"{slo['ttft_ticks']} ticks / {slo['ttft_ms']} ms",
        tpot=f"{slo['tpot_ticks']} ticks / {slo['tpot_ms']} ms",
        trace_events=len(o.tracer.events), required="bitwise", card=card)
    res["obs"] = dict(tokens_per_s=rate, span_ms=spans, slo=slo,
                      snapshot=o.metrics.snapshot(), differ=differ)
    if differ:
        failed["obs"] = differ
    # the crash-free twins: the same streams served in phases 5, 5f, 5b
    twins = {tuple(GREEDY): {f"{r}:0": t for r, t in want.items()},
             tuple(N4_SAMPLED): report["shared"]["sampled_n4"]["streams"],
             tuple(GREEDY + SLOTS_LAYOUT):
                 report["whole_prompt"]["slots_greedy"]["streams"]}
    peaks = []
    for label, (extra, crash_at) in CRASH_RUNS.items():
        twin = twins[tuple(extra)]
        fresh_peak()
        watch = KVWatch() if label == "sampled_n4" else None
        run = restore_run(engine, extra, out_dir / f"{label}.jsonl",
                          serve_crashing(crash_at), crash_at, watch)
        bad = restore_failures(label, run, twin, crash_at, layers)
        res[label] = restore_line(label, run, twin, bad, card,
                                  crash_at=crash_at)
        if watch is not None:
            res["c4"], bad_c4 = c4_line(engine, extra, out_dir, run, twin,
                                        watch, card)
            if bad_c4:
                failed["c4"] = bad_c4
        peaks.append(res[label]["peak_memory_gib"])
        launches[f"restore_{label}"] = run["launches"]
        if bad:
            failed[label] = bad
    # slots: a live snapshot through JSON (flash prefill, contiguous decode)
    twin = twins[tuple(GREEDY + SLOTS_LAYOUT)]
    fresh_peak()
    run = restore_run(engine, GREEDY + SLOTS_LAYOUT, out_dir / "slots.jsonl",
                      serve_snapshot(SNAPSHOT_TICK, out_dir / "slots.json"))
    bad = restore_failures("slots_snapshot", run, twin, SNAPSHOT_TICK,
                           layers)
    res["slots_snapshot"] = restore_line("slots_snapshot", run, twin, bad,
                                         card, snapshot_at=SNAPSHOT_TICK)
    peaks.append(res["slots_snapshot"]["peak_memory_gib"])
    launches["restore_slots_snapshot"] = run["launches"]
    if bad:
        failed["slots_snapshot"] = bad
    # F4: seeded chaos with crashes
    twin = twins[tuple(GREEDY)]
    fresh_peak()
    run = restore_run(engine, GREEDY, out_dir / "F4.jsonl",
                      serve_chaos(F4_PLAN))
    bad = restore_failures("F4", run, twin, None, layers)
    inj = run["extra"]["injector"]
    res["F4"] = restore_line("F4", run, twin, bad, card,
                             crashes=run["extra"]["crashes"],
                             applied=inj.applied,
                             disconnected=inj.disconnected,
                             quarantined=sorted(run["sched"].quarantined))
    launches["restore_F4"] = run["launches"]
    if bad:
        failed["F4"] = bad
    peaks.append(res["F4"]["peak_memory_gib"])
    res["peak_memory_gib"] = max(peaks)
    log("5g restore", peak_memory_gib=f"{max(peaks):.2f}",
        runs_peak_gib=[f"{p:.2f}" for p in peaks])
    report["restore"] = res
    if failed:
        raise AssertionError(f"phase 5g failed: {failed}")
    return launches


def c4_line(engine, extra, out_dir, run, twin, watch, card):
    """ROADMAP C4: the crashed sampled stream against the same stream
    served again uncrashed with a KVWatch: every sample's stream bitwise
    the uncrashed one's (5f's), and every sample's K/V rows bitwise the
    uncrashed run's (the first differing row, its layer and the path that
    wrote it in each run are named if one is not). Returns (the record,
    its failures)."""
    twin_watch = KVWatch()
    fresh_peak()
    again = restore_run(engine, extra, out_dir / "c4_uncrashed.jsonl",
                        serve_crashing(0), None, twin_watch)
    got = sample_outs(run["sched"].finished)
    div = first_divergence(got, twin, run["ticks_of"])
    kv = {key: row for key in sorted(got)
          if (row := kv_divergence(twin_watch, watch, key)) is not None}
    rerun_equal = sample_outs(again["sched"].finished) == twin
    equal = sum(got[k] == twin.get(k) for k in got)
    log("5g C4", streams_bitwise=f"{equal}/{len(got)}",
        first_divergence="none" if div is None else
        f"rid {div[0].split(':')[0]} sample {div[0].split(':')[1]} tick "
        f"{div[1]}", kv_rows_differ=kv or "none",
        uncrashed_rerun_equals_5f=rerun_equal, required="all bitwise",
        card=card)
    bad = []
    if div is not None or equal != len(twin) or len(got) != len(twin):
        bad.append(f"C4: {equal}/{len(twin)} streams bitwise, first "
                   f"divergence {div}")
    if kv:
        bad.append(f"C4: K/V rows differ: {kv}")
    if not rerun_equal:
        bad.append("C4: the uncrashed rerun differs from 5f's streams")
    return dict(first_divergence=div, kv_rows=kv, streams_bitwise=equal,
                streams=len(got),
                uncrashed_rerun_equals_5f=rerun_equal), bad


def paged_generate(engine, prompts, steps, task_ids):
    """The static batch over a paged pool, through the port's entry points:
    ``Model.prefill``, ``PagedKVPool.write_prefill`` of each row into its
    own pages, then greedy ``Model.decode_step(block_tables=)`` steps.
    Returns (b, steps) tokens as ``ServeEngine.generate`` does."""
    from repro_torch.serve.kv_pool import PagedKVPool
    model, dev = engine.model, engine.device
    b, s = prompts.shape
    pool = PagedKVPool(model, b, engine.cfg.max_len, block_size=BS)
    toks = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    peft = engine._peft(torch.as_tensor(task_ids, dtype=torch.int32,
                                        device=dev))
    logits, cache, pos = model.prefill(engine.params, toks, peft,
                                       max_len=engine.cache_len)
    for r in range(b):
        slot = pool.alloc(int(task_ids[r]), pool.pages_needed(s + steps))
        pool.write_prefill(slot, {n: c[:, r:r + 1] for n, c in cache.items()},
                           s)
    del cache
    bt = torch.as_tensor(pool.block_tables, device=dev)
    tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
    out = []
    for i in range(steps):
        out.append(tok)
        logits, pool.cache = model.decode_step(
            engine.params, tok, torch.full((b,), pos + i, dtype=torch.int32,
                                           device=dev),
            pool.cache, peft, block_tables=bt)
        tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
    for r in range(b):
        pool.free(r)
    if pool.leak_report():
        raise AssertionError(f"paged static pool: {pool.leak_report()}")
    return torch.cat(out, dim=1).cpu().numpy()


STATIC_STEPS = 64


def static_batch(engine):
    """The static batch's 16 prompts of 512 tokens and their mixed task
    ids (seed 0)."""
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, engine.model.cfg.vocab_size,
                           (16, 512)).astype(np.int32)
    return prompts, rng.integers(0, engine.num_tasks, 16).astype(np.int32)


def counted(label, counts, fn):
    """fn() with every kernel count zeroed first; its counts go into
    ``counts[label]``. Returns (fn's result, seconds)."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts[label] = dict(ops.launches())
    return out, sec


def static_mixed(engine, label, prompts, task_ids, steps, counts):
    """One static mixed batch through ``ServeEngine.generate``, counted
    (:func:`counted`) and held to its launches: a flash per layer for the
    prefill, a decode per layer and step, a gather-add per layer for the
    prefill and for each step. Returns (tokens, seconds)."""
    layers = engine.model.cfg.num_layers
    out, sec = counted(label, counts,
                       lambda: engine.generate(prompts, steps, task_ids))
    check_launches(label, counts[label], {
        "flash_attention": layers, "decode_attention": layers * steps,
        "aot_gather_add_multitask": layers * (1 + steps)})
    return out, sec


def phase_static(report, engine):
    """The paper's Fig. 3 setting at full width: one static batch of 16
    prompts of 512 tokens with mixed task ids, 64 greedy tokens each,
    through ``ServeEngine.generate`` (flash prefill, contiguous decode);
    the same prompts as per-task batches, each on an engine holding that
    task's table alone (benchmarks/multitask_throughput.py's sequential
    baseline); and the mixed batch over a paged pool (paged decode)."""
    from repro_torch.serve.engine import ServeEngine
    layers = engine.model.cfg.num_layers
    n_tasks = engine.num_tasks
    prompts, task_ids = static_batch(engine)
    (b, s), steps = prompts.shape, STATIC_STEPS
    engine.generate(prompts[:2], 2, task_ids[:2])        # warm-up
    res, counts = {}, {}

    def timed(label, out_sec):
        out, sec = out_sec
        res[label] = dict(seconds=sec, tokens_per_s=b * steps / sec)
        return out

    def run(label, fn):
        return timed(label, counted(label, counts, fn))

    mixed = timed("static_mixed", static_mixed(engine, "static_mixed",
                                               prompts, task_ids, steps,
                                               counts))

    def per_task():
        outs = np.zeros_like(mixed)
        for t in range(n_tasks):
            idx = np.where(task_ids == t)[0]
            if len(idx) == 0:
                continue
            one = ServeEngine(engine.model, engine.params, engine.cfg,
                              fused_tasks={"table": engine.tables[
                                  :, t:t + 1].contiguous()})
            outs[idx] = one.generate(prompts[idx], steps,
                                     np.zeros(len(idx), np.int32))
            del one
        return outs
    n_runs = len(set(task_ids.tolist()))
    seq = run("static_per_task", per_task)
    check_launches("static_per_task", counts["static_per_task"], {
        "flash_attention": layers * n_runs,
        "decode_attention": layers * steps * n_runs,
        "aot_gather_add_multitask": layers * (1 + steps) * n_runs})
    paged = run("static_paged", lambda: paged_generate(engine, prompts,
                                                       steps, task_ids))
    check_launches("static_paged", counts["static_paged"], {
        "flash_attention": layers, "paged_decode_attention": layers * steps,
        "aot_gather_add_multitask": layers * (1 + steps)})
    same_seq = int((seq == mixed).all(axis=1).sum())
    same_paged = int((paged == mixed).all(axis=1).sum())
    log("5c static batch", b=b, prompt=s, steps=steps,
        tasks=np.bincount(task_ids, minlength=n_tasks).tolist(),
        mixed_tokens_per_s=f"{res['static_mixed']['tokens_per_s']:.1f}",
        per_task_tokens_per_s=f"{res['static_per_task']['tokens_per_s']:.1f}",
        per_task_runs=n_runs,
        paged_tokens_per_s=f"{res['static_paged']['tokens_per_s']:.1f}",
        rows_equal_per_task=f"{same_seq}/{b}",
        rows_equal_paged=f"{same_paged}/{b}", launches=counts)
    report["static"] = dict(res, rows_equal_per_task=same_seq,
                            rows_equal_paged=same_paged, launches=counts)
    # where the time goes: the mixed batch with 16 steps under the profiler
    # (its tracing slows the host, so the busy share is a lower bound)
    report["static"]["profile"] = profile_run(
        "5c profile", lambda: engine.generate(prompts, 16, task_ids),
        steps=16)
    # ... and over the paged pool (paged decode in place of contiguous)
    report["static"]["profile_paged"] = profile_run(
        "5c profile paged", lambda: paged_generate(engine, prompts, 16,
                                                   task_ids), steps=16)
    return counts


# the paper's Fig. 3 methods (benchmarks/speed_overhead.py), each served by
# one ServeEngine(peft=...): the backbone, one task's fused AoT tables,
# BitFit, LoRA (rank 16, alpha 32) unfused and fused into W_q / W_v,
# adapters (rank 16), P-Tuning v2 (a 20-position prefix)
PEFT_METHODS = ("none", "aot", "bitfit", "lora", "lora_fused", "adapters",
                "ptv2")
LOGITS_GRID = ((1, 64), (8, 64), (1, 384), (8, 384))   # speed_overhead's
# the grid's methods: P-Tuning v1 runs whole sequences only (its prompt, a
# bidirectional prefix, goes to attention_chunked), not ServeEngine
LOGITS_METHODS = PEFT_METHODS + ("ptv1",)
PEFT_ROUNDS = 3     # each method's runs, in turns (the host's speed drifts)


def peft_setup(label, model, params, table, gen):
    """(backbone params, PEFT bundle or None) serving ``label`` of
    PEFT_METHODS: ``aot`` gets ``table`` (L, V, d); every other method's
    leaves are drawn as normals x 0.02 (speed_overhead.py:30-32), in the
    model's compute dtype; ``lora_fused`` folds its LoRA into the backbone
    (core.peft.fuse_lora_into)."""
    from repro_torch.core import peft as P
    method = "lora" if label == "lora_fused" else label
    if method == "none":
        return params, None
    opt = P.PEFTOptions(method=method, aot=P.AoTOptions(mode="fused"),
                        lora_rank=16, lora_alpha=32.0, adapter_rank=16,
                        prompt_len=20)
    if method == "aot":
        return params, P.make({"aot": {"table": table}}, opt)
    dt = model.opts.compute_dtype

    def redraw(tree):
        if isinstance(tree, dict):
            return {k: redraw(v) for k, v in tree.items()}
        return (torch.randn(tree.shape, generator=gen, device=DEV)
                * 0.02).to(dt)
    pp = redraw(P.init(model.cfg, opt, device=DEV, dtype=dt))
    if label == "lora_fused":
        return P.fuse_lora_into(params, pp, model.cfg, opt), None
    return params, P.make(pp, opt)


def logits_launches(layers, label):
    """One smollm ``Model.logits`` call's launches with ``label`` of
    LOGITS_METHODS: per layer one flash attention (P-Tuning v1: none, and
    one ``attention_chunked`` call for its prompt's bidirectional prefix)
    and one input norm, fused into the single-table gather-add for AoT."""
    want = ({"chunked": layers} if label == "ptv1"
            else {"flash_attention": layers})
    want["aot_gather_add" if label == "aot" else "rms_norm"] = layers
    return want


def phase_peft(report, engine):
    """The paper's Fig. 3 comparison at full width, bf16: phase 5c's 16
    prompts of 512 tokens, 64 greedy tokens, through one
    ``ServeEngine(peft=...)`` per method of PEFT_METHODS (AoT: task 0's
    tables of the launcher's engine), PEFT_ROUNDS runs each, the methods
    in turns: median generated tokens/s and its time ratio to the
    backbone's; kernels per step and device busy ms from one profiled
    16-step run. Launches are checked exactly in every run; the AoT rows
    must equal the multi-task engine's with every task id 0, token for
    token. Then ``Model.logits`` at speed_overhead.py's grid for each
    method of LOGITS_METHODS (PEFT_METHODS and P-Tuning v1), one counted
    call each (exact launches: ``logits_launches``; ptv1 flash 0 and
    chunked 32), then in turns, each method's median time ratio to the
    backbone's (reported only)."""
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import ServeEngine
    model = engine.model
    layers = model.cfg.num_layers
    prompts, _ = static_batch(engine)
    (b, s), steps = prompts.shape, STATIC_STEPS
    gen = torch.Generator(device=DEV).manual_seed(5)
    table = engine.tables[:, 0].contiguous()
    setups = {label: peft_setup(label, model, engine.params, table, gen)
              for label in LOGITS_METHODS}
    engines = {label: ServeEngine(model, setups[label][0], engine.cfg,
                                  peft=setups[label][1])
               for label in PEFT_METHODS}
    for eng in engines.values():
        eng.generate(prompts[:2], 2)                     # warm-up
    want = {"flash_attention": layers, "decode_attention": layers * steps}
    secs = {label: [] for label in PEFT_METHODS}
    counts, outs = {}, {}
    for r in range(PEFT_ROUNDS):        # in turns, the order rotated
        for label in PEFT_METHODS[r:] + PEFT_METHODS[:r]:
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            outs[label] = engines[label].generate(prompts, steps)
            torch.cuda.synchronize()
            secs[label].append(time.perf_counter() - t0)
            counts[f"peft_{label}"] = dict(ops.launches())
            per_call = layers * (1 + steps)     # prefill + steps, per layer
            check_launches(f"peft_{label}", counts[f"peft_{label}"], dict(
                want, aot_gather_add=per_call * (label == "aot"),
                rms_norm=per_call * (label != "aot")))
    res = {}
    for label, eng in engines.items():
        prof = profile_of(lambda: eng.generate(prompts, 16), steps=16)
        tps = sorted(b * steps / t for t in secs[label])
        res[label] = dict(seconds=secs[label], tokens_per_s=median(tps),
                          tokens_per_s_range=(tps[0], tps[-1]),
                          kernels_per_step=prof["kernels_per_step"],
                          device_busy_ms=prof["device_busy_ms"],
                          profiled_wall_ms=prof["wall_ms"],
                          top_kernels=prof["kernels"][:5])
    del engines
    base = res["none"]
    for label, r in res.items():
        r["ratio"] = base["tokens_per_s"] / r["tokens_per_s"]   # time / none
        r["busy_ratio"] = r["device_busy_ms"] / base["device_busy_ms"]
        log(f"5d peft/{label}", b=b, prompt=s, steps=steps,
            rounds=PEFT_ROUNDS, tokens_per_s=f"{r['tokens_per_s']:.1f}",
            tokens_per_s_range="{:.1f}-{:.1f}".format(
                *r["tokens_per_s_range"]),
            time_ratio_to_none=f"{r['ratio']:.3f}",
            kernels_per_step=f"{r['kernels_per_step']:.0f}",
            device_busy_ms_16_steps=f"{r['device_busy_ms']:.1f}",
            busy_ratio_to_none=f"{r['busy_ratio']:.3f}",
            profiled_wall_ms=f"{r['profiled_wall_ms']:.0f}",
            launches=counts[f"peft_{label}"])
    multi = engine.generate(prompts, steps, np.zeros(b, np.int32))
    same = int((multi == outs["aot"]).all(axis=1).sum())
    log("5d peft/aot vs multi-task", rows_equal=f"{same}/{b}",
        required=f"{b}/{b}")
    if same != b:
        raise AssertionError(f"the single-table AoT engine's tokens equal "
                             f"the multi-task engine's in {same}/{b} rows")
    grid, grid_counts = {}, {}
    rng = np.random.default_rng(1)
    for gb, gs in LOGITS_GRID:
        toks = torch.as_tensor(rng.integers(0, model.cfg.vocab_size,
                                            (gb, gs)), dtype=torch.int32,
                               device=DEV)
        for label in LOGITS_METHODS:            # one counted call each
            p, bd = setups[label]
            torch.cuda.synchronize()
            ops.reset_launches()
            model.logits(p, toks, bd)
            torch.cuda.synchronize()
            key = f"logits_{label}_b{gb}_s{gs}"
            grid_counts[key] = dict(ops.launches(),
                                    chunked=ops.chunked_calls())
            check_launches(key, grid_counts[key],
                           logits_launches(layers, label))
        ms = {label: [] for label in LOGITS_METHODS}
        for r in range(PEFT_ROUNDS):
            for label in LOGITS_METHODS[r:] + LOGITS_METHODS[:r]:
                p, bd = setups[label]
                ms[label].append(wall_ms(
                    lambda i: model.logits(p, toks, bd), iters=3,
                    warmup=2 if r == 0 else 0))
        ms = {label: median(t) for label, t in ms.items()}
        grid[f"b{gb}_s{gs}"] = ms
        log("5d logits", b=gb, s=gs, rounds=PEFT_ROUNDS, **{
            label: f"{t:.2f}ms({t / ms['none']:.3f}x)"
            for label, t in ms.items()})
    report["peft"] = dict(runs=res, launches=counts, aot_rows_equal=same,
                          logits_ms=grid, logits_launches=grid_counts)
    del setups, table
    return counts


def profile_run(phase, fn, steps):
    """Device busy share, kernels per step and the top kernels and host
    ops of ``fn()`` under torch.profiler (CPU + CUDA), logged as one line
    of ``phase``."""
    r = profile_of(fn, steps)
    top = lambda rows: ";".join(f"{k[:40]}:{t:.0f}ms" for t, k in rows[:5])
    log(phase, steps=steps, wall_ms=f"{r['wall_ms']:.0f}",
        device_busy_ms=f"{r['device_busy_ms']:.0f}",
        busy_share=f"{r['device_busy_ms'] / r['wall_ms']:.3f}",
        kernels_per_step=f"{r['kernels_per_step']:.0f}",
        top_kernels=top(r["kernels"]), top_host_ops=top(r["host_ops"]))
    return r


def profile_of(fn, steps):
    """``fn()`` under torch.profiler (CPU + CUDA): wall ms, device busy ms
    (the kernels' summed device time), kernels per step, the top kernels
    and host ops."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t1) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    avgs = prof.key_averages()
    kern = sorted(((e.self_device_time_total / 1e3, e.key) for e in avgs
                   if e.device_type == cuda), reverse=True)
    host = sorted(((e.self_cpu_time_total / 1e3, e.key) for e in avgs
                   if e.device_type != cuda), reverse=True)
    busy_ms = sum(t for t, _ in kern)
    per_step = sum(e.count for e in avgs
                   if e.device_type == cuda) / max(steps, 1)
    return dict(steps=steps, wall_ms=wall_ms, device_busy_ms=busy_ms,
                kernels_per_step=per_step, kernels=kern[:15],
                host_ops=host[:25])


@contextlib.contextmanager
def plain_ops():
    """Every kernel wrapper the model calls replaced by its plain version
    (the same tensors on the card, no kernel launched; the ragged kernel's
    plan, which only the kernel reads, is dropped)."""
    from repro_torch.kernels import aot_bias, ops
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    def ragged(q, k_pages, v_pages, block_tables, token_rows, token_pos,
               plan=None):
        return da.ragged_paged_attention_plain(q, k_pages, v_pages,
                                               block_tables, token_rows,
                                               token_pos)
    plain = {"aot_gather_add": aot_bias.aot_gather_add_plain,
             "aot_gather_add_multitask":
                 aot_bias.aot_gather_add_multitask_plain,
             "rms_norm": aot_bias.rms_norm_plain,
             "ragged_paged_attention": ragged,
             "flash_attention": fa.flash_attention_plain,
             "decode_attention": da.decode_attention_plain,
             "paged_decode_attention": da.paged_decode_attention_plain}
    saved = {name: getattr(ops, name) for name in plain}
    for name, fn in plain.items():
        setattr(ops, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def tasks_peft(tables, task_ids):
    """The multi-task fused-AoT bundle (as ServeEngine builds it) for
    stacked tables (L, tasks, V, d) and per-row ``task_ids``."""
    from repro_torch.core import peft as P
    opt = P.PEFTOptions(method="aot", aot=P.AoTOptions(mode="fused"))
    return dict(P.make({"aot": {"table": tables}}, opt), task_ids=task_ids)


def greedy_decode(model, params, logits, cache, pos0, peft, steps,
                  block_tables=None, forced=None):
    """``steps`` greedy decode steps after ``logits``, the first at cache
    row ``pos0``: per-step logits (steps + 1, b, V) float32 and the tokens
    (b, steps). ``forced`` (b, steps) feeds those tokens in place of the
    argmax (teacher forcing)."""
    b = logits.shape[0]
    lgs, tokens = [logits[:, -1].float()], []
    for i in range(steps):
        tok = (lgs[-1].argmax(-1).to(torch.int32)[:, None] if forced is None
               else forced[:, i:i + 1])
        tokens.append(tok)
        pos = torch.full((b,), pos0 + i, dtype=torch.int32, device=DEV)
        logits, cache = model.decode_step(params, tok, pos, cache, peft,
                                          block_tables=block_tables)
        lgs.append(logits[:, -1].float())
    torch.cuda.synchronize()
    return torch.stack(lgs), torch.cat(tokens, 1)


# phase 6's bf16 tolerance of kernel logits against the plain versions
LOGIT_TOL = dict(atol=2e-2, rtol=2e-2)


def against_plain(lg_k, lg_p):
    """Kernel logits ``lg_k`` against the plain versions' ``lg_p`` of the
    same inputs (..., V) float32: max abs error, the rows whose argmax
    differs, the largest gap in ``lg_p`` between its argmax and the
    kernels' there, and whether every logit is within LOGIT_TOL. Within it,
    a differing argmax is a near tie: its gap is at most two tolerances."""
    a_k, a_p = lg_k.argmax(-1), lg_p.argmax(-1)
    gap = (lg_p.gather(-1, a_p[..., None])
           - lg_p.gather(-1, a_k[..., None])).max().item()
    return dict(logits_max_abs_err=(lg_k - lg_p).abs().max().item(),
                near_ties=int((a_k != a_p).sum()), tie_gap=gap,
                ok=torch.allclose(lg_k, lg_p, **LOGIT_TOL))


def kernels_vs_plain(model, params, toks, peft, steps):
    """A whole-prompt prefill plus ``steps`` greedy decode steps through
    the kernels, against the plain versions fed the kernels' tokens (the
    same inputs at every step): ``against_plain`` of the logits, plus
    whether the plain versions' own greedy run picks the same tokens
    (``free_same``, reported: a near tie may send it elsewhere)."""
    def run(forced=None):
        logits, cache, pos = model.prefill(params, toks, peft,
                                           max_len=MAX_LEN)
        return greedy_decode(model, params, logits, cache, pos, peft, steps,
                             forced=forced)
    lg_k, tok_k = run()
    with plain_ops():
        lg_p, _ = run(forced=tok_k)
        _, tok_free = run()
    return dict(against_plain(lg_k, lg_p),
                free_same=torch.equal(tok_k, tok_free))


def verdict(r):
    """One result of ``against_plain`` as text for a log line."""
    return (f"{r['logits_max_abs_err']:.3e}/ties {r['near_ties']}"
            f"/gap {r['tie_gap']:.3e}"
            + ("" if r.get("free_same", True) else "/free-run DIFFER"))


def cross_check_static(gen, report, model, params, tables):
    """At full width with 2 layers: a whole-prompt prefill plus three
    decode steps through the kernels against the plain versions
    (``kernels_vs_plain``); then decode steps over a paged pool filled from
    that prefill (scrambled pages) against the contiguous decode steps on
    the same cache (same tokens). Returns whether both held."""
    from repro_torch.serve.kv_pool import PagedKVPool
    b, s, steps = 4, 300, 3
    toks = torch.randint(0, model.cfg.vocab_size, (b, s), generator=gen,
                         device=DEV, dtype=torch.int32)
    peft = tasks_peft(tables, torch.arange(b, dtype=torch.int32,
                                           device=DEV) % 4)
    res = kernels_vs_plain(model, params, toks, peft, steps)
    first, cache, _ = model.prefill(params, toks, peft, max_len=MAX_LEN)
    # the paged pool, pages handed out in a scrambled order
    pool = PagedKVPool(model, b, MAX_LEN, block_size=BS)
    pool._free_blocks = [int(p) for p in np.random.default_rng(1).permutation(
        pool._free_blocks)]
    for r in range(b):
        slot = pool.alloc(0, pool.pages_needed(s + steps))
        pool.write_prefill(slot, {n: c[:, r:r + 1] for n, c in cache.items()},
                           s)
    bt = torch.as_tensor(pool.block_tables, device=DEV)
    lg_c, tok_c = greedy_decode(model, params, first, cache, s, peft, steps)
    lg_g, tok_g = greedy_decode(model, params, first, pool.cache, s, peft,
                                steps, bt)
    paged_err = (lg_g - lg_c).abs().max().item()
    paged_same = torch.equal(tok_g, tok_c)
    log("6 cross-check static", layers=2, b=b, prompt=s, steps=steps,
        vs_plain=verdict(res),
        paged_vs_contiguous_max_abs_err=f"{paged_err:.3e}",
        paged_tokens="identical" if paged_same else "DIFFER")
    report["cross_check_static"] = dict(
        res, paged_vs_contiguous_max_abs_err=paged_err, paged_same=paged_same)
    return res["ok"] and paged_same and paged_err <= 2e-2


def cross_check_peft(gen, report, model, params, tables):
    """At full width with 2 layers, for every method of phase 5d (AoT:
    task 0's tables): ``kernels_vs_plain`` of a whole-prompt prefill plus
    three decode steps. Returns the methods that missed the tolerance."""
    b, s, steps = 4, 300, 3
    toks = torch.randint(0, model.cfg.vocab_size, (b, s), generator=gen,
                         device=DEV, dtype=torch.int32)
    table = tables[:, 0].contiguous()
    res = {}
    for label in PEFT_METHODS:
        p, bundle = peft_setup(label, model, params, table, gen)
        res[label] = kernels_vs_plain(model, p, toks, bundle, steps)
    log("6 cross-check peft", layers=2, b=b, prompt=s, steps=steps,
        **{label: verdict(r) for label, r in res.items()})
    report["cross_check_peft"] = res
    return [label for label, r in res.items() if not r["ok"]]


def served_prefill(engine, sched_kw, reqs):
    """Serve ``reqs`` one after another on a fresh scheduler; for the last
    one, capture the logits row its final prefill chunk reported (its
    first token's) and the K/V rows it holds at that point (every layer,
    positions 0 .. length - 1, through its block table). Returns (the
    last request, logits (V,) float32, {"k", "v"}: (L, length, kvh, hd)
    float32, the prefix cache's hit tokens)."""
    from repro_torch.serve.scheduler import (ContinuousScheduler,
                                             SchedulerConfig)
    sched = ContinuousScheduler(engine, SchedulerConfig(**sched_kw))
    step, cap = engine.serve_step, {}
    commit = sched.pool.commit_prefill

    def tapped(*a):
        out = step(*a)
        cap["logits"] = out[1]
        return out

    def grab(slot, length):
        commit(slot, length)
        pages = sched.pool._pages[slot]
        cap["row"] = cap["logits"][slot].float().clone()
        cap["kv"] = {n: c[:, pages].flatten(1, 2)[:, :length].float().clone()
                     for n, c in sched.pool.cache.items()}
    engine.serve_step, sched.pool.commit_prefill = tapped, grab
    try:
        for r in reqs:
            sched.submit(r)
            sched.run()
    finally:
        del engine.serve_step
    if sched.drain_check():
        raise AssertionError(f"warm/cold: leaks {sched.drain_check()}")
    cache = sched.pool.prefix_cache
    return (reqs[-1], cap["row"], cap["kv"],
            cache.hit_tokens if cache is not None else 0)


def cross_check_warm_cold(gen, report, engine):
    """At full width with 2 layers: request A (prefix S of WARM_HIT tokens
    plus a tail) finishes and leaves S's pages in the prefix cache; B (S
    plus WARM_TAIL tokens) hits them. Against B served cold (no cache, the
    prefill budget splitting B's prompt at 200 as a stream would), B's
    first-token logits row and the K/V rows it wrote (positions >= the
    hit) must be within the bf16 tolerance; the cached rows against
    cold B's own are reported, as are the bitwise shares, a near-tie flip
    and whether B's greedy tokens agree. Returns whether the gate held."""
    vocab = engine.model.cfg.vocab_size
    rnd = lambda n: torch.randint(0, vocab, (n,), generator=gen, device=DEV,
                                  dtype=torch.int32).cpu().numpy()
    from repro_torch.serve.scheduler import Request
    S, a, b = rnd(WARM_HIT), rnd(37), rnd(WARM_TAIL)
    mk = lambda rid, tail: Request(rid=rid, prompt=np.concatenate([S, tail]),
                                   task_id=2, max_new_tokens=8)
    kw = dict(num_slots=4, block_size=BS, prefill_chunk=COLD_SPLIT,
              max_prefills=2)
    wb, w_row, w_kv, hit = served_prefill(
        engine, dict(kw, prefix_cache_pages=64), [mk(0, a), mk(1, b)])
    cb, c_row, c_kv, _ = served_prefill(engine, kw, [mk(1, b)])
    res = against_plain(w_row[None], c_row[None])
    kv = {}
    for part, sl in (("written", slice(hit, None)),
                     ("cached", slice(0, hit))):
        w = torch.cat([w_kv[n][:, sl].flatten() for n in ("k", "v")])
        c = torch.cat([c_kv[n][:, sl].flatten() for n in ("k", "v")])
        kv[part] = dict(max_abs_err=(w - c).abs().max().item(),
                        bitwise_share=(w == c).float().mean().item(),
                        ok=torch.allclose(w, c, atol=TOL[torch.bfloat16],
                                          rtol=TOL[torch.bfloat16]))
    share = (w_row == c_row).float().mean().item()
    ok = res["ok"] and kv["written"]["ok"] and hit == WARM_HIT
    log("6 cross-check warm/cold", layers=2, hit=hit,
        logits=f"{res['logits_max_abs_err']:.3e}/bitwise {share:.4f}"
        f"/ties {res['near_ties']}",
        kv_written=f"{kv['written']['max_abs_err']:.3e}"
        f"/bitwise {kv['written']['bitwise_share']:.4f}",
        kv_cached=f"{kv['cached']['max_abs_err']:.3e}"
        f"/bitwise {kv['cached']['bitwise_share']:.4f}",
        tokens="identical" if wb.out == cb.out else f"{wb.out} vs {cb.out}",
        required="logits and written K/V within the bf16 tolerance")
    report["cross_check_warm_cold"] = dict(
        res, hit=hit, logits_bitwise_share=share, kv=kv,
        tokens_equal=wb.out == cb.out)
    return ok


def cross_check_cow(gen, report, engine):
    """At full width with 2 layers, copy-on-write under the real tick: a
    slot prefilled to 300 positions (its tail page 12 rows deep) forks;
    the tick's write-exclusive check refuses the shared tail until
    ``ensure_append_page`` copies it; then one serve_step appends a
    different token to each. Bitwise: rows below the fork depth of both
    tail pages equal the pre-fork page, every other page is unchanged,
    and the two appended rows differ. Returns whether it held."""
    from repro_torch.models.model import check_write_exclusive
    from repro_torch.serve.kv_pool import PagedKVPool
    vocab = engine.model.cfg.vocab_size
    ns, depth = 4, 300
    pool = PagedKVPool(engine.model, ns, MAX_LEN, block_size=BS)
    greedy = (np.zeros(ns, np.float32), np.zeros(ns, np.int32),
              np.ones(ns, np.float32), np.zeros((ns, 2), np.uint32),
              np.zeros(ns, np.int32))
    slot = pool.alloc(1, pool.pages_needed(depth))
    toks = torch.randint(0, vocab, (depth + 2, 1), generator=gen, device=DEV,
                         dtype=torch.int32).cpu().numpy()
    if toks[depth, 0] == toks[depth + 1, 0]:      # the two appends differ
        toks[depth + 1, 0] = (toks[depth, 0] + 1) % vocab
    engine.serve_step(toks[:depth], np.full(depth, slot, np.int32),
                      np.arange(depth, dtype=np.int32),
                      np.zeros(ns, np.int32), pool.cache, pool.block_tables,
                      pool.task_id[np.full(depth, slot)], greedy)
    pool.commit_prefill(slot, depth)
    child = pool.fork(slot)
    tail, row = depth // BS, depth % BS
    old = pool._pages[slot][tail]
    rows = np.asarray([slot, child], np.int32)
    pos = np.full(2, depth, np.int32)
    try:
        check_write_exclusive(rows, pos, pool.block_tables, pool._refs, BS)
        refused = False
    except ValueError:
        refused = True
    torch.cuda.synchronize()
    before = {n: c.clone() for n, c in pool.cache.items()}
    copied = pool.ensure_append_page(slot) and pool.ensure_append_page(child)
    new = pool._pages[slot][tail]
    check_write_exclusive(rows, pos, pool.block_tables, pool._refs, BS)
    engine.serve_step(toks[depth:], rows, pos, np.arange(ns) % 2,
                      pool.cache, pool.block_tables, pool.task_id[rows],
                      greedy)
    torch.cuda.synchronize()
    others = [p for p in range(pool.num_blocks) if p not in (old, new)]
    below = all(torch.equal(c[:, p, :row], before[n][:, old, :row])
                for n, c in pool.cache.items() for p in (old, new))
    untouched = all(torch.equal(c[:, others], before[n][:, others])
                    for n, c in pool.cache.items())
    differ = all(not torch.equal(c[:, old, row], c[:, new, row])
                 for c in pool.cache.values())
    ok = (refused and copied and pool.cow_copies == 1 and new != old
          and below and untouched and differ and pool.leak_report() == [])
    log("6 cross-check cow", layers=2, depth=depth, tail_page=tail,
        fork_depth_row=row, refused_before_copy=refused,
        rows_below_fork="bitwise the pre-fork page" if below else "CHANGED",
        other_pages="unchanged" if untouched else "CHANGED",
        appended_rows="differ" if differ else "EQUAL",
        required="all bitwise as stated")
    report["cross_check_cow"] = dict(refused=refused, below=below,
                                     untouched=untouched, differ=differ)
    return ok


RESTORE_PROMPT, RESTORE_NEW, RESTORE_AT = 300, 24, 8


def decode_rows(engine, sched, req):
    """Serve ``sched`` to the end, recording the logits row each decode
    tick of ``req`` reports, keyed by the index of the token drawn from
    it."""
    step, rows = engine.serve_step, {}

    def tapped(*a):
        out = step(*a)
        if req.state == "running":
            rows[len(req.out)] = out[1][req.slot].float().clone()
        return out
    engine.serve_step = tapped
    try:
        sched.run()
    finally:
        del engine.serve_step
    return rows


def slot_kv(pool, slot, length):
    """A slot's K/V rows 0 .. length - 1 through its pages, every layer,
    float32."""
    pages = pool._pages[slot]
    return {n: c[:, pages].flatten(1, 2)[:, :length].float().clone()
            for n, c in pool.cache.items()}


def cross_check_restore(gen, report, engine):
    """At full width with 2 layers: one request served to the end, and the
    same request snapshotted after RESTORE_AT ticks, its snapshot written
    and read as JSON and restored into a fresh scheduler, which recomputes
    prompt + out[:-1] in chunk tiles where the first run wrote the decoded
    rows one token at a time. The K/V rows the recompute wrote against
    those the first run held at the snapshot, and the first logits row the
    restored request decodes from against the first run's for the same
    token: within the bf16 tolerance, bitwise shares reported, as is
    whether the two streams agree. Returns whether the gate held."""
    from repro_torch.serve.recovery import read_snapshot, write_snapshot
    from repro_torch.serve.scheduler import (ContinuousScheduler, Request,
                                             SchedulerConfig)
    vocab = engine.model.cfg.vocab_size
    prompt = torch.randint(0, vocab, (RESTORE_PROMPT,), generator=gen,
                           device=DEV, dtype=torch.int32).cpu().numpy()
    cfg = SchedulerConfig(num_slots=4, block_size=BS, prefill_chunk=128,
                          max_prefills=2)

    def fresh(submit=True):
        sched = ContinuousScheduler(engine, cfg)
        req = Request(rid=0, prompt=prompt, task_id=3,
                      max_new_tokens=RESTORE_NEW)
        if submit:
            sched.submit(req)
        return sched, req
    whole, ra = fresh()
    rows_a = decode_rows(engine, whole, ra)
    sched, rb = fresh()
    for _ in range(RESTORE_AT):
        sched.step()
    depth = int(sched.pool.cur_len[rb.slot])
    kv_b = slot_kv(sched.pool, rb.slot, depth)
    path = ROOT / "chiprun_out" / "restore_snapshot.json"
    path.parent.mkdir(exist_ok=True)
    write_snapshot(sched.snapshot(), path)
    sched.pool.cache = None
    restored, _ = fresh(submit=False)
    restored.restore(read_snapshot(path))
    rc = restored.queue[0]
    j0, cap = len(rc.out), {}
    commit = restored.pool.commit_prefill

    def grab(slot, length):
        commit(slot, length)
        cap["kv"] = slot_kv(restored.pool, slot, length)
    restored.pool.commit_prefill = grab
    rows_c = decode_rows(engine, restored, rc)
    res = against_plain(rows_c[j0][None], rows_a[j0][None])
    share = (rows_c[j0] == rows_a[j0]).float().mean().item()
    w = torch.cat([cap["kv"][n].flatten() for n in ("k", "v")])
    c = torch.cat([kv_b[n].flatten() for n in ("k", "v")])
    kv = dict(max_abs_err=(w - c).abs().max().item(),
              bitwise_share=(w == c).float().mean().item(),
              ok=torch.allclose(w, c, atol=TOL[torch.bfloat16],
                                rtol=TOL[torch.bfloat16]))
    ok = (res["ok"] and kv["ok"] and cap["kv"]["k"].shape[1] == depth
          and restored.drain_check() == [])
    log("6 cross-check restore", layers=2, prompt=RESTORE_PROMPT,
        snapshot_tick=RESTORE_AT, recomputed=depth, first_token=j0,
        logits=f"{res['logits_max_abs_err']:.3e}/bitwise {share:.4f}"
        f"/ties {res['near_ties']}",
        kv_recomputed=f"{kv['max_abs_err']:.3e}"
        f"/bitwise {kv['bitwise_share']:.4f}",
        tokens="identical" if rc.out == ra.out
        else f"{ra.out} vs {rc.out}",
        required="logits and recomputed K/V within the bf16 tolerance")
    report["cross_check_restore"] = dict(
        res, depth=depth, first_token=j0, logits_bitwise_share=share,
        kv=kv, tokens_equal=rc.out == ra.out)
    return ok


# phase 6 draws its inputs and PEFT parameters from a generator of its own,
# so that draws added to earlier phases leave them as they are
PHASE6_SEED = 0


def phase_cross_check(report, seed=PHASE6_SEED, recompute=True):
    """Phase 6 at inputs drawn from ``seed``: kernels against the plain
    versions at full width with 2 layers, the plain versions fed the
    kernels' tokens, every logit within LOGIT_TOL (so a token that differs
    is a near tie, counted in each line), and paged against contiguous
    decode (same tokens). Records every check, then raises if one failed."""
    from repro_torch import configs
    from repro_torch.core import aot as aot_mod
    from repro_torch.models import model as model_mod
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.scheduler import (ContinuousScheduler, Request,
                                             SchedulerConfig)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    dt = torch.bfloat16
    cfg = configs.get("smollm-360m").replace(num_layers=2)
    model = model_mod.Model(cfg, model_mod.ModelOptions(dt, dt), device=DEV)
    params = model.init(1)
    tables = aot_mod.stack_tasks([aot_mod.random_fused(
        cfg, params["embed"]["tok"], seed=t, scale=0.03, vocab_chunk=4096,
        dtype=dt) for t in range(4)])["table"]
    rows, pos = packings()["chunks_decode_dead"]
    T = len(rows)
    cache0 = model.init_paged_cache(NUM_BLOCKS, BS)
    for name in ("k", "v"):
        cache0[name].normal_(generator=gen)
    perm = torch.randperm(NUM_BLOCKS - 1, generator=gen, device=DEV) + 1
    bt = perm.view(SLOTS, NPAGES).to(torch.int32)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=DEV)
    tokens = torch.randint(0, cfg.vocab_size, (T, 1), generator=gen,
                           device=DEV, dtype=torch.int32)
    slot_task = [0, 1, 2, 3, 0, 1, 2, 3]
    lidx = [0] * SLOTS
    for t, (r, p) in enumerate(zip(rows, pos)):
        if p >= 0:
            lidx[r] = t
    live = sorted({r for r, p in zip(rows, pos) if p >= 0})
    peft = tasks_peft(tables, i32([slot_task[r] for r in rows]))

    def tick():
        cache = {n: c.clone() for n, c in cache0.items()}
        logits, cache = model.mixed_step(params, tokens, i32(rows), i32(pos),
                                         cache, peft, block_tables=bt,
                                         logit_idx=i32(lidx))
        torch.cuda.synchronize()
        return logits[live].float(), cache

    lg_k, cache_k = tick()
    with plain_ops():
        lg_p, cache_p = tick()
    res = against_plain(lg_k, lg_p)
    kv_err = max((cache_k[n].float() - cache_p[n].float()).abs().max().item()
                 for n in ("k", "v"))
    log("6 cross-check", seed=seed, layers=2, T=T, vs_plain=verdict(res),
        kv_max_abs_err=f"{kv_err:.3e}")
    report["cross_check"] = dict(res, seed=seed, kv_max_abs_err=kv_err)
    failed = [] if res["ok"] else ["tick"]
    if not cross_check_static(gen, report, model, params, tables):
        failed.append("static")
    failed += cross_check_peft(gen, report, model, params, tables)
    engine = ServeEngine(model, params, ServeConfig(max_len=MAX_LEN),
                         fused_tasks={"table": tables})
    if not cross_check_warm_cold(gen, report, engine):
        failed.append("warm/cold")
    if not cross_check_cow(gen, report, engine):
        failed.append("cow")
    if not cross_check_restore(gen, report, engine):
        failed.append("restore")
    if failed:
        raise AssertionError(f"kernel and plain runs disagree for {failed}")
    if not recompute:
        return
    # preempt-and-recompute parity through the scheduler (reported only:
    # cuBLAS may round a row differently at another packed width)
    engine = ServeEngine(model, params, ServeConfig(max_len=256),
                         fused_tasks={"table": tables})
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(20, 121)))
             .astype(np.int32), int(rng.integers(0, 4)),
             int(rng.integers(24, 61))) for _ in range(6)]
    outs, preempts = [], []
    for num_blocks in (0, 17):          # 17: one max_len request + scratch
        sched = ContinuousScheduler(engine, SchedulerConfig(
            num_slots=4, block_size=BS, num_blocks=num_blocks,
            prefill_chunk=64, max_prefills=2))
        for i, (p, task, n) in enumerate(reqs):
            sched.submit(Request(rid=i, prompt=p, task_id=task,
                                 max_new_tokens=n))
        sched.run()
        outs.append([sched.finished[i].out for i in range(len(reqs))])
        preempts.append(sched.preemptions)
    same = outs[0] == outs[1]
    n_same = sum(a == b for a, b in zip(*outs))
    log("6 recompute parity", preemptions=preempts[1],
        streams_equal=f"{n_same}/{len(reqs)}", required="no")
    report["recompute_parity"] = dict(preemptions=preempts, equal=same,
                                      equal_requests=n_same)


# ---------------------------------------------------------------------------
# phase 7: train the paper's method, fuse it, serve the trained tasks
# ---------------------------------------------------------------------------

TRAIN_BASE = ["--arch", "smollm-360m", "--rank", "32"]
# 7a: the paper's two reparametrizations on the LM stream (the launcher's
# defaults but for the steps)
TRAIN_LM = {label: ["--method", "aot", "--aot-mode", label, "--steps", "30",
                    "--seq", "128", "--batch", "8", "--lr", "5e-3"]
            for label in ("fc", "kron")}
# 7b: the paper's protocol, a classification head per method
TRAIN_CLS = {"aot_fc": ["--method", "aot", "--aot-mode", "fc"],
             "bitfit": ["--method", "bitfit"]}
CLS_FLAGS = ["--steps", "60", "--seq", "64", "--batch", "16", "--lr", "8e-3"]
CLS_TASK = dict(name="synth-3", vocab_size=49152, seq_len=64, num_classes=2,
                seed=3)
HELD_OUT = (4, 32, 1_000_000)   # batches, rows, first step (unseen)
LOSS_WINDOW = 5
# the 7a runs whose loss falls on fresh batches well above their noise:
# also gated on the last LOSS_WINDOW steps' mean against the first's
FRESH_GATED = ("kron",)
FUSE_TOKENS = (4, 128)
# 7c: phase 5's stream, 8 requests over the two trained tasks (greedy)
SERVE_TRAINED = BASE[:BASE.index("--tasks")] + BASE[BASE.index("--tasks")
                                                     + 2:] + [
    "--tasks", "2", "--requests", "8"]
TRAINED_EXPECT = {"ticks": 57, "dispatched": 57, "finished": 8}


def loss_drop(losses, again, fresh=False):
    """(mean of the first steps' losses, mean of ``again``, mean of the
    last steps' losses, failures): ``losses`` every step's, ``again`` the
    first ``len(again)`` batches' losses under the trained parameters.
    Every loss must be finite and the same batches' mean must have fallen.
    With ``fresh``, the last steps' mean (other batches) must also be
    below the first steps': the training batches differ from step to step
    by more than AoT fc lowers its loss in 30 steps on a random backbone,
    so for fc that mean measures the noise and is reported only."""
    n = len(again)
    first, after = sum(losses[:n]) / n, sum(again) / n
    last = sum(losses[-n:]) / n
    bad = []
    if not all(np.isfinite(losses + again)):
        bad.append("a loss is not finite")
    if not after < first:
        bad.append(f"loss did not fall ({first:.4f} -> {after:.4f} on "
                   f"the first {n} batches)")
    if fresh and not last < first:
        bad.append(f"loss did not fall ({first:.4f} -> {last:.4f} from the "
                   f"first {n} steps to the last {n})")
    return first, after, last, bad


def losses_again(t, args, n=LOSS_WINDOW):
    """The losses of the first ``n`` training batches under ``t``'s
    trained parameters (the train step's loss, no update)."""
    from repro_torch.launch import train as trainer
    from repro_torch.train.step import TrainConfig, make_loss_fn
    stream = trainer.lm_stream(args, t.model.cfg.vocab_size)
    loss_fn = make_loss_fn(t.model, TrainConfig(peft=t.popt,
                                                loss_chunk=args.seq // 4))
    out = []
    with torch.no_grad():
        for _ in range(n):
            b = {k: torch.from_numpy(v).to(DEV)
                 for k, v in stream.next().items()}
            out.append(float(loss_fn(t.state["trainable"], t.frozen, b,
                                     None)[0]))
    return out


def changed_leaves(before, after):
    """Indices of the leaves of ``after`` not bitwise equal to ``before``'s
    (two lists of tensors)."""
    return [i for i, (a, b) in enumerate(zip(before, after))
            if not torch.equal(a, b)]


def fused_vs_reparam(model, params, peft_reparam, peft_fused, tokens):
    """``model.forward`` through the reparametrization against forward
    through its fused tables (both plain PyTorch, ``attn_impl="ref"``) on
    ``tokens``: (max abs error, bitwise share of the hidden states)."""
    with torch.no_grad():
        h_r = model.forward(params, tokens, peft_reparam)
        h_f = model.forward(params, tokens, peft_fused)
    return ((h_r - h_f).abs().max().item(),
            (h_r == h_f).float().mean().item())


# the served bf16 logits may stray from the float32 function at most this
# many times as far as plain bf16 PyTorch's logits of the same prompts do
BF16_FACTOR = 2.0
# ... and must carry the task's trained effect on them (the float32
# function's logits less the backbone's alone) to within this share
CARRY_TOL = 0.1


def carried(lg, ref32, base32):
    """The share of the task's effect ``ref32 - base32`` that ``lg``
    carries: the least-squares coefficient of ``lg - base32`` on it, each
    row less its mean (a shift of a whole row moves no probability; 1: all
    of the effect, 0: a serve without the task's table)."""
    eff = ref32 - base32
    eff = eff - eff.mean(-1, keepdim=True)
    return ((lg - base32) * eff).sum().item() / (eff * eff).sum().item()


def against_float32(served, plain16, ref32, base32, task_ids):
    """Per task: ``served`` (the kernels' bf16 logits) and ``plain16``
    (plain bf16 PyTorch's) against ``ref32`` (the float32 function) on
    the task's rows, all (n, V) float32 with ``task_ids`` (n,): each one's
    max abs error and share ``carried`` of the task's effect over
    ``base32`` (the float32 backbone's logits, no table). A task is
    ``ok`` when the served error is within BF16_FACTOR times the plain one
    (every logit: so an argmax that differs from ``ref32``'s is a near tie
    of at most twice that) and the served rows carry the effect within
    CARRY_TOL: a bf16 error as large as a small task's effect cannot hide
    a dropped or swapped table. ``ok``: every task is."""
    tasks = {}
    for t in sorted(set(task_ids)):
        m = torch.tensor([i == t for i in task_ids])
        k, p, r, b = served[m], plain16[m], ref32[m], base32[m]
        e_k = (k - r).abs().max().item()
        e_p = (p - r).abs().max().item()
        c_k, c_p = carried(k, r, b), carried(p, r, b)
        tasks[t] = dict(served_err=e_k, plain_err=e_p, carried=c_k,
                        carried_plain=c_p, effect_max=(r - b).abs().max()
                        .item(), ok=e_k <= BF16_FACTOR * e_p
                        and abs(c_k - 1) <= CARRY_TOL)
    return dict(tasks=tasks, ok=all(r["ok"] for r in tasks.values()))


def control_serves(tables):
    """7c's controls, serves that ``against_float32`` must reject: (name,
    the stacked tables it serves, the task ids whose rows it makes wrong)
    for fc's table zeroed (a serve that dropped a task's table) and the
    two tables swapped (a serve that mixed up the task ids). ``tables``:
    [fc, kron], each ``{"table": (L, V, d)}``."""
    from repro_torch.core.aot import stack_tasks
    zero = {"table": torch.zeros_like(tables[0]["table"])}
    yield "fc_zeroed", stack_tasks([zero, tables[1]]), {0}
    del zero
    yield "swapped", stack_tasks(tables[::-1]), {0, 1}


def rejected(res):
    """The task ids ``against_float32`` did not pass."""
    return {t for t, r in res["tasks"].items() if not r["ok"]}


def f32_text(res):
    """One result of ``against_float32`` as text for a log line."""
    return ";".join(f"task {t}: {r['served_err']:.3e}/plain "
                    f"{r['plain_err']:.3e}/carried {r['carried']:.4f}"
                    f"/plain {r['carried_plain']:.4f}/effect "
                    f"{r['effect_max']:.3e}"
                    for t, r in res["tasks"].items())


def trained_launches(layers, dispatched):
    """7c's launches: the multi-task gather-add + norm and ragged
    attention once per layer of each dispatched tick, nothing else."""
    return {"aot_gather_add_multitask": layers * dispatched,
            "ragged_paged_attention": layers * dispatched}


def cast_backbone(params, dtype, norm=False):
    """The backbone in ``dtype``, the norms' parameters (RMSNorm's scale,
    LayerNorm's scale and bias) and the QKV biases (the subtrees
    ``bridge.FLOAT32``) kept in float32 as ``Model.init`` keeps them."""
    from repro_torch.bridge import FLOAT32
    if isinstance(params, dict):
        return {k: cast_backbone(v, dtype, norm or k in FLOAT32)
                for k, v in params.items()}
    if isinstance(params, list):
        return [cast_backbone(v, dtype, norm) for v in params]
    return params.detach() if norm else params.detach().to(dtype)


def profile_train_step(t, args, steps=2):
    """``steps`` more train steps of ``t`` on the stream's next batch under
    torch.profiler (``profile_of``); their updates are dropped (the step
    returns a new state), so the trained parameters stay as they were."""
    from repro_torch.launch import train as trainer
    from repro_torch.train.loop import step_rng
    stream = trainer.lm_stream(args, t.model.cfg.vocab_size)
    stream.restore(dict(stream.state(), step=args.steps))
    b = {k: torch.from_numpy(v).to(DEV) for k, v in stream.next().items()}
    return profile_of(lambda: [t.train_step(t.state, t.frozen, b,
                                            step_rng(0, args.steps))
                               for _ in range(steps)], steps)


def train_lm(report):
    """7a: each TRAIN_LM run through the training launcher; returns the
    trained AoT bundles by label, the backbone (seed 0, float32) and each
    run's whole train state (parameters, AdamW state, step) by label."""
    from repro_torch import tree
    from repro_torch.core import peft as peft_mod
    from repro_torch.kernels import ops
    from repro_torch.launch import train as trainer
    trained, failed, backbone, states = {}, [], None, {}
    for label, flags in TRAIN_LM.items():
        args = trainer.parser().parse_args(TRAIN_BASE + flags)
        fresh_peak()
        t = trainer.build(args)
        before = [x.clone() for x in tree.leaves(t.params)]
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        loop = trainer.train(t, args, log_every=1)
        sec = time.perf_counter() - t0
        counts = dict(ops.launches())
        losses = [h["loss"] for h in loop.history]
        again = losses_again(t, args)
        first, after, last, bad = loss_drop(losses, again,
                                            fresh=label in FRESH_GATED)
        changed = changed_leaves(before, tree.leaves(t.params))
        if changed:
            bad.append(f"{len(changed)} backbone leaves changed")
        if any(counts.values()):
            bad.append(f"kernels launched while training: {counts}")
        prof = profile_train_step(t, args)
        peft = t.state["trainable"]["peft"]
        n_train = sum(x.numel() for x in tree.leaves(peft))
        ms = median(h["step_time_s"] for h in loop.history) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"7a train/{label}", steps=len(losses),
            loss_first=f"{losses[0]:.4f}", loss_last=f"{losses[-1]:.4f}",
            mean_first5=f"{first:.4f}", first5_after=f"{after:.4f}",
            mean_last5=f"{last:.4f}",
            median_ms_per_step=f"{ms:.2f}", seconds=f"{sec:.2f}",
            peak_memory_gib=f"{peak:.2f}", trainable_params=n_train,
            backbone="bitwise" if not changed else f"{len(changed)} changed",
            launches=sum(counts.values()),
            failures="none" if not bad else bad)
        log(f"7a profile/{label}", steps=prof["steps"],
            wall_ms=f"{prof['wall_ms']:.0f}",
            device_busy_ms=f"{prof['device_busy_ms']:.1f}",
            kernels_per_step=f"{prof['kernels_per_step']:.0f}",
            top_kernels=";".join(f"{k[:40]}:{ms:.1f}ms"
                                 for ms, k in prof["kernels"][:4]))
        report.setdefault("train", {})[label] = dict(
            losses=losses, first5_after=again, median_ms_per_step=ms,
            seconds=sec,
            peak_memory_gib=peak, trainable_params=n_train,
            step_ms=[h["step_time_s"] * 1e3 for h in loop.history],
            profile=prof, failures=bad)
        failed += [f"{label}: {b}" for b in bad]
        with torch.no_grad():
            trained[label] = peft_mod.make(
                tree.map(lambda x: x.detach(), peft), t.popt)
        backbone = backbone or t.params
        states[label] = t.state
        del t, before, loop
    if failed:
        raise AssertionError(f"7a: {failed}")
    return trained, backbone, states


def train_classify(base=None, task_kw=None, phase="7b", keep=()):
    """7b (8d: an encoder's ``base`` flags and ``task_kw``): each TRAIN_CLS
    method with a 2-class head on CLS_TASK, then its accuracy on HELD_OUT
    batches (reported only). Returns (each run's results, {label:
    (backbone, trained bundle)} of the runs named in ``keep``)."""
    from repro_torch.core import peft as peft_mod
    from repro_torch.data.tasks import ClassificationTask
    from repro_torch.kernels import ops
    from repro_torch.launch import train as trainer
    from repro_torch.train.loop import step_rng
    task = ClassificationTask(**(task_kw or CLS_TASK))
    on_dev = lambda b: {k: torch.from_numpy(v).to(DEV) for k, v in b.items()}
    results, kept = {}, {}
    for label, flags in TRAIN_CLS.items():
        args = trainer.parser().parse_args((base or TRAIN_BASE) + flags
                                           + CLS_FLAGS)
        t = trainer.build(args, num_classes=task.num_classes)
        ops.reset_launches()
        losses, step_s = [], []
        for i in range(args.steps):
            t0 = time.perf_counter()
            t.state, m = t.train_step(t.state, t.frozen,
                                      on_dev(task.batch(args.batch, i)),
                                      step_rng(0, i))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        n, rows, at = HELD_OUT
        bundle = peft_mod.make(t.state["trainable"]["peft"], t.popt)
        correct = 0
        with torch.no_grad():
            for k in range(n):
                b = on_dev(task.batch(rows, at + k))
                pred = t.model.classify(t.params, b["tokens"], bundle)
                correct += int((pred.argmax(-1) == b["labels"]).sum())
        counts = dict(ops.launches())
        acc = correct / (n * rows)
        log(f"{phase} classify/{label}", arch=args.arch, steps=args.steps,
            loss_first=f"{losses[0]:.4f}", loss_last=f"{losses[-1]:.4f}",
            median_ms_per_step=f"{median(step_s) * 1e3:.2f}",
            held_out_acc=f"{acc:.4f}", held_out_rows=n * rows,
            launches=sum(counts.values()), required="no")
        results[label] = dict(losses=losses, held_out_acc=acc,
                              median_ms_per_step=median(step_s) * 1e3)
        if any(counts.values()) or not all(np.isfinite(losses)):
            raise AssertionError(f"{phase} {label}: launches {counts} or a "
                                 "loss not finite")
        if label in keep:
            kept[label] = (t.params, bundle)
        del t, bundle
    return results, kept


def trained_stream(engine, args, arrivals):
    """Serve ``arrivals`` through the launcher's scheduler and client loop,
    capturing each request's first-token logits row (the row its final
    prefill chunk reported). Returns (scheduler, {rid: row float32})."""
    from repro_torch.launch import serve as launcher
    sched = launcher.make_scheduler(engine, args)
    step, install, cap, rows = engine.serve_step, sched._install, {}, {}

    def tapped(*a):
        out = step(*a)
        cap["logits"] = out[1]
        return out

    def grab(req, slot, length, first, cache=None):
        if req.rid not in rows and cache is None:
            rows[req.rid] = torch.as_tensor(
                cap["logits"][slot]).float().clone()
        return install(req, slot, length, first, cache)
    engine.serve_step, sched._install = tapped, grab
    try:
        launcher.run_with_retries(sched, arrivals)
    finally:
        del engine.serve_step
    return sched, rows


def first_rows(model, params, tables, args, arrivals):
    """Serve ``arrivals`` on a fresh engine over the stacked ``tables``:
    (the scheduler, the engine's dispatches, the first-token rows (n, V)
    float32 in arrival order, or None where a request has none)."""
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    engine = ServeEngine(model, params, ServeConfig(max_len=MAX_LEN),
                         fused_tasks=tables)
    d0 = engine.dispatches
    sched, rows = trained_stream(engine, args, arrivals)
    torch.cuda.synchronize()
    return (sched, engine.dispatches - d0,
            [rows.get(req.rid) for _, req in arrivals])


def fuse_and_serve(report, trained, backbone):
    """7c: fuse 7a's parameters, hold forward through the tables against
    forward through the reparametrizations (float32), then serve both
    tables as two bf16 tasks and hold each request's first-token logits
    against Model.logits through its reparametrization (``against_float32``
    per task), and the control serves (``control_serves``) against the
    same: each must fail in its wrong tasks. Returns the launches of the
    served stream and the float32 fused tables by label; the served
    tokens go to ``report["serve_trained"]["streams"]``."""
    from repro_torch import configs
    from repro_torch.core import aot as aot_mod
    from repro_torch.core import peft as peft_mod
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launcher
    from repro_torch.models.model import Model, ModelOptions
    cfg = configs.get("smollm-360m")
    f32, dt = torch.float32, torch.bfloat16
    ref32 = Model(cfg, ModelOptions(attn_impl="ref"), device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, FUSE_TOKENS, generator=gen,
                         device=DEV)
    fused_opt = peft_mod.PEFTOptions(method="aot",
                                     aot=aot_mod.AoTOptions(mode="fused"))
    tables, failed, fused32 = [], [], {}
    for label, bundle in trained.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused = aot_mod.fuse(bundle["params"]["aot"], cfg, bundle["opt"].aot,
                             embed=backbone["embed"]["tok"], dtype=f32)
        torch.cuda.synchronize()
        fuse_s = time.perf_counter() - t0
        err, share = fused_vs_reparam(ref32, backbone, bundle,
                                      peft_mod.make({"aot": fused},
                                                    fused_opt), toks)
        log(f"7c fuse/{label}", fuse_s=f"{fuse_s:.2f}",
            table_gib=f"{fused['table'].numel() * 4 / 2 ** 30:.2f}",
            tokens="x".join(map(str, FUSE_TOKENS)),
            max_abs_err=f"{err:.3e}", bitwise_share=f"{share:.4f}",
            tol=TOL[f32])
        # ROADMAP C5: the same fusion with GEMMs of the forward's shapes
        # (as many rows per chunk as the forward has tokens), recorded
        chunk = FUSE_TOKENS[0] * FUSE_TOKENS[1]
        same = aot_mod.fuse(bundle["params"]["aot"], cfg, bundle["opt"].aot,
                            embed=backbone["embed"]["tok"], dtype=f32,
                            vocab_chunk=chunk)
        err_f, share_f = fused_vs_reparam(ref32, backbone, bundle,
                                          peft_mod.make({"aot": same},
                                                        fused_opt), toks)
        del same
        log(f"7c fuse/{label} C5", vocab_chunk_8192=f"{err:.3e}",
            vocab_chunk_forward=chunk, max_abs_err_forward=f"{err_f:.3e}",
            bitwise_share_forward=f"{share_f:.4f}")
        report.setdefault("fuse", {})[label] = dict(
            fuse_s=fuse_s, max_abs_err=err, bitwise_share=share,
            forward_chunk=chunk, max_abs_err_forward=err_f,
            bitwise_share_forward=share_f)
        if not err <= TOL[f32]:
            failed.append(f"fused {label} off by {err:.3e}")
        tables.append({"table": fused["table"].to(dt)})
        fused32[label] = fused
    torch.cuda.empty_cache()
    params = cast_backbone(backbone, dt)
    model = Model(cfg, ModelOptions(dt, dt), device=DEV)
    args = launcher.parser().parse_args(SERVE_TRAINED)
    arrivals = launcher.make_arrivals(args, cfg.vocab_size, args.tasks)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    sched, dispatched, rows = first_rows(model, params,
                                         aot_mod.stack_tasks(tables), args,
                                         arrivals)
    sec = time.perf_counter() - t0
    counts = dict(ops.launches())
    findings = sched.drain_check()
    got = dict(ticks=sched.ticks, dispatched=dispatched,
               finished=len(sched.finished))
    if got != TRAINED_EXPECT:
        failed.append(f"counts {got} != {TRAINED_EXPECT}")
    if findings:
        failed.append(f"leaks {findings}")
    try:
        check_launches("7c", counts, trained_launches(cfg.num_layers,
                                                      dispatched))
    except AssertionError as e:
        failed.append(str(e))
    if any(r is None for r in rows):
        raise AssertionError(f"7c: {failed + ['a request has no row']}")
    ref16 = Model(cfg, ModelOptions(dt, dt, attn_impl="ref"), device=DEV)
    by_task = list(trained.values())
    task_ids = [req.task_id for _, req in arrivals]
    lg_p, lg_32, lg_0 = [], [], []
    with torch.no_grad():
        for _, req in arrivals:
            prompt = torch.from_numpy(req.prompt).to(DEV)[None]
            peft = by_task[req.task_id]
            lg_p.append(ref16.logits(params, prompt, peft)[0, -1].float())
            lg_32.append(ref32.logits(backbone, prompt, peft)[0, -1].float())
            lg_0.append(ref32.logits(backbone, prompt)[0, -1].float())
    lg_k, lg_p, lg_32, lg_0 = map(torch.stack, (rows, lg_p, lg_32, lg_0))
    res = against_plain(lg_k, lg_p)
    f32 = against_float32(lg_k, lg_p, lg_32, lg_0, task_ids)
    if not f32["ok"]:
        failed.append(f"first-token logits off the reparametrization in "
                      f"tasks {sorted(rejected(f32))}")
    log("7c serve trained", requests=f"{len(sched.finished)}/{len(arrivals)}",
        tokens=sched.tokens_emitted, ticks=sched.ticks, dispatched=dispatched,
        seconds=f"{sec:.3f}",
        tokens_per_s=f"{sched.tokens_emitted / sec:.1f}",
        drain="clean" if not findings else findings, launches=counts,
        vs_float32=f32_text(f32), vs_plain_bf16=verdict(res),
        within_2e_2="yes" if res["ok"] else "no",
        failures="none" if not failed else failed)
    controls = {}
    for name, stacked, wrong in control_serves(tables):
        arrivals = launcher.make_arrivals(args, cfg.vocab_size, args.tasks)
        _, _, lg_c = first_rows(model, params, stacked, args, arrivals)
        del stacked
        if any(r is None for r in lg_c):
            failed.append(f"control {name}: a request has no row")
            continue
        ctl = against_float32(torch.stack(lg_c), lg_p, lg_32, lg_0,
                              task_ids)
        controls[name] = dict(ctl, wrong=sorted(wrong),
                              rejected=sorted(rejected(ctl)))
        if rejected(ctl) != wrong:
            failed.append(f"control {name}: the gate rejected tasks "
                          f"{sorted(rejected(ctl))}, not {sorted(wrong)}")
        log(f"7c control/{name}", wrong_tasks=sorted(wrong),
            rejected=sorted(rejected(ctl)), vs_float32=f32_text(ctl))
    report["serve_trained"] = dict(res, vs_float32=f32, controls=controls,
                                   counts=got, seconds=sec,
                                   tokens=sched.tokens_emitted,
                                   streams=stream_outs(sched.finished),
                                   launches=counts, failures=failed)
    if failed:
        raise AssertionError(f"7c: {failed}")
    return {"trained_serve": counts}, fused32


def phase_train(report):
    """Phase 7 (7a, 7b, 7c); returns 7c's launches by path and what phase
    9 carries on from: 7a's fc train state and 7c's float32 fused tables
    by label."""
    t0 = time.perf_counter()
    trained, backbone, states = train_lm(report)
    report["classify"] = train_classify()[0]
    launches, fused32 = fuse_and_serve(report, trained, backbone)
    report["train_seconds"] = time.perf_counter() - t0
    log("7 train", seconds=f"{report['train_seconds']:.1f}")
    return launches, dict(state=states["fc"], fused32=fused32)


# ---------------------------------------------------------------------------
# phase 9: the lifecycle across processes (checkpoints and resume, the
# fused-table export, serve --load, the launcher's overload flags)
# ---------------------------------------------------------------------------

# scratch for 9a / 9b under the checkout (build/ is not committed); each
# part removes its directory when it ends
LIFECYCLE_DIR = ROOT / "build" / "lifecycle"
# 9a: the training launcher with its defaults (7a's fc run: smollm-360m,
# AoT fc rank 32, seq 128, batch 8, lr 5e-3), stopped after the first count
# of steps and resumed to the second in another process
RESUME_STEPS = (20, 30)
RESUME_FLAGS = []       # the launcher's defaults (the CPU rehearsal adds)
# 9b: 7c's stream (two tasks, eight requests) from the exported tables
LOAD_SERVE = [f for f in SERVE_TRAINED if f != "--demo"]
# 9c: phase 5's engine under the launcher's overload flags: bursts of 6
# (the gap derived from --rate 0.5: 12 ticks) against a queue of 4, a
# class mix, deadlines on latency requests, 2 retries, an 8-tick drain;
# then the same flags with arrivals from a trace (OVERLOAD_TRACES)
OVERLOAD = ["--requests", "16", "--max-queue", "4", "--priority-mix",
            "latency=0.25,standard=0.5,best_effort=0.25",
            "--deadline-ticks", "24", "--max-retries", "2", "--backoff",
            "2", "--grace-ticks", "8"]
OVERLOAD_RUNS = {"bursty": ["--arrivals", "bursty", "--burst", "6"],
                 "trace_ticks": ["--arrival-trace", "trace_ticks"],
                 "trace_classes": ["--arrival-trace", "trace_classes"]}
# tick[,class] per line: a burst of 8, a pair, a late burst (classes drawn
# from the mix); and lines that name a class (no draw) among lines that do
# not
OVERLOAD_TRACES = {
    "trace_ticks": "0\n0\n0\n0\n0\n0\n0\n0\n3\n3\n40\n40\n40\n41\n41\n41\n",
    "trace_classes": "# tick,class\n0,best_effort\n0,best_effort\n0\n"
                     "0,best_effort\n0,latency\n1\n1,latency\n1,standard\n"
                     "2\n2,latency\n30,best_effort\n30\n30,latency\n31\n"
                     "31,latency\n60,best_effort\n"}
# every count of each 9c run, from the CPU replay with a model-less engine
# (the schedule does not depend on the tokens: no stop or end token)
OVERLOAD_EXPECT = {
    "bursty": dict(requests=16, ticks=36, dispatched=36,
                   sheds={"displaced": 1, "queue_full": 1}, retries=2,
                   gave_up=0, deadline_misses=2,
                   aborted={"deadline": 2, "shutdown": 10}, finished=4,
                   drain_finished=4, drain_shed=10, drain_grace_used=8),
    "trace_ticks": dict(requests=16, ticks=50, dispatched=50,
                        sheds={"displaced": 2, "queue_full": 4}, retries=6,
                        gave_up=0, deadline_misses=3,
                        aborted={"deadline": 3, "shutdown": 8}, finished=5,
                        drain_finished=5, drain_shed=8, drain_grace_used=8),
    "trace_classes": dict(requests=16, ticks=69, dispatched=69,
                          sheds={"displaced": 2, "queue_full": 3},
                          retries=4, gave_up=1, deadline_misses=3,
                          aborted={"deadline": 3, "shutdown": 3},
                          finished=9, drain_finished=9, drain_shed=3,
                          drain_grace_used=8),
}


def tree_bits_equal(a, b):
    """The leaves of two trees (tensors, ints) that are not bitwise
    equal, as their indices in jax's order (empty: all equal)."""
    from repro_torch import tree
    la, lb = tree.sorted_leaves(a), tree.sorted_leaves(b)
    if tree.structure(a) != tree.structure(b) or len(la) != len(lb):
        return ["structure"]
    return [i for i, (x, y) in enumerate(zip(la, lb))
            if not (torch.equal(x.cpu(), y.cpu())
                    and x.dtype == y.dtype
                    if isinstance(x, torch.Tensor) else x == y)]


def max_leaf_diff(a, b):
    """The largest abs difference over the tensor leaves of two trees."""
    from repro_torch import tree
    return max((float((x.detach().float() - y.detach().float()).abs().max())
                for x, y in zip(tree.sorted_leaves(a), tree.sorted_leaves(b))
                if isinstance(x, torch.Tensor) and x.numel()), default=0.0)


def train_process(ckpt_dir, steps):
    """``python -m repro_torch.launch.train --ckpt-dir D --steps N`` in a
    process of its own (the launcher's defaults, RESUME_FLAGS); returns
    (its seconds, its stdout). Raises if it fails."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--ckpt-dir",
           str(ckpt_dir), "--steps", str(steps)] + RESUME_FLAGS
    t0 = time.perf_counter()
    res = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=900)
    sec = time.perf_counter() - t0
    if res.returncode:
        raise AssertionError(f"9a: {' '.join(cmd[1:])} exited "
                             f"{res.returncode}: {res.stderr[-2000:]}")
    return sec, res.stdout


def ckpt_round_trip(state, directory):
    """In process: ``state`` saved (the host copy in ``save``, then the
    writer thread) and restored onto the card; returns (bytes on disk,
    the host copy's ms, the writer's ms, restore ms, the leaves not bitwise
    the saved state's)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    mgr = CheckpointManager(str(directory), keep=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(1, state, extra={"step": 1})
    t1 = time.perf_counter()
    mgr.wait()
    t2 = time.perf_counter()
    got, _ = mgr.restore(state, device=DEV)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    size = (Path(directory) / "step_0000000001" / "arrays.npz").stat().st_size
    return (size, (t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3,
            tree_bits_equal(got, state))


def resume_across_processes(report, state):
    """9a: the training launcher run to RESUME_STEPS[0] in one process and
    resumed to RESUME_STEPS[1] in a second; the final checkpoint restored
    (trainable parameters, AdamW's mu, nu and step, the step counter) must
    be bitwise ``state``, 7a's fc state after as many unbroken steps in
    this process (the fc step has no index backward into a trainable
    tensor, so the card repeats it bit for bit). Also: ``state`` saved and
    restored in process, bitwise; the checkpoint's bytes and its save and
    restore ms reported."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import train as trainer
    args = trainer.parser().parse_args(RESUME_FLAGS)
    root = LIFECYCLE_DIR / "resume"
    shutil.rmtree(root, ignore_errors=True)
    failed, res = [], {}
    try:
        secs = []
        for steps in RESUME_STEPS:
            sec, out = train_process(root / "split", steps)
            secs.append(sec)
        if f"'kind': 'resume', 'step': {RESUME_STEPS[0]}" not in out:
            failed.append(f"the second process did not resume at "
                          f"{RESUME_STEPS[0]}: {out[-500:]}")
        mgr = CheckpointManager(str(root / "split" / args.arch))
        steps_kept = mgr.all_steps()
        got, extra = mgr.restore(state, device=DEV)
        bad = tree_bits_equal(got, state)
        res = dict(process_s=secs, steps_kept=steps_kept,
                   final_step=got["step"], data=extra.get("data"),
                   not_bitwise=bad, max_abs_diff=max_leaf_diff(got, state))
        if got["step"] != RESUME_STEPS[1] or steps_kept != list(RESUME_STEPS):
            failed.append(f"final step {got['step']}, kept {steps_kept}")
        if bad:
            failed.append(f"resumed state not bitwise 7a's: leaves {bad}, "
                          f"max abs diff {res['max_abs_diff']:.3e}")
        size, host_ms, write_ms, restore_ms, rt_bad = ckpt_round_trip(
            state, root / "round_trip")
        res.update(bytes=size, save_host_copy_ms=host_ms,
                   save_write_ms=write_ms, restore_ms=restore_ms,
                   round_trip_not_bitwise=rt_bad)
        if rt_bad:
            failed.append(f"saved and restored in process: leaves {rt_bad} "
                          "differ")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("9a resume", processes=",".join(f"{s:.1f}s" for s in secs),
        steps=f"{RESUME_STEPS[0]}+{RESUME_STEPS[1] - RESUME_STEPS[0]}",
        vs_unbroken="bitwise" if not res.get("not_bitwise")
        else f"{len(res['not_bitwise'])} leaves differ",
        max_abs_diff=f"{res.get('max_abs_diff', 0):.3e}",
        ckpt_bytes=res.get("bytes"),
        save_ms=f"{res.get('save_host_copy_ms', 0):.1f}+"
                f"{res.get('save_write_ms', 0):.1f}",
        restore_ms=f"{res.get('restore_ms', 0):.1f}",
        round_trip="bitwise" if not res.get("round_trip_not_bitwise")
        else res.get("round_trip_not_bitwise"),
        failures="none" if not failed else failed)
    report["resume"] = dict(res, failures=failed)
    if failed:
        raise AssertionError(f"9a: {failed}")


def export_load_serve(report, fused32, want_streams):
    """9b: 7c's float32 fused tables (``fused32``: fc, kron) written
    through ``launch.export.export_tasks`` (after a check that the disk
    holds them), then served through the launcher's functions
    (``build_engine`` with ``--load``, so ``load_tasks``, in bf16;
    ``make_arrivals``; ``serve``) on 7c's stream: every token equal to
    7c's in-memory serve (``want_streams``), every request finished, the
    pool drained clean, the counts TRAINED_EXPECT, 32 launches of the
    fused gather-add + norm and ragged attention per tick. Reports seconds
    to write, to load (disk to host) and to stage (the rest of
    build_engine: weights, copy to the card, cast, stack), the memory
    allocated before the build, its peak and the run's. Returns the
    served stream's launches."""
    from repro_torch import configs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.kernels import ops
    from repro_torch.launch import export as exporter
    from repro_torch.launch import serve as launcher
    cfg = configs.get("smollm-360m")
    root = LIFECYCLE_DIR / "fused"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    need = sum(f["table"].numel() * 4 for f in fused32.values())
    free = shutil.disk_usage(root).free
    failed = []
    try:
        if free < need * 1.02:
            raise AssertionError(f"9b: {free / 1e9:.2f} GB free under "
                                 f"{root}, the tables need {need / 1e9:.2f}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = exporter.export_tasks(str(root), fused32, cfg.name)
        write_s = time.perf_counter() - t0
        size = sum(p.stat().st_size for p in root.rglob("*"))
        fused32.clear()             # the card holds only what is loaded
        gc.collect()
        torch.cuda.empty_cache()
        args = launcher.parser().parse_args(LOAD_SERVE + ["--load",
                                                          str(root)])
        load_s = [0.0]
        restore = CheckpointManager.restore

        def timed_restore(self, *a, **kw):
            t = time.perf_counter()
            out = restore(self, *a, **kw)
            load_s[0] += time.perf_counter() - t
            return out
        fresh_peak()
        before = torch.cuda.memory_allocated() / 2 ** 30
        CheckpointManager.restore = timed_restore
        try:
            t0 = time.perf_counter()
            engine = launcher.build_engine(args)
            torch.cuda.synchronize()
            engine_s = time.perf_counter() - t0
        finally:
            CheckpointManager.restore = restore
        build_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        arrivals = launcher.make_arrivals(args, cfg.vocab_size,
                                          engine.num_tasks)
        d0 = engine.dispatches
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        sched = launcher.serve(engine, args, arrivals)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = dict(ops.launches())
        dispatched = engine.dispatches - d0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        got = stream_outs(sched.finished)
        same = sum(got.get(r) == t for r, t in want_streams.items())
        div = first_divergence({r: t for r, t in got.items()
                                if r in want_streams}, want_streams, {})
        findings = sched.drain_check()
        n = dict(ticks=sched.ticks, dispatched=dispatched,
                 finished=len(sched.finished))
        if same != len(want_streams) or len(got) != len(want_streams):
            failed.append(f"tokens equal 7c's in {same}/"
                          f"{len(want_streams)} requests")
        if n != TRAINED_EXPECT:
            failed.append(f"counts {n} != {TRAINED_EXPECT}")
        if findings:
            failed.append(f"leaks {findings}")
        try:
            check_launches("9b", counts, trained_launches(cfg.num_layers,
                                                          dispatched))
        except AssertionError as e:
            failed.append(str(e))
        res = dict(steps=steps, bytes=size, write_s=write_s,
                   load_s=load_s[0], stage_s=engine_s - load_s[0],
                   tasks=engine.num_tasks, seconds=sec,
                   tokens=sched.tokens_emitted,
                   tokens_per_s=sched.tokens_emitted / sec,
                   streams_equal_7c=f"{same}/{len(want_streams)}",
                   allocated_before_gib=before, build_peak_gib=build_peak,
                   peak_memory_gib=peak, launches=counts, failures=failed,
                   **n)
        del engine, sched
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("9b export/load/serve", steps=steps, tables_gb=f"{size / 1e9:.2f}",
        disk_free_gb=f"{free / 1e9:.1f}", write_s=f"{write_s:.2f}",
        load_s=f"{res['load_s']:.2f}", stage_s=f"{res['stage_s']:.2f}",
        requests=f"{n['finished']}/{len(arrivals)}", ticks=n["ticks"],
        dispatched=dispatched, tokens_per_s=f"{res['tokens_per_s']:.1f}",
        streams_equal_7c=res["streams_equal_7c"],
        first_divergence="none" if div is None else f"rid {div[0]}",
        drain="clean" if not findings else findings, launches=counts,
        allocated_before_gib=f"{before:.2f}",
        build_peak_gib=f"{build_peak:.2f}", peak_memory_gib=f"{peak:.2f}",
        failures="none" if not failed else failed)
    report["load_serve"] = res
    if failed:
        raise AssertionError(f"9b: {failed}")
    return {"lifecycle_load_serve": counts}


def phase_lifecycle(report, kept):
    """9a and 9b (after phase 7, whose fc state and fused tables ``kept``
    holds); returns 9b's launches by path."""
    t0 = time.perf_counter()
    resume_across_processes(report, kept.pop("state"))
    launches = export_load_serve(report, kept.pop("fused32"),
                                 report["serve_trained"]["streams"])
    report["lifecycle_seconds"] = time.perf_counter() - t0
    log("9ab lifecycle", seconds=f"{report['lifecycle_seconds']:.1f}")
    return launches


def overload_args(label, trace_dir):
    """The launcher's arguments of the 9c run ``label``: BASE, OVERLOAD,
    its OVERLOAD_RUNS flags, a trace name written to ``trace_dir``."""
    from repro_torch.launch import serve as launcher
    extra = list(OVERLOAD_RUNS[label])
    if "--arrival-trace" in extra:
        i = extra.index("--arrival-trace") + 1
        path = Path(trace_dir) / f"{extra[i]}.txt"
        path.write_text(OVERLOAD_TRACES[extra[i]])
        extra[i] = str(path)
    return launcher.parser().parse_args(BASE + OVERLOAD + extra)


def overload_run(engine, args):
    """One 9c stream through the launcher's code (``make_arrivals``,
    ``make_scheduler``, ``run_with_retries`` with the flags' retries,
    backoff and drain), counting sheds by reason. Returns the scheduler,
    the arrivals, the rids that gave up, seconds, the kernels' launches
    and ``overload_counts``."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launcher
    arrivals = launcher.make_arrivals(args, engine.model.cfg.vocab_size,
                                      engine.num_tasks)
    sched = launcher.make_scheduler(engine, args)
    sheds, shed = {}, sched._shed

    def counted_shed(req, reason):
        sheds[reason] = sheds.get(reason, 0) + 1
        shed(req, reason)
    sched._shed = counted_shed
    d0 = engine.dispatches
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    gave_up, retries, drain, sched = launcher.run_with_retries(
        sched, arrivals, grace_ticks=args.grace_ticks,
        max_retries=args.max_retries, backoff=args.backoff)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    aborted = {}
    for r in sched.aborted.values():
        aborted[r.finish_reason] = aborted.get(r.finish_reason, 0) + 1
    counts = dict(requests=len(arrivals), ticks=sched.ticks,
                  dispatched=engine.dispatches - d0,
                  sheds=dict(sorted(sheds.items())), retries=retries,
                  gave_up=len(gave_up), deadline_misses=sched.deadline_misses,
                  aborted=dict(sorted(aborted.items())),
                  finished=len(sched.finished),
                  drain_finished=drain.finished,
                  drain_shed=len(drain.shed_rids),
                  drain_grace_used=drain.grace_ticks_used)
    return dict(sched=sched, arrivals=arrivals, gave_up=gave_up,
                drain=drain, seconds=sec, launches=dict(ops.launches()),
                counts=counts)


def overload_failures(label, run, layers):
    """9c's gates of one run (empty = passed): the counts are the CPU
    replay's (OVERLOAD_EXPECT), every request finished, gave up or was
    aborted (deadline, shutdown), the pool and the drain report hold no
    leak, and each kernel launched ``layers`` times per dispatched tick."""
    sched, c, bad = run["sched"], run["counts"], []
    want = OVERLOAD_EXPECT.get(label)
    if c != want:
        diff = {k: (c.get(k), (want or {}).get(k))
                for k in set(c) | set(want or {})
                if c.get(k) != (want or {}).get(k)}
        bad.append(f"counts differ from the replay's (got, want): {diff}")
    rids = {r.rid for _, r in run["arrivals"]}
    done = set(sched.finished) | set(run["gave_up"]) | set(sched.aborted)
    if done != rids or sched.busy():
        bad.append(f"unaccounted requests {sorted(rids - done)}")
    leaks = sorted(set(sched.drain_check()) | set(run["drain"].leak_findings))
    if leaks:
        bad.append(f"leaks {leaks}")
    try:
        check_launches(label, run["launches"], {
            "ragged_paged_attention": layers * c["dispatched"],
            "aot_gather_add_multitask": layers * c["dispatched"]})
    except AssertionError as e:
        bad.append(str(e))
    return bad


def phase_overload(report, engine):
    """9c: OVERLOAD_RUNS on phase 5's engine through the launcher's flags;
    every run's counts must be the CPU replay's and overload_failures'
    gates hold. Returns the launches by path."""
    layers = engine.model.cfg.num_layers
    res, launches, failed = {}, {}, {}
    d = LIFECYCLE_DIR / "traces"
    d.mkdir(parents=True, exist_ok=True)
    try:
        for label in OVERLOAD_RUNS:
            run = overload_run(engine, overload_args(label, d))
            bad = overload_failures(label, run, layers)
            c, sec = run["counts"], run["seconds"]
            log(f"9c overload/{label}", seconds=f"{sec:.3f}",
                tokens_per_s=f"{run['sched'].tokens_emitted / sec:.1f}",
                **c, launches=run["launches"], failures=bad or "none")
            res[label] = dict(c, seconds=sec,
                              tokens=run["sched"].tokens_emitted,
                              launches=run["launches"], failures=bad)
            launches[f"overload_{label}"] = run["launches"]
            if bad:
                failed[label] = bad
    finally:
        shutil.rmtree(d, ignore_errors=True)
    report["overload"] = res
    if failed:
        raise AssertionError(f"phase 9c failed: {failed}")
    return launches


# ---------------------------------------------------------------------------
# phase 8: the paper's own encoders, roberta-large and deberta-xl
# ---------------------------------------------------------------------------

ENC_TASKS = 4                       # 8a's stacked tables
ENC_CHECK = (2, 384)                # 8b's tokens
ENC_DEBERTA = (8, 384)              # 8c's tokens
ENC_METHODS = PEFT_METHODS + ("aot_multitask",)
ENC_CLS_BASE = ["--arch", "roberta-large", "--rank", "32"]
# the run whose launches the kernels line's ``encoder`` entry of each
# kernel carries
ENC_PATH = {"flash_attention": "enc_roberta_none",
            "aot_gather_add": "enc_roberta_aot",
            "aot_gather_add_multitask": "enc_roberta_aot_multitask"}


def encoder_launches(layers, label):
    """What one ``Model.logits`` or ``classify`` call of an encoder with
    the method ``label`` of ENC_METHODS (or HUBERT_METHODS) launches: one
    flash attention (full mode) per layer, or for P-Tuning v1 none and one
    ``attention_chunked`` call per layer (its prompt is a bidirectional
    prefix), and, with AoT, one plain gather-add per layer (one task's
    table, or the multi-task entry for ``aot_multitask``: LayerNorm has no
    input norm to fuse); nothing else (LayerNorm, the MLP and the PEFT
    hooks are plain PyTorch)."""
    if label == "ptv1":
        return {"chunked": layers}
    want = {"flash_attention": layers}
    if label == "aot":
        want["aot_gather_add"] = layers
    if label == "aot_multitask":
        want["aot_gather_add_multitask"] = layers
    return want


def encoder_model(name, layers=0, seed=0, max_pos=0):
    """(model, params): the arch ``name`` (an encoder, or phase 13's
    front-ends) at full width in bf16 on the card (``layers`` > 0 cuts its
    depth; ``max_pos`` > 0 its learned positions), random weights from
    ``seed``."""
    from repro_torch import configs
    from repro_torch.models.model import Model, ModelOptions
    cfg = configs.get(name)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    dt = torch.bfloat16
    model = Model(cfg, ModelOptions(dt, dt, max_learned_pos=max_pos),
                  device=DEV)
    return model, model.init(seed)


def stacked_tables(cfg, embed, n):
    """``n`` fabricated tasks' fused tables (``random_fused``, seeds 0 to
    n - 1) stacked (L, n, V, d) in ``embed``'s dtype, filled one task at a
    time (no second copy of the stack)."""
    from repro_torch.core import aot as aot_mod
    out = torch.empty((cfg.num_layers, n, cfg.vocab_size, cfg.d_model),
                      dtype=embed.dtype, device=embed.device)
    for t in range(n):
        out[:, t] = aot_mod.random_fused(cfg, embed, seed=t, scale=0.03,
                                         vocab_chunk=4096,
                                         dtype=embed.dtype)["table"]
    return out


def encoder_setups(model, params, tables, b, gen):
    """label -> (params, bundle or None) for ENC_METHODS: PEFT_METHODS
    through ``peft_setup`` (AoT: task 0's table), and ``aot_multitask``:
    the stacked ``tables`` (L, tasks, V, d), row r of a batch of ``b`` on
    task r % tasks."""
    table = tables[:, 0].contiguous()
    setups = {label: peft_setup(label, model, params, table, gen)
              for label in PEFT_METHODS}
    setups["aot_multitask"] = (params, multitask_bundle(tables, b))
    return setups


def multitask_bundle(tables, b):
    """``tasks_peft`` over ``tables`` for a batch of ``b`` rows, row r on
    task r % tasks."""
    return tasks_peft(tables, torch.arange(b, dtype=torch.int32,
                                           device=tables.device)
                      % tables.shape[1])


def counted_logits(model, params, toks, bundle, label):
    """One ``Model.logits`` call with the launch counts zeroed just before:
    (logits, the counts); raises unless they are ``encoder_launches``'s
    and every logit is finite."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launches()
    lg = model.logits(params, toks, bundle)
    torch.cuda.synchronize()
    counts = dict(ops.launches())
    b, s = toks.shape
    check_launches(f"8 {label} b{b} s{s}", counts,
                   encoder_launches(model.cfg.num_layers, label))
    if not bool(torch.isfinite(lg).all()):
        raise AssertionError(f"8 {label} b{b} s{s}: a logit is not finite")
    return lg, counts


def multitask_equals_single(model, params, tables, toks):
    """The multi-task batch with every task id 0 against one task's table
    (task 0's) through the single-table gather-add: the sums are exact, so
    the logits must be bitwise equal. Returns whether they are."""
    from repro_torch.core import peft as P
    opt = P.PEFTOptions(method="aot", aot=P.AoTOptions(mode="fused"))
    zeros = torch.zeros(toks.shape[0], dtype=torch.int32, device=toks.device)
    multi = model.logits(params, toks, tasks_peft(tables, zeros))
    single = model.logits(params, toks, P.make(
        {"aot": {"table": tables[:, 0].contiguous()}}, opt))
    return torch.equal(multi, single)


def encoder_fig3(report, gen):
    """8a: roberta-large at full width (24 layers, bf16, random weights
    seed 0) through ``Model.logits`` at speed_overhead.py's grid, every
    method of ENC_METHODS (4 fabricated tasks' tables; AoT takes task 0's,
    the multi-task batch all 4): one counted call each (exact launches,
    finite logits), then PEFT_ROUNDS timed runs in turns, median ms and
    its ratio to the backbone's (reported, no limit); the multi-task batch
    with every task id 0 bitwise the single-table call. Returns the
    launches by path."""
    model, params = encoder_model("roberta-large")
    cfg = model.cfg
    tables = stacked_tables(cfg, params["embed"]["tok"], ENC_TASKS)
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(2)
    grid, counts = {}, {}
    setups = encoder_setups(model, params, tables, LOGITS_GRID[0][0], gen)
    for gb, gs in LOGITS_GRID:
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (gb, gs)),
                               dtype=torch.int32, device=DEV)
        # the mixed batch's task ids follow the batch
        setups["aot_multitask"] = (params, multitask_bundle(tables, gb))
        with torch.no_grad():
            for label, (p, bd) in setups.items():
                counts[f"enc_roberta_{label}"] = counted_logits(
                    model, p, toks, bd, label)[1]
            ms = {label: [] for label in ENC_METHODS}
            for r in range(PEFT_ROUNDS):
                for label in ENC_METHODS[r:] + ENC_METHODS[:r]:
                    p, bd = setups[label]
                    ms[label].append(wall_ms(
                        lambda i: model.logits(p, toks, bd), iters=3,
                        warmup=1))
        ms = {label: median(t) for label, t in ms.items()}
        grid[f"b{gb}_s{gs}"] = ms
        log("8a logits", arch=cfg.name, b=gb, s=gs, rounds=PEFT_ROUNDS,
            **{label: f"{t:.3f}ms({t / ms['none']:.3f}x)"
               for label, t in ms.items()})
    with torch.no_grad():
        same = multitask_equals_single(model, params, tables, toks)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log("8a aot vs multi-task", b=toks.shape[0], s=toks.shape[1],
        all_task_0="bitwise" if same else "DIFFER", required="bitwise",
        launches_per_call={label: {k: v for k, v in c.items() if v}
                           for label, c in counts.items()},
        peak_memory_gib=f"{peak:.2f}",
        tables_gib=f"{tables.numel() * 2 / 2 ** 30:.2f}")
    report["encoder"]["fig3"] = dict(logits_ms=grid, launches=counts,
                                     multitask_bitwise=same,
                                     peak_memory_gib=peak)
    if not same:
        raise AssertionError("8a: the multi-task batch with every task id "
                             "0 is not bitwise the single-table call")
    return counts


def encoder_cross_check(report, gen):
    """8b: roberta-large at full width with 2 layers (seed 1), every
    method of ENC_METHODS through the kernels against the plain versions
    on ENC_CHECK tokens (``against_plain``: every logit within LOGIT_TOL,
    a differing argmax counted as a near tie); raises if one missed."""
    model, params = encoder_model("roberta-large", layers=2, seed=1)
    tables = stacked_tables(model.cfg, params["embed"]["tok"], ENC_TASKS)
    b, s = ENC_CHECK
    toks = torch.randint(0, model.cfg.vocab_size, (b, s), generator=gen,
                         device=DEV, dtype=torch.int32)
    res = {}
    with torch.no_grad():
        for label, (p, bd) in encoder_setups(model, params, tables, b,
                                             gen).items():
            lg_k = model.logits(p, toks, bd).float()
            with plain_ops():
                lg_p = model.logits(p, toks, bd).float()
            res[label] = against_plain(lg_k, lg_p)
            del lg_k, lg_p
    log("8b cross-check", arch=model.cfg.name, layers=2, b=b, s=s,
        **{label: verdict(r) for label, r in res.items()})
    report["encoder"]["cross_check"] = res
    bad = [label for label, r in res.items() if not r["ok"]]
    if bad:
        raise AssertionError(f"8b: kernel and plain logits disagree for "
                             f"{bad}")


def encoder_deberta(report):
    """8c: deberta-xl at full width (48 layers, V 128100, bf16, random
    weights seed 0): the backbone and one fabricated fused task (L, V, d)
    through ``Model.logits`` at ENC_DEBERTA tokens: finite logits, exact
    launches, ms (wall, 3 calls) and peak memory reported. Returns the
    launches by path."""
    from repro_torch.core import aot as aot_mod
    from repro_torch.core import peft as P
    model, params = encoder_model("deberta-xl")
    cfg = model.cfg
    table = aot_mod.random_fused(cfg, params["embed"]["tok"], seed=0,
                                 scale=0.03, vocab_chunk=4096,
                                 dtype=torch.bfloat16)
    opt = P.PEFTOptions(method="aot", aot=P.AoTOptions(mode="fused"))
    runs = {"none": None, "aot": P.make({"aot": table}, opt)}
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, ENC_DEBERTA), dtype=torch.int32, device=DEV)
    counts, res = {}, {}
    with torch.no_grad():
        for label, bd in runs.items():
            torch.cuda.reset_peak_memory_stats()
            lg, c = counted_logits(model, params, toks, bd, label)
            counts[f"enc_deberta_{label}"] = c
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            del lg
            ms = wall_ms(lambda i: model.logits(params, toks, bd), iters=3,
                         warmup=1)
            res[label] = dict(ms=ms, peak_memory_gib=peak, launches=c)
            log(f"8c deberta/{label}", layers=cfg.num_layers,
                vocab=cfg.vocab_size, b=toks.shape[0], s=toks.shape[1],
                ms=f"{ms:.3f}", finite="yes", launches=c,
                peak_memory_gib=f"{peak:.2f}",
                table_gib=f"{table['table'].numel() * 2 / 2 ** 30:.2f}")
    res["ratio"] = res["aot"]["ms"] / res["none"]["ms"]
    report["encoder"]["deberta"] = res
    return counts


def classify_rows(model, params, batches, bundle):
    """``model.classify`` over every batch of token tensors, concatenated
    (n, classes) float32."""
    return torch.cat([model.classify(params, toks, bundle).float()
                      for toks in batches])


def encoder_classify(report):
    """8d: the paper's protocol on roberta-large (phase 7b's settings:
    float32, TF32 off, attn_impl="ref", CLS_TASK at roberta's vocabulary,
    60 steps at batch 16, lr 8e-3; mean pooling): AoT fc and BitFit
    trained, held-out accuracy reported; AoT fc fused (forward through the
    table within 2e-5 of forward through the reparametrization), cast to
    bf16 and served through the kernels' ``classify`` on the HELD_OUT
    batches; gate, as 7c's: the served logits within BF16_FACTOR x plain
    bf16's error of the float32 reparametrized logits and carrying the
    task's effect within CARRY_TOL (``against_float32``); a control serve
    with the table zeroed must fail it. Returns the served call's
    launches."""
    from repro_torch import configs
    from repro_torch.core import aot as aot_mod
    from repro_torch.core import peft as P
    from repro_torch.data.tasks import ClassificationTask
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model, ModelOptions
    cfg = configs.get("roberta-large")
    task_kw = dict(CLS_TASK, vocab_size=cfg.vocab_size)
    results, kept = train_classify(ENC_CLS_BASE, task_kw, "8d",
                                   keep=("aot_fc",))
    backbone, bundle = kept.pop("aot_fc")
    task = ClassificationTask(**task_kw)
    n, rows, at = HELD_OUT
    held = [task.batch(rows, at + k) for k in range(n)]
    batches = [torch.from_numpy(b["tokens"]).to(DEV) for b in held]
    labels = torch.from_numpy(np.concatenate([b["labels"] for b in held]))
    f32, dt = torch.float32, torch.bfloat16
    head = bundle["params"]["head"]
    fopt = P.PEFTOptions(method="aot", num_classes=2,
                         aot=P.AoTOptions(mode="fused"))
    failed = []
    with torch.no_grad():
        ref32 = Model(cfg, ModelOptions(attn_impl="ref"), device=DEV)
        fused = aot_mod.fuse(bundle["params"]["aot"], cfg, bundle["opt"].aot,
                             embed=backbone["embed"]["tok"], dtype=f32)
        err, share = fused_vs_reparam(ref32, backbone, bundle, P.make(
            {"aot": fused, "head": head}, fopt), batches[0])
        if not err <= TOL[f32]:
            failed.append(f"fused off by {err:.3e}")
        table = fused["table"].to(dt)
        del fused
        params = cast_backbone(backbone, dt)
        model = Model(cfg, ModelOptions(dt, dt), device=DEV)
        ref16 = Model(cfg, ModelOptions(dt, dt, attn_impl="ref"), device=DEV)
        served_bundle = lambda t: P.make({"aot": {"table": t}, "head": head},
                                         fopt)
        torch.cuda.synchronize()
        ops.reset_launches()
        served = classify_rows(model, params, batches, served_bundle(table))
        torch.cuda.synchronize()
        counts = dict(ops.launches())
        want = {k: v * n for k, v in encoder_launches(cfg.num_layers,
                                                      "aot").items()}
        try:
            check_launches("8d served", counts, want)
        except AssertionError as e:
            failed.append(str(e))
        plain16 = classify_rows(ref16, params, batches, bundle)
        lg_32 = classify_rows(ref32, backbone, batches, bundle)
        lg_0 = classify_rows(ref32, backbone, batches, P.make(
            {"head": head}, P.PEFTOptions(method="none", num_classes=2)))
        ids = [0] * len(labels)
        res = against_float32(served, plain16, lg_32, lg_0, ids)
        if not res["ok"]:
            failed.append("served classifier off the reparametrization")
        zero = classify_rows(model, params, batches,
                             served_bundle(torch.zeros_like(table)))
        ctl = against_float32(zero, plain16, lg_32, lg_0, ids)
        if rejected(ctl) != {0}:
            failed.append("the zeroed control passed the gate")
    acc = {name: (lg.cpu().argmax(-1) == labels).float().mean().item()
           for name, lg in (("served", served), ("float32", lg_32),
                            ("zeroed", zero))}
    log("8d serve classify", arch=cfg.name, fuse_max_abs_err=f"{err:.3e}",
        fuse_bitwise_share=f"{share:.4f}", rows=len(labels),
        launches=counts, vs_float32=f32_text(res),
        control_zeroed=f32_text(ctl),
        control_rejected=sorted(rejected(ctl)),
        held_out_acc=",".join(f"{k}:{v:.4f}" for k, v in acc.items()),
        failures="none" if not failed else failed)
    report["encoder"]["classify"] = dict(
        trained=results, fuse_max_abs_err=err, fuse_bitwise_share=share,
        vs_float32=res, control=ctl, held_out_acc=acc, launches=counts,
        failures=failed)
    if failed:
        raise AssertionError(f"8d: {failed}")
    return {"enc_classify_served": counts}


def phase_encoders(report):
    """Phase 8 (8a-8d), each part's memory freed before the next; returns
    the launches by path."""
    t0 = time.perf_counter()
    report["encoder"] = {}
    gen = torch.Generator(device=DEV).manual_seed(8)
    launches = {}
    for part in (lambda: encoder_fig3(report, gen),
                 lambda: encoder_cross_check(report, gen),
                 lambda: encoder_deberta(report),
                 lambda: encoder_classify(report)):
        launches.update(part() or {})
        gc.collect()
        torch.cuda.empty_cache()
    report["encoder"]["seconds"] = time.perf_counter() - t0
    log("8 encoders", seconds=f"{report['encoder']['seconds']:.1f}")
    return launches


# ---------------------------------------------------------------------------
# phase 10: the decoder variants at full width (h2o-danube-1.8b's sliding
# window over its ring, olmo-1b's non-parametric LayerNorm, qwen2.5-14b's
# QKV bias)
# ---------------------------------------------------------------------------

DEC_TABLE_SCALE = 0.02          # the fabricated tables' normals
# 10a: danube at all 24 layers, 4 tasks, max_len 8192 (a ring of 4096 rows)
DANUBE = dict(arch="h2o-danube-1.8b", layers=0, tasks=4, max_len=8192,
              static=(4, 6144, 32), slots=4, requests=8,
              prompt=(3000, 6000), new=(16, 48))
# 10b / 10c: phase 5's paged chunked stream and 5c's static mixed batch;
# qwen2.5 cut to 8 of its 48 layers (one bf16 table at full depth is 75 GB)
PAGED_DECODERS = {
    "olmo": dict(arch="olmo-1b", layers=0, tasks=4, requests=16,
                 static=(16, 512, 64)),
    "qwen": dict(arch="qwen2.5-14b", layers=8, tasks=2, requests=8,
                 static=(4, 512, 32)),
}
# the phase 10 run whose count rides with each kernel's phase 4 times at
# phase 10's shapes (``decoders``)
DEC_PATH = {"flash_attention": "decoder_danube_static",
            "decode_attention": "decoder_danube_static",
            "aot_gather_add_multitask": "decoder_qwen_paged"}


def fabricated_tables(cfg, n_tasks, dtype, seed=0):
    """Stacked fused tables (L, tasks, V, d) in ``dtype``, each (V, d)
    slice drawn in place on the card as normals x DEC_TABLE_SCALE (a
    float32 draw of qwen2.5's 8 x 152064 x 5120 table would be a 25 GB
    temporary)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    t = torch.empty(cfg.num_layers, n_tasks, cfg.vocab_size, cfg.d_model,
                    dtype=dtype, device=DEV)
    for layer in range(cfg.num_layers):
        for task in range(n_tasks):
            t[layer, task].normal_(0.0, DEC_TABLE_SCALE, generator=gen)
    return t


def decoder_engine(spec, max_len):
    """A ServeEngine over ``spec``'s arch (cut to ``spec["layers"]`` when
    set) in bf16, random weights (seed 0), QKV biases (where the config
    has them) drawn as normals x 0.1 from a seeded generator (zero biases
    would hide a missing add), and ``spec["tasks"]`` fabricated tables."""
    from repro_torch import configs
    from repro_torch.models.model import Model, ModelOptions
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    cfg = configs.get(spec["arch"])
    if spec["layers"]:
        cfg = cfg.replace(num_layers=spec["layers"], **spec.get("cut", {}))
    dt = torch.bfloat16
    model = Model(cfg, ModelOptions(dt, dt), device=DEV)
    params = model.init(0)
    if cfg.qkv_bias:
        gen = torch.Generator(device=DEV).manual_seed(5)
        for lp in params["layers"]:
            for b in ("bq", "bk", "bv"):
                lp["attn"][b].normal_(0.0, 0.1, generator=gen)
    tables = fabricated_tables(cfg, spec["tasks"], dt)
    return ServeEngine(model, params, ServeConfig(max_len=max_len),
                       fused_tasks={"table": tables})


def divergence(got, want, lgs):
    """A stream's greedy tokens ``got`` against the same prompt's tokens
    served alone ``want``, with ``lgs`` (n, V) float32 the alone run's
    logits that picked them: None when equal; else (the first index that
    differs, the gap in ``lgs`` there between ``want``'s token and
    ``got``'s, whether it is a near tie: within two LOGIT_TOL tolerances
    at the top logit's magnitude, phase 6's rule). Past the first
    difference the two continue from other tokens and are not compared."""
    for j, (a, b) in enumerate(zip(got, want)):
        if a != b:
            row = lgs[j]
            gap = (row[b] - row[a]).item()
            tol = LOGIT_TOL["atol"] + LOGIT_TOL["rtol"] * row[b].abs().item()
            return j, gap, gap <= 2 * tol
    if len(got) != len(want):
        return min(len(got), len(want)), float("inf"), False
    return None


def stream_vs_alone(engine, finished):
    """Each finished request's tokens against its prompt served alone
    (``Model.prefill`` of the exact prompt, then greedy decode steps with
    the logits kept): (requests equal, [(rid, index, gap)] near-tie
    divergences, [(rid, index, gap)] divergences that are not near
    ties)."""
    model, params = engine.model, engine.params
    equal, ties, bad = 0, [], []
    for rid, req in sorted(finished.items()):
        toks = torch.as_tensor(np.asarray(req.prompt)[None],
                               dtype=torch.int32, device=DEV)
        peft = engine._peft(torch.full((1,), req.task_id, dtype=torch.int32,
                                       device=DEV))
        logits, cache, pos = model.prefill(params, toks, peft,
                                           max_len=engine.cache_len)
        lgs, alone = greedy_decode(model, params, logits, cache, pos, peft,
                                   len(req.out))
        del cache
        d = divergence([int(t) for t in req.out], alone[0].tolist(),
                       lgs[:, 0])
        if d is None:
            equal += 1
        else:
            (ties if d[2] else bad).append((rid, d[0], round(d[1], 5)))
    return equal, ties, bad


def decoder_static(engine, label, shape, counts, seed=0):
    """5c's static mixed batch of ``shape`` = (b, prompt, steps) through
    ``ServeEngine.generate``, tasks assigned in turn; its launch gate.
    Returns (prompts, task ids, tokens, tokens/s)."""
    b, s, steps = shape
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, engine.model.cfg.vocab_size,
                           (b, s)).astype(np.int32)
    task_ids = (np.arange(b) % engine.num_tasks).astype(np.int32)
    engine.generate(prompts[:1, :64], 2, task_ids[:1])          # warm-up
    out, sec = static_mixed(engine, label, prompts, task_ids, steps, counts)
    return prompts, task_ids, out, b * steps / sec


def whole_logits(model, params, seq, peft, s):
    """``Model.logits`` over ``seq`` (b, s + steps), unembedded only at the
    positions s - 1 .. that picked the generated tokens: (steps + 1, b, V)
    float32."""
    h = model.forward(params, seq, peft)
    return model.unembed(params, h[:, s - 1:]).float().transpose(0, 1)


def ring_vs_window(model, params, tables, seq, s, lg_dec, peft):
    """10a's gate on the decode steps' logits ``lg_dec`` (steps + 1, b, V)
    of the prompts in ``seq`` (prompt i served with task i), as 7c's
    ``against_float32``: per prompt, against the float32 whole-sequence
    pass with the window (``ref32``), within BF16_FACTOR times the bf16
    whole-sequence pass's error, and carrying the window's effect (ref32
    less the float32 pass with no window) within CARRY_TOL; the bf16 pass
    with no window as a control that must fail in every prompt (a ring
    that dropped the window). LOGIT_TOL does not hold between two bf16
    orders of 24 layers (PERF.md, section 6), so the comparison of the
    decode with the bf16 whole pass is reported (``vs_whole``), not
    gated."""
    from repro_torch.models.model import Model, ModelOptions
    cfg, f32 = model.cfg, torch.float32
    nowin = Model(cfg.replace(attn_kind="full"), model.opts, device=DEV)
    lg_whole = whole_logits(model, params, seq, peft, s)
    lg_nowin = whole_logits(nowin, params, seq, peft, s)
    m32 = Model(cfg, ModelOptions(f32, f32), device=DEV)
    n32 = Model(cfg.replace(attn_kind="full"), ModelOptions(f32, f32),
                device=DEV)
    p32 = cast_backbone(params, f32)
    ref32, base32 = [], []
    for i in range(seq.shape[0]):
        one = tasks_peft(tables[:, i:i + 1].float(),
                         torch.zeros(1, dtype=torch.int32, device=DEV))
        ref32.append(whole_logits(m32, p32, seq[i:i + 1], one, s))
        base32.append(whole_logits(n32, p32, seq[i:i + 1], one, s))
        del one
    del p32
    rows = lambda x: x.reshape(-1, x.shape[-1])
    ref32, base32 = torch.cat(ref32, 1), torch.cat(base32, 1)
    ids = list(range(seq.shape[0])) * lg_dec.shape[0]
    res = against_float32(rows(lg_dec), rows(lg_whole), rows(ref32),
                          rows(base32), ids)
    control = against_float32(rows(lg_nowin), rows(lg_whole), rows(ref32),
                              rows(base32), ids)
    res["vs_whole"] = against_plain(lg_dec, lg_whole)
    res["control_rejected"] = sorted(rejected(control))
    res["control"] = control
    res["ok"] = res["ok"] and len(rejected(control)) == seq.shape[0]
    return res


def decoder_danube(report):
    """10a: danube at full width and depth. The static mixed batch (4
    prompts of 6144, one task each, 32 greedy steps through
    ``ServeEngine.generate``): a 4096-row ring, exact launches, the decode
    over the ring teacher-forced with generate's tokens picking exactly
    those tokens, and its logits held by :func:`ring_vs_window` (against
    a float32 whole pass with the window, the no-window bf16 pass as a
    control that must fail). The slots stream (8 requests
    of 3000-6000 tokens, buckets of 4096 and 8192: past the window, the
    C7 case): every request finished, exact launches, each request's
    tokens equal to its prompt's served alone but at near ties. The paged
    layout refused with the scheduler's error."""
    from repro_torch.launch import serve as launcher
    from repro_torch.serve.scheduler import InvalidConfig, Request
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    spec, counts, failures = DANUBE, {}, []
    engine = decoder_engine(spec, spec["max_len"])
    model, params, cfg = engine.model, engine.params, engine.model.cfg
    layers, window = cfg.num_layers, model.window()
    setup_s = time.perf_counter() - t0
    # ---- the static mixed batch
    prompts, task_ids, out, static_tps = decoder_static(
        engine, "decoder_danube_static", spec["static"], counts)
    b, s, steps = spec["static"]
    toks = torch.as_tensor(prompts, dtype=torch.int32, device=DEV)
    gen_toks = torch.as_tensor(out, dtype=torch.int32, device=DEV)
    peft = engine._peft(torch.as_tensor(task_ids, device=DEV))
    logits, cache, pos = model.prefill(params, toks, peft,
                                       max_len=engine.cache_len)
    rows = cache["k"].shape[2]
    if rows != window:
        failures.append(f"ring of {rows} rows, not {window}")
    lg_dec, _ = greedy_decode(model, params, logits, cache, pos, peft,
                              steps, forced=gen_toks)
    del cache, logits
    if not torch.equal(lg_dec[:-1].argmax(-1).T.int(), gen_toks):
        failures.append("teacher-forced decode disagrees with generate")
    seq = torch.cat([toks, gen_toks], 1)
    window_gate = ring_vs_window(model, params, engine.tables, seq, s,
                                 lg_dec, peft)
    del lg_dec
    if not window_gate["ok"]:
        failures.append(f"decode over the ring vs the window: "
                        f"{window_gate}")
    # ---- the slots stream
    rng = np.random.default_rng(10)
    lo, hi = spec["prompt"]
    arrivals = []
    for i in range(spec["requests"]):
        arrivals.append((i // 2, Request(
            rid=i, prompt=rng.integers(0, cfg.vocab_size, int(
                rng.integers(lo, hi + 1))).astype(np.int32),
            task_id=int(rng.integers(0, spec["tasks"])),
            max_new_tokens=int(rng.integers(spec["new"][0],
                                            spec["new"][1] + 1)))))
    flags = ["--arch", spec["arch"], "--demo", "--tasks",
             str(spec["tasks"]), "--slots", str(spec["slots"]),
             "--max-len", str(spec["max_len"]), "--dtype", "bfloat16",
             "--quiet", "--requests", str(spec["requests"])]
    args = launcher.parser().parse_args(flags + ["--layout", "slots",
                                                 "--prefill-chunk", "0"])
    d0 = engine.dispatches
    sched, slots_s = counted("decoder_danube_slots", counts,
                             lambda: launcher.serve(engine, args, arrivals))
    dispatched = engine.dispatches - d0
    n_pre = len(arrivals) + sched.preemptions
    buckets = sorted({sched._bucket(len(r.prompt)) for _, r in arrivals})
    if len(sched.finished) != len(arrivals) or sched.drain_check():
        failures.append(f"slots: {len(sched.finished)}/{len(arrivals)} "
                        f"finished, {sched.drain_check()}")
    try:
        check_launches("decoder_danube_slots",
                       counts["decoder_danube_slots"], {
            "flash_attention": layers * n_pre,
            "decode_attention": layers * (dispatched - n_pre),
            "aot_gather_add_multitask": layers * dispatched})
    except AssertionError as e:
        failures.append(str(e))
    equal, ties, bad = stream_vs_alone(engine, sched.finished)
    if bad:
        failures.append(f"slots vs alone: divergences past a near tie {bad}")
    try:
        launcher.make_scheduler(engine, launcher.parser().parse_args(
            flags + ["--layout", "paged"]))
        paged = "accepted"
        failures.append("kv_layout='paged' accepted an SWA config")
    except InvalidConfig as e:
        paged = f"InvalidConfig({e})"
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    sec = time.perf_counter() - t0
    tokens = sum(len(r.out) for r in sched.finished.values())
    log("10a danube", layers=layers, window=window, ring_rows=rows,
        setup_s=f"{setup_s:.1f}", static=f"{b}x{s}+{steps}",
        static_tokens_per_s=f"{static_tps:.1f}",
        decode_vs_whole=verdict(window_gate["vs_whole"]),
        vs_float32=f32_text(window_gate),
        control_rejected=window_gate["control_rejected"],
        slots_requests=f"{len(sched.finished)}/{len(arrivals)}",
        slots_buckets=buckets, slots_tokens=tokens,
        slots_tokens_per_s=f"{tokens / slots_s:.1f}",
        slots_ticks=sched.ticks, dispatched=dispatched,
        slots_vs_alone=f"{equal}/{len(sched.finished)} equal",
        near_tie_divergences=ties, paged=paged,
        peak_memory_gib=f"{peak:.2f}", seconds=f"{sec:.1f}",
        launches=counts, failures=failures or "none")
    report["decoders"]["danube"] = dict(
        setup_s=setup_s, ring_rows=rows, static_tokens_per_s=static_tps,
        window_gate=window_gate, slots_tokens_per_s=tokens / slots_s,
        slots_buckets=buckets, slots_equal=equal, near_ties=ties,
        divergences=bad, paged=paged, peak_memory_gib=peak, seconds=sec,
        launches=counts, failures=failures)
    if failures:
        raise AssertionError(f"10a danube: {failures}")
    return counts


def decoder_paged(report, name):
    """10b / 10c: ``PAGED_DECODERS[name]`` on phase 5's paged chunked
    stream (greedy; every request finished, drained clean, exact launches
    per tick, each request's tokens equal to its prompt's served alone but
    at near ties) and 5c's static mixed batch (exact launches)."""
    from repro_torch import configs
    from repro_torch.launch import serve as launcher
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    spec, counts, failures = PAGED_DECODERS[name], {}, []
    engine = decoder_engine(spec, MAX_LEN)
    cfg = engine.model.cfg
    layers = cfg.num_layers
    setup_s = time.perf_counter() - t0
    flags = list(BASE)
    flags[flags.index("--arch") + 1] = spec["arch"]
    flags[flags.index("--tasks") + 1] = str(spec["tasks"])
    args = launcher.parser().parse_args(flags + ["--requests",
                                                 str(spec["requests"])])
    arrivals = launcher.make_arrivals(args, cfg.vocab_size, spec["tasks"])
    label = f"decoder_{name}_paged"
    d0 = engine.dispatches
    sched, stream_s = counted(label, counts,
                              lambda: launcher.serve(engine, args, arrivals))
    dispatched = engine.dispatches - d0
    if len(sched.finished) != len(arrivals) or sched.drain_check():
        failures.append(f"{len(sched.finished)}/{len(arrivals)} finished, "
                        f"{sched.drain_check()}")
    try:
        check_launches(label, counts[label], {
            "aot_gather_add_multitask": layers * dispatched,
            "ragged_paged_attention": layers * dispatched})
    except AssertionError as e:
        failures.append(str(e))
    equal, ties, bad = stream_vs_alone(engine, sched.finished)
    if bad:
        failures.append(f"stream vs alone: divergences past a near tie "
                        f"{bad}")
    _, _, _, static_tps = decoder_static(engine, f"decoder_{name}_static",
                                         spec["static"], counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    sec = time.perf_counter() - t0
    phase = "10b" if name == "olmo" else "10c"
    full = configs.get(spec["arch"]).num_layers
    log(f"{phase} {name}", arch=spec["arch"], layers=layers,
        cut=f"{layers} of {full} layers" if layers < full else "none",
        tasks=spec["tasks"],
        setup_s=f"{setup_s:.1f}",
        requests=f"{len(sched.finished)}/{len(arrivals)}",
        tokens=sched.tokens_emitted, ticks=sched.ticks,
        dispatched=dispatched,
        tokens_per_s=f"{sched.tokens_emitted / stream_s:.1f}",
        stream_vs_alone=f"{equal}/{len(sched.finished)} equal",
        near_tie_divergences=ties,
        static=f"{spec['static'][0]}x{spec['static'][1]}+"
        f"{spec['static'][2]}", static_tokens_per_s=f"{static_tps:.1f}",
        peak_memory_gib=f"{peak:.2f}", seconds=f"{sec:.1f}",
        launches=counts, failures=failures or "none")
    report["decoders"][name] = dict(
        setup_s=setup_s, tokens_per_s=sched.tokens_emitted / stream_s,
        ticks=sched.ticks, stream_equal=equal, near_ties=ties,
        divergences=bad, static_tokens_per_s=static_tps,
        peak_memory_gib=peak, seconds=sec, launches=counts,
        failures=failures)
    if failures:
        raise AssertionError(f"{phase} {name}: {failures}")
    return counts


def phase_decoders(report):
    """Phase 10 (10a-10c), each part's memory freed before the next;
    returns the launches by path."""
    t0 = time.perf_counter()
    report["decoders"] = {}
    launches = {}
    for part in (lambda: decoder_danube(report),
                 lambda: decoder_paged(report, "olmo"),
                 lambda: decoder_paged(report, "qwen")):
        launches.update(part())
        gc.collect()
        torch.cuda.empty_cache()
    report["decoders"]["seconds"] = time.perf_counter() - t0
    log("10 decoders", seconds=f"{report['decoders']['seconds']:.1f}")
    return launches


# ---------------------------------------------------------------------------
# phase 11: the mixture-of-experts decoders at full width (qwen3-moe-30b-a3b:
# 128 experts top-8, q/k norm, g = 8; llama4-maverick-400b-a17b: MoE on every
# second layer, top-1 with a shared expert)
# ---------------------------------------------------------------------------

# 11a: qwen3-moe cut to 16 of its 48 layers (each layer's weights 1.25 GB,
# each task's table 0.62 GB a layer), 2 tasks; 11b: llama4 cut to one
# interleave unit (a dense layer, then a MoE layer of 16.1 G parameters)
MOE_PARTS = {
    "qwen3moe": dict(arch="qwen3-moe-30b-a3b", layers=16, tasks=2,
                     requests=16, static=(16, 512, 64)),
    "llama4": dict(arch="llama4-maverick-400b-a17b", layers=2, tasks=2,
                   requests=8, static=(4, 512, 32)),
}
MOE_DROPFREE = 128.0        # capacity factor = E: C = T * k, nothing drops
MOE_ROUTING = (4, 256)      # 11a's tokens for AoT's effect on routing
MOE_CHECK_LAYERS = 2        # 11c: qwen3-moe at full width with 2 layers
MOE_CHECK_STATIC = (16, 8, 3)   # 11c's prefill (b, s) and decode steps
# the phase 11 run whose count rides with each kernel's phase 4 times at
# phase 11's shapes (``moe``)
MOE_PATH = {"flash_attention": "moe_qwen3moe_static",
            "decode_attention": "moe_qwen3moe_static",
            "ragged_paged_attention": "moe_qwen3moe_paged",
            "aot_gather_add_multitask": "moe_qwen3moe_paged",
            "paged_decode_attention": "moe_qwen3moe_static_paged"}
MOE_PAGED_STATIC = (4, 512, 16)     # 11a's static batch over a paged pool


def with_capacity(engine, factor):
    """A ServeEngine over ``engine``'s parameters and tables whose model's
    MoE capacity factor is ``factor`` (no copy of either)."""
    import dataclasses
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    model = engine.model
    cfg = model.cfg.replace(moe=dataclasses.replace(
        model.cfg.moe, capacity_factor=factor))
    return ServeEngine(Model(cfg, model.opts, device=DEV), engine.params,
                       ServeConfig(max_len=engine.cfg.max_len),
                       fused_tasks={"table": engine.tables})


def route_drops(routes, n_moe, live, decode_T):
    """A stream's recorded routes (``Model.record_routes``: one record per
    MoE layer per tick, ``n_moe`` per tick) and each tick's live-token
    mask ``live`` (host bools: token_pos >= 0) -> per tick the dropped
    share of its T * k assignments over its MoE layers (``moe_dropped_frac``:
    dead padding included, and the dead tokens, one hidden state, all pick
    the same experts) and of its live tokens' assignments, split into chunk
    ticks and decode-only ticks (T == ``decode_T``)."""
    calls = []
    for c, i in enumerate(range(0, len(routes), n_moe)):
        recs = routes[i:i + n_moe]
        keep = torch.stack([r["keep"] for r in recs]).float()  # (m, T, k)
        mask = torch.as_tensor(live[c], device=keep.device)
        calls.append((recs[0]["tokens"], 1.0 - keep.mean().item(),
                      1.0 - keep[:, mask].mean().item()))
    stat = lambda xs: dict(ticks=len(xs), mean=float(np.mean(xs)) if xs
                           else 0.0, max=max(xs, default=0.0))
    out = {}
    for kind, pick in (("chunk", lambda t: t != decode_T),
                       ("decode", lambda t: t == decode_T)):
        mine = [c for c in calls if pick(c[0])]
        out[kind] = stat([c[1] for c in mine])
        out[kind + "_live"] = stat([c[2] for c in mine])
    return out


def expert_sets(routes):
    """Each record's top-k expert sets, sorted: [(T, k) int64, ...]."""
    return [r["top_e"].sort(-1).values for r in routes]


def routing_effect(model, params, tables, gen):
    """AoT's effect on routing: for MOE_ROUTING's tokens, the share of
    (token, MoE layer) expert sets that differ between the backbone alone
    and each task's table (every row served with that task)."""
    b, s = MOE_ROUTING
    toks = torch.randint(0, model.cfg.vocab_size, (b, s), generator=gen,
                         device=DEV, dtype=torch.int32)
    with torch.no_grad(), model.record_routes() as base:
        model.forward(params, toks)
    base = expert_sets(base)
    share = {}
    for task in range(tables.shape[1]):
        peft = tasks_peft(tables, torch.full((b,), task, dtype=torch.int32,
                                             device=DEV))
        with torch.no_grad(), model.record_routes() as got:
            model.forward(params, toks, peft)
        diff = [(x != y).any(-1) for x, y in zip(base, expert_sets(got))]
        share[f"task{task}"] = torch.cat(diff).float().mean().item()
    return share


# a router near tie: an expert one run chose and the other did not has, in
# the other run, at least (1 - MOE_ROUTE_TIE) of that run's k-th
# probability (the swapped experts' probabilities within 10% of each other)
MOE_ROUTE_TIE = 0.1


def route_sets(recs):
    """One call's records (one per MoE layer) as host arrays: the ranked
    experts (m, T, R) and their probabilities (m, T, R)."""
    return (torch.stack([r["rank_e"] for r in recs]).cpu().numpy(),
            torch.stack([r["rank_p"] for r in recs]).cpu().numpy())


def route_gap(a, b, k) -> float:
    """One token's routes in one layer from two runs, each (ranked
    experts (R,), probabilities (R,)): 0 when their top-k sets are equal;
    else the largest relative shortfall, over the experts one run chose
    and the other did not, of the other run's probability of that expert
    below that run's k-th probability (1.0 for an expert outside the
    other's recorded ranks). A router near tie is a gap of at most
    MOE_ROUTE_TIE."""
    gap = 0.0
    for (ea, _), (eb, pb) in ((a, b), (b, a)):
        kth = float(pb[k - 1])
        prob = {int(e): float(p) for e, p in zip(eb, pb)}
        for e in set(ea[:k].tolist()) - set(eb[:k].tolist()):
            gap = max(gap, 1.0 - prob.get(int(e), 0.0) / kth)
    return gap


def moe_stream(engine, name, spec, label, counts, failures):
    """Phase 5's paged chunked stream (``spec["requests"]`` requests) on
    ``engine`` through the launcher's code, greedy, its routes recorded:
    every request finished, drained clean, each kernel exactly once per
    layer per tick. Returns (scheduler, seconds, the drops by tick kind,
    each request's routes {rid: {position: (ranked experts (m, R), their
    probabilities (m, R))}})."""
    from repro_torch.launch import serve as launcher
    cfg = engine.model.cfg
    layers, n_moe = cfg.num_layers, sum(cfg.moe_layer_mask())
    flags = list(BASE)
    flags[flags.index("--arch") + 1] = spec["arch"]
    flags[flags.index("--tasks") + 1] = str(spec["tasks"])
    args = launcher.parser().parse_args(flags + ["--requests",
                                                 str(spec["requests"])])
    arrivals = launcher.make_arrivals(args, cfg.vocab_size, spec["tasks"])
    sched = launcher.make_scheduler(engine, args)
    d0, live, owners, step = engine.dispatches, [], [], engine.serve_step

    def tapped(tokens, token_rows, token_pos, *rest):
        # each packed token's request at dispatch: decode rows and prefills
        owner = {slot: r.rid for slot, r in sched.running.items()}
        owner.update({pf.slot: pf.req.rid for pf in sched._prefills})
        live.append(np.asarray(token_pos) >= 0)
        owners.append([(owner[int(r)], int(p)) if p >= 0 else None
                       for r, p in zip(token_rows, token_pos)])
        return step(tokens, token_rows, token_pos, *rest)
    engine.serve_step = tapped
    try:
        with engine.model.record_routes() as routes:
            sched, sec = counted(label, counts, lambda: launcher.
                                 run_with_retries(
                                     sched, arrivals,
                                     grace_ticks=args.grace_ticks,
                                     max_retries=args.max_retries,
                                     backoff=args.backoff)[3])
    finally:
        del engine.serve_step
    dispatched = engine.dispatches - d0
    if len(sched.finished) != len(arrivals) or sched.drain_check():
        failures.append(f"{label}: {len(sched.finished)}/{len(arrivals)} "
                        f"finished, {sched.drain_check()}")
    try:
        check_launches(label, counts[label], {
            "aot_gather_add_multitask": layers * dispatched,
            "ragged_paged_attention": layers * dispatched})
    except AssertionError as e:
        failures.append(str(e))
    if len(routes) != n_moe * dispatched:
        failures.append(f"{label}: {len(routes)} MoE calls recorded, "
                        f"{n_moe * dispatched} expected")
    drops = route_drops(routes, n_moe, live, SLOTS)
    per_req = {}
    for c, own in enumerate(owners):       # later ticks overwrite (a retry)
        ranked, probs = route_sets(routes[c * n_moe:(c + 1) * n_moe])
        for t, o in enumerate(own):
            if o is not None:
                per_req.setdefault(o[0], {})[o[1]] = (ranked[:, t],
                                                      probs[:, t])
    del routes
    if drops["decode"]["max"] != 0.0:      # T <= 8 <= C: nothing can drop
        failures.append(f"{label}: a decode-only tick dropped {drops}")
    return sched, sec, drops, per_req


def moe_vs_alone(engine, finished, stream_routes):
    """:func:`stream_vs_alone` for a MoE model, its routes compared too:
    each finished request's tokens against its prompt served alone
    (prefill, then greedy decode steps, routes recorded). A divergence is
    a logit near tie (:func:`divergence`'s rule), or a router near tie:
    some position before the diverging token routed differently in some
    layer, and at the first such (position, layer) the swapped experts'
    probabilities are within MOE_ROUTE_TIE (:func:`route_gap`; one
    flipped expert reroutes the token and everything after it reads it).
    Returns (requests equal, [(rid, index, gap)] logit near ties, [(rid,
    index, position, layer, route gap)] router near ties, [(rid, index,
    gap, why)] divergences neither explains)."""
    model, params = engine.model, engine.params
    n_moe, k = sum(model.cfg.moe_layer_mask()), model.cfg.moe.top_k
    equal, ties, route_ties, bad = 0, [], [], []
    for rid, req in sorted(finished.items()):
        toks = torch.as_tensor(np.asarray(req.prompt)[None],
                               dtype=torch.int32, device=DEV)
        peft = engine._peft(torch.full((1,), req.task_id, dtype=torch.int32,
                                       device=DEV))
        with model.record_routes() as routes:
            logits, cache, pos = model.prefill(params, toks, peft,
                                               max_len=engine.cache_len)
            lgs, alone = greedy_decode(model, params, logits, cache, pos,
                                       peft, len(req.out))
        del cache
        d = divergence([int(t) for t in req.out], alone[0].tolist(),
                       lgs[:, 0])
        if d is None:
            equal += 1
            continue
        if d[2]:
            ties.append((rid, d[0], round(d[1], 5)))
            continue
        # the alone run's routes by position: the prefill's, then a step's
        alone_at = {}
        for c in range(len(routes) // n_moe):
            re_, rp = route_sets(routes[c * n_moe:(c + 1) * n_moe])
            base = 0 if c == 0 else len(req.prompt) + c - 1
            for t in range(re_.shape[1]):
                alone_at[base + t] = (re_[:, t], rp[:, t])
        del routes
        mine = stream_routes.get(rid, {})
        # the token at out[j] reads positions < len(prompt) + j
        first, why = None, "no routing difference before it"
        for p in range(len(req.prompt) + d[0]):
            if p not in mine or p not in alone_at:
                continue
            (ea, pa), (eb, pb) = mine[p], alone_at[p]
            gaps = [route_gap((ea[m], pa[m]), (eb[m], pb[m]), k)
                    for m in range(n_moe)]
            layer = next((m for m, g in enumerate(gaps) if g > 0), None)
            if layer is not None:
                first = (p, layer, round(gaps[layer], 4))
                if gaps[layer] > MOE_ROUTE_TIE:
                    why = (f"position {p} layer {layer}: route gap "
                           f"{gaps[layer]:.4f}")
                    first = None
                break
        if first is None:
            bad.append((rid, d[0], round(d[1], 5), why))
        else:
            route_ties.append((rid, d[0]) + first)
    return equal, ties, route_ties, bad


def moe_part(report, name):
    """11a / 11b: ``MOE_PARTS[name]`` at full width, bf16, random weights
    (seed 0) and fabricated tables, at the config's capacity factor 1.25:
    phase 5's paged chunked stream (gated: finished, drained, exact
    launches, no decode-only tick drops; reported: tokens/s, the dropped
    share per chunk tick and per decode tick, requests equal to their
    prompt served alone) and 5c's static mixed batch (exact launches;
    tokens/s and the prefill's dropped share). qwen3-moe also runs the
    stream drop-free (capacity factor MOE_DROPFREE: each request's tokens
    equal to its prompt served alone but at near ties, gated) and reports
    AoT's effect on routing."""
    from repro_torch import configs
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    spec, counts, failures = MOE_PARTS[name], {}, []
    engine = decoder_engine(spec, MAX_LEN)
    model, cfg = engine.model, engine.model.cfg
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    res = dict(setup_s=setup_s, layers=cfg.num_layers,
               moe_layers=sum(cfg.moe_layer_mask()),
               capacity_factor=cfg.moe.capacity_factor)
    label = f"moe_{name}_paged"
    sched, sec, drops, sroutes = moe_stream(engine, name, spec, label,
                                            counts, failures)
    equal, ties, rties, bad = moe_vs_alone(engine, sched.finished, sroutes)
    res.update(tokens_per_s=sched.tokens_emitted / sec, ticks=sched.ticks,
               drops=drops, stream_equal=equal, near_ties=ties,
               router_ties=rties, divergences=bad,
               requests=len(sched.finished))
    del sched, sroutes
    if name == "qwen3moe":
        free = with_capacity(engine, MOE_DROPFREE)
        flabel = f"moe_{name}_paged_dropfree"
        sched, fsec, fdrops, sroutes = moe_stream(free, name, spec, flabel,
                                                  counts, failures)
        fequal, fties, frties, fbad = moe_vs_alone(free, sched.finished,
                                                   sroutes)
        if fbad or fdrops["chunk"]["max"] != 0.0:
            failures.append(f"{flabel}: divergences neither tie explains "
                            f"{fbad}, drops {fdrops}")
        res["dropfree"] = dict(tokens_per_s=sched.tokens_emitted / fsec,
                               drops=fdrops, stream_equal=fequal,
                               near_ties=fties, router_ties=frties,
                               divergences=fbad)
        del sched, free
        gc.collect()
        res["aot_routing_differs"] = routing_effect(
            model, engine.params, engine.tables,
            torch.Generator(device=DEV).manual_seed(11))
    with model.record_routes() as routes:
        prompts, task_ids, _, static_tps = decoder_static(
            engine, f"moe_{name}_static", spec["static"], counts)
    if name == "qwen3moe":          # the static batch over a paged pool
        pb, ps, psteps = MOE_PAGED_STATIC
        plabel = f"moe_{name}_static_paged"
        _, psec = counted(plabel, counts, lambda: paged_generate(
            engine, prompts[:pb, :ps], psteps, task_ids[:pb]))
        try:
            check_launches(plabel, counts[plabel], {
                "flash_attention": cfg.num_layers,
                "paged_decode_attention": cfg.num_layers * psteps,
                "aot_gather_add_multitask": cfg.num_layers * (1 + psteps)})
        except AssertionError as e:
            failures.append(str(e))
        res["static_paged_tokens_per_s"] = pb * psteps / psec
    b, s, _ = spec["static"]
    pre = [r for r in routes if r["tokens"] == b * s]    # the prefill's
    res["static_tokens_per_s"] = static_tps
    res["static_prefill_dropped"] = 1.0 - torch.stack(
        [r["keep"].float().mean() for r in pre]).mean().item()
    del routes, pre
    res["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    res["seconds"] = time.perf_counter() - t0
    res["launches"], res["failures"] = counts, failures
    full = configs.get(spec["arch"]).num_layers
    phase = "11a" if name == "qwen3moe" else "11b"
    fmt_drops = lambda d: (
        f"chunk mean {d['chunk']['mean']:.4f} max {d['chunk']['max']:.4f} "
        f"live mean {d['chunk_live']['mean']:.4f} max "
        f"{d['chunk_live']['max']:.4f} ({d['chunk']['ticks']} ticks), "
        f"decode max {d['decode']['max']:.4f} ({d['decode']['ticks']} "
        "ticks)")
    extra = {}
    if "dropfree" in res:
        f = res["dropfree"]
        extra = dict(static_paged=f"{MOE_PAGED_STATIC[0]}x"
                     f"{MOE_PAGED_STATIC[1]}+{MOE_PAGED_STATIC[2]}: "
                     f"{res['static_paged_tokens_per_s']:.1f} tokens/s",
                     dropfree_tokens_per_s=f"{f['tokens_per_s']:.1f}",
                     dropfree_vs_alone=f"{f['stream_equal']}/"
                     f"{res['requests']} equal, {len(f['near_ties'])} "
                     f"logit near ties, {len(f['router_ties'])} router "
                     f"near ties, {len(f['divergences'])} neither",
                     dropfree_router_ties=f["router_ties"],
                     aot_routing_differs={k: round(v, 4) for k, v in
                                          res["aot_routing_differs"].items()})
    log(f"{phase} {name}", arch=spec["arch"], layers=cfg.num_layers,
        cut=f"{cfg.num_layers} of {full} layers", tasks=spec["tasks"],
        setup_s=f"{setup_s:.1f}",
        requests=f"{res['requests']}/{spec['requests']}",
        tokens_per_s=f"{res['tokens_per_s']:.1f}", ticks=res["ticks"],
        dropped=fmt_drops(drops),
        stream_vs_alone=f"{equal}/{res['requests']} equal, {len(ties)} "
        f"logit near ties, {len(rties)} router near ties, {len(bad)} "
        "neither (reported: drops differ)",
        static=f"{spec['static'][0]}x{spec['static'][1]}+"
        f"{spec['static'][2]}", static_tokens_per_s=f"{static_tps:.1f}",
        static_prefill_dropped=f"{res['static_prefill_dropped']:.4f}",
        **extra, peak_memory_gib=f"{res['peak_memory_gib']:.2f}",
        seconds=f"{res['seconds']:.1f}", launches=counts,
        failures=failures or "none")
    report["moe"][name] = res
    if failures:
        raise AssertionError(f"{phase} {name}: {failures}")
    return counts


def routes_agree(routes_k, routes_p, n_moe):
    """Per call and MoE layer, the tokens whose expert sets or kept
    assignments differ between the kernel run's routes and the plain
    run's (a flip elsewhere can move a token's bucket position past the
    capacity): [(T,) bool per record]; the count of differing tokens per
    layer (summed over calls); and the set flips whose :func:`route_gap`
    exceeds MOE_ROUTE_TIE as (record, token, gap)."""
    diff, not_ties = [], []
    for i, (a, b) in enumerate(zip(routes_k, routes_p)):
        sa, sb = (r["top_e"].sort(-1).values for r in (a, b))
        flip = (sa != sb).any(-1)
        diff.append(flip | (a["keep"] != b["keep"]).any(-1))
        k = sa.shape[-1]
        for t in flip.nonzero()[:, 0].tolist():
            gap = route_gap(*(((r["rank_e"][t].cpu(), r["rank_p"][t].cpu())
                               for r in (a, b))), k)
            if gap > MOE_ROUTE_TIE:
                not_ties.append((i, t, round(gap, 4)))
    per_layer = [sum(int(diff[c * n_moe + m].sum())
                     for c in range(len(diff) // n_moe))
                 for m in range(n_moe)]
    return diff, per_layer, not_ties


def moe_padding(model, params, gen, factor):
    """ROADMAP C9 on the card, one MoE layer of ``model`` (layer 0): 40
    live rows alone, then after 24 rows of one padding vector, at the
    config's capacity ``factor`` and drop-free (MOE_DROPFREE). Drop-free,
    the live rows' outputs must equal those alone within 2e-2 of the
    largest |output| (gated; their routes are the same bits); at
    ``factor``, the live assignments the padding displaces are
    reported."""
    import dataclasses
    from repro_torch.models import moe
    cfg, dt = model.cfg, model.opts.compute_dtype
    p = params["layers"][0]["moe"]
    live = torch.randn(40, cfg.d_model, generator=gen, device=DEV).to(dt)
    pad = torch.randn(1, cfg.d_model, generator=gen, device=DEV).to(dt)
    x = torch.cat([pad.expand(24, -1), live])
    out = {}
    for label, factor in (("config", factor), ("dropfree", MOE_DROPFREE)):
        c = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                capacity_factor=factor))
        routes = []
        alone, _ = moe.apply_moe(c, p, live, dt, record=routes)
        after, _ = moe.apply_moe(c, p, x, dt, record=routes)
        err = (after[24:].float() - alone.float()).abs().max().item()
        scale = alone.float().abs().max().item()
        displaced = int((~routes[1]["keep"][24:]).sum()) - int(
            (~routes[0]["keep"]).sum())
        out[label] = dict(max_abs_err=err, scale=scale, displaced=displaced)
    out["ok"] = out["dropfree"]["max_abs_err"] <= 2e-2 * max(
        1.0, out["dropfree"]["scale"])
    return out


def judge_moe(lg, routes, row_of, n_moe):
    """11c's verdict on one check: ``lg`` and ``routes`` of the kernels'
    bf16 run ("k"), the plain versions' ("p") and float32 plain PyTorch's
    ("f32"), logits (rows, ..., V) float32; ``row_of(record)`` maps a
    record's tokens to logit rows (-1: none). A row is gated when each of
    its tokens routed alike (sets and kept assignments) in all three runs;
    every k / p flip must be a router near tie (:func:`route_gap`). On the
    gated rows, the kernels' error against float32 must be within
    BF16_FACTOR times the plain versions' (7c's rule: the kernels lose no
    more than plain bf16 PyTorch does), and the kernels against the plain
    versions at LOGIT_TOL is reported."""
    diff_kp, per_layer, not_ties = routes_agree(routes["k"], routes["p"],
                                                n_moe)
    diff_k32 = routes_agree(routes["k"], routes["f32"], n_moe)[0]
    n = lg["k"].shape[0]
    bad = torch.zeros(n + 1, dtype=torch.bool, device=DEV)
    for rec, d1, d2 in zip(routes["k"], diff_kp, diff_k32):
        rows = row_of(rec)
        bad[rows[d1 | d2].clamp(min=-1)] = True      # row -1 lands at n
    keep = (~bad[:n]).nonzero()[:, 0]
    g = {key: x[keep] for key, x in lg.items()}
    res = dict(routing_differs_per_layer=per_layer, not_ties=not_ties,
               rows_gated=f"{len(keep)}/{n}", rows=len(keep))
    if len(keep):
        e_k = (g["k"] - g["f32"]).abs().max().item()
        e_p = (g["p"] - g["f32"]).abs().max().item()
        res.update(vs_plain=against_plain(g["k"], g["p"]), err_k_f32=e_k,
                   err_p_f32=e_p, ok=not not_ties and e_k <= BF16_FACTOR
                   * e_p)
    else:
        res.update(ok=not not_ties)
    return res


def moe_cross_check(report):
    """11c: qwen3-moe at full width with MOE_CHECK_LAYERS layers (phase 6's
    generator), drop-free (capacity factor MOE_DROPFREE: at the config's
    1.25 one flipped route moves later tokens' bucket positions past the
    capacity, C9, and no logit row would be left to compare; the capacity
    is held by :func:`moe_padding` instead): one mixed tick (phase 6's
    packing) and a whole-prompt prefill (MOE_CHECK_STATIC) plus three
    decode steps, each through the kernels, through the plain versions in
    the same packing and through float32 plain PyTorch, the latter two fed
    the kernels' tokens; :func:`judge_moe` gates the rows that routed
    alike in all three, and every flip between the kernels and the plain
    versions must be a near tie of the router. (LOGIT_TOL between the
    kernels and the plain versions, phase 6's rule, is reported: the
    experts' weights, std 1/sqrt(E) (C10), carry bf16's rounding into the
    logits at 4e-2 in two layers.)"""
    import dataclasses
    from repro_torch import configs
    from repro_torch.core import aot as aot_mod
    from repro_torch.models import model as model_mod
    gen = torch.Generator(device=DEV).manual_seed(PHASE6_SEED)
    dt, f32 = torch.bfloat16, torch.float32
    base = configs.get(MOE_PARTS["qwen3moe"]["arch"]).replace(
        num_layers=MOE_CHECK_LAYERS)
    cfg = base.replace(moe=dataclasses.replace(base.moe,
                                               capacity_factor=MOE_DROPFREE))
    n_moe = sum(cfg.moe_layer_mask())
    model = model_mod.Model(cfg, model_mod.ModelOptions(dt, dt), device=DEV)
    params = model.init(1)
    tables = aot_mod.stack_tasks([aot_mod.random_fused(
        cfg, params["embed"]["tok"], seed=t, scale=0.03, vocab_chunk=4096,
        dtype=dt) for t in range(2)])["table"]
    runs = {"k": (model, params, tables),
            "f32": (model_mod.Model(cfg, model_mod.ModelOptions(f32, f32),
                                    device=DEV), cast_backbone(params, f32),
                    tables.float())}
    runs["p"] = runs["k"]
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=DEV)
    # ---- one mixed tick
    rows, pos = packings()["chunks_decode_dead"]
    T = len(rows)
    cache0 = model.init_paged_cache(NUM_BLOCKS, BS)
    for n in ("k", "v"):
        cache0[n].normal_(generator=gen)
    perm = torch.randperm(NUM_BLOCKS - 1, generator=gen, device=DEV) + 1
    bt = perm.view(SLOTS, NPAGES).to(torch.int32)
    tokens = torch.randint(0, cfg.vocab_size, (T, 1), generator=gen,
                           device=DEV, dtype=torch.int32)
    lidx = [0] * SLOTS
    for t, (r, p) in enumerate(zip(rows, pos)):
        if p >= 0:
            lidx[r] = t
    live = sorted({r for r, p in zip(rows, pos) if p >= 0})
    task_of = i32([r % 2 for r in rows])
    # each token's logit row: its slot's place among the live slots
    tick_row = i32([live.index(r) if p >= 0 else -1
                    for r, p in zip(rows, pos)]).long()

    def tick(key):
        m, prm, tbl = runs[key]
        cache = {n: c.clone().to(m.opts.compute_dtype)
                 for n, c in cache0.items()}
        with m.record_routes() as routes:
            logits, _ = m.mixed_step(prm, tokens, i32(rows), i32(pos), cache,
                                     tasks_peft(tbl, task_of),
                                     block_tables=bt, logit_idx=i32(lidx))
        torch.cuda.synchronize()
        return logits[live].float(), routes
    # ---- a whole-prompt prefill plus three decode steps
    b, s, steps = MOE_CHECK_STATIC
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                         device=DEV, dtype=torch.int32)
    stask = torch.arange(b, dtype=torch.int32, device=DEV) % 2

    def static(key, forced=None):
        m, prm, tbl = runs[key]
        peft = tasks_peft(tbl, stask)
        with m.record_routes() as routes:
            logits, cache, p0 = m.prefill(prm, toks, peft, max_len=MAX_LEN)
            lgs, tk = greedy_decode(m, prm, logits, cache, p0, peft, steps,
                                    forced=forced)
        return lgs.transpose(0, 1), tk, routes     # rows first
    static_row = lambda rec: (torch.arange(rec["tokens"], device=DEV)
                              // (s if rec["tokens"] == b * s else 1))
    lg_t, rt_t, lg_s, rt_s = {}, {}, {}, {}
    lg_t["k"], rt_t["k"] = tick("k")
    lg_s["k"], tok_k, rt_s["k"] = static("k")
    with plain_ops():
        for key in ("p", "f32"):
            lg_t[key], rt_t[key] = tick(key)
            lg_s[key], _, rt_s[key] = static(key, forced=tok_k)
    tick_res = judge_moe(lg_t, rt_t, lambda rec: tick_row, n_moe)
    static_res = judge_moe(lg_s, rt_s, static_row, n_moe)
    del runs, lg_t, lg_s, rt_t, rt_s
    pad = moe_padding(model, params, gen, base.moe.capacity_factor)
    ok = tick_res["ok"] and static_res["ok"] and pad["ok"] and (
        tick_res["rows"] + static_res["rows"] > 0)
    fmt = lambda r: (f"rows {r['rows_gated']}, routing differs per layer "
                     f"{r['routing_differs_per_layer']}, flips not router "
                     f"ties {len(r['not_ties'])}" + (
                         f", vs float32 {r['err_k_f32']:.3e} (plain bf16 "
                         f"{r['err_p_f32']:.3e}), vs plain "
                         f"{verdict(r['vs_plain'])} (LOGIT_TOL "
                         f"{'held' if r['vs_plain']['ok'] else 'missed'})"
                         if r["rows"] else ""))
    log("11c moe cross-check", layers=MOE_CHECK_LAYERS, T=T,
        tick=fmt(tick_res), static=f"b{b} s{s}+{steps}: " + fmt(static_res),
        padding_first=f"dropfree {pad['dropfree']['max_abs_err']:.3e} of "
        f"{pad['dropfree']['scale']:.3e}, displaced at factor "
        f"{base.moe.capacity_factor}: {pad['config']['displaced']}",
        result="ok" if ok else "FAIL")
    report["moe"]["cross_check"] = dict(tick=tick_res, static=static_res,
                                        padding=pad)
    if not ok:
        raise AssertionError(f"11c: {report['moe']['cross_check']}")


def phase_moe(report):
    """Phase 11 (11a-11c), each part's memory freed before the next;
    returns the launches by path."""
    t0 = time.perf_counter()
    report["moe"] = {}
    launches = {}
    for part in (lambda: moe_part(report, "qwen3moe"),
                 lambda: moe_part(report, "llama4"),
                 lambda: moe_cross_check(report)):
        launches.update(part() or {})
        gc.collect()
        torch.cuda.empty_cache()
    report["moe"]["seconds"] = time.perf_counter() - t0
    log("11 moe", seconds=f"{report['moe']['seconds']:.1f}")
    return launches


# ---------------------------------------------------------------------------
# phase 12: the recurrent backbones at full width (recurrentgemma-9b: RG-LRU
# blocks and local MQA attention at hd 256, g 16, over a 2048-row ring;
# xlstm-350m: mLSTM / sLSTM), served as static batches
# ---------------------------------------------------------------------------

# 12a: recurrentgemma cut to 8 of its 38 layers, two (rglru, rglru, attn)
# units and the (rglru, rglru) remainder, so that both groups run (each
# task's bf16 table at 8 layers is 16.8 GB), 2 tasks; the ring wrap checked
# on one unit (3 layers); 12b: xlstm cut to two 7:1 units (16 of 24
# blocks, 2 of its 3 sLSTM: the whole run near 900 s), 4 tasks
RGEMMA = dict(arch="recurrentgemma-9b", layers=8, tasks=2,
              static=(RING_ROWS, 3072, 32))
RGEMMA_UNIT = dict(arch="recurrentgemma-9b", layers=3, tasks=2,
                   cut=dict(pattern_remainder=()), wrap=(2040, 16))
XLSTM = dict(arch="xlstm-350m", layers=16, tasks=4, static=(16, 512, 64))
# the phase 12 run whose count rides with each kernel's phase 4 times at
# phase 12's shapes (``recurrent``)
REC_PATH = {"flash_attention": "rec_rgemma_static",
            "decode_attention": "rec_rgemma_static",
            "aot_gather_add_multitask": "rec_rgemma_static"}


def attention_layers(cfg) -> int:
    return sum(k == "attn" for k in cfg.layer_kinds)


def rec_launches(cfg, steps):
    """A static batch's launches on a recurrent stack: a flash per
    attention layer for the prefill and a decode per attention layer and
    step; a gather-add per layer for the prefill and each step (fused with
    RMSNorm, or plain under LayerNorm)."""
    n_attn = attention_layers(cfg)
    return {"flash_attention": n_attn, "decode_attention": n_attn * steps,
            "aot_gather_add_multitask": cfg.num_layers * (1 + steps)}


@contextlib.contextmanager
def block_host_ms():
    """Host milliseconds spent inside each recurrent block kind's plain
    PyTorch (the enqueue of its eager launches; nothing waits on the
    card), summed while open: {"rglru" | "mlstm" | "slstm": ms}."""
    from repro_torch.models import recurrent as rec_mod
    from repro_torch.models import xlstm as xl_mod
    spent = {}
    saved = [(rec_mod, "apply_rglru", "rglru"),
             (xl_mod, "apply_mlstm_block", "mlstm"),
             (xl_mod, "apply_slstm_block", "slstm")]
    originals = [getattr(m, n) for m, n, _ in saved]

    def timed_fn(fn, kind):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[kind] = spent.get(kind, 0.0) + (
                    time.perf_counter() - t0) * 1e3
        return run
    for (m, n, kind), fn in zip(saved, originals):
        setattr(m, n, timed_fn(fn, kind))
    try:
        yield spent
    finally:
        for (m, n, _), fn in zip(saved, originals):
            setattr(m, n, fn)


def rec_step_times(model, params, logits, cache, pos, peft, steps=8):
    """Greedy decode steps from a prefill's ``logits`` and ``cache``: per
    step the host ms to enqueue it (no wait), the wall ms (each step
    waited for), the device busy ms from a profiled run, kernels per step,
    and the host ms inside each recurrent block kind (``block_host_ms``)
    with its share of the steps' host time. Each step is followed by a
    device wait here, so that a step's host time is its own."""
    b = logits.shape[0]
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    host, wall = [], []
    with block_host_ms() as spent:
        for i in range(steps):
            t0 = time.perf_counter()
            lg, cache = model.decode_step(params, tok, pos + i, cache, peft)
            host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
    prof = profile_of(lambda: [model.decode_step(
        params, tok, pos + steps + i, cache, peft) for i in range(steps)],
        steps)
    total = sum(host)
    return dict(host_ms=median(host), wall_ms=median(wall),
                device_busy_ms=prof["device_busy_ms"] / steps,
                kernels_per_step=prof["kernels_per_step"],
                block_host_ms={k: v / steps for k, v in spent.items()},
                block_host_share={k: v / total for k, v in spent.items()},
                batch=b)


def rec_mixed_vs_per_task(model, params, tables, prompts, task_ids, steps,
                          mixed, tie=None):
    """Each task's rows of the static batch served as a batch of their own
    (``Model.prefill`` then greedy decode steps, logits kept) against the
    mixed batch's tokens ``mixed``: (rows equal, [(row, index, gap)] near
    ties, [(row, index, gap)] divergences that are not), and whether every
    recurrent state read back from the caches is finite. A near tie is
    phase 6's (``divergence``), or with ``tie`` a gap of at most ``tie``
    (12b: two bf16 orders of xLSTM part by about its bf16 error)."""
    from repro_torch import tree as T
    equal, ties, bad, finite = 0, [], [], True
    for t in sorted(set(task_ids.tolist())):
        rows = np.flatnonzero(task_ids == t)
        toks = torch.as_tensor(prompts[rows], dtype=torch.int32, device=DEV)
        peft = tasks_peft(tables, torch.full((len(rows),), t,
                                             dtype=torch.int32, device=DEV))
        logits, cache, pos = model.prefill(params, toks, peft,
                                           max_len=prompts.shape[1] + steps)
        lgs, alone = greedy_decode(model, params, logits, cache, pos, peft,
                                   steps)
        finite = finite and all(
            bool(torch.isfinite(x).all()) for lc, kind in
            zip(cache["layers"], model.kinds) if kind != "attn"
            for x in T.leaves(lc))
        del cache
        for j, r in enumerate(rows):
            d = divergence([int(x) for x in mixed[r]], alone[j].tolist(),
                           lgs[:, j])
            if d is None:
                equal += 1
            else:
                near = d[2] or (tie is not None and d[1] <= tie)
                (ties if near else bad).append((int(r), d[0], round(d[1], 5)))
    return equal, ties, bad, finite


def rec_against_logits(model, params, tables, seq, s, lg_dec, task_ids,
                       carry_vs_plain=False):
    """7c's float32 rule on decode logits ``lg_dec`` (steps + 1, b, V) of
    the prompts in ``seq`` (b, s + steps) served with ``task_ids``: per
    task, against ``Model.logits`` of the same tokens in float32 plain
    PyTorch (``attn_impl="ref"``), within BF16_FACTOR times the same
    logits in plain bf16 PyTorch, and carrying the task's effect (less the
    float32 backbone's logits) within CARRY_TOL; with ``carry_vs_plain``
    (12b) within CARRY_TOL of the share that plain bf16 carries (xLSTM in
    bf16 carries about 0.69 of it in the plain versions as in the
    kernels: PERF.md section 6). The comparison with the kernels'
    bf16 whole pass is reported (``vs_whole``)."""
    from repro_torch.models.model import Model, ModelOptions
    cfg, f32, bf = model.cfg, torch.float32, torch.bfloat16
    lg_whole = whole_logits(model, params, seq, tasks_peft(
        tables, torch.as_tensor(task_ids, device=DEV)), s)
    plain16 = Model(cfg, ModelOptions(bf, bf, attn_impl="ref"), device=DEV)
    lg_p16 = whole_logits(plain16, params, seq, tasks_peft(
        tables, torch.as_tensor(task_ids, device=DEV)), s)
    m32 = Model(cfg, ModelOptions(f32, f32, attn_impl="ref"), device=DEV)
    p32 = cast_backbone(params, f32)
    ref32 = torch.empty_like(lg_dec)
    base32 = torch.empty_like(lg_dec)
    for t in sorted(set(task_ids.tolist())):
        rows = torch.as_tensor(np.flatnonzero(task_ids == t), device=DEV)
        one = tasks_peft(tables[:, t:t + 1].float(), torch.zeros(
            len(rows), dtype=torch.int32, device=DEV))
        ref32[:, rows] = whole_logits(m32, p32, seq[rows], one, s)
        base32[:, rows] = whole_logits(m32, p32, seq[rows], None, s)
        del one
    del p32
    flat = lambda x: x.reshape(-1, x.shape[-1])
    ids = [int(t) for t in task_ids] * lg_dec.shape[0]
    res = against_float32(flat(lg_dec), flat(lg_p16), flat(ref32),
                          flat(base32), ids)
    if carry_vs_plain:
        for r in res["tasks"].values():
            r["ok"] = (r["served_err"] <= BF16_FACTOR * r["plain_err"]
                       and abs(r["carried"] - r["carried_plain"])
                       <= CARRY_TOL)
        res["ok"] = all(r["ok"] for r in res["tasks"].values())
    res["vs_whole"] = against_plain(lg_dec, lg_whole)
    return res


def rec_rgemma(report):
    """12a: recurrentgemma-9b at full width, 8 layers (both groups of its
    plan), 2 tasks. The static mixed batch (4 x 3072 + 32: prompts past
    the window, so the ring wraps in the prefill) through
    ``ServeEngine.generate``: exact launches, the tokens against each
    task's rows served alone (equal, or a first difference at a near tie),
    every recurrent state finite; per decode step host, wall and device
    time and the host share of the RG-LRU blocks. Then one unit (rglru,
    rglru, attn): 2 prompts of 2040, one per task, and 16 decode steps (the
    ring wraps while decoding), each step's logits held to ``Model.logits``
    by 7c's float32 rule; and one AoT decode step's exact launches (flash
    0, decode 2 at g 16 and hd 256, the fused gather-add 8 on the 8-layer
    stack)."""
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    spec, counts, failures = RGEMMA, {}, []
    engine = decoder_engine(spec, spec["static"][1] + spec["static"][2])
    model, params, cfg = engine.model, engine.params, engine.model.cfg
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    b, s, steps = spec["static"]
    rng = np.random.default_rng(12)
    prompts = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    task_ids = (np.arange(b) % spec["tasks"]).astype(np.int32)
    engine.generate(prompts[:1, :64], 2, task_ids[:1])          # warm-up
    label = "rec_rgemma_static"
    out, sec = counted(label, counts,
                       lambda: engine.generate(prompts, steps, task_ids))
    try:
        check_launches(label, counts[label], rec_launches(cfg, steps))
    except AssertionError as e:
        failures.append(str(e))
    equal, ties, bad, finite = rec_mixed_vs_per_task(
        model, params, engine.tables, prompts, task_ids, steps, out)
    if bad or not finite:
        failures.append(f"mixed vs per task: divergences past a near tie "
                        f"{bad}, states finite {finite}")
    peft = engine._peft(torch.as_tensor(task_ids, device=DEV))
    logits, cache, pos = model.prefill(
        params, torch.as_tensor(prompts, device=DEV), peft,
        max_len=engine.cache_len)
    ring = model.cache_rows(cache)
    if ring != RGEMMA_WINDOW:
        failures.append(f"ring of {ring} rows, not {RGEMMA_WINDOW}")
    ops.reset_launches()
    model.decode_step(params, logits[:, -1].argmax(-1).to(torch.int32)[
        :, None], pos, cache, peft)
    step_launches = {k: v for k, v in ops.launches().items() if v}
    want = {"decode_attention": attention_layers(cfg),
            "aot_gather_add_multitask": cfg.num_layers}
    if step_launches != want:
        failures.append(f"one AoT decode step launched {step_launches}, "
                        f"expected {want}")
    times = rec_step_times(model, params, logits, cache, pos + 1, peft)
    del cache, logits, engine, model, params, peft
    gc.collect()
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # ---- one unit: the ring wraps while decoding
    torch.cuda.reset_peak_memory_stats()
    unit = decoder_engine(RGEMMA_UNIT, 4096)
    umodel, uparams = unit.model, unit.params
    (ws, wsteps), ub = RGEMMA_UNIT["wrap"], RGEMMA_UNIT["tasks"]
    wprompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (ub, ws)),
                               dtype=torch.int32, device=DEV)
    wtasks = np.arange(ub, dtype=np.int32)
    upeft = unit._peft(torch.as_tensor(wtasks, device=DEV))
    logits, cache, upos = umodel.prefill(uparams, wprompts, upeft,
                                         max_len=ws + wsteps + 64)
    urows = umodel.cache_rows(cache)
    lg_dec, wtoks = greedy_decode(umodel, uparams, logits, cache, upos,
                                  upeft, wsteps)
    del cache, logits
    seq = torch.cat([wprompts, wtoks], 1)
    gate = rec_against_logits(umodel, uparams, unit.tables, seq, ws, lg_dec,
                              wtasks)
    if urows != RGEMMA_WINDOW or not gate["ok"]:
        failures.append(f"unit: ring {urows} rows; decode vs Model.logits "
                        f"{gate}")
    upeak = torch.cuda.max_memory_allocated() / 2 ** 30
    del unit, umodel, uparams, lg_dec
    sec_all = time.perf_counter() - t0
    log("12a rgemma", layers=cfg.num_layers, kinds="".join(
        k[0] for k in cfg.layer_kinds), ring_rows=ring,
        setup_s=f"{setup_s:.1f}", static=f"{b}x{s}+{steps}",
        static_tokens_per_s=f"{b * steps / sec:.1f}",
        mixed_vs_per_task=f"{equal}/{b} equal", near_ties=ties,
        states_finite=finite, step_launches=step_launches,
        step_host_ms=f"{times['host_ms']:.2f}",
        step_wall_ms=f"{times['wall_ms']:.2f}",
        step_device_ms=f"{times['device_busy_ms']:.2f}",
        rglru_host_share={k: round(v, 3) for k, v in
                          times["block_host_share"].items()},
        peak_memory_gib=f"{peak:.2f}",
        unit_wrap=f"{ws}+{wsteps} over {urows} rows",
        unit_vs_float32=f32_text(gate),
        unit_vs_whole=verdict(gate["vs_whole"]),
        unit_peak_memory_gib=f"{upeak:.2f}", seconds=f"{sec_all:.1f}",
        launches=counts, failures=failures or "none")
    report["recurrent"]["rgemma"] = dict(
        setup_s=setup_s, static_tokens_per_s=b * steps / sec,
        mixed_equal=equal, near_ties=ties, divergences=bad,
        states_finite=finite, step_launches=step_launches, step=times,
        peak_memory_gib=peak, unit_gate=gate, unit_peak_memory_gib=upeak,
        seconds=sec_all, launches=counts, failures=failures)
    if failures:
        raise AssertionError(f"12a rgemma: {failures}")
    return counts


def rec_xlstm(report):
    """12b: xlstm-350m at full width, two units (16 of 24 blocks: 14
    mLSTM, 2 sLSTM), 4 tasks. 5c's static mixed batch (16 x 512 + 64)
    through ``ServeEngine.generate``: exact launches (16 plain-mode
    gather-adds for the prefill and each step, no attention kernel), the
    tokens against each task's rows served alone (equal, or a first
    difference within twice plain bf16's error of float32: xLSTM's bf16
    orders part by about that), every state finite; the mixed batch's
    prefill then decode steps
    held to ``Model.logits`` by 7c's float32 rule, the task's carried
    share against plain bf16's (``rec_against_logits``); per decode step host,
    wall and device time, the host share of the mLSTM and sLSTM blocks in
    a step and in the prefill."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    spec, counts, failures = XLSTM, {}, []
    engine = decoder_engine(spec, spec["static"][1] + spec["static"][2])
    model, params, cfg = engine.model, engine.params, engine.model.cfg
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    b, s, steps = spec["static"]
    rng = np.random.default_rng(13)
    prompts = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    task_ids = (np.arange(b) % spec["tasks"]).astype(np.int32)
    engine.generate(prompts[:1, :64], 2, task_ids[:1])          # warm-up
    label = "rec_xlstm_static"
    out, sec = counted(label, counts,
                       lambda: engine.generate(prompts, steps, task_ids))
    try:
        check_launches(label, counts[label], rec_launches(cfg, steps))
    except AssertionError as e:
        failures.append(str(e))
    toks = torch.as_tensor(prompts, device=DEV)
    peft = engine._peft(torch.as_tensor(task_ids, device=DEV))
    torch.cuda.synchronize()
    with block_host_ms() as pre_spent:
        p0 = time.perf_counter()
        logits, cache, pos = model.prefill(params, toks, peft,
                                           max_len=engine.cache_len)
        pre_host = (time.perf_counter() - p0) * 1e3
        torch.cuda.synchronize()
        pre_wall = (time.perf_counter() - p0) * 1e3
    times = rec_step_times(model, params, logits, cache, pos, peft)
    del cache
    logits, cache, pos = model.prefill(params, toks, peft,
                                       max_len=engine.cache_len)
    lg_dec, gen_toks = greedy_decode(model, params, logits, cache, pos,
                                     peft, steps)
    del cache, logits
    if not np.array_equal(gen_toks.cpu().numpy(), out):
        failures.append("prefill + decode steps picked other tokens than "
                        "generate")
    seq = torch.cat([toks, gen_toks], 1)
    gate = rec_against_logits(model, params, engine.tables, seq, s, lg_dec,
                              task_ids, carry_vs_plain=True)
    if not gate["ok"]:
        failures.append(f"decode vs Model.logits: {gate}")
    del lg_dec
    # two bf16 orders of the same function (batches of 16 and of 4 rows)
    # part by about bf16's own error: a divergence within twice the plain
    # bf16 run's error against float32 is a near tie there
    tie = BF16_FACTOR * max(r["plain_err"] for r in gate["tasks"].values())
    equal, ties, bad, finite = rec_mixed_vs_per_task(
        model, params, engine.tables, prompts, task_ids, steps, out, tie)
    if bad or not finite:
        failures.append(f"mixed vs per task: divergences past a near tie "
                        f"{bad}, states finite {finite}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    sec_all = time.perf_counter() - t0
    log("12b xlstm", layers=cfg.num_layers, setup_s=f"{setup_s:.1f}",
        static=f"{b}x{s}+{steps}",
        static_tokens_per_s=f"{b * steps / sec:.1f}",
        mixed_vs_per_task=f"{equal}/{b} equal", near_ties=ties,
        states_finite=finite,
        step_host_ms=f"{times['host_ms']:.2f}",
        step_wall_ms=f"{times['wall_ms']:.2f}",
        step_device_ms=f"{times['device_busy_ms']:.2f}",
        step_block_host_share={k: round(v, 3) for k, v in
                               times["block_host_share"].items()},
        prefill_host_ms=f"{pre_host:.1f}", prefill_wall_ms=f"{pre_wall:.1f}",
        prefill_block_host_share={k: round(v / pre_host, 3)
                                  for k, v in pre_spent.items()},
        vs_float32=f32_text(gate), vs_whole=verdict(gate["vs_whole"]),
        peak_memory_gib=f"{peak:.2f}", seconds=f"{sec_all:.1f}",
        launches=counts, failures=failures or "none")
    report["recurrent"]["xlstm"] = dict(
        setup_s=setup_s, static_tokens_per_s=b * steps / sec,
        mixed_equal=equal, near_ties=ties, divergences=bad,
        states_finite=finite, step=times, prefill_host_ms=pre_host,
        prefill_wall_ms=pre_wall, prefill_block_host_ms=dict(pre_spent),
        gate=gate, peak_memory_gib=peak, seconds=sec_all, launches=counts,
        failures=failures)
    if failures:
        raise AssertionError(f"12b xlstm: {failures}")
    return counts


def phase_recurrent(report):
    """Phase 12 (12a, 12b), each part's memory freed before the next;
    returns the launches by path."""
    t0 = time.perf_counter()
    report["recurrent"] = {}
    launches = {}
    for part in (lambda: rec_rgemma(report), lambda: rec_xlstm(report)):
        launches.update(part())
        gc.collect()
        torch.cuda.empty_cache()
    report["recurrent"]["seconds"] = time.perf_counter() - t0
    log("12 recurrent", seconds=f"{report['recurrent']['seconds']:.1f}")
    return launches


# ---------------------------------------------------------------------------
# phase 13: the two front-ends (paligemma-3b, hubert-xlarge)
# ---------------------------------------------------------------------------

# 13a's static batch: (b, text tokens after the 256 patches, steps)
PALI = dict(arch="paligemma-3b", tasks=2, static=(4, 256, 32))
PALI_SENTINEL = 0           # the token id AoT indexes at a patch position
PALI_CHECK_STEPS = (0, 8, 31)   # decode steps held to Model.logits
HUBERT = dict(arch="hubert-xlarge", frames=(8, 512), max_pos=1024)
HUBERT_METHODS = ("none", "aot", "bitfit", "lora", "adapters", "ptv1",
                  "ptv2")
# the phase 13 run whose count rides with each kernel's phase 4 times at
# phase 13's shapes (``frontends``)
FRONT_PATH = {"aot_gather_add_multitask": "front_pali_prefill",
              "decode_attention": "front_pali_decode",
              "flash_attention": "front_hubert_none",
              "aot_gather_add": "front_hubert_aot"}


def softcap_cases(dev, gen, cap=30.0):
    """The plain softcap paths (``tanh(s / cap) * cap`` on the scores; no
    kernel takes it) at smollm-360m's heads in float32 on ``dev``: the
    whole-sequence oracle, ``attention_chunked`` over several kv chunks,
    contiguous, paged and ragged decode. Returns {name: (fn, inputs)}:
    calling fn on the inputs (or on CPU copies) gives the output."""
    from repro_torch.models import layers as L
    g = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    b, s, nb, bs = 2, 96, 16, BS
    q, k, v = g(b, s, H, HD), g(b, s, KVH, HD), g(b, s, KVH, HD)
    pages = (g(nb, bs, KVH, HD), g(nb, bs, KVH, HD))
    tables = torch.arange(1, 1 + 2 * 6, device=dev).reshape(2, 6).to(
        torch.int32)
    cur = torch.tensor([37, 90], device=dev, dtype=torch.int32)
    rows = torch.tensor([0, 1, 1, 0], device=dev, dtype=torch.int32)
    pos = torch.tensor([36, 88, 89, -1], device=dev, dtype=torch.int32)
    return {
        "attention_ref": (lambda q, k, v: L.attention_ref(
            q, k, v, causal=True, softcap=cap), (q, k, v)),
        "attention_chunked": (lambda q, k, v: L.attention_chunked(
            q, k, v, causal=True, softcap=cap, chunk_q=32, chunk_kv=16),
            (q, k, v)),
        "attention_decode": (lambda q, k, v, c: L.attention_decode(
            q, k, v, c, softcap=cap), (q[:, :1], k, v, cur)),
        "paged_attention_decode": (lambda q, kp, vp, t, c: (
            L.paged_attention_decode(q, kp, vp, t, c, softcap=cap)),
            (q[:, :1], *pages, tables, cur)),
        "ragged_paged_attention_decode": (
            lambda q, kp, vp, t, r, p: L.ragged_paged_attention_decode(
                q, kp, vp, t, r, p, softcap=cap),
            (q[0, :4, None], *pages, tables, rows, pos)),
    }


def softcap_errors(cases):
    """The largest difference of each case on its device from the same
    call on CPU copies of its inputs."""
    out = {}
    for name, (fn, xs) in cases.items():
        got = fn(*xs)
        want = fn(*(x.cpu() for x in xs))
        out[name] = float((got.cpu() - want).abs().max())
    return out


def parity_softcap(gen, report):
    """Phase 3's softcap line: the plain paths on CUDA tensors against
    the CPU, float32, within TOL; no kernel mode exists for it."""
    errs = softcap_errors(softcap_cases(DEV, gen))
    report["parity"]["softcap"] = errs
    bad = {k: e for k, e in errs.items() if not e <= TOL[torch.float32]}
    log("3 parity", kernel="none (plain softcap paths)", cap=30.0,
        max_abs_err=max(errs.values()), cases=len(errs),
        result="cuda vs cpu within 2e-5" if not bad else f"FAIL {bad}")
    if bad:
        raise AssertionError(f"softcap on the card vs the CPU: {bad}")


def parity_frontends(gen, report):
    """Phase 3 at phase 13's new shapes: flash in full mode at hubert's
    heads (h16 kvh16 hd80, g 1; FLASH_CASES' ``hubert_*``) runs with
    parity_flash; here contiguous decode at paligemma's MQA (h8 kvh1
    hd256, g 8) over b 4, S 1024 (every row full, and 13a's depths 512 +
    i), the fused multi-task gather-add at d 2048 over 2 tasks of V 257216
    (with and without the norm, bitwise h_out), the single-table
    gather-add in its plain mode at hubert's d 1280 over V 504 (bitwise),
    and ``layers.attention_chunked`` (the route of a bidirectional prefix)
    on the card against ``layers.attention_ref`` on the card in float32
    (TF32 off) within TOL: a prefix of 256 over 512 and 577 tokens at
    paligemma's heads, through ``ops.flash_attention(prefix_len=)`` (the
    reference's chunks of 1024: one block) and with chunks of 128 (the
    online-softmax scan)."""
    from repro_torch.kernels import aot_bias, ops
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models import layers as L
    (h, kvh), hd = PALI_HEADS, PALI_HD
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, lens in (("full", [MAX_LEN] * 4),
                           ("13a_depths", [512 + i for i in (0, 1, 15, 31)])):
            q, k, v, cur = decode_inputs(gen, lens, dtype, hd, S=MAX_LEN,
                                         heads=PALI_HEADS)
            out = ops.decode_attention(q, k[0], v[0], cur)
            plain = da.decode_attention_plain(q, k[0], v[0], cur)
            err = check_close(f"decode/pali/{name}/{dtype}", out, plain,
                              dtype, report)
            cases.append(f"{name}/{str(dtype)[6:]}:{err:.2e}")
    log("3 parity", kernel="decode_attention", variant="pali_hd256_g8",
        shapes=f"b4 h{h} kvh{kvh} hd{hd} S{MAX_LEN}",
        max_abs_err=",".join(cases))
    parity_moe_gather(gen, report, gathers=(PALI_GATHER,), mode="paligemma")
    vocab, d = HUBERT_GATHER
    table = (torch.randn(vocab, d, generator=gen, device=DEV) * 0.03).to(
        torch.bfloat16)
    gcases = []
    for h_dtype in (torch.bfloat16, torch.float32):
        for T in (64, 4096):
            hh = torch.randn(T, d, generator=gen, device=DEV).to(h_dtype)
            ids = torch.randint(0, vocab, (T,), generator=gen, device=DEV,
                                dtype=torch.int32)
            ids[:3] = torch.tensor([0, vocab - 1, -1])
            out = ops.aot_gather_add(hh, table, ids)
            torch.cuda.synchronize()
            if not torch.equal(out, aot_bias.aot_gather_add_plain(
                    hh, table, ids)):
                raise AssertionError(f"plain-mode gather-add d{d} V{vocab} "
                                     f"h={h_dtype} T{T}: not bitwise")
            gcases.append(f"{str(h_dtype)[6:]}/T{T}")
    log("3 parity", kernel="aot_gather_add", mode="plain (hubert unit-AoT)",
        d=d, V=vocab, cases=",".join(gcases), result="bitwise equal")
    ccases = []
    for b, s in ((2, 512), (1, 577)):
        q, k, v = flash_inputs(gen, b, s, s, hd, torch.float32,
                               heads=PALI_HEADS)
        kw = dict(causal=True, prefix_len=PALI_PREFIX)
        want = L.attention_ref(q, k, v, **kw)
        for label, got in (
                ("wrapper", ops.flash_attention(q, k, v, **kw)),
                ("chunks128", L.attention_chunked(q, k, v, chunk_q=128,
                                                  chunk_kv=128, **kw))):
            err = check_close(f"chunked/{label}/b{b}_s{s}", got, want,
                              torch.float32, report)
            ccases.append(f"{label}/b{b}_s{s}:{err:.2e}")
    report["parity"]["frontends"] = dict(decode=cases, gather=gcases,
                                         chunked=ccases)
    log("3 parity", path="attention_chunked (prefix_len)",
        against="layers.attention_ref on the card", dtype="float32",
        prefix=PALI_PREFIX, heads=f"h{h} kvh{kvh} hd{hd}",
        max_abs_err=",".join(ccases))


def times_frontends(gen, report):
    """The kernels at phase 13's new shapes, bf16: flash in full mode at
    hubert's heads (h16 kvh16 hd80, g 1) over its frames (8 x 512) beside
    SDPA non-causal; contiguous decode at paligemma's MQA (h8 kvh1 hd256,
    g 8) over b 4, S 1024 beside SDPA with a length mask; the fused
    multi-task gather-add at d 2048 over 2 tasks of V 257216 at 13a's
    prefill (T 2048 = 4 x 512) beside the sequence it replaces and
    F.rms_norm; the single-table gather-add in its plain mode at d 1280
    over V 504 at 13b's T 4096 (no library call). Also, no kernel: the
    prefix's route, ``attention_chunked`` through ``ops.flash_attention``
    at 13a's prefill (4 x 512, prefix 256) beside SDPA with the same bool
    mask (a log line). Returns {kernel: {shape: numbers}} for the kernels
    line's ``frontends`` entries (launches added by phase 13)."""
    import torch.nn.functional as F
    from repro_torch.kernels import aot_bias
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    dt, es, out, text = torch.bfloat16, 2, {}, {}

    def keep(kernel, key, desc, r):
        out.setdefault(kernel, {})[key] = dict(shape=desc, **_enc_row(r))
        text[f"{kernel}/{key}"] = fmt_times(r) + (
            f"[{r['bound_by']}; library {r['library_ms']:.5f}]"
            if r["library_ms"] is not None else f"[{r['bound_by']}]")
    # ---- flash, full mode at g 1, hd 80: hubert's (8, 512)
    (h, kvh), hd = HUBERT_HEADS, HUBERT_HD
    b, s = HUBERT["frames"]
    qs = [flash_inputs(gen, b, s, s, hd, dt, heads=HUBERT_HEADS)
          for _ in range(4)]
    r = timed(lambda i: ops.flash_attention(*qs[i % 4], causal=False),
              lambda i: fa.flash_attention_plain(*qs[i % 4], causal=False),
              16, 4, tol=TOL[dt])
    r["library_ms"] = device_ms(lambda i: F.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in qs[i % 4])), 16)   # yardstick only
    r["bound_ms"], r["bound_by"] = bound(b * s * (2 * h + 2 * kvh) * hd * es,
                                         4 * hd * h * s * s * b, dt)
    keep("flash_attention", "hubert_b8_s512_full",
         f"b{b} s{s} h{h} kvh{kvh} hd{hd} full", r)
    del qs
    # ---- contiguous decode at paligemma's MQA: b 4, S 1024, rows full
    (h, kvh), hd = PALI_HEADS, PALI_HD
    q, k, v, cur = decode_inputs(gen, [MAX_LEN] * 4, dt, hd, layers=8,
                                 S=MAX_LEN, heads=PALI_HEADS)
    layer = lambda i: (k[i % 8], v[i % 8])
    r = timed(lambda i: ops.decode_attention(q, *layer(i), cur),
              lambda i: da.decode_attention_plain(q, *layer(i), cur),
              64, 16, tol=TOL[dt])
    mask = (torch.arange(MAX_LEN, device=DEV)[None, :]
            < cur[:, None])[:, None, None, :]
    r["library_ms"] = device_ms(lambda i: F.scaled_dot_product_attention(
        q[:, :, None], *(x.transpose(1, 2) for x in layer(i)),
        attn_mask=mask, enable_gqa=True), 64)     # yardstick only
    n_kv = 4 * MAX_LEN
    r["bound_ms"], r["bound_by"] = bound(
        2 * 4 * h * hd * es + 2 * n_kv * kvh * hd * es + 16,
        4 * hd * h * n_kv, dt)
    keep("decode_attention", "pali_b4_S1024",
         f"b4 h{h} kvh{kvh} hd{hd} S{MAX_LEN} (rows full)", r)
    del q, k, v, mask
    # ---- the fused multi-task gather-add at 13a's prefill
    n_tasks, vocab, d = PALI_GATHER
    tables = torch.empty(n_tasks, vocab, d, dtype=dt, device=DEV)
    for t in range(n_tasks):
        tables[t].normal_(0.0, DEC_TABLE_SCALE, generator=gen)
    T = 4 * 512
    # 8 sets of h, task ids and ids rotate (64 MB of h over a 50 MB L2),
    # so that each call reads its h from HBM, as a prefill's layer does
    hh, tasks, ids = gather_inputs(gen, T, dt, tables, sets=8)
    hs = [hh] + [torch.randn(T, d, generator=gen, device=DEV).to(dt)
                 for _ in range(7)]
    args = lambda i: (hs[i % 8], tables, tasks[i % 8], ids[i % 8])
    r = times_gather_norm(
        gen, hh, lambda i, **kw: ops.aot_gather_add_multitask(*args(i), **kw),
        lambda i, **kw: aot_bias.aot_gather_add_multitask_plain(*args(i),
                                                                **kw), 200,
        sets=8)
    r["library_ms"], r["bound_by"] = r["library_norm_ms"], "bytes"
    keep("aot_gather_add_multitask", "pali_T2048_d2048_norm",
         f"T{T} d{d} {n_tasks} tasks of V{vocab} +norm (library: "
         "F.rms_norm alone)", r)
    text["aot_gather_add_multitask/pali_T2048_d2048_norm"] = \
        fmt_gather_norm(r)
    del tables, hh, hs
    # ---- the single-table gather-add, plain mode, hubert's unit-AoT
    vocab, d = HUBERT_GATHER
    T = HUBERT["frames"][0] * HUBERT["frames"][1]
    table = (torch.randn(vocab, d, generator=gen, device=DEV) * 0.02).to(dt)
    hs = [torch.randn(T, d, generator=gen, device=DEV).to(dt)
          for _ in range(8)]
    idl = [torch.randint(0, vocab, (T,), generator=gen, device=DEV,
                         dtype=torch.int32) for _ in range(8)]
    r = timed(lambda i: ops.aot_gather_add(hs[i % 8], table, idl[i % 8]),
              lambda i: aot_bias.aot_gather_add_plain(hs[i % 8], table,
                                                      idl[i % 8]),
              200, 50, tol=0)
    r["library_ms"], r["bound_by"] = None, "bytes"
    # h read and the sum written; of the table (V 504 < T) only the rows
    # the ids touch, each once
    rows = int(torch.unique(idl[0]).numel())
    r["bound_ms"] = ((2 * T + rows) * d * es + 4 * T) / HBM_BYTES_PER_S * 1e3
    keep("aot_gather_add", "hubert_T4096_d1280_plain",
         f"T{T} d{d} V{vocab} plain mode", r)
    del hs, table
    # ---- the prefix's route (not a kernel): attention_chunked at 13a's
    # prefill beside SDPA with the same mask
    (h, kvh), hd = PALI_HEADS, PALI_HD
    b, s = 4, 512
    qs = [flash_inputs(gen, b, s, s, hd, dt, heads=PALI_HEADS)
          for _ in range(2)]
    pos = torch.arange(s, device=DEV)
    mask = (pos[None, :] <= pos[:, None]) | (pos[None, :] < PALI_PREFIX)
    chunked = dict(
        ms=device_ms(lambda i: ops.flash_attention(
            *qs[i % 2], causal=True, prefix_len=PALI_PREFIX), 8),
        wall_ms=wall_ms(lambda i: ops.flash_attention(
            *qs[i % 2], causal=True, prefix_len=PALI_PREFIX), 8),
        library_ms=device_ms(lambda i: F.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in qs[i % 2]), attn_mask=mask,
            enable_gqa=True), 8))
    pairs = b * h * int(mask.sum().item())
    chunked["bound_ms"], chunked["bound_by"] = bound(
        b * s * (2 * h + 2 * kvh) * hd * es, 4 * hd * pairs, dt)
    del qs, mask
    log("4 times", kernel="(none) attention_chunked", mode="prefix 256 "
        "(paligemma's prefill, 4 x 512, h8 kvh1 hd256)",
        ms=f"{chunked['ms']:.5f}", wall_ms=f"{chunked['wall_ms']:.4f}",
        sdpa_bool_mask_ms=f"{chunked['library_ms']:.5f}",
        bound_ms=f"{chunked['bound_ms']:.5f}[{chunked['bound_by']}]")
    log("4 times", kernel="frontends", mode="paligemma / hubert", **text)
    report["times"]["frontends"] = dict(rows=out, chunked=chunked)
    return out


def pali_inputs(cfg, b, s_text, seed=13):
    """13a's batch: token ids (b, frontend_len + s_text), the patch
    positions holding ``PALI_SENTINEL`` (what AoT indexes there), and the
    stub's patches (b, frontend_len, frontend_dim) float32, seeded."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (b, cfg.frontend_len + s_text))
    toks[:, :cfg.frontend_len] = PALI_SENTINEL
    gen = torch.Generator(device=DEV).manual_seed(seed)
    patches = torch.randn(b, cfg.frontend_len, cfg.frontend_dim,
                          generator=gen, device=DEV)
    return torch.as_tensor(toks, dtype=torch.int32, device=DEV), patches


def pali_logits_rule(model, params, tables, seq, s, lg_dec, task_ids,
                     patches, steps):
    """7c's float32 rule on the decode steps ``steps`` of ``lg_dec``
    (steps + 1, b, V): against ``Model.logits`` of the grown sequences
    ``seq`` (b, s + n) with the same patches in float32 plain PyTorch
    (``attn_impl="ref"``; the bf16 tables read exactly, no float32 copy),
    within BF16_FACTOR times plain bf16 PyTorch's error, carrying each
    task's effect within CARRY_TOL (``against_float32``)."""
    from repro_torch.models.model import Model, ModelOptions
    cfg, f32, bf = model.cfg, torch.float32, torch.bfloat16
    at = torch.as_tensor([1 + k for k in steps], device=DEV)

    def logits_at(m, p, rows, peft):
        h = m.forward(p, seq[rows], peft, patches=patches[rows])
        return m.unembed(p, h[:, s - 1 + at]).float().transpose(0, 1)
    every = torch.arange(seq.shape[0], device=DEV)
    tids = torch.as_tensor(task_ids, device=DEV)
    plain16 = Model(cfg, ModelOptions(bf, bf, attn_impl="ref"), device=DEV)
    lg_p16 = logits_at(plain16, params, every, tasks_peft(tables, tids))
    m32 = Model(cfg, ModelOptions(f32, f32, attn_impl="ref"), device=DEV)
    p32 = cast_backbone(params, f32)
    ref32 = torch.empty_like(lg_p16)
    base32 = torch.empty_like(lg_p16)
    for t in sorted(set(task_ids.tolist())):
        rows = torch.as_tensor(np.flatnonzero(task_ids == t), device=DEV)
        one = tasks_peft(tables[:, t:t + 1], torch.zeros(
            len(rows), dtype=torch.int32, device=DEV))
        ref32[:, rows] = logits_at(m32, p32, rows, one)
        base32[:, rows] = logits_at(m32, p32, rows, None)
    del p32
    flat = lambda x: x.reshape(-1, x.shape[-1])
    ids = [int(t) for t in task_ids] * len(steps)
    res = against_float32(flat(lg_dec[at]), flat(lg_p16), flat(ref32),
                          flat(base32), ids)
    res["steps"] = list(steps)
    return res


def pali_static(report):
    """13a: paligemma-3b at full depth (18 layers, bf16, random weights
    seed 0) with 2 fabricated tasks (37.9 GB of tables): a static batch of
    4 prompts of 256 patches and 256 text tokens through ``Model.prefill``
    (patches over the sentinel ids, bidirectional over the 256) then 32
    greedy decode steps (MQA at hd 256, g 8). Gates: the prefill launches
    18 fused multi-task gather-adds and sends 18 attentions to
    ``attention_chunked`` (flash 0), each decode step 18 contiguous decodes
    and 18 gather-adds; each task's rows served as a batch of their own
    equal to the mixed batch's tokens or diverging at a near tie (phase
    6's rule); decode steps PALI_CHECK_STEPS held to ``Model.logits`` with
    the same patches by 7c's float32 rule. Reported: tokens/s, a step's
    host, wall and device ms, peak memory."""
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    counts, failures = {}, []
    model, params = encoder_model(PALI["arch"])
    cfg = model.cfg
    tables = fabricated_tables(cfg, PALI["tasks"], torch.bfloat16)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    b, s_text, steps = PALI["static"]
    toks, patches = pali_inputs(cfg, b, s_text)
    s = toks.shape[1]
    task_ids = (np.arange(b) % PALI["tasks"]).astype(np.int32)
    peft = tasks_peft(tables, torch.as_tensor(task_ids, device=DEV))
    max_len = s + steps + 16          # rec_step_times' 16 steps after
    L = cfg.num_layers

    def prefill(rows=slice(None), bundle=peft):
        return model.prefill(params, toks[rows], bundle, max_len=max_len,
                             patches=patches[rows])
    prefill(slice(0, 1), tasks_peft(tables, torch.zeros(
        1, dtype=torch.int32, device=DEV)))                     # warm-up
    (logits, cache, pos), psec = counted("front_pali_prefill", counts,
                                         prefill)
    counts["front_pali_prefill"]["chunked"] = ops.chunked_calls()
    (lg_dec, out), dsec = counted(
        "front_pali_decode", counts, lambda: greedy_decode(
            model, params, logits, cache, pos, peft, steps))
    counts["front_pali_decode"]["chunked"] = ops.chunked_calls()
    for label, want in (
            ("front_pali_prefill", {"aot_gather_add_multitask": L,
                                    "chunked": L}),
            ("front_pali_decode", {"aot_gather_add_multitask": L * steps,
                                   "decode_attention": L * steps})):
        try:
            check_launches(label, counts[label], want)
        except AssertionError as e:
            failures.append(str(e))
    times = rec_step_times(model, params, lg_dec[-1][:, None], cache,
                           pos + steps, peft)
    del cache, logits
    # each task's rows alone against the mixed batch's tokens
    equal, ties, bad = 0, [], []
    for t in range(PALI["tasks"]):
        rows = torch.as_tensor(np.flatnonzero(task_ids == t), device=DEV)
        one = tasks_peft(tables, torch.full((len(rows),), t,
                                            dtype=torch.int32, device=DEV))
        lg1, c1, p1 = prefill(rows, one)
        lgs, alone = greedy_decode(model, params, lg1, c1, p1, one, steps)
        del c1
        for j, r in enumerate(rows.tolist()):
            d = divergence(out[r].tolist(), alone[j].tolist(), lgs[:, j])
            if d is None:
                equal += 1
            else:
                (ties if d[2] else bad).append((r, d[0], round(d[1], 5)))
    if bad:
        failures.append(f"mixed vs per task: divergences past a near tie "
                        f"{bad}")
    seq = torch.cat([toks, out], 1)
    gate = pali_logits_rule(model, params, tables, seq, s, lg_dec, task_ids,
                            patches, PALI_CHECK_STEPS)
    if not gate["ok"]:
        failures.append(f"decode vs Model.logits (7c's rule): {gate}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    sec_all = time.perf_counter() - t0
    tps = b * steps / (psec + dsec)
    log("13a paligemma", layers=L, tasks=PALI["tasks"],
        static=f"{b}x({cfg.frontend_len} patches + {s_text})+{steps}",
        setup_s=f"{setup_s:.1f}", prefill_ms=f"{psec * 1e3:.1f}",
        decode_ms=f"{dsec * 1e3:.1f}", tokens_per_s=f"{tps:.1f}",
        mixed_vs_per_task=f"{equal}/{b} equal", near_ties=ties,
        step_host_ms=f"{times['host_ms']:.2f}",
        step_wall_ms=f"{times['wall_ms']:.2f}",
        step_device_ms=f"{times['device_busy_ms']:.2f}",
        decode_vs_logits=f32_text(gate), peak_memory_gib=f"{peak:.2f}",
        seconds=f"{sec_all:.1f}", launches=counts,
        failures=failures or "none")
    report["frontends"]["paligemma"] = dict(
        setup_s=setup_s, prefill_s=psec, decode_s=dsec, tokens_per_s=tps,
        mixed_equal=equal, near_ties=ties, divergences=bad, step=times,
        gate=gate, peak_memory_gib=peak, seconds=sec_all, launches=counts,
        failures=failures)
    del model, params, tables, peft
    if failures:
        raise AssertionError(f"13a paligemma: {failures}")
    return counts


def hubert_setups(model, params, gen):
    """label -> (params, bundle or None) for HUBERT_METHODS: the methods of
    PEFT_METHODS through ``peft_setup`` (P-Tuning v1 too), and ``aot``:
    unit-AoT, one fused table (L, 504, d) of normals x DEC_TABLE_SCALE
    indexed by the unit ids."""
    from repro_torch.core import peft as P
    cfg = model.cfg
    out = {}
    for label in HUBERT_METHODS:
        if label == "aot":
            table = torch.empty(cfg.num_layers, cfg.vocab_size, cfg.d_model,
                                dtype=model.opts.compute_dtype, device=DEV)
            table.normal_(0.0, DEC_TABLE_SCALE, generator=gen)
            out[label] = (params, P.make({"aot": {"table": table}},
                                         P.PEFTOptions(
                                             method="aot", aot=P.AoTOptions(
                                                 mode="fused"))))
        else:
            out[label] = peft_setup(label, model, params, None, gen)
    return out


def hubert_encoder(report):
    """13b: hubert-xlarge at full depth (48 layers, bf16, random weights
    seed 0, 1024 learned positions) on seeded frames (8, 512) and unit ids:
    ``Model.logits`` for each method of HUBERT_METHODS, one counted call
    each (exact launches: ``encoder_launches``, finite logits), each held
    by 7c's float32 rule (within BF16_FACTOR times plain bf16's error of
    the float32 logits in plain PyTorch; the method's effect carried within
    CARRY_TOL, but the backbone's, which has none); then PEFT_ROUNDS timed
    runs in turns, each method's ms over the backbone's (Fig. 3, reported);
    then ``classify`` (a seeded 2-way head) held by the same error rule."""
    from repro_torch.core import peft as P
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model, ModelOptions
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    bf, f32 = torch.bfloat16, torch.float32
    model, params = encoder_model(HUBERT["arch"], max_pos=HUBERT["max_pos"])
    cfg, L = model.cfg, model.cfg.num_layers
    gen = torch.Generator(device=DEV).manual_seed(6)
    b, s = HUBERT["frames"]
    frames = torch.randn(b, s, cfg.frontend_dim, generator=gen, device=DEV)
    units = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                          device=DEV, dtype=torch.int32)
    setups = hubert_setups(model, params, gen)
    plain16 = Model(cfg, ModelOptions(bf, bf, attn_impl="ref",
                                      max_learned_pos=HUBERT["max_pos"]),
                    device=DEV)
    m32 = Model(cfg, ModelOptions(f32, f32, attn_impl="ref",
                                  max_learned_pos=HUBERT["max_pos"]),
                device=DEV)
    p32 = cast_backbone(params, f32)

    def inputs(label):
        return dict(frames=frames, aot_ids=units if label == "aot" else None)

    def bundle32(bundle):
        if bundle is None:
            return None
        return dict(bundle, params=cast_backbone(bundle["params"], f32))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    base32 = m32.logits(p32, None, None, frames=frames).float()
    counts, gates, failures = {}, {}, []
    for label in HUBERT_METHODS:
        p, bd = setups[label]
        torch.cuda.synchronize()
        ops.reset_launches()
        lg = model.logits(p, None, bd, **inputs(label)).float()
        torch.cuda.synchronize()
        c = counts[f"front_hubert_{label}"] = dict(
            ops.launches(), chunked=ops.chunked_calls())
        try:
            check_launches(f"13b {label}", c, encoder_launches(L, label))
        except AssertionError as e:
            failures.append(str(e))
        if not bool(torch.isfinite(lg).all()):
            failures.append(f"13b {label}: a logit is not finite")
        ref = m32.logits(cast_backbone(p, f32), None, bundle32(bd),
                         **inputs(label)).float()
        lp = plain16.logits(p, None, bd, **inputs(label)).float()
        flat = lambda x: x.reshape(-1, x.shape[-1])
        if label == "none":         # the backbone: no effect to carry
            g = dict(served_err=(lg - ref).abs().max().item(),
                     plain_err=(lp - ref).abs().max().item(),
                     carried=float("nan"))
            g["ok"] = g["served_err"] <= BF16_FACTOR * g["plain_err"]
        else:
            g = against_float32(flat(lg), flat(lp), flat(ref), flat(base32),
                                [0] * (b * s))["tasks"][0]
        gates[label] = g
        if not g["ok"]:
            failures.append(f"13b {label}: against float32 {g}")
        del lg, ref, lp
    ms = {label: [] for label in HUBERT_METHODS}
    for r in range(PEFT_ROUNDS):
        for label in HUBERT_METHODS[r:] + HUBERT_METHODS[:r]:
            p, bd = setups[label]
            ms[label].append(wall_ms(
                lambda i: model.logits(p, None, bd, **inputs(label)),
                iters=3, warmup=2 if r == 0 else 0))
    ms = {label: median(t) for label, t in ms.items()}
    # classify: a seeded 2-way head on the mean-pooled frames
    head = {"w": torch.randn(cfg.d_model, 2, generator=gen, device=DEV)
            * 0.02, "b": torch.zeros(2, device=DEV)}
    cls_opt = P.PEFTOptions(method="none", num_classes=2)
    cls = lambda m, pp, dt: m.classify(pp, None, P.make(
        {"head": {k: v.to(dt) for k, v in head.items()}}, cls_opt),
        frames=frames).float()
    c_k, c_p, c_r = cls(model, params, bf), cls(plain16, params, bf), \
        cls(m32, p32, f32)
    cls_gate = dict(served_err=(c_k - c_r).abs().max().item(),
                    plain_err=(c_p - c_r).abs().max().item())
    cls_gate["ok"] = cls_gate["served_err"] <= BF16_FACTOR * cls_gate[
        "plain_err"]
    if not cls_gate["ok"]:
        failures.append(f"13b classify: {cls_gate}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    sec_all = time.perf_counter() - t0
    log("13b hubert", layers=L, frames=f"{b}x{s}x{cfg.frontend_dim}",
        setup_s=f"{setup_s:.1f}",
        logits_ms={k: f"{t:.2f}({t / ms['none']:.3f}x)"
                   for k, t in ms.items()},
        vs_float32={k: f"{g['served_err']:.3e}/plain {g['plain_err']:.3e}"
                    f"/carried {g['carried']:.4f}" for k, g in gates.items()},
        classify=f"{cls_gate['served_err']:.3e}/plain "
        f"{cls_gate['plain_err']:.3e}", peak_memory_gib=f"{peak:.2f}",
        seconds=f"{sec_all:.1f}", launches=counts,
        failures=failures or "none")
    report["frontends"]["hubert"] = dict(
        setup_s=setup_s, logits_ms=ms, gates=gates, classify=cls_gate,
        peak_memory_gib=peak, seconds=sec_all, launches=counts,
        failures=failures)
    del model, params, setups, plain16, m32, p32
    if failures:
        raise AssertionError(f"13b hubert: {failures}")
    return counts


def phase_frontends(report):
    """Phase 13 (13a, 13b), each part's memory freed before the next;
    returns the launches by path."""
    t0 = time.perf_counter()
    report["frontends"] = {}
    launches = {}
    for part in (lambda: pali_static(report),
                 lambda: hubert_encoder(report)):
        launches.update(part())
        gc.collect()
        torch.cuda.empty_cache()
    report["frontends"]["seconds"] = time.perf_counter() - t0
    log("13 frontends", seconds=f"{report['frontends']['seconds']:.1f}")
    return launches


# ---------------------------------------------------------------------------
# phase 14: distribution on a one-rank mesh (the NCCL group, DTensors, the
# kernel wrappers on shards, the sharded train step, expert parallelism,
# the compressed all-reduce and resharding)
# ---------------------------------------------------------------------------

DIST_TASKS, DIST_BATCH = 4, (16, 64)
DIST_TRAIN = ["--arch", "smollm-360m", "--method", "aot", "--aot-mode", "fc",
              "--rank", "32", "--steps", "3"]
# qwen3-moe-30b-a3b's MoE layer (d 2048, E 128, top-8, f 768) on 1024 tokens
DIST_MOE_X = (4, 256)


def dist_mesh(dev):
    """Join a one-rank process group (NCCL on the card, gloo on the CPU)
    at a free local TCP port, unless one exists; the (1, 1) ("data",
    "model") mesh on ``dev``."""
    import socket
    from repro_torch.launch import mesh as mesh_mod
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    kind = torch.device(dev).type
    mesh_mod.init_group(0, 1, kind, init_method=f"tcp://127.0.0.1:{port}")
    return mesh_mod.make_mesh((1, 1), ("data", "model"), kind)


def _names(path, leaf):
    from repro_torch.distrib import axes as axlib
    return axlib.logical_axes_for(path, tuple(leaf.shape))


def _put_batch(x, name, mesh, rules):
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distrib import axes as axlib
    from repro_torch.distrib import sharding as shlib
    return distribute_tensor(x, mesh, shlib.placements_for(
        axlib.batch_axes_for(name, x.shape), x.shape, mesh, rules),
        src_data_rank=None)


def sharded_logits(mesh, cfg, dtype, dev, n_tasks=DIST_TASKS,
                   batch=DIST_BATCH, seed=0):
    """14a: ``Model.logits`` (the kernels) with ``n_tasks`` fused stacked
    tables over a batch of mixed task ids, unsharded and then on ``mesh``
    under the production rules. Returns (max abs difference, the
    unsharded call's launches, the sharded call's, the logits'
    placements)."""
    from repro_torch.checkpoint.reshard import reshard_tree
    from repro_torch.core import peft as peft_mod
    from repro_torch.distrib import sharding as shlib
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model, ModelOptions
    rules = shlib.tp_dp_rules()
    model = Model(cfg, ModelOptions(dtype, dtype), device=dev)
    params = model.init(seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    tables = torch.empty(cfg.num_layers, n_tasks, cfg.vocab_size,
                         cfg.d_model, dtype=dtype, device=dev)
    for layer in range(cfg.num_layers):
        for task in range(n_tasks):
            tables[layer, task].normal_(0.0, 0.02, generator=gen)
    b, s = batch
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=dev)
    task_ids = (torch.arange(b, device=dev) * 3 % n_tasks).to(torch.int32)
    opt = peft_mod.PEFTOptions(method="aot", aot=peft_mod.AoTOptions(
        mode="fused"))
    bundle = dict(peft_mod.make({"aot": {"table": tables}}, opt),
                  task_ids=task_ids)
    with torch.no_grad():
        ops.reset_launches()
        ref = model.logits(params, tokens, bundle)
        _sync(dev)
        plain = dict(ops.launches())
        params_s = reshard_tree(params, mesh, rules, _names)
        tables_s = reshard_tree({"aot": {"table": tables}}, mesh, rules,
                                _names)["aot"]
        bundle_s = dict(peft_mod.make({"aot": tables_s}, opt),
                        task_ids=_put_batch(task_ids, "task_ids", mesh,
                                            rules))
        toks = _put_batch(tokens, "tokens", mesh, rules)
        ops.reset_launches()
        with shlib.use_rules(mesh, rules):
            out = model.logits(params_s, toks, bundle_s)
        _sync(dev)
        sharded = dict(ops.launches())
    err = float((out.full_tensor().float() - ref.float()).abs().max())
    return err, plain, sharded, str(tuple(out.placements))


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def sharded_logits_gate(err, tol, plain, sharded, layers, on_card):
    """14a's failures: the sharded logits further than ``tol`` from the
    unsharded call's, launches unlike its, or (on the card) not one flash
    and one fused multi-task gather-add per layer and nothing else."""
    failures = []
    if not err <= tol:
        failures.append(f"sharded logits max err {err:.3e} > {tol}")
    if sharded != plain:
        failures.append(f"launches {sharded} != the unsharded {plain}")
    if on_card:
        want = {k: 0 for k in plain}
        want.update(flash_attention=layers, aot_gather_add_multitask=layers)
        if plain != want:
            failures.append(f"unsharded launches {plain} != {want}")
    return failures


def train_mesh_vs_plain(mesh_arg, argv, dev, ckpt_dir):
    """14b: the training launcher's run with ``--mesh mesh_arg`` (this
    process as rank 0 of the group it is in) and the same run without a
    mesh, every step logged. Returns {"mesh" / "plain": (losses, trainable
    leaves gathered whole, the state)}."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.checkpoint.reshard import gather_tree
    from repro_torch.launch import train as tl
    runs = {}
    for label in ("plain", "mesh"):
        args = tl.parser().parse_args(
            argv + ["--device", dev, "--ckpt-dir", f"{ckpt_dir}/{label}"]
            + (["--mesh", mesh_arg] if label == "mesh" else []))
        if label == "mesh":
            trainer, loop = tl.run_mesh(args, 0, 1, log_every=1)
        else:
            trainer = tl.build(args)
            loop = tl.train(trainer, args, log_every=1, ckpt=CheckpointManager(
                f"{args.ckpt_dir}/{args.arch}", keep=2))
        _sync(dev)
        runs[label] = ([h["loss"] for h in loop.history],
                       gather_tree(trainer.state["trainable"]), trainer.state)
    return runs


def train_gate(runs, tol=2e-5):
    """14b: (max difference over losses and trainable leaves, whether all
    are bitwise equal, failures)."""
    (la, ta, _), (lb, tb, _) = runs["mesh"], runs["plain"]
    failures = []
    if len(la) != len(lb) or not la:
        return float("inf"), False, [f"losses {la} vs {lb}"]
    err = max(max(abs(a - b) for a, b in zip(la, lb)), max_leaf_diff(ta, tb))
    bitwise = la == lb and not tree_bits_equal(ta, tb)
    if not err <= tol:
        failures.append(f"mesh vs plain max err {err:.3e} > {tol}")
    return err, bitwise, failures


def ep_vs_gspmd(mesh, cfg, dtype, dev, x_shape=DIST_MOE_X, seed=0):
    """14c: ``apply_moe_ep`` on ``mesh`` (M = the model axis) against
    ``apply_moe_gspmd`` under the same rules, on seeded parameters and
    inputs; then the gradient of the EP output's sum with respect to x.
    Returns (max abs difference, whether the outputs agree by the repo's
    rule for ``dtype``, allclose with atol = rtol = TOL, the largest
    output magnitude, whether the gradient is finite, the dropped
    fractions of both)."""
    from repro_torch.distrib import sharding as shlib
    from repro_torch.models import moe as moe_mod
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = moe_mod.moe_init(cfg, gen, dev, dtype)
    x = torch.randn(*x_shape, cfg.d_model, generator=gen, device=dev).to(dtype)
    with shlib.use_rules(mesh, shlib.tp_dp_rules()):
        with torch.no_grad():
            ref, aux_ref = moe_mod.apply_moe_gspmd(cfg, p, x, dtype)
        xg = x.clone().requires_grad_(True)
        out, aux = moe_mod.apply_moe_ep(cfg, p, xg, dtype)
        out.float().sum().backward()
    _sync(dev)
    a, b = out.detach().float(), ref.float()
    tol = TOL[dtype]
    return (float((a - b).abs().max()),
            bool(torch.allclose(a, b, atol=tol, rtol=tol)),
            float(b.abs().max()), bool(torch.isfinite(xg.grad).all()),
            float(aux["moe_dropped_frac"]), float(aux_ref["moe_dropped_frac"]))


def ep_gate(err, close, finite, dropped):
    """14c's failures: outputs apart by the repo's rule, a gradient that
    is not finite, or any drop at capacity factor 8."""
    failures = []
    if not close:
        failures.append(f"EP vs gather path apart (max err {err:.3e})")
    if not finite:
        failures.append("the gradient with respect to x is not finite")
    if dropped != (0.0, 0.0):
        failures.append(f"drops {dropped} at capacity factor 8")
    return failures


def compressed_vs_rounding(dev, seed=0):
    """14d: ``all_reduce_compressed`` over the group (world 1) against
    ``compress_decompress``: (the mean and error leaves that are not
    bitwise equal to the rounding's, as names)."""
    from repro_torch.optim import compression as comp
    gen = torch.Generator(device=dev).manual_seed(seed)
    grads = {"w": torch.randn(1024, 960, generator=gen, device=dev),
             "b": torch.randn(7, generator=gen, device=dev)}
    err = {k: torch.randn(v.shape, generator=gen, device=dev) * 1e-3
           for k, v in grads.items()}
    mean, new_err = comp.all_reduce_compressed(grads, err)
    _sync(dev)
    bad = []
    for k in grads:
        q, e = comp.compress_decompress(grads[k], err[k])
        if not torch.equal(mean[k], q):
            bad.append(f"mean[{k}]")
        if not torch.equal(new_err[k], e):
            bad.append(f"error[{k}]")
    return bad


def reshard_round_trip(state, mesh, ckpt_dir):
    """14e: a DTensor state saved (whole leaves), restored and laid out
    on ``mesh`` again; the leaves not bitwise equal to the saved state's
    (empty: all equal)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.checkpoint.reshard import gather_tree, reshard_tree
    from repro_torch.distrib import sharding as shlib
    mgr = CheckpointManager(ckpt_dir, async_save=False)
    mgr.save(1, state)
    restored, _ = mgr.restore(state)
    again = reshard_tree(restored, mesh, shlib.tp_dp_rules(), _names)
    return tree_bits_equal(gather_tree(state), gather_tree(again))


def phase_distrib(report):
    """Phase 14 (14a-14e) on a one-rank NCCL mesh, the group destroyed
    after; returns the launches of 14a's sharded call by path."""
    import torch.distributed as dist
    mesh = dist_mesh(DEV)
    try:
        return distrib_parts(report, mesh)
    finally:
        dist.destroy_process_group()


def distrib_parts(report, mesh):
    """Phase 14's parts on ``mesh``."""
    from repro_torch import configs
    t0 = time.perf_counter()
    out, failures = {"card": smi()}, []
    cfg = configs.get("smollm-360m")
    err, plain, sharded, placed = sharded_logits(mesh, cfg, torch.bfloat16,
                                                 DEV)
    failures += sharded_logits_gate(err, TOL[torch.bfloat16], plain, sharded,
                                    cfg.num_layers, on_card=True)
    out["14a"] = {"max_abs_err": err, "tol": TOL[torch.bfloat16],
                  "launches": sharded, "placements": placed}
    log("14a sharded logits", arch="smollm-360m", layers=cfg.num_layers,
        tasks=DIST_TASKS, batch="x".join(map(str, DIST_BATCH)), dtype="bf16",
        max_abs_err=f"{err:.3e}", launches=sharded, card=out["card"])
    gc.collect()
    torch.cuda.empty_cache()
    tmp = LIFECYCLE_DIR / "distrib"
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        runs = train_mesh_vs_plain("1x1", DIST_TRAIN, DEV, tmp)
        terr, bitwise, fails = train_gate(runs)
        failures += fails
        out["14b"] = {"max_abs_err": terr, "bitwise": bitwise,
                      "losses": runs["mesh"][0]}
        log("14b sharded train step", arch="smollm-360m", dtype="f32",
            steps=3, losses=[f"{x:.6f}" for x in runs["mesh"][0]],
            max_abs_err=f"{terr:.3e}", bitwise=bitwise, card=out["card"])
        bad = reshard_round_trip(runs["mesh"][2], mesh, f"{tmp}/reshard")
        if bad:
            failures.append(f"reshard round trip: leaves {bad} differ")
        out["14e"] = {"bitwise": not bad}
        del runs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    mcfg = configs.get("qwen3-moe-30b-a3b")
    mcfg = mcfg.replace(moe=dataclasses.replace(mcfg.moe,
                                                capacity_factor=8.0))
    eerr, close, scale, finite, *dropped = ep_vs_gspmd(
        mesh, mcfg, torch.bfloat16, DEV)
    failures += ep_gate(eerr, close, finite, tuple(dropped))
    out["14c"] = {"max_abs_err": eerr, "allclose": close,
                  "max_abs_out": scale, "grad_finite": finite}
    log("14c expert parallelism", arch="qwen3-moe-30b-a3b", d=mcfg.d_model,
        experts=mcfg.moe.num_experts, top_k=mcfg.moe.top_k,
        tokens=DIST_MOE_X[0] * DIST_MOE_X[1], dtype="bf16",
        max_abs_err=f"{eerr:.3e}", max_abs_out=f"{scale:.3e}",
        allclose_2e2=close, grad_finite=finite, card=out["card"])
    bad = compressed_vs_rounding(DEV)
    if bad:
        failures.append(f"compressed all-reduce: {bad} not bitwise")
    out["14d"] = {"bitwise": not bad}
    out["seconds"] = time.perf_counter() - t0
    report["distrib"] = out
    log("14 distrib", reshard_bitwise=out["14e"]["bitwise"],
        compressed_bitwise=not bad, seconds=f"{out['seconds']:.1f}",
        card=out["card"])
    if failures:
        raise AssertionError(f"phase 14 failed: {failures}")
    return {"sharded_logits": sharded}


# ---------------------------------------------------------------------------
# phase 15: the dry run on the card's host, its predictions on the card,
# remat on the card
# ---------------------------------------------------------------------------

# 15a: the dry run's cells on a production mesh (pod1, or pod2: 2 x 16 x
# 16 over 512 fake ranks), each a process; pod2's smollm-360m train_4k
# peak per rank must not pass pod1's (ROADMAP C15)
DRY_CELLS = (("smollm-360m", "train_4k", "pod1"),
             ("smollm-360m", "prefill_32k", "pod1"),
             ("smollm-360m", "decode_32k", "pod1"),
             ("qwen3-moe-30b-a3b", "decode_32k", "pod1"),
             ("smollm-360m", "train_4k", "pod2"))
# 15b: smollm-360m at full width, one fused AoT task: (kind, batch, seq)
DRY_CARD = {"prefill": ("prefill", 4, 4096), "train": ("train", 4, 2048)}
DRY_TIMED = 3               # timed calls after one warm-up
ARG_TOL = (0.01, 2 * 2 ** 20)   # predicted argument bytes: 1% + 2 MiB
REMAT_BATCH = (2, 512)      # 15c's float32 train step, 3 steps
# 15b's prediction: build_cell on a 1 x 1 mesh over a fake group of one
DRY_PREDICT = """
import json, sys
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import init_fake_group, make_mesh
kind, b, s = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
init_fake_group(1)
mesh = make_mesh((1, 1), ("data", "model"), "cpu")
rec = dryrun.run_cell("smollm-360m", kind, mesh=mesh, verbose=False,
                      shape_override=ShapeSpec(kind, kind, s, b))
print("JSON" + json.dumps(rec))
"""


def dry_procs():
    """Start 15a's cells and 15b's predictions, each a process of its own
    with no card; returns {name: Popen}."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    out = ROOT / "chiprun_out" / "dryrun"
    procs = {}
    for arch, shape, pod in DRY_CELLS:
        procs[f"{arch} {shape} {pod}"] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--out-dir", str(out)]
            + (["--multi-pod"] if pod == "pod2" else []), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, (kind, b, s) in DRY_CARD.items():
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", DRY_PREDICT, kind, str(b), str(s)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    return procs


def dry_wait(proc, timeout=300):
    out, _ = proc.communicate(timeout=timeout)
    if proc.returncode:
        raise AssertionError(f"dry run failed (rc {proc.returncode}):\n"
                             f"{out[-3000:]}")
    return out


def dry_cells_line(procs, card):
    """15a: each cell's record: per-rank argument and peak GB, FLOPs and
    bytes, collectives by kind, the three roofline terms. Returns (the
    records, the failures of the pod2 <= pod1 peak gate)."""
    recs = {}
    for arch, shape, pod in DRY_CELLS:
        dry_wait(procs[f"{arch} {shape} {pod}"])
        rec = json.loads((ROOT / "chiprun_out" / "dryrun" /
                          f"{arch}__{shape}__{pod}.json").read_text())
        m, r = rec["memory"], rec["roofline"]
        log(f"15a dryrun/{arch}/{shape}/{pod}", mesh="x".join(map(str,
                                                          rec["mesh"])),
            args_gb=f"{m['argument_bytes'] / 1e9:.3f}",
            peak_gb=f"{m['peak_bytes'] / 1e9:.3f}", fits=rec["fits"],
            flops=f"{rec['flops_per_device']:.4e}",
            bytes=f"{rec['bytes_per_device']:.4e}",
            collectives={k: int(v["count"])
                         for k, v in rec["collectives"].items()},
            compute_ms=f"{r['compute_s'] * 1e3:.3f}",
            memory_ms=f"{r['memory_s'] * 1e3:.3f}",
            collective_ms=f"{r['collective_s'] * 1e3:.3f}",
            run_s=f"{rec['run_s']:.1f}", card=card)
        recs[f"{arch}/{shape}" + ("/pod2" if pod == "pod2" else "")] = rec
    peaks = [recs[k]["memory"]["peak_bytes"]
             for k in ("smollm-360m/train_4k/pod2", "smollm-360m/train_4k")]
    log("15a dryrun/C15", pod2_peak_gb=f"{peaks[0] / 1e9:.3f}",
        pod1_peak_gb=f"{peaks[1] / 1e9:.3f}", required="pod2 <= pod1",
        card=card)
    bad = [] if peaks[0] <= peaks[1] else [
        f"C15: pod2's train_4k peak {peaks[0]} passes pod1's {peaks[1]}"]
    return recs, bad


def requested_bytes() -> int:
    """The bytes the caching allocator's live allocations asked for
    (``memory_allocated`` counts whole blocks: a large block keeps a
    remainder of up to 1 MiB that it does not split off)."""
    return torch.cuda.memory_stats().get("requested_bytes.all.current", 0)


def cuda_ms(fn, iters: int) -> float:
    """Median ms of ``fn()`` between CUDA events, after one warm-up."""
    fn()
    times = []
    for _ in range(iters):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return median(times)


def dry_on_card(name, pred, card):
    """15b: the cell ``name`` of DRY_CARD built as the dry run builds it,
    its specs made real on the card: the bytes the arguments take (the
    allocator's requested bytes; its blocks' ``memory_allocated`` gain
    beside them) against the prediction (gated), the call's peak against
    the predicted peak (reported), and its ms (reported) against two
    bounds at the data sheet's rates: the roofline of the function,
    max(model FLOPs / bf16 peak, (arguments read once + outputs written
    once) / HBM rate), which no implementation changes, and the eager
    count's, max(counted FLOPs / bf16 peak, counted bytes / HBM rate),
    whose bytes are eager PyTorch's unfused traffic (the share of it is
    how fast the eager ops move their own bytes, not closeness to the
    card's roofline). Returns (record, failures)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun, specs as sp
    from repro_torch.roofline import HW_H100
    kind, b, s = DRY_CARD[name]
    fn, args, *_ = dryrun.build_cell(
        "smollm-360m", kind, shape_override=ShapeSpec(kind, kind, s, b),
        mesh=None, device=DEV)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before, asked = torch.cuda.memory_allocated(), requested_bytes()
    real = sp.materialize(args, DEV)
    torch.cuda.synchronize()
    got = requested_bytes() - asked
    blocks = torch.cuda.memory_allocated() - before
    want = pred["memory"]["argument_bytes"]
    failures = []
    if abs(got - want) > ARG_TOL[0] * want + ARG_TOL[1]:
        failures.append(f"{name}: arguments take {got} bytes, predicted "
                        f"{want}")
    torch.cuda.reset_peak_memory_stats()
    fn(*real)
    torch.cuda.synchronize()
    peak_blocks = torch.cuda.max_memory_allocated() - before
    peak = torch.cuda.memory_stats()["requested_bytes.all.peak"] - asked
    out_bytes = pred["memory"]["output_bytes"]
    ms = cuda_ms(lambda: fn(*real), DRY_TIMED)
    flops_rate, hbm = HW_H100["peak_flops"], HW_H100["hbm_bw"]
    model_ms = pred["roofline"]["model_flops_total"] / flops_rate * 1e3
    least_ms = (want + out_bytes) / hbm * 1e3
    bound = max(model_ms, least_ms)
    eager = max(pred["flops_per_device"] / flops_rate,
                pred["bytes_per_device"] / hbm) * 1e3
    rec = dict(batch=b, seq=s, args_bytes=got, args_blocks=blocks,
               args_predicted=want, out_bytes=out_bytes,
               peak_bytes=peak, peak_blocks=peak_blocks,
               peak_predicted=pred["memory"]["peak_bytes"],
               ms=ms, bound_ms=bound,
               bound_by="operations" if model_ms >= least_ms else "bytes",
               roofline_share=bound / ms, model_ms=model_ms,
               mfu=model_ms / ms, eager_bound_ms=eager,
               eager_traffic_share=eager / ms,
               flops=pred["flops_per_device"],
               bytes=pred["bytes_per_device"])
    log(f"15b dryrun vs card/{name}", arch="smollm-360m", layers=32,
        dtype="bf16", batch=f"{b}x{s}", args_bytes=got,
        args_predicted=want, args_ok=not failures, args_blocks=blocks,
        out_bytes=out_bytes, peak_gb=f"{peak / 1e9:.3f}",
        peak_blocks_gb=f"{peak_blocks / 1e9:.3f}",
        peak_predicted_gb=f"{rec['peak_predicted'] / 1e9:.3f}",
        peak_ratio=f"{peak / rec['peak_predicted']:.3f}", ms=f"{ms:.3f}",
        bound_ms=f"{bound:.3f}", bound_by=rec["bound_by"],
        roofline_share=f"{bound / ms:.4f}",
        model_flops_ms=f"{model_ms:.3f}", mfu=f"{model_ms / ms:.4f}",
        eager_bound_ms=f"{eager:.3f}",
        eager_traffic_share=f"{eager / ms:.4f}", card=card)
    del real
    return rec, failures


def remat_on_card(card):
    """15c: smollm-360m's float32 train step (attn_impl="ref", AoT fc rank
    64, 3 steps at REMAT_BATCH) with remat on and off: the losses and the
    trainable leaves bitwise equal (gated); both peaks and both steps' ms
    (CUDA events, the mean of steps 2 and 3) reported."""
    from repro_torch import configs
    from repro_torch import tree as T
    from repro_torch.core import aot as aot_mod
    from repro_torch.core import peft as peft_mod
    from repro_torch.models.model import Model, ModelOptions
    from repro_torch.train.step import (TrainConfig, make_train_step,
                                        split_train)
    cfg = configs.get("smollm-360m")
    b, s = REMAT_BATCH
    popt = peft_mod.PEFTOptions(method="aot", aot=aot_mod.AoTOptions(
        mode="fc", rank=64, dropout=0.0))
    gen = torch.Generator(device=DEV).manual_seed(15)
    toks = torch.randint(0, cfg.vocab_size, (3, b, s + 1), generator=gen,
                         device=DEV)
    runs = {}
    for remat in (True, False):
        model = Model(cfg, ModelOptions(attn_impl="ref", remat=remat),
                      device=DEV)
        params = model.init(seed=0)
        pp = peft_mod.init(cfg, popt, seed=1, device=DEV)
        init_state, step = make_train_step(model, TrainConfig(peft=popt))
        trainable, frozen = split_train(params, pp, "aot")
        state = init_state(trainable)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        losses, times = [], []
        for t in toks:
            a, z = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            state, m = step(state, frozen, {"tokens": t[:, :-1],
                                            "labels": t[:, 1:]}, None)
            z.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(z))
            losses.append(m["loss"])
        runs[remat] = ([float(x) for x in losses],
                       [x.detach() for x in T.leaves(state["trainable"])],
                       torch.cuda.max_memory_allocated() - base,
                       sum(times[1:]) / len(times[1:]))
        del model, params, frozen, state
    same = runs[True][0] == runs[False][0] and all(
        torch.equal(x, y) for x, y in zip(runs[True][1], runs[False][1]))
    log("15c remat", arch="smollm-360m", dtype="f32", impl="ref",
        batch=f"{b}x{s}", steps=3, losses=[f"{x:.6f}" for x in runs[True][0]],
        bitwise=same, peak_gb_on=f"{runs[True][2] / 1e9:.3f}",
        peak_gb_off=f"{runs[False][2] / 1e9:.3f}",
        step_ms_on=f"{runs[True][3]:.3f}",
        step_ms_off=f"{runs[False][3]:.3f}", card=card)
    rec = dict(bitwise=same, losses=runs[True][0],
               peak_bytes={"on": runs[True][2], "off": runs[False][2]},
               step_ms={"on": runs[True][3], "off": runs[False][3]})
    return rec, [] if same else ["15c: remat on and off differ"]


def phase_dryrun(report):
    """Phase 15 (15a-15c); launches no kernel."""
    t0 = time.perf_counter()
    card = smi()
    procs = dry_procs()
    try:
        out = {"card": card}
        out["15a"], failures = dry_cells_line(procs, card)
        for name in DRY_CARD:
            pred = json.loads(dry_wait(procs[name]).split("JSON")[-1])
            out[f"15b_{name}"], bad = dry_on_card(name, pred, card)
            failures += bad
            gc.collect()
            torch.cuda.empty_cache()
        out["15c"], bad = remat_on_card(card)
        failures += bad
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    out["seconds"] = time.perf_counter() - t0
    report["dryrun"] = out
    log("15 dryrun", seconds=f"{out['seconds']:.1f}", card=card)
    if failures:
        raise AssertionError(f"phase 15 failed: {failures}")
    return {}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="stop after the build and parity phases (a first "
                         "check of new kernel code; prints no result)")
    ap.add_argument("--phase14", action="store_true",
                    help="the build, parity and phase 14 alone (a first "
                         "check of the distribution code; prints no result)")
    ap.add_argument("--phase15", action="store_true",
                    help="phase 15 alone, which launches no kernel (a "
                         "first check of the dry run on the card's host; "
                         "prints no result)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    # float32 matmuls in full float32 (no TF32), stated for the tolerances
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import ops      # noqa: F401 (fails if missing)
    t_start = time.perf_counter()
    card = smi()
    log("1 device", card=card, torch=torch.__version__,
        cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())
    report = {"card": card, "parity": {}, "times": {}}
    if args.phase15:
        phase_dryrun(report)
        print("[phase15] passed; no result")
        return 0
    report["build_s"], report["redesigned"] = phase_build(KERNEL_SOURCES)
    gen = torch.Generator(device=DEV).manual_seed(0)
    phase_parity(gen, report)
    if args.quick:
        print("[quick] stopped after parity; no result")
        return 0
    if args.phase14:
        print(f"[phase14] launches {phase_distrib(report)}; no result")
        return 0
    kernels = phase_times(gen, report)
    engine, setup_s = build_engine()
    launches = phase_main_path(report, engine, setup_s)
    launches.update(phase_whole_prompt(report, engine))
    launches.update(phase_static(report, engine))
    launches.update(phase_peft(report, engine))
    launches.update(phase_faults(report, engine))
    launches.update(phase_shared(report, engine))
    launches.update(phase_restore(report, engine))
    launches.update(phase_overload(report, engine))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    trained, kept = phase_train(report)
    launches.update(trained)
    launches.update(phase_lifecycle(report, kept))
    del kept
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(phase_encoders(report))
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(phase_decoders(report))
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(phase_moe(report))
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(phase_recurrent(report))
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(phase_frontends(report))
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(phase_distrib(report))
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(phase_dryrun(report))
    for row in kernels:     # each kernel's count on the path it serves
        row["launches"] = launches[MAIN_PATH[row["name"]]][row["name"]]
        row["launches_sampled"] = launches["paged_sampled"][row["name"]]
        row["launches_by_path"] = {path: counts[row["name"]]
                                   for path, counts in launches.items()}
        if row["launches"] < 1:
            raise AssertionError(f"{row['name']} never launched on "
                                 f"{MAIN_PATH[row['name']]}")
        if "encoder" in row:                # phase 8's path
            row["encoder"]["launches"] = launches[ENC_PATH[row["name"]]][
                row["name"]]
        if "decoders" in row:               # phase 10's path
            row["decoders"]["launches"] = launches[DEC_PATH[row["name"]]][
                row["name"]]
        if row["name"] in MOE_PATH:         # phase 11's path
            row["moe"]["launches"] = launches[MOE_PATH[row["name"]]][
                row["name"]]
        if row["name"] in REC_PATH:         # phase 12's path
            row["recurrent"]["launches"] = launches[REC_PATH[row["name"]]][
                row["name"]]
        if row["name"] in FRONT_PATH:       # phase 13's path
            row["frontends"]["launches"] = launches[FRONT_PATH[
                row["name"]]][row["name"]]
    phase_cross_check(report)
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1,
                                                        default=str))
    print(f"[done] seconds={report['seconds']:.1f}")
    print(smi())
    print(json.dumps({"kernels": kernels}, separators=(",", ":")))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
