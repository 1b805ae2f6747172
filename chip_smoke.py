#!/usr/bin/env python3
"""Drive the ``repro_torch`` port on one NVIDIA GPU and hold it to its kernels.

    python3 chip_smoke.py

Phases (each failure raises; the script exits non-zero and prints no result):

0. The card: ``nvidia-smi`` name and power limit, ``torch.cuda`` device name.
   No CUDA device -> exit 1.
1. Build every CUDA source of the port with ``nvcc`` (one process per
   source, all started together, and one more for the MI kernel's
   yardsticks in ``tools/mi_score_baseline.cu``: its former design and an
   empty kernel); print the build time and ``-Xptxas -v``, the register and
   spill lines of the five kernels' entries apart, and, where ``cuobjdump``
   sits next to ``nvcc``, count ``SASS_MARKS`` in their libraries:
   ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA tile loads) for flash attention,
   ``UBLKCP`` (bulk copies) and ``LDG.E.128`` for the correlation,
   ``LDG.E.128`` and ``LDG.E.64`` for the contingency count, ``LDG.E.128``
   for the bin codes, ``SHFL.BFLY`` (a table reduced across its lanes) for
   MI; a missing mark fails ("not checked" where ``cuobjdump`` is missing).
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes: contingency counts bitwise equal (int8/int16/int32, the
   class-fused conditional target, a ragged row count, injected negatives and
   sentinels, int32 codes of 16 bins, timed at the binned fits' V*C = 32
   and 256); every path ``contingency_plan`` and ``bin_codes_plan`` pick,
   forced where the main path does not reach it (the scalar width, shared
   tables, global atomics; 4, 2 or 1 features per lane, E > 64), bitwise
   against the plain versions (five dtypes x both layouts x 4/8/32/256 cells,
   unaligned views, 300,000 equal rows); MI within ``rtol=1e-5, atol=1e-6``
   at ``MI_SHAPES`` in int32 and float32 (the main path's tables, an odd
   shape, V=300 and V=13,000) and through the strided class-major view of
   conditional stacks, all-zero tables exactly 0, equal tables bit-equal;
   bin codes bitwise equal
   to the plain version and to the host binner (``QuantileBinner.transform``)
   at 65,536 x 1000 and a ragged 65,499 rows, E of 15 and 63, values planted
   on edges, and NaN (code E), +-inf and -0.0 on every bin-code path; row
   correlations within ``rtol=2e-4, atol=2e-5`` at 50,000 x
   10,000 rows against T=1 and T=4, with a constant row and through the
   ``X.T`` view.  Times with CUDA events (and, for the contingency and
   bin-code kernels, the kernel's own device time from ``torch.profiler``,
   without the wrapper's memset and launch): kernel, plain version, the
   byte/operation bound and a library yardstick (contingency:
   ``torch.bincount`` on the fused index, also for the class-fused
   conditional count; bin codes: one ``torch.searchsorted`` on the
   feature-major transpose, and beside it one device copy of the same
   bytes, what reading and writing them takes on the card; correlation: ``torch.matmul`` of pre-standardised
   rows, the product only).
3. Tall (the paper's Fig. 5/6 point): CorrAL 1,000,000 x 1000 int8, L=10,
   ``mid``.  The in-memory fit (plans ``conventional``), the streaming fit
   over ``ArraySource`` at ``block_obs=65536`` and the in-memory fit with the
   plain versions (``use_kernel=False``) must select the same features, the
   first nine being {0..8}; the streaming ledger must read 10 passes and 160
   blocks.  One more (warm) in-memory fit under ``torch.profiler``: device
   time by kernel and the device's busy share (also in phase 4).
4. Wide (the repo's scaled Fig. 7 point): CorrAL 10,000 x 50,000, L=10,
   plans ``alternative``; kernels and plain versions select the same.
5. Tall continuous (the Fig. 5/6 point with continuous values):
   ``continuous_dataset_np(1_000_000, 1000)`` float32, ``bins=16``, L=10,
   ``mid``.  The fingerprint and the sketch pass run once, timed apart
   (``fit_binned``; every fit below reuses the memoised binner), and so does
   the host binner's ``transform`` of one 65,536-row block, the work the
   device encode replaces.  (a) the
   streaming fused fit at ``block_obs=65536``, (b) the in-memory binned fit
   (host sketch, device encode), (c) (b) with the plain versions must select
   the same, first pick in {0, 8}; (a)'s ledger reads 10 passes, 160 blocks
   and the float blocks' bytes.
6. Wide continuous (the scaled Fig. 7 point, continuous):
   ``continuous_dataset_np(10_000, 50_000)``, L=8, plans ``alternative`` with
   ``PearsonMIScore``; kernel and plain versions select the same, first pick
   in {0, 8}.  Two more (warm) kernel fits: one on the host clock, one under
   ``torch.profiler``, whose device-only activities (kernels, copies) are
   printed by name with their share of the traced fit's wall time.
7. Yi-6B serve (the LM side, at the published widths and depth): random
   bf16 weights from a seeded generator on the card (~6.06e9 parameters),
   ``ServeEngine.serve`` of 8 greedy requests, 32 new tokens each, in two
   waves (4 prompts of 1000 tokens, 4 of 2048), prefill attention through
   the flash-attention kernel (32 launches per wave, one per layer).  Each
   of the 64 prefill attentions of a kernel run is held to the plain version
   on that layer's own q, k and v, within phase 2's bf16 tolerances (the
   per-row one included).  Held against the plain attention
   (``use_kernel=False``) on the same weights and prompts:
   last-position prefill logits within the bf16 model's own
   rounding error (the plain bf16 logits against float32 logits of the same
   weights), greedy tokens equal up to the first step whose plain top-1 /
   top-2 margin is below twice the logits error; then the 2048-token wave in
   float32 (24 GB of weights), whose kernel and plain tokens must be equal.

8. Out of core (the I/O knobs, the file sources and the service), every
   temporary file and spill directory under one directory removed at the
   end: (a) the tall fit of phase 3 as ``MRMRSelector(10, score=MIScore(2,
   2), block_obs=65536, spill_dir=..., readahead=4).fit(ArraySource(X, y))``:
   the same selection as phase 3's streaming fit, 10 passes and 160 blocks,
   one parse and nine replay passes, 160 contingency launches (all int8,
   V=2, C=2) and MI launches; the same fit again parses nothing (ten
   replays), and once more under ``torch.profiler`` (the device's busy
   share).  (b) the first ``BINNED_SPILL_BLOCKS`` (4) blocks of phase 5's
   continuous data with ``bins=16`` and ``spill_dir``: the staging pass
   encodes on the host and spills int8 codes, the replays count them: the
   same selection as the unspilled streamed fit of the same rows (the device
   encode), 0 bin-code launches, 40 contingency launches on int8 codes
   (V=16, C=2 and 16), the spilled bytes; one replayed 65,536 x 1000 code block
   read back as a replay (a memmap, one replay pass and no parse), counted
   bitwise against the plain version and timed at C=2 and 16.  (c) the
   first ``CSV_ROWS`` (125,000) rows of the tall data written as CSV with
   numpy byte operations (about 0.25 GB of text) and fitted through
   ``CSVSource(dtype=int8, target_dtype=int8)`` with ``spill_dir`` and
   ``readahead=4``: the selection and gains of an in-memory fit of the same
   rows, one parse pass and nine replays, each pass's seconds.
   (d) ``SelectionService(workers=2, device="cuda")`` over
   ``corral:1000000x1000`` with ``spill_dir``: two identical requests at
   once run the engine once (one coalesces; (10 + 5) x 16 contingency
   launches with the distinct request), a distinct request (L=5) runs in
   the other worker meanwhile, a third identical request is a cache hit
   that launches nothing; the results equal a direct streamed L=10 fit of a
   fresh source with no spill cache (the L=5 request its first five picks).  (e) ``mrmr_custom_score(MIScore(2, 2))`` on
   CorrAL 10,000 x 5,000, the alternative encoding, ``get_result`` vmapped
   over candidate chunks: one contingency and one MI launch a chunk for the
   relevance and as many for the redundancy, every pick; the selection of
   ``MIScore`` and of the same score in plain torch, one pick's scores
   against the plain version's, a NaN relevance.
   Each fit logs its seconds and each streamed pass's seconds.
9. Multi-process map-reduce (``python -m repro_torch.launch.select_multihost
   --device cuda`` in spawn mode: N worker processes started with
   ``subprocess``, each with its own CUDA context on the one card, gloo
   collectives on the host; ``MRMRSelector(hosts="auto")`` in each).  The
   data is written with ``np.save`` under phase 8's temporary directory and
   each worker memmaps it and reads only its shard: (a) phase 3's tall
   arrays, 2 workers, grid (2, 1), L=10 ``mid``, held to phase 3's streaming
   fit; (b) CorrAL 10,000 x 50,000, 2 workers, grid (1, 2), L=10, q=2,
   ``--spill-dir`` (one spill entry each for ``h0`` and ``h1``); (c) CorrAL
   40,000 x 40,000, 4 workers, grid (2, 2) by the automatic rule, L=5
   ``jmi``.  (b) and (c) are held to a one-process streaming fit of the
   same arrays on the card.  Each run: the same selection and bitwise the
   same gains and passes, every worker on the card with the contingency and
   MI launches reckoned from the engine (``expected_worker_launches``) and
   within 1/N +- 5% of the aggregate bytes; the wall seconds, the slowest
   worker's fit and each worker's ``io["hosts"]`` row are printed.  A run of
   N processes on one card is N contexts time-sliced on one device, not
   cluster scaling: no gain is claimed from it.  Then kernel 2 (the
   class-fused count) at (c)'s redundancy block, with and without its
   appended target column.
10. The in-process device mesh (``MRMRSelector(mesh=...)``, meshes of 2 or
   4 positions, every one ``cuda:0``: the shards run one after another on
   one stream).  (a) phase 3's tall arrays on (4,) ``data``, L=10; (b) phase
   4's wide arrays on (4,) ``model``; (c) phase 9's 40,000 x 40,000 arrays,
   ``jmi`` L=5, on a (2, 2) grid (16 class-fused counts); (d) phase 3's
   arrays streamed at 65,536 rows on (2,) ``data``; (e) phase 4's arrays
   streamed at 10,000 rows on (2,) ``model``, the state feature-sharded;
   (f) phase 6's continuous arrays, Pearson, on (2,) ``model``, L=8; (g)
   phase 5's continuous arrays, ``bins=16``, streamed at 65,536 rows on (3,)
   ``model``, L=4 (the fitted edges cut into three feature shards, 1000
   columns padded to 1002 with +inf edge rows; each tile encoded on its
   position once a block; held to the first 4 picks and gains of phase 5's
   streamed fit).  Each is held to the one-device card fit of the same
   data: the same picks,
   bitwise the same MI gains (Pearson within ``CORR_RTOL``/``CORR_ATOL``),
   the launches reckoned from the engine (``expected_mesh_launches``); (a)
   is traced warm (device busy share).  Then the per-shard kernel shapes:
   the count at 250,000 x 1000 (a (4,) data shard), 32,768 x 1000 (half a
   streamed block), the 10,000 x 12,500 column windows of (b) at columns 0
   and 12,500 (each also with the L2 flushed before every call), kernel 2
   at a 20,000 x 20,000 grid tile of (c), and the bin-code kernel at (g)'s
   last tile, 65,536 x 334 with two +inf edge rows, held bitwise to its
   plain version.

11. The other LM families, each at its published widths with random bf16
   weights from seed 0 (JAX init scales), freed before the next: (a)
   dbrx-132b cut to 4 of 40 layers (G = 6), phase 7's traffic (waves of 4 x
   2048 and 4 x 1000 tokens, 32 new tokens); (b) llama4-scout cut to 2 of 48
   layers (sigmoid top-1 routing, the shared expert, G = 5), one 4 x 2048
   wave.  Both through ``serve_and_hold`` (phase 7's checks: kernel and
   plain runs, every prefill attention held to the plain version on its own
   q, k, v, tokens by the margin rule); layer 0's MoE on the first wave:
   the slots dropped at the published capacity factor (1.25), and 1024 of
   its tokens in float32 with the factor raised to E / k against
   ``moe_dense_reference`` within ``MOE_REL_TOL``.  (c) mamba2-1.3b whole
   (48 layers, no kernel): waves of 4 x 2048 and 4 x 1024 (whole 256-token
   chunks), layer 0's chunked SSD in float32 against the token-by-token
   recurrence on its own inputs (``SSD_REL_TOL`` of the largest output), and
   in float32 prefill of 255 tokens plus one step against prefill of 256
   (``DECODE_REL_TOL``).  (d) jamba's smoke config (a full-width superblock
   is 90.3 GB) in bf16 (margin rule) and float32 (tokens equal).  (e)
   qwen2-vl-2b whole: a prefill from 4 x 2048 embeddings whose first 1024
   positions carry an image grid, (t, h, w) = (0, i // 32, i % 32), then
   32 greedy steps, kernel against plain (attentions held, margin rule);
   then a 4 x 2048 text wave through ``serve_and_hold``.  (f) whisper-tiny
   whole: 4 x 1500 frame embeddings, a 4-token decoder prompt and 32 greedy
   steps (``EncDecLM.greedy``), 4 + 4 + 4 flash launches a prefill (encoder,
   decoder, cross-attention), each held to the plain version, in bf16 and
   float32 (tokens equal).  Each logs parameters, weight bytes, prefill
   seconds a wave, decode ms a step and flash launches a prefill.

12. Training: qwen1.5-0.5b at its published widths and depth (24 layers,
   619,570,176 parameters), random float32 masters from seed 0, bf16
   compute, ``remat="full"``, AdamW float32 moments, warmup-cosine.  (a)
   step 0's loss and six gradient leaves in bf16 compute against float32
   compute (``TRAIN_LOSS_RTOL``, ``TRAIN_GRAD_REL_L2``); (b) 10 steps of
   ``make_train_step`` on ``ShardedDataPipeline`` batches of 8 x 2048 tokens
   with the launch counts zeroed just before and read just after (every
   count must be 0: training attends through plain PyTorch, the flash
   kernel has no backward), the loss lower after them, the peak memory
   under ``TRAIN_PEAK_LIMIT``; step ms, tokens/s and the share of the
   step's bound (``train_step_bound``); one more step traced (busy share,
   time by kernel); (c) (run beside phase 15 (d)) ``python -m repro_torch.launch.train`` twice at
   once, 2 of 24 layers, 4 steps of 2 x 256 tokens, one with ``--fail-at-step 3``: the same
   losses and, restored from their step-4 checkpoints, bitwise the same
   state; the serve command line's ``main`` with ``--ckpt-dir``, in this
   process, decoding from the uninterrupted run's checkpoint.  Its files go under one
   ``tempfile.mkdtemp()`` directory, removed at the end.
13. Model parallelism for serving, on meshes of positions of ``cuda:0``
   (they run one after another: the path and its cost, not scaling).  (a)
   Yi-6B whole in bf16, phase 7's 8 requests, served on one device (the
   reference) and, ``shard_params`` onto ``(1, 4)`` ``("data", "model")``
   positions, tensor parallel: each position's heads through the flash
   kernel (256 launches: 2 waves x 32 layers x 4 positions, each held to
   the plain version on its own q, k, v), ``wo`` and ``down`` row parallel
   with psums, the vocabulary split; the float32-compute last prefill
   logits within ``MESH_F32_TOL`` of one device's, the bf16 ones under
   phase 7's bf16-vs-float32 error, tokens by the margin rule.  (b) dbrx, 4
   of 40 layers, bf16, on ``(2, 2)``: the batch over ``data``, sequence
   chunks and experts over ``model`` (all-to-alls), the experts' d_ff on
   ``data``; held the same way to a one-device run whose MoE layers run
   ``moe_blockwise_reference`` (32 flash launches); layer 0's dropped slots
   a block beside the whole wave's.  (c) ``pipeline_apply`` over 4
   positions: ``PIPE_STAGES`` stages of ``tanh(h @ W + b)`` with 1, 2, 4
   and 8 microbatches, each microbatch bitwise the fold of its rows, the
   whole within ``PIPE_TOL`` of the whole batch's fold, seconds each.  (d) ``python -m repro_torch.launch.serve --preset full --arch
   qwen1.5-0.5b`` with ``--model-parallel 2`` (``REPRO_DEVICES=4``) and
   ``1``, at once: their tokens by the margin rule (the one-device margins
   from the same model and prompts rebuilt in process).  Flash timed at the positions' shapes
   (B=4, S=T=2048, H=8, KV=1 and B=2, S=T=2048, H=24, KV=4).

14. Training on a model mesh of ``MESH_TRAIN_MESH`` = (2, 2) positions of
   ``cuda:0`` (the path, its launches and copies; not scaling).  (a)
   qwen1.5-0.5b at its published widths and depth: one step in float32
   compute on the mesh and on one device from the same weights and batch
   (4 x 2048), the loss within ``TRAIN_LOSS_RTOL`` and the gradient leaves
   of ``TRAIN_GRAD_LEAVES`` by ``TRAIN_GRAD_REL_L2``; then 5 steps of
   ``make_train_step(mesh=)`` in bf16 compute (float32 masters, remat
   full) on ``ShardedDataPipeline.shards_at`` with the launch counts zeroed
   just before and read just after (all 0: no flash kernel in training),
   step ms, tokens/s, peak memory, one step traced.  (b) llama4-scout at
   its published widths, 1 of 48 layers (experts over ``model``, their
   d_ff over ``data``, bf16 moments), 2 x 2048: the float32-compute loss,
   aux loss and router gradient against a one-device run through
   ``moe_blockwise_reference``, dispatch slots routed otherwise and slots
   dropped a block, then 3 bf16 steps (the state donated), all launch
   counts 0.  (c) ``python
   -m repro_torch.launch.train --model-parallel 2`` with
   ``REPRO_DEVICES=4``, 2 of 24 layers, twice at once (one with
   ``--fail-at-step 3``): the same losses and bitwise the same final
   checkpoint, restored by ``elastic_restore`` onto (1, 4) positions and
   onto one device bitwise; it runs beside phase 15 (d)'s command lines.

15. The SSM, hybrid and encoder-decoder families on a model mesh of
   positions of ``cuda:0``.  (a) mamba2-1.3b whole: served in bf16 on
   (1, 4) (16 SSM heads and 1024 channels a position, phase 11's waves)
   through ``mesh_serve`` (the one-device run first; the tokens by the
   margin rule, the float32-compute logits within ``MAMBA_F32_REL`` of
   their largest magnitude, as the one-device ones are of a float64
   witness; no kernel), one decode step traced (its kernel launches); then trained on
   (2, 2), 4 x 2048 tokens, through ``mesh_train_family``: a float32 step
   on the mesh and on one device (the loss within ``TRAIN_LOSS_RTOL``, the
   leaves of ``MAMBA_GRAD_LEAVES`` by ``TRAIN_GRAD_REL_L2``), then 3 bf16
   steps with the launch counts zeroed (all 0), step ms, tokens/s, the
   share of ``mamba_step_bound``, peak memory, one step traced.  (b)
   whisper-tiny whole on (2, 2): 8 requests of 1500 frames and a 4-token
   prompt, 32 greedy tokens, bf16 and float32, flash once a position a
   layer of each of its three attentions (48 a prefill), each held to the
   plain version on its own q, k, v, the float32 tokens equal to one
   device's; trained on 8 x (1500 frames, 448 tokens).  (c) jamba's smoke
   superblock on (2, 2) and (1, 4) through ``mesh_serve`` (the reference's
   MoE layers run ``moe_blockwise_reference``), trained on (2, 2) (the
   float32 loss, aux and a router's gradient against the blockwise run).
   (d) ``launch.serve --model-parallel 2`` on mamba2 (phase 13 (d)'s
   check) and ``launch.train --model-parallel 2`` at 2 of its 48 layers
   (phase 14 (c)'s).  Flash timed at whisper's per-position shapes (B=4,
   S=T=1500 and S=4, T=1500, H=KV=3, D=64, non-causal).

16. The dry run's accounting (``repro_torch.analysis.op_analysis``) held
   to the card.  (a) phase 12's qwen1.5-0.5b step (8 x 2048, float32
   masters, bf16 compute, remat full) counted once on the card and once on
   ``meta`` tensors: flops and bytes equal (op by op: a difference names
   the op), the ``meta`` arguments equal the card's ``TrainState`` and
   batch bytes, the ``meta`` peak within ``DRYRUN_PEAK_BAND`` of
   ``torch.cuda.max_memory_allocated`` over the counted card step (reset
   just before), and the roofline bound at the H100 rates no larger than
   the measured step (its share printed beside the hand-worked bound).
   (b) yi-6b whole on (1, 4) positions of ``cuda:0`` (phase 13's path),
   one 2048 prefill wave and one decode step counted on the card and on a
   (1, 4) mesh of ``meta`` positions: each collective kind's count and
   operand bytes equal, the flash kernel's charge equal to its launches
   (128 a wave, counted) times its per-launch count.  (c) the dry run's
   command line (``repro_torch.launch.dryrun.main``, in this process) for
   one production cell (qwen1.5-0.5b
   ``decode_32k`` at 2 of its 24 layers, (16, 16) ``meta`` positions): its
   seconds and roofline line.
17. The meshed caches in JAX's ``_cache_specs`` layout: (a) Yi-6B
   whole in bf16 on (1, 8) positions of the card, where its 4 KV heads do
   not divide and each position holds all 4 heads of its eighth of the
   sequence: 4 prompts of 2048 tokens, 8 new tokens (a cache of 2056
   slots, 257 a position), served on one device and on the mesh (path
   ``yi6b_seq_tp8_serve``: 256 flash launches a wave, each prefill
   attention held to the plain version on its own q, k, v), the meshed
   tokens held to one device's by the margin rule, the error being the
   larger of the last prefill logits' and the first decode step's; each
   position's cache bytes exactly 1/8 of the whole, printed beside the
   former layout's (the whole sequence at 4 repeated heads); decode ms a
   step, kernels a traced step, peak memory.  (b) The same weights on (2,
   4), one row of 8192 tokens: the batch does not divide ``data``, so the
   batch is replicated and the sequence goes over ``data`` and the heads
   over ``model`` (path ``yi6b_seq_data_serve``), held the same way.  (c)
   The five ``examples/*_torch.py`` on the card as subprocesses, at most
   two at once: each one's seconds and exit code; a nonzero exit fails.
   Between (b) and (c), flash at the two positions' shapes (B=4, S=T=2048,
   H=KV=4 after the repeat; B=1, S=T=8192, H=8, KV=1) against the plain
   version, timed.

After phase 10 the MI kernel is timed at the table shapes of the main
paths and of ``jmi``/``cmim`` (1000 x 2 x 2, 50,000 x 2 x 2, 1000 x 16 x 2,
1000 x 16 x 16, the class-major view of a 1000 x 2 x 2 x 2 stack, phase 9's
20,001 x 2 x 2 and the class-major view of its 20,001 x 2 x 2 x 2 stack,
phase 10's 12,500 x 2 x 2, 20,000 x 2 x 2 and class-major 20,000 x 2 x 2 x 2,
the custom path's 279 x 1 and 279 x 5 stacks of 2 x 2 tables): CUDA
events and its own device time, the former design's on the same inputs, an
empty kernel launched through the same ctypes path (the launch floor), the
plain version, the bound (bytes, or ~10 instructions a cell and a logarithm a
nonzero cell at the SFU rate) and the shape's launches on the main paths.

Phase 2 also holds the flash-attention kernel to its plain version at the
serve shapes (B=4, S=T=2048 and the ragged 1000, H=32, KV=4, D=128, bf16),
a long prompt (B=1, S=T=8192), MHA, S=1, a ragged S, S < T causal and
non-causal, and phase 11's shapes (H=48 / 40 / 12 over KV=8 / 8 / 2 at
S=T=2048, whisper's non-causal encoder at S=T=1500 and its cross-attention
of 4 tokens against 1500 frames, H=KV=6, D=64; G = 6 and 5 and the
cross-attention in float32 too): float32 within ``rtol=2e-5, atol=2e-5``, bf16 within
``rtol=3e-2, atol=3e-2`` and, for every dtype, each output row
(``(b, s, h)``, L2 over D) within a relative error of ``1e-2``; it times
the kernel, the plain version and one ``scaled_dot_product_attention(
is_causal=True, enable_gqa=True)`` call (the library yardstick, which the
port never calls).  The flash and correlation timings also print their
share of the bound (bound ms over kernel ms).

Each main-path fit runs with the kernels' launch counts set to 0 just before
it and read just after: an in-memory fit of L=10 counts 10 contingency
launches (1 relevance + 9 folds; no fold follows the last pick), the
streaming fit 160 (10 passes x 16 blocks), and every fit launches the MI
kernel; the streaming binned fit encodes each of its 160 blocks once, the
in-memory binned fit encodes X once, and the wide Pearson fit launches the
correlation kernel 8 times (1 relevance + 7 folds); the Yi-6B serve
launches the flash-attention kernel 64 times (2 waves x 32 layers), phase
12's and phase 14's training none, and each phase-11 path once an attention layer a prefill (dbrx 4 a wave,
llama4 2, jamba 1, qwen2-vl 28, whisper 12; mamba2 none), each phase-13
path once a position an attention layer a prefill (yi-6b 128 a wave, dbrx
16), phase 15's likewise (whisper 48, jamba 4 a wave; mamba2 and every
training path none), phase 16 (b)'s 128 (one wave), phase 17's 256 a wave
on (1, 8) and on (2, 4); each
spilled fit of phase 8 counts its blocks (160; the binned one 40) and launches no bin-code kernel,
the service run counts its blocks once per engine run, and the custom-score
fit launches each of the contingency and MI kernels twice a chunk a pick;
each phase-9 worker zeroes its counts just before its fit and reads them
just after, and a run's launches are the sum over its workers; each
phase-10 mesh fit counts one contingency launch a shard (a tile) a pass or
block and one MI launch a feature group a pass (two on a conditional pass),
and (g) one bin-code launch a tile a block.  The
second-to-last line is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s, the SMs'
# 32-bit non-tensor rate for the integer compare-and-count and float work,
# and the dense bf16 tensor-core rate (attention's products in bf16).
# The float32 rate counts a fused multiply-add as two operations; work that
# is one instruction per operation (a compare, an add) issues at half of it.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
SCALAR_INSTR_PER_S = SCALAR_OPS_PER_S / 2
# Special-function results (a logarithm is priced as one): 16 per SM and
# clock, 132 SMs at the 1.98 GHz the float32 peak above assumes.
SFU_PER_S = 132 * 16 * 1.98e9
BF16_OPS_PER_S = 989e12
RTOL, ATOL = 1e-5, 1e-6
# Row correlations: float32 sums over M in another order (tests/test_kernels.py:83).
CORR_RTOL, CORR_ATOL = 2e-4, 2e-5


def log(*parts):
    print(*parts, flush=True)


def kernel_wrappers() -> dict:
    """name -> the wrapper whose ``launches`` counter each path reads."""
    from repro_torch.kernels.binning import bin_codes_cuda
    from repro_torch.kernels.contingency import contingency_tables_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.mi_score import mi_scores_cuda
    from repro_torch.kernels.pearson import pearson_corr_cuda

    return dict(contingency_tables=contingency_tables_cuda, mi_scores=mi_scores_cuda,
                bin_codes=bin_codes_cuda, pearson_corr=pearson_corr_cuda,
                flash_attention=flash_attention_cuda)


def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, name_part: str, reps: int = 5, flush: bool = False) -> float | None:
    """The kernel's own device time per launch (ms) under ``torch.profiler``:
    the self device time of activities whose name contains ``name_part``
    over ``reps`` calls, divided by the launches the trace recorded (it can
    miss one).  Unlike ``cuda_ms`` it leaves out the wrapper's memset, casts
    and launch gaps.  ``flush`` writes 256 MiB (five times the L2) before
    each call, so no call reads what the one before left in the L2.  None if
    the trace shows none."""
    from torch.profiler import ProfilerActivity, profile

    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda") if flush else None
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace can come back empty; try again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush:
                    scratch.zero_()
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if name_part in e.key and e.self_device_time_total > 0]
        launches = sum(e.count for e in rows)
        if launches:
            return sum(e.self_device_time_total for e in rows) / 1e3 / launches
    return None


def bound(nbytes: int, ops: int, ops_per_s: float = SCALAR_OPS_PER_S) -> tuple[float, str]:
    """Least time (ms) the card could take: bytes over HBM rate vs
    operations over their peak rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bincount_tables(X, y, v, c):
    """Library yardstick: one ``torch.bincount`` over the fused index."""
    f = X.shape[1]
    idx = (torch.arange(f, device=X.device) * v + X.long()) * c + y.long()[:, None]
    counts = torch.bincount(idx.reshape(-1), minlength=f * v * c)
    return counts.reshape(f, v, c).to(torch.int32)


def phase0() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device 0: {torch.cuda.get_device_name(0)}; "
        f"{torch.cuda.device_count()} device(s)")
    return smi


# SASS instructions that show each redesigned kernel is built as designed:
# flash attention's wgmma (HGMMA) fed by TMA tile loads (UTMALDG); the
# correlation kernel's bulk row copies (UBLKCP) and 128-bit global loads; the
# contingency kernels' 128- and 64-bit loads (16-byte words, and 8-byte words
# on 1000-byte rows); the bin-code kernels' 128-bit loads; the MI kernel's
# butterfly shuffles (a table reduced across its lanes).
SASS_MARKS = {"flash_attention": ("HGMMA", "UTMALDG"), "pearson": ("UBLKCP", "LDG.E.128"),
              "contingency": ("LDG.E.128", "LDG.E.64"), "bin_codes": ("LDG.E.128",),
              "mi_score": ("SHFL.BFLY",)}


def sass_check(libs) -> dict:
    """Count SASS_MARKS in each library with ``cuobjdump`` (next to ``nvcc``);
    fails if any mark is missing."""
    from repro_torch.kernels import _build

    tool = pathlib.Path(_build.nvcc()).parent / "cuobjdump"
    if not tool.exists():
        log("[sass] cuobjdump not found next to nvcc: not checked")
        return {}
    counts = {}
    for name, marks in SASS_MARKS.items():
        sass = subprocess.run([str(tool), "-sass", str(libs[name])], capture_output=True,
                              text=True, check=True).stdout
        counts[name] = {m: len(re.findall(rf"\b{re.escape(m)}", sass)) for m in marks}
        log(f"[sass] {name}: {json.dumps(counts[name])}")
    missing = {n: [m for m, k in c.items() if k == 0] for n, c in counts.items()}
    if any(missing.values()):
        raise AssertionError(f"SASS lacks the designed instructions: {missing}")
    return counts


BASELINE_SRC = ROOT / "tools" / "mi_score_baseline.cu"


class Baseline:
    """The yardsticks of ``tools/mi_score_baseline.cu``: the MI kernel's
    former design (one thread per table), called as its wrapper called it,
    and an empty kernel launched through the same ctypes path."""

    def __init__(self, path):
        import ctypes

        self.lib = ctypes.CDLL(str(path))
        P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        self.lib.mi_scores_baseline_launch.argtypes = [P, I, I64, I, I, P, P]
        self.lib.empty_launch.argtypes = [P, P]
        for fn in (self.lib.mi_scores_baseline_launch, self.lib.empty_launch):
            fn.restype = ctypes.c_int

    def mi(self, counts):
        """The former wrapper: (..., V, C) int32 or float32 counts flattened
        to a contiguous (F, V, C) stack (a copy for a strided view), then
        one launch."""
        from repro_torch.kernels import _build

        *lead, v, c = counts.shape
        flat = counts.reshape(-1, v, c).contiguous()
        out = torch.empty((flat.shape[0],), dtype=torch.float32, device=counts.device)
        err = self.lib.mi_scores_baseline_launch(
            flat.data_ptr(), 0 if flat.dtype == torch.int32 else 1, flat.shape[0], v, c,
            out.data_ptr(), torch.cuda.current_stream(counts.device).cuda_stream)
        _build.check(err, "mi_scores_baseline_launch")
        return out.view(lead)

    def empty(self, n, dev):
        """What a wrapper costs with no work: one allocation, one launch."""
        from repro_torch.kernels import _build

        out = torch.empty((n,), dtype=torch.float32, device=dev)
        err = self.lib.empty_launch(out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "empty_launch")
        return out


def phase1():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    # The yardsticks build beside the port's sources, one more nvcc at once.
    base_lib = _build.BUILD / "tools" / "libmi_score_baseline.so"
    base_lib.parent.mkdir(parents=True, exist_ok=True)
    base = subprocess.Popen([_build.nvcc(), *_build.FLAGS, "-o", str(base_lib), str(BASELINE_SRC)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        libs = _build.build_all()
        base_out, _ = base.communicate()
    finally:
        if base.poll() is None:
            base.kill()
            base.wait()
    if base.returncode != 0:
        raise RuntimeError(f"nvcc failed for {BASELINE_SRC.name}:\n{base_out}")
    log(f"[build] {len(libs)} libraries and the MI yardsticks in "
        f"{time.perf_counter() - t0:.3f} s")
    for name, out in _build.build_log.items():
        log(f"[build] {name}:\n{out}")
    for name in SASS_MARKS:  # -Xptxas -v of the redesigned kernels, entry by entry
        for line in _build.build_log.get(name, "").splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"[ptxas] {name}: {line.strip()}")
    return sass_check(libs), Baseline(base_lib)


def phase2(dev):
    from repro_torch.core.contingency import OOR
    from repro_torch.kernels import ref
    from repro_torch.kernels.contingency import contingency_tables_cuda

    rng = np.random.default_rng(0)
    M, F = 65536, 1000
    count_err = 0
    cases = [
        ("int8 V=2 C=2", torch.int8, M, 2, 2, False),
        ("int8 V=2 VC=4 (conditional)", torch.int8, M, 2, 4, False),
        ("int16 V=2 C=2", torch.int16, M, 2, 2, False),
        ("int32 V=2 C=2", torch.int32, M, 2, 2, False),
        ("int8 ragged M=65499, negatives", torch.int8, 65499, 2, 2, True),
        ("int32 negatives + 2**31-1 sentinels", torch.int32, M, 2, 2, True),
        ("int32 V=16 C=2 (binned codes)", torch.int32, M, 16, 2, False),
    ]
    for label, dtype, m, v, c, dirty in cases:
        X = rng.integers(0, v, (m, F))
        y = rng.integers(0, c, m)
        if dirty:
            X[rng.random((m, F)) < 0.03] = -1
            y[rng.random(m) < 0.03] = -5 if dtype == torch.int8 else OOR
            if dtype == torch.int32:
                X[rng.random((m, F)) < 0.03] = OOR
        Xd = torch.as_tensor(X).to(dtype).to(dev)
        yd = torch.as_tensor(y).to(torch.int32).to(dev)
        got = contingency_tables_cuda(Xd, yd, v, c)
        want = ref.contingency_tables(Xd, yd, v, c)
        diff = (got.long() - want.long()).abs().max().item()
        count_err = max(count_err, diff)
        if diff != 0 or got.dtype != torch.int32:
            raise AssertionError(f"contingency {label}: counts differ (max {diff})")
        log(f"[contingency] {label}: {m}x{F} bitwise equal")

    return count_err, phase2_mi(dev, rng)


# MI at the main path's table shapes (tall and wide passes, the binned fits'
# relevance and redundancy), the conditional stack's class slices, an odd
# shape, and tables whose marginals outgrow shared memory (global scratch).
MI_SHAPES = [(1000, 2, 2), (1000, 2, 4), (50000, 2, 2), (1000, 16, 2), (1000, 16, 16),
             (300, 5, 7), (8, 300, 40), (3, 13000, 2)]


def phase2_mi(dev, rng):
    """MI within RTOL/ATOL of the plain version at MI_SHAPES and through the
    strided class-major view of a conditional stack; all-zero tables give 0
    and equal tables bit-equal MI."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.mi_score import mi_scores_cuda

    def check(counts, label):
        got, want = mi_scores_cuda(counts), ref.mi_scores(counts)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        e = (got - want).abs().max().item()
        log(f"[mi] {label}: within rtol={RTOL} atol={ATOL}, max abs err {e:.3e}")
        return got, e

    err = 0.0
    for shape in MI_SHAPES:
        counts = torch.as_tensor(rng.integers(0, 30000, shape)).to(torch.int32).to(dev)
        counts[::11] = 0  # all-zero tables
        counts[1::11] = counts[2]  # equal tables, wherever they sit
        for dtype in (torch.int32, torch.float32):
            got, e = check(counts.to(dtype), f"{shape} {str(dtype)[6:]}")
            err = max(err, e)
            if not torch.all(got[::11] == 0):
                raise AssertionError(f"MI of an all-zero table is not 0 at {shape}")
            if not torch.all(got[1::11] == got[2]):
                raise AssertionError(f"equal tables give unequal MI at {shape}")
    for shape in [(1000, 2, 2, 2), (300, 16, 16, 2)]:  # (F, V, W, C) conditional stacks
        stack = torch.as_tensor(rng.integers(0, 30000, shape)).to(torch.int32).to(dev)
        view = stack.movedim(-1, -3)  # what cmi_from_counts hands the kernel
        got, e = check(view, f"class-major view of a {shape} stack")
        err = max(err, e)
        if not torch.equal(got, mi_scores_cuda(view.contiguous())):
            raise AssertionError(f"the strided view and its copy differ at {shape}")
    return err


def time_contingency(X, y, v, c, label, reps=10, flush=False):
    """Events, the kernel's own device time (and, with ``flush``, that time
    with the L2 flushed before each call), the plain version, the bound and
    ``bincount`` at one shape."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.contingency import contingency_tables_cuda

    m, f = X.shape
    ms = cuda_ms(lambda: contingency_tables_cuda(X, y, v, c), reps)
    plain_ms = cuda_ms(lambda: ref.contingency_tables(X, y, v, c), max(2, reps // 5), 1)
    if not torch.equal(bincount_tables(X, y, v, c),
                       contingency_tables_cuda(X, y, v, c)):
        raise AssertionError(f"bincount yardstick disagrees at {label}")
    library_ms = cuda_ms(lambda: bincount_tables(X, y, v, c), max(2, reps // 5), 1)
    device_ms = kernel_device_ms(lambda: contingency_tables_cuda(X, y, v, c), "contingency")
    nbytes = X.numel() * X.element_size() + y.numel() * y.element_size() + f * v * c * 4
    b_ms, b_by = bound(nbytes, m * f)
    rec = dict(shape=label, ms=ms, kernel_device_ms=device_ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
               library_ms=library_ms, bytes=nbytes)
    if flush:
        rec["kernel_device_ms_l2_flushed"] = kernel_device_ms(
            lambda: contingency_tables_cuda(X, y, v, c), "contingency", flush=True)
    log(f"[time] contingency {label}: {json.dumps(rec)}")
    return rec


def contingency_paths(dev) -> list:
    """Every path ``contingency_plan`` picks, forced where the main path does
    not reach it (the scalar width, shared tables, global atomics), held
    bitwise to the plain version: five dtypes x both layouts x 4, 8, 32 and
    256 cells, out-of-range values and targets, a ragged row count, unaligned
    and strided views, and a counter that would wrap if flushed late."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.contingency import (
        GLOBAL, SHARED, _forced_plan, contingency_tables_cuda)

    sms = _build.sm_count(dev)
    rng = np.random.default_rng(7)
    seen = set()

    def check(X, y, v, c, label, want=None, **force):
        plan = _forced_plan(X, v, c, sms, **force)
        got = contingency_tables_cuda(X, y, v, c, plan=plan)
        if want is None:
            want = ref.contingency_tables(X, y, v, c)
        if not torch.equal(got, want):
            diff = (got.long() - want.long()).abs().max().item()
            raise AssertionError(f"contingency {label} {force} {plan}: counts differ (max {diff})")
        seen.add((plan.path, plan.lanes_on_rows, plan.vec > 1))

    m, f = 70000, 1000  # ragged against every row range; 1000-byte int8 rows
    for dtype in (torch.int8, torch.uint8, torch.int16, torch.int32, torch.int64):
        for v, c in ((2, 2), (2, 4), (16, 2), (16, 16)):
            Xd = torch.as_tensor(rng.integers(-1, v + 1, (m, f))).to(dtype).to(dev)
            yd = torch.as_tensor(rng.integers(-1, c + 1, m)).to(torch.int32).to(dev)
            if dtype == torch.int32:
                Xd[::13, ::7] = 2**31 - 1
                yd[::17] = 2**31 - 1
            want = ref.contingency_tables(Xd, yd, v, c)
            for layout, X in (("row-major", Xd), ("feature-major", Xd.T.contiguous().T)):
                label = f"{str(dtype)[6:]} {layout} V={v} C={c}"
                for force in ({}, {"vec": 1}, {"path": SHARED}, {"path": GLOBAL}):
                    check(X, yd, v, c, label, want, **force)
            del Xd
        log(f"[contingency] {str(dtype)[6:]}: every plan path x both layouts x 4/8/32/256 "
            f"cells bitwise equal")
    X8 = torch.as_tensor(rng.integers(-1, 3, (4099, 1024))).to(torch.int8).to(dev)
    y8 = torch.as_tensor(rng.integers(-1, 3, 4099)).to(torch.int32).to(dev)
    check(X8, y8, 2, 2, "int8 1024-byte rows")  # 16-byte loads on row-major int8
    check(X8[1:, 8:], y8[1:], 2, 2, "int8 rows 8 bytes in")
    check(X8[:, 3:], y8, 2, 2, "int8 unaligned base")
    check(X8[:, 3:200:2], y8, 2, 2, "int8 strided features")
    check(X8[:, 5:6], y8, 2, 2, "int8 one column")
    check(X8.T.contiguous()[:, 1:].T, y8[1:], 2, 2, "int8 feature-major, rows 1 byte in")
    # A byte-lane counter not flushed in time wraps: 300,000 rows of one
    # (value, class) in every feature.
    Xo = torch.zeros((300_000, 64), dtype=torch.int8, device=dev)
    yo = torch.zeros(300_000, dtype=torch.int32, device=dev)
    for layout, X in (("row-major", Xo), ("feature-major", Xo.T.contiguous().T)):
        for force in ({}, {"vec": 1}):
            check(X, yo, 2, 2, f"300000 equal rows {layout}", **force)
    want = {(0, False, True), (1, False, True), (1, False, False),
            (1, True, True), (1, True, False), (2, False, False), (2, True, False)}
    if not want <= seen:
        raise AssertionError(f"paths never reached: {sorted(want - seen)}")
    log(f"[contingency] plan paths reached (path, lanes_on_rows, vector): {sorted(seen)}")
    return sorted(seen)


def bin_codes_paths(dev) -> list:
    """Every path ``bin_codes_plan`` picks (4 or 1 features per lane, the
    E > 64 kernel), forced where the main path does not reach it, bitwise
    against the plain version: E in {1, 15, 31, 63, 70}, a row slice with a
    stride, and an unaligned base."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.binning import _scalar_plan, bin_codes_cuda, bin_codes_plan

    sms = _build.sm_count(dev)
    rng = np.random.default_rng(8)
    seen = set()
    for e in (1, 15, 31, 63, 70):
        X, edges = planted_block(rng, 20011, 1000, e)
        Xd, ed = torch.from_numpy(X).to(dev), torch.from_numpy(edges).to(dev)
        for label, V in (("", Xd), ("rows 3::2", Xd[3:15000:2]), ("base +4 bytes", Xd[:, 1:])):
            ev = ed[1:] if V.shape[1] == 999 else ed
            for plan in (bin_codes_plan(V, e, sms), _scalar_plan(V, e, sms)):
                got = bin_codes_cuda(V, ev, plan=plan)
                if not torch.equal(got, ref.bin_codes(V, ev)):
                    raise AssertionError(f"bin_codes E={e} {label} {plan}: codes differ")
                seen.add(plan.fpl)
    if seen != {0, 1, 4}:
        raise AssertionError(f"bin_codes paths reached: {sorted(seen)}")
    log(f"[bin_codes] every plan path (features per lane {sorted(seen)}) bitwise equal")
    # NaN takes the top code E as searchsorted sorts it; +-inf, -0.0 against
    # a 0.0 edge: the 4- and 1-feature register paths and the cache kernel.
    for e, fpl in ((15, 4), (63, 1), (70, 0)):
        X, edges = planted_block(rng, 4099, 1000, e)
        edges[:, e // 2] = 0.0
        edges.sort(axis=1)
        X[5::9, 3::7], X[6::9, 2::5], X[7::9, 4::6], X[8::9, 1::3] = np.nan, np.inf, -np.inf, -0.0
        Xd, ed = torch.from_numpy(X).to(dev), torch.from_numpy(edges).to(dev)
        plan = bin_codes_plan(Xd, e, sms)
        if plan.fpl != fpl:
            raise AssertionError(f"bin_codes E={e}: plan {plan}, want {fpl} features a lane")
        got = bin_codes_cuda(Xd, ed, plan=plan)
        if not (torch.equal(got, ref.bin_codes(Xd, ed))
                and torch.equal(got.cpu(), ref.bin_codes(Xd.cpu(), ed.cpu()))):
            raise AssertionError(f"bin_codes E={e}: NaN / inf / -0.0 codes differ")
        if not torch.all(got[torch.isnan(Xd)] == e):
            raise AssertionError(f"bin_codes E={e}: NaN does not take code {e}")
    log("[bin_codes] NaN (code E), +-inf and -0.0 bitwise equal at E = 15, 63, 70")
    return sorted(seen)


# Contingency counts on int32 bin codes (bins=16): the binned fits' shapes.
# The streaming fit counts each 65,536-row block against the class (C=2,
# relevance) and against a selected feature's codes (C=16, redundancy); the
# in-memory fit counts the whole 1M x 1000 code matrix.
CODE_SHAPES = [
    ("65536x1000 int32 codes V=16 C=2 (binned streaming relevance)", 65536, 2, 40),
    ("65536x1000 int32 codes V=16 C=16 (binned streaming redundancy)", 65536, 16, 40),
    ("1000000x1000 int32 codes V=16 C=16 (binned in-memory redundancy)", 1_000_000, 16, 10),
]


def phase2_codes(dev):
    """Contingency counts on int32 codes: bitwise against the plain version
    and timed at CODE_SHAPES."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.contingency import contingency_tables_cuda

    gen = torch.Generator(device=dev).manual_seed(5)
    timings = []
    for label, m, c, reps in CODE_SHAPES:
        X = torch.randint(0, 16, (m, 1000), generator=gen, device=dev, dtype=torch.int32)
        y = torch.randint(0, c, (m,), generator=gen, device=dev, dtype=torch.int32)
        if not torch.equal(contingency_tables_cuda(X, y, 16, c), ref.contingency_tables(X, y, 16, c)):
            raise AssertionError(f"contingency {label}: counts differ")
        log(f"[contingency] {label}: bitwise equal")
        timings.append(time_contingency(X, y, 16, c, label, reps))
        del X, y
        torch.cuda.empty_cache()
    return timings


def time_mi(counts, label, base, mi_tally, reps=200):
    """The MI kernel at one shape: CUDA-event and own device time, the former
    design's (``base``) on the same inputs, an empty launch (the floor), the
    plain version, the bound, and the launches of this shape on the main
    paths (``mi_tally``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.mi_score import mi_scores_cuda

    *lead, v, c = counts.shape
    tables = int(np.prod(lead))
    got, want = mi_scores_cuda(counts), ref.mi_scores(counts)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(base.mi(counts), want, rtol=RTOL, atol=ATOL)
    err = (got - want).abs().max().item()
    # In turns (new, old, old, new): host work sets these times at small
    # shapes, and the host's pace drifts within a run.
    new_fn, old_fn = (lambda: mi_scores_cuda(counts)), (lambda: base.mi(counts))
    turns = [cuda_ms(fn, reps, 10) for fn in (new_fn, old_fn, old_fn, new_fn)]
    ms, old_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    device_ms = kernel_device_ms(new_fn, "mi_tables_")
    old_device_ms = kernel_device_ms(old_fn, "mi_rows_kernel")
    empty_ms = cuda_ms(lambda: base.empty(tables, counts.device), reps, 10)
    empty_device_ms = kernel_device_ms(lambda: base.empty(tables, counts.device), "empty_kernel")
    plain_ms = cuda_ms(lambda: ref.mi_scores(counts), reps // 4)
    nbytes = counts.numel() * counts.element_size() + tables * 4
    # ~10 instructions a cell (convert, three sums, two divisions, product,
    # clamps, multiply); one logarithm a nonzero cell, at the SFU rate.
    logs = int((counts > 0).sum())
    b_ms, b_by = max(bound(nbytes, 10 * counts.numel(), SCALAR_INSTR_PER_S),
                     bound(nbytes, logs, SFU_PER_S))
    rec = dict(shape=label, ms=ms, kernel_device_ms=device_ms, old_ms=old_ms,
               old_kernel_device_ms=old_device_ms, empty_launch_ms=empty_ms,
               empty_kernel_device_ms=empty_device_ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=None, bytes=nbytes, logs=logs, max_abs_err=err,
               main_path_launches=mi_tally.get(tuple(counts.shape), 0))
    log(f"[time] mi {label}: {json.dumps(rec)}")
    return rec


@contextlib.contextmanager
def tally_mi_shapes(tally):
    """While open, count the MI kernel's launches by table shape (into
    ``tally``) at the dispatcher; the wrapper's own counter is untouched."""
    from repro_torch.kernels import ops

    inner = ops.mi_scores_cuda

    def counted(counts):
        tally[tuple(counts.shape)] = tally.get(tuple(counts.shape), 0) + 1
        return inner(counts)

    ops.mi_scores_cuda = counted
    try:
        yield
    finally:
        ops.mi_scores_cuda = inner


# Launches of the MI kernel on the main paths, by table shape.
MI_TALLY: dict = {}


def run_path(name, fn, dev, launches):
    """Drive one main-path fit with the launch counts zeroed just before
    and read just after; returns (result, record)."""
    wrappers = kernel_wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    with tally_mi_shapes(MI_TALLY):
        res = fn()
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {k: w.launches for k, w in wrappers.items()}
    launches[name] = counts
    rec = dict(path=name, seconds=seconds, launches=counts,
               peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
               selected=res.selected_.tolist(),
               gains=[float(g) for g in res.gains_])
    if res.result_.io is not None:
        rec["io"] = res.result_.io
    log(f"[fit] {json.dumps(rec)}")
    return res, rec


def check_same_selection(a, b, what):
    if not np.array_equal(a.selected_, b.selected_):
        raise AssertionError(
            f"{what}: selections differ: {a.selected_.tolist()} "
            f"(gains {a.gains_.tolist()}) vs {b.selected_.tolist()} "
            f"(gains {b.gains_.tolist()})"
        )
    np.testing.assert_allclose(a.gains_, b.gains_, rtol=RTOL, atol=ATOL,
                               err_msg=what)


def check_finite(sel, n):
    if sel.scores_.shape != (n,) or not np.all(np.isfinite(sel.scores_)):
        raise AssertionError("relevance is not a finite (n,) vector")
    if not np.all(np.isfinite(sel.gains_)):
        raise AssertionError("gains are not finite")


def phase3(dev, launches, timings, keep):
    from repro_torch import ArraySource, MIScore, MRMRSelector
    from repro_torch.data.synthetic import corral_dataset_np

    t0 = time.perf_counter()
    X, y = corral_dataset_np(1_000_000, 1000, seed=0)
    Xd, yd = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    log(f"[tall] data 1000000x1000 int8 made and placed in "
        f"{time.perf_counter() - t0:.3f} s")

    timings.append(time_contingency(Xd, yd, 2, 2, "1000000x1000 int8 (tall fit pass)"))
    timings.append(time_contingency(Xd[:65536], yd[:65536], 2, 2,
                                    "65536x1000 int8 (streaming block)", reps=40))

    kern, rec = run_path("tall_conventional",
                         lambda: MRMRSelector(10).fit(Xd, yd), dev, launches)
    # Where a warm in-memory fit's time goes: the count kernel against the rest.
    rec["trace"] = device_breakdown(lambda: MRMRSelector(10).fit(Xd, yd))
    log(f"[tall] warm in-memory fit, traced: {json.dumps(rec['trace'])}")
    if kern.plan_.encoding != "conventional":
        raise AssertionError(f"tall fit planned {kern.plan_.encoding}")
    stream, srec = run_path(
        "tall_streaming",
        lambda: MRMRSelector(10, score=MIScore(2, 2), block_obs=65536).fit(
            ArraySource(X, y)),
        dev, launches)
    plain, prec = run_path(
        "tall_plain",
        lambda: MRMRSelector(10, score=MIScore(2, 2, use_kernel=False)).fit(Xd, yd),
        dev, launches)

    check_same_selection(kern, stream, "tall in-memory vs streaming")
    check_same_selection(kern, plain, "tall kernels vs plain versions")
    check_finite(kern, 1000)
    if set(kern.selected_[:9].tolist()) != set(range(9)):
        raise AssertionError(f"first nine picks {kern.selected_[:9]} != 0..8")
    io = stream.result_.io
    if io["passes"] != 10 or io["blocks_read"] != 160:
        raise AssertionError(f"streaming ledger {io}")
    want = {"tall_conventional": 10, "tall_streaming": 160, "tall_plain": 0}
    for path, n in want.items():
        if launches[path]["contingency_tables"] != n:
            raise AssertionError(f"{path}: {launches[path]} launches, want {n}")
        if (launches[path]["mi_scores"] > 0) != (n > 0):
            raise AssertionError(f"{path}: MI launches {launches[path]}")
    del Xd, yd
    keep["tall"] = (X, y)  # phase 8 streams the same data out of core
    return [rec, srec, prec]


def phase4(dev, launches, timings, keep):
    from repro_torch import MIScore, MRMRSelector
    from repro_torch.data.synthetic import corral_dataset_np

    X, y = corral_dataset_np(10_000, 50_000, seed=0)
    Xd, yd = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    timings.append(time_contingency(Xd, yd, 2, 2, "10000x50000 int8 (wide fit pass)"))
    Xfm = Xd.T.contiguous()  # feature-major storage, read through its .T view
    timings.append(time_contingency(Xfm.T, yd, 2, 2,
                                    "10000x50000 int8 feature-major"))
    del Xfm

    kern, rec = run_path("wide_alternative",
                         lambda: MRMRSelector(10).fit(Xd, yd), dev, launches)
    rec["trace"] = device_breakdown(lambda: MRMRSelector(10).fit(Xd, yd))
    log(f"[wide] warm in-memory fit, traced: {json.dumps(rec['trace'])}")
    if kern.plan_.encoding != "alternative":
        raise AssertionError(f"wide fit planned {kern.plan_.encoding}")
    plain, prec = run_path(
        "wide_plain",
        lambda: MRMRSelector(10, score=MIScore(2, 2, use_kernel=False)).fit(Xd, yd),
        dev, launches)
    check_same_selection(kern, plain, "wide kernels vs plain versions")
    check_finite(kern, 50_000)
    if launches["wide_alternative"]["contingency_tables"] != 10:
        raise AssertionError(f"wide launches {launches['wide_alternative']}")
    if launches["wide_alternative"]["mi_scores"] == 0:
        raise AssertionError("wide fit never launched the MI kernel")
    log(f"[wide] relevant picks among the first nine: "
        f"{len(set(kern.selected_[:9].tolist()) & set(range(9)))}/9")
    keep["wide"] = (X, y)  # phase 10 shards the same data
    return [rec, prec]


def time_conditional(X, xj, y, label, reps=40):
    """The class-fused conditional count (kernel 1 behind ``fuse_targets``)."""
    from repro_torch.core.contingency import fuse_targets
    from repro_torch.kernels import ref
    from repro_torch.kernels.contingency import conditional_tables_cuda

    from repro_torch.kernels.contingency import contingency_tables_cuda

    m, f = X.shape
    got = conditional_tables_cuda(X, xj, y, 2, 2)
    if not torch.equal(got, ref.conditional_tables(X, xj, y, 2, 2)):
        raise AssertionError(f"conditional counts differ at {label}")
    ms = cuda_ms(lambda: conditional_tables_cuda(X, xj, y, 2, 2), reps)
    fused = fuse_targets(xj, y, 2, 2)
    count_ms = cuda_ms(lambda: contingency_tables_cuda(X, fused, 2, 4), reps)
    plain_ms = cuda_ms(lambda: ref.conditional_tables(X, xj, y, 2, 2), 4, 1)
    library_ms = cuda_ms(lambda: bincount_tables(X, fuse_targets(xj, y, 2, 2), 2, 4), 4, 1)
    nbytes = X.numel() * X.element_size() + 2 * m * 4 + f * 2 * 4 * 4
    b_ms, b_by = bound(nbytes, m * f)
    rec = dict(shape=label, ms=ms, count_only_ms=count_ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=library_ms, bytes=nbytes)
    log(f"[time] conditional {label}: {json.dumps(rec)}")
    return rec


def planted_block(rng, b, n, e):
    """Float32 block and sorted edges (one duplicate), values planted on edges."""
    X = rng.standard_normal((b, n), dtype=np.float32)
    edges = np.sort(rng.standard_normal((n, e), dtype=np.float32), axis=1)
    if e > 1:
        edges[:, 1] = edges[:, 0]
    X[::7] = edges[np.arange(n), rng.integers(0, e, n)]
    X[1], X[2] = -0.0, 0.0
    return X, edges


def phase2_bins(dev):
    """bin_codes bitwise against the plain version and the host binner."""
    from repro_torch import QuantileBinner
    from repro_torch.kernels import ref
    from repro_torch.kernels.binning import bin_codes_cuda

    rng = np.random.default_rng(2)
    err, timings = 0, []
    for label, b, e in [("65536x1000 E=15", 65536, 15), ("ragged 65499x1000 E=15", 65499, 15),
                        ("65536x1000 E=63", 65536, 63)]:
        X, edges = planted_block(rng, b, 1000, e)
        Xd, ed = torch.from_numpy(X).to(dev), torch.from_numpy(edges).to(dev)
        got = bin_codes_cuda(Xd, ed)
        want = ref.bin_codes(Xd, ed)
        binner = QuantileBinner(e + 1)
        binner.edges_ = edges
        host = torch.from_numpy(binner.transform(X))
        diff = max((got.long() - want.long()).abs().max().item(),
                   (got.cpu().long() - host.long()).abs().max().item())
        err = max(err, diff)
        if diff != 0 or got.dtype != torch.int32:
            raise AssertionError(f"bin_codes {label}: codes differ (max {diff})")
        log(f"[bin_codes] {label}: bitwise equal to the plain version and the host binner")
        if b == 65536:
            timings.append(time_bins(Xd, ed, f"{label} (streaming block)", reps=40))
    gen = torch.Generator(device=dev).manual_seed(2)
    Xd = torch.randn((1_000_000, 1000), generator=gen, device=dev)
    ed = torch.sort(torch.randn((1000, 15), generator=gen, device=dev), dim=1).values
    if not torch.equal(bin_codes_cuda(Xd, ed), ref.bin_codes(Xd, ed)):
        raise AssertionError("bin_codes 1000000x1000: codes differ")
    timings.append(time_bins(Xd, ed, "1000000x1000 E=15 (in-memory fit)", reps=10))
    return err, timings


def check_bins(Xd, ed, label, reps):
    """bin_codes held bitwise to its plain version at one shape, then timed."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.binning import bin_codes_cuda

    diff = (bin_codes_cuda(Xd, ed).long() - ref.bin_codes(Xd, ed).long()).abs().max().item()
    if diff != 0:
        raise AssertionError(f"bin_codes {label}: codes differ (max {diff})")
    log(f"[bin_codes] {label}: bitwise equal to the plain version")
    return dict(time_bins(Xd, ed, label, reps), max_abs_err=diff)


def time_bins(Xd, ed, label, reps):
    from repro_torch.kernels import ref
    from repro_torch.kernels.binning import bin_codes_cuda

    b, n = Xd.shape
    e = ed.shape[1]
    ms = cuda_ms(lambda: bin_codes_cuda(Xd, ed), reps)
    plain_ms = cuda_ms(lambda: ref.bin_codes(Xd, ed), max(2, reps // 5), 1)
    Xt = Xd.T.contiguous()  # the library call's own layout, made outside the timing
    library_ms = cuda_ms(lambda: torch.searchsorted(ed, Xt, right=True), max(2, reps // 5), 1)
    del Xt
    device_ms = kernel_device_ms(lambda: bin_codes_cuda(Xd, ed), "bin_codes")
    # What reading and writing the same bytes takes on this card: one copy.
    out = torch.empty((b, n), dtype=torch.int32, device=Xd.device)
    copy_ms = cuda_ms(lambda: out.copy_(Xd.view(torch.int32)), max(2, reps // 5), 1)
    del out
    nbytes = 2 * b * n * 4 + n * e * 4
    # A compare and an add per edge and element, one instruction each.
    b_ms, b_by = bound(nbytes, 2 * b * n * e, SCALAR_INSTR_PER_S)
    rec = dict(shape=label, ms=ms, kernel_device_ms=device_ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
               copy_ms=copy_ms, library_ms=library_ms, library="torch.searchsorted(right=True) on the "
               "(N, B) transpose", bytes=nbytes)
    log(f"[time] bin_codes {label}: {json.dumps(rec)}")
    return rec


def phase2_pearson(dev):
    """pearson_corr within CORR_RTOL/CORR_ATOL of the plain version."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.pearson import pearson_corr_cuda

    gen = torch.Generator(device=dev).manual_seed(3)
    F, M = 50_000, 10_000
    X = torch.randn((F, M), generator=gen, device=dev) * 2 + 3
    X[7] = 2.5  # a constant row correlates 0
    err, timings = 0.0, []
    for t in (1, 4):
        Y = torch.randn((t, M), generator=gen, device=dev)
        got = pearson_corr_cuda(X, Y)
        want = ref.pearson_corr(X, Y)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=CORR_RTOL, atol=CORR_ATOL)
        if not torch.all(got[7] == 0):
            raise AssertionError("a constant row does not correlate 0")
        e = (got - want).abs().max().item()
        err = max(err, e)
        log(f"[pearson] {F}x{M} against T={t}: within rtol={CORR_RTOL} "
            f"atol={CORR_ATOL}, max abs err {e:.3e}")
        timings.append(time_pearson(X, Y, f"{F}x{M} T={t}", reps=20 if t == 1 else 5))
    Xv = X[:2000].T.contiguous().T  # the X.T view of a row-major matrix
    Y = torch.randn((1, M), generator=gen, device=dev)
    got = pearson_corr_cuda(Xv, Y)
    torch.testing.assert_close(got, ref.pearson_corr(Xv, Y), rtol=CORR_RTOL, atol=CORR_ATOL)
    err = max(err, (got - ref.pearson_corr(Xv, Y)).abs().max().item())
    log("[pearson] 2000x10000 through the X.T view: within tolerance")
    return err, timings


def time_pearson(X, Y, label, reps):
    from repro_torch.kernels import ref
    from repro_torch.kernels.pearson import pearson_corr_cuda

    f, m = X.shape
    t = Y.shape[0]
    ms = cuda_ms(lambda: pearson_corr_cuda(X, Y), reps)
    plain_ms = cuda_ms(lambda: ref.pearson_corr(X, Y), 3, 1)
    Xs, Ys = ref.standardize_rows(X), ref.standardize_rows(Y)
    library_ms = cuda_ms(lambda: torch.matmul(Xs, Ys.T) / m, reps)
    del Xs, Ys
    nbytes = (f * m + t * m + f * t) * 4
    b_ms, b_by = bound(nbytes, 4 * f * m + 2 * f * m * t)
    rec = dict(shape=label, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               share_of_bound=b_ms / ms, library_ms=library_ms,
               library="torch.matmul of pre-standardised rows (product only)", bytes=nbytes)
    log(f"[time] pearson_corr {label}: {json.dumps(rec)}")
    return rec


def phase5(dev, launches, keep):
    from repro_torch import ArraySource, MIScore, MRMRSelector, fit_binned
    from repro_torch.data.synthetic import continuous_dataset_np

    t0 = time.perf_counter()
    X, y = continuous_dataset_np(1_000_000, 1000, seed=0)
    log(f"[tall-binned] data 1000000x1000 float32 made in {time.perf_counter() - t0:.3f} s")
    src = ArraySource(X, y)
    t0 = time.perf_counter()
    src.fingerprint()
    fp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    binner = fit_binned(src, 16, block_obs=65536).binner
    sketch_s = time.perf_counter() - t0
    # What the device encode replaces: the host binner on one streaming block.
    t0 = time.perf_counter()
    binner.transform(X[:65536])
    transform_s = time.perf_counter() - t0
    log(f"[tall-binned] fingerprint (sha256 of 4 GB) {fp_s:.3f} s; "
        f"sketch pass {sketch_s:.3f} s; host QuantileBinner.transform of one "
        f"65536x1000 block {transform_s:.3f} s")

    stream, srec = run_path(
        "tall_binned_streaming",
        lambda: MRMRSelector(10, bins=16, block_obs=65536).fit(src), dev, launches)
    mem, mrec = run_path(
        "tall_binned_in_memory", lambda: MRMRSelector(10, bins=16).fit(X, y), dev, launches)
    plain, prec = run_path(
        "tall_binned_plain",
        lambda: MRMRSelector(10, bins=16, score=MIScore(16, 2, use_kernel=False)).fit(X, y),
        dev, launches)
    check_same_selection(stream, mem, "tall binned streaming vs in-memory")
    check_same_selection(mem, plain, "tall binned kernels vs plain versions")
    check_finite(mem, 1000)
    if (stream.plan_.bins, mem.plan_.bins) != (16, 16):
        raise AssertionError("binned fits did not record bins=16")
    if int(mem.selected_[0]) not in (0, 8):
        raise AssertionError(f"first binned pick {mem.selected_[0]} not in {{0, 8}}")
    io = stream.result_.io
    if (io["passes"], io["blocks_read"], io["bytes_read"]) != (10, 160, 10 * (X.nbytes + y.nbytes)):
        raise AssertionError(f"binned streaming ledger {io}")
    a, b, c = (launches[p] for p in ("tall_binned_streaming", "tall_binned_in_memory",
                                     "tall_binned_plain"))
    if (a["bin_codes"], a["contingency_tables"]) != (160, 160) or a["mi_scores"] == 0:
        raise AssertionError(f"binned streaming launches {a}")
    if b["bin_codes"] < 1 or b["contingency_tables"] != 10 or b["mi_scores"] == 0:
        raise AssertionError(f"binned in-memory launches {b}")
    if any(c.values()):
        raise AssertionError(f"plain-version binned fit launched kernels: {c}")
    keep["binned_src"] = src  # fingerprint and fitted binner memoised
    return [dict(srec, fingerprint_s=fp_s, sketch_s=sketch_s,
                 host_transform_block_s=transform_s), mrec, prec]


def device_breakdown(fn, top=6, host_ops=True):
    """Time ``fn()`` once on the host clock, then once more under
    ``torch.profiler``: the device-only activities (kernels, copies) by
    name, their sum, and its share of the profiled call's wall time.
    ``host_ops=False`` records the device's activity alone (no host
    operator events beside it).  The rows are summed from the profiler's
    raw events: building its Python event list takes ~70 us an event,
    minutes for a step of ~10^5 launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    activities = [ProfilerActivity.CPU] if host_ops else []
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            ms, calls = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, calls + 1)
    rows = sorted(((n, ms, c) for n, (ms, c) in by_name.items()), key=lambda r: -r[1])
    device_ms = sum(ms for _, ms, _ in rows)
    return dict(host_s=host_s, profiled_wall_ms=wall_ms, device_ms=device_ms,
                device_busy_share=device_ms / wall_ms, device_calls=sum(c for _, _, c in rows),
                top=[dict(name=n[:90], ms=ms, calls=c) for n, ms, c in rows[:top]])


def phase6(dev, launches, keep):
    from repro_torch import MRMRSelector, PearsonMIScore
    from repro_torch.data.synthetic import continuous_dataset_np

    t0 = time.perf_counter()
    X, y = continuous_dataset_np(10_000, 50_000, seed=0)
    Xd, yd = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    keep["pearson"] = (X, y)  # phase 10 shards the same data
    log(f"[wide-pearson] data 10000x50000 float32 made and placed in "
        f"{time.perf_counter() - t0:.3f} s")
    kern, rec = run_path("wide_pearson", lambda: MRMRSelector(8).fit(Xd, yd), dev, launches)
    # Where a warm fit's time goes: the correlation kernel against the rest.
    rec["trace"] = device_breakdown(lambda: MRMRSelector(8).fit(Xd, yd))
    log(f"[wide-pearson] warm fit, traced: {json.dumps(rec['trace'])}")
    if kern.plan_.encoding != "alternative" or not isinstance(kern.plan_.score, PearsonMIScore):
        raise AssertionError(f"wide continuous fit planned {kern.plan_}")
    plain, prec = run_path(
        "wide_pearson_plain",
        lambda: MRMRSelector(8, score=PearsonMIScore(use_kernel=False)).fit(Xd, yd),
        dev, launches)
    if not np.array_equal(kern.selected_, plain.selected_):
        raise AssertionError(f"wide Pearson selections differ: {kern.selected_} vs "
                             f"{plain.selected_}")
    np.testing.assert_allclose(kern.gains_, plain.gains_, rtol=CORR_RTOL, atol=CORR_ATOL)
    check_finite(kern, 50_000)
    if int(kern.selected_[0]) not in (0, 8):
        raise AssertionError(f"first Pearson pick {kern.selected_[0]} not in {{0, 8}}")
    if launches["wide_pearson"]["pearson_corr"] != 8:
        raise AssertionError(f"wide Pearson launches {launches['wide_pearson']}")
    if any(launches["wide_pearson_plain"].values()):
        raise AssertionError(f"plain Pearson fit launched {launches['wide_pearson_plain']}")
    return [rec, prec]


FLASH_F32_TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_kernels.py, float32
FLASH_BF16_TOL = dict(rtol=3e-2, atol=3e-2)  # tests/test_kernels.py, bf16
# Per-row relative error |got - want| / |want| (L2 over D), max over (b, s, h).
# At S = 2048-8192 a row's output shrinks to ~0.02-0.04, inside the bf16 atol
# above, so that elementwise tolerance alone passes a kernel whose scores are
# 1% too large (tools/flash_planted_faults.py); a row's relative error does
# not shrink with the output. bf16 rounds P for P.V and the output once
# each: ~4-5e-3 per row.
FLASH_ROW_RTOL = 1e-2


def flash_errors(got, want, dtype):
    """Hold a flash output to its plain version; (max abs err, max row err)."""
    got, want = got.float(), want.float()
    tol = FLASH_F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL
    torch.testing.assert_close(got, want, **tol)
    diff = got - want
    row = (diff.norm(dim=-1) / want.norm(dim=-1)).max().item()
    if not row <= FLASH_ROW_RTOL:
        raise AssertionError(f"flash attention row error {row:.3e} > {FLASH_ROW_RTOL}")
    return diff.abs().max().item(), row


def attn_inputs(b, s, t, h, kv, d, dtype, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d))]


def visible_pairs(s, t, causal):
    """(query, key) pairs the attention needs: query i sees keys <= i + t - s."""
    if not causal:
        return s * t
    i = np.arange(s)
    return int(np.clip(i + t - s + 1, 0, t).sum())


def phase2_flash(dev):
    """flash_attention against its plain version, and its times."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # label, b, s, t, h, kv, d, causal, dtype, timed
        ("serve prefill B=4 S=T=2048", 4, 2048, 2048, 32, 4, 128, True, bf, True),
        ("ragged wave B=4 S=T=1000", 4, 1000, 1000, 32, 4, 128, True, bf, True),
        ("long prompt B=1 S=T=8192", 1, 8192, 8192, 32, 4, 128, True, bf, True),
        ("MHA B=2 S=T=512 H=KV=32", 2, 512, 512, 32, 32, 128, True, f32, False),
        ("S=T=1", 4, 1, 1, 32, 4, 128, True, f32, False),
        ("ragged S=T=1000 f32", 2, 1000, 1000, 32, 4, 128, True, f32, False),
        ("S=256 < T=2048 causal", 2, 256, 2048, 32, 4, 128, True, f32, False),
        ("non-causal S=300 T=1000", 2, 300, 1000, 32, 4, 128, False, f32, False),
        ("D=64 S=T=777 bf16", 2, 777, 777, 16, 16, 64, True, bf, False),
        # The other families' shapes (phase 11): G = 6 and 5, D = 64 with G = 1,
        # non-causal over 1500 frames, 4 decoder tokens against them.
        ("dbrx prefill B=4 S=T=2048 H=48 KV=8", 4, 2048, 2048, 48, 8, 128, True, bf, True),
        ("dbrx ragged wave B=4 S=T=1000 H=48 KV=8", 4, 1000, 1000, 48, 8, 128, True, bf, False),
        ("llama4 prefill B=4 S=T=2048 H=40 KV=8", 4, 2048, 2048, 40, 8, 128, True, bf, True),
        ("qwen2-vl prefill B=4 S=T=2048 H=12 KV=2", 4, 2048, 2048, 12, 2, 128, True, bf, True),
        ("whisper encoder B=4 S=T=1500 H=KV=6 D=64 non-causal", 4, 1500, 1500, 6, 6, 64, False,
         bf, True),
        ("whisper cross-attention B=4 S=4 T=1500 H=KV=6 D=64", 4, 4, 1500, 6, 6, 64, False, bf,
         True),
        ("G=6 S=T=300 f32", 2, 300, 300, 48, 8, 128, True, f32, False),
        ("G=5 S=T=300 f32", 2, 300, 300, 40, 8, 128, True, f32, False),
        ("whisper cross-attention S=4 T=1500 f32", 2, 4, 1500, 6, 6, 64, False, f32, False),
    ]
    err, timings = 0.0, []
    for i, (label, b, s, t, h, kv, d, causal, dtype, timed) in enumerate(cases):
        q, k, v = attn_inputs(b, s, t, h, kv, d, dtype, dev, seed=10 + i)
        got = flash_attention_cuda(q, k, v, causal=causal)
        want = ref.flash_attention(q, k, v, causal=causal)
        e, row = flash_errors(got, want, dtype)
        del want
        err = max(err, e)
        log(f"[flash] {label} {str(dtype)[6:]}: max abs err {e:.3e}, "
            f"max row err {row:.3e}")
        if timed:
            timings.append(time_flash(q, k, v, label, causal))
        del q, k, v, got
        torch.cuda.empty_cache()
    return err, timings


def time_flash(q, k, v, label, causal=True):
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if causal and s != t:
        raise ValueError("SDPA's is_causal aligns the mask top-left; time S == T only")
    reps = 20 if s * b <= 8192 else 10
    ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, causal=causal), reps)
    plain_ms = cuda_ms(lambda: ref.flash_attention(q, k, v, causal=causal), 2, 1)
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = sdpa(qh, kh, vh, is_causal=causal, enable_gqa=True).transpose(1, 2)
    torch.testing.assert_close(lib.float(), flash_attention_cuda(q, k, v, causal=causal).float(),
                               **FLASH_BF16_TOL)
    library_ms = cuda_ms(lambda: sdpa(qh, kh, vh, is_causal=causal, enable_gqa=True), reps)
    es = q.element_size()
    nbytes = (2 * b * s * h * d + 2 * b * t * kvh * d) * es
    flops = 4 * b * h * d * visible_pairs(s, t, causal)
    b_ms, b_by = bound(nbytes, flops, BF16_OPS_PER_S)
    rec = dict(shape=label, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               share_of_bound=b_ms / ms, library_ms=library_ms,
               library=f"scaled_dot_product_attention(is_causal={causal}, "
               "enable_gqa=True)", bytes=nbytes, flops=flops,
               tflops=flops / ms / 1e9)
    log(f"[time] flash_attention {label}: {json.dumps(rec)}")
    return rec


def margin_engine(model, **kw):
    """A ServeEngine that keeps, for each sampled step, the top-1 / top-2
    logit margin of every row (waves in serving order) in ``.margins``."""
    from repro_torch.serve import ServeEngine

    class MarginEngine(ServeEngine):
        def _sample(self, logits):
            top = torch.topk(logits.float(), 2, dim=-1).values
            self.margins.append((top[:, 0] - top[:, 1]).cpu().numpy())
            return super()._sample(logits)

    engine = MarginEngine(model, **kw)
    engine.margins = []
    return engine


def serve_run(name, model, reqs, dev, launches, use_kernel="auto"):
    """Serve ``reqs`` with launch counts zeroed just before and read just
    after; prefill's flash launches are also counted per wave."""
    wrappers = kernel_wrappers()
    flash = wrappers["flash_attention"]
    per_wave = []
    prefill = model.prefill

    def counted_prefill(*a, **kw):
        before = flash.launches
        out = prefill(*a, **kw)
        per_wave.append(flash.launches - before)
        return out

    model.prefill = counted_prefill
    engine = margin_engine(model, use_kernel=use_kernel)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    try:
        outs = engine.serve(reqs)
    finally:
        del model.prefill
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches[name] = {k: w.launches for k, w in wrappers.items()}
    new = sum(len(o) for o in outs)
    steps = sum(w["decode_steps"] for w in engine.stats)
    rec = dict(path=name, seconds=seconds, launches=launches[name],
               flash_launches_per_wave=per_wave, waves=engine.stats,
               prefill_s=[w["prefill_s"] for w in engine.stats],
               decode_ms_per_step=1e3 * sum(w["decode_s"] for w in engine.stats) / steps,
               new_tokens=new, tokens_per_s=new / seconds,
               peak_mem_bytes=torch.cuda.max_memory_allocated(dev))
    log(f"[serve] {json.dumps(rec)}")
    return outs, engine.margins, rec


def wave_rows(reqs):
    """Request index -> (wave, row) in the engine's serving order."""
    lens = sorted({len(r.prompt) for r in reqs})
    rows: dict = {}
    for i in sorted(range(len(reqs)), key=lambda i: len(reqs[i].prompt)):
        w = lens.index(len(reqs[i].prompt))
        rows[i] = (w, sum(1 for wr in rows.values() if wr[0] == w))
    return rows


@contextlib.contextmanager
def held_to_plain(errs):
    """While open, every prefill attention is also computed by the plain
    version on the same q, k, v (the layer's own activations) and held to it
    with ``flash_errors``; ``errs`` collects (max abs err, max row err)."""
    from repro_torch.kernels import ops, ref

    inner = ops.flash_attention

    def checked(q, k, v, *, causal, use_kernel="auto"):
        out = inner(q, k, v, causal=causal, use_kernel=use_kernel)
        errs.append(flash_errors(out, ref.flash_attention(q, k, v, causal=causal), q.dtype))
        return out

    ops.flash_attention = checked
    try:
        yield
    finally:
        ops.flash_attention = inner


def last_logits(model, reqs, use_kernel):
    """Last-position prefill logits (float32) of every request, by wave."""
    out = []
    for n in sorted({len(r.prompt) for r in reqs}):
        toks = torch.tensor([r.prompt for r in reqs if len(r.prompt) == n], device=model.device)
        logits, caches = model.prefill(toks, use_kernel=use_kernel)
        out.append(logits.float())
        del caches
    return out


def margin_rule(outs, plain, margins, logit_err, reqs):
    """Kernel and plain greedy tokens equal up to the first step whose plain
    top-1 / top-2 margin is below twice the kernel-vs-plain logits error."""
    rows = wave_rows(reqs)
    agree = []
    for i, (a, b) in enumerate(zip(outs, plain)):
        new = len(b)
        w, r = rows[i]
        low = [j for j in range(new) if margins[new * w + j][r] < 2 * logit_err]
        first_low = low[0] if low else new
        first_diff = next((j for j in range(new) if a[j] != b[j]), new)
        if first_diff < first_low:
            raise AssertionError(
                f"request {i}: kernel and plain tokens differ at step {first_diff}, "
                f"before the first low-margin step {first_low}")
        agree.append(dict(request=i, prompt_len=len(reqs[i].prompt), first_diff=first_diff,
                          first_low_margin_step=first_low))
    return agree


def serve_and_hold(tag, model, reqs, dev, launches, attn_layers):
    """Serve ``reqs`` through the kernel (path ``{tag}_serve``) and through
    the plain attention (``{tag}_serve_plain``, which must launch nothing);
    ``attn_layers`` flash launches per wave.  Then each prefill attention of
    every wave held to the plain version on its own q, k, v, and the greedy
    tokens to the plain run's by ``margin_rule``.  -> (kernel record, plain
    record, check record, the plain last-position logits)."""
    from repro_torch.serve import Request

    vocab = model.cfg.vocab_size
    # Warm-up (library handles, allocator): one short request, not counted.
    margin_engine(model).serve([Request(reqs[0].prompt[:64], 2)])
    outs, _, rec = serve_run(f"{tag}_serve", model, reqs, dev, launches)
    waves = len({len(r.prompt) for r in reqs})
    if rec["flash_launches_per_wave"] != [attn_layers] * waves:
        raise AssertionError(f"{tag}: flash launches per wave {rec['flash_launches_per_wave']}, "
                             f"want {attn_layers} per wave")
    plain, margins, prec = serve_run(f"{tag}_serve_plain", model, reqs, dev, launches,
                                     use_kernel=False)
    if any(launches[f"{tag}_serve_plain"].values()):
        raise AssertionError(f"{tag}: plain serve launched {launches[f'{tag}_serve_plain']}")
    for o, r in zip(outs, reqs):
        if len(o) != r.max_new_tokens or not all(0 <= t < vocab for t in o):
            raise AssertionError(f"{tag}: bad generation {o}")

    # The kernel inside the model: each prefill attention of every wave held
    # to the plain version on its own inputs, so no error of an earlier layer
    # enters the comparison.
    layer_errs = []
    flash = kernel_wrappers()["flash_attention"]
    before = flash.launches
    with held_to_plain(layer_errs):
        kern_logits = last_logits(model, reqs, "auto")
    want = waves * attn_layers
    if flash.launches - before != want or len(layer_errs) != want:
        raise AssertionError(f"{tag}: held {len(layer_errs)} prefill attentions, "
                             f"{flash.launches - before} launches; want {want}")
    plain_logits = last_logits(model, reqs, False)
    for lg in kern_logits + plain_logits:
        if not torch.isfinite(lg).all():
            raise AssertionError(f"{tag}: non-finite prefill logits")
    logit_err = max((a - b).abs().max().item() for a, b in zip(kern_logits, plain_logits))
    agree = margin_rule(outs, plain, margins, logit_err, reqs)
    check = dict(logit_err=logit_err, agreement=agree, tokens_equal=outs == plain,
                 layer_abs_err=max((e for e, _ in layer_errs), default=None),
                 layer_row_err=max((r for _, r in layer_errs), default=None))
    log(f"[{tag}] prefill attention in the model, kernel vs plain on each layer's own q, k, "
        f"v: max abs err {check['layer_abs_err']}, max row err {check['layer_row_err']} "
        f"(limit {FLASH_ROW_RTOL}); last-position logits kernel vs plain {logit_err:.4e}")
    log(f"[{tag}] tokens, kernel vs plain: {json.dumps(agree)}")
    for r in (rec, prec):
        r.update(arch=model.cfg.name, layers=model.cfg.num_layers, params=model.num_params(),
                 weight_bytes=model.weight_bytes(), dtype=str(model.dtype)[6:])
    return rec, prec, check, plain_logits


def phase7(dev, launches):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import Request

    cfg = get_config("yi-6b")
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, dtype=torch.bfloat16,
                        generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    log(f"[yi6b] {model.num_params()} parameters, {model.weight_bytes()} weight bytes "
        f"(bf16), made on the card in {time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(0)
    new = 32
    reqs = [Request(rng.integers(0, cfg.vocab_size, n).tolist(), new)
            for n in [2048] * 4 + [1000] * 4]
    n_layers = cfg.num_layers
    rec, prec, check, plain_logits = serve_and_hold("yi6b", model, reqs, dev, launches,
                                                    n_layers)
    logit_err = check["logit_err"]
    del model
    torch.cuda.empty_cache()

    # Float32 at full width and depth: the same weights before bf16 rounding.
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, dtype=torch.float32,
                        generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    log(f"[yi6b] float32 model, {model.weight_bytes()} weight bytes, made in "
        f"{time.perf_counter() - t0:.3f} s")
    f32_logits = last_logits(model, reqs, False)
    bf16_err = max((a - b).abs().max().item() for a, b in zip(plain_logits, f32_logits))
    log(f"[yi6b] last-position logits: kernel vs plain (bf16) max abs err {logit_err:.4e}; "
        f"plain bf16 vs float32 (the bf16 model's own rounding) {bf16_err:.4e}")
    if not logit_err <= bf16_err:
        raise AssertionError(f"kernel-vs-plain logits error {logit_err} exceeds the bf16 "
                             f"model's own rounding error {bf16_err}")
    wave = reqs[:4]  # the 2048-token prompts
    f32_outs, _, frec = serve_run("yi6b_serve_f32", model, wave, dev, launches)
    f32_plain, _, fprec = serve_run("yi6b_serve_f32_plain", model, wave, dev, launches,
                                    use_kernel=False)
    if frec["flash_launches_per_wave"] != [n_layers]:
        raise AssertionError(f"float32 wave flash launches {frec['flash_launches_per_wave']}")
    if f32_outs != f32_plain:
        raise AssertionError(f"float32 tokens differ: {f32_outs} vs {f32_plain}")
    log("[yi6b] float32 wave: kernel and plain tokens equal")
    del model
    torch.cuda.empty_cache()
    recs = [rec, prec, frec, fprec]
    for r in recs:
        r.update(arch="yi-6b")
    check.update(bf16_vs_f32_err=bf16_err)
    return recs, check


# -- phase 11: the other LM families -----------------------------------------

# Prompt lengths of each served wave (phase 7's traffic for dbrx); Mamba
# prompts are whole SSD chunks (256; 32 in jamba's smoke config).
FAMILY_WAVES = dict(dbrx=[2048] * 4 + [1000] * 4, llama4=[2048] * 4, mamba2=[2048] * 4 + [1024] * 4,
                    jamba=[512] * 4 + [96] * 4, qwen2vl=[2048] * 4)
FAMILY_DEPTH = {"dbrx-132b": 4, "llama4-scout-17b-a16e": 2}  # of 40 and 48 layers
VLM_IMAGE = (1024, 32)  # image positions first, the grid's width: (0, i // 32, i % 32)
WHISPER_FRAMES = 1500  # 30 s of audio at 50 frames/s
WHISPER_PROMPT = 4
NEW_TOKENS = 32
FAMILY_PATHS = ("dbrx_serve", "llama4_serve", "jamba_bf16_serve", "jamba_f32_serve",
                "qwen2vl_embeds", "qwen2vl_serve", "whisper_bf16", "whisper_f32")
MOE_CHECK_TOKENS = 1024
MOE_REL_TOL = 1e-4  # float32 MoE against the dense reference, of its largest magnitude
SSD_REL_TOL = 1e-4  # chunked SSD against the recurrence, of the output's largest magnitude
# Prefill of S-1 tokens and a step against prefill of S, float32 over 48
# Mamba layers: each adds ~1e-6 relative float32 error (the SSD's chunk sums).
DECODE_REL_TOL = 1e-3


def counted(name, launches, fn):
    """fn() with every kernel's launch count set to 0 just before it and read
    just after, into ``launches[name]``."""
    wrappers = kernel_wrappers()
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    launches[name] = {k: w.launches for k, w in wrappers.items()}
    return out


def build_family(arch, dev, dtype, smoke=False):
    """A random model of ``arch`` at its published widths (depth cut to
    ``FAMILY_DEPTH``), or its smoke config, from seed 0 on the card."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import build_model

    cfg = smoke_config(arch) if smoke else get_config(arch)
    if not smoke and arch in FAMILY_DEPTH:
        cfg = dataclasses.replace(cfg, num_layers=FAMILY_DEPTH[arch])
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, dtype=dtype,
                        generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    log(f"[{arch}] {cfg.num_layers} layers, {model.num_params()} parameters, "
        f"{model.weight_bytes()} weight bytes ({str(dtype)[6:]}), made on the card in "
        f"{time.perf_counter() - t0:.3f} s")
    return model


def family_requests(cfg, lengths, seed=0):
    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    return [Request(rng.integers(0, cfg.vocab_size, n).tolist(), NEW_TOKENS) for n in lengths]


def moe_checks(tag, model, reqs):
    """Layer 0's MoE on the first wave's tokens, as the prefill hands them
    over: the slots dropped at the config's capacity factor; then, on
    ``MOE_CHECK_TOKENS`` of them in float32 with the factor raised to E / k
    (no expert can overflow), the MoE against ``moe_dense_reference``."""
    from repro_torch.models import moe, transformer

    cfg = model.cfg
    seen = {}
    inner = transformer.moe_einsum

    def capture(p, x, *, cfg):
        seen.setdefault("x", x.clone())
        seen.setdefault("p", p)
        return inner(p, x, cfg=cfg)

    n = len(reqs[0].prompt)
    toks = torch.tensor([r.prompt for r in reqs if len(r.prompt) == n], device=model.device)
    transformer.moe_einsum = capture
    try:
        model.prefill(toks)
    finally:
        transformer.moe_einsum = inner
    e, k = cfg.num_experts, cfg.experts_per_token
    with torch.inference_mode():
        x2d, p = seen["x"].reshape(-1, cfg.d_model), seen["p"]
        t = x2d.shape[0]
        cap = moe._capacity(t, k, e, cfg.capacity_factor)
        ids, gates, _ = moe._route(x2d, p["router"], k, cfg.router_softmax_topk)
        kept = int((moe._dispatch_sorted(ids, gates, e, cap)[0] >= 0).sum())
        load = torch.bincount(ids.reshape(-1), minlength=e).tolist()
        roomy = dataclasses.replace(cfg, capacity_factor=e / k)
        x32 = x2d[:MOE_CHECK_TOKENS].float()[None]
        p32 = {name: w.float() for name, w in p.named_parameters()}
        ids32, gates32, _ = moe._route(x32[0], p32["router"], k, cfg.router_softmax_topk)
        cap32 = moe._capacity(x32.shape[1], k, e, roomy.capacity_factor)
        kept32 = int((moe._dispatch_sorted(ids32, gates32, e, cap32)[0] >= 0).sum())
        got = moe.moe_einsum(p32, x32, cfg=roomy)[0]
        want = moe.moe_dense_reference(p32, x32, cfg=roomy)
        rel = ((got - want).abs().max() / want.abs().max()).item()
        del p32, x32, got, want
    torch.cuda.empty_cache()
    rec = dict(tokens=t, capacity_factor=cfg.capacity_factor, capacity=cap,
               slots=t * k, dropped=t * k - kept, expert_load=load,
               check_tokens=MOE_CHECK_TOKENS, check_dropped=MOE_CHECK_TOKENS * k - kept32,
               check_rel_err=rel)
    log(f"[{tag}] layer 0 MoE: {json.dumps(rec)}")
    if kept32 != MOE_CHECK_TOKENS * k:
        raise AssertionError(f"{tag}: the raised capacity factor still dropped slots")
    if not rel <= MOE_REL_TOL:
        raise AssertionError(f"{tag}: float32 MoE vs the dense reference {rel:.3e} > "
                             f"{MOE_REL_TOL}")
    return rec


def phase11_moe(tag, arch, dev, launches):
    """(a) dbrx, (b) llama4-scout: served at their published widths through
    the kernel and the plain attention, held by ``serve_and_hold``; layer 0's
    MoE checked by ``moe_checks``."""
    model = build_family(arch, dev, torch.bfloat16)
    reqs = family_requests(model.cfg, FAMILY_WAVES[tag])
    attn = sum(kind == "attn" for kind, _ in model.kinds)
    rec, prec, check, _ = serve_and_hold(tag, model, reqs, dev, launches, attn)
    check["moe"] = moe_checks(tag, model, reqs)
    del model
    torch.cuda.empty_cache()
    return [rec, prec], check


def phase11_mamba(dev, launches):
    """(c) mamba2-1.3b, whole: served in bf16 (no kernel on this path);
    layer 0's chunked SSD in float32 against the token-by-token recurrence
    on its own inputs; in float32, prefill of S-1 tokens plus one step
    against prefill of S."""
    from repro_torch.models import mamba
    from repro_torch.serve import Request

    model = build_family("mamba2-1.3b", dev, torch.bfloat16)
    cfg = model.cfg
    reqs = family_requests(cfg, FAMILY_WAVES["mamba2"])
    margin_engine(model).serve([Request(reqs[0].prompt[:64], 2)])  # warm-up
    outs, _, rec = serve_run("mamba2_serve", model, reqs, dev, launches)
    if any(launches["mamba2_serve"].values()):
        raise AssertionError(f"mamba2 launched {launches['mamba2_serve']}; no kernel expected")
    for o in outs:
        if len(o) != NEW_TOKENS or not all(0 <= t < cfg.vocab_size for t in o):
            raise AssertionError(f"mamba2: bad generation {o}")
    seen = []
    inner = mamba.ssd_chunked
    longest = max(FAMILY_WAVES["mamba2"])

    def capture(*args, **kw):  # layer 0's inputs in the longest wave
        if not seen and args[0].shape[1] == longest:
            seen.append((args, kw))
        return inner(*args, **kw)

    mamba.ssd_chunked = capture
    try:
        logits = last_logits(model, reqs, "auto")
    finally:
        mamba.ssd_chunked = inner
    if not all(torch.isfinite(lg).all() for lg in logits):
        raise AssertionError("mamba2: non-finite bf16 logits")
    with torch.inference_mode():
        (x, dt, a, b, c), kw = seen[0]
        x, b, c = x.float(), b.float(), c.float()
        t0 = time.perf_counter()
        y, state = inner(x, dt, a, b, c, **kw)
        torch.cuda.synchronize()
        chunked_s = time.perf_counter() - t0
        st = torch.zeros_like(state)
        ys = []
        t0 = time.perf_counter()
        for i in range(x.shape[1]):
            yi, st = mamba.ssd_recurrent_step(st, x[:, i:i + 1], dt[:, i:i + 1], a,
                                              b[:, i:i + 1], c[:, i:i + 1])
            ys.append(yi)
        y_rec = torch.cat(ys, dim=1)
        torch.cuda.synchronize()
        rec_s = time.perf_counter() - t0
        ssd_err = ((y - y_rec).abs().max() / y.abs().max()).item()
        state_err = ((state - st).abs().max() / state.abs().max()).item()
        del x, b, c, y, y_rec, ys, st, state
    ssd = dict(shape=list(seen[0][0][0].shape), chunk=kw["chunk"], rel_err=ssd_err,
               state_rel_err=state_err, chunked_s=chunked_s, recurrence_s=rec_s)
    log(f"[mamba2] layer 0 SSD in float32, chunked vs the recurrence: {json.dumps(ssd)}")
    if not (ssd_err <= SSD_REL_TOL and state_err <= SSD_REL_TOL):
        raise AssertionError(f"mamba2: chunked SSD vs recurrence {ssd_err:.3e} / "
                             f"{state_err:.3e} > {SSD_REL_TOL}")
    del model, seen
    torch.cuda.empty_cache()

    model = build_family("mamba2-1.3b", dev, torch.float32)
    s = cfg.ssm_chunk
    toks = torch.tensor([r.prompt[:s] for r in reqs[:4]], device=dev)
    full, _ = model.prefill(toks)
    _, caches = model.prefill(toks[:, : s - 1], cache_len=s)
    step, _ = model.serve_step(toks[:, s - 1:], s - 1, caches)
    dec_err = ((step[:, 0] - full).abs().max() / full.abs().max()).item()
    log(f"[mamba2] float32: prefill of {s - 1} tokens and one step vs prefill of {s}: "
        f"{dec_err:.3e} of the logits' largest magnitude (limit {DECODE_REL_TOL})")
    if not dec_err <= DECODE_REL_TOL:
        raise AssertionError(f"mamba2: decode consistency {dec_err:.3e} > {DECODE_REL_TOL}")
    del model, caches
    torch.cuda.empty_cache()
    rec.update(arch=cfg.name, layers=cfg.num_layers, dtype="bfloat16")
    return [rec], dict(ssd=ssd, decode_rel_err=dec_err)


def phase11_jamba(dev, launches):
    """(d) jamba's smoke config (its full-width superblock needs 90 GB): bf16
    held by the margin rule, float32 kernel and plain tokens equal."""
    recs, checks = [], {}
    for dtype, tag in ((torch.bfloat16, "jamba_bf16"), (torch.float32, "jamba_f32")):
        model = build_family("jamba-1.5-large-398b", dev, dtype, smoke=True)
        reqs = family_requests(model.cfg, FAMILY_WAVES["jamba"])
        attn = sum(kind == "attn" for kind, _ in model.kinds)
        rec, prec, check, _ = serve_and_hold(tag, model, reqs, dev, launches, attn)
        if dtype == torch.float32 and not check["tokens_equal"]:
            raise AssertionError("jamba float32: kernel and plain tokens differ")
        recs += [rec, prec]
        checks[tag] = check
        del model
        torch.cuda.empty_cache()
    return recs, checks


def vlm_positions(b, s, dev):
    """(B, S, 3) M-RoPE ids: an image grid over the first ``VLM_IMAGE[0]``
    positions, (t, h, w) = (0, i // w, i % w), text after it from the grid's
    largest id plus one (t = h = w)."""
    n, w = VLM_IMAGE
    i = torch.arange(s, device=dev)
    pos = torch.stack([torch.zeros_like(i), i // w, i % w], dim=-1)
    text = (i - n + (n - 1) // w + 1)[:, None].expand(s, 3)
    pos = torch.where((i < n)[:, None], pos, text)
    return pos.expand(b, s, 3)


def greedy_embeds(model, embeds, positions, new, use_kernel):
    """Prefill from embeddings, then ``new - 1`` greedy steps -> (tokens
    per row, each step's top-1 / top-2 margins, record)."""
    b, s = embeds.shape[:2]
    margins = []

    def pick(logits):
        top = torch.topk(logits.float(), 2, dim=-1).values
        margins.append((top[:, 0] - top[:, 1]).cpu().numpy())
        return torch.argmax(logits, dim=-1)

    t0 = time.perf_counter()
    last, caches = model.prefill(embeds=embeds, positions=positions, cache_len=s + new,
                                 use_kernel=use_kernel)
    tok = pick(last)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = [tok]
    for i in range(new - 1):
        logits, caches = model.serve_step(tok[:, None], s + i, caches)
        tok = pick(logits[:, 0])
        out.append(tok)
    torch.cuda.synchronize()
    rec = dict(batch=b, prompt_len=s, prefill_s=t1 - t0,
               decode_ms_per_step=1e3 * (time.perf_counter() - t1) / (new - 1))
    return torch.stack(out, dim=1).tolist(), margins, rec


def phase11_vlm(dev, launches):
    """(e) qwen2-vl-2b, whole: a prefill from embeddings with image-grid
    M-RoPE ids then greedy steps, kernel and plain, each prefill attention
    held to the plain version; then a text wave through ServeEngine."""
    from repro_torch.serve import Request

    model = build_family("qwen2-vl-2b", dev, torch.bfloat16)
    cfg = model.cfg
    b, s = 4, FAMILY_WAVES["qwen2vl"][0]
    gen = torch.Generator(device=dev).manual_seed(1)
    embeds = (0.02 * torch.randn((b, s, cfg.d_model), generator=gen, device=dev)).to(model.dtype)
    pos = vlm_positions(b, s, dev)
    greedy_embeds(model, embeds[:, :64], pos[:, :64], 2, "auto")  # warm-up
    toks, _, rec = counted("qwen2vl_embeds", launches,
                           lambda: greedy_embeds(model, embeds, pos, NEW_TOKENS, "auto"))
    plain, margins, prec = counted("qwen2vl_embeds_plain", launches,
                                   lambda: greedy_embeds(model, embeds, pos, NEW_TOKENS, False))
    attn = cfg.num_layers
    if launches["qwen2vl_embeds"]["flash_attention"] != attn:
        raise AssertionError(f"qwen2-vl embeddings prefill: {launches['qwen2vl_embeds']}")
    if any(launches["qwen2vl_embeds_plain"].values()):
        raise AssertionError(f"plain run launched {launches['qwen2vl_embeds_plain']}")
    errs = []
    with held_to_plain(errs):
        kern, _ = model.prefill(embeds=embeds, positions=pos)
    if len(errs) != attn:
        raise AssertionError(f"held {len(errs)} prefill attentions, want {attn}")
    want, _ = model.prefill(embeds=embeds, positions=pos, use_kernel=False)
    logit_err = (kern.float() - want.float()).abs().max().item()
    pseudo = [Request([0] * s, NEW_TOKENS) for _ in range(b)]  # one wave of b rows
    agree = margin_rule(toks, plain, margins, logit_err, pseudo)
    check = dict(logit_err=logit_err, agreement=agree, layer_abs_err=max(e for e, _ in errs),
                 layer_row_err=max(r for _, r in errs), image_positions=VLM_IMAGE[0])
    log(f"[qwen2vl] embeddings prefill (image grid {VLM_IMAGE}): {json.dumps(rec)}; plain "
        f"{json.dumps(prec)}; held {json.dumps({k: v for k, v in check.items() if k != 'agreement'})}")
    log(f"[qwen2vl] embeddings tokens, kernel vs plain: {json.dumps(agree)}")
    rec.update(path="qwen2vl_embeds", flash_launches=attn)
    prec.update(path="qwen2vl_embeds_plain")
    reqs = family_requests(cfg, FAMILY_WAVES["qwen2vl"])
    srec, sprec, scheck, _ = serve_and_hold("qwen2vl", model, reqs, dev, launches, attn)
    del model
    torch.cuda.empty_cache()
    for r in (rec, prec):
        r.update(arch=cfg.name, layers=cfg.num_layers)
    return [rec, prec, srec, sprec], dict(embeds=check, text=scheck)


def phase11_whisper(dev, launches):
    """(f) whisper-tiny, whole: frame embeddings, a short decoder prompt and
    greedy steps through ``EncDecLM.greedy``, kernel and plain; each prefill
    attention held to the plain version; float32 tokens equal."""
    recs, checks = [], {}
    for dtype, tag in ((torch.bfloat16, "whisper_bf16"), (torch.float32, "whisper_f32")):
        model = build_family("whisper-tiny", dev, dtype)
        cfg = model.cfg
        gen = torch.Generator(device=dev).manual_seed(2)
        frames = (0.02 * torch.randn((4, WHISPER_FRAMES, cfg.d_model), generator=gen,
                                     device=dev)).to(dtype)
        prompt = torch.randint(0, cfg.vocab_size, (4, WHISPER_PROMPT), generator=gen, device=dev)
        attn = cfg.encoder_layers + 2 * cfg.decoder_layers
        model.greedy(frames[:, :64], prompt, 2)  # warm-up
        toks, rec = counted(tag, launches, lambda: model.greedy(frames, prompt, NEW_TOKENS))
        plain, prec = counted(f"{tag}_plain", launches,
                              lambda: model.greedy(frames, prompt, NEW_TOKENS, use_kernel=False))
        if launches[tag]["flash_attention"] != attn or any(launches[f"{tag}_plain"].values()):
            raise AssertionError(f"{tag}: launches {launches[tag]}, plain "
                                 f"{launches[f'{tag}_plain']}; want {attn} flash")
        errs = []
        with held_to_plain(errs):
            kern, _ = model.prefill(frames, prompt)
        if len(errs) != attn:
            raise AssertionError(f"{tag}: held {len(errs)} prefill attentions, want {attn}")
        want, _ = model.prefill(frames, prompt, use_kernel=False)
        if not (0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size):
            raise AssertionError(f"{tag}: tokens out of range")
        same = torch.equal(toks, plain)
        if dtype == torch.float32 and not same:
            raise AssertionError(f"whisper float32: kernel and plain tokens differ: "
                                 f"{toks.tolist()} vs {plain.tolist()}")
        check = dict(logit_err=(kern.float() - want.float()).abs().max().item(),
                     layer_abs_err=max(e for e, _ in errs), layer_row_err=max(r for _, r in errs),
                     tokens_equal=same, distinct_tokens=len(set(toks.flatten().tolist())))
        for r, path in ((rec, tag), (prec, f"{tag}_plain")):
            r.update(path=path, arch=cfg.name, dtype=str(dtype)[6:], params=model.num_params(),
                     weight_bytes=model.weight_bytes(), enc_frames=WHISPER_FRAMES,
                     prompt_len=WHISPER_PROMPT, flash_launches=launches[path]["flash_attention"],
                     decode_ms_per_step=1e3 * r["decode_s"] / r["decode_steps"])
        log(f"[{tag}] {json.dumps(rec)}; plain {json.dumps(prec)}; held {json.dumps(check)}")
        recs += [rec, prec]
        checks[tag] = check
        del model
        torch.cuda.empty_cache()
    return recs, checks


def phase11(dev, launches):
    """The other LM families: (a) dbrx, (b) llama4-scout, (c) mamba2,
    (d) jamba, (e) qwen2-vl, (f) whisper; each model freed before the next."""
    recs, checks = [], {}
    parts = (("a dbrx", lambda: phase11_moe("dbrx", "dbrx-132b", dev, launches)),
             ("b llama4-scout", lambda: phase11_moe("llama4", "llama4-scout-17b-a16e", dev,
                                                    launches)),
             ("c mamba2", lambda: phase11_mamba(dev, launches)),
             ("d jamba", lambda: phase11_jamba(dev, launches)),
             ("e qwen2-vl", lambda: phase11_vlm(dev, launches)),
             ("f whisper", lambda: phase11_whisper(dev, launches)))
    for name, fn in parts:
        t0 = time.perf_counter()
        r, c = fn()
        recs += r
        checks[name.split()[1]] = c
        log(f"[phase] 11{name} {time.perf_counter() - t0:.3f} s")
    return recs, checks


# -- phase 8: the out-of-core surfaces ---------------------------------------

OOC_BLOCK = 65536  # block_obs of every phase-8 fit, as in phases 3 and 5
# Phase 8(c) writes the first CSV_ROWS rows of phase 3's data as CSV: an
# eighth of them (0.25 GB of text), cut for time (its parse pass took 94-96
# s at all 1,000,000 rows, 22.7 s at the 250,000 of PRs 21-24).
CSV_ROWS = 125_000
SERVICE_REF = "corral:1000000x1000"
CUSTOM_SHAPE = (10_000, 5_000)
# Cut from all 16 blocks of phase 5's rows, whose host encode in the staging
# pass took 55.7 s.
BINNED_SPILL_BLOCKS = 4
OOC_PATHS = ("ooc_tall_spill", "ooc_tall_replay", "ooc_binned_spill", "ooc_csv",
             "ooc_service", "ooc_custom")


@contextlib.contextmanager
def pass_clock(passes):
    """While open, append each streamed pass's wall seconds, as the fit
    consumes it (read, place, count, finalize), to ``passes``."""
    from repro_torch.core import streaming

    inner = streaming._score_pass

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        passes.append(time.perf_counter() - t0)
        return out

    streaming._score_pass = timed
    try:
        yield
    finally:
        streaming._score_pass = inner


@contextlib.contextmanager
def tally_count_inputs(tally):
    """While open, count the contingency kernel's launches by (X dtype, V, C)
    at the dispatcher; the wrapper's own counter is untouched."""
    from repro_torch.kernels import ops

    inner = ops.contingency_tables_cuda

    def counted(X, y, v, c):
        key = f"{str(X.dtype).removeprefix('torch.')} V={v} C={c}"
        tally[key] = tally.get(key, 0) + 1
        return inner(X, y, v, c)

    ops.contingency_tables_cuda = counted
    try:
        yield
    finally:
        ops.contingency_tables_cuda = inner


def spill_fit(name, fit, dev, launches):
    """``run_path`` with the per-pass clock and the count-input tally open:
    (result, record) with ``pass_s`` (the first a parse pass when the
    cache staged), ``count_inputs`` and the spill counters."""
    passes, inputs = [], {}
    with pass_clock(passes), tally_count_inputs(inputs):
        res, rec = run_path(name, fit, dev, launches)
    rec.update(pass_s=passes, count_inputs=inputs)
    log(f"[ooc] {name}: passes {json.dumps(passes)}; contingency launches by input "
        f"{json.dumps(inputs)}")
    return res, rec


def check_io(res, what, passes, blocks, parse, replay):
    io = res.result_.io
    cache = io.get("cache", {})
    got = (io["passes"], io["blocks_read"], cache.get("parse_passes"), cache.get("replay_passes"))
    if got != (passes, blocks, parse, replay):
        raise AssertionError(f"{what}: io {io}, want passes/blocks/parse/replay "
                             f"{(passes, blocks, parse, replay)}")


def check_against_record(res, rec, what):
    """Same selection as an earlier phase's recorded fit, gains in tolerance."""
    if res.selected_.tolist() != rec["selected"]:
        raise AssertionError(f"{what}: selected {res.selected_.tolist()} vs {rec['selected']}")
    np.testing.assert_allclose(res.gains_, rec["gains"], rtol=RTOL, atol=ATOL, err_msg=what)


def write_csv(path, X, y, chunk=65536):
    """CorrAL rows as CSV text, built with numpy byte operations: one digit a
    field (the values are 0/1), the label last, no header."""
    if X.min() < 0 or X.max() > 9 or y.min() < 0 or y.max() > 9:
        raise ValueError("write_csv writes single-digit values only")
    with open(path, "wb") as f:
        for lo in range(0, len(X), chunk):
            blk = np.concatenate([X[lo:lo + chunk], y[lo:lo + chunk, None]], axis=1)
            buf = np.empty((blk.shape[0], 2 * blk.shape[1]), np.uint8)
            buf[:, 0::2] = blk.astype(np.uint8) + ord("0")
            buf[:, 1::2] = ord(",")
            buf[:, -1] = ord("\n")
            f.write(buf.tobytes())


def dir_bytes(path) -> int:
    return sum(p.stat().st_size for p in pathlib.Path(path).rglob("*") if p.is_file())


def phase8(dev, launches, fits, keep, tmp):
    """The out-of-core and service surfaces on the card; every temporary
    file and spill directory lives under ``tmp`` (removed after phase 9)."""
    recs = {r["path"]: r for r in fits}
    out = dict(tall=phase8_tall(dev, launches, recs, keep, tmp))
    out["binned"], code_times = phase8_binned(dev, launches, recs, keep, tmp)
    out["csv"] = phase8_csv(dev, launches, keep, tmp)
    out["service"] = phase8_service(dev, launches, tmp)
    out["custom"], custom_times = phase8_custom(dev, launches)
    return out, code_times + custom_times


def phase8_tall(dev, launches, recs, keep, tmp):
    """(a) The tall CorrAL fit streamed through the spill cache with
    read-ahead: pass 1 parses and spills, passes 2..10 replay; then a second
    fit on the same directory parses nothing."""
    from repro_torch import ArraySource, MIScore, MRMRSelector

    X, y = keep["tall"]
    src = ArraySource(X, y)
    t0 = time.perf_counter()
    src.fingerprint()  # the spill entry's key: a content hash of 1 GB (set-up)
    fp_s = time.perf_counter() - t0
    spill = tmp / "spill_tall"

    blocks = -(-len(X) // OOC_BLOCK)  # 16 at 1,000,000 rows

    def fit():
        return MRMRSelector(10, score=MIScore(2, 2), block_obs=OOC_BLOCK, spill_dir=str(spill),
                            readahead=4).fit(src)

    a, arec = spill_fit("ooc_tall_spill", fit, dev, launches)
    check_against_record(a, recs["tall_streaming"], "spilled tall fit vs tall_streaming")
    check_io(a, "spilled tall fit", 10, 10 * blocks, 1, 9)
    counts = launches["ooc_tall_spill"]
    if counts["contingency_tables"] != 10 * blocks or counts["mi_scores"] == 0:
        raise AssertionError(f"spilled tall fit launches {counts}")
    if set(arec["count_inputs"]) != {"int8 V=2 C=2"}:
        raise AssertionError(f"spilled tall fit counted {arec['count_inputs']}")
    r, rrec = spill_fit("ooc_tall_replay", fit, dev, launches)
    check_against_record(r, recs["tall_streaming"], "replayed tall fit vs tall_streaming")
    check_io(r, "replayed tall fit", 10, 10 * blocks, 0, 10)
    if launches["ooc_tall_replay"]["contingency_tables"] != 10 * blocks:
        raise AssertionError(f"replayed tall fit launches {launches['ooc_tall_replay']}")
    # Where a replayed fit's time goes: the device's busy share.
    trace = device_breakdown(fit)
    log(f"[ooc] replayed tall fit, traced: {json.dumps(trace)}")
    spilled = dir_bytes(spill)
    log(f"[ooc] tall: fingerprint {fp_s:.3f} s; spill {spilled} bytes on disk; "
        f"fit {arec['seconds']:.3f} s (parse + 9 replays), {rrec['seconds']:.3f} s (10 replays)")
    return dict(spill=str(spill), fingerprint_s=fp_s, spilled_bytes=spilled,
                fit=arec, replay_fit=rrec, replay_trace=trace, selected=a.selected_.tolist(),
                gains=[float(g) for g in a.gains_])


def phase8_binned(dev, launches, recs, keep, tmp):
    """(b) The tall continuous bins=16 fit through the spill cache, on the
    first ``BINNED_SPILL_BLOCKS`` blocks of phase 5's rows: the staging pass
    encodes on the host and spills int8 codes, the nine replay passes count
    them; the bin-code kernel does not run.  Held to the unspilled streamed
    fit of the same rows (the device encode).  Then the replayed int8 code
    block's counts, bitwise against the plain version and timed."""
    from repro_torch import ArraySource, BinnedSource, MRMRSelector
    from repro_torch.data.block_cache import BlockCacheSource
    from repro_torch.kernels import ref
    from repro_torch.kernels.contingency import contingency_tables_cuda

    whole = keep["binned_src"]
    rows = min(whole.num_obs, BINNED_SPILL_BLOCKS * OOC_BLOCK)
    src = ArraySource(whole.X[:rows], whole.y[:rows])
    spill = tmp / "spill_binned"
    blocks = -(-src.num_obs // OOC_BLOCK)
    _, streamed = run_path("ooc_binned_unspilled",
                           lambda: MRMRSelector(10, bins=16, block_obs=OOC_BLOCK).fit(src), dev,
                           launches)
    res, rec = spill_fit(
        "ooc_binned_spill",
        lambda: MRMRSelector(10, bins=16, block_obs=OOC_BLOCK, spill_dir=str(spill)).fit(src),
        dev, launches)
    check_against_record(res, streamed, "spilled binned fit vs the unspilled streamed fit")
    check_io(res, "spilled binned fit", 10, 10 * blocks, 1, 9)
    counts = launches["ooc_binned_spill"]
    if counts["bin_codes"] != 0:
        raise AssertionError(f"spilled binned fit ran the bin-code kernel: {counts}")
    if counts["contingency_tables"] != 10 * blocks or counts["mi_scores"] == 0:
        raise AssertionError(f"spilled binned fit launches {counts}")
    if set(rec["count_inputs"]) != {"int8 V=16 C=2", "int8 V=16 C=16"}:
        raise AssertionError(f"spilled binned fit counted {rec['count_inputs']}")
    cache = res.result_.io["cache"]
    spilled = dir_bytes(spill)
    log(f"[ooc] binned: spilled {cache['parsed_bytes']} bytes of int8 codes and labels "
        f"({spilled} on disk) for {src.X.nbytes + src.y.nbytes} bytes of float32 blocks; "
        f"replayed {cache['replayed_bytes']} bytes")

    # One replayed block, as the replay passes read it (memmapped int8): a
    # hit on the fit's spill entry, not a block staged anew.
    cached = BlockCacheSource(BinnedSource(src, 16, fit_block_obs=OOC_BLOCK), str(spill))
    it = cached.iter_blocks(OOC_BLOCK)
    Xr, yr = next(it)
    it.close()
    if Xr.dtype != np.int8 or Xr.shape != (min(OOC_BLOCK, src.num_obs), src.num_features):
        raise AssertionError(f"replayed codes {Xr.dtype} {Xr.shape}")
    hit = (cached.counters["parse_passes"], cached.counters["replay_passes"])
    if not isinstance(Xr, np.memmap) or hit != (0, 1):
        raise AssertionError(f"the code block is not a replay of the fit's spill: "
                             f"{type(Xr).__name__}, counters {cached.counters}")
    Xd = torch.from_numpy(np.array(Xr)).to(dev)
    code_times = []
    shape = "x".join(map(str, Xr.shape))
    for label, tgt, c in ((f"{shape} int8 codes V=16 C=2 (spilled binned relevance)",
                           torch.from_numpy(np.array(yr)).to(dev, torch.int32), 2),
                          (f"{shape} int8 codes V=16 C=16 (spilled binned redundancy)",
                           Xd[:, 3].to(torch.int32), 16)):
        if not torch.equal(contingency_tables_cuda(Xd, tgt, 16, c),
                           ref.contingency_tables(Xd, tgt, 16, c)):
            raise AssertionError(f"contingency {label}: counts differ")
        log(f"[contingency] {label}: bitwise equal")
        code_times.append(time_contingency(Xd, tgt, 16, c, label, reps=40))
    return dict(fit=rec, parsed_bytes=cache["parsed_bytes"], spilled_bytes=spilled,
                float_bytes=int(src.X.nbytes + src.y.nbytes)), code_times


def phase8_csv(dev, launches, keep, tmp):
    """(c) The first CSV_ROWS rows of the tall CorrAL data written to CSV and
    fitted through CSVSource with the spill cache and read-ahead: one parse
    pass, nine replays; the selection and gains of an in-memory fit of the
    same rows."""
    from repro_torch import MIScore, MRMRSelector
    from repro_torch.data.sources import CSVSource

    X, y = (a[:CSV_ROWS] for a in keep["tall"])
    rows = len(X)
    path = tmp / "corral.csv"
    t0 = time.perf_counter()
    write_csv(path, X, y)
    write_s = time.perf_counter() - t0
    res, rec = spill_fit(
        "ooc_csv",
        lambda: MRMRSelector(10, score=MIScore(2, 2), block_obs=OOC_BLOCK,
                             spill_dir=str(tmp / "spill_csv"), readahead=4).fit(
            CSVSource(str(path), dtype=np.int8, target_dtype=np.int8)),
        dev, launches)
    blocks = -(-rows // OOC_BLOCK)
    check_io(res, "CSV fit", 10, 10 * blocks, 1, 9)
    ref = MRMRSelector(10, score=MIScore(2, 2), device=dev).fit(X, y)
    check_against_record(res, dict(selected=ref.selected_.tolist(), gains=ref.gains_),
                         "CSV fit vs the in-memory fit of its rows")
    counts = launches["ooc_csv"]
    if counts["contingency_tables"] != 10 * blocks or counts["mi_scores"] == 0:
        raise AssertionError(f"CSV fit launches {counts}")
    parse_s, replay_s = rec["pass_s"][0], rec["pass_s"][1:]
    log(f"[ooc] csv: {rows} rows, {path.stat().st_size} bytes written in {write_s:.3f} s; "
        f"fit {rec['seconds']:.3f} s; parse pass {parse_s:.3f} s; replay passes "
        f"{json.dumps(replay_s)}")
    return dict(rows=rows, csv_bytes=path.stat().st_size, write_s=write_s,
                parse_pass_s=parse_s, replay_pass_s=replay_s, fit=rec)


def phase8_service(dev, launches, tmp):
    """(d) SelectionService(workers=2) on the card over ``corral:1000000x1000``
    with the spill cache: two identical requests at once run the engine once,
    a distinct one (L=5) runs in the other worker meanwhile, a third identical
    request is a cache hit that launches nothing.  The results equal direct
    streamed fits of the same source with no spill cache, so a fault in the
    service's staging cannot agree with itself.  (The ref names CorralSource's generator, seeded
    by chunk: other rows than phase 3's arrays, so (a)'s fit is repeated on
    them here.)"""
    from repro_torch import ArraySource, CorralSource, MIScore, MRMRSelector
    from repro_torch.serve.selection import SelectionService

    ref, spill = SERVICE_REF, str(tmp / "spill_service")
    knobs = dict(score=MIScore(2, 2), block_obs=OOC_BLOCK, spill_dir=spill)
    rows, cols = (int(v) for v in ref.split(":")[1].split("x"))
    blocks = -(-rows // OOC_BLOCK)
    ids = {}
    barrier = threading.Barrier(2)

    def stampede(svc, i):
        barrier.wait()
        ids[i] = svc.submit(ref, num_select=10, **knobs)

    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    with SelectionService(workers=2, device="cuda") as svc:
        threads = [threading.Thread(target=stampede, args=(svc, i)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        if len(ids) != 2:
            raise AssertionError("the stampede's submissions did not return")
        ids["distinct"] = svc.submit(ref, num_select=5, **knobs)
        res = {k: svc.result(ids[k], timeout=900) for k in (0, 1, "distinct")}
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k: w.launches for k, w in wrappers.items()}
        info = {k: svc.poll(ids[k]).to_dict() for k in (0, 1, "distinct")}
        third = svc.submit(ref, num_select=10, **knobs)
        hit = svc.poll(third).to_dict()
        third_res = svc.result(third, timeout=10)
        stats = svc.stats()
    launches["ooc_service"] = counts
    after = {k: w.launches for k, w in wrappers.items()}
    log(f"[ooc] service: {seconds:.3f} s; launches {json.dumps(counts)}; jobs "
        f"{json.dumps(info)}; third {json.dumps(hit)}; stats {json.dumps(stats)}")
    # Two identical requests, one engine run: (10 + 5) passes of the blocks.
    if counts["contingency_tables"] != (10 + 5) * blocks:
        raise AssertionError(f"service launches {counts}: the stampede ran twice?")
    if stats["coalesced"] != 1 or sum(info[k]["coalesced_into"] is not None for k in (0, 1)) != 1:
        raise AssertionError(f"service coalescing {stats} {info}")
    if not hit["cache_hit"] or hit["attempts"] != 0 or after != counts:
        raise AssertionError(f"third request: {hit}, launches {after} after {counts}")
    primary = 0 if info[0]["coalesced_into"] is None else 1
    d, p = info["distinct"], info[primary]
    overlap = d["started_at"] < p["finished_at"] and p["started_at"] < d["finished_at"]
    if not overlap:
        raise AssertionError(f"the distinct request did not run beside the first: {info}")
    # The results against a direct fit of the same rows, generated anew by a
    # fresh source into arrays (one generation pass, where every pass of a
    # direct fit would generate them again); nothing is read from the
    # service's spill.  The greedy picks do not depend on L: the L=5
    # request is the direct fit's first five picks and gains.
    t0 = time.perf_counter()
    fresh = list(CorralSource(rows, cols).iter_blocks(OOC_BLOCK))
    fresh = ArraySource(np.concatenate([b[0] for b in fresh]),
                        np.concatenate([b[1] for b in fresh]))
    direct = MRMRSelector(10, score=MIScore(2, 2), block_obs=OOC_BLOCK).fit(fresh)
    direct_s = time.perf_counter() - t0
    if direct.result_.io.get("cache") is not None or direct.result_.io["passes"] != 10:
        raise AssertionError(f"direct fit io {direct.result_.io}")
    for k, L in ((0, 10), (1, 10), ("distinct", 5)):
        r = res[k]
        if r.selected.tolist() != direct.selected_[:L].tolist():
            raise AssertionError(f"service result {k}: {r.selected.tolist()} vs "
                                 f"{direct.selected_[:L].tolist()}")
        np.testing.assert_allclose(r.gains.numpy(), direct.gains_[:L], rtol=RTOL, atol=ATOL)
    if third_res.selected.tolist() != res[0].selected.tolist():
        raise AssertionError("the cache hit's result differs")
    if set(direct.selected_[:9].tolist()) != set(range(9)):
        raise AssertionError(f"service source's first nine picks {direct.selected_[:9]}")
    log(f"[ooc] service: the rows generated anew and a direct unspilled fit (L=10) "
        f"{direct_s:.3f} s, equal")
    return dict(seconds=seconds, launches=counts, jobs=info, third=hit, stats=stats,
                direct_s=direct_s, selected={str(k): res[k].selected.tolist() for k in res})


def phase8_custom(dev, launches):
    """(e) The paper's custom-score path (Listing 7) on the card: CorrAL
    10,000 x 5,000, mrmr_custom_score(MIScore) on the alternative encoding,
    recomputed every pick.  ``get_result`` is vmapped over candidate chunks
    and each chunk's relevance and redundancy are one launch each of the
    contingency and MI kernels; the fit selects what MIScore selects, with
    what the same vmapped score selects in plain torch (``use_kernel=False``)
    on the same tensors, and reports a NaN relevance."""
    from repro_torch import MIScore, MRMRSelector, mrmr_custom_score
    from repro_torch.core import scores
    from repro_torch.data.synthetic import corral_dataset_np

    X, y = corral_dataset_np(*CUSTOM_SHAPE, seed=0)
    Xd, yd = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    L = 5
    custom, rec = run_path(
        "ooc_custom",
        lambda: MRMRSelector(L, score=mrmr_custom_score(MIScore(2, 2)),
                             encoding="alternative").fit(Xd, yd),
        dev, launches)
    m, n = CUSTOM_SHAPE
    chunk = max(1, scores._CUSTOM_CHUNK_ELEMS // (m * (L + 1)))  # candidates a call
    chunks = -(-n // chunk)
    counts = launches["ooc_custom"]
    want = 2 * L * chunks  # a relevance and a redundancy launch a chunk a pick
    if (counts["contingency_tables"], counts["mi_scores"]) != (want, want):
        raise AssertionError(f"custom fit launches {counts}, want {want} of each "
                             f"({chunks} chunks a pick)")
    builtin = MRMRSelector(L, score=MIScore(2, 2), encoding="alternative").fit(Xd, yd)
    check_same_selection(custom, builtin, "CustomScore vs MIScore")
    t0 = time.perf_counter()
    plain = MRMRSelector(L, score=mrmr_custom_score(MIScore(2, 2, use_kernel=False)),
                         encoding="alternative").fit(Xd, yd)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    check_same_selection(custom, plain, "CustomScore through the kernels vs plain")
    if not np.isnan(custom.scores_).all() or custom.scores_.shape != (n,):
        raise AssertionError("a CustomScore fit's relevance is not all NaN")
    # One pick's full scores, kernels against the plain version.
    Xr = Xd.T.contiguous()
    sel = torch.zeros((L, m), dtype=torch.float32, device=dev)
    sel[:2] = Xr[custom.selected_[:2].tolist()].to(torch.float32)
    got = mrmr_custom_score(MIScore(2, 2)).full_score(Xr, yd, sel, 2)
    ref_scores = mrmr_custom_score(MIScore(2, 2, use_kernel=False)).full_score(Xr, yd, sel, 2)
    np.testing.assert_allclose(got.cpu(), ref_scores.cpu(), rtol=RTOL, atol=ATOL,
                               err_msg="custom full_score, kernels vs plain")
    err = float((got - ref_scores).abs().max())
    log(f"[ooc] custom: {m}x{n}, L={L}, recompute path: {rec['seconds']:.3f} s, peak "
        f"{rec['peak_mem_bytes']} bytes; {chunks} chunks a pick, launches "
        f"{json.dumps(counts)}; the plain vmapped fit {plain_s:.3f} s; one pick's "
        f"scores max abs err {err:.3g}")
    # The count inputs of one chunk, as the vmap rule hands them to the
    # kernel: the candidates' feature-major view against the class, and
    # the selected rows' values fused with each candidate's (x * 2 + v,
    # int32) against one class.
    b = min(chunk, n)
    cands = Xr[:b].T
    fused = (sel.T.to(torch.int32)[:, None, :] * 2 + cands.to(torch.int32)[:, :, None]).flatten(1)
    zero = torch.zeros((m,), dtype=torch.int32, device=dev)
    times = [time_contingency(cands, yd.to(torch.int32), 2, 2,
                              f"{m}x{b} int8 feature-major view (custom relevance chunk)", reps=40),
             time_contingency(fused, zero, 4, 1,
                              f"{m}x{b * L} int32 fused codes, V=4 C=1 (custom redundancy chunk)",
                              reps=40)]
    return dict(rec, plain_s=plain_s, chunks=chunks, max_abs_err=err), times


# -- phase 9: the multi-process map-reduce ------------------------------------

MH_WIDE = (10_000, 50_000)  # phase 4's data
MH_GRID = (40_000, 40_000)  # aspect 1: the automatic rule resolves (2, 2) on 4 hosts
MH_PATHS = ("mh_tall", "mh_wide", "mh_grid")
# block_obs of each run, and each worker's passes and blocks a pass, reckoned
# before the run: (a) L=10 passes of ceil(500,000 / 65,536) = 8 blocks; (b)
# one block of all 10,000 rows, 1 relevance pass + 5 to 9 redundancy passes
# (L-1 = 9 vectors, q=2 a pass, a speculated vector a hit or a miss); (c)
# one block of a host's 20,000 rows, L=5 passes.  (b) and (c) take a block
# of the rows there are: a shorter block is padded to block_obs rows.
MH_BLOCK = dict(mh_tall=65536, mh_wide=MH_WIDE[0], mh_grid=MH_GRID[0] // 2)
MH_EXPECT = dict(mh_tall=((10,), 8), mh_wide=(tuple(range(6, 11)), 1), mh_grid=((5,), 1))


def expected_worker_launches(name, passes, blocks):
    """A worker's (contingency, MI) launches, reckoned from the engine: one
    count a block a candidate, one MI launch a finalised state (two a
    conditional pass: the marginal and the class-major view), per pass."""
    if name == "mh_tall":  # mid, q=1: L passes of ``blocks`` blocks
        return blocks * passes, passes
    if name == "mh_wide":  # q=2: the relevance pass, then 2 states a pass
        return blocks * (2 * passes - 1), 2 * passes - 1
    # jmi, q=1: relevance, then L-1 conditional passes
    return blocks * passes, 1 + 2 * (passes - 1)


def mh_single(name, dev, launches, X, y, L, crit="mid", q=1):
    """The one-process streaming fit on the card that a run is held to:
    the same arrays (in memory), the same knobs."""
    from repro_torch import ArraySource, MIScore, MRMRSelector

    return run_path(f"{name}_single", lambda: MRMRSelector(
        L, score=MIScore(2, 2), block_obs=MH_BLOCK[name], criterion=crit,
        batch_candidates=q, device=dev).fit(ArraySource(X, y)), dev, launches)[1]


def mh_run(name, dev, launches, tmp, X, y, one, hosts, grid, L, extra, crit="mid", q=1):
    """Write (X, y) with ``np.save`` and fit the files through
    ``repro_torch.launch.select_multihost`` with ``hosts`` workers sharing the
    card; held to ``one`` (the record of a one-process fit of the same data):
    the same picks, bitwise the same gains and passes, every worker on the
    card with the launches the engine makes, each host's share of the bytes."""
    from repro_torch.device import device_name

    xp, yp = tmp / f"{name}_X.npy", tmp / f"{name}_y.npy"
    t0 = time.perf_counter()
    np.save(xp, X)
    np.save(yp, y)
    save_s = time.perf_counter() - t0
    cmd = [sys.executable, "-m", "repro_torch.launch.select_multihost",
           "--num-processes", str(hosts), "--input", str(xp), "--target", str(yp),
           "--select", str(L), "--criterion", crit, "--block-obs", str(MH_BLOCK[name]),
           "--batch-candidates", str(q), "--device", dev.type, "--timeout", "300", *extra]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{name}: the launcher failed (rc={proc.returncode})\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    if out["selected"] != one["selected"]:
        raise AssertionError(f"{name}: selected {out['selected']} vs one process {one['selected']}")
    if out["gains"] != one["gains"]:
        raise AssertionError(f"{name}: gains {out['gains']} are not bitwise the one-process "
                             f"{one['gains']}")
    hosts_io = out["hosts"]
    if hosts_io["grid"] != list(grid):
        raise AssertionError(f"{name}: grid {hosts_io['grid']}, want {list(grid)}")
    agg = hosts_io["aggregate"]
    shares = [h["bytes_read"] / agg["bytes_read"] for h in hosts_io["per_host"]]
    if any(abs(sh - 1 / hosts) > 0.05 for sh in shares):
        raise AssertionError(f"{name}: bytes shares {shares}, want 1/{hosts} +- 0.05")
    counts = dict(contingency_tables=0, mi_scores=0)
    want = {}
    passes_ok, blocks_want = MH_EXPECT[name]
    for pid, w in out["workers"].items():
        io = hosts_io["per_host"][int(pid)]
        if (io["passes"] not in passes_ok or io["passes"] != one["io"]["passes"]
                or io["blocks_read"] != blocks_want * io["passes"]):
            raise AssertionError(f"{name}: worker {pid} ledger {io}, want passes in {passes_ok} "
                                 f"(one process: {one['io']['passes']}) of {blocks_want} blocks")
        want[pid] = dict(zip(("contingency_tables", "mi_scores"),
                             expected_worker_launches(name, io["passes"], blocks_want)))
        if not w["device"].startswith(dev.type) or w["device_name"] != device_name(dev):
            raise AssertionError(f"{name}: worker {pid} ran on {w['device']} {w['device_name']}")
        if w["launches"] != want[pid] or min(w["launches"].values()) == 0:
            raise AssertionError(f"{name}: worker {pid} launches {w['launches']}, want {want[pid]}")
        for k in counts:
            counts[k] += w["launches"][k]
    launches[name] = dict(counts, bin_codes=0, pearson_corr=0, flash_attention=0)
    log(f"[mh] {name}: {hosts} workers on {out['workers']['0']['device']}, grid {hosts_io['grid']}; "
        f"wall {wall:.3f} s (launcher {out['wall_seconds']:.3f} s), slowest worker's fit "
        f"{out['seconds']:.3f} s, one process {one['seconds']:.3f} s; np.save {save_s:.3f} s")
    for pid, w in out["workers"].items():
        log(f"[mh] {name} host {pid}: {json.dumps(hosts_io['per_host'][int(pid)])} "
            f"share {shares[int(pid)]:.4f}; fit {w['seconds']:.3f} s (set-up before it "
            f"{w['setup_seconds']:.3f} s); launches "
            f"{json.dumps(w['launches'])} (reckoned {json.dumps(want[pid])}); windows "
            f"{w['host']['obs_range']} x {w['host']['col_range']}")
    return dict(path=name, hosts=hosts, grid=hosts_io["grid"], block_obs=MH_BLOCK[name],
                wall_s=wall, launcher_wall_s=out["wall_seconds"], slowest_fit_s=out["seconds"],
                single_process_s=one["seconds"], save_s=save_s, per_host=hosts_io["per_host"],
                shares=shares, workers=out["workers"], launches=counts,
                selected=out["selected"], gains=out["gains"])


def phase9(dev, launches, fits, keep, tmp):
    """The paper's multi-process map-reduce on one card: (a) tall, 2 workers,
    grid (2, 1); (b) wide, 2 workers, grid (1, 2), q=2, spill; (c) 2-D, 4
    workers, grid (2, 2), ``jmi``.  N CUDA contexts time-sliced on one device,
    the collectives on the host (gloo): what this measures is the path, not
    cluster scaling.  Then kernel 2 (the class-fused count) at (c)'s block."""
    from repro_torch.data.synthetic import corral_dataset_np

    out = {}
    X, y = keep["tall"]  # phase 3's arrays; its streaming fit is the same fit in one process
    tall_one = next(r for r in fits if r["path"] == "tall_streaming")
    out["tall"] = mh_run("mh_tall", dev, launches, tmp, X, y, tall_one, 2, (2, 1), 10, [])
    X, y = corral_dataset_np(*MH_WIDE, seed=0)
    spill = tmp / "mh_spill"
    one = mh_single("mh_wide", dev, launches, X, y, 10, q=2)
    out["wide"] = mh_run("mh_wide", dev, launches, tmp, X, y, one, 2, (1, 2), 10,
                         ["--spill-dir", str(spill)], q=2)
    entries = sorted(p.name for p in spill.iterdir())
    if len(entries) != 2 or {e.rsplit("-", 1)[1] for e in entries} != {"h0", "h1"}:
        raise AssertionError(f"mh_wide: spill entries {entries}, want one each for h0 and h1")
    log(f"[mh] mh_wide: spill entries {entries}; caches "
        f"{json.dumps({p: w['cache'] for p, w in out['wide']['workers'].items()})}")
    out["wide"]["spill_entries"] = entries
    t0 = time.perf_counter()
    X, y = corral_dataset_np(*MH_GRID, seed=0)
    log(f"[mh] grid data {MH_GRID[0]}x{MH_GRID[1]} int8 made in {time.perf_counter() - t0:.3f} s")
    one = mh_single("mh_grid", dev, launches, X, y, 5, crit="jmi")
    out["grid"] = mh_run("mh_grid", dev, launches, tmp, X, y, one, 4, (2, 2), 5, [], crit="jmi")
    # Kernel 2 at (c)'s redundancy block, as host (0, 0) counts it: its rows
    # and columns, the first pick appended (20,001 one-byte columns: rows
    # aligned to no more than a byte), against that column fused with the
    # class; then the same rows without the appended column.
    rows, cols = MH_GRID[0] // 2, MH_GRID[1] // 2
    c = out["grid"]["selected"][0]
    yb = torch.from_numpy(y[:rows]).to(dev, torch.int32)
    timings = []
    for label, block in ((f"{rows}x{cols + 1} int8 VC=4 (2-D jmi redundancy block, phase 9)",
                          np.concatenate([X[:rows, :cols], X[:rows, c:c + 1]], axis=1)),
                         (f"{rows}x{cols} int8 VC=4 (the same rows, no appended column)",
                          np.ascontiguousarray(X[:rows, :cols]))):
        Xb = torch.from_numpy(block).to(dev)
        timings.append(time_conditional(Xb, Xb[:, c].clone(), yb, label, reps=20))
        del Xb, block
    keep["grid"] = (X, y)  # phase 10's 2-D grid fits the same data
    torch.cuda.empty_cache()
    return out, timings


# -- phase 10: the in-process device mesh -------------------------------------

MESH_PATHS = ("mesh_tall", "mesh_tall_streaming", "mesh_binned_streaming", "mesh_wide",
              "mesh_wide_streaming", "mesh_grid", "mesh_pearson")


def expected_mesh_launches(name, passes, blocks=1):
    """A mesh run's (contingency, MI) launches, reckoned from the engine: one
    count a shard (a tile) a pass, streamed a tile a block; MI once a
    feature group a pass (a conditional pass twice: the marginal and the
    class-major view)."""
    if name == "mesh_tall":  # (4,) data: 4 shards a pass, one feature group
        return 4 * passes, passes
    if name == "mesh_wide":  # (4,) model: 4 shards, each its own group
        return 4 * passes, 4 * passes
    if name == "mesh_grid":  # (2, 2) jmi: 4 tiles; 2 groups, 1 + 2 MI a pass each
        return 4 * passes, 2 + 2 * 2 * (passes - 1)
    if name == "mesh_tall_streaming":  # (2,) data: 2 tiles a block, one group
        return 2 * blocks * passes, passes
    if name == "mesh_wide_streaming":  # (2,) model: 2 tiles a block, 2 groups
        return 2 * blocks * passes, 2 * passes
    if name == "mesh_binned_streaming":  # (3,) model: 3 tiles a block, 3 groups
        return 3 * blocks * passes, 3 * passes
    raise KeyError(name)


def phase10(dev, launches, fits, keep):
    """The in-process device mesh on one card: meshes of 2 or 4 positions,
    every one ``cuda:0``, so the shards run one after another on one stream.
    (a) phase 3's tall data on (4,) data; (b) phase 4's wide data on (4,)
    model; (c) phase 9's 40,000 x 40,000 ``jmi`` L=5 on a (2, 2) grid; (d)
    phase 3's data streamed at 65,536 rows on (2,) data; (e) phase 4's data
    streamed at 10,000 rows on (2,) model, the state feature-sharded; (f)
    phase 6's continuous data, Pearson, on (2,) model; (g) phase 5's
    continuous data, bins=16, L=4, streamed on (3,) model with the edges
    feature-sharded.  Each is held to the one-device card fit of the same
    data (picks equal, MI gains bitwise,
    Pearson within ``CORR_RTOL``/``CORR_ATOL``) and to its launches; then
    the new per-shard kernel shapes are timed.  A path, not a speed-up: no
    gain is claimed."""
    from repro_torch import ArraySource, MIScore, MRMRSelector
    from repro_torch.dist.meshes import make_mesh

    def mesh(shape, axes):
        return make_mesh(shape, axes, devices=[dev] * 4)

    one = {r["path"]: r for r in fits}
    out, timings = {}, []

    def held(name, rec, ref, exact=True):
        if rec["selected"] != ref["selected"]:
            raise AssertionError(f"{name}: selected {rec['selected']} vs one device "
                                 f"{ref['selected']}")
        if exact and rec["gains"] != ref["gains"]:
            raise AssertionError(f"{name}: gains {rec['gains']} are not bitwise the one-device "
                                 f"{ref['gains']}")
        if not exact:
            np.testing.assert_allclose(rec["gains"], ref["gains"], rtol=CORR_RTOL,
                                       atol=CORR_ATOL, err_msg=name)

    def counted(name, want):
        got = (launches[name]["contingency_tables"], launches[name]["mi_scores"])
        if got != want:
            raise AssertionError(f"{name}: launches {launches[name]}, reckoned {want}")
        log(f"[mesh] {name}: contingency, MI launches {got} as reckoned")

    def plan_of(name, res, encoding, shape):
        p = res.plan_
        if (p.encoding, p.mesh_shape, res.mesh_.size) != (encoding, shape, int(np.prod(shape))):
            raise AssertionError(f"{name}: plan {p.encoding} {p.mesh_shape} on {res.mesh_}")
        if {str(d) for d in res.mesh_.devices.flat} != {str(dev)}:
            raise AssertionError(f"{name}: mesh positions {res.mesh_}")

    # (a) tall in memory and (d) streamed, phase 3's arrays
    X, y = keep["tall"]
    Xd, yd = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    m = mesh((4,), ("data",))
    res, rec = run_path("mesh_tall", lambda: MRMRSelector(10, mesh=m).fit(Xd, yd), dev, launches)
    plan_of("mesh_tall", res, "conventional", (4,))
    held("mesh_tall", rec, one["tall_conventional"])
    counted("mesh_tall", expected_mesh_launches("mesh_tall", 10))
    rec["trace"] = device_breakdown(lambda: MRMRSelector(10, mesh=m).fit(Xd, yd))
    log(f"[mesh] warm (4,) data fit, traced: {json.dumps(rec['trace'])}")
    out["tall"] = dict(rec, single_s=one["tall_conventional"]["seconds"])
    timings.append(time_contingency(Xd[:250_000], yd[:250_000], 2, 2,
                                    "250000x1000 int8 (a (4,) data shard, phase 10)", flush=True))
    timings.append(time_contingency(Xd[:32768], yd[:32768], 2, 2,
                                    "32768x1000 int8 (half a streamed block, phase 10)", reps=40, flush=True))
    del Xd, yd
    m = mesh((2,), ("data",))
    res, rec = run_path("mesh_tall_streaming", lambda: MRMRSelector(
        10, score=MIScore(2, 2), block_obs=65536, mesh=m).fit(ArraySource(X, y)), dev, launches)
    plan_of("mesh_tall_streaming", res, "streaming", (2,))
    held("mesh_tall_streaming", rec, one["tall_streaming"])
    blocks = -(-X.shape[0] // 65536)  # 16 at 1,000,000 rows
    if (rec["io"]["passes"], rec["io"]["blocks_read"]) != (10, 10 * blocks):
        raise AssertionError(f"mesh_tall_streaming ledger {rec['io']}")
    counted("mesh_tall_streaming", expected_mesh_launches("mesh_tall_streaming", 10, blocks))
    out["tall_streaming"] = dict(rec, single_s=one["tall_streaming"]["seconds"])

    # (g) phase 5's continuous data, bins=16, streamed on (3,) model: the
    # fitted edges cut into three feature shards (1000 columns padded to
    # 1002: the last shard's two edge rows +inf), each block's tiles encoded
    # on their position, once a tile a block.  Cut to L=4 (the host copies
    # a block's column tiles, 2.3x phase 5's fit at L=10): its picks and
    # gains are the first 4 of phase 5's L=10 fit, whose greedy steps they are.
    src, depth = keep["binned_src"], 4
    m = mesh((3,), ("model",))
    res, rec = run_path("mesh_binned_streaming", lambda: MRMRSelector(
        depth, bins=16, block_obs=65536, mesh=m).fit(src), dev, launches)
    plan_of("mesh_binned_streaming", res, "streaming", (3,))
    if (res.plan_.bins, res.plan_.feat_axes) != (16, ("model",)):
        raise AssertionError(f"mesh_binned_streaming: plan {res.plan_}")
    ref5 = one["tall_binned_streaming"]
    held("mesh_binned_streaming", rec, dict(selected=ref5["selected"][:depth],
                                            gains=ref5["gains"][:depth]))
    if (rec["io"]["passes"], rec["io"]["blocks_read"]) != (depth, depth * blocks):
        raise AssertionError(f"mesh_binned_streaming ledger {rec['io']}")
    counted("mesh_binned_streaming",
            expected_mesh_launches("mesh_binned_streaming", depth, blocks))
    if launches["mesh_binned_streaming"]["bin_codes"] != 3 * blocks * depth:
        raise AssertionError(f"mesh_binned_streaming: bin_codes launches "
                             f"{launches['mesh_binned_streaming']}, reckoned {3 * blocks * depth}")
    out["binned_streaming"] = dict(rec, single_s=one["tall_binned_streaming"]["seconds"])
    # The last tile's encode: 332 columns and 2 padded ones, their edges +inf.
    rng = np.random.default_rng(10)
    Xt, et = planted_block(rng, 65536, 332, 15)
    Xt = np.concatenate([Xt, np.zeros((65536, 2), np.float32)], axis=1)
    et = np.concatenate([et, np.full((2, 15), np.inf, np.float32)])
    Xtd, etd = torch.from_numpy(Xt).to(dev), torch.from_numpy(et).to(dev)
    bin_times = [check_bins(Xtd, etd, "65536x334 E=15, the last 2 edge rows +inf (the last "
                            "tile of a (3,) model mesh, phase 10)", reps=40)]
    del Xtd, etd

    # (b) wide in memory and (e) streamed, phase 4's arrays
    X, y = keep["wide"]
    Xd, yd = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    m = mesh((4,), ("model",))
    res, rec = run_path("mesh_wide", lambda: MRMRSelector(10, mesh=m).fit(Xd, yd), dev, launches)
    plan_of("mesh_wide", res, "alternative", (4,))
    held("mesh_wide", rec, one["wide_alternative"])
    counted("mesh_wide", expected_mesh_launches("mesh_wide", 10))
    out["wide"] = dict(rec, single_s=one["wide_alternative"]["seconds"])
    for lo in (0, 12_500):  # shard 0, and shard 1: its rows start 12,500 bytes in
        timings.append(time_contingency(
            Xd[:, lo:lo + 12_500], yd, 2, 2, f"10000x12500 int8 column window at column {lo} "
            f"(a (4,) model shard of the 10000x50000 matrix, phase 10)", flush=True))
    del Xd, yd
    m = mesh((2,), ("model",))
    _, single = run_path("mesh_wide_streaming_single", lambda: MRMRSelector(
        10, score=MIScore(2, 2), block_obs=10_000).fit(ArraySource(X, y)), dev, launches)
    res, rec = run_path("mesh_wide_streaming", lambda: MRMRSelector(
        10, score=MIScore(2, 2), block_obs=10_000, mesh=m).fit(ArraySource(X, y)), dev, launches)
    plan_of("mesh_wide_streaming", res, "streaming", (2,))
    held("mesh_wide_streaming", rec, single)
    if rec["selected"] != one["wide_alternative"]["selected"]:
        raise AssertionError("mesh_wide_streaming: picks differ from phase 4's in-memory fit")
    counted("mesh_wide_streaming", expected_mesh_launches("mesh_wide_streaming", 10, 1))
    out["wide_streaming"] = dict(rec, single_s=single["seconds"])

    # (c) the 2-D grid, phase 9's 40,000 x 40,000 arrays, jmi L=5
    X, y = keep["grid"]
    Xd, yd = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    _, single = run_path("mesh_grid_single", lambda: MRMRSelector(5, criterion="jmi").fit(Xd, yd),
                         dev, launches)
    m = mesh((2, 2), ("data", "model"))
    inputs: dict = {}
    with tally_count_inputs(inputs):
        res, rec = run_path("mesh_grid", lambda: MRMRSelector(
            5, criterion="jmi", encoding="grid", mesh=m).fit(Xd, yd), dev, launches)
    plan_of("mesh_grid", res, "grid", (2, 2))
    held("mesh_grid", rec, single)
    counted("mesh_grid", expected_mesh_launches("mesh_grid", 5))
    if inputs.get("int8 V=2 C=4") != 16:
        raise AssertionError(f"mesh_grid: counts by input {inputs}, want 16 class-fused")
    log(f"[mesh] mesh_grid: contingency launches by input {json.dumps(inputs)}")
    out["grid"] = dict(rec, single_s=single["seconds"], count_inputs=inputs)
    rows, cols = MH_GRID[0] // 2, MH_GRID[1] // 2
    c = rec["selected"][0]
    timings.append(time_conditional(
        Xd[:rows, :cols], Xd[:rows, c].clone(), yd[:rows],
        f"{rows}x{cols} int8 VC=4 (a (2, 2) grid tile, a view with rows 16-byte aligned, "
        "phase 10)", reps=20))
    del Xd, yd

    # (f) Pearson, phase 6's arrays, on (2,) model
    X, y = keep["pearson"]
    Xd, yd = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    m = mesh((2,), ("model",))
    res, rec = run_path("mesh_pearson", lambda: MRMRSelector(8, mesh=m).fit(Xd, yd), dev, launches)
    plan_of("mesh_pearson", res, "alternative", (2,))
    held("mesh_pearson", rec, one["wide_pearson"], exact=False)
    if launches["mesh_pearson"]["pearson_corr"] != 16:  # 2 shards x (1 relevance + 7 folds)
        raise AssertionError(f"mesh_pearson launches {launches['mesh_pearson']}")
    out["pearson"] = dict(rec, single_s=one["wide_pearson"]["seconds"])
    del Xd, yd
    torch.cuda.empty_cache()
    for name, r in out.items():
        log(f"[mesh] {name}: fit {r['seconds']:.3f} s on {r['path']}, the one-device card "
            f"fit {r['single_s']:.3f} s")
    return out, timings, bin_times


# -- phase 12: training on the card ------------------------------------------

TRAIN_ARCH = "qwen1.5-0.5b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2048, 10
# One step in float32 compute against bf16 compute, float32 masters both:
# bf16 keeps 8 significand bits (a rounding of 2^-9 relative), and each
# gradient leaf accumulates a few hundred of them (worst leaf read 0.038 on
# the H100).  The loss is a mean over 16,384 tokens, whose roundings mostly
# cancel: read 7.5e-6 relative there, held at about 13x that.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_REL_L2 = 5e-2
TRAIN_GRAD_LEAVES = ("top.final_norm.w", "layers.0.attn.wq", "layers.11.mlp.up",
                     "layers.23.attn.bv", "layers.23.mlp.down", "top.unembed")
# The restart and serve checks run the command lines at the published widths
# with the depth cut to 2 of 24 layers: a checkpoint (float32 weights and two
# moments, 12 bytes a parameter) is then 4.0 GB, not 7.4.
CLI_DEVICE = "cuda"
RESTART_MODEL = ("--arch", TRAIN_ARCH, "--preset", "full", "--num-layers", "2")
# Cut from 6 steps of 512 tokens, a checkpoint every 3: a crash at step 3, a
# restart from step 2's checkpoint and bitwise equality stay.
RESTART_STEPS = 4
RESTART_ARGS = ("--steps", str(RESTART_STEPS), "--global-batch", "2", "--seq-len", "256",
                "--ckpt-every", "2", "--log-every", "1", "--warmup", "2")
TRAIN_PEAK_LIMIT = 70e9  # bytes; the step's batch is cut beyond this


def train_step_bound(cfg, b, s):
    """The step's least time (ms) and its reckoning, at the bf16
    tensor-core rate.  N is the parameters in products (every weight but
    the embedding table, which is gathered); the attention products are
    QK^T and PV over the causal half, S (S + 1) / 2 scores a head: 2 D
    flops each for either product, so 2 B H D S (S + 1) a layer forward.
    The bound counts what the step runs: 8 N T matmul flops (forward 2,
    backward 4, the full remat's recomputed forward 2) and the attention
    products x4.  ``model_ms`` counts the work without the recompute: 6 N T
    and the attention products x3."""
    per_layer = (cfg.d_model * cfg.head_dim * (cfg.num_heads + 2 * cfg.num_kv_heads)
                 + cfg.num_heads * cfg.head_dim * cfg.d_model + 3 * cfg.d_model * cfg.d_ff)
    n = cfg.num_layers * per_layer + cfg.d_model * cfg.vocab_size
    t = b * s
    attn_fwd = 2 * b * cfg.num_heads * cfg.head_dim * s * (s + 1) * cfg.num_layers
    matmul, attn = 8 * n * t, 4 * attn_fwd
    ms = (matmul + attn) / BF16_OPS_PER_S * 1e3
    model_flops = 6 * n * t + 3 * attn_fwd
    model_ms = model_flops / BF16_OPS_PER_S * 1e3
    return ms, dict(n_matmul_params=n, tokens=t, matmul_flops=matmul, attention_flops=attn,
                    flops=matmul + attn, bf16_ops_per_s=BF16_OPS_PER_S, bound_ms=ms,
                    model_flops=model_flops, model_ms=model_ms)


def run_cli(module, args, timeout=600, env=None):
    """``python -m module args`` from the repo root (``env`` added to the
    environment); its one JSON line."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **(env or {}))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", module, *args], capture_output=True, text=True,
                         env=env, timeout=timeout, cwd=ROOT)
    if out.returncode != 0:
        raise AssertionError(f"{module} {' '.join(args)} exited {out.returncode}\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    log(f"[{module.rsplit('.', 1)[1]}] {time.perf_counter() - t0:.3f} s: {json.dumps(rec)[:600]}")
    return rec


def restart_checks(tmp):
    """launch.train RESTART_STEPS steps uninterrupted and with --fail-at-step 3 (the two
    processes at once), and launch.serve --ckpt-dir (its ``main``, in this
    process) on the uninterrupted run's final checkpoint once it is written,
    beside the restarted run."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import build_model
    from repro_torch.runtime import CheckpointManager
    from repro_torch.runtime.checkpoint import flatten_with_paths
    from repro_torch.train import AdamWConfig, train_state_shapes
    from repro_torch.train.train_step import state_to_jax

    recs = {}

    def train(n, extra):
        recs[n] = run_cli("repro_torch.launch.train",
                          [*RESTART_MODEL, *RESTART_ARGS, "--device", CLI_DEVICE,
                           "--ckpt-dir", str(tmp / n), *extra])
        if n == "plain":  # the serve command line, in this process (its kernels built)
            t0 = time.perf_counter()
            recs["serve"] = serve_cli.main(
                [*RESTART_MODEL, "--ckpt-dir", str(tmp / "plain"), "--requests", "2",
                 "--prompt-len", "64", "--max-new-tokens", "8", "--device", CLI_DEVICE])
            log(f"[serve] --ckpt-dir {time.perf_counter() - t0:.3f} s")

    threads = [threading.Thread(target=train, args=a)
               for a in (("plain", ()), ("failed", ("--fail-at-step", "3")))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if set(recs) != {"plain", "failed", "serve"}:
        raise AssertionError(f"a command line failed: {sorted(recs)} came back")
    plain, failed = recs["plain"], recs["failed"]
    if ((plain["restarts"], failed["restarts"], plain["steps"], failed["steps"])
            != (0, 1, RESTART_STEPS, RESTART_STEPS)):
        raise AssertionError(f"restarts / steps: {plain['restarts']}, {failed['restarts']}, "
                             f"{plain['steps']}, {failed['steps']}")
    if failed["losses"] != plain["losses"] or not all(np.isfinite(plain["losses"])):
        raise AssertionError(f"losses differ: {failed['losses']} vs {plain['losses']}")
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=2)
    skeleton = build_model(cfg, device="meta", dtype=torch.float32)
    like = state_to_jax(skeleton, train_state_shapes(skeleton, AdamWConfig()))
    flats = []
    for n in ("plain", "failed"):
        mgr = CheckpointManager(str(tmp / n))
        if mgr.latest_step() != RESTART_STEPS:
            raise AssertionError(f"{n}: last checkpoint {mgr.latest_step()}")
        flats.append(flatten_with_paths(mgr.restore(RESTART_STEPS, like)))
    a, b = flats
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    if sorted(a) != sorted(b) or differ:
        raise AssertionError(f"restarted run's final state differs at {differ[:5]}")
    log(f"[train] restart: {RESTART_STEPS} steps with a failure at step 3 equal the "
        f"uninterrupted run bit "
        f"for bit ({len(a)} leaves, losses {plain['losses']})")
    served = recs["serve"]
    toks = [t for o in served["first_tokens"] for t in o]
    if (served["ckpt_step"] != RESTART_STEPS or served["new_tokens"] != 16
            or not all(0 <= t < cfg.vocab_size for t in toks)):
        raise AssertionError(f"serve --ckpt-dir: {served}")
    return dict(plain=plain, failed=failed, serve=served)


def phase12(dev, launches):
    """qwen1.5-0.5b trained at its published widths and depth: (a) one
    step's loss and gradient leaves, bf16 compute against float32 compute;
    (b) TRAIN_STEPS steps of ``make_train_step`` (launch counts zeroed just
    before, read just after: no kernel runs); (c) the restart and serve
    command lines run beside phase 15 (d) (``phase15_cli``)."""
    from repro_torch.configs import get_config
    from repro_torch.data import ShardedDataPipeline
    from repro_torch.dist import make_mesh
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, TrainState, make_train_step, warmup_cosine

    cfg = get_config(TRAIN_ARCH)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, dtype=torch.float32, compute_dtype=cfg.dtype,
                        generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    log(f"[train] {TRAIN_ARCH}: {cfg.num_layers} layers, d {cfg.d_model}, {cfg.num_heads} heads, "
        f"d_ff {cfg.d_ff}, vocab {model.cfg.vocab_size}, {model.num_params()} parameters "
        f"(float32 masters, compute {cfg.dtype}, remat {cfg.remat}), made in "
        f"{time.perf_counter() - t0:.3f} s")
    pipe = ShardedDataPipeline(mesh=make_mesh((1,), ("data",), devices=[dev]),
                               global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                               vocab=model.cfg.vocab_size, seed=0)
    params = model.flat_params()

    # (a) one step's loss and gradient leaves in bf16 and in float32 compute
    def grads_at(compute_dtype):
        model.compute_dtype = compute_dtype
        leaves = {k: v.detach().requires_grad_(k in TRAIN_GRAD_LEAVES) for k, v in params.items()}
        loss, metrics = model.train_loss(pipe.batch_at(0), leaves)
        g = torch.autograd.grad(loss, [leaves[k] for k in TRAIN_GRAD_LEAVES])
        return float(loss.detach()), dict(zip(TRAIN_GRAD_LEAVES, g))

    loss16, g16 = grads_at(torch.bfloat16)
    loss32, g32 = grads_at(torch.float32)
    model.compute_dtype = torch.bfloat16
    rel = {k: float((g16[k] - g32[k]).norm() / g32[k].norm()) for k in TRAIN_GRAD_LEAVES}
    del g16, g32
    log(f"[train] step 0 loss bf16 {loss16:.6f} vs float32 {loss32:.6f} (rtol "
        f"{TRAIN_LOSS_RTOL}); gradient relative L2 errors {json.dumps(rel)} "
        f"(<= {TRAIN_GRAD_REL_L2})")
    if not abs(loss16 - loss32) <= TRAIN_LOSS_RTOL * abs(loss32):
        raise AssertionError(f"bf16 loss {loss16} vs float32 {loss32}")
    bad = {k: r for k, r in rel.items() if not r <= TRAIN_GRAD_REL_L2}
    if bad:
        raise AssertionError(f"bf16 gradients off the float32 ones: {bad}")

    # (b) the train step
    opt_cfg = AdamWConfig(learning_rate=warmup_cosine(3e-4, 2, TRAIN_STEPS),
                          moment_dtype=cfg.optimizer_moment_dtype)
    step_fn = make_train_step(model, opt_cfg)
    state = TrainState.create(params, opt_cfg)
    del params
    batches = [pipe.batch_at(i) for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    step_s, losses = [], []

    def train():
        nonlocal state
        for batch in batches:
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))  # waits for the step
            step_s.append(time.perf_counter() - t0)

    counted("qwen_train", launches, train)
    peak = torch.cuda.max_memory_allocated(dev)
    # One more step (its result dropped), on the host clock and traced: the
    # device's busy share and its time by kernel.
    trace = device_breakdown(lambda: step_fn(state, batches[0]), top=12)
    log(f"[train] traced step: {json.dumps(trace)}")
    if any(launches["qwen_train"].values()):
        raise AssertionError(f"training launched kernels: {launches['qwen_train']}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses {losses}")
    if peak > TRAIN_PEAK_LIMIT:
        raise AssertionError(f"peak memory {peak} bytes over {TRAIN_PEAK_LIMIT:.0f}")
    bound_ms, reckoning = train_step_bound(model.cfg, TRAIN_BATCH, TRAIN_SEQ)
    warm = sorted(step_s[1:])
    step_ms = 1e3 * warm[len(warm) // 2]
    rec = dict(path="qwen_train", arch=TRAIN_ARCH, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
               steps=TRAIN_STEPS, step_ms=[1e3 * t for t in step_s], median_step_ms=step_ms,
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3), peak_mem_bytes=peak,
               flash_launches=launches["qwen_train"]["flash_attention"],
               launches=launches["qwen_train"], losses=losses, bound=reckoning,
               bound_share=bound_ms / step_ms, model_share=reckoning["model_ms"] / step_ms,
               loss_bf16=loss16, loss_f32=loss32,
               grad_rel_l2=rel, trace=trace)
    log(f"[train] {json.dumps(rec)}")
    log(f"[train] step {step_ms:.3f} ms (median of steps 2-{TRAIN_STEPS}; first "
        f"{1e3 * step_s[0]:.3f}), {rec['tokens_per_s']:.1f} tokens/s, peak "
        f"{peak / 1e9:.3f} GB, flash launches 0; bound {bound_ms:.3f} ms = "
        f"({reckoning['matmul_flops']:.4e} matmul + {reckoning['attention_flops']:.4e} "
        f"causal attention flops, the recompute included) / 989e12, "
        f"{100 * bound_ms / step_ms:.1f}% of it (hardware flops); without the recompute "
        f"{reckoning['model_ms']:.3f} ms ({reckoning['model_flops']:.4e} flops), "
        f"{100 * reckoning['model_ms'] / step_ms:.1f}% (model flops)")
    del state, batches, model
    torch.cuda.empty_cache()
    return rec  # (c) runs beside phase 15's command lines (phase15_cli)


# -- phase 13: model parallelism for serving ---------------------------------

MP_PATHS = ("yi6b_tp_serve", "dbrx_ep_serve")
YI_TP_MESH, DBRX_EP_MESH = (1, 4), (2, 2)  # ("data", "model") positions of the card
# (c): GPipe over four positions of the card, PIPE_STAGES stages of
# tanh(h @ W + b) at D = PIPE_D on PIPE_B rows, float32.
PIPE_STAGES, PIPE_D, PIPE_B = 32, 4096, 64
PIPE_MICROBATCHES = (1, 2, 4, 8)
# Each microbatch is held bitwise to the sequential fold of its own rows
# (the pipeline runs the fold's operations on them), and the whole output to
# the fold of the whole batch: cuBLAS picks its float32 GEMM by the row
# count, and a sum of D = 4096 products taken in another order moves by
# ~sqrt(D) float32 roundings (~2e-6 at these magnitudes; 1.58e-6 read on the
# H100 at 2-8 microbatches).  md_pipeline.py's 1e-6 is for D = 32.
PIPE_TOL = dict(rtol=1e-5, atol=1e-5)
MP_CLI_ARGS = ("--arch", "qwen1.5-0.5b", "--preset", "full", "--device", "cuda")


def card_mesh(dev, shape):
    from repro_torch.dist import make_mesh

    n = int(np.prod(shape))
    return make_mesh(shape, ("data", "model"), devices=[dev] * n)


# The meshed model against the one-device model, both computing in float32
# from the same bf16 weights: only the row-parallel sums' order differs
# (~1e-6 relative; the CPU tests hold the smoke models at 1e-5).  A router's
# near-tie can still flip an expert choice, which moves that token's output
# by a gate's share of an expert's and, through attention, the later
# positions' by ~1/S of that: where any dispatch slot differs between the
# two runs (counted), the float32 logits are held at the bf16 tolerances
# instead.  In bf16 such flips are common, so bf16 runs are held by their
# tokens (the margin rule) and, for the dense model, phase 7's bound.
MESH_F32_TOL = dict(rtol=1e-4, atol=1e-4)


@contextlib.contextmanager
def recorded_dispatches(seen):
    """While open, every MoE dispatch's ``buf_tok`` goes to ``seen``, in call
    order (one a block: layer by layer, blocks in mesh order)."""
    from repro_torch.models import moe

    inner = moe._dispatch

    def record(x2d, p, cfg):
        out = inner(x2d, p, cfg)
        seen.append(out[0])
        return out

    moe._dispatch = record
    try:
        yield
    finally:
        moe._dispatch = inner


def mesh_serve(tag, make_model, mesh, reqs, dev, launches, bf16_bound=None, f32_rel=None):
    """Serve ``reqs`` with ``make_model()`` on one device (the reference:
    tokens, margins and last prefill logits through the kernel, and the last
    prefill logits computed in float32 from the same bf16 weights), then
    shard it onto ``mesh`` (the one-device model freed) and serve again as
    path ``{tag}_serve``: flash launched once a position an attention layer
    a wave, every prefill attention of every position held to the plain
    version on its own q, k, v; the float32-compute last prefill logits
    within ``MESH_F32_TOL`` of the one-device model's, the bf16 ones within
    ``bf16_bound`` where given; the tokens held to the one-device run's by
    ``margin_rule``.  With ``f32_rel`` (a deep model whose float32 rounding
    grows past ``MESH_F32_TOL``) the one-device model's float64-compute
    logits are the witness: the meshed and the one-device float32 logits
    each within ``f32_rel`` of its largest magnitude, and of each other."""
    from repro_torch.models.model import shard_params
    from repro_torch.serve import Request

    def logits_f32(m, dispatched, compute=torch.float32):
        dtype, m.compute_dtype = m.compute_dtype, compute
        try:
            with recorded_dispatches(dispatched):
                return last_logits(m, reqs, "auto")
        finally:
            m.compute_dtype = dtype

    model = make_model()
    attn = sum(kind == "attn" for kind, _ in model.kinds)
    one_outs, one_margins, one_rec = serve_run(f"{tag}_one_device", model, reqs, dev, launches)
    one_logits = last_logits(model, reqs, "auto")
    one_disp, mesh_disp = [], []
    one32 = logits_f32(model, one_disp)
    t64 = time.perf_counter()
    one64 = None if f32_rel is None else logits_f32(model, [], torch.float64)
    t64 = time.perf_counter() - t64
    own = max((a - b).abs().max().item() for a, b in zip(one_logits, one32))
    t0 = time.perf_counter()
    meshed = shard_params(model, mesh)
    del model
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    shard_s = time.perf_counter() - t0
    log(f"[{tag}] sharded onto {mesh.shape} in {shard_s:.3f} s: {meshed.weight_bytes()} weight "
        f"bytes stored, {torch.cuda.memory_allocated(dev)} bytes allocated")
    margin_engine(meshed).serve([Request(r.prompt[:64], 2) for r in reqs[:4]])  # warm-up
    outs, _, rec = serve_run(f"{tag}_serve", meshed, reqs, dev, launches)
    waves = len({len(r.prompt) for r in reqs})
    want = attn * mesh.size
    if rec["flash_launches_per_wave"] != [want] * waves:
        raise AssertionError(f"{tag}: flash launches per wave {rec['flash_launches_per_wave']}, "
                             f"want {want} ({attn} attention layers x {mesh.size} positions)")
    layer_errs = []
    with held_to_plain(layer_errs):
        mesh_logits = last_logits(meshed, reqs, "auto")
    if len(layer_errs) != waves * want:
        raise AssertionError(f"{tag}: held {len(layer_errs)} prefill attentions, want "
                             f"{waves * want}")
    for lg in mesh_logits:
        if not torch.isfinite(lg).all():
            raise AssertionError(f"{tag}: non-finite prefill logits on the mesh")
    mesh32 = logits_f32(meshed, mesh_disp)
    if [d.shape for d in mesh_disp] != [d.shape for d in one_disp]:
        raise AssertionError(f"{tag}: the mesh dispatched {len(mesh_disp)} blocks, the "
                             f"reference {len(one_disp)}")
    flipped = sum(int((a.cpu() != b.cpu()).sum()) for a, b in zip(mesh_disp, one_disp))
    slots = sum(d.numel() for d in one_disp)
    f32_tol = MESH_F32_TOL if flipped == 0 else FLASH_BF16_TOL
    f32_err = max((a - b).abs().max().item() for a, b in zip(mesh32, one32))
    if one64 is None:
        for a, b in zip(mesh32, one32):
            torch.testing.assert_close(a, b, **f32_tol)
    else:  # each wave's errors as shares of its float64 logits' largest magnitude
        f32_tol = dict(rel_of_max=f32_rel)
        witness = {name: max(((a.double() - b.double()).abs().max() / w.abs().max()).item()
                             for a, b, w in zip(x, y, one64))
                   for name, x, y in (("mesh_vs_one_device", mesh32, one32),
                                      ("mesh_vs_float64", mesh32, one64),
                                      ("one_device_vs_float64", one32, one64))}
        log(f"[{tag}] float32 last-position logits as shares of the float64 witness's largest "
            f"magnitude: {json.dumps(witness)} (limit {f32_rel}; the witness {t64:.3f} s)")
        if not all(e <= f32_rel for e in witness.values()):
            raise AssertionError(f"{tag}: float32 logits off: {witness} > {f32_rel}")
        f32_tol["witness"] = witness
    del one64
    del one_disp, mesh_disp
    logit_err = max((a - b).abs().max().item() for a, b in zip(mesh_logits, one_logits))
    if bf16_bound is not None and not logit_err <= bf16_bound:
        raise AssertionError(f"{tag}: bf16 mesh vs one-device logits {logit_err} > {bf16_bound}")
    agree = margin_rule(outs, one_outs, one_margins, logit_err, reqs)
    check = dict(mesh=mesh.shape, logit_err=logit_err, bf16_bound=bf16_bound,
                 one_device_bf16_vs_f32=own, f32_err=f32_err, f32_tol=f32_tol,
                 f32_dispatch_slots=slots, f32_slots_routed_otherwise=flipped,
                 tokens_equal=outs == one_outs,
                 agreement=agree, shard_s=shard_s,
                 layer_abs_err=max((e for e, _ in layer_errs), default=0.0),
                 layer_row_err=max((r for _, r in layer_errs), default=0.0),
                 prefill_attentions_held=len(layer_errs), weight_bytes=meshed.weight_bytes(),
                 one_device=one_rec)
    rec.update(arch=meshed.cfg.name, layers=meshed.cfg.num_layers, mesh=mesh.shape,
               params=meshed.num_params(), weight_bytes=meshed.weight_bytes(),
               dtype=str(meshed.dtype)[6:])
    log(f"[{tag}] mesh vs one device, last-position logits: float32 compute {f32_err:.4e} "
        f"(limit {f32_tol}; {flipped} of {slots} MoE dispatch slots routed otherwise); bf16 {logit_err:.4e} (limit {bf16_bound}; the one-device "
        f"bf16 vs float32 compute {own:.4e}); each of the {len(layer_errs)} prefill attentions "
        f"of the positions vs plain: max abs err {check['layer_abs_err']:.3e}, max row err "
        f"{check['layer_row_err']:.3e}; "
        f"tokens equal {check['tokens_equal']}: {json.dumps(agree)}")
    return meshed, rec, check


def phase13_yi(dev, launches, bf16_bound):
    """(a) Yi-6B whole in bf16 on (1, 4) positions: heads, d_ff and the
    vocabulary over ``model``, phase 7's 8 requests; the bf16 logits within
    ``bf16_bound`` (phase 7's: the bf16 model against the float32 one)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import Request

    cfg = get_config("yi-6b")
    rng = np.random.default_rng(0)
    reqs = [Request(rng.integers(0, cfg.vocab_size, n).tolist(), 32)
            for n in [2048] * 4 + [1000] * 4]
    meshed, rec, check = mesh_serve(
        "yi6b_tp", lambda: build_model(cfg, device=dev, dtype=torch.bfloat16,
                                       generator=torch.Generator(device=dev).manual_seed(0)),
        card_mesh(dev, YI_TP_MESH), reqs, dev, launches, bf16_bound)
    del meshed
    torch.cuda.empty_cache()
    return rec, check


def phase13_dbrx(dev, launches):
    """(b) dbrx at its published widths, 4 of 40 layers, bf16, on (2, 2)
    positions: the batch over ``data``, sequence chunks and experts over
    ``model``, the experts' d_ff on ``data`` (``ff_axis``).  The one-device
    reference runs its MoE layers as ``moe_blockwise_reference`` (the
    mesh's blocks: 2 batch shards x 2 sequence chunks in prefill, the whole
    batch in decode).  Layer 0's slots dropped, per block on the mesh and
    over the whole wave on one device, for the first wave."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe, transformer

    cfg = dataclasses.replace(get_config("dbrx-132b"), num_layers=FAMILY_DEPTH["dbrx-132b"])
    reqs = family_requests(cfg, FAMILY_WAVES["dbrx"])
    n_data, n_model = DBRX_EP_MESH
    inner = transformer.moe_einsum

    def blockwise(p, x, *, cfg):
        return moe.moe_blockwise_reference(p, x, cfg, n_data, n_model)

    transformer.moe_einsum = blockwise
    try:
        meshed, rec, check = mesh_serve(
            "dbrx_ep", lambda: build_family("dbrx-132b", dev, torch.bfloat16),
            card_mesh(dev, DBRX_EP_MESH), reqs, dev, launches)
    finally:
        transformer.moe_einsum = inner
    # Layer 0 on the first wave (4 x 2048): the mesh's blocks, and the whole
    # wave's dispatch as one device makes it (phase 11 (a)'s count).
    records, seen = [], {}
    inner_apply = moe.moe_apply

    def recording(m, pre, hs, record=None):
        if pre != "layers.0.moe.":
            return inner_apply(m, pre, hs, record)
        seen["x"] = m.ctx.gather_batch(hs, dev)
        return inner_apply(m, pre, hs, records)

    n = len(reqs[0].prompt)
    toks = torch.tensor([r.prompt for r in reqs if len(r.prompt) == n], device=dev)
    transformer.moe_mod.moe_apply = recording
    try:
        meshed.prefill(toks)
    finally:
        transformer.moe_mod.moe_apply = inner_apply
    k = cfg.experts_per_token
    x2d = seen.pop("x").reshape(-1, cfg.d_model)
    buf_tok = moe._dispatch(x2d, {"router": meshed.weight("layers.0.moe.router")[0]}, cfg)[0]
    one = dict(tokens=x2d.shape[0], slots=x2d.shape[0] * k, capacity=buf_tok.shape[1],
               dropped=x2d.shape[0] * k - int((buf_tok >= 0).sum()))
    blocks = [dict(tokens=r["tokens"], capacity=r["capacity"], dropped=r["dropped"],
                   slots=r["tokens"] * k) for r in records]
    check["drops"] = dict(one_device=one, mesh_blocks=blocks)
    log(f"[dbrx_ep] layer 0 slots dropped at capacity factor {cfg.capacity_factor}, first wave: "
        f"the whole wave on one device {one['dropped']} of {one['slots']} (capacity "
        f"{one['capacity']}); the mesh's blocks (dropped, slots, capacity) "
        f"{[(b['dropped'], b['slots'], b['capacity']) for b in blocks]}")
    del meshed, x2d, buf_tok
    torch.cuda.empty_cache()
    return rec, check


def phase13_pipeline(dev):
    """(c) ``pipeline_apply`` over 4 positions of the card against the
    sequential fold: within ``PIPE_TOL``, bitwise with one microbatch."""
    from repro_torch.dist import make_mesh, pipeline_apply

    gen = torch.Generator(device=dev).manual_seed(13)
    w = torch.randn((PIPE_STAGES, PIPE_D, PIPE_D), generator=gen, device=dev) * PIPE_D ** -0.5
    b = 0.1 * torch.randn((PIPE_STAGES, PIPE_D), generator=gen, device=dev)
    x = torch.randn((PIPE_B, PIPE_D), generator=gen, device=dev)
    params = {"w": w, "b": b}

    def stage(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    def fold(h):
        for i in range(PIPE_STAGES):
            h = stage({"w": w[i], "b": b[i]}, h)
        return h

    mesh = make_mesh((4,), ("stage",), devices=[dev] * 4)
    want = fold(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fold(x)
    torch.cuda.synchronize()
    rec = dict(stages=PIPE_STAGES, d=PIPE_D, batch=PIPE_B, fold_s=time.perf_counter() - t0,
               runs=[])
    for mb in PIPE_MICROBATCHES:
        got = pipeline_apply(stage, params, x, mesh=mesh, microbatches=mb)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = pipeline_apply(stage, params, x, mesh=mesh, microbatches=mb)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        err = (got - want).abs().max().item()
        if not torch.equal(got, torch.cat([fold(h) for h in x.chunk(mb)])):
            raise AssertionError(f"pipeline with {mb} microbatches differs from the fold of "
                                 "each microbatch")
        torch.testing.assert_close(got, want, **PIPE_TOL)
        rec["runs"].append(dict(microbatches=mb, seconds=sec, max_abs_err=err))
    log(f"[pipeline] {json.dumps(rec)}")
    del w, b, params
    torch.cuda.empty_cache()
    return rec


def phase13_cli(dev, cli_args=None):
    """(d) ``launch.serve --model-parallel 2`` with ``REPRO_DEVICES=4`` (a
    (2, 2) mesh of card positions) and ``--model-parallel 1``, both at once
    as subprocesses, on ``cli_args`` (default ``MP_CLI_ARGS``); their tokens held to each other by the margin rule
    (bf16 greedy tokens of random weights flip where two logits nearly
    tie): the one-device run's margins come from the same model and prompts
    rebuilt here from the command line's seed (its tokens must equal the
    ``--model-parallel 1`` line's), the logits error from that model
    sharded onto the same mesh."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.model import shard_params
    from repro_torch.serve import Request

    cli_args = MP_CLI_ARGS if cli_args is None else cli_args
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_DEVICES="4")
    cmds = {n: [sys.executable, "-m", "repro_torch.launch.serve", *cli_args,
                "--model-parallel", n] for n in ("1", "2")}
    t0 = time.perf_counter()
    procs = {n: subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                 env=env, cwd=ROOT) for n, c in cmds.items()}
    outs = {}
    try:
        for n, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"serve --model-parallel {n} exited {proc.returncode}\n"
                                     f"{out[-3000:]}\n{err[-3000:]}")
            outs[n] = json.loads(out.strip().splitlines()[-1])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log(f"[serve cli] both in {time.perf_counter() - t0:.3f} s: "
        f"{json.dumps({n: {k: o[k] for k in ('mesh', 'new_tokens', 'prefill_s', 'decode_ms_per_step', 'first_tokens')} for n, o in outs.items()})}")
    if outs["2"]["mesh"] != {"data": 2, "model": 2} or outs["1"]["mesh"] is not None:
        raise AssertionError(f"the command lines ran on {outs['1']['mesh']}, {outs['2']['mesh']}")
    cfg = get_config(cli_args[cli_args.index("--arch") + 1])
    model = build_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    # The command line draws its prompts over the config's own vocabulary
    # (the model pads it to a multiple of 16).
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(8, 32))
    reqs = [Request(p.tolist(), 16) for p in prompts]
    engine = margin_engine(model)
    one = engine.serve(reqs)
    want = [o[:8] for o in one[:4]]
    if want != outs["1"]["first_tokens"]:
        raise AssertionError(f"rebuilt one-device tokens {want} differ from the command "
                             f"line's {outs['1']['first_tokens']}")
    one_logits = last_logits(model, reqs, "auto")
    meshed = shard_params(model, card_mesh(dev, (2, 2)))
    del model
    logit_err = max((a - b).abs().max().item()
                    for a, b in zip(last_logits(meshed, reqs, "auto"), one_logits))
    del meshed
    torch.cuda.empty_cache()
    agree = []
    for r, (a, b) in enumerate(zip(outs["2"]["first_tokens"], want)):
        low = [j for j in range(len(b)) if engine.margins[j][r] < 2 * logit_err]
        first_low = low[0] if low else len(b)
        first_diff = next((j for j in range(len(b)) if a[j] != b[j]), len(b))
        if first_diff < first_low:
            raise AssertionError(f"serve cli request {r}: --model-parallel 2 and 1 differ at "
                                 f"step {first_diff}, before the first low-margin step {first_low}")
        agree.append(dict(request=r, first_diff=first_diff, first_low_margin_step=first_low))
    log(f"[serve cli] --model-parallel 2 vs 1: tokens equal "
        f"{outs['2']['first_tokens'] == want}; logits error {logit_err:.4e}: {json.dumps(agree)}")
    return outs, dict(logit_err=logit_err, agreement=agree,
                      tokens_equal=outs["2"]["first_tokens"] == want)


def phase13(dev, launches, bf16_bound):
    """Model parallelism for serving on a mesh of positions of the card:
    (a) Yi-6B tensor parallel, (b) dbrx expert parallel, (c) GPipe, (d) the
    serve command line; and flash at the positions' new shapes."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    recs, checks = [], {}
    parts = (("a yi-6b tp", lambda: phase13_yi(dev, launches, bf16_bound)),
             ("b dbrx ep", lambda: phase13_dbrx(dev, launches)))
    for name, fn in parts:
        t0 = time.perf_counter()
        r, c = fn()
        recs.append(r)
        checks[name.split()[1]] = c
        log(f"[phase] 13{name} {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    checks["pipeline"] = phase13_pipeline(dev)
    log(f"[phase] 13c pipeline {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    cli, cli_check = phase13_cli(dev)
    checks["serve_cli"] = dict(cli_check, runs={
        n: {k: o[k] for k in ("mesh", "new_tokens", "seconds", "prefill_s", "decode_ms_per_step")}
        for n, o in cli.items()})
    log(f"[phase] 13d serve cli {time.perf_counter() - t0:.3f} s")
    timings, err = [], 0.0
    bf = torch.bfloat16
    for i, (label, b, s, h, kv) in enumerate([
            ("yi-6b tp=4 position B=4 S=T=2048 H=8 KV=1", 4, 2048, 8, 1),
            ("dbrx (2, 2) position B=2 S=T=2048 H=24 KV=4", 2, 2048, 24, 4)]):
        q, k, v = attn_inputs(b, s, s, h, kv, 128, bf, dev, seed=130 + i)
        e, row = flash_errors(flash_attention_cuda(q, k, v, causal=True),
                              ref.flash_attention(q, k, v, causal=True), bf)
        err = max(err, e)
        log(f"[flash] {label} bf16: max abs err {e:.3e}, max row err {row:.3e}")
        timings.append(time_flash(q, k, v, label))
        del q, k, v
    torch.cuda.empty_cache()
    return recs, checks, timings, err


# -- phase 14: training on a model mesh ---------------------------------------

MESH_TRAIN_MESH = (2, 2)  # ("data", "model") positions of the card
MESH_TRAIN_BATCH, MESH_TRAIN_SEQ, MESH_TRAIN_STEPS = 4, 2048, 5
# (b): llama4-scout at its published widths, 1 of 48 layers, experts over
# ``model`` and their d_ff over ``data``.  Its config accumulates 4
# microbatches; a batch of 2 rows on 2 data shards is one row a shard, so
# the phase takes one batch (microbatches=1).
MOE_TRAIN_ARCH = "llama4-scout-17b-a16e"
MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = 1, 2, 2048, 3
MESH_TRAIN_PEAK_LIMIT = 78e9  # bytes
# (c): the train command line at 2 of 24 layers on REPRO_DEVICES positions.
MESH_CLI_DEVICES = "4"
MESH_CLI_ARGS = ("--model-parallel", "2")


def rel_l2(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def phase14_qwen(dev, launches):
    """(a) qwen1.5-0.5b at published widths and depth on MESH_TRAIN_MESH:
    one step in float32 compute on the mesh and on one device from the same
    weights and batch (the loss within ``TRAIN_LOSS_RTOL``, the gradient
    leaves of ``TRAIN_GRAD_LEAVES`` by ``TRAIN_GRAD_REL_L2``), then
    MESH_TRAIN_STEPS bf16 steps of ``make_train_step(mesh=)`` on the
    pipeline's shards, launch counts zeroed just before and read just after
    (all 0), the first step's loss within ``TRAIN_LOSS_RTOL`` of the float32
    one, one more step traced."""
    from repro_torch.configs import get_config
    from repro_torch.data import ShardedDataPipeline
    from repro_torch.models import build_model
    from repro_torch.models.model import gather_leaves, mesh_model, shard_leaves
    from repro_torch.train import (AdamWConfig, TrainState, make_train_step,
                                   mesh_value_and_grad, warmup_cosine)

    cfg = get_config(TRAIN_ARCH)
    mesh = card_mesh(dev, MESH_TRAIN_MESH)
    model = build_model(cfg, device=dev, dtype=torch.float32, compute_dtype=torch.float32,
                        generator=torch.Generator(device=dev).manual_seed(0))
    pipe = ShardedDataPipeline(mesh=mesh, global_batch=MESH_TRAIN_BATCH, seq_len=MESH_TRAIN_SEQ,
                               vocab=model.cfg.vocab_size, seed=0)
    params = model.flat_params()
    leaves = {k: v.detach().requires_grad_(k in TRAIN_GRAD_LEAVES) for k, v in params.items()}
    loss, _ = model.train_loss(pipe.batch_at(0), leaves)
    one = dict(zip(TRAIN_GRAD_LEAVES, torch.autograd.grad(
        loss, [leaves[k] for k in TRAIN_GRAD_LEAVES])))
    loss_one = float(loss.detach())
    del leaves, loss
    meshed = mesh_model(model, mesh)
    shards = shard_leaves(meshed, params)
    del params
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_mesh, _, grads = mesh_value_and_grad(model, mesh)(shards, pipe.shards_at(0))
    loss_mesh = float(loss_mesh)
    f32_s = time.perf_counter() - t0
    got = gather_leaves(meshed, [{k: g[k] for k in TRAIN_GRAD_LEAVES} for g in grads])
    del grads
    rel = {k: rel_l2(got[k], one[k]) for k in TRAIN_GRAD_LEAVES}
    del got, one
    log(f"[mesh train] {TRAIN_ARCH} float32 step 0 on {mesh.shape}: loss {loss_mesh:.7f} vs one "
        f"device {loss_one:.7f} (rtol {TRAIN_LOSS_RTOL}); gradient relative L2 errors "
        f"{json.dumps(rel)} (<= {TRAIN_GRAD_REL_L2}); the meshed float32 step {f32_s:.3f} s")
    if not abs(loss_mesh - loss_one) <= TRAIN_LOSS_RTOL * abs(loss_one):
        raise AssertionError(f"meshed float32 loss {loss_mesh} vs one device {loss_one}")
    bad = {k: r for k, r in rel.items() if not r <= TRAIN_GRAD_REL_L2}
    if bad:
        raise AssertionError(f"meshed gradients off the one-device ones: {bad}")

    model.compute_dtype = torch.bfloat16  # the config's compute dtype, float32 masters
    opt_cfg = AdamWConfig(learning_rate=warmup_cosine(3e-4, 2, MESH_TRAIN_STEPS),
                          moment_dtype=cfg.optimizer_moment_dtype)
    step_fn = make_train_step(model, opt_cfg, mesh=mesh)
    del model
    state = TrainState.create(shards, opt_cfg)
    del shards
    batches = [pipe.shards_at(i) for i in range(MESH_TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    step_s, losses = [], []

    def train():
        nonlocal state
        for batch in batches:
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            step_s.append(time.perf_counter() - t0)

    counted("qwen_mesh_train", launches, train)
    peak = torch.cuda.max_memory_allocated(dev)
    trace = device_breakdown(lambda: step_fn(state, batches[0]), top=12)
    if any(launches["qwen_mesh_train"].values()):
        raise AssertionError(f"meshed training launched kernels: {launches['qwen_mesh_train']}")
    # The first step's loss is step 0's float32 one in bf16 compute.
    if not all(np.isfinite(losses)) or not abs(losses[0] - loss_mesh) <= \
            TRAIN_LOSS_RTOL * abs(loss_mesh):
        raise AssertionError(f"meshed losses {losses}, the float32 step 0's {loss_mesh}")
    warm = sorted(step_s[1:])
    step_ms = 1e3 * warm[len(warm) // 2]
    bound_ms, reckoning = train_step_bound(get_config(TRAIN_ARCH), MESH_TRAIN_BATCH,
                                           MESH_TRAIN_SEQ)
    rec = dict(path="qwen_mesh_train", arch=TRAIN_ARCH, mesh=mesh.shape, batch=MESH_TRAIN_BATCH,
               seq_len=MESH_TRAIN_SEQ, steps=MESH_TRAIN_STEPS, step_ms=[1e3 * t for t in step_s],
               median_step_ms=step_ms, tokens_per_s=MESH_TRAIN_BATCH * MESH_TRAIN_SEQ
               / (step_ms / 1e3), peak_mem_bytes=peak, launches=launches["qwen_mesh_train"],
               flash_launches=launches["qwen_mesh_train"]["flash_attention"], losses=losses,
               bound_ms=bound_ms, bound_share=bound_ms / step_ms, loss_f32_mesh=loss_mesh,
               loss_f32_one_device=loss_one, grad_rel_l2=rel, f32_mesh_step_s=f32_s,
               trace=trace)
    log(f"[mesh train] {json.dumps(rec)}")
    log(f"[mesh train] {TRAIN_ARCH} on {mesh.shape}: step {step_ms:.3f} ms (median of steps "
        f"2-{MESH_TRAIN_STEPS}; first {1e3 * step_s[0]:.3f}), {rec['tokens_per_s']:.1f} "
        f"tokens/s, peak {peak / 1e9:.3f} GB, 0 kernel launches, device busy "
        f"{100 * trace['device_busy_share']:.1f}% of a traced step; bound {bound_ms:.3f} ms "
        f"({100 * bound_ms / step_ms:.2f}%)")
    del state, batches, step_fn
    torch.cuda.empty_cache()
    return rec


def phase14_moe(dev, launches):
    """(b) llama4-scout at its published widths, MOE_TRAIN_LAYERS of 48
    layers, on MESH_TRAIN_MESH: the float32-compute loss, aux and router
    gradient against a one-device run whose MoE layers run
    ``moe_blockwise_reference`` over the mesh's blocks; the dispatch slots
    routed otherwise and the slots dropped a block; then MOE_TRAIN_STEPS
    bf16 steps (bf16 moments, as the config says), launch counts zeroed."""
    from repro_torch.configs import get_config
    from repro_torch.data import ShardedDataPipeline
    from repro_torch.models import build_model, moe, transformer
    from repro_torch.models.model import gather_leaves, mesh_model, shard_leaves
    from repro_torch.train import (AdamWConfig, TrainState, make_train_step,
                                   mesh_value_and_grad, warmup_cosine)

    cfg = dataclasses.replace(get_config(MOE_TRAIN_ARCH), num_layers=MOE_TRAIN_LAYERS,
                              microbatches=1)
    mesh = card_mesh(dev, MESH_TRAIN_MESH)
    n_data, n_model = MESH_TRAIN_MESH
    model = build_model(cfg, device=dev, dtype=torch.float32, compute_dtype=torch.float32,
                        generator=torch.Generator(device=dev).manual_seed(0))
    n_params = model.num_params()
    routers = [k for k, _ in model.named_parameters() if k.endswith("moe.router")]
    pipe = ShardedDataPipeline(mesh=mesh, global_batch=MOE_TRAIN_BATCH, seq_len=MOE_TRAIN_SEQ,
                               vocab=model.cfg.vocab_size, seed=0)
    inner = transformer.moe_einsum

    def blockwise(p, x, *, cfg):
        return moe.moe_blockwise_reference(p, x, cfg, n_data, n_model)

    one_disp, mesh_disp = [], []
    params = model.flat_params()
    leaves = {k: v.detach().requires_grad_(k in routers) for k, v in params.items()}
    transformer.moe_einsum = blockwise
    try:
        with recorded_dispatches(one_disp):
            loss, metrics = model.train_loss(pipe.batch_at(0), leaves)
            one = dict(zip(routers, torch.autograd.grad(loss, [leaves[k] for k in routers])))
    finally:
        transformer.moe_einsum = inner
    loss_one, aux_one = float(metrics["loss"]), float(metrics["aux_loss"])
    del leaves, loss, metrics
    meshed = mesh_model(model, mesh)
    shards = shard_leaves(meshed, params)
    skeleton = build_model(cfg, device="meta", dtype=torch.float32, compute_dtype=torch.float32)
    del params, model
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    records, inner_apply = [], moe.moe_apply

    def recording(m, pre, hs, record=None):
        if records:  # the first call only: remat's recompute routes again
            return inner_apply(m, pre, hs, record)
        rec = []
        out = inner_apply(m, pre, hs, rec)
        records.extend(rec)
        return out

    transformer.moe_mod.moe_apply = recording
    try:
        with recorded_dispatches(mesh_disp):
            _, metrics, grads = mesh_value_and_grad(skeleton, mesh)(shards, pipe.shards_at(0))
    finally:
        transformer.moe_mod.moe_apply = inner_apply
    loss_mesh, aux_mesh = float(metrics["loss"]), float(metrics["aux_loss"])
    got = gather_leaves(meshed, [{k: g[k] for k in routers} for g in grads])
    del grads
    rel = {k: rel_l2(got[k], one[k]) for k in routers}
    if [d.shape for d in mesh_disp] != [d.shape for d in one_disp]:
        raise AssertionError(f"the mesh dispatched {len(mesh_disp)} blocks, the reference "
                             f"{len(one_disp)}")
    flipped = sum(int((a.cpu() != b.cpu()).sum()) for a, b in zip(mesh_disp, one_disp))
    slots = sum(d.numel() for d in one_disp)
    del one_disp, mesh_disp, got, one
    k = cfg.experts_per_token
    blocks = [dict(tokens=r["tokens"], slots=r["tokens"] * k, capacity=r["capacity"],
                   dropped=r["dropped"]) for r in records]
    log(f"[moe mesh train] {MOE_TRAIN_ARCH}, {MOE_TRAIN_LAYERS} layer, {n_params} parameters, "
        f"float32 compute on {mesh.shape}: loss {loss_mesh:.7f} vs blockwise one device "
        f"{loss_one:.7f}, aux {aux_mesh:.7f} vs {aux_one:.7f}; router gradient relative L2 "
        f"{json.dumps(rel)}; {flipped} of {slots} dispatch slots routed otherwise; slots "
        f"dropped a block (dropped, slots, capacity) "
        f"{[(b['dropped'], b['slots'], b['capacity']) for b in blocks]}")
    for name, got_v, want in (("loss", loss_mesh, loss_one), ("aux", aux_mesh, aux_one)):
        if not abs(got_v - want) <= TRAIN_LOSS_RTOL * abs(want):
            raise AssertionError(f"meshed float32 {name} {got_v} vs blockwise {want}")
    bad = {k: r for k, r in rel.items() if not r <= TRAIN_GRAD_REL_L2}
    if bad:
        raise AssertionError(f"meshed router gradients off the blockwise ones: {bad}")

    skeleton.compute_dtype = torch.bfloat16
    opt_cfg = AdamWConfig(learning_rate=warmup_cosine(3e-4, 1, MOE_TRAIN_STEPS),
                          moment_dtype=cfg.optimizer_moment_dtype)
    # The state is donated, as the train command line (and JAX's) does: the
    # old and the new 34 GB states are never both whole.
    step_fn = make_train_step(skeleton, opt_cfg, mesh=mesh, donate=True)
    state = TrainState.create(shards, opt_cfg)
    del shards
    state_bytes = sum(t.numel() * t.element_size() for tree in
                      (state.params, state.opt["m"], state.opt["v"]) for sh in tree
                      for t in sh.values())
    batches = [pipe.shards_at(i) for i in range(MOE_TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    step_s, losses, auxes = [], [], []

    def train():
        nonlocal state
        for batch in batches:
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            auxes.append(float(metrics["aux_loss"]))
            step_s.append(time.perf_counter() - t0)

    counted("llama4_mesh_train", launches, train)
    peak = torch.cuda.max_memory_allocated(dev)
    if any(launches["llama4_mesh_train"].values()):
        raise AssertionError(f"meshed MoE training launched kernels: "
                             f"{launches['llama4_mesh_train']}")
    if not all(np.isfinite(losses + auxes)):
        raise AssertionError(f"meshed MoE losses {losses}, aux {auxes}")
    if peak > MESH_TRAIN_PEAK_LIMIT:
        raise AssertionError(f"peak memory {peak} bytes over {MESH_TRAIN_PEAK_LIMIT:.0f}")
    step_ms = 1e3 * sorted(step_s[1:])[len(step_s[1:]) // 2]
    rec = dict(path="llama4_mesh_train", arch=MOE_TRAIN_ARCH, layers=MOE_TRAIN_LAYERS,
               params=n_params, mesh=mesh.shape, batch=MOE_TRAIN_BATCH, seq_len=MOE_TRAIN_SEQ,
               steps=MOE_TRAIN_STEPS, step_ms=[1e3 * t for t in step_s], median_step_ms=step_ms,
               tokens_per_s=MOE_TRAIN_BATCH * MOE_TRAIN_SEQ / (step_ms / 1e3),
               peak_mem_bytes=peak, state_bytes=state_bytes,
               launches=launches["llama4_mesh_train"], losses=losses, aux=auxes,
               loss_f32_mesh=loss_mesh, loss_f32_blockwise=loss_one, aux_f32_mesh=aux_mesh,
               aux_f32_blockwise=aux_one, router_grad_rel_l2=rel, dispatch_slots=slots,
               slots_routed_otherwise=flipped, drops=blocks)
    log(f"[moe mesh train] {json.dumps(rec)}")
    log(f"[moe mesh train] step {step_ms:.3f} ms (first {1e3 * step_s[0]:.3f}), "
        f"{rec['tokens_per_s']:.1f} tokens/s, state {state_bytes / 1e9:.3f} GB, peak "
        f"{peak / 1e9:.3f} GB, 0 kernel launches")
    del state, batches, step_fn
    torch.cuda.empty_cache()
    return rec


def phase14_cli(dev, tmp, model_args=None):
    """(c) ``launch.train --model-parallel 2`` with ``REPRO_DEVICES=4`` (a
    (2, 2) mesh of card positions) on ``model_args`` (default
    ``RESTART_MODEL``: 2 of qwen's 24 layers), uninterrupted and with
    ``--fail-at-step 3``, both at once: the same losses and bitwise the same
    final checkpoint; that checkpoint restored by ``elastic_restore`` onto
    (1, 4) positions and onto one device, each state gathered bitwise the
    saved one."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime import CheckpointManager
    from repro_torch.runtime.checkpoint import flatten_with_paths
    from repro_torch.runtime.resilience import elastic_restore
    from repro_torch.train import AdamWConfig, gather_train_state, train_state_shapes
    from repro_torch.train.train_step import state_to_jax

    model_args = RESTART_MODEL if model_args is None else model_args
    recs = {}

    def train(n, extra):
        recs[n] = run_cli("repro_torch.launch.train",
                          [*model_args, *RESTART_ARGS, *MESH_CLI_ARGS, "--device", CLI_DEVICE,
                           "--ckpt-dir", str(tmp / n), *extra],
                          env=dict(REPRO_DEVICES=MESH_CLI_DEVICES))

    threads = [threading.Thread(target=train, args=a)
               for a in (("plain", ()), ("failed", ("--fail-at-step", "3")))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if set(recs) != {"plain", "failed"}:
        raise AssertionError(f"a command line failed: {sorted(recs)} came back")
    plain, failed = recs["plain"], recs["failed"]
    if plain["mesh"] != {"data": 2, "model": 2} or failed["mesh"] != plain["mesh"]:
        raise AssertionError(f"the command lines ran on {plain['mesh']}, {failed['mesh']}")
    if ((plain["restarts"], failed["restarts"], plain["steps"], failed["steps"])
            != (0, 1, RESTART_STEPS, RESTART_STEPS)):
        raise AssertionError(f"restarts / steps: {plain['restarts']}, {failed['restarts']}, "
                             f"{plain['steps']}, {failed['steps']}")
    if failed["losses"] != plain["losses"] or not all(np.isfinite(plain["losses"])):
        raise AssertionError(f"losses differ: {failed['losses']} vs {plain['losses']}")
    arch = model_args[model_args.index("--arch") + 1]
    layers = int(model_args[model_args.index("--num-layers") + 1])
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    skeleton = build_model(cfg, device="meta", dtype=torch.float32)
    opt_cfg = AdamWConfig(moment_dtype=cfg.optimizer_moment_dtype)
    like = state_to_jax(skeleton, train_state_shapes(skeleton, opt_cfg))
    saved = []
    for n in ("plain", "failed"):
        mgr = CheckpointManager(str(tmp / n))
        if mgr.latest_step() != RESTART_STEPS:
            raise AssertionError(f"{n}: last checkpoint {mgr.latest_step()}")
        saved.append(flatten_with_paths(mgr.restore(RESTART_STEPS, like)))
    a, b = saved
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    if sorted(a) != sorted(b) or differ:
        raise AssertionError(f"restarted meshed run's final state differs at {differ[:5]}")
    restores, faults = {}, []

    def restore(name, target):  # the two restores at once
        try:
            t0 = time.perf_counter()
            mgr = CheckpointManager(str(tmp / "plain"))
            _, state = elastic_restore(mgr, RESTART_STEPS, skeleton, opt_cfg, target)
            if name != "one device":
                state = gather_train_state(skeleton, state, target, "cpu")
            got = flatten_with_paths(state_to_jax(skeleton, state))
            differ = [k for k in a if not torch.equal(got[k].cpu(), a[k])]
            if sorted(got) != sorted(a) or differ:
                faults.append(f"elastic restore onto {name} differs at {differ[:5]}")
            restores[name] = time.perf_counter() - t0
        except Exception as e:  # raised below, in the phase's own thread
            faults.append(f"elastic restore onto {name}: {e!r}")

    threads = [threading.Thread(target=restore, args=job)
               for job in (("(1, 4)", card_mesh(dev, (1, 4))), ("one device", dev))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if faults:
        raise AssertionError("; ".join(faults))
    torch.cuda.empty_cache()
    log(f"[mesh train cli] {arch} --model-parallel 2 on REPRO_DEVICES={MESH_CLI_DEVICES}: {RESTART_STEPS} steps with "
        f"a failure at step 3 equal the uninterrupted run bit for bit ({len(a)} leaves, losses "
        f"{plain['losses']}); its step-{RESTART_STEPS} checkpoint restored onto (1, 4) and one device "
        f"bitwise in {json.dumps(restores)} s")
    return dict(plain=plain, failed=failed, elastic_restore_s=restores)


def phase14(dev, launches):
    """Training on a model mesh of positions of the card: (a) qwen1.5-0.5b
    whole, (b) llama4-scout's MoE; (c) the train command line runs beside
    phase 15's command lines (``phase15_cli``)."""
    out = {}
    for name, fn in (("a qwen", phase14_qwen), ("b llama4", phase14_moe)):
        t0 = time.perf_counter()
        out[name.split()[1]] = fn(dev, launches)
        log(f"[phase] 14{name} {time.perf_counter() - t0:.3f} s")
    return out


# -- phase 15: the SSM, hybrid and encoder-decoder families on a model mesh ---

MAMBA_ARCH, JAMBA_ARCH, WHISPER_ARCH = "mamba2-1.3b", "jamba-1.5-large-398b", "whisper-tiny"
MAMBA_SERVE_MESH, FAMILY_TRAIN_MESH = (1, 4), (2, 2)  # ("data", "model") positions of the card
# (a) mamba2 trained whole: 4 x 2048 tokens (8 SSD chunks of 256 a row).
MAMBA_TRAIN_BATCH, MAMBA_TRAIN_SEQ, FAMILY_TRAIN_STEPS = 4, 2048, 3
MAMBA_GRAD_LEAVES = ("top.embed", "layers.0.ssm.in_x", "layers.0.ssm.in_b",
                     "layers.0.ssm.a_log", "layers.47.ssm.out", "layers.47.ln1.w")
# (b) whisper-tiny whole on (2, 2): 8 requests of 1500 frames; training 8
# rows of 1500 frames and 448 decoder tokens (its decoder context).
WHISPER_MESH = (2, 2)
WHISPER_REQUESTS, WHISPER_DEC_TOKENS = 8, 448
WHISPER_GRAD_LEAVES = ("top.embed", "enc_layers.0.attn.wq", "enc_layers.3.mlp.b_in",
                       "dec_layers.0.self.wo", "dec_layers.3.cross.wk", "top.dec_final.w")
# (c) jamba's smoke superblock: served on both meshes, trained on (2, 2).
JAMBA_MESHES = ((2, 2), (1, 4))
JAMBA_TRAIN_BATCH, JAMBA_TRAIN_SEQ = 8, 512
JAMBA_GRAD_LEAVES = ("top.embed", "layers.0.ssm.in_x", "layers.1.moe.router",
                     "layers.4.attn.wq", "layers.7.moe.gate")
# (d) the command lines on mamba2: serve at its defaults (8 x 32 tokens, 16
# new), train at 2 of 48 layers (a 1.9 GB checkpoint).
FAMILY_CLI_ARGS = ("--arch", MAMBA_ARCH, "--preset", "full", "--device", "cuda")
FAMILY_RESTART_MODEL = ("--arch", MAMBA_ARCH, "--preset", "full", "--num-layers", "2")
# Float32 compute over mamba2's 48 layers: the mesh's sums in another order
# move the last logits by up to 4.8e-4 (read on the H100; 9.7% of them past
# MESH_F32_TOL), so they are held as phase 11's decode check holds them, at
# a share of the largest magnitude, beside a float64 witness that both
# float32 runs must lie as near.
MAMBA_F32_REL = DECODE_REL_TOL
FAMILY_MESH_PATHS = ("jamba_tp22_serve", "jamba_tp14_serve", "whisper_mesh_bf16",
                     "whisper_mesh_f32")  # the phase's paths that launch flash


def mamba_step_bound(cfg, b, s):
    """A mamba2 training step's least time (ms) at the bf16 tensor-core
    rate: 8 N T flops for the weights in products (the in- and
    out-projections and the tied unembedding; forward, backward and the
    full remat's recompute), the SSD's own products not counted (a lower
    bound all the same)."""
    d, d_in, n = cfg.d_model, cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    per_layer = 2 * d * d_in + 2 * d * n + d * (d_in // cfg.ssm_headdim) + d_in * d
    params = cfg.num_layers * per_layer + d * cfg.vocab_size
    flops = 8 * params * b * s
    return flops / BF16_OPS_PER_S * 1e3, dict(n_matmul_params=params, tokens=b * s,
                                               flops=flops, bf16_ops_per_s=BF16_OPS_PER_S)


def whisper_batch(cfg, b, frames, tokens, dev, seed):
    """A whisper training batch on the card: frame embeddings, decoder
    tokens and their targets, from ``seed``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {"enc_embeds": 0.02 * torch.randn((b, frames, cfg.d_model), generator=gen, device=dev),
            "dec_tokens": torch.randint(0, cfg.vocab_size, (b, tokens), generator=gen, device=dev),
            "targets": torch.randint(0, cfg.vocab_size, (b, tokens), generator=gen, device=dev)}


def mesh_train_family(tag, cfg, mesh, batches, grad_leaves, dev, launches, blockwise=None,
                      bound=None):
    """One step in float32 compute on one device and on ``mesh`` from the
    same weights (seed 0) and ``batches[0]`` (global dicts): the loss (and
    aux) within ``TRAIN_LOSS_RTOL``, the leaves ``grad_leaves`` by
    ``TRAIN_GRAD_REL_L2`` (relative L2).  ``blockwise`` (the mesh's
    (n_data, n_model)) runs the one-device MoE layers as
    ``moe_blockwise_reference``.  Then the config's compute dtype, float32
    masters: ``len(batches)`` steps of ``make_train_step(mesh=)`` as path
    ``{tag}`` with the launch counts zeroed just before and read just after
    (all 0), step ms, tokens/s, peak memory, one more step traced."""
    from repro_torch.models import build_model, moe, transformer
    from repro_torch.models.model import gather_leaves, mesh_model, shard_leaves
    from repro_torch.train import (AdamWConfig, TrainState, make_train_step,
                                   mesh_value_and_grad, warmup_cosine)

    model = build_model(cfg, device=dev, dtype=torch.float32, compute_dtype=torch.float32,
                        generator=torch.Generator(device=dev).manual_seed(0))
    n_params = model.num_params()
    params = model.flat_params()
    leaves = {k: v.detach().requires_grad_(k in grad_leaves) for k, v in params.items()}
    inner = transformer.moe_einsum
    one_disp, mesh_disp = [], []
    if blockwise is not None:
        transformer.moe_einsum = functools.partial(_blockwise, shape=blockwise)
    t0 = time.perf_counter()
    try:
        with recorded_dispatches(one_disp):
            loss, metrics = model.train_loss(batches[0], leaves)
            one = dict(zip(grad_leaves,
                           torch.autograd.grad(loss, [leaves[k] for k in grad_leaves])))
    finally:
        transformer.moe_einsum = inner
    one_m = {k: float(v.detach()) for k, v in metrics.items()}
    one_s = time.perf_counter() - t0
    del leaves, loss, metrics
    meshed = mesh_model(model, mesh)
    shards = shard_leaves(meshed, params)
    del params
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorded_dispatches(mesh_disp):
        _, metrics, grads = mesh_value_and_grad(model, mesh)(shards, batches[0])
    mesh_m = {k: float(v) for k, v in metrics.items()}
    f32_s = time.perf_counter() - t0
    if [d.shape for d in mesh_disp] != [d.shape for d in one_disp]:
        raise AssertionError(f"{tag}: the mesh dispatched {len(mesh_disp)} blocks, the "
                             f"reference {len(one_disp)}")
    flipped = sum(int((a != b).sum()) for a, b in zip(mesh_disp, one_disp))
    slots = sum(d.numel() for d in one_disp)
    del one_disp, mesh_disp
    got = gather_leaves(meshed, [{k: g[k] for k in grad_leaves} for g in grads])
    del grads
    rel = {k: rel_l2(got[k], one[k]) for k in grad_leaves}
    del got, one
    log(f"[{tag}] float32 step 0 on {mesh.shape}: {json.dumps(mesh_m)} vs one device "
        f"{json.dumps(one_m)} (rtol {TRAIN_LOSS_RTOL}); gradient relative L2 errors "
        f"{json.dumps(rel)} (<= {TRAIN_GRAD_REL_L2}); {flipped} of {slots} MoE dispatch slots "
        f"routed otherwise; the float32 step {one_s:.3f} s on one device, {f32_s:.3f} s on "
        f"the mesh")
    for key in ("loss", "aux_loss"):
        if not abs(mesh_m[key] - one_m[key]) <= TRAIN_LOSS_RTOL * abs(one_m[key]):
            raise AssertionError(f"{tag}: meshed float32 {key} {mesh_m[key]} vs one device "
                                 f"{one_m[key]}")
    bad = {k: r for k, r in rel.items() if not r <= TRAIN_GRAD_REL_L2}
    if bad:
        raise AssertionError(f"{tag}: meshed gradients off the one-device ones: {bad}")

    model.compute_dtype = getattr(torch, cfg.dtype)
    opt_cfg = AdamWConfig(learning_rate=warmup_cosine(3e-4, 1, len(batches)),
                          moment_dtype=cfg.optimizer_moment_dtype)
    step_fn = make_train_step(model, opt_cfg, mesh=mesh)
    del model
    state = TrainState.create(shards, opt_cfg)
    del shards
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    step_s, losses = [], []

    def train():
        nonlocal state
        for batch in batches:
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            step_s.append(time.perf_counter() - t0)

    counted(tag, launches, train)
    peak = torch.cuda.max_memory_allocated(dev)
    if any(launches[tag].values()):
        raise AssertionError(f"{tag}: meshed training launched kernels: {launches[tag]}")
    if not all(np.isfinite(losses)) or not abs(losses[0] - mesh_m["loss"]) <= \
            BF16_TRAIN_LOSS_RTOL * abs(mesh_m["loss"]):
        raise AssertionError(f"{tag}: losses {losses}, the float32 step 0's {mesh_m['loss']}")
    t0 = time.perf_counter()
    trace = device_breakdown(lambda: step_fn(state, batches[0]), top=8, host_ops=False)
    trace["seconds"] = time.perf_counter() - t0
    step_ms = 1e3 * sorted(step_s[1:])[len(step_s[1:]) // 2]
    tokens = batches[0]["targets"].numel()
    rec = dict(path=tag, arch=cfg.name, layers=cfg.num_layers, params=n_params, mesh=mesh.shape,
               batch=list(batches[0]["targets"].shape), steps=len(batches),
               step_ms=[1e3 * t for t in step_s], median_step_ms=step_ms,
               tokens_per_s=tokens / (step_ms / 1e3), peak_mem_bytes=peak,
               launches=launches[tag], losses=losses, f32_mesh=mesh_m, f32_one_device=one_m,
               grad_rel_l2=rel, dispatch_slots=slots, slots_routed_otherwise=flipped,
               f32_one_device_step_s=one_s, f32_mesh_step_s=f32_s, trace=trace)
    if bound is not None:
        rec.update(bound_ms=bound[0], bound_share=bound[0] / step_ms, bound_reckoning=bound[1])
    log(f"[{tag}] {json.dumps(rec)}")
    log(f"[{tag}] {cfg.name} on {mesh.shape}: step {step_ms:.3f} ms (median of steps 2-"
        f"{len(batches)}; first {1e3 * step_s[0]:.3f}), {rec['tokens_per_s']:.1f} tokens/s, "
        f"peak {peak / 1e9:.3f} GB, 0 kernel launches, device busy "
        f"{100 * trace['device_busy_share']:.1f}% of a traced step")
    del state, step_fn
    torch.cuda.empty_cache()
    return rec


def _blockwise(p, x, *, cfg, shape):
    from repro_torch.models import moe

    return moe.moe_blockwise_reference(p, x, cfg, *shape)


# A training step in bf16 compute against step 0 in float32 compute, the
# same weights and batch: phase 12's bf16 loss tolerance.
BF16_TRAIN_LOSS_RTOL = 2e-3


def decode_trace(meshed, reqs, dev):
    """One decode step of ``meshed`` traced after a prefill of the first 4
    prompts cut to 256 tokens (one SSD chunk): its host seconds, device ms, busy
    share and kernel launches (``device_calls``)."""
    n = min([256] + [len(r.prompt) for r in reqs[:4]])
    toks = torch.tensor([r.prompt[:n] for r in reqs[:4]], device=dev)
    _, caches = meshed.prefill(toks, cache_len=n + 2)
    out = device_breakdown(lambda: meshed.serve_step(toks[:, :1], n, caches), top=8,
                           host_ops=False)
    del caches
    return out


def phase15_mamba(dev, launches):
    """(a) mamba2-1.3b whole: served in bf16 on (1, 4) positions (16 SSM
    heads and 1024 channels a position; phase 11's waves; no kernel), held
    by ``mesh_serve`` (bf16 tokens by the margin rule, float32-compute
    logits within ``MAMBA_F32_REL`` of the largest magnitude, beside a
    float64 witness), one decode step traced; then trained
    on (2, 2) (float32 masters, bf16 compute, remat full, fsdp: its config)
    through ``mesh_train_family`` at 4 x 2048 tokens."""
    from repro_torch.configs import get_config
    from repro_torch.data import ShardedDataPipeline

    reqs = family_requests(get_config(MAMBA_ARCH), FAMILY_WAVES["mamba2"])
    t0 = time.perf_counter()
    meshed, rec, check = mesh_serve(
        "mamba2_tp", lambda: build_family(MAMBA_ARCH, dev, torch.bfloat16),
        card_mesh(dev, MAMBA_SERVE_MESH), reqs, dev, launches, f32_rel=MAMBA_F32_REL)
    if any(launches["mamba2_tp_serve"].values()):
        raise AssertionError(f"mamba2 on the mesh launched {launches['mamba2_tp_serve']}")
    log(f"[mamba2_tp] served, held and freed the one-device model: {time.perf_counter() - t0:.3f} s")
    check["decode_step_trace"] = decode_trace(meshed, reqs, dev)
    log(f"[mamba2_tp] a decode step traced: {json.dumps(check['decode_step_trace'])}")
    del meshed
    torch.cuda.empty_cache()
    cfg = get_config(MAMBA_ARCH)
    mesh = card_mesh(dev, FAMILY_TRAIN_MESH)
    pipe = ShardedDataPipeline(mesh=mesh, global_batch=MAMBA_TRAIN_BATCH, seq_len=MAMBA_TRAIN_SEQ,
                               vocab=cfg.vocab_size, seed=0)
    batches = [pipe.batch_at(i) for i in range(FAMILY_TRAIN_STEPS)]
    train = mesh_train_family("mamba2_mesh_train", cfg, mesh, batches, MAMBA_GRAD_LEAVES, dev,
                              launches, bound=mamba_step_bound(cfg, MAMBA_TRAIN_BATCH,
                                                               MAMBA_TRAIN_SEQ))
    return dict(serve=rec, serve_check=check, train=train)


def phase15_whisper(dev, launches):
    """(b) whisper-tiny whole on (2, 2) positions: ``WHISPER_REQUESTS``
    requests of 1500 frames and a 4-token prompt, ``NEW_TOKENS`` greedy
    tokens, in bf16 and float32, as paths ``whisper_mesh_{bf16,f32}``: flash
    once a position a layer of each attention (3 heads a position), every
    prefill attention held to the plain version on its own q, k, v, the
    float32 tokens equal to the one-device model's; then trained through
    ``mesh_train_family`` on 8 x (1500 frames, 448 tokens)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import shard_params

    mesh = card_mesh(dev, WHISPER_MESH)
    recs, checks = [], {}
    for dtype, tag in ((torch.bfloat16, "whisper_mesh_bf16"), (torch.float32, "whisper_mesh_f32")):
        model = build_family(WHISPER_ARCH, dev, dtype)
        cfg = model.cfg
        gen = torch.Generator(device=dev).manual_seed(2)
        frames = (0.02 * torch.randn((WHISPER_REQUESTS, WHISPER_FRAMES, cfg.d_model),
                                     generator=gen, device=dev)).to(dtype)
        prompt = torch.randint(0, cfg.vocab_size, (WHISPER_REQUESTS, WHISPER_PROMPT),
                               generator=gen, device=dev)
        model.greedy(frames[:, :64], prompt, 2)  # warm-up
        one, one_rec = counted(f"{tag}_one_device", launches,
                               lambda: model.greedy(frames, prompt, NEW_TOKENS))
        one_logits, _ = model.prefill(frames, prompt)
        meshed = shard_params(model, mesh)
        del model
        meshed.greedy(frames[:, :64], prompt, 2)
        torch.cuda.reset_peak_memory_stats(dev)
        toks, rec = counted(tag, launches, lambda: meshed.greedy(frames, prompt, NEW_TOKENS))
        peak = torch.cuda.max_memory_allocated(dev)
        attn = (cfg.encoder_layers + 2 * cfg.decoder_layers) * mesh.size
        if launches[tag]["flash_attention"] != attn:
            raise AssertionError(f"{tag}: launches {launches[tag]}; want {attn} flash")
        errs = []
        with held_to_plain(errs):
            logits, _ = meshed.prefill(frames, prompt)
        if len(errs) != attn:
            raise AssertionError(f"{tag}: held {len(errs)} prefill attentions, want {attn}")
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{tag}: non-finite logits")
        same = torch.equal(toks, one)
        if dtype == torch.float32 and not same:
            raise AssertionError(f"{tag}: meshed and one-device tokens differ: {toks.tolist()} "
                                 f"vs {one.tolist()}")
        check = dict(logit_err=(logits.float() - one_logits.float()).abs().max().item(),
                     layer_abs_err=max(e for e, _ in errs), layer_row_err=max(r for _, r in errs),
                     tokens_equal=same, one_device=dict(one_rec, decode_ms_per_step=1e3 *
                                                        one_rec["decode_s"] /
                                                        one_rec["decode_steps"]))
        rec.update(path=tag, arch=cfg.name, dtype=str(dtype)[6:], mesh=mesh.shape,
                   enc_frames=WHISPER_FRAMES, prompt_len=WHISPER_PROMPT, peak_mem_bytes=peak,
                   flash_launches=launches[tag]["flash_attention"],
                   decode_ms_per_step=1e3 * rec["decode_s"] / rec["decode_steps"])
        log(f"[{tag}] {json.dumps(rec)}; held {json.dumps(check)}")
        recs.append(rec)
        checks[tag] = check
        del meshed, frames, prompt
        torch.cuda.empty_cache()
    cfg = get_config(WHISPER_ARCH)
    batches = [whisper_batch(cfg, WHISPER_REQUESTS, WHISPER_FRAMES, WHISPER_DEC_TOKENS, dev, i)
               for i in range(FAMILY_TRAIN_STEPS)]
    train = mesh_train_family("whisper_mesh_train", cfg, card_mesh(dev, FAMILY_TRAIN_MESH),
                              batches, WHISPER_GRAD_LEAVES, dev, launches)
    return dict(serve=recs, serve_check=checks, train=train)


def phase15_jamba(dev, launches):
    """(c) jamba's smoke superblock (a full-width one is 90.3 GB) in bf16 on
    (2, 2) and (1, 4) positions through ``mesh_serve``, the one-device
    reference's MoE layers as ``moe_blockwise_reference`` over the mesh's
    blocks (flash once a position at the attention layer); trained on
    (2, 2) through ``mesh_train_family`` at 8 x 512 tokens, the float32 loss,
    aux and gradient leaves (a router's among them) against the blockwise
    one-device run, microbatches cut to 1 (one row a microbatch a data
    shard otherwise)."""
    from repro_torch.configs import smoke_config
    from repro_torch.data import ShardedDataPipeline
    from repro_torch.models import transformer

    reqs = family_requests(smoke_config(JAMBA_ARCH), FAMILY_WAVES["jamba"])
    recs, checks = [], {}
    for shape in JAMBA_MESHES:
        tag = f"jamba_tp{shape[0]}{shape[1]}"
        inner = transformer.moe_einsum
        transformer.moe_einsum = functools.partial(_blockwise, shape=shape)
        try:
            meshed, rec, check = mesh_serve(
                tag, lambda: build_family(JAMBA_ARCH, dev, torch.bfloat16, smoke=True),
                card_mesh(dev, shape), reqs, dev, launches)
        finally:
            transformer.moe_einsum = inner
        recs.append(rec)
        checks[tag] = check
        del meshed
        torch.cuda.empty_cache()
    cfg = dataclasses.replace(smoke_config(JAMBA_ARCH), dtype="bfloat16", microbatches=1)
    mesh = card_mesh(dev, FAMILY_TRAIN_MESH)
    pipe = ShardedDataPipeline(mesh=mesh, global_batch=JAMBA_TRAIN_BATCH, seq_len=JAMBA_TRAIN_SEQ,
                               vocab=cfg.vocab_size, seed=0)
    batches = [pipe.batch_at(i) for i in range(FAMILY_TRAIN_STEPS)]
    train = mesh_train_family("jamba_mesh_train", cfg, mesh, batches, JAMBA_GRAD_LEAVES, dev,
                              launches, blockwise=FAMILY_TRAIN_MESH)
    return dict(serve=recs, serve_check=checks, train=train)


def phase15_flash(dev):
    """Flash at whisper's two new per-position shapes on (2, 2): the encoder
    (B=4, S=T=1500, H=KV=3, D=64, non-causal) and the cross-attention (B=4,
    S=4, T=1500), bf16, held to the plain version and timed with its bound
    and SDPA's time."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    timings, err = [], 0.0
    bf = torch.bfloat16
    b = WHISPER_REQUESTS // WHISPER_MESH[0]
    for i, (label, s) in enumerate([
            (f"whisper (2, 2) position B={b} S=T=1500 H=KV=3 D=64 non-causal", WHISPER_FRAMES),
            (f"whisper cross (2, 2) position B={b} S=4 T=1500 H=KV=3 D=64 non-causal",
             WHISPER_PROMPT)]):
        q, k, v = attn_inputs(b, s, WHISPER_FRAMES, 3, 3, 64, bf, dev, seed=150 + i)
        e, row = flash_errors(flash_attention_cuda(q, k, v, causal=False),
                              ref.flash_attention(q, k, v, causal=False), bf)
        err = max(err, e)
        log(f"[flash] {label} bf16: max abs err {e:.3e}, max row err {row:.3e}")
        timings.append(time_flash(q, k, v, label, causal=False))
        del q, k, v
    torch.cuda.empty_cache()
    return timings, err


def phase15_cli(dev):
    """(d) The command lines on mamba2-1.3b with ``REPRO_DEVICES=4``:
    ``launch.serve --model-parallel 2`` against ``1`` (phase 13 (d)'s
    check), and ``launch.train --model-parallel 2`` at 2 of 48 layers with
    its crash-restart bitwise and ``elastic_restore`` onto (1, 4) and one
    device bitwise (phase 14 (c)'s check).  The serve pair runs beside the
    train pair, and phases 12 (c) and 14 (c) beside both: none is timed
    against another, and the eight processes share the card."""
    served, qwen = {}, {}

    def serve():
        served["out"] = phase13_cli(dev, FAMILY_CLI_ARGS)

    def beside(key, name, prefix, fn):
        """Phases 12 (c) and 14 (c), run here: their processes wait on
        start-up and checkpoint I/O, so they overlap these."""
        t0 = time.perf_counter()
        tmp_b = pathlib.Path(tempfile.mkdtemp(prefix=prefix))
        try:
            qwen[key] = fn(tmp_b)
        finally:
            shutil.rmtree(tmp_b, ignore_errors=True)
        log(f"[phase] {name} (beside 15d) {time.perf_counter() - t0:.3f} s")

    jobs = [(serve, ()),
            (beside, ("train_cli", "12c train cli", "chip_smoke_train_", restart_checks)),
            (beside, ("mesh_train_cli", "14c train cli", "chip_smoke_mesh_train_",
                      lambda tmp_q: phase14_cli(dev, tmp_q)))]
    threads = [threading.Thread(target=fn, args=args) for fn, args in jobs]
    for t in threads:
        t.start()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_family_train_"))
    try:
        train = phase14_cli(dev, tmp, FAMILY_RESTART_MODEL)
    finally:
        for t in threads:
            t.join()
        shutil.rmtree(tmp, ignore_errors=True)
    if "out" not in served:
        raise AssertionError("the serve command lines' check failed (its traceback above)")
    missing = {"train_cli", "mesh_train_cli"} - set(qwen)
    if missing:
        raise AssertionError(f"the command lines of {sorted(missing)} failed (their tracebacks "
                             "above)")
    serve, serve_check = served["out"]
    return dict(serve=dict(serve_check, runs={
        n: {k: o[k] for k in ("mesh", "new_tokens", "seconds", "prefill_s", "decode_ms_per_step")}
        for n, o in serve.items()}), train=train, **qwen)


def phase15(dev, launches):
    """The SSM, hybrid and encoder-decoder families on a model mesh of
    positions of the card: (a) mamba2, (b) whisper, (c) jamba's superblock,
    (d) the command lines; and flash at whisper's per-position shapes."""
    out = {}
    for name, fn in (("a mamba2", phase15_mamba), ("b whisper", phase15_whisper),
                     ("c jamba", phase15_jamba)):
        t0 = time.perf_counter()
        out[name.split()[1]] = fn(dev, launches)
        log(f"[phase] 15{name} {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    out["cli"] = phase15_cli(dev)
    log(f"[phase] 15d command lines {time.perf_counter() - t0:.3f} s")
    timings, err = phase15_flash(dev)
    return out, timings, err


def kernel_entry(name, source, replaces, paths, launches, err, head, shapes):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=sum(launches[p][name] for p in paths),
                launches_by_path={p: launches[p][name] for p in paths},
                max_abs_err=err, ms=head["ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                library_ms=head["library_ms"], at_shapes=shapes)


# -- phase 16: the dry run's accounting held to the card -----------------------

# The meta run's peak live bytes against the card's max_memory_allocated over
# the same step: the allocator rounds each block up to 512 bytes and holds
# cuBLAS's workspace, which the meta run does not see.
DRYRUN_PEAK_BAND = (0.90, 1.10)
DRYRUN_CELL = ("--arch", "qwen1.5-0.5b", "--shape", "decode_32k", "--mesh", "single",
               "--set", "num_layers=2")
DRYRUN_HAND_BOUND_MS = 68.149  # PERF.md's hand-worked bound of phase 12's step


def first_difference(card_ops, meta_ops):
    """The first op at which two counted runs part: (index, card's, meta's)."""
    for i, (a, b) in enumerate(zip(card_ops, meta_ops)):
        if a[:4] != b[:4]:
            return i, a, b
    return min(len(card_ops), len(meta_ops)), None, None


def phase16_qwen(dev, smi):
    """(a) phase 12's step counted on the card and on meta tensors."""
    from repro_torch.analysis.op_analysis import analyze_step
    from repro_torch.analysis.roofline import model_flops, roofline_terms
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step
    from repro_torch.train import train_state_shapes

    cfg = get_config(TRAIN_ARCH)
    opt_cfg = AdamWConfig(moment_dtype=cfg.optimizer_moment_dtype)
    shape = ShapeConfig("phase16", TRAIN_SEQ, TRAIN_BATCH, "train")

    def run(device):
        kw = dict(dtype=torch.float32, compute_dtype=cfg.dtype)
        if device == "meta":
            model = build_model(cfg, device="meta", **kw)
            state = train_state_shapes(model, opt_cfg)
            batch = model.input_specs(shape)
        else:
            model = build_model(cfg, device=device, **kw,
                                generator=torch.Generator(device=device).manual_seed(0))
            state = init_train_state(model, opt_cfg)
            gen = torch.Generator(device=device).manual_seed(1)
            tokens = torch.randint(0, model.cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                                   generator=gen, device=device, dtype=torch.int32)
            batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
        return model, state, batch, make_train_step(model, opt_cfg)

    model, state, batch, step = run(dev)
    for _ in range(2):  # warm, then the measured step (its result dropped)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(state, batch)
        float(out[1]["loss"])
        step_ms = 1e3 * (time.perf_counter() - t0)
        del out
    torch.cuda.empty_cache()
    state_bytes = sum(t.numel() * t.element_size()
                      for tree in (state.params, state.opt["m"], state.opt["v"])
                      for t in tree.values())
    state_bytes += 2 * 4  # the count and the step, int32
    batch_bytes = sum(t.numel() * t.element_size() for t in batch.values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    card = analyze_step(step, state, batch, keep_ops=True)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    card_peak = torch.cuda.max_memory_allocated(dev)
    del model, state, batch, step
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    m_model, m_state, m_batch, m_step = run("meta")
    meta = analyze_step(m_step, m_state, m_batch, keep_ops=True)
    meta_s = time.perf_counter() - t0
    if (card["flops"], card["bytes"]) != (meta["flops"], meta["bytes"]):
        i, a, b = first_difference(card["ops"], meta["ops"])
        raise AssertionError(f"card {card['flops']} flops, {card['bytes']} bytes; meta "
                             f"{meta['flops']}, {meta['bytes']}: op {i} card {a}, meta {b}")
    arg = meta["memory"]["argument_size_in_bytes"]
    if arg != state_bytes + batch_bytes:
        raise AssertionError(f"meta arguments {arg} bytes; the card's state {state_bytes} and "
                             f"batch {batch_bytes}")
    meta_peak = meta["memory"]["total_hbm_bytes"]
    ratio = meta_peak / card_peak
    if not DRYRUN_PEAK_BAND[0] <= ratio <= DRYRUN_PEAK_BAND[1]:
        raise AssertionError(f"meta peak {meta_peak} bytes, card {card_peak}: {ratio:.4f} "
                             f"outside {DRYRUN_PEAK_BAND}")
    roof = roofline_terms(flops_per_device=meta["flops"], bytes_per_device=meta["bytes"],
                          collective_operand_bytes=0.0, n_devices=1,
                          model_flops_global=model_flops(m_model.cfg, shape))
    bound_ms = 1e3 * max(roof["compute_s"], roof["memory_s"], roof["collective_s"])
    if not bound_ms <= step_ms:
        raise AssertionError(f"roofline bound {bound_ms} ms over the measured step {step_ms}")
    rec = dict(step_ms=step_ms, flops=meta["flops"], bytes=meta["bytes"], ops=len(meta["ops"]),
               argument_bytes=arg, state_bytes=state_bytes, batch_bytes=batch_bytes,
               meta_peak_bytes=meta_peak, card_peak_bytes=card_peak, peak_ratio=ratio,
               memory=meta["memory"], roofline=roof, bound_ms=bound_ms,
               bound_share=bound_ms / step_ms, hand_bound_ms=DRYRUN_HAND_BOUND_MS,
               hand_bound_share=DRYRUN_HAND_BOUND_MS / step_ms, card_count_s=card_s,
               meta_count_s=meta_s, card=smi)
    log(f"[dryrun] (a) {TRAIN_ARCH} step {TRAIN_BATCH} x {TRAIN_SEQ} on {smi}: card and meta "
        f"count {meta['flops']:.6e} flops, {meta['bytes']:.6e} bytes over {len(meta['ops'])} "
        f"ops; arguments {arg} bytes (state {state_bytes} + batch {batch_bytes}); peak meta "
        f"{meta_peak} / card {card_peak} = {ratio:.4f}; roofline {bound_ms:.3f} ms "
        f"({roof['dominant']}) = {100 * bound_ms / step_ms:.2f}% of the measured "
        f"{step_ms:.3f} ms step (hand-worked {DRYRUN_HAND_BOUND_MS} ms: "
        f"{100 * DRYRUN_HAND_BOUND_MS / step_ms:.2f}%): {json.dumps(rec)}")
    return rec


def phase16_yi(dev, launches, smi):
    """(b) yi-6b on (1, 4) positions: a 2048 wave's prefill and a decode step,
    counted on the card and on a mesh of meta positions."""
    from repro_torch.analysis.op_analysis import analyze_step
    from repro_torch.configs import get_config
    from repro_torch.dist import make_mesh
    from repro_torch.kernels.flash_attention import flash_charge
    from repro_torch.models import build_model
    from repro_torch.models.model import shard_params

    cfg = get_config("yi-6b")
    b, s = 4, 2048
    n = int(np.prod(YI_TP_MESH))

    def counts(device):
        if device == "meta":
            model = build_model(cfg, device="meta", dtype=torch.bfloat16)
            mesh = make_mesh(YI_TP_MESH, ("data", "model"), devices=["meta"] * n)
            tokens = torch.empty((b, s), dtype=torch.int64, device="meta")
        else:
            model = build_model(cfg, device=device, dtype=torch.bfloat16,
                                generator=torch.Generator(device=device).manual_seed(0))
            mesh = card_mesh(device, YI_TP_MESH)
            tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                                         (b, s))).to(device)
        meshed = shard_params(model, mesh)
        del model
        out = {}

        def prefill(t):
            out["caches"] = meshed.prefill(t, cache_len=s + 1)[1]

        def decode(t):
            meshed.serve_step(t, s, out["caches"])

        recs = {}

        def both():
            recs["prefill"] = analyze_step(prefill, tokens, num_partitions=n)
            recs["decode"] = analyze_step(decode, tokens[:, :1], num_partitions=n)

        if device == "meta":
            both()
        else:
            counted("dryrun_yi_tp", launches, both)
        del meshed, out
        torch.cuda.empty_cache()
        return recs

    card, meta = counts(dev), counts("meta")
    flash = launches["dryrun_yi_tp"]["flash_attention"]
    if flash != cfg.num_layers * n:
        raise AssertionError(f"{flash} flash launches, want {cfg.num_layers * n}")
    hq, kvq = cfg.num_heads // n, cfg.num_kv_heads // n
    per = flash_charge(b, s, s, hq, kvq, cfg.head_dim, torch.finfo(getattr(torch, cfg.dtype)).bits // 8,
                       True)
    want = {"calls": flash, "flops": flash * per[0] / n, "bytes": flash * per[1] / n}
    for step in ("prefill", "decode"):
        c, m = card[step], meta[step]
        cc, mc = c["collectives"]["by_type"], m["collectives"]["by_type"]
        if {k: (v["count"], v["operand_bytes"]) for k, v in cc.items()} != \
                {k: (v["count"], v["operand_bytes"]) for k, v in mc.items()}:
            raise AssertionError(f"{step} collectives: card {cc}, meta {mc}")
        if c["kernels"] != m["kernels"]:
            raise AssertionError(f"{step} kernel charges: card {c['kernels']}, meta {m['kernels']}")
    if card["prefill"]["kernels"].get("flash_attention") != want:
        raise AssertionError(f"flash charge {card['prefill']['kernels']}, want {want}")
    rec = {step: dict(collectives=card[step]["collectives"], kernels=card[step]["kernels"],
                      flops=card[step]["flops"], bytes=card[step]["bytes"],
                      meta_flops=meta[step]["flops"], meta_bytes=meta[step]["bytes"])
           for step in ("prefill", "decode")}
    rec.update(flash_launches=flash, flash_per_launch=dict(flops=per[0], bytes=per[1]),
               card=smi)
    log(f"[dryrun] (b) yi-6b on {YI_TP_MESH} positions, {b} x {s} prefill and a decode step on "
        f"{smi}: collectives equal on the card and meta ({json.dumps({k: v['collectives']['by_type'] for k, v in rec.items() if k in ('prefill', 'decode')})}); "
        f"flash {flash} launches x {per[0]} flops, {per[1]} bytes: {json.dumps(rec)}")
    return rec


def phase16_cli(smi):
    """(c) the dry run's command line for one production cell: its ``main``
    in this process (as phase 12 runs the serve command line's), which
    spares an interpreter's start and the imports."""
    import io

    from repro_torch.launch import dryrun

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    try:
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            dryrun.main([*DRYRUN_CELL, "--out", str(tmp)])  # exits non-zero on a failed cell
        seconds = time.perf_counter() - t0
        arch, shape = DRYRUN_CELL[1], DRYRUN_CELL[3]
        rec = json.loads((tmp / "single" / f"{arch}__{shape}.json").read_text())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if rec["status"] != "ok" or rec["n_devices"] != 256:
        raise AssertionError(f"dry-run record {rec}")
    line = printed.getvalue().strip().splitlines()[-1]
    log(f"[dryrun] (c) {' '.join(DRYRUN_CELL)}: {seconds:.3f} s (trace {rec['trace_s']} s; the "
        f"host's CPU, beside {smi}): {line}")
    return dict(seconds=seconds, trace_s=rec["trace_s"], roofline=rec["roofline"],
                memory=rec["memory"], collectives=rec["collectives"], cost=rec["cost"],
                summary=line)


def phase16(dev, launches, smi):
    torch.cuda.empty_cache()
    return dict(qwen=phase16_qwen(dev, smi), yi=phase16_yi(dev, launches, smi),
                cli=phase16_cli(smi))


# Phase 17: the meshed caches in JAX's ``_cache_specs`` layout.
SEQ_ARCH = "yi-6b"
SEQ_TP_MESH, SEQ_TP_ROWS, SEQ_TP_PROMPT = (1, 8), 4, 2048  # (a): the sequence over model
SEQ_DATA_MESH, SEQ_DATA_PROMPT = (2, 4), 8192  # (b): one row, the sequence over data
SEQ_NEW_TOKENS = 8  # 16 to the first runs: cut for the script's time
SEQ_PATHS = ("yi6b_seq_tp8_serve", "yi6b_seq_data_serve")
EXAMPLES = ("quickstart", "train_lm", "custom_score", "feature_selection_pipeline", "serve_lm")
EXAMPLE_TIMEOUT = 300.0  # seconds an example


def position_cache_bytes(caches) -> list:
    """Each position's cache bytes."""
    return [sum(t.numel() * t.element_size() for layer in pos for t in layer.values())
            for pos in caches]


def seq_serve(tag, model, mesh, reqs, dev, launches, replicate=False):
    """Serve ``reqs`` with the one-device ``model`` (the reference: tokens
    and margins), then sharded onto ``mesh`` (the batch replicated over
    the batch axes with ``replicate``) as path ``{tag}_serve``: flash
    launched once a position an attention layer a wave, each prefill
    attention held to the plain version on its own q, k, v, the tokens held
    to one device's by ``margin_rule`` with the larger of the last prefill
    logits' and the first decode step's errors; each position's cache bytes
    against the whole's share its spec gives it and the former layout's (the
    whole sequence, ``KV / tp`` heads or ``H / tp`` repeated ones); a decode
    step traced.  -> (the meshed serve's record, the check)."""
    from repro_torch.dist.sharding import mesh_extent
    from repro_torch.models.model import shard_params
    from repro_torch.serve import Request

    cfg = model.cfg
    attn = sum(kind == "attn" for kind, _ in model.kinds)
    one_outs, one_margins, one_rec = serve_run(f"{tag}_one_device", model, reqs, dev, launches)
    toks = torch.tensor([r.prompt for r in reqs], device=dev)
    b, s = toks.shape
    length = s + reqs[0].max_new_tokens

    def first_step(m):  # the step feeds both models the same tokens
        logits, caches = m.prefill(toks, cache_len=length)
        step, caches = m.serve_step(toks[:, -1:], s, caches)
        return logits.float(), step[:, 0].float(), caches

    one_logits, one_step, one_caches = first_step(model)
    del one_caches
    t0 = time.perf_counter()
    meshed = shard_params(model, mesh)
    if replicate:
        meshed = meshed.with_batch_replicated()
    shard_s = time.perf_counter() - t0
    margin_engine(meshed).serve([Request(reqs[0].prompt[:62], 2)])  # warm-up, 64 slots
    outs, _, rec = serve_run(f"{tag}_serve", meshed, reqs, dev, launches)
    want = attn * mesh.size
    if rec["flash_launches_per_wave"] != [want]:
        raise AssertionError(f"{tag}: flash launches per wave {rec['flash_launches_per_wave']}, "
                             f"want {want} ({attn} attention layers x {mesh.size} positions)")
    layer_errs = []
    with held_to_plain(layer_errs):
        logits, step, caches = first_step(meshed)
    if len(layer_errs) != want:
        raise AssertionError(f"{tag}: held {len(layer_errs)} prefill attentions, want {want}")
    for t in (logits, step):
        if not torch.isfinite(t).all():
            raise AssertionError(f"{tag}: non-finite logits on the mesh")
    prefill_err = (logits - one_logits).abs().max().item()
    step_err = (step - one_step).abs().max().item()
    agree = margin_rule(outs, one_outs, one_margins, max(prefill_err, step_err), reqs)

    spec = caches[0][0].specs["k"]
    elem = caches[0][0]["k"].element_size()
    whole = 2 * attn * b * length * cfg.num_kv_heads * cfg.head_dim * elem
    share = 1
    for e in spec:
        share *= mesh_extent(mesh, e)
    per = position_cache_bytes(caches)
    if per != [whole // share] * mesh.size:
        raise AssertionError(f"{tag}: positions hold {sorted(set(per))} cache bytes, want "
                             f"{whole // share} (1/{share} of {whole}, spec {tuple(spec)})")
    tp, h, kv = meshed.ctx.tp, cfg.num_heads, cfg.num_kv_heads
    old_heads = kv // tp if kv % tp == 0 else h // tp
    old = 2 * attn * (b // meshed.ctx.n_batch) * length * old_heads * cfg.head_dim * elem
    trace = device_breakdown(lambda: meshed.serve_step(toks[:, :1], s + 1, caches), top=8,
                             host_ops=False)
    del caches, meshed
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    check = dict(mesh=mesh.shape, spec=[e if e is None or isinstance(e, str) else list(e)
                                        for e in spec],
                 cache_bytes_a_position=per[0], cache_bytes_whole=whole,
                 share=f"1/{share}", cache_bytes_a_position_former_layout=old,
                 prefill_logit_err=prefill_err, step_logit_err=step_err,
                 tokens_equal=outs == one_outs, agreement=agree, shard_s=shard_s,
                 decode_ms_per_step=rec["decode_ms_per_step"],
                 one_device_decode_ms_per_step=one_rec["decode_ms_per_step"],
                 kernels_a_step=trace["device_calls"], step_trace=trace,
                 peak_mem_bytes=rec["peak_mem_bytes"],
                 layer_abs_err=max(e for e, _ in layer_errs),
                 layer_row_err=max(r for _, r in layer_errs))
    log(f"[{tag}] {json.dumps(check)}")
    log(f"[{tag}] cache a position {per[0]} bytes of {whole} ({check['share']}; the former "
        f"layout held {old}); decode {rec['decode_ms_per_step']:.3f} ms a step "
        f"(one device {one_rec['decode_ms_per_step']:.3f}), {trace['device_calls']} kernels a "
        f"traced step, peak {rec['peak_mem_bytes']} bytes")
    rec.update(arch=cfg.name, mesh=mesh.shape, dtype=str(model.dtype)[6:])
    return rec, check


def phase17_serve(dev, launches):
    """(a) and (b): yi-6b whole in bf16 on (1, 8), then its weights on (2,
    4) with one 8192-token row."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import Request

    cfg = get_config(SEQ_ARCH)
    rng = np.random.default_rng(7)
    model = build_model(cfg, device=dev, dtype=torch.bfloat16,
                        generator=torch.Generator(device=dev).manual_seed(0))
    out = {}
    t0 = time.perf_counter()
    reqs = [Request(rng.integers(0, cfg.vocab_size, SEQ_TP_PROMPT).tolist(), SEQ_NEW_TOKENS)
            for _ in range(SEQ_TP_ROWS)]
    out["tp8"] = seq_serve("yi6b_seq_tp8", model, card_mesh(dev, SEQ_TP_MESH), reqs, dev,
                           launches)
    log(f"[phase] 17a yi-6b (1, 8) {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    reqs = [Request(rng.integers(0, cfg.vocab_size, SEQ_DATA_PROMPT).tolist(), SEQ_NEW_TOKENS)]
    out["data"] = seq_serve("yi6b_seq_data", model, card_mesh(dev, SEQ_DATA_MESH), reqs, dev,
                            launches, replicate=True)
    log(f"[phase] 17b yi-6b (2, 4) one row {time.perf_counter() - t0:.3f} s")
    del model
    torch.cuda.empty_cache()
    return out


def phase17_examples(tmp):
    """(c) The five ``examples/*_torch.py`` on the card (their default
    device) as subprocesses, at most two at once; every process ended
    before this returns.  -> name -> (seconds, exit code, last line)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    queue = [(name, ["--ckpt-dir", str(tmp / "train_lm")] if name == "train_lm" else [])
             for name in EXAMPLES]
    running, done = {}, {}
    try:
        while queue or running:
            while queue and len(running) < 2:
                name, extra = queue.pop(0)
                out = open(tmp / f"{name}.out", "w+")
                err = open(tmp / f"{name}.err", "w+")
                proc = subprocess.Popen(
                    [sys.executable, os.path.join(root, "examples", f"{name}_torch.py"), *extra],
                    stdout=out, stderr=err, env=env, cwd=root, text=True)
                running[name] = (proc, out, err, time.perf_counter())
            time.sleep(0.2)
            for name, (proc, out, err, t0) in list(running.items()):
                late = time.perf_counter() - t0 > EXAMPLE_TIMEOUT
                if proc.poll() is None and not late:
                    continue
                if late and proc.poll() is None:
                    proc.kill()
                    proc.wait()
                out.seek(0)
                err.seek(0)
                text, etext = out.read(), err.read()
                out.close()
                err.close()
                del running[name]
                lines = text.strip().splitlines()
                done[name] = dict(seconds=time.perf_counter() - t0, exit_code=proc.returncode,
                                  last_line=lines[-1][:300] if lines else "")
                log(f"[examples] {name}_torch.py: {json.dumps(done[name])}")
                if proc.returncode != 0:
                    raise AssertionError(f"examples/{name}_torch.py exited {proc.returncode}:\n"
                                         f"{text[-2000:]}\n{etext[-3000:]}")
    finally:
        for proc, out, err, _ in running.values():
            proc.kill()
            proc.wait()
            out.close()
            err.close()
    return done


def phase17(dev, launches):
    """(a), (b), then flash at the positions' new shapes, then (c)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    torch.cuda.empty_cache()
    out = phase17_serve(dev, launches)
    timings, err = [], 0.0
    bf = torch.bfloat16
    for i, (label, b, s, h, kv) in enumerate([
            ("yi-6b (1, 8) position B=4 S=T=2048 H=4 KV=4 (repeated)", 4, 2048, 4, 4),
            ("yi-6b (2, 4) position B=1 S=T=8192 H=8 KV=1", 1, 8192, 8, 1)]):
        q, k, v = attn_inputs(b, s, s, h, kv, 128, bf, dev, seed=170 + i)
        e, row = flash_errors(flash_attention_cuda(q, k, v, causal=True),
                              ref.flash_attention(q, k, v, causal=True), bf)
        err = max(err, e)
        log(f"[flash] {label} bf16: max abs err {e:.3e}, max row err {row:.3e}")
        timings.append(time_flash(q, k, v, label))
        del q, k, v
    torch.cuda.empty_cache()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_examples_"))
    t0 = time.perf_counter()
    try:
        out["examples"] = phase17_examples(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[phase] 17c examples {time.perf_counter() - t0:.3f} s")
    return out, timings, err


def main():
    t_start = time.perf_counter()
    smi = phase0()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sass, base = phase1()

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[phase] {name} {time.perf_counter() - t0:.3f} s")
        return out

    count_err, mi_err = phase("2 contingency+mi", phase2, dev)
    plan_paths = dict(contingency=phase("2 contingency plan paths", contingency_paths, dev),
                      bin_codes=phase("2 bin_codes plan paths", bin_codes_paths, dev))
    code_times = phase("2 contingency int32 codes", phase2_codes, dev)
    bins_err, bin_times = phase("2 bin_codes", phase2_bins, dev)
    corr_err, corr_times = phase("2 pearson_corr", phase2_pearson, dev)
    flash_err, flash_times = phase("2 flash_attention", phase2_flash, dev)
    launches: dict = {}
    timings: list = []
    keep: dict = {}
    fits = phase("3 tall", phase3, dev, launches, timings, keep)
    fits += phase("4 wide", phase4, dev, launches, timings, keep)
    gen = torch.Generator(device=dev).manual_seed(4)
    Xc = (torch.rand((65536, 1000), generator=gen, device=dev) < 0.5).to(torch.int8)
    timings.append(time_conditional(Xc, Xc[:, 3].clone(), Xc[:, 5].to(torch.int32),
                                    "65536x1000 int8 VC=4 (conditional)"))
    del Xc
    fits += phase("5 tall binned", phase5, dev, launches, keep)
    fits += phase("6 wide pearson", phase6, dev, launches, keep)
    serves, serve_check = phase("7 yi-6b serve", phase7, dev, launches)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_ooc_"))
    try:
        ooc, spilled_code_times = phase("8 out-of-core", phase8, dev, launches, fits, keep, tmp)
        code_times += spilled_code_times
        mh, mh_times = phase("9 multi-host", phase9, dev, launches, fits, keep, tmp)
        timings += mh_times
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if tmp.exists():
        raise AssertionError(f"phases 8 and 9 left {tmp} behind")
    mesh_fits, mesh_times, mesh_bin_times = phase("10 device mesh", phase10, dev, launches,
                                                  fits, keep)
    del keep  # phase 10 was its last reader; phase 14 needs ~60 GB of the card
    torch.cuda.empty_cache()
    families, family_check = phase("11 other LM families", phase11, dev, launches)
    training = phase("12 training", phase12, dev, launches)
    mp_serves, mp_check, mp_flash_times, mp_flash_err = phase(
        "13 model parallelism", phase13, dev, launches, serve_check["bf16_vs_f32_err"])
    mesh_training = phase("14 training on a model mesh", phase14, dev, launches)
    mesh_families, fam_flash_times, fam_flash_err = phase(
        "15 the other families on a model mesh", phase15, dev, launches)
    dryrun_check = phase("16 the dry run's accounting", phase16, dev, launches, smi)
    seq_caches, seq_flash_times, seq_flash_err = phase("17 the meshed caches in JAX's layout",
                                                       phase17, dev, launches)
    training["cli"] = mesh_families["cli"].pop("train_cli")
    mesh_training["cli"] = mesh_families["cli"].pop("mesh_train_cli")
    flash_times += mp_flash_times + fam_flash_times + seq_flash_times
    flash_err = max(flash_err, mp_flash_err, fam_flash_err, seq_flash_err)
    timings += mesh_times
    bin_times += mesh_bin_times
    bins_err = max([bins_err] + [r["max_abs_err"] for r in mesh_bin_times])
    rng = np.random.default_rng(1)

    def tables(*shape):
        return torch.as_tensor(rng.integers(0, 30000, shape)).to(torch.int32).to(dev)

    mi_block = tables(1000, 2, 2)
    mi_times = [time_mi(t, label, base, MI_TALLY) for t, label in [
        (mi_block, "1000x2x2 (tall pass)"),
        (mi_block.repeat(50, 1, 1), "50000x2x2 (wide pass)"),
        (tables(1000, 16, 2), "1000x16x2 (binned relevance)"),
        (tables(1000, 16, 16), "1000x16x16 (binned redundancy)"),
        (tables(1000, 2, 2, 2).movedim(-1, -3),
         "class-major view of a 1000x2x2x2 stack (jmi/cmim redundancy)"),
        (tables(20001, 2, 2), "20001x2x2 (2-D jmi marginal, phase 9)"),
        (tables(12500, 2, 2), "12500x2x2 (a (4,) model shard's pass, phase 10)"),
        (tables(20000, 2, 2), "20000x2x2 (a (2, 2) grid's feature group, jmi marginal, phase 10)"),
        (tables(20000, 2, 2, 2).movedim(-1, -3),
         "class-major view of a 20000x2x2x2 stack (the grid's jmi redundancy, phase 10)"),
        (tables(20001, 2, 2, 2).movedim(-1, -3),
         "class-major view of a 20001x2x2x2 stack (2-D jmi redundancy, phase 9)"),
        (tables(279, 1, 2, 2), "279x1x2x2 (custom relevance chunk)"),
        (tables(279, 5, 2, 2), "279x5x2x2 (custom redundancy chunk)")]]
    log(f"[mi] main-path launches by table shape: {json.dumps({str(k): n for k, n in MI_TALLY.items()})}")

    mi_err = max([mi_err] + [r["max_abs_err"] for r in mi_times])
    mi_paths = ("tall_conventional", "tall_streaming", "wide_alternative",
                "tall_binned_streaming", "tall_binned_in_memory", *OOC_PATHS, *MH_PATHS,
                *MESH_PATHS)
    kernels = [
        # the streaming block: the shape launched most often
        kernel_entry("contingency_tables", "src/repro_torch/csrc/contingency.cu",
                     "src/repro/kernels/contingency.py:59", mi_paths, launches,
                     count_err, timings[1], timings + code_times),
        kernel_entry("mi_scores", "src/repro_torch/csrc/mi_score.cu",
                     "src/repro/kernels/mi_score.py:40", mi_paths, launches,
                     mi_err, mi_times[0], mi_times),
        kernel_entry("bin_codes", "src/repro_torch/csrc/bin_codes.cu",
                     "src/repro/kernels/binning.py:45",
                     ("tall_binned_streaming", "tall_binned_in_memory", "mesh_binned_streaming"),
                     launches,
                     bins_err, bin_times[0], bin_times),
        kernel_entry("pearson_corr", "src/repro_torch/csrc/pearson.cu",
                     "src/repro/kernels/pearson.py:57", ("wide_pearson", "mesh_pearson"), launches,
                     corr_err, corr_times[0], corr_times),
        kernel_entry("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:79",
                     ("yi6b_serve", *FAMILY_PATHS, *MP_PATHS, *FAMILY_MESH_PATHS,
                      "dryrun_yi_tp", *SEQ_PATHS),
                     launches,
                     flash_err, flash_times[0], flash_times),
    ]
    for k in kernels:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} was never launched on a main path")
        idle = [p for p, n in k["launches_by_path"].items() if n == 0]
        if k["name"] == "flash_attention" and idle:
            raise AssertionError(f"flash attention never launched on {idle}")
    log(json.dumps(dict(fits=fits, serves=serves, serve_check=serve_check, sass=sass,
                        plan_paths=plan_paths, out_of_core=ooc, multi_host=mh,
                        device_mesh=mesh_fits, families=families,
                        family_check=family_check, training=training,
                        model_parallel=mp_serves, model_parallel_check=mp_check,
                        mesh_training=mesh_training, mesh_families=mesh_families,
                        dryrun_check=dryrun_check, seq_caches=seq_caches)))
    log(f"[total] {time.perf_counter() - t_start:.3f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
