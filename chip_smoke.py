#!/usr/bin/env python3
"""Quickest proof that the PyTorch + CUDA port (src/repro_torch) runs on the card.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phase 0  builds every CUDA kernel under src/repro_torch/kernels/csrc from
         the checkout (one nvcc per source, all started together) and
         prints ptxas's register, shared-memory and spill lines for each
         kernel entry (each template instance) of each source.
Phase 1  holds the paged-attention kernel against its plain PyTorch version:
         the tests/test_paged.py sweep with a particle axis of 2 and NaN in
         every stale slot, then three shapes, each with fp32 and bf16
         pages and NaN in stale and unowned slots, all within 1e-4 (the
         two sides widen the same bf16 values and accumulate in fp32): the
         qwen1.5-0.5b serving shape (P=4, the 8 rows of the smoke
         traffic), the speculative draft's call (a one-particle view of
         that pool, as spec_draft_step takes it) and a long context (8
         rows at 1789-2048 tokens in a pool of their own). At each it
         times the kernel with the L2 flushed before each call (event ms)
         and with the profiler (device ms, L2 warm) at its default kv
         heads a block and at one and four, the plain version, and one
         scaled_dot_product_attention call on K/V gathered beforehand
         (library_ms, a yardstick the port never calls), beside the bound;
         at the serving and draft shapes also with the split count forced
         to 1 and to 8 (split_probe: what the plan's grid rule rests on).
Phase 2  drives serve_decode over P=4 full-width qwen1.5-0.5b particles
         (24 layers, random weights from seed 0) with 8 mixed-length
         requests (prompts of 16-128 tokens, max_new 16-64), twice: with
         every step captured as a CUDA graph and replayed (a fresh
         runtime.ProgramCache; warmup captures the decode step and each
         prompt's pow2 prefill bucket), then through an explicitly passed
         eager cache (ProgramCache(capturer=runtime.eager)). In each run
         every request must finish with finite heads, the pool must drain,
         no step may be captured after warmup, and the paged kernel must
         launch 24 times per decode step and the prefill kernel 24 times
         per prefill (a replay adds the launches its capture recorded).
         The captured run's counts must equal the eager run's (each of
         those a host launch), and its tokens the eager run's up to a
         near-tie (the rule of phase 6). Then one decode step on freshly
         prefilled rows runs through the kernel and through the plain
         version; their BMA mean probabilities must agree within 1e-4 of
         the largest probability, their member logits within 1e-3; and
         that step is profiled as a captured program and as an eager one;
         over each profiled window the counters' launches must equal the
         kernel launches the profiler saw on the card (PROFILER_NAMES),
         as in the profiled steps of phases 6 and 7.

Phase 3  holds the four SVGD and SWAG kernels against their plain versions
         on the card: the tests/test_kernels.py sweeps, dense and masked
         with NaN in the dead rows (sqdist 1e-3 absolute, force 2e-4
         relative, moments and diag_std 1e-5; dead rows of phi exact
         zeros, dead SWAG rows unchanged; the streamed force also equal
         to the column kernel, the probe svgd_force_columns, bit for bit,
         at n = 1-16 and 256 besides), then the training shape of 8
         ViT-MNIST particles x 19,775,360 parameters (sqdist within 1e-5
         of its largest entry: distances there are ~1e5; the force also
         with g = 0, since its repulsive term is ~1e-6 of the driving
         term at this D and would otherwise go unseen). sqdist must give
         the same bits twice, an exactly symmetric output and an exact-zero
         diagonal at every case; its path (bulk copies or plain loads) is
         printed for each, and the training shape must take the bulk
         copies. Then it times each kernel, its plain version and, for
         sqdist, torch.cdist by default and by its cuBLAS Gram route
         (use_mm_for_euclid_dist; library_ms is the faster, and neither is
         called by the port) at the training shape with the L2 flushed
         before each call, and probes sqdist: device ms split between its
         two kernels, the first stage alone, the ring at 2 and 4 stages.
         The force at the training shape (trained-like g and g = 0)
         equals the column kernel's bit for bit, and both are timed in this
         call (force_vs_columns: event and device ms, shares of the bound).
         #3 runs one collection over the ViT's 18 leaves and over the
         UNet's 34 (8 rows, a dead one with NaN in its theta), through
         the one-launch kernel, the per-leaf kernel's loop and the plain
         version, each on its own copy of the state, bit for bit; each
         collection timed (event and device ms) against the per-leaf
         loop and the bound (collections; the ViT's is the kernels
         line's row). #4 (diag_std_leaves, one launch over every leaf)
         equals the per-leaf kernel bit for bit on the sweep's leaves and
         on a view one float past a 16-byte boundary, on the ViT's 18
         leaves at 8 rows and on them raveled into one (8, 19,775,360)
         leaf; the 18 leaves' one launch, the per-leaf loop and the
         raveled leaf timed (event and device ms; the kernels line's
         row).
Phase 4  trains 8 full-width ViT-MNIST particles (16 layers, random
         weights from seed 0, batches of 64 from the seeded loader, 8 per
         epoch): SteinVGD for 2 epochs with the median heuristic, then
         MultiSWAG with Adam for 3 epochs collecting after the first
         (max_rank 20). Each runs twice from the same init: with every
         train step and collection captured once as a CUDA graph and
         replayed (a fresh runtime.ProgramCache on the PD's runtime), then
         through an explicitly passed eager cache (ProgramCache(capturer=
         runtime.eager)), the captured PD released before the eager one is
         built. In each run: one program per spec (the SVGD step; the
         MultiSWAG step and collection), looked up once, each a graph in
         the captured run (no capture after the first step); finite losses
         and exact launch counts (one sqdist and one force per SVGD step,
         one moments launch per collection), counted through the
         replays. The captured run's losses and launch counts must equal
         the eager run's, and so must p_predict over 64 images (seed 1),
         bit for bit. After the captured runs: one SVGD force on the
         trained theta, g and mask through the kernels and the plain path
         within 2e-4 relative, with the trained g and with g = 0; one more
         SWAG collection of the trained state at the path's per-leaf
         shapes (its 20-slot ring, slots and mask) through the one-launch
         kernel, the per-leaf kernel and the plain version, each on
         its own copy of the state, within 1e-5 for mean', sq' and the
         ring and bit-equal to both; #4 at the handoff's 18 leaves (one
         launch, bit-equal to the per-leaf kernel, 1e-5 of the plain
         version); the MultiSWAG posterior predictive with 4 draws per
         particle (one diag_std launch over every leaf); and the
         predictive heads with kernel-made and plain-made diag_std within
         1e-5 given the same noise. Each run then profiles 3 steps of its
         own step program (and, for MultiSWAG, of its collection) on its
         trained state: host ms and images/s, device busy time, idle
         share, top kernels and the four kernels' share, with each
         program's capture seconds and graph pool bytes, and the phase's
         peak device memory.

Phase 8  trains the same 8 full-width ViT-MNIST particles (random weights
         from seed 0, batches of 64, 4 per epoch: P8_NB, half of phase
         4's, for the script's time) with backend="nel", the
         default: the executor, the NEL on cuda:0 (num_devices=1) and
         particle messaging. DeepEnsemble (Adam, 1 epoch: one step hop a
         particle a batch), SteinVGD (2 epochs, the median heuristic: the
         paper's leader protocol, whose dense force over the gathered
         (8, 19,775,360) matrices launches sqdist and the force once a
         step) and MultiSWAG (Adam, 3 epochs, max_rank 20, collecting
         after the first: SWAG_COLLECT on one-row views, one moments
         launch per particle). Every NEL run and wait is joined
         within NEL_T seconds (a deadlock fails the phase). Checks: one NEL
         step against one captured compiled step from the same init and
         batch, params within 1e-4 (DeepEnsemble with sgd(0.05), and
         SteinVGD) and the NEL's grads within 1e-4 of one batched
         backward's (also for DeepEnsemble's Adam step, whose params
         are held within 1e-4 where |g| > G_HOLD = 1e-6, 100 eps: Adam's
         first update is about sign(g), so an entry with |g| near eps may
         move by up to 2 lr on one path and not the other; those entries
         are counted and printed); one NEL
         collection against the fused collection on the same state,
         moments and ring within 1e-5, equal ranks and counts; finite
         losses; NelRuntime.predict against CompiledRuntime.predict on
         each trained store within 1e-5; the leader's force at its shape
         (trained g and g = 0) against the plain versions within 2e-4
         relative; exact launch counts (16 sqdist and 16 force launches,
         2 x 8 moments launches, nothing else), and over profiled
         windows of two NEL steps (and two collections) the counters
         equal to the profiler's kernel counts (each window opens with
         32 spin kernels: the profiler misses the first kernel records
         after it starts, which matters where a window's first launches
         are counted ones, as a collection's are; profiler_start_probe
         shows it and prints it); the executor's dispatched
         and completed equal to the messages the protocols send, nothing
         in flight after a drain, a fixed thread count and every worker
         joined at cleanup. It prints, per algorithm, host and device
         busy ms per step with the idle share, images/s, the executor's
         wait and run time, queue depth and pool dispatches, the NEL's
         dispatches and cross-device transfers, and the peak device
         memory, beside the captured compiled step (DeepEnsemble and
         SteinVGD profiled here on the parity PDs; SteinVGD and MultiSWAG
         also as phase 4 measured them).

Phase 5  holds the three attention kernels of the LM's other serving paths
         against their plain versions on the card: the speculative verify
         window (the tests/test_speculative.py shapes plus the serving
         heads, NaN past every window and in unowned pages, fp32 and bf16
         pages, 1e-4; at W = 1 the same bits as the single-token kernel,
         max abs err 0, fp32 and bf16), the prefill (the
         tests/test_kernels.py flash sweep, 2e-5, and bf16, 2e-2) and the
         dense-cache decode (the decode and ragged-tail sweeps with NaN in
         empty slots, 2e-5; rows with every slot empty exact zeros), then
         each at its serving shape, the dense
         decode also at C = 2048 slots, all filled. It times each kernel,
         its plain version and one SDPA call (library_ms: is_causal for
         the prefill, a boolean mask over gathered or dense K/V for the
         other two) with the L2 flushed, the prefill also at P=4 x 4096
         tokens and the window also at a long-context case (8 rows at
         ~2048 tokens in a pool of their own, where the split page walk
         matters more), with the device time from torch.profiler beside
         the event times, the dense decode at one, two and four kv heads
         a block, and the window and dense decode at their serving shapes
         with the split count forced to 1 and to 8.
Phase 6  drives serve_decode(speculative=4) over phase 2's 8 requests and
         P=4 particles, captured (warmup captures the draft at 1-4
         iterations, the verify and the prefill buckets) and then eager:
         every request finishes with finite heads, the pool drains to 0
         pages, nothing is captured after warmup, and the launch counts
         are exact (window kernel 24 per verify, paged kernel 24 per draft
         iteration, prefill kernel 24 per prefill). Each request's tokens
         must equal phase 2's, and the captured run's the eager run's;
         where they first differ, the BMA top-2 gap there must be under
         1e-4 of the top probability (a near-tie that GEMMs of another
         shape may break the other way). It prints the speculative stats,
         tokens/s and latency of both runs and profiled windows of 3
         verify steps and 3 four-iteration drafts, captured and eager,
         then runs a short captured pass in which all 4 particles share
         one weight set (acceptance ~1: full windows, no rollback).
Phase 7  serves 8 prompts of 64 tokens (seed 2) through
         PredictiveEngine(stateful=True) over api.prefill /
         api.decode_step, 32 tokens each, captured (the first step
         captures, the other 31 replay) and then eager: 24 dense-decode
         launches per step and 24 prefill launches in each run, one
         program and no capture after the first step, every step's heads
         unchanged by the later replays,
         the tokens of serve_decode on the same prompts and of the eager
         run under the same tie rule, and one step's layer-0 attention
         through the kernel and the plain version within 2e-5. A captured
         step at cur_pos = the cache length must raise ValueError on the
         host, and the card must go on stepping after it.

Phase 9  the particle lifecycle (p_clone / p_kill / bdl.lifecycle) with
         every step captured. It first holds #5, #7 and #8 against their
         plain versions at its shapes (the prefill at P = 4 over a
         128-token bucket, the paged decode at P = 4 and through the
         one-particle view at slot 1, the draft slot re-picked after slot
         0's kill, the verify window W = 5). Serving: qwen1.5-0.5b at full
         width and depth in a store of capacity 4 with 3 live particles
         (seed 0), phase 2's first 4 requests per round, plain and then
         speculative (k_max 4; warmup captures the draft at every slot and
         iteration count): a round; a jittered clone under step_lock (4
         live) and a round; the twin's kill and a round, whose tokens and
         logprobs must equal the first round's exactly; speculative: the
         drafting particle's kill and a round. Nothing may be captured
         after warmup, generation() must not move, the pool must drain,
         the launch counts are exact and every program is a graph. It
         prints the host ms of each p_clone and p_kill, the clone's copies
         alone (params and the KV pool's row: event ms with the L2
         flushed, device ms) beside their byte bound, slot_uploads and the
         draft programs' pool bytes and capture seconds. Training: 8
         full-width ViT-MNIST particles in a store of capacity 8 (seed 0,
         batches of 64, 2 per epoch), SteinVGD (median heuristic) and
         MultiSWAG (Adam, rank 20), each captured: after one epoch, two
         kills (slots 1, 5) and a jittered clone (into slot 1), the fused
         run over the 7 live captures nothing, slot 5's params, optimizer
         state and SWAG state stay bit for bit and its loss is 0; #1 and #2
         at the churned (8, 19,775,360) state with its mask and #3 and #4
         at the churned moments against their plain versions (sqdist 1e-5
         of its largest entry, the force 2e-4 relative with seeded g and
         g = 0, dead rows exact zeros; moments and diag_std 1e-5); one
         backend="nel" leader step over the 7 (#1 and #2 at n = 7) against
         the captured step from the same params within 1e-4; the
         MultiSWAG predictive over the 7 live rows (store.dense, one
         diag_std launch, its leaves first held bit-equal to the per-leaf
         kernel); then resample (jitter 0.01), prune to 6 and
         grow by 2 with Adam: live counts 7, 6, 8, no capacity growth, no
         generation bump, and a last fused epoch over the 8 captures
         nothing. Each kernel's ``lifecycle_launches`` in the kernels line
         are phase 9's, summed over its driven runs (each between a reset
         and a read of the counts), and each kernel of its path must have
         launched.

Phase 10 predictive serving: 8 full-width ViT-MNIST particles trained
         with MultiSWAG (Adam, rank 20, 3 epochs of 2 batches, collecting
         after the first; phase 4's trained store is released by then),
         then posterior_predictive(samples_per_particle=4, max_batch=32,
         max_wait_ms=2): 32 sampled members (a 2.53 GB static tree), the
         BMA program captured at buckets 1-32 from one example request
         before serve() returns (the batcher's worker replays it). 256 single-example requests from 8
         client threads (predict_async), then 256 from one thread
         (predict, a closed loop: one row a flush), and the concurrent
         run again through an eager cache (ProgramCache(capturer=
         runtime.eager)) on the same tree. Checks: every served head
         within 1e-5 of the same row of one predict_batch over all 256;
         no capture after warmup, every program a graph; one
         host-to-device copy per flush (the request's one leaf); no
         error, the queue drained; #4 bit-equal to the per-leaf kernel
         and against its plain version at the (8, leaf) stacks and at
         P = 1, every leaf (1e-5), its launches exact (1 for the handoff,
         8 for sample_predict over 8 images at S = 2: one a particle,
         which must equal a loop of plain draws and forwards on the same
         noise within 1e-5); then serve() over the
         particles' own params with a p_kill under traffic: the 7 live
         rows' BMA, no capture, generation() unchanged; and F1:
         after a p_create into the killed slot, store.dense("swag")
         raises KeyError. It prints requests/s, latency p50 / p95 / p99
         and the flush mix of each run, occupancy and padded rows, host
         and device busy ms per flush at buckets 1 and 32 with the idle
         share (profiled windows opened with spins) beside the byte and
         operation bounds, capture seconds and pool bytes per bucket,
         #4's event and device ms at P = 1 (one launch and the per-leaf
         loop) and the peak device memory.
         Each kernel's ``serve_launches`` in the kernels line are phase
         10's driven runs (the training, the handoff, sample_predict).

Phase 11 the precision ladder (core.precision), every step captured.
         (a) qwen1.5-0.5b at full width and depth, 4 particles (seed 0)
         in a "mixed" store of capacity 4: fp32 masters, a bf16 serve
         copy rewritten in place by the serve_cast program, fp32
         arithmetic (the config's dtype). Phase 2's requests served plain,
         speculative with the fp32 draft and with the int8 draft
         (SpecConfig(quantized=True)), in one call; launches as phases 2
         and 6; each speculative run's tokens, and a dense-cache decode's
         (PredictiveEngine(stateful=True), 8 steps over phase 7's prompts)
         against plain decode, under phase 6's near-tie rule; #5-#8 against
         their plain versions on the layer-0 inputs of a freshly prefilled
         step (phases 1 and 5's fp32 tolerances); then rounds of phase 2's
         first 4 requests on the int8-draft service around a p_kill, a
         jittered p_clone into the freed slot (whose serve-copy row must
         be the bf16 cast of its master, bit for bit) and the twin's kill:
         nothing captured after warmup, the served params at fixed
         addresses, the copy at half the masters' bytes; then the
         drafter's kill: the draft moves to the next live slot, one pack
         is built, and the draft row equals the bf16 dequantization of that
         slot's int8 pack bit for bit. Last, 4 particles on one weight set
         served with the int8 draft (phase 2's prompts, 16 tokens each):
         verify corrects any draft, so only the acceptance shows a draft
         of garbage; it must reach ACCEPT_INT8. It prints tokens/s
         of the three runs, profiled windows of a plain step and of the
         fp32 and the int8 draft (4 iterations; device ms per iteration),
         the serve_cast program's ms against its byte bound, draft_packs,
         the draft programs' pool bytes and the peak memory.
         (b) the same model with cfg.replace(dtype="bfloat16") in a "bf16"
         store (capacity 4, 3 live): bf16 masters and pages, so #5-#8
         take bf16 q. Plain and speculative serving and the dense-cache
         steps as in (a), tokens under a near-tie bar of BF16_TIE; #5-#8
         against their plain versions at one freshly prefilled step
         (BF16_TOL, phase 5's bf16 bar) and timed there (event ms with the
         L2 flushed, device ms, plain ms, SDPA at the same bf16 shapes, the
         byte bound: the kernels line's ``bf16`` rows); a clone/kill round
         trip that must give the same tokens back.
         (c) 8 full-width ViT-MNIST particles, phase 4's epochs and
         batches, captured: SteinVGD under "mixed" (fp32 masters) and
         MultiSWAG under "bf16" masters (bf16 params and Adam state, fp32
         moments, a bf16 ring). Losses within the reference's bar of phase
         4's fp32 losses (|d| < 0.1 |fp32| + 0.05), launches of #1-#3 as
         phase 4, one program per spec; the force at the trained state and
         one collection (through the fp32 working copies) against the plain
         versions; images/s beside phase 4's.
         (d) phase 10's MultiSWAG posterior (32 members, trained anew the
         same way) served under "mixed" and "mixed_int8": the burst and
         the closed loop, one copy a flush, nothing captured after
         warmup, served heads within BF16_SERVED_TOL of predict_batch
         (a bucket's bf16 GEMMs round otherwise than the batch's; fp32
         holds 1e-5 in phase 10), BMA means within 0.03 and 0.06 of the
         fp32 service's; flush profiles at
         buckets 1 and 32 against bf16 bounds, beside phase 10's fp32
         figures; then the store's own params under "mixed_int8" (its
         int8 serve copy) with a p_kill under traffic: no capture, the copy
         at fixed addresses, one serve_cast program.
         Each part prints its line with the card's name and power limit;
         every kernel must have launched in phase 11, and each kernel's
         ``precision_launches`` in the kernels line are phase 11's.

Phase 12 the paper's SciML workload and its Fig. 4 baselines
         (configs/unet_advection.py, models/unet1d.py, bdl/baselines.py),
         with TF32 off as everywhere. (a) 8 full-width UNet-advection
         particles (d_model 32, depth 4: 1,240,065 parameters in 34
         leaves; random weights from seed 0), the paper's batch of 50 on
         a 128-point grid, 8 batches an epoch: DeepEnsemble (Adam, 2
         epochs), SteinVGD (the median heuristic, lr 0.05, 2 epochs) and
         MultiSWAG (Adam, 3 epochs collecting after the first, rank 20),
         each captured, then eager (an explicit eager cache), then with
         backend="nel". Checks: one program per spec, each a graph in the
         captured run; the captured run's losses and launches equal the
         eager run's; the loss on the first batch falls below the init's;
         the NEL runs' launches exact (16 sqdist and 16 force launches,
         2 x 8 moments launches); one NEL step (and, for MultiSWAG,
         one collection) within 1e-4 of one captured step from the same
         init (sgd(0.05) for DeepEnsemble and MultiSWAG); at the trained
         state #1 on its plain-load path (D is odd) within 1e-5 of the
         largest distance, #2 within 2e-4 relative (trained g and g = 0)
         and equal to the column kernel's bit for bit, and one collection
         of #3 within 1e-5 (one launch, bit-equal to the per-leaf kernel
         and the plain version), each timed beside its bound (#2 beside
         the column kernel, #3 beside the per-leaf loop), and the captured
         collection's device ms. It prints each captured step's host and
         device busy ms,
         idle share and samples/s against the step's fp32 operation bound
         (3 x 58.2 MFLOP x 400 samples at 67 TFLOP/s), the peak memory,
         and the forward + backward ms of the package's conv form (im2col
         and one batched GEMM a conv) and of grouped conv1d (cuDNN, with
         its autotuner off and on), the two forms held within 1e-4.
         (b) the captured MultiSWAG posterior, 4 draws a particle (32
         members), served with kind="regress" to phase 10's traffic of
         single-example u0 (128, 1) requests (8-thread burst, then a
         closed loop): buckets 1-32 captured before serve() returns and
         nothing after; served heads within 1e-5 of predict_batch's, the
         mean and variance within 1e-5 of the members' computed on the
         host; #4 one launch at the handoff and one a particle in
         sample_predict (8 draws, held to a loop of plain draws within
         1e-5), bit-equal to the per-leaf kernel and against its plain
         version at the (8, leaf) stacks and at P = 1, each shape timed
         beside the per-leaf loop; then the store's own params with a
         p_kill under traffic: the 7 live rows' mean, no capture. It
         prints requests/s, latency p50 / p95 / p99 and the flush
         profiles at buckets 1 and 32 against their bounds. (c) the Fig. 4 rows: ms per epoch (the
         last epoch of two, or part (a)'s) and samples/s of ensemble,
         multiswag and svgd under captured, nel and baseline
         (bdl.baselines: sequential NNs, one captured program a NN, the
         programs and pool bytes read as the last epoch starts), for the
         UNet at 2, 4 and 8 particles and for ViT-MNIST's baselines at
         phase 4's shape beside phase 4's captured and phase 8's NEL step
         times; and ensemble_baseline within 1e-5 of the fused
         DeepEnsemble from the same seed at full width (sgd(0.05), one
         epoch). Each part prints its line with the card's name and power
         limit; every SVGD and SWAG kernel must have launched, and each
         kernel's ``sciml_launches`` in the kernels line are phase 12's
         driven runs, its ``unet`` entry #1-#4 timed at the UNet's shapes.

Phase 13 LM training: 4 full-width qwen1.5-0.5b particles (6 of its
         24 layers, 232,684,544 parameters each, random
         weights from seed 0, TF32 off) fed one 2048-token lm_batch
         sequence a step by the seeded DataLoader, through
         ParticleModule(loss=api.loss_fn) (the chunked flash attention
         with its blockwise backward, the chunked cross-entropy).
         First, at one layer's shape (P 4, B 1,
         S 2048, 16 heads of 64), the chunked attention's forward and
         backward against full_attention's autograd within 1e-4 of the
         largest entry, and _chunked_ce's loss and grads against one
         unchunked cross-entropy of the same logits within 1e-5
         relative, each timed beside an SDPA forward + backward (a
         yardstick only) and its bound (the work the function needs:
         S(S+1)/2 causal entries a head, 6 FLOPs a MAC for the
         cross-entropy; what the code computes beside it as
         ``code_flops``). (a) DeepEnsemble with
         adam(warmup_cosine(3e-3, 2, 8)) through an eager cache for 2
         steps, then captured (backend="compiled") for 8 from the same
         init, a step a call (bayes_infer, then the fused epoch loop on
         the same particles): one capture, none after the first step;
         the captured losses and params after step 1 equal the eager
         run's bit for bit, the losses of step 2 too; no kernel launched;
         the schedule read back on the card at steps 1-8 within 1e-6 of
         numpy's formula. It prints tokens/s (P x B x S over a
         synchronised step's host ms), the step's host and device ms and
         idle share (a profiled window), peak memory, pool bytes and the
         step's FLOP bound at 67 TFLOP/s fp32 (the products and the
         causal attention a step needs; what the code computes, with
         the loss chunks' recompute and the masked blocks, beside it as
         ``code_bound_ms``).
         (b) step 1 again under remat_policy "nothing_saveable" and
         "dots_saveable", each captured: losses within 1e-5 of (a)'s
         first step, params within 1e-6 relative; peak memory, pool and
         device ms beside (a)'s. (c) adafactor(warmup_cosine(1e-2, 2,
         8)), made by make_optimizer from the config with
         optimizer="adafactor", captured, 4 steps: finite losses, one
         capture, the first update of the factored leaf units.attn.wq.w
         within 1e-5 (of its largest entry) of the formula in float64
         on the same grads; its state's bytes beside Adam's. (d) SteinVGD (the median heuristic, lr
         1e-3), captured, 4 steps: #1 and #2 once a step at (4,
         463,987,712), #1 on its bulk-copy path, the counters equal to
         the profiler's over a profiled window; each kernel against its
         plain version on the trained state (sqdist 1e-5 of its largest
         entry, against the plain version in fp64: the fp32 Gram form
         sums 463,987,712 products an entry; the force 2e-4 relative,
         and bit-equal to the column kernel's), timed beside its bound
         and the column kernel. (e)
         DeepEnsemble on the NEL (backend="nel"), Adam, 2 steps: step
         1's losses within 1e-5 of (a)'s; a profiled NEL step's host and
         device ms and idle share. Each part prints its line with the
         card's name and power limit; each kernel's
         ``lm_training_launches`` in the kernels line are phase 13's
         driven runs, and #1 and #2 carry their ``lm`` rows. Part (a)
         also holds the captured step's FLOPs as obs counts them on its
         first run (``Program.cost()``) within 3% of ``code_flops``.

Phase 14 checkpoints and obs. (a) 4 full-width qwen1.5-0.5b particles
         (seed 0, built as phase 2's: 7,423,803,392 bytes of params)
         saved by checkpoint.save_store into a temporary directory under
         build/ and restored by restore_store: every leaf of the file
         equal to the store's bytes, the restored store equal bit for
         bit; phase 2's requests served from the restored store by
         serve_decode under a fresh captured cache give phase 2's
         captured tokens and logprobs bit for bit, and one decode step on
         freshly prefilled rows (decode_parity's setup) the same BMA heads
         from both stores. (b) the UNet-advection MultiSWAG store of
         phase 12 (8 particles, rank 20), trained anew and captured,
         saved and restored: every key bit for bit and the regression BMA
         of PredictiveEngine(kind="regress") equal; then a captured
         DeepEnsemble's {"params", "opt"} saved by checkpoint.save after 3
         steps and restored (restore(like=)) into a fresh PD's store by
         commit: one more step gives the losses, params and optimizer
         state of the run that never stopped, bit for bit. Each save and
         restore prints the file bytes and seconds, the device-to-host
         and host-to-device part apart (the store.d2h / store.h2d spans).
         (c) phase 2's load served from the LM PD's store through the
         process cache, warm, untraced and traced by turns (two each):
         the same tokens, the best traced tokens/s at least 0.95 x the
         best untraced; a captured UNet DeepEnsemble epoch and a
         regression service traced; then pd.obs(): the snapshot's keys,
         devices[0] a "gpu" whose bytes_in_use equals
         torch.cuda.memory_allocated() read just after, the store's
         params 7,423,803,392 bytes, a cost for every program, the
         decode step's counted FLOPs within 2% of 2 x its products'
         parameters x 4 particles x 8 rows (its first run is the warm-up
         with every row masked, so #7 adds 0), the Perfetto dump's JSON
         holding each category (executor, store, runtime, serve, decode,
         bdl) and a program.<name> span for every program looked up while
         traced, and Prometheus text with repro_program_cache_hits that
         parses line by line. Each kernel's ``ckpt_obs_launches`` in the
         kernels line are phase 14's driven runs; #5, #7 and #3 must have
         launched.

Phase 15 particles across GPUs: the store's particle axis on a data mesh
         of 4 positions (real GPUs where there are 4, else 4 positions of
         cuda:0) and the NEL with host offload. (a) 8 full-width ViT-MNIST
         particles, 2 a position, trained captured by DeepEnsemble (sgd
         at P15_LR, 2 epochs), SteinVGD and MultiSWAG (phase 4's, Adam)
         at phase 4's seed, loader and batches, each once on one device
         and once on the mesh (DeepEnsemble and SteinVGD also on a mesh
         of one position, the mesh path with nothing split): losses
         within HOLD (1e-4) and params within HOLD, MultiSWAG's where
         the first step's |g| > G_HOLD (1e-5; fewer than 5% of the
         entries under it: Adam's first update is lr * sign(g)) and its
         SWAG mean, sq_mean and written deviation rows held there too;
         every particle moved by at least 5 HOLD; bit equality printed;
         the one-device SteinVGD and MultiSWAG losses equal to phase 4's
         captured ones; the last epoch's images/s of every run; zero
         stacks / unstacks / device_puts / checkouts inside the epoch
         loop (read when the loop takes its first and last batch); one
         capture per position per step kind (SVGD: grads and update at
         each position, the force once), each a graph; 1/n of the
         one-device per_device_bytes; exact launches (#1 and #2 once a
         step, #3 once a position a collection); #3 and #4 at a
         position's shapes on the trained state against their plain
         versions (1e-5), position 0's collection and scales timed. (b)
         phase 2's requests through serve_decode(placement=) over 4
         qwen1.5-0.5b particles (seed 0, capacity 4, one a position):
         tokens equal to phase 2's, logprobs within 1e-5, #7 and #5 4 x
         24 a step and a prefill; the same store moved to one position
         and then to one device (serve_decode reshards it), phase 2's
         tokens each time, tokens/s of each; #5-#8 at one particle
         against their plain versions, timed; then (a)'s MultiSWAG
         posterior of 32 members (4 draws a particle, sampled per
         position: #4 once a position) through
         serve(placement=).predict, 64 single-example requests, within
         1e-5 of the one-device posterior from the same generator; the
         store-backed BMA on the mesh with no store traffic per request
         and a second service over the same store and cache capturing
         nothing, then on the store moved to one position and to one
         device, ms a request each, heads within 1e-5 of the mesh's. (c)
         8 qwen1.5-0.5b particles (3 of 24 units, 8 x 0.777
         GB) trained by DeepEnsemble with sgd on the NEL with cache_size
         2, 2 steps
         of 256 tokens, with offload and without: losses and params bit
         for bit, the offloaded run's peak max_memory_allocated at least
         5 particles' params under the other's; swaps, the swaps' GB/s
         each way and seconds printed. (d) (a)'s DeepEnsemble mesh store
         through save_store, restored onto the mesh and onto mesh=None:
         params bit for bit. (e) with 2 or more CUDA devices, (a)-(c)
         again over the real devices; else a line says "multi_gpu": "not
         run: 1 device". Each kernel's ``placement_launches`` in the
         kernels line are (a)'s and (b)'s 4-position mesh runs.

Phase 17 the decoder-only model zoo at full width, depth cut (each part
         prints its cut), random fp32 weights from seed 0. (a)
         deepseek-moe-16b, the head attn_mlp layer + 2 of 27 attn_moe
         units (1.68 B parameters a particle), 2 particles: phase 2's
         load through serve_decode captured and eager (tokens equal up
         to the near-tie rule, no capture after warmup, #7 and #5 3 a
         step and a prefill), speculative (k_max 4; phase 6's launch
         rule), and phase 7's prompts through the dense-cache engine
         (tokens equal to serve_decode's up to a near-tie, #6 3 a step);
         one decode step's moe_apply (unit 0, every particle) within 1e-4
         of moe_ref's largest |y| with nothing dropped; each prefill
         bucket's dropped_frac; a profiled captured decode step with its
         Program.cost() FLOPs beside the routed tokens' expert FLOPs (C
         = 128 slots an expert) and the three expert products' event ms
         over the step's device ms; #5-#8 at its shapes (16 heads of
         128) against their plain versions. (b) the head + 1 unit, 2
         particles, one 512-token lm_batch sequence a step:
         DeepEnsemble (Adam) captured and eager for 4 steps, losses and
         params bit for bit, the aux values per particle, a profiled
         captured step; SteinVGD (the median) 2 steps, #1 and #2 once a
         step, then held against their plain versions at (2, D), #2 also
         against the column kernel bit for bit where the card has room
         for both outputs, and timed beside it. (c) qwen3-moe-235b-a22b,
         1 of 94 units, 1 particle: 4 of phase 2's prompts for 16 tokens on one
         device and on a 1 x 4 model mesh (cuda:0's positions, or 4
         GPUs): tokens equal up to a near-tie, per-device param bytes at
         most 0.3 of one device's; #8 at the verify shape (P 1, B 8, W
         5, 64 heads over 4 kv heads of 128: its rows split over blocks)
         against its plain version. (d) gemma3-4b, 1 unit + 4 tail
         local layers (10 of 34), 2 particles: 4 prompts of 1,237
         tokens, past the 1,024-token window, through the dense-cache
         engine, 32 steps captured and eager (tokens equal up to a
         near-tie, #5 once a prefill and #6 10 a step); every ring slot
         s holds the position p with p % 1024 == s; #6 on a ring and the
         global cache and #5 at hd 256 against their plain versions,
         timed. Each kernel's ``zoo_launches`` in the kernels line are
         (a)-(d)'s main-path runs; its ``zoo`` entry the rows at the
         zoo's shapes.

Phase 18 the recurrent families at full width, random fp32 weights from
         seed 0, 2 particles. (a) zamba2-1.2b at full depth (32 mamba
         layers and 6 occurrences of one shared attention block, 1.02 B
         parameters a particle): 4 prompts of 101 tokens (a prefill of
         100, which pads mamba's 64-step chunk) and 32 greedy BMA steps
         through the dense-state engine, captured and eager: tokens equal
         up to a near-tie, one cold compile of the step, #5 6 a prefill
         and #6 6 a step, #7 and #8 never; a prefill of the prompt and
         the first 31 generated tokens gives step 32's logits within
         1e-3 of the largest; #5 and #6 at the shared block's shapes (32
         heads of 64) against their plain versions, timed beside the
         bound and SDPA; a profiled captured step. (b) rwkv6-7b, 4 of 32
         layers: (a)'s traffic and checks with no kernel launched. (c)
         zamba2 (1 unit + the 2-layer tail) and rwkv6 (1 layer), one
         512-token lm_batch sequence a step: phase 17 (b)'s DeepEnsemble
         and SteinVGD (4 steps) runs and checks at their widths. Each
         kernel's ``recurrent_launches`` in the kernels line are
         (a)-(c)'s main-path runs; its ``recurrent`` entry the rows at
         these shapes.

Phase 19 the last two families at full width and depth, random fp32
         weights from seed 0, 2 particles, 4 prompts of 24 tokens and 32
         greedy BMA steps through the dense-cache engine, captured and
         eager. (a) whisper-medium (24 encoder and 24 decoder layers,
         811,358,208 parameters a particle) with stub frames (4, 1,500,
         1,024): tokens equal up to a near-tie, one cold compile of the
         step, #5 48 a prefill (24 bidirectional encoder layers, 24
         causal decoder self-attentions) and #6 48 a step (24 self, 24
         cross over the 1,500 frames), #7 and #8 never; one step on
         freshly prefilled rows through the kernels and through their
         plain versions (``plain_kernels``): BMA probabilities within
         1e-4 and member logits within 1e-3 of the largest (the
         reference ropes the cross-attention query in the prefill and
         not in decode, so no continuation holds). (b) paligemma-3b (18
         layers, 3,035,441,152) with 256 stub patches before the text:
         #5 18 a prefill under the prefix mask, #6 18 a step (8 heads
         over 1 of 256); a prefill of the prompt and the first 31
         generated tokens gives step 32's logits within 1e-3 of the
         largest. #5 at whisper's encoder and at paligemma's prefill, #6
         over the 1,500 cross slots and at paligemma's cache against
         their plain versions (2e-5), timed beside the bound and SDPA;
         a profiled captured step each. (c) whisper at 2 + 2 layers and
         paligemma at 1 of 18, one 256-token lm_batch sequence a step
         with its frames or patches: phase 17 (b)'s DeepEnsemble runs
         and checks, and whisper's SteinVGD (4 steps each). Each
         kernel's ``encdec_vlm_launches`` in the kernels line are
         (a)-(c)'s main-path runs; its ``encdec_vlm`` entry the rows at
         these shapes.

Phase 20 the launch tooling (``repro_torch.launch``) on the card. (a)
         ``launch.steps.build``'s five steps on a 1 x 1 mesh of cuda:0:
         qwen1.5-0.5b at full width and 2 of 24 units, P 2, 2
         microbatches, the InputShapes cut to S 64 and B 4, bf16 compute
         (the reference's launch config), real weights from seed 0; each
         run once and held: the train loss (Adam) against
         ``api.loss_fn`` on the same params and slices (1e-6 relative),
         SVGD's phi (the step at lr 1) against the plain #1 / #2 (2e-4
         relative), the MultiSWAG moments against the plain #3 bit for
         bit, the prefill and serve logits against the same steps
         through the plain kernels (``plain_kernels``, BF16_TOL); the
         serve step decodes at C - 1 over a cache prefilled with C - 1
         tokens, so #6 reads every slot; launches exactly #1 1, #2 1, #3
         1, #5 2, #6 2 and the rest 0 (a fake form counts none). Each
         step's event ms beside its largest roofline term. (b) each
         step counted on the card under ``obs.device.counting`` and the
         same step on fake tensors through ``launch.cost`` (the dry
         run's loop-aware count): FLOPs and bytes must be equal, or the
         phase names each aten op that differs. (c) one full-size
         dry-run row, qwen1.5-0.5b x decode_32k on the single mesh,
         with its roofline terms on the H100's published peaks, beside
         the card's name and power limit. Each kernel's
         ``launch_steps_launches`` in the kernels line are (a)'s runs.

Phase 21 the model axis for the four families and the shared q head,
         random fp32 weights from seed 0, 2 particles, on cuda:0's logical
         positions (or as many GPUs). (a) zamba2-1.2b at full width, 1 of
         6 units and the 2-layer tail (each position 32 of the 64 ssm
         heads and 16 of the shared block's 32 q heads), and rwkv6-7b, 2
         of 32 layers (32 of 64 heads a position), on 1 x 2: 4 prompts of 64
         tokens and 16 greedy BMA steps through the dense-state engine,
         captured and eager, against the same cut model on one device
         (the store's joined params) run first: tokens equal up to a
         near-tie, BMA probabilities within 1e-4 (phase 16's bar) while
         they agree, #5 and #6 twice (once a position) per attention
         layer a prefill and a step, the captured counts equal to the
         eager ones. (b) whisper-medium (2 + 2 layers, 1,500 stub frames)
         and paligemma-3b (2 of 18 layers, 256 stub patches): (a)'s
         traffic and holds. (c) gemma3-4b (1 unit of 6 layers) and
         paligemma-3b (2 layers) on 1 x 16, 8 q heads shared by 2
         positions each (the dry run's model axis): one prefill and 8
         steps, eager, tokens equal to one device's. (d) each family at
         (a)'s and (b)'s depth (paligemma at 1 of 18 layers: an Adam
         step at 2 peaks past 80 GB), one 256-token sequence a step: 2
         DeepEnsemble (Adam) steps on one device and on 1 x 2 from the
         same particles (losses within 1e-5 relative, params within 1e-4
         where the first step's |g| > G_HOLD), and 2 SteinVGD steps of
         zamba2 (params within 2e-4 of their largest; #1 and #2 once a
         position a step). (e) rwkv6-7b's decode step from
         ``launch.steps.build`` on a 1 x 2 mesh of cuda:0 counted on the
         card and on fake tensors of the same layout: FLOPs and bytes
         equal. (d) runs first, on the card the earlier phases left
         (paligemma's Adam step needs ~70 GB); the phase prints the GB
         left allocated before each part. Each kernel's
         ``model_axis_families_launches`` in the kernels line are (a)-(d)'s
         main-path runs (the captured ones in (a) and (b)).

The phases run in the order 0, 1, 5, 2, 6, 7, 3, 4, 8, 9, 10, 11, 12,
13, 14, 15, 16, 17, 18, 19, 20, 21: the kernel checks first, then the serving runs
over one set of particles, then training, fused and then on the NEL,
then the lifecycle, then predictive serving, then the precision ladder,
then the SciML workload and the baselines, then LM training, then
checkpoints and obs, then the particle axis across GPUs, then the model
axis, then the decoder-only model zoo, then the recurrent families,
then the encoder-decoder and the prefix-LM, then the launch tooling,
then the model axis for the recurrent, encoder-decoder and prefix-LM
families.
Each phase prints its wall seconds (``phase_s``, or ``wall_s`` by part).

Every launch count in the kernels line comes from a driven run (phase 2's
captured serving for the paged and prefill kernels, phase 6's for the
window kernel, phase 7's for the dense-decode kernel, phase 4's captured
SVGD and MultiSWAG runs and its predictive), with the counts set to 0
just before it and read just after; each count of a captured run must
equal the eager run's. Each kernel's ``nel_launches`` are phase 8's, read
the same way around its NEL runs, and its ``lifecycle_launches`` phase 9's.
Phases 2, 4, 6 and 7 print, for each run: host ms and device busy ms
per step with the idle share (the profiled windows), tokens/s (phase 4:
images/s), latency p50 / p95 (serving), the cache's hits, misses and
cold_compiles (captures), and each program's capture time and the bytes
its graph's pool reserved. A failed capture raises and fails its phase.

Output: one JSON object per line (phase results, then the kernels line), the
card's name and power limit as nvidia-smi prints them, and last
{"ok": true, "device": {...}}. Exits non-zero without that last line when
there is no CUDA device, when run outside a checkout of the repository, or
when any phase fails.
"""
import contextlib
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

SEED = 0
PARTICLES = 4
PAGE_SIZE = 16
NUM_PAGES = 256
MAX_ACTIVE = 8
N_REQUESTS = 8
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12        # H100 SXM dense TF32 on the tensor cores
SWEEP = [
    (2, 4, 2, 32, 16, 4, [47, 63]),
    (3, 8, 1, 16, 8, 6, [0, 33, 21]),
    (2, 4, 4, 8, 16, 3, [-1, 40]),
    (4, 6, 3, 64, 32, 2, [5, -1, 63, 31]),
]


KEEP = {}       # what a later phase holds against an earlier one's run


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg, code=1):
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def paged_case(torch, seed, P, B, H, KVH, hd, ps, n_pmax, NP, lens, dtype):
    """Random q/pages with the PagePool conventions; NaN in the tail slots
    of each row's last page and in every page no row owns."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((P, B, H, hd), np.float32))
    k = torch.from_numpy(rng.standard_normal((P, NP, ps, KVH, hd), np.float32))
    v = torch.from_numpy(rng.standard_normal((P, NP, ps, KVH, hd), np.float32))
    bt = np.zeros((B, n_pmax), np.int32)
    free = list(rng.permutation(NP))
    owned = set()
    for b, sl in enumerate(lens):
        if sl < 0:
            continue
        for i in range(sl // ps + 1):
            bt[b, i] = free.pop()
            owned.add(int(bt[b, i]))
        last = bt[b, sl // ps]
        k[:, last, sl % ps + 1:] = float("nan")
        v[:, last, sl % ps + 1:] = float("nan")
    dead = sorted(set(range(NP)) - owned)
    k[:, dead] = float("nan")
    v[:, dead] = float("nan")
    dev = torch.device("cuda")
    return (q.to(dev), k.to(dev, dtype), v.to(dev, dtype),
            torch.from_numpy(bt).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


def check_kernel(torch, kernel, ref, args, lens, tol, what):
    out = kernel(*args)
    torch.cuda.synchronize()
    want = ref(*args)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{what}: non-finite output (NaN leaked)")
    err = float((out.float() - want.float()).abs().max())
    if not err < tol:
        raise AssertionError(f"{what}: max abs err {err} >= {tol}")
    for b, L in enumerate(lens):
        if L < 0 and float(out[:, b].abs().max()) != 0.0:
            raise AssertionError(f"{what}: inactive row {b} is not zero")
    return err


def time_ms(torch, fn, iters=30):
    """Median device time of one call, with the 50 MB L2 flushed before
    each call (a decode step streams other layers' weights in between).
    The card zeroes the 256 MB flush buffer four times before each call,
    about 0.3 ms, so the host has queued the call before the card reaches
    it and the events hold no wait for the host's Python."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for e0, e1 in ev:
        for _ in range(4):
            flush.zero_()
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return float(np.median([e0.elapsed_time(e1) for e0, e1 in ev]))


def device_ms_by_kernel(torch, fn, n=20):
    """{kernel name (its first 80 characters): device ms per ``fn()``
    call} from torch.profiler (L2 warm). 32 spin kernels open and close
    the window and are left out: the profiler drops the first and last
    kernel records of a window (profile_steps), which a call of one
    launch would lose whole."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(32):
            torch.cuda._sleep(1000)
        for _ in range(n):
            fn()
        for _ in range(32):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and "spin_kernel" not in e.key:
            t = getattr(e, "self_device_time_total", None)
            t = getattr(e, "self_cuda_time_total", 0) if t is None else t
            if t > 0:
                out[e.key[:80]] = out.get(e.key[:80], 0.0) + t / n / 1e3
    return out


def device_ms(torch, fn, n=20):
    """Device time of one ``fn()`` call, summed over the kernels it
    launches (torch.profiler, L2 warm). Unlike time_ms it leaves out any
    wait for the host, and the reads that a flushed L2 sends to HBM."""
    ms = sum(device_ms_by_kernel(torch, fn, n).values())
    return ms if ms else "not measured"


def traffic(vocab):
    rng = np.random.default_rng(SEED)
    return [(rng.integers(1, vocab, int(rng.integers(16, 129))).tolist(),
             int(rng.integers(16, 65))) for _ in range(N_REQUESTS)]


def gathered(torch, k, v, bt, sl, lens, W):
    """K/V of each row gathered from its pages to dense (P * B, KVH, L, hd)
    beforehand, stale NaN zeroed, and the boolean mask of window query w
    (columns <= seq_len + w): the SDPA yardstick's inputs."""
    P, KVH, hd = k.shape[0], k.shape[3], k.shape[4]
    B, L = len(lens), max(lens) + W
    idx = torch.arange(L, device="cuda")
    page = bt.long()[:, idx // PAGE_SIZE]                       # (B, L)
    kd = k[:, page, idx % PAGE_SIZE].permute(0, 1, 3, 2, 4)     # (P,B,KVH,L,hd)
    vd = v[:, page, idx % PAGE_SIZE].permute(0, 1, 3, 2, 4)
    # stale slots hold NaN, which an additive mask would not hide
    kd = kd.reshape(P * B, KVH, L, hd).nan_to_num().contiguous()
    vd = vd.reshape(P * B, KVH, L, hd).nan_to_num().contiguous()
    lim = sl.long()[:, None] + torch.arange(W, device="cuda")[None]
    mask = (idx[None, None, :] <= lim[:, :, None])              # (B, W, L)
    return kd, vd, mask[None].expand(P, B, W, L).reshape(P * B, 1, W, L)


def paged_row(torch, q, k, v, bt, sl, lens):
    """The paged kernel on (q, pages): max abs err against the plain
    version, event ms (L2 flushed) and device ms (L2 warm) with each kv
    head grouping (the default first, then one and four kv heads a block),
    the plain version's ms, SDPA's (K/V gathered beforehand) and the
    bound."""
    from repro_torch.kernels import paged_decode_attention as pk
    from repro_torch.kernels import ref, split_walk
    kernel = pk.paged_decode_attention
    P, B, H, hd = q.shape
    KVH = k.shape[3]
    err = max_err(torch, kernel(q, k, v, bt, sl),
                  ref.paged_decode_attention(q, k, v, bt, sl),
                  f"paged P={P} {k.dtype} seq_lens {lens}", 1e-4)
    kd, vd, mask = gathered(torch, k, v, bt, sl, lens, 1)
    qd = q.reshape(P * B, H, 1, hd).to(k.dtype)   # SDPA takes one dtype
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # bound: each live K/V row read once, q read and out written once
    live = sum(L + 1 for L in lens if L >= 0)
    n_bt = sum(L // PAGE_SIZE + 1 for L in lens if L >= 0)
    b_ms, b_by = bound(P * live * KVH * hd * 2 * k.element_size()
                       + 2 * q.numel() * q.element_size() + 4 * (n_bt + B),
                       4 * P * live * H * hd)
    default = split_walk.heads_per_block(KVH, H // KVH, hd, 2 * PAGE_SIZE,
                                         k.element_size())
    heads = by_heads(torch, lambda: kernel(q, k, v, bt, sl), default)
    row = {"max_abs_err": err, **heads[str(default)],
           "plain_ms": time_ms(torch, lambda: ref.paged_decode_attention(
               q, k, v, bt, sl), iters=30 if max(lens) < 1024 else 5),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": time_ms(torch, lambda: sdpa(qd, kd, vd,
                                                     attn_mask=mask)),
           "library_device_ms": device_ms(torch, lambda: sdpa(
               qd, kd, vd, attn_mask=mask)),
           "kv_heads_per_block": default, "by_kv_heads_per_block": heads}
    del kd, vd, mask
    torch.cuda.empty_cache()
    return row


@contextlib.contextmanager
def forced_plan(heads=None, splits=None):
    """The decode kernels' launches with the kv heads a block and / or the
    split count forced (a measurement: what the plan's rules rest on)."""
    from repro_torch.kernels import split_walk
    plan_fn = split_walk.launch_plan

    def forced(n_pmax, ps, W, G, KVH, P, B, hd, itemsize, sms):
        plan, h, rb = plan_fn(n_pmax, ps, W, G, KVH, P, B, hd, itemsize, sms)
        if heads is not None:
            h = heads
            plan = split_walk.split_plan(n_pmax, ps, W,
                                         blocks=P * B * KVH // h * rb,
                                         sms=sms)
        if splits is not None:
            plan = plan[:2] + (splits,)
        return plan, h, rb
    split_walk.launch_plan = forced
    try:
        yield
    finally:
        split_walk.launch_plan = plan_fn


def by_heads(torch, fn, default):
    """Event and device ms of ``fn`` at the default kv heads a block, then
    at one and four."""
    out = {}
    for heads in dict.fromkeys((default, 1, 4)):
        with forced_plan(heads=heads):
            out[str(heads)] = {"ms": time_ms(torch, fn),
                               "device_ms": device_ms(torch, fn)}
    return out


def split_probe(torch, fns):
    """Event and device ms of each call in ``fns`` with the decode
    kernels' split count forced to 1 and to 8 (the plan's own choice is
    one of them): what split_walk.split_plan's grid rule rests on."""
    out = {}
    for n in (1, 8):
        with forced_plan(splits=n):
            for name, fn in fns.items():
                out.setdefault(name, {})[str(n)] = {
                    "ms": time_ms(torch, fn), "device_ms": device_ms(torch, fn)}
    return out


def phase1(torch, cfg, reqs):
    from repro_torch.kernels import paged_decode_attention as pk
    from repro_torch.kernels import ref
    kernel = pk.paged_decode_attention
    errs = {"sweep_fp32": 0.0, "sweep_bf16": 0.0}
    for i, (B, H, KVH, hd, ps, n_pmax, lens) in enumerate(SWEEP):
        for dtype, tol, key in ((torch.float32, 1e-4, "sweep_fp32"),
                                (torch.bfloat16, 1e-4, "sweep_bf16")):
            args = paged_case(torch, 100 + i, 2, B, H, KVH, hd, ps, n_pmax,
                              B * n_pmax + 2, lens, dtype)
            errs[key] = max(errs[key], check_kernel(
                torch, kernel, ref.paged_decode_attention, args, lens, tol,
                f"sweep case {i} {dtype}"))
    # the serving shape: P particles, MAX_ACTIVE rows mid-generation; the
    # draft's call: a one-particle view of the same pool (spec_draft_step's
    # a[slot:slot+1]); long context: 8 rows at ~2048 tokens, a pool of
    # their own. fp32 and bf16 pages each; NaN in stale and unowned slots.
    P, H, KVH, hd = PARTICLES, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    lens = [len(p) + m // 2 for p, m in reqs][:MAX_ACTIVE]
    long_lens = [LONG_CONTEXT - 37 * i for i in range(MAX_ACTIVE)]
    n_long = max(long_lens) // PAGE_SIZE + 8
    out, rows = {"phase": 1}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        args = paged_case(torch, 7, P, len(lens), H, KVH, hd, PAGE_SIZE,
                          NUM_PAGES, NUM_PAGES, lens, dtype)
        errs[f"serve_{name}"] = check_kernel(
            torch, kernel, ref.paged_decode_attention, args, lens, 1e-4,
            f"serving shape {dtype}")
        rows[f"serve_{name}"] = paged_row(torch, *args, lens)
        q, k, v, bt, sl = args
        s = 1                                   # the drafting particle
        draft = (q[s:s + 1], k[s:s + 1], v[s:s + 1], bt, sl)
        if dtype == torch.float32:
            out["split_probe"] = split_probe(torch, {
                "serve": lambda: kernel(*args), "draft": lambda: kernel(*draft)})
        errs[f"draft_{name}"] = check_kernel(
            torch, kernel, ref.paged_decode_attention, draft, lens, 1e-4,
            f"draft view {dtype}")
        rows[f"draft_{name}"] = paged_row(torch, *draft, lens)
        del args, draft, q, k, v
        args = paged_case(torch, 8, P, MAX_ACTIVE, H, KVH, hd, PAGE_SIZE,
                          n_long, MAX_ACTIVE * n_long + 2, long_lens, dtype)
        errs[f"long_context_{name}"] = check_kernel(
            torch, kernel, ref.paged_decode_attention, args, long_lens, 1e-4,
            f"long context {dtype}")
        rows[f"long_context_{name}"] = paged_row(torch, *args, long_lens)
        del args
        torch.cuda.empty_cache()
    serve = rows["serve_float32"]
    out.update({"max_abs_err": errs, "shapes": {
        "serve": {"P": P, "B": len(lens), "H": H, "KVH": KVH, "hd": hd,
                  "page_size": PAGE_SIZE, "n_pmax": NUM_PAGES,
                  "seq_lens": lens},
        "draft": {"P": 1, "view_of_P": P, "seq_lens": lens},
        "long_context": {"P": P, "n_pmax": n_long, "seq_lens": long_lens}},
        "timed": rows})
    emit(out)
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
            "replaces": "src/repro/kernels/paged_decode_attention.py:184",
            "max_abs_err": max(errs.values()), "ms": serve["ms"],
            "plain_ms": serve["plain_ms"], "bound_ms": serve["bound_ms"],
            "bound_by": serve["bound_by"], "library_ms": serve["library_ms"]}


def prefilled_rows(torch, pd, cfg, prompts, n_pmax, pages, params=None):
    """Prefill each prompt into its own pages of the checked-out pool, as a
    row about to decode its first token, through ``params`` (the store's
    when None). Returns (params, mask, block tables, first tokens,
    seq_lens), all on the card."""
    from repro_torch.models import api
    from repro_torch.runtime import bucket_size
    from repro_torch.serve import uncertainty
    if params is None:
        params = pd.store.stacked("params")
    mask = pd.store.active_mask()
    B = len(prompts)
    bt = torch.zeros((B, n_pmax), dtype=torch.int32, device="cuda")
    tokens, seq_lens, nxt = [], [], 0
    for b, prompt in enumerate(prompts):
        n = len(prompt)
        need = (n + 4) // PAGE_SIZE + 1        # covers a 5-token window at n
        bt[b, :need] = torch.arange(nxt, nxt + need, dtype=torch.int32)
        nxt += need
        toks = torch.zeros((1, bucket_size(n)), dtype=torch.int32,
                           device="cuda")
        toks[0, :n] = torch.tensor(prompt, dtype=torch.int32)
        logits, _ = api.prefill_paged(params, toks, pages, bt[b], n, cfg)
        mean = uncertainty.predictive_heads(logits, mask=mask)["mean"]
        tokens.append(int(mean.argmax(-1)[0]))
        seq_lens.append(n)
    return (params, mask, bt,
            torch.tensor(tokens, dtype=torch.int32, device="cuda"),
            torch.tensor(seq_lens, dtype=torch.int32, device="cuda"))


def decode_parity(torch, pd, cfg, reqs, n_pmax):
    """One decode step on freshly prefilled rows, kernel vs plain version;
    then the profiled step, captured and eager (``step_programs``)."""
    from repro_torch.models import api
    from repro_torch.runtime import specs
    from repro_torch.serve import uncertainty
    from repro_torch.serve.engine import sample_heads
    store = pd.store
    pages = store.checkout("kv_pages")
    try:
        params, mask, bt, tok, sl = prefilled_rows(
            torch, pd, cfg, [p for p, _ in reqs], n_pmax, pages)
        out = {}
        for use_kernel in (True, False):
            logits, _ = api.decode_step_paged(params, tok, pages, bt, sl, cfg,
                                              decode_kernel=use_kernel)
            out[use_kernel] = (logits, uncertainty.predictive_heads(
                logits, mask=mask)["mean"])

        def decode_fn(p, pg, tokens, block_tables, seq_lens):
            return api.decode_step_paged(p, tokens, pg, block_tables,
                                         seq_lens, cfg)

        packed = np.concatenate([tok.cpu().numpy()[:, None],
                                 sl.cpu().numpy()[:, None],
                                 bt.cpu().numpy()], 1).astype(np.int32)
        spec = specs.paged_decode_step(decode_fn, sample_heads)
        profile = step_programs(torch, spec, (params, pages, packed, mask))
        for prof in profile.values():
            prof["rows"] = MAX_ACTIVE
    finally:
        store.commit("kv_pages", pages)
    d_logits = float((out[True][0] - out[False][0]).abs().max())
    d_probs = float((out[True][1] - out[False][1]).abs().max())
    p_max = float(out[False][1].max())
    if not (d_logits < 1e-3 and d_probs <= 1e-4 * p_max):
        raise AssertionError(f"kernel vs plain decode step: logits "
                             f"{d_logits}, mean probs {d_probs} (max p "
                             f"{p_max})")
    return {"max_abs_logits": d_logits, "max_abs_mean_probs": d_probs,
            "max_mean_prob": p_max}, profile


def step_programs(torch, spec, args, n=5):
    """``profile_steps`` of one step program on the same arguments, first
    captured as a CUDA graph, then run eagerly (``runtime.eager``); the
    captured program's capture time beside its profile."""
    from repro_torch.runtime import ProgramCache, eager
    out = {}
    for mode, cache in (("captured", ProgramCache()),
                        ("eager", ProgramCache(capturer=eager))):
        prog = cache.program(spec, args)
        out[mode] = profile_steps(torch, lambda: prog(*args), n=n,
                                  fns=attention_counts())
        if mode == "captured":
            if prog.graph is None:
                raise AssertionError(f"{spec.name} was not captured")
            out[mode]["capture_s"] = prog.capture_s
    return out


# Spin kernels that open and close every profiled window whose launches
# are held to the profiler's kernel counts (``profile_steps``).
HELD_SPINS = 32
# Profiled windows a hold may take: the profiler drops kernel records (a
# SWAG collection's window once saw none of its 16 launches), and a
# window where it saw fewer than the counters is profiled afresh.
HOLD_TRIES = 3


class HoldMismatch(AssertionError):
    """The counters' launches over a profiled window against what the
    profiler saw of them (``seen`` and ``want``, by kernel)."""

    def __init__(self, what, want, seen):
        super().__init__(f"{what}: counters {want}, profiler {seen}")
        self.want, self.seen = want, seen

    def dropped(self):
        """The profiler saw no launch the counters did not count: only
        records it may have dropped, not a launch a counter missed."""
        return all(self.seen[k] <= self.want[k] for k in self.want)


def profile_steps(torch, step, n=5, track=(), fns=None, hold=None,
                  prologue=0, epilogue=0):
    """Host-clock time of one synchronised ``step()``, then the device's
    busy time per step by kernel name from torch.profiler, and the share
    of device time spent in kernels whose names contain one of ``track``.
    With ``fns`` the counters' launches over the profiled window are held
    to the profiler's kernel counts (``hold``, by default
    ``hold_to_profiler``). ``prologue`` spin kernels open the profiled
    window (left out of the sums): the profiler misses the first kernel
    records after it starts (``profiler_start_probe``), which matters
    where the window's first launches are counted ones. ``epilogue`` spin
    kernels close it, as the prologue opens it: on the NEL's windows the
    profiler has also dropped the last records before it stopped (1 of 2
    force launches, 8 of 288 collection launches, both the window's
    last). A window held to the profiler (``fns``) always opens and
    closes with at least ``HELD_SPINS`` of them: a speculative draft
    step's window without them once saw 287 of its 288 paged
    launches. Where the profiler saw fewer launches than the counters and
    no more of any kernel, the window is profiled afresh, up to
    ``HOLD_TRIES`` windows in all: a counter that counts a launch that
    never ran disagrees in every window, a dropped record in one. The
    earlier windows' counts stand in ``hold_retries``."""
    from torch.profiler import ProfilerActivity, profile
    if fns is not None:
        prologue = max(prologue, HELD_SPINS)
        epilogue = max(epilogue, HELD_SPINS)
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    retries = []
    for attempt in range(HOLD_TRIES if fns is not None else 1):
        before = None if fns is None else read_counts(fns)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(prologue):
                torch.cuda._sleep(1000)
            for _ in range(n):
                step()
                torch.cuda.synchronize()
            for _ in range(epilogue):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        if fns is None:
            break
        got = {k: v - before[k] for k, v in read_counts(fns).items()}
        try:
            held = (hold or hold_to_profiler)(torch, prof, got,
                                              "profiled steps")
            break
        except HoldMismatch as e:
            if not e.dropped() or attempt == HOLD_TRIES - 1:
                raise
            retries.append({"counters": e.want, "profiler": e.seen})
    per_kernel = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or ((prologue or epilogue) and "spin_kernel" in e.key):
            continue
        us = getattr(e, "self_device_time_total", None)
        us = getattr(e, "self_cuda_time_total", 0) if us is None else us
        if us > 0:
            per_kernel[e.key] = us / n / 1e3
    busy_ms = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    out = {"steps": n, "wall_ms": wall_ms,
           "device_busy_ms": busy_ms if busy_ms else "not measured",
           "idle_share": 1 - busy_ms / wall_ms if busy_ms else "not measured",
           "kernels": len(per_kernel),
           "top_kernels_ms": {k[:80]: v for k, v in top}}
    if fns is not None:
        out["launches"] = got
        out["profiler_launches"] = held
        out["hold_retries"] = retries
    if track:
        mine = {t: sum(v for k, v in per_kernel.items() if t in k)
                for t in track}
        out["tracked_ms"] = mine
        out["tracked_share"] = (sum(mine.values()) / busy_ms if busy_ms
                                else "not measured")
    return out


# The profiler's names for the serving kernels the counters count. The
# single-token paged decode and the verify window are one template
# instance (csrc/split_walk.cuh's split_kernel over PagedCols), so the
# profiler sees the sum of their two counts; a split walk's combine_kernel
# runs only after a split and is not counted.
PROFILER_NAMES = {"flash_attention": ("flash_kernel<",),
                  "paged": ("split_kernel<", "PagedCols"),
                  "decode_attention": ("split_kernel<", "DenseCols")}


def hold_to_profiler(torch, prof, got, what):
    """The counters' launches over a profiled window against the launches
    of each kernel the profiler saw on the card (PROFILER_NAMES), exactly.
    Returns the profiler's counts. Windows are a few steps: over a whole
    speculative run (hundreds of thousands of device events) the profiler
    drops kernel records."""
    seen = dict.fromkeys(PROFILER_NAMES, 0)
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name, parts in PROFILER_NAMES.items():
            if all(p in e.key for p in parts):
                seen[name] += e.count
    want = {"flash_attention": got["flash_attention"],
            "paged": got["paged_decode_attention"]
            + got["paged_decode_window_attention"],
            "decode_attention": got["decode_attention"]}
    if seen != want:
        raise HoldMismatch(what, want, seen)
    return seen


def serve_requests(torch, pd, cfg, reqs, fns, cache, info=None, hold=None,
                   **kw):
    """serve_decode over ``reqs`` on ``pd`` through ``cache``, with each
    prompt's pow2 bucket warmed: the launch counts of ``fns`` are set to 0
    after warmup and read when the last request resolves; no step may be
    captured after warmup. ``info`` (a list) receives the cache's
    program_costs before the service closes (a serve copy's programs go
    with it). ``hold(svc, generations)`` runs on the open service after
    the traffic and its stats. Returns (generations, stats, launches, wall
    seconds, the stats at the end of warmup, n_pmax)."""
    from repro_torch.runtime import bucket_size
    from repro_torch.serve import serve_decode
    buckets = sorted({bucket_size(len(p)) for p, _ in reqs})
    svc = serve_decode(pd, cfg, num_pages=NUM_PAGES, page_size=PAGE_SIZE,
                       max_active=MAX_ACTIVE, warmup_buckets=buckets,
                       cache=cache, **kw)
    try:
        warm = svc.stats()
        for fn in fns.values():
            fn.launches = 0
        t1 = time.perf_counter()
        handles = [svc.generate_async(p, max_new=m) for p, m in reqs]
        gens = [h.result(600) for h in handles]
        wall = time.perf_counter() - t1
        launches = read_counts(fns)
        st = svc.stats()
        if info is not None:
            info.extend(cache.program_costs())
        if hold is not None:
            hold(svc, gens)
    finally:
        svc.close()
    for g, (p, m) in zip(gens, reqs):
        if len(g.tokens) != m or g.finish_reason != "length":
            raise AssertionError(f"request did not finish: "
                                 f"{len(g.tokens)}/{m} tokens")
        heads = np.array([g.logprobs, g.entropy, g.mutual_info])
        if not np.isfinite(heads).all():
            raise AssertionError("non-finite heads")
    if st["pool"]["used_pages"] != 0:
        raise AssertionError(f"pool holds {st['pool']['used_pages']} pages")
    if st["cold_compiles"] != warm["cold_compiles"]:
        raise AssertionError(f"{st['cold_compiles'] - warm['cold_compiles']}"
                             f" captures after warmup")
    return gens, st, launches, wall, warm, svc.engine.n_pmax


def caches():
    """A captured cache, then an explicit eager one, by name (made one at
    a time, so that the captured graphs go with their cache)."""
    from repro_torch.runtime import ProgramCache, eager
    yield "captured", ProgramCache()
    yield "eager", ProgramCache(capturer=eager)


def same_launches(launches, what):
    """The captured run's counts (replays add what their capture
    recorded) must equal the eager run's (each one a host launch)."""
    if launches["captured"] != launches["eager"]:
        raise AssertionError(f"{what} launches: captured "
                             f"{launches['captured']}, eager "
                             f"{launches['eager']}")


def run_summary(gens, st, warm, wall, cache, info=None):
    """The per-run numbers phases 2, 6 and 7 print for each mode (``info``:
    the cache's program_costs taken earlier)."""
    toks = sum(len(g.tokens) for g in gens)
    info = cache.program_costs() if info is None else info
    return {"generated_tokens": toks, "wall_s": wall,
            "tok_per_s": toks / wall, "steps": st["steps"],
            "prefills": st["prefills"],
            "ms_per_step_wall": wall / max(1, st["steps"]) * 1e3,
            "latency_p50_ms": st["latency_p50_ms"],
            "latency_p95_ms": st["latency_p95_ms"],
            "cache": {k: st[k] for k in ("hits", "misses", "cold_compiles")},
            "captures_after_warmup": st["cold_compiles"]
            - warm["cold_compiles"],
            "programs": len(info),
            "graphs": sum(p["graph"] for p in info),
            "capture_s": {f"{p['name']}#{i}": p["capture_s"]
                          for i, p in enumerate(info)},
            "pool_bytes": {f"{p['name']}#{i}": p["pool_bytes"]
                           for i, p in enumerate(info)},
            "pool_bytes_total": sum(p["pool_bytes"] for p in info)}


def phase2(torch, pd, cfg, reqs):
    fns = attention_counts()
    L = cfg.n_layers
    runs, tokens, launches = {}, {}, {}
    for mode, cache in caches():
        gens, st, got, wall, warm, n_pmax = serve_requests(
            torch, pd, cfg, reqs, fns, cache)
        if (got["paged_decode_attention"] != L * st["steps"]
                or st["steps"] == 0
                or got["flash_attention"] != L * st["prefills"]):
            raise AssertionError(f"{mode} kernel launches {got}, want {L} x "
                                 f"{st['steps']} steps paged and {L} x "
                                 f"{st['prefills']} prefills flash")
        if mode != "eager" and not all(
                p["graph"] for p in cache.program_costs()):
            raise AssertionError("a captured step ran eagerly")
        runs[mode] = dict(run_summary(gens, st, warm, wall, cache),
                          kernel_launches=got)
        tokens[mode], launches[mode] = [g.tokens for g in gens], got
        if mode == "captured":
            logprobs = [g.logprobs for g in gens]
        runs[mode]["peak_pages"] = st["pool"]["peak_used"]
        runs[mode]["row_occupancy"] = st["row_occupancy"]
        del cache
        torch.cuda.empty_cache()
    exact, gaps = compare_tokens(torch, pd, cfg, [p for p, _ in reqs],
                                 tokens["captured"], tokens["eager"],
                                 "captured vs eager")
    same_launches(launches, "phase 2")
    parity, profile = decode_parity(torch, pd, cfg, reqs, n_pmax)
    cap = runs["captured"]
    emit({"phase": 2, "model": cfg.name, "particles": PARTICLES,
          "layers": cfg.n_layers, "requests": len(reqs),
          "generated_tokens": cap["generated_tokens"], "wall_s": cap["wall_s"],
          "tok_per_s": cap["tok_per_s"], "steps": cap["steps"],
          "prefills": cap["prefills"],
          "ms_per_step_wall": cap["ms_per_step_wall"],
          "latency_p50_ms": cap["latency_p50_ms"],
          "latency_p95_ms": cap["latency_p95_ms"],
          "kernel_launches": launches["captured"],
          "eager_tok_per_s": runs["eager"]["tok_per_s"],
          "runs": runs, "captured_vs_eager_requests_token_equal": exact,
          "captured_vs_eager_tie_gaps": gaps,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
          "decode_parity": parity, "step_profile": profile})
    return (launches["captured"], tokens["captured"], cap["tok_per_s"],
            logprobs)


# --------------------------------------------------------------------------
# phases 5-7: the window, prefill and dense-decode kernels; speculative
# serving; stateful dense-cache decode
# --------------------------------------------------------------------------

WINDOW_SWEEP = [
    (2, 3, 4, 2, 16, 8, 4, [13, 20]),
    (3, 5, 8, 1, 8, 4, 8, [0, 9, 17]),
    (2, 2, 4, 4, 8, 8, 3, [-1, 11]),
]
FLASH_SWEEP = [(1, 64, 4, 2, 32, True), (2, 50, 4, 1, 16, True),
               (1, 128, 8, 8, 64, False), (2, 33, 2, 2, 8, True)]
DECODE_SWEEP = [(2, 64, 4, 2, 32, False), (1, 100, 8, 1, 16, True),
                (3, 33, 4, 4, 8, True), (2, 7, 4, 2, 16, False),
                (2, 65, 4, 2, 16, False)]
SPEC_K = 4
LONG_PROMPT = 4096
LONG_CONTEXT = 2048
DENSE_PROMPTS, DENSE_LEN, DENSE_NEW = 8, 64, 32


def attention_counts():
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import paged_decode_attention as pk
    from repro_torch.kernels import paged_decode_window_attention as wk
    return {"paged_decode_attention": pk.paged_decode_attention,
            "paged_decode_window_attention": wk.paged_decode_window_attention,
            "flash_attention": fk.flash_attention,
            "decode_attention": dk.decode_attention}


def window_case(torch, seed, P, B, W, H, KVH, hd, ps, n_pmax, NP, lens,
                dtype):
    """Window q and pages with the PagePool conventions; NaN in every slot
    past each row's window and in every page no row owns."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((P, B, W, H, hd), np.float32))
    k = torch.from_numpy(rng.standard_normal((P, NP, ps, KVH, hd), np.float32))
    v = torch.from_numpy(rng.standard_normal((P, NP, ps, KVH, hd), np.float32))
    bt = np.zeros((B, n_pmax), np.int32)
    free = list(rng.permutation(NP))
    owned = set()
    for b, sl in enumerate(lens):
        if sl < 0:
            continue
        last = sl + W - 1
        for i in range(last // ps + 1):
            bt[b, i] = free.pop()
            owned.add(int(bt[b, i]))
        k[:, bt[b, last // ps], last % ps + 1:] = float("nan")
        v[:, bt[b, last // ps], last % ps + 1:] = float("nan")
    dead = sorted(set(range(NP)) - owned)
    k[:, dead] = float("nan")
    v[:, dead] = float("nan")
    dev = torch.device("cuda")
    return (q.to(dev), k.to(dev, dtype), v.to(dev, dtype),
            torch.from_numpy(bt).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


def decode_case(torch, seed, P, B, C, H, KVH, hd, holes, n_valid=None):
    """q and a dense cache; NaN in every empty slot (k_pos < 0)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((P, B, H, hd), generator=gen, device="cuda")
    k = torch.randn((P, B, C, KVH, hd), generator=gen, device="cuda")
    v = torch.randn((P, B, C, KVH, hd), generator=gen, device="cuda")
    pos = torch.arange(C, device="cuda").expand(B, C).clone()
    if holes:
        keep = torch.rand((B, C), generator=gen, device="cuda") < 0.8
        pos = torch.where(keep, pos, -1)
    if n_valid is not None:
        pos[:, n_valid:] = -1
    k[:, pos < 0] = float("nan")
    v[:, pos < 0] = float("nan")
    return q, k, v, pos.to(torch.int32)


def max_err(torch, out, want, what, tol):
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{what}: non-finite output (NaN leaked)")
    err = float((out.float() - want.float()).abs().max())
    if not err < tol:
        raise AssertionError(f"{what}: max abs err {err} >= {tol}")
    return err


def ptxas_by_entry(log):
    """{kernel name and mangled template arguments: its ptxas register,
    shared-memory and spill lines} from an nvcc -Xptxas -v log."""
    table, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            # the kernel's name and template arguments, past the anonymous
            # namespace and before the parameter list
            m = re.search(r"\d+([A-Za-z_]+_kernel)(I.*?E)Ev", name)
            name = m.group(1) + m.group(2) if m else name
            table[name] = []
        elif name and ("registers" in ln or "spill" in ln or "smem" in ln):
            table[name].append(ln.split(":", 1)[-1].strip()
                               if "ptxas" in ln else ln.strip())
    return {n: "; ".join(v) for n, v in table.items()}


def phase5(torch, cfg, reqs):
    """The window, prefill and dense-decode kernels against their plain
    versions (sweeps and serving shapes), then timed with the L2 flushed.
    Returns their three kernel rows (launches filled in by main)."""
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import paged_decode_attention as pk
    from repro_torch.kernels import paged_decode_window_attention as wk
    from repro_torch.kernels import ref, split_walk
    sdpa = torch.nn.functional.scaled_dot_product_attention
    P, H, KVH, hd = PARTICLES, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    errs, out = {}, {"phase": 5}
    window, flash, decode = (wk.paged_decode_window_attention,
                             fk.flash_attention, dk.decode_attention)

    # -- the window kernel (speculative verify) ------------------------------
    W = SPEC_K + 1
    lens = [len(p) + m // 2 for p, m in reqs][:MAX_ACTIVE]
    sweep = [c + (c[0] * c[6] + 2,) for c in WINDOW_SWEEP]
    sweep.append((len(lens), W, H, KVH, hd, PAGE_SIZE, NUM_PAGES, lens,
                  NUM_PAGES))
    for i, (B, Wc, Hc, KVc, hdc, ps, n_pmax, ls, NP) in enumerate(sweep):
        for dtype in (torch.float32, torch.bfloat16):
            args = window_case(torch, 200 + i, 2 if i < 3 else P, B, Wc, Hc,
                               KVc, hdc, ps, n_pmax, NP, ls, dtype)
            got = window(*args)
            torch.cuda.synchronize()
            key = f"window_{'sweep' if i < 3 else 'serve'}_{str(dtype)[6:]}"
            errs[key] = max(errs.get(key, 0.0), max_err(
                torch, got, ref.paged_decode_window_attention(*args),
                f"window case {i} {dtype}", 1e-4))
            for b, L in enumerate(ls):
                if L < 0 and float(got[:, b].abs().max()) != 0.0:
                    raise AssertionError("window: inactive row not zero")
    # W = 1: the same walk, plan and arithmetic as the single-token kernel,
    # so the same bits
    errs["window_w1_vs_paged"] = 0.0
    for i, (B, Hc, KVc, hdc, ps, n_pmax, ls) in enumerate(SWEEP):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, bt, sl = paged_case(torch, 100 + i, 2, B, Hc, KVc, hdc,
                                         ps, n_pmax, B * n_pmax + 2, ls,
                                         dtype)
            err = float((window(q[:, :, None], k, v, bt, sl)[:, :, 0]
                         - pk.paged_decode_attention(q, k, v, bt, sl))
                        .abs().max())
            if err != 0.0:
                raise AssertionError(f"window W=1 vs paged case {i} {dtype}: "
                                     f"max abs err {err}, want 0")

    def window_row(seed, lens, n_pmax, NP):
        """The window kernel at P particles and the serving heads: max abs
        err against the plain version, then ms, plain ms, SDPA ms (a
        boolean mask over K/V gathered beforehand) and the bound."""
        q, k, v, bt, sl = window_case(torch, seed, P, len(lens), W, H, KVH,
                                      hd, PAGE_SIZE, n_pmax, NP, lens,
                                      torch.float32)
        err = max_err(torch, window(q, k, v, bt, sl),
                      ref.paged_decode_window_attention(q, k, v, bt, sl),
                      f"window P={P} seq_lens {lens}", 1e-4)
        B = len(lens)
        kd, vd, mask = gathered(torch, k, v, bt, sl, lens, W)
        qd = q.permute(0, 1, 3, 2, 4).reshape(P * B, H, W, hd).contiguous()
        pairs = sum(W * L + W * (W + 1) // 2 for L in lens)
        live = sum(L + W for L in lens)
        b_ms, b_by = bound(P * live * KVH * hd * 2 * 4 + 2 * q.numel() * 4
                           + 4 * (sum((L + W - 1) // PAGE_SIZE + 1
                                      for L in lens) + B),
                           4 * P * pairs * H * hd)
        row = {"max_abs_err": err,
               "ms": time_ms(torch, lambda: window(q, k, v, bt, sl)),
               "plain_ms": time_ms(torch, lambda: ref.paged_decode_window_attention(
                   q, k, v, bt, sl), iters=10 if max(lens) < 1024 else 3),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": time_ms(torch, lambda: sdpa(qd, kd, vd,
                                                         attn_mask=mask)),
               "device_ms": device_ms(torch, lambda: window(q, k, v, bt, sl)),
               "library_device_ms": device_ms(torch, lambda: sdpa(
                   qd, kd, vd, attn_mask=mask))}
        del q, k, v, kd, vd, qd, mask
        torch.cuda.empty_cache()
        return row

    args = window_case(torch, 7, P, len(lens), W, H, KVH, hd, PAGE_SIZE,
                       NUM_PAGES, NUM_PAGES, lens, torch.float32)
    dargs = decode_case(torch, 9, P, DENSE_PROMPTS, DENSE_LEN + DENSE_NEW + 1,
                        H, KVH, hd, False, DENSE_LEN + DENSE_NEW // 2)
    out["split_probe"] = split_probe(torch, {
        "window_serve": lambda: window(*args), "decode_serve": lambda: decode(*dargs)})
    del args, dargs
    rows = [{"name": "paged_decode_window_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/"
                       "paged_decode_window_attention.cu",
             "replaces": "src/repro/kernels/paged_decode_attention.py:131",
             **window_row(7, lens, NUM_PAGES, NUM_PAGES)}]
    rows[0]["max_abs_err"] = max(rows[0]["max_abs_err"],
                                 errs["window_serve_float32"])
    out["window_shape"] = {"P": P, "B": len(lens), "W": W, "H": H,
                           "KVH": KVH, "hd": hd, "seq_lens": lens}
    # the long-context kernel case: 8 rows at ~2048 tokens in a pool of
    # their own, where the split page walk matters more
    long_lens = [LONG_CONTEXT - 37 * i for i in range(MAX_ACTIVE)]
    n_pmax = (max(long_lens) + W - 1) // PAGE_SIZE + 8
    out["window_long_context"] = {
        "P": P, "seq_lens": long_lens, "n_pmax": n_pmax,
        **window_row(8, long_lens, n_pmax, MAX_ACTIVE * n_pmax + 2)}

    # -- the prefill kernel ----------------------------------------------------
    for i, (B, S, Hc, KVc, hdc, causal) in enumerate(FLASH_SWEEP):
        gen = torch.Generator(device="cuda").manual_seed(300 + i)
        q, k, v = (torch.randn((2, B, S, h, hdc), generator=gen,
                               device="cuda") for h in (Hc, KVc, KVc))
        errs["flash_sweep"] = max(errs.get("flash_sweep", 0.0), max_err(
            torch, flash(q, k, v, causal=causal),
            ref.flash_attention(q, k, v, causal=causal),
            f"flash case {i}", 2e-5))
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn((2, 1, 64, h, 32), generator=gen,
                           device="cuda").bfloat16() for h in (4, 2, 2))
    errs["flash_bf16"] = max_err(
        torch, flash(q, k, v), ref.flash_attention(
            q.float(), k.float(), v.float()), "flash bf16", 2e-2)

    def flash_row(S):
        gen = torch.Generator(device="cuda").manual_seed(S)
        q = torch.randn((P, 1, S, H, hd), generator=gen, device="cuda")
        k, v = (torch.randn((P, 1, S, KVH, hd), generator=gen,
                            device="cuda") for _ in range(2))
        err = max_err(torch, flash(q, k, v), ref.flash_attention(q, k, v),
                      f"flash P={P} S={S}", 2e-5)
        qd, kd, vd = (t[:, 0].transpose(1, 2).contiguous() for t in (q, k, v))
        # the kernel takes each fp32 product as three TF32 products
        flops = 4 * P * H * hd * S * (S + 1) // 2
        b_ms, b_by = bound((q.numel() * 2 + k.numel() * 2) * 4, 3 * flops,
                           rate=TF32_FLOPS_PER_S)
        row = {"max_abs_err": err,
               "ms": time_ms(torch, lambda: flash(q, k, v),
                             iters=30 if S <= 1024 else 5),
               "plain_ms": time_ms(torch, lambda: ref.flash_attention(q, k, v),
                                   iters=10 if S <= 1024 else 3),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": time_ms(torch, lambda: sdpa(qd, kd, vd,
                                                         is_causal=True),
                                     iters=30 if S <= 1024 else 5)}
        if S <= 1024:
            row["device_ms"] = device_ms(torch, lambda: flash(q, k, v))
            row["library_device_ms"] = device_ms(
                torch, lambda: sdpa(qd, kd, vd, is_causal=True))
        del q, k, v, qd, kd, vd
        torch.cuda.empty_cache()
        return row

    rows.append({"name": "flash_attention", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                 "replaces": "src/repro/kernels/attention.py:74",
                 **flash_row(128)})
    out["flash_long_prompt"] = {
        "P": P, "S": LONG_PROMPT, **flash_row(LONG_PROMPT),
        # the same work as fp32 FMAs on the CUDA cores (PR 13's kernel)
        "fp32_ops_bound_ms": bound(0, 4 * P * H * hd * LONG_PROMPT
                                   * (LONG_PROMPT + 1) // 2)[0]}

    # -- the dense-cache decode kernel ----------------------------------------
    for dtype in (torch.float32, torch.bfloat16):
        for i, (B, C, Hc, KVc, hdc, holes) in enumerate(DECODE_SWEEP):
            q, k, v, pos = decode_case(torch, 400 + i, 2, B, C, Hc, KVc, hdc,
                                       holes)
            args = (q, k.to(dtype), v.to(dtype), pos)
            key = f"decode_sweep_{str(dtype)[6:]}"
            errs[key] = max(errs.get(key, 0.0), max_err(
                torch, decode(*args), ref.decode_attention(*args),
                f"decode case {i} {dtype}", 2e-5))
        # rows with every slot empty (k_pos all -1, NaN in every slot):
        # exact zeros, as the reference's Pallas kernel gives them
        q, k, v, pos = decode_case(torch, 410, 2, 4, 97, H, KVH, hd, True)
        pos[[0, 2]] = -1
        k[:, [0, 2]] = float("nan")
        v[:, [0, 2]] = float("nan")
        args = (q, k.to(dtype), v.to(dtype), pos)
        got = decode(*args)
        key = f"decode_sweep_{str(dtype)[6:]}"
        errs[key] = max(errs[key], max_err(
            torch, got, ref.decode_attention(*args),
            f"decode all-empty rows {dtype}", 2e-5))
        if float(got[:, [0, 2]].abs().max()) != 0.0:
            raise AssertionError(f"decode: an all-empty row is not exact "
                                 f"zeros ({dtype})")

    def decode_row(C, n_valid):
        """The dense-decode kernel at P particles, DENSE_PROMPTS rows and
        the serving heads over C slots (n_valid of them filled, NaN in the
        rest): max abs err, event and device ms with each kv head grouping
        (the default first, then one and four), plain ms, SDPA ms (a
        boolean mask over the dense cache) and the bound at this run's
        valid slots."""
        B = DENSE_PROMPTS
        q, k, v, pos = decode_case(torch, 9, P, B, C, H, KVH, hd, False,
                                   n_valid)
        err = max_err(torch, decode(q, k, v, pos),
                      ref.decode_attention(q, k, v, pos),
                      f"decode C={C}", 2e-5)
        kd = k.reshape(P * B, C, KVH, hd).transpose(1, 2).nan_to_num()
        vd = v.reshape(P * B, C, KVH, hd).transpose(1, 2).nan_to_num()
        kd, vd = kd.contiguous(), vd.contiguous()
        qd = q.reshape(P * B, H, 1, hd)
        mask = (pos >= 0)[None].expand(P, B, C).reshape(P * B, 1, 1, C)
        valid = int((pos >= 0).sum())
        b_ms, b_by = bound(P * valid * KVH * hd * 2 * 4 + 2 * q.numel() * 4
                           + pos.numel() * 4, 4 * P * valid * H * hd)
        default = split_walk.heads_per_block(KVH, H // KVH, hd,
                                             split_walk.dense_plan(C)[0], 4)
        heads = by_heads(torch, lambda: decode(q, k, v, pos), default)
        row = {"max_abs_err": err, **heads[str(default)],
               "plain_ms": time_ms(torch, lambda: ref.decode_attention(
                   q, k, v, pos), iters=30 if C < 1024 else 5),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": time_ms(torch, lambda: sdpa(qd, kd, vd,
                                                         attn_mask=mask)),
               "library_device_ms": device_ms(torch, lambda: sdpa(
                   qd, kd, vd, attn_mask=mask)),
               "kv_heads_per_block": default,
               "by_kv_heads_per_block": heads}
        del q, k, v, kd, vd, qd, mask
        torch.cuda.empty_cache()
        return row

    C = DENSE_LEN + DENSE_NEW + 1
    n_valid = DENSE_LEN + DENSE_NEW // 2
    rows.append({"name": "decode_attention", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
                 "replaces": "src/repro/kernels/decode_attention.py:67",
                 **decode_row(C, n_valid)})
    errs["decode_serve"] = rows[-1]["max_abs_err"]
    out["decode_shape"] = {"P": P, "B": DENSE_PROMPTS, "C": C,
                           "valid_slots": n_valid}
    # the long cache: C = 2048 slots, all filled (537 MB of K/V in fp32)
    out["decode_long_cache"] = {"P": P, "B": DENSE_PROMPTS, "C": LONG_CONTEXT,
                                **decode_row(LONG_CONTEXT, None)}
    errs["decode_long_cache"] = out["decode_long_cache"]["max_abs_err"]
    # device-only times and the kv head groupings go in this phase's line,
    # not in the kernels line
    out["device_ms"] = {r["name"]: {k: r.pop(k) for k in ("device_ms",
                                                          "library_device_ms")}
                        for r in rows if "device_ms" in r}
    out["by_kv_heads_per_block"] = {
        r["name"]: {k: r.pop(k) for k in ("kv_heads_per_block",
                                          "by_kv_heads_per_block")}
        for r in rows if "by_kv_heads_per_block" in r}
    out["max_abs_err"] = errs
    out["timed"] = {r["name"]: {k: r[k] for k in ("ms", "plain_ms",
                                                  "bound_ms", "library_ms")}
                    for r in rows}
    emit(out)
    return rows


def tie_gap(torch, pd, cfg, tokens, params=None, front=None):
    """The BMA top-2 gap of the next-token probabilities after ``tokens``,
    over the top probability (a dense prefill of all particles, through
    ``params``: the store's when None; ``front``: the row's frames or
    patches, {key: (1, L, D)}, for the audio and vlm families)."""
    from repro_torch.models import api
    from repro_torch.serve import uncertainty
    toks = torch.tensor([tokens], dtype=torch.int32, device="cuda")
    if params is None:
        params = pd.store.stacked("params")
    with torch.no_grad():
        logits, _ = api.prefill(params, {"tokens": toks, **(front or {})},
                                cfg)
    mean = uncertainty.predictive_heads(logits, mask=pd.store.active_mask())[
        "mean"][0]
    top2 = torch.topk(mean, 2).values
    return float((top2[0] - top2[1]) / top2[0])


def compare_tokens(torch, pd, cfg, prompts, got, want, what, params=None,
                   tie=1e-4, front=None):
    """Tokens equal, or the first difference sits on a near-tie of the
    reference run (top-2 gap under ``tie`` of the top probability, through
    ``params``: the store's when None; ``front``: the batch's frames or
    patches, {key: (B, L, D)}, by row). Returns (requests equal, [gap at
    each first difference])."""
    exact, gaps = 0, []
    for i, (prompt, a, b) in enumerate(zip(prompts, got, want)):
        k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if k is None and len(a) == len(b):
            exact += 1
            continue
        k = min(len(a), len(b)) if k is None else k
        gap = tie_gap(torch, pd, cfg, list(prompt) + list(b[:k]), params,
                      front and {key: t[i:i + 1] for key, t in front.items()})
        gaps.append(gap)
        if not gap < tie:
            raise AssertionError(f"{what}: tokens differ at {k} where the "
                                 f"top-2 gap is {gap}")
    return exact, gaps


def phase6(torch, pd, cfg, reqs, plain_tokens, plain_tok_s):
    """serve_decode(speculative=4) over phase 2's requests and particles,
    captured and eager, then a short pass with all particles on one weight
    set."""
    from repro_torch.core import ParticleModule, PushDistribution
    from repro_torch.models import api
    from repro_torch.runtime import ProgramCache, specs
    from repro_torch.serve.engine import sample_heads
    L = cfg.n_layers
    fns = attention_counts()
    runs, tokens, launches = {}, {}, {}
    for mode, cache in caches():
        gens, st, got, wall, warm, n_pmax = serve_requests(
            torch, pd, cfg, reqs, fns, cache, speculative=SPEC_K)
        ss = st["speculative"]
        iters = (st["engine"]["draft_iterations"]
                 - warm["engine"]["draft_iterations"])
        want = {"paged_decode_window_attention": L * ss["verify_calls"],
                "paged_decode_attention": L * iters,
                "flash_attention": L * st["prefills"], "decode_attention": 0}
        if got != want or ss["verify_calls"] == 0:
            raise AssertionError(f"{mode} speculative launches {got}, want "
                                 f"{want}")
        if mode != "eager" and not all(
                p["graph"] for p in cache.program_costs()):
            raise AssertionError("a captured step ran eagerly")
        runs[mode] = dict(run_summary(gens, st, warm, wall, cache),
                          draft_iterations=iters, speculative=ss,
                          kernel_launches=got)
        tokens[mode], launches[mode] = [g.tokens for g in gens], got
        del cache
        torch.cuda.empty_cache()
    prompts = [p for p, _ in reqs]
    exact, gaps = compare_tokens(torch, pd, cfg, prompts, tokens["captured"],
                                 plain_tokens, "speculative vs plain")
    exact_e, gaps_e = compare_tokens(torch, pd, cfg, prompts,
                                     tokens["captured"], tokens["eager"],
                                     "captured vs eager speculative")
    same_launches(launches, "phase 6")
    launches = launches["captured"]
    # profiled steps on 8 freshly prefilled rows: the verify of 5-token
    # windows and the draft of 4 iterations, captured and eager
    pages = pd.store.checkout("kv_pages")
    try:
        params, mask, bt, tok, sl = prefilled_rows(torch, pd, cfg, prompts,
                                                   n_pmax, pages)
        gen = torch.Generator(device="cuda").manual_seed(5)
        win = torch.randint(1, cfg.vocab_size, (len(reqs), SPEC_K + 1),
                            generator=gen, device="cuda", dtype=torch.int32)
        win[:, 0] = tok
        host = [t.cpu().numpy().astype(np.int32) for t in (win, sl, bt)]
        w, s0, b = host
        verify = np.concatenate(
            [w, s0[:, None], np.full_like(s0[:, None], SPEC_K + 1), b], 1)
        draft = np.concatenate(
            [w[:, :1], s0[:, None], np.full_like(s0[:, None], SPEC_K), b], 1)

        def decode_fn(p, pg, tokens, block_tables, seq_lens):
            return api.decode_step_paged(p, tokens, pg, block_tables,
                                         seq_lens, cfg)

        def verify_fn(p, pg, tokens, block_tables, seq_lens, win_lens):
            return api.decode_window_paged(p, tokens, pg, block_tables,
                                           seq_lens, win_lens, cfg)

        prof = step_programs(torch, specs.spec_verify(
            verify_fn, sample_heads, w_max=SPEC_K + 1),
            (params, pages, verify, mask), n=3)
        draft_prof = step_programs(torch, specs.spec_draft_step(
            decode_fn, slot=0, n_iter=SPEC_K), (params, pages, draft), n=3)
    finally:
        pd.store.commit("kv_pages", pages)
    cap = runs["captured"]
    out = {"phase": 6, "k_max": SPEC_K, "requests": len(reqs),
           "generated_tokens": cap["generated_tokens"],
           "wall_s": cap["wall_s"], "tok_per_s": cap["tok_per_s"],
           "plain_tok_per_s": plain_tok_s,
           "eager_tok_per_s": runs["eager"]["tok_per_s"],
           "steps": cap["steps"], "draft_iterations": cap["draft_iterations"],
           "speculative": cap["speculative"],
           "latency_p50_ms": cap["latency_p50_ms"],
           "latency_p95_ms": cap["latency_p95_ms"],
           "requests_token_equal_to_phase2": exact, "tie_gaps": gaps,
           "captured_vs_eager_requests_token_equal": exact_e,
           "captured_vs_eager_tie_gaps": gaps_e,
           "kernel_launches": launches, "runs": runs,
           "verify_profile": prof, "draft_profile": draft_prof}

    # all particles on one weight set: the draft always agrees with the BMA
    module = ParticleModule(init=None, cfg=cfg)
    with PushDistribution(module, seed=SEED) as twin:
        first = pd.p_params(pd.particle_ids()[0])
        for _ in range(PARTICLES):
            twin.p_create(params=first)
        short = [(p, 16) for p, _ in reqs[:4]]
        tg, tst, _, twall, _, _ = serve_requests(
            torch, twin, cfg, short, fns, ProgramCache(), speculative=SPEC_K)
        tss = tst["speculative"]
        if not tss["acceptance_rate"] >= 0.9:
            raise AssertionError(f"shared-weight acceptance {tss}")
        out["shared_weights"] = {
            "requests": len(tg), "generated_tokens": 16 * len(tg),
            "tok_per_s": 16 * len(tg) / twall, "steps": tst["steps"],
            "speculative": tss}
    torch.cuda.empty_cache()
    emit(out)
    return launches


def phase7(torch, pd, cfg):
    """Stateful dense-cache decode through PredictiveEngine(stateful=True),
    captured and eager, against serve_decode's tokens on the same
    prompts."""
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import ref
    from repro_torch.models import api
    from repro_torch.models.blocks import attn_qkv, norm_apply
    from repro_torch.runtime import ProgramCache
    from repro_torch.serve import PredictiveEngine
    L = cfg.n_layers
    rng = np.random.default_rng(2)
    prompts = rng.integers(1, cfg.vocab_size, (DENSE_PROMPTS, DENSE_LEN))
    C = DENSE_LEN + DENSE_NEW + 1
    cur = DENSE_LEN - 1 + DENSE_NEW
    fns = attention_counts()
    paged = serve_requests(torch, pd, cfg,
                           [(list(p), DENSE_NEW) for p in prompts], fns,
                           ProgramCache())[0]

    def fwd(params, caches, batch):
        return api.decode_step(params, batch["token"], caches,
                               batch["cur_pos"], cfg)

    toks = torch.as_tensor(prompts, dtype=torch.int32, device="cuda")
    runs, tokens, all_launches = {}, {}, {}
    for mode, cache in caches():
        engine = PredictiveEngine(fwd, store=pd.store, stateful=True,
                                  cache=cache)
        for fn in fns.values():
            fn.launches = 0
        t0 = time.perf_counter()
        state = engine.init_state(lambda p: api.prefill(
            p, {"tokens": toks[:, :-1]}, cfg, max_len=C)[1])
        tok, dense, kept, first = toks[:, -1], [], [], None
        for step in range(DENSE_NEW):
            heads, state = engine.step(state, {
                "token": tok, "cur_pos": DENSE_LEN - 1 + step})
            tok = heads["mean"].argmax(-1).to(torch.int32)
            dense.append(tok)
            kept.append(heads["mean"])
            if first is None:
                first = cache.snapshot_stats()["cold_compiles"]
        dense = torch.stack(dense, 1).cpu().numpy()
        wall = time.perf_counter() - t0
        launches = all_launches[mode] = read_counts(fns)
        # every step's heads are its own, kept past the later replays
        if not np.array_equal(torch.stack([m.argmax(-1) for m in kept],
                                          1).cpu().numpy(), dense):
            raise AssertionError(f"{mode}: a step's heads changed after it "
                                 f"returned")
        want = {"paged_decode_attention": 0,
                "paged_decode_window_attention": 0,
                "flash_attention": L, "decode_attention": L * DENSE_NEW}
        if launches != want:
            raise AssertionError(f"{mode} dense decode launches {launches}, "
                                 f"want {want}")
        for k, v in heads.items():
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"non-finite head {k}")
        st = cache.snapshot_stats()
        info = cache.program_costs()
        if st["cold_compiles"] != first or first != 1 or (
                mode != "eager" and not info[0]["graph"]):
            raise AssertionError(f"{mode} dense step programs {st}")
        tokens[mode] = dense.tolist()
        KEEP["phase7_tokens"] = tokens.get("captured")
        if mode == "captured":
            # a position outside the cache raises on the host, before the
            # replay, and the card goes on (the profiled steps below)
            try:
                engine.step(state, {"token": tok, "cur_pos": C})
            except ValueError:
                pass
            else:
                raise AssertionError("a captured step took cur_pos = C")
            # one step's layer-0 attention through the kernel and the
            # plain version
            params = pd.store.stacked("params")
            unit0 = {k: {kk: vv[:, 0] for kk, vv in v.items()}
                     for k, v in params["units"][0]["attn"].items()}
            x = params["embed"][:, tok.long()][:, :, None]
            x = norm_apply({k: v[:, 0] for k, v in
                            params["units"][0]["ln1"].items()}, x)
            q, _, _ = attn_qkv(unit0, x, cfg, torch.full(
                (DENSE_PROMPTS, 1), cur, device="cuda"))
            c0 = state["units"][0]
            kc, vc, pos = c0["k"][:, 0], c0["v"][:, 0], c0["pos"][0]
            attn_err = max_err(
                torch, dk.decode_attention(q[:, :, 0], kc, vc, pos),
                ref.decode_attention(q[:, :, 0], kc, vc, pos),
                "dense decode step attention", 2e-5)
            main_launches = launches
        last = tok

        def step():
            engine.step(state, {"token": last, "cur_pos": cur})

        runs[mode] = {
            "wall_s": wall, "tok_per_s": DENSE_PROMPTS * DENSE_NEW / wall,
            "ms_per_step_wall": wall / DENSE_NEW * 1e3,
            "kernel_launches": launches,
            "cache": {k: st[k] for k in ("hits", "misses", "cold_compiles")},
            "captures_after_first_step": st["cold_compiles"] - first,
            "capture_s": info[0]["capture_s"],
            "pool_bytes": info[0]["pool_bytes"],
            "step_profile": profile_steps(torch, step, n=3, fns=fns)}
        del state, engine, cache, kept, heads
        torch.cuda.empty_cache()
    exact, gaps = compare_tokens(torch, pd, cfg, prompts, tokens["captured"],
                                 [g.tokens for g in paged], "dense vs paged")
    exact_e, gaps_e = compare_tokens(torch, pd, cfg, prompts,
                                     tokens["captured"], tokens["eager"],
                                     "captured vs eager dense")
    same_launches(all_launches, "phase 7")
    cap = runs["captured"]
    emit({"phase": 7, "prompts": DENSE_PROMPTS, "prompt_len": DENSE_LEN,
          "new_tokens": DENSE_NEW, "cache_len": C, "wall_s": cap["wall_s"],
          "tok_per_s": cap["tok_per_s"],
          "eager_tok_per_s": runs["eager"]["tok_per_s"],
          "ms_per_step_wall": cap["ms_per_step_wall"],
          "requests_token_equal_to_serve_decode": exact, "tie_gaps": gaps,
          "captured_vs_eager_requests_token_equal": exact_e,
          "captured_vs_eager_tie_gaps": gaps_e,
          "step_attention_kernel_vs_plain": attn_err,
          "kernel_launches": main_launches, "runs": runs,
          "peak_mem_gb_phases_1_to_7":
              torch.cuda.max_memory_allocated() / 2**30})
    return main_launches


# --------------------------------------------------------------------------
# phases 3-4: SVGD and MultiSWAG training of ViT-MNIST particles
# --------------------------------------------------------------------------

TRAIN_P = 8                      # configs/vit_mnist.py default_particles
TRAIN_B, TRAIN_NB = 64, 8        # batch, batches per epoch (the paper: 40)
P8_NB = 4                        # phase 8's NEL runs: batches per epoch
TRAIN_D = 19_775_360             # parameters per ViT-MNIST particle
SQDIST_SWEEP = [(2, 16), (4, 100), (8, 5000), (64, 12345), (3, 7)]
FORCE_SWEEP = [(4, 100, 1.0), (8, 5000, 1.3), (16, 50000, 0.7), (3, 7, 2.0)]
OURS = ("sqdist_stream_kernel", "sqdist_sum_kernel", "force_stream_kernel",
        "moments_leaves_kernel", "diag_std_leaves_kernel", "diag_std_kernel")


def collect_launches(n_leaves):
    """#3's launches a collection over a tree of ``n_leaves`` leaves, and
    #4's a diagonal scale of the tree: one per swag_moments.MAX_LEAVES of
    them (one for every tree driven here)."""
    from repro_torch.kernels import swag_moments
    return -(-n_leaves // swag_moments.MAX_LEAVES)


def counted_launches(fn, call, want, what):
    """The launches the wrapper ``fn`` counts in one untimed ``call()``,
    which must be ``want``; ``fn``'s count is left as it was (a probe's
    launches are not the path's)."""
    before, fn.launches = fn.launches, 0
    try:
        call()
        got = fn.launches
    finally:
        fn.launches = before
    if got != want:
        raise AssertionError(f"{what}: {got} launches, not {want}")
    return got


def rows_case(torch, seed, n, D, dead=(), scale=0.05):
    """theta, grads (n, D) on the card and a mask, NaN in the dead rows."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t = torch.randn((n, D), generator=gen, device="cuda") * scale
    g = torch.randn((n, D), generator=gen, device="cuda")
    if not dead:
        return t, g, None
    m = torch.ones(n, device="cuda")
    m[list(dead)] = 0.0
    t[m == 0] = float("nan")
    g[m == 0] = float("nan")
    return t, g, m


def rel_err(got, want):
    """Largest absolute difference over the largest |want| (which must be
    positive: a zero reference would make any kernel pass)."""
    top = float(want.abs().max())
    if not top > 0.0:
        raise AssertionError("the plain version's output is all zeros")
    return float((got - want).abs().max()) / top


def plain_force(theta, g, ell, mask=None):
    """The SVGD force from the plain versions, past the kernels' dispatch."""
    from repro_torch.bdl.svgd import rbf_glue
    from repro_torch.kernels import ref
    sq = ref.pairwise_sqdist(theta, mask)
    return ref.svgd_force(theta, g, *rbf_glue(sq, ell, mask), mask)


def moments_parity(torch, state, params, mask):
    """One SWAG collection at the path's shapes (its leaves, ring depth,
    slots and mask): the one-launch kernel on a clone of the whole state,
    the per-leaf kernel and the plain version leaf by leaf, each on
    its own clone of the leaf's ring; nothing is written back. Returns
    the largest difference to the plain version; raises unless the
    one-launch kernel equals the per-leaf kernel and the plain version
    bit for bit."""
    from repro_torch.core.tree import tree_flatten
    from repro_torch.kernels import ref, swag_moments
    means = tree_flatten(state["mean"], sort_keys=True)[0]
    sqs, devs, thetas = (tree_flatten(t, sort_keys=True)[0] for t in
                         (state["sq_mean"], state["dev"], params))
    thetas = [t.contiguous() for t in thetas]
    n, R = state["n"], devs[0].shape[1]
    slot = (state["rank"] % R).to(torch.int32)
    one = [[x.clone() for x in xs] for xs in (means, sqs, devs)]
    swag_moments.moments_leaves(one[0], one[1], thetas, n, mask, one[2],
                                slot)
    err, same = 0.0, {"per_leaf_kernel": True, "plain": True}
    for i, (m, s, t, d) in enumerate(zip(means, sqs, thetas, devs)):
        ring_k, ring_p = d.clone(), d.clone()
        got = swag_moments.moments(m, s, t, n, mask, ring_k, slot)
        want = ref.swag_moments(m, s, t, n, mask, ring_p, slot)
        mine = (one[0][i], one[1][i], one[2][i])
        err = max([err] + [float((a - b).abs().max()) for a, b in
                           zip(mine, want + (ring_p,))])
        same["per_leaf_kernel"] &= all(
            torch.equal(a, b) for a, b in zip(mine, got + (ring_k,)))
        same["plain"] &= all(
            torch.equal(a, b) for a, b in zip(mine, want + (ring_p,)))
        del ring_k, ring_p, got, want, mine
    del one
    torch.cuda.empty_cache()
    if not all(same.values()):
        raise AssertionError(f"one-launch collection not bit-equal: {same}")
    return {"max_abs_err": err, "bit_equal": same, "leaves": len(means),
            "max_rank": R, "slots": sorted(set(slot.tolist()))}


def bound(nbytes, flops, rate=FP32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sqdist_exact(torch, svgd_rbf, theta, mask, what):
    """The sqdist kernel twice on the same input: the same bits, exactly
    symmetric, an exact-zero diagonal. Returns the first output."""
    a = svgd_rbf.pairwise_sqdist(theta, mask)
    b = svgd_rbf.pairwise_sqdist(theta, mask)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"{what}: two calls differ")
    if not (torch.equal(a, a.T) and bool((a.diagonal() == 0).all())):
        raise AssertionError(f"{what}: not exactly symmetric with a zero "
                             f"diagonal")
    return a


def sqdist_probe(torch, svgd_rbf, theta, plan):
    """What the sqdist kernel's time is made of at the training shape
    (its event ms are the kernels line's): the device ms of the whole
    call, split by kernel (the streaming first stage and the summing
    second); the first stage alone; the ring at 2 and 4 stages of the
    default bytes, event ms (L2 flushed) and device ms each; and event ms
    over ring shapes (KB a stage x stages x blocks an SM), the table the
    plan's defaults were chosen from."""
    def full(**kw):
        return svgd_rbf.pairwise_sqdist(theta, **kw)

    by_kernel = device_ms_by_kernel(torch, full)
    out = {"plan": {k: getattr(plan, k) for k in (
               "path", "nchunks", "grid", "stages", "tile_cols",
               "stage_rows", "smem", "blocks_per_sm")},
           "device_ms": device_ms(torch, full),
           "device_ms_by_kernel": by_kernel,
           "stage1_only": {
               "event_ms": time_ms(torch, lambda: full(reduce=False)),
               "device_ms": device_ms(torch, lambda: full(reduce=False))},
           "by_stages": {}}
    for stages in (2, 4):
        p = svgd_rbf.plan_for(theta, stages=stages)
        out["by_stages"][str(stages)] = {
            "grid": p.grid, "blocks_per_sm": p.blocks_per_sm,
            "event_ms": time_ms(torch, lambda: full(stages=stages)),
            "device_ms": device_ms(torch, lambda: full(stages=stages))}
    out["by_ring_event_ms"] = ring = {}
    for kb in (16, 32, 64):
        for stages in (1, 2, 3, 4):
            for per_sm in (2, 1):
                shape = {"stages": stages, "stage_bytes": kb * 1024,
                         "blocks_per_sm": per_sm}
                try:
                    p = svgd_rbf.plan_for(theta, **shape)
                except ValueError:      # the ring does not fit an SM
                    continue
                if p.blocks_per_sm == per_sm:
                    ring[f"{kb}KBx{stages}x{per_sm}"] = time_ms(
                        torch, lambda: full(**shape), iters=10)
    return out


def phase3(torch):
    """The four SVGD/SWAG kernels against their plain versions on the card
    (sweeps, masked cases with NaN in dead rows, the training shape), then
    timed at the training shape with the L2 flushed."""
    from repro_torch.bdl.svgd import rbf_glue
    from repro_torch.kernels import ref, svgd_rbf, swag_moments
    sweep = {"sqdist": 0.0, "force_rel": 0.0, "moments": 0.0, "diag_std": 0.0,
             "diag_std_leaves": 0.0}
    paths, force_paths = {}, {}
    for i, (n, D) in enumerate(SQDIST_SWEEP):
        for dead in ((), (n - 1,)):
            t, _, m = rows_case(torch, 10 + i, n, D, dead)
            got = sqdist_exact(torch, svgd_rbf, t, m, f"sqdist {n}x{D}")
            err = float((got - ref.pairwise_sqdist(t, m)).abs().max())
            if not (err < 1e-3 and bool(torch.isfinite(got).all())):
                raise AssertionError(f"sqdist {n}x{D} dead={dead}: {err}")
            sweep["sqdist"] = max(sweep["sqdist"], err)
            paths[f"{n}x{D}"] = svgd_rbf.plan_for(t).path
    for i, (n, D, ell) in enumerate(FORCE_SWEEP + [
            (8, 5000, 0.0), (16, 50000, -1.0), (2, 4099, 1.0),
            (1, 4096, 1.0), (256, 3001, 0.0)]):
        dead_rows = (0, n - 1) if n > 3 else ((1,) if n > 1 else ())
        for dead in ((), dead_rows):
            t, g, m = rows_case(torch, 20 + i, n, D, dead)
            sq = ref.pairwise_sqdist(t, m)
            glue = rbf_glue(sq, ell, m)
            got = svgd_rbf.svgd_force(t, g, *glue, m)
            torch.cuda.synchronize()
            want = ref.svgd_force(t, g, *glue, m)
            rel = float((got - want).abs().max() / want.abs().max())
            if not (rel < 2e-4 and bool(torch.isfinite(got).all())):
                raise AssertionError(f"force {n}x{D} ell={ell}: {rel}")
            if m is not None and float(got[m == 0].abs().max()) != 0.0:
                raise AssertionError("force: a dead row is not exact zeros")
            if not torch.equal(got, svgd_rbf.svgd_force_columns(t, g, *glue,
                                                             m)):
                raise AssertionError(f"force {n}x{D}: not the column "
                                     f"kernel's bits")
            sweep["force_rel"] = max(sweep["force_rel"], rel)
            force_paths[f"{n}x{D}"] = svgd_rbf.force_plan_for(t, g,
                                                              got).path
    for i, (P, L, dead) in enumerate([(3, 123, ()), (4, 8193, (1,)),
                                      (8, 100000, (0, 5))]):
        gen = torch.Generator(device="cuda").manual_seed(30 + i)
        mean, theta = (torch.randn((P, L), generator=gen, device="cuda")
                       for _ in range(2))
        sq = mean ** 2 + torch.rand((P, L), generator=gen, device="cuda")
        ring = torch.randn((P, 4, L), generator=gen, device="cuda")
        n = torch.arange(P, dtype=torch.float32, device="cuda")
        slot = (torch.arange(P, device="cuda") * 3 % 4).to(torch.int32)
        m = torch.ones(P, device="cuda")
        m[list(dead)] = 0.0
        theta[m == 0] = float("nan")
        ring_k, ring_p = ring.clone(), ring.clone()
        got = swag_moments.moments(mean, sq, theta, n, m, ring_k, slot)
        torch.cuda.synchronize()
        want = ref.swag_moments(mean, sq, theta, n, m, ring_p, slot)
        err = max(float((a - b).abs().max()) for a, b in
                  zip(got + (ring_k,), want + (ring_p,)))
        for p in dead:
            if not (torch.equal(got[0][p], mean[p])
                    and torch.equal(got[1][p], sq[p])
                    and torch.equal(ring_k[p], ring[p])):
                raise AssertionError("moments: a dead row changed")
        if not err < 1e-5:
            raise AssertionError(f"moments {P}x{L}: {err}")
        sweep["moments"] = max(sweep["moments"], err)
        std = swag_moments.diag_std(mean, sq)
        torch.cuda.synchronize()
        err = float((std - ref.diag_std(mean, sq)).abs().max())
        if not err < 1e-5:
            raise AssertionError(f"diag_std {P}x{L}: {err}")
        sweep["diag_std"] = max(sweep["diag_std"], err)
        # the one-launch kernel over the sweep's leaf and a view one float
        # past a 16-byte boundary (scalar accesses): the per-leaf bits
        par = diag_std_parity(torch, [mean, mean.reshape(-1)[1:]],
                              [sq, sq.reshape(-1)[1:]], f"{P}x{L}")
        sweep["diag_std_leaves"] = max(sweep["diag_std_leaves"],
                                       par["max_abs_err"])

    # the training shape: 8 particles x 19,775,360 parameters
    P, D = TRAIN_P, TRAIN_D
    gen = torch.Generator(device="cuda").manual_seed(40)
    theta = torch.randn((P, D), generator=gen, device="cuda") * 0.05
    grads = torch.randn((P, D), generator=gen, device="cuda")
    mb = P * D * 4
    rows, errs = [], {}
    plan = svgd_rbf.plan_for(theta)
    paths[f"{P}x{D}"] = plan.path
    if plan.path != "bulk":
        raise AssertionError(f"sqdist at the training shape takes the "
                             f"{plan.path} path, not the bulk copies")
    sq_k = sqdist_exact(torch, svgd_rbf, theta, None, "sqdist training shape")
    sq_p = ref.pairwise_sqdist(theta)
    errs["sqdist"] = float((sq_k - sq_p).abs().max())
    errs["sqdist_rel_to_max"] = errs["sqdist"] / float(sq_p.abs().max())
    if not errs["sqdist_rel_to_max"] < 1e-5:
        raise AssertionError(f"sqdist at the training shape: {errs}")
    b_ms, b_by = bound(mb, 2 * P * P * D)
    library = {
        "torch.cdist": time_ms(torch, lambda: torch.cdist(theta, theta)),
        "torch.cdist(use_mm_for_euclid_dist)": time_ms(
            torch, lambda: torch.cdist(
                theta, theta, compute_mode="use_mm_for_euclid_dist"))}
    rows.append({"name": "pairwise_sqdist", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/svgd_rbf.cu",
                 "replaces": "src/repro/kernels/svgd_rbf.py:57",
                 "max_abs_err": errs["sqdist"],
                 "ms": time_ms(torch, lambda: svgd_rbf.pairwise_sqdist(theta)),
                 "plain_ms": time_ms(torch,
                                     lambda: ref.pairwise_sqdist(theta)),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": min(library.values())})
    probe = {**sqdist_probe(torch, svgd_rbf, theta, plan),
             "library_ms": library}
    glue = rbf_glue(sq_p, 0.0)
    phi_k = svgd_rbf.svgd_force(theta, grads, *glue)
    phi_p = ref.svgd_force(theta, grads, *glue)
    errs["force"] = float((phi_k - phi_p).abs().max())
    errs["force_rel"] = errs["force"] / float(phi_p.abs().max())
    if not errs["force_rel"] < 2e-4:
        raise AssertionError(f"force at the training shape: {errs}")
    del phi_p
    # the redesign against the column kernel (the probe): the same bits
    errs["force_equals_columns"] = torch.equal(
        phi_k, svgd_rbf.svgd_force_columns(theta, grads, *glue))
    del phi_k
    # the repulsive term alone (g = 0): at this D it is ~1e-6 of the
    # driving term, so the check above cannot see it
    zeros = torch.zeros_like(grads)
    phi_k = svgd_rbf.svgd_force(theta, zeros, *glue)
    errs["force_repulsive_rel"] = rel_err(
        phi_k, ref.svgd_force(theta, zeros, *glue))
    errs["repulsive_equals_columns"] = torch.equal(
        phi_k, svgd_rbf.svgd_force_columns(theta, zeros, *glue))
    if not errs["force_repulsive_rel"] < 2e-4:
        raise AssertionError(f"repulsive force at the training shape: {errs}")
    if not (errs["force_equals_columns"] and errs["repulsive_equals_columns"]):
        raise AssertionError(f"force at the training shape: not the "
                             f"column kernel's "
                             f"bits: {errs}")
    del zeros, phi_k
    rows.append({**force_row(torch, theta, grads, glue),
                 "max_abs_err": errs["force"]})
    # #3: one collection over the ViT's 18 leaves (the kernels line's
    # row) and over the UNet's 34, each against the per-leaf loop
    vit = collection_probe(torch, leaf_shapes(torch, vit_module()[0]),
                           seed=41, raveled=True)
    unet = collection_probe(torch, leaf_shapes(torch, unet_module()[0]),
                            seed=42)
    rows.append({"name": "swag_moments", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/swag_moments.cu",
                 "replaces": "src/repro/kernels/swag_moments.py:37",
                 **{k: vit[k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by")},
                 "library_ms": None,
                 "vit_collection": vit, "unet_collection": unet})
    del theta, grads
    torch.cuda.empty_cache()
    # #4: the scale of the ViT's 18 leaves at 8 rows in one launch (the
    # kernels line's row), against the per-leaf kernel's loop, and the
    # per-leaf kernel once over the leaves raveled into one (8, D) leaf
    # (the shape the table carried before)
    shapes = leaf_shapes(torch, vit_module()[0])
    gen = torch.Generator(device="cuda").manual_seed(43)
    means = [torch.randn((P,) + s, generator=gen, device="cuda") * 0.05
             for s in shapes]
    sqs = [m * m + torch.rand(m.shape, generator=gen, device="cuda") * 1e-3
           for m in means]
    diag = diag_std_parity(torch, means, sqs, "the ViT's 18 leaves x 8")
    errs["diag_std"] = diag["max_abs_err"]
    diag.update(diag_std_timed(torch, means, sqs))
    mean = torch.cat([m.reshape(P, -1) for m in means], 1)
    sq = torch.cat([s.reshape(P, -1) for s in sqs], 1)
    del means, sqs
    diag["raveled"] = diag_std_parity(torch, [mean], [sq],
                                      f"the raveled {P} x {D}")
    raveled = lambda: swag_moments.diag_std(mean, sq)
    diag["raveled_ms"] = time_ms(torch, raveled)
    diag["raveled_device_ms"] = device_ms(torch, raveled)
    rows.append({"name": "swag_diag_std", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/swag_moments.cu",
                 "replaces": "src/repro/kernels/swag_moments.py:73",
                 "kernel": "diag_std_leaves_kernel",
                 "wrapper": "repro_torch.kernels.swag_moments.diag_std_leaves",
                 **{k: diag[k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by")},
                 "library_ms": None, "vit_leaves": diag})
    del mean, sq
    torch.cuda.empty_cache()
    emit({"phase": 3, "sweep_max_err": sweep, "train_shape": [P, D],
          "train_shape_err": errs, "sqdist_paths": paths,
          "force_paths": force_paths,
          "sqdist_probe": probe,
          "timed": {r["name"]: {k: r[k] for k in ("ms", "plain_ms",
                                                  "bound_ms", "library_ms")}
                    for r in rows},
          "force_vs_columns": rows[1]["vs_columns"],
          "collections": {"vit": rows[2]["vit_collection"],
                          "unet": rows[2]["unet_collection"]},
          "diag_std_leaves": rows[3]["vit_leaves"]})
    return rows


def force_row(torch, theta, grads, glue, mask=None, iters=30):
    """#2 at (theta, grads): the streamed kernel and the column kernel (the
    probe)
    each timed in this call, event ms (L2 flushed) and device ms, beside
    the plain version and the bound (theta and g read, phi written once;
    4 FLOPs a (pair, coordinate)): the kernels line's row."""
    from repro_torch.kernels import ref, svgd_rbf
    n, D = theta.shape
    out = torch.empty_like(theta)
    new = lambda: svgd_rbf.svgd_force(theta, grads, *glue, mask, out=out)
    old = lambda: svgd_rbf.svgd_force_columns(theta, grads, *glue, mask,
                                           out=out)
    b_ms, b_by = bound(3 * n * D * 4, 4 * n * n * D)
    row = {"name": "svgd_force", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/svgd_rbf.cu",
           "replaces": "src/repro/kernels/svgd_rbf.py:76",
           "ms": time_ms(torch, new, iters=iters),
           "plain_ms": time_ms(torch, lambda: ref.svgd_force(
               theta, grads, *glue, mask), iters=max(iters // 3, 3)),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    plan = svgd_rbf.force_plan_for(theta, grads, out)
    row["vs_columns"] = {
        "shape": [n, D], "path": plan.path, "grid": plan.grid,
        "cols": plan.cols, "blocks_per_sm": plan.blocks_per_sm,
        "ms": row["ms"], "columns_ms": time_ms(torch, old, iters=iters),
        "device_ms": device_ms(torch, new, n=min(iters, 20)),
        "columns_device_ms": device_ms(torch, old, n=min(iters, 20)),
        "bound_ms": b_ms}
    row["vs_columns"]["share_of_bound"] = b_ms / row["ms"]
    row["vs_columns"]["columns_share_of_bound"] = b_ms / row["vs_columns"]["columns_ms"]
    return row


def force_equals_columns(torch, theta, grads, glue, mask=None):
    """Does the streamed force give the column kernel's bits at (theta,
    grads)? Both outputs are held at once: where the card's free memory
    cannot take them (with a tenth to spare) the answer is a string that
    says so, and nothing is run."""
    from repro_torch.kernels import svgd_rbf
    need = 2.2 * theta.numel() * 4
    free = torch.cuda.mem_get_info()[0]
    if free < need:
        return (f"not checked: {free / 1e9:.1f} GB free, two outputs need "
                f"{need / 1e9:.1f} GB")
    new = svgd_rbf.svgd_force(theta, grads, *glue, mask)
    same = torch.equal(new, svgd_rbf.svgd_force_columns(theta, grads, *glue,
                                                     mask))
    del new
    torch.cuda.empty_cache()
    return same


def leaf_shapes(torch, cfg):
    """The shapes of one particle's leaves in the collection's order
    (sorted key paths), from an init on the card."""
    from repro_torch.core.tree import tree_flatten
    from repro_torch.models import api
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    leaves = tree_flatten(api.init_params(gen, cfg), sort_keys=True)[0]
    return [tuple(x.shape) for x in leaves]


def collection_probe(torch, shapes, P=TRAIN_P, R=2, seed=0, raveled=False):
    """#3 over a tree of leaves of ``shapes`` (P rows each; a ring of R
    slots: the bytes moved do not depend on its depth): one collection
    with a dead row (NaN in its theta) through the one-launch kernel, the
    per-leaf kernel and the plain version, each on its own copy of
    the state, bit for bit; then, every row live, each timed (event ms,
    L2 flushed; device ms) beside the bound (mean, sq and theta read,
    mean, sq and the ring's slot written once). With ``raveled``, also the
    per-leaf kernel once over the tree raveled into one (P, D) leaf, out
    of place: the shape #3 was timed at before the one-launch kernel."""
    from repro_torch.kernels import ref, swag_moments
    gen = torch.Generator(device="cuda").manual_seed(seed)
    thetas = [torch.randn((P,) + s, generator=gen, device="cuda") * 0.05
              for s in shapes]
    base = [[t * 1.01 for t in thetas], [t * t + 1e-3 for t in thetas],
            [torch.zeros((P, R) + s, device="cuda") for s in shapes]]
    n = torch.full((P,), 3.0, device="cuda")
    slot = (torch.arange(P, device="cuda") % R).to(torch.int32)
    mask = torch.ones(P, device="cuda")
    mask[P - 1] = 0.0
    for t in thetas:
        t[P - 1] = float("nan")
    sides = {k: [[x.clone() for x in xs] for xs in base]
             for k in ("one", "per_leaf", "plain")}
    one, per, pl = sides["one"], sides["per_leaf"], sides["plain"]
    swag_moments.moments_leaves(one[0], one[1], thetas, n, mask, one[2],
                                slot)
    for m, s, t, d in zip(per[0], per[1], thetas, per[2]):
        swag_moments.moments(m, s, t, n, mask, d, slot, out_mean=m, out_sq=s)
    ref.swag_moments_leaves(pl[0], pl[1], thetas, n, mask, pl[2], slot)
    torch.cuda.synchronize()
    flat = {k: sum(v, []) for k, v in sides.items()}
    err = max(float((a - b).abs().max())
              for a, b in zip(flat["one"], flat["plain"]))
    same = {k: all(torch.equal(a, b) for a, b in zip(flat["one"], flat[k]))
            for k in ("per_leaf", "plain")}
    dead_kept = all(torch.equal(a[P - 1], b[P - 1])
                    for a, b in zip(flat["one"], sum(base, [])))
    del sides, one, per, pl, flat
    if not (err <= 1e-5 and all(same.values()) and dead_kept):
        raise AssertionError(f"collection over {len(shapes)} leaves: err "
                             f"{err}, bit-equal {same}, dead kept "
                             f"{dead_kept}")
    for t in thetas:
        t[P - 1] = 0.0
    m, s, d = base

    def run_one():
        swag_moments.moments_leaves(m, s, thetas, n, None, d, slot)

    def run_per_leaf():
        for a, b, t, r in zip(m, s, thetas, d):
            swag_moments.moments(a, b, t, n, None, r, slot, out_mean=a,
                                 out_sq=b)

    elems = P * sum(int(np.prod(x)) for x in shapes)
    b_ms, b_by = bound(6 * 4 * elems, 7 * elems)
    what = f"collection over {len(shapes)} leaves"
    out = {"leaves": len(shapes), "rows": P, "elements": elems,
           "launches": counted_launches(
               swag_moments.moments_leaves, run_one,
               collect_launches(len(shapes)), what),
           "per_leaf_launches": counted_launches(
               swag_moments.moments, run_per_leaf, len(shapes), what),
           "max_abs_err": err,
           "bit_equal": same, "dead_row_kept": dead_kept,
           "ms": time_ms(torch, run_one),
           "per_leaf_ms": time_ms(torch, run_per_leaf),
           "plain_ms": time_ms(torch, lambda: ref.swag_moments_leaves(
               m, s, thetas, n, None, d, slot), iters=5),
           "device_ms": device_ms(torch, run_one),
           "per_leaf_device_ms": device_ms(torch, run_per_leaf),
           "bound_ms": b_ms, "bound_by": b_by}
    out["share_of_bound"] = b_ms / out["ms"]
    del base, m, s, d
    torch.cuda.empty_cache()
    if raveled:
        t = torch.cat([x.reshape(P, -1) for x in thetas], 1)
        del thetas
        mean, sq = t * 1.01, t * t + 1e-3
        ring = torch.zeros((P, R, t.shape[1]), device="cuda")
        one_leaf = lambda: swag_moments.moments(mean, sq, t, n, None, ring,
                                                slot)
        out["raveled_ms"] = time_ms(torch, one_leaf)
        out["raveled_device_ms"] = device_ms(torch, one_leaf)
        del t, mean, sq, ring
    torch.cuda.empty_cache()
    return out


def diag_std_parity(torch, means, sqs, what):
    """#4 at a path's leaves (each a contiguous (rows, ...) mean and sq):
    the one-launch kernel against the per-leaf kernel, bit for bit, and
    against the plain version, within 1e-5; raises otherwise. These
    launches are not the path's."""
    from repro_torch.kernels import ref, swag_moments
    means = [m.contiguous() for m in means]
    sqs = [s.contiguous() for s in sqs]
    got = swag_moments.diag_std_leaves(means, sqs)
    per_leaf = [swag_moments.diag_std(m, s) for m, s in zip(means, sqs)]
    plain = ref.diag_std_leaves(means, sqs)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, per_leaf))
    err = max(float((a - b).abs().max()) if a.numel() else 0.0
              for a, b in zip(got, plain))
    if not (same and err <= 1e-5):
        raise AssertionError(f"diag_std_leaves at {what}: bit-equal to the "
                             f"per-leaf kernel {same}, err {err}")
    return {"leaves": len(means), "rows": int(means[0].shape[0]),
            "bit_equal_per_leaf": same, "max_abs_err": err}


def diag_std_timed(torch, means, sqs, iters=30, device=True):
    """#4 over a path's leaves timed in one call: the one launch and the
    per-leaf kernel's loop, event ms (L2 flushed before each call) and,
    with ``device``, device ms; the plain version; the bound (mean and sq
    read, the scale written; 4 FLOPs an entry)."""
    from repro_torch.kernels import ref, swag_moments
    one = lambda: swag_moments.diag_std_leaves(means, sqs)
    loop = lambda: [swag_moments.diag_std(m, s) for m, s in zip(means, sqs)]
    elems = sum(m.numel() for m in means)
    b_ms, b_by = bound(3 * 4 * elems, 4 * elems)
    what = f"diag_std over {len(means)} leaves"
    out = {"leaves": len(means), "rows": int(means[0].shape[0]),
           "elements": elems,
           "launches": counted_launches(swag_moments.diag_std_leaves, one,
                                        collect_launches(len(means)), what),
           "per_leaf_launches": counted_launches(swag_moments.diag_std, loop,
                                                 len(means), what),
           "ms": time_ms(torch, one, iters=iters),
           "per_leaf_ms": time_ms(torch, loop, iters=iters),
           "plain_ms": time_ms(torch, lambda: ref.diag_std_leaves(means, sqs),
                               iters=iters),
           "bound_ms": b_ms, "bound_by": b_by}
    if device:
        out["device_ms"] = device_ms(torch, one)
        out["per_leaf_device_ms"] = device_ms(torch, loop)
    out["share_of_bound"] = b_ms / out["ms"]
    return out


def reset_counts():
    from repro_torch.kernels import svgd_rbf, swag_moments
    fns = {**attention_counts(),
           "pairwise_sqdist": svgd_rbf.pairwise_sqdist,
           "svgd_force": svgd_rbf.svgd_force,
           "swag_moments": swag_moments.moments_leaves,
           "swag_diag_std": swag_moments.diag_std_leaves}
    for fn in fns.values():
        fn.launches = 0
    return fns


def read_counts(fns):
    return {k: fn.launches for k, fn in fns.items()}


def train_run(torch, cls, module, cache, epochs, precision=None, **kw):
    """One driven fused run of ``cls`` over TRAIN_P fresh particles (seed
    SEED, the seeded loader, the ``precision`` policy) with ``cache`` on
    the PD's runtime, between a reset and a read of the kernels' launch
    counts. Returns (algorithm, last losses, launches, wall s, cache stats,
    program info, the GB left allocated before it); the peak memory
    statistic starts anew here."""
    from repro_torch.data import DataLoader
    resident = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    algo = cls(module, seed=SEED, backend="compiled", precision=precision)
    algo.push_dist.runtime.cache = cache
    loader = DataLoader(module.cfg, batch_size=TRAIN_B, num_batches=TRAIN_NB,
                        seed=SEED)
    fns = reset_counts()
    t0 = time.perf_counter()
    _, losses = algo.bayes_infer(loader, epochs, num_particles=TRAIN_P, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts(fns)
    if not np.isfinite(losses).all():
        raise AssertionError(f"{cls.__name__} losses {losses}")
    return (algo, losses, got, wall, cache.snapshot_stats(),
            cache.program_costs(), resident)


def one_program_each(mode, stats, info, names):
    """After a fused run: one program per spec, looked up once (a miss)
    and, in the captured run, each a CUDA graph."""
    got = sorted(p["name"] for p in info)
    if got != sorted(names) or stats["misses"] != len(names) \
            or stats["cold_compiles"] != len(names):
        raise AssertionError(f"{mode} run: programs {got}, stats {stats}; "
                             f"want one each of {names}")
    if mode == "captured" and not all(p["graph"] for p in info):
        raise AssertionError(f"captured run left an eager program: {info}")


def program_window(torch, rt, spec, args, track=OURS, n=3, **kw):
    """``profile_steps`` of ``spec``'s program at ``args``, which must be
    the cache's own (a hit: nothing is captured), with its capture time
    and pool bytes beside the profile; ``kw`` goes to profile_steps."""
    cold = rt.cache.snapshot_stats()["cold_compiles"]
    prog = rt.program(spec, *args)
    if rt.cache.snapshot_stats()["cold_compiles"] != cold:
        raise AssertionError(f"{spec.name}: captured again after the run")
    prof = profile_steps(torch, lambda: prog(*args), n=n, track=track, **kw)
    prof["capture_s"], prof["pool_bytes"] = prog.capture_s, prog.pool_bytes
    return prof


def same_runs(runs, what):
    """The captured run's losses and launch counts equal the eager run's."""
    a, b = runs["captured"], runs["eager"]
    if a["last_losses"] != b["last_losses"]:
        raise AssertionError(f"{what} losses: captured {a['last_losses']}, "
                             f"eager {b['last_losses']}")
    same_launches({m: r["launches"] for m, r in runs.items()}, what)


def vit_module():
    """The full-width ViT-MNIST config and its ParticleModule."""
    from repro_torch import configs
    from repro_torch.core import ParticleModule
    from repro_torch.models import api
    cfg = configs.get("vit-mnist")
    return cfg, ParticleModule(init=lambda g: api.init_params(g, cfg),
                               loss=lambda p, b: api.loss_fn(p, b, cfg),
                               forward=lambda p, b: api.forward(p, b, cfg)[0],
                               cfg=cfg)


def phase4(torch):
    """SVGD and MultiSWAG training of full-width ViT-MNIST particles, each
    run captured and then eager, and the MultiSWAG posterior predictive;
    each driven run between a reset and a read of the kernels' launch
    counts."""
    from repro_torch.bdl import MultiSWAG, SteinVGD
    from repro_torch.bdl.svgd import svgd_force, svgd_step_spec
    from repro_torch.bdl.swag import swag_collect
    from repro_torch.core.functional import (ensemble_value_and_grad,
                                             flatten_stacked)
    from repro_torch.core.tree import tree_leaves, to_device
    from repro_torch.data import DataLoader, mnist_like
    from repro_torch.optim import adam
    from repro_torch.runtime import specs
    cfg, module = vit_module()
    P, B, NB = TRAIN_P, TRAIN_B, TRAIN_NB
    out, launches = {"phase": 4, "model": cfg.name, "particles": P,
                     "batch": B, "batches_per_epoch": NB}, {}
    # what the earlier phases left allocated (graph pools, workspaces)
    out["resident_gb_at_start"] = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    peak = 0.0                  # each run restarts the peak statistic
    batch = to_device(next(iter(DataLoader(cfg, batch_size=B, num_batches=1,
                                           seed=7))), "cuda")
    images = mnist_like(np.random.default_rng(1), B, cfg.vocab_size)

    # (a) SteinVGD, median heuristic (with ell = 1 and distances of ~1e5,
    # K would be the identity and the force's off-diagonal work zero);
    # captured, then eager
    svgd_kw = {"lengthscale": 0.0, "lr": 1e-3}
    steps, runs = 2 * NB, {}
    for mode, cache in caches():
        algo, losses, got, wall, stats, info, resident = train_run(
            torch, SteinVGD, module, cache, 2, **svgd_kw)
        if got["pairwise_sqdist"] != steps or got["svgd_force"] != steps:
            raise AssertionError(f"SVGD launches {got}, want {steps} each")
        one_program_each(mode, stats, info, ["svgd_step"])
        row = {"wall_s": wall, "last_losses": losses, "launches": got,
               "cache": stats, "programs": info, "resident_gb": resident}
        store, mask = algo.store, algo.store.active_mask()
        if mode == "captured":
            # one step's force on the same stacked theta, g and mask:
            # kernels vs plain (launches not counted: the run is over)
            params = store.stacked("params")
            grads = ensemble_value_and_grad(module.loss)(params, batch)[1]
            # the matrices alone: an unravel closure would keep its tree
            theta = flatten_stacked(params)[0]
            g = flatten_stacked(grads)[0]
            del grads, params
            row["force_kernel_vs_plain_rel"] = rel_err(
                svgd_force(theta, g, 0.0, mask=mask),
                plain_force(theta, g, 0.0, mask))
            # the repulsive term alone (g = 0), which the driving term
            # swamps
            zeros = torch.zeros_like(g)
            row["repulsive_kernel_vs_plain_rel"] = rel_err(
                svgd_force(theta, zeros, 0.0, mask=mask),
                plain_force(theta, zeros, 0.0, mask))
            if not (row["force_kernel_vs_plain_rel"] < 2e-4
                    and row["repulsive_kernel_vs_plain_rel"] < 2e-4):
                raise AssertionError(f"SVGD step kernel vs plain: {row}")
            del theta, g, zeros
        # a profiled window of the run's own step program
        params = store.checkout("params")
        try:
            prof = program_window(torch, algo.push_dist.runtime,
                                  svgd_step_spec(module.loss, **svgd_kw),
                                  (params, batch, mask))
        finally:
            store.commit("params", params)
        row.update({"step_ms": prof["wall_ms"],
                    "images_per_s": P * B / prof["wall_ms"] * 1e3,
                    "profile": prof,
                    "peak_gb": torch.cuda.max_memory_allocated() / 2**30})
        peak = max(peak, row["peak_gb"])
        runs[mode] = row
        del algo, store, params, cache, mask
        gc.collect()            # the run's PD and its graphs' pools
        torch.cuda.empty_cache()
    same_runs(runs, "SVGD")
    launches["svgd"] = runs["captured"]["launches"]
    out["svgd"] = {"epochs": 2, "steps": steps, **runs}

    # (b) MultiSWAG: adam, 3 epochs, collecting after the first; captured,
    # then eager
    opt = adam(1e-3)
    step_spec = specs.ensemble_step(module.loss, opt)
    collect_spec = specs.map_step(swag_collect, key=("swag_collect",),
                                  n_state=2, masked=True)
    runs = {}
    for mode, cache in caches():
        algo, losses, got, wall, stats, info, resident = train_run(
            torch, MultiSWAG, module, cache, 3, optimizer=opt,
            pretrain_epochs=1, max_rank=20)
        n_leaves = len(tree_leaves(algo.p_parameters()[0]))
        if got["swag_moments"] != 2 * collect_launches(n_leaves):
            raise AssertionError(f"MultiSWAG launches {got} (want "
                                 f"{2 * collect_launches(n_leaves)} "
                                 f"moments)")
        one_program_each(mode, stats, info, ["ensemble_step", "map_step"])
        row = {"wall_s": wall, "last_losses": losses, "launches": got,
               "cache": stats, "programs": info, "resident_gb": resident}
        store, mask = algo.store, algo.store.active_mask()
        if mode == "captured":
            row.update(swag_checks(torch, algo, images, n_leaves, launches))
            row["state_gb"] = sum(store.per_device_bytes(k) for k in
                                  ("params", "opt_state", "swag")) / 1e9
        # p_predict through the runtime: one more program, captured once
        row["predict"] = algo.posterior_pred(images).cpu()
        # profiled windows of the run's own step and collection programs,
        # run last: they advance the trained state
        co = {k: store.checkout(k) for k in ("params", "opt_state", "swag")}
        rt = algo.push_dist.runtime
        try:
            prof = program_window(torch, rt, step_spec,
                                  (co["params"], co["opt_state"], batch,
                                   mask))
            prof_collect = program_window(torch, rt, collect_spec,
                                          (co["swag"], co["params"], mask),
                                          prologue=32, epilogue=32)
        finally:
            for k in co:
                store.commit(k, co[k])
        row.update({"step_ms": prof["wall_ms"],
                    "images_per_s": P * B / prof["wall_ms"] * 1e3,
                    "collect_ms": prof_collect["wall_ms"],
                    "profile_train_step": prof,
                    "profile_collect": prof_collect,
                    "programs_after_predict": rt.cache.program_costs(),
                    "peak_gb": torch.cuda.max_memory_allocated() / 2**30})
        peak = max(peak, row["peak_gb"])
        runs[mode] = row
        del algo, store, co, rt, cache, mask
        gc.collect()
        torch.cuda.empty_cache()
    same_runs(runs, "MultiSWAG")
    pred = {m: r.pop("predict") for m, r in runs.items()}
    if not torch.equal(pred["captured"], pred["eager"]):
        raise AssertionError("p_predict: captured and eager differ by "
                             f"{float((pred['captured'] - pred['eager']).abs().max())}")
    launches["multiswag"] = runs["captured"]["launches"]
    out["multiswag"] = {"epochs": 3, "steps": 3 * NB, "collects": 2,
                        "predict_equal": True, **runs}
    out["launches"] = launches
    out["peak_mem_gb"] = max(peak, torch.cuda.max_memory_allocated() / 2**30)
    emit(out)
    captured = {name: {"step_ms": out[name]["captured"]["step_ms"],
                       "collect_ms": out[name]["captured"].get("collect_ms"),
                       "images_per_s": out[name]["captured"]["images_per_s"],
                       "last_losses": out[name]["captured"]["last_losses"],
                       "profile": out[name]["captured"].get(
                           "profile", out[name]["captured"].get(
                               "profile_train_step"))}
                for name in ("svgd", "multiswag")}
    return ({"pairwise_sqdist": launches["svgd"]["pairwise_sqdist"],
             "svgd_force": launches["svgd"]["svgd_force"],
             "swag_moments": launches["multiswag"]["swag_moments"],
             "swag_diag_std": launches["predictive"]["swag_diag_std"]},
            captured)


def swag_checks(torch, algo, images, n_leaves, launches):
    """On the trained MultiSWAG state: one more collection at the path's
    per-leaf shapes, kernel vs plain; #4 at the handoff's leaves (the
    one launch against the per-leaf kernel and the plain version); the
    posterior predictive with 4 draws per particle (its one diag_std
    launch counted into ``launches["predictive"]``); the same noise
    through the kernel-made and the plain diag_std."""
    from repro_torch.bdl.swag import (_sample, diag_scales,
                                      swag_sample_stacked)
    from repro_torch.core.tree import tree_flatten, tree_map
    from repro_torch.kernels import ref
    from repro_torch.serve import serve
    P = TRAIN_P
    store, mask = algo.store, algo.store.active_mask()
    parity = moments_parity(torch, store.stacked("swag"),
                            store.stacked("params"), mask)
    if not parity["max_abs_err"] <= 1e-5:
        raise AssertionError(f"SWAG collection kernel vs plain: {parity}")
    dense = store.dense("swag")
    diag = diag_std_parity(torch, *(
        tree_flatten(dense[k], sort_keys=True)[0]
        for k in ("mean", "sq_mean")), "the ViT handoff")
    fns = reset_counts()
    svc = algo.posterior_predictive(samples_per_particle=4)
    heads = svc.predict_batch(images)
    torch.cuda.synchronize()
    got = read_counts(fns)
    if got["swag_diag_std"] != collect_launches(n_leaves):
        raise AssertionError(f"predictive launches {got}, want "
                             f"{collect_launches(n_leaves)} diag_std")
    for k, v in heads.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite head {k}")
    if float((heads["mean"].sum(-1) - 1).abs().max()) > 1e-4:
        raise AssertionError("BMA mean probabilities do not sum to 1")
    launches["predictive"] = got
    gen = torch.Generator(device="cuda").manual_seed(3)
    noise = (tree_map(lambda m: torch.randn((P, 4) + tuple(m.shape[1:]),
                                            generator=gen, device="cuda"),
                      dense["mean"]),
             torch.randn((P, 4, 20), generator=gen, device="cuda"))
    pred = {}
    for plain in (False, True):
        with torch.no_grad():
            sampled = (_sample(dense, *noise, 1.0,
                               stds=diag_scales(dense, ref.diag_std_leaves))
                       if plain else swag_sample_stacked(dense, 4,
                                                         noise=noise))
        pred[plain] = serve(algo, params=sampled).predict_batch(images)
        del sampled
    heads_diff = max(float((pred[True][k] - pred[False][k]).abs().max())
                     for k in pred[True])
    if not heads_diff <= 1e-5:
        raise AssertionError(f"predictive heads kernel vs plain: {heads_diff}")
    del svc, dense, pred, noise
    torch.cuda.empty_cache()
    return {"moments_kernel_vs_plain": parity,
            "diag_std_kernel_vs_per_leaf": diag,
            "predictive": {"samples_per_particle": 4, "members": P * 4,
                           "images": TRAIN_B,
                           "entropy_mean": float(heads["entropy"].mean()),
                           "heads_kernel_vs_plain": heads_diff}}


# --------------------------------------------------------------------------
# phase 8: the actor runtime — backend="nel" training of ViT-MNIST particles
# --------------------------------------------------------------------------

NEL_T = 600.0       # seconds any one NEL run or wait may take
# the profiler's names for the training kernels the counters count (the
# sqdist wrapper's second stage is counted with its first)
TRAIN_PROFILER_NAMES = {"pairwise_sqdist": "sqdist_stream_kernel",
                        "svgd_force": "force_stream_kernel",
                        "swag_moments": "moments_leaves_kernel"}


def bounded(fn, *args, timeout=NEL_T, **kw):
    """``fn(*args, **kw)`` on a thread joined within ``timeout`` s: a
    deadlocked protocol fails the phase instead of eating the time
    limit (the thread is a daemon and dies with the process)."""
    import threading
    box = {}

    def run():
        try:
            box["out"] = fn(*args, **kw)
        except BaseException as e:      # re-raised below
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        raise AssertionError(f"{getattr(fn, '__name__', fn)} did not finish "
                             f"within {timeout} s")
    if "err" in box:
        raise box["err"]
    return box["out"]


def train_counts():
    fns = reset_counts()
    return {k: fns[k] for k in TRAIN_PROFILER_NAMES}


def train_kernels_seen(torch, prof, names=TRAIN_PROFILER_NAMES):
    """{counter: launches the profiler saw of its kernel} over a window."""
    seen = dict.fromkeys(names, 0)
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name, part in names.items():
            if part in e.key:
                seen[name] += e.count
    return seen


def hold_train_to_profiler(torch, prof, got, what):
    """The training kernels' counters over a profiled window against the
    launches the profiler saw on the card, exactly."""
    seen = train_kernels_seen(torch, prof)
    if seen != got:
        raise HoldMismatch(what, got, seen)
    return seen


def profiler_start_probe(torch, fn, k=32):
    """Does torch.profiler see the first kernels launched after it
    starts? ``fn`` alone in a fresh profile, then after ``k`` untracked
    spin kernels (``torch.cuda._sleep``): the training counters' launches
    in ``fn`` and what the profiler saw of them and of the spins."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for spins in (0, k):
        fns = train_counts()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(spins):
                torch.cuda._sleep(1000)
            fn()
            torch.cuda.synchronize()
        out[f"after_{spins}_spins"] = {
            "counters": read_counts(fns),
            "profiler": train_kernels_seen(torch, prof),
            "spins_seen": train_kernels_seen(
                torch, prof, {"spin": "spin_kernel"})["spin"]}
    return out


# Adam's first update is g / (|g| + eps) (eps 1e-8) times lr (1e-3). Where
# |g| > G_HOLD = 100 eps, a grad difference dg between the two paths
# moves that update by at most lr * eps * dg / g^2: with dg up to the
# grads' largest difference between the paths on the card (about 1.2e-6)
# that is 1.2e-5, under the 1e-4 the params are held to. Entries at or
# under it may flip the update's sign (a move of up to 2 lr): they are
# counted, not held.
G_HOLD = 1e-6


def one_step_parity(torch, cls, module, batch, **kw):
    """One NEL step and one captured compiled step from the same init
    (seed SEED) on the same host batch. Returns the params' max abs
    difference (with how many entries exceed 1e-4 and the largest |g| of
    the NEL's grads there), the NEL's per-particle grads against one
    batched backward at the same init (the compiled path's), and the
    compiled algorithm, its step program captured once."""
    from repro_torch.core import PushDistribution
    from repro_torch.core.functional import (ensemble_value_and_grad,
                                             flatten_rows, flatten_stacked)
    from repro_torch.core.tree import to_device
    from repro_torch.runtime import ProgramCache
    algos = {}
    for backend in ("nel", "compiled"):
        algo = cls(module, seed=SEED, backend=backend)
        if backend == "compiled":
            algo.push_dist.runtime.cache = ProgramCache()
        bounded(algo.bayes_infer, [batch], 1, num_particles=TRAIN_P, **kw)
        algos[backend] = algo
    nel, comp = algos["nel"], algos["compiled"]
    info = comp.push_dist.runtime.cache.program_costs()
    if not (len(info) == 1 and info[0]["graph"]):
        raise AssertionError(f"{cls.__name__}: compiled step not one "
                             f"captured program: {info}")
    pids = nel.push_dist.particle_ids()
    theta = flatten_rows([nel.push_dist.p_params(p) for p in pids])[0]
    diff = (theta - flatten_rows([comp.push_dist.p_params(p) for p in
                                  comp.push_dist.particle_ids()])[0]).abs()
    del theta
    g = flatten_rows([nel.push_dist.particles[p].gradients()
                      for p in pids])[0]
    over = diff > 1e-4
    held = g.abs() > G_HOLD
    out = {"params_max_abs": float(diff.max()),
           "params_over_1e-4": int(over.sum()),
           "max_abs_grad_where_over": (float(g[over].abs().max())
                                       if bool(over.any()) else 0.0),
           "params_max_abs_where_grad_over_hold": float(diff[held].max()),
           "grad_hold": G_HOLD,
           "entries_at_or_under_hold": int((~held).sum()),
           "entries": int(held.numel())}
    del diff, over, held
    nel.cleanup()
    del nel, algos
    # the compiled path's grads: one batched backward at the same init
    init = PushDistribution(module, seed=SEED, backend="compiled")
    for _ in range(TRAIN_P):
        init.p_create()
    gb = flatten_stacked(ensemble_value_and_grad(module.loss)(
        init.store.dense("params"), to_device(batch, "cuda"))[1])[0]
    out["grads_max_abs"] = float((g - gb).abs().max())
    out["grad_abs_max"] = float(g.abs().max())
    del g, gb, init
    gc.collect()
    torch.cuda.empty_cache()
    return out, comp


def compiled_step_window(torch, comp, spec, keys, batch):
    """``program_window`` of the compiled PD's own step program."""
    store = comp.store
    mask = store.active_mask()
    co = {k: store.checkout(k) for k in keys}
    try:
        prof = program_window(torch, comp.push_dist.runtime, spec,
                              tuple(co[k] for k in keys) + (batch, mask))
    finally:
        for k in keys:
            store.commit(k, co[k])
    return {"step_ms": prof["wall_ms"],
            "images_per_s": TRAIN_P * TRAIN_B / prof["wall_ms"] * 1e3,
            "profile": prof}


def nel_run(torch, cls, module, epochs, **kw):
    """One driven NEL run (backend="nel", the default) of ``cls`` over
    TRAIN_P fresh particles (seed SEED, the seeded loader of P8_NB
    batches an epoch), between a
    reset and a read of the kernels' launch counts. Returns (algorithm,
    last losses, launches, wall s, the GB left allocated before it)."""
    from repro_torch.data import DataLoader
    resident = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    algo = cls(module, seed=SEED)
    if algo.backend != "nel":
        raise AssertionError(f"default backend {algo.backend}")
    loader = DataLoader(module.cfg, batch_size=TRAIN_B,
                        num_batches=P8_NB, seed=SEED)
    fns = reset_counts()
    t0 = time.perf_counter()
    _, losses = bounded(algo.bayes_infer, loader, epochs,
                        num_particles=TRAIN_P, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts(fns)
    if not np.isfinite(losses).all():
        raise AssertionError(f"NEL {cls.__name__} losses {losses}")
    return algo, losses, got, wall, resident


def executor_health(algo, dispatches, pool, threads_before):
    """The protocol's message count, nothing in flight, a fixed thread
    count; returns the executor's and the NEL's counters."""
    pd = algo.push_dist
    pd.drain(NEL_T)
    ex, nel = pd.nel.executor.stats(), dict(pd.nel.stats)
    want = {"dispatched": dispatches, "completed": dispatches,
            "pool_dispatched": pool, "threads": pd.nel.executor.num_threads}
    got = {k: ex[k] for k in want}
    if got != want or nel["dispatches"] != dispatches \
            or nel["xdev_transfers"] != 0:
        raise AssertionError(f"executor {got} / NEL {nel}, want {want}")
    import threading
    if threading.active_count() != threads_before + ex["threads"]:
        raise AssertionError(f"{threading.active_count()} threads, want "
                             f"{threads_before} + {ex['threads']}")
    return {"executor": {k: ex[k] for k in (
                "dispatched", "pool_dispatched", "wait_time_s",
                "run_time_s", "max_queue_depth", "threads")},
            "nel": {k: nel[k] for k in ("dispatches", "xdev_transfers",
                                        "swaps_in", "swaps_out")}}


def predict_parity(torch, algo, images):
    """NelRuntime.predict (per-particle forwards, host average) against
    CompiledRuntime.predict (one captured forward) on the same store:
    their max abs difference."""
    from repro_torch.runtime import CompiledRuntime, ProgramCache
    nel = bounded(algo.posterior_pred, images)
    pd = algo.push_dist
    comp = CompiledRuntime(pd, ProgramCache()).predict(pd, images)
    if not bool(torch.isfinite(nel).all()):
        raise AssertionError("NEL predict is not finite")
    return float((nel - comp).abs().max())


def shut(algo, threads_before):
    """cleanup(): the NEL drains and its workers are joined."""
    import threading
    ex = algo.push_dist.nel.executor
    algo.cleanup()
    alive = [t.name for t in ex._threads if t.is_alive()]
    if alive or threading.active_count() != threads_before:
        raise AssertionError(f"shutdown left {alive} alive")


def nel_window(torch, step, what, failed, images=True):
    """Two NEL steps profiled (``profile_steps``, n = 2, between a
    prologue and an epilogue of 32 spin kernels), the training kernels'
    counters held to the profiler's counts; with ``images`` the rate of a
    train step over P x B images."""
    try:
        prof = profile_steps(torch, lambda: bounded(step), n=2, track=OURS,
                             fns=train_counts(), hold=hold_train_to_profiler,
                             prologue=32, epilogue=32)
    except AssertionError as e:     # the phase fails at its end
        failed.append(f"{what}: {e}")
        prof = profile_steps(torch, lambda: bounded(step), n=2, track=OURS,
                             prologue=32)
    if images:
        prof["images_per_s"] = TRAIN_P * TRAIN_B / prof["wall_ms"] * 1e3
    prof["what"] = what
    return prof


def phase8(torch, captured):
    """DeepEnsemble, SteinVGD and MultiSWAG of full-width ViT-MNIST
    particles with backend="nel" (the default): the executor, the NEL,
    particle messaging and the SVGD leader protocol on the card."""
    import threading
    from repro_torch.bdl import DeepEnsemble, MultiSWAG, SteinVGD
    from repro_torch.bdl.svgd import svgd_force, svgd_step_spec
    from repro_torch.bdl.swag import swag_collect
    from repro_torch.core.functional import flatten_rows
    from repro_torch.core.tree import tree_flatten, tree_leaves, \
        tree_map, to_device
    from repro_torch.data import DataLoader, mnist_like
    from repro_torch.optim import adam, sgd
    from repro_torch.runtime import specs
    cfg, module = vit_module()
    P, B, NB = TRAIN_P, TRAIN_B, P8_NB
    out = {"phase": 8, "model": cfg.name, "particles": P, "batch": B,
           "batches_per_epoch": NB, "backend": "nel", "num_devices": 1,
           "resident_gb": torch.cuda.memory_allocated() / 2**30}
    host_batch = next(iter(DataLoader(cfg, batch_size=B, num_batches=1,
                                      seed=7)))
    batch = to_device(host_batch, "cuda")
    images = mnist_like(np.random.default_rng(1), B, cfg.vocab_size)
    threads = threading.active_count()
    launches, peak, failed = {}, 0.0, []
    opt = adam(1e-3)

    def check(ok, what):
        """A failed check fails the phase at its end, after the rest ran."""
        if not ok:
            failed.append(what)

    # (a) DeepEnsemble. One step with sgd(0.05) is held to 1e-4 on every
    # entry. Adam's first update is g / (|g| + eps), about sign(g), so
    # rounding at a gradient entry near eps (1e-8) may move that
    # parameter by up to 2 lr on one path and not the other: Adam's step
    # is held to 1e-4 where |g| > G_HOLD, and the entries at or under it
    # are counted beside the entries over 1e-4 and the largest |g| among
    # them. Both hold the NEL's grads to one batched backward's within
    # 1e-4.
    row = {}
    for name, o in (("sgd", sgd(0.05)), ("adam", opt)):
        par, comp = one_step_parity(torch, DeepEnsemble, module,
                                    host_batch, optimizer=o)
        row[f"one_step_vs_captured_{name}"] = par
        check(par["grads_max_abs"] < 1e-4, f"DeepEnsemble {name} grads "
              f"{par}")
        if name == "sgd":
            check(par["params_max_abs"] < 1e-4,
                  f"DeepEnsemble sgd one step {par}")
        else:
            check(par["params_max_abs_where_grad_over_hold"] < 1e-4,
                  f"DeepEnsemble adam one step where |g| > {G_HOLD}: {par}")
            row["compiled_captured"] = compiled_step_window(
                torch, comp, specs.ensemble_step(module.loss, o),
                ("params", "opt_state"), batch)
        comp.cleanup()
        del comp
        gc.collect()
        torch.cuda.empty_cache()
    algo, losses, got, wall, resident = nel_run(torch, DeepEnsemble, module,
                                                1, optimizer=opt)
    if any(got.values()):
        raise AssertionError(f"NEL DeepEnsemble launched kernels: {got}")
    row.update({"epochs": 1, "steps": NB, "wall_s": wall,
                "last_losses": losses, "resident_gb": resident,
                **executor_health(algo, NB * P, 0, threads),
                "predict_vs_compiled_max_abs": predict_parity(torch, algo,
                                                              images)})
    pd = algo.push_dist
    pids = pd.particle_ids()

    def de_step():
        futs = [pd.particles[p].step(batch) for p in pids]
        return [float(f.wait()) for f in futs]

    row["nel_step"] = nel_window(torch, de_step, "one step hop a particle",
                                 failed)
    row["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    peak = max(peak, row["peak_gb"])
    shut(algo, threads)
    del algo, pd, de_step
    gc.collect()
    torch.cuda.empty_cache()
    out["deep_ensemble"] = row
    emit({"phase": 8, "part": "deep_ensemble", **row})

    # (b) SteinVGD, the leader protocol, median heuristic, 2 epochs
    svgd_kw = {"lengthscale": 0.0, "lr": 1e-3}
    par, comp = one_step_parity(torch, SteinVGD, module, host_batch,
                                **svgd_kw)
    check(par["params_max_abs"] < 1e-4 and par["grads_max_abs"] < 1e-4,
          f"SteinVGD one step {par}")
    row = {"one_step_vs_captured": par,
           "compiled_captured": compiled_step_window(
               torch, comp, svgd_step_spec(module.loss, **svgd_kw),
               ("params",), batch),
           "phase4_captured": captured["svgd"]}
    comp.cleanup()
    del comp
    gc.collect()
    torch.cuda.empty_cache()
    steps = 2 * NB
    algo, losses, got, wall, resident = nel_run(torch, SteinVGD, module, 2,
                                                **svgd_kw)
    want = {k: 0 for k in got}
    want.update(pairwise_sqdist=steps, svgd_force=steps)
    if got != want:
        raise AssertionError(f"NEL SVGD launches {got}, want {want}")
    launches["svgd"] = got
    # per step: the leader's grad, P - 1 SVGD_STEP sends and their grads,
    # P - 1 gets (on the pool), P - 1 SVGD_FOLLOW sends and their
    # updates, the leader's update; plus the one SVGD_LEADER launch
    row.update({"epochs": 2, "steps": steps, "wall_s": wall,
                "last_losses": losses, "resident_gb": resident,
                "launches": got,
                **executor_health(algo, 1 + steps * (5 * (P - 1) + 2),
                                  steps * (P - 1), threads),
                "predict_vs_compiled_max_abs": predict_parity(torch, algo,
                                                              images)})
    pd = algo.push_dist
    pids = pd.particle_ids()
    # the leader's force once more, at its (P, D) shape: the particles'
    # params and last grads gathered as the leader gathers them, dense
    theta = flatten_rows([pd.p_params(p) for p in pids])[0]
    g = flatten_rows([pd.particles[p].gradients() for p in pids])[0]
    if tuple(theta.shape) != (P, TRAIN_D):
        raise AssertionError(f"leader's theta {tuple(theta.shape)}")
    row["leader_force_vs_plain_rel"] = rel_err(svgd_force(theta, g, 0.0),
                                               plain_force(theta, g, 0.0))
    zeros = torch.zeros_like(g)
    row["leader_repulsive_vs_plain_rel"] = rel_err(
        svgd_force(theta, zeros, 0.0), plain_force(theta, zeros, 0.0))
    check(row["leader_force_vs_plain_rel"] < 2e-4
          and row["leader_repulsive_vs_plain_rel"] < 2e-4,
          f"leader force kernel vs plain: {row}")
    del theta, g, zeros
    torch.cuda.empty_cache()
    leader = pids[0]

    def svgd_step():
        return pd.p_launch(leader, "SVGD_LEADER", svgd_kw["lr"],
                           svgd_kw["lengthscale"], [batch], 1).wait(NEL_T)

    row["nel_step"] = nel_window(torch, svgd_step, "one leader step",
                                 failed)
    row["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    peak = max(peak, row["peak_gb"])
    shut(algo, threads)
    del algo, pd, svgd_step
    gc.collect()
    torch.cuda.empty_cache()
    out["svgd"] = row
    emit({"phase": 8, "part": "svgd", **row})

    # (c) MultiSWAG, Adam, 3 epochs collecting after the first, rank 20
    algo, losses, got, wall, resident = nel_run(
        torch, MultiSWAG, module, 3, optimizer=opt, pretrain_epochs=1,
        max_rank=20)
    pd = algo.push_dist
    pids = pd.particle_ids()
    n_leaves = len(tree_leaves(pd.p_params(pids[0])))
    want = {k: 0 for k in got}
    # P = 1 views: one launch a particle a collection
    want["swag_moments"] = 2 * P * collect_launches(n_leaves)
    if got != want:
        raise AssertionError(f"NEL MultiSWAG launches {got}, want {want}")
    launches["multiswag"] = got
    row = {"epochs": 3, "steps": 3 * NB, "collects": 2, "wall_s": wall,
           "last_losses": losses, "resident_gb": resident,
           "launches": got, "phase4_captured": captured["multiswag"],
           **executor_health(algo, 3 * NB * P + 2 * P, 0, threads),
           "predict_vs_compiled_max_abs": predict_parity(torch, algo,
                                                         images)}
    # one NEL collection against the fused collection on the same state
    store, mask = algo.store, algo.store.active_mask()
    fused = tree_map(torch.clone, store.stacked("swag"))
    swag_collect(fused, store.stacked("params"), mask)
    bounded(pd.p_wait, [pd.p_launch(p, "SWAG_COLLECT") for p in pids],
            NEL_T)
    nel = store.stacked("swag")
    check(torch.equal(nel["rank"], fused["rank"])
          and torch.equal(nel["n"], fused["n"]),
          "NEL vs fused collection: ranks or counts differ")
    row["collect_vs_fused"] = {
        key: max(float((a - b).abs().max()) for a, b in zip(
            tree_flatten(nel[key], sort_keys=True)[0],
            tree_flatten(fused[key], sort_keys=True)[0]))
        for key in ("mean", "sq_mean", "dev")}
    check(max(row["collect_vs_fused"].values()) <= 1e-5,
          f"NEL vs fused collection: {row['collect_vs_fused']}")
    row["rank_after"] = int(nel["rank"][0])
    del fused, nel
    torch.cuda.empty_cache()

    def swag_step():
        futs = [pd.particles[p].step(batch) for p in pids]
        return [float(f.wait()) for f in futs]

    def swag_collection():
        return pd.p_wait([pd.p_launch(p, "SWAG_COLLECT") for p in pids],
                         NEL_T)

    row["nel_step"] = nel_window(torch, swag_step, "one step hop a particle",
                                 failed)
    row["profiler_start_probe"] = profiler_start_probe(
        torch, lambda: bounded(swag_collection))
    row["nel_collect"] = nel_window(torch, swag_collection,
                                    "one SWAG_COLLECT a particle", failed,
                                    images=False)
    row["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    peak = max(peak, row["peak_gb"])
    shut(algo, threads)
    del algo, pd, store, mask, swag_step, swag_collection
    gc.collect()
    torch.cuda.empty_cache()
    out["multiswag"] = row
    emit({"phase": 8, "part": "multiswag", **row})
    out["launches"] = launches
    out["peak_mem_gb"] = peak
    out["threads_after"] = threading.active_count()
    for name in ("deep_ensemble", "svgd", "multiswag"):
        check(out[name]["predict_vs_compiled_max_abs"] < 1e-5,
              f"{name}: NEL vs compiled predict "
              f"{out[name]['predict_vs_compiled_max_abs']}")
    out["failed_checks"] = failed
    emit({k: v for k, v in out.items()
          if k not in ("deep_ensemble", "svgd", "multiswag")})
    if failed:
        raise AssertionError(f"phase 8: {failed}")
    # the step times phase 12's Fig. 4 rows of ViT-MNIST are made of
    de, sv, ms = out["deep_ensemble"], out["svgd"], out["multiswag"]
    steps = {
        "ensemble": {"captured_step_ms": de["compiled_captured"]["step_ms"],
                     "nel_step_ms": de["nel_step"]["wall_ms"],
                     "from": {"captured": "phase 8, the Adam parity PD's "
                                          "captured step",
                              "nel": "phase 8"}},
        "svgd": {"captured_step_ms": captured["svgd"]["step_ms"],
                 "nel_step_ms": sv["nel_step"]["wall_ms"],
                 "from": {"captured": "phase 4", "nel": "phase 8"}},
        "multiswag": {"captured_step_ms": captured["multiswag"]["step_ms"],
                      "captured_collect_ms":
                          captured["multiswag"]["collect_ms"],
                      "nel_step_ms": ms["nel_step"]["wall_ms"],
                      "nel_collect_ms": ms["nel_collect"]["wall_ms"],
                      "from": {"captured": "phase 4", "nel": "phase 8"}}}
    return ({"pairwise_sqdist": launches["svgd"]["pairwise_sqdist"],
             "svgd_force": launches["svgd"]["svgd_force"],
             "swag_moments": launches["multiswag"]["swag_moments"]}, steps)


# --------------------------------------------------------------------------
# phase 9: the particle lifecycle — clone / kill / resample / prune / grow
# under served and trained ensembles, with every step captured
# --------------------------------------------------------------------------

LC_CAPACITY, LC_LIVE = 4, 3          # serving: a step's work as in phase 2
LC_REQS = 4                          # requests per round (phase 2's first)
LC_NB = 2                            # training batches per epoch


def add_counts(total, got):
    for k, v in got.items():
        total[k] = total.get(k, 0) + v


def lc_round(torch, svc, reqs, fns, total):
    """One driven round of ``reqs`` on a running service, between a reset
    and a read of the kernels' counts (added to ``total``). Every request
    must finish with finite heads. Returns the token lists."""
    for fn in fns.values():
        fn.launches = 0
    gens = [h.result(600) for h in
            [svc.generate_async(p, max_new=m) for p, m in reqs]]
    add_counts(total, read_counts(fns))
    for g, (_, m) in zip(gens, reqs):
        if len(g.tokens) != m or not np.isfinite(
                [g.logprobs, g.entropy, g.mutual_info]).all():
            raise AssertionError(f"request: {len(g.tokens)}/{m} tokens or "
                                 f"non-finite heads")
    return [g.tokens for g in gens], [g.logprobs for g in gens]


def clone_copy(torch, store, keys, src, dst):
    """The clone's copies alone (``clone_slot`` of ``keys`` from ``src``
    into ``dst``, the particle re-copied in place): event ms with the L2
    flushed, device busy ms from a profiled window opened by spin kernels
    (the profiler misses the first kernel records after it starts, and a
    copy is a few large kernels), and the byte bound (each key's row read
    once and written once)."""
    def copy():
        for k in keys:
            store.clone_slot(k, src, dst)
    nbytes = sum(store.per_particle_bytes(k) for k in keys)
    b_ms, b_by = bound(2 * nbytes, 0)
    prof = profile_steps(torch, copy, n=5, prologue=32)
    return {"keys": list(keys), "bytes": nbytes,
            "ms": time_ms(torch, copy, iters=10),
            "device_ms": prof["device_busy_ms"], "kernels": prof["kernels"],
            "bound_ms": b_ms, "bound_by": b_by}


def lc_serving(torch, cfg, reqs):
    """Clone and kill under ``step_lock`` between rounds of requests, on
    plain and on speculative serving of qwen1.5-0.5b (capacity 4, 3 live),
    with every step captured at warmup. Returns (summary, launches)."""
    from repro_torch.core import ParticleModule, PushDistribution
    from repro_torch.models import api
    from repro_torch.runtime import ProgramCache, bucket_size
    from repro_torch.serve import serve_decode
    fns, L = attention_counts(), cfg.n_layers
    reqs = reqs[:LC_REQS]
    buckets = sorted({bucket_size(len(p)) for p, _ in reqs})
    module = ParticleModule(init=lambda g: api.init_params(g, cfg), cfg=cfg)
    out, total = {}, {}
    with PushDistribution(module, seed=SEED, capacity=LC_CAPACITY) as pd:
        pids = [pd.p_create() for _ in range(LC_LIVE)]
        for name, spec in (("plain", None), ("speculative", SPEC_K)):
            cache = ProgramCache()
            t0 = time.perf_counter()
            svc = serve_decode(pd, cfg, num_pages=NUM_PAGES,
                               page_size=PAGE_SIZE, max_active=MAX_ACTIVE,
                               warmup_buckets=buckets, speculative=spec,
                               cache=cache)
            warmup_s = time.perf_counter() - t0
            row = {"warmup_s": warmup_s}
            try:
                warm, gen0 = svc.stats(), pd.store.generation()
                seen = {}
                base, base_lp = lc_round(torch, svc, reqs, fns, seen)
                with svc.scheduler.step_lock:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    twin = pd.p_clone(pids[0], jitter=0.01)
                    row["clone_host_ms"] = (time.perf_counter() - t0) * 1e3
                    torch.cuda.synchronize()
                    row["clone_synced_ms"] = (time.perf_counter() - t0) * 1e3
                wide, _ = lc_round(torch, svc, reqs, fns, seen)
                with svc.scheduler.step_lock:
                    row["clone_copy"] = clone_copy(
                        torch, pd.store, ("params", "kv_pages"), pids[0],
                        twin)
                    t0 = time.perf_counter()
                    pd.p_kill(twin)
                    row["kill_host_ms"] = (time.perf_counter() - t0) * 1e3
                back, back_lp = lc_round(torch, svc, reqs, fns, seen)
                if back != base or back_lp != base_lp:
                    raise AssertionError(f"{name}: tokens after the round "
                                         f"trip differ from before it")
                rounds = 3
                if spec:
                    with svc.scheduler.step_lock:
                        t0 = time.perf_counter()
                        pd.p_kill(pids[0])          # the drafting particle
                        row["kill_drafter_host_ms"] = \
                            (time.perf_counter() - t0) * 1e3
                    solo, _ = lc_round(torch, svc, reqs, fns, seen)
                    rounds += 1
                st = svc.stats()
                info = cache.program_costs()
            finally:
                svc.close()
            sp = st["speculative"] or {}
            want = {"flash_attention": L * (st["prefills"]
                                            - warm["prefills"]),
                    "paged_decode_attention": L * (
                        st["engine"].get("draft_iterations", 0)
                        - warm["engine"].get("draft_iterations", 0)
                        if spec else st["steps"] - warm["steps"]),
                    "paged_decode_window_attention": L * sp.get(
                        "verify_calls", 0)}
            got = {k: seen.get(k, 0) for k in want}
            row.update({
                "captures_after_warmup": st["cold_compiles"]
                - warm["cold_compiles"],
                "programs": len(info),
                "graphs": sum(p["graph"] for p in info),
                "pool_bytes_total": sum(p["pool_bytes"] for p in info),
                "generation_before": gen0,
                "generation_after": pd.store.generation(),
                "retired": st["retired"], "used_pages": st["pool"][
                    "used_pages"],
                "tokens_equal_after_round_trip": True,
                "widened_tokens_differ": wide != base,
                "launches": got})
            if spec:
                drafts = [p for p in info if p["name"] == "spec_draft_step"]
                row.update({
                    "slot_uploads": st["engine"]["slot_uploads"],
                    "draft_programs": len(drafts),
                    "draft_pool_bytes": sum(p["pool_bytes"] for p in drafts),
                    "draft_capture_s": sum(p["capture_s"] for p in drafts),
                    "acceptance_rate": sp["acceptance_rate"]})
                if len(drafts) != LC_CAPACITY * SPEC_K:
                    raise AssertionError(f"{len(drafts)} draft programs")
            if (row["captures_after_warmup"] != 0
                    or row["generation_after"] != gen0
                    or row["used_pages"] != 0 or row["graphs"] != len(info)
                    or st["retired"] != rounds * len(reqs) or got != want
                    or (spec and row["slot_uploads"] < 2)):
                raise AssertionError(f"{name} serving under churn: {row}, "
                                     f"launches want {want}")
            out[name] = row
            add_counts(total, got)
            emit({"phase": 9, "part": f"serving_{name}", **row})
            del cache, svc
            gc.collect()
            torch.cuda.empty_cache()
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    return out, total


def lc_kernels_serving(torch, cfg, reqs):
    """#5, #7 and #8 against their plain versions at phase 9's shapes:
    the prefill at P = capacity over a 128-token bucket, the paged decode
    at P = capacity and through the one-particle view at slot 1 (the
    draft slot re-picked after slot 0's kill), the verify window W = 5."""
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import paged_decode_attention as pk
    from repro_torch.kernels import paged_decode_window_attention as wk
    from repro_torch.kernels import ref
    P, H, KVH, hd = LC_CAPACITY, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    lens = [len(p) + m // 2 for p, m in reqs][:MAX_ACTIVE]
    errs = {}
    args = paged_case(torch, 90, P, len(lens), H, KVH, hd, PAGE_SIZE,
                      NUM_PAGES, NUM_PAGES, lens, torch.float32)
    errs["paged_decode_attention"] = check_kernel(
        torch, pk.paged_decode_attention, ref.paged_decode_attention, args,
        lens, 1e-4, "phase 9 paged")
    q, k, v, bt, sl = args
    errs["paged_decode_attention_draft_slot1"] = check_kernel(
        torch, pk.paged_decode_attention, ref.paged_decode_attention,
        (q[1:2], k[1:2], v[1:2], bt, sl), lens, 1e-4, "phase 9 draft view")
    del args, q, k, v
    args = window_case(torch, 91, P, len(lens), SPEC_K + 1, H, KVH, hd,
                       PAGE_SIZE, NUM_PAGES, NUM_PAGES, lens, torch.float32)
    errs["paged_decode_window_attention"] = max_err(
        torch, wk.paged_decode_window_attention(*args),
        ref.paged_decode_window_attention(*args), "phase 9 window", 1e-4)
    del args
    gen = torch.Generator(device="cuda").manual_seed(92)
    q = torch.randn((P, 1, 128, H, hd), generator=gen, device="cuda")
    k, v = (torch.randn((P, 1, 128, KVH, hd), generator=gen, device="cuda")
            for _ in range(2))
    errs["flash_attention"] = max_err(
        torch, fk.flash_attention(q, k, v), ref.flash_attention(q, k, v),
        "phase 9 flash", 2e-5)
    del q, k, v
    torch.cuda.empty_cache()
    return errs


def lc_force_checks(torch, theta, mask, what):
    """#1 and #2 through the kernels against the plain versions on
    ``theta`` with ``mask`` and seeded g (and g = 0): sqdist within 1e-5 of
    its largest entry, the force within 2e-4 relative, dead rows 0."""
    from repro_torch.bdl.svgd import svgd_force
    from repro_torch.kernels import ref, svgd_rbf
    sq = svgd_rbf.pairwise_sqdist(theta, mask)
    want = ref.pairwise_sqdist(theta, mask)
    out = {"sqdist_rel": float((sq - want).abs().max() / want.max())}
    g = torch.randn(theta.shape, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED))
    for name, gg in (("force_rel", g), ("force_g0_rel", torch.zeros_like(g))):
        got = svgd_force(theta, gg, 0.0, mask=mask)
        ref_phi = plain_force(theta, gg, 0.0, mask)
        out[name] = float((got - ref_phi).abs().max()
                          / ref_phi.abs().max())
        if mask is not None and float(got[mask == 0].abs().max()) != 0.0:
            raise AssertionError(f"{what}: dead rows of phi not zero")
    del g, sq, want
    if not (out["sqdist_rel"] < 1e-5 and out["force_rel"] < 2e-4
            and out["force_g0_rel"] < 2e-4):
        raise AssertionError(f"{what}: {out}")
    return out


def slot_rows(torch, store, keys, slot):
    """Device copies of ``slot``'s row of each key (bit-for-bit checks)."""
    from repro_torch.core.tree import tree_map
    return {k: tree_map(lambda a: a[slot].clone(), store.stacked(k))
            for k in keys}


def same_rows(torch, store, rows, slot):
    from repro_torch.core.tree import tree_leaves
    return all(torch.equal(a[slot], b) for k, r in rows.items()
               for a, b in zip(tree_leaves(store.stacked(k)),
                               tree_leaves(r)))


def lc_training(torch):
    """SteinVGD and MultiSWAG of 8 full-width ViT-MNIST particles in a
    store of capacity 8: after two kills and a jittered clone the captured
    fused runs over 7 live reuse their programs and keep the dead slot bit
    for bit; one NEL leader step over the 7 against the captured step;
    the MultiSWAG predictive over the live rows; resample, prune and grow
    within capacity. Returns (summary, launches)."""
    from repro_torch.bdl import MultiSWAG, SteinVGD, lifecycle
    from repro_torch.core.functional import flatten_rows, flatten_stacked
    from repro_torch.core.tree import tree_flatten, tree_map
    from repro_torch.data import DataLoader, mnist_like
    from repro_torch.kernels import ref, swag_moments
    from repro_torch.optim import adam
    from repro_torch.runtime import ProgramCache
    cfg, module = vit_module()
    loader = DataLoader(cfg, batch_size=TRAIN_B, num_batches=LC_NB,
                        seed=SEED)
    batch = next(iter(loader))
    images = mnist_like(np.random.default_rng(1), 64, cfg.vocab_size)
    out, total = {}, {}
    torch.cuda.reset_peak_memory_stats()

    def churn(pd, pids):
        pd.p_kill(pids[1])
        pd.p_kill(pids[5])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clone = pd.p_clone(pids[0], jitter=0.01)
        host = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        synced = (time.perf_counter() - t0) * 1e3
        if pd.store.slot_of(clone) != 1 or pd.store.live_count() != 7:
            raise AssertionError("churn: the clone did not take slot 1")
        return clone, {"clone_host_ms": host, "clone_synced_ms": synced}

    def driven(fn, *args, **kw):
        fns = reset_counts()
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        add_counts(total, read_counts(fns))
        return got

    # (a) SteinVGD, median heuristic
    svgd = SteinVGD(module, seed=SEED, backend="compiled", capacity=8)
    pd, cache = svgd.push_dist, ProgramCache()
    pd.runtime.cache = cache
    pids, _ = svgd.bayes_infer(loader, 1, num_particles=TRAIN_P, lr=1e-3,
                               lengthscale=0.0)
    clone, row = churn(pd, pids)
    dead = slot_rows(torch, pd.store, ("params",), 5)
    misses = cache.snapshot_stats()["misses"]
    losses = driven(svgd._fused_epochs, pd.particle_ids(), loader, 1,
                    lr=1e-3, lengthscale=0.0)
    row["captures_after_churn"] = cache.snapshot_stats()["misses"] - misses
    row["dead_slot_bit_for_bit"] = same_rows(torch, pd.store, dead, 5)
    mask = pd.store.active_mask()
    row["kernels"] = lc_force_checks(
        torch, flatten_stacked(pd.store.stacked("params"))[0], mask,
        "phase 9 SVGD at 8 rows, slot 5 dead")
    # the dead slot reports loss 0: the captured step once more (a hit)
    from repro_torch.bdl.svgd import svgd_step_spec
    co = pd.store.checkout("params")
    try:
        b = svgd._batch(batch)
        prog = pd.runtime.program(svgd_step_spec(module.loss, lr=1e-3,
                                                 lengthscale=0.0),
                                  co, b, mask)
        _, ls = prog(co, b, mask)
        row["dead_slot_loss"] = float(ls[5])
    finally:
        pd.store.commit("params", co)
    # one NEL leader step over the 7 against the captured step from the
    # same params and batch
    theta0 = tree_map(torch.clone, pd.store.stacked("params"))
    leader = pd.particle_ids()[0]
    driven(bounded, lambda: pd.p_wait([pd.p_launch(
        leader, "SVGD_LEADER", 1e-3, 0.0, svgd._on_device([batch]), 1)],
        timeout=NEL_T))
    nel = flatten_rows([pd.p_params(p) for p in pd.particle_ids()])[0]
    tree_map(lambda s, o: s.copy_(o), pd.store.stacked("params"), theta0)
    del theta0
    svgd._fused_epochs(pd.particle_ids(), [batch], 1, lr=1e-3,
                       lengthscale=0.0)
    comp = flatten_rows([pd.p_params(p) for p in pd.particle_ids()])[0]
    row["nel_vs_captured_max_abs"] = float((nel - comp).abs().max())
    row["nel_kernels"] = lc_force_checks(torch, nel, None,
                                         "phase 9 NEL leader, n = 7")
    del nel, comp
    row["captures_total_after_churn"] = \
        cache.snapshot_stats()["misses"] - misses
    # the clone's copies alone, timed last (they overwrite the clone)
    row["clone_copy"] = clone_copy(torch, pd.store, ("params",), pids[0],
                                   clone)
    ok = (row["captures_after_churn"] == 0 and row["dead_slot_bit_for_bit"]
          and row["dead_slot_loss"] == 0.0 and np.isfinite(losses).all()
          and row["nel_vs_captured_max_abs"] < 1e-4
          and row["captures_total_after_churn"] == 0)
    out["svgd"] = row
    emit({"phase": 9, "part": "svgd", **row})
    svgd.cleanup()
    del svgd, pd, cache, prog, co, mask, dead
    gc.collect()
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"phase 9 SVGD under churn: {row}")

    # (b) MultiSWAG, Adam, rank 20, collecting every epoch
    swag = MultiSWAG(module, seed=SEED, backend="compiled", capacity=8)
    pd, cache = swag.push_dist, ProgramCache()
    pd.runtime.cache = cache
    opt = adam(1e-3)
    pids, _ = swag.bayes_infer(loader, 1, num_particles=TRAIN_P,
                               optimizer=opt, max_rank=20)
    clone, row = churn(pd, pids)
    keys = ("params", "opt_state", "swag")
    dead = slot_rows(torch, pd.store, keys, 5)
    misses = cache.snapshot_stats()["misses"]
    losses = driven(swag._fused_epochs, pd.particle_ids(), loader, 2,
                    optimizer=opt)
    row["captures_after_churn"] = cache.snapshot_stats()["misses"] - misses
    row["dead_slot_bit_for_bit"] = same_rows(torch, pd.store, dead, 5)
    del dead
    mask = pd.store.active_mask()
    st = pd.store.stacked("swag")
    m0, s0 = (flatten_stacked(st[k])[0] for k in ("mean", "sq_mean"))
    theta = flatten_stacked(pd.store.stacked("params"))[0]
    mk, sk = m0.clone(), s0.clone()         # #3 as the path runs it
    swag_moments.moments_leaves([mk], [sk], [theta], st["n"], mask)
    mp, sp = ref.swag_moments(m0, s0, theta, st["n"], mask)
    dense = pd.store.dense("swag")
    row["kernels"] = {
        "moments_max_abs": max(float((mk - mp).abs().max()),
                               float((sk - sp).abs().max())),
        "moments_dead_row_kept": bool(torch.equal(mk[5], m0[5])
                                      and torch.equal(sk[5], s0[5])),
        # #4 at the handoff's leaves over the 7 live rows
        "diag_std": diag_std_parity(torch, *(
            tree_flatten(dense[k], sort_keys=True)[0]
            for k in ("mean", "sq_mean")), "phase 9's 7 live rows")}
    del m0, s0, theta, mk, sk, mp, sp, st, dense
    # the predictive over the live rows (store.dense): one diag_std launch
    before = total.get("swag_diag_std", 0)
    svc = driven(swag.posterior_predictive, samples_per_particle=1)
    row["predictive_diag_std_launches"] = \
        total.get("swag_diag_std", 0) - before
    heads = svc.predict_batch(images)
    row["predictive_finite"] = bool(all(
        torch.isfinite(v).all() for v in heads.values()))
    row["predictive_members"] = int(svc.engine._static_mask.numel())
    del svc, heads
    # resample, prune and grow within capacity, then one more fused run
    cap, gen0 = pd.store.capacity, pd.store.generation()
    w = lifecycle.ensemble_weights(swag, batch)
    live_counts = [len(lifecycle.resample(
        swag, w, jitter=0.01, rng=np.random.default_rng(SEED)))]
    live_counts.append(len(lifecycle.prune(swag, 6, batch=batch)))
    lifecycle.grow(swag, 2, batch=batch, optimizer=opt)
    live_counts.append(len(pd.particle_ids()))
    misses = cache.snapshot_stats()["misses"]
    losses2 = driven(swag._fused_epochs, pd.particle_ids(), loader, 1,
                     optimizer=opt)
    row.update({
        "live_counts": live_counts, "capacity": pd.store.capacity,
        "generation_unchanged": pd.store.generation() == gen0,
        "captures_after_policies": cache.snapshot_stats()["misses"] - misses,
        "lifecycle": pd.stats()["lifecycle"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30})
    ids = pd.particle_ids()
    row["clone_copy"] = clone_copy(torch, pd.store, keys, ids[0], ids[1])
    k = row["kernels"]
    ok = (row["captures_after_churn"] == 0 and row["dead_slot_bit_for_bit"]
          and np.isfinite(losses).all() and np.isfinite(losses2).all()
          and k["moments_max_abs"] < 1e-5 and k["moments_dead_row_kept"]
          and k["diag_std"]["max_abs_err"] < 1e-5
          and row["predictive_finite"]
          and row["predictive_members"] == 7
          and row["predictive_diag_std_launches"] == 1
          and live_counts == [7, 6, 8] and pd.store.capacity == cap
          and row["generation_unchanged"]
          and row["captures_after_policies"] == 0)
    out["multiswag"] = row
    emit({"phase": 9, "part": "multiswag", **row})
    swag.cleanup()
    del swag, pd, cache, mask
    gc.collect()
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"phase 9 MultiSWAG under churn: {row}")
    return out, total


def phase9(torch, cfg, reqs):
    """The particle lifecycle on the card (module doc). Returns each
    kernel's launches over phase 9's driven runs."""
    t0 = time.perf_counter()
    errs = lc_kernels_serving(torch, cfg, reqs)
    _, launches = lc_serving(torch, cfg, reqs)
    gc.collect()            # the LM's particles sit in reference cycles
    torch.cuda.empty_cache()
    _, got = lc_training(torch)
    add_counts(launches, got)
    on_path = ("pairwise_sqdist", "svgd_force", "swag_moments",
               "swag_diag_std", "flash_attention", "paged_decode_attention",
               "paged_decode_window_attention")
    missing = [k for k in on_path if not launches.get(k)]
    emit({"phase": 9, "kernel_max_abs_err": errs, "launches": launches,
          "wall_s": time.perf_counter() - t0})
    if missing:
        raise AssertionError(f"phase 9: {missing} never launched")
    return launches


# --------------------------------------------------------------------------
# phase 10: predictive serving — ViT-MNIST MultiSWAG predictions served to
# concurrent single-example requests
# --------------------------------------------------------------------------

SERVE_S = 4                  # SWAG draws per particle: 32 members
SERVE_MAX_BATCH = 32
SERVE_WAIT_MS = 2.0
SERVE_N = 256                # requests per traffic run
SERVE_CLIENTS = 8
SERVE_NB = 2                 # training batches per epoch
SERVE_TOKENS = 5             # ViT-MNIST: 4 patches + the CLS token
HEADS = ("mean", "variance", "entropy", "mutual_info", "expected_entropy")
FLUSH_KEYS = ("requests", "batches", "rows", "padded_rows", "size_flushes",
              "deadline_flushes", "close_flushes", "errors", "h2d_transfers")


def serve_traffic(svc, reqs, clients):
    """``reqs`` through ``svc``: from ``clients`` threads, each submitting
    its share through ``predict_async`` and then waiting on it, or (0)
    from one thread calling ``predict`` (a closed loop: each flush holds
    one row). Returns the predictions in request order and this run's
    numbers: requests/s, latency percentiles and the batcher's counters
    over the run."""
    import threading
    before = svc.stats()
    n_lat = len(svc.batcher.latencies_s())
    out = [None] * len(reqs)
    t0 = time.perf_counter()
    if clients:
        def client(c):
            handles = [(i, svc.predict_async(reqs[i]))
                       for i in range(c, len(reqs), clients)]
            for i, h in handles:
                out[i] = h.result(120.0)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300.0)
    else:
        for i, r in enumerate(reqs):
            out[i] = svc.predict(r, timeout=120.0)
    wall = time.perf_counter() - t0
    st = svc.stats()
    lat = np.array(svc.batcher.latencies_s()[n_lat:]) * 1e3
    row = {k: st[k] - before[k] for k in FLUSH_KEYS}
    row.update({"clients": clients or 1, "wall_s": wall,
                "requests_per_s": len(reqs) / wall,
                "latency_p50_ms": float(np.percentile(lat, 50)),
                "latency_p95_ms": float(np.percentile(lat, 95)),
                "latency_p99_ms": float(np.percentile(lat, 99)),
                "occupancy": row["rows"] / max(1, row["rows"]
                                               + row["padded_rows"]),
                "queue_depth": st["queue_depth"],
                "max_queue_depth": st["max_queue_depth"]})
    if any(o is None for o in out) or row["errors"] or st["queue_depth"]:
        raise AssertionError(f"serving run did not finish clean: {row}")
    # counted where the programs copy: one leaf a request, so one copy a
    # flush; a second copy of the staged batch, or one made before the
    # program, would show here
    if row["h2d_transfers"] != row["batches"]:
        raise AssertionError(f"h2d copies {row['h2d_transfers']} for "
                             f"{row['batches']} flushes of one leaf")
    return out, row


def served_vs_batch(preds, heads):
    """Largest difference of any served head from the same row of one
    ``predict_batch`` over every request."""
    return max(float(np.abs(getattr(p, k) - heads[k][i].cpu().numpy())
                     .max()) for i, p in enumerate(preds) for k in HEADS)


def flush_profile(torch, svc, reqs, B, members):
    """Host ms and device busy ms of one flush of B rows (stage, one BMA
    program, read back), a profiled window opened with spins, beside the
    flush's bounds: the members' params read once, and 2 x params x
    tokens x members x B fp32 operations."""
    xs = reqs[:B]
    prof = profile_steps(torch, lambda: svc.batcher.run_batch(xs), n=5,
                         prologue=32)
    ms, by = bound(members * TRAIN_D * 4,
                   2 * TRAIN_D * SERVE_TOKENS * members * B)
    return {"rows": B, "host_ms": prof["wall_ms"],
            "device_busy_ms": prof["device_busy_ms"],
            "idle_share": prof["idle_share"],
            "top_kernels_ms": prof["top_kernels_ms"],
            "bound_ms": ms, "bound_by": by,
            "bytes_bound_ms": members * TRAIN_D * 4 / HBM_BYTES_PER_S * 1e3,
            "flops_bound_ms": 2 * TRAIN_D * SERVE_TOKENS * members * B
            / FP32_FLOPS_PER_S * 1e3}


def diag_std_serving_shapes(torch, swag, D=TRAIN_D, device=True):
    """#4 at the serving path's two shapes, every leaf: the (8, leaf) dense
    stacks ``posterior_predictive`` reads and the one-particle rows of
    ``sample_predict``, the one launch bit-equal to the per-leaf kernel
    and within 1e-5 of the plain version; then timed at P = 1 (one
    particle's D parameters), the one launch beside the per-leaf loop
    (``diag_std_timed``; device ms with ``device``)."""
    from repro_torch.core.tree import tree_flatten
    means = tree_flatten(swag["mean"], sort_keys=True)[0]
    sqs = tree_flatten(swag["sq_mean"], sort_keys=True)[0]
    parity = {}
    for P in (len(means[0]), 1):
        parity[f"P={P}"] = diag_std_parity(
            torch, [m[:P] for m in means], [s[:P] for s in sqs],
            f"the serving path's P = {P}")
    one = ([m[:1].contiguous() for m in means],
           [s[:1].contiguous() for s in sqs])
    p1 = diag_std_timed(torch, *one, device=device)
    if p1["elements"] != D:
        raise AssertionError(f"a particle holds {p1['elements']} "
                             f"parameters, not {D}")
    return {"max_abs_err": {k: v["max_abs_err"] for k, v in parity.items()},
            "bit_equal_per_leaf": all(v["bit_equal_per_leaf"]
                                      for v in parity.values()),
            "leaves": len(means), "p1": p1}


def sample_predict_check(torch, algo, images, S=2):
    """``MultiSWAG.sample_predict`` over ``images`` (8), S draws a
    particle from noise drawn here (one diag_std launch a particle),
    against a loop of plain draws (the plain diag_std at every draw, past
    the kernel's dispatch) and forwards on the same noise. Returns the
    largest difference and the driven launches."""
    from repro_torch.bdl.swag import _sample, diag_scales
    from repro_torch.core.tree import to_device, tree_leaves, tree_map
    from repro_torch.kernels import ref
    pd = algo.push_dist
    gen = torch.Generator(device="cuda").manual_seed(5)
    noise = []
    for pid in pd.particle_ids():
        swag = pd.particles[pid].state["swag"]
        for _ in range(S):
            noise.append((tree_map(lambda m: torch.randn(
                m.shape, generator=gen, device="cuda"), swag["mean"]),
                torch.randn(tree_leaves(swag["dev"])[0].shape[0],
                            generator=gen, device="cuda")))
    fns = reset_counts()
    got = algo.sample_predict(images, samples_per_particle=S, noise=noise)
    torch.cuda.synchronize()
    launches = read_counts(fns)
    batch = to_device(images, "cuda")
    total, draws = None, iter(noise)
    with torch.no_grad():
        for pid in pd.particle_ids():
            swag = pd.particles[pid].state["swag"]
            one = tree_map(lambda x: x[None], swag)
            for _ in range(S):
                z1, z2 = next(draws)
                theta = tree_map(lambda x: x[0], _sample(
                    one, tree_map(lambda z: z[None, None], z1),
                    z2[None, None], 1.0,
                    stds=diag_scales(one, ref.diag_std_leaves)))
                out = algo.module._forward(theta, batch)
                total = out if total is None else total + out
    want = total / (len(pd.particle_ids()) * S)
    return float((got - want).abs().max()), launches, tuple(got.shape)


def phase10(torch):
    """Predictive serving on the card (module doc). Returns each kernel's
    launches over phase 10's driven runs."""
    import threading
    from repro_torch.bdl import MultiSWAG
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import DataLoader, mnist_like
    from repro_torch.optim import adam
    from repro_torch.runtime import ProgramCache, eager
    from repro_torch.serve import serve
    t_start = time.perf_counter()
    cfg, module = vit_module()
    P, S = TRAIN_P, SERVE_S
    members = P * S
    out = {"phase": 10, "model": cfg.name, "particles": P,
           "samples_per_particle": S, "members": members,
           "max_batch": SERVE_MAX_BATCH, "max_wait_ms": SERVE_WAIT_MS,
           "resident_gb_at_start": torch.cuda.memory_allocated() / 2**30}
    torch.cuda.reset_peak_memory_stats()
    launches = {}

    # phase 4's MultiSWAG store is gone by now (phase 4 frees each run
    # before the next, to keep the peak down): train 8 particles anew,
    # Adam, rank 20, 3 epochs of 2 batches, collecting after the first
    opt = adam(1e-3)
    algo = MultiSWAG(module, seed=SEED, backend="compiled")
    algo.push_dist.runtime.cache = ProgramCache()
    loader = DataLoader(cfg, batch_size=TRAIN_B, num_batches=SERVE_NB,
                        seed=SEED)
    fns = reset_counts()
    t0 = time.perf_counter()
    _, losses = algo.bayes_infer(loader, 3, num_particles=P, optimizer=opt,
                                 pretrain_epochs=1, max_rank=20)
    torch.cuda.synchronize()
    add_counts(launches, read_counts(fns))
    out["train"] = {"epochs": 3, "batches_per_epoch": SERVE_NB,
                    "wall_s": time.perf_counter() - t0,
                    "last_losses": losses, "launches": read_counts(fns),
                    "why": "phase 4's trained MultiSWAG is released before "
                           "phase 8; phase 10 trains its own"}
    if not np.isfinite(losses).all():
        raise AssertionError(f"MultiSWAG losses {losses}")
    n_leaves = len(tree_leaves(algo.p_parameters()[0]))
    if launches.get("swag_moments") != 2 * collect_launches(n_leaves):
        raise AssertionError(f"training launches {launches}")

    rng = np.random.default_rng(11)
    data = mnist_like(rng, SERVE_N, cfg.vocab_size)
    images = data["images"]
    reqs = [{"images": im} for im in images]

    # (a) posterior_predictive(S=4): sampling (one diag_std launch over the
    # dense (8, ·) stacks of every leaf), warmup captures buckets 1-32 on
    # this thread from one request; then the concurrent and the
    # closed-loop traffic
    fns = reset_counts()
    t0 = time.perf_counter()
    svc = algo.posterior_predictive(samples_per_particle=S,
                                    max_batch=SERVE_MAX_BATCH,
                                    max_wait_ms=SERVE_WAIT_MS,
                                    warmup=reqs[0])
    torch.cuda.synchronize()
    got = read_counts(fns)
    add_counts(launches, got)
    if got["swag_diag_std"] != collect_launches(n_leaves) \
            or got["swag_moments"]:
        raise AssertionError(f"predictive launches {got}")
    row = {"handoff_s": time.perf_counter() - t0, "launches": got,
           "static_tree_gb": members * TRAIN_D * 4 / 1e9}
    try:
        cache = svc.engine.cache
        warm = cache.snapshot_stats()
        info = cache.program_costs()
        row["warmup"] = {"programs": len(info), "cache": warm,
                         "by_bucket": [
                             {"bucket": 2**i, "graph": p["graph"],
                              "capture_s": p["capture_s"],
                              "pool_bytes": p["pool_bytes"]}
                             for i, p in enumerate(info)]}
        if len(info) != 6 or not all(p["graph"] for p in info):
            raise AssertionError(f"warmup programs {info}")
        conc, row["concurrent"] = serve_traffic(svc, reqs, SERVE_CLIENTS)
        closed, row["closed_loop"] = serve_traffic(svc, reqs, 0)
        after = cache.snapshot_stats()
        extra = after["cold_compiles"] - warm["cold_compiles"]
        if extra:
            raise AssertionError(f"{extra} captures after warmup")
        row["captures_after_warmup"] = 0
        row["profile"] = {f"bucket_{B}": flush_profile(torch, svc, reqs, B,
                                                       members)
                          for B in (1, SERVE_MAX_BATCH)}
        heads = svc.predict_batch({"images": images})
        row["served_vs_predict_batch"] = {
            "concurrent": served_vs_batch(conc, heads),
            "closed_loop": served_vs_batch(closed, heads)}
        if not max(row["served_vs_predict_batch"].values()) <= 1e-5:
            raise AssertionError(f"served vs predict_batch: "
                                 f"{row['served_vs_predict_batch']}")
        # the same concurrent run through an eager cache, on the same tree
        esvc = serve(algo, params=svc.engine._static_params,
                     max_batch=SERVE_MAX_BATCH, max_wait_ms=SERVE_WAIT_MS,
                     cache=ProgramCache(capturer=eager), warmup=reqs[0])
        try:
            eager_preds, row["eager_concurrent"] = serve_traffic(
                esvc, reqs, SERVE_CLIENTS)
            row["eager_vs_predict_batch"] = served_vs_batch(eager_preds,
                                                            heads)
            if not row["eager_vs_predict_batch"] <= 1e-5:
                raise AssertionError(f"eager served vs predict_batch: "
                                     f"{row['eager_vs_predict_batch']}")
        finally:
            esvc.close()
        row["stats"] = svc.stats()
        row["entropy_mean"] = float(heads["entropy"].mean())
    finally:
        svc.close()     # the engine lets its 2.53 GB tree go
    out["predictive"] = row

    # (b) #4 at the serving shapes, then sample_predict (8 images, S = 2)
    out["diag_std"] = diag_std_serving_shapes(torch, algo.store.dense("swag"))
    err, got, shape = sample_predict_check(
        torch, algo, {"images": images[:8]})
    add_counts(launches, got)
    if got["swag_diag_std"] != P * collect_launches(n_leaves) \
            or got["swag_moments"]:
        raise AssertionError(f"sample_predict launches {got}")
    if not err <= 1e-5:
        raise AssertionError(f"sample_predict vs plain loop: {err}")
    out["sample_predict"] = {"images": 8, "samples_per_particle": 2,
                             "launches": got, "max_abs_err": err,
                             "shape": shape}

    # (c) the store's own params behind the batcher; a p_kill under
    # traffic serves the 7 live rows' BMA with no capture
    pd = algo.push_dist
    row = {}
    with serve(algo, max_batch=8, max_wait_ms=SERVE_WAIT_MS,
               warmup=reqs[0]) as ssvc:
        cold = ssvc.engine.cache.snapshot_stats()["cold_compiles"]
        gen = pd.store.generation()
        handles = []

        def client():
            for r in reqs[:128]:
                handles.append(ssvc.predict_async(r))

        t = threading.Thread(target=client)
        t.start()
        while len(handles) < 64:
            time.sleep(0.0005)
        pd.p_kill(pd.particle_ids()[3])
        t.join(120.0)
        for h in handles:
            h.result(120.0)
        post = [ssvc.predict(r, timeout=120.0) for r in reqs[:8]]
        st = ssvc.stats()
        heads, outs = ssvc.predict_batch({"images": images[:8]},
                                         members=True)
        bma = torch.softmax(outs.float(), -1).mean(0).cpu().numpy()
        row = {"live": pd.store.live_count(), "member_rows": outs.shape[0],
               "captures_after_warmup_and_kill":
                   st["engine"]["program_cache"]["cold_compiles"] - cold,
               "generation_unchanged": pd.store.generation() == gen,
               "errors": st["errors"], "requests": st["requests"],
               "post_kill_vs_members_bma": max(
                   float(np.abs(p.mean - bma[i]).max())
                   for i, p in enumerate(post))}
        if row["captures_after_warmup_and_kill"] or not \
                row["generation_unchanged"] or row["errors"] or \
                row["member_rows"] != P - 1 or \
                not row["post_kill_vs_members_bma"] <= 1e-5:
            raise AssertionError(f"store-backed serving under churn: {row}")
        del heads, outs
    out["store_serving"] = row

    # (d) F1 on the card: a particle created in the killed one's slot
    # holds params but no SWAG state, so dense("swag") must raise
    pd.p_create(opt)
    try:
        algo.store.dense("swag")
    except KeyError as e:
        out["f1_dense_raises"] = str(e)
    else:
        raise AssertionError("dense('swag') handed back a dead row")
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - t_start
    emit(out)
    algo.cleanup()
    return launches, out["diag_std"], out["predictive"]


# --------------------------------------------------------------------------
# phase 11: the precision ladder
# --------------------------------------------------------------------------

BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 on the tensor cores
P11_NEW = 8                      # dense-cache steps in (a) and (b)
# a bf16 computation rounds every product to 8 bits of mantissa: two
# programs that order a sum differently (a W-row verify GEMM against a
# 1-row decode GEMV) may split a greedy token where the top-2 gap is within
# a few roundings, as fp32 programs may within 1e-4 (phase 6)
BF16_TIE = 3e-2
FP32_TOLS = {"paged": 1e-4, "window": 1e-4, "flash": 2e-5, "decode": 2e-5}
BF16_TOL = 2e-2                  # phase 5's bf16 bar (one bf16 rounding)
# a served row under a bf16 policy against the same row of one
# predict_batch: the bucket's bf16 GEMMs round otherwise than the batch's
BF16_SERVED_TOL = 1e-2
# the int8 draft's acceptance over particles that share one weight set:
# int8 rounding flips some near-ties (a correct draft: ~0.8 on these
# random weights), a draft of garbage gets ~0 and one of another random
# particle ~0.11 (phase 6)
ACCEPT_INT8 = 0.5


def unit0(tree, key):
    """Layer 0 of the stacked units' ``key`` subtree (particle axis kept)."""
    from repro_torch.core.tree import tree_map
    return tree_map(lambda a: a[:, 0], tree["units"][0][key])


def tree_gb(tree):
    from repro_torch.core.tree import tree_leaves
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)) / 1e9


def dense_prompts(torch, cfg):
    rng = np.random.default_rng(2)
    return torch.as_tensor(rng.integers(1, cfg.vocab_size,
                                        (DENSE_PROMPTS, DENSE_LEN)),
                           dtype=torch.int32, device="cuda")


def timed_row(torch, fn, plain, lib, nbytes, flops, rate):
    """Event ms (L2 flushed) and device ms of ``fn``, its plain version's
    and one SDPA call's (``lib``), beside the bound."""
    b_ms, b_by = bound(nbytes, flops, rate)
    return {"ms": time_ms(torch, fn), "device_ms": device_ms(torch, fn),
            "plain_ms": time_ms(torch, plain, iters=10),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(torch, lib),
            "library_device_ms": device_ms(torch, lib)}


def step_kernel_checks(torch, pd, cfg, params, prompts, n_pmax, tols,
                       timed=False):
    """#5-#8 against their plain versions on the layer-0 inputs of one
    freshly prefilled step through ``params`` (the serve copy, or the bf16
    masters), in ``cfg.dtype``: the paged decode of each prompt's next
    token (its K/V written first), a W = SPEC_K + 1 verify window after
    it, the prefill of the first prompt at its bucket, and a dense-cache
    decode step after a prefill of the DENSE prompts. ``tols`` by kernel.
    With ``timed``, each kernel's timed row (``timed_row``) with SDPA at
    the same shapes and dtypes. Returns (errors, rows)."""
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import paged_decode_attention as pk
    from repro_torch.kernels import paged_decode_window_attention as wk
    from repro_torch.kernels import ref
    from repro_torch.models import api
    from repro_torch.models.blocks import (attn_qkv, norm_apply,
                                           paged_write_index,
                                           window_write_index, write_kv)
    from repro_torch.runtime import bucket_size
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dt = getattr(torch, cfg.dtype)
    attn0, ln0 = unit0(params, "attn"), unit0(params, "ln1")
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    W = SPEC_K + 1
    errs, rows = {}, {}
    pages = pd.store.checkout("kv_pages")
    try:
        _, _, bt, tok, sl = prefilled_rows(torch, pd, cfg, prompts, n_pmax,
                                           pages, params=params)
        pool = {"k": pages["units"][0]["k"][:, 0],
                "v": pages["units"][0]["v"][:, 0]}
        esz = pool["k"].element_size()
        P, B, lens = pool["k"].shape[0], len(prompts), sl.tolist()
        scratch = api.scratch_page(pages)
        # #7: the next token's q, its K/V written at its slot first
        x = norm_apply(ln0, api._embed(params, tok[:, None], dt))
        q, k, v = attn_qkv(attn0, x, cfg, sl[:, None])
        write_kv(pool, k[:, :, 0], v[:, :, 0],
                 paged_write_index(bt, sl, PAGE_SIZE, scratch))
        pargs = (q[:, :, 0].contiguous(), pool["k"], pool["v"], bt, sl)
        errs["paged"] = max_err(torch, pk.paged_decode_attention(*pargs),
                                ref.paged_decode_attention(*pargs),
                                "paged step", tols["paged"])
        # #8: a window of the token and W - 1 drafts after it
        gen = torch.Generator(device="cuda").manual_seed(5)
        win = torch.randint(1, cfg.vocab_size, (B, W), generator=gen,
                            device="cuda", dtype=torch.int32)
        win[:, 0] = tok
        pos = sl[:, None] + torch.arange(W, device="cuda")
        xw = norm_apply(ln0, api._embed(params, win, dt))
        qw, kw, vw = attn_qkv(attn0, xw, cfg, pos)
        write_kv(pool, kw, vw, window_write_index(
            bt, sl, torch.full_like(sl, W), W, PAGE_SIZE, scratch))
        wargs = (qw.contiguous(), pool["k"], pool["v"], bt, sl)
        errs["window"] = max_err(
            torch, wk.paged_decode_window_attention(*wargs),
            ref.paged_decode_window_attention(*wargs), "window step",
            tols["window"])
        # #5: the first prompt's prefill at its bucket
        n = len(prompts[0])
        Sp = bucket_size(n)
        toks = torch.zeros((1, Sp), dtype=torch.int32, device="cuda")
        toks[0, :n] = torch.tensor(prompts[0], dtype=torch.int32)
        xp = norm_apply(ln0, api._embed(params, toks, dt))
        fargs = attn_qkv(attn0, xp, cfg, torch.arange(Sp, device="cuda"))
        fargs = tuple(t.contiguous() for t in fargs)
        errs["flash"] = max_err(torch, fk.flash_attention(*fargs),
                                ref.flash_attention(*fargs), "prefill step",
                                tols["flash"])
        # #6: a dense-cache step after a prefill of the DENSE prompts
        dtoks = dense_prompts(torch, cfg)
        C, cur = DENSE_LEN + P11_NEW + 1, DENSE_LEN - 1
        with torch.no_grad():
            caches = api.prefill(params, {"tokens": dtoks[:, :-1]}, cfg,
                                 max_len=C)[1]
        c0 = caches["units"][0]
        kc, vc, kpos = c0["k"][:, 0], c0["v"][:, 0], c0["pos"][0]
        xd = norm_apply(ln0, api._embed(params, dtoks[:, -1:], dt))
        qd, kd1, vd1 = attn_qkv(attn0, xd, cfg, torch.full(
            (DENSE_PROMPTS, 1), cur, device="cuda"))
        kc[:, :, cur] = kd1[:, :, 0].to(kc.dtype)
        vc[:, :, cur] = vd1[:, :, 0].to(vc.dtype)
        kpos[:, cur] = cur
        dargs = (qd[:, :, 0].contiguous(), kc, vc, kpos)
        errs["decode"] = max_err(torch, dk.decode_attention(*dargs),
                                 ref.decode_attention(*dargs),
                                 "dense step", tols["decode"])
        if timed:
            qe = pargs[0].element_size()
            gqa = H != KVH
            live = sum(L + 1 for L in lens)
            n_bt = sum(L // PAGE_SIZE + 1 for L in lens)
            kg, vg, mask = gathered(torch, pool["k"], pool["v"], bt, sl,
                                    lens, 1)
            q1 = pargs[0].reshape(P * B, H, 1, hd)
            rows["paged_decode_attention"] = timed_row(
                torch, lambda: pk.paged_decode_attention(*pargs),
                lambda: ref.paged_decode_attention(*pargs),
                lambda: sdpa(q1, kg, vg, attn_mask=mask, enable_gqa=gqa),
                P * live * KVH * hd * 2 * esz + 2 * pargs[0].numel() * qe
                + 4 * (n_bt + B), 4 * P * live * H * hd, FP32_FLOPS_PER_S)
            kg, vg, mask = gathered(torch, pool["k"], pool["v"], bt, sl,
                                    lens, W)
            qw1 = wargs[0].permute(0, 1, 3, 2, 4).reshape(P * B, H, W, hd)
            pairs = sum(W * L + W * (W + 1) // 2 for L in lens)
            live = sum(L + W for L in lens)
            n_bt = sum((L + W - 1) // PAGE_SIZE + 1 for L in lens)
            rows["paged_decode_window_attention"] = timed_row(
                torch, lambda: wk.paged_decode_window_attention(*wargs),
                lambda: ref.paged_decode_window_attention(*wargs),
                lambda: sdpa(qw1, kg, vg, attn_mask=mask, enable_gqa=gqa),
                P * live * KVH * hd * 2 * esz + 2 * wargs[0].numel() * qe
                + 4 * (n_bt + B), 4 * P * pairs * H * hd, FP32_FLOPS_PER_S)
            qf, kf, vf = (t[:, 0].transpose(1, 2).contiguous()
                          for t in fargs)
            rows["flash_attention"] = timed_row(
                torch, lambda: fk.flash_attention(*fargs),
                lambda: ref.flash_attention(*fargs),
                lambda: sdpa(qf, kf, vf, is_causal=True, enable_gqa=gqa),
                (fargs[0].numel() * 2 + fargs[1].numel() * 2) * qe,
                4 * P * H * hd * Sp * (Sp + 1) // 2, BF16_FLOPS_PER_S)
            Bd = DENSE_PROMPTS
            kdd = kc.reshape(P * Bd, C, KVH, hd).transpose(1, 2).contiguous()
            vdd = vc.reshape(P * Bd, C, KVH, hd).transpose(1, 2).contiguous()
            qdd = dargs[0].reshape(P * Bd, H, 1, hd)
            dmask = (kpos >= 0)[None].expand(P, Bd, C).reshape(P * Bd, 1, 1, C)
            valid = int((kpos >= 0).sum())
            rows["decode_attention"] = timed_row(
                torch, lambda: dk.decode_attention(*dargs),
                lambda: ref.decode_attention(*dargs),
                lambda: sdpa(qdd, kdd, vdd, attn_mask=dmask,
                                  enable_gqa=gqa),
                P * valid * KVH * hd * 2 * kc.element_size()
                + 2 * dargs[0].numel() * qe + kpos.numel() * 4,
                4 * P * valid * H * hd, FP32_FLOPS_PER_S)
            shapes = {"P": P, "B": B, "W": W, "prefill_S": Sp,
                      "dense_B": Bd, "dense_C": C, "dense_valid": valid,
                      "seq_lens": lens, "dtype": cfg.dtype}
            rows = {k: dict(v, max_abs_err=errs[n], shapes=shapes)
                    for (k, v), n in zip(rows.items(),
                                         ("paged", "window", "flash",
                                          "decode"))}
    finally:
        pd.store.commit("kv_pages", pages)
    torch.cuda.empty_cache()
    return errs, rows


def speculative_launches(st, warm, got, L, what):
    """Phase 6's launch rule over one speculative run."""
    ss = st["speculative"]
    iters = (st["engine"]["draft_iterations"]
             - warm["engine"]["draft_iterations"])
    want = {"paged_decode_window_attention": L * ss["verify_calls"],
            "paged_decode_attention": L * iters,
            "flash_attention": L * st["prefills"], "decode_attention": 0}
    if got != want or ss["verify_calls"] == 0:
        raise AssertionError(f"{what} launches {got}, want {want}")
    return iters


def plain_launches(st, got, L, what):
    """Phase 2's launch rule over one plain run."""
    want = {"paged_decode_attention": L * st["steps"],
            "paged_decode_window_attention": 0,
            "flash_attention": L * st["prefills"], "decode_attention": 0}
    if got != want or st["steps"] == 0:
        raise AssertionError(f"{what} launches {got}, want {want}")


def ladder_serving(torch, pd, cfg, reqs, total, spec_cfgs, plain=True,
                   holds=None, precision=None):
    """serve_decode(precision=) over phase 2's requests on ``pd``, plain
    (unless ``plain`` is False) and then with each of ``spec_cfgs``, each
    through a fresh captured cache; launch counts as phases 2 and 6, every
    program a graph, nothing captured after warmup; ``holds[name]`` runs on
    that run's open service (``serve_requests``). Returns (runs, tokens by
    run)."""
    from repro_torch.runtime import ProgramCache
    fns, L = attention_counts(), cfg.n_layers
    runs, tokens = {}, {}
    holds = holds or {}
    plan = ((("plain", None),) if plain else ()) + tuple(spec_cfgs.items())
    for name, spec in plan:
        cache, info = ProgramCache(), []
        gens, st, got, wall, warm, _ = serve_requests(
            torch, pd, cfg, reqs, fns, cache, info=info,
            hold=holds.get(name), speculative=spec, precision=precision)
        if spec is None:
            plain_launches(st, got, L, f"{name} serving")
            row = run_summary(gens, st, warm, wall, cache, info)
        else:
            iters = speculative_launches(st, warm, got, L, f"{name} serving")
            row = dict(run_summary(gens, st, warm, wall, cache, info),
                       draft_iterations=iters, speculative=st["speculative"])
            row["draft_packs"] = st["engine"]["draft_packs"]
            row["draft_programs"] = sum(p["name"] == "spec_draft_step"
                                        for p in info)
            row["draft_pool_bytes"] = sum(
                p["pool_bytes"] for p in info
                if p["name"] in ("spec_draft_step", "spec_draft_pack"))
            row["pack_programs"] = sum(p["name"] == "spec_draft_pack"
                                       for p in info)
        if not info or not all(p["graph"] for p in info):
            raise AssertionError(f"{name}: a captured step ran eagerly")
        row["kernel_launches"] = got
        add_counts(total, got)
        runs[name], tokens[name] = row, [g.tokens for g in gens]
        del cache
        torch.cuda.empty_cache()
    return runs, tokens


def dense_steps(torch, pd, cfg, total, n=P11_NEW):
    """PredictiveEngine(stateful=True) over the DENSE prompts under the
    store's policy, captured: a prefill, then ``n`` steps (24 dense-decode
    launches a step, 24 prefill launches, one step program, and under a
    casting policy the serve_cast program, each a graph). Returns
    (tokens, launches, the step's profile)."""
    from repro_torch.models import api
    from repro_torch.runtime import ProgramCache
    from repro_torch.serve import PredictiveEngine
    fns, L = attention_counts(), cfg.n_layers
    toks = dense_prompts(torch, cfg)
    C = DENSE_LEN + n + 1

    def fwd(params, caches, batch):
        return api.decode_step(params, batch["token"], caches,
                               batch["cur_pos"], cfg)

    cache = ProgramCache()
    engine = PredictiveEngine(fwd, store=pd.store, stateful=True, cache=cache)
    for fn in fns.values():
        fn.launches = 0
    state = engine.init_state(lambda p: api.prefill(
        p, {"tokens": toks[:, :-1]}, cfg, max_len=C)[1])
    tok, out = toks[:, -1], []
    for step in range(n):
        heads, state = engine.step(state, {"token": tok,
                                           "cur_pos": DENSE_LEN - 1 + step})
        tok = heads["mean"].argmax(-1).to(torch.int32)
        out.append(tok)
    got = read_counts(fns)
    want = {"paged_decode_attention": 0, "paged_decode_window_attention": 0,
            "flash_attention": L, "decode_attention": L * n}
    info = cache.program_costs()
    steps = [p for p in info if p["name"] == "bma_step"]
    if got != want or len(steps) != 1 or not all(p["graph"] for p in info):
        raise AssertionError(f"dense steps: launches {got}, want {want}; "
                             f"programs {info}")
    add_counts(total, got)
    last = tok

    def step():
        engine.step(state, {"token": last, "cur_pos": DENSE_LEN - 1 + n})

    prof = profile_steps(torch, step, n=3, fns=fns)
    tokens = torch.stack(out, 1).cpu().numpy().tolist()
    engine.close()
    del state
    torch.cuda.empty_cache()
    return tokens, got, prof


def churn_rounds(torch, pd, cfg, reqs, total, serve_kw, check_row=None):
    """``churn_on`` a service of its own over LC_REQS requests (warmup
    captures their buckets), closed after."""
    from repro_torch.runtime import ProgramCache, bucket_size
    from repro_torch.serve import serve_decode
    reqs = reqs[:LC_REQS]
    buckets = sorted({bucket_size(len(p)) for p, _ in reqs})
    svc = serve_decode(pd, cfg, num_pages=NUM_PAGES, page_size=PAGE_SIZE,
                       max_active=MAX_ACTIVE, warmup_buckets=buckets,
                       cache=ProgramCache(), **serve_kw)
    try:
        return churn_on(torch, svc, pd, reqs, total, check_row)
    finally:
        svc.close()


def churn_on(torch, svc, pd, reqs, total, check_row=None):
    """Rounds of LC_REQS requests on a running service whose buckets were
    captured at its warmup: a round; ``p_kill`` of the last particle under
    ``step_lock`` and a round; a jittered ``p_clone`` of the first into the
    freed slot and a round; the twin's kill and a round. No capture, no
    generation bump, the pool drained, every program a graph, the served
    params at fixed addresses; ``check_row(engine, twin)`` runs after the
    clone. Returns (summary, tokens of the first round, tokens after the
    kill, tokens after the twin's kill)."""
    from repro_torch.core.tree import tree_leaves
    fns = attention_counts()
    reqs = reqs[:LC_REQS]
    cache = svc.engine.cache
    eng = svc.engine
    first, _ = lc_round(torch, svc, reqs, fns, total)
    cold, gen = svc.stats()["cold_compiles"], pd.store.generation()
    served = eng._mask_and_params()[1]
    ptrs = [x.data_ptr() for x in tree_leaves(served)]
    out = {"served_gb": tree_gb(served),
           "masters_gb": pd.store.per_device_bytes("params") / 1e9}
    pids = pd.particle_ids()
    t0 = time.perf_counter()
    with svc.scheduler.step_lock:
        pd.p_kill(pids[-1])
    out["kill_ms"] = (time.perf_counter() - t0) * 1e3
    killed, _ = lc_round(torch, svc, reqs, fns, total)
    t0 = time.perf_counter()
    with svc.scheduler.step_lock:
        twin = pd.p_clone(pids[0], jitter=0.01)
    out["clone_ms"] = (time.perf_counter() - t0) * 1e3
    lc_round(torch, svc, reqs, fns, total)
    if check_row is not None:
        with svc.scheduler.step_lock:
            out.update(check_row(eng, twin))
    with svc.scheduler.step_lock:
        pd.p_kill(twin)
    back, _ = lc_round(torch, svc, reqs, fns, total)
    st = svc.stats()
    out.update({
        "captures_after_warmup_and_churn": st["cold_compiles"] - cold,
        "generation_unchanged": pd.store.generation() == gen,
        "served_addresses_kept": [x.data_ptr() for x in tree_leaves(
            eng._mask_and_params()[1])] == ptrs,
        "pool_pages_used": st["pool"]["used_pages"],
        "all_graphs": all(p["graph"] for p in cache.program_costs())})
    if "draft_packs" in st["engine"]:
        out["draft_packs"] = st["engine"]["draft_packs"]
    if out["captures_after_warmup_and_churn"] or not (
            out["generation_unchanged"] and out["served_addresses_kept"]
            and out["all_graphs"]) or out["pool_pages_used"]:
        raise AssertionError(f"churn under the ladder: {out}")
    return out, first, killed, back


def drafter_kill(torch, svc, pd, reqs, total):
    """Kill the int8 draft's particle (the first live slot) under
    ``step_lock`` and serve a round: the draft moves to the next live slot,
    one more pack is built, nothing is captured, and the draft row is the
    bf16 dequantization of ``quantize_int8`` of that slot's serve-copy row,
    bit for bit (held in the config's fp32)."""
    from repro_torch.core import precision as prec
    from repro_torch.core.tree import tree_leaves, tree_map
    eng = svc.engine
    before = svc.stats()
    with svc.scheduler.step_lock:
        pd.p_kill(pd.particle_ids()[0])
    lc_round(torch, svc, reqs[:LC_REQS], attention_counts(), total)
    after = svc.stats()
    with svc.scheduler.step_lock:
        slot = eng.pick_draft_slot(eng.active_mask())
        served = eng._mask_and_params()[1]
        want = prec.quantize_int8(tree_map(lambda a: a[slot:slot + 1],
                                           served))
        pack, row = eng._pack[0], eng._pack[1]
        same_pack = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(pack), tree_leaves(want)))
        same_row = all(a.dtype == torch.float32 and torch.equal(
            a, b.float()) for a, b in zip(
                tree_leaves(row),
                tree_leaves(prec.dequantize(want, torch.bfloat16))))
        del want
    out = {"draft_slot": slot, "pack_equal": same_pack,
           "row_equal": same_row,
           "draft_packs": after["engine"]["draft_packs"]
           - before["engine"]["draft_packs"],
           "captures": after["cold_compiles"] - before["cold_compiles"]}
    if not (slot > 0 and same_pack and same_row and out["draft_packs"] == 1
            and out["captures"] == 0):
        raise AssertionError(f"the int8 draft after its drafter's kill: "
                             f"{out}")
    return out


def phase11_mixed(torch, cfg, reqs, card):
    """(a) full-width qwen1.5-0.5b, 4 particles, precision="mixed"."""
    from repro_torch.core import ParticleModule, PushDistribution
    from repro_torch.core import precision as prec
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.models import api
    from repro_torch.runtime import ProgramCache, specs
    from repro_torch.serve import SpecConfig
    from repro_torch.serve.engine import sample_heads
    total = {}
    torch.cuda.reset_peak_memory_stats()
    module = ParticleModule(init=lambda g: api.init_params(g, cfg), cfg=cfg)
    out = {"phase": 11, "part": "a", "model": cfg.name, "precision": "mixed",
           "particles": PARTICLES, "capacity": PARTICLES, "card": card}
    with PushDistribution(module, seed=SEED, capacity=PARTICLES,
                          precision="mixed") as pd:
        for _ in range(PARTICLES):
            pd.p_create()
        masters = pd.store.stacked("params")
        if not all(x.dtype == torch.float32 for x in tree_leaves(masters)):
            raise AssertionError("mixed masters are not fp32")
        runs, tokens = ladder_serving(torch, pd, cfg, reqs, total,
                                      {"fp32_draft": SPEC_K},
                                      precision="mixed")
        copy = prec.cast_for_serve(masters, "mixed")
        prompts = [p for p, _ in reqs]
        ties = {"fp32_draft": compare_tokens(
            torch, pd, cfg, prompts, tokens["fp32_draft"], tokens["plain"],
            "mixed fp32_draft vs plain", params=copy)}
        # the dense-cache step against plain paged decode of its prompts
        dtoks, got, dprof = dense_steps(torch, pd, cfg, total)
        dreqs = [(p, P11_NEW) for p in dense_prompts(torch, cfg).tolist()]
        dgens, dst, dgot, _, _, _ = serve_requests(
            torch, pd, cfg, dreqs, attention_counts(), ProgramCache())
        plain_launches(dst, dgot, cfg.n_layers, "mixed dense prompts")
        add_counts(total, dgot)
        ties["dense"] = compare_tokens(
            torch, pd, cfg, [p for p, _ in dreqs], dtoks,
            [g.tokens for g in dgens], "mixed dense vs paged", params=copy)
        # #5-#8 against their plain versions at this path's fp32 q
        errs, _ = step_kernel_checks(torch, pd, cfg, copy, prompts,
                                     NUM_PAGES, FP32_TOLS)
        out["kernel_vs_plain_max_abs_err"] = errs
        # the serve cast alone: masters read, the copy written
        cast_prog = ProgramCache().program(specs.serve_cast("mixed"),
                                           (masters, copy))
        n_params = sum(x.numel() for x in tree_leaves(masters))
        c_ms, c_by = bound(n_params * (4 + 2), 0)
        out["serve_cast"] = {
            "graph": cast_prog.graph is not None,
            "ms": time_ms(torch, lambda: cast_prog(masters, copy), iters=10),
            "device_ms": device_ms(torch, lambda: cast_prog(masters, copy),
                                   n=5),
            "bound_ms": c_ms, "bound_by": c_by,
            "read_gb": n_params * 4 / 1e9, "write_gb": n_params * 2 / 1e9,
            "pool_bytes": cast_prog.pool_bytes}
        del cast_prog
        # profiled windows: a plain step, the fp32 draft and the int8
        # draft (4 iterations of slot 0), each a captured program on 8
        # freshly prefilled rows
        n_pmax = NUM_PAGES
        pages = pd.store.checkout("kv_pages")
        try:
            _, mask, bt, tok, sl = prefilled_rows(torch, pd, cfg, prompts,
                                                  n_pmax, pages, params=copy)
            host = [t.cpu().numpy().astype(np.int32) for t in (tok, sl, bt)]
            t, s0, b = host
            step_packed = np.concatenate([t[:, None], s0[:, None], b], 1)
            draft_packed = np.concatenate(
                [t[:, None], s0[:, None], np.full_like(s0[:, None], SPEC_K),
                 b], 1)

            def decode_fn(p, pg, tokens, block_tables, seq_lens):
                return api.decode_step_paged(p, tokens, pg, block_tables,
                                             seq_lens, cfg)

            # the int8 draft's operand: slot 0's row packed and dequantized
            # to bf16, held in the config's fp32, as the engine's
            # spec_draft_pack program writes it
            key = prec.get("mixed").key()
            pack = prec.quantize_int8_like(tree_map(lambda a: a[:1], copy))
            row = tree_map(lambda a: torch.empty(
                (1,) + tuple(a.shape[1:]), dtype=torch.float32,
                device="cuda"), copy)
            prec.quantize_int8_into(pack, copy, row, dtype=torch.bfloat16,
                                    take=lambda a: a[:1])
            windows = {}
            for name, spec, args in (
                    ("plain_step", specs.paged_decode_step(
                        decode_fn, sample_heads), (copy, pages, step_packed,
                                                   mask)),
                    ("fp32_draft", specs.spec_draft_step(
                        decode_fn, slot=0, n_iter=SPEC_K),
                     (copy, pages, draft_packed)),
                    ("int8_draft", specs.spec_draft_step(
                        decode_fn, slot=0, n_iter=SPEC_K, quantized=True),
                     (row, pages, draft_packed))):
                prog = ProgramCache().program(
                    dataclasses.replace(spec, precision=key), args)
                if prog.graph is None:
                    raise AssertionError(f"{name} was not captured")
                windows[name] = dict(profile_steps(
                    torch, lambda: prog(*args), n=3,
                    fns=attention_counts()), capture_s=prog.capture_s,
                    pool_bytes=prog.pool_bytes)
                del prog
            for name in ("fp32_draft", "int8_draft"):
                w = windows[name]
                if isinstance(w["device_busy_ms"], float):
                    w["device_ms_per_iteration"] = w["device_busy_ms"] / SPEC_K
            out["profiles"] = windows
            del pack, row
        finally:
            pd.store.commit("kv_pages", pages)
        torch.cuda.empty_cache()

        # the int8 draft, last: after its traffic (tokens against plain
        # while every particle is live), churn on its open service, with
        # the serve copy at half the masters' bytes and the clone's row the
        # bf16 cast of its master
        def check_row(eng, twin):
            served = eng._mask_and_params()[1]
            slot = pd.store.slot_of(twin)
            exact = all(torch.equal(a[slot], b.to(torch.bfloat16))
                        for a, b in zip(tree_leaves(served),
                                        tree_leaves(pd.p_params(twin))))
            if not exact:
                raise AssertionError("the clone's serve-copy row is not "
                                     "the bf16 cast of its master")
            return {"clone_row_is_bf16_cast": exact}

        def hold(svc, gens):
            ties["int8_draft"] = compare_tokens(
                torch, pd, cfg, prompts, [g.tokens for g in gens],
                tokens["plain"], "mixed int8_draft vs plain", params=copy)
            out["churn"] = churn_on(torch, svc, pd, reqs, total,
                                    check_row)[0]
            out["drafter_kill"] = drafter_kill(torch, svc, pd, reqs, total)

        got8, tok8 = ladder_serving(
            torch, pd, cfg, reqs, total,
            {"int8_draft": SpecConfig(k_max=SPEC_K, quantized=True)},
            plain=False, holds={"int8_draft": hold}, precision="mixed")
        runs.update(got8)
        churn = out["churn"]
        if not abs(churn["served_gb"] * 2 - churn["masters_gb"]) \
                < 1e-6 * churn["masters_gb"]:
            raise AssertionError(f"serve copy {churn['served_gb']} GB for "
                                 f"masters of {churn['masters_gb']} GB")
        out["tokens_vs_plain"] = {k: {"requests_equal": v[0], "tie_gaps": v[1]}
                                  for k, v in ties.items()}
        del copy
        torch.cuda.empty_cache()
        # every particle on one weight set: the int8 draft's row is a pack
        # of the very weights verify reads, so it agrees with the BMA but
        # where int8 rounding flips a near-tie of the greedy argmax (about
        # 1 token in 10 on these random weights, one scale a channel
        # across all 24 layers). Verify corrects any draft, so only the
        # acceptance shows a draft of garbage (~0) or of another particle
        # (phase 6's distinct particles: ~0.11). The drafter's kill above
        # holds the row itself to the new slot's pack, bit for bit.
        first = pd.p_params(pd.particle_ids()[0])
        with PushDistribution(module, seed=SEED, precision="mixed") as twin:
            for _ in range(PARTICLES):
                twin.p_create(params=first)
            short = [(p, 16) for p, _ in reqs]
            tg, tst, tgot, twall, _, _ = serve_requests(
                torch, twin, cfg, short, attention_counts(), ProgramCache(),
                speculative=SpecConfig(k_max=SPEC_K, quantized=True))
            add_counts(total, tgot)
            tss = tst["speculative"]
            out["shared_weights_int8_draft"] = {
                "requests": len(tg), "generated_tokens": 16 * len(tg),
                "tok_per_s": 16 * len(tg) / twall, "steps": tst["steps"],
                "draft_packs": tst["engine"]["draft_packs"],
                "speculative": tss}
            if not tss["acceptance_rate"] >= ACCEPT_INT8:
                raise AssertionError(f"shared-weight int8-draft acceptance "
                                     f"{tss}")
        del first
        torch.cuda.empty_cache()
    out["runs"] = runs
    out["tok_per_s"] = {k: r["tok_per_s"] for k, r in runs.items()}
    out["dense_step"] = {"steps": P11_NEW, "launches": got,
                         "profile": dprof}
    out["launches"] = total
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    emit(out)
    return total


def phase11_bf16(torch, cfg, reqs, card):
    """(b) the same model under ``cfg.replace(dtype="bfloat16")`` and a
    "bf16" store: #5-#8 take bf16 q over bf16 pages."""
    from repro_torch.core import ParticleModule, PushDistribution
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models import api
    from repro_torch.runtime import ProgramCache
    cfg = cfg.replace(dtype="bfloat16")
    total = {}
    torch.cuda.reset_peak_memory_stats()
    module = ParticleModule(init=lambda g: api.init_params(g, cfg), cfg=cfg)
    live = PARTICLES - 1            # a free slot for the clone
    out = {"phase": 11, "part": "b", "model": cfg.name, "dtype": cfg.dtype,
           "precision": "bf16", "particles": live, "capacity": PARTICLES,
           "card": card}
    with PushDistribution(module, seed=SEED, capacity=PARTICLES,
                          precision="bf16") as pd:
        for _ in range(live):
            pd.p_create()
        if not all(x.dtype == torch.bfloat16
                   for x in tree_leaves(pd.store.stacked("params"))):
            raise AssertionError("bf16 masters are not bf16")
        out["masters_gb"] = pd.store.per_device_bytes("params") / 1e9
        runs, tokens = ladder_serving(torch, pd, cfg, reqs, total,
                                      {"speculative": SPEC_K})
        prompts = [p for p, _ in reqs]
        ties = {"speculative": compare_tokens(
            torch, pd, cfg, prompts, tokens["speculative"], tokens["plain"],
            "bf16 speculative vs plain", tie=BF16_TIE)}
        dtoks, got, dprof = dense_steps(torch, pd, cfg, total)
        dreqs = [(p, P11_NEW) for p in dense_prompts(torch, cfg).tolist()]
        dgens, dst, dgot, _, _, _ = serve_requests(
            torch, pd, cfg, dreqs, attention_counts(), ProgramCache())
        plain_launches(dst, dgot, cfg.n_layers, "bf16 dense prompts")
        add_counts(total, dgot)
        ties["dense"] = compare_tokens(
            torch, pd, cfg, [p for p, _ in dreqs], dtoks,
            [g.tokens for g in dgens], "bf16 dense vs paged", tie=BF16_TIE)
        out["tokens_vs_plain"] = {k: {"requests_equal": v[0], "tie_gaps": v[1]}
                                  for k, v in ties.items()}
        out["pages_dtype"] = str(tree_leaves(pd.store.stacked(
            "kv_pages"))[0].dtype)
        errs, rows = step_kernel_checks(
            torch, pd, cfg, pd.store.stacked("params"), prompts, NUM_PAGES,
            dict.fromkeys(FP32_TOLS, BF16_TOL), timed=True)
        out["kernel_vs_plain_max_abs_err"] = errs
        out["kernel_rows"] = rows
        churn, _, killed, back = churn_rounds(torch, pd, cfg, reqs, total, {})
        if killed != back:
            raise AssertionError("bf16 tokens changed across a clone/kill "
                                 "round trip")
        churn["round_trip_tokens_equal"] = True
        out["churn"] = churn
    out["runs"] = runs
    out["tok_per_s"] = {k: r["tok_per_s"] for k, r in runs.items()}
    out["dense_step"] = {"steps": P11_NEW, "launches": got, "profile": dprof}
    out["launches"] = total
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    emit(out)
    return total, rows


def losses_track(got, want, what):
    """The reference's bar: |mixed - fp32| < 0.1 |fp32| + 0.05 per row."""
    got, want = np.asarray(got), np.asarray(want)
    if not np.all(np.abs(got - want) < 0.1 * np.abs(want) + 0.05):
        raise AssertionError(f"{what} losses {got.tolist()} against fp32 "
                             f"{want.tolist()}")
    return float(np.abs(got - want).max())


def phase11_training(torch, fp32, card):
    """(c) 8 full-width ViT-MNIST particles, captured: SteinVGD under
    "mixed" and MultiSWAG under "bf16" masters, phase 4's epochs and
    batches, against phase 4's fp32 runs (``fp32``)."""
    from repro_torch.bdl import MultiSWAG, SteinVGD
    from repro_torch.bdl.svgd import svgd_force, svgd_step_spec
    from repro_torch.core.functional import (ensemble_value_and_grad,
                                             flatten_stacked)
    from repro_torch.core.tree import to_device, tree_flatten, tree_leaves
    from repro_torch.data import DataLoader
    from repro_torch.kernels import ref, swag_moments
    from repro_torch.optim import adam
    from repro_torch.runtime import ProgramCache, specs
    cfg, module = vit_module()
    P, B, NB = TRAIN_P, TRAIN_B, TRAIN_NB
    total = {}
    out = {"phase": 11, "part": "c", "model": cfg.name, "particles": P,
           "batch": B, "batches_per_epoch": NB, "card": card}
    batch = to_device(next(iter(DataLoader(cfg, batch_size=B, num_batches=1,
                                           seed=7))), "cuda")

    # SteinVGD under "mixed": fp32 masters, bf16 forward and backward, the
    # force on fp32 theta
    svgd_kw = {"lengthscale": 0.0, "lr": 1e-3}
    steps = 2 * NB
    cache = ProgramCache()
    algo, losses, got, wall, stats, info, _ = train_run(
        torch, SteinVGD, module, cache, 2, precision="mixed", **svgd_kw)
    if got["pairwise_sqdist"] != steps or got["svgd_force"] != steps:
        raise AssertionError(f"mixed SVGD launches {got}")
    one_program_each("captured", stats, info, ["svgd_step"])
    add_counts(total, got)
    store, mask = algo.store, algo.store.active_mask()
    params = store.stacked("params")
    if not all(x.dtype == torch.float32 for x in tree_leaves(params)):
        raise AssertionError("mixed SVGD masters are not fp32")
    row = {"precision": "mixed", "wall_s": wall, "last_losses": losses,
           "fp32_last_losses": fp32["svgd"]["last_losses"],
           "max_abs_loss_diff": losses_track(
               losses, fp32["svgd"]["last_losses"], "mixed SVGD"),
           "launches": got, "programs": info}
    grads = ensemble_value_and_grad(module.loss, torch.bfloat16)(
        params, batch)[1]
    theta, g = flatten_stacked(params)[0], flatten_stacked(grads)[0]
    del grads, params
    row["force_kernel_vs_plain_rel"] = rel_err(
        svgd_force(theta, g, 0.0, mask=mask), plain_force(theta, g, 0.0, mask))
    if not row["force_kernel_vs_plain_rel"] < 2e-4:
        raise AssertionError(f"mixed SVGD force kernel vs plain: {row}")
    del theta, g
    params = store.checkout("params")
    try:
        prof = program_window(torch, algo.push_dist.runtime, svgd_step_spec(
            module.loss, precision="mixed", **svgd_kw), (params, batch, mask))
    finally:
        store.commit("params", params)
    row.update({"step_ms": prof["wall_ms"],
                "images_per_s": P * B / prof["wall_ms"] * 1e3,
                "fp32_images_per_s": fp32["svgd"]["images_per_s"],
                "profile": prof})
    out["svgd"] = row
    del algo, store, params, cache, mask
    gc.collect()
    torch.cuda.empty_cache()

    # MultiSWAG under "bf16": bf16 params and Adam state, fp32 moments, a
    # bf16 ring; #3 on fp32 working copies
    opt = adam(1e-3)
    cache = ProgramCache()
    algo, losses, got, wall, stats, info, _ = train_run(
        torch, MultiSWAG, module, cache, 3, precision="bf16", optimizer=opt,
        pretrain_epochs=1, max_rank=20)
    n_leaves = len(tree_leaves(algo.p_parameters()[0]))
    if got["swag_moments"] != 2 * collect_launches(n_leaves):
        raise AssertionError(f"bf16 MultiSWAG launches {got}")
    one_program_each("captured", stats, info, ["ensemble_step", "map_step"])
    add_counts(total, got)
    store, mask = algo.store, algo.store.active_mask()
    swag = store.stacked("swag")
    dtypes = {"params": str(tree_leaves(store.stacked("params"))[0].dtype),
              "adam_m": str(tree_leaves(store.stacked("opt_state")["m"])[0]
                            .dtype),
              "swag_mean": str(tree_leaves(swag["mean"])[0].dtype),
              "swag_ring": str(tree_leaves(swag["dev"])[0].dtype)}
    if dtypes != {"params": "torch.bfloat16", "adam_m": "torch.bfloat16",
                  "swag_mean": "torch.float32",
                  "swag_ring": "torch.bfloat16"}:
        raise AssertionError(f"bf16 MultiSWAG state dtypes {dtypes}")
    # #3 at the path's inputs (fp32 moments, widened bf16 theta): the
    # one-launch kernel and the plain version each through
    # leaves_via_fp32 onto its own clone of the state, the bf16 ring's
    # included
    means = tree_flatten(swag["mean"], sort_keys=True)[0]
    sqs, devs, thetas = (tree_flatten(t, sort_keys=True)[0] for t in
                         (swag["sq_mean"], swag["dev"],
                          store.stacked("params")))
    slot = (swag["rank"] % devs[0].shape[1]).to(torch.int32)
    sides = {}
    for side, fn in (("kernel", swag_moments.moments_leaves),
                     ("plain", ref.swag_moments_leaves)):
        st = [[x.clone() for x in xs] for xs in (means, sqs, devs)]
        swag_moments.leaves_via_fp32(fn, st[0], st[1], thetas, swag["n"],
                                     mask, st[2], slot)
        sides[side] = sum(st, [])
    err = max(float((x.float() - y.float()).abs().max())
              for x, y in zip(sides["kernel"], sides["plain"]))
    same = all(torch.equal(x, y)
               for x, y in zip(sides["kernel"], sides["plain"]))
    del sides
    torch.cuda.empty_cache()
    if not err <= 1e-5:
        raise AssertionError(f"bf16 SWAG collection kernel vs plain: {err}")
    row = {"precision": "bf16", "wall_s": wall, "last_losses": losses,
           "fp32_last_losses": fp32["multiswag"]["last_losses"],
           "max_abs_loss_diff": losses_track(
               losses, fp32["multiswag"]["last_losses"], "bf16 MultiSWAG"),
           "launches": got, "programs": info, "state_dtypes": dtypes,
           "state_gb": sum(store.per_device_bytes(k) for k in
                           ("params", "opt_state", "swag")) / 1e9,
           "moments_kernel_vs_plain": err,
           "moments_kernel_equals_plain": same}
    del swag, means, sqs, devs, thetas
    co = {k: store.checkout(k) for k in ("params", "opt_state")}
    try:
        prof = program_window(torch, algo.push_dist.runtime,
                              specs.ensemble_step(module.loss, opt,
                                                  precision="bf16"),
                              (co["params"], co["opt_state"], batch, mask))
    finally:
        for k in co:
            store.commit(k, co[k])
    row.update({"step_ms": prof["wall_ms"],
                "images_per_s": P * B / prof["wall_ms"] * 1e3,
                "fp32_images_per_s": fp32["multiswag"]["images_per_s"],
                "profile": prof,
                "peak_gb": torch.cuda.max_memory_allocated() / 2**30})
    out["multiswag"] = row
    out["master_cast_bound_ms"] = bound(P * TRAIN_D * (4 + 2), 0)[0]
    out["launches"] = total
    emit(out)
    del algo, store, co, cache, mask
    gc.collect()
    torch.cuda.empty_cache()
    return total


def flush_bounds(B, members, weight_bytes):
    """One flush of B rows under a bf16 policy: the members' weights read
    once (``weight_bytes`` an element: 2 for bf16, 1 for int8 packs), and
    2 x params x tokens x members x B operations at the bf16 rate."""
    nbytes = members * TRAIN_D * weight_bytes
    flops = 2 * TRAIN_D * SERVE_TOKENS * members * B
    ms, by = bound(nbytes, flops, BF16_FLOPS_PER_S)
    return {"bound_ms": ms, "bound_by": by,
            "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "flops_bound_ms": flops / BF16_FLOPS_PER_S * 1e3}


def phase11_predictive(torch, fp32, card):
    """(d) phase 10's MultiSWAG posterior (32 members) served under
    "mixed" and "mixed_int8", against the fp32 service's heads and phase
    10's fp32 figures (``fp32``); then the store's own params under
    "mixed_int8" with a p_kill under traffic."""
    import threading
    from repro_torch.bdl import MultiSWAG
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import DataLoader, mnist_like
    from repro_torch.optim import adam
    from repro_torch.runtime import ProgramCache
    from repro_torch.serve import serve
    cfg, module = vit_module()
    P, S = TRAIN_P, SERVE_S
    members = P * S
    total = {}
    out = {"phase": 11, "part": "d", "model": cfg.name, "particles": P,
           "members": members, "card": card}
    torch.cuda.reset_peak_memory_stats()
    algo = MultiSWAG(module, seed=SEED, backend="compiled")
    algo.push_dist.runtime.cache = ProgramCache()
    loader = DataLoader(cfg, batch_size=TRAIN_B, num_batches=SERVE_NB,
                        seed=SEED)
    fns = reset_counts()
    _, losses = algo.bayes_infer(loader, 3, num_particles=P,
                                 optimizer=adam(1e-3), pretrain_epochs=1,
                                 max_rank=20)
    add_counts(total, read_counts(fns))
    n_leaves = len(tree_leaves(algo.p_parameters()[0]))
    images = mnist_like(np.random.default_rng(11), SERVE_N,
                        cfg.vocab_size)["images"]
    reqs = [{"images": im} for im in images]
    with algo.posterior_predictive(samples_per_particle=S,
                                   max_batch=SERVE_MAX_BATCH,
                                   warmup=False) as svc:
        want = svc.predict_batch({"images": images})
    out["diag_std"] = diag_std_serving_shapes(torch, algo.store.dense("swag"),
                                              device=False)
    for policy, tol, wbytes in (("mixed", 0.03, 2), ("mixed_int8", 0.06, 1)):
        fns = reset_counts()
        svc = algo.posterior_predictive(
            samples_per_particle=S, max_batch=SERVE_MAX_BATCH,
            max_wait_ms=SERVE_WAIT_MS, warmup=reqs[0], precision=policy)
        got = read_counts(fns)
        add_counts(total, got)
        if got["swag_diag_std"] != collect_launches(n_leaves):
            raise AssertionError(f"{policy} handoff launches {got}")
        try:
            cache = svc.engine.cache
            tree = svc.engine._static_params
            row = {"static_tree_gb": tree_gb(tree),
                   "leaf_dtypes": sorted({str(x.dtype)
                                          for x in tree_leaves(tree)})}
            del tree
            warm = cache.snapshot_stats()
            info = cache.program_costs()
            row["warmup"] = {"programs": len(info), "by_bucket": [
                {"bucket": 2**i, "graph": p["graph"],
                 "capture_s": p["capture_s"], "pool_bytes": p["pool_bytes"]}
                for i, p in enumerate(info)],
                "pool_bytes_total": sum(p["pool_bytes"] for p in info)}
            if len(info) != 6 or not all(p["graph"] for p in info):
                raise AssertionError(f"{policy} warmup programs {info}")
            conc, row["concurrent"] = serve_traffic(svc, reqs, SERVE_CLIENTS)
            closed, row["closed_loop"] = serve_traffic(svc, reqs, 0)
            extra = cache.snapshot_stats()["cold_compiles"] \
                - warm["cold_compiles"]
            if extra:
                raise AssertionError(f"{policy}: {extra} captures after "
                                     f"warmup")
            row["profile"] = {}
            for B in (1, SERVE_MAX_BATCH):
                fp = flush_profile(torch, svc, reqs, B, members)
                row["profile"][f"bucket_{B}"] = dict(
                    {k: fp[k] for k in ("rows", "host_ms", "device_busy_ms",
                                        "idle_share", "top_kernels_ms")},
                    **flush_bounds(B, members, wbytes))
            heads = svc.predict_batch({"images": images})
            row["served_vs_predict_batch"] = max(
                served_vs_batch(conc, heads), served_vs_batch(closed, heads))
            row["mean_vs_fp32"] = float((heads["mean"]
                                         - want["mean"]).abs().max())
            row["heads_vs_fp32"] = {k: float((heads[k] - want[k]).abs().max())
                                    for k in HEADS}
            row["tolerance"] = tol
            if not row["served_vs_predict_batch"] <= BF16_SERVED_TOL \
                    or not row["mean_vs_fp32"] < tol:
                raise AssertionError(f"{policy} heads: {row}")
        finally:
            svc.close()
        out[policy] = row
        del cache, heads, conc, closed
        gc.collect()
        torch.cuda.empty_cache()
    out["fp32_phase10"] = {
        "concurrent": {k: fp32["concurrent"][k] for k in (
            "requests_per_s", "latency_p50_ms", "latency_p95_ms",
            "latency_p99_ms")},
        "closed_loop": {k: fp32["closed_loop"][k] for k in (
            "requests_per_s", "latency_p50_ms", "latency_p95_ms",
            "latency_p99_ms")},
        "profile": {b: {k: fp32["profile"][b][k] for k in (
            "host_ms", "device_busy_ms", "bound_ms", "bound_by")}
            for b in fp32["profile"]}}

    # the store's own params under "mixed_int8": the serve copy refreshed
    # by the serve_cast program, a p_kill under traffic captures nothing
    pd = algo.push_dist
    with serve(algo, max_batch=8, max_wait_ms=SERVE_WAIT_MS, warmup=reqs[0],
               precision="mixed_int8") as ssvc:
        eng = ssvc.engine
        cold = eng.cache.snapshot_stats()["cold_compiles"]
        gen = pd.store.generation()
        ptrs = [x.data_ptr() for x in tree_leaves(eng._mask_and_params()[1])]
        handles = []

        def client():
            for r in reqs[:128]:
                handles.append(ssvc.predict_async(r))

        t = threading.Thread(target=client)
        t.start()
        while len(handles) < 64 and t.is_alive():
            time.sleep(0.0005)
        pd.p_kill(pd.particle_ids()[-1])
        t.join(120.0)
        for h in handles:
            h.result(120.0)
        st = ssvc.stats()
        row = {"live": pd.store.live_count(),
               "captures_after_warmup_and_kill":
                   st["engine"]["program_cache"]["cold_compiles"] - cold,
               "generation_unchanged": pd.store.generation() == gen,
               "serve_copy_addresses_kept": [
                   x.data_ptr() for x in tree_leaves(
                       eng._mask_and_params()[1])] == ptrs,
               "serve_casts": sum(p["name"] == "serve_cast"
                                  for p in eng.cache.program_costs()),
               "errors": st["errors"], "requests": st["requests"]}
        if row["captures_after_warmup_and_kill"] or not (
                row["generation_unchanged"]
                and row["serve_copy_addresses_kept"]) or row["errors"] \
                or row["serve_casts"] != 1:
            raise AssertionError(f"mixed_int8 store serving under churn: "
                                 f"{row}")
    out["store_serving"] = row
    out["launches"] = total
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    emit(out)
    algo.cleanup()
    del algo
    gc.collect()
    torch.cuda.empty_cache()
    return total


def phase11(torch, cfg, reqs, fp32_train, fp32_predictive, card):
    """The precision ladder on the card (module doc). Returns each
    kernel's launches over phase 11's driven runs and the bf16 timed rows
    of #5-#8."""
    t0 = time.perf_counter()
    total, walls = {}, {}
    add_counts(total, phase11_mixed(torch, cfg, reqs, card))
    gc.collect()
    torch.cuda.empty_cache()
    walls["a"] = time.perf_counter() - t0
    got, bf16_rows = phase11_bf16(torch, cfg, reqs, card)
    add_counts(total, got)
    gc.collect()
    torch.cuda.empty_cache()
    walls["b"] = time.perf_counter() - t0 - sum(walls.values())
    add_counts(total, phase11_training(torch, fp32_train, card))
    walls["c"] = time.perf_counter() - t0 - sum(walls.values())
    add_counts(total, phase11_predictive(torch, fp32_predictive, card))
    walls["d"] = time.perf_counter() - t0 - sum(walls.values())
    missing = [k for k, fn in reset_counts().items() if not total.get(k)]
    if missing:
        raise AssertionError(f"phase 11 never launched {missing}")
    emit({"phase": 11, "part": "end", "launches": total,
          "wall_s": time.perf_counter() - t0, "wall_s_by_part": walls,
          "card": card})
    return total, bf16_rows


# --------------------------------------------------------------------------
# phase 12: the paper's SciML workload (Fig. 4) — full-width UNet-advection
# particles trained by DeepEnsemble, SteinVGD and MultiSWAG, served as a
# regression BMA, and the sequential baselines of both workloads
# --------------------------------------------------------------------------

SCI_P = 8                        # configs/unet_advection.py default_particles
SCI_B, SCI_NB = 50, 8            # the paper's batch; phase 4's batches an epoch
SCI_D = 1_240_065                # parameters per UNet particle
SCI_LEAVES = 34
SCI_FIG4_P = (2, 4)              # the P = 8 rows are part (a)'s runs
SCI_KERNELS = ("pairwise_sqdist", "svgd_force", "swag_moments",
               "swag_diag_std")


def unet_module():
    """The full-width UNet-advection config and its ParticleModule."""
    from repro_torch import configs
    from repro_torch.core import ParticleModule
    from repro_torch.models import api
    cfg = configs.get("unet-advection")
    return cfg, ParticleModule(init=lambda g: api.init_params(g, cfg),
                               loss=lambda p, b: api.loss_fn(p, b, cfg),
                               forward=lambda p, b: api.forward(p, b, cfg)[0],
                               cfg=cfg)


def unet_flops(cfg, L):
    """fp32 operations of one sample's forward (two a multiply-add), from
    the shapes: the k = 3 convs of each stage at its grid, the 1x1 head."""
    chans = [cfg.d_model * 2 ** i for i in range(cfg.n_units)]
    total, cin, grids = 0, 1, []
    for c in chans:
        grids.append(L)
        total += 2 * L * 3 * (cin * c + c * c)
        cin, L = c, (L + 1) // 2
    for c, g in zip(reversed(chans), reversed(grids)):
        total += 2 * g * 3 * ((cin + c) * c + c * c)
        cin = c
    return total + 2 * grids[0] * cin


class EpochClock:
    """A data loader whose every pass marks the card's clock: it
    synchronises and reads the host clock as an epoch starts, and
    ``stop()`` after the run, so the last epoch's ms hold every step and
    collection of that epoch (the first holds the captures). ``probe()``,
    when given, runs as the last epoch starts (programs alive then)."""

    def __init__(self, torch, loader, probe=None):
        self.torch, self.loader, self.probe = torch, loader, probe
        self.marks, self.probed = [], None

    def __iter__(self):
        self.torch.cuda.synchronize()
        self.marks.append(time.perf_counter())
        if self.probe is not None:
            self.probed = self.probe()
        yield from self.loader

    def stop(self):
        self.torch.cuda.synchronize()
        self.marks.append(time.perf_counter())

    def last_ms(self):
        return (self.marks[-1] - self.marks[-2]) * 1e3


def sci_loader(torch, cfg, B, NB, probe=None):
    from repro_torch.data import DataLoader
    return EpochClock(torch, DataLoader(cfg, batch_size=B, num_batches=NB,
                                        seed=SEED), probe)


def sci_train(torch, cls, module, P, epochs, backend, cache=None, **kw):
    """One driven run of ``cls`` over P fresh particles (seed SEED, SCI_NB
    batches of SCI_B an epoch) on ``backend`` (a compiled run takes
    ``cache``), between a reset and a read of the kernels' counts.
    Returns the algorithm and the run's numbers (last losses, launches,
    wall s, last epoch ms, samples/s, peak GB)."""
    B, NB = SCI_B, SCI_NB
    torch.cuda.reset_peak_memory_stats()
    algo = cls(module, seed=SEED, backend=backend)
    if cache is not None:
        algo.push_dist.runtime.cache = cache
    clock = sci_loader(torch, module.cfg, B, NB)
    fns = reset_counts()
    t0 = time.perf_counter()
    _, losses = bounded(algo.bayes_infer, clock, epochs, num_particles=P,
                        **kw)
    clock.stop()
    row = {"particles": P, "epochs": epochs, "last_losses": losses,
           "launches": read_counts(fns),
           "wall_s": time.perf_counter() - t0,
           "ms_per_epoch": clock.last_ms(),
           "samples_per_s": P * B * NB / clock.last_ms() * 1e3,
           "peak_gb": torch.cuda.max_memory_allocated() / 2**30}
    if not np.isfinite(losses).all():
        raise AssertionError(f"{cls.__name__} {backend} losses {losses}")
    return algo, row


def baseline_programs():
    """The baseline programs alive in the process cache: name, graph,
    capture s and pool bytes, with the totals."""
    from repro_torch.runtime.cache import global_cache
    info = [p for p in global_cache().program_costs()
            if p["name"].startswith("baseline_")]
    return {"programs": len(info),
            "graphs": sum(p["graph"] for p in info),
            "by_name": sorted({p["name"] for p in info}),
            "capture_s": sum(p["capture_s"] for p in info),
            "pool_bytes": sum(p["pool_bytes"] for p in info)}


def sci_baseline(torch, name, module, P, epochs, B, NB, **kw):
    """One driven baseline run (``bdl.baselines``) over P NNs on the card,
    timed per epoch by an EpochClock whose probe reads the baseline
    programs as the last epoch starts. Returns (its result, its row)."""
    from repro_torch.bdl import baselines
    from repro_torch.runtime.cache import global_cache
    fn = getattr(baselines, f"{name}_baseline")
    clock = sci_loader(torch, module.cfg, B, NB, probe=baseline_programs)
    torch.cuda.reset_peak_memory_stats()
    before = global_cache().snapshot_stats()
    fns = reset_counts()
    t0 = time.perf_counter()
    if name == "svgd":
        out = fn(module, P, clock, epochs, seed=SEED, **kw)
    else:
        out = fn(module, kw.pop("optimizer"), P, clock, epochs, seed=SEED,
                 **kw)
    clock.stop()
    after = global_cache().snapshot_stats()
    row = {"particles": P, "epochs": epochs, "launches": read_counts(fns),
           "wall_s": time.perf_counter() - t0,
           "ms_per_epoch": clock.last_ms(),
           "samples_per_s": P * B * NB / clock.last_ms() * 1e3,
           "cache": {k: after[k] - before[k] for k in ("hits", "misses",
                                                       "cold_compiles")},
           "captured": clock.probed,
           "peak_gb": torch.cuda.max_memory_allocated() / 2**30}
    want = {"ensemble": P, "multiswag": 2 * P, "svgd": P + 1}[name]
    if row["cache"]["misses"] != want or clock.probed["programs"] != want \
            or clock.probed["graphs"] != want:
        raise AssertionError(f"{name} baseline programs {row}, want {want}"
                             f" graphs, each looked up once")
    return out, row


def unet_grouped(torch, params, u):
    """The UNet forward in the other form: NCW activations (B, P * C, L)
    and each conv one grouped ``conv1d`` over the particles (what XLA
    makes of the reference's vmapped convs). Returns (P, B, L, 1)."""
    F = torch.nn.functional
    P = params["head"]["b"].shape[0]
    B = u.shape[0]

    def conv(p, x):
        w = p["w"]                                  # (P, k, cin, cout)
        k = w.shape[1]
        wt = w.permute(0, 3, 2, 1).reshape(-1, w.shape[2], k)
        return F.conv1d(x, wt, p["b"].reshape(-1), padding=k // 2, groups=P)

    def gelu(x):
        return F.gelu(x, approximate="tanh")

    x = u.permute(0, 2, 1).repeat(1, P, 1)              # (B, P, L)
    skips = []
    for st in params["enc"]:
        x = gelu(conv(st["c2"], gelu(conv(st["c1"], x))))
        skips.append(x)
        x = x[:, :, ::2]
    for st, sk in zip(params["dec"], reversed(skips)):
        L = sk.shape[2]
        x = x.repeat_interleave(2, dim=2)[:, :, :L]
        x = torch.cat([x.reshape(B, P, -1, L), sk.reshape(B, P, -1, L)],
                      dim=2).reshape(B, -1, L)
        x = gelu(conv(st["c2"], gelu(conv(st["c1"], x))))
    y = conv(params["head"], x)                         # (B, P, L)
    return y.reshape(B, P, L, 1).permute(1, 0, 2, 3)


def conv_forms(torch, module, batch):
    """Forward + backward of the P = 8, B = 50, L = 128 UNet in the
    package's form (im2col + one batched GEMM a conv, NWC) and in the
    grouped-conv form (NCW, cuDNN, with its autotuner off and on), event
    ms with the L2 flushed; the two forms' outputs held within 1e-4 of the
    largest."""
    from repro_torch.core import PushDistribution
    from repro_torch.core.tree import tree_flatten
    from repro_torch.models import unet1d
    pd = PushDistribution(module, seed=SEED, backend="compiled")
    for _ in range(SCI_P):
        pd.p_create()
    leaves, unflatten = tree_flatten(pd.store.dense("params"))
    leaves = [x.detach().requires_grad_(True) for x in leaves]
    params = unflatten(leaves)
    pd.cleanup()
    u, u1 = batch["u0"], batch["u1"]
    forms = {"im2col_bmm": lambda: unet1d.unet_apply(params, u, module.cfg),
             "grouped_conv1d": lambda: unet_grouped(torch, params, u)}

    def fwd_bwd(apply):
        def run():
            loss = (apply() - u1).square().mean()
            torch.autograd.grad(loss, leaves)
        return run

    with torch.no_grad():
        a, b = forms["im2col_bmm"](), forms["grouped_conv1d"]()
    out = {"forms_max_rel": rel_err(b, a)}
    if not out["forms_max_rel"] < 1e-4:
        raise AssertionError(f"the two conv forms differ: {out}")
    out["fwd_bwd_ms"] = {k: time_ms(torch, fwd_bwd(f), iters=20)
                         for k, f in forms.items()}
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        out["fwd_bwd_ms"]["grouped_conv1d_cudnn_benchmark"] = time_ms(
            torch, fwd_bwd(forms["grouped_conv1d"]), iters=20)
    finally:
        torch.backends.cudnn.benchmark = bench
    out["chosen"] = "im2col_bmm"
    return out


def sci_one_step(torch, cls, module, batch, **kw):
    """One NEL step (SteinVGD: one leader step; MultiSWAG: a step and a
    collection) against one captured compiled step from the same init on
    the same host batch: the params' (and SWAG moments') largest
    difference."""
    from repro_torch.core.functional import flatten_rows
    from repro_torch.runtime import ProgramCache
    algos = {}
    for backend in ("nel", "compiled"):
        algo = cls(module, seed=SEED, backend=backend)
        if backend == "compiled":
            algo.push_dist.runtime.cache = ProgramCache()
        bounded(algo.bayes_infer, [batch], 1, num_particles=SCI_P, **kw)
        algos[backend] = algo
    out = {}
    keys = [("params",)] + ([("swag", "mean"), ("swag", "sq_mean")]
                            if cls.__name__ == "MultiSWAG" else [])
    for key in keys:
        rows = {}
        for backend, algo in algos.items():
            pd = algo.push_dist
            trees = [pd.particles[p].state[key[0]] for p in
                     pd.particle_ids()]
            if len(key) > 1:
                trees = [t[key[1]] for t in trees]
            rows[backend] = flatten_rows(trees)[0]
        out["/".join(key)] = float((rows["nel"] - rows["compiled"]).abs()
                                   .max())
    for algo in algos.values():
        algo.cleanup()
    return out


def sci_training(torch, card):
    """Part (a): DeepEnsemble, SteinVGD and MultiSWAG over 8 full-width
    UNet particles, each captured, eager and on the NEL. Returns the
    launches, the Fig. 4 rows at P = 8, the captured MultiSWAG algorithm
    (part (b) serves it) and the part's line."""
    from repro_torch.bdl import DeepEnsemble, MultiSWAG, SteinVGD
    from repro_torch.bdl.svgd import svgd_step_spec
    from repro_torch.bdl.swag import swag_collect
    from repro_torch.core import PushDistribution
    from repro_torch.core.tree import to_device
    from repro_torch.data import DataLoader
    from repro_torch.optim import adam, sgd
    from repro_torch.runtime import specs
    cfg, module = unet_module()
    P, B, NB = SCI_P, SCI_B, SCI_NB
    step_flops = 3 * unet_flops(cfg, cfg.max_seq_len) * P * B
    out = {"phase": 12, "part": "a", "model": cfg.name, "particles": P,
           "batch": B, "grid": cfg.max_seq_len, "batches_per_epoch": NB,
           "params_per_particle": SCI_D, "card": card,
           "forward_flops_per_sample": unet_flops(cfg, cfg.max_seq_len),
           "step_flops": step_flops,
           "step_bound_ms": step_flops / FP32_FLOPS_PER_S * 1e3}
    host_batch = next(iter(DataLoader(cfg, batch_size=B, num_batches=1,
                                      seed=SEED)))
    batch = to_device(host_batch, "cuda")
    out["conv_forms"] = conv_forms(torch, module, batch)
    init = PushDistribution(module, seed=SEED, backend="compiled")
    for _ in range(P):
        init.p_create()
    with torch.no_grad():
        loss0 = float(module.loss(init.store.dense("params"), batch)[0]
                      .mean())
    init.cleanup()
    del init
    opt = adam(1e-3)
    collect_spec = specs.map_step(swag_collect, key=("swag_collect",),
                                  n_state=2, masked=True)
    svgd_kw = {"lengthscale": 0.0, "lr": 5e-2}
    algos = {
        "ensemble": (DeepEnsemble, 2, {"optimizer": opt},
                     ["ensemble_step"], {"optimizer": sgd(0.05)}),
        "svgd": (SteinVGD, 2, svgd_kw, ["svgd_step"], svgd_kw),
        "multiswag": (MultiSWAG, 3, {"optimizer": opt, "pretrain_epochs": 1,
                                     "max_rank": 20},
                      ["ensemble_step", "map_step"],
                      {"optimizer": sgd(0.05), "max_rank": 20})}
    launches, fig4, keep = {}, {}, None
    for name, (cls, epochs, kw, names, one_kw) in algos.items():
        runs = {}
        for mode, cache in caches():
            algo, row = sci_train(torch, cls, module, P, epochs, "compiled",
                                  cache, **kw)
            one_program_each(mode, cache.snapshot_stats(),
                             cache.program_costs(), names)
            row["programs"] = cache.program_costs()
            if mode == "captured":
                add_counts(launches, row["launches"])
                row.update(sci_trained_checks(torch, name, algo, module,
                                              batch, loss0))
                row["step"], collect = sci_profiles(
                    torch, name, algo, batch,
                    svgd_step_spec(module.loss, **svgd_kw)
                    if name == "svgd" else specs.ensemble_step(module.loss,
                                                               opt),
                    collect_spec, out["step_bound_ms"])
                if collect is not None:
                    row["collect"] = collect
            runs[mode] = row
            if mode == "captured" and name == "multiswag":
                keep = algo
            else:
                algo.cleanup()
            del algo, cache
            gc.collect()
            torch.cuda.empty_cache()
        same_runs(runs, f"UNet {name}")
        nel, row = sci_train(torch, cls, module, P, epochs, "nel", **kw)
        add_counts(launches, row["launches"])
        want = {"ensemble": {},
                "svgd": {"pairwise_sqdist": epochs * NB,
                         "svgd_force": epochs * NB},
                "multiswag": {"swag_moments":
                              2 * P * collect_launches(SCI_LEAVES)}}[name]
        if {k: v for k, v in row["launches"].items() if v} != want:
            raise AssertionError(f"NEL {name} launches {row['launches']}")
        nel.cleanup()
        del nel
        runs["nel"] = row
        runs["nel_one_step_vs_captured"] = sci_one_step(
            torch, cls, module, host_batch, **one_kw)
        if not max(runs["nel_one_step_vs_captured"].values()) < 1e-4:
            raise AssertionError(f"NEL vs compiled one step {name}: "
                                 f"{runs['nel_one_step_vs_captured']}")
        gc.collect()
        torch.cuda.empty_cache()
        out[name] = runs
        fig4[name] = {"captured": runs["captured"], "nel": runs["nel"]}
    out["launches"] = launches
    return launches, fig4, keep, out


def sci_trained_checks(torch, name, algo, module, batch, loss0):
    """At a captured run's trained state, before anything advances it:
    the loss has fallen below the init's on the first batch; SteinVGD's
    #1 and #2 and MultiSWAG's #3 against their plain versions."""
    store, mask = algo.store, algo.store.active_mask()
    with torch.no_grad():
        after = float(module.loss(store.dense("params"), batch)[0].mean())
    out = {"loss_before": loss0, "loss_after": after}
    if not after < loss0:
        raise AssertionError(f"{name}: the loss did not fall: {loss0} -> "
                             f"{after}")
    if name == "svgd":
        out["kernels_vs_plain"] = sci_force_checks(torch, store, module,
                                                   batch, mask)
    if name == "multiswag":
        out["moments_kernel_vs_plain"] = moments_parity(
            torch, store.stacked("swag"), store.stacked("params"), mask)
        if not out["moments_kernel_vs_plain"]["max_abs_err"] <= 1e-5:
            raise AssertionError(f"SWAG collection kernel vs plain: {out}")
        out["moments_timed"] = sci_moments_timed(
            torch, store.stacked("swag"), store.stacked("params"), mask)
    return out


def sci_profiles(torch, name, algo, batch, step_spec, collect_spec,
                 bound_ms):
    """Profiled windows of a captured run's own step program (and, for
    MultiSWAG, its collection), run last: they advance the state.
    Returns (the step's numbers, the collection's or None)."""
    store, mask = algo.store, algo.store.active_mask()
    keys = {"ensemble": ("params", "opt_state"), "svgd": ("params",),
            "multiswag": ("params", "opt_state", "swag")}[name]
    co = {k: store.checkout(k) for k in keys}
    rt = algo.push_dist.runtime
    try:
        step_args = (co["params"],) + (
            (co["opt_state"],) if "opt_state" in co else ()) + (batch, mask)
        prof = program_window(torch, rt, step_spec, step_args)
        collect = (program_window(torch, rt, collect_spec,
                                  (co["swag"], co["params"], mask),
                                  prologue=32, epilogue=32)
                   if name == "multiswag" else None)
    finally:
        for k in co:
            store.commit(k, co[k])
    busy = prof["device_busy_ms"]
    return {"host_ms": prof["wall_ms"], "device_busy_ms": busy,
            "idle_share": prof["idle_share"],
            "samples_per_s": SCI_P * SCI_B / prof["wall_ms"] * 1e3,
            "bound_ms": bound_ms,
            "device_over_bound": (busy / bound_ms
                                  if isinstance(busy, float) else None),
            "tracked_ms": prof.get("tracked_ms"),
            "top_kernels_ms": prof["top_kernels_ms"],
            "capture_s": prof["capture_s"],
            "pool_bytes": prof["pool_bytes"]}, collect


def sci_moments_timed(torch, state, params, mask):
    """One eager collection's #3 over the 34 leaves, on a copy of the
    trained state: the one-launch kernel (the path's), the per-leaf
    kernel's loop and the plain version, event ms with the L2 flushed and device
    ms, beside the bound: mean, sq and theta read, mean, sq and the
    ring's slot written, for the live rows."""
    from repro_torch.core.tree import tree_flatten
    from repro_torch.kernels import ref, swag_moments
    means = tree_flatten(state["mean"], sort_keys=True)[0]
    sqs, devs, thetas = (tree_flatten(t, sort_keys=True)[0] for t in
                         (state["sq_mean"], state["dev"], params))
    n, R = state["n"], devs[0].shape[1]
    slot = (state["rank"] % R).to(torch.int32)
    m, s, d = ([x.clone() for x in xs] for xs in (means, sqs, devs))
    thetas = [t.contiguous() for t in thetas]

    def one():
        swag_moments.moments_leaves(m, s, thetas, n, mask, d, slot)

    def per_leaf():
        for a, b, t, r in zip(m, s, thetas, d):
            swag_moments.moments(a, b, t, n, mask, r, slot, out_mean=a,
                                 out_sq=b)

    live = int((mask > 0).sum())
    ms, by = bound(6 * 4 * live * SCI_D, 7 * live * SCI_D)
    out = {"leaves": len(means),
           "launches_per_collection": counted_launches(
               swag_moments.moments_leaves, one,
               collect_launches(len(means)), "the UNet's collection"),
           "ms": time_ms(torch, one),
           "per_leaf_ms": time_ms(torch, per_leaf),
           "plain_ms": time_ms(torch, lambda: ref.swag_moments_leaves(
               m, s, thetas, n, mask, d, slot)),
           "device_ms": device_ms(torch, one),
           "per_leaf_device_ms": device_ms(torch, per_leaf),
           "bound_ms": ms, "bound_by": by,
           "leaf_sizes": sorted({x[0].numel() for x in means})}
    del m, s, d
    torch.cuda.empty_cache()
    return out


def sci_force_checks(torch, store, module, batch, mask):
    """#1 and #2 at the trained (8, 1,240,065) state against their plain
    versions: sqdist within 1e-5 of its largest entry (and on the
    plain-load path: D is odd), the force with the trained g and with
    g = 0, 2e-4 relative; then each timed (L2 flushed) beside its bound
    and device ms."""
    from repro_torch.bdl.svgd import rbf_glue, svgd_force
    from repro_torch.core.functional import (ensemble_value_and_grad,
                                             flatten_stacked)
    from repro_torch.kernels import ref, svgd_rbf
    params = store.stacked("params")
    grads = ensemble_value_and_grad(module.loss)(params, batch)[1]
    theta = flatten_stacked(params)[0]
    g = flatten_stacked(grads)[0]
    del grads, params
    n, D = theta.shape
    plan = svgd_rbf.plan_for(theta)
    sq = sqdist_exact(torch, svgd_rbf, theta, mask, "UNet sqdist")
    want = ref.pairwise_sqdist(theta, mask)
    out = {"shape": [n, D], "sqdist_path": plan.path,
           "sqdist_rel": float((sq - want).abs().max() / want.abs().max()),
           "force_rel": rel_err(svgd_force(theta, g, 0.0, mask=mask),
                                plain_force(theta, g, 0.0, mask)),
           "repulsive_rel": rel_err(
               svgd_force(theta, torch.zeros_like(g), 0.0, mask=mask),
               plain_force(theta, torch.zeros_like(g), 0.0, mask))}
    if plan.path != "plain" or D != SCI_D or not (
            out["sqdist_rel"] < 1e-5 and out["force_rel"] < 2e-4
            and out["repulsive_rel"] < 2e-4):
        raise AssertionError(f"UNet SVGD kernels vs plain: {out}")
    glue = rbf_glue(sq, 0.0, mask)
    out["force_equals_columns"] = all(torch.equal(
        svgd_rbf.svgd_force(theta, x, *glue, mask),
        svgd_rbf.svgd_force_columns(theta, x, *glue, mask))
        for x in (g, torch.zeros_like(g)))
    if not out["force_equals_columns"]:
        raise AssertionError("UNet force: not the column kernel's bits")
    ms, by = bound(n * D * 4, 3 * n * n * D)
    kern = lambda: svgd_rbf.pairwise_sqdist(theta, mask)
    rows = {"pairwise_sqdist": {
        "ms": time_ms(torch, kern),
        "plain_ms": time_ms(torch, lambda: ref.pairwise_sqdist(theta, mask)),
        "device_ms": device_ms(torch, kern), "bound_ms": ms,
        "bound_by": by}}
    fr = force_row(torch, theta, g, glue, mask)
    rows["svgd_force"] = {**{k: fr[k] for k in ("ms", "plain_ms",
                                                "bound_ms", "bound_by")},
                          "device_ms": fr["vs_columns"]["device_ms"],
                          "vs_columns": fr["vs_columns"]}
    out["timed"] = rows
    del theta, g, sq, want, glue
    torch.cuda.empty_cache()
    return out


def sci_flush_profile(torch, svc, reqs, B, members, fwd_flops):
    """Host and device busy ms of one flush of B rows, a profiled window
    opened with spins, beside its bounds: the members' params read once,
    and the members' forwards over B rows."""
    prof = profile_steps(torch, lambda: svc.batcher.run_batch(reqs[:B]),
                         n=5, prologue=32)
    ms, by = bound(members * SCI_D * 4, members * B * fwd_flops)
    return {"rows": B, "host_ms": prof["wall_ms"],
            "device_busy_ms": prof["device_busy_ms"],
            "idle_share": prof["idle_share"],
            "top_kernels_ms": prof["top_kernels_ms"],
            "bound_ms": ms, "bound_by": by}


def sci_diag_std_stack(torch, swag):
    """#4 over the (8, leaf) stacks of all 34 leaves (the handoff's one
    launch): bit-equal to the per-leaf kernel, then timed beside the
    per-leaf loop (``diag_std_timed``)."""
    from repro_torch.core.tree import tree_flatten
    means, sqs = ([x.contiguous() for x in tree_flatten(
        swag[k], sort_keys=True)[0]] for k in ("mean", "sq_mean"))
    out = {"particles": int(means[0].shape[0]),
           **diag_std_parity(torch, means, sqs, "the UNet's (8, ·) stacks"),
           **diag_std_timed(torch, means, sqs)}
    if out["elements"] != out["particles"] * SCI_D:
        raise AssertionError(f"UNet stacks of {out['elements']} entries")
    return out


def sci_serving(torch, algo, card):
    """Part (b): the trained MultiSWAG posterior (8 particles x 4 draws)
    served as a regression BMA to single-example ``u0 (L, 1)`` requests,
    then the store's own params with a p_kill under traffic. Returns the
    launches and the part's line."""
    import threading
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import advection_batch
    from repro_torch.runtime import ProgramCache
    from repro_torch.serve import serve
    cfg = algo.module.cfg
    L = cfg.max_seq_len
    P, S = SCI_P, SERVE_S
    members = P * S
    fwd_flops = unet_flops(cfg, L)
    out = {"phase": 12, "part": "b", "model": cfg.name, "particles": P,
           "samples_per_particle": S, "members": members,
           "static_tree_mb": members * SCI_D * 4 / 1e6, "card": card}
    launches = {}
    data = advection_batch(np.random.default_rng(11), SERVE_N, L)["u0"]
    reqs = [{"u0": u} for u in data]
    fns = reset_counts()
    t0 = time.perf_counter()
    svc = algo.posterior_predictive(samples_per_particle=S, kind="regress",
                                    max_batch=SERVE_MAX_BATCH,
                                    max_wait_ms=SERVE_WAIT_MS,
                                    warmup=reqs[0])
    torch.cuda.synchronize()
    got = read_counts(fns)
    add_counts(launches, got)
    if got["swag_diag_std"] != collect_launches(SCI_LEAVES) \
            or got["swag_moments"]:
        raise AssertionError(f"regress handoff launches {got}")
    row = {"handoff_s": time.perf_counter() - t0, "launches": got}
    try:
        cache = svc.engine.cache
        warm = cache.snapshot_stats()
        info = cache.program_costs()
        row["warmup"] = [{"bucket": 2**i, "graph": p["graph"],
                          "capture_s": p["capture_s"],
                          "pool_bytes": p["pool_bytes"]}
                         for i, p in enumerate(info)]
        if len(info) != 6 or not all(p["graph"] for p in info):
            raise AssertionError(f"warmup programs {info}")
        conc, row["concurrent"] = serve_traffic(svc, reqs, SERVE_CLIENTS)
        closed, row["closed_loop"] = serve_traffic(svc, reqs, 0)
        extra = cache.snapshot_stats()["cold_compiles"] \
            - warm["cold_compiles"]
        if extra:
            raise AssertionError(f"{extra} captures after warmup")
        row["profile"] = {f"bucket_{B}": sci_flush_profile(
            torch, svc, reqs, B, members, fwd_flops)
            for B in (1, SERVE_MAX_BATCH)}
        heads, outs = svc.predict_batch({"u0": data}, members=True)
        for p in conc[:1] + closed[:1]:
            if p.mean.shape != (L, 1) or p.variance.shape != (L, 1) \
                    or np.shape(p.entropy) or np.shape(p.mutual_info):
                raise AssertionError(f"served shapes {p.mean.shape}, "
                                     f"{p.variance.shape}")
        host = outs.double().cpu()
        row["members"] = tuple(outs.shape)
        row["served_vs_predict_batch"] = {
            "concurrent": served_vs_batch(conc, heads),
            "closed_loop": served_vs_batch(closed, heads)}
        row["mean_vs_host_members"] = float(
            (heads["mean"].double().cpu() - host.mean(0)).abs().max())
        row["variance_vs_host_members"] = float(
            (heads["variance"].double().cpu() - host.var(0, unbiased=False))
            .abs().max())
        if not (max(row["served_vs_predict_batch"].values()) <= 1e-5
                and row["mean_vs_host_members"] <= 1e-5
                and row["variance_vs_host_members"] <= 1e-5
                and row["members"][0] == members):
            raise AssertionError(f"regress serving: {row}")
        row["stats"] = svc.stats()
        row["variance_mean"] = float(heads["variance"].mean())
        del heads, outs, host
    finally:
        svc.close()
    out["predictive"] = row

    # #4 at the UNet's 34 leaves (P = 1 rows, and the (8, leaf) stacks the
    # handoff reads, timed over all the leaves), then sample_predict: one
    # launch a particle, whatever its draws
    swag = algo.store.dense("swag")
    out["diag_std"] = diag_std_serving_shapes(torch, swag, D=SCI_D)
    out["diag_std_stack"] = sci_diag_std_stack(torch, swag)
    del swag
    err, got, shape = sample_predict_check(torch, algo, {"u0": data[:8]},
                                           S=1)
    add_counts(launches, got)
    if got["swag_diag_std"] != P * collect_launches(SCI_LEAVES) \
            or got["swag_moments"] or not err <= 1e-5:
        raise AssertionError(f"sample_predict: {got}, {err}")
    out["sample_predict"] = {"draws": P, "launches": got,
                             "max_abs_err": err, "shape": shape}

    # the store's own params, a p_kill under traffic: the 7 live rows
    pd = algo.push_dist
    with serve(algo, kind="regress", max_batch=8, max_wait_ms=SERVE_WAIT_MS,
               warmup=reqs[0], cache=ProgramCache()) as ssvc:
        cold = ssvc.engine.cache.snapshot_stats()["cold_compiles"]
        gen = pd.store.generation()
        handles = []

        def client():
            for r in reqs[:128]:
                handles.append(ssvc.predict_async(r))

        t = threading.Thread(target=client)
        t.start()
        while len(handles) < 64:
            time.sleep(0.0005)
        pd.p_kill(pd.particle_ids()[3])
        t.join(120.0)
        for h in handles:
            h.result(120.0)
        post = [ssvc.predict(r, timeout=120.0) for r in reqs[:8]]
        st = ssvc.stats()
        _, outs = ssvc.predict_batch({"u0": data[:8]}, members=True)
        mean = outs.double().mean(0).cpu().numpy()
        srow = {"live": pd.store.live_count(), "member_rows": outs.shape[0],
                "captures_after_warmup_and_kill":
                    st["engine"]["program_cache"]["cold_compiles"] - cold,
                "generation_unchanged": pd.store.generation() == gen,
                "errors": st["errors"], "requests": st["requests"],
                "post_kill_vs_members_mean": max(
                    float(np.abs(p.mean - mean[i]).max())
                    for i, p in enumerate(post))}
        if srow["captures_after_warmup_and_kill"] or not \
                srow["generation_unchanged"] or srow["errors"] or \
                srow["member_rows"] != P - 1 or \
                not srow["post_kill_vs_members_mean"] <= 1e-5:
            raise AssertionError(f"regress store serving under churn: "
                                 f"{srow}")
        del outs
    out["store_serving"] = srow
    out["launches"] = launches
    n_leaves = len(tree_leaves(pd.p_params(pd.particle_ids()[0])))
    if n_leaves != SCI_LEAVES:
        raise AssertionError(f"{n_leaves} leaves")
    return launches, out


def fig4_rows(torch, card, fig4_p8, vit_rows):
    """Part (c): ms per epoch and samples/s of ensemble, multiswag and svgd
    under captured, nel and baseline: the UNet at 2, 4 and 8 particles
    (8: part (a)'s runs), ViT-MNIST's baselines at phase 4's shape beside
    phases 4 and 8's step times; and the ensemble baseline held to the
    fused DeepEnsemble at full width. Returns the launches and the
    part's line."""
    from repro_torch.bdl import DeepEnsemble, MultiSWAG, SteinVGD, baselines
    from repro_torch.core.functional import flatten_rows
    from repro_torch.optim import adam, sgd
    from repro_torch.runtime import ProgramCache
    cfg, module = unet_module()
    opt = adam(1e-3)
    algos = {"ensemble": (DeepEnsemble, {"optimizer": opt}),
             "multiswag": (MultiSWAG, {"optimizer": opt,
                                       "pretrain_epochs": 0,
                                       "max_rank": 20}),
             "svgd": (SteinVGD, {"lengthscale": 0.0, "lr": 5e-2})}
    keys = ("ms_per_epoch", "samples_per_s", "wall_s", "peak_gb")
    out = {"phase": 12, "part": "c", "card": card,
           "unet": {"batch": SCI_B, "batches_per_epoch": SCI_NB,
                    "epochs": 2, "timed": "the last epoch"},
           "vit_mnist": {"batch": TRAIN_B, "batches_per_epoch": TRAIN_NB}}
    launches, rows = {}, {}
    for name, (cls, kw) in algos.items():
        rows[name] = {}
        for P in SCI_FIG4_P + (SCI_P,):
            r = {}
            if P == SCI_P:
                r["captured"] = {k: fig4_p8[name]["captured"][k]
                                 for k in keys}
                r["nel"] = {k: fig4_p8[name]["nel"][k] for k in keys}
            else:
                for impl, backend, cache in (
                        ("captured", "compiled", ProgramCache()),
                        ("nel", "nel", None)):
                    algo, row = sci_train(torch, cls, module, P, 2, backend,
                                          cache, **kw)
                    add_counts(launches, row["launches"])
                    r[impl] = {k: row[k] for k in keys}
                    algo.cleanup()
                    del algo
            _, row = sci_baseline(torch, name, module, P, 2, SCI_B, SCI_NB,
                                  **kw)
            add_counts(launches, row["launches"])
            r["baseline"] = {k: row[k] for k in keys + ("captured", "cache")}
            rows[name][f"P={P}"] = r
            gc.collect()
            torch.cuda.empty_cache()
    out["unet"]["rows"] = rows

    # the gate: tests/test_bdl.py's check at full width
    got, _ = baselines.ensemble_baseline(
        module, sgd(0.05), SCI_P, sci_loader(torch, cfg, SCI_B, SCI_NB), 1,
        seed=SEED)
    fused = DeepEnsemble(module, seed=SEED, backend="compiled")
    fused.push_dist.runtime.cache = ProgramCache()
    fused.bayes_infer(sci_loader(torch, cfg, SCI_B, SCI_NB), 1,
                      optimizer=sgd(0.05), num_particles=SCI_P)
    out["ensemble_baseline_vs_fused"] = float(
        (flatten_rows(got)[0] - flatten_rows(fused.p_parameters())[0])
        .abs().max())
    fused.cleanup()
    del got, fused
    if not out["ensemble_baseline_vs_fused"] <= 1e-5:
        raise AssertionError(f"ensemble baseline vs fused: "
                             f"{out['ensemble_baseline_vs_fused']}")

    # ViT-MNIST: the baselines at phase 4's shape, beside the captured and
    # NEL step times of phases 4 and 8 (an epoch: TRAIN_NB steps, plus a
    # collection for multiswag)
    vcfg, vmodule = vit_module()
    vkw = {"ensemble": {"optimizer": adam(1e-3)},
           "multiswag": {"optimizer": adam(1e-3), "pretrain_epochs": 0,
                         "max_rank": 20},
           "svgd": {"lengthscale": 0.0, "lr": 1e-3}}
    vrows = {}
    for name, kw in vkw.items():
        _, row = sci_baseline(torch, name, vmodule, TRAIN_P, 2, TRAIN_B,
                              TRAIN_NB, **kw)
        add_counts(launches, row["launches"])
        vrows[name] = {**vit_rows[name],
                       "baseline": {k: row[k] for k in
                                    keys + ("captured", "cache")}}
        gc.collect()
        torch.cuda.empty_cache()
    out["vit_mnist"]["rows"] = vrows
    return launches, out


def vit_fig4(steps):
    """Phase 4's captured and phase 8's NEL step times of ViT-MNIST as
    Fig. 4 rows: ms per epoch (TRAIN_NB steps, plus one collection for
    multiswag) and samples/s."""
    rows = {}
    for name, s in steps.items():
        rows[name] = {}
        for impl in ("captured", "nel"):
            ms = TRAIN_NB * s[f"{impl}_step_ms"] \
                + s.get(f"{impl}_collect_ms", 0.0)
            rows[name][impl] = {
                "ms_per_epoch": ms,
                "samples_per_s": TRAIN_P * TRAIN_B * TRAIN_NB / ms * 1e3,
                "from": s["from"][impl]}
    return rows


def phase12(torch, card, vit_rows):
    """The paper's SciML workload and Fig. 4 on the card (module doc).
    Returns each kernel's launches over phase 12's driven runs."""
    t0 = time.perf_counter()
    total, walls = {}, {}
    got, fig4_p8, algo, a_line = sci_training(torch, card)
    add_counts(total, got)
    emit(a_line)
    walls["a"] = time.perf_counter() - t0
    got, b_line = sci_serving(torch, algo, card)
    add_counts(total, got)
    emit(b_line)
    algo.cleanup()
    del algo
    gc.collect()
    torch.cuda.empty_cache()
    walls["b"] = time.perf_counter() - t0 - sum(walls.values())
    got, line = fig4_rows(torch, card, fig4_p8, vit_rows)
    add_counts(total, got)
    emit(line)
    walls["c"] = time.perf_counter() - t0 - sum(walls.values())
    missing = [k for k in SCI_KERNELS if not total.get(k)]
    if missing:
        raise AssertionError(f"phase 12 never launched {missing}")
    emit({"phase": 12, "part": "end", "launches": total,
          "wall_s": time.perf_counter() - t0, "wall_s_by_part": walls,
          "card": card})
    # #1-#4 at the UNet's shapes, for the kernels line
    kv = a_line["svgd"]["captured"]["kernels_vs_plain"]
    moments = a_line["multiswag"]["captured"]
    rows = {"pairwise_sqdist": {"shape": kv["shape"],
                                "path": kv["sqdist_path"],
                                "max_rel_err": kv["sqdist_rel"],
                                **kv["timed"]["pairwise_sqdist"]},
            "svgd_force": {"shape": kv["shape"],
                           "max_rel_err": kv["force_rel"],
                           **kv["timed"]["svgd_force"]},
            "swag_moments": {
                "max_abs_err":
                    moments["moments_kernel_vs_plain"]["max_abs_err"],
                **moments["moments_timed"],
                "captured_collection_device_ms":
                    moments["collect"]["device_busy_ms"]},
            "swag_diag_std": {**b_line["diag_std"],
                              "stack": b_line["diag_std_stack"]}}
    return total, rows


# ---------------------------------------------------------------------------
# phase 13: LM training (qwen1.5-0.5b particles through the normal entry
# points: DeepEnsemble with Adam under warmup_cosine and with Adafactor,
# captured and on the NEL, and SteinVGD)
# ---------------------------------------------------------------------------

LM_P = 4                         # particles (phase 2's serving count)
LM_B, LM_S = 1, 2048             # one 2048-token sequence a step
LM_STEPS = 8                     # part (a)'s captured steps
LM_EAGER = 2                     # ... and the eager cache's from the same init
LM_SCHED = (3e-3, 2, 8)          # examples/train_lm.py's warmup_cosine(3e-3, 20, steps), cut to 8 steps
LM_AF_SCHED = (1e-2, 2, 8)       # adafactor's default lr under the same warmup
LM_AF_STEPS = 4
LM_SVGD_STEPS = 4
LM_SVGD_LR = 1e-3
LM_REMAT = ("nothing_saveable", "dots_saveable")
LM_D = 463_987_712               # parameters per qwen1.5-0.5b particle
LM_UNITS = 6                     # phase 13's depth cut: 6 of its 24 units
LM_Q_CHUNK, LM_K_CHUNK = 512, 1024   # models.blocks.flash_attention's chunks
LM_LOSS_CHUNK = 512              # models.api.LOSS_CHUNK


def lm_module(cfg):
    """qwen1.5-0.5b's ParticleModule for training: the dense family's
    ``api.loss_fn`` over the stacked particles."""
    from repro_torch.core import ParticleModule
    from repro_torch.models import api
    return ParticleModule(init=lambda g: api.init_params(g, cfg),
                          loss=lambda p, b: api.loss_fn(p, b, cfg), cfg=cfg)


def lm_batches(cfg, n):
    """The seeded loader's first ``n`` host batches (lm_batch, B x S)."""
    from repro_torch.data import DataLoader
    return list(DataLoader(cfg, batch_size=LM_B, seq_len=LM_S,
                           num_batches=n, seed=SEED))


def lm_live_entries(S, q_chunk=LM_Q_CHUNK, k_chunk=LM_K_CHUNK):
    """Score entries the causal chunked attention computes for one
    sequence and head: every block but those its mask empties (k_lo >
    q_hi), which ``blocks.flash_attention`` skips."""
    qc, kc = min(q_chunk, S), min(k_chunk, S)
    nq, nk = -(-S // qc), -(-S // kc)
    return sum(qc * kc for qi in range(nq) for ki in range(nk)
               if not ki * kc > (qi + 1) * qc - 1)


def lm_attention_flops(S, hd, code=False):
    """FLOPs of one sequence and head of causal attention, forward and
    backward: 4 hd a score entry forward (QK^T, PV) and 8 hd backward
    (dP, dQ, dK, dV) over the S(S+1)/2 entries the mask keeps. With
    ``code``, what ``blocks.flash_attention`` computes: every entry of the
    blocks the mask does not empty (``lm_live_entries``), and 2 hd more
    for the backward's recompute of the scores."""
    if code:
        return lm_live_entries(S) * hd * 14
    return S * (S + 1) // 2 * hd * 12


def lm_step_flops(cfg, P, B, S):
    """FLOPs of one train step. ``total`` is what the step needs: the
    dense and head products forward and backward (3 x 2 x MACs a token)
    and the causal attention (``lm_attention_flops``). ``code_total`` is
    what the code computes: also the loss chunks' checkpointed head
    forward again (2 x MACs a token) and the chunked attention's masked
    entries and score recompute."""
    D, F, V, hd = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.hd
    H, KVH, L = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    dense = L * (D * H * hd + 2 * D * KVH * hd + H * hd * D + 3 * D * F)
    head = D * V
    tokens = P * B * S
    heads = P * B * L * H
    attn = heads * lm_attention_flops(S, hd)
    code_attn = heads * lm_attention_flops(S, hd, code=True)
    return {"dense_head": 6 * (dense + head) * tokens, "attention": attn,
            "total": 6 * (dense + head) * tokens + attn,
            "code_loss_recompute": 2 * head * tokens,
            "code_attention": code_attn,
            "code_total": 6 * (dense + head) * tokens + 2 * head * tokens
            + code_attn}


def np_warmup_cosine(lr, warmup, total, s, final_frac=0.1):
    """The schedule's formula in float64 (numpy), for the read-back gate."""
    s = np.asarray(s, np.float64)
    t = np.minimum(s - warmup, max(total - warmup, 1)) / max(total - warmup, 1)
    cos = lr * (final_frac + (1 - final_frac) * 0.5 * (1 + np.cos(np.pi * t)))
    return np.where(s < warmup, lr * s / max(warmup, 1), cos)


def host_tree(tree):
    from repro_torch.core.tree import tree_map
    return tree_map(lambda x: x.detach().to("cpu", copy=True), tree)


def kept_tree(torch, tree, peak_gb):
    """A snapshot of ``tree`` for a later bit-for-bit comparison: a clone
    on the card when it fits beside ``peak_gb`` (the run it came from; the
    run it is compared with peaks about as high) within 80% of the card,
    else a host copy (``host_tree``)."""
    from repro_torch.core.tree import tree_leaves, tree_map
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(tree))
    total = torch.cuda.get_device_properties(0).total_memory
    if peak_gb * 2**30 + nbytes < 0.8 * total:
        return tree_map(lambda x: x.detach().clone(), tree)
    return host_tree(tree)


def tree_rel(torch, got, want):
    """Largest per-leaf max |got - want| / max |want| (``want`` may live
    on the host: each leaf is moved over in turn)."""
    from repro_torch.core.tree import tree_leaves
    worst = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        b = b.to(a.device)
        top = float(b.abs().max())
        worst = max(worst, float((a - b).abs().max()) / (top or 1.0))
    return worst


def tree_equal(torch, got, want):
    from repro_torch.core.tree import tree_leaves
    return all(torch.equal(a, b.to(a.device))
               for a, b in zip(tree_leaves(got), tree_leaves(want)))


def lm_run(torch, cls, module, batches, cache, keep_first=False, **kw):
    """One driven run of ``cls`` over LM_P fresh particles (seed SEED) with
    ``cache`` on the PD's runtime, a step a call so that every step's
    losses come back: ``bayes_infer`` over the first batch (the step
    program is looked up, and captured, there), then the algorithm's
    fused epoch loop over each next batch on the same particles (a cache
    hit each). Between a reset and a read of the kernels' counts. Returns
    (algorithm, row, the params after the first step on the host or
    None)."""
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30
    algo = cls(module, seed=SEED, backend="compiled")
    algo.push_dist.runtime.cache = cache
    fns = reset_counts()
    losses, step_s, first = [], [], None
    t0 = time.perf_counter()
    pids, ls = algo.bayes_infer([batches[0]], 1, num_particles=LM_P, **kw)
    losses.append(ls)
    step_s.append(time.perf_counter() - t0)
    if keep_first:
        first = host_tree(algo.store.stacked("params"))
    for b in batches[1:]:
        t1 = time.perf_counter()
        losses.append(algo._fused_epochs(pids, [b], 1, **kw))
        step_s.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    row = {"steps": len(batches), "losses": losses,
           "launches": read_counts(fns), "wall_s": time.perf_counter() - t0,
           "step_host_s": step_s, "stats": cache.snapshot_stats(),
           "programs": cache.program_costs(compute=True),
           "resident_gb": resident,
           "peak_gb": torch.cuda.max_memory_allocated() / 2**30}
    if not np.isfinite(losses).all():
        raise AssertionError(f"LM {cls.__name__} losses {losses}")
    return algo, row, first


def lm_captured_once(row, what):
    """One program, looked up and captured once (at the first step), a
    CUDA graph; nothing captured after it."""
    st, info = row["stats"], row["programs"]
    if not (len(info) == 1 and info[0]["graph"] and st["misses"] == 1
            and st["cold_compiles"] == 1 and st["hits"] == row["steps"] - 1):
        raise AssertionError(f"{what}: programs {info}, stats {st}")


def lm_window(torch, algo, spec, keys, batch, **kw):
    """``program_window`` of the algorithm's own step program on its
    checked-out state (``kw``: n, fns, hold, prologue)."""
    store = algo.store
    co = {k: store.checkout(k) for k in keys}
    try:
        prof = program_window(torch, algo.push_dist.runtime, spec,
                              tuple(co[k] for k in keys)
                              + (algo._batch(batch), store.active_mask()),
                              **kw)
    finally:
        for k in keys:
            store.commit(k, co[k])
    prof["pool_gb"] = prof.pop("pool_bytes") / 2**30
    return prof


def lm_free(torch):
    """After the caller dropped its last reference to a run's algorithm:
    collect the PD's reference cycles and return the cached blocks, so
    that the next run's state finds the card empty."""
    gc.collect()
    torch.cuda.empty_cache()


def lm_attention_check(torch, cfg, card):
    """The chunked attention's forward and backward at one layer's shape
    (P 4, B 1, S 2048, 16 heads of 64) against ``full_attention`` under
    autograd, within 1e-4 of each output's largest entry; both timed
    (event ms, L2 flushed) beside one SDPA forward + backward at the same
    shape (a yardstick the port never calls) and the bound."""
    import torch.nn.functional as F
    from repro_torch.models import blocks
    P, B, S, H, hd = LM_P, LM_B, LM_S, cfg.n_heads, cfg.hd
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v, do = (torch.randn((P, B, S, H, hd), generator=gen,
                               device="cuda") for _ in range(4))

    def fwd_bwd(fn):
        def run():
            args = [x.detach().requires_grad_(True) for x in (q, k, v)]
            out = fn(*args)
            return (out.detach(),) + torch.autograd.grad(out, args, do)
        return run

    flash = fwd_bwd(lambda a, b, c: blocks.flash_attention(a, b, c,
                                                           kind="causal"))
    plain = fwd_bwd(lambda a, b, c: blocks.full_attention(a, b, c,
                                                          causal=True))

    def sdpa_layout(x):
        return x.reshape(P * B, S, H, hd).transpose(1, 2)

    sdpa = fwd_bwd(lambda a, b, c: F.scaled_dot_product_attention(
        sdpa_layout(a), sdpa_layout(b), sdpa_layout(c),
        is_causal=True).transpose(1, 2).reshape(P, B, S, H, hd))
    got, want = flash(), plain()
    errs = {n: rel_err(a, b) for n, a, b in zip(("out", "dq", "dk", "dv"),
                                                got, want)}
    del got, want
    if not all(e < 1e-4 for e in errs.values()):
        raise AssertionError(f"chunked attention vs full_attention: {errs}")
    flops = P * B * H * lm_attention_flops(S, hd)
    code_flops = P * B * H * lm_attention_flops(S, hd, code=True)
    ms, by = bound(8 * P * B * S * H * hd * 4, flops)
    row = {"shape": [P, B, S, H, hd], "max_rel_err": errs,
           "fwd_bwd_ms": time_ms(torch, flash, iters=10),
           "fwd_bwd_device_ms": device_ms(torch, flash, n=5),
           "plain_fwd_bwd_ms": time_ms(torch, plain, iters=10),
           "sdpa_fwd_bwd_ms": time_ms(torch, sdpa, iters=10),
           "bound_ms": ms, "bound_by": by, "flops": flops,
           "code_flops": code_flops,
           "code_bound_ms": bound(8 * P * B * S * H * hd * 4, code_flops)[0],
           "card": card}
    del q, k, v, do
    torch.cuda.empty_cache()
    return row


def lm_ce_check(torch, cfg, card):
    """``_chunked_ce``'s per-particle loss and its grads in x and the tied
    head against one unchunked cross-entropy of the same logits (the
    whole (P, S, V) logits at once), within 1e-5 relative, at the step's
    shape with a few labels masked; both timed (forward + backward)."""
    from repro_torch.models import api
    P, B, S, D, V = LM_P, LM_B, LM_S, cfg.d_model, cfg.vocab_size
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    x = torch.randn((P, B, S, D), generator=gen, device="cuda")
    emb = torch.randn((P, V, D), generator=gen, device="cuda") * 0.02
    labels = torch.from_numpy(lm_batches(cfg, 1)[0]["labels"]).to("cuda")
    labels[:, ::97] = -1

    def unchunked(e, xx):
        logits = torch.bmm(xx.reshape(P, -1, D), e.transpose(1, 2)).float()
        lse = torch.logsumexp(logits, -1)
        lab = labels.reshape(-1)
        gold = logits.gather(-1, lab.clamp(min=0).long().expand(
            P, -1)[..., None])[..., 0]
        m = (lab >= 0).float()
        return ((lse - gold) * m).sum(-1) / m.sum().clamp(min=1.0)

    def fwd_bwd(fn):
        def run():
            e, xx = emb.detach().requires_grad_(True), \
                x.detach().requires_grad_(True)
            loss = fn(e, xx)
            return (loss.detach(),) + torch.autograd.grad(loss.sum(),
                                                          (e, xx))
        return run

    chunked = fwd_bwd(lambda e, xx: api._chunked_ce({"embed": e}, xx, labels,
                                                    cfg))
    plain = fwd_bwd(unchunked)
    got, want = chunked(), plain()
    errs = {n: rel_err(a, b) for n, a, b in zip(("loss", "d_embed", "d_x"),
                                                got, want)}
    del got, want
    if not all(e < 1e-5 for e in errs.values()):
        raise AssertionError(f"chunked CE vs unchunked: {errs}")
    # 6 FLOPs a MAC: the logits, d_x and d_embed; the chunks' checkpoint
    # computes the logits twice (8)
    flops, code_flops = 6 * P * B * S * D * V, 8 * P * B * S * D * V
    nbytes = 4 * (2 * P * V * D + 2 * P * B * S * D)
    ms, by = bound(nbytes, flops)
    row = {"shape": [P, B, S, D, V], "chunks": -(-S // LM_LOSS_CHUNK),
           "max_rel_err": errs, "fwd_bwd_ms": time_ms(torch, chunked,
                                                      iters=5),
           "unchunked_fwd_bwd_ms": time_ms(torch, plain, iters=5),
           "bound_ms": ms, "bound_by": by, "flops": flops,
           "code_flops": code_flops,
           "code_bound_ms": bound(nbytes, code_flops)[0], "card": card}
    del x, emb, labels
    torch.cuda.empty_cache()
    return row


def lm_ensemble(torch, cfg, module, batches, card, total):
    """(a) DeepEnsemble with adam(warmup_cosine(3e-3, 2, 8)), eager for 2
    steps and then captured for 8 from the same init (its line printed
    here); (b) the first step again under each remat policy, captured.
    Returns the two parts' lines and the first step's losses and params
    (on the host) for part (e)."""
    from repro_torch.bdl import DeepEnsemble
    from repro_torch.optim import adam, warmup_cosine
    from repro_torch.runtime import ProgramCache, eager, specs
    sched = warmup_cosine(*LM_SCHED)
    flops = lm_step_flops(cfg, LM_P, LM_B, LM_S)
    b_ms, b_by = bound(4 * 4 * LM_P * p17_param_count(cfg), flops["total"])
    runs = {}
    algo, runs["eager"], first = lm_run(
        torch, DeepEnsemble, module, batches[:LM_EAGER],
        ProgramCache(capturer=eager), keep_first=True, optimizer=adam(sched))
    add_counts(total, runs["eager"]["launches"])
    algo.cleanup()
    del algo
    lm_free(torch)
    opt = adam(sched)
    algo, runs["captured"], first_c = lm_run(
        torch, DeepEnsemble, module, batches[:LM_STEPS], ProgramCache(),
        keep_first=True, optimizer=opt)
    add_counts(total, runs["captured"]["launches"])
    cap, eag = runs["captured"], runs["eager"]
    lm_captured_once(cap, "captured DeepEnsemble")
    if cap["losses"][:LM_EAGER] != eag["losses"]:
        raise AssertionError(f"captured losses {cap['losses'][:LM_EAGER]} "
                             f"!= eager {eag['losses']}")
    if not tree_equal(torch, first_c, first):
        raise AssertionError(f"captured params after step 1 != eager's: "
                             f"{tree_rel(torch, first_c, first)}")
    del first_c
    # the step's FLOPs as obs counts them on its first run (the capture's
    # warm-up), against lm_step_flops' count of what the code computes
    counted = cap["programs"][0]["cost"]["flops"]
    counted_rel = counted / flops["code_total"] - 1
    if not abs(counted_rel) < P14_CODE_TOL:
        raise AssertionError(f"counted {counted} FLOPs a step, code_flops "
                             f"{flops['code_total']}")
    same_launches({m: r["launches"] for m, r in runs.items()}, "LM ensemble")
    if any(cap["launches"].values()):
        raise AssertionError(f"LM training launched {cap['launches']}")
    # the schedule read back on the card: the store's steps, then steps
    # 1-8 one by one, against the formula in numpy
    steps = [int(s) for s in algo.store.dense("opt_state")["step"].cpu()]
    got = [float(sched(torch.full((LM_P,), s, dtype=torch.int32,
                                  device="cuda"))[0])
           for s in range(1, LM_STEPS + 1)]
    want = np_warmup_cosine(*LM_SCHED, np.arange(1, LM_STEPS + 1))
    lr_rel = float(np.abs(np.array(got) - want).max() / want.max())
    if not (lr_rel < 1e-6 and steps == [LM_STEPS] * LM_P):
        raise AssertionError(f"schedule read back {got} at steps {steps}, "
                             f"numpy {want.tolist()}")
    spec = specs.ensemble_step(module.loss, opt, precision=algo.precision)
    prof = lm_window(torch, algo, spec, ("params", "opt_state"), batches[0])
    adam_gb = algo.store.per_device_bytes("opt_state") / 2**30
    peak = torch.cuda.max_memory_allocated() / 2**30
    algo.cleanup()
    del algo
    lm_free(torch)
    tokens = LM_P * LM_B * LM_S
    a_line = {"phase": 13, "part": "a",
              "config": {"name": cfg.name, "layers": cfg.n_layers},
              "particles": LM_P, "batch": LM_B, "seq_len": LM_S,
              "optimizer": "adam(warmup_cosine(%g, %d, %d))" % LM_SCHED,
              "runs": runs, "opt_state_steps": steps, "lr_by_step": got,
              "lr_rel_err": lr_rel, "step_host_ms": prof["wall_ms"],
              "step_device_ms": prof["device_busy_ms"],
              "idle_share": prof["idle_share"],
              "tokens_per_s": tokens / prof["wall_ms"] * 1e3,
              "profile": prof, "peak_gb": peak, "opt_state_gb": adam_gb,
              "step_flops": flops, "bound_ms": b_ms, "bound_by": b_by,
              "code_bound_ms": bound(4 * 4 * LM_P * p17_param_count(cfg),
                                     flops["code_total"])[0],
              "counted_flops": counted, "code_flops": flops["code_total"],
              "counted_over_code": counted_rel + 1, "card": card}
    emit(a_line)
    remat = {"none": {"peak_gb": cap["peak_gb"],
                      "pool_gb": cap["programs"][0]["pool_bytes"] / 2**30,
                      "step_device_ms": prof["device_busy_ms"],
                      "step_host_ms": prof["wall_ms"]}}
    for name in LM_REMAT:
        mod = lm_module(cfg.replace(remat_policy=name))
        opt = adam(sched)
        algo, row, p1 = lm_run(torch, DeepEnsemble, mod, batches[:1],
                               ProgramCache(), keep_first=True,
                               optimizer=opt)
        add_counts(total, row["launches"])
        lm_captured_once(row, f"remat {name}")
        d_loss = float(np.abs(np.array(row["losses"][0])
                              - eag["losses"][0]).max())
        p_rel = tree_rel(torch, p1, first)
        del p1
        if not (d_loss < 1e-5 and p_rel < 1e-6):
            raise AssertionError(f"remat {name}: losses {row['losses'][0]} "
                                 f"vs {eag['losses'][0]}, params rel {p_rel}")
        prof = lm_window(torch, algo, specs.ensemble_step(
            mod.loss, opt, precision=algo.precision),
            ("params", "opt_state"), batches[0], n=1)
        remat[name] = {"loss_max_abs_diff": d_loss, "params_max_rel": p_rel,
                       "peak_gb": row["peak_gb"],
                       "pool_gb": row["programs"][0]["pool_bytes"] / 2**30,
                       "capture_s": row["programs"][0]["capture_s"],
                       "step_device_ms": prof["device_busy_ms"],
                       "step_host_ms": prof["wall_ms"]}
        algo.cleanup()
        del algo
        lm_free(torch)
    b_line = {"phase": 13, "part": "b", "remat": remat, "card": card}
    return a_line, b_line, eag["losses"][0], first


LM_AF_LEAF = ("units", 0, "attn", "wq", "w")   # (P, LM_UNITS, 1024, 1024)


def lm_leaf(tree, path=LM_AF_LEAF):
    for k in path:
        tree = tree[k]
    return tree


def np_adafactor_first(g, lr, eps=1e-30, clip=1.0):
    """Adafactor's first update of one factored leaf (P, ..., r, c), the
    formula in float64: beta = 0 at step 1, so vr and vc are the row and
    column means of g^2 + eps; u = g / sqrt(vr vc / mean(vr) + eps),
    clipped by its RMS over each particle's axes. Returns lr * u."""
    g2 = g * g + eps
    vr, vc = g2.mean(-1), g2.mean(-2)
    denom = vr[..., None] * vc[..., None, :] / np.maximum(
        vr.mean(-1, keepdims=True)[..., None], eps)
    u = g / np.sqrt(denom + eps)
    rms = np.sqrt((u * u).reshape(len(u), -1).mean(-1) + 1e-12)
    u = u / np.maximum(rms / clip, 1.0).reshape((-1,) + (1,) * (u.ndim - 1))
    return lr * u


def lm_adafactor_first(torch, module, opt, batch, p1):
    """The captured run's first Adafactor update of one factored leaf
    (``LM_AF_LEAF``: p0 - p1, p1 that leaf after step 1) against
    ``np_adafactor_first`` of the same grads: the particles made again
    from SEED (the run's init), the grads of the step's
    ``ensemble_value_and_grad`` at it. Returns the largest difference
    over the largest update."""
    from repro_torch.bdl import DeepEnsemble
    from repro_torch.core.functional import ensemble_value_and_grad
    from repro_torch.core.tree import tree_map
    probe = DeepEnsemble(module, seed=SEED, backend="compiled")
    for _ in range(LM_P):
        probe.push_dist.p_create(opt)
    params = tree_map(lambda x: x[:LM_P], probe.store.stacked("params"))
    p0 = lm_leaf(params).double().cpu().numpy()
    _, grads = ensemble_value_and_grad(module.loss)(params,
                                                    probe._batch(batch))
    g = lm_leaf(grads).double().cpu().numpy()
    del params, grads
    probe.cleanup()
    del probe
    lm_free(torch)
    want = np_adafactor_first(g, float(np_warmup_cosine(*LM_AF_SCHED, 1)))
    got = p0 - p1[:LM_P].double().numpy()
    return float(np.abs(got - want).max() / np.abs(want).max())


def lm_adafactor(torch, cfg, batches, card, total, adam_gb):
    """(c) DeepEnsemble with adafactor(warmup_cosine(1e-2, 2, 8)), built
    from the config (``optimizer="adafactor"``), captured, 4 steps: finite
    losses, one capture, and the first update of a factored leaf within
    1e-5 of the formula's (``lm_adafactor_first``); its state's bytes
    beside Adam's."""
    from repro_torch.bdl import DeepEnsemble
    from repro_torch.optim import make_optimizer, warmup_cosine
    from repro_torch.runtime import ProgramCache
    af_cfg = cfg.replace(optimizer="adafactor")
    module = lm_module(af_cfg)
    opt = make_optimizer(af_cfg, warmup_cosine(*LM_AF_SCHED))
    algo, row, p1 = lm_run(torch, DeepEnsemble, module,
                           batches[:LM_AF_STEPS], ProgramCache(),
                           keep_first=True, optimizer=opt)
    add_counts(total, row["launches"])
    lm_captured_once(row, "captured Adafactor")
    af_gb = algo.store.per_device_bytes("opt_state") / 2**30
    algo.cleanup()
    del algo
    lm_free(torch)
    first_rel = lm_adafactor_first(torch, module, opt, batches[0],
                                   lm_leaf(p1))
    if not first_rel < 1e-5:
        raise AssertionError(f"Adafactor's first update of {LM_AF_LEAF} is "
                             f"{first_rel} off the formula's")
    return {"phase": 13, "part": "c", "optimizer": af_cfg.optimizer,
            "schedule": "warmup_cosine(%g, %d, %d)" % LM_AF_SCHED,
            "run": row, "first_update_leaf": list(LM_AF_LEAF),
            "first_update_rel_err": first_rel, "opt_state_gb": af_gb,
            "adam_opt_state_gb": adam_gb,
            "step_host_ms_after_capture": [s * 1e3 for s in
                                           row["step_host_s"][1:]],
            "card": card}


def lm_svgd(torch, module, batches, card, total):
    """(d) SteinVGD (median heuristic), captured, 4 steps at P = 4: #1 and
    #2 once a step at (4, D), #1 on its bulk-copy path; a
    profiled window of the step program whose counters equal the
    profiler's; then each kernel on the trained state against its plain
    version (sqdist within 1e-5 of its largest entry, against the plain
    version in fp64, the force 2e-4 relative), timed beside its bound."""
    from repro_torch.bdl import SteinVGD
    from repro_torch.bdl.svgd import rbf_glue, svgd_force, svgd_step_spec
    from repro_torch.core.functional import (ensemble_value_and_grad,
                                             flatten_stacked)
    from repro_torch.kernels import ref, svgd_rbf
    from repro_torch.runtime import ProgramCache
    kw = {"lr": LM_SVGD_LR, "lengthscale": 0.0}
    algo, row, _ = lm_run(torch, SteinVGD, module, batches[:LM_SVGD_STEPS],
                          ProgramCache(), **kw)
    add_counts(total, row["launches"])
    lm_captured_once(row, "captured SteinVGD")
    want = {"pairwise_sqdist": LM_SVGD_STEPS, "svgd_force": LM_SVGD_STEPS}
    got = {k: row["launches"][k] for k in want}
    if got != want or sum(row["launches"].values()) != sum(want.values()):
        raise AssertionError(f"SteinVGD launches {row['launches']}")
    spec = svgd_step_spec(module.loss, precision=algo.precision, **kw)
    prof = lm_window(torch, algo, spec, ("params",), batches[0], n=2,
                     fns=train_counts(), hold=hold_train_to_profiler,
                     prologue=32)
    # each kernel's device ms a step in the profiled window (one launch
    # a step; the sqdist wrapper's second kernel counted with its first)
    mine = prof["tracked_ms"]
    in_step = {"pairwise_sqdist": mine["sqdist_stream_kernel"]
               + mine["sqdist_sum_kernel"],
               "svgd_force": mine["force_stream_kernel"]}
    algo.push_dist.runtime.cache.clear()        # the step's graph pool
    gc.collect()
    torch.cuda.empty_cache()
    params = algo.store.stacked("params")
    batch = algo._batch(batches[0])
    grads = ensemble_value_and_grad(module.loss)(params, batch)[1]
    theta = flatten_stacked(params)[0]
    g = flatten_stacked(grads)[0]
    del grads, params
    n, D = theta.shape
    plan = svgd_rbf.plan_for(theta)
    sq = sqdist_exact(torch, svgd_rbf, theta, None, "LM sqdist")
    # the plain version's Gram form in fp32 sums 463,987,712 products an
    # entry and lands ~5e-4 of the largest entry off on an H100: both are
    # held to the plain version computed in fp64
    exact = ref.pairwise_sqdist(theta.double()).float()
    plain = ref.pairwise_sqdist(theta)
    top = exact.abs().max()
    checks = {"shape": [n, D], "sqdist_path": plan.path,
              "sqdist_rel": float((sq - exact).abs().max() / top),
              "plain_fp32_sqdist_rel": float((plain - exact).abs().max()
                                             / top)}
    del plain, exact
    torch.cuda.empty_cache()
    checks["force_rel"] = rel_err(svgd_force(theta, g, 0.0),
                                  plain_force(theta, g, 0.0))
    torch.cuda.empty_cache()
    if plan.path != "bulk" or D != p17_param_count(module.cfg) or not (
            checks["sqdist_rel"] < 1e-5 and checks["force_rel"] < 2e-4):
        raise AssertionError(f"LM SVGD kernels vs plain: {checks}")
    glue = rbf_glue(sq, 0.0)
    checks["force_equals_columns"] = force_equals_columns(torch, theta, g, glue)
    if checks["force_equals_columns"] is not True:
        raise AssertionError(f"LM force: not the column kernel's bits: "
                             f"{checks}")
    nbytes = n * D * 4
    ms, by = bound(nbytes + n * n * 4, 3 * n * n * D)
    kern = lambda: svgd_rbf.pairwise_sqdist(theta)
    timed = {"pairwise_sqdist": {
        "ms": time_ms(torch, kern, iters=10),
        "plain_ms": time_ms(torch, lambda: ref.pairwise_sqdist(theta),
                            iters=5),
        "device_ms": device_ms(torch, kern, n=5),
        "in_step_device_ms": in_step["pairwise_sqdist"],
        "bound_ms": ms, "bound_by": by, "bytes": nbytes + n * n * 4}}
    torch.cuda.empty_cache()
    fr = force_row(torch, theta, g, glue, iters=10)
    timed["svgd_force"] = {**{k: fr[k] for k in ("ms", "plain_ms",
                                                 "bound_ms", "bound_by")},
                           "device_ms": fr["vs_columns"]["device_ms"],
                           "in_step_device_ms": in_step["svgd_force"],
                           "bytes": 3 * nbytes, "vs_columns": fr["vs_columns"]}
    torch.cuda.empty_cache()
    checks["timed"] = timed
    del theta, g, sq, glue
    algo.cleanup()
    del algo
    lm_free(torch)
    return {"phase": 13, "part": "d", "run": row, "lr": LM_SVGD_LR,
            "lengthscale": "median", "step_host_ms": prof["wall_ms"],
            "step_device_ms": prof["device_busy_ms"],
            "idle_share": prof["idle_share"], "profile": prof,
            "tokens_per_s": LM_P * LM_B * LM_S / prof["wall_ms"] * 1e3,
            "kernels_vs_plain": checks, "card": card}


def lm_nel(torch, module, batches, card, total, loss0):
    """(e) DeepEnsemble on the NEL (backend="nel", the default), Adam under
    the same schedule, 2 steps: the first step's losses within 1e-5 of
    part (a)'s first step from the same init; a profiled NEL step (LM_P
    step hops) for host and device ms and the idle share."""
    from repro_torch.bdl import DeepEnsemble
    from repro_torch.optim import adam, warmup_cosine
    torch.cuda.reset_peak_memory_stats()
    algo = DeepEnsemble(module, seed=SEED)
    if algo.backend != "nel":
        raise AssertionError(f"default backend {algo.backend}")
    fns = reset_counts()
    t0 = time.perf_counter()
    _, l1 = bounded(algo.bayes_infer, [batches[0]], 1, num_particles=LM_P,
                    optimizer=adam(warmup_cosine(*LM_SCHED)))
    pd = algo.push_dist
    pids = pd.particle_ids()

    def step(b=algo._batch(batches[1])):
        futs = [pd.particles[p].step(b) for p in pids]
        return [float(f.wait(NEL_T)) for f in futs]

    l2 = bounded(step)
    torch.cuda.synchronize()
    launches = read_counts(fns)
    add_counts(total, launches)
    d = float(np.abs(np.array(l1) - loss0).max())
    if not (d < 1e-5 and np.isfinite(l2).all()):
        raise AssertionError(f"NEL step 1 losses {l1} vs captured {loss0}; "
                             f"step 2 {l2}")
    wall = time.perf_counter() - t0
    prof = bounded(profile_steps, torch, step, n=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    algo.cleanup()
    del algo, pd, step
    lm_free(torch)
    return {"phase": 13, "part": "e", "losses": [l1, l2],
            "step1_vs_captured_max_abs": d, "launches": launches,
            "wall_s": wall, "step_host_ms": prof["wall_ms"],
            "step_device_ms": prof["device_busy_ms"],
            "idle_share": prof["idle_share"], "profile": prof,
            "tokens_per_s": LM_P * LM_B * LM_S / prof["wall_ms"] * 1e3,
            "peak_gb": peak, "card": card}


def phase13(torch, card):
    """LM training on the card (module doc). Returns each kernel's
    launches over phase 13's driven runs and #1 / #2's rows at the LM's
    shape."""
    from repro_torch import configs
    t0 = time.perf_counter()
    cfg = configs.get("qwen1.5-0.5b").replace(n_units=LM_UNITS)
    module = lm_module(cfg)
    batches = lm_batches(cfg, LM_STEPS)
    total, walls = {}, {}
    checks = {"attention": lm_attention_check(torch, cfg, card),
              "chunked_ce": lm_ce_check(torch, cfg, card)}
    emit({"phase": 13, "part": "checks", **checks})
    walls["checks"] = time.perf_counter() - t0
    a_line, b_line, loss0, _ = lm_ensemble(torch, cfg, module, batches, card,
                                           total)
    emit(b_line)
    walls["a_b"] = time.perf_counter() - t0 - sum(walls.values())
    emit(lm_adafactor(torch, cfg, batches, card, total,
                      a_line["opt_state_gb"]))
    walls["c"] = time.perf_counter() - t0 - sum(walls.values())
    d_line = lm_svgd(torch, module, batches, card, total)
    emit(d_line)
    walls["d"] = time.perf_counter() - t0 - sum(walls.values())
    emit(lm_nel(torch, module, batches, card, total, loss0))
    walls["e"] = time.perf_counter() - t0 - sum(walls.values())
    if not (total.get("pairwise_sqdist") and total.get("svgd_force")):
        raise AssertionError(f"phase 13 never launched #1 and #2: {total}")
    emit({"phase": 13, "part": "end", "launches": total,
          "wall_s": time.perf_counter() - t0, "wall_s_by_part": walls,
          "card": card})
    kv = d_line["kernels_vs_plain"]
    rows = {"pairwise_sqdist": {"shape": kv["shape"],
                                "path": kv["sqdist_path"],
                                "max_rel_err": kv["sqdist_rel"],
                                **kv["timed"]["pairwise_sqdist"]},
            "svgd_force": {"shape": kv["shape"],
                           "max_rel_err": kv["force_rel"],
                           **kv["timed"]["svgd_force"]}}
    return total, rows

# --------------------------------------------------------------------------
# phase 14: checkpoints and obs
# --------------------------------------------------------------------------

P14_RUNS = 2                     # untraced and traced passes of phase 2's load
P14_TRACE_GATE = 0.95            # traced tok/s over untraced (DESIGN.md §12)
P14_CATS = {"executor", "store", "runtime", "serve", "decode", "bdl"}
P14_RESUME_K = 3                 # DeepEnsemble steps before the checkpoint
P14_DECODE_TOL = 0.02            # counted decode FLOPs against the analytic
P14_CODE_TOL = 0.03              # phase 13's counted FLOPs against code_flops
PROM_LINE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? (\S+)$")


def span_s(name):
    """Seconds of the tracer's ``name`` spans in its ring."""
    from repro_torch.obs import trace
    return sum(s["t1"] - s["t0"] for s in trace.snapshot()
               if s["name"] == name)


def timed_save_restore(torch, store, ckpt_dir):
    """checkpoint.save_store then restore_store (on the card) with tracing
    on. Returns the restored store, the file and its numbers: bytes, save
    and restore seconds, each with its device-to-host or host-to-device
    part (the store.d2h and store.h2d spans) apart from the rest (the
    file), and the rates."""
    from repro_torch import checkpoint
    from repro_torch.obs import trace
    trace.clear()
    trace.enable()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = checkpoint.save_store(ckpt_dir, 0, store)
        save_s = time.perf_counter() - t0
        d2h = span_s("store.d2h")
        trace.clear()
        t0 = time.perf_counter()
        _, restored = checkpoint.restore_store(ckpt_dir)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        h2d = span_s("store.h2d")
    finally:
        trace.disable()
        trace.clear()
    nb = os.path.getsize(path)
    return restored, path, {
        "file_bytes": nb, "save_s": save_s, "save_d2h_s": d2h,
        "save_file_s": save_s - d2h, "restore_s": restore_s,
        "restore_h2d_s": h2d, "restore_file_s": restore_s - h2d,
        "save_gb_per_s": nb / save_s / 1e9, "d2h_gb_per_s": nb / d2h / 1e9,
        "restore_gb_per_s": nb / restore_s / 1e9,
        "h2d_gb_per_s": nb / h2d / 1e9}


def file_equals_store(torch, path, store):
    """Every leaf of a store file against the store's live rows of its key
    on the card (a bf16 leaf through its fp32 copy), bit for bit. Returns
    the bytes held."""
    from repro_torch.core.tree import tree_leaves
    data = np.load(path)
    manifest = json.loads(str(data["__store_manifest__"]))
    held = 0
    for key, skel in manifest["keys"].items():
        leaves = tree_leaves(store.dense(key, skel["_pids"]))
        for i, leaf in enumerate(leaves):
            a = torch.from_numpy(data[f"k{skel['_slot']}_l{i}"]).to("cuda")
            want = leaf.float() if leaf.dtype == torch.bfloat16 else leaf
            if not torch.equal(a, want):
                raise AssertionError(f"{path}: {key} leaf {i} differs from "
                                     f"the store")
            held += a.numel() * a.element_size()
    return held


def stores_equal(torch, a, b):
    """Every key of store ``a`` equal in ``b``, live rows bit for bit."""
    from repro_torch.core.tree import tree_leaves
    for key in a.keys():
        want = a.dense(key)
        if not tree_leaves(want):
            continue
        if not tree_equal(torch, b.dense(key), want):
            raise AssertionError(f"restored store: {key} differs")


def store_heads(torch, cfg, reqs, n_pmax, store):
    """decode_parity's setup on ``store``: phase 2's prompts prefilled
    into the store's own pool, then one decode step; its BMA heads."""
    import functools
    import types
    from repro_torch.models import api
    from repro_torch.serve import uncertainty
    from repro_torch.serve.paging import create_kv_pages
    if "kv_pages" not in store.keys():
        create_kv_pages(store, functools.partial(
            api.paged_cache_init, cfg, num_pages=NUM_PAGES,
            page_size=PAGE_SIZE))
    pages = store.checkout("kv_pages")
    try:
        params, mask, bt, tok, sl = prefilled_rows(
            torch, types.SimpleNamespace(store=store), cfg,
            [p for p, _ in reqs], n_pmax, pages)
        logits, _ = api.decode_step_paged(params, tok, pages, bt, sl, cfg)
        return uncertainty.predictive_heads(logits, mask=mask)
    finally:
        store.commit("kv_pages", pages)


def p14_lm(torch, cfg, reqs, want, card, launches, tmp):
    """(a) 4 full-width qwen1.5-0.5b particles (seed 0, as phase 2's)
    saved with save_store and restored with restore_store, then phase 2's
    requests served from the restored store under a fresh captured cache.
    Returns the original PD (part (c) serves it) and the part's line."""
    from repro_torch.core import ParticleModule, PushDistribution
    from repro_torch.models import api
    from repro_torch.runtime import ProgramCache
    module = ParticleModule(init=lambda g: api.init_params(g, cfg), cfg=cfg)
    pd = PushDistribution(module, seed=SEED)
    for _ in range(PARTICLES):
        pd.p_create()
    pd.store.stacked("params")
    params_bytes = pd.store.per_device_bytes("params")
    if params_bytes != PARTICLES * LM_D * 4:
        raise AssertionError(f"LM params {params_bytes} bytes")
    restored, path, io = timed_save_restore(torch, pd.store,
                                            os.path.join(tmp, "lm"))
    held = file_equals_store(torch, path, pd.store)
    stores_equal(torch, pd.store, restored)
    fns = attention_counts()
    gens, st, got, wall, warm, n_pmax = serve_requests(
        torch, restored, cfg, reqs, fns, ProgramCache())
    add_counts(launches, got)
    tokens = [g.tokens for g in gens]
    logprobs = [g.logprobs for g in gens]
    if (tokens, logprobs) != want:
        raise AssertionError("the restored store's tokens or logprobs differ "
                             "from phase 2's captured run")
    heads = [store_heads(torch, cfg, reqs, n_pmax, s)
             for s in (pd.store, restored)]
    for k, v in heads[0].items():
        if not torch.equal(v, heads[1][k]):
            raise AssertionError(f"decode step head {k}: restored != saved")
    del restored, heads
    gc.collect()
    torch.cuda.empty_cache()
    return pd, {"phase": 14, "part": "a", "model": cfg.name,
                "particles": PARTICLES, "params_bytes": params_bytes,
                "file_leaf_bytes": held, **io,
                "requests": len(reqs), "tok_per_s": sum(map(len, tokens))
                / wall, "steps": st["steps"], "launches": got,
                "tokens_equal_phase2": True, "logprobs_equal_phase2": True,
                "decode_heads_equal": True, "card": card}


def p14_sciml(torch, card, launches, tmp):
    """(b) phase 12's UNet-advection MultiSWAG store (8 particles, rank 20)
    trained anew, saved and restored: every key bit for bit, the
    regression BMA equal; then a captured DeepEnsemble resumed from a
    checkpoint.save of its {"params", "opt"} after step k, as
    examples/train_lm.py writes them."""
    from repro_torch import checkpoint
    from repro_torch.bdl import DeepEnsemble, MultiSWAG
    from repro_torch.core.tree import to_device
    from repro_torch.data import DataLoader
    from repro_torch.optim import adam
    from repro_torch.runtime import ProgramCache
    from repro_torch.serve import PredictiveEngine
    cfg, module = unet_module()
    algo, row = sci_train(torch, MultiSWAG, module, SCI_P, 3, "compiled",
                          ProgramCache(), optimizer=adam(1e-3),
                          pretrain_epochs=1, max_rank=20)
    add_counts(launches, row["launches"])
    store = algo.store
    restored, path, io = timed_save_restore(torch, store,
                                            os.path.join(tmp, "sciml"))
    held = file_equals_store(torch, path, store)
    stores_equal(torch, store, restored)
    batches = [to_device(b, "cuda") for b in DataLoader(
        cfg, batch_size=SCI_B, num_batches=P14_RESUME_K + 1, seed=SEED)]
    x = {"u0": batches[0]["u0"]}
    engines = [PredictiveEngine(module.forward, store=s, kind="regress")
               for s in (store, restored)]
    heads = [e.predict(x) for e in engines]
    for e in engines:
        e.close()
    for k, v in heads[0].items():
        if not torch.equal(v, heads[1][k]):
            raise AssertionError(f"regression BMA {k}: restored != saved")
    keys = store.keys()
    algo.cleanup()
    del algo, store, restored, engines, heads
    gc.collect()
    torch.cuda.empty_cache()
    # the resume: k captured steps, a checkpoint, one more step, against
    # a fresh PD that commits the checkpoint and takes that step
    opt = adam(1e-3)
    a = DeepEnsemble(module, seed=SEED, backend="compiled")
    pids, _ = a.bayes_infer(batches[:P14_RESUME_K], 1, optimizer=opt,
                            num_particles=SCI_P)
    ck = os.path.join(tmp, "resume")
    checkpoint.save(ck, P14_RESUME_K, {"params": a.store.stacked("params"),
                                       "opt": a.store.stacked("opt_state")})
    loss_a = a._fused_epochs(pids, batches[P14_RESUME_K:], 1, optimizer=opt)
    b = DeepEnsemble(module, seed=SEED + 1, backend="compiled")
    pids_b = [b.push_dist.p_create(opt) for _ in range(SCI_P)]
    step, tree = checkpoint.restore(
        ck, like={"params": b.store.stacked("params"),
                  "opt": b.store.stacked("opt_state")})
    b.store.commit("params", tree["params"])
    b.store.commit("opt_state", tree["opt"])
    del tree
    loss_b = b._fused_epochs(pids_b, batches[P14_RESUME_K:], 1, optimizer=opt)
    same = (loss_a == loss_b and step == P14_RESUME_K
            and tree_equal(torch, b.store.stacked("params"),
                           a.store.stacked("params"))
            and tree_equal(torch, b.store.stacked("opt_state"),
                           a.store.stacked("opt_state")))
    if not same:
        raise AssertionError(f"resumed step: losses {loss_b} vs {loss_a}")
    a.cleanup()
    b.cleanup()
    del a, b
    gc.collect()
    torch.cuda.empty_cache()
    return {"phase": 14, "part": "b", "model": cfg.name,
            "particles": SCI_P, "keys": keys, "file_leaf_bytes": held,
            **io, "multiswag_launches": row["launches"],
            "regress_heads_equal": True, "resume_step": step,
            "resumed_losses": loss_b, "resumed_equal": True, "card": card}


def prometheus_parses(text):
    """Each line a ``# TYPE name kind`` comment or ``name{labels} value``
    with a float value; returns the number of samples."""
    n = 0
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4 or parts[3] not in ("counter", "gauge",
                                                   "summary"):
                raise AssertionError(f"prometheus comment {line!r}")
            continue
        m = PROM_LINE.match(line)
        if m is None:
            raise AssertionError(f"prometheus line {line!r}")
        float(m.group(2))
        n += 1
    return n


def decode_matmul_params(cfg):
    """Parameters of qwen's products a decode step multiplies: every
    layer's q, k, v, o and MLP matrices and the tied head."""
    D, F, hd = cfg.d_model, cfg.d_ff, cfg.hd
    H, KVH = cfg.n_heads, cfg.n_kv_heads
    return cfg.n_layers * (D * H * hd + 2 * D * KVH * hd + H * hd * D
                           + 3 * D * F) + cfg.vocab_size * D


def p14_obs(torch, pd, cfg, reqs, card, launches, tmp):
    """(c) phase 2's load served from the LM PD's store through the
    process cache, untraced and traced by turns, all warm; a captured UNet
    DeepEnsemble epoch and a regression service traced; then pd.obs()."""
    from repro_torch.bdl import DeepEnsemble
    from repro_torch.data import DataLoader
    from repro_torch.obs import trace
    from repro_torch.optim import adam
    from repro_torch.runtime import bucket_size
    from repro_torch.runtime.cache import global_cache
    from repro_torch.serve import serve_decode
    buckets = sorted({bucket_size(len(p)) for p, _ in reqs})
    trace.clear()
    svc = serve_decode(pd, cfg, num_pages=NUM_PAGES, page_size=PAGE_SIZE,
                       max_active=MAX_ACTIVE, warmup_buckets=buckets,
                       cache=global_cache())
    runs, algo = [], None
    try:
        fns = attention_counts()
        for fn in fns.values():
            fn.launches = 0
        for traced in (False, True) * P14_RUNS:
            (trace.enable if traced else trace.disable)()
            t1 = time.perf_counter()
            gens = [h.result(600) for h in [svc.generate_async(p, max_new=m)
                                            for p, m in reqs]]
            wall = time.perf_counter() - t1
            runs.append({"traced": traced, "wall_s": wall,
                         "tok_per_s": sum(len(g.tokens) for g in gens) / wall,
                         "tokens": [g.tokens for g in gens]})
        add_counts(launches, read_counts(fns))
        if any(r["tokens"] != runs[0]["tokens"] for r in runs):
            raise AssertionError("traced and untraced tokens differ")
        best = {t: max(r["tok_per_s"] for r in runs if r["traced"] == t)
                for t in (False, True)}
        if not best[True] >= P14_TRACE_GATE * best[False]:
            raise AssertionError(f"traced {best[True]} tok/s against "
                                 f"untraced {best[False]}")
        trace.enable()
        ucfg, umodule = unet_module()
        algo = DeepEnsemble(umodule, seed=SEED, backend="compiled")
        loader = DataLoader(ucfg, batch_size=SCI_B, num_batches=SCI_NB,
                            seed=SEED)
        algo.bayes_infer(loader, 1, optimizer=adam(1e-3), num_particles=SCI_P)
        u0 = next(iter(loader))["u0"]
        with algo.posterior_predictive(kind="regress", max_batch=4,
                                       max_wait_ms=SERVE_WAIT_MS,
                                       warmup={"u0": u0[0]}) as ssvc:
            for u in u0[:8]:
                ssvc.predict({"u0": u})
        obs = pd.obs()
        snap = obs.snapshot(costs=True)
        in_use = torch.cuda.memory_allocated()
        path = obs.dump_trace(os.path.join(tmp, "trace.json"))
        text = obs.prometheus()
        trace.disable()
    finally:
        trace.disable()
        svc.close()
        if algo is not None:
            algo.cleanup()
    if set(snap) != {"stats", "devices", "store", "programs", "trace"}:
        raise AssertionError(f"snapshot keys {sorted(snap)}")
    dev = snap["devices"][0]
    if dev["platform"] != "gpu" or dev["bytes_in_use"] != in_use:
        raise AssertionError(f"device gauge {dev}, allocated {in_use}")
    if snap["store"]["per_device_bytes"]["params"] != PARTICLES * LM_D * 4:
        raise AssertionError(f"store gauge {snap['store']}")
    if "decode" not in snap["stats"]:
        raise AssertionError("no decode section while serving")
    missing = [p["name"] for p in snap["programs"] if p["cost"] is None]
    if missing:
        raise AssertionError(f"programs without a cost: {missing}")
    (decode,) = [p for p in snap["programs"]
                 if p["name"] == "paged_decode_step"]
    M = decode_matmul_params(cfg)
    # the program's first run is the warm-up step with every row masked
    # (seq_len -1), so #7's own count there is 0
    analytic = 2 * M * PARTICLES * MAX_ACTIVE
    counted = decode["cost"]["flops"]
    if not abs(counted / analytic - 1) < P14_DECODE_TOL:
        raise AssertionError(f"decode step counted {counted} FLOPs, "
                             f"analytic {analytic}")
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    cats = {e["cat"] for e in events if "cat" in e}
    names = {e["name"] for e in events}
    looked_up = {e["args"]["program"] for e in events
                 if e["name"] in ("cache.hit", "cache.miss")}
    want = looked_up | {"paged_decode_step", "paged_prefill",
                        "ensemble_step", "bma_predict"}
    if not (P14_CATS <= cats and {f"program.{n}" for n in want} <= names):
        raise AssertionError(f"trace categories {sorted(cats)}, programs "
                             f"{sorted(n for n in names if n.startswith('program.'))}"
                             f", want {sorted(want)}")
    if "repro_program_cache_hits" not in text:
        raise AssertionError("prometheus text lacks repro_program_cache_hits")
    samples = prometheus_parses(text)
    return {"phase": 14, "part": "c", "runs": [
                {k: v for k, v in r.items() if k != "tokens"} for r in runs],
            "traced_over_untraced": best[True] / best[False],
            "tokens_equal": True, "devices": snap["devices"],
            "store_per_device_bytes": snap["store"]["per_device_bytes"],
            "programs": [{k: p[k] for k in ("name", "fingerprint",
                                            "num_particles",
                                            "param_bytes_per_device", "cost",
                                            "graph", "pool_bytes")}
                         for p in snap["programs"]],
            "decode_counted_flops": counted,
            "decode_analytic_flops": analytic, "decode_matmul_params": M,
            "decode_paged_kernel_flops_at_first_run": 0,
            "trace_events": len(events), "trace_categories": sorted(cats),
            "trace_spans": snap["trace"], "prometheus_samples": samples,
            "card": card}


def phase14(torch, cfg, reqs, phase2_out, card):
    """Checkpoints and obs on the card (module doc). Returns each kernel's
    launches over phase 14's driven runs."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="phase14_", dir=os.path.join(ROOT, "build"))
    launches, walls = {}, {}
    try:
        pd, a_line = p14_lm(torch, cfg, reqs, phase2_out, card, launches, tmp)
        emit(a_line)
        walls["a"] = time.perf_counter() - t0
        emit(p14_sciml(torch, card, launches, tmp))
        walls["b"] = time.perf_counter() - t0 - sum(walls.values())
        with pd:
            emit(p14_obs(torch, pd, cfg, reqs, card, launches, tmp))
        del pd
        gc.collect()
        torch.cuda.empty_cache()
        walls["c"] = time.perf_counter() - t0 - sum(walls.values())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name in ("paged_decode_attention", "flash_attention", "swag_moments"):
        if not launches.get(name):
            raise AssertionError(f"phase 14 never launched {name}: "
                                 f"{launches}")
    emit({"phase": 14, "part": "end", "launches": launches,
          "wall_s": time.perf_counter() - t0, "wall_s_by_part": walls,
          "card": card})
    return launches


# --------------------------------------------------------------------------
# phase 15: particles across GPUs — the store's particle axis on a mesh,
# the NEL over every GPU, host offload
# --------------------------------------------------------------------------

MESH_N = 4                          # positions of the data axis
OFF_P = 8                           # (c): qwen1.5-0.5b particles on the NEL
OFF_UNITS = 3                       # (c): their depth cut, 3 of 24 units
OFF_CACHE = 2                       # (c): the NEL's active set a device
OFF_S = 256                         # (c): tokens a step
OFF_STEPS = 2
OFF_LR = 1e-3
TRAFFIC = ("stacks", "unstacks", "device_puts", "checkouts")
# (a)'s DeepEnsemble trains with sgd at P15_LR: a position's 2-row GEMMs
# round otherwise than one device's 8-row ones (8.9e-7 in the step-0
# grads), and sgd at phase 8's 0.05 grows that past HOLD in 16 steps. Its
# MultiSWAG runs phase 4's Adam: Adam's first update is about lr * sign(g),
# so an entry whose first grad is rounding noise takes lr with either sign
# on either side. Its params and SWAG moments are held where the first
# step's |g| > G_HOLD and the entries under it counted (fewer than
# G_REST: 2.43% of the ViT's entries on the H100), as the LM's Adam runs
# are in the CPU tests. G_HOLD = 1e-5 keeps lr * dg / |g| under HOLD for
# the grad differences dg ~ 9e-7 measured between the two layouts. Every
# particle must move by MOVED x HOLD at least, so that the bar would see
# a position's updates dropped or sent to another position's rows.
P15_LR = 1e-3
HOLD = 1e-4
G_HOLD = 1e-5
G_REST = 0.05
MOVED = 5


def one_position(torch):
    """A data mesh of one position, cuda:0: the mesh path with nothing to
    split, beside the one-device path on the same work."""
    from repro_torch.core.store import Placement
    from repro_torch.launch import make_bench_mesh
    return Placement(mesh=make_bench_mesh(1, devices=["cuda:0"]))


def mesh_placement(torch, real=False):
    """The data mesh of (a)-(d): MESH_N real GPUs where there are that
    many, else MESH_N logical positions of cuda:0; ``real``: the real
    GPUs of (e), MESH_N of them where there are that many, else 2."""
    from repro_torch.core.store import Placement
    from repro_torch.launch import make_bench_mesh
    count = torch.cuda.device_count()
    if real or count >= MESH_N:
        n = MESH_N if count >= MESH_N else 2
        devices = [f"cuda:{i}" for i in range(n)]
    else:
        n, devices = MESH_N, ["cuda:0"] * MESH_N
    return Placement(mesh=make_bench_mesh(n, devices=devices))


class WatchedLoader:
    """The seeded loader, reading the store's counters and the clock (the
    card synchronised) when the epoch loop asks for its first batch and
    after it took its last one."""

    def __init__(self, torch, loader):
        self.torch, self.loader, self.store = torch, loader, None
        self.seen, self.times = [], []

    def _mark(self):
        self.torch.cuda.synchronize()
        self.times.append(time.perf_counter())
        self.seen.append(self.store.snapshot_stats())

    def __iter__(self):
        self._mark()
        yield from self.loader
        self._mark()

    def traffic(self):
        a, b = self.seen[0], self.seen[-1]
        return {k: b[k] - a[k] for k in TRAFFIC}

    def last_epoch_s(self):
        """The last epoch's steps, captured in an earlier one."""
        return self.times[-1] - self.times[-2]


def flat_host(torch, tree):
    """A stacked tree (a Sharded one: its shards in slot order, model
    shards joined) as one (P, D) fp32 host matrix, leaves in
    ``flatten_stacked``'s order."""
    from repro_torch.core.functional import flatten_stacked
    from repro_torch.core.store import Sharded
    from repro_torch.core.tree import Group
    if isinstance(tree, Sharded) and isinstance(tree.shards[0], Group):
        tree = tree.gather()
    parts = tree.shards if isinstance(tree, Sharded) else (tree,)
    return torch.cat([flatten_stacked(p)[0].float().cpu() for p in parts])


def swag_host(torch, store):
    """The SWAG state on the host: mean and sq_mean (P, D), the ring's
    deviation rows written so far (one (P, D) matrix a ring slot), n and
    rank."""
    from repro_torch.core.store import Sharded
    from repro_torch.core.tree import Group, tree_leaves, tree_map
    st = store.stacked("swag")
    parts = st.shards if isinstance(st, Sharded) else (st,)
    first = [p[0] if isinstance(p, Group) else p for p in parts]
    rank = torch.cat([p["rank"].cpu() for p in first])
    R = tree_leaves(first[0]["dev"])[0].shape[1]

    def sub(key, pick=lambda t: t):
        return Sharded.apply(lambda p: pick(sub_key(p, key)), st)
    return {"mean": flat_host(torch, sub("mean")),
            "sq": flat_host(torch, sub("sq_mean")),
            "dev": [flat_host(torch, sub("dev", lambda t, j=j: tree_map(
                lambda x: x[:, j], t)))
                for j in range(min(int(rank.max()), R))],
            "n": torch.cat([p["n"].cpu() for p in first]), "rank": rank}


def sub_key(tree, key):
    """``tree[key]``; of a model group, the Group of its shards' ``key``
    subtrees (their dims without the key's prefix)."""
    from repro_torch.core.tree import Group
    if not isinstance(tree, Group):
        return tree[key]
    n = len(key) + 1
    return Group([s[key] for s in tree.shards],
                 {p[n:]: d for p, d in tree.dims.items()
                  if p.startswith(key + "/")}, tree.devices)


def p15_probe(torch, module):
    """(a)'s particles made again from SEED (the runs' init) and their
    first step's grads on the loader's first batch, as (P, D) host
    matrices: where the grads are rounding noise, and how far the runs
    moved the params."""
    from repro_torch.bdl import DeepEnsemble
    from repro_torch.core.functional import ensemble_value_and_grad
    from repro_torch.data import DataLoader
    from repro_torch.optim import sgd
    probe = DeepEnsemble(module, seed=SEED, backend="compiled")
    for _ in range(TRAIN_P):
        probe.push_dist.p_create(sgd(P15_LR))
    params = probe.store.stacked("params")
    batch = probe._batch(next(iter(DataLoader(
        module.cfg, batch_size=TRAIN_B, num_batches=TRAIN_NB, seed=SEED))))
    _, grads = ensemble_value_and_grad(module.loss)(params, batch)
    out = {"p0": flat_host(torch, params), "g1": flat_host(torch, grads)}
    del params, grads
    probe.cleanup()
    del probe
    gc.collect()
    torch.cuda.empty_cache()
    return out


def p15_train(torch, module, name, placement, fresh, lr=P15_LR,
              epochs=None, batches=TRAIN_NB):
    """One captured fused run of ``name`` (phase 4's seed and loader; sgd
    at ``lr`` for DeepEnsemble, phase 4's Adam for MultiSWAG) on
    ``placement``: (algo, losses, params on the host, launches, wall s,
    cache stats, program costs, in-loop store traffic, the last epoch's
    images/s, per-device param bytes; MultiSWAG's state on the host)."""
    from repro_torch.bdl import DeepEnsemble, MultiSWAG, SteinVGD
    from repro_torch.data import DataLoader
    from repro_torch.optim import adam, sgd
    from repro_torch.runtime import ProgramCache
    cls, kw, n_epochs = {
        "ensemble": (DeepEnsemble, {"optimizer": sgd(lr)}, 2),
        "svgd": (SteinVGD, {"lengthscale": 0.0, "lr": 1e-3}, 2),
        "multiswag": (MultiSWAG, {"optimizer": adam(1e-3),
                                  "pretrain_epochs": 1, "max_rank": 20}, 3),
    }[name]
    epochs = n_epochs if epochs is None else epochs
    algo = cls(module, seed=SEED, backend="compiled", placement=placement)
    cache = algo.push_dist.runtime.cache = ProgramCache()
    loader = WatchedLoader(torch, DataLoader(module.cfg, batch_size=TRAIN_B,
                                             num_batches=batches, seed=SEED))
    loader.store = algo.store
    fns = reset_counts() if fresh else None
    t0 = time.perf_counter()
    _, losses = algo.bayes_infer(loader, epochs, num_particles=TRAIN_P, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts(fns) if fresh else None
    if not np.isfinite(losses).all():
        raise AssertionError(f"{name} losses {losses}")
    return {"algo": algo, "losses": losses,
            "params": flat_host(torch, algo.store.stacked("params")),
            "swag": (swag_host(torch, algo.store) if name == "multiswag"
                     else None),
            "launches": got, "wall_s": wall, "steps": epochs * batches,
            "cache": cache.snapshot_stats(), "programs": cache.program_costs(),
            "traffic": loader.traffic(),
            "images_per_s": TRAIN_P * TRAIN_B * batches
            / loader.last_epoch_s(),
            "per_device_bytes": algo.store.per_device_bytes("params")}


def held(a, b, big, bar=HOLD):
    """Where ``big``: the largest |a - b| over its bar (a tensor or a
    float); elsewhere the largest |a - b| and the share of entries."""
    d = (a - b).abs()
    over = d / bar
    return {"held_max_over_bar": float(over[big].max()),
            "held_max_abs": float(d[big].max()),
            "rest_max_abs": float(d[~big].max()) if bool((~big).any())
            else 0.0,
            "rest_share": float((~big).float().mean())}


def p15_swag_compare(one, mesh, big):
    """(a)'s MultiSWAG state on the mesh against one device's, held where
    the first |g| > G_HOLD: the mean (an average of the params) within
    HOLD, sq_mean within HOLD (1 + sq) (|a^2 - b^2| <= 2 |a| |a - b| <=
    (1 + a^2) |a - b|), each written deviation row (theta - mean) within
    2 HOLD; n and rank equal."""
    out = {"mean": held(one["mean"], mesh["mean"], big),
           "sq_mean": held(one["sq"], mesh["sq"], big,
                           HOLD * (1 + one["sq"].abs())),
           "dev_rows": len(one["dev"]),
           "dev": max((held(a, b, big, 2 * HOLD) for a, b in
                       zip(one["dev"], mesh["dev"])),
                      key=lambda r: r["held_max_over_bar"]),
           "n_equal": bool((one["n"] == mesh["n"]).all()),
           "rank_equal": bool((one["rank"] == mesh["rank"]).all())}
    bad = [k for k in ("mean", "sq_mean", "dev")
           if not out[k]["held_max_over_bar"] < 1] + [
        k for k in ("n_equal", "rank_equal") if not out[k]]
    if len(one["dev"]) != len(mesh["dev"]) or not one["dev"]:
        bad.append("dev rows")
    return out, bad


def p15_compare(torch, name, one, mesh, n, probe, want_losses=None):
    """Gates of (a) for one algorithm: losses within HOLD of the
    unsharded run and params within HOLD (MultiSWAG: where the first |g|
    > G_HOLD, fewer than G_REST of the entries under it; its SWAG state by
    ``p15_swag_compare``), bits reported; every particle moved by at least
    MOVED x HOLD (so that dropped updates would show); no store traffic in
    the loop, one capture per position per step kind (SVGD: its force
    once), each a graph, 1/n of the unsharded per-device bytes."""
    dl = float(np.abs(np.array(one["losses"]) - np.array(mesh["losses"])).max())
    big = (probe["g1"].abs() > G_HOLD if name == "multiswag"
           else torch.ones_like(probe["g1"], dtype=torch.bool))
    hp = held(one["params"], mesh["params"], big)
    moved = (mesh["params"] - probe["p0"]).abs().amax(1)
    bits = one["losses"] == mesh["losses"] and bool(
        (one["params"] == mesh["params"]).all())
    kinds = {"ensemble": 1, "svgd": 2, "multiswag": 2}[name]
    want_captures = n * kinds + (1 if name == "svgd" else 0)
    row = {"loss_max_abs": dl, "params": hp, "bits_equal": bits,
           "moved_min": float(moved.min()), "moved_max": float(moved.max()),
           "traffic_in_loop": mesh["traffic"],
           "captures": mesh["cache"]["cold_compiles"],
           "want_captures": want_captures,
           "graphs": all(p["graph"] for p in mesh["programs"]),
           "per_device_bytes": mesh["per_device_bytes"],
           "unsharded_per_device_bytes": one["per_device_bytes"],
           "wall_s": {"one": one["wall_s"], "mesh": mesh["wall_s"]},
           "last_epoch_images_per_s": {"one": one["images_per_s"],
                                       "mesh": mesh["images_per_s"]},
           "losses_equal_phase4": (None if want_losses is None
                                   else one["losses"] == want_losses)}
    failed = [what for what, bad in (
        ("losses past HOLD", not dl < HOLD),
        ("params past HOLD", not hp["held_max_over_bar"] < 1),
        ("too many entries under G_HOLD", not hp["rest_share"] < G_REST),
        ("a particle moved less than MOVED x HOLD",
         not row["moved_min"] > MOVED * HOLD),
        ("store traffic in the epoch loop", any(mesh["traffic"].values())),
        ("captures", row["captures"] != want_captures or not row["graphs"]),
        ("per-device bytes", mesh["per_device_bytes"] * n
         != one["per_device_bytes"]),
        ("one-device losses other than phase 4's",
         want_losses is not None and not row["losses_equal_phase4"]))
        if bad]
    if name == "multiswag":
        row["swag"], bad = p15_swag_compare(one["swag"], mesh["swag"], big)
        failed += [f"SWAG {b}" for b in bad]
    return row, failed


def p15_shard_kernels(torch, store):
    """#3 and #4 at a position's shapes, on (a)'s trained mesh MultiSWAG
    state: one more collection over each position's rows and its slice of
    the mask (``moments_parity``: kernel against plain, each on its own
    clone of the ring) and ``diag_std_leaves`` of each position's (rows,
    leaf) means and sqs (``diag_std_parity``: bit-equal to the per-leaf
    kernel), both within 1e-5 of the plain versions; position 0's
    collection (one launch, on a copy of its moments and ring; the
    per-leaf kernel's loop beside it) and its scales (the one launch
    beside the per-leaf loop) timed (L2 flushed) beside the plain
    versions and the bound. Nothing is written back; these launches are
    not the path's."""
    from repro_torch.core.tree import tree_flatten
    from repro_torch.kernels import ref, swag_moments
    params, swag = store.stacked("params"), store.stacked("swag")
    mask = store.active_mask()
    out = {"rows": [hi - lo for lo, hi in zip(params.bounds[:-1],
                                               params.bounds[1:])],
           "moments_max_abs_err": [], "diag_std_max_abs_err": []}
    for i, (lo, hi) in enumerate(zip(params.bounds[:-1], params.bounds[1:])):
        m_i = mask[lo:hi].to(params.devices[i])
        out["moments_max_abs_err"].append(moments_parity(
            torch, swag.shards[i], params.shards[i], m_i)["max_abs_err"])
        means, sqs = (tree_flatten(swag.shards[i][k], sort_keys=True)[0]
                      for k in ("mean", "sq_mean"))
        out["diag_std_max_abs_err"].append(diag_std_parity(
            torch, means, sqs, f"position {i}")["max_abs_err"])
    if not (max(out["moments_max_abs_err"]) <= 1e-5
            and max(out["diag_std_max_abs_err"]) < 1e-5):
        raise AssertionError(f"#3 / #4 at a position's shapes: {out}")
    # position 0: every leaf's launch, outputs apart from the state
    sh = swag.shards[0]
    m0 = mask[: params.bounds[1]].to(params.devices[0])
    means, sqs, devs = (tree_flatten(sh[k], sort_keys=True)[0]
                        for k in ("mean", "sq_mean", "dev"))
    thetas = [t.contiguous() for t in
              tree_flatten(params.shards[0], sort_keys=True)[0]]
    n, R = sh["n"], devs[0].shape[1]
    slot = (sh["rank"] % R).to(torch.int32)
    rings = [d.clone() for d in devs]
    ms, qs = [m.clone() for m in means], [q.clone() for q in sqs]

    def kernel():
        swag_moments.moments_leaves(ms, qs, thetas, n, m0, rings, slot)

    def per_leaf():
        for m, q, t, r in zip(ms, qs, thetas, rings):
            swag_moments.moments(m, q, t, n, m0, r, slot, out_mean=m,
                                 out_sq=q)
    costs = [swag_moments.moments_cost(m, r) for m, r in zip(means, rings)]
    b_ms, b_by = bound(sum(c[1] for c in costs), sum(c[0] for c in costs))
    out["moments_position0"] = {
        "launches": counted_launches(swag_moments.moments_leaves, kernel,
                                     collect_launches(len(means)),
                                     "position 0's collection"),
        "ms": time_ms(torch, kernel, iters=10),
        "per_leaf_ms": time_ms(torch, per_leaf, iters=10),
        "plain_ms": time_ms(torch, lambda: ref.swag_moments_leaves(
            ms, qs, thetas, n, m0, rings, slot), iters=10),
        "bound_ms": b_ms, "bound_by": b_by}
    out["diag_std_position0"] = diag_std_timed(
        torch, [m.contiguous() for m in means],
        [q.contiguous() for q in sqs], iters=10, device=False)
    del rings, ms, qs
    torch.cuda.empty_cache()
    return out


def p15_training(torch, card, captured, real=False):
    """(a) DeepEnsemble, SteinVGD and MultiSWAG of 8 full-width ViT-MNIST
    particles, captured, on one device and on a MESH_N-position mesh;
    DeepEnsemble and SteinVGD also on a mesh of one position (the mesh
    path's cost with nothing split); #3 and #4 at a position's shapes."""
    _, module = vit_module()
    pl = mesh_placement(torch, real)
    n = len(pl.positions())
    probe = p15_probe(torch, module)
    out, keep, launches, failed = {}, {}, {}, []
    for name in ("ensemble", "svgd", "multiswag"):
        one = p15_train(torch, module, name, None, False)
        one["algo"].cleanup()
        del one["algo"]
        if not real:
            KEEP.setdefault("p15_one", {})[name] = {
                k: one[k] for k in ("losses", "params", "swag", "wall_s",
                                    "images_per_s", "per_device_bytes")}
            KEEP["p15_probe"] = probe
        gc.collect()
        torch.cuda.empty_cache()
        if name != "multiswag" and not real:
            # the mesh path at one position, beside one device
            pos1 = p15_train(torch, module, name, one_position(torch), False)
            pos1["algo"].cleanup()
            del pos1["algo"]
            row1, bad = p15_compare(torch, name, one, pos1, 1, probe)
            failed += [f"{name} at one position: {b}" for b in bad]
            del pos1
            gc.collect()
            torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mesh = p15_train(torch, module, name, pl, True)
        for k, v in mesh["launches"].items():
            launches[k] = launches.get(k, 0) + v
        # phase 4 runs SteinVGD and MultiSWAG as here
        want = (None if name == "ensemble" else
                (captured or {}).get(name, {}).get("last_losses"))
        row, bad = p15_compare(torch, name, one, mesh, n, probe, want)
        failed += [f"{name}: {b}" for b in bad]
        out[name] = dict(row, launches=mesh["launches"], steps=mesh["steps"],
                         peak_gb=torch.cuda.max_memory_allocated() / 2**30,
                         images_per_s_wall=TRAIN_P * TRAIN_B * mesh["steps"]
                         / mesh["wall_s"])
        if name != "multiswag" and not real:
            out[name]["one_position"] = {
                k: row1[k] for k in ("loss_max_abs", "params", "bits_equal",
                                     "captures", "wall_s",
                                     "last_epoch_images_per_s")}
        if name == "svgd":
            steps = mesh["steps"]
            if (mesh["launches"]["pairwise_sqdist"] != steps
                    or mesh["launches"]["svgd_force"] != steps):
                failed.append(f"SVGD launches {mesh['launches']}, want "
                              f"{steps} each")
        if name == "multiswag":
            from repro_torch.core.tree import tree_leaves
            n_leaves = len(tree_leaves(mesh["algo"].p_parameters()[0]))
            if mesh["launches"]["swag_moments"] != \
                    2 * collect_launches(n_leaves) * n:
                failed.append(f"MultiSWAG launches {mesh['launches']}")
            out[name]["shard_kernels"] = p15_shard_kernels(
                torch, mesh["algo"].store)
        if name == "svgd":
            mesh["algo"].cleanup()
        else:
            keep[name] = mesh["algo"]
        del one, mesh
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": 15, "part": "a",
          "placement": [str(d) for d in pl.positions()], **out,
          "g_hold": G_HOLD, "failed": failed, "card": card})
    if failed:
        raise AssertionError(f"phase 15 (a): {failed}")
    return keep, launches


def p15_one_particle_kernels(torch, cfg, module, reqs):
    """#5-#8 at one particle, a position's shard in (b): a store of capacity
    1 holding particle 0 (seed SEED), ``step_kernel_checks`` timed, at
    FP32_TOLS. #6 and #8 run on a mesh in phase 16. These launches are not
    the path's."""
    import functools
    from repro_torch.core import PushDistribution
    from repro_torch.models import api
    from repro_torch.serve.paging import create_kv_pages
    with PushDistribution(module, seed=SEED, capacity=1) as pd:
        pd.p_create()
        create_kv_pages(pd.store, functools.partial(
            api.paged_cache_init, cfg, num_pages=NUM_PAGES,
            page_size=PAGE_SIZE, dtype=pd.store.precision.kv))
        errs, rows = step_kernel_checks(
            torch, pd, cfg, pd.store.stacked("params"), [p for p, _ in reqs],
            NUM_PAGES, FP32_TOLS, timed=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"max_abs_err": errs, "rows": rows}


def p15_serving(torch, cfg, reqs, plain, keep, card, real=False):
    """(b) phase 2's requests through serve_decode(placement=) over 4
    qwen1.5-0.5b particles, one a position, then through the same store
    moved to one position and back to one device; #5-#8 at one particle;
    then the MultiSWAG posterior of 32 members, and the store-backed BMA
    through serve(placement=) on the mesh, at one position and on one
    device."""
    from repro_torch.core import ParticleModule, PushDistribution
    from repro_torch.core.store import Placement
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import mnist_like
    from repro_torch.models import api
    from repro_torch.runtime import ProgramCache
    from repro_torch.serve import serve
    pl = mesh_placement(torch, real)
    fns = attention_counts()
    module = ParticleModule(init=lambda g: api.init_params(g, cfg), cfg=cfg)
    L = cfg.n_layers

    def against_phase2(gens, what):
        tokens = [g.tokens for g in gens]
        lp = max(float(np.abs(np.array(g.logprobs) - np.array(w)).max())
                 for g, w in zip(gens, plain["logprobs"]))
        if tokens != plain["tokens"] or not lp < 1e-5:
            raise AssertionError(f"{what} vs phase 2: logprobs {lp}")
        return lp

    moved = {}
    with PushDistribution(module, seed=SEED, capacity=PARTICLES,
                          placement=pl) as pd:
        for _ in range(PARTICLES):
            pd.p_create()
        st0 = pd.store.snapshot_stats()
        gens, st, got, wall, warm, _ = serve_requests(
            torch, pd, cfg, reqs, fns, ProgramCache(), placement=pl)
        st1 = pd.store.snapshot_stats()
        per_dev = pd.store.per_device_bytes("params")
        lp = against_phase2(gens, "sharded decode")
        if not real:
            # the same store moved to one position, then to one device
            # (serve_decode reshards it): the mesh path's cost with
            # nothing split, beside the one-device path on the same work
            for where, place in (("one_position", one_position(torch)),
                                 ("one_device", Placement())):
                gens1, st_w, _, wall1, _, _ = serve_requests(
                    torch, pd, cfg, reqs, attention_counts(), ProgramCache(),
                    placement=place)
                moved[where] = {
                    "logprob_max_abs": against_phase2(gens1, where),
                    "tok_per_s": sum(len(g.tokens) for g in gens1) / wall1,
                    "steps": st_w["steps"]}
    decode = dict(run_summary(gens, st, warm, wall, None, info=[]),
                  kernel_launches=got, tokens_equal_phase2=True,
                  logprob_max_abs=lp, tok_per_s_phase2=plain["tok_per_s"],
                  per_device_param_gb=per_dev / 1e9, moved=moved)
    n = len(pl.positions())
    if (got["paged_decode_attention"] != n * L * st["steps"]
            or got["flash_attention"] != n * L * st["prefills"]):
        raise AssertionError(f"sharded decode launches {got}")
    decode["store_traffic"] = {k: st1[k] - st0[k] for k in TRAFFIC}
    gc.collect()
    torch.cuda.empty_cache()
    if not real:
        decode["one_particle_kernels"] = p15_one_particle_kernels(
            torch, cfg, module, reqs)

    # the MultiSWAG posterior of 32 members (phase 10's count) and the
    # store-backed BMA, through the batcher's predict
    algo = keep["multiswag"]
    images = mnist_like(np.random.default_rng(1), 64, 10)["images"]
    rows = [{"images": im} for im in images]
    heads, info = {}, {}
    diag = reset_counts()["swag_diag_std"]
    for where, place in (("one", None), ("mesh", pl)):
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        cache = ProgramCache()
        place = Placement() if place is None else place
        diag.launches = 0
        with algo.posterior_predictive(
                samples_per_particle=SERVE_S, generator=gen,
                placement=place, cache=cache, warmup=rows[0],
                max_batch=SERVE_MAX_BATCH) as svc:
            t0 = time.perf_counter()
            preds = [svc.predict(r, timeout=60) for r in rows]
            info[where] = {"diag_std_launches": diag.launches,
                           "wall_s": time.perf_counter() - t0,
                           "captures": cache.snapshot_stats()
                           ["cold_compiles"],
                           "members": svc.engine.num_particles}
        heads[where] = {k: np.stack([getattr(p, k) for p in preds])
                        for k in ("mean", "variance", "entropy",
                                  "mutual_info")}
    bma = max(float(np.abs(heads["one"][k] - heads["mesh"][k]).max())
              for k in heads["one"])
    n_leaves = len(tree_leaves(algo.p_parameters()[0]))
    if (not bma < 1e-5 or info["mesh"]["members"] != TRAIN_P * SERVE_S
            or info["mesh"]["diag_std_launches"]
            != n * collect_launches(n_leaves)
            or info["one"]["diag_std_launches"] != collect_launches(n_leaves)):
        raise AssertionError(f"sharded posterior vs one device: {bma} "
                             f"{info}")
    got["swag_diag_std"] = info["mesh"]["diag_std_launches"]
    # store-backed: per-request traffic and a second service on the mesh;
    # then the store moved to one position and to one device (serve
    # reshards it), the same requests timed on each
    store = algo.store
    store_bma, bma_heads = {}, {}
    plan = [("mesh", pl)] + ([] if real else [
        ("one_position", one_position(torch)), ("one_device", Placement())])
    for where, place in plan:
        cache = ProgramCache()
        with serve(algo, placement=place, cache=cache, warmup=rows[0],
                   max_batch=SERVE_MAX_BATCH) as svc:
            s0 = store.snapshot_stats()
            t0 = time.perf_counter()
            preds = [svc.predict(r, timeout=60) for r in rows]
            ms = (time.perf_counter() - t0) / len(rows) * 1e3
            s1 = store.snapshot_stats()
        bma_heads[where] = np.stack([p.mean for p in preds])
        store_bma[where] = {"ms_a_request": ms,
                            "traffic": {k: s1[k] - s0[k] for k in TRAFFIC},
                            "captures": cache.snapshot_stats()
                            ["cold_compiles"]}
        if where == "mesh":
            with serve(algo, placement=pl, cache=cache, warmup=rows[0],
                       max_batch=SERVE_MAX_BATCH) as svc:
                for r in rows[:8]:
                    svc.predict(r, timeout=60)
            store_bma[where]["captures_second_service"] = (
                cache.snapshot_stats()["cold_compiles"]
                - store_bma[where]["captures"])
    traffic = store_bma["mesh"]["traffic"]
    second = store_bma["mesh"]["captures_second_service"]
    spread = max(float(np.abs(h - bma_heads["mesh"]).max())
                 for h in bma_heads.values())
    if any(traffic.values()) or second or not spread < 1e-5:
        raise AssertionError(f"store-backed BMA: {store_bma}, heads apart "
                             f"by {spread}")
    emit({"phase": 15, "part": "b", "decode": decode,
          "posterior": {"members": info["mesh"]["members"],
                        "max_abs_vs_one_device": bma, "runs": info},
          "store_bma": dict(store_bma, requests=len(rows),
                            heads_max_abs_apart=spread),
          "card": card})
    return got


def p15_offload(torch, card, real=False):
    """(c) OFF_P qwen1.5-0.5b particles, OFF_UNITS of 24 units, trained by
    DeepEnsemble with sgd on the NEL (cache_size OFF_CACHE), OFF_STEPS
    steps of OFF_S tokens, with and without offload: equal losses and
    params bit for bit, and the offloaded run's peak device memory at
    least 5 particles' params under the other's."""
    from repro_torch import configs
    from repro_torch.bdl import DeepEnsemble
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import DataLoader
    from repro_torch.optim import sgd
    cfg = configs.get("qwen1.5-0.5b").replace(n_units=OFF_UNITS)
    module = lm_module(cfg)
    batches = list(DataLoader(cfg, batch_size=1, seq_len=OFF_S,
                              num_batches=OFF_STEPS, seed=SEED))
    runs, want = {}, None
    for offload in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        kw = ({"devices": [str(d) for d in
                           mesh_placement(torch, True).positions()]}
              if real else {})
        algo = DeepEnsemble(module, seed=SEED, cache_size=OFF_CACHE,
                            offload=offload, **kw)
        pd = algo.push_dist
        t0 = time.perf_counter()
        pids = [pd.p_create(sgd(OFF_LR)) for _ in range(OFF_P)]
        torch.cuda.synchronize()
        created = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = []
        for b in batches:
            b = algo._batch(b)
            futs = [pd.particles[p].step(b) for p in pids]
            losses.append([float(f.wait(NEL_T)) for f in futs])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        params = [[x.to("cpu", copy=True) for x in
                   tree_leaves(pd.particles[p].state["params"])]
                  for p in pids]
        nel = pd.nel
        sw = dict(nel.swap_stats)
        runs["offload" if offload else "resident"] = {
            "losses": losses, "peak_gb": peak / 1e9, "wall_s": wall,
            "create_s": created, "swaps_in": nel.stats["swaps_in"],
            "swaps_out": nel.stats["swaps_out"],
            "swap_bytes": {"in": sw["bytes_in"], "out": sw["bytes_out"]},
            "h2d_gb_per_s": sw["bytes_in"] / sw["s_in"] / 1e9
            if sw["s_in"] else None,
            "d2h_gb_per_s": sw["bytes_out"] / sw["s_out"] / 1e9
            if sw["s_out"] else None,
            "stacked_params_on_device": algo.store.is_stacked("params")}
        if want is None:
            want = (losses, params)
        else:
            same = losses == want[0] and all(
                torch.equal(x, y) for a, b in zip(params, want[1])
                for x, y in zip(a, b))
            runs["offload"]["bits_equal"] = same
        algo.cleanup()
        del algo, pd, params, nel
    per_particle = p17_param_count(cfg) * 4
    drop = (runs["resident"]["peak_gb"] - runs["offload"]["peak_gb"]) * 1e9
    row = {"phase": 15, "part": "c", "particles": OFF_P,
           "layers": cfg.n_layers,
           "cache_size": OFF_CACHE, "tokens_per_step": OFF_S,
           "steps": OFF_STEPS, **runs, "peak_drop_gb": drop / 1e9,
           "want_drop_gb": 5 * per_particle / 1e9, "card": card}
    emit(row)
    if not runs["offload"]["bits_equal"]:
        raise AssertionError("offloaded NEL training differs from resident")
    if drop < 5 * per_particle or runs["offload"]["swaps_out"] == 0:
        raise AssertionError(f"offload freed {drop / 1e9} GB")
    return row


def p15_checkpoint(torch, keep, card):
    """(d) (a)'s DeepEnsemble mesh store through save_store, restored onto
    the mesh and onto mesh=None: params bit for bit."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import restore_store, save_store
    from repro_torch.core.store import Placement, Sharded
    from repro_torch.core.tree import tree_leaves
    store = keep["ensemble"].store
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="phase15_", dir=os.path.join(ROOT, "build"))
    try:
        t0 = time.perf_counter()
        save_store(tmp, 1, store)
        save_s = time.perf_counter() - t0
        want = {p: store.read("params", p) for p in store.pids}
        out = {"save_s": save_s}
        for where, pl in (("mesh", store.placement), ("one", Placement())):
            t0 = time.perf_counter()
            _, got = restore_store(tmp, placement=pl, device=store.device)
            st = got.stacked("params")
            out[where] = {
                "restore_s": time.perf_counter() - t0,
                "sharded": isinstance(st, Sharded),
                "bits_equal": got.pids == store.pids and all(
                    torch.equal(a.to(b.device), b) for p in store.pids
                    for a, b in zip(tree_leaves(got.read("params", p)),
                                    tree_leaves(want[p])))}
            del got, st
        emit({"phase": 15, "part": "d", **out, "card": card})
        if not (out["mesh"]["bits_equal"] and out["one"]["bits_equal"]
                and out["mesh"]["sharded"] and not out["one"]["sharded"]):
            raise AssertionError(f"mesh store checkpoint: {out}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase15(torch, cfg, reqs, plain, captured, card):
    """The particle axis across GPUs: (a) sharded fused training, (b)
    sharded serving, (c) host offload on the NEL, (d) a mesh store's
    checkpoint, (e) real GPUs when there are several. Returns the
    kernels' launches over (a) and (b)."""
    t0 = time.perf_counter()
    keep, launches = p15_training(torch, card, captured)
    got = p15_serving(torch, cfg, reqs, plain, keep, card)
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    p15_checkpoint(torch, keep, card)
    for algo in keep.values():
        algo.cleanup()
    del keep
    gc.collect()
    torch.cuda.empty_cache()
    p15_offload(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    n = torch.cuda.device_count()
    if n >= 2:
        keep, _ = p15_training(torch, card, None, real=True)
        p15_serving(torch, cfg, reqs, plain, keep, card, real=True)
        for algo in keep.values():
            algo.cleanup()
        del keep
        gc.collect()
        torch.cuda.empty_cache()
        p15_offload(torch, card, real=True)
        multi = "run over " + ", ".join(
            str(d) for d in mesh_placement(torch, True).positions())
    else:
        multi = f"not run: {n} device"
    emit({"phase": 15, "part": "e", "multi_gpu": multi,
          "phase_s": time.perf_counter() - t0, "launches": launches,
          "card": card})
    return launches


# --------------------------------------------------------------------------
# phase 16: the model axis, one particle across a model group
# --------------------------------------------------------------------------

P16_MESH = (4, 2)                # positions, model axis: data 2 x model 2
P16_TIE = 1e-4                   # phase 6's near-tie rule
P16_PROB = 1e-4                  # BMA probabilities against one device
P16_CKPT_UNITS = 2               # (f): the checkpointed store's depth cut


def p16_placement(torch, model=2, n=4):
    """``data x model`` over n real GPUs where there are that many, else
    over n logical positions of cuda:0."""
    from repro_torch.core.store import Placement
    from repro_torch.launch import make_bench_mesh
    devices = ([f"cuda:{i}" for i in range(n)]
               if torch.cuda.device_count() >= n else ["cuda:0"] * n)
    return Placement(mesh=make_bench_mesh(n, model=model, devices=devices))


def p16_tokens(torch, pd, cfg, prompts, got, want, what):
    """Tokens equal to ``want``, or the first difference on a near-tie of
    the one-device run (``compare_tokens``, through the joined params)."""
    if [list(a) for a in got] == [list(b) for b in want]:
        return len(got), []
    dense = pd.store.dense("params")
    try:
        return compare_tokens(torch, pd, cfg, prompts, got, want, what,
                              params=dense, tie=P16_TIE)
    finally:
        del dense
        torch.cuda.empty_cache()


def p16_prob_gap(gens, logprobs):
    """The largest gap between the BMA probabilities of the generated
    tokens here and on one device, on each token both runs share."""
    gap = 0.0
    for g, w in zip(gens, logprobs):
        a, b = np.exp(np.array(g.logprobs)), np.exp(np.array(w))
        n = min(len(a), len(b))
        gap = max(gap, float(np.abs(a[:n] - b[:n]).max()))
    return gap


def p16_position_kernels(torch, lens, n_pmax, H, hd):
    """#5-#8 at a position's shapes (2 particles, H heads of hd, the pool
    of NUM_PAGES + 1 pages of PAGE_SIZE), on random inputs with NaN where
    no row reads, each against its plain version and timed beside it and
    the bound. These launches are not the path's."""
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import paged_decode_attention as pk
    from repro_torch.kernels import paged_decode_window_attention as wk
    from repro_torch.kernels import ref
    from repro_torch.runtime import bucket_size
    P, B, NP, W = 2, len(lens), NUM_PAGES + 1, SPEC_K + 1
    rows = {}
    args = paged_case(torch, 161, P, B, H, H, hd, PAGE_SIZE, n_pmax, NP, lens,
                      torch.float32)
    err = check_kernel(torch, pk.paged_decode_attention,
                       ref.paged_decode_attention, args, lens, 1e-4,
                       "#7 at a position")
    live = sum(L + 1 for L in lens)
    rows["paged_decode_attention"] = (err, args, pk.paged_decode_attention,
                                      ref.paged_decode_attention,
                                      P * live * H * hd * 2 * 4
                                      + 2 * args[0].numel() * 4,
                                      4 * P * live * H * hd)
    wlens = [L - W + 1 for L in lens]
    args = window_case(torch, 162, P, B, W, H, H, hd, PAGE_SIZE, n_pmax, NP,
                       wlens, torch.float32)
    err = check_kernel(torch, wk.paged_decode_window_attention,
                       ref.paged_decode_window_attention, args, wlens, 1e-4,
                       "#8 at a position")
    pairs = sum(W * L + W * (W + 1) // 2 for L in wlens)
    rows["paged_decode_window_attention"] = (
        err, args, wk.paged_decode_window_attention,
        ref.paged_decode_window_attention,
        P * sum(L + W for L in wlens) * H * hd * 2 * 4
        + 2 * args[0].numel() * 4, 4 * P * pairs * H * hd)
    Sp = bucket_size(max(lens) + 1)
    gen = torch.Generator(device="cuda").manual_seed(163)
    args = tuple(torch.randn((P, 1, Sp, H, hd), generator=gen, device="cuda")
                 for _ in range(3))
    err = max_err(torch, fk.flash_attention(*args), ref.flash_attention(*args),
                  "#5 at a position", 2e-5)
    rows["flash_attention"] = (err, args, fk.flash_attention,
                               ref.flash_attention, 4 * args[0].numel() * 4,
                               4 * P * H * hd * Sp * (Sp + 1) // 2)
    C = DENSE_LEN + DENSE_NEW + 1
    args = decode_case(torch, 164, P, DENSE_PROMPTS, C, H, H, hd, False,
                       n_valid=DENSE_LEN + DENSE_NEW)
    err = max_err(torch, dk.decode_attention(*args),
                  ref.decode_attention(*args), "#6 at a position", 2e-5)
    valid = DENSE_LEN + DENSE_NEW
    rows["decode_attention"] = (err, args, dk.decode_attention,
                                ref.decode_attention,
                                P * DENSE_PROMPTS * valid * H * hd * 2 * 4
                                + 2 * args[0].numel() * 4,
                                4 * P * DENSE_PROMPTS * valid * H * hd)
    out = {}
    for name, (err, a, fn, plain, nbytes, flops) in rows.items():
        b_ms, b_by = bound(nbytes, flops)
        out[name] = {"max_abs_err": err, "ms": time_ms(torch, lambda: fn(*a)),
                     "plain_ms": time_ms(torch, lambda: plain(*a), iters=10),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "shape": {"P": P, "H": H, "hd": hd,
                               "q": list(a[0].shape)}}
    del rows, args
    torch.cuda.empty_cache()
    return out


def p16_serving(torch, cfg, reqs, plain, card):
    """(a) phase 2's load on data 2 x model 2, captured; (c) phase 6's
    speculative run; (b) phase 7's dense-cache run; (f) a depth-cut store
    through save_store / restore_store. Returns (launches over the runs, the
    per-position kernel rows, the card's seconds)."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import restore_store, save_store
    from repro_torch.core import ParticleModule, PushDistribution
    from repro_torch.core.tree import Group, tree_leaves
    from repro_torch.models import api
    from repro_torch.runtime import ProgramCache
    from repro_torch.serve import PredictiveEngine
    pl = p16_placement(torch)
    n_pos, L = P16_MESH[0], cfg.n_layers
    H = cfg.n_heads // P16_MESH[1]
    # a group on one device captures every step as a CUDA graph; on
    # distinct GPUs a group's steps run eagerly (runtime.program.lower)
    one_card = all(len(set(g)) == 1 for g in pl.groups())
    module = ParticleModule(init=lambda g: api.init_params(g, cfg), cfg=cfg)
    prompts = [p for p, _ in reqs]
    fns = attention_counts()
    out, launches, failed = {}, {}, []

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    torch.cuda.reset_peak_memory_stats()
    with PushDistribution(module, seed=SEED, capacity=PARTICLES,
                          placement=pl) as pd:
        for _ in range(PARTICLES):
            pd.p_create()
        marks = [("start", time.perf_counter())]
        # (a) plain paged decode; then one decode step's device time
        # (every row inactive: the same GEMVs, no page read)
        prof = {}

        def profile_a(svc, _):
            packed = np.zeros((MAX_ACTIVE, 2 + svc.engine.n_pmax), np.int32)
            packed[:, 1] = -1
            prof["a"] = profile_steps(
                torch, lambda: svc.engine.decode_step(packed), n=3)

        st0 = pd.store.snapshot_stats()
        info_a = []
        gens, st, got, wall, warm, n_pmax = serve_requests(
            torch, pd, cfg, reqs, fns, ProgramCache(), info=info_a,
            placement=pl, hold=profile_a)
        st1 = pd.store.snapshot_stats()
        add(got)
        pages = pd.store.stacked("kv_pages")
        grp = pages.shards[0]
        heads = grp[0]["units"][0]["k"].shape[-2]
        exact, gaps = p16_tokens(torch, pd, cfg, prompts,
                                 [g.tokens for g in gens], plain["tokens"],
                                 "2 x 2 decode vs phase 2")
        gap = p16_prob_gap(gens, plain["logprobs"])
        want = {"paged_decode_attention": n_pos * L * st["steps"],
                "flash_attention": n_pos * L * st["prefills"],
                "paged_decode_window_attention": 0, "decode_attention": 0}
        out["a"] = dict(run_summary(gens, st, warm, wall, None, info=info_a),
                        kernel_launches=got, want_launches=want,
                        requests_token_equal=exact, tie_gaps=gaps,
                        prob_max_abs=gap, pool_heads_a_position=heads,
                        step_profile=prof["a"],
                        store_traffic={k: st1[k] - st0[k] for k in TRAFFIC},
                        tok_per_s_one_device=plain["tok_per_s"],
                        per_device_param_gb=pd.store.per_device_bytes(
                            "params") / 1e9)
        failed += [w for w, bad in (
            ("(a) launches", got != want),
            ("(a) BMA probabilities", not gap < P16_PROB),
            ("(a) a step not captured", one_card and not (info_a and all(
                p["graph"] for p in info_a))),
            ("(a) pool heads", heads != cfg.n_kv_heads // P16_MESH[1]
             or not isinstance(grp, Group))) if bad]
        lens = [min(len(p) + m - 1, n_pmax * PAGE_SIZE - SPEC_K - 2)
                for p, m in reqs]
        del pages, grp
        marks.append(("a", time.perf_counter()))
        # (c) speculative
        info_c = []
        gens_s, st, got, wall, warm, _ = serve_requests(
            torch, pd, cfg, reqs, fns, ProgramCache(), info=info_c,
            placement=pl, speculative=SPEC_K)
        add(got)
        ss = st["speculative"]
        iters = (st["engine"]["draft_iterations"]
                 - warm["engine"]["draft_iterations"])
        want = {"paged_decode_window_attention": n_pos * L * ss["verify_calls"],
                "paged_decode_attention": P16_MESH[1] * L * iters,
                "flash_attention": n_pos * L * st["prefills"],
                "decode_attention": 0}
        exact_s, gaps_s = p16_tokens(torch, pd, cfg, prompts,
                                     [g.tokens for g in gens_s],
                                     plain["tokens"],
                                     "2 x 2 speculative vs phase 2")
        out["c"] = dict(run_summary(gens_s, st, warm, wall, None,
                                    info=info_c),
                        kernel_launches=got, want_launches=want,
                        draft_iterations=iters, speculative=ss,
                        requests_token_equal=exact_s, tie_gaps=gaps_s)
        if got != want or ss["verify_calls"] == 0:
            failed.append("(c) launches")
        if one_card and not (info_c and all(p["graph"] for p in info_c)):
            failed.append("(c) a step not captured")
        marks.append(("c", time.perf_counter()))
        # (b) dense caches through PredictiveEngine(stateful=True)
        rng = np.random.default_rng(2)
        dprompts = rng.integers(1, cfg.vocab_size, (DENSE_PROMPTS, DENSE_LEN))
        toks = torch.as_tensor(dprompts, dtype=torch.int32, device="cuda")
        C = DENSE_LEN + DENSE_NEW + 1

        def fwd(params, caches, batch):
            return api.decode_step(params, batch["token"], caches,
                                   batch["cur_pos"], cfg)

        cache = ProgramCache()
        engine = PredictiveEngine(fwd, store=pd.store, stateful=True,
                                  cache=cache)
        for fn in fns.values():
            fn.launches = 0
        t0 = time.perf_counter()
        state = engine.init_state(lambda p: api.prefill(
            p, {"tokens": toks[:, :-1]}, cfg, max_len=C)[1])
        tok, dense = toks[:, -1], []
        for step in range(DENSE_NEW):
            heads_, state = engine.step(state, {
                "token": tok, "cur_pos": DENSE_LEN - 1 + step})
            tok = heads_["mean"].argmax(-1).to(torch.int32)
            dense.append(tok)
        dense = torch.stack(dense, 1).cpu().numpy().tolist()
        wall = time.perf_counter() - t0
        got = read_counts(fns)
        add(got)
        last, cur = tok, DENSE_LEN - 1 + DENSE_NEW
        step_prof = profile_steps(torch, lambda: engine.step(
            state, {"token": last, "cur_pos": cur}), n=3)
        want = {"paged_decode_attention": 0,
                "paged_decode_window_attention": 0,
                "flash_attention": n_pos * L,
                "decode_attention": n_pos * L * DENSE_NEW}
        kheads = state.shards[0][0]["units"][0]["k"].shape[-2]
        p7 = KEEP.get("phase7_tokens")
        exact_d, gaps_d = (p16_tokens(torch, pd, cfg, dprompts, dense, p7,
                                      "2 x 2 dense vs phase 7")
                           if p7 is not None else (None, []))
        out["b"] = {"wall_s": wall,
                    "tok_per_s": DENSE_PROMPTS * DENSE_NEW / wall,
                    "kernel_launches": got, "want_launches": want,
                    "captures": cache.snapshot_stats()["cold_compiles"],
                    "graphs": all(p["graph"] for p in cache.program_costs()),
                    "step_profile": step_prof,
                    "cache_heads_a_position": kheads,
                    "requests_token_equal_phase7": exact_d,
                    "tie_gaps": gaps_d}
        failed += [w for w, bad in (
            ("(b) launches", got != want),
            # a step program per data position and the heads' combine
            ("(b) captures", out["b"]["captures"] != P16_MESH[0] // P16_MESH[1]
             + 1 or not out["b"]["graphs"]),
            ("(b) cache heads", kheads != cfg.n_kv_heads // P16_MESH[1]),
            ("(b) no phase 7 tokens", p7 is None)) if bad]
        del state, engine, cache
        torch.cuda.empty_cache()
        marks.append(("b", time.perf_counter()))
    # (f) checkpoints, the depth cut to P16_CKPT_UNITS of 24 units (full
    # width; the full store's npz path is phase 14's): a 2 x 2 store of
    # PARTICLES through a file, restored onto 2 x 2; its rows (the file's
    # arrays, copied exactly) against the one-device store's, and the
    # load it served before the file served again
    gc.collect()
    torch.cuda.empty_cache()
    ccfg = cfg.replace(n_units=P16_CKPT_UNITS)
    cmod = ParticleModule(init=lambda g: api.init_params(g, ccfg), cfg=ccfg)
    with PushDistribution(cmod, seed=SEED, capacity=PARTICLES,
                          placement=pl) as cpd:
        for _ in range(PARTICLES):
            cpd.p_create()
        gens_c, _, got, _, _, _ = serve_requests(
            torch, cpd, ccfg, reqs, fns, ProgramCache(), placement=pl)
        add(got)
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        tmp = tempfile.mkdtemp(prefix="phase16_",
                               dir=os.path.join(ROOT, "build"))
        try:
            t0 = time.perf_counter()
            save_store(tmp, 1, cpd.store, keys=["params"])
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            _, store = restore_store(tmp, placement=pl, device="cuda:0")
            restore_s = time.perf_counter() - t0
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    replicas = p16_replicas_equal(torch, store.stacked("params"))
    with PushDistribution(cmod, seed=SEED, capacity=PARTICLES) as one:
        for _ in range(PARTICLES):
            one.p_create()
        same = store.pids == one.store.pids and all(
            torch.equal(a, b) for p in one.store.pids
            for a, b in zip(tree_leaves(store.read("params", p)),
                            tree_leaves(one.store.read("params", p))))
    gc.collect()
    torch.cuda.empty_cache()
    gens_r, _, got, _, _, _ = serve_requests(
        torch, store, ccfg, reqs, fns, ProgramCache())
    add(got)
    same_tokens = [g.tokens for g in gens_r] == [g.tokens for g in gens_c]
    del store
    out["f"] = {"units": P16_CKPT_UNITS, "rows_bit_equal_one_device": same,
                "save_s": save_s, "restore_s": restore_s,
                "restored_replicas_bit_equal": replicas,
                "restored_tokens_equal_before": same_tokens}
    failed += [w for w, bad in (
        ("(f) rows", not same), ("(f) replicas", not replicas),
        ("(f) tokens", not same_tokens)) if bad]
    gc.collect()
    torch.cuda.empty_cache()
    marks.append(("f", time.perf_counter()))
    kernels = p16_position_kernels(torch, lens, n_pmax, H, cfg.hd)
    marks.append(("position_kernels", time.perf_counter()))
    out["part_s"] = {k: t - marks[i][1] for i, (k, t) in
                     enumerate(marks[1:])}
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    emit({"phase": 16, "part": "serving", "placement": str(pl.groups()),
          **out, "position_kernels": kernels, "failed": failed,
          "card": card})
    if failed:
        raise AssertionError(f"phase 16 serving: {failed}")
    return launches, kernels


def p16_replicas_equal(torch, sharded):
    """Every replicated leaf bit-equal across each model group."""
    from repro_torch.sharding.rules import named_leaves
    for grp in sharded.shards:
        first = named_leaves(grp[0])
        for shard in grp.shards[1:]:
            for (path, a), (_, b) in zip(first, named_leaves(shard)):
                if grp.dims[path] is None and not torch.equal(
                        a, b.to(a.device)):
                    return False
    return True


def p16_footprint(torch, cfg, reqs, card):
    """(e) one full-width qwen1.5-0.5b particle on a model-only 1 x 4 plan
    against one device: the per-device param bytes and one greedy
    decode."""
    from repro_torch.core import ParticleModule, PushDistribution
    from repro_torch.models import api
    from repro_torch.runtime import ProgramCache
    module = ParticleModule(init=lambda g: api.init_params(g, cfg), cfg=cfg)
    req = [(reqs[0][0], 16)]
    fns = attention_counts()
    runs = {}
    for tag, pl in (("one", None), ("model4", p16_placement(torch, 4))):
        with PushDistribution(module, seed=SEED, capacity=1,
                              placement=pl) as pd:
            pd.p_create()
            pd.store.stacked("params")
            bytes_ = pd.stats()["placement"]["per_device_param_bytes"]
            gens, st, got, wall, _, _ = serve_requests(
                torch, pd, cfg, req, fns, ProgramCache(), placement=pl)
            runs[tag] = {"per_device_param_bytes": bytes_,
                         "tokens": gens[0].tokens, "kernel_launches": got,
                         "tok_per_s": len(gens[0].tokens) / wall,
                         "steps": st["steps"]}
            if tag == "model4":
                exact, gaps = p16_tokens(torch, pd, cfg, [req[0][0]],
                                         [gens[0].tokens],
                                         [runs["one"]["tokens"]],
                                         "1 x 4 vs one device")
        gc.collect()
        torch.cuda.empty_cache()
    ratio = (runs["model4"]["per_device_param_bytes"]
             / runs["one"]["per_device_param_bytes"])
    row = {"phase": 16, "part": "e", **runs, "ratio": ratio,
           "token_equal": exact, "tie_gaps": gaps, "card": card}
    emit(row)
    if not ratio <= 0.3:
        raise AssertionError(f"1 x 4 footprint ratio {ratio}")
    return runs["model4"]["kernel_launches"]


def p16_svgd_kernels(torch, store):
    """#1 and #2 at a position's shapes on (d)'s trained 2 x 2 SteinVGD
    store: each model shard's (n, D_j) block of the gathered matrix (its
    split leaves, the replicated ones in the first block), #1 per block
    against its plain version and the blocks' sum against #1 over the
    whole matrix (within 1e-5 of its largest entry), then #2 per block
    with the shared K against its plain version; each timed beside its
    plain version and the bound. These launches are not the path's."""
    from repro_torch.bdl.svgd import _owned, rbf_glue
    from repro_torch.core.functional import flatten_stacked
    from repro_torch.kernels import ref, svgd_rbf
    params, mask = store.stacked("params"), store.active_mask()
    m = len(params.shards[0])
    blocks = []
    for j in range(m):
        rows = []
        for grp in params.shards:
            leaves = _owned(grp[j], grp.dims, j)
            n = leaves[0].shape[0]
            rows.append(torch.cat([x.reshape(n, -1).float() for x in leaves],
                                  1).to("cuda:0"))
        blocks.append(torch.cat(rows))
    full = flatten_stacked(params.gather("cuda:0"))[0].float()
    whole = svgd_rbf.pairwise_sqdist(full, mask)
    parts = [svgd_rbf.pairwise_sqdist(b, mask) for b in blocks]
    errs = [float((p - ref.pairwise_sqdist(b, mask)).abs().max()
                  / ref.pairwise_sqdist(b, mask).abs().max().clamp(min=1e-30))
            for p, b in zip(parts, blocks)]
    summed = parts[0]
    for p in parts[1:]:
        summed = summed + p
    sum_err = float((summed - whole).abs().max() / whole.abs().max())
    glue = rbf_glue(summed, 0.0, mask)
    gen = torch.Generator(device="cuda").manual_seed(165)
    gs = [torch.randn(b.shape, generator=gen, device="cuda") * 1e-3
          for b in blocks]
    ferrs = []
    for b, g in zip(blocks, gs):
        got = svgd_rbf.svgd_force(b, g, *glue, mask)
        want = ref.svgd_force(b, g, *glue, mask)
        ferrs.append(float((got - want).abs().max()
                           / want.abs().max().clamp(min=1e-30)))
    b0, g0 = blocks[0], gs[0]
    out = {"pairwise_sqdist": {
        "max_rel_err": max(errs), "sum_vs_whole_rel": sum_err,
        "D_blocks": [b.shape[1] for b in blocks], "D": full.shape[1],
        "ms": time_ms(torch, lambda: svgd_rbf.pairwise_sqdist(b0, mask)),
        "plain_ms": time_ms(torch, lambda: ref.pairwise_sqdist(b0, mask),
                            iters=10)},
        "svgd_force": {
        "max_rel_err": max(ferrs),
        "ms": time_ms(torch, lambda: svgd_rbf.svgd_force(b0, g0, *glue,
                                                         mask)),
        "plain_ms": time_ms(torch, lambda: ref.svgd_force(b0, g0, *glue,
                                                          mask), iters=10)}}
    for name, cost in (("pairwise_sqdist", svgd_rbf.sqdist_cost(b0)),
                       ("svgd_force", svgd_rbf.force_cost(b0))):
        out[name]["bound_ms"], out[name]["bound_by"] = bound(cost[1],
                                                             cost[0])
    del blocks, full, gs
    torch.cuda.empty_cache()
    if not (max(errs) < 1e-5 and sum_err < 1e-5 and max(ferrs) < 1e-5):
        raise AssertionError(f"#1 / #2 at a position's shapes: {out}")
    return out


def p16_training(torch, card):
    """(d) phase 15 (a)'s runs (8 full-width ViT-MNIST particles,
    DeepEnsemble with sgd, SteinVGD with the median heuristic, MultiSWAG
    with Adam) on data 2 x model 2, captured, held to phase 15's
    one-device runs as phase 15 holds its mesh; #1 and #2 at a position's
    shapes."""
    _, module = vit_module()
    pl = p16_placement(torch)
    n_data, m = P16_MESH[0] // P16_MESH[1], P16_MESH[1]
    ones, probe = KEEP.get("p15_one", {}), KEEP.get("p15_probe")
    out, launches, failed = {}, {}, []
    if probe is None:
        probe = p15_probe(torch, module)
    for name in ("ensemble", "svgd", "multiswag"):
        t0 = time.perf_counter()
        one = ones.get(name)
        if one is None:
            one = p15_train(torch, module, name, None, False)
            one["algo"].cleanup()
            del one["algo"]
        torch.cuda.reset_peak_memory_stats()
        run = p15_train(torch, module, name, pl, True)
        for k, v in run["launches"].items():
            launches[k] = launches.get(k, 0) + v
        row, bad = p15_compare(torch, name, one, run, n_data, probe)
        # a position holds its 1/n_data of the rows and, of a split leaf,
        # its 1/m: within 1.2x of 1/(n_data * m) of one device, as (e)
        # holds the LM's 1 x 4 at 0.3 (1.2 / 4)
        bad = [b for b in bad if b != "per-device bytes"]
        row["bytes_ratio"] = run["per_device_bytes"] / one["per_device_bytes"]
        if not row["bytes_ratio"] <= 1.2 / (n_data * m):
            bad.append("per-device bytes")
        store = run["algo"].store
        keys = {"ensemble": ("params", "opt_state"), "svgd": ("params",),
                "multiswag": ("params", "opt_state", "swag")}[name]
        replicas = all(p16_replicas_equal(torch, store.stacked(k))
                       for k in keys)
        if not replicas:
            bad.append("replicated copies apart")
        steps = run["steps"]
        if name == "svgd" and (run["launches"]["pairwise_sqdist"] != m * steps
                               or run["launches"]["svgd_force"] != m * steps):
            bad.append(f"SVGD launches {run['launches']}")
        if name == "multiswag":
            from repro_torch.core.tree import tree_leaves
            n_leaves = len(tree_leaves(run["algo"].p_parameters()[0]))
            if run["launches"]["swag_moments"] != \
                    2 * collect_launches(n_leaves) * n_data * m:
                bad.append(f"MultiSWAG launches {run['launches']}")
        out[name] = dict(row, launches=run["launches"], steps=steps,
                         replicas_bit_equal=replicas,
                         peak_gb=torch.cuda.max_memory_allocated() / 2**30,
                         images_per_s_wall=TRAIN_P * TRAIN_B * steps
                         / run["wall_s"])
        if name == "multiswag":
            post, diag = p16_posterior(torch, run["algo"], pl)
            out[name]["posterior"] = post
            launches["swag_diag_std"] = launches.get("swag_diag_std",
                                                     0) + diag
            if not post["max_abs_vs_one_device"] < P16_PROB or \
                    diag != collect_launches(n_leaves) * n_data * m:
                bad.append(f"MultiSWAG posterior {post}")
        if name == "ensemble":
            # the fused step alone (a SteinVGD run captures its force
            # program anew on its own blocks, so a profile of short runs
            # would time captures)
            out[name]["epoch_profile"] = p16_epoch_profile(
                torch, module, run["algo"], name)
        out[name]["part_s"] = time.perf_counter() - t0
        if name == "svgd":
            out[name]["position_kernels"] = p16_svgd_kernels(torch, store)
        failed += [f"{name}: {b}" for b in bad]
        run["algo"].cleanup()
        del run, store
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": 16, "part": "d", "placement": str(pl.groups()), **out,
          "failed": failed, "card": card})
    if failed:
        raise AssertionError(f"phase 16 (d): {failed}")
    return launches, out["svgd"]["position_kernels"]


def p16_posterior(torch, algo, pl):
    """The MultiSWAG posterior of SERVE_S draws a particle (32 members)
    sampled per model shard on the 2 x 2 store, and on one device from
    the same state and noise: the BMA heads of one batch of 8 images.
    First #4 at each model shard's leaves (``diag_std_parity``: bit-equal
    to the per-leaf kernel). Returns (the row, #4's launches on 2 x
    2)."""
    from repro_torch.core.store import Placement
    from repro_torch.core.tree import Group, tree_flatten
    from repro_torch.data import mnist_like
    images = {"images": mnist_like(np.random.default_rng(1), 8,
                                   10)["images"]}
    errs = []
    for i, shard in enumerate(algo.store.stacked("swag").shards):
        for j, part in enumerate(shard if isinstance(shard, Group)
                                 else [shard]):
            errs.append(diag_std_parity(torch, *(
                tree_flatten(part[k], sort_keys=True)[0]
                for k in ("mean", "sq_mean")),
                f"data {i}, model {j}")["max_abs_err"])
    diag = reset_counts()["swag_diag_std"]
    heads, launches = {}, {}
    for where, place in (("one", Placement()), ("two", pl)):
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        diag.launches = 0
        with algo.posterior_predictive(
                samples_per_particle=SERVE_S, generator=gen, placement=place,
                warmup=False) as svc:
            heads[where] = svc.predict_batch(images)
            launches[where] = diag.launches
            members = svc.engine.num_particles
    err = max(float((heads["one"][k] - heads["two"][k]).abs().max())
              for k in heads["one"])
    torch.cuda.empty_cache()
    return {"members": members, "max_abs_vs_one_device": err,
            "diag_std_launches": launches,
            "diag_std_shards_max_abs_err": errs}, launches["two"]


def p16_epoch_profile(torch, module, algo, name):
    """The device time of one more fused run of one batch on a trained
    DeepEnsemble store (host ms include the run's checkout and
    commit)."""
    from repro_torch.data import DataLoader
    from repro_torch.optim import sgd
    kw = {"ensemble": {"optimizer": sgd(P15_LR)}}[name]
    batch = [next(iter(DataLoader(module.cfg, batch_size=TRAIN_B,
                                  num_batches=1, seed=SEED)))]
    pids = algo.push_dist.particle_ids()
    return profile_steps(torch, lambda: algo._fused_epochs(pids, batch, 1,
                                                           **kw), n=3)


def phase16(torch, cfg, reqs, plain, card):
    """The model axis: one particle across a model group (data 2 x model
    2 on one card's logical positions, or on four GPUs): serving (a),
    dense caches (b), speculative decode (c), training (d), the 1 x 4
    footprint (e) and checkpoints (f). Returns (the kernels' launches
    over the runs, the per-position kernel rows)."""
    t0 = time.perf_counter()
    gc.collect()
    gc_s = time.perf_counter() - t0
    gc_objects = len(gc.get_objects())
    launches, rows = p16_serving(torch, cfg, reqs, plain, card)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    for k, v in p16_footprint(torch, cfg, reqs, card).items():
        launches[k] = launches.get(k, 0) + v
    gc.collect()
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    got, svgd_rows = p16_training(torch, card)
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    rows.update(svgd_rows)
    emit({"phase": 16, "part": "summary", "phase_s": time.perf_counter() - t0,
          "part_s": {"serving": t1 - t0, "footprint": t2 - t1,
                     "training": time.perf_counter() - t2},
          "gc_collect_s": gc_s, "gc_objects": gc_objects,
          "launches": launches, "card": card})
    return launches, rows


# --------------------------------------------------------------------------
# phase 17: the decoder-only model zoo (MoE and sliding-window layers)
# --------------------------------------------------------------------------

P17_DS_UNITS = 2                 # (a): head attn_mlp + 2 of 27 attn_moe units
P17_DS_P = 2                     # deepseek-moe-16b default_particles
P17_TRAIN_UNITS = 1              # (b): head + 1 unit
P17_TRAIN_S = 512                # one lm_batch sequence a step
P17_TRAIN_STEPS = 4
P17_SVGD_STEPS = 2
P17_QW_UNITS = 1                 # (c): 1 of 94 attn_moe units, 1 particle
P17_GM_P = 2                     # (d): gemma3-4b, 1 unit + 4 tail local
P17_GM_B, P17_GM_LEN, P17_GM_NEW = 4, 1237, 32   # prompts past the 1,024 window
P17_MOE_TOL = 1e-4               # moe_apply vs moe_ref, of the largest |y|


def p17_cut(cfg, **kw):
    """A zoo config cut in depth only (printed beside each part)."""
    cut = cfg.replace(**kw)
    return cut, {"name": cfg.name, "layers": cut.n_layers,
                 "of_layers": cfg.n_layers, "cut": kw}


def p17_param_count(cfg):
    from repro_torch.models import api
    return api.param_footprint(cfg) // 4


def p17_expert_share(torch, params, cfg, T, step_ms):
    """Event ms of the step's own expert products (``moe._expert_products``
    over each MoE layer's wi, wg and wo as the step holds them: a unit's
    are strided views of its stacked leaves) on a (P, E, C, D) buffer of
    ``T`` routed tokens a particle, over ``step_ms``. A separate timing
    (the captured step's profile does not say which GEMM is whose),
    beside the computed (capacity-padded) and the routed tokens' FLOPs of
    one step."""
    from repro_torch.models import moe
    from repro_torch.models.transformer import unbind_units
    E, D, F = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    P, C = params["embed"].shape[0], moe.capacity(cfg, T)
    layers = [p["moe"] for k, p in zip(
        [*cfg.head_layers, *cfg.tail_layers],
        [*params["head"], *params["tail"]]) if k == "attn_moe"]
    for kind, unit in zip(cfg.pattern, params["units"]):
        if kind == "attn_moe":
            layers += [u["moe"] for u in unbind_units(unit)]
    gen = torch.Generator(device="cuda").manual_seed(171)
    buf = torch.randn((P, E, C, D), generator=gen, device="cuda")

    def experts():
        for p in layers:
            h = moe._expert_products(buf, p["wi"])
            moe._expert_products(buf, p["wg"])
            moe._expert_products(h, p["wo"])

    ms = time_ms(torch, experts, iters=10)
    del buf
    torch.cuda.empty_cache()
    per = 2 * 3 * D * F * P * len(layers)
    return {"expert_products_ms": ms, "moe_layers": len(layers),
            "step_device_ms": step_ms,
            "expert_share": ms / step_ms if isinstance(step_ms, float)
            else "not measured",
            "capacity": C, "routed_tokens": T,
            "computed_expert_flops": per * E * C,
            "routed_expert_flops": per * T * cfg.top_k}


def p17_moe_check(torch, params, cfg, B):
    """One decode step's MoE (unit 0's, every particle) on a random normed
    input of B tokens: moe_apply within P17_MOE_TOL of the largest |y| of
    moe_ref, and nothing dropped."""
    from repro_torch.models import moe
    from repro_torch.models.blocks import norm_apply
    p = unit0(params, "moe")
    gen = torch.Generator(device="cuda").manual_seed(172)
    x = torch.randn((params["embed"].shape[0], B, 1, cfg.d_model),
                    generator=gen, device="cuda")
    x = norm_apply(unit0(params, "ln2"), x)
    with torch.no_grad():
        y, aux = moe.moe_apply(p, x, cfg)
        yr = moe.moe_ref(p, x, cfg)
    err = float((y - yr).abs().max() / yr.abs().max())
    dropped = aux["dropped_frac"].tolist()
    if not err < P17_MOE_TOL or max(dropped) != 0.0:
        raise AssertionError(f"decode-step MoE vs moe_ref {err}, dropped "
                             f"{dropped}")
    return {"rel_err": err, "dropped_frac": dropped}


def p17_bucket_drops(torch, params, cfg, reqs):
    """Each prefill bucket's dropped_frac, per MoE layer and particle: the
    first prompt of each pow2 bucket, padded as the engine pads it,
    through a dense prefill."""
    from repro_torch.models import moe
    from repro_torch.runtime import bucket_size
    out = {}
    for prompt, _ in reqs:
        Sp = bucket_size(len(prompt))
        if str(Sp) in out:
            continue
        toks = torch.zeros((1, Sp), dtype=torch.int32, device="cuda")
        toks[0, :len(prompt)] = torch.tensor(prompt, dtype=torch.int32)
        out[str(Sp)] = {"capacity": moe.capacity(cfg, Sp),
                        "dropped_frac_by_layer": p17_prefill_drops(
                            torch, params, cfg, toks)}
    return out


def p17_prefill_drops(torch, params, cfg, toks):
    """dropped_frac of each MoE layer and particle in one dense prefill of
    the prompts ``toks`` (B, S), all routed together."""
    from repro_torch.models import api, moe
    got, orig = [], moe.moe_apply

    def rec(*a, **k):
        y, aux = orig(*a, **k)
        got.append(aux["dropped_frac"].tolist())
        return y, aux

    moe.moe_apply = rec
    try:
        with torch.no_grad():
            api.prefill(params, {"tokens": toks}, cfg)
    finally:
        moe.moe_apply = orig
    return got


def p17_decode_profile(torch, pd, cfg, reqs, n_pmax):
    """One decode step of phase 2's shape (the first MAX_ACTIVE prompts
    freshly prefilled into the checked-out pool) as a captured program:
    its profile (counters held to the profiler) and its
    ``Program.cost()``."""
    from repro_torch.models import api
    from repro_torch.runtime import ProgramCache, specs
    from repro_torch.serve.engine import sample_heads
    store = pd.store
    pages = store.checkout("kv_pages")
    try:
        params, mask, bt, tok, sl = prefilled_rows(
            torch, pd, cfg, [p for p, _ in reqs[:MAX_ACTIVE]], n_pmax, pages)
        packed = np.concatenate([tok.cpu().numpy()[:, None],
                                 sl.cpu().numpy()[:, None],
                                 bt.cpu().numpy()], 1).astype(np.int32)
        spec = specs.paged_decode_step(
            lambda p, pg, t, b, s: api.decode_step_paged(p, t, pg, b, s, cfg),
            sample_heads, key=("p17", cfg.name))
        cache = ProgramCache()
        args = (params, pages, packed, mask)
        prog = cache.program(spec, args)
        if prog.graph is None:
            raise AssertionError("(a) the decode step was not captured")
        prof = profile_steps(torch, lambda: prog(*args), n=3,
                             fns=attention_counts(), prologue=32,
                             epilogue=32)
        prof["program_cost"] = prog.cost()
        del prog, cache, args
    finally:
        store.commit("kv_pages", pages)
    torch.cuda.empty_cache()
    return prof


def p17_deepseek_serving(torch, card):
    """(a) deepseek-moe-16b: plain paged serving captured and eager,
    speculative, and the dense-cache engine, over phase 2's requests."""
    from repro_torch import configs
    from repro_torch.core import ParticleModule, PushDistribution
    from repro_torch.models import api
    from repro_torch.runtime import ProgramCache
    cfg, cut = p17_cut(configs.get("deepseek-moe-16b"), n_units=P17_DS_UNITS)
    L = cfg.n_layers
    reqs = traffic(cfg.vocab_size)
    module = ParticleModule(init=lambda g: api.init_params(g, cfg), cfg=cfg)
    fns = attention_counts()
    total = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with PushDistribution(module, seed=SEED) as pd:
        for _ in range(P17_DS_P):
            pd.p_create()
        params = pd.store.stacked("params")
        runs, toks, launches = {}, {}, {}
        for mode, cache in caches():
            gens, st, got, wall, warm, n_pmax = serve_requests(
                torch, pd, cfg, reqs, fns, cache)
            plain_launches(st, got, L, f"(a) {mode}")
            add_counts(total, got)
            runs[mode] = run_summary(gens, st, warm, wall, cache)
            toks[mode] = [g.tokens for g in gens]
            launches[mode] = got
        same_launches(launches, "phase 17 (a)")
        prompts = [p for p, _ in reqs]
        exact, gaps = compare_tokens(torch, pd, cfg, prompts,
                                     toks["captured"], toks["eager"],
                                     "(a) captured vs eager")
        gens, st, got, wall, warm, _ = serve_requests(
            torch, pd, cfg, reqs, fns, ProgramCache(), speculative=SPEC_K)
        speculative_launches(st, warm, got, L, "(a) speculative")
        add_counts(total, got)
        spec = {**run_summary(gens, st, warm, wall, None, info=[]),
                "acceptance_rate": st["speculative"]["acceptance_rate"],
                "launches": got}
        spec_exact, spec_gaps = compare_tokens(
            torch, pd, cfg, prompts, [g.tokens for g in gens],
            toks["captured"], "(a) speculative vs plain")
        dense = p17_dense(torch, pd, cfg, fns, total)
        moe_check = p17_moe_check(torch, params, cfg, MAX_ACTIVE)
        drops = p17_bucket_drops(torch, params, cfg, reqs)
        prof = p17_decode_profile(torch, pd, cfg, reqs, n_pmax)
        lens = [min(len(p) + m - 1, n_pmax * PAGE_SIZE - SPEC_K - 1)
                for p, m in reqs]
        kernels = p16_position_kernels(torch, lens, n_pmax, cfg.n_heads,
                                       cfg.hd)
        share = p17_expert_share(torch, params, cfg, MAX_ACTIVE,
                                 prof["device_busy_ms"])
        del params
    gc.collect()
    torch.cuda.empty_cache()
    share["program_cost_flops"] = (prof["program_cost"] or {}).get("flops")
    row = {"phase": 17, "part": "a", "config": cut,
           "params_per_particle": p17_param_count(cfg),
           "particles": P17_DS_P, "runs": runs,
           "captured_vs_eager_requests_token_equal": exact,
           "captured_vs_eager_tie_gaps": gaps, "speculative": spec,
           "speculative_vs_plain_requests_token_equal": spec_exact,
           "speculative_tie_gaps": spec_gaps, "dense": dense,
           "decode_moe_vs_moe_ref": moe_check, "prefill_bucket_drops": drops,
           "decode_step_profile": prof, "expert_products": share,
           "kernels_at_shape": kernels, "tok_per_s": runs["captured"][
               "tok_per_s"], "launches": total,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
           "part_s": time.perf_counter() - t0, "card": card}
    emit(row)
    return total, kernels


def p17_dense(torch, pd, cfg, fns, total):
    """(a) the dense-cache engine (captured) over phase 7's prompts against
    serve_decode's tokens on the same prompts (near-tie rule)."""
    from repro_torch.models import api
    from repro_torch.runtime import ProgramCache
    from repro_torch.serve import PredictiveEngine
    L = cfg.n_layers
    params = pd.store.stacked("params")
    rng = np.random.default_rng(2)
    prompts = rng.integers(1, cfg.vocab_size, (DENSE_PROMPTS, DENSE_LEN))
    C = DENSE_LEN + DENSE_NEW + 1
    paged = serve_requests(torch, pd, cfg,
                           [(list(p), DENSE_NEW) for p in prompts], fns,
                           ProgramCache())
    add_counts(total, paged[2])
    cache = ProgramCache()
    engine = PredictiveEngine(
        lambda p, c, b: api.decode_step(p, b["token"], c, b["cur_pos"], cfg),
        store=pd.store, stateful=True, cache=cache)
    toks = torch.as_tensor(prompts, dtype=torch.int32, device="cuda")
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    state = engine.init_state(lambda p: api.prefill(
        p, {"tokens": toks[:, :-1]}, cfg, max_len=C)[1])
    tok, dense = toks[:, -1], []
    for step in range(DENSE_NEW):
        heads, state = engine.step(state, {"token": tok,
                                           "cur_pos": DENSE_LEN - 1 + step})
        tok = heads["mean"].argmax(-1).to(torch.int32)
        dense.append(tok)
    dense = torch.stack(dense, 1).cpu().numpy().tolist()
    wall = time.perf_counter() - t0
    got = read_counts(fns)
    want = {"paged_decode_attention": 0, "paged_decode_window_attention": 0,
            "flash_attention": L, "decode_attention": L * DENSE_NEW}
    if got != want:
        raise AssertionError(f"(a) dense launches {got}, want {want}")
    add_counts(total, got)
    st = cache.snapshot_stats()
    if st["cold_compiles"] != 1:
        raise AssertionError(f"(a) dense step programs {st}")
    # the batched dense prefill routes all prompts' tokens together (one
    # capacity per particle), the paged one prompt at a time: they agree
    # while neither drops an assignment, and its drops are printed
    try:
        exact, gaps = compare_tokens(torch, pd, cfg, prompts, dense,
                                     [g.tokens for g in paged[0]],
                                     "(a) dense vs paged")
    except AssertionError as e:
        drops = p17_prefill_drops(torch, params, cfg, toks[:, :-1])
        raise AssertionError(f"{e}; dense prefill dropped {drops}")
    del state, engine, cache
    torch.cuda.empty_cache()
    return {"tok_per_s": DENSE_PROMPTS * DENSE_NEW / wall,
            "requests_token_equal_to_serve_decode": exact, "tie_gaps": gaps,
            "prefill_dropped_frac": p17_prefill_drops(torch, params, cfg,
                                                      toks[:, :-1]),
            "launches": got}


def p17_train_run(torch, cls, module, batches, cache, **kw):
    """``cls`` over P17_DS_P fresh particles (seed SEED) with ``cache``: a
    step a call, every step's losses kept. Returns (algorithm, row)."""
    torch.cuda.reset_peak_memory_stats()
    algo = cls(module, seed=SEED, backend="compiled")
    algo.push_dist.runtime.cache = cache
    fns = reset_counts()
    losses, t0 = [], time.perf_counter()
    pids, ls = algo.bayes_infer([batches[0]], 1, num_particles=P17_DS_P,
                                **kw)
    losses.append(ls)
    for b in batches[1:]:
        losses.append(algo._fused_epochs(pids, [b], 1, **kw))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not np.isfinite(losses).all():
        raise AssertionError(f"{cls.__name__} losses {losses}")
    return algo, {"losses": losses, "launches": read_counts(fns),
                  "wall_s": wall, "stats": cache.snapshot_stats(),
                  "programs": cache.program_costs(),
                  "peak_gb": torch.cuda.max_memory_allocated() / 2**30}


def p17_training(torch, card):
    """(b) deepseek-moe-16b training: DeepEnsemble (Adam) captured vs eager
    bit for bit over 4 steps; SteinVGD (median) with #1 and #2 held against
    their plain versions at (2, D)."""
    from repro_torch import configs
    return zoo_training(torch, card, *p17_cut(
        configs.get("deepseek-moe-16b"), n_units=P17_TRAIN_UNITS),
        P17_SVGD_STEPS, 17, "b")[0]


def zoo_training(torch, card, cfg, cut, svgd_steps, phase, part,
                 seq_len=P17_TRAIN_S):
    """Fused training of ``cfg`` (cut in depth as ``cut`` says) over
    P17_DS_P particles, one ``seq_len``-token sequence a step (with its
    frames or patches, for the audio and vlm families): DeepEnsemble (Adam)
    captured vs eager bit for bit over P17_TRAIN_STEPS steps; SteinVGD
    (median) over ``svgd_steps`` steps (none when 0), #1 and #2 launched
    once a step and held against their plain versions at (2, D); the
    captured DeepEnsemble step profiled after its run. Emits the row and
    returns (the SteinVGD run's launches, the kernels' checks)."""
    from repro_torch.bdl import DeepEnsemble, SteinVGD
    from repro_torch.bdl.svgd import rbf_glue, svgd_force
    from repro_torch.core import ParticleModule
    from repro_torch.core.functional import (ensemble_value_and_grad,
                                             flatten_stacked)
    from repro_torch.data import DataLoader
    from repro_torch.kernels import ref, svgd_rbf
    from repro_torch.models import api
    from repro_torch.optim import adam
    from repro_torch.runtime import ProgramCache, specs
    what = f"({part})"
    module = ParticleModule(init=lambda g: api.init_params(g, cfg),
                            loss=lambda p, b: api.loss_fn(p, b, cfg), cfg=cfg)
    batches = list(DataLoader(cfg, batch_size=1, seq_len=seq_len,
                              num_batches=P17_TRAIN_STEPS, seed=SEED))
    t0 = time.perf_counter()
    runs = {}
    for mode, cache in caches():
        opt = adam(1e-4)
        algo, row = p17_train_run(torch, DeepEnsemble, module, batches,
                                  cache, optimizer=opt)
        if mode == "captured":
            info = row["programs"]
            if not (len(info) == 1 and info[0]["graph"]
                    and row["stats"]["cold_compiles"] == 1):
                raise AssertionError(f"{what} captured programs {info}")
            params = algo.store.stacked("params")
            b0 = algo._batch(batches[0])
            with torch.no_grad():
                _, metrics = api.loss_fn(params, b0, cfg)
            row["aux_per_particle"] = {k: v.tolist()
                                       for k, v in metrics.items()}
            del params, b0
        if mode == "captured":
            final = kept_tree(torch, algo.store.stacked("params"),
                              row["peak_gb"])
        else:
            same = tree_equal(torch, algo.store.stacked("params"), final)
        if mode == "captured":
            # after the parity's snapshot: the window's steps advance it
            row["step_profile"] = lm_window(
                torch, algo, specs.ensemble_step(module.loss, opt,
                                                 precision=algo.precision),
                ("params", "opt_state"), batches[0], n=2)
        runs[mode] = row
        algo.cleanup()
        del algo, cache
        lm_free(torch)
    if runs["captured"]["losses"] != runs["eager"]["losses"] or not same:
        raise AssertionError(f"{what} captured and eager DeepEnsemble differ")
    del final
    t1 = time.perf_counter()
    if not svgd_steps:
        return {}, zoo_training_row(card, cfg, cut, phase, part, seq_len,
                                    runs, None, None, {}, t0, t1)[1]
    kw = {"lr": 1e-3, "lengthscale": 0.0}
    algo, svgd = p17_train_run(torch, SteinVGD, module,
                               batches[:svgd_steps], ProgramCache(), **kw)
    want = {"pairwise_sqdist": svgd_steps, "svgd_force": svgd_steps}
    got = {k: svgd["launches"][k] for k in want}
    if got != want or sum(svgd["launches"].values()) != svgd_steps * 2:
        raise AssertionError(f"{what} SteinVGD launches {svgd['launches']}")
    launches = dict(svgd["launches"])
    algo.push_dist.runtime.cache.clear()
    gc.collect()
    torch.cuda.empty_cache()
    params = algo.store.stacked("params")
    grads = ensemble_value_and_grad(module.loss)(
        params, algo._batch(batches[0]))[1]
    theta = flatten_stacked(params)[0]
    g = flatten_stacked(grads)[0]
    del grads, params
    n, D = theta.shape
    sq = sqdist_exact(torch, svgd_rbf, theta, None, f"{what} sqdist")
    # the plain version's fp32 Gram form sums 1.09e9 products an entry:
    # both sqdists are held to the plain version in fp64, and the force
    # kernel, alone and as SteinVGD runs it (kernel sqdist, glue, kernel
    # force), to the plain force on the glue of that fp64 sqdist
    exact = ref.pairwise_sqdist(theta.double()).float()
    plain = ref.pairwise_sqdist(theta)
    glue = rbf_glue(exact, 0.0)
    top = exact.abs().max()
    checks = {"shape": [n, D], "sqdist_path": svgd_rbf.plan_for(theta).path,
              "sqdist_rel": float((sq - exact).abs().max() / top),
              "plain_fp32_sqdist_rel": float((plain - exact).abs().max()
                                             / top)}
    del plain
    torch.cuda.empty_cache()
    want = ref.svgd_force(theta, g, *glue)
    checks["force_rel"] = rel_err(svgd_rbf.svgd_force(theta, g, *glue), want)
    checks["svgd_force_end_to_end_rel"] = rel_err(svgd_force(theta, g, 0.0),
                                                  want)
    del want
    torch.cuda.empty_cache()
    if D != p17_param_count(cfg) or not (
            checks["sqdist_rel"] < 1e-5 and checks["force_rel"] < 2e-4
            and checks["svgd_force_end_to_end_rel"] < 2e-4):
        raise AssertionError(f"{what} SVGD kernels vs plain: {checks}")
    # the column kernel's bits where a second (n, D) output fits beside it
    checks["force_equals_columns"] = force_equals_columns(torch, theta, g, glue)
    if checks["force_equals_columns"] is False:
        raise AssertionError(f"{what} force: not the column kernel's bits: "
                             f"{checks}")
    b_ms, b_by = bound(n * D * 4 + n * n * 4, 3 * n * n * D)
    checks["pairwise_sqdist"] = {
        "ms": time_ms(torch, lambda: svgd_rbf.pairwise_sqdist(theta),
                      iters=5),
        "plain_ms": time_ms(torch, lambda: ref.pairwise_sqdist(theta),
                            iters=3),
        "bound_ms": b_ms, "bound_by": b_by}
    fr = force_row(torch, theta, g, glue, iters=5)
    checks["svgd_force"] = {**{k: fr[k] for k in ("ms", "plain_ms",
                                                  "bound_ms", "bound_by")},
                            "vs_columns": fr["vs_columns"]}
    del theta, g, sq, glue, fr
    algo.cleanup()
    del algo
    lm_free(torch)
    return zoo_training_row(card, cfg, cut, phase, part, seq_len, runs,
                            svgd, checks, launches, t0, t1)


def zoo_training_row(card, cfg, cut, phase, part, seq_len, runs, svgd,
                     checks, launches, t0, t1):
    """Emit ``zoo_training``'s row; returns (launches, checks)."""
    tokens = P17_DS_P * seq_len
    cap = runs["captured"]
    row = {"phase": phase, "part": part, "config": cut,
           "params_per_particle": p17_param_count(cfg),
           "particles": P17_DS_P, "seq_len": seq_len,
           "ensemble": runs, "captured_equals_eager_bit_for_bit": True,
           "ensemble_tokens_per_s": tokens * P17_TRAIN_STEPS / cap["wall_s"],
           "svgd": svgd, "svgd_kernels_vs_plain": checks,
           "launches": launches, "part_s": {"ensemble": t1 - t0,
                                            "svgd": time.perf_counter() - t1},
           "card": card}
    emit(row)
    return launches, checks


def p17_qwen3(torch, card):
    """(c) qwen3-moe-235b-a22b, 1 particle: plain paged serving of phase
    2's requests on one device and on a 1 x 4 model mesh of the card's
    positions (experts, heads and vocab split 4 ways); #8 at the verify
    shape."""
    from repro_torch import configs
    from repro_torch.core import ParticleModule, PushDistribution
    from repro_torch.kernels import paged_decode_window_attention as wk
    from repro_torch.kernels import ref, split_walk
    from repro_torch.models import api
    from repro_torch.runtime import ProgramCache
    cfg, cut = p17_cut(configs.get("qwen3-moe-235b-a22b"),
                       n_units=P17_QW_UNITS)
    L = cfg.n_layers
    reqs = traffic(cfg.vocab_size)
    module = ParticleModule(init=lambda g: api.init_params(g, cfg), cfg=cfg)
    fns = attention_counts()
    total, runs = {}, {}
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    for tag, pl in (("one", None), ("model4", p16_placement(torch, 4, 4))):
        with PushDistribution(module, seed=SEED, capacity=1,
                              placement=pl) as pd:
            pd.p_create()
            pd.store.stacked("params")
            nbytes = pd.stats()["placement"]["per_device_param_bytes"]
            gens, st, got, wall, _, _ = serve_requests(
                torch, pd, cfg, reqs, fns, ProgramCache(), placement=pl)
            # each model position launches its own kernels
            m = 1 if pl is None else 4
            plain_launches(st, {k: v // m for k, v in got.items()}, L,
                           f"(c) {tag}")
            if any(v % m for v in got.values()):
                raise AssertionError(f"(c) {tag} launches {got}")
            add_counts(total, got)
            n_tok = sum(len(g.tokens) for g in gens)
            runs[tag] = {"per_device_param_bytes": nbytes,
                         "tokens": [g.tokens for g in gens],
                         "generated_tokens": n_tok, "wall_s": wall,
                         "tok_per_s": n_tok / wall, "steps": st["steps"],
                         "launches": got}
            if tag == "model4":
                exact, gaps = p16_tokens(torch, pd, cfg,
                                         [p for p, _ in reqs],
                                         runs[tag]["tokens"],
                                         runs["one"]["tokens"],
                                         "(c) 1 x 4 vs one device")
        gc.collect()
        torch.cuda.empty_cache()
    ratio = (runs["model4"]["per_device_param_bytes"]
             / runs["one"]["per_device_param_bytes"])
    if not ratio <= 0.3:
        raise AssertionError(f"(c) 1 x 4 footprint ratio {ratio}")
    # #8 at the verify shape of one particle: W 5, 64 heads over 4 kv heads
    P, B, W, H, KVH, hd = 1, MAX_ACTIVE, SPEC_K + 1, cfg.n_heads, \
        cfg.n_kv_heads, cfg.hd
    n_pmax = NUM_PAGES // MAX_ACTIVE
    wlens = [min(len(p) + m - W, n_pmax * PAGE_SIZE - W)
             for p, m in traffic(cfg.vocab_size)]
    args = window_case(torch, 173, P, B, W, H, KVH, hd, PAGE_SIZE, n_pmax,
                       NUM_PAGES + 1, wlens, torch.float32)
    fn, plain = wk.paged_decode_window_attention, \
        ref.paged_decode_window_attention
    err = check_kernel(torch, fn, plain, args, wlens, 1e-4,
                       "(c) #8 at qwen3-moe's verify shape")
    plan = split_walk.launch_plan(n_pmax, PAGE_SIZE, W, H // KVH, KVH, P, B,
                                  hd, 4, split_walk.sm_count(args[0].device))
    pairs = sum(W * Ln + W * (W + 1) // 2 for Ln in wlens)
    b_ms, b_by = bound(P * sum(Ln + W for Ln in wlens) * KVH * hd * 2 * 4
                       + 2 * args[0].numel() * 4, 4 * P * pairs * H * hd)
    verify = {"max_abs_err": err, "ms": time_ms(torch, lambda: fn(*args)),
              "device_ms": device_ms(torch, lambda: fn(*args)),
              "plain_ms": time_ms(torch, lambda: plain(*args), iters=10),
              "bound_ms": b_ms, "bound_by": b_by,
              "plan": {"split_plan": list(plan[0]),
                       "kv_heads_a_block": plan[1], "row_blocks": plan[2]},
              "shape": {"P": P, "B": B, "W": W, "H": H, "KVH": KVH, "hd": hd}}
    if plan[2] < 2:
        raise AssertionError(f"(c) the verify rows did not split: {plan}")
    del args
    torch.cuda.empty_cache()
    row = {"phase": 17, "part": "c", "config": cut,
           "params_per_particle": p17_param_count(cfg), "particles": 1,
           "runs": runs, "ratio": ratio, "token_equal": exact,
           "tie_gaps": gaps, "verify_kernel": verify, "launches": total,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
           "part_s": time.perf_counter() - t0, "card": card}
    emit(row)
    return total, verify


def p17_gemma(torch, card):
    """(d) gemma3-4b dense-cache serving over prompts past the 1,024-token
    window: captured vs eager, the ring's layout, #5 at hd 256 and #6 on a
    ring and a global cache."""
    from repro_torch import configs
    from repro_torch.core import ParticleModule, PushDistribution
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ref
    from repro_torch.models import api
    from repro_torch.serve import PredictiveEngine
    cfg, cut = p17_cut(configs.get("gemma3-4b"), n_units=1)
    L, W = cfg.n_layers, cfg.sliding_window
    module = ParticleModule(init=lambda g: api.init_params(g, cfg), cfg=cfg)
    fns = attention_counts()
    rng = np.random.default_rng(17)
    prompts = rng.integers(1, cfg.vocab_size, (P17_GM_B, P17_GM_LEN))
    C = P17_GM_LEN + P17_GM_NEW
    toks = torch.as_tensor(prompts, dtype=torch.int32, device="cuda")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    runs, tokens, launches, total = {}, {}, {}, {}
    with PushDistribution(module, seed=SEED) as pd:
        for _ in range(P17_GM_P):
            pd.p_create()
        params = pd.store.stacked("params")
        for mode, cache in caches():
            engine = PredictiveEngine(
                lambda p, c, b: api.decode_step(p, b["token"], c,
                                                b["cur_pos"], cfg),
                store=pd.store, stateful=True, cache=cache)
            for fn in fns.values():
                fn.launches = 0
            t1 = time.perf_counter()
            state = engine.init_state(lambda p: api.prefill(
                p, {"tokens": toks[:, :-1]}, cfg, max_len=C)[1])
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t1
            tok, out = toks[:, -1], []
            t2 = time.perf_counter()
            for step in range(P17_GM_NEW):
                heads, state = engine.step(state, {
                    "token": tok, "cur_pos": P17_GM_LEN - 1 + step})
                tok = heads["mean"].argmax(-1).to(torch.int32)
                out.append(tok)
            tokens[mode] = torch.stack(out, 1).cpu().numpy().tolist()
            decode_s = time.perf_counter() - t2
            got = launches[mode] = read_counts(fns)
            want = {"paged_decode_attention": 0,
                    "paged_decode_window_attention": 0,
                    "flash_attention": 1, "decode_attention": L * P17_GM_NEW}
            if got != want:
                raise AssertionError(f"(d) {mode} launches {got}, want {want}")
            add_counts(total, got) if mode == "captured" else None
            st = cache.snapshot_stats()
            if st["cold_compiles"] != 1:
                raise AssertionError(f"(d) {mode} step programs {st}")
            runs[mode] = {"prefill_s": prefill_s,
                          "decode_tok_per_s": P17_GM_B * P17_GM_NEW / decode_s,
                          "ms_per_step_wall": decode_s / P17_GM_NEW * 1e3}
            if mode == "captured":
                last = tok
                runs[mode]["step_profile"] = profile_steps(
                    torch, lambda: engine.step(state, {
                        "token": last, "cur_pos": C - 1}), n=3, fns=fns,
                    prologue=32, epilogue=32)
                ring = state["units"][0]
                pos = ring["pos"][0]
                slot = torch.arange(pos.shape[-1], device="cuda")
                if pos.shape[-1] != W or not bool(((pos >= 0)
                                                   & (pos % W == slot)).all()):
                    raise AssertionError("(d) a ring slot s holds a position "
                                         "p with p % 1024 != s")
                gen = torch.Generator(device="cuda").manual_seed(174)
                q = torch.randn((P17_GM_P, P17_GM_B, cfg.n_heads, cfg.hd),
                                generator=gen, device="cuda")
                caches6 = {"ring": state["units"][0],
                           "global": state["units"][cfg.pattern.index(
                               "attn_mlp")]}
                dec = {}
                for name, c in caches6.items():
                    a = (q, c["k"][:, 0], c["v"][:, 0], c["pos"][0])
                    valid = int((a[3] >= 0).sum())
                    b_ms, b_by = bound(
                        P17_GM_P * valid * cfg.n_kv_heads * cfg.hd * 2 * 4
                        + 2 * q.numel() * 4,
                        4 * P17_GM_P * valid * cfg.n_heads * cfg.hd)
                    dec[name] = {
                        "max_abs_err": max_err(torch, dk.decode_attention(*a),
                                               ref.decode_attention(*a),
                                               f"(d) #6 on the {name} cache",
                                               2e-5),
                        "C": int(a[1].shape[2]), "valid": valid,
                        "ms": time_ms(torch, lambda: dk.decode_attention(*a)),
                        "plain_ms": time_ms(
                            torch, lambda: ref.decode_attention(*a),
                            iters=10),
                        "bound_ms": b_ms, "bound_by": b_by}
                del q
            del state, engine, cache
            torch.cuda.empty_cache()
        exact, gaps = compare_tokens(
            torch, pd, cfg, prompts, tokens["captured"], tokens["eager"],
            "(d) captured vs eager")
        same_launches(launches, "phase 17 (d)")
        # #5 at the global layer's prefill shape: hd 256, 8 heads over 4
        gen = torch.Generator(device="cuda").manual_seed(175)
        S = P17_GM_LEN - 1
        qkv = [torch.randn((P17_GM_P, P17_GM_B, S, h, cfg.hd), generator=gen,
                           device="cuda")
               for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads)]
        err = max_err(torch, fk.flash_attention(*qkv),
                      ref.flash_attention(*qkv), "(d) #5 at hd 256", 2e-5)
        # each fp32 product as three TF32 products (phase 5's bound)
        b_ms, b_by = bound(4 * (2 * qkv[0].numel() + 2 * qkv[1].numel()),
                           3 * 4 * P17_GM_P * P17_GM_B * cfg.n_heads * cfg.hd
                           * S * (S + 1) // 2, rate=TF32_FLOPS_PER_S)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        qs, ks, vs = (t.reshape(-1, *t.shape[2:]).transpose(1, 2)
                      .repeat_interleave(cfg.n_heads // t.shape[3], 1)
                      for t in qkv)
        flash = {"max_abs_err": err,
                 "ms": time_ms(torch, lambda: fk.flash_attention(*qkv)),
                 "device_ms": device_ms(torch,
                                        lambda: fk.flash_attention(*qkv)),
                 "plain_ms": time_ms(torch, lambda: ref.flash_attention(*qkv),
                                     iters=5),
                 "library_ms": time_ms(torch, lambda: sdpa(qs, ks, vs,
                                                           is_causal=True)),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "shape": {"P": P17_GM_P, "B": P17_GM_B, "S": S,
                           "H": cfg.n_heads, "KVH": cfg.n_kv_heads,
                           "hd": cfg.hd}}
        del qkv, qs, ks, vs, params
    gc.collect()
    torch.cuda.empty_cache()
    row = {"phase": 17, "part": "d", "config": cut,
           "params_per_particle": p17_param_count(cfg),
           "particles": P17_GM_P, "prompts": P17_GM_B,
           "prompt_len": P17_GM_LEN, "new_tokens": P17_GM_NEW,
           "window": W, "runs": runs,
           "captured_vs_eager_requests_token_equal": exact,
           "tie_gaps": gaps, "decode_kernel": dec, "flash_kernel": flash,
           "launches": total,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
           "part_s": time.perf_counter() - t0, "card": card}
    emit(row)
    return total, flash


def phase17(torch, card):
    """The decoder-only model zoo: deepseek-moe-16b serving (a) and
    training (b), qwen3-moe-235b-a22b on one device and a 1 x 4 model
    mesh (c), gemma3-4b's ring caches (d). Returns (the kernels' launches
    over the parts' main-path runs, phase 17's kernel rows)."""
    t0 = time.perf_counter()
    launches, rows = {}, {}
    got, rows["position"] = p17_deepseek_serving(torch, card)
    add_counts(launches, got)
    lm_free(torch)
    t1 = time.perf_counter()
    add_counts(launches, p17_training(torch, card))
    lm_free(torch)
    t2 = time.perf_counter()
    got, rows["verify"] = p17_qwen3(torch, card)
    add_counts(launches, got)
    lm_free(torch)
    t3 = time.perf_counter()
    got, rows["flash_hd256"] = p17_gemma(torch, card)
    add_counts(launches, got)
    lm_free(torch)
    emit({"phase": 17, "part": "summary", "phase_s": time.perf_counter() - t0,
          "part_s": {"a": t1 - t0, "b": t2 - t1, "c": t3 - t2,
                     "d": time.perf_counter() - t3},
          "launches": launches, "card": card})
    return launches, rows


P18_P = 2                        # particles in every part
P18_B, P18_LEN, P18_NEW = 4, 101, 32   # a prefill of 100 = 64 + 36
P18_RWKV_UNITS = 4               # (b): 4 of rwkv6-7b's 32 layers
P18_CONT_TOL = 1e-3              # state continuation, of the largest |logit|


def p18_attention_layers(cfg):
    """The stack's attention layers (each one #5 launch a prefill and one
    #6 launch a decode step on the dense path)."""
    kinds = (list(cfg.head_layers) + list(cfg.pattern) * cfg.n_units
             + list(cfg.tail_layers))
    return sum(k not in ("mamba", "rwkv") for k in kinds)


def p18_decode_row(torch, cfg, cache):
    """#6 at the shared block's cache (its first occurrence's): the kernel
    against its plain version, event and device ms beside the bound and
    SDPA over the filled slots."""
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(184)
    q = torch.randn((P18_P, P18_B, cfg.n_heads, cfg.hd), generator=gen,
                    device="cuda")
    a = (q, cache["k"][:, 0], cache["v"][:, 0], cache["pos"][0])
    valid = int((a[3] >= 0).sum())
    b_ms, b_by = bound(P18_P * valid * cfg.n_kv_heads * cfg.hd * 2 * 4
                       + 2 * q.numel() * 4,
                       4 * P18_P * valid * cfg.n_heads * cfg.hd)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    C = a[1].shape[2]
    qs = q.reshape(-1, cfg.n_heads, 1, cfg.hd)
    ks, vs = (t.reshape(-1, C, cfg.n_kv_heads, cfg.hd).transpose(1, 2)
              for t in a[1:3])
    live = (a[3] >= 0).repeat(P18_P, 1)[:, None, None, :]
    return {"max_abs_err": max_err(torch, dk.decode_attention(*a),
                                   ref.decode_attention(*a),
                                   "(a) #6 on the shared block's cache", 2e-5),
            "shape": {"P": P18_P, "B": P18_B, "C": C, "valid": valid,
                      "H": cfg.n_heads, "KVH": cfg.n_kv_heads,
                      "hd": cfg.hd},
            "ms": time_ms(torch, lambda: dk.decode_attention(*a)),
            "device_ms": device_ms(torch, lambda: dk.decode_attention(*a)),
            "plain_ms": time_ms(torch, lambda: ref.decode_attention(*a),
                                iters=10),
            "library_ms": time_ms(torch, lambda: sdpa(qs, ks, vs,
                                                      attn_mask=live)),
            "bound_ms": b_ms, "bound_by": b_by}


def p18_flash_row(torch, cfg):
    """#5 at the shared block's prefill shape (P18_P x P18_B prompts of
    P18_LEN - 1 tokens, 32 heads of 64 over 32 kv heads) against its plain
    version, with event and device ms, the bound and SDPA."""
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(185)
    S = P18_LEN - 1
    qkv = [torch.randn((P18_P, P18_B, S, h, cfg.hd), generator=gen,
                       device="cuda")
           for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads)]
    err = max_err(torch, fk.flash_attention(*qkv), ref.flash_attention(*qkv),
                  "(a) #5 at zamba2's shape", 2e-5)
    # each fp32 product as three TF32 products (phase 5's bound)
    b_ms, b_by = bound(4 * (2 * qkv[0].numel() + 2 * qkv[1].numel()),
                       3 * 4 * P18_P * P18_B * cfg.n_heads * cfg.hd
                       * S * (S + 1) // 2, rate=TF32_FLOPS_PER_S)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs = (t.reshape(-1, *t.shape[2:]).transpose(1, 2)
                  .repeat_interleave(cfg.n_heads // t.shape[3], 1)
                  for t in qkv)
    return {"max_abs_err": err,
            "ms": time_ms(torch, lambda: fk.flash_attention(*qkv)),
            "device_ms": device_ms(torch, lambda: fk.flash_attention(*qkv)),
            "plain_ms": time_ms(torch, lambda: ref.flash_attention(*qkv),
                                iters=5),
            "library_ms": time_ms(torch, lambda: sdpa(qs, ks, vs,
                                                      is_causal=True)),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": {"P": P18_P, "B": P18_B, "S": S, "H": cfg.n_heads,
                      "KVH": cfg.n_kv_heads, "hd": cfg.hd}}


def p18_serving(torch, card, name, part, **cut_kw):
    """(a) / (b): ``name`` (cut in depth by ``cut_kw``) served from dense
    state through ``PredictiveEngine(stateful=True)``, captured and eager:
    P18_B prompts of P18_LEN tokens (a prefill of P18_LEN - 1, then
    P18_NEW greedy BMA steps). Holds the tokens equal between the runs,
    one cold compile of the captured step, the launches exact (#5 and #6
    once an attention layer a prefill and a step, #7 and #8 never), and
    the state carried on the card: a prefill of the prompt and the first
    P18_NEW - 1 generated tokens gives the last step's logits. Returns
    (the captured run's launches, the kernel rows at this model's
    shapes)."""
    from repro_torch import configs
    from repro_torch.core import ParticleModule, PushDistribution
    from repro_torch.models import api
    from repro_torch.serve import PredictiveEngine
    what = f"({part})"
    cfg, cut = p17_cut(configs.get(name), **cut_kw)
    A = p18_attention_layers(cfg)
    module = ParticleModule(init=lambda g: api.init_params(g, cfg), cfg=cfg)
    fns = attention_counts()
    prompts = np.random.default_rng(18).integers(1, cfg.vocab_size,
                                                 (P18_B, P18_LEN))
    C = P18_LEN + P18_NEW
    toks = torch.as_tensor(prompts, dtype=torch.int32, device="cuda")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    runs, tokens, launches, total, last, kernels = {}, {}, {}, {}, {}, {}

    def forward(p, c, b):
        logits, c = api.decode_step(p, b["token"], c, b["cur_pos"], cfg)
        last["logits"] = logits
        return logits, c

    with PushDistribution(module, seed=SEED) as pd:
        for _ in range(P18_P):
            pd.p_create()
        params = pd.store.stacked("params")
        for mode, cache in caches():
            engine = PredictiveEngine(forward, store=pd.store, stateful=True,
                                      cache=cache)
            for fn in fns.values():
                fn.launches = 0
            t1 = time.perf_counter()
            state = engine.init_state(lambda p: api.prefill(
                p, {"tokens": toks[:, :-1]}, cfg, max_len=C)[1])
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t1
            tok, out = toks[:, -1], []
            t2 = time.perf_counter()
            for step in range(P18_NEW):
                heads, state = engine.step(state, {
                    "token": tok, "cur_pos": P18_LEN - 1 + step})
                tok = heads["mean"].argmax(-1).to(torch.int32)
                out.append(tok)
            tokens[mode] = torch.stack(out, 1).cpu().numpy().tolist()
            decode_s = time.perf_counter() - t2
            got = launches[mode] = read_counts(fns)
            want = {"paged_decode_attention": 0,
                    "paged_decode_window_attention": 0,
                    "flash_attention": A, "decode_attention": A * P18_NEW}
            if got != want:
                raise AssertionError(f"{what} {mode} launches {got}, want "
                                     f"{want}")
            if mode == "captured":
                add_counts(total, got)
            st = cache.snapshot_stats()
            if st["cold_compiles"] != 1:
                raise AssertionError(f"{what} {mode} step programs {st}")
            runs[mode] = {"prefill_s": prefill_s,
                          "decode_tok_per_s": P18_B * P18_NEW / decode_s,
                          "ms_per_step_wall": decode_s / P18_NEW * 1e3,
                          "graph_pool_gb": [
                              (c.get("pool_bytes") or 0) / 2**30
                              for c in cache.program_costs()]}
            if mode == "eager":
                step32 = last.pop("logits").clone()
            else:
                if A:
                    kernels["decode_attention"] = p18_decode_row(
                        torch, cfg, state["units"][
                            cfg.pattern.index("shared_attn")])
                after = tok
                prof = runs[mode]["step_profile"] = profile_steps(
                    torch, lambda: engine.step(state, {
                        "token": after, "cur_pos": C - 1}), n=3, fns=fns,
                    prologue=32, epilogue=32)
                if "wall_ms" in prof:
                    runs[mode]["steady_tok_per_s"] = \
                        P18_B / prof["wall_ms"] * 1e3
            last.clear()
            del state, engine, cache
            torch.cuda.empty_cache()
        exact, gaps = compare_tokens(
            torch, pd, cfg, prompts, tokens["captured"], tokens["eager"],
            f"{what} captured vs eager")
        same_launches(launches, f"phase 18 {what}")
        # the state carried over: the eager run's last step consumed the
        # 31st generated token; a prefill of everything before it and it
        # gives the same next-token logits
        seq = torch.cat([toks, torch.as_tensor(
            tokens["eager"], dtype=torch.int32,
            device="cuda")[:, :P18_NEW - 1]], 1)
        with torch.no_grad():
            cont, _ = api.prefill(params, {"tokens": seq}, cfg)
        top = float(step32.abs().max())
        cont_err = float((cont - step32).abs().max()) / top
        if not cont_err < P18_CONT_TOL:
            raise AssertionError(f"{what} prefill of {seq.shape[1]} tokens "
                                 f"vs step {P18_NEW}: {cont_err} of the "
                                 f"largest |logit|")
        if A:
            kernels["flash_attention"] = p18_flash_row(torch, cfg)
        del params, cont, step32
    gc.collect()
    torch.cuda.empty_cache()
    row = {"phase": 18, "part": part, "config": cut,
           "params_per_particle": p17_param_count(cfg),
           "particles": P18_P, "prompts": P18_B, "prompt_len": P18_LEN,
           "new_tokens": P18_NEW, "attention_layers": A, "runs": runs,
           "captured_vs_eager_requests_token_equal": exact,
           "tie_gaps": gaps, "continuation_rel_err": cont_err,
           "kernels": kernels, "launches": total,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
           "part_s": time.perf_counter() - t0, "card": card}
    emit(row)
    return total, kernels


def phase18(torch, card):
    """The recurrent families: zamba2-1.2b (Mamba2 with its shared
    attention) at full depth (a) and rwkv6-7b at 4 of its 32 layers (b)
    served from dense state, captured and eager; both trained fused,
    depth cut (c). Returns (the kernels' launches over the parts'
    main-path runs, phase 18's kernel rows)."""
    from repro_torch import configs
    t0 = time.perf_counter()
    launches, rows = {}, {}
    got, rows["zamba2"] = p18_serving(torch, card, "zamba2-1.2b", "a")
    add_counts(launches, got)
    lm_free(torch)
    t1 = time.perf_counter()
    got, _ = p18_serving(torch, card, "rwkv6-7b", "b",
                         n_units=P18_RWKV_UNITS)
    add_counts(launches, got)
    lm_free(torch)
    t2 = time.perf_counter()
    train = {}
    for name, units in (("zamba2-1.2b", 1), ("rwkv6-7b", 1)):
        got, train[name] = zoo_training(
            torch, card, *p17_cut(configs.get(name), n_units=units),
            P17_TRAIN_STEPS, 18, f"c {name}")
        add_counts(launches, got)
        lm_free(torch)
    rows["training"] = train
    emit({"phase": 18, "part": "summary",
          "phase_s": time.perf_counter() - t0,
          "part_s": {"a": t1 - t0, "b": t2 - t1,
                     "c": time.perf_counter() - t2},
          "launches": launches, "card": card})
    return launches, rows


P19_P = 2                        # particles in every part
P19_B, P19_LEN, P19_NEW = 4, 24, 32   # prompts of 24 tokens, 32 greedy steps
P19_WH_TRAIN = {"n_units": 2, "n_encoder_layers": 2}   # (c): 2 + 2 layers
P19_PG_TRAIN = {"n_units": 1}    # (c): 1 of paligemma's 18 layers
P19_TRAIN_S = 256                # (c): one lm_batch sequence a step
P19_PROB_TOL = 1e-4              # (a): kernels vs plain, BMA probabilities
P19_LOGIT_TOL = 1e-3             # member logits and the continuation


class plain_kernels:
    """Route ``kernels.ops``' attention dispatches to their plain versions
    on the card for one comparison (the port itself never does): a model
    step run inside is the same step through the plain #5 / #6."""

    def __enter__(self):
        from repro_torch.kernels import ops, ref
        self.saved = {n: getattr(ops, n) for n in ("flash_attention",
                                                   "decode_attention")}
        ops.flash_attention = ref.flash_attention
        ops.decode_attention = ref.decode_attention
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        for n, fn in self.saved.items():
            setattr(ops, n, fn)


def p19_layers(cfg):
    """(#5 launches a prefill, #6 launches a decode step): whisper's
    encoder layers and decoder self-attentions take #5, its decoder's
    self and cross attentions #6; paligemma's layers one of each."""
    if cfg.family == "audio":
        return cfg.n_encoder_layers + cfg.n_units, 2 * cfg.n_units
    return cfg.n_units, cfg.n_units


def p19_front(torch, cfg, B):
    """The batch's stub frontend on the card: whisper's frames (B, 1,500,
    1,024) or paligemma's patches (B, 256, 2,048), from seed 19."""
    from repro_torch.data import frontend_stub
    key, L = (("frames", cfg.n_frames) if cfg.family == "audio"
              else ("patches", cfg.n_prefix_tokens))
    a = frontend_stub(np.random.default_rng(19), B, L, cfg.d_model)
    return {key: torch.as_tensor(a, device="cuda")}


def p19_rows(torch, cfg, state, front):
    """The kernels at this model's shapes, each against its plain version,
    with event and device ms, the bound and one SDPA call: whisper: #5 at
    its encoder (bidirectional, S 1,500, MHA 16 x 64) and #6 over the
    first decoder layer's 1,500 cross slots; paligemma: #5 at its prefill
    under the prefix mask (S 256 + text, 8 heads over 1 of 256) and #6
    over the first layer's cache (G 8, hd 256)."""
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import visible_pairs
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(190)
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    audio = cfg.family == "audio"
    S = cfg.n_frames if audio else cfg.n_prefix_tokens + P19_LEN - 1
    prefix = 0 if audio else cfg.n_prefix_tokens
    qkv = [torch.randn((P19_P, P19_B, S, h, hd), generator=gen,
                       device="cuda") for h in (H, KVH, KVH)]
    kw = {"causal": not audio, "prefix_len": prefix}
    what = "(d) #5 at " + ("whisper's encoder" if audio else
                           "paligemma's prefix prefill")
    err = max_err(torch, fk.flash_attention(*qkv, **kw),
                  ref.flash_attention(*qkv, **kw), what, 2e-5)
    pairs = visible_pairs(S, not audio, prefix)
    b_ms, b_by = bound(4 * (2 * qkv[0].numel() + 2 * qkv[1].numel()),
                       3 * 4 * P19_P * P19_B * H * hd * pairs,
                       rate=TF32_FLOPS_PER_S)
    qs, ks, vs = (t.reshape(-1, *t.shape[2:]).transpose(1, 2)
                  .repeat_interleave(H // t.shape[3], 1) for t in qkv)
    mask = None
    if not audio:
        mask = torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
        mask[:, :prefix] = True
    rows = {"flash_attention": {
        "max_abs_err": err, "tol": 2e-5,
        "ms": time_ms(torch, lambda: fk.flash_attention(*qkv, **kw)),
        "device_ms": device_ms(torch, lambda: fk.flash_attention(*qkv, **kw)),
        "plain_ms": time_ms(torch, lambda: ref.flash_attention(*qkv, **kw),
                            iters=5),
        "library_ms": time_ms(torch, lambda: sdpa(qs, ks, vs,
                                                  attn_mask=mask)),
        "bound_ms": b_ms, "bound_by": b_by,
        "shape": {"P": P19_P, "B": P19_B, "S": S, "H": H, "KVH": KVH,
                  "hd": hd, "causal": not audio, "prefix_len": prefix,
                  "visible_pairs": pairs}}}
    del qkv, qs, ks, vs
    u0 = state["units"][0]
    if audio:
        C = u0["xk"].shape[3]
        a = (None, u0["xk"][:, 0], u0["xv"][:, 0],
             torch.arange(C, dtype=torch.int32, device="cuda").repeat(
                 P19_B, 1))
        what = "(d) #6 over whisper's 1,500 cross slots"
    else:
        a = (None, u0["k"][:, 0], u0["v"][:, 0], u0["pos"][0])
        what = "(d) #6 over paligemma's cache (G 8, hd 256)"
    q = torch.randn((P19_P, P19_B, H, hd), generator=gen, device="cuda")
    a = (q,) + a[1:]
    C = a[1].shape[2]
    valid = int((a[3] >= 0).sum())
    b_ms, b_by = bound(P19_P * valid * KVH * hd * 2 * 4 + 2 * q.numel() * 4,
                       4 * P19_P * valid * H * hd)
    qs = q.reshape(-1, H, 1, hd)
    ks, vs = (t.reshape(-1, C, KVH, hd).transpose(1, 2)
              .repeat_interleave(H // KVH, 1) for t in a[1:3])
    live = (a[3] >= 0).repeat(P19_P, 1)[:, None, None, :]
    rows["decode_attention"] = {
        "max_abs_err": max_err(torch, dk.decode_attention(*a),
                               ref.decode_attention(*a), what, 2e-5),
        "tol": 2e-5,
        "shape": {"P": P19_P, "B": P19_B, "C": C, "valid": valid, "H": H,
                  "KVH": KVH, "hd": hd,
                  "cache": "cross" if audio else "self"},
        "ms": time_ms(torch, lambda: dk.decode_attention(*a)),
        "device_ms": device_ms(torch, lambda: dk.decode_attention(*a)),
        "plain_ms": time_ms(torch, lambda: ref.decode_attention(*a),
                            iters=10),
        "library_ms": time_ms(torch, lambda: sdpa(qs, ks, vs,
                                                  attn_mask=live)),
        "bound_ms": b_ms, "bound_by": b_by}
    return rows


def p19_kernels_vs_plain(torch, params, cfg, batch, tok, C):
    """One decode step on freshly prefilled rows, through the kernels and
    through their plain versions (``plain_kernels``): the BMA mean
    probabilities within P19_PROB_TOL of the largest, the member logits
    within P19_LOGIT_TOL of the largest |logit|. Stands in for the
    continuation check on whisper, whose reference ropes the
    cross-attention query in the prefill and not in decode."""
    from repro_torch.models import api
    out = {}
    for name, ctx in (("kernels", None), ("plain", plain_kernels())):
        with torch.no_grad(), (ctx or contextlib.nullcontext()):
            _, caches = api.prefill(params, batch, cfg, max_len=C)
            logits, _ = api.decode_step(params, tok, caches,
                                        C - P19_NEW - 1, cfg)
        out[name] = logits.float()
        del caches
    k, p = out["kernels"], out["plain"]
    top = float(p.abs().max())
    pk, pp = k.softmax(-1).mean(0), p.softmax(-1).mean(0)
    gaps = {"member_logits_rel": float((k - p).abs().max()) / top,
            "bma_prob_rel": float((pk - pp).abs().max() / pp.max())}
    if not (gaps["member_logits_rel"] < P19_LOGIT_TOL
            and gaps["bma_prob_rel"] < P19_PROB_TOL):
        raise AssertionError(f"(a) a step through the kernels vs the plain "
                             f"versions: {gaps}")
    return gaps


def p19_serving(torch, card, name, part):
    """``name`` at full width and depth, P19_P particles of random fp32
    weights: P19_B prompts of P19_LEN tokens with their stub frames or
    patches prefilled into dense caches, then P19_NEW greedy BMA steps
    through ``PredictiveEngine(stateful=True)``, captured and eager: the
    tokens equal, one cold compile of the captured step, the launches
    exact (``p19_layers``; #7 and #8 never). whisper: one step on freshly
    prefilled rows through the kernels and the plain versions
    (``p19_kernels_vs_plain``); paligemma: the caches carried on the
    card, a prefill of the prompt and the first P19_NEW - 1 generated
    tokens giving the last step's logits. Returns (the captured run's
    launches, the kernel rows at this model's shapes)."""
    from repro_torch import configs
    from repro_torch.core import ParticleModule, PushDistribution
    from repro_torch.models import api
    from repro_torch.serve import PredictiveEngine
    what = f"({part})"
    cfg = configs.get(name)
    n5, n6 = p19_layers(cfg)
    off = cfg.n_prefix_tokens if cfg.family == "vlm" else 0
    module = ParticleModule(init=lambda g: api.init_params(g, cfg), cfg=cfg)
    fns = attention_counts()
    prompts = np.random.default_rng(19).integers(1, cfg.vocab_size,
                                                 (P19_B, P19_LEN))
    C = off + P19_LEN + P19_NEW
    toks = torch.as_tensor(prompts, dtype=torch.int32, device="cuda")
    front = p19_front(torch, cfg, P19_B)
    pre = {"tokens": toks[:, :-1], **front}
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    runs, tokens, launches, total, last, kernels = {}, {}, {}, {}, {}, {}

    def forward(p, c, b):
        logits, c = api.decode_step(p, b["token"], c, b["cur_pos"], cfg)
        last["logits"] = logits
        return logits, c

    with PushDistribution(module, seed=SEED) as pd:
        for _ in range(P19_P):
            pd.p_create()
        params = pd.store.stacked("params")
        for mode, cache in caches():
            engine = PredictiveEngine(forward, store=pd.store, stateful=True,
                                      cache=cache)
            for fn in fns.values():
                fn.launches = 0
            t1 = time.perf_counter()
            state = engine.init_state(lambda p: api.prefill(
                p, pre, cfg, max_len=C)[1])
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t1
            tok, out = toks[:, -1], []
            t2 = time.perf_counter()
            for step in range(P19_NEW):
                heads, state = engine.step(state, {
                    "token": tok, "cur_pos": off + P19_LEN - 1 + step})
                tok = heads["mean"].argmax(-1).to(torch.int32)
                out.append(tok)
            tokens[mode] = torch.stack(out, 1).cpu().numpy().tolist()
            decode_s = time.perf_counter() - t2
            got = launches[mode] = read_counts(fns)
            want = {"paged_decode_attention": 0,
                    "paged_decode_window_attention": 0,
                    "flash_attention": n5, "decode_attention": n6 * P19_NEW}
            if got != want:
                raise AssertionError(f"{what} {mode} launches {got}, want "
                                     f"{want}")
            if mode == "captured":
                add_counts(total, got)
            st = cache.snapshot_stats()
            if st["cold_compiles"] != 1:
                raise AssertionError(f"{what} {mode} step programs {st}")
            runs[mode] = {"prefill_s": prefill_s,
                          "decode_tok_per_s": P19_B * P19_NEW / decode_s,
                          "ms_per_step_wall": decode_s / P19_NEW * 1e3,
                          "graph_pool_gb": [
                              (c.get("pool_bytes") or 0) / 2**30
                              for c in cache.program_costs()]}
            if mode == "eager":
                step32 = last.pop("logits").clone()
            else:
                kernels = p19_rows(torch, cfg, state, front)
                after = tok
                prof = runs[mode]["step_profile"] = profile_steps(
                    torch, lambda: engine.step(state, {
                        "token": after, "cur_pos": C - 1}), n=3, fns=fns,
                    prologue=32, epilogue=32)
                if "wall_ms" in prof:
                    runs[mode]["steady_tok_per_s"] = \
                        P19_B / prof["wall_ms"] * 1e3
            last.clear()
            del state, engine, cache
            torch.cuda.empty_cache()
        exact, gaps = compare_tokens(
            torch, pd, cfg, prompts, tokens["captured"], tokens["eager"],
            f"{what} captured vs eager", front=front)
        same_launches(launches, f"phase 19 {what}")
        row = {}
        if cfg.family == "audio":
            row["kernels_vs_plain_step"] = p19_kernels_vs_plain(
                torch, params, cfg, pre, toks[:, -1], C)
        else:
            # the caches carried over: the eager run's last step consumed
            # the 31st generated token; a prefill of everything before it
            # and it gives the same next-token logits
            seq = torch.cat([toks, torch.as_tensor(
                tokens["eager"], dtype=torch.int32,
                device="cuda")[:, :P19_NEW - 1]], 1)
            with torch.no_grad():
                cont, _ = api.prefill(params, {"tokens": seq, **front}, cfg)
            top = float(step32.abs().max())
            row["continuation_rel_err"] = float(
                (cont - step32).abs().max()) / top
            if not row["continuation_rel_err"] < P19_LOGIT_TOL:
                raise AssertionError(f"{what} prefill of {seq.shape[1]} "
                                     f"tokens vs step {P19_NEW}: {row}")
            del cont
        del params, step32
    gc.collect()
    torch.cuda.empty_cache()
    row.update({"phase": 19, "part": part, "config": cfg.name,
                "params_per_particle": p17_param_count(cfg),
                "particle_gb": p17_param_count(cfg) * 4 / 1e9,
                "particles": P19_P, "prompts": P19_B,
                "prompt_len": P19_LEN, "positions_before_text": off,
                "new_tokens": P19_NEW, "flash_a_prefill": n5,
                "decode_a_step": n6, "runs": runs,
                "captured_vs_eager_requests_token_equal": exact,
                "tie_gaps": gaps, "kernels": kernels, "launches": total,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
                "part_s": time.perf_counter() - t0, "card": card})
    emit(row)
    return total, kernels


def phase19(torch, card):
    """The last two families at full width: whisper-medium's
    encoder-decoder (a) and paligemma-3b's prefix-LM (b) served from dense
    caches, captured and eager; both trained fused, depth cut (c): whisper
    at 2 + 2 layers (DeepEnsemble, SteinVGD), paligemma at 1 of 18
    (DeepEnsemble). Returns (the kernels' launches over the parts'
    main-path runs, phase 19's kernel rows)."""
    from repro_torch import configs
    t0 = time.perf_counter()
    launches, rows = {}, {}
    got, rows["whisper"] = p19_serving(torch, card, "whisper-medium", "a")
    add_counts(launches, got)
    lm_free(torch)
    t1 = time.perf_counter()
    got, rows["paligemma"] = p19_serving(torch, card, "paligemma-3b", "b")
    add_counts(launches, got)
    lm_free(torch)
    t2 = time.perf_counter()
    train = {}
    for name, cut, svgd_steps in (
            ("whisper-medium", P19_WH_TRAIN, P17_TRAIN_STEPS),
            ("paligemma-3b", P19_PG_TRAIN, 0)):
        got, train[name] = zoo_training(
            torch, card, *p17_cut(configs.get(name), **cut), svgd_steps, 19,
            f"c {name}", seq_len=P19_TRAIN_S)
        add_counts(launches, got)
        lm_free(torch)
    rows["training"] = train
    emit({"phase": 19, "part": "summary",
          "phase_s": time.perf_counter() - t0,
          "part_s": {"a": t1 - t0, "b": t2 - t1,
                     "c": time.perf_counter() - t2},
          "launches": launches, "card": card})
    return launches, rows


P20_UNITS = 2                   # qwen1.5-0.5b at full width, 2 of 24 units
P20_P = 2                       # particles of the train and serve steps
P20_MB = 2                      # microbatches of the train steps
P20_S, P20_B = 64, 4            # the cut InputShape: seq_len, global_batch
P20_SVGD_LR = 1.0               # (a): phi stands well above the rounding
P20_FORCE_TOL = 2e-4            # SVGD phi against the plain #1 / #2
P20_LOSS_TOL = 1e-6             # train loss against api.loss_fn, relative
P20_STEPS = (("train", "train_4k", "ensemble"),
             ("svgd", "train_4k", "svgd"),
             ("multiswag", "train_4k", "multiswag"),
             ("prefill", "prefill_32k", "ensemble"),
             ("serve", "decode_32k", "ensemble"))


def p20_step(torch, name, shape_name, bdl, cfg, mesh, init):
    """(step, args, plan, cut shape) of one launch step at phase 20's cut:
    ``launch.steps.build``'s step (the SVGD step at P20_SVGD_LR), its
    inputs real (``init``, a generator on the card) or fake (None). The
    serve step's caches are full: a prefill of C - 1 tokens and the
    decode at C - 1, so #6 reads every slot, as the dry run counts it."""
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.launch import plans, steps
    from repro_torch.models import api
    full = INPUT_SHAPES[shape_name]
    shape = dataclasses.replace(full, seq_len=P20_S, global_batch=P20_B)
    plan = dataclasses.replace(
        plans.plan_for(cfg, full), particles=P20_P,
        microbatches=P20_MB if full.kind == "train" else 1)
    step, args, _ = steps.build(cfg, shape, plan, mesh, bdl=bdl, init=init)
    if name == "svgd":
        step = steps.make_svgd_train_step(
            cfg.replace(remat=True, dtype="bfloat16"), plan, mesh,
            lr=P20_SVGD_LR)
    if name == "serve" and init is not None:
        params, token = args[0], args[1]
        bcfg = cfg.replace(dtype="bfloat16")
        prompt = torch.randint(1, cfg.vocab_size, (P20_B, P20_S - 1),
                               generator=init, device=init.device)
        with torch.no_grad():
            _, caches = api.prefill(params, {"tokens": prompt}, bcfg,
                                    max_len=P20_S)
        args = (params, token, caches, args[3].fill_(P20_S - 1))
    return step, args, plan, shape


def p20_holds(torch, name, cfg, plan, mesh, args, out):
    """Phase 20 (a)'s check of one step's output against the same work
    done another way (module docstring); returns the gaps."""
    from repro_torch.bdl import svgd as bsvgd
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import ref
    from repro_torch.launch import steps
    from repro_torch.models import api
    bcfg = cfg.replace(remat=True, dtype="bfloat16")
    gaps = {}
    if name in ("train", "svgd", "multiswag"):
        params, batch = args[0], args[1 if name == "svgd" else -1]
        n = P20_B // P20_MB
        with torch.no_grad():
            want = sum(api.loss_fn(params, {k: v[i * n:(i + 1) * n]
                                            for k, v in batch.items()},
                                   bcfg)[0] for i in range(P20_MB)) / P20_MB
        loss = out[-1]
        rel = float((loss - want).abs().max() / want.abs().max())
        gaps = {"loss_rel": rel}
        if not rel < P20_LOSS_TOL:
            raise AssertionError(f"(a) {name}: the step's loss against "
                                 f"api.loss_fn: {rel}")
    if name == "svgd":
        _, g = steps.microbatched_grads(bcfg, plan)(params, batch)
        group, ggroup = steps._as_group(params), steps._as_group(g)
        theta = steps._owned_matrix(group, 0)
        gm = steps._owned_matrix(ggroup, 0)
        sq = ref.pairwise_sqdist(theta)
        phi = ref.svgd_force(theta, gm, *bsvgd.rbf_glue(sq, 1.0))
        new = steps._owned_matrix(steps._as_group(out[0]), 0)
        got = (theta - new) / P20_SVGD_LR
        rel = float((got - phi).abs().max() / phi.abs().max())
        gaps["phi_rel"] = rel
        if not rel < P20_FORCE_TOL:
            raise AssertionError(f"(a) svgd: the step's phi against the "
                                 f"plain #1 / #2: {rel}")
    if name in ("prefill", "serve"):
        with torch.no_grad(), plain_kernels():
            if name == "prefill":
                want, _ = api.prefill(args[0], args[1], bcfg)
            else:
                caches = args[2]
                want, _ = api.decode_step(args[0], args[1], caches,
                                          args[3], bcfg)
        want = want.float().mean(0)
        rel = float((out[0] - want).abs().max() / want.abs().max())
        gaps["logits_rel"] = rel
        if not rel < BF16_TOL:
            raise AssertionError(f"(a) {name}: logits through the kernels "
                                 f"against the plain versions: {rel}")
    if not all(bool(torch.isfinite(x).all()) for x in tree_leaves(out)
               if isinstance(x, torch.Tensor) and x.is_floating_point()):
        raise AssertionError(f"(a) {name}: non-finite output")
    return gaps


def p20_clone(tree):
    from repro_torch.core.tree import tree_map
    return tree_map(lambda x: x.clone(), tree)


def p20_swag_bits(torch, before, after, new_params):
    """MultiSWAG's collection on the card bit for bit against the plain
    version of #3 applied to a copy of the state before the step."""
    from repro_torch.bdl.swag import swag_collect
    from repro_torch.kernels import ops
    saved = ops._route
    ops._route = lambda x, kernel, plain, n: plain
    try:
        swag_collect(before, new_params)
    finally:
        ops._route = saved
    if not tree_equal(torch, after, before):
        raise AssertionError("(a) multiswag: the moments differ from the "
                             "plain #3's")
    return {"moments_bit_equal": True}


def p20_counts(torch, step, args, fake):
    """(FLOPs, bytes, by aten op) of one ``step(*args)``: on the card
    under ``obs.device.counting`` (every microbatch trip run), or on fake
    inputs through ``launch.cost`` (as the dry run counts: one trip
    multiplied)."""
    from repro_torch.launch import cost
    from repro_torch.obs import device as obs
    if fake:
        c = cost.cost(step, *args)["totals"]
        return c["flops"], c["bytes"], c["by_op"]
    with obs.counting(by_op=True) as count:
        step(*args)
    torch.cuda.synchronize()
    return float(count.flops), float(count.bytes), count.by_op


def phase20(torch, card):
    """The launch tooling on the card: (a) the five steps that
    ``launch.steps.build`` makes, run and held; (b) each step's count on
    the card against the dry run's count of the same step on fake
    tensors; (c) one full-size dry-run row. Returns the kernels'
    launches over (a)'s runs."""
    from repro_torch import configs
    from repro_torch.launch import dryrun, make_mesh, roofline, steps
    t0 = time.perf_counter()
    cfg = configs.get("qwen1.5-0.5b").replace(n_units=P20_UNITS)
    mesh = make_mesh((1, 1), ("data", "model"), ["cuda:0"])
    fake_mesh = make_mesh((1, 1), ("data", "model"), steps.trace_devices(1))
    fns = reset_counts()
    expected = {"svgd": {"pairwise_sqdist": 1, "svgd_force": 1},
                "multiswag": {"swag_moments": collect_launches(
                    len(steps.rules.named_leaves(steps._template(cfg))))},
                "prefill": {"flash_attention": cfg.n_layers},
                "serve": {"decode_attention": cfg.n_layers}}
    launches, rows = {}, {}
    for name, shape_name, bdl in P20_STEPS:
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        step, args, plan, shape = p20_step(torch, name, shape_name, bdl,
                                           cfg, mesh, gen)
        before = p20_clone(args[2]) if name == "multiswag" else None
        counts0 = read_counts(fns)
        grad = name in ("train", "svgd", "multiswag")
        with (contextlib.nullcontext() if grad else torch.no_grad()):
            out = step(*args)
        torch.cuda.synchronize()
        got = {k: v - counts0[k] for k, v in read_counts(fns).items()}
        want = {k: expected.get(name, {}).get(k, 0) for k in got}
        if got != want:
            raise AssertionError(f"(a) {name}: launches {got}, want {want}")
        add_counts(launches, got)
        gaps = p20_holds(torch, name, cfg, plan, mesh, args, out)
        if name == "multiswag":
            gaps.update(p20_swag_bits(torch, before, args[2], out[0]))
        with (contextlib.nullcontext() if grad else torch.no_grad()):
            ms = time_ms(torch, lambda: step(*args), iters=3)
        # (b) the same step counted on the card and on fake tensors
        with (contextlib.nullcontext() if grad else torch.no_grad()):
            card_count = p20_counts(torch, step, args, fake=False)
        fstep, fargs, _, _ = p20_step(torch, name, shape_name, bdl, cfg,
                                      fake_mesh, None)
        fake_count = p20_counts(torch, fstep, fargs, fake=True)
        if card_count[:2] != fake_count[:2]:
            ops = [(k, card_count[2].get(k), fake_count[2].get(k))
                   for k in sorted(set(card_count[2]) | set(fake_count[2]))
                   if card_count[2].get(k) != fake_count[2].get(k)]
            raise AssertionError(
                f"(b) {name}: card count {card_count[:2]} against the fake "
                f"count {fake_count[:2]}; ops that differ: {ops}")
        t_c, t_m, t_n, dom = roofline.terms(card_count[0], card_count[1], 0.0)
        bound_ms = 1e3 * max(t_c, t_m, t_n)
        rows[name] = {"launches": got, **gaps, "flops": card_count[0],
                      "bytes": card_count[1], "fake_equal": True,
                      "event_ms": ms, "largest_term_ms": bound_ms,
                      "bound_by": dom, "shape": dataclasses.asdict(shape),
                      "plan": dataclasses.asdict(plan)}
        del step, args, out, before, fstep, fargs
        lm_free(torch)
    t1 = time.perf_counter()
    emit({"phase": 20, "part": "a-b", "steps": rows,
          "model": {"name": cfg.name, "layers": cfg.n_layers,
                    "of_layers": configs.get(cfg.name).n_layers},
          "terms_on": roofline.CARD, "card": card, "wall_s": t1 - t0})
    rec = dryrun.run_one("qwen1.5-0.5b", "decode_32k", verbose=False)
    if rec["status"] != "ok":
        raise AssertionError(f"(c) the full-size dry-run row: {rec}")
    coll = sum(rec["collective_bytes_per_device"].values())
    t_c, t_m, t_n, dom = roofline.terms(rec["flops_per_device"],
                                        rec["bytes_per_device"], coll)
    emit({"phase": 20, "part": "c", "row": {
        k: rec[k] for k in ("arch", "shape", "particles", "mode",
                            "flops_per_device", "bytes_per_device",
                            "collective_bytes_per_device", "memory",
                            "trace_s", "kv_layout", "units_traced")},
        "t_compute_s": t_c, "t_memory_s": t_m, "t_collective_s": t_n,
        "dominant": dom, "terms_on": roofline.CARD, "card": card,
        "wall_s": time.perf_counter() - t1})
    emit({"phase": 20, "part": "summary",
          "phase_s": time.perf_counter() - t0, "launches": launches,
          "card": card})
    return launches


P21_P = 2                        # particles in every part
P21_B, P21_LEN, P21_NEW = 4, 64, 16   # prompts of 64 tokens, 16 greedy steps
P21_CUTS = {                     # (a), (b), (d): each family's depth cut
    "zamba2-1.2b": {"n_units": 1},          # 1 of 6 units + the 2-layer tail
    "rwkv6-7b": {"n_units": 2},             # 2 of 32 layers
    "whisper-medium": {"n_units": 2, "n_encoder_layers": 2},
    "paligemma-3b": {"n_units": 2}}         # 2 of 18 layers
P21_SHARED = (("gemma3-4b", {"n_units": 1, "tail_layers": ()}),
              ("paligemma-3b", {"n_units": 2}))
P21_SHARED_M, P21_SHARED_NEW = 16, 8     # (c): the dry run's model axis
P21_TRAIN_S = 256                # (d): one lm_batch sequence a step
P21_TRAIN_CUTS = {**P21_CUTS,    # (d): paligemma at phase 19 (c)'s 1 of 18:
                  "paligemma-3b": {"n_units": 1}}   # 2 layers' Adam > 80 GB
P21_TRAIN_STEPS = 2
P21_LOSS_TOL = 1e-5              # (d): losses against one device, relative
P21_SVGD_TOL = 2e-4              # (d): SteinVGD params, relative


def p21_layers(cfg):
    """(#5 launches a prefill, #6 launches a step) at one model position:
    the audio and vlm families' (``p19_layers``); else every attention
    layer takes #6 a step and the non-``local`` ones #5 a prefill (a
    local layer's prefill is the plain sliding-window form)."""
    if cfg.family in ("audio", "vlm"):
        return p19_layers(cfg)
    kinds = (list(cfg.head_layers) + list(cfg.pattern) * cfg.n_units
             + list(cfg.tail_layers))
    att = [k for k in kinds if k not in ("mamba", "rwkv")]
    return sum(k != "local" for k in att), len(att)


def p21_mode(torch, group, cfg):
    """The model-axis form each layer kind takes on ``group``, a store's
    Group of params: ``tp``'s attention mode of the first attention layer
    and ``tp_recurrent``'s mode of the first recurrent one."""
    from repro_torch.models import tp, tp_recurrent
    m, s = len(group), group.shards[0]
    out = {}
    for kind, p in zip(cfg.pattern, s["units"]):
        if kind in tp_recurrent.MODES and kind not in out:
            out[kind] = tp_recurrent.MODES[kind](p, cfg, m)
        elif "attn" in (s["shared"] if kind == "shared_attn" else p) \
                and "attn" not in out:
            pa = (s["shared"] if kind == "shared_attn" else p)["attn"]
            out["attn"] = tp._attn_locals(pa["wq"]["w"].shape[-1],
                                          pa["wk"]["w"].shape[-1], cfg, m)[0]
    return out


def p21_serving(torch, card, name, part, cut_kw, m=2, new=P21_NEW,
                modes=("captured", "eager")):
    """``name`` at full width, depth cut by ``cut_kw``, P21_P particles of
    random fp32 weights on a 1 x ``m`` plan of cuda:0's positions (or m
    GPUs): P21_B prompts of P21_LEN tokens (with the stub frames or
    patches) prefilled into each position's dense caches and states, then
    ``new`` greedy BMA steps through ``PredictiveEngine(stateful=True)``
    in each of ``modes``. The same cut model on one device (the store's
    joined params, the same particles) runs the same steps first: tokens
    equal up to a near-tie (``compare_tokens``) and the BMA probabilities
    within P16_PROB while the tokens agree; launches exact (m x #5 a
    prefill and m x #6 a step, ``p21_layers``; #7 and #8 never), the
    captured run's equal to the eager run's. Returns (the first mode's
    launches, the row)."""
    from repro_torch import configs
    from repro_torch.core import ParticleModule, PushDistribution
    from repro_torch.models import api
    from repro_torch.serve import PredictiveEngine, uncertainty
    what = f"(21 {part} {name})"
    cfg, cut = p17_cut(configs.get(name), **cut_kw)
    n5, n6 = p21_layers(cfg)
    off = cfg.n_prefix_tokens if cfg.family == "vlm" else 0
    module = ParticleModule(init=lambda g: api.init_params(g, cfg), cfg=cfg)
    fns = attention_counts()
    prompts = np.random.default_rng(21).integers(1, cfg.vocab_size,
                                                 (P21_B, P21_LEN))
    toks = torch.as_tensor(prompts, dtype=torch.int32, device="cuda")
    front = (p19_front(torch, cfg, P21_B)
             if cfg.family in ("audio", "vlm") else {})
    pre = {"tokens": toks[:, :-1], **front}
    C = off + P21_LEN + new
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    runs, tokens, probs, launches, box = {}, {}, {}, {}, {}

    def steps(decode):
        tok, out, ps = toks[:, -1], [], []
        for step in range(new):
            if step == 1:       # past the first step (a capture's)
                torch.cuda.synchronize()
                box["t1"] = time.perf_counter()
            mean = decode(tok, off + P21_LEN - 1 + step)
            tok = mean.argmax(-1).to(torch.int32)
            out.append(tok)
            ps.append(mean)
        torch.cuda.synchronize()
        box["steady_ms"] = (time.perf_counter() - box["t1"]) / (new - 1) * 1e3
        return (torch.stack(out, 1).cpu().numpy().tolist(),
                torch.stack(ps, 1))

    with PushDistribution(module, seed=SEED,
                          placement=p16_placement(torch, m, m)) as pd:
        for _ in range(P21_P):
            pd.p_create()
        form = p21_mode(torch, pd.store.stacked("params").shards[0], cfg)
        mask = pd.store.active_mask()
        dense = pd.store.dense("params")
        t1 = time.perf_counter()
        with torch.no_grad():
            c1 = api.prefill(dense, pre, cfg, max_len=C)[1]

            def one(tok, pos):
                logits = api.decode_step(dense, tok, c1, pos, cfg)[0]
                return uncertainty.predictive_heads(logits, mask=mask)[
                    "mean"]

            tokens["one_device"], probs["one_device"] = steps(one)
        del c1
        torch.cuda.synchronize()
        runs["one_device"] = {"wall_s": time.perf_counter() - t1,
                              "ms_per_step_after_first": box["steady_ms"]}
        for mode, cache in caches():
            if mode not in modes:
                continue
            engine = PredictiveEngine(
                lambda p, c, b: api.decode_step(p, b["token"], c,
                                                b["cur_pos"], cfg),
                store=pd.store, stateful=True, cache=cache)
            for fn in fns.values():
                fn.launches = 0
            t1 = time.perf_counter()
            box["state"] = engine.init_state(lambda p: api.prefill(
                p, pre, cfg, max_len=C)[1])
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t1

            def grouped(tok, pos):
                heads, box["state"] = engine.step(
                    box["state"], {"token": tok, "cur_pos": pos})
                return heads["mean"]

            t2 = time.perf_counter()
            tokens[mode], probs[mode] = steps(grouped)
            decode_s = time.perf_counter() - t2
            got = launches[mode] = read_counts(fns)
            want = {"paged_decode_attention": 0,
                    "paged_decode_window_attention": 0,
                    "flash_attention": m * n5,
                    "decode_attention": m * n6 * new}
            if got != want:
                raise AssertionError(f"{what} {mode} launches {got}, want "
                                     f"{want}")
            runs[mode] = {"prefill_s": prefill_s,
                          "ms_per_step_wall": decode_s / new * 1e3,
                          "ms_per_step_after_first": box["steady_ms"],
                          "decode_tok_per_s": P21_B * new / decode_s,
                          "cache": cache.snapshot_stats()}
            del box["state"], engine, cache
            torch.cuda.empty_cache()
        holds = {}
        for mode in modes:
            exact, gaps = compare_tokens(
                torch, pd, cfg, prompts, tokens[mode], tokens["one_device"],
                f"{what} {mode} vs one device", params=dense, tie=P16_TIE,
                front=front)
            same = [i for i in range(P21_B)
                    if tokens[mode][i] == tokens["one_device"][i]]
            gap = (float((probs[mode][same] - probs["one_device"][same])
                         .abs().max()) if same else 0.0)
            if not gap < P16_PROB:
                raise AssertionError(f"{what} {mode}: BMA probabilities "
                                     f"{gap} from one device's")
            holds[mode] = {"requests_token_equal": exact, "tie_gaps": gaps,
                           "prob_max_abs_vs_one_device": gap}
        if len(modes) == 2:
            same_launches(launches, f"phase 21 {what}")
        del dense, probs
    gc.collect()
    torch.cuda.empty_cache()
    row = {"phase": 21, "part": part, "config": cut, "model_axis": m,
           "forms": form, "params_per_particle": p17_param_count(cfg),
           "particles": P21_P, "prompts": P21_B, "prompt_len": P21_LEN,
           "positions_before_text": off, "new_tokens": new,
           "flash_a_prefill_a_position": n5,
           "decode_a_step_a_position": n6, "runs": runs, "holds": holds,
           "launches": launches[modes[0]],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
           "part_s": time.perf_counter() - t0, "card": card}
    emit(row)
    return launches[modes[0]], row


def p21_rows(torch, cfg):
    """The P21_P particles drawn afresh, one at a time (seed SEED on the
    card): every call gives the same rows, so no copy of them need be
    kept, and a row is dropped once the store has stacked it."""
    from repro_torch.models import api
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for _ in range(P21_P):
        yield api.init_params(gen, cfg)


def p21_train_run(torch, cls, cfg, batches, placement, **kw):
    """``cls`` over the P21_P particles of ``p21_rows``, eager, one step a
    batch, on ``placement`` (None: one device). Returns (the losses, the
    params as (P, D) on the card, the launches, the wall s)."""
    from repro_torch.core import ParticleModule
    from repro_torch.core.functional import flatten_stacked
    from repro_torch.models import api
    from repro_torch.runtime import ProgramCache, eager
    rows = p21_rows(torch, cfg)
    module = ParticleModule(init=lambda g: next(rows),
                            loss=lambda p, b: api.loss_fn(p, b, cfg), cfg=cfg)
    algo = cls(module, seed=SEED, backend="compiled", placement=placement)
    algo.push_dist.runtime.cache = ProgramCache(capturer=eager)
    fns = reset_counts()
    t0 = time.perf_counter()
    pids, ls = algo.bayes_infer([batches[0]], 1, num_particles=P21_P, **kw)
    losses = [ls] + [algo._fused_epochs(pids, [b], 1, **kw)
                     for b in batches[1:]]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(fns)
    flat = flatten_stacked(algo.store.dense("params"))[0]
    algo.cleanup()
    del algo, module
    lm_free(torch)
    return np.array(losses, dtype=np.float64), flat, launches, wall


def p21_held(one, two, big):
    """``held``'s figures for (P, D) params too large for its temporaries
    beside two runs' rows: computed in place on ``one``."""
    d = one.sub_(two).abs_()
    rest = float(d.masked_fill(big, 0.0).max())
    share = float((~big).sum()) / big.numel()
    top = float(d.masked_fill_(~big, 0.0).max())
    return {"held_max_over_bar": top / HOLD, "held_max_abs": top,
            "rest_max_abs": rest, "rest_share": share}


def p21_training(torch, card):
    """(d) each family at (a)'s and (b)'s depth (paligemma at 1 of 18
    layers: at 2 an Adam step, which holds the old and the new params and
    moments, peaks past the card's 80 GB), one P21_TRAIN_S-token
    sequence a step (with its frames or patches): DeepEnsemble (Adam 1e-4)
    for P21_TRAIN_STEPS steps on one device and on 1 x 2 from the same
    particles: losses within P21_LOSS_TOL relative, params within HOLD
    where the first step's |g| > G_HOLD (the rest reported: Adam's first
    steps are sign-like, so where |g| sits at the rounding level the runs
    may step 2 lr apart); SteinVGD (the median) on zamba2 the same way,
    params within P21_SVGD_TOL of their largest, #1 and #2 launched once a
    step on one device and once a position a step on 1 x 2. Returns (the
    1 x 2 runs' launches, the row)."""
    from repro_torch import configs
    from repro_torch.bdl import DeepEnsemble, SteinVGD
    from repro_torch.core.functional import (ensemble_value_and_grad,
                                             flatten_stacked)
    from repro_torch.core.tree import tree_map
    from repro_torch.data import DataLoader
    from repro_torch.models import api
    from repro_torch.optim import adam
    t0 = time.perf_counter()
    out, launches, failed = {}, {}, []
    for name, cut_kw in P21_TRAIN_CUTS.items():
        cfg, cut = p17_cut(configs.get(name), **cut_kw)
        batches = [{k: torch.as_tensor(v, device="cuda") for k, v in b.items()}
                   for b in DataLoader(cfg, batch_size=1, seq_len=P21_TRAIN_S,
                                       num_batches=P21_TRAIN_STEPS,
                                       seed=SEED)]
        stacked = tree_map(lambda *x: torch.stack(x),
                           *p21_rows(torch, cfg))
        g1 = ensemble_value_and_grad(lambda p, b: api.loss_fn(p, b, cfg))(
            stacked, batches[0])[1]
        big = flatten_stacked(g1)[0].abs() > G_HOLD
        del g1, stacked
        lm_free(torch)
        algos = [("ensemble", DeepEnsemble, {"optimizer": adam(1e-4)})]
        if name == "zamba2-1.2b":
            algos.append(("svgd", SteinVGD, {"lr": 1e-3, "lengthscale": 0.0}))
        for algo_name, cls, kw in algos:
            t1 = time.perf_counter()
            # paligemma's Adam step peaks at ~70 GB: the first run's
            # (P, D) params wait on the host while the second runs
            one = p21_train_run(torch, cls, cfg, batches, None, **kw)
            one = (one[0], one[1].cpu()) + one[2:]
            two = p21_train_run(torch, cls, cfg, batches,
                                p16_placement(torch, 2, 2), **kw)
            one = (one[0], one[1].to(two[1].device)) + one[2:]
            row_gb = torch.cuda.memory_allocated() / 2**30
            add_counts(launches, two[2])
            dl = float(np.abs(one[0] - two[0]).max() / np.abs(one[0]).max())
            row = {"loss_rel": dl, "launches": {"one": one[2], "1x2": two[2]},
                   "wall_s": {"one": one[3], "1x2": two[3]},
                   "allocated_gb_at_compare": row_gb}
            bad = [] if dl < P21_LOSS_TOL else ["losses"]
            if algo_name == "ensemble":
                row["params"] = p21_held(one[1], two[1], big)
                if not row["params"]["held_max_over_bar"] < 1:
                    bad.append("params")
            else:
                top = float(one[1].abs().max())
                rel = float(one[1].sub_(two[1]).abs_().max()) / top
                row["params_rel"] = rel
                want = {"pairwise_sqdist": 2 * P21_TRAIN_STEPS,
                        "svgd_force": 2 * P21_TRAIN_STEPS}
                if not rel < P21_SVGD_TOL:
                    bad.append("params")
                if {k: two[2][k] for k in want} != want or \
                        one[2]["pairwise_sqdist"] != P21_TRAIN_STEPS:
                    bad.append("launches")
            out[f"{name} {algo_name}"] = dict(row, config=cut,
                                              part_s=time.perf_counter() - t1)
            failed += [f"{name} {algo_name}: {b}" for b in bad]
            del one, two
            lm_free(torch)
        del batches, big
        lm_free(torch)
    row = {"phase": 21, "part": "d", "train": out, "failed": failed,
           "launches": launches, "seq_len": P21_TRAIN_S,
           "steps": P21_TRAIN_STEPS, "part_s": time.perf_counter() - t0,
           "card": card}
    emit(row)
    if failed:
        raise AssertionError(f"phase 21 (d): {failed}")
    return launches, row


def p21_layer_share(m=4):
    """The share of one recurrent layer's parameter bytes a model position
    holds at a model axis of ``m`` (``sharding.rules.model_dims`` on the
    layer's shapes, traced on fake tensors): zamba2-1.2b's mamba layer
    (``out_proj`` replicated) and rwkv6-7b's rwkv layer (the
    channel-mix's ``wr`` replicated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    import torch
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.sharding import rules
    out = {}
    for name, kind in (("zamba2-1.2b", "mamba"), ("rwkv6-7b", "rwkv")):
        with FakeTensorMode():
            layer = transformer.layer_init(kind, torch.Generator(),
                                           configs.get(name))
        dims = rules.model_dims(layer, m)
        whole = own = 0
        for path, x in rules.named_leaves(layer):
            whole += x.numel()
            own += x.numel() // (m if dims[path] is not None else 1)
        out[kind] = own / whole
    return out


def p21_dry_run(torch, card):
    """(e) rwkv6-7b's decode step from ``launch.steps.build`` (2 of 32
    layers at full width, phase 20's cut shape and plan) on a 1 x 2 mesh
    of cuda:0, run on real weights (its caches from a prefill of C - 1
    tokens), then counted on the card under ``obs.device.counting`` and
    on fake tensors through ``launch.cost`` on the same layout (two
    positions of one fake device): FLOPs and bytes equal."""
    from repro_torch import configs
    from repro_torch.core.tree import Group, tree_leaves
    from repro_torch.launch import make_mesh, steps
    t0 = time.perf_counter()
    cfg = configs.get("rwkv6-7b").replace(**P21_CUTS["rwkv6-7b"])
    mesh = make_mesh((1, 2), ("data", "model"), ["cuda:0"] * 2)
    fake_mesh = make_mesh((1, 2), ("data", "model"),
                          [steps.trace_devices(1)[0]] * 2)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    step, args, plan, shape = p20_step(torch, "serve", "decode_32k",
                                       "ensemble", cfg, mesh, gen)
    if not isinstance(args[0], Group) or not isinstance(args[2], Group):
        raise AssertionError("(e) the decode step's params and caches are "
                             "not a model group")
    with torch.no_grad():
        out = step(*args)
        card_count = p20_counts(torch, step, args, fake=False)
    if not all(bool(torch.isfinite(x).all()) for x in tree_leaves(out)
               if isinstance(x, torch.Tensor) and x.is_floating_point()):
        raise AssertionError("(e) non-finite output")
    fstep, fargs, _, _ = p20_step(torch, "serve", "decode_32k", "ensemble",
                                  cfg, fake_mesh, None)
    fake_count = p20_counts(torch, fstep, fargs, fake=True)
    if card_count[:2] != fake_count[:2]:
        ops = [(k, card_count[2].get(k), fake_count[2].get(k))
               for k in sorted(set(card_count[2]) | set(fake_count[2]))
               if card_count[2].get(k) != fake_count[2].get(k)]
        raise AssertionError(
            f"(e) card count {card_count[:2]} against the fake count "
            f"{fake_count[:2]}; ops that differ: {ops}")
    row = {"phase": 21, "part": "e", "step": "serve", "flops": card_count[0],
           "bytes": card_count[1], "fake_equal": True,
           "layer_bytes_a_position_at_4": p21_layer_share(4),
           "shape": dataclasses.asdict(shape),
           "plan": dataclasses.asdict(plan), "layers": cfg.n_layers,
           "part_s": time.perf_counter() - t0, "card": card}
    emit(row)
    del step, args, out, fstep, fargs
    lm_free(torch)
    return row


def phase21(torch, card):
    """The model axis for the four families and the shared q head, in
    the order (d), (a), (b), (c), (e): (d) training on 1 x 2
    (``p21_training``); (a) zamba2-1.2b and rwkv6-7b and (b)
    whisper-medium and paligemma-3b served on 1 x 2 (``p21_serving``,
    captured and eager); (c) gemma3-4b and paligemma-3b on 1 x 16, their
    q heads shared by 2 positions (eager); (e) a launch step's count on
    the card against the dry run's (``p21_dry_run``). Prints the GB left
    allocated before each part. Returns the kernels' launches over
    (a)-(d)'s main-path runs."""
    t0 = time.perf_counter()
    launches, parts, gb = {}, {}, {}

    def resident(part):
        lm_free(torch)
        gb[part] = torch.cuda.memory_allocated() / 2**30

    # (d) first: paligemma's Adam step needs ~70 of the card's 80 GB
    resident("d")
    t1 = time.perf_counter()
    add_counts(launches, p21_training(torch, card)[0])
    parts["d"] = time.perf_counter() - t1
    for part, names in (("a", ("zamba2-1.2b", "rwkv6-7b")),
                        ("b", ("whisper-medium", "paligemma-3b"))):
        resident(part)
        t1 = time.perf_counter()
        for name in names:
            got, _ = p21_serving(torch, card, name, part, P21_CUTS[name])
            add_counts(launches, got)
            lm_free(torch)
        parts[part] = time.perf_counter() - t1
    resident("c")
    t1 = time.perf_counter()
    for name, cut_kw in P21_SHARED:
        got, row = p21_serving(torch, card, name, "c", cut_kw,
                               m=P21_SHARED_M, new=P21_SHARED_NEW,
                               modes=("eager",))
        if row["forms"].get("attn") != "shared":
            raise AssertionError(f"(c) {name}: the q heads are not shared "
                                 f"on 1 x {P21_SHARED_M}: {row['forms']}")
        add_counts(launches, got)
        lm_free(torch)
    parts["c"] = time.perf_counter() - t1
    resident("e")
    t1 = time.perf_counter()
    p21_dry_run(torch, card)
    parts["e"] = time.perf_counter() - t1
    resident("end")
    emit({"phase": 21, "part": "summary",
          "phase_s": time.perf_counter() - t0, "part_s": parts,
          "resident_gb_before": gb, "launches": launches, "card": card})
    return launches


def timed(n, fn, *args):
    """``fn(*args)``, then phase ``n``'s summary row with its wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    emit({"phase": n, "part": "summary", "phase_s": time.perf_counter() - t0})
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke run needs one GPU")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail("src/repro_torch not found beside chip_smoke.py: run it from a "
             "checkout of the repository", code=2)
    sys.path.insert(0, SRC)
    # fp32 products in full fp32, as the reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)

    from repro_torch import configs
    from repro_torch.core import ParticleModule, PushDistribution
    from repro_torch.kernels import build
    from repro_torch.models import api
    t0 = time.perf_counter()
    build.build_all()
    ptxas = {n: ptxas_by_entry(build.build_log(n)) for n in build.sources()}
    emit({"phase": 0, "built": build.sources(),
          "build_s": time.perf_counter() - t0, "ptxas": ptxas})

    cfg = configs.get("qwen1.5-0.5b")
    reqs = traffic(cfg.vocab_size)
    rows = {"paged_decode_attention": timed(1, phase1, torch, cfg, reqs)}
    for row in timed(5, phase5, torch, cfg, reqs):
        rows[row["name"]] = row
    launches = {}
    module = ParticleModule(init=lambda g: api.init_params(g, cfg), cfg=cfg)
    with PushDistribution(module, seed=SEED) as pd:
        for _ in range(PARTICLES):
            pd.p_create()
        pd.store.stacked("params")
        got, plain_tokens, plain_tok_s, plain_logprobs = timed(
            2, phase2, torch, pd, cfg, reqs)
        for name in ("paged_decode_attention", "flash_attention"):
            launches[name] = got[name]
        got = timed(6, phase6, torch, pd, cfg, reqs, plain_tokens,
                    plain_tok_s)
        launches["paged_decode_window_attention"] = got[
            "paged_decode_window_attention"]
        launches["decode_attention"] = timed(7, phase7, torch, pd, cfg)[
            "decode_attention"]
    del pd
    gc.collect()            # the LM's particles sit in reference cycles
    torch.cuda.empty_cache()
    for row in timed(3, phase3, torch):
        rows[row["name"]] = row
    got, captured = timed(4, phase4, torch)
    launches.update(got)
    gc.collect()
    torch.cuda.empty_cache()
    nel_launches, vit_steps = timed(8, phase8, torch, captured)
    gc.collect()
    torch.cuda.empty_cache()
    lc_launches = timed(9, phase9, torch, cfg, reqs)
    gc.collect()
    torch.cuda.empty_cache()
    serve_launches, diag_std_p1, fp32_predictive = timed(10, phase10, torch)
    rows["swag_diag_std"]["serving_p1"] = diag_std_p1
    gc.collect()
    torch.cuda.empty_cache()
    card = smi.stdout.strip().splitlines()[0]
    precision_launches, bf16_rows = phase11(torch, cfg, reqs, captured,
                                            fp32_predictive, card)
    gc.collect()
    torch.cuda.empty_cache()
    sciml_launches, sci_rows = phase12(torch, card, vit_fig4(vit_steps))
    gc.collect()
    torch.cuda.empty_cache()
    lm_launches, lm_rows = phase13(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    obs_launches = phase14(torch, cfg, reqs, (plain_tokens, plain_logprobs),
                           card)
    gc.collect()
    torch.cuda.empty_cache()
    placement_launches = phase15(
        torch, cfg, reqs, {"tokens": plain_tokens, "logprobs": plain_logprobs,
                           "tok_per_s": plain_tok_s}, captured, card)
    gc.collect()
    torch.cuda.empty_cache()
    model_launches, position_rows = phase16(
        torch, cfg, reqs, {"tokens": plain_tokens, "logprobs": plain_logprobs,
                           "tok_per_s": plain_tok_s}, card)
    gc.collect()
    torch.cuda.empty_cache()
    zoo_launches, zoo_rows = phase17(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    recurrent_launches, recurrent_rows = phase18(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    encdec_launches, encdec_rows = phase19(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    launch_steps_launches = phase20(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    families_launches = phase21(torch, card)
    for name, row in rows.items():
        row["launch_steps_launches"] = launch_steps_launches.get(name, 0)
        row["model_axis_families_launches"] = families_launches.get(name, 0)
        row["launches"] = launches[name]
        row["nel_launches"] = nel_launches.get(name, 0)
        row["lifecycle_launches"] = lc_launches.get(name, 0)
        row["serve_launches"] = serve_launches.get(name, 0)
        row["precision_launches"] = precision_launches.get(name, 0)
        row["sciml_launches"] = sciml_launches.get(name, 0)
        row["lm_training_launches"] = lm_launches.get(name, 0)
        row["ckpt_obs_launches"] = obs_launches.get(name, 0)
        row["placement_launches"] = placement_launches.get(name, 0)
        row["model_axis_launches"] = model_launches.get(name, 0)
        row["zoo_launches"] = zoo_launches.get(name, 0)
        row["recurrent_launches"] = recurrent_launches.get(name, 0)
        row["encdec_vlm_launches"] = encdec_launches.get(name, 0)
        encdec = {arch: encdec_rows[arch][name]
                  for arch in ("whisper", "paligemma")
                  if name in encdec_rows[arch]}
        if name in ("pairwise_sqdist", "svgd_force"):
            encdec["training"] = {
                arch: checks[name]
                for arch, checks in encdec_rows["training"].items()
                if checks}
        if encdec:
            row["encdec_vlm"] = encdec
        recurrent = {}
        if name in recurrent_rows["zamba2"]:
            recurrent["zamba2"] = recurrent_rows["zamba2"][name]
        if name in ("pairwise_sqdist", "svgd_force"):
            recurrent["training"] = {
                arch: checks[name]
                for arch, checks in recurrent_rows["training"].items()}
        if recurrent:
            row["recurrent"] = recurrent
        zoo = {}
        if name in zoo_rows["position"]:
            zoo["deepseek"] = zoo_rows["position"][name]
        if name == "paged_decode_window_attention":
            zoo["qwen3_verify"] = zoo_rows["verify"]
        if name == "flash_attention":
            zoo["gemma3_hd256"] = zoo_rows["flash_hd256"]
        if zoo:
            row["zoo"] = zoo
        if name in position_rows:
            row["per_position"] = position_rows[name]
        if name in lm_rows:
            row["lm"] = lm_rows[name]
        if name in sci_rows:
            row["unet"] = sci_rows[name]
        if name in bf16_rows:
            row["bf16"] = bf16_rows[name]
    rows = list(rows.values())
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
