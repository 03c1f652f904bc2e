#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths on the card — through `repro_torch.api.run`
a fleet of 16 FB-like traces (526 coflows, 150 ports each, the paper's
full-width trace) through the Saath coordinator tick, first on the big
switch, then on a 4:1 leaf-spine fabric with the max-min work-
conservation fill; then through `repro_torch.launch.lm_serve.
ServeSession` Mamba2-1.3B and StarCoder2-3B at their published widths
and depths; then the same 16 traces streamed online into a
`repro_torch.api.SessionPool`, and a leaf-spine pool; then the fleet with
pilot-learned coflow sizes, and the `repro_torch.launch.serve.
CoflowServer` front door; then the port's drivers, and the event-driven
host plane replaying one FB-like trace under each of the nine registry
policies, then the paper's figure drivers with their host baselines,
and the runtime bridge's wave planner and wave-ordered all-reduce, the
analysis plane's checks of the device step, and last Qwen3-MoE-235B-
A22B, DeepSeek-V2-236B (MLA) and Jamba-v0.1-52B (the Mamba/attention
hybrid) served at their published widths with every expert and the
depth cut, then StarCoder2-3B trained at its published width
through `repro_torch.launch.train.train`, and last Gemma-7B, DeepSeek-7B,
DeepSeek-Coder-33B, Chameleon-34B and the encoder-decoder
SeamlessM4T-medium served at their published widths and depths, and
last Mamba2-1.3B, Jamba-v0.1-52B (one period, 2 of its 16 experts) and
SeamlessM4T-medium trained at their published widths — and holds each
hand-written CUDA kernel of those paths against its plain PyTorch
version on the same inputs:

1. the card's name and power limit; build the eight kernels with nvcc
   (`src/repro_torch/kernels/csrc/`, sm_90a, one nvcc per source, all
   started together) and print nvcc's register and shared-memory
   report and the build time;
2. K1 (LCoF contention) against its plain version, exact, at Table 2's
   shapes (B=1, C=2048 and 4096, P=512), f32 and bf16, with its time
   beside the plain version's, one bf16 matmul form's and the bound
   (`contention_bound_ms`: bytes, and the fewer word operations of the
   pairwise and the port-major forms for these inputs);
3. one chunk of 128 event steps of each path, and one chunk of 32
   session steps (the `n_end`-capped branch of the tick), under
   `torch.cuda.set_sync_debug_mode("error")`: the tick loop makes no
   host synchronization; then the same for a learned replay chunk (the
   pilot estimate built in) and a chunk of a sampling pool slab with a
   known and a learned row;
4. the big-switch main path: the 16-trace fleet through `run(Scenario(
   ...))`, with the kernels' launch counters set to 0 just before and
   read just after (K1 and K2 must equal the event steps; K6's
   launches the calls those steps make, `prefix_calls_per_step`, and
   its rows summed their segment sums times the lanes,
   `segment_sums_per_step`); per-lane
   avg CCT, events, ticks, wall seconds and peak device memory; every
   real coflow finished, every byte delivered; K3, K4 and K5 ran 0
   times. Tick inputs are captured on the way (a spy on `tick_core`
   that clones its arguments, and the segment sums' inputs before it);
5. whole-path parity: lanes 0 and 1 within 1% of the JAX package's avg
   CCT on the same traces (`tests/data/torch_port_fb_golden.json`);
6. on the heaviest captured ticks, the whole tick with the kernels
   against the tick with the plain versions (order, queue, contention,
   expiry and admission exact; rates to rtol 1e-6; K6 on the tick's
   segment-sum inputs bit for bit, as in 9, 18 and 19), and K1's and K2's
   time at the main path's shapes beside the plain version, the bound
   and (K1) one PyTorch call computing the same function; K1 on the
   main path's bool incidence and on its f32 cast, with the CUDA
   launches one call makes (`cuda_launches`) and the host time one call
   takes to queue (`host_us`); K2's chain
   (`walk_chain`): the busiest lane's dependent steps and the measured
   ns per step;
7. the leaf-spine main path: the same fleet under `LeafSpine(4, 4.0,
   "maxmin")` (38 leaves, 188 rows a side), counters as in 4 (K1, K2 and
   K3 must each equal the event steps; K4 and K5 0), the same checks
   and prints;
8. leaf-spine whole-path parity: lanes fb_like_trace(48, 150, seed=0/1)
   under that topology with the JAX package's event count and within 1%
   of its avg CCT (`tests/data/torch_port_leafspine_golden.json`);
9. as 6 on the heaviest captured leaf-spine ticks (K1 + K2 + K3 against
   the plain versions; the rates, `wc_flow` among them, must agree bit
   for bit), and K2's (admission only) and K3's time at that path's
   shapes beside the plain version and the bound, with K2's chain and
   K3's rounds and ns per round;
10. K4 (the SSD chunked scan) against `ssd_chunked_ref` on the shapes of
   `tests/test_kernels.py` and the serve shape (4, 1024, 64, 64, G = 1,
   N = 128, lc = 128), f32 and bf16, plus the two-half state chaining,
   at the reference's bar (atol 5e-4 scaled by max|y| at the serve
   shape, rtol 1e-3, one bf16 rounding step more for a bf16 y); K4's
   time at the serve shape beside the plain version's and the bound, and
   at B = 1 with the CUDA launches one call makes;
11. full-width whole-path parity (`golden_parity`): Mamba2-1.3B at its
   published width, 2 layers, f32, weights from `numpy_params(cfg,
   seed=0)` served by `ServeSession(model=...)`, 2 prompts of 300 tokens
   and 8 greedy tokens through K4 (once per layer, no other kernel),
   against the JAX package's numbers
   (`tests/data/torch_port_mamba2_golden.json`): top-8 logits to atol
   2e-3, tokens equal (a token may differ only where the golden's top-2
   gap is under 1e-3), per-layer SSD state norms (summed in f64) to rtol
   1e-4;
12. the Mamba2 serve main path (`serve_main_path`): `ServeSession(
   "mamba2-1.3b", smoke=False)`, 48 layers in bf16, 4 prompts of 1000
   tokens and 64 greedy tokens, with the counters set to 0 just before
   and read just after (K4 = 48 per prefill, every other kernel 0);
   prefill ms, decode ms per token, tokens/s, peak device memory; then
   the same session in f32 with the plain SSD path and with K4, held to
   phase 11's bar over the steps with equal histories;
13. K5 (forward GQA attention; the f32 instance on the CUDA cores, the
   bf16 one on wgmma tensor cores fed by a TMA ring) against
   `flash_attention_ref` on the shapes of `tests/test_kernels.py`'s
   sweep, its chunked-prefill offset, a ragged S against T > S, and at
   D = 128 StarCoder2's G = 12 with S = T = 300 and a chunk at q_offset
   250 against T = 400, causal and not, and at the serve shape (B 4, H
   24, Hkv 2, S = T = 2000, D 128, causal), f32 and bf16, at the
   reference's bars (atol 2e-6 f32, 2e-2 bf16); K5's time at the serve
   shape beside the plain version's, one PyTorch call's
   (`scaled_dot_product_attention`, timed here only) and the bound, and
   for bf16 its TFLOP/s, its share of the bound and its ratio to SDPA's
   time in the same run (printed, never a failure: speed is read, not
   gated);
14. as 11 for StarCoder2-3B through K5: full width, 2 layers, f32,
   against `tests/data/torch_port_starcoder2_golden.json`, per-layer K
   and V cache norms to rtol 1e-4;
15. as 12 for the StarCoder2 serve main path: `ServeSession(
   "starcoder2-3b", smoke=False)`, 30 layers in bf16, 4 prompts of 2000
   tokens and 64 greedy tokens (K5 = 30 per prefill, every other kernel
   0) and its first-step logit gap to the plain attention in bf16
   (printed); then in f32 with the plain attention and with K5; then a
   bf16 pair (`bf16_pair`): StarCoder2-3B at full width, 2 layers, bf16,
   weights from `numpy_params(cfg, seed=0)`, a prefill of 4 x 2000
   tokens and 8 teacher-forced decode steps with the plain attention
   and with K5, logits to atol 0.1 (the bf16 bar of ROADMAP C5);
16. the online serving plane (`pool_main_path`): `SessionPool(
   SchedulerParams(), num_ports=150, max_sessions=16)` on the card,
   tenant i streaming phase 4's trace i (every coflow arriving before
   the new clock submitted before each `pool.advance(16 δ)`), then
   drained in 1 s advances through `pool.advance` and `pool.poll`, with
   the counters set to 0 just before and read just after: every
   tenant's per-coflow CCTs equal phase 4's offline replay bit for bit,
   every coflow completes once, K1 = K2 = the event steps the session
   loops ran (discarded steps included), K3 = K4 = K5 = 0, full uploads
   = capacity growths + 1, and an advance with no dirty row uploads no
   byte; advances, event steps, flag reads, wall seconds, wall ms per
   advance (median, p99) and peak device memory. Then the δ budget: a
   one-row pool on trace 0 streamed to the arrival of its 100th
   coflow, then 200 advances of one δ, wall ms per advance and its
   event steps printed beside δ = 8 ms (no gate);
17. the leaf-spine pool (`leafspine_pool`): 4 tenants on phase 8's
   parity shape, fb_like_trace(48, 150, seed=0..3), under
   `LeafSpine(4, 4.0, "maxmin")`, streamed as in 16, bit for bit the
   port's offline `run` of the same traces on the card, K1 = K2 = K3 =
   the event steps; a fifth tenant under the Aalo-queue ablation
   (`per_flow_threshold=False`) against its offline replay bit for bit
   (its float byte sums add in the JAX package's order through K6,
   whatever the slab's padding);
18. the learned fleet (`learned_main_path`): phase 4's 16 traces through
   `run(Scenario(..., clairvoyance=False))`, counters as in 4 (K1 = K2 =
   the event steps, K3 = K4 = K5 = 0), every coflow finished and byte
   delivered; lanes 0 and 1 (and a replay of those two alone, for the
   event count) with the JAX package's events and within 1% of its avg
   CCT (`tests/data/torch_port_learned_golden.json`); the leaf-spine
   pair fb_like_trace(48, 150, seed=0/1) learned under `LeafSpine(4,
   4.0, "maxmin")` against the same golden, K3 = the event steps; the
   three heaviest captured ticks of the fleet (as phase 6) and of the
   pair (as phase 9, rates bit for bit), each carrying the pilot
   estimate, with K1-K3 against the plain versions (fig_sampling's
   lanes are held to the same golden in 23);
19. the serving front door (`server_main_path`): `CoflowServer(
   SchedulerParams(), num_ports=150, max_tenants=8, features=(True,
   True, False, False, True))`, 12 tenants registering in turn
   (registrants 9-12 meet `AdmissionError` until evictions free rows),
   tenant i streaming fb_like_trace(128, 150, seed=100 + i) (the FB
   width, cut in depth from 526 coflows to keep the phase short), even
   tenants known, odd ones learned, tenants 10 and 11 under a
   `TenantQuota` (reject, defer with an SLO) that sheds; arrivals before
   the new clock submitted before each 16 δ advance (1 s advances once
   no tenant has arrivals left), polls, evictions of drained tenants
   and the next registration. Tenants without a quota equal the port's
   offline `run` of their traces on the card: known bit for bit, learned
   at ROADMAP C9's bar (rtol 1e-2, atol 2δ, the differing count
   printed); the quota tenants' shed and deferred counts are positive,
   every coflow is completed or shed once; K1 = K2 = the session loops'
   event steps, K3 = K4 = K5 = 0; the three heaviest ticks captured in
   the session loops (every 64th, as in phase 4; the slab's shape, known
   and learned rows together) with K1 and K2 against the plain versions
   as in phase 6; wall, advances, wall ms per advance (median, p99),
   `pool.io` and peak device memory (the captured ticks' clones
   included) printed. Phases 7 and 16-19 hold K6's launches and rows
   to the steps their runs took, as 4 does;
20. K6 (the engine's prefix sums, in the JAX package's scan order)
   against `prefix_sum_ref` bit for bit on seeded rows of
   `PREFIX_LENGTHS` (zeros and magnitudes from 1 to 1e9) and on rows
   of `NEG_ZERO_LENGTHS` with runs of -0.0 at the front and across the
   block and tile boundaries (no -0.0 may come out), and its time
   on phase 4's grouped segment-sum input (3 sums x 16 lanes), on its
   first sum's 16 rows alone and on phase 7's grouped input (5 sums),
   each beside the plain version's, `torch.cumsum`'s (timed here only)
   and the bound, with its CUDA launches and host time a call;
21. the port's drivers at their defaults (`drivers_phase`):
   `benchmarks/torch_pool_throughput.py` (its bitwise and single-upload
   gates; the speedup printed beside the reference's 4.0, read and not
   gated; `--no-cold`, the kernels built in 1 and loaded by the earlier
   phases), Table 2's rows (a), (b) and (c) and `torch_api_smoke.py`;
22. the event-driven host plane (`host_plane_phase`): fb_like_trace(526,
   150, seed=0) through `torch_common.Bench(quick=False).run(p,
   engine="numpy")` on the card for each of the nine registry policies
   (the replays phase 23's fig9 reads from the bench's cache for its
   host baselines), each in a spawned worker process of its own, all at
   once beside the CPU replays of saath and lwtf (the walls printed are
   those of concurrent replays), counters set to 0 just before each
   replay and read just after: every coflow finished and byte
   delivered; the eight host
   policies take the golden's steps
   (`tests/data/torch_port_numpy_golden.json`, the JAX package's numpy
   engine on the CPU) with avg CCT within 1e-9 relative, `saath-torch`
   the golden's `saath-jax` steps and avg CCT within 1%; the count of
   CCTs differing from the golden printed; K1 = the steps for saath,
   lwtf and saath-torch (K2 too for saath-torch), 0 for the rest, and no
   other kernel; host<->device bytes a step, wall ms a step and the
   kernel builds printed with the card's name and power limit; saath's
   and lwtf's replays on the card bit for bit their `device="cpu"`
   replays; K1 bit for bit its plain version on the five
   heaviest captured incidences, and its time on the heaviest beside the
   plain version's, one bf16 matmul form's and the bound; Aalo's avg
   and p90 CCT over Saath's;
23. the paper's figure drivers (`figures_phase`), each through its own
   `run(bench, engine="torch")` on the card, counters set to 0 just
   before each and read just after: `benchmarks/torch_fig9_speedup.py`
   at `torch_common.FULL` (fb_like_trace(526, 150, seed=0): Saath on
   the torch engine against Aalo, Varys-SEBF, UC-TCP, FIFO and
   `saath-torch` on the host plane, phase 22's replays, then the
   32-trace fleet with its wall-clock gate at `SAATH_FLEET_MIN_SPEEDUP`,
   default 5.0, over host-only sequential replays), then at `QUICK`
   (fb_like_trace(240, 100, seed=0)) fig2, fig3, fig10, fig11, fig13,
   fig14, fig_oversub and fig_sampling at once, each in a spawned
   worker process on a bench cache of its own; every gate of the reference's
   drivers holds as written (a failed one fails the phase); each
   driver's wall and K1, K2, K6 launches printed; K3, K4, K5 0. Each
   driver runs under `capture_ticks` (every `FIGURE_CAPTURE_EVERY`-th
   tick) and `capture_contention`: the three heaviest captured ticks of
   each of its tick shapes (lanes x coflows, fill, structure switches)
   go through `compare_ticks` (K1, K2, K6 against the plain versions on
   those inputs), and K1 equals its plain version bit for bit on the
   five heaviest card incidences it saw; the deviations go into the
   kernels line. The rows are held to references: fig9's Saath row
   bit for bit phase 4's lane 0 (the same trace and params) and within
   phase 5's 1% of the JAX package's golden; the fleet's batched
   fidelity replay bit for bit a `device="cpu"` replay of the same
   scenario (steps, CCTs; that CPU replay in a worker process while the
   other drivers run); the QUICK Saath row and fig_sampling's three
   torch lanes (known, learned, aalo-like on fb_like_trace(240, 100,
   seed=0); the driver's gate holds learned ahead of aalo-like) at the
   JAX package's event counts and within 1% of its avg CCTs
   (`LEARNED_GOLDEN`'s `fig_sampling`, phase 18's bar), and a sweep
   over [known, learned] whose known row is bit for bit the driver's
   known lane. The
   fleet's sequential replays are also timed with Saath's K1 on the
   card, and both walls printed;
24. the runtime bridge (`bridge_phase`): `repro_torch.runtime.
   coflow_bridge.plan_waves` on the bridge workload of
   `tests/test_session.py` (`bridge_workload()` of
   `examples/multi_tenant_fabric_torch.py`, the port's one copy) with
   the torch backend on the card (counters set to 0 just before, read
   just after: K1 and K2 launched), every tick captured and the three
   heaviest held to the plain versions as in phase 6; its waves equal
   to the numpy backend's and the reference's; the planner's ms a call
   (median of 20); then `runtime.overlap.scheduled_psum` over an NCCL
   world of 1 (rendezvous through an in-memory `HashStore`) on a
   6-layer tree of card tensors, its buckets planned by `plan_waves`:
   every value back unchanged, the all-reduces issued in wave order;
25. the analysis plane (`analysis_phase`, `repro_torch.analysis`): one
   tick, one session step and a session advance to 64 ticks of phase
   4's fleet on each fabric (big switch, and phase 7's leaf-spine) under
   the op scan (`analysis.op_scan`): no f64 site, no host sync or
   transfer in the step, the loop's counted flag-read crossings equal to
   the flag reads it reports, every `kernel:*` entry equal to its
   launch counter over the run, and the card's op histogram of a tick
   printed; the audit's seven entry points on the canonical slab
   (`analysis.audit`) with the same checks and their kernel calls equal
   to the CPU's manifest (`analysis/torch_dispatch_manifest.json`);
   then a 16-tenant `SessionPool` at phase 16's width (each tenant
   submits its trace's first `ANALYSIS_COFLOWS` coflows up front) and an
   8-row `CoflowServer` configured as phase 19's (known and learned
   tenants), each warmed by `ANALYSIS_WARM` advances of 16 δ with polls,
   then `ANALYSIS_GUARDED` more that set the card's peak of allocated
   memory and `ANALYSIS_GUARDED` more under `assert_no_recompiles()` and
   `assert_no_transfers()` (`guarded`): nothing raises (no build, no
   higher peak), no slab byte is uploaded,
   and the guard's counted downloads equal the `io` ledger's (one byte a
   flag read, `loop_reads`; the pool's download and control bytes);
   negative controls, each of which must raise inside its guard (an
   unaccounted `engine.host_to_device`, a bare `.to("cuda")`, an
   unaccounted `.cpu()`, and a first K1 call in a fresh child process
   with an empty build directory, a build); which pulls and uploads the
   dispatch mode sees and which it does not (printed); and the
   interleaving explorer (`analysis.explore`) with `ANALYSIS_SCHEDULES`
   schedules on the card: 0 divergences. K1, K2, K6 and K3 are held to
   their plain versions (`hold_kernels`) on the ticks captured from the
   audit's entry points, the pool's and server's warm advances and the
   explorer's pools; the phase's launches (not those of the holds) are
   the kernels line's `analysis` path;
26. K5 at MLA's widths (D_qk, D_v) = (192, 128) against
   `flash_attention_ref` on `MLA_CASES` (the smoke heads, a chunk at
   q_offset 250 against T > S, a ragged S against T > S, 16 heads of
   300 rows), f32 and bf16, causal and not, at the reference's bars
   (atol 2e-6 f32, 2e-2 bf16), printing max |o| beside max |Δo|
   (ROADMAP C8); then at DeepSeek-V2's prefill shape (4, 128, 128,
   1000, 1000, 192, 128) and at Qwen3-MoE's (G = 16) and Jamba's (G = 4)
   GQA prefill shapes, f32 and bf16, each with its time beside the
   plain version's, SDPA's (null with the error when no backend of the
   install takes the shape) and the bound, with TFLOP/s and the bound
   share (`attention_shape_record`); K4 at Jamba's Mamba prefill shape
   (4, 1000, 128, G = 1, 64, N = 16, lc = 128) against `ssd_chunked_ref`
   at phase 10's bar, f32 and bf16, with its time beside the plain
   version's and the bound. These go under `shapes` of K5's and K4's
   records in the kernels line;
27. as 11 for the three MoE-bearing models (`MOE_GOLDENS`): published
   widths, depth and routed experts cut as each golden's `config_cuts`
   say (Qwen3-MoE 2 layers, 16 of 128 experts; DeepSeek-V2 2 layers,
   the dense one and an MoE one, 16 of 160 routed experts and both
   shared; Jamba one period of 8 layers, 4 of 16 experts), the default
   capacity factor 1.25 (the routers drop pairs), f32, weights from
   `numpy_params(cfg, seed=0)`, against
   `tests/data/torch_port_{qwen3_moe,deepseek_v2,jamba}_golden.json`:
   K4 once per Mamba layer and K5 once per attention layer, top-8
   logits to atol 2e-3, tokens equal (the tie rule), per-layer cache
   norms (k/v, ckv/krope, ssd) to rtol 1e-4;
28. as 12 for the three serve main paths at their published widths
   with every expert, bf16, seed-0 weights from `lm.init_model` on the
   card, depth cut to keep at least one whole period
   (`MOE_SERVE_LAYERS`: Qwen3-MoE 4 layers, DeepSeek-V2 4 (the dense
   one and 3 MoE), Jamba 8), served by `ServeSession(arch, model=...)`:
   4 prompts of 1000 tokens and 64 greedy tokens, counters as in 12 (K5
   = 4, 4, 1 and K4 = 0, 0, 7 per prefill, every other kernel 0);
   prefill ms, decode ms per token, tokens/s and peak memory (the depth
   cut makes the host's share larger than in a deployment); then, the
   bf16 model freed, the f32 pair at one period's depth (1, 2 and 8
   layers) with the plain prefill path and with the kernels; then a
   bf16 pair of DeepSeek-V2 at 2 layers (weights from `lm.init_model`),
   the plain attention against K5 (192, 128), logits to atol 0.1;
29. training (`train_phase`): K7 (the attention backward: softmax
   statistics, dk and dv, dq, and the head split's sum; three or four
   launches counted as one call) against `flash_attention_bwd_ref` at
   every (D, Dv) pair of `flash_attention_bwd.WIDTHS`, f32 and bf16, causal
   and not, q_offset 0 and a chunk at q_offset 113 against T > S
   (`K7_CASES`), each gradient within `K7_BAR` of its largest magnitude
   (1e-5 f32, 2e-2 bf16) and a second call bitwise equal to the first;
   each instance's registers, shared memory and blocks an SM
   (`k7_resources`); then at StarCoder2-3B's train shape (4, 24, 2,
   2048, 2048, 128) and DeepSeek-V2's MLA shape (4, 128, 128, 1000,
   1000, 192, 128), f32 and bf16, with its time beside the plain
   version's, the backward of SDPA through `torch.autograd.grad` (null
   with the error where no backend takes the shape), the bound
   (`k7_bound_ms`) and each gradient's largest difference and
   magnitude (ROADMAP C14); the train
   golden (`train_golden`, `tests/data/
   torch_port_train_starcoder2_golden.json`, the JAX package on the
   CPU): StarCoder2-3B at its published width, 2 layers, f32, 3 AdamW
   steps of batch 2 x 128 from `numpy_params(seed=0)`, with K5 + K7 and
   with `force="ref"`: losses rtol 1e-5, grad norms rtol 1e-4, every
   master leaf's norm rtol 1e-5; the main train path:
   `train("starcoder2-3b", smoke=False, device="cuda")`, 30 layers,
   bf16 on f32 masters, AdamW, 20 steps of 4 x 2048 tokens with the
   gradient buckets planned by the Saath bridge, counters set to 0 just
   before and read just after: the loss falls by the reference's bar
   (mean of the last 5 below the mean of the first 5 minus 0.05), each
   step launches K5 2 x layers times (remat recomputes the forward) and
   K7 once a layer, the plan K1, K2 and K6 once a wave and nothing else
   runs; ms a step, tokens/s, peak memory and the plan's waves printed;
   a bf16 pair (2 layers, 4 x 2048 tokens: loss within 2e-2 and every
   gradient leaf's norm within rtol 2e-2 of the plain attention's); and
   `test_checkpoint_restart_bitwise` on the card at the smoke config
   (20 steps, a checkpoint every 6, the one at 18 deleted, resumed from
   12: losses equal at rtol 1e-6);
30. the catalog's other dense models and its encoder-decoder
   (`dense_phase`): K5 at `DENSE_K5`'s shapes (Gemma-7B's prefill (4,
   16, 16, 1000, 1000, 256) on the (256, 256) instance, causal;
   SeamlessM4T's encoder (4, 16, 16, 1000, 1000, 64) and its cross
   attention (4, 16, 16, 16, 1000, 64), non-causal; DeepSeek-Coder-33B's
   (4, 56, 8, 1000, 1000, 128), G = 7, causal), f32 and bf16, against
   `flash_attention_ref` (atol 2e-6 f32, 2e-2 bf16) with its time beside
   the plain version's, SDPA's and the bound (`attention_shape_record`,
   under K5's `shapes`); as 11 for the five at their published widths, 2
   layers (SeamlessM4T 2 + 2, with the golden's 2 x 300 frames), f32,
   against `tests/data/torch_port_<arch>_golden.json` (k/v and
   cross_k/cross_v cache norms); as 12 for each at its published width
   and depth in bf16 through `ServeSession(arch, smoke=False)`, one after
   another, each freed before the next: 4 prompts of 1000 tokens
   (SeamlessM4T: 4 x 16 decoder tokens against 4 x 1000 frame embeddings,
   the audio front end's stub) and 64 greedy tokens, K5 = 28, 30, 62, 48
   and 36 launches per prefill (`DENSE_K5_LAUNCHES`; SeamlessM4T: 12
   encoder layers, 12 self and 12 cross attentions), every other kernel
   0; prefill ms, decode ms per token, tokens/s and peak memory, no f32
   re-run (DeepSeek-Coder-33B and Chameleon-34B fill the card in bf16);
   then a bf16 pair of each at 4 layers (SeamlessM4T 4 + 4) from
   `lm.init_model`, the plain attention against K5, logits within C5's
   0.1, Gemma-7B's (tied embedding) each w within 0.1 + 2^-6 (|w| + the
   RMS of its row) (ROADMAP C15);
31. training through the Mamba mixer and the encoder (`train_ssm_phase`):
   K8 (the SSD scan's backward: each chunk's state updates and G, the
   state pass, every chunk's gradients with its split of the group's
   heads summed in the block, the splits' sums; four launches counted
   as one call) against `ssd_chunked_bwd_ref` at
   `SSD_CASES`, Mamba2-1.3B's train shape (4, 2048, 64, G 1, 64, N 128,
   lc 128) and Jamba's microbatch shape (1, 1024, 128, 1, 64, 16, 128),
   f32 and bf16, each gradient (da included) within K4's bar, atol 5e-4
   of its largest magnitude (`ssd_err`), a second call bitwise equal;
   its time at the two train shapes beside the plain version's and the
   bound (`ssd_bwd_bound_ms`; library null), with its workspaces'
   bytes; K5 and K7 non-causal at SeamlessM4T's cross attention in
   training (1, 16, 16, 2048, 32, 64), S > T under one key tile; the
   train goldens (`SSM_GOLDENS`, the JAX package on the CPU:
   Mamba2-1.3B, 2 layers, 2 x 256 tokens; SeamlessM4T-medium, 2 + 2
   layers, 4 x 128 tokens against 32 frames; published widths, f32, 3
   AdamW steps) with the kernels and with `force="ref"`: losses rtol
   1e-5, grad norms 1e-4, every master leaf's norm 1e-5; the three main
   train paths through `train(arch, smoke=False, device="cuda")`
   (`SSM_TRAIN`: Mamba2-1.3B, 48 layers, 4 x 2048; Jamba one period of 8
   layers with 2 of its 16 routed experts, top-2 kept, 8 microbatches of
   1 x 1024, bf16 moments; SeamlessM4T 12 + 12 layers, 4 microbatches
   of 1 x 2048 against 32 frames), bf16 on f32 masters, AdamW,
   `SSM_TRAIN_STEPS` steps with the coflow plan, counters set to 0 just
   before and read just after: the loss falls by the reference's bar,
   each step launches `train_launches` (K4 twice and K8 once a Mamba
   layer, K5 twice and K7 once an attention, per microbatch) and the
   plan K1, K2 and K6, and nothing else; ms a step, tokens/s and peak
   memory; then bf16 pairs (`ssm_bf16_pair`: 2 layers, SeamlessM4T 2 +
   2, Jamba the main path's period and experts; loss within 2e-2, leaf
   norms rtol 2e-2, Jamba's layer by layer on the same input, and its
   whole stack in f32 at rtol 1e-4).

Each phase prints its seconds (`[n] phase seconds`).

Kernel times are device times (`cuda_ms`: a sleep kernel holds the
stream while the timed calls queue, so a kernel faster than its
wrapper's host work does not read as that host work). Prints a
`{"kernels": [...]}` line (`launches` = launches over the
twenty-three main-path runs, split by path in `launches_by_path`, the
three train paths of phase 31 summed under `train_ssm`; K4's, K5's,
K6's, K7's and K8's records also list further timed shapes under
`shapes`, K7's and K8's their train paths' step times under `train`),
the script's wall, the nvidia-smi line, and as the last line `{"ok":
true, "device": {...}}`.
Any failed phase exits non-zero before the result lines. Exits non-zero
without a CUDA device.

`python3 chip_smoke.py --profile` adds one profiled chunk of each fleet
path (`profile_chunk`) and one profiled prefill and 16 decode steps of
each serve path (`profile_serve`) and one profiled warm train step
of StarCoder2-3B and of Mamba2-1.3B (`profile_train`): wall time per
event step, prefill, token or train
step, device busy share, kernel launches and the kernels with the most
device time.
"""
import concurrent.futures
import contextlib
import dataclasses
import io
import json
import multiprocessing
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_port_fb_golden.json"
LEAF_GOLDEN = ROOT / "tests" / "data" / "torch_port_leafspine_golden.json"
MAMBA_GOLDEN = ROOT / "tests" / "data" / "torch_port_mamba2_golden.json"
ATTN_GOLDEN = ROOT / "tests" / "data" / "torch_port_starcoder2_golden.json"
LEARNED_GOLDEN = ROOT / "tests" / "data" / "torch_port_learned_golden.json"
# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12     # non-tensor f32; used for 32-bit word ops too
BF16_OPS_PER_S = 989e12   # bf16 on the tensor cores
# the SFUs' exps: 16 a clock an SM (the CUDA programming guide's
# throughput table, compute capability 9.0) x 132 SMs x 1.98 GHz boost
SFU_OPS_PER_S = 16 * 132 * 1.98e9
SM_HZ = 1.98e9            # boost clock: turns a hold time into sleep cycles
FLEET = 16
COFLOWS, PORTS = 526, 150
PARITY_COFLOWS = 48
CAPTURE_EVERY = 64
# the block barriers of one max-min round in csrc/maxmin.cu: after the
# row update, levels and least level; after the saturated rows' lists
MAXMIN_STEPS_PER_ROUND = 2
SERVE_ARCH = "mamba2-1.3b"
# (B, L, H, G, Dh, N, lc): tests/test_kernels.py's SSD sweep, then the
# serve shape (4 prompts of 1000 tokens padded to 1024, Mamba2-1.3B heads)
SSD_CASES = [(1, 16, 1, 1, 8, 8, 8), (2, 64, 4, 2, 16, 32, 16),
             (1, 128, 2, 1, 32, 64, 64), (1, 256, 8, 2, 64, 128, 128)]
SSD_SERVE = (4, 1024, 64, 1, 64, 128, 128)
SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS = 4, 1000, 64
ATTN_ARCH = "starcoder2-3b"
# (B, H, Hkv, S, T, D, q_offset): tests/test_kernels.py's attention sweep,
# its chunked-prefill offset, a ragged S against T > S, at D = 128 G = 12
# with S and T no multiple of 128 and a chunk against T > S; then the
# serve shape (4 prompts of 2000 tokens, StarCoder2-3B heads)
FLASH_CASES = [(1, 1, 1, 16, 16, 32, 0), (2, 4, 2, 64, 64, 64, 0),
               (1, 8, 1, 32, 32, 128, 0), (1, 2, 2, 40, 40, 64, 0),
               (1, 2, 2, 32, 64, 32, 32), (2, 4, 2, 23, 40, 32, 17),
               (1, 24, 2, 300, 300, 128, 0), (2, 8, 2, 150, 400, 128, 250)]
FLASH_SERVE = (4, 24, 2, 2000, 2000, 128, 0)
ATTN_BATCH, ATTN_PROMPT, ATTN_TOKENS = 4, 2000, 64
# phases 26-28: the MoE, MLA and hybrid architectures
MOE_ARCHS = ("qwen3-moe-235b-a22b", "deepseek-v2-236b", "jamba-v0.1-52b")
# (B, H, Hkv, S, T, D, Dv, q_offset): K5 at MLA's widths (192, 128): the
# smoke heads, a chunk at q_offset 250 against T > S, a ragged S against
# T > S, 16 heads of 300 rows; then DeepSeek-V2's prefill shape (4
# prompts of 1000 tokens, 128 heads)
MLA_CASES = [(1, 2, 2, 16, 16, 192, 128, 0), (2, 4, 2, 150, 400, 192, 128, 250),
             (2, 4, 4, 23, 40, 192, 128, 17), (1, 16, 16, 300, 300, 192, 128, 0)]
MLA_SERVE = (4, 128, 128, 1000, 1000, 192, 128, 0)
# K5 at the GQA prefill shapes of Qwen3-MoE (G = 16) and Jamba (G = 4)
GQA_SERVE = {"qwen3-moe-235b-a22b": (4, 64, 4, 1000, 1000, 128, 128, 0),
             "jamba-v0.1-52b": (4, 32, 8, 1000, 1000, 128, 128, 0)}
# K4 at Jamba's Mamba prefill shape (N = 16; 1000 tokens, no padding)
SSD_JAMBA = (4, 1000, 128, 1, 64, 16, 128)
# phase 27's goldens (the JAX package on the CPU, published widths, depth
# and routed experts cut; tests/test_torch_lm_moe.py regenerates them)
# and the per-layer cache norms each holds ({golden field: cache key})
MOE_GOLDENS = {
    "qwen3-moe-235b-a22b": ("torch_port_qwen3_moe_golden.json",
                            {"k_cache_norm": "k", "v_cache_norm": "v"}),
    "deepseek-v2-236b": ("torch_port_deepseek_v2_golden.json",
                         {"ckv_cache_norm": "ckv",
                          "krope_cache_norm": "krope"}),
    "jamba-v0.1-52b": ("torch_port_jamba_golden.json",
                       {"k_cache_norm": "k", "v_cache_norm": "v",
                        "ssd_state_norm": "ssd"}),
}
# phase 28: bf16 depth (at least one whole period, all experts) and the
# f32 pair's depth (one period, the leading dense layer included)
MOE_SERVE_LAYERS = {"qwen3-moe-235b-a22b": (4, 1),
                    "deepseek-v2-236b": (4, 2),
                    "jamba-v0.1-52b": (8, 8)}
MOE_BATCH, MOE_PROMPT, MOE_TOKENS = 4, 1000, 64
TIE_GAP = 1e-3       # a greedy token may differ where top-2 is this close
LOGIT_ATOL = 2e-3    # the JAX package's prefill bar (test_arch_smoke.py)
BF16_LOGIT_ATOL = 0.1  # the bf16 logit bar (ROADMAP C5)
PAIR_STEPS = 8       # teacher-forced decode steps of the bf16 pair
POOL_DRAIN = 1.0     # seconds a drain advance of phases 16-17 moves
DELTA_ADVANCES = 200  # one-δ advances of phase 16's budget run
# phase 23's fig_sampling sweep trace (fig_sampling.py's bench shape)
FIG_COFLOWS, FIG_PORTS = 240, 100
# phase 19: tenants, rows and each tenant's trace depth
SERVER_TENANTS, SERVER_ROWS, SERVER_COFLOWS = 12, 8, 128
# phase 20: K6's row lengths (one tile, the chunk boundaries, the
# fleet's, and rows with a fourth level of totals)
PREFIX_LENGTHS = (1, 16, 17, 4095, 4096, 4097, 8193, 30016, 65537, 200_000)
# and the lengths of its rows with runs of -0.0 (ROADMAP C11)
NEG_ZERO_LENGTHS = (17, 4097, 30016, 65537)
# phase 22: the host plane's golden and its policies
NUMPY_GOLDEN = ROOT / "tests" / "data" / "torch_port_numpy_golden.json"
HOST_PLANE = ("saath", "aalo", "fifo", "scf", "srtf", "lwtf", "varys-sebf",
              "uc-tcp", "saath-torch")
# phase 22's worker processes: its eleven replays (the nine, two on the
# CPU) are single-threaded host loops, one a core of the card's host
HOST_WORKERS = 8
# the port's kernels by the names the profiler gives them
# K7's kernels, both instances (the head split's sum only when it splits)
K7_KERNELS = ("bwd_stats_sm90<", "bwd_dkdv_sm90<", "bwd_dq_sm90<",
              "bwd_stats_f32<", "bwd_dkdv_f32<", "bwd_dq_f32<", "bwd_sum<")
# K8's kernels
K8_KERNELS = ("ssd_bwd_states<", "ssd_bwd_pass(", "ssd_bwd_chunk<",
              "ssd_bwd_reduce<")
PORT_KERNELS = ("contention<", "tick_walk<", "maxmin<", "ssd_scan<",
                "ssd_gram<", "flash_fwd", "prefix_sum_kernel") + K7_KERNELS \
    + K8_KERNELS
# phase 21: the reference's pool-throughput gate (benchmarks/
# pool_throughput.py:236), read here, not gated
POOL_GATE = 4.0
# phase 23: the figure drivers in suite order (benchmarks/torch_run.py),
# then the two it does not run; fig9 at the FB width, the rest quick
FIGURES = ("fig9_speedup", "fig2_out_of_sync", "fig3_offline_policies",
           "fig10_breakdown", "fig11_bins", "fig13_fct_deviation",
           "fig14_sensitivity", "fig_oversub", "fig_sampling")
# phase 23: every how many ticks a driver's replays are captured
FIGURE_CAPTURE_EVERY = 16
# phase 24: the example that holds the bridge workload of
# tests/test_session.py, and the reference's wave plan of it
# (`repro.runtime.coflow_bridge.plan_waves`, jax and numpy backends)
BRIDGE_EXAMPLE = ROOT / "examples" / "multi_tenant_fabric_torch.py"
BRIDGE_WAVES = [["grad/0", "moe_a2a/0", "ckpt/upload"],
                ["grad/1", "moe_a2a/1", "kv/migrate"], ["reshard/params"],
                ["grad/2", "moe_a2a/2"], ["grad/3"], ["grad/4"], ["grad/5"]]
PLAN_REPS = 20
# phase 30: the catalog's other dense models and its encoder-decoder,
# served at their published widths and depths
DENSE_ARCHS = ("gemma-7b", "deepseek-7b", "deepseek-coder-33b",
               "chameleon-34b", "seamless-m4t-medium")
# K5 at their prefill shapes ((B, H, Hkv, S, T, D, Dv, q_offset), causal):
# Gemma-7B's 256-wide heads, SeamlessM4T's encoder and its cross attention
# (16 decoder rows against 1000 frames), DeepSeek-Coder-33B's G = 7
DENSE_K5 = {"Gemma-7B's prefill": ((4, 16, 16, 1000, 1000, 256, 256, 0), True),
            "SeamlessM4T's encoder": ((4, 16, 16, 1000, 1000, 64, 64, 0),
                                      False),
            "SeamlessM4T's cross attention": (
                (4, 16, 16, 16, 1000, 64, 64, 0), False),
            "DeepSeek-Coder-33B's prefill (G = 7)": (
                (4, 56, 8, 1000, 1000, 128, 128, 0), True)}
# K5 launches a prefill at the published depth (SeamlessM4T: 12 encoder
# layers, 12 decoder self-attentions, 12 cross attentions)
DENSE_K5_LAUNCHES = {"gemma-7b": 28, "deepseek-7b": 30,
                     "deepseek-coder-33b": 62, "chameleon-34b": 48,
                     "seamless-m4t-medium": 36}
# the goldens (the JAX package on the CPU, published widths, 2 layers,
# SeamlessM4T 2 + 2; tests/test_torch_lm_dense.py regenerates them)
DENSE_GOLDENS = {a: f"torch_port_{a.replace('-', '_')}_golden.json"
                 for a in DENSE_ARCHS}
# 4 prompts of 1000 tokens (SeamlessM4T: 16 decoder tokens against 1000
# frames, the audio front end's stub), 64 greedy tokens; the bf16 pairs'
# depth
DENSE_BATCH, DENSE_PROMPT, DENSE_TOKENS = 4, 1000, 64
SEAMLESS_PROMPT, SEAMLESS_FRAMES = 16, 1000
DENSE_PAIR_LAYERS = 4
# a tied embedding's bf16 logit bar beyond C5's 0.1: 2^-6 of (the plain
# logit's magnitude + its row's RMS) (ROADMAP C15: Gemma's tied
# unit-normal embedding gives logits of RMS ~sqrt(d_model), the last
# token's own ~d_model, where C5's 0.1 is under one bf16 step; a
# logit's error is the hidden state's dotted with the head's row, so it
# scales with the row's RMS)
BF16_STEPS_RTOL = 2 ** -6
# phase 29: training. K7 (the attention backward) at every width pair of
# K5 on (B, H, Hkv, S, T, q_offset) cases (two heads a KV head, q_offset
# 0; a chunk at q_offset 113 against T > S; G = 2 with ragged tiles),
# then StarCoder2-3B's train shape (4 x 2048 tokens) and DeepSeek-V2's
# MLA shape
K7_CASES = [(2, 4, 2, 100, 100, 0), (1, 2, 1, 37, 150, 113),
            (2, 6, 3, 130, 130, 0)]
K7_TRAIN = (4, 24, 2, 2048, 2048, 128, 128, 0)
K7_MLA = (4, 128, 128, 1000, 1000, 192, 128, 0)
# its bars, of each gradient's largest magnitude: f32 sums in another
# order; bf16 adds the rounding of the gradients to bf16 (2^-8)
K7_BAR = {"float32": 1e-5, "bfloat16": 2e-2}
TRAIN_GOLDEN = ROOT / "tests" / "data" / \
    "torch_port_train_starcoder2_golden.json"
# the main train path: StarCoder2-3B at its published width and depth
# (30 layers), bf16 on f32 masters, AdamW, batch x seq tokens a step
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 20
# phase 31: training through the Mamba mixer and the encoder. K8 (the SSD
# scan's backward) at SSD_CASES, Mamba2-1.3B's train shape (4 x 2048
# tokens) and Jamba's microbatch shape (1 x 1024 tokens, H 128, N 16);
# K4's bar, atol 5e-4 of each gradient's largest magnitude
SSD_BWD_TRAIN = (4, 2048, 64, 1, 64, 128, 128)
SSD_BWD_JAMBA = (1, 1024, 128, 1, 64, 16, 128)
SSD_BWD_ATOL = 5e-4
# the train goldens (the JAX package on the CPU, published widths, 2
# layers, SeamlessM4T 2 + 2; tests/test_torch_train_ssm.py regenerates
# them)
SSM_GOLDENS = {"mamba2-1.3b": "torch_port_train_mamba2_golden.json",
               "seamless-m4t-medium": "torch_port_train_seamless_golden.json"}
# the main train paths: (batch, seq, config cuts); bf16 on f32 masters,
# the configs' optimizers and microbatches, SSM_TRAIN_STEPS steps (the
# fewest the loss bar reads: the mean of the first 5 against the last 5).
# Jamba: one period (8 layers), routed experts cut from 16 to 2 (top-2
# kept), so that f32 masters, gradients and bf16 moments fit one card
SSM_TRAIN = {"mamba2-1.3b": (4, 2048, {}),
             "jamba-v0.1-52b": (8, 1024, {"num_layers": 8,
                                          "num_experts": 2}),
             "seamless-m4t-medium": (4, 2048, {})}
SSM_TRAIN_STEPS = 10
# the bf16 pairs' depth (Jamba: the main path's period and experts)
SSM_PAIR_CUTS = {"mamba2-1.3b": {"num_layers": 2},
                 "jamba-v0.1-52b": {"num_layers": 8, "num_experts": 2},
                 "seamless-m4t-medium": {"num_layers": 2, "enc_layers": 2}}


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def cuda_ms(fn, reps):
    """Mean device milliseconds of `fn` over `reps` back-to-back calls
    (CUDA events, after warm-up). A sleep kernel holds the stream while
    the calls are queued, for twice the host time they take to queue, so
    that the events time the device: a kernel faster than its wrapper's
    host work would otherwise read as that host work."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    queue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(min(2 * reps * queue_s, 2.0) * SM_HZ))
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def host_ms(fn):
    """Milliseconds of one synchronized call (for the slow plain walk)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def bound(nbytes, ops):
    """The least time (ms) for `nbytes` moved and `ops` f32 operations,
    and which of the two bounds it."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def contention_library(a_s, a_r, active):
    """One bf16 tensor-core product form of the contention count (the
    yardstick `library_ms`; the port never calls it)."""
    import torch

    act = active.to(torch.bfloat16).unsqueeze(-1)
    s, r = a_s * act, a_r * act
    blocks = (s @ s.mT + r @ r.mT) > 0.5
    k = blocks.sum(-1) - torch.diagonal(blocks, dim1=-2, dim2=-1).long()
    return torch.where(active, k, 0)


def contention_bound_ms(a_s, a_r, active):
    """Bytes: both incidences and `active` read once, the int32 counts
    written once. Operations: the fewer of two exact forms for these
    inputs, per lane with Ca active coflows: pairwise, an AND and an OR
    for each of 2 ceil(P/32) words of each of Ca^2 pairs; port-major,
    ceil(Ca/32) word ORs for each port of each active coflow plus
    ceil(Ca/32) popcounts a coflow (csrc/contention.cu's design)."""
    B, C, P = a_s.shape
    nbytes = 2 * B * C * P * a_s.element_size() + B * C + 4 * B * C
    act = active.bool()
    ca = act.sum(-1).long()
    ports = ((a_s != 0).sum(-1) + (a_r != 0).sum(-1)) * act
    words = (ca + 31) // 32
    pairwise = int((2 * ca * ca * 2 * ((P + 31) // 32)).sum())
    port_major = int((ports.sum(-1) * words + ca * words).sum())
    return bound(nbytes, min(pairwise, port_major))


def cuda_launches(tag, fn, reps=10):
    """CUDA kernels one call of `fn` launches, counted by torch.profiler
    over `reps` calls as the host's kernel-launch API calls, with the
    APIs' names and how many kernel records the device side delivered
    (a session late in a process can lose some of those). `fn` launches
    at least one kernel, so the phase fails if the profiler saw no launch
    or a count that `reps` does not divide."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    api = [e for e in rows if e.device_type != torch.autograd.DeviceType.CUDA
           and "Launch" in e.key and "Kernel" in e.key]
    n = sum(e.count for e in api)
    kern = sum(e.count for e in rows
               if e.device_type == torch.autograd.DeviceType.CUDA)
    if n == 0 or n % reps:
        fail(f"[{tag}] the profiler saw {n} kernel launches in {reps} calls")
    return (f"{n // reps} {sorted(e.key for e in api)} ({kern} kernel "
            f"records of {n} launches)")


def host_us(fn, reps=200):
    """Host microseconds one call of `fn` takes to queue its work: `reps`
    calls back to back, no synchronization between them."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / reps


def walk_bound_ms(args, out):
    """Bytes and operations this tick's data needs: the n_live rows of
    cnt, the missed coflows' flows (per-flow fill), the outputs."""
    import torch

    order, n_live, cnt, avail0, _, _, flows = args
    B, C, W = cnt.shape
    rate, admitted, _, wc_flow, _ = out
    nl = int(n_live.sum())
    nbytes = nl * (8 + 4 * W) + B * (8 + 8 * W + 8) + B * C * 9
    ops = nl * W * 5
    if wc_flow is not None:
        lead = torch.arange(C, device=cnt.device)[None] < n_live[:, None]
        missed = torch.zeros_like(admitted).scatter_(1, order, lead) \
            & ~admitted
        nf = int(((flows.flow_hi - flows.flow_lo) * missed).sum())
        per_flow = 17 + (16 if flows.up is not None else 0)
        nbytes += int(missed.sum()) * 16 + nf * per_flow \
            + wc_flow.numel() * 4
        ops += nf * 8
    return bound(nbytes, ops)


def walk_chain(args, out, admit_only):
    """K2's chain on its busiest lane, read off the inputs and outputs:
    one step per admission, per coflow-fill step (coflow mode), per
    window of 32 of the missed coflows' flows and per non-zero take
    (flow mode). Returns (steps, lane, {part: count})."""
    import torch

    order, n_live, cnt, _, _, wc, flows = args
    rate, admitted, _, wc_flow, _ = out
    gate = (wc > 0) & (not admit_only)
    parts = {"admissions": n_live.long()}
    if flows is None:
        parts["coflow fill"] = torch.where(gate, n_live, 0)
    else:
        C = cnt.shape[1]
        lead = torch.arange(C, device=cnt.device)[None] < n_live[:, None]
        missed = torch.zeros_like(admitted).scatter_(1, order, lead) \
            & ~admitted
        n = ((flows.flow_hi - flows.flow_lo) * missed).sum(-1)
        parts["flow windows"] = torch.where(gate, (n + 31) // 32, 0)
        parts["takes"] = torch.where(gate, (wc_flow != 0).sum(-1), 0) \
            if wc_flow is not None else torch.zeros_like(n)
    steps = sum(parts.values())
    b = int(steps.argmax())
    return int(steps[b]), b, {k: int(v[b]) for k, v in parts.items()}


def maxmin_work(args, rates):
    """What this input needs of the max-min fill, read off its result:
    candidates frozen in round k share the round's level, and the levels
    rise round by round, so the distinct candidate rates of a lane are
    its rounds and the flows still active in round k are those at or
    above its level. Returns (bytes, ops, most rounds of any lane)."""
    B, F = args["src"].shape
    W = args["avail"].shape[1]
    ops, rounds = 0, 0
    for b in range(B):
        v = rates[b][args["cand"][b]].sort().values
        levels, counts = v.unique_consecutive(return_counts=True)
        active = counts.flip(0).cumsum(0).flip(0)      # flows at >= level
        rounds = max(rounds, levels.numel())
        # per round: count + saturation test + freeze per active flow
        # (four row ids each), level and update per row
        ops += int(active.sum()) * 12 + levels.numel() * W * 6
    links = 16 if args["num_links"] else 0
    nbytes = B * F * (16 + links + 1 + 4) + B * W * 4
    return nbytes, ops, rounds


def profile_chunk(fleet, params, feats, topology, label, warm_chunks=8):
    """(`--profile` only) Where one chunk of a main path's time goes:
    replay `warm_chunks` chunks unprofiled, then one chunk of 128 event
    steps under torch.profiler. Prints the wall time per event step, the
    device's busy share (summed kernel time over wall time; one stream,
    so kernels do not overlap), kernel launches per step and the
    kernels with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fabric import engine as eng
    from repro_torch.traces.batch import pack, to_device

    dev = torch.device("cuda")
    tb = to_device(pack(fleet, port_bw=params.port_bw, topology=topology),
                   dev)
    ep = eng.EngineParams.from_scheduler(params, device=dev).lanes(len(fleet))
    state = eng._init_state(tb)
    for _ in range(warm_chunks):
        state = eng._run_chunk(state, tb, ep, chunk=128, features=feats)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = eng._run_chunk(state, tb, ep, chunk=128, features=feats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"[p] {label}: chunk of 128 event steps after {warm_chunks * 128}"
          f": wall {1e3 * wall / 128:.3f} ms per step (profiled)")
    report_profile(prof, wall, 128, "step")


def report_profile(prof, wall, steps, unit):
    """Device busy time per `unit` and its share of the wall time (one
    stream, so kernels do not overlap), kernel launches per unit, the
    kernels with the most device time and each of the port's kernels
    (`PORT_KERNELS`) with its share of the busy time, from a
    torch.profiler run of `steps` units that took `wall` seconds."""
    import torch

    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not rows:
        print("[p] device time: not measured (the profiler saw no CUDA "
              "kernels)")
        return
    busy_us = sum(e.self_device_time_total for e in rows)
    launches = sum(e.count for e in rows)
    print(f"[p] device busy {busy_us / 1e3 / steps:.3f} ms per {unit}, "
          f"share {busy_us / 1e6 / wall:.3f}; {launches / steps:.1f} kernel "
          f"launches per {unit}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[p]   {e.self_device_time_total / steps:9.1f} us/{unit} "
              f"{e.count / steps:6.1f} x  {e.key[:90]}")
    for e in rows:
        if any(k in e.key for k in PORT_KERNELS):
            t = e.self_device_time_total
            print(f"[p]   port kernel {e.key[:70]}: "
                  f"{t / steps:.1f} us/{unit} ({t / busy_us:.3f} of busy), "
                  f"{e.count / steps:.1f} launches per {unit}")
    return rows, busy_us


def profile_serve(sess, prompts, n_decode=16, src=None):
    """(`--profile` only) Where the serve path's time goes: one profiled
    prefill (of an encoder-decoder's frames `src` too), then `n_decode`
    profiled decode steps, each with its wall time, device busy share
    and top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import lm

    tokens = torch.as_tensor(prompts, device=sess.device)
    B, P = tokens.shape
    with torch.inference_mode():
        cache = lm.init_cache(sess.cfg, B, sess.max_len,
                              src_len=sess.src_len, device=sess.device)
        if src is not None:
            src = torch.as_tensor(src, device=sess.device)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            logits, cache = sess.prefill_fn(tokens, cache, src)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        print(f"[p] serve prefill {tuple(tokens.shape)}: wall "
              f"{1e3 * wall:.3f} ms (profiled)")
        report_profile(prof, wall, 1, "prefill")
        tok = logits[:, -1].argmax(-1)[:, None]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(n_decode):
                logits, cache = sess.decode_fn(tok, cache, P + i)
                tok = logits[:, -1].argmax(-1)[:, None]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        print(f"[p] serve decode, {n_decode} steps: wall "
              f"{1e3 * wall / n_decode:.3f} ms per token (profiled)")
        report_profile(prof, wall, n_decode, "token")


def profile_train(warm_steps=2, arch=ATTN_ARCH, batch=TRAIN_BATCH,
                  seq=TRAIN_SEQ, split=("K7", K7_KERNELS)):
    """(`--profile` only) Where the train step's time goes: `arch`
    (StarCoder2-3B unless given) at its published width, as its main
    train path runs it (bf16 on f32 masters, the config's optimizer,
    `batch` x `seq` tokens), `warm_steps` steps unprofiled, then one step
    under torch.profiler: its wall time, device busy share, the kernels
    with the most device time and each of the port's kernels with its
    share of the busy time, and the total a step of the kernel `split`
    names (K7 unless given), split by launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import steps as ST
    from repro_torch.models import lm
    from repro_torch.optim import make_optimizer

    dev = torch.device("cuda")
    cfg = get_config(arch)
    params = lm.init_masters(cfg, seed=0, device=dev)
    opt = make_optimizer(cfg, total_steps=warm_steps + 1,
                         groups=lm.reference_groups(cfg, list(params)))
    opt_state = opt.init(params)
    step_fn = ST.make_train_step(cfg, opt)
    data = SyntheticLMData(cfg.vocab_size, seq, batch, seed=0,
                           d_model=cfg.d_model, device=dev)

    def rows(step):
        tokens = data.batch(step)["tokens"]
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    for step in range(warm_steps):
        params, opt_state, _ = step_fn(params, opt_state, step, rows(step))
    b = rows(warm_steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, warm_steps, b)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"[p] {arch} train step of {cfg.num_layers} layers, {batch} x "
          f"{seq} tokens, after {warm_steps}: wall {1e3 * wall:.3f} "
          f"ms (profiled)")
    got = report_profile(prof, wall, 1, "step")
    if got is not None:
        found, busy_us = got
        name, keys = split
        ks = [e for e in found if any(k in e.key for k in keys)]
        t = sum(e.self_device_time_total for e in ks)
        print(f"[p] {name} a step: {t / 1e3:.3f} ms, {t / busy_us:.3f} of "
              f"busy ({sum(e.count for e in ks)} kernel launches); by "
              f"launch: "
              + ", ".join(f"{e.key.split('<')[0].split('::')[-1].split('(')[0]} "
                          f"{e.self_device_time_total / busy_us:.3f}"
                          for e in sorted(ks, key=lambda e:
                                          -e.self_device_time_total)),
              flush=True)
    del params, opt_state, step_fn, prof
    torch.cuda.empty_cache()


@contextlib.contextmanager
def capture_ticks(every=CAPTURE_EVERY):
    """While the block runs, clone the inputs of every `every`-th call
    of `tick_core` (the replay's and the session loop's alike) into
    the list it yields, for `compare_ticks`, each with the inputs of the
    segment sums (`ops.prefix_sum`, K6) the engine took since the tick
    before it (this step's views, the last step's completions)."""
    from repro_torch.core import coordinator as co
    from repro_torch.kernels import ops

    captured, calls, sums = [], [0], []
    real_tick_core, real_prefix = co.tick_core, ops.prefix_sum

    def spy(state, batch, now, dp, **kw):
        if calls[0] % every == every // 2:
            clone = (lambda t: None if t is None else
                     type(t)(*(None if x is None else x.clone()
                               for x in t)))
            captured.append((clone(state), clone(batch), now.clone(),
                             clone(dp), clone(kw.get("flows")),
                             kw.get("wc_fill", "greedy"),
                             [x.clone() for x in sums]))
        calls[0] += 1
        sums.clear()
        return real_tick_core(state, batch, now, dp, **kw)

    def prefix_spy(x, **kw):
        sums.append(x)
        return real_prefix(x, **kw)

    co.tick_core, ops.prefix_sum = spy, prefix_spy
    try:
        yield captured
    finally:
        co.tick_core, ops.prefix_sum = real_tick_core, real_prefix


def segment_sums_per_step(features, leafspine):
    """The segment sums one event step of `engine._tick` takes under the
    structure switches `features`: the sender and receiver live counts
    and the completions' undone count; the uplink and downlink counts on
    a leaf-spine batch; the live flows per coflow (§4.3 re-queue, either
    form); the pilot count and byte sum (learned sizes); the total bytes
    and the rate sum (ablations)."""
    _, dyn, abl, _, samp = tuple(features) + (False,) * (5 - len(features))
    return 3 + 2 * bool(leafspine) + bool(dyn or samp) + 2 * bool(samp) \
        + 2 * bool(abl)


def prefix_calls_per_step(features):
    """The K6 calls one event step makes: the step's independent sums in
    one, the completions' undone count, and the ablations' rate sum."""
    abl = (tuple(features) + (False,) * 5)[2]
    return 2 + bool(abl)


def add_sums(total, steps, tb, features):
    """Add `steps` event steps of batch `tb` under `features` to the K6
    calls and rows of `total`."""
    leaf = tb.bw_up.shape[-1] > 0
    total["calls"] += steps * prefix_calls_per_step(features)
    total["rows"] += steps * tb.cid.shape[0] * segment_sums_per_step(
        features, leaf)


@contextlib.contextmanager
def expected_sums():
    """While the block runs, add up what the K6 counters must read for
    its event steps (each offline chunk and each session loop): K6 calls
    (`prefix_calls_per_step` a step) and rows summed (the segment sums of
    a step times the batch's lanes); yields the dict of both."""
    from repro_torch.fabric import engine as eng

    total = {"calls": 0, "rows": 0}
    real_chunk, real_advance = eng._run_chunk, eng.session_advance

    def chunk_spy(state, tb, ep, *, chunk, features):
        add_sums(total, chunk, tb, features)
        return real_chunk(state, tb, ep, chunk=chunk, features=features)

    def advance_spy(state, tb, ep, **kw):
        out = real_advance(state, tb, ep, **kw)
        add_sums(total, out[1], tb, kw.get(
            "features", (True, True, False, False, False)))
        return out

    eng._run_chunk, eng.session_advance = chunk_spy, advance_spy
    try:
        yield total
    finally:
        eng._run_chunk, eng.session_advance = real_chunk, real_advance


def check_sums(tag, counts, expected):
    """K6 must have launched once for each call the run's steps make,
    and summed the rows of every segment sum of every lane."""
    if counts["prefix_sum"] != expected["calls"]:
        fail(f"[{tag}] prefix_sum launched {counts['prefix_sum']} times for "
             f"{expected['calls']} calls of the run's steps")
    if counts["prefix_sum_rows"] != expected["rows"]:
        fail(f"[{tag}] K6 summed {counts['prefix_sum_rows']} rows for the "
             f"run's {expected['rows']} segment-sum rows")
    print(f"[{tag}] K6 launches {counts['prefix_sum']} = the run's calls, "
          f"rows summed {counts['prefix_sum_rows']} = its segment sums x "
          f"lanes")


def drive(tag, sc, fleet, coflows=COFLOWS):
    """Run scenario `sc` (the traces `fleet`, `coflows` coflows each) with
    every launch counter set to 0 just before and read just after,
    capturing every CAPTURE_EVERY-th tick's inputs; check that every real
    coflow finished and every byte arrived. Returns (result, launch
    counts, captured ticks)."""
    import torch

    from repro_torch.api import run
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with capture_ticks() as captured, expected_sums() as sums:
        ops.reset_launches()
        try:
            res = run(sc)
        finally:
            counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tag}] fleet of {len(fleet)} x fb_like_trace({coflows}, "
          f"{PORTS}), topology {sc.topology}: events {res.events}, ticks "
          f"{res.ticks}, wall {res.wall_seconds:.3f} s, peak device memory "
          f"{peak / 2**20:.1f} MiB, launches {counts}")
    print("    avg CCT per lane: " + " ".join(f"{x:.6f}"
                                               for x in res.avg_cct))
    for b, tr in enumerate(fleet):
        cct = res.row_cct(b)
        if cct.shape != (len(tr.coflows),) or not (cct > 0).all():
            fail(f"[{tag}] lane {b}: unfinished or non-positive CCTs")
        t = res.table(b)
        if abs(t.sent.sum() - t.size.sum()) > 1e-5 * t.size.sum():
            fail(f"[{tag}] lane {b}: bytes delivered differ from the "
                 f"trace's")
    check_sums(tag, counts, sums)
    return res, counts, captured


def compare_ticks(tag, captured, exact_rates, learned=False):
    """The heaviest captured ticks with the kernels against the plain
    versions; with `learned`, each must carry the pilot estimate
    (`s_mixed`, `s_m`). Returns ({kernel: (args, kwargs) of its last
    launch}, {kernel: max abs error})."""
    import torch

    from repro_torch.core import coordinator as co
    from repro_torch.kernels import ops

    def work(c):
        return int(c[1].active.sum())

    heavy = sorted(captured, key=work)[-3:]
    n_sums = 0
    if not heavy:
        fail(f"[{tag}] no tick was captured")
    if learned and any(c[1].s_mixed is None or c[3].clairvoyant is None
                       for c in heavy):
        fail(f"[{tag}] a captured tick carries no pilot estimate")
    grabbed = {}
    names = ("contention", "tick_walk", "maxmin_rates")
    real_ops = {n: getattr(ops, n) for n in names}

    def grab(name, fn):
        def f(*a, **k):
            if k.get("force") is None:
                grabbed[name] = (a, {x: v for x, v in k.items()
                                     if x != "force"})
            return fn(*a, **k)
        return f

    err = {n: 0.0 for n in (*names, "prefix_sum")}
    for i, (st, batch, now, dp, flows, fill, sums) in enumerate(heavy):
        for x in sums:
            got_s, want_s = ops.prefix_sum(x), ops.prefix_sum(x, force="ref")
            torch.cuda.synchronize()
            if not torch.equal(got_s.view(torch.int32),
                               want_s.view(torch.int32)):
                fail(f"[{tag}] captured tick {i}: K6 differs from its plain "
                     f"version on a {tuple(x.shape)} segment-sum input")
            err["prefix_sum"] = max(err["prefix_sum"], abs_err(got_s, want_s))
            if "prefix_sum" not in grabbed or \
                    x.shape[0] > grabbed["prefix_sum"][0][0].shape[0]:
                grabbed["prefix_sum"] = ((x,), {})   # the grouped call
            n_sums += 1
        for n in names:
            setattr(ops, n, grab(n, real_ops[n]))
        try:
            _, got = co.tick_core(st, batch, now, dp, flows=flows,
                                  wc_fill=fill)
        finally:
            for n in names:
                setattr(ops, n, real_ops[n])
        _, want = co.tick_core(st, batch, now, dp, flows=flows,
                               wc_fill=fill, force="ref")
        torch.cuda.synchronize()
        for k in ("order", "queue", "contention", "expired", "admitted"):
            if not torch.equal(got[k], want[k]):
                fail(f"[{tag}] captured tick {i}: {k} differs between "
                     f"kernels and plain versions")
        for k in ("rate", "wc_rate", "wc_flow"):
            a, b = got[k], want[k]
            if a is None or b is None:   # no per-flow fill this tick
                if a is not b:
                    fail(f"[{tag}] captured tick {i}: {k} is None on one "
                         f"side only")
                continue
            if exact_rates and not torch.equal(a, b):
                fail(f"[{tag}] captured tick {i}: {k} differs from the "
                     f"plain versions' (max abs "
                     f"{float((a - b).abs().max()):.3g})")
            if not torch.allclose(a, b, rtol=1e-6, atol=0):
                fail(f"[{tag}] captured tick {i}: {k} differs beyond "
                     f"rtol 1e-6")
            who = "maxmin_rates" if fill == "maxmin" and k == "wc_flow" \
                else "tick_walk"
            err[who] = max(err[who], float((a - b).abs().max()))
        err["contention"] = max(err["contention"], float(
            (got["contention"] - want["contention"]).abs().max()))
        pilot = ("" if batch.s_mixed is None else
                 f", {int((batch.s_mixed & batch.active).sum())} with a "
                 f"pilot estimate")
        print(f"[{tag}] captured tick {i} ({work((st, batch))} active "
              f"coflows in {batch.active.shape[0]} lanes{pilot}): "
              f"kernels == "
              f"plain versions (max abs rate diff "
              f"{max(err['tick_walk'], err['maxmin_rates']):.3g}; K6 == "
              f"its plain version bit for bit on the {len(sums)} K6 calls' "
              f"inputs before it)")
    if not n_sums:
        fail(f"[{tag}] no segment-sum input was captured")
    return grabbed, err


def ssd_inputs(shape, dtype, seed, dev):
    """The seeded inputs of `tests/test_kernels.py`'s SSD sweep."""
    import numpy as np
    import torch

    B, L, H, G, Dh, N, _ = shape
    rng = np.random.default_rng(seed)
    arrs = (rng.normal(size=(B, L, H, Dh)),
            rng.uniform(0.01, 0.3, size=(B, L, H)),
            -rng.uniform(0.3, 2.0, size=H),
            rng.normal(size=(B, L, G, N)), rng.normal(size=(B, L, G, N)))
    return [torch.as_tensor(a, dtype=torch.float32 if i == 2 else dtype,
                            device=dev) for i, a in enumerate(arrs)]


def ssd_err(got, want, atol):
    """(within the bar, max abs error): |got - want| <= atol + rtol |want|
    with rtol 1e-3, plus one bf16 rounding step (2^-7 relative) for a
    bf16 output, since both sides round their f32 sums to bf16."""
    import torch

    rtol = 1e-3 + (2.0 ** -7 if got.dtype == torch.bfloat16 else 0.0)
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    ok = bool((diff <= atol + rtol * w.abs()).all()) and bool(
        torch.isfinite(g).all())
    return ok, float(diff.max())


def ssd_bound_ms(shape, elt):
    """Bytes: x, dt, b, c read once (elt bytes each), a, y written once,
    the f32 final state written once. Operations (multiply-adds): per
    (batch, group, chunk) the causal half of c b^T (lc (lc + 1) / 2 x N),
    which the heads of a group share, at the bf16 tensor-core rate when
    b and c are bf16 (their products are exact there); per (batch, head,
    chunk) the causal half of M x (x Dh), c S^T and the state update
    (lc Dh N each), at the f32 rate since M, S and the state weights
    are f32."""
    B, L, H, G, Dh, N, lc = shape
    nbytes = elt * (2 * B * L * H * Dh + B * L * H + 2 * B * L * G * N) \
        + 4 * H + 4 * B * H * Dh * N
    # chunk lengths: full chunks, then the ragged last one (no padding)
    lens = [min(lc, L - j) for j in range(0, L, lc)]
    tri = sum(n * (n + 1) // 2 for n in lens)
    gram = B * G * tri * N
    rest = B * H * (tri * Dh + 2 * L * Dh * N)
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = 2 * gram / (BF16_OPS_PER_S if elt == 2 else F32_OPS_PER_S) \
        + 2 * rest / F32_OPS_PER_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def attention_widths(shape):
    """(B, H, Hkv, S, T, D, Dv, q_offset) of an attention shape given as
    that 8-tuple or as (B, H, Hkv, S, T, D, q_offset) with Dv = D."""
    if len(shape) == 8:
        return shape
    B, H, Hkv, S, T, D, q_offset = shape
    return B, H, Hkv, S, T, D, D, q_offset


def flash_inputs(shape, dtype, seed, dev):
    """Seeded q (B, H, S, D), k (B, Hkv, T, D) and v (B, Hkv, T, Dv)."""
    import numpy as np
    import torch

    B, H, Hkv, S, T, D, Dv, _ = attention_widths(shape)
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(size=s).astype(np.float32),
                            device=dev).to(dtype)
            for s in ((B, H, S, D), (B, Hkv, T, D), (B, Hkv, T, Dv))]


def attention_bound_ms(shape, elt, causal=True):
    """Of attention at `shape` (see `attention_widths`). Bytes: q once (B
    H S D) and o once (B H S Dv), k and v once per KV head (B Hkv T D
    and B Hkv T Dv), elt bytes an element. Operations: D + Dv
    multiply-adds (q . k and p v) for each unmasked (query, key) pair,
    counted exactly: sum_i min(T, q_offset + i + 1) pairs a (batch,
    head) under `causal`, S T without; at the bf16 tensor-core rate for
    bf16 inputs (the 2e-2 bar admits bf16 products), at the non-tensor
    f32 rate for f32 (TF32 fails the 2e-6 bar). Returns (ms, what bounds
    it, pairs)."""
    import numpy as np

    B, H, Hkv, S, T, D, Dv, q_offset = attention_widths(shape)
    nbytes = elt * (B * H * S * (D + Dv) + B * Hkv * T * (D + Dv))
    pairs = B * H * (int(np.minimum(T, q_offset + np.arange(S) + 1).sum())
                     if causal else S * T)
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = 2 * (D + Dv) * pairs / (BF16_OPS_PER_S if elt == 2
                                  else F32_OPS_PER_S)
    return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations",
            pairs)


def sdpa(q, k, v, causal=True):
    """One PyTorch call computing K5's function on (B, H, S, D) inputs
    (the yardstick `library_ms`; the port never calls it)."""
    import torch

    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True)


def check_tokens(tag, got, want, gaps):
    """Greedy tokens equal row by row, except that a row may part from
    the reference at a step whose reference top-2 gap is under TIE_GAP
    (its later tokens follow another history and are not compared).
    Returns, per row, the step compared up to."""
    upto = []
    for r in range(want.shape[0]):
        n = want.shape[1]
        for i in range(n):
            if int(got[r, i]) != int(want[r, i]):
                print(f"[{tag}] row {r}: token {i} differs, reference "
                      f"top-2 gap {gaps[r][i]:.3e}")
                if gaps[r][i] >= TIE_GAP:
                    fail(f"[{tag}] row {r}: greedy token {i} differs "
                         f"where the top-2 gap is {gaps[r][i]:.3e}")
                n = i
                break
        upto.append(n)
        print(f"[{tag}] row {r}: tokens equal over {n} of "
              f"{want.shape[1]} steps; least reference top-2 gap "
              f"{min(gaps[r]):.3e}")
    return upto


def expected_launches(cfg):
    """{kernel: launches} of one prefill of `cfg`'s stack: K4 for each
    Mamba layer, K5 for each GQA or MLA layer, each cross attention and
    each encoder layer, every other kernel 0."""
    from repro_torch.kernels import ops
    from repro_torch.models import lm

    want = {n: 0 for n in ops.launch_counts()}
    for mixer, _, cross in lm.layer_plan(cfg, cfg.num_layers, True):
        want["ssd_scan" if mixer == "mamba" else "flash_attention"] += 1
        want["flash_attention"] += cross
    want["flash_attention"] += cfg.enc_layers if cfg.enc_dec else 0
    return want


def check_launches(tag, what, counts, cfg):
    """Fail unless `counts` are one prefill's `expected_launches`."""
    want = expected_launches(cfg)
    got = {n: counts[n] for n in want}
    if got != want:
        fail(f"[{tag}] {what} launched {got}; expected {want}")


def golden_src(gold):
    """A golden's frame embeddings (None without): f32 normals from
    `default_rng(src_seed)` of its `src_shape`, as
    `tests/test_torch_lm_dense.py` draws them."""
    import numpy as np

    if "src_seed" not in gold:
        return None
    return np.random.default_rng(gold["src_seed"]).standard_normal(
        gold["src_shape"], dtype=np.float32)


def golden_parity(tag, arch, path, norms):
    """`arch` at its published width, depth (and, for the MoE models,
    routed experts) cut as the golden's `config_cuts` say (its
    `num_layers` alone in the older goldens), f32, weights from
    `numpy_params(cfg, seed)` served by `ServeSession(model=...)` (an
    encoder-decoder with the golden's frames, `golden_src`): its
    prefill launches K4 once per Mamba layer, K5 once per attention
    (encoder and cross attention included) and no other kernel; top-8
    logits within LOGIT_ATOL of the JAX package's numbers in the golden
    at `path`, tokens equal (the tie rule of `check_tokens`), and the
    per-layer cache norms (summed in f64) named by `norms` ({golden
    field: cache key}, over the layers whose cache has the key) to rtol
    1e-4."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.lm_serve import ServeSession
    from repro_torch.models import lm

    dev = torch.device("cuda")
    gold = json.loads(path.read_text())
    cuts = gold.get("config_cuts", {"num_layers": gold["num_layers"]})
    cfg = dataclasses.replace(get_config(arch), dtype="float32", **cuts)
    t0 = time.perf_counter()
    weights, meta = lm.numpy_params(cfg, seed=gold["weights_seed"])
    t_draw = time.perf_counter() - t0
    n_gold = len(gold["tokens"][0])
    B, P = len(gold["prompts"]), len(gold["prompts"][0])
    src = golden_src(gold)
    src_len = 0 if src is None else src.shape[1]
    sess = ServeSession(arch, batch=B, max_len=P + n_gold, src_len=src_len,
                        model=lm.from_reference(weights, meta, cfg,
                                                device=dev))
    del weights
    ops.reset_launches()
    out = list(sess.stream(gold["prompts"], n_gold, src))
    check_launches(tag, "the parity run", ops.launch_counts(), cfg)
    logits = [lg.float() for _, lg in out]
    toks = torch.stack([t for t, _ in out], 1)
    with torch.inference_mode():
        _, cache = sess.prefill_fn(
            torch.as_tensor(gold["prompts"], device=dev),
            lm.init_cache(cfg, B, P, src_len=src_len, device=dev),
            None if src is None else torch.as_tensor(src, device=dev))
    idx = torch.as_tensor(gold["top8_index"], device=dev)
    top = logits[0].gather(1, idx)
    want = torch.as_tensor(gold["top8_value"], device=dev)
    lerr = float((top - want).abs().max())
    got = {f: [float(c[key].double().norm()) for c in cache if key in c]
           for f, key in norms.items()}
    print(f"[{tag}] {arch} full width, cut {cuts}, f32 (weights drawn in "
          f"{t_draw:.1f} s), {B} x "
          f"{P} tokens: top-8 logits max abs error {lerr:.3e} (bar "
          f"{LOGIT_ATOL}); logits norm "
          f"{logits[0].double().norm(dim=1).tolist()} vs JAX "
          f"{gold['logits_norm']}; " + "; ".join(
              f"{f} {got[f]} vs JAX {gold[f]}" for f in norms))
    if lerr > LOGIT_ATOL or not torch.isfinite(logits[0]).all():
        fail(f"[{tag}] full-width prefill logits differ from the JAX "
             f"package's")
    for f in norms:
        if not np.allclose(got[f], gold[f], rtol=1e-4):
            fail(f"[{tag}] full-width {f} differ from the JAX package's")
    check_tokens(tag, toks.cpu(), torch.as_tensor(gold["tokens"]),
                 gold["top2_gap"])


def serve_model(arch, layers, dtype, dev):
    """The model of `arch` at its published widths in `dtype` with
    random weights from seed 0 on `dev`: the published depth when
    `layers` is None (`ServeSession(arch, smoke=False)`'s), else cut to
    `layers` (`lm.init_model`)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.lm_serve import ServeSession
    from repro_torch.models import lm

    if layers is None:
        return ServeSession(arch, smoke=False, device=dev, seed=0,
                            dtype=dtype).model
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return lm.init_model(cfg, seed=0, device=dev)


def serve_main_path(tag, arch, batch, prompt_len, n_tokens, layers=None,
                    f32_layers=None, frames=0, f32=True):
    """`ServeSession(arch, ...)` on `serve_model(arch, layers, None)`:
    the published widths in the config's dtype, the published depth
    (`smoke=False`) or a depth cut to `layers`; `batch` prompts of
    `prompt_len` tokens (numpy `default_rng(1)`; an encoder-decoder's
    `frames` frame embeddings a prompt from `default_rng(2)`) and
    `n_tokens` greedy tokens, with every launch counter set to 0 just
    before and read just after: K4 once per Mamba layer and K5 once per
    attention (in the prefill), every other kernel 0, finite logits.
    Prints prefill ms, decode ms per token, tokens/s and peak device
    memory, the first step's logit gap to the plain path in the same
    dtype (and, with `--profile`, `profile_serve`). Then, the model
    freed and unless `f32` is False, the same session in f32 (at
    `f32_layers` when given) with the plain prefill path and with the
    kernels, held to LOGIT_ATOL over the steps with equal histories.
    Returns the launch counts of the main-path run."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.lm_serve import ServeSession

    dev = torch.device("cuda")
    cfg0 = get_config(arch)
    prompts = np.random.default_rng(1).integers(
        0, cfg0.vocab_size, (batch, prompt_len))
    src = np.random.default_rng(2).standard_normal(
        (batch, frames, cfg0.d_model), dtype=np.float32) if frames else None
    max_len = prompt_len + n_tokens
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sess = ServeSession(arch, batch=batch, max_len=max_len, src_len=frames,
                        model=serve_model(arch, layers, None, dev))
    sess.generate(prompts, 2, src)                # warm-up
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    stream = sess.stream(prompts, n_tokens, src)
    first = next(stream)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = [first] + list(stream)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    served = torch.stack([tok for tok, _ in out], 1)
    prefill_ms = 1e3 * (t1 - t0)
    decode_ms = 1e3 * (t2 - t1) / (n_tokens - 1)
    depth = ("the published depth" if layers is None else
             f"depth cut to {layers} of {get_config(arch).num_layers} "
             f"layers (the host's share of each step is larger than in a "
             f"deployment)")
    enc = (f" + {sess.cfg.enc_layers} encoder layers over {batch} x "
           f"{frames} frames" if sess.cfg.enc_dec else "")
    print(f"[{tag}] ServeSession({arch!r}), {depth}: "
          f"{sess.cfg.num_layers} layers{enc}, d_model {sess.cfg.d_model}, "
          f"{sess.cfg.dtype}; {batch} x {prompt_len}-token prompts, "
          f"{n_tokens} greedy tokens: prefill {prefill_ms:.3f} ms, decode "
          f"{decode_ms:.3f} ms per token ({batch * 1e3 / decode_ms:.1f} "
          f"tokens/s), peak device memory {peak / 2**20:.1f} MiB above the "
          f"{base / 2**20:.1f} MiB held before, launches {counts}; {smi()}")
    check_launches(tag, f"one prefill of the {arch} serve path", counts,
                   sess.cfg)
    if served.shape != (batch, n_tokens) or not (
            (served >= 0) & (served < sess.cfg.vocab_size)).all() or not \
            all(torch.isfinite(lg.float()).all() for _, lg in out):
        fail(f"[{tag}] the serve path's tokens or logits are malformed")
    plain = ServeSession(arch, batch=batch, max_len=max_len, force="ref",
                         src_len=frames, model=sess.model)
    _, plain_first = next(plain.stream(prompts, 1, src))
    gap = float((first[1].float() - plain_first.float()).abs().max())
    print(f"[{tag}] {sess.cfg.dtype} session, first step: kernels vs their "
          f"plain paths: logits max abs gap {gap:.3e} over "
          f"{sess.cfg.num_layers} layers (printed, no bar)")
    del plain, plain_first
    if "--profile" in sys.argv[1:]:
        profile_serve(sess, prompts, src=src)
    del sess, stream, first, out
    runs = {}
    torch.cuda.empty_cache()
    if not f32:
        return counts
    m32 = serve_model(arch, f32_layers or layers, "float32", dev)
    for force in ("ref", None):
        s32 = ServeSession(arch, batch=batch, max_len=max_len, force=force,
                           src_len=frames, model=m32)
        ops.reset_launches()
        res = list(s32.stream(prompts, n_tokens, src))
        if force:
            if any(ops.launch_counts().values()):
                fail(f"[{tag}] the f32 session (force={force}) launched "
                     f"{ops.launch_counts()}")
        else:
            check_launches(tag, "the f32 session", ops.launch_counts(),
                           m32.cfg)
        runs[force] = ([lg for _, lg in res],
                       torch.stack([t for t, _ in res], 1).cpu())
        del s32, res
    del m32
    (ref_l, ref_t), (k_l, k_t) = runs["ref"], runs[None]
    top2 = [lg.topk(2, dim=1).values for lg in ref_l]
    gaps = torch.stack([t[:, 0] - t[:, 1] for t in top2], 1).tolist()
    upto = check_tokens(tag, k_t, ref_t, gaps)
    err = 0.0
    for i, (g, w) in enumerate(zip(k_l, ref_l)):
        rows = [r for r in range(batch) if i <= upto[r]]
        if rows:
            err = max(err, float((g[rows] - w[rows]).abs().max()))
    print(f"[{tag}] f32 session, kernels vs their plain paths: logits max "
          f"abs error {err:.3e} over the steps with equal histories (bar "
          f"{LOGIT_ATOL})")
    if err > LOGIT_ATOL:
        fail(f"[{tag}] the f32 session's logits through the kernels differ "
             f"from the plain path's")
    torch.cuda.empty_cache()
    return counts


def bf16_pair(tag, arch, batch, prompt_len, kernel, numpy_weights=True,
              layers=2, frames=0, rtol=0.0):
    """`arch` at its published width, `layers` layers (an
    encoder-decoder's encoder too), in the config's bf16, weights from
    `numpy_params(cfg, seed=0)` (`numpy_weights`) or
    `lm.init_model(cfg, seed=0)` on the card: a prefill of `batch`
    prompts of `prompt_len` tokens (numpy `default_rng(1)`; an
    encoder-decoder's `frames` frames a prompt from `default_rng(2)`)
    and PAIR_STEPS teacher-forced decode steps (the same next tokens for
    both), once with the plain prefill path and once with the kernels;
    `kernel` runs as `expected_launches` says in the second and never in
    the first, and every logit of every step agrees with the plain one,
    w, to BF16_LOGIT_ATOL + `rtol` (|w| + the RMS of w's row) (`rtol` 0:
    C5's bar; ROADMAP C15 for the models whose logits need the relative
    term)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm

    dev = torch.device("cuda")
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, num_layers=layers, **(
        {"enc_layers": layers} if cfg.enc_dec else {}))
    model = (lm.from_reference(*lm.numpy_params(cfg, seed=0), cfg,
                               device=dev) if numpy_weights
             else lm.init_model(cfg, seed=0, device=dev))
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (batch, prompt_len + PAIR_STEPS)), device=dev)
    src = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (batch, frames, cfg.d_model), dtype=np.float32),
        device=dev) if frames else None
    runs = {}
    for force in ("ref", None):
        ops.reset_launches()
        with torch.inference_mode():
            cache = lm.init_cache(cfg, batch, prompt_len + PAIR_STEPS,
                                  src_len=frames, device=dev)
            lg, cache = lm.forward_prefill(model, tokens[:, :prompt_len],
                                           cache, src_embeds=src,
                                           force=force)
            out = [lg[:, -1].float()]
            for i in range(PAIR_STEPS):
                pos = prompt_len + i
                lg, cache = lm.forward_decode(model, tokens[:, pos:pos + 1],
                                              cache, pos)
                out.append(lg[:, -1].float())
        n = ops.launch_counts()[kernel]
        if n != (0 if force else expected_launches(cfg)[kernel]):
            fail(f"[{tag}] the bf16 pair (force={force}) launched {kernel} "
                 f"{n} times")
        runs[force] = out
        del cache
    errs = [float((g - w).abs().max())
            for g, w in zip(runs[None], runs["ref"])]
    # each logit's error over its own bar: at most 1 everywhere; the
    # worst (share, error, |w|, its row's RMS)
    worst = (0.0, 0.0, 0.0, 0.0)
    for g, w in zip(runs[None], runs["ref"]):
        rms = w.pow(2).mean(dim=1, keepdim=True).sqrt().expand_as(w)
        err = (g - w).abs()
        share = err / (BF16_LOGIT_ATOL + rtol * (w.abs() + rms))
        i = share.argmax()
        worst = max(worst, tuple(float(t.flatten()[i])
                                 for t in (share, err, w.abs(), rms)))
    finite = all(bool(torch.isfinite(g).all()) for g in runs[None])
    enc = f" (+ {layers} encoder layers, {frames} frames)" if frames else ""
    print(f"[{tag}] bf16 pair: {arch} full width, {cfg.num_layers} layers"
          f"{enc}, {cfg.dtype}, {batch} x {prompt_len} tokens + "
          f"{PAIR_STEPS} teacher-forced steps, {kernel} vs its plain path: "
          f"logits max abs error {errs[0]:.3e} after the prefill, "
          f"{max(errs[1:]):.3e} over the decode steps (bar "
          f"{BF16_LOGIT_ATOL} + {rtol:.4g} (|w| + its row's RMS) a plain "
          f"logit w; the worst element used {worst[0]:.3f} of its bar: "
          f"error {worst[1]:.4g} at |w| {worst[2]:.4g}, row RMS "
          f"{worst[3]:.4g}; largest plain logit "
          f"{max(float(w.abs().max()) for w in runs['ref']):.4g})")
    if worst[0] > 1.0 or not finite:
        fail(f"[{tag}] the bf16 logits through {kernel} differ from the "
             f"plain path's")
    del model, runs
    torch.cuda.empty_cache()


def sdpa_any(q, k, v, causal=True):
    """`sdpa` where some backend of this install takes the shape: (its
    device ms over 10 calls, None), else (None, the error it raised) (a
    yardstick only; the port never calls it)."""
    import torch

    try:
        sdpa(q, k, v, causal)
        torch.cuda.synchronize()
    except RuntimeError as e:
        return None, str(e).splitlines()[0]
    return cuda_ms(lambda: sdpa(q, k, v, causal), 10), None


def attention_shape_record(tag, shape, dtype, dev, what, causal=True):
    """K5 at `shape` (causal unless `causal` is False, q_offset 0) in
    `dtype` against its plain version at the dtype's bar, then its time
    beside the plain version's, SDPA's (`sdpa_any`) and the bound, with
    the bf16 TFLOP/s and the bound share; max |o| and max |Δo| printed
    (ROADMAP C8). Returns the record for the kernels line's
    `shapes`."""
    import torch

    from repro_torch.kernels import ops

    q, k, v = flash_inputs(shape, dtype, shape[3] + shape[5], dev)
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ops.flash_attention(q, k, v, causal=causal, force="ref")
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    omax = float(want.float().abs().max())
    bar = 2e-6 if dtype == torch.float32 else 2e-2
    if err > bar or got.dtype != dtype or not bool(torch.isfinite(got).all()):
        fail(f"[{tag}] K5 disagrees with flash_attention_ref at {shape} "
             f"{dtype}: max abs error {err:.3e} (bar {bar})")
    bnd, by, pairs = attention_bound_ms(shape, q.element_size(), causal)
    ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=causal), 10)
    plain = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=causal,
                                                force="ref"), 3)
    lib, lib_err = sdpa_any(q, k, v, causal)
    _, _, _, _, _, D, Dv, _ = attention_widths(shape)
    flop = 2 * (D + Dv) * pairs
    print(f"[{tag}] K5 at {what} {shape} {str(dtype)[6:]} causal={causal}: "
          f"max abs error "
          f"{err:.3e} (bar {bar}), max |o| {omax:.4f}; kernel {ms:.4f} ms, "
          f"plain {plain:.4f} ms, SDPA "
          + (f"{lib:.4f} ms" if lib is not None else f"null ({lib_err})")
          + f", bound {bnd:.4f} ms ({by}; {pairs} unmasked pairs); "
          f"{flop / ms / 1e9:.1f} TFLOP/s, {bnd / ms:.1%} of the bound; "
          f"{smi()}")
    del q, k, v, got, want
    return {"shape": list(shape), "dtype": str(dtype)[6:], "causal": causal,
            "ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib, "max_abs_err": err, "max_abs_o": omax}


def moe_kernels_phase(tag):
    """Phase 26: K5 at MLA's widths (192, 128) against
    `flash_attention_ref` on `MLA_CASES`, f32 and bf16, causal and not
    (atol 2e-6 f32, 2e-2 bf16), then at DeepSeek-V2's prefill shape
    `MLA_SERVE` (causal) with its times (`attention_shape_record`); K5
    at Qwen3-MoE's and Jamba's GQA prefill shapes (`GQA_SERVE`), f32
    and bf16; K4 at Jamba's N = 16 shape `SSD_JAMBA` against
    `ssd_chunked_ref` at phase 10's bar, f32 and bf16, with its time
    beside the plain version's and the bound. Returns ({"flash_attention":
    records, "ssd_scan": records} for the kernels line's `shapes`)."""
    import torch

    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    for shape in MLA_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                q, k, v = flash_inputs(shape, dtype, shape[3] + shape[5],
                                       dev)
                off = shape[-1]
                got = ops.flash_attention(q, k, v, causal=causal,
                                          q_offset=off)
                want = ops.flash_attention(q, k, v, causal=causal,
                                           q_offset=off, force="ref")
                torch.cuda.synchronize()
                e = float((got.float() - want.float()).abs().max())
                bar = 2e-6 if dtype == torch.float32 else 2e-2
                print(f"[{tag}] K5 {shape} {str(dtype)[6:]} causal={causal}:"
                      f" max abs error {e:.3e} (bar {bar}), max |o| "
                      f"{float(want.float().abs().max()):.4f}")
                if e > bar or got.shape != want.shape or not bool(
                        torch.isfinite(got).all()):
                    fail(f"[{tag}] K5 disagrees with flash_attention_ref at "
                         f"{shape} {dtype} causal={causal}")
    records = {"flash_attention": [], "ssd_scan": []}
    for dtype in (torch.float32, torch.bfloat16):
        records["flash_attention"].append(attention_shape_record(
            tag, MLA_SERVE, dtype, dev, "DeepSeek-V2's MLA prefill shape"))
    for arch, shape in GQA_SERVE.items():
        for dtype in (torch.float32, torch.bfloat16):
            records["flash_attention"].append(attention_shape_record(
                tag, shape, dtype, dev, f"{arch}'s prefill shape"))
    lc = SSD_JAMBA[-1]
    for dtype in (torch.float32, torch.bfloat16):
        args = ssd_inputs(SSD_JAMBA, dtype, 16, dev)
        y, st = ops.ssd_scan(*args, lc=lc)
        y_ref, st_ref = ops.ssd_scan(*args, lc=lc, force="ref")
        torch.cuda.synchronize()
        ymax = float(y_ref.float().abs().max())
        ok_y, err_y = ssd_err(y, y_ref, 5e-4 * ymax)
        ok_s, err_s = ssd_err(st, st_ref, 5e-4)
        if not (ok_y and ok_s) or y.dtype != dtype:
            fail(f"[{tag}] K4 disagrees with ssd_chunked_ref at {SSD_JAMBA} "
                 f"{dtype}: y {err_y:.3e}, state {err_s:.3e}")
        ms = cuda_ms(lambda: ops.ssd_scan(*args, lc=lc), 20)
        plain = cuda_ms(lambda: ops.ssd_scan(*args, lc=lc, force="ref"), 5)
        bnd, by = ssd_bound_ms(SSD_JAMBA, args[0].element_size())
        print(f"[{tag}] K4 at Jamba's shape {SSD_JAMBA} {str(dtype)[6:]}: "
              f"max abs error y {err_y:.3e} (max|y| {ymax:.3f}), state "
              f"{err_s:.3e}; kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"bound {bnd:.4f} ms ({by}); library: null; {smi()}")
        records["ssd_scan"].append({
            "shape": list(SSD_JAMBA), "dtype": str(dtype)[6:], "ms": ms,
            "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": None, "max_abs_err": max(err_y, err_s)})
        del args, y, y_ref
    torch.cuda.empty_cache()
    return records


class PoolStream:
    """Tenants of `pool` streaming `traces`, one trace a tenant (admitted
    with `tenant_kw[i]` where given). Each `advance(dt)` submits every
    coflow whose arrival falls before the new clock, calls
    `pool.advance(dt)` and `pool.poll()`, synchronizes, and records its
    wall ms, the event steps its session loops ran (a spy on
    `engine.session_advance`) and where the wall went (`parts`, seconds:
    submits, the slab flush `pool._ensure` with its gathers, re-packs
    and scatters, the session loops, the polls). It fails if a coflow
    completes twice or if an advance with no dirty row uploads a
    byte."""

    def __init__(self, tag, pool, traces, tenant_kw=()):
        import numpy as np

        self.tag, self.pool = tag, pool
        self.rows = [pool.session(**dict(tenant_kw[i] if i < len(tenant_kw)
                                         else {}))
                     for i in range(len(traces))]
        self.queues = [sorted(tr.coflows, key=lambda c: (c.arrival, c.cid))
                       for tr in traces]
        self.cids = [{} for _ in traces]       # live handle -> cid
        self.cct = [np.full(len(tr.coflows), np.nan) for tr in traces]
        self.submitted = 0                     # coflows of tenant 0 in
        self.steps, self.walls, self.step_counts = 0, [], []
        self.growths = 0
        self.parts = dict(submit=0.0, flush=0.0, loop=0.0, poll=0.0)
        ensure = pool._ensure

        def timed_ensure():
            t = time.perf_counter()
            ensure()
            self.parts["flush"] += time.perf_counter() - t

        pool._ensure = timed_ensure

    def advance(self, dt):
        import torch

        from repro_torch.fabric import engine as eng

        t0 = time.perf_counter()
        clock = self.rows[0].now + dt
        dirty = False
        for i, (s, q) in enumerate(zip(self.rows, self.queues)):
            while q and q[0].arrival < clock:
                c = q.pop(0)
                self.cids[i][s.submit([c])[0]] = c.cid
                self.submitted += i == 0
                dirty = True
        pool, real, ran = self.pool, eng.session_advance, [0]
        t1 = time.perf_counter()
        self.parts["submit"] += t1 - t0

        def spy(*a, **kw):
            t = time.perf_counter()
            out = real(*a, **kw)
            self.parts["loop"] += time.perf_counter() - t
            ran[0] += out[1]
            return out

        up, caps = pool.io["upload_bytes"], (pool._C_cap, pool._F_cap)
        built = pool._tb is not None
        eng.session_advance = spy
        try:
            pool.advance(dt)
        finally:
            eng.session_advance = real
        t2 = time.perf_counter()
        for s, d in pool.poll():
            i = self.rows.index(s)
            c = self.cids[i].pop(d.handle, None)
            if c is None:
                fail(f"[{self.tag}] tenant {i}: coflow {d.handle} "
                     f"completed twice")
            self.cct[i][c] = d.cct
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        self.parts["poll"] += t3 - t2
        self.walls.append(1e3 * (t3 - t0))
        self.steps += ran[0]
        self.step_counts.append(ran[0])
        self.growths += built and caps != (pool._C_cap, pool._F_cap)
        if not dirty and pool.io["upload_bytes"] != up:
            fail(f"[{self.tag}] an advance with no dirty row uploaded "
                 f"{pool.io['upload_bytes'] - up} bytes")

    def stream(self, dt, until=None):
        """Advance by `dt` until every coflow is in (or tenant 0 has
        submitted `until`)."""
        while any(self.queues) and (until is None
                                    or self.submitted < until):
            self.advance(dt)

    def drain(self, step):
        """Advance by `step` until every tenant is empty; every coflow
        must have completed exactly once with a positive CCT."""
        import numpy as np

        while any(s.num_live for s in self.rows):
            self.advance(step)
        for i, c in enumerate(self.cct):
            if not (np.isfinite(c) & (c > 0)).all():
                fail(f"[{self.tag}] tenant {i}: a coflow did not complete "
                     f"with a positive CCT")


def pool_main_path(tag, fleet, params, offline):
    """Phase 16: `SessionPool(params, num_ports=PORTS, max_sessions=16)`
    on the card, tenant i streaming `fleet[i]` in 16 δ advances, then
    draining in POOL_DRAIN s advances, with every launch counter set to
    0 just before and read just after. Every tenant's per-coflow CCTs
    must equal `offline`'s lane (phase 4's replay) bit for bit; K1 = K2
    = the event steps the session loops ran, K3 = K4 = K5 = 0; full
    uploads = capacity growths + 1. Then the δ budget: a one-row pool on
    `fleet[0]` streamed to the arrival of its 100th coflow, then 200
    advances of one δ. Returns the launch counts."""
    import numpy as np
    import torch

    from repro_torch.api import SessionPool
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_launches()
    t0 = time.perf_counter()
    with expected_sums() as sums:
        pool = SessionPool(params, num_ports=PORTS,
                           max_sessions=len(fleet))
        st = PoolStream(tag, pool, fleet)
        st.stream(16 * params.delta)
        n_stream = len(st.walls)
        st.drain(POOL_DRAIN)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    walls = np.array(st.walls)
    io = pool.io
    print(f"[{tag}] SessionPool, {len(fleet)} tenants x fb_like_trace("
          f"{COFLOWS}, {PORTS}): {len(walls)} advances ({n_stream} of 16 δ "
          f"while streaming, then {POOL_DRAIN} s), event steps {st.steps}, "
          f"flag reads {io['loop_reads']}, wall {wall:.3f} s, wall per "
          f"advance median {np.median(walls):.3f} ms p99 "
          f"{np.percentile(walls, 99):.3f} ms (streaming median "
          f"{np.median(walls[:n_stream]):.3f} ms), peak device memory "
          f"{peak / 2**20:.1f} MiB above the {base / 2**20:.1f} MiB held "
          f"before, launches {counts}; io {io}; slab capacities C "
          f"{pool._C_cap} F {pool._F_cap}, {st.growths} growths")
    k_stream = sum(st.step_counts[:n_stream])
    print(f"[{tag}] where the wall went (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in st.parts.items()) + f" (event steps "
        f"{st.steps}, {k_stream} of them while streaming: "
        f"{1e3 * st.parts['loop'] / max(st.steps, 1):.3f} ms of loop wall "
        f"a step, flag reads included); offline replay (phase 4): "
        f"{offline.events} event steps, {offline.wall_seconds:.3f} s")
    for b, got in enumerate(st.cct):
        want = offline.row_cct(b)
        if not np.array_equal(got, want):
            bad = int((got != want).sum())
            fail(f"[{tag}] tenant {b}: {bad} per-coflow CCTs differ from "
                 f"the offline replay's (max |Δ| "
                 f"{np.nanmax(np.abs(got - want)):.3e})")
    print(f"[{tag}] every tenant's {COFLOWS} per-coflow CCTs equal phase "
          f"4's offline replay bit for bit")
    for name in ("contention", "tick_walk"):
        if counts[name] != st.steps:
            fail(f"[{tag}] {name} launched {counts[name]} times for "
                 f"{st.steps} event steps")
    if counts["maxmin"] or counts["ssd_scan"] or counts["flash_attention"]:
        fail(f"[{tag}] K3, K4 or K5 ran on the big-switch pool")
    if io["full_uploads"] != st.growths + 1:
        fail(f"[{tag}] {io['full_uploads']} full uploads for "
             f"{st.growths} capacity growths")
    check_sums(tag, counts, sums)
    del pool, st

    one = PoolStream(tag, SessionPool(params, num_ports=PORTS,
                                      max_sessions=1), fleet[:1])
    one.stream(16 * params.delta, until=100)
    one.walls, one.step_counts = [], []
    one.parts = dict.fromkeys(one.parts, 0.0)
    for _ in range(DELTA_ADVANCES):
        one.advance(params.delta)
    w, k = np.array(one.walls), np.array(one.step_counts)
    parts = ", ".join(f"{k_} {1e3 * v / len(w):.3f}"
                      for k_, v in one.parts.items())
    budget = 1e3 * params.delta
    print(f"[{tag}] δ budget: one tenant (fb_like_trace({COFLOWS}, "
          f"{PORTS}, seed=0)) after the arrival of its 100th coflow, "
          f"{DELTA_ADVANCES} advances of one δ (arrivals submitted before "
          f"each): wall per advance median {np.median(w):.3f} ms, p99 "
          f"{np.percentile(w, 99):.3f} ms, max {w.max():.3f} ms against "
          f"δ = {budget:.0f} ms ({int((w > budget).sum())} of {len(w)} "
          f"over); event steps per advance median {np.median(k):.0f}, max "
          f"{k.max()}, total {k.sum()}; mean ms an advance: {parts}; "
          f"{smi()}")
    return counts


def leafspine_pool(tag, params, leaf):
    """Phase 17: 4 tenants streaming fb_like_trace(48, 150, seed=0..3)
    under `leaf` through a 5-row pool whose fifth tenant streams seed 0
    under the Aalo-queue ablation; the 4 are held to the port's offline
    `run` of the same traces on the card bit for bit, the ablation
    tenant to its offline replay at ROADMAP C2's bar; K1 = K2 = K3 = the
    event steps. Returns the launch counts."""
    import numpy as np

    from repro_torch.api import Scenario, SessionPool, run
    from repro_torch.kernels import ops
    from repro_torch.traces.synth import fb_like_trace

    traces = [fb_like_trace(PARITY_COFLOWS, PORTS, seed=s)
              for s in range(4)]
    ablation = {"per_flow_threshold": False}
    offline = run(Scenario(engine="torch", traces=tuple(traces),
                           topology=leaf))
    abl_off = run(Scenario(engine="torch", traces=(traces[0],),
                           topology=leaf, mechanisms=ablation))
    ops.reset_launches()
    t0 = time.perf_counter()
    with expected_sums() as sums:
        pool = SessionPool(params, num_ports=PORTS, max_sessions=5,
                           topology=leaf)
        st = PoolStream(tag, pool, traces + traces[:1],
                        tenant_kw=[{}] * 4 + [{"mechanisms": ablation}])
        st.stream(16 * params.delta)
        st.drain(POOL_DRAIN)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    print(f"[{tag}] leaf-spine SessionPool ({leaf}), 4 tenants x "
          f"fb_like_trace({PARITY_COFLOWS}, {PORTS}) + 1 ablation tenant: "
          f"{len(st.walls)} advances, event steps {st.steps}, flag reads "
          f"{pool.io['loop_reads']}, wall {wall:.3f} s, launches {counts}")
    for b in range(4):
        if not np.array_equal(st.cct[b], offline.row_cct(b)):
            fail(f"[{tag}] leaf-spine tenant {b}'s per-coflow CCTs differ "
                 f"from the offline replay's")
    want = abl_off.row_cct(0)
    dev_abs = np.abs(st.cct[4] - want)
    print(f"[{tag}] the 4 tenants equal the offline replay bit for bit; "
          f"the ablation tenant against its offline replay: max |Δ CCT| "
          f"{dev_abs.max():.3e} s, {int((dev_abs > 0).sum())} of "
          f"{len(want)} differ (its byte sums add in the JAX package's "
          f"order, K6, whatever the slab's padding: bit for bit)")
    if not np.array_equal(st.cct[4], want):
        fail(f"[{tag}] the ablation tenant differs from its offline "
             f"replay")
    for name in ("contention", "tick_walk", "maxmin"):
        if counts[name] != st.steps:
            fail(f"[{tag}] {name} launched {counts[name]} times for "
                 f"{st.steps} leaf-spine event steps")
    if counts["ssd_scan"] or counts["flash_attention"]:
        fail(f"[{tag}] a model kernel ran on the leaf-spine pool")
    check_sums(tag, counts, sums)
    return counts


def within(tag, what, got, want, bar=1e-2):
    """Fail unless `got` is within `bar` of `want` (relative); print
    both."""
    rel = abs(got - want) / want
    print(f"[{tag}] {what}: avg CCT {got:.6f} vs JAX {want:.6f} (relative "
          f"deviation {rel:.3e})")
    if rel > bar:
        fail(f"[{tag}] {what} deviates {rel:.3%} from the JAX package")


def learned_main_path(tag, fleet, leaf, known):
    """Phase 18: the learned-size fleet, its parity lanes and the learned
    leaf-spine pair against `LEARNED_GOLDEN` (fig_sampling's lanes are
    phase 23's). `known` is phase 4's result (the same traces with
    known sizes, for the wall beside). Returns the launch counts of the
    big-switch fleet run and of the leaf-spine pair, and the kernels'
    largest deviations from their plain versions on both runs' captured
    ticks."""
    from repro_torch.api import Scenario, run
    from repro_torch.kernels import ops
    from repro_torch.traces.synth import fb_like_trace

    gold = json.loads(LEARNED_GOLDEN.read_text())
    res, counts, captured = drive(tag, Scenario(
        engine="torch", traces=fleet, clairvoyance=False), fleet)
    for name in ("contention", "tick_walk"):
        if counts[name] != res.events:
            fail(f"[{tag}] {name} launched {counts[name]} times for "
                 f"{res.events} learned event steps")
    if counts["maxmin"] or counts["ssd_scan"] or counts["flash_attention"]:
        fail(f"[{tag}] K3, K4 or K5 ran on the learned big-switch fleet")
    print(f"[{tag}] learned fleet wall {res.wall_seconds:.3f} s, {res.events} "
          f"events, {res.ticks} ticks, against phase 4's known-size replay "
          f"in this run: {known.wall_seconds:.3f} s, {known.events} events, "
          f"{known.ticks} ticks; {smi()}")
    pair = run(Scenario(engine="torch", traces=fleet[:2], clairvoyance=False))
    print(f"[{tag}] lanes {gold['seeds']} alone: events {pair.events} vs JAX "
          f"{gold['fleet']['events']}, wall {pair.wall_seconds:.3f} s")
    if pair.events != gold["fleet"]["events"]:
        fail(f"[{tag}] the learned lanes took another event count than the "
             f"JAX package")
    for b, want in enumerate(gold["fleet"]["avg_cct"]):
        within(tag, f"learned lane {b} (fleet)", res.avg_cct[b], want)
        within(tag, f"learned lane {b} (alone)", pair.avg_cct[b], want)

    _, err = compare_ticks(tag, captured, exact_rates=False, learned=True)
    del captured

    traces = tuple(fb_like_trace(PARITY_COFLOWS, PORTS, seed=s)
                   for s in gold["seeds"])
    lres, lcounts, lcaptured = drive(tag, Scenario(
        engine="torch", traces=traces, topology=leaf, clairvoyance=False),
        traces, coflows=PARITY_COFLOWS)
    print(f"[{tag}] learned leaf-spine fb_like_trace({PARITY_COFLOWS}, "
          f"{PORTS}) lanes {gold['seeds']} ({leaf}): events {lres.events} vs "
          f"JAX {gold['leafspine']['events']}, wall {lres.wall_seconds:.3f} "
          f"s, launches {lcounts}")
    if lres.events != gold["leafspine"]["events"]:
        fail(f"[{tag}] the learned leaf-spine lanes took another event "
             f"count than the JAX package")
    for name in ("contention", "tick_walk", "maxmin"):
        if lcounts[name] != lres.events:
            fail(f"[{tag}] {name} launched {lcounts[name]} times for "
                 f"{lres.events} learned leaf-spine event steps")
    if lcounts["ssd_scan"] or lcounts["flash_attention"]:
        fail(f"[{tag}] a model kernel ran on the learned leaf-spine path")
    for b, want in enumerate(gold["leafspine"]["avg_cct"]):
        within(tag, f"learned leaf-spine lane {b}", lres.avg_cct[b], want)
    _, lerr = compare_ticks(tag, lcaptured, exact_rates=True, learned=True)
    err = {k: max(err[k], lerr[k]) for k in err}

    return counts, lcounts, err


def prefix_rows(B, F, seed, dev):
    """Seeded f32 rows (B, F): about a third zeros, the rest of
    magnitudes from 1 to 1e9 (tests/test_torch_cuda.py's `prefix_rows`)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = rng.uniform(1.0, 10.0, (B, F)) * 10.0 ** rng.integers(0, 9, (B, F))
    x[rng.uniform(size=(B, F)) < 0.3] = 0.0
    return torch.from_numpy(x.astype(np.float32)).to(dev)


def negative_zero_rows(F, seed):
    """Seeded f32 rows (4, F) with runs of -0.0 where XLA's scan chains
    start (tests/test_torch_cuda.py's `negative_zero_rows`): row 0 at
    the front, row 1 across a block-of-16 boundary, row 2 across a
    4096-tile boundary, row 3 all -0.0; 10% -0.0 scattered elsewhere."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.lognormal(0.0, 3.0, (4, F)) * rng.choice([-1.0, 1.0], (4, F))
    x[rng.uniform(size=x.shape) < 0.1] = -0.0
    x[0, :int(rng.integers(1, 301))] = -0.0
    b = 16 * int(rng.integers(1, max(F // 16, 1) + 1))
    x[1, max(b - 5, 0):b + 7] = -0.0
    t = 4096 if F > 4096 else b
    x[2, :3] = -0.0
    x[2, max(t - 40, 0):t + 40] = -0.0
    x[3] = -0.0
    return x.astype(np.float32)


def abs_err(got, want):
    """max |got - want| (0 for empty tensors)."""
    return float((got - want).abs().max()) if got.numel() else 0.0


def prefix_sum_phase(tag, grouped, leaf_grouped, tick_err):
    """Phase 20: K6 against `prefix_sum_ref` bit for bit on seeded rows
    of PREFIX_LENGTHS, then its time on phase 4's and phase 7's grouped
    segment-sum inputs (`grouped` (3 x 16, F), `leaf_grouped` (5 x 16,
    F)) and on the first sum's rows alone (16, F), the shape of a step's
    single sums, each beside the plain version's, `torch.cumsum`'s (one
    PyTorch call computing the same sums in another order; the port
    never calls it) and the bound (each input read once, the (R, F + 1)
    output written once, F adds a row); the CUDA launches and host
    microseconds of a call. Returns the K6 record of the kernels line
    (`ms` and its peers at (16, F); every shape under `shapes`); its
    `max_abs_err` is the largest |K6 - plain| over these rows and
    `tick_err`, that of the captured ticks' segment sums (phases 6, 9,
    18, 19)."""
    import torch

    from repro_torch.kernels import ops

    dev = grouped.device
    err = tick_err
    for F in PREFIX_LENGTHS:
        x = prefix_rows(4, F, F, dev)
        got, want = ops.prefix_sum(x), ops.prefix_sum(x, force="ref")
        torch.cuda.synchronize()
        if got.shape != (4, F + 1) or not torch.equal(
                got.view(torch.int32), want.view(torch.int32)):
            fail(f"[{tag}] K6 differs from its plain version at (4, {F})")
        err = max(err, abs_err(got, want))
    print(f"[{tag}] K6 == prefix_sum_ref bit for bit at (4, F) for F in "
          f"{PREFIX_LENGTHS} (zeros and magnitudes 1 to 1e9)")
    for F in NEG_ZERO_LENGTHS:
        x = torch.from_numpy(negative_zero_rows(F, F)).to(dev)
        got, want = ops.prefix_sum(x), ops.prefix_sum(x, force="ref")
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            fail(f"[{tag}] K6 differs from its plain version on the -0.0 "
                 f"runs at (4, {F})")
        if bool((got.view(torch.int32) == -2 ** 31).any()):
            fail(f"[{tag}] K6 wrote a -0.0 (XLA's chains start from +0.0)")
    print(f"[{tag}] K6 == prefix_sum_ref bit for bit on rows with -0.0 runs "
          f"at the front and across block and tile boundaries, F in "
          f"{NEG_ZERO_LENGTHS}; no -0.0 written (ROADMAP C11)")
    B = FLEET
    shapes = []
    for what, x in (("a single sum's rows of phase 4", grouped[:B]),
                    ("phase 4's grouped sums", grouped),
                    ("phase 7's grouped sums", leaf_grouped)):
        R, F = x.shape
        got, want = ops.prefix_sum(x), ops.prefix_sum(x, force="ref")
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            fail(f"[{tag}] K6 differs from its plain version on {what} "
                 f"({R}, {F})")
        err = max(err, abs_err(got, want))
        ms = cuda_ms(lambda: ops.prefix_sum(x), 200)
        plain = cuda_ms(lambda: ops.prefix_sum(x, force="ref"), 20)
        lib = cuda_ms(lambda: torch.cumsum(x, -1), 200)
        bnd, by = bound(4 * (R * F + R * (F + 1)), R * F)
        calls = cuda_launches(tag, lambda: ops.prefix_sum(x))
        host = host_us(lambda: ops.prefix_sum(x))
        print(f"[{tag}] K6 at ({R}, {F}), {what}: kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, torch.cumsum {lib:.4f} ms, bound "
              f"{bnd:.5f} ms ({by}); host {host:.2f} us a call; CUDA "
              f"launches a call: {calls}")
        shapes.append({"shape": [R, F], "ms": ms, "plain_ms": plain,
                       "bound_ms": bnd, "bound_by": by, "library_ms": lib,
                       "host_us": host})
    single = shapes[0]
    return {"name": "prefix_sum", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/prefix_sum.cu",
            "replaces": "src/repro/fabric/jax_engine.py:180",
            "max_abs_err": err, "ms": single["ms"],
            "plain_ms": single["plain_ms"], "bound_ms": single["bound_ms"],
            "bound_by": single["bound_by"],
            "library_ms": single["library_ms"], "shapes": shapes}


def drivers_phase(tag):
    """Phase 21: the port's drivers on the card at their defaults:
    `benchmarks/torch_pool_throughput.py` (16 sessions x 10 coflows;
    its bitwise-CCT and single-upload gates hold, the speedup is printed
    beside the reference's 4.0 and not gated; no cold passes, as phase 1
    built the kernels and earlier phases loaded them), Table 2's rows (a), (b)
    and (c) (`torch_table2_coordinator_latency.py`, its sub-second gate
    at 4096 coflows) and `torch_api_smoke.py` (the JAX package's CCTs at
    rtol 1e-5, the numpy engine within 1%, the session bit for bit its
    offline replay)."""
    import os

    from benchmarks import torch_api_smoke, torch_pool_throughput
    from benchmarks import torch_table2_coordinator_latency as table2

    gate = os.environ.get("SAATH_POOL_MIN_SPEEDUP")
    os.environ["SAATH_POOL_MIN_SPEEDUP"] = "0"
    try:
        rec = torch_pool_throughput.main(["--no-cold"])
    except AssertionError as e:
        fail(f"[{tag}] torch_pool_throughput: {e}")
    finally:
        if gate is None:
            os.environ.pop("SAATH_POOL_MIN_SPEEDUP")
        else:
            os.environ["SAATH_POOL_MIN_SPEEDUP"] = gate
    print(f"[{tag}] torch_pool_throughput ({rec['sessions']} sessions): "
          f"pooled CCTs == sequential bit "
          f"for bit, {rec['full_uploads']} full upload; sequential "
          f"{rec['wall_sequential']:.3f} s, pool {rec['wall_pool']:.3f} s "
          f"(best of two warm passes; kernel builds during the drive "
          f"{rec['build_seconds']:.2f} s): speedup {rec['speedup']:.3f}x "
          f"against the reference's gate {POOL_GATE}x ("
          f"{'met' if rec['speedup'] >= POOL_GATE else 'NOT met'}; read, "
          f"not gated); {rec['sessions_per_sec']:.1f} sessions/s; {smi()}")
    try:
        rows = table2.main([])
        smoke = torch_api_smoke.main([])
    except AssertionError as e:
        fail(f"[{tag}] a benchmark's gate failed: {e}")
    for r in rows:
        print(f"[{tag}] Table 2 {r['impl']} C={r['C']} P={r['P']}: "
              f"{r['avg_ms']:.4f} ms (p90 {r['p90_ms']:.4f}); {r['note']}")
    print(f"[{tag}] torch_api_smoke: avg CCT {smoke['avg_cct']:.6f} s, max "
          f"relative deviation from the JAX package {smoke['max_rel_dev']:.3e}"
          f", torch / numpy engine avg CCT {smoke['engine_ratio']:.6f}; the "
          f"3-step session equals the offline replay bit for bit")


@contextlib.contextmanager
def capture_contention(keep=5):
    """Spy on `ops.contention` as the host plane's policies call it
    (`core.contention`, the active rows only): keep clones of the `keep`
    calls on the card with the most rows (the heaviest ticks), in
    `grabbed`."""
    from repro_torch.kernels import ops

    real = ops.contention
    grabbed = []

    def spy(a_s, a_r, active, **kw):
        out = real(a_s, a_r, active, **kw)
        if a_s.is_cuda and (len(grabbed) < keep or
                            a_s.shape[1] > grabbed[-1][0].shape[1]):
            grabbed.append((a_s.clone(), a_r.clone(), active.clone()))
            grabbed.sort(key=lambda g: -g[0].shape[1])
            del grabbed[keep:]
        return out

    ops.contention = spy
    try:
        yield grabbed
    finally:
        ops.contention = real


def line_buffered():
    """A worker process's start: its printed lines reach the smoke's
    output whole and in time."""
    sys.stdout.reconfigure(line_buffering=True)


def worker_pool(n):
    """`n` worker processes (spawned: the parent holds a CUDA context);
    leaving its `with` block waits for them and stops them."""
    return concurrent.futures.ProcessPoolExecutor(
        n, mp_context=multiprocessing.get_context("spawn"),
        initializer=line_buffered)


def host_plane_replay(name):
    """Phase 22's replay of policy `name` in a worker process: through a
    FULL `torch_common.Bench` on the card (the numpy engine), the launch
    counters set to 0 just before and read just after. Returns (the
    result, its launch counts, its host<->device transfer counts, K1's
    heaviest card incidences (saath and lwtf's own calls; saath-torch's
    come whole from its tick, phase 6's shape) copied to the host)."""
    from benchmarks import torch_common
    from repro_torch.core import transfer
    from repro_torch.kernels import ops

    bench = torch_common.Bench(quick=False, device="cuda")
    io0 = transfer.counts()
    with (capture_contention() if name in ("saath", "lwtf")
          else contextlib.nullcontext([])) as caught:
        ops.reset_launches()
        r = bench.run(name, engine="numpy")
        counts = ops.launch_counts()
    io = {k: v - io0[k] for k, v in transfer.counts().items()}
    return r, counts, io, [tuple(t.cpu() for t in g) for g in caught]


def cpu_replay(sc):
    """`repro_torch.api.run(sc)` in a worker process: the CPU replays
    that phases 22 and 23 hold the card's replays against."""
    from repro_torch.api import run

    return run(sc)


def host_plane_phase(tag, bench):
    """Phase 22: the event-driven host plane (see the module docstring),
    its replays through `bench` (`torch_common.Bench` at FULL on the
    card), whose cache phase 23's fig9 then reads for its host
    baselines. Returns the launch counts of its replays on the card (the
    `host_plane` path) and K1's largest deviation from its plain version
    on the captured incidences."""
    import numpy as np

    from repro_torch.api import Scenario
    from repro_torch.kernels import ops
    from repro_torch.traces.synth import fb_like_trace

    gold = json.loads(NUMPY_GOLDEN.read_text())["rows"]
    tr = fb_like_trace(COFLOWS, PORTS, seed=0)
    if bench.quick or bench.device != "cuda" or \
            bench.scenario().synth != dict(num_coflows=COFLOWS,
                                           num_ports=PORTS, seed=0):
        fail(f"[{tag}] the bench is not fb_like_trace({COFLOWS}, {PORTS}, "
             f"seed=0) on the card")
    total = None
    res = {}
    grabbed = []
    # every replay in a worker process of its own, all at once: the card's
    # nine (saath, lwtf and saath-torch launch kernels, the six host
    # policies never touch the card) and the CPU replays of saath and
    # lwtf; the walls printed are those of concurrent replays
    with worker_pool(HOST_WORKERS) as pool:
        cpu_jobs = {name: pool.submit(cpu_replay, Scenario(
            engine="numpy", policy=name, device="cpu", trace=tr))
            for name in ("saath", "lwtf")}
        jobs = {name: pool.submit(host_plane_replay, name)
                for name in reversed(HOST_PLANE)}
        try:
            cpu = {name: job.result() for name, job in cpu_jobs.items()}
            done = {name: job.result() for name, job in jobs.items()}
        except Exception as e:
            fail(f"[{tag}] a replay's worker process failed: {e!r}")
    for name in HOST_PLANE:
        want = gold["saath-jax" if name == "saath-torch" else name]
        r, counts, io, caught = done[name]
        bench.add(r)
        caught = [tuple(t.cuda() for t in g) for g in caught]
        grabbed = sorted(grabbed + caught, key=lambda g: -g[0].shape[1])[:5]
        total = counts if total is None else \
            {k: total[k] + v for k, v in counts.items()}
        res[name] = r
        cct = r.row_cct()
        if cct.shape != (len(tr.coflows),) or not (cct > 0).all():
            fail(f"[{tag}] {name}: unfinished or non-positive CCTs")
        t = r.table()
        if abs(t.sent.sum() - t.size.sum()) > 1e-5 * t.size.sum():
            fail(f"[{tag}] {name}: bytes delivered differ from the trace's")
        avg = float(r.avg_cct[0])
        rel = abs(avg - want["avg_cct"]) / want["avg_cct"]
        ndiff = int((cct != np.asarray(want["cct"])).sum())
        k1 = counts["contention"]
        k2 = counts["tick_walk"]
        steps = r.steps
        moved = io["h2d_bytes"] + io["d2h_bytes"]
        print(f"[{tag}] {name} on fb_like_trace({COFLOWS}, {PORTS}, seed=0): "
              f"steps {steps} (golden {want['steps']}), avg CCT {avg!r} "
              f"(golden {want['avg_cct']!r}, relative deviation "
              f"{rel:.3e}), p90 {r.summary()['p90_cct']!r}; CCTs differing "
              f"from the golden: {ndiff} of {cct.size}; K1 launches {k1}, "
              f"K2 {k2}; host<->device {moved / max(steps, 1):.0f} B a step "
              f"({io['h2d_copies']} uploads, {io['d2h_copies']} downloads); "
              f"wall {r.wall_seconds:.3f} s, {1e3 * r.wall_seconds / steps:.3f}"
              f" ms a step ({1e3 * r.sched_seconds / steps:.3f} ms in the "
              f"policy); kernel builds {r.build_seconds:.2f} s; {smi()}")
        if steps != want["steps"]:
            fail(f"[{tag}] {name} took {steps} steps, the golden "
                 f"{want['steps']}")
        if rel > (1e-2 if name == "saath-torch" else 1e-9):
            fail(f"[{tag}] {name}'s avg CCT deviates {rel:.3e} from the "
                 f"golden")
        uses_k1 = name in ("saath", "lwtf", "saath-torch")
        if k1 != (steps if uses_k1 else 0) or \
                k2 != (steps if name == "saath-torch" else 0):
            fail(f"[{tag}] {name}: K1 launched {k1}, K2 {k2} times for "
                 f"{steps} steps")
        if counts["maxmin"] or counts["ssd_scan"] or \
                counts["flash_attention"] or counts["prefix_sum"]:
            fail(f"[{tag}] {name}: a kernel off the host plane's path ran")
    st, sj = res["saath"], res["saath-torch"]
    print(f"[{tag}] saath-torch against numpy Saath on the same trace: avg "
          f"CCT relative distance "
          f"{abs(st.avg_cct[0] - sj.avg_cct[0]) / st.avg_cct[0]:.3e} (the "
          f"reference's saath-jax sits "
          f"{abs(gold['saath-jax']['avg_cct'] - gold['saath']['avg_cct']) / gold['saath']['avg_cct']:.3e}"
          f" from its numpy Saath)")
    for name in ("saath", "lwtf"):
        card, host = res[name], cpu[name]
        if host.steps != card.steps or not (
                np.array_equal(host.cct, card.cct)
                and np.array_equal(host.fct, card.fct)):
            fail(f"[{tag}] {name} on the card differs from its CPU run")
        print(f"[{tag}] {name}: the card's replay equals a device='cpu' "
              f"replay bit for bit (steps {card.steps}, CCTs, FCTs; walls: "
              f"card {card.wall_seconds:.3f} s, CPU "
              f"{host.wall_seconds:.3f} s)")
    err = hold_kernels(tag, "the host plane", [], grabbed)["contention"]
    a_s, a_r, act = grabbed[0]
    ms = cuda_ms(lambda: ops.contention(a_s, a_r, act), 50)
    plain = cuda_ms(lambda: ops.contention(a_s, a_r, act, force="ref"), 10)
    lib = cuda_ms(lambda: contention_library(
        a_s.bfloat16(), a_r.bfloat16(), act), 10)
    bnd, by = contention_bound_ms(a_s, a_r, act)
    host = host_us(lambda: ops.contention(a_s, a_r, act))
    print(f"[{tag}] K1 at the heaviest host-plane incidence "
          f"{tuple(a_s.shape)}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
          f"bf16 matmul {lib:.4f} ms, bound {bnd:.5f} ms ({by}); host "
          f"{host:.2f} us a call")
    sa, aa = res["saath"].summary(), res["aalo"].summary()
    print(f"[{tag}] Aalo / Saath on fb_like_trace({COFLOWS}, {PORTS}, "
          f"seed=0): avg CCT {aa['avg_cct'] / sa['avg_cct']:.4f}x, p90 CCT "
          f"{aa['p90_cct'] / sa['p90_cct']:.4f}x")
    return total, err


def tick_shape(c):
    """What sets a captured tick's kernel inputs apart: lanes x coflows,
    the fill, whether flows came with it, and which structure switches
    (the batch's and the params' optional fields) it carries."""
    _, batch, _, dp, flows, fill, _ = c
    return (tuple(batch.active.shape), fill, flows is None,
            tuple(x is None for x in batch), tuple(x is None for x in dp))


def hold_kernels(tag, what, captured, caught):
    """K1, K2, K6 (and K3 where a tick fills max-min) against their plain
    versions on the inputs one run gave them: `compare_ticks` on the
    three heaviest captured ticks of each tick shape, and K1 bit for
    bit on the card incidences `capture_contention` kept. Returns the
    largest deviations."""
    import torch

    from repro_torch.kernels import ops

    groups = {}
    for c in captured:
        groups.setdefault(tick_shape(c), []).append(c)
    err = {n: 0.0 for n in ("contention", "tick_walk", "maxmin_rates",
                            "prefix_sum")}
    for ticks in groups.values():
        _, e = compare_ticks(tag, ticks, exact_rates=False)
        err = {k: max(err[k], e[k]) for k in err}
    for a_s, a_r, act in caught:
        got = ops.contention(a_s, a_r, act)
        ref = ops.contention(a_s, a_r, act, force="ref")
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"[{tag}] {what}: K1 differs from its plain version on a "
                 f"captured {tuple(a_s.shape)} incidence")
        err["contention"] = max(err["contention"],
                                float((got - ref).abs().max()))
    ticks = (f"kernels == plain versions on the heaviest captured ticks of "
             f"each of its {len(groups)} tick shapes "
             f"{sorted({k[0] for k in groups})}; " if groups else "")
    print(f"[{tag}] {what}: {ticks}K1 == contention_ref on the "
          f"{len(caught)} heaviest card incidences "
          f"{[tuple(g[0].shape) for g in caught]}", flush=True)
    return err


def figure_driver(tag, name, bench=None):
    """The figure driver `name` (`FIGURES`) through its own
    `run(bench, engine="torch")` on the card (`bench` None: a QUICK
    bench of its own, as in a worker process), the launch counters set
    to 0 just before and read just after, every front-door replay it
    makes recorded; its gates must hold, no kernel off the figures' path
    may run, and its captured ticks and K1 incidences are held to the
    plain versions (`hold_kernels`). Returns (its rows, its launch
    counts, the kernels' largest deviations, [(scenario, result)] of its
    replays)."""
    import importlib

    from benchmarks import torch_common
    from repro_torch.kernels import ops

    if bench is None:
        bench = torch_common.Bench(quick=True, device="cuda")
    mod = importlib.import_module(f"benchmarks.torch_{name}")
    real_run = torch_common.api_run
    replays = []

    def spy(sc):
        res = real_run(sc)
        replays.append((sc, res))
        return res

    patched = [m for m in (torch_common, mod)
               if getattr(m, "api_run", None) is real_run]
    for m in patched:
        m.api_run = spy
    try:
        with capture_ticks(FIGURE_CAPTURE_EVERY) as captured, \
                capture_contention() as caught:
            ops.reset_launches()
            t0 = time.perf_counter()
            try:
                rows = mod.run(bench, engine="torch")
            except AssertionError as e:
                fail(f"[{tag}] torch_{name}: a gate failed: {e}")
            finally:
                counts = ops.launch_counts()
            wall = time.perf_counter() - t0
    finally:
        for m in patched:
            m.api_run = real_run
    size = ("QUICK", torch_common.QUICK) if bench.quick else \
        ("FULL", torch_common.FULL)
    print(f"[{tag}] torch_{name} at {size[0]} {size[1]}: every gate "
          f"holds; wall {wall:.3f} s; K1 launches "
          f"{counts['contention']}, K2 {counts['tick_walk']}, K6 "
          f"{counts['prefix_sum']} ({counts['prefix_sum_rows']} "
          f"rows), K3 {counts['maxmin']} (replays cached by phase "
          f"22 or earlier in its process are not rerun)", flush=True)
    if counts["ssd_scan"] or counts["flash_attention"] or counts["maxmin"]:
        fail(f"[{tag}] torch_{name}: a kernel off the figures' path ran")
    err = hold_kernels(tag, f"torch_{name}", captured, caught)
    return rows, counts, err, replays


def figures_phase(tag, full, known):
    """Phase 23: the paper's figure drivers on the card (module
    docstring); fig9 on `full`, the FULL bench phase 22 filled, then
    the QUICK ones at once, each in a worker process on a QUICK bench of
    its own (`figure_driver`), beside the fleet's CPU fidelity replay;
    their replays then fill `quick`. `known` is phase 4's result (lane 0
    is fig9's Saath row). Returns the launch counts of their replays
    (the `figures` path) and the kernels' largest deviations from their
    plain versions on the inputs captured from them."""
    import numpy as np

    from benchmarks import torch_common
    from repro_torch.api import Scenario
    from repro_torch.traces.synth import fb_like_trace

    real_run = torch_common.api_run
    rows, total, err, replays = figure_driver(tag, FIGURES[0], full)
    for r in rows:
        if "p50" in r:
            print(f"[{tag}] fig9 Saath against {r['vs']}: p50 "
                  f"{r['p50']:.4f}x, p90 {r['p90']:.4f}x, overall "
                  f"{r['overall']:.4f}x")
        else:
            print(f"[{tag}] fig9 {r['vs']}: wall {r['wall_s']:.4f} s, "
                  f"speedup {r['speedup']:.3f}x ({r['note']})")
    print(f"[{tag}] fig9 fleet: {rows[-1]['speedup']:.3f}x against the gate "
          f"{os.environ.get('SAATH_FLEET_MIN_SPEEDUP', '5.0')}x; {smi()}")
    fsc, fid = next((sc, r) for sc, r in replays
                    if sc.label == "fleet-fidelity")
    with worker_pool(len(FIGURES)) as pool:
        fid_cpu = pool.submit(cpu_replay, dataclasses.replace(
            fsc, device="cpu", warm_timing=False))
        jobs = [pool.submit(figure_driver, tag, name)
                for name in FIGURES[1:]]
        try:
            cpu = fid_cpu.result()
            for job in jobs:
                _, counts, e, more = job.result()
                total = {k: total[k] + v for k, v in counts.items()}
                err = {k: max(err[k], e[k]) for k in err}
                replays += more
        except BaseException as e:
            fail(f"[{tag}] a figure driver's worker process failed: {e!r}")
    quick = torch_common.Bench(quick=True, device="cuda")
    for _, res in replays:
        quick.add(res)
    for k in ("contention", "tick_walk", "prefix_sum"):
        if not total[k]:
            fail(f"[{tag}] {k} was not launched by the figure drivers")

    # the rows against references
    gold = json.loads(GOLDEN.read_text())
    saath = full.run("saath", engine="torch")
    if not np.array_equal(saath.row_cct(0), known.row_cct(0)):
        fail(f"[{tag}] fig9's Saath row differs from phase 4's lane 0")
    rel = abs(saath.avg_cct[0] - gold["avg_cct"][0]) / gold["avg_cct"][0]
    print(f"[{tag}] fig9 Saath row (fb_like_trace({COFLOWS}, {PORTS}, "
          f"seed=0)): CCTs bit for bit phase 4's lane 0; avg CCT "
          f"{saath.avg_cct[0]:.6f} vs JAX {gold['avg_cct'][0]:.6f} "
          f"(relative deviation {rel:.3e})")
    if rel > 1e-2:
        fail(f"[{tag}] fig9's Saath row deviates {rel:.3%} from the JAX "
             f"package")
    seq = next((sc, res) for sc, res in replays if sc.label == "fleet-seq")
    if cpu.steps != fid.steps or not np.array_equal(cpu.cct, fid.cct,
                                                    equal_nan=True):
        fail(f"[{tag}] the fleet's fidelity replay on the card differs from "
             f"its device='cpu' replay")
    print(f"[{tag}] fig9 fleet-fidelity ({len(fsc.traces)} lanes): the "
          f"card's batched replay equals the same scenario's device='cpu' "
          f"replay bit for bit (steps {fid.steps}, CCTs; CPU wall "
          f"{cpu.wall_seconds:.3f} s)")
    sc, host = seq
    card = real_run(dataclasses.replace(sc, device="cuda"))
    if not np.array_equal(card.cct, host.cct, equal_nan=True):
        fail(f"[{tag}] the fleet's sequential replays with K1 on the card "
             f"differ from the host-only ones")
    print(f"[{tag}] fig9 fleet-seq: host-only (the gate's yardstick) "
          f"{host.wall_seconds:.4f} s, with Saath's K1 on the card "
          f"{card.wall_seconds:.4f} s ({card.wall_seconds / host.wall_seconds:.4f}"
          f"x), CCTs equal; {smi()}")
    lgold = json.loads(LEARNED_GOLDEN.read_text())["fig_sampling"]
    lanes = [("known", quick.run("saath", engine="torch"))] + [
        (sc.label[len("sampling-"):], res) for sc, res in replays
        if sc.engine == "torch" and sc.label.startswith("sampling-")]
    for lane, res in lanes:
        want = lgold[lane]
        within(tag, f"QUICK {lane} row ({res.events} events, JAX "
               f"{want['events']})", res.avg_cct[0], want["avg_cct"])
        if res.events != want["events"]:
            fail(f"[{tag}] the QUICK {lane} row took {res.events} events, "
                 f"the JAX package {want['events']}")
    # the sweep over [known, learned] against the driver's solo lanes
    solo = {sc.label: (sc, res) for sc, res in replays
            if sc.engine == "torch" and sc.label.startswith("sampling-")}
    ksc, kres = solo["sampling-known"]
    p = ksc.params
    sweep = real_run(Scenario(engine="torch", trace=fb_like_trace(
        FIG_COFLOWS, FIG_PORTS, seed=0), sweep=(
            p, dataclasses.replace(p, clairvoyant=False))))
    if not np.array_equal(sweep.row_cct(0), kres.row_cct(0)):
        fail(f"[{tag}] the sweep's known row differs from the solo known run")
    if np.array_equal(sweep.row_cct(1), kres.row_cct(0)):
        fail(f"[{tag}] the sweep's learned row equals the known schedule")
    dev_l = np.abs(sweep.row_cct(1)
                   - solo["sampling-learned"][1].row_cct(0)).max()
    print(f"[{tag}] sweep [known, learned]: the known row equals the solo "
          f"known run bit for bit, the learned row differs from it (max "
          f"|Δ CCT| to the solo learned run {dev_l:.3e} s)")
    return total, err


def bridge_workload():
    """The bridge workload, from the port's one copy of it."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(BRIDGE_EXAMPLE.stem,
                                                  BRIDGE_EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.bridge_workload()


def bridge_phase(tag):
    """Phase 24: the runtime bridge on the card (module docstring).
    Returns the launch counts of the planner's run (the `bridge`
    path) and the kernels' largest deviations from their plain versions
    on its ticks."""
    import statistics

    import torch
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.runtime.buckets import bucketize, leaves_with_path
    from repro_torch.runtime.coflow_bridge import (grad_bucket_coflows,
                                                   plan_waves)
    from repro_torch.runtime.overlap import scheduled_psum

    cfs = bridge_workload()
    torch.cuda.synchronize()
    with capture_ticks(1) as captured, capture_contention() as caught:
        ops.reset_launches()
        try:
            waves = plan_waves(cfs, num_chips=16, backend="torch")
            torch.cuda.synchronize()
        finally:
            counts = ops.launch_counts()
    err = hold_kernels(tag, "plan_waves", captured, caught)
    del captured, caught
    host = plan_waves(cfs, num_chips=16, backend="numpy")
    if waves != host or waves != BRIDGE_WAVES:
        fail(f"[{tag}] plan_waves on the card {waves} differs from the numpy "
             f"backend's {host} or the reference's {BRIDGE_WAVES}")
    for k in ("contention", "tick_walk"):
        if not counts[k]:
            fail(f"[{tag}] the planner launched no {k}")
    if counts["maxmin"] or counts["ssd_scan"] or counts["flash_attention"]:
        fail(f"[{tag}] a kernel off the planner's path ran")
    walls = []
    for _ in range(PLAN_REPS):
        t0 = time.perf_counter()
        plan_waves(cfs, num_chips=16, backend="torch")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    plan_waves(cfs, num_chips=16, backend="numpy")
    np_ms = 1e3 * (time.perf_counter() - t0)
    print(f"[{tag}] plan_waves on the bridge workload ({len(cfs)} "
          f"collectives, 16 chips, {len(waves)} waves): torch backend on the "
          f"card == numpy backend == the reference's waves; K1 launches "
          f"{counts['contention']}, K2 {counts['tick_walk']}, K6 "
          f"{counts['prefix_sum']} a call; "
          f"{1e3 * statistics.median(walls):.3f} ms a call (median of "
          f"{PLAN_REPS}; min {1e3 * min(walls):.3f}), numpy backend "
          f"{np_ms:.3f} ms; {smi()}", flush=True)

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(0)
    tree = {f"layer{i}": {"w": torch.randn(256, 256 + 64 * i, generator=g),
                          "b": torch.randn(256, generator=g)}
            for i in range(6)}
    tree = {k: {n: t.to(dev) for n, t in v.items()} for k, v in tree.items()}
    bks = bucketize(tree, bucket_bytes=1 << 19)
    pwaves = plan_waves(grad_bucket_coflows(bks), num_chips=16,
                        backend="torch")
    flat = [leaf for _, leaf in leaves_with_path(tree)]
    issued = []
    real = dist.all_reduce
    sizes = {sum(flat[i].numel() for i in b.leaf_idx): f"grad/{b.bid}"
             for b in bks}

    def spy(x, group=None, async_op=False):
        issued.append(sizes[x.numel()])
        return real(x, group=group, async_op=async_op)

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        dist.all_reduce = spy
        try:
            out = scheduled_psum(flat, bks, pwaves)
        finally:
            dist.all_reduce = real
        torch.cuda.synchronize()
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    if len(sizes) != len(bks) or \
            issued != [n for w in pwaves for n in w]:
        fail(f"[{tag}] scheduled_psum issued {issued}, not the waves "
             f"{pwaves}")
    for a, b in zip(out, flat):
        if a.device != dev or not torch.equal(a, b):
            fail(f"[{tag}] scheduled_psum over a world of 1 changed a value")
    print(f"[{tag}] scheduled_psum over a {backend} world of 1 (HashStore "
          f"rendezvous): {len(flat)} leaves in {len(bks)} buckets "
          f"({sum(b.bytes for b in bks)} B) returned unchanged on the card, "
          f"all-reduces issued in wave order {pwaves}")
    return counts, err


def server_main_path(tag, params):
    """Phase 19: the `CoflowServer` front door (see the module docstring).
    Returns the launch counts and the kernels' largest deviations from
    their plain versions on the server's captured ticks."""
    import numpy as np
    import torch

    from repro_torch.api import Scenario, run
    from repro_torch.fabric import engine as eng
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import (AdmissionError, CoflowServer,
                                          QuotaExceededError, TenantQuota)
    from repro_torch.traces.synth import fb_like_trace

    n = SERVER_TENANTS
    traces = [fb_like_trace(SERVER_COFLOWS, PORTS, seed=100 + i)
              for i in range(n)]
    quotas = {10: TenantQuota(max_live_coflows=4, policy="reject"),
              11: TenantQuota(max_live_coflows=4, slo=0.5, policy="defer")}
    learned = [i % 2 == 1 for i in range(n)]
    plain = [i for i in range(n) if i not in quotas]
    offline = {}
    for flag in (False, True):
        ids = [i for i in plain if learned[i] == flag]
        r = run(Scenario(engine="torch", traces=tuple(traces[i] for i in ids),
                         clairvoyance=False if flag else None))
        offline.update({i: r.row_cct(j) for j, i in enumerate(ids)})

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    steps, sums, real = [0], {"calls": 0, "rows": 0}, eng.session_advance

    def spy(*a, **kw):
        out = real(*a, **kw)
        steps[0] += out[1]
        add_sums(sums, out[1], a[1], kw["features"])
        return out

    ops.reset_launches()
    eng.session_advance = spy
    t0 = time.perf_counter()
    srv = CoflowServer(params, num_ports=PORTS, max_tenants=SERVER_ROWS,
                       features=(True, True, False, False, True))
    waiting, refused, queues, cid_of = list(range(n)), [], {}, {}
    cct = {i: np.full(SERVER_COFLOWS, np.nan) for i in plain}
    agg, quota_sheds, walls = {}, 0, []
    parts = dict(submit=0.0, advance=0.0, poll=0.0)

    def register(first):
        """Register waiting tenants in turn; after the first round stop
        at the first refusal (the cap is reached)."""
        for i in list(waiting):
            try:
                srv.register(f"t{i}", quota=quotas.get(i), mechanisms=(
                    {"clairvoyant": False} if learned[i] else None))
            except AdmissionError:
                refused.append(i)
                if first:
                    continue
                return
            waiting.remove(i)
            queues[i] = sorted(traces[i].coflows,
                               key=lambda c: (c.arrival, c.cid))
            cid_of[i] = {}

    try:
        with capture_ticks() as captured:
            register(first=True)
            while queues:
                t_adv = time.perf_counter()
                dt = 16 * params.delta if any(queues.values()) else POOL_DRAIN
                for i, q in queues.items():
                    name = f"t{i}"
                    clock = srv._tenants[name].now + dt
                    batch = []
                    while q and q[0].arrival < clock:
                        batch.append(q.pop(0))
                    if not batch:
                        continue
                    try:
                        handles = srv.submit(name, batch)
                    except QuotaExceededError:
                        quota_sheds += 1
                        continue
                    cid_of[i].update(zip(handles, (c.cid for c in batch)))
                t_mid = time.perf_counter()
                srv.advance(dt)
                t_polls = time.perf_counter()
                parts["submit"] += t_mid - t_adv
                parts["advance"] += t_polls - t_mid
                for i in list(queues):
                    name = f"t{i}"
                    for d in srv.poll(name):
                        if i in cct:
                            c = cid_of[i].pop(d.handle)
                            cct[i][c] = d.cct
                    if not queues[i] and not srv.num_live(name) \
                            and not srv._deferred[name]:
                        agg[i] = dataclasses.asdict(srv.aggregates(name))
                        srv.evict(name)
                        del queues[i]
                        register(first=False)
                parts["poll"] += time.perf_counter() - t_polls
                walls.append(1e3 * (time.perf_counter() - t_adv))
            torch.cuda.synchronize()
    finally:
        eng.session_advance = real
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    st = srv.stats()
    w = np.array(walls)
    print(f"[{tag}] CoflowServer, {n} tenants x fb_like_trace("
          f"{SERVER_COFLOWS}, {PORTS}) through {SERVER_ROWS} rows: "
          f"{len(w)} advances, event steps {steps[0]}, wall {wall:.3f} s, "
          f"wall per advance median {np.median(w):.3f} ms p99 "
          f"{np.percentile(w, 99):.3f} ms (δ = {1e3 * params.delta:.0f} ms),"
          f" peak device memory {peak / 2**20:.1f} MiB above the "
          f"{base / 2**20:.1f} MiB held before, launches {counts}; "
          f"pool.io {srv.pool.io}; stats {st}; admission refusals of "
          f"tenants {refused}; where the wall went (s): " + ", ".join(
              f"{k} {v:.3f}" for k, v in parts.items())
          + " (advance: the pooled advance, harvest and deferred retries; "
          "poll: polls, evictions, registrations)")
    if sorted(set(refused)) != list(range(SERVER_ROWS, n)):
        fail(f"[{tag}] admission refused tenants {sorted(set(refused))}, "
             f"not exactly those past the {SERVER_ROWS}-row cap")
    if st["tenants"] or st["live_coflows"] or st["deferred_pending"] \
            or st["rejected"] != len(refused) or len(agg) != n:
        fail(f"[{tag}] the server's stats are inconsistent: {st}")
    for i in quotas:
        a = agg[i]
        print(f"[{tag}] tenant {i} ({quotas[i].policy}): completed "
              f"{a['coflows']}, shed {a['shed']}, deferred {a['deferred']}")
        if a["coflows"] + a["shed"] != SERVER_COFLOWS or not a["shed"]:
            fail(f"[{tag}] quota tenant {i} does not account for every "
                 f"coflow once, or shed none: {a}")
    if not agg[11]["deferred"] or quota_sheds == 0:
        fail(f"[{tag}] the quota tenants deferred or rejected nothing")
    for i in plain:
        want, got = offline[i], cct[i]
        if agg[i]["coflows"] != SERVER_COFLOWS:
            fail(f"[{tag}] tenant {i} completed {agg[i]['coflows']} coflows")
        if not learned[i]:
            if not np.array_equal(got, want):
                fail(f"[{tag}] known tenant {i}: "
                     f"{int((got != want).sum())} per-coflow CCTs differ "
                     f"from its offline replay")
            continue
        d = np.abs(got - want)
        print(f"[{tag}] learned tenant {i} against its offline replay: "
              f"{int((d > 0).sum())} of {SERVER_COFLOWS} CCTs differ, max "
              f"|Δ| {d.max():.3e} s (C9's bar: rtol 1e-2, atol 2δ)")
        if not np.all(d <= 2 * params.delta + 1e-2 * np.abs(want)):
            fail(f"[{tag}] learned tenant {i} is outside C9's bar")
    print(f"[{tag}] known tenants {[i for i in plain if not learned[i]]} "
          f"equal their offline replay bit for bit")
    for name in ("contention", "tick_walk"):
        if counts[name] != steps[0]:
            fail(f"[{tag}] {name} launched {counts[name]} times for "
                 f"{steps[0]} event steps")
    if counts["maxmin"] or counts["ssd_scan"] or counts["flash_attention"]:
        fail(f"[{tag}] K3, K4 or K5 ran on the big-switch server")
    check_sums(tag, counts, sums)
    _, err = compare_ticks(tag, captured, exact_rates=False, learned=True)
    return counts, err


ANALYSIS_WARM = 8        # advances that warm a pool path (captured)
ANALYSIS_GUARDED = 4     # advances under both guards
ANALYSIS_COFLOWS = 64    # coflows a pool tenant submits up front
ANALYSIS_SCHEDULES = 2   # explorer schedules on the card
STEP_KERNELS = ("contention", "tick_walk", "maxmin", "prefix_sum")
FRESH_CHILD = r"""
import pathlib, sys
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.analysis.sanitize import RecompileError, assert_no_recompiles
from repro_torch.kernels import build, ops
build.BUILD_DIR = pathlib.Path(sys.argv[2])
a = torch.zeros((1, 64, 150), dtype=torch.bool, device="cuda")
active = torch.ones((1, 64), dtype=torch.bool, device="cuda")
try:
    with assert_no_recompiles():
        ops.contention(a, a, active)
except RecompileError as e:
    print("RAISED", e)
    sys.exit(0)
print("NOT RAISED")
sys.exit(1)
"""


def must_raise(tag, what, exc, fn):
    """A negative control: `fn` must raise `exc`; anything else fails the
    phase (another exception propagates)."""
    try:
        fn()
    except exc as e:
        print(f"[{tag}] control {what}: raised {type(e).__name__}: "
              f"{str(e)[:150]}")
        return
    fail(f"[{tag}] control {what} did not raise")


def step_scan(tag, what, fn, *args, **kw):
    """`fn` under the op scan on the card, its kernel counters set to 0
    just before: no f64 site, no host sync, and each `kernel:*` entry
    equal to its launch counter. Returns the scan."""
    import torch

    from repro_torch.analysis.op_scan import scan
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launches()
    s = scan(fn, *args, **kw)
    torch.cuda.synchronize()
    return check_scan(tag, what, s, ops.launch_counts())


def check_scan(tag, what, s, counts):
    """The hard invariants of a scan and its kernel calls against the
    launch counters of its run."""
    if s.f64_sites or s.host_sites:
        fail(f"[{tag}] {what}: f64 sites {s.f64_sites}, host sites "
             f"{s.host_sites}")
    launched = {k: counts[k] for k in STEP_KERNELS if counts[k]}
    if s.kernels != launched:
        fail(f"[{tag}] {what}: kernel calls {s.kernels} but launches "
             f"{launched}")
    return s


def guarded(tag, what, advance, io, n):
    """`n` calls of `advance()` (a warm advance and its polls) that set
    the card's peak of allocated memory, then `n` more under
    `assert_no_recompiles()` and `assert_no_transfers()`: nothing may
    raise (no build, no higher peak), and the guard's counted downloads
    must equal the `io` ledger's (one byte a flag read, the rest the
    pool's download and control bytes)."""
    import torch

    from repro_torch.analysis.sanitize import (assert_no_recompiles,
                                               assert_no_transfers)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(n):
        advance()
    torch.cuda.synchronize()
    before = dict(io)
    with assert_no_recompiles() as built, assert_no_transfers() as g:
        for _ in range(n):
            advance()
        torch.cuda.synchronize()
    d = {k: io[k] - before[k] for k in io}
    want = d["loop_reads"] + d["download_bytes"] + d["ctl_bytes"]
    print(f"[{tag}] {what}: {n} warm advances under assert_no_recompiles "
          f"and assert_no_transfers: built {built.compiles}; downloads "
          f"{g.downloads} ({g.flag_reads} flag reads, io loop_reads "
          f"{d['loop_reads']}), {g.download_bytes} bytes (io: "
          f"{d['download_bytes']} + ctl {d['ctl_bytes']} + flags), uploads "
          f"{g.uploads} ({g.upload_bytes} bytes; io upload_bytes "
          f"{d['upload_bytes']}), dispatches {d['dispatches']}")
    if g.flag_reads != d["loop_reads"] or g.download_bytes != want:
        fail(f"[{tag}] {what}: the guard counted {g.flag_reads} flag reads "
             f"and {g.download_bytes} bytes, the io ledger "
             f"{d['loop_reads']} and {want}")
    if d["upload_bytes"] or d["full_uploads"] or d["row_uploads"]:
        fail(f"[{tag}] {what}: a warm clean-row advance uploaded {d}")
    print(f"[{tag}] {what}: a warm advance downloads {g.downloads / n} "
          f"times ({g.flag_reads / n} flag reads), {g.download_bytes / n} "
          f"bytes; uploads {g.uploads / n} times, {g.upload_bytes / n} "
          f"bytes (the dispatch arguments); {smi()}")


def analysis_phase(tag, fleet, params, leaf):
    """Phase 25: the analysis plane (`repro_torch.analysis`) on the card
    (see the module docstring). Returns the launch counts of its
    main-path runs (the `analysis` path) and the kernels' largest
    deviations from their plain versions on the inputs captured from
    the audit, the pool, the server and the explorer."""
    import json as _json
    import shutil

    import numpy as np
    import torch

    from repro_torch.analysis import audit, explore, sanitize
    from repro_torch.api import SessionPool
    from repro_torch.fabric import engine as eng
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import CoflowServer
    from repro_torch.traces.batch import pack, to_device
    from repro_torch.traces.synth import fb_like_trace

    dev = torch.device("cuda")
    err = {n: 0.0 for n in ("contention", "tick_walk", "maxmin_rates",
                            "prefix_sum")}
    tally = dict.fromkeys(ops.launch_counts(), 0)

    def absorb():
        """Add the launches since the last reset to the path's counts."""
        torch.cuda.synchronize()
        for k, v in ops.launch_counts().items():
            tally[k] += v
        ops.reset_launches()

    def hold(what, captured, caught):
        """The kernels against their plain versions on one run's
        captures; these launches are not the path's."""
        e = hold_kernels(tag, what, captured, caught)
        for k in err:
            err[k] = max(err[k], e[k])
        torch.cuda.synchronize()
        ops.reset_launches()

    torch.cuda.synchronize()
    ops.reset_launches()
    # 1. the hard invariants at the fleet's shape, one tick and one
    # session step a fabric, and a session advance's flag reads
    for topo, name in ((None, "big switch"), (leaf, "leaf-spine")):
        tb = to_device(pack(fleet, port_bw=params.port_bw, topology=topo),
                       dev)
        feats = eng.features_for(params, topology=topo)
        ep = eng.EngineParams.from_scheduler(params, device=dev).lanes(
            len(fleet))
        state = eng._init_state(tb)
        shape = tuple(tb.lo_src.shape)
        tick = step_scan(tag, f"one tick {name} {shape}", eng._run_chunk,
                         state, tb, ep, chunk=1, features=feats)
        absorb()
        z = torch.zeros_like(state.sent)
        zb = torch.zeros_like(state.t0)
        sstate = state._replace(rate=z, pend_sent=z.clone(), pend_tick=zb,
                                pend_next=zb.clone())
        n_end = torch.full((len(fleet),), 64.0, device=dev)
        step = step_scan(tag, f"one session step {name}", eng._session_chunk,
                         sstate, tb, ep, n_end, 1, features=feats)
        absorb()
        adv = step_scan(tag, f"session_advance {name}", eng.session_advance,
                        sstate, tb, ep, n_end=np.full(len(fleet), 64.0,
                                                      np.float32),
                        chunk=4, features=feats)
        absorb()
        reads = adv.result[2]
        if adv.crossings.get(audit.FLAG, 0) != reads:
            fail(f"[{tag}] session_advance {name}: {adv.crossings} for "
                 f"{reads} flag reads")
        n_ops = sum(v for k, v in tick.ops.items()
                    if not k.startswith("kernel:"))
        top = sorted(((v, k) for k, v in tick.ops.items()
                      if not k.startswith("kernel:")), reverse=True)[:8]
        print(f"[{tag}] card histogram, one tick {name} {shape}: {n_ops} "
              f"aten ops, kernels {tick.kernels}; top "
              + ", ".join(f"{k} x{v}" for v, k in top))
        print(f"[{tag}] one session step {name}: "
              f"{sum(v for k, v in step.ops.items() if 'kernel:' not in k)}"
              f" aten ops, kernels {step.kernels}; session_advance to 64 "
              f"ticks: {adv.result[1]} event steps, {reads} flag reads = "
              f"{adv.crossings.get(audit.FLAG, 0)} counted crossings; no "
              f"f64 site, no host sync in the step")
        del tb, state, sstate
    # the canonical slab's entry points on the card: hard invariants and
    # kernel calls against the CPU's manifest, every tick captured
    manifest = _json.loads(audit.default_manifest_path().read_text())
    with capture_ticks(1) as captured, capture_contention() as caught:
        for name, build in sorted(audit.ENTRYPOINTS.items()):
            s = build(device="cuda")
            torch.cuda.synchronize()
            check_scan(tag, f"audit {name}", s, ops.launch_counts())
            absorb()
            want = {k[len("kernel:"):]: v for k, v in
                    manifest["entrypoints"][name]["ops"].items()
                    if k.startswith("kernel:")}
            if s.kernels != want:
                fail(f"[{tag}] audit {name}: kernel calls {s.kernels} on "
                     f"the card, {want} on the CPU")
    hold("audit (canonical slab)", captured, caught)
    del captured, caught
    problems = audit.check_manifest(manifest, device="cuda")
    absorb()
    if problems:
        fail(f"[{tag}] audit on the card: " + "; ".join(problems))
    print(f"[{tag}] audit: {len(audit.ENTRYPOINTS)} entry points on the "
          f"canonical slab: hard invariants hold, signatures and kernel "
          f"calls equal the CPU manifest's (torch "
          f"{manifest['torch_version']})")

    # 2. a warm pool and a warm server under both guards
    pool = SessionPool(params, num_ports=PORTS, max_sessions=len(fleet))
    for tr in fleet:
        pool.session().submit(sorted(tr.coflows, key=lambda c: (
            c.arrival, c.cid))[:ANALYSIS_COFLOWS])

    def pool_advance():
        pool.advance(16 * params.delta)
        pool.poll()

    what = f"SessionPool ({len(fleet)} tenants x {ANALYSIS_COFLOWS} coflows)"
    with capture_ticks(FIGURE_CAPTURE_EVERY) as captured, \
            capture_contention() as caught:
        for _ in range(ANALYSIS_WARM):
            pool_advance()
    absorb()
    hold(f"{what}, {ANALYSIS_WARM} warm advances", captured, caught)
    del captured, caught
    guarded(tag, what, pool_advance, pool.io, ANALYSIS_GUARDED)
    absorb()
    del pool
    srv = CoflowServer(params, num_ports=PORTS, max_tenants=SERVER_ROWS,
                       features=(True, True, False, False, True))
    for i in range(SERVER_ROWS):
        srv.register(f"t{i}", mechanisms={"clairvoyant": False}
                     if i % 2 else None)
        tr = fb_like_trace(SERVER_COFLOWS, PORTS, seed=100 + i)
        srv.submit(f"t{i}", sorted(tr.coflows, key=lambda c: (
            c.arrival, c.cid))[:ANALYSIS_COFLOWS // 2])

    def srv_advance():
        srv.advance(16 * params.delta)
        for i in range(SERVER_ROWS):
            srv.poll(f"t{i}")

    what = f"CoflowServer ({SERVER_ROWS} tenants, known and learned)"
    with capture_ticks(FIGURE_CAPTURE_EVERY) as captured, \
            capture_contention() as caught:
        for _ in range(ANALYSIS_WARM):
            srv_advance()
    absorb()
    hold(f"{what}, {ANALYSIS_WARM} warm advances", captured, caught)
    del captured, caught
    guarded(tag, what, srv_advance, srv.pool.io, ANALYSIS_GUARDED)
    absorb()
    del srv

    # 3. negative controls: each must raise inside its guard
    must_raise(tag, "unaccounted host_to_device", sanitize.TransferError,
               lambda: _guard(lambda: eng.host_to_device(
                   np.ones(4, np.float32), dev)))
    must_raise(tag, "bare .to('cuda')", sanitize.TransferError,
               lambda: _guard(lambda: torch.ones(4).to("cuda")))
    must_raise(tag, "unaccounted .cpu()", sanitize.TransferError,
               lambda: _guard(lambda: torch.ones(4, device=dev).cpu()))
    fresh = ROOT / "build" / f"fresh_{os.getpid()}"
    child = subprocess.run(
        [sys.executable, "-c", FRESH_CHILD, str(ROOT / "src"), str(fresh)],
        capture_output=True, text=True, timeout=300)
    shutil.rmtree(fresh, ignore_errors=True)
    if child.returncode != 0 or "nvcc contention" not in child.stdout:
        fail(f"[{tag}] control: a first kernel call in a fresh process did "
             f"not raise RecompileError with its build: rc "
             f"{child.returncode}, {child.stdout[-400:]} "
             f"{child.stderr[-400:]}")
    print(f"[{tag}] control first K1 call in a fresh process: "
          f"{child.stdout.strip()[:300]}")
    t = torch.arange(4, dtype=torch.float32, device=dev)
    probes = {
        "pinned non-blocking download": lambda: torch.empty(
            4, pin_memory=True).copy_(t, non_blocking=True),
        ".cpu()": lambda: t.cpu(), ".item()": lambda: t[0].item(),
        "float(t)": lambda: float(t[0]), "bool(t)": lambda: bool(t[0]),
        ".tolist()": lambda: t.tolist(),
        "pinned non-blocking upload": lambda: torch.ones(4).pin_memory().to(
            dev, non_blocking=True),
        "torch.tensor(..., device)": lambda: torch.tensor([1.0], device=dev),
    }
    seen = {}
    for what, probe in probes.items():
        try:
            _guard(probe)
            seen[what] = False
        except sanitize.TransferError:
            seen[what] = True
    print(f"[{tag}] the dispatch mode sees: "
          f"{[w for w, v in seen.items() if v]}; does not see: "
          f"{[w for w, v in seen.items() if not v]} (the lint rule "
          f"host-sync-in-step covers those)")

    # 4. the explorer on the card
    buf = io.StringIO()
    with capture_ticks(1) as captured, capture_contention() as caught:
        rc = explore.explore(schedules=ANALYSIS_SCHEDULES, n_ops=16, seed=0,
                             out=buf, device="cuda")
    absorb()
    print("\n".join(f"[{tag}] {line}" for line in
                    buf.getvalue().splitlines()))
    if rc:
        fail(f"[{tag}] the explorer found a divergence on the card")
    hold("the explorer's pools", captured, caught)
    del captured, caught
    for k in STEP_KERNELS:
        if not tally[k]:
            fail(f"[{tag}] {k} was not launched by the analysis path")
    print(f"[{tag}] the analysis path launched K1 {tally['contention']}, K2 "
          f"{tally['tick_walk']}, K3 {tally['maxmin']}, K6 "
          f"{tally['prefix_sum']} ({tally['prefix_sum_rows']} rows) times")
    if tally["ssd_scan"] or tally["flash_attention"]:
        fail(f"[{tag}] K4 or K5 ran on the analysis path")
    return tally, err


def k7_design_macs(D, Dv):
    """Multiply-adds a pair that K7's three launches do (on `wgmma` in
    bf16, on the CUDA cores in f32): the scores q . k in each of the
    three (3 D: the stats launch keeps its own), do . v in the dk/dv and
    dq launches (2 Dv), p do (Dv), ds q and ds k (2 D)."""
    return 5 * D + 3 * Dv


def k7_bound_ms(shape, elt):
    """Of K7 at `shape` (`attention_widths`, causal). Bytes: q, o and do
    once (B H S (D + 2 Dv)), k and v once (B Hkv T (D + Dv)), and the
    gradients written once (as many again as q, k and v), elt bytes an
    element. Operations: the products the function needs, 3 D + 2 Dv
    multiply-adds a pair (the scores q . k, do . v, p do, ds k and ds q
    once each; K7's three launches do 5 D + 3 Dv, `k7_design_macs`), for
    each unmasked pair (`attention_bound_ms`'s count), plus delta's Dv a
    query row; at the bf16 tensor-core rate for bf16 inputs, the f32
    rate for f32. Returns (ms, what bounds it, pairs)."""
    B, H, Hkv, S, T, D, Dv, q_offset = attention_widths(shape)
    _, _, pairs = attention_bound_ms(shape, elt)
    nbytes = elt * (B * H * S * (2 * D + 2 * Dv)
                    + 2 * B * Hkv * T * (D + Dv))
    ops_ = 2 * ((3 * D + 2 * Dv) * pairs + B * H * S * Dv)
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = ops_ / (BF16_OPS_PER_S if elt == 2 else F32_OPS_PER_S)
    return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations",
            pairs)


def k7_inputs(shape, dtype, seed, dev):
    """Seeded q, k, v and do of `shape`, laid out as the train path lays
    them (transposed (B, S, H, D) tensors), and the forward's o."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops

    B, H, Hkv, S, T, D, Dv, q_offset = attention_widths(shape)
    rng = np.random.default_rng(seed)

    def t(*s):
        x = torch.as_tensor(rng.normal(size=s).astype(np.float32),
                            device=dev).to(dtype)
        return x.transpose(1, 2)

    q, k, v, do = t(B, S, H, D), t(B, T, Hkv, D), t(B, T, Hkv, Dv), \
        t(B, S, H, Dv)
    o = ops.flash_attention(q, k, v, q_offset=q_offset, force="ref")
    return q, k, v, o, do


def k7_check(tag, shape, dtype, dev, causal=True):
    """K7 at `shape` against its plain version: fails past `K7_BAR` of
    each gradient's largest magnitude, or unless a second call gives the
    same bits. Returns (inputs, max abs error, max relative error, {name:
    (max |difference|, max |plain gradient|)})."""
    import torch

    from repro_torch.kernels import ops

    q, k, v, o, do = k7_inputs(shape, dtype, shape[3] + shape[5], dev)
    qo = shape[-1]
    got = ops.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                  q_offset=qo)
    again = ops.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                    q_offset=qo)
    want = ops.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                   q_offset=qo, force="ref")
    torch.cuda.synchronize()
    err = rel = 0.0
    per = {}
    for name, g, g2, w in zip(("dq", "dk", "dv"), got, again, want):
        e = float((g.float() - w.float()).abs().max())
        m = float(w.float().abs().max())
        per[name] = (e, m)
        err, rel = max(err, e), max(rel, e / max(m, 1e-30))
        bar = K7_BAR[str(dtype)[6:]] * m
        if e > bar or g.dtype != dtype or g.shape != w.shape or not bool(
                torch.isfinite(g).all()):
            fail(f"[{tag}] K7 disagrees with flash_attention_bwd_ref at "
                 f"{shape} {dtype} causal={causal}: {name} max abs error "
                 f"{e:.3e} (bar {bar:.3e})")
        if not torch.equal(g, g2):
            fail(f"[{tag}] two K7 calls at {shape} {dtype} causal={causal} "
                 f"gave different {name}")
    return (q, k, v, o, do), err, rel, per


def k7_resources(D, Dv, dtype):
    """K7's instance at (D, Dv) and `dtype` in words: each launch's
    registers a thread, shared memory and blocks an SM
    (`flash_attention_bwd.resources`)."""
    from repro_torch.kernels.flash_attention_bwd import resources

    return "; ".join(f"{k} {r} registers, {b / 1024:.1f} KB, {n} an SM"
                     for k, (r, b, n) in resources(D, Dv, dtype).items())


def sdpa_bwd_any(q, k, v, do):
    """The backward of `sdpa` through `torch.autograd.grad` (the forward
    once, outside the timing): (its device ms over 3 calls, None), or
    (None, the error) where no backend of this install takes the shape
    (a yardstick only; the port never calls it)."""
    import torch

    try:
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        o = sdpa(qs, ks, vs)
        torch.autograd.grad(o, (qs, ks, vs), do, retain_graph=True)
        torch.cuda.synchronize()
    except RuntimeError as e:
        return None, str(e).splitlines()[0]
    return cuda_ms(lambda: torch.autograd.grad(o, (qs, ks, vs), do,
                                               retain_graph=True), 3), None


def k7_shape_record(tag, shape, dtype, dev, what):
    """K7 at `shape` within its bar, then its time beside the plain
    version's, SDPA's backward (`sdpa_bwd_any`) and the bound. Returns
    the record for the kernels line's `shapes`."""
    import torch

    from repro_torch.kernels import ops

    (q, k, v, o, do), err, rel, per = k7_check(tag, shape, dtype, dev)
    bnd, by, pairs = k7_bound_ms(shape, q.element_size())
    ms = cuda_ms(lambda: ops.flash_attention_bwd(q, k, v, o, do), 3)
    plain = cuda_ms(lambda: ops.flash_attention_bwd(q, k, v, o, do,
                                                    force="ref"), 2)
    lib, lib_err = sdpa_bwd_any(q, k, v, do)
    _, _, _, _, _, D, Dv, _ = attention_widths(shape)
    flop = 2 * (3 * D + 2 * Dv) * pairs
    done = 2 * k7_design_macs(D, Dv) * pairs
    print(f"[{tag}] K7 at {what} {shape} {str(dtype)[6:]}: max abs error "
          f"{err:.3e} ({rel:.2e} of the largest gradient); kernel {ms:.4f} "
          f"ms, plain {plain:.4f} ms, SDPA backward "
          + (f"{lib:.4f} ms" if lib is not None else f"null ({lib_err})")
          + f", bound {bnd:.4f} ms ({by}; {pairs} unmasked pairs); "
          f"{flop / ms / 1e9:.1f} TFLOP/s of the function's products "
          f"({done / ms / 1e9:.1f} of the {done / flop:.2f}x its three "
          f"launches do), {bnd / ms:.2%} of the bound; two calls bitwise "
          f"equal; max |difference| / max |gradient| "
          + ", ".join(f"{n} {e:.4e} / {m:.4e}" for n, (e, m) in per.items())
          + f"; {k7_resources(D, Dv, dtype)}; {smi()}", flush=True)
    del q, k, v, o, do
    torch.cuda.empty_cache()
    return {"shape": list(shape), "dtype": str(dtype)[6:], "ms": ms,
            "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib, "library_error": lib_err,
            "max_abs_err": err,
            "max_abs": {n: list(em) for n, em in per.items()}}


def train_golden(tag, force):
    """Phase 29's golden run: StarCoder2-3B at its published width, 2
    layers, f32, `numpy_params(seed=0)`, 3 AdamW steps of batch 2 x 128
    through `make_train_step` on the card (`force` "ref" pins the plain
    attention), held to `TRAIN_GOLDEN` (the JAX package on the CPU):
    loss rtol 1e-5, grad_norm rtol 1e-4, the f64 norm of every master
    leaf after step 3 rtol 1e-5. Returns the launch counts of the run."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST
    from repro_torch.models import lm
    from repro_torch.optim import make_optimizer

    gold = json.loads(TRAIN_GOLDEN.read_text())
    cfg = dataclasses.replace(get_config(ATTN_ARCH), **gold["config_cuts"])
    params, _ = lm.numpy_params(cfg, seed=gold["seed"])
    masters = lm.masters_from_reference(params, cfg, device="cuda")
    del params
    opt = make_optimizer(cfg, total_steps=gold["steps"],
                         groups=lm.reference_groups(cfg))
    state = opt.init(masters)
    step_fn = ST.make_train_step(cfg, opt, force=force)
    data = SyntheticLMData(cfg.vocab_size, gold["seq"], gold["batch"],
                           seed=gold["seed"], device="cuda")
    worst = {"loss": 0.0, "grad_norm": 0.0, "leaf": 0.0}

    def within(what, got, want, rtol, key):
        rel = abs(got - want) / abs(want)
        worst[key] = max(worst[key], rel)
        if rel > rtol:
            fail(f"[{tag}] the train golden ({force or 'kernels'}): {what} "
                 f"{got!r} against {want!r} (rtol {rtol})")

    ops.reset_launches()
    for step in range(gold["steps"]):
        t = data.batch(step)["tokens"]
        masters, state, m = step_fn(masters, state, step,
                                    {"tokens": t[:, :-1],
                                     "labels": t[:, 1:]})
        within(f"loss at step {step}", float(m["loss"]),
               gold["losses"][step], 1e-5, "loss")
        within(f"grad_norm at step {step}", float(m["grad_norm"]),
               gold["grad_norms"][step], 1e-4, "grad_norm")
    counts = ops.launch_counts()
    if sorted(gold["leaf_norms"]) != sorted(masters):
        fail(f"[{tag}] the golden's leaves are not the masters'")
    for n, t in masters.items():
        within(f"the norm of {n}",
               float(torch.linalg.vector_norm(t.detach().double())),
               gold["leaf_norms"][n], 1e-5, "leaf")
    L, steps = cfg.num_layers, gold["steps"]
    want = {n: 0 for n in counts}
    if force is None:
        want["flash_attention"], want["flash_attention_bwd"] = \
            2 * L * steps, L * steps
    if counts != want:
        fail(f"[{tag}] the golden run ({force or 'kernels'}) launched "
             f"{counts}; expected {want}")
    print(f"[{tag}] train golden ({force or 'K5 + K7'}): {steps} AdamW "
          f"steps at full width, {L} layers, f32: losses "
          f"{[round(x, 6) for x in gold['losses']]} held; largest relative "
          f"gaps: loss {worst['loss']:.2e} (bar 1e-5), grad_norm "
          f"{worst['grad_norm']:.2e} (bar 1e-4), leaf norms "
          f"{worst['leaf']:.2e} (bar 1e-5); launches {counts}", flush=True)
    del masters, state
    return counts


def train_bf16_pair(tag):
    """Phase 29's bf16 pair: StarCoder2-3B at its published width, 2
    layers, bf16 on f32 masters from `numpy_params(seed=0)`, one batch
    of the main path's shape: the loss and every gradient leaf's norm
    with K5 + K7 against the plain attention (loss within 2e-2, norms
    rtol 2e-2)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_config(ATTN_ARCH), num_layers=2)
    params, _ = lm.numpy_params(cfg, seed=0)
    masters = lm.masters_from_reference(params, cfg, device="cuda")
    del params
    t = SyntheticLMData(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                        device="cuda").batch(0)["tokens"]
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    model = lm.skeleton(cfg)
    out = {}
    for force in (None, "ref"):
        loss = lm.forward_train_loss(model, masters, batch, force=force)
        grads = torch.autograd.grad(loss, list(masters.values()))
        out[force] = (float(loss.detach()), [float(
            torch.linalg.vector_norm(g.double())) for g in grads])
        del grads
    (lk, nk), (lr_, nr) = out[None], out["ref"]
    gap = max(abs(a - b) / b for a, b in zip(nk, nr))
    print(f"[{tag}] bf16 pair at full width, 2 layers, {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens: loss {lk:.6f} with K5 + K7, {lr_:.6f} plain "
          f"(gap {abs(lk - lr_):.2e}, bar 2e-2); gradient leaf norms within "
          f"{gap:.2e} relative (bar 2e-2)", flush=True)
    if abs(lk - lr_) > 2e-2 or gap > 2e-2:
        fail(f"[{tag}] the bf16 pair differs past its bar")
    del masters


def train_restart(tag):
    """Phase 29's restart check, `test_checkpoint_restart_bitwise` on the
    card at the smoke config: 20 steps with a checkpoint every 6, the
    one at 18 deleted, resume from 12; the losses after the resume equal
    the uninterrupted run's at rtol 1e-6."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.checkpoint import latest_step
    from repro_torch.launch.train import train

    d = tempfile.mkdtemp(prefix="saath_train_ckpt_")
    try:
        kw = dict(steps=20, smoke=True, batch=4, seq=64, ckpt_dir=d,
                  ckpt_every=6, log_every=1000, coflow_plan=False,
                  device="cuda")
        full = train(ATTN_ARCH, **kw)
        if latest_step(d) != 18:
            fail(f"[{tag}] the restart run's latest step is "
                 f"{latest_step(d)}, not 18")
        shutil.rmtree(f"{d}/step_{18:08d}")   # the crash
        resumed = train(ATTN_ARCH, **kw)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    a, b = np.asarray(resumed["losses"]), np.asarray(full["losses"][12:])
    gap = float(np.max(np.abs(a - b) / np.abs(b))) if a.shape == b.shape \
        else float("inf")
    print(f"[{tag}] restart at the smoke config: resumed at step 12, "
          f"final step {resumed['final_step']}, losses within {gap:.2e} "
          f"relative of the uninterrupted run's (bar 1e-6)", flush=True)
    if resumed["final_step"] != 20 or gap > 1e-6:
        fail(f"[{tag}] the resumed losses {a.tolist()} are not the "
             f"uninterrupted run's {b.tolist()}")


def train_phase(tag):
    """Phase 29: K7 against its plain version at every width pair and
    at the train shapes; the train golden with the kernels and with the
    plain attention; the main train path (StarCoder2-3B at its published
    width, bf16 on f32 masters, AdamW, `TRAIN_STEPS` steps of
    `TRAIN_BATCH` x `TRAIN_SEQ` tokens with the coflow plan), counters
    set to 0 just before and read just after; the bf16 pair; the restart.
    Returns (K7's record for the kernels line, the main path's launch
    counts)."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention_bwd import WIDTHS
    from repro_torch.launch.train import train

    layers = get_config(ATTN_ARCH).num_layers
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    worst = {}
    for D, Dv in WIDTHS:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                for B, H, Hkv, S, T, qo in K7_CASES:
                    shape = (B, H, Hkv, S, T, D, Dv, qo)
                    _, err, rel, _ = k7_check(tag, shape, dtype, dev,
                                              causal)
                    key = f"({D}, {Dv}) {str(dtype)[6:]}"
                    worst[key] = max(worst.get(key, 0.0), rel)
    print(f"[{tag}] K7 within its bars at every width pair, causal and "
          f"not, q_offset 0 and a chunk against T > S, two calls bitwise "
          f"equal; largest error of the largest gradient: "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()), flush=True)
    for D, Dv in WIDTHS:
        for dtype in (torch.float32, torch.bfloat16):
            print(f"[{tag}] K7 ({D}, {Dv}) {str(dtype)[6:]}: "
                  f"{k7_resources(D, Dv, dtype)}", flush=True)
    shapes = [k7_shape_record(tag, shape, dtype, dev, what)
              for shape, what in ((K7_TRAIN, "StarCoder2-3B's train shape"),
                                  (K7_MLA, "DeepSeek-V2's MLA shape"))
              for dtype in (torch.float32, torch.bfloat16)]

    for force in (None, "ref"):
        train_golden(tag, force)
    gc.collect()
    torch.cuda.empty_cache()

    # the main train path
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = train(ATTN_ARCH, smoke=False, device="cuda", batch=TRAIN_BATCH,
                seq=TRAIN_SEQ, steps=TRAIN_STEPS, coflow_plan=True,
                log_every=5)
    counts = ops.launch_counts()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        fail(f"[{tag}] the train path's losses {losses}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if not last < first - 0.05:
        fail(f"[{tag}] the loss did not fall by the reference's bar: mean "
             f"of the first 5 {first:.4f}, of the last 5 {last:.4f}")
    plan = out["plan_launches"]
    per_step = {n: (counts[n] - plan[n]) / TRAIN_STEPS for n in counts}
    want = {n: 0 for n in counts}
    want["flash_attention"] = 2 * layers
    want["flash_attention_bwd"] = layers
    if per_step != want or plan["flash_attention"] or \
            plan["flash_attention_bwd"] or not plan["contention"]:
        fail(f"[{tag}] the train path launched {counts} (the plan "
             f"{plan}); expected a step to launch {want}")
    ms = 1e3 * float(np.median(out["step_seconds"][1:]))
    ms0 = 1e3 * out["step_seconds"][0]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"[{tag}] train main path: StarCoder2-3B at its published width, "
          f"{layers} layers, bf16 on f32 masters, AdamW, "
          f"{TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens: "
          f"losses {losses[0]:.4f} -> {losses[-1]:.4f} (mean of the first "
          f"5 {first:.4f}, of the last 5 {last:.4f}); {ms:.1f} ms a step "
          f"(median after the first; the first {ms0:.1f} ms), "
          f"{tokens / ms * 1e3:.1f} tokens/s; peak "
          f"{peak / 2**30:.2f} GiB ({held / 2**30:.2f} GiB of it held by "
          f"earlier phases); wall {wall:.1f} s; launches a step "
          f"{ {n: v for n, v in per_step.items() if v} }, the plan's "
          f"{ {n: v for n, v in plan.items() if v} }; "
          f"{len(out['plan'])} waves, the first {out['plan'][:2]}; "
          f"stragglers {len(out['straggler_events'])}; {smi()}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    if "--profile" in sys.argv[1:]:
        profile_train()
        gc.collect()

    train_bf16_pair(tag)
    train_restart(tag)

    main = next(r for r in shapes if r["dtype"] == "bfloat16")
    rec = {"name": "flash_attention_bwd", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
           "replaces": "src/repro/models/attention.py:28",
           "max_abs_err": main["max_abs_err"], "ms": main["ms"],
           "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
           "bound_by": main["bound_by"], "library_ms": main["library_ms"],
           "shapes": shapes,
           "train": {"ms_per_step": ms, "tokens_per_s": tokens / ms * 1e3,
                     "peak_bytes": peak, "layers": layers,
                     "losses": losses}}
    return rec, counts


def dense_phase(tag):
    """Phase 30: K5 at the new models' shapes (`DENSE_K5`: Gemma's (256,
    256), SeamlessM4T's non-causal encoder and cross attention, S != T,
    DeepSeek-Coder's G = 7), f32 and bf16, against its plain version
    with its time beside the plain version's, SDPA's and the bound
    (`attention_shape_record`); the five goldens (`golden_parity`:
    published widths, 2 layers, f32, SeamlessM4T with the golden's
    frames); each model through `ServeSession(arch, smoke=False)` at its
    published width and depth in bf16, one after another, each freed
    before the next (`serve_main_path`, no f32 re-run: the 33 B models do
    not fit the card in f32), K5 launches a prefill equal to
    `DENSE_K5_LAUNCHES`; and each at `DENSE_PAIR_LAYERS` layers in bf16,
    the plain attention against K5 (`bf16_pair`: C5's 0.1, and for a
    tied embedding the relative term of BF16_STEPS_RTOL).
    Returns (K5's shape records, {arch: the main-path run's launch
    counts})."""
    import gc

    import torch

    from repro_torch.configs import get_config

    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    for arch in DENSE_ARCHS:
        want = expected_launches(get_config(arch))["flash_attention"]
        if want != DENSE_K5_LAUNCHES[arch]:
            fail(f"[{tag}] {arch}'s plan gives {want} K5 launches a "
                 f"prefill, not {DENSE_K5_LAUNCHES[arch]}")
    shapes = [attention_shape_record(tag, shape, dtype, dev, what, causal)
              for what, (shape, causal) in DENSE_K5.items()
              for dtype in (torch.float32, torch.bfloat16)]
    for arch in DENSE_ARCHS:
        norms = {"k_cache_norm": "k", "v_cache_norm": "v"}
        if get_config(arch).enc_dec:
            norms.update(cross_k_cache_norm="cross_k",
                         cross_v_cache_norm="cross_v")
        golden_parity(tag, arch, ROOT / "tests" / "data" /
                      DENSE_GOLDENS[arch], norms)
        gc.collect()
        torch.cuda.empty_cache()
    counts = {}
    for arch in DENSE_ARCHS:
        enc = get_config(arch).enc_dec
        counts[arch] = serve_main_path(
            tag, arch, DENSE_BATCH, SEAMLESS_PROMPT if enc else DENSE_PROMPT,
            DENSE_TOKENS, frames=SEAMLESS_FRAMES if enc else 0, f32=False)
        gc.collect()
        torch.cuda.empty_cache()
    for arch in DENSE_ARCHS:
        enc = get_config(arch).enc_dec
        bf16_pair(tag, arch, DENSE_BATCH,
                  SEAMLESS_PROMPT if enc else DENSE_PROMPT,
                  "flash_attention", numpy_weights=False,
                  layers=DENSE_PAIR_LAYERS,
                  frames=SEAMLESS_FRAMES if enc else 0,
                  rtol=BF16_STEPS_RTOL if get_config(arch).tie_embeddings
                  else 0.0)
    return shapes, counts


K8_GRADS = ("dx", "ddt", "da", "db", "dc")
# K5 and K7 at SeamlessM4T's cross attention in training (a microbatch
# of one row: 2048 decoder rows against 32 frames, under one key tile)
SEAMLESS_TRAIN_CROSS = (1, 16, 16, 2048, 32, 64, 64, 0)


def ssd_bwd_bound_ms(shape, elt):
    """Of K8 at `shape` (B, L, H, G, Dh, N, lc). Bytes: x, dt, b, c and dy
    read once, dx, ddt, db and dc written once (elt bytes an element),
    a read and da written once (f32). Operations (multiply-adds) for
    these chunk lengths (the ragged last one unpadded; tri = the causal
    pairs u <= t of every chunk): per (batch, group) G = c b^T (tri x
    N), per (batch, head) dM = dY X^T (tri x Dh), both of the inputs
    alone, at the bf16 tensor-core rate for bf16 inputs; then at the f32
    rate (M, dG, S and dS are f32) per (batch, head) M^T dY (tri x Dh)
    and the five L x Dh x N products of `ref.ssd_chunked_bwd_ref` (the
    chunk states (x w)^T b, the state gradients' updates (e dY)^T C, B
    dS^T, dY S and X dS), and per (batch, group) dG B and dG^T C (tri x
    N each): B and C belong to the group, so dc's and db's dG terms are
    products of the group's heads' dG sum. Returns (ms, what bounds it,
    multiply-adds)."""
    B, L, H, G, Dh, N, lc = shape
    nbytes = 2 * elt * (2 * B * L * H * Dh + B * L * H + 2 * B * L * G * N) \
        + 8 * H
    lens = [min(lc, L - j) for j in range(0, L, lc)]
    tri = sum(n * (n + 1) // 2 for n in lens)
    of_inputs = B * G * tri * N + B * H * tri * Dh
    of_f32 = B * H * (tri * Dh + 5 * L * Dh * N) + B * G * tri * 2 * N
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = 2 * of_inputs / (BF16_OPS_PER_S if elt == 2 else F32_OPS_PER_S) \
        + 2 * of_f32 / F32_OPS_PER_S
    return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations",
            of_inputs + of_f32)


def k8_check(tag, shape, dtype, dev):
    """K8 at `shape` against `ssd_chunked_bwd_ref`: fails past K4's bar
    (`ssd_err`, atol `SSD_BWD_ATOL` of each gradient's largest magnitude,
    da included), or unless a second call gives the same bits. Returns
    (inputs, dy, {gradient: (max |difference|, max |plain gradient|)})."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops

    B, L, H, G, Dh, N, lc = shape
    args = ssd_inputs(shape, dtype, L + H, dev)
    dy = torch.as_tensor(np.random.default_rng(L + H + 1).normal(
        size=(B, L, H, Dh)), dtype=dtype, device=dev)
    got = ops.ssd_scan_bwd(*args, dy, lc=lc)
    again = ops.ssd_scan_bwd(*args, dy, lc=lc)
    want = ops.ssd_scan_bwd(*args, dy, lc=lc, force="ref")
    torch.cuda.synchronize()
    per = {}
    for name, g, g2, w, x in zip(K8_GRADS, got, again, want, args):
        m = float(w.float().abs().max())
        ok, e = ssd_err(g, w, SSD_BWD_ATOL * m)
        per[name] = (e, m)
        if not ok or g.dtype != x.dtype or g.shape != x.shape:
            fail(f"[{tag}] K8 disagrees with ssd_chunked_bwd_ref at {shape} "
                 f"{dtype}: {name} max abs error {e:.3e} (atol "
                 f"{SSD_BWD_ATOL * m:.3e})")
        if not torch.equal(g, g2):
            fail(f"[{tag}] two K8 calls at {shape} {dtype} gave different "
                 f"{name}")
    return args, dy, per


def k8_shape_record(tag, shape, dtype, dev, what):
    """K8 at `shape` within its bar, then its time beside the plain
    version's and the bound (no single PyTorch call computes this
    gradient: library null), with its workspaces' bytes. Returns the
    record for the kernels line's `shapes`."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan_bwd import workspace

    B, L, H, G, Dh, N, lc = shape
    args, dy, per = k8_check(tag, shape, dtype, dev)
    bnd, by, macs = ssd_bwd_bound_ms(shape, args[0].element_size())
    ms = cuda_ms(lambda: ops.ssd_scan_bwd(*args, dy, lc=lc), 5)
    plain = cuda_ms(lambda: ops.ssd_scan_bwd(*args, dy, lc=lc,
                                             force="ref"), 2)
    ws = workspace(B, L, H, Dh, G, N, lc)
    err = max(e for e, _ in per.values())
    print(f"[{tag}] K8 at {what} {shape} {str(dtype)[6:]}: kernel {ms:.4f} "
          f"ms, plain {plain:.4f} ms, library null (no single PyTorch call "
          f"computes the SSD scan's gradient), bound {bnd:.4f} ms ({by}; "
          f"{macs / 1e9:.2f} G multiply-adds), {bnd / ms:.2%} of the bound, "
          f"{2 * macs / ms / 1e9:.1f} TFLOP/s; two calls bitwise equal; max "
          f"|difference| / max |gradient| "
          + ", ".join(f"{n} {e:.4e} / {m:.4e}" for n, (e, m) in per.items())
          + "; workspaces " + ", ".join(f"{k} {v / 1e6:.1f} MB"
                                        for k, v in ws.items())
          + f"; {smi()}", flush=True)
    del args, dy
    torch.cuda.empty_cache()
    return {"shape": list(shape), "dtype": str(dtype)[6:], "ms": ms,
            "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": None, "max_abs_err": err,
            "max_abs": {n: list(em) for n, em in per.items()},
            "workspace_bytes": ws}


def train_launches(cfg):
    """{kernel: launches} of one train step of `cfg`: per microbatch, K4
    for each Mamba layer and K5 for each attention (decoder self, cross,
    encoder; `expected_launches`), twice under remat (the backward
    recomputes the forward), and K8 and K7 once each; every other kernel
    0."""
    want = expected_launches(cfg)
    k = max(cfg.train_microbatches, 1)
    fwd = 1 if cfg.remat == "none" else 2
    mixers = {"ssd_scan": "ssd_scan_bwd",
              "flash_attention": "flash_attention_bwd"}
    for f, b in mixers.items():
        want[b] = k * want[f]
        want[f] = fwd * k * want[f]
    return want


def ssm_batch(data, step):
    """Batch `step` of `data` as the train loop cuts it."""
    a = data.batch(step)
    b = {"tokens": a["tokens"][:, :-1], "labels": a["tokens"][:, 1:]}
    if "src_embeds" in a:
        b["src_embeds"] = a["src_embeds"]
    return b


def ssm_golden(tag, arch, params, gold, force):
    """Phase 31's golden run of `arch` (as `train_golden`): the golden's
    config cuts, the reference tree `params` (`numpy_params`), its steps
    of AdamW through `make_train_step` on the card (`force` "ref" pins
    the plain versions), losses rtol 1e-5, grad norms rtol 1e-4, every
    master leaf's f64 norm after the last step rtol 1e-5; the kernels
    launched `train_launches` a step (none with "ref")."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST
    from repro_torch.models import lm
    from repro_torch.optim import make_optimizer

    cfg = dataclasses.replace(get_config(arch), **gold["config_cuts"])
    masters = lm.masters_from_reference(params, cfg, device="cuda")
    opt = make_optimizer(cfg, total_steps=gold["steps"],
                         groups=lm.reference_groups(cfg))
    state = opt.init(masters)
    step_fn = ST.make_train_step(cfg, opt, force=force)
    data = SyntheticLMData(cfg.vocab_size, gold["seq"], gold["batch"],
                           seed=gold["seed"], src_len=gold["src_len"],
                           d_model=cfg.d_model, device="cuda")
    worst = {"loss": 0.0, "grad_norm": 0.0, "leaf": 0.0}

    def within(what, got, want, rtol, key):
        rel = abs(got - want) / abs(want)
        worst[key] = max(worst[key], rel)
        if rel > rtol:
            fail(f"[{tag}] {arch}'s train golden ({force or 'kernels'}): "
                 f"{what} {got!r} against {want!r} (rtol {rtol})")

    ops.reset_launches()
    for step in range(gold["steps"]):
        masters, state, m = step_fn(masters, state, step,
                                    ssm_batch(data, step))
        within(f"loss at step {step}", float(m["loss"]),
               gold["losses"][step], 1e-5, "loss")
        within(f"grad_norm at step {step}", float(m["grad_norm"]),
               gold["grad_norms"][step], 1e-4, "grad_norm")
    counts = ops.launch_counts()
    if sorted(gold["leaf_norms"]) != sorted(masters):
        fail(f"[{tag}] {arch}'s golden leaves are not the masters'")
    for n, t in masters.items():
        within(f"the norm of {n}",
               float(torch.linalg.vector_norm(t.detach().double())),
               gold["leaf_norms"][n], 1e-5, "leaf")
    want = {n: 0 for n in counts}
    if force is None:
        want = {n: v * gold["steps"] for n, v in train_launches(cfg).items()}
    if counts != want:
        fail(f"[{tag}] {arch}'s golden run ({force or 'kernels'}) launched "
             f"{counts}; expected {want}")
    print(f"[{tag}] {arch} train golden ({force or 'kernels'}): "
          f"{gold['steps']} AdamW steps at full width, "
          f"{gold['config_cuts']}, {gold['batch']} x {gold['seq']} tokens"
          + (f" against {gold['src_len']} frames" if gold["src_len"] else "")
          + f": losses {[round(x, 6) for x in gold['losses']]} held; "
          f"largest relative gaps: loss {worst['loss']:.2e} (bar 1e-5), "
          f"grad_norm {worst['grad_norm']:.2e} (bar 1e-4), leaf norms "
          f"{worst['leaf']:.2e} (bar 1e-5); launches "
          f"{ {n: v for n, v in counts.items() if v} }", flush=True)
    del masters, state


def ssm_main_path(tag, arch):
    """Phase 31's main train path of `arch`: `train(arch, smoke=False,
    device="cuda")` with `SSM_TRAIN`'s batch, length and config cuts,
    `SSM_TRAIN_STEPS` steps with the coflow plan, counters set to 0 just
    before and read just after: the loss falls by the reference's bar,
    each step launches `train_launches` and the plan K1, K2 and K6.
    Returns (the run's launch counts, its record)."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train

    batch, seq, cuts = SSM_TRAIN[arch]
    cfg = dataclasses.replace(get_config(arch), **cuts)
    want = train_launches(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = train(arch, smoke=False, device="cuda", batch=batch, seq=seq,
                steps=SSM_TRAIN_STEPS, coflow_plan=True, log_every=5,
                config_cuts=cuts or None)
    counts = ops.launch_counts()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    if len(losses) != SSM_TRAIN_STEPS or not np.isfinite(losses).all():
        fail(f"[{tag}] {arch}'s train path's losses {losses}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if not last < first - 0.05:
        fail(f"[{tag}] {arch}'s loss did not fall by the reference's bar: "
             f"mean of the first 5 {first:.4f}, of the last 5 {last:.4f}")
    plan = out["plan_launches"]
    per_step = {n: (counts[n] - plan[n]) / SSM_TRAIN_STEPS for n in counts}
    if per_step != want or any(plan[n] for n in want if want[n]) or \
            not plan["contention"]:
        fail(f"[{tag}] {arch}'s train path launched {counts} (the plan "
             f"{plan}); expected a step to launch {want}")
    ms = 1e3 * float(np.median(out["step_seconds"][1:]))
    ms0 = 1e3 * out["step_seconds"][0]
    tokens = batch * seq
    print(f"[{tag}] train main path: {arch} at its published width, "
          f"cuts {cuts or 'none'} ({cfg.num_layers} layers"
          + (f" + {cfg.enc_layers} encoder layers" if cfg.enc_dec else "")
          + f", {cfg.param_count() / 1e9:.2f} B parameters), bf16 on f32 "
          f"masters, {cfg.optimizer}, {cfg.train_microbatches} "
          f"microbatch(es), {SSM_TRAIN_STEPS} steps of {batch} x {seq} "
          f"tokens" + (" against 32 frames a row" if cfg.enc_dec else "")
          + f": losses {losses[0]:.4f} -> {losses[-1]:.4f} (mean of the "
          f"first 5 {first:.4f}, of the last 5 {last:.4f}); {ms:.1f} ms a "
          f"step (median after the first; the first {ms0:.1f} ms), "
          f"{tokens / ms * 1e3:.1f} tokens/s; peak {peak / 2**30:.2f} GiB "
          f"({held / 2**30:.2f} GiB of it held by earlier phases); wall "
          f"{wall:.1f} s; launches a step "
          f"{ {n: v for n, v in per_step.items() if v} }, the plan's "
          f"{ {n: v for n, v in plan.items() if v} }; {len(out['plan'])} "
          f"waves; stragglers {len(out['straggler_events'])}; {smi()}",
          flush=True)
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return counts, {"arch": arch, "config_cuts": cuts,
                    "layers": cfg.num_layers, "batch": batch, "seq": seq,
                    "ms_per_step": ms, "tokens_per_s": tokens / ms * 1e3,
                    "peak_bytes": peak, "losses": losses,
                    "reduced": ({"num_experts": [get_config(arch).num_experts,
                                                 cfg.num_experts],
                                 "num_layers": [get_config(arch).num_layers,
                                                cfg.num_layers]}
                                if cuts else {})}


def pair_grads(cfg, masters, b, force):
    """(loss, [the f64 norm of each master leaf's gradient]) of
    `forward_train_loss` on batch `b`."""
    import torch

    from repro_torch.models import lm

    loss = lm.forward_train_loss(lm.skeleton(cfg), masters, b, force=force)
    grads = torch.autograd.grad(loss, list(masters.values()))
    return float(loss.detach()), [float(torch.linalg.vector_norm(
        g.double())) for g in grads]


def layer_pairs(tag, cfg, masters, b):
    """Each layer of `cfg`'s stack fed the same input, the plain path's
    (its forward, layer by layer, under no_grad), and the same seeded
    output gradient: the norms of its input's and its masters' gradients
    with the kernels against the plain versions, rtol 2e-2 (the bf16
    pair's bar). Returns the largest relative gap and its leaf."""
    import numpy as np
    import torch

    from repro_torch.models import lm
    from repro_torch.models.common import compute_dtype

    dt = compute_dtype(cfg.dtype)
    model = lm.skeleton(cfg)
    S = b["tokens"].shape[1]
    pos = torch.arange(S, device="cuda")[None]
    with torch.no_grad():
        x = lm._scale_embed(cfg, masters["embed"].to(dt)[b["tokens"]])
    rng = np.random.default_rng(31)
    worst = (0.0, "")
    for l, layer in enumerate(model.layers):
        pre = f"layers.{l}."
        names = [n for n in masters if n.startswith(pre)]
        g = torch.as_tensor(rng.normal(size=tuple(x.shape)), dtype=dt,
                            device="cuda")
        norms = {}
        for force in (None, "ref"):
            xi = x.detach().requires_grad_(True)
            w = {n[len(pre):]: masters[n].to(dt) for n in names}
            out = lm._layer(layer, w, xi, pos, force)
            grads = torch.autograd.grad(out, [xi] + [masters[n]
                                                     for n in names], g)
            norms[force] = [float(torch.linalg.vector_norm(t.double()))
                            for t in grads]
            if force == "ref":
                x = out.detach()
        for n, a, r in zip(["input"] + names, norms[None], norms["ref"]):
            gap = abs(a - r) / r if r else 0.0
            if gap > worst[0]:
                worst = (gap, f"{pre}{n}" if n == "input" else n)
    if worst[0] > 2e-2:
        fail(f"[{tag}] {cfg.name}'s layer-by-layer bf16 pair: the gradient "
             f"norm of {worst[1]} differs by {worst[0]:.2e} relative (bar "
             f"2e-2)")
    return worst


def ssm_bf16_pair(tag, arch):
    """Phase 31's bf16 pair of `arch`: `SSM_PAIR_CUTS`' depth (Jamba: the
    main path's period and experts), bf16 on f32 masters from
    `lm.init_masters(seed=0)`, one microbatch of the main path's shape:
    the loss and every gradient leaf's norm with the kernels against the
    plain versions (loss within 2e-2, norms rtol 2e-2). Jamba's eight
    bf16 layers compound the rounding of either path past 2e-2 on a few
    small leaves (a Mamba layer's conv_w and conv_b) whichever kernel is
    swapped in, K5 and K7 alone included; so, as the repository's bf16
    serve test of Jamba does, its leaf norms are held layer by layer on
    the same input (`layer_pairs`), and the whole stack besides in f32
    (loss rtol 1e-5, every leaf's norm rtol 1e-4)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_config(arch), **SSM_PAIR_CUTS[arch])
    batch, seq, _ = SSM_TRAIN[arch]
    rows = batch // max(cfg.train_microbatches, 1)
    masters = lm.init_masters(cfg, seed=0, device="cuda")
    data = SyntheticLMData(cfg.vocab_size, seq, rows,
                           src_len=32 if cfg.enc_dec else 0,
                           d_model=cfg.d_model, device="cuda")
    b = ssm_batch(data, 0)
    (lk, nk), (lr_, nr) = (pair_grads(cfg, masters, b, f)
                           for f in (None, "ref"))
    gap = max(abs(a - r) / r for a, r in zip(nk, nr) if r)
    by_layer = arch == "jamba-v0.1-52b"
    what = (f"whole-stack gradient leaf norms within {gap:.2e} relative "
            f"(held layer by layer)" if by_layer else
            f"gradient leaf norms within {gap:.2e} relative (bar 2e-2)")
    if by_layer:
        lgap, leaf = layer_pairs(tag, cfg, masters, b)
        what += (f"; layer by layer on the same input: within {lgap:.2e} "
                 f"relative at {leaf} (bar 2e-2)")
    print(f"[{tag}] {arch} bf16 pair at full width, {SSM_PAIR_CUTS[arch]}, "
          f"{rows} x {seq} tokens: loss {lk:.6f} with the kernels, "
          f"{lr_:.6f} plain (gap {abs(lk - lr_):.2e}, bar 2e-2); {what}",
          flush=True)
    if abs(lk - lr_) > 2e-2 or (gap > 2e-2 and not by_layer):
        fail(f"[{tag}] {arch}'s bf16 pair differs past its bar")
    del masters
    if by_layer:
        f32 = dataclasses.replace(cfg, dtype="float32")
        masters = lm.init_masters(f32, seed=0, device="cuda")
        (lk, nk), (lr_, nr) = (pair_grads(f32, masters, b, f)
                               for f in (None, "ref"))
        gap = max(abs(a - r) / r for a, r in zip(nk, nr) if r)
        print(f"[{tag}] {arch} f32 pair, the same depth and batch: loss "
              f"{lk:.7f} with the kernels, {lr_:.7f} plain (relative gap "
              f"{abs(lk - lr_) / lr_:.2e}, bar 1e-5); gradient leaf norms "
              f"within {gap:.2e} relative (bar 1e-4)", flush=True)
        if abs(lk - lr_) > 1e-5 * lr_ or gap > 1e-4:
            fail(f"[{tag}] {arch}'s f32 pair differs past its bar")
        del masters


def train_ssm_phase(tag):
    """Phase 31: K8 against its plain version at `SSD_CASES` and at the
    train shapes (`SSD_BWD_TRAIN`, `SSD_BWD_JAMBA`), f32 and bf16, with its
    time beside the plain version's and the bound; K5 and K7 non-causal
    at SeamlessM4T's cross attention in training (S > T, T under one key
    tile); the train goldens of Mamba2-1.3B and SeamlessM4T-medium with
    the kernels and with the plain versions; the three main train paths
    (`SSM_TRAIN`), counters set to 0 just before and read just after;
    the bf16 pairs. Returns (K8's record for the kernels line, the main
    paths' launch counts summed, K5's shape records)."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    t0 = [time.perf_counter()]

    def part(what):
        now = time.perf_counter()
        print(f"[{tag}] {what}: {now - t0[0]:.1f} s", flush=True)
        t0[0] = now

    worst = {}
    for shape in SSD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            _, _, per = k8_check(tag, shape, dtype, dev)
            key = str(dtype)[6:]
            worst[key] = max([worst.get(key, 0.0)]
                             + [e / max(m, 1e-30) for e, m in per.values()])
    print(f"[{tag}] K8 within K4's bar at SSD_CASES {SSD_CASES}, two calls "
          f"bitwise equal; largest error of the largest gradient: "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()), flush=True)
    shapes = [k8_shape_record(tag, shape, dtype, dev, what)
              for shape, what in ((SSD_BWD_TRAIN, "Mamba2-1.3B's train shape"),
                                  (SSD_BWD_JAMBA, "Jamba's microbatch shape"))
              for dtype in (torch.float32, torch.bfloat16)]
    k5_shapes = []
    for dtype in (torch.float32, torch.bfloat16):
        k5_shapes.append(attention_shape_record(
            tag, SEAMLESS_TRAIN_CROSS, dtype, dev,
            "SeamlessM4T's cross attention in training", causal=False))
        _, err, rel, _ = k7_check(tag, SEAMLESS_TRAIN_CROSS, dtype, dev,
                                  causal=False)
        print(f"[{tag}] K7 at SeamlessM4T's cross attention in training "
              f"{SEAMLESS_TRAIN_CROSS} {str(dtype)[6:]} non-causal: max abs "
              f"error {err:.3e} ({rel:.2e} of the largest gradient, bar "
              f"{K7_BAR[str(dtype)[6:]]}); two calls bitwise equal",
              flush=True)
    part("K8, K5 and K7 records")

    for arch, name in SSM_GOLDENS.items():
        gold = json.loads((ROOT / "tests" / "data" / name).read_text())
        cfg = dataclasses.replace(get_config(arch), **gold["config_cuts"])
        params, _ = lm.numpy_params(cfg, seed=gold["seed"])
        for force in (None, "ref"):
            ssm_golden(tag, arch, params, gold, force)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    part("the train goldens")

    counts, train = {}, {}
    for arch in SSM_TRAIN:
        counts[arch], train[arch] = ssm_main_path(tag, arch)
    part("the main train paths")
    if "--profile" in sys.argv[1:]:
        profile_train(arch="mamba2-1.3b", batch=SSM_TRAIN["mamba2-1.3b"][0],
                      seq=SSM_TRAIN["mamba2-1.3b"][1],
                      split=("K8", K8_KERNELS))
        gc.collect()
    for arch in SSM_TRAIN:
        ssm_bf16_pair(tag, arch)
        gc.collect()
        torch.cuda.empty_cache()
    part("the pairs")

    main = next(r for r in shapes if r["dtype"] == "bfloat16")
    rec = {"name": "ssd_scan_bwd", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
           "replaces": "src/repro/models/mamba.py:18",
           "max_abs_err": main["max_abs_err"], "ms": main["ms"],
           "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
           "bound_by": main["bound_by"], "library_ms": None,
           "shapes": shapes, "train": train}
    total = {n: sum(c[n] for c in counts.values())
             for n in next(iter(counts.values()))}
    return rec, total, k5_shapes


def _guard(fn):
    """`fn()` inside `assert_no_transfers()`."""
    from repro_torch.analysis.sanitize import assert_no_transfers

    with assert_no_transfers():
        return fn()


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import Scenario, SessionPool, run
    from repro_torch.fabric import engine as eng
    from repro_torch.fabric.topology import LeafSpine
    from repro_torch.kernels import build, ops
    from repro_torch.traces.batch import pack, to_device
    from repro_torch.traces.synth import fb_like_trace

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_script = time.perf_counter()
    t_lap = [t_script]

    def lap(tag):
        now = time.perf_counter()
        print(f"[{tag}] phase seconds {now - t_lap[0]:.1f}", flush=True)
        t_lap[0] = now

    dev = torch.device("cuda")
    card = smi()
    print(f"card: {card} | {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    # ---- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build_all(ptxas_info=True)
    print(f"[1] built {sorted(logs)} in {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")

    lap("1")

    # ---- 2. K1 at Table 2's shapes -------------------------------------
    g = torch.Generator(device="cpu").manual_seed(0)
    for C in (2048, 4096):
        for dtype in (torch.float32, torch.bfloat16):
            a_s = (torch.rand(1, C, 512, generator=g) < 0.05).to(dtype).to(dev)
            a_r = (torch.rand(1, C, 512, generator=g) < 0.05).to(dtype).to(dev)
            act = (torch.rand(1, C, generator=g) < 0.7).to(dev)
            got = ops.contention(a_s, a_r, act)
            want = ops.contention(a_s, a_r, act, force="ref")
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"K1 disagrees with its plain version at (1, {C}, 512)"
                     f" {dtype}")
            ms = cuda_ms(lambda: ops.contention(a_s, a_r, act), 20)
            plain = cuda_ms(lambda: ops.contention(a_s, a_r, act,
                                                   force="ref"), 5)
            lib = cuda_ms(lambda: contention_library(
                a_s.bfloat16(), a_r.bfloat16(), act), 5)
            bnd, by = contention_bound_ms(a_s, a_r, act)
            print(f"[2] K1 (1, {C}, 512) {str(dtype)[6:]}: exact; kernel "
                  f"{ms:.4f} ms, plain {plain:.4f} ms, bf16 matmul "
                  f"{lib:.4f} ms, bound {bnd:.4f} ms ({by})")

    lap("2")

    # ---- 3. no host sync inside a chunk, on each path ------------------
    params = Scenario().params
    fleet = tuple(fb_like_trace(COFLOWS, PORTS, seed=s)
                  for s in range(FLEET))
    leaf = LeafSpine(hosts_per_leaf=4, oversub=4.0, wc_fill="maxmin")
    for topo in (None, leaf):
        tb = to_device(pack(fleet, port_bw=params.port_bw, topology=topo),
                       dev)
        feats = eng.features_for(params, topology=topo)
        ep = eng.EngineParams.from_scheduler(params, device=dev).lanes(FLEET)
        state = eng._init_state(tb)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state = eng._run_chunk(state, tb, ep, chunk=128, features=feats)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        print(f"[3] 128 event steps of the fleet (topology {topo}) ran "
              f"under set_sync_debug_mode('error'): no host sync in the "
              f"tick loop")
        # the session branch: a chunk of the slab's steps capped at a
        # per-lane horizon, as `session_advance` runs between flag reads
        zf = torch.zeros_like(state.sent)
        zb = torch.zeros_like(state.t0)
        state = eng._init_state(tb)._replace(rate=zf, pend_sent=zf,
                                             pend_tick=zb, pend_next=zb)
        n_end = torch.full((FLEET,), 2048.0, device=dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state = eng._session_chunk(state, tb, ep, n_end, 32,
                                       features=feats)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if not bool((state.tick > 0).all()):
            fail("[3] the session chunk moved no lane")
        print(f"[3] a session chunk of 32 event steps (topology {topo}) "
              f"ran under set_sync_debug_mode('error'): the flag read "
              f"between chunks is the session loop's only host sync")
        del state, tb
    # learned sizes: a replay chunk with the pilot estimate built in, and
    # a session chunk of a sampling slab holding a known and a learned row
    learned = dataclasses.replace(params, clairvoyant=False)
    tb = to_device(pack(fleet, port_bw=params.port_bw, sampling=True,
                        pilot_frac=learned.pilot_frac), dev)
    feats = eng.features_for(learned)
    ep = eng.EngineParams.from_scheduler(learned, device=dev).lanes(FLEET)
    state = eng._init_state(tb)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = eng._run_chunk(state, tb, ep, chunk=128, features=feats)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"[3] 128 learned event steps of the fleet (features {feats}) ran "
          f"under set_sync_debug_mode('error')")
    del state, tb
    pool = SessionPool(params, num_ports=PORTS, max_sessions=2,
                       features=(True, True, False, False, True))
    for mech in (None, {"clairvoyant": False}):
        pool.session(mechanisms=mech).submit(fleet[0].coflows[:64])
    pool._ensure()
    n_end = torch.full((2,), 2048.0, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = eng._session_chunk(pool._state, pool._tb, pool._ep_stack,
                                   n_end, 32, features=pool._features_now)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not bool((state.tick > 0).all()):
        fail("[3] the learned pool's session chunk moved no lane")
    print(f"[3] a session chunk of 32 event steps of a sampling pool slab "
          f"(a known and a learned row, clairvoyant leaves "
          f"{pool._ep_stack.dp.clairvoyant.tolist()}) ran under "
          f"set_sync_debug_mode('error')")
    del state, pool

    lap("3")

    # ---- 4. the big-switch main path -----------------------------------
    res, counts, captured = drive("4", Scenario(engine="torch",
                                                traces=fleet), fleet)
    for name in ("contention", "tick_walk"):
        if counts[name] != res.events:
            fail(f"{name} launched {counts[name]} times for {res.events} "
                 f"event steps")
    if counts["maxmin"]:
        fail("the max-min kernel ran on the big switch")
    if counts["ssd_scan"] or counts["flash_attention"]:
        fail("a model kernel ran on the big-switch fleet replay")

    lap("4")

    # ---- 5. whole-path parity with the JAX package ---------------------
    gold = json.loads(GOLDEN.read_text())
    for b, want in zip(gold["seeds"], gold["avg_cct"]):
        dev_rel = abs(res.avg_cct[b] - want) / want
        print(f"[5] lane {b}: avg CCT {res.avg_cct[b]:.6f} vs JAX "
              f"{want:.6f} (relative deviation {dev_rel:.3e})")
        if dev_rel > 1e-2:
            fail(f"lane {b} avg CCT deviates {dev_rel:.3%} from the JAX "
                 f"package")

    lap("5")

    # ---- 6. kernels vs plain versions on captured ticks ----------------
    grabbed, err = compare_ticks("6", captured, exact_rates=False)
    ca, _ = grabbed["contention"]
    wa, wk = grabbed["tick_walk"]
    B, C, P = ca[0].shape
    k1_ms = cuda_ms(lambda: ops.contention(*ca), 50)
    k1_plain = cuda_ms(lambda: ops.contention(*ca, force="ref"), 10)
    k1_lib = cuda_ms(lambda: contention_library(
        ca[0].bfloat16(), ca[1].bfloat16(), ca[2]), 10)
    k1_bound, k1_by = contention_bound_ms(*ca)
    f32 = (ca[0].float(), ca[1].float(), ca[2])
    if not torch.equal(ops.contention(*f32), ops.contention(*ca)):
        fail("[6] K1 on the f32 incidence differs from the main path's")
    k1_f32 = cuda_ms(lambda: ops.contention(*f32), 50)
    k1_f32_bound, _ = contention_bound_ms(*f32)
    k1_calls = cuda_launches("6", lambda: ops.contention(*ca))
    k1_host = host_us(lambda: ops.contention(*ca))
    walk_out = ops.tick_walk(*wa, **wk)
    k2_ms = cuda_ms(lambda: ops.tick_walk(*wa, **wk), 20)
    k2_plain = host_ms(lambda: ops.tick_walk(*wa, **wk, force="ref"))
    k2_bound, k2_by = walk_bound_ms(wa, walk_out)
    print(f"[6] K1 at ({B}, {C}, {P}) {str(ca[0].dtype)[6:]} (the main "
          f"path's incidence): kernel {k1_ms:.4f} ms, plain {k1_plain:.4f} "
          f"ms, bf16 matmul {k1_lib:.4f} ms, bound {k1_bound:.5f} ms "
          f"({k1_by}); as f32: kernel {k1_f32:.4f} ms, bound "
          f"{k1_f32_bound:.5f} ms; host {k1_host:.2f} us a call; CUDA "
          f"launches a call: {k1_calls}")
    k2_steps, k2_lane, k2_parts = walk_chain(wa, walk_out, False)
    print(f"[6] K2 at ({B}, {C}, {wa[2].shape[2]}), n_live "
          f"{int(wa[1].sum())}: kernel {k2_ms:.4f} ms, plain "
          f"{k2_plain:.1f} ms, bound {k2_bound:.5f} ms ({k2_by}); chain of "
          f"the busiest lane ({k2_lane}): {k2_steps} dependent steps "
          f"{k2_parts}, {1e6 * k2_ms / max(k2_steps, 1):.1f} ns per step")

    lap("6")

    # ---- 7. the leaf-spine max-min main path ---------------------------
    lres, lcounts, lcaptured = drive(
        "7", Scenario(engine="torch", traces=fleet, topology=leaf), fleet)
    for name in ("contention", "tick_walk", "maxmin"):
        if lcounts[name] != lres.events:
            fail(f"{name} launched {lcounts[name]} times for {lres.events} "
                 f"leaf-spine event steps")
    if lcounts["ssd_scan"] or lcounts["flash_attention"]:
        fail("a model kernel ran on the leaf-spine fleet replay")

    lap("7")

    # ---- 8. leaf-spine whole-path parity with the JAX package ----------
    lgold = json.loads(LEAF_GOLDEN.read_text())
    small = run(Scenario(engine="torch", topology=leaf, traces=tuple(
        fb_like_trace(PARITY_COFLOWS, PORTS, seed=s)
        for s in lgold["seeds"])))
    print(f"[8] fb_like_trace({PARITY_COFLOWS}, {PORTS}) lanes "
          f"{lgold['seeds']}: events {small.events} vs JAX "
          f"{lgold['events']}")
    if small.events != lgold["events"]:
        fail("leaf-spine parity lanes took another event count than the "
             "JAX package")
    for b, want in enumerate(lgold["avg_cct"]):
        dev_rel = abs(small.avg_cct[b] - want) / want
        print(f"[8] lane {lgold['seeds'][b]}: avg CCT "
              f"{small.avg_cct[b]:.6f} vs JAX {want:.6f} (relative "
              f"deviation {dev_rel:.3e})")
        if dev_rel > 1e-2:
            fail(f"leaf-spine lane {b} avg CCT deviates {dev_rel:.3%} "
                 f"from the JAX package")

    lap("8")

    # ---- 9. leaf-spine kernels vs plain versions on captured ticks -----
    lgrabbed, lerr = compare_ticks("9", lcaptured, exact_rates=True)
    err = {k: max(err[k], lerr[k]) for k in err}
    la, lk = lgrabbed["tick_walk"]
    lk2_ms = cuda_ms(lambda: ops.tick_walk(*la, **lk), 20)
    lk2_plain = host_ms(lambda: ops.tick_walk(*la, **lk, force="ref"))
    lwalk_out = ops.tick_walk(*la, **lk)
    lk2_bound, lk2_by = walk_bound_ms(la, lwalk_out)
    lk2_steps, lk2_lane, lk2_parts = walk_chain(la, lwalk_out,
                                                lk["admit_only"])
    print(f"[9] K2 (admission only) at ({la[2].shape[0]}, "
          f"{la[2].shape[1]}, {la[2].shape[2]}), n_live "
          f"{int(la[1].sum())}: kernel {lk2_ms:.4f} ms, plain "
          f"{lk2_plain:.1f} ms, bound {lk2_bound:.5f} ms ({lk2_by}); chain "
          f"of the busiest lane ({lk2_lane}): {lk2_steps} dependent steps "
          f"{lk2_parts}, {1e6 * lk2_ms / max(lk2_steps, 1):.1f} ns per "
          f"step")
    ma, mk = lgrabbed["maxmin_rates"]
    margs = dict(src=ma[0], dst=ma[1], cand=ma[2], avail=ma[3], **mk)
    rates = ops.maxmin_rates(*ma, **mk)
    k3_ms = cuda_ms(lambda: ops.maxmin_rates(*ma, **mk), 20)
    k3_plain = cuda_ms(lambda: ops.maxmin_rates(*ma, **mk, force="ref"), 3)
    nbytes, mops, rounds = maxmin_work(margs, rates)
    k3_bound, k3_by = bound(nbytes, mops)
    Bm, Fm = ma[0].shape
    print(f"[9] K3 at ({Bm} lanes, {ma[3].shape[1] // 2} rows a side, "
          f"{Fm} flows), {int(ma[2].sum())} candidates: kernel "
          f"{k3_ms:.4f} ms, plain {k3_plain:.3f} ms, bound {k3_bound:.5f} "
          f"ms ({k3_by}); chain: {rounds} rounds (distinct candidate levels "
          f"of the busiest lane) of {MAXMIN_STEPS_PER_ROUND} block "
          f"barriers, {1e6 * k3_ms / max(rounds, 1):.1f} ns per round; "
          f"library: null (no single PyTorch call computes max-min fair "
          f"rates)")

    lap("9")

    # ---- 10. K4 against its plain version ------------------------------
    k4 = {}
    for shape in SSD_CASES + [SSD_SERVE]:
        for dtype in (torch.float32, torch.bfloat16):
            args = ssd_inputs(shape, dtype, shape[1] + shape[2], dev)
            lc = shape[-1]
            y, st = ops.ssd_scan(*args, lc=lc)
            y_ref, st_ref = ops.ssd_scan(*args, lc=lc, force="ref")
            torch.cuda.synchronize()
            scale = (float(y_ref.float().abs().max())
                     if shape == SSD_SERVE else 1.0)
            ok_y, err_y = ssd_err(y, y_ref, 5e-4 * scale)
            ok_s, err_s = ssd_err(st, st_ref, 5e-4)
            ymax = float(y_ref.float().abs().max())
            print(f"[10] K4 {shape} {str(dtype)[6:]}: max abs error y "
                  f"{err_y:.3e} (max|y| {ymax:.3f}), state {err_s:.3e}")
            if not (ok_y and ok_s) or y.dtype != dtype:
                fail(f"K4 disagrees with ssd_chunked_ref at {shape} {dtype}")
            if shape == SSD_SERVE:
                k4[dtype] = dict(
                    args=args, err=max(err_y, err_s),
                    ms=cuda_ms(lambda: ops.ssd_scan(*args, lc=lc), 20),
                    plain=cuda_ms(lambda: ops.ssd_scan(
                        *args, lc=lc, force="ref"), 5),
                    bound=ssd_bound_ms(shape, args[0].element_size()))
            del args, y, y_ref
    x, dt_, a, b, c = ssd_inputs((1, 64, 2, 1, 16, 32, 16),
                                 torch.float32, 5, dev)
    y_full, s_full = ops.ssd_scan(x, dt_, a, b, c, lc=16, force="ref")
    y1, s1 = ops.ssd_scan(x[:, :32], dt_[:, :32], a, b[:, :32], c[:, :32],
                          lc=16)
    y2, s2 = ops.ssd_scan(x[:, 32:], dt_[:, 32:], a, b[:, 32:], c[:, 32:],
                          init_state=s1, lc=16)
    torch.cuda.synchronize()
    if not (torch.allclose(torch.cat([y1, y2], 1), y_full, atol=1e-4,
                           rtol=1e-3)
            and torch.allclose(s2, s_full, atol=1e-4, rtol=1e-3)):
        fail("K4's two chained halves differ from one plain scan")
    print("[10] K4 two chained halves == one plain scan (atol 1e-4, "
          "rtol 1e-3)")
    for dtype, r in k4.items():
        bnd, by = r["bound"]
        print(f"[10] K4 at the serve shape {SSD_SERVE} {str(dtype)[6:]}: "
              f"kernel {r['ms']:.4f} ms, plain {r['plain']:.4f} ms, bound "
              f"{bnd:.4f} ms ({by}); library: null (no single PyTorch "
              f"call computes the SSD scan)")
    one = (1,) + SSD_SERVE[1:]
    k4_one = ssd_inputs(one, torch.bfloat16, 7, dev)
    bnd, by = ssd_bound_ms(one, 2)
    print(f"[10] K4 at B = 1 {one} bfloat16: kernel "
          f"{cuda_ms(lambda: ops.ssd_scan(*k4_one, lc=one[-1]), 20):.4f} "
          f"ms, bound {bnd:.4f} ms ({by}); CUDA launches a call: "
          f"{cuda_launches('10', lambda: ops.ssd_scan(*k4_one, lc=one[-1]))}")
    del k4_one

    lap("10")

    # ---- 11. Mamba2 full-width parity with the JAX package -------------
    golden_parity("11", SERVE_ARCH, MAMBA_GOLDEN, {"ssd_state_norm": "ssd"})

    lap("11")

    # ---- 12. the serve main path: Mamba2-1.3B, 48 layers, bf16 ---------
    scounts = serve_main_path("12", SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT,
                              SERVE_TOKENS)

    lap("12")

    # ---- 13. K5 against its plain version ------------------------------
    k5 = {}
    for shape in FLASH_CASES + [FLASH_SERVE]:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in ((True,) if shape == FLASH_SERVE
                           else (True, False)):
                q, k, v = flash_inputs(shape, dtype, shape[3] + shape[5],
                                       dev)
                off = shape[-1]
                got = ops.flash_attention(q, k, v, causal=causal,
                                          q_offset=off)
                want = ops.flash_attention(q, k, v, causal=causal,
                                           q_offset=off, force="ref")
                torch.cuda.synchronize()
                e = float((got.float() - want.float()).abs().max())
                bar = 2e-6 if dtype == torch.float32 else 2e-2
                print(f"[13] K5 {shape} {str(dtype)[6:]} causal={causal}: "
                      f"max abs error {e:.3e} (bar {bar})")
                if e > bar or got.dtype != dtype or not bool(
                        torch.isfinite(got).all()):
                    fail(f"K5 disagrees with flash_attention_ref at {shape} "
                         f"{dtype} causal={causal}")
            if shape == FLASH_SERVE:
                bnd, by, pairs = attention_bound_ms(shape, q.element_size())
                k5[dtype] = dict(
                    err=e, bound=bnd, by=by, pairs=pairs,
                    ms=cuda_ms(lambda: ops.flash_attention(q, k, v), 10),
                    plain=cuda_ms(lambda: ops.flash_attention(
                        q, k, v, force="ref"), 3),
                    sdpa=cuda_ms(lambda: sdpa(q, k, v), 10))
            del q, k, v, got, want
    for dtype, r in k5.items():
        print(f"[13] K5 at the serve shape {FLASH_SERVE} {str(dtype)[6:]}: "
              f"kernel {r['ms']:.4f} ms, plain {r['plain']:.4f} ms, SDPA "
              f"{r['sdpa']:.4f} ms, bound {r['bound']:.4f} ms ({r['by']}; "
              f"{r['pairs']} unmasked pairs; their exps at the SFU rate "
              f"{1e3 * r['pairs'] / SFU_OPS_PER_S:.4f} ms)")
    r = k5[torch.bfloat16]
    flop = 2 * 2 * FLASH_SERVE[5] * r["pairs"]
    print(f"[13] K5 bf16 at the serve shape: {flop / r['ms'] / 1e9:.1f} "
          f"TFLOP/s ({flop / 1e9:.2f} GFLOP of unmasked pairs), "
          f"{r['bound'] / r['ms']:.1%} of the bound, {r['ms'] / r['sdpa']:.3f}"
          f" x SDPA's time in this run; {smi()}")

    lap("13")

    # ---- 14. StarCoder2 full-width parity with the JAX package ---------
    golden_parity("14", ATTN_ARCH, ATTN_GOLDEN,
                  {"k_cache_norm": "k", "v_cache_norm": "v"})

    lap("14")

    # ---- 15. the serve main path: StarCoder2-3B, 30 layers, bf16 -------
    acounts = serve_main_path("15", ATTN_ARCH, ATTN_BATCH, ATTN_PROMPT,
                              ATTN_TOKENS)
    bf16_pair("15", ATTN_ARCH, ATTN_BATCH, ATTN_PROMPT, "flash_attention")

    lap("15")

    # ---- 16. the pool's main path on the big switch --------------------
    pcounts = pool_main_path("16", fleet, params, res)

    lap("16")

    # ---- 17. the leaf-spine pool ---------------------------------------
    plcounts = leafspine_pool("17", params, leaf)

    lap("17")

    # ---- 18. learned sizes: the fleet, its parity lanes ----------------
    ecounts, elcounts, eerr = learned_main_path("18", fleet, leaf, res)

    lap("18")

    # ---- 19. the CoflowServer front door --------------------------------
    svcounts, sverr = server_main_path("19", params)
    err = {k: max(err[k], eerr[k], sverr[k]) for k in err}

    lap("19")

    # ---- 20. K6: the segment sums' prefix sums -------------------------
    (k6_x,), _ = grabbed["prefix_sum"]
    (k6_lx,), _ = lgrabbed["prefix_sum"]
    k6 = prefix_sum_phase("20", k6_x, k6_lx, err["prefix_sum"])

    lap("20")

    # ---- 21. the port's drivers -----------------------------------------
    sys.path.insert(0, str(ROOT))   # the `benchmarks` package
    drivers_phase("21")

    lap("21")

    # ---- 22. the event-driven host plane, nine policies ----------------
    from benchmarks import torch_common
    full = torch_common.Bench(quick=False, device="cuda")
    hcounts, herr = host_plane_phase("22", full)
    err["contention"] = max(err["contention"], herr)
    lap("22")

    # ---- 23. the paper's figure drivers ---------------------------------
    fcounts, ferr = figures_phase("23", full, res)
    del full
    lap("23")

    # ---- 24. the runtime bridge -----------------------------------------
    bcounts, berr = bridge_phase("24")
    err = {k: max(err[k], ferr[k], berr[k]) for k in err}
    lap("24")

    # ---- 25. the analysis plane -----------------------------------------
    ancounts, anerr = analysis_phase("25", fleet, params, leaf)
    err = {k: max(err[k], anerr[k]) for k in err}
    lap("25")

    # ---- 26. K5 at MLA's widths, K5 and K4 at the new models' shapes ----
    moe_shapes = moe_kernels_phase("26")
    lap("26")

    # ---- 27. MoE, MLA and hybrid full-width parity with the JAX package -
    for arch, (name, norms) in MOE_GOLDENS.items():
        golden_parity("27", arch, ROOT / "tests" / "data" / name, norms)
    lap("27")

    # ---- 28. the MoE, MLA and hybrid serve main paths -------------------
    moe_counts = {}
    for arch in MOE_ARCHS:
        layers, f32_layers = MOE_SERVE_LAYERS[arch]
        moe_counts[arch] = serve_main_path(
            "28", arch, MOE_BATCH, MOE_PROMPT, MOE_TOKENS, layers=layers,
            f32_layers=f32_layers)
    bf16_pair("28", "deepseek-v2-236b", MOE_BATCH, MOE_PROMPT,
              "flash_attention", numpy_weights=False)
    lap("28")

    # ---- 29. training: K7, the train golden, StarCoder2-3B at full width
    k7, tcounts = train_phase("29")
    lap("29")

    # ---- 30. the other dense models and the encoder-decoder, full depth
    dense_shapes, dense_counts = dense_phase("30")
    lap("30")

    # ---- 31. training through the Mamba mixer and the encoder ----------
    k8, ssm_counts, ssm_k5 = train_ssm_phase("31")
    lap("31")

    paths = {"bigswitch": counts, "leafspine": lcounts,
             "mamba2_serve": scounts, "starcoder2_serve": acounts,
             "session_bigswitch": pcounts, "session_leafspine": plcounts,
             "learned_bigswitch": ecounts, "learned_leafspine": elcounts,
             "server": svcounts, "host_plane": hcounts,
             "figures": fcounts, "bridge": bcounts, "analysis": ancounts,
             "qwen3_moe": moe_counts["qwen3-moe-235b-a22b"],
             "deepseek_v2": moe_counts["deepseek-v2-236b"],
             "jamba": moe_counts["jamba-v0.1-52b"], "train": tcounts,
             **{a.replace("-", "_").replace(".", "p"): dense_counts[a]
                for a in DENSE_ARCHS}, "train_ssm": ssm_counts}
    total = {n: sum(p[n] for p in paths.values()) for n in counts}
    by_path = {n: {k: p[n] for k, p in paths.items()} for n in counts}
    kernels = [
        {"name": "contention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/contention.cu",
         "replaces": "src/repro/kernels/contention.py:51",
         "launches": total["contention"],
         "launches_by_path": by_path["contention"],
         "max_abs_err": err["contention"], "ms": k1_ms,
         "plain_ms": k1_plain, "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": k1_lib},
        {"name": "tick_walk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/walk.cu",
         "replaces": "src/repro/core/jax_coordinator.py:311",
         "launches": total["tick_walk"],
         "launches_by_path": by_path["tick_walk"],
         "max_abs_err": err["tick_walk"], "ms": k2_ms,
         "plain_ms": k2_plain, "bound_ms": k2_bound, "bound_by": k2_by,
         "library_ms": None},
        {"name": "maxmin", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/maxmin.cu",
         "replaces": "src/repro/kernels/maxmin.py:60",
         "launches": total["maxmin"], "launches_by_path": by_path["maxmin"],
         "max_abs_err": err["maxmin_rates"], "ms": k3_ms,
         "plain_ms": k3_plain, "bound_ms": k3_bound, "bound_by": k3_by,
         "library_ms": None},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:73",
         "launches": total["ssd_scan"],
         "launches_by_path": by_path["ssd_scan"],
         "max_abs_err": k4[torch.bfloat16]["err"],
         "ms": k4[torch.bfloat16]["ms"],
         "plain_ms": k4[torch.bfloat16]["plain"],
         "bound_ms": k4[torch.bfloat16]["bound"][0],
         "bound_by": k4[torch.bfloat16]["bound"][1], "library_ms": None,
         "shapes": moe_shapes["ssd_scan"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:77",
         "launches": total["flash_attention"],
         "launches_by_path": by_path["flash_attention"],
         "max_abs_err": k5[torch.bfloat16]["err"],
         "ms": k5[torch.bfloat16]["ms"],
         "plain_ms": k5[torch.bfloat16]["plain"],
         "bound_ms": k5[torch.bfloat16]["bound"],
         "bound_by": k5[torch.bfloat16]["by"],
         "library_ms": k5[torch.bfloat16]["sdpa"],
         "shapes": moe_shapes["flash_attention"] + dense_shapes + ssm_k5},
        {**k6, "launches": total["prefix_sum"],
         "launches_by_path": by_path["prefix_sum"],
         "rows": total["prefix_sum_rows"],
         "rows_by_path": by_path["prefix_sum_rows"]},
        {**k7, "launches": total["flash_attention_bwd"],
         "launches_by_path": by_path["flash_attention_bwd"]},
        {**k8, "launches": total["ssd_scan_bwd"],
         "launches_by_path": by_path["ssd_scan_bwd"]},
    ]
    if "--profile" in sys.argv[1:]:
        for topo, label in ((None, "big switch"), (leaf, "leaf-spine")):
            profile_chunk(fleet, params,
                          eng.features_for(params, topology=topo), topo,
                          label)
    print(json.dumps({"kernels": kernels}))
    print(f"script wall {time.perf_counter() - t_script:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
