#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

  1. build   nvcc builds the kernels (K1 FMA body, K2 memory sweep, K3
             single-step megakernel, K4 temporal-blocked megakernel in three
             forms, tiled, resident and cooperative, K5 flash attention in two
             forms, bf16 on the tensor cores and f32, K6 decode attention,
             K7 SSD intra-chunk, K8 RMSNorm) from ``src/``, one nvcc
             process per source, all started together.
  2. parity  each kernel against its plain PyTorch version on the card:
             K1-K3 at the main path's width W = 2112, at W = 65536 and at
             W = 132 (one task an SM; one chain a thread), K1 also at
             n % 4 != 0 (with 4 chains a thread: the scalar tail) and on an
             input at a 4-byte offset (its scalar path), K2 also at ragged
             payloads and scratches (its 16-byte and scalar paths), K3 also
             at a ragged payload (its scalar path), at 9 slots (onehot's
             merge from memory, not registers) and on out-of-range
             indices; K3 with the one-device halo wrap folded in (``wrap``)
             equal bit for bit to K3 on the row-gathered halo extension,
             every combine and body, H in {1, 2}, W in {2112, 132, 1, 2,
             3}, gather and onehot indices past both ends of the extended
             length; K4 in every form that applies (the resident and the
             cooperative form for the compute and empty bodies, the
             cooperative form alone for the memory body; each pinned with
             ``form=`` and counted on its own counter), each held to the
             plain version and the forms to each other bit for bit: at the
             blocked main path's buffer (M = 2144 rows) for every combine,
             random fixed and time-varying tables, every body, S in {2, 8},
             an act mask with a masked tail and a frozen member; with the
             tiled form too on tables of reach <= 2 (window, gather,
             onehot), compute and empty bodies, S in {2, 8}, M = 2144 and
             301; the pipelined phases stitched together equal to one full
             K4 launch, bit for bit, in each form; K3 gather and onehot at
             W = D = 512 (all_to_all's slots at the gather cap); K4's
             time-varying tables at M = 512 and 2048, S = 8, D = 3 and 512
             (the blocked all-gather plan's shapes);
             K5 (both forms) at the serving prefill (8 x 16 heads x 1024 x
             128, causal) and a windowed ragged case, K6 (one cluster
             launch) at the serving decode (q 8 x 16
             x 128 over an 8 x 8 x 1088 x 128 cache, lengths 0 .. 1088,
             window 0 and 256), K5 and K6 at hymba-1.5b's (group 5, head
             dim 64, window 1024), K5 at llama-3.2-vision's cross-attention
             (non-causal, q 4 x 64 x 1024 x 128 over k/v 4 x 8 x 1600 x
             128) and K6 over that cache read whole, and K5 and K6 at each
             other served arch's prefill and decode (SERVED_ATTN: head dims
             64 to 256, groups 1 to 8, each window of its layer kinds,
             lengths over its run's decode reads); K7 at mamba2-130m's and hymba-1.5b's
             prefill chunks, at T = 5, at G = 2 and at P = 12, with some
             dtA <= -30; K8 at mamba2's norm shapes, (37, 1000), (5, 33)
             and x at an odd offset (the scalar path); each in bf16 and
             f32.
  3. main    the Task Bench main path: the 7 halo patterns through ``pallas_step``
             and ``fused(use_kernels=True)`` at W = 2112, T = 1000,
             payload 64, compute_bound grain 64, checked against each
             other and against ``fused(use_kernels=False)``; then
             ``pallas_step(steps_per_launch=8)`` serial and pipelined on
             every pattern (window; gather and onehot on two), held to the
             S = 1 run and pipelined equal to serial bit for bit; one
             memory_bound run of each; small-input checks against the CPU
             plain path. Every run is its runtime's ``build``: the eager
             loop captured as one CUDA graph (its warm-up and capture
             counted apart from the run's launches), replayed once; each
             schedule (S = 1 window, gather and onehot, S = 8 pipelined and
             serial, ``fused`` with the kernels, the memory_bound runs)
             equals its eager loop bit for bit and launches the same
             kernels; capture times and node counts are printed (the plain
             ``fused`` run at grain 64: ~136k nodes). The launch counters
             are zeroed just before and read just after, and each replay's
             launches must equal the runtime's ``dispatches_per_run``. One
             replay of a short S = 1 run's graph under ``torch.profiler``
             shows one device kernel a timestep, K3, and nothing else (the
             halo wrap is folded into K3).
  4. plans   ``pallas_step``'s stride and all-gather plans at T = 1000,
             payload 64, grain 64, each run one graph replay equal to its
             eager loop bit for bit, its launches (zeroed just before the
             phase, the eager loops' and the references' kept apart) equal
             to ``dispatches_per_run`` and to the plan's kernels: fft and
             tree at W = 2048 on the stride plan (K3 ``pair``; gather and
             onehot) and at an explicit S = 8 over the cap (per step), at
             W = 512 with S = 8 (re-routed to the blocked all-gather plan:
             K4's resident form on time-varying tables); spread and
             all_to_all at W = 512 at S = 1 and 8, all_to_all with the row
             mean on and off; spread at W = 2048 under a raised cap; one
             memory_bound run on each plan; W = 1 fft; then each plan at
             grain 1, T = 7 against the CPU plain path (each reference 100 x
             TOL or more from the FMA's fixed point, or the phase fails). Butterfly runs
             equal ``fused(use_kernels=True)`` bit for bit, the rest are
             held to TOL (TOL_MEMORY_RUN for memory_bound) against it and
             against plain ``fused``. One replay of a 6-step fft graph
             under ``torch.profiler``: 6 K3 in their pair mode and the XOR
             shuffle's copy kernels, counted and timed.
  5. ensemble  GraphEnsembles through ``build_ensemble``, each run one graph
             replay equal to its eager loop bit for bit, its launches
             (zeroed just before the phase, the eager loops' and the
             references' kept apart) equal to ``ensemble_dispatches_per_run``:
             K = 4 stacked stencil_1d members at W = 2112, T = 1000, payload
             64, grain 64 (seeds 0-3) through ``pallas_step`` at S = 1 (1000
             K3 for all four) and at S = 8 pipelined and serial with horizons
             T = (1000, 750, 333, 1) (pipelined equal to serial bit for bit),
             each member against its own single-graph run (bit for bit
             recorded, TOL held); one memory_bound stacked run; a
             mixed-spec tuple (stencil_1d grain 64, nearest radius 2 grain
             256, no_comm memory_bound) at S = 1 and 8; a mixed-plan tuple
             (stencil_1d W = 2112, fft W = 2048, spread and all_to_all W =
             512), one step a launch; ``fused(use_kernels=True)`` on each,
             held to TOL against ``pallas_step`` and the plain path. Then
             the stacked launch plan at S = 8, stepped on the host: equal to
             ``build_ensemble`` bit for bit; with member 1's act rows zeroed
             from launch 40 it equals its own run at T = 321, bit for bit; a
             fresh member admitted into slot 3 at launch 60 holds the t = 0
             K3 of its init; the capture count reads the same before and
             after both edits. Grain 64 drives every state to the FMA's
             fixed point, so the members against their own runs and the
             launch plan's edits run again at grain 1 (T = 7, 6, 4, 1, inside
             the contraction horizon, each reference 100 x TOL or more from
             the fixed point; radii 1 and 2 stacked; each combine at S = 1
             and 2, the plan's edits at launches 1 and 2), also
             against the CPU plain path, and so do ``fused(use_kernels=
             True)``'s stacked run and both tuples (mixed-spec at S = 1 and
             8 and on ``fused(use_kernels=True)``, mixed-plan on both, the
             fft member bit for bit), each with mixed horizons and each
             member held to the CPU plain path. The members bit for bit
             their own runs are counted apart: at grain 1 and memory_bound
             (the evidence), and the grain-64 compute members.
  6. schedule  ``steps_per_launch="auto"`` under a cost model measured on
             the card (``kernels/probes.py``'s ``run_probes``: K3 as a graph
             node, the slope of its wall over widths, the one-device
             exchange 0.0 so X = 1), printed and saved to a temporary cache
             file: the 7 halo patterns at the main path's shape and one
             memory_bound run through ``pallas_step(steps_per_launch=
             "auto", cost_model=...)``, each resolution and its reason
             printed, the compute runs serial at S = 16 (the deepest depth
             K4's tiled form holds), memory_bound at S = 1, each run equal
             bit for bit to the explicit run of the depth and schedule it
             resolved to and launching ``dispatches_per_run`` (the counters
             zeroed just before the phase, the twins' and the probes' kept
             apart); the step walls of "auto" beside explicit S = 1, 8 and
             16 serial (graph replays, grains 64 and 1); one run resolved
             through the cache (``REPRO_COST_MODEL`` naming the file, keyed
             by the CUDA device name); fft, tree, spread and all_to_all at
             [plans]' widths under "auto" (the all-gather plan at S = 1);
             the K = 4 stacked ensemble under "auto", equal to its twin,
             its step walls beside explicit S = 1, 8 and 16 serial, and
             its launch plan stepped under a ``DeadlineDetector`` held
             to its ``expected_launch_us``: each launch's device wall
             (between CUDA events), measured once, under the deadline;
             the act rows staged on the card ahead and a spin kernel
             queued before the start event, so the events bracket the
             launch's device work and not the host's issue; a launch
             whose host issue alone crosses the deadline printed as a
             host stall; each launch's walls beside the
             expected one; under the analytic
             model ``expected_launch_us`` is None.
  6a. resilience  ``Runtime.execute_ensemble_resilient`` (``repro_torch.
             resilience``, the launch plan stepped from the host under the
             cost model measured in [schedule]): K = 4 stacked stencil_1d at
             W = 2112, S = 1 (K3) and S = 8 (K4 tiled), grain 64 at T up to
             1000 and grain 1 at T <= 7 (the dataflow shows), a mixed-plan
             stepwise ensemble at grain 1, and grain 1 over D = 4 shards of
             the card. The clean run equals the ``build_ensemble`` replay
             bit for bit; under a plan of every fault class (a transport
             fault twice, a launch that raises, a poisoned launch, a member
             eviction with re-admission, a frozen eviction at the last
             launch, a 150 ms straggler) the survivors equal the clean run,
             the evicted and the re-admitted members their same-K oracle
             (one ``build_ensemble`` replay), bit for bit; the events equal
             the plan; the straggler is flagged against the detector's
             deadline; the K3 and K4 launches equal the clean run's plus
             one launch for each poisoned or evicting replay and the t = 0
             K3 of each admission; D = 4 equals D = 1 bit for bit. The
             clean walls at T = 1000 beside the replay's and
             ``measure_launch_plan``'s (the host-stepping tax), recovery
             walls by class, the detection overshoot, and the launches the
             default policy flags in clean runs.
  6b. serving  ``repro_torch.serving.ServingFabric`` over ``pallas_step``
             at W = 2112, S = 8, four slots, under ``LaunchClock``: 12
             requests in two cohorts (stencil_1d, nearest), mixed T, two
             priorities, one explicit deadline that evicts; every outcome
             bit for bit its same-K serial oracle (run after serving), no
             capture between a cohort's first launch and its end, the
             census (founders, admissions, evictions) equal to ``pack``'s
             prediction, K4 launches equal to the launches run and K3 to
             the inits and admissions; the same checks at grain 1, T <= 7,
             S = 2 (the dataflow shows; admissions and an eviction within
             the horizon); one ``WallClock`` pass on the default deadline
             factor: latency p50/p95/p99, slot utilization and the requests
             priced deadlines evict.
  6c. restart  ``checkpoint.elastic.run_with_restarts`` over the stacked S =
             8 launch plan at W = 2112 (grain 64, T = 1000, one launch a
             step), a checkpoint every 25 launches, ``keep=2``, failures at
             two launches, the newest checkpoint corrupted before the
             second, so the restore falls back to the one before; the
             final state equal to the uninterrupted plan bit for bit; the
             same at grain 1, T = 7, S = 2; save and restore ms of the 2.16
             MB state, in a temporary directory removed after.
  7. rungs   the paper's other four rungs, each with the kernels
             (``use_kernels=True``; the launch counters and host calls
             zeroed just before the phase, the eager loops' and the
             references' kept apart): ``bsp`` (one graph per distinct
             superstep, replayed from a host loop, one host call a step),
             ``bsp_scan`` and ``overlap`` (the run one graph replay;
             ``overlap`` also with ``overlap=False`` and
             ``halo_via="allgather"``) on the main path's 7 halo patterns
             (overlap refuses trivial) at W = 2112, T = 1000, payload 64,
             grain 64, ``bsp(donate=False)`` on stencil_1d equal bit for
             bit to ``donate=True``; one memory_bound run each; ``bsp`` and
             ``bsp_scan`` on fft and spread at W = 512 (fft bit for bit
             ``fused(use_kernels=True)``); ``serialized`` at W = 132, T = 50
             (the main path's 2.1 M tasks are over its MAX_TASKS, the
             refusal printed), grains 64 and 1; a K = 4 ensemble on each
             (stencil_1d, seeds 0-3, horizons T = (1000, 750, 333, 1), for
             serialized (50, 40, 20, 1) at W = 132), each member against
             its own ``fused(use_kernels=True)`` run. Every run equals its
             eager loop bit for bit (``serialized``: a second run), is held
             to ``fused(use_kernels=True)`` (TOL; TOL_MEMORY_RUN for
             memory_bound), launches its K1/K2 bodies
             (``body_launches_per_run``: T, or 1 + 3 (T - 1) for
             ``overlap``, T x W for ``serialized``) and nothing else,
             and makes ``host_calls_per_run`` host calls (graph replays
             and task calls); its us a step (a task), graphs, nodes, build
             seconds and the memory reserved at its build are printed.
             Grain 64 puts every state at the FMA's fixed point 0.2 within
             a step, so the agreement that shows the dataflow comes from
             the grain-1 and memory_bound runs, counted apart: at grain 1
             a K = 4 ensemble on each rung (members of mixed patterns and
             horizons from ENS_SHORT, one of T = 1, W = 64), each member
             against the CPU plain path's run of it alone, and every rung
             with each option (bsp both buffer schemes, overlap three
             ways) at T = 8, W = 64 on the 11 patterns it supports against
             the CPU plain path. Then a short run of each under
             ``torch.profiler`` (issued three times in one window, the
             last read): one device kernel per counted operation
             (``dispatches_per_run``), the K1 launches among them, and
             their device time.
  7b. shards the port over row shards of the card
             (``devices=["cuda"] * D``): the main shape (W = 2112, T =
             250 for the time limit, grain 64) at D = 4 on the 7 halo
             patterns through
             ``bsp_scan``, ``overlap`` and ``pallas_step`` S = 1 and S = 8
             pipelined and serial; on stencil_1d and nearest also ``bsp``,
             ``overlap=False``, ``halo_via="allgather"``,
             ``halo_impl="ppermute"`` and "auto" (under the probe's model),
             and all of it at D = 2; the same schedules at D = 1 on
             stencil_1d for the step walls; memory_bound at D = 4 (K2, K3,
             and K4's cooperative form at S = 8). Each run a ShardedRun
             over one graph (bsp: a graph a superstep), equal to its eager
             loop bit for bit, launching D times a shard's count in
             ``host_calls_per_run`` host calls; S = 8 pipelined, serial
             and "ppermute" equal bit for bit. Where the dataflow shows
             (grain 1, W = 64, T = 7, inside the contraction horizon: each
             reference at least 100 x TOL from the fixed point, or the
             phase fails; fft and spread at W = 512; multi-hop at W = 16,
             r = 2, S = 3; a K = 4 ensemble per rung and a stacked
             pallas_step ensemble) against the CPU plain path. At grain 64
             every state is at the fixed point, so the comparisons below
             check graphs, counts and bits only.
             The stride and all-gather plans at T = 250 (D = 4, B = 512
             and 128): fft and tree at W = 2048 on the stride plan under
             ``halo_impl`` "xla" and "ppermute" (in-block strides by the
             XOR shuffle, block strides by the XOR block exchange), fft at
             W = 512 with S = 8 (the blocked all-gather plan: D cooperative
             K4 grids at once), spread and all_to_all at W = 512 at S = 1
             and 8 under ``gather_impl`` "xla", "ppermute" and "chunked"
             (all_to_all also with ``psum_mean=False``), "auto" on fft at
             2048 and spread at 512 under the probe's D = 4 model (its
             plan, S and reason printed), fft at 2048 and spread at 512 at
             D = 2; each equal bit for bit to its D = 1 run (all_to_all's
             row mean within TOL) and the transports to each other, the µs
             a step beside D = 1's; at grain 1 (W = 64 and 512) also under
             the other transports. Ensembles across the shards: K = 4
             stacked stencil_1d members at W = 2112 over D = 4, cut to T
             = 250 for the time limit (horizons 250, 187, 83, 1), with
             ``member_shards=2`` (the row
             x member mesh: two rings of two shards) at S = 1 and S = 8
             pipelined and serial, each bit for bit its Dk = 1 run, and
             ``member_shards="auto"`` under the probe's D = 4 model (its Dk
             and reason printed); the stacked launch plan at Dk = 1 and 2
             (S = 8, member 1 evicted from launch 10, a fresh member
             admitted into slot 3 at launch 15; Dk = 2 bit for bit Dk = 1);
             a tuple (stencil_1d at 2112, fft at 2048, spread at 512) and
             its stepwise launch plan under the same edits, each bit for
             bit its D = 1 twin; every run equal to its eager loop three
             times, its launches exactly those counted, its us a step
             beside its twin's; the same paths at grain 1 (W = 64, T = 7,
             6, 4, 1; Dk = 1, 2, 4 at S = 1 and 3) against the CPU plain
             path. ``probe_halo_exchange_us(4)`` per
             transport and its X, and the stride, gather and
             gather-transport probe tables at D = 4. The
             overlap measured: one replay each of a 6-step ``overlap``
             (True, False) and a 17-step pipelined ``pallas_step``
             ("ppermute") under ``torch.profiler``: the copy nodes (the
             transfers) against every other kernel, > 0 us of overlap for
             ``overlap=True``, exactly 0 for ``overlap=False``. Across
             distinct cards only where there are two (else one line says
             it was not run).
  7c. trace the traced twin of each backend (``trace=True``,
             ``Runtime.trace_once``, ``repro_torch.obs``) on the card at
             full width: ``pallas_step`` on stencil_1d at W = 2112, T =
             1000, grain 64 at S = 1, serial S = 8 and pipelined S = 8; fft
             at W = 2048 (the stride plan) and spread at W = 512 (the
             all-gather plan); ``fused``, ``bsp``, ``bsp_scan`` and
             ``overlap`` with the kernels at W = 2112; ``serialized`` at W
             = 132, T = 50; and over D = 4 shards of the card S = 1,
             pipelined S = 8 and fft. Each traced run equals the build's
             replay bit for bit, launches exactly what its eager loop
             launches (its warm-up and probes counted apart), has fractions
             summing to 1 and, for ``pallas_step``, its ``schedule.resolve``
             record; each prints ``obs.summarize``'s wall and category
             walls beside the replay's best wall (what host-stepping costs),
             the pipelined runs their overlap verdict and probes (at D = 1
             "unavailable": the self-wrap moves no rows), and the D = 4
             pipelined trace is written as Chrome JSON to
             ``artifacts/bench_torch/trace_pipelined_d4.json``.
  8. metg    grains 1..16384, stencil_1d, T = 1000, 5 reps, W in {132,
             2112} (one task per SM times overdecomposition 1 and 16), on
             both backends and on ``pallas_step(steps_per_launch=8)``
             pipelined and serial, each run one graph replay; at grains 1
             and 64 the eager loop's step wall beside the graph's.
  9. serve   the LM serving paths through ``repro_torch.launch.serve.serve``,
             each at full width and depth, f32 storage, bf16 compute,
             random weights from seed 0, greedy: [serve] internlm2-1.8b,
             batch 8, prompt 1024, 64 tokens (launches: 24 K5 in its
             tensor-core form, 24 x 63 K6); [serve-ssm] mamba2-130m, batch
             8, prompt 1024, 64 tokens (24 K7 in the prefill, nothing in
             decode); [serve-hybrid] hymba-1.5b, batch 4, prompt 1024, 16
             tokens (32 K5 in its tensor-core form + 32 K7, 32 x 15 K6).
             Each decode step after the first is one CUDA graph replay.
             For each, the
             launch counters, zeroed just before, must read exactly that;
             every step's logits finite; the same run with every decode
             step eager gives the same tokens and the same logits bit for
             bit (the p50 step wall both ways); the prefill and 4 decode steps,
             teacher-forced with the served tokens, held against the same
             model on its plain path on the card; 3 more decode steps
             under ``torch.profiler`` (device kernels, and host operators
             by self CPU time), then 3 as replays of the step's graph
             (device kernels); the prefill again, warm. The same for
             [serve-moe] granite-moe-3b-a800m at full width and depth
             (batch 8, prompt 1024, 64 tokens; 32 K5, 32 x 63 K6; the
             plain path replays the kernel path's routing, and the
             (token, layer) choices on which the two paths' own routers
             differ are printed), [serve-xattn]
             llama-3.2-vision-90b at full width with 5 of its 100 layers
             (4 attn + 1 xattn; batch 4, prompt 1024, 16 tokens; 4 K5 and
             1 of its f32 form over the f32 image K/V, 5 x 15 K6; served
             with zero image embeddings as the reference's
             serve, teacher-forced with 0.02 N(0, 1) image embeddings and
             the cross-attention gates at 1, so the cross term counts),
             [serve-embed] musicgen-medium (batch 8, 1024 prompt
             embeddings, 64 steps each drawing its embedding inside the
             step's graph; 48 K5, 48 x 63 K6) and [serve-int8]
             internlm2-1.8b with the int8 KV cache at [serve]'s shape (its
             decode logits also against [serve]'s); each kernel-vs-plain
             limit lies between the sound path's reading and a broken
             control's (beside each TOL_SERVE_*). Then [serve-archs]: one
             serve each of gemma3-4b, minitron-8b, stablelm-3b and
             mixtral-8x7b at full width with 2 of its 32 layers (batch 4,
             prompt 1024, 16 tokens), launches held exactly. Then [norm]:
             ``ops.rmsnorm``, K8's one entry point (the models call its
             plain version, as the reference's do), at mamba2's norm
             shapes, 2 launches.
  9b. train  (after [serve-archs], before [norm]) training through
             ``repro_torch.launch``: (a) one ``make_train_step`` on the
             card against the same step on the CPU, one weight set, f32, on
             reduced internlm2-1.8b, granite-moe-3b-a800m and hymba-1.5b at
             accum 1 and 2: the loss, grad_norm and every parameter after
             the update held to TOL_TRAIN_*, the launch counters zeroed
             just before each card step and read just after: 0 launches
             (train mode runs the plain attention and SSD, as the
             reference's; the serve phases above launch K5, K6 and K7);
             (b) the restart drill: ``train()`` on reduced internlm2 with a
             failure at step 6 and checkpoints every 4, its losses bit for
             bit an uninterrupted run's; (c) ``train()`` at internlm2-1.8b's
             full width and depth (bf16 compute, f32 masters, batch 4, seq
             2048, 6 steps, no checkpoints): every loss and grad_norm
             finite, the last loss below the first, 0 launches; the step
             wall (median of steps 2-6), tokens/s, peak memory allocated
             and 6ND model FLOP/s against the bf16 dense peak printed, then
             one more step under torch.profiler (device busy, device ms by
             kernel family, the top kernels).
 10. times   each kernel and its plain version timed with CUDA events at
             the main path's shapes and in the main path's form (K3 on the
             W-row state with the halo wrap folded in), beside its bound on
             this card (K2 also beside its shared-memory bound); K1 and K3
             also at W = 132 and at grain 16384 (K3 also on the
             row-gathered source, the t = 0 launch's form), with the CTAs
             each launch ran (the plan its wrapper handed the launch),
             beside the launch floor and the bound's latency term (the
             FMA's dependent latency, read by a clock-mark probe, x each
             element's chain; derived, under "bounds" in the JSON); K3 at
             the plans' shapes (pair on a W = 2048 stride step, gather at W
             = D = 512) and K4's resident and cooperative forms on a blocked
             fft launch's time-varying tables at W = 512 and 2048 and on
             all_to_all's static (512, 512) table (under "plans_shapes");
             K4's cooperative form on the memory body at the main path's
             memory_bound run (S = 8), beside S x K2's shared-memory bound;
             K4 in all three forms as one full
             launch at S = 2 and S = 8 and as the pipelined phases, and one
             whole pipelined launch with its interior on the same stream
             or a second one, queued and as graph nodes; K5 at internlm2's and hymba's prefill
             shapes and at llama-3.2-vision's cross-attention, and K6 at
             the serving decode warm and L2-cold, beside
             ``scaled_dot_product_attention`` on the same inputs under
             PyTorch's choice of backend and each backend pinned
             (``repro_torch.launch.attention_times``); K7 at the mamba2
             and hymba prefills' chunks in f32 and bf16, beside its bound
             on the units it uses and the f32 FMA bound, with how many
             times it forms each (chunk, group)'s C B^T and its and its
             plain version's error against f64; K8 at mamba2's norm
             shapes warm and L2-cold beside ``rms_norm`` warm and cold
             (``repro_torch.launch.kernel_times``; the yardsticks only:
             the port never calls them).

The last lines are the card's name and power limit, a ``{"kernels": ...}``
JSON line, and ``{"ok": true, "device": ...}``. With no card, or without
the rest of the repository beside it, the script exits non-zero and prints
no result. It imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import itertools
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet, at a 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12  # dense, on the tensor cores

HALO_PATTERNS = ("trivial", "no_comm", "stencil_1d", "stencil_1d_periodic",
                 "dom", "nearest", "random_nearest")
W_MAIN, T_MAIN, PAYLOAD, GRAIN = 2112, 1000, 64, 64
W_WIDE = 65536  # a 16 MiB state
SMS = 132
GRAINS = (1, 4, 16, 64, 256, 1024, 4096, 16384)  # configs/taskbench.py PAPER
# Tolerances, max abs error. K1: the kernel's fmaf and the plain
# multiply-then-add round alike (0.5*x is exact), so only the last bit may
# move. K2, K3 and the backends: sums taken in another order (the sweep's
# mean, the combine's weighted sum with fused multiply-adds), on values in
# [0, 1].
TOL_K1 = 1e-6
TOL = 1e-5
# The T-step memory_bound run accumulates those roundings: the sweep adds
# 1e-6 per pass and the combine averages, so nothing contracts a difference
# away as the FMA body does; allow ~2 ulp of 0.5 per step.
TOL_MEMORY_RUN = T_MAIN * 1.2e-7
S_MAIN = 8  # the blocked main path's steps per launch
T_PROFILED = 6  # steps of the S = 1 run traced in [main], and of the fft run in [plans]
# [plans]: fft and tree at the power of two nearest the main path's width
# (graph validation asks a power of two for them), and the all-gather
# plan's default cap (`schedule.DEFAULT_GATHER_WIDTH_CAP`); the grain-1 runs
# stay inside the contraction horizon (see T_SHARD_SMALL: each step halves a
# row's distance from the FMA's fixed point), each reference held to lie
# SHOWS_MIN or more from it
W_PLAN, W_GATHER, T_PLANS_SHORT = 2048, 512, 7
# The Task Bench kernels the main path launches (K4's resident form runs on
# the all-gather plan's path, [plans], [schedule] and [shards], instead)
TASKBENCH_KERNELS = ("taskbench_compute", "memory_bound", "taskbench_step",
                     "taskbench_blocked", "taskbench_blocked_tiled")
# K4's launch counters by form: the main path's fixed-table compute runs
# take the tiled form, its memory_bound run the cooperative one, and the
# blocked all-gather plan's compute runs (no radius, any table) the
# resident one.
K4_TILED, K4_COOP, K4_RES = ("taskbench_blocked_tiled", "taskbench_blocked",
                             "taskbench_blocked_resident")


def k4_entry(form: str) -> str:
    """The launch counter of K4's ``form`` (tiled, resident, cooperative)."""
    return {"tiled": K4_TILED, "resident": K4_RES, "cooperative": K4_COOP}[form]


def k4_form(memory: bool, allgather: bool) -> str:
    """The K4 counter a pallas_step run's blocked launches count on: the
    cooperative form for the memory body, the resident form on the
    all-gather plan (its launch declares no radius), the tiled form on the
    halo plan."""
    return K4_COOP if memory else K4_RES if allgather else K4_TILED
# K2 at ragged shapes, (rows, payload, scratch): a payload of 3 and of 40
# 16-byte words, a scratch not a multiple of the payload, and the scalar
# path (a payload or a scratch not a multiple of 4).
K2_RAGGED = ((W_MAIN, 12, 2048), (37, 160, 2048), (50, 64, 100), (37, 13, 1001),
             (W_MAIN, 64, 2046))
# The serving cell: internlm2-1.8b at full width, batch 8, prompt 1024,
# 64 generated tokens (63 decode steps), greedy.
SERVE_ARCH, SERVE_B, SERVE_PROMPT, SERVE_GEN = "internlm2-1.8b", 8, 1024, 64
# Attention tolerances (K5, K6 against their plain versions on the same
# inputs). f32: sums in another order (online softmax by tiles against one
# dense softmax; K6's query pre-scaled before the product), on outputs of
# magnitude ~1. bf16: both versions compute in f32 (the same sums in
# another order, TOL_ATTN_F32 apart) and round once to bf16, so each output
# is held to TOL_ATTN_F32 plus one bf16 ulp of its own plain value.
TOL_ATTN_F32 = 2e-5
# m and l of K6 are f32 in both versions: 1e-5 of max(|value|, 1) (l sums
# up to 1088 terms in another order; an empty row's m is -1e30 in both).
TOL_STATS_REL = 1e-5
# [serve]: the kernel path against the plain path, max |difference| over
# max |logit|, prefill and 4 teacher-forced decode steps; bf16 activations
# through 24 layers, where the two attention versions may round an
# output one bf16 ulp apart and the residual stream carries that on. On the
# H100 the sound paths read 1.42-1.63% apart, and a control whose K6
# misses each step's own token read 3.45-10.2% at every decode step.
TOL_SERVE_REL = 0.025
# The SSM serving cells, at full width and depth: mamba2-130m (24 layers,
# d_model 768, 24 SSD heads of 64, state 128), batch 8, prompt 1024, 64
# tokens; hymba-1.5b (32 layers, d_model 1600, 25 query over 5 KV heads,
# window 1024, 50 SSD heads of 64, state 16), batch 4, prompt 1024, 16
# tokens, so that decode positions pass the window.
SSM_ARCH, SSM_B, SSM_PROMPT, SSM_GEN = "mamba2-130m", 8, 1024, 64
HYB_ARCH, HYB_B, HYB_PROMPT, HYB_GEN = "hymba-1.5b", 4, 1024, 16
# [serve-ssm] and [serve-hybrid]: the kernel path against the plain path
# over the prefill and 4 teacher-forced decode steps, as [serve]: max
# |difference| / max |logit| ("max") and ||difference|| / ||logits||
# ("rms"). The SSD runs in f32 there (the conv's f32 bias promotes its
# output), so K7 and its plain version differ by f32 sums in another order;
# bf16 roundings downstream carry that on through the layers, and in hymba
# K5's and K6's bf16 outputs add theirs. On the H100 the sound paths read
# (the same in every run) mamba2 max 1.35-1.60%, rms 0.90-0.93%, hymba max
# 2.42-3.12%, rms 2.74-2.88%; a control whose K7 drops its decay mask L read
# mamba2 max 11.6-15.9%, rms 10.1-16.7%, hymba max 2.72-5.96%, rms
# 3.22-5.64% at every step. Each limit lies between the two.
TOL_SERVE_SSM = {"max": 0.025, "rms": 0.015}
TOL_SERVE_HYB = {"max": 0.035, "rms": 0.031}
# The serving cells of the other layer and input kinds (PERF.md section 4).
# granite-moe-3b-a800m at full width and depth (32 layers, d_model 1536,
# 24/8 heads of 64, 40 experts top-8 of d_ff 512), batch 8, prompt 1024, 64
# tokens: prefill capacity C = 2048 an expert, so capacity_factor 1.25
# drops. llama-3.2-vision-90b at full width cut from 100 layers to one
# block of 4 attn + 1 xattn (90B parameters do not fit 80 GB; 5 layers are
# ~6.4B), batch 4, prompt 1024, 16 tokens; its teacher-forced runs take
# 0.02 N(0, 1) image embeddings and gates of IMAGE_GATE, so that the cross
# term is not 0. musicgen-medium at full width and depth (48 layers, MHA 24
# heads of 64), batch 8, 1024 prompt embeddings, 64 steps. [serve-int8]:
# internlm2-1.8b with kv_quant at [serve]'s shape.
MOE_ARCH, MOE_B, MOE_PROMPT, MOE_GEN = "granite-moe-3b-a800m", 8, 1024, 64
VLM_ARCH, VLM_LAYERS, VLM_B, VLM_PROMPT, VLM_GEN = "llama-3.2-vision-90b", 5, 4, 1024, 16
EMB_ARCH, EMB_B, EMB_PROMPT, EMB_GEN = "musicgen-medium", 8, 1024, 64
IMAGE_SEED, IMAGE_GATE = 5, 1.0
# [serve-archs]: one serve each at batch 4, prompt 1024, 16 tokens; mixtral-8x7b
# at full width with 2 of its 32 layers (~3.2B parameters; 47B do not fit)
ARCHS_SERVED = ("gemma3-4b", "minitron-8b", "stablelm-3b", "mixtral-8x7b")
ARCHS_LAYERS = {"mixtral-8x7b": 2}
ARCHS_B, ARCHS_PROMPT, ARCHS_GEN = 4, 1024, 16
# The self-attention shapes the new serving paths give K5 and K6 (arch,
# batch, prompt, generated tokens), held to their plain versions in
# [parity]; [serve]'s and [serve-hybrid]'s are held there already
SERVED_ATTN = ((MOE_ARCH, MOE_B, MOE_PROMPT, MOE_GEN),
               (VLM_ARCH, VLM_B, VLM_PROMPT, VLM_GEN),
               (EMB_ARCH, EMB_B, EMB_PROMPT, EMB_GEN),
               *((arch, ARCHS_B, ARCHS_PROMPT, ARCHS_GEN) for arch in ARCHS_SERVED))
# The new paths' kernel-vs-plain limits, as TOL_SERVE_*: max |diff| / max
# |logit| ("max") and ||diff|| / ||logits|| ("rms") over the prefill and 4
# teacher-forced decode steps. Readings on an H100 80GB HBM3 at 700 W
# (sound path; a control from benchmarks/torch_serve_controls.py, broken on
# the kernel path only; a K6 that misses each step's own token leaves the
# prefill as it is, so its readings are the decode steps'); the readings
# repeat to the last digit from run to run:
# - [serve-moe], the plain path replaying the kernel path's routing: sound
#   max 0.98-1.17%, rms 1.05-1.10%; the K6 control max 1.30-1.53%, rms
#   1.24-1.31% in the decode steps; a combine weighting each expert 1/K
#   max 22.4-26.5%, rms 22.5-23.9% at every step.
# - [serve-xattn] (f32 image K/V): sound max 0.87-1.22%, rms 0.92-1.03%;
#   K6 control max 4.56-17.2%, rms 3.95-12.1%.
# - [serve-embed]: sound max 1.74-2.16%, rms 1.96-2.08%; K6 control max
#   4.04-6.84%, rms 3.51-4.27%.
# - [serve-int8]: sound max 1.39-1.73%, rms 1.58-1.61%; K6 control max
#   3.38-10.6%, rms 3.39-5.39%.
# Each limit lies between the two.
# [train]: (a) one train step on the card against the same step on the CPU
# (one weight set, f32) on reduced internlm2, granite-moe and hymba, at
# accum 1 and 2, batch TRAIN_B x TRAIN_S; the optimizer takes lr 1e-2 and
# eps 1e-3 there (TRAIN_OPT), so each element's update is smooth in its
# gradient (Adam's first step is lr g / (|g| + eps)); the loss and
# grad_norm within TOL_TRAIN_REL, every parameter after the update within
# TOL_TRAIN_PARAM (the CPU tests hold the CPU step to the JAX package's at
# 1e-4 as well). (b) the restart drill: train() on reduced internlm2 with a
# failure at TRAIN_FAIL_AT, checkpoints every TRAIN_CKPT_EVERY, its losses
# bit for bit an uninterrupted run's. (c) train() itself at internlm2-1.8b's
# full width and depth, bf16 compute, f32 masters: batch TRAIN_FULL_B, seq
# TRAIN_FULL_S, TRAIN_FULL_STEPS steps.
TRAIN_ARCHS = ("internlm2-1.8b", "granite-moe-3b-a800m", "hymba-1.5b")
TRAIN_B, TRAIN_S = 4, 64
TRAIN_OPT = dict(lr=1e-2, eps=1e-3, warmup_steps=1)
TOL_TRAIN_REL, TOL_TRAIN_PARAM = 1e-4, 1e-4
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 8, 4, 6
TRAIN_FULL_ARCH, TRAIN_FULL_B, TRAIN_FULL_S, TRAIN_FULL_STEPS = "internlm2-1.8b", 4, 2048, 6
TOL_SERVE_MOE = {"max": 0.0125, "rms": 0.0118}
TOL_SERVE_VLM = {"max": 0.025, "rms": 0.02}
TOL_SERVE_EMBED = {"max": 0.03, "rms": 0.028}
TOL_SERVE_INT8 = {"max": 0.025, "rms": 0.025}
# K7 and K8 against their plain versions: both compute in f32 precision
# (K7's TF32 tensor-core products with each f32 operand split into TF32
# parts, its C B^T and K8 in f32 FMAs, against einsums and reductions:
# the same sums in another order), so an output is held to TOL_F32_SCALED
# of the output's scale, max(1, max |plain|); a bf16 output is rounded once
# from those sums, so it also gets one bf16 ulp of its own plain value. A
# K7 that rounds each operand to TF32 once (no residual products) fails it
# (PERF.md §6).
TOL_F32_SCALED = 2e-5
BLOCKED_RUNS = (("pipelined", {}), ("serial", {"pipeline": False}))
# [ensemble]: K = 4 stacked stencil_1d members at the main path's shape
# (seeds 0-3), their mixed horizons at S = 8, and where the launch plan
# evicts member 1 (from launch EVICT_AT: it stops at T = 1 + EVICT_AT * S)
# and admits a fresh member into the finished slot 3 (at launch ADMIT_AT)
K_ENS, HETERO_T, EVICT_AT, ADMIT_AT = 4, (1000, 750, 333, 1), 40, 60
# and at grain 1, where the dataflow shows: mixed horizons inside the
# contraction horizon (see T_SHARD_SMALL), at a depth that still spans
# several launches (3, 3, 2 and 0 at S = 2); the launch plan's edits at
# launches 1 and 2
T_ENS_SHORT, S_ENS_SHORT = (7, 6, 4, 1), 2
# [schedule]: the depth "auto" resolves the main path's compute runs to under
# the card's measured model (the deepest of schedule.CANDIDATES whose K4
# launch takes the tiled form, serial since X = 1), and the explicit depths
# its step walls are timed beside; the spin (SM cycles, ~10 ms) queued ahead
# of each timed launch-plan launch, under which the host issues it
S_AUTO_MAIN, S_WALLS = 16, (1, 8, 16)
LAUNCH_SPIN_CYCLES = 20_000_000
# [rungs]: serialized at the QUICK preset's T (the main path's T x W = 2.1 M
# tasks is over its MAX_TASKS) and W = one task an SM, and its K = 4
# ensemble's mixed horizons
T_SER, T_SER_ENS = 50, (50, 40, 20, 1)
# [rungs] at grain 1, where the dataflow shows (grain 64 puts every state at
# the FMA's fixed point within a step): the width of the runs held to the
# CPU plain path, and the (pattern, T) an ensemble's members are taken from,
# the first four a rung runs (overlap: the halo patterns)
W_SMALL = 64
ENS_SHORT = (("stencil_1d", 8), ("spread", 6), ("fft", 4), ("nearest", 1), ("dom", 5),
             ("random_nearest", 3))
# [rungs]' profiled runs: issues in one profiling window, the last one read
PROFILE_ISSUES = 3


# [shards]: the port over D row shards of one card (``devices=["cuda"] * D``):
# the main shape at D = 4 (B = 528) and D = 2, at T_SHARD and T_SHARD_D2
# steps (the time limit: [shards] took 388-557 s of the script's 935-1232 s
# at T = 1000 on an H100 80GB HBM3 at 700 W; the step walls are per step); every halo pattern runs bsp,
# bsp_scan, overlap (overlap=True and False, halo_via="allgather") and
# pallas_step S = 1 and S = 8 (pipelined, serial, halo_impl "xla" and
# "ppermute") and "auto"; the main schedules at D = 1 on stencil_1d for the
# step walls; the grain-1 evidence at W = 64, T = T_SHARD_SMALL (fft and
# spread at W_GATHER); multi-hop at W = 16, r = 2, S = S_SHARD_HOP; the
# profiled overlap runs of T_PROFILED steps. Each run is compared with its
# eager loop three times (the three timed replays): a race between streams
# or in the allocator gives wrong bits only sometimes.
SHARD_D = (4, 2)
T_SHARD = T_SHARD_D2 = 250
# The grain-1 evidence stays inside the contraction horizon: each step
# halves a row's distance from the FMA's fixed point 0.2 (every combine is
# convex), so after T steps the state is within 0.8 * 2**-T of it, and a
# wrong partner, row cut or stale read shows only while that is well above
# TOL. T = 7 = log2(64) + 1 keeps a butterfly's rows from all reaching the
# mean too, and leaves every case at least 3e-3 from the fixed point; the
# phase fails a case whose reference is within SHOWS_MIN of it. The K = 4
# stacked ensemble's horizons, and the multi-hop depth (r * S = 6 > B = 4
# at T = 2 S + 1), are cut to the same horizon.
W_SHARD_SMALL, T_SHARD_SMALL = 64, 7
T_SHARD_ENS = (7, 6, 4, 1)
S_SHARD_HOP = 3
FIXED_POINT = 0.1 / (1 - 0.5)  # bodies.cuh: x <- 0.5 x + 0.1
SHOWS_MIN = 100 * 1e-5  # 100 x TOL
# [shards]' stride and all-gather plans: fft and tree at W_PLAN (the stride
# plan under both halo transports), fft at W_GATHER with S = 8 (the re-route
# to the blocked all-gather plan), spread and all_to_all at W_GATHER at S = 1
# and 8 under each gather transport (all_to_all also with psum_mean=False),
# and "auto" under the D = 4 model, at D = 4; fft at W_PLAN and spread at
# W_GATHER at D = 2; each run against its D = 1 run. T_SHARD_PLANS steps
# each at D = 4 (the sharded main shape's T), T_SHARD_D2 at D = 2.
T_SHARD_PLANS = T_SHARD
GATHER_TRANSPORTS = ("xla", "ppermute", "chunked")


def _measure(intervals):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _intersection(xs, ys):
    """Length of union(xs) intersected with union(ys)."""
    return _measure(xs) + _measure(ys) - _measure(list(xs) + list(ys))


def shards_phase(dev, rand, smi, counted_calls, *, W=W_MAIN, T=T_MAIN, W_small=W_SHARD_SMALL,
                 T_small=T_SHARD_SMALL, W_glob=W_GATHER, T_prof=T_PROFILED, T_d2=T_SHARD_D2,
                 issues=PROFILE_ISSUES, W_plan=W_PLAN, T_plans=T_SHARD_PLANS):
    """The [shards] phase; returns the launches its runs counted (the eager
    loops' and the references' apart) and its record."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import GraphEnsemble, KernelSpec, TaskGraph, get_runtime
    from repro_torch.core.runtimes._capture import GraphRun, ReplayLoop, ShardedRun, time_runs
    from repro_torch.kernels import _build, ops, probes

    t0 = time.perf_counter()
    card = dev.type == "cuda"
    # the probe: one exchange between 4 shards per transport (halo and
    # stride), the gather per width and per (transport, D, width), and the
    # model; its K3 launches come before the counters' reset, apart from the
    # runs'
    tp = time.perf_counter()
    model = probes.run_probes(devices=4, payload=PAYLOAD, device=dev)
    probe = {"halo_exchange_us": model.halo_exchange_us, "row_step_us": model.row_step_us,
             "X": model.exchange_row_steps, "stride_exchange_us": model.stride_exchange_us,
             "gather_us": model.gather_us, "gather_impl_us": model.gather_impl_us,
             "seconds": time.perf_counter() - tp, "describe": model.describe()}
    print(f"[shards] probe_halo_exchange_us(4): {model.halo_exchange_us} -> X = "
          f"{model.exchange_row_steps:.3f} row-steps ({model.describe()}) | {smi}", flush=True)
    print(f"[shards] probe_stride_exchange_us(4): {model.stride_exchange_us}; "
          f"probe_gather_us(4): {model.gather_us}; probe_gather_impl_us(4): "
          f"{model.gather_impl_us} (median of {probes.GATHER_IMPL_REPS} replays); "
          f"{probe['seconds']:.3f} s | {smi}", flush=True)
    if card:
        torch.cuda.synchronize()
    ops.reset_launch_counts()
    apart = dict.fromkeys(_build.ENTRIES, 0)
    apart_calls = [0]
    rows, refused, bitwise = [], {}, []
    compared = [0]  # sharded outputs compared bit for bit with an eager loop
    shows_dist = []  # the grain-1 references' distances from the fixed point
    expected = dict.fromkeys(_build.ENTRIES, 0)  # the launches the sharded runs make

    def keep_apart(d, calls):
        for k, n in d.items():
            apart[k] += n
        apart_calls[0] += calls

    def sync():
        if card:
            torch.cuda.synchronize()

    def runtime(name, D, opts, devices=None):
        kw = dict(opts) if name == "pallas_step" else dict(opts, use_kernels=True)
        return get_runtime(name, devices=devices or [dev] * D, **kw)

    def reference(g, init):
        """fused(use_kernels=True)'s run on one device, its launches apart."""
        run = get_runtime("fused", device=dev, use_kernels=True).build(g)
        out, d, h = counted_calls(lambda: run(init))
        keep_apart(d, h)
        return out.cpu()

    def want_launches(rt, g):
        """The kernel launches of one run over every shard: K3 and K4 from
        ``dispatches_per_run`` (one shard's count) times D; the rungs' K1/K2
        from ``body_launches_per_run`` (every shard's)."""
        D = rt.num_devices
        want = dict.fromkeys(_build.ENTRIES, 0)
        if rt.name == "pallas_step":
            per = rt.dispatches_per_run(g)
            plan = rt._schedule_for_graph(g)
            if plan.steps_per_launch == 1:
                want["taskbench_step"] = D * per
            else:  # the halo plan tiled, the all-gather plan resident, the
                # memory body cooperative
                want["taskbench_step"] = D
                want[k4_form(g.kernel.kind == "memory_bound",
                             plan.kind == "allgather")] = D * (per - 1)
        else:
            body = "taskbench_compute" if g.kernel.kind == "compute_bound" else "memory_bound"
            want[body] = rt.body_launches_per_run(g)
        return want

    def dataflow_shows(label, want):
        shows_dist.append(dataflow_distance("shards", label, want))

    def run_once(label, rt, g, init, want, tol, reps=3):
        """``rt``'s run of ``g``: built (D > 1: a ShardedRun over one graph,
        or bsp's graph a superstep), run once with the counters read around
        it, equal bit for bit to its eager loop, its launches D times the
        per-shard count and its host calls ``host_calls_per_run``, held to
        ``want`` within ``tol``, timed (best of ``reps``), and each timed
        run's output again equal bit for bit to the eager loop's."""
        D = rt.num_devices
        tb = time.perf_counter()
        run = rt.build(g)
        sync()
        build_s = time.perf_counter() - tb
        inner = run.inner if isinstance(run, ShardedRun) else run
        if card and (isinstance(run, ShardedRun) != (D > 1) or not isinstance(
                inner, ReplayLoop if rt.name == "bsp" else GraphRun)):
            fail(f"[shards] {label}: build gave {type(run).__name__} over "
                 f"{type(inner).__name__}")
        out, d, calls = counted_calls(lambda: run(init))
        eager = getattr(run, "eager", run)
        again, d_eager, h_eager = counted_calls(lambda: eager(init.clone()))
        keep_apart(d_eager, h_eager)
        if not torch.equal(out, again):
            fail(f"[shards] {label}: the run differs from its eager loop, max |difference| "
                 f"{(out - again).abs().max().item()}")
        wd = want_launches(rt, g)
        if d != wd or d_eager != d:
            fail(f"[shards] {label}: launches {d} (eager loop {d_eager}), expected {wd}")
        if calls != rt.host_calls_per_run(g):
            fail(f"[shards] {label}: {calls} host calls, host_calls_per_run "
                 f"{rt.host_calls_per_run(g)}")
        err = check_close(f"[shards] {label}", out.cpu(), want, tol)
        timed = []
        walls = time_runs(run, init, reps=reps, outputs=timed)
        for k, n in wd.items():  # the counted run, time_runs' warm-up and timed runs
            expected[k] += n * (2 + reps)
        for i, o in enumerate(timed):
            if not torch.equal(o, again):
                fail(f"[shards] {label}: timed run {i} differs from the eager loop, max "
                     f"|difference| {(o - again).abs().max().item()}")
        compared[0] += 1 + len(timed)
        rows.append({"run": label, "runtime": rt.name, "D": D, "pattern": g.pattern,
                     "plan": (list(rt._schedule_for_graph(g)) if rt.name == "pallas_step"
                              else None),
                     "W": g.width, "T": g.steps, "kind": g.kernel.kind,
                     "grain": g.kernel.iterations, "us_per_step": min(walls) / g.steps * 1e6,
                     "launches": {k: n for k, n in d.items() if n}, "host_calls": calls,
                     "dispatches_per_run": rt.dispatches_per_run(g),
                     "nodes": getattr(inner, "nodes", None), "build_s": build_s,
                     "max_abs_err": err})
        return out.cpu()

    main_runs = (("bsp_scan", {}), ("overlap", {}), ("pallas_step", {}),
                 ("pallas_step", {"steps_per_launch": S_MAIN}),
                 ("pallas_step", {"steps_per_launch": S_MAIN, "pipeline": False}))
    full_runs = (("bsp", {}), ("overlap", {"overlap": False}),
                 ("overlap", {"halo_via": "allgather"}),
                 ("pallas_step", {"steps_per_launch": S_MAIN, "halo_impl": "ppermute"}),
                 ("pallas_step", {"steps_per_launch": "auto", "cost_model": model}))
    for pattern in HALO_PATTERNS:
        init = rand(W, PAYLOAD)
        for D in SHARD_D:
            g = TaskGraph(steps=T if D == SHARD_D[0] else T_d2, width=W, pattern=pattern,
                          payload=PAYLOAD, kernel=KernelSpec("compute_bound", GRAIN), radius=2,
                          seed=0)
            want = reference(g, init)
            outs = {}
            for name, opts in main_runs + full_runs:
                rt = runtime(name, D, opts)
                ok, why = rt.supports(g)
                if not ok:
                    refused[f"{pattern} D={D} {name}"] = why
                    continue
                tag = {k: v for k, v in opts.items() if k != "cost_model"}
                outs[(name, str(tag))] = run_once(f"{pattern} D={D} {name}{tag or ''}", rt, g,
                                                  init, want, TOL)
            blocked = [v for (n, o), v in outs.items() if "steps_per_launch': 8" in o]
            if any(not torch.equal(blocked[0], b) for b in blocked[1:]):
                fail(f"[shards] {pattern} D={D}: S = 8 pipelined, serial and halo_impl runs "
                     f"differ")
            bitwise.append(f"{pattern} D={D} S=8 x{len(blocked)}")
        if pattern == "stencil_1d":  # the step walls at D = 1
            g = TaskGraph(steps=T, width=W, pattern=pattern, payload=PAYLOAD,
                          kernel=KernelSpec("compute_bound", GRAIN), radius=2, seed=0)
            want = reference(g, init)
            for name, opts in main_runs:
                run_once(f"{pattern} D=1 {name}{opts or ''}", runtime(name, 1, opts, [dev]), g,
                         init, want, TOL)
    g = TaskGraph(steps=T, width=W, pattern="stencil_1d", payload=PAYLOAD,
                  kernel=KernelSpec("memory_bound", 4, scratch=2048), seed=0)
    init = rand(W, PAYLOAD)
    want = reference(g, init)
    for name, opts in (("bsp_scan", {}), ("overlap", {}), ("pallas_step", {}),
                       ("pallas_step", {"steps_per_launch": S_MAIN})):
        # S = 8: the memory body takes K4's cooperative form, D grids at once
        run_once(f"memory_bound D=4 {name}{opts or ''}", runtime(name, 4, opts), g, init, want,
                 TOL_MEMORY_RUN)

    # the stride and all-gather plans (T_SHARD_PLANS): each run bit for bit
    # its D = 1 run of the same plan (all_to_all's psum_mean row mean sums
    # the shards' partial sums, another order: within TOL), and the gather
    # transports bit for bit each other
    plan_groups, plan_walls, autos = {}, [], []
    inputs = {}  # (pattern, W, T) -> the init and fused(kernels)' run
    ones = {}  # (pattern, W, T, plan, S, psum_mean) -> the D = 1 run's output and wall

    def plan_run(pattern, width, D, opts, steps):
        g = TaskGraph(steps=steps, width=width, pattern=pattern, payload=PAYLOAD,
                      kernel=KernelSpec("compute_bound", GRAIN), seed=0)
        if (pattern, width, steps) not in inputs:
            init = rand(width, PAYLOAD)
            inputs[(pattern, width, steps)] = (init, reference(g, init))
        init, want = inputs[(pattern, width, steps)]
        tag = {k: v for k, v in opts.items() if k != "cost_model"}
        rt = runtime("pallas_step", D, opts)
        plan = rt._schedule_for_graph(g)
        out = run_once(f"{pattern} W={width} D={D} pallas_step{tag}", rt, g, init, want, TOL)
        us = rows[-1]["us_per_step"]
        S = plan.steps_per_launch
        psum = (pattern == "all_to_all" and opts.get("psum_mean", True) and S == 1)
        key = (pattern, width, steps, plan.kind, S, opts.get("psum_mean", True))
        if key not in ones:
            one_opts = {k: v for k, v in opts.items()
                        if k not in ("halo_impl", "gather_impl", "cost_model")}
            one_opts["steps_per_launch"] = S
            ones[key] = (run_once(f"{pattern} W={width} D=1 pallas_step{one_opts}",
                                  runtime("pallas_step", 1, one_opts, [dev]), g, init, want,
                                  TOL), rows[-1]["us_per_step"])
        one, one_us = ones[key]
        if psum:
            check_close(f"[shards] {pattern} W={width} D={D}{tag} against D = 1", out, one, TOL)
        elif not torch.equal(out, one):
            fail(f"[shards] {pattern} W={width} D={D}{tag}: differs from its D = 1 run, max "
                 f"|difference| {(out - one).abs().max().item()}")
        plan_groups.setdefault((pattern, width, D, plan.kind, S, psum), []).append((tag, out))
        plan_walls.append({"run": f"{pattern} W={width} D={D}{tag}", "plan": [plan.kind, S],
                           "us_per_step": us, "d1_us_per_step": one_us})
        return plan

    for pattern in ("fft", "tree"):
        for impl in ("xla", "ppermute"):
            plan_run(pattern, W_plan, 4, {"halo_impl": impl}, T_plans)
    plan_run("fft", W_glob, 4, {"steps_per_launch": S_MAIN}, T_plans)
    for pattern, extra in (("spread", {}), ("all_to_all", {}),
                           ("all_to_all", {"psum_mean": False})):
        for S in ((1,) if extra else (1, S_MAIN)):
            for impl in GATHER_TRANSPORTS:
                plan_run(pattern, W_glob, 4, dict(extra, steps_per_launch=S, gather_impl=impl),
                         T_plans)
    plan_run("fft", W_plan, 2, {}, T_d2)
    plan_run("spread", W_glob, 2, {}, T_d2)
    for pattern, width in (("fft", W_plan), ("spread", W_glob)):
        plan = plan_run(pattern, width, 4, {"steps_per_launch": "auto", "cost_model": model},
                        T_plans)
        autos.append({"pattern": pattern, "W": width, "plan": list(plan)})
        print(f"[shards] auto on {pattern} W={width} D=4 under the D = 4 model: "
              f"({plan.kind}, S={plan.steps_per_launch}): {plan.reason}", flush=True)
    for key, outs in plan_groups.items():
        if any(not torch.equal(outs[0][1], o) for _, o in outs[1:]):
            fail(f"[shards] {key}: the transports {[t for t, _ in outs]} differ")
        if len(outs) > 1:
            bitwise.append(f"{key} x{len(outs)}")
    for row in plan_walls:
        print(f"[shards] plans: {row['run']} {row['plan']}: {row['us_per_step']:.3f} us a step "
              f"(D = 1: {row['d1_us_per_step']:.3f})", flush=True)

    # grain 1, where the dataflow shows: against the CPU plain path at D = 1
    cpu = get_runtime("fused", device="cpu")
    small = (("bsp", {}), ("bsp_scan", {}), ("overlap", {}), ("overlap", {"overlap": False}),
             ("overlap", {"halo_via": "allgather"}), ("pallas_step", {}),
             ("pallas_step", {"steps_per_launch": 2}),
             ("pallas_step", {"steps_per_launch": 2, "pipeline": False}),
             ("pallas_step", {"steps_per_launch": 3, "halo_impl": "ppermute"}),
             ("pallas_step", {"steps_per_launch": 3, "pipeline": False}))
    # the stride and all-gather plans also under their other transports
    small_plans = (("pallas_step", {"halo_impl": "ppermute"}),
                   ("pallas_step", {"gather_impl": "chunked"}))
    n_small = 0
    cases = [(p, W_small, 2) for p in HALO_PATTERNS] + [
        (p, W_small, 2) for p in ("fft", "tree", "all_to_all", "spread")] + [
        (p, W_glob, 2) for p in ("fft", "spread")] + [("nearest", 16, 2)]
    for pattern, width, r in cases:
        steps = 2 * S_SHARD_HOP + 1 if width == 16 else T_small
        g = TaskGraph(steps=steps, width=width, pattern=pattern, payload=PAYLOAD,
                      kernel=KernelSpec("compute_bound", 1), radius=r, seed=1)
        init = rand(width, PAYLOAD)
        want = torch.from_numpy(cpu.execute(g, init.cpu()))
        dataflow_shows(f"grain 1 {pattern} W={width} T={steps}", want)
        runs = (("pallas_step", {"steps_per_launch": S_SHARD_HOP}),) if width == 16 else small
        if pattern not in HALO_PATTERNS:
            runs = runs + small_plans + ((("pallas_step", {"psum_mean": False}),)
                                         if pattern == "all_to_all" else ())
        outs = {}
        for name, opts in runs:
            rt = runtime(name, 4, opts)
            if not rt.supports(g)[0]:
                continue
            outs[str(opts)] = run_once(f"grain 1 {pattern} W={width} D=4 {name}{opts or ''}",
                                       rt, g, init, want, TOL)
            n_small += 1
        for S in (2, 3):
            piped = [v for o, v in outs.items() if f"'steps_per_launch': {S}" in o]
            if len(piped) == 2 and not torch.equal(*piped):
                fail(f"[shards] grain 1 {pattern}: S = {S} pipelined != serial")
    # K = 4 ensembles of mixed patterns and horizons at grain 1, each member
    # against the CPU plain path's run of it alone; one stacked pallas_step
    # ensemble (stencil_1d, horizons T_SHARD_ENS)
    ens_rows = []
    mixed = (("stencil_1d", 8), ("spread", 6), ("fft", 4), ("nearest", 1), ("dom", 5),
             ("random_nearest", 3))
    stacked = [TaskGraph(steps=t, width=W_small, pattern="stencil_1d", payload=PAYLOAD,
                         kernel=KernelSpec("compute_bound", 1), seed=20 + k)
               for k, t in enumerate(T_SHARD_ENS)]
    for name, opts in (("bsp", {}), ("bsp_scan", {}), ("overlap", {}), ("pallas_step", {}),
                       ("pallas_step", {"steps_per_launch": S_MAIN})):
        rt = runtime(name, 4, opts)
        if name == "pallas_step":
            members = stacked
        else:
            members = [TaskGraph(steps=t, width=W_small, pattern=p, payload=PAYLOAD, radius=2,
                                 kernel=KernelSpec("compute_bound", 1), seed=10 + k)
                       for k, (p, t) in enumerate(mixed)]
            members = [g for g in members if rt.supports(g)[0]][:4]
        ens = GraphEnsemble(members)
        xs = tuple(rand(W_small, PAYLOAD) for _ in members)
        run = rt.build_ensemble(ens)
        outs, d, calls = counted_calls(lambda: run(xs))
        again, d_eager, h_eager = counted_calls(
            lambda: getattr(run, "eager", run)(tuple(x.clone() for x in xs)))
        keep_apart(d_eager, h_eager)
        if name == "pallas_step":
            want_n = 4 * rt.ensemble_dispatches_per_run(ens)
        else:
            want_n = rt.body_launches_per_run(ens)
        if sum(d.values()) != want_n or d_eager != d:
            fail(f"[shards] K=4 {name}{opts}: launches {d}, expected {want_n}")
        if calls != rt.host_calls_per_run(ens):
            fail(f"[shards] K=4 {name}: {calls} host calls")
        errs = []
        for i, run_i in enumerate([outs] + [run(xs) for _ in range(2)]):
            for k, (a, b) in enumerate(zip(run_i, again)):
                if not torch.equal(a, b):
                    fail(f"[shards] K=4 {name} member {k}: run {i} differs from its eager "
                         f"loop")
            compared[0] += 1
        for k, n in d.items():
            expected[k] += 3 * n
        for k, (a, g, x) in enumerate(zip(outs, members, xs)):
            want_k = torch.from_numpy(cpu.execute(g, x.cpu()))
            dataflow_shows(f"K=4 {name}{opts} member {k} T={g.steps}", want_k)
            errs.append(check_close(f"[shards] K=4 {name}{opts} member {k}", a.cpu(), want_k,
                                    TOL))
        ens_rows.append({"run": f"K=4 {name}{opts or ''}", "patterns": [g.pattern for g in members],
                         "T": [g.steps for g in members], "launches": sum(d.values()),
                         "host_calls": calls, "max_abs_err": max(errs)})

    # ensembles across the row shards (`shard_ensembles`), at T_d2 steps for
    # the time limit: its launches, those it kept apart and its comparisons
    # join the phase's
    part = shard_ensembles(dev, rand, smi, counted_calls, model, W=W, T=T_d2, W_small=W_small,
                           W_glob=W_glob, W_plan=W_plan)
    for k in expected:
        expected[k] += part["expected"][k]
        apart[k] += part["apart"][k]
    apart_calls[0] += part["apart_calls"]
    compared[0] += part["compared"]
    shows_dist.extend(part["shows_dist"])

    # the overlap, measured: T_prof-step runs at the main shape, D = 4 and
    # 2, replayed `issues` times in one profiling window behind a marker
    # kernel; the events after the last marker are one replay's. The
    # transfers are the graph's copy nodes ("ppermute": device-to-device
    # copies); every other kernel is compute, and a replay does not say
    # which shard ran a node. overlap=True must overlap its transfers with
    # compute. overlap=False joins a shard's transfers before its compute,
    # and a shard waits on its ring neighbours' transfers only: at D = 2
    # every shard is every other's neighbour, so nothing may overlap a
    # transfer there (0 us, the check that can fail); at D = 4 shard d's
    # compute may run under shard d + 2's copies, which is printed.
    overlap_rows = {}
    profiled = (("overlap", {}, 4), ("overlap", {"overlap": False}, 4),
                ("overlap", {}, 2), ("overlap", {"overlap": False}, 2),
                ("pallas_step", {"steps_per_launch": S_MAIN, "halo_impl": "ppermute"}, 4))
    for name, opts, D in profiled:
        steps = 1 + 2 * S_MAIN if name == "pallas_step" else T_prof
        g = TaskGraph(steps=steps, width=W, pattern="nearest", payload=PAYLOAD,
                      kernel=KernelSpec("compute_bound", GRAIN), radius=2, seed=0)
        rt = runtime(name, D, opts)
        run = rt.build(g)
        init = rand(W, PAYLOAD)
        keep_apart(*counted_calls(lambda: run(init))[1:])  # a warm replay
        if not card:
            continue
        run.stage(init)
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(issues):
                torch.cuda._sleep(1000)  # the marker
                _, d, calls = counted_calls(run.inner.graphed.replay)
                keep_apart(d, calls)
            sync()
        events = sorted((e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3, e.name())
                        for e in prof.profiler.kineto_results.events()
                        if e.device_type() == torch.autograd.DeviceType.CUDA)
        marks = [i for i, (_, _, n) in enumerate(events)
                 if "spin_kernel" in n or "sleep" in n.lower()]
        if not marks:
            fail("[shards] the profiler recorded no marker kernel")
        mine = events[marks[-1] + 1:]
        copies = [(a, b) for a, b, n in mine if "memcpy" in n.lower()]
        compute = [(a, b) for a, b, n in mine if "memcpy" not in n.lower()]
        first = min(a for a, _, _ in mine)
        during = [(round(a - first, 3), round(b - first, 3), n[:40]) for a, b, n in mine
                  if "memcpy" not in n.lower() and any(a < y and b > x for x, y in copies)]
        ov = _intersection(copies, compute)
        key = f"{name}{opts} D={D}"
        # the device span from the first transfer to the last kernel holds
        # the T - 1 combine steps (the t = 0 body before it is left out);
        # the busy time is the union of every node's interval in it
        span = max(b for _, b, _ in mine) - min(copies)[0] if copies else 0.0
        busy = _measure([(a, b) for a, b, _ in mine if copies and a >= min(copies)[0]])
        overlap_rows[key] = {
            "D": D, "steps": steps, "transfers": len(copies), "kernels": len(compute),
            "transfer_us": _measure(copies), "overlap_us": ov,
            "overlap_us_per_step": ov / (steps - 1),
            "device_us": span, "device_us_per_step": span / (steps - 1),
            "busy_us": busy, "busy_us_per_step": busy / (steps - 1),
            "kernel_us": sum(b - a for a, b in compute),
            "transfer_intervals": [(round(a - first, 3), round(b - first, 3)) for a, b in copies],
            "compute_during_transfers": during[:24]}
        print(f"[shards] profiled {key} (W={W}, {steps} steps): {len(copies)} transfers "
              f"({_measure(copies):.3f} us), {len(compute)} compute kernels, overlapping the "
              f"transfers by {ov:.3f} us ({ov / (steps - 1):.3f} a step); device "
              f"{span:.3f} us from the first transfer ({span / (steps - 1):.3f} a step), busy "
              f"{busy:.3f} us ({busy / (steps - 1):.3f} a step); first "
              f"transfers {overlap_rows[key]['transfer_intervals'][:8]}, compute during them "
              f"{during[:6]} | {smi}", flush=True)
        if not copies:
            fail(f"[shards] profiled {key}: no transfer seen")
        if opts.get("overlap") is False and D == 2 and ov != 0.0:
            fail(f"[shards] overlap=False, D = 2: the transfers overlap compute by "
                 f"{ov:.3f} us")
        if opts.get("overlap") is not False and ov <= 0.0:
            fail(f"[shards] {key}: the transfers overlap no compute")

    # distinct cards: the same code over cuda:0..n-1, where there are two
    n_cards = torch.cuda.device_count() if card else 0
    distinct = "not run: one card (torch.cuda.device_count() = %d)" % n_cards
    if n_cards >= 2:
        cards = [torch.device("cuda", i) for i in range(min(4, n_cards))]
        g = TaskGraph(steps=T_small, width=W_small, pattern="nearest", payload=PAYLOAD,
                      kernel=KernelSpec("compute_bound", 1), radius=2, seed=1)
        init = rand(W_small, PAYLOAD)
        want = torch.from_numpy(cpu.execute(g, init.cpu()))
        dataflow_shows(f"nearest across {len(cards)} cards", want)
        for name, opts in (("bsp_scan", {}), ("pallas_step", {})):
            rt = runtime(name, len(cards), opts, cards)
            out, d, _ = counted_calls(lambda: rt.build(g)(init))
            for k, n in d.items():
                expected[k] += n
            check_close(f"[shards] {name} across {len(cards)} cards", out.cpu(), want, TOL)
        distinct = f"bsp_scan and pallas_step across {len(cards)} cards within TOL of D = 1"
    print(f"[shards] distinct cards: {distinct}", flush=True)

    sync()
    total = ops.launch_counts()
    launches = {k: n - apart[k] for k, n in total.items()}
    for k in ("taskbench_compute", "memory_bound", "taskbench_step", K4_TILED, K4_COOP,
              K4_RES):
        if launches[k] == 0:
            fail(f"[shards] kernel {k}: no launch on the sharded runs")
    if launches != expected:
        fail(f"[shards] launches {launches} differ from the sharded runs' own {expected}")
    for row in rows:
        print(f"  {row['run']} W={row['W']} T={row['T']} {row['kind']} grain {row['grain']}: "
              f"{row['us_per_step']:.3f} us a step; launches {row['launches']}, "
              f"{row['host_calls']} host calls, {row['dispatches_per_run']} per shard; "
              f"{row['nodes']} nodes, built in {row['build_s']:.3f} s; max |err| "
              f"{row['max_abs_err']:.3g}")
    for row in ens_rows:
        print(f"  {row['run']} {row['patterns']} T={row['T']}: {row['launches']} launches, "
              f"{row['host_calls']} host calls, max |err| {row['max_abs_err']:.3g}")
    shows = [r for r in rows if r["grain"] == 1 or r["kind"] == "memory_bound"]
    print(f"[shards] refused: {refused}", flush=True)
    print(f"[shards] {len(rows)} sharded runs ({len(rows) - len(shows)} at grain {GRAIN}: "
          f"counts, graphs and bits only, the plans' D = 1 and transport comparisons "
          f"included, every state at the fixed point; {len(shows)} where the dataflow shows: "
          f"grain 1 against the CPU plain path ({n_small}; every reference at least "
          f"{min(shows_dist):.3g} from the fixed point), memory_bound against "
          f"fused(kernels)) and "
          f"{len(ens_rows)} K=4 ensembles and {len(part['record']['runs'])} ensembles across "
          f"the shards, each equal to its eager loop bit for bit three times "
          f"({compared[0]} comparisons), launches "
          f"D x the per-shard count, host calls as counted; pipelined = serial = ppermute bit "
          f"for bit ({len(bitwise)} groups); launches {launches} (and {apart}, "
          f"{apart_calls[0]} host calls, apart); {time.perf_counter() - t0:.3f} s | {smi}",
          flush=True)
    record = {"runs": rows, "ensembles": ens_rows, "ensembles_sharded": part["record"],
              "overlap": overlap_rows, "probe": probe,
              "plans": plan_walls, "auto": autos,
              "refused": refused, "distinct_cards": distinct,
              "seconds": time.perf_counter() - t0}
    print(json.dumps({"shards": record}, default=str), flush=True)
    return launches, record


def shard_ensembles(dev, rand, smi, counted_calls, model, *, W=W_MAIN, T=T_MAIN,
                    W_small=W_SHARD_SMALL, W_glob=W_GATHER, W_plan=W_PLAN):
    """[shards]' ensembles across the row shards, a part of the phase that
    also runs alone: K = 4 stacked stencil_1d members at the main shape over
    D = 4 (horizons HETERO_T cut to T) on the row x member mesh
    (member_shards 2 at S = 1 and S = S_MAIN pipelined and serial, and "auto"
    under ``model``, the probe's D = 4 model), the stacked launch plan at Dk
    = 1 and 2 and the stepwise one on a tuple (stencil_1d at W, fft at
    W_plan, spread at W_glob); each run equal to its eager loop in the
    counted run and three timed ones, bit for bit its Dk = 1 run (a tuple, a
    stepwise plan: its D = 1 twin), its launches exactly those counted, its
    us a step printed beside the twin's. Then the same paths at grain 1, W
    = W_small, horizons T_SHARD_ENS, at Dk = 2 and 4, against the CPU plain
    path. Returns the launches its runs make (``expected``), those of its
    eager loops and twins (``apart``, ``apart_calls``), its comparisons, the
    grain-1 references' distances from the fixed point and its record; the
    counters read around the part hold it to them."""
    import dataclasses

    import torch

    from repro_torch.core import GraphEnsemble, KernelSpec, TaskGraph, get_runtime
    from repro_torch.core.runtimes._capture import GraphRun, ShardedRun, time_runs
    from repro_torch.kernels import _build, ops

    t0 = time.perf_counter()
    card = dev.type == "cuda"
    expected = dict.fromkeys(_build.ENTRIES, 0)
    apart = dict.fromkeys(_build.ENTRIES, 0)
    apart_calls, compared, shows_dist = [0], [0], []
    cpu = get_runtime("fused", device="cpu")

    def sync():
        if card:
            torch.cuda.synchronize()

    def runtime(name, D, opts, devices=None):
        return get_runtime(name, devices=devices or [dev] * D, **opts)

    def keep_apart(d, calls):
        for k, n in d.items():
            apart[k] += n
        apart_calls[0] += calls

    def dataflow_shows(label, want):
        shows_dist.append(dataflow_distance("shards", label, want))

    sync()
    before = ops.launch_counts()
    ens_walls = []  # one row per sharded ensemble run or plan, beside its twin's
    ens_sharded = []  # one record per sharded ensemble run

    def same(label, got, want):
        for k, (a, b) in enumerate(zip(got, want)):
            if not torch.equal(a, b):
                fail(f"[shards] {label} member {k}: differs, max |difference| "
                     f"{(a - b).abs().max().item()}")

    def ens_launches(rt, ens):
        """One ensemble run's K3/K4 launches over every shard: D x
        ensemble_dispatches_per_run (K3 at S = 1; at S > 1, stacked, one K3
        a shard and the rest K4's tiled form)."""
        D, n = rt.num_devices, rt.ensemble_dispatches_per_run(ens)
        want = dict.fromkeys(_build.ENTRIES, 0)
        if rt._ensemble_steps_per_launch(ens) == 1:
            want["taskbench_step"] = D * n
        else:
            want["taskbench_step"], want[K4_TILED] = D, D * (n - 1)
        return want

    def ens_once(label, rt, ens, xs, reps=3):
        """``rt``'s run of ``ens`` over its shards: built (a ShardedRun over
        one graph), run once with the counters read around it, equal bit
        for bit to its eager loop, launching ``ens_launches`` in
        ``host_calls_per_run`` host calls, timed (best of ``reps``), each
        timed run's output equal to the eager loop's again. Returns the
        members' outputs and the us a step."""
        tb = time.perf_counter()
        run = rt.build_ensemble(ens)
        sync()
        build_s = time.perf_counter() - tb
        if card and not (isinstance(run, ShardedRun) and isinstance(run.inner, GraphRun)):
            fail(f"[shards] {label}: build_ensemble gave {type(run).__name__}")
        out, d, calls = counted_calls(lambda: run(xs))
        again, d_eager, h_eager = counted_calls(
            lambda: run.eager(tuple(x.clone() for x in xs)))
        keep_apart(d_eager, h_eager)
        same(f"{label} vs its eager loop", out, again)
        wd = ens_launches(rt, ens)
        if d != wd or d_eager != d:
            fail(f"[shards] {label}: launches {d} (eager loop {d_eager}), expected {wd}")
        if calls != rt.host_calls_per_run(ens):
            fail(f"[shards] {label}: {calls} host calls")
        timed = []
        walls = time_runs(run, xs, reps=reps, outputs=timed)
        for k, n in wd.items():
            expected[k] += n * (2 + reps)
        for o in timed:
            same(f"{label} timed run vs its eager loop", o, again)
        compared[0] += 1 + reps
        ens_sharded.append({"run": label, "patterns": [g.pattern for g in ens.members],
                            "T": [g.steps for g in ens.members], "launches": sum(d.values()),
                            "host_calls": calls, "build_s": build_s,
                            "us_per_step": min(walls) / ens.steps * 1e6})
        return out, min(walls) / ens.steps * 1e6

    def twin_run(rt, ens, xs, reps=3):
        """A twin's run the sharded runs are held to (one build, one run and
        ``reps`` timed), its launches kept apart; its outputs and us a step."""
        run = rt.build_ensemble(ens)
        out, d, h = counted_calls(lambda: run(xs))
        keep_apart(d, h)
        walls, d, h = counted_calls(lambda: time_runs(run, xs, reps=reps))
        keep_apart(d, h)
        return out, min(walls) / ens.steps * 1e6

    def plan_runs(label, rt, ens, xs, evict_at, admit_at, slot, fresh, count=True):
        """``rt``'s launch plan of ``ens`` stepped on the host: plainly, and
        with member 1's act rows zeroed from launch ``evict_at`` and
        ``fresh`` admitted into ``slot`` at launch ``admit_at``; the capture
        count flat under both edits; with ``count``, each run's launches
        exactly the plan's (D K3 at init, D a launch, a stepwise plan's
        members each; the admission's K3 on the slot's shards). Returns
        the plan, both runs' outputs and the plain run's us a step."""
        lp = rt.build_ensemble_launches(ens)
        if not evict_at < admit_at < lp.num_launches:
            fail(f"[shards] {label}: {lp.num_launches} launches, evict at {evict_at}, "
                 f"admit at {admit_at}")

        def step(acts, admit=None):
            carry = lp.init_fn(xs)
            for l in range(lp.num_launches):
                if admit is not None and l == admit[0]:
                    carry = lp.admit_fn(carry, admit[1], admit[2])
                carry = lp.launch_fn(carry, acts[l], lp.launch_t0(l))
            return lp.finalize(carry)

        D = rt.num_devices
        want = dict.fromkeys(_build.ENTRIES, 0)
        if lp.kind == "stacked":
            want["taskbench_step"] = D
            want["taskbench_step" if lp.steps_per_launch == 1 else K4_TILED] += \
                D * lp.num_launches
            admitted = D // rt._member_shards(ens)
        else:
            want["taskbench_step"] = D * len(ens) * (1 + lp.num_launches)
            admitted = D
        tp = time.perf_counter()
        plain, d_plain, _ = counted_calls(lambda: step(lp.acts))
        plan_us = (time.perf_counter() - tp) / ens.steps * 1e6
        captures_before = lp.compile_counter()
        acts = lp.acts.copy()
        acts[evict_at:, 1, :] = 0
        churned, d_churn, _ = counted_calls(lambda: step(acts, admit=(admit_at, slot, fresh)))
        if lp.compile_counter() != captures_before:
            fail(f"[shards] {label}: the plan captured under eviction and admission")
        if count:
            churn_want = dict(want, taskbench_step=want["taskbench_step"] + admitted)
            if d_plain != want or d_churn != churn_want:
                fail(f"[shards] {label}: launches {d_plain} and {d_churn} (churned), "
                     f"expected {want} and {churn_want}")
            for k in want:
                expected[k] += d_plain[k] + d_churn[k]
        else:
            keep_apart(d_plain, 0)
            keep_apart(d_churn, 0)
        return lp, plain, churned, plan_us

    def t0_of(g, x):
        """The t = 0 K3 of ``x`` on one device, its launch kept apart."""
        fn = get_runtime("pallas_step", device=dev)._halo_step_fns(g)[0]
        out, d, h = counted_calls(lambda: fn(x[None])[0])
        keep_apart(d, h)
        return out

    ens_T = tuple(max(1, t * T // T_MAIN) for t in HETERO_T)
    ens_main = GraphEnsemble([TaskGraph(steps=t, width=W, pattern="stencil_1d", payload=PAYLOAD,
                                        kernel=KernelSpec("compute_bound", GRAIN), seed=k)
                              for k, t in enumerate(ens_T)])
    xs_main = tuple(rand(W, PAYLOAD) for _ in ens_main.members)
    stacked_out = {}
    for tag, opts in (("S=1", {}), (f"S={S_MAIN} pipelined", {"steps_per_launch": S_MAIN}),
                      (f"S={S_MAIN} serial", {"steps_per_launch": S_MAIN, "pipeline": False})):
        one, one_us = ens_once(f"K=4 stacked {tag} Dk=1", runtime("pallas_step", 4, opts),
                               ens_main, xs_main)
        two, two_us = ens_once(f"K=4 stacked {tag} Dk=2",
                               runtime("pallas_step", 4, dict(opts, member_shards=2)),
                               ens_main, xs_main)
        same(f"K=4 stacked {tag} Dk=2 vs Dk=1", two, one)
        stacked_out[tag] = one
        ens_walls.append({"run": f"K=4 stacked {tag} member_shards=2", "us_per_step": two_us,
                          "twin": "Dk=1", "twin_us_per_step": one_us})
    same(f"K=4 stacked S={S_MAIN} pipelined vs serial", stacked_out[f"S={S_MAIN} pipelined"],
         stacked_out[f"S={S_MAIN} serial"])
    rt = runtime("pallas_step", 4, {"member_shards": "auto", "cost_model": model})
    auto_dk, auto_why = rt._auto_member_shards(ens_main)
    print(f"[shards] member_shards='auto' on the K=4 stacked ensemble (W={W}, D=4) under the "
          f"D = 4 model: Dk={auto_dk}: {auto_why}", flush=True)
    got, us = ens_once(f"K=4 stacked S=1 member_shards=auto (Dk={auto_dk})", rt, ens_main,
                       xs_main)
    same("K=4 stacked member_shards=auto vs Dk=1", got, stacked_out["S=1"])
    ens_walls.append({"run": f"K=4 stacked S=1 member_shards=auto (Dk={auto_dk})",
                      "us_per_step": us, "twin": "Dk=1",
                      "twin_us_per_step": ens_walls[0]["twin_us_per_step"]})
    # the stacked launch plan at S_MAIN: evict member 1 from launch EVICT_AT,
    # admit a fresh member into the finished slot 3 at ADMIT_AT
    evict_at, admit_at = EVICT_AT * T // T_MAIN, ADMIT_AT * T // T_MAIN
    fresh = rand(W, PAYLOAD)
    plans_main = {}
    for dk in (1, 2):
        rt = runtime("pallas_step", 4, {"steps_per_launch": S_MAIN, "member_shards": dk})
        lp, plain, churned, us = plan_runs(f"stacked launch plan Dk={dk}", rt, ens_main, xs_main,
                                           evict_at, admit_at, 3, fresh)
        same(f"stacked launch plan Dk={dk} vs build_ensemble", plain,
             stacked_out[f"S={S_MAIN} serial"])
        plans_main[dk] = churned
        ens_walls.append({"run": f"stacked launch plan S={S_MAIN} Dk={dk} ({lp.num_launches} "
                                 f"launches, host-stepped)", "us_per_step": us,
                          "twin": "graph replay Dk=1",
                          "twin_us_per_step": ens_walls[2]["twin_us_per_step"]})
    same("stacked launch plan Dk=2 vs Dk=1 under eviction and admission", plans_main[2],
         plans_main[1])
    same("stacked launch plan: the admitted member vs the t = 0 K3 of its init",
         plans_main[1][3:], (t0_of(ens_main.members[3], fresh),))
    t_evict = 1 + evict_at * S_MAIN
    g1 = dataclasses.replace(ens_main.members[1], steps=t_evict)
    own, d, h = counted_calls(lambda: runtime("pallas_step", 1, {"steps_per_launch": S_MAIN},
                                              [dev]).build(g1)(xs_main[1]))
    keep_apart(d, h)
    err = check_close(f"[shards] stacked launch plan: the evicted member vs its own D = 1 run "
                      f"at T={t_evict}", plans_main[1][1].cpu(), own.cpu(), TOL)
    evicted_bitwise = bool(torch.equal(plans_main[1][1], own))
    # a tuple of three plans at D = 4, and its stepwise launch plan, each
    # held to its D = 1 twin bit for bit
    tup_main = GraphEnsemble([
        TaskGraph(steps=t, width=w, pattern=p, payload=PAYLOAD, seed=k,
                  kernel=KernelSpec("compute_bound", GRAIN))
        for k, (p, w, t) in enumerate((("stencil_1d", W, ens_T[0]), ("fft", W_plan, ens_T[1]),
                                        ("spread", W_glob, ens_T[2])))])
    xt = tuple(rand(g.width, PAYLOAD) for g in tup_main.members)
    four, four_us = ens_once("tuple stencil_1d/fft/spread D=4", runtime("pallas_step", 4, {}),
                             tup_main, xt)
    one, one_us = twin_run(runtime("pallas_step", 1, {}, [dev]), tup_main, xt)
    same("tuple D=4 vs D=1", four, one)
    ens_walls.append({"run": "tuple stencil_1d/fft/spread D=4", "us_per_step": four_us,
                      "twin": "D=1", "twin_us_per_step": one_us})
    fresh_t = rand(W_glob, PAYLOAD)
    lp, plain, churned, us = plan_runs("stepwise launch plan D=4", runtime("pallas_step", 4, {}),
                                       tup_main, xt, evict_at, admit_at, 2, fresh_t)
    same("stepwise launch plan D=4 vs build_ensemble", plain, four)
    _, _, churned1, us1 = plan_runs("stepwise launch plan D=1", runtime("pallas_step", 1, {}, [dev]),
                                    tup_main, xt, evict_at, admit_at, 2, fresh_t, count=False)
    same("stepwise launch plan D=4 vs D=1 under eviction and admission", churned, churned1)
    ens_walls.append({"run": f"stepwise launch plan D=4 ({lp.num_launches} launches, "
                             f"host-stepped)", "us_per_step": us, "twin": "D=1",
                      "twin_us_per_step": us1})

    # the same paths at grain 1, where the dataflow shows
    stacked = [TaskGraph(steps=t, width=W_small, pattern="stencil_1d", payload=PAYLOAD,
                         kernel=KernelSpec("compute_bound", 1), seed=20 + k)
               for k, t in enumerate(T_SHARD_ENS)]
    ens1 = GraphEnsemble(stacked)
    xs1 = tuple(rand(W_small, PAYLOAD) for _ in stacked)
    want1 = [torch.from_numpy(cpu.execute(g, x.cpu())) for g, x in zip(stacked, xs1)]
    n_ens_small = 0
    for opts in ({}, {"steps_per_launch": S_SHARD_HOP}):
        base = None
        for dk in (1, 2, 4):
            label = f"grain 1 K=4 stacked {opts or ''} Dk={dk}"
            out, _ = ens_once(label, runtime("pallas_step", 4, dict(opts, member_shards=dk)),
                              ens1, xs1)
            base = out if base is None else base
            same(f"{label} vs Dk=1", out, base)
            for k, (a, w) in enumerate(zip(out, want1)):
                dataflow_shows(f"{label} member {k}", w)
                check_close(f"[shards] {label} member {k} vs CPU plain", a.cpu(), w, TOL)
            n_ens_small += 1
    fresh1 = rand(W_small, PAYLOAD)
    for dk in (2, 4):
        label = f"grain 1 stacked launch plan Dk={dk}"
        lp, plain, churned, _ = plan_runs(label, runtime("pallas_step", 4, {"member_shards": dk}),
                                          ens1, xs1, 2, 4, 3, fresh1)
        g1 = dataclasses.replace(stacked[1], steps=3)
        wants = [want1[0], torch.from_numpy(cpu.execute(g1, xs1[1].cpu())), want1[2],
                 torch.from_numpy(cpu.execute(dataclasses.replace(stacked[3], steps=1),
                                              fresh1.cpu()))]
        for k, (a, w) in enumerate(zip(churned, wants)):
            dataflow_shows(f"{label} member {k}", w)
            check_close(f"[shards] {label} member {k} vs CPU plain", a.cpu(), w, TOL)
        for k, (a, w) in enumerate(zip(plain, want1)):
            check_close(f"[shards] {label} unedited member {k} vs CPU plain", a.cpu(), w, TOL)
        n_ens_small += 1
    tup1 = GraphEnsemble([TaskGraph(steps=t, width=W_small, pattern=p, payload=PAYLOAD, seed=30 + k,
                                    kernel=KernelSpec("compute_bound", 1))
                          for k, (p, t) in enumerate(zip(("stencil_1d", "fft", "spread"),
                                                         T_SHARD_ENS))])
    xt1 = tuple(rand(W_small, PAYLOAD) for _ in tup1.members)
    want_t1 = [torch.from_numpy(cpu.execute(g, x.cpu())) for g, x in zip(tup1.members, xt1)]
    out, _ = ens_once("grain 1 tuple stencil_1d/fft/spread D=4", runtime("pallas_step", 4, {}),
                      tup1, xt1)
    lp, plain, churned, _ = plan_runs("grain 1 stepwise launch plan D=4",
                                      runtime("pallas_step", 4, {}), tup1, xt1, 2, 4, 2, fresh1)
    same("grain 1 stepwise launch plan vs build_ensemble", plain, out)
    wants = [want_t1[0], torch.from_numpy(cpu.execute(dataclasses.replace(tup1.members[1], steps=3),
                                                      xt1[1].cpu())),
             torch.from_numpy(cpu.execute(dataclasses.replace(tup1.members[2], steps=1),
                                          fresh1.cpu()))]
    for k, (a, b, w, w0) in enumerate(zip(out, churned, want_t1, wants)):
        for lbl, got, ref in (("tuple", a, w), ("stepwise launch plan (churned)", b, w0)):
            dataflow_shows(f"grain 1 {lbl} member {k}", ref)
            check_close(f"[shards] grain 1 {lbl} member {k} vs CPU plain", got.cpu(), ref, TOL)
    n_ens_small += 2
    for row in ens_walls:
        print(f"[shards] ensembles: {row['run']}: {row['us_per_step']:.3f} us a step "
              f"({row['twin']}: {row['twin_us_per_step']:.3f})", flush=True)
    print(f"[shards] the evicted member vs its own D = 1 run: bit for bit {evicted_bitwise}, "
          f"max |err| {err:.3g}; {n_ens_small} grain-1 ensemble cases against the CPU plain "
          f"path", flush=True)

    sync()
    total = ops.launch_counts()
    launches = {k: total[k] - before[k] - apart[k] for k in total}
    if launches != expected:
        fail(f"[shards] ensembles: launches {launches} differ from the runs' own {expected}")
    print(f"[shards] ensembles across the shards: {len(ens_sharded)} runs and the launch "
          f"plans, each run equal to its eager loop bit for bit ({compared[0]} comparisons), "
          f"each to its twin; launches {launches} (and {apart} apart); "
          f"{time.perf_counter() - t0:.3f} s | {smi}", flush=True)
    record = {"runs": ens_sharded, "walls": ens_walls,
              "member_shards_auto": {"Dk": auto_dk, "reason": auto_why},
              "evicted_bitwise": evicted_bitwise, "seconds": time.perf_counter() - t0}
    return {"expected": expected, "apart": apart, "apart_calls": apart_calls[0],
            "compared": compared[0], "shows_dist": shows_dist, "record": record}


# [trace]: serialized at [rungs]' size; the pipelined D = 4 run's Chrome trace
TRACE_CHROME = "artifacts/bench_torch/trace_pipelined_d4.json"


def trace_phase(dev, rand, smi, *, W=W_MAIN, T=T_MAIN, W_plan=W_PLAN, W_glob=W_GATHER,
                W_ser=SMS, T_ser=T_SER, D=4, chrome: Optional[Path] = None):
    """The [trace] phase; returns its record. Reads the launch counters
    around each run itself, so it leaves nothing for another phase to
    account."""
    import torch

    from repro_torch import obs
    from repro_torch.core import KernelSpec, TaskGraph, get_runtime
    from repro_torch.core.runtimes._capture import time_runs
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    card = dev.type == "cuda"
    chrome = ROOT / TRACE_CHROME if chrome is None else chrome

    def sync():
        if card:
            torch.cuda.synchronize()

    def counted(fn):
        sync()
        before = ops.launch_counts()
        out = fn()
        sync()
        after = ops.launch_counts()
        return out, {k: after[k] - before[k] for k in after if after[k] != before[k]}

    def graph(pattern, width, steps=T, grain=GRAIN):
        return TaskGraph(steps=steps, width=width, pattern=pattern, payload=PAYLOAD,
                         kernel=KernelSpec("compute_bound", grain))

    S8 = {"steps_per_launch": S_MAIN}
    cases = [
        ("pallas_step S=1", "pallas_step", 1, {}, graph("stencil_1d", W)),
        ("pallas_step S=8 serial", "pallas_step", 1, dict(S8, pipeline=False),
         graph("stencil_1d", W)),
        ("pallas_step S=8 pipelined", "pallas_step", 1, S8, graph("stencil_1d", W)),
        ("pallas_step fft stride", "pallas_step", 1, {}, graph("fft", W_plan)),
        ("pallas_step spread all-gather", "pallas_step", 1, {}, graph("spread", W_glob)),
        ("fused", "fused", 1, {"use_kernels": True}, graph("stencil_1d", W)),
        ("bsp", "bsp", 1, {"use_kernels": True}, graph("stencil_1d", W)),
        ("bsp_scan", "bsp_scan", 1, {"use_kernels": True}, graph("stencil_1d", W)),
        ("overlap", "overlap", 1, {"use_kernels": True}, graph("stencil_1d", W)),
        ("serialized", "serialized", 1, {"use_kernels": True},
         graph("stencil_1d", W_ser, T_ser)),
        (f"pallas_step S=1 D={D}", "pallas_step", D, {}, graph("stencil_1d", W)),
        (f"pallas_step S=8 pipelined D={D}", "pallas_step", D, S8, graph("stencil_1d", W)),
        (f"pallas_step fft D={D}", "pallas_step", D, {}, graph("fft", W_plan)),
    ]
    rows = []
    for label, name, nd, opts, g in cases:
        rt = get_runtime(name, devices=[dev] * nd, trace=True, **opts)
        x = rand(g.width, PAYLOAD)
        run = rt.build(g)
        want, _ = counted(lambda: run(x.clone()))
        eager = getattr(run, "eager", run)
        _, d_eager = counted(lambda: eager(x.clone()))
        walls = time_runs(run, x, reps=3)
        got, d_traced = counted(lambda: rt.trace_once(g, x))
        spans = rt.tracer.spans
        if not torch.equal(torch.from_numpy(got), want.cpu()):
            fail(f"[trace] {label}: the traced run differs from the build's replay, max "
                 f"|diff| {(torch.from_numpy(got) - want.cpu()).abs().max().item():.3g}")
        if d_traced != d_eager:
            fail(f"[trace] {label}: the traced run launched {d_traced}, its eager loop "
                 f"{d_eager}")
        if dev.type == "cuda" and not d_traced:
            fail(f"[trace] {label}: the traced run launched no kernel")
        summary = obs.summarize(spans)
        if abs(sum(summary["fractions"].values()) - 1.0) > 1e-9:
            fail(f"[trace] {label}: the fractions sum to {sum(summary['fractions'].values())}")
        if not summary["fractions"]["dispatch"] > 0:
            fail(f"[trace] {label}: no dispatch wall")
        decisions = summary["decisions"]
        if (name == "pallas_step") != bool(decisions) or (
                decisions and decisions[0]["name"] != "schedule.resolve"):
            fail(f"[trace] {label}: decision records {decisions}")
        verdict = summary["overlap"]
        if "pipelined" in label:
            probes = obs.probe_costs(spans)
            phases = {"boundary", "interior"} | ({"exchange"} if nd > 1 else set())
            if set(probes) != phases or not all(v > 0 for v in probes.values()):
                fail(f"[trace] {label}: probes {probes}, want {sorted(phases)} above 0")
            if nd == 1 and verdict.get("verdict") != "unavailable":
                fail(f"[trace] {label}: one device's verdict {verdict}")
            if nd > 1 and verdict.get("verdict") not in ("hidden", "visible"):
                fail(f"[trace] {label}: verdict {verdict}")
            if nd > 1:
                chrome.parent.mkdir(parents=True, exist_ok=True)
                obs.write_chrome_trace(str(chrome), spans, process_name=f"{label} | {smi}")
        row = {"run": label, "runtime": name, "D": nd, "W": g.width, "T": g.steps,
               "pattern": g.pattern, "options": opts, "wall_us": summary["wall_us"],
               "categories_us": summary["categories_us"],
               "fractions": summary["fractions"], "span_count": summary["span_count"],
               "replay_best_us": min(walls) * 1e6,
               "host_stepping_ratio": summary["wall_us"] / (min(walls) * 1e6),
               "launches": d_traced,
               "plan": decisions[0]["plan"] if decisions else None,
               "steps_per_launch": decisions[0]["steps_per_launch"] if decisions else None,
               "overlap": verdict}
        rows.append(row)
        cats = ", ".join(f"{k} {v:.3f}" for k, v in summary["categories_us"].items() if v)
        over = ""
        if verdict:
            over = (f"; overlap {verdict['verdict']}" + (
                f", hidden_fraction {verdict['hidden_fraction']:.4f}, per launch: exchange "
                f"{verdict['exchange_per_launch_us']:.3f} us, boundary "
                f"{verdict['boundary_per_launch_us']:.3f} us, interior "
                f"{verdict['interior_per_launch_us']:.3f} us, launch "
                f"{verdict['combined_launch_us'] / verdict['launches']:.3f} us"
                if "hidden_fraction" in verdict else
                f" ({verdict['reason']}); probes per launch "
                f"{ {k: round(v, 3) for k, v in obs.probe_costs(spans).items()} } us"))
        print(f"[trace] {label} W={g.width} T={g.steps}: traced wall "
              f"{summary['wall_us']:.3f} us against the replay's {min(walls) * 1e6:.3f} us "
              f"(x{row['host_stepping_ratio']:.3f}); us by category: {cats}{over}; "
              f"{summary['span_count']} spans, launches {d_traced} | {smi}", flush=True)
    print(f"[trace] {len(rows)} traced runs, each bit for bit its replay and launching its "
          f"eager loop's kernels; Chrome trace {chrome.relative_to(ROOT) if chrome.is_relative_to(ROOT) else chrome}; "
          f"{time.perf_counter() - t0:.3f} s | {smi}", flush=True)
    record = {"trace": {"runs": rows, "chrome": str(chrome), "card": smi}}
    print(json.dumps(record), flush=True)
    return record


# [resilience], [serving], [restart]: the host-stepped launch plans under the
# resilience engine, the serving fabric and the restart loop, at the main
# width. K = 4 stacked stencil_1d members, grain 64 at the horizons T_RES
# (launch plan S = 1: 999 launches, S = 8: 125), and where the dataflow shows:
# grain 1 at T_RES_SHORT (inside the contraction horizon, see T_SHARD_SMALL;
# 6 launches at S = 1, one at S = 8). The straggler stalls STRAGGLER_S past
# its launch. Where a launch is one replay the faulted runs' policy puts the
# detector's deadline at RES_DEADLINE_US under the measured model: under the
# stall, and above a host-stepped launch's issue and synchronize, which a
# shared host stretches past 500 us at times ([schedule]'s host stalls), and
# above a fresh plan's first launches (their outputs' first allocations; the
# phase prints a fresh plan's walls), ~20 ms once over D = 4 shards.
# The stepwise plan's eager launches (0.8-2.7 ms on the H100) are not
# priced: its deadline is the default factor x the observed median. The
# clean runs of the host-stepping tax run on the default policy, and the
# phase prints the launches it flags.
K_RES = 4
T_RES, T_RES_SHORT = (1000, 900, 800, 700), (7, 7, 6, 5)
STRAGGLER_S, RES_DEADLINE_US = 0.15, 40000.0
# [serving]: 12 requests at the main width, 6 stencil_1d and 6 nearest
# (radius 2), two priorities, one explicit deadline (rid 3, in LaunchClock
# launches) that evicts; the grain-1 pass at T <= 7 and S = S_ENS_SHORT
SERVE_T = (97, 161, 33, 250, 65, 129, 201, 41, 113, 81, 145, 57)
SERVE_T_SHORT = (7, 7, 6, 7, 3, 4, 7, 3, 7, 5, 3, 4)
SERVE_DEADLINE_RID, SERVE_DEADLINE = 3, 5.0
# [restart]: a checkpoint every RESTART_EVERY launches, failures at the
# launches RESTART_FAIL_AT (the newest checkpoint corrupted before the last)
RESTART_EVERY, RESTART_FAIL_AT = 25, (60, 110)


def _plan_events(plan):
    """The events a fault plan should leave, as (kind, launch, action,
    member, attempts, mode), sorted."""
    out = []
    for s in plan.specs:
        if s.kind == "transport":
            out.append(("transport", s.launch, "retried", -1, s.times, ""))
        elif s.kind == "launch":
            out.append(("launch", s.launch, "replayed", -1, 0, s.mode))
        elif s.kind == "member":
            out.append(("member", s.launch, "evicted", s.member, 0, ""))
        else:
            out.append(("straggler", s.launch, "flagged", -1, 0, ""))
    return sorted(out)


def _counter(dev):
    """(sync, counted, apart, kept) over the launch counters: ``counted(fn)``
    gives fn's result and the launches it made (a synchronize before and
    after); ``apart(fn)`` does the same and adds the launches to ``kept``,
    the oracles' launches that are not the phase's path."""
    import torch

    from repro_torch.kernels import ops

    kept = dict.fromkeys(ops.launch_counts(), 0)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def counted(fn):
        sync()
        before = ops.launch_counts()
        out = fn()
        sync()
        after = ops.launch_counts()
        return out, {k: after[k] - before[k] for k in after}

    def apart(fn):
        out, d = counted(fn)
        for k, n in d.items():
            kept[k] += n
        return out

    return sync, counted, apart, kept


def resilience_phase(dev, rand, smi, model=None, *, W=W_MAIN, T=T_RES,
                     T_short=T_RES_SHORT, W_plan=W_PLAN, W_glob=W_GATHER, D=4):
    """The [resilience] phase; returns the launches of its resilient runs
    (the oracles' kept apart). ``model``: the cost model the runtimes
    price launches with (None: the default tier, analytic on the CPU)."""
    import dataclasses

    import torch

    from repro_torch.core import GraphEnsemble, KernelSpec, TaskGraph, get_runtime
    from repro_torch.core.runtimes._capture import time_runs
    from repro_torch.core.task_kernels import initial_state
    from repro_torch.kernels import ops
    from repro_torch.resilience import (READMIT_SEED_OFFSET, FaultPlan, FaultSpec,
                                        RecoveryPolicy)

    t0 = time.perf_counter()
    card = dev.type == "cuda"
    ops.reset_launch_counts()
    sync, counted, apart, kept = _counter(dev)
    opts = {} if model is None else {"cost_model": model}
    rows = []

    def ens_of(steps, width=W, grain=GRAIN, pattern="stencil_1d", radius=1):
        return GraphEnsemble([TaskGraph(steps=t, width=width, pattern=pattern, payload=PAYLOAD,
                                        radius=radius, seed=k,
                                        kernel=KernelSpec("compute_bound", grain))
                              for k, t in enumerate(steps)])

    def policy_for(lp, **kw):
        f = RES_DEADLINE_US / lp.deadline_expected_us if lp.deadline_expected_us else None
        return RecoveryPolicy(**kw) if f is None else RecoveryPolicy(
            deadline_factor=max(f, 1.5), **kw)

    def outputs_of(res):
        return [torch.from_numpy(o) for o in res.outputs]

    def case(label, rt, ens, xs, plan, readmit, evidence):
        """The clean resilient run against the build_ensemble replay, then
        the faulted run: survivors against the clean run, evicted and
        re-admitted members against one same-K oracle replay, the events
        against the plan, the launches against the clean run's."""
        lp = rt.build_ensemble_launches(ens)
        L = lp.num_launches
        run = rt.build_ensemble(ens)
        want = [w.cpu() for w in apart(lambda: run(xs))]
        policy = policy_for(lp, readmit=readmit)
        clean, d_clean = counted(lambda: rt.execute_ensemble_resilient(
            ens, policy=policy, inits=xs))
        for k, (a, b) in enumerate(zip(outputs_of(clean), want)):
            if not torch.equal(a, b):
                fail(f"[resilience] {label}: the clean run's member {k} differs from the "
                     f"build_ensemble replay, max |difference| {(a - b).abs().max().item()}")
        if clean.events:
            fail(f"[resilience] {label}: the clean run recorded {clean.events}")
        res, d_fault = counted(lambda: rt.execute_ensemble_resilient(
            ens, plan=plan, policy=policy, inits=xs))
        got = outputs_of(res)
        events = sorted((e.kind, e.launch, e.action, e.member, e.attempts, e.mode)
                        for e in res.events)
        if events != _plan_events(plan):
            fail(f"[resilience] {label}: events {events} != the plan's "
                 f"{_plan_events(plan)} ({plan.describe()})")
        # the oracle: the evicted members truncated at their frozen step, a
        # re-admitted member as its fresh run (its seed, its effective T)
        members, inits = list(ens.members), list(xs)
        for k, frozen in res.evicted.items():
            members[k] = dataclasses.replace(members[k], steps=frozen)
        for k, info in res.readmitted.items():
            g = members[k]
            if info["seed"] != g.seed + READMIT_SEED_OFFSET:
                fail(f"[resilience] {label}: re-admitted seed {info['seed']}")
            members[k] = dataclasses.replace(g, steps=info["steps"], seed=info["seed"])
            inits[k] = initial_state(g.width, g.payload, info["seed"], device=dev)
        touched = set(res.evicted) | set(res.readmitted)
        oracle = [w.cpu() for w in apart(
            lambda: rt.build_ensemble(GraphEnsemble(members))(tuple(inits)))]
        for k, (a, b, c) in enumerate(zip(got, want, oracle)):
            ref_ = c if k in touched else b
            if not torch.equal(a, ref_):
                fail(f"[resilience] {label}: member {k} "
                     f"({'evicted/re-admitted' if k in touched else 'survivor'}) differs from "
                     f"its oracle, max |difference| {(a - ref_).abs().max().item()}")
            if k not in touched and not torch.equal(a, c):
                fail(f"[resilience] {label}: the survivor {k} differs from the oracle replay")
        dist = None
        if evidence:
            dist = min(dataflow_distance("resilience", f"{label} member {k}", o)
                       for k, o in enumerate(oracle))
        # launches: the clean run's, one launch more for each poisoned or
        # evicting replay (the faulted launch ran, then its replay), and
        # the t = 0 K3 of each admission (a raise replays a launch that
        # never ran; a transport retry launches nothing)
        _, d_init = counted(lambda: lp.init_fn(xs))
        _, d_admit = counted(lambda: lp.admit_fn(lp.init_fn(xs), 0, xs[0])) \
            if res.readmitted else (None, dict.fromkeys(d_clean, 0))
        relaunch = sum(1 for e in res.events
                       if e.kind == "member" or (e.kind == "launch" and e.mode == "poison"))
        for k in d_clean:
            per = (d_clean[k] - d_init[k]) / L
            want_k = d_clean[k] + relaunch * per + len(res.readmitted) * (d_admit[k] - d_init[k])
            if d_fault[k] != want_k:
                fail(f"[resilience] {label}: kernel {k} launched {d_fault[k]} under faults, "
                     f"expected {want_k} (clean {d_clean[k]}, {relaunch} relaunches, "
                     f"{len(res.readmitted)} admissions)")
        for k in d_init:  # the init and admission probes are not the path
            kept[k] += d_init[k] + (d_admit[k] if res.readmitted else 0)
        flagged = [e for e in res.events if e.kind == "straggler"]
        rec = {k: sum(e.wall_us for e in res.events
                      if (e.kind, e.mode) == k) for k in {(e.kind, e.mode) for e in res.events}}
        rows.append({
            "run": label, "launches": L, "S": lp.steps_per_launch, "kind": lp.kind,
            "plan": plan.describe(), "wall_s": res.wall_s, "clean_wall_s": clean.wall_s,
            "retries": res.retries, "replays": res.replays, "evicted": res.evicted,
            "readmitted": res.readmitted, "deadline_us": res.deadline_us,
            "deadline_source": res.deadline_source,
            "overshoot_us": [e.overshoot_us for e in flagged],
            "recovery_us": {f"{k}{'/' + m if m else ''}": v for (k, m), v in rec.items()},
            "evidence_distance": dist,
            "kernel_launches": {k: n for k, n in d_fault.items() if n},
            "clean_kernel_launches": {k: n for k, n in d_clean.items() if n}})
        print(f"  {label}: {L} launches ({lp.kind}, S={lp.steps_per_launch}), "
              f"{plan.describe()}: clean {clean.wall_s * 1e3:.3f} ms, faulted "
              f"{res.wall_s * 1e3:.3f} ms; deadline {res.deadline_us} us "
              f"({res.deadline_source}), overshoot "
              f"{[round(e.overshoot_us, 3) for e in flagged]} us; recovery us "
              f"{rows[-1]['recovery_us']}; launches {rows[-1]['kernel_launches']}"
              + (f"; evidence {dist:.3g} from the fixed point" if dist is not None else ""),
              flush=True)
        return clean, res

    # grain 64 at T_RES: every class, the re-admission mid-run and a frozen
    # eviction at the last launch
    taxes = {}
    # clean runs on the default policy: (launches flagged, launches run,
    # deadline us, its source)
    default_flags = {}

    def on_default(label, runs, L):
        default_flags[label] = (sum(r.stragglers for r in runs), L * len(runs),
                                runs[-1].deadline_us, runs[-1].deadline_source)
    for S in (1, S_MAIN):
        ens = ens_of(T)
        xs = tuple(rand(W, PAYLOAD) for _ in ens.members)
        rt = get_runtime("pallas_step", devices=[dev], steps_per_launch=S, **opts)
        L = rt.build_ensemble_launches(ens).num_launches
        plan = FaultPlan((FaultSpec("transport", 3, times=2), FaultSpec("launch", 10),
                          FaultSpec("launch", 20, mode="poison"),
                          FaultSpec("straggler", 30, delay_s=STRAGGLER_S),
                          FaultSpec("member", 40, member=1),
                          FaultSpec("member", L - 1, member=0)))
        case(f"grain {GRAIN} S={S} T={T}", rt, ens, xs, plan, True, False)
        # the host-stepping tax: the clean resilient run, the build's
        # replay and measure_launch_plan, best of 3 each
        res_runs = [apart(lambda: rt.execute_ensemble_resilient(ens, inits=xs))
                    for _ in range(3)]
        on_default(f"grain {GRAIN} S={S}", res_runs, L)
        res_walls = [r.wall_s for r in res_runs]
        replay = min(apart(lambda: time_runs(rt.build_ensemble(ens), xs, reps=3)))
        _, st = apart(lambda: rt.measure_launch_plan(ens, reps=3))
        taxes[S] = {"resilient_s": min(res_walls), "replay_s": replay,
                    "measure_launch_plan_s": st.best, "launches": L}
        print(f"[resilience] the host-stepping tax, K={K_RES} S={S} grain {GRAIN}: clean "
              f"resilient {min(res_walls) * 1e3:.3f} ms, the build's replay "
              f"{replay * 1e3:.3f} ms, measure_launch_plan {st.best * 1e3:.3f} ms "
              f"({L} launches: {(min(res_walls) - replay) / L * 1e6:.3f} us a launch over the "
              f"replay) | {smi}", flush=True)
    # grain 1 at T_short: S = 1 (six launches: every class at its own
    # launch) and S = 8 (one launch: two plans)
    short = ens_of(T_short, grain=1)
    xs1 = tuple(rand(W, PAYLOAD) for _ in short.members)
    rt1 = get_runtime("pallas_step", devices=[dev], steps_per_launch=1, **opts)
    plan_a = FaultPlan((FaultSpec("transport", 0, times=2), FaultSpec("launch", 1),
                        FaultSpec("launch", 2, mode="poison"),
                        FaultSpec("straggler", 3, delay_s=STRAGGLER_S),
                        FaultSpec("member", 4, member=1), FaultSpec("member", 5, member=0)))
    case(f"grain 1 S=1 T={T_short}", rt1, short, xs1, plan_a, True, True)
    rt8 = get_runtime("pallas_step", devices=[dev], steps_per_launch=S_MAIN, **opts)
    # (one site a plan per class: a member fault replays its launch before
    # a poisoned output is scanned, and a stall is flagged on the committed
    # wall only)
    for plan in (FaultPlan((FaultSpec("transport", 0, times=2),
                            FaultSpec("launch", 0, mode="poison"))),
                 FaultPlan((FaultSpec("member", 0, member=1),)),
                 FaultPlan((FaultSpec("launch", 0), FaultSpec("straggler", 0,
                                                             delay_s=STRAGGLER_S)))):
        case(f"grain 1 S={S_MAIN} T={T_short}", rt8, short, xs1, plan, True, True)
    # a mixed-plan ensemble (halo, stride, all-gather members): the
    # stepwise plan, one step a launch, eager
    mixed = GraphEnsemble([
        TaskGraph(steps=t, width=w, pattern=p, payload=PAYLOAD, seed=k,
                  kernel=KernelSpec("compute_bound", 1))
        for k, (t, w, p) in enumerate(((T_ENS_SHORT[3], W, "stencil_1d"),
                                       (T_ENS_SHORT[0], W_plan, "fft"),
                                       (T_ENS_SHORT[1], W_glob, "spread"),
                                       (T_ENS_SHORT[2], W_glob, "all_to_all")))])
    xm = tuple(rand(g.width, PAYLOAD) for g in mixed.members)
    plan_e = FaultPlan((FaultSpec("transport", 0, times=2), FaultSpec("launch", 1),
                        FaultSpec("launch", 2, mode="poison"),
                        FaultSpec("straggler", 3, delay_s=STRAGGLER_S),
                        FaultSpec("member", 4, member=1)))
    case(f"grain 1 mixed-plan stepwise T={T_ENS_SHORT}", rt1, mixed, xm, plan_e, False, True)
    on_default("grain 1 mixed-plan stepwise", [
        apart(lambda: rt1.execute_ensemble_resilient(mixed, inits=xm)) for _ in range(3)],
        rt1.build_ensemble_launches(mixed).num_launches)
    # over D row shards of the card
    rtD = get_runtime("pallas_step", devices=[dev] * D, steps_per_launch=1, **opts)
    clean_d, _ = case(f"grain 1 S=1 T={T_short} D={D}", rtD, short, xs1, plan_a, True, True)
    one = apart(lambda: rt1.execute_ensemble_resilient(short, inits=xs1))
    for k, (a, b) in enumerate(zip(clean_d.outputs, one.outputs)):
        a, b = torch.from_numpy(a), torch.from_numpy(b)
        if not torch.equal(a, b):
            fail(f"[resilience] D={D} member {k} differs from D = 1, max |difference| "
                 f"{(a - b).abs().max().item()}")
    on_default(f"grain 1 S=1 D={D}", [
        apart(lambda: rtD.execute_ensemble_resilient(short, inits=xs1)) for _ in range(3)],
        rtD.build_ensemble_launches(short).num_launches)
    # a fresh plan's launches, host wall with a synchronize each, on one
    # device and over D shards, 3 plans each: the first launches of a plan
    # allocate their outputs
    cold = {}

    def fresh_walls(rt_):
        walls_ = []
        for _ in range(3):
            lp_ = rt_.build_ensemble_launches(short)
            rows_ = lp_.act_rows()
            rows_[0]
            carry = lp_.init_fn(xs1)
            sync()
            ws = []
            for l in range(lp_.num_launches):
                t1 = time.perf_counter()
                carry = lp_.launch_fn(carry, rows_[l], lp_.launch_t0(l))
                sync()
                ws.append((time.perf_counter() - t1) * 1e6)
            walls_.append(ws)
        return walls_

    for label, rt_ in (("D=1", rt1), (f"D={D}", rtD)):
        cold[label] = apart(lambda: fresh_walls(rt_))
    print("[resilience] a fresh S=1 plan's launch walls (us, host, a synchronize each; 3 plans): "
          + "; ".join(f"{k}: " + ", ".join(str([round(w, 1) for w in ws]) for ws in v)
                      for k, v in cold.items()) + f" | {smi}", flush=True)
    flagged = sum(n for n, _, _, _ in default_flags.values())
    print(f"[resilience] clean runs on the default policy (factor "
          f"{RecoveryPolicy().deadline_factor}): {flagged} of "
          f"{sum(n for _, n, _, _ in default_flags.values())} launches flagged; "
          + "; ".join(f"{k}: {n} of {m} (deadline {d} us, {src})"
                      for k, (n, m, d, src) in default_flags.items()) + f" | {smi}", flush=True)
    sync()
    total = ops.launch_counts()
    launches = {k: n - kept[k] for k, n in total.items()}
    for k, n in launches.items():
        if card and (n == 0) == (k in ("taskbench_step", K4_TILED)):
            fail(f"[resilience] kernel {k}: {n} launches on the resilient runs")
    print(f"[resilience] {len(rows)} resilient runs (K={K_RES} stacked stencil_1d at W={W}, "
          f"S=1 and {S_MAIN}, grain {GRAIN} at T={T} and grain 1 at T={T_short}; a "
          f"mixed-plan stepwise ensemble; D={D} shards): each clean run equal to its "
          f"build_ensemble replay, survivors equal to it and evicted/re-admitted members to "
          f"their same-K oracle bit for bit, the events the plans', every straggler flagged, "
          f"launches the clean run's plus the relaunches and admissions; D={D} bit for bit "
          f"D = 1; launches {launches} (and {kept} by the oracles); "
          f"{time.perf_counter() - t0:.3f} s | {smi}", flush=True)
    print(json.dumps({"resilience": {"runs": rows, "host_stepping_tax": taxes,
                                     "default_policy_flags": default_flags,
                                     "fresh_plan_walls_us": cold,
                                     "card": smi}}), flush=True)
    return launches


def serving_phase(dev, rand, smi, model=None, *, W=W_MAIN, S=S_MAIN,
                  S_short=S_ENS_SHORT, T=SERVE_T, T_short=SERVE_T_SHORT, slots=K_RES):
    """The [serving] phase; returns the launches of the fabric's serving
    (each pass's oracles, run after serving, kept apart)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core import GraphEnsemble, KernelSpec, get_runtime
    from repro_torch.kernels import ops
    from repro_torch.serving import (LaunchClock, ServingFabric, WallClock, cohort_key,
                                     make_request, pack)

    t0 = time.perf_counter()
    card = dev.type == "cuda"
    ops.reset_launch_counts()
    sync, counted, apart, kept = _counter(dev)
    opts = {} if model is None else {"cost_model": model}
    passes = []

    def requests(steps, grain, deadline):
        return [make_request(
            rid, steps=t, width=W, payload=PAYLOAD,
            pattern="stencil_1d" if rid < 6 else "nearest", radius=1 if rid < 6 else 2,
            kernel=KernelSpec("compute_bound", grain), seed=rid, priority=int(rid % 2 == 0),
            deadline_s=deadline if rid == SERVE_DEADLINE_RID else None)
            for rid, t in enumerate(steps)]

    def served(label, depth, reqs, evidence):
        rt = get_runtime("pallas_step", devices=[dev], steps_per_launch=depth, **opts)
        # priced deadlines far out: the one explicit deadline is the only
        # eviction, so the census is pack's
        fabric = ServingFabric(rt, max_slots=slots, clock=LaunchClock(), deadline_factor=1e6)
        rep, d = counted(lambda: fabric.serve(reqs))
        fabric.verify = True
        apart(lambda: fabric._verify(rep.outcomes, rep.cohorts))  # serve(verify=True)'s step
        if rep.bit_identical is not True:
            fail(f"[serving] {label}: outcomes not bit for bit their oracles: "
                 f"{[(o.rid, o.bit_identical) for o in rep.outcomes]}")
        if any(c.recompiles != 0 for c in rep.cohorts):
            fail(f"[serving] {label}: captures mid-cohort {[c.recompiles for c in rep.cohorts]}")
        # the census pack predicts: per cohort key in admission order, the
        # first group founds the cohort and the key's later groups are
        # admitted into freed slots; the explicit deadline evicts once
        groups = pack(rt, reqs, max_slots=slots)
        keys = list(dict.fromkeys(repr(cohort_key(rt, g[0].graph)) for g in groups))
        if [c.key for c in rep.cohorts] != keys:
            fail(f"[serving] {label}: cohorts {[c.key for c in rep.cohorts]}, pack {keys}")
        for c in rep.cohorts:
            mine = [g for g in groups if repr(cohort_key(rt, g[0].graph)) == c.key]
            outs = [o for o in rep.outcomes if o.cohort == c.index]
            founders = sorted(o.rid for o in outs if not o.admitted_mid_run)
            admitted = sorted(o.rid for o in outs if o.admitted_mid_run)
            if founders != sorted(r.rid for r in mine[0]) or admitted != sorted(
                    r.rid for g in mine[1:] for r in g) or c.requests != len(outs):
                fail(f"[serving] {label}: cohort {c.index} founders {founders}, admitted "
                     f"{admitted}; pack {[[r.rid for r in g] for g in mine]}")
        evicted = [o.rid for o in rep.outcomes if o.status == "deadline_evicted"]
        if evicted != [SERVE_DEADLINE_RID] or sum(c.deadline_evictions
                                                  for c in rep.cohorts) != 1:
            fail(f"[serving] {label}: evicted {evicted}")
        ev = {o.rid: o for o in rep.outcomes}[SERVE_DEADLINE_RID]
        if not ev.effective_steps < ev.graph.steps:
            fail(f"[serving] {label}: the evicted request ran {ev.effective_steps} steps")
        # launches: K4 (S > 1) a dispatched launch, K3 each cohort's init
        # and each admission
        runs = sum(c.launches_run for c in rep.cohorts)
        admits = sum(c.admitted_mid_run for c in rep.cohorts)
        want = dict.fromkeys(d, 0)
        want["taskbench_step"] = len(rep.cohorts) + admits
        want[K4_TILED] = runs
        if card and d != want:
            fail(f"[serving] {label}: launches {d}, expected {want}")
        dist = None
        if evidence:
            dist = min(dataflow_distance("serving", f"{label} rid {o.rid}",
                                         torch.from_numpy(o.output)) for o in rep.outcomes)
        passes.append({"pass": label, "S": depth, "requests": len(reqs),
                       "cohorts": [dataclasses.asdict(c) for c in rep.cohorts],
                       "launches": {k: n for k, n in d.items() if n},
                       "evidence_distance": dist})
        print(f"  {label}: {len(rep.cohorts)} cohorts {[c.kind for c in rep.cohorts]}, "
              f"{runs} launches run, {admits} admitted mid-run, evicted {evicted} at "
              f"{ev.effective_steps} of {ev.graph.steps} steps, slot utilization "
              f"{[round(c.slot_utilization, 4) for c in rep.cohorts]}, recaptures "
              f"{[c.recompiles for c in rep.cohorts]}; launches "
              f"{passes[-1]['launches']}"
              + (f"; evidence {dist:.3g} from the fixed point" if dist is not None else ""),
              flush=True)
        return rt

    rt = served(f"grain {GRAIN} S={S}", S, requests(T, GRAIN, SERVE_DEADLINE), False)
    served(f"grain 1 S={S_short}", S_short, requests(T_short, 1, 1.0), True)
    # WallClock passes: the latency a request sees, host-stepped, each
    # cohort's plan built (its launch captured) inside the pass; priced
    # deadlines do not count the build. On the default deadline factor,
    # the requests the priced deadlines evict; with them set aside (factor
    # 1e6), every request completes: its latency from arrival and its
    # service from admission (a cohort's founders are admitted once the
    # plan is built)
    reqs = requests(T, GRAIN, None)
    wall = {}
    for label, factor in (("default", None), ("unpriced", 1e6)):
        fabric = (ServingFabric(rt, max_slots=slots, clock=WallClock()) if factor is None else
                  ServingFabric(rt, max_slots=slots, clock=WallClock(), deadline_factor=factor))
        rep = apart(lambda: fabric.serve(reqs))
        service = [o.finished_s - o.admitted_s for o in rep.completed]
        wall[label] = {
            "deadline_factor": fabric.deadline_factor, "latency_s": rep.latency_percentiles_s(),
            "service_s": {f"p{q}": float(np.percentile(service, q)) if service else None
                          for q in (50, 95, 99)},
            "slot_utilization": [c.slot_utilization for c in rep.cohorts],
            "evicted": {o.rid: o.effective_steps for o in rep.outcomes
                        if o.status == "deadline_evicted"},
            "wall_s": rep.wall_s, "launches": sum(c.launches_run for c in rep.cohorts)}
    # one cohort's set-up inside that wall: its launch plan's build (operand
    # tables, the launch's capture), best of 3; then its t = 0 launch, its
    # first launch and the median of 16 more, each with a synchronize
    first = GraphEnsemble(tuple(r.graph for r in pack(rt, reqs, max_slots=slots)[0]))
    plan_s = []
    for _ in range(3):
        t1 = time.perf_counter()
        lp_first = apart(lambda: rt.build_ensemble_launches(first))
        plan_s.append(time.perf_counter() - t1)
    xs_first = [rand(g.width, PAYLOAD) for g in first.members]
    rows_first = lp_first.act_rows()

    def timed(fn):
        t1 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t1

    def steps():
        carry, init_s = timed(lambda: lp_first.init_fn(xs_first))
        walls = []
        for l in range(17):
            carry, w = timed(lambda: lp_first.launch_fn(carry, rows_first[l],
                                                        lp_first.launch_t0(l)))
            walls.append(w)
        return init_s, walls

    init_s, launch_s = apart(steps)
    unit_us = lp_first.deadline_expected_us
    for label, w in wall.items():
        pct, svc = w["latency_s"], w["service_s"]
        print(f"[serving] WallClock pass, {len(reqs)} requests at grain {GRAIN}, S={S}, "
              f"deadline factor {w['deadline_factor']} x {unit_us} us a launch: "
              f"{len(w['evicted'])} priced-deadline evictions (rid: steps run "
              f"{w['evicted']}); latency of the {len(reqs) - len(w['evicted'])} completed p50 "
              f"{pct['p50'] * 1e3:.3f} ms, p95 {pct['p95'] * 1e3:.3f}, p99 "
              f"{pct['p99'] * 1e3:.3f}; service p50 "
              + (f"{svc['p50'] * 1e3:.3f} ms, p95 {svc['p95'] * 1e3:.3f}, p99 "
                 f"{svc['p99'] * 1e3:.3f}" if svc["p50"] is not None else "none")
              + f"; slot utilization {[round(u, 4) for u in w['slot_utilization']]}; wall "
              f"{w['wall_s'] * 1e3:.3f} ms for {w['launches']} launches | {smi}", flush=True)
    print(f"[serving] a cohort's set-up: launch plan build {min(plan_s) * 1e3:.3f} ms (best of "
          f"3), t = 0 launch {init_s * 1e3:.3f} ms, first launch {launch_s[0] * 1e6:.3f} us, "
          f"then median {sorted(launch_s[1:])[8] * 1e6:.3f} us a launch (host wall, a "
          f"synchronize each; priced {unit_us} us) | {smi}", flush=True)
    sync()
    total = ops.launch_counts()
    launches = {k: n - kept[k] for k, n in total.items()}
    for k, n in launches.items():
        if card and (n == 0) == (k in ("taskbench_step", K4_TILED)):
            fail(f"[serving] kernel {k}: {n} launches on the fabric's passes")
    print(f"[serving] {len(passes)} LaunchClock passes: every outcome bit for bit its same-K "
          f"oracle, no capture mid-cohort, the census pack's; launches {launches} (and "
          f"{kept} by the oracles and the WallClock pass); {time.perf_counter() - t0:.3f} s "
          f"| {smi}", flush=True)
    print(json.dumps({"serving": {"passes": passes, "wallclock": wall, "setup": {
        "plan_build_s": plan_s, "init_s": init_s, "launch_s": launch_s,
        "priced_launch_us": unit_us}, "card": smi}}), flush=True)
    return launches


def restart_phase(dev, rand, smi, *, W=W_MAIN, T=T_MAIN, S=S_MAIN, every=RESTART_EVERY,
                  fail_at=RESTART_FAIL_AT, T_short=T_RES_SHORT, S_short=S_ENS_SHORT,
                  reps=5):
    """The [restart] phase; returns the launches of its restart loops (the
    uninterrupted oracles kept apart)."""
    import os
    import tempfile

    import torch

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.checkpoint.elastic import FailureInjector, run_with_restarts
    from repro_torch.core import GraphEnsemble, KernelSpec, TaskGraph, get_runtime
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    card = dev.type == "cuda"
    ops.reset_launch_counts()
    sync, counted, apart, kept = _counter(dev)
    rows = []
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_restart_")
    try:
        for label, steps, grain, depth, ev, fails in (
                (f"grain {GRAIN} S={S} T={T}", (T,) * K_RES, GRAIN, S, every, fail_at),
                (f"grain 1 S={S_short} T={T_short}", T_short, 1, S_short, 1, (1, 2))):
            ens = GraphEnsemble([TaskGraph(steps=t, width=W, pattern="stencil_1d",
                                           payload=PAYLOAD, seed=k,
                                           kernel=KernelSpec("compute_bound", grain))
                                 for k, t in enumerate(steps)])
            xs = tuple(rand(W, PAYLOAD) for _ in steps)
            rt = get_runtime("pallas_step", devices=[dev], steps_per_launch=depth)
            lp = rt.build_ensemble_launches(ens)
            L = lp.num_launches
            act_rows = lp.act_rows()  # staged on the card in one copy
            calls = {"init": 0, "step": 0}

            def init_state():
                calls["init"] += 1
                return {"carry": lp.init_fn(xs)}

            def step_fn(state, l):
                calls["step"] += 1
                return {"carry": lp.launch_fn(state["carry"], act_rows[l], lp.launch_t0(l))}

            ckpt = Checkpointer(os.path.join(tmp.name, f"run{len(rows)}"), keep=2)
            corrupted = []

            class CorruptingInjector(FailureInjector):
                def maybe_fail(self, step):
                    if step == fails[-1] and step not in self.fired:
                        newest = ckpt.latest_step()
                        path = os.path.join(ckpt.dir, f"step_{newest:08d}", "arrays.npz")
                        with open(path, "r+b") as f:
                            f.seek(64)
                            f.write(b"\xde\xad\xbe\xef")
                        corrupted.append(newest)
                    super().maybe_fail(step)

            (final, restarts), d = counted(lambda: run_with_restarts(
                total_steps=L, ckpt=ckpt, ckpt_every=ev, init_state=init_state,
                step_fn=step_fn, injector=CorruptingInjector(fails)))
            want = [w.cpu() for w in apart(lambda: rt.build_ensemble(ens)(xs))]
            got = [w.cpu() for w in lp.finalize(final["carry"])]
            for k, (a, b) in enumerate(zip(got, want)):
                if not torch.equal(a, b):
                    fail(f"[restart] {label}: member {k} differs from the uninterrupted run, "
                         f"max |difference| {(a - b).abs().max().item()}")
            if restarts != len(fails) or not corrupted:
                fail(f"[restart] {label}: {restarts} restarts, corrupted {corrupted}")
            # the restore after the corruption fell back past it: the loop
            # ran the launches after the second-newest checkpoint again
            redo = calls["step"] - L
            fell_back = fails[-1] - (corrupted[0] - ev)
            expect_redo = (fails[0] - (fails[0] // ev) * ev) + fell_back
            if redo != expect_redo:
                fail(f"[restart] {label}: {redo} launches run again, expected {expect_redo} "
                     f"(the fallback past step {corrupted[0]})")
            # launches: K3 for each init (the first, and the structure donor of
            # each restore tried), K4 for each launch run
            want_d = dict.fromkeys(d, 0)
            want_d.update({"taskbench_step": calls["init"], K4_TILED: calls["step"]})
            if card and d != want_d:
                fail(f"[restart] {label}: launches {d}, expected {want_d} ({calls})")
            dist = (min(dataflow_distance("restart", f"{label} member {k}", w)
                        for k, w in enumerate(want)) if grain == 1 else None)
            # save and restore walls of the state, on the card
            state = {"carry": apart(lambda: lp.init_fn(xs))}
            nbytes = state["carry"].numel() * state["carry"].element_size()
            probe = Checkpointer(os.path.join(tmp.name, f"probe{len(rows)}"), keep=1)
            save_ms, restore_ms = [], []
            for i in range(reps):
                sync()
                t1 = time.perf_counter()
                probe.save(i, state)
                save_ms.append((time.perf_counter() - t1) * 1e3)
                t1 = time.perf_counter()
                back, _ = probe.restore(state)
                sync()
                restore_ms.append((time.perf_counter() - t1) * 1e3)
                if not torch.equal(back["carry"], state["carry"]):
                    fail(f"[restart] {label}: the restored state differs")
            rows.append({"run": label, "launches": L, "every": ev, "fail_at": list(fails),
                         "corrupted": corrupted, "restarts": restarts, "calls": calls,
                         "kernel_launches": {k: n for k, n in d.items() if n},
                         "state_bytes": nbytes, "save_ms": save_ms, "restore_ms": restore_ms,
                         "evidence_distance": dist})
            print(f"  {label}: {L} launches, checkpoints every {ev} (keep 2), failures at "
                  f"{list(fails)}, step {corrupted[0]} corrupted: {restarts} restarts, "
                  f"{redo} launches run again, final state bit for bit the uninterrupted "
                  f"run; {nbytes} B state: save {min(save_ms):.3f} ms (median "
                  f"{sorted(save_ms)[reps // 2]:.3f}), restore {min(restore_ms):.3f} ms "
                  f"(median {sorted(restore_ms)[reps // 2]:.3f}); launches {rows[-1]['kernel_launches']}"
                  + (f"; evidence {dist:.3g} from the fixed point" if dist is not None else ""),
                  flush=True)
    finally:
        tmp.cleanup()
    sync()
    total = ops.launch_counts()
    launches = {k: n - kept[k] for k, n in total.items()}
    print(f"[restart] {len(rows)} restart loops, each bit for bit its uninterrupted run after "
          f"falling back past a corrupt checkpoint; launches {launches} (and {kept} by the "
          f"uninterrupted oracles); {time.perf_counter() - t0:.3f} s | {smi}", flush=True)
    print(json.dumps({"restart": {"runs": rows, "card": smi}}), flush=True)
    return launches


def serve_path(dev, smi, tag: str, cfg, batch: int, prompt: int, gen: int, want: dict,
               tol: dict, *, image_gate=None, keep_logits: bool = False,
               profile_prefill: bool = False):
    """Serve ``cfg`` through ``serve`` (random weights from seed 0, greedy;
    each decode step after the first a graph replay), the launch counters
    zeroed just before and held to ``want`` just after, and again with
    every decode step eager (the same tokens and logits); then one model of
    the same weights (seed 0) through the kernels and through the plain
    path (``use_flash=False`` on the same weights, so they are held once),
    teacher-forced with the served inputs (the prefill and 4 decode steps
    held to ``tol``: limits on max |diff| / max |logit| and ||diff|| /
    ||logits||, None where a metric is only printed; a MoE model's plain
    path replays the kernel path's routing), 3 more eager decode
    steps and 3 graph replays under torch.profiler, and the prefill again,
    warm. With ``image_gate`` the teacher-forced runs take 0.02·N(0, 1)
    image embeddings (seed IMAGE_SEED) and every cross-attention gate at
    ``image_gate`` (``serve`` itself runs as the reference's: zero image
    embeddings, zero gates). The (token, layer) prefill decisions on which
    the two paths' own MoE routers differ are printed.
    With ``profile_prefill`` one more warm prefill runs under
    torch.profiler (its kernels' device times by name). Returns (cfg, serve
    result, launches, stats); the result's decode logits (on the CPU) with
    ``keep_logits``."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.runtimes._capture import Graphed
    from repro_torch.kernels import _build, ops
    from repro_torch.launch.serve import _grow_caches, make_inputs, serve, step_embeds
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    arch = cfg.name
    cap = prompt + gen
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    res = serve(cfg, batch=batch, prompt_len=prompt, gen=gen, seed=0, verbose=True,
                device="cuda", keep_logits=True)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    # the same run with every decode step eager: the same tokens and the
    # same logits, bit for bit (the graph replays the same kernels on the
    # same buffers, and draws what the eager steps draw)
    res_eager = serve(cfg, batch=batch, prompt_len=prompt, gen=gen, seed=0,
                      verbose=False, device="cuda", graph=False, keep_logits=True)
    if not np.array_equal(res.tokens, res_eager.tokens):
        fail(f"{tag} the graph's greedy tokens differ from the eager loop's")
    if not torch.equal(res.logits, res_eager.logits):
        fail(f"{tag} the graph's decode logits differ from the eager loop's, max "
             f"|difference| {(res.logits - res_eager.logits).abs().max().item()}")
    rep_eager = res_eager.report
    print(f"{tag} decode as one CUDA graph a step (captured in "
          f"{res.capture_s:.6f} s, {res.graph_nodes} nodes): tokens and logits of "
          f"{gen - 1} steps equal the eager loop's bit for bit; p50 step wall "
          f"{res.report.p50_wall * 1e3:.3f} ms, eager {rep_eager.p50_wall * 1e3:.3f} ms "
          f"| {smi}", flush=True)
    res.logits = res.logits.cpu() if keep_logits else None
    res_eager.logits = None
    want_d = dict.fromkeys(_build.ENTRIES, 0)
    want_d.update(want)
    if launches != want_d:
        fail(f"{tag} launches {launches}, expected {want_d}")
    if want.get("flash_attention"):
        # the counters name the form: the prefill's attention was bf16
        print(f"{tag} K5 received {cfg.dtype} operands: "
              f"{launches['flash_attention']} launches of its tensor-core form, "
              f"{launches['flash_attention_f32']} of its f32 form", flush=True)
    if res.tokens.shape != (batch, gen) or res.poisoned_steps:
        fail(f"{tag} tokens {res.tokens.shape}, poisoned steps {res.poisoned_steps}")
    rep = res.report
    stats = {
        "arch": arch, "n_layers": cfg.n_layers, "batch": batch, "prompt": prompt,
        "gen": gen, "prefill_s": res.prefill_s,
        "prefill_tok_per_s": batch * prompt / res.prefill_s,
        "decode_tok_per_s": res.tokens_per_s,
        "decode_tok_per_s_steady": rep.tokens_per_s,
        "step_wall_p50_ms": rep.p50_wall * 1e3,
        "step_wall_mean_ms": rep.mean_wall * 1e3,
        "eager_step_wall_p50_ms": rep_eager.p50_wall * 1e3,
        "eager_step_wall_mean_ms": rep_eager.mean_wall * 1e3,
        "eager_decode_tok_per_s_steady": rep_eager.tokens_per_s,
        "capture_s": res.capture_s, "graph_nodes": res.graph_nodes,
        "flagged_steps": len(res.flagged_steps),
        "peak_gib_serve": torch.cuda.max_memory_allocated() / 2**30,
    }
    del res_eager
    torch.cuda.empty_cache()
    # one model (seed 0) through the kernels and then the plain path, on the
    # served inputs, teacher-forced with the served tokens (or embeddings)
    model = Model(cfg, device=dev, seed=0)
    inputs = make_inputs(cfg, batch, prompt, 0, dev)
    forced = image_gate is None  # the served inputs: the served tokens must follow
    if image_gate is not None:
        img = torch.Generator(device=dev).manual_seed(IMAGE_SEED)
        inputs["image_embeds"] = 0.02 * torch.randn(inputs["image_embeds"].shape,
                                                    generator=img, device=dev)
        for li, kind in enumerate(model.kinds):
            if kind == "xattn":
                model.layers[li].gate_attn.fill_(image_gate)
                model.layers[li].gate_mlp.fill_(image_gate)
    served = torch.from_numpy(res.tokens).to(dev)
    # serve's per-step embeddings: the same draws from a fresh generator
    embedder = torch.Generator(device=dev).manual_seed(0 + 3)
    step_in = ([step_embeds(cfg, batch, embedder, dev) for _ in range(11)]
               if cfg.embed_inputs else None)

    def feed(i, tok=None):
        if cfg.embed_inputs:
            return {"embeds": step_in[i] if tok is None else tok}
        return {"tokens": served[:, i:i + 1] if tok is None else tok}

    # A MoE model's plain path replays the kernel path's discrete routing
    # (each router call's experts, slots and drops, in call order) weighted
    # by its own router's gates at those experts: a near-tie that bf16
    # rounds the other way then changes no expert, and the limit holds K5,
    # K6 and the combine rather than the router's discontinuity. Each
    # path's own top-k choice is recorded too.
    own = {True: [], False: []}  # (mode, own top-k experts (G, Ng, K)) a call
    kernel_routes = []
    route = moe_mod.route

    def recording(use_flash):
        def spy(p, xt, cfg_, mode):
            r = route(p, xt, cfg_, mode)
            logits = xt.float() @ p["router"].float()
            experts = torch.sort(logits, dim=-1, descending=True,
                                 stable=True)[1][..., :cfg_.top_k]
            own[use_flash].append((mode, experts))
            if use_flash:
                kernel_routes.append((r, experts))
                return r
            rk, ek = kernel_routes[len(own[False]) - 1]
            gates = torch.softmax(torch.gather(logits, -1, ek), dim=-1).to(xt.dtype)
            return rk._replace(gates=gates)
        return spy

    state = {}
    for use_flash in (True, False):  # the kernels' caches stay for the profile
        model.cfg = dataclasses.replace(cfg, use_flash=use_flash)
        moe_mod.route = recording(use_flash)
        try:
            lg, c = model.prefill(**inputs)
            lgs = [lg]
            c = _grow_caches(model, c, batch, cap)
            lengths = torch.full((batch,), prompt, dtype=torch.int32, device=dev)
            for i in range(4):
                lg, c = model.decode_step(lengths=lengths, caches=c, **feed(i))
                lgs.append(lg)
                lengths = lengths + 1
        finally:
            moe_mod.route = route
        state[use_flash] = (lgs, c, lengths) if use_flash else (lgs, None, None)
        del c
    model.cfg = cfg
    if len(own[True]) != len(own[False]):
        fail(f"{tag} {len(own[True])} router calls on the kernel path, "
             f"{len(own[False])} on the plain path")
    del kernel_routes
    rel, rms = [], []
    for i, (lk, lp) in enumerate(zip(state[True][0], state[False][0])):
        what = "prefill" if i == 0 else f"decode step {i - 1}"
        if not (bool(torch.isfinite(lk).all()) and bool(torch.isfinite(lp).all())):
            fail(f"{tag} {what}: non-finite logits")
        if forced and not torch.equal(lk.argmax(-1), served[:, i]):
            fail(f"{tag} {what}: the kernel path's argmax differs from the served token")
        rel.append(((lk - lp).abs().max() / lp.abs().max()).item())
        rms.append((torch.linalg.vector_norm(lk - lp) / torch.linalg.vector_norm(lp)).item())
    print(f"{tag} kernel vs plain path{' (one routing)' if cfg.n_experts else ''}, prefill "
          f"and 4 decode steps: max |diff| / max |logit| {rel} (limit {tol['max']}); "
          f"||diff|| / ||logits|| {rms} (limit {tol['rms']})", flush=True)
    for metric, got in (("max", rel), ("rms", rms)):
        if tol[metric] is not None and not max(got) <= tol[metric]:
            fail(f"{tag} kernel vs plain path ({metric}): {got}, above {tol[metric]}")
    agree = [float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
             for lk, lp in zip(state[True][0], state[False][0])]
    if cfg.n_experts:
        # how often the two paths' own routers would have chosen apart in the
        # prefill: in some expert or its rank, and as unordered top-k sets
        pre = [(a, b) for (ma, a), (_, b) in zip(own[True], own[False]) if ma == "prefill"]
        if len(pre) != cfg.n_layers:
            fail(f"{tag} recorded {len(pre)} prefill routings, expected {cfg.n_layers}")
        ranked = [int((a != b).any(-1).sum()) for a, b in pre]
        unordered = [int((a.sort(-1)[0] != b.sort(-1)[0]).any(-1).sum()) for a, b in pre]
        decisions = cfg.n_layers * batch * prompt
        stats.update(routing_decisions=decisions, routing_decisions_differ=sum(ranked),
                     routing_sets_differ=sum(unordered))
        print(f"{tag} prefill routing, each path's own router: {sum(ranked)} of {decisions} "
              f"(token, layer) top-{cfg.top_k} choices differ in some expert or its rank, "
              f"{sum(unordered)} as unordered sets (per layer {ranked}, {unordered})",
              flush=True)
    del own
    # where a decode step's device time goes: 3 more steps of the kernel
    # path under torch.profiler, its kernels' device times summed by name
    km, (_, c, lengths) = model, state[True]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for i in range(4, 7):
            _, c = km.decode_step(lengths=lengths, caches=c, **feed(i))
            lengths = lengths + 1
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t1) * 1e3

    by_name = device_ms(prof)
    busy_ms = sum(by_name.values())
    # and as graph replays: step 7 eagerly on the capture stream (the
    # warm-up), the step captured, then steps 8-10 replayed
    tokb = feed(7)[("embeds" if cfg.embed_inputs else "tokens")].clone()

    def tf_step():
        lg, _ = km.decode_step(lengths=lengths, caches=c, **feed(None, tokb))
        lengths.add_(1)
        return lg

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        tf_step()
        step_graph = Graphed(tf_step, stream)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as gprof:
            t1 = time.perf_counter()
            for i in range(8, 11):
                tokb.copy_(feed(i)[("embeds" if cfg.embed_inputs else "tokens")])
                step_graph.replay()
            torch.cuda.synchronize()
            graph_window_ms = (time.perf_counter() - t1) * 1e3
    torch.cuda.current_stream().wait_stream(stream)
    step_graph.close()
    g_by_name = device_ms(gprof)
    graph_busy_ms = sum(g_by_name.values())
    g_top = sorted(g_by_name.items(), key=lambda kv: -kv[1])[:8]
    # and where its host time goes: the operators by self CPU time
    cpu_avg = prof.key_averages()
    cpu_top = sorted(cpu_avg, key=lambda a: -a.self_cpu_time_total)[:12]
    cpu_ops_ms = sum(a.self_cpu_time_total for a in cpu_avg) / 1e3
    # the prefill again, its bf16 weight copies and libraries now warm
    t1 = time.perf_counter()
    km.prefill(**inputs)
    torch.cuda.synchronize()
    stats["prefill_warm_s"] = time.perf_counter() - t1
    if profile_prefill:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pprof:
            t1 = time.perf_counter()
            km.prefill(**inputs)
            torch.cuda.synchronize()
            pre_ms = (time.perf_counter() - t1) * 1e3
        p_by_name = device_ms(pprof)
        p_top = sorted(p_by_name.items(), key=lambda kv: -kv[1])[:10]
        stats["profile_prefill"] = {
            "window_ms": pre_ms, "device_busy_ms": sum(p_by_name.values()),
            "top_kernels_ms": {name[:80]: ms for name, ms in p_top}}
        print(f"{tag} one warm prefill under torch.profiler: {pre_ms:.3f} ms, device "
              f"busy {sum(p_by_name.values()):.3f} ms; top kernels "
              f"{[(n[:60], round(ms, 3)) for n, ms in p_top]}", flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    stats["profile_3_steps"] = {
        "window_ms": window_ms, "device_busy_ms": busy_ms,
        "busy_share": busy_ms / window_ms,
        "top_kernels_ms": {name[:80]: ms for name, ms in top},
        "cpu_ops_self_ms": cpu_ops_ms,
        "top_cpu_self_ms": {a.key[:80]: [a.self_cpu_time_total / 1e3, a.count]
                            for a in cpu_top}}
    stats["profile_3_replays"] = {
        "window_ms": graph_window_ms, "device_busy_ms": graph_busy_ms,
        "busy_share": graph_busy_ms / graph_window_ms,
        "top_kernels_ms": {name[:80]: ms for name, ms in g_top}}
    stats.update(kernel_vs_plain_rel=rel, kernel_vs_plain_rms=rms,
                 argmax_agreement=agree,
                 peak_gib_with_the_teacher_forced_runs=torch.cuda.max_memory_allocated()
                 / 2**30)
    del model, state, c, km, inputs, step_in
    torch.cuda.empty_cache()
    print(f"{tag} 3 decode steps under torch.profiler: {window_ms:.3f} ms, device "
          f"busy {busy_ms:.3f} ms ({busy_ms / window_ms:.4f}); top kernels "
          f"{[(n[:60], round(ms, 3)) for n, ms in top]}", flush=True)
    print(f"{tag} 3 decode steps as graph replays under torch.profiler: "
          f"{graph_window_ms:.3f} ms, device busy {graph_busy_ms:.3f} ms "
          f"({graph_busy_ms / graph_window_ms:.4f}); top kernels "
          f"{[(n[:60], round(ms, 3)) for n, ms in g_top]}", flush=True)
    print(f"{tag} the 3 eager steps, host operators' self CPU time {cpu_ops_ms:.3f} ms "
          f"in all; the top by self CPU time (ms, calls): "
          f"{[(a.key[:60], a.self_cpu_time_total / 1e3, a.count) for a in cpu_top]}",
          flush=True)
    print(f"{tag} {arch} ({cfg.n_layers} layers, d_model {cfg.d_model}, bf16 "
          f"compute), batch {batch}, prompt {prompt}, gen {gen}: prefill "
          f"{stats['prefill_tok_per_s']:.1f} tok/s ({res.prefill_s * 1e3:.3f} ms; "
          f"warm {stats['prefill_warm_s'] * 1e3:.3f} ms), "
          f"decode {res.tokens_per_s:.1f} tok/s ({rep.tokens_per_s:.1f} steady), "
          f"p50 step wall {rep.p50_wall * 1e3:.3f} ms (eager "
          f"{rep_eager.p50_wall * 1e3:.3f} ms); capture {res.capture_s:.6f} s, "
          f"{res.graph_nodes} nodes; peak {stats['peak_gib_serve']:.3f} GiB serving, "
          f"{stats['peak_gib_with_the_teacher_forced_runs']:.3f} GiB with the "
          f"teacher-forced runs; launches {launches}; "
          f"kernel vs plain path, max |diff| / max |logit|: {rel}, ||diff|| / "
          f"||logits||: {rms} (argmax agreement {agree}); "
          f"{time.perf_counter() - t0:.3f} s | {smi}", flush=True)
    print(json.dumps({tag.strip("[]"): stats}), flush=True)
    return cfg, res, launches, stats


def attention_kinds_parity(dev, gen) -> dict:
    """K5 and K6 at every shape the new serving paths give them, against
    their plain versions under the ``check_attn`` limits, in bf16 and f32:
    K5 non-causal at llama-3.2-vision's cross-attention (q 4 x 64 heads x
    1024 x 128 over k/v 4 x 8 x 1600 x 128) and K6 at group 8 over its
    1600-position image cache read whole; and for each served arch's
    self-attention (SERVED_ATTN: its batch, heads, head dim and each window
    of its layer kinds) K5 at its causal prefill and K6 at its decode, the
    cache at the run's capacity and the batch's lengths spread over the
    run's decode reads (prompt + 1 to prompt + gen - 1). Returns the max abs
    error per launch counter."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import ENTRY as K5_FORM
    from repro_torch.models.attention import _window_for

    def normal(*shape, dtype):
        return torch.randn(shape, device=dev, generator=gen).to(dtype)

    errs = dict.fromkeys((*K5_FORM.values(), "decode_attention"), 0.0)
    vlm = get_config(VLM_ARCH)
    vq, vkv, vhd, n_img = vlm.n_heads, vlm.n_kv_heads, vlm.head_dim_, vlm.n_image_tokens
    for dtype in (torch.bfloat16, torch.float32):
        form = K5_FORM[dtype]
        q = normal(VLM_B, vq, VLM_PROMPT, vhd, dtype=dtype)
        k, v = (normal(VLM_B, vkv, n_img, vhd, dtype=dtype) for _ in range(2))
        errs[form] = max(errs[form], check_attn(
            f"K5 {dtype} cross-attention {VLM_ARCH}",
            ops.flash_attention(q, k, v, causal=False),
            ref.attention_plain(q, k, v, causal=False)))
        q = normal(VLM_B, vq, vhd, dtype=dtype)
        full = torch.full((VLM_B,), n_img, dtype=torch.int32, device=dev)
        errs["decode_attention"] = max(errs["decode_attention"], check_attn(
            f"K6 {dtype} group {vq // vkv} over the {n_img}-position image cache",
            ops.decode_attention(q, k, v, full), ref.decode_attention_plain(q, k, v, full)))
        del q, k, v
        for arch, B, prompt, gen_ in SERVED_ATTN:
            c = get_config(arch)
            Hq, Hkv, hd = c.n_heads, c.n_kv_heads, c.head_dim_
            windows = sorted({_window_for(c, kind) for kind in c.layer_plan_flat()
                              if kind not in ("ssm", "xattn")})
            what = f"{arch} (B {B}, {Hq}/{Hkv} heads of {hd})"
            q = normal(B, Hq, prompt, hd, dtype=dtype)
            k, v = (normal(B, Hkv, prompt, hd, dtype=dtype) for _ in range(2))
            for window in windows:
                errs[form] = max(errs[form], check_attn(
                    f"K5 {dtype} {what} prefill {prompt}, window {window}",
                    ops.flash_attention(q, k, v, causal=True, window=window),
                    ref.attention_plain(q, k, v, causal=True, window=window)))
            cap = prompt + gen_
            q = normal(B, Hq, hd, dtype=dtype)
            k, v = (normal(B, Hkv, cap, hd, dtype=dtype) for _ in range(2))
            lengths = (prompt + 1 + torch.arange(B, device=dev) * (gen_ - 2) // (B - 1)
                       ).to(torch.int32)
            for window in windows:
                errs["decode_attention"] = max(errs["decode_attention"], check_attn(
                    f"K6 {dtype} {what} over a {cap}-position cache, lengths "
                    f"{lengths.tolist()}, window {window}",
                    ops.decode_attention(q, k, v, lengths, window=window),
                    ref.decode_attention_plain(q, k, v, lengths, window=window)))
            del q, k, v
    torch.cuda.synchronize()
    return errs


def serve_kinds_phase(dev, smi, serve_logits=None, serve_tokens=None) -> dict:
    """[serve-moe], [serve-xattn], [serve-embed], [serve-int8] through
    ``serve_path`` and [serve-archs] (one ``serve`` each), each run's launch
    counters zeroed just before it and held exactly to its K5 and K6
    launches just after. With [serve]'s decode logits and tokens, [serve-int8]
    prints its own decode logits against them. Runs alone after
    ``_build.build_all()``. Returns {path: launches}."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.launch.serve import serve

    t0 = time.perf_counter()
    launches = {}
    # granite-moe-3b-a800m at full width and depth: K5 once per layer in the
    # prefill, K6 per layer and decode step; the experts are batched matrix
    # products (no kernel of the port, as in the reference)
    cfg = get_config(MOE_ARCH)
    L, steps = cfg.n_layers, MOE_GEN - 1
    _, _, launches["serve-moe"], _ = serve_path(
        dev, smi, "[serve-moe]", cfg, MOE_B, MOE_PROMPT, MOE_GEN,
        dict(flash_attention=L, decode_attention=L * steps), TOL_SERVE_MOE,
        profile_prefill=True)
    # llama-3.2-vision-90b at full width, cut to one block of 4 attn layers
    # and 1 xattn layer: K5 per layer (the xattn layer's non-causal over the
    # 1600 image tokens, in its f32 form: f32 image embeddings give f32
    # image K/V, as in the reference), K6 per layer and step (the xattn
    # layer's over its static f32 image cache)
    cfg = dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_LAYERS)
    if cfg.layer_plan() != ((("attn",) * (VLM_LAYERS - 1) + ("xattn",), 1),):
        fail(f"[serve-xattn] layer plan {cfg.layer_plan()}")
    L, steps = cfg.n_layers, VLM_GEN - 1
    _, _, launches["serve-xattn"], _ = serve_path(
        dev, smi, "[serve-xattn]", cfg, VLM_B, VLM_PROMPT, VLM_GEN,
        dict(flash_attention=L - 1, flash_attention_f32=1, decode_attention=L * steps),
        TOL_SERVE_VLM, image_gate=IMAGE_GATE)
    # musicgen-medium at full width and depth: embedding prompts, a fresh
    # embedding drawn inside each decode step's graph
    cfg = get_config(EMB_ARCH)
    L, steps = cfg.n_layers, EMB_GEN - 1
    _, _, launches["serve-embed"], _ = serve_path(
        dev, smi, "[serve-embed]", cfg, EMB_B, EMB_PROMPT, EMB_GEN,
        dict(flash_attention=L, decode_attention=L * steps), TOL_SERVE_EMBED)
    # internlm2-1.8b with the int8 KV cache at [serve]'s shape
    cfg = dataclasses.replace(get_config(SERVE_ARCH), kv_quant=True)
    L, steps = cfg.n_layers, SERVE_GEN - 1
    _, res8, launches["serve-int8"], _ = serve_path(
        dev, smi, "[serve-int8]", cfg, SERVE_B, SERVE_PROMPT, SERVE_GEN,
        dict(flash_attention=L, decode_attention=L * steps), TOL_SERVE_INT8,
        keep_logits=serve_logits is not None)
    if serve_logits is not None:
        # step i's logits compare where both runs fed the same tokens so far
        same = np.cumprod(res8.tokens == serve_tokens, axis=1).astype(bool)
        gaps = []
        for i in range(steps):
            rows = torch.from_numpy(same[:, i])
            if not bool(rows.any()):
                break
            a, b = res8.logits[i][rows], serve_logits[i][rows]
            gaps.append(((a - b).abs().max() / b.abs().max()).item())
        print(f"[serve-int8] the int8 cache's decode logits against [serve]'s bf16 "
              f"cache, max |diff| / max |logit| per step over the sequences whose "
              f"tokens agree so far ({len(gaps)} steps; {int(same[:, -1].sum())} of "
              f"{SERVE_B} sequences agree throughout): max {max(gaps) if gaps else None}, "
              f"{gaps}", flush=True)
        res8.logits = None
    # the other registered archs, one serve each (graph decode), freed in turn
    for arch in ARCHS_SERVED:
        t1 = time.perf_counter()
        cfg = get_config(arch)
        if arch in ARCHS_LAYERS:
            cfg = dataclasses.replace(cfg, n_layers=ARCHS_LAYERS[arch])
        attn = sum(kind != "ssm" for kind in cfg.layer_plan_flat())
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        res = serve(cfg, batch=ARCHS_B, prompt_len=ARCHS_PROMPT, gen=ARCHS_GEN, seed=0,
                    verbose=False, device="cuda")
        torch.cuda.synchronize()
        got = ops.launch_counts()
        want = dict(dict.fromkeys(_build.ENTRIES, 0), flash_attention=attn,
                    decode_attention=attn * (ARCHS_GEN - 1))
        if got != want:
            fail(f"[serve-archs] {arch}: launches {got}, expected {want}")
        if res.tokens.shape != (ARCHS_B, ARCHS_GEN) or res.poisoned_steps:
            fail(f"[serve-archs] {arch}: tokens {res.tokens.shape}, poisoned steps "
                 f"{res.poisoned_steps}")
        launches[f"serve-archs {arch}"] = got
        rep = res.report
        print(f"[serve-archs] {arch} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.param_count() / 1e9:.3f}B parameters), batch {ARCHS_B}, prompt "
              f"{ARCHS_PROMPT}, gen {ARCHS_GEN}: prefill {res.prefill_s * 1e3:.3f} ms, "
              f"p50 decode step {rep.p50_wall * 1e3:.3f} ms as a graph replay (captured in "
              f"{res.capture_s:.6f} s, {res.graph_nodes} nodes), {rep.tokens_per_s:.1f} "
              f"tok/s steady; launches K5 {got['flash_attention']}, K6 "
              f"{got['decode_attention']}; {len(res.flagged_steps)} steps flagged, none "
              f"poisoned; peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
              f"{time.perf_counter() - t1:.3f} s | {smi}", flush=True)
        del res
        torch.cuda.empty_cache()
    print(f"[serve-kinds] {time.perf_counter() - t0:.3f} s | {smi}", flush=True)
    return launches


def device_ms(prof) -> dict:
    """A torch.profiler window's device kernels: ms summed by name."""
    import torch

    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return by_name


def train_phase(dev, smi, *, full_cfg=None, full_b=TRAIN_FULL_B, full_s=TRAIN_FULL_S,
                archs=TRAIN_ARCHS) -> dict:
    """[train]: (a) ``make_train_step`` on the card against the same step
    on the CPU, one weight set, at accum 1 and 2, for each of ``archs``
    reduced: the loss, grad_norm and every parameter after the update held
    to TOL_TRAIN_*, the launch counters zeroed just before each card step
    and read just after: no kernel of the port runs in a train step (the
    attention and SSD run their plain versions in train mode, as the
    reference's; the serve phases launch K5, K6 and K7); (b) the restart
    drill on reduced internlm2, its losses bit for bit an uninterrupted
    run's; (c) ``train()`` at ``full_cfg`` (default internlm2-1.8b at full
    width and depth), every loss and grad_norm finite, the last loss below
    the first, its step wall, tokens/s, peak memory and model FLOP/s
    against the bf16 dense peak printed; on the card one more step of it
    under torch.profiler (device busy, kernels by name). Runs alone
    (it builds nothing: no kernel of the port is on the train path);
    returns the numbers it printed."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config, get_shape
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.kernels import _build, ops
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.train import train
    from repro_torch.models.model import Model
    from repro_torch.optim.optimizer import AdamW, AdamWConfig

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    shape = get_shape("train_4k")
    zero = dict.fromkeys(_build.ENTRIES, 0)
    out = {"card_vs_cpu": []}
    # (a) the card's train step against the CPU's, one weight set
    for arch in archs:
        cfg = get_config(arch).reduced()
        weights = Model(cfg, device="cpu", seed=0).state_dict()
        batch = SyntheticTokenPipeline(cfg, shape, seed=0, batch_override=TRAIN_B,
                                       seq_override=TRAIN_S).batch_at(0)
        for accum in (1, 2):
            got = {}
            for where in ("cpu", dev):
                model = Model(cfg, device=where)
                model.load_state_dict(weights)
                opt = AdamW(AdamWConfig(**TRAIN_OPT))
                step = steps_lib.make_train_step(model, opt, accum)
                named = dict(model.named_parameters())
                state = opt.init(named)
                ops.reset_launch_counts()
                _, metrics = step(state, {k: v.to(where) for k, v in batch.items()})
                if where != "cpu":
                    torch.cuda.synchronize()
                    launches = ops.launch_counts()
                    if launches != zero:
                        fail(f"[train] {arch} accum {accum}: the train step launched "
                             f"{ {k: v for k, v in launches.items() if v} }")
                got[str(where)] = ({k: float(v) for k, v in metrics.items()},
                                   {n: p.detach().cpu() for n, p in named.items()})
            (m_cpu, p_cpu), (m_card, p_card) = got["cpu"], got[str(dev)]
            rel = {k: abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k]) for k in ("loss", "grad_norm")}
            perr = max(float((p_card[n] - p_cpu[n]).abs().max()) for n in p_cpu)
            if not all(np.isfinite(list(m_card.values()))):
                fail(f"[train] {arch} accum {accum}: metrics {m_card}")
            if max(rel.values()) > TOL_TRAIN_REL or perr > TOL_TRAIN_PARAM:
                fail(f"[train] {arch} accum {accum}: card against CPU, relative "
                     f"loss/grad_norm error {rel}, max parameter error {perr}")
            out["card_vs_cpu"].append({"arch": arch, "accum": accum, "loss": m_card["loss"],
                                       "rel": rel, "param_err": perr})
            print(f"[train] {arch} reduced, accum {accum}, batch {TRAIN_B} x {TRAIN_S}: "
                  f"loss {m_card['loss']:.6f} (CPU {m_cpu['loss']:.6f}), grad_norm "
                  f"{m_card['grad_norm']:.6f} (CPU {m_cpu['grad_norm']:.6f}); relative "
                  f"errors {rel}; max |param card - CPU| after the update {perr:.3e}; "
                  f"0 kernel launches in the card's step", flush=True)
    # (b) the restart drill: a failure after the checkpoint, the re-run
    # steps and every later one bit for bit the uninterrupted run's
    cfg = get_config("internlm2-1.8b").reduced()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        kw = dict(steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S, ckpt_every=TRAIN_CKPT_EVERY,
                  verbose=False, profile=False, device=str(dev))
        a = train(cfg, shape, ckpt_dir=f"{tmp}/a", fail_at=(TRAIN_FAIL_AT,), **kw)
        b = train(cfg, shape, ckpt_dir=f"{tmp}/b", **kw)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    redo = TRAIN_FAIL_AT - TRAIN_FAIL_AT % TRAIN_CKPT_EVERY
    if (a.restarts, b.restarts) != (1, 0) or a.losses[:TRAIN_FAIL_AT] != \
            b.losses[:TRAIN_FAIL_AT] or a.losses[TRAIN_FAIL_AT:] != b.losses[redo:]:
        fail(f"[train] restart drill: restarts {a.restarts}, losses {a.losses} against "
             f"the uninterrupted {b.losses}")
    print(f"[train] restart drill (reduced internlm2, {TRAIN_STEPS} steps, checkpoints "
          f"every {TRAIN_CKPT_EVERY}, a failure at step {TRAIN_FAIL_AT}): 1 restart, the "
          f"{len(a.losses)} losses bit for bit the uninterrupted run's {b.losses}",
          flush=True)
    # (c) train() at full width: bf16 compute, f32 masters, no checkpoints
    cfg = full_cfg or get_config(TRAIN_FULL_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    ops.reset_launch_counts()
    res = train(cfg, shape, steps=TRAIN_FULL_STEPS, batch=full_b, seq=full_s,
                ckpt_dir=None, log_every=1, verbose=True, device=str(dev))
    torch.cuda.synchronize()
    phase_s = time.perf_counter() - t1
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if launches != zero:
        fail(f"[train] full width: launches {launches}")
    if not (np.isfinite(res.losses).all() and np.isfinite(res.grad_norms).all()):
        fail(f"[train] full width: losses {res.losses}, grad norms {res.grad_norms}")
    if not res.losses[-1] < res.losses[0]:
        fail(f"[train] full width: the loss did not fall: {res.losses}")
    wall = res.report.p50_wall  # the median of steps 2-6 (step 1 is the warm-up)
    flops = steps_lib.step_flops_estimate(cfg, shape) * (full_b * full_s) / (
        shape.global_batch * shape.seq_len)
    out["full"] = {"arch": cfg.name, "n_layers": cfg.n_layers, "params": cfg.param_count(),
                   "batch": full_b, "seq": full_s, "losses": res.losses,
                   "grad_norms": res.grad_norms, "step_wall_p50_ms": wall * 1e3,
                   "tokens_per_s": full_b * full_s / wall, "peak_bytes": peak,
                   "model_flops": flops, "bf16_peak_share": flops / wall / BF16_FLOPS_PER_S,
                   "phase_s": phase_s}
    print(f"[train] {cfg.name} full width ({cfg.n_layers} layers, {cfg.param_count()} "
          f"parameters, {cfg.dtype} compute, {cfg.param_dtype} masters), batch {full_b} x "
          f"seq {full_s}, {TRAIN_FULL_STEPS} steps: losses {res.losses}, grad norms "
          f"{res.grad_norms}", flush=True)
    print(f"[train] step wall {wall * 1e3:.3f} ms (median of steps 2-{TRAIN_FULL_STEPS}); "
          f"{full_b * full_s / wall:.1f} tokens/s; peak memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB) allocated; model FLOPs (6ND) {flops:.4e} a step, "
          f"{flops / wall / 1e12:.3f} TFLOP/s = {flops / wall / BF16_FLOPS_PER_S:.4f} of "
          f"the bf16 dense peak; 0 kernel launches; train() {phase_s:.3f} s | {smi}",
          flush=True)
    # where a full-width step's device time goes: one more step (after a
    # warm-up step) under torch.profiler, its kernels summed by name
    if dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        model = Model(cfg, device=dev, seed=0)
        opt = AdamW()
        step = steps_lib.make_train_step(model, opt)
        state = opt.init(dict(model.named_parameters()))
        data = SyntheticTokenPipeline(cfg, shape, batch_override=full_b, seq_override=full_s,
                                      device=dev).batch_at(0)
        state, _ = step(state, data)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            step(state, data)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t1) * 1e3
        del model, opt, step, state
        by_name = device_ms(prof)
        busy = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:14]
        # kernel families by the libraries' names: cuBLAS's f32 GEMMs
        # ("f32f32", "sgemm": the plain attention's f32 products and the f32
        # head), its bf16 ones ("nvjet", "bf16"), ATen's softmax and
        # elementwise kernels and reductions
        families = dict.fromkeys(("gemm_f32", "gemm_bf16", "softmax", "elementwise",
                                  "reduce", "other"), 0.0)
        for n, ms in by_name.items():
            low = n.lower()
            fam = ("gemm_f32" if "f32f32" in low or "sgemm" in low else
                   "gemm_bf16" if "nvjet" in low or ("gemm" in low and "bf16" in low) else
                   "softmax" if "softmax" in low else
                   "elementwise" if "elementwise" in low else
                   "reduce" if "reduce" in low else "other")
            families[fam] += ms
        out["profile"] = {"window_ms": window_ms, "device_busy_ms": busy,
                          "kernels": sum(1 for e in prof.events() if e.device_type ==
                                         torch.autograd.DeviceType.CUDA),
                          "families_ms": families,
                          "top_kernels_ms": {n[:90]: ms for n, ms in top}}
        print(f"[train] one full-width step under torch.profiler: {window_ms:.3f} ms, "
              f"device busy {busy:.3f} ms ({busy / window_ms:.4f}), "
              f"{out['profile']['kernels']} kernels; device ms by family "
              f"{ {k: round(v, 3) for k, v in families.items()} }; top kernels "
              f"{[(n[:70], round(ms, 3)) for n, ms in top]} | {smi}", flush=True)
        torch.cuda.empty_cache()
    print(f"[train] {time.perf_counter() - t0:.3f} s | {smi}", flush=True)
    out["phase_s"] = time.perf_counter() - t0
    return out


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def dataflow_distance(phase: str, label: str, want) -> float:
    """The distance of ``want`` (a grain-1 reference) from the FMA's fixed
    point; fails the run where it is under SHOWS_MIN, where a wrong
    dataflow no longer shows."""
    dist = (want - FIXED_POINT).abs().max().item()
    if dist < SHOWS_MIN:
        fail(f"[{phase}] {label}: the reference is {dist:.3g} from the fixed point "
             f"{FIXED_POINT}, under {SHOWS_MIN}: the run shows no dataflow")
    return dist


def check_close(name: str, got, want, tol: float) -> float:
    if tuple(got.shape) != tuple(want.shape):
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    import torch

    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite values")
    diff = (got.double() - want.double()).abs()
    err = diff.max().item() if got.numel() else 0.0
    if not err <= tol:
        i = int(diff.flatten().argmax())
        fail(f"{name}: max abs error {err} > {tol} at flat index {i} "
             f"({got.flatten()[i].item()} vs {want.flatten()[i].item()})")
    return err


def bf16_ulp(x):
    """One bf16 ulp of each |x|, 0 where x is 0: 2^(floor(log2 |x|) - 7)."""
    import torch

    return torch.exp2(torch.floor(torch.log2(x.double().abs())) - 7)


def check_attn(name: str, got, want) -> float:
    """K5/K6 output against its plain version, element by element:
    TOL_ATTN_F32 in f32, TOL_ATTN_F32 + one bf16 ulp of the plain value in
    bf16. Returns the max abs error."""
    import torch

    if got.dtype != want.dtype:
        fail(f"{name}: dtype {got.dtype} != {want.dtype}")
    if want.dtype == torch.float32:
        return check_close(name, got, want, TOL_ATTN_F32)
    err = check_close(name, got.float(), want.float(), float("inf"))
    excess = (got.double() - want.double()).abs() - (TOL_ATTN_F32 + bf16_ulp(want))
    if excess.numel() and excess.max().item() > 0:
        i = int(excess.argmax())
        fail(f"{name}: |got - want| at flat index {i} ({got.flatten()[i].item()} vs "
             f"{want.flatten()[i].item()}) exceeds {TOL_ATTN_F32} + one bf16 ulp")
    return err


def check_scaled(name: str, got, want) -> float:
    """K7/K8 output against its plain version, element by element:
    TOL_F32_SCALED * max(1, max |want|), plus one bf16 ulp of each plain
    value in bf16. Returns the max abs error."""
    import torch

    if got.dtype != want.dtype:
        fail(f"{name}: dtype {got.dtype} != {want.dtype}")
    err = check_close(name, got.float(), want.float(), float("inf"))
    tol = TOL_F32_SCALED * max(1.0, want.double().abs().max().item())
    excess = (got.double() - want.double()).abs() - tol
    if want.dtype == torch.bfloat16:
        excess -= bf16_ulp(want)
    if excess.numel() and excess.max().item() > 0:
        i = int(excess.argmax())
        fail(f"{name}: |got - want| at flat index {i} ({got.flatten()[i].item()} vs "
             f"{want.flatten()[i].item()}) exceeds {tol}"
             f"{' + one bf16 ulp' if want.dtype == torch.bfloat16 else ''}")
    return err


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}", file=sys.stderr)
        return 2
    if not Path(repro_torch.__file__).resolve().is_relative_to(ROOT / "src"):
        print("chip_smoke: repro_torch was not imported from this checkout",
              file=sys.stderr)
        return 2

    import dataclasses

    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.core import (GraphEnsemble, KernelSpec, TaskGraph, compute_metg,
                                  get_runtime)
    from repro_torch.core.patterns import halo_radius
    from repro_torch.core.runtimes import pallas_step as ps_mod
    from repro_torch.core.runtimes._capture import Graphed, GraphRun, time_runs
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.flash_attention import ENTRY as K5_FORM  # form per dtype
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models.model import Model
    from repro_torch.kernels.bodies import apply_body
    from repro_torch.kernels.taskbench_step import (
        taskbench_step_blocked_plain,
        taskbench_step_plain,
        wrap_rows,
    )
    from repro_torch.launch import attention_times, kernel_times
    from repro_torch.launch.attention_times import gpu_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
          f"{torch.version.cuda}; card: {smi}", flush=True)

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    logs = _build.build_all()
    libs = sorted({lib for lib, _ in (*_build.ENTRIES.values(), *_build.PROBES.values())})
    missing = [lib for lib in libs if not _build.library_path(lib).exists()]
    if missing:
        fail(f"[build] libraries missing after the build: {missing}")
    print(f"[build] {len(libs)} libraries ({len(logs)} built now) in "
          f"{time.perf_counter() - t0:.3f} s "
          f"-> {_build.library_path('taskbench_step').parent}", flush=True)
    for lib, log in sorted(logs.items()):
        for line in log.splitlines():
            if "warning" in line or "Used" in line or "Compiling entry" in line:
                print(f"  {lib}: {line.strip()}")

    # --------------------------------------------------------------- parity
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {entry: 0.0 for entry in _build.ENTRIES}

    def rand(*shape):
        return torch.rand(shape, device=dev, generator=gen) * 0.9 + 0.1

    def k4_forms(case, src, idx, wgt, act, S, kw, radius=None):
        """K4 in every form that applies to these operands, each pinned
        (the tiled one with ``radius``; the memory body only cooperative):
        each launches once on its own counter, is held to the plain version
        within TOL, and all are equal bit for bit. Returns the first."""
        memory = kw["kind"] == "memory_bound"
        pins = [("cooperative", dict(form="cooperative"))]
        if not memory:
            pins.insert(0, ("resident", dict(form="resident")))
            if radius is not None:
                pins.insert(0, ("tiled", dict(radius=radius)))
        want = taskbench_step_blocked_plain(src, idx, wgt, act, **kw)
        outs = []
        for form, pin in pins:
            entry = k4_entry(form)
            before = ops.launch_counts()
            got = ops.taskbench_step(src, idx, wgt, act, steps_per_launch=S, **kw, **pin)
            after = ops.launch_counts()
            moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            if moved != {entry: 1}:
                fail(f"{case} ({form}): launches {moved}")
            errs[entry] = max(errs[entry], check_close(f"{case} ({form})", got, want, TOL))
            if outs and not torch.equal(got, outs[0][1]):
                d = (got - outs[0][1]).abs()
                i = int(d.flatten().argmax())
                fail(f"{case}: {form} != {outs[0][0]} at flat index {i} "
                     f"({got.flatten()[i].item()} vs {outs[0][1].flatten()[i].item()})")
            outs.append((form, got))
        return outs[0][1]

    for rows, p in ((37, 13), (SMS, PAYLOAD), (W_MAIN, PAYLOAD), (W_WIDE, PAYLOAD)):
        x = rand(rows, p)
        for it in (0, 1, 16, 1024):
            e1 = check_close(f"K1 rows={rows} P={p} it={it}",
                             ops.taskbench_compute(x, it),
                             apply_body(x, "compute_bound", it, 0), TOL_K1)
            e2 = check_close(f"K2 rows={rows} P={p} it={it}",
                             ops.taskbench_memory(x, it, 2048),
                             apply_body(x, "memory_bound", it, 2048), TOL)
            errs["taskbench_compute"] = max(errs["taskbench_compute"], e1)
            errs["memory_bound"] = max(errs["memory_bound"], e2)
    # K1 with 4 chains a thread and n % 4 != 0 (the last thread's scalar
    # tail), and its scalar path: x at a 4-byte offset (no 16-byte access
    # lines up)
    for rows, p, offset in ((W_WIDE + 1, 13, 0), (W_MAIN, PAYLOAD, 1), (37, 13, 1)):
        x = rand(rows * p + offset)[offset:].view(rows, p)
        for it in (0, 1, 16, 1024):
            errs["taskbench_compute"] = max(errs["taskbench_compute"], check_close(
                f"K1 rows={rows} P={p} it={it} at a {4 * offset}-byte offset",
                ops.taskbench_compute(x, it), apply_body(x, "compute_bound", it, 0),
                TOL_K1))
    for rows, p, scratch in K2_RAGGED:
        x = rand(rows, p)
        for it in (0, 1, 16, 1024):
            errs["memory_bound"] = max(errs["memory_bound"], check_close(
                f"K2 rows={rows} P={p} scratch={scratch} it={it}",
                ops.taskbench_memory(x, it, scratch),
                apply_body(x, "memory_bound", it, scratch), TOL))
    kinds = (("compute_bound", GRAIN), ("memory_bound", 4), ("empty", 0))
    # K3 at the main path's width, a wide state, one task an SM (one column
    # a thread), and a ragged payload (4 columns a thread on the scalar
    # path); D = 9 slots: more than onehot's merge keeps in registers
    for W, P, D in ((W_MAIN, PAYLOAD, 3), (W_WIDE, PAYLOAD, 3), (SMS, PAYLOAD, 3),
                    (SMS, 13, 3), (W_WIDE, 13, 3), (W_MAIN, PAYLOAD, 9), (SMS, 13, 9)):
        for K in (1, 3):
            wgt = torch.rand((K, W, D), device=dev, generator=gen) / D
            idx = torch.randint(0, W + D - 1, (K, W, D), device=dev,
                                generator=gen, dtype=torch.int32)
            idx[:, ::2, 1] = idx[:, ::2, 0]  # duplicate slots: onehot merges them
            for combine in ("window", "gather", "onehot", "pair"):
                src = rand(K, 2 * W if combine == "pair" else W + D - 1, P)
                for kind, it in kinds:
                    kw = dict(kind=kind, iterations=it, scratch=2048, combine=combine)
                    e3 = check_close(f"K3 W={W} P={P} D={D} K={K} {combine} {kind}",
                                     ops.taskbench_step(src, idx, wgt, **kw),
                                     taskbench_step_plain(src, idx, wgt, **kw), TOL)
                    errs["taskbench_step"] = max(errs["taskbench_step"], e3)
    # K3 with the halo wrap folded in: bit for bit K3 on the row-gathered
    # extension, out-of-range indices on the extended length, W <= 2H
    wrap_cases = 0
    for W, H in itertools.product((W_MAIN, SMS, 1, 2, 3), (1, 2)):
        K, D, ext = 2, 2 * H + 1, W + 2 * H
        state = rand(K, W, PAYLOAD)
        wgt = torch.rand((K, W, D), device=dev, generator=gen) / D
        idx = torch.randint(-ext - 2, ext + 3, (K, W, D), device=dev, generator=gen,
                            dtype=torch.int32)
        idx[:, ::2, 1] = idx[:, ::2, 0]
        for combine in ("window", "gather", "onehot"):
            for kind, it in kinds:
                kw = dict(kind=kind, iterations=it, scratch=2048, combine=combine)
                case = f"K3 wrap={H} W={W} {combine} {kind}"
                folded = ops.taskbench_step(state, idx, wgt, wrap=H, **kw)
                gathered = ops.taskbench_step(wrap_rows(state, H), idx, wgt, **kw)
                if not torch.equal(folded, gathered):
                    d = (folded - gathered).abs()
                    i = int(d.flatten().argmax())
                    fail(f"{case}: folded != row gather + K3 at flat index {i} "
                         f"({folded.flatten()[i].item()} vs {gathered.flatten()[i].item()}, "
                         f"max |difference| {d.max().item()})")
                errs["taskbench_step"] = max(errs["taskbench_step"], check_close(
                    case, folded,
                    taskbench_step_plain(state, idx, wgt, wrap=H, **kw), TOL))
                wrap_cases += 1
    # K3 on out-of-range indices: gather wraps a negative index once and
    # clamps; an onehot slot outside the source adds nothing
    src = rand(1, 6, PAYLOAD)
    idx = torch.tensor([[[-1, 0], [6, 1], [-7, 2], [9, -2], [-2, -2]]],
                       dtype=torch.int32, device=dev)
    wgt = torch.full((1, 5, 2), 0.5, device=dev)
    for combine in ("gather", "onehot"):
        kw = dict(kind="empty", iterations=0, combine=combine)
        errs["taskbench_step"] = max(errs["taskbench_step"], check_close(
            f"K3 out-of-range {combine}", ops.taskbench_step(src, idx, wgt, **kw),
            taskbench_step_plain(src, idx, wgt, **kw), TOL))
    # K3 at the all-gather plan's widest slot count: all_to_all without the
    # row mean gathers every row of the cap's width, D = W = 512
    src = rand(1, W_GATHER, PAYLOAD)
    wgt = torch.rand((1, W_GATHER, W_GATHER), device=dev, generator=gen) / W_GATHER
    idx = torch.randint(0, W_GATHER, (1, W_GATHER, W_GATHER), device=dev, generator=gen,
                        dtype=torch.int32)
    idx[:, ::2, 1] = idx[:, ::2, 0]
    for combine in ("gather", "onehot"):
        for kind, it in (("compute_bound", GRAIN), ("empty", 0)):
            kw = dict(kind=kind, iterations=it, combine=combine)
            errs["taskbench_step"] = max(errs["taskbench_step"], check_close(
                f"K3 W={W_GATHER} D={W_GATHER} {combine} {kind}",
                ops.taskbench_step(src, idx, wgt, **kw),
                taskbench_step_plain(src, idx, wgt, **kw), TOL))
    # K4's time-varying (K, S, M, D) tables at the blocked all-gather plan's
    # shapes: the cap's width and the full one, butterfly's and spread's few
    # slots and all_to_all's D = W, with a masked tail
    for M, D, combines in ((W_GATHER, 3, ("gather", "onehot")),
                           (W_PLAN, 3, ("gather", "onehot")),
                           (W_GATHER, W_GATHER, ("gather", "onehot")),
                           (W_PLAN, W_GATHER, ("gather",))):
        act = torch.ones((1, S_MAIN), device=dev)
        act[:, S_MAIN - 3:] = 0.0
        src = rand(1, M, PAYLOAD)
        wgt = torch.rand((1, S_MAIN, M, D), device=dev, generator=gen) / D
        idx = torch.randint(0, M, (1, S_MAIN, M, D), device=dev, generator=gen,
                            dtype=torch.int32)
        idx[..., ::2, 1] = idx[..., ::2, 0]
        for combine in combines:
            for kind, it in (("compute_bound", GRAIN), ("empty", 0)):
                kw = dict(kind=kind, iterations=it, combine=combine)
                k4_forms(f"K4 time-varying M={M} D={D} S={S_MAIN} {combine} {kind}",
                         src, idx, wgt, act, S_MAIN, kw)
    # K4 at the blocked main path's buffer: W + 2 * S * r rows (r = 2)
    M, K, D = W_MAIN + 2 * S_MAIN * 2, 3, 5
    for S in (2, S_MAIN):
        act = torch.ones((K, S), device=dev)
        act[:, S - 1] = 0.0  # the masked tail of a run's last launch
        act[K - 1] = 0.0     # a frozen member
        src = rand(K, M, PAYLOAD)
        for combine, tv in (("window", False), ("gather", False), ("onehot", False),
                            ("gather", True), ("onehot", True)):
            shape = (K, S, M, D) if tv else (K, M, D)
            wgt = torch.rand(shape, device=dev, generator=gen) / D
            idx = torch.randint(-2, M + 2, shape, device=dev, generator=gen,
                                dtype=torch.int32)
            idx[..., ::2, 1] = idx[..., ::2, 0]
            for kind, it in kinds:
                kw = dict(kind=kind, iterations=it, scratch=2048, combine=combine)
                case = f"K4 S={S} {combine}{' time-varying' if tv else ''} {kind}"
                got = k4_forms(case, src, idx, wgt, act, S, kw)
                if not torch.equal(got[K - 1], src[K - 1]):
                    fail(f"{case}: the frozen member changed")
    # K4's tiled form on tables of reach <= 2: against the plain version and
    # bit for bit the resident and cooperative forms, at the main path's
    # buffer and at one that is not a multiple of the tile
    for M, S, tail in itertools.product((W_MAIN + 2 * S_MAIN * 2, 301), (2, S_MAIN),
                                        (False, True)):
        act = torch.ones((K, S), device=dev)  # every depth active ...
        if tail:  # ... or a masked tail and a frozen member
            act[:, S - 1] = 0.0
            act[K - 1] = 0.0
        src = rand(K, M, PAYLOAD)
        own = torch.arange(M, device=dev)[None, :, None]
        for combine in ("window", "gather", "onehot"):
            Dt = 5 if combine == "window" else 3
            wgt = torch.rand((K, M, Dt), device=dev, generator=gen) / Dt
            off = torch.randint(-2, 3, (K, M, Dt), device=dev, generator=gen)
            idx = (own + off).clamp(0, M - 1).to(torch.int32)
            idx[..., ::2, 1] = idx[..., ::2, 0]
            # the empty body first: grain 64 contracts any difference
            # in its input toward the FMA's fixed point
            for kind, it in (("empty", 0), ("compute_bound", GRAIN)):
                kw = dict(kind=kind, iterations=it, scratch=2048, combine=combine)
                k4_forms(f"K4 M={M} S={S} {combine} {kind}{' masked tail' if tail else ''}",
                         src, idx, wgt, act, S, kw, radius=2)
    # the pipelined phases, stitched, against one full launch (bit for bit)
    g = TaskGraph(steps=T_MAIN, width=W_MAIN, pattern="random_nearest",
                  payload=PAYLOAD, kernel=KernelSpec("compute_bound", 1), radius=2)
    depth = S_MAIN * 2
    state = rand(1, W_MAIN, PAYLOAD)
    act = torch.ones((1, S_MAIN), device=dev)
    act[0, -3:] = 0.0
    hl, hr = ps_mod._prologue_exchange(state, depth)
    side = torch.cuda.Stream()
    for combine in ("window", "gather", "onehot"):
        for kind, it in (("compute_bound", 1), ("memory_bound", 2)):
            rt = get_runtime("pallas_step", combine=combine, steps_per_launch=S_MAIN)
            idx, wgt, _, _ = (torch.from_numpy(a)[None].to(dev)
                              for a in rt._blocked_operands(g, 2))
            iext, wext = ps_mod._extend_tables(idx, wgt, depth, combine, row_axis=1)
            ph = ps_mod._phase_tables(idx, wgt, depth, combine)
            fulls = []
            # each form that applies: the cooperative, the resident and (the
            # compute body, radius 2) the tiled one
            forms = [dict(form="cooperative"), dict(radius=2)]
            if kind != "memory_bound":
                forms.insert(1, dict(form="resident"))
            for pin in forms:
                kw = dict(kind=kind, iterations=it, scratch=2048, combine=combine,
                          steps_per_launch=S_MAIN, **pin)
                full = ops.taskbench_step(wrap_rows(state, depth), iext, wext, act,
                                          **kw)[:, depth:depth + W_MAIN]
                fulls.append(full)
                for stream in (None, side):
                    stitched, _, _ = ps_mod._pipelined_launch(
                        state, hl, hr, act, ph, depth, kw, stream)
                    torch.cuda.synchronize()
                    if not torch.equal(stitched, full):
                        fail(f"K4 phases ({combine} {kind}, {pin}, side "
                             f"stream {stream is not None}): stitched != full launch")
            if not all(torch.equal(fulls[0], f) for f in fulls[1:]):
                fail(f"K4 phases ({combine} {kind}): the forms' full launches differ")
    # K5 at the serving prefill and a windowed ragged case; K6 at the
    # serving decode, lengths from empty to past the capacity
    def normal(*shape, dtype):
        return torch.randn(shape, device=dev, generator=gen).to(dtype)

    cfg_serve = get_config(SERVE_ARCH)
    Hq, Hkv, hd = cfg_serve.n_heads, cfg_serve.n_kv_heads, cfg_serve.head_dim_
    cap = SERVE_PROMPT + SERVE_GEN
    for dtype in (torch.bfloat16, torch.float32):
        for B, Sq, Sk, causal, window in ((SERVE_B, SERVE_PROMPT, SERVE_PROMPT, True, 0),
                                          (2, 1000, 1000, True, 300),
                                          (2, 77, 1000, False, 0)):
            q = normal(B, Hq, Sq, hd, dtype=dtype)
            k, v = normal(B, Hkv, Sk, hd, dtype=dtype), normal(B, Hkv, Sk, hd, dtype=dtype)
            kw = dict(causal=causal, window=window)
            form = K5_FORM[dtype]
            errs[form] = max(errs[form], check_attn(
                f"K5 {dtype} B={B} Sq={Sq} Sk={Sk} {kw}",
                ops.flash_attention(q, k, v, **kw), ref.attention_plain(q, k, v, **kw)))
        lengths = torch.tensor([0, 1, 513, 1024, 1050, cap - 1, cap, cap + 1],
                               dtype=torch.int32, device=dev)
        q = normal(len(lengths), Hq, hd, dtype=dtype)
        kc, vc = (normal(len(lengths), Hkv, cap, hd, dtype=dtype) for _ in range(2))
        for window in (0, 256):
            o, m, l = ops.decode_attention(q, kc, vc, lengths, window=window,
                                           return_stats=True)
            wo, wm, wl = ref.decode_attention_plain(q, kc, vc, lengths, window=window,
                                                    return_stats=True)
            case = f"K6 {dtype} window={window}"
            errs["decode_attention"] = max(errs["decode_attention"],
                                           check_attn(case, o, wo))
            for stat, got, want in (("m", m, wm), ("l", l, wl)):
                rel = ((got - want).abs() / want.abs().clamp(min=1.0)).max().item()
                if not rel <= TOL_STATS_REL:
                    fail(f"{case} {stat}: relative error {rel} > {TOL_STATS_REL}")
            if l[0].abs().max().item() != 0.0 or o[0].abs().max().item() != 0.0:
                fail(f"{case}: an empty cache gave l or o != 0")
    # K5 and K6 at hymba's shape: GQA group 5, head dim 64, window 1024
    cfg_hyb = get_config(HYB_ARCH)
    hq, hkv, hhd, win = (cfg_hyb.n_heads, cfg_hyb.n_kv_heads, cfg_hyb.head_dim_,
                         cfg_hyb.window)
    hcap = HYB_PROMPT + HYB_GEN
    for dtype in (torch.bfloat16, torch.float32):
        q = normal(HYB_B, hq, HYB_PROMPT, hhd, dtype=dtype)
        k, v = (normal(HYB_B, hkv, HYB_PROMPT, hhd, dtype=dtype) for _ in range(2))
        form = K5_FORM[dtype]
        errs[form] = max(errs[form], check_attn(
            f"K5 hymba {dtype}", ops.flash_attention(q, k, v, causal=True, window=win),
            ref.attention_plain(q, k, v, causal=True, window=win)))
        lengths = torch.tensor([0, 1, win - 1, win, win + 1, hcap], dtype=torch.int32,
                               device=dev)
        q = normal(len(lengths), hq, hhd, dtype=dtype)
        kc, vc = (normal(len(lengths), hkv, hcap, hhd, dtype=dtype) for _ in range(2))
        errs["decode_attention"] = max(errs["decode_attention"], check_attn(
            f"K6 hymba {dtype}", ops.decode_attention(q, kc, vc, lengths, window=win),
            ref.decode_attention_plain(q, kc, vc, lengths, window=win)))
    # K5 and K6 at every shape of the other serving paths: cross-attention
    # over 1600 image tokens and its cache read whole, and each served
    # arch's prefill and decode (head dims 64, 80, 128, 256; groups 1-8)
    for form, err in attention_kinds_parity(dev, gen).items():
        errs[form] = max(errs[form], err)
    # K7 at the serving prefills' chunks (mamba2: BC = 8 x 8 chunks, 24
    # heads, N 128; hymba: 50 heads, N 16), at a 5-token prompt, with two
    # groups; some dtA <= -30, whose decays underflow and must stay finite
    def ssd_inputs(BC, H, G, T, N, P, dtype):
        x = normal(BC, H, T, P, dtype=dtype)
        b, c = normal(BC, G, T, N, dtype=dtype), normal(BC, G, T, N, dtype=dtype)
        dt = torch.rand((BC, H, T), device=dev, generator=gen) * 0.1 + 0.001
        A = -torch.linspace(1.0, 16.0, H, device=dev)
        dta = dt * A[None, :, None]
        dta[:, :, ::7] = -35.0
        return x, b, c, dta, dt

    cfg_ssm = get_config(SSM_ARCH)
    ssd_cases = (
        ("mamba2", SSM_B * SSM_PROMPT // cfg_ssm.ssm_chunk, cfg_ssm.ssm_heads,
         cfg_ssm.ssm_groups, cfg_ssm.ssm_chunk, cfg_ssm.ssm_state, cfg_ssm.ssm_head_dim),
        ("hymba", HYB_B * HYB_PROMPT // cfg_hyb.ssm_chunk, cfg_hyb.ssm_heads,
         cfg_hyb.ssm_groups, cfg_hyb.ssm_chunk, cfg_hyb.ssm_state, cfg_hyb.ssm_head_dim),
        ("T=5", 8, 24, 1, 5, 128, 64),
        ("G=2", 16, 8, 2, 128, 16, 64),
        ("P=12", 4, 6, 2, 100, 16, 12))
    for dtype in (torch.float32, torch.bfloat16):
        for label, *shape in ssd_cases:
            args = ssd_inputs(*shape, dtype=dtype)
            (y, st), (wy, wst) = ops.ssd_chunk(*args), ref.ssd_chunk_plain(*args)
            case = f"K7 {label} {dtype} (BC, H, G, T, N, P) = {tuple(shape)}"
            errs["ssd_chunk"] = max(errs["ssd_chunk"], check_scaled(f"{case} y", y, wy),
                                    check_scaled(f"{case} state", st, wst))
    # K8 at mamba2's norm shapes (d_model, and the gated norm over ssm_inner),
    # a row of 125 vectors, a ragged d (the scalar path) and x at an odd
    # offset (the scalar path), weights in f32 (the model's) and x's dtype
    for rows, d, offset in ((SSM_B * SSM_PROMPT, cfg_ssm.d_model, 0),
                            (SSM_B * SSM_PROMPT, cfg_ssm.ssm_inner, 0), (37, 1000, 0),
                            (5, 33, 0), (64, cfg_ssm.d_model, 1)):
        for dtype in (torch.bfloat16, torch.float32):
            x = (normal(rows * d + offset, dtype=dtype) * 3.0)[offset:].view(rows, d)
            for wdt in (torch.float32, dtype):
                w = normal(d, dtype=wdt)
                errs["rmsnorm"] = max(errs["rmsnorm"], check_scaled(
                    f"K8 ({rows}, {d}) offset {offset} {dtype} w {wdt}",
                    ops.rmsnorm(x, w, 1e-5), ref.rmsnorm_plain(x, w, 1e-5)))
    torch.cuda.synchronize()
    print(f"[parity] K1-K8 (K4 in three forms, K5 in two) agree with their plain versions, "
          f"K3 with the wrap folded in equals the row gather + K3 in {wrap_cases} cases, "
          f"K4's forms equal each other bit for bit and their phases stitched equal "
          f"one launch, in {time.perf_counter() - t0:.3f} s; "
          f"max abs errors {errs}", flush=True)

    # ------------------------------------------------------------ main path
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    # launches of the eager loops the graphs are held to: not the main path's
    check_launches = dict.fromkeys(_build.ENTRIES, 0)
    captures = []  # (run, capture seconds, graph nodes)

    def counted(fn):
        before = ops.launch_counts()
        out = fn()
        torch.cuda.synchronize()
        after = ops.launch_counts()
        return out, {k: after[k] - before[k] for k in after}

    def graphed(label: str, rt, g: TaskGraph, init, eager: bool = True):
        """``rt``'s run of ``g`` on ``init``: built (a CUDA graph, its
        warm-up and capture counted apart), replayed once with the launch
        counters read around the replay; with ``eager``, its eager loop on
        the same init, equal to the replay bit for bit and launching the
        same kernels. Returns (final state on the host, the replay's
        launches)."""
        run = rt.build(g)
        if not isinstance(run, GraphRun):
            fail(f"{label}: build gave {type(run).__name__}, not a CUDA graph")
        out, d = counted(lambda: run(init))
        captures.append((label, run.capture_s, run.nodes))
        if eager:
            want, d_eager = counted(lambda: run.eager(init.clone()))
            if not torch.equal(out, want):
                fail(f"{label}: the graph's replay differs from its eager loop, max "
                     f"|difference| {(out - want).abs().max().item()}")
            if d_eager != d:
                fail(f"{label}: the eager loop launched {d_eager}, the replay {d}")
            for k, n in d_eager.items():
                check_launches[k] += n
        return out.cpu(), d

    def run_all(g: TaskGraph, init):
        ps, d_ps = graphed(f"{g.pattern} pallas_step", get_runtime("pallas_step"), g, init)
        fk, d_fk = graphed(f"{g.pattern} fused kernels",
                           get_runtime("fused", use_kernels=True), g, init)
        fp, d_fp = graphed(f"{g.pattern} fused plain", get_runtime("fused"), g, init,
                           eager=False)
        body = "taskbench_compute" if g.kernel.kind == "compute_bound" else "memory_bound"
        want_ps = dict.fromkeys(_build.ENTRIES, 0)
        want_ps["taskbench_step"] = g.steps
        want_fk = dict.fromkeys(_build.ENTRIES, 0)
        want_fk[body] = g.steps
        if d_ps != want_ps or d_fk != want_fk or any(d_fp.values()):
            fail(f"{g.describe()}: launches pallas_step {d_ps}, fused "
                 f"kernels {d_fk}, fused plain {d_fp}")
        if get_runtime("pallas_step").dispatches_per_run(g) != d_ps["taskbench_step"]:
            fail("pallas_step.dispatches_per_run disagrees with its launches")
        return ps, fk, fp

    blocked_launches = {}

    def run_blocked(g: TaskGraph, init, want, tol: float, combine: str = "window"):
        """pallas_step(steps_per_launch=S_MAIN), pipelined and serial: each
        held to the S = 1 run ``want``, its launches to 1 K3 plus one (serial)
        or two (pipelined) K4 per blocked launch, all on K4's tiled form
        (the cooperative one for the memory body), and to
        dispatches_per_run, and pipelined equal to serial bit for bit."""
        outs = {}
        form = K4_COOP if g.kernel.kind == "memory_bound" else K4_TILED
        for label, opts in BLOCKED_RUNS:
            rt = get_runtime("pallas_step", combine=combine,
                             steps_per_launch=S_MAIN, **opts)
            out, d = graphed(f"{g.pattern} {combine} S={S_MAIN} {label}", rt, g, init)
            split = rt._pipeline_active(g.width, S_MAIN, halo_radius(g))
            want_d = dict.fromkeys(_build.ENTRIES, 0)
            want_d["taskbench_step"] = 1
            want_d[form] = -(-(g.steps - 1) // S_MAIN) * (1 + split)
            if d != want_d or sum(d.values()) != rt.dispatches_per_run(g):
                fail(f"{g.describe()} {combine} S={S_MAIN} {label}: launches {d}, "
                     f"expected {want_d}, dispatches_per_run "
                     f"{rt.dispatches_per_run(g)}")
            blocked_launches.setdefault(form, {})[label] = d[form]
            outs[label] = out
            check_close(f"{g.pattern} {combine} S={S_MAIN} {label} vs S=1",
                        outs[label], want, tol)
        if not torch.equal(outs["pipelined"], outs["serial"]):
            fail(f"{g.pattern} {combine} S={S_MAIN}: pipelined != serial")

    for pattern in HALO_PATTERNS:
        g = TaskGraph(steps=T_MAIN, width=W_MAIN, pattern=pattern, payload=PAYLOAD,
                      kernel=KernelSpec("compute_bound", GRAIN), radius=2, seed=0)
        init = rand(W_MAIN, PAYLOAD)
        ps, fk, fp = run_all(g, init)
        run_blocked(g, init, ps, TOL)
        if pattern in ("stencil_1d", "random_nearest"):
            for combine in ("gather", "onehot"):
                run_blocked(g, init, ps, TOL, combine)
        check_close(f"{pattern}: pallas_step vs fused(kernels)", ps, fk, TOL)
        check_close(f"{pattern}: fused(kernels) vs fused(plain)", fk, fp, TOL)
        for combine in ("gather", "onehot"):
            out, d = graphed(f"{pattern} pallas_step {combine}",
                             get_runtime("pallas_step", combine=combine), g, init)
            if d["taskbench_step"] != T_MAIN or sum(d.values()) != T_MAIN:
                fail(f"{pattern} {combine}: launches {d}")
            check_close(f"{pattern}: pallas_step {combine} vs window", out, ps, TOL)
    g = TaskGraph(steps=T_MAIN, width=W_MAIN, pattern="stencil_1d", payload=PAYLOAD,
                  kernel=KernelSpec("memory_bound", 4, scratch=2048), seed=0)
    init = rand(W_MAIN, PAYLOAD)
    ps, fk, fp = run_all(g, init)
    check_close("memory_bound: pallas_step vs fused(kernels)", ps, fk, TOL_MEMORY_RUN)
    check_close("memory_bound: fused(kernels) vs fused(plain)", fk, fp, TOL_MEMORY_RUN)
    run_blocked(g, init, ps, TOL_MEMORY_RUN)
    # Grain 64 drives every state to the FMA's fixed point 0.2, so also
    # check the dataflow where it shows: grain 1, 8 steps, against the
    # plain path on the CPU.
    for pattern in HALO_PATTERNS:
        g = TaskGraph(steps=8, width=64, pattern=pattern, payload=PAYLOAD,
                      kernel=KernelSpec("compute_bound", 1), radius=3, seed=1)
        want = torch.from_numpy(get_runtime("fused", device="cpu").execute(g))
        init = get_runtime("fused", device="cpu")._init(g, None)
        for rt in (get_runtime("pallas_step"), get_runtime("fused", use_kernels=True),
                   get_runtime("pallas_step", combine="onehot"),
                   get_runtime("pallas_step", steps_per_launch=3),
                   get_runtime("pallas_step", steps_per_launch=3, pipeline=False),
                   get_runtime("pallas_step", steps_per_launch=3, combine="gather")):
            check_close(f"small {pattern} {rt.name} {rt.options}",
                        torch.from_numpy(rt.execute(g, init)), want, TOL)
    # one replay of a short S = 1 run's graph under torch.profiler (its
    # input staged before): one device kernel a timestep, K3, and nothing
    # else; no row gather (the one-device halo wrap is folded into K3's row
    # index)
    from torch.profiler import ProfilerActivity, profile

    gp = TaskGraph(steps=T_PROFILED, width=W_MAIN, pattern="nearest", payload=PAYLOAD,
                   kernel=KernelSpec("compute_bound", GRAIN), radius=2, seed=0)
    run = get_runtime("pallas_step").build(gp)
    init = rand(W_MAIN, PAYLOAD)
    run(init)
    run.stage(init)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, d = counted(run.graphed.replay)
    seen = [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    k3_seen = sum("step_compute_kernel" in n for n in seen)
    if d["taskbench_step"] != T_PROFILED or sum(d.values()) != T_PROFILED \
            or k3_seen != T_PROFILED or len(seen) != T_PROFILED:
        fail(f"S = 1 profiled replay of {T_PROFILED} steps: launch counters {d}, "
             f"device events {len(seen)} ({k3_seen} K3): {sorted(set(seen))[:6]}")
    print(f"[main] one replay of the S = 1 graph of {T_PROFILED} steps (nearest, "
          f"W={W_MAIN}): launch counter {d['taskbench_step']} K3 and no other kernel "
          f"of the port; torch.profiler: {len(seen)} device events, {k3_seen} of them "
          f"K3 ({sorted(set(n[:48] for n in seen))}), nothing else", flush=True)
    del run
    torch.cuda.synchronize()
    total = ops.launch_counts()
    launches = {k: n - check_launches[k] for k, n in total.items()}
    for k, n in launches.items():
        if (n == 0) == (k in TASKBENCH_KERNELS):
            fail(f"kernel {k}: {n} launches on the Task Bench main path")
    print(f"[main] {len(HALO_PATTERNS)} halo patterns, W={W_MAIN} T={T_MAIN} "
          f"P={PAYLOAD} grain {GRAIN}: pallas_step (window, gather, onehot), "
          f"fused(kernels) and fused(plain) agree; pallas_step(steps_per_launch="
          f"{S_MAIN}) pipelined and serial agree with S=1 and with each other bit "
          f"for bit, K4 launches per run {blocked_launches} (+1 K3); launches "
          f"{launches} (and {check_launches} by the eager loops each graph was held "
          f"to); {time.perf_counter() - t0:.3f} s", flush=True)
    plain = [c for c in captures if c[0].endswith("fused plain")]
    print(f"[main] every run replayed one CUDA graph ({len(captures)} captured; "
          f"each schedule equal to its eager loop bit for bit): capture seconds and "
          f"nodes {[(lbl, round(sec, 6), n) for lbl, sec, n in captures[:9]]} ...; "
          f"fused plain (grain {GRAIN}, T={T_MAIN}): "
          f"{[(round(sec, 6), n) for _, sec, n in plain]}", flush=True)
    print(json.dumps({"captures": [{"run": lbl, "capture_s": sec, "nodes": n}
                                   for lbl, sec, n in captures]}), flush=True)

    # ---------------------------------------------------------------- plans
    # pallas_step's stride plan (fft, tree) and all-gather plan (spread,
    # all_to_all, W = 1 fft, and butterfly at an explicit depth under the
    # cap) through the runtime's build, each run one graph replay held to its
    # eager loop; the launch counters are zeroed just before and read just
    # after, apart from the eager loops'
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    check_launches = dict.fromkeys(_build.ENTRIES, 0)
    plan_runs = []  # (label, plan, S, launches of the replay)
    plan_errs = {}

    def plan_run(label: str, g: TaskGraph, init, opts: dict):
        """pallas_step(**opts) on ``g``: one graph replay equal to its eager
        loop, its launches equal to dispatches_per_run and to the plan's
        kernels (T K3 per step; 1 K3 + ceil((T-1)/S) K4 when blocked, in
        the resident form, or the cooperative one for the memory body).
        Returns the final state on the host."""
        rt = get_runtime("pallas_step", **opts)
        plan = rt._schedule_for_graph(g)
        out, d = graphed(f"{label} pallas_step {opts}", rt, g, init)
        want = dict.fromkeys(_build.ENTRIES, 0)
        blocked = plan.kind == ps_mod.PLAN_ALLGATHER and plan.steps_per_launch > 1
        if blocked:
            want["taskbench_step"] = 1
            want[k4_form(g.kernel.kind == "memory_bound", True)] = \
                -(-(g.steps - 1) // plan.steps_per_launch)
        else:
            want["taskbench_step"] = g.steps
        if d != want or sum(d.values()) != rt.dispatches_per_run(g):
            fail(f"[plans] {label} {opts}: plan {plan}, launches {d}, expected {want}, "
                 f"dispatches_per_run {rt.dispatches_per_run(g)}")
        plan_runs.append((label, plan.kind, plan.steps_per_launch,
                          rt._plan_combine(plan.kind), d))
        return out

    def plan_refs(label: str, g: TaskGraph, init, plain: bool):
        """fused(kernels) (and with ``plain``, fused plain) on ``g``: the
        references, their launches kept out of the plans' counts."""
        outs = []
        for tag, opts in (("kernels", {"use_kernels": True}), ("plain", {}))[:1 + plain]:
            out, d = graphed(f"{label} fused {tag}", get_runtime("fused", **opts), g, init,
                             eager=False)
            for k, n in d.items():
                check_launches[k] += n
            outs.append(out)
        return outs[0], (outs[1] if plain else None)

    def held(label: str, got, want, tol: Optional[float]):
        """``tol`` None: equal bit for bit; else max abs error <= tol."""
        if tol is None:
            if not torch.equal(got, want):
                fail(f"[plans] {label}: not bit for bit fused(kernels), max |difference| "
                     f"{(got - want).abs().max().item()}")
            err = 0.0
        else:
            err = check_close(f"[plans] {label}", got, want, tol)
        plan_errs[label] = max(plan_errs.get(label, 0.0), err)

    def tb_graph(pattern, W, kind="compute_bound", it=GRAIN, steps=T_MAIN):
        return TaskGraph(steps=steps, width=W, pattern=pattern, payload=PAYLOAD,
                         kernel=KernelSpec(kind, it, scratch=2048), seed=0)

    # fft and tree at full width: the stride plan (pair, gather, onehot) and
    # an explicit S = 8 over the cap (per step); at the cap's width S = 8
    # re-routes to the blocked all-gather plan (K4, time-varying tables)
    for pattern in ("fft", "tree"):
        g = tb_graph(pattern, W_PLAN)
        init = rand(W_PLAN, PAYLOAD)
        fk, _ = plan_refs(pattern, g, init, plain=False)
        for opts in ({}, {"combine": "gather"}, {"combine": "onehot"},
                     {"steps_per_launch": S_MAIN}):
            held(f"{pattern} W={W_PLAN} {opts}", plan_run(pattern, g, init, opts), fk, None)
        g = tb_graph(pattern, W_GATHER)
        init = rand(W_GATHER, PAYLOAD)
        fk, _ = plan_refs(pattern, g, init, plain=False)
        held(f"{pattern} W={W_GATHER} S={S_MAIN}",
             plan_run(pattern, g, init, {"steps_per_launch": S_MAIN}), fk, None)
    # spread and all_to_all at the cap's width, per step and blocked,
    # all_to_all with and without the row mean (whose sum is taken in
    # another order: TOL); spread at full width under a raised cap
    for pattern, W, cap_opts in (("spread", W_GATHER, {}), ("all_to_all", W_GATHER, {}),
                                 ("spread", W_PLAN, {"gather_width_cap": W_PLAN})):
        g = tb_graph(pattern, W)
        init = rand(W, PAYLOAD)
        fk, fp = plan_refs(pattern, g, init, plain=True)
        runs = [{}, {"steps_per_launch": S_MAIN}]
        if pattern == "all_to_all":
            runs.append({"psum_mean": False})
        for opts in runs:
            opts = dict(cap_opts, **opts)
            out = plan_run(pattern, g, init, opts)
            held(f"{pattern} W={W} {opts} vs fused(kernels)", out, fk, TOL)
            held(f"{pattern} W={W} {opts} vs fused(plain)", out, fp, TOL)
    # one memory_bound run on each plan: stride, blocked and per-step
    # all-gather
    for pattern, W, opts in (("fft", W_PLAN, {}), ("tree", W_GATHER, {"steps_per_launch": S_MAIN}),
                             ("spread", W_GATHER, {}), ("all_to_all", W_GATHER, {})):
        g = tb_graph(pattern, W, "memory_bound", 4)
        init = rand(W, PAYLOAD)
        fk, _ = plan_refs(f"{pattern} memory_bound", g, init, plain=False)
        held(f"{pattern} W={W} memory_bound {opts}",
             plan_run(f"{pattern} memory_bound", g, init, opts), fk, TOL_MEMORY_RUN)
    # W = 1 fft: a pure self-dependency, on the all-gather plan
    g = tb_graph("fft", 1)
    init = rand(1, PAYLOAD)
    fk, _ = plan_refs("fft W=1", g, init, plain=False)
    held("fft W=1", plan_run("fft W=1", g, init, {}), fk, None)
    if get_runtime("pallas_step")._schedule_for_graph(g).kind != ps_mod.PLAN_ALLGATHER:
        fail("[plans] W = 1 fft is not on the all-gather plan")
    # grain 64 drives every state to the FMA's fixed point, and grain 1 past
    # ~9 steps: the dataflow shows in a short run at grain 1, each plan at
    # full width against the plain path on the CPU (and butterfly bit for bit
    # fused(kernels) on the card), each reference SHOWS_MIN or more from the
    # fixed point
    plans_dist = []
    for pattern, W, opts in (
            ("fft", W_PLAN, {}), ("tree", W_PLAN, {"combine": "onehot"}),
            ("fft", W_GATHER, {"steps_per_launch": 3}), ("tree", W_GATHER, {"steps_per_launch": 3}),
            ("spread", W_GATHER, {}), ("spread", W_GATHER, {"steps_per_launch": 3}),
            ("all_to_all", W_GATHER, {}), ("all_to_all", W_GATHER, {"psum_mean": False}),
            ("all_to_all", W_GATHER, {"steps_per_launch": 3})):
        g = tb_graph(pattern, W, it=1, steps=T_PLANS_SHORT)
        cpu_fused = get_runtime("fused", device="cpu")
        init = cpu_fused._init(g, None)
        want = torch.from_numpy(cpu_fused.execute(g, init))
        plans_dist.append(dataflow_distance(
            "plans", f"{pattern} W={W} grain 1 T={T_PLANS_SHORT} {opts}", want))
        out = plan_run(f"{pattern} grain 1", g, init.to(dev), opts)
        held(f"{pattern} W={W} grain 1 T={T_PLANS_SHORT} {opts} vs CPU plain", out, want, TOL)
        if pattern in ("fft", "tree"):
            fk, _ = plan_refs(f"{pattern} grain 1", g, init.to(dev), plain=False)
            held(f"{pattern} W={W} grain 1 T={T_PLANS_SHORT} {opts}", out, fk, None)
    # replays of a 6-step fft graph at full width under torch.profiler: K3
    # (pair) once a step, and the XOR shuffle's copies (the flip and the
    # concatenation; at t = 0 the [x | x] concatenation). Two replays in one
    # profiling window, the last replay's events read (the window may drop the
    # first events it sees)
    gp = tb_graph("fft", W_PLAN, steps=T_PROFILED)
    run = get_runtime("pallas_step").build(gp)
    init = rand(W_PLAN, PAYLOAD)
    run(init)
    run.stage(init)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, d = counted(lambda: [run.graphed.replay() for _ in range(2)])
    seen = sorted((e.time_range.start, e.name, e.time_range.elapsed_us())
                  for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    per_replay = 3 * T_PROFILED - 1  # 6 K3, 5 flips, 6 concatenations
    events = [(n, us) for _, n, us in seen[-per_replay:]]
    k3_pair = [us for n, us in events if "step_compute_kernel<3" in n]
    others = [(n, us) for n, us in events if "step_compute_kernel" not in n]
    pattern = ["cat"] + ["k3", "flip", "cat"] * (T_PROFILED - 1) + ["k3"]
    kinds = ["k3" if "step_compute_kernel<3" in n else "cat" if "Cat" in n
             else "flip" if "index_elementwise" in n or "flip" in n else n[:60]
             for n, _ in events]
    if d["taskbench_step"] != 2 * T_PROFILED or sum(d.values()) != 2 * T_PROFILED \
            or kinds != pattern:
        fail(f"[plans] fft profiled replays of {T_PROFILED} steps: launch counters {d}, "
             f"{len(seen)} device events, the last replay's {kinds}")
    del run
    stride_profile = {
        "steps": T_PROFILED, "W": W_PLAN, "device_events": len(events),
        "device_events_two_replays": len(seen), "sequence": kinds,
        "k3_pair": len(k3_pair), "k3_pair_us": sum(k3_pair),
        "glue": len(others), "glue_us": sum(us for _, us in others),
        "glue_kernels": sorted({n[:60] for n, _ in others})}
    print(f"[plans] two replays of the fft stride graph of {T_PROFILED} steps (W={W_PLAN}): "
          f"launch counter {d['taskbench_step']} K3; torch.profiler: {len(seen)} device "
          f"events; the last replay's {len(events)}: {len(k3_pair)} K3 in its pair mode ({sum(k3_pair):.3f} us) and "
          f"{len(others)} glue kernels ({stride_profile['glue_us']:.3f} us: "
          f"{stride_profile['glue_kernels']}) | {smi}", flush=True)
    torch.cuda.synchronize()
    total = ops.launch_counts()
    launches_plans = {k: n - check_launches[k] for k, n in total.items()}
    for k in ("taskbench_step", K4_RES, K4_COOP):
        if launches_plans[k] == 0:
            fail(f"kernel {k}: no launches on the plans' path")
    for k, n in launches_plans.items():
        if n and k not in ("taskbench_step", K4_RES, K4_COOP):
            fail(f"kernel {k}: {n} launches on the plans' path")
    print(f"[plans] {len(plan_runs)} pallas_step runs on the stride and all-gather "
          f"plans (T={T_MAIN} at W={W_PLAN} and {W_GATHER}, grain {GRAIN}; grain 1 at "
          f"T={T_PLANS_SHORT}): each graph equal to its eager loop bit for bit, launches "
          f"equal to dispatches_per_run; butterfly bit for bit fused(kernels); every grain-1 "
          f"reference at least {min(plans_dist):.3g} from the fixed point; "
          f"launches {launches_plans} (and {check_launches} by the eager loops); "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    print(json.dumps({"plans": [
        {"run": lbl, "plan": kind, "S": s, "combine": comb,
         "launches": {k: n for k, n in d.items() if n}}
        for lbl, kind, s, comb, d in plan_runs],
        "max_abs_err": plan_errs, "stride_profile": stride_profile}), flush=True)

    # ------------------------------------------------------------- ensemble
    # GraphEnsembles through both backends' build_ensemble, each run one
    # graph replay held to its eager loop, its launches (zeroed just before
    # the phase, the eager loops' and the references' kept apart) equal to
    # ensemble_dispatches_per_run; pallas_step's stacked launch plan stepped
    # on the host
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    check_launches = dict.fromkeys(_build.ENTRIES, 0)
    ens_runs = []  # (label, stacked, launches of the replay)
    ens_errs = {}  # label -> max abs difference (0.0: bit for bit)
    own_bitwise = {}  # stacked member vs its own single-graph run

    def ens_graphed(label: str, rt, ens, xs, eager: bool = True):
        """``rt``'s run of ``ens`` on the member states ``xs``: built (one
        CUDA graph), replayed once with the launch counters read around the
        replay, equal to its eager loop bit for bit with the same launches,
        and its launches equal to ensemble_dispatches_per_run. Returns the
        members' final states."""
        run = rt.build_ensemble(ens)
        if not isinstance(run, GraphRun):
            fail(f"[ensemble] {label}: build_ensemble gave {type(run).__name__}")
        out, d = counted(lambda: run(xs))
        captures.append((f"ensemble {label}", run.capture_s, run.nodes))
        if eager:
            want, d_eager = counted(lambda: run.eager(tuple(x.clone() for x in xs)))
            for k, (a, b) in enumerate(zip(out, want)):
                if not torch.equal(a, b):
                    fail(f"[ensemble] {label}: member {k}'s replay differs from the "
                         f"eager loop, max |difference| {(a - b).abs().max().item()}")
            if d_eager != d:
                fail(f"[ensemble] {label}: the eager loop launched {d_eager}, the replay {d}")
            for k, n in d_eager.items():
                check_launches[k] += n
        if rt.name == "pallas_step":
            if sum(d.values()) != rt.ensemble_dispatches_per_run(ens):
                fail(f"[ensemble] {label}: launches {d}, ensemble_dispatches_per_run "
                     f"{rt.ensemble_dispatches_per_run(ens)}")
        elif d != fused_launches(rt, ens):
            fail(f"[ensemble] {label}: launches {d}, expected {fused_launches(rt, ens)}")
        ens_runs.append((label, rt.name, dict(rt.options), rt._is_stacked(ens)
                         if rt.name == "pallas_step" else None, d))
        return out

    def fused_launches(rt, ens):
        """``fused(use_kernels=True)``'s kernel launches for ``ens`` (its
        ensemble_dispatches_per_run counts every device operation): one body
        launch a step over all rows of a stacked uniform ensemble, else one
        per member a step, frozen members included."""
        want = dict.fromkeys(_build.ENTRIES, 0)
        specs = [g.kernel for g in ens.members]
        if rt._is_stacked(ens) and len(set(specs)) == 1:
            specs = specs[:1]
        for spec in specs:
            if spec.iterations and spec.kind != "empty":
                want["taskbench_compute" if spec.kind == "compute_bound"
                     else "memory_bound"] += ens.steps
        return want

    def reference_run(fn):
        """A run the ensemble is held to, its launches kept apart."""
        out, d = counted(fn)
        for k, n in d.items():
            check_launches[k] += n
        return out

    def ens_held(label: str, got, want, tol: Optional[float]):
        """``tol`` None: bit for bit; else max abs error <= tol."""
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        if tol is None and err != 0.0:
            fail(f"[ensemble] {label}: not bit for bit, max |difference| {err}")
        if tol is not None:
            for k, (a, b) in enumerate(zip(got, want)):
                check_close(f"[ensemble] {label} member {k}", a, b, tol)
        ens_errs[label] = max(ens_errs.get(label, 0.0), err)

    def own_runs(label: str, rt, ens, xs, outs, tol: float):
        """Each member against its own single-graph run under ``rt`` (the
        K-dependent rounding check): recorded bit for bit or not, held to
        ``tol``."""
        for k, (g, x, out) in enumerate(zip(ens.members, xs, outs)):
            own = reference_run(lambda: rt.build(g)(x))
            same = torch.equal(out, own)
            own_bitwise[f"{label} member {k}"] = (
                True if same else (out - own).abs().max().item())
            check_close(f"[ensemble] {label} member {k} vs its own run", out, own, tol)

    def ens_of(specs):
        """GraphEnsemble of (steps, width, pattern, kind, iterations, radius)
        members, payload 64, seed k."""
        return GraphEnsemble([
            TaskGraph(steps=t, width=w, pattern=p, payload=PAYLOAD, radius=r, seed=k,
                      kernel=KernelSpec(kind, it, scratch=2048))
            for k, (t, w, p, kind, it, r) in enumerate(specs)])

    def inits_of(ens):
        return tuple(rand(g.width, g.payload) for g in ens.members)

    k3_only = dict.fromkeys(_build.ENTRIES, 0)
    # the stacked S = 1 ensemble: one K3 a step for all K members
    stacked = ens_of([(T_MAIN, W_MAIN, "stencil_1d", "compute_bound", GRAIN, 1)] * K_ENS)
    xs = inits_of(stacked)
    rt = get_runtime("pallas_step")
    st1 = ens_graphed("stacked S=1", rt, stacked, xs)
    if ens_runs[-1][-1] != dict(k3_only, taskbench_step=T_MAIN):
        fail(f"[ensemble] stacked S=1 at K={K_ENS}: launches {ens_runs[-1][-1]}, "
             f"expected {T_MAIN} K3")
    own_runs("stacked S=1", rt, stacked, xs, st1, TOL)
    fk = ens_graphed("stacked fused(kernels)", get_runtime("fused", use_kernels=True),
                     stacked, xs)
    fp = reference_run(lambda: get_runtime("fused")._build_ensemble_eager(stacked)(xs))
    ens_held("stacked S=1 vs fused(kernels)", st1, fk, TOL)
    ens_held("stacked fused(kernels) vs fused(plain)", fk, fp, TOL)
    # the same members at S = 8 with mixed horizons, pipelined and serial
    hetero = ens_of([(t, W_MAIN, "stencil_1d", "compute_bound", GRAIN, 1) for t in HETERO_T])
    blocked = {}
    for label, opts in BLOCKED_RUNS:
        rt = get_runtime("pallas_step", steps_per_launch=S_MAIN, **opts)
        blocked[label] = ens_graphed(f"stacked S={S_MAIN} {label}", rt, hetero, xs)
        own_runs(f"stacked S={S_MAIN} {label}", rt, hetero, xs, blocked[label], TOL)
        d = ens_runs[-1][-1]
        split = rt._pipeline_active(W_MAIN, S_MAIN, 1)
        if d != dict(k3_only, taskbench_step=1,
                     **{K4_TILED: -(-(T_MAIN - 1) // S_MAIN) * (1 + split)}):
            fail(f"[ensemble] stacked S={S_MAIN} {label}: launches {d}")
    ens_held(f"stacked S={S_MAIN} pipelined vs serial", blocked["pipelined"],
             blocked["serial"], None)
    hs1 = reference_run(lambda: get_runtime("pallas_step").build_ensemble(hetero)(xs))
    ens_held(f"stacked S={S_MAIN} vs S=1 (mixed horizons)", blocked["serial"], hs1, TOL)
    # one memory_bound stacked run
    mem = ens_of([(T_MAIN, W_MAIN, "stencil_1d", "memory_bound", 4, 1)] * K_ENS)
    xm = inits_of(mem)
    rt = get_runtime("pallas_step")
    ms1 = ens_graphed("stacked memory_bound S=1", rt, mem, xm)
    own_runs("stacked memory_bound S=1", rt, mem, xm, ms1, TOL_MEMORY_RUN)
    fmk = ens_graphed("stacked memory_bound fused(kernels)",
                      get_runtime("fused", use_kernels=True), mem, xm)
    ens_held("stacked memory_bound vs fused(kernels)", ms1, fmk, TOL_MEMORY_RUN)
    # a mixed-spec tuple ensemble, at S = 1 and S = 8
    mixed = ens_of([(T_MAIN, W_MAIN, "stencil_1d", "compute_bound", GRAIN, 1),
                    (T_MAIN, W_MAIN, "nearest", "compute_bound", 256, 2),
                    (T_MAIN, W_MAIN, "no_comm", "memory_bound", 4, 1)])
    xt = inits_of(mixed)
    tols = [TOL, TOL, TOL_MEMORY_RUN]
    tup = {S: ens_graphed(f"tuple mixed-spec S={S}",
                          get_runtime("pallas_step", steps_per_launch=S), mixed, xt)
           for S in (1, S_MAIN)}
    tk = ens_graphed("tuple mixed-spec fused(kernels)", get_runtime("fused", use_kernels=True),
                     mixed, xt)
    tp = reference_run(lambda: get_runtime("fused")._build_ensemble_eager(mixed)(xt))
    for k, tol in enumerate(tols):
        for tag, got in (("S=1", tup[1]), (f"S={S_MAIN}", tup[S_MAIN]), ("fused(kernels)", tk)):
            check_close(f"[ensemble] tuple mixed-spec {tag} member {k} vs fused(plain)",
                        got[k], tp[k], tol)
        ens_errs[f"tuple mixed-spec member {k} vs fused(plain)"] = max(
            (got[k] - tp[k]).abs().max().item() for got in (tup[1], tup[S_MAIN], tk))
    # a mixed-plan tuple ensemble: halo, stride, all-gather (spread,
    # all_to_all); the shared cadence is per step
    plans = ens_of([(T_MAIN, W_MAIN, "stencil_1d", "compute_bound", GRAIN, 1),
                    (T_MAIN, W_PLAN, "fft", "compute_bound", GRAIN, 1),
                    (T_MAIN, W_GATHER, "spread", "compute_bound", GRAIN, 1),
                    (T_MAIN, W_GATHER, "all_to_all", "compute_bound", GRAIN, 1)])
    xp = inits_of(plans)
    rt = get_runtime("pallas_step", steps_per_launch=S_MAIN)
    if rt._ensemble_steps_per_launch(plans) != 1:
        fail("[ensemble] the mixed-plan ensemble's cadence is not per step")
    pl = ens_graphed("tuple mixed-plan", rt, plans, xp)
    if ens_runs[-1][-1] != dict(k3_only, taskbench_step=len(plans) * T_MAIN):
        fail(f"[ensemble] mixed-plan: launches {ens_runs[-1][-1]}")
    pk = ens_graphed("tuple mixed-plan fused(kernels)", get_runtime("fused", use_kernels=True),
                     plans, xp)
    ens_held("tuple mixed-plan vs fused(kernels)", pl, pk, TOL)
    if not torch.equal(pl[1], pk[1]):
        fail("[ensemble] the fft member is not bit for bit fused(kernels)")
    def plan_checks(label: str, ens, xs, want, evict_at: int, admit_at: int, S: int):
        """The stacked launch plan of ``ens`` at depth S, stepped on the
        host: equal to ``want`` (build_ensemble's serial run) bit for bit;
        member 1's act rows zeroed from launch ``evict_at`` (it then equals
        its own run at T = 1 + evict_at * S), a fresh member admitted into
        the finished slot 3 at ``admit_at`` (it then holds the t = 0 K3 of
        its init); the capture count flat under both edits. Returns the
        plan and the launches of its plain and its edited run."""
        rt = get_runtime("pallas_step", steps_per_launch=S)
        lp = rt.build_ensemble_launches(ens)
        if lp.kind != "stacked" or lp.num_launches != -(-(ens.steps - 1) // S) \
                or not evict_at < admit_at < lp.num_launches:
            fail(f"[ensemble] {label} launch plan {lp.kind}, {lp.num_launches} launches, "
                 f"evict at {evict_at}, admit at {admit_at}")

        def step_plan(acts, admit=None):
            carry = lp.init_fn(xs)
            for l in range(lp.num_launches):
                if admit is not None and l == admit[0]:
                    carry = lp.admit_fn(carry, admit[1], admit[2])
                carry = lp.launch_fn(carry, acts[l], lp.launch_t0(l))
            return lp.finalize(carry)

        plan_out, d_plan = counted(lambda: step_plan(lp.acts))
        ens_held(f"{label} launch plan S={S_MAIN} vs build_ensemble", plan_out, want, None)
        captures_before = lp.compile_counter()
        acts = lp.acts.copy()
        acts[evict_at:, 1, :] = 0
        g3 = ens.members[3]
        fresh = rand(g3.width, g3.payload)
        churned, d_churn = counted(lambda: step_plan(acts, admit=(admit_at, 3, fresh)))
        if lp.compile_counter() != captures_before:
            fail(f"[ensemble] {label}: the launch plan captured under eviction and "
                 f"admission: {captures_before} -> {lp.compile_counter()}")
        t_evict = 1 + evict_at * S
        g1 = dataclasses.replace(ens.members[1], steps=t_evict)
        ens_held(f"{label} evicted member 1 vs its own run at T={t_evict}", churned[1:2],
                 (reference_run(lambda: rt.build(g1)(xs[1])),), None)
        t0_fresh = reference_run(lambda: ops.taskbench_step(
            fresh[None], *(t[None] for t in ps_mod._self_tables(g3.width, dev)),
            kind=g3.kernel.kind, iterations=g3.kernel.iterations, scratch=2048,
            combine="window")[0])
        ens_held(f"{label} admitted member 3 vs the t = 0 K3 of its init", churned[3:4],
                 (t0_fresh,), None)
        ens_held(f"{label} members 0 and 2 under churn", (churned[0], churned[2]),
                 (plan_out[0], plan_out[2]), None)
        return lp, d_plan, d_churn, captures_before

    # the stacked launch plan at S = 8 on the mixed horizons: evict member 1
    # from launch EVICT_AT, admit a fresh member into slot 3 at ADMIT_AT
    lp, d_plan, d_churn, captures_before = plan_checks(
        "grain 64", hetero, xs, blocked["serial"], EVICT_AT, ADMIT_AT, S_MAIN)
    # grain 64 drives every state to the FMA's fixed point 0.2 within a
    # step, so the members against their own runs (the K-dependent rounding
    # check) and the launch plan's edits run again where the dataflow
    # shows: grain 1, T_ENS_SHORT steps, radii 1 and 2 stacked (every
    # member read through the radius-2 window), each combine, S = 1 and
    # S_ENS_SHORT, and against the CPU plain path, each reference SHOWS_MIN
    # or more from the fixed point
    cpu_fused = get_runtime("fused", device="cpu")
    ens_dist = []  # the grain-1 references' distances from the fixed point

    def cpu_plain(ens):
        """The members' inits, on the card, and their final states on the
        CPU plain path."""
        xs = tuple(cpu_fused._init(g, None) for g in ens.members)
        want = tuple(torch.from_numpy(cpu_fused.execute(g, x)) for g, x in zip(ens.members, xs))
        for k, (g, w) in enumerate(zip(ens.members, want)):
            if g.kernel.kind == "compute_bound" and g.kernel.iterations == 1:
                ens_dist.append(dataflow_distance(
                    "ensemble", f"grain 1 {g.pattern} member {k} T={g.steps}", w))
        return tuple(x.to(dev) for x in xs), want

    def held_to_cpu(label: str, got, want, tols):
        for k, (a, b, tol) in enumerate(zip(got, want, tols)):
            check_close(f"[ensemble] {label} member {k} vs CPU plain", a.cpu(), b, tol)
        ens_errs[f"{label} vs CPU plain"] = max(
            (a.cpu() - b).abs().max().item() for a, b in zip(got, want))

    short = ens_of([(t, W_MAIN, p, "compute_bound", 1, 2) for t, p in zip(
        T_ENS_SHORT, ("stencil_1d", "nearest", "stencil_1d", "random_nearest"))])
    xs1, want1 = cpu_plain(short)
    short_serial = None
    for combine in ("window", "gather", "onehot"):
        for tag, opts in (("S=1", {}),) + tuple(
                (f"S={S_ENS_SHORT} {lbl}", dict(o, steps_per_launch=S_ENS_SHORT))
                for lbl, o in BLOCKED_RUNS):
            rt = get_runtime("pallas_step", combine=combine, **opts)
            label = f"grain 1 {combine} {tag}"
            out = ens_graphed(label, rt, short, xs1)
            own_runs(label, rt, short, xs1, out, TOL)
            ens_held(f"{label} vs CPU plain", tuple(o.cpu() for o in out), want1, TOL)
            if combine == "window" and tag.endswith("serial"):
                short_serial = out
    plan_checks("grain 1", short, xs1, short_serial, 1, 2, S_ENS_SHORT)
    # fused(kernels)'s stacked run and both tuple ensembles at grain 1 as
    # well, mixed horizons freezing members, each held to the CPU plain path
    fk1 = ens_graphed("grain 1 stacked fused(kernels)", get_runtime("fused", use_kernels=True),
                      short, xs1)
    held_to_cpu("grain 1 stacked fused(kernels)", fk1, want1, [TOL] * K_ENS)
    mixed1 = ens_of([(T_ENS_SHORT[0], W_MAIN, "stencil_1d", "compute_bound", 1, 1),
                     (T_ENS_SHORT[1], W_MAIN, "nearest", "compute_bound", 1, 2),
                     (T_ENS_SHORT[2], W_MAIN, "no_comm", "memory_bound", 4, 1)])
    xt1, want_t1 = cpu_plain(mixed1)
    for tag, rt in (("S=1", get_runtime("pallas_step")),
                    (f"S={S_ENS_SHORT}", get_runtime("pallas_step", steps_per_launch=S_ENS_SHORT)),
                    ("fused(kernels)", get_runtime("fused", use_kernels=True))):
        label = f"grain 1 tuple mixed-spec {tag}"
        held_to_cpu(label, ens_graphed(label, rt, mixed1, xt1), want_t1, tols)
    plans1 = ens_of([(T_ENS_SHORT[3], W_MAIN, "stencil_1d", "compute_bound", 1, 1),
                     (T_ENS_SHORT[0], W_PLAN, "fft", "compute_bound", 1, 1),
                     (T_ENS_SHORT[1], W_GATHER, "spread", "compute_bound", 1, 1),
                     (T_ENS_SHORT[2], W_GATHER, "all_to_all", "compute_bound", 1, 1)])
    xp1, want_p1 = cpu_plain(plans1)
    pl1 = ens_graphed("grain 1 tuple mixed-plan",
                      get_runtime("pallas_step", steps_per_launch=S_ENS_SHORT), plans1, xp1)
    pk1 = ens_graphed("grain 1 tuple mixed-plan fused(kernels)",
                      get_runtime("fused", use_kernels=True), plans1, xp1)
    held_to_cpu("grain 1 tuple mixed-plan", pl1, want_p1, [TOL] * len(plans1))
    held_to_cpu("grain 1 tuple mixed-plan fused(kernels)", pk1, want_p1, [TOL] * len(plans1))
    if not torch.equal(pl1[1], pk1[1]):
        fail("[ensemble] grain 1: the fft member is not bit for bit fused(kernels)")
    torch.cuda.synchronize()

    def own_count(evidence: bool) -> str:
        """'n of m' members bit for bit their own runs, among the cases
        where the dataflow shows (grain 1, memory_bound) or the others."""
        vs = [v for lbl, v in own_bitwise.items()
              if (lbl.startswith("grain 1") or "memory_bound" in lbl) == evidence]
        return f"{sum(v is True for v in vs)} of {len(vs)}"

    total = ops.launch_counts()
    launches_ens = {k: n - check_launches[k] for k, n in total.items()}
    for k, n in launches_ens.items():
        if (n == 0) == (k in TASKBENCH_KERNELS):
            fail(f"kernel {k}: {n} launches on the ensemble path")
    print(f"[ensemble] {len(ens_runs)} ensemble runs (K={K_ENS} stacked stencil_1d at "
          f"W={W_MAIN} T={T_MAIN}, S=1 ({T_MAIN} K3 for all members) and S={S_MAIN} "
          f"pipelined and serial at T={HETERO_T}; memory_bound stacked; mixed-spec tuple "
          f"at S=1 and {S_MAIN}; mixed-plan tuple; fused(kernels) on each): each graph "
          f"equal to its eager loop bit for bit, launches equal to "
          f"ensemble_dispatches_per_run; pipelined equal to serial; the launch plan "
          f"(S={S_MAIN}, {lp.num_launches} launches) equal to build_ensemble, eviction "
          f"and admission bit for bit, captures {captures_before} before and after; "
          f"every grain-1 reference at least {min(ens_dist):.3g} from the fixed point; "
          f"stacked members bit for bit their own runs: {own_count(True)} at grain 1 "
          f"and memory_bound (the evidence), {own_count(False)} compute members at grain "
          f"{GRAIN} (at the FMA's fixed point, no evidence); "
          f"launches {launches_ens} (and {check_launches} by the eager loops and the "
          f"references); {time.perf_counter() - t0:.3f} s | {smi}", flush=True)
    print(json.dumps({"ensemble": [
        {"run": lbl, "runtime": name, "options": opts, "stacked": st,
         "launches": {k: n for k, n in d.items() if n}}
        for lbl, name, opts, st, d in ens_runs],
        "max_abs_err": ens_errs, "own_run_bitwise": own_bitwise,
        "launch_plan": {"S": S_MAIN, "launches": lp.num_launches,
                        "kernel_launches": {k: n for k, n in d_plan.items() if n},
                        "kernel_launches_churned": {k: n for k, n in d_churn.items() if n},
                        "captures": captures_before}}), flush=True)

    # ------------------------------------------------------------- schedule
    # steps_per_launch="auto" under the cost model measured on the card: the
    # main path, the cache tier, the other plans and the stacked ensemble's
    # launch plan; the launch counters zeroed just before the auto runs and
    # read just after, the probes' (before) and the explicit twins' and
    # references' (check_launches) kept apart
    import os
    import tempfile

    from repro_torch.kernels import probes
    from repro_torch.kernels import schedule as sched
    from repro_torch.resilience.detect import DeadlineDetector

    t0 = time.perf_counter()
    model = probes.run_probes(payload=PAYLOAD)
    probe_s = time.perf_counter() - t0
    floor_us = probes.row_step_floor_us(PAYLOAD)
    print(f"[schedule] run_probes() in {probe_s:.3f} s: {model.describe()}; launch "
          f"{model.launch_us:.6f} us, row-step {model.row_step_us:.6e} us (floor "
          f"{floor_us:.6e}) | {smi}", flush=True)
    print(json.dumps({"cost_model": model.to_dict(), "row_step_floor_us": floor_us,
                      "probe_s": probe_s}), flush=True)
    if not (model.is_measured and model.launch_us > 0 and model.row_step_us > floor_us):
        fail(f"[schedule] the cost model is not a measurement: {model.to_dict()}")
    if model.halo_exchange_us != {probes.SELF_EXCHANGE: 0.0} \
            or model.exchange_row_steps != 1.0 or model.platform != name \
            or model.devices != 1:
        fail(f"[schedule] the one-device model: exchange {model.halo_exchange_us}, X "
             f"{model.exchange_row_steps}, platform {model.platform!r}")
    cache_dir = tempfile.TemporaryDirectory()
    cache = probes.save_cost_model(model, Path(cache_dir.name) / "cost_model.json")
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    check_launches = dict.fromkeys(_build.ENTRIES, 0)
    sched_runs = []  # (label, plan, S, pipelined, reason, launches of the replay)

    def apart(fn):
        """A run the auto runs are held to, its launches kept apart."""
        out, d = counted(fn)
        for k, n in d.items():
            check_launches[k] += n
        return out

    def auto_run(label: str, g: TaskGraph, init, opts: dict, rt=None):
        """pallas_step(steps_per_launch="auto", cost_model=model, **opts) on
        ``g`` (or ``rt``): one graph replay equal to its eager loop, its
        launches equal to dispatches_per_run, and equal bit for bit to the
        explicit run of the depth and schedule it resolved to. Returns
        (output on the host, the resolution)."""
        rt = rt or get_runtime("pallas_step", steps_per_launch="auto", cost_model=model,
                               **opts)
        plan = rt._schedule_for_graph(g)
        H = halo_radius(g)
        piped = plan.kind == ps_mod.PLAN_HALO and rt._pipeline_active(
            g.width, plan.steps_per_launch, H, g.payload)
        out, d = graphed(f"[schedule] {label} auto", rt, g, init)
        if sum(d.values()) != rt.dispatches_per_run(g):
            fail(f"[schedule] {label}: launches {d}, dispatches_per_run "
                 f"{rt.dispatches_per_run(g)}")
        twin = get_runtime("pallas_step", steps_per_launch=plan.steps_per_launch,
                           pipeline=piped, **opts)
        if twin._schedule_for_graph(g)[:2] != plan[:2]:
            fail(f"[schedule] {label}: the twin resolves {twin._schedule_for_graph(g)}")
        want = apart(lambda: twin.build(g)(init)).cpu()
        if not torch.equal(out, want):
            fail(f"[schedule] {label}: auto ({plan.kind}, S={plan.steps_per_launch}, "
                 f"pipelined={piped}) differs from its explicit twin, max |difference| "
                 f"{(out - want).abs().max().item()}")
        sched_runs.append((label, plan.kind, plan.steps_per_launch, piped, plan.reason, d))
        print(f"  {label}: {plan.kind} S={plan.steps_per_launch} pipelined={piped}: "
              f"{plan.reason}", flush=True)
        return out, plan

    # the main path: the 7 halo patterns and one memory_bound run
    for pattern in HALO_PATTERNS:
        g = TaskGraph(steps=T_MAIN, width=W_MAIN, pattern=pattern, payload=PAYLOAD,
                      kernel=KernelSpec("compute_bound", GRAIN), radius=2, seed=0)
        _, plan = auto_run(pattern, g, rand(W_MAIN, PAYLOAD), {})
        if (plan.kind, plan.steps_per_launch, sched_runs[-1][3]) != (
                ps_mod.PLAN_HALO, S_AUTO_MAIN, False):
            fail(f"[schedule] {pattern}: auto resolved {plan} pipelined="
                 f"{sched_runs[-1][3]}, expected halo S={S_AUTO_MAIN} serial")
    g_mem = TaskGraph(steps=T_MAIN, width=W_MAIN, pattern="stencil_1d", payload=PAYLOAD,
                      kernel=KernelSpec("memory_bound", 4, scratch=2048), seed=0)
    _, plan = auto_run("stencil_1d memory_bound", g_mem, rand(W_MAIN, PAYLOAD), {})
    if plan[:2] != (ps_mod.PLAN_HALO, 1) or "memory body" not in plan.reason:
        fail(f"[schedule] memory_bound: auto resolved {plan}")
    # through the cache: REPRO_COST_MODEL names the saved file, no option
    g = TaskGraph(steps=T_MAIN, width=W_MAIN, pattern="nearest", payload=PAYLOAD,
                  kernel=KernelSpec("compute_bound", GRAIN), radius=2, seed=0)
    init = rand(W_MAIN, PAYLOAD)
    explicit_model, explicit_plan = auto_run("nearest (explicit model)", g, init, {})
    before = os.environ.get(probes.COST_MODEL_ENV)
    os.environ[probes.COST_MODEL_ENV] = str(cache)
    try:
        rt_cache = get_runtime("pallas_step", steps_per_launch="auto")
        if rt_cache._cost_model(PAYLOAD) != model:
            fail(f"[schedule] the cache tier read {rt_cache._cost_model(PAYLOAD)}")
        cached, cached_plan = auto_run("nearest (through the cache)", g, init, {},
                                       rt=rt_cache)
    finally:
        if before is None:
            os.environ.pop(probes.COST_MODEL_ENV)
        else:
            os.environ[probes.COST_MODEL_ENV] = before
        cache_dir.cleanup()
    if cached_plan != explicit_plan or not torch.equal(cached, explicit_model):
        fail(f"[schedule] the cache resolved {cached_plan}, the explicit model "
             f"{explicit_plan}")
    # the step walls of "auto" beside explicit depths (graph replays, serial)
    walls = {}
    for grain in (GRAIN, 1):
        g = TaskGraph(steps=T_MAIN, width=W_MAIN, pattern="stencil_1d", payload=PAYLOAD,
                      kernel=KernelSpec("compute_bound", grain), seed=0)
        x = rand(W_MAIN, PAYLOAD)
        runs = {"auto": get_runtime("pallas_step", steps_per_launch="auto",
                                    cost_model=model).build(g)}
        for S in S_WALLS:
            runs[f"S={S}" + (" serial" if S > 1 else "")] = get_runtime(
                "pallas_step", steps_per_launch=S, pipeline=False).build(g)
        best = {key: float("inf") for key in runs}
        for _ in range(3):
            for key, run in runs.items():
                best[key] = min(best[key], min(apart(lambda: time_runs(run, x, reps=5))))
        walls[grain] = {key: t / T_MAIN * 1e6 for key, t in best.items()}
        del runs
        print(f"[schedule] stencil_1d W={W_MAIN} grain {grain}: us per step (graph "
              f"replays, best of 15) " + ", ".join(
                  f"{key} {us:.4f}" for key, us in walls[grain].items()) + f" | {smi}",
              flush=True)
    # the other plans at [plans]' widths: the all-gather plan's launch fits
    # when it takes K4's resident form, so "auto" blocks spread and
    # all_to_all at the deepest candidate under T - 1 (on one card every
    # depth pays off); a butterfly under the cap re-routes to that plan where
    # the measured model ranks it ahead (`gathered_beats_strides` on one
    # card: no stride leaves the block), and stays per step over the cap
    for pattern, W in (("fft", W_PLAN), ("tree", W_PLAN), ("fft", W_GATHER),
                       ("spread", W_GATHER), ("all_to_all", W_GATHER)):
        g = TaskGraph(steps=T_MAIN, width=W, pattern=pattern, payload=PAYLOAD,
                      kernel=KernelSpec("compute_bound", GRAIN), seed=0)
        want = ("allgather", S_AUTO_MAIN)
        if W > sched.DEFAULT_GATHER_WIDTH_CAP:
            want = ("stride", 1)
        elif pattern == "fft":
            strides = ps_mod._patterns.butterfly_slot_strides(g)
            beats, _ = sched.gathered_beats_strides(
                width=W, block=W, steps_per_launch=S_AUTO_MAIN, period=len(strides),
                off_block_strides=sum(1 for st in strides if st >= W), model=model,
                impl=probes.SELF_EXCHANGE)
            want = want if beats else ("stride", 1)
        _, plan = auto_run(f"{pattern} W={W}", g, rand(W, PAYLOAD), {})
        if plan[:2] != want:
            fail(f"[schedule] {pattern} W={W}: auto resolved {plan}, expected {want}")
        if plan.kind == "allgather" and pattern != "fft" \
                and "resident form" not in plan.reason:
            fail(f"[schedule] {pattern}: the reason names no rule: {plan.reason}")
    # the K = 4 stacked ensemble: its run, and its launch plan under a deadline
    ens_k4 = ens_of([(T_MAIN, W_MAIN, "stencil_1d", "compute_bound", GRAIN, 1)] * K_ENS)
    xe = inits_of(ens_k4)
    rt = get_runtime("pallas_step", steps_per_launch="auto", cost_model=model)
    S_ens = rt._ensemble_steps_per_launch(ens_k4)
    if S_ens != S_AUTO_MAIN or rt._pipeline_active(W_MAIN, S_ens, 1, PAYLOAD):
        fail(f"[schedule] the stacked ensemble resolved S={S_ens}")
    got = ens_graphed("auto stacked", rt, ens_k4, xe)
    twin = get_runtime("pallas_step", steps_per_launch=S_ens, pipeline=False)
    want = apart(lambda: twin.build_ensemble(ens_k4)(xe))
    for k, (a, b) in enumerate(zip(got, want)):
        if not torch.equal(a, b):
            fail(f"[schedule] stacked member {k} differs from its explicit twin")
    # the stacked ensemble's step walls: "auto" beside explicit depths (graph
    # replays, serial), where one (K, W) launch carries K x W rows
    ens_walls = {}
    for grain in (GRAIN, 1):
        ens_g = ens_of([(T_MAIN, W_MAIN, "stencil_1d", "compute_bound", grain, 1)] * K_ENS)
        xg = inits_of(ens_g)
        runs = {"auto": rt.build_ensemble(ens_g)}
        for S in S_WALLS:
            runs[f"S={S}" + (" serial" if S > 1 else "")] = get_runtime(
                "pallas_step", steps_per_launch=S, pipeline=False).build_ensemble(ens_g)
        best = {key: float("inf") for key in runs}
        for _ in range(3):
            for key, run in runs.items():
                best[key] = min(best[key], min(apart(lambda: time_runs(run, xg, reps=5))))
        ens_walls[grain] = {key: t / T_MAIN * 1e6 for key, t in best.items()}
        del runs
        print(f"[schedule] K={K_ENS} stacked stencil_1d W={W_MAIN} grain {grain}: us per "
              f"step (graph replays, best of 15) " + ", ".join(
                  f"{key} {us:.4f}" for key, us in ens_walls[grain].items()) + f" | {smi}",
              flush=True)
    lp = rt.build_ensemble_launches(ens_k4)
    if lp.expected_launch_us is None or lp.steps_per_launch != S_ens:
        fail(f"[schedule] the measured launch plan: S={lp.steps_per_launch}, expected "
             f"{lp.expected_launch_us}")
    # each launch's device wall, between CUDA events around it, is held to
    # the deadline, once. The act rows are staged on the card ahead, and a
    # spin kernel queued before the start event holds the card while the
    # host issues the launch, so the events bracket the launch's device
    # work (its staging copies on the card and its replay) and not the
    # host's issue. A launch whose host issue alone crosses the deadline is
    # printed as a host stall, with both walls: a host stall on a shared
    # machine is not a slow launch
    det = DeadlineDetector(expected_us=lp.expected_launch_us)
    det.note_recompile_boundary()  # the cohort's first launch
    acts_card = torch.as_tensor(lp.acts, dtype=torch.float32, device="cuda")
    issue_walls, device_walls, host_stalls = [], [], []
    carry = lp.init_fn(xe)
    torch.cuda.synchronize()
    for l in range(lp.num_launches):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(LAUNCH_SPIN_CYCLES)
        t1 = time.perf_counter()
        start.record()
        carry = lp.launch_fn(carry, acts_card[l], lp.launch_t0(l))
        end.record()
        issue_us = (time.perf_counter() - t1) * 1e6
        end.synchronize()
        device_us = start.elapsed_time(end) * 1e3
        issue_walls.append(issue_us)
        device_walls.append(device_us)
        if det.observe(device_us) is not None:
            fail(f"[schedule] launch {l} flagged: its device wall {device_us:.3f} us against "
                 f"the deadline {det.deadline_us():.3f} (expected {lp.expected_launch_us:.3f}; "
                 f"host issue {issue_us:.3f} us)")
        if l and issue_us > det.deadline_us():
            host_stalls.append((l, issue_us, device_us))
    for l, issue_us, device_us in host_stalls:
        print(f"[schedule] host stall at launch {l}: host issue {issue_us:.3f} us, device "
              f"wall {device_us:.3f} us, against the deadline {det.deadline_us():.3f}",
              flush=True)
    for k, (a, b) in enumerate(zip(lp.finalize(carry), want)):
        if not torch.equal(a, b):
            fail(f"[schedule] the launch plan's member {k} differs from build_ensemble")
    analytic = get_runtime("pallas_step", steps_per_launch="auto",
                           cost_model=probes.analytic_cost_model())
    if analytic.build_ensemble_launches(ens_k4).expected_launch_us is not None:
        fail("[schedule] the analytic launch plan priced a launch")
    torch.cuda.synchronize()
    total = ops.launch_counts()
    launches_sched = {k: n - check_launches[k] for k, n in total.items()}
    for k, n in launches_sched.items():
        if (n == 0) == (k in ("taskbench_step", K4_TILED, K4_RES)):
            fail(f"kernel {k}: {n} launches on the schedule path")
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    print(f"[schedule] launch plan of the K={K_ENS} stacked ensemble at S={S_ens} "
          f"({lp.num_launches} launches): expected {lp.expected_launch_us:.3f} us a "
          f"launch; device (events) median {med(device_walls[1:]):.3f} us (max "
          f"{max(device_walls[1:]):.3f}), ratio device/expected "
          f"{med(device_walls[1:]) / lp.expected_launch_us:.3f}; host issue median "
          f"{med(issue_walls[1:]):.3f} us (max {max(issue_walls[1:]):.3f}) "
          f"(DEADLINE_FACTOR {sched.DEADLINE_FACTOR:g}); deadline {det.deadline_us():.3f} us: "
          f"no device wall flagged, {len(host_stalls)} host stalls (a host issue over it)",
          flush=True)
    print(f"[schedule] {len(sched_runs)} auto runs (the main path's 7 halo patterns at "
          f"S={S_AUTO_MAIN} serial, memory_bound at S=1, the cache tier, fft/tree/spread/"
          f"all_to_all, the K={K_ENS} stacked ensemble at S={S_ens}): each equal to its "
          f"explicit twin bit for bit and launching dispatches_per_run; launches "
          f"{launches_sched} (and {check_launches} by the eager loops and the twins); "
          f"{time.perf_counter() - t0:.3f} s (+{probe_s:.3f} s of probes) | {smi}",
          flush=True)
    print(json.dumps({"schedule": {
        "runs": [{"run": lbl, "plan": kind, "S": s, "pipelined": piped, "reason": why,
                  "launches": {k: n for k, n in d.items() if n}}
                 for lbl, kind, s, piped, why, d in sched_runs],
        "step_us": walls, "ensemble_S": S_ens, "ensemble_step_us": ens_walls,
        "launch_plan": {"expected_us": lp.expected_launch_us, "issue_us": issue_walls,
                        "device_us": device_walls, "deadline_us": det.deadline_us(),
                        "host_stalls": host_stalls}}}),
        flush=True)

    # ------------------------------------------- resilience, serving, restart
    # the launch plans stepped from the host: the resilience engine under
    # every fault class, the serving fabric, the restart loop
    launches_res = resilience_phase(dev, rand, smi, model)
    launches_serving = serving_phase(dev, rand, smi, model)
    launches_restart = restart_phase(dev, rand, smi)

    # ---------------------------------------------------------------- rungs
    # the paper's other four rungs, each with the kernels: bsp (one graph
    # replay a superstep), bsp_scan and overlap (the run one graph replay),
    # serialized (one eager host call a task); the launch counters and host
    # calls zeroed just before the phase, the eager loops' and the fused
    # references' kept apart
    from repro_torch.core.runtimes._capture import HostLoop, ReplayLoop

    t0 = time.perf_counter()
    ops.reset_launch_counts()
    check_launches = dict.fromkeys(_build.ENTRIES, 0)
    check_calls = 0
    rung_rows = []  # one record per run

    def counted_calls(fn):
        """``fn()``'s result, launches and host calls (a synchronize after)."""
        h0 = ops.host_calls()
        out, d = counted(fn)
        return out, d, ops.host_calls() - h0

    def reference(g: TaskGraph, init):
        """fused(use_kernels=True)'s run of ``g`` (one graph replay), its
        launches kept apart."""
        nonlocal check_calls
        run = get_runtime("fused", use_kernels=True).build(g)
        out, d, h = counted_calls(lambda: run(init))
        for k, n in d.items():
            check_launches[k] += n
        check_calls += h
        return out.cpu()

    def rung(label: str, rt, g: TaskGraph, init, want, tol: float, bits: bool = False):
        """``rt``'s run of ``g`` on ``init``: built (its graphs captured; the
        warm-ups and captures counted apart), run once with the launch
        counters and host calls read around it, equal bit for bit to its
        eager loop on the same init (a second run, for serialized), held to
        ``want`` (fused with the kernels) within ``tol`` (or bit for bit
        with ``bits``), and timed (best of 3 runs; serialized: 1). Returns
        its output."""
        nonlocal check_calls
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        m0 = torch.cuda.memory_reserved()
        tb = time.perf_counter()
        run = rt.build(g)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - tb
        pool_mb = (torch.cuda.memory_reserved() - m0) / 2**20
        form = {"bsp": ReplayLoop, "bsp_scan": GraphRun, "overlap": GraphRun}.get(rt.name)
        if not (isinstance(run, form) if form else
                not isinstance(run, (GraphRun, ReplayLoop, HostLoop))):
            fail(f"[rungs] {label}: build gave {type(run).__name__}")
        out, d, calls = counted_calls(lambda: run(init))
        eager = getattr(run, "eager", run)
        again, d_eager, h_eager = counted_calls(lambda: eager(init.clone()))
        for k, n in d_eager.items():
            check_launches[k] += n
        check_calls += h_eager
        if not torch.equal(out, again):
            fail(f"[rungs] {label}: the run differs from its eager loop, max |difference| "
                 f"{(out - again).abs().max().item()}")
        body = "taskbench_compute" if g.kernel.kind == "compute_bound" else "memory_bound"
        want_d = dict.fromkeys(_build.ENTRIES, 0)
        want_d[body] = rt.body_launches_per_run(g)
        if d != want_d or d_eager != d:
            fail(f"[rungs] {label}: launches {d} (eager loop {d_eager}), expected {want_d}")
        if calls != rt.host_calls_per_run(g):
            fail(f"[rungs] {label}: {calls} host calls, host_calls_per_run "
                 f"{rt.host_calls_per_run(g)}")
        if rt.name == "bsp" and len(run.graphs) != len(set(run.eager.order)):
            fail(f"[rungs] {label}: {len(run.graphs)} graphs for "
                 f"{len(set(run.eager.order))} distinct supersteps")
        err = 0.0
        if bits:
            if not torch.equal(out.cpu(), want):
                fail(f"[rungs] {label}: not bit for bit fused(kernels), max |difference| "
                     f"{(out.cpu() - want).abs().max().item()}")
        else:
            err = check_close(f"[rungs] {label} vs fused(kernels)", out.cpu(), want, tol)
        walls = time_runs(run, init, reps=1 if rt.name == "serialized" else 3)
        tasks = g.num_tasks
        rung_rows.append({
            "run": label, "runtime": rt.name, "options": rt.options, "pattern": g.pattern,
            "W": g.width, "T": g.steps, "kind": g.kernel.kind, "grain": g.kernel.iterations,
            "us_per_step": min(walls) / g.steps * 1e6, "us_per_task": min(walls) / tasks * 1e6,
            "host_calls": calls, "launches": d[body], "device_ops": rt.dispatches_per_run(g),
            "graphs": len(getattr(run, "graphs", [])) or (1 if isinstance(run, GraphRun) else 0),
            "nodes": getattr(run, "nodes", None), "build_s": build_s, "pool_mb": pool_mb,
            "max_abs_err": err, "bit_for_bit_fused": bool(torch.equal(out.cpu(), want))})
        return out.cpu()

    RUNGS = (("bsp", {}), ("bsp_scan", {}), ("overlap", {}), ("overlap", {"overlap": False}),
             ("overlap", {"halo_via": "allgather"}))
    refused = {}
    for pattern in HALO_PATTERNS:
        g = TaskGraph(steps=T_MAIN, width=W_MAIN, pattern=pattern, payload=PAYLOAD,
                      kernel=KernelSpec("compute_bound", GRAIN), radius=2, seed=0)
        init = rand(W_MAIN, PAYLOAD)
        want = reference(g, init)
        for rt_name, opts in RUNGS:
            rt = get_runtime(rt_name, use_kernels=True, **opts)
            ok, why = rt.supports(g)
            if not ok:
                refused[f"{pattern} {rt_name}"] = why
                continue
            rung(f"{pattern} {rt_name}{opts or ''}", rt, g, init, want, TOL)
        if pattern == "stencil_1d":  # both buffer schemes, the same bits
            a = rung("stencil_1d bsp{'donate': False}",
                     get_runtime("bsp", use_kernels=True, donate=False), g, init, want, TOL)
            b = get_runtime("bsp", use_kernels=True).execute(g, init)
            if not torch.equal(a, torch.from_numpy(b)):
                fail("[rungs] bsp donate=False differs from donate=True")
    g = TaskGraph(steps=T_MAIN, width=W_MAIN, pattern="stencil_1d", payload=PAYLOAD,
                  kernel=KernelSpec("memory_bound", 4, scratch=2048), seed=0)
    init = rand(W_MAIN, PAYLOAD)
    want = reference(g, init)
    for rt_name in ("bsp", "bsp_scan", "overlap"):
        rung(f"memory_bound {rt_name}", get_runtime(rt_name, use_kernels=True), g, init, want,
             TOL_MEMORY_RUN)
    for pattern in ("fft", "spread"):
        g = TaskGraph(steps=T_MAIN, width=W_GATHER, pattern=pattern, payload=PAYLOAD,
                      kernel=KernelSpec("compute_bound", GRAIN), seed=0)
        init = rand(W_GATHER, PAYLOAD)
        want = reference(g, init)
        for rt_name in ("bsp", "bsp_scan"):
            rung(f"{pattern} {rt_name}", get_runtime(rt_name, use_kernels=True), g, init,
                 want, TOL, bits=pattern == "fft")
    ser = get_runtime("serialized", use_kernels=True)
    g_main = TaskGraph(steps=T_MAIN, width=W_MAIN, pattern="stencil_1d", payload=PAYLOAD,
                       kernel=KernelSpec("compute_bound", GRAIN))
    ok, why = ser.supports(g_main)
    if ok:
        fail("[rungs] serialized accepted the main path's 2.1 M tasks")
    refused[f"stencil_1d serialized W={W_MAIN} T={T_MAIN}"] = why
    for grain in (GRAIN, 1):
        g = TaskGraph(steps=T_SER, width=SMS, pattern="stencil_1d", payload=PAYLOAD,
                      kernel=KernelSpec("compute_bound", grain), seed=0)
        init = rand(SMS, PAYLOAD)
        rung(f"stencil_1d serialized grain {grain}", ser, g, init, reference(g, init), TOL)
    # K = 4 ensembles, mixed horizons: round-robin host calls (bsp,
    # serialized) or one graph; each member bit for bit its eager loop
    ens_rows = []

    def rung_ensemble(label: str, rt, members, xs, wants):
        """``rt``'s run of the ensemble of ``members`` on ``xs``: its K1
        launches (``body_launches_per_run``) and host calls counted, each
        member bit for bit its eager loop and held to ``wants`` within TOL
        (another run of that member alone), timed (best of 3; serialized:
        1)."""
        nonlocal check_calls
        ens = GraphEnsemble(members)
        run = rt.build_ensemble(ens)
        outs, d, calls = counted_calls(lambda: run(xs))
        eager = getattr(run, "eager", run)
        again, d_eager, h_eager = counted_calls(lambda: eager(tuple(x.clone() for x in xs)))
        for k, n in d_eager.items():
            check_launches[k] += n
        check_calls += h_eager
        want_k1 = rt.body_launches_per_run(ens)
        if d["taskbench_compute"] != want_k1 or sum(d.values()) != want_k1 or d_eager != d:
            fail(f"[rungs] {label}: launches {d} (eager {d_eager}), expected {want_k1} K1")
        if calls != rt.host_calls_per_run(ens):
            fail(f"[rungs] {label}: {calls} host calls, expected {rt.host_calls_per_run(ens)}")
        errs = []
        for k, (a, b, w) in enumerate(zip(outs, again, wants)):
            if not torch.equal(a, b):
                fail(f"[rungs] {label} member {k}: the run differs from its eager loop")
            errs.append(check_close(f"[rungs] {label} member {k} vs its own run",
                                    a.cpu(), w, TOL))
        walls = time_runs(run, xs, reps=1 if rt.name == "serialized" else 3)
        ens_rows.append({"run": label, "runtime": rt.name, "K": len(members),
                         "W": [g.width for g in members], "T": [g.steps for g in members],
                         "patterns": [g.pattern for g in members],
                         "grain": [g.kernel.iterations for g in members],
                         "host_calls": calls, "launches": d["taskbench_compute"],
                         "us_per_step": min(walls) / ens.steps * 1e6, "max_abs_err": max(errs)})

    # at grain 64 (the main path's width; serialized at W = 132), each
    # member against fused(kernels)'s run of it alone
    ens_cases = {}
    for W, horizons in ((W_MAIN, HETERO_T), (SMS, T_SER_ENS)):
        members = [TaskGraph(steps=T, width=W, pattern="stencil_1d", payload=PAYLOAD,
                             kernel=KernelSpec("compute_bound", GRAIN), seed=k)
                   for k, T in enumerate(horizons)]
        xs = tuple(rand(W, PAYLOAD) for _ in members)
        ens_cases[W] = (members, xs, [reference(g, x) for g, x in zip(members, xs)])
    for rt_name, W in (("bsp", W_MAIN), ("bsp_scan", W_MAIN), ("overlap", W_MAIN),
                       ("serialized", SMS)):
        rung_ensemble(f"K={K_ENS} {rt_name} grain {GRAIN}",
                      get_runtime(rt_name, use_kernels=True), *ens_cases[W])
    # at grain 1, where the dataflow shows: K = 4 members of mixed patterns
    # and horizons (the first four a rung runs of ENS_SHORT; a T = 1 member
    # frozen from the start), each against the plain path's run of it alone
    # on the CPU: bsp's round-robin replays skip the frozen members,
    # bsp_scan's and overlap's one graph masks them
    cpu = get_runtime("fused", device="cpu")
    for rt_name in ("bsp", "bsp_scan", "overlap", "serialized"):
        rt = get_runtime(rt_name, use_kernels=True)
        members = [TaskGraph(steps=T, width=W_SMALL, pattern=p, payload=PAYLOAD, radius=2,
                             kernel=KernelSpec("compute_bound", 1), seed=10 + k)
                   for k, (p, T) in enumerate(ENS_SHORT)]
        members = [g for g in members if rt.supports(g)[0]][:K_ENS]
        xs = tuple(rand(W_SMALL, PAYLOAD) for _ in members)
        wants = [torch.from_numpy(cpu.execute(g, x.cpu())) for g, x in zip(members, xs)]
        rung_ensemble(f"K={K_ENS} {rt_name} grain 1 {[g.pattern for g in members]}", rt,
                      members, xs, wants)
    # grain 1, where the dataflow shows: every pattern each rung runs, each
    # option, against the plain path on the CPU
    n_small = 0
    for pattern in (*HALO_PATTERNS, "fft", "tree", "spread", "all_to_all"):
        g = TaskGraph(steps=8, width=W_SMALL, pattern=pattern, payload=PAYLOAD,
                      kernel=KernelSpec("compute_bound", 1), radius=3, seed=1)
        want = torch.from_numpy(cpu.execute(g))
        init = cpu._init(g, None)
        for rt_name, opts in (*RUNGS, ("bsp", {"donate": False}), ("serialized", {})):
            rt = get_runtime(rt_name, use_kernels=True, **opts)
            if rt.supports(g)[0]:
                check_close(f"[rungs] small {pattern} {rt_name}{opts or ''}",
                            torch.from_numpy(rt.execute(g, init)), want, TOL)
                n_small += 1
    # device kernels of a short run, by torch.profiler: one event per
    # counted operation (the replays', without the output's clone). A
    # profiling window late in this process drops the first device events
    # it sees (12-15 of a bsp run's 32; [plans] reads the last of two
    # replays for the same reason), so the run is issued PROFILE_ISSUES
    # times in one window, each behind a marker kernel (a short device
    # sleep), and the events after the last marker are the run's.
    def profiled(issue):
        """(device kernel names, {name: (count, device us)}, launches, host
        calls) of the last of PROFILE_ISSUES calls of ``issue()`` in one
        torch.profiler window; every call's launches and host calls are
        kept apart in check_launches and check_calls."""
        nonlocal check_calls
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_ISSUES):
                torch.cuda._sleep(1000)  # the marker
                _, d, calls = counted_calls(issue)
                for k, n in d.items():
                    check_launches[k] += n
                check_calls += calls
        events = sorted((e.time_range.start, e.name, e.time_range.elapsed_us())
                        for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA)
        marks = [i for i, (_, name, _) in enumerate(events)
                 if "spin_kernel" in name or "sleep" in name.lower()]
        if not marks:
            fail("[rungs] the profiler recorded no marker kernel")
        names, by_kernel = [], {}
        for _, name, us in events[marks[-1] + 1:]:
            names.append(name)
            n, total = by_kernel.get(name[:48], (0, 0.0))
            by_kernel[name[:48]] = (n + 1, total + us)
        return names, by_kernel, d, calls

    prof_rows = {}
    gp = TaskGraph(steps=T_PROFILED, width=W_MAIN, pattern="nearest", payload=PAYLOAD,
                   kernel=KernelSpec("compute_bound", GRAIN), radius=2, seed=0)
    gs = TaskGraph(steps=2, width=8, pattern="stencil_1d", payload=PAYLOAD,
                   kernel=KernelSpec("compute_bound", GRAIN), seed=0)
    for rt_name, g in (("bsp", gp), ("bsp_scan", gp), ("overlap", gp), ("serialized", gs)):
        rt = get_runtime(rt_name, use_kernels=True)
        run = rt.build(g)
        init = rand(g.width, PAYLOAD)
        run(init)
        if isinstance(run, GraphRun):
            run.stage(init)
            issue = run.graphed.replay
        elif isinstance(run, ReplayLoop):
            run.stage(init)
            issue = lambda run=run: [run.graphs[i].replay() for i in run.eager.order]
        else:
            issue = lambda run=run, init=init: run(init)
        names, by_kernel, d, calls = profiled(issue)
        run_events, run_k1 = len(names), sum("fma_kernel" in n for n in names)
        if run_events != rt.dispatches_per_run(g) or run_k1 != d["taskbench_compute"] \
                or calls != rt.host_calls_per_run(g):
            fail(f"[rungs] {rt_name} profiled: {run_events} device kernels ({run_k1} K1), "
                 f"dispatches_per_run {rt.dispatches_per_run(g)}, launch counters {d}, "
                 f"{calls} host calls: {sorted(by_kernel)}")
        if isinstance(run, ReplayLoop) and sum(run.graphs[i].nodes for i in run.eager.order) \
                != rt.dispatches_per_run(g):
            fail(f"[rungs] bsp's superstep graphs hold "
                 f"{[run.graphs[i].nodes for i in run.eager.order]} nodes")
        device_us = sum(us for _, us in by_kernel.values())
        prof_rows[rt_name] = {"W": g.width, "T": g.steps, "device_events": run_events,
                              "k1": run_k1, "host_calls": calls,
                              "per_host_call": run_events / calls,
                              "device_us": device_us,
                              "device_us_per_host_call": device_us / calls,
                              "kernels": by_kernel}
    torch.cuda.synchronize()
    total = ops.launch_counts()
    launches_rungs = {k: n - check_launches[k] for k, n in total.items()}
    for k, n in launches_rungs.items():
        if (n == 0) == (k in ("taskbench_compute", "memory_bound")):
            fail(f"[rungs] kernel {k}: {n} launches on the rungs' runs")
    for row in rung_rows:
        extra = (f", {row['us_per_task']:.3f} us a task" if row["runtime"] == "serialized"
                 else "")
        print(f"  {row['run']} W={row['W']} T={row['T']} {row['kind']} grain {row['grain']}: "
              f"{row['us_per_step']:.3f} us a step{extra}; {row['host_calls']} host calls, "
              f"{row['launches']} K1/K2 launches, {row['device_ops']} device operations a run; "
              f"{row['graphs']} graphs, {row['nodes']} nodes, built in {row['build_s']:.3f} s, "
              f"pool {row['pool_mb']:.0f} MiB; max |err| vs fused(kernels) "
              f"{row['max_abs_err']:.3g}")
    for row in ens_rows:
        print(f"  {row['run']} W={row['W']} T={row['T']}: "
              f"{row['us_per_step']:.3f} us a lockstep step, {row['host_calls']} host calls, "
              f"{row['launches']} K1 launches; max |err| vs the members' own runs "
              f"{row['max_abs_err']:.3g}", flush=True)
    ser_rows = [r for r in rung_rows if r["runtime"] == "serialized"]
    print(f"[rungs] refused: {refused}", flush=True)
    print(f"[rungs] torch.profiler, device kernels per run: "
          f"{ {k: (v['device_events'], v['k1'], v['host_calls'], round(v['device_us'], 3)) for k, v in prof_rows.items()} } "
          f"(events, K1, host calls, device us: the kernels' durations summed); serialized: "
          f"{prof_rows['serialized']['per_host_call']:.3f} device kernels and "
          f"{prof_rows['serialized']['k1'] / prof_rows['serialized']['host_calls']:.3f} K1 a "
          f"task, {[round(r['us_per_task'], 3) for r in ser_rows]} us a task (grains "
          f"{[r['grain'] for r in ser_rows]})", flush=True)
    # where the dataflow shows in the result (grain 1, memory_bound): the
    # agreement there is the evidence; at grain 64 every state sits at the
    # FMA's fixed point, and those runs check counts, graphs and bits only
    shows = [r for r in rung_rows if r["grain"] == 1 or r["kind"] == "memory_bound"]
    ens_shows = [r for r in ens_rows if set(r["grain"]) == {1}]
    print(f"[rungs] {len(rung_rows)} runs (bsp, bsp_scan, overlap three ways on the main "
          f"path's halo patterns, memory_bound, fft and spread at W={W_GATHER}, serialized "
          f"at W={SMS} T={T_SER}) and {len(ens_rows)} K={K_ENS} ensembles: every bsp_scan "
          f"and overlap run one graph replay, every bsp superstep one replay (one host call), "
          f"every serialized task one host call, each equal to its eager loop bit for bit; "
          f"held to a reference where the dataflow shows: {len(shows)} single runs (grain 1, "
          f"memory_bound) against fused(kernels), {len(ens_shows)} grain-1 ensembles and "
          f"{n_small} grain-1 runs at W={W_SMALL} against the CPU plain path; "
          f"{len(rung_rows) - len(shows)} runs and {len(ens_rows) - len(ens_shows)} ensembles "
          f"at grain {GRAIN} (the fixed point); launches {launches_rungs} (and "
          f"{check_launches}, {check_calls} host calls, by the eager loops and the "
          f"references); {time.perf_counter() - t0:.3f} s | {smi}", flush=True)
    print(json.dumps({"rungs": {"runs": rung_rows, "ensembles": ens_rows,
                                "profiled": prof_rows, "refused": refused}}), flush=True)

    # --------------------------------------------------------------- shards
    launches_shards, _ = shards_phase(dev, rand, smi, counted_calls, T=T_SHARD)

    # ---------------------------------------------------------------- trace
    trace_phase(dev, rand, smi)

    # ----------------------------------------------------------------- METG
    t0 = time.perf_counter()
    step_wall, step_wall_eager = {}, {}
    for od in (1, 16):
        W = SMS * od
        for rt_name, opts in (
                ("pallas_step", {}), ("fused", {"use_kernels": True}),
                ("pallas_step", {"steps_per_launch": S_MAIN}),
                ("pallas_step", {"steps_per_launch": S_MAIN, "pipeline": False})):
            rt = get_runtime(rt_name, **opts)
            if opts.get("steps_per_launch"):
                rt_name += f"[S={S_MAIN}{',serial' if 'pipeline' in opts else ''}]"
            samples = []
            for grain in GRAINS:
                g = TaskGraph(steps=T_MAIN, width=W, pattern="stencil_1d",
                              payload=PAYLOAD, kernel=KernelSpec("compute_bound", grain))
                s, st = rt.measure(g, reps=5, warmup=1)
                samples.append(s)
                step_wall[(rt_name, W, grain)] = s.wall_time / T_MAIN
                eager = ""
                if grain in (1, GRAIN):
                    # the same run's eager loop, timed alike: what capture removes
                    walls = time_runs(rt._build_eager(g), rand(W, PAYLOAD), reps=5)
                    step_wall_eager[(rt_name, W, grain)] = min(walls) / T_MAIN
                    eager = f"; eager loop {min(walls) / T_MAIN * 1e6:.3f} us/step"
                print(f"  {rt_name} W={W} grain={grain}: wall {s.wall_time:.6f} s "
                      f"({s.wall_time / T_MAIN * 1e6:.3f} us/step as one graph{eager}, "
                      f"{s.flops_per_second / 1e9:.3f} GFLOP/s, "
                      f"granularity {s.granularity_us:.4f} us, "
                      f"{st.dispatches} launches, captured in {st.capture_s:.6f} s, "
                      f"{st.graph_nodes} nodes)")
            m = compute_metg(samples)
            metg = "unreached" if m.metg_us is None else f"{m.metg_us:.4f} us"
            print(f"METG(50%) {rt_name} W={W} (od {od}, T={T_MAIN}, 5 reps): "
                  f"{metg}, peak {m.peak_flops_per_second / 1e9:.3f} GFLOP/s "
                  f"| {smi}", flush=True)
    print(json.dumps({"metg_step_us": [
        {"runtime": k[0], "W": k[1], "grain": k[2], "graph": step_wall[k] * 1e6,
         "eager": step_wall_eager[k] * 1e6} for k in step_wall_eager]}), flush=True)
    print(f"[metg] {time.perf_counter() - t0:.3f} s | {smi}", flush=True)

    # ---------------------------------------------------------------- serve
    n_layers, steps = cfg_serve.n_layers, SERVE_GEN - 1
    _, res, serve_launches, serve_stats = serve_path(
        dev, smi, "[serve]", cfg_serve, SERVE_B, SERVE_PROMPT, SERVE_GEN,
        dict(flash_attention=n_layers, decode_attention=n_layers * steps),
        {"max": TOL_SERVE_REL, "rms": None}, keep_logits=True)
    rep = res.report
    # mamba2-130m: K7 once per layer in the prefill, no kernel in decode
    _, res_ssm, ssm_launches, ssm_stats = serve_path(
        dev, smi, "[serve-ssm]", cfg_ssm, SSM_B, SSM_PROMPT, SSM_GEN,
        dict(ssd_chunk=cfg_ssm.n_layers), TOL_SERVE_SSM)
    # hymba-1.5b: K5 and K7 once per layer in the prefill, K6 per layer and step
    hl, hs = cfg_hyb.n_layers, HYB_GEN - 1
    _, _, hyb_launches, hyb_stats = serve_path(
        dev, smi, "[serve-hybrid]", cfg_hyb, HYB_B, HYB_PROMPT, HYB_GEN,
        dict(flash_attention=hl, ssd_chunk=hl, decode_attention=hl * hs), TOL_SERVE_HYB)
    # the MoE kind, cross-attention over image tokens, embedding inputs, the
    # int8 KV cache and the other registered archs
    kinds_launches = serve_kinds_phase(dev, smi, res.logits, res.tokens)
    res.logits = None

    # ---------------------------------------------------------------- train
    # one train step on the card against the CPU's, the restart drill and
    # train() at internlm2-1.8b's full width: no kernel of the port runs
    train_phase(dev, smi)

    # ----------------------------------------------------------------- norm
    # K8's one entry point, ops.rmsnorm, over mamba2-130m's norm shapes: the
    # embedded prompts of the served batch (d_model rows) and a gated-norm
    # input (ssm_inner rows), bf16, with the model's f32 weights
    t0 = time.perf_counter()
    emb = Model(cfg_ssm, device=dev, seed=0)
    xs = [emb.embed[make_prompts(cfg_ssm, SSM_B, SSM_PROMPT, 0, dev)].to(torch.bfloat16)
          .reshape(-1, cfg_ssm.d_model),
          normal(SSM_B * SSM_PROMPT, cfg_ssm.ssm_inner, dtype=torch.bfloat16)]
    ws = [emb.final_norm.detach(), emb.layers[0].ssm.norm_w.detach()]
    del emb
    ops.reset_launch_counts()
    normed = [ops.rmsnorm(x, w, cfg_ssm.norm_eps) for x, w in zip(xs, ws)]
    torch.cuda.synchronize()
    norm_launches = ops.launch_counts()
    if norm_launches != dict(dict.fromkeys(_build.ENTRIES, 0), rmsnorm=len(xs)):
        fail(f"[norm] launches {norm_launches}")
    for x, w, o in zip(xs, ws, normed):
        errs["rmsnorm"] = max(errs["rmsnorm"], check_scaled(
            f"[norm] {tuple(x.shape)}", o, ref.rmsnorm_plain(x, w, cfg_ssm.norm_eps)))
    print(f"[norm] ops.rmsnorm over {[tuple(x.shape) for x in xs]} bf16: launches "
          f"{norm_launches['rmsnorm']} K8, agree with the plain version; "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    # ---------------------------------------------------------------- times
    x = rand(W_MAIN, PAYLOAD)
    H, D = 1, 3  # stencil_1d: the METG pattern
    g = TaskGraph(steps=T_MAIN, width=W_MAIN, pattern="stencil_1d", payload=PAYLOAD,
                  kernel=KernelSpec("compute_bound", GRAIN))
    from repro_torch.core.runtimes.pallas_step import _window_operands

    _, w_np = _window_operands(g, H)
    wgt = torch.from_numpy(w_np)[None].to(dev)
    k3_state = rand(1, W_MAIN, PAYLOAD)  # K3 reads it with the halo wrap folded in
    n_el = W_MAIN * PAYLOAD
    mem_it, scratch = 4, 2048
    step_kw = dict(kind="compute_bound", iterations=GRAIN, scratch=scratch,
                   combine="window")
    cases = [
        ("taskbench_compute", "K1", "src/repro_torch/kernels/csrc/taskbench_compute.cu",
         "src/repro/kernels/taskbench_compute.py:30",
         lambda: ops.taskbench_compute(x, GRAIN),
         lambda: apply_body(x, "compute_bound", GRAIN, 0),
         2 * n_el * 4, 2 * n_el * GRAIN),
        ("memory_bound", "K2", "src/repro_torch/kernels/csrc/memory_bound.cu",
         "src/repro/kernels/bodies.py:107",
         lambda: ops.taskbench_memory(x, mem_it, scratch),
         lambda: apply_body(x, "memory_bound", mem_it, scratch),
         2 * n_el * 4, W_MAIN * (scratch * (mem_it + 1) + PAYLOAD)),
        ("taskbench_step", "K3", "src/repro_torch/kernels/csrc/taskbench_step.cu",
         "src/repro/kernels/taskbench_step.py:368",
         lambda: ops.taskbench_step(k3_state, None, wgt, wrap=H, **step_kw),
         lambda: taskbench_step_plain(k3_state, None, wgt, wrap=H, **step_kw),
         (k3_state.numel() + wgt.numel() + n_el) * 4, n_el * (2 * D + 2 * GRAIN)),
    ]
    # K4 at the blocked main path's shape: nearest (r = 2, window D = 5),
    # S = 8, a buffer of M = W + 2 * S * r = 2144 rows
    gb = TaskGraph(steps=T_MAIN, width=W_MAIN, pattern="nearest", payload=PAYLOAD,
                   kernel=KernelSpec("compute_bound", GRAIN), radius=2)
    Hb, Db = 2, 5
    depth = S_MAIN * Hb
    M = W_MAIN + 2 * depth
    wb = torch.from_numpy(_window_operands(gb, Hb)[1])[None].to(dev)
    wext = wrap_rows(wb, depth)
    srcb = rand(1, M, PAYLOAD)
    actb = torch.ones((1, S_MAIN), device=dev)
    blk_kw = dict(step_kw, steps_per_launch=S_MAIN)

    def k4_cost(rows):
        """(bytes, f32 operations) of one K4 launch on a `rows`-row buffer:
        src, weights and act read once, the buffer written once; per depth
        a D-tap combine and the grain-64 FMA chain per element."""
        return ((2 * rows * PAYLOAD + rows * Db + S_MAIN) * 4,
                S_MAIN * rows * PAYLOAD * (2 * Db + 2 * GRAIN))

    # K4's three forms at the same launch: the tiled one (the main path's,
    # radius 2 declared), the cooperative and the resident one (each pinned)
    k4_kw = {K4_TILED: dict(blk_kw, radius=Hb), K4_COOP: dict(blk_kw, form="cooperative"),
             K4_RES: dict(blk_kw, form="resident")}
    for kname, tag in ((K4_TILED, "K4 tiled"), (K4_COOP, "K4 cooperative"),
                       (K4_RES, "K4 resident")):
        cases.append(
            (kname, tag, "src/repro_torch/kernels/csrc/taskbench_blocked.cu",
             "src/repro/kernels/taskbench_step.py:275",
             lambda kw=k4_kw[kname]: ops.taskbench_step(srcb, None, wext, actb, **kw),
             lambda: taskbench_step_blocked_plain(srcb, None, wext, actb, **step_kw),
             *k4_cost(M)))
    kernels = []
    for kname, tag, source, replaces, kern, plain, nbytes, nops in cases:
        check_close(f"{tag} timing inputs", kern(), plain(), TOL)
        ms = gpu_ms(kern, 200)
        # K4's plain version issues ~1100 operations per call, more than
        # the launch queue holds: its time spans the host's enqueue gaps
        k4_case = tag.startswith("K4")
        plain_ms = gpu_ms(plain, 2, cover=False) if k4_case else gpu_ms(plain, 4)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / F32_FLOPS_PER_S * 1e3
        per_run = blocked_launches.get(kname, {}) if k4_case else T_MAIN
        path_launches = launches[kname]
        if kname == K4_RES:  # its path: the blocked all-gather plan's runs
            per_run = {"allgather": -(-(T_MAIN - 1) // S_MAIN)}
            path_launches = launches_plans[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path_launches, "max_abs_err": errs[kname],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "launches_per_run": per_run,
            "launches_by_path": {"main": launches[kname], "plans": launches_plans[kname],
                                 "ensemble": launches_ens[kname],
                                 "schedule": launches_sched[kname],
                                 "resilience": launches_res[kname],
                                 "serving": launches_serving[kname],
                                 "restart": launches_restart[kname],
                                 "rungs": launches_rungs[kname],
                                 "shards": launches_shards[kname]},
        })
        if kname in ("taskbench_compute", "taskbench_step"):
            # the grid its wrapper launched in the timing above
            kernels[-1]["ctas"] = _build.LAST_CTAS[kname]
        print(f"[time] {tag} {kname}: {ms * 1e3:.3f} us per launch, {per_run} "
              f"launches per main-path run (plain version {plain_ms * 1e3:.3f} us, "
              f"no yardstick; no single PyTorch call computes it), bound "
              f"{max(t_bytes, t_ops) * 1e3:.3f} us by "
              f"{'bytes' if t_bytes >= t_ops else 'operations'} | {smi}", flush=True)
    # K2 moves its bytes through shared memory: per row the tile-out writes
    # `scratch` floats, each pass reads and writes them, the fold reads them
    # back; against 132 SMs x 128 B per clock at the card's top SM clock
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    k2 = kernels[1]
    k2["smem_bytes"] = W_MAIN * 4 * scratch * (2 * mem_it + 2)
    k2["smem_bytes_per_s"] = SMS * 128 * sm_mhz * 1e6
    k2["smem_bound_ms"] = k2["smem_bytes"] / k2["smem_bytes_per_s"] * 1e3
    k2["binds"] = "shared memory" if k2["smem_bound_ms"] > k2["bound_ms"] else k2["bound_by"]
    print(f"[time] K2 memory_bound: {k2['smem_bytes']} shared-memory bytes per launch at "
          f"{SMS} SMs x 128 B x {sm_mhz:.0f} MHz: bound {k2['smem_bound_ms'] * 1e3:.3f} us "
          f"({k2['binds']} binds), against {k2['ms'] * 1e3:.3f} us | {smi}", flush=True)
    # K1 and K3 (window D = 3, stencil_1d's; K3 as the S = 1 steps launch
    # it, the halo wrap folded in, and on the row-gathered source beside it)
    # at one task an SM and at the main path's width, grain 64 and 16384:
    # the CTAs each launch ran, beside the launch floor and the bound's
    # latency term (the FMA's dependent latency from a clock-mark probe, x
    # each element's chain of FMAs). The derived bounds sit under "bounds".
    floor = kernel_times.floor_case()
    latency = (floor["fma_latency_cycles"], floor["sm_max_mhz"])
    print(f"[time] launch floor (an empty kernel) {floor['ms'] * 1e3:.3f} us; the body's "
          f"FMA {latency[0]:.3f} cycles dependent latency at {latency[1]:.0f} MHz | {smi}",
          flush=True)
    for k, (tag, tol) in enumerate((("K1", TOL_K1), ("K3", TOL))):
        rec = kernels[2 * k]  # K1, then K3
        rec["launch_floor_ms"] = floor["ms"]
        rec["fma_latency_cycles"] = latency[0]
        rec["shapes"] = {}
        for W, grain in itertools.product((SMS, W_MAIN), (GRAIN, 16384)):
            if tag == "K1":
                t = kernel_times.k1_case(W, grain, latency)
            else:
                t = kernel_times.k3_case(W, "window", 3, grain, latency, step=True)
                if not t["equal_to_gather_then_k3"]:
                    fail(f"[time] K3 W={W} grain {grain}: folded != row gather + K3")
                unfolded = kernel_times.k3_case(W, "window", 3, grain, latency)
                t["unfolded_ms"] = unfolded["ms"]
            if not t["max_abs_err"] <= tol:
                fail(f"[time] {tag} W={W} grain {grain}: max abs error {t['max_abs_err']}")
            bounds = {key: t[key] for key in (
                "bound_ms", "bound_by", "latency_ms", "bound_with_latency_ms",
                "bound_with_latency_by")}
            shape = {"ctas": t["ctas"], "ms": t["ms"], "bounds": bounds}
            extra = ""
            if tag == "K3":
                shape["unfolded_ms"] = t["unfolded_ms"]
                extra = (f" (folded; on the row-gathered source, the t = 0 launch's "
                         f"form, {t['unfolded_ms'] * 1e3:.3f} us)")
            rec["shapes"][f"W={W} grain {grain}"] = shape
            if (W, grain) == (W_MAIN, GRAIN):
                rec["bounds"] = {key: bounds[key] for key in (
                    "latency_ms", "bound_with_latency_ms", "bound_with_latency_by")}
            print(f"[time] {tag} W={W} P={PAYLOAD} grain {grain}: {t['ms'] * 1e3:.3f} us"
                  f"{extra}, {t['ctas']} CTAs; bound "
                  f"{t['bound_with_latency_ms'] * 1e3:.3f} us by "
                  f"{t['bound_with_latency_by']} (bytes or operations "
                  f"{t['bound_ms'] * 1e3:.3f} us, latency {t['latency_ms'] * 1e3:.3f} us); "
                  f"launch floor {floor['ms'] * 1e3:.3f} us | {smi}", flush=True)
    k3_us = kernels[2]["ms"] * 1e3
    wall_us = step_wall[("pallas_step", W_MAIN, GRAIN)] * 1e6
    # K3's time above is per launch queued on a stream, launch gaps in it;
    # the graph's nodes launch closer together, so the ratio may pass 1
    print(f"[time] pallas_step W={W_MAIN} grain {GRAIN}: step wall {wall_us:.3f} us as "
          f"a graph replay, K3 (folded, the step's one launch) {k3_us:.3f} us per launch "
          f"on a stream: ratio {k3_us / wall_us:.4f}")
    # K4's pipelined phases at their shapes, the boundary buffer (6 * depth
    # rows) and the interior (the owned W rows), and its cost per depth (the
    # full buffer at S = 2 beside S = S_MAIN), in each form
    ph = ps_mod._phase_tables(None, wb, depth, "window")
    state = rand(1, W_MAIN, PAYLOAD)
    bl, br = rand(1, 3 * depth, PAYLOAD), rand(1, 3 * depth, PAYLOAD)
    act2 = torch.ones((1, 2), device=dev)
    k4s = {K4_TILED: kernels[3], K4_COOP: kernels[4], K4_RES: kernels[5]}
    for kname, k4 in k4s.items():
        kw = k4_kw[kname]
        for phase, fn, rows in (
                ("boundary", lambda: ops.taskbench_boundary(
                    bl, br, ph.i_bnd, ph.w_bnd, actb, depth=depth, **kw), 6 * depth),
                ("interior", lambda: ops.taskbench_interior(
                    state, ph.i_int, ph.w_int, actb, depth=depth, **kw), W_MAIN)):
            ms = gpu_ms(fn, 200)
            nbytes, nops = k4_cost(rows)
            bound = max(nbytes / HBM_BYTES_PER_S, nops / F32_FLOPS_PER_S) * 1e3
            k4[f"{phase}_ms"], k4[f"{phase}_bound_ms"] = ms, bound
            print(f"[time] {kname} {phase} launch ({rows} rows, S={S_MAIN}): "
                  f"{ms * 1e3:.3f} us, bound {bound * 1e3:.3f} us | {smi}", flush=True)
        k4["ms_at_S2"] = ms2 = gpu_ms(lambda: ops.taskbench_step(
            srcb, None, wext, act2, **dict(kw, steps_per_launch=2)), 200)
        k4["per_depth_ms"] = per_depth = (k4["ms"] - ms2) / (S_MAIN - 2)
        k4["per_launch_besides_ms"] = ms2 - 2 * per_depth
        print(f"[time] {kname} full buffer: S=2 {ms2 * 1e3:.3f} us, S={S_MAIN} "
              f"{k4['ms'] * 1e3:.3f} us: {per_depth * 1e3:.3f} us per depth, "
              f"{k4['per_launch_besides_ms'] * 1e3:.3f} us per launch besides | {smi}",
              flush=True)
    k4 = k4s[K4_TILED]
    # one whole pipelined launch (two concatenations, the two phases, the
    # stitching concatenation) as the main path runs it, its interior on the
    # same stream or on a second one: how far the two K4 launches overlap
    hl, hr = ps_mod._prologue_exchange(state, depth)
    side = torch.cuda.Stream()
    for label, stream in (("one stream", None), ("two streams", side)):
        # ~9 operations per call: 50 calls stay within the launch queue
        k4[f"pipelined_launch_ms_{label.replace(' ', '_')}"] = ms = gpu_ms(
            lambda: ps_mod._pipelined_launch(state, hl, hr, actb, ph, depth,
                                             k4_kw[K4_TILED], stream), 50)
        # the same launches captured as one graph, 20 a graph: with the
        # interior on the second stream its phases are parallel branches
        cs = torch.cuda.Stream()
        cs.wait_stream(torch.cuda.current_stream())

        def twenty(stream=stream):
            for _ in range(20):
                ps_mod._pipelined_launch(state, hl, hr, actb, ph, depth,
                                         k4_kw[K4_TILED], stream)

        with torch.cuda.stream(cs):
            twenty()  # the warm-up
            pg = Graphed(twenty, cs)
        torch.cuda.current_stream().wait_stream(cs)
        k4[f"pipelined_launch_graph_ms_{label.replace(' ', '_')}"] = gms = \
            gpu_ms(pg.replay, 20) / 20
        pg.close()
        print(f"[time] pipelined launch, interior on {label}: {ms * 1e3:.3f} us queued "
              f"on the stream(s), {gms * 1e3:.3f} us as graph nodes (boundary "
              f"{k4['boundary_ms'] * 1e3:.3f} + interior {k4['interior_ms'] * 1e3:.3f} us "
              f"alone) | {smi}", flush=True)
    for label, key, k4_us in (
            ("serial", f"pallas_step[S={S_MAIN},serial]", k4["ms"] * 1e3),
            ("pipelined", f"pallas_step[S={S_MAIN}]",
             (k4["boundary_ms"] + k4["interior_ms"]) * 1e3)):
        wall_us = step_wall[(key, W_MAIN, GRAIN)] * 1e6
        print(f"[time] {key} W={W_MAIN} grain {GRAIN}: step wall {wall_us:.3f} us "
              f"per timestep as a graph replay, K4 {k4_us / S_MAIN:.3f} us per timestep "
              f"on a stream ({label}): ratio {k4_us / S_MAIN / wall_us:.4f}")

    # K3 and K4 as the plans launch them, beside their bounds: K3 in its pair
    # mode on the [x | partner] halves of a W_PLAN-row stride step; K3
    # gathering D = 512 slots (all_to_all at the cap without the row mean);
    # K4's resident and cooperative forms on the time-varying (1, S, W, 2)
    # tables of a blocked fft launch (its first launch's, as the runtime
    # builds them) at W = 512 and 2048, and on all_to_all's static (1, 512,
    # 512) table at the cap (D = W)
    pair_src = rand(1, 2 * W_PLAN, PAYLOAD)
    pair_w = torch.zeros((1, W_PLAN, 1), device=dev)
    a2a = tb_graph("all_to_all", W_GATHER)
    a2a_i, a2a_w = (torch.from_numpy(a[:1]).to(dev)
                    for a in ps_mod._global_slot_operands(a2a))
    a2a_src = rand(1, W_GATHER, PAYLOAD)
    tv_act = torch.ones((1, S_MAIN), device=dev)
    P_ = PAYLOAD
    plan_cases = [
        (kernels[2], "pair", f"K3 pair W={W_PLAN}",
         lambda: ops.taskbench_step(pair_src, None, pair_w, **dict(step_kw, combine="pair")),
         lambda: taskbench_step_plain(pair_src, None, pair_w, **dict(step_kw, combine="pair")),
         3 * W_PLAN * P_ * 4, W_PLAN * P_ * (2 + 2 * GRAIN)),
        (kernels[2], "gather_d512", f"K3 gather W={W_GATHER} D={W_GATHER}",
         lambda: ops.taskbench_step(a2a_src, a2a_i, a2a_w, **dict(step_kw, combine="gather")),
         lambda: taskbench_step_plain(a2a_src, a2a_i, a2a_w,
                                      **dict(step_kw, combine="gather")),
         (2 * W_GATHER * P_ + 2 * W_GATHER * W_GATHER) * 4,
         W_GATHER * P_ * (2 * W_GATHER + 2 * GRAIN)),
    ]
    k4_plan_ops = []  # (key, W, D, src, idx, wgt): the blocked all-gather launches
    for W in (W_GATHER, W_PLAN):
        tables_at, key_of, _ = get_runtime("pallas_step")._global_table_fn(tb_graph("fft", W))
        tv_i, tv_w, _ = ps_mod._stack_tables(tables_at, key_of,
                                             [list(range(1, S_MAIN + 1))], dev)
        key = "time_varying" if W == W_GATHER else f"time_varying_W{W}"
        k4_plan_ops.append((key, W, 2, rand(1, W, PAYLOAD), tv_i, tv_w))
    k4_plan_ops.append(("all_to_all_d512", W_GATHER, W_GATHER, a2a_src, a2a_i, a2a_w))
    for key, W, Dp, src_p, i_p, w_p in k4_plan_ops:
        n_tables = S_MAIN if w_p.ndim == 4 else 1
        for rec, form in ((kernels[5], "resident"), (kernels[4], "cooperative")):
            plan_cases.append((
                rec, key, f"K4 {form} {'time-varying' if w_p.ndim == 4 else 'static'} "
                f"M={W} D={Dp}",
                lambda s_=src_p, i_=i_p, w_=w_p, f_=form: ops.taskbench_step(
                    s_, i_, w_, tv_act, **dict(blk_kw, combine="gather", form=f_)),
                lambda s_=src_p, i_=i_p, w_=w_p: taskbench_step_blocked_plain(
                    s_, i_, w_, tv_act, **dict(step_kw, combine="gather")),
                (2 * W * P_ + 2 * n_tables * W * Dp + S_MAIN) * 4,
                S_MAIN * W * P_ * (2 * Dp + 2 * GRAIN)))
    for rec, key, tag, kern, plain, nbytes, nops in plan_cases:
        check_close(f"{tag} timing inputs", kern(), plain(), TOL)
        ms = gpu_ms(kern, 200)
        plain_ms = gpu_ms(plain, 2, cover=False) if tag.startswith("K4") else gpu_ms(plain, 4)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_FLOPS_PER_S * 1e3
        rec.setdefault("plans_shapes", {})[key] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        print(f"[time] {tag} (the plans' shape), grain {GRAIN}: {ms * 1e3:.3f} us per "
              f"launch (plain version {plain_ms * 1e3:.3f} us), bound "
              f"{max(t_bytes, t_ops) * 1e3:.3f} us by "
              f"{'bytes' if t_bytes >= t_ops else 'operations'} | {smi}", flush=True)
    del pair_src, a2a_src, k4_plan_ops
    # K4's cooperative form on the memory body at the main path's
    # memory_bound run (stencil_1d, radius 1, window D = 3, iterations 4,
    # scratch 2048, S = 8: a buffer of W + 2 * S rows), beside its bound:
    # S x K2's shared-memory bound on that buffer
    Mm = W_MAIN + 2 * S_MAIN
    src_m = rand(1, Mm, PAYLOAD)
    w_m = torch.rand((1, Mm, 3), device=dev, generator=gen) / 3
    mem_kw = dict(kind="memory_bound", iterations=mem_it, scratch=scratch, combine="window",
                  steps_per_launch=S_MAIN)
    got_m = ops.taskbench_step(src_m, None, w_m, actb, **mem_kw)
    want_m = taskbench_step_blocked_plain(src_m, None, w_m, actb,
                                          **{k: v for k, v in mem_kw.items()
                                             if k != "steps_per_launch"})
    mem_err = check_close("K4 cooperative memory body timing inputs", got_m, want_m, TOL)
    ms_m = gpu_ms(lambda: ops.taskbench_step(src_m, None, w_m, actb, **mem_kw), 50)
    smem_m = S_MAIN * Mm * 4 * scratch * (2 * mem_it + 2)
    bound_m = smem_m / k2["smem_bytes_per_s"] * 1e3
    kernels[4]["memory_body"] = {
        "rows": Mm, "S": S_MAIN, "iterations": mem_it, "scratch": scratch, "ms": ms_m,
        "max_abs_err": mem_err, "smem_bytes": smem_m, "smem_bound_ms": bound_m}
    print(f"[time] K4 cooperative memory body ({Mm} rows, S={S_MAIN}, iterations "
          f"{mem_it}, scratch {scratch}): {ms_m * 1e3:.3f} us per launch, bound "
          f"{bound_m * 1e3:.3f} us (S x K2's shared-memory bound on the buffer: "
          f"{smem_m} bytes) | {smi}", flush=True)
    del src_m, got_m, want_m

    # K5 at internlm2's and hymba's prefill shapes (bf16, and its f32 form at
    # internlm2's and at llama-vision's cross-attention, which [serve-xattn]
    # runs over f32 image K/V), K6 at the serving decode warm and L2-cold,
    # each beside scaled_dot_product_attention on the same inputs (a
    # yardstick only)
    t5, (got, want) = attention_times.flash_case(SERVE_B, Hq, Hkv, SERVE_PROMPT, hd)
    check_attn("K5 timing inputs", got, want)
    t5h, (got, want) = attention_times.flash_case(HYB_B, hq, hkv, HYB_PROMPT, hhd, window=win)
    check_attn("K5 hymba timing inputs", got, want)
    t5f, (got, want) = attention_times.flash_case(SERVE_B, Hq, Hkv, SERVE_PROMPT, hd,
                                                  dtype=torch.float32, reps=(5, 3, 20))
    check_attn("K5 f32 timing inputs", got, want)
    vlm = get_config(VLM_ARCH)
    t5x, (got, want) = attention_times.flash_case(
        VLM_B, vlm.n_heads, vlm.n_kv_heads, VLM_PROMPT, vlm.head_dim_,
        Sk=vlm.n_image_tokens, causal=False, dtype=torch.float32, reps=(5, 3, 20))
    check_attn("K5 cross-attention timing inputs", got, want)
    t6, (got, want) = attention_times.decode_case(SERVE_B, Hq, Hkv, SERVE_PROMPT, cap, hd)
    check_attn("K6 timing inputs", got, want)
    del got, want
    yard = ("library_backend", "library_pinned_ms", "library_kernels")
    k5 = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:103",
        "launches": serve_launches["flash_attention"],
        "max_abs_err": errs["flash_attention"], "ms": t5["ms"], "plain_ms": t5["plain_ms"],
        "bound_ms": t5["bound_ms"], "bound_by": t5["bound_by"],
        "library_ms": t5["library_ms"], **{key: t5[key] for key in yard},
        "shape_B_Hq_Hkv_S_D": t5["shape"], "dtype": "bfloat16",
        "hymba": {key: t5h[key] for key in ("shape", "window", "ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms", *yard)},
        "cross_attention": {"dtype": "float32",
                            **{key: t5x[key] for key in ("shape", "causal", "ms", "plain_ms",
                                                         "bound_ms", "bound_by", "library_ms",
                                                         *yard)}},
        "f32_form": {"source": "src/repro_torch/kernels/csrc/flash_attention_f32.cu",
                     "launches": serve_launches["flash_attention_f32"],
                     "launches_by_path": {path: n["flash_attention_f32"]
                                          for path, n in kinds_launches.items()
                                          if n["flash_attention_f32"]},
                     "max_abs_err": errs["flash_attention_f32"],
                     **{key: t5f[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                  "library_ms", *yard)}},
        "launches_by_path": {"serve": serve_launches["flash_attention"],
                             "serve-hybrid": hyb_launches["flash_attention"],
                             **{path: n["flash_attention"]
                                for path, n in kinds_launches.items()}},
        "launches_per_run": serve_launches["flash_attention"],
        "prefill_share": n_layers * t5["ms"] / (res.prefill_s * 1e3),
        "prefill_share_warm": n_layers * t5["ms"] / (serve_stats["prefill_warm_s"] * 1e3),
        "hymba_prefill_share_warm": cfg_hyb.n_layers * t5h["ms"]
        / (hyb_stats["prefill_warm_s"] * 1e3),
    }
    k6 = {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:76",
        "launches": serve_launches["decode_attention"],
        "max_abs_err": errs["decode_attention"],
        "timing": f"ms and library_ms L2-cold ({t6['cold_copies']} caches, "
                  f"{t6['cold_bytes']} bytes, called in turn); warm_ms and "
                  f"library_warm_ms one cache called back to back",
        "ms": t6["cold_ms"], "warm_ms": t6["ms"], "plain_ms": t6["plain_ms"],
        "bound_ms": t6["bound_ms"], "bound_by": t6["bound_by"],
        "library_ms": t6["library_cold_ms"], "library_warm_ms": t6["library_ms"],
        "library_backend": t6["library_backend"], "library_kernels": t6["library_kernels"],
        "library_pinned_ms": t6["library_pinned_cold_ms"],
        "library_pinned_warm_ms": t6["library_pinned_ms"],
        "shape_B_Hq_Hkv_S_D": t6["shape"], "visible": t6["visible"], "dtype": "bfloat16",
        "launches_by_path": {"serve": serve_launches["decode_attention"],
                             "serve-hybrid": hyb_launches["decode_attention"],
                             **{path: n["decode_attention"]
                                for path, n in kinds_launches.items()}},
        "launches_per_run": serve_launches["decode_attention"],
        "decode_share": n_layers * t6["cold_ms"] / (rep.p50_wall * 1e3),
    }
    kernels += [k5, k6]
    for tag, t, shape in (("K5", t5, "internlm2"), ("K5", t5h, "hymba"),
                          ("K5 f32 form", t5x, "llama-vision cross-attention"),
                          ("K5 f32 form", t5f, "internlm2"), ("K6 warm", t6, "internlm2")):
        print(f"[time] {tag} {shape} {t['shape']}: {t['ms'] * 1e3:.3f} us per launch "
              f"(plain version {t['plain_ms'] * 1e3:.3f} us; scaled_dot_product_attention "
              f"{t['library_ms'] * 1e3:.3f} us by PyTorch's choice, {t['library_backend']}; "
              f"pinned {t['library_pinned_ms']}), bound {t['bound_ms'] * 1e3:.3f} us by "
              f"{t['bound_by']} | {smi}", flush=True)
    print(f"[time] K6 cold ({t6['cold_copies']} caches, {t6['cold_bytes']} bytes, in "
          f"turn): {t6['cold_ms'] * 1e3:.3f} us per launch (scaled_dot_product_attention "
          f"{t6['library_cold_ms'] * 1e3:.3f} us, pinned {t6['library_pinned_cold_ms']}), "
          f"bound {t6['bound_ms'] * 1e3:.3f} us by {t6['bound_by']}; "
          f"{serve_launches['decode_attention']} launches in the serve run | {smi}", flush=True)
    print(f"[time] K6 (cold) x {n_layers} layers = {k6['decode_share']:.4f} of the p50 decode "
          f"step wall; K5 x {n_layers} = {k5['prefill_share']:.4f} of the prefill wall, "
          f"{k5['prefill_share_warm']:.4f} of the warm one; hymba's 32 K5 = "
          f"{k5['hymba_prefill_share_warm']:.4f} of its warm prefill", flush=True)

    # K7 at the mamba2-130m and hymba-1.5b serving prefills' chunks, in the
    # f32 the path gives it (and in bf16 beside), against its bound on the
    # units it uses (C B^T on f32 FMAs, the head products on the TF32
    # tensor cores) with the all-f32-FMA bound beside; K8 at mamba2's norm shapes in bf16, warm and L2-cold,
    # beside torch.nn.functional.rms_norm (a yardstick only), through
    # repro_torch.launch.kernel_times
    t7 = {}
    for (label, *shape), arch in zip(ssd_cases[:2], (SSM_ARCH, HYB_ARCH)):
        if tuple(shape) != kernel_times.SSD_SHAPES[arch]:
            fail(f"K7 {label}: the serving chunk {tuple(shape)} is not kernel_times' "
                 f"{kernel_times.SSD_SHAPES[arch]}")
        for dtype in (torch.float32, torch.bfloat16):
            rec, (got, want) = kernel_times.ssd_case(shape, dtype,
                                                     plain=dtype == torch.float32)
            check_scaled(f"K7 {label} {dtype} timing inputs y", got[0], want[0])
            check_scaled(f"K7 {label} {dtype} timing inputs state", got[1], want[1])
            t7[label, dtype] = rec
            plain = ("not timed" if rec["plain_ms"] is None
                     else f"{rec['plain_ms'] * 1e3:.3f} us")
            print(f"[time] K7 ssd_chunk {label} {tuple(shape)} {dtype}: "
                  f"{rec['ms'] * 1e3:.3f} us per launch (plain version {plain}, no "
                  f"yardstick: no single PyTorch call computes it), bound "
                  f"{rec['bound_ms'] * 1e3:.3f} us by {rec['bound_by']} (bytes "
                  f"{rec['bytes_ms'] * 1e3:.3f} us; operations {rec['operations_ms'] * 1e3:.3f} "
                  f"us, C B^T on f32 FMAs, the head products on TF32; f32 FMA bound "
                  f"{rec['f32_fma_bound_ms'] * 1e3:.3f} us); C B^T formed "
                  f"{rec['cbt_per_chunk_group']} times per (chunk, group) of "
                  f"{rec['heads_per_group']} heads | {smi}", flush=True)
            if dtype == torch.float32:
                print(f"[time] K7 {label} f32 against f64, max and mean |error| / scale: "
                      + "; ".join(f"{key[8:]} {rec[key]}" for key in rec
                                  if key.startswith("f64_err_")), flush=True)
    del got, want
    m7, h7 = t7["mamba2", torch.float32], t7["hymba", torch.float32]
    warm_s = ssm_stats["prefill_warm_s"]
    rec7 = {
        "name": "ssd_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:68",
        "launches": ssm_launches["ssd_chunk"], "max_abs_err": errs["ssd_chunk"],
        "ms": m7["ms"], "plain_ms": m7["plain_ms"], "bound_ms": m7["bound_ms"],
        "bound_by": m7["bound_by"], "library_ms": None,
        "bound_route": "C B^T at the f32 FMA peak; the head products on the TF32 "
                       "tensor cores, 6 (Y) and 3 (state) TF32 products per f32 product",
        "f32_fma_bound_ms": m7["f32_fma_bound_ms"],
        "shape_BC_H_G_T_N_P": m7["shape_BC_H_G_T_N_P"], "dtype": "float32",
        "cbt_per_chunk_group": m7["cbt_per_chunk_group"],
        "f64_err": {key[8:]: m7[key] for key in m7 if key.startswith("f64_err_")},
        "ms_bf16": t7["mamba2", torch.bfloat16]["ms"],
        "bound_ms_bf16": t7["mamba2", torch.bfloat16]["bound_ms"],
        "hymba": {key: h7[key] for key in (
            "shape_BC_H_G_T_N_P", "ms", "plain_ms", "bound_ms", "bound_by",
            "f32_fma_bound_ms", "cbt_per_chunk_group")}
        | {"ms_bf16": t7["hymba", torch.bfloat16]["ms"],
           "bound_ms_bf16": t7["hymba", torch.bfloat16]["bound_ms"]},
        "launches_by_path": {"serve-ssm": ssm_launches["ssd_chunk"],
                             "serve-hybrid": hyb_launches["ssd_chunk"]},
        "prefill_share_warm": cfg_ssm.n_layers * m7["ms"] / (warm_s * 1e3),
        "prefill_share_cold": cfg_ssm.n_layers * m7["ms"] / (res_ssm.prefill_s * 1e3),
        "hymba_prefill_share_warm": cfg_hyb.n_layers * h7["ms"]
        / (hyb_stats["prefill_warm_s"] * 1e3),
    }
    kernels.append(rec7)
    print(f"[time] K7 x {cfg_ssm.n_layers} layers = {rec7['prefill_share_warm']:.4f} of "
          f"the warm mamba2 prefill wall ({warm_s * 1e3:.3f} ms), "
          f"{rec7['prefill_share_cold']:.4f} of the cold one; hymba's {cfg_hyb.n_layers} "
          f"K7 = {rec7['hymba_prefill_share_warm']:.4f} of its warm prefill", flush=True)
    t8 = []
    for rows, d in kernel_times.NORM_SHAPES:
        rec, (got, want) = kernel_times.rmsnorm_case(rows, d)
        check_scaled(f"K8 ({rows}, {d}) timing inputs", got, want)
        t8.append(rec)
        print(f"[time] K8 rmsnorm ({rows}, {d}) bf16: warm {rec['warm_ms'] * 1e3:.3f} us, "
              f"cold {rec['cold_ms'] * 1e3:.3f} us ({rec['cold_copies']} inputs, "
              f"{rec['cold_bytes']} bytes, in turn) per launch; rms_norm warm "
              f"{rec['library_warm_ms'] * 1e3:.3f} us, cold "
              f"{rec['library_cold_ms'] * 1e3:.3f} us; plain version "
              f"{rec['plain_ms'] * 1e3:.3f} us; bound {rec['bound_ms'] * 1e3:.3f} us by "
              f"{rec['bound_by']} | {smi}", flush=True)
    del got, want
    r8, g8 = t8
    rec8 = {
        "name": "rmsnorm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:31",
        "launches": norm_launches["rmsnorm"], "max_abs_err": errs["rmsnorm"],
        "timing": f"ms and library_ms L2-cold ({r8['cold_copies']} inputs called in "
                  f"turn); warm_ms and library_warm_ms one input back to back",
        "ms": r8["cold_ms"], "warm_ms": r8["warm_ms"], "plain_ms": r8["plain_ms"],
        "bound_ms": r8["bound_ms"], "bound_by": r8["bound_by"],
        "library_ms": r8["library_cold_ms"], "library_warm_ms": r8["library_warm_ms"],
        "shape": r8["shape"], "dtype": "bfloat16",
        "gated": {key: g8[key] for key in (
            "shape", "cold_copies", "warm_ms", "cold_ms", "library_warm_ms",
            "library_cold_ms", "plain_ms", "bound_ms", "bound_by")},
        "launches_by_path": {"norm": norm_launches["rmsnorm"]}}
    kernels.append(rec8)

    loaded = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
              or m == "repro" or m.startswith("repro.")]
    if loaded:
        fail(f"JAX or the JAX package was imported: {loaded[:5]}")
    print(f"[done] every phase passed in {time.perf_counter() - t_start:.3f} s", flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
