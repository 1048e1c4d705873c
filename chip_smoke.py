#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. The card: name and power limit (``nvidia-smi``), torch and CUDA
   versions.
2. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` into
   ``build/kernels`` (one nvcc per source, all started together, sm_90a)
   and print the build time and each kernel's registers, shared memory
   and spills (among them the bf16 flash kernel's wgmma builds and the
   decode's split and combine kernels).
3. Hold each kernel against its plain torch form on the card. The
   aggregation kernels at the paper's shape (n=20 agents, P=431,080
   LeNet parameters), at ragged P, at a shape whose CGE share does not
   fit on chip (P=1,000,003, every agent received), with 64 agents (f=2)
   and with 4097 (held to f64 references, thousands of rows per sum),
   from a misaligned base (the int8 payload 1 and 8 bytes off too), and
   on the edge cases (every agent crashed, with exact zeros, m - f <= 0,
   exact norm ties, duplicate values), each output bit-identical on a
   repeated call; the plan of each shape (grid, bytes held per block,
   columns re-read, the dequant's load width) is printed; the paged
   flash-decode at the decode shapes of qwen2-0.5b, qwen2-1.5b, yi-6b and
   phase 11's jamba (G = 4 over 8 KV heads), qwen2-vl-2b (G = 6) and
   arctic (G = 7 over 8), Dv != D, PS = 128 and Pmax = 1, in f32 and
   bf16, ragged and full (each run to run identical), and
   on kv_len = 0 (exact zeros), -1 and stale table entries and
   page-boundary lengths, then over a 4096-token table walked by many
   splits (lengths on and past a split boundary), run to run identical;
   the split plan of each shape is printed. Then time each kernel, its
   plain form and one library call for the same function, each with a
   cold L2, beside the least time the card could take, and each kernel's
   per-launch device time with its inputs warm in L2; for scale, a
   torch.sum over the aggregation kernels' received rows in the same
   timing window; and the aggregation kernels with 4097 and 16,384
   agents (P = 20,000), cold, beside their bounds.
   3c. Flash attention, the CGE squared norms and the masked scaling
   against their plain forms on the cases of ``kernels/cases.py``: flash
   attention on the shapes of the JAX tests, ragged S = T = 100, T = 2 S
   under the top-left causal mask, Dv != D, inputs scaled x8, 4096
   tokens, D = 192, D = Dv = 256, D = 72 with Dv = 40, S > T, causal and
   not, f32 (CUDA cores) and bf16 (tensor cores); the norms and the
   scaling on the JAX sweep and ragged widths, with zero and one scales.
   Then each timed at phase 8's shapes (flash attention also at yi-6b's
   head shape, with its achieved TFLOP/s beside SDPA's) beside its bound
   and a library call (SDPA, ``vector_norm``, ``torch.mul`` into x's
   dtype).
4. The main path: ``AsyncDGDServer`` with the §5 LeNet agents (n=20,
   data partitioned with overlap 2) on the device backend, for the
   mean, cge (one sign-flip agent), trimmed_mean (stale) and quantized
   rules. Kernel launch counts are zeroed just before and read just
   after. Every run must give finite losses, match the host conformance
   pipeline (the reference rule op by op) on the card, and replay
   snapshot -> restore -> run bit for bit.
5. Where the time goes: a few cge iterations under torch.profiler (host
   ms per iteration, device busy time and idle share, copies, kernels),
   then a few quantized iterations: device us per iteration of the int8
   quantization's PyTorch operations beside ``dequant_accum``'s.
6. The serving path: ``ServeEngine`` at the full width of qwen2-0.5b
   (``SERVE_LAYERS`` = 4 of its 24 layers, d=896, 14 query heads over 2
   KV heads, vocab 151,936, bf16, weights from seed 0; the model of
   phases 6-14) serves 24 requests (prompts of 64-512
   tokens, 16-64 new tokens each) on 8 slots of a paged cache with
   superstep_k=8. The decode kernel's launch count is zeroed just before
   and read just after. Every request must finish with exactly its
   budget, every page must come back, the kernel must run at least once
   per layer and decode step, the token streams must equal a
   superstep_k=1 run's, and teacher-forced decode logits through the
   kernel must match the plain form's. Prints decode tokens/s, ms per
   superstep, mean TTFT, prefill ms and the kernel's share of device
   time.
7. Where the serving time goes: a few supersteps under torch.profiler
   (host ms per step, device busy time and idle share, device
   activities per decode step).
8. The kernels API at full width (``kernels/ops.py``), launch counts
   zeroed just before and read just after: flash attention on layer 0's
   q, k, v of qwen2-0.5b (phase 6's weights) over a 4096-token prompt,
   against its plain form and the model's chunked attention; the CGE
   squared norms and masked scaling over phase 6's whole parameter tree
   bucketed as bf16 (rows of 2048), against the plain forms
   and an f64 sum of squares; and the CGE keep-set of one cge iteration
   of the §5 LeNet agents from bucketed norms, against the plain form's
   on the same buckets and the f32 ledger's.
9. The simulator (``repro_torch.sim``): ``run_train`` of all 13
   registered scenarios (n = 8 agents, dim = 4) on the card with the host
   backend, each against the same run on the CPU in this process (zero
   conformance violations, the discrete trace fields identical, loss and
   dist within rtol 1e-4 / 1e-3), and ``run_serve`` of each; then
   ``byzantine_flip_midrun`` (cge, f = 2, two attack switches, an (8, 4)
   ledger through ``masked_cge_reduce``) and ``rolling_restart`` (stale,
   tau = 3, a crash/recover wave) on the device backend, held the same
   way. The aggregation kernels' counts are zeroed just before and read
   just after; CGE's kernel must launch at every iteration of its run.
   Prints per run wall seconds, iterations per second, the final
   ||x - x*|| against the envelope radius, drops and duplicates.
10. The e2e harness (``repro_torch.sim.e2e``): one ``EngineFleet`` of 8
   replicas of qwen2-0.5b at full width over phase 6's weights (2 slots,
   8-token pages, superstep_k = 4, 8 new tokens a request) replays
   ``e2e_steady`` and ``crash_cascade``, cut to their first 8 and 16
   requests (of 32 and 40; printed as ``reduced``), on the same warm
   fleet, drained between them. The decode kernel's count is
   zeroed just before each run and read just after. Both runs must have
   zero violations, and every delivered stream of ``e2e_steady`` must be
   the plain attention form's greedy argmax (teacher forced, on the
   fleet's page size) wherever the top-2 margin exceeds the logit
   tolerance. Prints per run the native quorum row and each row of the
   r-sweep (goodput, p50/p99 latency and TTFT in virtual time), wall
   seconds, and decode steps and supersteps per replica.
11. The other model families at full width, one config at a time,
   bf16 weights from seed 0 made on the card and freed before the next:
   ``ServeEngine`` (4 slots, 16-token pages, superstep_k = 4) serves 8
   requests (prompts of 16-256 tokens, 8-16 new tokens each) on
   jamba-v0.1-52b (one period: 8 layers, 7 Mamba, 1 GQA, 4 MoE),
   deepseek-v2-236b (2 layers: MLA latent pages, 160 experts top-6, 2
   shared), arctic-480b (1 layer: 128 experts and the dense residual),
   rwkv6-3b (8 of its 32 layers) and qwen2-vl-2b (7 of its 28, M-RoPE);
   the cuts in depth are printed as ``reduced``. Each must finish every request with
   its budget and bring back every page, give the streams of a
   superstep_k = 1 run, and launch the decode kernel exactly once per
   GQA layer and decode step (zero for rwkv6 and deepseek-v2), its count
   zeroed just before and read just after; the GQA configs' teacher-
   forced decode logits through the kernel must match the plain form's
   within the logit tolerance. Prints per config the parameter GB, the
   seconds to make them, decode tok/s, ms per decode step, ms per
   prefill and the launches, and where two profiled supersteps' time
   goes (host ms and device busy ms per decode step, idle share, the
   top device activities). Then whisper-base (full, f32) through
   ``apply_model``: a prefill over 1,500 frame embeddings and 16
   dense-cache decode steps on the card against the CPU (rtol = atol =
   1e-4); and the reduced config of each new family in f32 on the card
   against the CPU: prefill and decode logits within 1e-4, served
   streams equal wherever the CPU's top-2 margin exceeds it.
   Phase 6's weights and phase 10's fleet stay on the card for:
12. The prefix cache at full width: ``ServeEngine(prefix_cache="on")``
   on phase 6's weights (8 slots, 16-token pages, superstep_k = 8)
   serves 24 requests (16-32 new tokens): 16 on a 256-token system
   prompt with tails of 1-40, 4 identical 200-token prompts (full hits,
   COW forks), 4 cold prompts of 64-128; run A on a pool that never
   evicts, then again with the cache off; run B under ``sla`` on a
   60-page pool, half the requests at priority 0 first and the rest at
   priority 1 two steps later, so the LRU evicts and requests are
   preempted and resumed. The books are checked after every step; every
   budget met; every page back; the hit, COW and suffix counters; the
   decode kernel exactly once per layer and decode-program iteration
   (superstep iterations plus suffix steps). Every stream of run A (on
   and off) and of run B is teacher forced through the plain form and
   the kernel: it must be the plain greedy argmax wherever the top-2
   margin exceeds the logit tolerance, and the kernel's logits within
   that tolerance of the plain form's. Then reduced qwen2-0.5b in f32 on
   the CPU test's mix and on a one-slot 12-page ``sla`` run (the LRU
   evicts, a preemption, a resume that re-shares resident blocks):
   streams with the cache on equal the cache-off run's and the CPU's
   exactly, and the stats equal the CPU's. Prints TTFT, prefill and
   suffix-step ms, hit and miss tokens, decode tok/s, forks, evictions
   and each admission's time to its first token.
13. Fleet control and checkpoint rejoin on phase 10's fleet: engine 0's
   snapshot through the ``Checkpointer`` into ``restart(image)`` (the
   rid counter monotone, the same stream after, a busy engine's
   snapshot refused), then ``run_fleet_e2e`` of ``crash_cascade`` cut to
   16 requests, and of the same scenario with its three crashes moved
   onto requests in flight: zero violations, nothing lost, every death
   rejoined after probation, delivered streams the plain form's greedy
   argmax where the margin allows; in the second, copies lost to the
   crashes, the controller's hedges or retries, and a restarted replica
   serving again. Prints the ``FleetMetrics`` rows, the quorum
   rows, wall seconds and launches.
14. Wall-clock chaos: 4 of the fleet's engines as ``EngineReplica``s
   under ``RealClock`` through ``kill_rejoin`` with its own 40 requests,
   on the timescale of one request served by 3 replicas at once, the
   horizon cut to 40 timescales (of 160): nothing lost, no violation,
   drained, the killed replica declared dead, restarted and rejoined,
   one restart for each kill and no exception from any replica's engine
   (the fleet would count one as a crash and restart the replica), the
   decode kernel launched. Prints the report, ``recovered`` with
   ``sr_pre`` and ``sr_post``, how long arrivals go on past the last
   rejoin, and the deaths of replicas no fault killed.
15. The SPMD layer on ``torch.distributed``. Ranks are processes
   spawned by ``launch.mesh.run_ranks`` with an explicit backend and a
   time limit; a rank that raises or overruns it ends the script.
   15a: ``TrainLoop`` (the masked step, Algorithm 1 by loss weights) on
   qwen2-0.5b at full width with ``examples/train_lm.py``'s defaults (8
   agents, r = 2, batch 8 x 64, lr 3e-3 cosine; bf16 parameters, f32
   AdamW moments): 10 steps with a checkpoint at 10, a new loop that
   restores step 10 bit for bit and takes 5 more; the loss must fall;
   the step alone timed and profiled (idle share); the f32 reduced twin,
   card against CPU within 1e-4.
   15b: 4 gloo ranks sharing the card (mesh data = 4) run phase 4's four
   LeNet runs on ``agg_backend="sharded"`` (5 ledger rows per rank),
   combine ``gather`` then ``partial``: every rank's iterate equal bit
   for bit, gather bit-identical to phase 4's device backend, partial
   within 1e-5 * max(|x|, 1) (the quantized rule, whose int8 rounding a
   difference can flip in later iterations, within 1e-3 of |x| after
   10); one call per kernel per rank against its plain form on that
   rank's inputs; then the cge gather run on a one-rank NCCL group, bit
   for bit. 15c: on the same ranks, ``make_general_step`` (cge, stale,
   trimmed, quantized; 2 steps each, one agent masked per step) on
   qwen2-0.5b's widths cut to 2 layers in bf16, parameters identical on
   every rank (an all-reduced checksum), then its f32 reduced twin
   against 4 gloo ranks on the CPU within 1e-4.
   15d: 2 gloo ranks (mesh data = 1, model = 2) serve phase 6's workload
   cut to 8 requests at full width, each rank's pools holding one of the
   2 KV heads: streams and stats identical to the one-rank engine's,
   ``paged_flash_decode`` launched 24 x decode steps per rank; reduced
   deepseek-v2 (MLA, the absorbed decode split over query heads) at tp =
   2 held to the teacher-forced greedy rule.
16. The placed (FSDP) masked step, the launch serving steps and the
   example twins.
   16a: 4 gloo ranks sharing the card (mesh data = 4) place 15a's state
   cut to ``SPMD_LAYERS`` (4) of its 24 layers (qwen2-0.5b at full
   width, bf16 parameters, f32 AdamW moments, drawn from one generator)
   by ``launch.train.place_state`` and take 3 steps
   of ``make_train_step(..., param_specs=)`` with remat, one agent a
   rank and 2 of the 4 masked a step: each rank's bytes of parameters
   and moments (memory_allocated's growth over the placement) equal the
   meta-device report within 1% and are a quarter of the replicated
   state's; the gathered parameters are identical on every rank. Two
   references run first in this process on the same weights and
   batches: the mirror of the placed step's arithmetic (each agent's
   bf16 gradient alone, the four summed in f32), which the placed
   parameters must equal bit for bit after every step, its losses and
   gradient norms within 1e-6; and the one-process ``make_train_step``
   (15a's step), against whose update from the initial parameters the
   placed step's gap is at most ``PLACED_UPDATE_REL`` (an unchanged state
   reads 1). Prints seconds per step and the peak bytes of gathered
   weights.
   16b: reduced qwen2-0.5b (f32, 2 layers) placed on data 2 x model 2,
   3 steps on the card and on 4 CPU ranks, within 1e-4.
   16c: ``launch.serve.greedy_generate`` at full width, 4 prompts of 64
   tokens, 32 new tokens each: tok/s, ``paged_flash_decode`` launched
   exactly 24 x the decode steps (its count zeroed just before and read
   just after), the tokens equal to ``ServeEngine.run``'s on the same
   prompts, whose engine's own pools, page table and lengths hold the
   decode kernel against ``paged_decode_plain`` after steps 2 and 3,
   every layer; ``make_prefill_step`` and ``make_decode_step`` under
   their own ``act_policy``, their argmax equal to the policy-free
   calls', their constraint points reaching an enclosing recorder (the
   kinds of a dense model, the batch over "data").
   16d: microbatch accumulation in the placed step, in 16a-16b's spawn.
   16a's ranks take a 4th step at ``accum_steps = 2`` from 16a's state:
   its parameters equal bit for bit the mirror's arithmetic extended to
   microbatches (each rank's bf16 gradient of its block of a microbatch,
   the four summed in f32 and cast, the two microbatches' summed in f32,
   halved and cast) and lie within ``PLACED_UPDATE_REL`` of the
   one-process ``make_train_step(accum_steps=2)``; 16b's twin takes a
   4th step at ``accum_steps = 2`` too, card and CPU ranks within 1e-4.
   Prints s per step, the peak bytes of gathered weights and
   ``max_memory_allocated``'s growth over a step at k = 1 and k = 2.
   16e: ``examples/torch_quickstart.py``, ``torch_byzantine_cge.py`` and
   ``torch_serve_lm.py`` run in process on the card at their defaults,
   then the Byzantine one with ``--agg-backend device``, its 9 runs held
   to the host backend's (the same events, ||x - x*|| within rtol 1e-3
   at every iteration), and the serving one with ``--device cpu``, its
   stats and streams equal to the card's; their lines are printed, and
   the aggregation and decode kernels' launches (zeroed just before each
   card run) must be above 0. Phase 3 holds the aggregation kernels at
   the Byzantine example's shape (12 agents, P = 6).
17. The dry run (``launch.dryrun``, ``launch.hlo_analysis``) against
   the card. 17a: 15a's step (qwen2-0.5b at full width,
   ``examples/train_lm.py``'s defaults, one rank) under ``OpCounter`` on
   the meta device and on the card: the FLOPs and HBM bytes equal op by
   op (any op that differs is named), the dry run's peak of live
   temporaries within 20% of ``max_memory_allocated`` above the
   arguments; ms per step and TFLOP/s (the trace's FLOPs over the step
   time) beside the card's dense bf16 peak. 17b: 16a's placed step on a
   ``RecordingMesh`` of 16a's shape on the meta device: its collectives
   (kind, axes, group, bytes, count) equal those each of 16a's 4 gloo
   ranks counted through its real mesh in its first step. 17c:
   ``launch.serve``'s dense decode step (8 rows, position 512 of 1024)
   on the meta device and on the card: the FLOPs equal.
18. Tensor-parallel compute over "model" for the dense decoders
   (``dist.tp``), on 4 gloo ranks sharing the card (mesh data 2 x model
   2). 18a: 16a's placed masked step (qwen2-0.5b at full width and 16a's
   4 layers, bf16
   parameters, f32 AdamW, 4 agents with 2 masked a step; no remat), 3
   steps: seconds per step, each rank's bytes of parameters and moments
   within 1% of the meta-device report, the gathered parameters
   identical on every rank, a step's FLOPs and collectives on the card
   equal op by op to a ``RecordingMesh``'s count on the meta device, and
   those FLOPs over the same step's at data 2 x model 1 (meta) within
   ``TPC_FLOP_RATIO``; the f32 twin (full width, 2 layers, SGD with
   momentum, remat: its recomputation on autograd's thread runs the TP
   layers too) within 1e-4 of the one-process ``make_train_step`` on the
   same batches and identical on every rank. 18b: ``launch.serve``'s
   ``make_prefill_step`` and ``make_decode_step`` on ``place_params``'
   blocks and ``place_cache``'s cache (head_dim over model), 16c's 4
   prompts of 64 (2 a dp rank) and 32 new tokens: every model rank of a
   dp block streams the same tokens, one rank's greedy argmax along them
   wherever its top-2 margin exceeds ``LOGIT_TOL``; ms per decode step
   beside one rank's. No kernel lies on this path (the reference's
   train, prefill and dense decode call no Pallas kernel).
19. The general step (``make_general_step``) tensor-parallel over
   "model" on 4 gloo ranks sharing the card (data 2 x model 2, one agent
   a dp rank): qwen2-0.5b at full width and 16a's 4 layers, bf16
   parameters, AdamW, on
   ``place_general_state``'s share of the state, each mode 2 steps. cge
   (f = 1) with both agents received (with one masked, n = 2 leaves it
   m - f = 0 to keep); stale (tau = 1: step 1 reads agent 1's row from
   step 0), trimmed (f = 0: at n = 2, f = 1 leaves m - 2f <= 0 and the
   rule returns 0) and quantized with agent t % 2 masked at step t. Per
   mode: seconds per step, the last step's FLOPs and collectives on each
   rank equal op by op to a ``RecordingMesh``'s count of its agent on
   the meta device (all-reduces and wire bytes a rank), each rank's
   bytes of state beside the meta report, and the parameters identical
   per tp block over dp and per whole leaf over all ranks; the f32 twin
   (reduced qwen2-0.5b, 2 layers, SGD with momentum) within 1e-4 of a
   one-process oracle built here from ``core.gradagg`` on the per-agent
   gradients. No kernel lies on this path (the reference's general step
   calls no Pallas kernel).
20. arctic-480b tensor- and expert-parallel over "model"
   (``models/moe.py`` under ``dist.tp``), on 4 gloo ranks sharing the
   card, one spawn for a and b (``drive_moe``; so in 21-24). 20a: phase 11's cut (1 of 35 layers) at every published width
   and all 128 experts, bf16 from seed 0, on data 1 x model 4: each rank
   draws its blocks by ``launch.serve.init_params`` (one rank at a
   time), holds 32 experts, exactly a quarter of the expert bytes, and
   runs ``make_prefill_step`` and ``make_decode_step`` on 16c's 4
   prompts of 64 tokens, 32 new: a decode step's FLOPs and collectives
   on the card equal op by op to a ``RecordingMesh``'s count on the meta
   device (its all-reduces printed), every rank streams the same tokens,
   one rank's greedy argmax along them (whole parameters, the same
   steps) wherever its top-2 margin exceeds ``LOGIT_TOL``; ms per decode
   step beside one rank's. 20b: data 2 x model 2 at the published
   widths, 1 layer: the placed masked step (8 experts, 4 a rank, AdamW,
   16a's agents and masks) and the general modes (2 experts, one a
   rank, SGD with momentum; 19's masks) counted on the meta device
   (FLOPs, all-reduces and wire bytes a rank, state bytes) and run on
   the twins; where a step runs at the published widths (22b, 23b):
   seconds per step, the last step's FLOPs and
   collectives equal op by op to a ``RecordingMesh``'s count, state
   bytes a rank within 1% of the meta report, the most bytes allocated,
   parameters identical on every rank (placed) and per tp block over dp
   (general); the f32 twins (reduced arctic, 4 experts, 2 layers, SGD
   with momentum, remat) within 1e-4 of the one-process
   ``make_train_step`` and of a ``core.gradagg`` oracle. No kernel lies
   on this path (the reference's experts are three ``einsum``s outside
   any Pallas kernel).
21. deepseek-v2-236b tensor- and expert-parallel over "model", its MLA
   split too (``models/attention.py:_apply_mla_tp``), by phase 20's
   code. 21a: 1 of 60 layers at every published width (MLA at latent
   rank 512, q rank 1536, 128 heads; all 160 experts, top-6, 2 shared)
   from seed 0, on data 1 x model 4 (40 experts and 32 heads a rank),
   8 new tokens, with 20a's checks, in bf16 and then, in the same
   ranks, in f32: in bf16 a rounding difference can flip a near tie of
   top-6 of 160 routing and move a logit past ``LOGIT_TOL``, so there
   the streams against one rank's argmax are printed; in f32 the streams
   are held to one rank's argmax at every clear margin and rank 0's
   teacher-forced logits within 1e-4 of one rank's. 21b:
   data 2 x model 2, 1 layer, as 20b: the general modes cge and
   quantized (6 experts, the fewest top-6 allows, SGD with momentum;
   quantized's whole f32 rows four ranks cannot hold at this
   vocabulary) and the placed masked step (8 experts, AdamW) counted on
   the meta device (FLOPs, all-reduces, state bytes) and run on the f32
   twins
   (reduced deepseek-v2, 4 experts, 2 layers: placed, cge and quantized
   within 1e-4 of one process). No kernel lies on this path (the
   reference's MLA is ``jnp`` einsums and ``attention_math``).
22. jamba-v0.1-52b tensor- and expert-parallel over "model", its Mamba
   mixers split too (``models/ssm.py:_apply_mamba_tp``: a block of the
   inner width di a rank, ``a_log`` and the decode state over d_state),
   by phase 20's code. 22a: one period (8 of 32 layers: 7 Mamba, 1 GQA
   with 32 heads over 8 KV heads, 4 MoE blocks) at every published width
   and all 16 experts, bf16 from seed 0, on data 1 x model 4 (4 experts,
   8 heads and 2048 of di a rank), 8 new tokens, with 20a's checks and
   the share of the decode's wire bytes that re-lays the Mamba
   activations, then in
   the same ranks in f32 at 4 experts (one a rank): the streams held to
   one rank's argmax at every clear margin and the logits within 1e-4
   there, printed in bf16 (top-2 routing's near ties can flip). 22b: data
   2 x model 2 at the published widths, the period cut to its positions
   4-5 (a GQA layer with its dense MLP, a Mamba layer with an MoE
   block): 1 placed masked step (4 experts, AdamW) and 2 general cge
   steps (2 experts, SGD with momentum) with 20b's checks; quantized
   counted on the meta device and run on the f32 twins (reduced jamba
   cut the same way, 4 experts: placed, cge and quantized within 1e-4 of
   one process). No kernel lies on this path (the reference's
   Mamba is ``jnp`` einsums and ``lax.associative_scan``).
23. rwkv6-3b tensor-parallel over "model" (``models/ssm.py``'s
   ``_apply_rwkv_time_tp`` and ``_apply_rwkv_channel_tp``: every weight
   a column weight, the WKV scan on a head group's heads, the decode on
   a block of every head's value columns), by phase 20's code. 23a: 2
   of 32 layers at every published width (d 2560, 40 heads, d_ff 8960,
   vocabulary 65,536), bf16 from seed 0, on data 1 x model 4 (10 heads
   and 640 columns a rank), 8 new tokens, with 20a's checks (the
   streams held to one rank's argmax at every clear margin), then in the
   same ranks in f32 with the logits within 1e-4 of one rank's. 23c, in
   the same spawn: 23a's prompt 0 alone on data 2 x model 2 at 23a's
   widths and depth, 8 new tokens, in bf16 and then in f32:
   ``make_decode_step(..., dp=())``, whose batch of one leaves "data"
   idle, so every projection's fan-in splits over it as the reference's
   compiled decode splits it (``dist.tp.fan_in_dot``; rwkv6's
   long_500k); the stream held to one rank's argmax at every clear
   margin, the f32 logits within 1e-4 of one rank's, a step's FLOPs and
   all-reduces (axes, group, bytes) on every rank equal to a
   ``RecordingMesh``'s count on the meta device; ms a step beside the
   same steps unsplit (``dp`` None). 23b:
   data 2 x model 2 at the same cut: 1 placed masked step (AdamW) and 2
   general cge steps (SGD with momentum) with 20b's checks; stale,
   trimmed and quantized counted on the meta device, cge and quantized
   run on the f32 twins (reduced rwkv6, 2 layers: placed, cge and
   quantized within 1e-4 of one process). No kernel lies on this path
   (the reference's RWKV is ``jnp`` einsums and ``lax.scan``).
24. whisper-base tensor-parallel over "model" (``models/attention.py``'s
   ``_apply_gqa_tp`` with cross-attention: the encoder's and the
   decoder's heads, the cross-attention's K/V from the encoder's output
   on the KV heads a rank reads, its decode over ``ck`` / ``cv``'s
   head_dim block as partial dots; the MLPs' columns), by phase 20's
   code. 24a: every published width at full depth (6 + 6 layers, d 512,
   8 heads, 1,500 frames, vocabulary 51,865), bf16 from seed 0, on data
   1 x model 4 (2 heads and 128 columns a rank), 16c's 4 prompts of 64
   tokens with frame embeddings from seed 0, 8 new tokens, with 20a's
   checks (the streams held to one rank's argmax at every clear margin),
   then in the same ranks in f32 with the logits within 1e-4 of one
   rank's. 24b: data 2 x model 2 at the same widths and depth: 1 placed
   masked step (AdamW) and 2 general cge steps (SGD with momentum) with
   20b's checks; stale, trimmed and quantized counted on the meta
   device, cge and quantized run on the f32 twins (reduced whisper-base,
   2 + 2 layers: placed, cge and quantized within 1e-4 of one process).
   No kernel lies on this path (the reference's whisper decode is
   ``plain_attention`` over a dense cache, and no engine pages it).
25. A JSON line with every kernel's launches (summed over the phases
   that drive a path: 4, 6, 8, 9, 10, 11, 12, 13, 14, 15 and 16, all
   ranks of 15), error and times, the ``nvidia-smi`` line, and as the
   last line ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when CUDA is not available or the
repository's sources are missing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import spans  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import gradagg  # noqa: E402
from repro_torch.core.async_engine import (AsyncEngine,  # noqa: E402
                                           EngineConfig, default_latency)
from repro_torch.core.ledger import (  # noqa: E402
    layout_of, make_sharded_aggregate_apply, tree_flatten, tree_map)
from repro_torch.core.server import AsyncDGDServer  # noqa: E402
from repro_torch.data.partition import (mask_to_weights,  # noqa: E402
                                        partition)
from repro_torch.data.synthetic import (lm_batches,  # noqa: E402
                                        markov_tokens, mnist_like)
from repro_torch.dist import collectives  # noqa: E402
from repro_torch.dist.act_sharding import act_policy  # noqa: E402
from repro_torch.dist.sharding import (gather_tree,  # noqa: E402
                                       shard_tree, tree_specs)
from repro_torch.dist.tp import gather_from_tp, tp_context  # noqa: E402
from repro_torch.kernels import _build, agg, ops  # noqa: E402
from repro_torch.kernels import cge_norms as cgen  # noqa: E402
from repro_torch.kernels import decode_attention as dattn  # noqa: E402
from repro_torch.kernels import flash_attention as fattn  # noqa: E402
from repro_torch.kernels.cases import (CGE_SHAPES, FLASH_CASES,  # noqa: E402
                                       FLASH_TOL, NORM_TOL)
from repro_torch.launch.hlo_analysis import (OpCounter,  # noqa: E402
                                            analyze, diff)
from repro_torch.launch.loop import StragglerOracle, TrainLoop  # noqa: E402
from repro_torch.launch.mesh import (RecordingMesh,  # noqa: E402
                                     make_test_mesh, run_ranks)
from repro_torch.launch.serve import (greedy_generate,  # noqa: E402
                                      init_params, make_decode_step,
                                      make_prefill_step, place_cache,
                                      place_params)
from repro_torch.launch.train import (TrainConfig,  # noqa: E402
                                      abstract_state, general_specs,
                                      init_state, lr_at, make_general_step,
                                      make_loss_fn, make_optimizer,
                                      make_train_step, place_general_state,
                                      place_state, state_bytes_per_rank,
                                      state_rules, value_and_grad)
from repro_torch.models import attention as mattn  # noqa: E402
from repro_torch.models import layers as mlayers  # noqa: E402
from repro_torch.models.layers import vocab_split  # noqa: E402
from repro_torch.models import lenet  # noqa: E402
from repro_torch.models import model as mmodel  # noqa: E402
from repro_torch.models.model import classifier_loss  # noqa: E402
from repro_torch.models.model import apply_model, init_model  # noqa: E402
from repro_torch.models.model import lm_loss  # noqa: E402
from repro_torch.optim.optimizers import (apply_updates,  # noqa: E402
                                          clip_by_global_norm)
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.serve import (EngineReplica, FleetConfig,  # noqa: E402
                               PagedCacheConfig, RealClock, ReplicaKilled,
                               ServeEngine, SnapshotInFlightError)
from repro_torch.serve.kv_cache import PagedKVCache  # noqa: E402
from repro_torch.sim.conformance import summarize  # noqa: E402
from repro_torch.sim.e2e import LOST, EngineFleet, run_e2e  # noqa: E402
from repro_torch.sim.faults import CrashWindow  # noqa: E402
from repro_torch.sim.fleet_e2e import run_fleet_e2e  # noqa: E402
from repro_torch.sim.realtime_chaos import (PLANS,  # noqa: E402
                                            run_realtime_chaos)
from repro_torch.sim.scenario import (SCENARIOS, get_scenario,  # noqa: E402
                                      run_serve, run_train)

N_AGENTS, P_LENET = 20, 431_080
KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)   # agent-order sum vs torch's order
EDGE_TOL = dict(rtol=1e-6, atol=1e-6)     # edge cases: exact or near-exact
REPLACES = {
    "masked_cge_reduce": "src/repro/kernels/agg.py:58",
    "trimmed_mean_tiled": "src/repro/kernels/agg.py:154",
    "dequant_accum": "src/repro/kernels/agg.py:247",
    "paged_flash_decode": "src/repro/kernels/decode_attention.py:154",
    "flash_attention": "src/repro/kernels/flash_attention.py:73",
    "block_sq_norms": "src/repro/kernels/cge_norms.py:32",
    "masked_scale": "src/repro/kernels/cge_norms.py:69",
}
CSRC = "src/repro_torch/kernels/csrc"
SOURCE = {k: f"{CSRC}/agg.cu" for k in REPLACES}
SOURCE["paged_flash_decode"] = f"{CSRC}/decode_attention.cu"
SOURCE["flash_attention"] = f"{CSRC}/flash_attention.cu"
SOURCE["block_sq_norms"] = SOURCE["masked_scale"] = f"{CSRC}/cge_norms.cu"
BUILDS = ("agg", "decode_attention", "flash_attention", "cge_norms")


def log(*args) -> None:
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# 1. the card


def card_peaks(name: str):
    """(memory bytes/s, f32 FLOP/s outside the tensor cores, bf16 dense
    tensor-core FLOP/s) of an H100 SXM from NVIDIA's data sheet: 3.35
    TB/s, 67 and 989 TFLOP/s. Another card has other peaks, which this
    script does not guess."""
    if "H100" in name and ("HBM3" in name or "SXM" in name):
        return 3.35e12, 67e12, 989e12
    raise RuntimeError(f"no data-sheet peaks for {name!r}: the bounds are "
                       "stated for an H100 SXM")


# ---------------------------------------------------------------------------
# 3. kernels against their plain forms, and their times


def ledger(n, p, n_received, seed, device="cuda"):
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(n, p)) * rng.uniform(0.5, 3.0, size=(n, 1))
         ).astype(np.float32)
    rx = np.zeros(n, bool)
    rx[rng.choice(n, size=n_received, replace=False)] = True
    return (torch.from_numpy(g).to(device), torch.from_numpy(rx).to(device))


def edge_cases():
    """(name, g, received, f) on the card."""
    g, _ = ledger(6, 3001, 6, seed=4)
    # four rows of one norm with different contents (sign flips of one
    # row), and m - f = 4 keeping the smaller row and three of the four:
    # the id tie-break decides which tied row goes
    row = g[0]
    s1, s2 = torch.where(g[1:3] < 0, -1.0, 1.0)
    ties = torch.stack([row * 0.5, row, -row, row * 2.0, row * s1,
                        row * 3.0, row * s2])
    dups = torch.tensor([[1.0], [1.0], [2.0], [3.0], [1.0], [2.0]],
                        device="cuda").repeat(1, 3001)

    def mask(*v):
        return torch.tensor(v, dtype=torch.bool, device="cuda")

    return [
        ("all_crashed", g, mask(*[False] * 6), 1),
        ("m_minus_f_nonpositive", g, mask(True, True, *[False] * 4), 3),
        ("ties", ties, mask(*[True] * 7), 3),
        ("duplicates", dups, mask(True, True, True, True, False, True), 1),
    ]


def check(name, out, ref, tol, errs):
    out, ref = out.cpu(), ref.cpu()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise AssertionError(f"{name}: bad output {tuple(out.shape)}")
    err = float((out - ref).abs().max()) if out.numel() else 0.0
    errs.append(err)
    torch.testing.assert_close(out, ref, **tol, msg=lambda m: f"{name}: {m}")
    return err


def log_plans(n, p, m, q):
    """The aggregation kernels' plans for n agents, P columns, m received
    rows and the int8 payload ``q`` on this card (``agg.cge_plan``,
    ``agg.trimmed_plan``, ``agg.dequant_plan``)."""
    sms, smem = agg.card_limits(torch.device("cuda"))
    cp, tp = agg.cge_plan(n, p, sms, smem), agg.trimmed_plan(n, p, sms, smem)
    dp = agg.dequant_plan(n, p, q.data_ptr() % 16, sms)
    held = cp.held[m]
    widths = [min(cp.share, p - b * cp.share) for b in range(cp.grid)]
    reread = sum(max(0, w - held) for w in widths)
    log(f"    plan masked_cge_reduce : grid {cp.grid}, share {cp.share} "
        f"columns, {min(held, cp.share)} held x {m} rows = "
        f"{m * min(held, cp.share) * 4} B of rows per block "
        f"({cp.smem_bytes} B of shared memory asked), {reread} columns "
        "re-read" + (", per-agent lists in a device workspace"
                     if cp.workspace else ""))
    ring = (f"{tp.stages} stages of {n} rows ({tp.smem_bytes} B of shared "
            "memory)" if tp.stages else "no ring: rows read from device "
            "memory in agent order")
    log(f"    plan trimmed_mean_tiled: grid {tp.grid}, share {tp.share} "
        f"columns in chunks of {tp.chunk}, {ring}, 0 columns re-read")
    log(f"    plan dequant_accum     : base {q.data_ptr() % 16} mod 16, "
        f"{dp.vec}-byte loads, {dp.cols} columns a thread, grid {dp.grid} x "
        f"{agg.DQ_THREADS} threads, share {dp.share} columns, the mask "
        f"walked in {-(-n // agg.DQ_THREADS)} batch(es) per block")


def misaligned(g, elems=1):
    """g as a contiguous view ``elems`` elements past its storage's start:
    with one float, every row starts off its 16-byte line."""
    buf = torch.empty(g.numel() + elems, dtype=g.dtype, device=g.device)
    buf[elems:] = g.reshape(-1)
    return buf[elems:].view(g.shape)


def f64_references(g, rx, f, q, s):
    """For thousands of received rows: each kernel's f64 reference and the
    bound on its f32 error. A sum of m f32 terms in any order is off by
    about sqrt(m) roundings of the sum of their magnitudes (16x margin);
    a row kept or dropped wrongly moves a column by a whole |g|."""
    m = int(rx.sum())

    def bound(w, x):
        return 16 * m ** 0.5 * 2.0 ** -24 * (w.abs() @ x.abs())

    g64 = g.double()
    keep = gradagg.cge_mask_from_norms(agg.row_norms(g), rx, f).double()
    rows = g64[rx]
    cnt = m - 2 * f
    srt = torch.sort(rows, dim=0).values
    ones = torch.ones(m, dtype=torch.float64, device=g.device)
    w = (s * rx).double()
    q64 = q.double()
    return {"masked_cge_reduce": (keep @ g64, bound(keep, g64)),
            "trimmed_mean_tiled": (srt[f:m - f].sum(0) / cnt,
                                   bound(ones, rows) / cnt),
            "dequant_accum": (w @ q64, bound(w, q64))}


def check_f64(name, out, ref, bound):
    """Returns the largest error relative to its bound; raises above 1."""
    out = out.double()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise AssertionError(f"{name}: bad output {tuple(out.shape)}")
    worst = float(((out - ref).abs() / bound.clamp(min=1e-300)).max())
    if worst > 1:
        raise AssertionError(f"{name}: {worst:.2f}x its f64 error bound")
    return worst


def check_kernels():
    errs = {k: [] for k in ("masked_cge_reduce", "trimmed_mean_tiled",
                            "dequant_accum")}
    # (n, P, received, f); (12, 6, 10, 2) is examples/
    # torch_byzantine_cge.py's shape on its device backend (phase 16e)
    shapes = [(N_AGENTS, P_LENET, N_AGENTS - 3, 1), (7, 4097, 5, 1),
              (N_AGENTS, 1_000_003, N_AGENTS, 2), (3, 1, 3, 0),
              (64, P_LENET, 45, 2), (4097, 20_000, 2868, 1), (12, 6, 10, 2)]
    for i, (n, p, m, f) in enumerate(shapes + [shapes[0]]):
        g, rx = ledger(n, p, m, seed=i)
        mis = i == len(shapes)
        if mis:
            g = misaligned(g)
        log(f"  n={n} P={p} m={m} f={f}" + (", misaligned base" if mis
                                           else ""))
        q, s = gradagg.quantize_int8_parts(g)
        s = s[:, 0].contiguous()
        log_plans(n, p, m, q)
        refs = f64_references(g, rx, f, q, s) if n > 1000 else None
        # the payload also 1 and 8 bytes past a 16-byte line
        payloads = [q] + ([misaligned(q, 1), misaligned(q, 8)] if mis else [])
        for k, kern, plain, args in (
                ("masked_cge_reduce", agg.masked_cge_reduce,
                 agg.masked_cge_dot, [(g, rx, f)]),
                ("trimmed_mean_tiled", agg.trimmed_mean_tiled,
                 agg.trimmed_mean_running, [(g, rx, f)]),
                ("dequant_accum", agg.dequant_accum, agg.dequant_dot,
                 [(qq, s, rx) for qq in payloads])):
            for a in args:
                out = kern(*a)
                what = f"{k} n={n} P={p} f={f}"
                if refs is None:
                    res = (f"max_abs_err="
                           f"{check(what, out, plain(*a), KERNEL_TOL, errs[k]):.3e}")
                else:
                    res = (f"{check_f64(what, out, *refs[k]):.3f} of its f64 "
                           "error bound")
                if not torch.equal(kern(*a), out):
                    raise AssertionError(f"{what}: not bit-identical on a "
                                         "repeated call")
                base = (f" payload base {a[0].data_ptr() % 16} mod 16"
                        if k == "dequant_accum" else "")
                log(f"  {k:20s} n={n:<4d} P={p:<9d} m={m:<4d} f={f} {res}, "
                    f"run to run identical{base}")
    for case, g, rx, f in edge_cases():
        q, s = gradagg.quantize_int8_parts(g)
        for k, kern, plain in (
                ("masked_cge_reduce", agg.masked_cge_reduce,
                 agg.masked_cge_dot),
                ("trimmed_mean_tiled", agg.trimmed_mean_tiled,
                 agg.trimmed_mean_running)):
            check(f"{k} {case}", kern(g, rx, f), plain(g, rx, f), EDGE_TOL,
                  errs[k])
        check(f"dequant_accum {case}", agg.dequant_accum(q, s[:, 0], rx),
              agg.dequant_dot(q, s[:, 0], rx), EDGE_TOL,
              errs["dequant_accum"])
        if case == "all_crashed":
            if agg.masked_cge_reduce(g, rx, f).abs().max() != 0 or \
                    agg.trimmed_mean_tiled(g, rx, f).abs().max() != 0 or \
                    agg.dequant_accum(q, s[:, 0], rx).abs().max() != 0:
                raise AssertionError("all_crashed must give exact zeros")
        log(f"  edge case {case}: ok")
    # every agent crashed at the paper's shape: the dequant writes zeros
    g, rx = ledger(N_AGENTS, P_LENET, 0, seed=0)
    q, s = gradagg.quantize_int8_parts(g)
    if agg.dequant_accum(q, s[:, 0], rx).abs().max() != 0:
        raise AssertionError("dequant_accum: all crashed must give zeros")
    log(f"  dequant_accum n={N_AGENTS} P={P_LENET}, every agent crashed: "
        "exact zeros")
    torch.cuda.synchronize()
    return {k: max(v) for k, v in errs.items()}


def time_ms(fn, flush=None, reps=30, warmup=3):
    """Median device ms of one call, timed alone with CUDA events. A spin
    kernel queued first lets the host enqueue the call ahead of the card,
    so host launch overhead stays out of the time; with ``flush`` (a
    buffer larger than the 50 MB L2) a read of it first evicts the inputs
    and leaves no dirty lines behind."""
    for _ in range(warmup):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in ev:
        torch.cuda._sleep(2_000_000)
        if flush is not None:
            flush.sum()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in ev]))


def library_cge(g, rx, k):
    norms = torch.where(rx, torch.linalg.norm(g, dim=1), float("inf"))
    keep = torch.zeros(g.shape[0], device=g.device)
    keep[torch.argsort(norms, stable=True)[:k]] = 1.0
    return keep @ g


def library_trimmed(g, rx, m, f):
    srt = torch.sort(torch.where(rx[:, None], g, float("inf")), dim=0).values
    return srt[f:m - f].sum(0) / max(m - 2 * f, 1)


def timing_row(kern, plain, lib, nbytes, nops, mem_rate, op_rate, flush):
    """Cold times of a kernel, its plain form and a library call for the
    same function (None where there is none), beside the bound: the
    larger of the bytes over the memory rate and the operations over
    ``op_rate``."""
    byte_ms = nbytes / mem_rate * 1e3
    op_ms = nops / op_rate * 1e3
    return dict(ms=time_ms(kern, flush), plain_ms=time_ms(plain, flush),
                library_ms=None if lib is None else time_ms(lib, flush),
                bound_ms=max(byte_ms, op_ms),
                bound_by="bytes" if byte_ms >= op_ms else "operations")


def time_kernels(mem_rate: float, f32_rate: float):
    n, p, f = N_AGENTS, P_LENET, 1
    m = N_AGENTS - 3
    g, rx = ledger(n, p, m, seed=0)
    q, s = gradagg.quantize_int8_parts(g)
    s = s[:, 0].contiguous()
    w = s * rx.float()
    flush = torch.zeros(64 * 2**20, dtype=torch.float32, device="cuda")
    # bytes the function must move: the received rows read once, the (P,)
    # f32 output written once (mask, scales and weights are O(n));
    # operations: f32 multiply-adds and compares per received element
    jobs = {
        "masked_cge_reduce": (
            lambda: agg.masked_cge_reduce(g, rx, f),
            lambda: agg.masked_cge_dot(g, rx, f),
            lambda: library_cge(g, rx, m - f),
            m * p * 4 + p * 4, 2 * m * p + (m - f) * p),
        "trimmed_mean_tiled": (
            lambda: agg.trimmed_mean_tiled(g, rx, f),
            lambda: agg.trimmed_mean_running(g, rx, f),
            lambda: library_trimmed(g, rx, m, f),
            m * p * 4 + p * 4, (m + 2 * f * m) * p),
        "dequant_accum": (
            lambda: agg.dequant_accum(q, s, rx),
            lambda: agg.dequant_dot(q, s, rx),
            lambda: w @ q.float(),
            m * p * 1 + p * 4, 2 * m * p),
    }
    rows = {}
    for k, (kern, plain, lib, nbytes, nops) in jobs.items():
        rows[k] = r = timing_row(kern, plain, lib, nbytes, nops, mem_rate,
                                 f32_rate, flush)
        warm = time_ms(kern)
        log(f"  {k:20s} kernel {r['ms']*1e3:7.2f} us (L2 warm "
            f"{warm*1e3:6.2f})  plain {r['plain_ms']*1e3:7.2f} us  library "
            f"{r['library_ms']*1e3:7.2f} us  bound {r['bound_ms']*1e3:5.2f} us"
            f" ({r['bound_by']}, {nbytes/1e6:.1f} MB at "
            f"{mem_rate/1e12:.2f} TB/s)")
        for kname, us in device_times(kern).items():
            log(f"      {kname:40s} {us:6.2f} us on the device (L2 warm)")
    # for scale, not a bound: one PyTorch reduction reading the same bytes
    # in the same timing window, launch and ramp-up included
    rows_rx = g[rx].contiguous()
    log(f"  for scale: torch.sum over the same {rows_rx.numel() * 4 / 1e6:.1f}"
        f" MB of received rows, contiguous, "
        f"{time_ms(rows_rx.sum, flush) * 1e3:.2f} us (L2 warm "
        f"{time_ms(rows_rx.sum) * 1e3:.2f})")
    return rows


def time_many_agents(mem_rate: float):
    """Cold times of the aggregation kernels past the shared-memory sizes,
    written down, not tuned: n = 4097 (CGE lists on chip beside 8 held
    columns, the trimmed mean through one stage of 8 columns, the mask
    walked in 33 batches) and n = 16,384 (CGE lists in a device workspace
    and no held column, the trimmed mean reading rows from device
    memory), P = 20,000, about 70% of the agents received, f = 1."""
    flush = torch.zeros(64 * 2**20, dtype=torch.float32, device="cuda")
    for n in (4097, 16_384):
        gen = torch.Generator(device="cuda").manual_seed(n)
        p = 20_000
        g = torch.randn((n, p), generator=gen, device="cuda")
        rx = torch.rand(n, generator=gen, device="cuda") > 0.3
        q, s = gradagg.quantize_int8_parts(g)
        s = s[:, 0].contiguous()
        m = int(rx.sum())
        f32_bytes, i8_bytes = m * p * 4 + p * 4, m * p + p * 4
        times = {k: time_ms(fn, flush, reps=10, warmup=1) for k, fn in (
            ("masked_cge_reduce", lambda: agg.masked_cge_reduce(g, rx, 1)),
            ("trimmed_mean_tiled", lambda: agg.trimmed_mean_tiled(g, rx, 1)),
            ("dequant_accum", lambda: agg.dequant_accum(q, s, rx)))}
        log(f"  n={n} P={p} m={m} f=1 (cold, not tuned): masked_cge_reduce "
            f"{times['masked_cge_reduce'] * 1e3:.2f} us, trimmed_mean_tiled "
            f"{times['trimmed_mean_tiled'] * 1e3:.2f} us (bound "
            f"{f32_bytes / mem_rate * 1e6:.2f} us each), dequant_accum "
            f"{times['dequant_accum'] * 1e3:.2f} us (bound "
            f"{i8_bytes / mem_rate * 1e6:.2f} us)")
        del g, q


def device_times(fn, calls: int = 20):
    """Mean device time per call of each CUDA kernel ``fn`` launches
    (torch.profiler, after warm-up; inputs warm in L2)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key.replace("void ", "").replace("(anonymous namespace)::", "")
            .split("(")[0]: e.self_device_time_total / calls
            for e in prof.key_averages() if e.self_device_time_total > 0}


# ---------------------------------------------------------------------------
# 3b. the paged flash-decode against its plain form, and its times


# (B, H, Hkv, D, Dv, page_size, Pmax, num_pages); the first is the
# serving path's own shape (qwen2-0.5b, phase 6)
DECODE_SHAPES = {
    "qwen2-0.5b": (8, 14, 2, 64, 64, 16, 48, 8 * 48 + 1),
    "qwen2-1.5b": (8, 12, 2, 128, 128, 16, 12, 8 * 12 + 1),
    "yi-6b": (4, 32, 4, 128, 128, 16, 12, 4 * 12 + 1),
    # phase 11's serving shapes: 4 slots, 17 pages of 16 tokens
    "jamba": (4, 32, 8, 128, 128, 16, 17, 4 * 17 + 1),
    "qwen2-vl-2b": (4, 12, 2, 128, 128, 16, 17, 4 * 17 + 1),
    "arctic": (4, 56, 8, 128, 128, 16, 17, 4 * 17 + 1),
    "dv_ne_d": (3, 2, 2, 128, 64, 8, 4, 16),
    "ps128": (2, 2, 1, 32, 32, 128, 2, 8),
    "pmax1": (2, 4, 2, 32, 32, 8, 1, 16),
}
# f32: tile-wise online softmax against one softmax, sums in another
# order; bf16: one rounding of the output (2^-7 relative, values of order 1)
DECODE_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
              torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def decode_inputs(shape, dtype, lens=None, seed=0):
    b, h, hkv, d, dv, ps, pmax, npg = shape
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k = rng.normal(size=(npg, ps, hkv, d)).astype(np.float32)
    v = rng.normal(size=(npg, ps, hkv, dv)).astype(np.float32)
    tbl = (rng.permutation(npg - 1)[: b * pmax] + 1).reshape(b, pmax)
    if lens is None:
        lens = rng.integers(1, pmax * ps + 1, size=b)
    return ([torch.from_numpy(a).to("cuda", dtype) for a in (q, k, v)]
            + [torch.tensor(tbl, dtype=torch.int32, device="cuda"),
               torch.tensor(lens, dtype=torch.int32, device="cuda")])


def split_plan(shape):
    b, _, hkv, _, _, ps, pmax, _ = shape
    return dattn.split_plan(b, hkv, pmax, ps, torch.cuda.get_device_properties(
        0).multi_processor_count)


def check_decode_kernel():
    errs = []
    for name, shape in DECODE_SHAPES.items():
        b, _, hkv, _, _, ps, pmax, _ = shape
        n_split, per = split_plan(shape)
        log(f"  paged_flash_decode {name}: split plan {n_split} splits of "
            f"{per} pages ({per * ps} tokens), {b * hkv * n_split} blocks")
        for dtype in (torch.float32, torch.bfloat16):
            for kind, lens in (("ragged", None),
                               ("full", np.full(b, pmax * ps))):
                args = decode_inputs(shape, dtype, lens)
                out = dattn.paged_flash_decode(*args)
                e = check(f"paged_flash_decode {name} {dtype} {kind}", out,
                          dattn.paged_decode_plain(*args),
                          DECODE_TOL[dtype], errs)
                if not torch.equal(dattn.paged_flash_decode(*args), out):
                    raise AssertionError(f"paged_flash_decode {name} "
                                         "differs run to run")
                log(f"  paged_flash_decode {name:11s} {str(dtype)[6:]:9s} "
                    f"{kind:6s} max_abs_err={e:.3e}, run to run identical")
    # kv_len 0, one token, on a page boundary, one past it, the full
    # table, more than the table holds
    lens = np.array([0, 1, 16, 17, 96, 500])
    used = -(-np.maximum(lens, 1) // 16)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, tbl, ln = decode_inputs((6, 14, 2, 64, 64, 16, 6, 64),
                                         dtype, lens, seed=3)
        out = dattn.paged_flash_decode(q, k, v, tbl, ln)
        check(f"paged_flash_decode edge lengths {dtype}", out,
              dattn.paged_decode_plain(q, k, v, tbl, ln), DECODE_TOL[dtype],
              errs)
        if not torch.equal(out[0], torch.zeros_like(out[0])):
            raise AssertionError("kv_len = 0 must give exact zeros")
        for fill in (-1, 5):
            stale = tbl.clone()
            for i, u in enumerate(used):
                stale[i, min(u, 6):] = fill
            if not torch.equal(dattn.paged_flash_decode(q, k, v, stale, ln),
                               out):
                raise AssertionError(f"table entries {fill} past the "
                                     "length changed the output")
    log("  edge cases kv_len 0 (exact zeros), 1, 16, 17, 96, 500; -1 and "
        "stale entries past the length (bit-identical): ok")
    # a 4096-token table over many splits: one token, one split exactly,
    # one split plus a token, the whole table; and run-to-run identity
    shape = (2, 14, 2, 64, 64, 16, 256, 2 * 256 + 1)
    n_split, per = split_plan(shape)
    for dtype in (torch.float32, torch.bfloat16):
        for lens in ([1, per * 16], [per * 16 + 1, 4096]):
            args = decode_inputs(shape, dtype, np.array(lens), seed=5)
            out = dattn.paged_flash_decode(*args)
            check(f"paged_flash_decode long {dtype} {lens}", out,
                  dattn.paged_decode_plain(*args), DECODE_TOL[dtype], errs)
            if not torch.equal(dattn.paged_flash_decode(*args), out):
                raise AssertionError("paged_flash_decode differs run to run")
    log(f"  long context (Pmax = 256, {n_split} splits of {per} pages): "
        f"lengths 1, {per * 16}, {per * 16 + 1}, 4096 within the limits, "
        "run to run identical: ok")
    torch.cuda.synchronize()
    return max(errs)


def library_decode(q, k_pages, v_pages, tbl_used, mask):
    """One PyTorch composite for the same function (timed only): gather
    the used pages, then scaled_dot_product_attention with the length
    mask and grouped KV heads."""
    b, h, d = q.shape
    hkv = k_pages.shape[2]
    k = k_pages[tbl_used].reshape(b, -1, hkv, d).transpose(1, 2)
    v = v_pages[tbl_used].reshape(b, -1, hkv, v_pages.shape[-1])
    return F.scaled_dot_product_attention(
        q[:, :, None], k, v.transpose(1, 2), attn_mask=mask[:, None, None],
        enable_gqa=True)[:, :, 0]


def time_decode_kernel(mem_rate: float, f32_rate: float):
    """The kernel at the serving path's shape (qwen2-0.5b, 8 slots, bf16)
    and lengths like phase 6's (prompts of 64-512 plus up to 64 new
    tokens). Bound: the valid tokens' K and V rows read once plus q and
    out, over the memory rate; operations: the f32 multiply-adds of the valid
    tokens' scores and weighted values."""
    shape = DECODE_SHAPES["qwen2-0.5b"]
    b, h, hkv, d, dv, ps, pmax, _ = shape
    n_split, per = split_plan(shape)
    lens = np.random.default_rng(1).integers(64, 577, size=b)
    args = decode_inputs(shape, torch.bfloat16, lens, seed=1)
    q, k, v, tbl, ln = args
    used = -(-lens // ps)
    tbl_used = tbl[:, :used.max()].long()
    mask = (torch.arange(used.max() * ps, device="cuda")[None]
            < ln.long()[:, None])
    nbytes = int(lens.sum()) * hkv * (d + dv) * 2 + 2 * b * h * (d + dv)
    nops = 2 * int(lens.sum()) * h * (d + dv)
    flush = torch.zeros(64 * 2**20, dtype=torch.float32, device="cuda")
    r = timing_row(lambda: dattn.paged_flash_decode(*args),
                   lambda: dattn.paged_decode_plain(*args),
                   lambda: library_decode(q, k, v, tbl_used, mask),
                   nbytes, nops, mem_rate, f32_rate, flush)
    warm = time_ms(lambda: dattn.paged_flash_decode(*args))
    log(f"  {'paged_flash_decode':20s} kernel {r['ms']*1e3:7.2f} us (L2 warm "
        f"{warm*1e3:6.2f})  plain {r['plain_ms']*1e3:7.2f} us  library "
        f"{r['library_ms']*1e3:7.2f} us  bound {r['bound_ms']*1e3:5.2f} us "
        f"({r['bound_by']}, {nbytes/1e6:.2f} MB at {mem_rate/1e12:.2f} TB/s;"
        f" lens {lens.tolist()}; {n_split} splits of {per} pages)")
    log(f"      kernel {r['ms'] / r['library_ms']:.2f}x the gather + SDPA "
        "composite's time")
    for kname, us in device_times(
            lambda: dattn.paged_flash_decode(*args)).items():
        log(f"      {kname:40s} {us:6.2f} us on the device (L2 warm)")
    log("      (the combine starts during the split kernel and waits for "
        "it: its span includes the wait)")
    return r


# ---------------------------------------------------------------------------
# 3c. flash attention and the CGE bucketed passes against their plain
#     forms, and their times


# phase 8's shapes: qwen2-0.5b's layer 0 over a 4096-token prompt (B, H,
# S, T, D, Dv), yi-6b's head shape, and the qwen2-0.5b parameter tree
# bucketed into rows of 2048
FLASH_QWEN = (1, 14, 4096, 4096, 64, 64)
FLASH_YI = (1, 32, 4096, 4096, 128, 128)
TREE_ROWS = (241_227, 2048)


def flash_inputs(shape, dtype, mult=1.0, seed=0):
    b, h, s, t, d, dv = shape[:6]
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(b, h, s, d)) * mult,
              rng.normal(size=(b, h, t, d)) * mult,
              rng.normal(size=(b, h, t, dv)))
    return [torch.from_numpy(a.astype(np.float32)).to("cuda", dtype)
            for a in arrays]


def check_flash_kernel():
    errs = {torch.float32: [], torch.bfloat16: []}
    for case in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(case, dtype, case[6])
            for causal in (True, False):
                e = check(f"flash_attention {case} {dtype} causal={causal}",
                          fattn.flash_attention(q, k, v, causal=causal),
                          fattn.flash_attention_plain(q, k, v, causal=causal),
                          FLASH_TOL[dtype], errs[dtype])
            log(f"  flash_attention {str(case[:6]):30s} x{case[6]:<3} "
                f"{str(dtype)[6:]:9s} max_abs_err={e:.3e} (causal and not)")
    torch.cuda.synchronize()
    log(f"  flash_attention: f32 max_abs_err {max(errs[torch.float32]):.3e}"
        f" ({FLASH_TOL[torch.float32]}), bf16 "
        f"{max(errs[torch.bfloat16]):.3e} ({FLASH_TOL[torch.bfloat16]})")
    return max(max(v) for v in errs.values())


def check_cge_norm_kernels():
    errs = []
    for n, w in CGE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            rng = np.random.default_rng(n * w)
            x = torch.from_numpy(rng.normal(size=(n, w)).astype(np.float32)
                                 ).to("cuda", dtype)
            norms = cgen.block_sq_norms(x)
            e = check(f"block_sq_norms {n}x{w} {dtype}", norms,
                      cgen.block_sq_norms_plain(x), NORM_TOL, errs)
            if not torch.equal(cgen.block_sq_norms(x), norms):
                raise AssertionError("block_sq_norms differs run to run")
            for scale in (rng.uniform(size=n), np.zeros(n), np.ones(n)):
                s = torch.tensor(scale, dtype=torch.float32, device="cuda")
                if not torch.equal(cgen.masked_scale(x, s),
                                   cgen.masked_scale_plain(x, s)):
                    raise AssertionError(f"masked_scale {n}x{w} {dtype} is "
                                         "not bit-identical")
            log(f"  block_sq_norms {n}x{w:<5d} {str(dtype)[6:]:9s} "
                f"max_abs_err={e:.3e} (rtol 1e-5), run to run identical; "
                "masked_scale bit-identical (uniform, 0, 1)")
    torch.cuda.synchronize()
    return {"block_sq_norms": max(errs), "masked_scale": 0.0}


def flash_work(shape, causal, elt):
    """(bytes, operations) flash attention must move and do: q, k, v read
    once and the output written once; 2 (D + Dv) operations per (query,
    key) pair the mask lets through."""
    b, h, s, t, d, dv = shape
    if causal:
        pairs = t * (t + 1) // 2 + (s - t) * t if s > t else s * (s + 1) // 2
    else:
        pairs = s * t
    return (b * h * (s * d + t * d + t * dv + s * dv) * elt,
            2 * (d + dv) * pairs * b * h)


def log_row(name, r, what, kern):
    lib = ("none" if r["library_ms"] is None
           else f"{r['library_ms'] * 1e3:9.2f} us")
    log(f"  {name:20s} kernel {r['ms'] * 1e3:9.2f} us  plain "
        f"{r['plain_ms'] * 1e3:9.2f} us  library {lib}  bound "
        f"{r['bound_ms'] * 1e3:8.2f} us ({r['bound_by']}; {what})")
    for kname, us in device_times(kern, calls=5).items():
        log(f"      {kname:40s} {us:9.2f} us on the device (L2 warm)")


def time_new_kernels(mem_rate, f32_rate, bf16_rate):
    """Flash attention (bf16, causal) at qwen2-0.5b's and yi-6b's
    long-prompt head shapes, the squared norms and the masked scaling on
    the qwen2-0.5b tree's 241,227 rows of 2048 bf16; seed-0 inputs."""
    flush = torch.zeros(64 * 2**20, dtype=torch.float32, device="cuda")
    rows = {}
    for label, shape in (("qwen2-0.5b", FLASH_QWEN), ("yi-6b", FLASH_YI)):
        q, k, v = flash_inputs(shape, torch.bfloat16)
        nbytes, nops = flash_work(shape, True, 2)
        kern = lambda: fattn.flash_attention(q, k, v)  # noqa: E731
        r = timing_row(
            kern, lambda: fattn.flash_attention_plain(q, k, v),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
            nbytes, nops, mem_rate, bf16_rate, flush)
        log_row("flash_attention", r, f"{label} {shape} bf16 causal, "
                f"{nops / 1e9:.2f} GFLOP at {bf16_rate / 1e12:.0f} TFLOP/s, "
                f"{nbytes / 1e6:.1f} MB", kern)
        log(f"      achieved {nops / r['ms'] / 1e9:.2f} TFLOP/s on the tensor "
            f"cores, SDPA {nops / r['library_ms'] / 1e9:.2f} TFLOP/s; kernel "
            f"{r['ms'] / r['library_ms']:.2f}x SDPA's time, "
            f"{r['ms'] / r['bound_ms']:.2f}x its bound")
        if label == "qwen2-0.5b":
            rows["flash_attention"] = r
        del q, k, v
    n, w = TREE_ROWS
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((n, w), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    s = (torch.rand(n, generator=gen, device="cuda") < 0.5).float()
    kern = lambda: cgen.block_sq_norms(x)  # noqa: E731
    rows["block_sq_norms"] = r = timing_row(
        kern, lambda: cgen.block_sq_norms_plain(x),
        lambda: torch.linalg.vector_norm(x, dim=1, dtype=torch.float32),
        n * w * 2 + n * 4, 2 * n * w, mem_rate, f32_rate, flush)
    log_row("block_sq_norms", r, f"{n} x {w} bf16, {(n * w * 2 + n * 4) / 1e6:.2f}"
            f" MB at {mem_rate / 1e12:.2f} TB/s", kern)
    # one torch.mul computes x * s in f32 and rounds once into x's dtype,
    # the same function bit for bit
    o = torch.empty_like(x)
    lib = lambda: torch.mul(x, s[:, None], out=o)  # noqa: E731
    kern = lambda: cgen.masked_scale(x, s)  # noqa: E731
    if not torch.equal(lib(), kern()):
        raise AssertionError("torch.mul is not masked_scale's function")
    rows["masked_scale"] = r = timing_row(
        kern, lambda: cgen.masked_scale_plain(x, s), lib,
        2 * n * w * 2 + n * 4, n * w, mem_rate, f32_rate, flush)
    log_row("masked_scale", r, f"{n} x {w} bf16, {(2 * n * w * 2 + n * 4) / 1e6:.2f}"
            f" MB at {mem_rate / 1e12:.2f} TB/s", kern)
    return rows


# ---------------------------------------------------------------------------
# 4. the main path


RUNS = [  # (label, kernel, cfg overrides)
    ("mean fresh r=3", None, dict(rule="mean", r=3)),
    ("cge fresh f=1 sign_flip", "masked_cge_reduce",
     dict(rule="cge", r=3, f=1, byz_ids=(4,), attack="sign_flip")),
    ("trimmed_mean stale tau=2 f=1", "trimmed_mean_tiled",
     dict(rule="trimmed_mean", mode="stale", tau=2, r=3, f=1)),
    ("quantized fresh r=3", "dequant_accum", dict(rule="quantized", r=3)),
]
LAUNCHES_PER_CALL = {"masked_cge_reduce": 1, "trimmed_mean_tiled": 1,
                     "dequant_accum": 1}
EVENT_FIELDS = ("n_rx", "max_age", "comm_time", "wall", "bytes_tx")


def make_server(sets, test, flat0, backend, overrides):
    grad_fn, _, unravel = lenet.make_agent_grad_fn(sets, 32, device="cuda",
                                                   flat0=flat0)
    tx = torch.as_tensor(test.x[:512], device="cuda")
    ty = torch.as_tensor(test.y[:512], device="cuda")
    ones = torch.ones(len(ty), device="cuda")

    def loss_fn(x):
        with torch.no_grad():
            flat = torch.as_tensor(np.asarray(x, np.float32), device="cuda")
            return classifier_loss(lenet.apply_lenet(unravel(flat), tx), ty,
                                   ones).item()

    cfg = EngineConfig(n_agents=N_AGENTS, step_size=lambda t: 0.05,
                       proj_gamma=1e6, seed=0, agg_backend=backend,
                       device="cuda", **overrides)
    srv = AsyncDGDServer(grad_fn, np.asarray(flat0), cfg,
                         latency=default_latency(N_AGENTS, 3, 10.0, seed=0),
                         loss_fn=loss_fn)
    return srv, grad_fn, cfg


def drive_main_path(half: int):
    train, test = mnist_like(n_train=4000, n_test=512, seed=0)
    sets = partition(train, N_AGENTS, overlap=2, seed=0)
    grad_fn, flat0, _ = lenet.make_agent_grad_fn(sets, 32, device="cuda")
    if flat0.device.type != "cuda" or flat0.numel() != P_LENET:
        raise AssertionError(f"LeNet has {flat0.numel()} parameters on "
                             f"{flat0.device}")
    flat0 = flat0.cpu().numpy()
    grad_fn(0, flat0, None)                  # cuDNN/cuBLAS set-up, untimed
    agg.reset_launches()
    t_main = time.perf_counter()
    for label, kernel, overrides in RUNS:
        before = dict(agg.LAUNCHES)
        t0 = time.perf_counter()
        srv, grad_fn, cfg = make_server(sets, test, flat0, "device",
                                        overrides)
        srv.run(1)
        x_1 = srv.x.copy()
        MAIN_PATH_X[label, 1] = x_1
        srv.run(half - 1)
        MAIN_PATH_X[label, half] = srv.x.copy()
        snap = srv.snapshot()
        streams = [r.bit_generator.state for r in grad_fn.rngs]
        srv.run(half)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        x_a, hist_a = srv.x.copy(), dataclasses.asdict(srv.engine.hist)
        MAIN_PATH_X[label, 2 * half] = x_a.copy()
        ledger_a = srv.engine.ledger_host()
        srv.restore(snap, cfg)
        for r, st in zip(grad_fn.rngs, streams):
            r.bit_generator.state = st
        srv.run(half)
        if not (np.array_equal(srv.x, x_a)
                and np.array_equal(srv.engine.ledger_host(), ledger_a)
                and dataclasses.asdict(srv.engine.hist) == hist_a):
            raise AssertionError(f"{label}: snapshot -> restore -> run "
                                 "is not bit-identical")
        losses = np.asarray(hist_a["loss"])
        if not (losses.size == 2 * half and np.isfinite(losses).all()
                and np.isfinite(x_a).all() and x_a.shape == (P_LENET,)):
            raise AssertionError(f"{label}: non-finite or misshapen output")
        # the host conformance pipeline on the card: same agents, same
        # events, the reference rule op by op. After one step the two differ
        # only by f32 summation order (the tests' tolerance). Later steps
        # feed that back through LeNet's gradients, and for the quantized
        # rule through int8 rounding, which can flip by one step, so the
        # end of the run is held to a relative distance and the losses.
        ref, _, _ = make_server(sets, test, flat0, "host", overrides)
        ref.run(1)
        np.testing.assert_allclose(x_1, np.asarray(ref.x, np.float64),
                                   rtol=1e-3, atol=1e-5, err_msg=label)
        h_ref = ref.run(2 * half - 1)
        for fld in EVENT_FIELDS:
            if getattr(h_ref, fld) != hist_a[fld]:
                raise AssertionError(f"{label}: {fld} differs from host run")
        rel = np.linalg.norm(x_a - ref.x) / np.linalg.norm(ref.x)
        if rel > 1e-3:
            raise AssertionError(f"{label}: |x - x_host| / |x_host| = {rel}")
        np.testing.assert_allclose(losses, h_ref.loss, rtol=1e-3,
                                   err_msg=label)
        if kernel is not None:
            calls = agg.LAUNCHES[kernel] - before[kernel]
            need = 3 * half * LAUNCHES_PER_CALL[kernel]
            if calls < need:
                raise AssertionError(f"{label}: {kernel} launched {calls} "
                                     f"times, expected at least {need}")
        log(f"  {label:30s} {2 * half} iters {dt:6.2f} s "
            f"({dt / (2 * half) * 1e3:7.1f} ms/iter)  loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}  "
            f"|x - x_host|/|x_host| {rel:.1e}")
    counts = dict(agg.LAUNCHES)
    log(f"  main path {time.perf_counter() - t_main:.1f} s, kernel launches "
        f"{counts}")
    for k, c in counts.items():
        if c == 0:
            raise AssertionError(f"{k} was not launched on the main path")
    return counts, (sets, test, flat0)


OUR_KERNELS = ("masked_cge_kernel", "trimmed_mean_kernel",
               "dequant_accum_kernel")


def where_time_goes(data, iters: int = 3):
    """Profile a few device-backend cge iterations: host wall time per
    iteration, the union of device activity (kernels and copies), the
    device's idle share, and the part of it that is copies and the
    aggregation kernels."""
    from torch.profiler import ProfilerActivity, profile
    srv, _, _ = make_server(*data, "device", RUNS[1][2])
    srv.run(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        srv.run(iters)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -np.inf
    for a, b, _ in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    per = lambda keys: sum(b - a for a, b, nm in spans  # noqa: E731
                           if any(k in nm for k in keys)) / 1e3 / iters
    busy = busy / 1e3 / iters
    log(f"  cge device backend under the profiler: {wall:.1f} ms/iter on the "
        f"host clock, device busy {busy:.2f} ms/iter (idle share "
        f"{1 - busy / wall:.3f}), copies {per(('Memcpy',)):.2f} ms, "
        f"aggregation kernels {per(OUR_KERNELS) * 1e3:.1f} us, "
        f"{len(spans) / iters:.0f} device activities per iteration")


def kernels_under(event):
    """The device kernels launched under a profiler CPU event."""
    return list(event.kernels) + [k for ch in event.cpu_children
                                  for k in kernels_under(ch)]


def where_quantized_time_goes(data, iters: int = 3):
    """Profile a few quantized device-backend iterations and split the
    aggregate step: the int8 quantization (``gradagg.quantize_int8_parts``,
    PyTorch operations over the whole (n, P) ledger, run under a
    ``record_function`` range here) against ``dequant_accum``'s kernel,
    device us per iteration each."""
    from torch.profiler import ProfilerActivity, profile, record_function
    parts = gradagg.quantize_int8_parts

    def traced(x):
        with record_function("quantize_int8_parts"):
            return parts(x)

    srv, _, _ = make_server(*data, "device", RUNS[3][2])
    srv.run(1)
    torch.cuda.synchronize()
    gradagg.quantize_int8_parts = traced
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            srv.run(iters)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / iters
    finally:
        gradagg.quantize_int8_parts = parts
    quant = [k for e in prof.events() if e.name == "quantize_int8_parts"
             and e.device_type == torch.autograd.DeviceType.CPU
             for k in kernels_under(e)]
    spans = [sp for sp in device_spans(prof)     # not the range's own span
             if sp[2] != "quantize_int8_parts"]
    deq = [b - a for a, b, nm in spans if "dequant_accum_kernel" in nm]
    if not quant or not deq:
        raise AssertionError(f"quantized profile: {len(quant)} quantize "
                             f"kernels, {len(deq)} dequant launches")
    q_us = sum(k.duration for k in quant) / iters
    d_us = sum(deq) / iters
    log(f"  quantized device backend under the profiler: {wall:.1f} ms/iter "
        f"on the host clock, device busy {busy_us(spans) / 1e3 / iters:.2f} "
        f"ms/iter; aggregate step on the device per iteration: quantize "
        f"{q_us:.1f} us ({len(quant) / iters:.0f} kernels) vs dequant_accum "
        f"{d_us:.1f} us ({len(deq) / iters:.0f} launch)")
    by_name = {}
    for k in quant:
        n, us = by_name.get(k.name[:70], (0, 0.0))
        by_name[k.name[:70]] = (n + 1, us + k.duration)
    for nm, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
        log(f"      {nm:70s} {n / iters:4.1f} per iter {us / iters:8.1f} us")


# ---------------------------------------------------------------------------
# 6. the serving path at full qwen2-0.5b width


SERVE_ARCH = "qwen2-0.5b"
# the model of phases 6-14 (one parameter set, phase 6's): qwen2-0.5b at
# full width, cut in depth; the host issues each layer's operations, so
# their times (phase 14's timescale among them) follow the depth
SERVE_LAYERS = 4


def serve_cfg():
    """qwen2-0.5b at full width, ``SERVE_LAYERS`` of its 24 layers."""
    return dataclasses.replace(get_config(SERVE_ARCH), n_layers=SERVE_LAYERS)

# the decode's two CUDA kernels (split partials, combine) share this prefix
DECODE_KERNEL = "paged_decode_"
SERVE_CCFG = PagedCacheConfig(num_slots=8, page_size=16, max_pages_per_seq=48,
                              num_pages=8 * 48 + 1)
# teacher-forced decode logits, kernel against plain form, both bf16: the
# attention outputs differ by rounding (f32 sums in another order, then a
# bf16 cast), which 24 layers carry into logits of order 1 to 10, whose
# own bf16 step is 2^-7 to 2^-4
LOGIT_TOL = 0.125
F32_LOGIT_TOL = 1e-4          # f32 tensor-parallel logits vs one rank's


class TimedEngine(ServeEngine):
    """ServeEngine whose host-clock totals come from its own spans
    (``repro_torch.spans``), recorded while it is driven inside
    ``with eng.timed():``: ``step_s`` the ``serve.step`` spans,
    ``prefill_s`` the ``serve.prefill`` ones. Both end in a host sync, so
    the clock covers the device work; decode time is step time minus
    prefill time."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.spans = []

    @contextlib.contextmanager
    def timed(self):
        spans.clear()
        spans.start()
        try:
            yield self
        finally:
            spans.stop()
            self.spans += spans.recorded()
            spans.clear()

    def host_s(self, *names) -> float:
        return sum(s.t1_ns - s.t0_ns for s in self.spans
                   if s.name in names) * 1e-9

    @property
    def step_s(self) -> float:
        return self.host_s("serve.step")

    @property
    def prefill_s(self) -> float:
        return self.host_s("serve.prefill")


def serve_requests(cfg, n: int = 24, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, int(rng.integers(64, 513)))
             .astype(np.int32), int(rng.integers(16, 65))) for _ in range(n)]


@torch.no_grad()
def teacher_forced_logits(params, cfg, prompts, streams, impl,
                          ccfg=SERVE_CCFG):
    """(T, B, vocab) paged-decode logits along ``streams`` (B, T) with
    attention form ``impl``: prompt i prefilled into slot i of a fresh
    cache of layout ``ccfg``, then ``streams[:, t]`` fed at step t."""
    kv = PagedKVCache(cfg, ccfg, device="cuda")
    for slot, prompt in enumerate(prompts):
        _, _, cache = apply_model(params, torch.tensor(prompt[None],
                                                       device="cuda"),
                                  cfg, mode="prefill", logits_chunk=1)
        kv.admit(slot, cache, len(prompt), len(prompt) + streams.shape[1])
    slots = list(range(len(prompts)))
    out = []
    for t in range(streams.shape[1]):
        tokens = np.zeros((ccfg.num_slots, 1), np.int32)
        tokens[slots, 0] = streams[:, t]
        logits, _, _ = apply_model(
            params, torch.tensor(tokens, device="cuda"), cfg, mode="decode",
            cache=kv.cache, cache_index=kv.kv_lens_dev,
            page_table=kv.page_table_dev, impl=impl)
        kv.commit_token(slots)
        out.append(logits[slots, 0])
    return torch.stack(out)


def run_engine(params, cfg, reqs, k, ccfg=SERVE_CCFG):
    eng = TimedEngine(params, cfg, ccfg, superstep_k=k)
    with eng.timed():
        rids = [eng.submit(p, n) for p, n in reqs]
        out = eng.run()
    torch.cuda.synchronize()
    return eng, rids, out


def drive_serving():
    cfg = serve_cfg()
    t0 = time.perf_counter()
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_flatten(params)[0])
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} parameters, want "
                             f"{cfg.param_count()}")
    log(f"  {SERVE_ARCH}: {n_params:,} parameters (bf16) initialised on the "
        f"card in {time.perf_counter() - t0:.1f} s")
    reqs = serve_requests(cfg)
    run_engine(params, cfg, serve_requests(cfg, n=2, seed=1), 8)  # warm-up

    dattn.reset_launches()
    eng, rids, out = run_engine(params, cfg, reqs, 8)
    launches = dattn.LAUNCHES["paged_flash_decode"]
    st = eng.stats
    for rid, (prompt, budget) in zip(rids, reqs):
        toks = out[rid]
        if toks.shape != (budget,) or toks.min() < 0 or \
                toks.max() >= cfg.vocab_size:
            raise AssertionError(f"request {rid}: {toks.shape} tokens, "
                                 f"budget {budget}")
    if eng.kv.alloc.n_used or not eng.kv.alloc.check_invariants():
        raise AssertionError(f"{eng.kv.alloc.n_used} pages still used")
    if launches < st["decode_steps"] * cfg.n_layers:
        raise AssertionError(f"paged_flash_decode launched {launches} times "
                             f"for {st['decode_steps']} decode steps")
    decode_s = eng.step_s - eng.prefill_s
    decode_tokens = sum(len(t) - 1 for t in out.values())
    ttft = np.mean([s.ttft for s in eng.sched.finished.values()])
    metrics = dict(decode_tok_s=decode_tokens / decode_s,
                   ms_per_superstep=decode_s / st["supersteps"] * 1e3,
                   ms_per_decode_step=decode_s / st["decode_steps"] * 1e3,
                   mean_ttft_ms=ttft * 1e3,
                   prefill_ms=eng.prefill_s / st["prefill_calls"] * 1e3)
    log(f"  24 requests, {sum(n for _, n in reqs)} tokens, superstep_k=8: "
        f"{st['decode_steps']} decode steps in {st['supersteps']} supersteps,"
        f" {st['prefill_calls']} prefill calls, {st['host_syncs']} host "
        f"syncs; paged_flash_decode launched {launches} times")
    log(f"  decode {metrics['decode_tok_s']:.1f} tok/s, "
        f"{metrics['ms_per_superstep']:.2f} ms per superstep "
        f"({metrics['ms_per_decode_step']:.2f} ms per decode step), mean "
        f"TTFT {metrics['mean_ttft_ms']:.1f} ms, prefill "
        f"{metrics['prefill_ms']:.2f} ms per call "
        f"({eng.prefill_s * 1e3:.1f} ms in all)")

    ref, ref_rids, ref_out = run_engine(params, cfg, reqs, 1)
    for a, b in zip(rids, ref_rids):
        if not np.array_equal(out[a], ref_out[b]):
            raise AssertionError(f"request {a}: superstep_k=8 and 1 differ")
    log(f"  token streams identical to the superstep_k=1 run "
        f"({ref.stats['decode_steps']} decode steps, "
        f"{ref.stats['host_syncs']} host syncs)")

    # teacher-forced logits through the kernel and the plain form
    t_len = 16
    prompts = [p for p, _ in reqs[:8]]
    streams = np.stack([out[r][:t_len] for r in rids[:8]])
    lg_k = teacher_forced_logits(params, cfg, prompts, streams,
                                 "cuda").float()
    lg_p = teacher_forced_logits(params, cfg, prompts, streams,
                                 "plain").float()
    diff = float((lg_k - lg_p).abs().max())
    top2 = lg_p.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    clear = margin > LOGIT_TOL
    agree = lg_k.argmax(-1) == lg_p.argmax(-1)
    log(f"  teacher-forced decode, 8 slots x {t_len} steps: max |logit "
        f"diff| {diff:.4f} (logits up to {float(lg_p.abs().max()):.2f}, "
        f"tolerance {LOGIT_TOL}); argmax agrees at {int(agree.sum())} of "
        f"{agree.numel()} positions, {int(clear.sum())} with a top-2 margin "
        "above the tolerance")
    if not torch.isfinite(lg_k).all() or diff > LOGIT_TOL or \
            not bool(agree[clear].all()):
        raise AssertionError("teacher-forced logits: kernel and plain form "
                             "disagree")

    share = kernel_share(params, cfg, reqs)
    log(f"  paged_flash_decode: {share:.3f} of device busy time over the "
        "same run (torch.profiler)")
    metrics["kernel_share"] = share
    return launches, params, metrics


def device_spans(prof):
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)


def busy_us(spans):
    busy, end = 0.0, -np.inf
    for a, b, _ in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def decode_spans(spans):
    """The decode's device spans. The combine kernel is a programmatic
    dependent launch: it starts during the split kernel and waits there,
    so the two overlap and their time is the union of their spans."""
    return [sp for sp in spans if DECODE_KERNEL in sp[2]]


def kernel_share(params, cfg, reqs):
    """The decode kernel's share of device busy time over a replay of
    the phase-6 workload (device activities only)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_engine(params, cfg, reqs, 8)
    spans = device_spans(prof)
    return busy_us(decode_spans(spans)) / busy_us(spans)


def where_serving_time_goes(params, steps: int = 3):
    """Profile a few full supersteps (8 slots, K=8): host ms per step,
    device busy time and idle share, and device activities per decode
    step."""
    cfg = serve_cfg()
    eng = ServeEngine(params, cfg, SERVE_CCFG, superstep_k=8)
    rng = np.random.default_rng(2)
    for _ in range(8):
        eng.submit(rng.integers(0, cfg.vocab_size, 256).astype(np.int32), 64)
    profile_decode(eng, steps)


def profile_decode(eng, steps: int, top: int = 6):
    """Run the engine's admissions and first superstep, then profile
    ``steps`` more: host ms per decode step, device busy time and idle
    share, device activities per decode step and the ``top`` activities
    by device time."""
    from torch.profiler import ProfilerActivity, profile
    eng.step()                              # admissions + first superstep
    torch.cuda.synchronize()
    k0 = eng.stats["decode_steps"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    n_dec = eng.stats["decode_steps"] - k0
    spans = device_spans(prof)
    busy = busy_us(spans) / 1e3
    mine = busy_us(decode_spans(spans))
    log(f"  {steps} supersteps ({n_dec} decode steps) under the profiler: "
        f"{wall / n_dec:.2f} ms per decode step on the host clock, device "
        f"busy {busy / n_dec:.3f} ms per decode step (idle share "
        f"{1 - busy / wall:.3f}), {len(spans) / n_dec:.0f} device "
        f"activities per decode step, paged_flash_decode "
        f"{mine / n_dec:.1f} us per decode step")
    by_name = {}
    for a, b, nm in spans:
        n, us = by_name.get(nm[:60], (0, 0.0))
        by_name[nm[:60]] = (n + 1, us + b - a)
    for nm, (n, us) in sorted(by_name.items(),
                              key=lambda kv: -kv[1][1])[:top]:
        log(f"      {nm:60s} {n / n_dec:5.1f} per step {us / n_dec:8.1f} us"
            " per step")


# ---------------------------------------------------------------------------
# 8. the kernels API at full width


FLASH_PROMPT = 4096
# ops.flash_attention (f32 inside, one bf16 rounding of the output) against
# the model's chunked attention, which rounds p to bf16 and carries its
# accumulator in bf16 across its 4 chunks of 1024 keys: outputs of order 1
# differ by a few bf16 steps, the whole output by about 2^-8 in L2
CHUNKED_BOUND = 5e-2
CHUNKED_REL_L2 = 2e-2
TOTAL_RTOL = 1e-5       # the norms' f32 total against an f64 sum of squares


@torch.no_grad()
def layer0_qkv(params, cfg, n_tokens):
    """Layer 0's q, k, v over a seed-0 prompt, through the model's own
    embedding, norm, projections and RoPE, with the KV heads expanded as
    ``apply_gqa`` does: (B, S, H, hd) bf16 each."""
    tokens = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, n_tokens)[None], device="cuda")
    layer = mmodel._unstack(params["blocks"][0], cfg.n_periods)[0]
    x = mlayers.embed_tokens(params["embed"], tokens, cfg)
    h = mlayers.apply_norm(layer["norm1"], x, cfg)
    q = mattn._proj_q(layer["mixer"], h, cfg)
    k, v = mattn._proj_kv(layer["mixer"], h, cfg)
    pos = mmodel._positions_for(cfg, 1, n_tokens, 0, tokens.device)
    rope = mlayers.rope_cos_sin(pos, cfg.resolved_head_dim, cfg.rope_theta)
    q, k = mlayers.rotate(q, *rope), mlayers.rotate(k, *rope)
    g = cfg.n_heads // cfg.n_kv_heads
    return (q, torch.repeat_interleave(k, g, dim=2),
            torch.repeat_interleave(v, g, dim=2))


@torch.no_grad()
def flash_on_activations(params, cfg):
    q, k, v = layer0_qkv(params, cfg, FLASH_PROMPT)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    out = ops.flash_attention(qt, kt, vt, causal=True)
    plain = fattn.flash_attention_plain(qt, kt, vt, causal=True)
    e = check("ops.flash_attention on layer 0", out, plain,
              FLASH_TOL[torch.bfloat16], [])
    chunked = mattn.chunked_attention(q, k, v, causal=True).transpose(1, 2)
    delta = out.float() - chunked.float()
    diff = float(delta.abs().max())
    rel = float(delta.norm() / chunked.float().norm())
    mag = plain.float().abs()
    log(f"  flash attention, qwen2-0.5b layer 0, {FLASH_PROMPT}-token prompt "
        f"{tuple(qt.shape)} {str(qt.dtype)[6:]} causal: kernel vs plain form "
        f"max_abs_err {e:.3e} ({FLASH_TOL[torch.bfloat16]}); vs the model's "
        f"chunked attention max {diff:.3e} (bound {CHUNKED_BOUND}), relative "
        f"L2 {rel:.3e} (bound {CHUNKED_REL_L2}); |out| median "
        f"{float(mag.median()):.4f}, max {float(mag.max()):.3f}")
    if diff > CHUNKED_BOUND or rel > CHUNKED_REL_L2:
        raise AssertionError(f"flash attention and chunked attention differ "
                             f"by {diff} (max), {rel} (relative L2)")


@torch.no_grad()
def norms_over_tree(params, cfg):
    rows, n = ops.tree_bucket(params)
    width = TREE_ROWS[1]
    if n != cfg.param_count() or rows.shape != (-(-n // width), width):
        raise AssertionError(f"tree_bucket gave {tuple(rows.shape)}, {n}")
    norms = ops.block_sq_norms(rows)
    e = check("ops.block_sq_norms on the qwen2-0.5b tree", norms,
              cgen.block_sq_norms_plain(rows), NORM_TOL, [])
    total = float(norms.double().sum())
    want = sum(float(t.to(torch.bfloat16).double().square().sum())
               for t in tree_flatten(params)[0])
    rel = abs(total - want) / want
    scale = torch.from_numpy(np.random.default_rng(0).integers(
        0, 2, rows.shape[0]).astype(np.float32)).cuda()
    same = torch.equal(ops.masked_scale(rows, scale),
                       cgen.masked_scale_plain(rows, scale))
    log(f"  qwen2-0.5b tree: {n:,} parameters -> {rows.shape[0]:,} rows x "
        f"{rows.shape[1]} bf16 ({rows.numel() * 2 / 1e6:.2f} MB); squared "
        f"norms vs plain max_abs_err {e:.3e} (rtol 1e-5), total {total:.6e} "
        f"vs f64 {want:.6e} (relative {rel:.1e}, limit {TOTAL_RTOL}); "
        f"masked_scale (keep/drop per row) bit-identical: {same}")
    if rel > TOTAL_RTOL or not same:
        raise AssertionError("norms or masked_scale over the tree are wrong")


def keepset_on_lenet(data):
    """One cge iteration of phase 4's run (20 agents, one sign-flip, f=1):
    the ledger's gradients bucketed through ``tree_bucket`` of each
    agent's LeNet parameter dict, per-agent squared norms as the sum of
    its 211 bucket norms, and the CGE keep-set from their square roots."""
    overrides = RUNS[1][2]
    srv, _, _ = make_server(*data, "device", overrides)
    seen = []
    step = srv.engine._device_step

    def spy(received, eta):
        seen.append(received.copy())
        step(received, eta)

    srv.engine._device_step = spy
    srv.run(1)
    g = torch.from_numpy(srv.engine.ledger_host()).cuda()
    rx = torch.from_numpy(seen[0]).cuda()
    f = overrides["f"]
    layout = lenet.lenet_layout()
    rows = torch.cat([ops.tree_bucket(layout.unflatten(g[j]))[0]
                      for j in range(N_AGENTS)])
    per = rows.shape[0] // N_AGENTS
    sq = ops.block_sq_norms(rows).view(N_AGENTS, per).sum(1)
    sq_plain = cgen.block_sq_norms_plain(rows).view(N_AGENTS, per).sum(1)
    keep = gradagg.cge_mask_from_norms(sq.sqrt(), rx, f)
    keep_plain = gradagg.cge_mask_from_norms(sq_plain.sqrt(), rx, f)
    f32_norms = agg.row_norms(g)
    keep_f32 = gradagg.cge_mask_from_norms(f32_norms, rx, f)
    rel = ((sq.sqrt() - f32_norms).abs() / f32_norms)[rx]
    srt = torch.sort(f32_norms[rx]).values
    m = int(rx.sum())
    gap = float((srt[m - f] - srt[m - f - 1]) / srt[m - f - 1])
    log(f"  LeNet cge iteration: {m} of {N_AGENTS} received, f={f}, "
        f"{per} rows of 2048 per agent; keep-set from kernel norms equals "
        f"the plain form's: {torch.equal(keep, keep_plain)}; equals the f32 "
        f"ledger's: {torch.equal(keep, keep_f32)} (bf16 bucketing moves a "
        f"norm by at most {float(rel.max()):.2e} relative; the f32 norms "
        f"at the keep boundary are {gap:.2e} apart, relative)")
    if not torch.equal(keep, keep_plain):
        raise AssertionError("keep-set from kernel norms differs from the "
                             "plain form's")
    if not torch.equal(keep, keep_f32) and gap > 2 * float(rel.max()):
        raise AssertionError("bf16 keep-set differs beyond the bucketing's "
                             "relative error")


def drive_kernels_api(params, data):
    cfg = serve_cfg()
    fattn.reset_launches()
    cgen.reset_launches()
    t0 = time.perf_counter()
    flash_on_activations(params, cfg)
    norms_over_tree(params, cfg)
    keepset_on_lenet(data)
    torch.cuda.synchronize()
    counts = {**fattn.LAUNCHES, **cgen.LAUNCHES}
    log(f"  phase 8 in {time.perf_counter() - t0:.1f} s, kernel launches "
        f"{counts}")
    for k, c in counts.items():
        if c == 0:
            raise AssertionError(f"{k} was not launched in phase 8")
    return counts


# ---------------------------------------------------------------------------
# 9. the simulator on the card


# trace fields from numpy event logic and the transport's own stream:
# identical on every device; loss and dist come from an f32 rule whose
# reduction order is the device's (tests/test_torch_engine.py tolerances)
SIM_EXACT = ("t", "n_rx", "r", "comm", "stale", "amax")
SIM_LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
SIM_DIST_TOL = dict(rtol=1e-3, atol=1e-5)
# the two scenarios run again on the device backend: CGE under two attack
# switches, and the stale rule through a crash/recover wave
SIM_DEVICE_RUNS = ("byzantine_flip_midrun", "rolling_restart")


def check_sim_train(label, rep, ref):
    """``rep`` (card) against ``ref`` (CPU, same process): no violation,
    the discrete fields identical, loss and dist within tolerance."""
    if rep.violations or ref.violations:
        raise AssertionError(f"{label}: violations "
                             f"{summarize(rep.violations + ref.violations)}")
    for key in SIM_EXACT:
        if [st[key] for st in rep.trace] != [st[key] for st in ref.trace]:
            raise AssertionError(f"{label}: trace field {key} differs from "
                                 "the CPU run")
    if (rep.hist.bytes_tx, rep.transport.drops, rep.transport.dups) != \
            (ref.hist.bytes_tx, ref.transport.drops, ref.transport.dups):
        raise AssertionError(f"{label}: bytes_tx, drops or dups differ")
    np.testing.assert_allclose([st["loss"] for st in rep.trace],
                               [st["loss"] for st in ref.trace],
                               err_msg=label, **SIM_LOSS_TOL)
    np.testing.assert_allclose([st["dist"] for st in rep.trace],
                               [st["dist"] for st in ref.trace],
                               err_msg=label, **SIM_DIST_TOL)


def log_sim_train(label, rep, dt):
    sc = rep.scenario
    dist = rep.hist.dist[-1]
    if sc.expect.check_envelope:
        limit = (f"envelope radius "
                 f"{rep.envelope.radius(sc.expect.envelope_slack):.4g}")
    else:
        limit = f"max_dist {sc.expect.max_dist}"
    log(f"  {label:36s} {sc.iters} iters {dt:6.2f} s "
        f"({sc.iters / dt:7.1f} it/s)  ||x - x*|| {dist:.4g} vs {limit}, "
        f"drops {rep.transport.drops}, dups {rep.transport.dups}")


def drive_simulator():
    """Every registered scenario's ``run_train`` on the card (host
    backend) against the same run on the CPU, its ``run_serve``, then
    ``SIM_DEVICE_RUNS`` on the device backend. The aggregation kernels'
    counts are zeroed just before and read just after."""
    agg.reset_launches()
    t_all = time.perf_counter()
    on_cpu = {}
    for name in sorted(SCENARIOS):
        sc = get_scenario(name)
        t0 = time.perf_counter()
        rep = run_train(sc, device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        on_cpu[name] = run_train(sc, device="cpu")
        check_sim_train(name, rep, on_cpu[name])
        log_sim_train(f"{name} (host)", rep, dt)
        served = run_serve(sc)
        if served.violations or len(served.trace) != sc.n_requests or \
                not np.isfinite(served.latencies).all():
            raise AssertionError(f"{name} serve: {len(served.trace)} "
                                 f"requests, violations "
                                 f"{summarize(served.violations)}")
    for name in SIM_DEVICE_RUNS:
        sc = get_scenario(name)
        before = agg.LAUNCHES["masked_cge_reduce"]
        t0 = time.perf_counter()
        rep = run_train(sc, device="cuda", agg_backend="device")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launched = agg.LAUNCHES["masked_cge_reduce"] - before
        check_sim_train(f"{name} (device)", rep, on_cpu[name])
        log_sim_train(f"{name} (device)", rep, dt)
        if sc.rule == "cge" and launched < sc.iters:
            raise AssertionError(f"{name}: masked_cge_reduce launched "
                                 f"{launched} times in {sc.iters} iters")
    counts = dict(agg.LAUNCHES)
    log(f"  phase 9 in {time.perf_counter() - t_all:.1f} s: 13 scenarios "
        f"x (train on the card and the CPU, serve), {len(SIM_DEVICE_RUNS)} "
        f"on the device backend; kernel launches {counts}")
    if counts["masked_cge_reduce"] == 0:
        raise AssertionError("masked_cge_reduce was not launched in phase 9")
    return {"masked_cge_reduce": counts["masked_cge_reduce"]}


# ---------------------------------------------------------------------------
# 10. the e2e harness at full width


# (name, requests run of the scenario's): cut to their first 8 and 16 to
# leave phases 12-14 room in the script's time
E2E_RUNS = (("e2e_steady", 8), ("crash_cascade", 16))
E2E_REPLICAS = 8


def log_quorum(row, label):
    log(f"    {label:8s} ok {row.n_ok}/{row.n_requests} degraded "
        f"{row.n_degraded} unanswered {row.n_unanswered}  goodput "
        f"{row.goodput:.4f}/unit  latency p50 {row.p50_latency:.3f} p99 "
        f"{row.p99_latency:.3f}  TTFT p50 {row.p50_ttft:.3f} p99 "
        f"{row.p99_ttft:.3f}")


@torch.no_grad()
def greedy_check(params, cfg, page_size, prompts, streams):
    """Each of ``streams`` (1-D, any lengths) against the greedy argmax
    of its logits through the plain attention form: the first token
    against the prefill's (which runs no decode kernel), the rest against
    teacher-forced decode logits, 8 streams at a time on a fresh cache
    of ``page_size``-token pages. The streams were served with prompts
    prefilled in groups, or a cached prefix and a suffix fed through
    decode; these are prefilled one at a time, so bf16 roundings differ
    and a near tie may flip: a stream must be the argmax wherever the
    top-2 margin exceeds ``LOGIT_TOL``, and the kernel's teacher-forced
    logits must be within ``LOGIT_TOL`` of the plain form's. Returns
    (max |logit diff| between the kernel and the plain form, positions
    checked, positions within the margin, positions where the stream is
    the plain argmax)."""
    diff, checked, close, same = 0.0, 0, 0, 0
    for i in range(0, len(streams), 8):
        batch, ss = prompts[i:i + 8], streams[i:i + 8]
        n = np.asarray([len(s) for s in ss])
        toks = np.zeros((len(ss), n.max()), np.int32)
        for b, s in enumerate(ss):
            toks[b, :len(s)] = s
        pages = max(-(-(len(p) + n.max()) // page_size) for p in batch)
        ccfg = PagedCacheConfig(num_slots=8, page_size=page_size,
                                max_pages_per_seq=pages,
                                num_pages=8 * pages + 1)
        first = []
        for prompt in batch:
            x, _, _ = apply_model(params, torch.tensor(prompt[None],
                                                       device="cuda"),
                                  cfg, mode="prefill", logits_chunk=1)
            first.append(mlayers.unembed(params["embed"], x[0, -1], cfg))
        lg_p = teacher_forced_logits(params, cfg, batch, toks[:, :-1],
                                     "plain", ccfg).float()
        lg_k = teacher_forced_logits(params, cfg, batch, toks[:, :-1],
                                     "cuda", ccfg).float()
        # (T, B): position t of stream b was served
        valid = torch.as_tensor(np.arange(n.max())[:, None] < n[None],
                                device="cuda")
        if n.max() > 1:
            diff = max(diff, float((lg_k - lg_p).abs()[valid[1:]].max()))
        # position 0: the prefill's logits; then the decode's, teacher forced
        lg_p = torch.cat([torch.stack(first)[None].float(), lg_p])
        top2 = lg_p.topk(2, dim=-1).values
        clear = ((top2[..., 0] - top2[..., 1]) > LOGIT_TOL) & valid
        want = torch.as_tensor(toks.T, device="cuda").long()
        agree = (lg_p.argmax(-1) == want) & valid
        if not bool(agree[clear].all()):
            raise AssertionError("a served stream leaves the plain form's "
                                 "greedy argmax at a clear margin")
        checked += int(valid.sum())
        close += int((valid & ~clear).sum())
        same += int(agree.sum())
    if diff > LOGIT_TOL:
        raise AssertionError(f"teacher-forced logits: kernel and plain "
                             f"form differ by {diff}")
    return diff, checked, close, same


def plain_greedy_check(params, cfg, ecfg, report):
    """``greedy_check`` of every delivered honest stream of ``report``."""
    done = [q for q in report.requests if q.delivered()]
    return greedy_check(params, cfg, ecfg.page_size,
                        [q.prompt for q in done],
                        [q.delivered()[0].tokens for q in done])


def drive_e2e(params):
    """``run_e2e`` on one fleet of 8 full-width qwen2-0.5b replicas over
    phase 6's weights: ``e2e_steady`` cut to 8, then ``crash_cascade`` to 16
    requests, on the same warm fleet. The decode kernel's count is
    zeroed just before each run and read just after."""
    cfg = serve_cfg()
    fleet = EngineFleet(E2E_REPLICAS, params=params, cfg=cfg, device="cuda")
    ecfg = fleet.ecfg
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    plan = dattn.split_plan(ecfg.num_slots, cfg.n_kv_heads,
                            ecfg.max_pages_per_seq, ecfg.page_size, n_sm)
    log(f"  {E2E_REPLICAS} replicas of {SERVE_ARCH} (full width, one "
        f"parameter set), {ecfg.num_slots} slots, {ecfg.page_size}-token "
        f"pages, at most {ecfg.max_pages_per_seq} a sequence, superstep_k="
        f"{ecfg.superstep_k}, {ecfg.max_new_tokens} new tokens a request; "
        f"decode split plan (splits, pages a split) {plan}")
    log("  reduced: " + ", ".join(
        f"{name} {get_scenario(name).n_requests} -> {cut} requests"
        for name, cut in E2E_RUNS))
    total, results = 0, {}
    for name, cut in E2E_RUNS:
        if not fleet.drained():
            raise AssertionError(f"fleet not drained before {name}")
        sc = get_scenario(name)
        st0 = [dict(e.stats) for e in fleet.engines]
        dattn.reset_launches()
        t0 = time.perf_counter()
        rep = run_e2e(sc, fleet=fleet, n_requests=cut)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dattn.LAUNCHES["paged_flash_decode"]
        total += launches
        if rep.violations:
            raise AssertionError(f"{name}: {summarize(rep.violations)}")
        if not fleet.drained():
            raise AssertionError(f"{name}: fleet not drained after the run")
        dec = [e.stats["decode_steps"] - s["decode_steps"]
               for e, s in zip(fleet.engines, st0)]
        sup = [e.stats["supersteps"] - s["supersteps"]
               for e, s in zip(fleet.engines, st0)]
        pre = [e.stats["prefill_calls"] - s["prefill_calls"]
               for e, s in zip(fleet.engines, st0)]
        if launches == 0 or launches < sum(dec) * cfg.n_layers:
            raise AssertionError(f"{name}: paged_flash_decode launched "
                                 f"{launches} times for {sum(dec)} decode "
                                 "steps")
        lost = sum(c.status != "delivered" for q in rep.requests
                   for c in q.copies.values())
        log(f"  {name}: {len(rep.requests)} requests in {dt:.1f} s on the "
            f"host clock; paged_flash_decode launched {launches} times; per "
            f"replica decode steps {dec}, supersteps {sup}, prefill calls "
            f"{pre}; retries {sum(q.retries for q in rep.requests)}, copies "
            f"lost or dropped {lost}")
        log_quorum(rep.native, "native")
        for r, row in sorted(rep.sweep.items()):
            log_quorum(row, f"r={r}")
        results[name] = rep
    diff, checked, close, same = plain_greedy_check(params, cfg, ecfg,
                                                    results["e2e_steady"])
    log(f"  e2e_steady: delivered streams vs the plain form's greedy "
        f"argmax: equal at {same} of {checked} positions ({close} with a "
        f"top-2 margin within {LOGIT_TOL}); max |teacher-forced logit "
        f"diff| kernel vs plain {diff:.4f}")
    return {"paged_flash_decode": total}, fleet


# ---------------------------------------------------------------------------
# 11. the other model families at full width


# (arch, layers run): one whole period of jamba's pattern, deepseek-v2
# and arctic cut in depth to fit 80 GB with their serving state, rwkv6-3b
# and qwen2-vl-2b cut to a quarter of their depth to keep the script
# within its time limit (a layer of each runs the same code as the rest)
FAMILY_RUNS = (("jamba-v0.1-52b", 8), ("deepseek-v2-236b", 2),
               ("arctic-480b", 1), ("rwkv6-3b", 8), ("qwen2-vl-2b", 7))
FAMILY_CCFG = PagedCacheConfig(num_slots=4, page_size=16,
                               max_pages_per_seq=17, num_pages=4 * 17 + 1)
TWIN_ARCHS = ("arctic-480b", "deepseek-v2-236b", "jamba-v0.1-52b",
              "rwkv6-3b", "qwen2-vl-2b", "whisper-base")
# f32 on the card against f32 on the CPU: the same operations, reductions
# in another order (and the Mamba scan's f32 state carried over steps)
TWIN_TOL = dict(rtol=1e-4, atol=1e-4)
WHISPER_DECODE_STEPS = 16


def family_requests(cfg, n: int = 8, seed: int = 0):
    """Prompts of 16-256 tokens (never 2, never above 256: the Mamba
    scan's chunk rule), 8-16 new tokens each."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, int(rng.integers(16, 257)))
             .astype(np.int32), int(rng.integers(8, 17))) for _ in range(n)]


def gqa_layers(cfg) -> int:
    if cfg.attention != "gqa":
        return 0
    return cfg.layer_pattern.count("attn") * cfg.n_periods


def serve_family(name: str, depth: int):
    """One config at full width, ``depth`` layers, bf16 weights from seed
    0 made on the card: ``ServeEngine`` (4 slots, 16-token pages,
    superstep_k = 4) serves 8 requests; every budget met and every page
    back, streams equal to a superstep_k = 1 run's, the decode kernel
    launched exactly once per GQA layer and decode step (zero without
    GQA layers), and for GQA configs teacher-forced decode logits through
    the kernel within ``LOGIT_TOL`` of the plain form's. Returns the
    kernel's launches in the superstep_k = 4 run."""
    full = get_config(name)
    cfg = dataclasses.replace(full, n_layers=depth)
    t0 = time.perf_counter()
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    leaves = tree_flatten(params)[0]
    n_params = sum(t.numel() for t in leaves)
    if n_params != cfg.param_count():
        raise AssertionError(f"{name}: {n_params} parameters, want "
                             f"{cfg.param_count()}")
    gb = sum(t.numel() * t.element_size() for t in leaves) / 1e9
    cut = ("none" if depth == full.n_layers
           else f"n_layers {full.n_layers} -> {depth}")
    dtypes = "/".join(sorted({str(t.dtype)[6:] for t in leaves}))
    log(f"  {name}: {n_params:,} parameters ({gb:.2f} GB, {dtypes}) made on "
        f"the card in {load_s:.1f} s; reduced: {cut}")
    reqs = family_requests(cfg)
    dattn.reset_launches()
    eng, rids, out = run_engine(params, cfg, reqs, 4, FAMILY_CCFG)
    launches = dattn.LAUNCHES["paged_flash_decode"]
    st = eng.stats
    for rid, (_, budget) in zip(rids, reqs):
        toks = out[rid]
        if toks.shape != (budget,) or toks.min() < 0 or \
                toks.max() >= cfg.vocab_size:
            raise AssertionError(f"{name} request {rid}: {toks.shape} "
                                 f"tokens, budget {budget}")
    if eng.kv.alloc.n_used or not eng.kv.alloc.check_invariants():
        raise AssertionError(f"{name}: {eng.kv.alloc.n_used} pages used")
    want = gqa_layers(cfg) * st["decode_steps"]
    if launches != want:
        raise AssertionError(f"{name}: paged_flash_decode launched "
                             f"{launches} times, want {want}")
    decode_s = eng.step_s - eng.prefill_s
    decode_tokens = sum(len(t) - 1 for t in out.values())
    log(f"    8 requests, {sum(n for _, n in reqs)} tokens, superstep_k=4: "
        f"{st['decode_steps']} decode steps in {st['supersteps']} "
        f"supersteps, {st['prefill_calls']} prefill calls; decode "
        f"{decode_tokens / decode_s:.1f} tok/s, "
        f"{decode_s / st['decode_steps'] * 1e3:.2f} ms per decode step, "
        f"prefill {eng.prefill_s / st['prefill_calls'] * 1e3:.1f} ms per "
        f"call; paged_flash_decode launched {launches} times "
        f"({gqa_layers(cfg)} GQA layers x {st['decode_steps']} steps)")
    experts = [t for blk in params["blocks"] if "router" in blk["ffn"]
               for k, t in blk["ffn"].items()
               if k in ("w_gate", "w_up", "w_down")]
    if experts:
        nbytes = sum(t.numel() * t.element_size() for t in experts)
        mem_rate = card_peaks(torch.cuda.get_device_name(0))[0]
        log(f"    routed experts' weights {nbytes / 1e9:.2f} GB: drop-free "
            "capacity runs every expert, so each decode step reads them "
            f"all, at least {nbytes / mem_rate * 1e3:.2f} ms at "
            f"{mem_rate / 1e12:.2f} TB/s")
    ref, ref_rids, ref_out = run_engine(params, cfg, reqs, 1, FAMILY_CCFG)
    for a, b in zip(rids, ref_rids):
        if not np.array_equal(out[a], ref_out[b]):
            raise AssertionError(f"{name} request {a}: superstep_k=4 and 1 "
                                 "differ")
    log(f"    token streams identical to the superstep_k=1 run "
        f"({ref.stats['decode_steps']} decode steps)")
    if gqa_layers(cfg):
        steps = min(n for _, n in reqs)
        prompts = [p for p, _ in reqs[:FAMILY_CCFG.num_slots]]
        streams = np.stack([out[r][:steps]
                            for r in rids[:FAMILY_CCFG.num_slots]])
        lg = [teacher_forced_logits(params, eng.infer_cfg, prompts, streams,
                                    impl, FAMILY_CCFG).float()
              for impl in ("cuda", "plain")]
        diff = float((lg[0] - lg[1]).abs().max())
        log(f"    teacher-forced decode, {len(prompts)} slots x {steps} "
            f"steps: max |logit diff| kernel vs plain {diff:.4f} (logits up "
            f"to {float(lg[1].abs().max()):.2f}, tolerance {LOGIT_TOL})")
        if not torch.isfinite(lg[0]).all() or diff > LOGIT_TOL:
            raise AssertionError(f"{name}: teacher-forced logits, kernel "
                                 "and plain form disagree")
    # where a decode step's time goes: 4 slots of 128-token prompts
    prof_eng = ServeEngine(params, cfg, FAMILY_CCFG, superstep_k=4)
    rng = np.random.default_rng(3)
    for _ in range(FAMILY_CCFG.num_slots):
        prof_eng.submit(rng.integers(0, cfg.vocab_size, 128).astype(
            np.int32), 16)
    profile_decode(prof_eng, steps=2, top=4)
    del params, eng, ref, prof_eng
    torch.cuda.empty_cache()
    return launches


def dense_cache(cfg, prefill, batch, max_len, device):
    """A dense decode cache of ``max_len`` positions holding a prefill's
    cache: attention rows copied to the front, state and cross leaves
    whole."""
    cache = mmodel.init_cache(cfg, batch, max_len, device=device)
    for blk, pre in zip(cache, prefill):
        for part, leaves in blk.items():
            for leaf_name, leaf in leaves.items():
                src = pre[part][leaf_name]
                if part == "mixer" and leaf_name in ("k", "v", "ckv", "kr"):
                    leaf[:, :, :src.shape[2]] = src
                else:
                    leaf.copy_(src)
    return cache


@torch.no_grad()
def twin_logits(params, cfg, prompt, enc, steps, device, feed=None):
    """Prefill ``prompt`` (B, S) (with frame embeddings ``enc`` for an
    encoder-decoder), then ``steps`` dense-cache decode steps, each fed
    ``feed``'s next token, or the step's own argmax. Returns the prefill's
    logits, the (steps, B, vocab) decode logits and the tokens fed."""
    b, s = prompt.shape
    tok = torch.tensor(prompt, device=device)
    kw = {} if enc is None else {"enc_embed": torch.tensor(enc,
                                                           device=device)}
    logits, _, pre = apply_model(params, tok, cfg, mode="prefill", **kw)
    cache = dense_cache(cfg, pre, b, s + steps, device)
    nxt = logits[:, -1].argmax(-1)
    out, fed = [], []
    for i in range(steps):
        cur = (torch.tensor(feed[i], device=device) if feed is not None
               else nxt)
        fed.append(cur.cpu().numpy())
        lg, _, _ = apply_model(params, cur[:, None].int(), cfg,
                               mode="decode", cache=cache, cache_index=s + i)
        out.append(lg[:, 0])
        nxt = lg[:, 0].argmax(-1)
    return logits, torch.stack(out), np.stack(fed)


def whisper_card_vs_cpu():
    """whisper-base at full size in f32: a prefill over 1,500 random frame
    embeddings and an 8-token prompt, then 16 dense-cache decode steps
    fed the CPU's greedy tokens, on the card against the CPU."""
    cfg = dataclasses.replace(get_config("whisper-base"),
                              param_dtype="float32", compute_dtype="float32")
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    enc = rng.normal(size=(2, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    t0 = time.perf_counter()
    c_pre, c_dec, fed = twin_logits(params, cfg, prompt, enc,
                                    WHISPER_DECODE_STEPS, "cpu")
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    g_pre, g_dec, _ = twin_logits(mmodel.tree_to(params, "cuda"), cfg,
                                  prompt, enc, WHISPER_DECODE_STEPS, "cuda",
                                  feed=fed)
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    diff = max(float((g_pre.cpu() - c_pre).abs().max()),
               float((g_dec.cpu() - c_dec).abs().max()))
    log(f"  whisper-base (full, {cfg.param_count():,} parameters, f32): "
        f"prefill over {cfg.encoder_seq} frames + {WHISPER_DECODE_STEPS} "
        f"decode steps, card {gpu_s:.2f} s, CPU {cpu_s:.2f} s; max |logit "
        f"diff| card vs CPU {diff:.3e} (logits up to "
        f"{float(c_dec.abs().max()):.2f}, rtol = atol = 1e-4)")
    for a, b in ((g_pre, c_pre), (g_dec, c_dec)):
        torch.testing.assert_close(a.cpu(), b, **TWIN_TOL)


@torch.no_grad()
def family_twin(name: str):
    """The reduced config of ``name`` in f32 on the card and on the CPU:
    prefill and dense-decode logits within ``TWIN_TOL``; for a
    decoder-only arch, ``ServeEngine`` streams (4 slots, superstep_k = 4)
    identical wherever the CPU's top-2 margin exceeds the tolerance.
    Returns (max |logit diff|, stream positions checked, positions equal
    up to each stream's first divergence)."""
    cfg = get_config(name).reduced()
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    gparams = mmodel.tree_to(params, "cuda")
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    enc = (rng.normal(size=(2, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32) if cfg.encoder_decoder else None)
    c_pre, c_dec, fed = twin_logits(params, cfg, prompt, enc, 8, "cpu")
    g_pre, g_dec, _ = twin_logits(gparams, cfg, prompt, enc, 8, "cuda",
                                  feed=fed)
    for a, b in ((g_pre, c_pre), (g_dec, c_dec)):
        torch.testing.assert_close(a.cpu(), b, **TWIN_TOL)
    diff = max(float((g_pre.cpu() - c_pre).abs().max()),
               float((g_dec.cpu() - c_dec).abs().max()))
    if cfg.encoder_decoder:
        return diff, 0, 0
    reqs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(16, 65)))
             .astype(np.int32), int(rng.integers(8, 17))) for _ in range(8)]
    ccfg = PagedCacheConfig(num_slots=4, page_size=16, max_pages_per_seq=6,
                            num_pages=25)
    outs = []
    for p, dev in ((params, "cpu"), (gparams, "cuda")):
        eng = ServeEngine(p, cfg, ccfg, superstep_k=4, device=dev)
        rids = [eng.submit(q, n) for q, n in reqs]
        out = eng.run()
        outs.append([out[r] for r in rids])
    icfg = eng.infer_cfg
    checked = same = 0
    for (prompt_i, _), c_toks, g_toks in zip(reqs, *outs):
        checked += len(c_toks)
        if np.array_equal(c_toks, g_toks):
            same += len(c_toks)
            continue
        j = int(np.argmax(c_toks != g_toks))       # the first divergence
        same += j
        seq = np.concatenate([prompt_i, c_toks[:j]])[None]
        lg, _, _ = apply_model(params, torch.tensor(seq), icfg)
        top2 = lg[0, -1].float().topk(2).values
        if float(top2[0] - top2[1]) > TWIN_TOL["atol"]:
            raise AssertionError(f"{name}: card and CPU streams diverge at a "
                                 "clear top-2 margin")
    return diff, checked, same


def drive_families():
    """Phase 11: the five served configs at full width, whisper-base on
    the card against the CPU, and the reduced CPU twin of every new
    family. Returns the decode kernel's launches (the served configs'
    superstep_k = 4 runs)."""
    t_all = time.perf_counter()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    total = 0
    for name, depth in FAMILY_RUNS:
        cfg = get_config(name)
        if gqa_layers(cfg):
            plan = dattn.split_plan(FAMILY_CCFG.num_slots, cfg.n_kv_heads,
                                    FAMILY_CCFG.max_pages_per_seq,
                                    FAMILY_CCFG.page_size, n_sm)
            log(f"  {name}: decode kernel at G = "
                f"{cfg.n_heads // cfg.n_kv_heads} (H = {cfg.n_heads}, Hkv "
                f"= {cfg.n_kv_heads}, D = {cfg.resolved_head_dim}), split "
                f"plan {plan}")
        t0 = time.perf_counter()
        total += serve_family(name, depth)
        log(f"    {name} in {time.perf_counter() - t0:.1f} s")
    whisper_card_vs_cpu()
    for name in TWIN_ARCHS:
        diff, checked, same = family_twin(name)
        streams = (f"served streams equal at {same} of {checked} positions "
                   "(any divergence at a CPU top-2 margin within the "
                   "tolerance)" if checked else "not paged (encoder-decoder)")
        log(f"  CPU twin {name} (reduced, f32): max |logit diff| card vs "
            f"CPU {diff:.3e}; {streams}")
    log(f"  phase 11 in {time.perf_counter() - t_all:.1f} s; "
        f"paged_flash_decode launched {total} times")
    return {"paged_flash_decode": total}


# ---------------------------------------------------------------------------
# 12. the prefix cache at full width


SYSTEM_PROMPT = 256          # tokens: 16 full pages shared by 16 requests
PREFIX_CCFG_A = PagedCacheConfig(num_slots=8, page_size=16,
                                 max_pages_per_seq=24, num_pages=24 * 24 + 1)
# run B: room for the largest request and a few more, so cached pages
# must be reclaimed from the LRU while higher-priority requests preempt
PREFIX_CCFG_B = PagedCacheConfig(num_slots=8, page_size=16,
                                 max_pages_per_seq=24, num_pages=60)
PREFIX_TWIN_CCFG = PagedCacheConfig(num_slots=2, page_size=4,
                                    max_pages_per_seq=8, num_pages=24)
PREFIX_SLA_CCFG = PagedCacheConfig(num_slots=1, page_size=4,
                                   max_pages_per_seq=8, num_pages=12)


def prefix_requests(vocab: int, seed: int = 0):
    """24 requests, 16-32 new tokens each, in a seeded order: 16 share a
    256-token system prompt and add their own tails of 1-40 tokens
    (partial-block hits, new blocks), 4 carry one identical 200-token
    prompt (full hits, a COW fork each), 4 are cold unique prompts of
    64-128 tokens. Returns (prompt, budget, family) triples."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, SYSTEM_PROMPT)
    same = rng.integers(0, vocab, 200)
    reqs = [(np.concatenate([system, rng.integers(0, vocab, int(
        rng.integers(1, 41)))]), "shared") for _ in range(16)]
    reqs += [(same.copy(), "identical") for _ in range(4)]
    reqs += [(rng.integers(0, vocab, int(rng.integers(64, 129))), "cold")
             for _ in range(4)]
    order = rng.permutation(len(reqs))
    return [(reqs[i][0].astype(np.int32), int(rng.integers(16, 33)),
             reqs[i][1]) for i in order]


class PrefixTimedEngine(TimedEngine):
    """TimedEngine that with the prefix cache on also bills each
    admission (a cold prefill, or a shared hit's suffix feed; each ends
    in a host sync) to ``prefill_s``, and its suffix feeds to
    ``suffix_s`` as well; per request it gives the admission's time to
    the first token and its cached tokens (``admit_ms``), and it counts
    the pages that resumes re-shared from the index."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.reshared = 0

    @property
    def prefill_s(self) -> float:
        return self.host_s("serve.prefill", "serve.suffix")

    @property
    def suffix_s(self) -> float:
        return self.host_s("serve.suffix")

    @property
    def admit_ms(self):
        """rid -> (ms, cached tokens) of each prefix-cache admission: from
        its start, where its ``serve.queued`` span ends, to its first
        token (``ttft`` less the wait, both on the span clock): the whole
        ``_admit_prefix`` call, a cold prefill or a hit's plan, sharing
        and suffix feed; the cached tokens are the prompt less the
        suffix its ``serve.suffix`` span fed."""
        if self.kv.prefix is None:
            return {}
        fed = {s.rid: s.counts["tokens"] for s in self.spans
               if s.name == "serve.suffix"}
        out = {}
        for s in self.spans:
            if s.name != "serve.queued":
                continue
            st = self.sched.finished[s.rid]
            ms = st.ttft * 1e3 - (s.t1_ns - s.t0_ns) * 1e-6
            out[s.rid] = (ms, st.req.prompt_len - fed[s.rid]
                          if s.rid in fed else 0)
        return out

    def _resume(self, st):
        swap_in = self.kv.swap_in

        def counted(*args):
            m = swap_in(*args)
            self.reshared += m
            return m
        self.kv.swap_in = counted
        try:
            super()._resume(st)
        finally:
            del self.kv.swap_in


class SharedPageProbe:
    """After a step where one physical page sits in two active slots'
    tables, or a COW fork happened, holds the decode kernel against its
    plain form on the engine's own pools and tables, every layer, on a
    random query (at most ``limit`` times a run). Its launches are kept
    apart, so the main path's count can leave them out."""

    def __init__(self, limit: int = 4):
        self.limit, self.probes, self.shared = limit, 0, 0
        self.launches, self.forks, self.errs = 0, 0, []
        self.gen = torch.Generator(device="cuda").manual_seed(7)

    def __call__(self, eng):
        kv, ps = eng.kv, eng.kv.ccfg.page_size
        forked = eng.stats["cow_forks"] > self.forks
        self.forks = eng.stats["cow_forks"]
        rows = [kv.page_table[s, :-(-int(kv.kv_lens[s]) // ps)]
                for s in eng.sched.active]
        used = np.concatenate(rows) if rows else np.zeros(0, np.int32)
        shared = len(used) - len(np.unique(used))
        if self.probes >= self.limit or not (shared or forked):
            return
        self.probes += 1
        self.shared = max(self.shared, shared)
        self.launches += probe_decode(eng, self.gen, self.errs,
                                      "the engine's shared pages")


def probe_decode(eng, gen, errs, what) -> int:
    """Holds ``paged_flash_decode`` against its plain form on ``eng``'s
    own pools, page table and lengths, every layer, on a random query
    from ``gen``; returns the kernel's launches."""
    kv = eng.kv
    tbl = torch.tensor(kv.page_table, device="cuda")
    lens = torch.tensor(kv.kv_lens, device="cuda")
    before = dattn.LAUNCHES["paged_flash_decode"]
    for pos, blk in enumerate(kv.cache):
        kp, vp = blk["mixer"]["k_pages"], blk["mixer"]["v_pages"]
        q = torch.randn((kv.page_table.shape[0], eng.cfg.n_heads,
                         kp.shape[-1]), generator=gen,
                        device="cuda").to(kp.dtype)
        for p in range(kp.shape[0]):
            check(f"paged_flash_decode on {what}, layer {pos}.{p}",
                  dattn.paged_flash_decode(q, kp[p], vp[p], tbl, lens),
                  dattn.paged_decode_plain(q, kp[p], vp[p], tbl, lens),
                  DECODE_TOL[kp.dtype], errs)
    return dattn.LAUNCHES["paged_flash_decode"] - before


class StepProbe:
    """``probe_decode`` after the engine's steps in ``at`` (while its
    slots are active)."""

    def __init__(self, at=(2, 3)):
        self.at, self.steps, self.launches, self.errs = at, 0, 0, []
        self.gen = torch.Generator(device="cuda").manual_seed(7)

    def __call__(self, eng):
        self.steps += 1
        if self.steps in self.at:
            self.launches += probe_decode(
                eng, self.gen, self.errs,
                f"the engine's pools after step {self.steps}")


def checked_drain(eng, max_steps: int = 10_000, after_step=None):
    """``run()`` with the allocator's and the index's books checked after
    every step, and ``after_step(eng)`` called there."""
    steps = 0
    while not eng.sched.idle:
        eng.step()
        eng.kv.alloc.check_invariants()
        if eng.kv.prefix is not None:
            eng.kv.prefix.check_invariants()
        if after_step is not None:
            after_step(eng)
        steps += 1
        if steps > max_steps:
            raise AssertionError("serving loop did not drain")
    return {rid: np.asarray(st.generated, np.int32)
            for rid, st in eng.sched.finished.items()}


def serve_prefix(params, cfg, reqs, ccfg, prefix, policy="fifo",
                 split=None, probe=None):
    """Serve ``reqs`` on one engine (superstep_k = 8). With ``split``,
    the requests at those indices come first at priority 0, the rest two
    steps later at priority 1 (under ``sla`` they preempt). ``probe`` is
    called after every step. Returns the engine, the streams in request
    order and the decode kernel's launches over the run, its count zeroed
    just before, less the probe's."""
    eng = PrefixTimedEngine(params, cfg, ccfg, superstep_k=8,
                            prefix_cache=prefix, policy=policy,
                            device=params["embed"]["tok"].device)
    dattn.reset_launches()
    rids = {}
    with eng.timed():
        if split is None:
            for i, (p, n, _) in enumerate(reqs):
                rids[i] = eng.submit(p, n)
        else:
            for i in split:
                rids[i] = eng.submit(reqs[i][0], reqs[i][1], priority=0)
            eng.step()
            eng.step()
            for i in range(len(reqs)):
                if i not in rids:
                    rids[i] = eng.submit(reqs[i][0], reqs[i][1], priority=1)
        out = checked_drain(eng, after_step=probe)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    launches = dattn.LAUNCHES["paged_flash_decode"]
    if probe is not None:
        launches -= probe.launches
    return eng, [out[rids[i]] for i in range(len(reqs))], launches


def prefix_metrics(eng, reqs):
    """Host-clock figures of one run. Prefill time per call includes the
    prompt's page writes; with the cache on it is the mean cold
    admission. Decode time is step time less all admission time."""
    st = eng.stats
    ttft = np.asarray([s.ttft for s in eng.sched.finished.values()]) * 1e3
    cold = [ms for ms, c in eng.admit_ms.values() if not c]
    return dict(
        ttft_mean_ms=float(ttft.mean()), ttft_p50_ms=float(np.median(ttft)),
        prefill_calls=st["prefill_calls"],
        prefill_ms=(float(np.mean(cold)) if eng.kv.prefix is not None
                    else eng.prefill_s / st["prefill_calls"] * 1e3),
        hit_tokens=st["cache_hit_tokens"], miss_tokens=st["cache_miss_tokens"],
        suffix_steps=st["suffix_steps"],
        suffix_step_ms=(eng.suffix_s / st["suffix_steps"] * 1e3
                        if st["suffix_steps"] else float("nan")),
        decode_steps=st["decode_steps"],
        decode_tok_s=(sum(n - 1 for _, n, _ in reqs)
                      / (eng.step_s - eng.prefill_s)),
        cow_forks=st["cow_forks"], evictions=st["prefix_evictions"],
        preemptions=st["preemptions"], resumed=st["resumed"])


def log_prefix(label, m):
    log(f"    {label}: TTFT mean {m['ttft_mean_ms']:.1f} ms p50 "
        f"{m['ttft_p50_ms']:.1f} ms; {m['prefill_calls']} prefill calls, "
        f"{m['prefill_ms']:.2f} ms each; hit {m['hit_tokens']} / miss "
        f"{m['miss_tokens']} tokens; {m['suffix_steps']} suffix steps, "
        f"{m['suffix_step_ms']:.2f} ms each; decode {m['decode_tok_s']:.1f} "
        f"tok/s over {m['decode_steps']} steps; COW forks {m['cow_forks']}, "
        f"evictions {m['evictions']}, preemptions {m['preemptions']}, "
        f"resumed {m['resumed']}")


def serve_sla_twin(params, cfg, prefix):
    """The f32 twin's small-pool ``sla`` run, one slot and 12 pages of 4
    tokens: three 8-token prompts are served and retire (their blocks
    stay in the LRU), a 9-token prompt starts, and two steps later a
    priority-2 prompt on its first block preempts it. The pool makes the
    LRU evict, and the resume re-shares the long prompt's resident
    blocks. Returns the engine and the streams."""
    rng = np.random.default_rng(5)
    v = cfg.vocab_size
    p_long = rng.integers(0, v, 9).astype(np.int32)
    p_hot = np.concatenate([p_long[:4], rng.integers(0, v, 2)
                            ]).astype(np.int32)
    warm = [rng.integers(0, v, 8).astype(np.int32) for _ in range(3)]
    eng = PrefixTimedEngine(params, cfg, PREFIX_SLA_CCFG, superstep_k=1,
                            prefix_cache=prefix, policy="sla",
                            device=params["embed"]["tok"].device)
    rids = [eng.submit(p, 4, priority=0) for p in warm]
    checked_drain(eng)
    rids.append(eng.submit(p_long, 12, priority=0))
    eng.step()
    eng.step()
    rids.append(eng.submit(p_hot, 3, priority=2, deadline=2.0))
    out = checked_drain(eng)
    return eng, [out[r] for r in rids]


def prefix_twin(dev_params, cpu_params, cfg):
    """Reduced qwen2-0.5b in f32, on ``tests/test_serve_prefix.py``'s mix
    and on the small-pool ``sla`` run: the card's streams with the cache
    on equal its streams with it off and the CPU's with it on, exactly,
    and the card's and the CPU's stats (and re-shared pages) match.
    Returns the card's stats of both runs and its re-shared pages."""
    rng = np.random.default_rng(3)
    p0 = rng.integers(0, cfg.vocab_size, 9).astype(np.int32)
    p2 = np.concatenate([p0[:8], rng.integers(0, cfg.vocab_size, 3)
                         ]).astype(np.int32)
    p3 = rng.integers(0, cfg.vocab_size, 7).astype(np.int32)
    reqs = [(p, n, "") for p, n in zip([p0, p0.copy(), p2, p3], [4, 3, 5, 4])]
    runs = {}
    for label, params, prefix in (("card on", dev_params, "on"),
                                  ("card off", dev_params, "off"),
                                  ("cpu on", cpu_params, "on")):
        eng, out, _ = serve_prefix(params, cfg, reqs, PREFIX_TWIN_CCFG,
                                   prefix)
        sla, sla_out = serve_sla_twin(params, cfg, prefix)
        runs[label] = ((eng.stats, sla.stats, sla.reshared),
                       out + sla_out)
    for label in ("card off", "cpu on"):
        for a, b in zip(runs["card on"][1], runs[label][1]):
            if not np.array_equal(a, b):
                raise AssertionError(f"reduced f32 twin: card on and {label} "
                                     "streams differ")
    if runs["card on"][0] != runs["cpu on"][0]:
        raise AssertionError("reduced f32 twin: card and CPU stats differ")
    st, sla, reshared = runs["card on"][0]
    if (sla["prefix_evictions"] < 1 or sla["preemptions"] < 1
            or sla["resumed"] < 1 or reshared < 1):
        raise AssertionError(f"reduced f32 twin, sla run: {sla}, "
                             f"{reshared} pages re-shared")
    return st, sla, reshared


def drive_prefix(params, cfg):
    """Phase 12: the prefix cache on qwen2-0.5b at full width (phase 6's
    bf16 weights), 8 slots, 16-token pages, superstep_k = 8. Returns the
    decode kernel's launches over the cached runs and the metrics of run
    A with the cache on and off."""
    reqs = prefix_requests(cfg.vocab_size)
    prompts = [p for p, _, _ in reqs]
    fams = {f: sum(1 for *_, g in reqs if g == f)
            for f in ("shared", "identical", "cold")}
    log(f"  24 requests ({fams['shared']} on a {SYSTEM_PROMPT}-token system "
        f"prompt with tails of 1-40, {fams['identical']} identical "
        f"200-token prompts, {fams['cold']} cold of 64-128), "
        f"{sum(n for _, n, _ in reqs)} new tokens; run A pool "
        f"{PREFIX_CCFG_A.num_pages} pages, run B {PREFIX_CCFG_B.num_pages}")
    total = 0
    serve_prefix(params, cfg, reqs[:2], PREFIX_CCFG_A, "on")    # warm-up
    probe_a = SharedPageProbe()
    eng_on, on, launches = serve_prefix(params, cfg, reqs, PREFIX_CCFG_A,
                                        "on", probe=probe_a)
    total += launches
    st = eng_on.stats
    iters = st["decode_steps"] + st["suffix_steps"]
    if launches != cfg.n_layers * iters:
        raise AssertionError(f"run A: paged_flash_decode launched {launches} "
                             f"times, want {cfg.n_layers} x {iters}")
    if eng_on.kv.alloc.n_used != eng_on.kv.prefix.n_indexed:
        raise AssertionError("run A: used pages other than the indexed ones")
    if (st["cache_hit_tokens"] < 15 * SYSTEM_PROMPT or st["cow_forks"] < 1
            or st["suffix_steps"] <= 0 or st["prefix_evictions"]):
        raise AssertionError(f"run A: cache counters {st}")
    eng_off, off, launches_off = serve_prefix(params, cfg, reqs,
                                              PREFIX_CCFG_A, "off")
    if launches_off != cfg.n_layers * eng_off.stats["decode_steps"]:
        raise AssertionError("run A off: decode launches do not match")
    for what, streams in (("run A on", on), ("run A off", off)):
        for (_, n, _), g in zip(reqs, streams):
            if g.shape != (n,):
                raise AssertionError(f"{what}: {g.shape} tokens, budget {n}")
    # on and off both the plain argmax at every clear margin: where they
    # part, the margin is within LOGIT_TOL
    g_on = greedy_check(params, cfg, 16, prompts, on)
    g_off = greedy_check(params, cfg, 16, prompts, off)
    div = sum(not np.array_equal(a, b) for a, b in zip(on, off))
    log(f"  run A: paged_flash_decode launched {launches} times = "
        f"{cfg.n_layers} layers x ({st['decode_steps']} decode + "
        f"{st['suffix_steps']} suffix steps); books checked after every "
        f"step; {eng_on.kv.alloc.n_used} pages left, all indexed")
    log_greedy("run A, cache on ", g_on)
    log_greedy("run A, cache off", g_off)
    log(f"    {div} of {len(reqs)} cache-on streams differ from the "
        f"cache-off run's, each first where the top-2 margin is within "
        f"{LOGIT_TOL}")
    m_on, m_off = prefix_metrics(eng_on, reqs), prefix_metrics(eng_off, reqs)
    log_prefix("cache on ", m_on)
    log_prefix("cache off", m_off)
    hits = [ms for ms, c in eng_on.admit_ms.values() if c]
    cold = [ms for ms, c in eng_on.admit_ms.values() if not c]
    tails = [len(p) - SYSTEM_PROMPT for p, _, g in reqs if g == "shared"]
    m_on["hit_admit_ms"] = float(np.mean(hits))
    m_on["cold_admit_ms"] = float(np.mean(cold))
    m_on["break_even_tokens"] = m_on["cold_admit_ms"] / m_on["suffix_step_ms"]
    log(f"    admission to first token, cache on: {len(hits)} hits "
        f"{m_on['hit_admit_ms']:.1f} ms mean (suffixes of 1 token and of "
        f"{min(tails)}-{max(tails)}), {len(cold)} cold single prefills "
        f"{m_on['cold_admit_ms']:.1f} ms mean: a suffix longer than "
        f"{m_on['break_even_tokens']:.1f} tokens costs more than a cold "
        "prefill")

    lo = [i for i in range(len(reqs)) if i % 2 == 0]
    probe_b = SharedPageProbe()
    eng_b, out_b, launches_b = serve_prefix(params, cfg, reqs, PREFIX_CCFG_B,
                                            "on", policy="sla", split=lo,
                                            probe=probe_b)
    total += launches_b
    sb = eng_b.stats
    if (sb["prefix_evictions"] < 1 or sb["preemptions"] < 1
            or sb["resumed"] < 1):
        raise AssertionError(f"run B: cache counters {sb}")
    if launches_b != cfg.n_layers * (sb["decode_steps"] + sb["suffix_steps"]):
        raise AssertionError("run B: decode launches do not match")
    if eng_b.kv.alloc.n_used != eng_b.kv.prefix.n_indexed:
        raise AssertionError("run B: used pages other than the indexed ones")
    eng_b.reset_prefix_cache()
    if eng_b.kv.alloc.n_used:
        raise AssertionError(f"run B: {eng_b.kv.alloc.n_used} pages kept")
    for (_, n, _), g in zip(reqs, out_b):
        if g.shape != (n,):
            raise AssertionError(f"run B: {g.shape} tokens, budget {n}")
    g_b = greedy_check(params, cfg, 16, prompts, out_b)
    div_b = sum(not np.array_equal(a, b) for a, b in zip(out_b, off))
    log(f"  run B (sla, priorities 0 then 1): {sb['prefix_evictions']} "
        f"evictions, {sb['preemptions']} preemptions, {sb['resumed']} "
        f"resumed, {sb['swapped_pages']} pages swapped, {eng_b.reshared} "
        f"re-shared on resume; every page back after reset_prefix_cache; "
        f"{div_b} streams differ from run A off's")
    log_greedy("run B", g_b)
    for label, pr in (("run A", probe_a), ("run B", probe_b)):
        if not pr.shared:
            raise AssertionError(f"{label}: no step with a page in two "
                                 "slots' tables was probed")
        log(f"    {label}: decode kernel vs plain form on the engine's own "
            f"pools and tables after {pr.probes} steps (at most "
            f"{pr.shared} table entries on a page another slot holds), "
            f"{cfg.n_layers} layers each: "
            f"max_abs_err {max(pr.errs):.3e} (bf16 rtol/atol 2e-2)")
    log_prefix("run B    ", prefix_metrics(eng_b, reqs))

    tcfg = get_config(SERVE_ARCH).reduced()
    cpu_params = init_model(torch.Generator().manual_seed(0), tcfg,
                            device="cpu", max_pos=64)
    tst, sla, reshared = prefix_twin(mmodel.tree_to(cpu_params, "cuda"),
                                     cpu_params, tcfg)
    log(f"  reduced {SERVE_ARCH} f32: streams with the cache on equal the "
        f"cache-off run's and the CPU's exactly; stats equal the CPU's "
        f"(hit {tst['cache_hit_tokens']}, suffix steps "
        f"{tst['suffix_steps']}, COW forks {tst['cow_forks']}); small-pool "
        f"sla run: {sla['prefix_evictions']} evictions, "
        f"{sla['preemptions']} preemption, {sla['resumed']} resumed with "
        f"{reshared} pages re-shared, equal to the CPU's")
    return {"paged_flash_decode": total}, m_on, m_off


def log_greedy(label, g):
    diff, checked, close, same = g
    log(f"    {label}: streams vs the plain form's greedy argmax, teacher "
        f"forced: equal at {same} of {checked} positions ({close} with a "
        f"top-2 margin within {LOGIT_TOL}); max |logit diff| kernel vs "
        f"plain {diff:.4f}")


# ---------------------------------------------------------------------------
# 13. fleet control and checkpoint rejoin on real engines


FLEET_REQUESTS = 16          # the reference's smoke size for fleet replays
# crash_cascade's crashes start at 100, 140 and 180 of virtual time, when
# no request is in flight; moved to 3.0, 14.5 and 29.8 each lands on a
# request in flight on that replica, and the windows end early enough
# that the restarted replicas serve the later arrivals
INFLIGHT_CRASHES = ((0, 3.0, 60.0), (1, 14.5, 70.0), (2, 29.8, 80.0))


def engine_rejoin(eng):
    """A drained engine's snapshot through the Checkpointer into
    ``restart(image)``: rid counter monotone, one request's stream the
    same after as before; a busy engine's snapshot refused."""
    import tempfile
    prompt = np.random.default_rng(51).integers(
        0, eng.cfg.vocab_size, 24).astype(np.int32)
    rid0 = eng.submit(prompt, 8)
    before = eng.run()[rid0]
    image = eng.snapshot()
    with tempfile.TemporaryDirectory(prefix="rejoin_") as d:
        ck = Checkpointer(d, keep=1)
        t0 = time.perf_counter()
        ck.save(image, step=0, blocking=True)
        loaded, _ = ck.restore_flat()
        ck_s = time.perf_counter() - t0
    mb = sum(v.nbytes for v in loaded.values()) / 1e6
    t0 = time.perf_counter()
    eng.restart(loaded)
    torch.cuda.synchronize()
    restart_s = time.perf_counter() - t0
    rid1 = eng.submit(prompt, 8)
    if rid1 <= rid0:
        raise AssertionError("rid counter went back across the restart")
    try:
        eng.snapshot()
    except SnapshotInFlightError as e:
        refused = (e.n_active, e.n_waiting)
    else:
        raise AssertionError("snapshot of a busy engine was not refused")
    after = eng.run()[rid1]
    if not np.array_equal(before, after):
        raise AssertionError("the stream changed across the restart")
    return mb, ck_s, restart_s, refused


def fleet_replay(params, fleet, sc):
    """``run_fleet_e2e`` of ``sc`` cut to 16 requests on the warm fleet,
    the decode kernel's count zeroed just before and read just after:
    zero violations, nothing lost, every death rejoined after probation,
    delivered streams the plain form's greedy argmax where the margin
    allows. Returns the launches, the report and the wall seconds."""
    dattn.reset_launches()
    t0 = time.perf_counter()
    rep = run_fleet_e2e(sc, fleet, n_requests=FLEET_REQUESTS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dattn.LAUNCHES["paged_flash_decode"]
    m = rep.metrics
    if rep.violations:
        raise AssertionError(f"{sc.name}: {summarize(rep.violations)}")
    if m.permanently_lost or m.restarts < 1 or m.deaths < 1:
        raise AssertionError(f"{sc.name}: {m.as_dict()}")
    if m.rejoins != m.deaths:
        raise AssertionError(f"{sc.name}: {m.deaths} deaths but "
                             f"{m.rejoins} rejoins after probation")
    if launches == 0:
        raise AssertionError(f"paged_flash_decode was not launched in "
                             f"{sc.name}")
    if not fleet.drained():
        raise AssertionError(f"fleet not drained after {sc.name}")
    lost = sum(c.status == LOST for q in rep.requests
               for c in q.copies.values())
    log(f"  {sc.name}, {len(rep.requests)} requests through the fleet "
        f"controller in {wall:.1f} s on the host clock; paged_flash_decode "
        f"launched {launches} times; copies lost to crashes {lost}")
    log(f"    deaths {m.deaths}, rejoins {m.rejoins}, restarts {m.restarts}, "
        f"transitions {m.transitions}; hedges {m.hedges}, retries "
        f"{m.retries}, shed {m.shed}, permanently lost "
        f"{m.permanently_lost}; recovery {m.recovery_time_mean:.3f} mean / "
        f"{m.recovery_time_max:.3f} max, rejoin lag {m.rejoin_lag_mean:.3f} "
        f"(virtual time); success rate {m.sr_pre:.3f} pre-fault, "
        f"{m.sr_post:.3f} post-rejoin; goodput {m.goodput_pre:.4f} / "
        f"{m.goodput_post:.4f} per unit")
    log_quorum(rep.native, "native")
    for r, row in sorted(rep.sweep.items()):
        log_quorum(row, f"r={r}")
    diff, checked, close, same = plain_greedy_check(
        params, fleet.engines[0].cfg, fleet.ecfg, rep)
    log(f"    delivered streams vs the plain form's greedy argmax: equal at "
        f"{same} of {checked} positions ({close} with a top-2 margin within "
        f"{LOGIT_TOL}); max |teacher-forced logit diff| kernel vs plain "
        f"{diff:.4f}")
    return launches, rep, wall, lost


def drive_fleet(params, fleet):
    """Phase 13: the engine-level rejoin on phase 10's warm fleet, then
    ``run_fleet_e2e`` of ``crash_cascade`` cut to 16 requests, and of the
    same scenario with its crashes on requests in flight, where the
    controller must fail copies over and a restarted replica must serve
    again. Returns the decode kernel's launches over the replays."""
    if not fleet.drained():
        raise AssertionError("fleet not drained before phase 13")
    mb, ck_s, restart_s, refused = engine_rejoin(fleet.engines[0])
    log(f"  engine 0: a {mb:.1f} MB snapshot through the Checkpointer in "
        f"{ck_s:.2f} s, restart(image) in {restart_s * 1e3:.1f} ms; rid "
        f"counter monotone, the stream after the restart equals the one "
        f"before; a busy engine's snapshot refused ({refused[0]} active, "
        f"{refused[1]} waiting)")
    sc = get_scenario("crash_cascade")
    launches, rep, wall, _ = fleet_replay(params, fleet, sc)
    sc = dataclasses.replace(
        sc, name="crash_cascade_inflight", faults=dataclasses.replace(
            sc.faults, crashes=tuple(CrashWindow(*c)
                                     for c in INFLIGHT_CRASHES)))
    more, rep2, wall2, lost = fleet_replay(params, fleet, sc)
    m = rep2.metrics
    if not lost or m.hedges + m.retries == 0 or not np.isfinite(m.sr_post):
        raise AssertionError(f"{sc.name}: no failover ({lost} copies lost, "
                             f"{m.as_dict()})")
    # the controller ranks replicas by latency, so a restarted one need
    # not be picked again; one at least must serve from its image
    served = sorted({j for j, _, end in INFLIGHT_CRASHES
                     for q in rep2.requests for c in q.delivered()
                     if c.replica == j and c.t_first > end})
    if not served:
        raise AssertionError(f"{sc.name}: no restarted replica served")
    log(f"    restarted replicas {served} delivered copies after their "
        "restarts")
    return {"paged_flash_decode": launches + more}, m, wall + wall2


# ---------------------------------------------------------------------------
# 14. wall-clock chaos on real engines


WALLCLOCK_N = 4
WALLCLOCK_STUB_WORK = 0.3    # StubReplica work_time at scale 1
# the run's horizon, in timescales (kill_rejoin's own is 160): its 40
# arrivals end at 20, and a run of 12 arrivals took 17
WALLCLOCK_T_MAX = 40.0


class CheckedReplica(EngineReplica):
    """EngineReplica that keeps the traceback of every exception of its
    engine other than a kill. The fleet counts such an exception as a
    crash and restarts the replica, so without this record a fault of
    the kernel or the cache would pass for one more crash and rejoin."""

    def __init__(self, *args):
        super().__init__(*args)
        self.errors = []

    def process(self, request, should_abort):
        try:
            return super().process(request, should_abort)
        except ReplicaKilled:
            raise
        except Exception:
            self.errors.append(traceback.format_exc())
            raise


def drive_wallclock(fleet):
    """Phase 14: 4 of the fleet's engines as ``EngineReplica``s under
    ``RealClock``, through ``kill_rejoin`` with its own 40 requests, so
    that arrivals go on past the replicas' rejoins and ``recovered``
    (``sr_post / sr_pre``, answered shares before the fault and after
    the last rejoin) reads a number. Outcomes only, never timings; the
    horizon is cut to ``WALLCLOCK_T_MAX`` timescales.

    The timescale comes from one measured request, as the reference's
    wall-clock benchmark sets it, but from the request as a dispatch
    serves it: on n - r = 3 replicas at once, each on its own thread.
    One process drives every engine, and its host work serializes on the
    interpreter lock, so 3 replicas at once take far longer than one
    alone; a lone request's time would put heartbeats and deadlines
    below the fleet's real service time. The detector's prior
    (``init_interval``) scales with the heartbeat, as at scale 1."""
    replicas = [CheckedReplica(e, fleet.ecfg.max_new_tokens)
                for e in fleet.engines[:WALLCLOCK_N]]
    req = np.arange(1, 9, dtype=np.int32)
    for rep in replicas:
        rep.process(req, lambda: False)
    t0 = time.perf_counter()
    for rep in replicas:
        rep.process(req, lambda: False)
    lat = (time.perf_counter() - t0) / len(replicas)
    threads = [threading.Thread(target=rep.process, args=(req, lambda: False))
               for rep in replicas[:3]]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    lat3 = time.perf_counter() - t0
    scale = max(lat3, 1e-3) / WALLCLOCK_STUB_WORK
    log(f"  one request {lat * 1e3:.1f} ms on one replica, {lat3 * 1e3:.1f} "
        f"ms on 3 at once (host clock): timescale {scale:.3f}")
    plan = dataclasses.replace(PLANS["kill_rejoin"](WALLCLOCK_N, scale=scale),
                               t_max=WALLCLOCK_T_MAX * scale)
    cfg = FleetConfig(n_replicas=WALLCLOCK_N, r=1, seed=0,
                      heartbeat_period=2.0 * scale, init_interval=2.0 * scale)
    dattn.reset_launches()
    t0 = time.perf_counter()
    rep = run_realtime_chaos(plan, cfg, clock=RealClock(), replicas=replicas)
    wall = time.perf_counter() - t0
    launches = dattn.LAUNCHES["paged_flash_decode"]
    d = rep.as_dict()
    log(f"  kill_rejoin, {plan.n_requests} requests, in {wall:.1f} s "
        f"(heartbeat {cfg.heartbeat_period:.3f} s); paged_flash_decode "
        f"launched {launches} times")
    log(f"    {json.dumps(d)}")
    log("    transitions " + ", ".join(
        f"{t:.3f} replica {j} {a} -> {b}" for t, j, a, b in rep.transition_log))
    log("    latencies " + " ".join(f"{x:.3f}" for x in rep.latencies))
    faulted = {ev.replica for ev in plan.events}
    false_deaths = [(t, j) for t, j, _, b in rep.transition_log
                    if b == "dead" and j not in faulted]
    rejoins = [t for t, _, a, b in rep.transition_log
               if a == "recovering" and b == "healthy"]
    last_arrival = (plan.n_requests - 1 + 0.26) * plan.arrival_period
    past = last_arrival - max(rejoins, default=float("nan"))
    log(f"    recovered {rep.recovered:.4f} (sr_pre {rep.sr_pre:.4f}, sr_post "
        f"{rep.sr_post:.4f}); arrivals go on {past:.1f} s past the last "
        f"rejoin ({past / wall:.1%} of the {wall:.1f} s run); deaths of "
        f"replicas no fault killed: {len(false_deaths)} "
        + " ".join(f"(replica {j} at {t:.1f} s)" for t, j in false_deaths))
    if rep.lost or rep.violations or not rep.drained:
        raise AssertionError(f"wall-clock kill_rejoin: {d}")
    for j in {ev.replica for ev in plan.events}:
        seen = [(a, b) for _, r, a, b in rep.transition_log if r == j]
        if not any(b == "dead" for _, b in seen) or \
                ("recovering", "healthy") not in seen:
            raise AssertionError(f"wall-clock kill_rejoin: the kill of "
                                 f"replica {j} was not detected or it did "
                                 f"not rejoin: {d}")
    errors = [e for r in replicas for e in r.errors]
    if errors:
        raise AssertionError(f"wall-clock kill_rejoin: {len(errors)} "
                             f"exceptions in the replicas' engines, the "
                             f"first:\n{errors[0]}")
    kills = sum(ev.kind == "kill" for ev in plan.events)
    if rep.deaths < 1 or rep.rejoins < 1 or rep.restarts != kills:
        raise AssertionError(f"wall-clock kill_rejoin: {rep.restarts} "
                             f"restarts for {kills} kills: {d}")
    if launches == 0:
        raise AssertionError("paged_flash_decode was not launched in the "
                             "wall-clock run")
    if not all(e.sched.idle for e in fleet.engines[:WALLCLOCK_N]):
        raise AssertionError("an engine replica was left busy")
    return {"paged_flash_decode": launches}, d, wall


# ---------------------------------------------------------------------------
# 15. the SPMD layer: training, the sharded server, the general step and
#     tensor-parallel decode on torch.distributed


# 15a: examples/train_lm.py's defaults at qwen2-0.5b's full width
TRAIN_AGENTS, TRAIN_R, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 2, 8, 64, 3e-3
TRAIN_STEPS, TRAIN_MORE, TRAIN_CKPT_EVERY = 10, 5, 10
# the f32 reduced twins, card against CPU: the same operations, sums in
# another order, over a few steps
TWIN_TOL = dict(rtol=1e-4, atol=1e-4)
# 15b-15c: ranks sharing the one card over gloo, and a time limit each;
# the host's cores split between them (torch's own threads per process
# would oversubscribe them many times over)
SPMD_RANKS, SPMD_TIMEOUT = 4, 600
CORES = max(len(os.sched_getaffinity(0)), SPMD_RANKS)
# 15b runs 5 iterations of each run (10 before phase 23 needed the time)
SHARDED_ITERS = 5
COMBINES = ("gather", "partial")
GENERAL_MODES = ("cge", "stale", "trimmed", "quantized")
GENERAL_LAYERS, GENERAL_STEPS = 2, 2
# 15d: phase 6's workload cut to 8 requests, over 2 ranks
TP_RANKS, TP_REQUESTS = 2, 8
# phase 4's iterates (device backend) after 1, 5 and 10 iterations of
# each run, keyed (label, iterations): 15b's gather combine must reproduce them
# bit for bit. The partial combine sums in another order: one step of it
# is held to 1e-5 * max(|x|, 1) of the device step on the same inputs
# (after the first iteration, and on the ledger and iterate of the last).
# Over the run, LeNet's gradients at the slightly different iterates
# carry the difference on, so the end of the run is held per rule in
# ||x - x_device|| / ||x_device||, at about ten times the drift measured
# on the H100 (mean 1.03e-06, cge 4.89e-06); quantized (2.29e-04, where
# int8 rounding can flip a step) at phase 4's host-comparison 1e-3;
# trimmed_mean has no partial form and gathers, so it stays bit-identical
MAIN_PATH_X: dict = {}
PARTIAL_TOL = 1e-5
RUN_REL = {"mean": 1e-5, "cge": 5e-5, "trimmed_mean": 0.0, "quantized": 1e-3}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def card_flags() -> None:
    """The numerics every phase runs under: full f32 matmuls and
    convolutions, deterministic cuDNN algorithms (ranks set them too)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def param_checksum(tree) -> int:
    """An integer digest of a tree's bits: each leaf's bit patterns as
    integers, weighted by position, summed exactly in int64."""
    total, chunk = 0, 1 << 24
    for leaf in tree_flatten(tree)[0]:
        bits = leaf.detach().contiguous().view(
            torch.int16 if leaf.element_size() == 2 else torch.int32
        ).reshape(-1)
        for c0 in range(0, bits.numel(), chunk):
            part = bits[c0:c0 + chunk].long()
            w = torch.arange(c0, c0 + part.numel(),
                             device=bits.device) % 65521 + 1
            total += int((part * w).sum())
    return total


def lm_batch(tokens, targets, weights, device, cfg=None):
    """A train batch on ``device``, with ``frames`` for an
    encoder-decoder ``cfg``."""
    out = {k: torch.from_numpy(np.asarray(v)).to(device)
           for k, v in (("tokens", tokens), ("targets", targets),
                        ("weights", weights))}
    return with_frames(out, cfg, device)


def frames(cfg, rows: int, device):
    """Frame embeddings (rows, encoder_seq, d_model) in the compute dtype,
    drawn from seed 0 (shapes only on the meta device)."""
    shape = (rows, cfg.encoder_seq, cfg.d_model)
    dt = mlayers.torch_dtype(cfg.compute_dtype)
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dt, device=META)
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dt)


def with_frames(batch: dict, cfg, device) -> dict:
    """``batch`` with ``enc_embed`` (``frames`` for its rows) where ``cfg``
    is an encoder-decoder; as it is otherwise."""
    if cfg is None or not cfg.encoder_decoder:
        return batch
    return {**batch, "enc_embed": frames(cfg, len(batch["tokens"]),
                                         device)}


def train_twin(device):
    """3 masked steps of reduced qwen2-0.5b in f32 (SGD with momentum)
    from CPU-drawn weights: (losses, grad norms, parameter leaves)."""
    cfg = get_config(SERVE_ARCH).reduced()
    tc = TrainConfig(mode="masked", optimizer="sgdm", lr=3e-2,
                     remat_policy="none")
    state = init_state(torch.Generator().manual_seed(0), cfg, tc,
                       max_pos=33, n_agents=4, device="cpu")
    state = {k: mmodel.tree_to(v, device) if k != "step" else v
             for k, v in state.items()}
    step = make_train_step(cfg, tc, moe_groups=4)
    data = lm_batches(markov_tokens(5_000, vocab=cfg.vocab_size, seed=0),
                      8, 32, seed=1)
    oracle = StragglerOracle(4, 1, seed=2)
    out = []
    for _ in range(3):
        x, y = next(data)
        mask, _, _ = oracle.next_mask()
        state, m = step(state, lm_batch(x, y, mask_to_weights(mask, 8, 32),
                                        device))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out, [l.cpu().numpy() for l in tree_flatten(state["params"])[0]]


def drive_train(device="cuda"):
    """15a: ``TrainLoop`` at full width with a checkpoint every 10 steps,
    restored by a second loop; the step alone, timed and profiled; the
    f32 twin, card against CPU."""
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config(SERVE_ARCH)
    total = TRAIN_STEPS + TRAIN_MORE
    tc = TrainConfig(mode="masked", lr=TRAIN_LR, lr_kind="cosine",
                     lr_total=total, warmup=total // 20,
                     remat_policy="none")
    tokens = markov_tokens(200_000, vocab=cfg.vocab_size, seed=0)

    def new_loop(ckdir):
        return TrainLoop(cfg, tc, lm_batches(tokens, TRAIN_BATCH, TRAIN_SEQ,
                                             seed=1),
                         n_agents=TRAIN_AGENTS, r=TRAIN_R,
                         oracle=StragglerOracle(TRAIN_AGENTS, TRAIN_R,
                                                seed=2),
                         ckpt_dir=ckdir, ckpt_every=TRAIN_CKPT_EVERY,
                         max_pos=TRAIN_SEQ + 1, device=device)

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckdir:
        t0 = time.perf_counter()
        loop = new_loop(ckdir)
        p_leaves = tree_flatten(loop.state["params"])[0]
        m_leaves = tree_flatten(loop.state["opt"])[0]
        if {l.dtype for l in p_leaves} != {torch.bfloat16} or \
                {l.dtype for l in m_leaves} != {torch.float32}:
            raise AssertionError("want bf16 parameters, f32 AdamW moments")
        n_params = sum(l.numel() for l in p_leaves)
        del p_leaves, m_leaves
        hist = loop.run(TRAIN_STEPS)
        sync(device)
        run_s = time.perf_counter() - t0
        loss = np.asarray(hist.loss)
        first, last = loss[:5].mean(), loss[-5:].mean()
        log(f"  {SERVE_ARCH}: {n_params:,} parameters (bf16, f32 AdamW "
            f"moments), {TRAIN_AGENTS} agents, r = {TRAIN_R}, batch "
            f"{TRAIN_BATCH} x {TRAIN_SEQ}: {TRAIN_STEPS} steps and "
            f"{-(-TRAIN_STEPS // TRAIN_CKPT_EVERY)} checkpoint saves in "
            f"{run_s:.1f} s; loss {first:.4f} -> {last:.4f} (mean of the "
            f"first and last 5); comm_saving {hist.comm_saving:.4f}")
        if not (np.isfinite(loss).all() and last < first):
            raise AssertionError(f"training loss did not fall: {loss}")
        digest = param_checksum(loop.state["params"])
        del loop
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        loop = new_loop(ckdir)
        restore_s = time.perf_counter() - t0
        if int(loop.state["step"]) != TRAIN_STEPS or \
                param_checksum(loop.state["params"]) != digest:
            raise AssertionError(f"restored step {int(loop.state['step'])}, "
                                 "or parameters differ from the saved ones")
        loop.run(TRAIN_MORE)
        if int(loop.state["step"]) != total or \
                not np.isfinite(loop.hist.loss).all():
            raise AssertionError(f"resumed loop at step "
                                 f"{int(loop.state['step'])}")
        log(f"  a new TrainLoop restored step {TRAIN_STEPS} in {restore_s:.1f}"
            f" s (parameters bit-identical) and took {TRAIN_MORE} more, loss "
            f"{np.mean(loop.hist.loss):.4f}")

    # the step alone, past the loop's checkpoints: 3 timed, 2 profiled
    x, y = next(loop.data_iter)
    mask, _, _ = loop.oracle.next_mask()
    batch = lm_batch(x, y, mask_to_weights(mask, TRAIN_BATCH, TRAIN_SEQ),
                     device)
    state = loop.state
    sync(device)
    t0 = time.perf_counter()
    for _ in range(3):
        state, m = loop.step_fn(state, batch)
        float(m["loss"])
    ms = (time.perf_counter() - t0) / 3 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            state, m = loop.step_fn(state, batch)
            float(m["loss"])
        wall = (time.perf_counter() - t0) * 1e6
    busy = busy_us(device_spans(prof))
    log(f"  train step alone: {ms:.1f} ms on the host clock; two profiled "
        f"steps {wall / 2e3:.1f} ms each, device busy {busy / 2e3:.1f} ms "
        f"(idle share {1 - busy / wall:.3f})")
    del loop, state, batch
    torch.cuda.empty_cache()

    card, card_p = train_twin(device)
    cpu, cpu_p = train_twin("cpu")
    np.testing.assert_allclose(card, cpu, **TWIN_TOL)
    err = max(float(np.max(np.abs(a - b))) for a, b in zip(card_p, cpu_p))
    for a, b in zip(card_p, cpu_p):
        np.testing.assert_allclose(a, b, **TWIN_TOL)
    log(f"  f32 reduced twin, 3 steps: losses {[round(l, 5) for l, _ in card]}"
        f", card vs CPU max |param diff| {err:.2e}")


def sharded_server(mesh, runs, combines, kernels_checked=()):
    """15b on one rank: phase 4's LeNet ``runs`` (n = 20, P = 431,080) on
    ``agg_backend="sharded"``, each of ``combines`` in turn. Returns
    {(label, combine): (x, seconds)}, the launches of the runs, and the
    errors of the ``kernels_checked`` ((kernel, combine) pairs) against
    their plain forms on this rank's inputs."""
    dev = mesh.device
    train, _ = mnist_like(n_train=4000, n_test=512, seed=0)
    sets = partition(train, N_AGENTS, overlap=2, seed=0)
    grad_fn, flat0, _ = lenet.make_agent_grad_fn(sets, 32, device=dev)
    flat0 = flat0.cpu().numpy()
    grad_fn(0, flat0, None)                  # cuDNN/cuBLAS set-up, untimed
    out, errs, step_err = {}, {}, 0.0
    agg.reset_launches()
    for label, kernel, overrides in runs:
        for combine in combines:
            grad_fn, _, _ = lenet.make_agent_grad_fn(sets, 32, device=dev,
                                                     flat0=flat0)
            cfg = EngineConfig(n_agents=N_AGENTS, step_size=lambda t: 0.05,
                               proj_gamma=1e6, seed=0, agg_backend="sharded",
                               ledger_combine=combine, device=str(dev),
                               **overrides)
            eng = AsyncEngine(grad_fn, flat0, cfg,
                              latency=default_latency(N_AGENTS, 3, 10.0,
                                                      seed=0), mesh=mesh)
            sync(dev)
            t0 = time.perf_counter()
            eng.run(1)
            x_1 = eng.x.copy()
            eng.run(SHARDED_ITERS - 1)
            sync(dev)
            out[(label, combine)] = (x_1, eng.x.copy(),
                                     time.perf_counter() - t0)
            if combine == "partial":
                counts = dict(agg.LAUNCHES)
                step_err = max(step_err, partial_step_err(eng))
                agg.LAUNCHES.update(counts)    # the checks do not count
            if kernel is not None and (kernel, combine) in kernels_checked:
                counts = dict(agg.LAUNCHES)
                errs[kernel] = check_shard_kernel(kernel, eng, combine)
                agg.LAUNCHES.update(counts)    # the checks do not count
    return out, dict(agg.LAUNCHES), errs, step_err


def partial_step_err(eng):
    """One partial step against one gather step (the device step's bits)
    on the engine's last iterate and ledger, every agent but every
    fourth received: max |difference| over max(|x|, 1)."""
    cfg, led = eng.cfg, eng._dev
    rx = torch.as_tensor(np.arange(N_AGENTS) % 4 != 0, device=led.device)
    x = eng._dev_x
    steps = [make_sharded_aggregate_apply(cfg.rule, cfg.f, cfg.proj_gamma,
                                          led.mesh, led.axes, N_AGENTS, c)
             for c in ("gather", "partial")]
    a, b = (step(x, led.data, rx, 0.05) for step in steps)
    err = float((a - b).abs().max()) / max(float(a.abs().max()), 1.0)
    if err > PARTIAL_TOL:
        raise AssertionError(f"{cfg.rule}: one partial step differs from "
                             f"the device step by {err:.2e}")
    return err


def check_shard_kernel(kernel, eng, combine):
    """One call of ``kernel`` against its plain form on this rank's
    inputs: the rebuilt ledger (gather) or this rank's quantized row
    block (partial)."""
    led = eng._dev
    rx = torch.as_tensor(np.arange(N_AGENTS) % 4 != 0, device=led.device)
    if combine == "partial":
        q, scale = gradagg.quantize_int8_parts(led.data)
        r = rx[led.row0:led.row0 + led.n_loc]
        out = agg.dequant_accum(q, scale[:, 0], r)
        ref = agg.dequant_dot(q, scale[:, 0], r)
    else:
        g = collectives.ledger_all_rows(led.data, led.axes, N_AGENTS,
                                        mesh=led.mesh)
        if kernel == "masked_cge_reduce":
            out, ref = agg.masked_cge_reduce(g, rx, 1), agg.masked_cge_dot(
                g, rx, 1)
        else:
            out = agg.trimmed_mean_tiled(g, rx, 1)
            ref = agg.trimmed_mean_running(g, rx, 1)
    sync(led.device)
    err = float((out - ref).abs().max())
    torch.testing.assert_close(out, ref, **KERNEL_TOL)
    return err


def general_step(mesh, twin: bool):
    """15c on one rank: ``make_general_step`` for each mode, 2 steps with
    one agent masked per step, on qwen2-0.5b's widths cut to 2 layers in
    bf16 (AdamW), or (``twin``) reduced qwen2-0.5b in f32 (SGD with
    momentum) from CPU-drawn weights. Returns {mode: (losses, seconds per
    step, the parameter checksum, agreed by all ranks)}, and the twin's
    parameter leaves."""
    dev = mesh.device
    if twin:
        cfg = dataclasses.replace(get_config(SERVE_ARCH).reduced(),
                                  n_layers=GENERAL_LAYERS)
    else:
        cfg = dataclasses.replace(get_config(SERVE_ARCH),
                                  n_layers=GENERAL_LAYERS)
    data = lm_batches(markov_tokens(50_000, vocab=cfg.vocab_size, seed=0),
                      TRAIN_BATCH, TRAIN_SEQ, seed=1)
    batches = [next(data) for _ in range(GENERAL_STEPS)]
    out, leaves = {}, {}
    for mode in GENERAL_MODES:
        tc = TrainConfig(mode=mode, lr=TRAIN_LR, f=1, tau=2,
                         remat_policy="none",
                         optimizer="sgdm" if twin else "adamw")
        gen = (torch.Generator() if twin
               else torch.Generator(device=dev)).manual_seed(0)
        state = init_state(gen, cfg, tc, max_pos=TRAIN_SEQ + 1,
                           n_agents=SPMD_RANKS, device="cpu" if twin else dev,
                           mesh=mesh)
        if twin:
            state = {k: mmodel.tree_to(v, dev) if k != "step" else v
                     for k, v in state.items()}
        step = make_general_step(cfg, tc, mesh)
        losses, secs = [], []
        for t, (x, y) in enumerate(batches):
            mask = np.ones(SPMD_RANKS, np.float32)
            mask[t % SPMD_RANKS] = 0.0
            sync(dev)
            t0 = time.perf_counter()
            state, m = step(state, lm_batch(
                x, y, np.ones((TRAIN_BATCH, TRAIN_SEQ), np.float32), dev),
                mask)
            losses.append(float(m["loss"]))
            secs.append(time.perf_counter() - t0)
        digest = param_checksum(state["params"])
        lo = torch.tensor([digest], dtype=torch.int64, device=dev)
        hi = lo.clone()
        torch.distributed.all_reduce(lo, op=torch.distributed.ReduceOp.MIN)
        torch.distributed.all_reduce(hi, op=torch.distributed.ReduceOp.MAX)
        if int(lo) != int(hi) or not np.isfinite(losses).all():
            raise AssertionError(f"general step {mode}: parameters differ "
                                 f"across ranks or loss {losses}")
        out[mode] = (losses, secs, digest)
        if twin:
            leaves[mode] = [l.cpu().numpy()
                            for l in tree_flatten(state["params"])[0]]
        del state, step
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out, leaves


def spmd_card_rank(rank, world, device="cuda"):
    """A rank of 15b and 15c on the card (gloo, 4 ranks, mesh data = 4):
    the sharded server, the general step at full width, its f32 twin."""
    card_flags()
    mesh = make_test_mesh(data=world, model=1, device=device)
    checked = {("masked_cge_reduce", "gather"),
               ("trimmed_mean_tiled", "gather"), ("dequant_accum", "partial")}
    server, counts, errs, step_err = sharded_server(mesh, RUNS, COMBINES,
                                                    checked)
    general, _ = general_step(mesh, twin=False)
    twin, twin_leaves = general_step(mesh, twin=True)
    return dict(server=server, counts=counts, errs=errs, step_err=step_err,
                general=general, twin=twin, twin_leaves=twin_leaves)


def spmd_cpu_rank(rank, world):
    """A rank of 15c's f32 twin on the CPU (gloo, 4 ranks)."""
    mesh = make_test_mesh(data=world, model=1, device="cpu")
    return general_step(mesh, twin=True)


def one_rank_group(device, backend):
    """15b's cge gather run in this process, as the one rank of a
    process group of ``backend`` (NCCL on the card)."""
    import torch.distributed as dist
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=SPMD_TIMEOUT))
        try:
            mesh = make_test_mesh(data=1, model=1, device=device)
            server, counts, _, _ = sharded_server(mesh, [RUNS[1]],
                                                  ("gather",))
        finally:
            dist.destroy_process_group()
    return server, counts


def drive_spmd_server_and_step(device="cuda", nccl="nccl"):
    """15b-15c from the parent: spawn the ranks, hold their results."""
    t0 = time.perf_counter()
    res = run_ranks(spmd_card_rank, SPMD_RANKS, backend="gloo",
                    device=device, timeout=SPMD_TIMEOUT, args=(device,),
                    threads=CORES // SPMD_RANKS)
    log(f"  {SPMD_RANKS} gloo ranks on the card, mesh data = {SPMD_RANKS}: "
        f"{time.perf_counter() - t0:.1f} s with start-up")
    # 15b
    for label, kernel, over in RUNS:
        row = []
        for combine in COMBINES:
            runs = [r["server"][(label, combine)] for r in res]
            secs = max(secs for _, _, secs in runs)
            for it, k in ((1, 0), (SHARDED_ITERS, 1)):
                xs = [run[k] for run in runs]
                want = MAIN_PATH_X[label, it]
                if not all(np.array_equal(x, xs[0]) for x in xs):
                    raise AssertionError(f"{label} {combine}: ranks "
                                         "disagree")
                err = float(np.max(np.abs(xs[0] - want)))
                scale = max(float(np.max(np.abs(want))), 1.0)
                if combine == "gather" and err != 0.0:
                    raise AssertionError(f"{label} gather: not bit-identical"
                                         f" to the device backend ({err})")
                rel = float(np.linalg.norm(xs[0] - want)
                            / np.linalg.norm(want))
                if it > 1:
                    ok = rel <= RUN_REL[over["rule"]]
                else:
                    ok = err <= PARTIAL_TOL * scale
                if not ok:
                    raise AssertionError(f"{label} {combine} after {it} "
                                         f"iterations: |x - x_device| {err}")
            row.append(f"{combine} {secs / SHARDED_ITERS * 1e3:.1f} ms/iter "
                       f"(max |x - x_device| {err:.1e}, "
                       f"||x - x_device|| / ||x_device|| {rel:.2e})")
        log(f"    {label:30s} " + ", ".join(row))
    counts = {k: sum(r["counts"][k] for r in res) for k in agg.LAUNCHES}
    errs = {k: max(r["errs"][k] for r in res) for k in res[0]["errs"]}
    log(f"  sharded server: every rank's x bit-identical, gather "
        f"bit-identical to phase 4's device backend, one partial step "
        f"within {PARTIAL_TOL} * max(|x|, 1) of the device step (after "
        f"iteration 1 and on iteration {SHARDED_ITERS}'s inputs, max "
        f"{max(r['step_err'] for r in res):.1e}), after {SHARDED_ITERS} "
        f"within {RUN_REL} of ||x||; launches per rank "
        f"{[r['counts'] for r in res]}; kernels vs plain on each rank's "
        f"inputs, max |err| {errs}")
    for k in ("masked_cge_reduce", "trimmed_mean_tiled", "dequant_accum"):
        if any(r["counts"][k] == 0 for r in res):
            raise AssertionError(f"{k} was not launched on every rank")
    t0 = time.perf_counter()
    one = one_rank_group(device, nccl)
    (label, _), (_, x, secs) = next(iter(one[0].items()))
    if not np.array_equal(x, MAIN_PATH_X[label, SHARDED_ITERS]):
        raise AssertionError("one-rank NCCL gather: not bit-identical to the "
                             "device backend")
    for k, c in one[1].items():
        counts[k] += c
    log(f"  {label} gather on a one-rank NCCL group: bit-identical to the "
        f"device backend, {secs / SHARDED_ITERS * 1e3:.1f} ms/iter "
        f"({time.perf_counter() - t0:.1f} s with start-up)")
    # 15c
    for mode in GENERAL_MODES:
        losses, secs, digest = res[0]["general"][mode]
        if any(r["general"][mode][2] != digest for r in res):
            raise AssertionError(f"general step {mode}: checksums differ")
        log(f"    general step {mode:9s} losses "
            f"{', '.join(f'{l:.4f}' for l in losses)}, "
            f"{', '.join(f'{s:.2f}' for s in secs)} s per step, parameters "
            "identical on every rank")
    cpu = run_ranks(spmd_cpu_rank, SPMD_RANKS, backend="gloo", device="cpu",
                    timeout=SPMD_TIMEOUT, threads=CORES // SPMD_RANKS)
    err = 0.0
    for mode in GENERAL_MODES:
        np.testing.assert_allclose(res[0]["twin"][mode][0],
                                   cpu[0][0][mode][0], **TWIN_TOL)
        for a, b in zip(res[0]["twin_leaves"][mode], cpu[0][1][mode]):
            np.testing.assert_allclose(a, b, **TWIN_TOL)
            err = max(err, float(np.max(np.abs(a - b))))
    log(f"  general step f32 reduced twin, 4 card ranks vs 4 CPU ranks: max "
        f"|param diff| {err:.2e}")
    return counts, errs


class TPDecodeProbe:
    """15d, on every rank: after steps ``at`` of a tensor-parallel
    engine's run, holds ``tp_paged_decode`` on the engine's own pools
    (this rank's KV-head block), page table and lengths, every layer, on
    a random query the same on every rank, against the plain form and,
    bit for bit, the unsharded kernel, both on the whole pools (the
    ranks' blocks put together by an all-reduce of ``-0.0`` pads). Its
    launches are kept apart, so the main path's count can leave them
    out."""

    def __init__(self, at=(2, 4)):
        self.at, self.steps, self.probes = at, 0, 0
        self.launches, self.errs, self.gen = 0, [], None

    def __call__(self, eng):
        self.steps += 1
        if self.steps not in self.at:
            return
        kv, mesh, axes, dev = eng.kv, eng.mesh, eng.rules.tp_axes, eng.device
        if kv.kv_block is None:
            raise AssertionError("the TP engine's pools hold every KV head")
        h0, h1 = kv.kv_block
        self.probes += 1
        if self.gen is None:
            self.gen = torch.Generator(device=dev).manual_seed(7)
        tbl = torch.tensor(kv.page_table, device=dev)
        lens = torch.tensor(kv.kv_lens, device=dev)
        before = dattn.LAUNCHES["paged_flash_decode"]
        for pos, blk in enumerate(kv.cache):
            kp, vp = blk["mixer"]["k_pages"], blk["mixer"]["v_pages"]
            q = torch.randn((kv.page_table.shape[0], eng.cfg.n_heads,
                             kp.shape[-1]), generator=self.gen,
                            device=dev).to(kp.dtype)
            for p in range(kp.shape[0]):
                whole = []
                for pool in (kp[p], vp[p]):
                    full = torch.full(pool.shape[:2] + (eng.cfg.n_kv_heads,)
                                      + pool.shape[3:], -0.0,
                                      dtype=pool.dtype, device=pool.device)
                    full[:, :, h0:h1] = pool
                    whole.append(mesh.all_reduce(full, axes))
                out = dattn.tp_paged_decode(
                    q, kp[p], vp[p], tbl, lens, mesh=mesh,
                    kv_block=kv.kv_block, n_kv_heads=eng.cfg.n_kv_heads,
                    tp_axes=axes)
                name = (f"tp_paged_decode on the engine's pools, layer "
                        f"{pos}.{p}, step {self.steps}")
                check(name, out, dattn.paged_decode_plain(q, *whole, tbl,
                                                          lens),
                      DECODE_TOL[kp.dtype], self.errs)
                if not torch.equal(out, dattn.paged_flash_decode(
                        q, *whole, tbl, lens)):
                    raise AssertionError(f"{name}: not bit-identical to the "
                                         "unsharded kernel")
        sync(dev)
        self.launches += dattn.LAUNCHES["paged_flash_decode"] - before


def tp_engine_run(params, cfg, reqs, mesh=None, ccfg=SERVE_CCFG, k=8,
                  device="cuda", probe=None):
    eng = TimedEngine(params, cfg, ccfg, superstep_k=k, mesh=mesh,
                      device=device)
    with eng.timed():
        rids = [eng.submit(p, n) for p, n in reqs]
        out = (eng.run() if probe is None
               else checked_drain(eng, after_step=probe))
    sync(eng.device)
    ms = (eng.step_s - eng.prefill_s) / max(eng.stats["decode_steps"], 1) * 1e3
    return [out[r] for r in rids], dict(eng.stats), ms, eng.infer_cfg


def mla_twin_setup(device="cuda"):
    cfg = get_config("deepseek-v2-236b").reduced()
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu",
                        max_pos=512)
    rng = np.random.default_rng(4)
    reqs = [(rng.integers(0, cfg.vocab_size, int(s)).astype(np.int32), 12)
            for s in (5, 17, 33, 9)]
    ccfg = PagedCacheConfig(num_slots=4, page_size=8, max_pages_per_seq=8,
                            num_pages=4 * 8 + 1)
    return cfg, mmodel.tree_to(params, device), reqs, ccfg


def tp_rank(rank, world, reqs, device="cuda"):
    """A rank of 15d (gloo, 2 ranks, mesh data = 1, model = 2)."""
    card_flags()
    mesh = make_test_mesh(data=1, model=world, device=device)
    cfg = get_config(SERVE_ARCH)
    params = init_model(torch.Generator(device=device).manual_seed(0), cfg,
                        device=device)
    tp_engine_run(params, cfg, serve_requests(cfg, n=2, seed=1), mesh,
                  device=device)
    dattn.reset_launches()
    probe = TPDecodeProbe()
    streams, stats, ms, _ = tp_engine_run(params, cfg, reqs, mesh,
                                          device=device, probe=probe)
    launches = dattn.LAUNCHES["paged_flash_decode"] - probe.launches
    del params
    mcfg, mparams, mreqs, mccfg = mla_twin_setup(device)
    mla, mla_stats, _, _ = tp_engine_run(mparams, mcfg, mreqs, mesh, mccfg,
                                         device=device)
    return (streams, stats, ms, launches, mla, mla_stats,
            (probe.probes, max(probe.errs, default=0.0), probe.launches))


def drive_tp_decode(device="cuda"):
    """15d from the parent: the one-rank engine, then the ranks."""
    cfg = get_config(SERVE_ARCH)
    reqs = serve_requests(cfg)[:TP_REQUESTS]
    params = init_model(torch.Generator(device=device).manual_seed(0), cfg,
                        device=device)
    tp_engine_run(params, cfg, serve_requests(cfg, n=2, seed=1),
                  device=device)                              # warm-up
    one, one_stats, one_ms, _ = tp_engine_run(params, cfg, reqs,
                                              device=device)
    del params
    mcfg, mparams, mreqs, mccfg = mla_twin_setup(device)
    mla_one, mla_one_stats, _, mla_infer = tp_engine_run(
        mparams, mcfg, mreqs, ccfg=mccfg, device=device)
    t0 = time.perf_counter()
    res = run_ranks(tp_rank, TP_RANKS, backend="gloo", device=device,
                    timeout=SPMD_TIMEOUT, args=(reqs, device),
                    threads=CORES // TP_RANKS)
    log(f"  {TP_RANKS} gloo ranks on the card, mesh data = 1, model = "
        f"{TP_RANKS}: {time.perf_counter() - t0:.1f} s with start-up")
    launches = 0
    for r, (streams, stats, ms, n, mla, mla_stats, pr) in enumerate(res):
        if pr[0] != 2:
            raise AssertionError(f"rank {r}: {pr[0]} probes of the TP decode"
                                 " on the engine's pools, want 2")
        if stats != one_stats or not all(
                np.array_equal(a, b) for a, b in zip(streams, one)):
            raise AssertionError(f"rank {r}: TP streams or stats differ from "
                                 "the one-rank engine's")
        if n != cfg.n_layers * stats["decode_steps"]:
            raise AssertionError(f"rank {r}: paged_flash_decode launched {n}"
                                 f" times for {stats['decode_steps']} decode "
                                 "steps")
        if mla_stats != mla_one_stats:
            raise AssertionError(f"rank {r}: MLA stats differ")
        launches += n
    log(f"  {SERVE_ARCH} at full width, {cfg.n_heads} query heads and "
        f"{cfg.n_kv_heads} KV heads over {TP_RANKS} ranks: {TP_REQUESTS} "
        f"requests, {one_stats['decode_steps']} decode steps; streams and "
        f"stats identical to the one-rank engine's; paged_flash_decode "
        f"{res[0][3]} launches per rank (= {cfg.n_layers} x decode steps); "
        f"{np.mean([r[2] for r in res]):.2f} ms per decode step (one rank "
        f"alone {one_ms:.2f})")
    log(f"    tp_paged_decode on each rank's own pools, table and lengths "
        f"after steps 2 and 4, {cfg.n_layers} layers each, "
        f"{cfg.n_heads // TP_RANKS} query heads over its "
        f"{cfg.n_kv_heads // TP_RANKS} KV head: bit-identical to the "
        f"unsharded kernel on the whole pools, max_abs_err vs the plain form "
        f"{max(r[6][1] for r in res):.3e} (bf16 rtol/atol 2e-2); "
        f"{res[0][6][2]} probe launches per rank, left out of the count")
    same = all(np.array_equal(a, b) for a, b in zip(res[0][4], mla_one))
    # the engine's model: MoE drop-free, as it serves
    diff, checked, close, agree = greedy_check(
        mparams, mla_infer, mccfg.page_size, [p for p, _ in mreqs], res[0][4])
    log(f"  reduced deepseek-v2 (MLA, f32) at tp = {TP_RANKS}: streams "
        f"{'identical to' if same else 'differ from'} the one-rank engine's; "
        f"the plain greedy argmax at {agree} of {checked} positions ({close} "
        f"within the {LOGIT_TOL} margin)")
    return launches


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# 16. the placed (FSDP) masked step, the launch serving steps and the
#     example twins


# 16a: 15a's configuration on 4 ranks (data = 4), one agent a rank, 2 of
# the 4 masked a step. Two references on the same batches from the same
# weights (bf16 parameters, f32 AdamW). The mirror (``mirror_step``)
# follows the placed step's arithmetic, each agent's bf16 gradient alone
# and the four summed in f32, so the placed step must equal it bit for
# bit after every step (the H100 gave bit-identity at all 3). The
# one-process ``make_train_step`` rounds one bf16 gradient of the whole
# batch instead: on the H100 that moved 2.3% of the parameters after one
# step and ||p - p_one|| / ||p_one - p0|| stayed within 0.0709 over the
# 3 steps. PLACED_UPDATE_REL is about three times that: an unchanged
# state reads 1 and a sign-flipped update 2
PLACED_STEPS, PLACED_AGENTS, PLACED_MASKED = 3, 4, 2
# 16d: one more step, at accum_steps = 2, from 16a's and 16b's state
PLACED_ACCUM = 2
SPMD_LAYERS = 4                     # of qwen2-0.5b's 24 (spmd_cfg)
PLACED_UPDATE_REL = 0.2
PLACED_METRIC_TOL = dict(rtol=1e-6, atol=0.0)   # loss and grad norm sums
# the meta-device report against memory_allocated's growth over the
# placement: the allocator rounds each block up to 512 bytes
PLACED_BYTES_REL = 0.01
# 16e: the Byzantine example's device backend against its host backend,
# as tests/test_torch_examples.py holds them on the CPU (f32 rules that
# reduce in another order over 2,000 rounds)
EXAMPLE_DIST_TOL = dict(rtol=1e-3, atol=1e-6)
# 16c: greedy_generate at full width
GREEDY_PROMPTS, GREEDY_PROMPT_LEN, GREEDY_NEW, GREEDY_PAGE = 4, 64, 32, 16


def spmd_cfg():
    """qwen2-0.5b at full width cut to ``SPMD_LAYERS`` layers: the model
    of 16a, 17b, 18 and 19 (gloo's host copies of the wire bytes, which
    grow with depth, set those phases' times)."""
    return dataclasses.replace(get_config(SERVE_ARCH), n_layers=SPMD_LAYERS)


def placed_tc(remat: str) -> TrainConfig:
    """15a's training configuration (lr 3e-3 cosine, AdamW)."""
    total = TRAIN_STEPS + TRAIN_MORE
    return TrainConfig(mode="masked", lr=TRAIN_LR, lr_kind="cosine",
                       lr_total=total, warmup=total // 20,
                       remat_policy=remat)


def placed_batches(vocab: int, steps: int = PLACED_STEPS):
    """16a's batches: 15a's data, 2 of 4 agents masked per step (16d's
    is the one after 16a's)."""
    data = lm_batches(markov_tokens(200_000, vocab=vocab, seed=0),
                      TRAIN_BATCH, TRAIN_SEQ, seed=1)
    oracle = StragglerOracle(PLACED_AGENTS, PLACED_MASKED, seed=2)
    out = []
    for _ in range(steps):
        x, y = next(data)
        mask, _, _ = oracle.next_mask()
        out.append((x, y, mask_to_weights(mask, TRAIN_BATCH, TRAIN_SEQ)))
    return out


def mirror_step(cfg, tc, accum: int = 1):
    """16a's second reference: the placed step's arithmetic in one
    process. Each agent's block of the batch alone through the loss over
    the global weight sum, its gradient in the parameters' dtype (bf16),
    the blocks' gradients summed in f32 and rounded to that dtype, as the
    placed step's dp all-reduce sums its ranks'; then
    ``make_train_step``'s clipping, AdamW and update. With ``accum`` > 1
    (16d) that for each microbatch (the batch's rows in ``accum`` slices,
    each rank a block of a slice, over the slice's weight sum), the
    microbatches' rounded gradients summed in f32, divided by ``accum``
    and rounded."""
    opt = make_optimizer(tc)

    def loss_fn(params, batch, denom):
        logits, aux, _ = apply_model(params, batch["tokens"], cfg,
                                     mode="train", remat_policy="none")
        return lm_loss(logits, batch["targets"], batch["weights"], aux,
                       aux_coef=tc.aux_coef, denom=denom)

    def rank_sum(params, batch):
        per = batch["tokens"].shape[0] // PLACED_AGENTS
        denom = torch.clamp(batch["weights"].to(torch.float32).sum(),
                            min=1.0)
        loss, total = 0.0, None
        for a in range(PLACED_AGENTS):
            blk = {k: v[a * per:(a + 1) * per] for k, v in batch.items()}
            l, g = value_and_grad(lambda p, b: loss_fn(p, b, denom),
                                  params, blk)
            g = tree_map(lambda t: t.to(torch.float32), g)
            total = g if total is None else tree_map(torch.add, total, g)
            loss += float(l)
        return loss, tree_map(lambda t, p: t.to(p.dtype), total, params)

    def step(state, batch):
        params = state["params"]
        if accum == 1:
            loss, grads = rank_sum(params, batch)
        else:
            rows = batch["tokens"].shape[0] // accum
            loss, acc = 0.0, tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            for i in range(accum):
                l, g = rank_sum(params, {k: v[i * rows:(i + 1) * rows]
                                         for k, v in batch.items()})
                acc = tree_map(lambda a, t: a + t.to(torch.float32), acc, g)
                loss += l / accum
            grads = tree_map(lambda a, p: (a / accum).to(p.dtype), acc,
                             params)
        grads, gnorm = clip_by_global_norm(grads, tc.clip_norm)
        s = int(state["step"])
        updates, new_opt = opt.update(grads, state["opt"], params, s)
        return ({"params": apply_updates(params, updates, lr_at(tc, s)),
                 "opt": new_opt, "step": state["step"] + 1},
                {"loss": loss, "grad_norm": gnorm})

    return step


def placed_reference(tmp, device="cuda"):
    """16a's references from the same generator's weights and on the same
    batches: ``make_train_step`` in one process (15a's step) and the
    mirror of the placed step's arithmetic. The initial parameters and
    each reference's after every step are saved under ``tmp``. Returns
    {name: (losses, grad norms, seconds per step)}, 16d's step last, at
    ``accum_steps = PLACED_ACCUM``."""
    cfg = spmd_cfg()
    tc = placed_tc("none")
    tc_accum = dataclasses.replace(tc, accum_steps=PLACED_ACCUM)
    makers = {"one": lambda t: make_train_step(cfg, t,
                                               moe_groups=PLACED_AGENTS),
              "mirror": lambda t: mirror_step(cfg, t, t.accum_steps)}
    out = {}
    for name, make in makers.items():
        state = init_state(torch.Generator(device=device).manual_seed(0),
                           cfg, tc, max_pos=TRAIN_SEQ + 1, device=device)
        if name == "one":
            torch.save(mmodel.tree_to(state["params"], "cpu"),
                       os.path.join(tmp, "p0.pt"))
        steps = (make(tc), make(tc_accum))
        losses, norms, secs = [], [], []
        for i, (x, y, w) in enumerate(placed_batches(cfg.vocab_size,
                                                     PLACED_STEPS + 1)):
            step = steps[i == PLACED_STEPS]
            sync(device)
            t0 = time.perf_counter()
            state, m = step(state, lm_batch(x, y, w, device))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            secs.append(time.perf_counter() - t0)
            torch.save(mmodel.tree_to(state["params"], "cpu"),
                       os.path.join(tmp, f"{name}{i}.pt"))
        out[name] = (losses, norms, secs)
        del state, step, steps
        torch.cuda.empty_cache()
    return out


def tree_gap(tree, ref, p0, device):
    """(max |tree - ref|, the share of elements bit-identical,
    ||tree - ref|| / ||ref - p0||: the gap against ``ref``'s update from
    ``p0``), in f64."""
    mx, eq, n, d2, u2 = 0.0, 0, 0, 0.0, 0.0
    for a, b, p in zip(tree_flatten(tree)[0], tree_flatten(ref)[0],
                       tree_flatten(p0)[0]):
        a, b, p = a.to(device), b.to(device), p.to(device)
        d = a.double() - b.double()
        mx = max(mx, float(d.abs().max()))
        eq += int((a == b).sum())
        n += a.numel()
        d2 += float(torch.square(d).sum())
        u2 += float(torch.square(b.double() - p.double()).sum())
        del d
    return mx, eq / n, (d2 / u2) ** 0.5


def agreed(mesh, tree) -> bool:
    """Whether ``tree``'s bits are the same on every rank (an all-reduced
    checksum's minimum and maximum)."""
    lo = torch.tensor([param_checksum(tree)], dtype=torch.int64,
                      device=mesh.device)
    hi = lo.clone()
    torch.distributed.all_reduce(lo, op=torch.distributed.ReduceOp.MIN)
    torch.distributed.all_reduce(hi, op=torch.distributed.ReduceOp.MAX)
    return int(lo) == int(hi)


def placed_full_width(mesh, ref_dir):
    """16a on one rank: the whole state drawn from one generator, placed
    (memory_allocated before and after), 3 placed steps with remat, the
    gathered parameters checked across ranks and (rank 0) against the
    one-process step's."""
    dev = mesh.device
    cfg = spmd_cfg()
    tc = placed_tc("full")
    full = init_state(torch.Generator(device=dev).manual_seed(0), cfg, tc,
                      max_pos=TRAIN_SEQ + 1, device=dev)
    whole = sum(l.numel() * l.element_size() for k in ("params", "opt")
                for l in tree_flatten(full[k])[0])
    before = torch.cuda.memory_allocated(dev)
    state, specs = place_state(full, mesh)
    placed = torch.cuda.memory_allocated(dev) - before
    del full
    torch.cuda.empty_cache()
    report = state_bytes_per_rank(cfg, tc, mesh.shape,
                                  max_pos=TRAIN_SEQ + 1)
    steps = [make_train_step(cfg, t, moe_groups=PLACED_AGENTS, dp="data",
                             tp="model", param_specs=specs["params"],
                             sizes=mesh.shape, mesh=mesh)
             for t in (tc, dataclasses.replace(
                 tc, accum_steps=PLACED_ACCUM))]
    losses, norms, secs, grew, gaps = [], [], [], [], {}
    p0 = torch.load(os.path.join(ref_dir, "p0.pt")) if mesh.rank == 0 \
        else None
    for i, (x, y, w) in enumerate(placed_batches(cfg.vocab_size,
                                                 PLACED_STEPS + 1)):
        step = steps[i == PLACED_STEPS]           # 16d: the last
        batch = lm_batch(x, y, w, dev)
        sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        # step 1's collectives as the real mesh reports them (phase 17b)
        with OpCounter() if i == 0 else contextlib.nullcontext() as cnt:
            state, m = step(state, batch)
        if i == 0:
            collectives = cnt.table()["collectives"]
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        secs.append(time.perf_counter() - t0)
        grew.append(torch.cuda.max_memory_allocated(dev) - before)
        params = gather_tree(state["params"], specs["params"], mesh)
        if mesh.rank == 0:
            for ref in ("one", "mirror"):
                gaps[ref, i] = tree_gap(params, torch.load(
                    os.path.join(ref_dir, f"{ref}{i}.pt")), p0, dev)
    same = agreed(mesh, params)
    out = dict(placed=placed, whole=whole, report=report, losses=losses,
               norms=norms, secs=secs, grew=grew,
               peak=[s.placement.peak_bytes for s in steps], same=same,
               gaps=gaps, collectives=collectives)
    del state, params, step, steps
    torch.cuda.empty_cache()
    return out


def placed_twin(mesh):
    """16b on one rank: reduced qwen2-0.5b (2 layers, f32, SGD with
    momentum, remat) from CPU-drawn weights, placed on ``mesh``, 3 steps
    and 16d's 4th at ``accum_steps = PLACED_ACCUM``; (losses, the
    gathered parameter leaves, agreed by all ranks)."""
    dev = mesh.device
    cfg = dataclasses.replace(get_config(SERVE_ARCH).reduced(),
                              n_layers=GENERAL_LAYERS)
    tc = TrainConfig(mode="masked", optimizer="sgdm", lr=3e-2,
                     remat_policy="full")
    state = init_state(torch.Generator().manual_seed(0), cfg, tc,
                       max_pos=TRAIN_SEQ + 1, device="cpu")
    state = {k: mmodel.tree_to(v, dev) if k != "step" else v
             for k, v in state.items()}
    state, specs = place_state(state, mesh)
    steps = [make_train_step(cfg, t, moe_groups=PLACED_AGENTS, dp="data",
                             tp="model", param_specs=specs["params"],
                             sizes=mesh.shape, mesh=mesh)
             for t in (tc, dataclasses.replace(
                 tc, accum_steps=PLACED_ACCUM))]
    losses = []
    for i, (x, y, w) in enumerate(placed_batches(cfg.vocab_size,
                                                 PLACED_STEPS + 1)):
        state, m = steps[i == PLACED_STEPS](state, lm_batch(x, y, w, dev))
        losses.append(float(m["loss"]))
    params = gather_tree(state["params"], specs["params"], mesh)
    if not agreed(mesh, params):
        raise AssertionError("16b: gathered parameters differ across ranks")
    return losses, [l.cpu().numpy() for l in tree_flatten(params)[0]]


def placed_card_rank(rank, world, ref_dir, device="cuda"):
    """A rank of 16a and 16b on the card (gloo, 4 ranks)."""
    card_flags()
    out = placed_full_width(make_test_mesh(data=world, model=1,
                                           device=device), ref_dir)
    out["twin"] = placed_twin(make_test_mesh(data=2, model=2,
                                             device=device))
    return out


def placed_cpu_rank(rank, world):
    """A rank of 16b on the CPU (gloo, 4 ranks, data 2 x model 2)."""
    return placed_twin(make_test_mesh(data=2, model=2, device="cpu"))


def drive_placed(device="cuda"):
    """16a-16b and 16d from the parent. Returns each rank's collectives of
    its first placed step, as its real mesh reported them (phase 17b)."""
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        refs = placed_reference(tmp, device)
        t0 = time.perf_counter()
        res = run_ranks(placed_card_rank, SPMD_RANKS, backend="gloo",
                        device=device, timeout=SPMD_TIMEOUT,
                        args=(tmp, device), threads=CORES // SPMD_RANKS)
        card_s = time.perf_counter() - t0
    r0 = res[0]
    log(f"  16a: {SERVE_ARCH} at full width, {SPMD_LAYERS} layers, on "
        f"{SPMD_RANKS} gloo ranks sharing the card (data = {SPMD_RANKS}), "
        f"{card_s:.1f} s with start-up, 16b and 16d")
    for r, o in enumerate(res):
        log(f"    rank {r}: parameters and moments {o['placed']:,} B after "
            f"placement (memory_allocated), meta-device report "
            f"{o['report']['total']:,} B (params {o['report']['params']:,}, "
            f"moments {o['report']['opt']:,}), replicated state "
            f"{o['whole']:,} B: {o['placed'] / o['whole']:.4f} of it; peak "
            f"gathered weights {o['peak'][0]:,} B")
    log(f"    placed: losses {r0['losses']}, grad norms {r0['norms']}, s "
        f"per step " + ", ".join(f"{s:.2f}" for s in r0["secs"])
        + f" (the last 16d's, accum_steps = {PLACED_ACCUM})")
    for name, (losses, norms, secs) in refs.items():
        log(f"    {name:6s}: losses {losses}, grad norms {norms}, ms per "
            f"step " + ", ".join(f"{s * 1e3:.1f}" for s in secs))
    log(f"    gathered parameters identical on every rank: "
        f"{all(o['same'] for o in res)}")
    for (ref, i), (mx, eq, rel) in sorted(r0["gaps"].items()):
        log(f"    after step {i + 1}{' (16d)' if i == PLACED_STEPS else ''}"
            f", placed vs {ref:6s}: max |diff| "
            f"{mx:.3e}, {eq:.4f} bit-identical, ||diff|| / ||update|| "
            f"{rel:.3e}" + (f" (bound {PLACED_UPDATE_REL})" if ref == "one"
                            else ""))
    for r, o in enumerate(res):
        if abs(o["placed"] - o["report"]["total"]) > \
                PLACED_BYTES_REL * o["report"]["total"]:
            raise AssertionError(f"16a rank {r}: {o['placed']} B placed, "
                                 f"the report says {o['report']['total']}")
        if not 0.24 < o["placed"] / o["whole"] < 0.26:
            raise AssertionError(f"16a rank {r}: holds {o['placed']} of "
                                 f"{o['whole']} B, not a quarter")
    if not all(o["same"] for o in res):
        raise AssertionError("16a: gathered parameters differ across ranks")
    for (ref, i), (mx, eq, rel) in r0["gaps"].items():
        phase = "16d" if i == PLACED_STEPS else "16a"
        if ref == "mirror" and not (mx == 0.0 and eq == 1.0):
            raise AssertionError(f"{phase} step {i + 1}: the placed step is "
                                 f"not the mirror's arithmetic (max |diff| "
                                 f"{mx})")
        if ref == "one" and not rel <= PLACED_UPDATE_REL:
            raise AssertionError(f"{phase} step {i + 1}: ||diff|| / "
                                 f"||update|| {rel} against the "
                                 f"one-process step")
    if not np.isfinite(r0["losses"]).all():
        raise AssertionError(f"16a: losses {r0['losses']}")
    np.testing.assert_allclose(r0["losses"], refs["mirror"][0],
                               **PLACED_METRIC_TOL)
    np.testing.assert_allclose(r0["norms"], refs["mirror"][1],
                               **PLACED_METRIC_TOL)
    np.testing.assert_allclose(r0["losses"], refs["one"][0], rtol=1e-2)

    t0 = time.perf_counter()
    cpu = run_ranks(placed_cpu_rank, SPMD_RANKS, backend="gloo",
                    device="cpu", timeout=SPMD_TIMEOUT,
                    threads=CORES // SPMD_RANKS)
    cpu_s = time.perf_counter() - t0
    (card_l, card_p), (cpu_l, cpu_p) = r0["twin"], cpu[0]
    np.testing.assert_allclose(card_l, cpu_l, **TWIN_TOL)
    err = 0.0
    for a, b in zip(card_p, cpu_p):
        np.testing.assert_allclose(a, b, **TWIN_TOL)
        err = max(err, float(np.max(np.abs(a - b))))
    for o in res[1:]:
        for a, b in zip(o["twin"][1], card_p):
            np.testing.assert_array_equal(a, b)
    log(f"  16b: reduced {SERVE_ARCH} (f32, {GENERAL_LAYERS} layers, remat) "
        f"placed on data 2 x model 2, {PLACED_STEPS} steps and 16d's at "
        f"accum_steps = {PLACED_ACCUM}: losses "
        f"{[round(l, 5) for l in card_l]}; card vs {SPMD_RANKS} CPU ranks "
        f"({cpu_s:.1f} s) max |param diff| {err:.2e} (tolerance "
        f"{TWIN_TOL['atol']:.0e})")
    k1 = slice(0, PLACED_STEPS)
    log(f"  16d: 16a's ranks at accum_steps = {PLACED_ACCUM} (step "
        f"{PLACED_STEPS + 1}) against accum_steps = 1 (steps 1-"
        f"{PLACED_STEPS}): s per step {r0['secs'][-1]:.2f} against "
        + ", ".join(f"{s:.2f}" for s in r0["secs"][k1]))
    for r, o in enumerate(res):
        log(f"    rank {r}: peak gathered weights {o['peak'][1]:,} B at "
            f"accum_steps = {PLACED_ACCUM} (gathered once, held over the "
            f"microbatches), {o['peak'][0]:,} B at 1; max_memory_allocated "
            f"above the step's start {o['grew'][-1]:,} B at "
            f"{PLACED_ACCUM}, " + ", ".join(f"{g:,}" for g in o["grew"][k1])
            + " B at 1")
    return [o["collectives"] for o in res]


@torch.no_grad()
def drive_launch_serve(device="cuda"):
    """16c: ``greedy_generate`` at full width against ``ServeEngine.run``
    on the same prompts, decode launches counted; the prefill and decode
    steps under an activation policy against the policy-free calls."""
    cfg = get_config(SERVE_ARCH)
    params = init_model(torch.Generator(device=device).manual_seed(0), cfg,
                        device=device)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (GREEDY_PROMPTS, GREEDY_PROMPT_LEN)).astype(
            np.int32)
    max_len = GREEDY_PROMPT_LEN + GREEDY_NEW
    greedy_generate(params, cfg, prompts[:1, :8], max_len=max_len, steps=2,
                    page_size=GREEDY_PAGE, device=device)       # warm-up
    dattn.reset_launches()
    sync(device)
    t0 = time.perf_counter()
    out = greedy_generate(params, cfg, torch.from_numpy(prompts).to(device),
                          max_len=max_len, steps=GREEDY_NEW,
                          page_size=GREEDY_PAGE, device=device)
    sync(device)
    wall = time.perf_counter() - t0
    launches = dattn.LAUNCHES["paged_flash_decode"]
    per_seq = -(-max_len // GREEDY_PAGE)
    eng = ServeEngine(params, cfg, PagedCacheConfig(
        num_slots=GREEDY_PROMPTS, page_size=GREEDY_PAGE,
        num_pages=GREEDY_PROMPTS * per_seq + 1, max_pages_per_seq=per_seq),
        superstep_k=8, device=device)
    rids = [eng.submit(p, GREEDY_NEW) for p in prompts]
    probe = StepProbe()
    ref = checked_drain(eng, after_step=probe)
    same = all(np.array_equal(out[i, GREEDY_PROMPT_LEN:].cpu().numpy(),
                              ref[rid]) for i, rid in enumerate(rids))
    steps = eng.stats["decode_steps"]
    log(f"  16c: greedy_generate, {SERVE_ARCH} at full width, "
        f"{GREEDY_PROMPTS} prompts of {GREEDY_PROMPT_LEN} tokens, "
        f"{GREEDY_NEW} new each: {wall:.2f} s, "
        f"{GREEDY_PROMPTS * GREEDY_NEW / wall:.1f} tok/s; paged_flash_decode "
        f"launched {launches} times = {gqa_layers(cfg)} layers x {steps} "
        f"decode steps: {launches == gqa_layers(cfg) * steps}; tokens equal "
        f"ServeEngine.run's: {same}; the kernel on that engine's pools and "
        f"table after steps {probe.at}, every layer, against "
        f"paged_decode_plain: max |err| {max(probe.errs):.3e}")
    if tuple(out.shape) != (GREEDY_PROMPTS, max_len) or not same or \
            launches != gqa_layers(cfg) * steps or steps != GREEDY_NEW - 1 \
            or len(probe.errs) != len(probe.at) * gqa_layers(cfg):
        raise AssertionError(f"16c: shape {tuple(out.shape)}, streams equal "
                             f"{same}, {launches} launches, {steps} steps")

    policy = dict(dp="data", tp="model", sizes={"data": SPMD_RANKS,
                                                "model": 1})
    batch = {"tokens": torch.from_numpy(prompts).to(device)}
    recs = {"prefill": [], "decode": []}
    with act_policy(None, None, recorder=recs["prefill"]):
        tok, cache = make_prefill_step(cfg, **policy)(params, batch)
    tok0, cache0 = make_prefill_step(cfg)(params, batch)
    dense = [dense_cache(cfg, c, GREEDY_PROMPTS, GREEDY_PROMPT_LEN + 1,
                         device) for c in (cache, cache0)]
    pos = torch.tensor(GREEDY_PROMPT_LEN, dtype=torch.int32)
    with act_policy(None, None, recorder=recs["decode"]):
        nxt, _ = make_decode_step(cfg, **policy)(
            params, {"tokens": tok[:, None], "cache": dense[0], "pos": pos})
    nxt0, _ = make_decode_step(cfg)(
        params, {"tokens": tok0[:, None], "cache": dense[1], "pos": pos})
    kinds = {m: sorted({k for k, _, _ in r}) for m, r in recs.items()}
    log(f"  16c: make_prefill_step / make_decode_step under act_policy"
        f"({policy}): tokens {tok.tolist()} / {nxt.tolist()}, equal to the "
        f"policy-free calls': {torch.equal(tok, tok0)} / "
        f"{torch.equal(nxt, nxt0)}; constraint points recorded by an "
        f"enclosing recorder: " + ", ".join(
            f"{m} {len(r)} ({len(set(r))} distinct, kinds {kinds[m]})"
            for m, r in recs.items()))
    if not (torch.equal(tok, tok0) and torch.equal(nxt, nxt0)) or \
            tok.dtype != torch.int32:
        raise AssertionError("16c: the steps' tokens differ under a policy")
    want = {"prefill": ["act", "ffn", "heads4", "logits"],
            "decode": ["act", "ffn", "hd_tp", "logits"]}
    for m, r in recs.items():
        if kinds[m] != want[m] or any(spec[0] != "data" for _, _, spec in r):
            raise AssertionError(f"16c {m}: the step's policy did not reach "
                                 f"the model: {sorted(set(r))}")
    del params, eng, cache, cache0, dense
    torch.cuda.empty_cache()
    return launches


def example_main(name, argv):
    """``examples/<name>.py``'s ``main(argv)`` in this process; its lines
    logged indented."""
    import importlib.util
    import io
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        lines = mod.main(argv)
    log(f"  {name} {' '.join(argv)} ({time.perf_counter() - t0:.1f} s):")
    for line in "\n".join(lines).splitlines():
        log(f"    {line}")
    return lines


@contextlib.contextmanager
def caught_runs():
    """Every ``AsyncEngine.run`` history inside the block, in call order,
    appended to the list it yields."""
    runs, run = [], AsyncEngine.run

    def caught(self, iters):
        h = run(self, iters)
        runs.append(h)
        return h

    AsyncEngine.run = caught
    try:
        yield runs
    finally:
        AsyncEngine.run = run


def drive_examples():
    """16e: the three example twins on the card at their defaults; the
    Byzantine one again on the device backend, its 9 runs held to the
    host backend's (the same events, ||x - x*|| within
    ``EXAMPLE_DIST_TOL`` at every iteration); the serving one again on
    the CPU, where the decode is its plain form, the streams equal.
    Returns the kernel launches of the card's runs."""
    counts = dict.fromkeys(("paged_flash_decode", "masked_cge_reduce",
                            "trimmed_mean_tiled"), 0)
    example_main("torch_quickstart", [])
    with caught_runs() as host:
        example_main("torch_byzantine_cge", [])
    agg.reset_launches()
    with caught_runs() as dev:
        example_main("torch_byzantine_cge", ["--agg-backend", "device"])
    for k in ("masked_cge_reduce", "trimmed_mean_tiled"):
        counts[k] = agg.LAUNCHES[k]
    worst = 0.0
    for h, d in zip(host, dev, strict=True):
        if d.n_rx != h.n_rx or d.comm_time != h.comm_time:
            raise AssertionError("16e: the device backend's events differ "
                                 "from the host backend's")
        np.testing.assert_allclose(d.dist, h.dist, **EXAMPLE_DIST_TOL)
        worst = max(worst, float(np.max(np.abs(np.subtract(d.dist,
                                                           h.dist)))))
    log(f"  16e: the device backend's {len(dev)} runs against the host "
        f"backend's: the same events, max | ||x - x*|| diff | {worst:.3e} "
        f"over every iteration (tolerance {EXAMPLE_DIST_TOL})")
    dattn.reset_launches()
    card = example_main("torch_serve_lm", [])
    counts["paged_flash_decode"] = dattn.LAUNCHES["paged_flash_decode"]
    cpu = example_main("torch_serve_lm", ["--device", "cpu"])
    # every line but the first, which times the run: stats and streams
    same = card[1:] == cpu[1:]
    streams = [l for l in card if l.lstrip().startswith("req ")]
    log(f"  16e: torch_serve_lm's engine stats and {len(streams)} streams "
        f"on the card equal the CPU's: {same}")
    log(f"  16e launches: {counts}")
    if not (same and streams):
        raise AssertionError("16e: torch_serve_lm's streams differ between "
                             "the card and the CPU")
    if not all(counts.values()):
        raise AssertionError(f"16e: a kernel was not launched: {counts}")
    return counts


# ---------------------------------------------------------------------------
# 17. the dry run against the card


# the dry run's peak of live temporaries against the allocator's peak
# above the arguments: the allocator rounds every block up to 512 bytes
# and some kernels take workspace the op trace does not show
DRY_TEMP_REL = 0.2
DRY_DECODE_ROWS, DRY_DECODE_LEN, DRY_DECODE_POS = 8, 1024, 512
META = torch.device("meta")


def lm_batch_meta(rows: int, seq: int, cfg=None):
    return with_frames(
        {"tokens": torch.empty((rows, seq), dtype=torch.int32, device=META),
         "targets": torch.empty((rows, seq), dtype=torch.int32,
                                device=META),
         "weights": torch.empty((rows, seq), dtype=torch.float32,
                                device=META)}, cfg, META)


def counted(fn, *args):
    """(fn's output, its OpCounter)."""
    with OpCounter() as cnt:
        out = fn(*args)
    return out, cnt


def require_same_ops(what, dry, card, keys=("flops", "bytes")):
    """Fail naming every op whose ``keys`` differ between the dry run's
    count and the card's."""
    bad = {op: (x, y) for op, (x, y) in diff(dry, card).items()
           if any((x or {}).get(k, 0) != (y or {}).get(k, 0)
                  for k in keys)}
    if bad:
        raise AssertionError(f"{what}: ops dispatched differently on meta "
                             f"and on the card: {bad}")


def dry_train_step(bf16_rate: float, device="cuda"):
    """17a: 15a's step (``make_train_step``, examples/train_lm.py's
    defaults) on the meta device and on the card under one counter.
    Returns the card's parameters."""
    cfg = get_config(SERVE_ARCH)
    tc = placed_tc("none")
    step = make_train_step(cfg, tc, moe_groups=TRAIN_AGENTS)
    state = abstract_state(cfg, tc, max_pos=TRAIN_SEQ + 1)
    _, dry = counted(step, state, lm_batch_meta(TRAIN_BATCH, TRAIN_SEQ))

    state = init_state(torch.Generator(device=device).manual_seed(0), cfg,
                       tc, max_pos=TRAIN_SEQ + 1, device=device)
    x, y = next(lm_batches(markov_tokens(200_000, vocab=cfg.vocab_size,
                                         seed=0), TRAIN_BATCH, TRAIN_SEQ,
                           seed=1))
    mask, _, _ = StragglerOracle(TRAIN_AGENTS, TRAIN_R, seed=2).next_mask()
    batch = lm_batch(x, y, mask_to_weights(mask, TRAIN_BATCH, TRAIN_SEQ),
                     device)
    state, m = step(state, batch)     # warm: the library workspaces
    float(m["loss"])
    gc.collect()                      # no garbage among the arguments
    sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    (new, _), card = counted(step, state, batch)
    sync(device)
    card_temp = torch.cuda.max_memory_allocated(device) - base
    state = new
    del new
    t0 = time.perf_counter()
    for _ in range(3):
        state, m = step(state, batch)
        float(m["loss"])
    ms = (time.perf_counter() - t0) / 3 * 1e3

    a, c = analyze(dry), analyze(card)
    tflops = a["flops"] / (ms * 1e-3) / 1e12
    log(f"  17a: {SERVE_ARCH} at full width, 15a's step (batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, one rank): meta {a['flops']:.6e} "
        f"FLOPs and {a['hbm_bytes']:.6e} HBM bytes, card {c['flops']:.6e} "
        f"and {c['hbm_bytes']:.6e}; differing ops: {diff(dry, card)}")
    log(f"    temporaries: dry run {dry.peak_temp_bytes:,} B, card "
        f"max_memory_allocated above the arguments {card_temp:,} B "
        f"({dry.peak_temp_bytes / card_temp:.4f}; bound 1 +- "
        f"{DRY_TEMP_REL})")
    log(f"    step {ms:.2f} ms on the host clock (3 steps, synchronized): "
        f"{tflops:.3f} TFLOP/s, {tflops * 1e12 / bf16_rate:.5f} of the "
        f"card's dense bf16 peak {bf16_rate / 1e12:.0f} TFLOP/s")
    require_same_ops("17a", dry, card)
    if abs(dry.peak_temp_bytes - card_temp) > DRY_TEMP_REL * card_temp:
        raise AssertionError(f"17a: dry-run temporaries "
                             f"{dry.peak_temp_bytes} B against the card's "
                             f"{card_temp} B")
    return state["params"]


def dry_placed_collectives(placed_collectives):
    """17b: 16a's placed step (data = 4, remat) on a recording mesh of
    the same shape on the meta device: its collectives against those each
    of 16a's gloo ranks counted through its real mesh."""
    cfg = spmd_cfg()
    tc = placed_tc("full")
    mesh = RecordingMesh((SPMD_RANKS, 1), ("data", "model"))
    state, specs = place_state(abstract_state(cfg, tc,
                                              max_pos=TRAIN_SEQ + 1), mesh)
    step = make_train_step(cfg, tc, moe_groups=PLACED_AGENTS, dp="data",
                           tp="model", param_specs=specs["params"],
                           sizes=mesh.shape, mesh=mesh)
    _, dry = counted(step, state, lm_batch_meta(TRAIN_BATCH, TRAIN_SEQ))
    want = dry.table()["collectives"]
    a = analyze(dry)
    log(f"  17b: 16a's placed step, recorded: {a['collective_count']:.0f} "
        f"all-reduces, {a['collectives']['all-reduce']:.6e} wire bytes a "
        f"rank; " + ", ".join(
            f"rank {r} {'equal' if got == want else 'DIFFERENT'}"
            for r, got in enumerate(placed_collectives)))
    for r, got in enumerate(placed_collectives):
        if got != want:
            raise AssertionError(f"17b rank {r}: the real mesh reported "
                                 f"{got}, the dry run {want}")


@torch.no_grad()
def dry_decode_step(params, device="cuda"):
    """17c: ``launch.serve``'s dense decode step on the meta device and on
    the card (17a's weights)."""
    cfg = get_config(SERVE_ARCH)
    step = make_decode_step(cfg)

    def batch(dev):
        return {"tokens": torch.zeros((DRY_DECODE_ROWS, 1),
                                      dtype=torch.int32, device=dev),
                "cache": mmodel.init_cache(cfg, DRY_DECODE_ROWS,
                                           DRY_DECODE_LEN, device=dev),
                "pos": DRY_DECODE_POS}
    meta_params = init_model(None, cfg, device=META)
    _, dry = counted(step, meta_params, batch(META))
    (tok, _), card = counted(step, params, batch(device))
    a, c = analyze(dry), analyze(card)
    log(f"  17c: dense decode, {DRY_DECODE_ROWS} rows at position "
        f"{DRY_DECODE_POS} of {DRY_DECODE_LEN}: meta {a['flops']:.6e} "
        f"FLOPs, card {c['flops']:.6e}; differing ops: {diff(dry, card)}")
    require_same_ops("17c", dry, card, keys=("flops",))
    if tok.shape != (DRY_DECODE_ROWS,):
        raise AssertionError(f"17c: next tokens of shape {tok.shape}")


def drive_dryrun(placed_collectives, bf16_rate: float):
    """17a-17c."""
    params = dry_train_step(bf16_rate)
    dry_placed_collectives(placed_collectives)
    dry_decode_step(params)
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 18. tensor-parallel compute over "model" for the dense decoders


# 18a: 16a's agents, mask and batches on data 2 x model 2 (no remat: the
# f32 twin recomputes, so a recomputation on autograd's thread is held to
# the one-process step there); the f32 twin
# (full width, 2 layers, SGD with momentum: AdamW would turn the
# reordered sums of near-zero gradients into updates of about lr) against
# the one-process step within TWIN_TOL. 18b: 16c's prompts.
TPC_DATA, TPC_MODEL = 2, 2
TPC_TWIN_LAYERS = 2
TPC_FLOP_RATIO = (0.45, 0.60)      # rank FLOPs at model 2 over model 1


def tpc_twin():
    """(config, train config) of 18a's f32 twin."""
    cfg = dataclasses.replace(get_config(SERVE_ARCH),
                              n_layers=TPC_TWIN_LAYERS,
                              param_dtype="float32", compute_dtype="float32")
    return cfg, TrainConfig(mode="masked", optimizer="sgdm", lr=3e-2,
                            remat_policy="full")


def twin_placed(mesh, cfg, tc, path) -> bool:
    """An f32 twin's placed steps on this rank (from seed 1, over 16a's
    batches); rank 0 saves the gathered parameters to ``path``. Returns
    whether they are the same on every rank."""
    dev = mesh.device
    state = init_state(torch.Generator(device=dev).manual_seed(1), cfg, tc,
                       max_pos=TRAIN_SEQ + 1, device=dev)
    state, specs = place_state(state, mesh)
    step = make_train_step(cfg, tc, moe_groups=PLACED_AGENTS, dp="data",
                           tp="model", param_specs=specs["params"],
                           sizes=mesh.shape, mesh=mesh)
    for x, y, w in placed_batches(cfg.vocab_size):
        state, m = step(state, lm_batch(x, y, w, dev, cfg))
    params = gather_tree(state["params"], specs["params"], mesh)
    same = agreed(mesh, params)
    if mesh.rank == 0:                # the parent holds it to its reference
        torch.save(mmodel.tree_to(params, "cpu"), path)
    del state, step, params
    torch.cuda.empty_cache()
    return same


def twin_one_process(cfg, tc, device="cuda"):
    """The same twin's steps in one process (``make_train_step``): its
    parameters."""
    state = init_state(torch.Generator(device=device).manual_seed(1), cfg,
                       tc, max_pos=TRAIN_SEQ + 1, device=device)
    step = make_train_step(cfg, tc, moe_groups=PLACED_AGENTS)
    for x, y, w in placed_batches(cfg.vocab_size):
        state, _ = step(state, lm_batch(x, y, w, device, cfg))
    return state["params"]


def twin_gap(path, ref, device="cuda") -> float:
    """max |param diff| of the placed twin saved at ``path`` against the
    one-process ``ref``, each leaf held within ``TWIN_TOL``."""
    twin = torch.load(path)
    pairs = [(a.to(device), b) for a, b in zip(tree_flatten(twin)[0],
                                               tree_flatten(ref)[0])]
    for a, b in pairs:
        torch.testing.assert_close(a, b, **TWIN_TOL)
    return max(float((a - b).abs().max()) for a, b in pairs)


def tpc_meta_count(model: int):
    """18a's placed step (16a's configuration, no remat) on rank 0 of a
    recording mesh data 2 x ``model``, on the meta device."""
    cfg = spmd_cfg()
    tc = placed_tc("none")
    mesh = RecordingMesh((TPC_DATA, model), ("data", "model"))
    state, specs = place_state(abstract_state(cfg, tc,
                                              max_pos=TRAIN_SEQ + 1), mesh)
    step = make_train_step(cfg, tc, moe_groups=PLACED_AGENTS, dp="data",
                           tp="model", param_specs=specs["params"],
                           sizes=mesh.shape, mesh=mesh)
    _, cnt = counted(step, state, lm_batch_meta(TRAIN_BATCH, TRAIN_SEQ))
    return cnt.table()


def tpc_grow(cfg, prefill, rows, max_len, mesh):
    """A decode cache of ``max_len`` positions in ``place_cache``'s layout
    holding a tensor-parallel prefill's cache."""
    cache = place_cache(mmodel.init_cache(cfg, rows, max_len,
                                          device=mesh.device), cfg, mesh)
    for blk, pre in zip(cache, prefill):
        for part, leaves in blk.items():
            for name, leaf in leaves.items():
                src = pre[part][name]
                if leaf.shape == src.shape:     # a Mamba or RWKV state
                    leaf.copy_(src)
                else:
                    leaf[:, :, :src.shape[2]] = src
    return cache


@torch.no_grad()
def tpc_serve(mesh, prompts):
    """18b on one rank: this dp rank's prompts through ``make_prefill_step``
    and ``make_decode_step`` on ``place_params``' blocks; (tokens, ms per
    decode step)."""
    dev = mesh.device
    cfg = spmd_cfg()
    params = place_params(init_model(torch.Generator(device=dev)
                                     .manual_seed(0), cfg, device=dev),
                          cfg, mesh)
    rows = len(prompts) // TPC_DATA
    d = mesh.axis_index("data")
    mine = torch.from_numpy(prompts[d * rows:(d + 1) * rows]).to(dev)
    prefill = make_prefill_step(cfg, mesh=mesh)
    decode = make_decode_step(cfg, mesh=mesh)
    tok, pre = prefill(params, {"tokens": mine})
    cache = tpc_grow(cfg, pre, rows, GREEDY_PROMPT_LEN + GREEDY_NEW, mesh)
    out = [tok]
    sync(dev)
    t0 = time.perf_counter()
    for i in range(GREEDY_NEW - 1):
        tok, _ = decode(params, {"tokens": tok[:, None], "cache": cache,
                                 "pos": GREEDY_PROMPT_LEN + i})
        out.append(tok)
    sync(dev)
    ms = (time.perf_counter() - t0) / (GREEDY_NEW - 1) * 1e3
    toks = torch.stack(out, 1).cpu().numpy()
    del params, cache, pre
    return toks, ms


def tpc_card_rank(rank, world, ref_dir, prompts, device="cuda"):
    """A rank of 18a and 18b on the card (gloo, data 2 x model 2)."""
    card_flags()
    mesh = make_test_mesh(data=TPC_DATA, model=TPC_MODEL, device=device)
    dev = mesh.device
    cfg = spmd_cfg()
    tc = placed_tc("none")
    full = init_state(torch.Generator(device=dev).manual_seed(0), cfg, tc,
                      max_pos=TRAIN_SEQ + 1, device=dev)
    whole = sum(l.numel() * l.element_size() for k in ("params", "opt")
                for l in tree_flatten(full[k])[0])
    before = torch.cuda.memory_allocated(dev)
    state, specs = place_state(full, mesh)
    placed = torch.cuda.memory_allocated(dev) - before
    del full
    torch.cuda.empty_cache()
    step = make_train_step(cfg, tc, moe_groups=PLACED_AGENTS, dp="data",
                           tp="model", param_specs=specs["params"],
                           sizes=mesh.shape, mesh=mesh)
    losses, secs = [], []
    t_rank = time.perf_counter()
    for i, (x, y, w) in enumerate(placed_batches(cfg.vocab_size)):
        last = i == PLACED_STEPS - 1         # counted: the card's ops
        sync(dev)
        t0 = time.perf_counter()
        with OpCounter() if last else contextlib.nullcontext() as cnt:
            state, m = step(state, lm_batch(x, y, w, dev))
            losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
        if last:
            table = cnt.table()
    same = agreed(mesh, gather_tree(state["params"], specs["params"], mesh))
    out = dict(placed=placed, whole=whole, losses=losses, secs=secs,
               table=table, same=same, tp=step.placement.tp,
               report=state_bytes_per_rank(cfg, tc, mesh.shape,
                                           max_pos=TRAIN_SEQ + 1))
    del state, step
    torch.cuda.empty_cache()
    out["steps_s"] = time.perf_counter() - t_rank

    t0 = time.perf_counter()
    out["twin_same"] = twin_placed(mesh, *tpc_twin(),
                                   os.path.join(ref_dir, "tpc_twin_tp.pt"))
    out["twin_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out["tokens"], out["decode_ms"] = tpc_serve(mesh, prompts)
    out["serve_s"] = time.perf_counter() - t0
    return out


@torch.no_grad()
def tpc_one_rank(prompts, device="cuda", cfg=None, new=GREEDY_NEW):
    """18b's one-rank reference (20a's with ``cfg``): the same prefill and
    greedy decode steps with whole parameters, ``new`` tokens; (tokens,
    ms per decode step, parameters)."""
    cfg = cfg or spmd_cfg()
    params = init_model(torch.Generator(device=device).manual_seed(0), cfg,
                        device=device)
    batch = torch.from_numpy(prompts).to(device)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    prefill(params, with_frames({"tokens": batch[:, :8]}, cfg,
                                device))                      # warm-up
    tok, pre = prefill(params, with_frames({"tokens": batch}, cfg, device))
    cache = dense_cache(cfg, pre, len(prompts), GREEDY_PROMPT_LEN + new,
                        device)
    out = [tok]
    sync(device)
    t0 = time.perf_counter()
    for i in range(new - 1):
        tok, _ = decode(params, {"tokens": tok[:, None], "cache": cache,
                                 "pos": GREEDY_PROMPT_LEN + i})
        out.append(tok)
    sync(device)
    ms = (time.perf_counter() - t0) / (new - 1) * 1e3
    return torch.stack(out, 1).cpu().numpy(), ms, params


@torch.no_grad()
def tpc_teacher_forced(params, prompts, streams, device="cuda", cfg=None,
                       mesh=None, idle=()):
    """One rank's logits along ``streams`` (the prefill's last position,
    then each decode fed the stream's previous token): (B, T, V) f32.
    With ``mesh``, the tensor-parallel ranks' (``params`` this rank's
    blocks, every rank of the mesh calling), the vocabulary gathered;
    ``idle``: the dp axes the decode's batch leaves idle, as
    ``make_decode_step(..., dp=())`` names them."""
    cfg = cfg or spmd_cfg()
    batch = torch.from_numpy(prompts).to(device)

    def last(logits):
        lf = logits[:, -1]
        return (gather_from_tp(lf, -1) if vocab_split(lf, cfg)
                else lf).float()

    enc = (frames(cfg, len(prompts), device) if cfg.encoder_decoder
           else None)
    with tp_context(mesh, idle=idle):
        logits, _, pre = apply_model(params, batch, cfg, mode="prefill",
                                     enc_embed=enc)
        out = [last(logits)]
        cache = (dense_cache(cfg, pre, len(prompts),
                             GREEDY_PROMPT_LEN + GREEDY_NEW, device)
                 if mesh is None else
                 tpc_grow(cfg, pre, len(prompts),
                          GREEDY_PROMPT_LEN + GREEDY_NEW, mesh))
        feed = torch.from_numpy(streams).to(device)
        for i in range(streams.shape[1] - 1):
            logits, _, _ = apply_model(params, feed[:, i:i + 1], cfg,
                                       mode="decode", cache=cache,
                                       cache_index=GREEDY_PROMPT_LEN + i)
            out.append(last(logits))
    return torch.stack(out, 1)


def drive_tp_compute(device="cuda"):
    """18a-18b: the placed masked step and launch.serve's steps of
    qwen2-0.5b at full width (``SPMD_LAYERS`` layers), tensor-parallel
    over model = 2 on 4 gloo ranks sharing the card (data 2 x model 2)."""
    t_all = time.perf_counter()
    cfg = spmd_cfg()
    prompts = np.random.default_rng(0).integers(       # 16c's prompts
        0, cfg.vocab_size, (GREEDY_PROMPTS, GREEDY_PROMPT_LEN)).astype(
            np.int32)
    one_tok, one_ms, params = tpc_one_rank(prompts, device)
    t_one = time.perf_counter() - t_all
    t0 = time.perf_counter()
    ref = twin_one_process(*tpc_twin(), device)
    t_twin = time.perf_counter() - t0

    def meta_counts():
        t0 = time.perf_counter()
        out = tpc_meta_count(TPC_MODEL), tpc_meta_count(1)
        return out + (time.perf_counter() - t0,)

    # the meta counts (host work only) on a thread while the ranks run
    ex = ThreadPoolExecutor(1)
    counting = ex.submit(meta_counts)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t0 = time.perf_counter()
        res = run_ranks(tpc_card_rank, TPC_DATA * TPC_MODEL, backend="gloo",
                        device=device, timeout=SPMD_TIMEOUT,
                        args=(tmp, prompts, device),
                        threads=CORES // (TPC_DATA * TPC_MODEL))
        ranks_s = time.perf_counter() - t0
        dry, dry1, t_meta = counting.result()
        ex.shutdown()
        twin_err = twin_gap(os.path.join(tmp, "tpc_twin_tp.pt"), ref, device)
    del ref
    r0 = res[0]
    a, a1 = analyze(dry), analyze(dry1)
    log(f"  18a: {SERVE_ARCH} at full width, {SPMD_LAYERS} layers, bf16, "
        f"the placed masked step "
        f"on data {TPC_DATA} x model {TPC_MODEL} (4 gloo ranks sharing the "
        f"card, {ranks_s:.1f} s with start-up: rank 0's state and steps "
        f"{r0['steps_s']:.1f} s, twin {r0['twin_s']:.1f} s, 18b "
        f"{r0['serve_s']:.1f} s; before the ranks, one rank's serving "
        f"{t_one:.1f} s and the twin's reference {t_twin:.1f} s; beside "
        f"them, the two meta counts {t_meta:.1f} s), tp axes {r0['tp']}")
    for r, o in enumerate(res):
        log(f"    rank {r}: parameters and moments {o['placed']:,} B after "
            f"placement, meta-device report {o['report']['total']:,} B, "
            f"replicated state {o['whole']:,} B; s per step " + ", ".join(
                f"{t:.2f}" for t in o["secs"]))
    log(f"    losses {r0['losses']}; gathered parameters identical on every "
        f"rank: {all(o['same'] for o in res)}")
    card_flops = analyze(r0["table"])["flops"]
    log(f"    rank FLOPs of a step: card (the last) {card_flops:.6e}, "
        f"recording mesh (meta) {a['flops']:.6e}; at data "
        f"{TPC_DATA} x model 1 (meta) {a1['flops']:.6e}: ratio "
        f"{a['flops'] / a1['flops']:.4f}; all-reduces a rank "
        f"{a['collective_count']:.0f} ({a['collectives']['all-reduce']:.6e} "
        f"wire bytes) against {a1['collective_count']:.0f} "
        f"({a1['collectives']['all-reduce']:.6e})")
    log(f"    f32 twin ({TPC_TWIN_LAYERS} layers, full width, SGD-momentum) "
        f"against the one-process make_train_step after {PLACED_STEPS} "
        f"steps: max |param diff| {twin_err:.3e} (tolerance "
        f"{TWIN_TOL['atol']:.0e}); identical on every rank: "
        f"{all(o['twin_same'] for o in res)}")
    for r, o in enumerate(res):
        require_same_ops(f"18a rank {r}", dry, o["table"], keys=("flops",))
        if o["table"]["collectives"] != dry["collectives"]:
            raise AssertionError(f"18a rank {r}: collectives "
                                 f"{o['table']['collectives']}, recorded "
                                 f"{dry['collectives']}")
        if abs(o["placed"] - o["report"]["total"]) > \
                PLACED_BYTES_REL * o["report"]["total"]:
            raise AssertionError(f"18a rank {r}: {o['placed']} B placed, "
                                 f"the report says {o['report']['total']}")
    ratio = a["flops"] / a1["flops"]
    if not (all(o["same"] and o["twin_same"] for o in res)
            and r0["tp"] == ("model",) and np.isfinite(r0["losses"]).all()
            and TPC_FLOP_RATIO[0] <= ratio <= TPC_FLOP_RATIO[1]):
        raise AssertionError(f"18a: same {[o['same'] for o in res]}, twin "
                             f"{[o['twin_same'] for o in res]}, tp "
                             f"{r0['tp']}, losses {r0['losses']}, FLOP "
                             f"ratio {ratio}")

    # 18b: every model rank of a dp block streams the same tokens; the
    # streams against one rank's greedy argmax wherever it is clear
    rows = GREEDY_PROMPTS // TPC_DATA
    streams = np.concatenate([res[d * TPC_MODEL]["tokens"]
                              for d in range(TPC_DATA)])
    for r, o in enumerate(res):
        d = r // TPC_MODEL
        if not np.array_equal(o["tokens"], streams[d * rows:(d + 1) * rows]):
            raise AssertionError(f"18b rank {r}: tokens differ from its "
                                 "dp block's other model rank")
    lg = tpc_teacher_forced(params, prompts, streams, device)
    top2 = lg.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > LOGIT_TOL
    agree = lg.argmax(-1).cpu().numpy() == streams
    clear = clear.cpu().numpy()
    mean_ms = float(np.mean([o["decode_ms"] for o in res]))
    log(f"  18b: launch.serve prefill + {GREEDY_NEW - 1} decode steps, "
        f"{GREEDY_PROMPTS} prompts of {GREEDY_PROMPT_LEN}, on data "
        f"{TPC_DATA} x model {TPC_MODEL}: {mean_ms:.2f} ms per decode "
        f"step (ranks " + ", ".join(
            f"{o['decode_ms']:.2f}" for o in res) + f") against one rank's "
        f"{one_ms:.2f}; streams equal to one rank's greedy tokens: "
        f"{np.array_equal(streams, one_tok)} ({int((streams == one_tok).sum())}"
        f" of {streams.size} positions); the one-rank argmax along the "
        f"streams at {int(agree.sum())} of {agree.size} positions, "
        f"{int((~clear).sum())} within the {LOGIT_TOL} margin")
    if not agree[clear].all():
        raise AssertionError("18b: a stream leaves one rank's greedy argmax "
                             "at a clear margin")
    del params
    torch.cuda.empty_cache()
    log(f"  phase 18 in {time.perf_counter() - t_all:.1f} s")


# 19: the general step over data 2 x model 2
GEN_DATA, GEN_MODEL = 2, 2
GEN_STEPS, GEN_TWIN_LAYERS = 2, 2
GEN_WHY = {"cge": "f = 1, both agents received (one masked at n = 2 "
                  "leaves m - f = 0 to keep)",
           "stale": "tau = 1, agent t % 2 masked at step t",
           "trimmed": "f = 0, agent t % 2 masked at step t (f = 1 at n = "
                      "2 leaves m - 2f <= 0: the rule returns 0)",
           "quantized": "agent t % 2 masked at step t"}


def gen_tc(mode: str, twin: bool) -> TrainConfig:
    return TrainConfig(mode=mode, lr=3e-2 if twin else TRAIN_LR,
                       f=0 if mode == "trimmed" else 1, tau=1,
                       remat_policy="none",
                       optimizer="sgdm" if twin else "adamw")


def gen_masks(mode: str):
    out = []
    for t in range(GEN_STEPS):
        m = np.ones(GEN_DATA, np.float32)
        if mode != "cge":
            m[t % GEN_DATA] = 0.0
        out.append(m)
    return out


def gen_batches(vocab: int):
    data = lm_batches(markov_tokens(50_000, vocab=vocab, seed=0),
                      TRAIN_BATCH, TRAIN_SEQ, seed=1)
    return [next(data) for _ in range(GEN_STEPS)]


def gen_twin_cfg():
    return dataclasses.replace(get_config(SERVE_ARCH).reduced(),
                               n_layers=GEN_TWIN_LAYERS)


def gen_state(cfg, tc, mesh, gen, device):
    return place_general_state(init_state(
        gen, cfg, tc, max_pos=TRAIN_SEQ + 1, n_agents=GEN_DATA,
        device=device, mesh=mesh), mesh, cfg)


def state_bytes(state) -> int:
    return sum(l.numel() * l.element_size() for k in ("params", "opt",
                                                      "ledger", "err")
               if k in state for l in tree_flatten(state[k])[0])


def agreed_over(mesh, tree, axes) -> bool:
    """Whether ``tree``'s bits are the same on every rank of ``axes``."""
    lo = torch.tensor([param_checksum(tree)], dtype=torch.int64,
                      device=mesh.device)
    hi = lo.clone()
    g = mesh.group(axes)
    torch.distributed.all_reduce(lo, op=torch.distributed.ReduceOp.MIN,
                                 group=g)
    torch.distributed.all_reduce(hi, op=torch.distributed.ReduceOp.MAX,
                                 group=g)
    return int(lo) == int(hi)


def gen_meta_count(mode: str, rank: int, cfg=None, tc=None):
    """The last step of 19's mode (20b's with ``cfg`` and ``tc``) on
    ``rank`` of a recording mesh data 2 x model 2, on the meta device:
    (op table, bytes of the placed state)."""
    cfg = cfg or spmd_cfg()
    tc = tc or gen_tc(mode, twin=False)
    mesh = RecordingMesh((GEN_DATA, GEN_MODEL), ("data", "model"), rank=rank)
    state = gen_state(cfg, tc, mesh, None, "meta")
    state["step"] = torch.tensor(GEN_STEPS - 1, dtype=torch.int32)
    step = make_general_step(cfg, tc, mesh)
    _, cnt = counted(step, state, lm_batch_meta(TRAIN_BATCH, TRAIN_SEQ, cfg),
                     gen_masks(mode)[-1])
    return cnt.table(), state_bytes(state)


def gen_rank_run(mesh, mode, twin, cfg=None, tc=None):
    """One mode of 19 (20b's with ``cfg`` and ``tc``) on this rank:
    (losses, seconds per step, the last step's op table, bytes placed,
    identical per tp block over dp, whole leaves identical over all
    ranks, the most bytes allocated, the gathered parameters (twin))."""
    dev = mesh.device
    cfg = cfg or (gen_twin_cfg() if twin else spmd_cfg())
    tc = tc or gen_tc(mode, twin)
    torch.cuda.reset_peak_memory_stats(dev)
    gen = (torch.Generator() if twin
           else torch.Generator(device=dev)).manual_seed(0)
    before = torch.cuda.memory_allocated(dev)
    state = gen_state(cfg, tc, mesh, gen, "cpu" if twin else dev)
    if twin:
        state = {k: mmodel.tree_to(v, dev) if k != "step" else v
                 for k, v in state.items()}
    gc.collect()
    torch.cuda.empty_cache()          # the whole state's blocks, cached
    placed = torch.cuda.memory_allocated(dev) - before
    step = make_general_step(cfg, tc, mesh)
    losses, secs, table = [], [], None
    for t, ((x, y), m) in enumerate(zip(gen_batches(cfg.vocab_size),
                                        gen_masks(mode))):
        last = t == GEN_STEPS - 1
        sync(dev)
        t0 = time.perf_counter()
        with OpCounter() if last and not twin else \
                contextlib.nullcontext() as cnt:
            state, met = step(state, lm_batch(
                x, y, np.ones((TRAIN_BATCH, TRAIN_SEQ), np.float32), dev,
                cfg), m)
            losses.append(float(met["loss"]))
        secs.append(time.perf_counter() - t0)
        if last and not twin:
            table = cnt.table()
    whole = init_model(None, cfg, device="meta", max_pos=TRAIN_SEQ + 1)
    blocks = tree_flatten(state["params"])[0]
    split = [b for b, w in zip(blocks, tree_flatten(whole)[0])
             if b.shape != w.shape]
    kept = [b for b, w in zip(blocks, tree_flatten(whole)[0])
            if b.shape == w.shape]
    out = dict(losses=losses, secs=secs, table=table, placed=placed,
               peak=torch.cuda.max_memory_allocated(dev),
               tp=step.tp_axes, split=len(split),
               same_blocks=agreed_over(mesh, split, "data"),
               same_whole=agreed_over(mesh, kept, ("data", "model")))
    if twin:
        out["params"] = [l.cpu().numpy() for l in tree_flatten(gather_tree(
            state["params"], general_specs(cfg, whole, mesh), mesh))[0]]
    del state, step
    torch.cuda.empty_cache()
    return out


def gen_card_rank(rank, world, device="cuda"):
    """A rank of 19 on the card (gloo, data 2 x model 2)."""
    card_flags()
    mesh = make_test_mesh(data=GEN_DATA, model=GEN_MODEL, device=device)
    out = {}
    for mode in GENERAL_MODES:
        t0 = time.perf_counter()
        out[mode] = gen_rank_run(mesh, mode, twin=False)
        out[mode]["mode_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["twin"] = {mode: gen_rank_run(mesh, mode, twin=True)
                   for mode in GENERAL_MODES}
    out["twin_s"] = time.perf_counter() - t0
    return out


def gen_oracle(mode: str, device="cuda", cfg=None, tc=None):
    """19's f32 twin (20b's with ``cfg`` and ``tc``) in one process: each
    agent's gradient by the port's loss, the rule of ``core.gradagg`` on
    the stacked flat gradients, then the step's clipping, optimizer and
    update. Returns the parameter leaves."""
    cfg = cfg or gen_twin_cfg()
    tc = tc or gen_tc(mode, twin=True)
    opt = make_optimizer(tc)
    state = init_state(torch.Generator().manual_seed(0), cfg, tc,
                       max_pos=TRAIN_SEQ + 1, device="cpu")
    params = mmodel.tree_to(state["params"], device)
    ost = mmodel.tree_to(state["opt"], device)
    loss_fn = make_loss_fn(cfg, tc, 1)
    n, per = GEN_DATA, TRAIN_BATCH // GEN_DATA
    ledger = ts = err = None
    for t, ((x, y), m) in enumerate(zip(gen_batches(cfg.vocab_size),
                                        gen_masks(mode))):
        batch = lm_batch(x, y, np.ones((TRAIN_BATCH, TRAIN_SEQ), np.float32),
                         device, cfg)
        grads, layout = [], None
        for a in range(n):
            _, g = value_and_grad(loss_fn, params, {
                k: v[a * per:(a + 1) * per] for k, v in batch.items()})
            layout = layout_of(g)
            grads.append(layout.flatten(g))
        g = torch.stack(grads)
        rx = torch.from_numpy(m > 0).to(device)
        if mode == "cge":
            keep = gradagg.cge_mask(g, rx, tc.f)
            agg_flat, denom = gradagg.agg_sum(g, keep), keep.sum()
        elif mode == "trimmed":
            agg_flat = gradagg.agg_trimmed_mean(g, rx, tc.f)
            denom = torch.ones((), device=device)
        elif mode == "stale":
            if ledger is None:
                ledger = torch.zeros_like(g)
                ts = torch.full((n,), -1, device=device)
            ts = torch.where(rx, t, ts)
            ledger = torch.where(rx[:, None], g, ledger)
            usable = (t - ts) <= tc.tau
            agg_flat, denom = gradagg.agg_sum(ledger, usable), usable.sum()
        else:
            if err is None:
                err = torch.zeros_like(g)
            xq = g + err
            deq, res = gradagg.quantize_int8(xq)
            agg_flat, denom = gradagg.agg_sum(deq, rx), rx.sum()
            err = torch.where(rx[:, None], res, xq)
        denom = torch.clamp(denom.to(torch.float32), min=1.0)
        agg = layout.unflatten(agg_flat / denom, dtype=torch.float32)
        agg, _ = clip_by_global_norm(agg, tc.clip_norm)
        agg = tree_map(lambda a, p: a.to(p.dtype), agg, params)
        updates, ost = opt.update(agg, ost, params, t)
        params = apply_updates(params, updates, lr_at(tc, t))
    return [l.cpu().numpy() for l in tree_flatten(params)[0]]


def drive_general_tp(device="cuda"):
    """19: the general step tensor-parallel over model on 4 gloo ranks."""
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    oracle = {mode: gen_oracle(mode, device) for mode in GENERAL_MODES}
    t_oracle = time.perf_counter() - t0

    def meta_counts():
        t0 = time.perf_counter()
        out = {(mode, r): gen_meta_count(mode, r) for mode in GENERAL_MODES
               for r in (0, GEN_MODEL)}            # an agent each
        return out, time.perf_counter() - t0

    ex = ThreadPoolExecutor(1)
    counting = ex.submit(meta_counts)
    t0 = time.perf_counter()
    res = run_ranks(gen_card_rank, GEN_DATA * GEN_MODEL, backend="gloo",
                    device=device, timeout=SPMD_TIMEOUT, args=(device,),
                    threads=CORES // (GEN_DATA * GEN_MODEL))
    ranks_s = time.perf_counter() - t0
    dry, t_meta = counting.result()
    ex.shutdown()
    r0 = res[0]
    log(f"  {SERVE_ARCH} at full width, {SPMD_LAYERS} layers, bf16, AdamW, "
        f"the general step on "
        f"data {GEN_DATA} x model {GEN_MODEL} (4 gloo ranks sharing the "
        f"card, {ranks_s:.1f} s with start-up: rank 0's modes " + ", ".join(
            f"{m} {r0[m]['mode_s']:.1f} s" for m in GENERAL_MODES)
        + f", twin {r0['twin_s']:.1f} s; before the ranks, the twin's "
        f"one-process oracle {t_oracle:.1f} s; beside them, the meta counts "
        f"{t_meta:.1f} s), tp axes {r0['cge']['tp']}, "
        f"{r0['cge']['split']} leaves split over model")
    bad = []
    for mode in GENERAL_MODES:
        a = analyze(dry[mode, 0][0])
        log(f"    {mode} ({GEN_WHY[mode]}): s per step (rank 0) "
            + ", ".join(f"{t:.2f}" for t in r0[mode]["secs"])
            + f"; losses {r0[mode]['losses']}; all-reduces a rank "
            f"{a['collective_count']:.0f} ({a['collectives']['all-reduce']:.6e}"
            f" wire bytes), FLOPs {a['flops']:.6e}; state bytes a rank " +
            ", ".join(f"{o[mode]['placed']:,}" for o in res)
            + f" (meta report {dry[mode, 0][1]:,}); identical per tp block "
            f"over dp: {all(o[mode]['same_blocks'] for o in res)}, whole "
            f"leaves over all ranks: {all(o[mode]['same_whole'] for o in res)}")
        for r, o in enumerate(res):
            want, want_bytes = dry[mode, (r // GEN_MODEL) * GEN_MODEL]
            require_same_ops(f"19 {mode} rank {r}", want, o[mode]["table"],
                             keys=("flops",))
            if o[mode]["table"]["collectives"] != want["collectives"]:
                bad.append(f"{mode} rank {r}: collectives "
                           f"{o[mode]['table']['collectives']}, recorded "
                           f"{want['collectives']}")
            if abs(o[mode]["placed"] - want_bytes) > \
                    PLACED_BYTES_REL * want_bytes:
                bad.append(f"{mode} rank {r}: {o[mode]['placed']} B placed, "
                           f"the report says {want_bytes}")
            if not (o[mode]["same_blocks"] and o[mode]["same_whole"]
                    and o[mode]["tp"] == ("model",)
                    and np.isfinite(o[mode]["losses"]).all()):
                bad.append(f"{mode} rank {r}: blocks {o[mode]['same_blocks']}"
                           f", whole {o[mode]['same_whole']}, tp "
                           f"{o[mode]['tp']}, losses {o[mode]['losses']}")
    errs = {}
    for mode in GENERAL_MODES:
        for r, o in enumerate(res):
            tw = o["twin"][mode]
            if not (tw["same_blocks"] and tw["same_whole"]):
                bad.append(f"twin {mode} rank {r}: not identical")
            for got, want in zip(tw["params"], oracle[mode]):
                torch.testing.assert_close(torch.from_numpy(got),
                                           torch.from_numpy(want),
                                           **TWIN_TOL)
            errs[mode] = max(errs.get(mode, 0.0), max(
                float(np.max(np.abs(a - b)))
                for a, b in zip(tw["params"], oracle[mode])))
    log(f"    f32 twin ({GEN_TWIN_LAYERS} layers of reduced {SERVE_ARCH}, "
        f"SGD-momentum, {GEN_STEPS} steps) against the one-process "
        f"core.gradagg oracle: max |param diff| " + ", ".join(
            f"{m} {e:.3e}" for m, e in errs.items())
        + f" (tolerance {TWIN_TOL['atol']:.0e})")
    if bad:
        raise AssertionError("19: " + "; ".join(bad))
    log(f"  phase 19 in {time.perf_counter() - t_all:.1f} s")


# ---------------------------------------------------------------------------
# 20-21. an MoE model tensor- and expert-parallel over "model"


class MoeRun(NamedTuple):
    """What phase 20 (arctic-480b), 21 (deepseek-v2-236b), 22
    (jamba-v0.1-52b), 23 (rwkv6-3b) or 24 (whisper-base) runs (the last
    two without experts: their expert counts None; whisper's prefills and
    train batches carry frame embeddings, ``with_frames``).

    Its a: ``layers`` layers at every published width, all experts,
    served on data 1 x model ``serve_model`` through launch.serve's
    steps, 16c's prompts, ``new_tokens`` new; in f32 with ``f32_experts``
    experts where given.
    Its b: data 2 x model 2 at the published widths, the expert count cut
    to what 4 ranks sharing the card hold: ``placed_experts`` for the
    placed step (AdamW), ``gen_experts`` for the general step's
    ``gen_modes`` (SGD with momentum; its stale and quantized modes hold
    the agent's whole f32 row several times over while it is joined over
    tp), the layers cut to ``train_pattern`` where one is given. The f32
    twins on the reduced config, ``twin_layers`` layers (or b's cut),
    remat: the placed step and the general step's ``twin_modes``;
    ``placed_steps`` placed steps, the last counted (0: counted on the
    meta device only). ``meta_modes``: general modes counted on the meta
    device at ``gen_experts`` (FLOPs, all-reduces, state bytes) but not
    run.
    Its c, where ``one_tokens`` is given: a's prompt 0 alone on b's mesh
    at a's widths and depth, ``one_tokens`` new, in each of a's dtypes:
    ``make_decode_step(..., dp=())``, whose batch of one leaves "data"
    idle and splits each projection's fan-in over it, beside the same
    steps unsplit (``dp`` None)."""
    phase: str
    arch: str
    layers: int
    serve_model: int
    placed_experts: int
    gen_experts: int
    gen_modes: tuple
    twin_modes: tuple
    twin_layers: int = 2
    placed_steps: int = 2
    meta_modes: tuple = ()
    f32_experts: Optional[int] = None
    train_pattern: tuple = ()
    new_tokens: int = GREEDY_NEW
    one_tokens: int = 0

    def cfg(self, experts=None, dtype=None):
        """The arch cut to ``layers`` (and ``experts`` experts; in f32,
        ``f32_experts`` where given), its parameters and compute in
        ``dtype`` where one is given."""
        cfg = get_config(self.arch)
        if experts is None and dtype == "float32":
            experts = self.f32_experts
        moe = (cfg.moe if experts is None or cfg.moe is None
               else dataclasses.replace(cfg.moe, num_experts=experts))
        cfg = dataclasses.replace(cfg, n_layers=self.layers, moe=moe)
        return (cfg if dtype is None else dataclasses.replace(
            cfg, param_dtype=dtype, compute_dtype=dtype))

    def train_cfg(self, experts):
        """b's model: ``cfg(experts)``, its layers cut to
        ``train_pattern`` where one is given."""
        cfg = self.cfg(experts)
        if not self.train_pattern:
            return cfg
        return dataclasses.replace(cfg, layer_pattern=self.train_pattern,
                                   n_layers=len(self.train_pattern))

    def twin_cfg(self):
        """The f32 twins' model: the reduced config at ``twin_layers``
        layers, or cut to ``train_pattern`` as b's is."""
        cfg = get_config(self.arch).reduced()
        if self.train_pattern:
            return dataclasses.replace(cfg, layer_pattern=self.train_pattern,
                                       n_layers=len(self.train_pattern))
        return dataclasses.replace(cfg, n_layers=self.twin_layers)


# arctic: phase 11's cut (1 of 35 layers); 3 x 4 B x 0.89e9 parameters of
# the general step's whole rows at 2 experts, one a rank. To pay for
# phases 21-22 its general step at the published widths runs cge; its
# placed step (22b runs one with GQA and an MoE block at these widths)
# and stale, trimmed and quantized (the whole-row modes) are counted on
# the meta device and run on the twins (and the modes at full width on
# qwen2-0.5b in phase 19)
ARCTIC = MoeRun("20", "arctic-480b", 1, 4, 8, 2, ("cge",),
                GENERAL_MODES, placed_steps=0,
                meta_modes=("stale", "trimmed", "quantized"))
# deepseek-v2: 1 of 60 layers; top-6 needs 6 experts. At 6 the general
# step's whole f32 row is 5.55 GB (the untied 102,400 x 5,120 embedding
# and unembedding are 1.05e9 of its 1.39e9 parameters): the stale and
# quantized modes, ~4x the row a rank at peak (arctic's 20b), would want
# ~90 GB on 4 ranks, so at the published widths the general step runs cge
# and the whole-row mode runs on the twin (its meta count is reported).
# To pay for phases 22-23 its placed step is counted on the meta device
# and runs on the twin, and 21a streams 8 new tokens
DEEPSEEK = MoeRun("21", "deepseek-v2-236b", 1, 4, 8, 6, ("cge",),
                  ("cge", "quantized"), placed_steps=0,
                  meta_modes=("quantized",), new_tokens=8)


def moe_gen_tc(mode: str, twin: bool) -> TrainConfig:
    return dataclasses.replace(gen_tc(mode, twin), optimizer="sgdm",
                               remat_policy="full" if twin else "none")


def barrier(mesh) -> None:
    mesh.all_reduce(torch.zeros(1, device=mesh.device), mesh.axis_names)


def moe_positions(cfg) -> list:
    """The positions of the layer pattern that hold an MoE block."""
    return [p for p in range(cfg.period) if cfg.moe_on_layer(p)]


def expert_bytes(params, cfg) -> int:
    return sum(ffn[k].numel() * ffn[k].element_size()
               for ffn in (params["blocks"][p]["ffn"]
                           for p in moe_positions(cfg))
               for k in ("w_gate", "w_up", "w_down"))


def expert_count(params, cfg) -> int:
    """The experts a stack holds (dimension 1 of ``w_gate``; 0 without
    MoE)."""
    pos = moe_positions(cfg)
    return params["blocks"][pos[0]]["ffn"]["w_gate"].shape[1] if pos else 0


def experts_of(cfg) -> str:
    """``"N experts"`` of an MoE config, ``"no experts"`` otherwise."""
    return (f"{cfg.moe.num_experts} experts" if cfg.moe is not None
            else "no experts")


def moe_decode_batch(tok, cache, i):
    return {"tokens": tok[:, None], "cache": cache,
            "pos": GREEDY_PROMPT_LEN + i}


def moe_meta_decode(run: MoeRun, dtype=None):
    """a's decode step on rank 0 of a recording mesh data 1 x
    ``serve_model``, on the meta device: its op table."""
    cfg = run.cfg(dtype=dtype)
    mesh = RecordingMesh((1, run.serve_model), ("data", "model"))
    params = place_params(init_model(None, cfg, device=META), cfg, mesh)
    cache = place_cache(mmodel.init_cache(
        cfg, GREEDY_PROMPTS, GREEDY_PROMPT_LEN + run.new_tokens,
        device=META), cfg, mesh)
    tok = torch.zeros((GREEDY_PROMPTS,), dtype=torch.int32, device=META)
    _, cnt = counted(make_decode_step(cfg, mesh=mesh), params,
                     moe_decode_batch(tok, cache, 0))
    return cnt.table()


def moe_serve_rank(rank, world, run, prompts, device="cuda", dtypes=(None,)):
    """a on one rank (gloo, data 1 x model ``serve_model``), once for
    each of ``dtypes``, an f32 pass teacher-forced along its stream too."""
    card_flags()
    mesh = make_test_mesh(data=1, model=run.serve_model, device=device)
    return {dt: moe_serve_one(mesh, run, prompts, dt, dt == "float32")
            for dt in dtypes}


@torch.no_grad()
def moe_serve_one(mesh, run, prompts, dtype, gap):
    """a in ``dtype`` on this rank: its blocks drawn by ``init_params``
    (one rank at a time: a whole f32 expert stack is 17.8 GB for
    arctic), the prompts' prefill, the first decode step counted, the
    others timed; with ``gap``, then the rank's logits along its stream
    (rank 0 keeps them)."""
    dev = mesh.device
    cfg = run.cfg(dtype=dtype)
    t0 = time.perf_counter()
    for r in range(mesh.size):
        if r == mesh.rank:
            t1 = time.perf_counter()
            before = torch.cuda.memory_allocated(dev)
            params = init_params(torch.Generator(device=dev).manual_seed(0),
                                 cfg, mesh, device=dev)
            held = torch.cuda.memory_allocated(dev) - before
            torch.cuda.empty_cache()
            draw_s = time.perf_counter() - t1
        barrier(mesh)
    make_s = time.perf_counter() - t0
    prefill = make_prefill_step(cfg, mesh=mesh)
    decode = make_decode_step(cfg, mesh=mesh)
    t0 = time.perf_counter()
    tok, pre = prefill(params, with_frames(
        {"tokens": torch.from_numpy(prompts).to(dev)}, cfg, dev))
    cache = tpc_grow(cfg, pre, len(prompts),
                     GREEDY_PROMPT_LEN + run.new_tokens, mesh)
    del pre
    out = [tok]
    (tok, _), cnt = counted(decode, params, moe_decode_batch(tok, cache, 0))
    out.append(tok)
    sync(dev)
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(1, run.new_tokens - 1):
        tok, _ = decode(params, moe_decode_batch(tok, cache, i))
        out.append(tok)
    sync(dev)
    ms = (time.perf_counter() - t0) / (run.new_tokens - 2) * 1e3
    # for scale: one all-reduce of a decode step's (B, d) over model here
    x = torch.zeros((len(prompts), cfg.d_model), dtype=torch.bfloat16,
                    device=dev)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(20):
        mesh.all_reduce(x, ("model",))
    sync(dev)
    ar_ms = (time.perf_counter() - t0) / 20 * 1e3
    toks = torch.stack(out, 1).cpu().numpy()
    forced = None
    if gap:
        forced = tpc_teacher_forced(params, prompts, toks, dev, cfg,
                                    mesh=mesh).cpu()
    res = dict(tokens=toks, decode_ms=ms, allreduce_ms=ar_ms,
               table=cnt.table(), held=held, make_s=make_s, draw_s=draw_s,
               prefill_s=prefill_s, expert_bytes=expert_bytes(params, cfg),
               experts=expert_count(params, cfg),
               forced=forced if mesh.rank == 0 else None)
    del params, cache
    torch.cuda.empty_cache()
    return res


def moe_prompts(run: MoeRun):
    """a's prompts: 16c's, drawn over the arch's vocabulary."""
    return np.random.default_rng(0).integers(
        0, run.cfg().vocab_size, (GREEDY_PROMPTS, GREEDY_PROMPT_LEN)
        ).astype(np.int32)


def moe_serve_checks(run, device, dtype, streams_checked, prompts, res,
                     dry, ranks_s):
    """a's checks in ``dtype`` on the ranks' results ``res`` and the meta
    count ``dry``."""
    tag = run.phase + "a" + ("" if dtype is None else f" ({dtype})")
    cfg = run.cfg(dtype=dtype)
    gap = res[0]["forced"] is not None
    t0 = time.perf_counter()
    one_tok, one_ms, params = tpc_one_rank(prompts, device, cfg,
                                           new=run.new_tokens)
    whole = expert_bytes(params, cfg)
    streams = res[0]["tokens"]
    lg = tpc_teacher_forced(params, prompts, streams, device, cfg)
    del params
    gc.collect()              # tens of GB: nothing may keep it for b
    torch.cuda.empty_cache()
    one_s = time.perf_counter() - t0
    top2 = lg.topk(2, dim=-1).values
    clear = ((top2[..., 0] - top2[..., 1]) > LOGIT_TOL).cpu().numpy()
    agree = lg.argmax(-1).cpu().numpy() == streams
    finite = bool(torch.isfinite(lg).all())
    gaps = None
    if gap:                     # (B, T): the largest |logit| gap a position
        gaps = (res[0]["forced"].to(lg.device) - lg).abs().amax(-1).cpu(
            ).numpy()
    del lg, top2
    a = analyze(dry)
    r0 = res[0]
    enc = (f" + {cfg.encoder_layers} encoder layers, {cfg.encoder_seq} "
           "frames" if cfg.encoder_decoder else "")
    log(f"  {tag}: {run.arch} at full width ({cfg.n_layers} layer{enc}, "
        f"{experts_of(cfg)}, {cfg.param_dtype} from seed 0), "
        f"launch.serve's "
        f"prefill and decode steps on data 1 x model {run.serve_model} ("
        f"{run.serve_model} gloo ranks sharing the card, rank 0 {ranks_s:.1f}"
        f" s for every dtype after start-up: it drew its blocks in "
        f"{r0['make_s']:.1f} s (one rank at a time), prefill and the "
        f"counted step {r0['prefill_s']:.1f} s; then one rank with whole "
        f"parameters {one_s:.1f} s)")
    for r, o in enumerate(res):
        held = (f"{o['experts']} experts, expert bytes "
                f"{o['expert_bytes']:,} of {whole:,} "
                f"({o['expert_bytes'] / whole:.4f}), " if whole else "")
        log(f"    rank {r}: {held}parameters held "
            f"{o['held']:,} B (drawn in {o['draw_s']:.2f} s); "
            f"{o['decode_ms']:.2f} ms per decode step, "
            f"{o['allreduce_ms']:.2f} ms per all-reduce of a step's "
            f"({GREEDY_PROMPTS}, {cfg.d_model}) bf16 alone")
    log(f"    a decode step's rank FLOPs: card {analyze(r0['table'])['flops']:.6e}"
        f", recording mesh (meta) {a['flops']:.6e}; all-reduces a decode "
        f"step {a['collective_count']:.0f} "
        f"({a['collectives']['all-reduce']:.6e} wire bytes); "
        f"{np.mean([o['decode_ms'] for o in res]):.2f} ms per decode step "
        f"against one rank's {one_ms:.2f}")
    if "mamba" in cfg.layer_pattern:
        relay = mamba_relay_bytes(cfg, len(prompts))
        log(f"    of those wire bytes, re-laying the Mamba mixers' "
            f"activations (xz, xh, dt/B/C, delta; counted from their "
            f"shapes) {relay:.6e} "
            f"({relay / a['collectives']['all-reduce']:.4f}); re-laying "
            f"weights 0 (no weight is re-laid)")
    log(f"    streams equal to one rank's greedy tokens: "
        f"{np.array_equal(streams, one_tok)} "
        f"({int((streams == one_tok).sum())} of {streams.size} positions); "
        f"the one-rank argmax along the streams at {int(agree.sum())} of "
        f"{agree.size} positions, {int((~clear).sum())} within the "
        f"{LOGIT_TOL} margin; logits finite: {finite}")
    if gaps is not None:
        big = np.argwhere(gaps > LOGIT_TOL)
        log(f"    rank 0's teacher-forced logits along its stream against "
            f"one rank's: the largest |gap| a position, median "
            f"{np.median(gaps):.4g}, max {gaps.max():.4g}; positions past "
            f"{LOGIT_TOL}: " + (", ".join(
                f"prompt {b} step {t} ({gaps[b, t]:.4g})" for b, t in big)
                or "none"))
        if gaps.max() > F32_LOGIT_TOL:
            raise AssertionError(f"{tag}: logits {gaps.max()} from one "
                                 f"rank's, past {F32_LOGIT_TOL}")
    for r, o in enumerate(res):
        require_same_ops(f"{tag} rank {r}", dry, o["table"], keys=("flops",))
        if o["table"]["collectives"] != dry["collectives"]:
            raise AssertionError(f"{tag} rank {r}: collectives "
                                 f"{o['table']['collectives']}, recorded "
                                 f"{dry['collectives']}")
        if not np.array_equal(o["tokens"], streams):
            raise AssertionError(f"{tag} rank {r}: tokens differ from rank "
                                 "0's")
        if cfg.moe is not None and (
                o["experts"] != cfg.moe.num_experts // run.serve_model
                or o["expert_bytes"] * run.serve_model != whole):
            raise AssertionError(f"{tag} rank {r}: {o['experts']} experts, "
                                 f"{o['expert_bytes']} of {whole} B")
    if not (finite and streams.shape == (GREEDY_PROMPTS, run.new_tokens)
            and (agree[clear].all() or not streams_checked)):
        raise AssertionError(f"{tag}: a stream leaves one rank's greedy "
                             "argmax at a clear margin, or the logits are "
                             "not finite")


MOE_DATA, MOE_MODEL = 2, 2


def one_meta_decode(run: MoeRun, dtype=None):
    """c's split decode step (a batch of one, ``dp=()``) on rank 0 of a
    recording mesh data 2 x model 2, on the meta device: its op
    table."""
    cfg = run.cfg(dtype=dtype)
    mesh = RecordingMesh((MOE_DATA, MOE_MODEL), ("data", "model"))
    params = place_params(init_model(None, cfg, device=META), cfg, mesh)
    cache = place_cache(mmodel.init_cache(
        cfg, 1, GREEDY_PROMPT_LEN + run.one_tokens, device=META), cfg, mesh)
    tok = torch.zeros((1,), dtype=torch.int32, device=META)
    _, cnt = counted(make_decode_step(cfg, mesh=mesh, dp=()), params,
                     moe_decode_batch(tok, cache, 0))
    return cnt.table()


@torch.no_grad()
def one_decode_run(mesh, run, prompts, dtype, gap):
    """c in ``dtype`` on this rank (data 2 x model 2): its blocks by
    ``init_params``, the prefill of a's prompt 0, then ``one_tokens - 1``
    decode steps with "data" idle (``dp=()``: each fan-in split over it)
    and as many unsplit (``dp`` None), each from the prefill's cache, the
    first step of each counted, the others timed; with ``gap``, the
    rank's teacher-forced logits along the split stream, as the split
    step computes them (rank 0 keeps them)."""
    dev = mesh.device
    cfg = run.cfg(dtype=dtype)
    n = run.one_tokens
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         mesh, device=dev)
    prompt = prompts[:1]
    tok0, pre = make_prefill_step(cfg, mesh=mesh)(
        params, {"tokens": torch.from_numpy(prompt).to(dev)})
    out = {}
    for name, dp in (("split", ()), ("unsplit", None)):
        cache = tpc_grow(cfg, pre, 1, GREEDY_PROMPT_LEN + n, mesh)
        decode = make_decode_step(cfg, mesh=mesh, dp=dp)
        (tok, _), cnt = counted(decode, params,
                                moe_decode_batch(tok0, cache, 0))
        toks = [tok0, tok]
        sync(dev)
        t0 = time.perf_counter()
        for i in range(1, n - 1):
            tok, _ = decode(params, moe_decode_batch(tok, cache, i))
            toks.append(tok)
        sync(dev)
        out[name] = dict(tokens=torch.stack(toks, 1).cpu().numpy(),
                         ms=(time.perf_counter() - t0) / (n - 2) * 1e3,
                         table=cnt.table())
        del cache
    forced = None
    if gap:
        forced = tpc_teacher_forced(params, prompt, out["split"]["tokens"],
                                    dev, cfg, mesh=mesh, idle=("data",))
    out["forced"] = (forced.cpu() if forced is not None and mesh.rank == 0
                     else None)
    del params, pre
    torch.cuda.empty_cache()
    return out


def one_decode_rank(rank, world, run, prompts, device="cuda",
                    dtypes=(None,)):
    """c on one rank (gloo, data 2 x model 2), once for each of
    ``dtypes``."""
    mesh = make_test_mesh(data=MOE_DATA, model=MOE_MODEL, device=device)
    return {dt: one_decode_run(mesh, run, prompts, dt, dt == "float32")
            for dt in dtypes}


def one_checks(run, device, dtype, prompts, res, dry, ranks_s):
    """c's checks in ``dtype`` on the ranks' results ``res`` and the meta
    count ``dry`` of the split step: the split stream at one rank's
    greedy argmax (whole parameters, teacher-forced along it) at every
    clear margin, in f32 rank 0's teacher-forced logits within
    ``F32_LOGIT_TOL`` of one rank's, every rank's FLOPs and collectives
    the meta count's op by op, the same tokens on every rank."""
    tag = run.phase + "c" + ("" if dtype is None else f" ({dtype})")
    cfg = run.cfg(dtype=dtype)
    r0 = res[0]
    stream = r0["split"]["tokens"]
    t0 = time.perf_counter()
    params = init_model(torch.Generator(device=device).manual_seed(0), cfg,
                        device=device)
    lg = tpc_teacher_forced(params, prompts[:1], stream, device, cfg)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    one_s = time.perf_counter() - t0
    top2 = lg.topk(2, dim=-1).values
    clear = ((top2[..., 0] - top2[..., 1]) > LOGIT_TOL).cpu().numpy()
    agree = lg.argmax(-1).cpu().numpy() == stream
    finite = bool(torch.isfinite(lg).all())
    gaps = None
    if r0["forced"] is not None:
        gaps = (r0["forced"].to(lg.device) - lg).abs().amax(-1).cpu().numpy()
    del lg, top2
    a, u = analyze(dry), analyze(r0["unsplit"]["table"])
    log(f"  {tag}: {run.arch} ({cfg.n_layers} layers, {cfg.param_dtype}), "
        f"a batch of one ({run.phase}a's prompt 0) on data {MOE_DATA} x "
        f"model {MOE_MODEL}, {run.one_tokens} new tokens: "
        f"make_decode_step(dp=()) leaves data idle and splits each "
        f"projection's fan-in over it (rank 0 {ranks_s:.1f} s for every "
        f"dtype; one rank's teacher-forced logits {one_s:.1f} s)")
    log(f"    a decode step's rank FLOPs: card "
        f"{analyze(r0['split']['table'])['flops']:.6e}, recording mesh "
        f"(meta) {a['flops']:.6e}, unsplit {u['flops']:.6e} "
        f"({a['flops'] / u['flops']:.4f}); all-reduces "
        f"{a['collective_count']:.0f} ({a['collectives']['all-reduce']:.6e}"
        f" wire bytes), unsplit {u['collective_count']:.0f} "
        f"({u['collectives']['all-reduce']:.6e})")
    for r, o in enumerate(res):
        log(f"    rank {r}: {o['split']['ms']:.2f} ms per decode step split "
            f"over data against {o['unsplit']['ms']:.2f} unsplit")
    same = np.array_equal(r0["unsplit"]["tokens"], stream)
    log(f"    the split stream equal to the unsplit one: {same}; at one "
        f"rank's greedy argmax at {int(agree.sum())} of {agree.size} "
        f"positions, {int((~clear).sum())} within the {LOGIT_TOL} margin; "
        f"logits finite: {finite}")
    if gaps is not None:
        log(f"    rank 0's teacher-forced logits along its stream against "
            f"one rank's: the largest |gap| a position, median "
            f"{np.median(gaps):.4g}, max {gaps.max():.4g}")
        if gaps.max() > F32_LOGIT_TOL:
            raise AssertionError(f"{tag}: logits {gaps.max()} from one "
                                 f"rank's, past {F32_LOGIT_TOL}")
    for r, o in enumerate(res):
        require_same_ops(f"{tag} rank {r}", dry, o["split"]["table"],
                         keys=("flops",))
        if o["split"]["table"]["collectives"] != dry["collectives"]:
            raise AssertionError(f"{tag} rank {r}: collectives "
                                 f"{o['split']['table']['collectives']}, "
                                 f"recorded {dry['collectives']}")
        if not np.array_equal(o["split"]["tokens"], stream):
            raise AssertionError(f"{tag} rank {r}: tokens differ from rank "
                                 "0's")
    if not (finite and stream.shape == (1, run.one_tokens)
            and agree[clear].all()):
        raise AssertionError(f"{tag}: the stream leaves one rank's greedy "
                             "argmax at a clear margin, or the logits are "
                             "not finite")


def moe_placed_state(cfg, tc, mesh):
    """b's placed state on this rank: the whole parameters from seed 0,
    cut to this rank's storage blocks, and the optimizer state of the
    blocks (zeros: the blocks of the whole moments, never made)."""
    dev = mesh.device
    specs = tree_specs(abstract_state(cfg, tc, max_pos=TRAIN_SEQ + 1),
                       state_rules(mesh.shape))
    whole = init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                       device=dev, max_pos=TRAIN_SEQ + 1)
    params = shard_tree(whole, specs["params"], mesh)
    del whole
    return ({"params": params, "opt": make_optimizer(tc).init(params),
             "step": torch.zeros((), dtype=torch.int32)}, specs)


def moe_placed_meta(run: MoeRun):
    """b's placed step on rank 0 of a recording mesh data 2 x model 2,
    on the meta device: its op table."""
    cfg, tc = run.train_cfg(run.placed_experts), placed_tc("none")
    mesh = RecordingMesh((MOE_DATA, MOE_MODEL), ("data", "model"))
    state, specs = place_state(abstract_state(cfg, tc,
                                              max_pos=TRAIN_SEQ + 1), mesh)
    step = make_train_step(cfg, tc, moe_groups=PLACED_AGENTS, dp="data",
                           tp="model", param_specs=specs["params"],
                           sizes=mesh.shape, mesh=mesh)
    _, cnt = counted(step, state, lm_batch_meta(TRAIN_BATCH, TRAIN_SEQ, cfg))
    return cnt.table()


def moe_placed_report(run: MoeRun) -> int:
    """b's placed state bytes a rank, as the meta report states them."""
    return state_bytes_per_rank(run.train_cfg(run.placed_experts),
                                placed_tc("none"),
                                {"data": MOE_DATA, "model": MOE_MODEL},
                                max_pos=TRAIN_SEQ + 1)["total"]


def moe_placed_run(mesh, run: MoeRun):
    """b's placed masked steps on this rank (16a's batches and masks,
    AdamW, no remat): bytes placed, seconds per step, the last step's op
    table, the gathered parameters identical on every rank."""
    dev = mesh.device
    cfg, tc = run.train_cfg(run.placed_experts), placed_tc("none")
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    state, specs = moe_placed_state(cfg, tc, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    placed = torch.cuda.memory_allocated(dev) - before
    step = make_train_step(cfg, tc, moe_groups=PLACED_AGENTS, dp="data",
                           tp="model", param_specs=specs["params"],
                           sizes=mesh.shape, mesh=mesh)
    losses, secs, table = [], [], None
    batches = placed_batches(cfg.vocab_size)[:run.placed_steps]
    for i, (x, y, w) in enumerate(batches):
        last = i == run.placed_steps - 1
        sync(dev)
        t0 = time.perf_counter()
        with OpCounter() if last else contextlib.nullcontext() as cnt:
            state, m = step(state, lm_batch(x, y, w, dev, cfg))
            losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
        if last:
            table = cnt.table()
    out = dict(placed=placed, losses=losses, secs=secs, table=table,
               tp=step.placement.tp, peak=torch.cuda.max_memory_allocated(dev),
               report=moe_placed_report(run),
               experts=expert_count(state["params"], cfg))
    del step
    out["same"] = agreed(mesh, gather_tree(state["params"], specs["params"],
                                           mesh))
    del state
    torch.cuda.empty_cache()
    return out


def moe_placed_twin_tc() -> TrainConfig:
    return TrainConfig(mode="masked", optimizer="sgdm", lr=3e-2,
                       remat_policy="full")


def moe_train_rank(rank, world, run, ref_dir, device="cuda"):
    """A rank of b on the card (gloo, data 2 x model 2)."""
    card_flags()
    mesh = make_test_mesh(data=MOE_DATA, model=MOE_MODEL, device=device)
    t0 = time.perf_counter()
    out = {"placed": moe_placed_run(mesh, run) if run.placed_steps else None}
    out["placed_s"] = time.perf_counter() - t0
    gcfg = run.train_cfg(run.gen_experts)
    for mode in run.gen_modes:
        t0 = time.perf_counter()
        out[mode] = gen_rank_run(mesh, mode, False, cfg=gcfg,
                                 tc=moe_gen_tc(mode, False))
        out[mode]["mode_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["placed_twin_same"] = twin_placed(
        mesh, run.twin_cfg(), moe_placed_twin_tc(),
        os.path.join(ref_dir, f"moe{run.phase}_twin_tp.pt"))
    out["twin"] = {mode: gen_rank_run(mesh, mode, True, cfg=run.twin_cfg(),
                                      tc=moe_gen_tc(mode, True))
                   for mode in run.twin_modes}
    out["twin_s"] = time.perf_counter() - t0
    return out


def moe_rank(rank, world, run, prompts, ref_dir, device="cuda",
             dtypes=(None,)):
    """A rank of a (data 1 x ``serve_model``), of c where the run has one
    and then of b (data ``MOE_DATA`` x ``MOE_MODEL``): one spawn of 4
    ranks for the phase. Returns (a's results, b's results, a's seconds,
    c's results or None, c's seconds)."""
    t0 = time.perf_counter()
    serve = moe_serve_rank(rank, world, run, prompts, device, dtypes)
    serve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = (one_decode_rank(rank, world, run, prompts, device, dtypes)
           if run.one_tokens else None)
    one_s = time.perf_counter() - t0
    return (serve, moe_train_rank(rank, world, run, ref_dir, device),
            serve_s, one, one_s)


def drive_moe(run: MoeRun, device="cuda", dtypes=(None,), unchecked=()):
    """a and b from the parent, their ranks one spawn of 4 (a's data 1 x
    ``serve_model`` and b's data 2 x 2 meshes over the same process
    group): b's twins' one-process references first, the meta counts
    beside the ranks. Then a's checks for each of ``dtypes``: the
    one-rank run (whole parameters) and its teacher-forced argmax along
    the ranks' streams, held at every clear margin but for the dtypes in
    ``unchecked``, and in f32 the largest |logit| gap between rank 0's
    teacher-forced logits along its stream and the one rank's, held
    within ``F32_LOGIT_TOL``; then b's checks."""
    if run.serve_model != MOE_DATA * MOE_MODEL:
        raise ValueError(f"{run.arch}: a's {run.serve_model} ranks are not "
                         f"b's {MOE_DATA * MOE_MODEL}")
    prompts = moe_prompts(run)
    t0 = time.perf_counter()
    ref = twin_one_process(run.twin_cfg(), moe_placed_twin_tc(), device)
    oracle = {mode: gen_oracle(mode, device, cfg=run.twin_cfg(),
                               tc=moe_gen_tc(mode, True))
              for mode in run.twin_modes}
    t_ref = time.perf_counter() - t0
    gcfg = run.train_cfg(run.gen_experts)

    def meta_counts():
        t0 = time.perf_counter()
        out = {"placed": moe_placed_meta(run)}
        out.update({(mode, r): gen_meta_count(mode, r, cfg=gcfg,
                                              tc=moe_gen_tc(mode, False))
                    for mode in run.gen_modes + run.meta_modes
                    for r in (0, MOE_MODEL)})
        return out, time.perf_counter() - t0

    gc.collect()
    torch.cuda.empty_cache()        # the ranks need the card
    held = (torch.cuda.memory_allocated(device),
            torch.cuda.memory_reserved(device))
    free, total = torch.cuda.mem_get_info(device)
    log(f"  {run.phase}: before the ranks this process holds {held[0]:,} B "
        f"({held[1]:,} reserved); the card has {free:,} of {total:,} B "
        f"free")
    ex = ThreadPoolExecutor(1)
    serve_counting = [ex.submit(moe_meta_decode, run, dt) for dt in dtypes]
    one_counting = [ex.submit(one_meta_decode, run, dt) for dt in dtypes
                    if run.one_tokens]
    counting = ex.submit(meta_counts)
    # the ranks' allocators map freed blocks back to the card: four
    # processes share it, and a rank's cached but unused blocks (3.5 GB
    # of 16 in a first run) are memory the others cannot have
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t0 = time.perf_counter()
        try:
            res = run_ranks(moe_rank, MOE_DATA * MOE_MODEL,
                            backend="gloo", device=device,
                            timeout=SPMD_TIMEOUT,
                            args=(run, prompts, tmp, device, dtypes),
                            threads=CORES // (MOE_DATA * MOE_MODEL))
        finally:
            if alloc is None:
                del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
        ranks_s = time.perf_counter() - t0
        serve_dry = [c.result() for c in serve_counting]
        one_dry = [c.result() for c in one_counting]
        dry, t_meta = counting.result()
        ex.shutdown()
        twin_err = twin_gap(os.path.join(tmp, f"moe{run.phase}_twin_tp.pt"),
                            ref, device)
    del ref
    serve_s, one_s = res[0][2], res[0][4]
    log(f"  {run.phase}a-{run.phase}b: one spawn of "
        f"{MOE_DATA * MOE_MODEL} gloo ranks, {ranks_s:.1f} s with start-up "
        f"(rank 0's a {serve_s:.1f} s" + (f", c {one_s:.1f} s"
                                         if run.one_tokens else "") + ")")
    t0 = time.perf_counter()
    for dt, dry_dt in zip(dtypes, serve_dry):
        moe_serve_checks(run, device, dt, dt not in unchecked, prompts,
                         [o[0][dt] for o in res], dry_dt, serve_s)
    log(f"  {run.phase}a checked in {time.perf_counter() - t0:.1f} s")
    for dt, dry_dt in zip(dtypes, one_dry):
        t0 = time.perf_counter()
        one_checks(run, device, dt, prompts, [o[3][dt] for o in res],
                   dry_dt, one_s)
        log(f"  {run.phase}c checked in {time.perf_counter() - t0:.1f} s")
    moe_train_checks(run, [o[1] for o in res], dry, t_meta,
                     ranks_s - serve_s - one_s, twin_err, oracle, t_ref)


def moe_train_checks(run: MoeRun, res, dry, t_meta, ranks_s, twin_err,
                     oracle, t_ref):
    """b's checks on the ranks' results ``res``, the meta counts ``dry``,
    the placed twin's gap ``twin_err`` to its one-process reference and
    the general twins' ``oracle``."""
    t_all = time.perf_counter()
    tag = run.phase + "b"
    gcfg = run.train_cfg(run.gen_experts)
    r0 = res[0]
    log(f"  {tag}: {run.arch} at its published widths, {gcfg.n_layers} "
        f"layer(s) ({', '.join(gcfg.layer_pattern)}), "
        f"bf16, on data {MOE_DATA} x model {MOE_MODEL} (4 gloo ranks sharing"
        f" the card, rank 0 {ranks_s:.1f} s after a: its placed steps "
        f"{r0['placed_s']:.1f} s, general modes " + ", ".join(
            f"{m} {r0[m]['mode_s']:.1f} s" for m in run.gen_modes)
        + f", twins {r0['twin_s']:.1f} s; before the ranks, the twins' "
        f"one-process references {t_ref:.1f} s; beside them, the meta "
        f"counts {t_meta:.1f} s)")
    bad = []
    p, a = r0["placed"], analyze(dry["placed"])
    if p is None:
        log(f"    placed masked step on the meta device only (not run: see "
            f"the phase's cut), "
            f"{experts_of(run.train_cfg(run.placed_experts))}, AdamW: "
            f"all-reduces a rank {a['collective_count']:.0f} "
            f"({a['collectives']['all-reduce']:.6e} wire bytes), FLOPs "
            f"{a['flops']:.6e}; state bytes a rank {moe_placed_report(run):,}")
    else:
        log(f"    placed masked step, "
            f"{experts_of(run.train_cfg(run.placed_experts))} "
            f"({p['experts']} a rank), AdamW, 4 agents with 2 masked a step: "
            f"s per step (rank 0) " + ", ".join(f"{t:.2f}" for t in p["secs"])
            + f"; losses {p['losses']}; all-reduces a rank "
            f"{a['collective_count']:.0f} "
            f"({a['collectives']['all-reduce']:.6e} wire bytes), FLOPs "
            f"{a['flops']:.6e}; state bytes a rank " +
            ", ".join(f"{o['placed']['placed']:,}" for o in res)
            + f" (meta report {p['report']:,}); most bytes allocated "
            + ", ".join(f"{o['placed']['peak']:,}" for o in res)
            + "; gathered parameters identical on every rank: "
            f"{all(o['placed']['same'] for o in res)}; tp axes {p['tp']}")
    for r, o in enumerate(res if p is not None else ()):
        q = o["placed"]
        require_same_ops(f"{tag} placed rank {r}", dry["placed"], q["table"],
                         keys=("flops",))
        if q["table"]["collectives"] != dry["placed"]["collectives"]:
            bad.append(f"placed rank {r}: collectives differ from the "
                       "recording mesh's")
        if abs(q["placed"] - q["report"]) > PLACED_BYTES_REL * q["report"]:
            bad.append(f"placed rank {r}: {q['placed']} B placed, the report "
                       f"says {q['report']}")
        if not (q["same"] and q["tp"] == ("model",)
                and np.isfinite(q["losses"]).all()):
            bad.append(f"placed rank {r}: same {q['same']}, tp {q['tp']}, "
                       f"losses {q['losses']}")
    for mode in run.gen_modes:
        a = analyze(dry[mode, 0][0])
        log(f"    general {mode} ({GEN_WHY[mode]}), {experts_of(gcfg)}, "
            f"SGD-momentum: s per step (rank 0) " + ", ".join(
                f"{t:.2f}" for t in r0[mode]["secs"])
            + f"; losses {r0[mode]['losses']}; all-reduces a rank "
            f"{a['collective_count']:.0f} ({a['collectives']['all-reduce']:.6e}"
            f" wire bytes), FLOPs {a['flops']:.6e}; state bytes a rank " +
            ", ".join(f"{o[mode]['placed']:,}" for o in res)
            + f" (meta report {dry[mode, 0][1]:,}); most bytes allocated "
            + ", ".join(f"{o[mode]['peak']:,}" for o in res)
            + f"; identical per tp block over dp: "
            f"{all(o[mode]['same_blocks'] for o in res)}, whole leaves over "
            f"all ranks: {all(o[mode]['same_whole'] for o in res)}")
        for r, o in enumerate(res):
            want, want_bytes = dry[mode, (r // MOE_MODEL) * MOE_MODEL]
            require_same_ops(f"{tag} {mode} rank {r}", want,
                             o[mode]["table"], keys=("flops",))
            if o[mode]["table"]["collectives"] != want["collectives"]:
                bad.append(f"{mode} rank {r}: collectives differ from the "
                           "recording mesh's")
            if abs(o[mode]["placed"] - want_bytes) > \
                    PLACED_BYTES_REL * want_bytes:
                bad.append(f"{mode} rank {r}: {o[mode]['placed']} B placed, "
                           f"the report says {want_bytes}")
            if not (o[mode]["same_blocks"] and o[mode]["same_whole"]
                    and o[mode]["tp"] == ("model",)
                    and np.isfinite(o[mode]["losses"]).all()):
                bad.append(f"{mode} rank {r}: blocks {o[mode]['same_blocks']}"
                           f", whole {o[mode]['same_whole']}, tp "
                           f"{o[mode]['tp']}, losses {o[mode]['losses']}")
    row = 4 * sum(l.numel() for l in tree_flatten(init_model(
        None, gcfg, device=META, max_pos=TRAIN_SEQ + 1))[0])
    for mode in run.meta_modes:
        a = analyze(dry[mode, 0][0])
        log(f"    general {mode} on the meta device only (not run: see the "
            f"phase's cut), {experts_of(gcfg)}: all-reduces a rank "
            f"{a['collective_count']:.0f} ({a['collectives']['all-reduce']:.6e}"
            f" wire bytes), FLOPs {a['flops']:.6e}; state bytes a rank "
            f"{dry[mode, 0][1]:,}, the agent's whole f32 row {row:,} B")
    errs = {}
    for mode in run.twin_modes:
        for r, o in enumerate(res):
            tw = o["twin"][mode]
            if not (tw["same_blocks"] and tw["same_whole"]):
                bad.append(f"twin {mode} rank {r}: not identical")
            for got, want in zip(tw["params"], oracle[mode]):
                torch.testing.assert_close(torch.from_numpy(got),
                                           torch.from_numpy(want),
                                           **TWIN_TOL)
            errs[mode] = max(errs.get(mode, 0.0), max(
                float(np.max(np.abs(x - y)))
                for x, y in zip(tw["params"], oracle[mode])))
    log(f"    f32 twins (reduced {run.arch}, {run.twin_cfg().n_layers} "
        f"layers, {experts_of(run.twin_cfg())}, SGD-momentum, "
        f"remat): "
        f"the placed step against the one-process make_train_step "
        f"{twin_err:.3e}, identical on every rank: "
        f"{all(o['placed_twin_same'] for o in res)}; the general step "
        f"against the one-process core.gradagg oracle " + ", ".join(
            f"{m} {e:.3e}" for m, e in errs.items())
        + f" (tolerance {TWIN_TOL['atol']:.0e})")
    if not all(o["placed_twin_same"] for o in res):
        bad.append("placed twin: not identical on every rank")
    if bad:
        raise AssertionError(f"{tag}: " + "; ".join(bad))
    log(f"  {tag} checked in {time.perf_counter() - t_all:.1f} s")


# jamba: 22a one period (8 layers: 7 Mamba, 1 GQA, 4 MoE blocks) at
# 26.6 GB in bf16 with all 16 experts, 6.7 GB a rank at model 4; its f32
# pass at 4 experts (one a rank; 19.4 GB whole, where 16 would be 53 GB
# on the card beside the ranks). Its decode step is 60 gloo all-reduces
# (~0.4-0.7 s in bf16 and f32), so it streams 8 new tokens, and only
# the f32 pass is teacher-forced on the ranks. 22b at the published
# widths, the period cut to its positions 4-5 (a GQA layer with a dense
# MLP, a Mamba layer with an MoE block): at 8 layers and 2 experts its
# 3.43e9 parameters would want ~69 GB on 4 ranks for the placed step
# with SGD, ~89 with AdamW and ~96 for cge (meta counts, peak
# temporaries beside state); at 2 layers the placed step runs 4 experts
# (AdamW, ~10 GB a rank), cge 2 (~9 GB a rank), quantized (~19 GB a
# rank) is counted on the meta device and runs on the twins (reduced
# jamba, cut as 22b is)
JAMBA = MoeRun("22", "jamba-v0.1-52b", 8, 4, 4, 2, ("cge",),
               ("cge", "quantized"), placed_steps=1,
               meta_modes=("quantized",), f32_experts=4,
               train_pattern=("attn", "mamba"), new_tokens=8)


def mamba_relay_bytes(cfg, rows: int) -> int:
    """Wire bytes a rank of one decode step's Mamba re-layouts (ring
    convention: twice each all-reduce's payload): every Mamba layer
    gathers ``xz`` (2 di), ``xh`` (di) and ``x_proj``'s products (dt_rank
    + 2 d_state) in the compute dtype and ``delta`` (di) in f32."""
    ssm = cfg.ssm
    di = ssm.expand * cfg.d_model
    rank = ssm.dt_rank or -(-cfg.d_model // 16)
    es = torch.finfo(getattr(torch, cfg.compute_dtype)).bits // 8
    per = rows * ((3 * di + rank + 2 * ssm.d_state) * es + di * 4)
    n_mamba = cfg.n_layers // cfg.period * cfg.layer_pattern.count("mamba")
    return 2 * per * n_mamba


# rwkv6: 2 of 32 layers (0.51e9 parameters, 1.0 GB in bf16, 2.0 GB in
# f32 whole; every layer is alike); its decode step is 2 x 10 gloo
# all-reduces and two for the embedding and logits, so it streams 8 new
# tokens (16 before 23c) and 23c decodes a batch of one 8 tokens, split
# and unsplit. 23b at the same cut: the placed step (AdamW) and cge run
# at the published widths, the other general modes are counted on the
# meta device and quantized runs on the twins. At 4 layers the phase
# took 89.8-115.1 s, past its share of the 1,200 s
RWKV = MoeRun("23", "rwkv6-3b", 2, 4, None, None, ("cge",),
              ("cge", "quantized"), placed_steps=1,
              meta_modes=("stale", "trimmed", "quantized"), new_tokens=8,
              one_tokens=8)


# whisper-base: every published width at full depth (6 encoder and 6
# decoder layers, 114,758,656 parameters, 1,500 frames), 2 of 8 heads
# and 128 of 512 columns a rank at model 4; its decode step is 9 gloo
# all-reduces a layer (self- and cross-attention 4 each, the MLP 1) and
# one for the embedding, so it streams 8 new tokens. 24b at the same
# widths and depth: the placed step (AdamW) and cge run, stale, trimmed
# and quantized are counted on the meta device, cge and quantized run on
# the f32 twins (reduced whisper-base, 2 + 2 layers). Every train batch
# and prefill carries frame embeddings drawn from seed 0
WHISPER = MoeRun("24", "whisper-base", 6, 4, None, None, ("cge",),
                 ("cge", "quantized"), placed_steps=1,
                 meta_modes=("stale", "trimmed", "quantized"), new_tokens=8)


def drive_arctic(device="cuda"):
    """20a-20b: arctic-480b."""
    t0 = time.perf_counter()
    drive_moe(ARCTIC, device)
    log(f"  phase 20 in {time.perf_counter() - t0:.1f} s")


def drive_deepseek(device="cuda"):
    """21a-21b: deepseek-v2-236b, its MLA over "model" beside its
    experts. 21a runs in bf16 (times, counts, bytes; the streams against
    one rank's argmax reported: in bf16 a rounding difference can flip
    one of top-6-of-160 routing's near ties, which moves a logit past
    the margin) and again in f32 at the same widths, where the streams
    are held to one rank's argmax at every clear margin and the logits
    within ``F32_LOGIT_TOL`` (16 new tokens, teacher-forced on the ranks
    in f32 only, to pay for phase 22)."""
    t0 = time.perf_counter()
    drive_moe(DEEPSEEK, device, dtypes=(None, "float32"), unchecked=(None,))
    log(f"  phase 21 in {time.perf_counter() - t0:.1f} s")


def drive_jamba(device="cuda"):
    """22a-22b: jamba-v0.1-52b, its Mamba mixers over "model" beside its
    attention heads and experts. 22a in bf16 (times, counts, bytes; the
    streams against one rank's argmax reported: top-2 routing's near ties
    can flip in bf16) and again in f32 at 4 experts, where the streams
    are held to one rank's argmax at every clear margin and the logits
    within ``F32_LOGIT_TOL``."""
    t0 = time.perf_counter()
    drive_moe(JAMBA, device, dtypes=(None, "float32"), unchecked=(None,))
    log(f"  phase 22 in {time.perf_counter() - t0:.1f} s")


def drive_rwkv(device="cuda"):
    """23a-23b: rwkv6-3b, its time and channel mixes over "model". 23a in
    bf16 and again in f32 in the same ranks; in both the streams are held
    to one rank's argmax at every clear margin (no routing to flip), in
    f32 the logits within ``F32_LOGIT_TOL`` of one rank's too."""
    t0 = time.perf_counter()
    drive_moe(RWKV, device, dtypes=(None, "float32"))
    log(f"  phase 23 in {time.perf_counter() - t0:.1f} s")


def drive_whisper(device="cuda"):
    """24a-24b: whisper-base, its encoder, self- and cross-attention and
    MLPs over "model". 24a in bf16 and again in f32 in the same ranks; in
    both the streams are held to one rank's argmax at every clear margin
    (no routing to flip), in f32 the logits within ``F32_LOGIT_TOL`` of
    one rank's too."""
    t0 = time.perf_counter()
    drive_moe(WHISPER, device, dtypes=(None, "float32"))
    log(f"  phase 24 in {time.perf_counter() - t0:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    card_flags()

    log("== 1. card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {name}")
    mem_rate, f32_rate, bf16_rate = card_peaks(name)

    log("== 2. build")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(BUILDS)) as ex:    # one nvcc per source
        outs = list(ex.map(_build.build, BUILDS))
    log(f"  built {', '.join(f'csrc/{b}.cu' for b in BUILDS)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for _, out in outs:
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("  " + line.strip())
    log("  flash_wgmma_kernel dynamic shared memory per block: " + ", ".join(
        f"D = Dv = {d}: {fattn.wgmma_smem_bytes(d, d)} B"
        for d in (64, 128, 192, 256)))

    log("== 3. kernels vs plain forms")
    errs = check_kernels()
    errs["paged_flash_decode"] = check_decode_kernel()
    timing = time_kernels(mem_rate, f32_rate)
    time_many_agents(mem_rate)
    timing["paged_flash_decode"] = time_decode_kernel(mem_rate, f32_rate)

    log("== 3c. flash attention and the CGE norm kernels vs plain forms")
    t0 = time.perf_counter()
    errs["flash_attention"] = check_flash_kernel()
    errs.update(check_cge_norm_kernels())
    timing.update(time_new_kernels(mem_rate, f32_rate, bf16_rate))
    log(f"  phase 3c in {time.perf_counter() - t0:.1f} s")

    log("== 4. main path: AsyncDGDServer + LeNet, device backend")
    counts, data = drive_main_path(half=5)

    log("== 5. where the time goes")
    where_time_goes(data)
    where_quantized_time_goes(data)

    log(f"== 6. serving path: ServeEngine, {SERVE_ARCH} at full width, bf16")
    counts["paged_flash_decode"], params, _ = drive_serving()

    log("== 7. where the serving time goes")
    where_serving_time_goes(params)

    log(f"== 8. kernels API at full width: {SERVE_ARCH} activations and "
        "parameter tree, LeNet keep-set")
    counts.update(drive_kernels_api(params, data))

    log("== 9. the simulator: 13 scenarios, train (host backend, then two "
        "on the device backend) and serve")
    for k, c in drive_simulator().items():
        counts[k] += c

    log(f"== 10. the e2e harness: {E2E_REPLICAS} {SERVE_ARCH} replicas at "
        "full width")
    e2e_counts, fleet = drive_e2e(params)
    for k, c in e2e_counts.items():
        counts[k] += c

    # phase 6's weights and phase 10's fleet (about 1 GB) stay on the
    # card through phase 11 for phases 12-14
    log("== 11. the other model families at full width: jamba, deepseek-v2, "
        "arctic, rwkv6, qwen2-vl served; whisper and the CPU twins")
    for k, c in drive_families().items():
        counts[k] += c

    log(f"== 12. the prefix cache: {SERVE_ARCH} at full width, bf16")
    t0 = time.perf_counter()
    c12, _, _ = drive_prefix(params, serve_cfg())
    log(f"  phase 12 in {time.perf_counter() - t0:.1f} s")

    log(f"== 13. fleet control and checkpoint rejoin: {E2E_REPLICAS} "
        f"{SERVE_ARCH} replicas at full width")
    c13, _, _ = drive_fleet(params, fleet)

    log(f"== 14. wall-clock chaos: {WALLCLOCK_N} of the replicas on real "
        "threads and timers")
    c14, _, _ = drive_wallclock(fleet)
    for c in (c12, c13, c14):
        counts["paged_flash_decode"] += c["paged_flash_decode"]
    del params, fleet
    torch.cuda.empty_cache()

    t15 = time.perf_counter()
    log(f"== 15a. training: TrainLoop, {SERVE_ARCH} at full width, one "
        "process")
    drive_train()
    log(f"== 15b-15c. the sharded server and the general train step on "
        f"{SPMD_RANKS} ranks")
    c15, _ = drive_spmd_server_and_step()
    log(f"== 15d. tensor-parallel decode on {TP_RANKS} ranks")
    c15["paged_flash_decode"] = drive_tp_decode()
    for k, c in c15.items():
        counts[k] += c
    log(f"  phase 15 in {time.perf_counter() - t15:.1f} s, kernel launches "
        f"{c15}")

    t16 = time.perf_counter()
    log(f"== 16a-16b, 16d. the placed (FSDP) masked step on {SPMD_RANKS} "
        f"ranks")
    placed_collectives = drive_placed()
    log("== 16c. launch.serve: greedy_generate and the serving steps")
    c16 = {"paged_flash_decode": drive_launch_serve()}
    log("== 16e. the example twins on the card")
    for k, c in drive_examples().items():
        c16[k] = c16.get(k, 0) + c
    for k, c in c16.items():
        counts[k] += c
    log(f"  phase 16 in {time.perf_counter() - t16:.1f} s, kernel launches "
        f"{c16}")

    t17 = time.perf_counter()
    log("== 17. the dry run (launch.dryrun, launch.hlo_analysis) against "
        "the card")
    drive_dryrun(placed_collectives, bf16_rate)
    log(f"  phase 17 in {time.perf_counter() - t17:.1f} s")

    log("== 18. tensor-parallel compute over model: the placed step and "
        "launch.serve's steps on data 2 x model 2")
    drive_tp_compute()

    log("== 19. the general step tensor-parallel over model: cge, stale, "
        "trimmed, quantized on data 2 x model 2")
    drive_general_tp()

    log("== 20. arctic-480b tensor- and expert-parallel over model: "
        "launch.serve's steps on data 1 x model 4, the placed and the "
        "general step on data 2 x model 2")
    drive_arctic()

    log("== 21. deepseek-v2-236b tensor- and expert-parallel over model, "
        "its MLA split: launch.serve's steps on data 1 x model 4, the "
        "placed and the general step on data 2 x model 2")
    drive_deepseek()

    log("== 22. jamba-v0.1-52b tensor- and expert-parallel over model, its "
        "Mamba mixers split: launch.serve's steps on data 1 x model 4, the "
        "placed and the general step on data 2 x model 2")
    drive_jamba()

    log("== 23. rwkv6-3b tensor-parallel over model, its time and channel "
        "mixes split: launch.serve's steps on data 1 x model 4, the placed "
        "and the general step on data 2 x model 2")
    drive_rwkv()

    log("== 24. whisper-base tensor-parallel over model, its encoder and "
        "cross-attention split: launch.serve's steps on data 1 x model 4, "
        "the placed and the general step on data 2 x model 2")
    drive_whisper()

    log("== 25. result")

    rows = [dict(name=k, route="cuda", source=SOURCE[k], replaces=REPLACES[k],
                 launches=counts[k], max_abs_err=errs[k],
                 ms=timing[k]["ms"], plain_ms=timing[k]["plain_ms"],
                 bound_ms=timing[k]["bound_ms"],
                 bound_by=timing[k]["bound_by"],
                 library_ms=timing[k]["library_ms"]) for k in REPLACES]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
