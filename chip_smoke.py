#!/usr/bin/env python3
"""Run the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py            # everything, on cuda:0

Phases, each of which fails the run (non-zero exit, no result line):

1. device  -- needs ``torch.cuda.is_available()``; prints the card's name
   and power limit as ``nvidia-smi`` reports them; turns TF32 off.
2. build   -- compiles every kernel of ``src/repro_torch/kernels/csrc`` with
   ``nvcc`` (one process per source, all at once), and prints ``ptxas -v``'s
   registers, shared memory and spills of each ``fused_wgmma_kernel``,
   ``decode_kernel``, ``fused_ffma_kernel``, ``f32_narrow_kernel`` and
   ``f32_short_k_kernel``.
3. kernels -- calls each kernel at the qwen25-7b serving shapes (decode:
   N=8 rows, M=1; prefill: N=1, M=256; a prefill chunk, ``chunk``: N=1,
   M=CHUNK=64, bf16; r=16; plus a ragged pack of ranks (8, 16); and the
   tune_serve drains' decode rows, ``decode_r128``: N=8, M=1 at the pool's
   rank bucket r=128, bf16) and at its
   training shapes (N=2 adapters, M=1024 tokens each,
   r=16: the forward calls, the four backward cases of ``packed_matmul``,
   the fused dx reading W^T in place, and ``fused_matmul_q`` on int8 and nf4
   codes, which must also be bit-equal to the dense kernel on the
   dequantized W; ``fused_matmul_q`` also at the decode shapes), in bf16 and
   f32, and ``packed_matmul``'s training calls (xA, xAB, backward cases 2
   and 4) at the sweep's shapes in bf16 (each same-rank segment of each
   job the sweep phase plans: N, M = rows per adapter x 512 and r of that
   segment, r 8-128, and likewise each of the online plan's segments, M
   up to 4,096, and the multihost phase's two jobs, ``multihost``: N = 2 x
   M = 512 at r = 8 and at r = 16), and in f32 at the launcher's shapes (phase 11's pack:
   N = 1 x M = 1,024 at r = 8 and at r = 16; the fused forward and dx,
   and ``packed_matmul``'s xA, xAB and cases 2 and 4), and in bf16 at the
   training shapes of starcoder2-7b, gemma3-1b, minicpm3-4b,
   mamba2-370m, qwen3-moe-30b-a3b and jamba-v0.1-52b (N = 2 x M = 1,024, r = 16:
   ``packed_matmul``'s xA, xAB and cases 2 and 4, the fused forward and
   dx; cases ``train_starcoder2``, ``train_gemma3``, ``train_minicpm3``,
   ``train_mamba2``: zx 1,024 -> 4,096 and out 2,048 -> 1,024,
   ``train_qwen3_moe``: q 2,048 -> 4,096, k/v 2,048 -> 512, o 4,096 ->
   2,048; jamba's two kinds of layer, ``train_jamba_ssd``: zx 4,096 ->
   16,384 and out 8,192 -> 4,096, ``train_jamba_attn``: q/o 4,096 ->
   4,096, k/v 4,096 -> 1,024) and at the decode rows of gemma3-1b,
   minicpm3-4b, mamba2-370m, qwen3-moe-30b-a3b and jamba-v0.1-52b
   (``decode_gemma3``: d = 1,152, k/v 256 wide; ``decode_minicpm3``;
   ``decode_mamba2``; ``decode_qwen3_moe``; ``decode_jamba_ssd``,
   ``decode_jamba_attn``),
   and at command-r-35b's widths (d 8,192, k/v 1,024, d_ff 22,528):
   ``fused_matmul_q`` on int8 codes at the training shapes with the dx its
   backward runs (``train_command_r``), on int8 and nf4 codes at 8 decode
   rows (``decode_command_r``), and on nf4 codes under an f32 x at the
   launcher's segments (``launcher_command_r``: N = 1 x M = 512 at r = 8
   and 16); holds each against its plain version, and times
   kernel, plain
   version and one PyTorch library call (or the named composition where no
   single call exists) with CUDA events. At the decode shapes the delta's
   two passes also run as one ``packed_matmul_pair`` call (call "pair",
   against two ``torch.bmm`` calls). Each row carries the ``path`` its
   plan took (fused: ``decode``, ``wgmma``, ``ffma`` or ``split3``, from
   ``csrc/fused.cuh``'s plan; ``packed_matmul``: ``decode``, ``mma``,
   ``f32skinny`` or ``fma``, ``packed_matmul_path``), ``device_ms`` and
   ``library_device_ms``
   (a CUDA graph of 20 calls replayed, 5 for a row whose call takes over
   2 ms: the host out of the loop; the
   library yardstick of ``fused_matmul_q`` dequantizes W inside the
   graph) and ``host_us`` and ``library_host_us`` (host time per call, not
   synchronised). The run fails if a bf16 training-shape row of
   ``fused_matmul`` or ``fused_matmul_q`` (the families' too) is off
   ``wgmma``, an f32 one or
   an f32 launcher-shape fused row off ``ffma`` (``csrc/ffma.cuh``'s tiled
   FFMA kernel), a bf16 decode
   row of either or of ``packed_matmul`` is off ``decode``, a bf16
   training row of xA, xAB, case 2 or case 4, or a bf16 prefill or chunk
   row, of ``packed_matmul`` is off ``mma`` (a chunk row of ``fused_matmul``
   off ``wgmma``), or such an f32 row, or an f32
   launcher-shape one, off ``f32skinny`` (``csrc/fskinny.cuh``'s streaming
   FFMA kernels). Then the sync check: ragged
   ``packed_lora_delta`` and ``fused_lora_linear`` (ranks out of order, and
   sorted), forward and backward, under
   ``torch.cuda.set_sync_debug_mode("error")``, their output and LoRA
   gradients ``torch.equal`` to the gather/scatter formulation's.
4. command_r -- command-r-35b (40 layers, d 8,192, GQA 64/8, d_ff 22,528,
   vocab 256,000, tied) at full width and depth, whose bf16 base (60.6 GB)
   does not fit beside a step. It runs right after the kernel phase, with
   no base resident and the allocator's cache fresh: its train step peaks
   near 68 GB, and the leftovers of the later phases fragment the cache
   past what is left. Its int8 and nf4 bases are built by
   ``init_model(..., quant=)`` layer by layer (the dense tree never
   exists), each held ``torch.equal`` to
   dense-then-quantize at full width cut to 2 layers, and each build's own
   peak held under CR_BUILD_PEAK. On int8, ``make_packed_step`` under
   impl="auto" and "fused" on the train phase's pack (step 1 against the
   plain path to the train phase's limits, then CR_TRAIN_STEPS = 2 steps
   whose counts must move; every ``fused_matmul_q`` call on "wgmma", every ``packed_matmul``
   call on "mma"; the steps' own peak within [1, C3_SLACK] of
   ``job_mem_bytes`` priced at the tree's storage and dense dtype: ROADMAP
   C6);
   8 requests through ``ServeEngine(base_dtype=...)`` on int8 under fused
   and auto and on nf4 under fused (``fused_matmul_q`` must launch on
   "decode"), prefill logits and CR_SERVE_STEPS = 2 teacher-forced decode
   steps held against the plain path at LOGIT_TOL; then ``launch/train.py --arch command-r-35b
   --quant nf4 --impl fused`` (an f32 x on nf4 codes: every
   ``fused_matmul_q`` and dx call on "ffma", finite losses, its own peak
   within [1, C3_SLACK] of its own ``CostModel``'s price: the nf4 codes,
   the f32 embedding, f32 activations).
4b. moe   -- qwen3-moe-30b-a3b (48 layers, d 2,048, GQA 32/4, 128 experts
   of d_ff 768, top-8 on every layer, capacity factor 1.25, vocab
   151,936) at full width and depth on a bf16 base (61.06 GB, the router
   f32) built by ``init_model`` on the card right after command_r, with
   nothing else resident: the "ep" dispatch against the dense oracle on
   one full-width layer (384 tokens, nothing dropped; f32 and bf16); the
   train phase's pack at 256 tokens through ``make_packed_step`` under
   impl="auto" and "fused" with the aux loss (step 1 against the plain
   path: the bf16 loss at 48 layers, the f32 gradients on the first 2
   layers, MOE_F32_LAYERS:
   an f32 copy of the base would be 122 GB; then 2 steps whose counts must
   move); the pack's routing (pairs dropped at capacity 1.25 by layer and
   by row, the share of top-8 choices the kernel and plain paths share by
   layer); a ``make_train_step`` call with no host wait; 8 requests
   through ``ServeEngine.serve`` under auto and fused (prompts of 64-600
   tokens) with prefill and 4 teacher-forced decode steps held against
   the plain path at LOGIT_TOL; and one captured ``run_local`` job of
   FAMILY_SWEEP_IDS, as the families' (48 layers).
4c. jamba -- jamba-v0.1-52b, the hybrid (32 layers, d 4,096; GQA 32/8 of
   128 on layers 3, 11, 19, 27, SSD with d_state 16 and 128 heads of 64 on
   the others; 16 experts of d_ff 14,336, top-2, on the odd layers, a dense
   SwiGLU of 14,336 on the even ones; vocab 65,536; 102.9 GB of bf16), at
   full width on its first 8 layers, one whole period of its layer pattern
   (1 attention and 7 SSD mixers, 4 MoE and 4 dense FFNs: 26.53 GB of
   bf16), built by ``init_model`` on the card right after the moe phase:
   the train phase's pack at 512 tokens through ``make_packed_step`` under
   impl="auto" and "fused" with the aux loss (step 1 against the plain
   path: the bf16 loss on the 8 layers, the f32 gradients on the first 4
   -- SSD + dense, SSD + MoE, SSD + dense, attention + MoE, a view cut by
   ``cut_decoder`` -- then 2 steps whose counts must move); the pack's
   routing (pairs dropped at capacity 1.25 by MoE layer and by row, the
   top-2 agreement of the kernel and plain paths); a ``make_train_step``
   call with no host wait; 8 requests through ``ServeEngine.serve`` under
   auto and fused (prompts of 200-600 tokens) with prefill and 4
   teacher-forced decode steps held against the plain path at LOGIT_TOL;
   one captured ``run_local`` job of FAMILY_SWEEP_IDS, as the families'.
5. autotune -- ``kernels/autotune.py`` at the launcher's pack (full
   qwen25-7b, ranks 8 and 16, batch 2, seq 512: N = 2 x M = 1,024 at d x d
   and d x d_ff, r = 16): ``tune_for_model(fast=False)`` in f32 (the fused
   kernel's "ffma" path) and ``tune`` at the same shapes in bf16 ("wgmma"),
   each into a fresh cache under ``smoke_out/``. Each candidate (the plan's
   own K split, then every other count the sweep asks of the path) is
   held against the plain version at KERNEL_TOL and must keep its path; one
   ``autotune_candidate`` line each: device ms (CUDA events), the two-pass
   tier's ms, the speedup, FLOP/s and the share of the bound. A second tune
   on each cache must measure nothing.
6. serve   -- full-width qwen25-7b (28 layers, bf16, random weights from a
   seed) cut to its first SERVE_LAYERS = 5 layers (a view; the train,
   sweep and online phases reuse the whole base), 8 published adapters of rank 8 or 16 with non-zero B, 16 requests
   through ``ServeEngine.serve`` under impl="auto" (packed_matmul kernel)
   and impl="fused" (fused kernel). Launch counts are zeroed just before
   each drain and read just after. Then the same 16 requests under each
   impl with ``prefill_chunk=CHUNK`` (64): each prompt streamed in chunks
   between decode steps; every request must return its 32 tokens, the
   chunks' calls must launch on "mma" (auto) / "wgmma" (fused), and the
   record carries TTFT and ITL (p50, p95), launches by path and the share
   of greedy tokens equal to the one-shot drain's. Two prompts' chunked
   prefill logits are held against the one-shot prefill's and against the
   plain path's on the same chunks at LOGIT_TOL (``chunk_gates``).
   Prefill logits and 4 teacher-forced decode steps are held against the
   plain-version path on the same weights. Every drain of the smoke runs
   its decode steps as the engine's CUDA graphs (``ServeEngine``'s
   default on the card); each family's serve, and command-r's, also holds
   one captured step's logits ``torch.equal`` to the eager step's on the
   same inputs and caches (``step_gate``).
6b. serve_captured -- the serve phase's base at its full 28 layers:
   SC_REQUESTS = 8 requests (64-256 prompt tokens, SC_NEW = 16 new) at 8
   rows, r_bucket 16,
   one-shot prefill, under each impl through an eager engine
   (``capture=False``) and a captured one (after two 1-request warm
   drains that capture the greedy and the sampling step): the all-greedy drain,
   then a mixed one (every odd request at temperature 0.8, top-k 50, one
   seed). Fails unless every request returns its 16 tokens, the captured
   drains' tokens equal the eager ones', the captured drain's launch
   counts equal the eager drain's, one captured step's logits equal the
   eager step's (``step_gate``), and dropping the captured engine returns
   the allocated memory to its level before it. Records ITL p50 / p95 /
   p99, TTFT p50, tokens/s and host µs per step, eager and captured side
   by side, and each capture's seconds and pool bytes; then a short fused
   drain on a captured engine runs under ``torch.profiler`` (device busy
   share, device time by kernel).
7. train   -- full-width qwen25-7b cut to its first TRAIN_LAYERS = 5
   layers (a view of the serve phase's bf16 base), a pack of 4 adapters
   of ranks (8, 16, 16, 32) (ragged
   segments of one and of two adapters), seq 512, 4096 tokens per step,
   through ``make_packed_step`` under impl="auto", impl="fused", and
   impl="fused" on an nf4 and on an int8 base. Step 1's per-adapter loss and
   every LoRA gradient are held against the plain path on the same weights
   and batch; then TRAIN_STEPS = 3 steps run with the launch counts zeroed just before and
   read just after (forward and backward counts must both move). One auto,
   one fused and one nf4 step then run under ``torch.profiler``; the auto
   step's record carries ``packed_matmul``'s share of its device time. On
   the dense base (each impl) and on the nf4 base, one ``make_train_step``
   call runs under ``torch.cuda.set_sync_debug_mode("error")`` (after one
   that builds its per-device vectors).

8. sweep   -- the planner-driven sweep on the same base, cut to its first
   SWEEP_LAYERS = 8 layers (a view; planned on that model: 2 jobs, as at
   28 layers; at 7 it plans 3): the 9
   configurations of ``default_search_space(300, seq_len=512)[::37]``
   planned on one card with the ``H100`` cost-model preset, then every job
   run by ``ExecutionEngine.run_local`` through a ``ClusterRunner`` and a
   ``SliceExecutor`` whose cache unit is one captured CUDA graph of the
   whole step (impl="auto", 4 steps per job, every adapter saved to a
   ``CheckpointPool`` under ``smoke_pool/``, removed at the end). Prints
   the plan, each job's predicted and measured seconds per iteration, peak
   allocated memory against the cost model's ``job_mem_bytes``, the graph's
   pool bytes, planned and measured makespan beside ``min_gpu_schedule``'s,
   the step cache's builds and hits, ``packed_matmul``'s launches (zeroed
   just before the run and read just after; a replay counts the launches
   its graph recorded) and a fit of the preset's ``sat_tokens`` /
   ``layer_overhead`` to the measured iterations. Fails unless every
   configuration's adapter is in the pool with a finite loss, each job's
   final losses and adapters equal a ``SliceExecutor(capture=False)`` run
   on the same pack, initial weights and batches (bit for bit, or else the
   losses within LOSS_RTOL), a further pack of the last job's shape (job
   1; the executor keeps one graph) with other learning rates and alphas
   hits the cache and equals its eager run step by step, the launches
   equal what the eager runs' steps launch (a warm-up step and 4 replays a
   job), and extract -> inject -> extract of an adapter is bit-exact on
   the card. The last captured replay of the cache hit and the last eager
   step of that shape run under ``torch.profiler``. Each job's own peak
   allocated memory (the device's peak less what earlier phases left
   allocated, besides the base) must lie within [peak, 1.3 x peak] of the
   cost model's ``job_mem_bytes`` (ROADMAP C3). The runner is a
   ``ServeEngine`` (the ``Runner`` surface: its ``run`` drives an inner
   ``ClusterRunner`` on the sweep's executor), which then serves the pool
   (``tune_serve``): 12 requests of 64-256 prompt tokens and TS_NEW = 16
   new tokens over the 9 adapters (ranks 8-128) at a rank bucket of 128, 8
   rows, 4 adapter slots (each adapter loaded from the pool on a miss),
   every odd request sampled at temperature 0.8, top-k 50; under "auto"
   and "fused": a mixed drain, its repeat under the same seed, an
   all-greedy drain and its repeat, and under "fused" a drain over the
   adapters ``publish``ed from the pool. Fails unless every request
   returns 16 in-vocabulary tokens, the first drain misses >= 9 times and
   evicts, the impl's kernel launches on "decode", the greedy rows equal
   the all-greedy drain's and the sampled ones their repeat (as far as an
   all-greedy drain repeats itself), the published drain equals the
   miss-loaded one, 16,384 draws from each of 2 rows of the base's
   logits stay in the top-k set within a total variation of 0.05 of the
   exact masked softmax, and ``merge_model`` of the largest-rank adapter
   into the bf16 base, with no adapter, holds within LOGIT_TOL of the
   "auto" path with the adapter over 2 prompts and 4 teacher-forced
   decode steps.
9. multihost -- the dispatch tier (``cluster/multihost.py``) on the same
   base cut to SWEEP_LAYERS = 8 layers: four batch-1 adapters of
   ``default_search_space(300, seq_len=512)`` (MH_IDS, ranks 8, 8, 16, 16)
   as two jobs of two, one per host, 4 captured steps each (impl="auto"),
   run by ``ExecutionEngine(cm, 2, host_size=1).run_local`` in this process
   (a ``ClusterRunner``, one job after the other), then through
   ``HostDispatcher([1, 1])``: two spawned worker processes sharing the
   card, each sent the base once (``init``), heartbeats every MH_HEARTBEAT
   s; host 0's worker is SIGKILLed while its first segment is in flight
   (its init under way) and the segment re-runs on a respawned worker;
   then the same workload again on
   the warm workers (no second ``init``), traced. Prints each worker's
   spawn-to-ready, ``init`` bytes and seconds, capture seconds, s/iter
   against the in-process run's, peak memory, the walls, the recovery's
   seconds and the card's free memory before, at its least and after
   ``close()``. Fails unless the kill landed mid-segment and was recovered,
   both runs' losses and pooled adapters equal the in-process run's bit
   for bit with every budget exact, the hosts' segments overlapped, both
   hosts end ALIVE, the trace is valid with both hosts' ``host*.segment``
   spans stitched under ``dispatch.segment``, the card's free memory comes
   back within MH_MEM_SLACK after ``close()``, and the workers' launches
   (sent back with each segment) equal the in-process run's (cold) and its
   replays' (warm).
10. online  -- the online engine on the same base: six configurations of
   ``default_search_space(300, seq_len=512)`` (two of batch 8, one of rank
   128, ranks 16-128) arrive on a ``poisson_trace``;
   ``ExecutionEngine.plan_online`` on the ``H100`` preset (the port's
   memory accounting, 1 s of setup a job) plans a migration, and
   ``run_online_local`` runs the plan on captured steps (impl="auto"): a
   preempted adapter checkpoints through the pool and resumes in a pack of
   other partners and another shape (a recapture). Prints the plan (and
   the largest job the reference's memory accounting would pack, priced
   by the port's), each segment's measured s/iter against the prior, its
   peak against ``job_mem_bytes``, the captures, and ``packed_matmul``'s
   launches. Fails unless every adapter is in the pool with its step
   budget and a finite loss, the preempted adapter's state file holds
   0 < steps_done < total, the same segments run eagerly give equal
   losses and adapters (bit for bit, else losses within LOSS_RTOL), the
   preempted adapter, against an unbroken run of it alone from the same
   initial weights, has its update within RESUME_UPDATE_RTOL and its final
   loss within RESUME_LOSS_RTOL (and the same run restarted from those
   weights at the preemption, the fault a lost resume makes, reads far
   outside the update's limit), the launches equal the eager steps'
   (warm-up included), and every captured job passes the C3 check. Then the adaptive loop
   (``ProfiledCostModel`` over the prior, three configurations, probes of
   2 steps on the card's clock) must reassign at least once, account every
   step, finish every adapter with a finite loss and round-trip its
   observation store through JSON. Last, ``c3_fit`` fits the memory
   model's logits copies and per-job bytes to every captured job's peak.
11. launcher -- ``repro_torch.launch.train.main``, the port's training
   entry point, on full qwen25-7b with its f32 base (``init_model``'s
   default; the smoke's bf16 base is freed first): ``--seq 512 --ranks
   8,16 --batch-sizes 2,2 --steps 3`` (two adapters of 1,024 tokens, ranks
   8 and 16: two same-rank segments, N = 1 x M = 1,024 each), once with
   ``--impl fused`` and once with ``--impl auto``, each on a captured
   step, then tuned and traced (``--impl fused --autotune-cache
   --trace-out --metrics-out``: a fresh cache; the launcher sweeps the d x
   d shape, calibrates its prior and runs the tuned split), then a planted
   control: ``--impl fused`` with the kernel's delta
   scale left out (forward and dx). Records s/step, the
   capture's seconds, the busy share of the last replay (``torch.profiler``),
   the peak allocated memory, and each wrapper's launches in all and by
   path (``kernels/launches.py``). Fails unless every f32 fused call of the
   fused run took ``ffma`` and every ``packed_matmul`` call of the auto run
   ``f32skinny``, each impl's own peak (the device's less what earlier
   phases hold) lies within [1, C3_SLACK] of the price of the launcher's
   own ``CostModel`` (priced at its tree's storage, "f32": ROADMAP C5),
   the counts that each impl must move moved, the
   two impls' per-adapter final losses are finite and agree within
   LAUNCH_LOSS_RTOL, each adapter's update under fused lies within
   LAUNCH_UPDATE_RTOL of auto's, the tuned run's losses and updates lie
   within the same limits of the untuned fused run's, its trace passes
   ``validate_chrome_trace`` with autotune and executor spans and its
   metrics count an executor build (it prints the uncalibrated and the
   calibrated prior's s/step beside the measured, and the split it ran),
   and the control's reads above LAUNCH_CONTROL_FACTOR times that limit.
12. families -- starcoder2-7b (LayerNorm, the two-matrix GELU MLP, biased
   GQA; cut to its first 8 of 32 layers, FAMILY_LAYERS), gemma3-1b
   (512-token sliding windows, every 6th layer global with its own rope
   theta, the gated GELU, tied embeddings; cut to 7 of 26), minicpm3-4b (multi-head
   latent attention: kv_a's 288-wide output, the absorbed decode; cut to
   16 of its 62 layers) and mamba2-370m (attention-free: SSD layers,
   cut to 24 of its 48,
   a chunked scan with a fixed-size f32 decode cache, no FFN; LoRA on zx
   and out), each at full width on a bf16 base of random weights from a
   seed (the launcher's f32 base freed first, each family's base freed
   after it):
   ``make_packed_step`` under impl="auto" and impl="fused" on the train
   phase's pack (seq 512; gemma3 1,024, so the window masks and attention
   reads a band per query chunk; mamba2 1,024, 4 chunks of the scan), step
   1 held against the plain path to the train phase's limits, then 2 steps
   whose counts must move; 8 requests through ``ServeEngine.serve``
   (starcoder2 under auto, the others under auto and fused, gemma3's and
   mamba2's prompts of 200-600 tokens), prefill logits and teacher-forced
   decode steps held against the plain path at LOGIT_TOL, and for gemma3
   (its prompt across the window), minicpm3 (MLA's chunk branch) and
   mamba2 (chunks of 256, its scan's) the first prompt's chunked prefill
   as the serve phase's (``chunk_gates``, FAMILY_CHUNK); and, for
   starcoder2, minicpm3 and mamba2, one captured
   ``run_local`` job of three configurations of
   ``default_search_space(300, seq_len=512)`` (FAMILY_SWEEP_IDS), equal to
   an eager run, its launches equal to the eager steps', its own peak held
   to C3, extract -> inject bit-exact. mamba2 also: ``launch/train.py --arch mamba2-370m --seq 1024
   --ranks 8,16 --steps 6`` on its own f32 base (s/step, peak against its
   price). ``scripts/ssd_share.py`` profiles the SSD's device share.
   Then whisper-tiny (the encoder-decoder: a non-causal encoder over 1,500
   frames a row, a cross-attention in each decoder layer) and
   internvl2-1b (256 patch positions before the text), at full width and
   depth: train at 448 tokens over 1,500 frames / 256 patches + 256
   tokens (whisper's fused step fails on any ``split3`` launch: its
   encoder packs of 1,500 frames a row take "wgmma"), serve with each
   request's own frames or patches (prompts of 16-200 / 64-257 tokens),
   one captured sweep job each at its train length; whisper also through
   the launcher on its f32 base under ``--impl fused`` and ``--impl auto``
   (losses and updates against each other, each own peak against its
   price).

Prints one JSON line per measurement, then a ``kernels`` line, then
``{"ok": true, "device": {...}}`` last. Details also go to
``smoke_out/`` (``chip_smoke.json``, ``profile_captured_fused.txt``,
``profile_train_{auto,fused,nf4}.txt``, ``profile_sweep_{captured,eager}.txt``,
``profile_launcher_{fused,auto,tuned}.txt``, the autotune caches
``autotune_{float32,bfloat16,launcher}.json``, the tuned launcher run's
``trace_launcher.json`` and ``metrics_launcher.json``, the nvcc logs with
``ptxas -v``).
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0

# H100 SXM published peaks (NVIDIA data sheet; dense, no sparsity)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# Max |kernel - plain| over max |plain|, per dtype. f32: only the order of
# the f32 sums differs; over K <= 18944 that is about sqrt(K) * 2^-24, some
# 1e-5 of the largest output at worst. bf16: besides, the one final cast may
# round the other way: one bf16 ulp, at most 2^-7 of the largest output.
KERNEL_TOL = {"float32": 5e-5, "bfloat16": 2 ** -7}
# Serve-phase logits, bf16 end to end: a 1-ulp difference in one projection
# output passes through up to 28 layers; held relative to max |logit|.
LOGIT_TOL = 0.05

# (d_in, d_out) of one qwen25-7b layer's projections, with their count
PROJ = [((3584, 3584), 2), ((3584, 512), 2), ((3584, 18944), 2), ((18944, 3584), 1)]
RANK = 16
CASES = {"decode": (8, 1), "prefill": (1, 256)}
# chunked prefill (``ServeEngine(prefill_chunk=)``): the serve phase's
# chunked drains stream each prompt in chunks of CHUNK tokens; the kernel
# phase's "chunk" rows are one chunk's calls (one adapter, CHUNK rows)
CHUNK = 64
CHUNK_CASE = (1, CHUNK)
TRAIN_CASE = (2, 1024)  # training shapes: N adapters, M = B*S tokens each

# The train phase's pack (alpha = 2r; learning rates inside the paper's
# 2e-5..4e-4 range): ranks 8 and 32 run as one-adapter segments, the two
# rank-16 adapters as one segment of two. NB = 8 rows of 512 tokens.
TRAIN_RANKS = (8, 16, 16, 32)
TRAIN_LRS = (1e-4, 2e-4, 3e-4, 4e-4)
TRAIN_BATCH = (1, 2, 1, 2)
TRAIN_SEQ = 512
TRAIN_STEPS = 3
TRAIN_RUNS = (("auto", None), ("fused", None), ("fused", "nf4"), ("fused", "int8"))
# The serve, train and sweep phases run the first SERVE_LAYERS,
# TRAIN_LAYERS and SWEEP_LAYERS of the 28 (the full width; views of the
# serve phase's base, no copy), so that the families and command_r phases
# fit in the smoke's time (PERF.md §4). The online phase keeps all 28: at
# fewer layers its plan preempts an adapter before its first step.
SERVE_LAYERS = 5
TRAIN_LAYERS = 5
SWEEP_LAYERS = 8
# Step 1 of the kernel path against the plain path on the same weights and
# batch. bf16 end to end: a 1-ulp difference in one projection's bf16
# output (the f32 sums run in another order) propagates through 28 layers.
# The per-adapter loss, a mean over >= 512 tokens, is held at LOSS_RTOL
# (relative). The LoRA gradients are held per leaf at max |kernel - plain|
# <= GRAD_TOL_F32 * max |plain| with the base cast to f32: the same kernels
# and autograd Functions on their f32 paths, where a summation order moves a
# gradient by f32 rounding grown through the depth while a wrong gradient
# moves it by O(1). In bf16 that growth takes even the plain path's
# gradients far from the f32 gradient (printed as
# step1_grad_err_vs_f32_plain_bf16), so there the kernel path's bf16
# gradients are held to be no farther from the f32 plain gradient than
# BF16_GRAD_FACTOR times the plain path's bf16 gradients are.
LOSS_RTOL = 1e-2
GRAD_TOL_F32 = 1e-3
BF16_GRAD_FACTOR = 1.5

RECORDS = []
# (configurations, peak allocated bytes) of every captured job of the sweep
# and online phases: the points of the memory fit (c3_fit)
C3_POINTS = []
# a captured job's peak must lie in [peak, C3_SLACK x peak] of its price
C3_SLACK = 1.3
# The online phase's preempted adapter against an unbroken run of it alone
# from the same initial weights and data: its update (w - w0, all leaves)
# within RESUME_UPDATE_RTOL of the unbroken run's, relative to that update,
# and its final loss within RESUME_LOSS_RTOL. The same adapter restarted
# from w0 at its preemption (a lost resume) must read above
# RESUME_CONTROL_FACTOR x RESUME_UPDATE_RTOL, so the check can see that
# fault. The loss moves little over 8 steps on random weights (PERF.md).
RESUME_UPDATE_RTOL = 0.05
RESUME_LOSS_RTOL = 1e-3
RESUME_CONTROL_FACTOR = 5.0


def emit(obj) -> None:
    RECORDS.append(obj)
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(torch, fn, arg_sets, iters: int = 20) -> float:
    """Mean ms per call over ``iters`` calls, cycling through ``arg_sets``
    (enough copies of the inputs that they do not stay in the 50 MB L2)."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, arg_sets, iters: int = 20, reps: int = 3) -> float:
    """Device ms per call with the host out of the loop: ``iters`` calls
    (cycling through ``arg_sets``) captured into one CUDA graph, whose
    replay is timed with CUDA events (mean over ``reps`` replays)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture wants
        for args in arg_sets[:2]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * reps)


def host_us(torch, fn, arg_sets, iters: int = 20, rounds: int = 2) -> float:
    """Host µs per call: ``time.perf_counter`` over ``iters`` calls that do
    not synchronise, after a warm-up (the device catches up after each
    round); the least of ``rounds`` rounds, so a stall of the shared host
    in one round does not count."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(rounds):
        t0 = time.perf_counter()
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return 1e6 * best / iters


# the kernel rows' repeats (cut for the smoke's time, PERF.md §4): a
# plain version is timed over PLAIN_ITERS calls (its "plain_ms" is
# reported, not checked), and a row's graph of 20 calls is replayed
# ROW_DEVICE_REPS times for its device time; a row whose kernel call takes
# over LONG_ROW_MS takes its library, device and host times over
# LONG_ROW_ITERS calls (each window still spans over 10 ms of device time)
PLAIN_ITERS = 5
ROW_DEVICE_REPS = 1
LONG_ROW_MS = 2.0
LONG_ROW_ITERS = 5


def copies_for(nbytes: int) -> int:
    return max(1, min(32, math.ceil(100e6 / max(nbytes, 1))))


def bound(nbytes: float, flops: float, dtype: str):
    t_b, t_f = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations"), t_b, t_f


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

# (case, call) of the packed_matmul rows that must take the tensor-core
# ("mma") path in bf16: the training calls of the N-D delta and prefill.
MMA_ROWS = {("train", c) for c in ("xA", "xAB", "bwd2_dxA", "bwd4_dx")} | {
    ("prefill", "xA"), ("prefill", "xAB"), ("chunk", "xA"), ("chunk", "xAB")}
# the same calls in f32, and the launcher's, take the streaming FFMA
# kernels ("f32skinny")
F32SKINNY_ROWS = MMA_ROWS | {("launcher", c) for c in ("xA", "xAB", "bwd2_dxA", "bwd4_dx")}


def packed_calls(rnd, dtype, n, m, d_in, d_out, r, scale, backward_cases=False):
    """``packed_matmul``'s uses at one projection shape, as (call, args_fn,
    flops, backward): the forward's xA and (xA)B and, with
    ``backward_cases``, the four backward cases on transposed views (read in
    place)."""
    calls = [
        ("xA", lambda: (rnd((n, m, d_in), dtype), rnd((n, d_in, r), dtype, d_in ** -0.5)),
         2 * n * m * d_in * r, False),
        ("xAB", lambda: (rnd((n, m, r), dtype), rnd((n, r, d_out), dtype), scale),
         2 * n * m * r * d_out, False),
    ]
    if backward_cases:
        calls += [
            # case 1: dB = (xA)^T @ g_s   (N, r, d_out), contracting over tokens
            ("bwd1_dB", lambda: (rnd((n, m, r), dtype).transpose(1, 2), rnd((n, m, d_out), dtype)),
             2 * n * r * m * d_out, True),
            # case 2: d(xA) = g_s @ B^T   (N, T, r)
            ("bwd2_dxA", lambda: (rnd((n, m, d_out), dtype), rnd((n, r, d_out), dtype).transpose(1, 2)),
             2 * n * m * d_out * r, True),
            # case 3: dA = x^T @ d(xA)    (N, d_in, r), contracting over tokens
            ("bwd3_dA", lambda: (rnd((n, m, d_in), dtype).transpose(1, 2), rnd((n, m, r), dtype)),
             2 * n * d_in * m * r, True),
            # case 4: dx = d(xA) @ A^T    (N, T, d_in), contracting over the rank
            ("bwd4_dx", lambda: (rnd((n, m, r), dtype), rnd((n, d_in, r), dtype, d_in ** -0.5).transpose(1, 2)),
             2 * n * m * r * d_in, True),
        ]
    return calls


def pair_call(torch, rnd, dtype, n, m, d_in, d_out, r, scale):
    """The delta's two passes as one ``packed_matmul_pair`` call, as
    (args_fn, kernel, plain, library, flops, path_fn): the library yardstick
    is two ``torch.bmm`` calls, the plain version two plain calls. Its path
    is "decode" when both passes take it (one C call), else both paths."""
    from repro_torch.kernels.packed_matmul import packed_matmul_pair, packed_matmul_path
    from repro_torch.kernels.ref import packed_matmul_ref

    def kfn(x, a, b, s):
        return packed_matmul_pair(x, a, b, s)[0]

    def pfn(x, a, b, s):
        return packed_matmul_ref(packed_matmul_ref(x, a), b, s)

    def lfn(x, a, b, s):
        return torch.bmm(torch.bmm(x, a), b)

    def path_fn(x, a, b, s):
        p1 = packed_matmul_path(x, a)
        p2 = packed_matmul_path(x.new_empty((n, m, r)), b)
        return p1 if p1 == p2 == "decode" else f"{p1}/{p2}"

    return ((lambda: (rnd((n, m, d_in), dtype), rnd((n, d_in, r), dtype, d_in ** -0.5),
                      rnd((n, r, d_out), dtype), scale)),
            kfn, pfn, lfn, 2 * n * m * r * (d_in + d_out), path_fn)


def kernel_phase(torch, dev):
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused import (
        fused_matmul,
        fused_matmul_path,
        fused_matmul_q,
        fused_matmul_q_path,
    )
    from repro_torch.kernels.packed_matmul import packed_matmul, packed_matmul_path
    from repro_torch.kernels.quant import dequantize, quantize_weight
    from repro_torch.kernels.ref import fused_matmul_q_ref, fused_matmul_ref, packed_matmul_ref

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(shape, dtype, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    rows = []

    def check(name, case, call, d_in, d_out, dtype, kfn, pfn, lfn, args_fn, flops,
              library, exact=None, path_fn=None, extra=None):
        args = args_fn()
        path = path_fn(*args) if path_fn is not None else None
        got = kfn(*args)
        want = pfn(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        tol = KERNEL_TOL[str(dtype).split(".")[-1]] * max(scale, 1e-30)
        if not (math.isfinite(err) and err <= tol):
            fail(f"{name} {case} {call} ({d_in},{d_out}) {dtype}: max_abs_err {err} > {tol}")
        if exact is not None and not torch.equal(got, exact(*args)):
            fail(f"{name} {case} {call} ({d_in},{d_out}) {dtype}: not bit-equal to the dense "
                 "kernel on the dequantized weight")
        in_bytes = nbytes(*[a for a in args if a is not None]) + nbytes(got)
        sets = [args] + [args_fn() for _ in range(copies_for(in_bytes) - 1)]
        ms = time_ms(torch, kfn, sets)
        iters = LONG_ROW_ITERS if ms > LONG_ROW_MS else 20
        plain_ms = time_ms(torch, pfn, sets, iters=PLAIN_ITERS)
        library_ms = time_ms(torch, lfn, sets, iters=iters)
        dname = str(dtype).split(".")[-1]
        b_ms, b_by, _, _ = bound(in_bytes, flops, dname)
        row = {"phase": "kernel", "kernel": name, "case": case, "call": call,
               "d_in": d_in, "d_out": d_out, "dtype": dname, "max_abs_err": err,
               "tol": tol, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "library": library, "bound_ms": b_ms, "bound_by": b_by, "bytes": in_bytes,
               "flops": flops, **(extra or {})}
        if path is not None:
            row["path"] = path
        # device time with the host out of the loop, and host time
        row.update(device_ms=device_ms(torch, kfn, sets, iters, reps=ROW_DEVICE_REPS),
                   library_device_ms=device_ms(torch, lfn, sets, iters, reps=ROW_DEVICE_REPS),
                   host_us=host_us(torch, kfn, sets, iters),
                   library_host_us=host_us(torch, lfn, sets, iters))
        emit(row)
        rows.append(row)
        del sets, args, got, want

    def lib_bmm(x, w, s=None):
        return torch.bmm(x, w)

    def packed_bwd(x, w):
        return packed_matmul(x, w, backward=True)

    def lib_fused(x, w, a, b, s):
        return torch.baddbmm(torch.matmul(x, w), torch.bmm(x, a) * s.view(-1, 1, 1).to(x.dtype), b)

    def lib_fused_q(x, codes, scales, a, b, s):
        return lib_fused(x, dequantize({"codes": codes, "scales": scales}, x.dtype), a, b, s)

    def dense_on_dequantized(x, codes, scales, a, b, s):
        return fused_matmul(x, dequantize({"codes": codes, "scales": scales}, x.dtype), a, b, s)

    BMM = "torch.bmm"
    FUSED3 = "baddbmm(x@W, bmm(x,A)*s, B): 3 calls"

    def fused_rows(case, n, m, d_in, d_out, dtype, scale, rank=RANK, extra=None):
        check("fused_matmul", case, "fused", d_in, d_out, dtype,
              fused_matmul, fused_matmul_ref, lib_fused,
              lambda: (rnd((n, m, d_in), dtype), rnd((d_in, d_out), dtype, d_in ** -0.5),
                       rnd((n, d_in, rank), dtype, d_in ** -0.5),
                       rnd((n, rank, d_out), dtype), scale),
              2 * n * m * (d_in * d_out + d_in * rank + rank * d_out), FUSED3,
              path_fn=lambda x, w, a, b, s: fused_matmul_path(x, w, a.shape[2], a, b),
              extra=extra)

    def lib_dx(g, wt, bt, at, s):
        return torch.baddbmm(torch.matmul(g, wt), torch.bmm(g, bt) * s.view(-1, 1, 1).to(g.dtype), at)

    def dx_rows(case, n, m, d_in, d_out, dtype, scale, rank=RANK, extra=None):
        """The backward's dx = g @ W^T + s * (g @ B^T) @ A^T, W^T a view of
        the (d_in, d_out) W (read in place)."""
        check("fused_matmul", case, "dx", d_in, d_out, dtype,
              lambda g, wt, bt, at, s: fused_matmul(g, wt, bt, at, s, backward=True),
              fused_matmul_ref, lib_dx,
              lambda: (rnd((n, m, d_out), dtype), rnd((d_in, d_out), dtype, d_in ** -0.5).t(),
                       rnd((n, d_out, rank), dtype), rnd((n, rank, d_in), dtype, d_in ** -0.5),
                       scale),
              2 * n * m * (d_out * d_in + d_out * rank + rank * d_in),
              "baddbmm(g@W^T, bmm(g,B^T)*s, A^T): 3 calls",
              path_fn=lambda g, wt, bt, at, s: fused_matmul_path(g, wt, bt.shape[2], bt, at),
              extra=extra)

    def fused_q_rows(case, n, m, d_in, d_out, dtype, scale, modes=("int8", "nf4"), rank=RANK,
                     extra=None):
        """``fused_matmul_q`` on int8 and nf4 codes, bit-equal to the dense
        kernel on the dequantized W; every call set quantizes a W of its own."""
        for mode in modes:
            def args_fn(mode=mode):
                q = quantize_weight(rnd((d_in, d_out), torch.float32, d_in ** -0.5), mode)
                return (rnd((n, m, d_in), dtype), q["codes"], q["scales"],
                        rnd((n, d_in, rank), dtype, d_in ** -0.5), rnd((n, rank, d_out), dtype), scale)

            check("fused_matmul_q", case, mode, d_in, d_out, dtype, fused_matmul_q,
                  fused_matmul_q_ref, lib_fused_q, args_fn,
                  2 * n * m * (d_in * d_out + d_in * rank + rank * d_out),
                  "dequantize(W) then baddbmm(x@W, bmm(x,A)*s, B)", exact=dense_on_dequantized,
                  path_fn=lambda x, c, sc, a, b, s: fused_matmul_q_path(x, c, sc, a.shape[2], a, b),
                  extra=extra)

    def packed_rows(case, n, m, d_in, d_out, dtype, scale, backward_cases=False, rank=RANK,
                    only=None, extra=None):
        for call, args_fn, flops, bwd in packed_calls(rnd, dtype, n, m, d_in, d_out, rank, scale,
                                                      backward_cases):
            if only is not None and call not in only:
                continue
            check("packed_matmul", case, call, d_in, d_out, dtype,
                  packed_bwd if bwd else packed_matmul, packed_matmul_ref, lib_bmm, args_fn, flops,
                  BMM + (" on the transposed views" if bwd else ""),
                  path_fn=lambda x, w, s=None: packed_matmul_path(x, w), extra=extra)
        if case.startswith("decode"):  # both passes of the delta as one call
            args_fn, kfn, pfn, lfn, flops, path_fn = pair_call(torch, rnd, dtype, n, m, d_in, d_out,
                                                               rank, scale)
            check("packed_matmul", case, "pair", d_in, d_out, dtype, kfn, pfn, lfn, args_fn, flops,
                  "2 calls: bmm(bmm(x, A), B)", path_fn=path_fn)

    # one prefill chunk's calls (bf16, as serve runs them): #1's xA and xAB on
    # "mma", #2 on "wgmma" (one 128-row tile, half its rows masked)
    n, m = CHUNK_CASE
    for (d_in, d_out), _ in PROJ:
        scale = torch.ones((n,), device=dev)
        packed_rows("chunk", n, m, d_in, d_out, torch.bfloat16, scale)
        fused_rows("chunk", n, m, d_in, d_out, torch.bfloat16, scale)
    # the tune_serve drains' decode steps: 8 rows at the pool's rank bucket
    # of 128 (#1's xA, xAB and pair; #2), bf16
    n, m = CASES["decode"]
    for (d_in, d_out), _ in PROJ:
        scale = torch.linspace(0.5, 2.0, n, device=dev)
        packed_rows(TS_CASE, n, m, d_in, d_out, torch.bfloat16, scale, rank=TS_R_BUCKET)
        fused_rows(TS_CASE, n, m, d_in, d_out, torch.bfloat16, scale, rank=TS_R_BUCKET)
    for dtype in (torch.bfloat16, torch.float32):
        for case, (n, m) in CASES.items():
            for (d_in, d_out), _ in PROJ:
                scale = torch.linspace(0.5, 2.0, n, device=dev)
                packed_rows(case, n, m, d_in, d_out, dtype, scale)
                fused_rows(case, n, m, d_in, d_out, dtype, scale)
                if case == "decode":
                    fused_q_rows(case, n, m, d_in, d_out, dtype, scale)
        # a ragged pack: ranks (8, 16) padded to a bucket of 16
        ranks = (8, 16)
        x = rnd((2, 4, 3584), dtype)
        w = rnd((3584, 3584), dtype, 3584 ** -0.5)
        a = rnd((2, 3584, 16), dtype, 3584 ** -0.5)
        b = rnd((2, 16, 3584), dtype)
        al = torch.tensor([2.0, 0.5], device=dev)
        for name, kimpl, pimpl, fn in (
            ("packed_lora_delta", "pallas", "plain", lambda i: ops.packed_lora_delta(x, a, b, al, impl=i, ranks=ranks)),
            ("fused_lora_linear", "fused_pallas", "fused_plain", lambda i: ops.fused_lora_linear(x, w, a, b, al, impl=i, ranks=ranks)),
        ):
            got, want = fn(kimpl), fn(pimpl)
            err = (got.float() - want.float()).abs().max().item()
            tol = KERNEL_TOL[str(dtype).split(".")[-1]] * want.float().abs().max().item()
            if not err <= tol:
                fail(f"ragged {name} {dtype}: max_abs_err {err} > {tol}")
            emit({"phase": "ragged", "op": name, "ranks": list(ranks),
                  "dtype": str(dtype).split(".")[-1], "max_abs_err": err, "tol": tol})
        train_kernel_rows(torch, dev, dtype, fused_rows, dx_rows, fused_q_rows, packed_rows)
    # the sweep's own shapes: each same-rank segment of each planned job
    for job, n, m, r in sweep_segments(sweep_plan().jobs):
        for (d_in, d_out), _ in PROJ:
            packed_rows("sweep", n, m, d_in, d_out, torch.bfloat16,
                        torch.linspace(0.5, 2.0, n, device=dev), backward_cases=True, rank=r,
                        only=SWEEP_CALLS, extra={"job": job, "n": n, "m": m, "rank": r})
    # the multihost phase's jobs (two adapters of one rank a job, batch 1:
    # N = 2 x M = 512 at r = 8 and at r = 16)
    for job, n, m, r in sweep_segments(mh_jobs()):
        for (d_in, d_out), _ in PROJ:
            packed_rows("multihost", n, m, d_in, d_out, torch.bfloat16,
                        torch.linspace(0.5, 2.0, n, device=dev), backward_cases=True, rank=r,
                        only=SWEEP_CALLS, extra={"job": job, "n": n, "m": m, "rank": r})
    # the online plan's shapes (batch 8: M = 4,096 tokens per adapter)
    on = online_plan()
    for job, n, m, r in online_segments(on.sched, on.configs):
        for (d_in, d_out), _ in PROJ:
            packed_rows("online", n, m, d_in, d_out, torch.bfloat16,
                        torch.linspace(0.5, 2.0, n, device=dev), backward_cases=True, rank=r,
                        only=SWEEP_CALLS, extra={"job": job, "n": n, "m": m, "rank": r})
    # each new family's training shapes (N = 2 x M = 1,024, r = 16, bf16):
    # packed_matmul's calls of a train step, the fused forward and dx; and
    # gemma3's decode rows (d = 1,152, k/v 256 wide)
    from repro_torch.configs import get_config

    for arch, mixer, case in family_cases("train"):
        n, m = CASE_ROWS.get(case, TRAIN_CASE)
        scale = torch.linspace(0.5, 2.0, n, device=dev)
        for (d_in, d_out), _ in family_proj(get_config(arch), mixer):
            packed_rows(case, n, m, d_in, d_out, torch.bfloat16, scale, backward_cases=True,
                        only=SWEEP_CALLS)
            fused_rows(case, n, m, d_in, d_out, torch.bfloat16, scale)
            dx_rows(case, n, m, d_in, d_out, torch.bfloat16, scale)
    n, m = CASES["decode"]
    for arch, mixer, case in family_cases("decode"):
        scale = torch.linspace(0.5, 2.0, n, device=dev)
        for (d_in, d_out), _ in family_proj(get_config(arch), mixer):
            packed_rows(case, n, m, d_in, d_out, torch.bfloat16, scale)
            fused_rows(case, n, m, d_in, d_out, torch.bfloat16, scale)
    # command-r-35b on its quantized base: #3 int8 at the training shapes
    # (N = 2 x M = 1,024, r = 16) with the dx its backward runs (#2 on the
    # dequantized W^T), #3 int8 and nf4 at 8 decode rows, and #3 nf4 on an
    # f32 x at the launcher's segments (N = 1 x M = 512 at r = 8 and 16)
    cr = get_config(COMMAND_R)
    n, m = TRAIN_CASE
    scale = torch.linspace(0.5, 2.0, n, device=dev)
    for (d_in, d_out), _ in family_proj(cr):
        fused_q_rows(CR_TRAIN_CASE, n, m, d_in, d_out, torch.bfloat16, scale, modes=("int8",))
        dx_rows(CR_TRAIN_CASE, n, m, d_in, d_out, torch.bfloat16, scale)
    n, m = CASES["decode"]
    scale = torch.linspace(0.5, 2.0, n, device=dev)
    for (d_in, d_out), _ in family_proj(cr):
        fused_q_rows(CR_DECODE_CASE, n, m, d_in, d_out, torch.bfloat16, scale)
    for n, m, r in launcher_segments(CR_LAUNCH_ARGS):
        scale = torch.linspace(0.5, 2.0, n, device=dev)
        for (d_in, d_out), _ in family_proj(cr):
            fused_q_rows(CR_LAUNCH_CASE, n, m, d_in, d_out, torch.float32, scale, modes=("nf4",),
                         rank=r, extra={"n": n, "m": m, "rank": r})
    train_cases = {"train", "chunk", CR_TRAIN_CASE, *(c for _, _, c in family_cases("train"))}
    decode_cases = {"decode", TS_CASE, CR_DECODE_CASE,
                    *(c for _, _, c in family_cases("decode"))}
    off = [(r["case"], r["kernel"], r["call"], r["d_in"], r["d_out"], r["path"]) for r in rows
           if r["case"] in train_cases and r["dtype"] == "bfloat16"
           and r["kernel"] != "packed_matmul" and r["path"] != "wgmma"]
    if off:
        fail(f"training-shape or prefill-chunk fused rows off the wgmma path: {off}")
    # the launcher's own shapes on its f32 base: each same-rank segment of
    # its pack, at the segment's rank (ops._ragged_call), forward and dx,
    # and packed_matmul's calls of --impl auto
    for n, m, r in launcher_segments():
        scale = torch.linspace(0.5, 2.0, n, device=dev)
        extra = {"n": n, "m": m, "rank": r}
        for (d_in, d_out), _ in PROJ:
            fused_rows("launcher", n, m, d_in, d_out, torch.float32, scale, rank=r, extra=extra)
            dx_rows("launcher", n, m, d_in, d_out, torch.float32, scale, rank=r, extra=extra)
            packed_rows("launcher", n, m, d_in, d_out, torch.float32, scale, backward_cases=True,
                        rank=r, only=SWEEP_CALLS, extra=extra)
    off = [(r["case"], r["call"], r["d_in"], r["d_out"], r.get("rank"), r["path"]) for r in rows
           if r["case"] in ("train", "launcher", CR_LAUNCH_CASE) and r["dtype"] == "float32"
           and r["kernel"] != "packed_matmul" and r["path"] != "ffma"]
    if off:
        fail(f"f32 training-shape or launcher fused rows off the ffma path: {off}")
    off = [(r["case"], r["call"], r["d_in"], r["d_out"], r.get("rank"), r["path"]) for r in rows
           if r["kernel"] == "packed_matmul" and r["dtype"] == "float32"
           and (r["case"], r["call"]) in F32SKINNY_ROWS and r["path"] != "f32skinny"]
    if off:
        fail(f"f32 training, launcher or prefill packed_matmul rows off the f32skinny path: {off}")
    off = [(r["case"], r["kernel"], r["call"], r["d_in"], r["d_out"], r["path"]) for r in rows
           if r["case"] in decode_cases and r["dtype"] == "bfloat16"
           and r["kernel"] != "packed_matmul" and r["path"] != "decode"]
    if off:
        fail(f"bf16 decode rows of fused_matmul or fused_matmul_q off the decode path: {off}")
    mma_rows = MMA_ROWS | {(case, call) for _, _, case in family_cases("train")
                           for call in SWEEP_CALLS}
    off = [(r["case"], r["call"], r["d_in"], r["d_out"], r["path"]) for r in rows
           if r["kernel"] == "packed_matmul" and r["dtype"] == "bfloat16"
           and (r["case"], r["call"]) in mma_rows and r["path"] != "mma"]
    if off:
        fail(f"bf16 training or prefill packed_matmul rows off the mma path: {off}")
    off = [(r["case"], r["call"], r["d_in"], r["d_out"], r["path"]) for r in rows
           if r["kernel"] == "packed_matmul" and r["dtype"] == "bfloat16"
           and r["case"] in decode_cases and r["path"] != "decode"]
    if off:
        fail(f"bf16 decode rows of packed_matmul off the decode path: {off}")
    return rows


def train_kernel_rows(torch, dev, dtype, fused_rows, dx_rows, fused_q_rows, packed_rows):
    """Every kernel use of the training step at its shapes: N=2 adapters,
    M=1024 tokens each, r=16. The backward cases pass transposed views,
    which the kernels read in place; the library yardstick is ``torch.bmm``
    on the same views."""
    n, m = TRAIN_CASE
    scale = torch.linspace(0.5, 2.0, n, device=dev)
    for (d_in, d_out), _ in PROJ:
        packed_rows("train", n, m, d_in, d_out, dtype, scale, backward_cases=True)
        fused_rows("train", n, m, d_in, d_out, dtype, scale)
        dx_rows("train", n, m, d_in, d_out, dtype, scale)
        fused_q_rows("train", n, m, d_in, d_out, dtype, scale)


# ---------------------------------------------------------------------------
# sync phase: no host wait in the ragged ops or a train step
# ---------------------------------------------------------------------------

# a pack's ranks out of order (the ragged ops gather by a permutation), and
# the train phase's sorted ranks (no permutation)
SYNC_RANKS = ((32, 8, 16, 8), TRAIN_RANKS)


def sync_free(torch, fn, what: str):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("error")``: any call
    that makes the host wait on the device (a blocking copy, ``.item()``, a
    stream synchronize) raises, and the run fails."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    except RuntimeError as e:
        fail(f"{what}: the host waited on the device: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out


def gather_scatter_call(torch, fn, x, a, b, alpha, ranks):
    """The ragged segmentation as ``ops._ragged_call`` had it before its
    index tensors were cached: a gather by a fresh index tensor (a blocking
    copy) on every call, sorted ranks or not, and a scatter back."""
    from repro_torch.kernels.ops import rank_segments

    order, inv, segments = rank_segments(ranks)
    o = torch.tensor(order, device=x.device)
    xs, a_s, b_s, al_s = x[o], a[o], b[o], alpha[o]
    outs = [fn(xs[lo:hi].contiguous(), a_s[lo:hi, :, :r].contiguous(),
               b_s[lo:hi, :r, :].contiguous(), al_s[lo:hi].contiguous()) for lo, hi, r in segments]
    return torch.cat(outs, dim=0)[torch.tensor(inv, device=x.device)]


def sync_phase(torch, dev):
    """Ragged ``packed_lora_delta`` and ``fused_lora_linear``, forward and
    backward, bf16 at the width of qwen25-7b's k projection, with ranks
    out of order and sorted: after one warm-up call, one call under
    ``sync_free``; its output and LoRA gradients must be ``torch.equal``
    to the gather/scatter formulation's on the same inputs."""
    import functools

    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    d_in, d_out, rb = 3584, 512, 32
    w = (torch.randn((d_in, d_out), generator=gen, device=dev) * d_in ** -0.5).to(torch.bfloat16)
    for ranks in SYNC_RANKS:
        n = len(ranks)
        mask = (torch.arange(rb, device=dev)[None, :] < torch.tensor(ranks, device=dev)[:, None])
        x = torch.randn((n, 2, 64, d_in), generator=gen, device=dev).to(torch.bfloat16)
        a0 = (torch.randn((n, d_in, rb), generator=gen, device=dev) * d_in ** -0.5 * mask[:, None]).to(torch.bfloat16)
        b0 = (torch.randn((n, rb, d_out), generator=gen, device=dev) * mask[:, :, None]).to(torch.bfloat16)
        al = torch.linspace(0.5, 2.0, n, device=dev)
        for name in ("packed_lora_delta", "fused_lora_linear"):
            def run(name=name):
                a, b = a0.clone().requires_grad_(True), b0.clone().requires_grad_(True)
                if name == "packed_lora_delta":
                    y = ops.packed_lora_delta(x, a, b, al, impl="auto", ranks=ranks)
                else:
                    y = ops.fused_lora_linear(x, w, a, b, al, impl="fused", ranks=ranks)
                (y.float() ** 2).sum().backward()
                return y, a.grad, b.grad

            run()  # warm-up: plans, kernel attributes, the index tensors
            got = sync_free(torch, run, f"ragged {name} {ranks}")
            real = ops._ragged_call
            ops._ragged_call = functools.partial(gather_scatter_call, torch)
            try:
                want = run()
            finally:
                ops._ragged_call = real
            equal = all(bool(torch.equal(g, h)) for g, h in zip(got, want))
            emit({"phase": "sync", "op": name, "ranks": list(ranks), "synchronisations": 0,
                  "equal_to_gather_scatter": equal})
            if not equal:
                fail(f"ragged {name} {ranks}: output or LoRA gradients differ from the "
                     "gather/scatter formulation")


def sync_free_train_step(torch, cfg, meta, base, lora, opt, batch, impl: str, quant=None):
    """One ``make_train_step`` call on the train phase's model under
    ``sync_free``, after one call that makes its per-device vectors, index
    tensors and the nf4 codebook's copy on the card."""
    from repro_torch.train.trainer import make_train_step

    step = make_train_step(cfg, meta, impl=impl)
    _, _, m1 = step(base, lora, opt, batch)
    _, _, m2 = sync_free(torch, lambda: step(base, lora, opt, batch),
                         f"make_train_step impl={impl} quant={quant}")
    emit({"phase": "sync_train_step", "impl": impl, "quant": quant, "synchronisations": 0,
          "loss_equal_to_first_call": bool(torch.equal(m1["per_adapter_loss"], m2["per_adapter_loss"]))})


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------


def make_adapters(torch, cfg, n: int, device="cpu"):
    """``n`` host adapter trees (f32 numpy), ranks alternating 8 and 16, A
    ~ N(0, 1/d_in) and B ~ N(0, 0.25/r): non-zero deltas about half the
    size of the base projection's output at scale alpha/r = 1. ``device``:
    where they are drawn (command-r-35b's 9 GB of adapters are drawn on the
    card)."""
    from repro_torch.configs import LoraConfig
    from repro_torch.core.adapter import pack_meta
    from repro_torch.models.model import lora_zeros
    from repro_torch.tree import tree_map

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    out = []
    for i in range(n):
        r = 8 if i % 2 == 0 else 16
        tmpl = lora_zeros(cfg, pack_meta([LoraConfig(rank=r, alpha=float(r))]), torch.float32,
                          device)

        def fill(t, r=r):
            if t.shape[-1] == r:  # a: (L, 1, d_in, r)
                w = torch.randn(t.shape, generator=gen, device=device) * t.shape[-2] ** -0.5
            else:
                w = torch.randn(t.shape, generator=gen, device=device) * (0.25 / r) ** 0.5
            return w.cpu().numpy()

        tree = tree_map(fill, tmpl)
        # drop the width-1 pack axis: what extract_adapter would give
        out.append((tree_map(lambda t: t[:, 0] if t.ndim == 4 else t[0], tree), r))
    return out


def row_adapters(torch, cfg, adapters, dev):
    """Each host adapter of ``make_adapters`` as a width-1 bf16 pack tree on
    ``dev``, zero-padded to rank 16 (what ``ServeEngine`` admits)."""
    from repro_torch import bridge
    from repro_torch.configs import LoraConfig
    from repro_torch.core.adapter import pack_meta
    from repro_torch.core.packed_lora import inject_adapter
    from repro_torch.models.model import lora_zeros
    from repro_torch.tree import tree_map

    meta1 = pack_meta([LoraConfig(rank=16, alpha=16.0)])
    tmpl = tree_map(lambda t: t.numpy(), lora_zeros(cfg, meta1, torch.float32, "cpu"))
    return [bridge.to_torch(inject_adapter(tmpl, tree, 0), dev, torch.bfloat16)
            for tree, _r in adapters]


def teacher_forced(torch, cfg, base, adapters, prompts, smax, kimpl, pimpl, counter, steps=4,
                   lora1s=None, routes=None, extras=None):
    """Prefill 8 rows (one adapter each) and decode ``steps`` tokens at
    width 8, once through the kernel path and once through the plain path,
    feeding both the kernel path's greedy tokens. Returns the max abs logit
    difference per step (prefill first), the max abs plain logit, and the
    kernel's launches per decode step (``counter`` names its count in
    ``kernels/launches.py``). ``lora1s``: ``row_adapters`` of ``adapters``,
    when the caller has them. ``extras``: each row's other prefill fields
    (``request_extras``: frames or patches); a row's decode positions start
    after its ``n_patch_tokens`` patches.

    ``routes`` (a dict, for a model with MoE layers): the plain path is also
    fed the kernel path's expert choices, as it is fed its tokens -- each
    MoE layer's router takes the kernel path's top-k in place of its own,
    its gates its own probabilities there, renormalized -- and the returned
    differences are that run's. ``routes`` receives the differences of the
    plain path on its own routing (``own_routes_per_step``) and, per MoE
    layer, the share of the kernel path's top-k choices that the plain
    path's own router made too (``topk_agreement_by_layer``)."""
    from repro_torch.configs import LoraConfig
    from repro_torch.core.adapter import pack_meta
    from repro_torch.kernels.ops import KernelConfig
    from repro_torch.models.layers import moe as tmoe
    from repro_torch.models.model import decode_step, init_caches, lora_zeros, prefill
    from repro_torch.serve.decode import pad_caches
    from repro_torch.serve.engine import write_row_caches

    dev = base["embed"]["w"].device
    rows = len(adapters)
    meta1 = pack_meta([LoraConfig(rank=16, alpha=16.0)])
    meta = pack_meta([LoraConfig(rank=16, alpha=16.0)] * rows)
    if lora1s is None:
        lora1s = row_adapters(torch, cfg, adapters, dev)
    scales = torch.ones((rows,), dtype=torch.float32, device=dev)  # alpha / r = 1
    teacher = []
    logs = {}
    router, kern_idx, own_idx = tmoe._router, [], []

    def replaying(x, params, mcfg):  # the plain path on the kernel path's experts
        _, idx, aux = router(x, params, mcfg)
        own_idx.append(idx)
        idx = kern_idx[len(own_idx) - 1]
        gates = torch.softmax(x.float() @ params["router"]["w"].float(), dim=-1).gather(-1, idx)
        return gates / (gates.sum(-1, keepdim=True) + 1e-9), idx, aux

    def recording(x, params, mcfg):  # the kernel path's choices
        out = router(x, params, mcfg)
        kern_idx.append(out[1])
        return out

    runs = ([(kimpl, None), (pimpl, None)] if routes is None
            else [(kimpl, recording), (pimpl, None), (pimpl, replaying)])
    for path, hook in runs:
        kc1 = KernelConfig(impl=path, ranks=meta1.ranks)
        kc = KernelConfig(impl=path, ranks=meta.ranks)
        caches = init_caches(cfg, rows, smax, device=dev)
        lora = lora_zeros(cfg, meta, torch.bfloat16, dev)
        tmoe._router = hook or router
        try:
            lg_all = []
            for i, (lora1, p) in enumerate(zip(lora1s, prompts)):
                write_row_caches(lora, lora1, i)
                extra = {k: v.to(dev) for k, v in (extras[i] if extras else {}).items()}
                lg, c1 = prefill(base, lora1, scales[:1],
                                 {"tokens": torch.from_numpy(p[None]).to(dev), **extra}, cfg,
                                 kcfg=kc1)
                write_row_caches(caches, pad_caches(c1, smax), i)
                lg_all.append(lg[0, -1, : cfg.vocab_size].float())
            step_lg = [torch.stack(lg_all)]
            pos = torch.tensor([len(p) + cfg.n_patch_tokens for p in prompts], device=dev)
            n0 = train_counts()[counter]
            for s in range(steps):
                if path == kimpl:
                    teacher.append(torch.argmax(step_lg[-1], dim=-1).to(torch.int32))
                lg, caches = decode_step(base, lora, scales, teacher[s][:, None], caches, pos,
                                         cfg, n_pack=rows, kcfg=kc)
                step_lg.append(lg[:, -1, : cfg.vocab_size].float())
                pos = pos + 1
        finally:
            tmoe._router = router
        if path == kimpl:
            per_step_launches = (train_counts()[counter] - n0) / steps
        logs[path, hook is replaying] = torch.stack(step_lg)  # (1 + steps, rows, V)
        del caches, lora
    got, want = logs[kimpl, False], logs[pimpl, routes is not None]
    if not all(bool(torch.isfinite(t).all()) for t in logs.values()):
        fail(f"non-finite logits on the {kimpl} or {pimpl} path")
    per_step = (got - want).abs().amax(dim=(1, 2)).tolist()
    if routes is not None:
        n_moe = cfg.ffn_kinds().count("moe")
        if len(own_idx) != len(kern_idx) or len(kern_idx) % n_moe:
            fail(f"{len(kern_idx)} / {len(own_idx)} router calls on the {kimpl} / {pimpl} paths")
        routes["own_routes_per_step"] = (got - logs[pimpl, False]).abs().amax(dim=(1, 2)).tolist()
        routes["topk_agreement_by_layer"] = [
            (torch.cat(kern_idx[j::n_moe])[:, :, None] == torch.cat(own_idx[j::n_moe])[:, None, :])
            .any(-1).float().mean().item() for j in range(n_moe)]
    return per_step, want.abs().max().item(), per_step_launches


def chunk_gates(torch, cfg, base, lora1s, prompts, impl: str, chunk: int) -> dict:
    """Each prompt's last-position logits from ``prefill_chunked`` in
    chunks of ``chunk`` under ``impl``, against the one-shot ``prefill``
    under ``impl`` and against ``prefill_chunked`` on the same chunks under
    ``impl``'s plain version; each difference relative to max |logit| of
    what it is held against, and both gated at LOGIT_TOL. ``lora1s``: one
    width-1 adapter tree a prompt (``row_adapters``)."""
    from repro_torch.configs import LoraConfig
    from repro_torch.core.adapter import pack_meta
    from repro_torch.kernels.ops import KernelConfig
    from repro_torch.models.model import prefill
    from repro_torch.serve.decode import prefill_chunked

    dev = base["embed"]["w"].device
    ranks = pack_meta([LoraConfig(rank=16, alpha=16.0)]).ranks
    kc = KernelConfig(impl=impl, ranks=ranks)
    pc = KernelConfig(impl={"auto": "plain", "fused": "fused_plain"}[impl], ranks=ranks)
    scales = torch.ones((1,), dtype=torch.float32, device=dev)  # alpha / r = 1
    v = cfg.vocab_size
    out = {"vs_one_shot": [], "vs_plain": []}
    for lora1, p in zip(lora1s, prompts):
        toks = torch.from_numpy(p[None]).to(dev)
        with torch.no_grad():
            one, _ = prefill(base, lora1, scales, {"tokens": toks}, cfg, kcfg=kc)
            got, _ = prefill_chunked(base, lora1, scales, toks, cfg, chunk, kcfg=kc)
            plain, _ = prefill_chunked(base, lora1, scales, toks, cfg, chunk, kcfg=pc)
        one, got, plain = (t[0, -1, :v].float() for t in (one, got, plain))
        if not bool(torch.isfinite(got).all()):
            fail(f"{cfg.name} impl={impl}: non-finite chunked prefill logits")
        out["vs_one_shot"].append(((got - one).abs().max() / one.abs().max()).item())
        out["vs_plain"].append(((got - plain).abs().max() / plain.abs().max()).item())
    rec = {"phase": "serve_chunk_logits", "model": cfg.name, "impl": impl, "chunk": chunk,
           "prompt_tokens": [len(p) for p in prompts],
           "rel_err_vs_one_shot": out["vs_one_shot"], "rel_err_vs_plain": out["vs_plain"],
           "tol": LOGIT_TOL}
    emit(rec)
    worst = max(out["vs_one_shot"] + out["vs_plain"])
    if not worst <= LOGIT_TOL:
        fail(f"{cfg.name} impl={impl}: chunked prefill logits differ by {worst} > {LOGIT_TOL} "
             "(from the one-shot prefill or the plain path's chunks)")
    return rec


def profile_serve(torch, cfg, base, adapters, reqs, impl: str, out_dir: Path,
                  capture: bool = True):
    """Serve 8 requests of 8 new tokens under ``torch.profiler`` (8 one-shot
    prefills, 7 decode steps; with ``capture``, replays of the engine's
    greedy graph, captured by a warm-up drain outside the window) and
    report the device time by operator and the device's busy share of the
    wall time. The table goes to ``smoke_out/profile_<captured|eager>_<impl>.txt``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(cfg, base, rows=8, smax=512, r_bucket=16, impl=impl, capture=capture,
                      device=base["embed"]["w"].device)
    for i, (tree, r) in enumerate(adapters):
        eng.publish(f"ad{i}", tree, {"rank": r, "alpha": float(r)})
    short = [dataclasses.replace(r, max_new_tokens=8, arrival=0.0) for r in reqs[:8]]
    eng.serve(short[:1])  # warm-up outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stats = eng.serve(short)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    label = "captured" if capture else "eager"
    emit({"phase": "profile", "impl": impl, "captured": capture, "n_layers": cfg.n_layers,
          "decode_steps": stats.steps,
          **read_profile(prof, wall_ms, out_dir / f"profile_{label}_{impl}.txt")})


def read_profile(prof, wall_ms: float, table_path: Path) -> dict:
    """Device time and busy share of a profiled window, its top device
    operations and the port's own kernels (``port_kernels``); the full
    table goes to ``table_path``."""
    from torch.autograd import DeviceType

    ka = prof.key_averages()
    # device-side events only (kernels, copies): an operator's own row
    # repeats the time of the kernels it launched
    kernels = [e for e in ka if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if device_ms <= 0:
        fail(f"the profiler saw no device time in {table_path.name}")
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    table_path.write_text(ka.table(sort_by="self_cuda_time_total", row_limit=40))
    return {"wall_ms": wall_ms, "device_ms": device_ms, "device_busy_share": device_ms / wall_ms,
            "top_device_ms": [[e.key[:60], e.self_device_time_total / 1e3, e.count] for e in top],
            "port_device_ms": port_kernels(kernels)}


def port_kernels(kernels) -> dict:
    """The port's own device kernels among profiler events (namespace
    ``plora``), by name without the argument list: [device ms, launches]."""
    out = {}
    for e in kernels:
        if "plora::" in e.key:
            name = e.key.split("(")[0]
            ms, n = out.get(name, (0.0, 0))
            out[name] = (ms + e.self_device_time_total / 1e3, n + e.count)
    return out


def serve_phase(torch, dev):
    """Serves on the first SERVE_LAYERS layers of full-width qwen25-7b (a
    view of its base): 16 requests under each impl with one-shot prefills,
    then with their prompts streamed in chunks of CHUNK (``prefill_chunk``),
    each chunked drain's tokens against its impl's one-shot drain, and two
    prompts' chunked prefill logits held against the one-shot prefill's and
    the plain path's (``chunk_gates``). Returns the launch counts of each
    drain ("chunked:<impl>": the chunk path's launches), and the whole base
    model (the train, sweep and online phases reuse it)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launches as launch_counts
    from repro_torch.models.model import init_model
    from repro_torch.serve.engine import ServeEngine, poisson_requests
    from repro_torch.tree import tree_leaves

    t0 = time.perf_counter()
    full, _ = init_model(SEED, get_config("qwen25-7b"), None, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    cfg, base = depth_cut(get_config("qwen25-7b"), full, SERVE_LAYERS)
    n_params = sum(t.numel() for t in tree_leaves(base))
    adapters = make_adapters(torch, cfg, 8)
    emit({"phase": "serve_setup", "model": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "params": n_params, "dtype": "bfloat16",
          "init_s": time.perf_counter() - t0,
          "weights_gb": torch.cuda.memory_allocated(dev) / 1e9})
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(0, cfg.vocab_size, size=rng.randint(64, 257)).astype(np.int32)
               for _ in range(16)]
    reqs = poisson_requests([f"ad{i % 8}" for i in range(16)], prompts, 2.0,
                            max_new_tokens=32, seed=SEED)
    counters = {"auto": "packed_matmul", "fused": "fused_matmul"}  # each impl's forward count
    launches, tokens = {}, {}
    for impl in ("auto", "fused"):
        eng = ServeEngine(cfg, base, rows=8, smax=512, r_bucket=16, slot_capacity=8,
                          impl=impl, device=dev)
        for i, (tree, r) in enumerate(adapters):
            eng.publish(f"ad{i}", tree, {"rank": r, "alpha": float(r)})
        zero_counts()
        stats = eng.serve(reqs)
        torch.cuda.synchronize()
        counts = train_counts()
        launches[impl] = {name: counts[name] for name in counters.values()}
        if counts[counters[impl]] == 0:
            fail(f"impl={impl}: the {counters[impl]} kernel was never launched")
        bad = [r for r in stats.results if r.error is not None or len(r.tokens) != 32]
        if bad or len(stats.results) != 16:
            fail(f"impl={impl}: requests failed: {[(r.request_id, r.error) for r in bad]}")
        toks = np.stack([r.tokens for r in stats.results])
        if toks.min() < 0 or toks.max() >= cfg.vocab_size:
            fail(f"impl={impl}: token ids outside the vocabulary")
        tokens[impl] = toks
        lat = stats.latency_summaries()
        emit({"phase": "serve", "impl": impl, "requests": len(stats.results),
              "tokens": stats.tokens_emitted, "steps": stats.steps,
              "mean_occupancy": stats.mean_occupancy, "wall_s": stats.wall_seconds,
              "tokens_per_s": stats.tokens_per_s,
              "ttft_p50_s": lat["ttft"]["p50"], "ttft_p95_s": lat["ttft"]["p95"],
              "itl_p50_s": lat["itl"]["p50"], "itl_p95_s": lat["itl"]["p95"],
              "launches": launches[impl]})
        del eng
    emit({"phase": "serve_agreement",
          "greedy_token_match_share": float((tokens["auto"] == tokens["fused"]).mean())})
    # the same requests with their prompts streamed in chunks of CHUNK
    # between decode steps; the chunks' calls take "mma" / "wgmma" (and
    # "decode" at a tail of <= 16 rows)
    chunk_path = {"auto": ("packed_matmul", "mma"), "fused": ("fused_matmul", "wgmma")}
    for impl in ("auto", "fused"):
        eng = ServeEngine(cfg, base, rows=8, smax=512, r_bucket=16, slot_capacity=8,
                          prefill_chunk=CHUNK, impl=impl, device=dev)
        for i, (tree, r) in enumerate(adapters):
            eng.publish(f"ad{i}", tree, {"rank": r, "alpha": float(r)})
        zero_counts()
        stats = eng.serve(reqs)
        torch.cuda.synchronize()
        by_path = launch_counts.read_paths()
        kernel, path = chunk_path[impl]
        launches[f"chunked:{impl}"] = {f"{kernel}:{path}": by_path[kernel].get(path, 0)}
        if by_path[kernel].get(path, 0) == 0:
            fail(f"chunked impl={impl}: {kernel} never launched on \"{path}\" at chunk rows")
        bad = [r for r in stats.results if r.error is not None or len(r.tokens) != 32]
        if bad or len(stats.results) != 16:
            fail(f"chunked impl={impl}: requests failed: {[(r.request_id, r.error) for r in bad]}")
        toks = np.stack([r.tokens for r in stats.results])
        if toks.min() < 0 or toks.max() >= cfg.vocab_size:
            fail(f"chunked impl={impl}: token ids outside the vocabulary")
        lat = stats.latency_summaries()
        emit({"phase": "serve_chunked", "impl": impl, "prefill_chunk": CHUNK,
              "requests": len(stats.results), "tokens": stats.tokens_emitted,
              "steps": stats.steps, "mean_occupancy": stats.mean_occupancy,
              "wall_s": stats.wall_seconds, "tokens_per_s": stats.tokens_per_s,
              "ttft_p50_s": lat["ttft"]["p50"], "ttft_p95_s": lat["ttft"]["p95"],
              "itl_p50_s": lat["itl"]["p50"], "itl_p95_s": lat["itl"]["p95"],
              "greedy_token_match_share_vs_one_shot": float((toks == tokens[impl]).mean()),
              "launches_by_path": by_path})
        del eng
    lora1s = row_adapters(torch, cfg, adapters[:2], dev)
    for impl in ("auto", "fused"):
        chunk_gates(torch, cfg, base, lora1s, [r.prompt for r in reqs[:2]], impl, CHUNK)
    with torch.no_grad():
        for kimpl, pimpl in (("auto", "plain"), ("fused", "fused_plain")):
            per_step, ref_max, per_dec = teacher_forced(
                torch, cfg, base, adapters, [r.prompt for r in reqs[:8]], 512, kimpl, pimpl,
                counters[kimpl])
            rel = max(per_step) / ref_max
            emit({"phase": "serve_logits", "impl": kimpl, "plain": pimpl,
                  "launches_per_decode_step": per_dec,
                  "max_abs_err_prefill": per_step[0], "max_abs_err_decode": per_step[1:],
                  "max_abs_logit": ref_max, "rel_err": rel, "tol": LOGIT_TOL})
            if not rel <= LOGIT_TOL:
                fail(f"impl={kimpl}: logits differ from {pimpl} by {rel} > {LOGIT_TOL}")
    # the profiled drain runs at full depth, captured (serve_captured)
    return launches, full


# ---------------------------------------------------------------------------
# serve_captured phase
# ---------------------------------------------------------------------------

# 8 requests of 16 new tokens (16 of 32 until the multihost phase came: the
# cut that pays for it; the step gate feeds 8 rows, so no fewer)
SC_REQUESTS = 8
SC_NEW = 16
SC_TEMP, SC_TOP_K = 0.8, 50  # every odd request of the mixed drain
SC_COUNTERS = {"auto": "packed_matmul", "fused": "fused_matmul"}  # each impl's forward count


def step_gate(torch, eng, tokens, positions, what: str) -> dict:
    """One decode step of ``eng`` (a captured engine) at ``tokens`` and
    ``positions``, every row at scale 1, through its greedy graph and
    through the eager step on the same caches (restored between the two:
    an SSM state advances): the logits must be ``torch.equal``, the same
    kernels in the same order on the same buffers."""
    from repro_torch.tree import tree_map

    snapshot = tree_map(torch.clone, eng._caches)
    ones = [1.0] * eng.rows
    got = eng.decode_once(tokens, positions, ones)[1].clone()
    tree_map(lambda d, s: d.copy_(s), eng._caches, snapshot)
    want = eng.decode_once(tokens, positions, ones, eager=True)[1]
    rec = {"logits_equal": bool(torch.equal(got, want)),
           "max_abs_diff": (got.float() - want.float()).abs().max().item()}
    del snapshot, got, want
    if not rec["logits_equal"]:
        fail(f"{what}: a captured decode step's logits differ from the eager step's by "
             f"{rec['max_abs_diff']} (bitwise equality wanted)")
    return rec


def sc_drain(torch, eng, reqs, what: str):
    """One drain with the launch counts zeroed just before it and read just
    after: (stats, tokens (R, new), counts)."""
    new = {r.request_id: r.max_new_tokens for r in reqs}
    zero_counts()
    stats = eng.serve(reqs)
    torch.cuda.synchronize()
    counts = train_counts()
    bad = [(r.request_id, r.error) for r in stats.results
           if r.error is not None or len(r.tokens) != new[r.request_id]]
    if bad or len(stats.results) != len(reqs):
        fail(f"serve_captured {what}: requests failed: {bad}")
    toks = np.stack([r.tokens for r in stats.results])
    if toks.min() < 0 or toks.max() >= eng.cfg.vocab_size:
        fail(f"serve_captured {what}: token ids outside the vocabulary")
    return stats, toks, counts


def sc_summary(stats) -> dict:
    """A drain's end-to-end numbers: wall, tokens/s, TTFT p50, ITL p50 /
    p95 / p99 and the host's time per decode step."""
    lat = stats.latency_summaries()
    return {"wall_s": stats.wall_seconds, "steps": stats.steps,
            "tokens": stats.tokens_emitted, "tokens_per_s": stats.tokens_per_s,
            "ttft_p50_s": lat["ttft"]["p50"], "itl_p50_s": lat["itl"]["p50"],
            "itl_p95_s": lat["itl"]["p95"], "itl_p99_s": lat["itl"]["p99"],
            "step_host_us_p50": 1e6 * lat["step_host"]["p50"],
            "step_host_us_mean": 1e6 * lat["step_host"]["mean"]}


def serve_captured(torch, dev, base, out_dir: Path) -> dict:
    """qwen25-7b at its full 28 layers (``base``, the serve phase's whole
    model): SC_REQUESTS requests of 64-256 prompt tokens and SC_NEW new
    ones at 8 rows, r_bucket 16, one-shot prefill, under each impl through
    an eager engine and a captured one: the all-greedy drain, then the
    mixed one (every odd request sampled at SC_TEMP, top-k SC_TOP_K, one
    seed). The captured engine first serves a greedy request, then a
    sampled one, in warm drains that capture the two steps. Gates: every
    request returns its tokens; the captured drains' tokens equal the eager
    ones'; the captured greedy drain's launch counts equal the eager
    drain's (a replay adds what its capture recorded); one captured step's
    logits equal the eager step's (``step_gate``); the allocated memory
    after the captured engine is dropped equals its level before it. Then
    a profiled captured fused drain (``profile_serve``). Returns each
    impl's launch counts of its captured greedy drain."""
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import ServeEngine, poisson_requests

    cfg = get_config("qwen25-7b")
    adapters = make_adapters(torch, cfg, 8, device=dev)
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(0, cfg.vocab_size, size=rng.randint(64, 257)).astype(np.int32)
               for _ in range(SC_REQUESTS)]
    greedy = poisson_requests([f"ad{i % 8}" for i in range(SC_REQUESTS)], prompts, 2.0,
                              max_new_tokens=SC_NEW, seed=SEED)
    mixed = [dataclasses.replace(r, temperature=SC_TEMP if i % 2 else 0.0,
                                 top_k=SC_TOP_K if i % 2 else 0) for i, r in enumerate(greedy)]
    # two warm drains of one request each: the greedy step's capture, then
    # the sampling step's (a drain with a sampled row runs only the latter)
    warm = [[dataclasses.replace(r, max_new_tokens=3, arrival=0.0)] for r in mixed[:2]]
    sampled = np.array([r.temperature > 0 for r in mixed])

    def engine(impl, capture):
        eng = ServeEngine(cfg, base, rows=8, smax=512, r_bucket=16, slot_capacity=8, impl=impl,
                          seed=SEED, capture=capture, device=dev)
        for i, (tree, r) in enumerate(adapters):
            eng.publish(f"ad{i}", tree, {"rank": r, "alpha": float(r)})
        return eng

    launches = {}
    for impl in ("auto", "fused"):
        counter = SC_COUNTERS[impl]
        eng = engine(impl, False)
        e_stats, e_greedy, e_counts = sc_drain(torch, eng, greedy, f"{impl} eager")
        _, e_mixed, _ = sc_drain(torch, eng, mixed, f"{impl} eager mixed")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated(dev)
        eng = engine(impl, None)
        if not eng.capture:
            fail(f"serve_captured {impl}: ServeEngine on {dev} does not capture by default")
        t0 = time.perf_counter()
        for w in warm:
            sc_drain(torch, eng, w, f"{impl} warm")
        warm_s = time.perf_counter() - t0
        c_stats, c_greedy, c_counts = sc_drain(torch, eng, greedy, f"{impl} captured")
        _, c_mixed, _ = sc_drain(torch, eng, mixed, f"{impl} captured mixed")
        gate = step_gate(torch, eng, [int(t) for t in c_greedy[:8, 0]],
                         [len(p) for p in prompts[:8]], f"serve_captured {impl}")
        captures = list(eng.captures)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        after = torch.cuda.memory_allocated(dev)
        launches[impl] = c_counts
        emit({"phase": "serve_captured", "model": cfg.name, "n_layers": cfg.n_layers,
              "impl": impl, "requests": len(greedy), "new_tokens": SC_NEW, "rows": 8,
              "eager": sc_summary(e_stats), "captured": sc_summary(c_stats),
              "warm_drain_s": warm_s, "captures": captures,
              "launches_eager": e_counts, "launches_captured": c_counts,
              "greedy_equal": bool(np.array_equal(c_greedy, e_greedy)),
              "mixed_equal": bool(np.array_equal(c_mixed, e_mixed)),
              "sampled_differs_from_greedy_share":
                  float((c_mixed[sampled] != c_greedy[sampled]).mean()),
              "step_logits": gate, "allocated_before": held, "allocated_after_del": after})
        if not np.array_equal(c_greedy, e_greedy):
            fail(f"serve_captured {impl}: captured greedy tokens differ from the eager drain's "
                 f"at {float((c_greedy != e_greedy).mean())} of them")
        if not np.array_equal(c_mixed, e_mixed):
            fail(f"serve_captured {impl}: captured mixed-drain tokens differ from the eager "
                 f"mixed drain's under one seed at {float((c_mixed != e_mixed).mean())}")
        if c_counts[counter] == 0 or c_counts != e_counts:
            fail(f"serve_captured {impl}: captured launches {c_counts} against eager "
                 f"{e_counts} ({counter} must launch, and the counts agree)")
        if [c["sampling"] for c in captures] != [False, True]:
            fail(f"serve_captured {impl}: captures {captures} (the greedy step, then the "
                 "sampling step, once each)")
        if after != held:
            fail(f"serve_captured {impl}: {after} bytes allocated after the captured engine was "
                 f"dropped, {held} before it")
    profile_serve(torch, cfg, base, adapters, greedy, "fused", out_dir, capture=True)
    return launches


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------


def train_lora(torch, cfg, meta, dev):
    """The pack's LoRA tree in f32 (the leaves that train): A ~ N(0, 1/d_in)
    and B ~ N(0, 0.25/r) on each adapter's first r columns (zero padding),
    from a seed. B is non-zero so the deltas and dA are."""
    from repro_torch.models.model import lora_zeros
    from repro_torch.tree import tree_map

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    mask = meta.rank_mask(dev)  # (N, r_bucket)
    ranks = torch.tensor(meta.ranks, dtype=torch.float32, device=dev)

    def fill(t):
        if t.shape[-1] == meta.r_bucket and t.shape[-2] != meta.r_bucket:  # a: (.., N, d_in, r)
            return torch.randn(t.shape, generator=gen, device=dev) * t.shape[-2] ** -0.5 * mask[:, None, :]
        std = (0.25 / ranks)[:, None, None] ** 0.5  # b: (.., N, r, d_out)
        return torch.randn(t.shape, generator=gen, device=dev) * std * mask[:, :, None]

    return tree_map(fill, lora_zeros(cfg, meta, torch.float32, dev))


def resident_bytes(tree) -> int:
    from repro_torch.tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def train_counts():
    """Each kernel's launches (a captured graph's replays included)."""
    from repro_torch.kernels import launches

    return launches.read()


def zero_counts():
    from repro_torch.kernels import launches

    launches.zero()


# the counts a run's impl must move: forward, and backward
NEEDED = {("auto", None): ("packed_matmul", "packed_matmul_bwd"),
          ("fused", None): ("fused_matmul", "fused_matmul_dx"),
          ("fused", "nf4"): ("fused_matmul_q", "fused_matmul_dx"),
          ("fused", "int8"): ("fused_matmul_q", "fused_matmul_dx"),
          ("auto", "int8"): ("packed_matmul", "packed_matmul_bwd")}


def compare_step1(torch, cfg, base, lora, batch, meta, impl, scales, f32_layers=None):
    """Step 1's per-adapter loss and LoRA gradients, kernel path against the
    plain path on the same weights and batch: in bf16, and with the base's
    floating-point leaves cast to f32 (the same kernels and autograd
    Functions on their f32 paths). Returns the comparison's numbers. The f32
    runs come first, with the f32 copy of the base freed after them; the
    gradients that later runs are held against wait on the host, so the
    card holds one set of gradients at a time (command-r-35b's pack: 3.1 GB
    a set). ``f32_layers``: the f32 runs take a view of the first that many
    layers (``depth_cut``, the LoRA cut alike), for a base whose f32 copy
    does not fit (qwen3-moe-30b-a3b: 122 GB); the bf16 gradients are then
    not held against the f32 ones (other depths), and those two numbers
    are None."""
    from repro_torch.kernels.ops import KernelConfig
    from repro_torch.train.trainer import packed_value_and_grad
    from repro_torch.tree import tree_leaves, tree_map

    plain = {"auto": "plain", "fused": "fused_plain"}[impl]

    def grad_rel(ga, gb):  # per leaf: max |a - b| / max |b|
        out = []
        for a, b in zip(ga, gb):
            b = b.to(a.device)
            out.append(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item())
        return out

    loss, kept, errs = {}, {}, {}
    cfg32, base32, lora32 = cfg, base, lora
    if f32_layers is not None:
        cfg32, base32 = depth_cut(cfg, base, f32_layers)
        lora32 = depth_cut_lora(cfg, lora, f32_layers)
    base32 = tree_map(lambda t: t.float() if t.is_floating_point() else t, base32)
    for prec, path in (("f32", plain), ("f32", impl), ("bf16", plain), ("bf16", impl)):
        if prec == "bf16" and base32 is not None:
            base32 = None
            torch.cuda.empty_cache()
        f32 = prec == "f32"
        _, per, grads = packed_value_and_grad(
            lora32 if f32 else lora, base32 if f32 else base, batch, cfg32 if f32 else cfg,
            meta.n, scales, kcfg=KernelConfig(impl=path, ranks=meta.ranks))
        grads = tree_leaves(grads)
        if not (torch.isfinite(per).all() and all(bool(torch.isfinite(g).all()) for g in grads)):
            fail(f"impl={impl}: non-finite step-1 loss or gradient on the {path} path ({prec})")
        loss[prec, path] = per
        cross = f32_layers is None  # bf16 against f32 at the same depth
        if path == plain:
            if prec == "bf16":
                errs["plain_bf16_vs_f32"] = max(grad_rel(grads, kept["f32"])) if cross else None
            kept[prec] = [g.cpu() for g in grads]
        elif prec == "f32":
            errs["f32"] = max(grad_rel(grads, kept["f32"]))
        else:
            errs["bf16"] = max(grad_rel(grads, kept["bf16"]))
            errs["kernel_bf16_vs_f32"] = max(grad_rel(grads, kept["f32"])) if cross else None
        del grads

    def loss_rel(a, b):
        return ((a - b).abs() / b.abs()).max().item()

    return {
        "step1_loss_kernel": loss["bf16", impl].tolist(),
        "step1_loss_plain": loss["bf16", plain].tolist(),
        "step1_loss_rel_err": loss_rel(loss["bf16", impl], loss["bf16", plain]),
        "step1_loss_rel_err_f32": loss_rel(loss["f32", impl], loss["f32", plain]),
        "step1_grad_rel_err_f32": errs["f32"],
        "step1_grad_rel_err_bf16": errs["bf16"],
        # the bf16 gradients' distance from the f32 plain gradient: kernel path, plain path
        "step1_grad_err_vs_f32_kernel_bf16": errs["kernel_bf16_vs_f32"],
        "step1_grad_err_vs_f32_plain_bf16": errs["plain_bf16_vs_f32"],
        "step1_f32_layers": f32_layers or cfg.n_layers,
    }


def train_setup_configs(seq: int = TRAIN_SEQ):
    """The train phase's pack as configurations: TRAIN_RANKS, TRAIN_LRS,
    TRAIN_BATCH, alpha 2r."""
    from repro_torch.configs import LoraConfig

    return [LoraConfig(rank=r, alpha=2.0 * r, learning_rate=lr, batch_size=b, seq_len=seq)
            for r, lr, b in zip(TRAIN_RANKS, TRAIN_LRS, TRAIN_BATCH)]


def train_setup(torch, dev, cfg=None, seq: int = TRAIN_SEQ, steps: int = TRAIN_STEPS):
    """The train phase's model config (qwen25-7b unless given), pack,
    initial LoRA tree and ``steps`` batches of ``seq`` tokens, all from
    seeds."""
    from repro_torch.configs import get_config
    from repro_torch.core.adapter import pack_meta
    from repro_torch.train.data import packed_batch_iterator

    cfg = cfg or get_config("qwen25-7b")
    configs = train_setup_configs(seq)
    meta = pack_meta(configs)
    batches = packed_batch_iterator(cfg, configs, seq=seq, seed=SEED, device=dev)
    return cfg, meta, train_lora(torch, cfg, meta, dev), [next(batches) for _ in range(steps)]


def train_run(torch, dev, cfg, meta, lora0, batches, base, impl: str, quant=None, phase="train",
              f32_layers=None):
    """Step 1 of ``impl`` against the plain path (``compare_step1``, its f32
    runs on ``f32_layers`` layers when given), then one
    ``make_packed_step`` step per batch with the launch counts zeroed just
    before and read just after; fails on a non-finite loss or leaf, a step
    1 outside the limits, or a count of NEEDED that stayed at 0. Returns
    (the record, the counts, the step, the last LoRA and state)."""
    from repro_torch.kernels import launches
    from repro_torch.kernels.quant import quantize_base_params
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainer import make_packed_step
    from repro_torch.tree import tree_leaves

    scales, lr_vec = meta.scales(dev), meta.lr_vector(dev)
    seq = batches[0]["tokens"].shape[1]
    nb = meta.n * meta.max_batch
    t0 = time.perf_counter()
    qbase = quantize_base_params(base, quant) if quant else base
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    cmp = compare_step1(torch, cfg, qbase, lora0, batches[0], meta, impl, scales, f32_layers)
    compare_s = time.perf_counter() - t0
    compare_peak = torch.cuda.max_memory_allocated(dev)
    step = make_packed_step(cfg, meta.n, impl=impl, ranks=meta.ranks, base_dtype=quant)
    lora, opt = lora0, init_opt_state(lora0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the comparison's cached blocks: the steps start unfragmented
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    times, losses = [], []
    for batch in batches:
        t0 = time.perf_counter()
        lora, opt, m = step(qbase, lora, opt, batch, scales, lr_vec, None)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(m["per_adapter_loss"].tolist())
    counts = train_counts()
    key = f"{impl}+{quant}" if quant else impl
    finite = all(math.isfinite(v) for row in losses for v in row) and all(
        bool(torch.isfinite(t).all()) for t in tree_leaves(lora))
    row = {"phase": phase, "model": cfg.name, "n_layers": cfg.n_layers, "impl": impl,
           "quant": quant, "seq": seq, "steps": len(batches),
           "step_s": times, "step_s_after_first": sum(times[1:]) / (len(times) - 1),
           "tokens_per_s": nb * seq * (len(times) - 1) / sum(times[1:]),
           "per_adapter_loss": losses, **cmp, "loss_rtol": LOSS_RTOL,
           "grad_tol_f32": GRAD_TOL_F32, "bf16_grad_factor": BF16_GRAD_FACTOR,
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "compare_max_memory_allocated": compare_peak,
           "base_resident_bytes": resident_bytes(qbase), "quantize_s": quant_s,
           "compare_s": compare_s, "launches": counts,
           "launches_by_path": launches.read_paths()}
    emit(row)
    what = f"{cfg.name} impl={key}"
    if not finite:
        fail(f"{what}: non-finite loss or LoRA leaf after {len(batches)} steps")
    if not cmp["step1_loss_rel_err"] <= LOSS_RTOL:
        fail(f"{what}: step-1 loss differs from the plain path by "
             f"{cmp['step1_loss_rel_err']} > {LOSS_RTOL}")
    if not cmp["step1_grad_rel_err_f32"] <= GRAD_TOL_F32:
        fail(f"{what}: step-1 LoRA gradient (f32) differs from the plain path by "
             f"{cmp['step1_grad_rel_err_f32']} > {GRAD_TOL_F32}")
    noise = BF16_GRAD_FACTOR * (cmp["step1_grad_err_vs_f32_plain_bf16"] or 0.0)
    if f32_layers is None and not cmp["step1_grad_err_vs_f32_kernel_bf16"] <= noise:
        fail(f"{what}: step-1 bf16 LoRA gradient is {cmp['step1_grad_err_vs_f32_kernel_bf16']} "
             f"from the f32 gradient, more than {BF16_GRAD_FACTOR} x the plain path's")
    for need in NEEDED[(impl, quant)]:
        if counts[need] == 0:
            fail(f"{what}: the {need} launch count stayed at 0 over {len(batches)} steps")
    return row, counts, (qbase, step, lora, opt)


def cut_decoder(cfg, dec, n_layers: int):
    """The ``"decoder"`` subtree ``dec`` of a tree laid out as ``cfg``'s (a
    base, or a LoRA pack, whose layers without an adapter have no entry),
    cut to its first ``n_layers`` layers and laid out as a model of that
    depth, of views. With the cut's own layer period q equal to the
    model's p (gemma3's 6), it keeps the first n_layers // p stacked
    blocks and, as its ``rest``, layers of the pattern's first n_layers % p
    specs: the tree's own ``rest`` where it has them (random weights: any
    layer of the right spec will do), else the next block's. A cut within
    one period (jamba's first 4 of 8: SSD + dense, SSD + MoE, SSD + dense,
    attention + MoE, a period of its own) takes its block's layers from the
    first block, ``t[:1]``, and its ``rest`` from the first block's next
    layers."""
    from repro_torch.models.transformer import find_period, layer_specs
    from repro_torch.tree import tree_index, tree_map

    p = find_period(layer_specs(cfg))
    q = find_period(layer_specs(cfg.replace(n_layers=n_layers)))
    n_blocks, n_rest = divmod(n_layers, q)
    if n_layers > cfg.n_layers or (q != p and n_blocks > 1):
        fail(f"{cfg.name}: cannot cut {cfg.n_layers} layers to {n_layers}")
    blocks, rest = dec["blocks"] or {}, dec["rest"]
    if q == p:
        src = ({k: rest[k] for k in rest} if n_rest <= len(rest)
               else {k: tree_index(t, n_blocks) for k, t in blocks.items()})
        return {"blocks": tree_map(lambda t: t[:n_blocks], blocks),
                "rest": {f"l{i}": src[f"l{i}"] for i in range(n_rest) if f"l{i}" in src}}
    head = {k: t for k, t in blocks.items() if int(k[1:]) < n_blocks * q}
    return {"blocks": tree_map(lambda t: t[:1], head),
            "rest": {f"l{i}": tree_index(blocks[f"l{n_blocks * q + i}"], 0)
                     for i in range(n_rest) if f"l{n_blocks * q + i}" in blocks}}


def depth_cut(cfg, base, n_layers: int):
    """A decoder cut to ``n_layers`` layers: its config and a view of
    ``base`` (``cut_decoder``)."""
    return cfg.replace(n_layers=n_layers), {
        **base, "decoder": cut_decoder(cfg, base["decoder"], n_layers)}


def depth_cut_lora(cfg, lora, n_layers: int):
    """A pack's LoRA tree cut as ``depth_cut`` cuts the base of ``cfg``."""
    return {"decoder": cut_decoder(cfg, lora["decoder"], n_layers)}


def train_phase(torch, dev, base, out_dir: Path):
    """TRAIN_STEPS steps of ``make_packed_step`` per run of TRAIN_RUNS on
    the first TRAIN_LAYERS layers of the dense bf16 base ``base``
    (quantized per run); returns the launch counts of each run's steps."""
    from repro_torch.configs import get_config

    cfg, base = depth_cut(get_config("qwen25-7b"), base, TRAIN_LAYERS)
    cfg, meta, lora0, batches = train_setup(torch, dev, cfg)
    nb = meta.n * max(TRAIN_BATCH)
    emit({"phase": "train_setup", "model": cfg.name, "n_layers": cfg.n_layers, "ranks": list(meta.ranks),
          "alphas": list(meta.alphas), "lrs": list(meta.learning_rates), "batch_sizes": list(TRAIN_BATCH),
          "seq": TRAIN_SEQ, "rows": nb, "tokens_per_step": nb * TRAIN_SEQ,
          "lora_bytes": resident_bytes(lora0)})
    launches = {}
    for impl, quant in TRAIN_RUNS:
        _, counts, (qbase, step, lora, opt) = train_run(torch, dev, cfg, meta, lora0, batches,
                                                        base, impl, quant)
        launches[f"{impl}+{quant}" if quant else impl] = counts
        if quant in (None, "nf4"):
            profile_train(torch, step, qbase, lora, opt, batches[0], meta, out_dir, impl, quant)
            sync_free_train_step(torch, cfg, meta, qbase, lora, opt, batches[0], impl, quant)
        del qbase, lora, opt, step
        torch.cuda.empty_cache()
    return launches


def is_packed_kernel(name: str) -> bool:
    """A device kernel of ``packed_matmul`` (``csrc/packed_matmul.cu``: its
    products in namespace ``plora`` and its split-K reduction). Under
    impl="auto" no other kernel of the port runs in a train step."""
    return "plora::" in name or name.startswith("void reduce_kernel<")


def packed_share(prof, device_ms: float) -> dict:
    """``packed_matmul``'s device time, launches and share of a profile."""
    from torch.autograd import DeviceType

    packed = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation and is_packed_kernel(e.key)]
    ms = sum(e.self_device_time_total for e in packed) / 1e3
    return {"packed_matmul_device_ms": ms, "packed_matmul_launches": sum(e.count for e in packed),
            "packed_matmul_device_share": ms / device_ms}


def profile_train(torch, step, base, lora, opt, batch, meta, out_dir: Path, impl: str, quant):
    """One step under ``torch.profiler``: the device busy share, the top
    device operations and, under impl="auto", ``packed_matmul``'s share of
    the device time; the table goes to
    ``smoke_out/profile_train_<quant or impl>.txt``."""
    from torch.profiler import ProfilerActivity, profile

    dev = base["embed"]["w"].device
    scales, lr_vec = meta.scales(dev), meta.lr_vector(dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(base, lora, opt, batch, scales, lr_vec, None)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    res = read_profile(prof, wall_ms, out_dir / f"profile_train_{quant or impl}.txt")
    if impl == "auto":
        res.update(packed_share(prof, res["device_ms"]))
    row = {"phase": "train_profile", "impl": impl, "quant": quant, **res}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# sweep phase
# ---------------------------------------------------------------------------

# default_search_space(300, seq_len=512)[::37]: 9 configurations, ranks
# 8-128, batch sizes 1-4, alpha r/4-4r, learning rates 2e-5-4e-4
SWEEP_SEQ = 512
SWEEP_EVERY = 37
SWEEP_STEPS = 4
# packed_matmul's calls in a train step under impl="auto": the delta's two
# passes and the N-D backward's cases 2 and 4
SWEEP_CALLS = ("xA", "xAB", "bwd2_dxA", "bwd4_dx")


def sweep_plan():
    """The sweep's space, cost model, plan and ``min_gpu_schedule`` (pure
    Python, milliseconds: the kernel phase reads the plan's shapes too)."""
    from types import SimpleNamespace

    from repro_torch.configs import default_search_space, get_config
    from repro_torch.sched import H100, CostModel, min_gpu_schedule, plan

    cfg = get_config("qwen25-7b").replace(n_layers=SWEEP_LAYERS)
    space = default_search_space(300, seq_len=SWEEP_SEQ)[::SWEEP_EVERY]
    cm = CostModel(cfg, H100)
    t0 = time.perf_counter()
    sched = plan(cm, space, 1, SWEEP_SEQ, SWEEP_STEPS)
    plan_s = time.perf_counter() - t0
    return SimpleNamespace(
        cfg=cfg, space=space, cm=cm, sched=sched, plan_s=plan_s,
        mingpu=min_gpu_schedule(cm, space, 1, SWEEP_SEQ, SWEEP_STEPS),
        jobs=[[space[i] for i in j.config_ids] for j in sched.jobs])


def sweep_segments(jobs):
    """(job, N, M, r) of each group of ``packed_matmul`` calls that one
    step of each job makes: one per same-rank segment of its pack
    (``ops.rank_segments``; a pack of one rank is one segment), M = the
    pack's rows per adapter times SWEEP_SEQ tokens."""
    from repro_torch.core.adapter import pack_meta
    from repro_torch.kernels.ops import rank_segments

    out = []
    for job, configs in enumerate(jobs):
        meta = pack_meta(configs)
        out += [(job, hi - lo, meta.max_batch * SWEEP_SEQ, r)
                for lo, hi, r in rank_segments(meta.ranks)[2]]
    return out


def fit_preset(cm, timings, jobs, seq: int) -> dict:
    """``sat_tokens`` and ``layer_overhead`` of the cost model's hardware
    spec fitted to the measured seconds per iteration of the planned jobs:
    for each ``sat_tokens`` of a log grid, the least-squares ``layer_overhead
    >= 0`` of the relative errors, and the grid point with the least sum of
    squared relative errors."""
    layers = cm.cfg.n_layers
    best = None
    for sat in np.logspace(0, 6, 241):
        probe = type(cm)(cm.cfg, cm.hw.scaled(sat_tokens=float(sat), layer_overhead=0.0))
        base = [probe.iter_time(jc, 1, seq) for jc in jobs]
        w = [1.0 / t ** 2 for t in timings]
        lo = max(0.0, sum(wi * (t - b) for wi, t, b in zip(w, timings, base))
                 / (layers * sum(w)))
        err = sum(((b + layers * lo) / t - 1.0) ** 2 for b, t in zip(base, timings))
        if best is None or err < best["sum_sq_rel_err"]:
            best = {"sat_tokens": float(sat), "layer_overhead": lo, "sum_sq_rel_err": err,
                    "predicted_s_per_iter": [b + layers * lo for b in base]}
    return best


class StepWindow:
    """A ``train_pack`` step callback: each step's per-adapter loss, the
    seconds between the ends of consecutive steps (it synchronises after
    every step) and, with ``profile_step``, that one step under
    ``torch.profiler`` (started at the end of the step before it; its table
    goes to ``table``), read into ``profile``."""

    def __init__(self, torch, dev, profile_step=None, table=None):
        self.torch, self.dev, self.profile_step, self.table = torch, dev, profile_step, table
        self.losses, self.seconds, self.profile = [], [], None
        self._t = self._prof = None

    def __call__(self, i, metrics):
        self.torch.cuda.synchronize(self.dev)
        now = time.perf_counter()
        if self._prof is not None:  # the profiled step has ended
            self._prof.stop()
            self.profile = read_profile(self._prof, 1e3 * (now - self._t), self.table)
            self.profile.update(packed_share(self._prof, self.profile["device_ms"]))
            self._prof = None
        elif self._t is not None:
            self.seconds.append(now - self._t)
        self.losses.append(metrics["per_adapter_loss"].clone())
        if i + 1 == self.profile_step:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self._prof.start()
        self._t = time.perf_counter()


def compare_runs(torch, what: str, cap_losses, eager_losses, cap_adapters, eager_lora, ranks):
    """Captured against eager: per-adapter losses and the adapters' weights,
    bit for bit; if not, the losses are held at LOSS_RTOL (step 1's
    tolerance). Returns the comparison's numbers."""
    from repro_torch.core.packed_lora import extract_adapter
    from repro_torch.tree import tree_leaves

    cap, eag = torch.as_tensor(np.asarray(cap_losses)), eager_losses.cpu()
    loss_equal = bool(torch.equal(cap, eag))
    loss_rel = ((cap - eag).abs() / eag.abs()).max().item()
    w_equal, w_rel = True, 0.0
    for slot, ad in enumerate(cap_adapters):
        ref = extract_adapter(eager_lora, slot, ranks)
        for a, b in zip(tree_leaves(ad), tree_leaves(ref)):
            w_equal &= bool(np.array_equal(a, b))
            w_rel = max(w_rel, float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)))
    res = {"bitwise": loss_equal and w_equal, "loss_equal": loss_equal,
           "loss_rel_err": loss_rel, "weights_equal": w_equal, "weights_rel_err": w_rel}
    if not res["bitwise"] and not loss_rel <= LOSS_RTOL:
        fail(f"{what}: captured losses differ from the eager run's by {loss_rel} > {LOSS_RTOL}")
    return res


def sweep_phase(torch, dev, base, out_dir: Path):
    """The planner-driven sweep on qwen25-7b at full width cut to its first
    SWEEP_LAYERS layers (a view of ``base``): plan the space on the H100
    preset, run every job through ``ExecutionEngine.run_local`` with the
    captured executor (impl="auto"), then hold each job, and a cache hit of
    the last job's shape, against runs of an eager executor
    (``SliceExecutor(capture=False)``). Returns the launch counts of the
    run."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.sched import H100
    from repro_torch.train.checkpoint import CheckpointPool

    sw = sweep_plan()
    _, base = depth_cut(get_config("qwen25-7b"), base, SWEEP_LAYERS)
    emit({"phase": "sweep_plan", "hw": H100.name, "n_layers": sw.cfg.n_layers, "configs": [
              {"id": i, "rank": c.rank, "alpha": c.alpha, "lr": c.learning_rate,
               "batch_size": c.batch_size} for i, c in enumerate(sw.space)],
          "jobs": [{"config_ids": list(j.config_ids), "start": j.start, "end": j.end,
                    "predicted_s_per_iter": sw.cm.iter_time(jc, 1, SWEEP_SEQ),
                    "job_mem_bytes": sw.cm.job_mem_bytes(jc, 1, SWEEP_SEQ)}
                   for j, jc in zip(sw.sched.jobs, sw.jobs)],
          "kernel_segments": sweep_segments(sw.jobs),
          "planned_makespan_s": sw.sched.makespan, "setup_s_per_job": sw.cm.setup_time,
          "min_gpu_makespan_s": sw.mingpu.makespan, "plan_s": sw.plan_s})
    if len(sw.sched.jobs) < 2:
        fail(f"the planner made {len(sw.sched.jobs)} job(s) of the sweep space; the phase "
             "needs two shapes for its cache checks")
    # GBs of f32 adapters: kept out of smoke_out/ and removed when the phase ends
    pool_dir = ROOT / "smoke_pool"
    shutil.rmtree(pool_dir, ignore_errors=True)
    try:
        return _sweep(torch, dev, base, out_dir, sw, CheckpointPool(str(pool_dir)))
    finally:
        shutil.rmtree(pool_dir, ignore_errors=True)


def _sweep(torch, dev, base, out_dir, sw, pool):
    from repro_torch.cluster import DevicePool, SliceExecutor
    from repro_torch.cluster.executor import WARMUP_STEPS
    from repro_torch.configs import LoraConfig
    from repro_torch.core.adapter import pack_meta
    from repro_torch.core.packed_lora import extract_adapter, inject_adapter
    from repro_torch.models.model import lora_zeros
    from repro_torch.obs import MetricsTracer
    from repro_torch.sched import H100, ExecutionEngine, plan
    from repro_torch.serve import ServeEngine
    from repro_torch.tree import tree_leaves, tree_map

    cfg, space, cm, sched, jobs = sw.cfg, sw.space, sw.cm, sw.sched, sw.jobs
    tracer = MetricsTracer()
    ex = SliceExecutor(tracer=tracer)
    # the tune side runs through the serve engine (a Runner), which then
    # serves the pool its jobs fill (tune_serve)
    engine = ServeEngine(cfg, base, rows=TS_ROWS, smax=TS_SMAX, r_bucket=TS_R_BUCKET,
                         slot_capacity=TS_SLOTS, checkpoint_pool=pool,
                         device_pool=DevicePool([dev]), train_executor=ex, impl="auto",
                         seed=TS_SEED, tracer=tracer, device=dev)
    torch.cuda.synchronize(dev)
    held = held_bytes(torch, dev, base)
    zero_counts()
    t0 = time.perf_counter()
    records, makespan = ExecutionEngine(cm, 1, tracer=tracer).run_local(
        sched, space, cfg, base, n_steps=SWEEP_STEPS, seq=SWEEP_SEQ, pool=pool, runner=engine,
        impl="auto")
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = train_counts()
    timings = {t.job_id: t for t in engine.last_result.timings}
    rows = []
    for job_id, (j, rec) in enumerate(zip(sched.jobs, records)):
        t, m = timings[job_id], pack_meta(jobs[job_id])
        cap = ex.captures[job_id] if job_id < len(ex.captures) else {}
        rows.append({"job": job_id, "config_ids": list(j.config_ids),
                     "ranks": list(m.ranks), "rows": m.n * m.max_batch,
                     "tokens_per_step": m.n * m.max_batch * SWEEP_SEQ,
                     "predicted_s_per_iter": t.predicted_iter, "measured_s_per_iter": t.measured_iter,
                     "drift": t.drift, "wall_s": rec.wall_seconds,
                     "final_losses": [float(x) for x in rec.final_losses],
                     "peak_allocated_bytes": rec.peak_bytes,
                     "job_peak_bytes": rec.peak_bytes - held,
                     "job_mem_bytes": cm.job_mem_bytes(jobs[job_id], 1, SWEEP_SEQ),
                     "graph_pool_bytes": cap.get("pool_bytes"),
                     "graph_static_bytes": cap.get("static_bytes"),
                     "warmup_transient_bytes": cap.get("transient_bytes"),
                     "capture_s": cap.get("seconds"), "captured": rec.captured})
    names = pool.list()
    metas = {n: pool.load_meta(n) for n in names}
    fit = fit_preset(cm, [r["measured_s_per_iter"] for r in rows], jobs, SWEEP_SEQ)
    fitted = type(cm)(cfg, H100.scaled(sat_tokens=fit["sat_tokens"],
                                        layer_overhead=fit["layer_overhead"]))
    fit["plan_config_ids"] = [list(j.config_ids) for j in plan(
        fitted, space, 1, SWEEP_SEQ, SWEEP_STEPS).jobs]
    builds, hits = ex.n_builds, ex.n_hits
    emit({"phase": "sweep", "runner": type(engine).__name__, "jobs": rows, "held_bytes": held,
          "wall_s": wall,
          "measured_makespan_s": makespan,
          "planned_makespan_s": sched.makespan, "min_gpu_makespan_s": sw.mingpu.makespan,
          "planned_compute_s": sum(cm.iter_time(jc, 1, SWEEP_SEQ) * SWEEP_STEPS for jc in jobs),
          "executor_builds": builds, "executor_hits": hits, "launches": launches,
          "graph_replays": SWEEP_STEPS * len(records), "metrics": tracer.metrics.to_json(),
          "pool": names, "h100_fit": fit})
    want = [f"adapter_{i:04d}" for i in range(len(space))]
    if names != want:
        fail(f"the pool holds {names}, not the sweep's {len(want)} adapters")
    if not all(math.isfinite(m["final_loss"]) for m in metas.values()):
        fail("an adapter in the pool has a non-finite final loss")
    for need in ("packed_matmul", "packed_matmul_bwd"):
        if launches[need] == 0:
            fail(f"the sweep launched {need} no time")
    if ((builds, hits) != (len(records), 0) or len(ex.captures) != len(records)
            or not all(rec.captured for rec in records)):
        fail(f"the sweep built {builds} steps and hit {hits} for {len(records)} job shapes")
    c3_check("the sweep", rows, [[space[i] for i in j.config_ids] for j in sched.jobs], cfg)

    # a further pack of job 1's shape (the last job, whose graph the cache
    # holds), with other learning rates and alphas: the cache must hit, and
    # its steps equal the eager run's. Its last replay runs under the profiler.
    hit_cfgs = [LoraConfig(rank=c.rank, alpha=2.0 * c.alpha, learning_rate=0.5 * c.learning_rate,
                           batch_size=c.batch_size, seq_len=SWEEP_SEQ) for c in jobs[-1]]
    meta = pack_meta(hit_cfgs)
    slice_ = DevicePool([dev]).acquire(1)
    hit = StepWindow(torch, dev, SWEEP_STEPS - 1, out_dir / "profile_sweep_captured.txt")
    res = ex.train_pack(cfg, hit_cfgs, n_steps=SWEEP_STEPS, seq=SWEEP_SEQ, base=base,
                        slice_=slice_, step_callback=hit)
    if (ex.n_builds, ex.n_hits) != (builds, hits + 1) or len(ex.captures) != len(records):
        fail(f"job {len(jobs) - 1}'s shape did not hit the step cache ({ex.n_builds} builds, "
             f"{ex.n_hits} hits)")
    hit_adapters = [extract_adapter(res.lora, s, meta.ranks) for s in range(meta.n)]
    # extract -> inject of one adapter, on the card: into a one-adapter pack
    # of zeros, back to the card, and out again
    slot = meta.n - 1
    one = pack_meta([hit_cfgs[slot]])
    packed = inject_adapter(lora_zeros(cfg, one, torch.float32, "cpu"), hit_adapters[slot], 0)
    again = extract_adapter(tree_map(lambda a: torch.from_numpy(a).to(dev), packed), 0, one.ranks)
    roundtrip = all(np.array_equal(a, b) for a, b in zip(tree_leaves(again),
                                                          tree_leaves(hit_adapters[slot])))
    del res
    ex.clear()
    torch.cuda.empty_cache()

    # the eager executor from the same initial weights (the captured one's
    # templates), budgets and data; its last step of job 1 under the profiler
    eager = SliceExecutor(capture=False)
    checks, eager_launches = [], []
    for job_id, jc in enumerate(jobs):
        m = pack_meta(jc)
        win = StepWindow(torch, dev, SWEEP_STEPS - 1 if job_id == len(jobs) - 1 else None,
                         out_dir / "profile_sweep_eager.txt")
        zero_counts()
        res = eager.train_pack(cfg, jc, n_steps=SWEEP_STEPS, seq=SWEEP_SEQ, base=base,
                               lora=ex.pack_template(cfg, jc, 0, dev)[0], slice_=slice_,
                               budgets=np.full((m.n,), SWEEP_STEPS, np.int32), step_callback=win)
        eager_launches.append(train_counts())
        cap_ads = [pool.load_adapter(f"adapter_{i:04d}") for i in sched.jobs[job_id].config_ids]
        cmp = compare_runs(torch, f"sweep job {job_id}", [records[job_id].final_losses],
                           torch.stack(win.losses[-1:]), cap_ads, res.lora, m.ranks)
        checks.append({"job": job_id, **cmp, "eager_step_s": win.seconds,
                       "captured_step_s": rows[job_id]["measured_s_per_iter"],
                       "eager_peak_allocated_bytes": res.peak_bytes,
                       **({"eager_profile": win.profile} if win.profile else {})})
        del res
        torch.cuda.empty_cache()
    # each job: a warm-up step and SWEEP_STEPS replays, each launching what
    # one eager step launches
    expect = {k: sum(c[k] for c in eager_launches) * (WARMUP_STEPS + SWEEP_STEPS) // SWEEP_STEPS
              for k in launches}
    win = StepWindow(torch, dev)
    res = eager.train_pack(cfg, hit_cfgs, n_steps=SWEEP_STEPS, seq=SWEEP_SEQ, base=base,
                           lora=ex.pack_template(cfg, hit_cfgs, 0, dev)[0], slice_=slice_,
                           step_callback=win)
    hit_cmp = compare_runs(torch, "the cache hit", torch.stack(hit.losses).cpu().numpy(),
                           torch.stack(win.losses), hit_adapters, res.lora, meta.ranks)
    del res
    emit({"phase": "sweep_checks", "jobs": checks,
          "cache_hit": {**hit_cmp, "captured_step_s": hit.seconds, "eager_step_s": win.seconds},
          "extract_inject_bit_exact": roundtrip, "captured_profile": hit.profile,
          "launches_expected_from_eager": expect})
    if not roundtrip:
        fail("extract -> inject -> extract of an adapter on the card is not bit-exact")
    if launches != expect:
        fail(f"the sweep counted {launches} launches; its eager steps make {expect}")
    del eager, win, hit
    torch.cuda.empty_cache()
    ts_launches = tune_serve(torch, dev, cfg, base, pool, engine, metas)
    return launches, ts_launches


# ---------------------------------------------------------------------------
# tune-then-serve: the sweep's pool served, sampled, merged
# ---------------------------------------------------------------------------

# the sweep's 9 adapters (ranks 8-128) served at a rank bucket of 128 from 4
# slots: 12 requests in 3 waves of 4 (a wave's adapters fit the slots, which
# active rows pin), TS_NEW tokens each, so that misses and evictions happen;
# every odd request sampled at TS_TEMP / TS_TOP_K
TS_ROWS, TS_SLOTS, TS_R_BUCKET = 8, 4, 128
TS_ADAPTERS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 0, 4, 8)
TS_WAVE = 4
TS_NEW = 16
TS_PROMPT = (64, 257)
TS_SMAX = 512
TS_TEMP, TS_TOP_K = 0.8, 50
TS_SEED = 7
TS_MIN_MISSES = 9
# the sampler on the card: draws per logits row, in batches; its law
TS_DRAWS, TS_DRAW_BATCH = 16_384, 1024
TS_TV = 0.05
TS_MERGE_STEPS = 4
TS_CASE = "decode_r128"  # the kernel phase's rows at the engine's decode shape
TS_KERNELS = {"auto": "packed_matmul", "fused": "fused_matmul"}


def ts_requests(names, prompts, sampled: bool):
    """The 12 requests: wave w arrives at step w * TS_NEW (after the wave
    before has retired); odd ones sampled when ``sampled``."""
    from repro_torch.serve import ServeRequest

    return [ServeRequest(i, names[a], prompts[i], max_new_tokens=TS_NEW,
                         arrival=float(i // TS_WAVE * TS_NEW),
                         temperature=TS_TEMP if sampled and i % 2 else 0.0,
                         top_k=TS_TOP_K if sampled and i % 2 else 0)
            for i, a in enumerate(TS_ADAPTERS)]


def ts_drain(torch, eng, reqs, what: str):
    """One drain with the launch counts zeroed just before it and read just
    after: (stats, tokens (R, TS_NEW), launches by kernel and path)."""
    from repro_torch.kernels import launches as launch_counts

    zero_counts()
    stats = eng.serve(reqs)
    torch.cuda.synchronize()
    by_path = launch_counts.read_paths()
    bad = [(r.request_id, r.error) for r in stats.results
           if r.error is not None or len(r.tokens) != TS_NEW]
    if bad or len(stats.results) != len(reqs):
        fail(f"tune_serve {what}: requests failed: {bad}")
    toks = np.stack([r.tokens for r in stats.results])
    if toks.min() < 0 or toks.max() >= eng.cfg.vocab_size:
        fail(f"tune_serve {what}: token ids outside the vocabulary")
    return stats, toks, by_path


def ts_sampler(torch, dev, cfg, base, prompts) -> dict:
    """``sample_tokens`` on 2 rows of the base's real last-position logits:
    TS_DRAWS draws a row at TS_TEMP / TS_TOP_K against the exact softmax of
    the masked logits (ties at the k-th value kept); and one call's time at
    the engine's TS_ROWS rows beside the greedy argmax's."""
    from repro_torch.models.model import prefill
    from repro_torch.serve import sample_tokens

    v = cfg.vocab_size
    one = torch.ones((1,), device=dev)
    rows = []
    with torch.no_grad():
        for p in prompts[:2]:
            lg, _ = prefill(base, None, one, {"tokens": torch.from_numpy(p[None]).to(dev)}, cfg)
            rows.append(lg[0, -1, :v].float())
    gen = torch.Generator(device=dev).manual_seed(SEED)
    temp = torch.full((TS_DRAW_BATCH,), TS_TEMP, device=dev)
    topk = torch.full((TS_DRAW_BATCH,), TS_TOP_K, dtype=torch.int32, device=dev)
    out = []
    for row in rows:
        thresh = torch.sort(row).values[v - TS_TOP_K]
        keep = row >= thresh
        exact = torch.softmax(torch.where(keep, row, float("-inf")).double() / TS_TEMP, 0)
        counts = torch.zeros(v, dtype=torch.float64, device=dev)
        for _ in range(TS_DRAWS // TS_DRAW_BATCH):
            toks = sample_tokens(row[None].expand(TS_DRAW_BATCH, -1), temp, topk, gen)
            counts += torch.bincount(toks.long(), minlength=v).double()
        freq = counts / counts.sum()
        out.append({"kept": int(keep.sum()), "outside_top_k": int(counts[~keep].sum()),
                    "tv": 0.5 * float((freq - exact).abs().sum()),
                    "max_prob": float(exact.max())})
    lg8 = torch.stack(rows * (TS_ROWS // 2)).to(torch.bfloat16)
    t8 = torch.tensor([TS_TEMP if i % 2 else 0.0 for i in range(TS_ROWS)], device=dev)
    k8 = torch.full((TS_ROWS,), TS_TOP_K, dtype=torch.int32, device=dev)
    ms = time_ms(torch, sample_tokens, [(lg8, t8, k8, gen)])
    argmax_ms = time_ms(torch, lambda x: torch.argmax(x, dim=-1), [(lg8,)])
    return {"rows": out, "draws_per_row": TS_DRAWS, "sample_ms_8_rows": ms,
            "argmax_ms_8_rows": argmax_ms}


def ts_merge(torch, dev, cfg, base, pool, name: str, prompts) -> dict:
    """``merge_model`` of pool adapter ``name`` into the bf16 base: the
    merged base with no adapter, teacher-forced over 2 prompts and
    TS_MERGE_STEPS decode steps, against the "auto" kernel path with the
    adapter (the adapter path's greedy tokens fed to both)."""
    from repro_torch import bridge
    from repro_torch.configs import LoraConfig
    from repro_torch.core.adapter import pack_meta
    from repro_torch.core.packed_lora import inject_adapter, merge_model
    from repro_torch.models.model import decode_step, lora_zeros, prefill
    from repro_torch.serve.decode import pad_caches
    from repro_torch.tree import tree_map

    meta = pool.load_meta(name)
    meta1 = pack_meta([LoraConfig(rank=meta["rank"], alpha=meta["alpha"])])
    tmpl = tree_map(lambda t: t.numpy(), lora_zeros(cfg, meta1, torch.float32, "cpu"))
    lora32 = bridge.to_torch(inject_adapter(tmpl, pool.load_adapter(name), 0), dev)
    lora16 = tree_map(lambda t: t.to(torch.bfloat16), lora32)
    scales = meta1.scales(dev)
    kc = meta1.kernel_config("auto")
    v = cfg.vocab_size
    with torch.no_grad():
        t0 = time.perf_counter()
        merged = merge_model(base, lora32, scales, 0)
        torch.cuda.synchronize(dev)
        merge_s = time.perf_counter() - t0
        per_step, ref_max = [0.0] * (1 + TS_MERGE_STEPS), 0.0
        for p in prompts[:2]:
            batch = {"tokens": torch.from_numpy(p[None]).to(dev)}
            la, ca = prefill(base, lora16, scales, batch, cfg, kcfg=kc)
            lm, cm = prefill(merged, None, scales, batch, cfg)
            ca, cm = (pad_caches(c, len(p) + TS_MERGE_STEPS) for c in (ca, cm))
            for s in range(1 + TS_MERGE_STEPS):
                if s:
                    tok = torch.argmax(la[:, -1, :v], dim=-1).to(torch.int32)[:, None]
                    pos = torch.tensor(len(p) + s - 1, device=dev)
                    la, ca = decode_step(base, lora16, scales, tok, ca, pos, cfg, kcfg=kc)
                    lm, cm = decode_step(merged, None, scales, tok, cm, pos, cfg)
                a, m = la[0, -1, :v].float(), lm[0, -1, :v].float()
                if not (torch.isfinite(a).all() and torch.isfinite(m).all()):
                    fail("tune_serve merge: non-finite logits")
                per_step[s] = max(per_step[s], (a - m).abs().max().item())
                ref_max = max(ref_max, a.abs().max().item())
        del merged
    return {"adapter": name, "rank": meta["rank"], "alpha": meta["alpha"], "merge_s": merge_s,
            "max_abs_err_prefill": per_step[0], "max_abs_err_decode": per_step[1:],
            "max_abs_logit": ref_max, "rel_err": max(per_step) / ref_max, "tol": LOGIT_TOL}


def tune_serve(torch, dev, cfg, base, pool, engine, metas) -> dict:
    """Tune-then-serve on the sweep's pool, on its 8-layer base: the 12
    requests (``ts_requests``) through the sweep's own ``engine`` (impl
    "auto") and a fused one, each adapter loaded from the pool on a slot
    miss: a mixed drain, its repeat under the same seed, an all-greedy
    drain and its repeat; under "fused" also a drain over the adapters
    ``publish``ed from ``pool.load_adapter``. Then the sampler on the
    card (``ts_sampler``) and a merged base (``ts_merge``). Returns the
    decode-path launches of each impl's mixed drain."""
    from repro_torch.cluster import DevicePool
    from repro_torch.serve import ServeEngine

    names = sorted(metas)
    rng = np.random.RandomState(SEED + 4)
    prompts = [rng.randint(0, cfg.vocab_size, size=rng.randint(*TS_PROMPT)).astype(np.int32)
               for _ in TS_ADAPTERS]
    mixed_reqs, greedy_reqs = (ts_requests(names, prompts, s) for s in (True, False))
    sampled = np.array([r.temperature > 0 for r in mixed_reqs])
    rec, launches = {"requests": len(mixed_reqs), "new_tokens": TS_NEW, "rows": TS_ROWS,
                     "slot_capacity": TS_SLOTS, "r_bucket": TS_R_BUCKET,
                     "adapter_ranks": [metas[n]["rank"] for n in names],
                     "temperature": TS_TEMP, "top_k": TS_TOP_K, "seed": TS_SEED}, {}
    t0 = time.perf_counter()
    for impl in ("auto", "fused"):
        eng = engine if impl == "auto" else ServeEngine(
            cfg, base, rows=TS_ROWS, smax=TS_SMAX, r_bucket=TS_R_BUCKET, slot_capacity=TS_SLOTS,
            checkpoint_pool=pool, device_pool=DevicePool([dev]), impl=impl, seed=TS_SEED,
            device=dev)
        kernel = TS_KERNELS[impl]
        stats, mixed, by_path = ts_drain(torch, eng, mixed_reqs, f"{impl} mixed")
        launches[impl] = {kernel: by_path[kernel].get("decode", 0)}
        cache = {"hits": stats.cache_hits, "misses": stats.cache_misses,
                 "evictions": stats.cache_evictions}
        _, again, _ = ts_drain(torch, eng, mixed_reqs, f"{impl} mixed, again")
        _, greedy, _ = ts_drain(torch, eng, greedy_reqs, f"{impl} all-greedy")
        _, greedy2, _ = ts_drain(torch, eng, greedy_reqs, f"{impl} all-greedy, again")
        lat = stats.latency_summaries()
        r = {"cache": cache, "launches_by_path": by_path, "wall_s": stats.wall_seconds,
             "captures": list(eng.captures),
             "steps": stats.steps, "tokens_per_s": stats.tokens_per_s,
             "ttft": lat["ttft"], "itl": lat["itl"],
             "sampled_repeat_share": float((again[sampled] == mixed[sampled]).mean()),
             "greedy_repeat_share": float((greedy2 == greedy).mean()),
             "greedy_rows_match_share": float((mixed[~sampled] == greedy[~sampled]).mean()),
             "sampled_differs_from_greedy_share":
                 float((mixed[sampled] != greedy[sampled]).mean())}
        if impl == "fused":
            pub = ServeEngine(cfg, base, rows=TS_ROWS, smax=TS_SMAX, r_bucket=TS_R_BUCKET,
                              slot_capacity=len(names), device_pool=DevicePool([dev]),
                              impl=impl, seed=TS_SEED, device=dev)
            for n in names:
                pub.publish(n, pool.load_adapter(n), pool.load_meta(n))
            pstats, published, _ = ts_drain(torch, pub, mixed_reqs, "fused published")
            r["published_equal"] = bool(np.array_equal(published, mixed))
            r["published_misses"] = pstats.cache_misses
            del pub
        rec[impl] = r
        if cache["misses"] < TS_MIN_MISSES or cache["evictions"] <= 0:
            fail(f"tune_serve {impl}: {cache} (misses >= {TS_MIN_MISSES} and evictions > 0 "
                 "wanted)")
        if launches[impl][kernel] == 0:
            fail(f"tune_serve {impl}: {kernel} never launched on \"decode\" at r = "
                 f"{TS_R_BUCKET}")
        # greedy rows held to the all-greedy drain, and the sampled ones to
        # their repeat, as far as an all-greedy drain repeats itself
        floor = r["greedy_repeat_share"]
        if r["greedy_rows_match_share"] < floor or r["sampled_repeat_share"] < floor:
            fail(f"tune_serve {impl}: greedy rows match the all-greedy drain at "
                 f"{r['greedy_rows_match_share']}, sampled rows their repeat at "
                 f"{r['sampled_repeat_share']}; an all-greedy drain repeats at {floor}")
        if impl == "fused" and not r["published_equal"]:
            fail("tune_serve fused: adapters published from the pool serve other tokens than "
                 "the same adapters loaded on a miss")
        if eng is not engine:
            del eng
        torch.cuda.empty_cache()
    rec["drains_s"] = time.perf_counter() - t0
    rec["sampler"] = ts_sampler(torch, dev, cfg, base, prompts)
    for i, row in enumerate(rec["sampler"]["rows"]):
        if row["outside_top_k"] or not row["tv"] <= TS_TV:
            fail(f"tune_serve sampler row {i}: {row['outside_top_k']} draws outside the top-k "
                 f"set, total variation {row['tv']} (<= {TS_TV} wanted)")
    name = max(names, key=lambda n: (metas[n]["rank"], n))
    rec["merge"] = ts_merge(torch, dev, cfg, base, pool, name, prompts)
    if not rec["merge"]["rel_err"] <= LOGIT_TOL:
        fail(f"tune_serve merge: the merged base's logits differ from the adapter path's by "
             f"{rec['merge']['rel_err']} > {LOGIT_TOL}")
    emit({"phase": "tune_serve", **rec})
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# multihost phase
# ---------------------------------------------------------------------------

# four batch-1 adapters of default_search_space(300, seq_len=512), ranks 8,
# 8, 16 and 16, as two jobs of two adapters, one per host from t = 0: the
# planner packs all four into one job on the H100 preset (``multihost_plan``
# prints its plan), so the schedule is given by hand
MH_IDS = (0, 37, 74, 110)
MH_JOBS = ((0, 1), (2, 3))
MH_STEPS = 4
# the heartbeat interval: a host is declared dead 12 intervals after its
# last pong (a timeout of 3 intervals, doubled at each of the 3 misses), and
# a worker answers no ping while it takes its init (the 8-layer base, 5.9 GB
# of bf16, sent through a pipe and placed on the card), so 12 intervals
# must cover a cold worker's init with room: 24 s against its 12.1-12.5 s
# with both workers taking theirs at once beside their warm-up steps (H100
# 80GB HBM3, 700 W)
MH_HEARTBEAT = 2.0
# the kill lands this long after host 0's segment request goes out: while
# the worker takes its init (12.1-12.5 s beside its warm-up step, H100 80GB
# HBM3, 700 W), so the killed attempt costs little besides its spawn
MH_KILL_DELAY = 1.0
MH_KILL_ATTEMPTS = 2  # a cold dispatcher each, should the segment end first
# the card's free memory after close() against its level before the
# dispatcher started: every worker's context and memory must be gone
MH_MEM_SLACK = 128 * 2**20


def mh_plan():
    """(config cut to SWEEP_LAYERS, the four adapters, the H100 cost model,
    the hand schedule, the planner's own plan of the four on 2 units)."""
    from repro_torch.configs import default_search_space, get_config
    from repro_torch.sched import H100, CostModel, Schedule, ScheduledJob, plan

    cfg = get_config("qwen25-7b").replace(n_layers=SWEEP_LAYERS)
    space = default_search_space(300, seq_len=SWEEP_SEQ)
    configs = [space[i] for i in MH_IDS]
    cm = CostModel(cfg, H100)
    dur = MH_STEPS * max(cm.iter_time([configs[c] for c in job], 1, SWEEP_SEQ) for job in MH_JOBS)
    sched = Schedule([ScheduledJob(job, 1, 0.0, dur) for job in MH_JOBS], dur, 2)
    return cfg, configs, cm, sched, plan(cm, configs, 2, SWEEP_SEQ, MH_STEPS, max_degree=1)


def mh_jobs():
    """Each job's adapters (``sweep_segments`` takes them)."""
    configs = mh_plan()[1]
    return [[configs[c] for c in job] for job in MH_JOBS]


class MemWatch:
    """Samples the card's free memory on a thread until ``stop``: the least
    free is the most that this process and its workers held at once."""

    def __init__(self, torch, dev, every: float = 0.1):
        import threading

        self.torch, self.dev, self.every = torch, dev, every
        self.least_free = torch.cuda.mem_get_info(dev)[0]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.wait(self.every):
            self.least_free = min(self.least_free, self.torch.cuda.mem_get_info(self.dev)[0])

    def stop(self) -> int:
        self._stop.set()
        self._thread.join(timeout=5)
        return self.least_free


def multihost_phase(torch, dev, base, out_dir: Path):
    """The dispatch tier on the card: qwen25-7b at full width on its first
    SWEEP_LAYERS layers (a view of ``base``), four adapters as two jobs of
    two, MH_STEPS captured steps each at SWEEP_SEQ tokens (impl="auto"):
    in process first (``ClusterRunner``, one job after the other), then
    through ``HostDispatcher([1, 1])``: two spawned workers sharing the
    card, the heartbeat on, host 0's worker SIGKILLed while its first
    segment is in flight (MH_KILL_DELAY after its request, during its
    init), then the same workload again on the warm workers, traced.
    Returns the launch counts of the kill run (the workers' launches, sent
    back with each segment)."""
    import shutil

    from repro_torch.configs import get_config

    cfg, configs, cm, sched, planned = mh_plan()
    _, base = depth_cut(get_config("qwen25-7b"), base, SWEEP_LAYERS)
    emit({"phase": "multihost_plan", "n_layers": cfg.n_layers, "ids": list(MH_IDS),
          "configs": [{"rank": c.rank, "alpha": c.alpha, "lr": c.learning_rate,
                       "batch_size": c.batch_size} for c in configs],
          "jobs": [list(j.config_ids) for j in sched.jobs],
          "planner_jobs": [list(j.config_ids) for j in planned.jobs],
          "job_mem_bytes": [cm.job_mem_bytes([configs[c] for c in job], 1, SWEEP_SEQ)
                            for job in MH_JOBS],
          "heartbeat_s": MH_HEARTBEAT, "dead_after_s": 12 * MH_HEARTBEAT})
    pool_dir = ROOT / "smoke_pool"
    shutil.rmtree(pool_dir, ignore_errors=True)
    try:
        return _multihost(torch, dev, base, out_dir, cfg, configs, cm, sched, pool_dir)
    finally:
        shutil.rmtree(pool_dir, ignore_errors=True)


def _multihost(torch, dev, base, out_dir, cfg, configs, cm, sched, pool_dir):
    import threading

    from repro_torch.cluster import ClusterRunner, DevicePool, HostDispatcher, SliceExecutor
    from repro_torch.cluster.executor import WARMUP_STEPS
    from repro_torch.obs import Tracer, trace_tiers, validate_chrome_trace
    from repro_torch.sched import ExecutionEngine
    from repro_torch.train.checkpoint import CheckpointPool
    from repro_torch.tree import tree_leaves

    def run(runner, name, tracer=None):
        """One run of the workload, counts zeroed just before it and read
        just after: losses by config, the pooled adapters, wall, counts."""
        pool = CheckpointPool(str(pool_dir / name))
        zero_counts()
        t0 = time.perf_counter()
        records, _ = ExecutionEngine(cm, 2, host_size=1, tracer=tracer).run_local(
            sched, configs, cfg, base, n_steps=MH_STEPS, seq=SWEEP_SEQ, pool=pool,
            runner=runner, impl="auto")
        torch.cuda.synchronize(dev)
        t_end = time.perf_counter()
        counts = train_counts()
        losses = {}
        for rec in records:
            for cid, loss in zip(rec.job.config_ids, rec.final_losses):
                losses[cid] = np.float32(loss)
        adapters = [tree_leaves(pool.load_adapter(f"adapter_{i:04d}")) for i in range(len(configs))]
        metas = [pool.load_meta(f"adapter_{i:04d}") for i in range(len(configs))]
        return {"losses": np.array([losses[c] for c in range(len(configs))]),
                "adapters": adapters, "metas": metas, "wall_s": t_end - t0, "t_end": t_end,
                "counts": counts, "records": records,
                "s_per_iter": [t.measured_iter for t in runner.last_result.timings],
                "overlap": runner.last_result.max_overlap()}

    def same(a, b) -> bool:
        """Losses and pooled adapters equal bit for bit."""
        return a["losses"].tobytes() == b["losses"].tobytes() and all(
            len(x) == len(y) and all(np.asarray(p).dtype == np.asarray(q).dtype
                                     and np.asarray(p).tobytes() == np.asarray(q).tobytes()
                                     for p, q in zip(x, y))
            for x, y in zip(a["adapters"], b["adapters"]))

    # in process: the same jobs one after the other on the parent's card
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ex = SliceExecutor()
    ref = run(ClusterRunner(ex, DevicePool([dev, dev]), concurrent=False), "in_process")
    ref_captures = [c["seconds"] for c in ex.captures]
    parent_peak = torch.cuda.max_memory_allocated(dev)
    ex.clear()
    del ex
    gc.collect()
    torch.cuda.empty_cache()  # the card as the workers find it
    torch.cuda.synchronize(dev)
    free0 = torch.cuda.mem_get_info(dev)[0]
    watch = MemWatch(torch, dev)
    tracer = Tracer()
    kill_t = [None]
    disp = None
    try:
        for attempt in range(MH_KILL_ATTEMPTS):
            if disp is not None:
                disp.close()
            disp = HostDispatcher([1, 1], heartbeat_interval=MH_HEARTBEAT, tracer=tracer)
            stop = threading.Event()

            def killer():
                while not stop.is_set():
                    if disp.in_flight(0) > 0:
                        time.sleep(MH_KILL_DELAY)
                        if disp.in_flight(0) > 0 and not stop.is_set():
                            kill_t[0] = time.perf_counter()
                            disp.kill_host(0)
                        return
                    time.sleep(0.005)

            th = threading.Thread(target=killer, daemon=True)
            th.start()
            try:
                kill = run(disp, f"kill{attempt}", tracer)
            except Exception:
                # what the dispatcher saw, before the failure propagates
                emit({"phase": "multihost_failed", "host_stats": [
                          {k: v for k, v in st.items() if k != "launches"}
                          for st in disp.host_stats],
                      "kill_t": kill_t[0], "membership": [
                          {"name": sp.name, "t": sp.start, **sp.args} for sp in tracer.spans()
                          if sp.track == "membership"]})
                raise
            finally:
                stop.set()
                th.join(timeout=30)
            kill_stats = [dict(st) for st in disp.host_stats]
            if disp.n_restarts >= 1:
                break
        warm = run(disp, "warm", tracer)
        warm_stats = [dict(st) for st in disp.host_stats]
        states = [disp.host_state(h) for h in range(len(disp.hosts))]
        n_restarts = disp.n_restarts
    finally:
        if disp is not None:
            disp.close()
    # a killed or stopped process gives its memory back once it has exited
    deadline = time.perf_counter() + 30
    while torch.cuda.mem_get_info(dev)[0] < free0 - MH_MEM_SLACK and time.perf_counter() < deadline:
        time.sleep(0.2)
    free_after = torch.cuda.mem_get_info(dev)[0]
    least_free = watch.stop()
    chrome = tracer.to_chrome()
    (out_dir / "trace_multihost.json").write_text(json.dumps(chrome))
    spans = tracer.spans()
    dispatch = {s.span_id: s for s in spans if s.name == "dispatch.segment"}
    roots = [s for s in spans if s.cat == "host" and s.name.endswith(".segment")]
    stitched = sorted({s.name for s in roots if s.parent_id in dispatch})
    trace_errors = validate_chrome_trace(chrome)

    hosts = []
    for h in range(2):
        ks, ws = kill_stats[h], warm_stats[h]
        caps = ks.get("captures") or [{}]
        hosts.append({
            "host": h, "device": disp.host_device(h), "spawns": ks.get("spawns"),
            "spawn_to_ready_s": ks.get("spawn_s"), "init_bytes": ks.get("init_bytes"),
            "inits_sent": ks.get("inits_sent"), "inits_sent_after_warm": ws.get("inits_sent"),
            "init_encode_s": ks.get("init_encode_s"),
            "init_s": ks.get("init_s"), "init_place_s": ks.get("init_place_s"),
            "capture_s": caps[-1].get("seconds"), "graph_pool_bytes": caps[-1].get("pool_bytes"),
            "s_per_iter_cold": kill["s_per_iter"][h], "s_per_iter_warm": warm["s_per_iter"][h],
            "s_per_iter_in_process": ref["s_per_iter"][h],
            "peak_allocated_bytes": ws.get("peak_bytes"), "reserved_bytes": ws.get("reserved_bytes"),
            "captured_warm": ws.get("captured")})
    warm_expect = {k: v * MH_STEPS // (WARMUP_STEPS + MH_STEPS) for k, v in ref["counts"].items()}
    rec = {"phase": "multihost", "model": cfg.name, "n_layers": cfg.n_layers,
           "steps": MH_STEPS, "seq": SWEEP_SEQ, "hosts": hosts,
           "in_process": {"wall_s": ref["wall_s"], "s_per_iter": ref["s_per_iter"],
                          "capture_s": ref_captures, "peak_allocated_bytes": parent_peak},
           "kill_run": {"wall_s": kill["wall_s"], "attempts": attempt + 1,
                        "n_restarts": n_restarts, "overlap": kill["overlap"],
                        "recovery_s": None if kill_t[0] is None else kill["t_end"] - kill_t[0],
                        "bitwise": same(kill, ref)},
           "warm_run": {"wall_s": warm["wall_s"], "overlap": warm["overlap"],
                        "bitwise": same(warm, ref)},
           "host_states": states, "heartbeat_s": MH_HEARTBEAT,
           "memory": {"free_before": free0, "least_free": least_free, "free_after": free_after,
                      "most_used_beyond_before": free0 - least_free, "slack": MH_MEM_SLACK},
           "trace": {"spans": len(spans), "errors": trace_errors, "stitched": stitched,
                     "tiers": trace_tiers(chrome)},
           "launches": {"in_process": ref["counts"], "kill_run": kill["counts"],
                        "warm_run": warm["counts"], "warm_expected": warm_expect}}
    emit(rec)
    if n_restarts < 1:
        fail(f"multihost: the kill of host 0 never landed mid-segment in {attempt + 1} attempts")
    if not kill["overlap"] >= 2 or not warm["overlap"] >= 2:
        fail(f"multihost: the two hosts' segments overlapped {kill['overlap']} / "
             f"{warm['overlap']} at most (2 wanted)")
    for name, r in (("the kill run", kill), ("the warm run", warm)):
        if not same(r, ref):
            fail(f"multihost: {name}'s losses or pooled adapters differ from the in-process "
                 f"run's (bitwise equality wanted): {r['losses']} against {ref['losses']}")
    if any(m["total_steps"] != MH_STEPS or not math.isfinite(m["final_loss"])
           for r in (kill, warm) for m in r["metas"]):
        fail("multihost: a pooled adapter's budget or final loss is off")
    if states != ["ALIVE", "ALIVE"]:
        fail(f"multihost: host states {states} at the end, both ALIVE wanted")
    if any(h["inits_sent_after_warm"] != h["inits_sent"] for h in hosts):
        fail("multihost: the unchanged workload shipped a second init")
    if trace_errors or stitched != ["host0.segment", "host1.segment"]:
        fail(f"multihost: the trace is invalid ({trace_errors}) or lacks a host's spans "
             f"stitched under dispatch.segment ({stitched})")
    if free_after < free0 - MH_MEM_SLACK:
        fail(f"multihost: {free0 - free_after} bytes of the card still held after close(), "
             f"over the slack of {MH_MEM_SLACK}")
    for need in ("packed_matmul", "packed_matmul_bwd"):
        if kill["counts"][need] == 0:
            fail(f"multihost: the workers launched {need} no time")
    if kill["counts"] != ref["counts"] or warm["counts"] != warm_expect:
        fail(f"multihost: the workers' launches {kill['counts']} (cold) / {warm['counts']} "
             f"(warm) against in-process {ref['counts']} / {warm_expect}")
    return kill["counts"]


# ---------------------------------------------------------------------------
# online phase
# ---------------------------------------------------------------------------

# Six configurations of default_search_space(300, seq_len=512), arriving on a
# Poisson trace: (rank, batch) = (16, 2), (16, 8), (16, 8), (128, 1),
# (32, 4), (32, 2), with their own step budgets. The mean inter-arrival is
# ONLINE_MEAN iterations of the first configuration on the H100 prior.
ONLINE_SEQ = SWEEP_SEQ
ONLINE_IDS = (87, 71, 81, 254, 157, 135)
ONLINE_STEPS = (8, 6, 7, 7, 7, 8)
ONLINE_SEED = 1
ONLINE_MEAN = 2.0
# The cost model's setup_time prices a base load and a compile per job (60
# s); the port keeps the base on the card and pays a capture per new step
# shape (3-4 s at full width, PERF.md) or nothing on a cache hit, so the
# phase plans with 1 s a job, which lets a migration pay within a few steps.
ONLINE_SETUP_S = 1.0
# The adaptive run: a rank-8 batch-1 configuration at t = 0, then a rank-16
# batch-2 and a rank-32 batch-4 one ADAPTIVE_GAP_S later (real seconds), 6
# steps each, probed for 2. One row runs far from the prior (-60 % on the
# card, PERF.md), beyond the drift threshold of 0.5.
ADAPTIVE_IDS = (13, 88, 163)
ADAPTIVE_ARRIVALS_S = (0.0, 1.0, 1.0)
ADAPTIVE_STEPS = 6
PROBE_STEPS = 2


def _rows(configs) -> int:
    """Rows of a pack: each adapter padded to the pack's largest batch."""
    return len(configs) * max(c.batch_size for c in configs)


def online_plan():
    """The online phase's trace, cost model (the port's memory accounting)
    and plan, and what the reference's memory accounting plans for the
    same trace (pure Python, milliseconds: the kernel phase and the tests
    read it too)."""
    from types import SimpleNamespace

    from repro_torch.configs import default_search_space, get_config
    from repro_torch.sched import H100, REFERENCE_MEMORY, CostModel, ExecutionEngine, poisson_trace

    cfg = get_config("qwen25-7b")
    space = default_search_space(300, seq_len=ONLINE_SEQ)
    configs = [space[i] for i in ONLINE_IDS]
    cm = CostModel(cfg, H100, setup_time=ONLINE_SETUP_S)
    mean = ONLINE_MEAN * cm.iter_time(configs[:1], 1, ONLINE_SEQ)
    trace = poisson_trace(configs, mean, seed=ONLINE_SEED, steps=ONLINE_STEPS)
    kw = dict(migration_budget=1, preempt_min_remaining=0.0)
    sched = ExecutionEngine(cm, 1).plan_online(trace, ONLINE_SEQ, max(ONLINE_STEPS), **kw)
    ref_cm = CostModel(cfg, H100, setup_time=ONLINE_SETUP_S, **REFERENCE_MEMORY)
    ref = ExecutionEngine(ref_cm, 1).plan_online(trace, ONLINE_SEQ, max(ONLINE_STEPS), **kw)
    big = max(ref.segments, key=lambda sg: _rows([configs[c] for c in sg.config_ids]))
    bc = [configs[c] for c in big.config_ids]
    reference = {"largest_config_ids": list(big.config_ids), "largest_rows": _rows(bc),
                 "reference_job_mem_bytes": ref_cm.job_mem_bytes(bc, 1, ONLINE_SEQ),
                 "repaired_job_mem_bytes": cm.job_mem_bytes(bc, 1, ONLINE_SEQ),
                 "segments": [list(sg.config_ids) for sg in ref.segments]}
    return SimpleNamespace(cfg=cfg, configs=configs, cm=cm, mean=mean, trace=trace,
                           sched=sched, reference=reference)


def online_segments(sched, configs):
    """``sweep_segments`` of the online plan's segments (the same sequence
    length), each distinct (N, M, r) once."""
    out, seen = [], set()
    for job, n, m, r in sweep_segments([[configs[c] for c in sg.config_ids]
                                        for sg in sched.segments]):
        if (n, m, r) not in seen:
            seen.add((n, m, r))
            out.append((sched.segments[job].job_id, n, m, r))
    return out


def initial_adapter(torch, ex, cfg, order, configs, c: int, dev):
    """Config ``c``'s initial weights in the online run (its slot of the
    template of the first segment that trains it, from the executor's
    cache), and a one-adapter pack of them."""
    from repro_torch.core.adapter import pack_meta
    from repro_torch.core.packed_lora import extract_adapter, inject_adapter
    from repro_torch.models.model import lora_zeros

    first = next(sg for sg in order if c in sg.config_ids)
    jc = [configs[i] for i in first.config_ids]
    w0 = extract_adapter(ex.pack_template(cfg, jc, 0, dev)[0], first.config_ids.index(c),
                         pack_meta(jc).ranks)
    return w0, inject_adapter(lora_zeros(cfg, pack_meta([configs[c]]), torch.float32, "cpu"),
                              w0, 0)


def _flat(tree, path=""):
    """{leaf path: f64 array} of an adapter tree, whatever its key order."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{path}/{key}").items()}
    return {path: np.asarray(tree, np.float64)}


def update_err(w, ref, w0) -> float:
    """||w - ref|| / ||ref - w0|| over every leaf: how far an update lies
    from the reference update, relative to it."""
    w, ref, w0 = _flat(w), _flat(ref), _flat(w0)
    if not set(w) == set(ref) == set(w0):
        fail(f"adapter trees differ: {sorted(w)} / {sorted(ref)} / {sorted(w0)}")
    diff = sum(float(np.sum((w[k] - ref[k]) ** 2)) for k in ref)
    update = sum(float(np.sum((ref[k] - w0[k]) ** 2)) for k in ref)
    return math.sqrt(diff / update)


def held_bytes(torch, dev, base) -> int:
    """What the process holds on the card besides the base: earlier phases'
    leftovers (cuBLAS workspaces of their streams, cached index tensors).
    A job's own peak is the device's peak less this."""
    return torch.cuda.memory_allocated(dev) - resident_bytes(base)


def c3_check(what: str, rows, packs, cfg) -> None:
    """ROADMAP C3: every captured job's own peak allocated memory
    (``job_peak_bytes``) lies within [peak, C3_SLACK x peak] of the cost
    model's ``job_mem_bytes``. A cache hit replays in the memory its graph
    reserved at the capture, so only captures are held (and fitted:
    C3_POINTS, with the model ``cfg`` they ran)."""
    over = []
    for r, jc in zip(rows, packs):
        if not r["captured"]:
            continue
        peak = r["job_peak_bytes"]
        C3_POINTS.append((cfg, jc, peak))
        if not peak <= r["job_mem_bytes"] <= C3_SLACK * peak:
            over.append(r)
    if over:
        fail(f"C3: {what}'s jobs whose job_mem_bytes is not within [peak, {C3_SLACK} x peak]: "
             f"{over}")


def c3_fit(seq: int) -> dict:
    """``logits_copies`` and ``job_overhead_bytes`` fitted to C3_POINTS: for
    each number of copies on a grid, the least per-job term that prices
    every job at or above its peak; the grid point whose largest price over
    peak is least."""
    from repro_torch.sched import H100, CostModel

    best = None
    for copies in np.arange(0.0, 10.001, 0.05):
        price = [CostModel(cfg, H100, logits_copies=float(copies),
                           job_overhead_bytes=0.0).job_mem_bytes(jc, 1, seq)
                 for cfg, jc, _ in C3_POINTS]
        fixed = max(0.0, max(p - q for (_, _, p), q in zip(C3_POINTS, price)))
        worst = max((q + fixed) / p for (_, _, p), q in zip(C3_POINTS, price))
        if best is None or worst < best["max_price_over_peak"]:
            best = {"logits_copies": float(copies), "job_overhead_bytes": fixed,
                    "max_price_over_peak": worst}
    default = CostModel(C3_POINTS[0][0], H100)
    best.update(n_points=len(C3_POINTS), model_logits_copies=default.logits_copies,
                model_job_overhead_bytes=default.job_overhead_bytes,
                points=[{"n_layers": cfg.n_layers, "rows": _rows(jc), "ranks": [c.rank for c in jc],
                         "batch_sizes": [c.batch_size for c in jc], "peak_allocated_bytes": p,
                         "job_mem_bytes": CostModel(cfg, H100).job_mem_bytes(jc, 1, seq)}
                        for cfg, jc, p in C3_POINTS])
    return best


def online_phase(torch, dev, base, out_dir: Path):
    """(a) The online engine on full qwen25-7b: plan the trace on the H100
    preset with the port's memory accounting, run it with
    ``run_online_local`` (captured steps, a preemption through the pool),
    then hold it against the same segments run eagerly and the preempted
    adapter against an unbroken run of it alone. (b) The adaptive loop with
    a ``ProfiledCostModel`` on a smaller trace. Returns the launch counts of
    (a) and (b)."""
    import shutil

    on = online_plan()
    cm, sched, configs = on.cm, on.sched, on.configs
    cap = cm.load_factor * cm.hw.mem_bytes
    jobs = [{"job_id": sg.job_id, "config_ids": list(sg.config_ids),
             "start_steps": list(sg.start_steps), "run_steps": sg.run_steps,
             "done_ids": list(sg.done_ids), "preempted": sg.preempted,
             "start": sg.start, "end": sg.end,
             "rows": _rows([configs[c] for c in sg.config_ids]),
             "job_mem_bytes": cm.job_mem_bytes([configs[c] for c in sg.config_ids], 1, ONLINE_SEQ),
             "predicted_s_per_iter": cm.iter_time([configs[c] for c in sg.config_ids], 1,
                                                  ONLINE_SEQ)}
            for sg in sched.segments]
    emit({"phase": "online_plan", "hw": cm.hw.name, "setup_s": cm.setup_time,
          "mean_interarrival_s": on.mean, "seed": ONLINE_SEED,
          "configs": [{"id": i, "space_index": k, "rank": c.rank, "alpha": c.alpha,
                       "lr": c.learning_rate, "batch_size": c.batch_size, "steps": a.steps,
                       "arrival_s": a.time}
                      for i, (k, c, a) in enumerate(zip(ONLINE_IDS, configs, on.trace))],
          "segments": jobs, "n_repacks": sched.n_repacks, "n_migrations": sched.n_migrations,
          "planned_makespan_s": sched.makespan, "load_factor_bytes": cap,
          "kernel_segments": online_segments(sched, configs),
          "reference_accounting": on.reference})
    if sched.n_migrations < 1:
        fail("the online plan has no migration")
    over = [j for j in jobs if j["job_mem_bytes"] > cap]
    if over:
        fail(f"the online plan has jobs above the load factor: {over}")
    pool_dir = ROOT / "smoke_pool"
    shutil.rmtree(pool_dir, ignore_errors=True)
    try:
        return _online(torch, dev, base, on, pool_dir)
    finally:
        shutil.rmtree(pool_dir, ignore_errors=True)


def _online(torch, dev, base, on, pool_dir):
    from repro_torch.cluster import ClusterRunner, DevicePool, SliceExecutor
    from repro_torch.cluster.executor import WARMUP_STEPS
    from repro_torch.core.adapter import pack_meta
    from repro_torch.core.packed_lora import extract_adapter
    from repro_torch.obs import MetricsTracer
    from repro_torch.sched import ExecutionEngine
    from repro_torch.train.checkpoint import CheckpointPool
    from repro_torch.tree import tree_leaves

    cfg, cm, sched, configs, trace = on.cfg, on.cm, on.sched, on.configs, on.trace
    n_steps = max(ONLINE_STEPS)
    pool = CheckpointPool(str(pool_dir / "captured"))
    tracer = MetricsTracer()
    ex = SliceExecutor(tracer=tracer)
    runner = ClusterRunner(ex, DevicePool([dev]), tracer=tracer)
    torch.cuda.synchronize(dev)
    held = held_bytes(torch, dev, base)
    zero_counts()
    t0 = time.perf_counter()
    records, ran = ExecutionEngine(cm, 1, tracer=tracer).run_online_local(
        trace, cfg, base, n_steps=n_steps, seq=ONLINE_SEQ, pool=pool, runner=runner,
        migration_budget=1, preempt_min_remaining=0.0)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = train_counts()
    if [dataclasses.astuple(sg) for sg in ran.segments] != [
            dataclasses.astuple(sg) for sg in sched.segments]:
        fail("run_online_local planned other segments than plan_online")
    # the runner's order: virtual start, then job id
    order = sorted(ran.segments, key=lambda sg: (sg.start, sg.job_id))
    timings = runner.last_result.timings
    rows = []
    built = [rec.captured for rec in records]
    for sg, rec, t, w in zip(order, records, timings, built):
        jc = [configs[c] for c in sg.config_ids]
        m = pack_meta(jc)
        mem = cm.job_mem_bytes(jc, 1, ONLINE_SEQ)
        rows.append({"job_id": sg.job_id, "config_ids": list(sg.config_ids), "ranks": list(m.ranks),
                     "rows": _rows(jc), "run_steps": sg.run_steps, "preempted": sg.preempted,
                     "predicted_s_per_iter": t.predicted_iter,
                     "measured_s_per_iter": t.measured_iter, "drift": t.drift,
                     "wall_s": rec.wall_seconds,
                     "final_losses": [float(x) for x in rec.final_losses]
                     if rec.final_losses is not None else None,
                     "peak_allocated_bytes": rec.peak_bytes,
                     "job_peak_bytes": rec.peak_bytes - held, "job_mem_bytes": mem,
                     "job_mem_over_peak": mem / (rec.peak_bytes - held), "captured": w})
    builds, hits = ex.n_builds, ex.n_hits
    emit({"phase": "online", "segments": rows, "held_bytes": held, "wall_s": wall,
          "planned_makespan_s": sched.makespan,
          "n_repacks": ran.n_repacks, "n_migrations": ran.n_migrations,
          "executor_builds": builds, "executor_hits": hits,
          "captures": [{k: c[k] for k in ("n_pack", "rows", "pool_bytes", "static_bytes",
                                          "transient_bytes", "seconds")} for c in ex.captures],
          "launches": launches, "metrics": tracer.metrics.to_json()})
    total = ran.total_steps
    names = pool.list()
    if names != [f"adapter_{c:04d}" for c in range(len(trace))]:
        fail(f"the online pool holds {names}, not the trace's {len(trace)} adapters")
    for cid in range(len(trace)):
        meta = pool.load_meta(f"adapter_{cid:04d}")
        if meta["total_steps"] != total[cid] or not math.isfinite(meta["final_loss"]):
            fail(f"adapter {cid}: {meta['total_steps']} steps of {total[cid]}, final loss "
                 f"{meta['final_loss']}")
    preempted = sorted({c for sg in order if sg.preempted for c in sg.config_ids
                        if c not in sg.done_ids})
    part = {c: pool.load_adapter_state(f"{c:04d}")[1]["steps_done"] for c in preempted}
    if not part or not all(0 < part[c] < total[c] for c in part):
        fail(f"the preempted adapters' state files hold steps {part} of {total}")
    for need in ("packed_matmul", "packed_matmul_bwd"):
        if launches[need] == 0:
            fail(f"the online run launched {need} no time")
    if builds != sum(built) or hits != len(order) - sum(built):
        fail(f"the online run built {builds} steps and hit {hits}; its shapes make "
             f"{sum(built)} captures")
    # (b) on the same executor: its first pack's new shape follows the
    # online run's last graph, the largest
    adaptive = _adaptive(torch, dev, base, CheckpointPool(str(pool_dir / "adaptive")), ex, held)
    ex.clear()
    torch.cuda.empty_cache()

    # the same segments, eagerly, one at a time (each with its own counts),
    # into a pool of their own
    eager = SliceExecutor(capture=False)
    erunner = ClusterRunner(eager, DevicePool([dev]))
    epool = CheckpointPool(str(pool_dir / "eager"))
    by_cid = dict(enumerate(configs))
    checks, expect = [], {k: 0 for k in launches}
    for sg, rec, w in zip(order, records, built):
        zero_counts()
        res = erunner.run([sg], by_cid, total, cfg, base, seq=ONLINE_SEQ, pool=epool, impl="auto")
        counts = train_counts()
        if not sg.run_steps:  # nothing trained, nothing captured
            continue
        for k in expect:  # a warm-up step (on a capture) and the replays
            expect[k] += counts[k] * (sg.run_steps + (WARMUP_STEPS if w else 0)) // sg.run_steps
        cap_l = torch.as_tensor(np.asarray(rec.final_losses))
        eag_l = torch.as_tensor(np.asarray(res.records[0].final_losses))
        equal = bool(torch.equal(cap_l, eag_l))
        rel = ((cap_l - eag_l).abs() / eag_l.abs()).max().item()
        checks.append({"job_id": sg.job_id, "loss_equal": equal, "loss_rel_err": rel,
                       "eager_s_per_iter": res.timings[0].measured_iter,
                       "eager_peak_allocated_bytes": res.records[0].peak_bytes})
        if not equal and not rel <= LOSS_RTOL:
            fail(f"online segment {sg.job_id}: captured losses differ from eager by {rel}")
        torch.cuda.empty_cache()
    w_equal, w_rel = True, 0.0
    for name in names:
        for a, b in zip(tree_leaves(pool.load_adapter(name)), tree_leaves(epool.load_adapter(name))):
            w_equal &= bool(np.array_equal(a, b))
            w_rel = max(w_rel, float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)))
    # each preempted adapter against an unbroken run of it alone, from the
    # weights it started from (its slot of its first pack's template) on its
    # own data stream: the pack steps it rode through (its weights freeze at
    # its budget, its loss is read on the last of them). The control: the
    # same adapter restarted from those weights at its preemption, with
    # fresh Adam moments and its data stream where it stopped.
    unbroken = []
    slice_ = DevicePool([dev]).acquire(1)
    for c in preempted:
        seen = sum(sg.run_steps for sg in order if c in sg.config_ids)
        w0, lora0 = initial_adapter(torch, ex, cfg, order, configs, c, dev)
        budget = np.asarray([total[c]], np.int32)
        res = eager.train_pack(cfg, [configs[c]], n_steps=seen, seq=ONLINE_SEQ, base=base,
                               lora=lora0, slice_=slice_, budgets=budget)
        want_w, want = extract_adapter(res.lora, 0, [configs[c].rank]), float(res.losses[0])
        del res
        res = eager.train_pack(cfg, [configs[c]], n_steps=seen - part[c], seq=ONLINE_SEQ,
                               base=base, lora=lora0, slice_=slice_, budgets=budget,
                               data_start_steps=[part[c]])
        lost_w, lost = extract_adapter(res.lora, 0, [configs[c].rank]), float(res.losses[0])
        del res
        got = pool.load_meta(f"adapter_{c:04d}")["final_loss"]
        got_w = pool.load_adapter(f"adapter_{c:04d}")
        row = {"config": c, "steps_done_at_preemption": part[c], "pack_steps": seen,
               "final_loss": got, "unbroken_final_loss": want,
               "loss_rel_err": abs(got - want) / abs(want),
               "update_rel_err": update_err(got_w, want_w, w0),
               "restart_control_loss_rel_err": abs(lost - want) / abs(want),
               "restart_control_update_rel_err": update_err(lost_w, want_w, w0)}
        unbroken.append(row)
        if not row["update_rel_err"] <= RESUME_UPDATE_RTOL:
            fail(f"preempted adapter {c}: its update is {row['update_rel_err']} off the unbroken "
                 f"run's (limit {RESUME_UPDATE_RTOL})")
        if not row["loss_rel_err"] <= RESUME_LOSS_RTOL:
            fail(f"preempted adapter {c}: final loss {got} against {want} unbroken alone")
        if not row["restart_control_update_rel_err"] > RESUME_CONTROL_FACTOR * RESUME_UPDATE_RTOL:
            fail(f"preempted adapter {c}: a restart from its initial weights reads "
                 f"{row['restart_control_update_rel_err']}, which the update's limit "
                 f"{RESUME_UPDATE_RTOL} cannot tell from a resume")
    eager.clear()
    torch.cuda.empty_cache()
    emit({"phase": "online_checks", "segments": checks, "adapters_equal": w_equal,
          "adapters_rel_err": w_rel, "preempted_state_steps": part, "unbroken": unbroken,
          "launches_expected_from_eager": expect,
          "c3": [{k: r[k] for k in ("job_id", "rows", "job_peak_bytes", "job_mem_bytes",
                                   "job_mem_over_peak")} for r in rows]})
    if launches != expect:
        fail(f"the online run counted {launches} launches; its eager steps make {expect}")
    c3_check("the online run", rows, [[configs[c] for c in sg.config_ids] for sg in order], cfg)
    return launches, adaptive


def _adaptive(torch, dev, base, pool, ex, held: int):
    """``run_online_local`` with a ``ProfiledCostModel`` (the adaptive loop)
    on three configurations, on the card's clock, through the executor
    ``ex``, which still holds the online run's last graph: the first pack
    must drop it before it makes anything (C3 holds its whole peak). Each
    job's own peak is the device's less ``held``, what the phases before
    the online run left allocated."""
    from repro_torch.cluster import ClusterRunner, DevicePool
    from repro_torch.configs import default_search_space, get_config
    from repro_torch.sched import H100, Arrival, CostModel, ExecutionEngine, ObservationStore
    from repro_torch.sched import ProfiledCostModel

    cfg = get_config("qwen25-7b")
    space = default_search_space(300, seq_len=ONLINE_SEQ)
    configs = [space[i] for i in ADAPTIVE_IDS]
    trace = [Arrival(t, c, ADAPTIVE_STEPS) for t, c in zip(ADAPTIVE_ARRIVALS_S, configs)]
    est = ProfiledCostModel(CostModel(cfg, H100, setup_time=ONLINE_SETUP_S), ObservationStore())
    runner = ClusterRunner(ex, DevicePool([dev]))
    after_rows = ex.captures[-1]["rows"] if ex.captures else None
    builds0, hits0 = ex.n_builds, ex.n_hits
    torch.cuda.synchronize(dev)
    zero_counts()
    t0 = time.perf_counter()
    records, sched = ExecutionEngine(est, 1).run_online_local(
        trace, cfg, base, n_steps=ADAPTIVE_STEPS, seq=ONLINE_SEQ, pool=pool, runner=runner,
        probe_steps=PROBE_STEPS)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = train_counts()
    executed = {cid: 0 for cid in sched.total_steps}
    for sg in sched.segments:
        for cid, st0 in zip(sg.config_ids, sg.start_steps):
            executed[cid] += min(sched.total_steps[cid] - st0, sg.run_steps)
    store_path = pool.root + "/profile.json"
    est.store.save(store_path)
    roundtrip = ObservationStore.load(store_path).to_json() == est.store.to_json()
    metas = {n: pool.load_meta(n) for n in pool.list()}
    packs = [[configs[c] for c in sg.config_ids] for sg in sched.segments]
    rows = [{"job_id": sg.job_id, "config_ids": list(sg.config_ids), "run_steps": sg.run_steps,
             "start_steps": list(sg.start_steps), "preempted": sg.preempted,
             "captured": rec.captured, "peak_allocated_bytes": rec.peak_bytes,
             "job_peak_bytes": rec.peak_bytes - held,
             "job_mem_bytes": est.prior.job_mem_bytes(jc, 1, ONLINE_SEQ)}
            for sg, rec, jc in zip(sched.segments, records, packs)]
    emit({"phase": "online_adaptive", "n_probes": sched.n_probes,
          "n_reassignments": sched.n_reassignments, "n_repacks": sched.n_repacks,
          "held_bytes": held, "wall_s": wall, "segments": rows,
          "timings": [{"job_id": t.job_id, "measured_s_per_iter": t.measured_iter,
                       "predicted_s_per_iter": t.predicted_iter, "drift": t.drift}
                      for t in sched.timings],
          "final_losses": {n: m["final_loss"] for n, m in metas.items()},
          "executor_builds": ex.n_builds - builds0, "executor_hits": ex.n_hits - hits0,
          "follows_graph_rows": after_rows,
          "store_roundtrip": roundtrip, "store": est.store.to_json(), "launches": launches})
    if executed != sched.total_steps:
        fail(f"the adaptive run trained {executed} steps of {sched.total_steps}")
    if sorted(metas) != [f"adapter_{c:04d}" for c in range(len(trace))] or not all(
            math.isfinite(m["final_loss"]) for m in metas.values()):
        fail(f"the adaptive run's pool holds {metas}")
    if sched.n_reassignments < 1:
        fail("the adaptive run made no reassignment")
    if not roundtrip:
        fail("the observation store does not round-trip through save/load")
    if (ex.n_builds - builds0, ex.n_hits - hits0) != (
            sum(r["captured"] for r in rows), len(rows) - sum(r["captured"] for r in rows)):
        fail(f"the adaptive run built {ex.n_builds - builds0} steps and hit {ex.n_hits - hits0}")
    c3_check("the adaptive run", rows, packs, cfg)
    for need in ("packed_matmul", "packed_matmul_bwd"):
        if launches[need] == 0:
            fail(f"the adaptive run launched {need} no time")
    return launches


# ---------------------------------------------------------------------------
# autotune phase
# ---------------------------------------------------------------------------


def launcher_configs(argv=None):
    """The launcher's pack from ``argv`` (LAUNCH_ARGS unless given): its
    configurations and sequence length (the autotuner's shapes follow from
    ranks, batches and seq alone)."""
    from repro_torch.configs.base import LoraConfig
    from repro_torch.launch.train import parse_args

    args = parse_args(argv or LAUNCH_ARGS)
    return [LoraConfig(rank=int(r), alpha=2.0 * int(r), batch_size=int(b), seq_len=args.seq)
            for r, b in zip(args.ranks.split(","), args.batch_sizes.split(","))], args.seq


def autotune_phase(torch, dev, out_dir: Path):
    """``kernels/autotune.py`` at the launcher's pack (full qwen25-7b, ranks
    8 and 16, batch 2, seq 512: ``model_shapes(fast=False)``, N = 2 x M =
    1,024 at d x d and d x d_ff, r = 16): ``tune_for_model`` in f32 (the
    "ffma" path) and ``tune`` at the same shapes in bf16 (the "wgmma" path),
    each into its own cache under ``out_dir``. Every candidate (the plan's
    own K split, then each other count the sweep asks for) is held
    against the plain version at KERNEL_TOL and must keep its path; one line
    a candidate: device ms (CUDA events, ``autotune.measure``), the
    two-pass tier's, the speedup, FLOP/s and the share of the bound. A
    second tune on each cache must measure nothing (a cache hit). Returns
    the f32 sweep's records."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels.fused import fused_matmul_path, fused_matmul_splits
    from repro_torch.kernels.ops import fused_lora_linear
    from repro_torch.kernels.ref import fused_matmul_ref
    from repro_torch.obs import Tracer

    cfg = get_config("qwen25-7b")
    configs, seq = launcher_configs()
    shapes = at.model_shapes(cfg, configs, seq, fast=False)
    want_path = {"float32": "ffma", "bfloat16": "wgmma"}
    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        cache = out_dir / f"autotune_{dname}.json"
        cache.unlink(missing_ok=True)
        rows, two_ms = [], {}

        def measure_fn(n, m, k, l, r, blocks, backend, twopass=True, dtype=dtype, dname=dname,
                       rows=rows, two_ms=two_ms):
            x, w, a, b, al = at.operands(n, m, k, l, r, dtype, dev)
            path = fused_matmul_path(x, w, r, a, b)
            splits = fused_matmul_splits(x, w, r, a, b, blocks=blocks)
            with torch.no_grad():
                got = fused_lora_linear(x, w, a, b, al, impl="fused", blocks=blocks)
            want = fused_matmul_ref(x, w, a, b, al)
            err = (got.float() - want.float()).abs().max().item()
            tol = KERNEL_TOL[dname] * want.float().abs().max().item()
            del x, w, a, b, al, got, want
            shape = [n, m, k, l, r]
            if not (math.isfinite(err) and err <= tol):
                fail(f"autotune {dname} {shape} blocks={blocks}: max_abs_err {err} > {tol}")
            if path != want_path[dname]:
                fail(f"autotune {dname} {shape} blocks={blocks}: took {path!r}, not "
                     f"{want_path[dname]!r}")
            fused_t, two_t = at._default_measure(n, m, k, l, r, blocks, backend, twopass,
                                                 dtype=dtype, device=dev)
            if two_t is not None:
                two_ms[tuple(shape)] = 1e3 * two_t
            flops = at.fused_flops(n, m, k, l, r)
            b_ms = bound(nbytes_of_shape(n, m, k, l, r, dtype), flops, dname)[0]
            row = {"phase": "autotune_candidate", "shape": shape, "dtype": dname, "path": path,
                   "blocks": list(blocks) if blocks else None, "k_splits": splits,
                   "device_ms": 1e3 * fused_t, "twopass_ms": two_ms[tuple(shape)],
                   "speedup_vs_twopass": two_ms[tuple(shape)] / (1e3 * fused_t),
                   "flops_per_s": flops / fused_t, "bound_ms": b_ms,
                   "bound_share": b_ms / (1e3 * fused_t), "max_abs_err": err, "tol": tol}
            emit(row)
            rows.append(row)
            return fused_t, two_t

        tracer = Tracer()
        if dtype == torch.float32:
            prof = at.tune_for_model(cfg, configs, seq=seq, cache_path=str(cache), fast=False,
                                     measure_fn=measure_fn, tracer=tracer, device=dev, dtype=dtype)
        else:
            prof = at.tune(shapes, cache_path=str(cache), measure_fn=measure_fn, tracer=tracer,
                           device=dev, dtype=dtype)
        spans = [sp for sp in tracer.spans() if sp.name == "autotune.measure"]
        if len(spans) != len(rows) or any(sp.args.get("seconds") is None for sp in spans):
            fail(f"autotune {dname}: {len(spans)} autotune.measure spans for {len(rows)} "
                 "candidates")
        hit, again = Tracer(), []
        at.tune(shapes, cache_path=str(cache), tracer=hit, device=dev, dtype=dtype,
                measure_fn=lambda *a, **kw: again.append(a) or (1.0, 1.0))
        if again or hit.spans():
            fail(f"autotune {dname}: a second tune on {cache.name} measured again")
        for shape in shapes:
            own = next(r for r in rows if r["shape"] == list(shape) and r["blocks"] is None)
            e = prof.entry(*shape)
            emit({"phase": "autotune", "dtype": dname, "shape": list(shape),
                  "best_blocks": e["blocks"], "plan_k_splits": own["k_splits"],
                  "best_ms": 1e3 * e["seconds"], "plan_ms": own["device_ms"],
                  "speedup_vs_twopass": e["speedup_vs_twopass"], "cache": cache.name})
        records[dname] = {"rows": rows, "lora_speedup": prof.lora_speedup()}
    return records


def nbytes_of_shape(n, m, k, l, r, dtype) -> int:
    """Bytes one fused call must move: x, W, A, B read once, y written once."""
    elem = 4 if str(dtype).endswith("float32") else 2
    return elem * (n * m * k + k * l + n * k * r + n * r * l + n * m * l)


# ---------------------------------------------------------------------------
# launcher phase
# ---------------------------------------------------------------------------

# repro_torch.launch.train's arguments: full qwen25-7b on its f32 base, two
# adapters of batch 2 at seq 512 (N = 2 x M = 1,024 tokens: the kernel
# phase's training shapes), 4 steps of a captured step
LAUNCH_STEPS = 3
LAUNCH_ARGS = ["--arch", "qwen25-7b", "--seq", "512", "--ranks", "8,16", "--batch-sizes", "2,2",
               "--steps", str(LAUNCH_STEPS), "--log-every", "0"]
LAUNCH_IMPLS = ("fused", "auto")
# The two impls compute one f32 function in two orders of sums. Their
# final losses must agree within LAUNCH_LOSS_RTOL (relative), and each
# adapter's update (w - w0, every leaf) under --impl fused must lie within
# LAUNCH_UPDATE_RTOL of --impl auto's, relative to auto's (``update_err``).
# Read on an H100 (PERF.md): losses 7.7e-8 apart, updates 6.7e-4; a fused
# run whose kernel leaves out the delta's scale (forward and dx: a
# mis-scaled delta), the planted control, reads 8.4e-5 and 6.2e-2. Both
# limits lie between; the control must read above LAUNCH_CONTROL_FACTOR x
# LAUNCH_UPDATE_RTOL, so the update check can see that fault.
LAUNCH_LOSS_RTOL = 2e-6
LAUNCH_UPDATE_RTOL = 5e-3
LAUNCH_CONTROL_FACTOR = 5.0
# the counts each impl's run must move: forward, and backward
LAUNCH_NEEDED = {"fused": ("fused_matmul", "fused_matmul_dx"),
                 "auto": ("packed_matmul", "packed_matmul_bwd")}


def launcher_segments(argv=None):
    """(N, M, r) of each same-rank segment of the launcher's pack, from
    ``argv`` (LAUNCH_ARGS unless given): a step runs every projection once
    per segment, at the segment's own rank (``ops._ragged_call``), M = the
    pack's rows per adapter (each padded to the largest batch) times the
    sequence."""
    from repro_torch.kernels.ops import rank_segments

    configs, seq = launcher_configs(argv)
    m = max(c.batch_size for c in configs) * seq
    return [(hi - lo, m, r) for lo, hi, r in rank_segments([c.rank for c in configs])[2]]


def launcher_executor():
    """A ``SliceExecutor`` that keeps its one pack's configurations and
    sequence length (``configs``, ``seq``) and its initial and final
    adapters (``w0``, ``w``: one numpy tree per adapter)."""
    from repro_torch.cluster import SliceExecutor
    from repro_torch.core.adapter import pack_meta
    from repro_torch.core.packed_lora import extract_adapter

    class Kept(SliceExecutor):
        def train_pack(self, cfg, configs, *, lora, **kw):
            self.configs, self.seq = configs, kw["seq"]
            ranks = pack_meta(configs).ranks
            self.w0 = [extract_adapter(lora, i, ranks) for i in range(len(ranks))]
            res = super().train_pack(cfg, configs, lora=lora, **kw)
            self.w = [extract_adapter(res.lora, i, ranks) for i in range(len(ranks))]
            return res

    return Kept()


def unscaled_delta(kernel):
    """``fused_matmul`` with its delta's scale left out (the planted
    control's fault)."""
    def call(x, w, a, b, scale=None, *, backward=False, blocks=None):
        return kernel(x, w, a, b, None, backward=backward, blocks=blocks)

    # the kernel counts through its module's name for it, which names this
    # wrapper while the control runs: one dict for both
    call.launches = kernel.launches
    return call


def tuned_run(ex, cm, win, paths) -> dict:
    """The tuned, traced launcher run's own checks and numbers: its trace
    (schema, autotune and executor tiers), its metrics (an executor build),
    the split it ran, and the prior's s/step uncalibrated (``cm``, the
    launcher's own ``CostModel``) and calibrated (``KernelProfile.calibrate``
    of the cache it wrote) against the measured."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.autotune import KernelProfile, model_shapes
    from repro_torch.obs import trace_tiers, validate_chrome_trace

    trace = json.loads(paths["trace"].read_text())
    problems, tiers = validate_chrome_trace(trace), trace_tiers(trace)
    if problems or not {"autotune", "executor"} <= set(tiers):
        fail(f"launcher tuned: trace problems {problems[:5]}, tiers {tiers}")
    metrics = json.loads(paths["metrics"].read_text())
    builds = metrics["counters"].get("executor.compile_cache_builds", 0)
    if builds < 1:
        fail(f"launcher tuned: metrics count {builds} executor builds")
    prof = KernelProfile.load(str(paths["cache"]))
    measured = sum(win.seconds) / max(len(win.seconds), 1)
    pred = {"uncalibrated": cm.iter_time(ex.configs, 1, ex.seq),
            "calibrated": prof.calibrate(cm).iter_time(ex.configs, 1, ex.seq)}
    return {"blocks": prof.best_blocks(*model_shapes(get_config("qwen25-7b"), ex.configs,
                                                     ex.seq)[0]),
            "autotune_entries": prof.entries, "lora_speedup": prof.lora_speedup(),
            "trace_tiers": tiers, "trace_events": len(trace["traceEvents"]),
            "metrics_counters": metrics["counters"],
            **{f"pred_{k}_s": v for k, v in pred.items()},
            **{f"drift_{k}": measured / v - 1.0 for k, v in pred.items()}}


def launcher_phase(torch, dev, out_dir: Path):
    """The training launcher under --impl fused and --impl auto on the f32
    base, then tuned and traced (--impl fused --autotune-cache --trace-out
    --metrics-out, a fresh cache), then the planted control (--impl fused,
    the delta's scale left out); returns each impl's launch counts. Each
    run's last step (a replay of its captured graph) runs under
    ``torch.profiler``. Each run's own peak but the control's (the device's
    peak less what earlier phases hold) must lie within [1, C3_SLACK] of the
    price of the launcher's own ``CostModel`` (ROADMAP C5: priced at the
    tree's storage, "f32"). The tuned run's trace must pass
    ``validate_chrome_trace`` with spans of the autotune and executor tiers,
    its metrics count at least one executor build, and its losses and
    updates agree with the untuned fused run's within the launcher's
    limits; it prints the uncalibrated and the calibrated prior's s/step
    against the measured."""
    from repro_torch.kernels import fused as fused_module
    from repro_torch.kernels import launches
    from repro_torch.launch import train as launch_train

    counts, losses, adapters = {}, {}, {}
    cost_model, priced = launch_train.CostModel, []

    def pricing(*args, **kw):  # the launcher's own CostModel, kept to price its run
        priced.append(cost_model(*args, **kw))
        return priced[-1]

    tuned = {"cache": out_dir / "autotune_launcher.json",
             "trace": out_dir / "trace_launcher.json",
             "metrics": out_dir / "metrics_launcher.json"}
    for run in LAUNCH_IMPLS + ("tuned", "control"):
        impl = "auto" if run == "auto" else "fused"
        argv = LAUNCH_ARGS + ["--impl", impl]
        if run == "tuned":
            for path in tuned.values():
                path.unlink(missing_ok=True)
            argv += ["--autotune-cache", str(tuned["cache"]), "--trace-out", str(tuned["trace"]),
                     "--metrics-out", str(tuned["metrics"])]
        ex = launcher_executor()
        win = StepWindow(torch, dev, profile_step=None if run == "control" else LAUNCH_STEPS - 1,
                         table=out_dir / f"profile_launcher_{run}.txt")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        zero_counts()
        kernel = fused_module.fused_matmul
        if run == "control":
            fused_module.fused_matmul = unscaled_delta(kernel)
        launch_train.CostModel = pricing
        t0 = time.perf_counter()
        try:
            per = launch_train.main(argv, executor=ex, step_callback=win)
        finally:
            fused_module.fused_matmul = kernel
            launch_train.CostModel = cost_model
        wall = time.perf_counter() - t0
        counts[run], paths = launches.read(), launches.read_paths()
        peak = torch.cuda.max_memory_allocated(dev)
        cm = priced[-1]
        price = cm.job_mem_bytes(ex.configs, 1, ex.seq)
        losses[run], adapters[run] = np.asarray(per, dtype=np.float64), (ex.w0, ex.w)
        prof = dict(win.profile or {})
        # StepWindow's share counts every kernel in namespace plora: here the
        # impl's own kernels (fused: the ffma kernel, its xA pass, and the
        # split-K epilogue)
        share = {k.replace("packed_matmul", "port_kernels"): prof.pop(k)
                 for k in list(prof) if k.startswith("packed_matmul")}
        own = tuned_run(ex, cm, win, tuned) if run == "tuned" else {}
        emit({"phase": "launcher", "impl": impl, "run": run,
              "args": argv, "base_dtype": "float32",
              "per_adapter_loss": losses[run].tolist(),
              "step_s": win.seconds, "s_per_step": sum(win.seconds) / max(len(win.seconds), 1),
              "capture_s": ex.captures[-1]["seconds"] if ex.captures else None,
              "captures": len(ex.captures), "wall_s": wall, "held_bytes": held,
              "max_memory_allocated": peak, "job_peak_bytes": peak - held,
              "priced_base_dtype": cm.base_dtype, "job_mem_bytes": price,
              "price_over_peak": price / (peak - held), "launches": counts[run],
              "launches_by_path": paths, "profile": prof, **share, **own})
        ex.clear()
        del ex, win
        if not np.isfinite(losses[run]).all():
            fail(f"launcher {run}: non-finite final loss {losses[run].tolist()}")
        for need in LAUNCH_NEEDED[impl]:
            if counts[run][need] == 0:
                fail(f"launcher {run}: the {need} launch count stayed at 0")
        # every f32 call of the impl's kernel on its f32 path
        kernel_name, f32_path = ("fused_matmul", "ffma") if impl == "fused" \
            else ("packed_matmul", "f32skinny")
        on = paths[kernel_name]
        off = {p: k for p, k in on.items() if p != f32_path and k}
        if off or not on[f32_path]:
            fail(f"launcher {run}: f32 {kernel_name} calls off the {f32_path} path: {on}")
        if run != "control" and (cm.base_dtype != "f32"
                                 or not peak - held <= price <= C3_SLACK * (peak - held)):
            fail(f"C5: launcher {run} priced as {cm.base_dtype!r} at {price} bytes, not within "
                 f"[1, {C3_SLACK}] x its own peak {peak - held}")

    def rel(run, ref_run="auto"):
        w0, ref = adapters[ref_run]
        w = adapters[run][1]
        return {"loss_rel_err": float(np.max(np.abs(losses[run] - losses[ref_run])
                                             / np.abs(losses[ref_run]))),
                "update_rel_err": max(update_err(w[i], ref[i], w0[i]) for i in range(len(w0)))}

    got, control, tuned_err = rel("fused"), rel("control"), rel("tuned", "fused")
    emit({"phase": "launcher_agreement", **got, "loss_rtol": LAUNCH_LOSS_RTOL,
          "update_rtol": LAUNCH_UPDATE_RTOL,
          **{f"control_{k}": v for k, v in control.items()},
          "control_factor": LAUNCH_CONTROL_FACTOR,
          **{f"tuned_vs_fused_{k}": v for k, v in tuned_err.items()}})
    if not (tuned_err["loss_rel_err"] <= LAUNCH_LOSS_RTOL
            and tuned_err["update_rel_err"] <= LAUNCH_UPDATE_RTOL):
        fail(f"launcher: the tuned run is {tuned_err} off the untuned --impl fused run's "
             f"(limits {LAUNCH_LOSS_RTOL} / {LAUNCH_UPDATE_RTOL})")
    if not got["loss_rel_err"] <= LAUNCH_LOSS_RTOL:
        fail(f"launcher: --impl fused and --impl auto final losses differ by "
             f"{got['loss_rel_err']} > {LAUNCH_LOSS_RTOL}")
    if not got["update_rel_err"] <= LAUNCH_UPDATE_RTOL:
        fail(f"launcher: --impl fused's adapter updates are {got['update_rel_err']} off "
             f"--impl auto's (limit {LAUNCH_UPDATE_RTOL})")
    if not control["update_rel_err"] > LAUNCH_CONTROL_FACTOR * LAUNCH_UPDATE_RTOL:
        fail(f"launcher: the planted control (delta's scale left out) reads "
             f"{control['update_rel_err']}, not above {LAUNCH_CONTROL_FACTOR} x "
             f"{LAUNCH_UPDATE_RTOL}: the update check cannot see that fault")
    return {impl: counts[impl] for impl in LAUNCH_IMPLS}


# ---------------------------------------------------------------------------
# families phase: starcoder2-7b and gemma3-1b at full width and depth
# ---------------------------------------------------------------------------

# The two dense families besides qwen25-7b, each through train, serve and
# (starcoder2) the sweep, on a bf16 base of random weights from SEED.
# starcoder2-7b: LayerNorm, the two-matrix GELU MLP, biased GQA (d 4,608,
# d_ff 18,432); gemma3-1b: 512-token sliding windows with every 6th layer
# global, the gated GELU, tied embeddings (d 1,152, a 256-wide k/v output,
# head_dim 256). gemma3 trains at seq 1,024 (at 512 a 512-token window masks
# nothing, and the band path needs more than one query chunk of 512) and
# serves prompts of 520-600 tokens with 8 decode steps past the window.
# minicpm3-4b: multi-head latent attention (q_a 768, kv_a 288 = the
# 256-wide latent + the 32-wide rope part, heads of 64 + 32 / 64), served
# through the absorbed decode; d 2,560, d_ff 6,400, 62 layers.
# mamba2-370m: attention-free, 48 SSD layers (d 1,024, d_inner 2,048, 32
# heads of 64, d_state 128, chunks of 256), no FFN, tied embeddings; LoRA
# on zx (1,024 -> 4,096) and out (2,048 -> 1,024); a fixed-size decode
# cache (conv window and state, f32).
# whisper-tiny: the encoder-decoder (arXiv:2212.04356; d 384, 6 heads of
# 64, biased q/k/v, LayerNorm, the gated GELU of 1,536, vocab 51,865): a
# 4-layer non-causal encoder over 1,500 precomputed frames a row (the front
# end's stub) and a 4-layer decoder whose every layer adds a
# cross-attention over the encoder's output; LoRA on q, v, gate, up and
# down of both stacks and on the decoder's cross q (its cross v adapter is
# read by no loss: a zero gradient, as the reference's). internvl2-1b: the
# LM of a VLM (Qwen2-0.5B: 24 layers, d 896, GQA 14/2 of 64, biased, rope
# theta 1e6, d_ff 4,864, vocab 151,655) behind 256 precomputed patch
# embeddings a row, each through a biased patch_proj. Both at full width
# and depth.
WHISPER = "whisper-tiny"
INTERNVL = "internvl2-1b"
FAMILIES = ("starcoder2-7b", "gemma3-1b", "minicpm3-4b", "mamba2-370m", WHISPER, INTERNVL)
MAMBA2 = "mamba2-370m"
# the moe phase's model (moe_phase), whose kernel rows and serve runs share
# the families' tables
MOE = "qwen3-moe-30b-a3b"
# the jamba phase's model (jamba_phase), likewise
JAMBA = "jamba-v0.1-52b"
# depth cuts (a view of the family's base, ``depth_cut``) that keep the
# smoke inside its time
FAMILY_LAYERS = {"starcoder2-7b": 8, "gemma3-1b": 7, "minicpm3-4b": 16, MAMBA2: 24}
# mamba2's 1,024 tokens: the scan carries its state across 4 chunks
# whisper's decoder at its 448 tokens (``max_seq_len``) over 1,500 frames a
# row; internvl2's 512 positions: 256 patches + 256 text tokens
FAMILY_TRAIN_SEQ = {"starcoder2-7b": 512, "gemma3-1b": 1024, "minicpm3-4b": 512,
                    MAMBA2: 1024, WHISPER: 448, INTERNVL: 512}
FAMILY_TRAIN_STEPS = 2
FAMILY_TRAIN_IMPLS = ("auto", "fused")
# (impls, prompt lengths [lo, hi), new tokens per request, teacher-forced
# decode steps; gemma3's and mamba2's steps cut from 8 to 4 for the chunk
# gates' time)
FAMILY_SERVE = {"starcoder2-7b": (("auto",), (64, 257), 8, 4),
                "gemma3-1b": (("auto", "fused"), (520, 601), 8, 4),
                "minicpm3-4b": (("auto", "fused"), (64, 257), 8, 4),
                # prompts of 200-600 tokens: below, across and past the scan's
                # 256- and 512-token chunk boundaries
                MAMBA2: (("auto", "fused"), (200, 601), 8, 4),
                # a prefill of T tokens drops pairs past 1.25 T k / E slots an
                # expert; 8 decode rows drop none (8 slots at least)
                MOE: (("auto", "fused"), (64, 601), 8, 4),
                # the SSD layers' chunks of 256, and the MoE layers' drops, as
                # mamba2's and qwen3-moe's
                JAMBA: (("auto", "fused"), (200, 601), 8, 4),
                # each request with its own frames / patches (``request_extras``);
                # internvl2's positions start after its 256 patches
                WHISPER: (("auto", "fused"), (16, 201), 8, 4),
                INTERNVL: (("auto", "fused"), (64, 258), 8, 4)}
# the families whose first prompt's chunked prefill is held against its
# one-shot prefill and the plain path's chunks (``chunk_gates``), with the
# chunk: gemma3's prompt crosses its window of 512, minicpm3 takes MLA's
# chunk branch, mamba2 resumes its scan at its own chunk of 256
FAMILY_CHUNK = {"gemma3-1b": CHUNK, "minicpm3-4b": CHUNK, MAMBA2: 256}
# the families whose serve check feeds the plain path the kernel path's
# expert choices, as it feeds it the kernel path's tokens
# (``teacher_forced(routes=)``). At a near-tie between a token's k-th and
# (k+1)-th expert, a 1-ulp difference of the two paths' bf16 projections
# takes another expert, and jamba's SSD layers carry that token's changed
# output into the state every later position of its prompt reads: with the
# plain path on its own routing the fused prefill logits sat 15.8 % of max
# |logit| from the kernel path's, and 1.2 % with the routing replayed
# (H100, ``scripts/moe_routing.py jamba``; PERF.md). The check then holds the
# replayed logits to LOGIT_TOL and the routing itself to ROUTE_AGREEMENT: at
# least that share of the kernel path's top-k choices, per MoE layer, are
# the plain path's own too.
ROUTE_REPLAY = (JAMBA,)
ROUTE_AGREEMENT = 0.95
# the sweep phase's first three configurations (ranks 8, 8, 16): one job
FAMILY_SWEEP_IDS = (0, 37, 74)
FAMILY_SWEEPS = ("starcoder2-7b", "minicpm3-4b", MAMBA2, WHISPER, INTERNVL)
# a sweep job's sequence: the model's train length for the two, else SWEEP_SEQ
FAMILY_SWEEP_SEQ = {WHISPER: 448, INTERNVL: 512}
# the kernel phase's rows at each family's shapes
FAMILY_TRAIN_CASE = {"starcoder2-7b": "train_starcoder2", "gemma3-1b": "train_gemma3",
                     "minicpm3-4b": "train_minicpm3", MAMBA2: "train_mamba2",
                     MOE: "train_qwen3_moe", WHISPER: "train_whisper",
                     INTERNVL: "train_internvl2"}
FAMILY_DECODE_CASE = {"gemma3-1b": "decode_gemma3", "minicpm3-4b": "decode_minicpm3",
                      MAMBA2: "decode_mamba2", MOE: "decode_qwen3_moe",
                      WHISPER: "decode_whisper", INTERNVL: "decode_internvl2"}
# whisper's encoder layer (q/v 384 -> 384, gate/up 384 -> 1,536, down), rows
# of its own; ``family_proj``'s "encoder"
WHISPER_ENC_CASE = "train_whisper_enc"
# (N, M) of a family train case's rows where it is not TRAIN_CASE: an
# adapter's rows in the main path's calls. Whisper's encoder at 1,500 frames
# a row -- no multiple of 64, so #2's pack of 2 takes "wgmma" with its row
# tiles per adapter (``fused.cuh``, ``wg_tpa``) -- and its decoder at 448
# tokens (its cross q included)
CASE_ROWS = {WHISPER_ENC_CASE: (2, 1500), "train_whisper": (2, 448)}
# jamba's two kinds of layer, each with rows of its own: an SSD layer (zx
# 4,096 -> 16,384, out 8,192 -> 4,096) and the attention layer (q/o 4,096 ->
# 4,096, k/v 4,096 -> 1,024)
JAMBA_CASES = {"ssm": {"train": "train_jamba_ssd", "decode": "decode_jamba_ssd"},
               "attn": {"train": "train_jamba_attn", "decode": "decode_jamba_attn"}}
# mamba2 through the launcher on its own f32 base (the command a user
# runs, at full width and depth): 6 captured steps of 2 x 1,024 tokens
MAMBA2_LAUNCH_ARGS = ["--arch", MAMBA2, "--seq", "1024", "--ranks", "8,16", "--steps", "6",
                      "--log-every", "0"]
# whisper through the launcher on its own f32 base: 4 captured steps of 2 x
# 448 tokens over 1,500 frames a row, --impl fused against --impl auto
# (final losses within LAUNCH_LOSS_RTOL, updates within LAUNCH_UPDATE_RTOL)
WHISPER_LAUNCH_ARGS = ["--arch", WHISPER, "--seq", "448", "--ranks", "8,16", "--steps", "4",
                       "--log-every", "0"]
# minicpm3-4b's kv_a (K = 2,560 -> L = 288; its dx at K = 288): the first
# main-path width that is not a multiple of 64, listed on a line of its own
KV_A = (2560, 288)


def family_proj(cfg, mixer=None):
    """(d_in, d_out) of the projections that carry an adapter (the
    kernels' calls; MLA's q_b, kv_b_k and kv_b_v are plain products) on one
    layer -- the first of mixer ``mixer`` ("attn" or "ssm"; the config's
    first layer when None; "encoder": an encoder-decoder's encoder layer) --
    with their count per layer, as PROJ (equal shapes merged). A decoder
    layer's cross-attention counts its q, not the k/v adapters no loss
    reads (CROSS_UNREAD: their K/V are plain products)."""
    from repro_torch.configs.base import CROSS_UNREAD, ENCODER_LAYER, lora_layout
    from repro_torch.models.transformer import layer_specs

    if mixer == "encoder":
        layout = lora_layout(cfg, *ENCODER_LAYER)
    else:
        spec = next(s for s in layer_specs(cfg) if mixer in (None, s.mixer))
        layout = lora_layout(cfg, spec.mixer, spec.ffn, spec.cross)
    out = {}
    for grp, projs in layout.items():
        for nm, sh in projs.items():
            if not (grp == "cross" and nm in CROSS_UNREAD):
                out[sh] = out.get(sh, 0) + 1
    return list(out.items())


def family_cases(kind: str):
    """(arch, mixer, case) of the kernel phase's rows at the families'
    shapes, ``kind`` "train" or "decode": one case a family, one for each
    of jamba's layer kinds (its "layer" is no longer one shape), and, in
    training, whisper's encoder layer beside its decoder layer."""
    one = FAMILY_TRAIN_CASE if kind == "train" else FAMILY_DECODE_CASE
    return ([(arch, None, case) for arch, case in one.items()]
            + [(JAMBA, mixer, cases[kind]) for mixer, cases in JAMBA_CASES.items()]
            + ([(WHISPER, "encoder", WHISPER_ENC_CASE)] if kind == "train" else []))


def case_proj(case: str):
    """The projections a kernel-phase case sums over one layer."""
    from repro_torch.configs import get_config

    if case in (CR_TRAIN_CASE, CR_DECODE_CASE, CR_LAUNCH_CASE):
        return family_proj(get_config(COMMAND_R))
    for arch, mixer, c in (*family_cases("train"), *family_cases("decode")):
        if case == c:
            return family_proj(get_config(arch), mixer)
    return PROJ


def request_extras(torch, cfg, n: int):
    """``n`` requests' front-end stubs, 0.1 x N(0, 1) in f32 from a seed:
    an encoder-decoder's frames (1, S_enc, d), a VLM's patches (1, P, d)
    (each request its own); empty dicts for a decoder alone."""
    gen = torch.Generator().manual_seed(SEED + 3)
    shapes = {"frames": cfg.encoder_seq_len if cfg.is_encdec else 0,
              "patches": cfg.n_patch_tokens}
    return [{k: 0.1 * torch.randn((1, s, cfg.d_model), generator=gen)
             for k, s in shapes.items() if s} for _ in range(n)]


def family_serve(torch, dev, arch: str, cfg, base):
    """8 requests through ``ServeEngine.serve`` under each impl of
    FAMILY_SERVE (launch counts zeroed just before each drain and read
    just after), each with its own frames or patches where the model takes
    them, then prefill logits and teacher-forced decode steps held against
    the plain path; for FAMILY_CHUNK, the first prompt's chunked prefill
    (``chunk_gates``). Returns each impl's launch counts."""
    from repro_torch.serve.engine import ServeEngine, poisson_requests

    impls, (lo, hi), new_tokens, steps = FAMILY_SERVE[arch]
    adapters = make_adapters(torch, cfg, 8)
    lora1s = row_adapters(torch, cfg, adapters, dev)
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(0, cfg.vocab_size, size=rng.randint(lo, hi)).astype(np.int32)
               for _ in range(8)]
    extras = request_extras(torch, cfg, 8)
    reqs = [dataclasses.replace(r, extra=e) for r, e in zip(
        poisson_requests([f"ad{i}" for i in range(8)], prompts, 2.0, max_new_tokens=new_tokens,
                         seed=SEED), extras)]
    smax = (hi + cfg.n_patch_tokens + max(new_tokens, steps) + 63) // 64 * 64
    counters = {"auto": "packed_matmul", "fused": "fused_matmul"}
    launches = {}
    for impl in impls:
        eng = ServeEngine(cfg, base, rows=8, smax=smax, r_bucket=16, slot_capacity=8,
                          impl=impl, device=dev)
        for i, (tree, r) in enumerate(adapters):
            eng.publish(f"ad{i}", tree, {"rank": r, "alpha": float(r)})
        zero_counts()
        stats = eng.serve(reqs)
        torch.cuda.synchronize()
        launches[impl] = train_counts()
        gate = step_gate(torch, eng, [int(p[-1]) for p in prompts],
                         [len(p) + cfg.n_patch_tokens for p in prompts],
                         f"{cfg.name} serve impl={impl}")
        bad = [r for r in stats.results if r.error is not None or len(r.tokens) != new_tokens]
        toks = np.stack([r.tokens for r in stats.results]) if not bad else np.zeros((0,))
        lat = stats.latency_summaries()
        emit({"phase": "family_serve", "model": cfg.name, "impl": impl, "smax": smax,
              "prompt_tokens": [len(p) for p in prompts], "requests": len(stats.results),
              "tokens": stats.tokens_emitted, "steps": stats.steps,
              "wall_s": stats.wall_seconds, "tokens_per_s": stats.tokens_per_s,
              "ttft_p50_s": lat["ttft"]["p50"], "itl_p50_s": lat["itl"]["p50"],
              "step_host_us_p50": 1e6 * lat["step_host"]["p50"], "captures": eng.captures,
              "step_logits": gate, "launches": launches[impl]})
        if launches[impl][counters[impl]] == 0:
            fail(f"{cfg.name} serve impl={impl}: the {counters[impl]} kernel was never launched")
        if bad or len(stats.results) != 8:
            fail(f"{cfg.name} serve impl={impl}: requests failed: "
                 f"{[(r.request_id, r.error) for r in bad]}")
        if toks.min() < 0 or toks.max() >= cfg.vocab_size:
            fail(f"{cfg.name} serve impl={impl}: token ids outside the vocabulary")
        del eng
        t0 = time.perf_counter()
        routes = {} if arch in ROUTE_REPLAY else None
        with torch.no_grad():
            pimpl = {"auto": "plain", "fused": "fused_plain"}[impl]
            per_step, ref_max, per_dec = teacher_forced(
                torch, cfg, base, adapters, prompts, smax, impl, pimpl, counters[impl], steps,
                lora1s=lora1s, routes=routes, extras=extras)
            if arch in FAMILY_CHUNK:
                chunk_gates(torch, cfg, base, lora1s[:1], prompts[:1], impl, FAMILY_CHUNK[arch])
        rel = max(per_step) / ref_max
        extra = {} if routes is None else {
            "plain_replays_kernel_routes": True,
            "max_abs_err_own_routes": routes["own_routes_per_step"],
            "rel_err_own_routes": max(routes["own_routes_per_step"]) / ref_max,
            "topk_agreement_by_layer": routes["topk_agreement_by_layer"],
            "topk_agreement_tol": ROUTE_AGREEMENT}
        emit({"phase": "family_serve_logits", "model": cfg.name, "impl": impl, "plain": pimpl,
              "seconds": time.perf_counter() - t0,
              "prompt_tokens": [len(p) for p in prompts], "decode_steps": steps,
              "last_position": max(len(p) for p in prompts) + steps - 1,
              "window": cfg.attention.sliding_window,
              "launches_per_decode_step": per_dec, "max_abs_err_prefill": per_step[0],
              "max_abs_err_decode": per_step[1:], "max_abs_logit": ref_max, "rel_err": rel,
              "tol": LOGIT_TOL, **extra})
        if not rel <= LOGIT_TOL:
            fail(f"{cfg.name} impl={impl}: logits differ from {pimpl} by {rel} > {LOGIT_TOL}")
        if routes is not None and not min(routes["topk_agreement_by_layer"]) >= ROUTE_AGREEMENT:
            fail(f"{cfg.name} impl={impl}: the plain path's router makes "
                 f"{routes['topk_agreement_by_layer']} of the kernel path's top-k choices per "
                 f"MoE layer, below {ROUTE_AGREEMENT}")
        torch.cuda.empty_cache()
    return launches


def family_sweep(torch, dev, cfg, base, out_dir: Path, seq: int = SWEEP_SEQ):
    """``ExecutionEngine.run_local`` on FAMILY_SWEEP_IDS of
    ``default_search_space(300, seq_len=seq)``: one job on the H100 preset,
    captured (impl="auto"), held against an eager run of the same pack from
    the same initial weights (bit for bit, else losses within LOSS_RTOL),
    its launches against the eager steps', its own peak to C3, and
    extract -> inject -> extract of its last adapter bit-exact on the card.
    Returns its launch counts."""
    import shutil

    from repro_torch.cluster import ClusterRunner, DevicePool, SliceExecutor
    from repro_torch.cluster.executor import WARMUP_STEPS
    from repro_torch.configs import default_search_space
    from repro_torch.core.adapter import pack_meta
    from repro_torch.core.packed_lora import extract_adapter, inject_adapter
    from repro_torch.models.model import lora_zeros
    from repro_torch.obs import MetricsTracer
    from repro_torch.sched import H100, CostModel, ExecutionEngine, plan
    from repro_torch.train.checkpoint import CheckpointPool
    from repro_torch.tree import tree_leaves, tree_map

    space = default_search_space(300, seq_len=seq)
    configs = [space[i] for i in FAMILY_SWEEP_IDS]
    cm = CostModel(cfg, H100)
    sched = plan(cm, configs, 1, seq, SWEEP_STEPS)
    if len(sched.jobs) != 1:
        fail(f"{cfg.name}: the planner made {len(sched.jobs)} jobs of the 3 configurations")
    pool_dir = ROOT / "smoke_pool"
    shutil.rmtree(pool_dir, ignore_errors=True)
    try:
        pool = CheckpointPool(str(pool_dir))
        tracer = MetricsTracer()
        ex = SliceExecutor(tracer=tracer)
        runner = ClusterRunner(ex, DevicePool([dev]), tracer=tracer)
        torch.cuda.synchronize(dev)
        held = held_bytes(torch, dev, base)
        zero_counts()
        records, makespan = ExecutionEngine(cm, 1, tracer=tracer).run_local(
            sched, configs, cfg, base, n_steps=SWEEP_STEPS, seq=seq, pool=pool,
            runner=runner, impl="auto")
        torch.cuda.synchronize(dev)
        launches = train_counts()
        rec, t = records[0], runner.last_result.timings[0]
        jc = [configs[i] for i in sched.jobs[0].config_ids]
        m = pack_meta(jc)
        cap = ex.captures[0] if ex.captures else {}
        row = {"job": 0, "config_ids": list(sched.jobs[0].config_ids),
               "space_ids": list(FAMILY_SWEEP_IDS), "ranks": list(m.ranks),
               "rows": m.n * m.max_batch, "predicted_s_per_iter": t.predicted_iter,
               "measured_s_per_iter": t.measured_iter, "drift": t.drift,
               "final_losses": [float(x) for x in rec.final_losses],
               "peak_allocated_bytes": rec.peak_bytes, "job_peak_bytes": rec.peak_bytes - held,
               "job_mem_bytes": cm.job_mem_bytes(jc, 1, seq),
               "capture_s": cap.get("seconds"), "captured": rec.captured}
        cap_ads = [pool.load_adapter(f"adapter_{i:04d}") for i in sched.jobs[0].config_ids]
        # extract -> inject of the job's last adapter, on the card: into a
        # one-adapter pack of zeros, back to the card, and out again
        one = pack_meta([jc[-1]])
        packed = inject_adapter(lora_zeros(cfg, one, torch.float32, "cpu"), cap_ads[-1], 0)
        again = extract_adapter(tree_map(lambda a: torch.from_numpy(a).to(dev), packed), 0,
                                one.ranks)
        roundtrip = all(np.array_equal(a, b) for a, b in zip(tree_leaves(again),
                                                              tree_leaves(cap_ads[-1])))
        ex.clear()
        torch.cuda.empty_cache()
        slice_ = DevicePool([dev]).acquire(1)
        win = StepWindow(torch, dev)
        zero_counts()
        res = SliceExecutor(capture=False).train_pack(
            cfg, jc, n_steps=SWEEP_STEPS, seq=seq, base=base,
            lora=ex.pack_template(cfg, jc, 0, dev)[0], slice_=slice_,
            budgets=np.full((m.n,), SWEEP_STEPS, np.int32), step_callback=win)
        eager = train_counts()
        cmp = compare_runs(torch, f"{cfg.name} sweep job", [rec.final_losses],
                           torch.stack(win.losses[-1:]), cap_ads, res.lora, m.ranks)
        del res
        expect = {k: eager[k] * (WARMUP_STEPS + SWEEP_STEPS) // SWEEP_STEPS for k in launches}
        emit({"phase": "family_sweep", "model": cfg.name, "job": row, "makespan_s": makespan,
              "captured_vs_eager": cmp, "eager_step_s": win.seconds, "launches": launches,
              "launches_expected_from_eager": expect, "held_bytes": held,
              "extract_inject_bit_exact": roundtrip, "metrics": tracer.metrics.to_json()})
        if not rec.captured:
            fail(f"{cfg.name}: the sweep's job was not captured")
        if not roundtrip:
            fail(f"{cfg.name}: extract -> inject -> extract of an adapter is not bit-exact")
        if launches != expect:
            fail(f"{cfg.name}: the sweep counted {launches} launches; its eager steps make "
                 f"{expect}")
        if not all(math.isfinite(x) for x in row["final_losses"]):
            fail(f"{cfg.name}: a non-finite loss in the sweep")
        c3_check(f"{cfg.name}'s sweep", [row], [jc], cfg)
        return launches
    finally:
        shutil.rmtree(pool_dir, ignore_errors=True)


def mamba2_launcher(torch, dev) -> dict:
    """``launch/train.py`` with MAMBA2_LAUNCH_ARGS: full mamba2-370m on the
    launcher's own f32 base, captured steps (``launcher_run``: s/step, its
    own peak beside its price); fails on a non-finite loss or a
    ``packed_matmul`` count that stayed at 0. Returns its counts."""
    rec = launcher_run(torch, dev, MAMBA2_LAUNCH_ARGS)
    emit({"phase": "mamba2_launcher", **rec})
    if not np.isfinite(rec["per_adapter_loss"]).all():
        fail(f"{MAMBA2} launcher: non-finite final loss {rec['per_adapter_loss']}")
    for need in ("packed_matmul", "packed_matmul_bwd"):
        if rec["launches"][need] == 0:
            fail(f"{MAMBA2} launcher: the {need} launch count stayed at 0")
    return rec["launches"]


def whisper_launcher(torch, dev) -> dict:
    """``launch/train.py`` with WHISPER_LAUNCH_ARGS under --impl fused and
    --impl auto: full whisper-tiny on its own f32 base, captured steps
    (``launcher_run``); fails on a non-finite loss, a count of
    LAUNCH_NEEDED that stayed at 0, final losses or adapter updates of the
    two impls farther apart than LAUNCH_LOSS_RTOL / LAUNCH_UPDATE_RTOL, or
    an own peak outside [1, C3_SLACK] of the launcher's price. Returns each
    impl's counts."""
    recs, kept = {}, {}
    for impl in LAUNCH_IMPLS:
        ex = launcher_executor()
        recs[impl] = launcher_run(torch, dev, WHISPER_LAUNCH_ARGS + ["--impl", impl], ex=ex)
        kept[impl] = np.asarray(recs[impl]["per_adapter_loss"]), ex.w0, ex.w
        emit({"phase": "whisper_launcher", "impl": impl, **recs[impl]})
    (la, w0, wa), (lf, _, wf) = kept["auto"], kept["fused"]
    loss_err = float(np.max(np.abs(lf - la) / np.abs(la)))
    upd_err = max(update_err(wf[i], wa[i], w0[i]) for i in range(len(w0)))
    emit({"phase": "whisper_launcher_agreement", "loss_rel_err": loss_err,
          "update_rel_err": upd_err, "loss_rtol": LAUNCH_LOSS_RTOL,
          "update_rtol": LAUNCH_UPDATE_RTOL})
    for impl, rec in recs.items():
        if not np.isfinite(rec["per_adapter_loss"]).all():
            fail(f"{WHISPER} launcher {impl}: non-finite final loss {rec['per_adapter_loss']}")
        for need in LAUNCH_NEEDED[impl]:
            if rec["launches"][need] == 0:
                fail(f"{WHISPER} launcher {impl}: the {need} launch count stayed at 0")
        if not rec["job_peak_bytes"] <= rec["job_mem_bytes"] <= C3_SLACK * rec["job_peak_bytes"]:
            fail(f"C5: {WHISPER} launcher {impl}: job_mem_bytes {rec['job_mem_bytes']} is not "
                 f"within [1, {C3_SLACK}] x its own peak {rec['job_peak_bytes']}")
    if not (loss_err <= LAUNCH_LOSS_RTOL and upd_err <= LAUNCH_UPDATE_RTOL):
        fail(f"{WHISPER} launcher: --impl fused is {loss_err} / {upd_err} off --impl auto "
             f"(limits {LAUNCH_LOSS_RTOL} / {LAUNCH_UPDATE_RTOL})")
    return {impl: rec["launches"] for impl, rec in recs.items()}


def families_phase(torch, dev, out_dir: Path, archs=FAMILIES):
    """starcoder2-7b, gemma3-1b, minicpm3-4b, mamba2-370m, whisper-tiny,
    then internvl2-1b, at full width on a bf16 base (at full depth but for
    FAMILY_LAYERS' cuts): train (auto and fused: step 1 against the plain
    path, then FAMILY_TRAIN_STEPS steps with launch counts), serve
    (FAMILY_SERVE) and, for FAMILY_SWEEPS, one captured sweep job; for
    mamba2 and whisper also the launcher on its own f32 base
    (``mamba2_launcher``, ``whisper_launcher``). Returns the launch counts
    by family and run. ``archs``: the families to run, in FAMILIES'
    order."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_model
    from repro_torch.tree import tree_leaves

    out = {}
    for arch in [a for a in FAMILIES if a in archs]:
        cfg = get_config(arch)
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base, _ = init_model(SEED, cfg, None, dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        if arch in FAMILY_LAYERS:
            cfg, base = depth_cut(cfg, base, FAMILY_LAYERS[arch])
        emit({"phase": "family_setup", "model": arch, "n_layers": cfg.n_layers,
              "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
              "params": sum(t.numel() for t in tree_leaves(base)), "dtype": "bfloat16",
              "init_s": time.perf_counter() - t0, "weights_gb": resident_bytes(base) / 1e9,
              "allocated_gb": torch.cuda.memory_allocated(dev) / 1e9})
        counts, stages, lap = {}, {}, time.perf_counter()

        def stage(name):  # the seconds since the last stage ended
            nonlocal lap
            stages[name], lap = time.perf_counter() - lap, time.perf_counter()

        seq = FAMILY_TRAIN_SEQ[arch]
        _, meta, lora0, batches = train_setup(torch, dev, cfg, seq, FAMILY_TRAIN_STEPS)
        for impl in FAMILY_TRAIN_IMPLS:
            row, counts[f"train:{impl}"], state = train_run(
                torch, dev, cfg, meta, lora0, batches, base, impl, phase="family_train")
            del state
            split3 = row["launches_by_path"]["fused_matmul"]["split3"]
            if arch == WHISPER and split3:
                fail(f"{arch} train impl={impl}: {split3} fused_matmul calls on \"split3\" "
                     "(its ragged encoder packs belong on \"wgmma\")")
            torch.cuda.empty_cache()
        del lora0, batches
        stage("train")
        for impl, c in family_serve(torch, dev, arch, cfg, base).items():
            counts[f"serve:{impl}"] = c
        stage("serve")
        if arch in FAMILY_SWEEPS:
            counts["sweep:auto"] = family_sweep(torch, dev, cfg, base, out_dir,
                                                FAMILY_SWEEP_SEQ.get(arch, SWEEP_SEQ))
            stage("sweep")
        if arch == MAMBA2:
            counts["launcher"] = mamba2_launcher(torch, dev)
            stage("launcher")
        if arch == WHISPER:
            for impl, c in whisper_launcher(torch, dev).items():
                counts[f"launcher:{impl}"] = c
            stage("launcher")
        out[arch] = counts
        emit({"phase": "family_done", "model": arch, "seconds": time.perf_counter() - t0,
              "stages_s": stages})
        del base
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# command_r phase: command-r-35b at full width and depth on a quantized base
# ---------------------------------------------------------------------------

# command-r-35b (hf:CohereForAI/c4ai-command-r-v01: 40 layers, d 8,192, GQA
# 64/8 of 128, d_ff 22,528, vocab 256,000, tied): 30.28 B parameters, 60.6 GB
# of bf16, so one card holds it only quantized. Its int8 and nf4 bases are
# built layer by layer (``init_model(..., quant=)``: the dense tree never
# exists) from SEED, after every earlier base is freed.
COMMAND_R = "command-r-35b"
# the streamed build against dense-then-quantize, at full width cut to
# this depth (the dense base of 40 layers does not fit beside it)
CR_CHECK_LAYERS = 2
# each streamed build's own peak must stay under these bytes: the quantized
# tree (int8 32.4 GB, nf4 20.0 GB) plus one layer's temporaries, or the
# embedding's f32 draw (12.6 GB with the bf16 copy)
CR_BUILD_PEAK = {"int8": 40e9, "nf4": 28e9}
# steps cut from 3 to 2, and the teacher-forced decode steps below from 4
# to 2, for the serve phase's chunked drains (PERF.md §4)
CR_TRAIN_STEPS = 2
CR_TRAIN_IMPLS = ("auto", "fused")
# (base, impl) of each serve run: 8 requests of 64-256 prompt tokens, 16
# new tokens each, 8 rows; under "fused" each decode step runs
# fused_matmul_q's decode rows, under "auto" each projection is
# dequantized per call (the reference's formulation: slow by design)
CR_SERVE_RUNS = (("int8", "fused"), ("int8", "auto"), ("nf4", "fused"))
CR_SERVE_PROMPT = (64, 257)
# 8 new tokens a request (16 before the sweep phase's tune_serve step came:
# the cut that pays for it)
CR_SERVE_NEW = 8
CR_SERVE_STEPS = 2  # teacher-forced decode steps held against the plain path
# the launcher on an nf4 base with an f32 x (the launcher draws in f32):
# fused_matmul_q on its "ffma" path, 2 captured steps after the warm-up
CR_LAUNCH_ARGS = ["--arch", COMMAND_R, "--quant", "nf4", "--impl", "fused", "--seq", "512",
                  "--ranks", "8,16", "--batch-sizes", "1,1", "--steps", "2", "--log-every", "0"]
# the kernel phase's command-r cases
CR_TRAIN_CASE, CR_DECODE_CASE, CR_LAUNCH_CASE = "train_command_r", "decode_command_r", \
    "launcher_command_r"


def cr_build_check(torch, dev, cfg, mode: str) -> None:
    """The streamed build at full width cut to CR_CHECK_LAYERS layers,
    ``torch.equal`` leaf by leaf to ``quantize_base_params`` of the dense
    init."""
    from repro_torch.kernels.quant import quantize_base_params
    from repro_torch.models.model import init_model
    from repro_torch.tree import tree_leaves

    cut = cfg.replace(n_layers=CR_CHECK_LAYERS)
    got, _ = init_model(SEED, cut, None, dtype=torch.bfloat16, device=dev, quant=mode)
    dense, _ = init_model(SEED, cut, None, dtype=torch.bfloat16, device=dev)
    want = quantize_base_params(dense, mode)
    del dense
    a, b = tree_leaves(got), tree_leaves(want)
    equal = len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
    emit({"phase": "command_r_build_check", "quant": mode, "n_layers": CR_CHECK_LAYERS,
          "leaves": len(a), "equal": equal})
    if not equal:
        fail(f"{COMMAND_R} {mode}: the streamed build at depth {CR_CHECK_LAYERS} differs from "
             "dense-then-quantize")


def cr_build(torch, dev, cfg, mode: str):
    """The full base (40 layers, bf16 embedding) through the streamed
    init, its seconds, resident bytes and own peak held to CR_BUILD_PEAK."""
    from repro_torch.models.model import init_model

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    base, _ = init_model(SEED, cfg, None, dtype=torch.bfloat16, device=dev, quant=mode)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    emit({"phase": "command_r_build", "model": cfg.name, "n_layers": cfg.n_layers,
          "quant": mode, "dtype": "bfloat16", "seconds": time.perf_counter() - t0,
          "resident_bytes": resident_bytes(base), "held_bytes": held,
          "max_memory_allocated": peak, "build_peak_bytes": peak - held,
          "limit_bytes": CR_BUILD_PEAK[mode]})
    if not peak - held <= CR_BUILD_PEAK[mode]:
        fail(f"{cfg.name} {mode}: the streamed build peaked at {peak - held} bytes, over "
             f"{CR_BUILD_PEAK[mode]}")
    return base


def cr_train(torch, dev, cfg, base) -> dict:
    """The train phase's pack on the int8 base under each of CR_TRAIN_IMPLS:
    step 1 against the plain path (``train_run``: loss LOSS_RTOL, f32
    gradients GRAD_TOL_F32), then CR_TRAIN_STEPS steps whose counts must
    move, every fused_matmul_q call on "wgmma" (fused) and every
    packed_matmul call on "mma" (auto); the steps' own peak must lie within
    [1, C3_SLACK] of the port's ``job_mem_bytes`` priced at the tree's
    storage and dense dtype (int8 codes, a bf16 embedding: ROADMAP C6)."""
    from repro_torch.kernels import launches as launch_counts
    from repro_torch.kernels.quant import base_storage
    from repro_torch.sched import H100, CostModel

    _, meta, lora0, batches = train_setup(torch, dev, cfg, TRAIN_SEQ, CR_TRAIN_STEPS)
    storage, dense = base_storage(base, dense=True)
    price = CostModel(cfg, H100, base_dtype=storage, dense_dtype=dense).job_mem_bytes(
        train_setup_configs(), 1, TRAIN_SEQ)
    counts = {}
    for impl in CR_TRAIN_IMPLS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize(dev)
        held = torch.cuda.memory_allocated(dev) - resident_bytes(base) - resident_bytes(lora0)
        row, counts[f"train:{impl}"], state = train_run(
            torch, dev, cfg, meta, lora0, batches, base, impl, quant="int8",
            phase="command_r_train")
        paths = launch_counts.read_paths()
        del state
        own = row["max_memory_allocated"] - held
        emit({"phase": "command_r_train_memory", "impl": impl, "held_bytes": held,
              "job_peak_bytes": own, "job_mem_bytes_int8": price, "price_over_peak": price / own,
              "base_dtype": storage, "dense_dtype": dense, "launches_by_path": paths})
        if not own <= price <= C3_SLACK * own:
            fail(f"C6: {cfg.name} int8 train impl={impl}: job_mem_bytes {price} is not within "
                 f"[peak, {C3_SLACK} x peak] of its own peak {own}")
        kernel, path = ("fused_matmul_q", "wgmma") if impl == "fused" else ("packed_matmul", "mma")
        off = {p: k for p, k in paths[kernel].items() if p != path and k}
        if off or not paths[kernel][path]:
            fail(f"{cfg.name} train impl={impl}: {kernel} calls off the {path} path: "
                 f"{paths[kernel]}")
        if impl == "fused" and any(k for p, k in paths["fused_matmul"].items() if p != "wgmma"):
            fail(f"{cfg.name} train impl=fused: dx calls off the wgmma path: {paths['fused_matmul']}")
    del lora0, batches
    return counts


def cr_serve(torch, dev, cfg, base, mode: str, impls, adapters, lora1s, prompts) -> dict:
    """8 requests through ``ServeEngine(base_dtype=mode)`` under each impl
    (counts zeroed just before each drain and read just after), then
    prefill logits and CR_SERVE_STEPS teacher-forced decode steps held
    against the plain path at LOGIT_TOL. Under "fused", fused_matmul_q must
    launch on "decode" (the decode steps) and on nothing but "decode" and
    "wgmma" (the prefills). Returns each run's counts."""
    from repro_torch.kernels import launches as launch_counts
    from repro_torch.serve.engine import ServeEngine, poisson_requests

    reqs = poisson_requests([f"ad{i}" for i in range(8)], prompts, 2.0,
                            max_new_tokens=CR_SERVE_NEW, seed=SEED)
    smax = (CR_SERVE_PROMPT[1] + CR_SERVE_NEW + 63) // 64 * 64
    counter = {"auto": "packed_matmul", "fused": "fused_matmul_q"}
    out = {}
    for impl in impls:
        eng = ServeEngine(cfg, base, rows=8, smax=smax, r_bucket=16, slot_capacity=8,
                          impl=impl, base_dtype=mode, device=dev)
        for i, (tree, r) in enumerate(adapters):
            eng.publish(f"ad{i}", tree, {"rank": r, "alpha": float(r)})
        zero_counts()
        stats = eng.serve(reqs)
        torch.cuda.synchronize()
        counts, paths = train_counts(), launch_counts.read_paths()
        counts["fused_matmul_q_decode"] = paths["fused_matmul_q"]["decode"]
        out[f"serve:{impl}:{mode}"] = counts
        gate = step_gate(torch, eng, [int(p[-1]) for p in prompts], [len(p) for p in prompts],
                         f"{cfg.name} {mode} serve impl={impl}")
        bad = [r for r in stats.results if r.error is not None or len(r.tokens) != CR_SERVE_NEW]
        toks = np.stack([r.tokens for r in stats.results]) if not bad else np.zeros((0,))
        lat = stats.latency_summaries()
        emit({"phase": "command_r_serve", "model": cfg.name, "quant": mode, "impl": impl,
              "smax": smax, "prompt_tokens": [len(p) for p in prompts],
              "requests": len(stats.results), "tokens": stats.tokens_emitted,
              "steps": stats.steps, "wall_s": stats.wall_seconds,
              "tokens_per_s": stats.tokens_per_s, "ttft_p50_s": lat["ttft"]["p50"],
              "itl_p50_s": lat["itl"]["p50"], "step_host_us_p50": 1e6 * lat["step_host"]["p50"],
              "captures": eng.captures, "step_logits": gate, "launches": counts,
              "launches_by_path": paths})
        del eng
        if counts[counter[impl]] == 0:
            fail(f"{cfg.name} {mode} serve impl={impl}: the {counter[impl]} kernel never launched")
        if impl == "fused":
            off = {p: k for p, k in paths["fused_matmul_q"].items()
                   if p not in ("decode", "wgmma") and k}
            if off or not paths["fused_matmul_q"]["decode"]:
                fail(f"{cfg.name} {mode} serve: fused_matmul_q on {paths['fused_matmul_q']}, "
                     "no decode rows or off the decode and wgmma paths")
        if bad or len(stats.results) != 8:
            fail(f"{cfg.name} {mode} serve impl={impl}: requests failed: "
                 f"{[(r.request_id, r.error) for r in bad]}")
        if toks.min() < 0 or toks.max() >= cfg.vocab_size:
            fail(f"{cfg.name} {mode} serve impl={impl}: token ids outside the vocabulary")
        pimpl = {"auto": "plain", "fused": "fused_plain"}[impl]
        with torch.no_grad():
            per_step, ref_max, per_dec = teacher_forced(
                torch, cfg, base, adapters, prompts, smax, impl, pimpl, counter[impl],
                CR_SERVE_STEPS, lora1s=lora1s)
        rel = max(per_step) / ref_max
        emit({"phase": "command_r_serve_logits", "model": cfg.name, "quant": mode, "impl": impl,
              "plain": pimpl, "decode_steps": CR_SERVE_STEPS,
              "launches_per_decode_step": per_dec, "max_abs_err_prefill": per_step[0],
              "max_abs_err_decode": per_step[1:], "max_abs_logit": ref_max, "rel_err": rel,
              "tol": LOGIT_TOL})
        if not rel <= LOGIT_TOL:
            fail(f"{cfg.name} {mode} impl={impl}: logits differ from {pimpl} by {rel} > "
                 f"{LOGIT_TOL}")
        torch.cuda.empty_cache()
    return out


def launcher_run(torch, dev, argv, ex=None) -> dict:
    """``launch/train.py``'s ``main`` on ``argv`` with a ``launcher_executor``
    (``ex`` when given: its adapters ``w0`` / ``w`` stay the caller's) and
    a ``StepWindow``, the launcher's own ``CostModel`` kept: its losses,
    s/step, capture s, peaks (the device's, and its own: less what was
    allocated before it) beside that model's price, and its counts and
    paths, as one record."""
    from repro_torch.kernels import launches as launch_counts
    from repro_torch.launch import train as launch_train

    cost_model, priced = launch_train.CostModel, []

    def pricing(*args, **kw):
        priced.append(cost_model(*args, **kw))
        return priced[-1]

    ex = ex if ex is not None else launcher_executor()
    win = StepWindow(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    zero_counts()
    launch_train.CostModel = pricing
    t0 = time.perf_counter()
    try:
        per = launch_train.main(argv, executor=ex, step_callback=win)
    finally:
        launch_train.CostModel = cost_model
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    cm = priced[-1]
    price = cm.job_mem_bytes(ex.configs, 1, ex.seq)
    rec = {"args": argv, "per_adapter_loss": np.asarray(per, dtype=np.float64).tolist(),
           "step_s": win.seconds, "s_per_step": sum(win.seconds) / max(len(win.seconds), 1),
           "capture_s": ex.captures[-1]["seconds"] if ex.captures else None, "wall_s": wall,
           "held_bytes": held, "max_memory_allocated": peak, "job_peak_bytes": peak - held,
           "priced_base_dtype": cm.base_dtype, "priced_dense_dtype": cm.dense_dtype,
           "job_mem_bytes": price, "price_over_peak": price / (peak - held),
           "launches": launch_counts.read(), "launches_by_path": launch_counts.read_paths()}
    ex.clear()
    return rec


def cr_launcher(torch, dev, out_dir: Path) -> dict:
    """``launch/train.py`` with CR_LAUNCH_ARGS: the nf4 base built layer by
    layer under an f32 x. Losses finite, every fused_matmul_q call and every
    dx on "ffma"; its own peak within [1, C3_SLACK] of the price of the
    launcher's own ``CostModel`` (base_dtype "nf4" with dense_dtype "f32":
    ROADMAP C6). Returns its counts."""
    rec = launcher_run(torch, dev, CR_LAUNCH_ARGS)
    emit({"phase": "command_r_launcher", "x_dtype": "float32", **rec})
    losses, peak, price = rec["per_adapter_loss"], rec["job_peak_bytes"], rec["job_mem_bytes"]
    if not np.isfinite(losses).all():
        fail(f"{COMMAND_R} launcher: non-finite final loss {losses}")
    if not peak <= price <= C3_SLACK * peak:
        fail(f"C6: {COMMAND_R} launcher: job_mem_bytes {price} is not within "
             f"[peak, {C3_SLACK} x peak] of its own peak {peak}")
    for kernel in ("fused_matmul_q", "fused_matmul"):
        on = rec["launches_by_path"][kernel]
        off = {p: k for p, k in on.items() if p != "ffma" and k}
        if off or not on["ffma"]:
            fail(f"{COMMAND_R} launcher: f32 {kernel} calls off the ffma path: {on}")
    return rec["launches"]


def command_r_phase(torch, dev, out_dir: Path) -> dict:
    """command-r-35b at full width and depth, with no earlier base
    resident: the streamed builds (depth-2 checks, then the int8 base),
    train and serve on int8, the nf4 base and its serve run, then the
    launcher on nf4 with an f32 x. Returns the launch counts by run."""
    from repro_torch.configs import get_config

    cfg = get_config(COMMAND_R)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    emit({"phase": "command_r_setup", "model": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
          "allocated_bytes": torch.cuda.memory_allocated(dev)})
    t0 = time.perf_counter()
    for mode in ("int8", "nf4"):
        cr_build_check(torch, dev, cfg, mode)
    counts = {}
    base = cr_build(torch, dev, cfg, "int8")
    emit({"phase": "command_r_stage", "stage": "build", "seconds": time.perf_counter() - t0})
    t1 = time.perf_counter()
    counts.update(cr_train(torch, dev, cfg, base))
    emit({"phase": "command_r_stage", "stage": "train", "seconds": time.perf_counter() - t1})
    t1 = time.perf_counter()
    adapters = make_adapters(torch, cfg, 8, device=dev)
    lora1s = row_adapters(torch, cfg, adapters, dev)
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(0, cfg.vocab_size, size=rng.randint(*CR_SERVE_PROMPT)).astype(np.int32)
               for _ in range(8)]
    counts.update(cr_serve(torch, dev, cfg, base, "int8",
                           [impl for mode, impl in CR_SERVE_RUNS if mode == "int8"],
                           adapters, lora1s, prompts))
    del base
    base = cr_build(torch, dev, cfg, "nf4")
    counts.update(cr_serve(torch, dev, cfg, base, "nf4",
                           [impl for mode, impl in CR_SERVE_RUNS if mode == "nf4"],
                           adapters, lora1s, prompts))
    del base, lora1s, adapters
    emit({"phase": "command_r_stage", "stage": "serve", "seconds": time.perf_counter() - t1})
    t1 = time.perf_counter()
    counts["launcher:fused"] = cr_launcher(torch, dev, out_dir)
    emit({"phase": "command_r_stage", "stage": "launcher", "seconds": time.perf_counter() - t1})
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# moe phase: qwen3-moe-30b-a3b at full width and depth on a bf16 base
# ---------------------------------------------------------------------------

# qwen3-moe-30b-a3b (hf:Qwen/Qwen3-30B-A3B as the reference models it: 48
# layers, d 2,048, GQA 32/4 of 128, 128 experts of d_ff 768, top-8 on every
# layer, capacity factor 1.25, vocab 151,936, untied): 30.53 B parameters,
# 61.06 GB of bf16 (the experts 29.0 B), built by ``init_model`` on the card
# from SEED right after the command_r phase, with nothing else resident.
MOE_TRAIN_STEPS = 2
# the train phase's pack (8 padded rows) at 256 tokens: the CE's backward
# takes ~0.87 GB a row at 256 (1.75 at 512), which with the 61 GB base and
# step 1's f32 copy of MOE_F32_LAYERS layers (2.4 GB each, with the f32
# embedding and head 7.4 GB) keeps the comparison near 77 GB of the 80
MOE_TRAIN_SEQ = 256
# step 1's f32 comparison runs on a view of the first MOE_F32_LAYERS layers:
# the whole base in f32 would be 122 GB
MOE_F32_LAYERS = 2
# the "ep" path against the dense oracle on one full-width layer: this many
# tokens, at a capacity factor of E / top_k (nothing dropped); f32 within
# KERNEL_TOL's f32 limit of max |y|, bf16 within MOE_ORACLE_BF16
MOE_ORACLE_TOKENS = 384
MOE_ORACLE_BF16 = 2e-2


def moe_oracle(torch, dev, cfg, base) -> None:
    """The "ep" path equals ``_moe_dense`` on layer 0's experts at full
    width (MOE_ORACLE_TOKENS tokens of N(0, 1), capacity factor E / top_k:
    every pair kept), in f32 and in bf16; the same routing on both."""
    from repro_torch.models.layers import moe as tmoe
    from repro_torch.tree import tree_index, tree_map

    mcfg = dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)
    t = MOE_ORACLE_TOKENS
    cap = tmoe.moe_capacity(t, mcfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    x = torch.randn((t, cfg.d_model), generator=gen, device=dev)
    layer = tree_index(base["decoder"]["blocks"]["l0"]["moe"], 0)
    out = {"phase": "moe_oracle", "model": cfg.name, "tokens": t, "capacity": cap,
           "capacity_factor": mcfg.capacity_factor}
    with torch.no_grad():
        for name, dtype, tol in (("f32", torch.float32, KERNEL_TOL["float32"]),
                                 ("bf16", torch.bfloat16, MOE_ORACLE_BF16)):
            p = tree_map(lambda w: w.to(dtype) if w.dim() == 3 else w, layer)
            xd = x.to(dtype)
            y_ep, a_ep = tmoe._moe_ep_local(p, xd, mcfg, 0, mcfg.n_experts, cap)
            y_dn, a_dn = tmoe._moe_dense(p, xd, mcfg)
            err = (y_ep.float() - y_dn.float()).abs().max().item()
            scale = y_dn.float().abs().max().item()
            out[name] = {"max_abs_err": err, "max_abs_y": scale, "rel_err": err / scale,
                         "tol": tol, "aux_ep": a_ep.item(), "aux_dense": a_dn.item()}
            if not (math.isfinite(err) and err <= tol * scale and a_ep.item() == a_dn.item()):
                emit(out)
                fail(f"{cfg.name}: the ep path differs from the dense oracle in {name}: "
                     f"{err} > {tol} x {scale}, aux {a_ep.item()} / {a_dn.item()}")
            del p, y_ep, y_dn
    emit(out)


def moe_routes(torch, cfg, base, lora, batch, meta):
    """One no-grad forward of the pack under impl="auto" and one on the
    plain path, the routing recorded: each MoE layer's top-k ``idx`` and
    its dispatch (``dispatch_plan``). Returns the share of (token, expert)
    pairs dropped per layer and per pack row (the config's capacity
    factor, "auto"), and per layer the share of the kernel path's top-k
    choices that the plain path also made."""
    from repro_torch.kernels.ops import KernelConfig
    from repro_torch.models import model as tmodel
    from repro_torch.models.layers import moe as tmoe

    impls = ("auto", "plain")
    router, plan_fn = tmoe._router, tmoe.dispatch_plan
    routes, kept = {}, []

    def rec_router(x, params, mcfg):
        out = router(x, params, mcfg)
        routes[cur].append(out[1])
        return out

    def rec_plan(idx, n_experts, capacity, *a):
        out = plan_fn(idx, n_experts, capacity, *a)
        if cur == impls[0]:
            kept.append((out[0] < n_experts * capacity).view(idx.shape))
        return out

    tmoe._router, tmoe.dispatch_plan = rec_router, rec_plan
    try:
        with torch.no_grad():
            for cur in impls:
                routes[cur] = []
                tmodel.forward(base, lora, meta.scales(batch["tokens"].device), batch, cfg,
                               n_pack=meta.n, kcfg=KernelConfig(impl=cur, ranks=meta.ranks))
    finally:
        tmoe._router, tmoe.dispatch_plan = router, plan_fn
    nb, s = batch["tokens"].shape
    k = cfg.moe.top_k
    dropped = [1.0 - kp.float().mean().item() for kp in kept]
    by_row = torch.stack([1.0 - kp.float().view(nb, s * k).mean(1) for kp in kept]).mean(0)

    def agree(a, b):  # the share of a's top-k choices that b also made
        return (a[:, :, None] == b[:, None, :]).any(-1).float().mean().item()

    same = {other: [agree(a, b) for a, b in zip(routes[impls[0]], routes[other])]
            for other in impls[1:]}
    return {"dropped_share_by_layer": dropped, "dropped_share": sum(dropped) / len(dropped),
            "dropped_share_by_row": by_row.tolist(), "topk_agreement_by_layer": same,
            "topk_agreement_min": {o: min(v) for o, v in same.items()}}


def moe_phase(torch, dev, out_dir: Path) -> dict:
    """qwen3-moe-30b-a3b at full width and depth on a bf16 base (61.06 GB)
    built by ``init_model`` on the card: the oracle check (``moe_oracle``);
    ``make_packed_step`` under impl="auto" and "fused" on the train phase's
    pack at MOE_TRAIN_SEQ (step 1 against the plain path: loss LOSS_RTOL in bf16 at 48
    layers, f32 gradients GRAD_TOL_F32 on the first MOE_F32_LAYERS; then
    MOE_TRAIN_STEPS steps whose counts must move); the routing of the pack
    (``moe_routes``: the pairs dropped at capacity factor 1.25, by layer and
    by row; the top-k agreement of the kernel and plain paths, by layer); a
    ``make_train_step`` call with no host wait (on MOE_F32_LAYERS layers);
    8 requests through ``ServeEngine.serve`` under auto and fused with the
    logits of prefill and teacher-forced decode steps held against the
    plain path at LOGIT_TOL; one captured sweep job of FAMILY_SWEEP_IDS
    (``family_sweep``: equal to eager, launches, its own peak held to C3)
    at 48 layers. Returns the launch counts by run."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_model
    from repro_torch.train.optimizer import init_opt_state

    cfg = get_config(MOE)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    base, _ = init_model(SEED, cfg, None, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize(dev)
    emit({"phase": "moe_setup", "model": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "n_experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
          "d_expert": cfg.moe.d_expert, "capacity_factor": cfg.moe.capacity_factor,
          "vocab": cfg.vocab_size, "dtype": "bfloat16", "init_s": time.perf_counter() - t0,
          "resident_bytes": resident_bytes(base), "held_bytes": held,
          "build_peak_bytes": torch.cuda.max_memory_allocated(dev) - held})
    counts, stages, lap = {}, {}, time.perf_counter()

    def stage(name):  # the seconds since the last stage ended
        nonlocal lap
        stages[name], lap = time.perf_counter() - lap, time.perf_counter()

    moe_oracle(torch, dev, cfg, base)
    stage("oracle")
    _, meta, lora0, batches = train_setup(torch, dev, cfg, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS)
    routes = moe_routes(torch, cfg, base, lora0, batches[0], meta)
    emit({"phase": "moe_routes", "model": cfg.name, "rows": meta.n * meta.max_batch,
          "seq": MOE_TRAIN_SEQ, "capacity_factor": cfg.moe.capacity_factor, **routes})
    stage("routes")
    for impl in FAMILY_TRAIN_IMPLS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize(dev)
        row, counts[f"train:{impl}"], state = train_run(
            torch, dev, cfg, meta, lora0, batches, base, impl, phase="moe_train",
            f32_layers=MOE_F32_LAYERS)
        del state
    cut, cut_base = depth_cut(cfg, base, MOE_F32_LAYERS)
    cut_lora = depth_cut_lora(cfg, lora0, MOE_F32_LAYERS)
    sync_free_train_step(torch, cut, meta, cut_base, cut_lora, init_opt_state(cut_lora),
                         batches[0], "auto")
    del lora0, batches, cut_base, cut_lora
    torch.cuda.empty_cache()
    stage("train")
    for impl, c in family_serve(torch, dev, MOE, cfg, base).items():
        counts[f"serve:{impl}"] = c
    stage("serve")
    counts["sweep:auto"] = family_sweep(torch, dev, cfg, base, out_dir)
    stage("sweep")
    emit({"phase": "moe_done", "model": MOE, "stages_s": stages})
    del base
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# jamba phase: jamba-v0.1-52b, the hybrid, at full width on one whole period
# ---------------------------------------------------------------------------

# jamba-v0.1-52b (arXiv:2403.19887 as the reference models it: 32 layers, d
# 4,096, GQA 32/8 of 128 on layers 3, 11, 19 and 27, SSD (expand 2, heads of
# 64, d_state 16, chunks of 256) on the other 28, 16 experts of d_ff 14,336
# with top-2 on the odd layers, a dense SwiGLU of 14,336 on the even ones,
# vocab 65,536): 51.46 B parameters, 102.9 GB of bf16, ~97 GB as int8 (the
# quantizer leaves the experts dense), so one card holds neither. Its layer
# pattern repeats every 8 layers, and layers 0-7 hold every kind of layer it
# has (1 attention and 7 SSD mixers, 4 MoE and 4 dense FFNs): the phase runs
# that one whole period, JAMBA_LAYERS, at full width (13.27 B parameters,
# 26.53 GB of bf16), built by ``init_model`` on the card from SEED right
# after the moe phase, with nothing else resident. (Alone, those 8 layers
# have a least period of 6, so their stack is a checkpointed block of 6 and
# an unchecked remainder of 2, as the reference would group them.)
JAMBA_LAYERS = 8
JAMBA_TRAIN_STEPS = 2
# the train phase's pack (8 padded rows) at 512 tokens: the CE's backward
# takes ~0.72 GB a row at vocab 65,536
JAMBA_TRAIN_SEQ = 512
# step 1's f32 comparison on a view of the first JAMBA_F32_LAYERS layers (SSD
# + dense, SSD + MoE, SSD + dense, attention + MoE: 6.87 B parameters, 27.5
# GB of f32 beside the bf16 base)
JAMBA_F32_LAYERS = 4


def jamba_phase(torch, dev, out_dir: Path) -> dict:
    """jamba-v0.1-52b at full width on its first JAMBA_LAYERS layers (one
    whole period) on a bf16 base built by ``init_model`` on the card:
    ``make_packed_step`` under impl="auto" and "fused" on the train phase's
    pack at JAMBA_TRAIN_SEQ with the aux loss (step 1 against the plain
    path: the bf16 loss at LOSS_RTOL on all 8 layers, the f32 gradients at
    GRAD_TOL_F32 on the first JAMBA_F32_LAYERS; then JAMBA_TRAIN_STEPS
    steps whose counts must move); the pack's routing (``moe_routes``: the
    pairs dropped at capacity factor 1.25 by MoE layer and by row, the
    top-2 agreement of the kernel and plain paths); a ``make_train_step``
    call with no host wait; 8 requests through ``ServeEngine.serve`` under
    auto and fused (prompts of 200-600 tokens) with prefill and
    teacher-forced decode logits held against the plain path at
    LOGIT_TOL; one captured sweep job of FAMILY_SWEEP_IDS
    (``family_sweep``: equal to eager, launches, extract -> inject, its own
    peak held to C3). Returns the launch counts by run."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_model
    from repro_torch.sched.cost_model import model_param_count
    from repro_torch.train.optimizer import init_opt_state

    cfg = get_config(JAMBA).replace(n_layers=JAMBA_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    base, _ = init_model(SEED, cfg, None, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize(dev)
    emit({"phase": "jamba_setup", "model": cfg.name, "n_layers": cfg.n_layers,
          "of_layers": get_config(JAMBA).n_layers, "layer_kinds": list(cfg.layer_kinds()),
          "ffn_kinds": list(cfg.ffn_kinds()), "d_model": cfg.d_model,
          "n_experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
          "capacity_factor": cfg.moe.capacity_factor, "vocab": cfg.vocab_size,
          "params": model_param_count(cfg), "dtype": "bfloat16",
          "init_s": time.perf_counter() - t0, "resident_bytes": resident_bytes(base),
          "held_bytes": held, "build_peak_bytes": torch.cuda.max_memory_allocated(dev) - held})
    counts, stages, lap = {}, {}, time.perf_counter()

    def stage(name):  # the seconds since the last stage ended
        nonlocal lap
        stages[name], lap = time.perf_counter() - lap, time.perf_counter()

    _, meta, lora0, batches = train_setup(torch, dev, cfg, JAMBA_TRAIN_SEQ, JAMBA_TRAIN_STEPS)
    routes = moe_routes(torch, cfg, base, lora0, batches[0], meta)
    emit({"phase": "jamba_routes", "model": cfg.name, "rows": meta.n * meta.max_batch,
          "seq": JAMBA_TRAIN_SEQ, "capacity_factor": cfg.moe.capacity_factor,
          "moe_layers": [i for i, f in enumerate(cfg.ffn_kinds()) if f == "moe"], **routes})
    stage("routes")
    for impl in FAMILY_TRAIN_IMPLS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize(dev)
        _, counts[f"train:{impl}"], state = train_run(
            torch, dev, cfg, meta, lora0, batches, base, impl, phase="jamba_train",
            f32_layers=JAMBA_F32_LAYERS)
        del state
    torch.cuda.empty_cache()
    sync_free_train_step(torch, cfg, meta, base, lora0, init_opt_state(lora0), batches[0],
                         "auto")
    del lora0, batches
    torch.cuda.empty_cache()
    stage("train")
    for impl, c in family_serve(torch, dev, JAMBA, cfg, base).items():
        counts[f"serve:{impl}"] = c
    stage("serve")
    counts["sweep:auto"] = family_sweep(torch, dev, cfg, base, out_dir)
    stage("sweep")
    emit({"phase": "jamba_done", "model": JAMBA, "stages_s": stages})
    del base
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def ptxas_entries(log: str, name: str):
    """``nvcc -Xptxas -v``'s lines for each compiled kernel whose mangled
    name contains ``name``: registers, static shared memory (the wgmma
    kernel's ring is dynamic: ``WgCfg::SMEM`` in fused.cuh), stack and
    spills."""
    out, cur = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = {"entry": ln.split("'")[1]} if name in ln else None
            if cur is not None:
                out.append(cur)
        elif cur is not None and ("spill" in ln or "Used" in ln):
            cur.setdefault("ptxas", []).append(ln.split(":", 1)[-1].strip())
    return out


CSRC = "src/repro_torch/kernels/csrc/"
# (entry, kernel, the kernel-phase calls it sums, case, source, replaces,
#  where its launches come from: (path, run, count)[, dtype: bf16 if absent])
USES = [
    ("packed_matmul", "packed_matmul", ("xA", "xAB"), "decode",
     "packed_matmul.cu", "src/repro/kernels/packed_matmul.py:89",
     ("serve", "auto", "packed_matmul")),
    ("fused_matmul", "fused_matmul", ("fused",), "decode",
     "fused.cu", "src/repro/kernels/fused.py:275", ("serve", "fused", "fused_matmul")),
    # the same decode rows in qwen25-7b's captured greedy drains at 28
    # layers (serve_captured): each replay adds what its graph recorded
    ("packed_matmul:decode_captured", "packed_matmul", ("xA", "xAB"), "decode",
     "packed_matmul.cu", "src/repro/kernels/packed_matmul.py:89",
     ("serve_captured", "auto", "packed_matmul")),
    ("fused_matmul:decode_captured", "fused_matmul", ("fused",), "decode",
     "fused.cu", "src/repro/kernels/fused.py:275", ("serve_captured", "fused", "fused_matmul")),
    # the tune_serve drains' decode steps (8 rows at r = 128, the sweep's
    # pool served at its rank bucket): launches on "decode" in each impl's
    # mixed drain
    ("packed_matmul:decode_r128", "packed_matmul", ("xA", "xAB"), TS_CASE,
     "packed_matmul.cu", "src/repro/kernels/packed_matmul.py:89",
     ("tune_serve", "auto", "packed_matmul")),
    ("fused_matmul:decode_r128", "fused_matmul", ("fused",), TS_CASE,
     "fused.cu", "src/repro/kernels/fused.py:275", ("tune_serve", "fused", "fused_matmul")),
    # one prefill chunk's calls (N = 1 x M = CHUNK), launched at chunk rows in
    # the serve phase's chunked drains
    ("packed_matmul:prefill_chunk", "packed_matmul", ("xA", "xAB"), "chunk",
     "packed_matmul.cu", "src/repro/kernels/packed_matmul.py:89",
     ("serve", "chunked:auto", "packed_matmul:mma")),
    ("fused_matmul:prefill_chunk", "fused_matmul", ("fused",), "chunk",
     "fused.cu", "src/repro/kernels/fused.py:275",
     ("serve", "chunked:fused", "fused_matmul:wgmma")),
    ("packed_matmul:train_forward", "packed_matmul", ("xA", "xAB"), "train",
     "packed_matmul.cu", "src/repro/kernels/packed_matmul.py:89",
     ("train", "auto", "packed_matmul")),
    # the N-D backward branch that training runs: cases 2 and 4
    ("packed_matmul:train_backward", "packed_matmul", ("bwd2_dxA", "bwd4_dx"), "train",
     "packed_matmul.cu", "src/repro/kernels/packed_matmul.py:89 (ops.py:238-242)",
     ("train", "auto", "packed_matmul_bwd")),
    ("fused_matmul:train_forward", "fused_matmul", ("fused",), "train",
     "fused.cu", "src/repro/kernels/fused.py:275", ("train", "fused", "fused_matmul")),
    ("fused_matmul:train_dx", "fused_matmul", ("dx",), "train",
     "fused.cu", "src/repro/kernels/fused.py:275 (fused.py:389-401)",
     ("train", "fused", "fused_matmul_dx")),
    ("fused_matmul_q:int8", "fused_matmul_q", ("int8",), "train",
     "fused_q.cu", "src/repro/kernels/fused.py:275 (_fused_kernel_q :133, _dequant_tile :107)",
     ("train", "fused+int8", "fused_matmul_q")),
    ("fused_matmul_q:nf4", "fused_matmul_q", ("nf4",), "train",
     "fused_q.cu", "src/repro/kernels/fused.py:275 (_fused_kernel_q :133, _dequant_tile :107)",
     ("train", "fused+nf4", "fused_matmul_q")),
    # the sweep's captured steps (impl="auto"), at the sweep's own shapes:
    # launches of each job's eager warm-up step and of its replays (each
    # replay adds what its graph recorded)
    ("packed_matmul:sweep_forward", "packed_matmul", ("xA", "xAB"), "sweep",
     "packed_matmul.cu", "src/repro/kernels/packed_matmul.py:89",
     ("sweep", "auto", "packed_matmul")),
    ("packed_matmul:sweep_backward", "packed_matmul", ("bwd2_dxA", "bwd4_dx"), "sweep",
     "packed_matmul.cu", "src/repro/kernels/packed_matmul.py:89 (ops.py:238-242)",
     ("sweep", "auto", "packed_matmul_bwd")),
    # the multihost phase's captured steps in the workers (impl="auto"), at
    # its jobs' shapes: the kill run's launches, each worker's sent back
    # with its segments (a warm-up step and 4 replays a job)
    ("packed_matmul:multihost_forward", "packed_matmul", ("xA", "xAB"), "multihost",
     "packed_matmul.cu", "src/repro/kernels/packed_matmul.py:89",
     ("multihost", "auto", "packed_matmul")),
    ("packed_matmul:multihost_backward", "packed_matmul", ("bwd2_dxA", "bwd4_dx"), "multihost",
     "packed_matmul.cu", "src/repro/kernels/packed_matmul.py:89 (ops.py:238-242)",
     ("multihost", "auto", "packed_matmul_bwd")),
    # the online phase's captured steps (run_online_local, impl="auto"), at
    # the online plan's shapes: warm-up steps and replays, as the sweep's
    ("packed_matmul:online_forward", "packed_matmul", ("xA", "xAB"), "online",
     "packed_matmul.cu", "src/repro/kernels/packed_matmul.py:89",
     ("online", "auto", "packed_matmul")),
    ("packed_matmul:online_backward", "packed_matmul", ("bwd2_dxA", "bwd4_dx"), "online",
     "packed_matmul.cu", "src/repro/kernels/packed_matmul.py:89 (ops.py:238-242)",
     ("online", "auto", "packed_matmul_bwd")),
    # the launcher on its f32 base, at its own shapes (launcher_segments:
    # N = 1 x M = 1,024 at r = 8 and at r = 16): #1 on "f32skinny" (--impl
    # auto), #2 on "ffma" (--impl fused: forward and recompute, and dx)
    ("packed_matmul:train_forward_f32", "packed_matmul", ("xA", "xAB"), "launcher",
     "fskinny.cuh", "src/repro/kernels/packed_matmul.py:89",
     ("launcher", "auto", "packed_matmul"), "float32"),
    ("packed_matmul:train_backward_f32", "packed_matmul", ("bwd2_dxA", "bwd4_dx"), "launcher",
     "fskinny.cuh", "src/repro/kernels/packed_matmul.py:89 (ops.py:238-242)",
     ("launcher", "auto", "packed_matmul_bwd"), "float32"),
    ("fused_matmul:train_forward_f32", "fused_matmul", ("fused",), "launcher",
     "fused.cu", "src/repro/kernels/fused.py:275", ("launcher", "fused", "fused_matmul"),
     "float32"),
    ("fused_matmul:train_dx_f32", "fused_matmul", ("dx",), "launcher",
     "fused.cu", "src/repro/kernels/fused.py:275 (fused.py:389-401)",
     ("launcher", "fused", "fused_matmul_dx"), "float32"),
]
# the families phase's runs (families_phase: counts by family, then
# "train:<impl>" / "serve:<impl>"), at each family's shapes in the kernel
# phase: the train step's calls of #1 and #2 (N = 2 x M = 1,024, r = 16),
# and gemma3's decode rows (serve)
_TAGS = {None: "", "ssm": "_ssd", "attn": "_attn", "encoder": "_enc"}
for _arch, _mixer, _case in family_cases("train"):
    _tag = _arch.split("-")[0] + _TAGS[_mixer]
    USES += [
        (f"packed_matmul:{_tag}_train_forward", "packed_matmul", ("xA", "xAB"), _case,
         "packed_matmul.cu", "src/repro/kernels/packed_matmul.py:89",
         (_arch, "train:auto", "packed_matmul")),
        (f"packed_matmul:{_tag}_train_backward", "packed_matmul", ("bwd2_dxA", "bwd4_dx"), _case,
         "packed_matmul.cu", "src/repro/kernels/packed_matmul.py:89 (ops.py:238-242)",
         (_arch, "train:auto", "packed_matmul_bwd")),
        (f"fused_matmul:{_tag}_train_forward", "fused_matmul", ("fused",), _case,
         "fused.cu", "src/repro/kernels/fused.py:275", (_arch, "train:fused", "fused_matmul")),
        (f"fused_matmul:{_tag}_train_dx", "fused_matmul", ("dx",), _case,
         "fused.cu", "src/repro/kernels/fused.py:275 (fused.py:389-401)",
         (_arch, "train:fused", "fused_matmul_dx")),
    ]
for _arch, _mixer, _case in family_cases("decode"):
    _tag = _arch.split("-")[0] + _TAGS[_mixer]
    USES += [
        (f"packed_matmul:{_tag}_decode", "packed_matmul", ("xA", "xAB"), _case,
         "packed_matmul.cu", "src/repro/kernels/packed_matmul.py:89",
         (_arch, "serve:auto", "packed_matmul")),
        (f"fused_matmul:{_tag}_decode", "fused_matmul", ("fused",), _case,
         "fused.cu", "src/repro/kernels/fused.py:275", (_arch, "serve:fused", "fused_matmul")),
    ]

# command-r-35b's quantized base (command_r_phase: its runs' counts; the
# decode entries count fused_matmul_q's launches on "decode" alone)
_Q = "src/repro/kernels/fused.py:275 (_fused_kernel_q :133, _dequant_tile :107)"
USES += [
    ("fused_matmul_q:command_r_train_int8", "fused_matmul_q", ("int8",), CR_TRAIN_CASE,
     "fused_q.cu", _Q, (COMMAND_R, "train:fused", "fused_matmul_q")),
    ("fused_matmul:command_r_train_dx", "fused_matmul", ("dx",), CR_TRAIN_CASE,
     "fused.cu", "src/repro/kernels/fused.py:275 (fused.py:389-401)",
     (COMMAND_R, "train:fused", "fused_matmul_dx")),
    ("fused_matmul_q:command_r_decode_int8", "fused_matmul_q", ("int8",), CR_DECODE_CASE,
     "fused_q.cu", _Q, (COMMAND_R, "serve:fused:int8", "fused_matmul_q_decode")),
    ("fused_matmul_q:command_r_decode_nf4", "fused_matmul_q", ("nf4",), CR_DECODE_CASE,
     "fused_q.cu", _Q, (COMMAND_R, "serve:fused:nf4", "fused_matmul_q_decode")),
    ("fused_matmul_q:command_r_launcher_nf4_f32", "fused_matmul_q", ("nf4",), CR_LAUNCH_CASE,
     "fused_q.cu", _Q, (COMMAND_R, "launcher:fused", "fused_matmul_q"), "float32"),
]


# uses with layer sums but no entry in the kernels line: fused_matmul_q at
# qwen25-7b's decode rows and on an f32 x at its widths (the main paths run
# them at command-r-35b's: the entries above),
# packed_matmul's decode pair (the serve entry's kernels, launched by one
# call), and #1/#2 in f32 at the training shapes (N = 2 x M = 1,024, r = 16:
# the bf16 train entries' shapes)
EXTRA_SUMS = [("fused_matmul_q:decode_int8", "fused_matmul_q", ("int8",), "decode"),
              ("fused_matmul_q:decode_nf4", "fused_matmul_q", ("nf4",), "decode"),
              # the delta's two decode passes as one packed_matmul_pair call, which serve runs
              ("packed_matmul:decode_pair", "packed_matmul", ("pair",), "decode"),
              ("packed_matmul:decode_r128_pair", "packed_matmul", ("pair",), TS_CASE),
              ("packed_matmul:gemma3_decode_pair", "packed_matmul", ("pair",), "decode_gemma3"),
              ("packed_matmul:minicpm3_decode_pair", "packed_matmul", ("pair",),
               "decode_minicpm3"),
              ("packed_matmul:mamba2_decode_pair", "packed_matmul", ("pair",), "decode_mamba2"),
              ("packed_matmul:qwen3_decode_pair", "packed_matmul", ("pair",),
               "decode_qwen3_moe"),
              ("packed_matmul:jamba_ssd_decode_pair", "packed_matmul", ("pair",),
               "decode_jamba_ssd"),
              ("packed_matmul:jamba_attn_decode_pair", "packed_matmul", ("pair",),
               "decode_jamba_attn"),
              ("packed_matmul:whisper_decode_pair", "packed_matmul", ("pair",),
               "decode_whisper"),
              ("packed_matmul:internvl2_decode_pair", "packed_matmul", ("pair",),
               "decode_internvl2"),
              # fused_matmul_q on an f32 x (the launcher's --quant ... --impl fused)
              ("fused_matmul_q:int8_f32", "fused_matmul_q", ("int8",), "train", "float32"),
              ("fused_matmul_q:nf4_f32", "fused_matmul_q", ("nf4",), "train", "float32"),
              ("fused_matmul:train_case_forward_f32", "fused_matmul", ("fused",), "train",
               "float32"),
              ("fused_matmul:train_case_dx_f32", "fused_matmul", ("dx",), "train", "float32"),
              ("packed_matmul:train_case_forward_f32", "packed_matmul", ("xA", "xAB"), "train",
               "float32"),
              ("packed_matmul:train_case_backward_f32", "packed_matmul", ("bwd2_dxA", "bwd4_dx"),
               "train", "float32")]


def layer_sums(rows, kernel, calls, case, dtype="bfloat16"):
    """A use's rows of ``dtype`` and their times summed over one decoder
    layer's projections, weighted by their count per layer."""
    mult = dict(case_proj(case))
    sel = [r for r in rows if r["kernel"] == kernel and r["case"] == case
           and r["call"] in calls and r["dtype"] == dtype]
    keys = [k for k in ("ms", "plain_ms", "library_ms", "bytes", "flops", "device_ms",
                        "library_device_ms", "host_us", "library_host_us")
            if all(k in r for r in sel)]
    return sel, {k: sum(mult[(r["d_in"], r["d_out"])] * r[k] for r in sel) for k in keys}


def summarize(rows, launches):
    """One entry per kernel and use: its times (bf16, or the use's dtype)
    summed over one decoder layer's projections (weighted by their count per
    layer) -- of a decode step for the serve entries, of a training step's
    calls at N=2, M=1024, r=16 for the train ones, of one step of each sweep
    or online job, or of the launcher's pack (every same-rank segment at its
    own N, M and r) for the sweep, online and f32 ones -- and its launches
    in its path's run. For every use, and for EXTRA_SUMS, it also emits
    those layer sums with the device and host times (a ``layer_sums``
    record)."""
    out = []
    for entry, kernel, calls, case, *dtype in EXTRA_SUMS:
        dtype = dtype[0] if dtype else "bfloat16"
        sel, tot = layer_sums(rows, kernel, calls, case, dtype)
        emit({"phase": "layer_sums", "use": entry, "dtype": dtype,
              "bound_ms": bound(tot["bytes"], tot["flops"], dtype)[0],
              "paths": sorted({r.get("path", "") for r in sel}),
              **{k: v for k, v in tot.items() if k not in ("bytes", "flops")}})
    for entry, kernel, calls, case, source, replaces, (path, run, count), *dtype in USES:
        dtype = dtype[0] if dtype else "bfloat16"
        sel, tot = layer_sums(rows, kernel, calls, case, dtype)
        b_ms, b_by, _, _ = bound(tot["bytes"], tot["flops"], dtype)
        emit({"phase": "layer_sums", "use": entry, "dtype": dtype, "bound_ms": b_ms,
              "paths": sorted({r.get("path", "") for r in sel}),
              **{k: v for k, v in tot.items() if k not in ("bytes", "flops")}})
        out.append({"name": entry, "route": "cuda", "source": CSRC + source, "replaces": replaces,
                    "launches": launches[path][run][count],
                    "max_abs_err": max(r["max_abs_err"] for r in sel),
                    "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": tot["library_ms"]})
        if case in (FAMILY_TRAIN_CASE["minicpm3-4b"], FAMILY_DECODE_CASE["minicpm3-4b"]):
            # the use's kv_a call alone (L = 288; the dx's K = 288), beside its layer
            for r in sel:
                if (r["d_in"], r["d_out"]) == KV_A:
                    emit({"phase": "kv_a", "use": entry, "call": r["call"], "path": r.get("path"),
                          "max_abs_err": r["max_abs_err"], "tol": r["tol"],
                          "device_ms": r["device_ms"],
                          "library_device_ms": r["library_device_ms"],
                          "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                          "host_us": r["host_us"], "library_host_us": r["library_host_us"],
                          "ms": r["ms"], "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
                          "layer_device_ms": tot["device_ms"]})
    return {"kernels": out}


def main() -> None:
    if len(sys.argv) > 1:
        fail(f"takes no arguments, got {sys.argv[1:]}")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail("src/repro_torch not found next to chip_smoke.py: run it from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs an NVIDIA GPU")
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi.stdout.strip().splitlines()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda})

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    try:
        libs = _build.build_all()
    except RuntimeError as e:
        fail(str(e))
    out_dir = ROOT / "smoke_out"
    out_dir.mkdir(exist_ok=True)
    spills = {}
    for lib in libs:  # ptxas: registers and spills of every kernel
        log = lib.with_suffix(".log")
        if log.exists():
            (out_dir / f"nvcc_{lib.stem}.log").write_text(log.read_text())
            spills[lib.stem] = [ln.strip() for ln in log.read_text().splitlines()
                                if "spill" in ln and not ln.strip().startswith("0 bytes")]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "libs": [p.name for p in libs],
          "spill_lines": spills})
    for lib in libs:
        log = lib.with_suffix(".log")
        if log.exists():
            for kernel in ("fused_wgmma_kernel", "decode_kernel", "fused_ffma_kernel",
                           "f32_narrow_kernel", "f32_short_k_kernel"):
                for entry in ptxas_entries(log.read_text(), kernel):
                    emit({"phase": "ptxas", "lib": lib.stem, **entry})

    t0 = time.perf_counter()
    rows = kernel_phase(torch, dev)
    emit({"phase": "kernels_done", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    command_r_launches = command_r_phase(torch, dev, out_dir)
    emit({"phase": "command_r_done", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    moe_launches = moe_phase(torch, dev, out_dir)
    emit({"phase": "moe_phase_done", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    jamba_launches = jamba_phase(torch, dev, out_dir)
    emit({"phase": "jamba_phase_done", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    autotune_phase(torch, dev, out_dir)
    emit({"phase": "autotune_done", "seconds": time.perf_counter() - t0})
    sync_phase(torch, dev)
    t0 = time.perf_counter()
    serve_launches, base = serve_phase(torch, dev)
    emit({"phase": "serve_done", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    captured_launches = serve_captured(torch, dev, base, out_dir)
    emit({"phase": "serve_captured_done", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    train_launches = train_phase(torch, dev, base, out_dir)
    emit({"phase": "train_done", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    sweep_launches, tune_serve_launches = sweep_phase(torch, dev, base, out_dir)
    emit({"phase": "sweep_done", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    multihost_launches = multihost_phase(torch, dev, base, out_dir)
    emit({"phase": "multihost_done", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    online_launches, adaptive_launches = online_phase(torch, dev, base, out_dir)
    emit({"phase": "online_done", "seconds": time.perf_counter() - t0,
          "adaptive_launches": adaptive_launches})
    emit({"phase": "c3_fit", **c3_fit(ONLINE_SEQ)})
    del base  # the launcher makes its own f32 base (30.5 GB)
    t0 = time.perf_counter()
    launcher_launches = launcher_phase(torch, dev, out_dir)
    emit({"phase": "launcher_done", "seconds": time.perf_counter() - t0})
    gc.collect()
    torch.cuda.empty_cache()  # the launcher's f32 base is gone; each family makes its own
    t0 = time.perf_counter()
    family_launches = families_phase(torch, dev, out_dir)
    emit({"phase": "families_done", "seconds": time.perf_counter() - t0})
    summary = summarize(rows, {"serve": serve_launches, "serve_captured": captured_launches,
                               "train": train_launches,
                               "sweep": {"auto": sweep_launches},
                               "tune_serve": tune_serve_launches,
                               "multihost": {"auto": multihost_launches},
                               "online": {"auto": online_launches},
                               "launcher": launcher_launches, **family_launches,
                               COMMAND_R: command_r_launches, MOE: moe_launches,
                               JAMBA: jamba_launches})
    (out_dir / "chip_smoke.json").write_text(json.dumps({"records": RECORDS, **summary}, indent=1))
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
