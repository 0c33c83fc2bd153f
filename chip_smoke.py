#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. card: a CUDA device must be present; prints ``nvidia-smi``'s name and
   power limit.
2. build: compiles the three kernels from ``kernels/csrc`` with nvcc
   (one process per source, in parallel; always, even when a library is
   up to date, so each run reports its own build) and prints the build
   seconds and ptxas's register, shared-memory and spill counts.
3. kernels: each decode kernel against its plain PyTorch version on the
   card at the full-width minitron-8b decode shapes (H=32, Hkv=8,
   hd=128, 8 rows, S=4096, BLOCK_S=16), bf16 and f32, with ragged
   lengths, inactive rows (exact zeros), a non-contiguous valid mask,
   stale block-table entries and two rows aliasing one block; times the
   kernel, the plain version and ``F.scaled_dot_product_attention`` on
   the same gathered inputs (the yardstick; the port never calls it).
   Then both decode kernels, bf16 and f32, at the fleet pools' shapes:
   the long pool (B=4, S=4096, one live row of 1,100 tokens, three
   inactive) and the short pool (B=4, S=512, four live rows of 400-500),
   each checked against its plain version, two calls bitwise equal, dense
   equal to paged bitwise on the same tokens, and timed rotating over
   enough copies of the caches that the live K/V between two uses of one
   copy exceeds the 50 MB L2.
   Then both decode kernels, bf16 and f32, at the head shapes of other
   registered configs, (q_per_kv, head_dim) = (5, 128), (6, 128), (12,
   192) and (16, 64): against the plain version, two calls bitwise equal,
   dense equal to paged bitwise; and in bf16 at the long pool's contexts,
   one live row at S = 16384 and 65536. bf16 is held to 1e-2 and to 2^-8
   (one bf16 ulp) x max|plain| everywhere.
   TextRank against its plain version in f32 at N = 1, 64, 96, 97, 239,
   240, 512, 1024, 1500 and 2000 sentences (symmetric |normal| matrices,
   two with an all-zero column; one block up to 96, at 2000 a grid whose
   rows do not fit shared memory), one launch a call and two calls
   bitwise equal; a
   sweep of grid sizes at N = 64, 96, 128, 239, 512 and 1024 (the
   measurement behind kernels/textrank.py's rule); times at N = 64, 512
   and 1024 beside the host numpy scorer it replaces; and the host split of
   ``ops.textrank_scores`` (cast, copy in, launch, kernel, copy out) at N
   = 64 and 1024.
4. parity: the reduced minitron-8b port in f32 serves the same requests
   on the card (kernels) and on the CPU (plain versions), dense and
   paged; the greedy tokens must match (a flip only at a CPU near-tie).
   Then four turns sharing a prefix through a paged engine with the
   prefix cache and one without, on the card: the same tokens, and the
   shared blocks' bits unchanged by the turns that map them.
5. fleet: ``launch.serve`` builds the full-width minitron-8b K=2 fleet
   (azure plan, bf16, random weights from a seed) and serves one
   request per pool band plus one borderline request (L_total 1069 >
   gamma * B = 1024: the long pool, uncompressed), once dense and once
   paged, with decode_k=4; every request must complete with tokens, and
   each layout's decode kernel must have launched.
6. gateway: the same fleet with ``--prefix-cache`` (paged): the
   launcher's batch and two-turn session, then five in-band borderline
   requests (B < L_total <= gamma * B; four of varied sentences, prose
   and rag, one of the repetitive template) and a two-turn session of
   ~3000 tokens on the long pool. Every in-band request must be
   compressed (C&R) within Eq. 15, served by the short pool and
   complete; TextRank must have launched once per compression attempt;
   each session's turn 2 must be pinned to its pool and hit its cached
   prefix; the block invariants must hold at idle. Prints compression
   ms with the kernel and with the numpy scorer, the kept-set agreement
   of the two, and each session's turn 2 against its turn 1. Then the
   compressor alone at the paper's size (B* = 8192, gamma 2): three
   prompts of 9,500-14,500 tokens (400-800 sentences) compressed to
   8192 - 64 tokens with the kernel scorer and the numpy scorer; prints
   the kept-set agreement, compression_ms of each and the split between
   tfidf_matrix, the similarity product and TextRank.
7. speculation and overload survival, minitron-8b bf16 at its published
   widths, its first 8 of 32 layers (``P7_LAYERS``, the stacked leaves
   sliced and the cut config registered under its own name: every part
   but (c) is host-bound and its dispatches' time grows with the depth;
   each check holds at any depth) unless said otherwise; the launch
   counts are reset before each part.
   (b) the phase-5 fleet, paged, with ``--spec-k 4`` against spec_k 1
   (random weights: drafts mostly rejected): every request completes;
   both runs log the logits behind each emitted token, which may differ
   by at most BF16_DRIFT_ULPS wherever the histories agree, and tokens
   are equal but where the plain run's preference at the first
   divergence is a bf16 near-tie (BF16_GAP_ULPS). (a) the agent-loop
   weights (``agent_loop_params``: new tensors beside the random ones),
   one dense and one paged engine (n_max 4, c_max 4096, decode_k 4) at
   spec_k 1, 2 and 4 on in-cycle prompts: acceptance 1.0, kappa ==
   spec_k, the same tokens bitwise; decode tokens/s and ms per dispatch.
   (c) reduced minitron-8b f32 on the card against the CPU (phase 4's
   rule): spec_k 4, and swap- and recompute-resume of a preempted
   request, dense and paged, decode_k 1 and 4. (d) the paged long pool
   (c_max 4096, n_max 4) with 320 blocks under 8 requests of 1,000-2,500
   tokens (64 new each) and preemption: a swap out and in at least, every
   request completes, each swapped block's bits restored exactly, the
   host tier empty and the block invariants holding at idle, tokens equal
   an unloaded run's (the near-tie rule); preempt / swap / recompute
   counts and swap ms per block. Then the same stream with queue-wait
   shedding: shed + completed = submitted. (e) lout_reservation on that
   pool (84 blocks, agent-loop weights, EOS in the cycle): peak admitted
   concurrency above the worst-case run's, a breach that preempts and
   never runs out of blocks, the same tokens; then lout_routing through
   the fleet: an over-claiming request routed short by its predicted
   output length, its budget clamped to that pool, completes.
8. forward, prefill and the batch launcher (``launch.serve`` without
   ``--fleet``), bf16 at full width unless said otherwise; the launch
   counts are reset before each launcher run, and a kernel run must
   launch ``gqa_decode`` exactly once per layer per decode step (a
   torch-path run, never). (a) minitron-8b, batch 8, prompt 2048, 64 new
   tokens, decode through the kernel against the torch path on the same
   prompts: tokens equal or held by phase 7's drift and near-tie rule;
   prefill ms, decode tokens/s, launches (32 x 63). (b) ``forward`` over
   prompt + emitted tokens: its logits at every generated position
   within BF16_DRIFT_ULPS of the decode logits. (d) ``--int8-kv`` on the
   same prompts, the kernel against the torch path on the same
   dequantized int8 cache by the drift and near-tie rule (launches
   32 x 63); then int8 prefill + decode fed the bf16 run's tokens,
   the last-token logits within 0.05 of max|logit| of the bf16 cache's
   (the JAX package's bound); both caches' bytes. (c) one prompt of 8192:
   ``forward`` through ``_flash_causal`` (all 32 layers) against the same
   forward with ``_sdpa`` forced, over the last 64 positions, by the
   drift rule; then prefill 8192 (flash) and 8 decode steps, kernel
   against the torch path, and the prefill's logits against the flash
   forward's. (e) reduced minitron-8b f32, card against CPU: ``forward``
   logits within 1e-5 of max|logit|, ``prefill`` caches (fp and int8)
   alike, the launcher's tokens equal, fp and int8. (f) nemotron-4-15b
   (31.3 GB of weights, q_per_kv 6) after minitron's tensors are freed:
   batch 4, prompt 1024, 32 new, kernel against the torch path (launches
   32 x 31).
9. live re-provisioning and crash recovery on phase 5's fleet (full-width
   minitron-8b bf16 at its first 8 of 32 layers, ``P9_LAYERS``, the
   stacked leaves sliced; 4 slots a pool, contexts 512 / 4096, c_chunk 256,
   decode_k 4), dense and paged; eight requests through
   ``FleetRuntime.submit`` (five short-band, two long, one in-band for
   C&R; 32 new tokens each), every run driven round by round and held
   against an uninterrupted run of the same stream by phase 7's rules
   (both runs' logits logged). (a) after 3 rounds the short pool is
   reprovisioned to n_max 2, c_max 768, then, once both long requests
   decode, the long pool to c_max 6144: every request completes, none
   rerouted, ``reprovision_stats`` as done; each call's wall ms (device
   synchronised) split into ``drain_checkpoint``, the engine build and
   ``_adopt_state`` (host checkpoints fitted to the new geometry), device
   memory before, at peak and after (the old cache freed), and
   the drive rounds against the uninterrupted run; the long pool's
   tokens exact (swap restore at an unchanged n_max). (b) every swap-in
   read back from the new engine equals its host copy bitwise, a dense
   row's padded tail exactly zero; swap ms per MiB. (c) dense: the short
   pool killed, its device KV set to NaN, ``recover_pool`` with a 1 s
   blackout moves its requests to the long pool; a submission inside
   the blackout raises PoolDownError (retry_after > 0), after it the
   same prompt and an in-band one (TextRank) are served by the short
   pool; then the long pool is wedged, found by HealthPolicy(patience=2)
   and rebuilt in place. (d) paged: the same with the short pool's
   allocator exhausted instead of a kill. (e) the engines built in
   (a)-(d) must have launched the layout's decode kernel, and in (a)-(d)
   the kernel's first launch at each shape, the rebuilt pools' (2, 768)
   and (4, 6144) included, is held against its plain version on the same
   live inputs (TOL and one bf16 ulp, as phase 3); phase 9's launches are
   added to the ``kernels`` line. Prints its duration.
10. the HTTP/SSE gateway (``launch.serve.serve_http`` on phase 5's fleet,
   minitron-8b's first 8 of 32 layers, ``P10_LAYERS``, an ephemeral port,
   the client in process), every answer read as it arrives. (a) paged with the prefix
   cache: the reference smoke sequence (``/health``; a streamed
   completion, more than one flush and [DONE]; the same prompt not
   streamed, equal bitwise, or by phase 7's rules where it hit the prefix
   cache and so prefilled other shapes; a malformed body's 400; a burst
   of six prompts of 96-136 tokens, sized for this fleet's context scale,
   then ``POST /admin/replan``, which must move the boundary down to
   ``boundaries_after``; ``/metrics``, every sample line parsing and the
   boundary gauge equal to the applied boundary); then, on a new gateway,
   phase 6's five in-band prompts, streamed one at a time, each
   compressed into the short pool (the annotation says so) by one
   TextRank launch a compression attempt, and eight concurrent streams
   (four of 300-420 tokens, four of 1500-2500), each completing with
   finish_reason ``length`` on its pool. (b) dense, ``--chaos``: the
   reference chaos sequence, with the streamed and non-streamed runs of
   one prompt equal bitwise; the short pool killed after the live
   stream's first flush, a probe in the blackout answered 503 with
   Retry-After >= 1, the killed stream completing on the long pool by
   phase 7's rules, the retry after the blackout equal bitwise to the
   unfaulted run (the rebuilt engine has the same shapes), and the
   restart and migration counters >= 1. (c) dense, ``--autoscale``: a
   long prompt's unfaulted run, four short requests, then the same long
   prompt streamed and ``POST /admin/replan`` after its first flush: the
   tick must take an autoscale action on the stream's pool while the
   stream is in its slots (the planning rate is the smoke's arrival rate
   against the plan's 1000 req/s, so the plan shrinks the pools' slots),
   the stream completes by phase 7's rules, and
   ``fleetopt_autoscale_actions_total`` >= 1. Each decode kernel's first
   launch at every (B, S) of the phase, the autoscaled long pool's
   included, is held against its plain version on its live inputs (phase
   9's rule). Prints TTFT over HTTP (short, long, in-band with
   compression_ms), request latency, streamed tokens/s and flushes per
   stream under the concurrent streams, ``Replanner.tick`` ms,
   ``/metrics`` render ms, kill to the first post-recovery token, the
   autoscale tick's ms (its rebuilds split), the stream's largest pause
   and the device memory around the tick, and the phase's launches, which
   are added to the ``kernels`` line.

11. training (``launch.train`` and ``training/``; no kernel of the port
   is on this path, and none may launch), after a check that phases
   1-10 left no engine or cache allocated:
   (a) ``train()`` with the launcher's defaults (global batch 8 x 128 from
   ``batch_at``, AdamW lr 3e-4 with warmup 2, remat "layer", 10 steps) on
   minitron-8b at its published widths with the depth cut from 32 to 16
   layers (AdamW's 12 B a parameter needs 92.9 GB at 32), bf16, the
   port's ``init_params`` at seed 0: every loss and grad norm finite, the
   reference's rule ``min(losses[4:]) < losses[0] + 0.02``, peak
   ``max_memory_allocated`` under 80 GB; prints ms a step, tokens/s, the
   peak and the step's floor (FLOP at 989 TFLOP/s plus the update's
   bytes at 3.35 TB/s), then a step split into gradients and update, and
   one step under torch.profiler.
   (b) reduced minitron-8b f32, the port's weights on the CPU and a copy
   on the card, 3 steps each: losses and grad norms within 1e-5
   relative, parameters by the parity rule of
   tests/test_torch_training.py.
   (c) one step's gradients with remat "layer" and with none at (a)'s
   depth and batch: the loss bitwise, each grad leaf bitwise but the
   embedding's, within ``REMAT_GRAD_BOUND`` of its max |g|.
   (d) one step with microbatches 2 against 1 on 8 layers at 8 x 512:
   the loss and the grad norm within ``MICRO_REL_BOUND`` relative, each
   parameter leaf within ``MICRO_PARAM_BOUND`` of its max |p|.
   (e) (b)'s parameters (f32 and as bf16) and AdamW state checkpointed
   from the card and restored onto it, bitwise.

12. the int8 KV cache and the sliding-window ring caches, minitron-8b at
   its published widths, bf16, the port's ``init_params`` at seed 0, its
   first 2 of 32 layers (``P12_LAYERS``, the stacked leaves sliced: (a)'s
   fleet dispatches and (b), (c)'s per-token prefill, one
   ``decode_step`` a token column, are host-bound).
   (a) phase 9's stream through phase 5's dense fleet (``from_plan``)
   with the bf16 cache and with ``kv_cache_dtype="int8"``: every request
   completes in both; the int8 fleet's caches hold 130/256 of the bf16
   fleet's bytes; one decoding slot of the int8 long pool swapped out
   (the host copy bitwise every leaf, scales included) and back in (read
   back bitwise); the int8 engine's logits against the int8 batch path
   (``prefill`` + ``decode_step`` on the int8 dense cache, the same
   prompts, the engine's convention of feeding the last prompt token
   again) by phase 7's drift and near-tie rule; the int8 batch path fed
   the bf16 fleet's tokens, its last-token logits within 0.05 of
   max|logit| of the bf16 engine's (tests/test_perf_opts.py); each decode
   kernel launch shape held against its plain version on its live,
   dequantized inputs. Prints decode ms per dispatch of both fleets, the
   cache bytes, and one profiled decode dispatch of each long pool with
   ``dequantize_kv`` marked (its device share), beside a CUDA-event time
   of one dequantized leaf. (b) ``attention_window=1024`` (llama4-scout's
   8192 cut so the per-token prefill fits the phase), a dense engine with
   n_max 4, c_max 4096 (a ring of 1024 rows), decode_k 4: four prompts
   of 1,200-1,500 tokens and 64 new each, prefilled token by token; every
   request completes past position 1024; the logits against a
   teacher-forced ``forward(window=1024)`` over prompt and fed tokens by
   the drift rule (a position where the forward's argmax is another
   token passes only within the near-tie limit); ``prefill`` into the
   ring (shorter than the prompt) and ``decode_step`` against the engine
   by the drift and near-tie rule; the decode kernel held on its live
   inputs while the ring fills and after it wrapped, and on the live
   ring under a window of 512, where ``valid`` is no prefix. Prints the
   per-token prefill's ms, decode ms per dispatch and the launches. (c)
   int8 and the window in (b)'s engine: one request of 1,060 + 16
   tokens completes, its kernel launches held on the live dequantized
   ring.
   Phase 12's launches are added to the ``kernels`` line.

13. the MoE block (``models/moe.py``) and llama4-scout-17b-a16e at its
   published widths (d_model 5120, 40 / 8 heads, 16 routed experts of
   d_ff 8192, top-1, one shared expert, vocab 202048, window 8192), the
   depth cut from 48 to 12 layers (56.99 GB of bf16 weights), the port's
   ``init_params`` at seed 0. (a) ``moe_block`` on layer 0's weights at
   T = 4 (a decode step) and T = 4096 (a 4 x 1024 prefill): ms beside
   two bytes floors, the function's (the experts its kept pairs reach,
   the router, the shared expert) and this implementation's (every
   expert's weights: each expert's buffer holds at least 8 rows), and
   its operations floor, the pairs dropped at
   capacity_factor 1.25, and the routing flips of bf16 against the same
   block in f32 on the same inputs. (b) the batch launcher
   (``serve_batch`` on the depth-cut config, registered under its own
   name), 4 x 1024 + 16 decode steps: prefill ms against its compute
   floor, decode ms a step against its bytes floors (the function's:
   the experts each step's pairs reach and the KV rows it reads; this
   implementation's: every weight but the embedding), the drops at 1.25
   (none in decode); then on a copy at capacity_factor 8.0 (no drop, as
   the reference's own test) the decode logits against a teacher-forced
   ``forward`` by the drift rule, the forward taking the decode run's
   routing (``_route_log(replay=)``: in bf16 two paths route a token to
   another expert where the router's top two nearly tie, and the token's
   logits then leave the drift limit), each of the forward's own
   decisions that differs within twice the runs' largest top router
   logit difference where they route alike. (c) phase 5's K=2 fleet over
   the first 2 of these layers (its per-token prefill is host-bound, so
   the cut shortens the phase's longest part; the stacked leaves sliced)
   at contexts 256 / 2048 and c_chunk 128, dense (the
   window rules out the paged pool; rings of 256 and 2048 rows), n_max
   4, decode_k 4, behind the C&R gateway: two short, two in-band and one
   long request of 16 new tokens, prefilled token by token; every
   request completes, the in-band ones compressed into the short pool
   (TextRank launched). That run is timed with nothing else wrapping the
   path; the same stream again with logits and routing logged and each
   decode kernel launch shape held on its live inputs gives the same
   tokens and launches; the same stream with ``decode_impl="torch"``,
   taking the logged kernel run's routing, by phase 7's drift and
   near-tie rule and (b)'s routing rule. Prints decode
   ms per dispatch, per-token prefill ms a column, one profiled decode
   dispatch with ``moe_block`` marked (its device share, the device's
   busy share) and the launches. (d) reduced llama4-scout f32, dense
   (its window of 64 wraps) and with window 0 on the paged pool, card
   against CPU, the CPU taking the card's routing: tokens equal, a
   difference only where the CPU's top-2 logits are within 1e-5, and
   each of the CPU's own routing decisions that differs from the card's
   only where its top-2 router probabilities are. Peak device memory under 80 GB; the phase's launches are
   added to the ``kernels`` line.

14. the recurrent families (``models/ssm.py``: Mamba2, mLSTM, sLSTM) at
   their models' published widths and full depth, bf16, the port's
   ``init_params`` at seed 0: zamba2-1.2b (38 Mamba2 layers, one shared
   attention + MLP block after every 6) and xlstm-350m (24 layers of
   mLSTM x 3 + sLSTM). (a) each block alone on one layer's random
   weights at B=4, T=1024, and its decode step: ms (CUDA events; the
   sLSTM forward, a host-bound loop over T, between events without the
   hold, with its device busy share from torch.profiler) beside its
   bytes floor at 3.35 TB/s (the layer's weights, input, output and
   state) and its FLOP floor at 989 TFLOP/s. (b) zamba2 through the batch
   launcher, 4 x 1024 + 32 new, decode through the kernel against the
   torch path on the same prompts by phase 7's drift and near-tie rule;
   ``gqa_decode`` launches exactly 6 x 31 a run (one a shared-block
   application) and is held on its live inputs (TOL and one bf16 ulp);
   then decode against a teacher-forced ``forward`` over prompt + fed
   tokens (its tail padded with filler tokens to a multiple of the scan
   chunk: every block is causal, and only real positions are compared):
   in bf16 within 0.1 of max|logit| (the two paths round at other
   points), and in f32 within the reference's 2e-2 (the launcher on the
   same weights upcast, through the kernel again). Prints prefill ms,
   decode tokens/s and ms a step, peak memory. (c) xlstm likewise (no
   attention: no kernel launches), but its bf16 decode at 24 layers is
   reported, not held: the bf16 model's rounding grows with depth (the
   JAX package's own, on the CPU: 0.039 of max|logit| at 4 layers, 0.26
   at 16; tests/ssm_bf16_drift.py), so the 0.1 bound holds the launcher
   on the first 4 layers' weights; and decode ms a step after a 1 x 8192
   prompt beside 1 x 1024. (d) reduced f32, xlstm and zamba2 in both
   layouts (3 layers: flat with a tail; 4: stacked), card against CPU:
   ``prefill`` logits and every cache leaf, 8 greedy ``decode_step``s
   (tokens equal, a flip only at a CPU top-2 gap under 1e-5), a masked
   step and ``prefill_chunk`` with an idle row (those rows bitwise),
   within 1e-5 (zamba2) / 3e-5 (xlstm) of max. The phase's launches are
   added to the ``kernels`` line.

15. the VLM family (``models/model.py``'s VLM branch: a tanh-gated
   cross-attention layer over a stubbed frontend after every 5 decoder
   layers) on llama-3.2-vision-11b at its published widths and full depth
   (40 layers, 8 cross layers over 1601 frontend rows, d_model 4096, 32 /
   8 heads, vocab 128256; 23.04 GB in bf16), the port's ``init_params`` at
   seed 0 with every cross layer's gate and gate_mlp set to 0.5 / -0.7
   (the reference draws them zero: every cross layer the identity). At
   this depth two valid bf16 roundings of one decode step (the kernel,
   its f32 plain version, the torch path) sit farther apart than
   BF16_DRIFT_ULPS, so each bf16 path is held to an f32 truth instead: a
   teacher-forced ``forward`` of the weights upcast over the path's own
   history, its largest distance from which must stay within
   P15_TRUTH_RATIO of the torch path's (the reference's rounding); the
   drifts are reported and the near-tie rule holds each first
   divergence. (a) the batch launcher, 4 x 1024 + 16, the launcher's
   constant frontend, through the kernel (held on its live inputs) and
   through the torch path: prefill ms against its FLOP floor, decode ms a step against its
   bytes floor (the weights but the embedding, the KV and the cross
   memory, 52.5 MB a slot), launches exactly 40 x 15. (b) the launcher on
   a random frontend (normal x 0.02), 2 x 512 + 16, against the
   teacher-forced bf16 ``forward`` (the drift reported; the decode's
   distance from the f32 truth held to P15_TRUTH_RATIO of the forward's),
   and in f32 on the weights upcast at full depth, decode against its
   own teacher-forced forward within P15_FWD_REL = 1e-4 of max|logit|
   (the reference's f32 test holds 2e-2, which passes planted faults
   here). (c) phase 5's K=2 dense fleet
   at contexts 256 / 2048 (c_chunk 128, n_max 4, decode_k 4), each
   pool's cross memory the K/V of a random frontend (the engine never
   writes it), behind the C&R gateway: two short requests and two
   in-band ones compressed into the short pool (TextRank launched),
   prefilled token by token, 16 new tokens each; every request
   completes; the kernel run (each decode kernel shape held on live
   inputs) against the torch run by the near-tie rule and the f32 truth;
   decode ms a dispatch, per-token prefill ms a column. (d) the same
   stream with the short pool reprovisioned to c_max 384 once a slot
   decodes: every request completes, every swap-in read back bitwise,
   the cross memory (F = 1601 rows; the rebuilt pool's own rows another
   frontend's) included. (e) reduced f32 (4 layers, 2 KV heads: two
   groups, q_per_kv 2), gates as above, a random frontend, card against
   CPU: ``prefill`` logits and every cache leaf, 8 greedy decode steps
   (a flip only at a CPU top-2 gap under 1e-5), a masked step and
   ``prefill_chunk`` with an idle row (those rows bitwise), within 1e-5
   of max. The phase's launches are added to the ``kernels`` line.

16. the encoder-decoder family (``models/model.py``'s ENCDEC branch: a
   bidirectional encoder over a stubbed frontend of frame embeddings,
   each decoder layer followed by an ungated cross-attention over its
   output) on seamless-m4t-large-v2 at its published widths and full
   depth (24 encoder + 24 decoder layers, d_model 1024, 16 heads, MHA,
   hd 64, d_ff 8192, vocab 256206, 1024 frames; 3.87 GB in bf16), the
   port's ``init_params`` at seed 0, nothing cut, after phase 15's
   tensors are freed. (a) the batch launcher, 4 x 1024 + 16, on a random
   frontend (normal x 0.02: the launcher's constant stub makes every
   frame alike), through the kernel (held on its live inputs) and
   through the torch path on the same prompts, then the kernel path once
   more on the stub, timed: prefill ms against its FLOP floor (the
   encoder included), decode ms a step against its bytes floor (the
   decoder weights but the cross K/V projections, the LM head, the
   self-attention KV and the cross memory, whose share is printed),
   launches exactly 24 x 15 a run; the kernel path against the torch path
   by the near-tie rule, and by the drift rule: within BF16_DRIFT_ULPS,
   or else each path's distance from the f32 truth (phase 15's) within
   P15_TRUTH_RATIO of the torch path's. (b) the bf16 decode against a
   teacher-forced bf16 ``forward`` over (a)'s history by the same rule
   (the bf16 forward the plain path), and in f32 on the weights upcast,
   2 x 512 + 16, decode against its own teacher-forced forward within
   P15_FWD_REL of max|logit|. (c) ``--int8-kv`` on (a)'s prompts and
   frontend: the self-attention cache exactly (hd + 2) / 2hd of the bf16
   cache's bytes (phase 12's rule: hd int8 values and a bf16 scale an
   entry), the cross memory the bf16 run's dtype and bytes; int8 prefill
   + decode fed (a)'s tokens, the last-token logits within INT8_REL of
   max|logit| of the bf16 run's. (d) ``launch/train.py``'s ``train()``
   at full width and depth, global batch 8 x 128 with the launcher's
   frontend stub, 10 steps: every loss and grad norm finite, the
   reference's ``min(losses[4:]) < losses[0] + 0.02``, peak under 80 GB,
   no kernel launched; ms a step split into gradients and update beside
   the floor. (e) reduced f32 (2 + 2 layers), a random frontend, card
   against CPU: ``forward``, ``prefill`` logits and every cache leaf, 8
   greedy decode steps (a flip only at a CPU top-2 gap under 1e-5), a
   masked step (the inactive row bitwise), within 1e-5 of max. The
   engine, and so the fleet, refuses ENCDEC, as the reference's does.
   The phase's launches are added to the ``kernels`` line.

17. multi-head latent attention (``models/mla.py``: the latent cache
   ``c_kv`` / ``k_r``, the non-absorbed prefill, the absorbed decode; no
   kernel, as the reference computes MLA in plain ``jnp``) on
   deepseek-v2-236b at its published widths (d_model 5120, 128 heads,
   latent 512, rope 64, nope and v 128; 160 routed experts of d_ff 1536,
   top-6, 2 shared; vocab 102400), the port's ``init_params`` at seed 0,
   after phase 16's tensors are freed. (a) one layer's MLA alone
   (``init_mla``, 0.459 GB): ``mla_attention`` at 4 x 1024 (the plain
   branch) and ``mla_decode`` at B = 4 over 2048 latent rows, timed with
   CUDA events against their bounds (bytes at 3.35 TB/s, FLOP at 989
   TFLOP/s); at 1 x 8192 the flash branch against the plain branch
   (whose f32 scores take 34.4 GB) within BF16_DRIFT_ULPS of each
   position's largest output. (b) the depth cut from 60 to 6 layers
   (50.72 GB; 8 would leave too little beside the per-token prefill),
   the batch launcher at 4 x 1024 + 16: prefill ms against its FLOP
   floor (the routed pairs and shared experts), decode ms a step against
   two bytes floors (the function's: the experts its pairs reach,
   attention, head and latent rows; this implementation's: every
   expert, each buffer holding at least 8 rows), the drops (none at
   decode), no kernel launched; then 1 x 8192 + 3, whose prefill takes
   ``_flash_causal`` once a layer. (c) bf16 decode against a
   teacher-forced ``forward``, the forward replaying the decode run's
   routing, each of its own decisions that differs within twice the
   runs' router-logit noise (phase 13 (b)'s rule), on a copy at
   capacity_factor 4.0 (no pair may drop: phase 13's 8.0 would give 160
   experts a 16 GB buffer): at 6 layers the drift is reported (the
   absorbed and the expanded forms round the scores at other points);
   then, after the other bf16 layers are freed, at full width and 2 of
   60 layers (the f32 copy of 6 does not fit; that of 2 is 36.6 GB) the
   bf16 decode by phase 16's rule (within BF16_DRIFT_ULPS of the bf16
   forward, else its distance from the f32 truth, a forward of the
   weights upcast over its history on its routing, within
   P15_TRUTH_RATIO of the bf16 forward's), and the absorbed algebra's
   hard gate: the launcher on the upcast weights, 2 x 512 + 16, decode
   against its teacher-forced forward (on the decode run's
   routing) within P15_FWD_REL = 1e-4 of max|logit|. (d) phase 13's K=2
   dense fleet (the paged pool refuses MLA, as the reference's does) at
   contexts 256 / 2048, c_chunk 128, n_max 4, decode_k 4, behind the C&R
   gateway: two short, two in-band and one long request of 16 new
   tokens, prefilled token by token; every request completes, the
   in-band ones compressed within Eq. 15 (TextRank launched once each),
   ``gqa_decode`` and ``paged_gqa_decode`` launched 0 times; the
   ``decode_impl="torch"`` run emits the kernel run's tokens (MLA's
   decode is the same code in both); then the short pool reprovisioned
   to c_max 384 once a slot decodes (phase 15 (d)'s event): every
   swap-in's ``c_kv`` / ``k_r`` rows read back bitwise, the padded tail
   zero, and the uninterrupted run's tokens. Decode ms a dispatch and
   per-token prefill ms a column are printed. (e) reduced f32, card
   against CPU, the CPU replaying the card's routing: ``forward``,
   ``prefill`` (logits and both latent leaves), 8 greedy decode steps (a
   token flip only at a CPU top-2 gap under 1e-5), a masked step and
   ``prefill_chunk`` with an idle row (those rows bitwise), within 1e-5
   of max; a routing decision of the CPU's own only at a top-2 router
   probability gap under 1e-5 (with top-k routing the gap between the
   k-th and (k+1)-th, where a flip happens; ``_route_log`` logs those).
   Peak device memory under 80 GB; the phase's launches (TextRank's) are
   added to the ``kernels`` line.
18. tensor-parallel serving over one rank group: minitron-8b bf16 at its
   published widths and depth (seed 0) at tp=4, four rank processes on
   the one card (``distributed/context.launch_ranks``: gloo for the
   process group, the tensors exchanged through card buffers the ranks
   share), each drawing its shard (``init_params(parallel=)``) after
   the tp=1 references ran in this process and were freed. (a) each
   rank's weights exactly the sharded leaves / 4 plus the replicated
   norms (``param_specs`` on the meta shapes); each rank's KV bytes x 4
   exactly the tp=1 engines' (dense and paged); peak device memory per
   rank. (b) ``serve.py --fleet 2 --tp 4``'s path, phase 5's fleet and
   prompts with 32 new tokens (decode_k 4) on the first 16 of the 32
   layers (``P18_FLEET_LAYERS``; phase 20 serves a multi-rank fleet at
   full depth), dense and paged: every
   request completes,
   rank 0's tokens equal rank 3's, and held against the tp=1 run by the
   drift and near-tie rule (both runs' logits logged); decode ms a
   dispatch and a profiled dispatch with the collectives' share, beside
   tp=1's. (c) on every rank each decode kernel launches once a layer a
   decode step (16) on the rank's 2 kv heads and its first launch at
   every shape is held against its plain version on the live inputs
   (``_live_kernel_hold``). (d) phase 9's stream (five short, two long,
   one in-band request through C&R) on the tp=4 fleet, uninterrupted and
   with the long pool reprovisioned to c_max 6144 after 3 rounds: every
   request completes, the in-band one compressed into the short pool with
   TextRank launched once, on rank 0 only (rank 0 routes; the others
   receive its decision), ranks 0 and 3 the same tokens, the
   reprovisioned run held to the uninterrupted one by the drift rule.
   (e) the batch launcher (phase 8's 8 x 2048 + 64) at ``--mesh 1x4`` and
   ``--mesh 2x2`` (the rows split over the data axis, each rank drawing
   its 2-way shard), 32 x 63 kernel launches on every rank, every row held
   to the 1x1 run by the drift rule. (f) reduced f32 (8 query heads over
   4 kv heads of 64), the card at tp=4 and the CPU at tp=4 (in the same
   ranks) against the CPU at tp=1: the engine's tokens equal, the
   forward's logits within 1e-5 of max. Reported, not gated: prefill ms,
   decode ms a dispatch and a step, tp=4 beside tp=1 (four ranks
   time-sliced on one card measure correctness, not what tp=4 gives on
   four cards). Every rank's launches are added to the ``kernels`` line.
19. expert parallelism: llama4-scout-17b-a16e bf16 at its published
   widths, the depth cut from 48 to 6 layers (30.56 GB), at tp=4, four
   rank processes on the one card (phase 18's group), each drawing its
   shard (``init_params(parallel=)``: 4 of the 16 experts a layer, the
   router and the shared expert whole) after the tp=1 references ran in
   this process and were freed: each rank's weights exactly the sharded
   leaves / 4 plus the replicated ones; peak device memory per rank.
   (a) ``moe.moe_block_sharded`` alone on layer 0, a2a at 4 x 1024 and
   psum at T = 4, and deepseek-v2-236b's MoE block at its published
   widths (160 experts of 1536, top-6, 2 shared; each rank drawing its
   40) at the same two shapes (run first, before scout's weights): at
   capacity_factor 8.0 no pair dropped and the output within ``TOL`` of
   max|y| of ``moe_block`` at tp=1 on the same input (tokens whose router
   top-k probabilities nearly tie, under P19_TIE, left out); at 1.25 the
   pairs dropped among those routed to each rank's experts; ms a call
   (host clock, the device synchronised) beside a rank's bytes and
   operations floors. (b) the batch launcher at ``--mesh 1x4`` and
   ``2x2`` (4 x 256 + 8 decode steps) on the capacity-8.0 copy, every
   rank taking the tp=1 run's routing (``_route_log(sharded=)``: a rank
   logs the tokens it routes, its sequence slice under a2a), held to the tp=1
   run by the drift and near-tie rule and each own routing decision
   that differs by phase 13's routing rule; 6 x 8 gqa_decode launches on
   every rank, held live. (c) phase 13 (c)'s requests and contexts on
   the K=2 fleet at tp=4 with window 0, twice: dense (the fused chunk:
   a2a; ``decode_step``: psum), the long pool reprovisioned to c_max
   6144 after 3 rounds; then paged (``paged_prefill_chunk``: a2a;
   ``paged_decode_step``: psum). Each: every request completes, the
   same tokens on every rank, TextRank on rank 0 only, 6 launches of the
   layout's decode kernel a decode step on every rank at 2 kv heads,
   q_per_kv 5 and head_dim 128 (none of the other), each shape's first
   launch held on its live inputs.
   (d) reduced scout f32 at capacity 8.0 (one expert a rank), the card
   at tp=4 and the CPU at tp=4 against the CPU at tp=1: the engine's
   tokens equal, the forward's logits within 1e-5 of max. Times are
   reported, not gated (four ranks time-slice one card). Every rank's
   launches are added to the ``kernels`` line.
20. the K-pool fleet on disjoint tp submeshes: minitron-8b bf16 at its
   published widths and depth (seed 0), four rank processes on the one
   card over a 1x4 mesh, phase 5's K=2 plan (contexts 512 / 4096, 4
   slots a pool, c_chunk 256, decode_k 4) with tp=2 pools: the short pool
   on ranks 0-1, the long pool on ranks 2-3, each rank drawing its
   submesh's shard after the tp=1 references ran in this process and
   were freed. (a) ``device_placement()`` is {short: [0, 1], long: [2,
   3]} on every rank; each rank's weights are exactly its pool's shard
   (the sharded leaves / 2 plus the replicated ones), it holds no cache
   of the other pool, and a member's KV bytes x 2 are the tp=1 pool's.
   (b) phase 9's stream (five short, two long, one in-band request
   through C&R), dense and then paged: every request completes with the
   same tokens on every rank, held to the tp=1 fleet by the drift and
   near-tie rule (the logits logged on the pools' leads); TextRank on
   rank 0 only; each rank launches its layout's decode kernel 32 times a
   decode step of its own pool's and never for the other pool, ranks
   0-1 and 2-3 the same steps, summing to tp=1's; each shape's first
   launch held on its live inputs. (c) the long pool reprovisioned
   mid-flight once all its slots decode: dense to tp=1 (rank 1, the
   reference's rule) beside (b)'s uninterrupted run, and paged with the
   prefix cache to tp=4 with a prefix-warm session turn in flight,
   beside the same stream uninterrupted: the tokens by the drift rule,
   every checkpointed request swapped (none recomputed), each host leaf
   moved with every old member's heads bitwise (crc32), KV bytes a member
   x tp_old / tp_new, device memory after = before - the old shard set
   and cache + the new within 1 MiB on every rank; the reprovision's ms
   split into ``drain_checkpoint``, the weight reshard, the KV reshard
   and the engine build. (d) the short pool killed while the long pool
   decodes: ``recover_pool`` rebuilds it on ranks 0-1, every accepted
   request completes, the long pool's requests held to (b)'s by the
   drift rule. (e) ``serve.py --fleet 2 --tp 2 --mesh 1x4`` on the card
   prints the reference's placement lines and completes every request.
   Reported, not gated: decode ms a dispatch a pool beside tp=1's, a
   readback share's ms, the reprovision split, peak device memory a
   rank (the ranks time-slice one card: correctness, not four cards).
   Every rank's launches are added to the ``kernels`` line.

Then it prints the ``kernels`` JSON line, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. Imports nothing of
JAX and nothing of the JAX package.
"""
import bisect
import contextlib
import dataclasses
import functools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, published
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, no tensor f32
# max abs error against the plain version, as a fraction of max |plain|
# (no floor): f32 differs in reduction order only; in bf16 both sides
# accumulate in f32 and round once, at most one bf16 ulp (2^-7 relative)
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# bf16 is also held to 2^-8 x max|plain|: one bf16 ulp at the top of the
# output's range, what two f32 computations of one function rounded to
# bf16 can differ by (the decode kernels carry P into P.V as a bf16
# hi/lo pair, as exact as the plain version's f32 P)
BF16_ULP = 2.0 ** -8


# the gateway phase's in-band prompts draw their sentences from this list
WORDS = tuple("""
fleet pool router gateway token prompt context budget queue slot cache
block prefix session kernel tenant replica shard batch latency throughput
deadline request response stream agent tool retrieval passage document
summary answer question policy planner boundary band gamma workload
arrival burst tail percentile capacity memory bandwidth engine scheduler
decode prefill chunk window eviction refcount hash compression sentence
ranking graph centrality novelty position salience budgeted extractive
operator cluster region outage failover autoscaler dashboard alert metric
trace span counter histogram sample interval median variance estimate
model weights layer attention head projection activation norm vocabulary
customer invoice contract ticket escalation incident review migration
database index table column row partition snapshot checkpoint recovery
the a of to in for with on by from and but while because after before
quickly slowly rarely often always never usually mostly partly fully
""".split())


def varied_prompt(rng, n_tokens: int, tokenizer, words=(6, 15)) -> str:
    """Sentences of ``words`` random words from WORDS, drawn with
    ``rng``, as many as fit in ``n_tokens`` tokens by
    ``tokenizer.count``."""
    sents = []
    while True:
        k = int(rng.integers(*words))
        s = " ".join(rng.choice(WORDS, k)).capitalize() + "."
        if tokenizer.count(" ".join(sents + [s])) > n_tokens:
            return " ".join(sents)
        sents.append(s)


def template_prompt(n_tokens: int, tokenizer, topic: str) -> str:
    """The launcher's repetitive template (``serve.prompt``) with as many
    sentences as fit in ``n_tokens`` tokens."""
    from repro_torch.launch.serve import prompt
    n = 2
    while tokenizer.count(prompt(n + 1, topic)) <= n_tokens:
        n += 1
    return prompt(n, topic)


AGENT_CYCLE = 48          # agent-loop period, > the longest draft walk K*W-1


def agent_loop_params(cfg, params, cycle: int = AGENT_CYCLE):
    """Parameters whose greedy continuation is a pure token cycle, the
    torch twin of ``benchmarks/bench_speculative.py::agent_loop_model``:
    ``attn.wo`` and ``mlp.down`` zeroed make every residual block a
    no-op, so the last hidden state is the embedding of the last token
    alone, and ``lm_head`` maps cycle token t to t+1 mod ``cycle`` by its
    rms-normed, unit-length embedding (x4). Every n-gram draft copied from
    an in-cycle history is then right: acceptance 1.0 by construction.
    Returns a new dict: the changed leaves are new tensors (the zeroed
    stacks broadcast one zero layer), the others are ``params``'s own."""
    import torch
    attn, mlp = params["layers"]["attn"], params["layers"]["mlp"]

    def zeros(a):
        return torch.zeros_like(a[:1]).expand_as(a)
    emb = params["embed"][:cycle].float()
    h = emb / torch.sqrt((emb ** 2).mean(-1, keepdim=True) + 1e-5) \
        * params["final_ln"].float()
    u = h / torch.linalg.vector_norm(h, dim=-1, keepdim=True)
    head = torch.zeros((cfg.d_model, cfg.vocab_size),
                       dtype=params["embed"].dtype, device=emb.device)
    nxt = (torch.arange(cycle, device=emb.device) + 1) % cycle
    head[:, nxt] = (u * 4.0).T.to(head.dtype)
    layers = dict(params["layers"], attn=dict(attn, wo=zeros(attn["wo"])),
                  mlp=dict(mlp, down=zeros(mlp["down"])))
    return dict(params, layers=layers, lm_head=head)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call: CUDA events around ``iters``
    back-to-back calls after ``warmup``. The device is first held in a
    spin of at least 50 ms while the host queues the timed calls, so the
    events time device work and not the host's Python per call (which
    at these shapes is longer than the kernels); the run fails if the
    queueing outlasted the spin."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    khz = torch.cuda.get_device_properties(0).clock_rate
    hold, start, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
    hold.record()
    torch.cuda._sleep(int(50 * khz))            # >= 50 ms of spinning
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    queued_ms = 1e3 * (time.perf_counter() - t0)
    end.record()
    torch.cuda.synchronize()
    if queued_ms >= hold.elapsed_time(start):
        fail(f"timing: queueing {iters} calls took {queued_ms:.1f} ms, "
             f"longer than the device hold; device time not isolated")
    return start.elapsed_time(end) / iters


def profile_calls(fn, n: int):
    """torch.profiler over ``n`` calls of ``fn``: the device-side rows
    (name, device microseconds, count), largest first, and the wall
    seconds of the calls (device synchronised)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side rows only (kernels, copies): the CPU ops that launched
    # them carry the same device time again
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.self_device_time_total]
    return sorted(rows, key=lambda r: -r[1]), wall


def profile_decode(eng, n_dispatch: int = 2):
    """torch.profiler over ``n_dispatch`` decode dispatches of a busy
    engine: device kernel time per dispatch, the device's busy share of
    the wall time, and the kernels that take the most device time."""
    rows, wall = profile_calls(eng.step, n_dispatch)
    dev_us = sum(r[1] for r in rows)
    if dev_us == 0:
        return None
    attn_us = sum(t for k, t, _ in rows if "decode_cluster" in k)
    return {"wall_ms": 1e3 * wall / n_dispatch,
            "device_ms": dev_us / 1e3 / n_dispatch,
            "attn_ms": attn_us / 1e3 / n_dispatch,
            "busy": dev_us / 1e6 / wall,
            "top": [(k[:60], round(t / 1e3 / n_dispatch, 3), c // n_dispatch)
                    for k, t, c in rows[:8]]}


# --------------------------------------------------------------- phase 1-2
def phase_card():
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(f"[card] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | "
          f"devices {torch.cuda.device_count()}")
    return smi


def phase_build():
    import ctypes
    from repro_torch.kernels import build, ops
    secs = build.build_all(list(ops.KERNELS))
    for k in ops.KERNELS[:2]:        # the decode kernels' dynamic smem
        fn = k.extra("decode_smem_bytes", [ctypes.c_int] * 3)
        print(f"[build] {k.name}: dynamic smem per block (bf16 / f32) at "
              + ", ".join(f"hd {hd} q_per_kv {qpk}: {fn(1, hd, qpk)} / "
                          f"{fn(0, hd, qpk)} B"
                          for hd, qpk in ((128, 4), (128, 6), (192, 12),
                                          (64, 16))))
    for k in ops.KERNELS:
        regs = [int(x) for x in re.findall(r"Used (\d+) registers",
                                           k.build_log)]
        smem = [int(x) for x in re.findall(r"(\d+) bytes smem", k.build_log)]
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                                k.build_log))
        if not regs:
            fail(f"{k.name}: no ptxas resource report in the build log")
        print(f"[build] {k.name}: {secs[k.name]:.1f}s nvcc, "
              f"{len(regs)} entry points, registers max {max(regs)}, "
              f"smem max {max(smem, default=0)} B, spill stores total "
              f"{spills} B")


# ----------------------------------------------------------------- phase 3
def _dense_inputs(dtype, gen, b=8, s=4096, h=32, hkv=8, hd=128):
    import torch
    dev = "cuda"
    q = torch.randn((b, h, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, hkv, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, hkv, hd), generator=gen, device=dev).to(dtype)
    lens = torch.tensor([s, 3000, 2048, 1, s - 1, 777, s, 2500], device=dev)
    j = torch.arange(s, device=dev)
    valid = j[None, :] < lens[:, None]
    # a ring-window row: two disjoint valid ranges
    valid[5] = ((j >= 100) & (j < 900)) | ((j >= 2000) & (j < 2100))
    active = torch.ones(b, dtype=torch.bool, device=dev)
    active[3] = False
    return q, k, v, valid.contiguous(), active


def _paged_inputs(dtype, gen, b=8, s=4096, h=32, hkv=8, hd=128, bs=16):
    import torch
    dev = "cuda"
    nb = s // bs
    p = b * nb
    q = torch.randn((b, h, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((p, bs, hkv, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((p, bs, hkv, hd), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(p, generator=gen, device=dev)
    tables = perm.reshape(b, nb).to(torch.int32)
    seq = torch.tensor([s, 3001, 17, 1, s - 5, 777, 2048, 1200],
                       device=dev, dtype=torch.int32)
    tables[1, 0] = tables[0, 0]          # two rows alias one block
    for r in range(b):                   # stale entries past seq_len
        used = -(-int(seq[r]) // bs)
        if used < nb:
            tables[r, used:] = p + 1000 if r % 2 else -7
    active = torch.ones(b, dtype=torch.bool, device=dev)
    active[3] = False
    return q, k, v, tables.contiguous(), seq, active


# the main path's shapes: the long pool (one live row of 1,100 tokens,
# three inactive) and the short pool (four live rows of 400-500 tokens)
FLEET_SHAPES = {"long": (4096, [0, 1100, 0, 0]),
                "short": (512, [400, 433, 467, 500])}
L2_BYTES = 50e6                      # H100 L2; the timed calls rotate past it


def _fleet_inputs(dtype, gen, s, lens, h=32, hkv=8, hd=128, bs=16):
    """Dense inputs of a fleet pool (prefix rows of ``lens`` tokens; a row
    of length 0 is inactive) and the same K/V scattered into shuffled
    pages of ``bs`` tokens, so both kernels see the same tokens."""
    import torch
    dev = "cuda"
    b = len(lens)
    q = torch.randn((b, h, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, hkv, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, hkv, hd), generator=gen, device=dev).to(dtype)
    ln = torch.tensor(lens, device=dev)
    valid = torch.arange(s, device=dev)[None, :] < ln[:, None]
    active = ln > 0
    nb = s // bs
    perm = torch.randperm(b * nb, generator=gen, device=dev)
    kp = torch.empty((b * nb, bs, hkv, hd), dtype=dtype, device=dev)
    vp = torch.empty_like(kp)
    kp[perm] = k.reshape(b * nb, bs, hkv, hd)
    vp[perm] = v.reshape(b * nb, bs, hkv, hd)
    tables = perm.reshape(b, nb).to(torch.int32).contiguous()
    seq = ln.to(torch.int32)
    return (q, k, v, valid.contiguous(), active), (q, kp, vp, tables, seq,
                                                   active)


def _rotating(make, n):
    """A call that runs ``make(i)``'s closure for i = 0, 1, ..., n-1 in
    turn, so back-to-back timed calls read ``n`` distinct copies."""
    import itertools
    calls = [make(i) for i in range(n)]
    it = itertools.cycle(calls)
    return lambda: next(it)()


def phase_fleet_kernels():
    """Both decode kernels at the fleet pools' shapes, bf16 and f32:
    checked against the plain version, two calls bitwise equal, dense
    equal to paged bitwise on the same tokens, then timed. The timed
    calls rotate over enough copies of the inputs that the live K/V read
    between two uses of one copy exceeds the 50 MB L2, as on the path,
    where 32 layers and 15.5 GB of weights pass between two calls."""
    import torch
    from repro_torch.kernels import gqa_decode as D
    from repro_torch.kernels import paged_decode as PD
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        el = torch.tensor([], dtype=dtype).element_size()
        for pool, (s, lens) in FLEET_SHAPES.items():
            dense, paged = _fleet_inputs(dtype, gen, s, lens)
            q, k, v, valid, active = dense
            b, h, hd = q.shape
            hkv = k.shape[2]
            got = D.gqa_decode_cuda(*dense)
            gotp = PD.paged_gqa_decode_cuda(*paged)
            again = D.gqa_decode_cuda(*dense)
            againp = PD.paged_gqa_decode_cuda(*paged)
            ref = D.gqa_decode_plain(*dense)
            torch.cuda.synchronize()
            _check("gqa_decode", name, got, ref, active, pool)
            _check("paged_gqa_decode", name, gotp, ref, active, pool)
            if not (torch.equal(got, again) and torch.equal(gotp, againp)):
                fail(f"decode {name} {pool}: two identical calls differ")
            if not torch.equal(got, gotp):
                fail(f"decode {name} {pool}: dense and paged differ on the "
                     f"same tokens")
            tokens = int(valid[active].sum())
            live = 2 * tokens * hkv * hd * el
            n_copies = max(2, int(-(-2 * L2_BYTES // live)))
            copies = [dense] + [tuple(t.clone() for t in dense)
                                for _ in range(n_copies - 1)]
            pcopies = [paged] + [(c[0], *(t.clone() for t in paged[1:3]),
                                  *paged[3:]) for c in copies[1:]]
            dbytes = live + 2 * q.numel() * el + valid.numel() + b
            pbytes = (live + 2 * q.numel() * el + 4 * b + b
                      + 4 * sum(-(-n // 16) for n in lens))
            ops = 4 * tokens * h * hd
            for kname, fn, plain, lib, nbytes, ins in (
                    ("gqa_decode", D.gqa_decode_cuda, D.gqa_decode_plain,
                     _sdpa_dense, dbytes, copies),
                    ("paged_decode", PD.paged_gqa_decode_cuda,
                     PD.paged_gqa_decode_plain, _sdpa_paged, pbytes,
                     pcopies)):
                libs = [lib(*c) for c in ins]
                r = _time_row(
                    _rotating(lambda i: lambda: fn(*ins[i]), n_copies),
                    _rotating(lambda i: lambda: plain(*ins[i]), n_copies),
                    _rotating(lambda i: libs[i], n_copies),
                    got, ref, *_bound(nbytes, ops, name), iters=50)
                rows[(kname, name, pool)] = r
                print(f"[kernels] {kname} {name} {pool} pool (B={b}, S={s}, "
                      f"lens {lens}, {tokens} live tokens, {n_copies} "
                      f"rotated copies): max_abs_err {r['max_abs_err']:.3e} "
                      f"(limit {TOL[name] * r['ref_max']:.3e}"
                      f"{_ulp_note(name, r)}) | kernel "
                      f"{1e3 * r['ms']:.2f} us, plain {1e3 * r['plain_ms']:.2f}"
                      f" us, sdpa {1e3 * r['library_ms']:.2f} us, bound "
                      f"{1e3 * r['bound_ms']:.3f} us ({r['bound_by']}), kernel "
                      f"at {100 * r['bound_ms'] / r['ms']:.1f}% of bound; "
                      f"two calls equal, dense == paged bitwise")
            del copies, pcopies, libs
            torch.cuda.empty_cache()
    return rows


# (q_per_kv, head_dim) of registered configs the decode kernels serve
# beside minitron-8b's (4, 128): llama4-scout-17b-a16e (5, 128),
# nemotron-4-15b (6, 128), nemotron-4-340b (12, 192), and the widest
# group, (16, 64); Hkv = 8 as in all of them
HEAD_SHAPES = ((5, 128), (6, 128), (12, 192), (16, 64))


def phase_head_shapes():
    """Both decode kernels, bf16 and f32, at each of HEAD_SHAPES (B=4,
    S=4096, rows of 4079, 1100, 0 and 333 tokens): against the plain
    version, two calls bitwise equal, dense equal to paged bitwise; in
    bf16 also timed, beside minitron-8b's (4, 128) on the same rows,
    rotating over copies past the L2 as phase_fleet_kernels does."""
    import torch
    from repro_torch.kernels import gqa_decode as D
    from repro_torch.kernels import paged_decode as PD
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    s, lens = 4096, [4096 - 17, 1100, 0, 333]
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        shapes = ((4, 128),) + HEAD_SHAPES if name == "bfloat16" \
            else HEAD_SHAPES
        for qpk, hd in shapes:
            dense, paged = _fleet_inputs(dtype, gen, s, lens, h=8 * qpk,
                                         hkv=8, hd=hd)
            active = dense[4]
            got = D.gqa_decode_cuda(*dense)
            gotp = PD.paged_gqa_decode_cuda(*paged)
            again = D.gqa_decode_cuda(*dense)
            againp = PD.paged_gqa_decode_cuda(*paged)
            ref = D.gqa_decode_plain(*dense)
            torch.cuda.synchronize()
            shape = f"q_per_kv {qpk} hd {hd}"
            err, top = _check("gqa_decode", name, got, ref, active, shape)
            errp, _ = _check("paged_gqa_decode", name, gotp, ref, active,
                             shape)
            if not (torch.equal(got, again) and torch.equal(gotp, againp)):
                fail(f"decode {name} {shape}: two identical calls differ")
            if not torch.equal(got, gotp):
                fail(f"decode {name} {shape}: dense and paged differ on the "
                     f"same tokens")
            print(f"[kernels] decode {name} H={8 * qpk} Hkv=8 hd={hd} (B=4, "
                  f"S={s}, lens {lens}): max_abs_err dense {err:.3e}, paged "
                  f"{errp:.3e} (limit {TOL[name] * top:.3e}"
                  + (f", 2^-8 x max|plain| {BF16_ULP * top:.3e}"
                     if name == "bfloat16" else "")
                  + "); two calls equal, dense == paged bitwise"
                  + (_time_head_shape(dense, paged, lens)
                     if name == "bfloat16" else ""))
            del dense, paged
            torch.cuda.empty_cache()


def _time_head_shape(dense, paged, lens) -> str:
    """Device us per call of both decode kernels on ``dense`` / ``paged``
    (bf16), rotating over copies whose live K/V exceed the L2 twice,
    with the bytes bound; the text appended to the check line."""
    from repro_torch.kernels import gqa_decode as D
    from repro_torch.kernels import paged_decode as PD
    q, k = dense[0], dense[1]
    hkv, hd = k.shape[2], k.shape[3]
    live = 2 * sum(lens) * hkv * hd * k.element_size()
    n_copies = max(2, int(-(-2 * L2_BYTES // live)))
    copies = [dense] + [tuple(t.clone() for t in dense)
                        for _ in range(n_copies - 1)]
    pcopies = [paged] + [(c[0], *(t.clone() for t in paged[1:3]),
                          *paged[3:]) for c in copies[1:]]
    times = []
    for fn, ins in ((D.gqa_decode_cuda, copies),
                    (PD.paged_gqa_decode_cuda, pcopies)):
        call = _rotating(lambda i: lambda: fn(*ins[i]), n_copies)
        times.append(min(cuda_ms(call, iters=50), cuda_ms(call, iters=50)))
    bound = _bound(live + 2 * q.numel() * q.element_size(),
                   4 * sum(lens) * q.shape[1] * hd, "bfloat16")[0]
    return (f"; kernel {1e3 * times[0]:.2f} / {1e3 * times[1]:.2f} us "
            f"dense / paged ({n_copies} rotated copies), bytes bound "
            f"{1e3 * bound:.3f} us")


def phase_long_rows():
    """bf16 error of both decode kernels at the long pool's contexts: 4
    rows, one live of S - 17 tokens, at S = 16384 and 65536 (the plan's
    c_max); ~1.1 GB of K/V at 65536."""
    import torch
    from repro_torch.kernels import gqa_decode as D
    from repro_torch.kernels import paged_decode as PD
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    for s in (16384, 65536):
        lens = [0, s - 17, 0, 0]
        dense, paged = _fleet_inputs(torch.bfloat16, gen, s, lens)
        got = D.gqa_decode_cuda(*dense)
        gotp = PD.paged_gqa_decode_cuda(*paged)
        ref = D.gqa_decode_plain(*dense)
        torch.cuda.synchronize()
        err, top = _check("gqa_decode", "bfloat16", got, ref, dense[4],
                          f"S={s}")
        errp, _ = _check("paged_gqa_decode", "bfloat16", gotp, ref,
                         dense[4], f"S={s}")
        if not torch.equal(got, gotp):
            fail(f"decode bf16 S={s}: dense and paged differ")
        print(f"[kernels] decode bfloat16 long row (B=4, S={s}, lens "
              f"{lens}): max_abs_err dense {err:.3e}, paged {errp:.3e}; "
              f"max|plain| {top:.4e}; err / max|plain| {err / top:.3e} / "
              f"{errp / top:.3e} (limits 2^-8 = {BF16_ULP:.3e}, "
              f"{TOL['bfloat16']:g}); dense == paged bitwise")
        del dense, paged, got, gotp, ref
        torch.cuda.empty_cache()


def _sdpa_dense(q, k, v, valid, active):
    """F.scaled_dot_product_attention on the dense inputs (the yardstick;
    the port never calls it): a closure over the transposed views."""
    import torch.nn.functional as F
    kq, kk, vv = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
    mask = valid[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(kq, kk, vv, attn_mask=mask,
                                                  enable_gqa=True)


def _sdpa_paged(q, kp, vp, tables, seq, active):
    """SDPA on the pages gathered through the tables (gathered once,
    outside the timed call)."""
    import torch
    import torch.nn.functional as F
    b, nb = tables.shape
    bs, hkv, hd = kp.shape[1:]
    bt = tables.long().clamp(0, kp.shape[0] - 1)
    kg = kp[bt].reshape(b, nb * bs, hkv, hd).transpose(1, 2)
    vg = vp[bt].reshape(b, nb * bs, hkv, hd).transpose(1, 2)
    mask = (torch.arange(nb * bs, device=q.device)[None, :]
            < seq[:, None])[:, None, None, :]
    kq = q[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(kq, kg, vg, attn_mask=mask,
                                                  enable_gqa=True)


def _bound(b_bytes: float, ops: float, dtype_name: str):
    t_bytes = b_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels():
    """Each kernel against its plain version; returns the kernels-line
    rows (bf16, the main path's type) keyed by kernel name."""
    import torch
    from repro_torch.kernels import gqa_decode as D
    from repro_torch.kernels import paged_decode as PD
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        el = torch.tensor([], dtype=dtype).element_size()
        # -- dense ---------------------------------------------------------
        q, k, v, valid, active = _dense_inputs(dtype, gen)
        b, h, hd = q.shape
        hkv = k.shape[2]
        got = D.gqa_decode_cuda(q, k, v, valid, active)
        again = D.gqa_decode_cuda(q, k, v, valid, active)
        ref = D.gqa_decode_plain(q, k, v, valid, active)
        torch.cuda.synchronize()
        _check("gqa_decode", name, got, ref, active)
        if not torch.equal(got, again):
            fail(f"gqa_decode {name}: two identical calls differ")
        tokens = int(valid[active].sum())
        nbytes = (2 * tokens * hkv * hd * el + 2 * q.numel() * el
                  + valid.numel() + b)
        ops = 4 * tokens * h * hd
        rows[("gqa_decode", name)] = _time_row(
            lambda: D.gqa_decode_cuda(q, k, v, valid, active),
            lambda: D.gqa_decode_plain(q, k, v, valid, active),
            _sdpa_dense(q, k, v, valid, active),
            got, ref, *_bound(nbytes, ops, name))
        # -- paged ---------------------------------------------------------
        q, kp, vp, tables, seq, active = _paged_inputs(dtype, gen)
        got = PD.paged_gqa_decode_cuda(q, kp, vp, tables, seq, active)
        again = PD.paged_gqa_decode_cuda(q, kp, vp, tables, seq, active)
        ref = PD.paged_gqa_decode_plain(q, kp, vp, tables, seq, active)
        torch.cuda.synchronize()
        _check("paged_gqa_decode", name, got, ref, active)
        if not torch.equal(got, again):
            fail(f"paged_gqa_decode {name}: two identical calls differ")
        tokens = int(seq[active].sum())
        nbytes = (2 * tokens * hkv * hd * el + 2 * q.numel() * el
                  + 4 * (tables.numel() + b) + b)
        ops = 4 * tokens * h * hd
        rows[("paged_decode", name)] = _time_row(
            lambda: PD.paged_gqa_decode_cuda(q, kp, vp, tables, seq, active),
            lambda: PD.paged_gqa_decode_plain(q, kp, vp, tables, seq,
                                              active),
            _sdpa_paged(q, kp, vp, tables, seq, active),
            got, ref, *_bound(nbytes, ops, name))
    for (kname, dname), r in rows.items():
        print(f"[kernels] {kname} {dname}: max_abs_err {r['max_abs_err']:.3e}"
              f" (limit {TOL[dname] * r['ref_max']:.3e} = {TOL[dname]:g} x "
              f"max|plain| {r['ref_max']:.4f}{_ulp_note(dname, r)}) | "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"sdpa {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), kernel at "
              f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound")
    return {kname: r for (kname, dname), r in rows.items()
            if dname == "bfloat16"}


def _ulp_note(dname, r) -> str:
    """The bf16 one-ulp limit beside an error line."""
    if dname != "bfloat16":
        return ""
    return (f"; 2^-8 x max|plain| {BF16_ULP * r['ref_max']:.3e}, err = "
            f"{r['max_abs_err'] / r['ref_max']:.3e} x max|plain|")


def _check(kname, dname, got, ref, active, shape=""):
    import torch
    what = f"{kname} {dname} {shape}".rstrip()
    if not torch.isfinite(got).all():
        fail(f"{what}: non-finite output")
    if (got[~active] != 0).any():
        fail(f"{what}: inactive rows are not exact zeros")
    err = (got.float() - ref.float()).abs().max().item()
    ref_max = ref.float().abs().max().item()
    lim = TOL[dname] * ref_max
    if err > lim:
        fail(f"{what}: max abs err {err:.3e} > {lim:.3e} "
             f"({TOL[dname]:g} x max|plain| {ref_max:.4f})")
    if dname == "bfloat16" and err > BF16_ULP * ref_max:
        fail(f"{what}: max abs err {err:.3e} > one bf16 ulp at the top of "
             f"the range, 2^-8 x max|plain| = {BF16_ULP * ref_max:.3e}")
    return err, ref_max


def _time_row(kernel, plain, library, got, ref, bound_ms, bound_by,
              iters=20):
    # turns: plain, kernel, kernel, plain (and the library call between,
    # where there is one)
    p1 = cuda_ms(plain, iters=5)
    k1 = cuda_ms(kernel, iters=iters)
    lib = cuda_ms(library, iters=iters) if library is not None else None
    k2 = cuda_ms(kernel, iters=iters)
    p2 = cuda_ms(plain, iters=5)
    return {"max_abs_err": (got.float() - ref.float()).abs().max().item(),
            "ref_max": ref.float().abs().max().item(),
            "ms": min(k1, k2), "plain_ms": min(p1, p2), "library_ms": lib,
            "bound_ms": bound_ms, "bound_by": bound_by}


def _host_ms(fn, reps: int) -> float:
    """Median host milliseconds of ``fn`` over ``reps`` calls, after one."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[len(times) // 2]


def _textrank_sim(rng, n, zero_col=None):
    """Symmetric |normal| similarity matrix; ``zero_col`` empties one
    sentence's row and column (a zero column sum)."""
    import numpy as np
    m = np.abs(rng.normal(size=(n, n)))
    m = (m + m.T) / 2
    if zero_col is not None:
        m[:, zero_col] = 0.0
        m[zero_col, :] = 0.0
    return m


# TextRank's checks: one block up to N = 96 (kernels/textrank.py's
# SINGLE_MAX), a grid above, its rows staged in shared memory up to 1500
# and read from global memory every step at 2000; 1500 and 2000 with a
# zero column sum
TEXTRANK_N = ((1, None), (64, None), (96, None), (97, None), (239, None),
              (240, None), (512, None), (1024, None), (1500, 3), (2000, 5))
TEXTRANK_GRIDS = (1, 2, 4, 8, 16, 32, 64, 128)    # the sweep behind the rule


def phase_textrank():
    """TextRank kernel against its plain version (f32, limit 1e-5 x
    max|plain|), one launch a call and two calls bitwise equal, at each of
    TEXTRANK_N; the sweep over grid sizes that sets the rule in
    kernels/textrank.py; its times at N = 64, 512 and 1024; the host share
    of ``ops.textrank_scores``. Returns the kernels-line row at N = 64
    (the size of the gateway's prompts) with the largest error seen."""
    import numpy as np
    import torch
    from repro_torch.core.compression import textrank_scores_np
    from repro_torch.kernels import ops
    from repro_torch.kernels import textrank as TR
    rng = np.random.default_rng(0)
    sims, devs, max_err = {}, {}, 0.0
    for n, zero_col in TEXTRANK_N:
        sim = _textrank_sim(rng, n, zero_col)
        sims[n] = sim
        dev = devs[n] = torch.from_numpy(sim.astype(np.float32)).cuda()
        before = TR.KERNEL.launches
        got = TR.textrank_cuda(dev)
        again = TR.textrank_cuda(dev)
        ref = TR.textrank_plain(dev)
        torch.cuda.synchronize()
        if TR.KERNEL.launches != before + 2:
            fail(f"textrank N={n}: {TR.KERNEL.launches - before} launches "
                 f"for 2 calls")
        if not torch.isfinite(got).all():
            fail(f"textrank N={n}: non-finite output")
        if not torch.equal(got, again):
            fail(f"textrank N={n}: two identical calls differ")
        err = (got - ref).abs().max().item()
        ref_max = ref.abs().max().item()
        lim = TOL["float32"] * ref_max
        plan = TR.device_plan(n, dev.device)
        blk = TR.block(plan, dev.device.index)
        print(f"[kernels] textrank float32 N={n}"
              f"{' (zero column)' if zero_col is not None else ''}: "
              f"max_abs_err {err:.3e} (limit {lim:.3e} = 1e-05 x "
              f"max|plain| {ref_max:.4e}); grid {plan.grid} x "
              f"{plan.threads} threads, {plan.rows} rows a block, "
              f"{'staged' if blk.staged else 'rows from global memory'}, "
              f"{blk.smem} B smem; two calls equal")
        if err > lim:
            fail(f"textrank N={n}: max abs err {err:.3e} > {lim:.3e}")
        max_err = max(max_err, err)
    # the grid-size sweep (device ms; one launch of plan_for(n, g) each)
    devs[128] = torch.from_numpy(
        _textrank_sim(rng, 128).astype(np.float32)).cuda()
    for n in (64, 96, 128, 239, 512, 1024):
        times = []
        for g in TEXTRANK_GRIDS:
            plan = TR.plan_for(n, g)
            if plan.grid != g:
                continue
            times.append((g, plan.rows,
                          TR.block(plan, devs[n].device.index).staged,
                          cuda_ms(lambda: TR._launch(devs[n], plan))))
        print(f"[kernels] textrank N={n} grid sweep (grid, rows, staged, "
              f"ms): " + ", ".join(f"({g}, {r}, {int(st)}, {ms:.4f})"
                                   for g, r, st, ms in times)
              + f"; the rule picks {TR.device_plan(n, devs[n].device).grid}")
    rows = {}
    # the first call on a fresh stream pays one-time costs (the caching
    # allocator's first blocks for that stream): timed apart
    stream = torch.cuda.Stream()
    t0 = time.perf_counter()
    ops.textrank_scores(sims[64], device="cuda", stream=stream)
    print(f"[kernels] textrank N=64: first ops.textrank_scores call on a "
          f"new stream {1e3 * (time.perf_counter() - t0):.3f} ms")
    for n in (64, 512, 1024):
        dev = devs[n]
        # each input byte read once, the output written once; 2 N^2 f32
        # operations per step plus the column sums
        row = _time_row(lambda: TR.textrank_cuda(dev),
                        lambda: TR.textrank_plain(dev), None,
                        TR.textrank_cuda(dev), TR.textrank_plain(dev),
                        *_bound(4 * n * n + 4 * n, (2 * 30 + 1) * n * n,
                                "float32"))
        row["max_abs_err"] = max_err
        numpy_ms = _host_ms(lambda: textrank_scores_np(sims[n]),
                            50 if n == 64 else 5)
        call_ms = _host_ms(lambda: ops.textrank_scores(
            sims[n], device="cuda", stream=stream), 50)
        print(f"[kernels] textrank float32 N={n}: kernel {row['ms']:.4f} ms, "
              f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.6f} "
              f"ms ({row['bound_by']}), kernel at "
              f"{100 * row['bound_ms'] / row['ms']:.2f}% of bound, "
              f"{row['plain_ms'] / row['ms']:.2f}x the plain version; "
              f"library none (no PyTorch call computes PageRank); host: "
              f"numpy textrank_scores_np (f64) {numpy_ms:.4f} ms, "
              f"ops.textrank_scores on the card {call_ms:.4f} ms")
        rows[n] = row
        if n in (64, 1024):
            _textrank_host_split(sims[n], stream)
    return rows[64]


def _textrank_host_split(sim, stream, reps: int = 50):
    """``ops.textrank_scores``'s parts on the host clock, each ended by a
    sync: the f64 -> f32 cast, the copy to the card, the launch (host
    time of the wrapper), the kernel's wait, the copy back. Medians."""
    import numpy as np
    import torch
    from repro_torch.kernels import textrank as TR
    parts = {k: [] for k in ("cast", "copy in", "launch", "kernel wait",
                             "copy out")}
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        a = np.ascontiguousarray(sim, dtype=np.float32)
        t1 = time.perf_counter()
        with torch.cuda.stream(stream):
            d = torch.from_numpy(a).to("cuda")
            stream.synchronize()
            t2 = time.perf_counter()
            out = TR.textrank_cuda(d)
            t3 = time.perf_counter()
            stream.synchronize()
            t4 = time.perf_counter()
            out.cpu().numpy()
            t5 = time.perf_counter()
        for k, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3,
                                t5 - t4)):
            parts[k].append(1e3 * v)
    med = {k: sorted(v[1:])[reps // 2] for k, v in parts.items()}
    print(f"[kernels] textrank N={sim.shape[0]} host split of "
          f"ops.textrank_scores (ms, medians of {reps}, each part synced): "
          + ", ".join(f"{k} {v:.4f}" for k, v in med.items())
          + f"; sum {sum(med.values()):.4f}")


# ----------------------------------------------------------------- phase 4
def _stream(seed=42, n_req=6, max_new=12, l_in_max=40):
    import numpy as np
    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(n_req):
        l_in = int(rng.integers(3, l_in_max))
        reqs.append(dict(rid=rid,
                         tokens=[int(t) for t in rng.integers(1, 900, l_in)],
                         max_new_tokens=int(rng.integers(2, max_new))))
    return reqs


def _serve(cfg, params, waves, on_wave=None, **kw):
    """Serve each wave of requests once the engine is idle; returns the
    tokens by rid and the engine. ``on_wave(eng, i)`` runs after wave i."""
    from repro_torch.serving.engine import InferenceEngine, ServeRequest
    eng = InferenceEngine(cfg, params, n_max=3, c_max=128, c_chunk=16,
                          eos_id=7, **kw)
    for i, wave in enumerate(waves):
        for r in wave:
            eng.submit(ServeRequest(**r))
        eng.run_to_completion(5000)
        if on_wave is not None:
            on_wave(eng, i)
    res = eng.results
    return {rid: r.output_tokens for rid, r in sorted(res.items())}, eng


def _cpu_top2(cfg, params, history):
    """CPU logits after ``history`` (prompt + emitted prefix) through a
    fresh one-slot cache: the two top values."""
    import torch
    from repro_torch.models import model as M
    cache = M.init_cache(cfg, 1, 128, device="cpu")
    toks = torch.tensor([history])
    logits, _ = M.prefill_chunk(params, cfg, toks, cache,
                                torch.tensor([0]), torch.tensor([len(history)]))
    return torch.topk(logits[0], 2).values.tolist()


def _to_cpu(params):
    from repro_torch.training import tree
    return tree.map(lambda t: t.cpu(), params)


def phase_parity():
    import dataclasses
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("minitron-8b").reduced(),
                              dtype="float32")
    params = M.init_params(cfg, seed=0, device="cuda")
    cpu_params = _to_cpu(params)
    reqs = _stream()
    for paged in (False, True):
        kw = dict(paged=True, block_size=16) if paged else {}
        card, _ = _serve(cfg, params, [reqs], decode_k=4, **kw)
        cpu, _ = _serve(cfg, cpu_params, [reqs], decode_k=4, **kw)
        flips = _near_tie_flips(cfg, cpu_params, reqs, card, cpu,
                                f"card vs CPU, paged={paged}")
        n = sum(len(t) for t in cpu.values())
        print(f"[parity] reduced minitron-8b f32, paged={paged}, decode_k=4: "
              f"{len(cpu)} requests / {n} tokens, card == CPU "
              f"({flips} near-tie flips)")
    _prefix_cache_parity(cfg, params, cpu_params)
    del params
    torch.cuda.empty_cache()


def _near_tie_flips(cfg, cpu_params, reqs, got, want, what) -> int:
    """Count the requests whose tokens differ between ``got`` and
    ``want``; fails unless each first difference sits at a CPU near-tie
    (top-2 logits closer than 1e-5)."""
    flips = 0
    by_rid = {r["rid"]: r for r in reqs}
    for rid, toks in want.items():
        if got[rid] == toks:
            continue
        j = next((i for i, (a, b) in enumerate(zip(got[rid], toks))
                  if a != b), min(len(got[rid]), len(toks)))
        top = _cpu_top2(cfg, cpu_params, by_rid[rid]["tokens"] + toks[:j])
        print(f"[parity] {what}: rid {rid} step {j}: {got[rid][j:j+1]} vs "
              f"{toks[j:j+1]}; CPU top-2 logits {top}")
        if j >= min(len(got[rid]), len(toks)) or top[0] - top[1] >= 1e-5:
            fail(f"{what}: tokens differ away from a near-tie (rid {rid})")
        flips += 1
    return flips


def _prefix_cache_parity(cfg, params, cpu_params):
    """Four turns sharing a 3-block prefix through a paged engine with the
    prefix cache and one without, on the card. Turn 3 is the bare prefix
    (fully cached: no prefill, its first decode write is the first token
    past the shared blocks); turn 4 maps the blocks again after it. The
    tokens must match (phase 4's near-tie rule) and the shared blocks'
    bits must be unchanged from turn 1's prefill to the end."""
    import numpy as np
    import torch
    rng = np.random.default_rng(5)
    prefix = [int(t) for t in rng.integers(1, 900, 48)]
    tail = [int(t) for t in rng.integers(1, 900, 6)]
    turns = [dict(rid=0, tokens=prefix + tail[:3], max_new_tokens=6),
             dict(rid=1, tokens=prefix + tail[3:5], max_new_tokens=8),
             dict(rid=2, tokens=prefix, max_new_tokens=6),
             dict(rid=3, tokens=prefix + tail[5:], max_new_tokens=8)]
    waves = [[t] for t in turns]
    snap = {}

    def shared_bits(eng):
        blocks = sorted(eng._prefix_map.values())[:3]
        return blocks, {k: a[:, blocks].clone()
                        for k, a in eng.cache["kv"].items()}

    def on_wave(eng, i):
        if i == 0:
            snap["turn1"] = shared_bits(eng)
    kw = dict(paged=True, block_size=16, decode_k=4)
    cached, eng = _serve(cfg, params, waves, on_wave=on_wave,
                         prefix_cache=True, **kw)
    plain, _ = _serve(cfg, params, waves, **kw)
    blocks, before = snap["turn1"]
    after = {k: a[:, blocks] for k, a in eng.cache["kv"].items()}
    if len(blocks) != 3 or not all(torch.equal(before[k], after[k])
                                   for k in before):
        fail(f"prefix cache: shared blocks {blocks} changed after turn 1")
    st = eng.prefix_stats
    if st["hit_blocks"] != 9 or eng.results[2].prefill_iters != 0:
        fail(f"prefix cache: expected 9 hit blocks and a fully cached "
             f"turn 3, got {st} and {eng.results[2].prefill_iters} prefill "
             f"iterations")
    try:
        eng.assert_block_invariants()
    except AssertionError as e:
        fail(f"prefix cache: block invariants at idle: {e}")
    flips = _near_tie_flips(cfg, cpu_params, turns, cached, plain,
                            "prefix cache vs none, card")
    n = sum(len(t) for t in cached.values())
    print(f"[parity] reduced minitron-8b f32, paged + prefix cache vs paged, "
          f"on the card: {len(turns)} turns / {n} tokens equal ({flips} "
          f"near-tie flips); hit blocks {st['hit_blocks']}, prefill "
          f"iterations per turn "
          f"{[eng.results[t['rid']].prefill_iters for t in turns]}; shared "
          f"blocks {blocks} bitwise unchanged from turn 1 to the end")


# ----------------------------------------------------------------- phase 5
def fleet_args(**over):
    """``launch.serve``'s arguments for the full-width minitron-8b K=2
    fleet on the card (azure plan, decode_k 4, 64 new tokens)."""
    import argparse
    kw = dict(arch="minitron-8b", reduced=False, fleet=2, workload="azure",
              lam=1000.0, paged=False, prefix_cache=False, decode_k=4,
              spec_k=1, preemption=False, max_queue_wait=None,
              new_tokens=64, device="cuda", int8_kv=False, autoscale=False,
              http=None, smoke=False, chaos=False, replan_interval=None,
              tp=1, mesh="")
    return argparse.Namespace(**dict(kw, **over))


@contextlib.contextmanager
def _decode_timer(log, methods=("_run_decode_scan",)):
    """Time every decode-only dispatch (the engine's ``methods``) on the
    host clock, the device synchronised on both ends (the dispatch itself
    ends in a sync)."""
    import torch
    from repro_torch.serving.engine import InferenceEngine
    origs = {m: getattr(InferenceEngine, m) for m in methods}

    def wrap(orig):
        def timed(self, mask):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            before = self.decode_tokens_emitted
            orig(self, mask)
            torch.cuda.synchronize()
            log.append((time.perf_counter() - t0,
                        self.decode_tokens_emitted - before))
        return timed
    for m, orig in origs.items():
        setattr(InferenceEngine, m, wrap(orig))
    try:
        yield
    finally:
        for m, orig in origs.items():
            setattr(InferenceEngine, m, orig)


def phase_fleet():
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving.engine import ServeRequest
    tokens = {}
    launches = {}
    for paged, kernel in ((False, ops.KERNELS[0]), (True, ops.KERNELS[1])):
        args = fleet_args(paged=paged)
        torch.cuda.reset_peak_memory_stats()
        decode_log = []
        for kk in ops.KERNELS:
            kk.launches = 0
        with _decode_timer(decode_log):
            rt, results, secs = serve.serve_fleet(
                args, slots_per_pool=4, c_chunk=256, long_ctx=4096)
        counts = {kk.name: kk.launches for kk in ops.KERNELS}
        launches[kernel.name] = counts[kernel.name]
        if kernel.launches == 0:
            fail(f"paged={paged}: the main path never launched "
                 f"{kernel.name}")
        for rid, res in results.items():
            if res.timed_out or not res.output_tokens:
                fail(f"paged={paged}: request {rid} did not complete")
        tokens[paged] = {rid: r.output_tokens for rid, r in results.items()}
        dec_s = sum(t for t, _ in decode_log)
        dec_tok = sum(n for _, n in decode_log)
        out_tok = sum(len(t) for t in tokens[paged].values())
        ctx = [e.c_max for e in rt.engines.values()]
        print(f"[fleet] minitron-8b bf16 full width, paged={paged}, "
              f"contexts {ctx}, decode_k=4: {len(results)} requests, "
              f"{out_tok} tokens in {secs:.2f} s "
              f"({out_tok / secs:.1f} tokens/s end to end); decode-only "
              f"{dec_tok} tokens in {len(decode_log)} dispatches: "
              f"{dec_tok / dec_s:.1f} tokens/s, "
              f"{1e3 * dec_s / len(decode_log):.2f} ms per dispatch; "
              f"launches {counts}; max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        # a profiled window after the measured run: one more request on
        # the long pool, prefilled, then decode dispatches under the
        # profiler (its per-op cost would distort the run above)
        eng = list(rt.engines.values())[-1]
        eng.submit(ServeRequest(rid=10_000, tokens=list(range(1, 1025)),
                                max_new_tokens=64))
        while eng.slot_prefill_left[0] or eng.slot_req[0] is None:
            eng.step()
        prof = profile_decode(eng)
        if prof is None:
            print("[fleet] profiler: no device time recorded; device busy "
                  "share not measured")
        else:
            print(f"[fleet] profiled decode dispatch (1 live row, long pool):"
                  f" wall {prof['wall_ms']:.2f} ms, device kernels "
                  f"{prof['device_ms']:.2f} ms (decode attention "
                  f"{prof['attn_ms']:.2f} ms), device busy "
                  f"{100 * prof['busy']:.1f}%; top device time per dispatch "
                  f"(ms, launches): {prof['top']}")
        del rt, results, eng
        torch.cuda.empty_cache()
    same = total = 0
    for rid, toks in tokens[False].items():
        other = tokens[True][rid]
        same += sum(a == b for a, b in zip(toks, other))
        total += max(len(toks), len(other))
    print(f"[fleet] dense vs paged token agreement: {same}/{total} "
          f"({same / total:.3f}; bf16 reduction order may differ)")
    return launches


# ----------------------------------------------------------------- phase 6
@contextlib.contextmanager
def _run_timer(log):
    """Host seconds of every FleetRuntime.run call, device synchronised
    at the end."""
    import torch
    from repro_torch.serving.pools import FleetRuntime
    orig = FleetRuntime.run

    def timed(self, *a, **kw):
        t0 = time.perf_counter()
        out = orig(self, *a, **kw)
        torch.cuda.synchronize()
        log.append(time.perf_counter() - t0)
        return out
    FleetRuntime.run = timed
    try:
        yield
    finally:
        FleetRuntime.run = orig


def _in_band_requests(rt, new_tokens: int, rid0: int):
    """Four requests of varied sentences (prose and rag) and one of the
    launcher's repetitive template, each sized by the runtime's tokenizer
    so that B < L_total <= gamma * B."""
    import numpy as np
    from repro_torch.serving.pools import GatewayRequest
    b, gamma = rt.router.boundaries[0], rt.router.gammas[0]
    rng = np.random.default_rng(0)
    span = int(gamma * b) - b
    texts = [(varied_prompt(rng, b - new_tokens + int(span * f), rt.tokenizer),
              cat) for f, cat in ((0.15, "prose"), (0.4, "rag"),
                                  (0.6, "prose"), (0.9, "rag"))]
    texts.append((template_prompt(b - new_tokens + int(span * 0.75),
                                  rt.tokenizer, "inband"), "rag"))
    reqs = []
    for i, (text, cat) in enumerate(texts):
        l_total = rt.tokenizer.count(text) + new_tokens
        if not b < l_total <= gamma * b:
            fail(f"gateway: in-band request sized {l_total} outside "
                 f"({b}, {gamma * b}]")
        reqs.append(GatewayRequest(rid0 + i, text, new_tokens, category=cat))
    return reqs


def _session_turn(rt, req, log):
    """Submit one session turn and drain it; returns (decision,
    response, seconds, pinned?, hit blocks of its engine)."""
    pinned0 = rt.router.stats.affinity_pinned
    hits0 = {n: e.prefix_stats["hit_blocks"] for n, e in rt.engines.items()}
    d = rt.submit(req)
    n_runs = len(log)
    res = rt.run(max_iters=20_000)[req.rid]
    eng = rt.engines[d.pool]
    return (d, res, log[n_runs],
            rt.router.stats.affinity_pinned - pinned0,
            eng.prefix_stats["hit_blocks"] - hits0[d.pool])


def phase_gateway():
    """Returns the TextRank launches of the gateway path."""
    import numpy as np
    import torch
    from repro_torch.core.compression import ExtractiveCompressor
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving.pools import GatewayRequest
    args = fleet_args(prefix_cache=True)
    torch.cuda.reset_peak_memory_stats()
    runs = []
    t0 = time.perf_counter()
    for kk in ops.KERNELS:
        kk.launches = 0
    with _run_timer(runs):
        # the launcher's batch and its two-turn session
        rt, results, _ = serve.serve_fleet(args, slots_per_pool=4,
                                           c_chunk=256, long_ctx=4096)
        stats0 = dataclasses.replace(rt.router.stats)
        b = rt.router.boundaries[0]
        # in-band borderline requests, all at once
        inband = _in_band_requests(rt, args.new_tokens, rid0=100)
        decisions = {r.rid: rt.submit(r) for r in inband}
        inband_res = rt.run(max_iters=20_000)
        # a ~3000-token two-turn session on the long pool
        history = varied_prompt(np.random.default_rng(1), 3000,
                                rt.tokenizer)
        long_turns = [_session_turn(rt, GatewayRequest(
            200 + i, text, args.new_tokens, category="prose",
            session="long"), runs) for i, text in enumerate(
                (history, history + " Follow-up: what did the history say "
                 "about the fleet?"))]
    counts = {kk.name: kk.launches for kk in ops.KERNELS}
    secs = time.perf_counter() - t0
    st = rt.router.stats
    # -- the launcher's session: results 3 and 4, runs 1 and 2 ------------
    demo = [results[3], results[4]]
    if demo[0].pool != demo[1].pool:
        fail(f"gateway: demo session turn 2 on {demo[1].pool}, turn 1 on "
             f"{demo[0].pool}")
    demo_hits = rt.engines[demo[1].pool].prefix_stats["hit_blocks"]
    if stats0.affinity_pinned != 1 or demo_hits <= 0:
        fail(f"gateway: demo session turn 2 pinned "
             f"{stats0.affinity_pinned} times, {demo_hits} hit blocks")
    # -- in-band C&R ---------------------------------------------------------
    short = rt.router.names[0]
    for r in inband:
        d, res = decisions[r.rid], inband_res.get(r.rid)
        n_ids = len(rt.tokenizer.encode(d.compressed_text or ""))
        if not d.compressed or d.pool != short:
            fail(f"gateway: in-band request {r.rid} ({r.category}) not "
                 f"compressed to {short}: {d.pool}, compressed="
                 f"{d.compressed}")
        if d.l_total_effective > b or n_ids + r.max_output_tokens > \
                rt.engines[short].c_max:
            fail(f"gateway: request {r.rid} breaks Eq. 15: "
                 f"{d.l_total_effective} (ids {n_ids}) + L_out > B = {b}")
        if res is None or res.timed_out or not res.output_tokens \
                or res.pool != short:
            fail(f"gateway: in-band request {r.rid} did not complete on "
                 f"{short}")
    attempts = st.compression_attempts
    if counts["textrank"] < 1 or counts["textrank"] != attempts \
            or st.compressed_ok != len(inband):
        fail(f"gateway: textrank launches {counts['textrank']}, compression "
             f"attempts (all with text) {attempts}, compressed "
             f"{st.compressed_ok} of {len(inband)} in-band requests")
    # -- the long session ----------------------------------------------------
    (d1, r1, s1, _, _), (d2, r2, s2, pin2, hit2) = long_turns
    if d1.pool != rt.router.names[-1] or d2.pool != d1.pool or pin2 != 1 \
            or hit2 <= 0:
        fail(f"gateway: long session turns on {d1.pool}/{d2.pool}, turn 2 "
             f"pinned {pin2}, hit blocks {hit2}")
    for name, eng in rt.engines.items():
        if eng.busy():
            fail(f"gateway: {name} still busy at the end")
        try:
            eng.assert_block_invariants()
        except AssertionError as e:
            fail(f"gateway: {name} block invariants at idle: {e}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    # -- after the counted run: the same prompts through the numpy scorer
    # and again through the kernel, for compression time and kept sets
    kernel_c = rt.router.compressor       # scores with the kernel
    numpy_c = ExtractiveCompressor()
    agree, np_ms, k_ms, warm_ms = 0, [], [], []
    for r in inband:
        budget = b - r.max_output_tokens
        rk, rn = kernel_c.compress(r.text, budget), \
            numpy_c.compress(r.text, budget)
        np_ms.append(rn.latency_ms)
        k_ms.append(decisions[r.rid].compression_ms)
        warm_ms.append(rk.latency_ms)
        if rk.text != decisions[r.rid].compressed_text:
            fail(f"gateway: request {r.rid}: the kernel scorer's text "
                 "differs between two calls")
        n_sent = len(rn.scores)
        if rk.kept_indices == rn.kept_indices:
            agree += 1
        else:
            edge = sorted(set(rk.kept_indices) ^ set(rn.kept_indices))
            print(f"[gateway] kept-set disagreement, request {r.rid} "
                  f"({n_sent} sentences): sentences {edge} kept by one "
                  f"scorer only; composite scores (kernel, numpy): "
                  + ", ".join(f"{i}: ({rk.scores[i]:.9f}, "
                              f"{rn.scores[i]:.9f})" for i in edge))
        print(f"[gateway] request {r.rid} {r.category}: {n_sent} sentences, "
              f"L_total {rt.tokenizer.count(r.text) + r.max_output_tokens} "
              f"-> {decisions[r.rid].l_total_effective} (B {b}), kept "
              f"{len(rk.kept_indices)}, compression ms: kernel (in the "
              f"gateway) {decisions[r.rid].compression_ms:.3f}, kernel "
              f"again after the run {rk.latency_ms:.3f}, numpy "
              f"{rn.latency_ms:.3f}")
    med = lambda v: sorted(v)[len(v) // 2]   # noqa: E731
    print(f"[gateway] minitron-8b bf16 full width, paged + prefix cache, "
          f"contexts {[e.c_max for e in rt.engines.values()]}: "
          f"{len(inband)} in-band requests compressed to {short} within Eq. "
          f"15; compression_ms p50 / max: kernel {med(k_ms):.3f} / "
          f"{max(k_ms):.3f} (again after the run {med(warm_ms):.3f} / "
          f"{max(warm_ms):.3f}), numpy scorer {med(np_ms):.3f} / "
          f"{max(np_ms):.3f}; kept sets equal {agree}/{len(inband)}; "
          f"launches {counts} for {attempts} compression attempts; "
          f"{secs:.1f} s; max_memory_allocated {peak:.2f} GiB")
    print(f"[gateway] launcher session ({demo[0].pool}): prefill iterations "
          f"turn 1 {demo[0].prefill_iters}, turn 2 {demo[1].prefill_iters}; "
          f"wall turn 1 {runs[1]:.3f} s, turn 2 {runs[2]:.3f} s; turn 2 "
          f"pinned, {demo_hits} hit blocks")
    print(f"[gateway] long session ({d1.pool}, "
          f"{rt.tokenizer.count(history)} tokens of history): prefill "
          f"iterations turn 1 {r1.prefill_iters}, turn 2 {r2.prefill_iters}; "
          f"wall turn 1 {s1:.3f} s, turn 2 {s2:.3f} s; turn 2 pinned, "
          f"{hit2} hit blocks ({16 * hit2} tokens)")
    prefix = {n: e.prefix_stats for n, e in rt.engines.items()}
    print(f"[gateway] prefix stats {prefix}")
    del rt, results
    torch.cuda.empty_cache()
    return counts["textrank"]


# the paper's C&R band at the planned B* = 8192, gamma 2: prompts of
# 9,000-16,000 tokens (~20 tokens a sentence: 400-800 sentences),
# compressed to T_c = B* - L_out
PAPER_B, PAPER_LOUT = 8192, 64
PAPER_PROMPT_TOKENS = (9500, 12000, 14500)


def phase_compressor_paper_size():
    """The C&R compressor alone (no engine: the smoke's pools are scaled
    to 4096 tokens) on prompts of the paper's size, with the kernel
    scorer and the numpy scorer: kept-set agreement, compression_ms of
    each, and the host split of one scoring between ``tfidf_matrix``,
    the similarity product and TextRank."""
    import numpy as np
    import torch
    from repro_torch.core.compression import (ExtractiveCompressor,
                                              split_sentences,
                                              textrank_scores_np,
                                              tfidf_matrix)
    from repro_torch.kernels import ops
    from repro_torch.serving.tokenizer import ByteChunkTokenizer
    tok = ByteChunkTokenizer(256000)
    rng = np.random.default_rng(7)
    stream = torch.cuda.Stream()
    scorer = lambda m: ops.textrank_scores(m, device="cuda",  # noqa: E731
                                           stream=stream)
    kernel_c = ExtractiveCompressor(textrank_fn=scorer)
    numpy_c = ExtractiveCompressor()
    budget = PAPER_B - PAPER_LOUT
    kernel_c.compress(varied_prompt(rng, 9000, tok), budget)   # warm-up
    agree = 0
    for n_tok in PAPER_PROMPT_TOKENS:
        text = varied_prompt(rng, n_tok, tok)
        rk, rn = kernel_c.compress(text, budget), numpy_c.compress(text,
                                                                  budget)
        if not (rk.success and rn.success) \
                or rk.compressed_tokens > budget:
            fail(f"compressor at {n_tok} tokens: not compressed within "
                 f"{budget} (kernel {rk.compressed_tokens}, numpy "
                 f"{rn.compressed_tokens})")
        n_sent = len(rn.scores)
        if rk.kept_indices == rn.kept_indices:
            agree += 1
        else:
            edge = sorted(set(rk.kept_indices) ^ set(rn.kept_indices))
            print(f"[compressor] kept-set disagreement at {n_tok} tokens "
                  f"({n_sent} sentences): sentences {edge} kept by one "
                  f"scorer only; composite scores (kernel, numpy): "
                  + ", ".join(f"{i}: ({rk.scores[i]:.9f}, "
                              f"{rn.scores[i]:.9f})" for i in edge))
        sents = split_sentences(text)
        t0 = time.perf_counter()
        m = tfidf_matrix(sents)
        t1 = time.perf_counter()
        sim = m @ m.T
        t2 = time.perf_counter()
        scorer(sim)
        t3 = time.perf_counter()
        textrank_scores_np(sim)
        t4 = time.perf_counter()
        split = {"tfidf_matrix": t1 - t0, "m @ m.T": t2 - t1,
                 "textrank kernel call": t3 - t2,
                 "textrank numpy": t4 - t3}
        print(f"[compressor] {tok.count(text)} tokens, {n_sent} sentences, "
              f"vocab {m.shape[1]} -> budget {budget}: kept "
              f"{len(rk.kept_indices)} sentences, {rk.compressed_tokens} "
              f"tokens; compression_ms kernel scorer {rk.latency_ms:.3f}, "
              f"numpy scorer {rn.latency_ms:.3f}; split (ms) "
              + ", ".join(f"{k} {1e3 * v:.3f}" for k, v in split.items()))
    print(f"[compressor] paper-size prompts: kept sets equal {agree}/"
          f"{len(PAPER_PROMPT_TOKENS)}")


# ----------------------------------------------------------------- phase 7
# Full-width bf16 token comparisons of two paths (verify windows vs plain
# decode; loaded vs unloaded batches, other prefill buckets) hold exactly
# only where the bits are provably the same. Elsewhere both runs log the
# logits behind every token they emit (_logit_log), and the path run is
# held to the plain run's logits: wherever the two have the same history,
# the path's logits may differ from the plain run's by at most
# BF16_DRIFT_ULPS bf16 ulps of the plain top logit, over the whole
# vocabulary; a first divergence passes only where the plain run prefers
# its own token to the path's by at most BF16_GAP_ULPS = twice that (each
# of the two logits moved by the drift bound, in opposite directions).
# The largest drift read on an H100 80GB HBM3 (700 W) was 4.38 ulps in
# (b) and 3.29 in (d) (PERF.md section 6); 9 is 4.38 with a factor 2 of
# margin. A wrong history moves the logits by far more: the smoke prints
# the least drift between consecutive positions of one plain request.
BF16_DRIFT_ULPS = 9
BF16_GAP_ULPS = 2 * BF16_DRIFT_ULPS
DEVICE = "cuda"
SPEC_KS = (1, 2, 4)
AGENT_PROMPT, AGENT_NEW = 200, 64        # in-cycle prompts; 64 = 16 x 4
OVERLOAD_LENS, OVERLOAD_NEW = (1000, 2500), 64
OVERLOAD_BLOCKS = 320                    # 5120 tokens: ~2 worst cases fit
LOUT_PROMPT, LOUT_CLAIM, LOUT_HINT = 310, 1024, 16
LOUT_BLOCKS = 84          # one worst case (84 blocks) or four hints (21)
P7_LAYERS = 8             # of 32: every part but (c) is host-bound, its
                          # dispatches' time ~ the depth; the checks hold
                          # at any depth (phase 15 needs the time)
# the model's step functions the engine dispatches emit tokens from, with
# the names of their (fed tokens, positions, rows' window lengths) inputs
_STEP_ARGS = {"decode_step": ("token", "pos", "active"),
              "paged_decode_step": ("token", "pos", "active"),
              "mixed_step": ("decode_tokens", "pos", "decode_active"),
              "paged_mixed_step": ("decode_tokens", "pos", "decode_active"),
              "verify_step": ("tokens", "start_pos", "lengths"),
              "paged_verify_step": ("tokens", "start_pos", "lengths")}
_DISPATCHES = ("_run_decode", "_run_decode_scan", "_run_spec_scan",
               "_run_mixed")


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


def _full_width():
    """minitron-8b at full width (bf16) and random weights from seed 0 on
    the card."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    cfg = get_config("minitron-8b")
    return cfg, M.init_params(cfg, seed=0, device=DEVICE)


def _depth_cut(cfg, params, layers: int, arch=None):
    """``cfg``'s first ``layers`` layers at full width, registered as
    "{arch or cfg.name}-{layers}-layers" (so a launcher's ``--arch`` finds
    it), and ``params`` with its stacked layer leaves sliced (views, not
    re-drawn)."""
    from repro_torch.configs import base
    from repro_torch.training import tree
    cut = base.register(dataclasses.replace(
        cfg, num_layers=layers, name=f"{arch or cfg.name}-{layers}-layers"))
    return cut, dict(params, layers=tree.map(lambda a: a[:layers],
                                             params["layers"]))


@contextlib.contextmanager
def _logit_log(log):
    """Log the logits behind every token a serving run emits: ``log[rid]
    [j]`` is an f32 copy, on the card, of the logits the request's output
    token ``j`` was the argmax of. Patches the model's step functions to
    keep each call's (fed tokens, positions, window lengths, logits) and
    the engine's dispatches to assign them to requests after the
    dispatch's own host sync (outside _decode_timer's clock when entered
    after it). A verify-window position counts only where the drafts fed
    before it are the tokens the run emitted there."""
    import inspect
    import torch
    from repro_torch.models import model as M
    from repro_torch.serving.engine import InferenceEngine
    calls, live = [], [False]
    fns = {n: getattr(M, n) for n in _STEP_ARGS}
    disp = {m: getattr(InferenceEngine, m) for m in _DISPATCHES}

    def wrap_step(fn, names):
        sig = inspect.signature(fn)

        def step(*a, **kw):
            logits, cache = fn(*a, **kw)
            if live[0]:
                b = sig.bind(*a, **kw).arguments
                toks, pos, lens = (b.get(n) for n in names)
                if lens is None:            # decode_step's default
                    lens = torch.ones_like(pos)
                calls.append((toks, pos, lens.long(), logits if
                              logits.dim() == 3 else logits[:, None]))
            return logits, cache
        return step

    def wrap_dispatch(orig):
        def dispatch(self, *a, **kw):
            rows = {s: (self.slot_req[s].rid, self.slot_out[s],
                        len(self.slot_out[s]), int(self.slot_pos[s]))
                    for s in range(self.n_max) if self.slot_req[s] is not None}
            live[0] = True
            try:
                res = orig(self, *a, **kw)
            finally:
                live[0] = False
            for toks, pos, lens, logits in calls:
                toks, pos, lens = (t.cpu().tolist() for t in (toks, pos, lens))
                for s, (rid, out, j0, p0) in rows.items():
                    for i in range(lens[s]):
                        j = j0 + pos[s] - p0 + i
                        if j >= len(out) or toks[s][1:i + 1] != out[j - i:j]:
                            break
                        log.setdefault(rid, {})[j] = logits[s, i].to(
                            torch.float32, copy=True)
            calls.clear()
            return res
        return dispatch
    for n, fn in fns.items():
        setattr(M, n, wrap_step(fn, _STEP_ARGS[n]))
    for m, orig in disp.items():
        setattr(InferenceEngine, m, wrap_dispatch(orig))
    try:
        yield
    finally:
        for n, fn in fns.items():
            setattr(M, n, fn)
        for m, orig in disp.items():
            setattr(InferenceEngine, m, orig)


def _logged(log, rid, j, tok, what):
    """The logged logits of ``rid``'s output token ``j``; fails unless
    ``tok`` is their argmax (the log is the run's own)."""
    v = log.get(rid, {}).get(j)
    if v is None or v[tok] != v.max():
        fail(f"{what}: the logit log does not hold rid {rid} token {j}")
    return v


def _bf16_flips(plain_log, path_log, want, got, what,
                tag="spec/overload", limit=BF16_DRIFT_ULPS, out=None) -> int:
    """Hold a full-width bf16 run (``got`` tokens, ``path_log``) against
    the plain run (``want``, ``plain_log``) by the drift and near-tie rule
    above (``limit``: the drift's; None reports the drift and holds only
    the near-tie rule). Prints the plain run's top-2 gap over every
    emitted position, the largest drift where the histories agree, and
    each first divergence with the plain run's preference there. Returns
    the divergences (``out["drift"]``: the largest drift)."""
    import torch
    gaps, drift, n_drift, flips = [], 0.0, 0, 0
    for rid, toks in want.items():
        for j, t in enumerate(toks):
            top = torch.topk(_logged(plain_log, rid, j, t, what), 2).values
            top = top.tolist()
            gaps.append((top[0] - top[1]) / _bf16_ulp(top[0]))
        mine = got[rid]
        n = min(len(mine), len(toks))
        d = next((i for i in range(n) if mine[i] != toks[i]), n)
        if d == n and len(mine) != len(toks):
            fail(f"{what}: rid {rid} stopped at {len(mine)} tokens, the "
                 f"plain run at {len(toks)}")
        for j in range(min(d + 1, n)):        # the same history up to d
            p = _logged(plain_log, rid, j, toks[j], what)
            q = _logged(path_log, rid, j, mine[j], what)
            ulps = float((q - p).abs().max()) / _bf16_ulp(float(p.max()))
            drift, n_drift = max(drift, ulps), n_drift + 1
        if d < n:
            p = plain_log[rid][d]
            pref = float(p[toks[d]] - p[mine[d]])
            lim = BF16_GAP_ULPS * _bf16_ulp(float(p.max()))
            print(f"[{tag}] {what}: rid {rid} step {d}: {mine[d]} vs "
                  f"{toks[d]}; the plain run prefers its token by "
                  f"{pref:.5f} (near-tie limit {lim:.5f}), top-2 gap "
                  f"{gaps[len(gaps) - len(toks) + d]:.2f} ulps")
            if pref > lim:
                fail(f"{what}: tokens differ away from a bf16 near-tie (rid "
                     f"{rid}, step {d}, {pref:.5f} > {lim:.5f})")
            flips += 1
    # for scale: the drift a one-token shift of the history causes
    shift = sorted(float((v[j] - v[j - 1]).abs().max()) / _bf16_ulp(
        float(v[j].max())) for v in plain_log.values() for j in v
        if j - 1 in v)
    gaps.sort()
    q = lambda f: gaps[min(len(gaps) - 1, int(f * len(gaps)))]  # noqa
    print(f"[{tag}] {what}: largest |logit - plain logit| over "
          f"{n_drift} positions with the plain run's history: {drift:.2f} "
          f"bf16 ulps of the top logit (limit {limit}; a shift "
          f"of the plain history by one position: least {shift[0]:.2f}, "
          f"median {shift[len(shift) // 2]:.2f}); "
          f"plain top-2 gap over {len(gaps)} emitted positions, in ulps: min "
          f"{gaps[0]:.2f}, p10 {q(.1):.2f}, p25 {q(.25):.2f}, median "
          f"{q(.5):.2f}, p90 {q(.9):.2f}, max {gaps[-1]:.2f}; "
          f"{sum(g <= BF16_GAP_ULPS for g in gaps)}/{len(gaps)} within the "
          f"near-tie limit ({BF16_GAP_ULPS} ulps)")
    if limit is not None and drift > limit:
        fail(f"{what}: logits drift {drift:.2f} ulps from the plain run's "
             f"where the histories agree (limit {limit})")
    if out is not None:
        out["drift"] = drift
    return flips


def _reset_launches():
    from repro_torch.kernels import ops
    for k in ops.KERNELS:
        k.launches = 0


def _launch_counts(need=(), what=""):
    from repro_torch.kernels import ops
    counts = {k.name: k.launches for k in ops.KERNELS}
    for name in need:
        if counts[name] == 0:
            fail(f"{what}: the path never launched {name}")
    return counts


def _drain(eng, requests, on_step=None):
    """Submit ``requests`` (ServeRequest kwargs) and step to idle;
    ``on_step(eng)`` after every step. Returns the tokens by rid."""
    from repro_torch.serving.engine import ServeRequest
    for r in requests:
        eng.submit(ServeRequest(**r))
    while eng.busy():
        eng.step()
        if on_step is not None:
            on_step(eng)
        if eng.iteration > 100_000:
            fail("engine did not drain")
    return {rid: r.output_tokens for rid, r in sorted(eng.results.items())}


def phase_spec_overload():
    """Phase 7: speculation, overload survival and output-length-aware
    reservation on the card (module docstring)."""
    import torch
    t0 = time.perf_counter()
    cfg, base = _depth_cut(*_full_width(), P7_LAYERS)
    _spec_fleet(cfg, base)
    _spec_agent_loop(cfg, base)
    _reduced_parity()
    _overload(cfg, base)
    _lout(cfg, base)
    del base
    torch.cuda.empty_cache()
    print(f"[spec/overload] phase 7: {time.perf_counter() - t0:.1f} s")


@contextlib.contextmanager
def _request_log(log):
    """Record every ServeRequest an engine takes: rid -> prompt ids."""
    from repro_torch.serving.engine import InferenceEngine
    orig = InferenceEngine.submit

    def logged(self, req):
        log[req.rid] = list(req.tokens)
        return orig(self, req)
    InferenceEngine.submit = logged
    try:
        yield
    finally:
        InferenceEngine.submit = orig


def _spec_fleet(cfg, base):
    """(b) ``launch.serve --fleet 2 --paged --decode-k 4 --spec-k 4`` on
    ``cfg`` (registered) and its random weights ``base`` (drafts mostly
    rejected) against the same fleet at spec_k 1."""
    import torch
    from repro_torch.launch import serve
    out, launches, logs = {}, {}, {}
    for sk in (1, 4):
        _reset_launches()
        log, logs[sk] = [], {}
        with _decode_timer(log, ("_run_decode_scan", "_run_spec_scan")), \
                _logit_log(logs[sk]):
            rt, results, secs = serve.serve_fleet(
                fleet_args(arch=cfg.name, paged=True, spec_k=sk,
                           device=DEVICE),
                slots_per_pool=4, c_chunk=256, long_ctx=4096, params=base)
        launches[sk] = _launch_counts(("paged_decode",), f"fleet spec_k={sk}")
        for rid, res in results.items():
            if res.timed_out or not res.output_tokens:
                fail(f"fleet spec_k={sk}: request {rid} did not complete")
        out[sk] = {rid: r.output_tokens for rid, r in results.items()}
        dec_s, dec_tok = sum(t for t, _ in log), sum(n for _, n in log)
        spec = {n: (round(e.spec_kappa(), 4),
                    round(e.spec_acceptance_rate(), 4),
                    dict(e.spec_stats)) for n, e in rt.engines.items()}
        print(f"[spec/overload] (b) fleet {cfg.name} bf16, paged,"
              f" decode_k=4, spec_k={sk}: {len(results)} requests, "
              f"{sum(map(len, out[sk].values()))} tokens in {secs:.2f} s "
              f"(logit log included); "
              f"decode-only {dec_tok} tokens in {len(log)} dispatches "
              f"({dec_tok / max(dec_s, 1e-9):.1f} tokens/s, "
              f"{1e3 * dec_s / max(1, len(log)):.2f} ms per dispatch); "
              f"kappa / acceptance / stats {spec}; launches {launches[sk]}")
        del rt, results
    flips = _bf16_flips(logs[1], logs[4], out[1], out[4],
                        "(b) fleet spec_k=4 vs 1")
    same = sum(out[4][r] == out[1][r] for r in out[1])
    print(f"[spec/overload] (b) fleet spec_k=4 vs spec_k=1: {same}/"
          f"{len(out[1])} requests equal, {flips} first divergences at "
          f"bf16 near-ties")
    del logs
    torch.cuda.empty_cache()


def _cycle_requests(cycle, starts, l_in, max_new, **extra):
    return [dict(rid=i, tokens=[(s + j) % cycle for j in range(l_in)],
                 max_new_tokens=max_new, **extra)
            for i, s in enumerate(starts)]


def _spec_agent_loop(cfg, base):
    """(a) The agent-loop weights on ``cfg``: acceptance 1, kappa ==
    spec_k, tokens equal the spec_k = 1 run's bitwise, dense and paged."""
    import torch
    from repro_torch.serving.engine import InferenceEngine
    params = agent_loop_params(cfg, base)
    reqs = _cycle_requests(AGENT_CYCLE, (0, 11, 23, 37), AGENT_PROMPT,
                           AGENT_NEW)
    want = {r["rid"]: [(r["tokens"][-1] + 1 + j) % AGENT_CYCLE
                       for j in range(AGENT_NEW)] for r in reqs}
    for paged in (False, True):
        outs = {}
        for sk in SPEC_KS:
            _reset_launches()
            eng = InferenceEngine(cfg, params, n_max=4, c_max=4096,
                                  c_chunk=256, decode_k=4, spec_k=sk,
                                  paged=paged, eos_id=None)
            log = []
            with _decode_timer(log, ("_run_decode_scan", "_run_spec_scan")):
                outs[sk] = _drain(eng, reqs)
            counts = _launch_counts()
            kappa, acc = eng.spec_kappa(), eng.spec_acceptance_rate()
            if outs[sk] != want:
                fail(f"(a) agent loop spec_k={sk} paged={paged}: tokens are "
                     f"not the cycle")
            if sk > 1 and (acc != 1.0 or kappa != sk):
                fail(f"(a) agent loop spec_k={sk} paged={paged}: acceptance "
                     f"{acc}, kappa {kappa}; stats {eng.spec_stats}")
            dec_s, dec_tok = sum(t for t, _ in log), sum(n for _, n in log)
            print(f"[spec/overload] (a) agent loop {cfg.name} bf16, "
                  f"paged={paged}, n_max 4, c_max 4096, decode_k 4, "
                  f"spec_k={sk}: acceptance {acc:.4f}, kappa {kappa:.4f}, "
                  f"{dec_tok} decode tokens in {len(log)} dispatches: "
                  f"{dec_tok / dec_s:.1f} tokens/s, "
                  f"{1e3 * dec_s / len(log):.2f} ms per dispatch; stats "
                  f"{eng.spec_stats}; launches {counts}")
            del eng
        if not (outs[1] == outs[2] == outs[4]):
            fail(f"(a) agent loop paged={paged}: spec_k runs differ")
    del params
    torch.cuda.empty_cache()


def _drive_preempt(eng, reqs, preempt_at, mode):
    """Drain ``reqs``, preempting the last decoding slot at the first
    step from ``preempt_at`` on that has one."""
    def on_step(e):
        if e.iteration >= preempt_at and not e.overload_stats["preempted"]:
            decoding = [s for s in range(e.n_max) if e.slot_req[s]
                        is not None and not e.slot_prefill_left[s]]
            if decoding:
                e.preempt_slot(decoding[-1], mode=mode)
    out = _drain(eng, reqs, on_step)
    st = eng.overload_stats
    if st["preempted"] != 1 or eng.host_tier_blocks() != 0:
        fail(f"(c) {mode}: overload stats {st}")
    return out


def _reduced_parity():
    """(c) Reduced minitron-8b f32 on the card against the CPU (phase 4's
    rule): spec_k 4 vs plain, and swap / recompute resume vs an unloaded
    run, dense and paged, decode_k 1 and 4."""
    import dataclasses
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import InferenceEngine
    cfg = dataclasses.replace(get_config("minitron-8b").reduced(),
                              dtype="float32")
    params = M.init_params(cfg, seed=0, device=DEVICE)
    cpu_params = _to_cpu(params)
    reqs = _stream()
    _reset_launches()
    n_cases = flips = 0
    for paged in (False, True):
        kw = dict(n_max=3, c_max=128, c_chunk=16, eos_id=7)
        if paged:
            kw.update(paged=True, block_size=16)
        cpu = _drain(InferenceEngine(cfg, cpu_params, **kw), reqs)
        for dk in (1, 4):
            got = _drain(InferenceEngine(cfg, params, decode_k=dk, spec_k=4,
                                         **kw), reqs)
            flips += _near_tie_flips(cfg, cpu_params, reqs, got, cpu,
                                     f"(c) spec_k=4 decode_k={dk} "
                                     f"paged={paged}")
            for mode in ("swap", "recompute"):
                eng = InferenceEngine(cfg, params, decode_k=dk, **kw)
                got = _drive_preempt(eng, reqs, 6, mode)
                flips += _near_tie_flips(cfg, cpu_params, reqs, got, cpu,
                                         f"(c) {mode} decode_k={dk} "
                                         f"paged={paged}")
            n_cases += 3
    counts = _launch_counts(("gqa_decode", "paged_decode"), "(c)")
    print(f"[spec/overload] (c) reduced minitron-8b f32, card vs CPU: "
          f"{n_cases} runs (spec_k 4; swap and recompute resume; dense and "
          f"paged; decode_k 1 and 4) equal the CPU's unloaded plain tokens "
          f"({flips} near-tie flips); launches {counts}")
    del params
    torch.cuda.empty_cache()


def _check_restored(eng, s, state, what, pad_from=None):
    """The KV just swapped into slot ``s`` of ``eng``, read back from the
    card, equals the host copy ``state.host_kv`` bitwise (paged: the
    slot's fresh blocks; dense: its row, a VLM's cross memory included);
    a dense KV row's tail past ``pad_from`` tokens, where the host copy
    was zero-padded, is zero."""
    import torch
    leaves = eng.cache["kv"] if eng.paged else eng._row_leaves()
    for k, a in leaves.items():
        got = (a[:, eng._slot_blocks[s]] if eng.paged else a[:, s]).cpu()
        if not torch.equal(got, state.host_kv[k]):
            fail(f"{what}: the KV restored for rid {state.req.rid} differs "
                 f"from the bits swapped out ({k})")
        if pad_from is not None and not eng.paged \
                and k not in ("xk", "xv") and got[:, pad_from:].any():
            fail(f"{what}: rid {state.req.rid}'s padded tail past "
                 f"{pad_from} is not zero ({k})")


@contextlib.contextmanager
def _swap_probe(log):
    """Check each swap on the card: the host copy equals the device
    blocks it left (read by plain indexing before the swap-out), and
    after the swap-in the fresh blocks hold those bits; logs (direction,
    blocks, seconds) with the device synchronised around each call."""
    import torch
    from repro_torch.serving.engine import InferenceEngine
    out_orig, in_orig = InferenceEngine._swap_out, InferenceEngine._swap_in

    def swap_out(self, s):
        before = {k: a[:, self._slot_blocks[s]].clone()
                  for k, a in self.cache["kv"].items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = out_orig(self, s)
        torch.cuda.synchronize()
        log.append(("out", len(self._slot_blocks[s]),
                    time.perf_counter() - t0))
        if not all(torch.equal(host[k].to(a.device), a)
                   for k, a in before.items()):
            fail("(d) swap-out: the host copy differs from the device blocks")
        return host

    def swap_in(self, s, qi, state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = in_orig(self, s, qi, state)
        torch.cuda.synchronize()
        if res == "admitted":
            log.append(("in", state.n_blocks, time.perf_counter() - t0))
            _check_restored(self, s, state, "(d) swap-in")
        return res
    InferenceEngine._swap_out, InferenceEngine._swap_in = swap_out, swap_in
    try:
        yield
    finally:
        InferenceEngine._swap_out, InferenceEngine._swap_in = out_orig, in_orig


def _overload(cfg, base):
    """(d) The paged long pool of ``cfg`` under 8 requests of
    1,000-2,500 tokens that its blocks cannot all reserve: preemption
    swaps, every request completes with the unloaded run's tokens (bf16
    near-tie rule), the swapped bits come back exactly; then the same
    stream with queue-wait shedding."""
    import numpy as np
    import torch
    from repro_torch.serving.engine import InferenceEngine
    rng = np.random.default_rng(17)
    reqs = [dict(rid=i, tokens=[int(t) for t in rng.integers(
        1, cfg.vocab_size, int(rng.integers(*OVERLOAD_LENS)))],
        max_new_tokens=OVERLOAD_NEW) for i in range(8)]
    prompts = {r["rid"]: r["tokens"] for r in reqs}
    kw = dict(n_max=4, c_max=4096, c_chunk=256, paged=True, decode_k=4,
              eos_id=None)
    plain_log, path_log = {}, {}
    with _logit_log(plain_log):
        unloaded = _drain(InferenceEngine(cfg, base, **kw), reqs)
    _reset_launches()
    swaps = []
    eng = InferenceEngine(cfg, base, num_blocks=OVERLOAD_BLOCKS,
                          preemption=True, **kw)
    worst = sum(eng._worst_case_blocks(r) for r in map(_as_req, reqs))
    t0 = time.perf_counter()
    with _swap_probe(swaps), _logit_log(path_log):
        got = _drain(eng, reqs, lambda e: e.assert_block_invariants())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _launch_counts(("paged_decode",), "(d)")
    st = eng.overload_stats
    if st["swapped_out"] < 1 or st["swapped_in"] < 1:
        fail(f"(d) no swap: {st}")
    if sorted(got) != list(range(8)) or not all(map(len, got.values())):
        fail(f"(d) not every request completed: {sorted(got)}")
    if eng.host_tier_blocks() != 0:
        fail("(d) the host tier is not drained at idle")
    try:
        eng.assert_block_invariants()
    except AssertionError as e:
        fail(f"(d) block invariants at idle: {e}")
    flips = _bf16_flips(plain_log, path_log, unloaded, got,
                        "(d) overload vs unloaded")
    del plain_log, path_log
    per = {d: [1e3 * t / n for dd, n, t in swaps if dd == d and n]
           for d in ("out", "in")}
    med = lambda v: sorted(v)[len(v) // 2] if v else float("nan")  # noqa
    print(f"[spec/overload] (d) overload, {cfg.name} bf16, paged"
          f" long pool (c_max 4096, n_max 4, {OVERLOAD_BLOCKS} blocks of 16 "
          f"for {worst} worst-case blocks), 8 requests of "
          f"{min(map(len, prompts.values()))}-"
          f"{max(map(len, prompts.values()))} tokens, 64 new each, "
          f"decode_k 4: preempted {st['preempted']} (swapped out "
          f"{st['swapped_out']}, in {st['swapped_in']}, recomputed "
          f"{st['recomputed']}, {st['swapped_blocks']} blocks), hol_bypass "
          f"{st['hol_bypass']}; {secs:.2f} s (swap probe, block checks and "
          f"logit log included); swap ms per block (pageable copies) out "
          f"median {med(per['out']):.3f} over {len(per['out'])} "
          f"swaps ({sum(n for d, n, _ in swaps if d == 'out')} blocks), in "
          f"median {med(per['in']):.3f} over {len(per['in'])}; swapped "
          f"blocks bitwise restored; 8/8 complete; tokens vs unloaded: "
          f"{sum(got[r] == unloaded[r] for r in got)}/8 equal, {flips} "
          f"near-tie divergences; launches {counts}")
    # the same stream with shedding: four at once, the rest after the
    # first completion, when the queue-wait estimate exceeds 1 iteration
    eng = InferenceEngine(cfg, base, num_blocks=OVERLOAD_BLOCKS,
                          preemption=True, max_queue_wait=1.0, **kw)
    accepted = [eng.submit(_as_req(r)) for r in reqs[:4]]
    while not eng.results:
        eng.step()
    accepted += [eng.submit(_as_req(r)) for r in reqs[4:]]
    eng.run_to_completion()
    shed = [r for r in eng.results.values() if r.shed]
    done = [r for r in eng.results.values() if not r.shed
            and len(r.output_tokens) == OVERLOAD_NEW]
    if not shed or len(shed) + len(done) != len(reqs) \
            or accepted.count(False) != len(shed) \
            or any(r.output_tokens for r in shed):
        fail(f"(d) shedding: {len(shed)} shed + {len(done)} completed != "
             f"{len(reqs)} submitted (accepted {accepted})")
    print(f"[spec/overload] (d) with max_queue_wait 1.0: {len(shed)} shed + "
          f"{len(done)} completed = {len(reqs)} submitted; overload "
          f"{eng.utilization_snapshot(detail=True)}")
    del eng
    torch.cuda.empty_cache()


def _as_req(r):
    from repro_torch.serving.engine import ServeRequest
    return ServeRequest(**r)


def _lout(cfg, base):
    """(e) lout_reservation on the same pool: requests that claim 1,024
    new tokens, hint 16, and stop at an EOS of the agent-loop cycle after
    4-32: the hints admit more at once than the worst case, the overruns
    preempt and never run the pool dry, and the tokens equal the
    worst-case run's."""
    import torch
    from repro_torch.serving.engine import InferenceEngine
    params = agent_loop_params(cfg, base)
    eos = 5
    # the four admitted first stop after 32, 28, 24 and 20 tokens: the
    # two past 336 positions outgrow their 21 blocks with no headroom
    # left; then 16, 12, 8 and 4
    reqs = _cycle_requests(AGENT_CYCLE, (0, 4, 8, 12, 16, 20, 24, 28),
                           LOUT_PROMPT, LOUT_CLAIM, l_out_hint=LOUT_HINT)
    runs = {}
    for lout in (False, True):
        _reset_launches()
        eng = InferenceEngine(cfg, params, n_max=4, c_max=4096, c_chunk=256,
                              paged=True, num_blocks=LOUT_BLOCKS,
                              preemption=True, lout_reservation=lout,
                              decode_k=4, eos_id=eos)
        peak = [0]

        def on_step(e):
            peak[0] = max(peak[0], sum(r is not None for r in e.slot_req))
        got = _drain(eng, reqs, on_step)
        counts = _launch_counts(("paged_decode",), f"(e) lout={lout}")
        try:
            eng.assert_block_invariants()
        except AssertionError as e:
            fail(f"(e) block invariants at idle: {e}")
        if not all(t and t[-1] == eos for t in got.values()):
            fail(f"(e) lout={lout}: a request did not stop at its EOS")
        runs[lout] = (got, peak[0], dict(eng.overload_stats))
        print(f"[spec/overload] (e) lout_reservation={lout}, agent loop "
              f"{cfg.name} bf16, {LOUT_BLOCKS} blocks, 8 requests "
              f"of {LOUT_PROMPT} tokens claiming {LOUT_CLAIM} (hint "
              f"{LOUT_HINT}), outputs {sorted(map(len, got.values()))}: peak "
              f"concurrent admitted {peak[0]}; overload {runs[lout][2]}; "
              f"launches {counts}")
        del eng
    (worst, c_worst, _), (hint, c_hint, st) = runs[False], runs[True]
    if c_hint <= c_worst:
        fail(f"(e) hints admitted {c_hint} at once, worst case {c_worst}")
    if st["reservation_breach"] < 1 or st["preempted"] < 1:
        fail(f"(e) no breach preemption under the hints: {st}")
    if hint != worst:
        fail("(e) lout_reservation changed the tokens")
    print(f"[spec/overload] (e) peak concurrency {c_hint} with hints vs "
          f"{c_worst} worst case; {st['reservation_breach']} breaches, "
          f"{st['preempted']} preemptions, never out of blocks; tokens equal")
    del params
    torch.cuda.empty_cache()
    _lout_routing(cfg, base)


def _lout_routing(cfg, base):
    """(e) lout_routing through the phase-5 fleet (random weights): a
    450-token prompt claiming 2,000 new tokens goes long by its worst
    case, short by its predicted output length, with the budget clamped
    to the short pool's context and the prediction as its hint; it
    completes there."""
    import torch
    from repro_torch.core.planner import plan_k_pool
    from repro_torch.core.workload import get_workload
    from repro_torch.serving.config import ServingConfig
    from repro_torch.serving.pools import FleetRuntime, GatewayRequest
    plan = plan_k_pool(get_workload("azure"), lam=1000.0, t_slo=0.5, k=2)
    seen, pools = {}, {}
    for lout in (False, True):
        rt = FleetRuntime.from_plan(
            cfg, base, plan, slots_per_pool=4, c_chunk=256,
            ctx_scale=4096 / plan.pools[-1].c_max,
            config=ServingConfig(paged=True, preemption=True, decode_k=4,
                                 lout_routing=lout, lout_reservation=lout))
        text = template_prompt(450, rt.tokenizer, "lout")
        with _request_log(seen):
            pools[lout] = rt.submit(GatewayRequest(0, text, 2000)).pool
        if lout:
            _reset_launches()
            short = rt.engines[pools[lout]]
            req = short.waiting[0]
            res = rt.run(max_iters=20_000)[0]
            counts = _launch_counts(("paged_decode",), "(e) lout_routing")
            if res.timed_out or res.shed or not res.output_tokens \
                    or len(req.tokens) + req.max_new_tokens > short.c_max \
                    or len(res.output_tokens) > req.max_new_tokens:
                fail(f"(e) lout_routing: {res} for {len(req.tokens)} + "
                     f"{req.max_new_tokens} tokens in c_max {short.c_max}")
        del rt
    if pools != {False: "long", True: "short"}:
        fail(f"(e) lout_routing: pools {pools}")
    print(f"[spec/overload] (e) lout_routing through the fleet: "
          f"{len(seen[0])}-token prompt claiming 2000 goes long worst case, "
          f"short by prediction with max_new {req.max_new_tokens} (short "
          f"c_max {short.c_max}) and hint {req.l_out_hint}; "
          f"{len(res.output_tokens)} tokens; launches {counts}")
    torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 8
# full-width shapes of the batch launcher (sized by the transient scores:
# below FLASH_MIN_SEQ _sdpa holds (B, H, S, S) f32, 4.3 GB a layer at 8 x
# 2048; _flash_causal's chunk scores at 8192 are 0.54 GB)
BATCH_SHAPE = (8, 2048, 64)              # batch, prompt, new tokens
FLASH_SHAPE = (1, 8192, 8)
NEMOTRON_SHAPE = (4, 1024, 32)
INT8_REL = 0.05               # tests/test_perf_opts.py::test_int8_kv_decode_close
FLASH_TAIL = 64               # last positions compared, flash vs _sdpa


def batch_args(arch, shape, int8=False, reduced=False):
    """``launch.serve``'s batch-launcher arguments (no ``--fleet``)."""
    from repro_torch.launch import serve
    b, p, n = shape
    return serve.parse_args(
        ["--arch", arch, "--batch", str(b), "--prompt-len", str(p),
         "--new-tokens", str(n), "--device", DEVICE]
        + ["--int8-kv"] * int8 + ["--reduced"] * reduced)


def _decode_launches(cfg) -> int:
    """Decode-kernel launches of one decode step: one a layer; HYBRID one
    a shared-block application (n_groups); SSM and MLA none."""
    if cfg.mla is not None:
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.ssm.shared_attn_every
    return 0 if cfg.family == "ssm" else cfg.num_layers


def _serve_batch(args, params, tokens=None, need=(), impl="kernel",
                 frontend=None):
    """One batch-launcher run (decode attention through ``impl``; a VLM
    given ``frontend``, else the launcher's constant one) with the launch
    counts reset just before; fails unless each kernel in ``need``
    launched exactly ``_decode_launches`` times per decode step, and
    nothing else launched."""
    from repro_torch.launch import serve
    _reset_launches()
    run = serve.serve_batch(args, params=params, tokens=tokens,
                            decode_impl=impl, frontend=frontend)
    counts = _launch_counts(need, f"batch launcher {args.arch}")
    want = {k: 0 for k in counts}
    want.update({k: _decode_launches(run.cfg) * (args.new_tokens - 1)
                 for k in need})
    if counts != want:
        fail(f"batch launcher {args.arch}: launches {counts}, expected "
             f"{want}")
    return run, counts


def _run_log(run):
    """``_bf16_flips``' inputs from a batch run: row -> emitted tokens, and
    row -> {j: the f32 logits token j is the argmax of}."""
    import torch
    toks = {b: row for b, row in enumerate(run.tokens.tolist())}
    log = {b: {j: lg[b].to(torch.float32) for j, lg in enumerate(run.logits)}
           for b in toks}
    return toks, log


def _ulps(got, ref) -> float:
    """Largest |got - ref| over rows in bf16 ulps of each row's top ref
    logit."""
    return max(float((g.float() - r.float()).abs().max())
               / _bf16_ulp(float(r.float().max()))
               for g, r in zip(got.reshape(-1, got.shape[-1]),
                               ref.reshape(-1, ref.shape[-1])))


def _kernel_vs_torch(arch, params, shape, smi, what, prompt=None,
                     int8=False):
    """The batch launcher through the decode kernel and through the torch
    path on the same weights and prompts (``prompt``, or the launcher's
    own draw) and the same cache type (``int8``: the dequantized int8
    cache): the kernel launches once per layer per decode step, and the
    tokens agree under the drift and near-tie rule. Returns the kernel
    run and its launch counts."""
    args = batch_args(arch, shape, int8=int8)
    kern, counts = _serve_batch(args, params, tokens=prompt,
                                need=("gqa_decode",))
    plain, _ = _serve_batch(args, params, tokens=kern.prompt, impl="torch")
    want, plain_log = _run_log(plain)
    got, path_log = _run_log(kern)
    flips = _bf16_flips(plain_log, path_log, want, got, f"{what} kernel vs "
                        "torch path", tag="forward")
    print(f"[forward] {what}: batch {shape[0]}, prompt {shape[1]}, "
          f"{shape[2]} new tokens; kernel: prefill {kern.prefill_ms:.2f} ms, "
          f"decode {kern.decode_tok_s:.1f} tokens/s; torch path: prefill "
          f"{plain.prefill_ms:.2f} ms, decode {plain.decode_tok_s:.1f} "
          f"tokens/s; gqa_decode launches {counts['gqa_decode']} "
          f"(= {_decode_launches(kern.cfg)} x {shape[2] - 1}); {flips} "
          f"near-tie "
          f"divergences ({smi})")
    del plain, plain_log, path_log
    return kern, counts


def _teacher_forced(cfg, params, run):
    """(b) forward over prompt + emitted tokens: its logits at each
    generated position against the decode logits behind each token."""
    import torch
    from repro_torch.models import model as M
    p = run.prompt.shape[1]
    seq = torch.cat([run.prompt, run.tokens[:, :-1]], dim=1)
    logits = M.forward(params, cfg, {"tokens": seq})[0][:, p - 1:].clone()
    dec = torch.stack(run.logits, dim=1)
    drift = _ulps(dec, logits)
    agree = float((logits.argmax(-1) == run.tokens).float().mean())
    print(f"[forward] (b) teacher-forced forward over {seq.shape[1]} tokens "
          f"x {seq.shape[0]} rows vs the decode logits at every generated "
          f"position: largest |decode - forward| {drift:.2f} bf16 ulps of "
          f"the top logit (limit {BF16_DRIFT_ULPS}); forward's argmax is the "
          f"emitted token at {100 * agree:.2f}% of positions")
    if drift > BF16_DRIFT_ULPS:
        fail(f"(b) decode logits drift {drift:.2f} ulps from the "
             f"teacher-forced forward (limit {BF16_DRIFT_ULPS})")


@contextlib.contextmanager
def _count_flash(calls):
    """Count calls of layers._flash_causal."""
    from repro_torch.models import layers as L
    orig = L._flash_causal

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)
    L._flash_causal = counted
    try:
        yield
    finally:
        L._flash_causal = orig


def _flash(cfg, params, smi):
    """(c) one prompt of FLASH_SHAPE[1] tokens: forward through
    _flash_causal against the same forward with _sdpa forced, at the last
    positions; then prefill (flash) and decode through the kernel against
    the torch path."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    b, s, n = FLASH_SHAPE
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1)
    prompt = torch.randint(1, cfg.vocab_size, (b, s), generator=gen,
                           device=DEVICE)
    calls = []
    with _count_flash(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flash = M.forward(params, cfg, {"tokens": prompt})[0]
        torch.cuda.synchronize()
        t_flash = time.perf_counter() - t0
        flash = flash[:, -FLASH_TAIL:].clone()
        if len(calls) != cfg.num_layers:
            fail(f"(c) forward at S={s} took _flash_causal {len(calls)} "
                 f"times, expected {cfg.num_layers}")
        floor, L.FLASH_MIN_SEQ = L.FLASH_MIN_SEQ, 1 << 62
        try:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            dense = M.forward(params, cfg, {"tokens": prompt})[0]
            torch.cuda.synchronize()
            t_dense = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
        finally:
            L.FLASH_MIN_SEQ = floor
        dense = dense[:, -FLASH_TAIL:].clone()
        if len(calls) != cfg.num_layers:
            fail("(c) the forced _sdpa forward took _flash_causal")
        drift = _ulps(flash, dense)
        print(f"[forward] (c) forward at S={s}: _flash_causal (chunk "
              f"{L.FLASH_CHUNK}) {1e3 * t_flash:.1f} ms vs _sdpa forced "
              f"{1e3 * t_dense:.1f} ms (peak {peak:.2f} GiB); largest "
              f"|flash - sdpa| over the last {FLASH_TAIL} positions "
              f"{drift:.2f} bf16 ulps of the top logit (limit "
              f"{BF16_DRIFT_ULPS}); argmax equal at "
              f"{100 * float((flash.argmax(-1) == dense.argmax(-1)).float().mean()):.1f}%"
              f" ({smi})")
        if drift > BF16_DRIFT_ULPS:
            fail(f"(c) flash forward drifts {drift:.2f} ulps from _sdpa")
        calls.clear()
        kern, counts = _kernel_vs_torch(cfg.name, params, FLASH_SHAPE, smi,
                                        f"(c) prefill {s} + decode", prompt)
        if len(calls) != 2 * cfg.num_layers:
            fail(f"(c) the two prefills at S={s} took _flash_causal "
                 f"{len(calls)} times, expected {2 * cfg.num_layers}")
        last = _ulps(kern.logits[0], flash[:, -1])
        print(f"[forward] (c) prefill's last-token logits vs the flash "
              f"forward's at position {s - 1}: {last:.2f} bf16 ulps")
        if last > BF16_DRIFT_ULPS:
            fail(f"(c) prefill logits drift {last:.2f} ulps from forward's")
    del flash, dense, kern
    return counts


def _nbytes(tree) -> int:
    """Bytes of every tensor in a nested dict."""
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _int8_cache(cfg, params, ref, smi):
    """(d) the launcher with --int8-kv beside the bf16-cache run ``ref``:
    the kernel against the torch path on the same int8 cache under the
    drift and near-tie rule; then int8 prefill + decode fed ``ref``'s
    tokens: the last-token logits within INT8_REL of max|logit| of
    ``ref``'s."""
    import dataclasses
    from repro_torch.models import model as M
    run, counts = _kernel_vs_torch(cfg.name, params, BATCH_SHAPE, smi,
                                   "(d) minitron-8b int8 cache", ref.prompt,
                                   int8=True)
    same = float((run.tokens == ref.tokens).float().mean())
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    b, p, n = BATCH_SHAPE
    logits, cache = M.prefill(params, cfg8, {"tokens": ref.prompt,
                                             "cache_len": p + n})
    rel = []
    for t in range(n):
        want = ref.logits[t].float()
        rel.append(float((logits.float() - want).abs().max()
                         / want.abs().max()))
        if t < n - 1:
            logits, cache = M.decode_step(params, cfg8, ref.tokens[:, t:t + 1],
                                          cache, p + t)
    print(f"[forward] (d) int8 KV cache, batch {b}, prompt {p}: launcher "
          f"prefill {run.prefill_ms:.2f} ms, decode {run.decode_tok_s:.1f} "
          f"tokens/s, gqa_decode launches {counts['gqa_decode']}, tokens "
          f"equal to the bf16-cache run's at {100 * same:.2f}% of positions; "
          f"cache {_nbytes(run.cache)} B int8 vs "
          f"{_nbytes(ref.cache)} B {cfg.dtype}; fed the bf16 run's "
          f"tokens, "
          f"last-token max|dlogit| / max|logit| {rel[-1]:.4f} (largest over "
          f"the {n} positions {max(rel):.4f}; limit {INT8_REL}) ({smi})")
    if rel[-1] >= INT8_REL:
        fail(f"(d) int8 last-token logits {rel[-1]:.4f} of max|logit| from "
             f"the bf16 cache's (limit {INT8_REL})")
    return counts


def _reduced_card_vs_cpu():
    """(e) reduced minitron-8b f32, card vs CPU: forward logits within
    1e-5 of max|logit|, prefill caches alike, launcher tokens equal (fp
    and int8; a flip only at a CPU top-2 gap under 1e-5)."""
    import dataclasses
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("minitron-8b").reduced(),
                              dtype="float32")
    params = M.init_params(cfg, seed=0, device=DEVICE)
    cpu_params = _to_cpu(params)
    shape = (4, 96, 16)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(2)
    toks = torch.randint(1, cfg.vocab_size, shape[:2], generator=gen,
                         device=DEVICE)
    card = M.forward(params, cfg, {"tokens": toks})[0].cpu()
    cpu = M.forward(cpu_params, cfg, {"tokens": toks.cpu()})[0]
    err = float((card - cpu).abs().max() / cpu.abs().max())
    if err > 1e-5:
        fail(f"(e) forward logits card vs CPU {err:.3g} of max|logit|")
    flips, worst = 0, 0.0
    for int8 in (False, True):
        c = dataclasses.replace(cfg, kv_cache_dtype="int8" if int8 else "")
        batch = {"tokens": toks, "cache_len": 128}
        _, kc = M.prefill(params, c, batch)
        _, cc = M.prefill(cpu_params, c, dict(batch, tokens=toks.cpu()))
        for leaf, t in kc["kv"].items():
            got, ref = t.cpu(), cc["kv"][leaf]
            if leaf in ("k", "v") and int8:
                bad = int((got.int() - ref.int()).abs().max())
                if bad > 1:
                    fail(f"(e) int8 prefill cache {leaf}: values {bad} apart")
                continue
            d = float((got.float() - ref.float()).abs().max()
                      / ref.float().abs().max())
            worst = max(worst, d)
            if d > 1e-5:
                fail(f"(e) prefill cache {leaf} (int8={int8}) card vs CPU "
                     f"{d:.3g} of max")
        args = batch_args("minitron-8b", shape, int8=int8, reduced=True)
        _reset_launches()
        got = serve.serve_batch(args, params=params, tokens=toks)
        _launch_counts(("gqa_decode",), "(e)")
        args.device = "cpu"
        want = serve.serve_batch(args, params=cpu_params, tokens=toks.cpu())
        flips += _batch_flips(got, want, f"(e) int8={int8}")
    print(f"[forward] (e) reduced minitron-8b f32, card vs CPU: forward "
          f"logits {err:.3g} of max|logit|, prefill caches within "
          f"{worst:.3g} of max (int8 values within 1), launcher tokens equal "
          f"fp and int8 ({flips} near-tie flips)")
    del params
    torch.cuda.empty_cache()


def _batch_flips(got, want, what) -> int:
    """Rows whose tokens differ between two batch runs; fails unless each
    first difference sits at a top-2 gap under 1e-5 in ``want``'s logits."""
    import torch
    flips = 0
    for b, (g, w) in enumerate(zip(got.tokens.tolist(),
                                   want.tokens.tolist())):
        if g == w:
            continue
        j = next(i for i, (x, y) in enumerate(zip(g, w)) if x != y)
        top = torch.topk(want.logits[j][b].float(), 2).values.tolist()
        print(f"[forward] {what}: row {b} step {j}: {g[j]} vs {w[j]}; "
              f"top-2 logits {top}")
        if top[0] - top[1] >= 1e-5:
            fail(f"{what}: tokens differ away from a near-tie (row {b})")
        flips += 1
    return flips


def phase_forward(smi):
    """Phase 8: forward, prefill and the batch launcher (module
    docstring). Returns the launch counts of (a)."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    cfg, params = _full_width()
    ref, counts = _kernel_vs_torch(cfg.name, params, BATCH_SHAPE, smi,
                                   "(a) minitron-8b bf16")
    _teacher_forced(cfg, params, ref)
    _int8_cache(cfg, params, ref, smi)
    del ref
    _flash(cfg, params, smi)
    del params
    torch.cuda.empty_cache()
    _reduced_card_vs_cpu()
    cfg = get_config("nemotron-4-15b")
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, seed=0, device=DEVICE)
    run, _ = _kernel_vs_torch(cfg.name, params, NEMOTRON_SHAPE, smi,
                              f"(f) nemotron-4-15b bf16 "
                              f"({_nbytes(params) / 1e9:.2f} "
                              f"GB of weights, q_per_kv {cfg.q_per_kv})")
    print(f"[forward] (f) max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})")
    del params, run
    torch.cuda.empty_cache()
    print(f"[forward] phase 8: {time.perf_counter() - t0:.1f} s")
    return counts


# ----------------------------------------------------------------- phase 9
P9_NEW = 32                              # new tokens a request
P9_LAYERS = 8             # of 32: the phase is host-bound; its checks hold
                          # at any depth (full depth until phase 18 needed
                          # the time)
P9_SHORT = (300, 420, 360, 390, 330)     # prompt tokens: L_total <= B = 512
P9_LONG = (1500, 2500)                   # > gamma * B = 1024: the long pool
P9_INBAND = 700                          # B < L_total <= gamma * B: C&R
P9_EVENT_ROUND = 3                       # drive rounds before the event
P9_SHORT_TO = dict(n_max=2, c_max=768)   # (a): the short pool, >= B
P9_LONG_TO = dict(c_max=6144)            # (a): the long pool, n_max kept
P9_BLACKOUT_S = 1.0


def _p9_fleet(cfg, params, paged, long_ctx=4096, c_chunk=256, **skw):
    """Phase 5's fleet (``fleet_args``' azure plan, 4 slots a pool,
    c_chunk 256, contexts 512 / 4096, decode_k 4) over ``params``, as
    ``launch.serve.build_fleet_runtime`` builds it, without drawing a
    second set of weights; ``long_ctx`` and ``c_chunk``: another
    long-pool context (the boundary scaled with it, down to 2 x
    ``c_chunk``) and chunk; ``skw``: other ServingConfig fields."""
    from repro_torch.core.planner import plan_k_pool
    from repro_torch.core.workload import get_workload
    from repro_torch.serving.config import ServingConfig
    from repro_torch.serving.pools import FleetRuntime
    a = fleet_args(paged=paged)
    plan = plan_k_pool(get_workload(a.workload), lam=a.lam, t_slo=0.5,
                       k=a.fleet)
    return FleetRuntime.from_plan(
        cfg, params, plan, slots_per_pool=4, c_chunk=c_chunk,
        ctx_scale=long_ctx / plan.pools[-1].c_max,
        config=ServingConfig(paged=paged, decode_k=a.decode_k, **skw))


def _p9_requests(tokenizer):
    """Five short-band prompts (they keep the short pool's 4 slots full),
    two long ones and one in-band prompt for C&R; rids 0-4, 10-11, 20."""
    import numpy as np
    from repro_torch.serving.pools import GatewayRequest
    rng = np.random.default_rng(9)
    reqs = [GatewayRequest(i, varied_prompt(rng, n, tokenizer), P9_NEW)
            for i, n in enumerate(P9_SHORT)]
    reqs += [GatewayRequest(10 + i, varied_prompt(rng, n, tokenizer), P9_NEW)
             for i, n in enumerate(P9_LONG)]
    reqs.append(GatewayRequest(20, varied_prompt(rng, P9_INBAND, tokenizer),
                               P9_NEW, category="rag"))
    return reqs


def _p9_round(rt, event, rebuilt, rebuilt_counts):
    """One drive round: step every busy engine once. An engine that raises
    EngineDead goes to ``event.on_dead``; launches made by the steps of
    engines built mid-run (``rebuilt``, a WeakSet) are added up apart."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import EngineDead
    for name in list(rt.engines):
        eng = rt.engines[name]
        if not eng.busy():
            continue
        before = [k.launches for k in ops.KERNELS]
        try:
            eng.step()
        except EngineDead:
            if not hasattr(event, "on_dead"):
                fail(f"reprovision: pool {name} died unprompted")
            event.on_dead(rt, name, rebuilt)
        if eng in rebuilt:
            for k, b in zip(ops.KERNELS, before):
                rebuilt_counts[k.name] += k.launches - b


def _p9_serve(cfg, params, paged, log, event=None, health=False,
              keep=False, reqs=None, new=P9_NEW, **skw):
    """Serve phase 9's stream (or ``reqs(tokenizer)``'s, by its rid
    convention: 10-19 long, 20-29 in-band, the rest short; ``new`` tokens
    each) on a new
    fleet (``skw``: ``_p9_fleet``'s ``long_ctx``, ``c_chunk`` and other
    ServingConfig fields), logging the logits behind
    every emitted token into ``log`` (None: no log), driving round by round (each busy engine stepped
    once a round) until it drains. ``event.on_round(rt, rounds, rebuilt)``
    runs after every round; with ``health`` a HealthPolicy(patience=2)
    hands the pools it finds wedged to ``event.on_wedged``. Returns the
    run's tokens, rounds, launches and stats; keeps no engine unless
    ``keep``, which returns the fleet as ``rt``."""
    import weakref
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving.reconfigure import HealthPolicy
    rt = _p9_fleet(cfg, params, paged, **skw)
    short, long_ = rt.router.names[0], rt.router.names[-1]
    _reset_launches()
    rebuilt = weakref.WeakSet()
    rebuilt_counts = {k.name: 0 for k in ops.KERNELS}
    for r in (reqs or _p9_requests)(rt.tokenizer):
        d = rt.submit(r)
        want = (long_ if 10 <= r.rid < 20 else short, 20 <= r.rid < 30)
        if (d.pool, d.compressed) != want:
            fail(f"reprovision: request {r.rid} routed to {d.pool} "
                 f"(compressed={d.compressed}), not {want}")
    policy = HealthPolicy(patience=2) if health else None
    done_round, rounds = {}, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _logit_log(log) if log is not None else contextlib.nullcontext():
        while True:
            if any(e.busy() for e in rt.engines.values()):
                _p9_round(rt, event, rebuilt, rebuilt_counts)
                rounds += 1
                # (a comprehension: no loop variable keeps an engine alive)
                for rid in [rid for e in rt.engines.values()
                            for rid in e.results]:
                    done_round.setdefault(rid, rounds)
            elif event is not None and event.pending():
                time.sleep(max(0.0, event.wait_s()))
            else:
                break
            if event is not None:
                event.on_round(rt, rounds, rebuilt)
            if policy is not None:
                for name in policy.check(rt):
                    event.on_wedged(rt, name, rebuilt)
            if rounds > 2000:
                fail("reprovision: the fleet did not drain")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    res = rt.run(max_iters=1)
    for rid, r in res.items():
        if r.timed_out or r.shed or len(r.output_tokens) != new:
            fail(f"reprovision: request {rid} did not complete "
                 f"({len(r.output_tokens)} tokens, timed_out="
                 f"{r.timed_out}, shed={r.shed})")
    out = dict(tokens={rid: r.output_tokens for rid, r in sorted(
        res.items())}, rounds=rounds, done_round=done_round, secs=secs,
        stats=dict(rt.reprovision_stats), counts=_launch_counts(),
        rebuilt_counts=rebuilt_counts)
    if keep:
        out["rt"] = rt
    del rt
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _split_timer(split, fns=None):
    """Seconds of each of a reprovision's parts, the device synchronised
    around each: ``fns`` maps a key to the (owner, attribute) of the
    function timed under it; by default ``drain_checkpoint``, the engine
    build and ``_adopt_state`` (fitting each host checkpoint to the new
    geometry: a dense row padded on the host)."""
    import torch
    from repro_torch.serving import reconfigure
    from repro_torch.serving.engine import InferenceEngine
    if fns is None:
        fns = {"drain": (InferenceEngine, "drain_checkpoint"),
               "build": (reconfigure, "InferenceEngine"),
               "adopt": (reconfigure, "_adopt_state")}
    origs = {k: getattr(o, n) for k, (o, n) in fns.items()}

    def timed(fn, key):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            split[key] = split.get(key, 0.0) + time.perf_counter() - t0
            return out
        return call
    for k, (o, n) in fns.items():
        setattr(o, n, timed(origs[k], k))
    try:
        yield
    finally:
        for k, (o, n) in fns.items():
            setattr(o, n, origs[k])


@contextlib.contextmanager
def _live_kernel_hold(held, tag=None):
    """Hold each decode kernel against its plain version on the live
    inputs of its first launch at every (B, S) the run gives it (S the
    dense cache's length, or blocks_per_slot x BLOCK_S), the rebuilt
    pools' shapes among them, under phase 3's TOL and one-bf16-ulp rule.
    The launch held is the path's own, checked before the next layer
    writes the cache; the plain version launches nothing.
    ``held[(kernel, (B, S))]`` gets (max_abs_err, max|plain|); with
    ``tag`` (a callable read at each launch) the key is (kernel, (B, S),
    tag()), so a launch is held once per (shape, tag)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.gqa_decode import gqa_decode_plain
    from repro_torch.kernels.paged_decode import paged_gqa_decode_plain
    dense, paged = ops.gqa_decode, ops.paged_gqa_decode

    def hold(kname, shape, plain, q, args, out, active):
        key = (kname, shape) if tag is None else (kname, shape, tag())
        if key in held:
            return
        if active is None:
            active = torch.ones(q.shape[0], dtype=torch.bool, device=q.device)
        ref = plain(q, *args, active)
        held[key] = _check(kname, str(q.dtype).split(".")[1], out, ref,
                           active, f"live B={shape[0]} S={shape[1]}")

    def dense_call(q, k, v, valid, active=None):
        out = dense(q, k, v, valid, active)
        hold("gqa_decode", (q.shape[0], k.shape[1]), gqa_decode_plain, q,
             (k, v, valid), out, active)
        return out

    def paged_call(q, kp, vp, tables, seq, active=None):
        out = paged(q, kp, vp, tables, seq, active)
        hold("paged_decode", (q.shape[0], tables.shape[1] * kp.shape[1]),
             paged_gqa_decode_plain, q, (kp, vp, tables, seq), out, active)
        return out
    ops.gqa_decode, ops.paged_gqa_decode = dense_call, paged_call
    try:
        yield
    finally:
        ops.gqa_decode, ops.paged_gqa_decode = dense, paged


@contextlib.contextmanager
def _restore_probe(log, pad_from):
    """(b) Time every swap (device synchronised around it) and check every
    swap-in by ``_check_restored``, a dense row's tail past the context it
    was taken at (``pad_from[engine]``) included. Logs (direction, bytes,
    seconds)."""
    import torch
    from repro_torch.serving.engine import InferenceEngine
    out_orig, in_orig = InferenceEngine._swap_out, InferenceEngine._swap_in

    def swap_out(self, s):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = out_orig(self, s)
        log.append(("out", _nbytes(host), time.perf_counter() - t0))
        return host

    def swap_in(self, s, qi, state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = in_orig(self, s, qi, state)
        torch.cuda.synchronize()
        if res != "admitted":
            return res
        dt = time.perf_counter() - t0
        _check_restored(self, s, state, "(b) swap-in", pad_from.get(self))
        log.append(("in", _nbytes(state.host_kv), dt))
        return res
    InferenceEngine._swap_out, InferenceEngine._swap_in = swap_out, swap_in
    try:
        yield
    finally:
        InferenceEngine._swap_out, InferenceEngine._swap_in = out_orig, in_orig


class _Reprovision:
    """(a) After P9_EVENT_ROUND rounds the short pool goes to n_max 2 and
    c_max 768; then, once both long requests decode, the long pool to
    c_max 6144 (n_max kept). Each call is timed, split, and read for
    device memory."""

    def __init__(self, pad_from, swaps, smi):
        self.pad_from, self.swaps, self.smi = pad_from, swaps, smi
        self.calls = []

    def pending(self):
        return False

    def on_round(self, rt, rounds, rebuilt):
        long_ = rt.engines[rt.router.names[-1]]
        decoding = sum(r is not None for r in long_.slot_req) == 2 \
            and not any(long_.slot_prefill_left) and not long_.waiting
        del long_
        if rounds == P9_EVENT_ROUND and not self.calls:
            self._call(rt, rt.router.names[0], P9_SHORT_TO, rebuilt)
        elif len(self.calls) == 1 and decoding:
            self._call(rt, rt.router.names[-1], P9_LONG_TO, rebuilt)

    def _call(self, rt, pool, to, rebuilt):
        import torch
        old = rt.engines[pool]
        old_c, old_bytes = old.c_max, _nbytes(old.cache)
        del old
        n_swaps, split = len(self.swaps), {}
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with _split_timer(split):
            t0 = time.perf_counter()
            info = rt.reprovision(pool, **to)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        peak, mem1 = torch.cuda.max_memory_allocated(), \
            torch.cuda.memory_allocated()
        new = rt.engines[pool]
        new_bytes = _nbytes(new.cache)
        self.pad_from[new] = old_c
        rebuilt.add(new)
        del new
        # the old engine is gone: what is left is its cache's bytes freed
        # and the new cache's allocated (to the engines' small state)
        if abs((mem1 - mem0) - (new_bytes - old_bytes)) > 2 ** 20:
            fail(f"(a) {pool}: device memory moved by {mem1 - mem0} B, the "
                 f"caches by {new_bytes - old_bytes} B: the old engine's "
                 f"cache was not freed")
        if info["rerouted"] or info["migrated"] < info["checkpointed"] \
                or not info["checkpointed"]:
            fail(f"(a) {pool}: {info}")
        outs = [(b, t) for d, b, t in self.swaps[n_swaps:] if d == "out"]
        gib = 2.0 ** 30
        self.calls.append(dict(info, wall_ms=1e3 * wall,
                               drain_ms=1e3 * split["drain"],
                               build_ms=1e3 * split["build"],
                               adopt_ms=1e3 * split.get("adopt", 0.0)))
        print(f"[reprovision] (a) {pool} -> {to}: checkpointed "
              f"{info['checkpointed']}, migrated {info['migrated']}, "
              f"rerouted {info['rerouted']}; {1e3 * wall:.2f} ms (device "
              f"synchronised), of which drain_checkpoint "
              f"{1e3 * split['drain']:.2f} ms ({len(outs)} swap-outs of "
              f"{sum(b for b, _ in outs) / 2 ** 20:.0f} MiB, "
              f"{1e3 * sum(t for _, t in outs):.2f} ms), the engine build "
              f"{1e3 * split['build']:.2f} ms and _adopt_state "
              f"{1e3 * split.get('adopt', 0.0):.2f} ms (host checkpoints "
              f"fitted to c_max {info['c_max']}); device memory allocated "
              f"before {mem0 / gib:.3f} GiB, peak {peak / gib:.3f}, after "
              f"{mem1 / gib:.3f} (cache {old_bytes / gib:.3f} -> "
              f"{new_bytes / gib:.3f} GiB; old cache freed) ({self.smi})")


class _Crash:
    """(c) dense: FaultInjector.kill the short pool after P9_EVENT_ROUND
    rounds; (d) paged: exhaust its allocator instead. Either way the dead
    engine's device KV is filled with NaN before ``recover_pool`` (salvage
    reads host mirrors only), a new short-band submission inside the
    blackout must raise PoolDownError, and after it the same prompt and
    an in-band prompt (compressed by C&R through TextRank) are served.
    Three rounds after the recovery the long pool is wedged, for the
    HealthPolicy to find and ``recover_pool`` to rebuild in place."""

    def __init__(self, paged, texts):
        self.paged, self.texts = paged, texts
        self.recoveries, self.deadline, self.resubmitted = [], None, False
        self.recovered_at = self.wedged_at = None
        self.rounds = 0
        self.retry_after = self.textrank = None

    def pending(self):
        return self.deadline is not None and not self.resubmitted

    def wait_s(self):
        return self.deadline - time.monotonic()

    def on_round(self, rt, rounds, rebuilt):
        from repro_torch.kernels import ops
        from repro_torch.serving.pools import GatewayRequest
        from repro_torch.serving.reconfigure import FaultInjector
        self.rounds = rounds
        inj = FaultInjector(rt)
        if rounds == P9_EVENT_ROUND and not self.recoveries:
            (inj.exhaust_allocator if self.paged else inj.kill)(
                rt.router.names[0])
        if self.pending() and time.monotonic() >= self.deadline:
            self.resubmitted = True
            tr = ops.KERNELS[2].launches
            for rid, (text, cat) in ((30, self.texts[0]),
                                     (31, self.texts[20])):
                d = rt.submit(GatewayRequest(rid, text, P9_NEW, category=cat))
                if d.pool != rt.router.names[0] or d.compressed != (rid == 31):
                    fail(f"(c) after the blackout: request {rid} went to "
                         f"{d.pool} (compressed={d.compressed})")
            self.textrank = ops.KERNELS[2].launches - tr
            if self.textrank < 1:
                fail("(c) after the blackout the in-band request was not "
                     "scored by the TextRank kernel")
        if self.recovered_at is not None and self.wedged_at is None \
                and rounds >= self.recovered_at + 3:
            long_ = rt.router.names[-1]
            if not rt.engines[long_].busy():
                fail("(d) the long pool drained before the wedge")
            inj.wedge(long_)
            self.wedged_at = rounds

    def _recover(self, rt, name, rebuilt, blackout_s):
        import torch
        from repro_torch.serving.reconfigure import recover_pool
        for a in rt.engines[name].cache["kv"].values():
            a.fill_(float("nan"))             # salvage must not read it
        info = recover_pool(rt, name, blackout_s=blackout_s)
        rebuilt.add(rt.engines[name])
        if rt.reprovision_stats["engine_restarts"] != len(
                self.recoveries) + 1:
            fail(f"recover {name}: stats {rt.reprovision_stats}")
        self.recoveries.append((self.rounds, info))
        torch.cuda.synchronize()
        return info

    def on_dead(self, rt, name, rebuilt):
        from repro_torch.serving.pools import GatewayRequest
        from repro_torch.serving.reconfigure import PoolDownError
        info = self._recover(rt, name, rebuilt, P9_BLACKOUT_S)
        if info["rerouted_to"] != rt.router.names[-1]:
            fail(f"(c) recovery of {name}: {info}")
        self.recovered_at = self.rounds
        text, cat = self.texts[0]
        try:
            rt.submit(GatewayRequest(29, text, P9_NEW, category=cat))
        except PoolDownError as e:
            if e.pool != name or not e.retry_after > 0:
                fail(f"(c) blackout: {e.pool}, retry_after {e.retry_after}")
            self.retry_after = e.retry_after
        else:
            fail("(c) a submission inside the blackout was accepted")
        self.deadline = rt.pool_down_until[name]

    def on_wedged(self, rt, name, rebuilt):
        if self.wedged_at is None or name != rt.router.names[-1]:
            fail(f"(d) HealthPolicy judged {name} wedged, unprompted")
        self._recover(rt, name, rebuilt, 0.0)


def _p9_layout(cfg, params, paged, smi):
    """Phase 9 on one KV layout: the uninterrupted run, then (a)+(b) and
    (c) or (d), each held against it. Returns the launches of its runs."""
    import weakref
    from repro_torch.serving.tokenizer import ByteChunkTokenizer
    kname = "paged_decode" if paged else "gqa_decode"
    lay = "paged" if paged else "dense"
    base_log = {}
    base = _p9_serve(cfg, params, paged, base_log)
    texts = {r.rid: (r.text, r.category)
             for r in _p9_requests(ByteChunkTokenizer(cfg.vocab_size))}
    want = base["tokens"]
    print(f"[reprovision] {lay} uninterrupted: {len(want)} requests, "
          f"{base['rounds']} rounds, {base['secs']:.2f} s (logit log "
          f"included); launches {base['counts']}")
    # (a) + (b)
    swaps, pad_from, log, held = [], weakref.WeakKeyDictionary(), {}, {}
    ev = _Reprovision(pad_from, swaps, smi)
    with _restore_probe(swaps, pad_from), _live_kernel_hold(held):
        got = _p9_serve(cfg, params, paged, log, ev)
    for to in (P9_SHORT_TO, dict(n_max=4, **P9_LONG_TO)):
        if (kname, (to["n_max"], to["c_max"])) not in held:
            fail(f"(a) {lay}: {kname} never launched at the rebuilt pool's "
                 f"B={to['n_max']}, S={to['c_max']}")
    if len(ev.calls) != 2:
        fail(f"(a) {lay}: {len(ev.calls)} reprovision calls, not 2 (the "
             f"long requests never all decoded?)")
    st = got["stats"]
    if st != dict(st, rebuilds=2, engine_restarts=0, rerouted_requests=0,
                  migrated_requests=sum(c["migrated"] for c in ev.calls)):
        fail(f"(a) {lay}: reprovision_stats {st} after {ev.calls}")
    if set(got["tokens"]) != set(want):
        fail(f"(a) {lay}: completed {sorted(got['tokens'])}, not "
             f"{sorted(want)}")
    for rid in (10, 11):              # swap restore at an unchanged n_max
        if got["tokens"][rid] != want[rid]:
            fail(f"(a) {lay}: long-pool rid {rid} restored at n_max 4 "
                 f"differs from the uninterrupted run")
    flips = _bf16_flips(base_log, log, want, got["tokens"],
                        f"(a) {lay} reprovision vs uninterrupted",
                        tag="reprovision")
    del log
    ins = [(b, t) for d, b, t in swaps if d == "in"]
    outs = [(b, t) for d, b, t in swaps if d == "out"]
    if not ins or len(ins) != len(outs):
        fail(f"(b) {lay}: {len(outs)} swap-outs, {len(ins)} checked "
             f"swap-ins")
    late = {rid: got["done_round"][rid] - base["done_round"][rid]
            for rid in (10, 11)}
    ms_mib = lambda v: 1e3 * sum(t for _, t in v) / (  # noqa: E731
        sum(b for b, _ in v) / 2 ** 20)
    print(f"[reprovision] (a) {lay}: {len(want)}/{len(want)} complete, none "
          f"timed out or shed, rerouted 0; stats {st}; {got['rounds']} "
          f"rounds against {base['rounds']} uninterrupted (+"
          f"{got['rounds'] - base['rounds']}: the short pool serves 6 "
          f"requests on 2 slots after the call); long requests finish "
          f"{late} rounds later; tokens equal "
          f"{sum(got['tokens'][r] == want[r] for r in want)}/{len(want)} "
          f"(long pool exact), {flips} first divergences at bf16 near-ties")
    print(f"[reprovision] (b) {lay}: {len(ins)} swap-ins read back equal to "
          f"their host copies bitwise{'' if paged else ', padded tails zero'};"
          f" swap-out {ms_mib(outs):.3f} ms/MiB over {len(outs)} "
          f"({sum(b for b, _ in outs) / 2 ** 20:.0f} MiB), swap-in "
          f"{ms_mib(ins):.3f} ms/MiB over {len(ins)} "
          f"({sum(b for b, _ in ins) / 2 ** 20:.0f} MiB) (pageable; "
          f"{smi})")
    # (c) / (d)
    log = {}
    ev = _Crash(paged, texts)
    with _live_kernel_hold(held):
        crash = _p9_serve(cfg, params, paged, log, ev, health=True)
    what = "(d) exhaust_allocator" if paged else "(c) kill"
    if len(ev.recoveries) != 2 or not ev.resubmitted or ev.wedged_at is None:
        fail(f"{what} {lay}: recoveries {ev.recoveries}, resubmitted "
             f"{ev.resubmitted}, wedged at {ev.wedged_at}")
    if set(crash["tokens"]) != set(want) | {30, 31}:
        fail(f"{what} {lay}: completed {sorted(crash['tokens'])}")
    flips_c = _bf16_flips(base_log, log, want, crash["tokens"],
                          f"{what} {lay} vs uninterrupted",
                          tag="reprovision")
    del log, base_log
    (r1, i1), (r2, i2) = ev.recoveries
    print(f"[reprovision] {what} {lay}: the short pool died at round "
          f"{r1 + 1}, its device KV set to NaN, recover_pool moved "
          f"{i1['migrated']} requests to {i1['rerouted_to']}; a submission "
          f"in the blackout raised PoolDownError (retry_after "
          f"{ev.retry_after:.3f} s), after it the same prompt and an "
          f"in-band one (TextRank launches {ev.textrank}) were served by "
          f"short; the long pool, wedged at round {ev.wedged_at}, was found "
          f"by HealthPolicy(patience=2) at round {r2} and rebuilt in place "
          f"({i2['migrated']} requests); stats {crash['stats']}; "
          f"{len(crash['tokens'])} requests complete in {crash['rounds']} "
          f"rounds; tokens equal "
          f"{sum(crash['tokens'][r] == want[r] for r in want)}/{len(want)}, "
          f"{flips_c} first divergences at bf16 near-ties")
    for run, name in ((got, "(a)"), (crash, what)):
        if run["rebuilt_counts"][kname] == 0:
            fail(f"(e) {lay} {name}: the rebuilt engines never launched "
                 f"{kname}")
    print(f"[reprovision] (e) {lay}: {kname} held against its plain "
          f"version on the live inputs of its first launch at each shape "
          f"of (a) and {what.split()[0]} (limit {TOL['bfloat16']:g} and one "
          f"bf16 ulp of max|plain|): " + ", ".join(
              f"B={b} S={s_} err {e:.3e} ({e / m:.3e} x max|plain| {m:.3f})"
              for (_, (b, s_)), (e, m) in sorted(held.items())))
    print(f"[reprovision] (e) {lay}: launches by engines built mid-run "
          f"{got['rebuilt_counts']} in (a), {crash['rebuilt_counts']} in "
          f"{what.split()[0]}")
    total = {}
    for run in (base, got, crash):
        for k, v in run["counts"].items():
            total[k] = total.get(k, 0) + v
    return total


def phase_reprovision(smi):
    """Phase 9: live re-provisioning and crash recovery (module
    docstring). Returns the launches of its runs."""
    import torch
    t0 = time.perf_counter()
    cfg, params = _depth_cut(*_full_width(), P9_LAYERS)
    launches = {}
    for paged in (False, True):
        for k, v in _p9_layout(cfg, params, paged, smi).items():
            launches[k] = launches.get(k, 0) + v
    del params
    torch.cuda.empty_cache()
    print(f"[reprovision] phase 9: {time.perf_counter() - t0:.1f} s; "
          f"launches {launches}")
    return launches


# ---------------------------------------------------------------- phase 10
P10_NEW = 16                               # new tokens: in-band and mixed
P10_LAYERS = 8            # of 32: the gateway's checks hold at any depth
                          # (full depth until phase 18 needed the time)
P10_MIX_SHORT = (300, 360, 420, 390)       # prompt tokens of the short streams
P10_MIX_LONG = (1500, 1800, 2200, 2500)    # of the long ones (phase 9's)
P10_SMOKE = "smoke fleet serving demo " * 6          # the reference smoke's
P10_BURST = tuple(96 + 8 * i for i in range(6))      # (a) before the re-plan
P10_CHAOS = "chaos smoke fleet serving " * 4         # the reference chaos's
P10_CHAOS_NEW = 32
P10_WARM = (60, 90, 120, 150)              # (c) completed before the tick
P10_LIVE = 1500                            # (c) in flight through the tick


async def _sse_timed(host, port, body: dict):
    """POST ``body`` to /v1/completions and read the answer as it arrives.
    Returns dict(status, headers, chunks, done, at, sent, end): ``at[i]``
    is the host time chunk ``i`` arrived (perf_counter), ``sent`` when
    the request went out, ``end`` when the connection closed; a JSON
    answer (not a stream) comes back as ``body``."""
    import asyncio
    reader, writer = await asyncio.open_connection(host, port)
    payload = json.dumps(body).encode()
    sent = time.perf_counter()
    writer.write(f"POST /v1/completions HTTP/1.1\r\nHost: smoke\r\n"
                 f"Content-Length: {len(payload)}\r\n\r\n".encode()
                 + payload)
    await writer.drain()
    head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), 300)
    lines = head.decode("latin-1").split("\r\n")
    headers = {k.strip().lower(): v.strip() for k, v in
               (ln.split(":", 1) for ln in lines[1:] if ":" in ln)}
    out = dict(status=int(lines[0].split()[1]), headers=headers, chunks=[],
               at=[], done=False, sent=sent, body=None)
    if headers.get("content-type") != "text/event-stream":
        raw = await asyncio.wait_for(reader.read(), 300)
        out["body"] = json.loads(raw) if raw else None
    else:
        while True:
            try:
                ev = await asyncio.wait_for(reader.readuntil(b"\n\n"), 300)
            except asyncio.IncompleteReadError:
                break
            t = time.perf_counter()
            if ev.strip() == b"data: [DONE]":
                out["done"] = True
            elif ev.startswith(b"data: "):
                out["chunks"].append(json.loads(ev[6:]))
                out["at"].append(t)
    out["end"] = time.perf_counter()
    writer.close()
    return out


def _streamed(r, what, n_tokens=None):
    """A timed SSE answer's token ids; fails unless it is a 200 stream
    ending in a ``length`` chunk and [DONE] (with ``n_tokens`` ids)."""
    chunks = r["chunks"]
    if r["status"] != 200 or not r["done"] or not chunks \
            or chunks[-1]["choices"][0]["finish_reason"] != "length":
        fail(f"{what}: status {r['status']}, done {r['done']}, last chunk "
             f"{chunks[-1] if chunks else None}")
    ids = [t for c in chunks[:-1] for t in c["choices"][0]["token_ids"]]
    if n_tokens is not None and len(ids) != n_tokens:
        fail(f"{what}: {len(ids)} tokens, not {n_tokens}")
    return ids


def _rid(answer: dict) -> int:
    """The gateway's request id (the engine's rid) of an answer."""
    return int(answer["id"].split("-")[1])


def _ms(a, b) -> float:
    return 1e3 * (b - a)


@contextlib.contextmanager
def _tick_timer(ticks):
    """Every Replanner.tick: (ms, {pool: rids in its slots at the start},
    report, device bytes allocated before, after, the engines' cache bytes
    before, after), the device synchronised at both ends."""
    import torch
    from repro_torch.serving.replanner import Replanner
    orig = Replanner.tick

    def caches(rt):
        return sum(_nbytes(e.cache) for e in rt.engines.values())

    def timed(self):
        slots = {n: [r.rid for r in e.slot_req if r is not None]
                 for n, e in self.runtime.engines.items()}
        torch.cuda.synchronize()
        mem0, c0 = torch.cuda.memory_allocated(), caches(self.runtime)
        t0 = time.perf_counter()
        rep = orig(self)
        torch.cuda.synchronize()
        ticks.append((_ms(t0, time.perf_counter()), slots, rep, mem0,
                      torch.cuda.memory_allocated(), c0,
                      caches(self.runtime)))
        return rep
    Replanner.tick = timed
    try:
        yield
    finally:
        Replanner.tick = orig


def _p10_gateway(params, client, **over):
    """``launch.serve.serve_http`` on phase 5's fleet over ``params`` (4
    slots a pool, c_chunk 256, contexts 512 / 4096, decode_k 4), on an
    ephemeral port, with ``client(gw)`` as its client."""
    from repro_torch.launch import serve
    over = dict(dict(arch=f"minitron-8b-{P10_LAYERS}-layers"), **over)
    return serve.serve_http(fleet_args(smoke=True, **over), client=client,
                            params=params, slots_per_pool=4, c_chunk=256,
                            long_ctx=4096)


def _p10_smoke(params, smi):
    """(a) the reference smoke sequence, paged with the prefix cache."""
    import numpy as np
    from repro_torch.launch import serve
    from repro_torch.serving.metrics import render_prometheus
    log, ticks = {}, []

    async def client(gw):
        host, port = gw.host, gw.port
        st, _, body = await serve._http_call(host, port, "GET", "/health")
        h = json.loads(body)
        if st != 200 or h["status"] != "ok" or h["boundaries"] != [512]:
            fail(f"(a) /health: {st} {h}")
        r = await _sse_timed(host, port, {"prompt": P10_SMOKE,
                                          "max_tokens": 12, "stream": True})
        if r["headers"].get("content-type") != "text/event-stream":
            fail(f"(a) stream content type {r['headers']}")
        streamed = _streamed(r, "(a) SSE", 12)
        flushes = len(r["chunks"]) - 1
        if flushes < 2:
            fail(f"(a) SSE: {flushes} flushes, want > 1")
        pool = r["chunks"][-1]["fleetopt"]["pool"]
        hits0 = gw.runtime.engines[pool].prefix_stats["hit_blocks"]
        t0 = time.perf_counter()
        st, _, body = await serve._http_call(
            host, port, "POST", "/v1/completions",
            json.dumps({"prompt": P10_SMOKE, "max_tokens": 12}).encode())
        t_ns = time.perf_counter()
        offline = json.loads(body)
        if st != 200 or offline["fleetopt"]["pool"] != pool:
            fail(f"(a) non-streamed: {st} {offline}")
        st, _, body = await serve._http_call(host, port, "POST",
                                             "/v1/completions", b"{not json")
        err = json.loads(body)
        if st != 400 or err["error"]["type"] != "invalid_request_error":
            fail(f"(a) malformed body: {st} {err}")
        rng = np.random.default_rng(11)
        for n in P10_BURST:
            st, _, body = await serve._http_call(
                host, port, "POST", "/v1/completions", json.dumps(
                    {"prompt": varied_prompt(rng, n, gw.runtime.tokenizer),
                     "max_tokens": 8}).encode())
            if st != 200:
                fail(f"(a) burst: {st} {body[:200]}")
        b_before = list(gw.runtime.router.boundaries)
        t1 = time.perf_counter()
        st, _, body = await serve._http_call(host, port, "POST",
                                             "/admin/replan")
        t2 = time.perf_counter()
        rep = json.loads(body)
        b_after = list(gw.runtime.router.boundaries)
        if st != 200 or not rep["applied"] or b_after != \
                rep["boundaries_after"] or not all(
                    a < b for a, b in zip(b_after, b_before)):
            fail(f"(a) re-plan: {st}, boundaries {b_before} -> {b_after}, "
                 f"report {rep}")
        st, _, body = await serve._http_call(host, port, "GET", "/metrics")
        t3 = time.perf_counter()
        text = body.decode()
        bad = [ln for ln in text.splitlines()
               if ln and not ln.startswith("#")
               and not serve.METRIC_SAMPLE.match(ln)]
        gauge = [ln for ln in text.splitlines() if ln.startswith(
            'fleetopt_boundary_tokens{index="0"}')]
        if st != 200 or bad or not gauge or \
                int(float(gauge[0].split()[-1])) != b_after[0] or any(
                    n not in text for n in (
                        'fleetopt_dispatches_total{pool="short"}',
                        "fleetopt_replan_applied_total",
                        "fleetopt_stream_flushes_total")):
            fail(f"(a) /metrics: status {st}, bad lines {bad[:3]}, boundary "
                 f"gauge {gauge} vs {b_after}")
        async with gw._lock:
            render = []
            for _ in range(20):
                t = time.perf_counter()
                render_prometheus(gw.metrics())
                render.append(_ms(t, time.perf_counter()))
        return dict(streamed=streamed, offline=offline, pool=pool,
                    hits=gw.runtime.engines[pool].prefix_stats["hit_blocks"]
                    - hits0, ttft=_ms(r["sent"], r["at"][0]),
                    latency=_ms(r["sent"], r["end"]), flushes=flushes,
                    nonstream_ms=_ms(t0, t_ns), replan_http_ms=_ms(t1, t2),
                    metrics_http_ms=_ms(t2, t3), render_ms=sorted(render),
                    b=(b_before, b_after), rid=_rid(r["chunks"][0]),
                    lines=len(text.splitlines()))

    with _logit_log(log), _tick_timer(ticks):
        out = _p10_gateway(params, client, paged=True, prefix_cache=True)
    offline = out["offline"]["choices"][0]["token_ids"]
    same = offline == out["streamed"]
    if not same:
        if out["hits"] <= 0:
            fail(f"(a) streamed {out['streamed']} and non-streamed {offline} "
                 "ids differ at the same fixed shapes")
        # a prefix hit prefills only the uncached suffix: other shapes
        _bf16_flips({0: log[out["rid"]]}, {0: log[_rid(out["offline"])]},
                    {0: out["streamed"]}, {0: offline},
                    "(a) non-streamed (prefix hit) vs streamed", tag="gateway")
    rep = ticks[-1][2]
    print(f"[http] (a) reference smoke sequence, paged + prefix cache: "
          f"/health, SSE {out['flushes']} flushes / 12 tokens from "
          f"{out['pool']} (TTFT {out['ttft']:.2f} ms, latency "
          f"{out['latency']:.2f} ms), the same prompt non-streamed "
          f"({out['nonstream_ms']:.2f} ms) "
          f"{'equal bitwise' if same else 'held by the drift rule'} "
          f"({out['hits']} prefix-hit blocks: the repeat prefilled only "
          f"the uncached suffix), 400 invalid_request_error, a burst of "
          f"{len(P10_BURST)} prompts of {P10_BURST[0]}-{P10_BURST[-1]} "
          f"tokens, re-plan boundaries {out['b'][0]} -> {out['b'][1]} "
          f"(Replanner.tick {ticks[-1][0]:.2f} ms over window weight "
          f"{rep['window_weight']:.1f}, POST /admin/replan "
          f"{out['replan_http_ms']:.2f} ms), /metrics {out['lines']} "
          f"lines parse, the boundary gauge equal ({smi})")
    r = out["render_ms"]
    print(f"[http] (a) /metrics: render_prometheus(gw.metrics()) p50 "
          f"{r[len(r) // 2]:.3f} ms, max {r[-1]:.3f} ms over {len(r)}; "
          f"GET /metrics {out['metrics_http_ms']:.2f} ms ({smi})")
    return out


def _p10_mix(params, smi):
    """(a) the gateway's real mix, paged with the prefix cache: the five
    in-band prompts (C&R into the short pool), then eight concurrent
    streams, short and long."""
    import asyncio
    import numpy as np
    from repro_torch.kernels import ops

    async def client(gw):
        rt = gw.runtime
        b = rt.router.boundaries[0]
        tr0 = ops.KERNELS[2].launches
        att0 = rt.router.stats.compression_attempts
        inband = []
        for req in _in_band_requests(rt, P10_NEW, rid0=0):
            r = await _sse_timed(gw.host, gw.port, {
                "prompt": req.text, "max_tokens": P10_NEW, "stream": True,
                "category": req.category})
            _streamed(r, f"(a) in-band {req.category}", P10_NEW)
            ann = r["chunks"][-1]["fleetopt"]
            if not ann["compressed"] or ann["pool"] != rt.router.names[0] \
                    or ann["l_total_effective"] > b:
                fail(f"(a) in-band request not compressed into the short "
                     f"pool within Eq. 15: {ann}")
            inband.append(dict(
                l_total=rt.tokenizer.count(req.text) + P10_NEW,
                eff=ann["l_total_effective"], c_ms=ann["compression_ms"],
                ttft=_ms(r["sent"], r["at"][0]),
                latency=_ms(r["sent"], r["end"])))
        textrank = ops.KERNELS[2].launches - tr0
        attempts = rt.router.stats.compression_attempts - att0
        if textrank < len(inband) or textrank != attempts:
            fail(f"(a) TextRank launches {textrank} for {attempts} "
                 f"compression attempts, {len(inband)} in-band requests")
        rng = np.random.default_rng(10)
        texts = [varied_prompt(rng, n, rt.tokenizer)
                 for n in P10_MIX_SHORT + P10_MIX_LONG]
        t0 = time.perf_counter()
        rs = await asyncio.gather(*(_sse_timed(gw.host, gw.port, {
            "prompt": x, "max_tokens": P10_NEW, "stream": True})
            for x in texts))
        wall = time.perf_counter() - t0
        streams = []
        for i, r in enumerate(rs):
            _streamed(r, f"(a) concurrent stream {i}", P10_NEW)
            want = rt.router.names[0 if i < len(P10_MIX_SHORT) else -1]
            if r["chunks"][-1]["fleetopt"]["pool"] != want:
                fail(f"(a) concurrent stream {i} served by "
                     f"{r['chunks'][-1]['fleetopt']['pool']}, not {want}")
            streams.append(dict(ttft=_ms(r["sent"], r["at"][0]),
                                latency=_ms(r["sent"], r["end"]),
                                flushes=len(r["chunks"]) - 1,
                                prompt=rt.tokenizer.count(texts[i])))
        return dict(inband=inband, textrank=textrank, attempts=attempts,
                    streams=streams, wall=wall)

    out = _p10_gateway(params, client, paged=True, prefix_cache=True)
    med = lambda v: sorted(v)[len(v) // 2]   # noqa: E731
    ib = out["inband"]
    print(f"[http] (a) {len(ib)} in-band prompts (L_total "
          f"{min(x['l_total'] for x in ib)}-{max(x['l_total'] for x in ib)}"
          f" -> {min(x['eff'] for x in ib)}-{max(x['eff'] for x in ib)}), "
          f"each compressed into the short pool by C&R, streamed one at a "
          f"time: TTFT over HTTP p50 {med([x['ttft'] for x in ib]):.2f} ms "
          f"(max {max(x['ttft'] for x in ib):.2f}), of which compression_ms "
          f"p50 {med([x['c_ms'] for x in ib]):.3f} (max "
          f"{max(x['c_ms'] for x in ib):.3f}); latency p50 "
          f"{med([x['latency'] for x in ib]):.2f} ms; TextRank launches "
          f"{out['textrank']} for {out['attempts']} compression attempts "
          f"({smi})")
    ss = out["streams"]
    tokens = P10_NEW * len(ss)
    for cls, part in (("short", ss[:len(P10_MIX_SHORT)]),
                      ("long", ss[len(P10_MIX_SHORT):])):
        print(f"[http] (a) concurrent {cls} streams (prompts "
              f"{min(x['prompt'] for x in part)}-"
              f"{max(x['prompt'] for x in part)} tokens): TTFT over HTTP "
              f"p50 {med([x['ttft'] for x in part]):.2f} ms, max "
              f"{max(x['ttft'] for x in part):.2f}; latency p50 "
              f"{med([x['latency'] for x in part]):.2f} ms, max "
              f"{max(x['latency'] for x in part):.2f}; flushes per stream "
              f"{sorted(x['flushes'] for x in part)} ({smi})")
    print(f"[http] (a) {len(ss)} concurrent SSE streams, {tokens} tokens in "
          f"{out['wall']:.3f} s: {tokens / out['wall']:.1f} streamed "
          f"tokens/s, all finish_reason length ({smi})")
    return out


def _p10_chaos(params, smi):
    """(b) the reference chaos sequence on the dense fleet: the victim
    pool killed under a live stream after its first flush."""
    import asyncio
    from repro_torch.launch import serve
    from repro_torch.serving.reconfigure import FaultInjector
    log = {}

    async def client(gw):
        host, port = gw.host, gw.port
        body = {"prompt": P10_CHAOS, "max_tokens": P10_CHAOS_NEW}
        ref = await _sse_timed(host, port, body)
        if ref["status"] != 200:
            fail(f"(b) unfaulted run: {ref}")
        ref_ids = ref["body"]["choices"][0]["token_ids"]
        victim = ref["body"]["fleetopt"]["pool"]
        if victim != gw.runtime.router.names[0]:
            fail(f"(b) the chaos prompt went to {victim}")
        unfaulted = await _sse_timed(host, port, dict(body, stream=True))
        streamed_ref = _streamed(unfaulted, "(b) unfaulted stream",
                                 P10_CHAOS_NEW)
        task = asyncio.ensure_future(_sse_timed(host, port,
                                                dict(body, stream=True)))
        tok0, done0 = gw.tokens_streamed, gw.completions_done
        while gw.tokens_streamed == tok0 and not task.done():
            await asyncio.sleep(0.001)
        if gw.completions_done != done0:
            fail("(b) the stream finished before the kill")
        async with gw._lock:
            if len(gw._pending) != 1:
                fail(f"(b) {len(gw._pending)} requests in flight at the kill")
            n_before = next(iter(gw._pending.values())).flushed
            FaultInjector(gw.runtime).kill(victim)
            t_kill = time.perf_counter()
        while gw.runtime.reprovision_stats["engine_restarts"] < 1:
            if task.done():
                fail("(b) the drive loop never recovered the killed engine")
            await asyncio.sleep(0.001)
        t_rec = time.perf_counter()
        probe = await _sse_timed(host, port, body)
        retry_after = int(probe["headers"].get("retry-after", "0"))
        if probe["status"] != 503 or retry_after < 1 or \
                probe["body"]["error"]["type"] != "overloaded_error":
            fail(f"(b) blackout probe: {probe['status']} "
                 f"{probe['headers']} {probe['body']}")
        killed = await task
        ids = _streamed(killed, "(b) killed stream", P10_CHAOS_NEW)
        # the first chunk holding a token flushed after the kill
        n, after = 0, None
        for c, t in zip(killed["chunks"], killed["at"]):
            n += len(c["choices"][0]["token_ids"])
            if n > n_before:
                after = t
                break
        await asyncio.sleep(retry_after)
        retry = await _sse_timed(host, port, body)
        if retry["status"] != 200 or \
                retry["body"]["fleetopt"]["pool"] != victim:
            fail(f"(b) post-blackout retry: {retry}")
        st, _, raw = await serve._http_call(host, port, "GET", "/metrics")
        counters = {ln.split()[0]: float(ln.split()[-1])
                    for ln in raw.decode().splitlines()
                    if ln.startswith(("fleetopt_engine_restarts_total",
                                      "fleetopt_migrated_requests_total"))}
        if len(counters) != 2 or min(counters.values()) < 1:
            fail(f"(b) /metrics counters {counters}")
        return dict(ref_ids=ref_ids, ref_rid=_rid(ref["body"]),
                    streamed_ref=streamed_ref, ids=ids,
                    rid=_rid(killed["chunks"][0]), victim=victim,
                    final_pool=killed["chunks"][-1]["fleetopt"]["pool"],
                    retry_ids=retry["body"]["choices"][0]["token_ids"],
                    retry_after=retry_after, counters=counters,
                    kill_to_recovered=_ms(t_kill, t_rec),
                    kill_to_token=None if after is None
                    else _ms(t_kill, after), flushed_at_kill=n_before,
                    gaps=[_ms(a, b) for a, b in zip(killed["at"],
                                                    killed["at"][1:])],
                    ref_latency=_ms(ref["sent"], ref["end"]))

    with _logit_log(log):
        out = _p10_gateway(params, client, chaos=True)
    if out["streamed_ref"] != out["ref_ids"]:
        fail(f"(b) streamed {out['streamed_ref']} and non-streamed "
             f"{out['ref_ids']} ids differ at the same fixed shapes")
    if out["retry_ids"] != out["ref_ids"]:
        fail("(b) the post-blackout retry on the rebuilt engine of the same "
             "(n_max, c_max) differs from the unfaulted run")
    if out["final_pool"] == out["victim"] or out["kill_to_token"] is None:
        fail(f"(b) the killed stream finished on {out['final_pool']}, "
             f"tokens after the kill: {out['kill_to_token']}")
    flips = _bf16_flips({0: log[out["ref_rid"]]}, {0: log[out["rid"]]},
                        {0: out["ref_ids"]}, {0: out["ids"]},
                        "(b) killed stream (migrated) vs unfaulted",
                        tag="gateway")
    print(f"[http] (b) chaos, dense: streamed == non-streamed bitwise; pool "
          f"{out['victim']} killed after the stream's first flush, the "
          f"drive loop rebuilt it {out['kill_to_recovered']:.2f} ms after the "
          f"kill; the probe got 503 overloaded_error, Retry-After "
          f"{out['retry_after']} s; the killed stream completed on "
          f"{out['final_pool']} ({P10_CHAOS_NEW} tokens, "
          f"{sum(a == b for a, b in zip(out['ids'], out['ref_ids']))} equal "
          f"the unfaulted run's, {flips} first divergences at bf16 "
          f"near-ties); kill to its first post-recovery token (token "
          f"{out['flushed_at_kill'] + 1}) {out['kill_to_token']:.2f} ms, "
          f"largest gap between its chunks "
          f"{max(out['gaps']):.2f} ms; the post-blackout retry equal "
          f"bitwise; counters {out['counters']}; unfaulted latency "
          f"{out['ref_latency']:.2f} ms ({smi})")
    return out


def _p10_autoscale(params, smi):
    """(c) --autoscale on the dense fleet: a re-plan tick, forced while a
    long stream decodes, rebuilds pools under it."""
    import numpy as np
    from repro_torch.launch import serve
    log, ticks, split = {}, [], {}

    async def client(gw):
        import asyncio
        import torch
        rt = gw.runtime
        rng = np.random.default_rng(12)
        live = varied_prompt(rng, P10_LIVE, rt.tokenizer)
        body = {"prompt": live, "max_tokens": P10_CHAOS_NEW}
        ref = await _sse_timed(gw.host, gw.port, body)
        if ref["status"] != 200 or \
                ref["body"]["fleetopt"]["pool"] != rt.router.names[-1]:
            fail(f"(c) the live prompt's unfaulted run: {ref['status']} "
                 f"{ref['body'] and ref['body'].get('fleetopt')}")
        for n in P10_WARM:
            r = await _sse_timed(gw.host, gw.port, {
                "prompt": varied_prompt(rng, n, rt.tokenizer),
                "max_tokens": 8})
            if r["status"] != 200:
                fail(f"(c) warm-up request: {r}")
        task = asyncio.ensure_future(_sse_timed(gw.host, gw.port,
                                                dict(body, stream=True)))
        tok0 = gw.tokens_streamed
        while gw.tokens_streamed == tok0 and not task.done():
            await asyncio.sleep(0.001)
        t0 = time.perf_counter()
        st, _, raw = await serve._http_call(gw.host, gw.port, "POST",
                                            "/admin/replan")
        t1 = time.perf_counter()
        rep = json.loads(raw)
        shapes = {n: (e.n_max, e.c_max) for n, e in rt.engines.items()}
        stream = await task
        torch.cuda.synchronize()
        mem_end = torch.cuda.memory_allocated()
        st2, _, raw = await serve._http_call(gw.host, gw.port, "GET",
                                             "/metrics")
        acts = [ln for ln in raw.decode().splitlines()
                if ln.startswith("fleetopt_autoscale_actions_total")]
        return dict(ref_ids=ref["body"]["choices"][0]["token_ids"],
                    ref_rid=_rid(ref["body"]), rep=rep, status=st,
                    replan_http_ms=_ms(t0, t1), shapes=shapes,
                    stream=stream, acts=acts, stats=dict(
                        rt.reprovision_stats), mem_end=mem_end,
                    lam=gw.replanner.lam_estimate())

    with _logit_log(log), _tick_timer(ticks), _split_timer(split):
        out = _p10_gateway(params, client, autoscale=True)
    rep, stream = out["rep"], out["stream"]
    ids = _streamed(stream, "(c) the stream through the tick", P10_CHAOS_NEW)
    rid = _rid(stream["chunks"][0])
    ms, slots, _, mem0, mem1, cache0, cache1 = ticks[-1]
    long_ = list(out["shapes"])[-1]
    actions = rep.get("autoscale_actions") or []
    if out["status"] != 200 or rid not in slots[long_] or not any(
            f" {long_} " in f" {a} " for a in actions):
        fail(f"(c) the tick (status {out['status']}) took actions {actions} "
             f"with {slots} in the slots: none rebuilt the pool of stream "
             f"{rid}")
    if not out["acts"] or float(out["acts"][0].split()[-1]) < 1 or \
            out["stats"]["autoscale_actions"] != len(actions):
        fail(f"(c) autoscale counters {out['acts']}, stats {out['stats']}")
    if out["shapes"][long_][0] == 4:
        fail(f"(c) the long pool kept n_max 4: {out['shapes']}")
    flips = _bf16_flips({0: log[out["ref_rid"]]}, {0: log[rid]},
                        {0: out["ref_ids"]}, {0: ids},
                        "(c) stream migrated by the autoscaler vs unfaulted",
                        tag="gateway")
    gaps = [_ms(a, b) for a, b in zip(stream["at"], stream["at"][1:])]
    gib = 2.0 ** 30
    # the old caches are freed by the drive loop's next pass: its loop
    # variable holds the engine it last stepped through the tick (the
    # logit log adds ~1 MiB a token meanwhile)
    if out["mem_end"] - mem0 > cache1 - cache0 + 64 * 2 ** 20:
        fail(f"(c) device memory {mem0 / gib:.3f} -> {out['mem_end'] / gib:.3f}"
             f" GiB once the stream completed; the caches went "
             f"{cache0 / gib:.3f} -> {cache1 / gib:.3f} GiB")
    print(f"[http] (c) --autoscale, dense: POST /admin/replan while stream "
          f"{rid} decoded on {long_} (lam_estimate {out['lam']:.3f} req/s "
          f"against the plan's 1000): {len(actions)} actions {actions}; "
          f"pools now {out['shapes']}, boundaries {rep['boundaries_before']}"
          f" -> {rep['boundaries_after']}; stats {out['stats']}")
    print(f"[http] (c) the tick took {ms:.2f} ms with its rebuilds under the "
          f"gateway lock (drain_checkpoint {1e3 * split.get('drain', 0):.2f} "
          f"ms, engine builds {1e3 * split.get('build', 0):.2f} ms, "
          f"_adopt_state {1e3 * split.get('adopt', 0):.2f} ms; POST "
          f"/admin/replan {out['replan_http_ms']:.2f} ms); the stream's "
          f"largest gap between chunks {max(gaps):.2f} ms (median "
          f"{sorted(gaps)[len(gaps) // 2]:.2f}); device memory allocated "
          f"{mem0 / gib:.3f} GiB before the tick, {mem1 / gib:.3f} right "
          f"after it, {out['mem_end'] / gib:.3f} once the stream completed "
          f"(caches {cache0 / gib:.3f} -> {cache1 / gib:.3f} GiB); the "
          f"stream completed "
          f"({P10_CHAOS_NEW} tokens, {sum(a == b for a, b in zip(ids, out['ref_ids']))}"
          f" equal the unfaulted run's, {flips} first divergences at bf16 "
          f"near-ties) ({smi})")
    return out


def phase_http(smi):
    """Phase 10: the HTTP/SSE gateway, metrics, the re-planner and the
    autoscaler (module docstring). Returns the launches of its runs."""
    import torch
    t0 = time.perf_counter()
    cfg, params = _depth_cut(*_full_width(), P10_LAYERS)
    held = {}
    _reset_launches()
    with _live_kernel_hold(held):
        _p10_smoke(params, smi)
        mix = _p10_mix(params, smi)
        _p10_chaos(params, smi)
        auto = _p10_autoscale(params, smi)
    counts = _launch_counts(need=("gqa_decode", "paged_decode", "textrank"),
                            what="gateway (phase 10)")
    want = [("paged_decode", (4, 512)), ("paged_decode", (4, 4096)),
            ("gqa_decode", (4, 512)), ("gqa_decode", (4, 4096)),
            ("gqa_decode", auto["shapes"][list(auto["shapes"])[-1]])]
    missing = [k for k in want if k not in held]
    if missing:
        fail(f"phase 10: no held launch at {missing}; held {sorted(held)}")
    if counts["textrank"] < mix["textrank"]:
        fail(f"phase 10: textrank launches {counts}")
    del params
    torch.cuda.empty_cache()
    print(f"[http] each decode kernel's first launch at every (B, S) of "
          f"phase 10 held against its plain version on its live inputs "
          f"(limit {TOL['bfloat16']:g} and one bf16 ulp of max|plain|): "
          + ", ".join(f"{k} B={b} S={s_} err {e:.3e} ({e / m:.3e} x "
                      f"max|plain| {m:.3f})"
                      for (k, (b, s_)), (e, m) in sorted(held.items())))
    print(f"[http] phase 10: {time.perf_counter() - t0:.1f} s; launches "
          f"{counts} ({smi})")
    return counts


# ---------------------------------------------------------------- phase 11
# minitron-8b at its published widths, depth cut for AdamW: at 12 B a
# parameter (bf16 weights and grads, float32 m and v) 32 layers need
# 92.9 GB, 16 need 59.1 GB
TRAIN_LAYERS = 16
TRAIN_STEPS = 10
MICRO_LAYERS = 8              # (d): + 4 B a parameter of f32 accumulators
MICRO_SHAPE = (8, 512)        # global batch, sequence
PEAK_LIMIT = 80e9             # bytes a train step may hold at its peak
OPT_BYTES = 22    # a parameter: read p, g (bf16), m, v (f32); write p, m, v
# (c) remat "layer" vs none, largest |g_layer - g_none| of a leaf as a
# fraction of its max |g|, set from readings (PERF.md: every leaf bitwise
# equal). The bound is 0 (bitwise) but for the embedding's grad, whose
# backward may accumulate duplicate tokens in an order the card does not
# fix: f32 sums rounded once to bf16, so one bf16 ulp of its max |g|.
REMAT_GRAD_BOUND = {"embed": 2.0 ** -8}
# (d) microbatches 2 vs 1 after one step, largest |p_2 - p_1| of a leaf as
# a fraction of its max |p|: readings up to 5.076e-3 (one bf16 ulp at
# mid-range values, where |g| is tiny or the f32 result sits at a
# rounding edge; PERF.md), a factor 2 of margin. Adam's first step moves
# an element by about +-lr whatever |g|, so this catches sign flips only
MICRO_PARAM_BOUND = 1e-2
# (d) microbatches 2 vs 1: the loss and the pre-clip grad norm within
# 1e-4 relative (readings: PERF.md). A gradient summed instead of
# averaged, or taken over half the batch, moves the norm by a large
# factor; the parameters after Adam's first step cannot show either.
MICRO_REL_BOUND = 1e-4
# (b) card vs CPU (f32), and tests/test_torch_training.py: the parity
# rule (parity_gaps)
PARITY_TOL, PARITY_TINY = 1e-5, 1e-4


def parity_gaps(got, want, tiny, far: float):
    """The parity rule on one f32 leaf after AdamW (numpy arrays):
    ``tiny`` marks the elements whose |g| was at most PARITY_TINY of the
    leaf's max |g| at some step. Returns (the largest |got - want| at the
    other elements, the largest at these, whether the first is within
    PARITY_TOL and the second within ``far`` (2 lr a step) + PARITY_TOL)."""
    import numpy as np
    d = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    near = float(d[~tiny].max()) if (~tiny).any() else 0.0
    flip = float(d[tiny].max()) if tiny.any() else 0.0
    return near, flip, near <= PARITY_TOL and flip <= far + PARITY_TOL


def _leaf_names(t, prefix=""):
    """Dotted paths of a params tree's leaves, in training/tree.py order."""
    if isinstance(t, dict):
        return [n for k in sorted(t)
                for n in _leaf_names(t[k], f"{prefix}{k}.")]
    return [prefix[:-1]]


def _train_cfg(layers: int, dtype="bfloat16"):
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config("minitron-8b"), num_layers=layers,
                               dtype=dtype)


def _step_flops(cfg, b: int, s: int) -> float:
    """Matmul FLOP of one train step with layer remat: the forward, the
    backward (twice the forward) and the blocks' forward once more.
    Attention counts the full (S, S) scores, as ``_sdpa`` computes them."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    mlp = (2 if cfg.activation == "squared_relu" else 3) * d * cfg.d_ff
    blocks = cfg.num_layers * (
        2 * b * s * (d * (h + 2 * hkv) * hd + h * hd * d + mlp)
        + 4 * b * s * s * h * hd)
    fwd = blocks + 2 * b * s * d * cfg.vocab_size
    return 3 * fwd + blocks


def _train_batch(cfg, b: int, s: int, step: int = 0, device=None):
    """``training.data.batch_at`` (seed 0) as tensors on ``device``."""
    import torch
    from repro_torch.training.data import DataConfig, batch_at
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b)
    return {k: torch.from_numpy(v).to(device or DEVICE)
            for k, v in batch_at(dc, step).items()}


def _gb(nbytes: float) -> str:
    return f"{nbytes / 1e9:.2f} GB"


def _peak_since(fn):
    """(fn(), the device memory it held at its peak beyond what was
    allocated before it)."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def _train_main(smi):
    """(a) launch/train.py's ``train()`` at TRAIN_LAYERS of minitron-8b
    with the launcher's defaults; then one more step split into its
    gradient and update halves, and one step under torch.profiler.
    Returns the run."""
    import torch
    from repro_torch.launch import train
    from repro_torch.training import tree
    from repro_torch.training.optimizer import AdamWConfig, adamw_update
    from repro_torch.training.train_step import value_and_grad
    cfg = _train_cfg(TRAIN_LAYERS)
    args = train.parse_args(["--steps", str(TRAIN_STEPS), "--device",
                             DEVICE])
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    run = train.train(args, cfg=cfg,
                      log=lambda line: print(f"[train] (a) {line}"))
    counts = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if any(counts.values()):
        fail(f"(a) training launched a kernel of the port: {counts}")
    bad = [i for i, (l, g) in enumerate(zip(run.losses, run.gnorms))
           if not (math.isfinite(l) and math.isfinite(g))]
    if bad:
        fail(f"(a) non-finite loss or grad norm at steps {bad}")
    if not min(run.losses[4:]) < run.losses[0] + 0.02:
        fail(f"(a) the loss did not fall: {run.losses}")
    if peak >= PEAK_LIMIT:
        fail(f"(a) peak memory {_gb(peak)} >= {_gb(PEAK_LIMIT)}")
    leaves = tree.leaves(run.params)
    n = sum(p.numel() for p in leaves)
    per_layer = sum(p.numel() for p in tree.leaves(run.params["layers"])) \
        // cfg.num_layers
    n32 = n + (32 - cfg.num_layers) * per_layer
    b, s = args.global_batch, args.seq_len
    flops = _step_flops(cfg, b, s)
    compute_ms = 1e3 * flops / PEAK_OPS["bfloat16"]
    opt_ms = 1e3 * OPT_BYTES * n / HBM_BYTES_PER_S
    steady = sorted(run.step_s[1:])
    med = 1e3 * steady[len(steady) // 2]
    print(f"[train] (a) minitron-8b at its published widths, num_layers 32 "
          f"-> {cfg.num_layers}: {n / 1e9:.4f} B parameters (32 layers: "
          f"{n32 / 1e9:.4f} B, {_gb(12 * n32)} of weights, grads and AdamW "
          f"moments; {cfg.num_layers} layers: {_gb(12 * n)}), bf16, seed 0, "
          f"batch {b} x {s}, remat layer, {TRAIN_STEPS} steps; losses "
          + ", ".join(f"{x:.4f}" for x in run.losses) + "; grad norms "
          + ", ".join(f"{x:.4f}" for x in run.gnorms))
    print(f"[train] (a) ms a step (host clock, device synchronised): first "
          f"{1e3 * run.step_s[0]:.2f}; steps 1-{TRAIN_STEPS - 1} median "
          f"{med:.2f} (min {1e3 * steady[0]:.2f}, max "
          f"{1e3 * steady[-1]:.2f}); {b * s / med * 1e3:.1f} tokens/s; peak "
          f"max_memory_allocated {_gb(peak)} ({peak / 2**30:.2f} GiB, limit "
          f"{_gb(PEAK_LIMIT)}); floor {compute_ms + opt_ms:.2f} ms = "
          f"{flops:.4g} FLOP / 989 TFLOP/s ({compute_ms:.2f} ms) + "
          f"{OPT_BYTES} B x {n / 1e9:.4f} B parameters / 3.35 TB/s "
          f"({opt_ms:.2f} ms); no kernel of the port launched ({smi})")
    # one more step, split: gradients, then the update (the same config)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                          total_steps=args.steps)
    batch = _train_batch(cfg, b, s, TRAIN_STEPS)
    split = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, grads = value_and_grad(run.params, cfg, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        run.params, run.opt, _ = adamw_update(opt_cfg, grads, run.opt,
                                              run.params)
        torch.cuda.synchronize()
        split.append((1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t1)))
        del grads

    def step():
        _, g = value_and_grad(run.params, cfg, batch)
        run.params, run.opt, _ = adamw_update(opt_cfg, g, run.opt, run.params)
    rows, wall = profile_calls(step, 1)
    dev_ms = sum(r[1] for r in rows) / 1e3
    print(f"[train] (a) a step split (device synchronised): gradients "
          + ", ".join(f"{g:.2f}" for g, _ in split) + " ms; AdamW update "
          + ", ".join(f"{u:.2f}" for _, u in split) + f" ms (floor "
          f"{opt_ms:.2f}); profiled step: wall {1e3 * wall:.2f} ms, device "
          f"{dev_ms:.2f} ms, busy {100 * dev_ms / (1e3 * wall):.1f}%; top "
          "kernels (ms, count): "
          + "; ".join(f"{k[:70]} {t / 1e3:.2f} ({c})" for k, t, c in rows[:8])
          + f" ({smi})")
    return run, args


def _remat_vs_none(run, args, smi):
    """(c) One step's gradients with remat "layer" and with none, at
    (a)'s depth and batch on (a)'s trained parameters: the loss bitwise
    equal, the grads bitwise but where REMAT_GRAD_BOUND bounds a leaf as
    a fraction of its max |g|."""
    import torch
    from repro_torch.training import tree
    from repro_torch.training.train_step import value_and_grad
    cfg = run.cfg
    batch = _train_batch(cfg, args.global_batch, args.seq_len)
    ((l1, _), g1), peak1 = _peak_since(lambda: value_and_grad(
        run.params, cfg, batch, remat="layer"))
    ((l0, _), g0), peak0 = _peak_since(lambda: value_and_grad(
        run.params, cfg, batch, remat=False))
    if not torch.equal(l0, l1):
        fail(f"(c) remat layer loss {float(l1)!r} != no-remat "
             f"{float(l0)!r}")
    names = _leaf_names(run.params)
    read = []
    for name, a, b in zip(names, tree.leaves(g1), tree.leaves(g0)):
        top = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max()) / top
        read.append((name, err, bool(torch.equal(a, b))))
        if err > REMAT_GRAD_BOUND.get(name, 0.0):
            fail(f"(c) {name}: |g_layer - g_none| {err:.3e} of max|g| "
                 f"{top:.3e} (bound {REMAT_GRAD_BOUND.get(name, 0.0):.3e})")
    print(f"[train] (c) remat layer vs none, {cfg.num_layers} layers, batch "
          f"{args.global_batch} x {args.seq_len}: loss {float(l0)!r} bitwise "
          f"equal; grads, largest |diff| / max|g| per leaf (bound 0 but "
          + ", ".join(f"{k} {v:.3e}" for k, v in REMAT_GRAD_BOUND.items())
          + "; = bitwise equal): "
          + ", ".join(f"{n} {e:.3e}{' =' if eq else ''}"
                      for n, e, eq in read)
          + f"; peak held beyond the weights (grads and activations): remat "
          f"{_gb(peak1)}, none "
          f"{_gb(peak0)} ({smi})")
    del g0, g1


def _micro_vs_full(smi):
    """(d) One launcher step with microbatches 2 against 1 from the same
    weights, at MICRO_LAYERS and MICRO_SHAPE: the loss and the grad norm
    within MICRO_REL_BOUND relative, the parameters within
    MICRO_PARAM_BOUND of each leaf's max |p|."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.training import tree
    from repro_torch.training.optimizer import AdamWConfig, init_adamw
    from repro_torch.training.train_step import make_train_step
    cfg = _train_cfg(MICRO_LAYERS)
    b, s = MICRO_SHAPE
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    p1 = M.init_params(cfg, seed=0, device=DEVICE)
    p2 = tree.unflatten(p1, [p.clone() for p in tree.leaves(p1)])
    batch = _train_batch(cfg, b, s)
    out = {}
    for mb, params in ((1, p1), (2, p2)):
        step = make_train_step(cfg, opt_cfg, microbatches=mb)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, init_adamw(params), batch)
        del opt
        out[mb] = (params, float(m["loss"]), float(m["grad_norm"]),
                   1e3 * (time.perf_counter() - t0),
                   torch.cuda.max_memory_allocated())
    rel = abs(out[2][1] - out[1][1]) / abs(out[1][1])
    rel_g = abs(out[2][2] - out[1][2]) / abs(out[1][2])
    if not rel <= MICRO_REL_BOUND:
        fail(f"(d) microbatches 2 loss {out[2][1]!r} vs 1 {out[1][1]!r}")
    if not rel_g <= MICRO_REL_BOUND:
        fail(f"(d) microbatches 2 grad norm {out[2][2]!r} vs 1 "
             f"{out[1][2]!r}")
    read = []
    for name, a, c in zip(_leaf_names(p1), tree.leaves(out[1][0]),
                          tree.leaves(out[2][0])):
        top = float(a.float().abs().max())
        d = float((a.float() - c.float()).abs().max())
        read.append((name, d, d / top))
        if d / top > MICRO_PARAM_BOUND:
            fail(f"(d) {name}: |p_2 - p_1| {d:.3e} = {d / top:.3e} of "
                 f"max|p| (bound {MICRO_PARAM_BOUND:.3e})")
    n = sum(p.numel() for p in tree.leaves(p1))
    print(f"[train] (d) microbatches 2 vs 1, minitron-8b widths at "
          f"{MICRO_LAYERS} layers ({n / 1e9:.4f} B parameters), batch {b} x "
          f"{s}, one step (lr {opt_cfg.lr} / warmup {opt_cfg.warmup_steps}): "
          f"loss {out[1][1]!r} / {out[2][1]!r} (rel {rel:.3e}), grad norm "
          f"{out[1][2]!r} / {out[2][2]!r} (rel {rel_g:.3e}; limit "
          f"{MICRO_REL_BOUND:g}); step "
          f"{out[1][3]:.2f} / {out[2][3]:.2f} ms; peak max_memory_allocated "
          f"{_gb(out[1][4])} / {_gb(out[2][4])}; parameters, largest |diff| "
          f"(/ max|p|) per leaf (bound {MICRO_PARAM_BOUND:.3e} of max|p|): "
          + ", ".join(f"{nm} {d:.3e} ({r:.3e})" for nm, d, r in read)
          + f" ({smi})")


def _card_vs_cpu(smi):
    """(b) Reduced minitron-8b f32, the port's init_params weights on the
    CPU and a copy on the card, 3 launcher steps each (TF32 off): losses
    and grad norms within 1e-5 relative, parameters by the parity rule.
    Returns the card's trained (params, opt state)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import model as M
    from repro_torch.training import tree
    from repro_torch.training.optimizer import AdamWConfig, init_adamw
    from repro_torch.training.train_step import (make_train_step,
                                                 value_and_grad)
    resolve_device(DEVICE)                  # TF32 off for f32 products
    cfg = dataclasses.replace(get_config("minitron-8b").reduced(), dtype="float32")
    steps, (b, s) = 3, (8, 128)
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=steps)
    cpu = M.init_params(cfg, seed=0, device="cpu")
    card = tree.unflatten(cpu, [p.to(DEVICE, copy=True)
                                for p in tree.leaves(cpu)])
    cpu_opt, card_opt = init_adamw(cpu), init_adamw(card)
    step = make_train_step(cfg, opt_cfg)
    tiny = [np.zeros(p.shape, bool) for p in tree.leaves(cpu)]
    worst = {"loss": 0.0, "grad_norm": 0.0}
    for i in range(steps):
        _, g = value_and_grad(cpu, cfg, _train_batch(cfg, b, s, i, "cpu"))
        for t, x in zip(tiny, tree.leaves(g)):
            a = x.abs().numpy()
            t |= a <= PARITY_TINY * a.max()
        cpu, cpu_opt, mc = step(cpu, cpu_opt,
                                _train_batch(cfg, b, s, i, "cpu"))
        card, card_opt, mg = step(card, card_opt, _train_batch(cfg, b, s, i))
        for k in worst:
            r = abs(float(mg[k]) - float(mc[k])) / abs(float(mc[k]))
            worst[k] = max(worst[k], r)
            if r > PARITY_TOL:
                fail(f"(b) step {i} {k}: card {float(mg[k])!r} vs CPU "
                     f"{float(mc[k])!r}")
    far = 2 * opt_cfg.lr * steps
    d_near = d_tiny = 0.0
    n_tiny = 0
    for name, t, a, c in zip(_leaf_names(cpu), tiny, tree.leaves(card),
                             tree.leaves(cpu)):
        near, flip, ok = parity_gaps(a.cpu().numpy(), c.numpy(), t, far)
        if not ok:
            fail(f"(b) {name}: card vs CPU params {near:.3e} / {flip:.3e} "
                 f"apart (tiny-gradient elements)")
        d_near, d_tiny = max(d_near, near), max(d_tiny, flip)
        n_tiny += int(t.sum())
    print(f"[train] (b) reduced minitron-8b f32, card vs CPU, {steps} steps "
          f"of {b} x {s}: losses within {worst['loss']:.3e}, grad norms "
          f"within {worst['grad_norm']:.3e} relative (limit {PARITY_TOL:g}); "
          f"params within {d_near:.3e} (limit {PARITY_TOL:g}) where |g| > "
          f"{PARITY_TINY:g} max|g| at every step, {d_tiny:.3e} at the "
          f"{n_tiny} other elements (limit 2 lr steps = {far:g}) ({smi})")
    return card, card_opt


def _checkpoint_round_trip(params, opt, smi):
    """(e) (b)'s trained parameters and optimizer state saved from the
    card and restored onto it bit for bit, in f32 and as bf16."""
    import tempfile
    import torch
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training import tree
    for dtype in (torch.float32, torch.bfloat16):
        p = tree.unflatten(params, [x.to(dtype) for x in tree.leaves(params)])
        like = {"params": tree.unflatten(p, [torch.empty_like(x) for x in
                                             tree.leaves(p)]),
                "opt": type(opt)(torch.zeros_like(opt.step),
                                 *(tree.unflatten(t, [torch.empty_like(x)
                                                      for x in tree.leaves(t)])
                                   for t in (opt.m, opt.v)))}
        with tempfile.TemporaryDirectory() as d:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            CKPT.save(d, 3, p, opt)
            t1 = time.perf_counter()
            back = CKPT.restore(d, 3, like)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            size = sum(f.stat().st_size for f in Path(d).iterdir())
        want = tree.leaves({"params": p, "opt": opt})
        got = tree.leaves(back)
        for i, (a, b) in enumerate(zip(got, want)):
            if a.device != b.device or a.dtype != b.dtype \
                    or not torch.equal(a, b):
                fail(f"(e) {dtype} checkpoint leaf {i} not restored bit "
                     f"for bit")
        print(f"[train] (e) checkpoint of (b)'s params ({dtype}) and AdamW "
              f"state from the card: {len(got)} leaves, {size} bytes, saved "
              f"in {1e3 * (t1 - t0):.1f} ms, restored onto the card in "
              f"{1e3 * (t2 - t1):.1f} ms, bitwise equal ({smi})")


def phase_train(smi):
    """Phase 11: training (module docstring)."""
    import gc
    import torch
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    if left > 2**30:
        fail(f"phase 11: {left / 2**30:.2f} GiB still allocated after "
             "phases 1-10")
    print(f"[train] earlier phases' engines and caches freed: "
          f"{left / 2**20:.1f} MiB allocated")
    run, args = _train_main(smi)
    run.opt = None                          # (c) needs no optimizer state
    torch.cuda.empty_cache()
    _remat_vs_none(run, args, smi)
    del run
    gc.collect()
    torch.cuda.empty_cache()
    _micro_vs_full(smi)
    gc.collect()
    torch.cuda.empty_cache()
    params, opt = _card_vs_cpu(smi)
    _checkpoint_round_trip(params, opt, smi)
    del params, opt
    torch.cuda.empty_cache()
    print(f"[train] phase 11: {time.perf_counter() - t0:.1f} s ({smi})")


# ---------------------------------------------------------------- phase 12
P12_WINDOW = 1024                 # (b): llama4-scout's 8192 made 1024 so
                                  # the per-token prefill fits the phase
P12_PROMPTS = (1200, 1300, 1400, 1500)   # (b): prompt tokens, one a slot
P12_NEW = 64                             # (b): new tokens a request
P12_BOTH = (1060, 16)                    # (c): prompt tokens, new tokens
P12_BOTH_SLOTS = 4                       # (c): the engine's n_max, (b)'s
P12_SWAP_ROUND = 7          # (a): the swap probe's earliest drive round
P12_NARROW = 512            # (b): a window below the ring's length
P12_LAYERS = 2              # of 32: (b), (c)'s per-token prefill is
                            # host-bound, one decode_step a token column,
                            # and (a)'s fleet dispatches too (8 until
                            # phase 18 needed the time)


@contextlib.contextmanager
def _engine_prompts(log):
    """``log[rid]``: the prompt token ids each engine is given (after C&R
    where the gateway compressed)."""
    from repro_torch.serving.engine import InferenceEngine
    orig = InferenceEngine.submit

    def submit(self, req):
        log[req.rid] = list(req.tokens)
        return orig(self, req)
    InferenceEngine.submit = submit
    try:
        yield
    finally:
        InferenceEngine.submit = orig


@contextlib.contextmanager
def _prefill_timer(log):
    """Host seconds of every dispatch that prefills (prefill-only and
    mixed), the device synchronised on both ends, with the dispatch's
    chunk tokens and its bucket (the per-token loop's length)."""
    import torch
    from repro_torch.serving.engine import InferenceEngine
    origs = {m: getattr(InferenceEngine, m)
             for m in ("_run_prefill_chunks", "_run_mixed")}

    def wrap(orig):
        def timed(self, chunks, *a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            orig(self, chunks, *a)
            torch.cuda.synchronize()
            longest = max(len(c) for c in chunks.values())
            log.append((time.perf_counter() - t0,
                        sum(len(c) for c in chunks.values()),
                        next(b for b in self.buckets if b >= longest)))
        return timed
    for m, orig in origs.items():
        setattr(InferenceEngine, m, wrap(orig))
    try:
        yield
    finally:
        for m, orig in origs.items():
            setattr(InferenceEngine, m, orig)


def _batch_path(params, cfg, prompt, n_new, feed=None):
    """The batch path on one prompt, by the engine's convention: ``prefill``
    into a dense cache (int8, or a ring, as ``cfg`` says), then
    ``decode_step`` fed the last prompt token at position len(prompt) and
    then each emitted token (``feed``: these tokens instead, teacher
    forcing). Returns (its greedy tokens, {j: f32 logits of token j})."""
    import torch
    from repro_torch.models import model as M
    n = len(prompt)
    toks = torch.tensor([prompt], device=DEVICE)
    _, cache = M.prefill(params, cfg, {"tokens": toks,
                                       "cache_len": n + n_new})
    tok, out, log = toks[:, -1:], [], {}
    for j in range(n_new):
        logits, cache = M.decode_step(params, cfg, tok, cache, n + j)
        log[j] = logits[0].float()
        out.append(int(logits[0].argmax()))
        nxt = out[-1] if feed is None else feed[j]
        tok = torch.tensor([[nxt]], device=DEVICE)
    return out, log


def _p12_swap(eng, done):
    """(a) Swap one decoding slot of ``eng`` out: the host copy must hold
    every cache leaf (values and scales) of its row bit for bit. The
    swap-in is checked by ``_restore_probe``. ``done`` gets the rid."""
    import torch
    s = next((s for s in range(eng.n_max) if eng.slot_req[s] is not None
              and not eng.slot_prefill_left[s] and eng.slot_out[s]), None)
    if s is None:
        return
    rid = eng.slot_req[s].rid
    row = {k: a[:, s].clone() for k, a in eng.cache["kv"].items()}
    eng.preempt_slot(s, mode="swap")
    host = eng._preempted[rid].host_kv
    if host is None or set(host) != set(row):
        fail(f"(a) swap-out of rid {rid}: host leaves "
             f"{None if host is None else sorted(host)}, cache {sorted(row)}")
    for k, a in row.items():
        if not torch.equal(host[k].to(a.device), a):
            fail(f"(a) swap-out of rid {rid}: the host copy of {k} differs")
    done.append(rid)


class _SwapProbe:
    """(a) A ``_p9_serve`` event: from drive round P12_SWAP_ROUND on, swap
    one decoding slot of the long pool out once (``_p12_swap``)."""

    def __init__(self, on):
        self.on, self.swapped = on, []

    def pending(self):
        return False

    def on_round(self, rt, rounds, rebuilt):
        if self.on and not self.swapped and rounds >= P12_SWAP_ROUND:
            _p12_swap(rt.engines[rt.router.names[-1]], self.swapped)


def _p12_fleet_run(cfg, params, swap):
    """(a) Phase 9's stream through phase 5's dense fleet of ``cfg``
    (``_p9_serve``), every emitted token's logits logged, every
    decode-only dispatch timed, each decode kernel launch shape held
    against its plain version; with ``swap`` one slot of the long pool
    swapped out and back in. Returns the run (its fleet kept)."""
    from repro_torch.kernels import ops
    probe = _SwapProbe(swap)
    run = dict(prompts={}, log={}, decode=[], held={}, swaps=[],
               swapped=probe.swapped)
    with _engine_prompts(run["prompts"]), _decode_timer(run["decode"]), \
            _live_kernel_hold(run["held"]), _restore_probe(run["swaps"], {}):
        served = _p9_serve(cfg, params, False, run["log"], probe, keep=True)
    run["counts"] = _launch_counts(("gqa_decode",), f"(a) {cfg.name} "
                                   f"{cfg.kv_cache_dtype or cfg.dtype} fleet")
    run.update(rt=served["rt"], tokens=served["tokens"],
               rounds=served["rounds"])
    run["bytes"] = sum(_nbytes(e.cache) for e in run["rt"].engines.values())
    if ops.KERNELS[1].launches:
        fail("(a) the dense fleet launched the paged kernel")
    return run


def _p12_profile(eng, module, name, n_prompt=1024):
    """One decode dispatch of ``eng`` (one live row of ``n_prompt``
    tokens; 1,024 as phase 5's) under torch.profiler with ``module.name``
    marked by ``record_function``: wall ms of the dispatch, the device ms
    of its kernels, and of those that ran inside the marked ranges
    (``layers.dequantize_kv``: the int8 cache's dequantization, 0 for an
    fp cache; ``moe.moe_block``). The profiler also lists each range as
    a device event of its own (a user annotation spanning the range on
    the device): those are not kernels and are not summed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.serving.engine import ServeRequest
    eng.submit(ServeRequest(rid=10_000, tokens=[1 + i % 1000
                                                for i in range(n_prompt)],
                            max_new_tokens=64))
    while eng.slot_req[0] is None or eng.slot_prefill_left[0]:
        eng.step()
    eng.step()                          # the first decode dispatch: warm
    orig = getattr(module, name)

    def marked(*a, **kw):
        with record_function(name):
            return orig(*a, **kw)
    setattr(module, name, marked)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        setattr(module, name, orig)
    device = [e for e in prof.events() if e.device_type != DeviceType.CPU]
    spans = sorted((e.time_range.start, e.time_range.end) for e in device
                   if e.is_user_annotation and e.name == name)
    kernels = [e.time_range for e in device if not e.is_user_annotation]
    starts = [a for a, _ in spans]

    def inside(t) -> bool:
        i = bisect.bisect_right(starts, t.start) - 1
        return i >= 0 and t.start < spans[i][1]
    dev = sum(t.elapsed_us() for t in kernels)
    mark = sum(t.elapsed_us() for t in kernels if inside(t))
    return {"wall_ms": 1e3 * wall, "device_ms": dev / 1e3,
            "marked_ms": mark / 1e3}


def _p12_int8(cfg, params, smi):
    """(a) the int8 fleet against the bf16 one (module docstring). Returns
    the gqa_decode launches of both runs."""
    import torch
    from repro_torch.models import layers as L
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    runs, prof = {}, {}
    for name, c in (("bf16", cfg), ("int8", cfg8)):
        run = _p12_fleet_run(c, params, swap=name == "int8")
        eng = run["rt"].engines[run["rt"].router.names[-1]]
        prof[name] = _p12_profile(eng, L, "dequantize_kv")
        if name == "int8":
            kv = eng.cache["kv"]
            one = cuda_ms(lambda: L.dequantize_kv(kv["k"][0], kv["k_scale"][0]))
            prof["event_ms"] = one
            prof["shape"] = tuple(kv["k"].shape[1:])
        run.pop("rt")
        del eng
        torch.cuda.empty_cache()
        runs[name] = run
    b16, i8 = runs["bf16"], runs["int8"]
    # a (token, kv head): hd int8 values and one scale in the model's
    # dtype, against hd values in it (bf16, hd 128: 130 B vs 256 B)
    hd, size = cfg.resolved_head_dim, L.torch_dtype(cfg.dtype).itemsize
    want_ratio = (hd + size) / (hd * size)
    ratio = i8["bytes"] / b16["bytes"]
    if abs(ratio - want_ratio) > 1e-9:
        fail(f"(a) int8 fleet cache {i8['bytes']} B / bf16 {b16['bytes']} B"
             f" = {ratio:.6f}, not {want_ratio:.6f}")
    if not i8["swapped"] or not any(d == "in" for d, _, _ in i8["swaps"]):
        fail(f"(a) no swap out and in on the int8 pool ({i8['swaps']})")
    if not i8["held"]:
        fail("(a) the int8 fleet's decode kernel was never held")
    # the engine against the int8 batch path on the same prompts
    want, plain = {}, {}
    for rid, prompt in i8["prompts"].items():
        want[rid], plain[rid] = _batch_path(params, cfg8, prompt, P9_NEW)
    flips = _bf16_flips(plain, i8["log"], want, i8["tokens"],
                        "(a) int8 engine vs the int8 batch path", tag="kv")
    # int8 against bf16: the int8 batch path fed the bf16 fleet's tokens
    rel = {}
    for rid, prompt in b16["prompts"].items():
        _, tf = _batch_path(params, cfg8, prompt, P9_NEW,
                            feed=b16["tokens"][rid])
        ref = _logged(b16["log"], rid, P9_NEW - 1,
                      b16["tokens"][rid][-1], "(a) bf16 fleet")
        rel[rid] = float((tf[P9_NEW - 1] - ref).abs().max()
                         / ref.abs().max())
    del plain, want
    ms = {n: 1e3 * sum(t for t, _ in r["decode"]) / len(r["decode"])
          for n, r in runs.items()}
    tok_s = {n: sum(k for _, k in r["decode"])
             / sum(t for t, _ in r["decode"]) for n, r in runs.items()}
    same = sum(a == b for rid in b16["tokens"] for a, b in
               zip(b16["tokens"][rid], i8["tokens"][rid]))
    total = sum(len(t) for t in b16["tokens"].values())
    errs = {f"{k[0]} B={k[1][0]} S={k[1][1]}": f"{e:.3e}"
            for k, (e, _) in i8["held"].items()}
    swap_ms = {d: 1e3 * t for d, _, t in i8["swaps"]}
    p8, p16 = prof["int8"], prof["bf16"]
    layer_leaves = 2 * cfg.num_layers
    print(f"[kv] (a) minitron-8b widths, {cfg.num_layers} of 32 layers, "
          f"phase 5's dense fleet, {len(i8['tokens'])} requests x "
          f"{P9_NEW} tokens, bf16 vs int8 "
          f"KV: cache {b16['bytes']} B vs {i8['bytes']} B ({ratio:.4f}x); "
          f"decode-only {ms['bf16']:.2f} vs {ms['int8']:.2f} ms per dispatch "
          f"({len(b16['decode'])} / {len(i8['decode'])} dispatches; "
          f"{tok_s['bf16']:.1f} vs {tok_s['int8']:.1f} tokens/s); drive "
          f"rounds {b16['rounds']} / {i8['rounds']}; gqa_decode launches "
          f"{b16['counts']['gqa_decode']} / {i8['counts']['gqa_decode']}; "
          f"tokens equal at {same}/{total} positions ({smi})")
    print(f"[kv] (a) int8 engine vs the int8 batch path: {flips} near-tie "
          f"divergences; int8 batch path fed the bf16 fleet's tokens, "
          f"last-token max|dlogit| / max|logit| per request "
          f"{ {k: round(v, 4) for k, v in sorted(rel.items())} } (limit "
          f"{INT8_REL}); swap of rid {i8['swapped'][0]}: out "
          f"{swap_ms.get('out', 0.0):.2f} ms, in {swap_ms.get('in', 0.0):.2f}"
          f" ms, values and scales restored bitwise; kernel held on live "
          f"dequantized inputs: {errs}")
    print(f"[kv] (a) one profiled decode dispatch of the long pool (one "
          f"live row of 1,024, decode_k 4): bf16 wall {p16['wall_ms']:.2f} "
          f"ms, device {p16['device_ms']:.2f} ms; int8 wall "
          f"{p8['wall_ms']:.2f} ms, device {p8['device_ms']:.2f} ms, of "
          f"which dequantize_kv {p8['marked_ms']:.2f} ms "
          f"({100 * p8['marked_ms'] / max(p8['device_ms'], 1e-9):.1f}%); "
          f"CUDA events: one leaf of one layer at {prof['shape']} "
          f"{prof['event_ms']:.4f} ms, x {layer_leaves} leaves x 4 "
          f"iterations = {4 * layer_leaves * prof['event_ms']:.2f} ms a "
          f"dispatch ({smi})")
    bad = {k: v for k, v in rel.items() if v >= INT8_REL}
    if bad:
        fail(f"(a) int8 last-token logits off the bf16 fleet's by {bad} of "
             f"max|logit| (limit {INT8_REL})")
    return b16["counts"]["gqa_decode"] + i8["counts"]["gqa_decode"]


def _not_prefix(valid) -> bool:
    """Whether some row of a (B, S) mask is not a prefix (a True after a
    False)."""
    return bool((valid[:, 1:] & ~valid[:, :-1]).any())


def _p12_engine(cfg, params, reqs, what, n_max=4):
    """(b), (c) A dense engine of ``cfg`` (``n_max`` slots, c_max 4096,
    c_chunk 256, decode_k 4) serving ``reqs``, logits logged, prefill and
    decode dispatches timed, the decode kernel held on its live inputs
    while the ring fills and after it wrapped. Returns the run (engine
    kept)."""
    from repro_torch.serving.engine import InferenceEngine
    eng = InferenceEngine(cfg, params, n_max=n_max, c_max=4096, c_chunk=256,
                          decode_k=4)
    ring = eng.cache["kv"]["k"].shape[2]
    if ring != cfg.attention_window:
        fail(f"{what}: the cache is {ring} rows long, not "
             f"{cfg.attention_window}")
    run = dict(eng=eng, log={}, held={}, prefill=[], decode=[], seen={},
               slot={})

    def wrapped():
        return "wrapped" if int(eng.slot_pos.max()) >= ring else "filling"

    def on_step(eng):
        for s, r in enumerate(eng.slot_req):
            if r is not None:
                run["seen"][r.rid] = max(run["seen"].get(r.rid, 0),
                                         int(eng.slot_pos[s]))
                run["slot"][r.rid] = s
    _reset_launches()
    t0 = time.perf_counter()
    with _prefill_timer(run["prefill"]), _decode_timer(run["decode"]), \
            _logit_log(run["log"]), \
            _live_kernel_hold(run["held"], tag=wrapped):
        run["tokens"] = _drain(eng, reqs, on_step)
    run["secs"] = time.perf_counter() - t0
    run["counts"] = _launch_counts(("gqa_decode",), what)
    for r in reqs:
        got = run["tokens"].get(r["rid"], [])
        if len(got) != r["max_new_tokens"]:
            fail(f"{what}: request {r['rid']} did not complete "
                 f"({len(got)} tokens)")
        if run["seen"][r["rid"]] <= ring:
            fail(f"{what}: request {r['rid']} stopped at position "
                 f"{run['seen'][r['rid']]}, inside the ring of {ring}")
    for tag in ("filling", "wrapped"):
        if ("gqa_decode", (eng.n_max, ring), tag) not in run["held"]:
            fail(f"{what}: no decode launch held while the ring was {tag}")
    return run


def _p12_window(cfg, params, smi):
    """(b) the windowed engine (module docstring). Returns its launches."""
    import numpy as np
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    cfgw = dataclasses.replace(cfg, attention_window=P12_WINDOW)
    rng = np.random.default_rng(12)
    reqs = [dict(rid=i, tokens=[int(t) for t in
                                rng.integers(1, cfg.vocab_size, n)],
                 max_new_tokens=P12_NEW) for i, n in enumerate(P12_PROMPTS)]
    run = _p12_engine(cfgw, params, reqs, "(b) windowed engine")
    eng = run["eng"]
    # the engine against a teacher-forced forward(window=) over prompt +
    # the fed tokens (the last prompt token again, then the emitted ones)
    drift, flips = 0.0, 0
    for r in reqs:
        rid, prompt, out = r["rid"], r["tokens"], run["tokens"][r["rid"]]
        seq = torch.tensor([prompt + prompt[-1:] + out[:-1]], device=DEVICE)
        fwd = M.forward(params, cfgw, {"tokens": seq},
                        window=P12_WINDOW)[0][0, len(prompt):].float()
        for j, t in enumerate(out):
            p, q = fwd[j], _logged(run["log"], rid, j, t, "(b) engine")
            ulp = _bf16_ulp(float(p.max()))
            drift = max(drift, float((q - p).abs().max()) / ulp)
            top = int(p.argmax())
            if top != t:
                pref = float(p[top] - p[t])
                if pref > BF16_GAP_ULPS * ulp:
                    fail(f"(b) rid {rid} token {j}: {t}, the forward prefers "
                         f"{top} by {pref:.5f} > {BF16_GAP_ULPS} ulps")
                flips += 1
        del fwd
    if drift > BF16_DRIFT_ULPS:
        fail(f"(b) engine logits {drift:.2f} ulps off the teacher-forced "
             f"forward (limit {BF16_DRIFT_ULPS})")
    # prefill into a ring shorter than the prompt, then decode_step
    want, plain = {}, {}
    for r in reqs:
        want[r["rid"]], plain[r["rid"]] = _batch_path(
            params, cfgw, r["tokens"], P12_NEW)
    ring_flips = _bf16_flips(plain, run["log"], want, run["tokens"],
                             "(b) ring prefill + decode_step vs the engine",
                             tag="kv")
    del plain, want
    # the live ring under a window shorter than it: valid is no prefix
    pos = torch.zeros(eng.n_max, dtype=torch.long, device=DEVICE)
    for r in reqs:
        pos[run["slot"][r["rid"]]] = len(r["tokens"]) + P12_NEW
    kv = {k: a.clone() for k, a in eng.cache["kv"].items()}
    idx = L.decode_index(cfgw, pos, {"k": kv["k"][0]}, window=P12_NARROW)
    if not _not_prefix(idx.valid):
        fail("(b) the narrow window's valid mask is a prefix")
    narrow = {}
    tok = torch.ones((eng.n_max, 1), dtype=torch.long, device=DEVICE)
    with _live_kernel_hold(narrow):
        M.decode_step(params, cfgw, tok, {"kv": kv}, pos, window=P12_NARROW)
    del kv
    pre_s = sum(t for t, _, _ in run["prefill"])
    pre_cols = sum(b for _, _, b in run["prefill"])
    pre_tok = sum(n for _, n, _ in run["prefill"])
    dec_ms = 1e3 * sum(t for t, _ in run["decode"]) / len(run["decode"])
    held = {f"{k[2]}": f"{v[0]:.3e}" for k, v in run["held"].items()}
    held.update({f"window {P12_NARROW}": f"{v[0]:.3e}"
                 for v in narrow.values()})
    print(f"[kv] (b) minitron-8b widths, {cfg.num_layers} of 32 layers, "
          f"attention_window {P12_WINDOW}: "
          f"engine n_max 4, c_max 4096 (ring {eng.cache['kv']['k'].shape[2]}"
          f" rows), decode_k 4, prompts {P12_PROMPTS} + {P12_NEW} new, "
          f"{run['secs']:.2f} s; positions reached {run['seen']}; per-token "
          f"prefill {len(run['prefill'])} dispatches, {pre_cols} token "
          f"columns, {1e3 * pre_s / pre_cols:.2f} ms a column (4 rows), "
          f"{1e3 * pre_s / pre_tok:.2f} ms a prompt token; decode-only "
          f"{dec_ms:.2f} ms per dispatch ({len(run['decode'])}); gqa_decode "
          f"launches {run['counts']['gqa_decode']} ({smi})")
    print(f"[kv] (b) engine vs teacher-forced forward(window={P12_WINDOW}): "
          f"largest drift {drift:.2f} ulps (limit {BF16_DRIFT_ULPS}), "
          f"{flips} positions where the forward's argmax is another token "
          f"(each within {BF16_GAP_ULPS} ulps); ring prefill + decode_step: "
          f"{ring_flips} near-tie divergences; kernel held on live ring "
          f"inputs (max abs err): {held}")
    n = run["counts"]["gqa_decode"]
    del run, eng
    torch.cuda.empty_cache()
    return n


def _p12_both(cfg, params, smi):
    """(c) int8 and the window in one engine. Returns its launches."""
    import numpy as np
    import torch
    cfgb = dataclasses.replace(cfg, attention_window=P12_WINDOW,
                               kv_cache_dtype="int8")
    n_prompt, n_new = P12_BOTH
    rng = np.random.default_rng(13)
    reqs = [dict(rid=0, tokens=[int(t) for t in
                                rng.integers(1, cfg.vocab_size, n_prompt)],
                 max_new_tokens=n_new)]
    run = _p12_engine(cfgb, params, reqs, "(c) int8 windowed engine",
                      n_max=P12_BOTH_SLOTS)
    kv = run["eng"].cache["kv"]
    if kv["k"].dtype != torch.int8 or "k_scale" not in kv:
        fail("(c) the engine's cache is not int8")
    held = {k[2]: f"{v[0]:.3e}" for k, v in run["held"].items()}
    print(f"[kv] (c) int8 + window {P12_WINDOW}, {cfg.num_layers} layers, "
          f"n_max "
          f"{run['eng'].n_max}: one request of {n_prompt} + {n_new} in "
          f"{run['secs']:.2f} s, position "
          f"{run['seen'][0]}, gqa_decode launches "
          f"{run['counts']['gqa_decode']}; kernel held on live dequantized "
          f"ring inputs (max abs err): {held} ({smi})")
    n = run["counts"]["gqa_decode"]
    del run, kv
    torch.cuda.empty_cache()
    return n


def phase_kv(smi):
    """Phase 12: the int8 KV cache through the fleet and the ring caches
    through the dense engine (module docstring). Returns the launches."""
    import torch
    t0 = time.perf_counter()
    cfg, params = _depth_cut(*_full_width(), P12_LAYERS)
    n = _p12_int8(cfg, params, smi)
    n += _p12_window(cfg, params, smi)
    n += _p12_both(cfg, params, smi)
    del params
    torch.cuda.empty_cache()
    print(f"[kv] phase 12: {time.perf_counter() - t0:.1f} s; gqa_decode "
          f"launches {n}")
    return {"gqa_decode": n}


# ---------------------------------------------------------------- phase 13
P13_ARCH = "llama4-scout-17b-a16e"
P13_LAYERS = 12               # of 48: 56.99 GB of bf16 weights, ~23 GB left
P13_NO_DROP = 8.0             # (b): capacity_factor, the reference test's
P13_BLOCK = ((1, 4), (4, 1024))   # (a): a decode step's tokens, a prefill's
P13_BATCH = (4, 1024, 17)     # (b): batch, prompt, new tokens (16 decodes)
P13_NEW = 16                  # (c): new tokens a request
P13_FLEET_LAYERS = 2          # (c): the first 2 of the 12 (host-bound;
                              # 6 until phase 18 needed the time)
P13_LONG_CTX = 2048           # (c): contexts 256 / 2048, half phase 5's,
P13_C_CHUNK = 128             # with the boundary at 2 x c_chunk
P13_SHORT = (100, 180)        # (c): prompt tokens, the short pool
P13_INBAND = (330, 420)       # (c): B < L_total <= gamma * B: C&R
P13_LONG = (530,)             # (c): > gamma * B: the long pool
P13_PROFILE_PROMPT = 64       # (c): the profiled request's prompt tokens
P13_CPU_GAP = 1e-5            # (d): a routing flip's CPU top-2 prob gap


@contextlib.contextmanager
def _route_log(log, key, replay=None, sharded=None):
    """Log the routing of every token the MoE routes inside
    ``decode_step``, ``paged_decode_step``, ``prefill`` and ``forward``
    (a chunk's tokens are not logged): ``log[key(row, b, pos)]`` is a
    list, one (experts, router probabilities, router logits) a layer,
    the last two the k-th and (k+1)-th largest, at the boundary of the
    top k (top-1: the top two), where ``row`` is the engine slot's (rid,
    prompt tokens) when an engine step made the call (else None) and a
    key of None is not logged. A decode_step row that is not active is
    not logged. The records stay on the device until the context exits,
    so the path takes no host sync for them (its ops add a router product
    and two top-(k+1)s a layer). With ``replay`` (another run's log), every token
    whose key it holds takes that run's experts at each layer in place
    of its own (its gates its own router probabilities at them,
    renormalised as ``moe.route`` does), while ``log`` keeps its own
    decisions: the two runs then route alike and differ only in the
    path they are compared on. A replaying run reads each call's keys on
    the host (a sync a call). With ``sharded`` (a rank of an
    expert-parallel run: its first row in the global batch), ``b`` is the
    global row and a call logs the tokens this rank routes in
    ``moe_block_sharded``: under "a2a" its slice of the sequence, under
    "psum" every token."""
    import functools
    import inspect
    import torch
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.serving.engine import InferenceEngine
    route, step = moe.route, InferenceEngine.step
    block = moe.moe_block_sharded
    fns = {n: getattr(M, n) for n in ("decode_step", "paged_decode_step",
                                      "prefill", "forward")}
    ctx, cur, raw = [None], [None], []
    row0 = sharded or 0

    def keys_of(meta, n=None, lo=0):
        """The keys of a call's tokens; ``n`` / ``lo``: of the sequence
        slice [lo, lo + n) alone."""
        if meta[0] == "step":
            _, pos, act, rows = meta
            return [key(rows[i], row0 + i, p) if a else None for i, (p, a)
                    in enumerate(zip(pos.tolist(), act.tolist()))]
        _, nb, ns = meta
        n = n or ns
        return [key(None, row0 + i // n, lo + i % n) for i in range(nb * n)]

    def sharded_block(p, cfg, x, par, mode="a2a"):
        s = x.shape[1]
        if ctx[0] is not None:
            n = s // par.tp if mode == "a2a" and s % par.tp == 0 else s
            lo = par.model_rank * n if n < s else 0
            ctx[0] = ctx[0][:2] + (keys_of(ctx[0][0], n, lo),)
        return block(p, cfg, x, par, mode)

    def logged_route(router, cfg, tokens):
        probs, gate, eidx = route(router, cfg, tokens)
        if ctx[0] is None:
            return probs, gate, eidx
        _, layers, keys = ctx[0]
        k = cfg.moe.top_k
        pt = torch.topk(probs, k + 1).values[:, k - 1:]
        lt = torch.topk(tokens.float() @ router, k + 1).values[:, k - 1:]
        layers.append(torch.cat([eidx.float(), pt, lt], 1))
        hit = [(t, replay[k][len(layers) - 1][0]) for t, k in
               enumerate(keys or ()) if k in replay] if replay else []
        if not hit:
            return probs, gate, eidx
        want = eidx.clone()
        want[[t for t, _ in hit]] = torch.tensor(
            [e for _, e in hit], dtype=eidx.dtype, device=eidx.device)
        g = probs.gather(1, want)
        return probs, g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9), want

    def wrap(name, fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)          # _logit_log binds the signature
        def call(*a, **kw):
            if ctx[0] is not None:
                return fn(*a, **kw)
            b = sig.bind(*a, **kw).arguments
            if name.endswith("decode_step"):
                n = b["token"].shape[0]
                pos = torch.as_tensor(b["pos"]).expand(n).clone()
                act = b.get("active")
                act = (torch.ones(n, dtype=torch.bool) if act is None
                       else torch.as_tensor(act).clone())
                rows = ([None if r is None else (r.rid, len(r.tokens))
                         for r in cur[0].slot_req] if cur[0] is not None
                        else [None] * n)
                meta = ("step", pos, act, rows)
            else:
                meta = ("seq",) + tuple(b["batch"]["tokens"].shape)
            ctx[0] = (meta, [], keys_of(meta) if replay and sharded is None
                      else None)
            try:
                return fn(*a, **kw)
            finally:
                if ctx[0][1]:
                    raw.append((meta, ctx[0][2], torch.stack(ctx[0][1])))
                ctx[0] = None
        return call

    def stepping(self):
        cur[0] = self
        try:
            return step(self)
        finally:
            cur[0] = None
    moe.route, InferenceEngine.step = logged_route, stepping
    if sharded is not None:
        moe.moe_block_sharded = sharded_block
    for n, fn in fns.items():
        setattr(M, n, wrap(n, fn))
    try:
        yield
    finally:
        moe.route, InferenceEngine.step = route, step
        moe.moe_block_sharded = block
        for n, fn in fns.items():
            setattr(M, n, fn)
    for meta, keys, recs in raw:
        recs, k = recs.cpu(), recs.shape[-1] - 4
        for t, kk in enumerate(keys or keys_of(meta)):
            if kk is not None:
                log.setdefault(kk, []).extend(
                    (tuple(int(e) for e in r[:k]), r[k:k + 2], r[k + 2:])
                    for r in recs[:, t].tolist())


def _engine_key(row, b, pos):
    """_route_log's key in an engine: (rid, pos) at generated positions
    (pos >= the prompt's length: the engine's decode at len(prompt) + j
    emits token j), None elsewhere."""
    return (row[0], pos) if row is not None and pos >= row[1] else None


def _batch_key(row, b, pos):
    """_route_log's key in the batch launcher: (row, pos); position pos
    computes token pos - prompt + 1."""
    return b, pos


def _route_flips(plain, path, j_of, until, what, tie=None):
    """Compare two runs' route logs (``_route_log``), the plain run having
    taken the path's decisions (``replay=``, so its states stay near the
    path's after a flip), at the keys both hold: ``j_of(key)`` -> (owner,
    j), the token whose logits the key's position computes; only j <=
    until[owner] count (where the two histories agree). Each of the plain
    run's own decisions whose expert set differs from the path's (the
    order within the top k aside) must be a near-tie: ``tie(the plain
    run's record)``, or by default a gap between the k-th and (k+1)-th
    router logits within twice the largest difference of the k-th router
    logit between the two runs where they route alike (a flip needs the
    two experts' logits to move apart by the gap). Returns (flips, that
    largest difference)."""
    flips, noise = [], 0.0
    for k in plain.keys() & path.keys():
        owner, j = j_of(k)
        if j > until.get(owner, 1 << 30):
            continue
        for layer, (a, b) in enumerate(zip(plain[k], path[k])):
            if sorted(a[0]) == sorted(b[0]):
                noise = max(noise, abs(a[2][0] - b[2][0]))
            else:
                flips.append((k, layer, a, b))
    for k, layer, a, b in flips:
        gap = a[2][0] - a[2][1]
        if tie(a) if tie is not None else gap <= 2 * noise:
            continue
        print(f"[moe] {what}: routing flip at {k} layer {layer}: expert "
              f"{b[0]} vs {a[0]}; the plain run's k-th and (k+1)-th router "
              f"probabilities {a[1]}, logits {a[2]} (gap {gap:.4f}, "
              f"largest k-th logit difference where they agree "
              f"{noise:.4f})")
        fail(f"{what}: routing differs away from a near-tie at {k} "
             f"layer {layer}")
    return len(flips), noise


def _p13_configs():
    """llama4-scout at its published widths with the depth cut to
    P13_LAYERS, and its copy at capacity_factor P13_NO_DROP, both
    registered so the batch launcher's ``--arch`` finds them."""
    from repro_torch.configs import base
    cfg = dataclasses.replace(base.get_config(P13_ARCH),
                              num_layers=P13_LAYERS,
                              name=f"{P13_ARCH}-{P13_LAYERS}-layers")
    nd = dataclasses.replace(cfg, name=f"{cfg.name}-no-drop",
                             moe=dataclasses.replace(
                                 cfg.moe, capacity_factor=P13_NO_DROP))
    return base.register(cfg), base.register(nd)


@contextlib.contextmanager
def _drop_log(log):
    """log: (pairs routed, pairs dropped, experts routed to) of every
    moe_block call, the last two as device tensors."""
    from repro_torch.models import moe
    orig = moe.moe_block

    def counted(p, cfg, x):
        y, aux = orig(p, cfg, x)
        log.append((aux["dropped"].numel(), aux["dropped"].sum(),
                    (aux["router_fraction"] > 0).sum()))
        return y, aux
    moe.moe_block = counted
    try:
        yield
    finally:
        moe.moe_block = orig


def _drops(log) -> tuple:
    return (sum(int(d) for _, d, _ in log), sum(n for n, _, _ in log))


def _moe_flops(cfg, t: int) -> float:
    """FLOPs of one moe_block call on ``t`` tokens: the router, every
    expert's (ecap, D) buffer through its gated MLP, and the shared
    experts."""
    from repro_torch.models import moe
    mc = cfg.moe
    d, f = cfg.d_model, mc.expert_d_ff or cfg.d_ff
    _, ecap = moe.capacities(cfg, t)
    return 2 * t * d * mc.num_experts + 6 * d * f * (
        mc.num_experts * ecap + t * mc.num_shared_experts)


def _moe_bytes(lp, used) -> int:
    """Bytes of one layer's MoE leaves ``lp`` that a call needs when its
    kept pairs reach ``used`` experts: the router, the shared experts and
    those experts' gate, up and down weights."""
    experts = sum(_nbytes(lp[n]) for n in ("w_gate", "w_up", "w_down"))
    return (_nbytes(lp) - experts
            + used * experts // lp["w_gate"].shape[0])


def _p13_block(cfg, params, smi):
    """(a) moe_block alone on layer 0's weights (module docstring)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models import moe
    lp = M._unstack(params["layers"]["moe"])[0]
    lp32 = {k: ({n: w.float() for n, w in v.items()} if isinstance(v, dict)
                else v.float()) for k, v in lp.items()}
    weight_ms = 1e3 * _nbytes(lp) / HBM_BYTES_PER_S
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(13)
    for b, s in P13_BLOCK:
        x32 = torch.randn((b, s, cfg.d_model), generator=gen, device=DEVICE)
        x = x32.to(torch.bfloat16)
        y, aux = moe.moe_block(lp, cfg, x)
        y32, _ = moe.moe_block(lp32, cfg, x32)
        # a call queues ~90 kernels: 4 stay inside the launch queue while
        # cuda_ms holds the device
        ms = cuda_ms(lambda: moe.moe_block(lp, cfg, x), iters=4)
        e16 = moe.route(lp["router"], cfg, x.reshape(-1, cfg.d_model))[2]
        e32 = moe.route(lp["router"], cfg, x32.reshape(-1, cfg.d_model))[2]
        same = (e16 == e32).all(-1)
        err = float((y.float() - y32).reshape(-1, cfg.d_model)[same]
                    .abs().max() / y32.abs().max())
        cap, ecap = moe.capacities(cfg, b * s)
        ops_ms = 1e3 * _moe_flops(cfg, b * s) / PEAK_OPS["bfloat16"]
        used = int(e16.reshape(-1)[~aux["dropped"]].unique().numel())
        need = _moe_bytes(lp, used) + 2 * x.numel() * x.element_size()
        if not torch.isfinite(y).all():
            fail(f"(a) moe_block at T={b * s}: non-finite output")
        need_ms = 1e3 * need / HBM_BYTES_PER_S
        print(f"[moe] (a) moe_block, layer 0 of llama4-scout, T={b * s} "
              f"({b} x {s}): {ms:.4f} ms; floors: the function's bytes "
              f"{need_ms:.4f} ms ({100 * need_ms / ms:.1f}% of the time; "
              f"{need / 1e9:.3f} GB: the {used} experts its kept pairs "
              f"reach, the router, the shared expert, x and y), this "
              f"implementation's bytes {weight_ms:.4f} ms "
              f"({100 * weight_ms / ms:.1f}%; every expert's weights: each "
              f"buffer holds at least 8 rows, {_nbytes(lp) / 1e9:.3f} GB at "
              f"3.35 TB/s), operations "
              f"{ops_ms:.4f} ms (cap {cap}, ecap {ecap}: "
              f"{cfg.moe.num_experts * ecap} "
              f"expert rows); drops at capacity_factor "
              f"{cfg.moe.capacity_factor}: {int(aux['dropped'].sum())} of "
              f"{aux['dropped'].numel()} pairs; routing flips bf16 vs f32 "
              f"on the same inputs: {int((~same).sum())} of {b * s} tokens; "
              f"max|y_bf16 - y_f32| / max|y_f32| over the others "
              f"{err:.3e} ({smi})")
    del lp32
    torch.cuda.empty_cache()


def _p13_batch(cfg, nd, params, smi):
    """(b) the batch launcher (module docstring). Returns its launches."""
    import torch
    p, new = P13_BATCH[1], P13_BATCH[2]
    drops = []
    with _drop_log(drops):
        run, counts = _serve_batch(batch_args(cfg.name, P13_BATCH), params,
                                   need=("gqa_decode",))
    pre = _drops(drops[:cfg.num_layers])
    dec = _drops(drops[cfg.num_layers:])
    dec_log, fwd_log = {}, {}

    def key(row, b, pos):          # position pos computes token pos - p + 1
        return b, pos
    with _route_log(dec_log, key):
        run8, counts8 = _serve_batch(batch_args(nd.name, P13_BATCH), params,
                                     tokens=run.prompt, need=("gqa_decode",))
    with _route_log(fwd_log, key, replay=dec_log):
        _teacher_forced(nd, params, run8)
    flips, noise = _route_flips(fwd_log, dec_log,
                                lambda k: (k[0], k[1] - (p - 1)), {},
                                "(b) the forward's own routing vs the "
                                "decode run's")
    tokens = P13_BATCH[0] * p
    flops = cfg.num_layers * (
        _moe_flops(cfg, tokens) + 2 * tokens * cfg.d_model * (
            (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.resolved_head_dim
            + cfg.num_heads * cfg.resolved_head_dim)
        + 2 * 2 * P13_BATCH[0] * cfg.num_heads * cfg.resolved_head_dim
        * p * (p + 1) / 2)
    floor_ms = 1e3 * flops / PEAK_OPS["bfloat16"]
    dec_bytes = _nbytes(params) - _nbytes(params["embed"])
    # the function's: every weight but the experts its pairs do not reach
    # (decode drops none), and the KV rows each step reads
    experts = sum(_nbytes(params["layers"]["moe"][n])
                  for n in ("w_gate", "w_up", "w_down"))
    steps = new - 1
    used = sum(int(u) for _, _, u in drops[cfg.num_layers:]) / steps
    kv = cfg.kv_bytes_per_token() * P13_BATCH[0] * (p + (steps + 1) / 2)
    need = (dec_bytes - experts + kv
            + used * experts / (cfg.num_layers * cfg.moe.num_experts))
    step_ms = 1e3 * P13_BATCH[0] / run.decode_tok_s
    print(f"[moe] (b) batch launcher, llama4-scout {cfg.num_layers} layers, "
          f"{P13_BATCH[0]} x {p} + {new - 1} decode steps, capacity_factor "
          f"{cfg.moe.capacity_factor}: prefill {run.prefill_ms:.2f} ms "
          f"(compute floor {floor_ms:.2f} ms: {flops:.3e} FLOP at 989 "
          f"TFLOP/s), decode {step_ms:.2f} ms a step (bytes floors: the "
          f"function's {1e3 * need / HBM_BYTES_PER_S:.2f} ms, "
          f"{need / 1e9:.2f} GB: {used:.2f} experts a step of the "
          f"{cfg.num_layers * cfg.moe.num_experts} and the KV rows read; "
          f"this implementation's {1e3 * dec_bytes / HBM_BYTES_PER_S:.2f} "
          f"ms, {dec_bytes / 1e9:.2f} GB: every weight but the embedding,"
          f" at 3.35 TB/s), {run.decode_tok_s:.1f} "
          f"tokens/s; drops: prefill {pre[0]} of {pre[1]} pairs, decode "
          f"{dec[0]} of {dec[1]}; at {P13_NO_DROP}: prefill "
          f"{run8.prefill_ms:.2f} ms; the forward on the decode run's "
          f"routing: {flips} decisions of its own differ, each at a router "
          f"near-tie (largest top router logit difference where they "
          f"route alike {noise:.4f}); gqa_decode launches "
          f"{counts['gqa_decode']} + {counts8['gqa_decode']} ({smi})")
    if dec[0]:
        fail(f"(b) a decode step dropped {dec[0]} pairs")
    n = counts["gqa_decode"] + counts8["gqa_decode"]
    del run, run8
    torch.cuda.empty_cache()
    return n


def _p13_requests(tokenizer):
    """(c) two short prompts (rids 0-1), one long (10), two in-band for
    C&R (20-21), P13_NEW new tokens each."""
    import numpy as np
    from repro_torch.serving.pools import GatewayRequest
    rng = np.random.default_rng(13)
    reqs = [GatewayRequest(i, varied_prompt(rng, n, tokenizer), P13_NEW)
            for i, n in enumerate(P13_SHORT)]
    reqs += [GatewayRequest(10 + i, varied_prompt(rng, n, tokenizer),
                            P13_NEW) for i, n in enumerate(P13_LONG)]
    reqs += [GatewayRequest(20 + i, varied_prompt(rng, n, tokenizer),
                            P13_NEW, category="rag")
             for i, n in enumerate(P13_INBAND)]
    return reqs


def _p13_fleet_run(cfg, params, impl, replay=None, logged=True):
    """(c) P13's stream through phase 5's dense fleet of ``cfg``
    (``_p9_serve``) with ``decode_impl=impl``: prompts, decode and
    prefill dispatches timed. With ``logged``, the logits behind every
    emitted token and every position's routing are logged (``replay``:
    another run's routing log, taken in place of its own), and on the
    kernel path each decode kernel launch shape is held against its plain
    version; without, nothing but the timers wraps the path, and the run
    keeps its fleet. Returns the run."""
    from repro_torch.kernels import ops
    run = dict(prompts={}, log={} if logged else None, decode=[],
               prefill=[], held={}, routes={})

    def key(row, b, pos):
        return None if row is None else (row[0], pos)
    with contextlib.ExitStack() as wraps:
        wraps.enter_context(_engine_prompts(run["prompts"]))
        wraps.enter_context(_decode_timer(run["decode"]))
        wraps.enter_context(_prefill_timer(run["prefill"]))
        if logged and impl == "kernel":
            wraps.enter_context(_live_kernel_hold(run["held"]))
        if logged:
            wraps.enter_context(_route_log(run["routes"], key, replay))
        served = _p9_serve(cfg, params, False, run["log"],
                           reqs=_p13_requests, new=P13_NEW, keep=not logged,
                           decode_impl=impl, long_ctx=P13_LONG_CTX,
                           c_chunk=P13_C_CHUNK)
    run.update(served)
    if ops.KERNELS[1].launches:
        fail("(c) the dense fleet launched the paged kernel")
    return run


def _fleet_ms(run) -> tuple:
    """(decode ms per dispatch, per-token prefill columns, ms a column)."""
    cols = sum(b for _, _, b in run["prefill"])
    return (1e3 * sum(t for t, _ in run["decode"]) / len(run["decode"]),
            cols, 1e3 * sum(t for t, _, _ in run["prefill"]) / cols)


def _p13_fleet(cfg, params, smi):
    """(c) the K=2 fleet behind the C&R gateway (module docstring).
    Returns its launches."""
    import torch
    from repro_torch.models import moe
    timed = _p13_fleet_run(cfg, params, "kernel", logged=False)
    if timed["counts"]["textrank"] < len(P13_INBAND):
        fail(f"(c) {timed['counts']['textrank']} TextRank launches for "
             f"{len(P13_INBAND)} in-band requests")
    rt = timed.pop("rt")
    prof = _p12_profile(rt.engines[rt.router.names[-1]], moe, "moe_block",
                        n_prompt=P13_PROFILE_PROMPT)
    del rt
    torch.cuda.empty_cache()
    kern = _p13_fleet_run(cfg, params, "kernel")
    if (kern["tokens"], kern["counts"]) != (timed["tokens"],
                                            timed["counts"]):
        fail("(c) the logged kernel run's tokens or launches differ from "
             "the timed run's")
    ring = cfg.attention_window or 1 << 30
    need = {("gqa_decode", (4, min(c, ring)))
            for c in (P13_LONG_CTX // 8, P13_LONG_CTX)}
    if set(kern["held"]) != need:
        fail(f"(c) decode kernel held at {sorted(kern['held'])}, not "
             f"{sorted(need)}")
    plain = _p13_fleet_run(cfg, params, "torch", replay=kern["routes"])
    lens = {rid: len(t) for rid, t in plain["prompts"].items()}
    until = {rid: next((j for j, (a, b) in enumerate(zip(t, kern["tokens"]
                                                         [rid])) if a != b),
                       len(t)) for rid, t in plain["tokens"].items()}
    rflips, noise = _route_flips(
        plain["routes"], kern["routes"], lambda k: (k[0], k[1] - lens[k[0]]),
        until, "(c) the torch path's own routing vs the kernel run's")
    flips = _bf16_flips(plain["log"], kern["log"], plain["tokens"],
                        kern["tokens"], "(c) kernel vs torch path",
                        tag="moe")
    held = {f"B={k[1][0]} S={k[1][1]}": f"{v[0]:.3e}"
            for k, v in kern["held"].items()}
    dec_ms, pre_cols, col_ms = _fleet_ms(timed)
    log_dec, _, log_col = _fleet_ms(kern)
    c = timed["counts"]
    print(f"[moe] (c) llama4-scout {cfg.num_layers} layers, phase 5's K=2 "
          f"dense fleet at contexts {P13_LONG_CTX // 8} / {P13_LONG_CTX}, "
          f"c_chunk {P13_C_CHUNK} "
          f"(rings of {min(P13_LONG_CTX // 8, ring)} / "
          f"{min(P13_LONG_CTX, ring)} rows, n_max 4, decode_k 4), "
          f"prompts {sorted(lens.values())} tokens (after C&R) + {P13_NEW} "
          f"new: {timed['secs']:.2f} s, {timed['rounds']} drive rounds; "
          f"decode {dec_ms:.2f} ms per dispatch ({len(timed['decode'])}); "
          f"per-token prefill {pre_cols} token columns, {col_ms:.2f} ms a "
          f"column; the same run with logits and routing logged and the "
          f"kernel held: {kern['secs']:.2f} s, decode {log_dec:.2f} ms per "
          f"dispatch, {log_col:.2f} ms a column, tokens and launches equal;"
          f" torch path (logged) {plain['secs']:.2f} s; launches "
          f"gqa_decode {c['gqa_decode']}, textrank {c['textrank']}; kernel "
          f"held on live inputs: {held} ({smi})")
    print(f"[moe] (c) kernel vs torch path, the torch path on the kernel "
          f"run's routing: {flips} near-tie divergences; {rflips} routing "
          f"decisions of its own differ from the kernel run's, each at a "
          f"router near-tie (largest top router logit difference where "
          f"they route alike {noise:.4f}); one profiled decode "
          f"dispatch of the long pool (one live row, decode_k 4): wall "
          f"{prof['wall_ms']:.2f} ms, device {prof['device_ms']:.2f} ms "
          f"(busy {100 * prof['device_ms'] / prof['wall_ms']:.1f}%), of "
          f"which moe_block {prof['marked_ms']:.2f} ms "
          f"({100 * prof['marked_ms'] / max(prof['device_ms'], 1e-9):.1f}%)"
          f" ({smi})")
    return {"gqa_decode": c["gqa_decode"], "textrank": c["textrank"]}


def _p13_card_vs_cpu():
    """(d) reduced llama4-scout f32, card against CPU (module docstring).
    Returns the launches."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    base = dataclasses.replace(get_config(P13_ARCH).reduced(),
                               dtype="float32")
    params = M.init_params(base, seed=0, device=DEVICE)
    cpu_params = _to_cpu(params)
    reqs = _stream(seed=13, max_new=12, l_in_max=100)
    lens = {r["rid"]: len(r["tokens"]) for r in reqs}
    launches = {}
    for what, change, kw, kernel in (
            ("dense ring", {}, {}, "gqa_decode"),
            ("paged, window 0", dict(attention_window=0),
             dict(paged=True, block_size=16), "paged_decode")):
        cfg = dataclasses.replace(base, **change)
        card_r, cpu_r, cpu_log = {}, {}, {}
        _reset_launches()
        with _route_log(card_r, _engine_key):
            card, _ = _serve(cfg, params, [reqs], decode_k=4, **kw)
        launches[kernel] = _launch_counts((kernel,), f"(d) {what}")[kernel]
        with _route_log(cpu_r, _engine_key, replay=card_r), \
                _logit_log(cpu_log):
            cpu, _ = _serve(cfg, cpu_params, [reqs], decode_k=4, **kw)
        until = {rid: next((j for j, (a, b) in enumerate(zip(t, card[rid]))
                            if a != b), len(t)) for rid, t in cpu.items()}
        rflips, noise = _route_flips(
            cpu_r, card_r, lambda k: (k[0], k[1] - lens[k[0]]), until,
            f"(d) {what}: the CPU's own routing vs the card's",
            tie=lambda rec: rec[1][0] - rec[1][1] < P13_CPU_GAP)
        flips = 0
        for rid, j in until.items():
            if j == len(cpu[rid]) and len(card[rid]) == len(cpu[rid]):
                continue
            if j >= min(len(card[rid]), len(cpu[rid])):
                fail(f"(d) {what}: rid {rid} stopped at {len(card[rid])} "
                     f"tokens on the card, {len(cpu[rid])} on the CPU")
            top = torch.topk(cpu_log[rid][j], 2).values.tolist()
            print(f"[moe] (d) {what}: rid {rid} token {j}: card "
                  f"{card[rid][j:j + 1]} vs CPU {cpu[rid][j:j + 1]}; CPU "
                  f"top-2 logits {top}")
            if top[0] - top[1] >= 1e-5:
                fail(f"(d) {what}: tokens differ away from a near-tie "
                     f"(rid {rid})")
            flips += 1
        n = sum(len(t) for t in cpu.values())
        print(f"[moe] (d) reduced llama4-scout f32, {what}, decode_k 4: "
              f"{len(cpu)} requests / {n} tokens, card == CPU ({flips} "
              f"logit near-tie flips, {rflips} routing flips; largest top "
              f"router logit difference {noise:.3e}); {kernel} "
              f"launches {launches[kernel]}")
    del params
    torch.cuda.empty_cache()
    return launches


def phase_moe(smi):
    """Phase 13: the MoE block and llama4-scout at its published widths,
    depth cut to P13_LAYERS (module docstring). Returns the launches."""
    import torch
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg, nd = _p13_configs()
    params = M.init_params(cfg, seed=0, device=DEVICE)
    print(f"[moe] llama4-scout at {cfg.num_layers} of 48 layers: "
          f"{_nbytes(params) / 1e9:.2f} GB of weights "
          f"({cfg.num_params() / 1e9:.3f}e9 parameters), init "
          f"{time.perf_counter() - t0:.1f} s")
    parts = [time.perf_counter()]
    _p13_block(cfg, params, smi)
    parts.append(time.perf_counter())
    n = {"gqa_decode": _p13_batch(cfg, nd, params, smi)}
    parts.append(time.perf_counter())
    for k, v in _p13_fleet(*_depth_cut(cfg, params, P13_FLEET_LAYERS,
                                           P13_ARCH), smi).items():
        n[k] = n.get(k, 0) + v
    parts.append(time.perf_counter())
    peak = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()
    for k, v in _p13_card_vs_cpu().items():
        n[k] = n.get(k, 0) + v
    parts.append(time.perf_counter())
    print(f"[moe] phase 13: {parts[-1] - t0:.1f} s (init "
          f"{parts[0] - t0:.1f}, (a) {parts[1] - parts[0]:.1f}, (b) "
          f"{parts[2] - parts[1]:.1f}, (c) {parts[3] - parts[2]:.1f}, (d) "
          f"{parts[4] - parts[3]:.1f}); peak device memory "
          f"{peak / 1e9:.2f} GB; launches {n} ({smi})")
    if peak >= PEAK_LIMIT:
        fail(f"phase 13 peak device memory {peak / 1e9:.2f} GB")
    return n


# ---------------------------------------------------------------- phase 14
P14_HYBRID, P14_SSM = "zamba2-1.2b", "xlstm-350m"
P14_SHAPE = (4, 1024)          # (a): batch, tokens of a block's forward
P14_BATCH = (4, 1024, 32)      # (b), (c): batch, prompt, new tokens
P14_CONTEXTS = ((1, 1024, 16), (1, 8192, 16))   # (c): decode vs context
P14_FWD_REL = 2e-2             # tests/test_decode_consistency.py:51, f32
# (b), (c): bf16 decode vs the bf16 teacher-forced forward, of max|logit|:
# about twice the sound readings (zamba2 at 38 layers 0.04927 on the H100;
# the JAX package's own bf16 model at the published widths on the CPU,
# tests/ssm_bf16_drift.py: xlstm at 4 layers 0.03891, zamba2 at 16 layers
# 0.02622). xlstm's full depth is no sound reading: the same script reads
# the JAX package's bf16 xlstm 0.07886 at 8 layers and 0.2629 at 16
P14_BF16_REL = 0.1
P14_SSM_CUT = 4                # (c): xlstm's bf16 gate, its first group
# (d): tests/test_torch_ssm_model.py's (xLSTM's exp gates amplify f32
# rounding past 1e-5 of max|logit| between two summation orders)
P14_CPU_TOL = {"hybrid": 1e-5, "ssm": 3e-5}
P14_CPU_GAP = 1e-5             # (d): a token flip's CPU top-2 logit gap
P14_SLSTM_ITERS = 3            # (a): timed sLSTM forwards (host-bound)
P14_BLOCKS = (("mamba2", P14_HYBRID), ("mlstm", P14_SSM),
              ("slstm", P14_SSM))


def _p14_event_ms(fn, iters: int) -> float:
    """Milliseconds per call between CUDA events around ``iters`` calls,
    the device synchronised before, without ``cuda_ms``'s hold: a
    host-bound call (the sLSTM's loop over T) queues slower than the
    device runs it, so no hold can cover its queueing; the events then
    span the host's pace, which is the call's time."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _p14_costs(kind, cfg, p, b: int, t: int):
    """(bytes, FLOP) floors of one block call on ``b`` x ``t`` tokens
    (``t`` = 1: the decode step): the layer's weights read once, the
    input read and the output written (bf16), the state written (decode:
    read and written); the matmuls' FLOP (projections, the chunked scan's
    decay-kernel, chunk-state and inter-chunk products, the sLSTM's
    recurrent product)."""
    from repro_torch.models import ssm as S
    d = cfg.d_model
    io = 2 * b * t * d * 2
    if kind == "mamba2":
        d_inner, nh, n = S.mamba2_dims(cfg)
        hp = S.HEAD_P
        state = b * nh * hp * n * 4 + b * 3 * (d_inner + 2 * n) * 2
        proj = 2 * b * t * d * (2 * d_inner + 2 * n + nh + d_inner)
        if t == 1:
            return _nbytes(p) + io + 2 * state, proj + 4 * b * nh * hp * n
        q = min(cfg.ssm.chunk_size, t)
        scan = 2 * b * t * q * (n + nh * hp) + 4 * b * t * nh * hp * n
        return _nbytes(p) + io + b * nh * hp * n * 4, proj + scan
    nh = cfg.num_heads
    if kind == "mlstm":
        d_up = cfg.ssm.expand * d
        hp = d_up // nh
        state = b * nh * hp * hp * 4
        proj = 2 * b * t * (d * 2 * d_up + 3 * d_up * d_up + d_up * 2 * nh
                            + d_up * d)
        if t == 1:
            return _nbytes(p) + io + 2 * state, proj + 4 * b * nh * hp * hp
        q = min(cfg.ssm.chunk_size, t)
        scan = 4 * b * t * q * nh * hp + 4 * b * t * nh * hp * hp
        return _nbytes(p) + io + state, proj + scan
    hp = d // nh
    state = 3 * b * nh * hp * 4
    flops = 2 * b * t * (5 * d * d + nh * hp * 4 * hp)
    return _nbytes(p) + io + (2 if t == 1 else 1) * state, flops


def _p14_blocks(smi):
    """(a) Each recurrent block alone at its model's published widths,
    bf16, on one layer of random weights (module docstring)."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import ssm as S
    b, t = P14_SHAPE
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    for kind, arch in P14_BLOCKS:
        cfg = get_config(arch)
        init, fwd, dec = {
            "mamba2": (S.init_mamba2, S.mamba2_forward, S.mamba2_decode),
            "mlstm": (S.init_mlstm, S.mlstm_forward, S.mlstm_decode),
            "slstm": (S.init_slstm, S.slstm_forward, S.slstm_decode)}[kind]
        p = init(gen, cfg, (), torch.bfloat16, DEVICE)
        u = torch.randn((b, t, cfg.d_model), generator=gen,
                        device=DEVICE).to(torch.bfloat16)
        u1 = u[:, -1:].contiguous()
        y, state = fwd(p, cfg, u)
        if kind == "mamba2":
            state = {"h": state,
                     "conv": S._split_proj(p, cfg, u)[1][:, -3:].clone()}
        y1, new = dec(p, cfg, u1, state)
        if not (torch.isfinite(y).all() and torch.isfinite(y1).all()):
            fail(f"(a) {kind}: non-finite output")
        busy = ""
        if kind == "slstm":
            f_ms = _p14_event_ms(lambda: fwd(p, cfg, u), P14_SLSTM_ITERS)
            rows, wall = profile_calls(lambda: fwd(p, cfg, u), 1)
            dev_ms = sum(r[1] for r in rows) / 1e3
            busy = (f", device busy {100 * dev_ms / (1e3 * wall):.1f}% "
                    f"({dev_ms:.2f} ms of kernels in {1e3 * wall:.2f} ms "
                    f"profiled)")
        else:
            f_ms = cuda_ms(lambda: fwd(p, cfg, u), iters=10)
        d_ms = cuda_ms(lambda: dec(p, cfg, u1, state), iters=20)
        out = []
        for name, ms, tt in ((f"{kind}_forward", f_ms, t),
                             (f"{kind}_decode", d_ms, 1)):
            nbytes, flops = _p14_costs(kind, cfg, p, b, tt)
            b_ms = 1e3 * nbytes / HBM_BYTES_PER_S
            o_ms = 1e3 * flops / PEAK_OPS["bfloat16"]
            out.append(f"{name} {ms:.4f} ms (bytes floor {b_ms:.4f} ms: "
                       f"{nbytes / 1e6:.2f} MB; FLOP floor {o_ms:.4f} ms: "
                       f"{flops:.3e})")
        print(f"[recurrent] (a) {cfg.name} widths, bf16, B={b}, T={t}: "
              f"{'; '.join(out)}{busy} ({smi})")
        del p, u, y, state, new
    torch.cuda.empty_cache()


def _p14_forward(cfg, params, run):
    """Teacher-forced ``forward`` over ``run``'s prompt + fed tokens: the
    f32 logits at each generated position, (B, new, V). A sequence past
    one chunk must be a multiple of it (ssm.py's assert), so the input is
    padded at its tail with filler tokens up to the next multiple; the
    three blocks are causal, so the tail changes no earlier position,
    and only the real positions are returned."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import model as M
    p = run.prompt.shape[1]
    seq = torch.cat([run.prompt, run.tokens[:, :-1]], dim=1)
    n = seq.shape[1]
    chunk = cfg.ssm.chunk_size
    seq = F.pad(seq, (0, -n % chunk if n > chunk else 0), value=1)
    return M.forward(params, cfg, {"tokens": seq})[0][:, p - 1:n].float()


def _p14_rel(run, fwd) -> float:
    """Largest max|decode - forward| / max|forward| over the generated
    positions."""
    return max(float((lg.float() - fwd[:, j]).abs().max()
                     / fwd[:, j].abs().max())
               for j, lg in enumerate(run.logits))


def _p14_f32(cfg, params):
    """``cfg`` in f32 (registered under its own name so the launcher's
    ``--arch`` finds it) on ``params`` upcast: the same weights, exactly."""
    from repro_torch.configs import base
    from repro_torch.training import tree
    cfg32 = base.register(dataclasses.replace(cfg, dtype="float32",
                                              name=f"{cfg.name}-f32"))
    return cfg32, tree.map(lambda t: t.float(), params)


def _p14_bf16(cfg, params, run, what, gate):
    """The bf16 decode logits' distance from the bf16 teacher-forced
    forward (``_p14_rel``), held to P14_BF16_REL when ``gate``. Returns
    it and a note for the phase's line (the limit; the share of
    positions where the forward's argmax is the emitted token)."""
    fb = _p14_forward(cfg, params, run)
    rel = _p14_rel(run, fb)
    agree = float((fb.argmax(-1) == run.tokens).float().mean())
    if gate and rel >= P14_BF16_REL:
        fail(f"{what}: bf16 decode logits {rel:.5f} of max|logit| from the "
             f"bf16 teacher-forced forward (limit {P14_BF16_REL})")
    return rel, (f"{f'limit {P14_BF16_REL}' if gate else 'reported'}; "
                 f"forward's argmax the emitted token at {100 * agree:.2f}% "
                 f"of positions")


def _p14_consistency(cfg, params, run, shape, need, what, gate):
    """Decode against teacher forcing, in bf16 and in f32. bf16: the
    decode logits against the bf16 teacher-forced forward, held to
    P14_BF16_REL when ``gate`` (the module docstring says why xlstm's
    full depth is not); and against the f32 forward on the same weights
    (reported). f32: the launcher on the same weights upcast, its decode
    logits against an f32 teacher-forced forward over its own tokens,
    held to the reference's 2e-2 of max|logit|
    (tests/test_decode_consistency.py:51, an f32 test). Returns the f32
    run's launch counts."""
    import torch
    bf16, note = _p14_bf16(cfg, params, run, what, gate)
    cfg32, p32 = _p14_f32(cfg, params)
    truth = _p14_rel(run, _p14_forward(cfg32, p32, run))
    run32, counts = _serve_batch(batch_args(cfg32.name, shape), p32,
                                 tokens=run.prompt, need=need)
    f32 = _p14_rel(run32, _p14_forward(cfg32, p32, run32))
    print(f"[recurrent] {what}: decode vs teacher-forced forward over "
          f"prompt + {shape[2] - 1} fed tokens (padded to the chunk): bf16 "
          f"{bf16:.5f} of max|logit| ({note}), the bf16 decode against the "
          f"f32 forward on the same weights {truth:.5f} (reported); f32 "
          f"launcher run {f32:.3e} (limit {P14_FWD_REL}), prefill "
          f"{run32.prefill_ms:.2f} ms, decode {run32.decode_tok_s:.1f} "
          f"tokens/s, launches {counts}")
    if f32 >= P14_FWD_REL:
        fail(f"{what}: f32 decode logits {f32:.3e} of max|logit| from the "
             f"teacher-forced forward (limit {P14_FWD_REL})")
    del p32, run32
    torch.cuda.empty_cache()
    return counts


def _p14_xlstm_cut(cfg, params):
    """(c)'s bf16 gate: xlstm-350m cut to its first P14_SSM_CUT layers
    (the stacked pattern-group leaves sliced, not re-drawn) through the
    batch launcher, the bf16 decode logits against the bf16
    teacher-forced forward within P14_BF16_REL of max|logit|."""
    from repro_torch.configs import base
    from repro_torch.training import tree
    cut = base.register(dataclasses.replace(
        cfg, num_layers=P14_SSM_CUT, name=f"{cfg.name}-{P14_SSM_CUT}l"))
    groups = P14_SSM_CUT // len(cfg.ssm.block_pattern)
    p = dict(params, layers=tree.map(lambda a: a[:groups], params["layers"]))
    run, _ = _serve_batch(batch_args(cut.name, P14_BATCH), p)
    what = f"(c) xlstm-350m cut to {P14_SSM_CUT} layers"
    bf16, note = _p14_bf16(cut, p, run, what, gate=True)
    print(f"[recurrent] {what}: bf16 decode vs teacher-forced forward "
          f"{bf16:.5f} of max|logit| ({note}), prefill "
          f"{run.prefill_ms:.2f} ms, decode {run.decode_tok_s:.1f} tokens/s")


def _p14_zamba2(smi):
    """(b) zamba2-1.2b through the batch launcher (module docstring).
    Returns its gqa_decode launches."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    cfg = get_config(P14_HYBRID)
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, seed=0, device=DEVICE)
    args = batch_args(P14_HYBRID, P14_BATCH)
    held = {}
    with _live_kernel_hold(held):
        kern, counts = _serve_batch(args, params, need=("gqa_decode",))
    plain, _ = _serve_batch(args, params, tokens=kern.prompt, impl="torch")
    want, plain_log = _run_log(plain)
    got, path_log = _run_log(kern)
    flips = _bf16_flips(plain_log, path_log, want, got, "(b) zamba2-1.2b "
                        "kernel vs torch path", tag="recurrent")
    b, p, new = P14_BATCH
    shape = ("gqa_decode", (b, p + new))
    if shape not in held:
        fail(f"(b) no gqa_decode launch held at (B, S) = {shape[1]}")
    del plain_log, path_log
    peak = torch.cuda.max_memory_allocated()
    c32 = _p14_consistency(cfg, params, kern, P14_BATCH, ("gqa_decode",),
                           "(b) zamba2-1.2b", gate=True)
    print(f"[recurrent] (b) zamba2-1.2b, {cfg.num_layers} layers "
          f"({_nbytes(params) / 1e9:.2f} GB of bf16 weights), batch {b}, "
          f"prompt {p}, {new} new tokens: kernel: prefill "
          f"{kern.prefill_ms:.2f} ms, decode {kern.decode_tok_s:.1f} "
          f"tokens/s, {1e3 * b / kern.decode_tok_s:.2f} ms a step; torch "
          f"path: prefill {plain.prefill_ms:.2f} ms, decode "
          f"{plain.decode_tok_s:.1f} tokens/s, "
          f"{1e3 * b / plain.decode_tok_s:.2f} ms a step; gqa_decode "
          f"launches {counts['gqa_decode']} (= {_decode_launches(cfg)} x "
          f"{new - 1}); kernel vs torch path: {flips} near-tie divergences "
          f"(the drift above); the kernel held on live inputs "
          f"(max abs err, max|plain|): {held[shape][0]:.3e}, "
          f"{held[shape][1]:.4f}; peak device memory (bf16 runs) "
          f"{peak / 1e9:.2f} GB, with the f32 check "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({smi})")
    n = counts["gqa_decode"] + c32["gqa_decode"]
    del params, kern, plain
    torch.cuda.empty_cache()
    return n


def _p14_xlstm(smi):
    """(c) xlstm-350m through the batch launcher (module docstring)."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    cfg = get_config(P14_SSM)
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, seed=0, device=DEVICE)
    run, counts = _serve_batch(batch_args(P14_SSM, P14_BATCH), params)
    peak = torch.cuda.max_memory_allocated()
    _p14_consistency(cfg, params, run, P14_BATCH, (), "(c) xlstm-350m",
                     gate=False)
    _p14_xlstm_cut(cfg, params)
    b, p, new = P14_BATCH
    ctx = []
    for shape in P14_CONTEXTS:
        r, _ = _serve_batch(batch_args(P14_SSM, shape), params)
        ctx.append(f"1 x {shape[1]}: prefill {r.prefill_ms:.2f} ms, decode "
                   f"{1e3 * shape[0] / r.decode_tok_s:.2f} ms a step")
        del r
    print(f"[recurrent] (c) xlstm-350m, {cfg.num_layers} layers "
          f"({_nbytes(params) / 1e9:.2f} GB of bf16 weights), batch {b}, "
          f"prompt {p}, {new} new tokens: prefill {run.prefill_ms:.2f} ms, "
          f"decode {run.decode_tok_s:.1f} tokens/s, "
          f"{1e3 * b / run.decode_tok_s:.2f} ms a step; launches {counts} "
          f"(no attention: no kernel); peak device memory (bf16 run) "
          f"{peak / 1e9:.2f} GB; decode against context, "
          f"{'; '.join(ctx)} ({smi})")
    del params, run
    torch.cuda.empty_cache()


def _p14_rows(cfg, cache, b: int):
    """Row ``b`` of every leaf of a recurrent cache (its batch axis
    follows the layer axes: 2 in zamba2's stacked layout, else 1)."""
    from repro_torch.training import tree
    out = []
    for name, sub in cache.items():
        lead = 2 if (name == "ssm" and cfg.family == "hybrid" and
                     cfg.num_layers % cfg.ssm.shared_attn_every == 0) else 1
        out += [t.select(lead, b).clone() for t in tree.leaves(sub)]
    return out


def _p14_card_vs_cpu():
    """(d) reduced f32, the card against the CPU (module docstring).
    Returns the card's gqa_decode launches."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.training import tree
    launches, report = 0, []
    for name, kw in ((P14_SSM, {}), (P14_HYBRID, {}),
                     (P14_HYBRID, {"num_layers": 4})):
        cfg = dataclasses.replace(get_config(name).reduced(),
                                  dtype="float32", **kw)
        what = f"(d) {cfg.name} {cfg.num_layers} layers"
        tol = P14_CPU_TOL[cfg.family]
        params = M.init_params(cfg, seed=0, device=DEVICE)
        cpu = _to_cpu(params)
        gen = torch.Generator()
        gen.manual_seed(14)
        toks = torch.randint(1, cfg.vocab_size, (3, 40), generator=gen)
        worst = [0.0]

        def close(got, want, label):
            err = float((got.cpu() - want).abs().max()
                        / max(float(want.abs().max()), 1e-30))
            worst[0] = max(worst[0], err)
            if err > tol:
                fail(f"{what}: {label} card vs CPU {err:.3g} of max "
                     f"(limit {tol})")
        _reset_launches()
        batch = {"tokens": toks[:, :32], "cache_len": 64}
        kl, kc = M.prefill(params, cfg, dict(
            batch, tokens=batch["tokens"].to(DEVICE)))
        cl, cc = M.prefill(cpu, cfg, batch)
        close(kl, cl, "prefill logits")
        for i, (a, b) in enumerate(zip(tree.leaves(kc), tree.leaves(cc))):
            close(a, b, f"prefill cache leaf {i}")
        k0 = tree.map(lambda t: t.clone(), kc)
        c0 = tree.map(lambda t: t.clone(), cc)
        # greedy decode, each side feeding its own tokens
        kt, ct = kl.argmax(-1)[:, None], cl.argmax(-1)[:, None]
        got, want, same = [kt.cpu()], [ct], [True] * 3
        for j in range(8):
            kl, kc = M.decode_step(params, cfg, kt, kc, 32 + j)
            cl, cc = M.decode_step(cpu, cfg, ct, cc, 32 + j)
            for r in range(3):
                if same[r]:
                    close(kl[r], cl[r], f"decode step {j} row {r}")
            kt, ct = kl.argmax(-1)[:, None], cl.argmax(-1)[:, None]
            got.append(kt.cpu())
            want.append(ct)
            for r in range(3):
                if same[r] and int(kt[r]) != int(ct[r]):
                    top = torch.topk(cl[r], 2).values.tolist()
                    if top[0] - top[1] >= P14_CPU_GAP:
                        fail(f"{what}: row {r} step {j}: tokens differ away "
                             f"from a CPU near-tie ({top})")
                    same[r] = False
        # one masked step: row 2 inactive keeps every state bit
        row2 = _p14_rows(cfg, kc, 2)
        active = torch.tensor([True, True, False])
        M.decode_step(params, cfg, kt, kc, 40, active=active.to(DEVICE))
        if not all(torch.equal(a, b) for a, b in zip(_p14_rows(cfg, kc, 2),
                                                     row2)):
            fail(f"{what}: an inactive decode row's state changed")
        # prefill_chunk on the prefilled caches, row 2 idle
        start = torch.tensor([32, 32, 32])
        lengths = torch.tensor([8, 5, 0])
        idle = _p14_rows(cfg, k0, 2)
        kl, k0 = M.prefill_chunk(params, cfg, toks[:, 32:].to(DEVICE), k0,
                                 start.to(DEVICE),
                                 lengths.to(DEVICE))
        cl, c0 = M.prefill_chunk(cpu, cfg, toks[:, 32:], c0, start, lengths)
        close(kl[:2], cl[:2], "prefill_chunk logits")
        for i, (a, b) in enumerate(zip(tree.leaves(k0), tree.leaves(c0))):
            close(a, b, f"prefill_chunk cache leaf {i}")
        if not all(torch.equal(a, b) for a, b in zip(_p14_rows(cfg, k0, 2),
                                                     idle)):
            fail(f"{what}: an idle prefill_chunk row's state changed")
        counts = _launch_counts(("gqa_decode",) if cfg.family == "hybrid"
                                else (), what)
        if cfg.family == "ssm" and any(counts.values()):
            fail(f"{what}: an xLSTM launched {counts}")
        launches += counts["gqa_decode"]
        report.append(f"{cfg.name} at {cfg.num_layers} layers within "
                      f"{worst[0]:.3g} (limit {tol}), "
                      f"{sum(not s for s in same)} near-tie flips, "
                      f"gqa_decode {counts['gqa_decode']}")
        del params, cpu, kc, k0
    torch.cuda.empty_cache()
    print(f"[recurrent] (d) reduced f32, card vs CPU (prefill, 8 greedy "
          f"decode steps, prefill_chunk with an idle row; logits and every "
          f"cache leaf, idle and inactive rows bitwise): "
          f"{'; '.join(report)}")
    return launches


def phase_recurrent(smi):
    """Phase 14: the recurrent families (module docstring). Returns the
    launches."""
    import torch
    t0 = time.perf_counter()
    parts = [t0]
    _p14_blocks(smi)
    parts.append(time.perf_counter())
    n = _p14_zamba2(smi)
    parts.append(time.perf_counter())
    _p14_xlstm(smi)
    parts.append(time.perf_counter())
    n += _p14_card_vs_cpu()
    parts.append(time.perf_counter())
    torch.cuda.empty_cache()
    print(f"[recurrent] phase 14: {parts[-1] - t0:.1f} s ((a) "
          f"{parts[1] - parts[0]:.1f}, (b) {parts[2] - parts[1]:.1f}, (c) "
          f"{parts[3] - parts[2]:.1f}, (d) {parts[4] - parts[3]:.1f}); "
          f"gqa_decode launches {n} ({smi})")
    return {"gqa_decode": n}


# ---------------------------------------------------------------- phase 15
P15_ARCH = "llama-3.2-vision-11b"
P15_GATES = (0.5, -0.7)        # every cross layer's gate, gate_mlp: at the
                               # reference's zeros a cross layer is the
                               # identity and would hide a wrong one
P15_BATCH = (4, 1024, 16)      # (a): batch, prompt, new tokens
P15_TF = (2, 512, 16)          # (b): teacher forcing, random frontend
# (b) in f32: decode against its own teacher-forced forward, of
# max|logit|. The reference's f32 test bound (2e-2,
# tests/test_decode_consistency.py:51) passes planted faults here: the
# RMSNorm's mean square rounded to bf16 reads 1.795e-02, cross-attention
# dropped at decode 3.201e-04; every sound path 1.774e-05
# (tests/vlm_truth_controls.py, PERF.md section 6).
P15_FWD_REL = 1e-4
# A bf16 path's largest distance from the f32 truth (ulps of the truth's
# top logit), at most this times the torch path's (the reference's
# rounding: bf16 scores and P.V). At 40 + 8 layers two valid bf16
# roundings of one decode step (the kernel, its f32 plain version, the
# torch path) sit 10.6-13.8 ulps apart, past BF16_DRIFT_ULPS, and each
# 17.6-20.1 from the truth. Sound paths read 0.837-1.065 of the base,
# K/V rounded through fp8 2.946-3.399, the cross gates without tanh
# 1.315-2.266 (tests/vlm_truth_controls.py, PERF.md section 6).
P15_TRUTH_RATIO = 1.25
P15_LONG_CTX = 2048            # (c): contexts 256 / 2048 (phase 13's), the
P15_C_CHUNK = 128              # boundary at 2 x c_chunk
P15_SHORT = (60, 120)          # (c): prompt tokens, the short pool
P15_INBAND = (330, 420)        # (c): B < L_total <= gamma * B: C&R
P15_NEW = 16                   # (c), (d): new tokens a request
P15_TO = dict(c_max=384)       # (d): the short pool's new context
P15_CPU_TOL = 1e-5             # (e): card vs CPU, of max
P15_CPU_GAP = 1e-5             # (e): a token flip's CPU top-2 logit gap


def _p15_model():
    """llama-3.2-vision-11b at its published widths and full depth, bf16,
    the port's ``init_params`` at seed 0 with every cross layer's gates
    set to P15_GATES."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    cfg = get_config(P15_ARCH)
    params = M.init_params(cfg, seed=0, device=DEVICE)
    _p15_gates(params)
    return cfg, params


def _p15_gates(params):
    params["cross"]["gate"].fill_(P15_GATES[0])
    params["cross"]["gate_mlp"].fill_(P15_GATES[1])


def _p15_frontend(cfg, b, dtype, seed=15):
    """A random frontend, normal x 0.02, (b, frontend_tokens, d_model)."""
    import torch
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    return (torch.randn((b, cfg.frontend_tokens, cfg.d_model),
                        generator=gen, device=DEVICE) * 0.02).to(dtype)


def _p15_cross_bytes(cfg) -> int:
    """The cross memory a decode step reads a slot: xk and xv of every
    group, F rows each."""
    from repro_torch.models import layers as L
    return (2 * (cfg.num_layers // cfg.cross_attn_every)
            * cfg.frontend_tokens * cfg.num_kv_heads * cfg.resolved_head_dim
            * L.torch_dtype(cfg.dtype).itemsize)


def _p15_prefill_flop(cfg, params, b: int, p: int) -> float:
    """Operations of ``prefill`` on b x p tokens: every decoder and cross
    layer's projections and MLP on the tokens, but the cross layers' K/V
    projections, which run on the F frontend rows; causal self-attention
    (the triangle), cross-attention over F rows; the LM head on the last
    token of each row."""
    from repro_torch.training import tree
    n_self = sum(t.numel() for t in tree.leaves(params["layers"]))
    x = params["cross"]["xattn"]
    n_kv = x["wk"].numel() + x["wv"].numel()
    n_cross = sum(t.numel() for t in tree.leaves(params["cross"])) - n_kv
    hhd = cfg.num_heads * cfg.resolved_head_dim
    groups, f = cfg.num_layers // cfg.cross_attn_every, cfg.frontend_tokens
    return (2.0 * (n_self + n_cross) * b * p + 2.0 * n_kv * b * f
            + 2.0 * cfg.num_layers * b * hhd * p * p
            + 4.0 * groups * b * hhd * p * f
            + 2.0 * cfg.d_model * cfg.vocab_size * b)


def _p15_rows(run, fe):
    """A batch run's rows as ``_p15_truth`` takes them: (prompt ids,
    emitted ids, {j: the logits behind token j}, the row's frontend)."""
    return [(run.prompt[r].tolist(), run.tokens[r].tolist(),
             {j: lg[r] for j, lg in enumerate(run.logits)}, fe[r:r + 1])
            for r in range(run.prompt.shape[0])]


def _p15_truth(cfg32, p32, rows) -> float:
    """The f32 truth of a bf16 path: a teacher-forced ``forward`` of the
    weights upcast over each row's prompt + emitted tokens (its own
    history) on the row's frontend upcast. Returns the path's largest
    distance from it over every emitted position, in bf16 ulps of the
    truth's top logit."""
    import torch
    from repro_torch.models import model as M
    worst = 0.0
    for prompt, out, logs, fe in rows:
        ids = torch.tensor([prompt + out[:-1]], device=DEVICE)
        truth = M.forward(p32, cfg32, {"tokens": ids,
                                       "frontend": fe.float()})[0][0]
        for j in range(len(out)):
            ref = truth[len(prompt) - 1 + j]
            err = float((logs[j].to(DEVICE).float() - ref).abs().max())
            worst = max(worst, err / _bf16_ulp(float(ref.max())))
        del truth
    return worst


def _p15_truth_gate(what, got, plain, plain_name):
    """Hold a path's distance from the f32 truth to P15_TRUTH_RATIO x the
    plain path's."""
    if got > P15_TRUTH_RATIO * plain:
        fail(f"{what}: {got:.2f} ulps from the f32 truth, past "
             f"{P15_TRUTH_RATIO} x the {plain_name}'s {plain:.2f}")
    return (f"{got:.2f} ulps from the f32 truth against the {plain_name}'s "
            f"{plain:.2f} (at most {P15_TRUTH_RATIO}x)")


def _p15_launcher(cfg, params):
    """(a) the batch launcher through the kernel (held on live inputs)
    and through the torch path on the same prompts, the launcher's
    constant frontend; the kernel path against the torch path by the
    near-tie rule, the drift reported. Returns ({"kernel", "torch":
    run}, launches, held, divergences)."""
    held = {}
    args = batch_args(cfg.name, P15_BATCH)
    with _live_kernel_hold(held):
        kern, counts = _serve_batch(args, params, need=("gqa_decode",))
    plain, _ = _serve_batch(args, params, tokens=kern.prompt, impl="torch")
    (want, plain_log), (got, kern_log) = _run_log(plain), _run_log(kern)
    flips = _bf16_flips(plain_log, kern_log, want, got,
                        "(a) kernel vs torch path", tag="vlm", limit=None)
    kern.cache = plain.cache = None
    return {"kernel": kern, "torch": plain}, counts, held, flips


def _p15_report_a(cfg, params, runs, counts, held, flips, truth, smi):
    kern, plain = runs["kernel"], runs["torch"]
    b, p, n = P15_BATCH
    step_ms = 1e3 * b / kern.decode_tok_s
    w_bytes = _nbytes(params)
    # a step reads every weight but the embedding table (b rows gathered),
    # the self-attention KV up to the last position, the cross memory
    w_read = w_bytes - _nbytes(params["embed"])
    kv_bytes = (cfg.num_layers * 2 * b * (p + n) * cfg.num_kv_heads
                * cfg.resolved_head_dim * 2)
    x_bytes = b * _p15_cross_bytes(cfg)
    floor_ms = 1e3 * (w_read + kv_bytes + x_bytes) / HBM_BYTES_PER_S
    flop = _p15_prefill_flop(cfg, params, b, p)
    hs = {f"B={k[1][0]} S={k[1][1]}": f"{v[0]:.3e}" for k, v in held.items()}
    print(f"[vlm] (a) {cfg.name} bf16 ({w_bytes / 1e9:.2f} GB of weights, "
          f"{cfg.num_layers} layers, {cfg.num_layers // cfg.cross_attn_every}"
          f" cross layers over {cfg.frontend_tokens} frontend rows, gates "
          f"{P15_GATES}), batch launcher {b} x {p} + {n} new, the "
          f"launcher's constant frontend: prefill {kern.prefill_ms:.2f} ms "
          f"in the kernel run (the phase's first), {plain.prefill_ms:.2f} "
          f"ms in the torch run (prefill runs no decode kernel; compute "
          f"floor {1e3 * flop / PEAK_OPS['bfloat16']:.2f} ms: {flop:.3e} "
          f"FLOP); kernel "
          f"decode {step_ms:.2f} ms a step ({kern.decode_tok_s:.1f} "
          f"tokens/s) against a bytes floor of {floor_ms:.2f} ms (weights "
          f"but the embedding {w_read / 1e9:.2f} GB, self-attention KV "
          f"{kv_bytes / 1e6:.1f} MB, cross memory {x_bytes / 1e6:.1f} MB "
          f"= {b} x {_p15_cross_bytes(cfg) / 1e6:.1f} MB a slot); torch "
          f"path decode {1e3 * b / plain.decode_tok_s:.2f} ms a step; "
          f"gqa_decode "
          f"launches {counts['gqa_decode']} (= {cfg.num_layers} x {n - 1}); "
          f"{flips} near-tie divergences from the torch path; {truth}; "
          f"kernel held on live inputs {hs} ({smi})")


def _p15_teacher(cfg, params):
    """(b) bf16: the launcher on a random frontend and the teacher-forced
    ``forward`` over its prompt + fed tokens. Returns (the run, its
    frontend, the forward's logits at each generated position, the
    decode-vs-forward drift in ulps, launches)."""
    import torch
    b, p, n = P15_TF
    fe = _p15_frontend(cfg, b, torch.bfloat16)
    run, counts = _serve_batch(batch_args(cfg.name, P15_TF), params,
                               need=("gqa_decode",), frontend=fe)
    run.cache = None
    seq = torch.cat([run.prompt, run.tokens[:, :-1]], dim=1)
    from repro_torch.models import model as M
    fwd = M.forward(params, cfg, {"tokens": seq, "frontend": fe})[0][
        :, p - 1:].clone()
    drift = _ulps(torch.stack(run.logits, dim=1), fwd)
    return run, fe, fwd, drift, counts["gqa_decode"]


def _p15_f32(cfg, params, tf, smi):
    """The f32 truth (module docstring): (a)'s, (b)'s and (c)'s paths
    against it, and (b) in f32 at full depth, decode against its own
    teacher-forced forward. ``tf``: "a" (a)'s runs, "b"
    ``_p15_teacher``'s result, "c" (kernel run, torch run, the short
    pool's frontend). Returns (the notes for (a), (b)'s line and (c)'s
    note, the f32 run's launches)."""
    import torch
    from repro_torch.configs import base
    from repro_torch.models import model as M
    from repro_torch.training import tree
    cfg32 = base.register(dataclasses.replace(cfg, dtype="float32",
                                              name=f"{cfg.name}-f32"))
    p32 = tree.map(lambda t: t.float(), params)
    notes = {}
    with torch.no_grad():
        fe = (torch.ones((P15_BATCH[0], cfg.frontend_tokens, cfg.d_model),
                         device=DEVICE) * 0.01).to(torch.bfloat16)
        t = {k: _p15_truth(cfg32, p32, _p15_rows(r, fe))
             for k, r in tf["a"].items()}
        notes["a"] = "the kernel path " + _p15_truth_gate(
            "(a) the kernel path", t["kernel"], t["torch"], "torch path")
        run, fe, fwd, drift, _ = tf["b"]
        t_dec = _p15_truth(cfg32, p32, _p15_rows(run, fe))
        fwd_rows = [(pr, out, {j: fwd[r, j] for j in range(len(out))}, f)
                    for r, (pr, out, _, f) in enumerate(_p15_rows(run, fe))]
        b_note = _p15_truth_gate("(b) bf16 decode", t_dec,
                                 _p15_truth(cfg32, p32, fwd_rows),
                                 "bf16 forward")
        kfl, pfl, mem = tf["c"]
        notes["c"] = "the kernel path " + _p15_truth_gate(
            "(c) the kernel fleet", _p15_truth(cfg32, p32, _p15_fleet_rows(
                kfl, mem)), _p15_truth(cfg32, p32, _p15_fleet_rows(pfl, mem)),
            "torch path")
    run32, c32 = _serve_batch(batch_args(cfg32.name, P15_TF), p32,
                              tokens=run.prompt, need=("gqa_decode",),
                              frontend=fe.float())
    seq = torch.cat([run32.prompt, run32.tokens[:, :-1]], dim=1)
    with torch.no_grad():
        f32 = M.forward(p32, cfg32, {"tokens": seq,
                                     "frontend": fe.float()})[0][
            :, P15_TF[1] - 1:]
    rel = max(float((lg.float() - f32[:, j]).abs().max()
                    / f32[:, j].abs().max())
              for j, lg in enumerate(run32.logits))
    b, p, n = P15_TF
    notes["b"] = (
        f"[vlm] (b) decode vs teacher-forced forward, {b} x {p} + {n - 1} "
        f"fed tokens, a random frontend (normal x 0.02), gates "
        f"{P15_GATES}: bf16 at {cfg.num_layers} layers, decode (kernel) vs "
        f"forward {drift:.2f} ulps of the top logit (BF16_DRIFT_ULPS "
        f"{BF16_DRIFT_ULPS}, reported), decode {b_note}; decode "
        f"{1e3 * b / run.decode_tok_s:.2f} ms a step; f32 on the same "
        f"weights upcast, decode (kernel) vs its own teacher-forced forward "
        f"{rel:.3e} of max|logit| (limit {P15_FWD_REL}), f32 prefill "
        f"{run32.prefill_ms:.2f} ms, decode "
        f"{1e3 * b / run32.decode_tok_s:.2f} ms a step, gqa_decode "
        f"{c32['gqa_decode']} ({smi})")
    if rel >= P15_FWD_REL:
        fail(f"(b) f32 decode logits {rel:.3e} of max|logit| from the "
             f"teacher-forced forward (limit {P15_FWD_REL})")
    del p32, run32, f32
    torch.cuda.empty_cache()
    return notes, c32["gqa_decode"]


@contextlib.contextmanager
def _p15_memory(params, frontends, seed=150):
    """Every VLM cache built inside holds in each slot the cross K/V of
    one random frontend (``_p15_frontend``, seed ``seed`` + the caches
    built so far; appended to ``frontends``), as ``prefill`` computes
    them. The engine never writes the memory (the reference's engine
    serves tokens only), so a pool's cross layers would attend zeros;
    with these rows they attend a frontend, the f32 truth can be
    computed, and a swap that restores them has bits to restore (a
    rebuilt pool's rows hold another frontend's)."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    orig = M.init_cache
    cross = M._unstack(params["cross"])

    def init_cache(cfg, *a, **kw):
        cache = orig(cfg, *a, **kw)
        if "xk" in cache:
            fe = _p15_frontend(cfg, 1, cache["xk"].dtype,
                               seed=seed + len(frontends))
            frontends.append(fe)
            for g, cp in enumerate(cross):
                k, v = L._kv(cp["xattn"], cfg, fe)
                cache["xk"][g].copy_(k.expand_as(cache["xk"][g]))
                cache["xv"][g].copy_(v.expand_as(cache["xv"][g]))
        return cache
    M.init_cache = init_cache
    try:
        yield
    finally:
        M.init_cache = orig


def _p15_requests(tokenizer):
    """(c) two short prompts (rids 0-1) and two in-band ones for C&R
    (20-21), P15_NEW new tokens each: all served by the short pool."""
    import numpy as np
    from repro_torch.serving.pools import GatewayRequest
    rng = np.random.default_rng(15)
    reqs = [GatewayRequest(i, varied_prompt(rng, n, tokenizer), P15_NEW)
            for i, n in enumerate(P15_SHORT)]
    reqs += [GatewayRequest(20 + i, varied_prompt(rng, n, tokenizer),
                            P15_NEW, category="rag")
             for i, n in enumerate(P15_INBAND)]
    return reqs


def _p15_fleet_run(cfg, params, impl, event=None, held=None,
                   pad_from=None):
    """P15's stream through phase 5's dense fleet at contexts 256 / 2048
    (``_p9_serve``) with ``decode_impl=impl``, each cache's cross memory
    a frontend's (``_p15_memory``), every emitted token's logits logged,
    decode and prefill dispatches timed, every swap-in read back
    (``_restore_probe``; a rebuilt engine's row tail past its old context
    ``pad_from[engine]``); ``held``: each decode kernel launch shape held
    against its plain version; ``event``: a reprovision. Returns the run
    (``frontends[i]``: the i-th cache built's)."""
    run = dict(prompts={}, log={}, decode=[], prefill=[], swaps=[],
               frontends=[], pad_from={} if pad_from is None else pad_from)
    with contextlib.ExitStack() as wraps:
        wraps.enter_context(_p15_memory(params, run["frontends"]))
        wraps.enter_context(_engine_prompts(run["prompts"]))
        wraps.enter_context(_decode_timer(run["decode"]))
        wraps.enter_context(_prefill_timer(run["prefill"]))
        wraps.enter_context(_restore_probe(run["swaps"], run["pad_from"]))
        if held is not None:
            wraps.enter_context(_live_kernel_hold(held))
        served = _p9_serve(cfg, params, False, run["log"], event=event,
                           reqs=_p15_requests, new=P15_NEW,
                           decode_impl=impl, long_ctx=P15_LONG_CTX,
                           c_chunk=P15_C_CHUNK)
    run.update(served)
    return run


def _p15_fleet_rows(run, fe):
    """A fleet run's requests as ``_p15_truth`` takes them, on the short
    pool's frontend ``fe`` (every P15 request is served there). The
    engine prefills the prompt and then decodes its last token again at
    position len(prompt) (``_batch_path``'s convention), so the history
    of output token j is prompt + [prompt[-1]] + out[:j]."""
    return [(list(run["prompts"][rid]) + [run["prompts"][rid][-1]], toks,
             run["log"][rid], fe) for rid, toks in run["tokens"].items()]


class _P15Reprovision:
    """(d) once a short-pool slot decodes, the short pool goes to
    P15_TO's c_max (n_max kept), mid-stream."""

    def __init__(self):
        self.pad_from, self.info = {}, None

    def pending(self):
        return False

    def on_round(self, rt, rounds, rebuilt):
        short = rt.engines[rt.router.names[0]]
        decoding = any(short.slot_req[s] is not None
                       and not short.slot_prefill_left[s]
                       and 0 < len(short.slot_out[s]) < P15_NEW
                       for s in range(short.n_max))
        old_c = short.c_max
        del short
        if self.info is None and decoding:
            self.info = rt.reprovision(rt.router.names[0], **P15_TO)
            new = rt.engines[rt.router.names[0]]
            self.pad_from[new] = old_c
            rebuilt.add(new)
            del new


def _p15_fleet(cfg, params):
    """(c) the K=2 fleet behind the C&R gateway, kernel and torch path.
    Returns (kernel run, torch run, held)."""
    held = {}
    kern = _p15_fleet_run(cfg, params, "kernel", held=held)
    c = kern["counts"]
    if c["textrank"] < len(P15_INBAND) or c["paged_decode"]:
        fail(f"(c) launches {c}: TextRank once per in-band request, no "
             f"paged kernel")
    need = {("gqa_decode", (4, P15_LONG_CTX // 8))}
    if not need <= set(held):
        fail(f"(c) decode kernel held at {sorted(held)}, not {sorted(need)}")
    plain = _p15_fleet_run(cfg, params, "torch")
    if plain["frontends"][0].ne(kern["frontends"][0]).any():
        fail("(c) the two runs' short pools hold other frontends")
    kern["flips"] = _bf16_flips(plain["log"], kern["log"], plain["tokens"],
                                kern["tokens"], "(c) kernel vs torch path",
                                tag="vlm", limit=None)
    return kern, plain, held


def _p15_report_c(cfg, kern, plain, held, truth, smi):
    dec_ms, cols, col_ms = _fleet_ms(kern)
    c = kern["counts"]
    lens = sorted(len(t) for t in kern["prompts"].values())
    hs = {f"B={k[1][0]} S={k[1][1]}": f"{v[0]:.3e}" for k, v in held.items()}
    print(f"[vlm] (c) {cfg.name} {cfg.num_layers} layers, phase 5's K=2 "
          f"dense fleet at contexts {P15_LONG_CTX // 8} / {P15_LONG_CTX}, "
          f"c_chunk {P15_C_CHUNK}, n_max 4, decode_k 4, each pool's cross "
          f"memory a random frontend's: prompts {lens} tokens (after C&R) "
          f"+ {P15_NEW} new: {kern['secs']:.2f} s (logits logged), "
          f"{kern['rounds']} drive rounds; decode {dec_ms:.2f} ms per "
          f"dispatch ({len(kern['decode'])}); per-token prefill {cols} "
          f"token columns, {col_ms:.2f} ms a column; torch path "
          f"{plain['secs']:.2f} s; {kern['flips']} near-tie divergences; "
          f"{truth}; launches gqa_decode {c['gqa_decode']}, "
          f"textrank {c['textrank']}; kernel held on live inputs: {hs} "
          f"({smi})")


def _p15_reprovision(cfg, params, smi):
    """(d) the fleet's short pool reprovisioned mid-stream (module
    docstring). Returns the launches."""
    ev = _P15Reprovision()
    run = _p15_fleet_run(cfg, params, "kernel", event=ev,
                         pad_from=ev.pad_from)
    ins = [b for d, b, _ in run["swaps"] if d == "in"]
    if ev.info is None or not ins or ev.info["rerouted"]:
        fail(f"(d) reprovision {ev.info}: {len(ins)} swap-ins")
    d = run["counts"]
    print(f"[vlm] (d) the short pool reprovisioned mid-stream to {P15_TO} "
          f"(n_max kept): checkpointed {ev.info['checkpointed']}, migrated "
          f"{ev.info['migrated']}, rerouted {ev.info['rerouted']}; "
          f"{len(ins)} swap-ins ({sum(ins) / 2 ** 20:.1f} MiB) read back "
          f"bitwise, the cross memory (F = {cfg.frontend_tokens} rows, the "
          f"rebuilt pool's own rows another frontend's) included; every "
          f"request completes ({run['secs']:.2f} s); launches gqa_decode "
          f"{d['gqa_decode']}, textrank {d['textrank']} ({smi})")
    return d


def _card_vs_cpu_close(tol):
    """A check of a card tensor against its CPU twin, within ``tol`` of
    the CPU one's max; ``close.worst`` keeps the largest reading."""
    def close(got, want, label):
        err = float((got.cpu() - want).abs().max()
                    / max(float(want.abs().max()), 1e-30))
        close.worst = max(close.worst, err)
        if err > tol:
            fail(f"(e) {label} card vs CPU {err:.3g} of max (limit {tol})")
    close.worst = 0.0
    return close


def _rows(cache, b):
    """Row ``b`` of every leaf of a dense cache (batch on axis 1)."""
    from repro_torch.training import tree
    return [t.select(1, b).clone() for t in tree.leaves(cache)]


def _cross_card_vs_cpu(cfg, params, cpu, toks, fe, cache_len, close, gap):
    """(e) of phases 15 and 16: ``prefill`` of toks[:, :32] over the
    frontend ``fe`` on the card (``params``) and on the CPU (``cpu``),
    logits and every cache leaf through ``close``; 8 greedy decode steps
    from it (a row's tokens may part only where the CPU's top-2 logits
    are within ``gap``; its logits are held until they part); then a
    step with row 2 inactive, whose cache rows must stay bitwise.
    Returns (the card's and the CPU's prefill caches, cloned before the
    decode steps, the near-tie flips)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.training import tree
    batch = {"tokens": toks[:, :32], "frontend": fe, "cache_len": cache_len}
    kl, kc = M.prefill(params, cfg, {k: v.to(DEVICE) if k != "cache_len"
                                     else v for k, v in batch.items()})
    cl, cc = M.prefill(cpu, cfg, batch)
    close(kl, cl, "prefill logits")
    for i, (a, b) in enumerate(zip(tree.leaves(kc), tree.leaves(cc))):
        close(a, b, f"prefill cache leaf {i}")
    k0 = tree.map(lambda t: t.clone(), kc)
    c0 = tree.map(lambda t: t.clone(), cc)
    kt, ct = kl.argmax(-1)[:, None], cl.argmax(-1)[:, None]
    same = [True] * 3
    for j in range(8):
        kl, kc = M.decode_step(params, cfg, kt, kc, 32 + j)
        cl, cc = M.decode_step(cpu, cfg, ct, cc, 32 + j)
        for r in range(3):
            if same[r]:
                close(kl[r], cl[r], f"decode step {j} row {r}")
        kt, ct = kl.argmax(-1)[:, None], cl.argmax(-1)[:, None]
        for r in range(3):
            if same[r] and int(kt[r]) != int(ct[r]):
                top = torch.topk(cl[r], 2).values.tolist()
                if top[0] - top[1] >= gap:
                    fail(f"(e) row {r} step {j}: tokens differ away from a "
                         f"CPU near-tie ({top})")
                same[r] = False
    row2 = _rows(kc, 2)
    M.decode_step(params, cfg, kt, kc, 32 + 8,
                  active=torch.tensor([True, True, False], device=DEVICE))
    if not all(torch.equal(a, b) for a, b in zip(_rows(kc, 2), row2)):
        fail("(e) an inactive decode row's cache changed")
    return k0, c0, sum(not s for s in same)


def _p15_card_vs_cpu():
    """(e) reduced f32 (4 layers, 2 KV heads: two groups), the card
    against the CPU (module docstring). Returns the card's launches."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.training import tree
    cfg = dataclasses.replace(get_config(P15_ARCH).reduced(),
                              dtype="float32", num_layers=4, num_kv_heads=2)
    params = M.init_params(cfg, seed=0, device=DEVICE)
    _p15_gates(params)
    cpu = _to_cpu(params)
    gen = torch.Generator()
    gen.manual_seed(15)
    toks = torch.randint(1, cfg.vocab_size, (3, 40), generator=gen)
    fe = torch.randn((3, cfg.frontend_tokens, cfg.d_model),
                     generator=gen) * 0.02
    close = _card_vs_cpu_close(P15_CPU_TOL)
    _reset_launches()
    k0, c0, flips = _cross_card_vs_cpu(cfg, params, cpu, toks, fe, 64,
                                       close, P15_CPU_GAP)
    start, lengths = torch.tensor([32, 32, 32]), torch.tensor([8, 5, 0])
    idle = _rows(k0, 2)
    kl, k0 = M.prefill_chunk(params, cfg, toks[:, 32:].to(DEVICE), k0,
                             start.to(DEVICE), lengths.to(DEVICE))
    cl, c0 = M.prefill_chunk(cpu, cfg, toks[:, 32:], c0, start, lengths)
    close(kl[:2], cl[:2], "prefill_chunk logits")
    for i, (a, b) in enumerate(zip(tree.leaves(k0), tree.leaves(c0))):
        close(a, b, f"prefill_chunk cache leaf {i}")
    if not all(torch.equal(a, b) for a, b in zip(_rows(k0, 2), idle)):
        fail("(e) an idle prefill_chunk row's cache changed")
    counts = _launch_counts(("gqa_decode",), "(e)")
    print(f"[vlm] (e) reduced {cfg.name} f32 at {cfg.num_layers} layers (2 "
          f"groups, q_per_kv {cfg.q_per_kv}), gates {P15_GATES}, a random "
          f"frontend, card vs CPU (prefill, 8 greedy decode steps, a masked "
          f"step, prefill_chunk with an idle row; logits and every cache "
          f"leaf, xk / xv included): within {close.worst:.3g} of max (limit "
          f"{P15_CPU_TOL}), {flips} near-tie flips, idle "
          f"and inactive rows bitwise; gqa_decode {counts['gqa_decode']}")
    del params, cpu, k0
    torch.cuda.empty_cache()
    return counts["gqa_decode"]


def phase_vlm(smi):
    """Phase 15: the VLM family (module docstring). Returns the
    launches."""
    import torch
    t0 = time.perf_counter()
    parts = [t0]
    torch.cuda.reset_peak_memory_stats()
    cfg, params = _p15_model()
    runs, counts, held, flips = _p15_launcher(cfg, params)
    n = counts["gqa_decode"]
    parts.append(time.perf_counter())
    tf = _p15_teacher(cfg, params)
    n += tf[-1]
    parts.append(time.perf_counter())
    kfl, pfl, fheld = _p15_fleet(cfg, params)
    parts.append(time.perf_counter())
    notes, n32 = _p15_f32(cfg, params, {
        "a": runs, "b": tf, "c": (kfl, pfl, kfl["frontends"][0])}, smi)
    n += n32
    _p15_report_a(cfg, params, runs, counts, held, flips, notes["a"], smi)
    print(notes["b"])
    _p15_report_c(cfg, kfl, pfl, fheld, notes["c"], smi)
    parts.append(time.perf_counter())
    d = _p15_reprovision(cfg, params, smi)
    parts.append(time.perf_counter())
    del params, runs, tf, pfl
    torch.cuda.empty_cache()
    n += _p15_card_vs_cpu()
    parts.append(time.perf_counter())
    peak = torch.cuda.max_memory_allocated()
    out = {"gqa_decode": n + kfl["counts"]["gqa_decode"] + d["gqa_decode"],
           "textrank": kfl["counts"]["textrank"] + d["textrank"]}
    print(f"[vlm] phase 15: {parts[-1] - t0:.1f} s ((a) "
          f"{parts[1] - parts[0]:.1f} with the init, (b) "
          f"{parts[2] - parts[1]:.1f}, (c) {parts[3] - parts[2]:.1f}, the "
          f"f32 truth and (b) in f32 {parts[4] - parts[3]:.1f}, (d) "
          f"{parts[5] - parts[4]:.1f}, (e) {parts[6] - parts[5]:.1f}); peak "
          f"device memory {peak / 1e9:.2f} GB; launches {out} ({smi})")
    return out


P16_ARCH = "seamless-m4t-large-v2"
P16_BATCH = (4, 1024, 16)      # (a), (c): batch, prompt, new tokens
P16_TF = (2, 512, 16)          # (b) in f32: batch, prompt, new tokens
P16_TRAIN = (8, 128, 10)       # (d): global batch, sequence, steps
P16_XKV = ("xattn.wk", "xattn.wv")   # the cross K/V projections: run on
                                     # the encoder rows, not the tokens
P16_CPU_TOL = 1e-5             # (e): card vs CPU, of max
P16_CPU_GAP = 1e-5             # (e): a token flip's CPU top-2 logit gap


def _p16_model():
    """seamless-m4t-large-v2 at its published widths and full depth,
    bf16, the port's ``init_params`` at seed 0."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    cfg = get_config(P16_ARCH)
    return cfg, M.init_params(cfg, seed=0, device=DEVICE)


def _per_layer(stacked, skip=()) -> int:
    """Parameters of one layer of a stacked layer tree, the leaves named
    in ``skip`` (dotted paths) left out."""
    from repro_torch.training import tree
    return sum(t[0].numel() for n, t in zip(_leaf_names(stacked),
                                            tree.leaves(stacked))
               if n not in skip)


def _p16_layer_flop(cfg, params, b: int, s: int, causal: bool) -> float:
    """Operations of every encoder and decoder layer on b x s tokens over
    F frames: the encoder's projections and MLP on the frames and its
    attention over the full F x F square; the decoder's projections and
    MLP on the tokens but the cross K/V projections, which run on the F
    encoder rows; self-attention (``causal``: the triangle, else the
    square ``_sdpa`` computes), cross-attention over F rows."""
    f, hhd = cfg.frontend_tokens, cfg.num_heads * cfg.resolved_head_dim
    n_dec = _per_layer(params["layers"], P16_XKV)
    n_kv = _per_layer(params["layers"]) - n_dec
    self_attn = (2.0 if causal else 4.0) * hhd * s * s
    return (cfg.encoder_layers * b
            * (2.0 * _per_layer(params["encoder"]) * f + 4.0 * hhd * f * f)
            + cfg.num_layers * b * (2.0 * n_dec * s + 2.0 * n_kv * f
                                    + self_attn + 4.0 * hhd * s * f))


def _p16_decode_bytes(cfg, params, b: int, s: int):
    """What a decode step must read: (the weights: every decoder layer's
    but the cross K/V projections, the final norm and the LM head; the
    self-attention KV of b rows of s entries; the cross memory, b x F
    rows a layer)."""
    from repro_torch.models import layers as L
    x = params["layers"]["xattn"]
    w = (_nbytes(params["layers"]) - _nbytes({"k": x["wk"], "v": x["wv"]})
         + _nbytes(params["lm_head"]) + _nbytes(params["final_ln"]))
    row = (cfg.num_layers * 2 * cfg.num_kv_heads * cfg.resolved_head_dim
           * L.torch_dtype(cfg.dtype).itemsize)
    return w, row * b * s, row * b * cfg.frontend_tokens


def _p16_launcher(cfg, params, fe):
    """(a) the batch launcher on the random frontend ``fe`` through the
    kernel (held on live inputs) and through the torch path on the same
    prompts, the near-tie rule holding the first, its drift read; then
    the kernel path once more on the launcher's constant stub, timed.
    Returns ({"kernel", "torch", "stub": run}, launches, held,
    divergences, drift, the kernel run's cache bytes (self-attention,
    cross memory))."""
    held, out = {}, {}
    args = batch_args(cfg.name, P16_BATCH)
    with _live_kernel_hold(held):
        kern, counts = _serve_batch(args, params, need=("gqa_decode",),
                                    frontend=fe)
    plain, _ = _serve_batch(args, params, tokens=kern.prompt, impl="torch",
                            frontend=fe)
    (want, plain_log), (got, kern_log) = _run_log(plain), _run_log(kern)
    flips = _bf16_flips(plain_log, kern_log, want, got,
                        "(a) kernel vs torch path", tag="encdec", limit=None,
                        out=out)
    stub, c2 = _serve_batch(args, params, tokens=kern.prompt,
                            need=("gqa_decode",))
    if stub.cache["xk"].ne(kern.cache["xk"]).sum() == 0:
        fail("(a) the stub and the random frontend gave one cross memory")
    nbytes = (_nbytes(kern.cache["kv"]),
              _nbytes({k: kern.cache[k] for k in ("xk", "xv")}))
    for r in (kern, plain, stub):
        r.cache = None
    counts["gqa_decode"] += c2["gqa_decode"]
    return ({"kernel": kern, "torch": plain, "stub": stub}, counts, held,
            flips, out["drift"], nbytes)


def _p16_truth_rule(what, drift, got, plain, plain_name):
    """The rule of (a): a bf16 path within BF16_DRIFT_ULPS of the plain
    one passes; past it, its distance from the f32 truth must stay within
    P15_TRUTH_RATIO of the plain path's."""
    if drift <= BF16_DRIFT_ULPS:
        return (f"drift {drift:.2f} ulps within BF16_DRIFT_ULPS "
                f"{BF16_DRIFT_ULPS} (from the f32 truth {got:.2f}, the "
                f"{plain_name} {plain:.2f})")
    return (f"drift {drift:.2f} ulps past BF16_DRIFT_ULPS, so held to the "
            f"f32 truth: " + _p15_truth_gate(what, got, plain, plain_name))


def _p16_f32(cfg, params, p32, runs, fe, drift):
    """(a)'s and (b)'s bf16 paths against the f32 truth (``_p15_truth``,
    ``p32`` the weights upcast) by the rule of (a), and (b) in f32: the
    launcher at P16_TF on ``p32``, decode against its own teacher-forced
    forward within P15_FWD_REL of max|logit|. Returns ((a)'s note, (b)'s
    line, the f32 run's launches)."""
    import torch
    from repro_torch.configs import base
    from repro_torch.models import model as M
    kern = runs["kernel"]
    b, p, n = P16_BATCH
    with torch.no_grad():
        seq = torch.cat([kern.prompt, kern.tokens[:, :-1]], dim=1)
        fwd = M.forward(params, cfg, {"tokens": seq, "frontend": fe})[0][
            :, p - 1:].clone()
    tf_drift = _ulps(torch.stack(kern.logits, dim=1), fwd)
    cfg32 = base.register(dataclasses.replace(cfg, dtype="float32",
                                              name=f"{cfg.name}-f32"))
    with torch.no_grad():
        t_kern, t_plain = (_p15_truth(cfg32, p32, _p15_rows(runs[k], fe))
                           for k in ("kernel", "torch"))
        fwd_rows = [(pr, out, {j: fwd[r, j] for j in range(len(out))}, f)
                    for r, (pr, out, _, f) in enumerate(_p15_rows(kern,
                                                                  fe))]
        t_fwd = _p15_truth(cfg32, p32, fwd_rows)
    del fwd
    note_a = "the kernel path " + _p16_truth_rule(
        "(a) the kernel path", drift, t_kern, t_plain, "torch path")
    note_b = "decode (kernel) vs forward " + _p16_truth_rule(
        "(b) bf16 decode", tf_drift, t_kern, t_fwd, "bf16 forward")
    bt, pt, nt = P16_TF
    fe32 = fe[:bt].float()
    run32, c32 = _serve_batch(batch_args(cfg32.name, P16_TF), p32,
                              tokens=kern.prompt[:bt, :pt],
                              need=("gqa_decode",), frontend=fe32)
    run32.cache = None
    with torch.no_grad():
        seq = torch.cat([run32.prompt, run32.tokens[:, :-1]], dim=1)
        f32 = M.forward(p32, cfg32, {"tokens": seq, "frontend": fe32})[0][
            :, pt - 1:]
    rel = max(float((lg.float() - f32[:, j]).abs().max()
                    / f32[:, j].abs().max())
              for j, lg in enumerate(run32.logits))
    if rel >= P15_FWD_REL:
        fail(f"(b) f32 decode logits {rel:.3e} of max|logit| from the "
             f"teacher-forced forward (limit {P15_FWD_REL})")
    line_b = (f"[encdec] (b) decode vs teacher-forced forward: bf16 on (a)'s "
              f"kernel run ({b} x {p} + {n - 1} fed tokens, the random "
              f"frontend), {note_b}; f32 on the weights upcast, {bt} x {pt} "
              f"+ {nt - 1} fed tokens, decode (kernel) vs its own "
              f"teacher-forced forward {rel:.3e} of max|logit| (limit "
              f"{P15_FWD_REL}), f32 prefill {run32.prefill_ms:.2f} ms, decode "
              f"{1e3 * bt / run32.decode_tok_s:.2f} ms a step, gqa_decode "
              f"{c32['gqa_decode']}")
    del run32, f32
    torch.cuda.empty_cache()
    return note_a, line_b, c32["gqa_decode"]


def _p16_report_a(cfg, params, runs, counts, held, flips, note, smi):
    kern, plain, stub = runs["kernel"], runs["torch"], runs["stub"]
    b, p, n = P16_BATCH
    w, kv, cross = _p16_decode_bytes(cfg, params, b, p + n)
    floor_ms = 1e3 * (w + kv + cross) / HBM_BYTES_PER_S
    flop = _p16_layer_flop(cfg, params, b, p, causal=True) \
        + 2.0 * cfg.d_model * cfg.vocab_size * b
    hs = {f"B={k[1][0]} S={k[1][1]}": f"{v[0]:.3e}" for k, v in held.items()}
    print(f"[encdec] (a) {cfg.name} bf16 ({_nbytes(params) / 1e9:.2f} GB "
          f"of weights, {cfg.encoder_layers} encoder + {cfg.num_layers} "
          f"decoder layers, d_model {cfg.d_model}, {cfg.num_heads} / "
          f"{cfg.num_kv_heads} heads, hd {cfg.resolved_head_dim}, "
          f"{cfg.frontend_tokens} frames), batch launcher {b} x {p} + {n} "
          f"new on a random frontend (normal x 0.02): prefill "
          f"{kern.prefill_ms:.2f} ms in the kernel run (the phase's first), "
          f"{plain.prefill_ms:.2f} ms in the torch run, {stub.prefill_ms:.2f}"
          f" ms on the launcher's stub (compute floor "
          f"{1e3 * flop / PEAK_OPS['bfloat16']:.2f} ms: {flop:.4e} FLOP, the "
          f"encoder over {cfg.frontend_tokens} frames included); decode "
          f"{1e3 * b / kern.decode_tok_s:.2f} ms a step (kernel, random "
          f"frontend), {1e3 * b / stub.decode_tok_s:.2f} (kernel, stub), "
          f"{1e3 * b / plain.decode_tok_s:.2f} (torch path), against a "
          f"bytes floor of {floor_ms:.4f} ms ({(w + kv + cross) / 1e9:.4f} "
          f"GB: decoder weights but the cross K/V projections, the final "
          f"norm and the LM head {w / 1e9:.4f} GB, self-attention KV "
          f"{kv / 1e9:.4f} GB, cross memory {cross / 1e9:.4f} GB = {b} x "
          f"{cross / b / 1e6:.1f} MB, {100 * cross / (w + kv + cross):.1f}% "
          f"of the floor); gqa_decode launches {counts['gqa_decode']} (= 2 "
          f"x {cfg.num_layers} x {n - 1}, kernel and stub runs); {flips} "
          f"near-tie divergences from the torch path; {note}; kernel held "
          f"on live inputs {hs} ({smi})")


def _p16_fed(cfg, params, prompt, fe, tokens, impl="kernel"):
    """``prefill`` of ``prompt`` over ``fe``, then a decode step fed each
    of ``tokens`` but the last (through ``impl``). Returns the logits
    behind each token, f32."""
    import torch
    from repro_torch.models import model as M
    p, n = prompt.shape[1], tokens.shape[1]
    out = []
    with torch.no_grad():
        logits, cache = M.prefill(params, cfg, {
            "tokens": prompt, "frontend": fe, "cache_len": p + n})
        for t in range(n):
            out.append(logits.float())
            if t < n - 1:
                logits, cache = M.decode_step(params, cfg,
                                              tokens[:, t:t + 1], cache,
                                              p + t, decode_impl=impl)
    return out


def _rels(got, want):
    """max|got - want| / max|want| at each position."""
    return [float((g - w).abs().max() / w.abs().max())
            for g, w in zip(got, want)]


def _p16_int8(cfg, params, p32, runs, fe, nbytes, smi):
    """(c) ``--int8-kv`` on (a)'s prompts and frontend: the
    self-attention cache (hd int8 values and a bf16 scale an entry)
    exactly (hd + 2) / 2hd of the bf16 cache's bytes, the cross memory
    the bf16 run's dtype and bytes. Then int8 against the fp cache fed
    (a)'s kernel-run tokens: in f32 on the weights upcast (``p32``), the
    reference's measure (tests/test_perf_opts.py runs it in f32), the
    last-token logits within INT8_REL of max|logit|; in bf16 the same
    reading is reported beside the bf16 paths' own distance (the torch
    path fed the same tokens against the kernel run). Returns the
    launches."""
    import torch
    kern = runs["kernel"]
    b, p, n = P16_BATCH
    run8, c8 = _serve_batch(batch_args(cfg.name, P16_BATCH, int8=True),
                            params, tokens=kern.prompt,
                            need=("gqa_decode",), frontend=fe)
    hd = cfg.resolved_head_dim
    kv8 = _nbytes(run8.cache["kv"])
    x8 = {k: run8.cache[k] for k in ("xk", "xv")}
    if kv8 * 2 * hd != nbytes[0] * (hd + 2):
        fail(f"(c) int8 self-attention cache {kv8} B, not (hd + 2) / 2hd "
             f"of the bf16 cache's {nbytes[0]} B")
    if x8["xk"].dtype != torch.bfloat16 or _nbytes(x8) != nbytes[1]:
        fail(f"(c) the int8 run's cross memory {x8['xk'].dtype}, "
             f"{_nbytes(x8)} B, not the bf16 run's {nbytes[1]} B")
    same = float((run8.tokens == kern.tokens).float().mean())
    run8.cache = None
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    want = [lg.float() for lg in kern.logits]
    bf_int8 = _rels(_p16_fed(cfg8, params, kern.prompt, fe, kern.tokens),
                    want)
    bf_path = _rels(_p16_fed(cfg, params, kern.prompt, fe, kern.tokens,
                             impl="torch"), want)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    fe32 = fe.float()
    f32 = _p16_fed(cfg32, p32, kern.prompt, fe32, kern.tokens)
    rel = _rels(_p16_fed(dataclasses.replace(cfg32, kv_cache_dtype="int8"),
                         p32, kern.prompt, fe32, kern.tokens), f32)
    del f32
    print(f"[encdec] (c) --int8-kv, {b} x {p} + {n}, (a)'s prompts and "
          f"frontend: prefill {run8.prefill_ms:.2f} ms, decode "
          f"{1e3 * b / run8.decode_tok_s:.2f} ms a step, gqa_decode "
          f"{c8['gqa_decode']}; self-attention cache {kv8} B int8 vs "
          f"{nbytes[0]} B bf16 (= ({hd} + 2) / {2 * hd} exactly), cross "
          f"memory {_nbytes(x8)} B bf16 in both; tokens equal to the bf16 "
          f"run's at {100 * same:.2f}% of positions. Fed (a)'s kernel-run "
          f"tokens, max|dlogit| / max|logit| at the last token (largest "
          f"over the {n} positions): f32 int8 vs f32 fp {rel[-1]:.4f} "
          f"({max(rel):.4f}; limit {INT8_REL}); bf16 int8 vs the bf16 run "
          f"{bf_int8[-1]:.4f} ({max(bf_int8):.4f}), the bf16 torch path vs "
          f"the bf16 run {bf_path[-1]:.4f} ({max(bf_path):.4f}) ({smi})")
    if rel[-1] >= INT8_REL:
        fail(f"(c) f32 int8 last-token logits {rel[-1]:.4f} of max|logit| "
             f"from the fp cache's (limit {INT8_REL})")
    return c8["gqa_decode"]


def _p16_train(cfg, params, smi):
    """(d) ``launch/train.py``'s ``train()`` at full width and depth on
    ``params`` (trained in place), P16_TRAIN, the launcher's frontend
    stub: finite losses and grad norms, the reference's loss rule, the
    peak under PEAK_LIMIT, no kernel launched; then two more steps split
    into gradients and update."""
    import torch
    from repro_torch.launch import train
    from repro_torch.training import tree
    from repro_torch.training.optimizer import AdamWConfig, adamw_update
    from repro_torch.training.train_step import value_and_grad
    b, s, steps = P16_TRAIN
    args = train.parse_args(["--arch", cfg.name, "--steps", str(steps),
                             "--global-batch", str(b), "--seq-len", str(s),
                             "--device", DEVICE])
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    run = train.train(args, params=params,
                      log=lambda line: print(f"[encdec] (d) {line}"))
    counts = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if any(counts.values()):
        fail(f"(d) training launched a kernel of the port: {counts}")
    bad = [i for i, (l, g) in enumerate(zip(run.losses, run.gnorms))
           if not (math.isfinite(l) and math.isfinite(g))]
    if bad:
        fail(f"(d) non-finite loss or grad norm at steps {bad}")
    if not min(run.losses[4:]) < run.losses[0] + 0.02:
        fail(f"(d) the loss did not fall: {run.losses}")
    if peak >= PEAK_LIMIT:
        fail(f"(d) peak memory {_gb(peak)} >= {_gb(PEAK_LIMIT)}")
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(2, steps // 10),
                          total_steps=steps)
    batch = _train_batch(cfg, b, s, steps)
    batch["frontend"] = torch.ones((b, cfg.frontend_tokens, cfg.d_model),
                                   dtype=torch.bfloat16, device=DEVICE) * 0.01
    split = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, grads = value_and_grad(run.params, cfg, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        run.params, run.opt, _ = adamw_update(opt_cfg, grads, run.opt,
                                              run.params)
        torch.cuda.synchronize()
        split.append((1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t1)))
        del grads
    n = sum(t.numel() for t in tree.leaves(run.params))
    flops = 4.0 * _p16_layer_flop(cfg, run.params, b, s, causal=False) \
        + 3.0 * 2.0 * b * s * cfg.d_model * cfg.vocab_size
    compute_ms = 1e3 * flops / PEAK_OPS["bfloat16"]
    opt_ms = 1e3 * OPT_BYTES * n / HBM_BYTES_PER_S
    steady = sorted(run.step_s[1:])
    med = 1e3 * steady[len(steady) // 2]
    print(f"[encdec] (d) train() on {cfg.name} at its published widths and "
          f"full depth ({cfg.encoder_layers} + {cfg.num_layers} layers, "
          f"{n / 1e9:.4f} B parameters; weights, grads and AdamW moments "
          f"{_gb(12 * n)}), bf16, seed 0, batch {b} x {s} with the "
          f"launcher's frontend stub ({cfg.frontend_tokens} frames), remat "
          f"layer, {steps} steps; losses "
          + ", ".join(f"{x:.4f}" for x in run.losses) + "; grad norms "
          + ", ".join(f"{x:.4f}" for x in run.gnorms)
          + f"; ms a step (host clock, device synchronised): first "
          f"{1e3 * run.step_s[0]:.2f}, steps 1-{steps - 1} median {med:.2f} "
          f"(min {1e3 * steady[0]:.2f}, max {1e3 * steady[-1]:.2f}); "
          f"{b * s / med * 1e3:.1f} tokens/s; split: gradients "
          + ", ".join(f"{g:.2f}" for g, _ in split) + " ms, AdamW update "
          + ", ".join(f"{u:.2f}" for _, u in split) + f" ms; floor "
          f"{compute_ms + opt_ms:.2f} ms = {flops:.4g} FLOP / 989 TFLOP/s "
          f"({compute_ms:.2f} ms) + {OPT_BYTES} B x {n / 1e9:.4f} B "
          f"parameters / 3.35 TB/s ({opt_ms:.2f} ms); peak "
          f"max_memory_allocated {_gb(peak)} ({_gb(peak - base_mem)} above "
          f"the weights held before; limit {_gb(PEAK_LIMIT)}); no kernel of "
          f"the port launched ({smi})")
    return run


def _p16_card_vs_cpu():
    """(e) reduced seamless-m4t f32, the card against the CPU: forward
    logits, then ``_cross_card_vs_cpu`` (prefill, 8 greedy decode steps,
    a masked step), within P16_CPU_TOL of max. Returns the card's
    launches."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config(P16_ARCH).reduced(),
                              dtype="float32")
    params = M.init_params(cfg, seed=0, device=DEVICE)
    cpu = _to_cpu(params)
    gen = torch.Generator()
    gen.manual_seed(16)
    toks = torch.randint(1, cfg.vocab_size, (3, 40), generator=gen)
    fe = torch.randn((3, cfg.frontend_tokens, cfg.d_model),
                     generator=gen) * 0.02
    close = _card_vs_cpu_close(P16_CPU_TOL)
    _reset_launches()
    with torch.no_grad():
        close(M.forward(params, cfg, {"tokens": toks.to(DEVICE),
                                      "frontend": fe.to(DEVICE)})[0],
              M.forward(cpu, cfg, {"tokens": toks, "frontend": fe})[0],
              "forward logits")
        flips = _cross_card_vs_cpu(cfg, params, cpu, toks, fe, 48, close,
                                   P16_CPU_GAP)[2]
    counts = _launch_counts(("gqa_decode",), "(e)")
    print(f"[encdec] (e) reduced {cfg.name} f32 ({cfg.encoder_layers} + "
          f"{cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.frontend_tokens} frames), a random frontend, card vs CPU "
          f"(forward, prefill, 8 greedy decode steps, a masked step; logits "
          f"and every cache leaf, xk / xv included): within "
          f"{close.worst:.3g} of max (limit {P16_CPU_TOL}), {flips} "
          f"near-tie flips, the inactive row bitwise; gqa_decode "
          f"{counts['gqa_decode']}")
    del params, cpu
    torch.cuda.empty_cache()
    return counts["gqa_decode"]


def phase_encdec(smi):
    """Phase 16: the encoder-decoder family (module docstring). Returns
    the launches."""
    import gc
    import torch
    from repro_torch.training import tree
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    parts = [t0]
    torch.cuda.reset_peak_memory_stats()
    cfg, params = _p16_model()
    fe = _p15_frontend(cfg, P16_BATCH[0], torch.bfloat16, seed=16)
    runs, counts, held, flips, drift, nbytes = _p16_launcher(cfg, params,
                                                             fe)
    n = counts["gqa_decode"]
    parts.append(time.perf_counter())
    p32 = tree.map(lambda t: t.float(), params)
    note_a, line_b, n32 = _p16_f32(cfg, params, p32, runs, fe, drift)
    n += n32
    _p16_report_a(cfg, params, runs, counts, held, flips, note_a, smi)
    print(f"{line_b} ({smi})")
    parts.append(time.perf_counter())
    n += _p16_int8(cfg, params, p32, runs, fe, nbytes, smi)
    parts.append(time.perf_counter())
    del runs, p32
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    run = _p16_train(cfg, params, smi)
    peak = max(peak, torch.cuda.max_memory_allocated())
    del params, run
    torch.cuda.empty_cache()
    parts.append(time.perf_counter())
    n += _p16_card_vs_cpu()
    parts.append(time.perf_counter())
    out = {"gqa_decode": n}
    print(f"[encdec] phase 16: {parts[-1] - t0:.1f} s ((a) "
          f"{parts[1] - parts[0]:.1f} with the init, the f32 truth and (b) "
          f"{parts[2] - parts[1]:.1f}, (c) {parts[3] - parts[2]:.1f}, (d) "
          f"{parts[4] - parts[3]:.1f}, (e) {parts[5] - parts[4]:.1f}); "
          f"device memory held from earlier phases at its start "
          f"{mem0 / 1e9:.2f} GB; peak {peak / 1e9:.2f} GB; launches {out} "
          f"({smi})")
    return out


# ---------------------------------------------------------------- phase 17
P17_ARCH = "deepseek-v2-236b"
P17_LAYERS = 6                # of 60: 50.72 GB of bf16 weights
# (c): capacity_factor of the no-drop copy. The reference test's 8.0
# gives each of 160 experts ceil(T k cf^2 / E) rows: 1.57e6 rows (16 GB
# of bf16 buffer) at 4 x 1039 tokens, beside 50.7 GB of weights; at 4.0
# each expert holds 16x its mean load, and (c) fails if a pair drops (at
# 2.0, 4x, random weights overloaded experts past it:
# tests/mla_truth_controls.py read 986 dropped pairs at 2 layers).
P17_NO_DROP = 4.0
P17_BLOCK = (4, 1024)         # (a): mla_attention's batch and tokens
P17_DECODE = (4, 2048)        # (a): mla_decode's rows and cache entries
P17_FLASH = (1, 8192)         # (a), (b): the flash branch's shape
P17_BATCH = (4, 1024, 16)     # (b), (c): batch, prompt, new tokens
P17_F32_LAYERS = 2            # (c): the f32 copy (36.6 GB) at 2 of 60
P17_TF32 = (2, 512, 16)       # (c): f32 batch, prompt, new tokens
P17_FLEET_LAYERS = 2          # (d): the fleet's depth (6 until phase 18
                              # needed the time)
P17_LONG_CTX = 2048           # (d): contexts 256 / 2048, phase 13's,
P17_C_CHUNK = 128             # with the boundary at 2 x c_chunk
P17_SHORT = (100, 180)        # (d): prompt tokens, the short pool
P17_INBAND = (330, 420)       # (d): B < L_total <= gamma * B: C&R
P17_LONG = (530,)             # (d): > gamma * B: the long pool
P17_NEW = P15_NEW             # (d): new tokens a request (16); the
                              # reprovision is phase 15's (c_max 384)
P17_CPU_TOL = 1e-5            # (e): card vs CPU, of max
P17_CPU_GAP = 1e-5            # (e): a token flip's CPU top-2 logit gap


def _p17_configs(layers=P17_LAYERS, dtype="bfloat16"):
    """deepseek-v2 at its published widths with the depth cut to
    ``layers``, and its copy at capacity_factor P17_NO_DROP, both
    registered under their own names (the batch launcher's ``--arch``
    finds them)."""
    from repro_torch.configs import base
    tag = "" if dtype == "bfloat16" else "-f32"
    cfg = dataclasses.replace(base.get_config(P17_ARCH), num_layers=layers,
                              dtype=dtype,
                              name=f"{P17_ARCH}-{layers}-layers{tag}")
    nd = dataclasses.replace(cfg, name=f"{cfg.name}-no-drop",
                             moe=dataclasses.replace(
                                 cfg.moe, capacity_factor=P17_NO_DROP))
    return base.register(cfg), base.register(nd)


def _p17_attn_flop(cfg, p, b: int, s: int) -> float:
    """Operations of ``mla_attention`` on b x s tokens: every projection
    on each token (``wuk`` / ``wuv`` on its latent) and the causal
    triangle's scores and weighted values at q/k head dim nope + rope, v
    head dim v_head_dim."""
    m = cfg.mla
    proj = sum(t.numel() for k, t in p.items() if k != "kv_norm")
    return (2.0 * b * s * proj + 2.0 * b * cfg.num_heads * s * (s + 1) / 2
            * (m.nope_head_dim + m.rope_head_dim + m.v_head_dim))


def _p17_block(smi):
    """(a) one layer's MLA at full width alone (module docstring)."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import mla
    cfg = get_config(P17_ARCH)
    m, d, h = cfg.mla, cfg.d_model, cfg.num_heads
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(17)
    p = mla.init_mla(gen, cfg, (), torch.bfloat16, DEVICE)
    w = _nbytes(p)
    b, s = P17_BLOCK
    x = torch.randn((b, s, d), generator=gen, device=DEVICE).to(
        torch.bfloat16)
    out = mla.mla_attention(p, cfg, x)
    if not all(torch.isfinite(t).all() for t in out):
        fail("(a) mla_attention: non-finite output")
    ms = cuda_ms(lambda: mla.mla_attention(p, cfg, x), iters=5)
    moved = w + 2 * (2 * x.numel() + b * s * (m.kv_lora_rank
                                              + m.rope_head_dim))
    flop = _p17_attn_flop(cfg, p, b, s)
    bound, by = _bound(moved, flop, "bfloat16")
    del out
    bd, sd = P17_DECODE
    kv = {"c_kv": torch.randn((bd, sd, m.kv_lora_rank), generator=gen,
                              device=DEVICE).to(torch.bfloat16),
          "k_r": torch.randn((bd, sd, m.rope_head_dim), generator=gen,
                             device=DEVICE).to(torch.bfloat16)}
    xd = x[:, :1].clone()
    idx = L.decode_index(cfg, sd - 1, kv, None, 0)
    if not torch.isfinite(mla.mla_decode(p, cfg, xd, kv, idx)).all():
        fail("(a) mla_decode: non-finite output")
    ms_d = cuda_ms(lambda: mla.mla_decode(p, cfg, xd, kv, idx), iters=10)
    rows = _nbytes(kv)
    moved_d = w + rows + 2 * 2 * xd.numel()
    flop_d = (2.0 * bd * sum(t.numel() for k, t in p.items()
                             if k != "kv_norm")
              + 2.0 * bd * h * sd * (2 * m.kv_lora_rank + m.rope_head_dim))
    bound_d, by_d = _bound(moved_d, flop_d, "bfloat16")
    print(f"[mla] (a) one MLA layer of {P17_ARCH} (d_model {d}, {h} heads, "
          f"latent {m.kv_lora_rank}, rope {m.rope_head_dim}, nope "
          f"{m.nope_head_dim}, v {m.v_head_dim}; {w / 1e9:.4f} GB of "
          f"weights): mla_attention (plain branch) {b} x {s}: {ms:.4f} ms "
          f"against {bound:.4f} ms ({by}: {moved / 1e9:.4f} GB at 3.35 TB/s,"
          f" {flop:.4e} FLOP at 989 TFLOP/s; {100 * bound / ms:.1f}%); "
          f"mla_decode (absorbed) B={bd} over {sd} cache entries "
          f"({rows / 1e6:.2f} MB of latent rows): {ms_d:.4f} ms against "
          f"{bound_d:.4f} ms ({by_d}: {moved_d / 1e9:.4f} GB, {flop_d:.4e} "
          f"FLOP; {100 * bound_d / ms_d:.1f}%) ({smi})")
    del kv, x, xd
    bf, sf = P17_FLASH
    xf = torch.randn((bf, sf, d), generator=gen, device=DEVICE).to(
        torch.bfloat16)
    calls = []
    torch.cuda.synchronize()
    with _count_flash(calls):
        t0 = time.perf_counter()
        flash = mla.mla_attention(p, cfg, xf)[0]
        torch.cuda.synchronize()
        t_flash = time.perf_counter() - t0
    if len(calls) != 1:
        fail(f"(a) mla_attention at S={sf} took _flash_causal "
             f"{len(calls)} times, not once")
    floor, L.FLASH_MIN_SEQ = L.FLASH_MIN_SEQ, 1 << 62
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        plain = mla.mla_attention(p, cfg, xf)[0]
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
    finally:
        L.FLASH_MIN_SEQ = floor
    drift = _ulps(flash, plain)
    print(f"[mla] (a) mla_attention at {bf} x {sf}: the flash branch "
          f"(q/k head dim {m.nope_head_dim + m.rope_head_dim}, v "
          f"{m.v_head_dim}, chunk {L.FLASH_CHUNK}) {1e3 * t_flash:.1f} ms "
          f"vs the plain branch {1e3 * t_plain:.1f} ms (peak "
          f"{peak / 1e9:.2f} GB: its f32 scores "
          f"{4 * h * sf * sf / 1e9:.1f} GB); largest |flash - plain| "
          f"{drift:.2f} bf16 ulps of each position's largest output "
          f"(limit {BF16_DRIFT_ULPS}) ({smi})")
    if drift > BF16_DRIFT_ULPS:
        fail(f"(a) the flash branch drifts {drift:.2f} ulps from the plain")
    del p, xf, flash, plain
    torch.cuda.empty_cache()


def _p17_prefill_flop(cfg, params, b: int, s: int) -> float:
    """Operations of ``prefill`` on b x s tokens that the function needs:
    each layer's attention (``_p17_attn_flop``), the router, the k routed
    and the shared experts' gated MLPs on every token, and the LM head on
    the last position."""
    from repro_torch.models import model as M
    mc = cfg.moe
    f = mc.expert_d_ff
    lp = M._unstack(params["layers"]["attn"])[0]
    t = b * s
    return cfg.num_layers * (
        _p17_attn_flop(cfg, lp, b, s) + 2.0 * t * cfg.d_model * mc.num_experts
        + 6.0 * cfg.d_model * f * t * (mc.top_k + mc.num_shared_experts)) \
        + 2.0 * b * cfg.d_model * cfg.vocab_size


def _p17_batch(cfg, nd, params, smi):
    """(b) the batch launcher and (c)'s bf16 teacher forcing (module
    docstring). Returns nothing: MLA launches no kernel."""
    import torch
    from repro_torch.models import model as M
    b, p, new = P17_BATCH
    drops = []
    with _drop_log(drops):
        run, _ = _serve_batch(batch_args(cfg.name, P17_BATCH), params)
    pre = _drops(drops[:cfg.num_layers])
    dec = _drops(drops[cfg.num_layers:])
    if dec[0]:
        fail(f"(b) a decode step dropped {dec[0]} pairs")
    flop = _p17_prefill_flop(cfg, params, b, p)
    floor_ms = 1e3 * flop / PEAK_OPS["bfloat16"]
    steps = new - 1
    experts = sum(_nbytes(params["layers"]["moe"][n])
                  for n in ("w_gate", "w_up", "w_down"))
    used = sum(int(u) for _, _, u in drops[cfg.num_layers:]) / steps
    rest = _nbytes(params) - _nbytes(params["embed"]) - experts
    kv = cfg.kv_bytes_per_token() * b * (p + (steps + 1) / 2)
    need = rest + kv + used * experts / (cfg.num_layers
                                         * cfg.moe.num_experts)
    impl = rest + kv + experts
    step_ms = 1e3 * b / run.decode_tok_s
    print(f"[mla] (b) batch launcher, {P17_ARCH} {cfg.num_layers} layers, "
          f"{b} x {p} + {steps} decode steps, capacity_factor "
          f"{cfg.moe.capacity_factor}: prefill {run.prefill_ms:.2f} ms "
          f"(compute floor {floor_ms:.2f} ms: {flop:.4e} FLOP at 989 "
          f"TFLOP/s, the routed pairs and shared experts only), decode "
          f"{step_ms:.2f} ms a step against two bytes floors: the "
          f"function's {1e3 * need / HBM_BYTES_PER_S:.2f} ms "
          f"({need / 1e9:.2f} GB: {used:.1f} experts a step of the "
          f"{cfg.num_layers * cfg.moe.num_experts}, attention, shared "
          f"experts, router, norms and head, the latent rows read) and "
          f"this implementation's {1e3 * impl / HBM_BYTES_PER_S:.2f} ms "
          f"({impl / 1e9:.2f} GB: every expert, each buffer holding at "
          f"least 8 rows), {run.decode_tok_s:.1f} tokens/s; latent cache "
          f"{_nbytes(run.cache) / 1e6:.1f} MB ({cfg.kv_bytes_per_token()} "
          f"B a token); drops: prefill {pre[0]} of {pre[1]} pairs, decode "
          f"{dec[0]} of {dec[1]}; no kernel launched ({smi})")
    run.cache = None
    calls = []
    bf, sf = P17_FLASH
    with _count_flash(calls):
        long_run, _ = _serve_batch(batch_args(cfg.name, (bf, sf, 4)),
                                   params)
    if len(calls) != cfg.num_layers:
        fail(f"(b) prefill {sf} took _flash_causal {len(calls)} times, "
             f"not {cfg.num_layers}")
    print(f"[mla] (b) batch launcher {bf} x {sf} + 3: prefill "
          f"{long_run.prefill_ms:.2f} ms through the flash branch "
          f"({len(calls)} calls), decode "
          f"{1e3 * bf / long_run.decode_tok_s:.2f} ms a step ({smi})")
    del long_run
    dec_log, fwd_log = {}, {}

    def key(row, b, pos):          # position pos computes token pos - p + 1
        return b, pos
    nd_drops = []
    with _route_log(dec_log, key), _drop_log(nd_drops):
        run8, _ = _serve_batch(batch_args(nd.name, P17_BATCH), params,
                               tokens=run.prompt)
        run8.cache = None
        seq = torch.cat([run8.prompt, run8.tokens[:, :-1]], dim=1)
        with torch.no_grad(), _route_log(fwd_log, key, replay=dec_log):
            fwd = M.forward(params, nd, {"tokens": seq})[0][:, p - 1:]
    if _drops(nd_drops)[0]:
        fail(f"(c) {_drops(nd_drops)[0]} pairs dropped at capacity_factor "
             f"{P17_NO_DROP}")
    flips, noise = _route_flips(fwd_log, dec_log,
                                lambda k: (k[0], k[1] - (p - 1)), {},
                                "(c) the forward's own routing vs the "
                                "decode run's")
    drift = _ulps(torch.stack(run8.logits, dim=1), fwd)
    agree = float((fwd.argmax(-1) == run8.tokens).float().mean())
    del fwd
    print(f"[mla] (c) bf16 at {cfg.num_layers} layers, capacity_factor "
          f"{P17_NO_DROP} (no pair dropped): absorbed decode vs the "
          f"teacher-forced forward over {seq.shape[1]} tokens x "
          f"{seq.shape[0]} rows, on the decode run's routing: largest "
          f"|decode - forward| {drift:.2f} bf16 ulps of the top logit "
          f"(reported: the two forms round the scores at other points; "
          f"held at {P17_F32_LAYERS} layers against the f32 truth below), "
          f"the forward's argmax the emitted token at {100 * agree:.2f}% of "
          f"positions; {flips} routing decisions of the forward's own "
          f"differ, each at a router near-tie (gap between the 6th and 7th "
          f"router logits within twice {noise:.4f}, the largest 6th logit "
          f"difference where they route alike); prefill "
          f"{run8.prefill_ms:.2f} ms ({smi})")
    del run, run8
    torch.cuda.empty_cache()


def _p17_requests(tokenizer):
    """(d) two short prompts (rids 0-1), one long (10), two in-band for
    C&R (20-21), P17_NEW new tokens each."""
    import numpy as np
    from repro_torch.serving.pools import GatewayRequest
    rng = np.random.default_rng(17)
    reqs = [GatewayRequest(i, varied_prompt(rng, n, tokenizer), P17_NEW)
            for i, n in enumerate(P17_SHORT)]
    reqs += [GatewayRequest(10 + i, varied_prompt(rng, n, tokenizer),
                            P17_NEW) for i, n in enumerate(P17_LONG)]
    reqs += [GatewayRequest(20 + i, varied_prompt(rng, n, tokenizer),
                            P17_NEW, category="rag")
             for i, n in enumerate(P17_INBAND)]
    return reqs


def _p17_fleet_run(cfg, params, impl, event=None, pad_from=None):
    """P17's stream through phase 5's dense fleet at contexts 256 / 2048
    (``_p9_serve``) with ``decode_impl=impl``, prompts, decode and
    prefill dispatches timed, every swap-in read back (``_restore_probe``;
    a rebuilt engine's row tail past its old context ``pad_from[engine]``
    zero); ``event``: a reprovision. Fails if a decode kernel
    launched. Returns the run."""
    run = dict(prompts={}, decode=[], prefill=[], swaps=[],
               pad_from={} if pad_from is None else pad_from)
    with contextlib.ExitStack() as wraps:
        wraps.enter_context(_engine_prompts(run["prompts"]))
        wraps.enter_context(_decode_timer(run["decode"]))
        wraps.enter_context(_prefill_timer(run["prefill"]))
        wraps.enter_context(_restore_probe(run["swaps"], run["pad_from"]))
        served = _p9_serve(cfg, params, False, None, event=event,
                           reqs=_p17_requests, new=P17_NEW,
                           decode_impl=impl, long_ctx=P17_LONG_CTX,
                           c_chunk=P17_C_CHUNK)
    run.update(served)
    c = run["counts"]
    if c["gqa_decode"] or c["paged_decode"] \
            or c["textrank"] != len(P17_INBAND):
        fail(f"(d) {impl} run: launches {c}, not 0 / 0 / one TextRank a "
             f"compression ({len(P17_INBAND)})")
    return run


def _p17_fleet(cfg, params, smi):
    """(d) the K=2 fleet behind the C&R gateway (module docstring).
    Returns the TextRank launches."""
    kern = _p17_fleet_run(cfg, params, "kernel")
    plain = _p17_fleet_run(cfg, params, "torch")
    if plain["tokens"] != kern["tokens"]:
        fail("(d) decode_impl 'kernel' and 'torch' emitted other tokens "
             "(MLA attention is the same code in both)")
    ev = _P15Reprovision()
    moved = _p17_fleet_run(cfg, params, "kernel", event=ev,
                           pad_from=ev.pad_from)
    ins = [nb for d, nb, _ in moved["swaps"] if d == "in"]
    if ev.info is None or not ins or ev.info["rerouted"]:
        fail(f"(d) reprovision {ev.info}: {len(ins)} swap-ins")
    if moved["tokens"] != kern["tokens"]:
        fail("(d) the reprovisioned run's tokens differ from the "
             "uninterrupted run's")
    dec_ms, cols, col_ms = _fleet_ms(kern)
    p_dec, _, p_col = _fleet_ms(plain)
    lens = sorted(len(t) for t in kern["prompts"].values())
    print(f"[mla] (d) {P17_ARCH} {cfg.num_layers} layers, phase 5's K=2 "
          f"dense fleet at contexts {P17_LONG_CTX // 8} / {P17_LONG_CTX}, "
          f"c_chunk {P17_C_CHUNK}, n_max 4, decode_k 4: prompts {lens} "
          f"tokens (after C&R) + {P17_NEW} new, every request complete: "
          f"{kern['secs']:.2f} s, {kern['rounds']} drive rounds; decode "
          f"{dec_ms:.2f} ms per dispatch ({len(kern['decode'])}); "
          f"per-token prefill {cols} token columns, {col_ms:.2f} ms a "
          f"column; decode_impl torch {plain['secs']:.2f} s ({p_dec:.2f} "
          f"ms a dispatch, {p_col:.2f} ms a column), the same tokens; "
          f"launches gqa_decode 0, paged_decode 0, textrank "
          f"{kern['counts']['textrank']} a run ({smi})")
    print(f"[mla] (d) the short pool reprovisioned mid-stream to {P15_TO} "
          f"(n_max kept): checkpointed {ev.info['checkpointed']}, migrated "
          f"{ev.info['migrated']}, rerouted {ev.info['rerouted']}; "
          f"{len(ins)} swap-ins ({sum(ins) / 2 ** 20:.2f} MiB of c_kv / "
          f"k_r rows) read back bitwise, the tail past "
          f"{P17_LONG_CTX // 8} zero; the uninterrupted run's tokens "
          f"({moved['secs']:.2f} s) ({smi})")
    return sum(r["counts"]["textrank"] for r in (kern, plain, moved))


def _p17_f32(p16, smi):
    """(c) at full width and P17_F32_LAYERS layers (``p16``: the bf16
    weights of those layers), capacity P17_NO_DROP, no pair dropped:
    the bf16 decode's distance from the f32 truth (a teacher-forced
    ``forward`` of the weights upcast over its history, on its routing)
    within P15_TRUTH_RATIO of the bf16 forward's, unless the two are
    within BF16_DRIFT_ULPS (``_p16_truth_rule``); then the launcher on
    the upcast weights, decode against its own teacher-forced forward
    (on its routing) within P15_FWD_REL of max|logit|."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.training import tree
    _, nd = _p17_configs(P17_F32_LAYERS)
    _, nd32 = _p17_configs(P17_F32_LAYERS, "float32")
    p32 = tree.map(lambda t: t.float(), p16)
    b, p, n = P17_TF32
    drops, logs = [], {k: {} for k in ("dec", "fwd", "truth", "dec32",
                                       "fwd32")}
    flips = []

    def key(row, b, pos):
        return b, pos

    def forward(params, cfg, run, log, replay):
        seq = torch.cat([run.prompt, run.tokens[:, :-1]], dim=1)
        with torch.no_grad(), _route_log(log, key, replay=replay):
            out = M.forward(params, cfg, {"tokens": seq})[0][:, p - 1:]
        flips.append(_route_flips(log, replay,
                                  lambda k: (k[0], k[1] - (p - 1)), {},
                                  "(c) a forward's own routing vs the "
                                  "decode run's")[0])
        return out
    with _drop_log(drops):
        with _route_log(logs["dec"], key):
            run, _ = _serve_batch(batch_args(nd.name, P17_TF32), p16)
        run.cache = None
        dec = torch.stack(run.logits, dim=1)
        fwd = forward(p16, nd, run, logs["fwd"], logs["dec"])
        truth = forward(p32, nd32, run, logs["truth"], logs["dec"])
        drift = _ulps(dec, fwd)
        note = _p16_truth_rule("(c) bf16 decode", drift, _ulps(dec, truth),
                               _ulps(fwd, truth), "bf16 forward")
        del fwd, truth, dec
        with _route_log(logs["dec32"], key):
            run32, _ = _serve_batch(batch_args(nd32.name, P17_TF32), p32,
                                    tokens=run.prompt)
        run32.cache = None
        fwd32 = forward(p32, nd32, run32, logs["fwd32"], logs["dec32"])
    if _drops(drops)[0]:
        fail(f"(c) {_drops(drops)[0]} pairs dropped at capacity_factor "
             f"{P17_NO_DROP}")
    rel = max(float((lg.float() - fwd32[:, j]).abs().max()
                    / fwd32[:, j].abs().max())
              for j, lg in enumerate(run32.logits))
    print(f"[mla] (c) at full width and {P17_F32_LAYERS} of 60 layers "
          f"(bf16 {_nbytes(p16) / 1e9:.2f} GB, the f32 copy "
          f"{_nbytes(p32) / 1e9:.2f} GB), capacity_factor {P17_NO_DROP}, "
          f"{b} x {p} + {n - 1} decode steps, each forward on its decode "
          f"run's routing ({sum(flips)} own decisions differ, each at a "
          f"router near-tie): bf16 decode vs forward {note}; f32 absorbed "
          f"decode vs its teacher-forced forward {rel:.3e} of max|logit| "
          f"(limit {P15_FWD_REL}); f32 prefill {run32.prefill_ms:.2f} ms, "
          f"decode {1e3 * b / run32.decode_tok_s:.2f} ms a step ({smi})")
    if rel >= P15_FWD_REL:
        fail(f"(c) f32 decode logits {rel:.3e} of max|logit| from the "
             f"teacher-forced forward (limit {P15_FWD_REL})")
    del p32, run, run32, fwd32
    torch.cuda.empty_cache()


def _p17_card_vs_cpu():
    """(e) reduced deepseek-v2 f32, the card against the CPU, the CPU
    replaying the card's routing: forward; prefill (logits and the
    latent caches), 8 greedy decode steps (a row's tokens may part only
    where the CPU's top-2 logits are within P17_CPU_GAP; its logits are
    held until they part) and a step with row 2 inactive (its rows
    bitwise); prefill_chunk with an idle row (bitwise); all within
    P17_CPU_TOL of max."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.training import tree
    cfg = dataclasses.replace(get_config(P17_ARCH).reduced(),
                              dtype="float32")
    params = M.init_params(cfg, seed=0, device=DEVICE)
    cpu = _to_cpu(params)
    gen = torch.Generator()
    gen.manual_seed(17)
    toks = torch.randint(1, cfg.vocab_size, (3, 40), generator=gen)
    close = _card_vs_cpu_close(P17_CPU_TOL)
    tie = lambda rec: rec[1][0] - rec[1][1] < P17_CPU_GAP  # noqa: E731
    rflips = 0

    def key(row, b, pos):
        return b, pos

    def routed(fn_card, fn_cpu, what, parted=()):
        """Both calls, the CPU's on the card's routing; the rows in
        ``parted`` (fed other tokens since a near-tie) are not held."""
        nonlocal rflips
        card_r, cpu_r = {}, {}
        with _route_log(card_r, key):
            got = fn_card()
        with _route_log(cpu_r, key, replay=card_r):
            want = fn_cpu()
        rflips += _route_flips(cpu_r, card_r, lambda k: (k[0], 0),
                               {r: -1 for r in parted},
                               f"(e) {what}: the CPU's own routing vs the "
                               f"card's", tie=tie)[0]
        return got, want
    _reset_launches()
    with torch.no_grad():
        kf, cf = routed(lambda: M.forward(params, cfg,
                                          {"tokens": toks.to(DEVICE)})[0],
                        lambda: M.forward(cpu, cfg, {"tokens": toks})[0],
                        "forward")
        close(kf, cf, "forward logits")
        batch = {"tokens": toks[:, :32], "cache_len": 48}
        (kl, kc), (cl, cc) = routed(
            lambda: M.prefill(params, cfg, dict(
                batch, tokens=batch["tokens"].to(DEVICE))),
            lambda: M.prefill(cpu, cfg, batch), "prefill")
        close(kl, cl, "prefill logits")
        for n in kc["kv"]:
            close(kc["kv"][n], cc["kv"][n], f"prefill cache {n}")
        k0 = tree.map(lambda t: t.clone(), kc)
        c0 = tree.map(lambda t: t.clone(), cc)
        kt, ct = kl.argmax(-1)[:, None], cl.argmax(-1)[:, None]
        same, flips = [True] * 3, 0
        for j in range(8):
            (kl, kc), (cl, cc) = routed(
                lambda: M.decode_step(params, cfg, kt, kc, 32 + j),
                lambda: M.decode_step(cpu, cfg, ct, cc, 32 + j),
                f"decode step {j}", [r for r in range(3) if not same[r]])
            for r in range(3):
                if same[r]:
                    close(kl[r], cl[r], f"decode step {j} row {r}")
            kt, ct = kl.argmax(-1)[:, None], cl.argmax(-1)[:, None]
            for r in range(3):
                if same[r] and int(kt[r]) != int(ct[r]):
                    top = torch.topk(cl[r], 2).values.tolist()
                    if top[0] - top[1] >= P17_CPU_GAP:
                        fail(f"(e) row {r} step {j}: tokens differ away "
                             f"from a CPU near-tie ({top})")
                    same[r], flips = False, flips + 1
        row2 = _rows(kc, 2)
        M.decode_step(params, cfg, kt, kc, 40,
                      active=torch.tensor([True, True, False],
                                          device=DEVICE))
        if not all(torch.equal(a, b) for a, b in zip(_rows(kc, 2), row2)):
            fail("(e) an inactive decode row's latent cache changed")
        start, lengths = torch.tensor([32, 32, 32]), torch.tensor([8, 5, 0])
        idle = _rows(k0, 2)
        (kl, k0), (cl, c0) = routed(
            lambda: M.prefill_chunk(params, cfg, toks[:, 32:].to(DEVICE), k0,
                                    start.to(DEVICE), lengths.to(DEVICE)),
            lambda: M.prefill_chunk(cpu, cfg, toks[:, 32:], c0, start,
                                    lengths), "prefill_chunk")
        close(kl[:2], cl[:2], "prefill_chunk logits")
        for n in k0["kv"]:
            close(k0["kv"][n], c0["kv"][n], f"prefill_chunk cache {n}")
        if not all(torch.equal(a, b) for a, b in zip(_rows(k0, 2), idle)):
            fail("(e) an idle prefill_chunk row's latent cache changed")
    counts = _launch_counts()
    if any(counts.values()):
        fail(f"(e) MLA launched a kernel: {counts}")
    print(f"[mla] (e) reduced {cfg.name} f32 ({cfg.num_layers} layers, "
          f"latent {cfg.mla.kv_lora_rank}, {cfg.moe.num_experts} experts "
          f"top-{cfg.moe.top_k}), card vs CPU, the CPU on the card's "
          f"routing (forward, prefill, 8 greedy decode steps, a masked step,"
          f" prefill_chunk with an idle row; logits and both latent leaves):"
          f" within {close.worst:.3g} of max (limit {P17_CPU_TOL}), {flips} "
          f"near-tie token flips, {rflips} routing decisions of the CPU's "
          f"own differ (each where the k-th and (k+1)-th router "
          f"probabilities are within {P17_CPU_GAP}); inactive and idle rows "
          f"bitwise; no kernel "
          f"launched")
    del params, cpu, k0, kc
    torch.cuda.empty_cache()


def phase_mla(smi):
    """Phase 17: MLA and deepseek-v2-236b at its published widths (module
    docstring). Returns the launches."""
    import gc
    import torch
    from repro_torch.models import model as M
    from repro_torch.training import tree
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    _p17_block(smi)
    parts = [time.perf_counter()]
    cfg, nd = _p17_configs()
    params = M.init_params(cfg, seed=0, device=DEVICE)
    print(f"[mla] {P17_ARCH} at {cfg.num_layers} of 60 layers: "
          f"{_nbytes(params) / 1e9:.2f} GB of weights, init "
          f"{time.perf_counter() - parts[0]:.1f} s")
    _p17_batch(cfg, nd, params, smi)
    parts.append(time.perf_counter())
    fleet = (cfg, params) if P17_FLEET_LAYERS == cfg.num_layers else \
        _depth_cut(cfg, params, P17_FLEET_LAYERS, P17_ARCH)
    textrank = _p17_fleet(*fleet, smi)
    parts.append(time.perf_counter())
    p16 = dict(params, layers=tree.map(lambda a: a[:P17_F32_LAYERS].clone(),
                                       params["layers"]))
    del params, fleet
    gc.collect()
    torch.cuda.empty_cache()
    _p17_f32(p16, smi)
    del p16
    parts.append(time.perf_counter())
    _p17_card_vs_cpu()
    parts.append(time.perf_counter())
    peak = torch.cuda.max_memory_allocated()
    out = {"gqa_decode": 0, "paged_decode": 0, "textrank": textrank}
    print(f"[mla] phase 17: {parts[-1] - t0:.1f} s ((a) "
          f"{parts[0] - t0:.1f}, init, (b) and (c) in bf16 "
          f"{parts[1] - parts[0]:.1f}, (d) {parts[2] - parts[1]:.1f}, (c) "
          f"in f32 {parts[3] - parts[2]:.1f}, (e) {parts[4] - parts[3]:.1f});"
          f" device memory held from earlier phases at its start "
          f"{mem0 / 1e9:.2f} GB; peak {peak / 1e9:.2f} GB; launches {out} "
          f"({smi})")
    if peak >= PEAK_LIMIT:
        fail(f"phase 17 peak device memory {peak / 1e9:.2f} GB")
    return out


# ---------------------------------------------------------------- phase 18
P18_TP = 4                    # ranks of the group, all on the one card
P18_TIMEOUT_S = 900           # the group's collective timeout
P18_TF = (2, 16, 8)           # (f): batch, tokens of the forward, engine
                              # requests' new tokens (reduced, f32)
P18_NEW = 32                  # (b): new tokens a request (phase 5's 64
                              # halved for the smoke's time)
P18_FLEET_LAYERS = 16         # (b): the fleet's first 16 of 32 layers (to
                              # make room for phase 20's fleet at full depth)


def _p18_model():
    """minitron-8b (bf16, its published widths and depth)."""
    from repro_torch.configs.base import get_config
    return get_config("minitron-8b")


def _p18_reduced():
    """Reduced f32 minitron-8b with 8 query heads over 4 kv heads of 64
    (a head_dim the decode kernels serve): each of the 4 ranks holds one
    kv head and its GQA group of two."""
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config("minitron-8b").reduced(),
                               dtype="float32", num_heads=8, num_kv_heads=4,
                               head_dim=64)


def _p18_shard_bytes(cfg, tp: int):
    """(one rank's parameter bytes, the sharded leaves' bytes, the
    replicated leaves' bytes) by ``sharding.param_specs`` on the meta
    shapes: the sharded leaves / tp plus the replicated ones."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.context import ParallelContext
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import model as M
    shapes = M.init_params(cfg, device="meta")
    leaves = []
    SH._map2(lambda spec, t: leaves.append((any(e is not None for e in spec),
                                            t.numel() * t.element_size())),
             SH.param_specs(shapes, ParallelContext(
                 mesh=make_smoke_mesh(tp, world=tp))), shapes)
    sharded = sum(n for s, n in leaves if s)
    repl = sum(n for s, n in leaves if not s)
    return sharded // tp + repl, sharded, repl


@contextlib.contextmanager
def _step_calls(calls):
    """Count the model's decode-step calls (the engine's and mixed_step's):
    each launches the decode kernel once a layer."""
    from repro_torch.models import model as M
    fns = {n: getattr(M, n) for n in ("decode_step", "paged_decode_step")}

    def counted(name, fn):
        @functools.wraps(fn)           # its signature, for _logit_log
        def call(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return call
    for n, fn in fns.items():
        setattr(M, n, counted(n, fn))
    try:
        yield
    finally:
        for n, fn in fns.items():
            setattr(M, n, fn)


@contextlib.contextmanager
def _collective_timer(acc):
    """Host seconds and calls of the ranks' collectives (all-reduce and
    all-gather, the host staging included)."""
    from repro_torch.distributed.context import ParallelContext as PCtx
    fns = {n: getattr(PCtx, n) for n in ("all_reduce_sum", "all_gather")}

    def timed(fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            acc["s"] = acc.get("s", 0.0) + time.perf_counter() - t0
            acc["n"] = acc.get("n", 0) + 1
            return out
        return call
    for n, fn in fns.items():
        setattr(PCtx, n, timed(fn))
    try:
        yield
    finally:
        for n, fn in fns.items():
            setattr(PCtx, n, fn)


def _p18_fleet(params, paged, tp, device, log=None, held=None, arch=None):
    """(b) ``serve.py --fleet 2 --tp tp``'s fleet (phase 5's plan and
    requests, decode_k 4) of ``arch`` (a registered config's name) over
    ``params`` (a rank's shard at tp > 1), the
    logits behind every token logged into ``log`` and each decode
    kernel's first launch at a shape held in ``held`` (when given); then
    one profiled decode dispatch of the long pool (one live row of 1024
    prompt tokens), the collectives' host time read inside it."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.serving.engine import ServeRequest
    decode_log, calls = [], {}
    _reset_launches()
    with contextlib.ExitStack() as stack:
        stack.enter_context(_decode_timer(decode_log))
        stack.enter_context(_step_calls(calls))
        if log is not None:
            stack.enter_context(_logit_log(log))
        if held is not None:
            stack.enter_context(_live_kernel_hold(held))
        rt, results, secs = serve.serve_fleet(
            fleet_args(arch=arch, paged=paged, tp=tp, new_tokens=P18_NEW),
            slots_per_pool=4, c_chunk=256, long_ctx=4096, params=params,
            device=device)
    counts = _launch_counts()
    for rid, res in results.items():
        if res.timed_out or not res.output_tokens:
            fail(f"(b) tp={tp} paged={paged}: request {rid} did not "
                 "complete")
    kv = sum(e.cache_bytes_per_device() for e in rt.engines.values())
    eng = rt.engines[rt.router.names[-1]]
    eng.submit(ServeRequest(rid=10_000, tokens=[
        1 + i % (rt.cfg.vocab_size - 1) for i in range(1024)],
        max_new_tokens=64))
    while eng.slot_prefill_left[0] or eng.slot_req[0] is None:
        eng.step()
    coll = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _collective_timer(coll):
        eng.step()
        torch.cuda.synchronize()
    one = time.perf_counter() - t0
    del eng, rt
    torch.cuda.empty_cache()
    dec_s = sum(t for t, _ in decode_log)
    return dict(tokens={rid: r.output_tokens for rid, r in results.items()},
                secs=secs, counts=counts, calls=calls, kv=kv,
                decode_ms=1e3 * dec_s / max(1, len(decode_log)),
                dispatches=len(decode_log),
                profiled_ms=1e3 * one, coll_ms=1e3 * coll.get("s", 0.0),
                coll_n=coll.get("n", 0))


class _P18Reprovision:
    """(d) The long pool to c_max 6144 after P9_EVENT_ROUND rounds."""

    def __init__(self):
        self.info = None

    def pending(self):
        return False

    def on_round(self, rt, rounds, rebuilt):
        if rounds == P9_EVENT_ROUND and self.info is None:
            long_ = rt.router.names[-1]
            self.info = rt.reprovision(long_, **P9_LONG_TO)
            rebuilt.add(rt.engines[long_])


def _p18_cpu_tree(tree):
    import torch
    if isinstance(tree, dict):
        return {k: _p18_cpu_tree(v) for k, v in tree.items()}
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def _p18_reduced_runs(params, cfg, device, parallel):
    """(f) reduced f32: the forward's logits over P18_TF's tokens and the
    engine's tokens on phase 4's stream (dense, decode_k 4, the kernel),
    on ``device``."""
    import torch
    from repro_torch.models import model as M
    b, t, new = P18_TF
    gen = torch.Generator().manual_seed(18)
    toks = torch.randint(1, cfg.vocab_size, (b, t), generator=gen)
    mesh = {} if parallel is None else {"mesh": parallel.mesh}
    lg, _ = M.forward(params, cfg, {"tokens": toks.to(device)},
                      parallel=parallel)
    out, _ = _serve(cfg, params, [_stream(max_new=new)], decode_k=4,
                    **mesh)
    return lg.cpu(), out


def _p18_rank(rank, device):
    """One rank of phase 18: (a)-(f) on this rank's shard (module
    docstring). Rank 0 returns the logs and rows the parent compares."""
    import torch
    from repro_torch.distributed import context as PC
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_smoke_mesh, parse_mesh
    from repro_torch.models import model as M
    from repro_torch.training import tree
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = PC.make_context(make_smoke_mesh(P18_TP))
    cfg = _p18_model()
    out, parts = {"rank": rank}, {}
    launches = {}

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device=device, parallel=ctx)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["param_bytes"] = _nbytes(params)
    out["b"], out["held"] = {}, {}
    cut, cut_params = _depth_cut(cfg, params, P18_FLEET_LAYERS)
    for paged in (False, True):
        log = {} if rank == 0 else None
        r = _p18_fleet(cut_params, paged, P18_TP, device, log=log,
                       held=out["held"], arch=cut.name)
        add(r["counts"])
        if log is not None:       # the logits' own dtype: exact, half the bytes
            r["log"] = {rid: {j: v.to(params["embed"].dtype).cpu()
                              for j, v in row.items()}
                        for rid, row in log.items()}
        out["b"][paged] = r
        del log
    del cut_params
    parts["(b)"] = time.perf_counter()
    # (d) the C&R fleet, uninterrupted and reprovisioned mid-stream
    runs = {}
    for name, event in (("plain", None), ("moved", _P18Reprovision())):
        log = {} if rank == 0 else None
        runs[name] = _p9_serve(cfg, params, False, log, event=event,
                               mesh=ctx.mesh, tp_degree=P18_TP)
        runs[name]["log"] = log
        add(runs[name]["counts"])
        if event is not None:
            if event.info is None or not event.info["migrated"]:
                fail(f"(d) rank {rank}: the reprovision moved nothing: "
                     f"{event.info}")
            runs[name]["info"] = event.info
    if rank == 0:
        runs["flips"] = _bf16_flips(
            runs["plain"]["log"], runs["moved"]["log"],
            runs["plain"]["tokens"], runs["moved"]["tokens"],
            "(d) tp=4 reprovisioned vs uninterrupted", tag="tp")
    for name in ("plain", "moved"):
        runs[name].pop("log")
    out["d"] = runs
    parts["(d)"] = time.perf_counter()
    # (e) the batch launcher at --mesh 1x4, then 2x2 (its own 2-way shard)
    out["e"] = {}
    for m in ("1x4", "2x2"):
        bctx = PC.make_context(parse_mesh(m))
        args = batch_args(cfg.name, BATCH_SHAPE)
        args.mesh = m
        _reset_launches()
        run = serve.serve_batch(args, params=params if m == "1x4" else None,
                                parallel=bctx, device=device)
        counts = _launch_counts(("gqa_decode",), f"(e) --mesh {m}")
        add(counts)
        if counts["gqa_decode"] != cfg.num_layers * (BATCH_SHAPE[2] - 1):
            fail(f"(e) --mesh {m} rank {rank}: launches {counts}")
        keep = bctx.model_rank == 0
        out["e"][m] = dict(counts=counts, data_rank=run.data_rank,
                           prefill_ms=run.prefill_ms,
                           decode_tok_s=run.decode_tok_s,
                           run=dataclasses.replace(
                               run, cache={}).to_cpu() if keep else None)
        del run
        if m == "1x4":
            del params
        torch.cuda.empty_cache()
    parts["(e)"] = time.perf_counter()
    # (f) reduced f32 at tp=4: the card against the CPU
    rcfg = _p18_reduced()
    cpu = M.init_params(rcfg, seed=0, device="cpu", parallel=ctx)
    out["f"] = {"cuda": _p18_reduced_runs(
        tree.map(lambda a: a.to(device), cpu), rcfg, device, ctx),
        "cpu": _p18_reduced_runs(cpu, rcfg, "cpu", ctx)}
    parts["(f)"] = time.perf_counter()
    out["launches"] = launches
    out["peak"] = torch.cuda.max_memory_allocated()
    out["parts"] = {k: v - t0 for k, v in parts.items()}
    return out


def _p18_tp1(cfg, smi):
    """The tp=1 references in this process: (b)'s fleets with their logs,
    (e)'s batch run, (f)'s CPU run; the weights freed after."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    params = M.init_params(cfg, seed=0, device=DEVICE)
    ref = {"b": {}}
    cut, cut_params = _depth_cut(cfg, params, P18_FLEET_LAYERS)
    for paged in (False, True):
        log = {}
        r = _p18_fleet(cut_params, paged, 1, torch.device(DEVICE), log=log,
                       arch=cut.name)
        r["log"] = {rid: {j: v.cpu() for j, v in row.items()}
                    for rid, row in log.items()}
        ref["b"][paged] = r
        del log
    del cut_params
    run = serve.serve_batch(batch_args(cfg.name, BATCH_SHAPE), params=params)
    ref["e"] = dataclasses.replace(run, cache={}).to_cpu()
    del run, params
    torch.cuda.empty_cache()
    rcfg = _p18_reduced()
    ref["f"] = _p18_reduced_runs(M.init_params(rcfg, seed=0, device="cpu"),
                                 rcfg, "cpu", None)
    return ref


def _p18_batch_rows(res, m):
    """The (e) run of ``--mesh m`` with every row, from the ranks whose
    model index is 0 (each holds its data slice)."""
    from repro_torch.launch import serve
    return serve._gather_rows([r["e"][m]["run"] for r in res
                               if r["e"][m]["run"] is not None])


def phase_tp(smi):
    """Phase 18: tensor-parallel serving over one rank group (module
    docstring). Returns the launches of every rank, summed."""
    import torch
    from repro_torch.distributed import context as PC
    t0 = time.perf_counter()
    cfg = _p18_model()
    want_bytes, sharded, repl = _p18_shard_bytes(cfg, P18_TP)
    ref = _p18_tp1(cfg, smi)
    t_ref = time.perf_counter()
    held_at_start = torch.cuda.memory_allocated()
    res = PC.launch_ranks(_p18_rank, P18_TP, device=DEVICE,
                          timeout_s=P18_TIMEOUT_S)
    t_ranks = time.perf_counter()
    r0, r3 = res[0], res[-1]
    gb = 1e9
    # (a) bytes
    for r in res:
        if r["param_bytes"] != want_bytes:
            fail(f"(a) rank {r['rank']}: {r['param_bytes']} B of weights, "
                 f"want {want_bytes} (sharded {sharded} / {P18_TP} + "
                 f"replicated {repl})")
        for paged in (False, True):
            if P18_TP * r["b"][paged]["kv"] != ref["b"][paged]["kv"]:
                fail(f"(a) rank {r['rank']} paged={paged}: {P18_TP} x "
                     f"{r['b'][paged]['kv']} KV bytes != tp=1's "
                     f"{ref['b'][paged]['kv']}")
    print(f"[tp] (a) {cfg.name} {cfg.dtype} at tp={P18_TP}, {P18_TP} ranks on one "
          f"card (a gloo group, tensors through shared card buffers): "
          f"each rank's weights {want_bytes / gb:.4f} GB "
          f"(the sharded {sharded / gb:.4f} GB / {P18_TP} + the replicated "
          f"norms {repl} B; tp=1 {(sharded + repl) / gb:.4f} GB), exact on "
          f"every rank; KV bytes a rank x {P18_TP} = tp=1's exactly (dense "
          f"{ref['b'][False]['kv']} B, paged {ref['b'][True]['kv']} B); "
          f"peak device memory per rank "
          f"{[round(r['peak'] / 2**30, 2) for r in res]} GiB; init "
          f"{[round(r['init_s'], 2) for r in res]} s ({smi})")
    # (b) the fleet, tp=4 vs tp=1
    for paged in (False, True):
        got, want = r0["b"][paged], ref["b"][paged]
        got["log"] = {rid: {j: v.float() for j, v in row.items()}
                      for rid, row in got["log"].items()}
        if got["tokens"] != r3["b"][paged]["tokens"]:
            fail(f"(b) paged={paged}: rank 0's and rank {P18_TP - 1}'s "
                 "tokens differ")
        flips = _bf16_flips(want["log"], got["log"], want["tokens"],
                            got["tokens"], f"(b) paged={paged} tp={P18_TP} "
                            "vs tp=1", tag="tp")
        print(f"[tp] (b) fleet paged={paged}, decode_k 4: tp={P18_TP} "
              f"{got['secs']:.2f} s, decode {got['decode_ms']:.2f} ms a "
              f"dispatch ({got['dispatches']}), one profiled dispatch "
              f"{got['profiled_ms']:.2f} ms of which the collectives "
              f"{got['coll_ms']:.2f} ms ({got['coll_n']} calls, "
              f"{100 * got['coll_ms'] / got['profiled_ms']:.1f}%); tp=1 "
              f"{want['secs']:.2f} s, {want['decode_ms']:.2f} ms a dispatch, "
              f"profiled {want['profiled_ms']:.2f} ms; {flips} near-tie "
              f"divergences; rank 0's tokens = rank {P18_TP - 1}'s ({smi}; "
              f"{P18_TP} ranks time-sliced on one card: correctness, not "
              f"tp={P18_TP} on {P18_TP} cards)")
    # (c) the decode kernels on every rank
    for r in res:
        for paged, kname, step in ((False, "gqa_decode", "decode_step"),
                                   (True, "paged_decode",
                                    "paged_decode_step")):
            b = r["b"][paged]
            n, steps = b["counts"][kname], b["calls"].get(step, 0)
            if n == 0 or n != P18_FLEET_LAYERS * steps:
                fail(f"(c) rank {r['rank']} paged={paged}: {kname} "
                     f"launched {n} times over {steps} decode steps, want "
                     f"{P18_FLEET_LAYERS} a step")
        kinds = {k[0] for k in r["held"]}
        if kinds != {"gqa_decode", "paged_decode"}:
            fail(f"(c) rank {r['rank']}: held {sorted(kinds)}")
    worst = max(e / m for r in res for e, m in r["held"].values())
    print(f"[tp] (c) each rank launched each decode kernel {P18_FLEET_LAYERS} "
          f"times a decode step (the fleet's first {P18_FLEET_LAYERS} of "
          f"{cfg.num_layers} layers) on its {cfg.num_kv_heads // P18_TP} kv heads "
          f"(dense {[r['b'][False]['counts']['gqa_decode'] for r in res]}, "
          f"paged {[r['b'][True]['counts']['paged_decode'] for r in res]}); "
          f"held on live inputs at {sorted({k[:2] for k in r0['held']})} on "
          f"every rank, worst error {worst:.3e} of max|plain| (TOL and one "
          f"bf16 ulp)")
    # (d) the C&R fleet and its reprovision
    d0, d3 = r0["d"], r3["d"]
    for name in ("plain", "moved"):
        if d0[name]["tokens"] != d3[name]["tokens"]:
            fail(f"(d) {name}: rank 0's and rank {P18_TP - 1}'s tokens "
                 "differ")
    tr = [r["d"]["plain"]["counts"]["textrank"] for r in res]
    if tr[0] != 1 or any(tr[1:]):
        fail(f"(d) TextRank launches by rank {tr}: want one (the in-band "
             "request's attempt) on rank 0 alone")
    print(f"[tp] (d) the K=2 fleet at tp={P18_TP} (phase 9's stream: 5 "
          f"short, 2 long, 1 in-band compressed into the short pool; "
          f"TextRank launches by rank {tr}): every request completes; the "
          f"long pool reprovisioned to {P9_LONG_TO} at round "
          f"{P9_EVENT_ROUND} ({d0['moved']['info']['migrated']} migrated), "
          f"{d0['flips']} near-tie divergences from the uninterrupted run; "
          f"{d0['plain']['secs']:.2f} s / {d0['moved']['secs']:.2f} s")
    # (e) the batch launcher over two meshes
    want = ref["e"]
    want_toks, want_log = _run_log(want)
    for m in ("1x4", "2x2"):
        got = _p18_batch_rows(res, m)
        toks, log = _run_log(got)
        flips = _bf16_flips(want_log, log, want_toks, toks,
                            f"(e) --mesh {m} vs 1x1", tag="tp")
        e0 = r0["e"][m]
        print(f"[tp] (e) batch launcher --mesh {m}, {BATCH_SHAPE[0]} x "
              f"{BATCH_SHAPE[1]} + {BATCH_SHAPE[2]}: prefill "
              f"{e0['prefill_ms']:.2f} ms, decode "
              f"{1e3 * BATCH_SHAPE[0] / e0['decode_tok_s']:.2f} ms a step "
              f"(rank 0); 1x1 {want.prefill_ms:.2f} ms, "
              f"{1e3 * BATCH_SHAPE[0] / want.decode_tok_s:.2f} ms a step; "
              f"{flips} near-tie divergences; gqa_decode "
              f"{cfg.num_layers} x {BATCH_SHAPE[2] - 1} on every rank ({smi})")
        del got, log
    # (f) reduced f32: card tp=4, CPU tp=4, CPU tp=1
    lg1, tok1 = ref["f"]
    top = float(lg1.abs().max())
    for r in res:
        for where in ("cuda", "cpu"):
            lg, toks = r["f"][where]
            err = float((lg - lg1).abs().max())
            if toks != tok1 or err > 1e-5 * top:
                fail(f"(f) rank {r['rank']} {where} tp={P18_TP}: tokens "
                     f"{'equal' if toks == tok1 else 'differ'}, logits "
                     f"{err / top:.3e} of max from CPU tp=1 (limit 1e-05)")
    errs = [float((r["f"][w][0] - lg1).abs().max()) / top for r in res
            for w in ("cuda", "cpu")]
    print(f"[tp] (f) reduced f32 (8 / 4 heads): the card at tp={P18_TP} and "
          f"the CPU at tp={P18_TP} against the CPU at tp=1: tokens equal, "
          f"logits within {max(errs):.3e} of max (limit 1e-05)")
    launches = {}
    for r in res:
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    p = r0["parts"]
    print(f"[tp] phase 18: {time.perf_counter() - t0:.1f} s (tp=1 references "
          f"{t_ref - t0:.1f}, ranks {t_ranks - t_ref:.1f}: init "
          f"{r0['init_s']:.1f}, (b) {p['(b)']:.1f}, (d) {p['(d)'] - p['(b)']:.1f}, "
          f"(e) {p['(e)'] - p['(d)']:.1f}, (f) {p['(f)'] - p['(e)']:.1f}); "
          f"device memory held at the spawn {held_at_start / 2**30:.2f} GiB; "
          f"launches of the {P18_TP} ranks {launches} ({smi})")
    return launches


# ---------------------------------------------------------------- phase 19
P19_TP = 4                    # ranks of the group, all on the one card
P19_TIMEOUT_S = 900           # the group's collective timeout
P19_LAYERS = 6                # of 48: 30.56 GB of bf16 weights, 8.77 GB a rank
P19_NO_DROP = 8.0             # capacity_factor at which neither degree drops
P19_BLOCK = ((4, 1024, "a2a"), (4, 1, "psum"))   # (a): batch, tokens, mode
P19_TIE = 1e-6                # (a): a token whose router top-k boundary gap
                              # (probabilities) is below this is not compared
P19_DEEPSEEK = "deepseek-v2-236b"
P19_BATCH = (4, 256, 9)       # (b): batch, prompt, new tokens


def _p19_configs():
    """llama4-scout at its published widths with the depth cut to
    P19_LAYERS, and its copy at capacity_factor P19_NO_DROP, registered
    so the batch launcher's ``--arch`` finds them (in every rank too)."""
    from repro_torch.configs import base
    cfg = dataclasses.replace(base.get_config(P13_ARCH),
                              num_layers=P19_LAYERS,
                              name=f"{P13_ARCH}-{P19_LAYERS}-layers")
    nd = dataclasses.replace(cfg, name=f"{cfg.name}-no-drop",
                             moe=dataclasses.replace(
                                 cfg.moe, capacity_factor=P19_NO_DROP))
    return base.register(cfg), base.register(nd)


def _p19_deepseek(cf):
    """deepseek-v2-236b's published config at capacity_factor ``cf`` (its
    MoE block alone is run: 160 experts of 1536, top-6, 2 shared)."""
    from repro_torch.configs.base import get_config
    cfg = get_config(P19_DEEPSEEK)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def _p19_reduced():
    """Reduced f32 llama4-scout (4 / 4 heads of 64, 4 experts, window 64)
    at capacity_factor P19_NO_DROP: each of the 4 ranks one kv head and
    one expert."""
    from repro_torch.configs.base import get_config
    cfg = dataclasses.replace(get_config(P13_ARCH).reduced(),
                              dtype="float32")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=P19_NO_DROP))


def _p19_ds_layer(cfg, ctx=None):
    """One deepseek MoE layer from a seed (``init_moe``), whole or this
    rank's block of experts (drawing every expert, keeping its own)."""
    import torch
    from repro_torch.models import layers, moe
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(19)

    def part(name, shape):
        if ctx is None or name not in ("w_gate", "w_up", "w_down"):
            return None
        return (1, ctx.model_rank, ctx.tp)
    p = moe.init_moe(gen, cfg, 1, layers.torch_dtype(cfg.dtype), DEVICE,
                     part)
    return {k: ({n: w[0] for n, w in v.items()} if isinstance(v, dict)
                else v[0]) for k, v in p.items()}


def _p19_ms(fn, iters: int = 4) -> float:
    """Host milliseconds a call of ``fn`` over ``iters`` calls after one,
    the device synchronised around them (a rank's call waits on its
    peers at each exchange, so CUDA events around queued calls would time
    the host's handshakes too)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def _p19_split(lp):
    """(the expert leaves' bytes, the router's and shared experts')."""
    experts = sum(_nbytes(lp[n]) for n in ("w_gate", "w_up", "w_down"))
    return experts, _nbytes(lp) - experts


def _p19_x(cfg, b, s):
    """(a)'s input, the same in every process: N(0, 1) from a seed, in
    the model dtype."""
    import torch
    from repro_torch.models import layers
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(190 + s)
    return torch.randn((b, s, cfg.d_model), generator=gen,
                       device=DEVICE).to(layers.torch_dtype(cfg.dtype))


def _p19_gap(router, cfg, x):
    """Each token's router probability gap at its top-k boundary (the
    k-th largest less the (k+1)-th): a routing decision two valid
    roundings may take either way when it is tiny."""
    import torch
    from repro_torch.models import moe
    probs = moe.route(router, cfg, x.reshape(-1, cfg.d_model))[0]
    top = torch.topk(probs, cfg.moe.top_k + 1).values
    return top[:, -2] - top[:, -1]


def _p19_block_ref(lp, cfg, nd):
    """(a) at tp=1 on one layer's MoE leaves ``lp``: each P19_BLOCK
    input's no-drop output (``nd``) and router gaps on the CPU, the drops
    and the ms a call at ``cfg``'s capacity."""
    from repro_torch.models import moe
    out = {}
    for b, s, _ in P19_BLOCK:
        x = _p19_x(cfg, b, s)
        y, aux = moe.moe_block(lp, nd, x)
        if aux["dropped"].any():
            fail(f"(a) tp=1 {cfg.name} T={b * s}: drops at capacity_factor "
                 f"{P19_NO_DROP}")
        _, aux = moe.moe_block(lp, cfg, x)
        out[(b, s)] = dict(y=y.cpu(), gap=_p19_gap(lp["router"], cfg,
                                                   x).cpu(),
                           drops=int(aux["dropped"].sum()),
                           ms=_p19_ms(lambda: moe.moe_block(lp, cfg, x)))
    return out


def _p19_block_rank(lp, cfg, nd, ctx, keep):
    """(a) on this rank: moe_block_sharded of each P19_BLOCK input in its
    mode on the rank's experts ``lp``; the no-drop output (rank 0 keeps
    it), the pairs dropped at ``cfg``'s capacity among those routed to
    the rank's experts, the ms a call and the call's floors on this
    rank."""
    import torch
    from repro_torch.models import moe
    mc = cfg.moe
    e_loc = mc.num_experts // ctx.tp
    out = {}
    for b, s, mode in P19_BLOCK:
        x = _p19_x(cfg, b, s)
        y, aux = moe.moe_block_sharded(lp, nd, x, ctx, mode)
        if aux["dropped"].any():
            fail(f"(a) rank {ctx.rank} {cfg.name} T={b * s} {mode}: drops "
                 f"at capacity_factor {P19_NO_DROP}")
        _, aux = moe.moe_block_sharded(lp, cfg, x, ctx, mode)
        eidx = moe.route(lp["router"], cfg, x.reshape(-1, cfg.d_model))[2]
        mine = eidx.reshape(-1) // e_loc == ctx.model_rank
        ms = _p19_ms(lambda: moe.moe_block_sharded(lp, cfg, x, ctx, mode))
        t = b * s
        local = t // ctx.tp if mode == "a2a" and s % ctx.tp == 0 else t
        if mode == "a2a" and s % ctx.tp == 0:
            rows = e_loc * moe.capacities(cfg, local, ctx.tp)[1]
        else:
            rows = e_loc * moe.psum_capacity(cfg, t, ctx.tp)
        f = mc.expert_d_ff or cfg.d_ff
        flops = (2 * local * cfg.d_model * mc.num_experts
                 + 6 * cfg.d_model * f * (rows + local
                                          * mc.num_shared_experts))
        nbytes = _nbytes(lp) + 2 * x.numel() * x.element_size()
        out[(b, s)] = dict(
            y=y.cpu() if keep else None, mode=mode, ms=ms,
            drops=int((aux["dropped"] & mine).sum()),
            routed=int(mine.sum()), bytes_ms=1e3 * nbytes / HBM_BYTES_PER_S,
            ops_ms=1e3 * flops / PEAK_OPS["bfloat16"])
    torch.cuda.empty_cache()
    return out


def _p19_rank(rank, device, replay):
    """One rank of phase 19: (a)-(d) on this rank's shard (module
    docstring). Rank 0 returns the outputs the parent compares."""
    import torch
    from repro_torch.distributed import context as PC
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_smoke_mesh, parse_mesh
    from repro_torch.models import model as M
    from repro_torch.training import tree
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = PC.make_context(make_smoke_mesh(P19_TP))
    cfg, nd = _p19_configs()
    out, parts, launches = {"rank": rank}, {}, {}

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    t0 = time.perf_counter()
    # (a) deepseek-v2's block first, alone on the card
    lp = _p19_ds_layer(_p19_deepseek(P19_NO_DROP), ctx)
    out["ds_bytes"] = _nbytes(lp)
    out["ds"] = _p19_block_rank(lp, _p19_deepseek(1.25),
                                _p19_deepseek(P19_NO_DROP), ctx, rank == 0)
    del lp
    torch.cuda.empty_cache()
    parts["(a) deepseek"] = time.perf_counter()
    params = M.init_params(cfg, seed=0, device=device, parallel=ctx)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - parts["(a) deepseek"]
    out["param_bytes"] = _nbytes(params)
    out["a"] = _p19_block_rank(M._unstack(params["layers"]["moe"])[0], cfg,
                               nd, ctx, rank == 0)
    parts["(a)"] = time.perf_counter()
    # (c) the C&R fleet: dense with the long pool reprovisioned
    # mid-stream, then paged (the paged chunk, a2a; paged decode, psum)
    out["c"] = {}
    for paged in (False, True):
        calls, held = {}, {}
        event = None if paged else _P18Reprovision()
        with _step_calls(calls), _live_kernel_hold(held):
            run = _p9_serve(dataclasses.replace(cfg, attention_window=0),
                            params, paged, None, event=event,
                            reqs=_p13_requests, new=P13_NEW,
                            long_ctx=P13_LONG_CTX, c_chunk=P13_C_CHUNK,
                            mesh=ctx.mesh, tp_degree=P19_TP)
        add(run["counts"])
        if event is not None and (event.info is None
                                  or not event.info["migrated"]):
            fail(f"(c) rank {rank}: the reprovision moved nothing: "
                 f"{event.info}")
        out["c"][paged] = dict(
            tokens=run["tokens"], counts=run["counts"], calls=calls,
            held=held, info=event and event.info, secs=run["secs"],
            rounds=run["rounds"])
    parts["(c)"] = time.perf_counter()
    # (b) the batch launcher at --mesh 1x4, then 2x2 (its own 2-way shard)
    out["b"] = {}
    b_rows = P19_BATCH[0]
    for m in ("1x4", "2x2"):
        bctx = PC.make_context(parse_mesh(m))
        args = batch_args(nd.name, P19_BATCH)
        args.mesh = m
        dp = bctx.mesh.size // bctx.tp
        row0 = bctx.data_rank * (b_rows // dp) if b_rows % dp == 0 else 0
        log, held_b = {}, {}
        _reset_launches()
        with _route_log(log, _batch_key, replay, sharded=row0), \
                _live_kernel_hold(held_b):
            run = serve.serve_batch(args, params=params if m == "1x4"
                                    else None, parallel=bctx, device=device)
        counts = _launch_counts(("gqa_decode",), f"(b) --mesh {m}")
        add(counts)
        if counts["gqa_decode"] != cfg.num_layers * (P19_BATCH[2] - 1):
            fail(f"(b) --mesh {m} rank {rank}: launches {counts}")
        keep = bctx.model_rank == 0
        out["b"][m] = dict(counts=counts, data_rank=run.data_rank,
                           prefill_ms=run.prefill_ms, held=held_b,
                           decode_tok_s=run.decode_tok_s, routes=log,
                           run=dataclasses.replace(
                               run, cache={}).to_cpu() if keep else None)
        del run
        if m == "1x4":
            del params
        torch.cuda.empty_cache()
    parts["(b)"] = time.perf_counter()
    # (d) reduced f32 at tp=4: the card against the CPU
    rcfg = _p19_reduced()
    cpu = M.init_params(rcfg, seed=0, device="cpu", parallel=ctx)
    out["d"] = {"cuda": _p18_reduced_runs(
        tree.map(lambda a: a.to(device), cpu), rcfg, device, ctx),
        "cpu": _p18_reduced_runs(cpu, rcfg, "cpu", ctx)}
    parts["(d)"] = time.perf_counter()
    out["launches"] = launches
    out["peak"] = torch.cuda.max_memory_allocated()
    out["parts"] = {k: v - t0 for k, v in parts.items()}
    return out


def _p19_tp1(cfg, nd):
    """The tp=1 references in this process, each model freed after: (a)
    scout's and deepseek's blocks, (b) the batch launcher with its
    routing logged, (d) the reduced CPU run."""
    import torch
    from repro_torch.models import model as M
    params = M.init_params(cfg, seed=0, device=DEVICE)
    ref = {"bytes": _nbytes(params)}
    lp = M._unstack(params["layers"]["moe"])[0]
    ref["moe_bytes"] = _nbytes(lp)
    ref["a"] = _p19_block_ref(lp, cfg, nd)
    del lp
    log = {}
    with _route_log(log, _batch_key):
        run, counts = _serve_batch(batch_args(nd.name, P19_BATCH), params,
                                   need=("gqa_decode",))
    ref["b"] = dict(run=dataclasses.replace(run, cache={}).to_cpu(),
                    routes=log, counts=counts)
    del run, params
    torch.cuda.empty_cache()
    ds = _p19_deepseek(1.25)
    lp = _p19_ds_layer(ds)
    ref["ds_bytes"] = _nbytes(lp)
    ref["ds_split"] = _p19_split(lp)
    ref["ds"] = _p19_block_ref(lp, ds, _p19_deepseek(P19_NO_DROP))
    del lp
    torch.cuda.empty_cache()
    rcfg = _p19_reduced()
    ref["d"] = _p18_reduced_runs(M.init_params(rcfg, seed=0, device="cpu"),
                                 rcfg, "cpu", None)
    return ref


def _p19_report_a(res, ref, what, cfg, tp1_bytes, smi):
    """(a): the no-drop outputs against tp=1 away from router near-ties,
    the drops a rank at the default capacity, ms a call beside the
    floors."""
    e_loc = cfg.moe.num_experts // P19_TP
    for b, s, mode in P19_BLOCK:
        r0 = res[0][what][(b, s)]
        want = ref[what][(b, s)]
        sure = want["gap"] >= P19_TIE
        y, y1 = r0["y"].float(), want["y"].float()
        top = float(y1.abs().max())
        err = float((y - y1).reshape(-1, cfg.d_model)[sure].abs().max())
        if err > TOL["bfloat16"] * top:
            fail(f"(a) {cfg.name} T={b * s} {mode}: tp={P19_TP} vs tp=1 "
                 f"{err / top:.3e} of max|y| (limit {TOL['bfloat16']})")
        rows = [r[what][(b, s)] for r in res]
        print(f"[ep] (a) {cfg.name} MoE block at its published widths "
              f"({cfg.moe.num_experts} experts of "
              f"{cfg.moe.expert_d_ff or cfg.d_ff}, top-{cfg.moe.top_k}, "
              f"{cfg.moe.num_shared_experts} shared), T={b * s} ({b} x {s}), "
              f"{mode} at tp={P19_TP} ({e_loc} experts a rank): at "
              f"capacity_factor {P19_NO_DROP} no drop, y within "
              f"{err / top:.3e} of max|y| of tp=1's over "
              f"{int(sure.sum())} of {b * s} tokens ({int((~sure).sum())} "
              f"router near-ties under {P19_TIE} left out); at "
              f"{cfg.moe.capacity_factor}: pairs dropped / routed to each "
              f"rank's experts {[(r['drops'], r['routed']) for r in rows]} "
              f"(tp=1: {want['drops']} dropped); ms a call by rank "
              f"{[round(r['ms'], 4) for r in rows]} against a rank's "
              f"floors: bytes {rows[0]['bytes_ms']:.4f} ms (its "
              f"{e_loc} experts, the router, the shared experts, x and y), "
              f"operations {rows[0]['ops_ms']:.4f} ms (its capacity "
              f"buffers); tp=1 {want['ms']:.4f} ms against "
              f"{1e3 * tp1_bytes / HBM_BYTES_PER_S:.4f} ms of the layer's "
              f"MoE weight bytes at 3.35 TB/s "
              f"({smi}; {P19_TP} ranks time-sliced on one card: "
              f"correctness, not tp={P19_TP} on {P19_TP} cards)")


def _p19_batch_rows(res, m):
    from repro_torch.launch import serve
    return serve._gather_rows([r["b"][m]["run"] for r in res
                               if r["b"][m]["run"] is not None])


def phase_ep(smi):
    """Phase 19: expert parallelism, llama4-scout at tp=4 over one rank
    group (module docstring). Returns the launches of every rank,
    summed."""
    import torch
    from repro_torch.distributed import context as PC
    t0 = time.perf_counter()
    cfg, nd = _p19_configs()
    want_bytes, sharded, repl = _p18_shard_bytes(cfg, P19_TP)
    ref = _p19_tp1(cfg, nd)
    t_ref = time.perf_counter()
    held_at_start = torch.cuda.memory_allocated()
    res = PC.launch_ranks(_p19_rank, P19_TP, (ref["b"]["routes"],),
                          device=DEVICE, timeout_s=P19_TIMEOUT_S)
    t_ranks = time.perf_counter()
    r0, r3 = res[0], res[-1]
    gb = 1e9
    for r in res:
        if r["param_bytes"] != want_bytes:
            fail(f"rank {r['rank']}: {r['param_bytes']} B of weights, want "
                 f"{want_bytes} (sharded {sharded} / {P19_TP} + replicated "
                 f"{repl})")
        experts, rest = ref["ds_split"]
        if r["ds_bytes"] != experts // P19_TP + rest:
            fail(f"(a) rank {r['rank']}: {r['ds_bytes']} B of deepseek MoE "
                 f"weights, want {experts} / {P19_TP} + {rest}")
    print(f"[ep] {cfg.name} {cfg.dtype} at tp={P19_TP}, {P19_TP} ranks on "
          f"one card (deepseek's MoE layer: {r0['ds_bytes'] / gb:.4f} GB a "
          f"rank, {ref['ds_bytes'] / gb:.4f} GB whole): each rank's weights "
          f"{want_bytes / gb:.4f} GB (the "
          f"sharded {sharded / gb:.4f} GB / {P19_TP} + the replicated "
          f"{repl / gb:.4f} GB: router, shared expert, norms), exact on "
          f"every rank; tp=1 {ref['bytes'] / gb:.4f} GB; peak device "
          f"memory per rank {[round(r['peak'] / 2**30, 2) for r in res]} "
          f"GiB; init {[round(r['init_s'], 2) for r in res]} s ({smi})")
    # (a) the blocks
    _p19_report_a(res, ref, "a", cfg, ref["moe_bytes"], smi)
    _p19_report_a(res, ref, "ds", _p19_deepseek(1.25), ref["ds_bytes"], smi)
    # (b) the batch launcher, each mesh against tp=1
    want = ref["b"]["run"]
    want_toks, want_log = _run_log(want)
    p = P19_BATCH[1]
    for m in ("1x4", "2x2"):
        got = _p19_batch_rows(res, m)
        toks, log = _run_log(got)
        routes = {}
        for r in res:
            for k, v in r["b"][m]["routes"].items():
                routes.setdefault(k, v)
        if routes.keys() != ref["b"]["routes"].keys() or any(
                len(v) != cfg.num_layers for v in routes.values()):
            fail(f"(b) --mesh {m}: the ranks logged the routing of "
                 f"{len(routes)} tokens, tp=1 {len(ref['b']['routes'])}")
        until = {b: next((j for j, (a, c) in enumerate(zip(t, toks[b]))
                          if a != c), len(t)) for b, t in want_toks.items()}
        rflips, noise = _route_flips(
            routes, ref["b"]["routes"], lambda k: (k[0], k[1] - (p - 1)),
            until, f"(b) --mesh {m}: tp's own routing vs tp=1's")
        flips = _bf16_flips(want_log, log, want_toks, toks,
                            f"(b) --mesh {m} vs 1x1", tag="ep")
        b0 = r0["b"][m]
        held = sorted({k[1] for r in res for k in r["b"][m]["held"]})
        worst = max(e / mx for r in res for e, mx in
                    r["b"][m]["held"].values())
        print(f"[ep] (b) batch launcher --mesh {m}, {P19_BATCH[0]} x {p} + "
              f"{P19_BATCH[2] - 1} decode steps, capacity_factor "
              f"{P19_NO_DROP}: prefill {b0['prefill_ms']:.2f} ms, decode "
              f"{1e3 * P19_BATCH[0] / b0['decode_tok_s']:.2f} ms a step "
              f"(rank 0); 1x1 {want.prefill_ms:.2f} ms, "
              f"{1e3 * P19_BATCH[0] / want.decode_tok_s:.2f} ms a step; "
              f"tp on tp=1's routing: {flips} near-tie divergences, "
              f"{rflips} routing decisions of its own differ (each a "
              f"near-tie; largest top router logit difference where they "
              f"route alike {noise:.4f}); gqa_decode {cfg.num_layers} x "
              f"{P19_BATCH[2] - 1} on every rank, held live at (B, S) "
              f"{held}, worst {worst:.3e} of max|plain| ({smi})")
        del got, log
    # (c) the fleet, dense then paged
    tr = [sum(r["c"][pg]["counts"]["textrank"] for pg in (False, True))
          for r in res]
    if tr[0] < 2 * len(P13_INBAND) or any(tr[1:]):
        fail(f"(c) TextRank launches by rank {tr}: want at least "
             f"{2 * len(P13_INBAND)} on rank 0 alone")
    for paged, kname, other, step in (
            (False, "gqa_decode", "paged_decode", "decode_step"),
            (True, "paged_decode", "gqa_decode", "paged_decode_step")):
        c0 = r0["c"][paged]
        for r in res:
            c = r["c"][paged]
            if c["tokens"] != c0["tokens"]:
                fail(f"(c) paged={paged}: rank {r['rank']}'s tokens differ "
                     "from rank 0's")
            n, steps = c["counts"][kname], c["calls"].get(step, 0)
            if n == 0 or n != cfg.num_layers * steps:
                fail(f"(c) rank {r['rank']} paged={paged}: {kname} launched "
                     f"{n} times over {steps} {step} calls, want "
                     f"{cfg.num_layers} a step")
            if c["counts"][other]:
                fail(f"(c) rank {r['rank']} paged={paged}: the fleet "
                     f"launched {other}")
            if not any(k[0] == kname for k in c["held"]):
                fail(f"(c) rank {r['rank']} paged={paged}: no live hold of "
                     f"{kname}")
        worst = max(e / mx for r in res for e, mx in
                    r["c"][paged]["held"].values())
        moved = (f"the long pool reprovisioned to {P9_LONG_TO} at round "
                 f"{P9_EVENT_ROUND} ({c0['info']['migrated']} migrated)"
                 if c0["info"] else "no reprovision")
        print(f"[ep] (c) llama4-scout {cfg.num_layers} layers, phase 13 "
              f"(c)'s K=2 fleet paged={paged} (contexts "
              f"{P13_LONG_CTX // 8} / {P13_LONG_CTX}, c_chunk {P13_C_CHUNK}, "
              f"window 0: the {'paged' if paged else 'fused'} chunk, a2a; "
              f"{step}, psum; decode_k 4) at tp={P19_TP}, {moved}: every "
              f"request completes ({len(c0['tokens'])}, {c0['rounds']} "
              f"rounds, {c0['secs']:.2f} s), the same tokens on every rank; "
              f"{kname} launches by rank "
              f"{[r['c'][paged]['counts'][kname] for r in res]} = "
              f"{cfg.num_layers} a decode step ({c0['calls'].get(step)} "
              f"steps) on {cfg.num_kv_heads // P19_TP} kv heads, q_per_kv "
              f"{cfg.num_heads // cfg.num_kv_heads}, head_dim "
              f"{cfg.resolved_head_dim}; held live at "
              f"{sorted({k[1] for k in c0['held']})} on every rank, worst "
              f"{worst:.3e} of max|plain| ({smi})")
    print(f"[ep] (c) TextRank launches by rank over both fleets {tr}")
    # (d) reduced f32: card tp=4, CPU tp=4, CPU tp=1
    lg1, tok1 = ref["d"]
    top = float(lg1.abs().max())
    errs = []
    for r in res:
        for where in ("cuda", "cpu"):
            lg, toks = r["d"][where]
            err = float((lg - lg1).abs().max())
            errs.append(err / top)
            if toks != tok1 or err > 1e-5 * top:
                fail(f"(d) rank {r['rank']} {where} tp={P19_TP}: tokens "
                     f"{'equal' if toks == tok1 else 'differ'}, logits "
                     f"{err / top:.3e} of max from CPU tp=1 (limit 1e-05)")
    print(f"[ep] (d) reduced llama4-scout f32 (4 experts, one a rank; "
          f"capacity_factor {P19_NO_DROP}): the card at tp={P19_TP} and the "
          f"CPU at tp={P19_TP} against the CPU at tp=1: tokens equal, "
          f"logits within {max(errs):.3e} of max (limit 1e-05)")
    launches = {}
    for r in res:
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    p = r0["parts"]
    print(f"[ep] phase 19: {time.perf_counter() - t0:.1f} s (tp=1 references "
          f"{t_ref - t0:.1f}, ranks {t_ranks - t_ref:.1f}: (a) deepseek "
          f"{p['(a) deepseek']:.1f}, init {r0['init_s']:.1f}, (a) "
          f"{p['(a)'] - p['(a) deepseek']:.1f}, (c) "
          f"{p['(c)'] - p['(a)']:.1f}, (b) {p['(b)'] - p['(c)']:.1f}, (d) "
          f"{p['(d)'] - p['(b)']:.1f}); device memory held at the spawn "
          f"{held_at_start / 2**30:.2f} GiB; launches of the {P19_TP} "
          f"ranks {launches} ({smi})")
    return launches


# ---------------------------------------------------------------- phase 20
P20_WORLD = 4                 # ranks of the group, all on the one card
P20_MESH = "1x4"              # the fleet's mesh: every rank
P20_TP = 2                    # each pool's degree: short on 0-1, long on 2-3
P20_TIMEOUT_S = 900           # the group's collective timeout
P20_PLACE = {"short": [0, 1], "long": [2, 3]}
P20_MOVES = {False: 1, True: 4}   # (c): the long pool's new degree, dense
                                  # (the reference's rule: rank 1) and paged
P20_SESSION = (1100, 60)      # (c) paged: the session's turn-1 prompt tokens,
                              # and the tokens turn 2 adds to it
P20_LEADS = (0, 1, 2)         # ranks whose logit logs the parent reads: the
                              # pools' leads, before and after each move


class _P20Event:
    """``_p9_serve``'s event for (c) and (d) on the tp=2 fleet. ``turn2``:
    a session turn submitted once the long pool's first request (its
    turn 1) decodes, so it admits prefix-warm. Once every occupied slot of
    the long pool decodes (and ``turn2`` was admitted), ``move`` (a tp)
    reprovisions the long pool there, with device memory, the host rows
    moved and the split timed; ``kill`` kills the short pool instead,
    which ``on_dead`` recovers on its own submesh. With neither, the run
    is the uninterrupted one of the same stream. ``held``: the caller's
    weights, which a move cannot free."""

    def __init__(self, move=None, turn2=None, kill=False, held=None):
        self.move, self.turn2, self.kill = move, turn2, kill
        self.held = id(held)
        self.at, self.info, self.report = None, None, {}

    def pending(self):
        return False

    def on_round(self, rt, rounds, rebuilt):
        long_ = rt.engines["long"]
        live = [not long_.slot_prefill_left[s] for s in range(long_.n_max)
                if long_.slot_req[s]]
        # a kill waits for one decoding slot, a move for every slot
        decoding = any(live) if self.kill else live and all(live)
        if self.turn2 is not None and not self.report.get("sent"):
            if decoding:
                d = rt.submit(self.turn2)
                if d.pool != "long":
                    fail(f"(c) the session's turn 2 routed to {d.pool}")
                self.report["sent"] = rounds
            return
        if self.at is not None or not decoding or (
                self.turn2 is not None
                and not long_.prefix_stats["hit_blocks"]):
            return
        self.at = rounds
        if self.kill:
            from repro_torch.serving.reconfigure import FaultInjector
            FaultInjector(rt).kill("short")
        elif self.move is not None:
            stats = long_.overload_stats
            kv0 = long_.cache_bytes_per_device()
            del long_
            self._move(rt, stats, kv0)
            rebuilt.add(rt.engines["long"])

    def _move(self, rt, stats, kv0):
        import torch
        from repro_torch.serving import reconfigure as RC
        from repro_torch.serving.engine import InferenceEngine
        # the move's parts: the drain, the weight reshard, the KV reshard
        # (every request's host rows) and the engine build
        parts = {"drain": (InferenceEngine, "drain_checkpoint"),
                 "weights": (RC, "reshard_params"),
                 "kv": (RC, "_reshard_kv"),
                 "build": (RC, "InferenceEngine")}
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        shards0 = {m: (_nbytes(p), id(p)) for m, p in rt.shards.items()}
        split = {}
        t0 = time.perf_counter()
        with _split_timer(split, parts):
            self.info = rt.reprovision("long", tp=self.move)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        mem1 = torch.cuda.memory_allocated()
        shards1 = {m: _nbytes(p) for m, p in rt.shards.items()}
        new = rt.engines["long"]
        # the old cache and shard set go (unless the caller holds the
        # set), the new ones come
        want = (mem0 - kv0 + new.cache_bytes_per_device()
                - sum(n for m, (n, i) in shards0.items()
                      if m not in shards1 and i != self.held)
                + sum(n for m, n in shards1.items() if m not in shards0))
        self.report.update(
            ms=ms, split={k: 1e3 * v for k, v in split.items()},
            devices=new.devices(), tp=new.tp_degree,
            moved=list(rt.moved_rows),
            mem=(mem0, mem1, want), kv=(kv0, new.cache_bytes_per_device()),
            member=new.member, recomputed=stats["recomputed"],
            swapped=stats["swapped_out"], shards=sorted(
                tuple(m.ranks) for m in rt.shards))

    def on_dead(self, rt, name, rebuilt):
        from repro_torch.serving.reconfigure import recover_pool
        self.info = recover_pool(rt, name)
        rebuilt.add(rt.engines[name])


@contextlib.contextmanager
def _p20_timers(acc):
    """Host seconds of each decode-only dispatch of the pools this rank is
    a member of, by the pool's context (the device synchronised around
    it), and of each readback's share with the process group
    (``ParallelContext.share``): "share" where this rank is one of the
    pool's (the exchange itself, the others already waiting in it),
    "wait" where it is not (its wait for the pool's dispatch); and the
    decode-step calls on this rank by the context of the pool stepping
    (each launches the decode kernel once a layer)."""
    import torch
    from repro_torch.distributed.context import ParallelContext as PCtx
    from repro_torch.models import model as M
    from repro_torch.serving.engine import InferenceEngine
    step, scan = InferenceEngine.step, InferenceEngine._run_decode_scan
    share = PCtx.share
    steps = {n: getattr(M, n) for n in ("decode_step", "paged_decode_step")}
    pool = [None]

    def pooled(self):
        pool[0] = self.c_max
        try:
            step(self)
        finally:
            pool[0] = None

    def timed_scan(self, mask):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scan(self, mask)
        torch.cuda.synchronize()
        if self.member:
            acc.setdefault(("dispatch", self.c_max), []).append(
                time.perf_counter() - t0)

    def timed_share(self, value, what):
        t0 = time.perf_counter()
        out = share(self, value, what)
        acc.setdefault("share" if self.member else "wait", []).append(
            time.perf_counter() - t0)
        return out

    def counted(fn):
        @functools.wraps(fn)           # its signature, for _logit_log
        def call(*a, **kw):
            key = ("steps", pool[0])
            acc[key] = acc.get(key, 0) + 1
            return fn(*a, **kw)
        return call
    InferenceEngine.step, InferenceEngine._run_decode_scan = pooled, timed_scan
    PCtx.share = timed_share
    for n, fn in steps.items():
        setattr(M, n, counted(fn))
    try:
        yield
    finally:
        InferenceEngine.step, InferenceEngine._run_decode_scan = step, scan
        PCtx.share = share
        for n, fn in steps.items():
            setattr(M, n, fn)


def _p20_session(tokenizer):
    """(c) paged: phase 9's short prompts, one long request (rid 10) and
    a session's first turn (rid 11, long), and its second turn (rid 12:
    the first's text and more, the event's to submit)."""
    import numpy as np
    from repro_torch.serving.pools import GatewayRequest
    rng = np.random.default_rng(20)
    turn1 = varied_prompt(rng, P20_SESSION[0], tokenizer)
    more = varied_prompt(rng, P20_SESSION[1], tokenizer)
    reqs = [GatewayRequest(i, varied_prompt(rng, n, tokenizer), P9_NEW)
            for i, n in enumerate(P9_SHORT[:3])]
    reqs.append(GatewayRequest(10, varied_prompt(rng, P9_LONG[0],
                                                 tokenizer), P9_NEW))
    reqs.append(GatewayRequest(11, turn1, P9_NEW, session="s"))
    return reqs, GatewayRequest(12, turn1 + " " + more, P9_NEW, session="s")


def _p20_serve(cfg, params, paged, lead, event=None, session=False, **skw):
    """One run of ``_p9_serve`` (phase 9's stream, or with ``session`` the
    session stream) with the logits logged (on ``lead`` ranks, kept in
    bf16 on the host), each decode kernel's first launch at every shape
    held live, and the dispatch, share and step timers; returns its
    result and the fleet's placement, bytes and members."""
    import torch
    log, held, acc = ({} if lead else None), {}, {}
    kw = dict(skw)
    if session:
        from repro_torch.serving.tokenizer import ByteChunkTokenizer
        reqs, turn2 = _p20_session(ByteChunkTokenizer(cfg.vocab_size))
        kw.update(reqs=lambda tok: reqs, prefix_cache=True)
        event.turn2 = turn2
    with _live_kernel_hold(held), _p20_timers(acc):
        r = _p9_serve(cfg, params, paged, log, event=event, keep=True, **kw)
    rt = r.pop("rt")
    r.update(place=rt.device_placement(),
             kv={n: e.cache_bytes_per_device() for n, e in rt.engines.items()},
             member={n: e.member for n, e in rt.engines.items()},
             shards={tuple(m.ranks): _nbytes(p)
                     for m, p in rt.shards.items() if m is not None},
             held=held, acc=acc,
             log=None if log is None else {
                 rid: {j: v.to(torch.bfloat16).cpu() for j, v in row.items()}
                 for rid, row in log.items()})
    if event is not None:
        r.update(at=event.at, info=event.info, report=event.report)
    del rt, log
    torch.cuda.empty_cache()
    return r


def _p20_rank(rank, device):
    """One rank of phase 20: (a)-(e) on this rank's shard of its tp=2
    submesh (module docstring). The leads' results carry their logit
    logs for the parent's drift rule."""
    import io
    import torch
    from repro_torch.distributed import context as PC
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_submeshes, parse_mesh
    from repro_torch.models import model as M
    mesh = parse_mesh(P20_MESH)
    own = next(c for c in (PC.make_context(m)
                           for m in make_submeshes(mesh, P20_TP))
               if c.member)
    cfg = _p18_model()
    out, parts = {"rank": rank}, {}
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device=device, parallel=own)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["param_bytes"] = _nbytes(params)
    lead = rank in P20_LEADS
    skw = dict(mesh=mesh, tp_degree=P20_TP)
    # (a), (b) the C&R fleet, dense then paged
    out["b"] = {paged: _p20_serve(cfg, params, paged, lead, **skw)
                for paged in (False, True)}
    parts["(b)"] = time.perf_counter()
    # (c) the long pool moved mid-flight: dense to tp=1 beside (b)'s
    # uninterrupted dense run; paged with the prefix cache to tp=4, a
    # prefix-warm session turn in flight, beside its own uninterrupted run
    out["c"] = {False: _p20_serve(
        cfg, params, False, lead,
        event=_P20Event(move=P20_MOVES[False], held=params), **skw)}
    for move in (None, P20_MOVES[True]):
        out["c"][(True, move)] = _p20_serve(
            cfg, params, True, lead, event=_P20Event(move=move, held=params),
            session=True, **skw)
    parts["(c)"] = time.perf_counter()
    # (d) the short pool killed while the long pool decodes
    out["d"] = _p20_serve(cfg, params, False, lead,
                          event=_P20Event(kill=True), **skw)
    parts["(d)"] = time.perf_counter()
    # (e) the launcher: serve.py --fleet 2 --tp 2 --mesh 1x4 on the card
    _reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rt, res, secs = serve.serve_fleet(
            fleet_args(tp=P20_TP, mesh=P20_MESH, new_tokens=P9_NEW),
            slots_per_pool=4, c_chunk=256, long_ctx=4096, params=params,
            device=device)
    out["e"] = dict(lines=buf.getvalue().splitlines(), secs=secs,
                    place=rt.device_placement(), counts=_launch_counts(),
                    done={rid: (r.timed_out, len(r.output_tokens))
                          for rid, r in res.items()})
    del rt, params
    torch.cuda.empty_cache()
    parts["(e)"] = time.perf_counter()
    out["peak"] = torch.cuda.max_memory_allocated()
    out["parts"] = {k: v - t0 for k, v in parts.items()}
    return out


def _p20_tp1(cfg):
    """(b)'s fleets at tp=1 in this process (logits logged, kernels held
    live, the timers on), the weights freed after."""
    import torch
    from repro_torch.models import model as M
    params = M.init_params(cfg, seed=0, device=DEVICE)
    ref = {paged: _p20_serve(cfg, params, paged, True)
           for paged in (False, True)}
    del params
    torch.cuda.empty_cache()
    return ref


def _p20_logs(runs):
    """The logit log of one run (f32), merged over the ranks that logged
    it (each logs the pools it is a member of; members of one pool log
    the same bits)."""
    import torch
    log = {}
    for run in runs:
        for rid, row in (run["log"] or {}).items():
            for j, v in row.items():
                log.setdefault(rid, {})[j] = v.to(torch.float32)
    return log


def _p20_ms(acc, key) -> str:
    v = acc.get(key) or []
    return f"{1e3 * sum(v) / len(v):.2f}" if v else "none"


def _p20_check_b(cfg, res, ref, paged, smi):
    """(b) one layout's fleet: the ranks' tokens against tp=1's, TextRank
    on rank 0 alone, each rank's decode kernel launched for its own
    pool's decode steps only, 32 a step, and held live."""
    short, long_ = 512, 4096
    runs, want = [r["b"][paged] for r in res], ref[paged]
    if any(x["tokens"] != runs[0]["tokens"] for x in runs[1:]):
        fail(f"(b) paged={paged}: the ranks' tokens differ")
    flips = _bf16_flips(_p20_logs([want]), _p20_logs(runs), want["tokens"],
                        runs[0]["tokens"], f"(b) paged={paged} two tp="
                        f"{P20_TP} pools vs tp=1", tag="submesh")
    kname, other = (("paged_decode", "gqa_decode") if paged
                    else ("gqa_decode", "paged_decode"))
    tr = [x["counts"]["textrank"] for x in runs]
    if tr[0] < 1 or any(tr[1:]):
        fail(f"(b) TextRank launches by rank {tr}: want rank 0 alone")
    steps = []
    for rank, x in enumerate(runs):
        mine = short if rank in P20_PLACE["short"] else long_
        n = x["acc"].get(("steps", mine), 0)
        elsewhere = {k: v for k, v in x["acc"].items() if isinstance(k, tuple)
                     and k[0] == "steps" and k[1] != mine}
        if elsewhere or n == 0 or x["counts"][other] \
                or x["counts"][kname] != cfg.num_layers * n:
            fail(f"(b) paged={paged} rank {rank}: {kname} "
                 f"{x['counts'][kname]} over {n} decode steps of its pool, "
                 f"{other} {x['counts'][other]}, other pools' steps "
                 f"{elsewhere}")
        if {k[0] for k in x["held"]} != {kname}:
            fail(f"(b) paged={paged} rank {rank}: held {sorted(x['held'])}")
        steps.append(n)
    tp1 = sum(v for k, v in want["acc"].items()
              if isinstance(k, tuple) and k[0] == "steps")
    if steps[0] != steps[1] or steps[2] != steps[3] \
            or steps[0] + steps[2] != tp1:
        fail(f"(b) paged={paged}: decode steps by rank {steps}, tp=1 {tp1}")
    worst = max(e / m for x in runs for e, m in x["held"].values())
    r0, r2 = runs[0], runs[2]
    print(f"[submesh] (b) fleet paged={paged} (phase 9's stream: 5 short, 2 "
          f"long, 1 in-band compressed into the short pool): every request "
          f"completes, the same tokens on every rank, {flips} near-tie "
          f"divergences from tp=1; TextRank by rank {tr}; {kname} by rank "
          f"{[x['counts'][kname] for x in runs]} ({cfg.num_layers} a decode "
          f"step of the rank's own pool: steps {steps}, tp=1 {tp1}), held "
          f"live at {sorted({k[1] for x in runs for k in x['held']})} within "
          f"{worst:.3e} of max|plain|; decode ms a dispatch short "
          f"{_p20_ms(r0['acc'], ('dispatch', short))} (rank 0), long "
          f"{_p20_ms(r2['acc'], ('dispatch', long_))} (rank 2), tp=1 "
          f"{_p20_ms(want['acc'], ('dispatch', short))} / "
          f"{_p20_ms(want['acc'], ('dispatch', long_))}; a readback's share "
          f"with the group {_p20_ms(r0['acc'], 'share')} ms on a member "
          f"({len(r0['acc'].get('share', []))} on rank 0), "
          f"{_p20_ms(r0['acc'], 'wait')} ms waited outside the pool "
          f"({len(r0['acc'].get('wait', []))}); {r0['secs']:.2f} s against "
          f"tp=1's "
          f"{want['secs']:.2f} s ({smi}; four ranks time-slice one card: "
          f"correctness, not four cards)")


def _p20_check_c(res, key, base, what, new_tp, smi):
    """(c) one move of the long pool: the ranks' tokens against the
    uninterrupted run's (``base``), every checkpointed request swapped
    (none recomputed), the host rows' heads bitwise, KV bytes a member
    scaled by tp_old / tp_new, device memory after = before - old + new
    within 1 MiB on every rank."""
    runs, plain = [r["c"][key] for r in res], [base(r) for r in res]
    if any(x["tokens"] != runs[0]["tokens"] for x in runs[1:]):
        fail(f"(c) {what}: the ranks' tokens differ")
    flips = _bf16_flips(_p20_logs(plain), _p20_logs(runs),
                        plain[0]["tokens"], runs[0]["tokens"],
                        f"(c) {what} vs uninterrupted", tag="submesh")
    info, rep = runs[0]["info"], [x["report"] for x in runs]
    new_ranks, old_ranks = rep[0]["devices"], P20_PLACE["long"]
    kv_old = rep[old_ranks[0]]["kv"][0]
    for rank, x in enumerate(rep):
        if x["recomputed"] or x["swapped"] != info["checkpointed"]:
            fail(f"(c) {what} rank {rank}: recomputed {x['recomputed']}, "
                 f"swapped {x['swapped']} of {info['checkpointed']}")
        mem0, mem1, want = x["mem"]
        if abs(mem1 - want) > 2 ** 20:
            fail(f"(c) {what} rank {rank}: device memory after the move "
                 f"{mem1} B, want {want} B (before {mem0} B)")
        if (rank in new_ranks) != x["member"] or (
                x["member"] and x["kv"][1] * new_tp != kv_old * P20_TP):
            fail(f"(c) {what} rank {rank}: KV bytes {x['kv']}, a member's "
                 f"before {kv_old}")
    moved = rep[0]["moved"]
    if not moved:
        fail(f"(c) {what}: no host row moved")
    for k, rec in enumerate(moved):
        sent = [rep[i]["moved"][k]["sent"] for i in old_ranks]
        for i in new_ranks:
            got = rep[i]["moved"][k]
            if got["got"] != sent or got["leaf"] != rec["leaf"]:
                fail(f"(c) {what}: rid {rec['rid']} {rec['leaf']} arrived "
                     f"on rank {i} as {got['got']}, sent {sent}")
    sp = [x["split"] for x in rep]
    part = lambda k: [round(s.get(k, 0.0), 1) for s in sp]  # noqa
    print(f"[submesh] (c) {what}: the long pool on ranks {new_ranks} (tp="
          f"{rep[0]['tp']}) after round {runs[0]['at']}, "
          f"{info['checkpointed']} checkpointed, every one swapped and none "
          f"recomputed; {len(moved)} host leaves moved, each old member's "
          f"heads bitwise (crc32); KV bytes a member {kv_old} -> "
          f"{rep[new_ranks[0]]['kv'][1]}; device memory after = before - "
          f"old + new within 1 MiB on every rank (before "
          f"{[round(x['mem'][0] / 2**30, 2) for x in rep]}, after "
          f"{[round(x['mem'][1] / 2**30, 2) for x in rep]} GiB); {flips} "
          f"near-tie divergences from the uninterrupted run; reprovision ms "
          f"by rank {[round(x['ms'], 1) for x in rep]}: drain_checkpoint "
          f"{part('drain')}, weight reshard {part('weights')}, KV reshard "
          f"{part('kv')}, engine build {part('build')} ({smi})")


def phase_submesh(smi):
    """Phase 20: the K-pool fleet on disjoint tp=2 submeshes (module
    docstring). Returns the launches of every rank, summed."""
    import torch
    from repro_torch.distributed import context as PC
    t0 = time.perf_counter()
    cfg = _p18_model()
    want_bytes, sharded, repl = _p18_shard_bytes(cfg, P20_TP)
    ref = _p20_tp1(cfg)
    t_ref = time.perf_counter()
    held_at_start = torch.cuda.memory_allocated()
    res = PC.launch_ranks(_p20_rank, P20_WORLD, device=DEVICE,
                          timeout_s=P20_TIMEOUT_S)
    t_ranks = time.perf_counter()
    # (a) placement and bytes
    for rank, r in enumerate(res):
        pool = "short" if rank in P20_PLACE["short"] else "long"
        other = "long" if pool == "short" else "short"
        if r["param_bytes"] != want_bytes:
            fail(f"(a) rank {rank}: {r['param_bytes']} B of weights, want "
                 f"{want_bytes}")
        for paged in (False, True):
            b = r["b"][paged]
            if b["place"] != P20_PLACE or b["shards"] != {
                    tuple(P20_PLACE[pool]): want_bytes}:
                fail(f"(a) rank {rank}: placement {b['place']}, shard sets "
                     f"{b['shards']}")
            if b["kv"][other] or b["member"][other] or \
                    P20_TP * b["kv"][pool] != ref[paged]["kv"][pool]:
                fail(f"(a) rank {rank} paged={paged}: KV bytes {b['kv']}, "
                     f"tp=1 {ref[paged]['kv']}")
    print(f"[submesh] (a) {cfg.name} {cfg.dtype}, {P20_WORLD} ranks on one "
          f"card over mesh {P20_MESH}, two tp={P20_TP} pools: placement "
          f"{P20_PLACE} on every rank; each rank's weights "
          f"{want_bytes / 1e9:.4f} GB, its pool's shard only (sharded "
          f"{sharded / 1e9:.4f} GB / {P20_TP} + replicated {repl} B), exact;"
          f" no cache of the other pool; KV bytes a member x {P20_TP} = the "
          f"tp=1 pool's exactly (dense {ref[False]['kv']}, paged "
          f"{ref[True]['kv']} B at tp=1); init "
          f"{[round(r['init_s'], 2) for r in res]} s ({smi})")
    for paged in (False, True):
        _p20_check_b(cfg, res, ref, paged, smi)
    _p20_check_c(res, False, lambda r: r["b"][False], "dense 2 -> 1",
                 P20_MOVES[False], smi)
    _p20_check_c(res, (True, P20_MOVES[True]), lambda r: r["c"][(True, None)],
                 "paged 2 -> 4, a prefix-warm session turn in flight",
                 P20_MOVES[True], smi)
    # (d) crash recovery on a submesh
    runs, base = [r["d"] for r in res], res[0]["b"][False]
    longs = [rid for rid in base["tokens"] if 10 <= rid < 20]
    if any(x["tokens"] != runs[0]["tokens"] for x in runs[1:]):
        fail("(d) the ranks' tokens differ")
    info = runs[0]["info"]
    if info is None or runs[0]["stats"]["engine_restarts"] != 1:
        fail(f"(d) no recovery: {info}")
    flips = _bf16_flips(_p20_logs([r["b"][False] for r in res]),
                        _p20_logs(runs),
                        {rid: base["tokens"][rid] for rid in longs},
                        runs[0]["tokens"], "(d) the long pool, the short "
                        "pool killed", tag="submesh")
    print(f"[submesh] (d) the short pool killed after round {runs[0]['at']} "
          f"while the long pool decodes: recover_pool rebuilt it on ranks "
          f"{P20_PLACE['short']} and moved {info['migrated']} requests to "
          f"the {info['rerouted_to']} pool; every accepted request "
          f"completes; the long pool's requests {longs}: {flips} near-tie "
          f"divergences from the run without the fault")
    # (e) the launcher
    lines = [ln for ln in res[0]["e"]["lines"] if "tp=" in ln]
    if lines != [f"  {n}: tp={P20_TP} devices={d}"
                 for n, d in P20_PLACE.items()]:
        fail(f"(e) placement lines {lines}")
    for rank, r in enumerate(res):
        if r["e"]["place"] != P20_PLACE or any(
                t or not n for t, n in r["e"]["done"].values()):
            fail(f"(e) rank {rank}: {r['e']['place']} {r['e']['done']}")
    print(f"[submesh] (e) serve.py --fleet 2 --tp {P20_TP} --mesh {P20_MESH} "
          f"on the card prints {lines}; {len(res[0]['e']['done'])} requests "
          f"complete in {res[0]['e']['secs']:.2f} s")
    launches = {}
    for r in res:
        for run in (r["b"][False], r["b"][True], r["c"][False],
                    r["c"][(True, None)], r["c"][(True, P20_MOVES[True])],
                    r["d"], r["e"]):
            for k, n in run["counts"].items():
                launches[k] = launches.get(k, 0) + n
    p = res[0]["parts"]
    print(f"[submesh] phase 20: {time.perf_counter() - t0:.1f} s (tp=1 "
          f"references {t_ref - t0:.1f}, ranks {t_ranks - t_ref:.1f}: init "
          f"{res[0]['init_s']:.1f}, (b) {p['(b)']:.1f}, (c) "
          f"{p['(c)'] - p['(b)']:.1f}, (d) {p['(d)'] - p['(c)']:.1f}, (e) "
          f"{p['(e)'] - p['(d)']:.1f}); peak device memory per rank "
          f"{[round(r['peak'] / 2**30, 2) for r in res]} GiB; held by this "
          f"process at the spawn {held_at_start / 2**30:.2f} GiB; launches "
          f"of the {P20_WORLD} ranks {launches} ({smi})")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: the port is not at {SRC / 'repro_torch'}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t0 = time.perf_counter()
    smi = phase_card()
    phase_build()
    rows = phase_kernels()
    phase_fleet_kernels()
    phase_head_shapes()
    phase_long_rows()
    rows["textrank"] = phase_textrank()
    phase_parity()
    launches = phase_fleet()
    launches["textrank"] = phase_gateway()
    phase_compressor_paper_size()
    phase_spec_overload()
    phase_forward(smi)
    for name, n in phase_reprovision(smi).items():
        launches[name] += n
    for name, n in phase_http(smi).items():
        launches[name] += n
    phase_train(smi)
    for name, n in phase_kv(smi).items():
        launches[name] += n
    for name, n in phase_moe(smi).items():
        launches[name] += n
    for name, n in phase_recurrent(smi).items():
        launches[name] += n
    for name, n in phase_vlm(smi).items():
        launches[name] += n
    for name, n in phase_encdec(smi).items():
        launches[name] += n
    for name, n in phase_mla(smi).items():
        launches[name] += n
    for name, n in phase_tp(smi).items():
        launches[name] += n
    for name, n in phase_ep(smi).items():
        launches[name] += n
    for name, n in phase_submesh(smi).items():
        launches[name] += n
    sources = {"gqa_decode": ("src/repro_torch/kernels/csrc/gqa_decode.cu",
                              "src/repro/kernels/gqa_decode.py:29"),
               "paged_decode": ("src/repro_torch/kernels/csrc/paged_decode.cu",
                                "src/repro/kernels/paged_decode.py:37"),
               "textrank": ("src/repro_torch/kernels/csrc/textrank.cu",
                            "src/repro/kernels/textrank.py:24")}
    line = []
    for name, (src, replaces) in sources.items():
        r = rows[name]
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
