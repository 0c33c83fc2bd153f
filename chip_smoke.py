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
7. speculation and overload survival, minitron-8b bf16 at full width
   unless said otherwise; the launch counts are reset before each part.
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
   minitron-8b bf16, 4 slots a pool, contexts 512 / 4096, c_chunk 256,
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
   the weights of phase 9 reused, an ephemeral port, the client in
   process), every answer read as it arrives. (a) paged with the prefix
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

Then it prints the ``kernels`` JSON line, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. Imports nothing of
JAX and nothing of the JAX package.
"""
import contextlib
import dataclasses
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


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


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
              http=None, smoke=False, chaos=False, replan_interval=None)
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
                tag="spec/overload") -> int:
    """Hold a full-width bf16 run (``got`` tokens, ``path_log``) against
    the plain run (``want``, ``plain_log``) by the drift and near-tie rule
    above. Prints the plain run's top-2 gap over every emitted position,
    the largest drift where the histories agree, and each first divergence
    with the plain run's preference there. Returns the divergences."""
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
          f"bf16 ulps of the top logit (limit {BF16_DRIFT_ULPS}; a shift "
          f"of the plain history by one position: least {shift[0]:.2f}, "
          f"median {shift[len(shift) // 2]:.2f}); "
          f"plain top-2 gap over {len(gaps)} emitted positions, in ulps: min "
          f"{gaps[0]:.2f}, p10 {q(.1):.2f}, p25 {q(.25):.2f}, median "
          f"{q(.5):.2f}, p90 {q(.9):.2f}, max {gaps[-1]:.2f}; "
          f"{sum(g <= BF16_GAP_ULPS for g in gaps)}/{len(gaps)} within the "
          f"near-tie limit ({BF16_GAP_ULPS} ulps)")
    if drift > BF16_DRIFT_ULPS:
        fail(f"{what}: logits drift {drift:.2f} ulps from the plain run's "
             f"where the histories agree (limit {BF16_DRIFT_ULPS})")
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
    _spec_fleet()
    cfg, base = _full_width()
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


def _spec_fleet():
    """(b) ``launch.serve --fleet 2 --paged --decode-k 4 --spec-k 4`` at
    full width with random weights (drafts mostly rejected) against the
    same fleet at spec_k 1."""
    import torch
    from repro_torch.launch import serve
    out, launches, logs = {}, {}, {}
    for sk in (1, 4):
        _reset_launches()
        log, logs[sk] = [], {}
        with _decode_timer(log, ("_run_decode_scan", "_run_spec_scan")), \
                _logit_log(logs[sk]):
            rt, results, secs = serve.serve_fleet(
                fleet_args(paged=True, spec_k=sk, device=DEVICE),
                slots_per_pool=4,
                c_chunk=256, long_ctx=4096)
        launches[sk] = _launch_counts(("paged_decode",), f"fleet spec_k={sk}")
        for rid, res in results.items():
            if res.timed_out or not res.output_tokens:
                fail(f"fleet spec_k={sk}: request {rid} did not complete")
        out[sk] = {rid: r.output_tokens for rid, r in results.items()}
        dec_s, dec_tok = sum(t for t, _ in log), sum(n for _, n in log)
        spec = {n: (round(e.spec_kappa(), 4),
                    round(e.spec_acceptance_rate(), 4),
                    dict(e.spec_stats)) for n, e in rt.engines.items()}
        print(f"[spec/overload] (b) fleet minitron-8b bf16 full width, paged,"
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
    """(a) The agent-loop weights at full width: acceptance 1, kappa ==
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
            print(f"[spec/overload] (a) agent loop minitron-8b bf16 full "
                  f"width, paged={paged}, n_max 4, c_max 4096, decode_k 4, "
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
    slot's fresh blocks; dense: its row); a dense row's tail past
    ``pad_from`` tokens, where the host copy was zero-padded, is zero."""
    import torch
    for k, a in eng.cache["kv"].items():
        got = (a[:, eng._slot_blocks[s]] if eng.paged else a[:, s]).cpu()
        if not torch.equal(got, state.host_kv[k]):
            fail(f"{what}: the KV restored for rid {state.req.rid} differs "
                 f"from the bits swapped out ({k})")
        if pad_from is not None and not eng.paged and got[:, pad_from:].any():
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
    """(d) The paged long pool at full width under 8 requests of
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
        fail(f"(d) no swap at full width: {st}")
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
    print(f"[spec/overload] (d) overload, minitron-8b bf16 full width, paged"
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
              f"minitron-8b bf16 full width, {LOUT_BLOCKS} blocks, 8 requests "
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


def _serve_batch(args, params, tokens=None, need=(), impl="kernel"):
    """One batch-launcher run (decode attention through ``impl``) with the
    launch counts reset just before; fails unless each kernel in ``need``
    launched exactly once per layer per decode step, and nothing else
    launched."""
    from repro_torch.launch import serve
    _reset_launches()
    run = serve.serve_batch(args, params=params, tokens=tokens,
                            decode_impl=impl)
    counts = _launch_counts(need, f"batch launcher {args.arch}")
    want = {k: 0 for k in counts}
    want.update({k: run.cfg.num_layers * (args.new_tokens - 1)
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
          f"(= {kern.cfg.num_layers} x {shape[2] - 1}); {flips} near-tie "
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
P9_SHORT = (300, 420, 360, 390, 330)     # prompt tokens: L_total <= B = 512
P9_LONG = (1500, 2500)                   # > gamma * B = 1024: the long pool
P9_INBAND = 700                          # B < L_total <= gamma * B: C&R
P9_EVENT_ROUND = 3                       # drive rounds before the event
P9_SHORT_TO = dict(n_max=2, c_max=768)   # (a): the short pool, >= B
P9_LONG_TO = dict(c_max=6144)            # (a): the long pool, n_max kept
P9_BLACKOUT_S = 1.0


def _p9_fleet(cfg, params, paged):
    """Phase 5's fleet (``fleet_args``' azure plan, 4 slots a pool,
    c_chunk 256, contexts 512 / 4096, decode_k 4) over ``params``, as
    ``launch.serve.build_fleet_runtime`` builds it, without drawing a
    second set of weights."""
    from repro_torch.core.planner import plan_k_pool
    from repro_torch.core.workload import get_workload
    from repro_torch.serving.config import ServingConfig
    from repro_torch.serving.pools import FleetRuntime
    a = fleet_args(paged=paged)
    plan = plan_k_pool(get_workload(a.workload), lam=a.lam, t_slo=0.5,
                       k=a.fleet)
    return FleetRuntime.from_plan(
        cfg, params, plan, slots_per_pool=4, c_chunk=256,
        ctx_scale=4096 / plan.pools[-1].c_max,
        config=ServingConfig(paged=paged, decode_k=a.decode_k))


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


def _p9_serve(cfg, params, paged, log, event=None, health=False):
    """Serve phase 9's stream on a new fleet, logging the logits behind
    every emitted token, driving round by round (each busy engine stepped
    once a round) until it drains. ``event.on_round(rt, rounds, rebuilt)``
    runs after every round; with ``health`` a HealthPolicy(patience=2)
    hands the pools it finds wedged to ``event.on_wedged``. Returns the
    run's tokens, rounds, launches and stats; keeps no engine."""
    import weakref
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving.reconfigure import HealthPolicy
    rt = _p9_fleet(cfg, params, paged)
    short, long_ = rt.router.names[0], rt.router.names[-1]
    _reset_launches()
    rebuilt = weakref.WeakSet()
    rebuilt_counts = {k.name: 0 for k in ops.KERNELS}
    for r in _p9_requests(rt.tokenizer):
        d = rt.submit(r)
        want = (long_ if r.rid >= 10 and r.rid < 20 else short,
                r.rid == 20)
        if (d.pool, d.compressed) != want:
            fail(f"reprovision: request {r.rid} routed to {d.pool} "
                 f"(compressed={d.compressed}), not {want}")
    policy = HealthPolicy(patience=2) if health else None
    done_round, rounds = {}, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _logit_log(log):
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
        if r.timed_out or r.shed or len(r.output_tokens) != P9_NEW:
            fail(f"reprovision: request {rid} did not complete "
                 f"({len(r.output_tokens)} tokens, timed_out="
                 f"{r.timed_out}, shed={r.shed})")
    out = dict(tokens={rid: r.output_tokens for rid, r in sorted(
        res.items())}, rounds=rounds, done_round=done_round, secs=secs,
        stats=dict(rt.reprovision_stats), counts=_launch_counts(),
        rebuilt_counts=rebuilt_counts)
    del rt
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _split_timer(split):
    """Seconds of ``drain_checkpoint``, of the engine build and of
    ``_adopt_state`` (fitting each host checkpoint to the new geometry: a
    dense row padded on the host) inside a reprovision call, the device
    synchronised around each."""
    import torch
    from repro_torch.serving import reconfigure
    from repro_torch.serving.engine import InferenceEngine
    drain, build = InferenceEngine.drain_checkpoint, reconfigure.InferenceEngine
    adopt = reconfigure._adopt_state

    def timed(fn, key):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            split[key] = split.get(key, 0.0) + time.perf_counter() - t0
            return out
        return call
    InferenceEngine.drain_checkpoint = timed(drain, "drain")
    reconfigure.InferenceEngine = timed(build, "build")
    reconfigure._adopt_state = timed(adopt, "adopt")
    try:
        yield
    finally:
        InferenceEngine.drain_checkpoint = drain
        reconfigure.InferenceEngine = build
        reconfigure._adopt_state = adopt


@contextlib.contextmanager
def _live_kernel_hold(held):
    """Hold each decode kernel against its plain version on the live
    inputs of its first launch at every (B, S) the run gives it (S the
    dense cache's length, or blocks_per_slot x BLOCK_S), the rebuilt
    pools' shapes among them, under phase 3's TOL and one-bf16-ulp rule.
    The launch held is the path's own, checked before the next layer
    writes the cache; the plain version launches nothing.
    ``held[(kernel, (B, S))]`` gets (max_abs_err, max|plain|)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.gqa_decode import gqa_decode_plain
    from repro_torch.kernels.paged_decode import paged_gqa_decode_plain
    dense, paged = ops.gqa_decode, ops.paged_gqa_decode

    def hold(kname, shape, plain, q, args, out, active):
        key = (kname, shape)
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
    cfg, params = _full_width()
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
    cfg, params = _full_width()
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
