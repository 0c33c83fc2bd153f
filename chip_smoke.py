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


def profile_decode(eng, n_dispatch: int = 2):
    """torch.profiler over ``n_dispatch`` decode dispatches of a busy
    engine: device kernel time per dispatch, the device's busy share of
    the wall time, and the kernels that take the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_dispatch):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side rows only (kernels, copies): the CPU ops that launched
    # them carry the same device time again
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.self_device_time_total]
    dev_us = sum(r[1] for r in rows)
    if dev_us == 0:
        return None
    rows.sort(key=lambda r: -r[1])
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
              new_tokens=64, device="cuda", int8_kv=False)
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
            blocks = self._slot_blocks[s]
            for k, a in self.cache["kv"].items():
                if not torch.equal(a[:, blocks].cpu(), state.host_kv[k]):
                    fail("(d) swap-in: restored blocks differ from the bits "
                         "swapped out")
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
