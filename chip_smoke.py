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

Then it prints the ``kernels`` JSON line, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. Imports nothing of
JAX and nothing of the JAX package.
"""
import contextlib
import dataclasses
import json
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
@contextlib.contextmanager
def _decode_timer(log):
    """Time every decode-only dispatch on the host clock, the device
    synchronised on both ends (the dispatch itself ends in a sync)."""
    import torch
    from repro_torch.serving.engine import InferenceEngine
    orig = InferenceEngine._run_decode_scan

    def timed(self, mask):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        before = self.decode_tokens_emitted
        orig(self, mask)
        torch.cuda.synchronize()
        log.append((time.perf_counter() - t0,
                    self.decode_tokens_emitted - before))
    InferenceEngine._run_decode_scan = timed
    try:
        yield
    finally:
        InferenceEngine._run_decode_scan = orig


def phase_fleet():
    import argparse
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving.engine import ServeRequest
    tokens = {}
    launches = {}
    for paged, kernel in ((False, ops.KERNELS[0]), (True, ops.KERNELS[1])):
        args = argparse.Namespace(arch="minitron-8b", reduced=False, fleet=2,
                                  workload="azure", lam=1000.0, paged=paged,
                                  prefix_cache=False, decode_k=4,
                                  new_tokens=64, device="cuda")
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
    import argparse
    import numpy as np
    import torch
    from repro_torch.core.compression import ExtractiveCompressor
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving.pools import GatewayRequest
    args = argparse.Namespace(arch="minitron-8b", reduced=False, fleet=2,
                              workload="azure", lam=1000.0, paged=False,
                              prefix_cache=True, decode_k=4, new_tokens=64,
                              device="cuda")
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
