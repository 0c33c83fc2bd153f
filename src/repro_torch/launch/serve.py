"""Serving on the GPU: the batch launcher (prefill a batch of prompts,
then greedy decode) and, with ``--fleet K``, offline fleet serving (plan
a K-pool fleet with the FleetOpt planner, build one gateway-routed
engine per pool, route a mixed prompt batch through the C&R gateway and
drain it).

  # batch launcher: full-width minitron-8b (bf16), 8 prompts of 64
  # tokens, 16 new tokens each, decode through the CUDA kernel
  PYTHONPATH=src python -m repro_torch.launch.serve

  # the same with the int8 KV cache, reduced (f32) on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --int8-kv \
      --batch 2 --prompt-len 16 --new-tokens 4 --device cpu

  # reduced model (f32), 2 pools, decode micro-loop of 4, paged KV
  PYTHONPATH=src python -m repro_torch.launch.serve --fleet 2 --reduced \
      --decode-k 4 --paged

  # full-width minitron-8b (bf16) on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --fleet 2 --decode-k 4

  # paged engines with the prefix cache, plus a two-turn session that
  # session affinity pins to the pool holding its cached prefix
  PYTHONPATH=src python -m repro_torch.launch.serve --fleet 2 --reduced \
      --decode-k 4 --prefix-cache --device cpu

  # self-speculative decoding (verify windows of 4) with preemption and
  # queue-wait shedding; prints kappa / acceptance and the overload line
  PYTHONPATH=src python -m repro_torch.launch.serve --fleet 2 --reduced \
      --paged --decode-k 4 --spec-k 4 --preemption --max-queue-wait 8 \
      --device cpu

The port of ``repro/launch/serve.py`` without its HTTP gateway and
sharding. Runs on ``--device cuda`` (the default) and raises when no
card is present; ``--device cpu`` runs the plain PyTorch versions of the
kernels.
"""
import argparse
import dataclasses
import time
from typing import Any, Dict, List

import torch

from repro_torch.configs.base import get_config
from repro_torch.core.planner import plan_k_pool
from repro_torch.core.workload import get_workload
from repro_torch.models import model as M
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.pools import FleetRuntime, GatewayRequest


def resolve_device(name: str) -> torch.device:
    """The device to serve on; a CUDA device must exist (no silent CPU
    fallback). f32 products stay full f32 on the card: TF32 off."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {name}: no CUDA device is "
                               "available (pass --device cpu to run the "
                               "plain PyTorch path on the CPU)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def model_config(args):
    """The launcher's model: ``--arch``, reduced in f32 with
    ``--reduced``, with the int8 KV cache under ``--int8-kv``."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    if args.int8_kv:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    return cfg


@dataclasses.dataclass
class BatchRun:
    """What :func:`serve_batch` served. ``prompt``: (B, prompt_len) ids;
    ``tokens``: (B, new_tokens) greedy tokens; ``logits[j]``: the (B, V)
    logits token ``j`` is the argmax of; ``cache``: the KV cache after
    the last step; host-clock prefill milliseconds and decode tokens per
    second (the device synchronised around each)."""
    cfg: Any
    prompt: torch.Tensor
    tokens: torch.Tensor
    logits: List[torch.Tensor]
    cache: Dict[str, Any]
    prefill_ms: float
    decode_tok_s: float


def serve_batch(args, params=None, tokens=None,
                decode_impl: str = "kernel") -> BatchRun:
    """The batch launcher: prefill ``--batch`` prompts of
    ``--prompt-len`` tokens into a cache of prompt + ``--new-tokens``,
    then ``new_tokens - 1`` greedy decode steps at the uniform position
    ``prompt_len + t``. ``params`` / ``tokens`` default to
    ``init_params(seed=0)`` and prompt ids drawn from a generator seeded
    with 0 on the device; a caller may pass its own (the tests pass the
    JAX launcher's). ``decode_impl``: decode attention through the CUDA
    kernel (its plain version on the CPU) or the torch ``_sdpa`` path,
    which a caller may ask for to hold the kernel against it."""
    if args.mesh not in ("", "1x1"):
        raise NotImplementedError(
            f"--mesh {args.mesh}: sharded serving is a later slice of the "
            "PyTorch port (one device only: --mesh 1x1)")
    device = resolve_device(args.device)
    cfg = model_config(args)
    if params is None:
        params = M.init_params(cfg, seed=0, device=device)
    if tokens is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        tokens = torch.randint(1, cfg.vocab_size,
                               (args.batch, args.prompt_len), generator=gen,
                               device=device)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else lambda: None)
    sync()
    t0 = time.perf_counter()
    logits, cache = M.prefill(params, cfg, {
        "tokens": tokens, "cache_len": args.prompt_len + args.new_tokens})
    nxt = logits.argmax(-1)[:, None]
    sync()
    t1 = time.perf_counter()
    out, steps = [nxt], [logits]
    for t in range(args.new_tokens - 1):
        logits, cache = M.decode_step(params, cfg, nxt, cache,
                                      args.prompt_len + t,
                                      decode_impl=decode_impl)
        nxt = logits.argmax(-1)[:, None]
        out.append(nxt)
        steps.append(logits)
    sync()
    t2 = time.perf_counter()
    out = torch.cat(out, dim=1)
    n_dec = args.batch * (args.new_tokens - 1)
    run = BatchRun(cfg, tokens, out, steps, cache, 1e3 * (t1 - t0),
                   n_dec / (t2 - t1) if n_dec else 0.0)
    print(f"arch={cfg.name} mesh 1x1 batch={args.batch} "
          f"prompt={args.prompt_len} -> {args.new_tokens} new tokens "
          f"in {t2 - t0:.1f}s ({args.batch * args.new_tokens / (t2 - t0):.1f}"
          f" tok/s)")
    print("first sequence:", out[0].tolist())
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"prefill: {run.prefill_ms:.2f} ms ({args.batch} x "
          f"{args.prompt_len} tokens, {where})")
    print(f"decode: {run.decode_tok_s:.1f} tokens/s ({n_dec} tokens, "
          f"decode_impl={decode_impl}, kv cache "
          f"{cfg.kv_cache_dtype or cfg.dtype}, {where})")
    return run


def build_fleet_runtime(args, *, slots_per_pool: int = 2, c_chunk: int = 16,
                        long_ctx: int = 512):
    """Plan K pools from the workload CDF and make the plan executable:
    one InferenceEngine per pool behind the C&R gateway, sharing one
    parameter set on ``args.device``. The plan's datacenter-token
    boundaries are scaled so the long pool's context is ``long_ctx``
    tokens. Returns (runtime, plan)."""
    w = get_workload(args.workload)
    plan = plan_k_pool(w, lam=args.lam, t_slo=0.5, k=args.fleet)
    print(f"plan: {plan.summary()}")
    for pp in plan.pools:
        print(f"  {pp.name}: c_max={pp.c_max} n_gpus={pp.n_gpus} "
              f"rho={pp.utilization:.3f} ttft_p99={pp.ttft_p99_s*1e3:.0f}ms")
    device = resolve_device(args.device)
    cfg = model_config(args)
    params = M.init_params(cfg, seed=0, device=device)
    scfg = ServingConfig(
        paged=args.paged or args.prefix_cache or args.preemption,
        prefix_cache=args.prefix_cache, decode_k=args.decode_k,
        spec_k=args.spec_k, preemption=args.preemption,
        max_queue_wait=args.max_queue_wait)
    rt = FleetRuntime.from_plan(cfg, params, plan,
                                slots_per_pool=slots_per_pool,
                                c_chunk=c_chunk,
                                ctx_scale=long_ctx / plan.pools[-1].c_max,
                                config=scfg)
    return rt, plan


def prompt(n_words: int, topic: str) -> str:
    return " ".join(f"{topic} fact {i}: fleets split by context length."
                    for i in range(n_words))


def fleet_requests(rt: FleetRuntime, new_tokens: int):
    """One prompt per pool band plus one borderline C&R candidate per
    boundary (rag category, 1.2x the boundary)."""
    bounds = rt.router.boundaries
    reqs, rid = [], 0
    for i, eng in enumerate(rt.engines.values()):
        lo = bounds[i - 1] if i else 0
        words = max(2, (lo + (bounds[i] if i < len(bounds) else eng.c_max))
                    // 2 // 8)
        reqs.append(GatewayRequest(rid, prompt(words, f"band{i}"),
                                   new_tokens))
        rid += 1
    for i, b in enumerate(bounds):
        reqs.append(GatewayRequest(
            rid, prompt(max(2, int(b * 1.2) // 8), f"borderline{i}"),
            new_tokens, category="rag"))
        rid += 1
    return reqs


def session_turns(rt: FleetRuntime):
    """The two turns of the demo agent session: turn 2 resubmits turn 1's
    prompt plus new text."""
    bounds = rt.router.boundaries
    b0 = bounds[0] if bounds else \
        next(iter(rt.engines.values())).c_max // 2   # K=1: no bounds
    base = prompt(max(2, b0 // 4 // 8), "session")
    return base, base + " follow-up resubmits history."


def serve_fleet(args, **build_kw):
    """Offline fleet demo: plan, route a mixed prompt batch, drain; with
    ``--prefix-cache``, then a two-turn session. Returns (runtime,
    {rid: GatewayResponse}, seconds)."""
    rt, plan = build_fleet_runtime(args, **build_kw)
    print(f"runtime pools: boundaries={rt.router.boundaries} "
          f"gammas={rt.router.gammas} "
          f"contexts={[e.c_max for e in rt.engines.values()]} "
          f"device={args.device}")
    reqs = fleet_requests(rt, args.new_tokens)
    t0 = time.perf_counter()
    for r in reqs:
        d = rt.submit(r)
        print(f"  req {r.rid}: {r.category:5s} -> {d.pool:6s}"
              f"{' [C&R]' if d.compressed else ''} "
              f"L_eff={d.l_total_effective}")
    results = rt.run(max_iters=20_000)
    if args.prefix_cache:
        # turn 2 goes in AFTER turn 1 completes: the gateway pins it to
        # turn 1's pool (session affinity), and that engine's prefix
        # cache skips the prefill of the shared full blocks
        rid = len(reqs)
        for i, text in enumerate(session_turns(rt)):
            d = rt.submit(GatewayRequest(rid, text, args.new_tokens,
                                         session="demo"))
            print(f"  req {rid}: turn{i + 1:2d} -> {d.pool:6s} "
                  f"L_eff={d.l_total_effective}")
            rid += 1
            results.update(rt.run(max_iters=20_000))
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    done = sum(len(res.output_tokens) for res in results.values())
    s = rt.router.stats
    print(f"served {len(results)} requests / {done} tokens in {dt:.1f}s; "
          f"gateway: borderline={s.borderline} "
          f"compressed={s.compressed_ok} pinned={s.affinity_pinned} "
          f"per_pool={s.per_pool}")
    disp = sum(e.dispatches for e in rt.engines.values())
    dtok = sum(e.decode_tokens_emitted for e in rt.engines.values())
    print(f"engine hot path: decode_k={args.decode_k} "
          f"{disp} dispatches / {dtok} decode tokens "
          f"({disp / max(1, dtok):.3f} dispatches/token)")
    if args.spec_k > 1:
        for name, eng in rt.engines.items():
            st = eng.spec_stats
            if st["verify_windows"]:
                print(f"  {name}: spec_k={args.spec_k} "
                      f"kappa={eng.spec_kappa():.2f} "
                      f"acceptance={eng.spec_acceptance_rate():.2f} "
                      f"({st['accepted_tokens']}/{st['proposed_tokens']} "
                      f"draft tokens over {st['verify_windows']} windows)")
    if args.prefix_cache:
        for name, eng in rt.engines.items():
            st = eng.prefix_stats
            if st["lookups"]:
                print(f"  {name}: prefix hits {st['hit_blocks']} blocks "
                      f"({st['hit_tokens']} tokens), "
                      f"{st['allocated_blocks']} allocated, "
                      f"{st['registered_blocks']} registered")
    if args.preemption or args.max_queue_wait is not None:
        for name, eng in rt.engines.items():
            snap = eng.utilization_snapshot(detail=True)
            print(f"  {name}: overload preempted={snap['preempted']} "
                  f"(swap={snap['swapped_out']} "
                  f"recompute={snap['recomputed']}) shed={snap['shed']} "
                  f"hol_bypass={snap['hol_bypass']} "
                  f"queue_wait_est={snap['queue_wait_est_iters']:.1f} it "
                  f"mu={snap['service_rate_per_iter']:.3f}/it")
    return rt, results, dt


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="minitron-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", default="",
                    help="device mesh DxM; one device only ('' or 1x1)")
    ap.add_argument("--batch", type=int, default=8,
                    help="batch launcher: prompts in the batch")
    ap.add_argument("--prompt-len", type=int, default=64,
                    help="batch launcher: tokens per prompt")
    ap.add_argument("--int8-kv", action="store_true",
                    help="batch launcher: int8 KV cache with per-token "
                         "scales")
    ap.add_argument("--fleet", type=int, default=0, metavar="K",
                    help="plan a K-pool fleet and serve through the "
                         "C&R gateway (K engines) instead of the batch "
                         "launcher")
    ap.add_argument("--workload", default="azure",
                    help="workload CDF for fleet planning")
    ap.add_argument("--lam", type=float, default=1000.0,
                    help="arrival rate (req/s) for fleet planning")
    ap.add_argument("--paged", action="store_true",
                    help="engines use the paged KV cache")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="paged engines share cached prompt prefixes "
                         "(implies --paged); adds a two-turn session")
    ap.add_argument("--decode-k", type=int, default=1, metavar="K",
                    help="decode iterations per dispatch (on-device "
                         "micro-loop)")
    ap.add_argument("--spec-k", type=int, default=1, metavar="W",
                    help="self-speculative verify window: 1 carried token "
                         "+ up to W-1 n-gram draft tokens per decode "
                         "iteration (1 = off)")
    ap.add_argument("--preemption", action="store_true",
                    help="overload survival: preempt (swap / recompute) "
                         "the newest decoding slot when paged admission "
                         "would defer (implies --paged)")
    ap.add_argument("--max-queue-wait", type=float, default=None,
                    metavar="ITERS",
                    help="shed arrivals whose estimated queue wait "
                         "exceeds this many iterations")
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    args = ap.parse_args(argv)
    if args.fleet < 0:
        ap.error("--fleet must be >= 0")
    return args


def main(argv=None):
    args = parse_args(argv)
    if args.fleet:
        serve_fleet(args)
    else:
        serve_batch(args)


if __name__ == "__main__":
    main()
