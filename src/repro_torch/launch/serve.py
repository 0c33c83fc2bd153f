"""Offline fleet serving on the GPU: plan a K-pool fleet with the
FleetOpt planner, build one gateway-routed engine per pool, route a
mixed prompt batch through the C&R gateway and drain it.

  # reduced model (f32), 2 pools, decode micro-loop of 4, paged KV
  PYTHONPATH=src python -m repro_torch.launch.serve --fleet 2 --reduced \\
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

The port of ``repro/launch/serve.py``'s ``--fleet`` mode. Runs on
``--device cuda`` (the default) and raises when no card is present;
``--device cpu`` runs the plain PyTorch versions of the kernels.
"""
import argparse
import dataclasses
import time

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
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="minitron-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--fleet", type=int, default=2, metavar="K",
                    help="plan a K-pool fleet and serve through the "
                         "C&R gateway")
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
    if args.fleet < 1:
        ap.error("--fleet must be >= 1")
    serve_fleet(args)


if __name__ == "__main__":
    main()
