"""Serving on the GPU: the batch launcher (prefill a batch of prompts,
then greedy decode) and, with ``--fleet K``, offline fleet serving (plan
a K-pool fleet with the FleetOpt planner, build one gateway-routed
engine per pool, route a mixed prompt batch through the C&R gateway and
drain it), or, with ``--http`` / ``--smoke``, the same fleet behind the
asyncio HTTP/SSE gateway with the closed-loop re-planner.

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

  # the same fleet behind the asyncio HTTP gateway (OpenAI-style
  # /v1/completions with SSE streaming, /health, Prometheus /metrics,
  # the closed-loop re-planner on /admin/replan, a tick every 30 s, and
  # the autoscaler acting on its deltas)
  PYTHONPATH=src python -m repro_torch.launch.serve --fleet 2 --decode-k 4 \
      --http 8000 --replan-interval 30 --autoscale

  # smoke: ephemeral port, in-process client, exit nonzero on failure;
  # --chaos kills a pool mid-stream and checks the recovery
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --fleet 2 \
      --smoke --chaos --device cpu

  # tensor-parallel: the K=2 fleet over 4 ranks (tp=4), the same fleet
  # with each pool on a submesh of its own (tp=2: short on ranks 0-1,
  # long on 2-3), and the batch launcher over a 2x2 (data x model) mesh;
  # four processes on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --fleet 2 --tp 4 \
      --reduced --decode-k 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --fleet 2 --tp 2 \
      --mesh 1x4 --reduced --decode-k 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --mesh 2x2 --reduced \
      --batch 4 --prompt-len 16 --new-tokens 4 --device cpu

The port of ``repro/launch/serve.py``. Runs on ``--device cuda`` (the
default) and raises when no card is present; ``--device cpu`` runs the
plain PyTorch versions of the kernels. ``--mesh DxM`` (the batch
launcher's mesh, or the fleet's, carved into submeshes of ``--tp D``
ranks, pool i on submesh i % (D*M / tp)) and ``--tp D`` alone (the
fleet on D ranks) spawn one process per rank
(``distributed/context.launch_ranks``): every rank runs the same
launcher on its shard, and rank 0 alone prints. The ranks share one
card when there are fewer cards than ranks (a gloo group, the tensors
exchanged through card buffers the ranks share), and own one each
otherwise (NCCL).
"""
import argparse
import asyncio
import contextlib
import dataclasses
import functools
import io
import json
import re
import time
from typing import Any, Awaitable, Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import get_config
from repro_torch.core.planner import plan_k_pool
from repro_torch.core.workload import get_workload
from repro_torch.device import resolve_device
from repro_torch.distributed import context as PC
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import (make_smoke_mesh, make_submeshes,
                                     parse_mesh)
from repro_torch.models import model as M
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.pools import FleetRuntime, GatewayRequest
from repro_torch.serving.reconfigure import FaultInjector
from repro_torch.serving.replanner import Replanner
from repro_torch.serving.server import ServingGateway


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
    second (the device synchronised around each). A rank of a mesh holds
    its data slice of the rows (``data_rank``) and its cache shard."""
    cfg: Any
    prompt: torch.Tensor
    tokens: torch.Tensor
    logits: List[torch.Tensor]
    cache: Dict[str, Any]
    prefill_ms: float
    decode_tok_s: float
    data_rank: int = 0

    def to_cpu(self) -> "BatchRun":
        return dataclasses.replace(
            self, prompt=self.prompt.cpu(), tokens=self.tokens.cpu(),
            logits=[t.cpu() for t in self.logits],
            cache={k: ({n: a.cpu() for n, a in v.items()}
                       if isinstance(v, dict) else v.cpu())
                   for k, v in self.cache.items()})


def _world(args) -> int:
    """Ranks the flags ask for: D*M of ``--mesh DxM`` (the batch
    launcher, or a fleet's group), else ``--tp``."""
    if args.mesh not in ("", "1x1"):
        return parse_mesh(args.mesh).size
    return args.tp if args.fleet else 1


def _rank0_prints(fn):
    """``fn`` with its lines printed on rank 0 only (every rank of a
    process group runs the launcher; the others' lines go nowhere)."""
    @functools.wraps(fn)
    def run(*args, **kw):
        if PC.global_rank() == 0:
            return fn(*args, **kw)
        with contextlib.redirect_stdout(io.StringIO()):
            return fn(*args, **kw)
    return run


def _batch_rank(rank, device, args, params, tokens, decode_impl, frontend):
    """One rank of the batch launcher over ``--mesh``: its BatchRun (its
    data slice of the rows) on the CPU."""
    ctx = PC.make_context(parse_mesh(args.mesh))
    return serve_batch(args, params, tokens, decode_impl, frontend,
                       parallel=ctx, device=device).to_cpu()


def _gather_rows(runs: List[BatchRun]) -> BatchRun:
    """One BatchRun of every row from the ranks' runs: each data row's
    model-rank-0 run, in data order (the other ranks of a row hold the
    same rows); the cache is rank 0's shard."""
    rows = {}
    for r in runs:
        rows.setdefault(r.data_rank, r)
    parts = [rows[i] for i in sorted(rows)]
    return dataclasses.replace(
        runs[0], prompt=torch.cat([r.prompt for r in parts]),
        tokens=torch.cat([r.tokens for r in parts]),
        logits=[torch.cat(ls) for ls in zip(*(r.logits for r in parts))])


@_rank0_prints
def serve_batch(args, params=None, tokens=None,
                decode_impl: str = "kernel", frontend=None,
                parallel=None, device=None) -> BatchRun:
    """The batch launcher: prefill ``--batch`` prompts of
    ``--prompt-len`` tokens into a cache of prompt + ``--new-tokens``,
    then ``new_tokens - 1`` greedy decode steps at the uniform position
    ``prompt_len + t``. A model with a frontend (VLM) gets ``frontend``,
    (B, F, d_model), or the reference launcher's stub, ``ones((B,
    frontend_tokens, d_model)) * 0.01`` in the model dtype. ``params`` /
    ``tokens`` default to ``init_params(seed=0)`` and prompt ids drawn
    from a generator seeded with 0 on the device; a caller may pass its
    own (the tests pass the JAX launcher's). ``decode_impl``: decode
    attention through the CUDA kernel (its plain version on the CPU) or
    the torch ``_sdpa`` path, which a caller may ask for to hold the
    kernel against it.

    ``--mesh DxM`` other than 1x1: every rank of the (data, model) mesh
    runs this on its data slice of the batch (``batch_specs``: the rows
    split over the data axis where they divide) and its model-axis shard
    of the weights (``params``: a full tree, cut per rank, or None:
    ``init_params(parallel=)``), with ``parallel`` its context and
    ``device`` its device. Called without ``parallel``, it spawns the
    D*M ranks itself and returns every row's tokens and logits
    (:func:`_gather_rows`)."""
    mesh = parse_mesh(args.mesh)
    cfg = model_config(args)
    if mesh.size > 1 and parallel is None:
        _check_ranks(args, cfg)
        runs = PC.launch_ranks(_batch_rank, mesh.size,
                               (args, params, tokens, decode_impl, frontend),
                               device=args.device, quiet=True)
        return _gather_rows(runs)
    device = device or resolve_device(args.device)
    par = parallel if parallel is not None and mesh.size > 1 else None
    if params is None:
        params = (M.init_params(cfg, seed=0, device=device, parallel=par)
                  if par is not None
                  else M.init_params(cfg, seed=0, device=device))
    elif par is not None:
        params = _to_device(SH.rank_shard(params, par, cfg.vocab_size),
                            device)
    if tokens is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        tokens = torch.randint(1, cfg.vocab_size,
                               (args.batch, args.prompt_len), generator=gen,
                               device=device)
    tokens = tokens.to(device)
    if cfg.frontend_tokens and frontend is None:
        frontend = torch.ones((args.batch, cfg.frontend_tokens, cfg.d_model),
                              dtype=params["embed"].dtype,
                              device=device) * 0.01
    data_rank = 0
    if par is not None:
        # the rows of this rank's data slice (all of them where the data
        # axis does not divide the batch, as batch_specs rules)
        spec = SH.batch_specs({"tokens": tokens}, par)["tokens"]
        tokens = SH.shard_leaf(tokens, spec, par)
        if frontend is not None:
            frontend = SH.shard_leaf(frontend.to(device), spec, par)
        data_rank = par.data_rank if spec[0] is not None else 0
    batch = {"tokens": tokens, "cache_len": args.prompt_len + args.new_tokens}
    if frontend is not None:
        batch["frontend"] = frontend
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else lambda: None)
    sync()
    t0 = time.perf_counter()
    logits, cache = M.prefill(params, cfg, batch, parallel=par)
    nxt = logits.argmax(-1)[:, None]
    sync()
    t1 = time.perf_counter()
    out, steps = [nxt], [logits]
    for t in range(args.new_tokens - 1):
        logits, cache = M.decode_step(params, cfg, nxt, cache,
                                      args.prompt_len + t,
                                      decode_impl=decode_impl, parallel=par)
        nxt = logits.argmax(-1)[:, None]
        out.append(nxt)
        steps.append(logits)
    sync()
    t2 = time.perf_counter()
    out = torch.cat(out, dim=1)
    n_dec = args.batch * (args.new_tokens - 1)
    run = BatchRun(cfg, tokens, out, steps, cache, 1e3 * (t1 - t0),
                   n_dec / (t2 - t1) if n_dec else 0.0, data_rank)
    dims = "x".join(str(n) for n in mesh.devices.shape)
    print(f"arch={cfg.name} mesh {dims} batch={args.batch} "
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


def _to_device(tree, device):
    return {k: (_to_device(v, device) if isinstance(v, dict)
                else v.to(device)) for k, v in tree.items()}


def _check_ranks(args, cfg) -> None:
    """Refuse, before any rank is spawned, what the ranks would refuse:
    a family or width the model axis cannot split, a fleet's tp that does
    not divide its mesh, ``--http`` / ``--smoke`` at tp > 1."""
    world = _world(args)
    tp = parse_mesh(args.mesh).shape["model"] if not args.fleet else args.tp
    if world % tp:
        raise ValueError(f"--tp {tp} does not divide the {world} ranks of "
                         f"--mesh {args.mesh}")
    mesh = make_smoke_mesh(tp, world=world)
    ctx = PC.ParallelContext(mesh=mesh)
    M.check_supported(cfg, parallel=ctx)
    if args.fleet and (args.http is not None or args.smoke) and tp > 1:
        raise PC.later(f"--http / --smoke with --tp {tp}", PC.SLICE_HTTP)


def build_fleet_runtime(args, *, slots_per_pool: int = 2, c_chunk: int = 16,
                        long_ctx: int = 512, params=None, device=None):
    """Plan K pools from the workload CDF and make the plan executable:
    one InferenceEngine per pool behind the C&R gateway, sharing one
    parameter set on ``args.device`` (``params``, else
    ``init_params(seed=0)``). The plan's datacenter-token boundaries are
    scaled so the long pool's context is ``long_ctx`` tokens. Returns
    (runtime, plan). Under ``--tp D`` (in a rank of the group ``--mesh``
    or ``--tp`` spawned) pool i runs over the mesh's submesh i % (ranks /
    D) of D ranks, on this rank's ``device`` and its shard of the weights
    for its submesh (a full ``params`` is cut per rank; None draws the
    rank's shard, ``init_params(parallel=)``)."""
    w = get_workload(args.workload)
    plan = plan_k_pool(w, lam=args.lam, t_slo=0.5, k=args.fleet)
    print(f"plan: {plan.summary()}")
    for pp in plan.pools:
        print(f"  {pp.name}: c_max={pp.c_max} n_gpus={pp.n_gpus} "
              f"rho={pp.utilization:.3f} ttft_p99={pp.ttft_p99_s*1e3:.0f}ms")
    device = device or resolve_device(args.device)
    cfg = model_config(args)
    mesh, par = None, None
    if _world(args) > 1:
        mesh = (parse_mesh(args.mesh) if args.mesh not in ("", "1x1")
                else make_smoke_mesh(args.tp, world=_world(args)))
        # every rank makes every submesh's context, in order; this rank's
        # own is the one it is a member of
        subs = [PC.make_context(m) for m in make_submeshes(mesh, args.tp)]
        par = next(c for c in subs if c.member)
    if params is None:
        params = (M.init_params(cfg, seed=0, device=device, parallel=par)
                  if par is not None
                  else M.init_params(cfg, seed=0, device=device))
    elif par is not None:
        params = _to_device(SH.rank_shard(params, par, cfg.vocab_size),
                            device)
    scfg = ServingConfig(
        paged=args.paged or args.prefix_cache or args.preemption,
        prefix_cache=args.prefix_cache, decode_k=args.decode_k,
        spec_k=args.spec_k, preemption=args.preemption,
        max_queue_wait=args.max_queue_wait, autoscale=args.autoscale,
        mesh=mesh, tp_degree=args.tp)
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


def _fleet_rank(rank, device, args, build_kw):
    """One rank of ``--fleet K --tp D``: (None, rank 0's responses, its
    seconds); the runtime stays in its process."""
    _, results, dt = serve_fleet(args, device=device, **build_kw)
    return None, results, dt


@_rank0_prints
def serve_fleet(args, **build_kw):
    """Offline fleet demo: plan, route a mixed prompt batch, drain; with
    ``--prefix-cache``, then a two-turn session. Returns (runtime,
    {rid: GatewayResponse}, seconds). ``--tp D`` outside a process group
    spawns the D ranks (each runs this, rank 0 prints) and returns
    (None, responses, seconds) of rank 0."""
    if _world(args) > 1 and PC.world_size() == 1:
        _check_ranks(args, model_config(args))
        return PC.launch_ranks(_fleet_rank, _world(args), (args, build_kw),
                               device=args.device)[0]
    rt, plan = build_fleet_runtime(args, **build_kw)
    print(f"runtime pools: boundaries={rt.router.boundaries} "
          f"gammas={rt.router.gammas} "
          f"contexts={[e.c_max for e in rt.engines.values()]} "
          f"device={args.device}")
    for name, ranks in rt.device_placement().items():
        print(f"  {name}: tp={rt.tp_degree} devices={ranks}")
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
    if rt.device.type == "cuda":
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


async def _http_call(host, port, method, path, body=None):
    """Minimal raw HTTP/1.1 client (stdlib only) for the in-process
    smoke: returns (status, header dict, body bytes). The gateway
    always closes the connection, so read-to-EOF is the framing."""
    reader, writer = await asyncio.open_connection(host, port)
    payload = body if body is not None else b""
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: smoke\r\n"
                 f"Content-Length: {len(payload)}\r\n\r\n"
                 .encode() + payload)
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(), timeout=120.0)
    writer.close()
    head, _, rest = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    status = int(lines[0].split()[1])
    headers = {}
    for ln in lines[1:]:
        if ":" in ln:
            k, v = ln.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    return status, headers, rest


def _parse_sse(body: bytes):
    """data: events -> (list of JSON chunks, saw [DONE])."""
    chunks, done = [], False
    for ev in body.split(b"\n\n"):
        if not ev.startswith(b"data: "):
            continue
        if ev == b"data: [DONE]":
            done = True
        else:
            chunks.append(json.loads(ev[6:]))
    return chunks, done


async def _smoke_client(gw) -> None:
    """Exercise every endpoint against a live gateway and assert: >1 SSE
    flush, streamed == offline token ids, parsable Prometheus text with
    per-pool series, a forced re-plan tick that moves the live boundary
    on short-shifted traffic, structured 4xx."""
    host, port = gw.host, gw.port
    prompt = "smoke fleet serving demo " * 6

    status, _, body = await _http_call(host, port, "GET", "/health")
    h = json.loads(body)
    assert status == 200 and h["status"] == "ok", (status, h)
    print(f"smoke /health ok: pools={list(h['pools'])} "
          f"boundaries={h['boundaries']}")

    req = json.dumps({"prompt": prompt, "max_tokens": 12,
                      "stream": True}).encode()
    status, headers, body = await _http_call(host, port, "POST",
                                             "/v1/completions", req)
    assert status == 200, body[:200]
    assert headers.get("content-type") == "text/event-stream", headers
    chunks, done = _parse_sse(body)
    token_chunks = [c for c in chunks
                    if c["choices"][0]["finish_reason"] is None]
    streamed = [t for c in token_chunks
                for t in c["choices"][0]["token_ids"]]
    assert done and len(token_chunks) > 1, \
        f"want >1 flush + [DONE], got {len(token_chunks)} flushes"
    assert chunks[-1]["choices"][0]["finish_reason"] == "length"
    print(f"smoke SSE ok: {len(token_chunks)} flushes / "
          f"{len(streamed)} tokens from pool "
          f"{chunks[-1]['fleetopt']['pool']}")

    # same prompt through the non-streaming path: decode is
    # deterministic argmax, so the ids must match bitwise
    req = json.dumps({"prompt": prompt, "max_tokens": 12}).encode()
    status, _, body = await _http_call(host, port, "POST",
                                       "/v1/completions", req)
    offline = json.loads(body)["choices"][0]["token_ids"]
    assert status == 200 and offline == streamed, (streamed, offline)
    print("smoke parity ok: streamed ids == offline drain ids")

    status, _, body = await _http_call(host, port, "POST",
                                       "/v1/completions", b"{not json")
    err = json.loads(body)
    assert status == 400 and err["error"]["type"] \
        == "invalid_request_error", (status, err)

    # a short-prompt burst so the re-planner's window is clearly
    # short-shifted relative to the provisioned boundaries
    for i in range(6):
        req = json.dumps({"prompt": f"short {i} " * 3,
                          "max_tokens": 8}).encode()
        status, _, _ = await _http_call(host, port, "POST",
                                        "/v1/completions", req)
        assert status == 200
    b_before = list(gw.runtime.router.boundaries)
    status, _, body = await _http_call(host, port, "POST",
                                       "/admin/replan")
    rep = json.loads(body)
    assert status == 200 and rep["tick"] >= 1, rep
    assert rep["applied"], f"re-plan did not move boundaries: {rep}"
    b_after = list(gw.runtime.router.boundaries)
    assert b_after == rep["boundaries_after"]
    assert all(a <= b for a, b in zip(b_after, b_before)), \
        (b_before, b_after)
    print(f"smoke re-plan ok: boundaries {b_before} -> {b_after} "
          f"(reason: {rep['reason']})")

    status, _, body = await _http_call(host, port, "GET", "/metrics")
    text = body.decode()
    assert status == 200
    for line in text.splitlines():
        if line and not line.startswith("#"):
            assert METRIC_SAMPLE.match(line), f"bad metric line: {line!r}"
    for needle in ('fleetopt_dispatches_total{pool="short"}',
                   'fleetopt_boundary_tokens{index="0"}',
                   "fleetopt_replan_applied_total",
                   "fleetopt_stream_flushes_total"):
        assert needle in text, f"missing metric {needle}"
    gauge = float([ln for ln in text.splitlines()
                   if ln.startswith('fleetopt_boundary_tokens{index="0"}')
                   ][0].split()[-1])
    assert int(gauge) == b_after[0], (gauge, b_after)
    print("smoke /metrics ok: Prometheus text parses, boundary gauge "
          "tracks the applied re-plan")


# one Prometheus sample line: name, optional labels, a number
METRIC_SAMPLE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? -?[0-9eE+.in-]+$')


async def _chaos_client(gw) -> None:
    """Fault-injection smoke: kill an engine mid-stream and assert the
    live stream completes with tokens bitwise identical to an unfaulted
    run (crash recovery migrates the checkpointed request one pool up,
    SSE cursor intact), the dead pool 503s with Retry-After during its
    blackout, and a post-blackout retry serves the same tokens again."""
    host, port = gw.host, gw.port
    prompt = "chaos smoke fleet serving " * 4
    max_tokens = 32

    # unfaulted reference: which pool serves this prompt + its tokens
    req = json.dumps({"prompt": prompt,
                      "max_tokens": max_tokens}).encode()
    status, _, body = await _http_call(host, port, "POST",
                                       "/v1/completions", req)
    ref = json.loads(body)
    assert status == 200, body[:200]
    ref_ids = ref["choices"][0]["token_ids"]
    victim = ref["fleetopt"]["pool"]

    # live stream on the victim pool, killed after its first flush
    sreq = json.dumps({"prompt": prompt, "max_tokens": max_tokens,
                       "stream": True}).encode()
    stream_task = asyncio.ensure_future(
        _http_call(host, port, "POST", "/v1/completions", sreq))
    tok0, done0 = gw.tokens_streamed, gw.completions_done
    for _ in range(20_000):
        if gw.tokens_streamed > tok0:
            break
        await asyncio.sleep(0.001)
    assert gw.tokens_streamed > tok0, "stream never flushed"
    assert gw.completions_done == done0, "stream finished before kill"
    async with gw._lock:
        FaultInjector(gw.runtime).kill(victim)
    print(f"chaos: killed pool {victim!r} mid-stream")

    # the drive loop hits EngineDead on its next step and recovers inline;
    # probe the blackout 503 as soon as the restart counter ticks
    for _ in range(20_000):
        if gw.runtime.reprovision_stats["engine_restarts"] >= 1:
            break
        await asyncio.sleep(0.001)
    assert gw.runtime.reprovision_stats["engine_restarts"] >= 1, \
        "the drive loop never recovered the killed engine"
    status, headers, body = await _http_call(host, port, "POST",
                                             "/v1/completions", req)
    assert status == 503, (status, body[:200])
    retry_after = int(headers["retry-after"])
    assert retry_after >= 1, headers
    err = json.loads(body)["error"]
    assert err["type"] == "overloaded_error", err
    print(f"chaos: blackout 503 ok (Retry-After: {retry_after}s)")

    # the killed stream must still deliver EVERY token, bitwise
    status, _, body = await stream_task
    assert status == 200, body[:200]
    chunks, done = _parse_sse(body)
    streamed = [t for c in chunks
                if c["choices"][0]["finish_reason"] is None
                for t in c["choices"][0]["token_ids"]]
    assert done and streamed == ref_ids, (streamed, ref_ids)
    final = [c for c in chunks
             if c["choices"][0]["finish_reason"] is not None][-1]
    print(f"chaos: killed stream completed bitwise on pool "
          f"{final['fleetopt']['pool']!r} ({len(streamed)} tokens)")

    # after the blackout the pool serves again — same tokens
    await asyncio.sleep(retry_after)
    status, _, body = await _http_call(host, port, "POST",
                                       "/v1/completions", req)
    assert status == 200, (status, body[:200])
    retry_ids = json.loads(body)["choices"][0]["token_ids"]
    assert retry_ids == ref_ids, (retry_ids, ref_ids)
    print("chaos: post-blackout retry ok (tokens bitwise identical)")

    status, _, body = await _http_call(host, port, "GET", "/metrics")
    text = body.decode()
    for needle in ("fleetopt_engine_restarts_total",
                   "fleetopt_migrated_requests_total"):
        line = [ln for ln in text.splitlines()
                if ln.startswith(needle)][0]
        assert float(line.split()[-1]) >= 1, line
    print("chaos: /metrics ok (restart + migration counters visible)")


async def run_client(gw: ServingGateway,
                     client: Callable[[ServingGateway], Awaitable[Any]]):
    """Start ``gw``, run ``client(gw)`` against it and stop it; returns
    what the client returns. An error that stops the gateway's drive
    loop (a kernel that fails to build or launch) is raised here, never
    waited out."""
    await gw.start()
    print(f"smoke gateway on {gw.host}:{gw.port}")
    try:
        task = asyncio.ensure_future(client(gw))
        drive = gw._tasks[0]
        await asyncio.wait({task, drive},
                           return_when=asyncio.FIRST_COMPLETED)
        if not task.done():
            task.cancel()
            drive.result()
            raise RuntimeError("the gateway's drive loop stopped")
        return task.result()
    finally:
        try:
            # bounded: after the drive loop died, a handler still waiting on
            # its request holds the server's wait_closed until the
            # request times out
            await asyncio.wait_for(gw.stop(), timeout=5.0)
        except asyncio.TimeoutError:
            pass


def serve_http(args, client: Optional[Callable] = None, **build_kw):
    """Run the asyncio gateway over a planned fleet (``build_kw`` as for
    :func:`build_fleet_runtime`): ``--http PORT`` serves until killed;
    ``--smoke`` binds an ephemeral port, runs the in-process client
    against it and exits nonzero on any failure (``--chaos`` adds the
    fault-injection pass). ``client(gateway)``, a coroutine function,
    replaces the smoke client; its result is returned."""
    rt, _ = build_fleet_runtime(args, **build_kw)
    print(f"runtime pools: boundaries={rt.router.boundaries} "
          f"gammas={rt.router.gammas} "
          f"contexts={[e.c_max for e in rt.engines.values()]} "
          f"device={args.device}")
    rp = Replanner(rt, min_observed=4, n_samples=2048)
    # chaos needs a blackout window long enough for the in-process
    # client to observe the 503 between recovery and its probe
    gw = ServingGateway(rt, replanner=rp, port=0 if args.smoke
                        else args.http,
                        replan_interval_s=args.replan_interval,
                        blackout_s=3.0 if args.chaos else 0.25)

    async def smoke(gw):
        await _smoke_client(gw)
        if args.chaos:
            await _chaos_client(gw)

    async def forever():
        await gw.start()
        print(f"gateway listening on http://{gw.host}:{gw.port} "
              f"(POST /v1/completions, GET /health, GET /metrics, "
              f"POST /admin/replan)")
        assert gw._server is not None
        async with gw._server:
            await gw._server.serve_forever()

    if client is None and not args.smoke:
        try:
            asyncio.run(forever())
        except KeyboardInterrupt:
            pass
        return None
    t0 = time.perf_counter()
    out = asyncio.run(run_client(gw, client or smoke))
    print(f"serve smoke passed in {time.perf_counter() - t0:.1f}s")
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="minitron-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", default="",
                    help="rank mesh DxM (data x model): the batch launcher "
                         "spawns D*M ranks, splits the batch over the data "
                         "axis and the weights over the model axis")
    ap.add_argument("--tp", type=int, default=1,
                    help="fleet: tensor-parallel degree of every pool's "
                         "engine (spawns tp ranks, one rank group)")
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
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serve the --fleet runtime over the asyncio HTTP "
                         "gateway (OpenAI-style /v1/completions with SSE "
                         "streaming, /health, Prometheus /metrics, "
                         "/admin/replan) instead of the offline batch")
    ap.add_argument("--smoke", action="store_true",
                    help="with --fleet: bind an ephemeral port, run the "
                         "in-process smoke client against every endpoint "
                         "(streaming parity, metrics parse, forced "
                         "re-plan) and exit nonzero on failure")
    ap.add_argument("--chaos", action="store_true",
                    help="with --smoke: also kill one engine mid-stream "
                         "and check that the stream completes after crash "
                         "recovery, the dead pool answers 503 with "
                         "Retry-After during its blackout, and a retry "
                         "after it matches")
    ap.add_argument("--autoscale", action="store_true",
                    help="the re-planner rebuilds a pool live (zero-drop "
                         "migration) when a tick's context or GPU-count "
                         "delta exceeds its hysteresis")
    ap.add_argument("--replan-interval", type=float, default=None,
                    metavar="SECONDS",
                    help="run a re-planner tick every S seconds (--http; "
                         "POST /admin/replan always works)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    args = ap.parse_args(argv)
    if args.fleet < 0:
        ap.error("--fleet must be >= 0")
    if args.tp < 1:
        ap.error("--tp must be >= 1")
    return args


def main(argv=None):
    args = parse_args(argv)
    if args.fleet and (args.http is not None or args.smoke):
        if _world(args) > 1:
            _check_ranks(args, model_config(args))
        serve_http(args)
    elif args.fleet:
        serve_fleet(args)
    else:
        serve_batch(args)


if __name__ == "__main__":
    main()
