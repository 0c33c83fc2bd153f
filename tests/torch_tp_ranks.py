"""The rank side of tests/test_torch_tp.py: every tensor-parallel scenario,
run by each of the ranks ``launch_ranks`` spawns (gloo on the CPU, one
process a rank). Imports torch and the port only (no JAX), so a spawned
rank starts fast; the test module passes the JAX package's weights in as
numpy arrays. Each scenario's result is plain Python / numpy, so the test
compares rank 0's with rank 3's and with the references it computed in
its own process."""
from __future__ import annotations

import contextlib
import io
import time
import traceback

import torch

from repro_torch import params as P
from repro_torch.distributed import context as PC
from repro_torch.launch import serve as TS
from repro_torch.launch.mesh import make_smoke_mesh, parse_mesh
from repro_torch.models import model as TM
from repro_torch.serving.engine import InferenceEngine, ServeRequest
from repro_torch.serving.pools import FleetRuntime, GatewayRequest

EOS = 7
ENGINE = dict(n_max=3, c_max=128, c_chunk=16, eos_id=EOS)
# (decode_impl, paged, decode_k) of the engine runs: the torch path at
# decode_k 1 and 4, the kernel at 4, dense and paged
ENGINE_CASES = [(impl, paged, k) for impl, ks in (("torch", (1, 4)),
                                                  ("kernel", (4,)))
                for paged in (False, True) for k in ks]


def run_engine(cfg, params, reqs, **kw):
    """Tokens by rid of ``reqs`` through one engine, and the engine."""
    eng = InferenceEngine(cfg, params, **ENGINE, **kw)
    for r in reqs:
        eng.submit(ServeRequest(**r))
    res = eng.run_to_completion(5000)
    return {rid: r.output_tokens for rid, r in sorted(res.items())}, eng


def prefix_warm(cfg, params, prompt, **kw):
    """Two turns of one prompt on a paged prefix-cache engine: the second
    admits warm. (tokens by rid, hit blocks)."""
    eng = InferenceEngine(cfg, params, n_max=3, c_max=128, c_chunk=16,
                          eos_id=EOS, paged=True, block_size=16,
                          prefix_cache=True, decode_k=4, **kw)
    eng.submit(ServeRequest(rid=0, tokens=prompt, max_new_tokens=6))
    eng.run_to_completion(5000)
    eng.submit(ServeRequest(rid=1, tokens=prompt, max_new_tokens=6))
    res = eng.run_to_completion(5000)
    return ({rid: r.output_tokens for rid, r in sorted(res.items())},
            eng.prefix_stats["hit_blocks"])


def fleet(cfg, params, requests, event=None, **kw):
    """The K=2 fleet on one rank group (``kw``: its mesh and tp), through
    the C&R gateway; ``event`` reprovisions the long pool mid-flight.
    (decisions, {rid: (pool, compressed, tokens)}, scorer calls)."""
    rt = FleetRuntime(cfg, params, (64,), (1.5,), (2, 2), (64, 256),
                      c_chunk=16, decode_k=4, paged=True, block_size=16,
                      **kw)
    calls = []
    score = rt.router.compressor._textrank

    def counted(sim):
        calls.append(sim.shape[0])
        return score(sim)
    rt.router.compressor._textrank = counted
    decisions = []
    for rid, text, n, cat in requests:
        d = rt.submit(GatewayRequest(rid, text, n, category=cat))
        decisions.append((d.pool, d.compressed, d.l_total_effective))
    out = {}
    if event is not None:
        for _ in range(3):
            for eng in list(rt.engines.values()):
                if eng.busy():
                    eng.step()
        assert rt.engines["long"].busy()
        info = rt.reprovision("long", **event)
        assert info["migrated"] > 0
    out.update({rid: (r.pool, r.compressed, r.output_tokens)
                for rid, r in rt.run(max_iters=2000).items()})
    return decisions, out, len(calls), rt


def _lines(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn()
    return buf.getvalue().splitlines(), result


def run_scenarios(rank, device, inp):
    """Every scenario on this rank; a failing scenario's traceback is
    returned, so one fault does not hide the others."""
    out = {}
    ctx = PC.make_context(make_smoke_mesh(4))
    cfg, jp = inp["cfg"], inp["jp"]
    shard = P.from_jax_numpy(jp, device="cpu", parallel=ctx)
    full = P.from_jax_numpy(jp, device="cpu")
    mesh = dict(mesh=ctx.mesh)

    out["seconds"] = {}

    def scenario(name, fn):
        t0 = time.perf_counter()
        try:
            out[name] = fn()
        except Exception:          # noqa: BLE001 (reported to the test)
            out[name] = ("error", traceback.format_exc())
        out["seconds"][name] = round(time.perf_counter() - t0, 2)

    def engines():
        res = {}
        for impl, paged, k in ENGINE_CASES:
            kw = dict(decode_impl=impl, paged=paged, decode_k=k, **mesh)
            if paged:
                kw["block_size"] = 16
            toks, eng = run_engine(cfg, shard, inp["reqs"], **kw)
            res[(impl, paged, k)] = (toks, eng.pallas_fallback,
                                     eng.decode_impl, eng.tp_degree,
                                     eng.devices(),
                                     eng.cache_bytes_per_device())
        return res
    scenario("engine", engines)
    scenario("prefix", lambda: prefix_warm(cfg, full, inp["prompt"], **mesh))
    scenario("spec", lambda: run_engine(cfg, shard, inp["reqs"], spec_k=4,
                                        decode_k=2, **mesh)[0])

    def fleets():
        base = fleet(cfg, full, inp["fleet"], mesh=ctx.mesh, tp_degree=4)
        moved = fleet(cfg, full, inp["fleet"], event=dict(c_max=384),
                      mesh=ctx.mesh, tp_degree=4)
        rt = moved[3]
        rebuilds, place = (rt.reprovision_stats["rebuilds"],
                           rt.device_placement())
        rt.reprovision("long", tp=2)
        return (base[:3], moved[:3], rebuilds, place,
                (rt.engines["long"].devices(), rt.device_placement()))
    scenario("fleet", fleets)

    def launcher_fleet():
        args = TS.parse_args(inp["fleet_argv"] + ["--tp", "4"])
        lines, (_, res, _) = _lines(lambda: TS.serve_fleet(args,
                                                           device=device))
        return lines, {rid: r.output_tokens for rid, r in res.items()}
    scenario("serve_fleet", launcher_fleet)

    def batch():
        res = {}
        for m in ("1x4", "2x2"):
            args = TS.parse_args(inp["batch_argv"] + ["--mesh", m])
            bctx = PC.make_context(parse_mesh(m))
            lines, run = _lines(lambda: TS.serve_batch(
                args, params=P.from_jax_numpy(inp["jp_launch"],
                                              device="cpu"),
                tokens=torch.as_tensor(inp["launch_tokens"]),
                parallel=bctx, device=device))
            res[m] = (lines, run.data_rank, run.tokens.numpy())
        return res
    scenario("batch", batch)

    def logits():
        toks = torch.as_tensor(inp["fwd_tokens"])
        lg, _ = TM.forward(shard, cfg, {"tokens": toks}, parallel=ctx)
        last, _ = TM.prefill(shard, cfg, {"tokens": toks}, parallel=ctx)
        return lg.numpy(), last.numpy()
    scenario("logits", logits)
    return out


def raise_on_rank_one(rank, device):
    """Rank 1 raises while the others wait in a collective."""
    ctx = PC.make_context(make_smoke_mesh(4))
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    ctx.all_reduce_sum(torch.ones(3))
    return rank
