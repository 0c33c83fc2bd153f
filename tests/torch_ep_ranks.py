"""The rank side of tests/test_torch_ep.py: every expert-parallel scenario,
run by each of the ranks ``launch_ranks`` spawns (gloo on the CPU, one
process a rank). Imports torch and the port only (no JAX), so a spawned
rank starts fast; the test module passes the JAX package's weights in as
numpy arrays. ``model_runs`` is also what the test runs at tp=1, so the
two sides call the same entry points on the same inputs."""
from __future__ import annotations

import dataclasses
import time
import traceback

import numpy as np
import torch

from repro_torch import params as P
from repro_torch.configs import base
from repro_torch.distributed import context as PC
from repro_torch.distributed import sharding as SH
from repro_torch.launch import serve as TS
from repro_torch.launch.mesh import make_smoke_mesh, parse_mesh
from repro_torch.models import model as TM
from repro_torch.models import moe as MOE

import torch_tp_ranks as R

ARCH = "llama4-scout-17b-a16e"
# the launcher finds the no-drop copy by name, in the ranks too
NO_DROP = base.register(dataclasses.replace(
    base.get_config(ARCH), name=f"{ARCH}-no-drop",
    moe=dataclasses.replace(base.get_config(ARCH).moe,
                            capacity_factor=8.0)))
MESHES = ("1x4", "2x2")
# (name, x key, mode): the block calls, each at both meshes
BLOCK_CALLS = (("a2a", "x", "a2a"), ("psum", "x", "psum"),
               ("odd", "x_odd", "a2a"), ("b1", "x_b1", "a2a"))
# the engine runs: (layout, decode_k); "ring" is the config's window of
# 64 (per-token chunks: the psum decode), "full" and "paged" window 0
ENGINE_CASES = (("ring", 1), ("ring", 4), ("full", 4), ("paged", 1),
                ("paged", 4))
WINDOW = 8                     # model_runs' ring: 12 + 4 positions wrap it
TABLES = np.array([[0, 1, 2], [3, 4, 5]], np.int32)


def block_rows(x, ctx):
    """This rank's rows of a (B, S, D) batch: its data slice where the
    data axes divide B, else all (``sharding.batch_specs``)."""
    spec = SH.batch_specs({"x": x}, ctx)["x"]
    return SH.shard_leaf(x, spec, ctx), spec[0] is not None


def block_calls(cfg, p_np, xs, ctx):
    """moe_block_sharded of every BLOCK_CALLS entry on this rank's shard:
    {name: (data rank or None, y, lb_loss, dropped)} as numpy, lb_loss
    the mean of the ranks' own (the reference's pmean)."""
    p = P.from_jax_numpy({"moe": p_np}, device="cpu", parallel=ctx)["moe"]
    out = {}
    for name, key, mode in BLOCK_CALLS:
        x, split = block_rows(torch.from_numpy(xs[key]), ctx)
        y, aux = MOE.moe_block_sharded(p, cfg, x, ctx, mode)
        out[name] = (ctx.data_rank if split else None, y.numpy(),
                     float(ctx.mean_all(aux["lb_loss"])),
                     aux["dropped"].numpy())
    return out


def _logits(t):
    return t.detach().numpy().copy()


def model_inputs():
    """The token ids of every ``model_runs`` call, from a seed."""
    rng = np.random.default_rng(7)
    shapes = dict(seq=(2, 16), decode=(3, 2, 1), chunk1=(3, 8),
                  chunk2=(3, 6), ring=(2, 12), ring_decode=(4, 2, 1),
                  paged=(2, 8), paged_decode=(2, 2, 1))
    return {k: rng.integers(1, 900, s) for k, s in shapes.items()}


def model_runs(params, cfg, parallel=None):
    """Every entry point on reduced scout (``cfg`` at window 0), each
    call's logits as numpy: forward; prefill and three decode steps on its
    cache; the fused chunk twice (8 columns: "a2a"; 6: not divisible by 4,
    the "psum" fallback) with an idle row; a ring of WINDOW rows, a
    12-token per-token chunk and four decode steps (it wraps); the paged
    chunk and two paged decode steps."""
    inp = {k: torch.from_numpy(v) for k, v in model_inputs().items()}
    kw = dict(parallel=parallel)
    out = {}
    t1 = inp["seq"]
    out["forward"] = _logits(TM.forward(params, cfg, {"tokens": t1},
                                        **kw)[0])
    last, cache = TM.prefill(params, cfg, {"tokens": t1, "cache_len": 24},
                             **kw)
    out["prefill"] = _logits(last)
    steps = []
    for j in range(3):
        lg, cache = TM.decode_step(params, cfg, inp["decode"][j], cache,
                                   16 + j,
                                   decode_impl="torch", **kw)
        steps.append(_logits(lg))
    out["decode"] = np.stack(steps)
    cache = TM.init_cache(cfg, 3, 32, device="cpu", parallel=parallel)
    chunks = []
    for toks, start, lengths in ((inp["chunk1"], [0, 0, 0], [8, 5, 0]),
                                 (inp["chunk2"], [8, 5, 0], [6, 6, 0])):
        lg, cache = TM.prefill_chunk(params, cfg, toks, cache,
                                     torch.tensor(start),
                                     torch.tensor(lengths), **kw)
        chunks.append(_logits(lg[:2]))
    out["chunk"] = np.stack(chunks)
    ring = dataclasses.replace(cfg, attention_window=WINDOW)
    cache = TM.init_cache(ring, 2, 32, device="cpu", parallel=parallel)
    lg, cache = TM.prefill_chunk(params, ring, inp["ring"], cache,
                                 torch.tensor([0, 0]), torch.tensor([12, 9]),
                                 decode_impl="torch", **kw)
    rows = [_logits(lg)]
    for j in range(4):
        lg, cache = TM.decode_step(params, ring, inp["ring_decode"][j],
                                   cache,
                                   torch.tensor([12 + j, 9 + j]),
                                   decode_impl="torch", **kw)
        rows.append(_logits(lg))
    out["ring"] = np.stack(rows)
    cache = TM.init_paged_cache(cfg, 8, 8, device="cpu", parallel=parallel)
    tables = torch.from_numpy(TABLES)
    lg, cache = TM.paged_prefill_chunk(params, cfg, inp["paged"], cache,
                                       tables,
                                       torch.tensor([0, 0]),
                                       torch.tensor([8, 6]), **kw)
    rows = [_logits(lg)]
    for j in range(2):
        lg, cache = TM.paged_decode_step(params, cfg,
                                         inp["paged_decode"][j], cache,
                                         tables, torch.tensor([8 + j, 6 + j]),
                                         decode_impl="torch", **kw)
        rows.append(_logits(lg))
    out["paged"] = np.stack(rows)
    return out


def forward_lb(params, cfg, ctx):
    """The forward's load-balance loss (each rank's own summed over the
    layers, then averaged over the ranks once) and the reference's form
    of it (each layer's loss averaged over the ranks, then summed)."""
    toks = {"tokens": torch.from_numpy(model_inputs()["seq"])}
    lb = float(TM.forward(params, cfg, toks, parallel=ctx)[1])
    block, layers = MOE.moe_block_sharded, []

    def meaned(p, cfg, x, par, mode="a2a"):
        y, aux = block(p, cfg, x, par, mode)
        layers.append(float(par.mean_all(aux["lb_loss"])))
        return y, aux
    MOE.moe_block_sharded = meaned
    try:
        TM.forward(params, cfg, toks, parallel=ctx)
    finally:
        MOE.moe_block_sharded = block
    return lb, layers


def engine_runs(cfg, params, reqs, **kw):
    """{(layout, decode_k): tokens by rid} of every ENGINE_CASES run
    (``cfg`` the config at its window of 64)."""
    res = {}
    for layout, k in ENGINE_CASES:
        lcfg = cfg if layout == "ring" else dataclasses.replace(
            cfg, attention_window=0)
        lkw = dict(paged=True, block_size=16) if layout == "paged" else {}
        res[(layout, k)] = R.run_engine(lcfg, params, reqs, decode_k=k,
                                        decode_impl="torch", **lkw, **kw)[0]
    return res


def run_scenarios(rank, device, inp):
    """Every scenario on this rank; a failing scenario's traceback is
    returned, so one fault does not hide the others."""
    out = {"seconds": {}}

    def scenario(name, fn):
        t0 = time.perf_counter()
        try:
            out[name] = fn()
        except Exception:          # noqa: BLE001 (reported to the test)
            out[name] = ("error", traceback.format_exc())
        out["seconds"][name] = round(time.perf_counter() - t0, 2)

    def collectives():
        res = {}
        for m in MESHES:
            ctx = PC.make_context(parse_mesh(m))
            t = torch.arange(ctx.tp * 3, dtype=torch.bfloat16).reshape(
                ctx.tp, 3) + 100 * rank
            res[m] = (ctx.all_to_all(t).float().numpy(),
                      float(ctx.mean_all(torch.tensor(float(rank) ** 2))),
                      ctx.model_rank, ctx.data_rank)
        return res
    scenario("collectives", collectives)

    def blocks():
        res = {}
        for m in MESHES:
            ctx = PC.make_context(parse_mesh(m))
            for arch, case in inp["block"].items():
                res[(m, arch)] = block_calls(case["cfg"], case["p"],
                                             case["x"], ctx)
        return res
    scenario("block", blocks)

    ctx = PC.make_context(make_smoke_mesh(4))
    cfg, jp = inp["cfg"], inp["jp"]
    shard = P.from_jax_numpy(jp, device="cpu", parallel=ctx)
    full = P.from_jax_numpy(jp, device="cpu")
    w0 = dataclasses.replace(cfg, attention_window=0)
    scenario("model", lambda: model_runs(shard, w0, ctx))
    scenario("forward_lb", lambda: forward_lb(shard, w0, ctx))
    scenario("engine", lambda: engine_runs(cfg, shard, inp["reqs"],
                                           mesh=ctx.mesh))

    def fleets():
        base_ = R.fleet(w0, full, inp["fleet"], mesh=ctx.mesh, tp_degree=4)
        moved = R.fleet(w0, full, inp["fleet"], event=dict(c_max=384),
                        mesh=ctx.mesh, tp_degree=4)
        return (base_[:3], moved[:3], moved[3].reprovision_stats["rebuilds"],
                moved[3].device_placement())
    scenario("fleet", fleets)

    def batch():
        res = {}
        for m in MESHES:
            args = TS.parse_args(inp["batch_argv"] + ["--mesh", m])
            run = TS.serve_batch(
                args, params=P.from_jax_numpy(inp["jp_launch"],
                                              device="cpu"),
                tokens=torch.as_tensor(inp["launch_tokens"]),
                parallel=PC.make_context(parse_mesh(m)), device=device,
                decode_impl="torch")
            res[m] = (run.data_rank, run.tokens.numpy(),
                      np.stack([t.numpy() for t in run.logits]))
        return res
    scenario("batch", batch)
    return out
