"""The rank side of tests/test_torch_submesh.py: the K-pool fleet with its
pools on disjoint tensor-parallel submeshes of a 1x4 mesh, run by each of
the four ranks ``launch_ranks`` spawns (gloo on the CPU, one process a
rank). Imports torch and the port only (no JAX); the test module passes
the JAX package's weights in as numpy arrays. Each scenario's result is
plain Python / numpy, so the test compares every rank's with the others'
and with the references it computed in its own process."""
from __future__ import annotations

import contextlib
import io
import pickle
import time
import traceback
import zlib

import torch

from repro_torch import params as P
from repro_torch.distributed import context as PC
from repro_torch.distributed import sharding as SH
from repro_torch.launch import serve as TS
from repro_torch.launch.mesh import parse_mesh
from repro_torch.serving import reconfigure as RC
from repro_torch.serving.engine import EngineDead
from repro_torch.serving.pools import FleetRuntime, GatewayRequest
from repro_torch.training import tree

MESH = "1x4"
# K -> (boundaries, contexts); gammas 1.5, two slots a pool
FLEETS = {2: ((64,), (64, 256)), 3: ((64, 128), (64, 128, 256))}
PLACEMENT_TP = (1, 2, 4)
REPROVISION_TP = (1, 4, 2)          # the K=2 tp=2 fleet's long pool, in turn
# (tp of the fleet, the long pool's new tp) of the mid-flight moves
MOVES = ((2, 1), (2, 4), (4, 2))
# (decode_impl, paged) of the token runs
TOKEN_CASES = (("torch", False), ("torch", True), ("kernel", True))


def fleet(cfg, params, k=2, **kw):
    bounds, ctx = FLEETS[k]
    return FleetRuntime(cfg, params, bounds, (1.5,) * len(bounds),
                        (2,) * k, ctx, c_chunk=16, block_size=16, **kw)


def host_state(eng) -> int:
    """crc32 of an engine's host state: the scheduler, the host KV tier
    (rows left out: a rank outside the mesh holds none), the allocator,
    the prefix cache and the counters; equal on every rank after every
    step when every rank takes the same host decisions."""
    pre = sorted((rid, st.pos, st.last_tok, st.replay, st.out, st.n_blocks,
                  st.host_kv is None) for rid, st in eng._preempted.items())
    state = [eng.iteration, [r and r.rid for r in eng.slot_req],
             eng.slot_pos.tolist(), eng.slot_out, eng.slot_prefill_left,
             eng.slot_last_tok.tolist(), [r.rid for r in eng.waiting], pre,
             sorted((rid, r.output_tokens) for rid, r in eng.results.items()),
             eng.overload_stats, eng.dispatches, eng._queue_iters,
             eng._prefill_iters]
    if eng.paged:
        state += [eng._free, eng._reserved, eng.block_tables.tolist(),
                  eng._ref.tolist(), sorted(eng._prefix_map.items()),
                  list(eng._cached_free), eng._slot_blocks,
                  eng.prefix_stats]
    return zlib.crc32(pickle.dumps(state))


def drive(rt, digests, max_rounds=2000):
    """Step every busy engine round robin until the fleet drains, one
    host-state crc an engine step into ``digests``. Returns {rid: tokens}
    of the drained fleet."""
    for _ in range(max_rounds):
        if not any(e.busy() for e in rt.engines.values()):
            break
        for name in list(rt.engines):
            eng = rt.engines[name]
            if eng.busy():
                eng.step()
                digests.append((name, host_state(eng)))
    return {rid: r.output_tokens for rid, r in sorted(rt.run().items())}


def _bytes(tree_) -> int:
    return sum(a.numel() * a.element_size() for a in tree.leaves(tree_))


def _counted(rt):
    calls = []
    score = rt.router.compressor._textrank

    def counted(sim):
        calls.append(sim.shape[0])
        return score(sim)
    rt.router.compressor._textrank = counted
    return calls


def placement(cfg, full, mesh):
    """Per (K, tp) of a dense fleet: the placement, this rank's KV bytes a
    pool and weight bytes a shard set, and whether each shard set is
    ``shard_params`` of the full weights bitwise; then the K=2 tp=2
    fleet's long pool moved to each of REPROVISION_TP in turn."""
    def read(rt):
        return dict(place=rt.device_placement(),
                    kv={n: e.cache_bytes_per_device()
                        for n, e in rt.engines.items()},
                    shards={tuple(m.ranks): _bytes(p)
                            for m, p in rt.shards.items()},
                    exact=all(_equal(p, SH.shard_params(
                        full, PC.make_context(m)))
                        for m, p in rt.shards.items()),
                    member={n: e.member for n, e in rt.engines.items()},
                    tp={n: e.tp_degree for n, e in rt.engines.items()})
    out = {}
    for k in FLEETS:
        for tp in PLACEMENT_TP:
            rt = fleet(cfg, full, k, mesh=mesh, tp_degree=tp)
            out[(k, tp)] = read(rt)
            if (k, tp) == (2, 2):
                for new in REPROVISION_TP:
                    rt.reprovision("long", tp=new)
                    out[(k, tp, new)] = read(rt)
    return out


def _equal(a, b) -> bool:
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def tokens(cfg, full, mesh, requests):
    """The K=2 tp=2 fleet through the C&R gateway: per TOKEN_CASES, the
    routing decisions, {rid: (pool, compressed, tokens)}, the scorer's
    calls on this rank and the host-state crcs after every step."""
    out = {}
    for impl, paged in TOKEN_CASES:
        rt = fleet(cfg, full, paged=paged, decode_k=4, decode_impl=impl,
                   mesh=mesh, tp_degree=2)
        calls = _counted(rt)
        decisions = []
        for rid, text, n, cat in requests:
            d = rt.submit(GatewayRequest(rid, text, n, category=cat))
            decisions.append((d.pool, d.compressed, d.l_total_effective))
        digests = []
        toks = drive(rt, digests)
        out[(impl, paged)] = dict(
            decisions=decisions, tokens=toks, calls=len(calls),
            digests=digests,
            dispatches={n: e.dispatches for n, e in rt.engines.items()})
    return out


def _session(rt, wave):
    for r in wave:
        rt.submit(GatewayRequest(**r))


def moved(cfg, full, mesh, waves, tp, new_tp, eos):
    """The reference's ``_run_sharded`` on the K=2 fleet at ``tp``, paged
    with the prefix cache: wave 1 (a session's first turn) drains, wave 2
    (the turn again, prefix-warm, beside other requests) runs until every
    occupied slot of the long pool decodes, and then (``new_tp`` not
    None) the long pool moves to ``new_tp`` mid-flight. Returns the
    tokens, the host-state crcs, the long pool's KV bytes on this rank
    before and after, the move's info, the recompute counts, and whether
    this rank's new shard set equals ``shard_params`` of the full
    weights."""
    rt = fleet(cfg, full, paged=True, prefix_cache=True, decode_k=4,
               eos_id=eos, mesh=mesh, tp_degree=tp)
    digests = []
    _session(rt, waves[0])
    toks = drive(rt, digests)
    _session(rt, waves[1])
    long_ = rt.engines["long"]
    for _ in range(200):
        live = [s for s in range(long_.n_max) if long_.slot_req[s]]
        if live and not any(long_.slot_prefill_left[s] for s in live):
            break
        for name in list(rt.engines):
            eng = rt.engines[name]
            if eng.busy():
                eng.step()
                digests.append((name, host_state(eng)))
    hit = long_.prefix_stats["hit_blocks"]
    before = long_.cache_bytes_per_device()
    info, recomputed = None, long_.overload_stats["recomputed"]
    if new_tp is not None:
        info = rt.reprovision("long", tp=new_tp)
        recomputed += long_.overload_stats["recomputed"]
        del long_
        digests.append(("long", host_state(rt.engines["long"])))
    new = rt.engines["long"]
    after = new.cache_bytes_per_device()
    mesh_new = new.mesh
    exact = None
    if new.member:
        exact = _equal(new.params,
                       SH.shard_params(full, PC.make_context(mesh_new)))
    toks.update(drive(rt, digests))
    recomputed += new.overload_stats["recomputed"]
    return dict(tokens=toks, digests=digests, before=before, after=after,
                info=info, recomputed=recomputed, exact=exact,
                member=new.member, hit_blocks=hit,
                moved_rows=list(rt.moved_rows),
                swapped_in=new.overload_stats["swapped_in"],
                place=rt.device_placement(),
                shards=sorted(tuple(m.ranks) for m in rt.shards))


def crash(cfg, full, mesh, requests, eos, kill):
    """The K=2 tp=2 fleet (dense, decode_k 1): with ``kill``, the short
    pool is killed once the long pool decodes, and ``recover_pool``
    rebuilds it on its own submesh while the long pool serves. Returns
    the tokens by rid, each request's pool, the recovery's info and the
    host-state crcs."""
    rt = fleet(cfg, full, decode_k=1, eos_id=eos, mesh=mesh, tp_degree=2)
    pools = {}
    for r in requests:
        pools[r["rid"]] = rt.submit(GatewayRequest(**r)).pool
    digests, info = [], {}
    for rnd in range(2000):
        if not any(e.busy() for e in rt.engines.values()):
            break
        for name in list(rt.engines):
            eng = rt.engines[name]
            if not eng.busy():
                continue
            try:
                eng.step()
            except EngineDead:
                info["recovered"] = RC.recover_pool(rt, name)
                continue
            digests.append((name, host_state(eng)))
        long_ = rt.engines["long"]
        if kill and not info and any(
                long_.slot_req[s] and not long_.slot_prefill_left[s]
                for s in range(long_.n_max)):
            RC.FaultInjector(rt).kill("short")
            info["killed_at"] = rnd
    toks = {rid: r.output_tokens for rid, r in rt.run().items()}
    return dict(tokens=toks, pools=pools, info=info, digests=digests,
                restarts=rt.reprovision_stats["engine_restarts"])


def refused(cfg, mesh):
    """A move to a degree the kv heads do not divide (2 kv heads at tp=4):
    the refusal's text, and whether the pool's engine and its host state
    are still the ones from before the call."""
    import dataclasses
    from repro_torch.models import model as TM
    narrow = dataclasses.replace(cfg, num_kv_heads=2)
    rt = fleet(narrow, TM.init_params(narrow, seed=0, device="cpu"),
               paged=True, mesh=mesh, tp_degree=2)
    rt.submit(GatewayRequest(0, "long request " * 30, 4))
    rt.engines["long"].step()
    eng, before = rt.engines["long"], host_state(rt.engines["long"])
    try:
        rt.reprovision("long", tp=4)
    except NotImplementedError as e:
        return str(e), rt.engines["long"] is eng and \
            host_state(eng) == before
    return "no refusal", False


def _lines(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn()
    return buf.getvalue().splitlines(), result


def run_scenarios(rank, device, inp):
    """Every scenario on this rank; a failing scenario's traceback is
    returned, so one fault does not hide the others."""
    out = {"seconds": {}}
    mesh = parse_mesh(MESH)
    cfg = inp["cfg"]
    full = P.from_jax_numpy(inp["jp"], device="cpu")

    def scenario(name, fn):
        t0 = time.perf_counter()
        try:
            out[name] = fn()
        except Exception:          # noqa: BLE001 (reported to the test)
            out[name] = ("error", traceback.format_exc())
        out["seconds"][name] = round(time.perf_counter() - t0, 2)

    scenario("placement", lambda: placement(cfg, full, mesh))
    scenario("tokens", lambda: tokens(cfg, full, mesh, inp["fleet"]))
    runs = {}
    for tp, new in MOVES:
        for event in (None, new):
            if (tp, event) not in runs:
                runs[(tp, event)] = (
                    lambda tp=tp, event=event: moved(
                        cfg, full, mesh, inp["waves"], tp, event,
                        inp["eos"]))
    scenario("moved", lambda: {key: fn() for key, fn in runs.items()})
    scenario("refused", lambda: refused(cfg, mesh))
    scenario("crash", lambda: {kill: crash(cfg, full, mesh, inp["crash"],
                                           inp["eos"], kill)
                               for kill in (False, True)})

    def launcher():
        args = TS.parse_args(inp["fleet_argv"] + ["--tp", "2", "--mesh",
                                                  MESH])
        lines, (rt, res, _) = _lines(lambda: TS.serve_fleet(args,
                                                            device=device))
        return (lines, {rid: r.output_tokens for rid, r in res.items()},
                rt.device_placement())
    scenario("launcher", launcher)
    return out
