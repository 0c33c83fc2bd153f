"""Live re-provisioning and crash recovery in the port, held to the JAX
package (the twin of ``tests/test_reprovision.py``, its non-sharded cases).

Both packages run reduced llama3-70b in f32 on the same weights (the JAX
parameters carried across with ``params.from_jax_numpy``). Every scenario
is held twice:

* within the port: a request checkpointed by ``FleetRuntime.reprovision``
  or salvaged by ``recover_pool`` finishes with the tokens of the port's
  uninterrupted run, for the ``"torch"`` and the ``"kernel"`` decode impl
  (the kernels' plain versions on the CPU);
* against JAX: the JAX runtime and both port runtimes step in lockstep on
  the same stream and the same event. After every round (and right after
  the event) their waiting queues, slot occupants, checkpoints (``pos``,
  ``out``, ``replay``, ``n_blocks``), results, ``reprovision_stats`` and
  routing decisions are equal, and so are the event's and the
  recoveries' return dicts; swap-path host KV agrees with JAX's numpy rows
  to 1e-5 relative (the two packages' f32 K/V differ by ~1.6e-6).
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from conftest import reduced_f32
from jax_compile_cache import jax_compile_cache  # noqa: F401
from repro.models import model as JM
from repro.serving import config as JConfig
from repro.serving import engine as JEngine
from repro.serving import pools as JPools
from repro.serving import reconfigure as JReconf
from repro_torch import params as P
from repro_torch.configs.base import get_config
from repro_torch.serving import config as TConfig
from repro_torch.serving import engine as TEngine
from repro_torch.serving import pools as TPools
from repro_torch.serving import reconfigure as TReconf

HOST_KV_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes run the suite at once: one intra-op thread
    each keeps these small-shape tests from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pkgs():
    """name -> the package's modules, model and decode impl: the JAX
    runtime ("xla") and the port's two impls, on one weight set."""
    cfg = reduced_f32("llama3-70b")
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_config("llama3-70b").reduced(),
                               dtype="float32")
    tp = P.from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jax_ns = dict(pools=JPools, config=JConfig, engine=JEngine,
                  reconf=JReconf, cfg=cfg, params=jp)
    port_ns = dict(pools=TPools, config=TConfig, engine=TEngine,
                   reconf=TReconf, cfg=tcfg, params=tp)
    return {"jax": types.SimpleNamespace(impl="xla", **jax_ns),
            "torch": types.SimpleNamespace(impl="torch", **port_ns),
            "kernel": types.SimpleNamespace(impl="kernel", **port_ns)}


PORT = ("torch", "kernel")


# -- fleets and streams (the reference test's) ------------------------------
def _scfg(p, **skw):
    return p.config.ServingConfig(**dict(dict(c_chunk=16, decode_impl=p.impl),
                                         **skw))


def _fleet1(p, **skw):
    """Single-pool runtime: no pool above, so nothing can re-route."""
    return p.pools.FleetRuntime(p.cfg, p.params, boundaries=(), gammas=(),
                                n_maxes=(3,), c_maxes=(128,),
                                config=_scfg(p, **skw))


def _fleet2(p, **skw):
    return p.pools.TwoPoolRuntime(p.cfg, p.params, 64, 1.0, 3, 2, 192,
                                  config=_scfg(p, **skw))


class _TinyLout:
    """Stub predictor that always guesses a 4-token output, so a
    short-pool request's prompt + budget can pass the routing boundary
    (lout_routing routes on the prediction)."""
    def predict(self, prompt_tokens, category=None, cap=None):
        return 4

    def update(self, l_in, l_out, category=None):
        pass


def _headroom_fleet(p):
    """K=2 fleet whose short pool has context headroom past its boundary."""
    return p.pools.FleetRuntime(p.cfg, p.params, boundaries=(32,),
                                gammas=(1.0,), n_maxes=(3, 2),
                                c_maxes=(64, 192),
                                config=_scfg(p, lout_routing=True),
                                lout_predictor=_TinyLout())


def _requests(n=5, max_new=10):
    """(rid, text, max_output_tokens): deterministic mixed lengths, no EOS."""
    return [(i, f"req {i} " + "alpha beta " * (2 + 3 * i), max_new - (i % 3))
            for i in range(n)]


def _short_reqs():
    # prompts of 20..26 tokens routed short by the stub predictor, with
    # prompt + budget 32..50 straddling the shrunk context of 36
    return [(i, "a" * (80 + 8 * (i % 4)), 12 + (i % 3) * 6) for i in range(5)]


def _layout(paged):
    return dict(paged=True, block_size=16) if paged else {}


# -- lockstep runner ---------------------------------------------------------
def _state(rt):
    """Host state compared across packages after every round."""
    out = {"stats": dict(rt.reprovision_stats),
           "down": sorted(rt.pool_down_until),
           "decisions": {rid: d.pool for rid, d in rt._decisions.items()}}
    for name, e in rt.engines.items():
        out[name] = dict(
            geometry=(e.n_max, e.c_max, e.paged), iteration=e.iteration,
            fault=e._fault, waiting=[r.rid for r in e.waiting],
            slots=[r.rid if r is not None else None for r in e.slot_req],
            slot_out=[list(o) for o in e.slot_out],
            preempted=sorted(
                (rid, st.pos, st.n_blocks, list(st.out), list(st.replay),
                 st.last_tok, st.host_kv is None)
                for rid, st in e._preempted.items()),
            results={rid: (r.output_tokens, r.shed, r.preemptions,
                           r.queue_iters, r.prefill_iters)
                     for rid, r in e.results.items()})
        if e.paged:
            out[name].update(tables=e.block_tables.tolist(),
                             free=list(e._free), reserved=e._reserved)
    return out


def _host_kv_close(jrt, trt) -> int:
    """Every swap-path checkpoint's host KV: the port's CPU tensors against
    JAX's numpy rows, same shape, within HOST_KV_RTOL of the largest
    magnitude. A JAX VLM row holds its self-attention leaves grouped,
    (n_groups, every, S, ...), and its cross memory beside "kv": those
    are read at the top level and the grouped ones flattened to the
    port's (num_layers, S, ...). Returns the number of leaves compared."""
    n = 0
    for name, je in jrt.engines.items():
        te = trt.engines[name]
        for rid, jst in je._preempted.items():
            if jst.host_kv is None:
                continue
            for k, t in te._preempted[rid].host_kv.items():
                j = np.asarray(jst.host_kv[k] if k in ("xk", "xv")
                               else jst.host_kv["kv"][k])
                if j.ndim == t.dim() + 1:       # VLM's grouped layers
                    j = j.reshape(-1, *j.shape[2:])
                assert t.device.type == "cpu" and tuple(t.shape) == j.shape
                err = float(np.abs(t.numpy() - j).max())
                assert err <= HOST_KV_RTOL * float(np.abs(j).max()), \
                    (name, rid, k, err)
                n += 1
    return n


def _run(pkgs, names, build, reqs, warm=0, event=None, recover=None,
         max_rounds=2000):
    """Build one runtime per package in ``names``, submit ``reqs`` and
    drive them in lockstep: ``warm`` rounds, ``event(pkg, rt)`` (its return
    value is compared across packages), then rounds until
    every fleet drains. ``recover`` = "dead" recovers an engine that
    raises EngineDead, "health" a pool a HealthPolicy(patience=2) judges
    wedged, both through ``recover_pool``. States are compared after every
    round. Returns {name: (runtime, event outcome, recoveries, results)}
    and the host-KV leaves compared."""
    rts = {n: build(pkgs[n]) for n in names}
    for n, rt in rts.items():
        for rid, text, max_new in reqs:
            rt.submit(pkgs[n].pools.GatewayRequest(rid, text, max_new))
    recs = {n: [] for n in names}
    health = {n: pkgs[n].reconf.HealthPolicy(patience=2) for n in names}
    compared = [0]

    def check(where):
        ref = _state(rts[names[0]])
        for n in names[1:]:
            assert _state(rts[n]) == ref, f"{n} diverged {where}"
            if "jax" in rts:
                compared[0] += _host_kv_close(rts["jax"], rts[n])

    def one_round():
        for pool in list(rts[names[0]].engines):
            busy = {n: rt.engines[pool].busy() for n, rt in rts.items()}
            assert len(set(busy.values())) == 1, busy
            for n, rt in rts.items():
                if not busy[n]:
                    continue
                p = pkgs[n]
                try:
                    rt.engines[pool].step()
                except p.engine.EngineDead:
                    assert recover == "dead", "unexpected engine death"
                    recs[n].append(p.reconf.recover_pool(rt, pool,
                                                         blackout_s=0.0))
        if recover == "health":
            for n, rt in rts.items():
                for pool in health[n].check(rt):
                    recs[n].append(pkgs[n].reconf.recover_pool(rt, pool))

    for i in range(warm):
        one_round()
        check(f"at warm round {i}")
    outcome = {n: None for n in names}
    if event is not None:
        for n, rt in rts.items():
            outcome[n] = event(pkgs[n], rt)
        check("right after the event")
    rounds = 0
    while any(e.busy() for e in rts[names[0]].engines.values()):
        one_round()
        rounds += 1
        check(f"at round {rounds} after the event")
        assert rounds < max_rounds, "fleet did not drain"
    for n in names[1:]:
        assert outcome[n] == outcome[names[0]]
        assert recs[n] == recs[names[0]]
    out = {n: (rt, outcome[n], recs[n], rt.run(max_iters=1))
           for n, rt in rts.items()}
    return out, compared[0]


def _tokens(res):
    return {rid: r.output_tokens for rid, r in sorted(res.items())}


def _responses(res):
    return {rid: (r.pool, r.output_tokens, r.shed, r.timed_out)
            for rid, r in sorted(res.items())}


def _held(pkgs, build, reqs, **kw):
    """Both holds: the event run in lockstep with JAX, and each port impl's
    tokens against its own uninterrupted run. Returns the lockstep run."""
    base, _ = _run(pkgs, PORT, build, reqs)
    got, n_kv = _run(pkgs, ("jax",) + PORT, build, reqs, **kw)
    for n in PORT:
        res = got[n][3]
        assert not any(r.timed_out or r.shed for r in res.values())
        assert _tokens(res) == _tokens(base[n][3]), \
            f"{n}: the event changed output tokens"
        assert _responses(res) == _responses(got["jax"][3])
    return got, n_kv


# -- re-provisioning ---------------------------------------------------------
def _reprovision_small(p, rt):
    pool = next(iter(rt.engines))
    assert rt.engines[pool].busy(), "nothing in flight at reprovision"
    info = rt.reprovision(pool, n_max=2, c_max=160)
    eng = rt.engines[pool]
    swapped = [st for st in eng._preempted.values() if st.host_kv]
    assert swapped, "no checkpoint took the swap path"
    for st in swapped:
        for h in st.host_kv.values():
            h = np.asarray(h["k"] if isinstance(h, dict) else h)
            if eng.paged:           # blocks move unchanged
                assert h.shape[1] == st.n_blocks
            else:                   # rows padded with zeros past 128
                assert h.shape[1] == 160 and not h[:, 128:].any()
    return info


@pytest.mark.parametrize("decode_k", [1, 4])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_reprovision_parity(pkgs, paged, decode_k):
    """reprovision() on a loaded pool, fewer slots and a larger context
    (dense host rows zero-padded along seq on the host, paged blocks
    moved unchanged): zero dropped requests, the uninterrupted run's
    tokens, JAX's host state after every round."""
    skw = dict(decode_k=decode_k, **_layout(paged))
    got, n_kv = _held(pkgs, lambda p: _fleet1(p, **skw), _requests(), warm=4,
                      event=_reprovision_small)
    for n in ("jax",) + PORT:
        rt, info, _, _ = got[n]
        assert info["migrated"] > 0 and info["rerouted"] == 0
        assert info["checkpointed"] > 0
        eng = rt.engines["long"]
        assert (eng.n_max, eng.c_max) == (2, 160)
        assert rt.reprovision_stats["rebuilds"] == 1
        assert rt.reprovision_stats["migrated_requests"] == info["migrated"]
    # the swap path's host KV was held against JAX's
    assert n_kv > 0


def _refused_shrink(p, rt):
    eng = rt.engines["long"]
    with pytest.raises(ValueError, match="orphan"):
        rt.reprovision("long", c_max=16)
    assert rt.engines["long"] is eng          # nothing was swapped
    return {"refused": True}


def _reroute(p, rt):
    return rt.reprovision("short", c_max=36)


def _kill(p, rt):
    assert rt.engines["short"].busy()
    p.reconf.FaultInjector(rt).kill("short")


def _oom(p, rt):
    p.reconf.FaultInjector(rt).exhaust_allocator("short")


def _wedge(p, rt):
    p.reconf.FaultInjector(rt).wedge("short")


# name -> (fleet builder, stream, warm rounds, event, recovery)
SCENARIOS = {
    # shrinking the top pool below an in-flight footprint is refused
    # before any state is touched
    "top-pool-shrink-refused": (_fleet1, [(0, "long " * 30, 12)], 2,
                                _refused_shrink, None),
    # misfits of a shrunk non-top pool re-route one pool up
    "misfits-reroute-up": (_headroom_fleet, _short_reqs(), 3, _reroute, None),
    # a crash loses device state, never an accepted request
    "kill": (_fleet2, _requests(), 3, _kill, "dead"),
    # the oom fault raises inside the allocator, counters left mid-update
    "allocator-exhaustion": (
        lambda p: _fleet2(p, paged=True, block_size=8),
        _requests(max_new=16), 2, _oom, "dead"),
    # a wedged step never raises: the health policy finds the stall
    "wedge": (_fleet2, _requests(), 3, _wedge, "health"),
}


@pytest.mark.parametrize("case", list(SCENARIOS))
def test_fault_and_reroute_lockstep(pkgs, case):
    build, reqs, warm, event, recover = SCENARIOS[case]
    got, _ = _held(pkgs, build, reqs, warm=warm, event=event,
                   recover=recover)
    for n in ("jax",) + PORT:
        rt, info, recs, res = got[n]
        stats = rt.reprovision_stats
        if case == "top-pool-shrink-refused":
            assert stats["rebuilds"] == 0 and len(res) == 1
        elif case == "misfits-reroute-up":
            assert info["rerouted"] > 0, "no request outgrew the context"
            assert sum(r.pool == "long" for r in res.values()) \
                == info["rerouted"] == stats["rerouted_requests"]
        else:
            assert len(recs) == 1, "the fault never fired or fired twice"
            assert recs[0]["rerouted_to"] == "long"
            assert stats["engine_restarts"] == 1
            assert sum(r.pool == "long" for r in res.values()) \
                >= recs[0]["migrated"] > 0
            assert rt.engines["short"]._fault is None


# -- the engine's fault hooks -----------------------------------------------
def test_fault_hooks_act_on_the_host_first(pkgs):
    """killed: step() raises EngineDead before touching anything (clock,
    queue, cache); wedged: it returns with the clock unmoved; oom: the
    allocator raises before its free list changes. exhaust_allocator on
    a dense pool is a ValueError, as in JAX."""
    p = pkgs["torch"]
    rt = _fleet2(p, paged=True, block_size=8)
    for rid, text, max_new in _requests(3):
        rt.submit(p.pools.GatewayRequest(rid, text, max_new))
    eng = rt.engines["short"]
    eng.step()
    inj = p.reconf.FaultInjector(rt)
    before = (eng.iteration, [r.rid for r in eng.waiting],
              {k: a.clone() for k, a in eng.cache["kv"].items()})
    for fault in ("kill", "wedge"):
        getattr(inj, fault)("short")
        if fault == "kill":
            with pytest.raises(p.engine.EngineDead):
                eng.step()
        else:
            eng.step()
        assert eng.iteration == before[0]
        assert [r.rid for r in eng.waiting] == before[1]
        assert all(torch.equal(a, before[2][k])
                   for k, a in eng.cache["kv"].items())
        inj.clear("short")
    inj.exhaust_allocator("short")
    free = list(eng._free)
    with pytest.raises(p.engine.EngineDead, match="allocator"):
        eng._alloc_block()
    assert eng._free == free
    dense = _fleet2(p)
    for name in ("jax", "torch"):
        rt = dense if name == "torch" else _fleet2(pkgs["jax"])
        with pytest.raises(ValueError, match="paged"):
            pkgs[name].reconf.FaultInjector(rt).exhaust_allocator("short")
        assert rt.engines["short"]._fault is None


def _oom_after_the_last_chunk(p):
    """A 20-token prompt (chunks of 16 + 4) on a paged short pool of
    8-token blocks: the allocator is exhausted after the first chunk, so
    the step that takes the last chunk raises EngineDead when it asks for
    block 3. Returns the uninterrupted run's tokens, the dead engine's
    salvage and the recovered run's result."""
    text = "x" * 80                          # 20 tokens: chunks of 16 + 4

    def fleet():
        rt = _fleet2(p, paged=True, block_size=8)
        rt.submit(p.pools.GatewayRequest(0, text, 6))
        return rt
    base = fleet().run()[0].output_tokens
    rt = fleet()
    eng = rt.engines["short"]
    eng.step()                                # the first chunk: 2 blocks
    assert len(eng.slot_prefill_left[0]) == 4
    p.reconf.FaultInjector(rt).exhaust_allocator("short")
    with pytest.raises(p.engine.EngineDead):
        eng.step()                            # the last chunk needs block 3
    assert not eng.slot_prefill_left[0] and eng.slot_pos[0] == 16
    salvaged = p.reconf.salvage_states(eng)
    p.reconf.recover_pool(rt, "short")
    return base, salvaged, rt.run()[0]


@pytest.mark.parametrize("impl", PORT)
def test_oom_after_the_last_chunk_is_taken_resumes_exactly(pkgs, impl):
    """step() takes a slot's last prefill chunk off its list before it
    allocates the chunk's blocks, so an oom raised there leaves the slot
    with an empty list and its KV short of the prompt. Salvage replays it
    as mid-prefill and the tokens are the uninterrupted run's."""
    base, [(req, st)], res = _oom_after_the_last_chunk(pkgs[impl])
    assert st.last_tok == req.tokens[-1] and st.replay == req.tokens
    assert res.pool == "long" and res.output_tokens == base


def test_oom_after_the_last_chunk_is_taken_stales_the_reference(pkgs):
    """The same fault on the JAX runtime: its salvage tests the empty list
    alone, resumes the slot as decoding and feeds the token it holds (not
    the prompt's last), so its tokens leave its own uninterrupted run's.
    This pins the port's one departure from the reference; a repair of
    the reference makes this test fail."""
    base, [(req, st)], res = _oom_after_the_last_chunk(pkgs["jax"])
    assert st.last_tok != req.tokens[-1]
    assert res.pool == "long" and res.output_tokens != base


def test_reprovision_tp_raises_before_any_state_changes(pkgs):
    p = pkgs["torch"]
    rt = _fleet1(p)
    for rid, text, max_new in _requests(3):
        rt.submit(p.pools.GatewayRequest(rid, text, max_new))
    rt.engines["long"].step()
    eng = rt.engines["long"]
    before = _state(rt)
    with pytest.raises(ValueError, match="needs a fleet mesh"):
        rt.reprovision("long", n_max=2, tp=2)
    assert rt.engines["long"] is eng and _state(rt) == before


# -- runtime surfaces: blackout, timed-out requests, flat host dicts ---------
def _blackout(p):
    rt = _fleet2(p)
    info = p.reconf.recover_pool(rt, "short", blackout_s=60.0)
    with pytest.raises(p.reconf.PoolDownError) as ei:
        rt.submit(p.pools.GatewayRequest(0, "tiny", 4))
    assert ei.value.pool == "short" and ei.value.retry_after > 0
    # the long pool keeps serving (prompt past the 64-token boundary)
    rt.submit(p.pools.GatewayRequest(1, "big " * 80, 4))
    rt.pool_down_until["short"] = 0.0         # the window elapsed
    rt.submit(p.pools.GatewayRequest(2, "tiny", 4))
    res = rt.run()
    assert set(res) == {1, 2} and not rt.pool_down_until
    return info["blackout_s"], info["migrated"], _responses(res)


def _timed_out(p):
    """run(max_iters) returns in-flight requests as timed_out with their
    partial prefix; a later run() finishes them."""
    rt = _fleet1(p)
    rt.submit(p.pools.GatewayRequest(0, "steady stream of words here", 24))
    partial = rt.run(max_iters=5)
    assert set(partial) == {0} and partial[0].timed_out
    assert 0 < len(partial[0].output_tokens) < 24
    full = rt.run()
    assert not full[0].timed_out and len(full[0].output_tokens) == 24
    assert full[0].output_tokens[:len(partial[0].output_tokens)] \
        == partial[0].output_tokens
    return _responses(partial), _responses(full)


def _flat_dicts(p):
    """Three waves through run(): the engine results and the gateway's
    decision and category dicts are empty after each."""
    rt = _fleet2(p)
    rid, out = 0, []
    for _ in range(3):
        for _ in range(4):
            rt.submit(p.pools.GatewayRequest(rid, "wave " * (1 + rid % 5), 6))
            rid += 1
        res = rt.run()
        assert len(res) == 4
        assert not rt._decisions and not rt._categories
        assert all(not e.results for e in rt.engines.values())
        out.append(_responses(res))
    return out


@pytest.mark.parametrize("surface", [_blackout, _timed_out, _flat_dicts],
                         ids=["blackout", "timed-out", "flat-host-dicts"])
def test_runtime_surfaces_match_jax(pkgs, surface):
    want = surface(pkgs["jax"])
    for n in PORT:
        assert surface(pkgs[n]) == want, n
