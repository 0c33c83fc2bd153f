"""The int8 KV cache and the sliding-window ring caches through the
port's engine, its host KV tier and its fleet, against the JAX package.

Both packages run reduced minitron-8b in f32 on the same weights (the JAX
parameters carried across with ``params.from_jax_numpy``) and the same
seed-made streams.

* Lockstep with the JAX engine: the int8 engine at decode_k 1 and 4,
  with a swap and a recompute preemption, and at spec_k 2; the windowed
  engine (a ring of 16 under prompts of 20-44 tokens) at decode_k 1 and
  4; int8 and a window in one engine. After every step both hold the
  same slots, positions, emitted tokens, queue, host tier and results,
  and caches (swap-path host rows alike) by tests/test_torch_kvcache.py's
  rule: fp within 1e-5 of the largest magnitude; int8 values within 1,
  and scales within 1e-5 relative in the first layer. Deeper layers are
  held to 1e-5 where their K/V can only have come from JAX's int8
  values: the int8 runs go both free-running and resynced, and resynced
  the port takes JAX's cache bits before every step, so each row's
  deeper scales are held to 1e-5 unless a lower layer of that row holds
  a value that rounded the other way in that step (its f32 input a few
  ulps off JAX's). Such a value moves the attention, and through it the
  next layers' K/V and scales by up to ~1e-3 relative (read: 5.7e-4 and
  1.1e-3 on the second layer's k / v scales of the first chunk); there,
  and in every deeper layer of a free-running run, where it also lingers
  in rows past a slot's position, each dequantized entry, value x scale,
  is held within two of JAX's scale steps.
* Within the port, bitwise, for the int8 cache, the ring, and both: K=4
  equals K=1, and a request preempted by swap or by recompute finishes
  with the unloaded run's tokens; a swap moves every cache leaf (the
  scales, the ring's rows) to the host and back bit for bit.
* The fleet: ``FleetRuntime.from_plan`` with an int8 or a windowed config
  builds dense pools and serves the JAX runtime's tokens; ``reprovision``
  of an int8 pool, and of a windowed pool whose ring length changes with
  its context (48 -> 64 and 64 -> 48 under a window of 64), keeps the
  JAX runtime's host state every round and the uninterrupted run's
  tokens (tests/test_torch_reprovision.py's lockstep). Where the ring
  stays at the window while the context grows past it (128 -> 160), the
  JAX package fits the host row to the new context, which the ring
  cannot take, and its swap-in raises; the port fits the row to the ring
  and resumes exactly. Both sides are pinned.
"""
import dataclasses
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from conftest import reduced_f32
from jax_compile_cache import jax_compile_cache  # noqa: F401
from repro.core import planner as JP
from repro.core import workload as JW
from repro.models import model as M
from repro.serving import config as JConfig
from repro.serving import engine as JEngine
from repro.serving import pools as JPools
from repro.serving import reconfigure as JReconf
from repro_torch import params as P
from repro_torch.core import planner as TP
from repro_torch.core import workload as TW
from repro_torch.serving import config as TConfig
from repro_torch.serving import engine as TEngine
from repro_torch.serving import pools as TPools
from repro_torch.serving import reconfigure as TReconf

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_kvcache import _kv_close, port_cfg  # noqa: E402
from test_torch_reprovision import PORT, _held, _run, _tokens  # noqa: E402

EOS = 7
KINDS = {"int8": dict(kv_cache_dtype="int8"),
         "window": dict(attention_window=16),
         "int8+window": dict(kv_cache_dtype="int8", attention_window=16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one intra-op
    thread per worker keeps these small-shape tests from oversubscribing
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """The JAX parameters of reduced minitron-8b (f32) and the port's
    copy; the window and the cache dtype live in the configs only."""
    jp = M.init_params(reduced_f32("minitron-8b"), jax.random.PRNGKey(0))
    return jp, P.from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _cfgs(**change):
    return (dataclasses.replace(reduced_f32("minitron-8b"), **change),
            port_cfg(**change))


def _stream(seed=42, n_req=5, l_in=(20, 45), max_new=(6, 14)):
    rng = np.random.default_rng(seed)
    return [dict(rid=rid,
                 tokens=[int(t) for t in rng.integers(1, 900,
                                                      rng.integers(*l_in))],
                 max_new_tokens=int(rng.integers(*max_new)))
            for rid in range(n_req)]


# ----------------------------------------------------- engine lockstep
def _engines(weights, change, **kw):
    jp, tp = weights
    cfg, tcfg = _cfgs(**change)
    kw = dict(dict(n_max=3, c_max=128, c_chunk=16, eos_id=EOS), **kw)
    return (JEngine.InferenceEngine(cfg, jp, decode_impl="xla", **kw),
            TEngine.InferenceEngine(tcfg, tp, decode_impl="torch", **kw))


def _host(e):
    """Host state compared across packages after every step."""
    return dict(
        iteration=e.iteration, waiting=[r.rid for r in e.waiting],
        slots=[r.rid if r is not None else None for r in e.slot_req],
        pos=[int(p) for p in e.slot_pos],
        out=[list(o) for o in e.slot_out],
        preempted=sorted((rid, st.pos, list(st.out), list(st.replay),
                          st.last_tok, st.host_kv is None)
                         for rid, st in e._preempted.items()),
        overload=dict(e.overload_stats),
        results={rid: (r.output_tokens, r.preemptions)
                 for rid, r in e.results.items()})


def _cache_close(got, ref, resynced=False):
    """The module docstring's cache rule; leaves (L, B, ...) or, for a
    swap-path host row, (L, ...) with the layer first. ``resynced``: both
    held the same bits before the step that wrote these."""
    if "k_scale" not in got:
        return _kv_close(got, ref)
    assert set(got) == set(ref)
    row_axis = got["k"].ndim == 5
    got = {n: t.numpy() if row_axis else t.numpy()[:, None]
           for n, t in got.items()}
    ref = {n: np.asarray(r) if row_axis else np.asarray(r)[:, None]
           for n, r in ref.items()}
    n_layers, n_rows = got["k"].shape[:2]
    for n in ("k", "v"):
        assert got[n].shape == ref[n].shape and got[n].dtype == np.int8, n
        assert np.abs(got[n].astype(int) - ref[n].astype(int)).max() <= 1, n
    for b in range(n_rows):
        flipped = False  # a lower layer of row b rounded the other way
        for li in range(n_layers):
            for n in ("k", "v"):
                g, r = got[n][li, b].astype(np.int32), ref[n][li, b].astype(
                    np.int32)
                gs, rs = got[n + "_scale"][li, b], ref[n + "_scale"][li, b]
                if not flipped:
                    np.testing.assert_allclose(gs, rs, rtol=1e-5, atol=0,
                                               err_msg=f"{n} {li} {b}")
                else:
                    assert (np.abs(g * gs[..., None] - r * rs[..., None])
                            <= 2 * rs[..., None]).all(), (n, li, b)
            flipped = flipped or not resynced or any(
                not np.array_equal(got[n][li, b], ref[n][li, b])
                for n in ("k", "v"))


def _lockstep(jeng, teng, reqs, preempt_at=None, mode=None, victim=1,
              resync=False):
    """Step both engines on ``reqs`` until both drain, comparing host
    state, caches and swap-path host rows after every step; preempt
    ``victim`` (decoding on both) after ``preempt_at`` steps. With
    ``resync`` the port's cache takes JAX's bits before every step."""
    for r in reqs:
        jeng.submit(JEngine.ServeRequest(**r))
        teng.submit(TEngine.ServeRequest(**r))
    it = 0
    while jeng.busy() or teng.busy():
        if resync:
            for n, leaf in teng.cache["kv"].items():
                leaf.copy_(torch.from_numpy(np.array(jeng.cache["kv"][n])))
        jeng.step()
        teng.step()
        it += 1
        if it == preempt_at:
            for e in (jeng, teng):
                assert e.slot_req[victim] is not None \
                    and not e.slot_prefill_left[victim]
                e.preempt_slot(victim, mode=mode)
        assert _host(teng) == _host(jeng), f"diverged at step {it}"
        _cache_close(teng.cache["kv"], jeng.cache["kv"], resync)
        for rid, st in teng._preempted.items():
            if st.host_kv is not None:
                _cache_close(st.host_kv, jeng._preempted[rid].host_kv["kv"],
                             resync)
        assert it < 2000
    return {rid: r.output_tokens for rid, r in sorted(teng.results.items())}


INT8_SCENARIOS = {"decode_k1": ({}, None), "decode_k4": (dict(decode_k=4),
                                                          None),
                  "swap": ({}, "swap"), "recompute": ({}, "recompute"),
                  "spec_k2": (dict(spec_k=2), None)}


@pytest.mark.parametrize("resync", [False, True], ids=["free", "resync"])
@pytest.mark.parametrize("scenario", list(INT8_SCENARIOS))
def test_int8_engine_lockstep_matches_jax(weights, scenario, resync):
    """The int8 dense engine against the JAX int8 engine, step by step."""
    kw, mode = INT8_SCENARIOS[scenario]
    jeng, teng = _engines(weights, KINDS["int8"], **kw)
    assert teng.cache["kv"]["k"].dtype == torch.int8
    toks = _lockstep(jeng, teng, _stream(), preempt_at=6 if mode else None,
                     mode=mode, resync=resync)
    assert len(toks) == 5
    if mode:
        assert teng.overload_stats["swapped_out" if mode == "swap"
                                   else "recomputed"] == 1


@pytest.mark.parametrize("decode_k", [1, 4])
def test_windowed_engine_lockstep_matches_jax(weights, decode_k):
    """The windowed dense engine (window 16: a ring of 16 rows under
    c_max 128) against the JAX windowed engine on prompts longer than the
    window, prefilled token by token: every row's ring wraps."""
    jeng, teng = _engines(weights, KINDS["window"], decode_k=decode_k)
    assert teng.cache["kv"]["k"].shape[2] == 16
    toks = _lockstep(jeng, teng, _stream())
    assert len(toks) == 5


@pytest.mark.parametrize("resync", [False, True], ids=["free", "resync"])
def test_int8_windowed_engine_lockstep_matches_jax(weights, resync):
    """An int8 ring: both features in one engine, decode_k 4."""
    jeng, teng = _engines(weights, KINDS["int8+window"], decode_k=4)
    assert set(teng.cache["kv"]) == {"k", "v", "k_scale", "v_scale"}
    assert teng.cache["kv"]["k_scale"].shape[2] == 16
    _lockstep(jeng, teng, _stream(seed=43), resync=resync)


# ---------------------------------------------- invariants within the port
def _port_run(weights, change, preempt_at=None, mode=None, victim=1,
              **kw):
    """The port's engine on _stream(); with ``preempt_at``, ``victim`` is
    preempted (``mode``) after that many steps. A swap must copy every
    cache leaf of the row to the host bit for bit, and its swap-in must
    put those bits back."""
    jp, tp = weights
    _, tcfg = _cfgs(**change)
    eng = TEngine.InferenceEngine(tcfg, tp, n_max=3, c_max=128, c_chunk=16,
                                  eos_id=EOS, decode_impl="torch", **kw)
    swap_in = eng._swap_in
    restored = []

    def checked(s, qi, state):
        res = swap_in(s, qi, state)
        if res == "admitted":
            back = eng.cache_row(s)["kv"]
            for n, h in state.host_kv.items():
                assert torch.equal(back[n], h), n
            restored.append(s)
        return res
    eng._swap_in = checked
    for r in _stream():
        eng.submit(TEngine.ServeRequest(**r))
    it = 0
    while eng.busy():
        eng.step()
        it += 1
        if it == preempt_at:
            rid = eng.slot_req[victim].rid
            row = eng.cache_row(victim)["kv"]
            eng.preempt_slot(victim, mode=mode)
            host = eng._preempted[rid].host_kv
            if mode == "swap":
                assert set(host) == set(eng.cache["kv"])
                for n, h in host.items():
                    assert torch.equal(h, row[n])
    assert len(restored) == (mode == "swap")
    return {rid: r.output_tokens for rid, r in sorted(eng.results.items())}


@pytest.mark.parametrize("kind", list(KINDS))
def test_engine_invariants_bitwise(weights, kind):
    """Within the port, on the int8 cache, the ring, and both: decode_k 4
    emits decode_k 1's tokens; a request preempted mid decode resumes
    with the unloaded tokens by swap (every cache leaf copied to the host
    and back bit for bit, scales and ring rows included) and by
    recompute."""
    change = KINDS[kind]
    base = _port_run(weights, change)
    assert _port_run(weights, change, decode_k=4) == base
    assert _port_run(weights, change, preempt_at=6, mode="swap") == base
    assert _port_run(weights, change, preempt_at=6, mode="recompute") == base


# ----------------------------------------------------------------- fleet
def _prompt(n_words, topic):
    return " ".join(f"{topic} fact {i}: fleets split by context length."
                    for i in range(n_words))


@pytest.mark.parametrize("kind", ["int8", "window"])
def test_from_plan_fleet_matches_jax(weights, kind):
    """FleetRuntime.from_plan with an int8 or a windowed (64) config: the
    K=2 azure plan at the long pool's 512 tokens builds dense pools of
    that cache (int8 leaves, or rings of min(c_max, 64) rows), and every
    request gets the JAX runtime's pool and tokens."""
    jp, tp = weights
    change = {"int8": dict(kv_cache_dtype="int8"),
              "window": dict(attention_window=64)}[kind]
    cfg, tcfg = _cfgs(**change)
    plan_j = JP.plan_k_pool(JW.get_workload("azure"), lam=1000.0,
                            t_slo=0.5, k=2)
    plan_t = TP.plan_k_pool(TW.get_workload("azure"), lam=1000.0, t_slo=0.5,
                            k=2)
    kw = dict(slots_per_pool=2, c_chunk=16, decode_k=4, eos_id=None,
              ctx_scale=512 / plan_j.pools[-1].c_max)
    reqs = [(0, _prompt(3, "short"), 8), (1, _prompt(30, "long"), 8),
            (2, _prompt(6, "mid"), 5)]

    def serve(rt, request_cls):
        for rid, text, n in reqs:
            rt.submit(request_cls(rid, text, n))
        out = rt.run(max_iters=4000)
        assert sorted(out) == [0, 1, 2]
        return {rid: (r.pool, r.output_tokens) for rid, r in out.items()}

    rj = JPools.FleetRuntime.from_plan(cfg, jp, plan_j, decode_impl="xla",
                                       **kw)
    rt = TPools.FleetRuntime.from_plan(tcfg, tp, plan_t, decode_impl="torch",
                                       **kw)
    for name, eng in rt.engines.items():
        kv = eng.cache["kv"]
        assert not eng.paged
        if kind == "int8":
            assert kv["k"].dtype == torch.int8 and "k_scale" in kv
        else:
            assert kv["k"].shape[2] == min(eng.c_max, 64)
    assert serve(rt, TPools.GatewayRequest) == serve(rj,
                                                     JPools.GatewayRequest)


@pytest.fixture(scope="module")
def pkgs_for(weights):
    """change -> test_torch_reprovision's package namespaces (the JAX
    runtime and the port's two impls) on a config with ``change``."""
    jp, tp = weights

    def make(**change):
        cfg, tcfg = _cfgs(**change)
        jax_ns = dict(pools=JPools, config=JConfig, engine=JEngine,
                      reconf=JReconf, cfg=cfg, params=jp)
        port_ns = dict(pools=TPools, config=TConfig, engine=TEngine,
                       reconf=TReconf, cfg=tcfg, params=tp)
        return {"jax": types.SimpleNamespace(impl="xla", **jax_ns),
                "torch": types.SimpleNamespace(impl="torch", **port_ns),
                "kernel": types.SimpleNamespace(impl="kernel", **port_ns)}
    return make


def _fleet(c_max, **skw):
    def build(p):
        cfg = p.config.ServingConfig(**dict(dict(c_chunk=16,
                                                  decode_impl=p.impl), **skw))
        return p.pools.FleetRuntime(p.cfg, p.params, boundaries=(),
                                    gammas=(), n_maxes=(3,),
                                    c_maxes=(c_max,), config=cfg)
    return build


def _requests(n=5, max_new=10, words=(2, 3)):
    """(rid, text, max_output_tokens), deterministic mixed lengths."""
    return [(i, f"req {i} " + "alpha beta " * (words[0] + words[1] * i),
             max_new - (i % 3)) for i in range(n)]


def _reprovision_to(n_max, c_max):
    def event(p, rt):
        pool = next(iter(rt.engines))
        assert rt.engines[pool].busy(), "nothing in flight at reprovision"
        info = rt.reprovision(pool, n_max=n_max, c_max=c_max)
        eng = rt.engines[pool]
        swapped = [st for st in eng._preempted.values() if st.host_kv]
        assert swapped, "no checkpoint took the swap path"
        return info
    return event


@pytest.mark.parametrize("decode_k", [1, 4])
def test_int8_reprovision_matches_jax(pkgs_for, decode_k):
    """An int8 pool reprovisioned to fewer slots and a longer context: the
    swap-path rows, values and scales, zero-padded on the host; JAX's
    host state every round and the uninterrupted run's tokens, for the
    torch and the kernel decode impl."""
    pkgs = pkgs_for(kv_cache_dtype="int8")
    got, n_kv = _held(pkgs, _fleet(128, decode_k=decode_k), _requests(),
                      warm=4, event=_reprovision_to(2, 160))
    for n in ("jax",) + PORT:
        eng = got[n][0].engines["long"]
        assert (eng.n_max, eng.c_max) == (2, 160)
    assert n_kv > 0


WARM_PAST = 45         # rounds before the reprovision past the window

# (c_max before, after, the stream) under a window of 64: the ring
# length is min(c_max, 64) on both sides
RING_CROSSINGS = {"48->64": (48, 64, _requests(n=4, words=(2, 1))),
                  "64->48": (64, 48, _requests(n=4, max_new=6,
                                               words=(1, 1)))}


@pytest.mark.parametrize("crossing", list(RING_CROSSINGS))
def test_windowed_reprovision_across_the_window_matches_jax(pkgs_for,
                                                            crossing):
    """A windowed pool whose ring length changes with its context (48 ->
    64 and 64 -> 48 under a window of 64): no position has wrapped where
    the length changes, so the padded or truncated host rows resume
    exactly; JAX's host state every round, the uninterrupted tokens."""
    c0, c1, reqs = RING_CROSSINGS[crossing]
    pkgs = pkgs_for(attention_window=64)
    got, n_kv = _held(pkgs, _fleet(c0), reqs, warm=4,
                      event=_reprovision_to(2, c1))
    for n in ("jax",) + PORT:
        eng = got[n][0].engines["long"]
        assert eng.cache["kv"]["k"].shape[2] == min(c1, 64)
    assert n_kv > 0


def test_ring_reprovision_past_the_window(pkgs_for):
    """A pool with a window of 64 at c_max 128 (a ring of 64 that has
    wrapped) reprovisioned to c_max 160 (still a ring of 64). The port
    fits each swapped row to the ring and every request finishes with the
    uninterrupted run's tokens; the JAX package fits the rows to c_max
    160, and its swap-in raises."""
    pkgs = pkgs_for(attention_window=64)
    reqs = _requests(max_new=60)
    grow = _reprovision_to(2, 160)

    def event(p, rt):
        wrapped = max(int(x) for x in rt.engines["long"].slot_pos) > 64
        return grow(p, rt), wrapped

    base, _ = _run(pkgs, PORT, _fleet(128), reqs)
    got, _ = _run(pkgs, PORT, _fleet(128), reqs, warm=WARM_PAST, event=event)
    for n in PORT:
        rt, (_, wrapped), _, res = got[n]
        assert wrapped, "no ring had wrapped at the reprovision"
        assert rt.engines["long"].cache["kv"]["k"].shape[2] == 64
        assert _tokens(res) == _tokens(base[n][3])
    p = pkgs["jax"]
    rt = _fleet(128)(p)
    for rid, text, n in reqs:
        rt.submit(p.pools.GatewayRequest(rid, text, n))
    for _ in range(WARM_PAST):
        rt.engines["long"].step()
    grow(p, rt)
    st = next(s for s in rt.engines["long"]._preempted.values()
              if s.host_kv)
    assert np.asarray(st.host_kv["kv"]["k"]).shape[1] == 160
    with pytest.raises(ValueError, match="Incompatible shapes"):
        rt.run(max_iters=2000)
