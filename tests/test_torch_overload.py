"""Overload survival in the port: preemption with the swap / recompute host
tier, queue-wait shedding and HOL bypass, held to the JAX engine; and the
port's copy of the DES at the stability boundary.

Both engines run reduced minitron-8b in f32 on the same weights (the JAX
parameters carried across with ``params.from_jax_numpy``).

* Resume parity, within the port and bitwise: a request preempted mid
  decode, its KV swapped to the host tier or discarded and replayed
  through prefill (also through a warm prefix cache), finishes with the
  tokens of the unloaded run, dense and paged, decode_k 1 and 4; those
  tokens are the JAX engine's.
* Lockstep with the JAX engine on overload streams (a pool too small for
  every worst case, with preemption by swap and by recompute, shedding
  arrivals, HOL bypass): after every step both hold the same block tables,
  refcounts, free list, reservation, queue, host tier, ``overload_stats``
  and results (shed flags, preemption counts, tokens).
* ``host_tier_blocks`` is 0 at idle; the launcher prints the JAX
  launcher's overload lines.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from conftest import reduced_f32
from jax_compile_cache import jax_compile_cache  # noqa: F401
from repro.models import model as M
from repro.serving import pools as JPools
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.engine import ServeRequest as JaxRequest
from repro_torch import params as P
from repro_torch.configs.base import get_config
from repro_torch.serving import pools as TPools
from repro_torch.serving.engine import InferenceEngine, ServeRequest
from repro_torch.sim.des import mmpp_arrivals, simulate_pool

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_speculative import _launcher_lines  # noqa: E402

EOS = 7


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
def models():
    cfg = reduced_f32("minitron-8b")
    jp = M.init_params(cfg, jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_config("minitron-8b").reduced(),
                               dtype="float32")
    tp = P.from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tcfg, tp


def _stream(seed=42, n_req=6, max_new=12, l_in_max=40, l_in_min=3):
    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(n_req):
        l_in = int(rng.integers(l_in_min, l_in_max))
        reqs.append(dict(rid=rid,
                         tokens=[int(t) for t in rng.integers(1, 900, l_in)],
                         max_new_tokens=int(rng.integers(2, max_new))))
    return reqs


def _engine(cfg, params, engine_cls=InferenceEngine, **kw):
    kw = dict(dict(n_max=3, c_max=128, c_chunk=16, eos_id=EOS,
                   decode_impl="torch" if engine_cls is InferenceEngine
                   else "xla"), **kw)
    return engine_cls(cfg, params, **kw)


def _drive(eng, reqs, preempt_at=None, victim=1, mode=None,
           request_cls=ServeRequest):
    """Submit everything; optionally preempt slot ``victim`` after
    ``preempt_at`` steps (asserting it is decoding then). Checks the
    block and host-tier invariants after every step."""
    for r in reqs:
        eng.submit(request_cls(**r))
    it = 0
    while eng.busy() and it < 5000:
        eng.step()
        it += 1
        if it == preempt_at:
            assert eng.slot_req[victim] is not None \
                and not eng.slot_prefill_left[victim], \
                "the victim is not decoding at preempt_at"
            eng._test_victim_rid = eng.slot_req[victim].rid
            eng.preempt_slot(victim, mode=mode)
        eng.assert_block_invariants()
    assert not eng.busy(), "engine did not drain"
    return {rid: r.output_tokens for rid, r in sorted(eng.results.items())}


@pytest.fixture(scope="module")
def jax_tokens(models):
    """The JAX engine's unloaded tokens on _stream()."""
    cfg, jp, _, _ = models
    return _drive(_engine(cfg, jp, JaxEngine), _stream(),
                  request_cls=JaxRequest)


def _layout(paged):
    return dict(paged=True, block_size=16) if paged else {}


def test_block_movers_match_jax():
    """layers.gather_blocks / scatter_blocks on a pool with the port's
    sink block, and gather_slot_row / scatter_slot_row on a dense cache,
    move the JAX functions' bits exactly; nothing else of the pool (the
    sink included) or of the cache changes."""
    import jax.numpy as jnp
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((2, 9, 4, 2, 8)).astype(np.float32)
    tpool = torch.from_numpy(pool.copy())
    jpool = jnp.asarray(pool[:, :8])                # JAX has no sink
    idx = np.array([5, 2, 7])
    host = TL.gather_blocks(tpool, torch.tensor(idx))
    assert np.array_equal(host.numpy(),
                          np.asarray(JL.gather_blocks(jpool, idx)))
    fresh = np.array([1, 3, 4])
    TL.scatter_blocks(tpool, host, torch.tensor(fresh))
    want = np.asarray(JL.scatter_blocks(jpool, JL.gather_blocks(jpool, idx),
                                        fresh))
    assert np.array_equal(tpool[:, :8].numpy(), want)
    assert np.array_equal(tpool[:, 8].numpy(), pool[:, 8])    # the sink
    dense = rng.standard_normal((2, 3, 16, 2, 8)).astype(np.float32)
    tdense = torch.from_numpy(dense.copy())
    row = TL.gather_slot_row(tdense, 1)
    assert np.array_equal(row.numpy(), np.asarray(
        JL.gather_slot_row(jnp.asarray(dense), 1, 1)))
    TL.scatter_slot_row(tdense, row, 2)
    assert np.array_equal(tdense.numpy(), np.asarray(JL.scatter_slot_row(
        jnp.asarray(dense), jnp.asarray(row.numpy()), 2, 1)))
    row[:] = 0                                      # a copy, not a view
    assert np.array_equal(tdense[:, 1].numpy(), dense[:, 1])


@pytest.mark.parametrize("decode_k", [1, 4])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("mode", ["swap", "recompute"])
def test_preempt_resume_parity(models, jax_tokens, mode, paged, decode_k):
    """The swapped-in (or replayed) row re-enters a running micro-loop
    through the dirty-tracked device state, bitwise where the unloaded
    run would be."""
    _, _, tcfg, tp = models
    kw = dict(decode_k=decode_k, **_layout(paged))
    base = _drive(_engine(tcfg, tp, **kw), _stream())
    eng = _engine(tcfg, tp, **kw)
    got = _drive(eng, _stream(), preempt_at=6, mode=mode)
    assert got == base == jax_tokens
    st = eng.overload_stats
    assert st["preempted"] == 1
    if mode == "swap":
        assert st["swapped_out"] == st["swapped_in"] == 1
        assert st["recomputed"] == 0
    else:
        assert st["recomputed"] == 1 and st["swapped_out"] == 0
    assert eng.host_tier_blocks() == 0
    assert eng.results[eng._test_victim_rid].preemptions == 1


def test_recompute_through_warm_prefix_cache(models):
    """The replay's leading blocks hit the prompt blocks the request
    registered before it was preempted (copy-free admission); the
    re-decoded suffix matches the never-preempted run, and the port's
    counters and tokens equal the JAX engine's under the same
    preemption."""
    cfg, jp, tcfg, tp = models
    reqs = _stream(seed=5, l_in_min=20)
    kw = dict(paged=True, block_size=16, prefix_cache=True)
    base = _drive(_engine(tcfg, tp, **kw), reqs)
    eng = _engine(tcfg, tp, **kw)
    got = _drive(eng, reqs, preempt_at=6, mode="recompute")
    jeng = _engine(cfg, jp, JaxEngine, **kw)
    ref = _drive(jeng, reqs, preempt_at=6, mode="recompute",
                 request_cls=JaxRequest)
    assert got == base == ref
    assert eng.overload_stats == jeng.overload_stats
    assert eng.overload_stats["recomputed"] == 1
    assert eng.prefix_stats == jeng.prefix_stats
    assert eng.prefix_stats["hit_blocks"] > 0


def test_swap_threshold_selects_mode(models):
    _, _, tcfg, tp = models
    kw = dict(paged=True, block_size=16)
    eng = _engine(tcfg, tp, swap_threshold=10_000, **kw)
    _drive(eng, _stream(), preempt_at=6)
    assert eng.overload_stats["recomputed"] == 1
    eng = _engine(tcfg, tp, swap_threshold=0, **kw)
    _drive(eng, _stream(), preempt_at=6)
    assert eng.overload_stats["swapped_out"] == 1


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_host_tier_accounting_and_bits(models, paged):
    """While a slot's KV sits in the host tier, host_tier_blocks() is its
    block count (0 for a dense row), the host copy holds exactly the
    device bits it left, and swap-in writes those bits back wherever the
    slot lands; the tier is empty again at idle."""
    _, _, tcfg, tp = models
    eng = _engine(tcfg, tp, **_layout(paged))
    for r in _stream():
        eng.submit(ServeRequest(**r))
    for _ in range(6):
        eng.step()
    assert eng.slot_req[1] is not None and not eng.slot_prefill_left[1]
    pos, rid = int(eng.slot_pos[1]), eng.slot_req[1].rid
    if paged:
        blocks = list(eng._slot_blocks[1])
        before = {k: a[:, blocks].clone() for k, a in eng.cache["kv"].items()}
    else:
        before = {k: a[:, 1].clone() for k, a in eng.cache["kv"].items()}
    eng.preempt_slot(1, mode="swap")
    st = eng._preempted[rid]
    for k in before:
        assert torch.equal(st.host_kv[k], before[k])
    if paged:
        assert eng.host_tier_blocks() == len(blocks) == -(-pos // 16)
        assert eng.overload_stats["swapped_blocks"] == len(blocks)
    else:
        assert eng.host_tier_blocks() == 0
    eng.assert_block_invariants()
    restored = {}
    swap_in = eng._swap_in

    def spy(s, qi, state):              # the bits right after swap-in
        out = swap_in(s, qi, state)
        if out == "admitted":
            restored.update(
                {k: (a[:, eng._slot_blocks[s]] if paged else a[:, s]).clone()
                 for k, a in eng.cache["kv"].items()})
        return out
    eng._swap_in = spy
    eng.run_to_completion(5000)
    assert eng.overload_stats["swapped_in"] == 1
    for k in before:
        assert torch.equal(restored[k], before[k]), k
    assert eng.host_tier_blocks() == 0
    eng.assert_block_invariants()


# -- lockstep with the JAX engine -------------------------------------------
def _tight_stream(n=5, l_in=30, max_new=8):
    return [(0, dict(rid=i, tokens=[int(t) for t in np.random.default_rng(
        i).integers(1, 900, l_in)], max_new_tokens=max_new))
        for i in range(n)]


def _staggered(seed=0, bursts=20, per=3, every=4, l_in=12, max_new=8):
    rng = np.random.default_rng(seed)
    out, rid = [], 0
    for b in range(bursts):
        for _ in range(per):
            out.append((b * every, dict(
                rid=rid, tokens=[int(t) for t in rng.integers(1, 900, l_in)],
                max_new_tokens=max_new)))
            rid += 1
    return out


def _hol_stream():
    rng = np.random.default_rng(2)
    return [(0, dict(rid=i, tokens=[int(t) for t in rng.integers(1, 900, n)],
                     max_new_tokens=m))
            for i, (n, m) in enumerate([(20, 24), (30, 8), (8, 4)])]


# name -> (engine overrides, [(arrival step, request)])
CASES = {
    # worst case ceil(38/16) = 3 blocks, 3 slots x 3 > 6: the head defers
    # and the LIFO victim is swapped out
    "preempt-swap": (dict(paged=True, block_size=16, num_blocks=6,
                          preemption=True), _tight_stream()),
    # the same through the recompute path, replaying via the prefix cache,
    # in decode_k = 4 micro-loops
    "preempt-recompute-k4": (dict(paged=True, block_size=16, num_blocks=6,
                                  preemption=True, prefix_cache=True,
                                  swap_threshold=10_000, decode_k=4),
                             _tight_stream()),
    # arrivals shed once the estimated queue wait exceeds 3 iterations
    "shed": (dict(n_max=2, max_queue_wait=3.0), _staggered()),
    "shed-preempt-k4": (dict(n_max=2, max_queue_wait=6.0, paged=True,
                             block_size=16, num_blocks=5, preemption=True,
                             decode_k=4),
                        _staggered(seed=1, bursts=8, l_in=30)),
    # a 4-block pool: the small request bypasses the blocked head
    "hol-bypass": (dict(n_max=2, paged=True, block_size=16, num_blocks=4),
                   _hol_stream()),
}


def _state(eng):
    out = [eng.iteration, dict(eng.overload_stats),
           [r.rid for r in eng.waiting],
           sorted((rid, st.pos, st.n_blocks, list(st.out))
                  for rid, st in eng._preempted.items()),
           eng.host_tier_blocks(), eng.queue_wait_estimate(),
           [r.rid if r is not None else None for r in eng.slot_req],
           {rid: (r.shed, r.preemptions, r.output_tokens, r.queue_iters)
            for rid, r in eng.results.items()}]
    if eng.paged:
        out += [eng.block_tables.tolist(), eng._ref.tolist(),
                list(eng._free), list(eng._cached_free), eng._reserved,
                dict(eng.prefix_stats)]
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_overload_lockstep_with_jax(models, case):
    cfg, jp, tcfg, tp = models
    over, arrivals = CASES[case]
    over = dict(over, eos_id=None)
    jeng = _engine(cfg, jp, JaxEngine, **over)
    teng = _engine(tcfg, tp, **over)
    i = step = 0
    submitted = {"jax": [], "port": []}
    while i < len(arrivals) or jeng.busy() or teng.busy():
        while i < len(arrivals) and arrivals[i][0] <= step:
            r = arrivals[i][1]
            submitted["jax"].append(jeng.submit(JaxRequest(**r)))
            submitted["port"].append(teng.submit(ServeRequest(**r)))
            i += 1
        jeng.step()
        teng.step()
        step += 1
        assert _state(teng) == _state(jeng), f"diverged at step {step}"
        teng.assert_block_invariants()
        assert step < 3000
    assert submitted["port"] == submitted["jax"]
    st = teng.overload_stats
    shed = sum(1 for r in teng.results.values() if r.shed)
    assert len(teng.results) == len(arrivals)
    assert shed == st["shed"] == submitted["port"].count(False)
    assert all(r.output_tokens for r in teng.results.values() if not r.shed)
    assert teng.host_tier_blocks() == 0
    if case.startswith("preempt"):
        assert st["preempted"] >= 1
        assert st["swapped_out" if case == "preempt-swap"
                  else "recomputed"] >= 1
    if case.startswith("shed"):
        assert st["shed"] > 0
    if case == "hol-bypass":
        assert st["hol_bypass"] >= 1


def test_shed_disabled_by_default(models):
    _, _, tcfg, tp = models
    eng = _engine(tcfg, tp, n_max=1)
    for r in _stream(n_req=6, max_new=4, l_in_max=10):
        assert eng.submit(ServeRequest(**r))
    eng.run_to_completion(5000)
    assert eng.overload_stats["shed"] == 0
    assert not any(r.shed for r in eng.results.values())


def test_queue_wait_estimate_warmup(models):
    """0.0 before the first completion (never shed without evidence);
    then positive with a queue and bounded by depth / cumulative rate."""
    _, _, tcfg, tp = models
    eng = _engine(tcfg, tp, n_max=1)
    for r in _stream(n_req=4, max_new=5, l_in_max=12):
        eng.submit(ServeRequest(**r))
    assert eng.queue_wait_estimate() == 0.0
    while not eng.results:
        eng.step()
    est = eng.queue_wait_estimate()
    assert 0.0 < est <= len(eng.waiting) / (len(eng.results)
                                            / eng.iteration) + 1e-9


def test_des_engine_stability_boundary_agreement(models):
    """The port's engine and the port's DES agree on where the stability
    boundary sits: on the same MMPP arrival instants (iteration clock,
    t_iter = 1) both shed ~nothing at 0.4x the planned capacity and
    materially at 2.5x."""
    _, _, tcfg, tp = models
    n_req, c_chunk, wait = 30, 16, 25.0
    rng = np.random.default_rng(0)
    l_in = rng.integers(8, 30, size=n_req)
    l_out = rng.integers(3, 6, size=n_req)
    toks = [[int(t) for t in rng.integers(1, 900, li)] for li in l_in]
    lam_star = 3 / float(np.mean(np.ceil(l_in / c_chunk) + l_out))
    for mult, low in ((0.4, True), (2.5, False)):
        arr = np.maximum(1, np.ceil(mmpp_arrivals(
            n_req, mult * lam_star, np.random.default_rng(7), 1.8, 40.0))
        ).astype(np.int64)
        eng = _engine(tcfg, tp, eos_id=None, max_queue_wait=wait)
        i = 0
        while i < n_req or eng.busy():
            while i < n_req and arr[i] <= eng.iteration:
                eng.submit(ServeRequest(i, toks[i], int(l_out[i])))
                i += 1
            eng.step()
        st = simulate_pool(arr.astype(float), l_in.astype(float),
                           l_out.astype(float), c_slots=3, t_iter=1.0,
                           t_chunk=1.0, c_chunk=c_chunk, warmup=0.0,
                           max_queue_wait=wait)
        e_frac = eng.overload_stats["shed"] / n_req
        d_frac = st.shed / n_req
        assert len(eng.results) == n_req
        if low:
            assert e_frac <= 0.05 and d_frac <= 0.05, (e_frac, d_frac)
        else:
            assert e_frac > 0.05 and d_frac > 0.05, (e_frac, d_frac)


def test_fleet_surfaces_shed_and_preemptions_like_jax(models):
    """FleetRuntime passes the overload knobs to every engine; run()
    returns shed requests (no tokens) and preemption counts, as the JAX
    runtime does on the same stream."""
    cfg, jp, tcfg, tp = models
    kw = dict(boundaries=(64,), gammas=(1.5,), n_maxes=(1, 1),
              c_maxes=(64, 128), c_chunk=16, paged=True, kv_block_size=16,
              preemption=True, max_queue_wait=2.0)
    outs = []
    for rt_cls, req_cls, c, p, impl in (
            (JPools.FleetRuntime, JPools.GatewayRequest, cfg, jp, "xla"),
            (TPools.FleetRuntime, TPools.GatewayRequest, tcfg, tp, "torch")):
        rt = rt_cls(c, p, decode_impl=impl, **kw)
        for eng in rt.engines.values():
            assert eng.preemption and eng.max_queue_wait == 2.0
        rng = np.random.default_rng(0)
        rid = 0
        for _ in range(8):
            for _ in range(3):
                text = "".join(chr(97 + int(x))
                               for x in rng.integers(0, 26, 40))
                rt.submit(req_cls(rid, text, 6))
                rid += 1
            for eng in rt.engines.values():
                for _ in range(2):
                    if eng.busy():
                        eng.step()
        out = rt.run(max_iters=5000)
        assert len(out) == rid
        outs.append({k: (v.pool, v.shed, v.preemptions, v.output_tokens,
                         v.timed_out) for k, v in sorted(out.items())})
    assert outs[1] == outs[0]
    assert any(v[1] for v in outs[1].values()), "the stream never shed"
    assert all(bool(v[3]) != v[1] for v in outs[1].values())


def test_launcher_prints_jax_overload_lines(monkeypatch):
    cfg = reduced_f32("minitron-8b")
    params = jax.tree.map(np.asarray,
                          M.init_params(cfg, jax.random.PRNGKey(0)))
    got, ref = _launcher_lines(
        ["--reduced", "--fleet", "2", "--paged", "--decode-k", "4",
         "--spec-k", "4", "--preemption", "--max-queue-wait", "8"],
        monkeypatch, params)
    assert got == ref
    assert sum("overload preempted=" in ln for ln in got) == 2
