"""The port's ref-counted prefix cache (repro_torch.serving.engine with
``paged=True, prefix_cache=True``), held to the JAX engine.

Both engines run reduced minitron-8b in f32 on the same weights (the JAX
parameters carried across with ``params.from_jax_numpy``) and serve the
same requests in lockstep, wave after wave (a wave is submitted once both
engines are idle, like the turns of a session). After every step the two
engines hold the same block tables, refcounts, free list, LRU tier,
reservation and ``prefix_stats``, and both pass ``assert_block_invariants``;
at the end they have emitted the same tokens with the same
``prefill_iters``. The cases are the port's counterparts of
tests/test_prefix_cache.py's engine and runtime tests, plus what each of
those pinned within the JAX engine (cold-start and dense parity, the
suffix-only allocation, the decref on release, eviction, capacity).
"""
import dataclasses

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
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import InferenceEngine, ServeRequest

BS = 16                                  # block size used throughout
PREFIX = list(range(100, 148))           # 48 tokens = 3 full blocks


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one intra-op
    thread per worker keeps these small-shape tests from oversubscribing
    the cores the other workers' tests time themselves on."""
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


def _req(rid, tokens, n):
    return dict(rid=rid, tokens=[int(t) for t in tokens], max_new_tokens=n)


def _mixed_stream():
    rng = np.random.default_rng(0)
    out = []
    for rid in range(6):
        toks = PREFIX[:32] if rid % 2 else \
            rng.integers(1, 900, int(rng.integers(3, 40)))
        out.append(_req(rid, toks, int(rng.integers(2, 6))))
    return out


# name -> (engine overrides, waves of requests)
CASES = {
    # two turns sharing 3 full blocks: the second maps them, allocates
    # only its suffix block and prefills one chunk
    "shared-prefix": (dict(), [[_req(0, PREFIX + [7, 8, 9], 6)],
                               [_req(1, PREFIX + [11, 12], 5)]]),
    # overlapping shared-prefix and unrelated requests in one batch
    "concurrent": (dict(), [[_req(0, PREFIX + [7, 8, 9], 6),
                             _req(1, PREFIX + [11, 12], 5),
                             _req(2, range(1, 40), 4),
                             _req(3, PREFIX[:32], 5)]]),
    # a prompt made only of cached full blocks: no prefill at all
    "fully-cached": (dict(), [[_req(0, PREFIX, 4)], [_req(1, PREFIX, 4)]]),
    # one holder of a shared prefix finishes while the other decodes
    "release-decref": (dict(), [[_req(99, PREFIX + [1], 2)],
                                [_req(0, PREFIX + [7], 2),
                                 _req(1, PREFIX + [9], 12)]]),
    "refcount-mix": (dict(n_max=3, c_max=64, num_blocks=12),
                     [_mixed_stream()]),
    # distinct prompts through a 4-block pool evict LRU cached prefixes
    "lru-eviction": (dict(n_max=1, c_max=64, num_blocks=4),
                     [[_req(r, range(r * 50, r * 50 + 33), 3)
                       for r in range(4)]]),
    # a pool full of ref-0 cached blocks still admits a whole-pool request
    "cached-free-capacity": (dict(n_max=1, num_blocks=5),
                             [[_req(0, PREFIX + [1], 2)],
                              [_req(1, range(200, 264), 12)]]),
    # pinning 2 evictable hits is charged: the warm request must defer
    # behind the cold one instead of over-committing its reservation
    "no-overcommit": (dict(num_blocks=5),
                      [[_req(9, PREFIX[:32], 2)],
                       [_req(0, range(200, 232), 16),
                        _req(1, PREFIX[:32], 16)]]),
}


def _kw(**over):
    return dict(dict(n_max=2, c_max=128, c_chunk=16, paged=True,
                     block_size=BS, prefix_cache=True), **over)


def _allocator(eng):
    return (eng.iteration, eng.block_tables.tolist(), eng._ref.tolist(),
            list(eng._free), list(eng._cached_free), eng._reserved,
            dict(eng.prefix_stats),
            [r.rid if r is not None else None for r in eng.slot_req])


def _port_tokens(tcfg, tp, waves, **kw):
    eng = InferenceEngine(tcfg, tp, decode_impl="torch", **kw)
    for wave in waves:
        for r in wave:
            eng.submit(ServeRequest(**r))
        eng.run_to_completion(2000)
    return {rid: r.output_tokens for rid, r in eng.results.items()}


def _decref_probe(eng, seen):
    """While both sharers are admitted they share the 3 prefix blocks;
    once the short one finished, those blocks stay referenced."""
    if eng.slot_req.count(None) == 0 and "shared" not in seen:
        assert eng._slot_blocks[0][:3] == eng._slot_blocks[1][:3]
        seen["shared"] = list(eng._slot_blocks[0][:3])
    if 0 in eng.results and 1 not in eng.results:
        assert not set(seen["shared"]) & set(eng._free)
        assert all(eng._ref[p] >= 1 for p in seen["shared"])
        seen["checked"] = True


@pytest.mark.parametrize("case,impl", [
    ("shared-prefix", ("xla", "torch")), ("shared-prefix", ("pallas", "kernel")),
    ("concurrent", ("xla", "torch")), ("fully-cached", ("xla", "torch")),
    ("release-decref", ("xla", "torch")), ("refcount-mix", ("xla", "torch")),
    ("lru-eviction", ("xla", "torch")),
    ("cached-free-capacity", ("xla", "torch")),
    ("no-overcommit", ("xla", "torch"))],
    ids=lambda v: v if isinstance(v, str) else "-".join(v))
def test_prefix_cache_lockstep_with_jax(models, case, impl):
    cfg, jp, tcfg, tp = models
    over, waves = CASES[case]
    jeng = JaxEngine(cfg, jp, decode_impl=impl[0], **_kw(**over))
    teng = InferenceEngine(tcfg, tp, decode_impl=impl[1], **_kw(**over))
    seen = {}
    for w, wave in enumerate(waves):
        for r in wave:
            jeng.submit(JaxRequest(**r))
            teng.submit(ServeRequest(**r))
        while jeng.busy() or teng.busy():
            assert teng.iteration < 2000
            jeng.step()
            teng.step()
            jeng.assert_block_invariants()
            teng.assert_block_invariants()
            assert _allocator(teng) == _allocator(jeng)
            if case == "release-decref" and w == 1:
                _decref_probe(teng, seen)
        if w == 0 and case == "cached-free-capacity":
            assert teng.prefix_cache_blocks() == 3
        if w == 0 and case == "no-overcommit":
            assert len(teng._cached_free) == 2
    got = {rid: (r.output_tokens, r.prefill_iters, r.queue_iters)
           for rid, r in teng.results.items()}
    want = {rid: (r.output_tokens, r.prefill_iters, r.queue_iters)
            for rid, r in jeng.results.items()}
    assert got == want
    n_req = sum(len(w) for w in waves)
    assert len(got) == n_req and all(t for t, _, _ in got.values())
    st, res = teng.prefix_stats, teng.results
    # the port against itself: cold engines (no prefix cache), or dense
    if case in ("shared-prefix", "fully-cached", "concurrent"):
        cold = _port_tokens(tcfg, tp, [[r] for w in waves for r in w],
                            **_kw(prefix_cache=False))
        dense = _port_tokens(tcfg, tp, waves, n_max=2, c_max=128, c_chunk=16)
        toks = {rid: t for rid, (t, _, _) in got.items()}
        assert toks == cold == dense
    if case == "shared-prefix":
        # turn 2's worst case is ceil((48 + 2 + 5) / 16) = 4 blocks: 3
        # mapped, 1 allocated (turn 1 allocated 4), one prefill chunk
        assert st["hit_blocks"] == len(PREFIX) // BS
        assert st["allocated_blocks"] == 4 + 1
        assert res[1].prefill_iters == 1
    elif case == "fully-cached":
        assert res[1].prefill_iters == 0
    elif case == "release-decref":
        assert seen.get("checked") and len(res[1].output_tokens) == 12
    elif case == "refcount-mix":
        assert int(teng._ref.sum()) == 0 and teng._reserved == 0
        assert len(teng._free) + len(teng._cached_free) == teng.num_blocks
        assert teng.kv_tokens_held() == 0
    elif case == "lru-eviction":
        assert st["evicted_blocks"] > 0
    elif case == "cached-free-capacity":
        assert len(res[1].output_tokens) == 12
    elif case == "no-overcommit":
        assert res[1].queue_iters > res[0].queue_iters
    assert teng.free_block_count() == teng.num_blocks


def test_prefix_cache_requires_paged(models):
    _, _, tcfg, tp = models
    with pytest.raises(ValueError, match="paged"):
        InferenceEngine(tcfg, tp, n_max=2, c_max=64, prefix_cache=True)
    eng = InferenceEngine(tcfg, tp, 2, 64, config=ServingConfig(
        paged=True, prefix_cache=True))
    assert eng.prefix_cache and eng.prefix_cache_blocks() == 0


def test_fleet_runtime_session_matches_jax(models):
    """TwoPoolRuntime with the prefix cache: a two-turn session is pinned
    to its pool on turn 2, hits the cache there, and emits the tokens of
    the JAX runtime and of the runtime without the cache."""
    cfg, jp, tcfg, tp = models
    text = "tool call result: " * 12          # deterministic tokenization
    kw = dict(b_short=64, gamma=1.5, n_max_short=2, n_max_long=2,
              c_max_long=256, c_chunk=16, paged=True)
    outs = {}
    for side, rt_cls, req_cls, params, impl in (
            ("jax", JPools.TwoPoolRuntime, JPools.GatewayRequest, jp, "xla"),
            ("port", TPools.TwoPoolRuntime, TPools.GatewayRequest, tp,
             "torch")):
        for enabled in (False, True):
            c = cfg if side == "jax" else tcfg
            rt = rt_cls(c, params, decode_impl=impl, prefix_cache=enabled,
                        **kw)
            res = {}
            for turn, t in enumerate((text, text + " next step please")):
                rt.submit(req_cls(rid=turn, text=t, max_output_tokens=4,
                                  session="agent-1"))
                res.update(rt.run(max_iters=5000))
            outs[side, enabled] = (
                {k: (v.pool, v.output_tokens, v.prefill_iters)
                 for k, v in res.items()},
                rt.router.stats.affinity_pinned,
                {n: dict(e.prefix_stats) for n, e in rt.engines.items()})
    assert outs["port", True] == outs["jax", True]
    assert outs["port", False] == outs["jax", False]
    tokens = {e: {k: v[1] for k, v in outs["port", e][0].items()}
              for e in (False, True)}
    assert tokens[False] == tokens[True]
    res, pinned, stats = outs["port", True]
    assert pinned == 1
    assert stats["short"]["hit_blocks"] > 0
    assert res[1][2] < outs["port", False][0][1][2]   # fewer prefill iters
