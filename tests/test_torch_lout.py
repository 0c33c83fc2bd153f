"""Output-length-aware serving in the port, held to the JAX package.

Both sides run reduced minitron-8b in f32 on the same weights (the JAX
parameters carried across with ``params.from_jax_numpy``).

* ``lout_reservation``: paged admission reserves a fresh request's
  predicted footprint (``l_out_hint``) instead of its max_new_tokens worst
  case, which multiplies admission concurrency when callers over-claim;
  a request that outruns its hint preempts (``_reservation_breach``) and
  never runs the pool dry. The port steps in lockstep with the JAX engine
  (allocator, queue, host tier, ``overload_stats`` and results equal after
  every step), and its tokens equal the worst-case run's.
* ``lout_routing``: the gateway bands by PREDICTED output length and
  clamps the generation budget to the chosen pool's context; the port's
  FleetRuntime makes the JAX runtime's decisions and engine requests.
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
from repro.core import workload as JW
from repro.models import model as M
from repro.serving import pools as JPools
from repro.serving.config import ServingConfig as JaxConfig
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.engine import ServeRequest as JaxRequest
from repro_torch import params as P
from repro_torch.configs.base import get_config
from repro_torch.core import workload as TW
from repro_torch.serving import pools as TPools
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import InferenceEngine, ServeRequest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_overload import _state  # noqa: E402


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


def _engines(models, num_blocks, lout_reservation, n_max=4, decode_k=1):
    cfg, jp, tcfg, tp = models
    kw = dict(paged=True, block_size=8, num_blocks=num_blocks,
              preemption=True, lout_reservation=lout_reservation,
              decode_k=decode_k)
    return (JaxEngine(cfg, jp, n_max, 128, 16, config=JaxConfig(**kw)),
            InferenceEngine(tcfg, tp, n_max, 128, 16,
                            config=ServingConfig(decode_impl="torch", **kw)))


def _lockstep(jeng, teng, reqs):
    """Serve ``reqs`` on both engines in lockstep, comparing their state
    after every step; returns the port's tokens and the admitted-slot
    count after the first step."""
    for r in reqs:
        jeng.submit(JaxRequest(**r))
        teng.submit(ServeRequest(**r))
    first = None
    while jeng.busy() or teng.busy():
        jeng.step()
        teng.step()
        if first is None:
            first = sum(r is not None for r in teng.slot_req)
        assert _state(teng) == _state(jeng), f"step {teng.iteration}"
        teng.assert_block_invariants()
        assert teng.iteration < 10_000
    return {r: v.output_tokens for r, v in sorted(teng.results.items())}, \
        first


@pytest.mark.parametrize("decode_k", [1, 4])
def test_hints_multiply_admission_concurrency(models, decode_k):
    """Three requests each claim max_new = 96 (worst case 14 blocks of 8).
    With 20 blocks, worst-case admission fits one at a time; a hint of 8
    tokens (3 blocks each) admits all three at once. They then outrun the
    hints: breach preemptions absorb it, and the tokens are the
    worst-case run's."""
    reqs = [dict(rid=i, tokens=[5 + i] * 10, max_new_tokens=96, l_out_hint=8)
            for i in range(3)]
    out = {}
    for lout in (False, True):
        jeng, teng = _engines(models, 20, lout, decode_k=decode_k)
        out[lout] = _lockstep(jeng, teng, reqs) + (
            teng.overload_stats["reservation_breach"],)
        assert all(len(r.output_tokens) == 96 and not r.shed
                   for r in teng.results.values())
    (worst, conc_worst, b_worst), (hint, conc_hint, b_hint) = \
        out[False], out[True]
    assert conc_worst == 1 and conc_hint == 3
    assert b_worst == 0 and b_hint >= 1
    assert hint == worst


def test_no_hint_means_worst_case(models):
    _, teng = _engines(models, 20, True)
    for i in range(3):
        teng.submit(ServeRequest(rid=i, tokens=[5 + i] * 10,
                                 max_new_tokens=96))
    teng.step()
    assert sum(r is not None for r in teng.slot_req) == 1


def test_breach_preempts_never_runs_dry(models):
    """Hints of 4 tokens against 40 decoded: 12 blocks for 21 of true
    demand, so the free pool dries up mid-decode and breach preemption
    serializes the overrun; never an allocator failure, and the tokens of
    the worst-case run."""
    reqs = [dict(rid=i, tokens=[5 + i] * 12, max_new_tokens=40, l_out_hint=4)
            for i in range(3)]
    jeng, teng = _engines(models, 12, False)
    worst, _ = _lockstep(jeng, teng, reqs)
    jeng, teng = _engines(models, 12, True)
    got, _ = _lockstep(jeng, teng, reqs)
    assert got == worst and all(len(t) == 40 for t in got.values())
    st = teng.overload_stats
    assert st["reservation_breach"] >= 1 and st["preempted"] >= 1
    assert teng.host_tier_blocks() == 0


def test_generous_hint_never_breaches(models):
    _, teng = _engines(models, 48, True)
    teng.submit(ServeRequest(rid=0, tokens=[3] * 12, max_new_tokens=16,
                             l_out_hint=16))
    res = teng.run_to_completion(max_iters=5_000)
    assert len(res[0].output_tokens) == 16
    assert teng.overload_stats["reservation_breach"] == 0


def test_lout_routing_bands_and_clamps_like_jax(models):
    """A short prompt with an inflated max_tokens claim: worst-case banding
    sends it long; with lout_routing it stays short, its budget clamped to
    the short pool's context, and with lout_reservation it carries the
    prediction as its hint. Every decision, engine request and token is
    the JAX runtime's."""
    cfg, jp, tcfg, tp = models
    text = "short prompt inflated claim " * 4
    texts = [(0, text, 200), (1, "tool call " * 30, 500),
             (2, text + "and more " * 20, 40)]

    def serve(side, **kw):
        if side == "jax":
            rt_cls, req_cls, c, p, scfg = (
                JPools.FleetRuntime, JPools.GatewayRequest, cfg, jp,
                JaxConfig(paged=True, preemption=True, **kw))
            pred = JW.OutputLenPredictor.from_workload(
                JW.get_workload("lmsys"))
        else:
            rt_cls, req_cls, c, p, scfg = (
                TPools.FleetRuntime, TPools.GatewayRequest, tcfg, tp,
                ServingConfig(paged=True, preemption=True,
                              decode_impl="torch", **kw))
            pred = TW.OutputLenPredictor.from_workload(
                TW.get_workload("lmsys"))
        rt = rt_cls(c, p, boundaries=(64,), gammas=(1.2,), n_maxes=(2, 2),
                    c_maxes=(96, 256), c_chunk=16, config=scfg,
                    lout_predictor=pred)
        seen = []
        for eng in rt.engines.values():
            submit = eng.submit

            def spy(req, submit=submit):
                seen.append((req.rid, len(req.tokens), req.max_new_tokens,
                             req.l_out_hint))
                return submit(req)
            eng.submit = spy
        decisions = [rt.submit(req_cls(rid, t, n)).pool
                     for rid, t, n in texts]
        res = rt.run(max_iters=5_000)
        return (decisions, seen,
                {k: (v.pool, v.output_tokens, v.shed)
                 for k, v in sorted(res.items())})

    worst = serve("port")
    assert worst == serve("jax")
    assert worst[0][0] == "long"               # worst-case banding
    got = serve("port", lout_routing=True, lout_reservation=True)
    assert got == serve("jax", lout_routing=True, lout_reservation=True)
    decisions, seen, res = got
    assert decisions[0] == "short"             # predicted banding
    rid, n_ids, max_new, hint = seen[0]
    assert n_ids + max_new <= 96 and 1 <= hint <= max_new
    assert 1 <= len(res[0][1]) <= max_new and not res[0][2]
