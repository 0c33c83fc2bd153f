"""The port's serving engine (repro_torch.serving.engine).

Against the JAX engine: on the request stream of
tests/test_decode_consistency.py (``_stream``/``_run_engine``: n_max=3,
c_max=128, c_chunk=16, eos 7), the port emits the JAX engine's tokens,
for decode_impl xla <-> torch and pallas <-> kernel, dense and paged.
The models run in f32 on both sides; greedy tokens are compared exactly.

Within the port, bitwise: paged == dense, decode_k=4 == decode_k=1, an
EOS that fires mid micro-loop; the later slices' knobs refused.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import reduced_f32
from jax_compile_cache import jax_compile_cache  # noqa: F401
from repro.models import model as M
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.engine import ServeRequest as JaxRequest
from repro_torch import params as P
from repro_torch.configs.base import get_config
from repro_torch.distributed.context import ParallelContext
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as TM
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import (InferenceEngine, ServeRequest,
                                        prefill_buckets)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one intra-op
    thread per worker keeps these small-shape tests from oversubscribing
    the cores the other workers' tests time themselves on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


EOS = 7


@pytest.fixture(scope="module")
def models():
    cfg = reduced_f32("minitron-8b", num_kv_heads=2)
    jp = M.init_params(cfg, jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_config("minitron-8b").reduced(),
                               dtype="float32", num_kv_heads=2)
    tp = P.from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tcfg, tp


def _stream(seed=42, n_req=6, max_new=12, l_in_max=40):
    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(n_req):
        l_in = int(rng.integers(3, l_in_max))
        reqs.append(dict(rid=rid,
                         tokens=[int(t) for t in rng.integers(1, 900, l_in)],
                         max_new_tokens=int(rng.integers(2, max_new))))
    return reqs


def _run(engine_cls, request_cls, cfg, params, reqs, **kw):
    kw = dict(dict(n_max=3, c_max=128, c_chunk=16, eos_id=EOS), **kw)
    eng = engine_cls(cfg, params, **kw)
    for r in reqs:
        eng.submit(request_cls(**r))
    res = eng.run_to_completion(5000)
    return {rid: r.output_tokens for rid, r in sorted(res.items())}, eng


def _layout(paged):
    return dict(paged=True, block_size=16) if paged else {}


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("impl", [("xla", "torch"), ("pallas", "kernel")],
                         ids=["xla-torch", "pallas-kernel"])
def test_tokens_match_jax_engine(models, impl, paged):
    cfg, jp, tcfg, tp = models
    reqs = _stream()
    ref, _ = _run(JaxEngine, JaxRequest, cfg, jp, reqs, decode_impl=impl[0],
                  decode_k=4, **_layout(paged))
    for k in (1, 4):
        got, eng = _run(InferenceEngine, ServeRequest, tcfg, tp, reqs,
                        decode_impl=impl[1], decode_k=k, **_layout(paged))
        assert got == ref, f"decode_k={k} diverged from the JAX engine"
    assert eng.dispatches_per_token() <= 0.25
    eng.assert_block_invariants()


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_paged_equals_dense_and_k_equals_1(models, impl):
    _, _, tcfg, tp = models
    reqs = _stream(seed=3, n_req=7, max_new=20, l_in_max=60)
    base, _ = _run(InferenceEngine, ServeRequest, tcfg, tp, reqs,
                   decode_impl=impl, decode_k=1)
    for paged in (False, True):
        for k in (1, 4, 8):
            got, _ = _run(InferenceEngine, ServeRequest, tcfg, tp, reqs,
                          decode_impl=impl, decode_k=k, **_layout(paged))
            assert got == base, f"paged={paged} decode_k={k}"


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_eos_terminates_mid_micro_loop(models, paged):
    """EOS by construction: run once without EOS, take the token one
    request emits at its 3rd decode step as eos_id, and rerun with
    decode_k=4. That request must stop right after emitting it (mid
    micro-loop), and every request must match the decode_k=1 rerun."""
    _, _, tcfg, tp = models
    reqs = _stream(seed=11, n_req=4, max_new=14)
    for r in reqs:
        r["max_new_tokens"] = 12
    free, _ = _run(InferenceEngine, ServeRequest, tcfg, tp, reqs,
                   eos_id=None, **_layout(paged))
    rid = 1
    eos = free[rid][2]
    cut = free[rid].index(eos) + 1
    assert cut < 12, "the EOS token must stop the request early"
    k1, _ = _run(InferenceEngine, ServeRequest, tcfg, tp, reqs, eos_id=eos,
                 decode_k=1, **_layout(paged))
    k4, eng = _run(InferenceEngine, ServeRequest, tcfg, tp, reqs, eos_id=eos,
                   decode_k=4, **_layout(paged))
    assert k4 == k1
    assert k4[rid] == free[rid][:cut]
    assert eng.decode_dispatches < sum(len(t) for t in k4.values())


def test_hol_bypass_matches_jax_engine(models):
    """A paged pool too small for the FIFO head's worst case defers it;
    hol_window admits the next, smaller request out of order — the same
    schedule, and tokens, as the JAX engine."""
    cfg, jp, tcfg, tp = models
    rng = np.random.default_rng(7)
    sizes = [(60, 30), (50, 20), (10, 6), (12, 5)]
    reqs = [dict(rid=i, tokens=[int(t) for t in rng.integers(1, 900, n)],
                 max_new_tokens=m) for i, (n, m) in enumerate(sizes)]
    kw = dict(paged=True, block_size=16, num_blocks=8, decode_k=4)
    ref, jeng = _run(JaxEngine, JaxRequest, cfg, jp, reqs,
                     decode_impl="xla", **kw)
    got, eng = _run(InferenceEngine, ServeRequest, tcfg, tp, reqs,
                    decode_impl="torch", **kw)
    assert got == ref
    assert eng.overload_stats["hol_bypass"] \
        == jeng.overload_stats["hol_bypass"] > 0
    assert eng.free_block_count() == 8


def test_near_capacity_request_fills_context(models):
    """prompt + max_new == c_max: the last prefill chunk overhangs the
    cache end, and decode runs to the last position."""
    cfg, jp, tcfg, tp = models
    rng = np.random.default_rng(9)
    reqs = [dict(rid=0, tokens=[int(t) for t in rng.integers(1, 900, 120)],
                 max_new_tokens=8)]
    ref, _ = _run(JaxEngine, JaxRequest, cfg, jp, reqs, eos_id=None,
                  decode_impl="xla")
    got, eng = _run(InferenceEngine, ServeRequest, tcfg, tp, reqs,
                    eos_id=None, decode_impl="torch", decode_k=4)
    assert got == ref and len(got[0]) == 8


def test_oversized_request_is_refused(models):
    _, _, tcfg, tp = models
    reqs = [dict(rid=0, tokens=[1] * 120, max_new_tokens=9),
            dict(rid=1, tokens=[5, 6, 7], max_new_tokens=2)]
    got, eng = _run(InferenceEngine, ServeRequest, tcfg, tp, reqs)
    assert got[0] == [] and len(got[1]) == 2
    assert not eng.busy()


def test_inactive_slot_rows_stay_bit_identical(models):
    """A slot that is never admitted keeps its (random) cache row bit for
    bit while the other slots prefill and decode."""
    _, _, tcfg, tp = models
    eng = InferenceEngine(tcfg, tp, n_max=3, c_max=128, c_chunk=16,
                          decode_k=4)
    eng.cache["kv"]["k"].normal_()
    row = eng.cache_row(2)["kv"]["k"].clone()
    for r in _stream(n_req=2):
        eng.submit(ServeRequest(**r))
    eng.run_to_completion(500)
    assert eng.slot_req[2] is None
    assert (eng.cache_row(2)["kv"]["k"] == row).all()


def test_utilization_and_counters(models):
    _, _, tcfg, tp = models
    got, eng = _run(InferenceEngine, ServeRequest, tcfg, tp, _stream(),
                    decode_k=4)
    assert 0.0 < eng.utilization_snapshot() <= 1.0
    snap = eng.utilization_snapshot(detail=True)
    assert snap["queue_depth"] == 0 and "hol_bypass" in snap
    assert eng.decode_tokens_emitted == sum(len(t) for t in got.values())
    assert eng.dispatches >= eng.decode_dispatches > 0
    assert eng.prefill_buckets_used <= set(prefill_buckets(16))


_TP3 = Mesh(np.arange(3).reshape(1, 3), ("data", "model"))


@pytest.mark.parametrize("knob", [
    dict(spec_k=4),
    dict(preemption=True), dict(max_queue_wait=8.0),
    dict(swap_threshold=16), dict(lout_routing=True),
    dict(mesh=Mesh(np.array([[1]]), ("data", "model"))),
    dict(parallel=ParallelContext(mesh=_TP3), mesh=_TP3),
    dict(autoscale=True)],
    ids=lambda kw: next(iter(kw)))
def test_later_slice_knobs_raise(models, knob):
    """A tp degree the heads do not divide (the sequence / block
    fallback) raises, naming its later slice; a mesh of ranks outside the
    process group is refused; the speculation, overload, output-length
    and autoscale knobs, ported since, serve a request."""
    _, _, tcfg, tp = models
    if next(iter(knob)) == "mesh":
        with pytest.raises(ValueError, match="outside the 1-rank process"):
            InferenceEngine(tcfg, tp, 2, 64, config=ServingConfig(**knob))
        return
    if next(iter(knob)) == "parallel":
        with pytest.raises(NotImplementedError, match="not ported.*slice"):
            InferenceEngine(tcfg, tp, 2, 64, config=ServingConfig(**knob))
        return
    eng = InferenceEngine(tcfg, tp, 2, 64, config=ServingConfig(**knob))
    eng.submit(ServeRequest(rid=0, tokens=[5, 6, 7], max_new_tokens=4))
    assert len(eng.run_to_completion(100)[0].output_tokens) == 4


def test_decode_impl_values():
    assert ServingConfig().decode_impl == "kernel"
    with pytest.raises(ValueError, match="decode_impl"):
        ServingConfig(decode_impl="pallas")


def test_port_init_params_engine_runs(models):
    """The port's own random weights (torch.Generator) serve end to end."""
    _, _, tcfg, _ = models
    tp = TM.init_params(tcfg, seed=1, device="cpu")
    got, eng = _run(InferenceEngine, ServeRequest, tcfg, tp,
                    _stream(n_req=3), decode_k=4, paged=True, block_size=16)
    assert all(len(t) > 0 for t in got.values())
    assert eng.free_block_count() == eng.num_blocks
