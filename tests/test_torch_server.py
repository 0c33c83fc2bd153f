"""The port's serving gateway, metrics and closed-loop re-planner against
the JAX package's (the twin of ``tests/test_server.py``).

Both gateways serve reduced minitron-8b in f32 on the same weights (the
JAX parameters carried across with ``params.from_jax_numpy``). Each test
sends the same requests to a JAX gateway and to a port gateway, holds
both to the reference test's own checks, and then holds the port's
answers equal to JAX's, exactly: SSE token ids and flush counts, the
``fleetopt`` annotation (all but the host-clock ``compression_ms``),
``/health`` (all but ``uptime_s``), every ``/metrics`` sample and the
``/admin/replan`` reports.

Beyond the twins: the autoscaler stepped in lockstep with JAX's (the
same ticks, actions, pool shapes, ``reprovision_stats`` and tokens), the
launcher's ``--smoke --chaos`` run in process, the engine counters the
scrape reads as Python scalars, the periodic re-plan loop, an engine
error surfacing from ``launch.serve.run_client`` instead of hanging it,
a kernel library loaded once when two threads reach it, and a pool
rebuilt under a live stream whose old engine the drive loop frees on
its next pass.
"""
import asyncio
import dataclasses
import json
import re

import jax
import numpy as np
import pytest
import torch

from conftest import reduced_f32
from jax_compile_cache import jax_compile_cache  # noqa: F401
from repro.core import planner as JP
from repro.core import workload as JW
from repro.models import model as JM
from repro.serving import config as JSC
from repro.serving import pools as JPools
from repro.serving import replanner as JRP
from repro.serving import server as JS
from repro_torch import params as P
from repro_torch.configs.base import get_config
from repro_torch.core import planner as TP
from repro_torch.core import workload as TW
from repro_torch.launch import serve as TL
from repro_torch.serving import config as TSC
from repro_torch.serving import metrics as TMetrics
from repro_torch.serving import pools as TPools
from repro_torch.serving import replanner as TRP
from repro_torch.serving import server as TS

DECODE_K = 4
MAX_TOKENS = 12
PROMPT = "gateway stream parity check " * 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes run the suite at once: one intra-op thread
    each keeps these small-shape tests from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """Reduced minitron-8b in f32: the JAX parameters and the port's copy
    of them."""
    cfg = reduced_f32("minitron-8b")
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_config("minitron-8b").reduced(),
                               dtype="float32")
    tp = P.from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return {"jax": (cfg, jp, JPools, JSC, JRP, JS),
            "torch": (tcfg, tp, TPools, TSC, TRP, TS)}


def make_runtime(side, **overrides):
    """The reference test's fleet: B = 64, gamma 1.4, two slots a pool,
    contexts 128 / 256, c_chunk 16, decode_k 4."""
    cfg, params, pools, config = side[:4]
    return pools.FleetRuntime(cfg, params, boundaries=(64,), gammas=(1.4,),
                              n_maxes=(2, 2), c_maxes=(128, 256), c_chunk=16,
                              config=config.ServingConfig(
                                  decode_k=DECODE_K, **overrides))


def on_both(models, coro_fn, *, replanner_kw=None, gateway_kw=None):
    """Run ``coro_fn(gw)`` against a JAX and a port gateway (each on an
    ephemeral port over a fresh runtime); returns {package: result}."""
    out = {}
    for name, side in models.items():
        rt = make_runtime(side)
        rp = None if replanner_kw is None else \
            side[4].Replanner(rt, **replanner_kw)

        async def main():
            gw = side[5].ServingGateway(rt, replanner=rp, port=0,
                                        **(gateway_kw or {}))
            await gw.start()
            try:
                return await coro_fn(gw)
            finally:
                await gw.stop()
        out[name] = asyncio.run(main())
    return out


def _strip(chunk: dict) -> dict:
    """A completion chunk without its host-clock fields."""
    chunk = dict(chunk)
    chunk.pop("created", None)
    if "fleetopt" in chunk:
        chunk["fleetopt"] = {k: v for k, v in chunk["fleetopt"].items()
                             if k != "compression_ms"}
    return chunk


def _samples(text: str) -> dict:
    """Every sample line of a scrape: 'name{labels}' -> value text."""
    return dict(ln.rsplit(" ", 1) for ln in text.splitlines()
                if ln and not ln.startswith("#"))


_call = TL._http_call
_sse_chunks = TL._parse_sse


# ------------------------------------------------------------------ health

def test_health(models):
    async def go(gw):
        status, headers, body = await _call(gw.host, gw.port, "GET",
                                            "/health")
        assert status == 200
        assert headers["content-type"] == "application/json"
        h = json.loads(body)
        assert h["status"] == "ok"
        assert set(h["pools"]) == {"short", "long"}
        assert h["boundaries"] == [64]
        for p in h["pools"].values():
            assert {"slots", "c_max", "occupancy",
                    "queue_depth"} <= set(p)
        assert h.pop("uptime_s") >= 0.0
        return h
    got = on_both(models, go)
    assert got["torch"] == got["jax"]


# --------------------------------------------------------------- 4xx paths

def test_structured_errors(models):
    async def go(gw):
        cases = [
            ("POST", "/v1/completions", b"{oops", 400, None),
            ("POST", "/v1/completions", b"[]", 400, None),
            ("POST", "/v1/completions", b'{"max_tokens": 4}', 400,
             "prompt"),
            ("POST", "/v1/completions",
             b'{"prompt": "x", "max_tokens": 0}', 400, "max_tokens"),
            ("POST", "/v1/completions",
             b'{"prompt": "x", "max_tokens": true}', 400, "max_tokens"),
            ("POST", "/v1/completions",
             b'{"prompt": "x", "stream": "yes"}', 400, "stream"),
            ("GET", "/v1/nope", b"", 404, None),
            ("GET", "/v1/completions", b"", 405, None),
            ("POST", "/health", b"", 405, None),
            ("POST", "/admin/replan", b"", 503, None),  # no replanner
        ]
        seen = []
        for method, path, body, want, param in cases:
            status, headers, raw = await _call(gw.host, gw.port, method,
                                               path, body)
            assert status == want, (method, path, status, raw[:200])
            assert headers["content-type"] == "application/json"
            err = json.loads(raw)["error"]
            assert {"message", "type", "param", "code"} <= set(err)
            if param is not None:
                assert err["param"] == param
            seen.append((status, err))
        status, _, raw = await _call(gw.host, gw.port, "GET", "/metrics")
        assert 'fleetopt_http_requests_total{method="POST",' \
            'path="/v1/completions",status="400"} 6' in raw.decode()
        return seen, _samples(raw.decode())
    got = on_both(models, go)
    assert got["torch"] == got["jax"]


# ----------------------------------------------------- SSE framing + parity

def test_sse_framing_flushes_and_parity(models):
    """One streaming completion: the reference's chunk shape, more than
    one flush, [DONE]; the port's chunks (ids per flush, the final
    annotation) equal JAX's, and its streamed ids equal the port's own
    offline drain of the same prompt."""
    async def go(gw):
        req = json.dumps({"prompt": PROMPT, "max_tokens": MAX_TOKENS,
                          "stream": True}).encode()
        status, headers, body = await _call(gw.host, gw.port, "POST",
                                            "/v1/completions", req)
        assert status == 200
        assert headers["content-type"] == "text/event-stream"
        chunks, done = _sse_chunks(body)
        assert done, "stream must terminate with data: [DONE]"
        for c in chunks:
            assert c["object"] == "text_completion"
            assert c["id"].startswith("cmpl-")
            choice = c["choices"][0]
            assert {"index", "text", "token_ids",
                    "finish_reason"} <= set(choice)
            assert choice["text"] == "".join(f" {t}"
                                             for t in choice["token_ids"])
        token_chunks = [c for c in chunks
                        if c["choices"][0]["finish_reason"] is None]
        assert len(token_chunks) > 1, "expected >1 flush unit"
        assert chunks[-1]["choices"][0]["finish_reason"] == "length"
        assert chunks[-1]["fleetopt"]["pool"] in ("short", "long")
        return [_strip(c) for c in chunks]

    got = on_both(models, go)
    assert got["torch"] == got["jax"]
    streamed = [t for c in got["torch"]
                if c["choices"][0]["finish_reason"] is None
                for t in c["choices"][0]["token_ids"]]
    assert len(streamed) == MAX_TOKENS
    rt = make_runtime(models["torch"])
    rt.submit(TPools.GatewayRequest(0, PROMPT, MAX_TOKENS))
    assert streamed == rt.run(max_iters=5_000)[0].output_tokens


def test_nonstream_matches_stream(models):
    async def go(gw):
        req = json.dumps({"prompt": PROMPT,
                          "max_tokens": MAX_TOKENS}).encode()
        status, _, body = await _call(gw.host, gw.port, "POST",
                                      "/v1/completions", req)
        assert status == 200
        r = json.loads(body)
        assert r["usage"]["completion_tokens"] == MAX_TOKENS
        assert r["usage"]["total_tokens"] == \
            r["usage"]["prompt_tokens"] + MAX_TOKENS
        req = json.dumps({"prompt": PROMPT, "max_tokens": MAX_TOKENS,
                          "stream": True}).encode()
        _, _, sse = await _call(gw.host, gw.port, "POST",
                                "/v1/completions", req)
        chunks, _ = _sse_chunks(sse)
        streamed = [t for c in chunks
                    for t in c["choices"][0]["token_ids"]]
        assert streamed == r["choices"][0]["token_ids"]
        return _strip(r), [_strip(c) for c in chunks]
    got = on_both(models, go)
    assert got["torch"] == got["jax"]


# ----------------------------------------------------------------- metrics

_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
                     r'(\{[a-zA-Z0-9_]+="[^"]*"'
                     r'(,[a-zA-Z0-9_]+="[^"]*")*\})? '
                     r'(-?\d+(\.\d+)?([eE][+-]?\d+)?|[+-]?Inf|NaN)$')


def test_metrics_prometheus_text(models):
    """/metrics parses line by line as Prometheus text, HELP/TYPE for
    every family, the dashboards' series present, no inf; and the port's
    scrape equals JAX's sample for sample."""
    async def go(gw):
        req = json.dumps({"prompt": PROMPT,
                          "max_tokens": MAX_TOKENS}).encode()
        await _call(gw.host, gw.port, "POST", "/v1/completions", req)
        status, headers, body = await _call(gw.host, gw.port, "GET",
                                            "/metrics")
        assert status == 200
        assert headers["content-type"].startswith("text/plain")
        text = body.decode()
        typed, helped = set(), set()
        for line in text.splitlines():
            if line.startswith("# TYPE "):
                name, mtype = line.split()[2:4]
                assert mtype in ("counter", "gauge"), line
                typed.add(name)
            elif line.startswith("# HELP "):
                helped.add(line.split()[2])
            elif line:
                m = _SAMPLE.match(line)
                assert m, f"unparsable sample line: {line!r}"
                assert m.group(1) in typed, f"sample before TYPE: {line}"
        assert typed == helped
        for needle in ('fleetopt_dispatches_total{pool="long"}',
                       'fleetopt_dispatches_total{pool="short"}',
                       'fleetopt_utilization{pool="short"}',
                       'fleetopt_boundary_tokens{index="0"} 64',
                       'fleetopt_gamma{index="0"} 1.4',
                       'fleetopt_requests_routed_total{pool=',
                       "fleetopt_completions_total 1",
                       "fleetopt_stream_tokens_total 12"):
            assert needle in text, f"missing {needle}"
        assert "inf" not in text and "Inf" not in text
        return text
    got = on_both(models, go)
    assert got["torch"] == got["jax"]


def test_metrics_read_python_scalars(models):
    """Every counter ``fleet_metrics`` and ``/health`` read off a port
    runtime is a Python number (a tensor would render as ``tensor(...)``
    and break the exposition), on a paged fleet with the prefix cache and
    speculation, after a repeat prompt has hit the cache."""
    rt = make_runtime(models["torch"], paged=True, prefix_cache=True,
                      spec_k=2, block_size=8)
    for rid in range(2):
        rt.submit(TPools.GatewayRequest(rid, PROMPT, 6))
        rt.run(max_iters=5_000)
    assert rt.engines["short"].prefix_stats["hit_blocks"] > 0
    for eng in rt.engines.values():
        snap = eng.utilization_snapshot(detail=True)
        for v in [*snap.values(), eng.dispatches, eng.decode_dispatches,
                  eng.decode_tokens_emitted, eng.dispatches_per_token(),
                  eng.kv_tokens_held(), eng.spec_kappa(), eng.iteration,
                  *eng.prefix_stats.values()]:
            assert type(v) in (int, float), (type(v), v)
    for m in TMetrics.fleet_metrics(rt):
        for _, v in m.samples:
            assert type(v) is float
    text = TMetrics.render_prometheus(TMetrics.fleet_metrics(rt))
    assert "tensor" not in text
    assert all(TL.METRIC_SAMPLE.match(ln) for ln in text.splitlines()
               if ln and not ln.startswith("#"))
    assert 'fleetopt_prefix_hit_blocks_total{pool="short"}' in text


# ---------------------------------------------------------- re-plan loop

def test_replan_moves_boundary_in_predicted_direction(models):
    """Closed loop: short-shifted traffic moves the live boundary DOWN,
    a long-shifted window moves it back UP; the port's re-plan reports
    and final scrape equal JAX's."""
    async def go(gw):
        async def burst(text, n, max_tokens=6):
            for i in range(n):
                req = json.dumps({"prompt": f"{text} {i} " * 4,
                                  "max_tokens": max_tokens}).encode()
                status, _, _ = await _call(gw.host, gw.port, "POST",
                                           "/v1/completions", req)
                assert status == 200

        async def replan():
            status, _, body = await _call(gw.host, gw.port, "POST",
                                          "/admin/replan")
            assert status == 200
            return json.loads(body)

        b0 = gw.runtime.router.boundaries[0]
        await burst("tiny", 6)
        rep1 = await replan()
        assert rep1["applied"], rep1
        b_short = gw.runtime.router.boundaries[0]
        assert b_short < b0, (b0, b_short)
        assert rep1["boundaries_after"] == [b_short]
        await burst("a much longer synthetic prompt that pushes the "
                    "empirical distribution toward the long pool", 8,
                    max_tokens=8)
        rep2 = await replan()
        b_long = gw.runtime.router.boundaries[0]
        assert b_long > b_short, (b_short, b_long, rep2)
        assert b_long <= list(gw.runtime.engines.values())[0].c_max
        _, _, body = await _call(gw.host, gw.port, "GET", "/metrics")
        assert f'fleetopt_boundary_tokens{{index="0"}} {b_long}' \
            in body.decode()
        assert "fleetopt_replan_applied_total 2" in body.decode()
        return rep1, rep2, body.decode()

    got = on_both(models, go,
                  replanner_kw=dict(min_observed=4, n_samples=1024,
                                    lam=50.0, decay=0.3, plan_scale=128.0))
    assert got["torch"] == got["jax"]


def test_replan_insufficient_data_is_a_noop(models):
    async def go(gw):
        b0 = list(gw.runtime.router.boundaries)
        status, _, body = await _call(gw.host, gw.port, "POST",
                                      "/admin/replan")
        rep = json.loads(body)
        assert status == 200 and not rep["applied"]
        assert "insufficient" in rep["reason"]
        assert list(gw.runtime.router.boundaries) == b0
        return rep
    got = on_both(models, go, replanner_kw=dict(min_observed=4))
    assert got["torch"] == got["jax"]


def test_periodic_replan_loop_ticks(models):
    """``replan_interval_s`` runs ticks on a timer while traffic flows;
    the scrape counts them."""
    async def go(gw):
        for i in range(3):
            req = json.dumps({"prompt": f"tick {i} " * 4,
                              "max_tokens": 4}).encode()
            status, _, _ = await _call(gw.host, gw.port, "POST",
                                       "/v1/completions", req)
            assert status == 200
        for _ in range(2_000):
            if gw.replanner.ticks >= 2:
                break
            await asyncio.sleep(0.005)
        assert gw.replanner.ticks >= 2
        _, _, body = await _call(gw.host, gw.port, "GET", "/metrics")
        n = float(_samples(body.decode())["fleetopt_replan_ticks_total"])
        assert n >= 2
        return gw.replanner.hist.observed
    got = on_both(models, go, replanner_kw=dict(min_observed=4),
                  gateway_kw=dict(replan_interval_s=0.02))
    assert got["torch"] == got["jax"] == 3


# ------------------------------------------------------------- autoscale

AUTOSCALE_LAM = 2.0        # fixed: lam_estimate reads the wall clock


def _autoscale_fleets(models):
    """The launcher's fleet (azure K=2 at lam 1000, 2 slots a pool,
    c_chunk 16, long context 512) with autoscale on, in both packages."""
    plans = {"jax": JP.plan_k_pool(JW.get_workload("azure"), lam=1000.0,
                                   t_slo=0.5, k=2),
             "torch": TP.plan_k_pool(TW.get_workload("azure"), lam=1000.0,
                                     t_slo=0.5, k=2)}
    out = {}
    for name, (cfg, params, pools, config, rp_mod, _) in models.items():
        plan = plans[name]
        rt = pools.FleetRuntime.from_plan(
            cfg, params, plan, slots_per_pool=2, c_chunk=16,
            ctx_scale=512 / plan.pools[-1].c_max,
            config=config.ServingConfig(decode_k=DECODE_K, autoscale=True,
                                        eos_id=None))
        out[name] = (rt, rp_mod.Replanner(rt, lam=AUTOSCALE_LAM,
                                          min_observed=4, n_samples=1024),
                     pools.GatewayRequest)
    return out


def _shapes(rt):
    return {n: (e.n_max, e.c_max) for n, e in rt.engines.items()}


def _round(rt):
    for name in list(rt.engines):
        if rt.engines[name].busy():
            rt.engines[name].step()


@pytest.mark.parametrize("words,grows", [(3, False), (36, True)],
                         ids=["rescale", "grow-and-rescale"])
def test_autoscale_lockstep_with_jax(models, words, grows):
    """Both runtimes with ``autoscale=True`` and one fixed planning rate:
    the same completions observed, then ticks while requests are in
    flight. Every tick's report (its ``autoscale_actions`` included) is
    equal, and so are the pools' (n_max, c_max), ``reprovision_stats`` and
    the tokens of the requests the rebuilds migrated. Short warm-up
    prompts make the first tick shrink both pools' slots to the plan's
    GPU counts; longer ones also grow the short pool's context."""
    sides = _autoscale_fleets(models)
    warm = [(i, f"warm {i} " * (words + 2 * i), 8) for i in range(6)]
    live = [(10, "live short request " * 3, 24),
            (11, "a long live request that migrates " * 14, 24)]
    results = {}
    for name, (rt, rp, req_cls) in sides.items():
        for rid, text, n in warm:
            rt.submit(req_cls(rid, text, n))
            rp.note_arrival()
        done = rt.run(max_iters=5_000)
        for rid, res in sorted(done.items()):
            rp.observe(len(rt.tokenizer.encode(warm[rid][1])),
                       len(res.output_tokens))
        decisions = [rt.submit(req_cls(rid, text, n))
                     for rid, text, n in live]
        for _ in range(4):
            _round(rt)
        in_flight = {r.rid for e in rt.engines.values()
                     for r in e.slot_req if r is not None}
        reports = [rp.tick()]
        shapes = [_shapes(rt)]
        for _ in range(3):
            _round(rt)
        reports.append(rp.tick())
        shapes.append(_shapes(rt))
        out = rt.run(max_iters=5_000)
        results[name] = dict(
            reports=reports, shapes=shapes, in_flight=in_flight,
            pools=[(d.pool, d.compressed) for d in decisions],
            stats=dict(rt.reprovision_stats),
            base=list(rt.plan_pool_gpus),
            tokens={rid: r.output_tokens for rid, r in out.items()})
    j, t = results["jax"], results["torch"]
    assert t == j
    assert t["in_flight"] == {10, 11}
    acts = t["reports"][0]["autoscale_actions"]
    assert acts and t["stats"]["autoscale_actions"] == len(acts) + len(
        t["reports"][1]["autoscale_actions"])
    assert t["stats"]["rebuilds"] >= len(acts)
    assert t["stats"]["migrated_requests"] >= 1
    assert [a.split()[0] for a in acts] == \
        ["grow"] * grows + ["rescale", "rescale"]
    assert t["shapes"][0]["long"] == (1, 512)
    assert (t["shapes"][0]["short"][1] > 64) == grows
    assert all(len(t["tokens"][rid]) == n for rid, _, n in live)


# -------------------------------------------------- launcher and drive loop

def test_launcher_smoke_chaos_in_process(capsys):
    """``--reduced --fleet 2 --smoke --chaos --device cpu``: the launcher's
    own assertions (streaming parity, 4xx, re-plan, /metrics, the kill,
    the 503 with Retry-After, the bitwise recovery) pass."""
    TL.main(["--reduced", "--fleet", "2", "--decode-k", "4", "--smoke",
             "--chaos", "--device", "cpu"])
    out = capsys.readouterr().out
    for needle in ("smoke SSE ok", "smoke parity ok", "smoke re-plan ok",
                   "smoke /metrics ok", "chaos: blackout 503 ok",
                   "chaos: killed stream completed bitwise",
                   "chaos: post-blackout retry ok",
                   "serve smoke passed"):
        assert needle in out, out


def test_run_client_raises_an_engine_error(models):
    """An engine step that raises anything but EngineDead stops the
    gateway's drive loop; ``run_client`` raises it instead of waiting out the
    client's request."""
    rt = make_runtime(models["torch"])

    def broken_step():
        raise RuntimeError("kernel launch failed")
    rt.engines["short"].step = broken_step
    gw = TS.ServingGateway(rt, port=0, request_timeout_s=1.0)

    async def client(gw):
        req = json.dumps({"prompt": "x y z", "max_tokens": 4}).encode()
        return await _call(gw.host, gw.port, "POST", "/v1/completions",
                           req)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        asyncio.run(TL.run_client(gw, client))


def test_kernel_library_loads_once_across_threads(monkeypatch):
    """The gateway's executor thread and its event loop may both reach a
    kernel first: the library is built and loaded by one of them only."""
    import threading
    import time

    from repro_torch.kernels.build import CudaKernel
    k = CudaKernel("probe", "probe_entry", [])
    loads = []

    def slow_load():
        loads.append(threading.get_ident())
        time.sleep(0.05)
        k._fn = object()
    monkeypatch.setattr(k, "_load", slow_load)
    got = []
    threads = [threading.Thread(target=lambda: got.append(k.function()))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert len(loads) == 1 and len(got) == 8 and len(set(map(id, got))) == 1


def test_rebuilt_engine_freed_by_the_drive_loops_next_pass(models):
    """A pool rebuilt under the gateway lock while a stream decodes on it:
    the drive loop's variable keeps the old engine (and its cache) until
    its next pass, and no longer; the stream completes with the tokens
    of an unfaulted run."""
    import gc

    from repro_torch.serving.engine import InferenceEngine
    rt = make_runtime(models["torch"])
    prompt = "rebuild under a stream " * 8

    def alive():
        gc.collect()
        return sum(type(o) is InferenceEngine and o.params is rt.params_for(None)
                   for o in gc.get_objects())

    async def go(gw):
        body = {"prompt": prompt, "max_tokens": 24}
        _, _, raw = await _call(gw.host, gw.port, "POST", "/v1/completions",
                                json.dumps(body).encode())
        ref = json.loads(raw)
        pool = ref["fleetopt"]["pool"]
        task = asyncio.ensure_future(_call(
            gw.host, gw.port, "POST", "/v1/completions",
            json.dumps(dict(body, stream=True)).encode()))
        n0 = gw.tokens_streamed
        while gw.tokens_streamed == n0 and not task.done():
            await asyncio.sleep(0.001)
        assert not task.done()
        async with gw._lock:
            gw.runtime.reprovision(pool, n_max=1)
            held = alive()
        _, _, sse = await task
        chunks, done = _sse_chunks(sse)
        ids = [t for c in chunks for t in c["choices"][0]["token_ids"]]
        return held, alive(), done, ids, ref["choices"][0]["token_ids"]

    async def main():
        gw = TS.ServingGateway(rt, port=0)
        await gw.start()
        try:
            return await go(gw)
        finally:
            await gw.stop()
    held, after, done, ids, ref_ids = asyncio.run(main())
    assert (held, after) == (3, 2)
    assert done and ids == ref_ids
    assert rt.reprovision_stats["migrated_requests"] == 1
