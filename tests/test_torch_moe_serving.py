"""The MoE decoder through the port's engines, its host KV tier, its fleet
and its launcher, against the JAX package, on reduced
llama4-scout-17b-a16e in f32 (4 experts, top-1, one shared expert, a
window of 64) on the same weights (the JAX parameters carried across
with ``params.from_jax_numpy``) and the same seed-made streams.

* Lockstep with the JAX engine: the dense engine on the config's window
  (a ring of 64 rows under c_max 128, prompts of 20-70 tokens prefilled
  token by token, so rows wrap) at decode_k 1, 4 and 8, and the paged
  engine with the window set to 0 (the paged pool takes no window, as
  the reference's) at decode_k 1 and 4. After every step both hold the
  same slots, positions, emitted tokens, queue, host tier and results
  (and, paged, block tables and free list), and caches within 1e-5 of
  the largest magnitude (the paged pool without its sink block).
* Within the port, bitwise: decode_k 8 emits decode_k 1's tokens (the
  reference pins its own, tests/test_decode_consistency.py:127-139), and
  a request preempted mid decode resumes with the unloaded run's tokens,
  by swap (every cache leaf to the host and back bit for bit) and by
  recompute.
* The fleet: ``FleetRuntime.from_plan`` (the window's dense pools, and
  paged pools at window 0) routes and serves every request as the JAX
  runtime does; ``reprovision`` of a pool keeps the JAX runtime's host
  state every round and the uninterrupted run's tokens
  (tests/test_torch_reprovision.py's lockstep).
* The launcher: ``serve --arch llama4-scout-17b-a16e --reduced``, batch
  and ``--fleet 2``, prints the JAX launcher's lines on its weights.
"""
import contextlib
import dataclasses
import io
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
from repro_torch.configs.base import get_config
from repro_torch.core import planner as TP
from repro_torch.core import workload as TW
from repro_torch.launch import serve as TS
from repro_torch.models import model as TM
from repro_torch.serving import config as TConfig
from repro_torch.serving import engine as TEngine
from repro_torch.serving import pools as TPools
from repro_torch.serving import reconfigure as TReconf

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_kvcache import _kv_close  # noqa: E402
from test_torch_kvcache_serving import (_fleet, _host,  # noqa: E402
                                        _reprovision_to)
from test_torch_reprovision import PORT, _held  # noqa: E402
from test_torch_speculative import _launcher_lines  # noqa: E402

ARCH = "llama4-scout-17b-a16e"
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


def _cfgs(**change):
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    return (dataclasses.replace(reduced_f32(ARCH), **change),
            dataclasses.replace(tcfg, **change))


@pytest.fixture(scope="module")
def weights():
    """The JAX parameters of reduced llama4-scout (f32) and the port's
    copy; the window lives in the configs only."""
    jp = M.init_params(reduced_f32(ARCH), jax.random.PRNGKey(0))
    return jp, P.from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _stream(seed=42, n_req=5, l_in=(20, 70), max_new=(6, 14)):
    rng = np.random.default_rng(seed)
    return [dict(rid=rid,
                 tokens=[int(t) for t in rng.integers(1, 900,
                                                      rng.integers(*l_in))],
                 max_new_tokens=int(rng.integers(*max_new)))
            for rid in range(n_req)]


# window 64: the config's ring; window 0: full attention, the paged pool
LAYOUTS = {"ring": (dict(), {}),
           "paged": (dict(attention_window=0), dict(paged=True,
                                                    block_size=16))}


def _engines(weights, layout, **kw):
    jp, tp = weights
    change, lkw = LAYOUTS[layout]
    cfg, tcfg = _cfgs(**change)
    kw = dict(dict(n_max=3, c_max=128, c_chunk=16, eos_id=EOS), **lkw, **kw)
    return (JEngine.InferenceEngine(cfg, jp, decode_impl="xla", **kw),
            TEngine.InferenceEngine(tcfg, tp, decode_impl="torch", **kw))


def _state(e):
    """_host plus, paged, the allocator."""
    out = _host(e)
    if e.paged:
        out.update(tables=e.block_tables.tolist(), free=list(e._free),
                   reserved=e._reserved)
    return out


def _decoding_slot(eng):
    """The first slot that has emitted a token and prefills no more."""
    return next((s for s in range(eng.n_max) if eng.slot_req[s] is not None
                 and not eng.slot_prefill_left[s] and eng.slot_out[s]), None)


def _lockstep(jeng, teng, reqs, preempt_at=None, mode=None):
    """Step both engines on ``reqs`` until both drain, comparing host state
    and caches (a paged pool without the port's sink block) after every
    step; with ``preempt_at``, the first decoding slot after that many
    steps is preempted (``mode``) in both. Returns the port's tokens."""
    for r in reqs:
        jeng.submit(JEngine.ServeRequest(**r))
        teng.submit(TEngine.ServeRequest(**r))
    it, done = 0, preempt_at is None
    while jeng.busy() or teng.busy():
        jeng.step()
        teng.step()
        it += 1
        if not done and it >= preempt_at and _decoding_slot(teng) is not None:
            s = _decoding_slot(teng)
            for e in (jeng, teng):
                e.preempt_slot(s, mode=mode)
            done = True
        assert _state(teng) == _state(jeng), f"diverged at step {it}"
        kv = teng.cache["kv"]
        if teng.paged:
            kv = {n: t[:, :teng.num_blocks] for n, t in kv.items()}
        _kv_close(kv, jeng.cache["kv"])
        assert it < 2000
    assert done
    return {rid: r.output_tokens for rid, r in sorted(teng.results.items())}


@pytest.mark.parametrize("layout,decode_k", [("ring", 1), ("ring", 4),
                                             ("ring", 8), ("paged", 1),
                                             ("paged", 4)])
def test_engine_lockstep_matches_jax(weights, layout, decode_k):
    """The MoE engine against the JAX engine, step by step (module
    docstring); on the ring, some row wraps."""
    jeng, teng = _engines(weights, layout, decode_k=decode_k)
    reqs = _stream()
    toks = _lockstep(jeng, teng, reqs)
    assert len(toks) == len(reqs)
    if layout == "ring":
        assert teng.cache["kv"]["k"].shape[2] == 64
        assert max(len(r["tokens"]) + len(toks[r["rid"]])
                   for r in reqs) > 64
    else:
        assert teng.paged and teng.cfg.attention_window == 0


# ---------------------------------------------- invariants within the port
def _port_run(weights, layout, preempt_at=None, mode=None, cf=None, **kw):
    """The port's engine on _stream() (``cf``: another capacity_factor);
    with ``preempt_at``, the first slot decoding after that many steps is
    preempted (``mode``). A dense swap-in must put the row's bits back."""
    _, tp = weights
    change, lkw = LAYOUTS[layout]
    _, tcfg = _cfgs(**change)
    if cf is not None:
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=cf))
    eng = TEngine.InferenceEngine(tcfg, tp, n_max=3, c_max=128, c_chunk=16,
                                  eos_id=EOS, decode_impl="torch", **lkw,
                                  **kw)
    swap_in, restored = eng._swap_in, []

    def checked(s, qi, state):
        res = swap_in(s, qi, state)
        if res == "admitted":
            if not eng.paged:
                back = eng.cache_row(s)["kv"]
                for n, h in state.host_kv.items():
                    assert torch.equal(back[n], h), n
            restored.append(s)
        return res
    eng._swap_in = checked
    for r in _stream():
        eng.submit(TEngine.ServeRequest(**r))
    it, done = 0, preempt_at is None
    while eng.busy():
        eng.step()
        it += 1
        if not done and it >= preempt_at and _decoding_slot(eng) is not None:
            eng.preempt_slot(_decoding_slot(eng), mode=mode)
            done = True
    assert done and len(restored) == (mode == "swap")
    return {rid: r.output_tokens for rid, r in sorted(eng.results.items())}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_decode_k8_equals_k1(weights, layout):
    """Within the port: decode_k 8 (the device micro-loop) emits decode_k
    1's tokens, bit for bit."""
    assert _port_run(weights, layout, decode_k=8) == _port_run(weights,
                                                               layout)


@pytest.mark.parametrize("mode", ["swap", "recompute"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_preempted_request_resumes_bitwise(weights, layout, mode):
    """A request preempted mid decode by swap (the dense row's leaves
    restored bit for bit) or by recompute finishes with the unloaded
    run's tokens. A recompute prefills the request's tokens again beside
    other rows' chunks, and the fused chunk's capacity drops depend on
    every token of the call: on the paged pool (the fused chunk) that
    case runs at capacity_factor 8.0, where no pair drops (at 1.25:
    test_paged_recompute_under_drops_matches_jax). The ring's per-token
    prefill routes a few tokens a call, which never fill an expert's 8
    rows."""
    cf = 8.0 if (layout, mode) == ("paged", "recompute") else None
    base = _port_run(weights, layout, cf=cf)
    assert _port_run(weights, layout, preempt_at=6, mode=mode,
                     cf=cf) == base


def test_paged_recompute_under_drops_matches_jax(weights):
    """At capacity_factor 1.25 a recompute on the paged pool re-prefills
    the request beside another row's chunk, the call drops other pairs,
    and the request's tokens leave the unloaded run's, in the JAX engine
    as in the port: both step in lockstep through the preemption and
    emit the same tokens."""
    jeng, teng = _engines(weights, "paged")
    got = _lockstep(jeng, teng, _stream(), preempt_at=6, mode="recompute")
    assert teng.overload_stats["recomputed"] == 1
    assert got != _port_run(weights, "paged")


# ----------------------------------------------------------------- fleet
def _prompt(n_words, topic):
    return " ".join(f"{topic} fact {i}: fleets split by context length."
                    for i in range(n_words))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_from_plan_fleet_matches_jax(weights, layout):
    """FleetRuntime.from_plan, the K=2 azure plan at the long pool's 512
    tokens: dense ring pools (window 64) or paged pools (window 0); every
    request gets the JAX runtime's pool and tokens."""
    jp, tp = weights
    change, lkw = LAYOUTS[layout]
    cfg, tcfg = _cfgs(**change)
    plan_j = JP.plan_k_pool(JW.get_workload("azure"), lam=1000.0,
                            t_slo=0.5, k=2)
    plan_t = TP.plan_k_pool(TW.get_workload("azure"), lam=1000.0, t_slo=0.5,
                            k=2)
    kw = dict(slots_per_pool=2, c_chunk=16, decode_k=4, eos_id=None,
              ctx_scale=512 / plan_j.pools[-1].c_max, paged=bool(lkw))
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
    for eng in rt.engines.values():
        assert eng.paged == bool(lkw)
        if not eng.paged:
            assert eng.cache["kv"]["k"].shape[2] == min(eng.c_max, 64)
    assert serve(rt, TPools.GatewayRequest) == serve(rj,
                                                     JPools.GatewayRequest)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_reprovision_matches_jax(weights, paged):
    """A pool of the MoE model (window 0) reprovisioned to fewer slots
    and a longer context mid-flight: JAX's host state every round, the
    swap-path host rows within 1e-5, and the uninterrupted run's tokens,
    for the torch and the kernel decode impl."""
    jp, tp = weights
    cfg, tcfg = _cfgs(attention_window=0)
    jax_ns = dict(pools=JPools, config=JConfig, engine=JEngine,
                  reconf=JReconf, cfg=cfg, params=jp)
    port_ns = dict(pools=TPools, config=TConfig, engine=TEngine,
                   reconf=TReconf, cfg=tcfg, params=tp)
    pkgs = {"jax": types.SimpleNamespace(impl="xla", **jax_ns),
            "torch": types.SimpleNamespace(impl="torch", **port_ns),
            "kernel": types.SimpleNamespace(impl="kernel", **port_ns)}
    lkw = dict(paged=True, block_size=16) if paged else {}
    reqs = [(i, f"req {i} " + "alpha beta " * (2 + 3 * i), 10 - (i % 3))
            for i in range(5)]
    got, n_kv = _held(pkgs, _fleet(128, **lkw), reqs, warm=4,
                      event=_reprovision_to(2, 160))
    for n in ("jax",) + PORT:
        eng = got[n][0].engines["long"]
        assert (eng.n_max, eng.c_max, eng.paged) == (2, 160, paged)
    assert n_kv > 0


# ---------------------------------------------------------------- launcher
@pytest.fixture(scope="module")
def launcher_params():
    """M.init_params(reduced llama4-scout f32, PRNGKey(0)): what the JAX
    launcher builds, as numpy arrays."""
    return jax.tree.map(np.asarray, M.init_params(reduced_f32(ARCH),
                                                  jax.random.PRNGKey(0)))


def test_fleet_launcher_prints_jax_lines(monkeypatch, launcher_params):
    """``--arch llama4-scout-17b-a16e --reduced --fleet 2``: the routing,
    served and hot-path lines equal the JAX launcher's."""
    got, ref = _launcher_lines(["--arch", ARCH, "--reduced", "--fleet",
                                "2"], monkeypatch, launcher_params)
    assert got == ref
    assert sum(ln.startswith("  req ") for ln in got) == 3


def test_batch_launcher_prints_jax_sequence(monkeypatch, launcher_params):
    """``--arch llama4-scout-17b-a16e --reduced`` as the batch launcher on
    the JAX launcher's weights and prompt ids: its ``first sequence`` line
    equals ``repro.launch.serve.main``'s (run with Auto mesh axes, as
    tests/test_torch_forward.py runs it)."""
    from jax.sharding import AxisType
    from repro.launch import serve as JS
    argv = ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len",
            "16", "--new-tokens", "4"]
    make_mesh = jax.make_mesh
    monkeypatch.setattr(jax, "make_mesh", lambda shape, names, **kw:
                        make_mesh(shape, names,
                                  axis_types=(AxisType.Auto,) * len(names)))
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        JS.main()
    ref = [ln for ln in buf.getvalue().splitlines()
           if ln.startswith("first sequence:")]
    cfg = reduced_f32(ARCH)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (2, 16), 1,
                                         cfg.vocab_size))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = TS.serve_batch(TS.parse_args(argv + ["--device", "cpu"]),
                             params=P.from_jax_numpy(launcher_params,
                                                     device="cpu"),
                             tokens=torch.from_numpy(toks))
    out = buf.getvalue().splitlines()
    assert len(ref) == 1
    assert [ln for ln in out if ln.startswith("first sequence:")] == ref
    assert out[0].startswith(f"arch={cfg.name} mesh 1x1 batch=2")
    assert run.cache["kv"]["k"].shape[2] == 20      # min(16 + 4, 64)
    assert TM.check_supported(run.cfg) is None
