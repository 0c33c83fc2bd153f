"""The VLM family through the port's dense engine, its host KV tier, its
fleet, its reprovisioning and its launchers, against the JAX package, on
reduced llama-3.2-vision-11b in f32 with 4 layers and 2 KV heads (two
groups of 2 decoder layers and a cross layer, q_per_kv 2), the cross
layers' gates set to 0.5 / -0.7 in the JAX tree before it is carried
across (``params.from_jax_numpy``).

The engine serves tokens only: the cross memory is the cache's zeros in
both packages (the reference's engine passes no frontend), so a cross
layer's attention adds zero and its gated MLP acts.

* Lockstep with the JAX engine (prompts of 20-45 tokens, prefilled token
  by token): at decode_k 1 and 4 with a request preempted mid decode by
  swap or by recompute, and at spec_k 2. After every step both hold the
  same slots, positions, emitted tokens, queue, host tier and results;
  the caches within 1e-5 of the largest magnitude (the reference's
  grouped self-attention leaves flattened to the port's layout, and the
  cross memory), and so are the swap path's host rows, cross memory
  included (the reference's host tier keeps every cache leaf).
* Within the port, bitwise: decode_k 8 emits decode_k 1's tokens (the
  reference's test_multi_step_scan_matches_sequential_other_families),
  and a preempted request resumes with the unloaded run's tokens by swap
  (every leaf back bit for bit) and by recompute.
* The fleet: ``FleetRuntime.from_plan`` (K=2) routes and serves every
  request as the JAX runtime does; ``reprovision`` to fewer slots at the
  same context keeps the JAX runtime's host state every round
  (tests/test_torch_reprovision.py's lockstep) and the uninterrupted
  run's tokens. To another ``c_max`` the port moves the cross memory
  unchanged and resumes exactly; the reference fits the memory's F axis
  to c_max and its swap-in raises (pinned on both sides).
* The launchers: ``serve --arch llama-3.2-vision-11b --reduced``, batch
  (the reference's constant frontend) and ``--fleet 2``, print the JAX
  launcher's lines on its weights. The paged pool refuses VLM in both
  packages, in the reference's words.
"""
import contextlib
import dataclasses
import io
import re
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
from test_torch_kvcache_serving import (_fleet, _host,  # noqa: E402
                                        _reprovision_to, _requests)
from test_torch_reprovision import PORT, _held, _run, _tokens  # noqa: E402
from test_torch_speculative import _launcher_lines  # noqa: E402
from test_torch_vlm import (GATES, cache_close, flat_jax_cache,  # noqa: E402
                            set_gates)

ARCH = "llama-3.2-vision-11b"
SHAPE = dict(num_layers=4, num_kv_heads=2)
EOS = 7
TOL = 1e-5
PAGED_REASON = "paged KV cache supports dense/MoE full-attention models"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one intra-op
    thread per worker keeps these small-shape tests from oversubscribing
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32",
                               **SHAPE)
    return reduced_f32(ARCH, **SHAPE), tcfg


@pytest.fixture(scope="module")
def weights():
    """The JAX parameters (gates set) and the port's copy."""
    jp = set_gates(M.init_params(_cfgs()[0], jax.random.PRNGKey(0)), GATES)
    return jp, P.from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _stream(seed=42, n_req=5, l_in=(20, 45), max_new=(6, 14)):
    rng = np.random.default_rng(seed)
    return [dict(rid=rid,
                 tokens=[int(t) for t in rng.integers(1, 900,
                                                      rng.integers(*l_in))],
                 max_new_tokens=int(rng.integers(*max_new)))
            for rid in range(n_req)]


def _engines(weights, **kw):
    jp, tp = weights
    cfg, tcfg = _cfgs()
    kw = dict(dict(n_max=3, c_max=96, c_chunk=16, eos_id=EOS), **kw)
    return (JEngine.InferenceEngine(cfg, jp, decode_impl="xla", **kw),
            TEngine.InferenceEngine(tcfg, tp, decode_impl="torch", **kw))


def _decoding_slot(eng):
    """The first slot that has emitted a token and prefills no more."""
    return next((s for s in range(eng.n_max) if eng.slot_req[s] is not None
                 and not eng.slot_prefill_left[s] and eng.slot_out[s]), None)


def _host_rows_close(jeng, teng) -> int:
    """Every swap-path checkpoint's host rows: the port's (L, S, ...) KV
    and (n_groups, F, ...) cross memory against the JAX engine's tree
    (its grouped KV flattened), within TOL of the leaf's max. Returns the
    checkpoints compared."""
    n = 0
    for rid, jst in jeng._preempted.items():
        if jst.host_kv is None:
            continue
        want = flat_jax_cache(jst.host_kv)
        got = teng._preempted[rid].host_kv
        want = dict(want["kv"], xk=want["xk"], xv=want["xv"])
        assert set(got) == set(want) == {"k", "v", "xk", "xv"}
        for k, t in got.items():
            assert t.device.type == "cpu" and tuple(t.shape) == want[k].shape
            err = np.abs(t.numpy() - want[k]).max()
            assert err <= TOL * max(np.abs(want[k]).max(), 1e-30), k
        n += 1
    return n


def _lockstep(jeng, teng, reqs, preempt_at=None, mode=None):
    """Step both engines on ``reqs`` until both drain, comparing host
    state, caches and host rows after every step; with ``preempt_at``,
    the first decoding slot after that many steps is preempted
    (``mode``) in both. Returns the port's tokens and the number of
    host-row comparisons."""
    for r in reqs:
        jeng.submit(JEngine.ServeRequest(**r))
        teng.submit(TEngine.ServeRequest(**r))
    it, done, rows = 0, preempt_at is None, 0
    while jeng.busy() or teng.busy():
        jeng.step()
        teng.step()
        it += 1
        if not done and it >= preempt_at and _decoding_slot(teng) is not None:
            s = _decoding_slot(teng)
            for e in (jeng, teng):
                e.preempt_slot(s, mode=mode)
            done = True
        assert _host(teng) == _host(jeng), f"diverged at step {it}"
        cache_close(teng.cache, jeng.cache)
        rows += _host_rows_close(jeng, teng)
        assert it < 2000
    assert done
    return {rid: r.output_tokens for rid, r in sorted(teng.results.items())}, \
        rows


LOCKSTEP = {"k1-swap": (dict(decode_k=1), "swap"),
            "k4-swap": (dict(decode_k=4), "swap"),
            "k1-recompute": (dict(decode_k=1), "recompute"),
            "k4-recompute": (dict(decode_k=4), "recompute"),
            "spec2": (dict(spec_k=2), None)}


@pytest.mark.parametrize("case", list(LOCKSTEP))
def test_engine_lockstep_matches_jax(weights, case):
    """The VLM engine against the JAX engine, step by step (module
    docstring); a swap's host rows, cross memory included, compared
    while they wait."""
    kw, mode = LOCKSTEP[case]
    jeng, teng = _engines(weights, **kw)
    reqs = _stream()
    toks, rows = _lockstep(jeng, teng, reqs,
                           preempt_at=None if mode is None else 6, mode=mode)
    assert len(toks) == len(reqs)
    assert set(teng.cache) == {"kv", "xk", "xv"}
    assert (rows > 0) == (mode == "swap")
    if mode:
        assert teng.overload_stats["preempted"] == 1


# ---------------------------------------------- invariants within the port
def _port_run(weights, preempt_at=None, mode=None, **kw):
    """The port's engine on _stream(); with ``preempt_at``, the first slot
    decoding after that many steps is preempted (``mode``). A swap-in must
    put every leaf of the row back bit for bit, the cross memory too."""
    _, tp = weights
    eng = TEngine.InferenceEngine(_cfgs()[1], tp, n_max=3, c_max=96,
                                  c_chunk=16, eos_id=EOS,
                                  decode_impl="torch", **kw)
    swap_in, restored = eng._swap_in, []

    def checked(s, qi, state):
        res = swap_in(s, qi, state)
        if res == "admitted":
            back = eng.cache_row(s)
            back = dict(back["kv"], xk=back["xk"], xv=back["xv"])
            assert set(back) == set(state.host_kv)
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


def test_decode_k8_equals_k1(weights):
    """Within the port: decode_k 8 (the device micro-loop) emits decode_k
    1's tokens, bit for bit."""
    assert _port_run(weights, decode_k=8) == _port_run(weights)


@pytest.mark.parametrize("mode", ["swap", "recompute"])
def test_preempted_request_resumes_bitwise(weights, mode):
    """A request preempted mid decode by swap (the row and its cross
    memory restored bit for bit) or by recompute finishes with the
    unloaded run's tokens."""
    assert _port_run(weights, preempt_at=6, mode=mode) == _port_run(weights)


def test_paged_pool_refuses_vlm(weights):
    """Both packages' paged engines refuse VLM in the reference's words."""
    jp, tp = weights
    cfg, tcfg = _cfgs()
    with pytest.raises(NotImplementedError, match=re.escape(PAGED_REASON)):
        JEngine.InferenceEngine(cfg, jp, n_max=2, c_max=64, paged=True,
                                block_size=16)
    with pytest.raises(NotImplementedError,
                       match=re.escape(PAGED_REASON)) as err:
        TEngine.InferenceEngine(tcfg, tp, n_max=2, c_max=64, paged=True,
                                block_size=16)
    assert "later slice" not in str(err.value)


# ----------------------------------------------------------------- fleet
def _prompt(n_words, topic):
    return " ".join(f"{topic} fact {i}: fleets split by context length."
                    for i in range(n_words))


def test_from_plan_fleet_matches_jax(weights):
    """FleetRuntime.from_plan, the K=2 azure plan at the long pool's 512
    tokens, dense pools: every request gets the JAX runtime's pool and
    tokens."""
    jp, tp = weights
    cfg, tcfg = _cfgs()
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
    assert len(rt.engines) == 2
    for eng in rt.engines.values():
        assert not eng.paged and set(eng.cache) == {"kv", "xk", "xv"}
    got = serve(rt, TPools.GatewayRequest)
    assert got == serve(rj, JPools.GatewayRequest)
    assert len({pool for pool, _ in got.values()}) == 2


@pytest.fixture(scope="module")
def pkgs(weights):
    """test_torch_reprovision's package namespaces (the JAX runtime and
    the port's two impls) on the VLM weights."""
    jp, tp = weights
    cfg, tcfg = _cfgs()
    jax_ns = dict(pools=JPools, config=JConfig, engine=JEngine,
                  reconf=JReconf, cfg=cfg, params=jp)
    port_ns = dict(pools=TPools, config=TConfig, engine=TEngine,
                   reconf=TReconf, cfg=tcfg, params=tp)
    return {"jax": types.SimpleNamespace(impl="xla", **jax_ns),
            "torch": types.SimpleNamespace(impl="torch", **port_ns),
            "kernel": types.SimpleNamespace(impl="kernel", **port_ns)}


@pytest.mark.parametrize("decode_k", [1, 4])
def test_reprovision_matches_jax(pkgs, decode_k):
    """One pool (n_max 3, c_max 128) reprovisioned to 2 slots at the same
    context mid-flight, where the reference's host rows move unchanged:
    JAX's host state every round, the swap-path host rows (cross memory
    included) within 1e-5, and the uninterrupted run's tokens, for the
    torch and the kernel decode impl."""
    got, n_kv = _held(pkgs, _fleet(128, decode_k=decode_k), _requests(),
                      warm=3, event=_reprovision_to(2, 128))
    for n in ("jax",) + PORT:
        eng = got[n][0].engines["long"]
        assert (eng.n_max, eng.c_max) == (2, 128)
    assert n_kv > 0


WARM = 3                       # drive rounds before the reprovision


@pytest.mark.parametrize("c_max", [160, 96])
def test_vlm_reprovision_other_c_max(pkgs, c_max):
    """The pool reprovisioned from c_max 128 to 160 or 96 (and 2 slots):
    the port fits each swapped row's self-attention K/V to the new
    length and moves its cross memory unchanged (F = the frontend's
    16); every request finishes with the uninterrupted run's tokens, for
    the torch and the kernel decode impl."""
    reqs = _requests()
    seen = {}

    def event(p, rt):
        info = _reprovision_to(2, c_max)(p, rt)
        eng = rt.engines["long"]
        st = next(s for s in eng._preempted.values() if s.host_kv)
        seen[p.impl] = (tuple(st.host_kv["k"].shape),
                        tuple(st.host_kv["xk"].shape))
        return info

    base, _ = _run(pkgs, PORT, _fleet(128), reqs)
    got, _ = _run(pkgs, PORT, _fleet(128), reqs, warm=WARM, event=event)
    cfg = pkgs["torch"].cfg
    n_groups = cfg.num_layers // cfg.cross_attn_every
    for n in PORT:
        rt, _, _, res = got[n]
        eng = rt.engines["long"]
        assert (eng.n_max, eng.c_max) == (2, c_max)
        assert tuple(eng.cache["xk"].shape[2:3]) == (cfg.frontend_tokens,)
        assert seen[pkgs[n].impl] == (
            (cfg.num_layers, c_max, cfg.num_kv_heads, 64),
            (n_groups, cfg.frontend_tokens, cfg.num_kv_heads, 64))
        assert _tokens(res) == _tokens(base[n][3])


@pytest.mark.parametrize("c_max", [160, 96])
def test_vlm_reprovision_other_c_max_raises_in_the_reference(pkgs, c_max):
    """The same stream and event in the JAX runtime: its _adopt_state
    fits every dense host leaf along the axis after the batch, the cross
    memory's F axis too, to c_max; the swap-in of that row then raises."""
    p = pkgs["jax"]
    rt = _fleet(128)(p)
    for rid, text, n in _requests():
        rt.submit(p.pools.GatewayRequest(rid, text, n))
    for _ in range(WARM):
        rt.engines["long"].step()
    _reprovision_to(2, c_max)(p, rt)
    st = next(s for s in rt.engines["long"]._preempted.values()
              if s.host_kv)
    assert np.asarray(st.host_kv["xk"]).shape[1] == c_max
    with pytest.raises(ValueError, match="Incompatible shapes"):
        rt.run(max_iters=2000)


# ---------------------------------------------------------------- launchers
@pytest.fixture(scope="module")
def launcher_params():
    """M.init_params(reduced llama-3.2-vision f32, PRNGKey(0)): what the
    JAX launcher builds (its zero gates), as numpy arrays."""
    return jax.tree.map(np.asarray, M.init_params(reduced_f32(ARCH),
                                                  jax.random.PRNGKey(0)))


def test_fleet_launcher_prints_jax_lines(monkeypatch, launcher_params):
    """``--arch llama-3.2-vision-11b --reduced --fleet 2``: the routing,
    served and hot-path lines equal the JAX launcher's."""
    got, ref = _launcher_lines(["--arch", ARCH, "--reduced", "--fleet",
                                "2"], monkeypatch, launcher_params)
    assert got == ref
    assert sum(ln.startswith("  req ") for ln in got) == 3


def test_batch_launcher_prints_jax_sequence(monkeypatch, launcher_params):
    """``--arch llama-3.2-vision-11b --reduced`` as the batch launcher on
    the JAX launcher's weights and prompt ids, both giving the model the
    reference's constant frontend: its ``first sequence`` line equals
    ``repro.launch.serve.main``'s (run with Auto mesh axes, as
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
    assert run.cache["xk"].shape == (1, 2, cfg.frontend_tokens,
                                     cfg.num_kv_heads, 64)
    assert run.cache["xk"].abs().max() > 0
    assert TM.check_supported(run.cfg) is None
