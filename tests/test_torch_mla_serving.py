"""The MLA decoder (deepseek-v2-236b) through the port's dense engine, its
host KV tier, the K=2 fleet with C&R, a reprovision and the launchers,
against the JAX package, on reduced deepseek-v2 in f32 (the JAX
parameters carried across with ``params.from_jax_numpy``) and the same
seed-made streams. The engine prefills MLA token by token (the masked
per-token chunk, as the reference does) and decodes it absorbed; the
paged pool refuses it (tests/test_torch_mla.py), so every pool here is
dense.

* Lockstep with the JAX engine at decode_k 1 and 4 and at spec_k 4:
  after every step both hold the same slots, positions, emitted tokens,
  queue, host tier and results, and latent caches within 1e-5.
  ``preempt_slot`` on the dense engine, by swap and by recompute, in
  lockstep too.
* Within the port, bitwise: decode_k 8 emits decode_k 1's tokens (the
  reference pins its own, tests/test_decode_consistency.py:127-139), and
  a request preempted mid decode resumes with the unloaded run's tokens,
  its swapped row (c_kv and k_r) read back bit for bit.
* The fleet: ``FleetRuntime.from_plan`` (K=2 azure plan) routes every
  request to the JAX runtime's pool with its C&R decision (an in-band
  request compressed into the short pool) and emits its tokens; a
  paged fleet is refused in both packages.
* ``reprovision`` of a pool to 2 slots and another c_max (160: the
  latent rows zero-padded; 96: truncated) mid-flight: JAX's host state
  every round, the swap-path host rows within 1e-5, the uninterrupted
  run's tokens, every swap-in read back bitwise with the padded tail
  zero. This is the path of ``reconfigure._adopt_state``, which took the
  row length from a "k" leaf the latent cache lacks; the reference's
  ``_adopt_state`` fits every leaf, and the lockstep holds it on the
  same states.
* The launchers: ``serve --arch deepseek-v2-236b --reduced`` (batch and
  ``--fleet 2``) and ``train --arch deepseek-v2-236b --reduced`` print
  the JAX launchers' lines on their weights.
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
from test_torch_kvcache_serving import _fleet, _reprovision_to  # noqa: E402
from test_torch_moe_serving import _decoding_slot, _lockstep  # noqa: E402
from test_torch_reprovision import PORT, _held  # noqa: E402
from test_torch_speculative import _launcher_lines  # noqa: E402
from test_torch_train_launch import _both_launchers  # noqa: E402

ARCH = "deepseek-v2-236b"
EOS = 7
PAGED_REASON = ("paged KV cache supports dense/MoE full-attention models; "
                "family='moe' mla=True")


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
    """The JAX parameters of reduced deepseek-v2 (f32) and the port's
    copy."""
    jp = M.init_params(reduced_f32(ARCH), jax.random.PRNGKey(0))
    return jp, P.from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _stream(seed=42, n_req=4, l_in=(12, 40), max_new=(5, 10)):
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


@pytest.mark.parametrize("kw", [dict(decode_k=1), dict(decode_k=4),
                                dict(spec_k=4)],
                         ids=["k1", "k4", "spec4"])
def test_engine_lockstep_matches_jax(weights, kw):
    """The MLA engine against the JAX engine, step by step (module
    docstring); the cache is the latent pair."""
    jeng, teng = _engines(weights, **kw)
    assert set(teng.cache["kv"]) == {"c_kv", "k_r"}
    toks = _lockstep(jeng, teng, _stream())
    assert len(toks) == 4 and all(toks.values())


@pytest.mark.parametrize("mode", ["swap", "recompute"])
def test_preempt_slot_matches_jax(weights, mode):
    """preempt_slot on the dense engine (a decoding slot, by swap or by
    recompute) in both packages, stepped in lockstep through the
    preemption and the resume."""
    jeng, teng = _engines(weights)
    _lockstep(jeng, teng, _stream(), preempt_at=6, mode=mode)
    key = "swapped_in" if mode == "swap" else "recomputed"
    assert teng.overload_stats[key] == 1


def _port_run(weights, preempt_at=None, mode=None, **kw):
    """The port's engine on _stream(); with ``preempt_at``, the first slot
    decoding after that many steps is preempted (``mode``), and a swap-in
    must put the row's latent bits back."""
    _, tp = weights
    _, tcfg = _cfgs()
    eng = TEngine.InferenceEngine(tcfg, tp, n_max=3, c_max=96, c_chunk=16,
                                  eos_id=EOS, decode_impl="torch", **kw)
    swap_in, restored = eng._swap_in, []

    def checked(s, qi, state):
        res = swap_in(s, qi, state)
        if res == "admitted":
            back = eng.cache_row(s)["kv"]
            assert set(back) == set(state.host_kv) == {"c_kv", "k_r"}
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
    """A request preempted mid decode by swap (c_kv and k_r to the host
    and back bit for bit) or by recompute finishes with the unloaded
    run's tokens."""
    assert _port_run(weights, preempt_at=6, mode=mode) == _port_run(weights)


# ----------------------------------------------------------------- fleet
def _prompt(n_words, topic):
    return " ".join(f"{topic} fact {i}: fleets split by context length."
                    for i in range(n_words))


def test_from_plan_fleet_with_cr_matches_jax(weights):
    """FleetRuntime.from_plan, the K=2 azure plan with the long pool at
    512 tokens (B = 64, gamma 2), dense pools: every request gets the JAX
    runtime's pool, C&R decision and tokens; the in-band request (20
    short sentences, 115 tokens with its output, between B and gamma x B)
    is compressed into the short pool. A paged fleet is refused
    in both packages with the reference's words."""
    jp, tp = weights
    cfg, tcfg = _cfgs()
    plan_j = JP.plan_k_pool(JW.get_workload("azure"), lam=1000.0,
                            t_slo=0.5, k=2)
    plan_t = TP.plan_k_pool(TW.get_workload("azure"), lam=1000.0, t_slo=0.5,
                            k=2)
    kw = dict(slots_per_pool=2, c_chunk=16, decode_k=4, eos_id=None,
              ctx_scale=512 / plan_j.pools[-1].c_max)
    border = " ".join(f"border note {i} holds." for i in range(20))
    reqs = [(0, _prompt(3, "short"), 8, "prose"),
            (1, border, 8, "rag"),                   # 115 tokens: in band
            (2, _prompt(30, "long"), 8, "prose")]

    def serve(rt, request_cls):
        decisions = [rt.submit(request_cls(rid, text, n, category=cat))
                     for rid, text, n, cat in reqs]
        out = rt.run(max_iters=4000)
        assert sorted(out) == [0, 1, 2]
        assert not any(r.timed_out for r in out.values())
        return ([(d.pool, d.compressed, d.l_total_effective)
                 for d in decisions],
                {rid: (r.pool, r.compressed, r.output_tokens)
                 for rid, r in out.items()})

    rj = JPools.FleetRuntime.from_plan(cfg, jp, plan_j, decode_impl="xla",
                                       **kw)
    rt = TPools.FleetRuntime.from_plan(tcfg, tp, plan_t, decode_impl="torch",
                                       **kw)
    for eng in rt.engines.values():
        assert not eng.paged and set(eng.cache["kv"]) == {"c_kv", "k_r"}
    got = serve(rt, TPools.GatewayRequest)
    assert got == serve(rj, JPools.GatewayRequest)
    names = list(rt.engines)
    assert got[1][1] == (names[0], True, got[1][1][2])
    assert {pool for pool, _, _ in got[1].values()} == set(names)
    for pools in (JPools, TPools):
        params = jp if pools is JPools else tp
        c = cfg if pools is JPools else tcfg
        with pytest.raises(NotImplementedError,
                           match=re.escape(PAGED_REASON)):
            pools.FleetRuntime.from_plan(
                c, params, plan_j if pools is JPools else plan_t,
                paged=True, **kw)


@pytest.fixture(scope="module")
def pkgs(weights):
    """test_torch_reprovision's package namespaces (the JAX runtime and
    the port's two impls) on the MLA weights."""
    jp, tp = weights
    cfg, tcfg = _cfgs()
    jax_ns = dict(pools=JPools, config=JConfig, engine=JEngine,
                  reconf=JReconf, cfg=cfg, params=jp)
    port_ns = dict(pools=TPools, config=TConfig, engine=TEngine,
                   reconf=TReconf, cfg=tcfg, params=tp)
    return {"jax": types.SimpleNamespace(impl="xla", **jax_ns),
            "torch": types.SimpleNamespace(impl="torch", **port_ns),
            "kernel": types.SimpleNamespace(impl="kernel", **port_ns)}


def _requests():
    return [(i, f"req {i} " + "alpha beta " * (2 + 3 * i), 10 - (i % 3))
            for i in range(4)]


@pytest.mark.parametrize("c_max", [160, 96])
def test_reprovision_other_c_max_matches_jax(pkgs, c_max):
    """One pool (n_max 3, c_max 128) reprovisioned to 2 slots and c_max
    160 or 96 mid-flight (module docstring): the JAX runtime in lockstep
    (its host state every round, the swap-path latent rows within 1e-5),
    each port impl's tokens equal to its own uninterrupted run's, and in
    the port every swapped row fitted to the new length (zeros past 128)
    and read back bit for bit at its swap-in."""
    seen = {}
    swap_in = TEngine.InferenceEngine._swap_in

    def checked(self, s, qi, state):
        res = swap_in(self, s, qi, state)
        if res == "admitted" and state.host_kv is not None:
            back = self.cache_row(s)["kv"]
            for n, h in state.host_kv.items():
                assert h.shape[1] == c_max and torch.equal(back[n], h), n
                if c_max > 128:
                    assert not h[:, 128:].any(), n
            seen[self.decode_impl] = seen.get(self.decode_impl, 0) + 1
        return res
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TEngine.InferenceEngine, "_swap_in", checked)
        got, n_kv = _held(pkgs, _fleet(128), _requests(), warm=4,
                          event=_reprovision_to(2, c_max))
    for n in ("jax",) + PORT:
        eng = got[n][0].engines["long"]
        assert (eng.n_max, eng.c_max) == (2, c_max)
    assert n_kv > 0
    assert set(seen) == {"torch", "kernel"}


def test_reference_adopt_state_fits_the_latent_rows(pkgs):
    """The reference's ``_adopt_state`` on an MLA checkpoint: each host
    leaf ("kv" / "c_kv", "k_r") padded along its row axis to the new
    c_max with zeros, as the port's (the fault was the port's alone)."""
    p = pkgs["jax"]
    rt = _fleet(128)(p)
    for rid, text, n in _requests():
        rt.submit(p.pools.GatewayRequest(rid, text, n))
    for _ in range(4):
        rt.engines["long"].step()
    src = rt.engines["long"]
    s = _decoding_slot(src)
    src.preempt_slot(s, mode="swap")
    st = next(st for st in src._preempted.values() if st.host_kv)
    dst = types.SimpleNamespace(paged=False, c_max=160)
    out = JReconf._adopt_state(st, src, dst)
    for n in ("c_kv", "k_r"):
        h, o = np.asarray(st.host_kv["kv"][n]), np.asarray(out.host_kv["kv"][n])
        assert o.shape == (h.shape[0], 160) + h.shape[2:]
        assert np.array_equal(o[:, :128], h) and not o[:, 128:].any()


# ---------------------------------------------------------------- launchers
@pytest.fixture(scope="module")
def launcher_params():
    """M.init_params(reduced deepseek-v2 f32, PRNGKey(0)): what the JAX
    launcher builds, as numpy arrays."""
    return jax.tree.map(np.asarray, M.init_params(reduced_f32(ARCH),
                                                  jax.random.PRNGKey(0)))


def test_fleet_launcher_prints_jax_lines(monkeypatch, launcher_params):
    """``--arch deepseek-v2-236b --reduced --fleet 2``: the routing,
    served and hot-path lines equal the JAX launcher's."""
    got, ref = _launcher_lines(["--arch", ARCH, "--reduced", "--fleet",
                                "2"], monkeypatch, launcher_params)
    assert got == ref
    assert sum(ln.startswith("  req ") for ln in got) == 3


def test_batch_launcher_prints_jax_sequence(monkeypatch, launcher_params):
    """``--arch deepseek-v2-236b --reduced`` as the batch launcher on the
    JAX launcher's weights and prompt ids: its ``first sequence`` line
    equals ``repro.launch.serve.main``'s (Auto mesh axes); the cache is
    the latent pair. ``--int8-kv`` raises in the port (the reference
    drops it)."""
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
    params = P.from_jax_numpy(launcher_params, device="cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = TS.serve_batch(TS.parse_args(argv + ["--device", "cpu"]),
                             params=params, tokens=torch.from_numpy(toks))
    out = buf.getvalue().splitlines()
    assert len(ref) == 1
    assert [ln for ln in out if ln.startswith("first sequence:")] == ref
    assert out[0].startswith(f"arch={cfg.name} mesh 1x1 batch=2")
    assert {k: tuple(v.shape) for k, v in run.cache["kv"].items()} == {
        "c_kv": (2, 2, 20, 64), "k_r": (2, 2, 20, 16)}
    with pytest.raises(NotImplementedError, match="int8 layout"):
        TS.serve_batch(TS.parse_args(argv + ["--device", "cpu",
                                             "--int8-kv"]),
                       params=params, tokens=torch.from_numpy(toks))


def test_train_launcher_prints_jax_lines(monkeypatch, tmp_path):
    """``train --arch deepseek-v2-236b --reduced``: the same mesh and step
    lines as the JAX training launcher from its weights; every loss and
    grad norm finite."""
    cfg = reduced_f32(ARCH)
    argv = ["--arch", ARCH, "--reduced", "--steps", "3", "--global-batch",
            "4", "--seq-len", "16"]
    got, want, run, _ = _both_launchers(argv, cfg, monkeypatch, tmp_path)
    assert got[0] == want[0] == f"mesh 1x1 (1 devices), arch={cfg.name}"
    assert got[1:4] == want[1:4]
    assert len(got) == len(want) == 5
    assert all(np.isfinite(x) for x in run.losses + run.gnorms)
