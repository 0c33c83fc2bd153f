"""Self-speculative decoding in the port (``spec_k > 1``), held to the JAX
engine.

Both engines run the same weights (the JAX parameters carried across with
``params.from_jax_numpy``) in f32; greedy tokens and the ``spec_stats``
counters are compared exactly.

* Random streams on reduced minitron-8b (drafts mostly rejected, the
  adversarial case for the accept / cursor logic): for spec_k {2, 4} x
  decode_k {1, 4} x dense / paged, the port's tokens equal its plain run
  (spec_k = 1, decode_k = 1) and the JAX engine's speculative run, and its
  ``spec_stats`` equal the JAX engine's.
* The agent-loop model (``chip_smoke.agent_loop_params``, the torch twin
  of ``benchmarks/bench_speculative.agent_loop_model``): the construction
  equals the JAX one (f32, rtol 1e-6 / atol 1e-7: the two reduce the
  rms and the norm in another order), and gives acceptance 1.0 and kappa
  4.0 at spec_k = 4, EOS inside an accepted window by construction, and a
  budget that full acceptance never overshoots.
* A windowed config refuses speculation; the launcher prints the JAX
  launcher's routing and kappa / acceptance lines.
"""
import contextlib
import dataclasses
import io
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from conftest import reduced_f32
from jax_compile_cache import jax_compile_cache  # noqa: F401
from repro.models import model as M
from repro.serving.draft import propose_draft as jax_propose_draft
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.engine import ServeRequest as JaxRequest
from repro_torch import params as P
from repro_torch.configs.base import get_config
from repro_torch.models import model as TM
from repro_torch.serving.draft import propose_draft
from repro_torch.serving.engine import InferenceEngine, ServeRequest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the agent-loop construction)

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


def _port_cfg(name, **over):
    return dataclasses.replace(get_config(name).reduced(), dtype="float32",
                               **over)


@pytest.fixture(scope="module")
def models():
    cfg = reduced_f32("minitron-8b")
    jp = M.init_params(cfg, jax.random.PRNGKey(0))
    tp = P.from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, _port_cfg("minitron-8b"), tp


def _tiny(cfg):
    """benchmarks/bench_engine_hotpath.py::_tiny_cfg's widths."""
    return dataclasses.replace(cfg, d_model=64, d_ff=128, num_heads=2,
                               num_kv_heads=1, head_dim=32, vocab_size=256)


@pytest.fixture(scope="module")
def cyclic():
    """The JAX agent-loop model, and the port's construction applied to
    the same base weights: (jax cfg, jax params, port cfg, port params,
    cycle)."""
    from benchmarks.bench_speculative import agent_loop_model
    jcfg, jparams, cycle = agent_loop_model()
    base = M.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = _tiny(_port_cfg("llama3-70b"))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    tbase = P.from_jax_numpy(jax.tree.map(np.asarray, base), device="cpu")
    return jcfg, jparams, tcfg, chip_smoke.agent_loop_params(tcfg, tbase,
                                                             cycle), cycle


def _stream(seed=42, n_req=6, max_new=16, l_in_max=40):
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
@pytest.mark.parametrize("decode_k", [1, 4])
@pytest.mark.parametrize("spec_k", [2, 4])
def test_spec_matches_plain_and_jax(models, spec_k, decode_k, paged):
    cfg, jp, tcfg, tp = models
    reqs = _stream()
    plain, _ = _run(InferenceEngine, ServeRequest, tcfg, tp, reqs,
                    decode_impl="torch", **_layout(paged))
    got, eng = _run(InferenceEngine, ServeRequest, tcfg, tp, reqs,
                    decode_impl="torch", decode_k=decode_k, spec_k=spec_k,
                    **_layout(paged))
    ref, jeng = _run(JaxEngine, JaxRequest, cfg, jp, reqs, decode_impl="xla",
                     decode_k=decode_k, spec_k=spec_k, **_layout(paged))
    assert got == plain, "speculation changed the port's tokens"
    assert got == ref, "the port's speculative run left the JAX engine's"
    assert eng.spec_stats == jeng.spec_stats
    assert eng.spec_stats["verify_windows"] > 0
    assert eng.spec_kappa() == jeng.spec_kappa()
    assert eng.spec_acceptance_rate() == jeng.spec_acceptance_rate()
    assert eng.iteration == jeng.iteration
    eng.assert_block_invariants()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_verify_step_matches_jax(models, paged):
    """M.verify_step / paged_verify_step: logits at every live window
    position within test_torch_model's tolerance (1e-5 of max |logit|,
    equal argmax) and the same cache writes; an idle row (lengths 0)
    leaves its cache bits as they were. The last live position's logits
    are what prefill_chunk returns for the same chunk."""
    from test_torch_model import (TABLES, _close, _cmp_cache, _dense_caches,
                                  _paged_caches)
    import jax.numpy as jnp
    cfg, jp, tcfg, tp = models
    rng = np.random.default_rng(4)
    toks = rng.integers(1, 1000, (3, 4)).astype(np.int32)
    start = np.array([5, 40, 9], np.int32)
    lengths = np.array([4, 2, 0], np.int32)            # row 2 idle
    targs = (torch.tensor(toks),)
    if paged:
        jc, tc = _paged_caches(cfg, tcfg)
        jl, jc = M.paged_verify_step(jp, cfg, jnp.asarray(toks), jc,
                                     jnp.asarray(TABLES), start, lengths)
        tc0 = {"kv": {k: a.clone() for k, a in tc["kv"].items()}}
        tl, tc = TM.paged_verify_step(tp, tcfg, *targs, tc,
                                      torch.tensor(TABLES),
                                      torch.tensor(start),
                                      torch.tensor(lengths))
        last, _ = TM.paged_prefill_chunk(tp, tcfg, *targs, tc0,
                                         torch.tensor(TABLES),
                                         torch.tensor(start),
                                         torch.tensor(lengths))
        _cmp_cache(jc, tc, 12)
    else:
        jc, tc = _dense_caches(cfg, tcfg)
        row2 = tc["kv"]["k"][:, 2].clone()
        jl, jc = M.verify_step(jp, cfg, jnp.asarray(toks), jc, start,
                               lengths)
        tc0 = {"kv": {k: a.clone() for k, a in tc["kv"].items()}}
        tl, tc = TM.verify_step(tp, tcfg, *targs, tc, torch.tensor(start),
                                torch.tensor(lengths))
        last, _ = TM.prefill_chunk(tp, tcfg, *targs, tc0,
                                   torch.tensor(start),
                                   torch.tensor(lengths))
        _cmp_cache(jc, tc, 3)
        assert torch.equal(tc["kv"]["k"][:, 2], row2)
    assert tl.shape == (3, 4, tcfg.vocab_size)
    jl = np.asarray(jl)
    for b in range(2):
        n = int(lengths[b])
        assert _close(tl[b, :n], jl[b, :n])
        assert (tl[b, :n].argmax(-1).numpy() == jl[b, :n].argmax(-1)).all()
        assert _close(tl[b, n - 1], last[b].numpy())


def test_spec_kernel_path_matches_plain(models):
    """decode_impl="kernel" (the plain versions of the CUDA kernels on the
    CPU) serves the mixed steps beside the verify windows: same tokens."""
    _, _, tcfg, tp = models
    reqs = _stream(seed=3)
    for paged in (False, True):
        plain, _ = _run(InferenceEngine, ServeRequest, tcfg, tp, reqs,
                        decode_impl="torch", **_layout(paged))
        got, _ = _run(InferenceEngine, ServeRequest, tcfg, tp, reqs,
                      decode_impl="kernel", decode_k=2, spec_k=4,
                      **_layout(paged))
        assert got == plain, f"paged={paged}"


def test_agent_loop_construction_matches_jax(cyclic):
    jcfg, jparams, _, tparams, _ = cyclic
    want = P.from_jax_numpy(jax.tree.map(np.asarray, jparams), device="cpu")

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + k + ".")
            else:
                yield prefix + k, v
    got = dict(leaves(tparams))
    for name, w in leaves(want):
        assert got[name].shape == w.shape, name
        torch.testing.assert_close(got[name], w, rtol=1e-6, atol=1e-7,
                                   msg=name)
    assert not got["layers.attn.wo"].any() and not got["layers.mlp.down"].any()


def _cycle_req(cycle, start, max_new, rid=0, l_in=64):
    return dict(rid=rid, tokens=[(start + j) % cycle for j in range(l_in)],
                max_new_tokens=max_new)


def _run_cyclic(engine_cls, request_cls, cfg, params, reqs, eos_id=None,
                **kw):
    return _run(engine_cls, request_cls, cfg, params, reqs, eos_id=eos_id,
                **dict(dict(n_max=2, c_max=512, c_chunk=32), **kw))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_agent_loop_accepts_everything(cyclic, paged):
    """Two in-cycle prompts prefilled together, then verify windows only:
    every window full (96 = 6 dispatches x 4 windows x 4 tokens), so
    acceptance is 1.0 and kappa 4.0 exactly; tokens equal the plain run's
    and the JAX engine's on its own construction."""
    jcfg, jparams, tcfg, tparams, cycle = cyclic
    reqs = [_cycle_req(cycle, s, max_new=96, rid=i)
            for i, s in enumerate((0, 17))]
    plain, _ = _run_cyclic(InferenceEngine, ServeRequest, tcfg, tparams,
                           reqs, decode_k=4, **_layout(paged))
    got, eng = _run_cyclic(InferenceEngine, ServeRequest, tcfg, tparams,
                           reqs, decode_k=4, spec_k=4, **_layout(paged))
    ref, jeng = _run_cyclic(JaxEngine, JaxRequest, jcfg, jparams, reqs,
                            decode_k=4, spec_k=4, **_layout(paged))
    assert got == plain == ref
    assert got[0] == [(j + 64) % cycle for j in range(96)]
    st = eng.spec_stats
    assert st == jeng.spec_stats
    assert eng.spec_acceptance_rate() == 1.0
    assert eng.spec_kappa() == 4.0
    assert st["accepted_tokens"] == st["proposed_tokens"] \
        <= st["drafted_tokens"]


@pytest.mark.parametrize("decode_k", [1, 4])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_eos_inside_accepted_window(cyclic, paged, decode_k):
    """EOS by construction: the cycle token two places into the first
    window. The proposer drafts it and the model accepts it as a draft
    (not the bonus); the device truncates the window there and the host
    finishes the request after 3 tokens, as the plain run does. The EOS
    id also sits in the prompt, which must never terminate a request."""
    _, _, tcfg, tparams, cycle = cyclic
    start = 5
    eos = (start + 64 + 2) % cycle
    reqs = [_cycle_req(cycle, start, max_new=32),
            _cycle_req(cycle, 30, max_new=32, rid=1)]
    base, _ = _run_cyclic(InferenceEngine, ServeRequest, tcfg, tparams, reqs,
                          eos_id=eos, **_layout(paged))
    got, eng = _run_cyclic(InferenceEngine, ServeRequest, tcfg, tparams,
                           reqs, eos_id=eos, decode_k=decode_k, spec_k=4,
                           **_layout(paged))
    assert got == base
    assert got[0][-1] == eos and len(got[0]) == 3
    assert eos in reqs[0]["tokens"]
    assert got[1][-1] == eos and len(got[1]) < 32
    assert eng.spec_stats["accepted_tokens"] >= 2
    assert not eng.busy()


def test_spec_budget_never_exceeded(cyclic):
    """Full acceptance would overshoot max_new without the per-window clip
    (w <= budget - 1): a 7-token budget under spec_k = 8 emits exactly 7
    tokens, the plain run's."""
    _, _, tcfg, tparams, cycle = cyclic
    reqs = [_cycle_req(cycle, 9, max_new=7)]
    base, _ = _run_cyclic(InferenceEngine, ServeRequest, tcfg, tparams, reqs,
                          decode_k=4)
    got, eng = _run_cyclic(InferenceEngine, ServeRequest, tcfg, tparams,
                           reqs, decode_k=4, spec_k=8)
    assert got == base and len(got[0]) == 7
    assert eng.spec_acceptance_rate() == 1.0


def test_spec_rejects_windowed_attention(models):
    _, _, tcfg, tp = models
    wcfg = dataclasses.replace(tcfg, attention_window=32)
    with pytest.raises(NotImplementedError, match="speculative"):
        InferenceEngine(wcfg, tp, n_max=2, c_max=128, spec_k=4)


def test_draft_copy_proposes_like_jax():
    rng = np.random.default_rng(0)
    for _ in range(200):
        h = [int(t) for t in rng.integers(0, 6, int(rng.integers(0, 40)))]
        n, ng = int(rng.integers(-1, 12)), int(rng.integers(1, 5))
        assert propose_draft(h, n, ng) == jax_propose_draft(h, n, ng)


def _launcher_lines(argv, monkeypatch, jax_params):
    """The JAX launcher's and the port's stdout for the same flags, the
    port serving the JAX launcher's weights; only the lines both print
    (routing, per-engine speculation and overload) are returned."""
    from repro.launch import serve as JS
    from repro_torch.launch import serve as TS
    keep = ("  req ", "engine hot path", "served ")

    def lines(text):
        out = []
        for ln in text.splitlines():
            if ln.startswith("served "):
                ln = ln.split(" in ")[0]          # drop the wall time
            if ln.startswith(keep) or "kappa=" in ln or "overload" in ln:
                out.append(ln)
        return out
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        JS.main()
    ref = lines(buf.getvalue())
    monkeypatch.setattr(TM, "init_params",
                        lambda cfg, seed=0, device="cuda": P.from_jax_numpy(
                            jax_params, device=device))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        TS.main(argv + ["--device", "cpu"])
    return lines(buf.getvalue()), ref


@pytest.fixture(scope="module")
def launcher_params():
    """M.init_params(reduced minitron-8b f32, PRNGKey(0)): what the JAX
    launcher builds, as numpy arrays."""
    cfg = reduced_f32("minitron-8b")
    return jax.tree.map(np.asarray, M.init_params(cfg, jax.random.PRNGKey(0)))


def test_launcher_prints_jax_lines(monkeypatch, launcher_params):
    got, ref = _launcher_lines(
        ["--reduced", "--fleet", "2", "--paged", "--decode-k", "4",
         "--spec-k", "4"], monkeypatch, launcher_params)
    assert got == ref
    assert sum("kappa=" in ln for ln in got) == 2
    assert sum(ln.startswith("  req ") for ln in got) == 3

