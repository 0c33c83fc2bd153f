"""The port's full-sequence path (repro_torch.models: ``forward``,
``prefill``, ``attention`` / ``_flash_causal``, the int8 dense KV cache)
and its batch launcher, against the JAX package on the same parameters
(carried across through numpy by ``repro_torch.params.from_jax_numpy``)
and the same seed-made inputs, plus port-only twins of the JAX package's
own consistency checks (decode == teacher forcing, prefill == forward,
int8 decode close to the fp forward).

Tolerances: f32 on both sides with matmuls summed in another order, so
logits are held to 1e-5 of max |logit| with equal argmax (as in
tests/test_torch_model.py); attention outputs to the 2e-5 of
tests/test_flash_attention.py; the twins keep the JAX tests' own bounds.
int8 values are held to +-1 (a value at a rounding edge may round the
other way when the f32 inputs differ in their last bits) and scales,
max|K| / 127, to the same 1e-5 relative as the logits: the two packages'
second-layer K/V differ by up to ~1.6e-6 relative (f32 products summed
in another order), and so do their scales. Where the inputs are the same
bits the quantizer is held bitwise.
"""
import contextlib
import dataclasses
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduced_f32
from repro.models import layers as JL
from repro.models import model as M
from repro_torch import params as P
from repro_torch.configs.base import get_config
from repro_torch.launch import serve as TS
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serving.engine import InferenceEngine


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one intra-op
    thread per worker keeps these small-shape tests from oversubscribing
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-5
B, S, CACHE = 3, 24, 40


def port_cfg(name="minitron-8b", **overrides):
    return dataclasses.replace(get_config(name).reduced(), dtype="float32",
                               **overrides)


@pytest.fixture(scope="module", params=[{}, {"num_kv_heads": 2}],
                ids=["qpk1", "qpk2"])
def models(request):
    """(jax cfg, jax params, port cfg, port params) for reduced
    minitron-8b in f32: q_per_kv 1 (as reduced) and 2."""
    cfg = reduced_f32("minitron-8b", **request.param)
    jp = M.init_params(cfg, jax.random.PRNGKey(0))
    tp = P.from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, port_cfg(**request.param), tp


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() <= tol * max(1.0, np.abs(ref).max())


def _tok(seed, shape):
    return np.random.default_rng(seed).integers(1, 1000, shape).astype(
        np.int32)


def _int8(cfg):
    return dataclasses.replace(cfg, kv_cache_dtype="int8")


# ---------------------------------------------------------------- forward
def test_forward_matches_jax(models):
    cfg, jp, tcfg, tp = models
    toks = _tok(0, (B, S))
    jl, jaux = M.forward(jp, cfg, {"tokens": jnp.asarray(toks)})
    tl, taux = TM.forward(tp, tcfg, {"tokens": torch.tensor(toks)})
    assert tl.shape == (B, S, cfg.vocab_size)
    assert _close(tl, jl)
    assert (tl.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).all()
    assert taux.dtype == torch.float32 and taux.dim() == 0
    assert float(taux) == float(jaux) == 0.0


# the shapes of tests/test_flash_attention.py::test_flash_vs_sdpa
FLASH_SHAPES = [(2, 256, 8, 2, 64, 64, 0), (1, 512, 4, 4, 32, 128, 0),
                (2, 256, 8, 2, 64, 64, 100), (1, 256, 2, 1, 64, 256, 0)]


@pytest.mark.parametrize("b,s,h,hkv,hd,chunk,window", FLASH_SHAPES,
                         ids=["gqa", "mha", "window", "one-chunk"])
def test_flash_causal_matches_jax(b, s, h, hkv, hd, chunk, window):
    """The port's _flash_causal against JAX's, and against the port's own
    _sdpa under causal_mask (which must equal JAX's causal_mask)."""
    rng = np.random.default_rng(s + h)
    q, k, v = (rng.standard_normal((b, s, n, hd)).astype(np.float32)
               for n in (h, hkv, hkv))
    ref = JL._flash_causal(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           h // hkv, window, chunk=chunk)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = TL._flash_causal(tq, tk, tv, h // hkv, window, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
    mask = TL.causal_mask(s, s, window)
    assert (mask.numpy() == np.asarray(JL.causal_mask(s, s, window))).all()
    dense = TL._sdpa(tq, tk, tv, mask[None], h // hkv)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=2e-5)


def test_forward_uses_flash_above_threshold(models, monkeypatch):
    """forward at S above the (patched) threshold takes _flash_causal and
    equals forward below it (the JAX test's 1e-4), and equals JAX's
    forward above the same patched threshold."""
    cfg, jp, tcfg, tp = models
    toks = _tok(1, (1, 128))
    dense, _ = TM.forward(tp, tcfg, {"tokens": torch.tensor(toks)})
    calls = []
    flash = TL._flash_causal
    monkeypatch.setattr(TL, "_flash_causal",
                        lambda *a, **kw: calls.append(1) or flash(*a, **kw))
    for mod in (TL, JL):
        monkeypatch.setattr(mod, "FLASH_MIN_SEQ", 64)
        monkeypatch.setattr(mod, "FLASH_CHUNK", 32)
    got, _ = TM.forward(tp, tcfg, {"tokens": torch.tensor(toks)})
    assert len(calls) == cfg.num_layers
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-4)
    ref, _ = M.forward(jp, cfg, {"tokens": jnp.asarray(toks)})
    assert _close(got, ref)


# ---------------------------------------------------------------- prefill
def test_prefill_matches_jax(models):
    """prefill with cache_len > S: last-token logits, the K/V cache, and
    the padding past S exactly zero."""
    cfg, jp, tcfg, tp = models
    toks = _tok(2, (B, S))
    jl, jc = M.prefill(jp, cfg, {"tokens": jnp.asarray(toks),
                                 "cache_len": CACHE})
    tl, tc = TM.prefill(tp, tcfg, {"tokens": torch.tensor(toks),
                                   "cache_len": CACHE})
    assert _close(tl, jl)
    assert (tl.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).all()
    for leaf in ("k", "v"):
        got = tc["kv"][leaf]
        assert got.shape == jc["kv"][leaf].shape
        assert _close(got, jc["kv"][leaf])
        assert not got[:, :, S:].any()


def test_prefill_int8_cache_matches_jax(models):
    """The int8 prefill cache: values within +-1 of JAX's, scales within
    1e-5 relative; the padding holds values 0 and the floor scale, as
    JAX's (quantized after the zero padding). Within the port it is
    bitwise the quantized fp prefill cache: the K/V forward implies."""
    cfg, jp, tcfg, tp = models
    toks = _tok(3, (B, S))
    jl, jc = M.prefill(jp, _int8(cfg), {"tokens": jnp.asarray(toks),
                                        "cache_len": CACHE})
    tl, tc = TM.prefill(tp, _int8(tcfg), {"tokens": torch.tensor(toks),
                                          "cache_len": CACHE})
    fl, fc = TM.prefill(tp, tcfg, {"tokens": torch.tensor(toks),
                                   "cache_len": CACHE})
    assert torch.equal(tl, fl)
    assert _close(tl, jl)
    for leaf in ("k", "v"):
        q, scale = TL.quantize_kv(fc["kv"][leaf])
        assert torch.equal(tc["kv"][leaf], q)
        assert torch.equal(tc["kv"][leaf + "_scale"], scale)
        got, ref = tc["kv"][leaf], np.asarray(jc["kv"][leaf])
        assert got.dtype == torch.int8 and got.shape == ref.shape
        assert np.abs(got.numpy().astype(int) - ref.astype(int)).max() <= 1
        assert not got[:, :, S:].any()
        gs, rs = tc["kv"][leaf + "_scale"], np.asarray(jc["kv"][leaf +
                                                               "_scale"])
        assert gs.dtype == torch.float32 and gs.shape == rs.shape
        np.testing.assert_allclose(gs.numpy(), rs, rtol=TOL, atol=0)
        assert (gs[:, :, S:].numpy() == rs[:, :, S:]).all()


# ------------------------------------------ twins of the JAX consistency tests
@pytest.mark.parametrize("name", ["minitron-8b", "llama3-70b",
                                  "qwen1.5-32b", "nemotron-4-15b",
                                  "nemotron-4-340b"])
def test_decode_matches_forward(name):
    """Port-only twin of tests/test_decode_consistency.py::
    test_decode_matches_forward on every dense config the port has: S
    uniform decode steps from an empty cache equal teacher forcing at the
    last position (the JAX test's bound, 2e-2 of max|logit|)."""
    tcfg = port_cfg(name)
    tp = TM.init_params(tcfg, seed=0, device="cpu")
    toks = torch.tensor(_tok(4, (2, 16)) % tcfg.vocab_size)
    ref = TM.forward(tp, tcfg, {"tokens": toks})[0][:, -1]
    cache = TM.init_cache(tcfg, 2, 32, device="cpu")
    for t in range(16):
        lg, cache = TM.decode_step(tp, tcfg, toks[:, t:t + 1], cache, t)
    scale = ref.abs().max().item() + 1e-9
    assert (lg - ref).abs().max().item() / scale < 2e-2


def test_prefill_matches_forward():
    """Port-only twin of test_decode_consistency.py::
    test_prefill_matches_forward (llama3-70b reduced, atol 1e-4)."""
    tcfg = port_cfg("llama3-70b")
    tp = TM.init_params(tcfg, seed=0, device="cpu")
    toks = torch.tensor(_tok(5, (2, 16)))
    logits_tf, _ = TM.forward(tp, tcfg, {"tokens": toks})
    last, cache = TM.prefill(tp, tcfg, {"tokens": toks, "cache_len": 32})
    torch.testing.assert_close(last, logits_tf[:, -1], atol=1e-4, rtol=0)
    nxt = torch.zeros((2, 1), dtype=torch.long)
    lg, _ = TM.decode_step(tp, tcfg, nxt, cache, 16)
    logits2, _ = TM.forward(tp, tcfg, {"tokens": torch.cat([toks, nxt], 1)})
    torch.testing.assert_close(lg, logits2[:, -1], atol=1e-4, rtol=0)


# ------------------------------------------------------------------- int8
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bitwise(dtype):
    """quantize_kv / dequantize_kv bitwise equal to JAX's on the same
    input: random rows, an all-zero row (the 1e-8 floor) and rows with
    values at exact half steps of their scale (round half to even)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 5, 3, 64)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0
    x[1, 1, 1] = np.arange(64) - 31.5          # scale 32/127: k + 0.5 steps
    x[1, 1, 1, 0] = 127 * 0.25
    x[2, 2, 2] = (np.arange(64) % 7 - 3) * 0.5
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        TL.torch_dtype(dtype))
    jq, js = JL.quantize_kv(jx)
    tq, ts = TL.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == tx.dtype
    assert (tq.numpy() == np.asarray(jq)).all()
    assert (ts.float().numpy() == np.asarray(js.astype(jnp.float32))).all()
    jd = JL.dequantize_kv(jq, js)
    td = TL.dequantize_kv(tq, ts)
    assert td.dtype == tx.dtype
    assert (td.float().numpy() == np.asarray(jd.astype(jnp.float32))).all()


def _carry_cache(jc):
    return {"kv": {k: torch.from_numpy(np.array(v))
                   for k, v in jc["kv"].items()}}


@pytest.mark.parametrize("mode", ["uniform", "ragged"])
def test_int8_decode_step_matches_jax(models, mode):
    """decode_step on a JAX-made int8 cache carried across: logits within
    1e-5; the written entries' values within +-1 and scales within 1e-5
    relative of JAX's; every other entry bitwise the carried-in bits, a
    masked row's scales included."""
    cfg, jp, tcfg, tp = models
    cfgq, tcfgq = _int8(cfg), _int8(tcfg)
    toks = _tok(7, (B, S))
    _, jc = M.prefill(jp, cfgq, {"tokens": jnp.asarray(toks),
                                 "cache_len": CACHE})
    tc = _carry_cache(jc)
    before = {k: v.clone() for k, v in tc["kv"].items()}
    nxt = _tok(8, (B, 1))
    if mode == "uniform":
        pos, active, jpos, jact = S, None, S, None
        written = [(b, S) for b in range(B)]
    else:
        pos = torch.tensor([S, S + 5, 3])
        active = torch.tensor([True, True, False])
        jpos, jact = jnp.asarray(pos.numpy()), jnp.asarray(active.numpy())
        written = [(0, S), (1, S + 5)]
    jl, jc = M.decode_step(jp, cfgq, jnp.asarray(nxt), jc, jpos,
                           active=jact)
    tl, tc = TM.decode_step(tp, tcfgq, torch.tensor(nxt), tc, pos,
                            active=active)
    rows = [b for b, _ in written]
    assert _close(tl[rows], np.asarray(jl)[rows])
    assert (tl[rows].argmax(-1).numpy()
            == np.asarray(jl)[rows].argmax(-1)).all()
    for leaf, got in tc["kv"].items():
        ref = np.asarray(jc["kv"][leaf])
        mask = np.zeros(ref.shape[:3], bool)
        for b, p in written:
            mask[:, b, p] = True
        if leaf in ("k", "v"):
            diff = np.abs(got.numpy().astype(int) - ref.astype(int))
            assert diff[mask].max() <= 1
        else:
            np.testing.assert_allclose(got.numpy()[mask], ref[mask],
                                       rtol=TOL, atol=0)
        assert torch.equal(got[torch.from_numpy(~mask)],
                           before[leaf][torch.from_numpy(~mask)])


def test_uniform_write_past_the_cache_clamps_like_jax(models):
    """A scalar position past the cache is JAX's dynamic_update_slice:
    every row writes at S-1 (not dropped as a masked scatter is)."""
    cfg, jp, tcfg, tp = models
    jc = M.init_cache(cfg, B, 8)
    tc = TM.init_cache(tcfg, B, 8, device="cpu")
    nxt = _tok(9, (B, 1))
    _, jc = M.decode_step(jp, cfg, jnp.asarray(nxt), jc, 11)
    _, tc = TM.decode_step(tp, tcfg, torch.tensor(nxt), tc, 11)
    for leaf in ("k", "v"):
        assert tc["kv"][leaf][:, :, -1].abs().sum() > 0
        assert not tc["kv"][leaf][:, :, :-1].any()
        assert _close(tc["kv"][leaf], jc["kv"][leaf])


def test_int8_kv_decode_close(models):
    """Twin of tests/test_perf_opts.py::test_int8_kv_decode_close: S
    decode steps through an int8 cache stay within 5% of max|logit| of
    the fp forward."""
    _, _, tcfg, tp = models
    toks = torch.tensor(_tok(10, (2, 16)))
    ref = TM.forward(tp, tcfg, {"tokens": toks})[0][:, -1]
    cache = TM.init_cache(_int8(tcfg), 2, 32, device="cpu")
    assert cache["kv"]["k"].dtype == torch.int8
    for t in range(16):
        lg, cache = TM.decode_step(tp, _int8(tcfg), toks[:, t:t + 1], cache,
                                   t)
    assert ((lg - ref).abs().max() / ref.abs().max()).item() < 0.05


def test_int8_kv_ragged_positions(models):
    """Twin of tests/test_perf_opts.py::test_int8_kv_ragged_positions."""
    _, _, tcfg, tp = models
    cache = TM.init_cache(_int8(tcfg), 2, 32, device="cpu")
    lg, _ = TM.decode_step(tp, _int8(tcfg), torch.zeros((2, 1), dtype=int),
                           cache, torch.tensor([0, 3]))
    assert not torch.isnan(lg).any()


# ---------------------------------------------------------------- launcher
@pytest.fixture(scope="module")
def launcher_inputs():
    """What the JAX batch launcher builds from PRNGKey(0) for reduced
    minitron-8b: its parameters (numpy) and the prompt ids' key."""
    cfg = reduced_f32("minitron-8b")
    key = jax.random.PRNGKey(0)
    return cfg, key, jax.tree.map(np.asarray, M.init_params(cfg, key))


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_batch_launcher_prints_jax_sequence(launcher_inputs, monkeypatch,
                                            int8):
    """The batch launcher run in process on the JAX launcher's weights and
    prompt ids: its ``first sequence`` line equals
    ``repro.launch.serve.main``'s. The JAX launcher builds its 1x1 mesh
    with ``jax.make_mesh``; it is given Auto axes, the sharding mode the
    launcher was written for (this JAX's default, Explicit, refuses the
    embedding gather it traces)."""
    from jax.sharding import AxisType
    from repro.launch import serve as JS
    cfg, key, jparams = launcher_inputs
    argv = ["--reduced", "--batch", "2", "--prompt-len", "16",
            "--new-tokens", "4"] + (["--int8-kv"] if int8 else [])
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
    toks = np.asarray(jax.random.randint(key, (2, 16), 1, cfg.vocab_size))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = TS.serve_batch(TS.parse_args(argv + ["--device", "cpu"]),
                             params=P.from_jax_numpy(jparams, device="cpu"),
                             tokens=torch.from_numpy(toks))
    out = buf.getvalue().splitlines()
    assert [ln for ln in out if ln.startswith("first sequence:")] == ref
    assert len(ref) == 1 and run.tokens.shape == (2, 4)
    assert out[0].startswith(f"arch={cfg.name} mesh 1x1 batch=2 prompt=16 "
                             "-> 4 new tokens")
    assert any(ln.startswith("prefill: ") for ln in out)
    assert any(ln.startswith("decode: ") for ln in out)
    assert len(run.logits) == 4
    assert (run.cache["kv"]["k"].dtype == torch.int8) == int8


def test_batch_launcher_draws_its_own_inputs():
    """Without weights or prompts passed in, the launcher draws both from
    seed 0 on its device: two runs are the same."""
    args = TS.parse_args(["--reduced", "--batch", "2", "--prompt-len", "8",
                          "--new-tokens", "3", "--device", "cpu"])
    with contextlib.redirect_stdout(io.StringIO()):
        a, b = TS.serve_batch(args), TS.serve_batch(args)
    assert torch.equal(a.tokens, b.tokens)
    assert args.fleet == 0


# ---------------------------------------------------------------- refusals
WINDOW = {"attention_window": 16}


@pytest.mark.parametrize("call", ["forward", "prefill", "decode_step"])
def test_window_config_refused(call):
    tcfg = port_cfg(**WINDOW)
    tp = TM.init_params(port_cfg(), seed=0, device="cpu")
    toks = torch.ones((1, 4), dtype=torch.long)
    cache = TM.init_cache(port_cfg(), 1, 8, device="cpu")
    fn = {"forward": lambda: TM.forward(tp, tcfg, {"tokens": toks}),
          "prefill": lambda: TM.prefill(tp, tcfg, {"tokens": toks}),
          "decode_step": lambda: TM.decode_step(tp, tcfg, toks[:, :1], cache,
                                                0)}[call]
    with pytest.raises(NotImplementedError, match="later slice"):
        fn()


def test_prefill_shorter_cache_refused():
    """cache_len < S is the JAX package's ring layout (keep the last
    cache_len entries), which the port does not run yet: refused, never
    cropped."""
    tp = TM.init_params(port_cfg(), seed=0, device="cpu")
    toks = torch.ones((1, 8), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="ring-buffer"):
        TM.prefill(tp, port_cfg(), {"tokens": toks, "cache_len": 4})


def test_int8_config_refused_by_engine_and_chunk_path():
    tcfg = _int8(port_cfg())
    tp = TM.init_params(port_cfg(), seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="int8-engine slice"):
        InferenceEngine(tcfg, tp, n_max=2, c_max=32)
    cache = TM.init_cache(tcfg, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        TM.prefill_chunk(tp, tcfg, torch.ones((1, 4), dtype=torch.long),
                         cache, torch.tensor([0]), torch.tensor([4]))


def test_sharded_mesh_refused():
    args = TS.parse_args(["--reduced", "--mesh", "2x1", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="sharded serving"):
        TS.serve_batch(args)
