"""The two layouts of the port's dense KV cache that go beyond the plain
fp row, against the JAX package: the int8 cache (values plus per-token
scales) on the chunk, mixed and verify paths, and the sliding-window ring
(min(cache_len, window) entries, position p at slot p % S) on every
dense entry point, ``loss_fn`` included. Both packages run reduced
minitron-8b in f32 on the same weights (the JAX parameters carried
across with ``params.from_jax_numpy``) and the same inputs, made from
one numpy seed per test.

Tolerances (those of tests/test_torch_forward.py): f32 on both sides
with matmuls summed in another order, so logits, attention outputs and
fp cache entries are held to 1e-5 of the largest magnitude; int8 values
to +-1 (an entry at a rounding edge may round the other way when its f32
input differs in the last bits) and scales to 1e-5 relative. Where both
packages start from the same bits (the chunk writer fed the same K/V)
the int8 cache is held bitwise. Within the port, an idle or masked row
is a bitwise no-op and mixed equals sequential, bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduced_f32
from jax_compile_cache import jax_compile_cache  # noqa: F401
from repro.models import layers as JL
from repro.models import model as M
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.training import train_step as JT
from repro_torch import params as P
from repro_torch.configs.base import get_config
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serving.engine import InferenceEngine
from repro_torch.training import train_step as TS
from repro_torch.training import tree


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
# An int8 entry that rounds the other way (its f32 input a few ulps off
# JAX's, at a rounding edge) moves that dequantized entry by one scale
# step, max|x| / 127: the read on the int8 fused chunk was 2.3e-5 of
# max|logit| (every other call ~1e-6). Logits of a call whose cache
# writes differ so are held to this bound; all others to TOL.
INT8_EDGE_TOL = 1e-4
WINDOWS = (16, 64)


def port_cfg(**overrides):
    return dataclasses.replace(get_config("minitron-8b").reduced(),
                               dtype="float32", **overrides)


@pytest.fixture(scope="module")
def models():
    """(jax cfg, jax params, port cfg, port params): reduced minitron-8b
    in f32, full attention and fp cache (tests replace the window and the
    cache dtype on both configs alike)."""
    cfg = reduced_f32("minitron-8b")
    jp = M.init_params(cfg, jax.random.PRNGKey(0))
    tp = P.from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, port_cfg(), tp


def _with(models, **change):
    cfg, jp, tcfg, tp = models
    return (dataclasses.replace(cfg, **change), jp,
            dataclasses.replace(tcfg, **change), tp)


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() <= tol * max(1.0, np.abs(ref).max())


def _tok(seed, shape):
    return np.random.default_rng(seed).integers(1, 1000, shape).astype(
        np.int32)


def _kv_close(got, ref):
    """A port KV dict (torch) against a JAX one: fp leaves within TOL,
    int8 values within 1, scales within TOL relative."""
    assert set(got) == set(ref)
    for name, g in got.items():
        r = np.asarray(ref[name])
        g = g.numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, name
        if g.dtype == np.int8:
            assert np.abs(g.astype(int) - r.astype(int)).max() <= 1, name
        elif name.endswith("_scale"):
            np.testing.assert_allclose(g, r, rtol=TOL, atol=0, err_msg=name)
        else:
            assert _close(g, r), name


def _clone(kv):
    return {k: v.clone() for k, v in kv.items()}


def _to_jax(kv):
    return {k: jnp.asarray(v.numpy()) for k, v in kv.items()}


# ------------------------------------------------------ decode over a ring
B, S_RING, HKV, HD = 3, 16, 4, 64
POS = {"uniform": 37, "per-row": [5, 20, 37], "masked": [5, 20, 37]}


def _ring_kv(seed, quant):
    """A full (B, S_RING) cache of random K/V (quantized by the port's
    quantize_kv for int8, bitwise JAX's)."""
    rng = np.random.default_rng(seed)
    kv = {n: torch.from_numpy(rng.standard_normal(
        (B, S_RING, HKV, HD)).astype(np.float32)) for n in ("k", "v")}
    if quant:
        for n in ("k", "v"):
            kv[n], kv[n + "_scale"] = TL.quantize_kv(kv[n])
    return kv


@pytest.mark.parametrize("impl", ["torch", "kernel"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("mode", list(POS))
@pytest.mark.parametrize("window", [8, 16], ids=["w8", "w16"])
def test_decode_attention_window_matches_jax(models, window, mode, quant,
                                             impl):
    """decode_attention over a ring of 16 entries at positions past it
    (uniform, per row, and with a masked row), the window equal to the
    ring or shorter (then ``valid`` is no prefix): the output and the
    written cache against JAX's; the masked row's cache bitwise
    untouched (its output is garbage in JAX, zeros from the kernel's
    plain version)."""
    cfg, jp, tcfg, tp = models
    jattn = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tattn = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    x = np.random.default_rng(1).standard_normal(
        (B, 1, cfg.d_model)).astype(np.float32)
    kv = _ring_kv(2, quant)
    pos = POS[mode]
    active = np.array([True, False, True]) if mode == "masked" else None
    jout, jkv = JL.decode_attention(
        jattn, cfg, jnp.asarray(x), _to_jax(kv), jnp.asarray(pos),
        window=window, decode_impl="xla",
        active=None if active is None else jnp.asarray(active))
    tkv = _clone(kv)
    tout, _ = TL.decode_attention(
        tattn, tcfg, torch.from_numpy(x), tkv, torch.tensor(pos),
        window=window, decode_impl=impl,
        active=None if active is None else torch.from_numpy(active))
    rows = [0, 2] if active is not None else [0, 1, 2]   # masked: garbage
    assert _close(tout[rows], np.asarray(jout)[rows])
    _kv_close(tkv, jkv)
    if active is not None:
        for name in kv:
            assert torch.equal(tkv[name][1], kv[name][1])


@pytest.mark.parametrize("window", [8, 16], ids=["w8", "w16"])
def test_decode_index_ring_mask(window):
    """The ring's slot and age mask: slot p % S, valid the last
    min(p + 1, window) positions, as JAX's decode_attention builds them;
    a row before the ring fills sees a prefix."""
    kv = {"k": torch.zeros((4, S_RING, 1, 8))}
    pos = torch.tensor([0, 5, 20, 37])
    idx = TL.decode_index(port_cfg(), pos, kv, window=window)
    assert idx.slots.tolist() == [0, 5, 4, 5]
    assert idx.live.all()
    for b, p in enumerate(pos.tolist()):
        want = {q % S_RING for q in range(max(0, p - window + 1), p + 1)}
        assert set(np.flatnonzero(idx.valid[b].numpy())) == want


# ------------------------------------------------------- int8 chunk writes
@pytest.mark.parametrize("start", [[0, 4, 2], [9, 12, 0]],
                         ids=["inside", "overhang"])
def test_write_chunk_kv_int8_matches_jax(start):
    """The int8 chunk writer against JAX's on the same K/V bits: the
    chunk quantized, values and scales blended through one index
    (bitwise equal), the overhang rolled into place, and the idle row
    (lengths 0) and every entry past a row's length bitwise untouched."""
    rng = np.random.default_rng(3)
    s_max, l = 16, 8
    k, v = (rng.standard_normal((B, l, HKV, HD)).astype(np.float32)
            for _ in range(2))
    old = _ring_kv(4, True)
    lengths = np.array([8, 3, 0], np.int32)
    ref = JL.write_chunk_kv(_to_jax(old), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(start, jnp.int32),
                            jnp.asarray(lengths))
    got = TL.write_chunk_kv(_clone(old), torch.from_numpy(k),
                            torch.from_numpy(v), torch.tensor(start),
                            torch.from_numpy(lengths))
    assert s_max == S_RING
    for name in old:
        assert np.array_equal(got[name].numpy(), np.asarray(ref[name])), name
        assert torch.equal(got[name][2], old[name][2])
        for b in range(2):
            kept = set(range(start[b], start[b] + int(lengths[b])))
            for j in set(range(s_max)) - kept:
                assert torch.equal(got[name][b, j], old[name][b, j])


# ------------------------------------------ forward, prefill, decode, ring
@pytest.mark.parametrize("window", WINDOWS)
def test_windowed_forward_prefill_decode_match_jax(models, window):
    """reduced minitron-8b with attention_window 16 and 64: forward over
    40 tokens, prefill of 30 into cache_len 48 (a ring of 16, or 48
    padded), then 10 uniform decode steps through the ring's wrap: logits
    within 1e-5 of max|logit| at every step, the cache too; the last
    decode step equals the forward's last position."""
    cfg, jp, tcfg, tp = _with(models, attention_window=window)
    toks = _tok(window, (2, 40))
    jl, _ = M.forward(jp, cfg, {"tokens": jnp.asarray(toks)})
    tl, _ = TM.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert _close(tl, jl)
    if window < toks.shape[1]:                          # the window bites
        full, _ = TM.forward(tp, port_cfg(),
                             {"tokens": torch.from_numpy(toks)})
        assert not _close(tl[:, window:], full[:, window:])
    jlog, jc = M.prefill(jp, cfg, {"tokens": jnp.asarray(toks[:, :30]),
                                   "cache_len": 48})
    tlog, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks[:, :30]),
                                     "cache_len": 48})
    assert tc["kv"]["k"].shape[2] == min(48, window)
    assert _close(tlog, jlog)
    _kv_close(tc["kv"], jc["kv"])
    for t in range(30, 40):
        jlog, jc = M.decode_step(jp, cfg, jnp.asarray(toks[:, t:t + 1]), jc,
                                 t)
        tlog, tc = TM.decode_step(tp, tcfg, torch.from_numpy(toks[:, t:t + 1]),
                                  tc, t)
        assert _close(tlog, jlog), t
    _kv_close(tc["kv"], jc["kv"])
    assert _close(tlog, tl[:, -1])


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("window", [0, 16], ids=["no-window", "w16"])
def test_prefill_ring_layout_matches_jax(models, window, quant):
    """prefill with cache_len < S (12 < 30 without a window; a ring of 16
    with one): the last entries in JAX's ring layout, fp or int8; the
    int8 ring is bitwise the quantized fp ring."""
    change = dict(attention_window=window)
    if quant:
        change["kv_cache_dtype"] = "int8"
    cfg, jp, tcfg, tp = _with(models, **change)
    toks = _tok(5, (2, 30))
    jl, jc = M.prefill(jp, cfg, {"tokens": jnp.asarray(toks),
                                 "cache_len": 12 if not window else 48})
    tl, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks),
                                   "cache_len": 12 if not window else 48})
    assert tc["kv"]["k"].shape[2] == (window or 12)
    assert _close(tl, jl)
    _kv_close(tc["kv"], jc["kv"])
    if quant:
        _, fc = TM.prefill(tp, dataclasses.replace(tcfg, kv_cache_dtype=""),
                           {"tokens": torch.from_numpy(toks),
                            "cache_len": 12 if not window else 48})
        for n in ("k", "v"):
            q, scale = TL.quantize_kv(fc["kv"][n])
            assert torch.equal(tc["kv"][n], q)
            assert torch.equal(tc["kv"][n + "_scale"], scale)


# ------------------------------------------------ chunk, verify and mixed
CHUNKS = ((np.array([0, 0, 0]), np.array([8, 5, 0])),
          (np.array([8, 5, 0]), np.array([8, 8, 0])),
          (np.array([16, 13, 0]), np.array([8, 8, 4])),
          (np.array([24, 21, 4]), np.array([3, 8, 8])))


def _chunk_call(mod, fn, params, cfg, toks, cache, start, lengths, impl):
    """One call of ``fn`` (prefill_chunk, verify_step or mixed_step, the
    decode rows of mixed being the rows with lengths 0) in package
    ``mod``; returns (logits, cache)."""
    if fn == "mixed_step":
        dec_active = lengths == 0
        dec_tok = toks[:, :1]
        return mod.mixed_step(params, cfg, toks, cache, start, lengths,
                              dec_tok, dec_active, decode_impl=impl)
    return getattr(mod, fn)(params, cfg, toks, cache, start, lengths,
                            decode_impl=impl)


def _chunk_parity(models, fn, impl, **change):
    """Four chunks of 8 through ``fn`` in both packages, from empty
    caches of 3 rows x 40; each call's logits compared where they are
    defined (active rows; verify: positions below lengths; mixed: the
    decode rows), and the caches after every call. Each call starts both
    packages from the same cache bits (the port takes JAX's), so an int8
    value that rounded the other way in an earlier call does not carry
    into the next call's logits; where the call's own chunk left one so,
    its logits are held to INT8_EDGE_TOL. Within the port, a row a call
    leaves idle is bitwise untouched."""
    cfg, jp, tcfg, tp = _with(models, **change)
    jc = M.init_cache(cfg, B, 40)
    tc = TM.init_cache(tcfg, B, 40, device="cpu")
    for i, (start, lengths) in enumerate(CHUNKS):
        toks = _tok(10 + i, (B, 8))
        for n, leaf in tc["kv"].items():
            leaf.copy_(torch.from_numpy(np.array(jc["kv"][n])))
        before = _clone(tc["kv"])
        jl, jc = _chunk_call(M, fn, jp, cfg, jnp.asarray(toks), jc,
                             jnp.asarray(start, jnp.int32),
                             jnp.asarray(lengths, jnp.int32), "xla")
        tl, tc = _chunk_call(TM, fn, tp, tcfg, torch.from_numpy(toks), tc,
                             torch.from_numpy(start),
                             torch.from_numpy(lengths), impl)
        jl, tl = np.asarray(jl), tl.numpy()
        tol = INT8_EDGE_TOL if any(
            not np.array_equal(t.numpy(), np.asarray(jc["kv"][n]))
            for n, t in tc["kv"].items() if t.dtype == torch.int8) else TOL
        for b in range(B):
            if fn == "verify_step":
                n = int(lengths[b])
                assert n == 0 or _close(tl[b, :n], jl[b, :n], tol), (i, b)
            elif (lengths[b] > 0) != (fn == "mixed_step"):
                assert _close(tl[b], jl[b], tol), (i, b)
            if lengths[b] == 0 and fn != "mixed_step":
                for n in before:
                    assert torch.equal(tc["kv"][n][:, b], before[n][:, b])
        _kv_close(tc["kv"], jc["kv"])


@pytest.mark.parametrize("fn", ["prefill_chunk", "verify_step",
                                "mixed_step"])
@pytest.mark.parametrize("window", WINDOWS)
def test_windowed_chunk_paths_match_jax(models, window, fn):
    """The masked per-token fallback the JAX package runs with a window:
    prefill_chunk (each row's logits at its last valid token), verify_step
    (every position) and mixed_step (a prefill chunk and a decode token),
    with an idle row, through the ring's wrap at window 16."""
    _chunk_parity(models, fn, "torch", attention_window=window)


@pytest.mark.parametrize("fn", ["prefill_chunk", "verify_step",
                                "mixed_step"])
def test_int8_fused_chunk_matches_jax(models, fn):
    """The fused chunk on an int8 cache: the chunk quantized into the
    cache, then attended dequantized, against JAX's."""
    _chunk_parity(models, fn, "torch", kv_cache_dtype="int8")


def test_windowed_chunk_runs_the_kernel_path(models, monkeypatch):
    """The per-token fallback goes through decode_step with the caller's
    decode_impl: one decode attention a layer a token column, through the
    kernel's wrapper for "kernel" (its plain version on the CPU), and it
    equals the torch path."""
    from repro_torch.kernels import ops
    cfg, jp, tcfg, tp = _with(models, attention_window=16)
    calls = []
    orig = ops.gqa_decode
    monkeypatch.setattr(ops, "gqa_decode",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    toks = torch.from_numpy(_tok(20, (B, 8)))
    start, lengths = torch.tensor([14, 0, 3]), torch.tensor([8, 0, 5])
    out = {}
    for impl in ("kernel", "torch"):
        cache = TM.init_cache(tcfg, B, 40, device="cpu")
        out[impl] = TM.prefill_chunk(tp, tcfg, toks, cache, start, lengths,
                                     decode_impl=impl)
    assert len(calls) == 8 * tcfg.num_layers
    assert _close(out["kernel"][0][[0, 2]], out["torch"][0][[0, 2]])
    assert not out["kernel"][0][1].any()          # the idle row: zeros


@pytest.mark.parametrize("kind", ["int8", "window", "int8+window"])
def test_mixed_equals_sequential_bitwise(models, kind):
    """Within the port, mixed_step is bitwise prefill_chunk then
    decode_step on the same rows, on the int8 cache, the ring, and both."""
    change = {"int8": dict(kv_cache_dtype="int8"),
              "window": dict(attention_window=16),
              "int8+window": dict(kv_cache_dtype="int8",
                                  attention_window=16)}[kind]
    _, _, tcfg, tp = _with(models, **change)
    cache = TM.init_cache(tcfg, B, 40, device="cpu")
    TM.prefill_chunk(tp, tcfg, torch.from_numpy(_tok(30, (B, 8))), cache,
                     torch.tensor([0, 0, 0]), torch.tensor([8, 8, 8]))
    for step in range(3):
        toks = torch.from_numpy(_tok(31 + step, (B, 8)))
        pos = torch.tensor([8 + 8 * step, 8 + step, 8 + step])
        lengths = torch.tensor([8, 0, 0])
        dec, act = toks[:, :1], torch.tensor([False, True, True])
        seq = {"kv": _clone(cache["kv"])}
        ml, cache = TM.mixed_step(tp, tcfg, toks, cache, pos, lengths, dec,
                                  act, decode_impl="torch")
        _, seq = TM.prefill_chunk(tp, tcfg, toks, seq, pos, lengths)
        sl, seq = TM.decode_step(tp, tcfg, dec, seq, pos, decode_impl="torch",
                                 active=act)
        assert torch.equal(ml[1:], sl[1:])
        for n in seq["kv"]:
            assert torch.equal(cache["kv"][n], seq["kv"][n])


# ----------------------------------------------------------------- training
@pytest.mark.parametrize("remat", [False, "layer"], ids=["none", "layer"])
def test_windowed_loss_and_grads_match_jax(models, remat):
    """loss_fn and its grads on a windowed config (window 16 over 32
    tokens) against jax.value_and_grad of the JAX loss: the loss within
    1e-5 relative, each grad leaf within 1e-5 of its max |g|."""
    cfg, jp, tcfg, tp = _with(models, attention_window=16)
    toks = _tok(40, (2, 33))
    labels = toks[:, 1:].copy()
    labels[1, -4:] = 0                              # padding
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]),
          "labels": torch.from_numpy(labels)}
    (jl, _), jg = jax.value_and_grad(JT.loss_fn, has_aux=True)(
        jp, cfg, jb, None, remat)
    (tl, _), tg = TS.value_and_grad(tp, tcfg, tb, remat=remat)
    assert float(tl) == pytest.approx(float(jl), rel=TOL)
    full, _ = TS.loss_fn(tp, port_cfg(), tb, None, remat)
    assert float(full) != float(tl)                 # the window bites
    got, want = tree.leaves(tg), jax.tree.leaves(jg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= TOL * np.abs(w).max()


# ------------------------------------------------------ refusals that stay
REFUSALS = {
    "paged+window": (dict(attention_window=16), dict(paged=True)),
    "paged+int8": (dict(kv_cache_dtype="int8"), dict(paged=True)),
    "spec+window": (dict(attention_window=16), dict(spec_k=2)),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_match_jax(models, case):
    """Paged + window, paged + int8 and speculation + window raise in the
    port's engine as in the JAX engine: NotImplementedError, the same
    message."""
    change, kw = REFUSALS[case]
    cfg, jp, tcfg, tp = _with(models, **change)
    with pytest.raises(NotImplementedError) as jerr:
        JaxEngine(cfg, jp, n_max=2, c_max=64, c_chunk=16, **kw)
    with pytest.raises(NotImplementedError) as terr:
        InferenceEngine(tcfg, tp, n_max=2, c_max=64, c_chunk=16, **kw)
    assert str(terr.value) == str(jerr.value)
