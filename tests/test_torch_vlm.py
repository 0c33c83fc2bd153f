"""The VLM family's model entry points (repro_torch.models.model, VLM
branch, and layers.cross_attention) against the JAX package, on the same
weights (the JAX parameters carried across with
``params.from_jax_numpy``) and the same seed-made inputs, in f32.

Variants: reduced llama-3.2-vision-11b (2 layers, one group of 2 decoder
layers and a cross layer, q_per_kv 1) and a 4-layer copy with 2 KV heads
(two groups, q_per_kv 2), both with the cross layers' ``gate`` /
``gate_mlp`` set to 0.5 / -0.7 in the JAX tree before it is carried
across; and the reduced model with the reference's own zero gates, where
every cross layer is the identity (a wrong cross-attention would pass
there, which is why the gated variants exist). The frontend is random,
normal x 0.02 from a numpy seed (a constant frontend makes the cross
softmax uniform whatever the weights).

* ``cross_attention`` and ``_cross_block`` alone; ``forward`` (remat
  none and "layer") and its aux (zero); ``prefill``: logits and every
  cache leaf, the self-attention K/V held against the reference's
  grouped (n_groups, every, B, S, ...) leaves reshaped to the port's
  flat (num_layers, B, S, ...), and the cross memory's ``xk`` / ``xv``.
* ``decode_step`` at per-row positions with an inactive row (its cache
  rows bitwise untouched), through the torch path and the kernel's plain
  version, and at a uniform position; two chunks of ``prefill_chunk`` /
  ``verify_step`` / ``mixed_step`` (the per-token loop) from a prefilled
  cache, an idle row bitwise untouched.
* Decode equals teacher forcing (the JAX test's 2e-2 of max|logit|) on
  the port's own weights with nonzero gates.
* ``loss_fn`` and its grads, remat none and "layer": each leaf within
  TOL of its max |g|.
* The port's ``init_params`` gives the reference's parameter tree; its
  cache the flat layout; VLM and ENCDEC pass ``check_supported``, the
  paged pool refuses both with the reference's words, MLA names its
  slice.

Every comparison is within TOL = 1e-5 of the reference's max.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduced_f32
from jax_compile_cache import jax_compile_cache  # noqa: F401
from repro.models import layers as JL
from repro.models import model as M
from repro.training import train_step as JT
from repro_torch import params as P
from repro_torch.configs.base import MLAConfig, get_config
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.training import train_step as TS
from repro_torch.training import tree

ARCH = "llama-3.2-vision-11b"
TOL = 1e-5
B = 3
GATES = (0.5, -0.7)            # gate, gate_mlp of every cross layer
# name -> (config overrides, gates or None for the reference's zeros)
VARIANTS = {"gated": ({}, GATES),
            "gated-2-groups": ({"num_layers": 4, "num_kv_heads": 2}, GATES),
            "zero-gates": ({}, None)}
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


def port_cfg(**overrides):
    return dataclasses.replace(get_config(ARCH).reduced(), dtype="float32",
                               **overrides)


def set_gates(jp, gates):
    """The JAX tree with every cross layer's gate / gate_mlp set to
    ``gates`` (None: unchanged, the reference's zeros)."""
    if gates is None:
        return jp
    cross = dict(jp["cross"],
                 gate=jnp.full_like(jp["cross"]["gate"], gates[0]),
                 gate_mlp=jnp.full_like(jp["cross"]["gate_mlp"], gates[1]))
    return dict(jp, cross=cross)


def jax_weights(cfg, gates=GATES):
    """The JAX init_params tree (PRNGKey(0)) with ``gates``, and the
    port's copy."""
    jp = set_gates(M.init_params(cfg, jax.random.PRNGKey(0)), gates)
    return jp, P.from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module", params=list(VARIANTS))
def models(request):
    """(jax cfg, jax params, port cfg, port params, gates) of one
    variant."""
    kw, gates = VARIANTS[request.param]
    cfg = reduced_f32(ARCH, **kw)
    jp, tp = jax_weights(cfg, gates)
    return cfg, jp, port_cfg(**kw), tp, gates


def frontend(seed, b, cfg):
    """A random frontend, normal x 0.02, (b, frontend_tokens, d_model)."""
    return (np.random.default_rng(seed).standard_normal(
        (b, cfg.frontend_tokens, cfg.d_model)) * 0.02).astype(np.float32)


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() <= tol * max(1.0, np.abs(ref).max())


def _tok(seed, shape):
    return np.random.default_rng(seed).integers(1, 1000, shape).astype(
        np.int32)


def flat_jax_cache(jc):
    """A JAX VLM cache in the port's layout: the grouped self-attention
    leaves (n_groups, every, B, S, ...) as (num_layers, B, S, ...); the
    cross memory as it is."""
    out = {"kv": {k: np.asarray(v).reshape(-1, *v.shape[2:])
                  for k, v in jc["kv"].items()}}
    out.update({k: np.asarray(jc[k]) for k in ("xk", "xv")})
    return out


def cache_close(tc, jc, tol=TOL):
    """Every leaf of a port VLM cache against the JAX one, the JAX one
    flattened (:func:`flat_jax_cache`): shapes and dtypes equal, values
    within ``tol`` of the leaf's max."""
    want = flat_jax_cache(jc)
    assert set(tc) == set(want) == {"kv", "xk", "xv"}
    got, ref = tree.leaves(tc), tree.leaves(want)
    assert len(got) == len(ref)
    for g, w in zip(got, ref):
        g = g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1e-30)


def row_views(cache, b):
    """Row ``b`` of every leaf of a port VLM cache (the batch on axis 1
    in every leaf)."""
    return [leaf.select(1, b).clone() for leaf in tree.leaves(cache)]


def _prefilled(models, toks, cache_len, seed=7):
    """Both packages' prefill of ``toks`` over one random frontend."""
    cfg, jp, tcfg, tp, _ = models
    fe = frontend(seed, toks.shape[0], cfg)
    jl, jc = M.prefill(jp, cfg, {"tokens": jnp.asarray(toks),
                                 "frontend": jnp.asarray(fe),
                                 "cache_len": cache_len})
    tl, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks),
                                   "frontend": torch.from_numpy(fe),
                                   "cache_len": cache_len})
    return (jl, jc), (tl, tc)


# ---------------------------------------------------------- cross blocks
def test_cross_attention_and_block_match_jax(models):
    """``layers.cross_attention`` and ``model._cross_block`` of group 0
    on a random (B, 12, D) stream over a random frontend."""
    cfg, jp, tcfg, tp, _ = models
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 12, cfg.d_model)).astype(np.float32)
    fe = frontend(4, B, cfg)
    jcp = jax.tree.map(lambda a: a[0], jp["cross"])
    tcp = tree.map(lambda t: t[0], tp["cross"])
    want = JL.cross_attention(jcp["xattn"], cfg, jnp.asarray(x),
                              jnp.asarray(fe))
    got = TL.cross_attention(tcp["xattn"], tcfg, torch.from_numpy(x),
                             torch.from_numpy(fe))
    assert got.shape == want.shape and _close(got, want)
    want = M._cross_block(jcp, cfg, jnp.asarray(x), jnp.asarray(fe))
    got = TM._cross_block(tcp, tcfg, torch.from_numpy(x),
                          torch.from_numpy(fe))
    assert _close(got, want)
    # the zero gates make the block the identity, bit for bit
    assert np.array_equal(got.numpy(), x) == (float(tcp["gate"]) == 0.0)


# ---------------------------------------------------------------- forward
@pytest.mark.parametrize("remat", [False, "layer"], ids=["plain", "remat"])
def test_forward_matches_jax(models, remat):
    """forward over 2 x 24 tokens and a random frontend: logits within
    TOL of max|logit|; the aux a 0-d f32 zero, as the reference's."""
    cfg, jp, tcfg, tp, _ = models
    toks, fe = _tok(1, (2, 24)), frontend(2, 2, cfg)
    jl, jaux = M.forward(jp, cfg, {"tokens": jnp.asarray(toks),
                                   "frontend": jnp.asarray(fe)})
    tl, taux = TM.forward(tp, tcfg, {"tokens": torch.from_numpy(toks),
                                     "frontend": torch.from_numpy(fe)},
                          remat=remat)
    assert _close(tl, jl)
    assert taux.dtype == torch.float32 and taux.dim() == 0
    assert float(taux) == float(jaux) == 0.0


def test_prefill_matches_jax(models):
    """prefill of 3 x 20 tokens into cache_len 32: logits, the
    self-attention K/V (flat against the reference's grouped leaves) and
    the cross memory's xk / xv, (n_groups, B, F, Hkv, hd)."""
    cfg, jp, tcfg, tp, _ = models
    (jl, jc), (tl, tc) = _prefilled(models, _tok(2, (B, 20)), 32)
    assert _close(tl, jl)
    cache_close(tc, jc)
    n_groups = tcfg.num_layers // tcfg.cross_attn_every
    assert tc["kv"]["k"].shape == (tcfg.num_layers, B, 32,
                                   tcfg.num_kv_heads, 64)
    assert tc["xk"].shape == (n_groups, B, tcfg.frontend_tokens,
                              tcfg.num_kv_heads, 64)
    assert tc["xk"].abs().max() > 0


@pytest.mark.parametrize("impl", [("xla", "torch"), ("pallas", "kernel")],
                         ids=["xla-torch", "pallas-kernel"])
def test_decode_step_matches_jax(models, impl):
    """Three decode steps from a 20-token prefill at per-row positions
    (rows at 20, 23 and 20), row 2 inactive: active rows' logits within
    TOL, the caches too, and row 2 of every leaf bitwise untouched."""
    cfg, jp, tcfg, tp, _ = models
    toks = _tok(3, (B, 24))
    (_, jc), (_, tc) = _prefilled(models, toks[:, :20], 32)
    row2 = row_views(tc, 2)
    active = np.array([True, True, False])
    for i in range(3):
        pos = np.array([20 + i, 23 + i, 20 + i], np.int32)
        tok = toks[:, 20 + i:21 + i]
        jl, jc = M.decode_step(jp, cfg, jnp.asarray(tok), jc,
                               jnp.asarray(pos), decode_impl=impl[0],
                               active=jnp.asarray(active))
        tl, tc = TM.decode_step(tp, tcfg, torch.from_numpy(tok), tc,
                                torch.from_numpy(pos), decode_impl=impl[1],
                                active=torch.from_numpy(active))
        assert _close(tl[:2], np.asarray(jl)[:2]), i
    cache_close(tc, jc)
    for a, b in zip(row_views(tc, 2), row2):
        assert torch.equal(a, b)


def test_uniform_decode_matches_jax(models):
    """The batch launcher's step: a scalar position, no mask."""
    cfg, jp, tcfg, tp, _ = models
    toks = _tok(4, (2, 20))
    (jl, jc), (tl, tc) = _prefilled(models, toks[:, :16], 24)
    for t in range(16, 20):
        jl, jc = M.decode_step(jp, cfg, jnp.asarray(toks[:, t:t + 1]), jc, t)
        tl, tc = TM.decode_step(tp, tcfg, torch.from_numpy(toks[:, t:t + 1]),
                                tc, t)
        assert _close(tl, jl), t
    cache_close(tc, jc)


def test_decode_matches_forward(models):
    """Port-only twin of tests/test_decode_consistency.py::
    test_decode_matches_forward: a prefill of 4 tokens, then 12 uniform
    decode steps, equal the teacher-forced forward at every decoded
    position within 2e-2 of max|logit|, on the port's own weights with
    the variant's gates and a random frontend."""
    tcfg, gates = models[2], models[4]
    tp = TM.init_params(tcfg, seed=0, device="cpu")
    if gates is not None:
        tp["cross"]["gate"].fill_(gates[0])
        tp["cross"]["gate_mlp"].fill_(gates[1])
    toks = torch.tensor(_tok(5, (2, 16)) % tcfg.vocab_size)
    fe = torch.from_numpy(frontend(6, 2, tcfg))
    ref = TM.forward(tp, tcfg, {"tokens": toks, "frontend": fe})[0]
    lg, cache = TM.prefill(tp, tcfg, {"tokens": toks[:, :4],
                                      "frontend": fe, "cache_len": 32})
    scale = ref.abs().max().item() + 1e-9
    assert (lg - ref[:, 3]).abs().max().item() / scale < 2e-2
    for t in range(4, 16):
        lg, cache = TM.decode_step(tp, tcfg, toks[:, t:t + 1], cache, t)
        assert (lg - ref[:, t]).abs().max().item() / scale < 2e-2, t


# ------------------------------------------ chunk, verify and mixed steps
CHUNKS = ((np.array([8, 8, 8]), np.array([6, 3, 0])),
          (np.array([14, 11, 8]), np.array([2, 6, 4])))


def _chunk_call(mod, fn, params, cfg, toks, cache, start, lengths, impl):
    """One call of ``fn`` in package ``mod`` (mixed_step's decode rows
    are the rows with lengths 0, fed their first token)."""
    if fn == "mixed_step":
        return mod.mixed_step(params, cfg, toks, cache, start, lengths,
                              toks[:, :1], lengths == 0, decode_impl=impl)
    return getattr(mod, fn)(params, cfg, toks, cache, start, lengths,
                            decode_impl=impl)


@pytest.mark.parametrize("fn", ["prefill_chunk", "verify_step",
                                "mixed_step"])
def test_chunk_paths_match_jax(models, fn):
    """Two chunks of 6 through the masked per-token decode loop in both
    packages, from a prefill of 3 x 8 tokens over a random frontend (so
    the cross memory is live): each call's logits where defined
    (prefill: rows with tokens; verify: positions below lengths; mixed:
    the decode rows), the caches after every call, and a row a call
    leaves idle bitwise untouched (in mixed_step an idle prefill row
    decodes)."""
    cfg, jp, tcfg, tp, _ = models
    (_, jc), (_, tc) = _prefilled(models, _tok(9, (B, 8)), 32)
    for i, (start, lengths) in enumerate(CHUNKS):
        toks = _tok(10 + i, (B, 6))
        before = {b: row_views(tc, b) for b in range(B)}
        jl, jc = _chunk_call(M, fn, jp, cfg, jnp.asarray(toks), jc,
                             jnp.asarray(start, jnp.int32),
                             jnp.asarray(lengths, jnp.int32), "xla")
        tl, tc = _chunk_call(TM, fn, tp, tcfg, torch.from_numpy(toks), tc,
                             torch.from_numpy(start),
                             torch.from_numpy(lengths), "torch")
        jl, tl = np.asarray(jl), tl.numpy()
        for b in range(B):
            if fn == "verify_step":
                n = int(lengths[b])
                assert n == 0 or _close(tl[b, :n], jl[b, :n]), (i, b)
            elif (lengths[b] > 0) != (fn == "mixed_step"):
                assert _close(tl[b], jl[b]), (i, b)
            if lengths[b] == 0 and fn != "mixed_step":
                for x, y in zip(row_views(tc, b), before[b]):
                    assert torch.equal(x, y), (i, b)
        cache_close(tc, jc)


# ----------------------------------------------------------------- training
@pytest.mark.parametrize("remat", [False, "layer"], ids=["none", "layer"])
def test_loss_and_grads_match_jax(models, remat):
    """loss_fn and its grads over 2 x 16 tokens and a random frontend
    against jax.value_and_grad of the JAX loss: the loss within TOL
    relative, the aux zero, each grad leaf (the reference's tree, leaf
    for leaf) within TOL of its max |g|. With zero gates a cross layer's
    leaves get no gradient in either package but its two gates."""
    cfg, jp, tcfg, tp, gates = models
    toks = _tok(40, (2, 17))
    labels = toks[:, 1:].copy()
    labels[1, -4:] = 0                              # padding
    fe = frontend(41, 2, cfg)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(labels),
          "frontend": jnp.asarray(fe)}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]),
          "labels": torch.from_numpy(labels),
          "frontend": torch.from_numpy(fe)}
    (jl, _), jg = jax.value_and_grad(JT.loss_fn, has_aux=True)(
        jp, cfg, jb, None, remat)
    (tl, taux), tg = TS.value_and_grad(tp, tcfg, tb, remat=remat)
    assert float(tl) == pytest.approx(float(jl), rel=TOL)
    assert float(taux["lb_loss"]) == 0.0
    got = tree.leaves(tg)
    want = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(got) == len(want)
    for g, (path, w) in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        name = jax.tree_util.keystr(path)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        silent = gates is None and name.startswith("['cross']") \
            and name not in ("['cross']['gate']", "['cross']['gate_mlp']")
        assert (np.abs(w).max() == 0) == silent, name
        assert np.abs(g - w).max() <= TOL * max(np.abs(w).max(), 1e-30), \
            name


# ------------------------------------------------- layout, params, refusals
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_and_cache_layout(dtype):
    """The port's own init: the JAX package's parameter tree, shapes and
    dtypes (the gates zero, as the reference draws them); its cache:
    the reference's leaves with the grouped self-attention axes merged,
    all zeros; ``frontend_len`` sets F."""
    kw = VARIANTS["gated-2-groups"][0]
    tcfg = dataclasses.replace(port_cfg(**kw), dtype=dtype)
    jcfg = dataclasses.replace(reduced_f32(ARCH, **kw), dtype=dtype)
    p = TM.init_params(tcfg, seed=0, device="cpu")
    ref = jax.eval_shape(lambda: M.init_params(jcfg, jax.random.PRNGKey(0)))
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(
        ".")[-1]), p) == jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype)), ref)
    assert not p["cross"]["gate"].any() and not p["cross"]["gate_mlp"].any()
    for f_len in (None, 5):
        c = TM.init_cache(tcfg, 2, 24, device="cpu", frontend_len=f_len)
        jc = jax.eval_shape(lambda: M.init_cache(jcfg, 2, 24,
                                                 frontend_len=f_len))
        want = {"kv": {k: (a.shape[0] * a.shape[1],) + a.shape[2:]
                       for k, a in jc["kv"].items()},
                "xk": jc["xk"].shape, "xv": jc["xv"].shape}
        assert tree.map(lambda t: tuple(t.shape), c) == want
        assert c["xk"].shape[2] == (f_len or tcfg.frontend_tokens)
        assert all(t.dtype == TL.torch_dtype(dtype) and not t.any()
                   for t in tree.leaves(c))


def test_supported_and_refused():
    """VLM passes check_supported; on the paged pool it is refused with
    the reference's words (the JAX init_paged_cache raises them too);
    ENCDEC passes check_supported and the paged pool refuses it with
    those words too; MLA passes check_supported, and the paged pool
    refuses it with the reference's words."""
    tcfg, cfg = port_cfg(), reduced_f32(ARCH)
    assert TM.check_supported(get_config(ARCH)) is None
    assert TM.check_supported(tcfg) is None
    with pytest.raises(NotImplementedError, match=re.escape(PAGED_REASON)):
        M.init_paged_cache(cfg, 4, 16)
    with pytest.raises(NotImplementedError,
                       match=re.escape(PAGED_REASON + "; family='vlm'")):
        TM.check_supported(get_config(ARCH), paged=True)
    with pytest.raises(NotImplementedError, match=re.escape(PAGED_REASON)):
        TM.init_paged_cache(tcfg, 4, 16, device="cpu")
    encdec = dataclasses.replace(tcfg, family="encdec")
    assert TM.check_supported(encdec) is None
    with pytest.raises(NotImplementedError,
                       match=re.escape(PAGED_REASON + "; family='encdec'")):
        TM.check_supported(encdec, paged=True)
    mla = dataclasses.replace(get_config("minitron-8b"), family="moe",
                              mla=MLAConfig())
    assert TM.check_supported(mla) is None
    with pytest.raises(NotImplementedError,
                       match=re.escape(PAGED_REASON + "; family='moe' "
                                       "mla=True")):
        TM.check_supported(mla, paged=True)
