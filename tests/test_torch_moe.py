"""The port's MoE block (repro_torch.models.moe) and the MoE decoder's
model steps against the JAX package on reduced llama4-scout-17b-a16e
(f32: 4 experts, top-1, one shared expert, a window of 64), on the same
weights (the JAX parameters carried across with
``params.from_jax_numpy``) and the same seed-made inputs.

* ``moe_block`` alone, on llama4-scout and on a top-2 variant without a
  shared expert, at capacity_factor 1.25 on inputs skewed toward one
  expert (so its buffer overflows and pairs drop) and at 8.0 (no drop):
  outputs within 1e-5 of max|y|, ``lb_loss`` and ``router_fraction``
  within 1e-6, and the same set of dropped pairs. The JAX block reports
  no drops, so its set is read off its own ``_expert_apply``: the
  function is called a second time on ones (tokens and weights), whose
  output row is non-zero exactly where an expert took the row; at one
  shard the reference's send buffer holds the pairs in (token, choice)
  order, so buffer row i is pair i.
* A tie in the router goes to the lower expert, as ``jax.lax.top_k``.
* ``forward`` (logits and its aux, the load-balance losses summed over
  layers), ``prefill`` and the ``decode_step`` / ``prefill_chunk`` /
  ``mixed_step`` / ``verify_step`` logits on the dense ring (the
  config's window of 64, and 16, where it wraps), on the dense fused
  chunk and on the paged pool (window 0): within 1e-5 of max|logit|,
  caches too.
* ``loss_fn`` and its grads by tests/test_torch_training.py's rule: the
  loss within 1e-5 relative, each grad leaf within 1e-5 of its max |g|.
* ``from_jax_numpy(..., dtype=bfloat16)`` keeps the router in f32.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduced_f32
from jax_compile_cache import jax_compile_cache  # noqa: F401
from repro.models import model as M
from repro.models import moe as JMOE
from repro.training import train_step as JT
from repro_torch import params as P
from repro_torch.configs.base import get_config
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.training import train_step as TS
from repro_torch.training import tree

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_kvcache import _chunk_parity, _kv_close  # noqa: E402
from test_torch_model import (TABLES, _cmp_cache, _dense_caches,  # noqa: E402
                              _paged_caches)

ARCH = "llama4-scout-17b-a16e"
TOL = 1e-5
AUX_TOL = 1e-6
B = 3


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


def _moe_change(cfg, **moe):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))


@pytest.fixture(scope="module")
def models():
    """(jax cfg, jax params, port cfg, port params): reduced llama4-scout
    in f32 (window 64, capacity_factor 1.25)."""
    cfg = reduced_f32(ARCH)
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


# --------------------------------------------------------- the block alone
VARIANTS = {"scout": {}, "top2": dict(top_k=2, num_shared_experts=0)}


def _jax_dropped(monkeypatch, p, cfg, x):
    """(y, aux, dropped pair mask) of the JAX moe_block on ``x``: the
    module docstring's probe of ``_expert_apply``."""
    orig, probes = JMOE._expert_apply, []

    def probe(toks, eids, p, e_loc, ecap, valid=None):
        ones = {k: jnp.ones_like(p[k]) for k in ("w_gate", "w_up", "w_down")}
        probes.append(orig(jnp.ones_like(toks), eids, ones, e_loc, ecap,
                           valid))
        return orig(toks, eids, p, e_loc, ecap, valid)
    monkeypatch.setattr(JMOE, "_expert_apply", probe)
    y, aux = JMOE.moe_block(p, cfg, jnp.asarray(x), None)
    monkeypatch.setattr(JMOE, "_expert_apply", orig)
    (took,) = probes
    took = np.asarray(took).any(-1)
    n_pairs = x.shape[0] * x.shape[1] * cfg.moe.top_k
    dropped = np.ones(n_pairs, bool)
    n = min(n_pairs, took.shape[0])
    dropped[:n] = ~took[:n]
    return y, aux, dropped


def _skewed(cfg, router, seed, n_tok=64):
    """(2, n_tok / 2, D) f32 inputs, each a random row plus a push of 15
    along expert 0's router column: most tokens route there."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_tok, cfg.d_model)).astype(np.float32)
    col = np.asarray(router[:, 0])
    x += 15.0 * col / np.linalg.norm(col)
    return x.reshape(2, n_tok // 2, cfg.d_model)


@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_moe_block_matches_jax(monkeypatch, variant, cf):
    """moe_block on one layer's weights: outputs, lb_loss,
    router_fraction and the dropped pairs equal JAX's; at 1.25 the skewed
    inputs drop pairs, at 8.0 none."""
    cfg = _moe_change(reduced_f32(ARCH), capacity_factor=cf,
                      **VARIANTS[variant])
    tcfg = _moe_change(port_cfg(), capacity_factor=cf, **VARIANTS[variant])
    jp = JMOE.init_moe(jax.random.PRNGKey(3), cfg)
    tp = P.from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    assert ("shared" in tp) == bool(cfg.moe.num_shared_experts)
    x = _skewed(cfg, jp["router"], seed=7)
    jy, jaux, jdrop = _jax_dropped(monkeypatch, jp, cfg, x)
    ty, taux = TMOE.moe_block(tp, tcfg, torch.from_numpy(x))
    assert _close(ty, jy)
    assert abs(float(taux["lb_loss"]) - float(jaux["lb_loss"])) <= AUX_TOL
    np.testing.assert_allclose(taux["router_fraction"].numpy(),
                               np.asarray(jaux["router_fraction"]),
                               atol=AUX_TOL, rtol=0)
    assert np.array_equal(taux["dropped"].numpy(), jdrop)
    assert jdrop.any() == (cf == 1.25)
    cap, ecap = TMOE.capacities(tcfg, x.shape[0] * x.shape[1])
    counts = np.bincount(np.argsort(-np.asarray(jax.nn.softmax(
        x.reshape(-1, cfg.d_model) @ np.asarray(jp["router"]), -1)),
        kind="stable", axis=-1)[:, :cfg.moe.top_k].reshape(-1),
        minlength=cfg.moe.num_experts)
    assert jdrop.sum() == np.maximum(counts - ecap, 0).sum()


@pytest.mark.parametrize("top_k", [1, 2])
def test_router_tie_picks_the_lower_expert(top_k):
    """Experts 1 and 2 with the same router column (and a router of zeros:
    all four tied): the port's top k is jax.lax.top_k's, the lower index
    first."""
    cfg = _moe_change(port_cfg(), top_k=top_k)
    rng = np.random.default_rng(11)
    router = rng.standard_normal((cfg.d_model, 4)).astype(np.float32)
    router[:, 2] = router[:, 1]
    router[:, 0] = router[:, 3] = -10.0 * np.abs(router[:, 1])
    x = np.abs(rng.standard_normal((6, cfg.d_model))).astype(np.float32)
    for r in (router, np.zeros_like(router)):
        probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(r), -1)
        jgate, jidx = jax.lax.top_k(probs, top_k)
        _, tgate, tidx = TMOE.route(torch.from_numpy(r), cfg,
                                    torch.from_numpy(x))
        assert np.array_equal(tidx.numpy(), np.asarray(jidx))
        if r is router:
            assert (tidx[:, 0] == 1).all()
        else:
            assert tidx[:, 0].eq(0).all()
        jgate = np.asarray(jgate) / np.maximum(
            np.asarray(jgate).sum(-1, keepdims=True), 1e-9)
        np.testing.assert_allclose(tgate.numpy(), jgate, rtol=1e-6)


# ------------------------------------------------------------ forward, aux
@pytest.mark.parametrize("window", [64, 0], ids=["ring64", "full"])
@pytest.mark.parametrize("remat", [False, "layer"], ids=["plain", "remat"])
def test_forward_matches_jax(models, window, remat):
    """forward over 80 tokens (past the window of 64): logits and the
    aux (the layers' load-balance losses, summed) against JAX's."""
    cfg, jp, tcfg, tp = _with(models, attention_window=window)
    toks = _tok(1, (2, 80))
    jl, jaux = M.forward(jp, cfg, {"tokens": jnp.asarray(toks)})
    tl, taux = TM.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                          remat=remat)
    assert _close(tl, jl)
    assert float(taux) > 0
    assert abs(float(taux) - float(jaux)) <= AUX_TOL * cfg.num_layers


@pytest.mark.parametrize("window", [64, 16])
def test_prefill_and_decode_match_jax(models, window):
    """prefill of 30 tokens into cache_len 48 (a ring of min(48, window)),
    then 18 uniform decode steps (through the ring's wrap at 16): logits
    within 1e-5 at every step and the cache; the last step equals the forward's last
    position; decode through the kernel's plain version equals the torch
    path."""
    cfg, jp, tcfg, tp = _with(models, attention_window=window)
    toks = _tok(2, (2, 48))
    jlog, jc = M.prefill(jp, cfg, {"tokens": jnp.asarray(toks[:, :30]),
                                   "cache_len": 48})
    tlog, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks[:, :30]),
                                     "cache_len": 48})
    assert tc["kv"]["k"].shape[2] == min(48, window)
    assert _close(tlog, jlog)
    _kv_close(tc["kv"], jc["kv"])
    for t in range(30, 48):
        jlog, jc = M.decode_step(jp, cfg, jnp.asarray(toks[:, t:t + 1]), jc,
                                 t)
        kc = {"kv": {k: v.clone() for k, v in tc["kv"].items()}}
        klog, _ = TM.decode_step(tp, tcfg, torch.from_numpy(toks[:, t:t + 1]),
                                 kc, t, decode_impl="kernel")
        tlog, tc = TM.decode_step(tp, tcfg,
                                  torch.from_numpy(toks[:, t:t + 1]), tc, t,
                                  decode_impl="torch")
        assert _close(tlog, jlog), t
        assert _close(klog, tlog), t
    _kv_close(tc["kv"], jc["kv"])
    fwd, _ = TM.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert _close(tlog, fwd[:, -1])


def test_decode_matches_forward():
    """Port-only twin of tests/test_decode_consistency.py::
    test_decode_matches_forward for llama4-scout: with capacity_factor
    8.0 (no drop), 16 uniform decode steps from an empty cache equal the
    teacher-forced forward at the last position (the JAX test's bound,
    2e-2 of max|logit|), and both use the port's own init."""
    tcfg = _moe_change(port_cfg(), capacity_factor=8.0)
    tp = TM.init_params(tcfg, seed=0, device="cpu")
    toks = torch.tensor(_tok(4, (2, 16)) % tcfg.vocab_size)
    ref = TM.forward(tp, tcfg, {"tokens": toks})[0][:, -1]
    cache = TM.init_cache(tcfg, 2, 32, device="cpu")
    for t in range(16):
        lg, cache = TM.decode_step(tp, tcfg, toks[:, t:t + 1], cache, t)
    scale = ref.abs().max().item() + 1e-9
    assert (lg - ref).abs().max().item() / scale < 2e-2


# ------------------------------------------ chunk, verify and mixed, ring
@pytest.mark.parametrize("fn", ["prefill_chunk", "verify_step",
                                "mixed_step"])
@pytest.mark.parametrize("window", [64, 16])
def test_ring_chunk_paths_match_jax(models, window, fn):
    """tests/test_torch_kvcache.py's four chunks through the masked
    per-token path of a window (64: the config's; 16: the ring wraps),
    with an idle row: logits and caches against JAX's every call."""
    _chunk_parity(models, fn, "torch", attention_window=window)


# ------------------------------ window 0: the fused chunk and the paged pool
def _call(mod, fn, paged, params, cfg, toks, cache, start, lengths, impl):
    """One call of ``fn`` in package ``mod`` on a dense or paged cache;
    the decode rows of mixed_step are the rows with lengths 0, and
    decode_step feeds each row its first token at ``start`` (rows with
    lengths 0 inactive). The paged prefill and verify take no
    decode_impl, in either package."""
    t = (lambda a: torch.from_numpy(np.asarray(a))) if mod is TM \
        else jnp.asarray
    toks, start, lengths = t(toks), t(start), t(lengths)
    pre, tables = ("paged_", (t(TABLES),)) if paged else ("", ())
    kw = {} if paged and fn in ("prefill_chunk", "verify_step") \
        else dict(decode_impl=impl)
    step = getattr(mod, pre + fn)
    if fn == "decode_step":
        return step(params, cfg, toks[:, :1], cache, *tables, start,
                    active=lengths > 0, **kw)
    if fn == "mixed_step":
        return step(params, cfg, toks, cache, *tables, start, lengths,
                    toks[:, :1], lengths == 0, **kw)
    return step(params, cfg, toks, cache, *tables, start, lengths, **kw)


@pytest.mark.parametrize("fn", ["decode_step", "prefill_chunk",
                                "verify_step", "mixed_step"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_full_attention_paths_match_jax(models, paged, fn):
    """Window 0: decode_step, the fused prefill_chunk, verify_step and
    mixed_step on the dense cache and their paged forms on the block
    pool, against JAX's: logits where defined (active rows; verify:
    positions below lengths; mixed: the decode rows) within 1e-5 of
    max|logit|, and the caches."""
    cfg, jp, tcfg, tp = _with(models, attention_window=0)
    toks = _tok(5, (B, 8))
    start = np.array([8, 30, 12], np.int32)
    lengths = np.array([8, 5, 0], np.int32)
    if paged:
        jc, tc = _paged_caches(cfg, tcfg)
    else:
        jc, tc = _dense_caches(cfg, tcfg)
    jl, jc = _call(M, fn, paged, jp, cfg, toks, jc, start, lengths, "xla")
    tl, tc = _call(TM, fn, paged, tp, tcfg, toks, tc, start, lengths,
                   "torch")
    jl, tl = np.asarray(jl), tl.numpy()
    for b in range(B):
        if fn == "verify_step":
            n = int(lengths[b])
            assert n == 0 or _close(tl[b, :n], jl[b, :n]), b
        elif (lengths[b] > 0) != (fn == "mixed_step"):
            assert _close(tl[b], jl[b]), b
    _cmp_cache(jc, tc, 12 if paged else B)


# ----------------------------------------------------------------- training
@pytest.mark.parametrize("remat", [False, "layer"], ids=["none", "layer"])
def test_loss_and_grads_match_jax(models, remat):
    """loss_fn (cross entropy + 0.01 x the summed load-balance loss) and
    its grads over 2 x 40 tokens against jax.value_and_grad of the JAX
    loss: loss and lb within 1e-5 relative, each grad leaf (the router's
    included) within 1e-5 of its max |g|."""
    cfg, jp, tcfg, tp = models
    toks = _tok(40, (2, 41))
    labels = toks[:, 1:].copy()
    labels[1, -4:] = 0                              # padding
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]),
          "labels": torch.from_numpy(labels)}
    (jl, jaux), jg = jax.value_and_grad(JT.loss_fn, has_aux=True)(
        jp, cfg, jb, None, remat)
    (tl, taux), tg = TS.value_and_grad(tp, tcfg, tb, remat=remat)
    assert float(tl) == pytest.approx(float(jl), rel=TOL)
    assert float(taux["lb_loss"]) == pytest.approx(float(jaux["lb_loss"]),
                                                   rel=TOL)
    got, want = tree.leaves(tg), jax.tree.leaves(jg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.abs(g - w).max() <= TOL * np.abs(w).max()
    assert tg["layers"]["moe"]["router"].abs().max() > 0


# -------------------------------------------------------- parameters
def test_from_jax_numpy_keeps_the_router_f32(models):
    """Carried across with dtype=bfloat16, every leaf is bf16 but the
    router, which stays f32 bit for bit (a bf16 router would move
    routing decisions)."""
    cfg, jp, _, _ = models
    tp = P.from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                          dtype=torch.bfloat16)
    moe = tp["layers"].pop("moe")
    router = moe.pop("router")
    assert router.dtype == torch.float32
    assert np.array_equal(router.numpy(),
                          np.asarray(jp["layers"]["moe"]["router"]))
    for leaf in tree.leaves(tp) + tree.leaves(moe):
        assert leaf.dtype == torch.bfloat16


def test_init_params_distributions():
    """The port's own init of an MoE config: the JAX package's shapes
    and leaf dtypes (router f32 in a bf16 model), the reference's scales
    (w_down at 0.5 / sqrt(D)), the same draw for the same seed."""
    tcfg = port_cfg()
    jcfg = reduced_f32(ARCH)
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(tcfg, dtype=dtype)
        p = TM.init_params(c, seed=0, device="cpu")
        ref = jax.eval_shape(lambda: M.init_params(
            dataclasses.replace(jcfg, dtype=dtype), jax.random.PRNGKey(0)))
        assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(
            ".")[-1]), p) == jax.tree.map(
            lambda a: (tuple(a.shape), str(a.dtype)), ref)
    p = TM.init_params(tcfg, seed=0, device="cpu")
    moe, d = p["layers"]["moe"], tcfg.d_model
    f = tcfg.moe.expert_d_ff
    assert abs(moe["router"].std().item() - d ** -0.5) < 5e-3
    assert abs(moe["w_gate"].std().item() - d ** -0.5) < 5e-3
    assert abs(moe["w_down"].std().item() - 0.5 * d ** -0.5) < 3e-3
    assert abs(moe["shared"]["down"].std().item() - f ** -0.5) < 5e-3
    q = TM.init_params(tcfg, seed=0, device="cpu")
    assert torch.equal(moe["w_up"], q["layers"]["moe"]["w_up"])
