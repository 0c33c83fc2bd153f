"""The port's multi-head latent attention (repro_torch.models.mla) and
the MLA decoder's model entry points against the JAX package, on reduced
deepseek-v2-236b in f32 (d_model 256, 4 heads, latent 64, rope 16, nope
and v 32; 4 experts, top-2, one shared expert), on the same weights (the
JAX parameters carried across with ``params.from_jax_numpy``) and the
same seed-made inputs.

Tolerances: f32 on both sides with products summed in another order, so
outputs, logits and latent cache entries are held to 1e-5 of the largest
magnitude, grads each leaf to 1e-5 of its max |g| (tests/
test_torch_training.py's rule). Within the port, an inactive or idle
row is a bitwise no-op and ``decode_impl`` changes nothing (MLA has no
kernel in either package).

* ``mla_attention``: the plain branch and the flash branch (the
  threshold and chunk patched down in both packages, the flash call
  counted in each), with and without a window: output, c_kv and k_r.
* ``mla_decode`` (absorbed) against JAX's at a scalar position, at
  ragged positions (one past the cache: no write), with ``active``
  (the inactive row's cache bits unchanged) and on a ring.
* ``forward`` (logits and the summed load-balance losses, remat too),
  ``loss_fn`` and its grads, ``prefill`` + ``decode_step``, and
  ``prefill_chunk`` / ``verify_step`` / ``mixed_step`` through the
  per-token loop (full attention and a ring of 16), caches every call.
* The port's side of tests/test_decode_consistency.py for deepseek.
* ``moe_block`` at deepseek's own routing shape (8 experts, top 6, two
  shared experts), which ``reduced()`` cuts to top-2 and one shared.
* What the reference refuses or drops, pinned on both sides: the paged
  pool (its words), an int8 cache (the reference keeps the latent in
  the model dtype and its logits are its fp run's bits; the port
  raises), and a prompt longer than the cache (ValueError in both).
"""
import dataclasses
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduced_f32
from jax_compile_cache import jax_compile_cache  # noqa: F401
from repro.models import layers as JL
from repro.models import mla as JMLA
from repro.models import model as M
from repro.models import moe as JMOE
from repro.serving import engine as JEngine
from repro.training import train_step as JT
from repro_torch import params as P
from repro_torch.configs.base import get_config
from repro_torch.models import layers as TL
from repro_torch.models import mla as TMLA
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.serving import engine as TEngine
from repro_torch.training import train_step as TS
from repro_torch.training import tree

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_kvcache import _chunk_parity, _kv_close  # noqa: E402
from test_torch_moe import _jax_dropped  # noqa: E402

ARCH = "deepseek-v2-236b"
TOL = 1e-5
AUX_TOL = 1e-6
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


def port_cfg(**overrides):
    return dataclasses.replace(get_config(ARCH).reduced(), dtype="float32",
                               **overrides)


@pytest.fixture(scope="module")
def models():
    """(jax cfg, jax params, port cfg, port params): reduced deepseek-v2
    in f32, no window, capacity_factor 1.25."""
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


@pytest.fixture(scope="module")
def layer():
    """One MLA layer's JAX parameters and the port's copy."""
    jp = JMLA.init_mla(jax.random.PRNGKey(3), reduced_f32(ARCH))
    return jp, P.from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")


# -------------------------------------------------------- the block alone
@pytest.mark.parametrize("window", [0, 12], ids=["full", "window12"])
@pytest.mark.parametrize("branch", ["plain", "flash"])
def test_mla_attention_matches_jax(monkeypatch, layer, branch, window):
    """mla_attention over 2 x 32 tokens: the output, c_kv and k_r within
    1e-5. For the flash branch both packages' threshold and chunk are
    patched to 16 (the reference's mla.py holds its own FLASH_CHUNK), and
    each package's ``_flash_causal`` must run once."""
    jp, tp = layer
    cfg, tcfg = reduced_f32(ARCH, attention_window=window), \
        port_cfg(attention_window=window)
    calls = []
    if branch == "flash":
        for mod in (JL, TL):
            monkeypatch.setattr(mod, "FLASH_MIN_SEQ", 16)
            monkeypatch.setattr(mod, "FLASH_CHUNK", 16)
        monkeypatch.setattr(JMLA, "FLASH_CHUNK", 16)
        for mod, name in ((JMLA, "_flash_causal"), (TL, "_flash_causal")):
            orig = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _o=orig, _m=mod, **kw:
                                calls.append(_m) or _o(*a, **kw))
    x = np.random.default_rng(5).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    jo = JMLA.mla_attention(jp, cfg, jnp.asarray(x))
    to = TMLA.mla_attention(tp, tcfg, torch.from_numpy(x))
    for g, r in zip(to, jo):
        assert g.shape == r.shape and _close(g, r)
    assert calls == ([JMLA, TL] if branch == "flash" else [])


def _latent(seed, b, s, cfg):
    rng = np.random.default_rng(seed)
    m = cfg.mla
    return (rng.standard_normal((b, s, m.kv_lora_rank)).astype(np.float32),
            rng.standard_normal((b, s, m.rope_head_dim)).astype(np.float32))


DECODE = {"scalar": (9, None, 0), "ragged": ([3, 15, 20], None, 0),
          "active": ([3, 9, 12], [True, False, True], 0),
          "ring": ([3, 9, 20], [True, True, False], 8)}


@pytest.mark.parametrize("case", list(DECODE))
def test_mla_decode_matches_jax(layer, case):
    """mla_decode of one token a row over a random latent cache of 16
    entries (8 on the ring) against JAX's: output and both caches within
    1e-5; a row past the cache writes nothing (the ragged case's 20), an
    inactive row's cache bits stay as they were."""
    jp, tp = layer
    pos, active, window = DECODE[case]
    cfg, tcfg = reduced_f32(ARCH), port_cfg()
    s = window or 16
    ckv, kr = _latent(6, 3, s, cfg)
    x = np.random.default_rng(7).standard_normal(
        (3, 1, cfg.d_model)).astype(np.float32)
    jact = None if active is None else jnp.asarray(active)
    jo, jc, jr = JMLA.mla_decode(jp, cfg, jnp.asarray(x), jnp.asarray(ckv),
                                 jnp.asarray(kr), jnp.asarray(pos),
                                 window=window, active=jact)
    kv = {"c_kv": torch.from_numpy(ckv.copy()),
          "k_r": torch.from_numpy(kr.copy())}
    tact = None if active is None else torch.tensor(active)
    idx = TL.decode_index(tcfg, torch.tensor(pos), kv, tact, window)
    to = TMLA.mla_decode(tp, tcfg, torch.from_numpy(x), kv, idx)
    assert _close(to, jo)
    _kv_close(kv, {"c_kv": jc, "k_r": jr})
    for b in range(3):
        if active is not None and not active[b]:
            assert np.array_equal(kv["c_kv"][b].numpy(), ckv[b])
            assert np.array_equal(kv["k_r"][b].numpy(), kr[b])
    if case == "ragged":
        assert np.array_equal(kv["c_kv"][2].numpy(), ckv[2])


# ------------------------------------------------------------ the model
@pytest.mark.parametrize("remat", [False, "layer", True],
                         ids=["plain", "layer", "full"])
def test_forward_matches_jax(models, remat):
    """forward over 2 x 24 tokens: logits and the aux (the layers'
    load-balance losses, summed) against JAX's."""
    cfg, jp, tcfg, tp = models
    toks = _tok(1, (2, 24))
    jl, jaux = M.forward(jp, cfg, {"tokens": jnp.asarray(toks)})
    tl, taux = TM.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                          remat=remat)
    assert _close(tl, jl)
    assert float(taux) > 0
    assert abs(float(taux) - float(jaux)) <= AUX_TOL * cfg.num_layers


@pytest.mark.parametrize("remat", [False, "layer"], ids=["none", "layer"])
def test_loss_and_grads_match_jax(models, remat):
    """loss_fn and its grads over 2 x 24 tokens (padded labels) against
    jax.value_and_grad of the JAX loss: loss and lb within 1e-5
    relative, each grad leaf within 1e-5 of its max |g|; every MLA leaf
    gets a gradient."""
    cfg, jp, tcfg, tp = models
    toks = _tok(40, (2, 25))
    labels = toks[:, 1:].copy()
    labels[1, -4:] = 0
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
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= TOL * np.abs(w).max()
    for name, g in tg["layers"]["attn"].items():
        assert g.abs().max() > 0, name


@pytest.mark.parametrize("window", [0, 16], ids=["full", "ring16"])
def test_prefill_and_decode_match_jax(models, window):
    """prefill of 12 tokens into cache_len 24 (a ring of 16 with the
    window), then 12 uniform decode steps (through the ring's wrap):
    logits within 1e-5 every step and the latent cache; ``decode_impl``
    "kernel" gives the torch path's bits and never calls the decode
    kernel's wrapper; the last step equals the forward's last position
    without a window."""
    cfg, jp, tcfg, tp = _with(models, attention_window=window)
    toks = _tok(2, (2, 24))
    jlog, jc = M.prefill(jp, cfg, {"tokens": jnp.asarray(toks[:, :12]),
                                   "cache_len": 24})
    tlog, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks[:, :12]),
                                     "cache_len": 24})
    assert set(tc["kv"]) == {"c_kv", "k_r"}
    assert tc["kv"]["c_kv"].shape[2] == (window or 24)
    assert _close(tlog, jlog)
    _kv_close(tc["kv"], jc["kv"])
    from repro_torch.kernels import ops
    for t in range(12, 24):
        jlog, jc = M.decode_step(jp, cfg, jnp.asarray(toks[:, t:t + 1]), jc,
                                 t)
        kc = {"kv": {k: v.clone() for k, v in tc["kv"].items()}}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ops, "gqa_decode", None)     # never reached
            klog, kc = TM.decode_step(tp, tcfg,
                                      torch.from_numpy(toks[:, t:t + 1]), kc,
                                      t, decode_impl="kernel")
        tlog, tc = TM.decode_step(tp, tcfg,
                                  torch.from_numpy(toks[:, t:t + 1]), tc, t,
                                  decode_impl="torch")
        assert _close(tlog, jlog), t
        assert torch.equal(klog, tlog)
        assert all(torch.equal(kc["kv"][n], tc["kv"][n]) for n in tc["kv"])
    _kv_close(tc["kv"], jc["kv"])
    if not window:
        fwd, _ = TM.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
        assert _close(tlog, fwd[:, -1])


@pytest.mark.parametrize("fn", ["prefill_chunk", "verify_step",
                                "mixed_step"])
@pytest.mark.parametrize("window", [0, 16], ids=["full", "ring16"])
def test_chunk_paths_match_jax(models, window, fn):
    """tests/test_torch_kvcache.py's four chunks through the masked
    per-token path (the reference's for MLA, whatever the window), with
    an idle row: logits and latent caches against JAX's every call, the
    idle row bitwise."""
    _chunk_parity(models, fn, "torch", attention_window=window)


def test_decode_matches_forward():
    """Port-only twin of tests/test_decode_consistency.py::
    test_decode_matches_forward for deepseek-v2: with capacity_factor
    8.0 (no drop), 16 uniform decode steps from an empty cache equal the
    teacher-forced forward at the last position (the JAX test's bound,
    2e-2 of max|logit|), on the port's own init."""
    tcfg = dataclasses.replace(port_cfg(), moe=dataclasses.replace(
        port_cfg().moe, capacity_factor=8.0))
    tp = TM.init_params(tcfg, seed=0, device="cpu")
    toks = torch.tensor(_tok(4, (2, 16)) % tcfg.vocab_size)
    ref = TM.forward(tp, tcfg, {"tokens": toks})[0][:, -1]
    cache = TM.init_cache(tcfg, 2, 32, device="cpu")
    for t in range(16):
        lg, cache = TM.decode_step(tp, tcfg, toks[:, t:t + 1], cache, t)
    scale = ref.abs().max().item() + 1e-9
    assert (lg - ref).abs().max().item() / scale < 2e-2


# ----------------------------------------------- deepseek's routing shape
@pytest.mark.parametrize("cf", [0.5, 8.0])
def test_moe_block_at_deepseek_routing(monkeypatch, cf):
    """moe_block with 8 experts, top 6 and two shared experts (the
    published config's top-k and shared count; ``reduced()`` keeps
    top-2 and one): outputs within 1e-5, lb_loss and router_fraction
    within 1e-6, and the same dropped pairs as the JAX block on inputs
    skewed toward expert 0. A token's six choices are six experts, and at
    capacity_factor 1.25 each expert's buffer (1.17 x the tokens) holds
    every token, so drops need a factor below 1: at 0.5 both capacity
    stages drop (the send buffer keeps half the pairs, each expert 12
    rows), at 8.0 nothing does."""
    moe = dict(num_experts=8, top_k=6, num_shared_experts=2,
               capacity_factor=cf)
    cfg = reduced_f32(ARCH)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    tcfg = dataclasses.replace(port_cfg(), moe=dataclasses.replace(
        port_cfg().moe, **moe))
    jp = JMOE.init_moe(jax.random.PRNGKey(8), cfg)
    tp = P.from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    assert tp["shared"]["up"].shape[-1] == 2 * cfg.moe.expert_d_ff
    rng = np.random.default_rng(9)
    x = rng.standard_normal((64, cfg.d_model)).astype(np.float32)
    col = np.asarray(jp["router"][:, 0])
    x = (x + 15.0 * col / np.linalg.norm(col)).reshape(2, 32, cfg.d_model)
    jy, jaux, jdrop = _jax_dropped(monkeypatch, jp, cfg, x)
    ty, taux = TMOE.moe_block(tp, tcfg, torch.from_numpy(x))
    assert _close(ty, jy)
    assert abs(float(taux["lb_loss"]) - float(jaux["lb_loss"])) <= AUX_TOL
    np.testing.assert_allclose(taux["router_fraction"].numpy(),
                               np.asarray(jaux["router_fraction"]),
                               atol=AUX_TOL, rtol=0)
    assert np.array_equal(taux["dropped"].numpy(), jdrop)
    assert jdrop.any() == (cf < 1)


# ------------------------------------------- refusals and dropped settings
def test_paged_pool_refuses_mla_in_the_reference_words(models):
    """MLA passes check_supported; the paged pool refuses it with the
    reference's words in both packages, and so does a paged engine."""
    cfg, jp, tcfg, tp = models
    assert TM.check_supported(tcfg) is None
    assert TM.check_supported(get_config(ARCH)) is None
    with pytest.raises(NotImplementedError, match=re.escape(PAGED_REASON)):
        M.init_paged_cache(cfg, 4, 16)
    with pytest.raises(NotImplementedError, match=re.escape(PAGED_REASON)):
        TM.init_paged_cache(tcfg, 4, 16, device="cpu")
    with pytest.raises(NotImplementedError, match=re.escape(PAGED_REASON)):
        TM.check_supported(get_config(ARCH), paged=True)
    with pytest.raises(NotImplementedError, match=re.escape(PAGED_REASON)):
        JEngine.InferenceEngine(cfg, jp, n_max=2, c_max=64, paged=True)
    with pytest.raises(NotImplementedError, match=re.escape(PAGED_REASON)):
        TEngine.InferenceEngine(tcfg, tp, n_max=2, c_max=64, paged=True)


def test_int8_kv_pinned_on_both_sides(models):
    """kv_cache_dtype="int8" with MLA: the reference drops it (its latent
    cache holds the model dtype, no scales, and prefill + decode give its
    fp run's logits bit for bit); the port raises NotImplementedError
    naming the missing int8 latent layout, at init_cache, prefill and the
    engine."""
    cfg, jp, tcfg, tp = models
    c8, t8 = (dataclasses.replace(c, kv_cache_dtype="int8")
              for c in (cfg, tcfg))
    jc = M.init_cache(c8, 2, 24)
    assert set(jc["kv"]) == {"c_kv", "k_r"}
    assert all(a.dtype == jnp.float32 for a in jax.tree.leaves(jc))
    toks = jnp.asarray(_tok(3, (2, 13)))
    runs = []
    for c in (cfg, c8):
        lg, cache = M.prefill(jp, c, {"tokens": toks[:, :12],
                                      "cache_len": 24})
        lg2, _ = M.decode_step(jp, c, toks[:, 12:], cache, 12)
        runs.append((np.asarray(lg), np.asarray(lg2)))
    assert all(np.array_equal(a, b) for a, b in zip(*runs))
    match = "no int8 layout for the latent cache"
    with pytest.raises(NotImplementedError, match=match):
        TM.init_cache(t8, 2, 24, device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        TM.prefill(tp, t8, {"tokens": torch.from_numpy(_tok(3, (2, 12))),
                            "cache_len": 24})
    with pytest.raises(NotImplementedError, match=match):
        TEngine.InferenceEngine(t8, tp, n_max=2, c_max=64)


def test_prefill_longer_than_the_cache_raises_in_both(models):
    """A prompt of 24 tokens into a ring of 16 (window 16) or a cache of
    16: the reference's ``jnp.pad`` raises ValueError on the negative
    width, and the port raises ValueError too."""
    for change, cache_len in ((dict(attention_window=16), 32), ({}, 16)):
        cfg, jp, tcfg, tp = _with(models, **change)
        toks = _tok(4, (2, 24))
        with pytest.raises(ValueError):
            M.prefill(jp, cfg, {"tokens": jnp.asarray(toks),
                                "cache_len": cache_len})
        with pytest.raises(ValueError, match="cannot take a prompt of 24"):
            TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks),
                                  "cache_len": cache_len})


def test_init_params_and_cache_layouts():
    """The port's own init of deepseek: the JAX package's leaf names,
    shapes and dtypes (bf16 model, f32 router), ``wo`` at half the std
    of the other projections, ``kv_norm`` ones, the same draw for the
    same seed; the latent cache's shapes are the JAX cache's."""
    tcfg, jcfg = port_cfg(), reduced_f32(ARCH)
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(tcfg, dtype=dtype)
        p = TM.init_params(c, seed=0, device="cpu")
        ref = jax.eval_shape(lambda: M.init_params(
            dataclasses.replace(jcfg, dtype=dtype), jax.random.PRNGKey(0)))
        assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(
            ".")[-1]), p) == jax.tree.map(
            lambda a: (tuple(a.shape), str(a.dtype)), ref)
    p = TM.init_params(tcfg, seed=0, device="cpu")
    attn, d = p["layers"]["attn"], tcfg.d_model
    assert abs(attn["wq"].std().item() - d ** -0.5) < 5e-3
    assert abs(attn["wo"].std().item()
               - 0.5 * attn["wo"].shape[-2] ** -0.5) < 5e-3
    assert torch.equal(attn["kv_norm"], torch.ones_like(attn["kv_norm"]))
    q = TM.init_params(tcfg, seed=0, device="cpu")
    assert torch.equal(attn["wuk"], q["layers"]["attn"]["wuk"])
    jc = M.init_cache(jcfg, 3, 40)
    tc = TM.init_cache(tcfg, 3, 40, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc["kv"].items()} == \
        {k: tuple(v.shape) for k, v in jc["kv"].items()}
