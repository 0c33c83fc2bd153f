"""The encoder-decoder family (repro_torch.models.model, ENCDEC branch)
against the JAX package, on reduced seamless-m4t-large-v2 (2 encoder + 2
decoder layers, d_model 256, 4 heads, MHA, 16 frames), the JAX
parameters carried across with ``params.from_jax_numpy``, in f32. The
encoder's input is a random frontend (normal x 0.02 from a numpy seed),
never the launchers' constant stub: over a constant frontend every frame
is alike and a wrong cross path could hide.

* ``_encode`` alone; ``forward`` (remat none and "layer") and its aux;
  ``forward`` under remat "layer" and True equal to the plain forward
  bitwise; ``prefill`` (fp): logits and every cache leaf, the cross
  memory ``xk`` / ``xv`` (num_layers, B, F, Hkv, hd) included.
* ``decode_step`` at per-row positions with an inactive row (its cache
  rows bitwise untouched), through the torch path and the kernel's plain
  version; uniform decode steps.
* The int8 KV cache: the port's ``prefill`` stores the self-attention
  K/V as int8 with scales, the cross memory in the model dtype; its
  int8 values and scales equal the JAX package's ``quantize_kv`` of the
  reference's fp cache (values within one step, scales 1e-5), and
  ``decode_step`` on that JAX-made int8 cache equals the reference's
  within TOL. The reference's ``_fill_cache`` drops int8 on the
  cross-attention families (ENCDEC and VLM): its cache holds the model
  dtype and no scales, so its "int8" run is unquantized; the port's int8
  logits stay within INT8_REL of it (tests/test_perf_opts.py's bound).
  Both sides pinned for both families.
* ``loss_fn`` and its grads, remat none and "layer".
* Twins of the reference's tests that list seamless:
  tests/test_decode_consistency.py::test_decode_matches_forward,
  tests/test_models_smoke.py::test_train_step_decreases_loss and
  ::test_assignment_coverage (the published shape tuple).
* The port's ``init_params`` gives the reference's tree; ``init_cache``
  its leaves; the engine, and with it ``--fleet``, refuses ENCDEC with
  the reference engine's message, the paged pool with the reference's
  reason, and the chunk, verify and mixed steps (the engine's) refuse it
  too.
* The batch launcher's ``first sequence`` line equals the JAX
  launcher's on its weights.
* bf16: the port's bf16 run against the JAX package's bf16 run on the
  same weights, as tests/test_torch_vlm_bf16.py holds VLM.

Every f32 comparison is within TOL = 1e-5 of the reference's max.
"""
import contextlib
import dataclasses
import functools
import io
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduced_f32
from repro.configs.base import get_config as jax_config
from repro.models import layers as JL
from repro.models import model as M
from repro.serving import engine as JEngine
from repro.training import train_step as JT
from repro_torch import params as P
from repro_torch.configs.base import get_config
from repro_torch.launch import serve as TServe
from repro_torch.models import model as TM
from repro_torch.serving import engine as TEngine
from repro_torch.training import optimizer as TO
from repro_torch.training import train_step as TS
from repro_torch.training import tree
from repro_torch.training.data import DataConfig, batch_at

from jax_compile_cache import jax_compile_cache  # noqa: F401
from test_torch_vlm_bf16 import SPREAD, model_readings, model_runs
from test_torch_vlm_bf16 import MODEL_TOL as BF16_TOL
from test_torch_vlm import GATES, set_gates

ARCH = "seamless-m4t-large-v2"
VLM = "llama-3.2-vision-11b"
TOL = 1e-5
INT8_REL = 0.05               # tests/test_perf_opts.py::test_int8_kv_decode_close
B = 3
PAGED_REASON = "paged KV cache supports dense/MoE full-attention models"
ENGINE_REASON = "engine supports attention-family models"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one intra-op
    thread per worker keeps these small-shape tests from oversubscribing
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(arch=ARCH, **kw):
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                               **kw)


@functools.lru_cache(maxsize=None)
def weights(arch=ARCH):
    """(jax cfg, jax params, port cfg, port params) of reduced ``arch``
    in f32: the JAX init_params tree (PRNGKey(0); a VLM's gates set to
    test_torch_vlm.GATES) and the port's copy, built once a process."""
    cfg = reduced_f32(arch)
    jp = M.init_params(cfg, jax.random.PRNGKey(0))
    if arch == VLM:
        jp = set_gates(jp, GATES)
    return cfg, jp, port_cfg(arch), P.from_jax_numpy(
        jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def models():
    return weights()


def frontend(seed, b, cfg):
    """A random frontend, normal x 0.02, (b, frontend_tokens, d_model)."""
    return (np.random.default_rng(seed).standard_normal(
        (b, cfg.frontend_tokens, cfg.d_model)) * 0.02).astype(np.float32)


def _tok(seed, shape):
    return np.random.default_rng(seed).integers(1, 1000, shape).astype(
        np.int32)


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() <= tol * max(1.0, np.abs(ref).max())


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def cache_close(tc, jc, tol=TOL):
    """Every leaf of a port cache against the JAX one: the same leaves,
    shapes and dtypes, values within ``tol`` of the leaf's max."""
    want = jax.tree.map(np.asarray, jc)
    assert tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]),
                    tc) == jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                                        want)
    for g, w in zip(tree.leaves(tc), jax.tree.leaves(want)):
        assert np.abs(g.numpy() - w).max() <= tol * max(np.abs(w).max(),
                                                        1e-30)


def row_views(cache, b):
    """Row ``b`` of every leaf of a port cache (batch on axis 1)."""
    return [leaf.select(1, b).clone() for leaf in tree.leaves(cache)]


def _prefilled(models, toks, cache_len, seed=7, cfgs=None):
    """Both packages' prefill of ``toks`` over one random frontend
    (``cfgs``: the (jax, port) configs, default the models')."""
    cfg, jp, tcfg, tp = models
    cfg, tcfg = cfgs or (cfg, tcfg)
    fe = frontend(seed, toks.shape[0], cfg)
    jl, jc = M.prefill(jp, cfg, {"tokens": jnp.asarray(toks),
                                 "frontend": jnp.asarray(fe),
                                 "cache_len": cache_len})
    tl, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks),
                                   "frontend": torch.from_numpy(fe),
                                   "cache_len": cache_len})
    return (jl, jc), (tl, tc)


# ------------------------------------------------------ encoder, forward
def test_encode_matches_jax(models):
    """The encoder over a random (B, F, D) frontend, ``enc_ln`` applied:
    within TOL of the reference's, and not constant over the frames."""
    cfg, jp, tcfg, tp = models
    fe = frontend(1, B, cfg)
    want = M._encode(jp, cfg, jnp.asarray(fe), None)
    got = TM._encode(tp, tcfg, torch.from_numpy(fe))
    assert got.shape == want.shape == (B, cfg.frontend_tokens, cfg.d_model)
    assert _close(got, want)
    assert float((got[:, 1:] - got[:, :1]).abs().max()) > 0.1


@pytest.mark.parametrize("remat", [False, "layer"], ids=["plain", "remat"])
def test_forward_matches_jax(models, remat):
    """forward over 2 x 24 tokens and a random frontend: logits within
    TOL of max|logit|; the aux a 0-d f32 zero, as the reference's."""
    cfg, jp, tcfg, tp = models
    toks, fe = _tok(1, (2, 24)), frontend(2, 2, cfg)
    jl, jaux = M.forward(jp, cfg, {"tokens": jnp.asarray(toks),
                                   "frontend": jnp.asarray(fe)})
    tl, taux = TM.forward(tp, tcfg, {"tokens": torch.from_numpy(toks),
                                     "frontend": torch.from_numpy(fe)},
                          remat=remat)
    assert tl.shape == (2, 24, cfg.vocab_size) and _close(tl, jl)
    assert taux.dtype == torch.float32 and taux.dim() == 0
    assert float(taux) == float(jaux) == 0.0


def test_forward_remat_equals_plain(models):
    """forward under remat "layer" and True (each encoder and decoder
    layer, or the whole pass, checkpointed) equals the plain forward
    bitwise, and the encoder's output reaches the logits: another
    frontend moves them."""
    tcfg, tp = models[2], models[3]
    batch = {"tokens": torch.from_numpy(_tok(3, (2, 12))),
             "frontend": torch.from_numpy(frontend(4, 2, tcfg))}
    plain = TM.forward(tp, tcfg, batch)[0]
    for remat in ("layer", True):
        assert torch.equal(TM.forward(tp, tcfg, batch, remat=remat)[0],
                           plain), remat
    other = dict(batch, frontend=torch.from_numpy(frontend(5, 2, tcfg)))
    assert float((TM.forward(tp, tcfg, other)[0] - plain).abs().max()) \
        > 1e-3 * float(plain.abs().max())


def test_prefill_matches_jax(models):
    """prefill of 3 x 20 tokens into cache_len 32: logits, the
    self-attention K/V and the cross memory's xk / xv, (num_layers, B, F,
    Hkv, hd), every leaf the reference's."""
    cfg, jp, tcfg, tp = models
    (jl, jc), (tl, tc) = _prefilled(models, _tok(2, (B, 20)), 32)
    assert _close(tl, jl)
    cache_close(tc, jc)
    assert tc["xk"].shape == (tcfg.num_layers, B, tcfg.frontend_tokens,
                              tcfg.num_kv_heads, 64)
    assert tc["xk"].abs().max() > 0


@pytest.mark.parametrize("impl", [("xla", "torch"), ("pallas", "kernel")],
                         ids=["xla-torch", "pallas-kernel"])
def test_decode_step_matches_jax(models, impl):
    """Three decode steps from a 20-token prefill at per-row positions
    (rows at 20, 23 and 20), row 2 inactive: active rows' logits within
    TOL, the caches too, and row 2 of every leaf bitwise untouched."""
    cfg, jp, tcfg, tp = models
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
    cfg, jp, tcfg, tp = models
    toks = _tok(4, (2, 20))
    (jl, jc), (tl, tc) = _prefilled(models, toks[:, :16], 24)
    for t in range(16, 20):
        jl, jc = M.decode_step(jp, cfg, jnp.asarray(toks[:, t:t + 1]), jc, t)
        tl, tc = TM.decode_step(tp, tcfg, torch.from_numpy(toks[:, t:t + 1]),
                                tc, t)
        assert _close(tl, jl), t
    cache_close(tc, jc)


# -------------------------------------------------------------- int8 cache
def _int8_close(got, want):
    """int8 cache leaves: values within one step, scales within TOL."""
    for name, leaf in want.items():
        g, w = got[name].numpy(), np.asarray(leaf)
        if name.endswith("scale"):
            assert _close(g, w), name
        else:
            assert np.abs(g.astype(np.int32) - w.astype(np.int32)
                          ).max() <= 1, name


def test_int8_prefill_and_decode_match_jax(models):
    """int8: the port's prefill cache holds int8 K/V and scales, the
    cross memory in f32 as the reference's; its values equal the JAX
    ``quantize_kv`` of the reference's fp cache within one step and its
    scales within TOL. Then four decode steps in the reference on that
    JAX-made int8 cache (its decode dequantizes it), the port taking the
    reference's cache before each step (a value at a rounding edge may
    round the other way in one package and move the next step's K/V):
    logits within TOL, the written entries within one step."""
    cfg, jp, tcfg, tp = models
    c8 = dataclasses.replace(tcfg, kv_cache_dtype="int8")
    toks = _tok(5, (B, 20))
    (_, jc), (tl, tc) = _prefilled(models, toks[:, :16], 24,
                                   cfgs=(cfg, c8))
    assert {k: v.dtype for k, v in tc["kv"].items()} == {
        "k": torch.int8, "v": torch.int8, "k_scale": torch.float32,
        "v_scale": torch.float32}
    assert tc["xk"].dtype == tc["xv"].dtype == torch.float32
    kv = {}
    for name in ("k", "v"):
        kv[name], kv[name + "_scale"] = JL.quantize_kv(jc["kv"][name])
    _int8_close(tc["kv"], kv)
    jc8 = dict(jc, kv=kv)
    for t in range(16, 20):
        tok = toks[:, t:t + 1]
        tc8 = P.from_jax_numpy(jax.tree.map(np.asarray, jc8), device="cpu")
        jl, jc8 = M.decode_step(jp, cfg, jnp.asarray(tok), jc8, t)
        tl, tc8 = TM.decode_step(tp, c8, torch.from_numpy(tok), tc8, t)
        assert _close(tl, jl), t
        _int8_close(tc8["kv"], jc8["kv"])


@functools.lru_cache(maxsize=None)
def int8_runs(arch, kv="int8", n_dec=4):
    """Prefill of 3 x 16 tokens over one random frontend, then ``n_dec``
    - 1 uniform decode steps fed the next tokens, in both packages under
    kv_cache_dtype ``kv``. Returns (the JAX logits (B, n_dec, V), the JAX
    prefill cache, the port's logits, the port's prefill cache)."""
    cfg, jp, tcfg, tp = models = weights(arch)
    cfg, tcfg = (dataclasses.replace(c, kv_cache_dtype=kv)
                 for c in (cfg, tcfg))
    toks = _tok(6, (B, 16 + n_dec))
    (jl, jc), (tl, tc) = _prefilled(models, toks[:, :16], 16 + n_dec,
                                    cfgs=(cfg, tcfg))
    caches = (jax.tree.map(np.asarray, jc), tree.map(torch.clone, tc))
    jout, tout = [np.asarray(jl)], [tl.numpy()]
    for t in range(16, 16 + n_dec - 1):
        tok = toks[:, t:t + 1]
        jl, jc = M.decode_step(jp, cfg, jnp.asarray(tok), jc, t)
        tl, tc = TM.decode_step(tp, tcfg, torch.from_numpy(tok), tc, t)
        jout.append(np.asarray(jl))
        tout.append(tl.numpy())
    return np.stack(jout, 1), caches[0], np.stack(tout, 1), caches[1]


@pytest.mark.parametrize("arch", [ARCH, VLM])
def test_int8_cache_holds_int8_and_scales(arch):
    """Under kv_cache_dtype int8 the port's prefill cache holds the
    self-attention K/V as int8 with scales (the cross memory in the
    model dtype), and its logits stay within INT8_REL of max|logit| of
    the reference's run, which is unquantized (the next test), while
    differing from it."""
    jl, _, tl, tc = int8_runs(arch)
    assert tc["kv"]["k"].dtype == tc["kv"]["v"].dtype == torch.int8
    assert tc["kv"]["k_scale"].shape == tc["kv"]["k"].shape[:-1]
    assert tc["kv"]["k_scale"].dtype == tc["xk"].dtype == torch.float32
    for j in range(jl.shape[1]):
        assert _rel(tl[:, j], jl[:, j]) < INT8_REL, j
    assert np.abs(tl[:, 1:] - jl[:, 1:]).max() > TOL * np.abs(jl).max()


@pytest.mark.parametrize("arch", [ARCH, VLM])
def test_prefill_drops_int8_in_the_reference(arch):
    """The reference's ``_fill_cache`` packs int8 only on its DENSE/MOE
    branch: an ENCDEC or VLM prefill under kv_cache_dtype int8 returns
    the model dtype and no scales, so its decode runs unquantized and
    its logits equal its fp run's bit for bit."""
    jl8, jc8, _, _ = int8_runs(arch)
    assert set(jc8["kv"]) == {"k", "v"}
    assert jc8["kv"]["k"].dtype == np.float32
    assert np.array_equal(jl8, int8_runs(arch, kv="")[0])


# --------------------------------------------------------------- training
@pytest.mark.parametrize("remat", [False, "layer"], ids=["none", "layer"])
def test_loss_and_grads_match_jax(models, remat):
    """loss_fn and its grads over 2 x 16 tokens and a random frontend
    against jax.value_and_grad of the JAX loss: the loss within TOL
    relative, the aux zero, each grad leaf (the reference's tree, leaf
    for leaf; the encoder's included) nonzero and within TOL of its max
    |g|."""
    cfg, jp, tcfg, tp = models
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
        assert np.abs(w).max() > 0, name
        assert np.abs(g - w).max() <= TOL * np.abs(w).max(), name


# ------------------------------------------- twins of the reference's tests
def test_decode_matches_forward():
    """Port-only twin of tests/test_decode_consistency.py::
    test_decode_matches_forward for seamless: init_cache, the cross
    memory taken from a prefill, then 16 decode steps from position 0;
    the last logits equal the teacher-forced forward's within 2e-2 of
    max|logit|, on the port's own weights and a random frontend."""
    tcfg = port_cfg()
    tp = TM.init_params(tcfg, seed=0, device="cpu")
    toks = torch.tensor(_tok(8, (2, 16)) % tcfg.vocab_size)
    batch = {"tokens": toks, "frontend": torch.from_numpy(frontend(9, 2,
                                                                   tcfg))}
    ref = TM.forward(tp, tcfg, batch)[0][:, -1]
    cache = TM.init_cache(tcfg, 2, 32, device="cpu",
                          frontend_len=tcfg.frontend_tokens)
    full = TM.prefill(tp, tcfg, batch)[1]
    cache["xk"], cache["xv"] = full["xk"], full["xv"]
    for t in range(16):
        lg, cache = TM.decode_step(tp, tcfg, toks[:, t:t + 1], cache, t)
    assert (lg - ref).abs().max().item() / (ref.abs().max().item()
                                            + 1e-9) < 2e-2


def test_train_step_decreases_loss():
    """Port-only twin of tests/test_models_smoke.py::
    test_train_step_decreases_loss for seamless (its batch given the
    constant frontend, as there): 12 AdamW steps, every loss finite,
    min(losses[4:]) < losses[0] + 0.02."""
    tcfg = port_cfg()
    params = TM.init_params(tcfg, seed=0, device="cpu")
    opt = TO.init_adamw(params)
    step = TS.make_train_step(tcfg, TO.AdamWConfig(lr=1e-3, warmup_steps=2,
                                                   total_steps=50))
    dc = DataConfig(vocab_size=tcfg.vocab_size, seq_len=32, global_batch=4)
    fe = torch.ones((4, tcfg.frontend_tokens, tcfg.d_model)) * 0.01
    losses = []
    for i in range(12):
        b = {k: torch.from_numpy(v) for k, v in batch_at(dc, i).items()}
        b["frontend"] = fe
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1])
    assert min(losses[4:]) < losses[0] + 0.02


def test_assignment_coverage():
    """Port twin of tests/test_models_smoke.py::test_assignment_coverage
    for seamless: the published shape tuple (layers, d_model, heads, kv
    heads, d_ff, vocab), 24 encoder layers and 1024 frames."""
    c = get_config(ARCH)
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads, c.d_ff,
            c.vocab_size) == (24, 1024, 16, 16, 8192, 256206)
    assert (c.family, c.encoder_layers, c.frontend_tokens) == \
        ("encdec", 24, 1024)
    assert dataclasses.asdict(c) == dataclasses.asdict(jax_config(ARCH))


# ------------------------------------------------- layout, params, refusals
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_and_cache_layout(dtype):
    """The port's own init: the JAX package's parameter tree, shapes and
    dtypes; its cache the reference's leaves, all zeros, fp and int8;
    ``frontend_len`` sets F."""
    tcfg = dataclasses.replace(port_cfg(), dtype=dtype)
    jcfg = dataclasses.replace(reduced_f32(ARCH), dtype=dtype)
    p = TM.init_params(tcfg, seed=0, device="cpu")
    ref = jax.eval_shape(lambda: M.init_params(jcfg, jax.random.PRNGKey(0)))

    def shape(t):
        return tuple(t.shape), str(t.dtype).split(".")[-1]
    assert tree.map(shape, p) == jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype)), ref)
    for kv, f_len in (("", None), ("int8", 5)):
        c = TM.init_cache(dataclasses.replace(tcfg, kv_cache_dtype=kv), 2,
                          24, device="cpu", frontend_len=f_len)
        jc = jax.eval_shape(lambda: M.init_cache(
            dataclasses.replace(jcfg, kv_cache_dtype=kv), 2, 24,
            frontend_len=f_len))
        assert tree.map(shape, c) == jax.tree.map(
            lambda a: (tuple(a.shape), str(a.dtype)), jc)
        assert c["xk"].shape[2] == (f_len or tcfg.frontend_tokens)
        assert not any(t.any() for t in tree.leaves(c))


def test_engine_and_fleet_refuse_encdec(monkeypatch):
    """The engine refuses ENCDEC in both packages with the same message,
    so ``--fleet`` does too; the paged pool refuses it with the
    reference's reason; ENCDEC passes check_supported."""
    cfg, tcfg = reduced_f32(ARCH), port_cfg()
    assert TM.check_supported(tcfg) is None
    with pytest.raises(NotImplementedError) as want:
        JEngine.InferenceEngine(cfg, {}, n_max=2, c_max=32)
    with pytest.raises(NotImplementedError) as got:
        TEngine.InferenceEngine(tcfg, {"embed": torch.zeros(1)}, n_max=2,
                                c_max=32)
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith(ENGINE_REASON)
    with pytest.raises(NotImplementedError, match=re.escape(ENGINE_REASON)):
        TServe.main(["--arch", ARCH, "--reduced", "--fleet", "2",
                     "--device", "cpu"])
    with pytest.raises(NotImplementedError, match=re.escape(PAGED_REASON)):
        M.init_paged_cache(cfg, 4, 16)
    with pytest.raises(NotImplementedError,
                       match=re.escape(PAGED_REASON + "; family='encdec'")):
        TM.init_paged_cache(tcfg, 4, 16, device="cpu")


@pytest.mark.parametrize("fn", ["prefill_chunk", "verify_step",
                                "mixed_step"])
def test_engine_steps_refuse_encdec(models, fn):
    """The chunk, verify and mixed steps serve the engine, which refuses
    ENCDEC: they refuse it too, naming the engine."""
    tcfg, tp = models[2], models[3]
    toks = torch.ones((2, 4), dtype=torch.int32)
    cache = TM.init_cache(tcfg, 2, 8, device="cpu")
    start, lengths = torch.zeros(2, dtype=torch.long), torch.full((2,), 4)
    args = (tp, tcfg, toks, cache, start, lengths)
    if fn == "mixed_step":
        args += (toks[:, :1], lengths == 0)
    with pytest.raises(NotImplementedError,
                       match=f"{fn} serves the engine"):
        getattr(TM, fn)(*args)


# ----------------------------------------------------------------- launcher
def test_batch_launcher_prints_jax_sequence(monkeypatch):
    """``serve --arch seamless-m4t-large-v2 --reduced`` as the batch
    launcher on the JAX launcher's weights and prompt ids, both giving
    the model the reference's constant frontend: its ``first sequence``
    line equals ``repro.launch.serve.main``'s (run with Auto mesh axes,
    as tests/test_torch_forward.py runs it); the cache holds the encoder
    output's cross K/V."""
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
    jp = jax.tree.map(np.asarray, M.init_params(cfg, jax.random.PRNGKey(0)))
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (2, 16), 1,
                                         cfg.vocab_size))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = TServe.serve_batch(TServe.parse_args(argv + ["--device",
                                                           "cpu"]),
                                 params=P.from_jax_numpy(jp, device="cpu"),
                                 tokens=torch.from_numpy(toks))
    out = buf.getvalue().splitlines()
    assert len(ref) == 1
    assert [ln for ln in out if ln.startswith("first sequence:")] == ref
    assert out[0].startswith(f"arch={cfg.name} mesh 1x1 batch=2")
    assert run.cache["xk"].shape == (cfg.num_layers, 2, cfg.frontend_tokens,
                                     cfg.num_kv_heads, 64)
    assert run.cache["xk"].abs().max() > 0


# ------------------------------------------------------------------- bf16
def test_bf16_matches_jax(models):
    """The bf16 witness: the JAX weights rounded to bf16 and carried
    across (``from_jax_numpy(dtype=bfloat16)``), one random frontend
    rounded to bf16, ``forward`` over 3 x 72 tokens and ``prefill`` of 64
    then 7 ``decode_step``s (test_torch_vlm_bf16.model_runs): the port's
    bf16 logits within MODEL_TOL of JAX's bf16 ones, and their distance
    from the f32 truth (JAX in f32 on the bf16 weights upcast), and the
    decode's from its own bf16 forward, at most SPREAD x JAX's (the VLM
    witness's bounds)."""
    cfg = jax_config(ARCH).reduced()
    assert cfg.dtype == "bfloat16"
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), models[1])
    w = (cfg, dataclasses.replace(cfg, dtype="float32"),
         get_config(ARCH).reduced(), jp,
         jax.tree.map(lambda a: a.astype(jnp.float32), jp),
         P.from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                          dtype=torch.bfloat16))
    runs = model_runs(w)
    for tf, td in runs.values():
        assert np.isfinite(tf).all() and np.isfinite(td).all()
    r = model_readings(runs)
    assert r["forward port-jax"] <= BF16_TOL
    assert r["decode port-jax"] <= BF16_TOL
    assert r["forward port-f32"] <= SPREAD * r["forward jax-f32"]
    assert r["decode-f32 forward port"] <= SPREAD * r["decode-f32 forward jax"]
    assert r["decode-own forward port"] <= SPREAD * r["decode-own forward jax"]
