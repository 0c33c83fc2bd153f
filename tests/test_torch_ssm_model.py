"""The recurrent families' model entry points (repro_torch.models.model,
SSM and HYBRID branches) and the batch launcher against the JAX package,
on the same weights (the JAX parameters carried across with
``params.from_jax_numpy``) and the same seed-made inputs, in f32:
reduced xlstm-350m (one mlstm x 3 + slstm pattern group, chunk 32),
reduced zamba2-1.2b (3 layers at every 2: the flat layout, a group and a
tail) and a 4-layer zamba2 (the stacked (2, 2, ...) layout).

* ``forward`` (remat none and "layer") and its aux (zero); ``prefill``:
  logits and every cache leaf; ``decode_step`` with per-row positions
  and an inactive row, through the torch path and the kernel's plain
  version (the JAX package's xla and pallas paths); two chunks of
  ``prefill_chunk`` / ``verify_step`` / ``mixed_step`` with an idle row:
  logits within TOL of max|logit| where defined, states within TOL of
  their max, and inactive or idle rows bitwise untouched.
* Decode equals teacher forcing (the JAX test's 2e-2 of max|logit|) on
  the port's own weights.
* The batch launcher's tokens equal the JAX launcher's (run with Auto
  mesh axes, as tests/test_torch_forward.py runs it); a prompt past one
  chunk that is no multiple of it is refused by the reference's assert.
* ``loss_fn`` and its grads by tests/test_torch_training.py's rule,
  remat none and "layer", with GRAD_TOL.
* The port's ``init_params`` gives the reference's layout; the paged
  pool and both packages' engines refuse the recurrent families with
  the reference's reasons; ``from_jax_numpy(dtype=bfloat16)`` keeps the
  four f32 leaves in f32.

Tolerances. TOL is 1e-5 of the reference's max, as elsewhere in the
port's tests, for zamba2; xLSTM's exponential input gates (up to e^8)
amplify f32 rounding, and the two packages, whose matmuls sum in other
orders, differ there by up to 1.02e-5 of max|logit| (prefill, 3 x 32)
and 2.2e-5 of the sLSTM's max|h|. That is noise of the order of the
reference's own: the JAX prefill's logits of one row move by 6.2e-6 of
max|logit| when it runs alone instead of in a batch of 3. xLSTM is held
to XLSTM_TOL = 3e-5. Grads: each leaf within GRAD_TOL = 1e-5 of its
max|g|, but for the leaves GRAD_WIDE names, held to 3e-5: Mamba2's
a_log, a reduction over every position with cancellation (1.67e-5 of
its max|g| in the 4-layer zamba2, no remat; every other zamba2 leaf
under 4.5e-6). xLSTM's grads share its logits' XLSTM_TOL: its forward
already differs by 1.02e-5, and its leaves read 0.8-2.14e-5 (embed the
widest, then the sLSTM's down projection 1.55e-5 and the first mLSTM's
q / k projections 1.3-1.4e-5).
"""
import contextlib
import dataclasses
import io
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduced_f32
from jax_compile_cache import jax_compile_cache  # noqa: F401
from repro.models import model as M
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.training import train_step as JT
from repro_torch import params as P
from repro_torch.configs.base import get_config
from repro_torch.launch import serve as TLS
from repro_torch.models import model as TM
from repro_torch.serving.engine import InferenceEngine
from repro_torch.training import train_step as TS
from repro_torch.training import tree

TOL = 1e-5
XLSTM_TOL = 3e-5
GRAD_TOL = 1e-5
GRAD_WIDE = {"['layers']['mamba']['a_log']": 3e-5}
B = 3
VARIANTS = {"xlstm": ("xlstm-350m", {}),
            "zamba2-flat": ("zamba2-1.2b", {}),
            "zamba2-stacked": ("zamba2-1.2b", {"num_layers": 4})}
ENGINE_REASON = "SSM decode runs through models.decode_step"
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


def port_cfg(name, **overrides):
    return dataclasses.replace(get_config(name).reduced(), dtype="float32",
                               **overrides)


@pytest.fixture(scope="module", params=list(VARIANTS))
def models(request):
    """(jax cfg, jax params, port cfg, port params) of one variant."""
    name, kw = VARIANTS[request.param]
    cfg = reduced_f32(name, **kw)
    jp = M.init_params(cfg, jax.random.PRNGKey(0))
    tp = P.from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, port_cfg(name, **kw), tp


def _tol(cfg) -> float:
    return XLSTM_TOL if cfg.family == "ssm" else TOL


def _grad_tol(cfg, leaf: str) -> float:
    """A grad leaf's tolerance: xLSTM's every leaf its family's, else
    GRAD_TOL, or GRAD_WIDE's for a leaf named there."""
    return XLSTM_TOL if cfg.family == "ssm" else GRAD_WIDE.get(leaf, GRAD_TOL)


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() <= tol * max(1.0, np.abs(ref).max())


def _tok(seed, shape):
    return np.random.default_rng(seed).integers(1, 1000, shape).astype(
        np.int32)


def _cache_close(tc, jc, tol):
    """Every leaf of a port cache against the JAX one (same tree order):
    shapes and dtypes equal, values within ``tol`` of the leaf's max."""
    got, want = tree.leaves(tc), jax.tree.leaves(jc)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1e-30)


def _row_views(tcfg, cache, b):
    """Row ``b`` of every leaf of a port recurrent cache: the KV entries'
    batch axis is 1; a state's follows its layer axes (2 in zamba2's
    stacked layout, else 1)."""
    out = []
    for name, sub in cache.items():
        lead = 1
        if name == "ssm" and tcfg.family == "hybrid" and \
                tcfg.num_layers % tcfg.ssm.shared_attn_every == 0:
            lead = 2
        out += [leaf.select(lead, b).clone() for leaf in tree.leaves(sub)]
    return out


# ---------------------------------------------------------------- forward
@pytest.mark.parametrize("remat", [False, "layer"], ids=["plain", "remat"])
def test_forward_matches_jax(models, remat):
    """forward over 2 x 64 tokens (two chunks): logits within TOL (xLSTM:
    XLSTM_TOL) of max|logit|; the aux a 0-d f32 zero, as the
    reference's."""
    cfg, jp, tcfg, tp = models
    toks = _tok(1, (2, 64))
    jl, jaux = M.forward(jp, cfg, {"tokens": jnp.asarray(toks)})
    tl, taux = TM.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                          remat=remat)
    assert _close(tl, jl, _tol(cfg))
    assert taux.dtype == torch.float32 and taux.dim() == 0
    assert float(taux) == float(jaux) == 0.0


def test_prefill_matches_jax(models):
    """prefill of 3 x 32 tokens into cache_len 48: logits and every cache
    leaf (the recurrent states, the conv states, zamba2's KV entries)."""
    cfg, jp, tcfg, tp = models
    toks = _tok(2, (B, 32))
    jl, jc = M.prefill(jp, cfg, {"tokens": jnp.asarray(toks),
                                 "cache_len": 48})
    tl, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks),
                                   "cache_len": 48})
    assert _close(tl, jl, _tol(cfg))
    _cache_close(tc, jc, _tol(cfg))
    assert set(tc) == ({"ssm", "kv"} if tcfg.family == "hybrid"
                       else {"ssm"})


@pytest.mark.parametrize("impl", [("xla", "torch"), ("pallas", "kernel")],
                         ids=["xla-torch", "pallas-kernel"])
def test_decode_step_matches_jax(models, impl):
    """Three decode steps from a 32-token prefill at per-row positions
    (rows at 32, 35 and 32), row 2 inactive: active rows' logits within
    TOL of JAX's (xLSTM: XLSTM_TOL), the caches too, and row 2 of every
    leaf bitwise untouched."""
    cfg, jp, tcfg, tp = models
    toks = _tok(3, (B, 36))
    _, jc = M.prefill(jp, cfg, {"tokens": jnp.asarray(toks[:, :32]),
                                "cache_len": 48})
    _, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks[:, :32]),
                                  "cache_len": 48})
    row2 = _row_views(tcfg, tc, 2)
    active = np.array([True, True, False])
    for i in range(3):
        pos = np.array([32 + i, 35 + i, 32 + i], np.int32)
        tok = toks[:, 32 + i:33 + i]
        jl, jc = M.decode_step(jp, cfg, jnp.asarray(tok), jc,
                               jnp.asarray(pos), decode_impl=impl[0],
                               active=jnp.asarray(active))
        tl, tc = TM.decode_step(tp, tcfg, torch.from_numpy(tok), tc,
                                torch.from_numpy(pos), decode_impl=impl[1],
                                active=torch.from_numpy(active))
        assert _close(tl[:2], np.asarray(jl)[:2], _tol(cfg)), i
    _cache_close(tc, jc, _tol(cfg))
    for a, b in zip(_row_views(tcfg, tc, 2), row2):
        assert torch.equal(a, b)


def test_uniform_decode_matches_jax(models):
    """The batch launcher's step: a scalar position, no mask."""
    cfg, jp, tcfg, tp = models
    toks = _tok(4, (2, 20))
    jl, jc = M.prefill(jp, cfg, {"tokens": jnp.asarray(toks[:, :16]),
                                 "cache_len": 24})
    tl, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks[:, :16]),
                                   "cache_len": 24})
    for t in range(16, 20):
        jl, jc = M.decode_step(jp, cfg, jnp.asarray(toks[:, t:t + 1]), jc, t)
        tl, tc = TM.decode_step(tp, tcfg, torch.from_numpy(toks[:, t:t + 1]),
                                tc, t)
        assert _close(tl, jl, _tol(cfg)), t
    _cache_close(tc, jc, _tol(cfg))


def test_decode_matches_forward(models):
    """Port-only twin of tests/test_decode_consistency.py::
    test_decode_matches_forward: 16 uniform decode steps from an empty
    cache equal the teacher-forced forward at the last position within
    2e-2 of max|logit|, on the port's own weights."""
    tcfg = models[2]
    tp = TM.init_params(tcfg, seed=0, device="cpu")
    toks = torch.tensor(_tok(5, (2, 16)) % tcfg.vocab_size)
    ref = TM.forward(tp, tcfg, {"tokens": toks})[0][:, -1]
    cache = TM.init_cache(tcfg, 2, 32, device="cpu")
    for t in range(16):
        lg, cache = TM.decode_step(tp, tcfg, toks[:, t:t + 1], cache, t)
    scale = ref.abs().max().item() + 1e-9
    assert (lg - ref).abs().max().item() / scale < 2e-2


def test_hybrid_shallower_than_a_group_matches_jax():
    """zamba2 with fewer layers than ``shared_attn_every`` (1 of 2): no
    group, so no shared block and an empty KV stack; prefill and two
    decode steps (row 1 inactive in the second) against the JAX package,
    the inactive row's states bitwise untouched."""
    cfg = reduced_f32("zamba2-1.2b", num_layers=1)
    tcfg = port_cfg("zamba2-1.2b", num_layers=1)
    jp = M.init_params(cfg, jax.random.PRNGKey(0))
    tp = P.from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = _tok(6, (2, 18))
    jl, jc = M.prefill(jp, cfg, {"tokens": jnp.asarray(toks[:, :16]),
                                 "cache_len": 24})
    tl, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks[:, :16]),
                                   "cache_len": 24})
    assert tc["kv"]["k"].shape[0] == 0
    assert _close(tl, jl)
    active = np.array([True, False])
    for t, act in ((16, None), (17, active)):
        row1 = _row_views(tcfg, tc, 1)
        jl, jc = M.decode_step(
            jp, cfg, jnp.asarray(toks[:, t:t + 1]), jc, t,
            active=None if act is None else jnp.asarray(act))
        tl, tc = TM.decode_step(
            tp, tcfg, torch.from_numpy(toks[:, t:t + 1]), tc, t,
            active=None if act is None else torch.from_numpy(act))
        rows = [0, 1] if act is None else [0]
        assert _close(tl[rows], np.asarray(jl)[rows]), t
    _cache_close(tc["ssm"], jc["ssm"], TOL)
    assert {k: tuple(v.shape) for k, v in tc["kv"].items()} == \
        {k: v.shape for k, v in jc["kv"].items()}
    for a, b in zip(_row_views(tcfg, tc, 1), row1):
        assert torch.equal(a, b)


# ------------------------------------------ chunk, verify and mixed steps
CHUNKS = ((np.array([0, 0, 0]), np.array([8, 5, 0])),
          (np.array([8, 5, 0]), np.array([3, 8, 4])))


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
    """Two chunks of 8 through the masked per-token decode loop in both
    packages from empty caches of 3 rows x 40: each call's logits where
    defined (prefill: rows with tokens; verify: positions below lengths;
    mixed: the decode rows), the caches after every call, and a row a
    call leaves idle bitwise untouched (in mixed_step an idle prefill
    row decodes)."""
    cfg, jp, tcfg, tp = models
    jc = M.init_cache(cfg, B, 40)
    tc = TM.init_cache(tcfg, B, 40, device="cpu")
    for i, (start, lengths) in enumerate(CHUNKS):
        toks = _tok(10 + i, (B, 8))
        before = {b: _row_views(tcfg, tc, b) for b in range(B)}
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
                assert n == 0 or _close(tl[b, :n], jl[b, :n],
                                        _tol(cfg)), (i, b)
            elif (lengths[b] > 0) != (fn == "mixed_step"):
                assert _close(tl[b], jl[b], _tol(cfg)), (i, b)
            if lengths[b] == 0 and fn != "mixed_step":
                for x, y in zip(_row_views(tcfg, tc, b), before[b]):
                    assert torch.equal(x, y), (i, b)
        _cache_close(tc, jc, _tol(cfg))


# ---------------------------------------------------------------- launcher
@pytest.mark.parametrize("name", ["xlstm-350m", "zamba2-1.2b"])
def test_batch_launcher_prints_jax_sequence(monkeypatch, name):
    """The batch launcher run in process on the JAX launcher's weights and
    prompt ids: its ``first sequence`` line equals
    ``repro.launch.serve.main``'s (given Auto mesh axes, as
    tests/test_torch_forward.py gives it)."""
    from jax.sharding import AxisType
    from repro.launch import serve as JS
    cfg = reduced_f32(name)
    key = jax.random.PRNGKey(0)
    jparams = jax.tree.map(np.asarray, M.init_params(cfg, key))
    argv = ["--arch", name, "--reduced", "--batch", "2", "--prompt-len",
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
    toks = np.asarray(jax.random.randint(key, (2, 16), 1, cfg.vocab_size))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = TLS.serve_batch(TLS.parse_args(argv + ["--device", "cpu"]),
                              params=P.from_jax_numpy(jparams, device="cpu"),
                              tokens=torch.from_numpy(toks))
    out = buf.getvalue().splitlines()
    assert len(ref) == 1
    assert [ln for ln in out if ln.startswith("first sequence:")] == ref
    assert out[0].startswith(f"arch={cfg.name} mesh 1x1 batch=2 prompt=16 "
                             "-> 4 new tokens")
    assert run.tokens.shape == (2, 4) and len(run.logits) == 4
    assert "ssm" in run.cache


def test_batch_launcher_refuses_a_ragged_long_prompt():
    """A prompt past one chunk (32 reduced) must be a multiple of it: the
    reference's assert, no padding; a multiple serves."""
    for name in ("xlstm-350m", "zamba2-1.2b"):
        base = ["--arch", name, "--reduced", "--batch", "1",
                "--new-tokens", "2", "--device", "cpu"]
        with contextlib.redirect_stdout(io.StringIO()):
            with pytest.raises(AssertionError, match="not divisible"):
                TLS.serve_batch(TLS.parse_args(base + ["--prompt-len",
                                                       "40"]))
            run = TLS.serve_batch(TLS.parse_args(base + ["--prompt-len",
                                                         "64"]))
        assert run.tokens.shape == (1, 2)


# ----------------------------------------------------------------- training
@pytest.mark.parametrize("remat", [False, "layer"], ids=["none", "layer"])
def test_loss_and_grads_match_jax(models, remat):
    """loss_fn and its grads over 2 x 32 tokens (one chunk) against
    jax.value_and_grad of the JAX loss: the loss within 1e-5 relative,
    the aux zero, each grad leaf within GRAD_TOL of its max |g| and
    non-zero somewhere."""
    cfg, jp, tcfg, tp = models
    toks = _tok(40, (2, 33))
    labels = toks[:, 1:].copy()
    labels[1, -4:] = 0                              # padding
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]),
          "labels": torch.from_numpy(labels)}
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
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.abs(w).max() > 0
        tol = _grad_tol(cfg, jax.tree_util.keystr(path))
        assert np.abs(g - w).max() <= tol * np.abs(w).max(), path


# ------------------------------------------------- layout, params, refusals
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_init_params_layout(variant):
    """The port's own init: the JAX package's tree, shapes and leaf dtypes
    in f32 and bf16 (the four f32 leaves f32 in both), and its cache's."""
    name, kw = VARIANTS[variant]
    for dtype in ("float32", "bfloat16"):
        tcfg = dataclasses.replace(port_cfg(name, **kw), dtype=dtype)
        jcfg = dataclasses.replace(reduced_f32(name, **kw), dtype=dtype)
        p = TM.init_params(tcfg, seed=0, device="cpu")
        ref = jax.eval_shape(lambda: M.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
        assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(
            ".")[-1]), p) == jax.tree.map(
            lambda a: (tuple(a.shape), str(a.dtype)), ref)
        c = TM.init_cache(tcfg, 2, 24, device="cpu")
        jc = jax.eval_shape(lambda: M.init_cache(jcfg, 2, 24))
        assert [(tuple(t.shape), str(t.dtype).split(".")[-1])
                for t in tree.leaves(c)] == \
            [(tuple(a.shape), str(a.dtype)) for a in jax.tree.leaves(jc)]
        assert not any(t.any() for t in tree.leaves(c))


def test_from_jax_numpy_keeps_the_f32_leaves(models):
    """Carried across with dtype=bfloat16, every leaf is bf16 but a_log,
    dt_bias, wif and rh, which stay f32 bit for bit."""
    cfg, jp, _, _ = models
    jn = jax.tree.map(np.asarray, jp)
    tp = P.from_jax_numpy(jn, device="cpu", dtype=torch.bfloat16)
    n_f32 = 0
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(jn),
                                 tree.leaves(tp)):
        key = path[-1].key
        if key in ("a_log", "dt_bias", "wif", "rh"):
            assert got.dtype == torch.float32, key
            assert np.array_equal(got.numpy(), want)
            n_f32 += 1
        else:
            assert got.dtype == torch.bfloat16, key
    assert n_f32 == (2 if cfg.family == "hybrid" else 4)


@pytest.mark.parametrize("name", ["xlstm-350m", "zamba2-1.2b"])
def test_engines_refuse_the_recurrent_families(name):
    """Both packages' InferenceEngine raise the reference's
    NotImplementedError, in its words."""
    cfg, tcfg = reduced_f32(name), port_cfg(name)
    with pytest.raises(NotImplementedError, match=re.escape(ENGINE_REASON)):
        JaxEngine(cfg, M.init_params(cfg, jax.random.PRNGKey(0)), n_max=2,
                  c_max=32)
    with pytest.raises(NotImplementedError,
                       match=re.escape(ENGINE_REASON)) as err:
        InferenceEngine(tcfg, TM.init_params(tcfg, seed=0, device="cpu"),
                        n_max=2, c_max=32)
    assert "later slice" not in str(err.value)


@pytest.mark.parametrize("name", ["xlstm-350m", "zamba2-1.2b"])
def test_paged_pool_refuses_the_recurrent_families(name):
    """init_paged_cache and the paged steps raise the reference's
    reason (the JAX init_paged_cache's words)."""
    cfg, tcfg = reduced_f32(name), port_cfg(name)
    with pytest.raises(NotImplementedError, match=re.escape(PAGED_REASON)):
        M.init_paged_cache(cfg, 4, 16)
    tp = TM.init_params(tcfg, seed=0, device="cpu")
    tables = torch.zeros((1, 2), dtype=torch.int32)
    toks = torch.ones((1, 4), dtype=torch.long)
    for call in (lambda: TM.init_paged_cache(tcfg, 4, 16, device="cpu"),
                 lambda: TM.paged_decode_step(tp, tcfg, toks[:, :1], {},
                                              tables, torch.tensor([0])),
                 lambda: TM.paged_prefill_chunk(
                     tp, tcfg, toks, {}, tables, torch.tensor([0]),
                     torch.tensor([4]))):
        with pytest.raises(NotImplementedError,
                           match=re.escape(PAGED_REASON)):
            call()
