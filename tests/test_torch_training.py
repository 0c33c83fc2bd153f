"""The port's training path (repro_torch.training: AdamW, the train step
with remat and microbatching, checkpoints; ``forward(remat=)``) against
the JAX package's on the same parameters and optimizer state (carried
across through numpy by ``repro_torch.params``) and the same seed-made
batches, plus port-only twins of tests/test_optimizer.py, the
microbatching case of tests/test_perf_opts.py and the train-step case
of tests/test_models_smoke.py.

Tolerances. ``lr_at`` is bitwise: the same float32 operations, and the
cosine from the C library's ``cosf`` on both sides. Otherwise f32 on
both sides with sums taken in another order: losses and grad norms
within 1e-5 relative, grads within 1e-5 of each leaf's max |g|. After
AdamW, parameters are held by the parity rule: Adam's first steps move
an element by about +-lr whatever its gradient's size, so where |g| is
tiny (<= 1e-4 of its leaf's max |g| at some step) roundoff can flip the
sign and the element lands up to 2 lr a step away; elsewhere the
parameters agree within 1e-5. A bfloat16 parameter may round the other
way where its f32 value sits at a rounding edge: one bf16 ulp.
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
from repro.configs.base import get_config as jax_get_config
from repro.models import model as M
from repro.training import optimizer as JO
from repro.training import train_step as JT
from repro_torch import params as P
from repro_torch.configs import base as TB
from repro_torch.models import model as TM
from repro_torch.training import checkpoint as TCK
from repro_torch.training import optimizer as TO
from repro_torch.training import train_step as TS
from repro_torch.training import tree
from repro_torch.training.data import DataConfig, batch_at

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the parity rule, shared with phase 11)


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
TINY = 1e-4


def port_cfg(name="minitron-8b"):
    return dataclasses.replace(TB.get_config(name).reduced(),
                               dtype="float32")


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _grads_close(got, want):
    """Leaf by leaf within TOL of the leaf's max |g| (leaves in order)."""
    got, want = tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= TOL * np.abs(w).max()


def _params_parity(got, want, grad_steps, lr: float):
    """The parity rule (module docstring, ``chip_smoke.parity_gaps``) on
    f32 parameters: ``grad_steps`` are the JAX grads of each step taken."""
    for i, (g, w) in enumerate(zip(tree.leaves(got), jax.tree.leaves(want))):
        tiny = np.zeros(w.shape, bool)
        for gs in grad_steps:
            a = np.abs(_np(jax.tree.leaves(gs)[i]))
            tiny |= a <= TINY * a.max()
        near, flip, ok = chip_smoke.parity_gaps(
            _np(g), _np(w), tiny, 2 * lr * len(grad_steps))
        assert ok, (i, near, flip)


def _batch(cfg, b=4, s=32, seed=1):
    """Tokens and labels drawn with numpy; one label in each row is
    padding (0)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[:, -1] = 0
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})


# --------------------------------------- twins of tests/test_optimizer.py
def test_adamw_minimizes_quadratic():
    cfg = TO.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=1000,
                         weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = TO.init_adamw(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = TO.adamw_update(cfg, grads, state, params)
    assert float(params["w"].abs().max()) < 0.1
    assert int(state.step) == 200 and state.step.dtype == torch.int32


def test_grad_clip():
    cfg = TO.AdamWConfig(lr=1e-3, grad_clip=1.0, warmup_steps=0)
    params = {"w": torch.zeros(3)}
    state = TO.init_adamw(params)
    _, _, gnorm = TO.adamw_update(cfg, {"w": torch.full((3,), 1e6)}, state,
                                  params)
    assert float(gnorm) > 1e5           # reported norm is pre-clip


def test_lr_schedule():
    cfg = TO.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110)
    assert float(TO.lr_at(cfg, 5)) == pytest.approx(0.5)
    assert float(TO.lr_at(cfg, 10)) == pytest.approx(1.0, abs=0.01)
    assert float(TO.lr_at(cfg, 110)) == pytest.approx(0.0, abs=1e-6)


def test_global_norm():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert float(TO.global_norm(t)) == pytest.approx(5.0)


def test_data_determinism_and_shape():
    dc = DataConfig(vocab_size=1000, seq_len=16, global_batch=4, seed=9)
    b1, b2 = batch_at(dc, 3), batch_at(dc, 3)
    assert np.array_equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].shape == (4, 16)
    assert b1["tokens"].min() >= 1
    b3 = batch_at(dc, 4)
    assert not np.array_equal(b1["tokens"], b3["tokens"])
    # labels are next-token shifted
    assert np.array_equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_checkpoint_roundtrip(tmp_path, dtype):
    params = {"w": torch.arange(6.0).reshape(2, 3).to(dtype),
              "b": torch.ones(3, dtype=dtype)}
    opt = TO.init_adamw(params)
    TCK.save(str(tmp_path), 7, params, opt)
    assert TCK.latest_step(str(tmp_path)) == 7
    back = TCK.restore(str(tmp_path), 7, {"params": params, "opt": opt})
    for a, b in zip(tree.leaves(back["params"]), tree.leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert back["opt"].step.dtype == torch.int32
    assert all(m.dtype == torch.float32 for m in tree.leaves(back["opt"].m))


# ------------------------------------------------------------ optimizer
@pytest.mark.parametrize("warmup", [0, 1, 100])
def test_lr_at_bitwise(warmup):
    total = 1000
    cfg = JO.AdamWConfig(warmup_steps=warmup, total_steps=total)
    tcfg = TO.AdamWConfig(warmup_steps=warmup, total_steps=total)
    want = np.array([np.asarray(JO.lr_at(cfg, jnp.int32(s)))
                     for s in range(total + 6)])
    got = np.array([TO.lr_at(tcfg, torch.tensor(s, dtype=torch.int32))
                    .numpy() for s in range(total + 6)])
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


def _tree(rng, dtype, scale=1.0):
    """A params-like tree: stacked per-layer leaves, a vector, a matrix."""
    def a(*shape):
        return jnp.asarray(rng.standard_normal(shape) * scale, dtype)
    return {"layers": {"w": a(3, 8, 16), "b": a(3, 16)}, "embed": a(40, 8),
            "ln": a(8)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [True, False], ids=["clipped", "unclipped"])
def test_adamw_update_matches_jax(dtype, clip):
    """Three updates from one state: params, moments, step and grad norm
    against JAX's (gradient norms ~270, clipped at 1 or under a clip of
    1e3)."""
    rng = np.random.default_rng(0)
    cfg = JO.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                         grad_clip=1.0 if clip else 1e3)
    tcfg = TO.AdamWConfig(**dataclasses.asdict(cfg))
    jp = _tree(rng, dtype)
    js = JO.init_adamw(jp)
    tp = P.from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    ts = TO.init_adamw(tp)
    for _ in range(3):
        jg = _tree(rng, dtype, scale=10.0)
        tg = P.from_jax_numpy(jax.tree.map(np.asarray, jg), device="cpu")
        jp, js, jn = JO.adamw_update(cfg, jg, js, jp)
        tp, ts, tn = TO.adamw_update(tcfg, tg, ts, tp)
        assert float(tn) == pytest.approx(float(jn), rel=TOL)
        assert (float(jn) > cfg.grad_clip) == clip
    assert int(ts.step) == int(js.step) == 3
    for got, want in ((ts.m, js.m), (ts.v, js.v)):
        for g, w in zip(tree.leaves(got), jax.tree.leaves(want)):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-7)
    for g, w in zip(tree.leaves(tp), jax.tree.leaves(jp)):
        assert g.dtype == getattr(torch, dtype)
        d = np.abs(_np(g) - _np(w))
        ulp = 2.0 ** -8 * np.abs(_np(w)) if dtype == "bfloat16" else 0.0
        assert (d <= 1e-6 + ulp).all()


def test_update_walks_large_leaves_in_slabs(monkeypatch):
    """A leaf larger than SLAB is updated a slab of rows at a time, with
    the result of the whole-leaf update."""
    rng = np.random.default_rng(3)
    p = {"w": torch.from_numpy(rng.standard_normal((6, 5, 4))
                               .astype(np.float32))}
    g = {"w": torch.from_numpy(rng.standard_normal((6, 5, 4))
                               .astype(np.float32))}
    cfg = TO.AdamWConfig(lr=1e-2, warmup_steps=0)
    whole = {"w": p["w"].clone()}
    pw, sw, nw = TO.adamw_update(cfg, g, TO.init_adamw(whole), whole)
    monkeypatch.setattr(TO, "SLAB", 40)            # two layers a slab
    assert len(list(TO._slabs(p["w"]))) == 3
    ps, ss, ns = TO.adamw_update(cfg, g, TO.init_adamw(p), p)
    assert torch.equal(ps["w"], pw["w"]) and torch.equal(ss.v["w"], sw.v["w"])
    assert float(ns) == pytest.approx(float(nw), rel=1e-6)


# ------------------------------------------------------- loss and grads
def test_cross_entropy_masks_padding():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(1, 11, (2, 5)).astype(np.int32)
    labels[0, 3:] = 0
    labels[1, 0] = 0
    want = JT.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = TS.cross_entropy(torch.from_numpy(logits),
                           torch.from_numpy(labels))
    assert float(got) == pytest.approx(float(want), rel=TOL)
    assert float(TS.cross_entropy(torch.from_numpy(logits),
                                  torch.zeros((2, 5), dtype=torch.int32))) \
        == 0.0


LOSS_CONFIGS = ["minitron-8b", "nemotron-4-15b", "llama3-70b", "qwen1.5-32b"]


@pytest.fixture(scope="module", params=LOSS_CONFIGS)
def model(request):
    name = request.param
    cfg = reduced_f32(name)
    jp = M.init_params(cfg, jax.random.PRNGKey(0))
    return (cfg, jp, port_cfg(name),
            P.from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu"))


@pytest.mark.parametrize("remat", [False, "layer", True],
                         ids=["none", "layer", "full"])
def test_loss_and_grads_match_jax(model, remat):
    cfg, jp, tcfg, tp = model
    jb, tb = _batch(cfg, b=2, s=16)
    (jl, jaux), jg = jax.value_and_grad(JT.loss_fn, has_aux=True)(
        jp, cfg, jb, None, remat)
    (tl, taux), tg = TS.value_and_grad(tp, tcfg, tb, remat=remat)
    assert float(tl) == pytest.approx(float(jl), rel=TOL)
    assert float(taux["ce"]) == pytest.approx(float(jaux["ce"]), rel=TOL)
    assert float(taux["lb_loss"]) == float(jaux["lb_loss"]) == 0.0
    _grads_close(tg, jg)
    assert not any(p.requires_grad for p in tree.leaves(tp))


def test_remat_keeps_loss_and_grads_bitwise():
    """Layer and full remat recompute the same forward: on one device the
    port's loss and grads are the no-remat ones, bit for bit."""
    tcfg = port_cfg()
    tp = TM.init_params(tcfg, seed=0, device="cpu")
    _, tb = _batch(tcfg, b=2, s=16, seed=5)
    (l0, _), g0 = TS.value_and_grad(tp, tcfg, tb, remat=False)
    for remat in ("layer", "full"):
        (l1, _), g1 = TS.value_and_grad(tp, tcfg, tb, remat=remat)
        assert torch.equal(l0, l1)
        assert all(torch.equal(a, b) for a, b in
                   zip(tree.leaves(g0), tree.leaves(g1)))


# ----------------------------------------------------------- train step
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=50)


def _jax_steps(cfg, jp, js, batches, opt, **kw):
    """JAX train steps; also each step's grads (the parity rule's mask)."""
    step = jax.jit(JT.make_train_step(cfg, JO.AdamWConfig(**opt), **kw))
    grad = jax.jit(jax.grad(lambda p, b: JT.loss_fn(p, cfg, b, None,
                                                    "layer")[0]))
    grads, metrics = [], []
    for b in batches:
        grads.append(grad(jp, b))
        jp, js, m = step(jp, js, b)
        metrics.append(m)
    return jp, js, grads, metrics


def test_three_train_steps_match_jax():
    """Three make_train_step steps from the JAX weights and the JAX
    init_adamw state carried across."""
    cfg, tcfg = reduced_f32("minitron-8b"), port_cfg()
    jp = M.init_params(cfg, jax.random.PRNGKey(0))
    js = JO.init_adamw(jp)
    tp = P.from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    ts = P.adamw_from_jax_numpy(jax.tree.map(np.asarray, js), device="cpu")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    batches = [batch_at(dc, i) for i in range(3)]
    jp, js, grads, jm = _jax_steps(
        cfg, jp, js, [{k: jnp.asarray(v) for k, v in b.items()}
                      for b in batches], OPT)
    step = TS.make_train_step(tcfg, TO.AdamWConfig(**OPT))
    for b, m in zip(batches, jm):
        tp, ts, tm = step(tp, ts, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
        for k in ("loss", "ce", "grad_norm"):
            assert float(tm[k]) == pytest.approx(float(m[k]), rel=TOL), k
        assert int(tm["step"]) == int(m["step"])
    _params_parity(tp, jp, grads, OPT["lr"])


@pytest.fixture(scope="module")
def perf_setup():
    """tests/test_perf_opts.py's setup: reduced minitron-8b f32, a batch
    of 4 x 32 (labels >= 1)."""
    cfg = reduced_f32("minitron-8b")
    params = M.init_params(cfg, jax.random.PRNGKey(0))
    batch = {"tokens": jax.random.randint(jax.random.PRNGKey(1), (4, 32), 0,
                                          cfg.vocab_size),
             "labels": jax.random.randint(jax.random.PRNGKey(2), (4, 32), 1,
                                          cfg.vocab_size)}
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    return cfg, params, batch, tb


def _port_state(jparams):
    tp = P.from_jax_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return tp, TO.init_adamw(tp)


def test_microbatching_matches_full_batch(perf_setup):
    """Twin of tests/test_perf_opts.py::test_microbatching_matches_full_batch
    on the port."""
    cfg, params, _, tb = perf_setup
    opt_cfg = TO.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    tcfg = port_cfg()
    p1, o1 = _port_state(params)
    p1, _, m1 = TS.make_train_step(tcfg, opt_cfg)(p1, o1, tb)
    p2, o2 = _port_state(params)
    p2, _, m2 = TS.make_train_step(tcfg, opt_cfg, microbatches=2)(p2, o2, tb)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    for a, b in zip(tree.leaves(p1), tree.leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4)


def test_microbatches_match_jax_microbatches(perf_setup):
    """microbatches=2 on both packages: loss, grad norm, parameters."""
    cfg, params, batch, tb = perf_setup
    opt = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    jp, _, grads, jm = _jax_steps(cfg, params, JO.init_adamw(params),
                                  [batch], opt, microbatches=2)
    tp, ts = _port_state(params)
    tp, ts, tm = TS.make_train_step(port_cfg(), TO.AdamWConfig(**opt),
                                    microbatches=2)(tp, ts, tb)
    for k in ("loss", "ce", "grad_norm"):
        assert float(tm[k]) == pytest.approx(float(jm[0][k]), rel=TOL), k
    _params_parity(tp, jp, grads, opt["lr"])
    with pytest.raises(ValueError, match="microbatches"):
        TS.make_train_step(port_cfg(), TO.AdamWConfig(**opt),
                           microbatches=3)(tp, ts, tb)


def test_train_step_decreases_loss():
    """Twin of tests/test_models_smoke.py::test_train_step_decreases_loss
    for minitron-8b: 12 steps on the port's own weights."""
    tcfg = port_cfg()
    params = TM.init_params(tcfg, seed=0, device="cpu")
    opt = TO.init_adamw(params)
    step = TS.make_train_step(tcfg, TO.AdamWConfig(lr=1e-3, warmup_steps=2,
                                                   total_steps=50))
    dc = DataConfig(vocab_size=tcfg.vocab_size, seq_len=32, global_batch=4)
    losses = []
    for i in range(12):
        b = {k: torch.from_numpy(v) for k, v in batch_at(dc, i).items()}
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1])
    assert min(losses[4:]) < losses[0] + 0.02


def _to_port_config(jcfg):
    """A JAX ModelConfig as the port's (its nested configs included)."""
    kw = {}
    for f in dataclasses.fields(jcfg):
        v = getattr(jcfg, f.name)
        if dataclasses.is_dataclass(v):
            v = getattr(TB, type(v).__name__)(**dataclasses.asdict(v))
        kw[f.name] = v
    return TB.ModelConfig(**kw)


@pytest.mark.parametrize("name", ["deepseek-v2-236b", "zamba2-1.2b",
                                  "xlstm-350m", "seamless-m4t-large-v2",
                                  "llama4-scout-17b-a16e",
                                  "llama-3.2-vision-11b"])
def test_other_families_raise_naming_their_slice(name):
    """The other families of tests/test_models_smoke.py's train case (and
    the two left) are refused by the train step, naming their slice."""
    tcfg = _to_port_config(dataclasses.replace(
        jax_get_config(name).reduced(), dtype="float32"))
    params = TM.init_params(port_cfg(), seed=0, device="cpu")
    step = TS.make_train_step(tcfg, TO.AdamWConfig())
    dc = DataConfig(vocab_size=port_cfg().vocab_size, seq_len=8,
                    global_batch=2)
    b = {k: torch.from_numpy(v) for k, v in batch_at(dc, 0).items()}
    with pytest.raises(NotImplementedError,
                       match=re.escape(TM.FAMILY_SLICES[tcfg.family])):
        step(params, TO.init_adamw(params), b)


def test_parallel_context_refused():
    with pytest.raises(NotImplementedError, match="later slice"):
        TS.make_train_step(port_cfg(), TO.AdamWConfig(), parallel=object())
