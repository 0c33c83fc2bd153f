"""The port's recurrent blocks (repro_torch.models.ssm: Mamba2, mLSTM,
sLSTM) against the JAX package's ``repro/models/ssm.py``, one layer's
weights carried across with ``params.from_jax_numpy``, on seed-made
inputs at the reduced configs' widths (zamba2-1.2b for Mamba2,
xlstm-350m for the xLSTM blocks; chunk_size 32), in f32.

* Each ``*_forward`` at T = 16 (one chunk shorter than chunk_size) and
  T = 64 (two chunks): the output within 1e-5 of max|y| and the final
  state within 1e-5 of max|state| (both against JAX's); then from a
  non-zero state (the first half's final state carried into the
  second half) the same, and for the xLSTM blocks the second half
  equal to the whole sequence's.
* Each ``*_decode`` from the forward's state (Mamba2's conv state being
  the last three pre-activation ``xbc`` rows, as the model's prefill
  keeps them): the output and the new state against JAX's decode from
  the same state, and the output against the port's own forward over
  the longer sequence at position T (T + 1 tokens where that is one
  chunk, else the next multiple of the chunk: the blocks are causal, so
  the tail cannot change position T).
* ``init_*`` and ``init_*_state``: the reference's shapes and dtypes
  (the decay rates, gates and recurrent weights f32 in a bf16 model),
  and the reference's scales.
* A sequence past one chunk that is no multiple of it is refused by
  the reference's assert.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduced_f32
from jax_compile_cache import jax_compile_cache  # noqa: F401
from repro.models import ssm as JS
from repro_torch import params as P
from repro_torch.configs.base import get_config
from repro_torch.models import ssm as TS

TOL = 1e-5
B = 3
KINDS = ("mamba2", "mlstm", "slstm")
ARCH = {"mamba2": "zamba2-1.2b", "mlstm": "xlstm-350m",
        "slstm": "xlstm-350m"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one intra-op
    thread per worker keeps these small-shape tests from oversubscribing
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, ref) -> float:
    """max|got - ref| / max|ref|."""
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _cfgs(kind):
    return (reduced_f32(ARCH[kind]),
            dataclasses.replace(get_config(ARCH[kind]).reduced(),
                                dtype="float32"))


JAX_FNS = {"mamba2": (JS.init_mamba2, JS.mamba2_forward, JS.mamba2_decode),
           "mlstm": (JS.init_mlstm, JS.mlstm_forward, JS.mlstm_decode),
           "slstm": (JS.init_slstm, JS.slstm_forward, JS.slstm_decode)}
PORT_FNS = {"mamba2": (TS.mamba2_forward, TS.mamba2_decode),
            "mlstm": (TS.mlstm_forward, TS.mlstm_decode),
            "slstm": (TS.slstm_forward, TS.slstm_decode)}


@pytest.fixture(scope="module", params=KINDS)
def block(request):
    """(kind, jax cfg, port cfg, jax params, port params) of one layer."""
    kind = request.param
    cfg, tcfg = _cfgs(kind)
    jp = JAX_FNS[kind][0](jax.random.PRNGKey(5), cfg)
    return kind, cfg, tcfg, jp, P.from_jax_numpy(
        jax.tree.map(np.asarray, jp), device="cpu")


def _u(cfg, t, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, t, cfg.d_model)).astype(np.float32)


def _leaves(state):
    """A state's leaves in one order for both packages: a dict by key,
    the sLSTM tuple in order."""
    if isinstance(state, dict):
        return [state[k] for k in sorted(state)]
    return list(state)


def _forward(kind, fn, p, cfg, u, state):
    if kind == "mamba2":
        y, h = fn(p, cfg, u, state)
        return y, {"h": h}
    return fn(p, cfg, u, state)


def _state_close(got, ref):
    g, r = _leaves(got), _leaves(ref)
    assert len(g) == len(r)
    for a, b in zip(g, r):
        assert tuple(a.shape) == tuple(np.shape(b))
        assert _rel(a, b) <= TOL


@pytest.mark.parametrize("t", [16, 64])
def test_forward_matches_jax(block, t):
    """The forward from the zero state, and its second half again from
    the first half's final state: outputs and final states against
    JAX's."""
    kind, cfg, tcfg, jp, tp = block
    jfwd, tfwd = JAX_FNS[kind][1], PORT_FNS[kind][0]
    u = _u(cfg, t)
    jy, js = _forward(kind, jfwd, jp, cfg, jnp.asarray(u), None)
    ty, ts = _forward(kind, tfwd, tp, tcfg, torch.from_numpy(u), None)
    assert ty.shape == (B, t, cfg.d_model)
    assert _rel(ty, jy) <= TOL
    _state_close(ts, js)
    half = t // 2
    jy1, js1 = _forward(kind, jfwd, jp, cfg, jnp.asarray(u[:, :half]), None)
    ty1, ts1 = _forward(kind, tfwd, tp, tcfg, torch.from_numpy(u[:, :half]),
                        None)
    carry = (lambda s: s["h"]) if kind == "mamba2" else (lambda s: s)
    jy2, js2 = _forward(kind, jfwd, jp, cfg, jnp.asarray(u[:, half:]),
                        carry(js1))
    ty2, ts2 = _forward(kind, tfwd, tp, tcfg, torch.from_numpy(u[:, half:]),
                        carry(ts1))
    assert _rel(ty2, jy2) <= TOL
    _state_close(ts2, js2)
    if kind != "mamba2":
        # the second half from the carried state is the whole sequence's
        # (Mamba2's forward restarts its conv from zeros: it is not)
        assert _rel(ty2, ty[:, half:]) <= TOL
        _state_close(ts2, ts)


def _decode_state(kind, p, cfg, u, tp, tcfg):
    """The state after the forward over ``u``, in the decode step's
    layout, for both packages (Mamba2 adds the conv state: the last three
    pre-activation xbc rows)."""
    jfwd, tfwd = JAX_FNS[kind][1], PORT_FNS[kind][0]
    _, js = _forward(kind, jfwd, p, cfg, jnp.asarray(u), None)
    _, ts = _forward(kind, tfwd, tp, tcfg, torch.from_numpy(u), None)
    if kind == "mamba2":
        js["conv"] = JS._split_proj(p, cfg, jnp.asarray(u))[1][:, -3:]
        ts["conv"] = TS._split_proj(tp, tcfg, torch.from_numpy(u))[1][:, -3:]
    return js, ts


@pytest.mark.parametrize("t", [16, 64])
def test_decode_continues_the_forward(block, t):
    """One decode step from the forward's state: output and new state
    against JAX's decode from that state, and the output against the
    port's forward over the longer sequence at position t."""
    kind, cfg, tcfg, jp, tp = block
    jdec, tdec = JAX_FNS[kind][2], PORT_FNS[kind][1]
    chunk = cfg.ssm.chunk_size
    longer = t + 1 if t + 1 <= chunk else -(-(t + 1) // chunk) * chunk
    u = _u(cfg, longer, seed=1)
    js, ts = _decode_state(kind, jp, cfg, u[:, :t], tp, tcfg)
    jy, jn = jdec(jp, cfg, jnp.asarray(u[:, t:t + 1]), js)
    ty, tn = tdec(tp, tcfg, torch.from_numpy(u[:, t:t + 1]), ts)
    assert ty.shape == (B, 1, cfg.d_model)
    assert _rel(ty, jy) <= TOL
    _state_close(tn, jn)
    full, _ = _forward(kind, PORT_FNS[kind][0], tp, tcfg,
                       torch.from_numpy(u), None)
    assert _rel(ty[:, 0], full[:, t]) <= TOL


def test_init_matches_the_reference_layout():
    """init_* of one layer and of a (2, 3) stack: the reference's shapes
    and dtypes, bf16 and f32, the four f32 leaves f32 in either; the
    states' shapes and dtypes; the reference's scales."""
    gen = torch.Generator().manual_seed(0)
    for kind in KINDS:
        init = {"mamba2": TS.init_mamba2, "mlstm": TS.init_mlstm,
                "slstm": TS.init_slstm}[kind]
        jinit = JAX_FNS[kind][0]
        for dtype in ("float32", "bfloat16"):
            cfg, tcfg = _cfgs(kind)
            cfg = dataclasses.replace(cfg, dtype=dtype)
            tcfg = dataclasses.replace(tcfg, dtype=dtype)
            ref = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), cfg))
            td = getattr(torch, dtype)
            for lead in ((), (2, 3)):
                got = init(gen, tcfg, lead, td, "cpu")
                assert sorted(got) == sorted(ref), kind
                for k, a in got.items():
                    assert tuple(a.shape) == lead + tuple(ref[k].shape), k
                    assert str(a.dtype).split(".")[-1] == str(ref[k].dtype)
            st = {"mamba2": TS.init_mamba2_state, "mlstm":
                  TS.init_mlstm_state, "slstm": TS.init_slstm_state}[kind](
                      tcfg, 2, "cpu")
            jst = jax.eval_shape(lambda: {
                "mamba2": JS.init_mamba2_state, "mlstm": JS.init_mlstm_state,
                "slstm": JS.init_slstm_state}[kind](cfg, 2))
            for a, r in zip(_leaves(st), _leaves(jst)):
                assert tuple(a.shape) == tuple(r.shape)
                assert str(a.dtype).split(".")[-1] == str(r.dtype)
                assert not a.any()
    cfg = _cfgs("mamba2")[1]
    p = TS.init_mamba2(gen, cfg, (4,), torch.float32, "cpu")
    d_inner, nh, _ = TS.mamba2_dims(cfg)
    assert torch.equal(p["a_log"][0], torch.log(torch.linspace(1., 16., nh)))
    assert abs(p["in_proj"].std().item() - cfg.d_model ** -0.5) < 3e-3
    assert abs(p["out_proj"].std().item() - 0.5 * d_inner ** -0.5) < 2e-3
    assert abs(p["conv"].std().item() - 0.1) < 5e-3
    cfg = _cfgs("slstm")[1]
    p = TS.init_slstm(gen, cfg, (4,), torch.float32, "cpu")
    hp = cfg.d_model // cfg.num_heads
    assert abs(p["rh"].std().item() - hp ** -0.5) < 5e-3


@pytest.mark.parametrize("kind", ["mamba2", "mlstm"])
def test_ragged_sequence_refused(kind):
    """Past one chunk a sequence must be a multiple of it, in both
    packages (the reference's assert; nothing pads)."""
    cfg, tcfg = _cfgs(kind)
    init = {"mamba2": TS.init_mamba2, "mlstm": TS.init_mlstm}[kind]
    tp = init(torch.Generator().manual_seed(0), tcfg, (), torch.float32,
              "cpu")
    jp = JAX_FNS[kind][0](jax.random.PRNGKey(0), cfg)
    u = _u(cfg, 40)
    with pytest.raises(AssertionError):
        PORT_FNS[kind][0](tp, tcfg, torch.from_numpy(u))
    with pytest.raises(AssertionError):
        JAX_FNS[kind][1](jp, cfg, jnp.asarray(u))


def test_decay_masks_before_the_exp():
    """The upper triangle is -inf before the exp: the kernel is exactly 0
    there and the backward pass through a long chunk stays finite."""
    cfg, tcfg = _cfgs("mamba2")
    p = TS.init_mamba2(torch.Generator().manual_seed(0), tcfg, (),
                       torch.float32, "cpu")
    p["a_log"] = p["a_log"] + 4.0           # steep decay: large exponents
    u = torch.from_numpy(_u(cfg, 64)).requires_grad_()
    y, _ = TS.mamba2_forward(p, tcfg, u)
    y.square().sum().backward()
    assert torch.isfinite(u.grad).all()
    cum = -torch.arange(4.0).reshape(1, 1, 4, 1) * 50
    dec = TS._decay(cum)[0, 0, :, :, 0]
    assert torch.equal(dec, torch.tril(dec)) and dec.diagonal().eq(1).all()
