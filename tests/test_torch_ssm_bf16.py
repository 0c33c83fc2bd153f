"""The recurrent families in bf16 against the JAX package in bf16: the
same weights (JAX's ``init_*`` / ``init_params`` in bf16, carried across
with ``params.from_jax_numpy(dtype=torch.bfloat16)``, which keeps the
f32 leaves f32) and the same seed-made inputs, at the reduced widths.

The f32 tests (test_torch_ssm.py, test_torch_ssm_model.py) cannot see
where a bf16 cast sits; these can. Each compares the port's bf16 run
with JAX's bf16 run, and both with JAX's f32 run on the same weights
upcast (the "f32 truth"):

* the blocks (Mamba2, mLSTM, sLSTM) at T = 16 and 64: ``*_forward``'s
  output and final state, and ``*_decode`` from that state, within
  BLOCK_ULPS bf16 ulps (2^-8) of the reference's max|.|, and the port's
  rms distance from the f32 truth at most RMS_SPREAD x JAX's;
* the models (reduced xlstm-350m, zamba2-1.2b flat and stacked):
  ``forward``'s logits over 3 x 72 tokens, and ``prefill`` of 64 then 7
  ``decode_step``s fed the next tokens, within MODEL_TOL of max|logit|
  of JAX's; the port's distance from the f32 truth, and its decode's
  distance from its own bf16 teacher-forced forward (the measure
  chip_smoke's phase 14 gates), each at most SPREAD x JAX's.

Readings (CPU, these inputs; tests/ssm_bf16_drift.py prints them). The
blocks: port vs JAX at most 1.92 bf16 ulps; the rms ratio 0.81-1.10.
Computing the mLSTM gates in bf16 instead of f32 reads 1.54 (its state,
T = 64), so RMS_SPREAD = 1.25 catches such a misplaced cast; one that
rounds the same values at another point moves the figures by less than
an ulp. The models: port vs JAX bf16 up to 0.066 of max|logit| (xlstm
forward) and 0.043 (xlstm decode); from the f32 truth, forward, the port
0.027-0.127 and JAX 0.029-0.121 (at most 1.05 x JAX's); decode against
the f32 forward at most 1.15 x JAX's; decode against its own bf16
forward, the port 0.014-0.067 and JAX 0.017-0.047 (at most 1.42 x, for
xlstm). Hence BLOCK_ULPS = 3, MODEL_TOL = 0.1 and SPREAD = 2. JAX runs
eagerly here, rounding each op to bf16 as PyTorch does; under jit, XLA
may keep a fused chain of elementwise ops in f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_compile_cache import jax_compile_cache  # noqa: F401
from repro.configs.base import get_config as jax_config
from repro.models import model as M
from repro.models import ssm as JS
from repro_torch import params as P
from repro_torch.configs.base import get_config
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS

BF16_ULP = 2.0 ** -8
BLOCK_ULPS = 3
RMS_SPREAD = 1.25
MODEL_TOL = 0.1
SPREAD = 2.0
B = 3
ARCH = {"mamba2": "zamba2-1.2b", "mlstm": "xlstm-350m",
        "slstm": "xlstm-350m"}
JAX_FNS = {"mamba2": (JS.init_mamba2, JS.mamba2_forward, JS.mamba2_decode),
           "mlstm": (JS.init_mlstm, JS.mlstm_forward, JS.mlstm_decode),
           "slstm": (JS.init_slstm, JS.slstm_forward, JS.slstm_decode)}
PORT_FNS = {"mamba2": (TS.mamba2_forward, TS.mamba2_decode),
            "mlstm": (TS.mlstm_forward, TS.mlstm_decode),
            "slstm": (TS.slstm_forward, TS.slstm_decode)}
VARIANTS = {"xlstm": ("xlstm-350m", {}),
            "zamba2-flat": ("zamba2-1.2b", {}),
            "zamba2-stacked": ("zamba2-1.2b", {"num_layers": 4})}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one intra-op
    thread per worker keeps these small-shape tests from oversubscribing
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    """A tensor or JAX array of any float type as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, ref) -> float:
    """max|got - ref| / max|ref|."""
    got, ref = _np(got), _np(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _cfgs(name, reduced=True, **kw):
    """(jax bf16, jax f32, port bf16) configs, reduced or at the
    published widths, with ``kw`` replaced."""
    cfg, tcfg = jax_config(name), get_config(name)
    if reduced:
        cfg, tcfg = cfg.reduced(), tcfg.reduced()
    cfg = dataclasses.replace(cfg, **kw)
    assert cfg.dtype == "bfloat16"
    return (cfg, dataclasses.replace(cfg, dtype="float32"),
            dataclasses.replace(tcfg, **kw))


def _weights(jp):
    """(JAX's bf16 params upcast to f32, the port's bf16 params)."""
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jp32, P.from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                                  dtype=torch.bfloat16)


# ----------------------------------------------------------------- blocks
def make_block(kind):
    """(kind, jax bf16 cfg, jax f32 cfg, port cfg, jax bf16 params, jax
    f32 params, port params) of one layer."""
    cfg, cfg32, tcfg = _cfgs(ARCH[kind])
    jp = JAX_FNS[kind][0](jax.random.PRNGKey(5), cfg)
    return (kind, cfg, cfg32, tcfg, jp) + _weights(jp)


@pytest.fixture(scope="module", params=list(JAX_FNS))
def block(request):
    return make_block(request.param)


def _u(cfg, t, seed):
    """(B, t, D) seed-made input, rounded to bf16: (jax bf16, jax f32,
    port bf16) views of the same values."""
    u = np.random.default_rng(seed).standard_normal(
        (B, t, cfg.d_model)).astype(np.float32)
    ub = jnp.asarray(u).astype(jnp.bfloat16)
    return ub, ub.astype(jnp.float32), torch.from_numpy(
        np.array(_np(ub))).to(torch.bfloat16)


def _state(kind, out, fn_in, p, cfg, split):
    """A forward's (y, state) with the state in the decode step's layout
    (Mamba2 adds the conv state: the last three pre-activation xbc rows
    of the input ``fn_in``)."""
    y, st = out
    if kind == "mamba2":
        st = {"h": st, "conv": split(p, cfg, fn_in)[1][:, -3:]}
    return y, st


def _leaves(state):
    if isinstance(state, dict):
        return [state[k] for k in sorted(state)]
    return list(state)


def _ulps(got, ref) -> float:
    """max|got - ref| in bf16 ulps of max|ref|."""
    return _rel(got, ref) / BF16_ULP


def _rms_ratio(port, ref, truth) -> float:
    """The port's rms distance from the f32 truth over the reference's
    (0 where both are exact, inf where only the reference is)."""
    d_port, d_ref = (float(np.sqrt(np.mean((_np(x) - _np(truth)) ** 2)))
                     for x in (port, ref))
    if d_ref == 0.0:
        return 0.0 if d_port == 0.0 else float("inf")
    return d_port / d_ref


def block_readings(block, t) -> dict:
    """The figures the block test holds, by name: the bf16 forward over
    t tokens and one decode step from its state, port against JAX in bf16
    ulps of JAX's max, and the port's rms distance from JAX's f32 run over
    JAX's bf16 run's (outputs; the largest over the state leaves). The
    port keeps each state leaf in the reference's dtype."""
    kind, cfg, cfg32, tcfg, jp, jp32, tp = block
    (_, jfwd, jdec), (tfwd, tdec) = JAX_FNS[kind], PORT_FNS[kind]
    ub, u32, ut = _u(cfg, t + 1, seed=t)
    jy, js = _state(kind, jfwd(jp, cfg, ub[:, :t]), ub[:, :t], jp, cfg,
                    JS._split_proj)
    y32, s32 = _state(kind, jfwd(jp32, cfg32, u32[:, :t]), u32[:, :t], jp32,
                      cfg32, JS._split_proj)
    jy1, jn = jdec(jp, cfg, ub[:, t:], js)
    y1_32, n32 = jdec(jp32, cfg32, u32[:, t:], s32)
    with torch.no_grad():
        ty, ts = _state(kind, tfwd(tp, tcfg, ut[:, :t]), ut[:, :t], tp,
                        tcfg, TS._split_proj)
        ty1, tn = tdec(tp, tcfg, ut[:, t:], ts)
    assert ty.dtype == ty1.dtype == torch.bfloat16
    for got, ref in ((ts, js), (tn, jn)):
        assert [str(a.dtype).split(".")[-1] for a in _leaves(got)] == \
            [str(b.dtype) for b in _leaves(ref)]
    return {"forward ulps": _ulps(ty, jy),
            "state ulps": max(_ulps(a, b) for a, b in
                              zip(_leaves(ts), _leaves(js))),
            "decode ulps": _ulps(ty1, jy1),
            "new state ulps": max(_ulps(a, b) for a, b in
                                  zip(_leaves(tn), _leaves(jn))),
            "forward rms ratio": _rms_ratio(ty, jy, y32),
            "state rms ratio": max(_rms_ratio(a, b, c) for a, b, c in
                                   zip(_leaves(ts), _leaves(js),
                                       _leaves(s32))),
            "decode rms ratio": _rms_ratio(ty1, jy1, y1_32),
            "new state rms ratio": max(_rms_ratio(a, b, c) for a, b, c in
                                       zip(_leaves(tn), _leaves(jn),
                                           _leaves(n32)))}


@pytest.mark.parametrize("t", [16, 64])
def test_bf16_block_matches_jax(block, t):
    """The bf16 forward over t tokens and one decode step from its state,
    against JAX's bf16 run: outputs and states within BLOCK_ULPS bf16
    ulps of the reference's max; their rms distance from JAX's f32 run
    at most RMS_SPREAD x JAX's bf16 run's."""
    r = block_readings(block, t)
    for what in ("forward", "state", "decode", "new state"):
        assert r[f"{what} ulps"] <= BLOCK_ULPS, what
        assert r[f"{what} rms ratio"] <= RMS_SPREAD, what


# ----------------------------------------------------------------- models
PROMPT, NEW = 64, 8


def model_runs(name, prompt=PROMPT, new=NEW, batch=B, seed=0, **kw):
    """``name``'s logits in bf16 (JAX and the port) and in f32 (JAX, the
    same weights upcast), reduced unless ``kw`` says otherwise
    (``reduced=False``: the published widths), at JAX's ``init_params``
    of ``seed``: ``forward`` over prompt + new tokens padded to the chunk
    (the blocks are causal, so only the real positions are kept), and
    ``prefill`` of ``prompt`` then new - 1 ``decode_step``s fed the next
    tokens (B, new, V). Returns {"jax" | "f32" | "port": (forward,
    decode)}."""
    reduced = kw.pop("reduced", True)
    cfg, cfg32, tcfg = _cfgs(name, reduced, **kw)
    jp = M.init_params(cfg, jax.random.PRNGKey(seed))
    jp32, tp = _weights(jp)
    n = prompt + new
    toks = np.random.default_rng(1).integers(
        1, cfg.vocab_size, (batch, n)).astype(np.int32)
    seq = np.pad(toks, ((0, 0), (0, -n % cfg.ssm.chunk_size)),
                 constant_values=1)

    def jax_runs(p, c):
        fwd = _np(M.forward(p, c, {"tokens": jnp.asarray(seq)})[0])[:, :n]
        lg, cache = M.prefill(p, c, {"tokens": jnp.asarray(toks[:, :prompt]),
                                     "cache_len": n})
        out = [_np(lg)]
        for t in range(prompt, n - 1):
            lg, cache = M.decode_step(p, c, jnp.asarray(toks[:, t:t + 1]),
                                      cache, t)
            out.append(_np(lg))
        return fwd, np.stack(out, 1)

    with torch.no_grad():
        tf = _np(TM.forward(tp, tcfg, {"tokens": torch.from_numpy(seq)})[0]
                 )[:, :n]
        lg, cache = TM.prefill(tp, tcfg, {
            "tokens": torch.from_numpy(toks[:, :prompt]), "cache_len": n})
        out = [_np(lg)]
        for t in range(prompt, n - 1):
            lg, cache = TM.decode_step(
                tp, tcfg, torch.from_numpy(toks[:, t:t + 1]), cache, t,
                decode_impl="torch")
            out.append(_np(lg))
    return {"jax": jax_runs(jp, cfg), "f32": jax_runs(jp32, cfg32),
            "port": (tf, np.stack(out, 1))}


def vs_forward(dec, fwd) -> float:
    """Largest rel. distance of the decode logits (B, new, V) from the
    forward's (B, prompt + new, V) at the same positions."""
    first = fwd.shape[1] - dec.shape[1] - 1
    return max(_rel(dec[:, j], fwd[:, first + j])
               for j in range(dec.shape[1]))


def model_readings(runs) -> dict:
    """The figures the model tests hold, by name."""
    (tf, td), (jf, jd), (f32, _) = (runs[k] for k in ("port", "jax", "f32"))
    return {
        "forward port-jax": _rel(tf, jf),
        "forward port-f32": _rel(tf, f32), "forward jax-f32": _rel(jf, f32),
        "decode port-jax": max(_rel(td[:, j], jd[:, j])
                               for j in range(td.shape[1])),
        "decode-f32 forward port": vs_forward(td, f32),
        "decode-f32 forward jax": vs_forward(jd, f32),
        "decode-own forward port": vs_forward(td, tf),
        "decode-own forward jax": vs_forward(jd, jf)}


@pytest.fixture(scope="module", params=list(VARIANTS))
def readings(request):
    name, kw = VARIANTS[request.param]
    runs = model_runs(name, **kw)
    for tf, td in runs.values():
        assert np.isfinite(tf).all() and np.isfinite(td).all()
    return model_readings(runs)


def test_bf16_forward_matches_jax(readings):
    """forward's bf16 logits over 3 x 72 tokens within MODEL_TOL of JAX's
    bf16 ones, and no farther from the f32 truth than SPREAD x JAX's."""
    r = readings
    assert r["forward port-jax"] <= MODEL_TOL
    assert r["forward port-f32"] <= SPREAD * r["forward jax-f32"]


def test_bf16_decode_matches_jax(readings):
    """prefill's and each decode_step's bf16 logits within MODEL_TOL of
    JAX's; their distance from the f32 forward, and from their own bf16
    teacher-forced forward, at most SPREAD x JAX's."""
    r = readings
    assert r["decode port-jax"] <= MODEL_TOL
    assert r["decode-f32 forward port"] <= \
        SPREAD * r["decode-f32 forward jax"]
    assert r["decode-own forward port"] <= \
        SPREAD * r["decode-own forward jax"]
