"""The VLM family in bf16 against the JAX package in bf16: the same
weights (JAX's ``init_params`` in bf16 with the cross gates set to
0.5 / -0.7, carried across with ``params.from_jax_numpy(dtype=
torch.bfloat16)``), the same random frontend (normal x 0.02, rounded to
bf16) and the same seed-made tokens, on reduced llama-3.2-vision-11b.

The f32 tests (test_torch_vlm.py) cannot see where a bf16 cast sits;
these can. Each compares the port's bf16 run with JAX's bf16 run, and
both with JAX's f32 run on the same weights upcast (the "f32 truth"):

* ``_cross_block`` of group 0 on a random (B, 12, D) stream: within
  BLOCK_ULPS bf16 ulps (2^-8) of the reference's max|.|, and the port's
  rms distance from the f32 truth at most RMS_SPREAD x JAX's;
* the models (2 layers: one group; 4 layers with 2 KV heads: two
  groups; 10 layers: five groups): ``forward``'s logits over 3 x 72
  tokens, and ``prefill`` of 64 then 7 ``decode_step``s (the torch
  path, the reference's XLA rounding) fed the next tokens, within
  MODEL_TOL of max|logit| of JAX's; the port's distance from the f32
  truth, and its decode's distance from its own bf16 teacher-forced
  forward, each at most SPREAD x JAX's.

Readings (CPU, these inputs; tests/vlm_bf16_drift.py prints them). The
block: port vs JAX 0.955 bf16 ulps (the two libraries round a bf16
product's sum differently by up to an ulp); rms ratio 0.959-0.964. The
models: port vs JAX bf16 0.012-0.033 of max|logit|; the port's distance
from the f32 truth over JAX's 0.948-1.055; the port's decode equals its
own bf16 forward (0), JAX's sits 0.009-0.021 from its own. At reduced
widths with the published structure (a cross layer after every 5) the
two stay together down to 40 layers: from the truth, forward 0.098 vs
JAX's 0.088, decode 0.063 vs 0.080. Hence BLOCK_ULPS = 2,
MODEL_TOL = 0.05 and both spreads 1.25 (as in test_torch_ssm_bf16.py).
Planted in a copy: the decode's K/V rounded through fp8 e4m3 reads
port vs JAX 0.093-0.113 and 3.4-3.7x JAX's distance from the truth
(caught); the RoPE or the RMSNorm's mean square computed in bf16 moves
port vs JAX to 0.019-0.053 with no more distance from the truth (at
most 1.04x JAX's): one more bf16 rounding, which these figures cannot
tell from the libraries' own. JAX runs eagerly here, rounding each op
to bf16 as PyTorch does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.models import model as M
from repro_torch import params as P
from repro_torch.configs.base import get_config
from repro_torch.models import model as TM
from repro_torch.training import tree

from jax_compile_cache import jax_compile_cache  # noqa: F401
from test_torch_ssm_bf16 import _np, _rel, _rms_ratio, _ulps, vs_forward
from test_torch_vlm import GATES, set_gates

ARCH = "llama-3.2-vision-11b"
BLOCK_ULPS = 2
MODEL_TOL = 0.05
RMS_SPREAD = 1.25
SPREAD = 1.25
B = 3
PROMPT, NEW = 64, 8
VARIANTS = {"one-group": {}, "two-groups": {"num_layers": 4,
                                            "num_kv_heads": 2},
            "five-groups": {"num_layers": 10}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one intra-op
    thread per worker keeps these small-shape tests from oversubscribing
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def weights(**kw):
    """(jax bf16 cfg, jax f32 cfg, port cfg, jax bf16 params, jax f32
    params (the bf16 ones upcast), port bf16 params) of reduced
    llama-3.2-vision-11b with ``kw`` replaced and the gates set."""
    cfg = dataclasses.replace(jax_config(ARCH).reduced(), **kw)
    assert cfg.dtype == "bfloat16"
    jp = set_gates(M.init_params(cfg, jax.random.PRNGKey(0)), GATES)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tp = P.from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                          dtype=torch.bfloat16)
    return (cfg, dataclasses.replace(cfg, dtype="float32"),
            dataclasses.replace(get_config(ARCH).reduced(), **kw), jp, jp32,
            tp)


def _bf16(x):
    """(jax bf16, jax f32, port bf16) views of f32 numpy ``x`` rounded to
    bf16."""
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    return xb, xb.astype(jnp.float32), torch.from_numpy(
        np.array(_np(xb))).to(torch.bfloat16)


def frontend(cfg, b, seed=2):
    return _bf16((np.random.default_rng(seed).standard_normal(
        (b, cfg.frontend_tokens, cfg.d_model)) * 0.02).astype(np.float32))


def block_readings(w) -> dict:
    """``_cross_block`` of group 0 in bf16, port against JAX in bf16 ulps
    of JAX's max, and the port's rms distance from JAX's f32 run over
    JAX's bf16 run's."""
    cfg, cfg32, tcfg, jp, jp32, tp = w
    x = np.random.default_rng(3).standard_normal(
        (B, 12, cfg.d_model)).astype(np.float32)
    xb, x32, xt = _bf16(x)
    fb, f32, ft = frontend(cfg, B, seed=4)
    first = (lambda t: t[0])
    want = M._cross_block(jax.tree.map(first, jp["cross"]), cfg, xb, fb)
    truth = M._cross_block(jax.tree.map(first, jp32["cross"]), cfg32, x32,
                           f32)
    with torch.no_grad():
        got = TM._cross_block(tree.map(first, tp["cross"]), tcfg, xt, ft)
    assert got.dtype == torch.bfloat16
    return {"block ulps": _ulps(got, want),
            "block rms ratio": _rms_ratio(got, want, truth)}


def model_runs(w, prompt=PROMPT, new=NEW, batch=B):
    """The logits of ``forward`` over prompt + new tokens and of
    ``prefill`` of ``prompt`` then new - 1 ``decode_step``s fed the next
    tokens (B, new, V), on one random frontend, in bf16 (JAX and the
    port) and in f32 (JAX, the weights upcast). Returns {"jax" | "f32" |
    "port": (forward, decode)}."""
    cfg, cfg32, tcfg, jp, jp32, tp = w
    n = prompt + new
    toks = np.random.default_rng(1).integers(
        1, cfg.vocab_size, (batch, n)).astype(np.int32)
    fb, f32, ft = frontend(cfg, batch)

    def jax_runs(p, c, fe):
        fwd = _np(M.forward(p, c, {"tokens": jnp.asarray(toks),
                                   "frontend": fe})[0])
        lg, cache = M.prefill(p, c, {"tokens": jnp.asarray(toks[:, :prompt]),
                                     "frontend": fe, "cache_len": n})
        out = [_np(lg)]
        for t in range(prompt, n - 1):
            lg, cache = M.decode_step(p, c, jnp.asarray(toks[:, t:t + 1]),
                                      cache, t)
            out.append(_np(lg))
        return fwd, np.stack(out, 1)

    with torch.no_grad():
        tf = _np(TM.forward(tp, tcfg, {"tokens": torch.from_numpy(toks),
                                       "frontend": ft})[0])
        lg, cache = TM.prefill(tp, tcfg, {
            "tokens": torch.from_numpy(toks[:, :prompt]), "frontend": ft,
            "cache_len": n})
        out = [_np(lg)]
        for t in range(prompt, n - 1):
            lg, cache = TM.decode_step(
                tp, tcfg, torch.from_numpy(toks[:, t:t + 1]), cache, t,
                decode_impl="torch")
            out.append(_np(lg))
    return {"jax": jax_runs(jp, cfg, fb), "f32": jax_runs(jp32, cfg32, f32),
            "port": (tf, np.stack(out, 1))}


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
    w = weights(**VARIANTS[request.param])
    runs = model_runs(w)
    for tf, td in runs.values():
        assert np.isfinite(tf).all() and np.isfinite(td).all()
    return dict(block_readings(w), **model_readings(runs))


def test_bf16_cross_block_matches_jax(readings):
    """``_cross_block`` in bf16 within BLOCK_ULPS of JAX's; its rms
    distance from the f32 truth at most RMS_SPREAD x JAX's."""
    assert readings["block ulps"] <= BLOCK_ULPS
    assert readings["block rms ratio"] <= RMS_SPREAD


def test_bf16_forward_matches_jax(readings):
    """forward's bf16 logits within MODEL_TOL of JAX's bf16 ones, and no
    farther from the f32 truth than SPREAD x JAX's."""
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
