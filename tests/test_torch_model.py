"""The port's model steps (repro_torch.models) against the JAX package's
``repro.models.model`` on the same parameters (carried across through
numpy by ``repro_torch.params.from_jax_numpy``) and the same inputs.

Tolerance: f32 on both sides, with matmuls summed in another order by
XLA and PyTorch, so logits agree to ~1e-6 of their scale; the tests
allow 1e-5 relative to max |logit| and require equal argmax. Caches
are compared the same way; rows the step must not touch are compared
bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduced_f32
from repro.models import model as M
from repro_torch import params as P
from repro_torch.configs.base import get_config
from repro_torch.models import layers as TL
from repro_torch.models import model as TM


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one intra-op
    thread per worker keeps these small-shape tests from oversubscribing
    the cores the other workers' tests time themselves on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-5
B, S, BS = 3, 64, 16


def port_cfg(**overrides):
    return dataclasses.replace(get_config("minitron-8b").reduced(),
                               dtype="float32", **overrides)


@pytest.fixture(scope="module", params=[{}, {"num_kv_heads": 2}],
                ids=["qpk1", "qpk2"])
def models(request):
    """(jax cfg, jax params, port cfg, port params) for reduced
    minitron-8b: as reduced (4 kv heads, q_per_kv 1) and with 2 kv heads
    (q_per_kv 2)."""
    cfg = reduced_f32("minitron-8b", **request.param)
    jp = M.init_params(cfg, jax.random.PRNGKey(0))
    tp = P.from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, port_cfg(**request.param), tp


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() <= TOL * max(1.0, np.abs(ref).max())


def _dense_caches(cfg, tcfg, seed=0):
    """A JAX cache and the port's holding the same random KV rows."""
    rng = np.random.default_rng(seed)
    jc = M.init_cache(cfg, B, S)
    shape = jc["kv"]["k"].shape
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    tc = TM.init_cache(tcfg, B, S, device="cpu")
    tc["kv"]["k"][:, :B] = torch.from_numpy(k)
    tc["kv"]["v"][:, :B] = torch.from_numpy(v)
    return {"kv": {"k": jnp.asarray(k), "v": jnp.asarray(v)}}, tc


def _paged_caches(cfg, tcfg, num_blocks=12, seed=0):
    rng = np.random.default_rng(seed)
    jc = M.init_paged_cache(cfg, num_blocks, BS)
    shape = jc["kv"]["k"].shape
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    tc = TM.init_paged_cache(tcfg, num_blocks, BS, device="cpu")
    tc["kv"]["k"][:, :num_blocks] = torch.from_numpy(k)
    tc["kv"]["v"][:, :num_blocks] = torch.from_numpy(v)
    return {"kv": {"k": jnp.asarray(k), "v": jnp.asarray(v)}}, tc


# block tables: rows own disjoint blocks; entries past each row's length
# are stale (0, or past the pool) as in the engine
TABLES = np.array([[4, 1, 7, 0], [2, 9, 11, 99], [5, 3, 8, 6]], np.int32)


def _cmp_cache(jc, tc, n):
    for leaf in ("k", "v"):
        assert _close(tc["kv"][leaf][:, :n].numpy(), jc["kv"][leaf])


def _tok(rng, shape):
    return rng.integers(1, 1000, shape).astype(np.int32)


@pytest.mark.parametrize("impl", [("xla", "torch"), ("pallas", "kernel")],
                         ids=["xla-torch", "pallas-kernel"])
def test_decode_step_matches_jax(models, impl):
    cfg, jp, tcfg, tp = models
    jc, tc = _dense_caches(cfg, tcfg)
    rng = np.random.default_rng(1)
    tok = _tok(rng, (B, 1))
    pos = np.array([5, 63, 20], np.int32)
    active = np.array([True, True, False])
    row2 = tc["kv"]["k"][:, 2].clone()
    jl, jc = M.decode_step(jp, cfg, jnp.asarray(tok), jc, jnp.asarray(pos),
                           decode_impl=impl[0], active=jnp.asarray(active))
    tl, tc = TM.decode_step(tp, tcfg, torch.tensor(tok), tc,
                            torch.tensor(pos), decode_impl=impl[1],
                            active=torch.tensor(active))
    assert _close(tl[:2], np.asarray(jl)[:2])
    assert (tl[:2].argmax(-1).numpy() == np.asarray(jl)[:2].argmax(-1)).all()
    _cmp_cache(jc, tc, B)
    assert torch.equal(tc["kv"]["k"][:, 2], row2)   # inactive: untouched


@pytest.mark.parametrize("impl", [("xla", "torch"), ("pallas", "kernel")],
                         ids=["xla-torch", "pallas-kernel"])
def test_paged_decode_step_matches_jax(models, impl):
    cfg, jp, tcfg, tp = models
    jc, tc = _paged_caches(cfg, tcfg)
    rng = np.random.default_rng(2)
    tok = _tok(rng, (B, 1))
    pos = np.array([17, 40, 3], np.int32)
    active = np.array([True, False, True])
    jl, jc = M.paged_decode_step(jp, cfg, jnp.asarray(tok), jc,
                                 jnp.asarray(TABLES), jnp.asarray(pos),
                                 decode_impl=impl[0],
                                 active=jnp.asarray(active))
    tl, tc = TM.paged_decode_step(tp, tcfg, torch.tensor(tok), tc,
                                  torch.tensor(TABLES), torch.tensor(pos),
                                  decode_impl=impl[1],
                                  active=torch.tensor(active))
    live = [0, 2]
    assert _close(tl[live], np.asarray(jl)[live])
    assert (tl[live].argmax(-1).numpy()
            == np.asarray(jl)[live].argmax(-1)).all()
    _cmp_cache(jc, tc, 12)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_prefill_chunk_matches_jax(models, paged):
    cfg, jp, tcfg, tp = models
    rng = np.random.default_rng(3)
    toks = _tok(rng, (B, 16))
    start = np.array([0, 16, 5], np.int32)
    lengths = np.array([16, 9, 0], np.int32)     # row 2 idle
    if paged:
        jc, tc = _paged_caches(cfg, tcfg)
        jl, jc = M.paged_prefill_chunk(jp, cfg, jnp.asarray(toks), jc,
                                       jnp.asarray(TABLES), start, lengths)
        tl, tc = TM.paged_prefill_chunk(tp, tcfg, torch.tensor(toks), tc,
                                        torch.tensor(TABLES),
                                        torch.tensor(start),
                                        torch.tensor(lengths))
        _cmp_cache(jc, tc, 12)
    else:
        jc, tc = _dense_caches(cfg, tcfg)
        row2 = tc["kv"]["v"][:, 2].clone()
        jl, jc = M.prefill_chunk(jp, cfg, jnp.asarray(toks), jc, start,
                                 lengths)
        tl, tc = TM.prefill_chunk(tp, tcfg, torch.tensor(toks), tc,
                                  torch.tensor(start), torch.tensor(lengths))
        _cmp_cache(jc, tc, B)
        assert torch.equal(tc["kv"]["v"][:, 2], row2)
    assert _close(tl[:2], np.asarray(jl)[:2])
    assert (tl[:2].argmax(-1).numpy() == np.asarray(jl)[:2].argmax(-1)).all()


def test_prefill_chunk_overhang_near_capacity(models):
    """The last chunk of a near-capacity prompt overhangs S (start + L >
    S): the JAX package clamps the window and rolls the chunk, and the
    port must land every valid token at its absolute position too."""
    cfg, jp, tcfg, tp = models
    jc, tc = _dense_caches(cfg, tcfg, seed=4)
    rng = np.random.default_rng(4)
    toks = _tok(rng, (B, 16))
    start = np.array([56, 60, 0], np.int32)      # 56 + 16 > 64
    lengths = np.array([8, 4, 16], np.int32)     # rows 0/1 end at S
    jl, jc = M.prefill_chunk(jp, cfg, jnp.asarray(toks), jc, start, lengths)
    tl, tc = TM.prefill_chunk(tp, tcfg, torch.tensor(toks), tc,
                              torch.tensor(start), torch.tensor(lengths))
    _cmp_cache(jc, tc, B)
    assert _close(tl, np.asarray(jl))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_mixed_step_matches_jax(models, paged):
    cfg, jp, tcfg, tp = models
    rng = np.random.default_rng(5)
    toks = _tok(rng, (B, 8))
    pos = np.array([8, 30, 12], np.int32)
    lengths = np.array([8, 0, 0], np.int32)      # row 0 prefills
    dtok = _tok(rng, (B, 1))
    dact = np.array([False, True, True])         # rows 1, 2 decode
    if paged:
        jc, tc = _paged_caches(cfg, tcfg)
        jl, jc = M.paged_mixed_step(jp, cfg, jnp.asarray(toks), jc,
                                    jnp.asarray(TABLES), pos, lengths,
                                    jnp.asarray(dtok), jnp.asarray(dact))
        tl, tc = TM.paged_mixed_step(tp, tcfg, torch.tensor(toks), tc,
                                     torch.tensor(TABLES), torch.tensor(pos),
                                     torch.tensor(lengths),
                                     torch.tensor(dtok), torch.tensor(dact))
        _cmp_cache(jc, tc, 12)
    else:
        jc, tc = _dense_caches(cfg, tcfg)
        jl, jc = M.mixed_step(jp, cfg, jnp.asarray(toks), jc, pos, lengths,
                              jnp.asarray(dtok), jnp.asarray(dact))
        tl, tc = TM.mixed_step(tp, tcfg, torch.tensor(toks), tc,
                               torch.tensor(pos), torch.tensor(lengths),
                               torch.tensor(dtok), torch.tensor(dact))
        _cmp_cache(jc, tc, B)
    assert _close(tl[1:], np.asarray(jl)[1:])
    assert (tl[1:].argmax(-1).numpy() == np.asarray(jl)[1:].argmax(-1)).all()


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_mixed_step_is_prefill_then_decode_bitwise(impl):
    """Within the port: the fused mixed step is exactly the two separate
    calls (same logits and cache bits)."""
    tcfg = port_cfg(num_kv_heads=2)
    tp = TM.init_params(tcfg, seed=3, device="cpu")
    rng = np.random.default_rng(6)
    toks = torch.tensor(_tok(rng, (B, 8)))
    pos = torch.tensor([0, 10, 3])
    lengths = torch.tensor([8, 0, 0])
    dtok = torch.tensor(_tok(rng, (B, 1)))
    dact = torch.tensor([False, True, True])
    c1 = TM.init_cache(tcfg, B, S, device="cpu")
    c1["kv"]["k"].normal_(generator=torch.Generator().manual_seed(0))
    c2 = {"kv": {k: v.clone() for k, v in c1["kv"].items()}}
    l1, c1 = TM.mixed_step(tp, tcfg, toks, c1, pos, lengths, dtok, dact,
                           decode_impl=impl)
    _, c2 = TM.prefill_chunk(tp, tcfg, toks, c2, pos, lengths)
    l2, c2 = TM.decode_step(tp, tcfg, dtok, c2, pos, decode_impl=impl,
                            active=dact)
    assert torch.equal(l1, l2)
    assert torch.equal(c1["kv"]["k"], c2["kv"]["k"])
    assert torch.equal(c1["kv"]["v"], c2["kv"]["v"])


def test_masked_writes_go_to_the_sink_only():
    """Masked rows and padding change no real cache entry: a dense masked
    row (inactive, or its slot past S) writes its own old bits back, and
    a paged masked entry lands in the sink block only."""
    tcfg = port_cfg(num_kv_heads=2)
    kv = TL.init_kv_cache(tcfg, 1, B, S, device="cpu")
    layer = {k: v[0] for k, v in kv.items()}
    assert layer["k"].shape[0] == B                 # no extra row
    layer["k"].normal_()
    before = layer["k"].clone()
    idx = TL.decode_index(tcfg, torch.tensor([3, 70, 5]), layer,
                          torch.tensor([True, True, False]))
    TL._scatter_slot(layer["k"], torch.ones(B, 2, 64), idx)
    changed = (layer["k"] != before).any(-1).any(-1)
    assert changed[0, 3] and changed.sum() == 1
    pages = TL.init_paged_kv_cache(tcfg, 1, 4, BS, device="cpu")["k"][0]
    pages.normal_()
    before = pages.clone()
    TL.paged_scatter_tokens(pages, torch.ones(3, 2, 64),
                            torch.tensor([17, 4 * BS, -1]))
    changed = (pages != before).any(-1).any(-1)
    assert changed[1, 1] and changed[:4].sum() == 1


def test_init_params_distributions():
    """The port's own init: shapes and scales of the JAX package's."""
    tcfg = port_cfg()
    p = TM.init_params(tcfg, seed=0, device="cpu")
    ref = jax.eval_shape(lambda: M.init_params(reduced_f32("minitron-8b"),
                                               jax.random.PRNGKey(0)))
    shapes = jax.tree.map(lambda a: tuple(a.shape), ref)
    assert jax.tree.map(lambda t: tuple(t.shape), p) == shapes
    d, f = tcfg.d_model, tcfg.d_ff
    assert abs(p["embed"].std().item() - 0.02) < 2e-3
    assert abs(p["layers"]["mlp"]["up"].std().item() - d ** -0.5) < 5e-3
    assert abs(p["layers"]["mlp"]["down"].std().item() - f ** -0.5) < 5e-3
    assert abs(p["layers"]["attn"]["wo"].std().item()
               - 0.5 * (tcfg.num_heads * 64) ** -0.5) < 5e-3
    assert torch.equal(p["final_ln"], torch.ones(d))
    q = TM.init_params(tcfg, seed=0, device="cpu")
    assert torch.equal(p["layers"]["attn"]["wq"], q["layers"]["attn"]["wq"])


@pytest.mark.parametrize("change", [
    {"family": "moe"}, {"attention_window": 16}, {"kv_cache_dtype": "int8"}],
    ids=["moe", "window", "int8"])
def test_unsupported_configs_raise(change):
    """A later slice's config raises where the port does not run it: the
    other families and windows everywhere, the int8 cache on the paged
    path (the dense cache takes it: tests/test_torch_forward.py)."""
    with pytest.raises(NotImplementedError, match="later slice"):
        TM.init_paged_cache(port_cfg(**change), 4, 16, device="cpu")
    if "kv_cache_dtype" not in change:
        with pytest.raises(NotImplementedError, match="later slice"):
            TM.init_cache(port_cfg(**change), 1, 16, device="cpu")
