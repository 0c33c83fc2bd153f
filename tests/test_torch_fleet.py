"""The port's control plane and fleet runtime against the JAX package's.

* The pure-Python modules the port copies (configs, core, tokenizer) are
  held to their originals: byte-equal but for the package name in the
  imports, and equal in behaviour (plans, routing decisions, compressed
  text, token ids) on the same inputs.
* ``FleetRuntime.from_plan`` on reduced minitron-8b (f32) routes every
  request to the same pool, with the same C&R decision, and emits the
  same tokens as the JAX runtime.
* Importing every module of the port, and chip_smoke.py, leaves JAX and
  the JAX package out of ``sys.modules``.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from conftest import reduced_f32
from repro.configs.base import get_config as jax_get_config
from repro.core import compression as JC
from repro.core import planner as JP
from repro.core import router as JR
from repro.core import workload as JW
from repro.models import model as M
from repro.serving import config as JSC
from repro.serving import pools as JPools
from repro.serving import tokenizer as JT
from repro_torch import params as P
from repro_torch.configs.base import get_config
from repro_torch.core import compression as TC
from repro_torch.core import planner as TP
from repro_torch.core import router as TR
from repro_torch.core import workload as TW
from repro_torch.serving import config as TSC
from repro_torch.serving import pools as TPools
from repro_torch.serving import tokenizer as TT

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the gateway phase's prompt builders)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one intra-op
    thread per worker keeps these small-shape tests from oversubscribing
    the cores the other workers' tests time themselves on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"

VERBATIM = ["configs/minitron_8b.py", "configs/llama3_70b.py",
            "configs/nemotron_4_15b.py", "configs/nemotron_4_340b.py",
            "configs/qwen1_5_32b.py",
            "core/naming.py", "core/workload.py", "core/queueing.py",
            "core/profiles.py", "core/planner.py", "core/compression.py",
            "core/router.py", "core/cost.py", "serving/tokenizer.py",
            "serving/draft.py", "sim/__init__.py", "sim/des.py",
            "core/empirical.py", "serving/metrics.py",
            "serving/replanner.py", "serving/server.py", "training/data.py"]


# comments a copy words otherwise: the port's files name no issue number
REWORDED = {"serving/server.py": [(" (ISSUE 10)\n", "\n")]}


@pytest.mark.parametrize("rel", VERBATIM)
def test_copied_module_matches_original(rel):
    """A copy differs from its original only in the package it imports
    from (and the comments in REWORDED), so a fix to one that misses the
    other fails here."""
    orig = (SRC / "repro" / rel).read_text()
    copy = (SRC / "repro_torch" / rel).read_text()
    for old, new in REWORDED.get(rel, []):
        assert orig.count(old) == 1, (rel, old)
        orig = orig.replace(old, new)
    assert copy == orig.replace("from repro.", "from repro_torch.")


def test_config_copies_match():
    for name in ("minitron-8b", "llama3-70b", "nemotron-4-15b",
                 "nemotron-4-340b", "qwen1.5-32b"):
        a, b = jax_get_config(name), get_config(name)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert dataclasses.asdict(a.reduced()) == \
            dataclasses.asdict(b.reduced())
        assert a.num_params() == b.num_params()
        assert a.kv_bytes_per_token() == b.kv_bytes_per_token()


def test_serving_config_keeps_every_field():
    """Every knob of the JAX ServingConfig exists in the port's with the
    same default, except decode_impl, whose values are the port's
    ("kernel" | "torch")."""
    ja, to = JSC.ServingConfig(), TSC.ServingConfig()
    assert JSC.field_names() == TSC.field_names()
    for f in JSC.field_names() - {"decode_impl"}:
        assert getattr(ja, f) == getattr(to, f), f
    assert to.replace(kv_block_size=32).block_size == 32


@pytest.mark.parametrize("workload,k", [("azure", 2), ("azure", 3),
                                        ("lmsys", 2)])
def test_planner_copy_gives_the_same_plan(workload, k):
    a = JP.plan_k_pool(JW.get_workload(workload), lam=1000.0, t_slo=0.5,
                       k=k)
    b = TP.plan_k_pool(TW.get_workload(workload), lam=1000.0, t_slo=0.5,
                       k=k)
    assert repr(a) == repr(b).replace("repro_torch.", "repro.")
    assert a.summary() == b.summary()


def _prompt(n_words, topic):
    return " ".join(f"{topic} fact {i}: fleets split by context length."
                    for i in range(n_words))


def test_router_and_compressor_copies_decide_alike():
    kw = dict(boundaries=(512, 2048), gammas=(1.5, 2.0))
    ja = JR.GatewayRouter(compressor=JC.ExtractiveCompressor(), **kw)
    to = TR.GatewayRouter(compressor=TC.ExtractiveCompressor(), **kw)
    for i, (words, cat) in enumerate([(20, "prose"), (60, "rag"),
                                      (70, "rag"), (200, "code"),
                                      (260, "rag"), (400, "prose")]):
        text = _prompt(words, f"t{i}")
        n = max(1, len(text.encode()) // 4)
        mk = dict(l_total=n + 32, l_in=n, l_out=32, category=cat,
                  prompt_bytes=len(text.encode()))
        da = ja.route(JW.Request(**mk), prompt_text=text)
        db = to.route(TW.Request(**mk), prompt_text=text)
        fa, fb = dataclasses.asdict(da), dataclasses.asdict(db)
        fa.pop("compression_ms"), fb.pop("compression_ms")
        assert fa == fb
    assert dataclasses.asdict(ja.stats)["per_pool"] == \
        dataclasses.asdict(to.stats)["per_pool"]
    text = _prompt(80, "compress")
    ra = JC.ExtractiveCompressor().compress(text, 300)
    rb = TC.ExtractiveCompressor().compress(text, 300)
    assert ra.text == rb.text and ra.kept_indices == rb.kept_indices
    assert JT.ByteChunkTokenizer(1024).encode(text) == \
        TT.ByteChunkTokenizer(1024).encode(text)


@pytest.fixture(scope="module")
def reduced_models():
    """Reduced minitron-8b in f32: the JAX parameters and the port's copy
    of them."""
    cfg = reduced_f32("minitron-8b")
    jp = M.init_params(cfg, jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_config("minitron-8b").reduced(),
                               dtype="float32")
    tp = P.from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tcfg, tp


def _azure_plans():
    """The same K=2 azure plan from both packages, and the context scale
    that puts the long pool at 512 tokens (B = 64, gamma 2)."""
    plan_j = JP.plan_k_pool(JW.get_workload("azure"), lam=1000.0, t_slo=0.5,
                            k=2)
    plan_t = TP.plan_k_pool(TW.get_workload("azure"), lam=1000.0, t_slo=0.5,
                            k=2)
    return plan_j, plan_t, 512 / plan_j.pools[-1].c_max


def test_fleet_runtime_matches_jax(reduced_models):
    """from_plan on reduced minitron-8b: the port's dense fleet routes
    every request to the JAX runtime's pool with its C&R decision and
    emits its tokens (xla <-> torch decode); the port's paged fleet emits
    the same tokens again."""
    cfg, jp, tcfg, tp = reduced_models
    kw = dict(slots_per_pool=2, c_chunk=16, decode_k=4, eos_id=None)
    plan_j, plan_t, scale = _azure_plans()
    reqs = [(0, _prompt(3, "short"), 8, "prose"),
            (1, _prompt(9, "border"), 8, "rag"),
            (2, _prompt(30, "long"), 8, "prose"),
            (3, _prompt(6, "mid"), 5, "code")]

    def serve(rt, request_cls):
        decisions = [rt.submit(request_cls(rid, text, n, category=cat))
                     for rid, text, n, cat in reqs]
        out = rt.run(max_iters=2000)
        assert sorted(out) == [0, 1, 2, 3]
        assert not any(r.timed_out for r in out.values())
        return ([(d.pool, d.compressed, d.l_total_effective)
                 for d in decisions],
                {rid: (r.pool, r.compressed, r.output_tokens)
                 for rid, r in out.items()})

    rj = JPools.FleetRuntime.from_plan(cfg, jp, plan_j, ctx_scale=scale,
                                       decode_impl="xla", **kw)
    ref = serve(rj, JPools.GatewayRequest)
    for paged in (False, True):
        rt = TPools.FleetRuntime.from_plan(tcfg, tp, plan_t, ctx_scale=scale,
                                           decode_impl="torch", paged=paged,
                                           **kw)
        assert rt.router.boundaries == rj.router.boundaries
        assert serve(rt, TPools.GatewayRequest) == ref, f"paged={paged}"
        assert rt.router.stats.per_pool == rj.router.stats.per_pool


def test_from_plan_records_scale_and_plan_gpus(reduced_models):
    """from_plan keeps what the re-planner reads off a runtime: the
    context scale the boundaries were shrunk by and the plan's per-pool
    GPU counts, equal to the JAX runtime's on the same plan."""
    cfg, jp, tcfg, tp = reduced_models
    plan_j, plan_t, scale = _azure_plans()
    kw = dict(slots_per_pool=2, c_chunk=16, ctx_scale=scale)
    rj = JPools.FleetRuntime.from_plan(cfg, jp, plan_j, **kw)
    rt = TPools.FleetRuntime.from_plan(tcfg, tp, plan_t, **kw)
    assert rt.ctx_scale == rj.ctx_scale == scale
    assert rt.plan_pool_gpus == rj.plan_pool_gpus
    assert rt.plan_pool_gpus == [pp.n_gpus for pp in plan_t.pools]
    bare = TPools.FleetRuntime(tcfg, tp, (64,), (1.5,), (1, 1), (64, 128))
    assert (bare.ctx_scale, bare.plan_pool_gpus) == (1.0, None)


def test_in_band_request_compresses_like_jax(reduced_models):
    """One in-band borderline request (B < L_total <= gamma * B, rag)
    through both runtimes: the same C&R decision, compressed text and
    tokens. The JAX runtime's compressor is swapped for one scoring with
    its Pallas TextRank, so both sides score in f32 (the port's runtime
    scores with the plain version on the CPU, and launches no kernel)."""
    from repro.kernels import ops as jax_ops
    from repro_torch.kernels import textrank as TRK
    cfg, jp, tcfg, tp = reduced_models
    plan_j, plan_t, scale = _azure_plans()
    kw = dict(slots_per_pool=2, c_chunk=16, decode_k=4, eos_id=None,
              ctx_scale=scale)
    rj = JPools.FleetRuntime.from_plan(cfg, jp, plan_j, decode_impl="xla",
                                       **kw)
    rj.router.compressor = JC.ExtractiveCompressor(
        textrank_fn=jax_ops.textrank_scores)
    rt = TPools.FleetRuntime.from_plan(tcfg, tp, plan_t, decode_impl="torch",
                                       paged=True, prefix_cache=True, **kw)
    b, gamma = rt.router.boundaries[0], rt.router.gammas[0]
    text = chip_smoke.varied_prompt(np.random.default_rng(3), 100,
                                    rt.tokenizer, words=(3, 6))
    assert b < rt.tokenizer.count(text) + 8 <= gamma * b
    launches = TRK.KERNEL.launches
    out = {}
    for rt_, req_cls in ((rj, JPools.GatewayRequest),
                         (rt, TPools.GatewayRequest)):
        d = dataclasses.asdict(rt_.submit(req_cls(0, text, 8,
                                                  category="rag")))
        d.pop("compression_ms")
        res = rt_.run(max_iters=2000)[0]
        out[rt_ is rt] = (d, res.pool, res.output_tokens)
    assert out[True] == out[False]
    d = out[True][0]
    assert d["compressed"] and d["pool"] == "short"
    assert d["l_total_effective"] <= b        # Eq. 15
    assert TRK.KERNEL.launches == launches


def test_fleet_rejects_later_slice_knobs():
    tcfg = dataclasses.replace(get_config("minitron-8b").reduced(),
                               dtype="float32")
    with pytest.raises(NotImplementedError,
                       match="not ported.*sharded-serving slice"):
        TPools.FleetRuntime(tcfg, {}, (64,), (1.5,), (1, 1), (64, 128),
                            tp_degree=2, mesh=object())


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import without JAX
    or the JAX package entering sys.modules."""
    mods = sorted(".".join(p.relative_to(SRC).with_suffix("").parts)
                  for p in (SRC / "repro_torch").rglob("*.py"))
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{str(SRC)!r}, {str(ROOT)!r}]\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stderr + out.stdout
    assert "repro_torch.launch.serve" in mods and len(mods) >= 20
    assert {"repro_torch.sim", "repro_torch.sim.des",
            "repro_torch.serving.draft", "repro_torch.core.cost",
            "repro_torch.configs.qwen1_5_32b", "repro_torch.core.empirical",
            "repro_torch.serving.metrics", "repro_torch.serving.replanner",
            "repro_torch.serving.server", "repro_torch.launch.train",
            "repro_torch.training.optimizer", "repro_torch.training.data",
            "repro_torch.training.train_step", "repro_torch.training.tree",
            "repro_torch.training.checkpoint"} <= set(mods)
