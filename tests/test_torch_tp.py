"""Tensor-parallel serving on the CPU: four gloo ranks (one process each, a
file store under a temporary directory, no network, no card) against the
JAX package's 1-device engine and the port's own tp=1 runs.

The counterparts of the reference's sharded tests
(tests/test_decode_consistency.py: tp=4 tokens equal the 1-device
engine's, dense and paged, decode_k 1 and 4, the Pallas engine, the
prefix cache's warm admit, the per-device cache bytes;
tests/test_reprovision.py: re-provisioning a sharded pool mid-flight).
Reduced f32 minitron-8b with 8 query heads over 4 kv heads of 64 (each
rank serves one kv head and its two query heads), weights carried from the
JAX package's ``init_params``. One module-scoped spawn runs every
scenario (tests/torch_tp_ranks.py) while this process computes the
references; each test asserts on one scenario's result, rank 0's and
rank 3's alike. The port keeps its decode kernel on the ranks' local
heads, where the reference's sharded engine falls back to XLA: the
"kernel" engine's tokens are held to the reference's 1-device "pallas"
engine's.
"""
import concurrent.futures
import contextlib
import dataclasses
import io
import sys
import time

import jax
import numpy as np
import pytest
import torch

import torch_tp_ranks as R
from conftest import reduced_f32
from jax_compile_cache import jax_compile_cache  # noqa: F401
from repro.models import model as M
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.engine import ServeRequest as JaxRequest
from repro_torch import params as P
from repro_torch.configs.base import get_config
from repro_torch.distributed import context as PC
from repro_torch.distributed.context import ParallelContext
from repro_torch.launch import serve as TS
from repro_torch.launch.mesh import Mesh, make_smoke_mesh
from repro_torch.models import model as TM

sys.path.insert(0, str(__import__("pathlib").Path(__file__).parents[1]))
import chip_smoke  # noqa: E402  (the in-band prompt builder)

WORLD = 4
TIMEOUT_S = 120
BATCH_ARGV = ["--reduced", "--batch", "4", "--prompt-len", "16",
              "--new-tokens", "4", "--device", "cpu"]
FLEET_ARGV = ["--reduced", "--fleet", "2", "--decode-k", "4", "--paged",
              "--new-tokens", "6", "--device", "cpu"]


def _cfgs():
    """(JAX config, port config): reduced f32 minitron-8b, 8 / 4 heads of
    64."""
    kw = dict(num_heads=8, num_kv_heads=4, head_dim=64)
    return (reduced_f32("minitron-8b", **kw),
            dataclasses.replace(get_config("minitron-8b").reduced(),
                                dtype="float32", **kw))


def _stream(seed=42, n_req=4, max_new=8, l_in_max=40):
    rng = np.random.default_rng(seed)
    return [dict(rid=rid,
                 tokens=[int(t) for t in rng.integers(1, 900,
                                                      int(rng.integers(
                                                          3, l_in_max)))],
                 max_new_tokens=int(rng.integers(2, max_new)))
            for rid in range(n_req)]


def _jax_engine(cfg, params, reqs, **kw):
    eng = JaxEngine(cfg, params, eos_id=R.EOS, n_max=3, c_max=128,
                    c_chunk=16, **kw)
    for r in reqs:
        eng.submit(JaxRequest(**r))
    res = eng.run_to_completion(5000)
    return {rid: r.output_tokens for rid, r in sorted(res.items())}


def _jax_launcher_lines():
    """The JAX batch launcher at --mesh 1x1 (Auto mesh axes, as
    tests/test_torch_forward.py runs it): its stdout lines."""
    from jax.sharding import AxisType
    from repro.launch import serve as JS
    make_mesh = jax.make_mesh
    argv = [a for a in BATCH_ARGV if a not in ("--device", "cpu")]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "make_mesh", lambda shape, names, **kw: make_mesh(
            shape, names, axis_types=(AxisType.Auto,) * len(names)))
        mp.setattr(sys, "argv", ["serve"] + argv + ["--mesh", "1x1"])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            JS.main()
    return buf.getvalue().splitlines()


def _fleet_requests():
    """(rid, text, max_new, category): short, long and one in-band rag
    request (B < L_total <= gamma * B) the gateway compresses."""
    from repro_torch.serving.tokenizer import ByteChunkTokenizer
    tok = ByteChunkTokenizer(1024)
    text = chip_smoke.varied_prompt(np.random.default_rng(3), 70, tok,
                                    words=(3, 6))
    assert 64 < tok.count(text) + 8 <= 96
    return [(0, "short prompt for the short pool", 6, "prose"),
            (1, "a long prompt for the long pool " * 12, 8, "prose"),
            (2, text, 8, "rag")]


@pytest.fixture(scope="module")
def tp():
    """Spawns the ranks (in a thread) and computes the references here
    meanwhile. Returns (rank results, references, inputs)."""
    jcfg, tcfg = _cfgs()
    jp = jax.tree.map(np.asarray, M.init_params(jcfg, jax.random.PRNGKey(0)))
    lcfg = reduced_f32("minitron-8b")
    key = jax.random.PRNGKey(0)
    jp_launch = jax.tree.map(np.asarray, M.init_params(lcfg, key))
    launch_tokens = np.asarray(jax.random.randint(key, (4, 16), 1,
                                                  lcfg.vocab_size))
    inp = dict(cfg=tcfg, jp=jp, reqs=_stream(),
               prompt=[int(t) for t in
                       np.random.default_rng(5).integers(1, 900, 37)],
               fleet=_fleet_requests(), fleet_argv=FLEET_ARGV,
               batch_argv=BATCH_ARGV, jp_launch=jp_launch,
               launch_tokens=launch_tokens,
               fwd_tokens=np.random.default_rng(1).integers(
                   0, tcfg.vocab_size, (2, 16)))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(PC.launch_ranks, R.run_scenarios, WORLD, (inp,),
                            device="cpu", timeout_s=TIMEOUT_S, threads=1,
                            quiet=True)
        ref = _references(jcfg, tcfg, jp, inp)
        t1 = time.perf_counter()
        out = ranks.result()
    print(f"references {t1 - t0:.1f} s, ranks {time.perf_counter() - t0:.1f}"
          f" s: {out[0]['seconds']}")
    return out, ref, inp


def _references(jcfg, tcfg, jp, inp):
    """What the ranks are held to: the JAX 1-device engine ("xla" and
    "pallas"), JAX forward logits and launcher lines, and the port's tp=1
    engine, fleet and launcher runs."""
    ref = {"xla": _jax_engine(jcfg, jp, inp["reqs"], decode_impl="xla"),
           "pallas": _jax_engine(jcfg, jp, inp["reqs"],
                                 decode_impl="pallas")}
    lg, _ = M.forward(jax.tree.map(jax.numpy.asarray, jp), jcfg,
                      {"tokens": jax.numpy.asarray(inp["fwd_tokens"])})
    ref["logits"] = np.asarray(lg)
    ref["launcher"] = _jax_launcher_lines()
    full = P.from_jax_numpy(jp, device="cpu")
    ref["bytes"] = {}
    for paged in (False, True):
        kw = dict(block_size=16) if paged else {}
        toks, eng = R.run_engine(tcfg, full, inp["reqs"], paged=paged,
                                 decode_impl="torch", **kw)
        ref["bytes"][paged] = eng.cache_bytes_per_device()
        ref[("port", paged)] = toks
    ref["prefix"] = R.prefix_warm(tcfg, full, inp["prompt"])
    ref["spec"] = R.run_engine(tcfg, full, inp["reqs"], spec_k=4,
                               decode_k=2)[0]
    ref["fleet"] = R.fleet(tcfg, full, inp["fleet"])[:3]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, res, _ = TS.serve_fleet(TS.parse_args(FLEET_ARGV))
    ref["serve_fleet"] = (buf.getvalue().splitlines(),
                          {rid: r.output_tokens for rid, r in res.items()})
    return ref


def _result(tp, name, rank=0):
    out = tp[0][rank][name]
    assert not (isinstance(out, tuple) and isinstance(out[0], str)
                and out[0] == "error"), out[1]
    return out


def _both(tp, name):
    """Rank 0's and rank 3's result of a scenario, asserted equal where
    it is host state every rank must agree on."""
    return _result(tp, name, 0), _result(tp, name, WORLD - 1)


@pytest.mark.parametrize("impl,paged,k", R.ENGINE_CASES,
                         ids=[f"{i}-{'paged' if p else 'dense'}-k{k}"
                              for i, p, k in R.ENGINE_CASES])
def test_tp4_engine_tokens_equal_one_device(tp, impl, paged, k):
    """tp=4 tokens equal the JAX 1-device engine's ("xla" for the torch
    path, "pallas" for the kernel) and the port's tp=1 engine's, on
    every rank; the kernel engine keeps the kernel (no fallback)."""
    r0, r3 = (res[(impl, paged, k)] for res in _both(tp, "engine"))
    _, ref, _ = tp
    toks, fallback, decode_impl, tp_degree, devices, _ = r0
    assert toks == r3[0]
    assert toks == ref["xla" if impl == "torch" else "pallas"]
    assert toks == ref[("port", paged)]
    assert (fallback, decode_impl, tp_degree, devices) \
        == (False, impl, 4, [0, 1, 2, 3])


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_tp4_cache_bytes_are_a_quarter(tp, paged):
    """Each rank holds exactly a quarter of the tp=1 engine's KV bytes
    (the kv-head split), dense and paged."""
    for res in _both(tp, "engine"):
        got = {res[(i, p, k)][5] for i, p, k in R.ENGINE_CASES if p == paged}
        assert got == {tp[1]["bytes"][paged] // 4}
        assert 4 * got.pop() == tp[1]["bytes"][paged]


def test_tp4_prefix_cache_warm_admit(tp):
    """The second turn admits warm (shared blocks in the sharded pool,
    block tables replicated) with the tp=1 engine's tokens."""
    r0, r3 = _both(tp, "prefix")
    assert r0 == r3 == tp[1]["prefix"]
    assert r0[1] > 0


def test_tp4_speculative_tokens(tp):
    r0, r3 = _both(tp, "spec")
    assert r0 == r3 == tp[1]["spec"]


def test_tp4_fleet_through_the_gateway(tp):
    """The K=2 fleet on one rank group: every rank routes as rank 0 did
    (the in-band request compressed into the short pool), only rank 0
    scores sentences, and the tokens are the tp=1 fleet's."""
    (base0, _, _, place, _), (base3, _, _, _, _) = _both(tp, "fleet")
    decisions, out, calls = base0
    assert (decisions, out) == base3[:2] == tp[1]["fleet"][:2]
    assert decisions[2][:2] == ("short", True)
    assert calls >= 1 and base3[2] == 0
    assert place == {"short": [0, 1, 2, 3], "long": [0, 1, 2, 3]}


def test_tp4_reprovision_mid_flight(tp):
    """Re-provisioning the long pool to another c_max mid-flight at the
    same tp: the uninterrupted run's tokens; then to tp=2, which moves it
    onto ranks 2-3, the second tp=2 submesh (tests/test_torch_submesh.py
    serves such fleets)."""
    (base, moved, rebuilds, _, regrouped), r3 = _both(tp, "fleet")
    assert moved[1] == base[1] == r3[1][1]
    assert rebuilds == 1
    assert regrouped == r3[4] == (
        [2, 3], {"short": [0, 1, 2, 3], "long": [2, 3]})


def test_tp4_serve_fleet_launcher(tp):
    """``serve.py --fleet 2 --tp 4`` in the ranks: rank 0 prints the tp=1
    launcher's lines but for the placement (tp=4 over ranks 0-3) and the
    wall time; the tokens are equal; rank 3 prints nothing."""
    (lines, toks), (lines3, toks3) = _both(tp, "serve_fleet")
    ref_lines, ref_toks = tp[1]["serve_fleet"]

    def plain(ls):
        return [ln.split(" in ")[0] if ln.startswith("served ") else ln
                for ln in ls if "tp=" not in ln]
    assert plain(lines) == plain(ref_lines)
    assert [ln for ln in lines if "tp=" in ln] == [
        f"  {p}: tp=4 devices=[0, 1, 2, 3]" for p in ("short", "long")]
    assert toks == toks3 == ref_toks
    assert lines3 == []


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_tp_batch_launcher_mesh(tp, mesh):
    """The batch launcher at --mesh 1x4 and 2x2 prints the JAX launcher's
    ``first sequence`` line at 1x1 on its JAX weights and prompt ids;
    2x2 splits the 4 rows over the data axis."""
    res = [r[mesh] for r in (_result(tp, "batch", i) for i in range(WORLD))]
    lines, data_rank, toks = res[0]
    want = [ln for ln in tp[1]["launcher"] if ln.startswith("first seq")]
    assert [ln for ln in lines if ln.startswith("first seq")] == want
    assert lines[0].startswith(f"arch=minitron-8b-reduced mesh {mesh} ")
    assert all(r[0] == [] for r in res[1:])
    dp = 2 if mesh == "2x2" else 1
    assert [r[1] for r in res] == [i // (WORLD // dp) for i in range(WORLD)]
    assert [r[2].shape[0] for r in res] == [4 // dp] * WORLD


def test_tp4_f32_logits_match_one_device(tp):
    """tp=4 forward logits within 1e-5 of max|logit| of the reference's
    1-device logits, the same bits on every rank, and the prefill's last
    position equal to the forward's."""
    (lg, last), (lg3, _) = _both(tp, "logits")
    ref = tp[1]["logits"]
    assert np.array_equal(lg, lg3)
    assert np.abs(lg - ref).max() <= 1e-5 * np.abs(ref).max()
    assert np.abs(last - lg[:, -1]).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("case", ["moe", "mla", "vlm", "ssm", "heads",
                                  "http"])
def test_later_slice_cases_raise(case):
    """Every case a later slice serves raises NotImplementedError naming
    that slice, before any rank is spawned or any state is built."""
    ctx = ParallelContext(mesh=make_smoke_mesh(4, world=4))
    dense = _cfgs()[1]
    slices = {"moe": "sharded-training", "mla": "sharded-families",
              "vlm": "sharded-families", "ssm": "sharded-families",
              "heads": "sharded-families", "http": "sharded-HTTP"}
    arch = {"mla": "deepseek-v2-236b",
            "vlm": "llama-3.2-vision-11b", "ssm": "zamba2-1.2b"}
    # an MoE model serves under tp (tests/test_torch_ep.py); its training
    # under a parallel context is the sharded-training slice's
    said = "later slice" if case == "moe" else "not ported"
    with pytest.raises(NotImplementedError,
                       match=f"{said}.*{slices[case]} slice"):
        if case == "moe":
            from repro_torch.training import train_step
            train_step.loss_fn({}, get_config(
                "llama4-scout-17b-a16e").reduced(), {}, ctx, "layer")
        elif case in arch:
            TM.check_supported(get_config(arch[case]).reduced(),
                               parallel=ctx)
        elif case == "heads":
            TM.init_params(dense, device="meta", parallel=ParallelContext(
                mesh=make_smoke_mesh(3, world=3)))
        else:
            TS.main(FLEET_ARGV + ["--tp", "4", "--smoke"])


@pytest.mark.parametrize("tp_size", [2, 4])
def test_sharded_init_draws_the_unsharded_weights(tp_size):
    """``init_params(parallel=)`` on each rank is ``shard_params`` of the
    unsharded ``init_params``: tp ranks start from one device's
    weights."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.training import tree
    cfg = _cfgs()[1]
    full = TM.init_params(cfg, seed=3, device="cpu")
    for r in range(tp_size):
        ctx = ParallelContext(mesh=Mesh(np.arange(tp_size)[None],
                                        ("data", "model")), rank=r)
        got = TM.init_params(cfg, seed=3, device="cpu", parallel=ctx)
        want = SH.shard_params(full, ctx)
        assert all(torch.equal(a, b) for a, b in
                   zip(tree.leaves(got), tree.leaves(want)))
        assert got["layers"]["attn"]["wq"].shape[-1] \
            == cfg.num_heads * cfg.resolved_head_dim // tp_size


def test_a_failing_rank_fails_the_spawn_without_hanging():
    """A rank that raises while the others wait in a collective fails the
    spawn with its error, well inside the group's timeout."""
    t0 = time.perf_counter()
    with pytest.raises(Exception, match="rank 1 fails"):
        PC.launch_ranks(R.raise_on_rank_one, WORLD, device="cpu",
                        timeout_s=TIMEOUT_S, threads=1, quiet=True)
    assert time.perf_counter() - t0 < TIMEOUT_S / 2
