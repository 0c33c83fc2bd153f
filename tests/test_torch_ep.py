"""Expert parallelism on the CPU: the port's ``moe_block_sharded`` (a2a and
psum) and the MoE decoder served tensor-parallel, four gloo ranks (one
process each, a file store under a temporary directory, no network, no
card) against the JAX package.

* The block: the port's ``moe_block_sharded`` against the reference's
  ``moe_block_sharded`` at meshes 1x4 (ep 4) and 2x2 (ep 2, the batch
  split over the data axis), modes a2a and psum, the two fallbacks (S = 5,
  which neither model axis divides: a2a runs as psum; B = 1 under 2x2:
  the rows replicated over the data axis), on reduced llama4-scout and
  reduced deepseek-v2 MoE widths at 8 experts (the reference test's), at
  the default capacity_factor 1.25 on inputs pushed towards one expert, so
  both capacity stages drop: outputs within 1e-5 of max|y|, the dropped
  pairs equal, lb_loss equal. The reference runs in one subprocess with
  four fake CPU devices and Auto mesh axes (``jax.make_mesh`` defaults to
  Explicit axes on this JAX, which the reference's shard_map refuses:
  tests/test_moe_sharded.py), one jitted call a (config, mesh) for every
  mode and fallback. It reports no drops; its dropped pairs are read by a
  second call on probe weights: each expert's down projection writes one
  column of its own (expert e: column e) and the shared expert writes
  none, so a (token, expert) pair was kept exactly where that column of
  the token's output is non-zero (the routing, hence the drops, does not
  read those weights).
* The model at capacity_factor 8.0 (no drops at either degree, so tp=4
  and tp=1 compute the same function): reduced llama4-scout in f32 with 8
  experts at tp=4 against tp=1 and the JAX package's 1-device runs:
  forward, prefill, decode_step, the fused chunk (a2a, and its psum
  fallback at 6 columns), a ring that wraps (the per-token chunk and
  decode: psum) and the paged chunk and decode, logits within 1e-5 of
  max|logit|; the greedy tokens of the dense engine (the ring, and window
  0), the paged engine at decode_k 1 and 4 and the K=2 fleet (and its
  reprovision) equal to tp=1's and to the JAX engine's; the batch
  launcher at --mesh 1x4 and 2x2 equal to 1x1.
* ep = 1 stays what tests/test_torch_moe.py pins: a one-rank model axis
  runs the unsharded block bit for bit.

One module-scoped spawn runs every rank scenario (tests/torch_ep_ranks.py)
while this process computes the references.
"""
import concurrent.futures
import dataclasses
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_ep_ranks as E
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
from repro_torch.models import moe as MOE
from test_torch_tp import _fleet_requests, _stream

WORLD = 4
TIMEOUT_S = 120
ROOT = Path(__file__).resolve().parents[1]
BLOCK_ARCHS = (E.ARCH, "deepseek-v2-236b")
BLOCK_SHAPE = (4, 16)          # (B, S): B splits over 2, S over 4 and 2
PUSH = 4.0                     # the inputs' push towards expert 0
BATCH_ARGV = ["--arch", E.NO_DROP.name, "--reduced", "--batch", "4",
              "--prompt-len", "16", "--new-tokens", "4", "--device", "cpu"]

# The reference's moe_block_sharded under four fake devices: one jit a
# (config, mesh) runs every mode and fallback; called on the weights and on
# the probe weights, it returns each call's (y, lb_loss).
REFERENCE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.distributed.context import ParallelContext
from repro.models import moe as MOE

inp = pickle.load(open(sys.argv[1], "rb"))
out = {}
for arch, case in inp["cases"].items():
    cfg = case["cfg"]
    xs = {k: jnp.asarray(v) for k, v in case["x"].items()}
    for shape in ((1, 4), (2, 2)):
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        ctx = ParallelContext(mesh=mesh, data_axes=("data",))

        def calls(p, xs):
            res = {}
            for name, key, mode in inp["calls"]:
                y, aux = MOE.moe_block_sharded(p, cfg, xs[key], ctx,
                                               mode=mode)
                res[name] = (y, aux["lb_loss"])
            return res
        with mesh:
            run = jax.jit(calls)
            for which in ("p", "probe"):
                p = jax.tree.map(jnp.asarray, case[which])
                got = run(p, xs)
                out[(arch, "%dx%d" % shape, which)] = jax.tree.map(
                    lambda a: jax.device_get(a), got)
pickle.dump(out, open(sys.argv[2], "wb"))
print("REFERENCE_OK")
"""


def _jcfg(arch, cf, experts=8):
    """The JAX config: reduced f32 ``arch`` at ``experts`` experts and
    capacity_factor ``cf`` (MLA left out: the block reads no attention)."""
    cfg = reduced_f32(arch)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=experts, capacity_factor=cf))


def _tcfg(arch, cf, experts=8, **change):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              **change)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=experts, capacity_factor=cf))


def _block_case(arch, seed):
    """One layer's MoE weights from the JAX ``init_moe``, its probe
    weights, and the (B, S, D) inputs pushed towards expert 0's router
    column (and their fallback cuts)."""
    from repro.models import moe as JMOE
    jcfg = _jcfg(arch, 1.25)
    p = jax.tree.map(np.asarray, JMOE.init_moe(jax.random.PRNGKey(seed),
                                               jcfg))
    probe = jax.tree.map(np.copy, p)
    e = jcfg.moe.num_experts
    probe["w_down"][:] = 0.0
    probe["w_down"][np.arange(e), :, np.arange(e)] = 1.0
    probe["shared"]["down"][:] = 0.0
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*BLOCK_SHAPE, jcfg.d_model)).astype(np.float32)
    col = p["router"][:, 0]
    x += PUSH * col / np.linalg.norm(col)
    xs = dict(x=x, x_odd=np.ascontiguousarray(x[:, :5]),
              x_b1=np.ascontiguousarray(x[:1]))
    return dict(cfg=jcfg, p=p, probe=probe, x=xs)


def _reference_block(cases):
    """Start the reference's subprocess; returns a function that waits
    for it and reads {(arch, mesh, which): {call: (y, lb)}}."""
    where = tempfile.mkdtemp(prefix="ep-ref-")
    src, dst = os.path.join(where, "in.pkl"), os.path.join(where, "out.pkl")
    with open(src, "wb") as f:
        pickle.dump({"cases": cases, "calls": E.BLOCK_CALLS}, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE, src, dst],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)

    def wait(kill=False):
        try:
            if kill:
                return None
            log, _ = proc.communicate(timeout=900)
            assert "REFERENCE_OK" in log, log[-4000:]
            with open(dst, "rb") as f:
                return pickle.load(f)
        finally:
            proc.kill()
            proc.wait()
            shutil.rmtree(where, ignore_errors=True)
    return wait


def _ref_dropped(cfg, router, x, y_probe):
    """The reference's dropped (token, choice) pairs: its routing of x,
    read against the probe output's expert columns."""
    t = x.reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(t @ router, axis=-1)
    eidx = np.asarray(jax.lax.top_k(probs, cfg.moe.top_k)[1])
    y = y_probe.reshape(t.shape[0], -1)
    return (np.take_along_axis(y, eidx, axis=1) == 0).reshape(-1)


def _jax_model_runs(jp, cfg):
    """``torch_ep_ranks.model_runs``'s calls through the JAX package (the
    same inputs, ``cfg`` at window 0)."""
    import jax.numpy as jnp
    inp = {k: jnp.asarray(v, jnp.int32) for k, v in E.model_inputs().items()}
    jp = jax.tree.map(jnp.asarray, jp)
    out = {}
    lg, _ = M.forward(jp, cfg, {"tokens": inp["seq"]})
    out["forward"] = np.asarray(lg)
    last, cache = M.prefill(jp, cfg, {"tokens": inp["seq"], "cache_len": 24})
    out["prefill"] = np.asarray(last)
    steps = []
    for j in range(3):
        lg, cache = M.decode_step(jp, cfg, inp["decode"][j], cache, 16 + j)
        steps.append(np.asarray(lg))
    out["decode"] = np.stack(steps)
    cache = M.init_cache(cfg, 3, 32)
    chunks = []
    for key, start, lengths in (("chunk1", [0, 0, 0], [8, 5, 0]),
                                ("chunk2", [8, 5, 0], [6, 6, 0])):
        lg, cache = M.prefill_chunk(jp, cfg, inp[key], cache,
                                    jnp.asarray(start), jnp.asarray(lengths))
        chunks.append(np.asarray(lg)[:2])
    out["chunk"] = np.stack(chunks)
    ring = dataclasses.replace(cfg, attention_window=E.WINDOW)
    cache = M.init_cache(ring, 2, 32)
    lg, cache = M.prefill_chunk(jp, ring, inp["ring"], cache,
                                jnp.asarray([0, 0]), jnp.asarray([12, 9]))
    rows = [np.asarray(lg)]
    for j in range(4):
        lg, cache = M.decode_step(jp, ring, inp["ring_decode"][j], cache,
                                  jnp.asarray([12 + j, 9 + j]))
        rows.append(np.asarray(lg))
    out["ring"] = np.stack(rows)
    cache = M.init_paged_cache(cfg, 8, 8)
    tables = jnp.asarray(E.TABLES)
    lg, cache = M.paged_prefill_chunk(jp, cfg, inp["paged"], cache, tables,
                                      jnp.asarray([0, 0]),
                                      jnp.asarray([8, 6]))
    rows = [np.asarray(lg)]
    for j in range(2):
        lg, cache = M.paged_decode_step(jp, cfg, inp["paged_decode"][j],
                                        cache, tables,
                                        jnp.asarray([8 + j, 6 + j]))
        rows.append(np.asarray(lg))
    out["paged"] = np.stack(rows)
    return out


def _jax_engine(cfg, jp, reqs, **kw):
    eng = JaxEngine(cfg, jp, eos_id=E.R.EOS, n_max=3, c_max=128,
                    c_chunk=16, decode_impl="xla", **kw)
    for r in reqs:
        eng.submit(JaxRequest(**r))
    res = eng.run_to_completion(5000)
    return {rid: r.output_tokens for rid, r in sorted(res.items())}


@pytest.fixture(scope="module")
def ep():
    """Starts the reference's subprocess, spawns the ranks (in a thread)
    and computes the other references here meanwhile. Returns (rank
    results, references, inputs)."""
    cases = {arch: _block_case(arch, seed)
             for seed, arch in enumerate(BLOCK_ARCHS)}
    wait_block = _reference_block(cases)
    jcfg = _jcfg(E.ARCH, 8.0)
    jp = jax.tree.map(np.asarray, M.init_params(jcfg, jax.random.PRNGKey(0)))
    key = jax.random.PRNGKey(0)
    jp_launch = jax.tree.map(np.asarray, M.init_params(
        reduced_f32(E.ARCH), key))
    tcfg = _tcfg(E.ARCH, 8.0)
    block = {arch: dict(cfg=_tcfg(arch, 1.25, mla=None), p=c["p"],
                        x=c["x"]) for arch, c in cases.items()}
    inp = dict(cfg=tcfg, jp=jp, reqs=_stream(), fleet=_fleet_requests(),
               block=block, batch_argv=BATCH_ARGV, jp_launch=jp_launch,
               launch_tokens=np.random.default_rng(2).integers(
                   1, 1000, (4, 16)))
    t0 = time.perf_counter()
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(PC.launch_ranks, E.run_scenarios, WORLD,
                                (inp,), device="cpu", timeout_s=TIMEOUT_S,
                                threads=1, quiet=True)
            ref = _references(jcfg, tcfg, jp, inp)
            t1 = time.perf_counter()
            out = ranks.result()
    except BaseException:
        wait_block(kill=True)
        raise
    ref["block"] = wait_block()
    ref["cases"] = cases
    print(f"references {t1 - t0:.1f} s, all {time.perf_counter() - t0:.1f}"
          f" s: {out[0]['seconds']}")
    return out, ref, inp


def _references(jcfg, tcfg, jp, inp):
    """The JAX package's 1-device model and engine runs, and the port's
    tp=1 model, engine, fleet and launcher runs."""
    w0 = dataclasses.replace(jcfg, attention_window=0)
    ref = {"jax": _jax_model_runs(jp, w0),
           "jax_engine": {
               "ring": _jax_engine(jcfg, jp, inp["reqs"]),
               "paged": _jax_engine(w0, jp, inp["reqs"], paged=True,
                                    block_size=16)}}
    full = P.from_jax_numpy(jp, device="cpu")
    t0 = dataclasses.replace(tcfg, attention_window=0)
    ref["model"] = E.model_runs(full, t0)
    ref["engine"] = E.engine_runs(tcfg, full, inp["reqs"])
    ref["fleet"] = E.R.fleet(t0, full, inp["fleet"])[:3]
    args = TS.parse_args(BATCH_ARGV)
    run = TS.serve_batch(args, params=P.from_jax_numpy(inp["jp_launch"],
                                                       device="cpu"),
                         tokens=torch.as_tensor(inp["launch_tokens"]),
                         decode_impl="torch")
    ref["batch"] = (run.tokens.numpy(),
                    np.stack([t.numpy() for t in run.logits]))
    return ref


def _result(ep, name, rank=0):
    out = ep[0][rank][name]
    assert not (isinstance(out, tuple) and isinstance(out[0], str)
                and out[0] == "error"), out[1]
    return out


def _close(got, want, tol=1e-5):
    return np.abs(got - want).max() <= tol * np.abs(want).max()


# ------------------------------------------------------------- the block
def test_all_to_all_and_mean_all(ep):
    """all_to_all: rank r's slot j holds rank j's slot r (jax.lax
    .all_to_all, tiled=False) in the model-axis row; mean_all: the mean
    over every rank of the mesh, the same on every rank."""
    for rank in range(WORLD):
        for m, (tp, dp) in (("1x4", (4, 1)), ("2x2", (2, 2))):
            got, mean, model_rank, data_rank = _result(ep, "collectives",
                                                       rank)[m]
            row = [data_rank * tp + j for j in range(tp)]
            want = np.stack([np.arange(tp * 3).reshape(tp, 3)[model_rank]
                             + 100 * j for j in row])
            want = torch.tensor(want, dtype=torch.bfloat16).float().numpy()
            assert np.array_equal(got, want), (rank, m)
            assert mean == np.mean([r * r for r in range(WORLD)])


def _assembled(ep, mesh, arch, name):
    """Every row of a block call from the ranks: each data slice's model
    rank 0 (all ranks of a row equal), in data order; (y, lb, dropped)."""
    tp = 4 if mesh == "1x4" else 2
    res = [_result(ep, "block", r)[(mesh, arch)][name] for r in range(WORLD)]
    for r in range(WORLD):
        first = res[r - r % tp]
        assert np.array_equal(res[r][1], first[1]), (r, name)
        assert np.array_equal(res[r][3], first[3]), (r, name)
    lbs = {res[r][2] for r in range(WORLD)}
    assert len(lbs) == 1, lbs
    heads = [res[r] for r in range(0, WORLD, tp)]
    if heads[0][0] is None:          # rows replicated over the data axis
        assert all(np.array_equal(h[1], heads[0][1]) for h in heads)
        heads = heads[:1]
    b = heads[0][1].shape[0]
    k = heads[0][3].size // (b * heads[0][1].shape[1])
    y = np.concatenate([h[1] for h in heads])
    dropped = np.concatenate([h[3].reshape(b, -1, k) for h in heads])
    return y, lbs.pop(), dropped.reshape(-1)


@pytest.mark.parametrize("name", [c[0] for c in E.BLOCK_CALLS])
@pytest.mark.parametrize("mesh", E.MESHES)
@pytest.mark.parametrize("arch", BLOCK_ARCHS, ids=["scout", "deepseek"])
def test_block_matches_reference_sharded(ep, arch, mesh, name):
    """The port's moe_block_sharded against the reference's, at
    capacity_factor 1.25 with drops: y within 1e-5 of max|y|, the dropped
    pairs equal, lb_loss equal (0 under psum)."""
    y, lb, dropped = _assembled(ep, mesh, arch, name)
    ref, case = ep[1]["block"], ep[1]["cases"][arch]
    y_ref, lb_ref = ref[(arch, mesh, "p")][name]
    y_probe = ref[(arch, mesh, "probe")][name][0]
    x = case["x"][dict((c[0], c[1]) for c in E.BLOCK_CALLS)[name]]
    want = _ref_dropped(case["cfg"], case["p"]["router"], x, y_probe)
    assert y.shape == y_ref.shape
    assert _close(y, np.asarray(y_ref))
    assert np.array_equal(dropped, want)
    assert lb == pytest.approx(float(lb_ref), rel=1e-6, abs=1e-7)


@pytest.mark.parametrize("arch", BLOCK_ARCHS, ids=["scout", "deepseek"])
def test_block_inputs_overflow(ep, arch):
    """The block's inputs exercise the drops: a2a drops pairs at both
    meshes, and the fallback calls drop too (they run as psum)."""
    for mesh in E.MESHES:
        assert _assembled(ep, mesh, arch, "a2a")[2].any(), mesh
    assert any(_assembled(ep, m, arch, n)[2].any() for m in E.MESHES
               for n in ("psum", "odd"))


# ------------------------------------------------------------- the model
@pytest.mark.parametrize("call", ["forward", "prefill", "decode", "chunk",
                                  "ring", "paged"])
def test_tp4_logits_match_tp1_and_jax(ep, call):
    """Reduced scout (8 experts, capacity_factor 8.0) at tp=4: every entry
    point's f32 logits within 1e-5 of max|logit| of the port's tp=1 and
    the JAX package's 1-device logits, the same bits on every rank."""
    got = _result(ep, "model")[call]
    assert np.array_equal(got, _result(ep, "model", WORLD - 1)[call])
    for want in (ep[1]["model"][call], ep[1]["jax"][call]):
        assert got.shape == want.shape
        assert _close(got, want), call


def test_tp4_forward_lb_is_the_sum_of_layer_means(ep):
    """The forward's load-balance loss at tp=4, each rank's own loss
    summed over the layers and averaged over the ranks once, is the
    reference's sum over the layers of each layer's mean over the ranks,
    the same on every rank."""
    lb, layers = _result(ep, "forward_lb")
    assert (lb, layers) == _result(ep, "forward_lb", WORLD - 1)
    assert len(layers) > 1
    assert lb > 0
    assert lb == pytest.approx(sum(layers), rel=1e-6)


@pytest.mark.parametrize("layout,k", E.ENGINE_CASES,
                         ids=[f"{lay}-k{k}" for lay, k in E.ENGINE_CASES])
def test_tp4_engine_tokens(ep, layout, k):
    """tp=4 engine tokens equal the port's tp=1 engine's and the JAX
    1-device engine's (decode_k changes no token), on every rank."""
    got = _result(ep, "engine")[(layout, k)]
    assert got == _result(ep, "engine", WORLD - 1)[(layout, k)]
    assert got == ep[1]["engine"][(layout, k)]
    jax_layout = "ring" if layout == "ring" else "paged"
    assert got == ep[1]["jax_engine"][jax_layout]


def test_tp4_fleet_and_reprovision(ep):
    """The K=2 fleet at tp=4 routes and serves as the tp=1 fleet; the
    long pool reprovisioned mid-flight keeps the uninterrupted tokens;
    only rank 0 scores sentences."""
    base, moved, rebuilds, place = _result(ep, "fleet")
    base3 = _result(ep, "fleet", WORLD - 1)[0]
    assert base[:2] == base3[:2] == ep[1]["fleet"][:2]
    assert base[0][2][:2] == ("short", True)
    assert base[2] >= 1 and base3[2] == 0
    assert moved[1] == base[1]
    assert rebuilds == 1
    assert place == {"short": [0, 1, 2, 3], "long": [0, 1, 2, 3]}


@pytest.mark.parametrize("mesh", E.MESHES)
def test_batch_launcher_mesh(ep, mesh):
    """The batch launcher on the no-drop scout at --mesh 1x4 and 2x2: the
    1x1 run's tokens, each data slice's rows, logits within 1e-5."""
    rows = {}
    for r in range(WORLD):
        data_rank, toks, logits = _result(ep, "batch", r)[mesh]
        rows.setdefault(data_rank, (toks, logits))
    toks = np.concatenate([rows[i][0] for i in sorted(rows)])
    logits = np.concatenate([rows[i][1] for i in sorted(rows)], axis=1)
    want_toks, want_logits = ep[1]["batch"]
    assert np.array_equal(toks, want_toks)
    assert _close(logits, want_logits)


# --------------------------------------------------- no spawn, no reference
def test_ep1_is_the_unsharded_block():
    """A one-rank model axis runs the unsharded block bit for bit, and the
    model takes it for the local path (ep = 1 stays tests/test_torch_moe
    .py's)."""
    cfg = _tcfg(E.ARCH, 1.25)
    params = TM.init_params(cfg, seed=4, device="cpu")
    lp = TM._unstack(params["layers"]["moe"])[0]
    x = torch.randn((2, 16, cfg.d_model), generator=torch.Generator()
                    .manual_seed(4))
    one = ParallelContext(mesh=make_smoke_mesh(1))
    y, aux = MOE.moe_block(lp, cfg, x)
    t = x.reshape(-1, cfg.d_model)
    y1, aux1 = MOE._moe_tokens(lp, cfg, t, one)
    y0, aux0 = MOE._moe_tokens(lp, cfg, t)
    assert torch.equal(y1, y0) and torch.equal(aux1["dropped"],
                                                aux0["dropped"])
    toks = torch.randint(1, 900, (2, 16), generator=torch.Generator()
                         .manual_seed(5))
    a = TM.forward(params, cfg, {"tokens": toks})[0]
    b = TM.forward(params, cfg, {"tokens": toks}, parallel=one)[0]
    assert torch.equal(a, b) and y.shape == x.shape


@pytest.mark.parametrize("t,ep,cf", [(4, 1, 1.25), (64, 1, 1.25),
                                     (64, 2, 1.25), (64, 4, 1.25),
                                     (1024, 4, 1.25), (5, 4, 8.0),
                                     (4096, 4, 8.0)])
def test_capacities_are_the_references(t, ep, cf):
    """cap and ecap as the reference's ``_moe_tokens`` (moe.py:213-214,
    :247-248) and ``moe_block_psum`` (:149-150) size them."""
    import math
    cfg = _tcfg(E.ARCH, cf, experts=16)
    k, e = cfg.moe.top_k, cfg.moe.num_experts
    cap = max(int(math.ceil(t * k / ep * cf)), 8)
    ecap = max(int(math.ceil(ep * cap / max(e // ep, 1) * cf)), 8)
    assert MOE.capacities(cfg, t, ep) == (cap, ecap)
    assert MOE.psum_capacity(cfg, t, ep) == max(
        int(math.ceil(t * k / max(e // ep, 1) * cf)), 8)


def test_packed_round_trips_every_dtype():
    """``moe._packed`` moves tensors of several dtypes as one byte tensor
    and gives each back bit for bit."""
    g = torch.Generator().manual_seed(6)
    ts = (torch.randn((4, 3, 5), generator=g).to(torch.bfloat16),
          torch.randint(-9, 9, (4, 3), generator=g, dtype=torch.int32),
          torch.rand((4, 3, 2), generator=g) > 0.5,
          torch.randn((4, 3, 7), generator=g))
    back = MOE._packed(lambda t: t, 2, *ts)
    assert all(torch.equal(a, b) and a.dtype == b.dtype
               for a, b in zip(ts, back))


@pytest.mark.parametrize("tp_size", [2, 4])
def test_sharded_init_draws_the_unsharded_experts(tp_size):
    """``init_params(parallel=)`` of an MoE model on each rank is
    ``shard_params`` of the unsharded draw: the rank's contiguous block of
    experts, the router and the shared expert whole."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.training import tree
    cfg = _tcfg(E.ARCH, 1.25)
    full = TM.init_params(cfg, seed=3, device="cpu")
    e_loc = cfg.moe.num_experts // tp_size
    for r in range(tp_size):
        ctx = ParallelContext(mesh=Mesh(np.arange(tp_size)[None],
                                        ("data", "model")), rank=r)
        got = TM.init_params(cfg, seed=3, device="cpu", parallel=ctx)
        want = SH.shard_params(full, ctx)
        assert all(torch.equal(a, b) for a, b in
                   zip(tree.leaves(got), tree.leaves(want)))
        moe = got["layers"]["moe"]
        assert moe["w_up"].shape[1] == e_loc
        assert torch.equal(moe["w_down"], full["layers"]["moe"]["w_down"][
            :, r * e_loc:(r + 1) * e_loc])
        assert torch.equal(moe["router"], full["layers"]["moe"]["router"])


@pytest.mark.parametrize("case", ["experts", "block", "mla"])
def test_ep_refusals(case):
    """What the expert-parallel slice does not serve: experts tp does not
    divide (the reference asserts it; the model refuses it, and so does
    the block called alone), and MoE with MLA attention (the
    sharded-families slice), refused before any state is built or any
    rank is asked for an exchange."""
    ctx = ParallelContext(mesh=make_smoke_mesh(3 if case != "mla" else 4,
                                               world=3 if case != "mla"
                                               else 4))
    cfg = (get_config("deepseek-v2-236b").reduced() if case == "mla"
           else _tcfg(E.ARCH, 1.25, experts=4, num_heads=6, num_kv_heads=3,
                      vocab_size=1026))
    if case == "block":
        with pytest.raises(ValueError, match="4 experts not divisible by "
                           "ep=3"):
            MOE.moe_block_sharded({}, cfg, torch.zeros((1, 3, 256)), ctx)
        return
    match = ("4 experts not divisible by ep=3" if case == "experts"
             else "MLA 'moe' under tp=4 is not ported.*sharded-families")
    with pytest.raises(NotImplementedError, match=match):
        TM.init_params(cfg, device="meta", parallel=ctx)
