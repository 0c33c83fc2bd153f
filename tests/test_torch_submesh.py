"""The K-pool fleet on disjoint tensor-parallel submeshes, on the CPU: four
gloo ranks (one process each, a file store under a temporary directory, no
network, no card) over a 1x4 mesh, against the JAX package.

* Placement: pool i on ``make_submeshes(mesh, tp)[i % len(subs)]``, equal
  to the reference's ``device_placement()`` for K=2 and K=3 at tp 1, 2
  and 4 (K=3 at tp=2 wraps round robin: [0, 1], [2, 3], [0, 1]) and after
  ``reprovision("long", tp=1 / 4 / 2)`` in turn; a member's KV bytes equal
  the reference's per-device bytes, and a rank holds one shard set for
  each distinct submesh it belongs to, ``shard_params`` of the full
  weights bitwise, and nothing of a pool outside its submesh. The
  reference runs in one subprocess with four fake CPU devices and Auto
  mesh axes (``jax.make_mesh`` defaults to Explicit axes on this JAX,
  which the reference's engine refuses: tests/test_moe_sharded.py).
* Tokens: the K=2 fleet of two tp=2 pools (short on ranks 0-1, long on
  2-3) through the C&R gateway equals the JAX 1-device ``FleetRuntime``
  on every rank: the port's "torch" path against "xla" dense and paged,
  the "kernel" path (its plain version on the CPU) against "pallas"
  paged; routing decisions equal the JAX gateway's, TextRank runs on rank
  0 only, and every rank's host state equals the others' after every
  engine step.
* ``reprovision("long", tp=)`` mid-flight, paged with the prefix cache and
  a prefix-warm session turn in flight (the reference's ``_run_sharded``,
  tests/test_reprovision.py:378): 2 -> 1, 2 -> 4 and 4 -> 2 give the
  uninterrupted run's tokens, KV bytes a member scale by exactly tp_old /
  tp_new (the reference's ``after == b4 * 4 // new_tp``), no request is
  recomputed, each moved host row's heads arrive bitwise (crc32), the new
  ranks' weights equal ``shard_params`` of the full weights bitwise; the
  uninterrupted runs at tp=2 and tp=4 give the JAX 1-device fleet's
  tokens on the same stream.
* ``recover_pool`` of the short pool under a kill while the long pool
  decodes leaves the long pool's tokens unchanged; the run without the
  kill gives the JAX 1-device fleet's tokens.
* ``serve.py --fleet 2 --tp 2 --mesh 1x4`` prints the reference's
  placement lines and the tp=1 launcher's tokens.

One module-scoped spawn runs every rank scenario
(tests/torch_submesh_ranks.py) while this process computes the
references.
"""
import concurrent.futures
import contextlib
import dataclasses
import io
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

import torch_submesh_ranks as S
from conftest import reduced_f32
from jax_compile_cache import jax_compile_cache  # noqa: F401
from repro.models import model as M
from repro.serving.pools import FleetRuntime as JaxFleet
from repro.serving.pools import GatewayRequest as JaxRequest
from repro_torch.configs.base import get_config
from repro_torch.distributed import context as PC
from repro_torch.launch import serve as TS

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the in-band prompt builder)

WORLD = 4
TIMEOUT_S = 120
EOS = 7
FLEET_ARGV = ["--reduced", "--fleet", "2", "--decode-k", "4", "--paged",
              "--new-tokens", "6", "--device", "cpu"]

# The reference under four fake devices: the placement and per-device KV
# bytes of each (K, tp) fleet and of the long pool moved in turn, and the
# launcher's placement lines (its loop, src/repro/launch/serve.py:94-95).
REFERENCE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from jax.sharding import AxisType
from repro.launch import serve as JS
from repro.models import model as M
from repro.serving.pools import FleetRuntime

inp = pickle.load(open(sys.argv[1], "rb"))
make_mesh = jax.make_mesh
jax.make_mesh = lambda shape, names, **kw: make_mesh(
    shape, names, axis_types=(AxisType.Auto,) * len(names))
cfg = inp["cfg"]
params = M.init_params(cfg, jax.random.PRNGKey(0))
mesh = jax.make_mesh((1, 4), ("data", "model"))


def read(rt):
    return (rt.device_placement(),
            {n: e.cache_bytes_per_device() for n, e in rt.engines.items()})


out = {}
for k, (bounds, ctx) in inp["fleets"].items():
    for tp in inp["tps"]:
        rt = FleetRuntime(cfg, params, bounds, (1.5,) * len(bounds),
                          (2,) * k, ctx, c_chunk=16, mesh=mesh,
                          tp_degree=tp)
        out[(k, tp)] = read(rt)
        if (k, tp) == (2, 2):
            for new in inp["moves"]:
                rt.reprovision("long", tp=new)
                out[(k, tp, new)] = read(rt)
rt, _ = JS.build_fleet_runtime(inp["args"])
out["lines"] = [f"  {name}: tp={rt.tp_degree} devices={ids}"
                for name, ids in rt.device_placement().items()]
pickle.dump(out, open(sys.argv[2], "wb"))
print("REFERENCE_OK")
"""


def _cfgs():
    """(JAX config, port config): reduced f32 minitron-8b (2 layers, 4 /
    4 heads of 64: one kv head a rank at tp=4)."""
    return (reduced_f32("minitron-8b"),
            dataclasses.replace(get_config("minitron-8b").reduced(),
                                dtype="float32"))


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


def _waves():
    """The reference's session stream, sized for the K=2 fleet's long
    pool: wave 1 a session's first turn; wave 2 the turn again (pinned
    to the long pool, its prefix warm) beside another long request and a
    short one."""
    turn1 = "session history " * 28
    return ([dict(rid=0, text=turn1, max_output_tokens=6, session="s")],
            [dict(rid=1, text="other stream " * 30, max_output_tokens=10),
             dict(rid=2, text=turn1 + " follow-up turn",
                  max_output_tokens=10, session="s"),
             dict(rid=3, text="a short one", max_output_tokens=8)])


def _crash_requests():
    """Short requests that outlive the long pool's prefill, and long
    ones."""
    return ([dict(rid=i, text=f"short request {i}", max_output_tokens=24)
             for i in range(3)]
            + [dict(rid=3 + i, text=f"long request {i} " * 26,
                    max_output_tokens=12) for i in range(2)])


def _reference_placement(tcfg):
    """Start the reference's subprocess; returns a function that waits for
    it and reads its placements, bytes and launcher lines."""
    where = tempfile.mkdtemp(prefix="submesh-ref-")
    src, dst = os.path.join(where, "in.pkl"), os.path.join(where, "out.pkl")
    args = TS.parse_args(FLEET_ARGV + ["--tp", "2", "--mesh", "1x4"])
    with open(src, "wb") as f:
        pickle.dump(dict(cfg=_cfgs()[0], fleets=S.FLEETS,
                         tps=S.PLACEMENT_TP, moves=S.REPROVISION_TP,
                         args=args), f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE, src, dst],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)

    def wait(kill=False):
        try:
            if kill:
                return None
            log, _ = proc.communicate(timeout=600)
            assert "REFERENCE_OK" in log, log[-4000:]
            with open(dst, "rb") as f:
                return pickle.load(f)
        finally:
            proc.kill()
            proc.wait()
            shutil.rmtree(where, ignore_errors=True)
    return wait


def _jax_fleet(cfg, jp, requests, paged, impl):
    """The JAX 1-device K=2 fleet: (decisions, {rid: tokens})."""
    bounds, ctx = S.FLEETS[2]
    rt = JaxFleet(cfg, jp, bounds, (1.5,), (2, 2), ctx, c_chunk=16,
                  block_size=16, paged=paged, decode_k=4, decode_impl=impl)
    decisions = []
    for rid, text, n, cat in requests:
        d = rt.submit(JaxRequest(rid, text, n, category=cat))
        decisions.append((d.pool, d.compressed, d.l_total_effective))
    res = rt.run(max_iters=2000)
    return decisions, {rid: r.output_tokens for rid, r in sorted(res.items())}


def _jax_waves(cfg, jp, waves, **kw):
    """The JAX 1-device K=2 fleet on ``waves`` in turn, each drained
    before the next is submitted: {rid: tokens}."""
    bounds, ctx = S.FLEETS[2]
    rt = JaxFleet(cfg, jp, bounds, (1.5,), (2, 2), ctx, c_chunk=16,
                  block_size=16, eos_id=EOS, decode_impl="pallas", **kw)
    out = {}
    for wave in waves:
        for r in wave:
            rt.submit(JaxRequest(**r))
        out.update({rid: r.output_tokens
                    for rid, r in rt.run(max_iters=2000).items()})
    return out


@pytest.fixture(scope="module")
def sub():
    """Starts the reference's subprocess, spawns the ranks (in a thread)
    and computes the other references here meanwhile. Returns (rank
    results, references)."""
    jcfg, tcfg = _cfgs()
    wait = _reference_placement(tcfg)
    jp = jax.tree.map(np.asarray, M.init_params(jcfg, jax.random.PRNGKey(0)))
    inp = dict(cfg=tcfg, jp=jp, fleet=_fleet_requests(), waves=_waves(),
               crash=_crash_requests(), eos=EOS, fleet_argv=FLEET_ARGV)
    t0 = time.perf_counter()
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(PC.launch_ranks, S.run_scenarios, WORLD,
                                (inp,), device="cpu", timeout_s=TIMEOUT_S,
                                threads=1, quiet=True)
            jps = jax.tree.map(jax.numpy.asarray, jp)
            ref = {case: _jax_fleet(jcfg, jps, inp["fleet"], case[1],
                                    "xla" if case[0] == "torch"
                                    else "pallas")
                   for case in S.TOKEN_CASES}
            # the session stream of the moves and the crash stream, as
            # the ranks' uninterrupted runs serve them
            ref["waves"] = _jax_waves(jcfg, jps, inp["waves"], paged=True,
                                      prefix_cache=True, decode_k=4)
            ref["crash"] = _jax_waves(jcfg, jps, [inp["crash"]],
                                      decode_k=1)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                _, res, _ = TS.serve_fleet(TS.parse_args(FLEET_ARGV))
            ref["launcher"] = (buf.getvalue().splitlines(),
                               {rid: r.output_tokens
                                for rid, r in res.items()})
            t1 = time.perf_counter()
            out = ranks.result()
    except BaseException:
        wait(kill=True)
        raise
    ref["reference"] = wait()
    print(f"references {t1 - t0:.1f} s, all {time.perf_counter() - t0:.1f}"
          f" s: {out[0]['seconds']}")
    return out, ref


def _result(sub, name, rank=0):
    out = sub[0][rank][name]
    assert not (isinstance(out, tuple) and isinstance(out[0], str)
                and out[0] == "error"), out[1]
    return out


def _every(sub, name):
    return [_result(sub, name, r) for r in range(WORLD)]


# --------------------------------------------------------------- placement
def _check_placement(sub, key):
    place, kv = sub[1]["reference"][key]
    got = [r[key] for r in _every(sub, "placement")]
    for rank, g in enumerate(got):
        assert g["place"] == place, (rank, key)
        for name, ranks in place.items():
            assert g["member"][name] == (rank in ranks)
            assert g["tp"][name] == len(ranks)
            # a member holds its share of the pool's KV, the reference's
            # per-device bytes; a rank outside the pool holds none
            assert g["kv"][name] == (kv[name] if rank in ranks else 0)
        # one shard set for each distinct submesh this rank is in, equal
        # to shard_params of the full weights
        assert set(g["shards"]) == {tuple(r) for r in place.values()
                                    if rank in r}
        assert g["exact"]
    return got


@pytest.mark.parametrize("k,tp", [(k, tp) for k in S.FLEETS
                                  for tp in S.PLACEMENT_TP])
def test_placement_equals_the_reference(sub, k, tp):
    """Pool i on submesh i % len(subs) on every rank, as the reference's
    ``device_placement()`` (K=3 at tp=2 wraps: [0, 1], [2, 3], [0, 1]);
    KV bytes a member equal the reference's per-device bytes; a rank
    holds the shard sets of its own submeshes only."""
    _check_placement(sub, (k, tp))


@pytest.mark.parametrize("new", S.REPROVISION_TP)
def test_reprovision_placement_equals_the_reference(sub, new):
    """The K=2 tp=2 fleet's long pool moved to tp=1 (rank 1, as the
    reference's rule puts it), then 4, then 2: the reference's placement
    and bytes after each; the old shard set freed once no pool uses it."""
    got = _check_placement(sub, (2, 2, new))
    want = {1: {0: [(0, 1)], 1: [(0, 1), (1,)], 2: [], 3: []},
            4: {r: ([(0, 1)] if r < 2 else []) + [(0, 1, 2, 3)]
                for r in range(WORLD)},
            2: {0: [(0, 1)], 1: [(0, 1)], 2: [(2, 3)], 3: [(2, 3)]}}[new]
    assert [sorted(g["shards"]) for g in got] == [sorted(want[r])
                                                  for r in range(WORLD)]


def test_weight_and_kv_bytes_a_rank(sub):
    """Weights a rank: the sharded leaves / tp plus the replicated ones,
    for its own submesh only; KV bytes a member x tp equal the tp=1
    pool's; a rank outside a pool holds none of its weights or cache."""
    res = _every(sub, "placement")
    tcfg = _cfgs()[1]
    full = {"short": res[0][(2, 1)]["kv"]["short"],
            "long": res[1][(2, 1)]["kv"]["long"]}
    assert res[0][(2, 1)]["shards"] == {
        (0,): chip_smoke._p18_shard_bytes(tcfg, 1)[0]}
    want = chip_smoke._p18_shard_bytes(tcfg, 2)[0]
    for rank, r in enumerate(res):
        g = r[(2, 2)]
        mine, other = ("short", "long") if rank < 2 else ("long", "short")
        assert g["kv"][mine] * 2 == full[mine]
        assert g["kv"][other] == 0
        assert g["shards"] == {(0, 1) if rank < 2 else (2, 3): want}
        assert g["exact"]


# ------------------------------------------------------------------ tokens
@pytest.mark.parametrize("case", S.TOKEN_CASES,
                         ids=[f"{i}-{'paged' if p else 'dense'}"
                              for i, p in S.TOKEN_CASES])
def test_two_tp2_pools_equal_the_jax_fleet(sub, case):
    """Two tp=2 pools through the gateway: every rank's tokens and routing
    decisions equal the JAX 1-device fleet's ("torch" against "xla",
    "kernel" against "pallas"); the in-band request is compressed into
    the short pool; both pools served."""
    decisions, want = sub[1][case]
    for rank, r in enumerate(_every(sub, "tokens")):
        got = r[case]
        assert got["decisions"] == decisions, rank
        assert got["tokens"] == want, rank
        assert all(got["tokens"][rid] for rid in want)
        assert got["dispatches"]["short"] > 0 and got["dispatches"]["long"]
    assert decisions[2][:2] == ("short", True)
    assert {d[0] for d in decisions} == {"short", "long"}


def test_routing_and_textrank_on_rank_zero(sub):
    """Rank 0 routes (the C&R compressor scores sentences there alone);
    the other ranks take its decisions."""
    calls = [[r[case]["calls"] for case in S.TOKEN_CASES]
             for r in _every(sub, "tokens")]
    assert all(n >= 1 for n in calls[0])
    assert all(n == 0 for r in calls[1:] for n in r)


def test_host_state_equal_on_every_rank(sub):
    """Every rank's host state (scheduler, host tier, allocator, prefix
    cache, counters) equals the others' after every engine step, members
    and ranks outside the pool alike."""
    res = _every(sub, "tokens")
    for case in S.TOKEN_CASES:
        first = res[0][case]["digests"]
        assert len(first) > 10
        assert all(r[case]["digests"] == first for r in res[1:]), case


# -------------------------------------------------------------- reprovision
@pytest.mark.parametrize("tp,new", S.MOVES,
                         ids=[f"{a}to{b}" for a, b in S.MOVES])
def test_reprovision_tp_mid_flight(sub, tp, new):
    """The long pool moved from tp to new mid-flight, a prefix-warm
    session turn in flight: the uninterrupted run's tokens on every rank,
    KV bytes a member x tp / new exactly, nothing recomputed (every
    checkpointed request swapped in), each moved host row's heads bitwise
    as the old members sent them, the new ranks' weights shard_params of
    the full weights, the same host state on every rank after every
    step."""
    res = [r[(tp, new)] for r in _every(sub, "moved")]
    plain = [r[(tp, None)] for r in _every(sub, "moved")]
    old_ranks = plain[0]["place"]["long"]
    new_ranks = res[0]["place"]["long"]
    want_new = {1: [1], 2: [2, 3], 4: [0, 1, 2, 3]}[new]
    assert new_ranks == want_new
    before = {r["before"] for i, r in enumerate(res) if i in old_ranks}
    assert len(before) == 1 and before.pop() > 0
    for rank, r in enumerate(res):
        assert r["tokens"] == plain[rank]["tokens"] == plain[0]["tokens"]
        assert r["hit_blocks"] > 0
        assert r["recomputed"] == 0
        assert r["info"]["checkpointed"] == r["swapped_in"] > 0
        assert r["digests"] == res[0]["digests"]
        assert r["member"] == (rank in new_ranks)
        if rank in new_ranks:
            assert r["after"] * new == res[old_ranks[0]]["before"] * tp
            assert r["exact"]
        else:
            assert r["after"] == 0 and r["exact"] is None
    # each moved leaf's old head ranges, as received, by crc
    for k, rec in enumerate(res[0]["moved_rows"]):
        sent = [res[i]["moved_rows"][k]["sent"] for i in old_ranks]
        for i in new_ranks:
            got = res[i]["moved_rows"][k]
            assert (got["rid"], got["leaf"]) == (rec["rid"], rec["leaf"])
            assert got["got"] == sent
    assert res[0]["moved_rows"]


def test_reprovision_to_a_degree_the_heads_do_not_divide_is_refused(sub):
    """2 kv heads cannot move to tp=4: refused up front, naming its later
    slice, the pool's engine and host state untouched, on every rank."""
    for said, unchanged in _every(sub, "refused"):
        assert "sharded-families slice" in said and unchanged


def test_reprovision_tokens_equal_across_degrees(sub):
    """The uninterrupted runs at tp=2 and tp=4 give the JAX 1-device
    fleet's tokens on the same session stream (paged, prefix cache,
    decode_k 4, eos), on every rank."""
    want = sub[1]["waves"]
    assert len(want) == 4 and all(want.values())
    for rank, runs in enumerate(_every(sub, "moved")):
        assert runs[(2, None)]["tokens"] == want, rank
        assert runs[(4, None)]["tokens"] == want, rank


# ------------------------------------------------------------------ crash
def test_recover_pool_on_its_submesh(sub):
    """The short pool killed while the long pool decodes: recover_pool
    rebuilds it on ranks 0-1 and re-routes its requests one pool up;
    every accepted request completes, and the long pool's own tokens
    equal the run without the fault, on every rank; that run's tokens are
    the JAX 1-device fleet's."""
    for rank, r in enumerate(_every(sub, "crash")):
        base, hit = r[False], r[True]
        assert base["tokens"] == sub[1]["crash"], rank
        assert hit["restarts"] == 1 and "killed_at" in hit["info"]
        assert hit["info"]["recovered"]["rerouted_to"] == "long"
        assert set(hit["tokens"]) == set(base["tokens"])
        assert all(hit["tokens"].values())
        longs = [rid for rid, p in base["pools"].items() if p == "long"]
        assert longs and all(hit["tokens"][rid] == base["tokens"][rid]
                             for rid in longs)
        assert hit["digests"] == _result(sub, "crash", 0)[True]["digests"]


# ---------------------------------------------------------------- launcher
def test_launcher_two_tp2_pools(sub):
    """``serve.py --fleet 2 --tp 2 --mesh 1x4``: rank 0 prints the tp=1
    launcher's lines but for the placement, which is the reference's
    (short on ranks 0-1, long on 2-3), and the wall time; the tokens are
    the tp=1 launcher's; the other ranks print nothing."""
    runs = _every(sub, "launcher")
    lines, toks, place = runs[0]
    ref_lines, ref_toks = sub[1]["launcher"]

    def plain(ls):
        return [ln.split(" in ")[0] if ln.startswith("served ") else ln
                for ln in ls if "tp=" not in ln]
    assert plain(lines) == plain(ref_lines)
    assert [ln for ln in lines if "tp=" in ln] \
        == sub[1]["reference"]["lines"] \
        == ["  short: tp=2 devices=[0, 1]", "  long: tp=2 devices=[2, 3]"]
    assert place == {"short": [0, 1], "long": [2, 3]}
    assert toks == ref_toks
    assert all(r[1] == toks and r[0] == [] for r in runs[1:])
