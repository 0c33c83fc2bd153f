"""Live fleet re-provisioning and fault injection, in PyTorch: the port of
``repro/serving/reconfigure.py``.

``reprovision`` tears a loaded engine down and rebuilds it with another
slot count, context window or tensor-parallel degree without dropping an
in-flight request:

    quiesce -> checkpoint -> rebuild -> restore

1. quiesce: ``drain_checkpoint`` preempts every occupied slot through
   the host KV tier (swap or recompute by the cold-suffix threshold;
   mid-prefill slots go onto the recompute path) and requeues them in
   slot order ahead of the waiting arrivals.
2. checkpoint: each ``_PreemptedState`` carries the emitted tokens, the
   replay token list and, on the swap path, the slot's exact KV bits as
   CPU tensors.
3. rebuild: a new ``InferenceEngine`` over the runtime's one parameter
   set (``runtime.params_for(None)``, already on the card: no second
   copy), or, under a mesh, over this rank's shard set of the engine's
   submesh.
4. restore: checkpointed requests move ahead of queued ones;
   ``_adopt_state`` fits swap-path KV to the new geometry (dense rows are
   zero-padded or truncated along the seq axis on the host; paged blocks
   move unchanged) and falls back to recompute when it cannot.

Resume gives the tokens of an uninterrupted run: a slot's tokens do not
depend on its co-tenants (masked rows are no-ops), the swap path
restores exact KV bits, and the recompute path replays the exact tokens
whose KV sat at positions 0..pos-1; every pool shares one set of params
and one prefill chunking.

The same machinery survives unplanned teardown: ``FaultInjector`` kills
an engine (device state lost, host bookkeeping kept), exhausts its paged
allocator, or wedges ``step()``; ``HealthPolicy`` detects the stall; and
``recover_pool`` salvages every accepted request from host mirrors only
and re-routes them one pool up, where the no-OOM guarantee holds by
construction (band_i requests fit pool i+1's larger context).

A sharded fleet (``FleetRuntime(mesh=, tp_degree=)``, each pool on a
submesh of its own) re-provisions and recovers on every rank alike:
every rank runs the same steps and salvages the same host states, and a
member of the engine's submesh rebuilds its part over its shard set.
``reprovision(tp=)`` moves the pool onto the fleet mesh's submesh of
that degree, pool i on ``make_submeshes(mesh, tp)[i % len(subs)]`` as
the reference places it. The reference re-shards from pristine host
params and scatters a full host KV copy into any submesh; the port keeps
only rank shards, so the move is an exchange over the fleet's world
context: each rank of the new submesh receives its slice of each weight
leaf from the old submesh's slices, one leaf at a time
(``reshard_params``); each swapped request's host rows are made
whole along the kv-head axis from the old members' heads and split for
the new degree, bitwise (``_reshard_kv``), so no request falls back to
the recompute path. A request that moves between pools on different
submeshes (a misfit re-routed one pool up, a salvaged one after a crash)
has its rows moved the same way.
"""
from __future__ import annotations

import dataclasses
import math
import time
import zlib
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.distributed import sharding as SH
from repro_torch.distributed.context import make_context, world_context
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as M
from repro_torch.serving.engine import (InferenceEngine, ServeRequest,
                                        _PreemptedState)

# the kv-head axis of each host KV leaf, counted from its end (the
# serving cache's split, ``sharding.serving_cache_specs``)
_HEAD_AXIS = {"k": -2, "v": -2, "k_scale": -1, "v_scale": -1}


class PoolDownError(RuntimeError):
    """Submission refused: the target pool is inside a re-provisioning or
    crash-recovery blackout window. Carries the seconds a client should
    wait (a gateway maps this to 503 + Retry-After)."""

    def __init__(self, pool: str, retry_after: float):
        super().__init__(f"pool {pool} is re-provisioning; "
                         f"retry after {retry_after:.2f}s")
        self.pool = pool
        self.retry_after = retry_after


# --------------------------------------------------------------- migration
def _fits(req: ServeRequest, c_max: int, paged: bool, block_size: int,
          num_blocks: int) -> bool:
    """Would ``req`` (fresh or resumed: the replay list plus the remaining
    budget span the same len(tokens) + max_new_tokens positions) fit an
    engine of this geometry at all?"""
    total = len(req.tokens) + req.max_new_tokens
    if total > c_max:
        return False
    if paged and math.ceil(total / block_size) > num_blocks:
        return False
    return True


def _fit_seq(h: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """Zero-pad or truncate a dense host KV row to ``n`` positions along
    its seq axis, on the host. Bitwise-safe either way: positions >= pos
    are never attended (the mask ends at pos), and pos <= the fit-checked
    len(tokens) + max_new_tokens <= n on the truncation path. A windowed
    row is a ring of min(c_max, window) entries; where that length
    changes, one of the two c_max is below the window and every request
    fits it, so no position has wrapped: p % length == p on both sides."""
    if h.shape[axis] == n:
        return h
    if h.shape[axis] > n:
        return h.narrow(axis, 0, n).clone()
    shape = list(h.shape)
    shape[axis] = n - h.shape[axis]
    return torch.cat([h, h.new_zeros(shape)], dim=axis)


def _adopt_state(state: _PreemptedState, src: InferenceEngine,
                 dst: InferenceEngine) -> _PreemptedState:
    """Fit a host checkpoint taken on ``src`` to ``dst``'s cache geometry.
    Paged blocks move unchanged (the block size is fleet-uniform); dense
    KV rows, (L, S, ...) per leaf (``layers.gather_slot_row``; int8 scales
    too; MLA's latent "c_kv" / "k_r"), pad or truncate along axis 1 to
    ``dst``'s row length, read off its cache's leaves: c_max, or the
    ring's min(c_max, window). A VLM row's cross memory ("xk" / "xv",
    (n_groups, F, Hkv, hd)) moves unchanged: F is the frontend's length,
    not the context's. (The JAX package fits a ring row to c_max, which
    no ring of a window below the new c_max can take, and fits the cross
    memory's F axis to c_max, which no cross cache of F rows can take:
    both swap-ins raise.) Any other mismatch falls back to the recompute
    path: replay and last_tok are kept on both preemption paths so this
    conversion is always available."""
    if state.host_kv is None:
        return state
    if src.paged and dst.paged and src.block_size == dst.block_size \
            and state.n_blocks <= dst.blocks_per_slot:
        return state
    if not src.paged and not dst.paged:
        if not dst.member:
            return state             # no rows on this rank to fit
        n = next(iter(dst.cache["kv"].values())).shape[2]
        kv = {k: h if k in ("xk", "xv") else _fit_seq(h, 1, n)
              for k, h in state.host_kv.items()}
        return dataclasses.replace(state, host_kv=kv)
    return dataclasses.replace(state, host_kv=None, n_blocks=0, pos=0)


def _crc(t: torch.Tensor) -> int:
    return zlib.crc32(t.contiguous().reshape(-1).view(torch.uint8)
                      .numpy().tobytes())


def _reshard_kv(state: _PreemptedState, src: InferenceEngine,
                dst: InferenceEngine, log: Optional[list] = None
                ) -> _PreemptedState:
    """A swapped request's host rows moved from ``src``'s submesh to
    ``dst``'s: each leaf made whole along its kv-head axis from the old
    members' heads (over the world context, every rank taking part),
    and each new member keeping its heads for ``dst``'s degree; a rank
    outside ``dst``'s submesh keeps an empty dict. Bitwise: raw bytes
    move. Paged blocks and dense rows alike, int8 scales included.
    ``log`` gets one record a leaf: the crc32 of each old member's rows
    as sent ("sent", on an old member) and of each old member's head
    range of the whole as received ("got", on a new member)."""
    if state.host_kv is None or src.mesh == dst.mesh:
        return state
    world = world_context()
    mine = None
    if src.member and src.parallel.rank == src.parallel.lead:
        mine = {k: (tuple(h.shape), h.dtype)
                for k, h in state.host_kv.items()}
    layout = world.gather_object(mine)[src.parallel.lead]
    rows = {}
    for k, (shape, dtype) in layout.items():
        axis = _HEAD_AXIS[k] % len(shape)
        part = state.host_kv[k] if src.member else None
        whole = world.gather_whole(part, src.devices(), dst.devices(),
                                   shape, dtype, axis, "cpu")
        rec = {"rid": state.req.rid, "leaf": k,
               "sent": _crc(part) if part is not None else None,
               "got": None}
        if whole is not None:
            h = shape[axis]
            rec["got"] = [_crc(whole.narrow(axis, j * h, h))
                          for j in range(len(src.devices()))]
            n = whole.shape[axis] // dst.tp_degree
            rows[k] = whole.narrow(axis, dst.parallel.model_rank * n,
                                   n).clone()
        if log is not None:
            log.append(rec)
    return dataclasses.replace(state, host_kv=rows)


def reshard_params(params, src: Mesh, dst: Mesh, device):
    """This rank's shard set of ``dst`` (None outside it), built from
    ``src``'s shards (``params``: this rank's, None outside ``src``) one
    leaf at a time over the world context, every rank taking part: each
    of ``dst``'s ranks receives its own slice of the leaf from the slices
    ``src``'s ranks hold (``ParallelContext.gather_whole`` with ``keep``).
    ``src``'s lead publishes the leaves' paths, shapes and dtypes; a leaf
    is split along the dim the partition rules pick at any degree that
    divides the widths (the model's check refuses the others), the same
    dim at both degrees, so no unsharded tree is drawn and no rank holds
    more of a leaf than its new slice; no host copy is made."""
    world, old, new = world_context(), make_context(src), make_context(dst)
    mine = []
    if old.member and old.rank == old.lead:
        SH._map_with_path(lambda path, a: mine.append(
            (path, tuple(a.shape), a.dtype)), params)
    out: dict = {}
    for path, shape, dtype in world.gather_object(mine)[old.lead]:
        spec = SH.param_spec(path, torch.empty(shape, device="meta"),
                             old.model_axis, 1)
        split = [d for d, e in enumerate(spec) if e is not None]
        axis = split[0] if split and old.tp > 1 else None
        keep = None
        if split and new.tp > 1 and new.member:
            n = shape[split[0]] * (old.tp if axis is not None else 1) \
                // new.tp
            keep = (split[0], new.model_rank * n, (new.model_rank + 1) * n)
        part = params
        for key in path if old.member else ():
            part = part[key]
        got = world.gather_whole(part if old.member else None, src.ranks,
                                 dst.ranks, shape, dtype, axis, device, keep)
        if got is not None:
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = got
    return out if new.member else None


def _move_request(src: InferenceEngine, dst: InferenceEngine,
                  req: ServeRequest,
                  state: Optional[_PreemptedState],
                  log: Optional[list] = None) -> None:
    """Move one queued or checkpointed request from ``src`` to the tail of
    ``dst``'s queue with its accounting (a swapped request's host rows
    resharded to ``dst``'s submesh, :func:`_reshard_kv`). The enqueue
    time is re-keyed to ``dst``'s iteration clock."""
    rid = req.rid
    if state is not None:
        state = _reshard_kv(state, src, dst, log)
        dst._preempted[rid] = _adopt_state(state, src, dst)
    dst.waiting.append(req)
    dst._enqueued_at[rid] = dst.iteration
    src._enqueued_at.pop(rid, None)
    for attr in ("_queue_iters", "_prefill_iters", "_rid_preemptions"):
        v = getattr(src, attr).pop(rid, None)
        if v is not None:
            d = getattr(dst, attr)
            d[rid] = d.get(rid, 0) + v
    src._preempted.pop(rid, None)
    src._req_hashes.pop(rid, None)
    src._hol_bypassed.pop(rid, None)
    src._resume_last_tok.pop(rid, None)


def reprovision(runtime, pool: str, *, n_max: Optional[int] = None,
                c_max: Optional[int] = None,
                tp: Optional[int] = None) -> Dict[str, object]:
    """Rebuild ``runtime.engines[pool]`` with a new slot count, context
    window or tensor-parallel degree (``tp``: the fleet mesh's submesh of
    that degree, pool i on ``make_submeshes(mesh, tp)[i % len(subs)]``),
    migrating every in-flight and queued request with the tokens of an
    uninterrupted run. A new submesh's weights are resharded from the old
    one's (:func:`reshard_params`) unless another pool already runs on
    it, and the old shard set is freed once no pool uses it.

    In-flight requests the new geometry cannot hold re-route one pool up
    (their band fits the larger pool by construction); shrinking the TOP
    pool below an in-flight request's footprint, and a ``tp`` the mesh
    cannot be carved by, are refused up front, before any state is
    touched. Every rank of a sharded fleet calls this at the same point;
    each host leaf moved to another submesh adds its crc record
    (:func:`_reshard_kv`) to ``runtime.moved_rows``."""
    names = list(runtime.engines)
    if pool not in runtime.engines:
        raise KeyError(f"unknown pool {pool!r} (have {names})")
    i = names.index(pool)
    old = runtime.engines[pool]
    new_n = old.n_max if n_max is None else int(n_max)
    new_c = old.c_max if c_max is None else int(c_max)
    if new_n < 1:
        raise ValueError(f"n_max must be >= 1, got {new_n}")
    bounds = runtime.router.boundaries
    if i < len(bounds) and new_c < bounds[i]:
        raise ValueError(
            f"pool {pool} context {new_c} < its routing boundary "
            f"{bounds[i]}: compressed requests could overflow the KV "
            "cache (shrink the boundary first)")
    ecfg = old.config
    if tp is not None:
        if runtime.config.mesh is None:
            raise ValueError("tp re-provisioning needs a fleet mesh")
        subs = runtime.submeshes(int(tp))
        ecfg = ecfg.replace(mesh=subs[i % len(subs)])
        # a degree the widths do not divide is refused here, not by the
        # new engine after the drain
        M.check_supported(runtime.cfg, parallel=make_context(ecfg.mesh))
    # misfit scan before any mutation: a request the new geometry can
    # never hold must have somewhere to go
    block = ecfg.block_size
    nb = ecfg.num_blocks if ecfg.num_blocks is not None \
        else new_n * math.ceil(new_c / block)
    inflight = [r for r in old.slot_req if r is not None] + list(old.waiting)
    misfits = {r.rid for r in inflight
               if not _fits(r, new_c, ecfg.paged, block, nb)}
    if misfits and i + 1 >= len(names):
        raise ValueError(
            f"shrinking top pool {pool} to c_max={new_c} would orphan "
            f"{len(misfits)} in-flight request(s); drain them first")
    # quiesce: checkpoint every occupied slot into the host tier, requeued
    # in slot order ahead of the waiting arrivals
    checkpointed = old.drain_checkpoint()
    if ecfg.mesh not in {e.mesh for e in runtime.engines.values()}:
        shard = reshard_params(runtime.params_for(old.mesh), old.mesh,
                               ecfg.mesh, runtime.device)
        if shard is not None:
            runtime.shards[ecfg.mesh] = shard
    new_eng = InferenceEngine(runtime.cfg, runtime.params_for(ecfg.mesh),
                              new_n, new_c, config=ecfg)
    up = runtime.engines[names[i + 1]] if i + 1 < len(names) else None
    migrated = rerouted = 0
    moved = runtime.moved_rows
    for req in list(old.waiting):
        state = old._preempted.get(req.rid)
        if req.rid in misfits:
            _move_request(old, up, req, state, moved)
            rerouted += 1
            d = runtime._decisions.get(req.rid)
            if d is not None:
                d.pool = names[i + 1]
        else:
            _move_request(old, new_eng, req, state, moved)
        migrated += 1
    old.waiting.clear()
    # unconsumed finished results follow the pool name
    new_eng.results.update(old.results)
    old.results.clear()
    # the swap: the router's pool name maps to the new engine from the
    # next submit or step on
    runtime.engines[pool] = new_eng
    runtime.drop_unused_shards()
    stats = runtime.reprovision_stats
    stats["rebuilds"] += 1
    stats["migrated_requests"] += migrated
    stats["rerouted_requests"] += rerouted
    return {"pool": pool, "checkpointed": checkpointed,
            "migrated": migrated, "rerouted": rerouted,
            "n_max": new_n, "c_max": new_c}


# ----------------------------------------------------------- fault recovery
def salvage_states(
        eng: InferenceEngine,
) -> List[Tuple[ServeRequest, Optional[_PreemptedState]]]:
    """Read every accepted request out of a DEAD engine from host mirrors
    only: its device KV is gone, and the allocator counters may be
    mid-update (the oom fault raises from inside ``_alloc_block``), so
    nothing here calls into the engine or reads its cache or paged
    bookkeeping.

    Slot occupants come first, in slot order, as recompute-path
    checkpoints (the replay list and the last fed token rebuilt as
    ``preempt_slot`` would); then the queue in order, where checkpointed
    requests keep their host swap copies, which survived the crash.

    A slot is mid-prefill while its KV does not cover its replay list
    (``slot_pos < len(replay)``), not only while ``slot_prefill_left``
    is non-empty: ``step()`` takes a slot's chunk off that list before
    it allocates the chunk's blocks, so an oom raised there leaves a
    slot whose final chunk never ran with an empty list. (The JAX
    package tests the list alone and feeds such a request a stale token
    after recovery.)"""
    out: List[Tuple[ServeRequest, Optional[_PreemptedState]]] = []
    for s in range(eng.n_max):
        req = eng.slot_req[s]
        if req is None:
            continue
        emitted = list(eng.slot_out[s])
        replay = InferenceEngine._replay_tokens(req, emitted)
        if int(eng.slot_pos[s]) < len(replay):
            # mid-prefill: a resumed replay parked its next fed token; a
            # fresh prefill feeds the last prompt token, replay[-1]
            last = eng._resume_last_tok.get(req.rid)
            if last is None:
                last = int(replay[-1]) if replay else 0
        else:
            last = int(eng.slot_last_tok[s])
        out.append((req, _PreemptedState(
            req=req, out=emitted, pos=0, last_tok=int(last),
            replay=replay, host_kv=None, n_blocks=0)))
    for req in eng.waiting:
        out.append((req, eng._preempted.get(req.rid)))
    return out


def recover_pool(runtime, pool: str, *,
                 blackout_s: float = 0.0) -> Dict[str, object]:
    """Crash recovery for ``pool``: salvage every accepted request from the
    dead engine's host mirrors, rebuild the engine at its provisioned
    shape, and re-route the salvaged requests ONE POOL UP (band_i requests
    fit pool i+1's larger context). The top pool restores into its own
    rebuilt engine, on its own submesh over that submesh's shard set. New
    submissions to the pool raise ``PoolDownError`` until ``blackout_s``
    has elapsed."""
    names = list(runtime.engines)
    if pool not in runtime.engines:
        raise KeyError(f"unknown pool {pool!r} (have {names})")
    i = names.index(pool)
    old = runtime.engines[pool]
    salvaged = salvage_states(old)
    new_eng = InferenceEngine(runtime.cfg, runtime.params_for(old.mesh),
                              old.n_max, old.c_max, config=old.config)
    up_name = names[i + 1] if i + 1 < len(names) else pool
    migrated = 0
    for req, state in salvaged:
        dst = new_eng if up_name == pool else runtime.engines[up_name]
        _move_request(old, dst, req, state, runtime.moved_rows)
        migrated += 1
        if up_name != pool:
            d = runtime._decisions.get(req.rid)
            if d is not None:
                d.pool = up_name
    # finished but unconsumed results survived on the host
    new_eng.results.update(old.results)
    old.results.clear()
    runtime.engines[pool] = new_eng
    runtime.pool_down_until[pool] = time.monotonic() + blackout_s
    runtime.reprovision_stats["engine_restarts"] += 1
    runtime.reprovision_stats["migrated_requests"] += migrated
    return {"pool": pool, "migrated": migrated, "rerouted_to": up_name,
            "blackout_s": blackout_s}


class FaultInjector:
    """Inject faults into a live pool's engine (tests, smoke runs).

    * ``kill``: the device state is lost; the next ``step()`` raises
      ``EngineDead``. Host bookkeeping (queue, emitted-token mirrors, the
      host KV tier) survives for salvage.
    * ``exhaust_allocator``: the next paged block allocation raises
      ``EngineDead`` from inside the allocator, leaving its counters
      inconsistent, which is why salvage reads host mirrors only.
    * ``wedge``: ``step()`` returns without advancing the iteration clock,
      the stall ``HealthPolicy`` detects.
    """

    def __init__(self, runtime):
        self.runtime = runtime

    def kill(self, pool: str) -> None:
        self.runtime.engines[pool]._fault = "killed"

    def exhaust_allocator(self, pool: str) -> None:
        eng = self.runtime.engines[pool]
        if not eng.paged:
            raise ValueError("allocator-exhaustion fault needs paged mode")
        eng._fault = "oom"

    def wedge(self, pool: str) -> None:
        self.runtime.engines[pool]._fault = "wedged"

    def clear(self, pool: str) -> None:
        self.runtime.engines[pool]._fault = None


class HealthPolicy:
    """Stall detector for a drive loop: an engine that is busy and being
    stepped but whose iteration clock has not advanced for ``patience``
    consecutive checks is wedged (a healthy ``step()`` always advances
    the clock). Crashes raise ``EngineDead`` and need no detector."""

    def __init__(self, patience: int = 3):
        self.patience = max(1, int(patience))
        self._seen: Dict[str, Tuple[int, int]] = {}

    def check(self, runtime) -> List[str]:
        """Call once per drive pass, after stepping the busy engines;
        returns the pools judged wedged (their strikes reset, so a
        recovered pool starts afresh)."""
        wedged = []
        for name, eng in runtime.engines.items():
            if not eng.busy():
                self._seen.pop(name, None)
                continue
            last_it, strikes = self._seen.get(name, (-1, 0))
            strikes = strikes + 1 if eng.iteration == last_it else 0
            if strikes >= self.patience:
                wedged.append(name)
                self._seen.pop(name, None)
            else:
                self._seen[name] = (eng.iteration, strikes)
        return wedged
