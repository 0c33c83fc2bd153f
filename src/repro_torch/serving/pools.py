"""K-pool serving runtime: the FleetOpt plan made executable, in PyTorch.

The port of ``repro/serving/pools.py``: the planner's boundary and gamma
vectors and per-pool sizing, the gateway router with the extractive
compressor (C&R), and one :class:`InferenceEngine` per pool (pool i
sized for its boundary's token budget, the top pool for c_max_long).
The boundary vector is enforced in software at the gateway, and the
hard OOM guarantee (Eq. 15) means no compressed request can overflow its
target pool's KV cache. ``TwoPoolRuntime`` is the paper's K=2 case;
``FleetRuntime.from_plan`` builds N engines from a ``FleetPlan``.

Every engine shares the ONE parameter set it is given (one copy on the
card). The compressor's TextRank runs on that card too, through the
CUDA kernel (``kernels/textrank.py``). One ServingConfig reaches every
engine: speculation, overload survival (preemption, the host KV tier,
queue-wait shedding) and output-length-aware reservation included; with
``lout_routing`` the gateway bands by predicted output length and clamps
the generation budget to the chosen pool's context.

Live re-provisioning: ``reprovision`` rebuilds one pool's engine with
another slot count or context window and migrates every in-flight
request through the host KV tier (``serving/reconfigure.py``); after a
crash, ``reconfigure.recover_pool`` rebuilds it and blacks the pool out
for a while (``pool_down_until``), during which ``submit`` raises
``PoolDownError``. ``reprovision_stats`` counts both.

Sharded serving: with ``mesh`` and ``tp_degree`` the mesh (every rank of
the process group, one process a rank: an SPMD program,
``distributed/context.py``) is carved into submeshes of ``tp_degree``
consecutive ranks (``launch/mesh.make_submeshes``), and pool i's engine
runs tensor-parallel on submesh ``i % len(subs)``, as the reference
places it: with fewer submeshes than pools the placement wraps round
robin and pools share a rank group (``device_placement`` maps each pool
to its ranks). A rank holds one shard set of the weights for each
distinct submesh it belongs to (``shards``; pools on one submesh share
it) and nothing of a pool outside its submesh. Every rank holds the same
requests and takes the same host decisions, for every pool: rank 0
routes each request (the C&R compressor and its TextRank launch run
there alone) and reads the blackout clock, and the ranks receive its
decision over the fleet's world context; a pool's readbacks reach the
ranks outside its submesh from the submesh's lead (``InferenceEngine.
_readback``). The pools step one after another on every rank.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.compression import ExtractiveCompressor
from repro_torch.core.naming import pool_names
from repro_torch.core.planner import FleetPlan
from repro_torch.core.router import GatewayRouter, RoutingDecision
from repro_torch.core.workload import (OutputLenPredictor, Request,
                                       get_workload)
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.context import (make_context, world_context,
                                             world_size)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import Mesh, make_submeshes
from repro_torch.serving import reconfigure
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import (InferenceEngine, ServeRequest,
                                        ServeResult)
from repro_torch.serving.tokenizer import ByteChunkTokenizer


@dataclasses.dataclass
class GatewayRequest:
    rid: int
    text: str
    max_output_tokens: int
    category: str = "prose"
    # opaque multi-turn session id (router session affinity)
    session: Optional[str] = None


@dataclasses.dataclass
class GatewayResponse:
    rid: int
    pool: str
    compressed: bool
    compression_ms: float
    output_tokens: List[int]
    prefill_iters: int
    decode_iters: int
    queue_iters: int
    shed: bool = False
    preemptions: int = 0
    # still in flight when run() hit its iteration cap: output_tokens
    # holds the partial prefix, and the request stays live on its engine
    timed_out: bool = False


class FleetRuntime:
    """N-pool gateway + engines.

    ``boundaries`` (tokens, strictly increasing) and ``gammas`` define
    the routing bands; ``n_maxes``/``c_maxes`` give each engine's slot
    count and context window — pool i's ``c_maxes[i]`` must be at least
    ``boundaries[i]`` so the no-OOM guarantee holds.
    """

    def __init__(self, cfg: ModelConfig, params,
                 boundaries: Sequence[int], gammas: Sequence[float],
                 n_maxes: Sequence[int], c_maxes: Sequence[int],
                 c_chunk: Optional[int] = None, *,
                 config: Optional[ServingConfig] = None,
                 lout_predictor: Optional[OutputLenPredictor] = None,
                 **overrides):
        scfg = config if config is not None else ServingConfig()
        if c_chunk is not None:
            overrides = dict(overrides, c_chunk=c_chunk)
        if overrides:
            scfg = scfg.replace(**overrides)
        self.config = scfg
        k = len(boundaries) + 1
        if len(n_maxes) != k or len(c_maxes) != k:
            raise ValueError(f"need {k} n_maxes/c_maxes for "
                             f"{len(boundaries)} boundaries")
        for i, b in enumerate(boundaries):
            if c_maxes[i] < b:
                raise ValueError(
                    f"pool {i} context {c_maxes[i]} < its boundary {b}: "
                    "compressed requests could overflow the KV cache")
        # -- placement: pool i on submesh i % len(subs) of tp_degree ranks
        self.tp_degree = scfg.tp_degree
        # the weights by the mesh of the engines that run them: the one
        # set of a fleet without a mesh under None; under a mesh, this
        # rank's shard set of each submesh it belongs to
        self.shards: Dict[Optional[Mesh], dict] = {}
        self.world = None
        places: List[Optional[Mesh]] = [None] * k
        if scfg.mesh is not None:
            if sorted(scfg.mesh.ranks) != list(range(world_size())):
                raise ValueError(
                    f"a fleet's mesh must span every rank of the "
                    f"{world_size()}-rank process group (every rank runs "
                    f"the fleet's host logic): {scfg.mesh}")
            self.world = world_context()
            subs = self.submeshes(scfg.tp_degree)
            places = [subs[i % len(subs)] for i in range(k)]
            for m in dict.fromkeys(places):
                ctx = make_context(m)
                if ctx.member:
                    self.shards[m] = SH.rank_shard(params, ctx,
                                                   cfg.vocab_size)
        else:
            self.shards[None] = params
        self.cfg = cfg
        self.tokenizer = ByteChunkTokenizer(cfg.vocab_size)
        # per-category output-length model, fed by record_completion;
        # lout_routing / lout_reservation default to the lmsys calibration
        self.lout_predictor = lout_predictor
        if self.lout_predictor is None and (scfg.lout_routing
                                            or scfg.lout_reservation):
            self.lout_predictor = OutputLenPredictor.from_workload(
                get_workload("lmsys"))
        # C&R scores sentences with TextRank on the params' device: the
        # CUDA kernel on its own stream on the card, the plain version
        # on the CPU
        device = self.device = params["embed"].device
        self.gateway_stream = (torch.cuda.Stream(device)
                               if device.type == "cuda" else None)
        scorer = functools.partial(ops.textrank_scores, device=device,
                                   stream=self.gateway_stream)
        self.router = GatewayRouter(
            boundaries=boundaries, gammas=gammas,
            compressor=ExtractiveCompressor(textrank_fn=scorer),
            lout_predictor=(self.lout_predictor
                            if scfg.lout_routing else None))
        names = pool_names(k)
        # engine rebuilds (reprovision, recover_pool) take these sets too,
        # never a second copy
        self.engines: Dict[str, InferenceEngine] = {
            names[i]: InferenceEngine(cfg, self.params_for(places[i]),
                                      n_maxes[i], c_maxes[i],
                                      config=scfg.replace(mesh=places[i],
                                                          tp_degree=1))
            for i in range(k)}
        self._decisions: Dict[int, RoutingDecision] = {}
        self._categories: Dict[int, str] = {}
        self.reprovision_stats = {"rebuilds": 0, "engine_restarts": 0,
                                  "migrated_requests": 0,
                                  "rerouted_requests": 0,
                                  "autoscale_actions": 0}
        # pool -> monotonic deadline while crash recovery blacks it out
        self.pool_down_until: Dict[str, float] = {}
        # one crc record a host KV leaf moved between submeshes by a
        # reprovision or a recovery, oldest first (reconfigure._reshard_kv)
        self.moved_rows: List[dict] = []
        # per-pool GPU counts of the plan this fleet was provisioned from
        # (from_plan sets it): the re-planner's hysteresis baseline
        self.plan_pool_gpus: Optional[List[int]] = None
        # demo tokens per datacenter token when from_plan shrank the
        # boundaries (1.0 = native scale): the re-planner plans at
        # datacenter scale, where the hardware profiles are calibrated
        self.ctx_scale = 1.0

    def device_placement(self) -> Dict[str, List[int]]:
        """pool name -> the global ranks its engine spans (one rank on a
        runtime without a mesh), the same on every rank."""
        return {name: eng.devices() for name, eng in self.engines.items()}

    def submeshes(self, tp: int) -> List[Mesh]:
        """The fleet mesh's submeshes of ``tp`` ranks, each with its
        context made: every rank makes all of them, in order, at the same
        point (their process groups are made by every rank together)."""
        subs = make_submeshes(self.config.mesh, tp)
        for m in subs:
            make_context(m)
        return subs

    def params_for(self, mesh: Optional[Mesh]):
        """The weights an engine on ``mesh`` runs on this rank: the fleet's
        one set without a mesh, this rank's shard set of ``mesh``, or None
        on a rank outside it."""
        return self.shards.get(mesh)

    def drop_unused_shards(self) -> None:
        """Free the shard sets of submeshes no engine runs on any more."""
        used = {eng.mesh for eng in self.engines.values()}
        for m in [m for m in self.shards if m not in used]:
            del self.shards[m]

    def _route(self, r: Request, req: GatewayRequest):
        """(routing decision, seconds left of the pool's blackout or
        None): taken on rank 0 and received by every other rank of a
        sharded fleet over its world context, so every rank enqueues the
        same request on the same pool (the compressor's kept sentences
        and the blackout clock are rank 0's)."""
        par = self.world
        if par is None or par.rank == par.lead:
            d = self.router.route(r, prompt_text=req.text,
                                  session=req.session)
            left = (self.pool_down_until[d.pool] - time.monotonic()
                    if d.pool in self.pool_down_until else None)
            out = (d, left)
        else:
            out = None
        return out if par is None else par.broadcast_object(out)

    @classmethod
    def from_plan(cls, cfg: ModelConfig, params, plan: FleetPlan,
                  slots_per_pool: int = 4, c_chunk: int = 64,
                  ctx_scale: Optional[float] = None, *,
                  config: Optional[ServingConfig] = None,
                  lout_predictor: Optional[OutputLenPredictor] = None,
                  **overrides) -> "FleetRuntime":
        """Build a runtime with the plan's boundary/gamma structure.

        The plan's per-GPU slot counts target datacenter hardware; a
        local runtime caps each pool at ``slots_per_pool`` engine slots.
        ``ctx_scale`` shrinks the token boundaries (e.g. ``4096 / 65536``
        serves a 64K plan with a 4096-token long pool); boundaries are
        kept >= 2 * c_chunk so the chunked prefill path stays exercised.
        """
        scale = ctx_scale if ctx_scale is not None else 1.0
        bounds = []
        for b in plan.boundaries:
            bounds.append(max(int(b * scale), 2 * c_chunk,
                              (bounds or [0])[-1] + 1))
        c_top = max(int(plan.pools[-1].c_max * scale),
                    (bounds[-1] if bounds else 2 * c_chunk) * 2)
        c_maxes = tuple(bounds) + (c_top,)
        n_maxes = tuple(min(slots_per_pool, max(1, pp.n_max))
                        for pp in plan.pools)
        rt = cls(cfg, params, tuple(bounds), plan.gammas, n_maxes,
                 c_maxes, c_chunk, config=config,
                 lout_predictor=lout_predictor, **overrides)
        rt.ctx_scale = scale
        rt.plan_pool_gpus = [pp.n_gpus for pp in plan.pools]
        return rt

    def submit(self, req: GatewayRequest) -> RoutingDecision:
        """Route one request through the gateway and enqueue it on the
        chosen pool's engine. Returns the routing decision.

        With ``lout_routing`` the router banded by PREDICTED output
        length, so the generation budget is clamped to what the chosen
        pool's context holds. With ``lout_reservation`` the engine request
        carries the prediction as its KV reservation hint."""
        prompt_tokens = self.tokenizer.count(req.text)
        r = Request(l_total=prompt_tokens + req.max_output_tokens,
                    l_in=prompt_tokens, l_out=req.max_output_tokens,
                    category=req.category,
                    prompt_bytes=len(req.text.encode("utf-8")))
        decision, left = self._route(r, req)
        if left is not None:
            if left > 0:
                # crash-recovery blackout: refuse with the wait a gateway
                # maps to 503 + Retry-After
                raise reconfigure.PoolDownError(decision.pool, left)
            self.pool_down_until.pop(decision.pool, None)
        text = decision.compressed_text if decision.compressed else req.text
        ids = self.tokenizer.encode(text)
        max_new = req.max_output_tokens
        if self.config.lout_routing:
            budget = self.engines[decision.pool].c_max - len(ids)
            max_new = max(1, min(max_new, budget))
        hint = None
        if self.config.lout_reservation:
            hint = self.lout_predictor.predict(len(ids),
                                               category=req.category,
                                               cap=max_new)
        self.engines[decision.pool].submit(ServeRequest(
            rid=req.rid, tokens=ids, max_new_tokens=max_new,
            category=req.category, l_out_hint=hint))
        self._decisions[req.rid] = decision
        self._categories[req.rid] = req.category
        # feed the bytes-per-token EMA with the true tokenizer count
        self.router.ema.update(req.category, len(text.encode("utf-8")),
                               len(ids))
        return decision

    def record_completion(self, rid: int, res: ServeResult) -> None:
        """Feed a finished request's actual output length into the
        output-length model. No-op without a predictor or for
        shed/empty results."""
        if self.lout_predictor is None or res.shed \
                or not res.output_tokens:
            return
        d = self._decisions.get(rid)
        if d is not None:
            self.lout_predictor.update(d.l_in_effective,
                                       len(res.output_tokens),
                                       category=self._categories.get(rid))

    def reprovision(self, pool: str, *, n_max: Optional[int] = None,
                    c_max: Optional[int] = None,
                    tp: Optional[int] = None) -> Dict[str, object]:
        """Rebuild one pool's engine with a new slot count or context,
        migrating every in-flight request through the host KV tier with
        the tokens of an uninterrupted run; ``tp`` moves it onto the fleet
        mesh's submesh of that degree (``reconfigure.reprovision``)."""
        return reconfigure.reprovision(self, pool, n_max=n_max,
                                       c_max=c_max, tp=tp)

    def release(self, rid: int) -> None:
        """Drop every host-side record of a consumed request."""
        for eng in self.engines.values():
            eng.results.pop(rid, None)
        self._decisions.pop(rid, None)
        self._categories.pop(rid, None)

    def _response(self, rid: int, res: ServeResult,
                  timed_out: bool = False) -> GatewayResponse:
        d = self._decisions[rid]
        return GatewayResponse(
            rid=rid, pool=d.pool, compressed=d.compressed,
            compression_ms=d.compression_ms,
            output_tokens=res.output_tokens,
            prefill_iters=res.prefill_iters,
            decode_iters=res.decode_iters, queue_iters=res.queue_iters,
            shed=res.shed, preemptions=res.preemptions,
            timed_out=timed_out)

    def run(self, max_iters: int = 100_000) -> Dict[int, GatewayResponse]:
        """Drive all pools to completion, interleaving their lockstep
        iterations. Finished requests are consumed (:meth:`release`), shed
        ones included (``shed=True``, no tokens); requests still in flight
        at the iteration cap, preempted ones in the host tier included,
        come back as ``timed_out=True`` responses with their partial
        tokens and stay live on their engines."""
        out: Dict[int, GatewayResponse] = {}
        busy = True
        while busy:
            busy = False
            for eng in self.engines.values():
                if eng.busy() and eng.iteration < max_iters:
                    eng.step()
                    busy = True
        for eng in self.engines.values():
            for rid, res in list(eng.results.items()):
                self.record_completion(rid, res)
                out[rid] = self._response(rid, res)
                self.release(rid)
        for eng in self.engines.values():
            live = [(eng.slot_req[s], list(eng.slot_out[s]))
                    for s in range(eng.n_max) if eng.slot_req[s] is not None]
            for req in eng.waiting:
                st = eng._preempted.get(req.rid)
                live.append((req, list(st.out) if st else []))
            for req, toks in live:
                if req.rid in out:
                    continue
                out[req.rid] = self._response(req.rid, ServeResult(
                    rid=req.rid, output_tokens=toks,
                    prefill_iters=eng._prefill_iters.get(req.rid, 0),
                    decode_iters=len(toks),
                    queue_iters=eng._queue_iters.get(req.rid, 0),
                    preemptions=eng._rid_preemptions.get(req.rid, 0)),
                    timed_out=True)
        return out


class TwoPoolRuntime(FleetRuntime):
    """The paper's two-pool runtime (K=2 view of :class:`FleetRuntime`)."""

    def __init__(self, cfg: ModelConfig, params, b_short: int, gamma: float,
                 n_max_short: int, n_max_long: int, c_max_long: int,
                 c_chunk: Optional[int] = None, *,
                 config: Optional[ServingConfig] = None,
                 lout_predictor: Optional[OutputLenPredictor] = None,
                 **overrides):
        super().__init__(cfg, params, boundaries=(b_short,),
                         gammas=(gamma,),
                         n_maxes=(n_max_short, n_max_long),
                         c_maxes=(b_short, c_max_long), c_chunk=c_chunk,
                         config=config, lout_predictor=lout_predictor,
                         **overrides)
