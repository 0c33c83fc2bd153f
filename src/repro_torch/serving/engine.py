"""Continuous-batching inference engine (paper §3.1's service model), in
PyTorch: the main-path subset of ``repro/serving/engine.py``.

One engine == one pool's GPU: ``n_max`` KV slots advance in lockstep;
each ``step()`` is one iteration (one decode token for every active
slot), with prefill chunked at ``c_chunk`` tokens per iteration. The
engine runs on the device its parameters live on.

The step path keeps the JAX engine's shape:

  * fixed-shape decode over all ``n_max`` rows, where a per-row active
    mask makes empty and mid-prefill slots bitwise no-ops on the cache;
  * prefill chunks padded to power-of-two buckets up to ``c_chunk``,
    every slot with a pending chunk advanced in ONE batched call;
  * ONE dispatch per step: mixed iterations fuse the prefill and decode
    advances (``M.mixed_step``); decode-only iterations with
    ``decode_k > 1`` run a micro-loop of K device steps in which argmax
    and the EOS / budget / c_max stops stay on the device, and the only
    host traffic is one (n_max, K) copy of the emitted tokens. The slot
    state (last token, position, active, budget) stays on the device
    between dispatches and is re-uploaded only when host bookkeeping
    marked it dirty. Output tokens equal the K=1 path's bitwise.

Two KV layouts: DENSE (one ``(n_max, c_max)`` row per slot) and PAGED
(``paged=True``: a shared block pool plus per-slot block tables, with a
host free list that reserves each admitted request's worst-case blocks
and a bounded out-of-order admission window, ``hol_window``, for when
the FIFO head cannot be placed). Paged reproduces dense tokens exactly.
The dense layout also serves the int8 KV cache (values plus per-token
scales; the host tier moves every leaf) and a sliding window (each row
a ring of min(c_max, window) entries, prefilled token by token), as in
the JAX engine; the paged pool refuses both, and a window refuses
``spec_k > 1``.

The paged layout can share prompt prefixes (``prefix_cache=True``): full
prompt blocks are registered under a chained content hash once prefill
has written them; a later request whose leading blocks hash the same
maps those physical blocks into its table (ref-counted, read-only) and
prefills from its first cold token. A released block that holds a
registered prefix stays cached in an LRU tier, evicted only when the
free list runs dry. The pool's sink block (past ``num_blocks``, where
masked writes land) is never allocated, registered or evicted.

Self-speculative decoding (``spec_k = W > 1``): the host proposes one
n-gram draft continuation per slot and dispatch (``serving/draft.py``),
uploaded as one (n_max, K*W - 1) table; each of the K device steps
feeds [last token, next W-1 drafts] through the masked multi-token
verify step (``M.verify_step``: the fused chunk with the LM head over
every position) and accepts the longest draft prefix equal to the
model's own greedy argmax, so the tokens are the plain run's. Gather,
argmax, cumprod accept, EOS truncation, the draft cursor and the budget
/ context stops stay on the device; one (K, n_max, W+1) copy per
dispatch carries the emitted tokens and the drafts fed.

Overload survival: when paged admission would defer, ``preemption``
preempts the most recently admitted decoding slot (LIFO), moving its KV
to a host-RAM tier (swap: a copy of exactly its blocks, or of its dense
row) or discarding it for replay through prefill (recompute, when the
cold suffix is at most ``swap_threshold`` tokens); preempted requests
re-enter the queue ahead of new arrivals and resume with the tokens of
an unloaded run. ``max_queue_wait`` sheds an arrival whose estimated
queue wait (queue depth over the rolling service rate) exceeds it.
``lout_reservation`` reserves a fresh request's predicted footprint
(``l_out_hint``) instead of its worst case; a request that outruns it
preempts (``_reservation_breach``), never runs the pool dry.

Fault hooks for live re-provisioning and crash recovery
(``serving/reconfigure.py``): ``_fault`` set to "killed" makes the next
``step()`` raise :class:`EngineDead`, "oom" makes the next paged block
allocation raise it from inside the allocator, and "wedged" makes
``step()`` return without advancing the iteration clock. All three act
on the host, before any device work is queued.

Sharded serving (``mesh``, ``parallel``): the engine is one rank of an
SPMD program over the mesh's ranks (``distributed/context.py``). Every
rank runs this same host logic on the same requests, computes on its
shard of the weights (``sharding.param_specs``; a full tree is cut on
entry) and of the KV cache (its Hkv/tp kv heads, a cache of its own,
``serving_cache_specs``'s head split), and uploads the same host arrays
for the slot state and block tables, which every rank holds whole. The
logits are gathered in rank order, so every rank emits the same tokens;
each readback is checked equal across the ranks. With
``decode_impl="kernel"`` each rank launches the decode kernels on its
local heads, an ordinary unsharded cache, where the reference's sharded
engine falls back to XLA (``pallas_fallback`` stays False here). The
dense decoder and the MoE decoder are served so; the other families and
heads that tp does not divide raise NotImplementedError naming the later
slice.

The mesh may be a submesh of the process group (a fleet's pool on its
own ranks). Every rank of the group still runs the engine's host logic
on the same requests: a rank outside the mesh (``member`` False) holds no
weights and no cache and skips every device dispatch, and takes each
dispatch's host result from the mesh's lead (``ParallelContext.share``).
Its host KV tier holds the same states as a member's, a swapped request
marked as holding KV with no rows (an empty ``host_kv``), so it takes the
swap path wherever the members do.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from collections import Counter, OrderedDict
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.context import make_context
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.draft import propose_draft
from repro_torch.training.tree import leaves as _leaves


def prefill_buckets(c_chunk: int, min_bucket: int = 8) -> Tuple[int, ...]:
    """Padded chunk lengths: powers of two from ``min_bucket`` up to (and
    always including) ``c_chunk``."""
    buckets = []
    b = min(min_bucket, c_chunk)
    while b < c_chunk:
        buckets.append(b)
        b *= 2
    buckets.append(c_chunk)
    return tuple(buckets)


class EngineDead(RuntimeError):
    """The engine's device state is gone (an injected crash or allocator
    exhaustion). Host bookkeeping (queue, emitted-token mirrors, the host
    KV tier) survives: ``reconfigure.salvage_states`` reads it to move
    every accepted request to a healthy engine."""


@dataclasses.dataclass
class ServeRequest:
    rid: int
    tokens: List[int]              # prompt token ids
    max_new_tokens: int
    category: str = "prose"
    # predicted output length (tokens): with lout_reservation, paged
    # admission reserves ceil((L_in + hint) / block) blocks instead of
    # the max_new_tokens worst case. None = worst-case reservation
    l_out_hint: Optional[int] = None


@dataclasses.dataclass
class ServeResult:
    rid: int
    output_tokens: List[int]
    prefill_iters: int
    decode_iters: int
    queue_iters: int               # iterations spent waiting for a slot
    shed: bool = False             # refused by queue-wait shedding
    preemptions: int = 0           # times this request was preempted


@dataclasses.dataclass
class _PreemptedState:
    """Host checkpoint of a preempted slot. ``host_kv`` is the swap
    path's device->host copy of exactly the slot's blocks (paged: (L,
    n_blocks, BLOCK_S, Hkv, hd) per leaf; dense: its cache row, every
    leaf of :meth:`InferenceEngine._row_leaves`), or None
    on the recompute path, where ``replay`` is prefilled again: the
    prompt, the duplicated last prompt token, and all but the last
    generated token, i.e. the tokens whose KV sat at positions 0..pos-1."""
    req: ServeRequest
    out: List[int]                 # tokens emitted before preemption
    pos: int                       # next KV position at preemption
    last_tok: int                  # token the next decode would feed
    replay: List[int]              # recompute-path prefill token list
    host_kv: Optional[Dict[str, torch.Tensor]] = None
    n_blocks: int = 0              # device blocks held at preemption


class InferenceEngine:
    """One pool: n_max lockstep slots over a shared batched KV cache."""

    def __init__(self, cfg: ModelConfig, params, n_max: int, c_max: int,
                 c_chunk: Optional[int] = None, *,
                 config: Optional[ServingConfig] = None, **overrides):
        scfg = config if config is not None else ServingConfig()
        if c_chunk is not None:
            overrides = dict(overrides, c_chunk=c_chunk)
        if overrides:
            scfg = scfg.replace(**overrides)
        if cfg.family not in ("dense", "moe", "vlm"):
            raise NotImplementedError(
                "engine supports attention-family models (the paper serves "
                "Llama-3-70B); SSM decode runs through models.decode_step")
        if scfg.spec_k > 1 and cfg.attention_window:
            # a rejected draft's KV write at ring slot (p + i) % window
            # would clobber live in-window history
            raise NotImplementedError(
                "speculative decoding needs full-attention KV offsets; "
                "windowed ring-buffer caches alias live history under "
                "rejected drafts")
        # -- mesh / tensor parallel: this rank's part of the engine
        self.mesh = scfg.mesh
        self.parallel = (scfg.parallel or make_context(scfg.mesh)) \
            if scfg.mesh is not None else None
        self.tp_degree = self.parallel.tp if self.parallel else 1
        # the decode kernels run on each rank's local heads: no fallback
        self.pallas_fallback = False
        M.check_supported(cfg, parallel=self.parallel)
        self.config = scfg
        self.cfg = cfg
        # a rank outside the mesh holds nothing of the engine on a device
        self.member = self.parallel is None or self.parallel.member
        if not self.member:
            params = None
        elif self.tp_degree > 1:
            params = SH.rank_shard(params, self.parallel, cfg.vocab_size)
        self.params = params
        self.device = params["embed"].device if self.member else None
        self.decode_impl = scfg.decode_impl
        self.n_max = n_max
        self.c_max = c_max
        self.c_chunk = min(scfg.c_chunk, c_max)
        self.buckets = prefill_buckets(self.c_chunk)
        self.eos_id = scfg.eos_id
        self.paged = scfg.paged
        self.prefix_cache = scfg.prefix_cache
        if self.paged:
            self.block_size = scfg.block_size
            # logical blocks per slot: enough to address c_max tokens
            self.blocks_per_slot = math.ceil(c_max / self.block_size)
            self.num_blocks = (scfg.num_blocks if scfg.num_blocks is not None
                               else n_max * self.blocks_per_slot)
            self.cache = (M.init_paged_cache(cfg, self.num_blocks,
                                             self.block_size,
                                             device=self.device,
                                             parallel=self.parallel)
                          if self.member else None)
            # host-side allocator: free list, worst-case reservations and
            # per-slot tables
            self._free: List[int] = list(range(self.num_blocks))
            self._reserved = 0          # worst-case blocks not yet alloc'd
            self.block_tables = np.zeros((n_max, self.blocks_per_slot),
                                         np.int32)
            self._slot_blocks: List[List[int]] = [[] for _ in range(n_max)]
            self._slot_reserved = [0] * n_max
            # -- ref-counted prefix cache --
            # _ref[phys]: live slot-table references to a physical block
            self._ref = np.zeros(self.num_blocks, np.int64)
            # chained block hash -> physical block holding its KV
            self._prefix_map: Dict[bytes, int] = {}
            # physical block -> its registered hash (reverse index)
            self._block_hash: Dict[int, bytes] = {}
            # ref == 0 blocks still holding cached prefixes, LRU order;
            # allocated (evicted) only when _free runs dry
            self._cached_free: OrderedDict = OrderedDict()
            # per-slot chain hashes of its FULL prompt blocks, and how
            # many leading blocks are already in the prefix map
            self._slot_hashes: List[List[bytes]] = [[] for _ in range(n_max)]
            self._slot_registered = [0] * n_max
            self._hash_seed = hashlib.sha1(
                f"{cfg.name}/{self.block_size}".encode()).digest()
            self.prefix_stats = {"lookups": 0, "hit_blocks": 0,
                                 "hit_tokens": 0, "allocated_blocks": 0,
                                 "registered_blocks": 0, "evicted_blocks": 0}
            # device copy of the block table, re-uploaded only after the
            # allocator touched it
            self._bt_device = None
        else:
            self.cache = (M.init_cache(cfg, n_max, c_max, device=self.device,
                                       parallel=self.parallel)
                          if self.member else None)
        # per-slot host state
        self.slot_req: List[Optional[ServeRequest]] = [None] * n_max
        self.slot_pos = np.zeros(n_max, np.int32)        # next position
        self.slot_prefill_left: List[List[int]] = [[] for _ in range(n_max)]
        self.slot_out: List[List[int]] = [[] for _ in range(n_max)]
        self.slot_last_tok = np.zeros(n_max, np.int32)
        self.waiting: List[ServeRequest] = []
        # chain hashes of waiting requests by rid, so a blocked FIFO head
        # does not rehash its prompt on every admission probe
        self._req_hashes: Dict[int, List[bytes]] = {}
        self.results: Dict[int, ServeResult] = {}
        self.iteration = 0
        self._queue_iters: Dict[int, int] = {}
        self._enqueued_at: Dict[int, int] = {}
        self._prefill_iters: Dict[int, int] = {}
        # bounded out-of-order admission window for a deferring FIFO head,
        # with a per-head bypass cap as starvation guard
        self.hol_window = max(0, int(scfg.hol_window))
        self.hol_max_bypass = 8 * max(1, self.hol_window)
        self._hol_bypassed: Dict[int, int] = {}
        # -- overload survival: LIFO preemption into the host tier, and
        # shedding above an estimated queue wait (iterations)
        self.preemption = bool(scfg.preemption)
        self.max_queue_wait = scfg.max_queue_wait
        # swap iff the cold suffix (tokens replay would recompute, net of
        # live prefix-cache hits) exceeds this; 0 always swaps
        self.swap_threshold = 0 if scfg.swap_threshold is None \
            else int(scfg.swap_threshold)
        self._preempted: Dict[int, _PreemptedState] = {}
        # a recompute replay ends one token early; the token decode feeds
        # next is restored when its prefill lands
        self._resume_last_tok: Dict[int, int] = {}
        self._rid_preemptions: Dict[int, int] = {}
        self._slot_admit_iter = [0] * n_max       # LIFO victim key
        self.overload_stats = {"preempted": 0, "swapped_out": 0,
                               "swapped_in": 0, "recomputed": 0,
                               "swapped_blocks": 0, "shed": 0,
                               "hol_bypass": 0, "reservation_breach": 0}
        # fault injection (reconfigure.FaultInjector): None = healthy;
        # "killed" / "oom" make the next step / block allocation raise
        # EngineDead, "wedged" stalls step() without advancing the clock
        self._fault: Optional[str] = None
        self.lout_reservation = bool(scfg.lout_reservation)
        # rolling completion / arrival rates per iteration (EMA) for the
        # queue-wait estimate
        self._completed_total = 0
        self._arrived_since_step = 0
        self._mu_hat = 0.0
        self._lam_hat = 0.0
        self._rate_alpha = 0.05
        self.prefill_buckets_used: Set[int] = set()
        # -- hot-path accounting: one DISPATCH == one model call on the
        # host (a K-step decode micro-loop counts once); one ITERATION ==
        # one lockstep model step
        self.decode_k = max(1, int(scfg.decode_k))
        # speculative verify window W = spec_k: the carried token plus up
        # to W-1 drafts per device step
        self.spec_k = max(1, int(scfg.spec_k))
        self.spec_ngram = max(1, int(scfg.spec_ngram))
        self.spec_stats = {
            "drafted_tokens": 0,     # host proposer output
            "proposed_tokens": 0,    # drafts fed to verify windows
            "accepted_tokens": 0,    # fed drafts the model confirmed
            "verify_windows": 0,     # live verify steps
        }
        self.dispatches = 0            # model calls, total
        self.decode_dispatches = 0     # decode-only calls
        self.decode_tokens_emitted = 0  # tokens emitted, any dispatch kind
        self._decode_only_tokens = 0   # tokens of decode-only dispatches
        self._occ_slot_iters = 0       # occupied slot-iterations
        # device-resident (last_tok, pos, active, budget) for the decode
        # micro-loop; host writes to slot state mark it dirty
        self._dev_state = None
        self._dev_dirty = True

    def devices(self) -> List[int]:
        """The global ranks this engine spans (each holds one shard; one
        rank without a mesh), the same list on every rank."""
        return self.mesh.ranks if self.mesh is not None else [0]

    def cache_bytes_per_device(self) -> int:
        """KV-cache bytes on this rank: 1/tp of the unsharded engine's
        under the kv-head split (0 on a rank outside the mesh)."""
        if not self.member:
            return 0
        return sum(a.numel() * a.element_size()
                   for a in _leaves(self.cache))

    def _readback(self, t: Optional[torch.Tensor], what: str) -> np.ndarray:
        """The host copy of a dispatch's tokens (``t``; None on a rank
        outside the mesh, which dispatched nothing), checked equal on
        every rank of the mesh (the schedulers would drift apart
        otherwise) and shared with every rank of the process group."""
        out = t.cpu().numpy() if self.member else None
        if self.parallel is not None:
            out = self.parallel.share(out, what)
        return out

    # ------------------------------------------------------------------ API
    def submit(self, req: ServeRequest) -> bool:
        """Enqueue a request. With ``max_queue_wait`` set, a request whose
        estimated queue wait already exceeds it is refused (shed): its
        result is empty with ``shed=True``. Returns False iff shed."""
        self._arrived_since_step += 1
        if (self.max_queue_wait is not None and self.waiting
                and self._completed_total > 0
                and self.queue_wait_estimate() > self.max_queue_wait):
            self.results[req.rid] = ServeResult(req.rid, [], 0, 0, 0,
                                                shed=True)
            self.overload_stats["shed"] += 1
            return False
        self.waiting.append(req)
        self._enqueued_at[req.rid] = self.iteration
        return True

    def busy(self) -> bool:
        return any(r is not None for r in self.slot_req) or bool(self.waiting)

    def queue_wait_estimate(self) -> float:
        """Iterations a request submitted now would wait for a slot: queue
        depth over the service rate (completions per iteration), the EMA
        floored by the cumulative rate so the first completions do not
        make it diverge. 0.0 before any completion; inf under a stall."""
        if self._completed_total == 0:
            return 0.0
        mu = max(self._mu_hat,
                 self._completed_total / max(1, self.iteration))
        if mu <= 0.0:
            return float("inf")
        return len(self.waiting) / mu

    def host_tier_blocks(self) -> int:
        """Device blocks' worth of KV parked in the host swap tier (0 for
        recompute-path preemptions and dense rows)."""
        return sum(st.n_blocks for st in self._preempted.values())

    def _update_rate_estimates(self, k_iters: int, completions: int) -> None:
        """Fold one dispatch's iterations into the EMA rates; the decay
        compounds per iteration, so the estimate is comparable across
        decode_k."""
        if k_iters <= 0:
            return
        decay = (1.0 - self._rate_alpha) ** k_iters
        self._mu_hat = decay * self._mu_hat \
            + (1.0 - decay) * (completions / k_iters)
        self._lam_hat = decay * self._lam_hat \
            + (1.0 - decay) * (self._arrived_since_step / k_iters)
        self._arrived_since_step = 0

    def utilization_snapshot(self, detail: bool = False):
        """Mean per-iteration slot occupancy since engine start (a slot
        that finishes mid-micro-loop contributes only the iterations it
        decoded); before the first iteration, the occupied fraction.
        ``detail=True`` returns a dict with the overload counters (shed,
        preempt, swap, HOL bypass), the queue depth, the host-tier blocks
        and the rate estimates too."""
        if self.iteration == 0:
            occ = sum(r is not None for r in self.slot_req) / self.n_max
        else:
            occ = self._occ_slot_iters / (self.n_max * self.iteration)
        if not detail:
            return occ
        return {"occupancy": occ,
                "queue_depth": len(self.waiting),
                "queue_wait_est_iters": self.queue_wait_estimate(),
                "service_rate_per_iter": self._mu_hat,
                "arrival_rate_per_iter": self._lam_hat,
                "host_tier_blocks": self.host_tier_blocks(),
                **self.overload_stats}

    def dispatches_per_token(self) -> float:
        """Decode-only dispatches per token they emitted (1/decode_k in
        steady-state decode)."""
        if self._decode_only_tokens == 0:
            return float("inf")
        return self.decode_dispatches / self._decode_only_tokens

    def free_block_count(self) -> int:
        """Allocatable physical blocks (paged): the free list plus the
        evictable cached-prefix tier, what admission reserves against."""
        return self._available_blocks() if self.paged else 0

    def prefix_cache_blocks(self) -> int:
        """Physical blocks addressable by prefix hash (referenced or
        evictable)."""
        return len(self._prefix_map) if self.paged else 0

    def kv_tokens_held(self) -> int:
        """Tokens of KV memory pinned: paged counts distinct referenced
        blocks (a shared prefix block pins memory once, evictable cached
        blocks not at all); dense pins c_max per occupied slot."""
        if self.paged:
            held = self.num_blocks - len(self._free) - len(self._cached_free)
            return held * self.block_size
        return sum(r is not None for r in self.slot_req) * self.c_max

    def run_to_completion(self, max_iters: int = 100_000
                          ) -> Dict[int, ServeResult]:
        while self.busy() and self.iteration < max_iters:
            self.step()
        return self.results

    def _row_leaves(self) -> Dict[str, torch.Tensor]:
        """The dense cache's leaves by name, each with the slots on axis
        1: the KV leaves and, for VLM, the cross memory's "xk" / "xv"."""
        return dict(self.cache["kv"],
                    **{k: a for k, a in self.cache.items() if k != "kv"})

    def cache_row(self, s: int) -> Dict[str, Dict[str, torch.Tensor]]:
        """Host copy of slot ``s``'s cache row, (L, S, Hkv, hd) per leaf
        (paged: materialized through the block table); VLM adds the slot's
        cross memory, "xk" / "xv" (n_groups, F, Hkv, hd)."""
        if self.paged:
            idx = torch.as_tensor(self.block_tables[s]).long()

            def gather(a):
                out = a[:, :self.num_blocks].cpu()[:, idx]
                return out.reshape(a.shape[0], -1, *a.shape[3:])
            return {"kv": {k: gather(a) for k, a in self.cache["kv"].items()}}
        return {k: ({n: a[:, s].cpu() for n, a in v.items()}
                    if k == "kv" else v[:, s].cpu())
                for k, v in self.cache.items()}

    # ----------------------------------------------------------------- step
    def step(self) -> None:
        """One lockstep step: admit, then ONE dispatch — the fused mixed
        call when prefill chunks and decode rows are both pending, else a
        batched prefill call, else a decode call advancing ``decode_k``
        iterations (verify windows when ``spec_k > 1``). The iteration
        clock advances by the model iterations the dispatch performed."""
        if self._fault == "killed":
            raise EngineDead(f"engine fault injected: {self._fault}")
        if self._fault == "wedged":
            # a stall: busy, stepped, and the clock never moves (what
            # HealthPolicy detects)
            return
        it0, done0 = self.iteration, self._completed_total
        self.iteration += 1
        self._admit()
        chunks: Dict[int, List[int]] = {}
        for s in range(self.n_max):
            if self.slot_req[s] is None or not self.slot_prefill_left[s]:
                continue
            chunks[s] = self.slot_prefill_left[s][: self.c_chunk]
            self.slot_prefill_left[s] = self.slot_prefill_left[s][self.c_chunk:]
        decode_mask = np.array(
            [self.slot_req[s] is not None and s not in chunks
             and not self.slot_prefill_left[s] for s in range(self.n_max)],
            bool)
        occupied = sum(r is not None for r in self.slot_req)
        if self.paged:
            for s, chunk in chunks.items():
                ok = self._ensure_blocks(s, int(self.slot_pos[s]) + len(chunk))
                assert ok, "prefill outran its reservation (the prompt " \
                    "is always fully covered, hint or not)"
            if decode_mask.any():
                # blocks for every token one decode dispatch can emit (K
                # steps of up to W tokens), so the micro-loop never needs
                # the host allocator
                k = self.decode_k * self.spec_k if not chunks else 1
                breached = False
                for s in np.where(decode_mask)[0]:
                    req = self.slot_req[int(s)]
                    if req is None:     # preempted by an earlier breach
                        continue
                    left = req.max_new_tokens - len(self.slot_out[int(s)])
                    needed = int(self.slot_pos[s]) + min(k, left)
                    if not self._ensure_blocks(int(s), needed):
                        # a tightened (l_out_hint) reservation outrun:
                        # free blocks by preemption, possibly of this slot
                        self._reservation_breach(int(s), needed,
                                                 protected=chunks.keys())
                        breached = True
                if breached:
                    # only rows still occupied decode; an all-False mask
                    # falls through to the idle branch
                    decode_mask &= np.array(
                        [r is not None for r in self.slot_req], bool)
        if chunks and decode_mask.any():
            self._occ_slot_iters += occupied
            self._run_mixed(chunks, decode_mask)
        elif chunks:
            self._occ_slot_iters += occupied
            self._run_prefill_chunks(chunks)
        elif decode_mask.any():
            if self.spec_k > 1:
                self._run_spec_scan(decode_mask)
            elif self.decode_k > 1:
                self._run_decode_scan(decode_mask)
            else:
                self._occ_slot_iters += occupied
                self._run_decode(decode_mask)
        else:
            self._occ_slot_iters += occupied
        self._update_rate_estimates(self.iteration - it0,
                                    self._completed_total - done0)

    # ------------------------------------------------------------ internals
    def _upload(self, host_array) -> torch.Tensor:
        """Host->device copy of a SNAPSHOT of scheduler state (tokens,
        positions, masks, budgets, block tables); later in-place host
        updates never reach the device copy."""
        return torch.tensor(np.array(host_array), device=self.device)

    def _worst_case_blocks(self, req: ServeRequest) -> int:
        return math.ceil((len(req.tokens) + req.max_new_tokens)
                         / self.block_size)

    def _refuse(self, req: ServeRequest, qi: int = 0) -> None:
        """Refuse waiting[qi]: empty result, no leaked host entries."""
        self.waiting.pop(qi)
        self.results[req.rid] = ServeResult(req.rid, [], 0, 0, 0)
        self._enqueued_at.pop(req.rid, None)
        self._queue_iters.pop(req.rid, None)
        self._req_hashes.pop(req.rid, None)
        self._hol_bypassed.pop(req.rid, None)
        self._resume_last_tok.pop(req.rid, None)
        self._preempted.pop(req.rid, None)
        self._rid_preemptions.pop(req.rid, None)

    def _admit(self) -> None:
        for s in range(self.n_max):
            if self.slot_req[s] is not None:
                continue
            while self.waiting:
                st = self._try_admit(s, 0, consume=True)
                if st == "refused":
                    continue          # the next waiting request gets the slot
                if st == "admitted":
                    break
                # the FIFO head defers (its blocks do not fit the pool
                # now). 1) preemption: free blocks by preempting the most
                # recently admitted decoding slot; a resumed head never
                # preempts (it would ping-pong with its preemptor)
                if self.preemption \
                        and self.waiting[0].rid not in self._preempted:
                    victim = self._select_victim()
                    if victim is not None:
                        self.preempt_slot(victim, requeue_index=1)
                        continue       # retry the head on the freed blocks
                # 2) a request within hol_window may take the slot;
                # 3) else wait for completions to return blocks
                if self._try_hol_bypass(s):
                    break
                return

    def _try_admit(self, s: int, qi: int, consume: bool) -> str:
        """Try to place ``waiting[qi]`` into free slot ``s``. Returns
        "admitted", "refused" (only when ``consume``), "defer" (fits the
        engine but not the block pool right now) or "skip" (would be
        refused, but this is a HOL probe that must not consume it). A
        preempted request resumes here: by swap-in, or by replaying its
        tokens through prefill (recompute)."""
        req = self.waiting[qi]
        state = self._preempted.get(req.rid)
        if len(req.tokens) + req.max_new_tokens > self.c_max:
            # the gateway guarantees this never happens (Eq. 15)
            if not consume:
                return "skip"
            self._refuse(req, qi)
            return "refused"
        if state is not None and state.host_kv is not None:
            return self._swap_in(s, qi, state)
        # a fresh admission, or a recompute replay: the same block
        # arithmetic over the replay list, which rebuilds positions
        # 0..pos-1 exactly
        tokens_full = req.tokens if state is None else state.replay
        budget_left = req.max_new_tokens \
            - (0 if state is None else len(state.out))
        hits = 0
        if self.paged:
            worst = math.ceil((len(tokens_full) + budget_left)
                              / self.block_size)
            if worst > self.num_blocks:
                # can never be covered: refuse, or the head defers forever
                if not consume:
                    return "skip"
                self._refuse(req, qi)
                return "refused"
            hashes = []
            if self.prefix_cache:
                if req.rid not in self._req_hashes:
                    self._req_hashes[req.rid] = self._chain_hashes(
                        tokens_full)
                hashes = self._req_hashes[req.rid]
            hits = self._prefix_hits(hashes)
            # lout_reservation: a FRESH admission reserves its predicted
            # footprint (l_out_hint, at least one token); a resumed
            # request, which breached once, reserves its worst case
            plan = worst
            if (self.lout_reservation and state is None
                    and req.l_out_hint is not None):
                reserve_budget = min(budget_left,
                                     max(1, int(req.l_out_hint)))
                plan = math.ceil((len(tokens_full) + reserve_budget)
                                 / self.block_size)
            # cached leading blocks are mapped, not allocated: only the
            # cold suffix needs cover. Pinning an EVICTABLE hit (ref 0)
            # takes it out of the allocatable tiers without adding to
            # _reserved, so it is charged here too, or the outstanding
            # reservations of other slots would be over-committed
            need = max(0, plan - hits)
            evictable_hits = sum(
                1 for i in range(hits)
                if self._ref[self._prefix_map[hashes[i]]] == 0)
            if need + evictable_hits > \
                    self._available_blocks() - self._reserved:
                return "defer"
            blocks = self._slot_blocks[s]
            for i in range(hits):
                phys = self._prefix_map[hashes[i]]
                if self._ref[phys] == 0:        # was evictable: pin it
                    del self._cached_free[phys]
                self._ref[phys] += 1
                self.block_tables[s, len(blocks)] = phys
                blocks.append(phys)
            if hits:
                self._bt_device = None
            self._reserved += need
            self._slot_reserved[s] = need
            self._slot_hashes[s] = hashes
            self._slot_registered[s] = hits
            if self.prefix_cache:
                self.prefix_stats["lookups"] += 1
                self.prefix_stats["hit_blocks"] += hits
                self.prefix_stats["hit_tokens"] += hits * self.block_size
        self.waiting.pop(qi)
        self._req_hashes.pop(req.rid, None)
        self._hol_bypassed.pop(req.rid, None)
        self.slot_req[s] = req
        self._dev_dirty = True
        self._slot_admit_iter[s] = self.iteration
        # prefill skips the cached prefix: it resumes at the first cold
        # token, in a private block (shared blocks are never written)
        self.slot_pos[s] = hits * self.block_size if self.paged else 0
        self.slot_prefill_left[s] = list(tokens_full[int(self.slot_pos[s]):])
        self.slot_out[s] = [] if state is None else list(state.out)
        if state is not None:
            del self._preempted[req.rid]
            if self.slot_prefill_left[s]:
                # the replay ends one token early (the newest emitted
                # token's KV was never written): decode feeds that token
                # once the replay's prefill lands
                self._resume_last_tok[req.rid] = state.last_tok
            elif tokens_full:
                self.slot_last_tok[s] = state.last_tok
        elif not self.slot_prefill_left[s] and req.tokens:
            # fully cached prompt: decode starts this same iteration from
            # the last prompt token
            self.slot_last_tok[s] = req.tokens[-1]
        self._queue_iters[req.rid] = self._queue_iters.get(req.rid, 0) \
            + self.iteration - self._enqueued_at.pop(req.rid)
        return "admitted"

    def _try_hol_bypass(self, s: int) -> bool:
        """Head-of-line fix: admit a request within the next
        ``hol_window`` queue positions out of order when the FIFO head
        defers; each head tolerates at most ``hol_max_bypass`` jumps."""
        if self.hol_window <= 0 or len(self.waiting) < 2:
            return False
        head_rid = self.waiting[0].rid
        bypasses = self._hol_bypassed.get(head_rid, 0)
        if bypasses >= self.hol_max_bypass:
            return False
        for qi in range(1, min(len(self.waiting), 1 + self.hol_window)):
            if self._try_admit(s, qi, consume=False) == "admitted":
                self._hol_bypassed[head_rid] = bypasses + 1
                self.overload_stats["hol_bypass"] += 1
                return True
        return False

    # -- preemption and the host KV tier -------------------------------------
    def _select_victim(self, exclude=()) -> Optional[int]:
        """LIFO: the most recently admitted DECODING slot (mid-prefill
        slots have not finished paying their admission), ties to the
        largest outstanding reservation. ``exclude`` shields slots the
        caller must not preempt."""
        cands = [s for s in range(self.n_max)
                 if self.slot_req[s] is not None
                 and not self.slot_prefill_left[s] and s not in exclude]
        if not cands:
            return None
        return max(cands, key=lambda s: (self._slot_admit_iter[s],
                                         self._slot_reserved[s], s))

    @staticmethod
    def _replay_tokens(req: ServeRequest, out: List[int]) -> List[int]:
        """The tokens whose KV sat at positions 0..pos-1: the prompt, the
        duplicated last prompt token the first decode wrote at position
        P, then all but the newest emitted token (decode feeds it next)."""
        if not out:
            return list(req.tokens)
        return list(req.tokens) + [req.tokens[-1]] + out[:-1]

    def _requeue(self, s: int, req: ServeRequest, requeue_index: int) -> None:
        """Put a checkpointed slot's request back in the queue AHEAD of new
        arrivals and release the slot (the queue entry goes in first, so
        the idle-point invariant check sees the rid queued)."""
        self.overload_stats["preempted"] += 1
        self._rid_preemptions[req.rid] = \
            self._rid_preemptions.get(req.rid, 0) + 1
        self.waiting.insert(min(requeue_index, len(self.waiting)), req)
        self._enqueued_at[req.rid] = self.iteration
        self.slot_req[s] = None
        self.slot_out[s] = []
        self.slot_pos[s] = 0
        self.slot_prefill_left[s] = []
        self._dev_dirty = True
        if self.paged:
            self._release_slot(s)

    def preempt_slot(self, s: int, mode: Optional[str] = None,
                     requeue_index: int = 0) -> None:
        """Preempt a DECODING slot: checkpoint its host state, move its KV
        off the device, SWAP (a host copy of exactly its blocks, or its
        dense row) or RECOMPUTE (discard; replay through prefill), and
        re-enqueue it ahead of new arrivals. ``mode`` forces "swap" or
        "recompute"; by default the cold suffix decides against
        ``swap_threshold``. Resume is ``_try_admit`` / ``_swap_in``."""
        req = self.slot_req[s]
        assert req is not None and not self.slot_prefill_left[s], \
            "can only preempt a decoding slot"
        pos = int(self.slot_pos[s])
        out = list(self.slot_out[s])
        if mode is None:
            restorable = 0
            if self.paged and self.prefix_cache:
                # leading blocks still in the prefix map are restored by
                # replay, not recomputed
                for h in self._slot_hashes[s]:
                    if h not in self._prefix_map:
                        break
                    restorable += self.block_size
            cold = pos - min(restorable, pos)
            mode = "swap" if cold > self.swap_threshold else "recompute"
        if mode == "swap":
            host_kv = self._swap_out(s)
            n_blocks = len(self._slot_blocks[s]) if self.paged else 0
            self.overload_stats["swapped_out"] += 1
        else:
            host_kv, n_blocks = None, 0
            self.overload_stats["recomputed"] += 1
        self._preempted[req.rid] = _PreemptedState(
            req=req, out=out, pos=pos,
            last_tok=int(self.slot_last_tok[s]),
            replay=self._replay_tokens(req, out), host_kv=host_kv,
            n_blocks=n_blocks)
        self._requeue(s, req, requeue_index)

    def _checkpoint_prefilling(self, s: int, requeue_index: int = 0) -> None:
        """Checkpoint a MID-PREFILL slot onto the recompute path (its KV
        so far is a prefix of what replay prefills anyway). The replay is
        rebuilt from the original request, so checkpointing a resumed
        request twice stays idempotent."""
        req = self.slot_req[s]
        assert req is not None and self.slot_prefill_left[s], \
            "can only checkpoint-prefill a mid-prefill slot"
        out = list(self.slot_out[s])
        replay = self._replay_tokens(req, out)
        # a resumed replay parked its next fed token; a fresh prefill's
        # is the last prompt token, replay[-1]
        last = self._resume_last_tok.pop(req.rid, None)
        if last is None:
            last = int(replay[-1]) if replay else 0
        self._preempted[req.rid] = _PreemptedState(
            req=req, out=out, pos=0, last_tok=int(last), replay=replay)
        self.overload_stats["recomputed"] += 1
        self._requeue(s, req, requeue_index)

    def drain_checkpoint(self, mode: Optional[str] = None) -> int:
        """Checkpoint EVERY occupied slot into the host tier, requeued in
        slot order ahead of the waiting requests (decoding slots through
        :meth:`preempt_slot`, mid-prefill ones onto the recompute path).
        Returns how many were checkpointed; they are then
        ``waiting[0:count]``."""
        count = 0
        for s in range(self.n_max):
            if self.slot_req[s] is None:
                continue
            if self.slot_prefill_left[s]:
                self._checkpoint_prefilling(s, requeue_index=count)
            else:
                self.preempt_slot(s, mode=mode, requeue_index=count)
            count += 1
        return count

    def _swap_out(self, s: int) -> Dict[str, torch.Tensor]:
        """Device->host copy of slot ``s``'s KV: exactly its block-table
        entries (shared prefix blocks included: the originals may be
        evicted before resume), or its dense cache row (VLM: with its
        cross memory). The host copy aliases no device memory. A rank
        outside the mesh copies nothing: its state holds an empty dict."""
        if self.paged:
            blocks = self._slot_blocks[s]
            self.overload_stats["swapped_blocks"] += len(blocks)
        if not self.member:
            return {}
        if self.paged:
            idx = torch.tensor(blocks, dtype=torch.long, device=self.device)
            return {k: L.gather_blocks(a, idx).cpu()
                    for k, a in self.cache["kv"].items()}
        return {k: L.gather_slot_row(a, s).cpu()
                for k, a in self._row_leaves().items()}

    def _swap_in(self, s: int, qi: int, state: _PreemptedState) -> str:
        """Swap-path resume into free slot ``s``: allocate fresh blocks
        (the originals were reclaimed), rewrite the block table, copy the
        host KV back and restore the slot's host state, so the next decode
        continues where the unloaded run would. Defers like a fresh
        admission when the pool cannot cover the (unchanged) worst case."""
        req = state.req
        if self.paged:
            worst = self._worst_case_blocks(req)
            if worst > self._available_blocks() - self._reserved:
                return "defer"
            n = state.n_blocks
            fresh = []
            for _ in range(n):
                phys = self._alloc_block()
                self._ref[phys] = 1
                fresh.append(phys)
            self.prefix_stats["allocated_blocks"] += n
            self._slot_blocks[s] = fresh
            self.block_tables[s, :] = 0
            self.block_tables[s, :n] = fresh
            self._bt_device = None
            self._reserved += worst - n
            self._slot_reserved[s] = worst - n
            if n and self.member:
                idx = torch.tensor(fresh, dtype=torch.long,
                                   device=self.device)
                for k, a in self.cache["kv"].items():
                    L.scatter_blocks(a, state.host_kv[k].to(self.device), idx)
            # restored blocks are PRIVATE: the slot's prefix registrations
            # were decref'd at preemption, and publishing the copies would
            # duplicate hashes
            self._slot_hashes[s] = []
            self._slot_registered[s] = 0
        elif self.member:
            for k, a in self._row_leaves().items():
                L.scatter_slot_row(a, state.host_kv[k].to(self.device), s)
        self.waiting.pop(qi)
        del self._preempted[req.rid]
        self._req_hashes.pop(req.rid, None)
        self._hol_bypassed.pop(req.rid, None)
        self.slot_req[s] = req
        self._dev_dirty = True
        self._slot_admit_iter[s] = self.iteration
        self.slot_pos[s] = state.pos
        self.slot_prefill_left[s] = []
        self.slot_out[s] = list(state.out)
        self.slot_last_tok[s] = state.last_tok
        self._queue_iters[req.rid] = self._queue_iters.get(req.rid, 0) \
            + self.iteration - self._enqueued_at.pop(req.rid)
        self.overload_stats["swapped_in"] += 1
        return "admitted"

    # -- prefix cache --------------------------------------------------------
    def _chain_hashes(self, tokens: List[int]) -> List[bytes]:
        """One chained content hash per FULL prompt block: h_i =
        sha1(h_{i-1} || tokens of block i as int64), seeded per (model,
        block size), so equal hashes mean equal prefixes up to and
        including the block, and so equal KV."""
        bs = self.block_size
        out, h = [], self._hash_seed
        for i in range(len(tokens) // bs):
            blk = np.asarray(tokens[i * bs:(i + 1) * bs], np.int64)
            h = hashlib.sha1(h + blk.tobytes()).digest()
            out.append(h)
        return out

    def _prefix_hits(self, hashes: List[bytes]) -> int:
        """Longest run of leading full blocks already cached."""
        n = 0
        for h in hashes:
            if h not in self._prefix_map:
                break
            n += 1
        return n

    def _available_blocks(self) -> int:
        """Blocks an allocation could obtain: free + evictable."""
        return len(self._free) + len(self._cached_free)

    def _alloc_block(self) -> int:
        """Pop a free block; when the free list is dry, evict the least
        recently released cached prefix block (its hash leaves the
        prefix map: its content is about to be overwritten)."""
        if self._fault == "oom":
            # raised from INSIDE the allocator, so counters the caller
            # already decremented stay inconsistent: salvage reads host
            # mirrors only
            raise EngineDead("engine fault injected: allocator exhausted")
        if self._free:
            return self._free.pop()
        phys, _ = self._cached_free.popitem(last=False)
        del self._prefix_map[self._block_hash.pop(phys)]
        self.prefix_stats["evicted_blocks"] += 1
        return phys

    def _register_prefix_blocks(self, s: int) -> None:
        """Publish slot ``s``'s full prompt blocks that prefill has now
        written completely. First writer wins: a block whose hash another
        slot registered meanwhile stays private."""
        hashes = self._slot_hashes[s]
        done = min(len(hashes), int(self.slot_pos[s]) // self.block_size)
        blocks = self._slot_blocks[s]
        for i in range(self._slot_registered[s], done):
            h = hashes[i]
            if h not in self._prefix_map:
                self._prefix_map[h] = blocks[i]
                self._block_hash[blocks[i]] = h
                self.prefix_stats["registered_blocks"] += 1
        self._slot_registered[s] = done

    def _ensure_blocks(self, s: int, tokens_needed: int) -> bool:
        """Allocate physical blocks for slot ``s`` until it covers
        ``tokens_needed`` positions. Within the slot's admission-time
        reservation the allocatable tiers never run dry (asserted).
        Beyond it (only under lout_reservation) an allocation may take
        only headroom no other slot reserved; returns False when that is
        gone, and the caller frees blocks by ``_reservation_breach``."""
        blocks = self._slot_blocks[s]
        while len(blocks) * self.block_size < tokens_needed:
            if self._slot_reserved[s] > 0:
                assert self._available_blocks(), \
                    "allocator exhausted despite reservation"
                self._reserved -= 1
                self._slot_reserved[s] -= 1
            elif self._available_blocks() - self._reserved <= 0:
                # other slots' reservations own every remaining block
                return False
            phys = self._alloc_block()
            self._ref[phys] = 1
            self.block_tables[s, len(blocks)] = phys
            blocks.append(phys)
            self.prefix_stats["allocated_blocks"] += 1
            self._bt_device = None
        return True

    def _reservation_breach(self, s: int, tokens_needed: int,
                            protected=frozenset()) -> None:
        """Slot ``s`` outran its l_out_hint reservation and the pool has no
        unreserved headroom: preempt LIFO victims until the allocation
        fits, or preempt ``s`` itself when it is the only candidate left
        (it resumes with its full worst case, so it breaches at most
        once). ``protected`` slots (this dispatch's prefill chunks) are
        never victims: their chunk would write into a released slot."""
        assert self.lout_reservation and self.preemption, \
            "reservation breach outside lout_reservation mode"
        self.overload_stats["reservation_breach"] += 1
        shield = {s} | set(protected)
        while True:
            victim = self._select_victim(exclude=shield)
            if victim is None:
                self.preempt_slot(s, requeue_index=0)
                return
            self.preempt_slot(victim, requeue_index=0)
            if self._ensure_blocks(s, tokens_needed):
                return

    def _block_table_device(self) -> torch.Tensor:
        if self._bt_device is None:
            self._bt_device = self._upload(self.block_tables)
        return self._bt_device

    def _release_slot(self, s: int) -> None:
        """Decrement the refcount of every block slot ``s`` holds (a block
        shared with another live slot survives). A block reaching ref 0
        goes to the free list if private, or to the evictable LRU tier if
        it holds a registered prefix. Drops the slot's unused reservation
        (the request finished early or at its cap)."""
        for phys in self._slot_blocks[s]:
            self._ref[phys] -= 1
            assert self._ref[phys] >= 0, "refcount underflow"
            if self._ref[phys] == 0:
                if phys in self._block_hash:
                    self._cached_free[phys] = None
                else:
                    self._free.append(phys)
        self._reserved -= self._slot_reserved[s]
        self._slot_blocks[s] = []
        self._slot_reserved[s] = 0
        self._slot_hashes[s] = []
        self._slot_registered[s] = 0
        self.block_tables[s, :] = 0
        self._bt_device = None
        if not any(r is not None for r in self.slot_req):
            self.assert_block_invariants()

    def assert_block_invariants(self) -> None:
        """Every physical block of ``[0, num_blocks)`` sits in exactly one
        tier (referenced, cached-free or free), each block's refcount
        equals its occurrences in the slot tables, the prefix map and its
        reverse index agree, and the outstanding reservation fits the
        allocatable tiers. The sink block is in none of them. The host
        tier: every preempted rid is queued for resume, and a swapped
        state's host copy holds exactly its recorded block count."""
        waiting_rids = {r.rid for r in self.waiting}
        for rid, st in self._preempted.items():
            assert rid in waiting_rids, \
                f"preempted rid {rid} not queued for resume"
            if self.paged and st.host_kv is not None:
                for leaf in st.host_kv.values():
                    assert leaf.shape[1] == st.n_blocks, \
                        "host-tier copy disagrees with its block count"
        if not self.paged:
            return
        cnt = Counter(b for blocks in self._slot_blocks for b in blocks)
        for phys in range(self.num_blocks):
            assert self._ref[phys] == cnt.get(phys, 0), \
                f"block {phys}: ref {self._ref[phys]} != " \
                f"{cnt.get(phys, 0)} table entries"
        referenced = set(cnt)
        free, cached = set(self._free), set(self._cached_free)
        assert len(free) == len(self._free), "duplicate in free list"
        assert not referenced & free, "block both referenced and free"
        assert not referenced & cached, "block both referenced and cached"
        assert not free & cached, "block both free and cached-free"
        assert referenced | free | cached <= set(range(self.num_blocks)), \
            "a tier holds a block outside the pool (the sink?)"
        assert len(referenced) + len(free) + len(cached) == self.num_blocks, \
            "block leak: tiers do not partition the pool"
        assert set(self._prefix_map.values()) == set(self._block_hash), \
            "prefix map and reverse index disagree"
        assert cached <= set(self._block_hash), \
            "cached-free block without a registered hash"
        assert 0 <= self._reserved <= self._available_blocks(), \
            "reservation exceeds allocatable blocks"

    def _bucket_chunks(self, chunks: Dict[int, List[int]]):
        """Pad pending chunks into the smallest covering bucket shape
        (shared by the prefill-only and fused mixed dispatches)."""
        longest = max(len(c) for c in chunks.values())
        bucket = next(b for b in self.buckets if b >= longest)
        self.prefill_buckets_used.add(bucket)
        tokens = np.zeros((self.n_max, bucket), np.int32)
        lengths = np.zeros(self.n_max, np.int32)
        for s, chunk in chunks.items():
            tokens[s, : len(chunk)] = chunk
            lengths[s] = len(chunk)
        return tokens, lengths

    def _run_prefill_chunks(self, chunks: Dict[int, List[int]]) -> None:
        tokens, lengths = self._bucket_chunks(chunks)
        if self.member:               # the mesh's ranks prefill
            tokens, start, lengths = (self._upload(tokens),
                                      self._upload(self.slot_pos),
                                      self._upload(lengths))
            if self.paged:
                M.paged_prefill_chunk(self.params, self.cfg, tokens,
                                      self.cache, self._block_table_device(),
                                      start, lengths, parallel=self.parallel)
            else:
                M.prefill_chunk(self.params, self.cfg, tokens, self.cache,
                                start, lengths, decode_impl=self.decode_impl,
                                parallel=self.parallel)
        self.dispatches += 1
        self._advance_prefill_host(chunks)

    def _advance_prefill_host(self, chunks: Dict[int, List[int]]) -> None:
        """Host bookkeeping for one dispatched chunk per slot; dirties the
        device-resident decode state."""
        self._dev_dirty = True
        for s, chunk in chunks.items():
            rid = self.slot_req[s].rid
            self.slot_pos[s] += len(chunk)
            self._prefill_iters[rid] = self._prefill_iters.get(rid, 0) + 1
            if not self.slot_prefill_left[s]:
                # a recompute replay's next fed token is its newest
                # emitted one, not the replay's last
                self.slot_last_tok[s] = self._resume_last_tok.pop(
                    rid, chunk[-1])
            if self.prefix_cache:
                # full prompt blocks this chunk completed become
                # addressable by later admissions
                self._register_prefix_blocks(s)

    def _decode_logits(self, tokens, pos, active) -> torch.Tensor:
        """One masked decode step over all n_max rows -> logits (B, V)."""
        if self.paged:
            logits, _ = M.paged_decode_step(
                self.params, self.cfg, tokens, self.cache,
                self._block_table_device(), pos,
                decode_impl=self.decode_impl, active=active,
                parallel=self.parallel)
        else:
            logits, _ = M.decode_step(self.params, self.cfg, tokens,
                                      self.cache, pos,
                                      decode_impl=self.decode_impl,
                                      active=active, parallel=self.parallel)
        return logits

    def _decode_loop(self, tok, pos, active, budget):
        """The decode_k micro-loop: K masked decode steps with argmax and
        termination on the device. A row that finishes (budget spent,
        EOS, or context full — the host's completion rule) clears its
        active bit and freezes: the remaining steps leave its cache row
        bit-identical. Returns the new (tok, pos, active, budget) and the
        (B, K) emitted tokens, -1 where a row emitted nothing."""
        emitted = []
        for _ in range(self.decode_k):
            logits = self._decode_logits(tok[:, None], pos, active)
            nxt = torch.argmax(logits, dim=-1)
            emitted.append(torch.where(active, nxt, -1))
            tok = torch.where(active, nxt, tok)
            pos = torch.where(active, pos + 1, pos)
            budget = torch.where(active, budget - 1, budget)
            done = budget <= 0
            if self.eos_id is not None:
                done = done | (tok == self.eos_id)
            done = done | (pos >= self.c_max)
            active = active & ~done
        return (tok, pos, active, budget), torch.stack(emitted, dim=1)

    def _spec_loop(self, tok, pos, active, budget, drafts, dlen):
        """The speculative micro-loop: ``decode_k`` verify steps, each
        feeding [tok, the next W-1 drafts at the row's cursor] through the
        masked verify step and emitting the longest draft prefix equal to
        the model's greedy argmax plus the bonus token: 1..W tokens per
        row and step, all on the device. A row whose draft dies burns the
        rest (cursor -> dlen) and decodes one token a step from then on;
        inactive rows feed lengths 0 and stay bitwise no-ops. Returns the
        new (tok, pos, active, budget), the (K, B, W) emitted tokens (-1
        where none) and the (K, B) drafts fed."""
        w_max, w_d = self.spec_k, self.spec_k - 1
        dev = tok.device
        last_col = drafts.shape[1] - 1
        ar_d = torch.arange(w_d, device=dev)[None, :]
        ar_w = torch.arange(w_max, device=dev)[None, :]
        cur = torch.zeros_like(dlen)
        emitted, fed = [], []
        for _ in range(self.decode_k):
            dwin = drafts.gather(1, torch.clamp(cur[:, None] + ar_d, 0,
                                                last_col))
            # feedable drafts, clipped so the window and its bonus token
            # never outrun the budget or the context
            w = torch.minimum(dlen - cur,
                              torch.minimum(budget - 1, self.c_max - 1 - pos))
            w = torch.where(active, torch.clamp(w, 0, w_d), 0)
            window = torch.cat([tok[:, None], dwin], dim=1)       # (B, W)
            lengths = torch.where(active, 1 + w, 0)
            if self.paged:
                logits, _ = M.paged_verify_step(
                    self.params, self.cfg, window, self.cache,
                    self._block_table_device(), pos, lengths,
                    parallel=self.parallel)
            else:
                logits, _ = M.verify_step(self.params, self.cfg, window,
                                          self.cache, pos, lengths,
                                          decode_impl=self.decode_impl,
                                          parallel=self.parallel)
            g = torch.argmax(logits, dim=-1)                      # (B, W)
            # draft i is accepted iff it equals the model's continuation
            # at the position before it; j = the accepted prefix length
            match = (dwin == g[:, :w_d]) & (ar_d < w[:, None])
            j = torch.cumprod(match.long(), dim=1).sum(dim=1)
            emit = (ar_w <= j[:, None]) & active[:, None]
            if self.eos_id is not None:
                # truncate at the first emitted EOS: the host releases
                # the slot there
                is_eos = (g == self.eos_id).long()
                emit &= (torch.cumsum(is_eos, dim=1) - is_eos) == 0
            emitted.append(torch.where(emit, g, -1))
            fed.append(w)
            e = emit.sum(dim=1)
            last = g.gather(1, torch.clamp(e - 1, 0, w_max - 1)[:, None])[:, 0]
            tok = torch.where(active & (e > 0), last, tok)
            pos = pos + e
            budget = budget - e
            # a fully accepted window's bonus token confirms the next
            # draft: the continuation lives on and the next window starts
            # after it; any divergence kills the row's remaining drafts
            d_next = drafts.gather(1, torch.clamp(cur + w, 0,
                                                  last_col)[:, None])[:, 0]
            chain = (j >= w) & (cur + w < dlen) & (d_next == last)
            cur = torch.where(chain, cur + w + 1, dlen)
            done = (budget <= 0) | (pos >= self.c_max)
            if self.eos_id is not None:
                done = done | (emit & (g == self.eos_id)).any(dim=1)
            active = active & ~done
        return (tok, pos, active, budget), torch.stack(emitted), \
            torch.stack(fed)

    def _device_decode_state(self, mask: np.ndarray):
        """Device-resident (tok, pos, active, budget), re-uploaded only when
        host bookkeeping wrote slot state since the last decode loop."""
        if self._dev_dirty or self._dev_state is None:
            budget = np.zeros(self.n_max, np.int64)
            for s in range(self.n_max):
                req = self.slot_req[s]
                if req is not None:
                    budget[s] = req.max_new_tokens - len(self.slot_out[s])
            self._dev_state = (
                self._upload(self.slot_last_tok.astype(np.int64)),
                self._upload(self.slot_pos.astype(np.int64)),
                self._upload(mask),
                self._upload(budget))
            self._dev_dirty = False
        return self._dev_state

    def _finish_slot(self, s: int) -> None:
        req = self.slot_req[s]
        self.results[req.rid] = ServeResult(
            rid=req.rid, output_tokens=self.slot_out[s],
            prefill_iters=self._prefill_iters.pop(req.rid, 0),
            decode_iters=len(self.slot_out[s]),
            queue_iters=self._queue_iters.pop(req.rid, 0),
            preemptions=self._rid_preemptions.pop(req.rid, 0))
        self._completed_total += 1
        self.slot_req[s] = None
        if self.paged:
            self._release_slot(int(s))

    def _append_token(self, s: int, tok: int) -> bool:
        """Host mirror of one emitted token; True when the slot completed
        (the rule the device loop applies)."""
        req = self.slot_req[s]
        self.slot_out[s].append(tok)
        self.slot_last_tok[s] = tok
        self.slot_pos[s] += 1
        self.decode_tokens_emitted += 1
        return (len(self.slot_out[s]) >= req.max_new_tokens
                or (self.eos_id is not None and tok == self.eos_id)
                or self.slot_pos[s] >= self.c_max)

    def _run_decode(self, mask: np.ndarray) -> None:
        tok = None
        if self.member:
            tok = torch.argmax(self._decode_logits(
                self._upload(self.slot_last_tok[:, None]),
                self._upload(self.slot_pos), self._upload(mask)), dim=-1)
        next_tok = self._readback(tok, "the decode dispatch's tokens")
        self.dispatches += 1
        self.decode_dispatches += 1
        self._decode_only_tokens += int(mask.sum())
        self._dev_dirty = True
        for s in np.where(mask)[0]:
            if self._append_token(int(s), int(next_tok[s])):
                self._finish_slot(int(s))

    def _run_decode_scan(self, mask: np.ndarray) -> None:
        """One dispatch, ``decode_k`` decode iterations; the only sync is
        the (n_max, K) emitted-token copy. The host replays the same
        completion rule to update its mirrors without dirtying the
        device state."""
        k = self.decode_k
        emitted = None
        if self.member:
            state, emitted = self._decode_loop(
                *self._device_decode_state(mask))
            self._dev_state = state
        self.dispatches += 1
        self.decode_dispatches += 1
        emitted = self._readback(emitted,       # the single host sync
                                 "the decode micro-loop's tokens")
        self.iteration += k - 1                # step() already added 1
        for s in np.where(mask)[0]:
            s = int(s)
            done = False
            for j in range(k):
                t = int(emitted[s, j])
                if t < 0:
                    break
                self._occ_slot_iters += 1
                self._decode_only_tokens += 1
                done = self._append_token(s, t)
                if done:
                    break
            if done:
                self._finish_slot(s)

    def _run_spec_scan(self, mask: np.ndarray) -> None:
        """One dispatch, ``decode_k`` speculative verify steps: the host
        proposes one n-gram draft continuation per slot, uploads the
        (n_max, K*W - 1) table, and the single sync pulls the (K, n_max,
        W) emitted tokens with the (K, n_max) drafts fed. The host replays
        window by window with the same completion rule, so its mirrors
        and the device state stay in lockstep."""
        k, w_max = self.decode_k, self.spec_k
        # K windows can walk K*W - 1 drafts when the continuation never
        # diverges (each window feeds W-1 and chains its bonus through one)
        m_len = k * w_max - 1
        drafts = np.zeros((self.n_max, m_len), np.int64)
        dlen = np.zeros(self.n_max, np.int64)
        for s in np.where(mask)[0]:
            s = int(s)
            req = self.slot_req[s]
            # a draft token is useful only if the budget and context also
            # admit its bonus token
            cap = min(m_len,
                      req.max_new_tokens - len(self.slot_out[s]) - 1,
                      self.c_max - 1 - int(self.slot_pos[s]))
            if cap <= 0:
                continue
            d = propose_draft(list(req.tokens) + self.slot_out[s], cap,
                              self.spec_ngram)
            if d:
                drafts[s, :len(d)] = d
                dlen[s] = len(d)
                self.spec_stats["drafted_tokens"] += len(d)
        both = None
        if self.member:
            state, emitted, fed = self._spec_loop(
                *self._device_decode_state(mask), self._upload(drafts),
                self._upload(dlen))
            self._dev_state = state
            both = torch.cat([emitted, fed[..., None]], dim=2)
        self.dispatches += 1
        self.decode_dispatches += 1
        # the single host sync: emitted tokens and drafts fed, one copy
        out = self._readback(both, "the verify windows' tokens")
        emitted, fed = out[..., :w_max], out[..., w_max]
        self.iteration += k - 1              # step() already added 1
        for s in np.where(mask)[0]:
            s = int(s)
            done = False
            for m in range(k):
                e = 0
                for i in range(w_max):
                    t = int(emitted[m, s, i])
                    if t < 0:
                        break
                    e += 1
                    self._decode_only_tokens += 1
                    done = self._append_token(s, t)
                    if done:
                        break
                if e:
                    # one live verify window is one occupied iteration,
                    # however many tokens it accepted
                    self._occ_slot_iters += 1
                    self.spec_stats["proposed_tokens"] += int(fed[m, s])
                    self.spec_stats["accepted_tokens"] += e - 1
                    self.spec_stats["verify_windows"] += 1
                if done:
                    break
            if done:
                self._finish_slot(s)

    def spec_acceptance_rate(self) -> float:
        """Accepted / proposed draft tokens over all verify windows (0.0
        before any window ran); drafts clipped by budget or context are
        never fed and not charged."""
        if self.spec_stats["proposed_tokens"] == 0:
            return 0.0
        return (self.spec_stats["accepted_tokens"]
                / self.spec_stats["proposed_tokens"])

    def spec_kappa(self) -> float:
        """Mean tokens emitted per verify window (>= 1.0; 1.0 when no
        draft was ever accepted or no window ran)."""
        w = self.spec_stats["verify_windows"]
        if w == 0:
            return 1.0
        return (self.spec_stats["accepted_tokens"] + w) / w

    def _run_mixed(self, chunks: Dict[int, List[int]],
                   mask: np.ndarray) -> None:
        """Fused prefill + decode dispatch: one model call advances all
        pending chunks and all decode rows (M.mixed_step)."""
        tokens, lengths = self._bucket_chunks(chunks)
        nxt = None                    # the mesh's ranks dispatch
        if self.member:
            pos = self._upload(self.slot_pos)
            toks = self._upload(self.slot_last_tok[:, None])
            if self.paged:
                logits, _ = M.paged_mixed_step(
                    self.params, self.cfg, self._upload(tokens), self.cache,
                    self._block_table_device(), pos, self._upload(lengths),
                    toks, self._upload(mask), decode_impl=self.decode_impl,
                    parallel=self.parallel)
            else:
                logits, _ = M.mixed_step(
                    self.params, self.cfg, self._upload(tokens), self.cache,
                    pos, self._upload(lengths), toks, self._upload(mask),
                    decode_impl=self.decode_impl, parallel=self.parallel)
            nxt = torch.argmax(logits, dim=-1)
        next_tok = self._readback(nxt, "the mixed dispatch's tokens")
        self.dispatches += 1
        self._dev_dirty = True
        self._advance_prefill_host(chunks)
        for s in np.where(mask)[0]:
            if self._append_token(int(s), int(next_tok[s])):
                self._finish_slot(int(s))
