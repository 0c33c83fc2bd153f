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

The paged layout can share prompt prefixes (``prefix_cache=True``): full
prompt blocks are registered under a chained content hash once prefill
has written them; a later request whose leading blocks hash the same
maps those physical blocks into its table (ref-counted, read-only) and
prefills from its first cold token. A released block that holds a
registered prefix stays cached in an LRU tier, evicted only when the
free list runs dry. The pool's sink block (past ``num_blocks``, where
masked writes land) is never allocated, registered or evicted.

Later slices of the port add speculative decoding, overload survival
(preemption, queue-wait shedding), output-length-aware reservation and
routing, and sharded serving; their ServingConfig knobs raise
NotImplementedError here when set (``check_slice``).
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
from repro_torch.models import model as M
from repro_torch.serving.config import ServingConfig

# ServingConfig knobs of later slices: field -> (default, the slice)
_LATER_SLICES = {
    "spec_k": (1, "the speculative-decoding slice"),
    "preemption": (False, "the overload-survival slice"),
    "max_queue_wait": (None, "the overload-survival slice"),
    "swap_threshold": (None, "the overload-survival slice"),
    "lout_reservation": (False, "the output-length-aware serving slice"),
    "lout_routing": (False, "the output-length-aware serving slice"),
    "mesh": (None, "the sharded-serving slice"),
    "parallel": (None, "the sharded-serving slice"),
    "tp_degree": (1, "the sharded-serving slice"),
    "autoscale": (False, "the serving-surface slice (live re-provisioning)"),
}


def check_slice(scfg: ServingConfig) -> None:
    """Raise NotImplementedError for a ServingConfig knob this slice of
    the port does not serve, naming the slice that will."""
    for name, (default, later) in _LATER_SLICES.items():
        val = getattr(scfg, name)
        if val != default:
            raise NotImplementedError(
                f"ServingConfig.{name}={val!r} is not ported yet: it comes "
                f"with {later} of the PyTorch port")


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


@dataclasses.dataclass
class ServeRequest:
    rid: int
    tokens: List[int]              # prompt token ids
    max_new_tokens: int
    category: str = "prose"
    # predicted output length; read by the output-length-aware slice
    l_out_hint: Optional[int] = None


@dataclasses.dataclass
class ServeResult:
    rid: int
    output_tokens: List[int]
    prefill_iters: int
    decode_iters: int
    queue_iters: int               # iterations spent waiting for a slot
    shed: bool = False
    preemptions: int = 0


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
        check_slice(scfg)
        M.check_supported(cfg)
        self.config = scfg
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
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
            self.cache = M.init_paged_cache(cfg, self.num_blocks,
                                            self.block_size,
                                            device=self.device)
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
            self.cache = M.init_cache(cfg, n_max, c_max, device=self.device)
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
        self.overload_stats = {"hol_bypass": 0}
        self.prefill_buckets_used: Set[int] = set()
        # -- hot-path accounting: one DISPATCH == one model call on the
        # host (a K-step decode micro-loop counts once); one ITERATION ==
        # one lockstep model step
        self.decode_k = max(1, int(scfg.decode_k))
        self.dispatches = 0            # model calls, total
        self.decode_dispatches = 0     # decode-only calls
        self.decode_tokens_emitted = 0  # tokens emitted, any dispatch kind
        self._decode_only_tokens = 0   # tokens of decode-only dispatches
        self._occ_slot_iters = 0       # occupied slot-iterations
        # device-resident (last_tok, pos, active, budget) for the decode
        # micro-loop; host writes to slot state mark it dirty
        self._dev_state = None
        self._dev_dirty = True

    # ------------------------------------------------------------------ API
    def submit(self, req: ServeRequest) -> bool:
        """Enqueue a request (always accepted: queue-wait shedding is the
        overload-survival slice)."""
        self.waiting.append(req)
        self._enqueued_at[req.rid] = self.iteration
        return True

    def busy(self) -> bool:
        return any(r is not None for r in self.slot_req) or bool(self.waiting)

    def utilization_snapshot(self, detail: bool = False):
        """Mean per-iteration slot occupancy since engine start (a slot
        that finishes mid-micro-loop contributes only the iterations it
        decoded); before the first iteration, the occupied fraction.
        ``detail=True`` returns a dict with the queue depth and the HOL
        bypass count too."""
        if self.iteration == 0:
            occ = sum(r is not None for r in self.slot_req) / self.n_max
        else:
            occ = self._occ_slot_iters / (self.n_max * self.iteration)
        if not detail:
            return occ
        return {"occupancy": occ, "queue_depth": len(self.waiting),
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

    def cache_row(self, s: int) -> Dict[str, Dict[str, torch.Tensor]]:
        """Host copy of slot ``s``'s cache row, (L, S, Hkv, hd) per leaf
        (paged: materialized through the block table)."""
        if self.paged:
            idx = torch.as_tensor(self.block_tables[s]).long()

            def gather(a):
                out = a[:, :self.num_blocks].cpu()[:, idx]
                return out.reshape(a.shape[0], -1, *a.shape[3:])
            return {"kv": {k: gather(a) for k, a in self.cache["kv"].items()}}
        return {"kv": {k: a[:, s].cpu() for k, a in self.cache["kv"].items()}}

    # ----------------------------------------------------------------- step
    def step(self) -> None:
        """One lockstep step: admit, then ONE dispatch — the fused mixed
        call when prefill chunks and decode rows are both pending, else a
        batched prefill call, else a decode call advancing ``decode_k``
        iterations. The iteration clock advances by the model iterations
        the dispatch performed."""
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
                self._ensure_blocks(s, int(self.slot_pos[s]) + len(chunk))
            # blocks for every token one decode dispatch can emit, so the
            # micro-loop never needs the host allocator
            k = self.decode_k if not chunks else 1
            for s in np.where(decode_mask)[0]:
                req = self.slot_req[int(s)]
                left = req.max_new_tokens - len(self.slot_out[int(s)])
                self._ensure_blocks(int(s), int(self.slot_pos[s])
                                    + min(k, left))
        if chunks and decode_mask.any():
            self._occ_slot_iters += occupied
            self._run_mixed(chunks, decode_mask)
        elif chunks:
            self._occ_slot_iters += occupied
            self._run_prefill_chunks(chunks)
        elif decode_mask.any():
            if self.decode_k > 1:
                self._run_decode_scan(decode_mask)
            else:
                self._occ_slot_iters += occupied
                self._run_decode(decode_mask)
        else:
            self._occ_slot_iters += occupied

    # ------------------------------------------------------------ internals
    def _upload(self, host_array) -> torch.Tensor:
        """Host->device copy of a SNAPSHOT of scheduler state (tokens,
        positions, masks, budgets, block tables); later in-place host
        updates never reach the device copy."""
        return torch.tensor(np.array(host_array), device=self.device)

    def _refuse(self, req: ServeRequest, qi: int = 0) -> None:
        """Refuse waiting[qi]: empty result, no leaked host entries."""
        self.waiting.pop(qi)
        self.results[req.rid] = ServeResult(req.rid, [], 0, 0, 0)
        self._enqueued_at.pop(req.rid, None)
        self._queue_iters.pop(req.rid, None)
        self._req_hashes.pop(req.rid, None)
        self._hol_bypassed.pop(req.rid, None)

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
                # the FIFO head defers (its worst-case blocks do not fit
                # the pool now): a request within hol_window may take the
                # slot, else wait for completions to return blocks
                if self._try_hol_bypass(s):
                    break
                return

    def _try_admit(self, s: int, qi: int, consume: bool) -> str:
        """Try to place ``waiting[qi]`` into free slot ``s``. Returns
        "admitted", "refused" (only when ``consume``), "defer" (fits the
        engine but not the block pool right now) or "skip" (would be
        refused, but this is a HOL probe that must not consume it)."""
        req = self.waiting[qi]
        if len(req.tokens) + req.max_new_tokens > self.c_max:
            # the gateway guarantees this never happens (Eq. 15)
            if not consume:
                return "skip"
            self._refuse(req, qi)
            return "refused"
        cached = 0                   # leading prompt tokens already in the cache
        if self.paged:
            worst = math.ceil((len(req.tokens) + req.max_new_tokens)
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
                    self._req_hashes[req.rid] = self._chain_hashes(req.tokens)
                hashes = self._req_hashes[req.rid]
            hits = self._prefix_hits(hashes)
            # cached leading blocks are mapped, not allocated: only the
            # cold suffix needs worst-case cover. Pinning an EVICTABLE hit
            # (ref 0) takes it out of the allocatable tiers without adding
            # to _reserved, so it is charged here too, or the outstanding
            # reservations of other slots would be over-committed
            need = max(0, worst - hits)
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
            cached = hits * self.block_size
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
        # prefill skips the cached prefix: it resumes at the first cold
        # token, in a private block (shared blocks are never written)
        self.slot_pos[s] = cached
        self.slot_prefill_left[s] = list(req.tokens[cached:])
        self.slot_out[s] = []
        if not self.slot_prefill_left[s] and req.tokens:
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

    def _ensure_blocks(self, s: int, tokens_needed: int) -> None:
        """Allocate physical blocks for slot ``s`` until it covers
        ``tokens_needed`` positions, out of its admission-time worst-case
        reservation (which the allocatable tiers always cover)."""
        blocks = self._slot_blocks[s]
        while len(blocks) * self.block_size < tokens_needed:
            assert self._slot_reserved[s] > 0 and self._available_blocks(), \
                "slot outran its worst-case block reservation"
            self._reserved -= 1
            self._slot_reserved[s] -= 1
            phys = self._alloc_block()
            self._ref[phys] = 1
            self.block_tables[s, len(blocks)] = phys
            blocks.append(phys)
            self.prefix_stats["allocated_blocks"] += 1
            self._bt_device = None

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
        allocatable tiers. The sink block is in none of them."""
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
        tokens, start, lengths = (self._upload(tokens),
                                  self._upload(self.slot_pos),
                                  self._upload(lengths))
        if self.paged:
            M.paged_prefill_chunk(self.params, self.cfg, tokens, self.cache,
                                  self._block_table_device(), start, lengths)
        else:
            M.prefill_chunk(self.params, self.cfg, tokens, self.cache, start,
                            lengths)
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
                self.slot_last_tok[s] = chunk[-1]
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
                decode_impl=self.decode_impl, active=active)
        else:
            logits, _ = M.decode_step(self.params, self.cfg, tokens,
                                      self.cache, pos,
                                      decode_impl=self.decode_impl,
                                      active=active)
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
            queue_iters=self._queue_iters.pop(req.rid, 0))
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
        logits = self._decode_logits(self._upload(self.slot_last_tok[:, None]),
                                     self._upload(self.slot_pos),
                                     self._upload(mask))
        next_tok = torch.argmax(logits, dim=-1).cpu().numpy()
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
        state, emitted = self._decode_loop(*self._device_decode_state(mask))
        self._dev_state = state
        self.dispatches += 1
        self.decode_dispatches += 1
        emitted = emitted.cpu().numpy()         # the single host sync
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

    def _run_mixed(self, chunks: Dict[int, List[int]],
                   mask: np.ndarray) -> None:
        """Fused prefill + decode dispatch: one model call advances all
        pending chunks and all decode rows (M.mixed_step)."""
        tokens, lengths = self._bucket_chunks(chunks)
        pos = self._upload(self.slot_pos)
        toks = self._upload(self.slot_last_tok[:, None])
        if self.paged:
            logits, _ = M.paged_mixed_step(
                self.params, self.cfg, self._upload(tokens), self.cache,
                self._block_table_device(), pos, self._upload(lengths), toks,
                self._upload(mask), decode_impl=self.decode_impl)
        else:
            logits, _ = M.mixed_step(
                self.params, self.cfg, self._upload(tokens), self.cache, pos,
                self._upload(lengths), toks, self._upload(mask),
                decode_impl=self.decode_impl)
        next_tok = torch.argmax(logits, dim=-1).cpu().numpy()
        self.dispatches += 1
        self._dev_dirty = True
        self._advance_prefill_host(chunks)
        for s in np.where(mask)[0]:
            if self._append_token(int(s), int(next_tok[s])):
                self._finish_slot(int(s))
