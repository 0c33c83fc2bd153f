"""Hardware profiles for the analytical fleet model (paper §7.1).

The paper calibrates (W, H) to Llama-3-70B on an A100-80GB 8-GPU TP
node and derives per-GPU slot counts from the KV budget:
n_max(C) = floor(n_ref * C_ref / C) -> 256 @4K, 682 @1.5K, 128 @8K,
16 @64K. We keep that as ``A100_LLAMA70B`` (paper-faithful) and add a
TPU-v5e profile derived from the roofline constants (DESIGN.md §3),
plus a constructor that derives a profile for ANY assigned architecture
from its KV bytes/token.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.configs.base import ModelConfig

HOURS_PER_YEAR = 8760.0
DEFAULT_KV_BLOCK = 16          # tokens per paged KV block (vLLM default)
DEFAULT_TAIL_MARGIN_BLOCKS = 2  # per-slot reserve above the mean


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    name: str
    w_ms: float                 # baseline iteration compute (ms)
    h_ms_per_slot: float        # per-slot memory-bandwidth cost (ms)
    c_chunk: int                # chunked-prefill size (tokens)
    n_ref: int                  # slots/GPU at the reference context size
    c_ref: int                  # reference context size (tokens)
    kv_bytes_per_token: int     # model KV growth
    cost_per_hour: float        # $/GPU-hr (or $/chip-hr)
    # When True, H is interpreted as per-slot cost at C_ref and scaled by
    # the pool's context size (memory-bandwidth reading; beyond-paper
    # option — the paper-faithful profiles keep it False).
    h_scales_with_context: bool = False
    # SSM/recurrent archs: slots are O(1) in context length, so the pool
    # boundary doesn't change capacity (the paper's rho -> 1 limit).
    context_free_slots: bool = False
    # Engine-side ref-counted prefix cache (DESIGN.md §Prefix caching):
    # fraction of PROMPT tokens expected to hit a cached shared prefix.
    # Hits skip their prefill iterations (shorter service time, see
    # FleetDES) and pin no per-request blocks (the shared block is
    # counted once across all its holders), so the paged methods below
    # subtract hit tokens from each slot's expected residency when the
    # caller passes the pool's mean prompt length.
    prefix_hit_rate: float = 0.0
    # Devices per engine REPLICA (tensor-parallel degree; DESIGN.md
    # §Sharded serving). n_ref/c_ref stay PER-DEVICE calibration
    # constants; a replica spanning d devices aggregates d x the HBM
    # token budget (the sharded KV cache splits over kv-heads, so each
    # device holds 1/d of every slot) and d x the memory bandwidth (the
    # per-slot H cost divides by d while the slot count multiplies by
    # d, leaving t_iter at a given c_max unchanged — TP collectives
    # and the unsplit W are deliberately NOT modeled; the paper's
    # (W, H) were calibrated on an 8-GPU TP node already). Pool sizing
    # then counts REPLICAS, and annual_cost bills every device of
    # every replica. The default 1 reproduces the single-device
    # numbers bit-for-bit.
    devices_per_replica: int = 1
    # Self-speculative decoding (DESIGN.md §Speculative decoding):
    # measured mean tokens EMITTED per verify iteration (kappa >= 1;
    # calibrate with InferenceEngine.spec_kappa() on the pool's
    # traffic) and the relative per-iteration cost of the W-token
    # verify step over a 1-token decode step. A kappa > 1 profile
    # advances kappa tokens per (1 + spec_overhead)x iteration, so the
    # planner sizes fleets by EFFECTIVE tokens/s: decode iterations
    # per request become L_out / kappa while t_iter inflates by the
    # overhead (core.planner.size_pool applies both). The defaults
    # reproduce every pre-speculation number bit-for-bit.
    spec_kappa: float = 1.0
    spec_overhead: float = 0.0
    # Host-offload KV tier (DESIGN.md §Overload survival): effective
    # device<->host copy bandwidth for swapping a preempted slot's KV
    # blocks to host RAM and back. ~25 GB/s is a PCIe-4 x16 link at
    # realistic efficiency; the default only prices the preemption
    # path and changes no pre-overload number.
    swap_gbps: float = 25.0

    # -- overload survival (DESIGN.md §Overload survival) ------------------
    def swap_seconds(self, tokens: float) -> float:
        """One-direction device<->host copy time for ``tokens`` worth
        of KV (swap-out and swap-in each cost this)."""
        return tokens * self.kv_bytes_per_token / (self.swap_gbps * 1e9)

    def recompute_threshold_tokens(self, c_max: Optional[int] = None) -> int:
        """Cold-suffix size (tokens NOT restorable from the prefix
        cache) above which swapping a preempted slot beats discarding
        and replaying its prefill.

        Replaying t cold tokens costs ceil(t/c_chunk) prefill
        iterations at t_iter(c_max) each; swapping costs the KV
        round trip 2*swap_seconds(t) but zero prefill. Both are linear
        in t at large t, so the policy reduces to comparing per-token
        rates: recompute wins while
        t_iter/c_chunk (prefill s/token) < 2*kv_bytes/swap_bw (copy
        s/token) — i.e. the threshold is where chunked-prefill
        throughput overtakes the PCIe link. The engine compares the
        preempted slot's cold-suffix tokens against this knee: small
        cold suffixes (warm prefix cache) recompute, large ones swap.
        On A100_LLAMA70B this lands around one c_chunk (prefill is
        fast, KV is 320KB/token), so cold suffixes beyond ~a chunk
        swap."""
        c = c_max if c_max is not None else self.c_ref
        prefill_s_per_tok = self.t_iter(c) / self.c_chunk
        swap_s_per_tok = 2.0 * self.kv_bytes_per_token / (self.swap_gbps
                                                          * 1e9)
        if prefill_s_per_tok <= 0:
            return 0
        return max(0, int(self.c_chunk * swap_s_per_tok
                          / prefill_s_per_tok))

    def n_max(self, c_max: int) -> int:
        """Concurrent slots per REPLICA (= per GPU at
        devices_per_replica == 1) for a pool sized for ``c_max``."""
        if self.context_free_slots:
            return self.n_ref
        return max(1, int(self.n_ref * self.devices_per_replica
                          * self.c_ref / c_max))

    def t_iter(self, c_max: int) -> float:
        """Iteration latency (seconds) at full occupancy (paper Eq. 3).
        Per-slot H divides by devices_per_replica (aggregate bandwidth),
        cancelling the replica's larger slot count."""
        n = self.n_max(c_max)
        h = self.h_ms_per_slot / self.devices_per_replica
        if self.h_scales_with_context:
            h = h * (c_max / self.c_ref)
        return (self.w_ms + h * n) / 1000.0

    def kv_bytes_per_slot(self, c_max: int, per_device: bool = False) -> int:
        """Worst-case KV bytes one slot pins; ``per_device=True`` gives
        the shard each of the replica's devices holds (the serving
        cache shards the kv-head dim, an even 1/d split)."""
        b = c_max * self.kv_bytes_per_token
        return b // self.devices_per_replica if per_device else b

    # -- paged KV variants (DESIGN.md §Paged KV cache) ---------------------
    def _paged_slot_tokens(self, mean_tokens: float,
                           block_size: int = DEFAULT_KV_BLOCK,
                           tail_margin_blocks: int =
                           DEFAULT_TAIL_MARGIN_BLOCKS,
                           mean_prompt_tokens: float = 0.0) -> int:
        """Expected KV tokens a paged slot pins: E[L_total] rounded up
        to whole blocks plus a tail-margin block reserve (the paged
        analog of the planner's tail_margin — absorbs length-mix
        drift without re-planning). With a prefix cache, hit prompt
        tokens (``prefix_hit_rate * mean_prompt_tokens``) live in
        shared blocks and are not charged to this slot."""
        eff = mean_tokens - self.prefix_hit_rate * mean_prompt_tokens
        blocks = math.ceil(max(eff, 1.0) / block_size) \
            + tail_margin_blocks
        return blocks * block_size

    def n_max_paged(self, mean_tokens: float,
                    block_size: int = DEFAULT_KV_BLOCK,
                    tail_margin_blocks: int =
                    DEFAULT_TAIL_MARGIN_BLOCKS,
                    mean_prompt_tokens: float = 0.0) -> int:
        """Concurrent slots per GPU with a PAGED KV cache.

        The dense layout divides the HBM token budget (n_ref * c_ref)
        by the pool's worst case ``c_max`` (Eq. 15's hard boundary);
        paging divides it by the pool's ACTUAL expected occupancy
        E[L_total] + margin — turning n_max from a worst-case constant
        into a function of the length mix (the runtime analog of the
        paper's hard-boundary -> software-parameter move).
        ``mean_tokens`` is the pool-conditional E[L_total] in tokens;
        ``mean_prompt_tokens`` (E[L_in]) is only needed when the
        profile carries a nonzero ``prefix_hit_rate``.
        """
        if self.context_free_slots:
            return self.n_ref
        # replica HBM budget in tokens: d devices' worth of per-device
        # budget (the paged pool shards over the replica's devices)
        budget = self.n_ref * self.c_ref * self.devices_per_replica
        per_slot = self._paged_slot_tokens(mean_tokens, block_size,
                                           tail_margin_blocks,
                                           mean_prompt_tokens)
        return max(1, int(budget / per_slot))

    def kv_bytes_per_slot_paged(self, mean_tokens: float,
                                block_size: int = DEFAULT_KV_BLOCK,
                                tail_margin_blocks: int =
                                DEFAULT_TAIL_MARGIN_BLOCKS,
                                mean_prompt_tokens: float = 0.0,
                                per_device: bool = False) -> int:
        b = self._paged_slot_tokens(mean_tokens, block_size,
                                    tail_margin_blocks,
                                    mean_prompt_tokens) \
            * self.kv_bytes_per_token
        return b // self.devices_per_replica if per_device else b

    def t_iter_paged(self, mean_tokens: float,
                     block_size: int = DEFAULT_KV_BLOCK,
                     tail_margin_blocks: int =
                     DEFAULT_TAIL_MARGIN_BLOCKS,
                     mean_prompt_tokens: float = 0.0,
                     spec_kappa: Optional[float] = None) -> float:
        """Iteration latency (s) at full PAGED occupancy: same Eq. 3
        shape, but n is the paged slot count and — when H models the
        per-slot KV read — each slot streams only its actual ~E[L]
        tokens, not c_max. More slots per iteration, each cheaper.

        Prefix sharing reduces only what a slot PINS (n grows via
        n_max_paged), never what it STREAMS: every decode step still
        attends the slot's full context, shared blocks included
        (gather_pages materializes them into each row). So the H
        scaling deliberately ignores ``prefix_hit_rate`` — a cached
        pool iterates SLOWER per step (more slots, same per-slot read),
        it just packs more of them per GPU.

        ``spec_kappa`` (None = the profile's own ``spec_kappa`` field)
        is the MEASURED speculative acceptance — kappa tokens emitted
        per verify iteration (InferenceEngine.spec_kappa()) — turning
        the returned value into the EFFECTIVE per-token decode latency
        t_iter * (1 + spec_overhead) / kappa, which is what sizing
        the fleet by effective tokens/s wants. kappa == 1 (the
        default's default) returns the plain per-iteration latency
        unchanged."""
        n = self.n_max_paged(mean_tokens, block_size, tail_margin_blocks,
                             mean_prompt_tokens)
        h = self.h_ms_per_slot / self.devices_per_replica
        if self.h_scales_with_context:
            h = h * (self._paged_slot_tokens(mean_tokens, block_size,
                                             tail_margin_blocks)
                     / self.c_ref)
        t = (self.w_ms + h * n) / 1000.0
        kappa = self.spec_kappa if spec_kappa is None else spec_kappa
        if kappa > 1.0:
            t = t * (1.0 + self.spec_overhead) / kappa
        return t

    def annual_cost(self, n_gpus: int) -> float:
        """Annual $ for ``n_gpus`` REPLICAS — every device of every
        replica bills (a tp=4 replica is 4 accelerators on the invoice
        whatever the planner calls a 'GPU')."""
        return n_gpus * self.devices_per_replica * self.cost_per_hour \
            * HOURS_PER_YEAR

    def sharded(self, devices: int) -> "HardwareProfile":
        """This profile with ``devices``-way tensor-parallel replicas
        (serving/engine.py mesh mode; DESIGN.md §Sharded serving)."""
        if devices < 1:
            raise ValueError(f"devices_per_replica must be >= 1, "
                             f"got {devices}")
        if devices == self.devices_per_replica:
            return self
        return dataclasses.replace(self, devices_per_replica=devices,
                                   name=f"{self.name}:tp{devices}")

    def speculative(self, kappa: float,
                    overhead: float = 0.15) -> "HardwareProfile":
        """This profile with measured speculative acceptance ``kappa``
        (tokens per verify iteration, InferenceEngine.spec_kappa())
        and per-iteration verify overhead — the calibration hand-off
        from a serving engine to fleet sizing."""
        if kappa < 1.0:
            raise ValueError(f"spec_kappa must be >= 1 (1 = no "
                             f"speculation), got {kappa}")
        if kappa == self.spec_kappa and overhead == self.spec_overhead:
            return self
        return dataclasses.replace(self, spec_kappa=kappa,
                                   spec_overhead=overhead,
                                   name=f"{self.name}:spec{kappa:g}")


# Paper-faithful profile: Llama-3-70B / A100-80GB (§7.1).
# W=8ms, H=0.65ms/slot, C_chunk=512, 16 slots at 64K, 320KB/token.
A100_LLAMA70B = HardwareProfile(
    name="a100-llama3-70b",
    w_ms=8.0,
    h_ms_per_slot=0.65,
    c_chunk=512,
    n_ref=16,
    c_ref=65536,
    kv_bytes_per_token=320 * 1024,
    cost_per_hour=2.21,
)

# TPU-v5e profile (beyond-paper; DESIGN.md §3). Derived from the target
# constants: 197 TFLOP/s bf16, 819 GB/s HBM, 16 GB HBM per chip.
# For Llama-3-70B on a 16-chip TP slice: per-chip decode FLOPs/token
# ~ 2*70e9/16 = 8.75 GFLOP -> W ~ weight-read bound: 140GB/16 chips /
# 819GB/s = 10.7 ms; per-slot KV read = 320KB/token * C / 819 GB/s.
TPU_V5E_LLAMA70B = HardwareProfile(
    name="tpu-v5e-llama3-70b",
    w_ms=10.7,
    # calibrated: 20.5GB KV / (819GB/s * 16 chips) / 16 slots @64K
    h_ms_per_slot=0.4,
    c_chunk=512,
    n_ref=16,
    c_ref=65536,
    kv_bytes_per_token=320 * 1024,
    cost_per_hour=1.20,         # v5e on-demand $/chip-hr
    h_scales_with_context=True,
)


def profile_for_arch(cfg: ModelConfig, base: HardwareProfile = A100_LLAMA70B,
                     ) -> HardwareProfile:
    """Derive an analytical profile for an assigned architecture.

    The slot budget scales inversely with the arch's KV bytes/token
    (paper §2.2: slots are KV-bound); W scales with active-param FLOPs
    relative to Llama-3-70B. SSM archs (kv_bytes_per_token == 0) get an
    effectively flat slot curve capped by a compute bound — the cliff
    ratio collapses to ~1 (DESIGN.md §4, ρ→1 limit).
    """
    kv = cfg.kv_bytes_per_token()
    ref_kv = 320 * 1024
    flops_ratio = cfg.num_active_params() / 70.6e9
    context_free = kv == 0
    if context_free:
        # recurrent state only: slots bounded by compute/state, not KV.
        n_ref = 256
        h_ratio = 1.0 / base.n_ref      # per-slot cost ~ state read, tiny
    else:
        n_ref = max(1, int(base.n_ref * ref_kv / kv))
        # H is the per-slot KV-read cost: scales with the arch's
        # bytes/token (otherwise small-KV archs get absurd iteration
        # latencies at their large slot counts).
        h_ratio = kv / ref_kv
    return dataclasses.replace(
        base,
        name=f"{base.name}:{cfg.name}",
        w_ms=base.w_ms * flops_ratio,
        h_ms_per_slot=base.h_ms_per_slot * h_ratio,
        n_ref=n_ref,
        kv_bytes_per_token=kv,
        context_free_slots=context_free,
    )
