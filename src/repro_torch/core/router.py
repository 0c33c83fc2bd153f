"""Gateway router (paper §2.1, §5): token estimation, pool decision,
borderline interception and Compress-and-Route — generalized to a
K-pool boundary vector.

The router is control-plane only (host-side): it never touches device
state.  The serving runtime (repro/serving/pools.py) gives it the pool
handles; the DES (repro/sim) gives it synthetic requests.

Routing rule (K pools, boundaries ``B_1 < ... < B_{K-1}`` in tokens):
a request with estimated ``L_total`` lands in the pool whose band
``(B_i, B_{i+1}]`` contains it.  C&R intercepts requests at most ONE
tier up: a pool-j request inside the band ``(B_j, gamma_j * B_j]``
whose content category passes the safety gate (paper §5.2) is
compressed to ``T_c = B_j - L_out`` tokens and re-routed to pool j-1 —
the virtual capacity of every pool below the top grows by its gamma
with no hardware change.  K=2 reduces exactly to the paper's
short/long gateway.

Session affinity (DESIGN.md §Prefix caching): multi-turn sessions
resubmit their whole history, and the engine-side prefix cache only
pays off if a repeat turn lands on the POOL whose engine still holds
its KV blocks.  ``route(..., session=...)`` remembers each session's
last pool and pins later turns to it whenever the turn still fits that
pool's band (a longer pool always fits a shorter request, so pinning
can only move a request UP, never overflow a KV budget).  A turn that
outgrows the remembered pool falls back to natural routing — and C&R
is skipped for pinned turns, since compressing a repeat turn away from
its cached prefix would trade a prefill skip for a full re-prefill.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.core.compression import ExtractiveCompressor
from repro_torch.core.naming import pool_names
from repro_torch.core.workload import COMPRESSIBLE, Request

SHORT, LONG = "short", "long"


class BytesPerTokenEMA:
    """Per-category bytes-per-token estimate c_hat_k (paper §2.1).

    Updated from completed requests (actual tokenizer counts) with
    exponential decay; seeds at 4.0 bytes/token.  Units: bytes/token.
    """

    def __init__(self, decay: float = 0.95, seed_value: float = 4.0):
        self.decay = decay
        self._est: Dict[str, float] = {}
        self._seed = seed_value

    def get(self, category: str) -> float:
        """Current bytes/token estimate for ``category``."""
        return self._est.get(category, self._seed)

    def update(self, category: str, prompt_bytes: int, true_tokens: int) -> None:
        """Fold one completed request's observed ratio into the EMA."""
        if true_tokens <= 0:
            return
        obs = prompt_bytes / true_tokens
        cur = self._est.get(category, self._seed)
        self._est[category] = self.decay * cur + (1 - self.decay) * obs


@dataclasses.dataclass
class RoutingDecision:
    """Outcome of one gateway decision (paper §5.1)."""
    pool: str                      # pool name ("short"/"long"/"pool{i}")
    l_total_effective: int         # token budget after any compression
    compressed: bool
    compression_ms: float = 0.0    # gateway compression overhead (ms)
    l_in_effective: int = 0        # prompt tokens actually sent (tokens)
    compressed_text: Optional[str] = None
    pool_index: int = -1           # 0 = shortest-context pool


@dataclasses.dataclass
class RouterStats:
    """Gateway counters.  ``to_short``/``to_long`` count the shortest /
    longest pool (the only two pools when K=2, matching paper Table 3's
    alpha accounting); ``per_pool`` has every pool by name."""
    total: int = 0
    to_short: int = 0
    to_long: int = 0
    borderline: int = 0
    compressed_ok: int = 0
    compression_attempts: int = 0
    compression_ms_sum: float = 0.0
    affinity_pinned: int = 0       # repeat turns pinned to their pool
    per_pool: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def alpha_observed(self) -> float:
        """Observed traffic fraction into the shortest pool (paper's
        alpha' = alpha + beta*p_c when K=2 and gamma > 1)."""
        return self.to_short / self.total if self.total else 0.0

    @property
    def p_c_observed(self) -> float:
        """Observed borderline compression success rate (paper p_c)."""
        if not self.compression_attempts:
            return 0.0
        return self.compressed_ok / self.compression_attempts

    @property
    def mean_overhead_ms(self) -> float:
        """Mean compression overhead across ALL requests (paper Table 4)."""
        return self.compression_ms_sum / self.total if self.total else 0.0


class GatewayRouter:
    """K-pool router with Compress-and-Route (paper §5.1).

    Construct either with the legacy two-pool arguments
    (``b_short``/``gamma``) or a K-pool spec
    (``boundaries=(B_1, ..., B_{K-1})``, ``gammas`` per boundary).
    A request with ``B_j < L_total <= gamma_j * B_j`` whose category
    passes the content-type safety gate is compressed to
    ``T_c = B_j - L_out`` and re-routed one tier down; the hard no-OOM
    guarantee (Eq. 15) means a compressed request can never overflow
    its target pool's KV budget.
    """

    def __init__(self, b_short: Optional[int] = None, gamma: float = 1.5,
                 compressor: Optional[ExtractiveCompressor] = None,
                 p_c: float = 1.0, seed: int = 0,
                 boundaries: Optional[Sequence[int]] = None,
                 gammas: Optional[Sequence[float]] = None,
                 lout_predictor=None):
        if boundaries is None:
            if b_short is None:
                raise ValueError("pass b_short (two-pool) or boundaries")
            boundaries = (b_short,)
        self._set_bands(boundaries, gammas if gammas is not None
                        else (gamma,) * len(boundaries))
        self.names = pool_names(self.k)
        self.compressor = compressor or ExtractiveCompressor()
        self.ema = BytesPerTokenEMA()
        # output-length-aware routing (DESIGN.md §Serving API): with a
        # calibrated OutputLenPredictor, banding uses the PREDICTED
        # output length instead of the max_tokens worst case — callers
        # over-claiming max_tokens stop being routed (and compressed)
        # as if they would use it. The serving runtime restores no-OOM
        # by clamping the generation budget to the chosen pool's
        # context (token-budget routing); None keeps worst-case
        # routing, bitwise-identical to the legacy router.
        self.lout_predictor = lout_predictor
        self.stats = RouterStats()
        # session -> pool index of its last turn (prefix-affinity hint)
        self._session_pool: Dict[str, int] = {}
        # simulation fallback when requests carry no prompt text
        self._p_c = p_c
        self._rng = np.random.default_rng(seed)

    def _set_bands(self, boundaries, gammas) -> None:
        boundaries = tuple(int(b) for b in boundaries)
        if list(boundaries) != sorted(set(boundaries)):
            raise ValueError(f"boundaries must be strictly increasing, "
                             f"got {boundaries}")
        gammas = tuple(float(g) for g in gammas)
        if len(gammas) != len(boundaries):
            raise ValueError("need one gamma per boundary")
        if any(g < 1.0 for g in gammas):
            raise ValueError(f"gammas must be >= 1.0, got {gammas}")
        self.boundaries = boundaries
        self.gammas = gammas
        self.k = len(self.boundaries) + 1
        # legacy two-pool views (first boundary); a boundary-less router
        # (K=1, homogeneous) routes everything to its single pool
        self.b_short = self.boundaries[0] if self.boundaries else 0
        self.gamma = self.gammas[0] if self.gammas else 1.0

    def set_boundaries(self, boundaries: Sequence[int],
                       gammas: Optional[Sequence[float]] = None) -> None:
        """Apply a re-plan to the LIVE router (DESIGN.md §Serving API):
        boundary/gamma moves are software-only in the C&R design — the
        band edges move, the provisioned pool handles do not, so K must
        stay the same. Stats, the bytes/token EMA and session affinity
        survive the move; in-flight requests keep the pool they were
        routed to (the no-OOM guarantee was enforced against their
        admission-time pool)."""
        if len(boundaries) != len(self.boundaries):
            raise ValueError(
                f"re-plan changed pool count ({len(boundaries) + 1} != "
                f"{self.k}): resizing the fleet needs provisioning, not "
                "a boundary move")
        self._set_bands(boundaries,
                        gammas if gammas is not None else self.gammas)

    # -- token budget estimate (paper §2.1) --------------------------------
    def estimate_l_total(self, req: Request) -> int:
        """Estimated token budget L_hat = prompt_bytes / c_hat + L_out
        (tokens); falls back to the exact ``l_in`` when the request
        carries no raw bytes (DES path). With an OutputLenPredictor the
        L_out term is min(cap, predicted) instead of the cap."""
        c_hat = self.ema.get(req.category)
        prompt_tokens = math.ceil(req.prompt_bytes / c_hat) \
            if req.prompt_bytes else req.l_in
        l_out = req.l_out              # l_out == r.max_output_tokens
        if self.lout_predictor is not None:
            l_out = min(l_out, self.lout_predictor.predict(
                prompt_tokens, category=req.category))
        return prompt_tokens + l_out

    # -- main entry ---------------------------------------------------------
    def route(self, req: Request, prompt_text: Optional[str] = None,
              session: Optional[str] = None) -> RoutingDecision:
        """Decide the pool for one request; attempt C&R in the
        borderline band.  ``session`` (opaque id) enables prefix
        affinity: a repeat turn is pinned to the session's previous
        pool when it still fits there, so the engine-side prefix cache
        sees the turn that holds its blocks.  Returns a
        :class:`RoutingDecision` whose ``pool`` is a name from
        ``pool_names(K)``."""
        self.stats.total += 1
        l_total = self.estimate_l_total(req)
        # natural pool: first i with l_total <= B_{i+1}
        idx = bisect.bisect_left(self.boundaries, l_total)
        prev = self._session_pool.get(session) if session is not None \
            else None
        if prev is not None and prev >= idx:
            # pin to the pool holding the session's cached prefix; a
            # pool with index >= idx always has room for the request
            # (c_max monotone in pool index), and C&R is skipped — it
            # would move the turn away from its blocks
            self.stats.affinity_pinned += 1
            return self._decide(prev, l_total, False, l_in=req.l_in)
        dec = self._route_natural(req, prompt_text, l_total, idx)
        if session is not None:
            self._session_pool[session] = dec.pool_index
        return dec

    def _route_natural(self, req: Request, prompt_text: Optional[str],
                       l_total: int, idx: int) -> RoutingDecision:
        if idx > 0 and l_total <= self.gammas[idx - 1] * self.boundaries[idx - 1]:
            self.stats.borderline += 1
            if req.category in COMPRESSIBLE:
                return self._compress_and_route(req, prompt_text, l_total, idx)
        return self._decide(idx, l_total, False, l_in=req.l_in)

    def _decide(self, idx: int, l_total: int, compressed: bool,
                l_in: int, ms: float = 0.0,
                text: Optional[str] = None) -> RoutingDecision:
        name = self.names[idx]
        if idx == 0 and self.k > 1:
            self.stats.to_short += 1
        if idx == self.k - 1:
            self.stats.to_long += 1
        self.stats.per_pool[name] = self.stats.per_pool.get(name, 0) + 1
        return RoutingDecision(name, l_total, compressed, ms,
                               l_in_effective=l_in, compressed_text=text,
                               pool_index=idx)

    def _compress_and_route(self, req: Request, text: Optional[str],
                            l_total: int, idx: int) -> RoutingDecision:
        b_low = self.boundaries[idx - 1]        # target pool's context cap
        budget = b_low - req.l_out              # T_c (Eq. 15), tokens
        if budget <= 0:
            return self._decide(idx, l_total, False, l_in=req.l_in)
        self.stats.compression_attempts += 1
        if text is not None:
            res = self.compressor.compress(text, budget)
            self.stats.compression_ms_sum += res.latency_ms
            if res.success:
                self.stats.compressed_ok += 1
                # hard OOM guarantee (Eq. 15): T_c + L_out <= B_j
                assert res.compressed_tokens + req.l_out <= b_low
                return self._decide(idx - 1,
                                    res.compressed_tokens + req.l_out, True,
                                    l_in=res.compressed_tokens,
                                    ms=res.latency_ms, text=res.text)
            return self._decide(idx, l_total, False, l_in=req.l_in)
        # DES path: Bernoulli(p_c) success, latency from the measured
        # distribution (paper Table 4: 2-7 ms).
        ms = float(self._rng.uniform(2.0, 7.0))
        self.stats.compression_ms_sum += ms
        if self._rng.uniform() < self._p_c:
            self.stats.compressed_ok += 1
            return self._decide(idx - 1, b_low, True, l_in=budget, ms=ms)
        return self._decide(idx, l_total, False, l_in=req.l_in)
