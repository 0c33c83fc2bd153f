"""FleetOpt offline planner (paper §6, Algorithm 1), generalized to
K-pool heterogeneous fleets.

Given a workload (prompt-length CDF + output-length model), an arrival
rate ``lam`` (req/s), a P99 TTFT SLO ``t_slo`` (seconds) and per-pool
hardware profiles, the planner returns the minimum-annual-cost fleet:
a sorted boundary vector ``(B_1 < ... < B_{K-1})`` (tokens), per-
boundary compression bandwidths ``gamma_j`` (dimensionless), and
per-pool GPU counts.

The paper's two-pool result (§4-§6) is the exact K=2 special case:
``plan_two_pool`` and ``fleetopt_plan`` are thin wrappers over the
same K-pool evaluation path, so K=2 plans are bit-for-bit identical to
the generalized planner's output.  The optimality logic is the paper's
equal-marginal-GPU-cost condition (Prop. 1): at an optimal boundary
vector, moving any B_j cannot lower total cost because the marginal
GPU cost of admitting longer requests into pool j equals the marginal
cost of keeping them in pool j+1 — the discrete sweep below realises
that condition by direct search over boundary candidates (DESIGN.md
"K-pool generalization").

Units used throughout this module:
  * context sizes / boundaries ``B``, ``c_max``  — tokens
  * arrival rates ``lam``                        — requests/second
  * latencies ``t_slo``, ``w99_s``, ``ttft``     — seconds
  * ``annual_cost``                              — $/year
  * ``gamma``                                    — dimensionless (>= 1)
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.naming import pool_names  # noqa: F401  (re-exported API)
from repro_torch.core.profiles import A100_LLAMA70B, HardwareProfile
from repro_torch.core.queueing import ServiceMoments, kimura_w99, service_moments
from repro_torch.core.workload import Workload

RHO_MAX = 0.85          # utilization cap (paper §4.1), dimensionless
GAMMA_GRID = tuple(round(1.0 + 0.1 * i, 1) for i in range(11))  # 1.0 .. 2.0
DEFAULT_B_CANDIDATES = (1024, 1536, 2048, 3072, 4096, 6144, 8192, 12288, 16384)
# reduced candidate grid for the combinatorial K>=3 boundary search
# (C(9,3)=84 combos x ~60 gamma evaluations is a benchmark-scale sweep,
# not a planner call; the coarse grid keeps K=4 searches interactive)
COARSE_B_CANDIDATES = (1024, 2048, 4096, 8192, 16384, 32768)
_N_MC = 30_000          # Monte-Carlo sample size for service moments


@dataclasses.dataclass(frozen=True)
class PoolPlan:
    """Sizing of one pool (paper Eq. 11).  All rates are req/s, times
    seconds, contexts tokens."""
    n_gpus: int              # GPUs (or accelerator chips) in the pool
    n_max: int               # concurrent KV slots per GPU
    c_max: int               # pool context window (tokens)
    lam: float               # arrival rate into the pool (req/s)
    mu_gpu: float            # GPU-level service rate (req/s)
    utilization: float       # rho_ana = lam / (n * mu_gpu), dimensionless
    w99_s: float             # P99 queue wait (s), Kimura approximation
    ttft_p99_s: float        # W99 + prefill + one decode iter (s)
    moments: ServiceMoments  # slot-occupancy moments (paper Eq. 4)
    name: str = "pool"       # "short"/"long" (K<=2) or "pool{i}"
    profile: Optional[HardwareProfile] = None  # hardware this pool runs on


@dataclasses.dataclass(frozen=True)
class FleetPlan:
    """A K-pool fleet: ``pools[i]`` serves requests with
    ``boundaries[i-1] < L_total <= boundaries[i]`` (edges 0 and
    +inf implied), with C&R compressing requests in the band
    ``(B_j, gamma_j * B_j]`` down one pool tier (paper §5).

    The legacy two-pool accessors (``short``, ``long``, ``b_short``,
    ``gamma``) are preserved as properties so K=2 call sites — the
    paper's main result — read exactly as before.
    """
    workload: str
    pools: Tuple[PoolPlan, ...]       # shortest-context pool first
    boundaries: Tuple[int, ...]       # (B_1 < ... < B_{K-1}), tokens
    gammas: Tuple[float, ...]         # per-boundary C&R bandwidth (>= 1)
    annual_cost: float                # sum of per-pool profile costs, $/yr
    total_gpus: int
    alpha_eff: float                  # traffic fraction below the top pool

    @property
    def k(self) -> int:
        """Number of pools."""
        return len(self.pools)

    @property
    def b_short(self) -> int:
        """First boundary B_1 (legacy K=2 view); the pool context for
        a homogeneous (K=1) plan."""
        return int(self.boundaries[0]) if self.boundaries \
            else self.pools[0].c_max

    @property
    def gamma(self) -> float:
        """First boundary's compression bandwidth (legacy K=2 view)."""
        return self.gammas[0] if self.gammas else 1.0

    @property
    def short(self) -> Optional[PoolPlan]:
        """Shortest-context pool; None for a homogeneous plan (legacy)."""
        return self.pools[0] if len(self.pools) > 1 else None

    @property
    def long(self) -> PoolPlan:
        """Longest-context (worst-case) pool."""
        return self.pools[-1]

    def pool(self, name: str) -> PoolPlan:
        """Look a pool up by its canonical name ("short", "pool2", ...)."""
        for p in self.pools:
            if p.name == name:
                return p
        raise KeyError(f"no pool named {name!r} in plan "
                       f"({[p.name for p in self.pools]})")

    def summary(self) -> str:
        if self.k <= 2:
            s = self.short.n_gpus if self.short else 0
            return (f"{self.workload}: B*={self.b_short} gamma*={self.gamma} "
                    f"n_s={s} n_l={self.long.n_gpus} "
                    f"total={self.total_gpus} "
                    f"cost=${self.annual_cost/1e3:.0f}K/yr")
        bs = "/".join(str(b) for b in self.boundaries)
        gs = "/".join(f"{g:g}" for g in self.gammas)
        ns = "+".join(f"{p.n_gpus}x{p.profile.name if p.profile else '?'}"
                      for p in self.pools)
        return (f"{self.workload}: K={self.k} B*=({bs}) gamma*=({gs}) "
                f"n=({ns}) total={self.total_gpus} "
                f"cost=${self.annual_cost/1e3:.0f}K/yr")


class Infeasible(RuntimeError):
    """Raised when no fleet satisfies the TTFT SLO at the given point
    (e.g. the prefill alone exceeds t_slo for the pool's context)."""


def size_pool(lam_p: float, l_in: np.ndarray, l_out: np.ndarray,
              profile: HardwareProfile, c_max: int, t_slo: float,
              rho_max: float = RHO_MAX, prefill_stat: str = "mean",
              tail_margin: float = 0.0, name: str = "pool") -> PoolPlan:
    """Minimum GPU count for one pool (paper Eq. 11 + rho_max floor).

    Args (units): ``lam_p`` req/s into the pool; ``l_in``/``l_out``
    token arrays sampled from the workload; ``c_max`` tokens;
    ``t_slo`` seconds (P99 TTFT target).

    Prefill chunks run compute-bound at W ms/chunk (not the decode
    iteration latency W + H*n): the paper's reported per-pool TTFTs
    (§7.4) are only consistent with this reading — see DESIGN.md §6.
    ``prefill_stat="p99"`` selects the strict Eq. 8 form.

    ``tail_margin`` (beyond-paper, EXPERIMENTS.md §Findings): for SMALL
    pools with heavy-tailed service times the Kimura two-moment P99
    wait underestimates badly (DES shows multi-second waits where the
    approximation says ~0). A margin of k sigmas enforces
    c >= a + k*sqrt(a*(1+Cs^2)) slots for offered load a = lam*E[S]
    (Gaussian bound on Poisson occupancy). 0 = paper-faithful.

    Speculative decoding (DESIGN.md §Speculative decoding): a profile
    carrying measured ``spec_kappa`` > 1 emits kappa tokens per
    (1 + spec_overhead)x verify iteration, so decode iterations per
    request become L_out / kappa at the inflated t_iter — the fleet is
    sized by EFFECTIVE tokens/s. kappa == 1 profiles are bit-identical
    to the pre-speculation planner.
    """
    n_max = profile.n_max(c_max)
    t_iter = profile.t_iter(c_max)
    kappa = max(1.0, profile.spec_kappa)
    if kappa > 1.0:
        t_iter = t_iter * (1.0 + profile.spec_overhead)
        l_out = np.asarray(l_out, float) / kappa
    if lam_p <= 0 or len(l_in) == 0:
        m = ServiceMoments(0.0, 0.0, 0.0, 0.0)
        return PoolPlan(0, n_max, c_max, 0.0, math.inf, 0.0, 0.0, 0.0, m,
                        name=name, profile=profile)
    m = service_moments(l_in, l_out, t_iter, profile.c_chunk)
    mu_slot = m.mu
    mu_gpu = n_max * mu_slot
    t_chunk = profile.w_ms / 1000.0          # compute-bound prefill chunk
    iters = (m.p99_prefill_iters if prefill_stat == "p99"
             else m.mean_prefill_iters)
    t_prefill = iters * t_chunk
    t_slo_eff = t_slo - t_prefill - t_iter              # Eq. 8
    if t_slo_eff <= 0:
        raise Infeasible(
            f"prefill ({t_prefill*1e3:.0f} ms, stat={prefill_stat}) exceeds "
            f"the {t_slo*1e3:.0f} ms TTFT SLO for c_max={c_max}")

    n_util = math.ceil(lam_p / (rho_max * mu_gpu))      # utilization floor
    if tail_margin > 0:
        a = lam_p * m.mean                              # offered slot load
        c_safe = a + tail_margin * math.sqrt(a * (1.0 + m.cs2))
        n_util = max(n_util, math.ceil(c_safe / n_max))

    def w99(n: int) -> float:
        return kimura_w99(n * n_max, mu_slot, lam_p, m.cs2)

    lo = max(1, n_util)
    hi = max(lo, int(10 * math.ceil(lam_p / mu_gpu)) + 1)
    if w99(lo) <= t_slo_eff:
        n = lo
    else:
        while w99(hi) > t_slo_eff:
            hi *= 2
            if hi > 10_000_000:
                raise Infeasible("Erlang-C inversion diverged")
        # binary search the smallest feasible n in (lo, hi]
        while lo + 1 < hi:
            mid = (lo + hi) // 2
            if w99(mid) <= t_slo_eff:
                hi = mid
            else:
                lo = mid
        n = hi
    w = w99(n)
    return PoolPlan(
        n_gpus=n, n_max=n_max, c_max=c_max, lam=lam_p, mu_gpu=mu_gpu,
        utilization=lam_p / (n * mu_gpu), w99_s=w,
        ttft_p99_s=w + t_prefill + t_iter, moments=m,
        name=name, profile=profile)


@dataclasses.dataclass
class _Samples:
    """One reusable Monte-Carlo draw from the workload."""
    l_total: np.ndarray
    l_in: np.ndarray
    l_out: np.ndarray
    compressible: np.ndarray  # Bernoulli(p_c) mask, fixed across the sweep


def _draw(workload: Workload, seed: int = 0, n: int = _N_MC) -> _Samples:
    l_total, l_in, l_out = workload.sample_arrays(n, seed)
    rng = np.random.default_rng(seed + 1)
    compressible = rng.uniform(size=n) < workload.p_c
    return _Samples(l_total, l_in, l_out, compressible)


def draw_samples(workload: Workload, seed: int = 0,
                 n: int = _N_MC) -> _Samples:
    """Public handle on the planner's Monte-Carlo draw.  Pass the
    result as ``samples=`` to amortize the ~ms sampling cost across
    repeated ``plan_k_pool``/``plan_two_pool`` calls (the paper's
    "<1 ms planner" figure excludes this calibration step)."""
    return _draw(workload, seed, n)


def _split_k(s: _Samples, boundaries: Sequence[int],
             gammas: Sequence[float]
             ) -> Tuple[List[Tuple[np.ndarray, np.ndarray]], List[float]]:
    """Route samples for boundary vector ``boundaries`` and per-boundary
    compression bandwidths ``gammas``.

    Pool i's natural members satisfy ``B_i < l_total <= B_{i+1}``
    (edges 0 and +inf implied).  C&R moves a request down exactly one
    tier: a pool-j request with ``l_total <= gamma_j * B_j`` that is
    compressible and has ``l_out < B_j`` enters pool j-1 with
    ``l_in' = clip(min(l_in, B_j - l_out), 1)`` (Eq. 15: the hard
    no-OOM budget T_c + L_out <= B_j).  Requests whose T_c budget is
    non-positive stay in their natural pool — mirroring the router's
    refusal (router.py ``_compress_and_route``) keeps the planner's
    alpha_eff and service moments consistent with serving.

    Returns ``(per_pool, fracs)`` where ``per_pool[i]`` is the
    ``(l_in, l_out)`` token arrays served by pool i and ``fracs[i]``
    the traffic fraction into pool i.
    """
    bvec = np.asarray(boundaries, dtype=np.float64)
    k = len(boundaries) + 1
    n = len(s.l_total)
    # natural pool: number of boundaries strictly below l_total
    # (l_total == B_j belongs to pool j-1: "<= B" routes short)
    pool_idx = np.searchsorted(bvec, s.l_total, side="left")
    moved_in = [np.zeros(n, bool) for _ in range(k)]
    moved_out = np.zeros(n, bool)
    for j in range(1, k):
        b, g = boundaries[j - 1], gammas[j - 1]
        elig = ((pool_idx == j) & (s.l_total <= g * b)
                & s.compressible & (s.l_out < b))
        moved_in[j - 1] = elig
        moved_out |= elig
    per_pool: List[Tuple[np.ndarray, np.ndarray]] = []
    fracs: List[float] = []
    for i in range(k):
        stay = (pool_idx == i) & ~moved_out
        if i < k - 1 and moved_in[i].any():
            b = boundaries[i]
            lin_c = np.maximum(
                np.minimum(s.l_in[moved_in[i]], b - s.l_out[moved_in[i]]), 1)
            lin = np.concatenate([s.l_in[stay], lin_c])
            lout = np.concatenate([s.l_out[stay], s.l_out[moved_in[i]]])
        else:
            lin, lout = s.l_in[stay], s.l_out[stay]
        per_pool.append((lin, lout))
        fracs.append(len(lin) / n)
    return per_pool, fracs


def _split(s: _Samples, b: int, gamma: float
           ) -> Tuple[Tuple[np.ndarray, np.ndarray],
                      Tuple[np.ndarray, np.ndarray], float]:
    """Legacy two-pool split (K=2 view of ``_split_k``).

    Returns ((l_in_s, l_out_s), (l_in_l, l_out_l), alpha_eff).
    """
    per_pool, fracs = _split_k(s, (b,), (gamma,))
    return per_pool[0], per_pool[1], 1.0 - fracs[1]


def _normalize_profiles(
        profiles: Union[HardwareProfile, Sequence[HardwareProfile]],
        k: int) -> Tuple[HardwareProfile, ...]:
    if isinstance(profiles, HardwareProfile):
        return (profiles,) * k
    profs = tuple(profiles)
    if len(profs) == 1:
        return profs * k
    if len(profs) != k:
        raise ValueError(f"got {len(profs)} profiles for a {k}-pool fleet; "
                         "pass one profile (shared) or exactly K")
    return profs


def _evaluate_k(workload: Workload, lam: float, t_slo: float,
                profiles: Optional[Sequence[HardwareProfile]],
                boundaries: Sequence[int], gammas: Sequence[float],
                c_max_long: int, s: _Samples, rho_max: float,
                tail_margin: float,
                profile_options: Optional[Sequence[HardwareProfile]] = None,
                ) -> FleetPlan:
    """Size a K-pool fleet at a FIXED (boundary vector, gamma vector).

    When ``profile_options`` is given, each pool independently picks
    the cheapest feasible hardware SKU from the options (per-pool
    sizing is separable once the split is fixed, so the greedy per-pool
    choice is exact).
    """
    k = len(boundaries) + 1
    names = pool_names(k)
    per_pool, fracs = _split_k(s, boundaries, gammas)
    c_maxes = tuple(int(b) for b in boundaries) + (c_max_long,)
    pools: List[PoolPlan] = []
    for i in range(k):
        lin, lout = per_pool[i]
        lam_i = fracs[i] * lam
        if profile_options is not None:
            best_p: Optional[PoolPlan] = None
            for prof in profile_options:
                try:
                    cand = size_pool(lam_i, lin, lout, prof, c_maxes[i],
                                     t_slo, rho_max,
                                     tail_margin=tail_margin, name=names[i])
                except Infeasible:
                    continue
                cost = prof.annual_cost(cand.n_gpus)
                if best_p is None or cost < best_p.profile.annual_cost(
                        best_p.n_gpus):
                    best_p = cand
            if best_p is None:
                raise Infeasible(
                    f"no hardware option feasible for pool {names[i]} "
                    f"(c_max={c_maxes[i]})")
            pools.append(best_p)
        else:
            pools.append(size_pool(lam_i, lin, lout, profiles[i], c_maxes[i],
                                   t_slo, rho_max, tail_margin=tail_margin,
                                   name=names[i]))
    total = sum(p.n_gpus for p in pools)
    cost = sum(p.profile.annual_cost(p.n_gpus) for p in pools)
    return FleetPlan(
        workload=workload.name, pools=tuple(pools),
        boundaries=tuple(int(b) for b in boundaries), gammas=tuple(gammas),
        annual_cost=cost, total_gpus=total, alpha_eff=1.0 - fracs[-1])


def _optimize_gammas(workload: Workload, lam: float, t_slo: float,
                     profiles, boundaries: Sequence[int],
                     gamma_grid: Sequence[float], c_max_long: int,
                     s: _Samples, rho_max: float, tail_margin: float,
                     profile_options=None) -> FleetPlan:
    """Best per-boundary gamma vector at a fixed boundary vector.

    K=2 is an exact grid sweep (identical to Algorithm 1's inner loop,
    including the cost-tie preference for smaller gamma).  For K>=3 the
    full grid is ``|grid|^(K-1)`` points, so we run coordinate descent:
    sweep each gamma_j in turn holding the others fixed, repeat until a
    full pass makes no improvement (<= 3 passes in practice — each
    gamma_j only couples pools j and j+1, so the interaction graph is a
    path and descent converges fast).
    """
    nb = len(boundaries)
    gam = [min(gamma_grid)] * nb
    best: Optional[FleetPlan] = None
    try:
        best = _evaluate_k(workload, lam, t_slo, profiles, boundaries, gam,
                           c_max_long, s, rho_max, tail_margin,
                           profile_options)
    except Infeasible:
        pass
    max_passes = 1 if nb == 1 else 3
    for _ in range(max_passes):
        improved = False
        for j in range(nb):
            for g in gamma_grid:
                if g == gam[j]:
                    continue
                trial = list(gam)
                trial[j] = g
                try:
                    p = _evaluate_k(workload, lam, t_slo, profiles,
                                    boundaries, trial, c_max_long, s,
                                    rho_max, tail_margin, profile_options)
                except Infeasible:
                    continue
                # on equal annual cost prefer the smaller gamma vector
                # (less compression risk) — same tie-break as Algorithm 1
                if best is None or p.annual_cost < best.annual_cost or (
                        p.annual_cost == best.annual_cost
                        and tuple(trial) < tuple(gam)):
                    best, gam = p, trial
                    improved = True
        if not improved:
            break
    if best is None:
        raise Infeasible(f"no feasible gamma vector at B={boundaries}")
    return best


def plan_k_pool(workload: Workload, lam: float = 1000.0, t_slo: float = 0.5,
                profiles: Union[HardwareProfile,
                                Sequence[HardwareProfile]] = A100_LLAMA70B,
                boundaries: Optional[Sequence[int]] = None,
                gammas: Optional[Sequence[float]] = None,
                k: Optional[int] = None,
                b_candidates: Optional[Sequence[int]] = None,
                gamma_grid: Sequence[float] = GAMMA_GRID,
                c_max_long: int = 65536, rho_max: float = RHO_MAX,
                samples: Optional[_Samples] = None,
                tail_margin: float = 0.0,
                profile_options: Optional[Sequence[HardwareProfile]] = None,
                ) -> FleetPlan:
    """Plan a K-pool fleet (the generalized Algorithm 1).

    Three calling modes, from cheapest to most exhaustive:

    1. ``boundaries`` + ``gammas`` given — a single fixed-point
       evaluation (the online re-plan path; < 10 ms for K <= 4 with
       precomputed ``samples``, see benchmarks/bench_k_pool_sweep.py).
    2. ``boundaries`` given, ``gammas=None`` — optimize the gamma
       vector at that boundary vector.
    3. ``k`` given — search all sorted (k-1)-subsets of
       ``b_candidates`` for the equal-marginal-cost boundary vector,
       optimizing gammas at each.  ``k=1`` is the homogeneous
       worst-case fleet; ``k=2`` reproduces ``fleetopt_plan``'s best
       plan bit-for-bit.

    ``profiles`` may be a single :class:`HardwareProfile` (shared by
    all pools) or a sequence of exactly K profiles (heterogeneous
    fleet: e.g. TPU-v5e short pools + A100 long pool).  Alternatively
    ``profile_options`` gives a menu of SKUs and each pool picks the
    cheapest feasible one (mixed-hardware search).

    Units: ``lam`` req/s, ``t_slo`` seconds, boundaries/contexts
    tokens, returned ``annual_cost`` $/yr.  Paper §6; K-pool extension
    in DESIGN.md "K-pool generalization".

    Tail-pool caveat: pool arrival rates and service moments are
    Monte-Carlo estimates over ``_N_MC`` samples (the paper's own
    calibration methodology).  A top pool that receives a sub-percent
    traffic fraction is calibrated from only tens of samples, so its
    sizing carries O(10%) relative noise — at K>=3 this can leave a
    thin tail pool a GPU short of its utilization cap under the DES
    (the K=2 analog is the known small-long-pool deviation in
    examples/plan_and_simulate.py).  For such fleets pass
    ``tail_margin`` (sigma-slack on the occupancy bound, see
    :func:`size_pool`) or a larger ``samples=draw_samples(w, n=...)``.
    """
    s = samples or _draw(workload)
    if boundaries is not None:
        boundaries = tuple(int(b) for b in boundaries)
        if any(b2 <= b1 for b1, b2 in zip(boundaries, boundaries[1:])):
            raise ValueError(f"boundaries must be strictly increasing, "
                             f"got {boundaries}")
        if boundaries and boundaries[-1] >= c_max_long:
            raise ValueError(f"boundaries must lie below c_max_long="
                             f"{c_max_long}, got {boundaries}")
        kk = len(boundaries) + 1
        profs = None if profile_options is not None \
            else _normalize_profiles(profiles, kk)
        if gammas is not None:
            if len(gammas) != len(boundaries):
                raise ValueError("need one gamma per boundary")
            return _evaluate_k(workload, lam, t_slo, profs, boundaries,
                               tuple(gammas), c_max_long, s, rho_max,
                               tail_margin, profile_options)
        return _optimize_gammas(workload, lam, t_slo, profs, boundaries,
                                gamma_grid, c_max_long, s, rho_max,
                                tail_margin, profile_options)
    if k is None:
        raise ValueError("pass either a boundary vector or k")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    profs = None if profile_options is not None \
        else _normalize_profiles(profiles, k)
    if k == 1:
        return _evaluate_k(workload, lam, t_slo, profs, (), (), c_max_long,
                           s, rho_max, tail_margin, profile_options)
    if b_candidates is None:
        b_candidates = DEFAULT_B_CANDIDATES if k == 2 else COARSE_B_CANDIDATES
    cands = [b for b in b_candidates if b < c_max_long]
    best: Optional[FleetPlan] = None
    for combo in itertools.combinations(sorted(cands), k - 1):
        try:
            p = _optimize_gammas(workload, lam, t_slo, profs, combo,
                                 gamma_grid, c_max_long, s, rho_max,
                                 tail_margin, profile_options)
        except Infeasible:
            continue
        # total order on ties: smaller gammas, then smaller boundaries
        # (matches Algorithm 1's (gamma, B) preference for K=2)
        if best is None or p.annual_cost < best.annual_cost or (
                p.annual_cost == best.annual_cost and
                (p.gammas, p.boundaries) < (best.gammas, best.boundaries)):
            best = p
    if best is None:
        raise Infeasible(f"no feasible {k}-pool boundary vector")
    return best


def plan_two_pool(workload: Workload, lam: float, t_slo: float,
                  profile: HardwareProfile, b_short: int, gamma: float,
                  c_max_long: int = 65536, samples: Optional[_Samples] = None,
                  rho_max: float = RHO_MAX,
                  tail_margin: float = 0.0) -> FleetPlan:
    """Size a two-pool fleet at a FIXED (B_short, gamma) — the paper's
    PR (gamma=1) and PR+C&R retrofit (gamma=1.5) baselines.

    Exact K=2 special case of :func:`plan_k_pool` (same code path, so
    the generalized planner reproduces it bit-for-bit).  Units: ``lam``
    req/s, ``t_slo`` s, ``b_short`` tokens.  Paper §4.2, Table 3.
    """
    return plan_k_pool(workload, lam, t_slo, profiles=profile,
                       boundaries=(b_short,), gammas=(gamma,),
                       c_max_long=c_max_long, samples=samples,
                       rho_max=rho_max, tail_margin=tail_margin)


def plan_homogeneous(workload: Workload, lam: float, t_slo: float,
                     profile: HardwareProfile, c_max: int = 65536,
                     rho_max: float = RHO_MAX) -> FleetPlan:
    """Single pool sized for worst-case context (paper baseline 1,
    §7.2): every GPU provisions ``c_max`` tokens of KV, so slot count
    — and with it fleet cost — is set by the longest request.  The
    K=1 special case of :func:`plan_k_pool`."""
    return plan_k_pool(workload, lam, t_slo, profiles=profile,
                       boundaries=(), gammas=(), c_max_long=c_max,
                       rho_max=rho_max)


def fleetopt_plan(workload: Workload, lam: float = 1000.0,
                  t_slo: float = 0.5,
                  profile: HardwareProfile = A100_LLAMA70B,
                  b_candidates: Sequence[int] = DEFAULT_B_CANDIDATES,
                  gamma_grid: Sequence[float] = GAMMA_GRID,
                  c_max_long: int = 65536,
                  rho_max: float = RHO_MAX,
                  fixed_b: Optional[int] = None,
                  tail_margin: float = 0.0,
                  ) -> Tuple[FleetPlan, Dict[Tuple[int, float], float]]:
    """Algorithm 1 (two-pool): sweep (B, gamma), recalibrating mu_l
    from the post-compression distribution at every point (the paper's
    critical step 6 — the split keeps only l_total > gamma*B in the
    long pool).  For K != 2 use :func:`plan_k_pool`.

    Returns (best_plan, {(B, gamma): annual_cost ($/yr)})."""
    s = _draw(workload)
    grid: Dict[Tuple[int, float], float] = {}
    best: Optional[FleetPlan] = None
    cands = [fixed_b] if fixed_b else [b for b in b_candidates if b < c_max_long]
    for b in cands:
        for g in gamma_grid:
            try:
                p = plan_two_pool(workload, lam, t_slo, profile, b, g,
                                  c_max_long, samples=s, rho_max=rho_max,
                                  tail_margin=tail_margin)
            except Infeasible:
                continue
            grid[(b, g)] = p.annual_cost
            # on equal annual cost prefer smaller gamma (less compression
            # risk), then smaller B (tighter short pool)
            if best is None or p.annual_cost < best.annual_cost or (
                    p.annual_cost == best.annual_cost and
                    (g, b) < (best.gamma, best.b_short)):
                best = p
    if best is None:
        raise Infeasible("no feasible (B, gamma) point")
    return best, grid
