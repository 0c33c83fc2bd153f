"""Discrete-event fleet simulator — the inference-fleet-sim analog
(paper §7.4, [Chen et al. 2026c]) — generalized to K-pool fleets.

Each pool is simulated as c = n_gpus * n_max KV slots with FIFO
queueing; a request occupies a slot for
S = (ceil(L_in/C_chunk) + L_out) * t_iter seconds (the same service
model the analytical planner uses — the validation checks that the
*queueing* abstractions agree, exactly as the paper's DES does).
Records the fraction of slot-time busy (GPU utilization rho_hat) and
empirical queue-wait percentiles.

The gateway decision rule is the vectorized mirror of
``GatewayRouter.route`` over the plan's boundary vector: a pool-j
request inside the band ``(B_j, gamma_j * B_j]`` compresses down one
tier with probability p_c.  Heterogeneous plans simulate each pool
with its own :class:`HardwareProfile` (t_iter, chunk size).

Fleets at paper scale have up to ~33k slots and mean occupancies of
minutes, so reaching steady state with a full-fleet event loop would
need millions of arrivals. We exploit the many-server regime the paper
itself identifies (§7.4): each pool is *Poisson-thinned* to at most
``max_sim_slots`` slots (keeping lambda/c fixed, which preserves
utilization and the Erlang-C wait probability's scale regime), and the
horizon is set to ``horizon_services`` mean service times.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.core.planner import FleetPlan, PoolPlan
from repro_torch.core.profiles import (DEFAULT_KV_BLOCK,
                                 DEFAULT_TAIL_MARGIN_BLOCKS,
                                 HardwareProfile)
from repro_torch.core.workload import Workload


@dataclasses.dataclass
class PoolStats:
    name: str
    n_gpus: int
    n_slots: int              # simulated slots (after thinning)
    served: int
    busy_time: float
    horizon: float
    waits: np.ndarray
    ttfts: np.ndarray
    thin_frac: float
    shed: int = 0             # refused by stability-aware admission
    preempted: int = 0        # slot preemptions (overload survival)
    migrated: int = 0         # in-service at a live re-provisioning step

    @property
    def goodput_frac(self) -> float:
        """Fraction of offered requests actually served (1 - shed)."""
        offered = self.served + self.shed
        return self.served / offered if offered else 1.0

    @property
    def utilization(self) -> float:
        if self.horizon <= 0 or self.n_slots == 0:
            return 0.0
        return self.busy_time / (self.n_slots * self.horizon)

    def wait_p99(self) -> float:
        return float(np.percentile(self.waits, 99)) if len(self.waits) else 0.0

    def ttft_p99(self) -> float:
        return float(np.percentile(self.ttfts, 99)) if len(self.ttfts) else 0.0


def simulate_pool(arrivals: np.ndarray, l_in: np.ndarray, l_out: np.ndarray,
                  c_slots: int, t_iter: float, t_chunk: float,
                  c_chunk: int, warmup: float, name: str = "pool",
                  n_gpus: int = 0, thin_frac: float = 1.0,
                  max_queue_wait: Optional[float] = None,
                  preempt: bool = False,
                  swap_s: float = 0.0,
                  reconfig_at: Optional[float] = None,
                  reconfig_slots: Optional[int] = None,
                  migration_s: float = 0.0) -> PoolStats:
    """Event-driven M/G/c slot simulation for one pool (FIFO).

    Overload-survival extensions (DESIGN.md §Overload survival; both
    default OFF, leaving the base path byte-identical):

      * ``max_queue_wait``: stability-aware admission — an arrival is
        SHED (never served, excluded from wait/TTFT stats) when the
        queue-wait estimate ``(queue+1) * E[S] / c_slots`` exceeds the
        deadline, mirroring the engine's Little's-law estimator.
      * ``preempt``: an arrival that would queue instead preempts the
        most recently STARTED in-service request (the engine's LIFO
        victim policy); the victim resumes at the queue FRONT with its
        remaining service plus ``2 * swap_s`` (swap-out + swap-in).
        Each request is preempted at most once (anti-thrash).

    Live re-provisioning transient (DESIGN.md §Live re-provisioning;
    the DES mirror of ``FleetRuntime.reprovision``; default OFF):

      * ``reconfig_at`` / ``reconfig_slots``: at the first event time
        >= ``reconfig_at`` the pool's capacity steps to
        ``reconfig_slots``. Every in-service request is checkpointed —
        it resumes at the queue FRONT (in arrival order, ahead of
        queued work, exactly the engine's restore order) with its
        remaining service plus ``migration_s`` (the swap-out +
        swap-in + rebuild penalty per request). Nothing is dropped;
        the transient shows up as a wait/TTFT bump around the step.
    """
    from collections import deque
    n = len(arrivals)
    service = (np.ceil(l_in / c_chunk) + l_out) * t_iter
    prefill = np.ceil(l_in / c_chunk) * t_chunk
    starts = np.empty(n)
    if max_queue_wait is None and not preempt and reconfig_at is None:
        busy_heap: list = []  # completion times of in-service requests
        queue: deque = deque()  # FIFO of waiting request indices
        for i in range(n):
            t = arrivals[i]
            # free slots up to t; freed slots admit queued requests FIFO
            while busy_heap and busy_heap[0] <= t:
                tc = heapq.heappop(busy_heap)
                if queue:
                    j = queue.popleft()
                    starts[j] = tc      # tc >= arrivals[j] (it was queued)
                    heapq.heappush(busy_heap, tc + service[j])
            if len(busy_heap) < c_slots:
                starts[i] = t
                heapq.heappush(busy_heap, t + service[i])
            else:
                queue.append(i)
        while queue:                    # drain
            tc = heapq.heappop(busy_heap)
            j = queue.popleft()
            starts[j] = tc
            heapq.heappush(busy_heap, tc + service[j])
        shed_count = preempt_count = migrated = 0
        shed_mask = np.zeros(n, bool)
    else:
        (starts, shed_mask, shed_count, preempt_count,
         migrated) = _simulate_overload(
            arrivals, service, c_slots, max_queue_wait, preempt, swap_s,
            reconfig_at, reconfig_slots, migration_s)
        if reconfig_slots is not None:
            c_slots = max(c_slots, reconfig_slots)   # utilization denom

    # Busy-time accounting (documented invariant): the measurement
    # window is [warmup, last arrival] — the interval where the pool is
    # in (time-)steady state — and every request whose service STARTS
    # inside the window is credited its FULL service time, including
    # the part completing after the last arrival. The previous code
    # clipped busy time at arrivals[-1], dropping exactly the drain-tail
    # service of small pools and biasing rho_hat low (busy/denominator
    # mismatch); start-credited full service is the throughput * E[S]
    # estimator, which is unbiased in steady state and needs no clipping.
    t_end = arrivals[-1] if n else warmup
    t0, t1 = warmup, max(t_end, warmup)
    started = (starts >= t0) & (starts <= t1)
    busy_time = float(service[started].sum())
    waits = starts - arrivals
    ttfts = waits + prefill + t_iter
    # shed requests never start: they carry no wait/TTFT sample (their
    # cost shows up in goodput_frac, not the latency tail)
    mask = (arrivals >= t0) & ~shed_mask
    return PoolStats(name=name, n_gpus=n_gpus, n_slots=c_slots,
                     served=n - shed_count,
                     busy_time=busy_time, horizon=t1 - t0,
                     waits=waits[mask], ttfts=ttfts[mask],
                     thin_frac=thin_frac, shed=shed_count,
                     preempted=preempt_count, migrated=migrated)


def _simulate_overload(arrivals: np.ndarray, service: np.ndarray,
                       c_slots: int, max_queue_wait: Optional[float],
                       preempt: bool, swap_s: float,
                       reconfig_at: Optional[float] = None,
                       reconfig_slots: Optional[int] = None,
                       migration_s: float = 0.0):
    """Slot simulation with shedding, preemption and/or a live
    re-provisioning capacity step — the DES mirror of the engine's
    overload + reconfiguration policies (see simulate_pool's
    docstring). Returns (starts, shed_mask, shed_count, preempt_count,
    migrated); a shed request's start is +inf."""
    from collections import deque
    n = len(arrivals)
    es_mean = float(service.mean()) if n else 0.0
    starts = np.full(n, np.inf)
    rem = service.copy()            # remaining service at (re)start
    comp_heap: list = []            # (completion_time, j)
    start_heap: list = []           # (-start_time, j, completion) LIFO
    cur_tc = np.full(n, -1.0)       # j's current scheduled completion
    in_service = np.zeros(n, bool)
    queue: deque = deque()          # waiting indices; preempted at FRONT
    preempted_once = set()
    n_busy = 0
    shed_mask = np.zeros(n, bool)
    preempt_count = 0
    migrated = 0

    def start(j, t):
        nonlocal n_busy
        if starts[j] == np.inf:
            starts[j] = t
        tc = t + rem[j]
        cur_tc[j] = tc
        in_service[j] = True
        heapq.heappush(comp_heap, (tc, j))
        heapq.heappush(start_heap, (-t, j, tc))
        n_busy += 1

    def drain(t):
        nonlocal n_busy
        while comp_heap and comp_heap[0][0] <= t:
            tc, j = heapq.heappop(comp_heap)
            if not in_service[j] or cur_tc[j] != tc:
                continue            # lazily removed (preempted/restarted)
            in_service[j] = False
            n_busy -= 1
            if queue:
                start(queue.popleft(), tc)

    def reconfigure(t_rc):
        # live re-provisioning step: checkpoint every in-service
        # request (remaining service + per-request migration penalty),
        # requeue them at the FRONT in arrival order — ahead of queued
        # work, the engine's restore order — then restart into the new
        # slot count. Planned migration does not consume the
        # anti-thrash preemption budget.
        nonlocal n_busy, c_slots, migrated
        drain(t_rc)
        live = [j for j in range(n) if in_service[j]]
        for j in reversed(live):
            in_service[j] = False
            rem[j] = cur_tc[j] - t_rc + migration_s
            queue.appendleft(j)
        migrated = len(live)
        n_busy = 0
        if reconfig_slots is not None:
            c_slots = reconfig_slots
        while queue and n_busy < c_slots:
            start(queue.popleft(), t_rc)

    for i in range(n):
        t = arrivals[i]
        if reconfig_at is not None and t >= reconfig_at:
            reconfigure(reconfig_at)
            reconfig_at = None
        drain(t)
        if n_busy < c_slots:
            start(i, t)
            continue
        # stability-aware admission: shed once the estimated wait
        # (Little's law over the current backlog) exceeds the deadline
        if max_queue_wait is not None and \
                (len(queue) + 1) * es_mean / c_slots > max_queue_wait:
            shed_mask[i] = True
            continue
        if preempt:
            victim = None
            skipped = []        # valid entries shielded by anti-thrash
            while start_heap:
                entry = heapq.heappop(start_heap)
                _, j, tc = entry
                if not in_service[j] or cur_tc[j] != tc:
                    continue    # stale entry (completed/restarted)
                if j in preempted_once:
                    skipped.append(entry)
                    continue
                victim = j
                break
            for e in skipped:
                heapq.heappush(start_heap, e)
            if victim is not None:
                in_service[victim] = False
                n_busy -= 1
                preempted_once.add(victim)
                preempt_count += 1
                # victim resumes at the queue FRONT with its remaining
                # service plus the swap-out + swap-in penalty
                rem[victim] = cur_tc[victim] - t + 2.0 * swap_s
                queue.appendleft(victim)
                start(i, t)
                continue
        queue.append(i)
    # a reconfiguration scheduled after the last arrival still fires:
    # its transient lands on the backlog drain
    if reconfig_at is not None:
        reconfigure(reconfig_at)
        reconfig_at = None
    # drain the backlog
    while queue:
        if not comp_heap:
            break
        tc, j = heapq.heappop(comp_heap)
        if not in_service[j] or cur_tc[j] != tc:
            continue
        in_service[j] = False
        n_busy -= 1
        start(queue.popleft(), tc)
    return starts, shed_mask, int(shed_mask.sum()), preempt_count, migrated


def mmpp_arrivals(n: int, lam: float, rng, burst_factor: float = 1.8,
                  mean_period_s: float = 30.0) -> np.ndarray:
    """Two-state Markov-modulated Poisson arrivals with mean rate
    ``lam``: the rate alternates between lam*burst_factor and
    lam*(2 - burst_factor) (clipped at 0.1*lam; keep burst_factor
    <= 1.9 for an unbiased mean), with exponential state holding
    times. Burstier tails than Poisson at equal load — used to stress
    the planner's small-pool sizing (EXPERIMENTS.md §Findings)."""
    hi = lam * burst_factor
    lo = max(0.1 * lam, lam * (2.0 - burst_factor))
    out = np.empty(n)
    t = 0.0
    i = 0
    state_hi = True
    while i < n:
        period = rng.exponential(mean_period_s)
        rate = hi if state_hi else lo
        # arrival count within a period is Poisson(rate * period) — a
        # deterministic int(rate * period) would understate the burst
        # variance the MMPP exists to model
        k = min(n - i, int(rng.poisson(rate * period)))
        if k > 0:
            gaps = rng.exponential(1.0 / rate, size=k)
            ts = t + np.cumsum(gaps)
            out[i:i + k] = ts
            t = ts[-1]
            i += k
        else:
            t += period        # silent period, clock still advances
        state_hi = not state_hi
    return out


class FleetDES:
    """Drive a K-pool (or homogeneous) fleet from a workload through
    the C&R gateway decision rule, Poisson arrivals at rate lam (or
    MMPP with ``arrival_process="mmpp"``).

    ``profile`` is the fallback hardware when a pool plan carries none
    (plans built by the current planner always do); ``gamma`` (scalar,
    applied to every boundary) or ``gammas`` (per boundary) override
    the plan's compression bandwidths — the legacy validation runs at
    gamma=1.0 to isolate queueing error from compression noise.
    """

    def __init__(self, plan: FleetPlan, profile: Optional[HardwareProfile]
                 = None, workload: Optional[Workload] = None,
                 gamma: Optional[float] = None,
                 gammas: Optional[Sequence[float]] = None,
                 max_sim_slots: int = 4096, horizon_services: float = 40.0,
                 paged: bool = False,
                 kv_block_size: int = DEFAULT_KV_BLOCK,
                 tail_margin_blocks: int = DEFAULT_TAIL_MARGIN_BLOCKS,
                 prefix_hit_rate: Optional[float] = None):
        if workload is None:
            raise ValueError("FleetDES needs the workload to sample from")
        self.plan = plan
        self.profile = profile
        self.workload = workload
        nb = len(plan.boundaries)
        if gammas is not None:
            if len(gammas) != nb:
                raise ValueError("need one gamma per plan boundary")
            self.gammas = tuple(gammas)
        elif gamma is not None:
            self.gammas = (gamma,) * nb
        else:
            self.gammas = plan.gammas
        # legacy scalar view (first boundary's gamma)
        self.gamma = self.gammas[0] if self.gammas else 1.0
        self.max_sim_slots = max_sim_slots
        self.horizon_services = horizon_services
        # paged=True re-derives each pool's per-GPU slot count from the
        # pool-conditional E[L_total] (profiles.n_max_paged) instead of
        # the plan's worst-case n_max(c_max) — the DES view of the
        # paged serving engine at identical HBM.
        self.paged = paged
        self.kv_block_size = kv_block_size
        self.tail_margin_blocks = tail_margin_blocks
        # prefix_hit_rate h (DESIGN.md §Prefix caching): the expected
        # fraction of each prompt already cached on its engine. Hits
        # skip prefill iterations — effective L_in -> (1-h) L_in in the
        # service and TTFT models — and (paged) stop pinning their KV
        # blocks per-request, shrinking each slot's expected residency
        # in n_max_paged. None = use each pool profile's own knob.
        self.prefix_hit_rate = prefix_hit_rate

    def _profile_of(self, pp: PoolPlan) -> HardwareProfile:
        prof = pp.profile or self.profile
        if prof is None:
            raise ValueError(f"pool {pp.name} has no hardware profile and "
                             "no fallback was passed to FleetDES")
        return prof

    def run(self, n_requests: int = 30_000, lam: float = 1000.0,
            seed: int = 0, arrival_process: str = "poisson",
            burst_factor: float = 1.8,
            max_queue_wait: Optional[float] = None,
            preempt: bool = False) -> Dict[str, PoolStats]:
        """Simulate and return per-pool stats keyed by pool name
        ("short"/"long" for K<=2, "pool{i}" for K>=3).

        ``max_queue_wait`` (seconds) / ``preempt`` switch each pool's
        simulation into the overload-survival policy (see
        simulate_pool); the swap penalty is the pool profile's
        ``swap_seconds`` over its band's mean KV tokens."""
        w, plan = self.workload, self.plan
        rng = np.random.default_rng(seed)
        k = plan.k
        active = [pp for pp in plan.pools if pp.n_gpus > 0]
        if not active:
            return {}

        # horizon long enough for the slowest pool to reach steady state
        max_es = max(pp.moments.mean for pp in active if pp.moments.mean)
        horizon = self.horizon_services * max_es
        n_total = max(n_requests, int(lam * horizon * 1.15))

        l_total, l_in, l_out = w.sample_arrays(n_total, seed)
        if arrival_process == "mmpp":
            arrivals = mmpp_arrivals(n_total, lam, rng, burst_factor)
        else:
            arrivals = np.cumsum(rng.exponential(1.0 / lam, size=n_total))
        rng.uniform(size=n_total)       # category draw (kept for rng parity)

        # vectorized gateway decision (same rule as GatewayRouter.route)
        if k >= 2:
            bvec = np.asarray(plan.boundaries, dtype=np.float64)
            pool_idx = np.searchsorted(bvec, l_total, side="left")
            li = l_in.copy()
            # one compressibility coin per request, shared across
            # boundaries (a request is prose/RAG or it is not)
            ok = rng.uniform(size=n_total) < w.p_c
            for j in range(1, k):
                b, g = plan.boundaries[j - 1], self.gammas[j - 1]
                # router refuses compression when T_c = b - l_out <= 0
                # (router.py _compress_and_route); keep the DES aligned
                elig = ((pool_idx == j) & (l_total <= g * b) & ok
                        & (g > 1.0) & (l_out < b))
                pool_idx[elig] = j - 1
                li[elig] = np.maximum(b - l_out[elig], 1)
        else:
            pool_idx = np.zeros(n_total, dtype=np.int64)
            li = l_in

        # a pool planned at 0 GPUs cannot serve: its band escalates to
        # the next provisioned pool ABOVE (longer context always fits;
        # going down would overflow KV).  Traffic above the top
        # provisioned pool is unservable and excluded from the stats.
        for i, pp in enumerate(plan.pools[:-1]):
            if pp.n_gpus == 0:
                pool_idx[pool_idx == i] = i + 1

        name_to_idx = {pp.name: i for i, pp in enumerate(plan.pools)}
        out: Dict[str, PoolStats] = {}
        l_tok = li + l_out              # post-compression KV occupancy
        for pp in active:
            mask = pool_idx == name_to_idx[pp.name]
            prof = self._profile_of(pp)
            h = self.prefix_hit_rate if self.prefix_hit_rate is not None \
                else prof.prefix_hit_rate
            # cached prefix tokens skip their prefill iterations: the
            # engine resumes at the first cold token (engine.py)
            li_eff = li * (1.0 - h) if h else li
            if self.paged:
                prof_eff = prof if prof.prefix_hit_rate == h else \
                    dataclasses.replace(prof, prefix_hit_rate=h)
                mean_tok = (float(l_tok[mask].mean()) if mask.any()
                            else float(pp.c_max))
                mean_in = float(li[mask].mean()) if mask.any() else 0.0
                n_slot = prof_eff.n_max_paged(mean_tok, self.kv_block_size,
                                              self.tail_margin_blocks,
                                              mean_prompt_tokens=mean_in)
                t_it = prof_eff.t_iter_paged(mean_tok, self.kv_block_size,
                                             self.tail_margin_blocks,
                                             mean_prompt_tokens=mean_in)
            else:
                n_slot = pp.n_max
                t_it = prof.t_iter(pp.c_max)
            # Poisson-thin the pool to <= max_sim_slots slots
            c_full = pp.n_gpus * n_slot
            thin = min(1.0, self.max_sim_slots / c_full)
            c_sim = max(1, int(round(c_full * thin)))
            thin = c_sim / c_full
            keep = mask & (rng.uniform(size=n_total) < thin)
            idx = np.where(keep)[0]
            swap_s = 0.0
            if preempt:
                band_tok = float(l_tok[mask].mean()) if mask.any() \
                    else float(pp.c_max)
                swap_s = prof.swap_seconds(band_tok)
            out[pp.name] = simulate_pool(
                arrivals[idx], li_eff[idx], l_out[idx],
                c_sim, t_it,
                prof.w_ms / 1000.0, prof.c_chunk,
                warmup=0.25 * horizon, name=pp.name, n_gpus=pp.n_gpus,
                thin_frac=thin, max_queue_wait=max_queue_wait,
                preempt=preempt, swap_s=swap_s)
        return out


def validation_table(plan: FleetPlan, profile: Optional[HardwareProfile]
                     = None, workload: Optional[Workload] = None,
                     gamma: Optional[float] = 1.0, seed: int = 0,
                     gammas: Optional[Sequence[float]] = None) -> list:
    """Paper Table 5: analytical vs DES utilization, one row per pool.

    ``gamma`` defaults to 1.0 (the paper's validation isolates the
    queueing model from compression); pass ``gamma=None`` to simulate
    at the plan's own gamma vector, or ``gammas`` for per-boundary
    control.  Error is (rho_ana - rho_des) / rho_des, dimensionless.
    """
    des = FleetDES(plan, profile, workload, gamma=gamma, gammas=gammas)
    stats = des.run(seed=seed)
    by_name = {pp.name: pp for pp in plan.pools}
    rows = []
    for name, ps in stats.items():
        pp = by_name[name]
        rho_ana = pp.utilization
        rho_hat = ps.utilization
        rows.append({
            "pool": name, "n_gpus": pp.n_gpus, "rho_ana": rho_ana,
            "rho_des": rho_hat,
            "error": (rho_ana - rho_hat) / rho_hat if rho_hat else math.inf,
        })
    return rows
