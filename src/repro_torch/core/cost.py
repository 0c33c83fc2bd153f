"""Cost-cliff and GPU-savings formulas (paper §2.2, §5.1), extended to
K-pool heterogeneous fleets.

Units: context sizes in tokens, savings as dimensionless fractions of
the homogeneous-fleet GPU count, costs in $/yr where stated.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

from repro_torch.core.profiles import HardwareProfile


def cliff_ratio(profile: HardwareProfile, b_short: int, c_max_long: int = 65536
                ) -> float:
    """rho = n_max^(s) / n_max^(l): throughput-capacity penalty for the
    first token above ``b_short`` (paper §2.2; 8x @8K, 16x @4K, 42x
    @1.5K on the A100/Llama-3-70B profile).  Dimensionless, >= 1 for
    KV-bound architectures; -> 1 for context-free (SSM) profiles."""
    return profile.n_max(b_short) / profile.n_max(c_max_long)


def pool_cliff_ratios(profiles: Sequence[HardwareProfile],
                      c_maxes: Sequence[int]) -> List[float]:
    """Per-pool capacity advantage over the fleet's top (worst-case)
    pool: ``rho_i = n_max_i(c_i) / n_max_top(c_top)``.

    For a heterogeneous fleet each pool uses ITS OWN profile's slot
    curve, so a TPU-v5e short pool is compared against the A100 top
    pool in slots — the quantity that sets relative GPU counts at
    equal offered load (DESIGN.md "K-pool generalization")."""
    if len(profiles) != len(c_maxes):
        raise ValueError("need one profile per pool")
    n_top = profiles[-1].n_max(c_maxes[-1])
    return [p.n_max(c) / n_top for p, c in zip(profiles, c_maxes)]


def pool_routing_savings(alpha: float, rho: float) -> float:
    """GPU savings fraction for plain two-pool routing (paper §5.1):
    ``alpha * (1 - 1/rho)`` — the alpha fraction of traffic served at
    ``rho``-fold slot density.  ``alpha`` = CDF mass below B_short."""
    return alpha * (1.0 - 1.0 / rho)


def k_pool_savings(fracs: Sequence[float], rhos: Sequence[float]) -> float:
    """K-pool generalization of :func:`pool_routing_savings`:
    ``sum_i frac_i * (1 - 1/rho_i)`` over the non-top pools, where
    ``frac_i`` is pool i's traffic fraction and ``rho_i`` its cliff
    ratio from :func:`pool_cliff_ratios`.  The top pool contributes 0
    by construction (rho_top = 1).  First-order model: it ignores
    per-pool queueing-tail differences, which the planner's exact
    sizing (planner.plan_k_pool) accounts for."""
    if len(fracs) != len(rhos):
        raise ValueError("need one traffic fraction per pool")
    return sum(f * (1.0 - 1.0 / r) for f, r in zip(fracs, rhos))


def cr_incremental_savings(beta: float, p_c: float, rho: float) -> float:
    """Additional savings from C&R beyond pool routing (paper Eq. 14):
    ``delta_alpha * (1 - 1/rho)`` with ``delta_alpha = beta * p_c``
    (beta = CDF mass in the borderline band, p_c = compressibility)."""
    return beta * p_c * (1.0 - 1.0 / rho)


@dataclasses.dataclass(frozen=True)
class CliffRow:
    """One row of the paper's Table 1 (cost-cliff illustration).
    ``cost_ratio`` is capacity consumed relative to a just-below-
    boundary request (dimensionless)."""
    l_total: int
    pool: str
    slots_per_gpu: int
    kv_utilised_frac: float
    cost_ratio: float


def cliff_table(profile: HardwareProfile, b_short: int = 8192,
                c_max_long: int = 65536) -> list:
    """Reproduce paper Table 1: capacity consumed around ``b_short``.

    Rows: at the boundary, one token above it, an interior long-pool
    illustration at ~1.5x the boundary (the paper uses l=12000 for
    B=8192), and the worst case.  The interior row is DERIVED from the
    geometry — clamped to the open interval (b_short+1, c_max_long) —
    rather than hard-coded, so the table stays correct for any
    (b_short, c_max_long) pair (the seed pinned l=12000, which lands
    in the wrong pool for b_short > 12000)."""
    n_s = profile.n_max(b_short)
    n_l = profile.n_max(c_max_long)
    rho = n_s / n_l
    interior = min(int(1.5 * b_short), (b_short + 1 + c_max_long) // 2)
    ls = [b_short, b_short + 1]
    if b_short + 1 < interior < c_max_long:
        ls.append(interior)
    if c_max_long > ls[-1]:
        ls.append(c_max_long)
    rows = []
    for l in ls:
        if l <= b_short:
            rows.append(CliffRow(l, "short", n_s, l / b_short, 1.0))
        else:
            rows.append(CliffRow(l, "long", n_l, l / c_max_long, rho))
    return rows
