"""Empirical-CDF fleet planning (DESIGN.md §Serving API).

The paper's planner consumes a MODELED workload (a PiecewiseCDF plus
an output-length power law). A live gateway sees the real thing: every
admitted request is one draw from the distribution actually arriving.
This module turns those observations into the planner's input:

* :class:`PromptHistogram` — a rolling joint histogram of
  (L_in, L_out) over log-spaced total-length bins with exponential
  decay, cheap enough to update on every admission (two array writes)
  and to snapshot on every re-plan tick.
* :func:`fleetopt_plan_empirical` — runs the SAME `plan_k_pool`
  machinery (Algorithm 1, generalized) over a Monte-Carlo resample of
  the histogram instead of a workload draw. Fed samples drawn from a
  known workload CDF, it converges to the analytic plan
  (tests/test_empirical_plan.py) — which is what licenses using it as
  the closed-loop re-planner behind the serving gateway
  (serving/replanner.py): same optimizer, empirical input.
"""
from __future__ import annotations

import bisect
import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.planner import (GAMMA_GRID, RHO_MAX, FleetPlan, _N_MC,
                                _Samples, plan_k_pool)
from repro_torch.core.profiles import A100_LLAMA70B, HardwareProfile


class _EmpiricalWorkload:
    """Duck-typed stand-in for the planner's Workload argument when
    the samples are observations, not model draws (`plan_k_pool` only
    reads ``.name`` once samples are supplied)."""
    name = "empirical"


_EMPIRICAL = _EmpiricalWorkload()


class PromptHistogram:
    """Rolling (L_in, L_out) histogram over log-spaced L_total bins.

    Per bin it keeps a decayed observation weight plus decayed sums of
    l_in and l_out — enough to resample representative (l_in, l_out)
    pairs bin-proportionally for the planner. ``bins_per_octave=8``
    gives ~9% length resolution per bin, far below the planner's
    boundary-candidate spacing, so binning noise does not move B*.

    ``decay(factor)`` ages the whole histogram multiplicatively; the
    re-planner calls it once per tick, making the effective window a
    few ticks of traffic — a shifted arrival mix shows up in the next
    plan instead of being averaged away by history.
    """

    def __init__(self, lo: int = 8, hi: int = 1 << 20,
                 bins_per_octave: int = 8):
        if lo < 2 or hi <= lo:
            raise ValueError(f"bad histogram range [{lo}, {hi}]")
        n_bins = int(math.ceil(math.log2(hi / lo) * bins_per_octave)) + 1
        # edges[i] <= l_total < edges[i+1] maps to bin i; the two
        # open ends clamp into the first/last bin
        self.edges = lo * np.exp2(np.arange(n_bins + 1)
                                  / float(bins_per_octave))
        self.weight = np.zeros(n_bins)
        self.sum_lin = np.zeros(n_bins)
        self.sum_lout = np.zeros(n_bins)
        self.observed = 0              # lifetime count, never decayed

    def observe(self, l_in: int, l_out: int) -> None:
        """Fold one request (prompt tokens, output tokens) in. The
        gateway records ACTUAL output lengths at completion — planning
        on max_tokens caps would re-introduce exactly the worst-case
        conservatism the planner exists to avoid."""
        t = max(2.0, float(l_in) + float(l_out))
        b = min(bisect.bisect_right(self.edges, t) - 1,
                len(self.weight) - 1)
        b = max(b, 0)
        self.weight[b] += 1.0
        self.sum_lin[b] += float(l_in)
        self.sum_lout[b] += float(l_out)
        self.observed += 1

    def decay(self, factor: float = 0.5) -> None:
        """Age every bin by ``factor`` (0 < factor <= 1)."""
        if not 0.0 < factor <= 1.0:
            raise ValueError(f"decay factor must be in (0, 1], "
                             f"got {factor}")
        self.weight *= factor
        self.sum_lin *= factor
        self.sum_lout *= factor

    @property
    def total_weight(self) -> float:
        return float(self.weight.sum())

    def to_arrays(self, n: int = _N_MC,
                  seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """Resample ``n`` (l_in, l_out) pairs, bins chosen
        weight-proportionally, each sample at its bin's mean lengths —
        the planner's service moments see the observed mix, not the
        bin edges."""
        mask = self.weight > 0
        if not mask.any():
            raise ValueError("empty histogram: nothing observed yet")
        w = self.weight[mask] / self.weight[mask].sum()
        mean_lin = self.sum_lin[mask] / self.weight[mask]
        mean_lout = np.maximum(self.sum_lout[mask] / self.weight[mask],
                               1.0)
        rng = np.random.default_rng(seed)
        idx = rng.choice(len(w), size=n, p=w)
        return mean_lin[idx], mean_lout[idx]

    def quantile(self, q: float) -> float:
        """Approximate L_total quantile (bin upper edges)."""
        if self.total_weight <= 0:
            raise ValueError("empty histogram")
        cum = np.cumsum(self.weight) / self.total_weight
        i = int(np.searchsorted(cum, q, side="left"))
        return float(self.edges[min(i + 1, len(self.edges) - 1)])


def candidate_boundaries(l_total: np.ndarray, c_max_long: int,
                         n: int = 9) -> List[int]:
    """Data-driven boundary candidates: a log-spaced grid from the
    observed median to just past the observed p99.9 (clipped under the
    top pool's context). Mirrors DEFAULT_B_CANDIDATES' ~1.4x spacing
    but at whatever scale the live traffic actually has — the serving
    runtime may run ctx_scale-shrunk boundaries a fixed candidate list
    would never see."""
    lo = max(16.0, float(np.quantile(l_total, 0.5)))
    hi = min(float(np.quantile(l_total, 0.999)) * 1.5,
             float(c_max_long) - 1.0)
    if hi <= lo:
        hi = min(lo * 2.0, float(c_max_long) - 1.0)
        lo = hi / 2.0
    grid = np.unique(np.round(np.geomspace(lo, hi, n)).astype(int))
    return [int(b) for b in grid if 0 < b < c_max_long]


def fleetopt_plan_empirical(
        data: Union[PromptHistogram,
                    Tuple[Sequence[float], Sequence[float]]],
        lam: float, t_slo: float = 0.5,
        profile: Union[HardwareProfile,
                       Sequence[HardwareProfile]] = A100_LLAMA70B,
        *, k: int = 2,
        boundaries: Optional[Sequence[int]] = None,
        gammas: Optional[Sequence[float]] = None,
        b_candidates: Optional[Sequence[int]] = None,
        gamma_grid: Sequence[float] = GAMMA_GRID,
        c_max_long: int = 65536, rho_max: float = RHO_MAX,
        p_c: float = 1.0,
        compressible: Optional[np.ndarray] = None,
        n_samples: int = _N_MC, seed: int = 0,
        tail_margin: float = 0.0) -> FleetPlan:
    """Plan a fleet from OBSERVED traffic (the paper's Algorithm 1
    with the modeled CDF swapped for the live empirical one).

    ``data`` is either a :class:`PromptHistogram` (resampled to
    ``n_samples`` pairs) or raw ``(l_in, l_out)`` arrays — the latter
    makes the planner exactly reproduce the analytic
    :func:`~repro.core.planner.fleetopt_plan` when fed the same draw
    (test-pinned). ``compressible`` overrides the Bernoulli(``p_c``)
    compressibility mask (pass the analytic mask for bit-exact
    comparisons). ``boundaries``/``gammas`` switch to the fixed-point
    re-evaluation mode (< ms — the re-planner's steady-state tick);
    otherwise the full K-pool search runs over ``b_candidates``
    (data-driven by default: :func:`candidate_boundaries`).
    """
    if isinstance(data, PromptHistogram):
        l_in, l_out = data.to_arrays(n_samples, seed)
    else:
        l_in = np.asarray(data[0], np.float64)
        l_out = np.asarray(data[1], np.float64)
        if l_in.shape != l_out.shape or l_in.ndim != 1 or not len(l_in):
            raise ValueError("need matching 1-D (l_in, l_out) arrays")
    l_total = l_in + l_out
    if compressible is None:
        rng = np.random.default_rng(seed + 1)
        compressible = rng.uniform(size=len(l_total)) < p_c
    s = _Samples(l_total, l_in, l_out,
                 np.asarray(compressible, bool))
    if boundaries is not None:
        return plan_k_pool(_EMPIRICAL, lam, t_slo, profiles=profile,
                           boundaries=boundaries, gammas=gammas,
                           gamma_grid=gamma_grid, c_max_long=c_max_long,
                           rho_max=rho_max, samples=s,
                           tail_margin=tail_margin)
    if b_candidates is None:
        b_candidates = candidate_boundaries(l_total, c_max_long)
    return plan_k_pool(_EMPIRICAL, lam, t_slo, profiles=profile, k=k,
                       b_candidates=b_candidates, gamma_grid=gamma_grid,
                       c_max_long=c_max_long, rho_max=rho_max, samples=s,
                       tail_margin=tail_margin)
