"""M/G/c queueing primitives (paper §3).

Log-space Erlang-C (App. A), the Kimura (1994) two-moment M/G/c P99
waiting-time approximation (Eq. 6), and Monte-Carlo service moments
(Eq. 4). All pure numpy — the planner must run in < 1 ms, so these are
vectorized and allocation-light.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
from numpy.typing import NDArray


def erlang_c(c: int, rho: float) -> float:
    """P(wait) for an M/M/c queue at per-server utilization ``rho``
    (paper §3.2).  ``c`` is the slot count (servers), ``rho`` is
    dimensionless in [0, 1); returns a probability.

    Numerically stable recursive/log-space form (paper Eq. 16):
        C(c, rho) = 1 / (1 + (1-rho) * sum_{k=0}^{c-1} c!/(k!) (c rho)^{k-c})
    Computed via log-gamma to avoid overflow at c ~ 1e5.
    """
    if c <= 0:
        return 1.0
    if rho >= 1.0:
        return 1.0
    if rho <= 0.0:
        return 0.0
    # Many-server shortcut (Halfin-Whitt): P(wait) ~ Phi(-sqrt(c)(1-rho));
    # for sqrt(c)(1-rho) > 6 the probability is < 1e-9 — call it 0 so the
    # planner's Erlang inversion stays < 1 ms even at c ~ 3e4 slots.
    if math.sqrt(c) * (1.0 - rho) > 6.0:
        return 0.0
    a = c * rho
    k = np.arange(c)
    # log of c!/(k!) * a^(k-c)  ==  lgamma(c+1) - lgamma(k+1) + (k-c) ln a
    log_terms = math.lgamma(c + 1) - _lgamma_vec(k + 1) + (k - c) * math.log(a)
    # sum in a stable way
    m = log_terms.max()
    s = float(np.exp(log_terms - m).sum())
    denom = 1.0 + (1.0 - rho) * math.exp(m) * s
    return 1.0 / denom


def _lgamma_vec(x: NDArray) -> NDArray:
    from scipy.special import gammaln  # local import; scipy present offline
    return gammaln(x)


def kimura_w99(c: int, mu: float, lam: float, cs2: float) -> float:
    """P99 queue waiting time, Kimura M/G/c approximation (paper Eq. 6).

    W99 = ln(C(c, rho)/0.01) * (1 + Cs^2) / (2 (c mu - lam)).

    Units: ``c`` slots, ``mu`` req/s per slot, ``lam`` req/s into the
    pool, ``cs2`` dimensionless (squared coefficient of variation of
    the service time); returns seconds.  Returns 0 when the wait
    probability is already below 1e-2 (the many-server regime, paper
    §3.1/§7.4) or the queue is empty; +inf when rho >= 1 (unstable).
    """
    if lam <= 0:
        return 0.0
    rho = lam / (c * mu)
    if rho >= 1.0:
        return math.inf
    pc_wait = erlang_c(c, rho)
    if pc_wait <= 0.01:
        return 0.0
    return math.log(pc_wait / 0.01) * (1.0 + cs2) / (2.0 * (c * mu - lam))


@dataclasses.dataclass(frozen=True)
class ServiceMoments:
    """First two moments of the slot-occupancy time S (paper Eq. 4),
    estimated by Monte-Carlo from the routed token distributions."""
    mean: float           # E[S] seconds
    cs2: float            # squared coefficient of variation, dimensionless
    mean_iterations: float       # E[prefill chunks + decode iters]
    p99_prefill_iters: float   # P99 of ceil(L_in / C_chunk), for Eq. 8
    mean_prefill_iters: float = 0.0

    @property
    def mu(self) -> float:
        """Per-slot service rate (req/s per slot)."""
        return 1.0 / self.mean if self.mean > 0 else math.inf


def service_moments(l_in: NDArray, l_out: NDArray, t_iter: float,
                    c_chunk: int = 512) -> ServiceMoments:
    """Monte-Carlo moments of S = (ceil(L_in/C_chunk) + L_out) * t_iter
    (paper Eq. 4).  ``l_in``/``l_out`` are token arrays drawn from the
    workload (post-routing, i.e. per pool), ``t_iter`` seconds per
    lockstep iteration, ``c_chunk`` tokens per prefill chunk."""
    if len(l_in) == 0:
        return ServiceMoments(mean=0.0, cs2=0.0, mean_iterations=0.0,
                              p99_prefill_iters=0.0)
    prefill_iters = np.ceil(l_in / c_chunk)
    iters = prefill_iters + l_out
    s = iters * t_iter
    mean = float(s.mean())
    var = float(s.var())
    cs2 = var / (mean * mean) if mean > 0 else 0.0
    return ServiceMoments(
        mean=mean, cs2=cs2, mean_iterations=float(iters.mean()),
        p99_prefill_iters=float(np.percentile(prefill_iters, 99)),
        mean_prefill_iters=float(prefill_iters.mean()))
