"""The port's copy of ``core/empirical.py`` (the twin of
``tests/test_empirical_plan.py``).

Each of the reference test's bodies runs on both packages (the JAX
package's modules and the port's copies): the empirical plan converges
to the analytic planner fed the same draws, and the rolling histogram
tracks a shift of the traffic. Then the two packages' plans and
resamples are held equal on the same observations.
"""
import types

import numpy as np
import pytest

from repro.core import empirical as JE
from repro.core import planner as JP
from repro.core import profiles as JPr
from repro.core import workload as JW
from repro_torch.core import empirical as TE
from repro_torch.core import planner as TP
from repro_torch.core import profiles as TPr
from repro_torch.core import workload as TW

LAM, SLO = 800.0, 0.5

PKGS = {"jax": types.SimpleNamespace(E=JE, P=JP, Pr=JPr, W=JW),
        "torch": types.SimpleNamespace(E=TE, P=TP, Pr=TPr, W=TW)}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


# ------------------------------------------------------ planner equivalence

def test_raw_arrays_bit_exact_vs_analytic(pkg):
    w = pkg.W.get_workload("lmsys")
    s = pkg.P.draw_samples(w, seed=0)
    analytic = pkg.P.plan_k_pool(w, LAM, SLO, profiles=pkg.Pr.A100_LLAMA70B,
                                 k=2, b_candidates=pkg.P.DEFAULT_B_CANDIDATES,
                                 samples=s)
    empirical = pkg.E.fleetopt_plan_empirical(
        (s.l_in, s.l_out), LAM, SLO, pkg.Pr.A100_LLAMA70B, k=2,
        b_candidates=pkg.P.DEFAULT_B_CANDIDATES, compressible=s.compressible)
    assert empirical.boundaries == analytic.boundaries
    assert empirical.gammas == analytic.gammas
    assert empirical.total_gpus == analytic.total_gpus
    assert empirical.annual_cost == analytic.annual_cost


def test_fixed_point_mode_bit_exact(pkg):
    w = pkg.W.get_workload("azure")
    s = pkg.P.draw_samples(w, seed=3)
    analytic = pkg.P.plan_k_pool(w, LAM, SLO, profiles=pkg.Pr.A100_LLAMA70B,
                                 boundaries=(8192,), gammas=(1.5,), samples=s)
    empirical = pkg.E.fleetopt_plan_empirical(
        (s.l_in, s.l_out), LAM, SLO, pkg.Pr.A100_LLAMA70B,
        boundaries=(8192,), gammas=(1.5,), compressible=s.compressible)
    assert (empirical.total_gpus, empirical.annual_cost) == \
        (analytic.total_gpus, analytic.annual_cost)


def _lmsys_histogram(pkg, n=20_000):
    w = pkg.W.get_workload("lmsys")
    s = pkg.P.draw_samples(w, seed=0)
    h = pkg.E.PromptHistogram()
    for li, lo in zip(s.l_in[:n], s.l_out[:n]):
        h.observe(float(li), float(lo))
    return w, s, h


def test_histogram_route_converges(pkg):
    w, s, h = _lmsys_histogram(pkg)
    analytic = pkg.P.plan_k_pool(w, LAM, SLO, profiles=pkg.Pr.A100_LLAMA70B,
                                 k=2, b_candidates=pkg.P.DEFAULT_B_CANDIDATES,
                                 samples=s)
    emp = pkg.E.fleetopt_plan_empirical(
        h, LAM, SLO, pkg.Pr.A100_LLAMA70B, k=2,
        b_candidates=pkg.P.DEFAULT_B_CANDIDATES)
    b_a, b_e = analytic.boundaries[0], emp.boundaries[0]
    assert 0.5 <= b_e / b_a <= 2.0, (b_a, b_e)
    assert abs(emp.annual_cost - analytic.annual_cost) \
        <= 0.10 * analytic.annual_cost


def test_compressibility_mask_default_is_bernoulli(pkg):
    w = pkg.W.get_workload("azure")
    s = pkg.P.draw_samples(w, seed=1)
    full = pkg.E.fleetopt_plan_empirical((s.l_in, s.l_out), LAM, SLO,
                                         boundaries=(8192,), gammas=(1.5,),
                                         p_c=1.0)
    none = pkg.E.fleetopt_plan_empirical((s.l_in, s.l_out), LAM, SLO,
                                         boundaries=(8192,), gammas=(1.5,),
                                         p_c=0.0)
    assert none.total_gpus >= full.total_gpus


def test_raw_array_validation(pkg):
    with pytest.raises(ValueError):
        pkg.E.fleetopt_plan_empirical((np.ones(4), np.ones(3)), LAM)
    with pytest.raises(ValueError):
        pkg.E.fleetopt_plan_empirical((np.ones((2, 2)), np.ones((2, 2))),
                                      LAM)
    with pytest.raises(ValueError):
        pkg.E.fleetopt_plan_empirical((np.ones(0), np.ones(0)), LAM)


# ------------------------------------------------------------- histogram

def test_histogram_observe_quantile_decay(pkg):
    h = pkg.E.PromptHistogram()
    with pytest.raises(ValueError):
        h.to_arrays()
    with pytest.raises(ValueError):
        h.quantile(0.5)
    for _ in range(100):
        h.observe(100, 28)
    assert h.observed == 100 and h.total_weight == pytest.approx(100.0)
    q = h.quantile(0.5)
    assert 100 <= q <= 200
    l_in, l_out = h.to_arrays(n=256, seed=0)
    assert len(l_in) == 256
    assert np.allclose(l_in, 100.0) and np.allclose(l_out, 28.0)
    h.decay(0.5)
    assert h.total_weight == pytest.approx(50.0)
    assert h.observed == 100
    with pytest.raises(ValueError):
        h.decay(0.0)
    with pytest.raises(ValueError):
        h.decay(1.5)


def test_histogram_tracks_shift(pkg):
    h = pkg.E.PromptHistogram()
    for _ in range(200):
        h.observe(4000, 500)
    q_long = h.quantile(0.9)
    for _ in range(4):
        h.decay(0.3)
    for _ in range(200):
        h.observe(200, 50)
    q_short = h.quantile(0.9)
    assert q_short < q_long / 4, (q_long, q_short)


def test_histogram_outlier_clamps_to_edge_bins(pkg):
    h = pkg.E.PromptHistogram(lo=8, hi=1024)
    h.observe(1, 0)
    h.observe(10**9, 10**9)
    assert h.total_weight == pytest.approx(2.0)
    l_in, l_out = h.to_arrays(n=8, seed=0)
    assert np.isfinite(l_in).all() and (l_out >= 1.0).all()


def test_candidate_boundaries_span_observed_quantiles(pkg):
    rng = np.random.default_rng(0)
    l_total = rng.lognormal(7.0, 1.0, size=20_000)
    cands = pkg.E.candidate_boundaries(l_total, c_max_long=65536)
    assert cands == sorted(set(cands))
    assert all(0 < b < 65536 for b in cands)
    p50, p999 = np.quantile(l_total, [0.5, 0.999])
    assert cands[0] >= max(16, int(p50) - 1)
    assert cands[-1] <= p999 * 1.5 + 1
    tight = pkg.E.candidate_boundaries(np.full(100, 500.0), c_max_long=65536)
    assert tight and tight == sorted(set(tight))


# ------------------------------------------------------- across packages

def test_packages_plan_alike_on_one_histogram():
    """The same observations through both packages' histograms: equal
    bins, equal resamples, and equal plans, searched (data-driven
    candidates) and fixed-point."""
    hists = {n: _lmsys_histogram(p, n=5_000)[2] for n, p in PKGS.items()}
    j, t = hists["jax"], hists["torch"]
    for a in ("edges", "weight", "sum_lin", "sum_lout"):
        np.testing.assert_array_equal(getattr(t, a), getattr(j, a))
    for x, y in zip(t.to_arrays(n=512, seed=4), j.to_arrays(n=512, seed=4)):
        np.testing.assert_array_equal(x, y)
    for kw in (dict(k=2), dict(k=3), dict(boundaries=(2048,), gammas=(1.5,))):
        pj = JE.fleetopt_plan_empirical(j, LAM, SLO, n_samples=4096, **kw)
        pt = TE.fleetopt_plan_empirical(t, LAM, SLO, n_samples=4096, **kw)
        assert repr(pt) == repr(pj).replace("repro.", "repro_torch."), kw
