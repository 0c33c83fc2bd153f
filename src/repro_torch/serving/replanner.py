"""Closed-loop fleet re-planning (DESIGN.md §Serving API).

The gateway observes every completion (prompt tokens, ACTUAL output
tokens) into a decaying :class:`~repro.core.empirical.PromptHistogram`;
each ``tick()`` re-runs the paper's planner over that empirical CDF
(:func:`~repro.core.empirical.fleetopt_plan_empirical`) and applies
what can be applied in software:

* **boundary moves DOWN (or sideways)** — a routing-table edit on the
  live :class:`~repro.core.router.GatewayRouter` via
  ``set_boundaries``; takes effect for the next routed request, no
  engine restart, in-flight requests unaffected.
* **boundary moves UP past a pool's provisioned context, or GPU-count
  deltas** — cannot be applied without re-provisioning engines (pool
  i's KV cache was sized for its old boundary), so they are clamped
  and surfaced as a ``recommendation`` in the tick report (and in
  /metrics via ``fleetopt_replan_recommendation``). With
  ``ServingConfig.autoscale`` on, deltas beyond a hysteresis threshold
  are ACTED on instead: ``runtime.reprovision`` live-rebuilds the pool
  (zero-drop KV migration, DESIGN.md §Live re-provisioning); otherwise
  an operator acts on the recommendation out of band.

This split is the paper's own deployment story: B* is enforced in
software at the gateway, capacity is provisioned hardware.
"""
from __future__ import annotations

import time
from typing import List, Optional

from repro_torch.core.empirical import PromptHistogram, fleetopt_plan_empirical
from repro_torch.core.planner import Infeasible
from repro_torch.core.profiles import A100_LLAMA70B


class Replanner:
    """Rolling-histogram re-planner bound to a live FleetRuntime.

    ``lam`` fixes the planning arrival rate (req/s); ``lam=None``
    estimates it from observed arrivals over wall-clock time. ``decay``
    ages the histogram once per tick, so the effective window is a few
    ticks — a CDF shift shows up in the next plan instead of being
    averaged into history. ``min_observed`` gates planning until the
    histogram holds enough weight to mean anything.
    """

    def __init__(self, runtime, *, lam: Optional[float] = None,
                 t_slo: float = 0.5, profile=A100_LLAMA70B,
                 min_observed: int = 32, decay: float = 0.7,
                 n_samples: int = 4096, rho_max: Optional[float] = None,
                 plan_scale: Optional[float] = None,
                 autoscale_hysteresis: float = 0.25):
        self.runtime = runtime
        self.lam = lam
        # relative delta a context/GPU-count recommendation must exceed
        # before the autoscaler (ServingConfig.autoscale) acts on it —
        # re-provisioning checkpoints every in-flight request, so small
        # oscillating deltas must not thrash engines every tick
        self.autoscale_hysteresis = float(autoscale_hysteresis)
        # hardware profiles are calibrated at datacenter token scale;
        # a ctx_scale-shrunk demo runtime observes demo tokens, so the
        # planner runs on lengths * plan_scale and its boundary vector
        # is divided back down before being applied to the router.
        # None = derive from the runtime's recorded ctx_scale.
        if plan_scale is None:
            plan_scale = 1.0 / getattr(runtime, "ctx_scale", 1.0)
        self.plan_scale = float(plan_scale)
        self.t_slo = t_slo
        self.profile = profile
        self.min_observed = int(min_observed)
        self.decay_factor = float(decay)
        self.n_samples = int(n_samples)
        self.rho_max = rho_max
        self.hist = PromptHistogram()
        self.ticks = 0
        self.applied = 0
        self.recommendations: List[str] = []
        self._arrivals = 0
        self._t0: Optional[float] = None
        self.last_report: Optional[dict] = None

    # ------------------------------------------------------------ feed
    def note_arrival(self) -> None:
        if self._t0 is None:
            self._t0 = time.monotonic()
        self._arrivals += 1

    def observe(self, l_in: int, l_out: int) -> None:
        """One completed request: prompt tokens as admitted (post-C&R)
        and the output length actually generated — planning on
        max_tokens caps would re-introduce the worst-case conservatism
        the planner exists to remove."""
        self.hist.observe(l_in, l_out)

    def lam_estimate(self) -> float:
        if self.lam is not None:
            return self.lam
        if self._t0 is None or self._arrivals < 2:
            return 1.0
        return max(self._arrivals / max(time.monotonic() - self._t0,
                                        1e-6), 1.0)

    # ------------------------------------------------------------ tick
    def tick(self) -> dict:
        """One re-plan cycle: plan over the empirical CDF, apply the
        software-applicable boundary move, report the rest. Returns a
        JSON-able report (also kept as ``last_report`` and served by
        POST /admin/replan)."""
        self.ticks += 1
        router = self.runtime.router
        engines = list(self.runtime.engines.values())
        report = {
            "tick": self.ticks,
            "observed": self.hist.observed,
            "window_weight": self.hist.total_weight,
            "applied": False,
            "boundaries_before": list(router.boundaries),
            "boundaries_after": list(router.boundaries),
            "gammas": list(router.gammas),
            "recommendation": None,
            "reason": None,
        }
        if self.hist.total_weight < self.min_observed:
            report["reason"] = (f"insufficient data: window weight "
                                f"{self.hist.total_weight:.0f} < "
                                f"{self.min_observed}")
            self.last_report = report
            return report
        kwargs = {} if self.rho_max is None else {"rho_max": self.rho_max}
        sc = self.plan_scale
        try:
            l_in, l_out = self.hist.to_arrays(self.n_samples,
                                              seed=self.ticks)
            plan = fleetopt_plan_empirical(
                (l_in * sc, l_out * sc), lam=self.lam_estimate(),
                t_slo=self.t_slo, profile=self.profile, k=len(engines),
                c_max_long=max(int(engines[-1].c_max * sc), 2),
                seed=self.ticks, **kwargs)
        except (Infeasible, ValueError) as e:
            report["reason"] = f"plan infeasible on current window: {e}"
            self.hist.decay(self.decay_factor)
            self.last_report = report
            return report
        report["plan_total_gpus"] = plan.total_gpus
        report["plan_annual_cost"] = plan.annual_cost
        report["plan_boundaries"] = list(plan.boundaries)
        # --- hardware-applicable part (ServingConfig.autoscale): act
        # on context/GPU-count deltas beyond the hysteresis threshold
        # by LIVE-REBUILDING the pool (reconfigure.reprovision —
        # zero-drop, bitwise resume), turning what used to be a dropped
        # recommendation into an action. Runs before the boundary
        # clamp so a grown context admits its new boundary this tick.
        report["autoscale_actions"] = self._autoscale(plan, sc)
        engines = list(self.runtime.engines.values())
        # --- software-applicable part: clamp each boundary to its
        # pool's provisioned context (pool i's KV cache holds at most
        # c_max tokens — routing past that breaks the no-OOM guarantee)
        recs = []
        new_b, new_g = [], list(plan.gammas)
        floor = 0
        for i, b_plan in enumerate(plan.boundaries):
            b = max(1, int(round(b_plan / sc)))   # back to runtime units
            cap = engines[i].c_max
            if b > cap:
                recs.append(f"pool{i} wants boundary {b} > provisioned "
                            f"context {cap}: re-provision pool{i} with "
                            f"c_max >= {b} to apply")
            clamped = min(int(b), cap)
            clamped = max(clamped, floor + 1)   # keep strictly increasing
            if clamped >= engines[-1].c_max:
                recs.append(f"boundary {i} collapsed into the top "
                            f"pool's context; keeping previous value")
                clamped = router.boundaries[i]
            new_b.append(clamped)
            floor = clamped
        # GPU-count sizing is provisioning, not routing: report it,
        # never touch the engines
        report["plan_pool_gpus"] = [pp.n_gpus for pp in plan.pools]
        report["recommendation"] = "; ".join(recs) or None
        self.recommendations.extend(recs)
        if tuple(new_b) != tuple(router.boundaries) \
                or tuple(new_g) != tuple(router.gammas):
            router.set_boundaries(new_b, new_g)
            report["applied"] = True
            self.applied += 1
            report["reason"] = "boundary vector moved"
        else:
            report["reason"] = "plan matches live boundaries"
        report["boundaries_after"] = list(router.boundaries)
        report["gammas"] = list(router.gammas)
        self.hist.decay(self.decay_factor)
        self.last_report = report
        return report

    # ------------------------------------------------------- autoscale
    def _autoscale(self, plan, sc: float) -> List[str]:
        """Apply the plan's re-provisioning deltas to the live fleet
        when ``ServingConfig.autoscale`` is on. Context: a plan
        boundary more than ``autoscale_hysteresis`` above a pool's
        provisioned c_max grows that pool. Slots: a plan GPU count
        drifting beyond the hysteresis band from the PROVISIONED
        baseline (from_plan's per-pool GPU counts) rescales the pool's
        local slot count proportionally. Each action is one
        ``runtime.reprovision`` call — in-flight requests migrate
        through the host-offload tier, nothing drops."""
        rt = self.runtime
        if not getattr(getattr(rt, "config", None), "autoscale", False) \
                or not hasattr(rt, "reprovision"):
            return []
        hyst = 1.0 + self.autoscale_hysteresis
        names = list(rt.engines)
        actions: List[str] = []
        for i, b_plan in enumerate(plan.boundaries):
            b = max(1, int(round(b_plan / sc)))
            cap = rt.engines[names[i]].c_max
            if b > cap * hyst:
                rt.reprovision(names[i], c_max=b)
                actions.append(f"grow {names[i]} c_max {cap} -> {b}")
        plan_gpus = [pp.n_gpus for pp in plan.pools]
        base = rt.plan_pool_gpus
        if base is None:
            # no provisioning baseline recorded: adopt this plan's and
            # only act on later drift
            rt.plan_pool_gpus = list(plan_gpus)
        else:
            for i, name in enumerate(names[:len(plan_gpus)]):
                if i >= len(base) or base[i] <= 0:
                    continue
                ratio = plan_gpus[i] / base[i]
                if 1.0 / hyst <= ratio <= hyst:
                    continue
                eng = rt.engines[name]
                new_n = max(1, int(round(eng.n_max * ratio)))
                if new_n != eng.n_max:
                    rt.reprovision(name, n_max=new_n)
                    actions.append(f"rescale {name} n_max {eng.n_max} "
                                   f"-> {new_n} (plan wants "
                                   f"{plan_gpus[i]} vs provisioned "
                                   f"{base[i]} GPUs)")
                base[i] = plan_gpus[i]
        if actions:
            rt.reprovision_stats["autoscale_actions"] += len(actions)
        return actions
