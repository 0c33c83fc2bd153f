"""Prometheus text-format metrics for the serving gateway
(DESIGN.md §Serving API).

Hand-rolled exposition-format writer (text/plain; version=0.0.4) over
the counters the engines, router and re-planner already track — no
prometheus_client dependency, so the CI smoke host (jax + numpy +
pytest only) scrapes the same bytes a production Prometheus would.

Layout: every engine counter is exported per pool under a
``pool="short"`` label; router and re-planner state is fleet-global;
the live routing boundaries are gauges (``fleetopt_boundary_tokens``)
so a closed-loop re-plan is VISIBLE in the scrape — the acceptance
criterion for the re-planner is literally a before/after diff of this
endpoint.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Tuple

_ESCAPES = str.maketrans({"\\": r"\\", "\n": r"\n", '"': r'\"'})


@dataclasses.dataclass
class Metric:
    """One metric family: name, type, help text and its samples
    (label dict -> value)."""
    name: str
    mtype: str                     # "counter" | "gauge"
    help: str
    samples: List[Tuple[Dict[str, str], float]] \
        = dataclasses.field(default_factory=list)

    def add(self, value: float, **labels: str) -> "Metric":
        self.samples.append((labels, float(value)))
        return self


def render_prometheus(metrics: List[Metric]) -> str:
    """Serialize metric families to the Prometheus text exposition
    format. Non-finite values are dropped (a scrape must never carry
    NaN from a not-yet-warmed rate estimate)."""
    out: List[str] = []
    for m in metrics:
        samples = [(lab, v) for lab, v in m.samples if math.isfinite(v)]
        if not samples:
            continue
        out.append(f"# HELP {m.name} {m.help.translate(_ESCAPES)}")
        out.append(f"# TYPE {m.name} {m.mtype}")
        for labels, value in samples:
            if labels:
                inner = ",".join(
                    f'{k}="{str(v).translate(_ESCAPES)}"'
                    for k, v in sorted(labels.items()))
                out.append(f"{m.name}{{{inner}}} {value:g}")
            else:
                out.append(f"{m.name} {value:g}")
    return "\n".join(out) + "\n"


def fleet_metrics(runtime) -> List[Metric]:
    """Metric families for a :class:`~repro.serving.pools.FleetRuntime`:
    per-pool engine counters + fleet-global router state."""
    per_pool = {
        "dispatches": Metric(
            "fleetopt_dispatches_total", "counter",
            "Jitted engine dispatches (any kind)"),
        "decode_dispatches": Metric(
            "fleetopt_decode_dispatches_total", "counter",
            "Decode-only scan/step dispatches"),
        "decode_tokens": Metric(
            "fleetopt_decode_tokens_total", "counter",
            "Tokens emitted (any dispatch kind)"),
        "dpt": Metric(
            "fleetopt_dispatches_per_token", "gauge",
            "Decode-only dispatches per token they emitted "
            "(1/decode_k in steady state)"),
        "occupancy": Metric(
            "fleetopt_utilization", "gauge",
            "Mean per-iteration slot occupancy since engine start"),
        "queue_depth": Metric(
            "fleetopt_queue_depth", "gauge",
            "Requests waiting for a slot"),
        "queue_wait": Metric(
            "fleetopt_queue_wait_est_iters", "gauge",
            "Rolling queue-wait estimate (iterations) used by "
            "stability-aware admission"),
        "slots": Metric(
            "fleetopt_slots", "gauge", "Provisioned engine slots"),
        "iterations": Metric(
            "fleetopt_iterations_total", "counter",
            "Lockstep engine iterations"),
        "host_tier": Metric(
            "fleetopt_host_tier_blocks", "gauge",
            "KV blocks parked in the host swap tier"),
        "kv_tokens": Metric(
            "fleetopt_kv_tokens_held", "gauge",
            "Tokens of KV memory currently pinned"),
        "spec_kappa": Metric(
            "fleetopt_spec_kappa", "gauge",
            "Mean tokens emitted per verify iteration "
            "(speculative decoding; 1.0 = off/nothing accepted)"),
        "prefix_hit_rate": Metric(
            "fleetopt_prefix_hit_rate", "gauge",
            "Prefix-cache hit blocks / (hit + allocated) blocks"),
        "prefix_hit_blocks": Metric(
            "fleetopt_prefix_hit_blocks_total", "counter",
            "Prompt blocks served from the prefix cache"),
    }
    overload = {
        key: Metric(f"fleetopt_{key}_total", "counter", help_)
        for key, help_ in (
            ("shed", "Arrivals refused by stability-aware admission"),
            ("preempted", "Slot preemptions (LIFO victim policy)"),
            ("swapped_out", "Preemptions via host-offload swap"),
            ("recomputed", "Preemptions via discard-and-replay"),
            ("hol_bypass", "Out-of-order admissions past a deferring "
                           "FIFO head"),
            ("reservation_breach", "Requests that outran their "
                                   "tightened l_out reservation"),
        )}
    for name, eng in runtime.engines.items():
        snap = eng.utilization_snapshot(detail=True)
        per_pool["dispatches"].add(eng.dispatches, pool=name)
        per_pool["decode_dispatches"].add(eng.decode_dispatches,
                                          pool=name)
        per_pool["decode_tokens"].add(eng.decode_tokens_emitted,
                                      pool=name)
        per_pool["dpt"].add(eng.dispatches_per_token(), pool=name)
        per_pool["occupancy"].add(snap["occupancy"], pool=name)
        per_pool["queue_depth"].add(snap["queue_depth"], pool=name)
        per_pool["queue_wait"].add(snap["queue_wait_est_iters"],
                                   pool=name)
        per_pool["slots"].add(eng.n_max, pool=name)
        per_pool["iterations"].add(eng.iteration, pool=name)
        per_pool["host_tier"].add(snap["host_tier_blocks"], pool=name)
        per_pool["kv_tokens"].add(eng.kv_tokens_held(), pool=name)
        per_pool["spec_kappa"].add(eng.spec_kappa(), pool=name)
        for key, metric in overload.items():
            metric.add(snap[key], pool=name)
        if eng.paged and eng.prefix_cache:
            hit = eng.prefix_stats["hit_blocks"]
            alloc = eng.prefix_stats["allocated_blocks"]
            per_pool["prefix_hit_blocks"].add(hit, pool=name)
            per_pool["prefix_hit_rate"].add(
                hit / (hit + alloc) if hit + alloc else 0.0, pool=name)
    # -- live re-provisioning / fault recovery (§Live re-provisioning) -----
    reprov: List[Metric] = []
    rstats = getattr(runtime, "reprovision_stats", None)
    if rstats is not None:
        for key, help_ in (
                ("rebuilds", "Planned live engine rebuilds "
                             "(reprovision calls)"),
                ("engine_restarts", "Engines rebuilt after a crash "
                                    "(fault recovery)"),
                ("migrated_requests", "In-flight/queued requests "
                                      "migrated across engine rebuilds"),
                ("rerouted_requests", "Migrated requests re-routed to a "
                                      "different pool"),
                ("autoscale_actions", "Re-planner recommendations acted "
                                      "on by the autoscaler"),
        ):
            reprov.append(Metric(f"fleetopt_{key}_total", "counter",
                                 help_).add(rstats[key]))
        down = Metric("fleetopt_pool_down", "gauge",
                      "1 while the pool refuses submissions "
                      "(crash-recovery blackout window)")
        for name in runtime.engines:
            until = getattr(runtime, "pool_down_until", {}).get(name, 0.0)
            down.add(1.0 if until > time.monotonic() else 0.0, pool=name)
        reprov.append(down)
    st = runtime.router.stats
    router = [
        Metric("fleetopt_requests_routed_total", "counter",
               "Requests routed, by destination pool"),
        Metric("fleetopt_borderline_total", "counter",
               "Requests in a compression band (B, gamma*B]")
        .add(st.borderline),
        Metric("fleetopt_compressed_total", "counter",
               "Borderline requests successfully compressed one "
               "tier down").add(st.compressed_ok),
        Metric("fleetopt_affinity_pinned_total", "counter",
               "Repeat session turns pinned to their prefix pool")
        .add(st.affinity_pinned),
        Metric("fleetopt_boundary_tokens", "gauge",
               "LIVE routing boundary vector (moved by re-plans)"),
        Metric("fleetopt_gamma", "gauge",
               "LIVE per-boundary compression bandwidth gamma"),
    ]
    for pool, count in sorted(st.per_pool.items()):
        router[0].add(count, pool=pool)
    for i, b in enumerate(runtime.router.boundaries):
        router[4].add(b, index=str(i))
    for i, g in enumerate(runtime.router.gammas):
        router[5].add(g, index=str(i))
    return (list(per_pool.values()) + list(overload.values()) + reprov
            + router)
