"""Trigger thresholds Θ, QoS classes, and ShouldReconfigure (paper Table I)."""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field

__all__ = ["Thresholds", "TriggerState", "should_reconfigure", "EWMA",
           "SolveThrottle", "QoSClass", "QOS_INTERACTIVE", "QOS_STANDARD",
           "QOS_BATCH", "QOS_CLASSES", "decision_gate", "hysteresis_keep",
           "forecast_reconfigure", "breach_seconds"]


@dataclass(frozen=True)
class Thresholds:
    """Θ = {L_max, U_max, B_min, T_cool} — paper Table I empirical defaults."""

    latency_max_s: float = 0.150        # EWMA end-to-end latency bound
    util_max: float = 0.85              # max node utilization
    bandwidth_min_bps: float = 50e6 / 8  # 50 Mbps in bytes/s
    cooldown_s: float = 30.0            # reconfiguration rate limit
    ewma_alpha: float = 0.3             # smoothing for the latency EWMA

    def for_slo(self, latency_slo_s: float | None) -> "Thresholds":
        """Per-session Θ: the latency trigger tracks the session's QoS SLO.

        The util/bandwidth triggers stay fleet-level (they describe the
        infrastructure, not the tenant); only L_max is tenant-scoped.
        """
        if latency_slo_s is None or latency_slo_s == self.latency_max_s:
            return self
        return dataclasses.replace(self, latency_max_s=latency_slo_s)


@dataclass(frozen=True)
class QoSClass:
    """A tenant service class: latency SLO + admission-queue patience.

    Admission control prices an arriving session's best feasible latency
    against ``latency_slo_s`` (cf. arXiv:2504.03668 — admit only what the
    residual capacity can serve inside the class SLO); a session that cannot
    be admitted now may wait in the defer queue for up to
    ``defer_timeout_s`` before it is rejected outright.
    """

    name: str = "standard"
    latency_slo_s: float = 1.0
    defer_timeout_s: float = 10.0


QOS_INTERACTIVE = QoSClass("interactive", latency_slo_s=0.25, defer_timeout_s=2.0)
QOS_STANDARD = QoSClass("standard", latency_slo_s=1.0, defer_timeout_s=10.0)
QOS_BATCH = QoSClass("batch", latency_slo_s=4.0, defer_timeout_s=30.0)
QOS_CLASSES = {q.name: q for q in (QOS_INTERACTIVE, QOS_STANDARD, QOS_BATCH)}


class EWMA:
    """Exponentially weighted moving average, paper's latency smoother."""

    def __init__(self, alpha: float = 0.3, init: float | None = None):
        self.alpha = alpha
        self.value: float | None = init

    def update(self, x: float) -> float:
        # a non-finite sample would stick in the recursion forever (NaN in,
        # NaN out for every future update) — skip it, hold the last value
        if not math.isfinite(x):
            return self.get(x)
        self.value = x if self.value is None else (
            self.alpha * x + (1.0 - self.alpha) * self.value
        )
        return self.value

    def get(self, default: float = 0.0) -> float:
        return default if self.value is None else self.value


@dataclass
class SolveThrottle:
    """Solver duty-cycle limiter shared by the single- and multi-session AOs.

    The paper's T_cool rate-limits COMMITS, but level-based triggers keep
    firing every monitoring cycle while the environment stays degraded, and
    re-solving (DP + Φ local search) just for hysteresis to reject the
    result again busts the ≤10 ms cycle budget.  After a solve, skip
    re-solving for ``backoff_s`` while the trigger context is unchanged:
    same fired-trigger kinds and EWMA latency not worse than ``tol_frac``.
    """

    backoff_s: float = 5.0
    tol_frac: float = 0.10
    t_last: float = float("-inf")
    kinds: tuple[str, ...] = ()
    ewma: float = float("inf")

    def should_skip(self, env: "TriggerState", now: float) -> bool:
        """True → reuse the previous (rejected) answer; False → solve now
        (and remember this context as the new debounce reference)."""
        if (now - self.t_last < self.backoff_s
                and env.kinds == self.kinds
                and env.ewma_latency_s <= self.ewma * (1.0 + self.tol_frac)):
            return True
        self.t_last = now
        self.kinds = env.kinds
        self.ewma = env.ewma_latency_s
        return False


@dataclass
class TriggerState:
    """E(t) summary the orchestrator inspects each monitoring cycle."""

    ewma_latency_s: float
    max_node_util: float
    min_link_bw_bps: float
    reasons: list[str] = field(default_factory=list)
    # stable identifiers of the fired triggers ("latency"/"util"/"bw") —
    # unlike ``reasons``, these carry no live values, so orchestrators can
    # compare trigger CONTEXT across cycles (solver duty-cycle limiting)
    kinds: tuple[str, ...] = ()


def decision_gate(
    env: TriggerState,
    th: Thresholds,
    *,
    now: float,
    t_last_reconfig: float,
    throttle: SolveThrottle | None = None,
    prefired: bool = False,
) -> str:
    """The trigger → cool-down → duty-cycle gate every orchestrator runs.

    One copy of the decision skeleton shared by the single-session
    :class:`~repro_torch.core.orchestrator.AdaptiveOrchestrator`, the fleet
    monitoring cycle (:meth:`~repro_torch.core.fleet.FleetOrchestrator.step`),
    and the fleet's PROACTIVE (forecast) path, so the three can never
    drift.  Returns one of:

    * ``"keep"``      — no trigger fired; stay on the current config.
    * ``"cooldown"``  — a trigger fired inside the T_cool window.
    * ``"throttled"`` — same degraded context as the last (rejected) solve;
      reuse that answer instead of re-solving (see :class:`SolveThrottle`).
    * ``"solve"``     — run the migrate/re-split machinery.

    Ordering matters: ``should_reconfigure`` populates ``env.reasons``/
    ``env.kinds``, and the throttle only records a context once the
    cool-down has passed (matching the pre-existing call sites).
    ``prefired=True`` skips the ``should_reconfigure`` evaluation — the
    caller already ran it (e.g. :func:`forecast_reconfigure`, which also
    namespaces the kinds) and only needs the cool-down/throttle tail.
    """
    if not prefired and not should_reconfigure(env, th):
        return "keep"
    if now - t_last_reconfig < th.cooldown_s:
        return "cooldown"
    if throttle is not None and throttle.should_skip(env, now):
        return "throttled"
    return "solve"


def hysteresis_keep(
    current: tuple[tuple[int, ...], tuple[int, ...]],
    candidate: tuple[tuple[int, ...], tuple[int, ...]],
    candidate_lat: float,
    current_lat: float,
    min_improvement_frac: float,
) -> bool:
    """Anti-thrash hysteresis shared by the single- and multi-session AOs.

    ``current``/``candidate`` are (boundaries, assignment) pairs.  True →
    KEEP: the candidate is identical to the incumbent, or its predicted
    latency does not beat the incumbent's by at least
    ``min_improvement_frac`` (a reconfiguration costs a broadcast + weight
    staging — only worth it if the predicted gain is material).
    """
    if candidate == current:
        return True
    return candidate_lat > current_lat * (1.0 - min_improvement_frac)


def forecast_reconfigure(env: TriggerState, th: Thresholds) -> bool:
    """ShouldReconfigure on a PREDICTED environment (proactive trigger).

    Same Θ comparison as :func:`should_reconfigure`, applied to a
    forecast-priced :class:`TriggerState` (the session's latency / fleet
    util / link bandwidth under the worst-case capacity within the forecast
    horizon).  On firing, the trigger kinds and reasons are namespaced
    ``forecast-``/``forecast:`` so (a) operators can tell a preemptive
    reconfiguration from a reactive one and (b) :class:`SolveThrottle`
    treats predicted and observed degradation as DISTINCT contexts — a
    rejected proactive solve must not debounce the reactive solve that
    fires when the degradation actually lands, and vice versa.
    """
    if not should_reconfigure(env, th):
        return False
    env.kinds = tuple(f"forecast-{k}" for k in env.kinds)
    env.reasons[:] = [f"forecast: {r}" for r in env.reasons]
    return True


def should_reconfigure(env: TriggerState, th: Thresholds) -> bool:
    """Paper §III-C: reconfigure if ANY trigger fires within the window."""
    env.reasons.clear()
    kinds = []
    if env.ewma_latency_s > th.latency_max_s:
        kinds.append("latency")
        env.reasons.append(
            f"latency {env.ewma_latency_s*1e3:.0f}ms > {th.latency_max_s*1e3:.0f}ms"
        )
    if env.max_node_util > th.util_max:
        kinds.append("util")
        env.reasons.append(f"util {env.max_node_util:.2f} > {th.util_max:.2f}")
    if env.min_link_bw_bps < th.bandwidth_min_bps:
        kinds.append("bw")
        env.reasons.append(
            f"bw {env.min_link_bw_bps*8/1e6:.0f}Mbps < {th.bandwidth_min_bps*8/1e6:.0f}Mbps"
        )
    env.kinds = tuple(kinds)
    return bool(env.reasons)


def breach_seconds(latency_s: float, slo_s: float) -> float:
    """Predicted per-token SLO breach magnitude, in seconds (Eq. 3 slack).

    ``max(0, latency − SLO)``: the fleet-global tie-break the fixed-point
    reconfiguration minimises (total predicted breach-seconds across the
    triggered set), and the unit the ``--thrash`` A/B integrates into
    breach-minutes.  Zero for any row meeting its SLO, so summing over a
    fleet never rewards over-delivering on already-feasible sessions.
    """
    return max(0.0, float(latency_s) - float(slo_s))
