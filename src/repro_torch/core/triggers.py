"""Trigger thresholds Θ and ShouldReconfigure (paper Table I)."""

from __future__ import annotations

import math
from dataclasses import dataclass, field

__all__ = ["Thresholds", "TriggerState", "should_reconfigure", "EWMA",
           "SolveThrottle", "decision_gate", "hysteresis_keep"]


@dataclass(frozen=True)
class Thresholds:
    """Θ = {L_max, U_max, B_min, T_cool} — paper Table I empirical defaults."""

    latency_max_s: float = 0.150        # EWMA end-to-end latency bound
    util_max: float = 0.85              # max node utilization
    bandwidth_min_bps: float = 50e6 / 8  # 50 Mbps in bytes/s
    cooldown_s: float = 30.0            # reconfiguration rate limit
    ewma_alpha: float = 0.3             # smoothing for the latency EWMA


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
    """Solver duty-cycle limiter of the orchestrator.

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
) -> str:
    """The trigger → cool-down → duty-cycle gate of a monitoring cycle.

    Returns one of:

    * ``"keep"``      — no trigger fired; stay on the current config.
    * ``"cooldown"``  — a trigger fired inside the T_cool window.
    * ``"throttled"`` — same degraded context as the last (rejected) solve;
      reuse that answer instead of re-solving (see :class:`SolveThrottle`).
    * ``"solve"``     — run the migrate/re-split machinery.

    Ordering matters: ``should_reconfigure`` populates ``env.reasons``/
    ``env.kinds``, and the throttle only records a context once the
    cool-down has passed.
    """
    if not should_reconfigure(env, th):
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
    """Anti-thrash hysteresis of the orchestrator.

    ``current``/``candidate`` are (boundaries, assignment) pairs.  True →
    KEEP: the candidate is identical to the incumbent, or its predicted
    latency does not beat the incumbent's by at least
    ``min_improvement_frac`` (a reconfiguration costs a broadcast + weight
    staging — only worth it if the predicted gain is material).
    """
    if candidate == current:
        return True
    return candidate_lat > current_lat * (1.0 - min_improvement_frac)


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
