"""Adaptive Orchestrator (AO) — paper Alg. 1 'Adaptive Split Orchestration'.

Decision hierarchy per §III-C: when any trigger fires (and the cool-down has
elapsed), the orchestrator FIRST attempts *placement migration* (reassigning
segments without moving boundaries, Eq. 7); only if the best migration still
violates the QoS targets does it invoke the *Split Revision* module for a full
re-split (Eq. 8).  Committed changes go through the Reconfiguration Broadcast.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum

from .broadcast import PartitionConfig, ReconfigurationBroadcast
from .cost_model import CostWeights, SystemState, Workload, phi
from .graph import ModelGraph
from .placement import Solution, local_search, solve_placement_chain_dp
from .profiling import CapacityProfiler
from .splitter import SplitRevision
from .triggers import SolveThrottle, Thresholds, decision_gate, hysteresis_keep

__all__ = ["DecisionKind", "Decision", "AdaptiveOrchestrator"]


class DecisionKind(Enum):
    KEEP = "keep"
    MIGRATE = "migrate"
    RESPLIT = "resplit"
    COOLDOWN = "cooldown"


@dataclass(frozen=True)
class Decision:
    kind: DecisionKind
    config: PartitionConfig | None
    reasons: tuple[str, ...]
    predicted_latency_s: float
    solver_time_s: float


@dataclass
class AdaptiveOrchestrator:
    graph: ModelGraph
    profiler: CapacityProfiler
    broadcast: ReconfigurationBroadcast
    workload: Workload
    thresholds: Thresholds = field(default_factory=Thresholds)
    weights: CostWeights = field(default_factory=CostWeights)
    splitter: SplitRevision = field(default_factory=SplitRevision)
    source_node: int = 0
    # anti-thrash hysteresis: only commit if predicted latency improves by
    # this fraction over the *current* config under the same C(t) (complements
    # the paper's T_cool rate limit)
    min_improvement_frac: float = 0.10
    # solver duty-cycle limit (see SolveThrottle): don't re-solve while the
    # degraded trigger context is unchanged since the last rejected solve
    throttle: SolveThrottle = field(default_factory=SolveThrottle)
    # Φ local-search budget for the migration attempt (the refinement is
    # python-loop evaluate(); unbounded rounds dominate the cycle cost)
    migration_rounds: int = 8

    current: PartitionConfig | None = None
    t_last_reconfig: float = float("-inf")
    decisions: list[Decision] = field(default_factory=list)

    # ------------------------------------------------------------------ #
    def deploy_initial(self, boundaries, assignment, now: float = 0.0) -> PartitionConfig:
        """Alg. 1 'Initialize': deploy the baseline split d_0.

        Also runs the re-split DP once for this (graph, fleet) shape: the
        device's first-use costs belong to deployment, not to the first
        triggered monitoring cycle, whose ``solver_time_s`` must reflect the
        warm-solve cost the paper budgets (≤10 ms).
        """
        cfg = self.broadcast.rollout(tuple(boundaries), tuple(assignment),
                                     reason="initial deployment", now=now)
        if cfg is None:
            raise RuntimeError("initial rollout failed")
        self.current = cfg
        self.splitter.warmup(self.graph, self.profiler.system_state(),
                             self.workload, source_node=self.source_node)
        return cfg

    # ------------------------------------------------------------------ #
    def _predicted_latency(self, sol: Solution, state: SystemState) -> float:
        return phi(self.graph, sol.boundaries, sol.assignment, state,
                   self.workload, self.weights).latency

    def step(self, now: float) -> Decision:
        """One monitoring cycle of Alg. 1."""
        assert self.current is not None, "call deploy_initial first"
        env = self.profiler.env_state()
        state = self.profiler.system_state()
        t0 = time.perf_counter()

        # trigger → cool-down → solver-duty-cycle gate (triggers.decision_gate)
        gate = decision_gate(env, self.thresholds, now=now,
                             t_last_reconfig=self.t_last_reconfig,
                             throttle=self.throttle)
        reasons = tuple(env.reasons)
        if gate == "cooldown":
            d = Decision(DecisionKind.COOLDOWN, self.current, reasons, 0.0,
                         time.perf_counter() - t0)
            self.decisions.append(d)
            return d
        if gate != "solve":  # "keep" (no trigger) or "throttled" (reuse answer)
            d = Decision(DecisionKind.KEEP, self.current,
                         reasons if gate == "throttled" else (),
                         self._predicted_latency(
                             Solution(self.current.boundaries,
                                      self.current.assignment, 0.0), state),
                         time.perf_counter() - t0)
            self.decisions.append(d)
            return d

        # --- attempt 1: placement migration under the current split (Eq. 7) ---
        mig = solve_placement_chain_dp(
            self.graph, self.current.boundaries, state, self.workload,
            source_node=self.source_node,
        )
        mig = local_search(self.graph, mig, state, self.workload,
                           max_rounds=self.migration_rounds,
                           allow_resplit=False)
        mig_lat = self._predicted_latency(mig, state)

        kind = DecisionKind.MIGRATE
        chosen = mig
        chosen_lat = mig_lat
        if mig_lat > self.thresholds.latency_max_s:
            # --- attempt 2: full re-split via SR (Eq. 8) ---
            rs = self.splitter.revise(self.graph, state, self.workload,
                                      source_node=self.source_node)
            rs_lat = self._predicted_latency(rs, state)
            if rs_lat < mig_lat:
                kind, chosen, chosen_lat = DecisionKind.RESPLIT, rs, rs_lat

        solver_time = time.perf_counter() - t0

        cur_sol = Solution(self.current.boundaries, self.current.assignment, 0.0)
        cur_lat = self._predicted_latency(cur_sol, state)
        if hysteresis_keep(
            (self.current.boundaries, self.current.assignment),
            (chosen.boundaries, chosen.assignment),
            chosen_lat, cur_lat, self.min_improvement_frac,
        ):
            d = Decision(DecisionKind.KEEP, self.current, reasons, chosen_lat,
                         solver_time)
            self.decisions.append(d)
            return d

        cfg = self.broadcast.rollout(chosen.boundaries, chosen.assignment,
                                     reason="; ".join(reasons), now=now)
        if cfg is None:  # rollout aborted (node failure mid-broadcast) — keep
            d = Decision(DecisionKind.KEEP, self.current, reasons, chosen_lat,
                         solver_time)
            self.decisions.append(d)
            return d
        self.current = cfg
        self.t_last_reconfig = now
        d = Decision(kind, cfg, reasons, chosen_lat, solver_time)
        self.decisions.append(d)
        return d
