"""Core: joint partitioning & placement at runtime (paper §III-A).

  graph        — the computational graph the orchestrator operates on
  cost_model   — Φ = α·L + β·U + γ·P  over system state C(t)
  placement    — placement solvers (chain DP / local search / repair) and
                 the numpy oracle of the fleet's red/black fixed point
  splitter     — Split Revision: joint split+placement DP (numpy + torch),
                 single-session and batched over a session axis
  triggers     — Θ thresholds + ShouldReconfigure (Table I)
  profiling    — Monitoring & Capacity Profiling (CP), measured segment
                 profiles and the calibrated cost model
  orchestrator — Adaptive Orchestrator (AO), Alg. 1
  forecast     — short-horizon capacity forecaster (device rings)
  fleet_eval   — batched fleet pricing / migration / repair, resident fleet
                 state and the fused monitoring-step programs
  fleet        — multi-session Fleet Orchestrator (admit / depart / step),
                 its crash journal (state_dict / save / load) and the
                 region-sharded orchestrator over one per MEC region
  admission    — latency-priced admission control (accept / defer / reject,
                 preemption under overload)
  broadcast    — Reconfiguration Broadcast (RB), 2-phase versioned rollout
  privacy      — trusted sets, Eq. (5)/(9)
"""

from .admission import (
    AdmissionKind,
    AdmissionRequest,
    AdmissionVerdict,
    FleetAdmissionController,
    ShardedFleetAdmissionController,
)
from .broadcast import (
    FlakyAgent,
    InProcessAgent,
    PartitionConfig,
    ReconfigurationBroadcast,
    RolloutPolicy,
)
from .cost_model import (
    AnalyticCostModel,
    CostBreakdown,
    CostModel,
    CostWeights,
    SystemState,
    Workload,
    chain_latency,
    evaluate,
    link_loads,
    memory_violations,
    memory_violations_packed,
    phi,
    region_slice,
)
from .fleet import (
    AdmissionRolloutError,
    FleetDecision,
    FleetOrchestrator,
    FleetSession,
    JOURNAL_SCHEMA,
    ShardedFleetOrchestrator,
    TelemetryGuard,
    session_induced_loads,
)
from .fleet_eval import (
    BatchedMigrationSolver,
    BatchedRepairPass,
    FixedPointResult,
    FleetCostEvaluator,
    FleetStateBuffers,
    PackedSessions,
    ResidentFleetKernel,
    ResidentPrice,
    ShardScreen,
    ShardedFleetState,
    pack_sessions,
    packed_induced_loads,
)
from .forecast import (
    CapacityForecaster,
    ForecastConfig,
    seasonal_forecast,
    seasonal_update,
    worst_case_capacity,
)
from .graph import GraphNode, ModelGraph, SplitScheme, make_transformer_graph
from .orchestrator import AdaptiveOrchestrator, Decision, DecisionKind
from .placement import (
    Solution,
    fixed_point_reference,
    local_search,
    repair_capacity,
    restrict_state,
    select_candidate_nodes,
    solve_placement_chain_dp,
    surrogate_cost,
)
from .privacy import TrustPolicy, assert_privacy_ok
from .profiling import (
    CalibratedCostModel,
    CapacityProfiler,
    ModelProfile,
    NodeSample,
    SegmentProfile,
    SegmentProfileEntry,
)
from .splitter import (
    BatchedJointSplitter,
    PackedProblem,
    SessionProblem,
    SplitRevision,
    TorchJointSplitter,
    brute_force_joint,
    coalesce_same_node,
    pack_problem,
    solve_joint_dp,
)
from .triggers import (
    EWMA,
    QOS_BATCH,
    QOS_CLASSES,
    QOS_INTERACTIVE,
    QOS_STANDARD,
    QoSClass,
    SolveThrottle,
    Thresholds,
    TriggerState,
    breach_seconds,
    decision_gate,
    forecast_reconfigure,
    hysteresis_keep,
    should_reconfigure,
)

__all__ = [
    "AdaptiveOrchestrator", "AdmissionKind", "AdmissionRequest",
    "AdmissionRolloutError", "AdmissionVerdict", "AnalyticCostModel",
    "assert_privacy_ok", "BatchedJointSplitter", "BatchedMigrationSolver",
    "BatchedRepairPass", "breach_seconds", "brute_force_joint",
    "CalibratedCostModel", "CapacityForecaster", "CapacityProfiler",
    "chain_latency", "coalesce_same_node", "CostBreakdown", "CostModel",
    "CostWeights", "Decision", "decision_gate", "DecisionKind", "evaluate",
    "EWMA", "fixed_point_reference", "FixedPointResult", "FlakyAgent",
    "FleetAdmissionController", "FleetCostEvaluator", "FleetDecision",
    "FleetOrchestrator", "FleetSession", "FleetStateBuffers",
    "forecast_reconfigure", "ForecastConfig", "GraphNode", "hysteresis_keep",
    "InProcessAgent", "JOURNAL_SCHEMA", "link_loads", "local_search",
    "make_transformer_graph", "memory_violations", "memory_violations_packed", "ModelGraph",
    "ModelProfile", "NodeSample", "pack_problem", "pack_sessions",
    "packed_induced_loads", "PackedProblem", "PackedSessions",
    "PartitionConfig", "phi", "QOS_BATCH", "QOS_CLASSES", "QOS_INTERACTIVE",
    "QOS_STANDARD", "QoSClass", "ReconfigurationBroadcast", "repair_capacity",
    "ResidentFleetKernel", "ResidentPrice", "restrict_state", "RolloutPolicy",
    "seasonal_forecast", "seasonal_update", "SegmentProfile",
    "SegmentProfileEntry", "select_candidate_nodes", "session_induced_loads",
    "ShardScreen", "ShardedFleetAdmissionController",
    "ShardedFleetOrchestrator", "ShardedFleetState", "region_slice",
    "SessionProblem", "should_reconfigure", "Solution", "solve_joint_dp",
    "solve_placement_chain_dp", "SolveThrottle", "SplitRevision",
    "SplitScheme", "surrogate_cost", "SystemState", "TelemetryGuard",
    "Thresholds", "TorchJointSplitter", "TriggerState", "TrustPolicy",
    "Workload", "worst_case_capacity",
]
