"""Core: joint partitioning & placement at runtime (paper §III-A).

  graph        — the computational graph the orchestrator operates on
  cost_model   — Φ = α·L + β·U + γ·P  over system state C(t)
  placement    — placement solvers (chain DP / local search / repair)
  splitter     — Split Revision: joint split+placement DP (numpy + torch)
  triggers     — Θ thresholds + ShouldReconfigure (Table I)
  profiling    — Monitoring & Capacity Profiling (CP), measured segment
                 profiles and the calibrated cost model
  orchestrator — Adaptive Orchestrator (AO), Alg. 1
  broadcast    — Reconfiguration Broadcast (RB), 2-phase versioned rollout
  privacy      — trusted sets, Eq. (5)/(9)
"""

from .broadcast import (
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
    memory_violations,
    phi,
)
from .graph import GraphNode, ModelGraph, SplitScheme, make_transformer_graph
from .orchestrator import AdaptiveOrchestrator, Decision, DecisionKind
from .placement import (
    Solution,
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
    SplitRevision,
    TorchJointSplitter,
    coalesce_same_node,
    solve_joint_dp,
)
from .triggers import (
    EWMA,
    SolveThrottle,
    Thresholds,
    TriggerState,
    decision_gate,
    hysteresis_keep,
    should_reconfigure,
)

__all__ = [
    "AdaptiveOrchestrator", "AnalyticCostModel", "CalibratedCostModel",
    "CapacityProfiler",
    "CostBreakdown", "CostModel", "CostWeights", "Decision", "DecisionKind",
    "EWMA", "GraphNode", "InProcessAgent", "ModelGraph", "ModelProfile",
    "NodeSample",
    "PartitionConfig", "ReconfigurationBroadcast", "RolloutPolicy",
    "SegmentProfile", "SegmentProfileEntry", "Solution", "SolveThrottle", "SplitRevision", "SplitScheme",
    "SystemState", "Thresholds", "TorchJointSplitter", "TriggerState",
    "TrustPolicy", "Workload", "assert_privacy_ok", "chain_latency",
    "coalesce_same_node", "decision_gate", "evaluate", "hysteresis_keep",
    "local_search", "make_transformer_graph", "memory_violations", "phi",
    "repair_capacity", "restrict_state", "select_candidate_nodes",
    "should_reconfigure", "solve_joint_dp", "solve_placement_chain_dp",
    "surrogate_cost",
]
