"""5G-MEC edge-environment simulator (paper §IV scenario + fleet mode)."""

from .chaos import ChaosInjector, ChaosSpec, InvariantChecker
from .failures import FailureInjector, FailureSpec
from .scenario import (
    MBPS,
    FleetScenarioParams,
    MECScenarioParams,
    base_system_state,
    build_fleet_scenario,
    build_mec_scenario,
    build_regional_orchestrator,
    fleet_model_catalog,
    llama3_8b_graph,
    mec_traces,
    regional_system_state,
    regional_traces,
    spike_onsets,
    static_baseline_split,
)
from .simulator import (
    EdgeSimulator,
    FleetSimConfig,
    FleetSimResult,
    FleetSimulator,
    FleetTickMetrics,
    SimConfig,
    SimResult,
    TickMetrics,
)
from .traces import Trace, constant, diurnal, ou_process, square_wave

__all__ = [
    "ChaosInjector", "ChaosSpec", "EdgeSimulator", "FailureInjector",
    "FailureSpec", "FleetScenarioParams",
    "FleetSimConfig", "FleetSimResult",
    "FleetSimulator", "FleetTickMetrics", "InvariantChecker",
    "MBPS", "MECScenarioParams", "SimConfig",
    "SimResult", "TickMetrics", "Trace", "base_system_state",
    "build_fleet_scenario", "build_mec_scenario",
    "build_regional_orchestrator", "constant", "diurnal",
    "fleet_model_catalog", "llama3_8b_graph", "mec_traces", "ou_process",
    "regional_system_state", "regional_traces",
    "spike_onsets", "square_wave", "static_baseline_split",
]
