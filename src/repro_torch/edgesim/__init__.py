"""5G-MEC edge environment: the §IV scenario's system state, its regional
replicas under the region-sharded control plane, the fleet's model catalog
and seeded time-series generators."""

from .scenario import (MBPS, MECScenarioParams, base_system_state,
                       build_regional_orchestrator, fleet_model_catalog,
                       regional_system_state)
from .traces import Trace, constant, diurnal, ou_process, square_wave

__all__ = ["MBPS", "MECScenarioParams", "Trace", "base_system_state",
           "build_regional_orchestrator", "constant", "diurnal",
           "fleet_model_catalog", "ou_process", "regional_system_state",
           "square_wave"]
