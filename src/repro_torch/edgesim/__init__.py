"""5G-MEC edge environment: the §IV scenario's system state and the fleet's
model catalog."""

from .scenario import (MBPS, MECScenarioParams, base_system_state,
                       fleet_model_catalog)

__all__ = ["MBPS", "MECScenarioParams", "base_system_state",
           "fleet_model_catalog"]
