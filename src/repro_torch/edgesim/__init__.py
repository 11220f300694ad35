"""5G-MEC edge environment: the §IV scenario's system state."""

from .scenario import MBPS, MECScenarioParams, base_system_state

__all__ = ["MBPS", "MECScenarioParams", "base_system_state"]
