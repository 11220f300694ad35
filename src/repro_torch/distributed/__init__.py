"""Distributed-systems support of the port: node liveness for the fleet,
straggler detection for training."""

from .fault_tolerance import HeartbeatRegistry, StragglerDetector

__all__ = ["HeartbeatRegistry", "StragglerDetector"]
