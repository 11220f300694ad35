"""Distributed-systems support of the port: node liveness for the fleet."""

from .fault_tolerance import HeartbeatRegistry

__all__ = ["HeartbeatRegistry"]
