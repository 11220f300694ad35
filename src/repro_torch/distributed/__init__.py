"""Distribution: the sharding policy, the activation-sharding context, node
liveness for the fleet, straggler detection for training, elastic re-mesh
planning."""

from .context import activation_mesh, activation_spec, constrain, current_mesh
from .fault_tolerance import HeartbeatRegistry, StragglerDetector, plan_elastic_mesh
from .sharding import (
    batch_axes,
    cache_pspecs,
    dp_axes,
    input_pspecs,
    mesh_shape,
    param_pspecs,
    placements,
    strip_dp,
    tree_placements,
)

__all__ = ["HeartbeatRegistry", "StragglerDetector", "activation_mesh",
           "activation_spec", "batch_axes", "cache_pspecs", "constrain",
           "current_mesh", "dp_axes", "input_pspecs", "mesh_shape",
           "param_pspecs", "placements", "plan_elastic_mesh", "strip_dp",
           "tree_placements"]
