"""Activation-sharding context, the reference's ``distributed/context.py``.

With weights sharded FSDP × TP, activations must be pinned to batch over dp
× heads / ff over TP at layer boundaries, or a partitioner can leave them
sharded on contracted dims.  :func:`constrain` does that for a DTensor when
a mesh is set (by :func:`activation_mesh`); with no mesh, or for a plain
tensor, it returns its input.  The spec of each kind is
:func:`activation_spec`'s.

The port's models do not call :func:`constrain` yet: it waits for
tensor-parallel execution, where activations are DTensors on the "model"
axis.  Until then every activation is a plain tensor and the call would do
nothing.
"""

from __future__ import annotations

import math
import os
from contextlib import contextmanager
from typing import Any

import torch

from .sharding import dp_axes, mesh_shape, placements

__all__ = ["activation_mesh", "activation_spec", "constrain", "current_mesh"]

_STATE: dict[str, Any] = {"mesh": None}


@contextmanager
def activation_mesh(mesh: Any):
    """Set the mesh (a ``DeviceMesh`` or a mesh shape) :func:`constrain`
    pins activations to, for the body of the ``with``."""
    prev = _STATE["mesh"]
    _STATE["mesh"] = mesh
    try:
        yield
    finally:
        _STATE["mesh"] = prev


def current_mesh() -> Any:
    return _STATE["mesh"]


def activation_spec(shape: tuple[int, ...], kind: str, mesh: Any) -> tuple:
    """The spec an activation of ``shape`` is pinned to.  kinds:
      hidden  [B, S, d]        -> (dp, S over TP [seq-parallel], None)
      hidden_full [B, S, d]    -> (dp, None, None)   (recurrent families)
      heads   [B, S, H, hd]    -> (dp, None, TP?, None)
      heads1  [B, H, hd]       -> (dp, TP?, None)          (decode)
      ff      [B, S, ff]       -> (dp, None, TP?)
    TP lands on the axis only when its size divides the model axis; dp on
    the batch only when the batch divides the dp axes.
    """
    sizes = mesh_shape(mesh)
    dp = dp_axes(sizes)
    dp_total = math.prod(sizes[a] for a in dp) if dp else 1
    tp = int(sizes.get("model", 1))
    ndim = len(shape)
    b_ax = dp if (dp and shape[0] % dp_total == 0) else None

    if kind == "hidden":
        # sequence parallelism: between TP regions the [B,S,d] hidden shards
        # S over "model"; falls back for decode (S=1) / ragged S
        s_ax = "model" if (ndim == 3 and shape[1] % tp == 0
                           and shape[1] > 1) else None
        return (b_ax, s_ax) + (None,) * (ndim - 2)
    if kind == "hidden_full":
        # recurrent families: temporal mixers consume full-S activations,
        # so S stays replicated
        return (b_ax,) + (None,) * (ndim - 1)
    if kind == "heads":
        return (b_ax, None, "model" if shape[2] % tp == 0 else None, None)
    if kind == "heads1":
        return (b_ax, "model" if shape[1] % tp == 0 else None, None)
    if kind == "ff":
        return (b_ax,) + (None,) * (ndim - 2) + (
            "model" if shape[-1] % tp == 0 else None,)
    raise ValueError(kind)


def constrain(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Pin an activation's sharding: a DTensor is redistributed to
    :func:`activation_spec`'s placements on its own mesh; a plain tensor,
    or any tensor with no mesh set or with ``REPRO_NO_CONSTRAIN`` set (the
    paper-faithful baseline), comes back unchanged."""
    from torch.distributed.tensor import DTensor

    mesh = _STATE["mesh"]
    if mesh is None or os.environ.get("REPRO_NO_CONSTRAIN") \
            or not isinstance(x, DTensor):
        return x
    spec = activation_spec(tuple(x.shape), kind, mesh)
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))
