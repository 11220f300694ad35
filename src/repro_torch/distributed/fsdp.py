"""Blocks of a state stored FSDP × TP, as ``param_pspecs`` shards it.

A rank of a mesh holds, of every leaf, the block that ``local_slices``
gives it under the leaf's spec (DTensor's order: a dim's axes split it in
mesh order, the first mesh dim major).  Tensor-parallel training runs the
model on the rank's blocks under ``strip_dp`` of that spec (its TP block),
so each step moves every leaf between the two:

* :meth:`LeafLayout.tp_block`: the FSDP block -> the TP block.  Each dim
  that dp axes shard is all-gathered over the ranks that split it (the
  group of its axes, in mesh order, so the pieces come in the dim's
  order); where "model" shards the same dim, the rank then keeps its
  "model" block of the gathered whole.
* :meth:`LeafLayout.reduce`: the TP block's gradient -> the FSDP block's,
  summed over the ranks: over "model" where the leaf is replicated there
  (each rank's gradient of such a leaf is its term of the sum; see
  ``distributed/context.py``), then reduce-scattered back over each dim's
  axes (a "model"-sharded dim's block zero-padded to the whole dim first),
  and all-reduced over the dp axes that shard no dim.

Axes of size 1 shard nothing.  :func:`full_tensor` and :func:`from_whole`
move a DTensor leaf between its block and the whole (checkpoints).  Every
function that talks is a collective of the mesh's ranks: all of them call
it, in the same order.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.distributed as dist

from .sharding import TP, dp_axes, local_slices, mesh_shape, placements

__all__ = ["LeafLayout", "axis_group", "from_whole", "full_tensor", "layouts",
           "spec_leaves", "spec_of"]

_GROUPS: dict = {}


def axis_group(mesh, axes: tuple[str, ...]):
    """The process group of the ranks that share this rank's coordinates on
    every mesh axis but ``axes``, ordered by their index over ``axes`` in
    mesh order.  Made once a mesh layout and axis set, with every other such
    group (``new_group`` is collective)."""
    names = tuple(mesh.mesh_dim_names)
    axes = tuple(a for a in names if a in axes)
    # the groups depend on the ranks' layout only: a mesh of the same layout
    # (another DeviceMesh object) shares them
    key = (names, tuple(mesh.mesh.shape), tuple(mesh.mesh.flatten().tolist()), axes)
    if key not in _GROUPS:
        if len(axes) == 1:
            _GROUPS[key] = mesh.get_group(axes[0])
        else:
            idx = [names.index(a) for a in axes]
            rest = [i for i in range(len(names)) if i not in idx]
            rows = mesh.mesh.permute(*rest, *idx).reshape(
                -1, math.prod(mesh.mesh.shape[i] for i in idx)).tolist()
            me = dist.get_rank()
            for row in rows:
                g = dist.new_group(row)
                if me in row:
                    _GROUPS[key] = g
    return _GROUPS[key]


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _live(entry, sizes) -> tuple[str, ...]:
    """The axes of a spec entry that split it (size above 1), in mesh order."""
    return tuple(a for a in sizes if a in _axes(entry) and sizes[a] > 1)


def _gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0], *src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


def _scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def spec_of(t) -> tuple:
    """A DTensor's spec: each dim's sharding axes, in mesh order."""
    names = t.device_mesh.mesh_dim_names
    dims: list[list[str]] = [[] for _ in range(t.ndim)]
    for name, p in zip(names, t.placements):
        if p.is_shard():
            dims[p.dim].append(name)
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a) for a in dims)


def full_tensor(t) -> torch.Tensor:
    """The whole tensor of a DTensor: each sharded dim all-gathered over
    its axes (the rank's own order, :func:`spec_of`)."""
    mesh, x = t.device_mesh, t.to_local()
    sizes = mesh_shape(mesh)
    for d, entry in enumerate(spec_of(t)):
        axes = _live(entry, sizes)
        if axes:
            x = _gather_dim(x, d, axis_group(mesh, axes))
    return x.contiguous()


def from_whole(x: torch.Tensor, spec: tuple, mesh):
    """The DTensor on ``mesh`` whose block on this rank is its block of the
    whole ``x`` under ``spec`` (a copy of its own)."""
    from torch.distributed.tensor import DTensor

    sizes = mesh_shape(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    block = x[local_slices(tuple(x.shape), spec, sizes, coord)].clone()
    return DTensor.from_local(block.contiguous(), mesh, placements(spec, mesh),
                              run_check=False)


class LeafLayout:
    """How one leaf of global ``shape`` stored under ``spec`` (FSDP × TP)
    moves between this rank's FSDP block and its TP block on ``mesh``."""

    def __init__(self, shape: tuple[int, ...], spec: tuple, mesh):
        self.mesh, self.spec, self.shape = mesh, spec, tuple(shape)
        sizes = mesh_shape(mesh)
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        self.tp = sizes.get(TP, 1)
        self.model_rank = int(coord.get(TP, 0))
        dp = tuple(a for a in dp_axes(sizes) if sizes[a] > 1)
        used = {a for e in spec for a in _live(e, sizes)}
        # (dim, its live axes, whether "model" is among them) of each dim
        # that dp axes shard
        self.gathers = [(d, _live(e, sizes), TP in _live(e, sizes))
                        for d, e in enumerate(spec)
                        if any(a in dp for a in _live(e, sizes))]
        self.model_replicated = self.tp > 1 and TP not in used
        self.rest_dp = tuple(a for a in dp if a not in used)
        row = spec[-1] if spec else None
        self.row_axes = _live(row, sizes)
        # the block counts once (the norm): coordinate 0 on every axis that
        # replicates it
        self.counted = all(int(coord[a]) == 0 for a in sizes
                           if sizes[a] > 1 and a not in used)

    def tp_block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's FSDP block ``x`` -> its TP block (``x`` itself where
        no dp axis shards the leaf)."""
        for d, axes, cut in self.gathers:
            x = _gather_dim(x, d, axis_group(self.mesh, axes))
            if cut:
                n = x.shape[d] // self.tp
                x = x.narrow(d, self.model_rank * n, n)
        return x.contiguous()

    def reduce(self, g: torch.Tensor) -> torch.Tensor:
        """The rank's gradient of its TP block -> the gradient of its FSDP
        block, summed over the ranks (module docstring)."""
        if self.model_replicated:
            dist.all_reduce(g, group=axis_group(self.mesh, (TP,)))
        for d, axes, cut in reversed(self.gathers):
            if cut:
                n = g.shape[d]
                whole = g.new_zeros(g.shape[:d] + (n * self.tp,) + g.shape[d + 1:])
                whole.narrow(d, self.model_rank * n, n).copy_(g)
                g = whole
            g = _scatter_dim(g, d, axis_group(self.mesh, axes))
        if self.rest_dp:
            dist.all_reduce(g, group=axis_group(self.mesh, self.rest_dp))
        return g

    def row_group(self):
        """The group whose ranks split each of the leaf's rows
        (``reshape(-1, last)`` of the global leaf), or None."""
        return axis_group(self.mesh, self.row_axes) if self.row_axes else None


def layouts(tree_shapes: Any, specs: Any, mesh) -> list:
    """:class:`LeafLayout` of every leaf, in ``tree_flatten``'s order."""
    from ..models.common import tree_flatten

    return [LeafLayout(tuple(t.shape), s, mesh) for t, s in
            zip(tree_flatten(tree_shapes)[0], spec_leaves(specs))]


def spec_leaves(specs: Any) -> list:
    """A spec tree's leaves (tuples) in ``tree_flatten``'s order."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [s for v in specs for s in spec_leaves(v)]
    return [specs]
