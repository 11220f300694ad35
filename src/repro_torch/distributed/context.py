"""Activation-sharding context, the reference's ``distributed/context.py``.

With weights sharded FSDP × TP, activations must be pinned to batch over dp
× heads / ff over TP at layer boundaries, or a partitioner can leave them
sharded on contracted dims.  The models call :func:`constrain` at the
reference's points (the q/k/v projections as ``heads``, the FFN's inner
products as ``ff``, the attention and FFN outputs and the entry of
``forward_hidden`` as ``hidden``).  The spec of each kind is
:func:`activation_spec`'s.  What :func:`constrain` does depends on what is
set:

* a tensor-parallel region (:func:`tensor_parallel`, set by the serving
  functions and the tensor-parallel train step of
  ``training/train_step.py``): every tensor is this rank's
  local block and the port runs Megatron-style on it.  ``heads`` and ``ff``
  come out of products with the rank's weight blocks already in their
  layout (the policy shards a weight's heads or ff exactly where the spec
  shards the activation's), so the call checks the block's shape; ``hidden``
  moves a whole-sequence activation into its layout: a reduce-scatter over
  S of a partial sum (after ``wo``), an all-reduce where ``hidden`` falls
  back to replicated (decode, S = 1, ragged S), a slice of a whole one; a
  ``hidden`` block already in its layout, given its global S, is checked.
  :func:`gather_seq` is the all-gather over S before the q/k/v and FFN
  products.  The collectives run over the "model" axis's process group
  (NCCL on the card, gloo on the CPU), outside the kernels; under grad
  mode each is differentiable (its backward the adjoint collective, see
  the note above ``_gather0``);
* an activation mesh (:func:`activation_mesh`) and a DTensor: it is
  redistributed to the spec's placements on its own mesh;
* neither: the input comes back unchanged, as it does with
  ``REPRO_NO_CONSTRAIN`` set (the paper-faithful baseline).  The variable
  drops the annotations of a mesh only: in a region the collectives are
  part of the computation, and it does not apply there.
"""

from __future__ import annotations

import math
import os
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from .sharding import dp_axes, mesh_shape, placements, shard_shape

__all__ = ["TPRegion", "activation_mesh", "activation_spec", "all_gather_model",
           "all_reduce_model", "batch_group", "constrain", "current_mesh",
           "current_region", "gather_seq", "seq_sharded", "split_batch",
           "tensor_parallel", "to_hidden"]

_STATE: dict[str, Any] = {"mesh": None, "tp": None, "batch": None}


@dataclass(frozen=True)
class TPRegion:
    """This rank's place in a tensor-parallel region: the mesh's shape, its
    coordinate on "model", the process group of the ranks that share its dp
    coordinates (the "model" axis; None where the axis is 1), and how many
    dp blocks the batch is split into (1 where it is replicated)."""

    sizes: dict
    rank: int
    group: Any
    batch_split: int

    @property
    def tp(self) -> int:
        return int(self.sizes.get("model", 1))


@contextmanager
def tensor_parallel(region: TPRegion | None):
    """Run the body's model code on local blocks in ``region``."""
    prev = _STATE["tp"]
    _STATE["tp"] = region
    try:
        yield
    finally:
        _STATE["tp"] = prev


def current_region() -> TPRegion | None:
    """The tensor-parallel region set, or None (one device, or a model
    axis of 1)."""
    r = _STATE["tp"]
    return r if r is not None and r.tp > 1 else None


@contextmanager
def split_batch(group):
    """Run the body on this rank's rows of a batch that the ranks of
    ``group`` split in their group order (the mesh train step's dp rows),
    or on the whole batch where ``group`` is None.  What couples the rows,
    token-choice MoE routing's expert slots
    (``models/transformer.moe_route``), is then taken over the whole
    batch."""
    prev = _STATE["batch"]
    _STATE["batch"] = group
    try:
        yield
    finally:
        _STATE["batch"] = prev


def batch_group():
    """The process group :func:`split_batch` set, or None."""
    return _STATE["batch"]


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


# --------------------------------------------------------------------------- #
# collectives over the "model" axis, on local tensors
# --------------------------------------------------------------------------- #
# Under grad mode (tensor-parallel training) each collective is an autograd
# function whose backward is its adjoint, with every rank's copy of a
# replicated tensor its own variable: the ranks' cotangents of a replicated
# tensor are terms of its gradient, which sum over "model" to the whole.
# So an all-gather's backward reduce-scatters, a reduce-scatter's
# all-gathers, an all-reduce's all-reduces, and keeping one's block of a
# whole tensor (a slice) pads the block's gradient with zeros.  Work that
# every rank repeats then counts once in the sum, and the gradient of a
# leaf that "model" replicates is the sum of the ranks' (the train step's
# reduction); the loss, replicated over "model", is seeded 1 / tp a rank.
def _gather0(x: torch.Tensor, group) -> torch.Tensor:
    out = x.new_empty((dist.get_world_size(group) * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def _scatter0(x: torch.Tensor, group) -> torch.Tensor:
    out = x.new_empty((x.shape[0] // dist.get_world_size(group), *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    return out


def _reduced(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


class _AllGather0(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather0(x, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter0(g, ctx.group), None


class _ReduceScatter0(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _scatter0(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather0(g, ctx.group), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.group), None


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _all_gather0(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` [n, ...] stacked on dim 0 -> [tp * n, ...]."""
    return _AllGather0.apply(x, group) if _tracked(x) else _gather0(x, group)


def _reduce_scatter0(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ranks of ``x`` [tp * n, ...], this rank's block [n, ...]."""
    return _ReduceScatter0.apply(x, group) if _tracked(x) else _scatter0(x, group)


def all_gather_model(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` stacked on a new leading axis [tp, ...], in rank
    order on "model" (the identity with no region: [1, ...])."""
    r = current_region()
    if r is None:
        return x[None]
    return _all_gather0(x[None], r.group)


def all_reduce_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the "model" axis (in place, but under grad
    mode, where the sum is a new tensor)."""
    r = current_region()
    if r is None:
        return x
    if _tracked(x):
        return _AllReduce.apply(x, r.group)
    dist.all_reduce(x, group=r.group)
    return x


def seq_sharded(s: int) -> bool:
    """Whether ``hidden`` [B, s, d] shards its sequence over "model" in the
    current region: S divides the axis and S > 1 (the reference's rule)."""
    r = current_region()
    return r is not None and s > 1 and s % r.tp == 0


def gather_seq(x: torch.Tensor, s: int) -> torch.Tensor:
    """``hidden`` of global length ``s`` in its layout -> the whole
    sequence [B, s, d] (an all-gather over S where it is sharded)."""
    if not seq_sharded(s):
        return x
    return _all_gather0(x.transpose(0, 1), current_region().group).transpose(0, 1)


def to_hidden(x: torch.Tensor, partial: bool) -> torch.Tensor:
    """A whole-sequence [B, S, d] activation -> ``hidden``'s layout.

    ``partial``: x is this rank's term of a sum over "model" (the product
    with a weight block sharded on the contracted dim), reduce-scattered
    over S or all-reduced; else x is whole and the rank keeps its block.
    """
    r = current_region()
    if r is None:
        return x
    s = x.shape[1]
    if seq_sharded(s):
        if partial:
            return _reduce_scatter0(x.transpose(0, 1), r.group).transpose(0, 1)
        n = s // r.tp
        return x[:, r.rank * n:(r.rank + 1) * n]
    return all_reduce_model(x) if partial else x


def _global_shape(x: torch.Tensor, kind: str, width: int | None,
                  r: TPRegion) -> tuple[int, ...]:
    shape = [x.shape[0] * r.batch_split, *x.shape[1:]]
    if kind == "hidden":
        if width is not None:
            shape[1] = width
        return tuple(shape)
    if width is None:
        raise ValueError(f"constrain({kind!r}) in a region needs the "
                         "global width of its model dim")
    shape[{"heads": 2, "heads1": 1, "ff": -1}[kind]] = width
    return tuple(shape)


def constrain(x: torch.Tensor, kind: str, width: int | None = None,
              partial: bool = False) -> torch.Tensor:
    """Pin an activation's sharding (module docstring).

    In a tensor-parallel region ``x`` is this rank's block and ``width`` the
    global size of the dim that the kind may shard: H for ``heads`` /
    ``heads1``, ff for ``ff``, S for a ``hidden`` block already in its
    layout.  Those blocks are checked against :func:`activation_spec`'s
    shard shape and come back as they are.  A ``hidden`` x without a width
    is the whole sequence and is moved into its layout (``partial``: x is
    this rank's term of a sum over "model").  Out of a region a DTensor is
    redistributed to the spec's placements on its own mesh, and a plain
    tensor comes back unchanged.
    """
    r = current_region()
    if r is None:
        mesh = _STATE["mesh"]
        if mesh is None or os.environ.get("REPRO_NO_CONSTRAIN"):
            return x
        from torch.distributed.tensor import DTensor

        if not isinstance(x, DTensor):
            return x
        spec = activation_spec(tuple(x.shape), kind, mesh)
        return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))
    out = to_hidden(x, partial) if kind == "hidden" and width is None else x
    shape = _global_shape(x, kind, width, r)
    spec = activation_spec(shape, kind, r.sizes)
    want = shard_shape(shape, spec, r.sizes)
    if tuple(out.shape) != want:
        raise ValueError(f"{kind} block {tuple(out.shape)} is not the "
                         f"block {want} of {shape} under {spec}")
    return out
