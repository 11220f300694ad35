"""Train step for any ModelBundle with a loss: loss + gradients -> optional
int8 error-feedback compression -> AdamW; and the serving functions on a
mesh.

The reference's ``training/train_step.py`` on one card or on a mesh:
data-parallel over its dp axes, tensor-parallel on a "model" axis above 1.  The
gradients flow through the forward and backward kernels of K1
in every attention layer, K4 in every Mamba-2 block and K5 in every
recurrent layer, and with compression on every gradient leaf crosses
K2a (quantize) and K2b (dequantize) once a step: the numerics of a
compressed all-reduce, the residual carried to the next step.

The state is ``{"params", "opt": {"mu", "nu", "step"}, "residual"}`` (the
residual with compression on), the reference's tree, so its checkpoints
cross between the packages.  A step updates it in place and returns it, as
the reference's jit donates it.

On a mesh of more than one device the state is stored as the reference
stores it, FSDP × TP under ``param_pspecs``: each rank holds DTensor
blocks, gathers them into its TP blocks for the step, runs the loss on its
dp rows (on a "model" axis above 1 Megatron-style in a tensor-parallel
region, the dense GQA transformers), reduces the gradients back into its
blocks as the whole batch's, which it compresses (each row's absmax
reduced over the ranks that split the row) and updates
(:func:`_make_mesh_train_step`).

Serving (:func:`make_serve_fns`) also runs on a "model" axis above 1, for
the dense GQA transformers: each rank holds its blocks of the weights
(:func:`serving_pspecs`) and of the caches (``cache_pspecs``) and runs the
model Megatron-style on them in a tensor-parallel region
(``distributed/context.py``), the activations moving between ranks through
``torch.distributed`` collectives over the "model" axis (NCCL on the card).
:func:`init_serving_params` draws such weights block by block.
"""

from __future__ import annotations

import functools
import math
import os
from dataclasses import dataclass
from typing import Any

import torch

from ..device import resolve_device
from ..distributed.context import TPRegion, split_batch, tensor_parallel
from ..distributed.fsdp import axis_group, layouts
from ..distributed.sharding import (
    batch_axes,
    block_keeper,
    cache_pspecs,
    dp_axes,
    input_pspecs,
    local_slices,
    mesh_shape,
    param_pspecs,
    placements,
    strip_dp,
)
from ..kernels import ops as kops
from ..models.common import tree_flatten, tree_map, tree_unflatten
from .optimizer import AdamWConfig, adamw_init, adamw_update, global_norm

__all__ = ["TrainStepConfig", "compress_grads_int8", "init_serving_params",
           "make_serve_fns", "make_train_step", "serving_pspecs"]


@dataclass(frozen=True)
class TrainStepConfig:
    opt: AdamWConfig = AdamWConfig()
    grad_compression: bool = False    # int8 error-feedback on gradients


def compress_grads_int8(grads: Any, residual: Any, row_groups=None):
    """Error-feedback int8 compression: returns (decompressed, residual).

    Per leaf, g + r (float32) is quantized per row by K2a and dequantized by
    K2b (rows as the reference makes them: ``reshape(-1, last)``, a 1-D leaf
    one row); the float32 residual g + r - deq is written into ``residual``
    in place, and the decompressed gradient comes back in g's dtype.

    On a mesh a leaf may be a rank's block of the global leaf, whose rows
    other ranks hold pieces of: ``row_groups`` gives per leaf (in
    ``tree_flatten``'s order) the process group of those ranks, or None.
    Such a block's row absmax (K2a's absmax pass) is reduced (MAX) over the
    group before K2a quantizes the block with it, so the codes and scales
    are the global leaf's, bit for bit.
    """
    import torch.distributed as dist

    flat_g, structure = tree_flatten(grads)
    flat_r = tree_flatten(residual)[0]
    groups = row_groups or [None] * len(flat_g)
    out = []
    for g, r, group in zip(flat_g, flat_r, groups):
        g32 = g.float() + r
        flat = g32.reshape(-1, g32.shape[-1]) if g32.ndim >= 2 \
            else g32.reshape(1, -1)
        if group is None:
            q, scale = kops.quantize_int8(flat)
        else:
            amax = kops.row_absmax(flat)
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
            q, scale = kops.quantize_int8(flat, absmax=amax)
        deq = kops.dequantize_int8(q, scale, torch.float32).reshape(g32.shape)
        torch.sub(g32, deq, out=r)
        out.append(deq.to(g.dtype))
    return tree_unflatten(structure, out), residual


class _MeshPlace:
    """This rank's place on a mesh: its coordinates, the process group of
    all of the mesh's ranks and that of the "model" axis."""

    def __init__(self, mesh):
        import torch.distributed as dist

        self.sizes = mesh_shape(mesh)
        self.tp = int(self.sizes.get("model", 1))
        self.mesh = mesh
        self.coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        self.n = mesh.size()
        self.group = None if self.n == dist.get_world_size() else \
            dist.new_group(mesh.mesh.flatten().tolist())
        self.model_group = mesh.get_group("model") if self.tp > 1 else None

    def region(self, batch: int) -> TPRegion:
        """The tensor-parallel region of a step whose global batch is
        ``batch`` (split over dp where it divides, as ``batch_axes``)."""
        dp = math.prod(self.sizes[a] for a in dp_axes(self.sizes))
        split = dp if batch_axes(batch, self.sizes) is not None else 1
        return TPRegion(self.sizes, int(self.coord.get("model", 0)),
                        self.model_group, split)

    def local(self, x: torch.Tensor, spec: tuple) -> torch.Tensor:
        """This rank's block of the global tensor ``x`` under ``spec``,
        contiguous (the kernels take contiguous tensors; a whole tensor is
        ``x`` itself)."""
        return x[local_slices(tuple(x.shape), spec, self.sizes,
                              self.coord)].contiguous()

    def wrap(self, x: torch.Tensor, spec: tuple):
        """The DTensor whose block on this rank is ``x``."""
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(x, self.mesh, placements(spec, self.mesh),
                                  run_check=False)


def _with_specs(fn, tree: Any, specs: Any) -> Any:
    """``fn(leaf, spec)`` over a dict/list tree and its spec tree."""
    if isinstance(tree, dict):
        return {k: _with_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with_specs(fn, v, sp) for v, sp in zip(tree, specs)]
    return fn(tree, specs)


def make_train_step(bundle, cfg: TrainStepConfig = TrainStepConfig(),
                    device: str | torch.device = "cuda", mesh=None):
    """``(step_fn, init_state)``: ``step_fn(state, batch) -> (state,
    metrics)`` with metrics {"loss", "grad_norm", "lr"} (0-d tensors);
    ``init_state(seed=0, params=None)`` builds the state on ``device`` from
    ``bundle.init`` with a seeded generator (float32 params), or around
    given ``params``.

    ``batch`` holds numpy arrays or tensors ({"tokens", "labels"}, and
    "prefix_embeds" for a modality prefix); they are moved to ``device``.

    ``mesh`` (a named ``DeviceMesh``, from ``launch/mesh.py``): every rank
    passes the whole batch and steps on its dp rows, the state stored FSDP
    × TP (:func:`_make_mesh_train_step`).  A mesh of one device runs the
    one-card step itself.  On a "model" axis above 1 the step is
    tensor-parallel for the dense GQA transformers; the other families
    raise ``NotImplementedError`` there.
    """
    if bundle.loss is None:
        raise ValueError(f"{bundle.arch} ({bundle.family}) has no training loss")
    dev = resolve_device(device)
    if mesh is not None and mesh.size() > 1:
        return _make_mesh_train_step(bundle, cfg, dev, _MeshPlace(mesh))

    def step_fn(state: dict, batch: dict):
        leaves, structure = tree_flatten(state["params"])
        ws = [p.detach().requires_grad_(True) for p in leaves]
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        loss = bundle.loss(tree_unflatten(structure, ws), batch)
        # a leaf the loss does not read (prefix_proj without a prefix) gets zeros
        flat = list(torch.autograd.grad(loss, ws, allow_unused=True,
                                        materialize_grads=True))
        del ws
        grads = tree_unflatten(structure, flat)
        if cfg.grad_compression:
            grads, state["residual"] = compress_grads_int8(grads,
                                                           state["residual"])
        _, state["opt"], metrics = adamw_update(cfg.opt, state["params"], grads,
                                                state["opt"])
        return state, dict(metrics, loss=loss.detach())

    def init_state(seed: int = 0, params: Any = None) -> dict:
        if params is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            params = bundle.init(gen, dev, torch.float32)
        state = {"params": params, "opt": adamw_init(params)}
        if cfg.grad_compression:
            state["residual"] = tree_map(
                lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                      device=x.device), params)
        return state

    return step_fn, init_state


def _make_mesh_train_step(bundle, cfg: TrainStepConfig, dev: torch.device,
                          place: _MeshPlace):
    """:func:`make_train_step` on a mesh of more than one device.

    The state's ``params``, ``mu``, ``nu`` and ``residual`` are DTensors
    under ``param_pspecs`` of the float32 params (FSDP × TP, the
    reference's ``state_specs``); the step counter is replicated.  A step:

    1. each leaf's FSDP block is gathered into the rank's TP block
       (``LeafLayout.tp_block``: an all-gather over the dp axes that shard
       it, none where they are 1);
    2. ``bundle.loss`` runs on the rank's dp rows and TP blocks, on a
       "model" axis above 1 in its tensor-parallel region
       (``distributed/context.py``), whose collectives carry the gradients
       back; the loss is seeded ``n / (N tp)``: the rank's share of the
       whole batch's mean (n its counted tokens, N the batch's, the tp
       ranks of "model" holding the same rows);
    3. ``LeafLayout.reduce`` sums each gradient over the ranks into the
       FSDP block (over "model" for a leaf it replicates, then
       reduce-scattered over the dp axes that shard it and all-reduced over
       the others), so every block holds the whole batch's gradient, as the
       reference's GSPMD step computes it;
    4. int8 compression on the blocks (``compress_grads_int8`` with the
       groups that split each leaf's rows), the global norm from local
       sums of squares all-reduced over the mesh (a block that several
       ranks hold counted once), and AdamW in place on the blocks.

    ``step_fn.loss_and_grads(state, batch)`` runs steps 1-3 alone (the
    whole batch's loss and this rank's gradient blocks, in
    ``tree_flatten``'s order) and ``step_fn.param_specs`` is the state's
    spec tree.
    """
    import torch.distributed as dist

    if place.tp > 1:
        _check_tp(bundle, "training")
    sizes = place.sizes
    shapes = bundle.param_specs(torch.float32)
    specs = param_pspecs(shapes, sizes)
    lays = layouts(shapes, specs, place.mesh)
    dp = tuple(a for a in dp_axes(sizes) if sizes[a] > 1)
    dp_group = axis_group(place.mesh, dp) if dp else None
    row_groups = [lay.row_group() for lay in lays] if cfg.grad_compression \
        else None
    counted = [lay.counted for lay in lays]

    def norm_reduce(total: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(total, group=place.group)
        return total

    def loss_and_grads(state: dict, batch: dict):
        leaves, structure = tree_flatten(state["params"])
        ws = [lay.tp_block(t.to_local()).detach().requires_grad_(True)
              for lay, t in zip(lays, leaves)]
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        b = batch["labels"].shape[0]
        rows = batch_axes(b, sizes)
        if rows is not None:
            batch = {k: place.local(v, (rows,)) for k, v in batch.items()}
        n = (batch["labels"] >= 0).sum(dtype=torch.float32)
        total = n.clone()
        if dp_group is not None:
            dist.all_reduce(total, group=dp_group)
        total = total.clamp_min(1)
        region = place.region(b) if place.tp > 1 else None
        with tensor_parallel(region), \
                split_batch(dp_group if rows is not None else None):
            loss = bundle.loss(tree_unflatten(structure, ws), batch)
            # a leaf the loss does not read (prefix_proj without a prefix)
            # gets zeros
            flat = list(torch.autograd.grad(
                loss, ws, grad_outputs=n / (total * place.tp),
                allow_unused=True, materialize_grads=True))
        del ws
        mean = loss.detach().float() * n
        if dp_group is not None:
            dist.all_reduce(mean, group=dp_group)
        for i, lay in enumerate(lays):
            flat[i] = lay.reduce(flat[i])
        return mean / total, flat

    def step_fn(state: dict, batch: dict):
        loss, flat = loss_and_grads(state, batch)
        leaves, structure = tree_flatten(state["params"])
        grads = tree_unflatten(structure, flat)
        del flat
        if cfg.grad_compression:
            grads, _ = compress_grads_int8(
                grads, tree_map(lambda t: t.to_local(), state["residual"]),
                row_groups)
        opt = {"mu": tree_map(lambda t: t.to_local(), state["opt"]["mu"]),
               "nu": tree_map(lambda t: t.to_local(), state["opt"]["nu"]),
               "step": state["opt"]["step"]}
        _, opt, metrics = adamw_update(
            cfg.opt, tree_unflatten(structure, [t.to_local() for t in leaves]),
            grads, opt, global_norm(grads, counted, norm_reduce))
        state["opt"]["step"] = opt["step"]
        return state, dict(metrics, loss=loss)

    def init_state(seed: int = 0, params: Any = None) -> dict:
        """The state's blocks: ``params`` given whole (each rank keeps its
        blocks), else drawn from ``seed`` in float32, the transformers'
        block by block (``block_keeper``); each rank's blocks bit for bit
        ``local_slices`` of the one-device init."""
        if params is None and bundle.family == "transformer":
            gen = torch.Generator(device=dev).manual_seed(seed)
            params = bundle.init(gen, dev, torch.float32,
                                 keep=block_keeper(specs, sizes, place.coord))
        else:
            if params is None:
                gen = torch.Generator(device=dev).manual_seed(seed)
                params = bundle.init(gen, dev, torch.float32)
            params = _with_specs(lambda t, sp: place.local(t.to(dev), sp),
                                 params, specs)

        def zeros():
            return wrap(tree_map(lambda x: torch.zeros(
                x.shape, dtype=torch.float32, device=x.device), params))

        wrap = functools.partial(_with_specs, place.wrap, specs=specs)
        state = {"params": wrap(params), "opt": {
            "mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}}
        if cfg.grad_compression:
            state["residual"] = zeros()
        return state

    step_fn.param_specs = specs
    step_fn.loss_and_grads = loss_and_grads
    return step_fn, init_state


def _tp_blocks(place: _MeshPlace, params: Any, tp_specs: Any) -> Any:
    """This rank's blocks of the params under the TP-only specs: a DTensor
    leaf in those placements is its local block; one whose placements add
    dp axes (FSDP storage, ``REPRO_SERVE_FSDP``) is all-gathered over them
    first; a plain tensor is whole, and sliced."""
    from torch.distributed.tensor import DTensor

    def leaf(t, spec):
        if not isinstance(t, DTensor):
            return place.local(t, spec)
        want = placements(spec, place.mesh)
        if tuple(t.placements) != want:
            t = t.redistribute(place.mesh, want)
        return t.to_local()

    return _with_specs(leaf, params, tp_specs)


def _check_tp(bundle, use: str = "serving") -> None:
    """Tensor-parallel serving and training run the dense GQA transformers;
    the other families keep raising on a "model" axis above 1."""
    cfg = bundle.cfg
    what = None
    if bundle.family != "transformer":
        what = f"the {bundle.family} family"
    elif cfg.moe is not None:
        what = "MoE experts"
    elif cfg.mla is not None:
        what = "MLA's latent cache" if use == "serving" else "MLA"
    if what is not None:
        raise NotImplementedError(
            f"{bundle.arch}: tensor-parallel {use} (a 'model' axis above 1) "
            f"runs the dense GQA transformers; {what} under tensor parallelism "
            "is a later slice of the port (ROADMAP, Queue 1: the other "
            "families under TP)")


def serving_pspecs(bundle, mesh) -> Any:
    """The serving params' specs (bf16): TP only, ``strip_dp(param_pspecs)``;
    with ``REPRO_SERVE_FSDP`` set, the FSDP specs (the paper-faithful
    baseline, for before/after measurement)."""
    pspecs = param_pspecs(bundle.param_specs(torch.bfloat16), mesh)
    return pspecs if os.environ.get("REPRO_SERVE_FSDP") else strip_dp(pspecs)


def init_serving_params(bundle, mesh, generator: torch.Generator,
                        device: str | torch.device = "cuda",
                        dtype=torch.bfloat16) -> Any:
    """Serving weights drawn by ``bundle.init`` from ``generator``, each rank
    keeping only its blocks under :func:`serving_pspecs` (``block_keeper``:
    every tensor is drawn whole, in the one-device order, its block kept
    and the rest freed), as DTensors on ``mesh`` in those placements.  The
    blocks are bit for bit ``local_slices`` of the one-device init from the
    same generator state.  Every rank draws every tensor, so a rank's
    device must hold the largest one whole (in float32) beside its blocks.
    """
    place = _MeshPlace(mesh)
    specs = serving_pspecs(bundle, place.sizes)
    dev = resolve_device(device)
    if bundle.family != "transformer":
        raise NotImplementedError(f"{bundle.arch}: sharded init draws the "
                                  "transformers' params")
    local = bundle.init(generator, dev, dtype,
                        keep=block_keeper(specs, place.sizes, place.coord))
    return _with_specs(place.wrap, local, specs)


def make_serve_fns(bundle, mesh, shape, device: str | torch.device = "cuda"):
    """``(fn, ispecs)``: the serving step of ``shape`` on ``mesh`` and its
    inputs as ``meta`` tensors (``bundle.input_specs``).

    prefill: ``fn(params, batch) -> (logits, cache)``; decode: ``fn(params,
    cache, tokens, pos) -> (logits, cache)``, the cache updated in place
    where the port's decode does.  Inputs are global (every rank passes the
    whole batch; a cache may also be the DTensors a prefill returned); each
    rank runs its rows, split over dp by ``batch_axes(shape.global_batch)``
    (MoE routing takes them as the whole batch's: ``split_batch``), and the
    caches by ``cache_pspecs``; logits and caches come back as DTensors on
    ``mesh``.

    ``fn.param_specs`` is the params' placement, :func:`serving_pspecs`
    (TP only unless ``REPRO_SERVE_FSDP`` is set).  Params may be DTensors
    so placed (:func:`init_serving_params`), whose blocks each rank runs on
    (under ``REPRO_SERVE_FSDP`` gathered over the dp axes only), or plain
    whole tensors, which each rank slices.

    On a "model" axis above 1 each rank runs the dense GQA transformer on
    its blocks (module docstring); the results equal the one-device
    computation's.  A prefill's ``fn(params, batch, max_len=None)`` sizes
    the cache for ``max_len`` (default ``shape.seq_len``), as
    ``bundle.prefill`` does; a sequence-sharded cache's length must divide
    the "model" axis.  The MoE, MLA, Mamba-2 and Griffin families raise
    ``NotImplementedError`` there.
    """
    dev = resolve_device(device)
    place = _MeshPlace(mesh)
    sizes = place.sizes
    if place.tp > 1:
        _check_tp(bundle)
    pspecs = serving_pspecs(bundle, sizes)
    tp_specs = strip_dp(pspecs)
    ispecs = bundle.input_specs(shape)
    in_sh = input_pspecs(ispecs, sizes, family=bundle.family)
    dpb = batch_axes(shape.global_batch, sizes)
    logits_spec = (dpb, "model" if bundle.cfg.vocab % sizes["model"] == 0
                   else None)
    region = place.region(shape.global_batch)
    dp = tuple(a for a in dp_axes(sizes) if sizes[a] > 1)
    rows = axis_group(place.mesh, dp) if dpb is not None and dp else None

    def on_rank(x, spec):
        return place.local(torch.as_tensor(x, device=dev), spec)

    if shape.kind == "prefill":
        def prefill_fn(params, batch, max_len=None):
            n = max(shape.seq_len, max_len or 0)
            cache_sh = cache_pspecs(bundle.cache_spec(shape.global_batch, n),
                                    sizes, family=bundle.family)
            local = {k: on_rank(v, in_sh[k]) for k, v in batch.items()}
            blocks = _tp_blocks(place, params, tp_specs)
            with tensor_parallel(region), split_batch(rows):
                logits, cache = bundle.prefill(blocks, local, n)
            return (place.wrap(logits, logits_spec),
                    _with_specs(place.wrap, cache, cache_sh))

        prefill_fn.param_specs = pspecs
        return prefill_fn, ispecs

    cache_sh = in_sh["cache"]

    def decode_fn(params, cache, tokens, pos):
        from torch.distributed.tensor import DTensor

        local = _with_specs(lambda t, sp: t.to_local() if isinstance(t, DTensor)
                            else on_rank(t, sp), cache, cache_sh)
        blocks = _tp_blocks(place, params, tp_specs)
        with tensor_parallel(region), split_batch(rows):
            logits, local = bundle.decode(blocks, local,
                                          on_rank(tokens, (dpb,)), int(pos))
        return (place.wrap(logits, logits_spec),
                _with_specs(place.wrap, local, cache_sh))

    decode_fn.param_specs = pspecs
    return decode_fn, ispecs
