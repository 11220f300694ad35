"""Train step for any ModelBundle with a loss: loss + gradients -> optional
int8 error-feedback compression -> AdamW; and the serving functions on a
mesh.

The reference's ``training/train_step.py`` on one card, or data-parallel
over a mesh's dp axes (a "model" axis of 1 for training; tensor-parallel
training is a later slice).  The gradients flow through the forward and backward kernels of K1
in every attention layer, K4 in every Mamba-2 block and K5 in every
recurrent layer, and with compression on every gradient leaf crosses
K2a (quantize) and K2b (dequantize) once a step: the numerics of a
compressed all-reduce, the residual carried to the next step.

The state is ``{"params", "opt": {"mu", "nu", "step"}, "residual"}`` (the
residual with compression on), the reference's tree, so its checkpoints
cross between the packages.  A step updates it in place and returns it, as
the reference's jit donates it.

On a mesh the policy of ``distributed/sharding.py`` places the batch (each
rank takes its rows by ``batch_axes``), while params and AdamW state stay
replicated: every rank builds them from the same seed and applies the same
update.  The loss is a mean over counted tokens, so the ranks all-reduce
their gradient sums and token counts: the gradient is the whole batch's, as
the reference's GSPMD step computes it, and every rank compresses that one
gradient and carries the same residual.

Serving (:func:`make_serve_fns`) also runs on a "model" axis above 1, for
the dense GQA transformers: each rank holds its blocks of the weights
(:func:`serving_pspecs`) and of the caches (``cache_pspecs``) and runs the
model Megatron-style on them in a tensor-parallel region
(``distributed/context.py``), the activations moving between ranks through
``torch.distributed`` collectives over the "model" axis (NCCL on the card).
:func:`init_serving_params` draws such weights block by block.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any

import torch

from ..device import resolve_device
from ..distributed.context import TPRegion, tensor_parallel
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
from .optimizer import AdamWConfig, adamw_init, adamw_update

__all__ = ["TrainStepConfig", "compress_grads_int8", "init_serving_params",
           "make_serve_fns", "make_train_step", "serving_pspecs"]


@dataclass(frozen=True)
class TrainStepConfig:
    opt: AdamWConfig = AdamWConfig()
    grad_compression: bool = False    # int8 error-feedback on gradients


def compress_grads_int8(grads: Any, residual: Any):
    """Error-feedback int8 compression: returns (decompressed, residual).

    Per leaf, g + r (float32) is quantized per row by K2a and dequantized by
    K2b (rows as the reference makes them: ``reshape(-1, last)``, a 1-D leaf
    one row); the float32 residual g + r - deq is written into ``residual``
    in place, and the decompressed gradient comes back in g's dtype.
    """
    flat_g, structure = tree_flatten(grads)
    flat_r = tree_flatten(residual)[0]
    out = []
    for g, r in zip(flat_g, flat_r):
        g32 = g.float() + r
        flat = g32.reshape(-1, g32.shape[-1]) if g32.ndim >= 2 \
            else g32.reshape(1, -1)
        q, scale = kops.quantize_int8(flat)
        deq = kops.dequantize_int8(q, scale, torch.float32).reshape(g32.shape)
        torch.sub(g32, deq, out=r)
        out.append(deq.to(g.dtype))
    return tree_unflatten(structure, out), residual


class _MeshPlace:
    """This rank's place on a mesh: its coordinates, the process group of
    the dp axes (all of the mesh's ranks; training takes a "model" axis of
    1 only) and, for serving, that of the "model" axis."""

    def __init__(self, mesh, serving: bool = False):
        import torch.distributed as dist

        self.sizes = mesh_shape(mesh)
        self.tp = int(self.sizes.get("model", 1))
        if self.tp > 1 and not serving:
            raise NotImplementedError(
                f"mesh {self.sizes}: tensor-parallel training (a 'model' "
                "axis above 1) is a later slice of the port (ROADMAP, "
                "Queue 1); use model=1")
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


def _whole_batch_mean(loss: torch.Tensor, grads: list, labels: torch.Tensor,
                      group) -> tuple[torch.Tensor, list]:
    """The whole batch's mean loss and gradients from each rank's mean over
    its own counted tokens (labels >= 0, as the loss counts them): one
    all-reduce of the count-weighted sums and the counts."""
    import torch.distributed as dist

    n = (labels >= 0).sum(dtype=torch.float32)
    flat = torch.cat([g.reshape(-1).float() * n for g in grads]
                     + [(loss.detach().float() * n).reshape(1), n.reshape(1)])
    dist.all_reduce(flat, group=group)
    total = flat[-1].clamp_min(1)
    out, at = [], 0
    for g in grads:
        out.append((flat[at:at + g.numel()] / total).view_as(g).to(g.dtype))
        at += g.numel()
    return flat[-2] / total, out


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
    passes the whole batch and steps on its dp rows, the gradients summed
    over the dp axes (module docstring).  A mesh of one device runs the
    one-card step itself; a "model" axis above 1 raises
    ``NotImplementedError``.
    """
    if bundle.loss is None:
        raise ValueError(f"{bundle.arch} ({bundle.family}) has no training loss")
    dev = resolve_device(device)
    place = _MeshPlace(mesh) if mesh is not None else None
    if place is not None and place.n == 1:
        place = None                    # one device: the one-card step

    def step_fn(state: dict, batch: dict):
        leaves, structure = tree_flatten(state["params"])
        ws = [p.detach().requires_grad_(True) for p in leaves]
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        rows = batch_axes(batch["labels"].shape[0], place.sizes) \
            if place is not None else None
        if rows is not None:
            batch = {k: place.local(v, (rows,)) for k, v in batch.items()}
        loss = bundle.loss(tree_unflatten(structure, ws), batch)
        # a leaf the loss does not read (prefix_proj without a prefix) gets zeros
        flat = list(torch.autograd.grad(loss, ws, allow_unused=True,
                                        materialize_grads=True))
        del ws
        if rows is not None:
            loss, flat = _whole_batch_mean(loss, flat, batch["labels"],
                                           place.group)
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


def _check_tp(bundle) -> None:
    """Tensor-parallel serving runs the dense GQA transformers; the other
    families keep raising on a "model" axis above 1."""
    cfg = bundle.cfg
    what = None
    if bundle.family != "transformer":
        what = f"the {bundle.family} family"
    elif cfg.moe is not None:
        what = "MoE experts"
    elif cfg.mla is not None:
        what = "MLA's latent cache"
    if what is not None:
        raise NotImplementedError(
            f"{bundle.arch}: tensor-parallel serving (a 'model' axis above 1) "
            f"runs the dense GQA transformers; {what} under tensor parallelism "
            "is a later slice of the port (ROADMAP, Queue 1)")


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
    place = _MeshPlace(mesh, serving=True)
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
    and the caches by ``cache_pspecs``; logits and caches come back as
    DTensors on ``mesh``.

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
    place = _MeshPlace(mesh, serving=True)
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

    def on_rank(x, spec):
        return place.local(torch.as_tensor(x, device=dev), spec)

    if shape.kind == "prefill":
        def prefill_fn(params, batch, max_len=None):
            n = max(shape.seq_len, max_len or 0)
            cache_sh = cache_pspecs(bundle.cache_spec(shape.global_batch, n),
                                    sizes, family=bundle.family)
            local = {k: on_rank(v, in_sh[k]) for k, v in batch.items()}
            blocks = _tp_blocks(place, params, tp_specs)
            with tensor_parallel(region):
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
        with tensor_parallel(region):
            logits, local = bundle.decode(blocks, local,
                                          on_rank(tokens, (dpb,)), int(pos))
        return (place.wrap(logits, logits_spec),
                _with_specs(place.wrap, local, cache_sh))

    decode_fn.param_specs = pspecs
    return decode_fn, ispecs
