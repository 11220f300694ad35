"""Train step for any ModelBundle with a loss: loss + gradients -> optional
int8 error-feedback compression -> AdamW; and the serving functions on a
mesh.

The reference's ``training/train_step.py`` on one card, or data-parallel
over a mesh's dp axes (a "model" axis of 1; tensor-parallel execution is a
later slice).  The gradients flow through the forward and backward kernels of K1
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
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any

import torch

from ..device import resolve_device
from ..distributed.sharding import (
    batch_axes,
    cache_pspecs,
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

__all__ = ["TrainStepConfig", "compress_grads_int8", "make_serve_fns",
           "make_train_step", "serving_pspecs"]


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
    """This rank's place on a mesh whose "model" axis is 1: its coordinates,
    and the process group of the dp axes (all of the mesh's ranks)."""

    def __init__(self, mesh):
        import torch.distributed as dist

        self.sizes = mesh_shape(mesh)
        if self.sizes.get("model", 1) > 1:
            raise NotImplementedError(
                f"mesh {self.sizes}: tensor-parallel execution (a 'model' "
                "axis above 1) is a later slice of the port; use model=1")
        self.mesh = mesh
        self.coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        self.n = mesh.size()
        self.group = None if self.n == dist.get_world_size() else \
            dist.new_group(mesh.mesh.flatten().tolist())

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


def _gathered(params: Any) -> Any:
    """Params whole on every rank: a DTensor leaf (FSDP storage) is
    all-gathered, a plain tensor is already whole."""
    from torch.distributed.tensor import DTensor

    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor) else t,
                    params)


def serving_pspecs(bundle, mesh) -> Any:
    """The serving params' specs (bf16): TP only, ``strip_dp(param_pspecs)``;
    with ``REPRO_SERVE_FSDP`` set, the FSDP specs (the paper-faithful
    baseline, for before/after measurement)."""
    pspecs = param_pspecs(bundle.param_specs(torch.bfloat16), mesh)
    return pspecs if os.environ.get("REPRO_SERVE_FSDP") else strip_dp(pspecs)


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
    (replicated at model 1 unless ``REPRO_SERVE_FSDP`` is set).  Params may
    be plain tensors or DTensors so placed; a DTensor leaf is all-gathered
    for the step.
    A "model" axis above 1 raises ``NotImplementedError``.
    """
    dev = resolve_device(device)
    place = _MeshPlace(mesh)
    sizes = place.sizes
    pspecs = serving_pspecs(bundle, sizes)
    ispecs = bundle.input_specs(shape)
    in_sh = input_pspecs(ispecs, sizes, family=bundle.family)
    dpb = batch_axes(shape.global_batch, sizes)
    logits_spec = (dpb, "model" if bundle.cfg.vocab % sizes["model"] == 0
                   else None)

    def on_rank(x, spec):
        return place.local(torch.as_tensor(x, device=dev), spec)

    if shape.kind == "prefill":
        cache_sh = cache_pspecs(bundle.cache_spec(shape.global_batch,
                                                  shape.seq_len),
                                sizes, family=bundle.family)

        def prefill_fn(params, batch):
            local = {k: on_rank(v, in_sh[k]) for k, v in batch.items()}
            logits, cache = bundle.prefill(_gathered(params), local)
            return (place.wrap(logits, logits_spec),
                    _with_specs(place.wrap, cache, cache_sh))

        prefill_fn.param_specs = pspecs
        return prefill_fn, ispecs

    cache_sh = in_sh["cache"]

    def decode_fn(params, cache, tokens, pos):
        from torch.distributed.tensor import DTensor

        local = _with_specs(lambda t, sp: t.to_local() if isinstance(t, DTensor)
                            else on_rank(t, sp), cache, cache_sh)
        logits, local = bundle.decode(_gathered(params), local,
                                      on_rank(tokens, (dpb,)), int(pos))
        return (place.wrap(logits, logits_spec),
                _with_specs(place.wrap, local, cache_sh))

    decode_fn.param_specs = pspecs
    return decode_fn, ispecs
