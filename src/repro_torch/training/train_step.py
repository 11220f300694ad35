"""Train step for any ModelBundle with a loss: loss + gradients -> optional
int8 error-feedback compression -> AdamW.

The reference's ``training/train_step.py`` without the mesh: one card, no
sharding (``make_serve_fns`` and the sharded step wait for the distributed
slice).  The gradients flow through the forward and backward kernels of K1
in every attention layer, K4 in every Mamba-2 block and K5 in every
recurrent layer, and with compression on every gradient leaf crosses
K2a (quantize) and K2b (dequantize) once a step: the numerics of a
compressed all-reduce, the residual carried to the next step.

The state is ``{"params", "opt": {"mu", "nu", "step"}, "residual"}`` (the
residual with compression on), the reference's tree, so its checkpoints
cross between the packages.  A step updates it in place and returns it, as
the reference's jit donates it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..device import resolve_device
from ..kernels import ops as kops
from ..models.common import tree_flatten, tree_map, tree_unflatten
from .optimizer import AdamWConfig, adamw_init, adamw_update

__all__ = ["TrainStepConfig", "compress_grads_int8", "make_train_step"]


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


def make_train_step(bundle, cfg: TrainStepConfig = TrainStepConfig(),
                    device: str | torch.device = "cuda"):
    """``(step_fn, init_state)``: ``step_fn(state, batch) -> (state,
    metrics)`` with metrics {"loss", "grad_norm", "lr"} (0-d tensors);
    ``init_state(seed=0, params=None)`` builds the state on ``device`` from
    ``bundle.init`` with a seeded generator (float32 params: the backward
    kernels have no bf16 instance yet), or around given ``params``.

    ``batch`` holds numpy arrays or tensors ({"tokens", "labels"}, and
    "prefix_embeds" for a modality prefix); they are moved to ``device``.
    """
    if bundle.loss is None:
        raise ValueError(f"{bundle.arch} ({bundle.family}) has no training loss")
    dev = resolve_device(device)

    def step_fn(state: dict, batch: dict):
        leaves, structure = tree_flatten(state["params"])
        ws = [p.detach().requires_grad_(True) for p in leaves]
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        loss = bundle.loss(tree_unflatten(structure, ws), batch)
        # a leaf the loss does not read (prefix_proj without a prefix) gets zeros
        grads = tree_unflatten(structure, torch.autograd.grad(
            loss, ws, allow_unused=True, materialize_grads=True))
        del ws
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
