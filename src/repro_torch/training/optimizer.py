"""AdamW with decoupled weight decay, the reference's ``training/optimizer.py``.

The reference returns new trees; here the update is in place (the params,
``mu``, ``nu`` and the gradients passed in are overwritten), as the
reference's jitted step donates its state: at Llama-3-8B's width a second
copy of the float32 state would not fit beside the first on one card.  The
arithmetic is the reference's, leaf by leaf in its order (dict keys sorted).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from ..models.common import tree_flatten, tree_map

__all__ = ["AdamWConfig", "lr_schedule", "adamw_init", "adamw_update",
           "global_norm", "clip_by_global_norm"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_frac * lr, in float32."""
    step = step.float()
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def adamw_init(params: Any) -> dict:
    """Zero float32 moments shaped like ``params`` and an int32 step 0, on
    the params' device."""
    def zeros(p):
        return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                              device=x.device), p)
    device = tree_flatten(params)[0][0].device
    return {"mu": zeros(params), "nu": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any, counted=None, reduce=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, summed leaf by leaf.

    On a mesh each leaf is this rank's block of the global leaf: ``counted``
    (per leaf, in ``tree_flatten``'s order) says whether this rank adds its
    block (a block that several ranks hold counts once), and ``reduce``
    sums the local total over the mesh (an all-reduce, in place)."""
    leaves = tree_flatten(tree)[0]
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for x, c in zip(leaves, counted or [True] * len(leaves)):
        if c:
            total = total + torch.sum(torch.square(x.float()))
    if reduce is not None:
        total = reduce(total)
    return torch.sqrt(total)


def _scaled(grads: Any, max_norm: float, norm: torch.Tensor) -> Any:
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12), 1.0)
    return tree_map(lambda g: g.mul_(scale), grads)


def clip_by_global_norm(grads: Any, max_norm: float):
    """(grads scaled in place to a global norm of at most ``max_norm``, the
    norm before)."""
    norm = global_norm(grads)
    return _scaled(grads, max_norm, norm), norm


def adamw_update(cfg: AdamWConfig, params: Any, grads: Any, state: dict,
                 gnorm: torch.Tensor | None = None):
    """One AdamW step in place.  Returns ``(params, state, metrics)``: the
    trees passed in, updated, and {"grad_norm", "lr"} (0-d tensors).
    ``gnorm`` is the gradients' global norm where the caller computed it
    (on a mesh, over the ranks' blocks: :func:`global_norm` with
    ``counted`` and ``reduce``); by default :func:`global_norm` of
    ``grads``.

    Weight decay applies to leaves of two or more dimensions (the stacked
    norm scales [L, d] included), as in the reference.
    """
    grads = tree_map(lambda g: g.float(), grads)
    if gnorm is None:
        gnorm = global_norm(grads)
    if cfg.grad_clip:
        grads = _scaled(grads, cfg.grad_clip, gnorm)
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    flat_p = tree_flatten(params)[0]
    flat_g = tree_flatten(grads)[0]
    flat_m = tree_flatten(state["mu"])[0]
    flat_v = tree_flatten(state["nu"])[0]
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if p.ndim >= 2:
            upd = upd + cfg.weight_decay * p.float()
        p.sub_(lr * upd)            # in float32, rounded to p's dtype
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
