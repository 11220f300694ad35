"""Shared building blocks for the model families (plain functions on tensors)."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

Params = Any  # nested dict of tensors


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: cap·tanh(x/cap)."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    s = (1.0 + scale.float()) if plus_one else scale.float()
    return (x * s).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def apply_norm(x: torch.Tensor, p: Params, kind: str, **kw) -> torch.Tensor:
    if kind == "rms":
        return rms_norm(x, p["scale"], **kw)
    if kind == "rms1":  # gemma-style (1 + scale)
        return rms_norm(x, p["scale"], plus_one=True, **kw)
    if kind == "ln":
        return layer_norm(x, p["scale"], p["bias"], **kw)
    raise ValueError(kind)


def norm_params(d: int, kind: str, device, dtype=torch.float32) -> Params:
    if kind in ("rms", "rms1"):
        init = torch.zeros if kind == "rms1" else torch.ones
        return {"scale": init((d,), dtype=dtype, device=device)}
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    if kind == "relu":
        return F.relu(x)
    raise ValueError(kind)


# --------------------------------------------------------------------------- #
# rotary embeddings
# --------------------------------------------------------------------------- #
def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0,
               rope_dim: int | None = None) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: broadcastable to [..., S].

    ``rope_dim``: rotate only the first ``rope_dim`` features (partial RoPE).
    Interleaved pairs (features 2i and 2i+1 rotate together), not the
    rotate-half layout.
    """
    hd = x.shape[-1]
    rd = hd if rope_dim is None else rope_dim
    xr, xp = x[..., :rd], x[..., rd:]
    freqs = rope_frequencies(rd, theta, x.device)             # [rd/2]
    ang = positions[..., None].float() * freqs                # [..., S, rd/2]
    cos = torch.cos(ang)[..., None, :]                        # [..., S, 1, rd/2]
    sin = torch.sin(ang)[..., None, :]
    x1 = xr[..., 0::2].float()
    x2 = xr[..., 1::2].float()
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rd < hd else out


# --------------------------------------------------------------------------- #
# initializers: the reference's distributions, drawn from a torch.Generator
# --------------------------------------------------------------------------- #
def dense_init(gen: torch.Generator, shape, device, dtype=torch.float32,
               scale: float | None = None) -> torch.Tensor:
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * s).to(dtype)


def embed_init(gen: torch.Generator, shape, device,
               dtype=torch.float32) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * 0.02).to(dtype)
