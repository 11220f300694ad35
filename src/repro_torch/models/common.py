"""Shared building blocks for the model families (plain functions on tensors)."""

from __future__ import annotations

from typing import Any, Callable

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


def causal_conv1d(u: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                  prev: torch.Tensor | None = None) -> torch.Tensor:
    """Causal depthwise conv: u [B,S,C], w [K,C], bias [C]; ``prev``
    [B,K-1,C] is the history before u (zeros when None).  The K taps are
    added in order in u's dtype, as the reference's Mamba-2 and Griffin do."""
    k = w.shape[0]
    if prev is None:
        up = F.pad(u, (0, 0, k - 1, 0))
    else:
        up = torch.cat([prev.to(u.dtype), u], dim=1)
    s = u.shape[1]
    out = up[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, k):
        out = out + up[:, i:i + s, :] * w[i][None, None, :]
    return out + bias[None, None, :]


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


# --------------------------------------------------------------------------- #
# parameter trees
# --------------------------------------------------------------------------- #
def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """Apply ``fn`` to every tensor of a nested dict/list param tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


# The walks below are module functions that take their accumulator as an
# argument: a recursive closure is a reference cycle (the function and its
# own cell) that would keep the leaves it captured, a step's gradients
# among them, alive until the garbage collector runs.
def _flatten_into(t: Any, leaves: list) -> Any:
    if isinstance(t, dict):
        return {k: _flatten_into(t[k], leaves) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return [_flatten_into(v, leaves) for v in t]
    leaves.append(t)
    return None


def _build_from(s: Any, it) -> Any:
    if isinstance(s, dict):
        return {k: _build_from(v, it) for k, v in s.items()}
    if isinstance(s, list):
        return [_build_from(v, it) for v in s]
    return next(it)


def tree_flatten(tree: Any) -> tuple[list, Any]:
    """The leaves of a nested dict/list tree in JAX's order (dict keys
    sorted, lists in order), and its structure for :func:`tree_unflatten`."""
    leaves: list = []
    return leaves, _flatten_into(tree, leaves)


def tree_unflatten(structure: Any, leaves) -> Any:
    """The tree of ``structure`` (from :func:`tree_flatten`) with ``leaves``."""
    return _build_from(structure, iter(leaves))


def count_params(params: Params) -> int:
    return sum(int(np.prod(x.shape)) for x in tree_flatten(params)[0])


def cast_tree(params: Params, dtype) -> Params:
    """Floating leaves cast to ``dtype``; integer leaves as they are."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    params)


def layer(blocks: Params, i: int) -> Params:
    """The i-th layer of a stacked block tree (views, no copies)."""
    return tree_map(lambda a: a[i], blocks)


def unstack_layers(blocks: Params) -> list[Params]:
    """Every layer of a stacked block tree, as views.

    Each leaf is unbound once, so under autograd its gradient is one stack
    of the layers' gradients; slicing layer by layer (:func:`layer`) would
    give each slice's backward a zero [L, ...] tensor of its own.
    """
    if isinstance(blocks, dict):
        per_key = {k: unstack_layers(v) for k, v in blocks.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(blocks.unbind(0))


def _tree_set(dst: Any, i: int, src: Any) -> None:
    """dst[...][i] = src[...] for every leaf (fills one layer of a stack)."""
    if isinstance(dst, dict):
        for k in dst:
            _tree_set(dst[k], i, src[k])
    else:
        dst[i] = src


def stack_layers(n: int, make: Callable[[], Params]) -> Params:
    """``n`` layers from ``make()``, stacked on a new leading axis.

    Each layer is drawn on its own and written into the stacked tensors, so
    a float32 draw never holds more than one layer's tensor at a time.
    """
    first = make()
    stacked = tree_map(lambda a: a.new_empty((n, *a.shape)), first)
    _tree_set(stacked, 0, first)
    for i in range(1, n):
        _tree_set(stacked, i, make())
    return stacked
