"""Mamba-2 (SSD, arXiv:2405.21060) — the attention-free SSM family.

One config dataclass + plain functions on tensors, in the reference's
layouts: ``in_proj`` [d, 2·d_inner + 2·G·N + H], ``conv_w`` [K, conv_dim],
``out_proj`` [d_inner, d], blocks stacked on a leading L axis.  Prefill runs
the chunked state-space duality through the K4 kernel (``ops.ssd``, with
``state_in`` and the final state for chunked prefill); decode is the O(1)
recurrent state update, plain torch, as the reference computes it outside
any Pallas kernel.  Layers run as a Python loop over the stacked axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..kernels import ops as kops
from ..kernels.ssd_chunk import _segsum
from .common import (
    Params,
    activation,
    apply_norm,
    causal_conv1d,
    dense_init,
    embed_init,
    layer,
    norm_params,
    stack_layers,
    unstack_layers,
)

__all__ = ["Mamba2Config", "init_params", "forward_hidden", "decode_step",
           "cache_spec", "init_cache", "ssd_chunked", "ssd_reference",
           "logits_fn", "embed_tokens", "block_forward"]


@dataclass(frozen=True)
class Mamba2Config:
    name: str
    vocab: int
    d_model: int
    n_layers: int
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64            # P
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 256
    act: str = "silu"
    norm: str = "rms"
    tie_embeddings: bool = True
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state

    @property
    def params_per_block(self) -> int:
        d, di = self.d_model, self.d_inner
        in_proj = d * (2 * di + 2 * self.n_groups * self.d_state + self.n_heads)
        return in_proj + self.d_conv * self.conv_dim + di * d + 2 * di + \
            2 * self.n_heads + d

    def num_params(self) -> int:
        emb = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        return emb + self.n_layers * self.params_per_block


# --------------------------------------------------------------------------- #
# params
# --------------------------------------------------------------------------- #
def _block_params(cfg: Mamba2Config, gen: torch.Generator, device,
                  dtype) -> Params:
    d, di, h = cfg.d_model, cfg.d_inner, cfg.n_heads
    proj_out = 2 * di + 2 * cfg.n_groups * cfg.d_state + h
    a = torch.linspace(1.0, float(h), h, device=device)
    return {
        "ln": norm_params(d, cfg.norm, device, dtype),
        "in_proj": dense_init(gen, (d, proj_out), device, dtype),
        "conv_w": dense_init(gen, (cfg.d_conv, cfg.conv_dim), device, dtype,
                             scale=0.5),
        "conv_b": torch.zeros((cfg.conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(a),                         # A = -exp(A_log) < 0
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=device),
        "D": torch.ones((h,), dtype=torch.float32, device=device),
        "out_norm": norm_params(di, cfg.norm, device, dtype),
        "out_proj": dense_init(gen, (di, d), device, dtype),
    }


def init_params(cfg: Mamba2Config, generator: torch.Generator,
                device: str | torch.device = "cuda",
                dtype=torch.float32) -> Params:
    """Random weights made directly on ``device`` from ``generator``.

    The reference's distributions (``dense_init``: normal with std
    1/sqrt(shape[-2]); ``embed_init``: std 0.02; ``A_log``, ``dt_bias``,
    ``D`` float32 as in the reference); the numbers differ, since the
    generators do.  Layers are drawn one at a time into the stacked tensors.
    """
    dev = resolve_device(device)
    params: dict[str, Any] = {
        "embed": embed_init(generator, (cfg.vocab, cfg.d_model), dev, dtype),
        "final_norm": norm_params(cfg.d_model, cfg.norm, dev, dtype),
        "blocks": stack_layers(
            cfg.n_layers, lambda: _block_params(cfg, generator, dev, dtype)),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(generator, (cfg.d_model, cfg.vocab), dev, dtype)
    return params


# --------------------------------------------------------------------------- #
# SSD core
# --------------------------------------------------------------------------- #
def ssd_reference(x, dt, A, Bm, Cm):
    """O(S²) oracle: y[i] = Σ_{j<=i} C_i·B_j · exp(Σ_{j<k<=i} dtA[k]) · dt_j x[j].

    x: [B,S,H,P], dt: [B,S,H], A: [H], Bm/Cm: [B,S,G,N] (G divides H).
    """
    h = x.shape[2]
    rep = h // Bm.shape[2]
    Bh = Bm.repeat_interleave(rep, dim=2).float()           # [B,S,H,N]
    Ch = Cm.repeat_interleave(rep, dim=2).float()
    dtA = dt * A[None, None, :]                              # [B,S,H]
    L = torch.exp(_segsum(dtA.transpose(1, 2)))              # [B,H,S,S]
    scores = torch.einsum("bihn,bjhn->bhij", Ch, Bh) * L
    xbar = (x * dt[..., None]).float()
    return torch.einsum("bhij,bjhp->bihp", scores, xbar).to(x.dtype)


def ssd_chunked(x, dt, A, Bm, Cm, *, chunk: int, state_in=None,
                return_state: bool = False):
    """Chunked SSD (K4): the signature of :func:`ssd_reference` plus an
    optional initial state [B,H,N,P] and the final state's return."""
    return kops.ssd(x, dt, A, Bm, Cm, chunk=chunk, state_in=state_in,
                    return_state=return_state)


# --------------------------------------------------------------------------- #
# block forward
# --------------------------------------------------------------------------- #
def _split_proj(z: torch.Tensor, cfg: Mamba2Config):
    di, gn = cfg.d_inner, cfg.n_groups * cfg.d_state
    return (z[..., :di], z[..., di:2 * di], z[..., 2 * di:2 * di + gn],
            z[..., 2 * di + gn:2 * di + 2 * gn], z[..., 2 * di + 2 * gn:])


def block_forward(x, p, cfg: Mamba2Config, *, state_in=None, conv_in=None,
                  return_state: bool = False):
    """x: [B,S,d]. Optional carried SSM/conv state for chunked prefill;
    with ``return_state``: ``(x, (ssm [B,H,N,P] float32, conv [B,K-1,C]))``,
    conv being the last K-1 conv inputs."""
    h = apply_norm(x, p["ln"], cfg.norm)
    z = h @ p["in_proj"].to(h.dtype)
    zg, xh, Bm, Cm, dt = _split_proj(z, cfg)
    conv_inp = torch.cat([xh, Bm, Cm], dim=-1)
    conv_out = activation(
        causal_conv1d(conv_inp, p["conv_w"].to(h.dtype),
                      p["conv_b"].to(h.dtype), conv_in), cfg.act)
    di, gn = cfg.d_inner, cfg.n_groups * cfg.d_state
    b, s, _ = x.shape
    # views of the conv output: K4 reads them through their strides
    xheads = conv_out[..., :di].unflatten(-1, (cfg.n_heads, cfg.head_dim))
    Bg = conv_out[..., di:di + gn].unflatten(-1, (cfg.n_groups, cfg.d_state))
    Cg = conv_out[..., di + gn:].unflatten(-1, (cfg.n_groups, cfg.d_state))
    dtv = F.softplus(dt.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"].float())
    out = ssd_chunked(xheads, dtv, A, Bg, Cg, chunk=cfg.chunk,
                      state_in=state_in, return_state=return_state)
    y, state = out if return_state else (out, None)
    y = y + xheads * p["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(b, s, di)
    y = apply_norm(y * activation(zg, cfg.act), p["out_norm"], cfg.norm)
    y = y @ p["out_proj"].to(y.dtype)
    if return_state:
        return x + y, (state, conv_inp[:, -(cfg.d_conv - 1):, :])
    return x + y


def embed_tokens(params: Params, cfg: Mamba2Config, tokens: torch.Tensor,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Token ids [B,S] -> [B,S,d] in ``compute_dtype``; ``F.embedding``,
    whose gradient sums each row's tokens in a fixed order."""
    return F.embedding(tokens, params["embed"]).to(compute_dtype)


def forward_hidden(params: Params, cfg: Mamba2Config,
                   x: torch.Tensor) -> torch.Tensor:
    """Run all blocks on embedded inputs x: [B,S,d] -> [B,S,d] (pre-head).

    Under grad mode each block is checkpointed (``torch.utils.checkpoint``,
    non-reentrant): its activations are recomputed in the backward, as the
    reference's ``jax.checkpoint(nothing_saveable)`` over its scanned
    blocks, so K4's forward runs twice a block and its backward once.  The
    stacked leaves are unbound once.
    """
    remat = torch.is_grad_enabled()
    for lp in unstack_layers(params["blocks"]):
        if remat:
            x = checkpoint(block_forward, x, lp, cfg, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = block_forward(x, lp, cfg)
    return apply_norm(x, params["final_norm"], cfg.norm)


def logits_fn(params: Params, cfg: Mamba2Config, h: torch.Tensor) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return (h @ w.to(h.dtype)).float()


# --------------------------------------------------------------------------- #
# decode: O(1) state recurrence
# --------------------------------------------------------------------------- #
def cache_spec(cfg: Mamba2Config, batch: int, max_len: int,
               dtype=torch.bfloat16) -> Any:
    """The state's shapes and dtypes as ``meta`` tensors; the SSM state is
    independent of ``max_len``."""
    del max_len
    return {
        "ssm": torch.empty((cfg.n_layers, batch, cfg.n_heads, cfg.d_state,
                            cfg.head_dim), dtype=torch.float32, device="meta"),
        "conv": torch.empty((cfg.n_layers, batch, cfg.d_conv - 1, cfg.conv_dim),
                            dtype=dtype, device="meta"),
    }


def init_cache(cfg: Mamba2Config, batch: int, max_len: int,
               dtype=torch.bfloat16, device: str | torch.device = "cuda") -> Any:
    return {name: torch.zeros(t.shape, dtype=t.dtype, device=device)
            for name, t in cache_spec(cfg, batch, max_len, dtype).items()}


def decode_step(params: Params, cfg: Mamba2Config, cache: Any,
                tokens: torch.Tensor, pos):
    """tokens: [B] int; ``pos`` unused (the state carries the position).

    Returns (logits [B,V] float32, cache): the cache is the one given, its
    layers' ``ssm`` and ``conv`` overwritten in place (the reference returns
    new arrays).  Plain torch: no kernel runs here.
    """
    del pos
    x = embed_tokens(params, cfg, tokens[:, None])            # [B,1,d]
    di, gn = cfg.d_inner, cfg.n_groups * cfg.d_state
    rep = cfg.n_heads // cfg.n_groups
    b = x.shape[0]
    for i in range(cfg.n_layers):
        lp = layer(params["blocks"], i)
        ssm, conv = cache["ssm"][i], cache["conv"][i]
        hin = apply_norm(x, lp["ln"], cfg.norm)
        z = hin @ lp["in_proj"].to(hin.dtype)
        zg, xh, Bm, Cm, dt = _split_proj(z, cfg)
        conv_inp = torch.cat([xh, Bm, Cm], dim=-1)            # [B,1,C]
        full = torch.cat([conv.to(x.dtype), conv_inp], dim=1)  # [B,K,C]
        conv_out = activation(
            (full * lp["conv_w"].to(x.dtype)[None]).sum(dim=1)
            + lp["conv_b"].to(x.dtype)[None], cfg.act)        # [B,C]
        xh1 = conv_out[:, :di].reshape(b, cfg.n_heads, cfg.head_dim)
        Bh = conv_out[:, di:di + gn].reshape(b, cfg.n_groups, cfg.d_state) \
            .repeat_interleave(rep, dim=1).float()            # [B,H,N]
        Ch = conv_out[:, di + gn:].reshape(b, cfg.n_groups, cfg.d_state) \
            .repeat_interleave(rep, dim=1).float()
        dtv = F.softplus(dt[:, 0].float() + lp["dt_bias"][None])
        A = -torch.exp(lp["A_log"].float())                   # [H]
        decay = torch.exp(dtv * A[None])[..., None, None]     # [B,H,1,1]
        xbar = (xh1 * dtv[..., None]).float()                 # [B,H,P]
        new_ssm = ssm * decay + Bh[..., :, None] * xbar[..., None, :]
        y = torch.einsum("bhn,bhnp->bhp", Ch, new_ssm)
        y = y.to(x.dtype) + xh1 * lp["D"][None, :, None].to(x.dtype)
        y = y.reshape(b, 1, di)
        y = apply_norm(y * activation(zg, cfg.act), lp["out_norm"], cfg.norm)
        x = x + y @ lp["out_proj"].to(y.dtype)
        ssm.copy_(new_ssm)
        conv.copy_(full[:, 1:, :])
    x = apply_norm(x, params["final_norm"], cfg.norm)
    return logits_fn(params, cfg, x)[:, 0], cache
