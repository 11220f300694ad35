"""Decoder-only transformer, dense GQA (the port's first family slice).

One config dataclass + plain functions on tensors, in the reference's
layouts: ``wq`` [d,H,hd], ``wk``/``wv`` [d,KV,hd], ``wo`` [H,hd,d], FFN
``wi``/``wg`` [d,ff] and ``wo`` [ff,d], blocks stacked on a leading L axis.
Layers run as a Python loop over that axis.  Attention is the K1 flash
kernel (``models/attention.py``); the projections, the FFN and the LM head
are plain matrix products.

The config keeps every field of the reference so that graphs and parameter
counts agree; MoE, MLA, the parallel block, post-norm and modality prefixes
raise ``NotImplementedError`` until their slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from .attention import chunked_attention
from .common import (
    Params,
    activation,
    apply_norm,
    apply_rope,
    dense_init,
    embed_init,
    layer,
    norm_params,
    softcap,
    stack_layers,
)

# --------------------------------------------------------------------------- #
# configs
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                   # per-expert FFN hidden size
    num_shared: int = 0             # always-on shared experts (DeepSeek)
    first_dense_layers: int = 0     # leading dense layers (DeepSeek-V2)
    dense_d_ff: int = 0             # FFN width of those dense layers
    capacity_factor: float = 1.25
    router_scale: bool = True       # normalize top-k gate weights to sum 1


@dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class TransformerConfig:
    name: str
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv: int
    d_ff: int
    head_dim: int = 0                  # 0 -> d_model // n_heads
    act: str = "silu"
    norm: str = "rms"                  # rms | rms1 | ln
    glu: bool = True                   # gated FFN (SwiGLU/GeGLU) vs plain MLP
    parallel_block: bool = False
    qk_norm: bool = False
    post_norm: bool = False            # gemma2 sandwich norms
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    rope_theta: float = 10_000.0
    rope_frac: float = 1.0             # partial rotary (stablelm-2: 0.25)
    attn_scale: float | None = None    # override 1/sqrt(head_dim)
    # per-layer window schedule, cycled: 0 = global, w>0 = sliding window
    window_pattern: tuple[int, ...] = (0,)
    tie_embeddings: bool = False
    embed_inputs: bool = False         # inputs are embeddings, not token ids
    embed_scale: bool = False          # multiply embeddings by sqrt(d) (gemma)
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    # vlm: number of prepended modality tokens in input_specs (0 = none)
    prefix_tokens: int = 0
    prefix_dim: int = 0                # raw dim of modality embeddings

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def windows(self) -> np.ndarray:
        pat = self.window_pattern or (0,)
        return np.array([pat[i % len(pat)] for i in range(self.n_layers)],
                        dtype=np.int32)

    @property
    def params_per_block(self) -> int:
        d, hd = self.d_model, self.hd
        if self.mla is not None:
            m = self.mla
            qk = m.nope_head_dim + m.rope_head_dim
            attn = (d * self.n_heads * qk                 # W_q
                    + d * (m.kv_lora + m.rope_head_dim)   # W_dkv + W_kr
                    + m.kv_lora * self.n_heads * (m.nope_head_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d)    # W_o
        else:
            attn = d * self.n_heads * hd + 2 * d * self.n_kv * hd \
                + self.n_heads * hd * d
        if self.moe is not None:
            f = (3 if self.glu else 2) * d * self.moe.d_expert
            ffn = self.moe.num_experts * f + self.moe.num_shared * f \
                + d * self.moe.num_experts  # router
        else:
            ffn = (3 if self.glu else 2) * d * self.d_ff
        return attn + ffn

    @property
    def active_params_per_block(self) -> int:
        if self.moe is None:
            return self.params_per_block
        d = self.d_model
        f = (3 if self.glu else 2) * d * self.moe.d_expert
        total = self.params_per_block
        return total - self.moe.num_experts * f + self.moe.top_k * f

    def num_params(self) -> int:
        emb = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        return emb + self.n_layers * self.params_per_block

    def num_active_params(self) -> int:
        emb = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        return emb + self.n_layers * self.active_params_per_block


def check_supported(cfg: TransformerConfig) -> None:
    """Raise for the features whose slice has not been ported yet."""
    missing = [name for name, on in (
        ("MoE", cfg.moe is not None), ("MLA", cfg.mla is not None),
        ("parallel block", cfg.parallel_block), ("post-norm", cfg.post_norm),
        ("modality prefix", bool(cfg.prefix_tokens)),
        ("embedding inputs", cfg.embed_inputs),
    ) if on]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet")


# --------------------------------------------------------------------------- #
# parameter trees
# --------------------------------------------------------------------------- #
def _block_params(cfg: TransformerConfig, gen: torch.Generator, device,
                  dtype) -> Params:
    d, hd, h, kv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv
    p: dict[str, Any] = {
        "ln1": norm_params(d, cfg.norm, device, dtype),
        "ln2": norm_params(d, cfg.norm, device, dtype),
        "attn": {
            "wq": dense_init(gen, (d, h, hd), device, dtype),
            "wk": dense_init(gen, (d, kv, hd), device, dtype),
            "wv": dense_init(gen, (d, kv, hd), device, dtype),
            "wo": dense_init(gen, (h, hd, d), device, dtype),
        },
    }
    if cfg.qk_norm:
        p["attn"]["q_norm"] = norm_params(hd, "rms", device, dtype)
        p["attn"]["k_norm"] = norm_params(hd, "rms", device, dtype)
    mlp = {"wi": dense_init(gen, (d, cfg.d_ff), device, dtype),
           "wo": dense_init(gen, (cfg.d_ff, d), device, dtype)}
    if cfg.glu:
        mlp["wg"] = dense_init(gen, (d, cfg.d_ff), device, dtype)
    p["mlp"] = mlp
    return p


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device: str | torch.device = "cuda",
                dtype=torch.float32) -> Params:
    """Random weights made directly on ``device`` from ``generator``.

    The distributions are the reference's (``dense_init``: normal with std
    1/sqrt(shape[-2]) per block tensor; ``embed_init``: std 0.02); the
    numbers differ, since the generators do.  Layers are drawn one at a
    time into the stacked tensors (``stack_layers``).
    """
    check_supported(cfg)
    dev = resolve_device(device)
    params: dict[str, Any] = {
        "embed": embed_init(generator, (cfg.vocab, cfg.d_model), dev, dtype),
        "final_norm": norm_params(cfg.d_model, cfg.norm, dev, dtype),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(generator, (cfg.d_model, cfg.vocab), dev, dtype)
    params["blocks"] = stack_layers(
        cfg.n_layers, lambda: _block_params(cfg, generator, dev, dtype))
    return params


# --------------------------------------------------------------------------- #
# FFN + attention
# --------------------------------------------------------------------------- #
def dense_ffn(x: torch.Tensor, p: Params, cfg: TransformerConfig) -> torch.Tensor:
    hg = x @ p["wi"].to(x.dtype)
    if cfg.glu:
        h = activation(hg, cfg.act) * (x @ p["wg"].to(x.dtype))
    else:
        h = activation(hg, cfg.act)
    return h @ p["wo"].to(h.dtype)


def project_qkv(x: torch.Tensor, p: Params, cfg: TransformerConfig,
                pos: torch.Tensor):
    """q [B,S,H,hd], k/v [B,S,KV,hd] of x [B,S,d] at positions ``pos`` [S]:
    projections, optional qk-norm, RoPE on q and k."""
    b, s, d = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    q = (x @ p["wq"].to(x.dtype).reshape(d, h * hd)).view(b, s, h, hd)
    k = (x @ p["wk"].to(x.dtype).reshape(d, kv * hd)).view(b, s, kv, hd)
    v = (x @ p["wv"].to(x.dtype).reshape(d, kv * hd)).view(b, s, kv, hd)
    if cfg.qk_norm:
        q = apply_norm(q, p["q_norm"], "rms")
        k = apply_norm(k, p["k_norm"], "rms")
    rd = int(cfg.hd * cfg.rope_frac) if cfg.rope_frac < 1.0 else None
    q = apply_rope(q, pos, cfg.rope_theta, rope_dim=rd)
    k = apply_rope(k, pos, cfg.rope_theta, rope_dim=rd)
    return q, k, v


def attn_forward(x: torch.Tensor, p: Params, cfg: TransformerConfig, *,
                 window: int):
    """Full-sequence attention (prefill compute). x: [B,S,d].

    Returns ``(out [B,S,d], k, v)``: k and v are the post-RoPE keys and
    values it attended over, what prefill writes into the KV cache.
    """
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.hd
    q, k, v = project_qkv(x, p, cfg, torch.arange(s, device=x.device))
    o = chunked_attention(q, k, v, causal=True, window=window,
                          logit_cap=cfg.attn_softcap, scale=cfg.attn_scale)
    return o.reshape(b, s, h * hd) @ p["wo"].to(o.dtype).reshape(h * hd, d), k, v


# --------------------------------------------------------------------------- #
# block + full model forward (prefill)
# --------------------------------------------------------------------------- #
def block_forward(x: torch.Tensor, p: Params, cfg: TransformerConfig, *,
                  window: int, return_kv: bool = False):
    """One block. With ``return_kv``: ``(x, (k, v))``, k/v as attn_forward's."""
    check_supported(cfg)
    h = apply_norm(x, p["ln1"], cfg.norm)
    attn, k, v = attn_forward(h, p["attn"], cfg, window=window)
    x = x + attn
    h = apply_norm(x, p["ln2"], cfg.norm)
    x = x + dense_ffn(h, p["mlp"], cfg)
    return (x, (k, v)) if return_kv else x


def embed_tokens(params: Params, cfg: TransformerConfig, tokens: torch.Tensor,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Token ids [B,S] -> activations [B,S,d] in ``compute_dtype``.

    Activations are ``compute_dtype`` (bf16) whatever the parameter dtype;
    the boundary byte counts depend on that.
    """
    x = params["embed"][tokens].to(compute_dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=compute_dtype)
    return x


def forward_hidden(params: Params, cfg: TransformerConfig,
                   x: torch.Tensor) -> torch.Tensor:
    """Run all blocks on embedded inputs x: [B,S,d] -> [B,S,d] (pre-head)."""
    windows = cfg.windows()
    for i in range(cfg.n_layers):
        x = block_forward(x, layer(params["blocks"], i), cfg,
                          window=int(windows[i]))
    return apply_norm(x, params["final_norm"], cfg.norm)


def logits_fn(params: Params, cfg: TransformerConfig,
              h: torch.Tensor) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    logits = h @ w.to(h.dtype)
    return softcap(logits.float(), cfg.final_softcap)
