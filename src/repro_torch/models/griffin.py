"""Griffin / RecurrentGemma (arXiv:2402.19427) — RG-LRU + local-attention hybrid.

Pattern (recurrent, recurrent, local attention) repeated, each layer a
temporal-mixing residual followed by a GeGLU MLP residual.  The param tree
is the reference's: ``groups`` holds each pattern position's params stacked
over the whole groups (``t{i}`` temporal, ``m{i}`` MLP), ``tail`` a list of
the remaining layers.  Prefill runs the RG-LRU scan through the K5 kernel
(``ops.rglru``, from a carried ``h0``) and the local attention through K1
with ``window = cfg.window`` (MQA, hd 256 at full width).  Decode keeps an
O(1) state per recurrent layer and an O(window) ring-buffer KV cache per
attention layer; its attention masks by each slot's position
(``slot_pos``), plain torch, as the reference computes it outside any
Pallas kernel.  The reference's sharding hints (``constrain``) have no
counterpart on one card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..kernels import ops as kops
from .attention import chunked_attention
from .common import (
    Params,
    activation,
    apply_norm,
    causal_conv1d,
    apply_rope,
    dense_init,
    embed_init,
    layer,
    norm_params,
    softcap,
    stack_layers,
    unstack_layers,
)

__all__ = ["GriffinConfig", "init_params", "forward_hidden", "decode_step",
           "cache_spec", "init_cache", "rglru", "rglru_reference", "logits_fn",
           "embed_tokens", "layer_params", "rec_forward", "attn_forward",
           "mlp_forward"]

NEG_INF = -2.0e38
_C = 8.0  # RG-LRU decay sharpness constant


@dataclass(frozen=True)
class GriffinConfig:
    name: str
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    head_dim: int
    d_ff: int
    lru_width: int = 0            # 0 -> d_model
    n_lru_heads: int = 16         # block-diagonal gate heads
    window: int = 2048
    pattern: tuple[str, ...] = ("rec", "rec", "attn")
    d_conv: int = 4
    act: str = "gelu"
    norm: str = "rms1"            # gemma-style (1+scale) RMSNorm
    rope_theta: float = 10_000.0
    final_softcap: float = 30.0
    tie_embeddings: bool = True
    embed_scale: bool = True

    @property
    def w(self) -> int:
        return self.lru_width or self.d_model

    def layer_kinds(self) -> list[str]:
        return [self.pattern[i % len(self.pattern)] for i in range(self.n_layers)]

    def tail_kinds(self) -> list[str]:
        glen = len(self.pattern)
        return self.layer_kinds()[(self.n_layers // glen) * glen:]

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def n_rec(self) -> int:
        return sum(k == "rec" for k in self.layer_kinds())

    @property
    def n_attn(self) -> int:
        return self.n_layers - self.n_rec

    def params_per_layer(self, kind: str) -> int:
        d, w = self.d_model, self.w
        mlp = 3 * d * self.d_ff
        if kind == "rec":
            gates = 2 * self.n_lru_heads * (w // self.n_lru_heads) ** 2
            return 2 * d * w + self.d_conv * w + gates + 2 * w + w * d + mlp
        attn = d * self.n_heads * self.head_dim + 2 * d * self.head_dim + \
            self.n_heads * self.head_dim * d
        return attn + mlp

    def num_params(self) -> int:
        emb = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        return emb + sum(self.params_per_layer(k) for k in self.layer_kinds())


# --------------------------------------------------------------------------- #
# params
# --------------------------------------------------------------------------- #
def _rec_params(cfg: GriffinConfig, gen, device, dtype) -> Params:
    d, w, nb = cfg.d_model, cfg.w, cfg.n_lru_heads
    bd = w // nb
    return {
        "ln": norm_params(d, cfg.norm, device, dtype),
        "wx": dense_init(gen, (d, w), device, dtype),
        "wy": dense_init(gen, (d, w), device, dtype),
        "conv_w": dense_init(gen, (cfg.d_conv, w), device, dtype, scale=0.5),
        "conv_b": torch.zeros((w,), dtype=dtype, device=device),
        "gate_a": dense_init(gen, (nb, bd, bd), device, dtype),
        "gate_x": dense_init(gen, (nb, bd, bd), device, dtype),
        "lam": torch.full((w,), 0.7, dtype=torch.float32, device=device),
        "wo": dense_init(gen, (w, d), device, dtype),
    }


def _attn_params(cfg: GriffinConfig, gen, device, dtype) -> Params:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {
        "ln": norm_params(d, cfg.norm, device, dtype),
        "wq": dense_init(gen, (d, h, hd), device, dtype),
        "wk": dense_init(gen, (d, 1, hd), device, dtype),
        "wv": dense_init(gen, (d, 1, hd), device, dtype),
        "wo": dense_init(gen, (h, hd, d), device, dtype),
    }


def _mlp_params(cfg: GriffinConfig, gen, device, dtype) -> Params:
    d = cfg.d_model
    return {
        "ln": norm_params(d, cfg.norm, device, dtype),
        "wi": dense_init(gen, (d, cfg.d_ff), device, dtype),
        "wg": dense_init(gen, (d, cfg.d_ff), device, dtype),
        "wo": dense_init(gen, (cfg.d_ff, d), device, dtype),
    }


def _temporal_params(cfg, kind, gen, device, dtype) -> Params:
    return (_rec_params if kind == "rec" else _attn_params)(cfg, gen, device, dtype)


def init_params(cfg: GriffinConfig, generator: torch.Generator,
                device: str | torch.device = "cuda",
                dtype=torch.float32) -> Params:
    """Random weights made directly on ``device`` from ``generator``, in the
    reference's tree (``groups`` stacked per pattern position, ``tail`` a
    list) and distributions (``lam`` float32 as in the reference); the
    numbers differ, since the generators do.  One group is drawn at a time."""
    dev = resolve_device(device)

    def group() -> Params:
        grp = {}
        for i, kind in enumerate(cfg.pattern):
            grp[f"t{i}"] = _temporal_params(cfg, kind, generator, dev, dtype)
            grp[f"m{i}"] = _mlp_params(cfg, generator, dev, dtype)
        return grp

    params: dict[str, Any] = {
        "embed": embed_init(generator, (cfg.vocab, cfg.d_model), dev, dtype),
        "final_norm": norm_params(cfg.d_model, cfg.norm, dev, dtype),
        "groups": stack_layers(cfg.n_groups, group) if cfg.n_groups else {},
        "tail": [{"t": _temporal_params(cfg, k, generator, dev, dtype),
                  "m": _mlp_params(cfg, generator, dev, dtype)}
                 for k in cfg.tail_kinds()],
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(generator, (cfg.d_model, cfg.vocab), dev, dtype)
    return params


def layer_params(params: Params, cfg: GriffinConfig, li: int):
    """(kind, temporal params, MLP params) of global layer ``li``: views."""
    glen = len(cfg.pattern)
    if li < cfg.n_groups * glen:
        g, i = divmod(li, glen)
        return (cfg.pattern[i], layer(params["groups"][f"t{i}"], g),
                layer(params["groups"][f"m{i}"], g))
    tl = params["tail"][li - cfg.n_groups * glen]
    return cfg.tail_kinds()[li - cfg.n_groups * glen], tl["t"], tl["m"]


# --------------------------------------------------------------------------- #
# RG-LRU
# --------------------------------------------------------------------------- #
def _lru_gates(u: torch.Tensor, p: Params, cfg: GriffinConfig):
    """u: [B,S,w] -> (a, gated_input) both [B,S,w] float32."""
    b, s, w = u.shape
    nb = cfg.n_lru_heads
    uh = u.reshape(b, s, nb, w // nb)
    r = torch.sigmoid(torch.einsum(
        "bsnd,nde->bsne", uh, p["gate_a"].to(u.dtype)).float()).reshape(b, s, w)
    i = torch.sigmoid(torch.einsum(
        "bsnd,nde->bsne", uh, p["gate_x"].to(u.dtype)).float()).reshape(b, s, w)
    log_a = -_C * F.softplus(p["lam"].float())[None, None, :] * r
    a = torch.exp(log_a)
    x_in = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * \
        (i * u.float())
    return a, x_in


def rglru_reference(a: torch.Tensor, x: torch.Tensor,
                    h0: torch.Tensor | None = None) -> torch.Tensor:
    """Sequential oracle: h_t = a_t h_{t-1} + x_t. a,x: [B,S,w] float32."""
    b, s, w = x.shape
    h = torch.zeros((b, w), dtype=torch.float32, device=x.device) if h0 is None else h0
    hs = []
    for t in range(s):
        h = a[:, t] * h + x[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def rglru(a: torch.Tensor, x: torch.Tensor,
          h0: torch.Tensor | None = None) -> torch.Tensor:
    """The recurrence through K5, from the carried state ``h0`` [B,w]."""
    return kops.rglru(a, x, h0)


# --------------------------------------------------------------------------- #
# temporal blocks
# --------------------------------------------------------------------------- #
def rec_forward(x, p, cfg: GriffinConfig, *, state=None, conv_prev=None,
                return_state: bool = False):
    """Recurrent temporal block. x: [B,S,d]; with ``return_state``:
    ``(x, (h_last [B,w] float32, last K-1 conv inputs [B,K-1,w]))``."""
    h = apply_norm(x, p["ln"], cfg.norm)
    branch_y = activation(h @ p["wy"].to(h.dtype), cfg.act)
    u = h @ p["wx"].to(h.dtype)
    u_conv = causal_conv1d(u, p["conv_w"].to(h.dtype), p["conv_b"].to(h.dtype),
                           conv_prev)
    a, xin = _lru_gates(u_conv, p, cfg)
    hs = rglru(a, xin, h0=state)                              # [B,S,w] float32
    y = (hs.to(h.dtype) * branch_y) @ p["wo"].to(h.dtype)
    if return_state:
        return x + y, (hs[:, -1], u[:, -(cfg.d_conv - 1):, :])
    return x + y


def _project_qkv(h, p, cfg: GriffinConfig, pos: torch.Tensor):
    """q [B,S,H,hd], k/v [B,S,1,hd] of normed x at positions ``pos`` [S];
    RoPE on q and k."""
    b, s, d = h.shape
    hd = cfg.head_dim
    q = (h @ p["wq"].to(h.dtype).reshape(d, cfg.n_heads * hd)).view(
        b, s, cfg.n_heads, hd)
    k = (h @ p["wk"].to(h.dtype).reshape(d, hd)).view(b, s, 1, hd)
    v = (h @ p["wv"].to(h.dtype).reshape(d, hd)).view(b, s, 1, hd)
    return (apply_rope(q, pos, cfg.rope_theta), apply_rope(k, pos, cfg.rope_theta),
            v)


def attn_forward(x, p, cfg: GriffinConfig, *, q_offset: int = 0,
                 return_kv: bool = False):
    """Local (sliding-window) MQA attention block through K1; with
    ``return_kv``: ``(x, (k, v))``, the post-RoPE keys and values."""
    b, s, _ = x.shape
    h = apply_norm(x, p["ln"], cfg.norm)
    pos = q_offset + torch.arange(s, device=x.device)
    q, k, v = _project_qkv(h, p, cfg, pos)
    o = chunked_attention(q, k, v, causal=True, window=cfg.window)
    hd_all = cfg.n_heads * cfg.head_dim
    y = o.reshape(b, s, hd_all) @ p["wo"].to(o.dtype).reshape(hd_all, -1)
    if return_kv:
        return x + y, (k, v)
    return x + y


def mlp_forward(x, p, cfg: GriffinConfig):
    h = apply_norm(x, p["ln"], cfg.norm)
    y = activation(h @ p["wi"].to(h.dtype), cfg.act) * (h @ p["wg"].to(h.dtype))
    return x + y @ p["wo"].to(y.dtype)


def layer_forward(x, kind: str, tm: Params, mp: Params, cfg: GriffinConfig):
    """One layer (temporal block, then MLP) without state."""
    if kind == "rec":
        x = rec_forward(x, tm, cfg)
    else:
        x = attn_forward(x, tm, cfg)
    return mlp_forward(x, mp, cfg)


# --------------------------------------------------------------------------- #
# full forward (prefill compute)
# --------------------------------------------------------------------------- #
def embed_tokens(params: Params, cfg: GriffinConfig, tokens: torch.Tensor,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Token ids [B,S] -> [B,S,d] in ``compute_dtype`` (scaled by sqrt(d)
    where the config says so); ``F.embedding``, whose gradient sums each
    row's tokens in a fixed order."""
    x = F.embedding(tokens, params["embed"]).to(compute_dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=compute_dtype)
    return x


def _group_forward(x, gp: Params, cfg: GriffinConfig):
    """One group of the pattern: its layers in order, params ``t{i}`` and
    ``m{i}`` of one group."""
    for i, kind in enumerate(cfg.pattern):
        x = layer_forward(x, kind, gp[f"t{i}"], gp[f"m{i}"], cfg)
    return x


def forward_hidden(params: Params, cfg: GriffinConfig,
                   x: torch.Tensor) -> torch.Tensor:
    """Run all layers on embedded inputs x: [B,S,d] -> [B,S,d] (pre-head).

    Under grad mode each group of the pattern is checkpointed
    (``torch.utils.checkpoint``, non-reentrant) and the tail layers are
    not, as the reference's ``jax.checkpoint(nothing_saveable)`` over its
    scanned groups: a group's K5 and K1 forwards run twice, a tail layer's
    once.  The groups' stacked leaves are unbound once.
    """
    remat = torch.is_grad_enabled()
    for gp in (unstack_layers(params["groups"]) if cfg.n_groups else []):
        if remat:
            x = checkpoint(_group_forward, x, gp, cfg, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _group_forward(x, gp, cfg)
    for layer_p, kind in zip(params["tail"], cfg.tail_kinds()):
        x = layer_forward(x, kind, layer_p["t"], layer_p["m"], cfg)
    return apply_norm(x, params["final_norm"], cfg.norm)


def logits_fn(params: Params, cfg: GriffinConfig, h: torch.Tensor) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return softcap((h @ w.to(h.dtype)).float(), cfg.final_softcap)


# --------------------------------------------------------------------------- #
# decode with ring-buffer attention cache + O(1) recurrent state
# --------------------------------------------------------------------------- #
def cache_spec(cfg: GriffinConfig, batch: int, max_len: int,
               dtype=torch.bfloat16) -> Any:
    """The cache's shapes and dtypes as ``meta`` tensors: per recurrent
    layer the LRU state and conv tail, per attention layer a ring of
    ``min(window, max_len)`` k/v slots and each slot's position."""
    w = min(cfg.window, max_len)

    def meta(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")

    return {
        "lru": meta((cfg.n_rec, batch, cfg.w), torch.float32),
        "conv": meta((cfg.n_rec, batch, cfg.d_conv - 1, cfg.w), dtype),
        "k": meta((cfg.n_attn, batch, w, 1, cfg.head_dim), dtype),
        "v": meta((cfg.n_attn, batch, w, 1, cfg.head_dim), dtype),
        "slot_pos": meta((cfg.n_attn, w), torch.int32),
    }


def init_cache(cfg: GriffinConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device: str | torch.device = "cuda") -> Any:
    cache = {name: torch.zeros(t.shape, dtype=t.dtype, device=device)
             for name, t in cache_spec(cfg, batch, max_len, dtype).items()}
    cache["slot_pos"].fill_(-1)
    return cache


def _ring_attn_decode(x, p, cfg: GriffinConfig, kc, vc, slot_pos, pos: int,
                      positions):
    """x: [B,1,d]; ring cache kc/vc: [B,W,1,hd] and slot_pos [W], written at
    slot pos % W in place."""
    b = x.shape[0]
    w = kc.shape[1]
    h = apply_norm(x, p["ln"], cfg.norm)
    q, kn, vn = _project_qkv(h, p, cfg, positions)
    slot = pos % w
    kc[:, slot] = kn[:, 0].to(kc.dtype)
    vc[:, slot] = vn[:, 0].to(vc.dtype)
    slot_pos[slot] = pos
    scores = torch.einsum("bhk,bwgk->bhw", q[:, 0].float() * cfg.head_dim ** -0.5,
                          kc.float())
    valid = (slot_pos >= 0) & (slot_pos <= pos) & (slot_pos > pos - cfg.window)
    scores = scores.masked_fill(~valid[None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhw,bwgk->bhk", probs, vc.float())
    hd_all = cfg.n_heads * cfg.head_dim
    y = o.to(h.dtype).reshape(b, hd_all) @ p["wo"].to(h.dtype).reshape(hd_all, -1)
    return x + y[:, None]


def _rec_decode(x, p, cfg: GriffinConfig, lru, conv):
    """x: [B,1,d]; ``lru`` [B,w] and ``conv`` [B,K-1,w] updated in place."""
    h = apply_norm(x, p["ln"], cfg.norm)
    branch_y = activation(h @ p["wy"].to(h.dtype), cfg.act)
    u = h @ p["wx"].to(h.dtype)                               # [B,1,w]
    full = torch.cat([conv.to(h.dtype), u], dim=1)            # [B,K,w]
    u_conv = (full * p["conv_w"].to(h.dtype)[None]).sum(dim=1, keepdim=True) \
        + p["conv_b"].to(h.dtype)[None, None]
    a, xin = _lru_gates(u_conv, p, cfg)                       # [B,1,w]
    hnew = a[:, 0] * lru + xin[:, 0]
    y = (hnew[:, None].to(h.dtype) * branch_y) @ p["wo"].to(h.dtype)
    lru.copy_(hnew)
    conv.copy_(full[:, 1:])
    return x + y


def decode_step(params: Params, cfg: GriffinConfig, cache: Any,
                tokens: torch.Tensor, pos):
    """One decode step. tokens: [B] int; pos: host int, shared by the batch.

    Returns (logits [B,V] float32, cache): the cache is the one given,
    updated in place (the reference returns new arrays).  Plain torch: no
    kernel runs here.
    """
    x = embed_tokens(params, cfg, tokens[:, None])
    pos = int(pos)
    positions = torch.full((1,), pos, device=x.device)
    ri = ai = 0
    for li in range(cfg.n_layers):
        kind, tm, mp = layer_params(params, cfg, li)
        if kind == "rec":
            x = _rec_decode(x, tm, cfg, cache["lru"][ri], cache["conv"][ri])
            ri += 1
        else:
            x = _ring_attn_decode(x, tm, cfg, cache["k"][ai], cache["v"][ai],
                                  cache["slot_pos"][ai], pos, positions)
            ai += 1
        x = mlp_forward(x, mp, cfg)
    x = apply_norm(x, params["final_norm"], cfg.norm)
    return logits_fn(params, cfg, x)[:, 0], cache
