"""Serving paths for the dense transformer: prefill + single-token decode.

The KV cache is ``{"blocks": {"k", "v"}}``, each [L, B, S, KV, hd] with a
leading layer axis, as in the reference; layer i reads and writes the views
``cache["blocks"]["k"][i]``.  Decode writes the new entry into those views
in place, so :func:`decode_step` returns the very cache tensors it was
given (the reference returns new arrays).  Decode attention is the K3
kernel (``models/attention.py``), prefill attention K1.

MLA's absorbed decode and MoE lead blocks wait for their slice:
``check_supported`` raises ``NotImplementedError`` for them.
"""

from __future__ import annotations

from typing import Any

import torch

from .attention import decode_attention, update_kv_cache
from .common import Params, apply_norm, layer
from .transformer import (
    TransformerConfig,
    block_forward,
    check_supported,
    dense_ffn,
    embed_tokens,
    logits_fn,
    project_qkv,
)

__all__ = ["cache_spec", "init_cache", "prefill", "decode_step"]


# --------------------------------------------------------------------------- #
# cache specs
# --------------------------------------------------------------------------- #
def cache_spec(cfg: TransformerConfig, batch: int, max_len: int,
               dtype=torch.bfloat16) -> Any:
    """The KV cache's shapes and dtype as tensors on the ``meta`` device
    (the reference's ``ShapeDtypeStruct`` tree); leading axis = layer."""
    check_supported(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.hd)
    return {"blocks": {name: torch.empty(shape, dtype=dtype, device="meta")
                       for name in ("k", "v")}}


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device: str | torch.device = "cuda") -> Any:
    spec = cache_spec(cfg, batch, max_len, dtype)
    return {"blocks": {name: torch.zeros(t.shape, dtype=t.dtype, device=device)
                       for name, t in spec["blocks"].items()}}


# --------------------------------------------------------------------------- #
# prefill: full forward that also fills the cache
# --------------------------------------------------------------------------- #
def prefill(params: Params, cfg: TransformerConfig, tokens: torch.Tensor, *,
            cache_dtype=torch.bfloat16, max_len: int | None = None):
    """Returns (last-position logits [B, V] float32, cache sized for ``max_len``).

    ``max_len`` defaults to the prompt length; serving must pass prompt +
    decode budget so decode steps have free cache slots (a write past the
    end clamps to the last slot, as in the reference).  The cache holds the
    post-RoPE k and v that each layer's attention used, in ``cache_dtype``
    whatever the param dtype, zero past the prompt.
    """
    check_supported(cfg)
    x = embed_tokens(params, cfg, tokens)
    b, s, _ = x.shape
    cache = init_cache(cfg, b, max(s, max_len or s), cache_dtype, x.device)
    windows = cfg.windows()
    for i in range(cfg.n_layers):
        x, (k, v) = block_forward(x, layer(params["blocks"], i), cfg,
                                  window=int(windows[i]), return_kv=True)
        cache["blocks"]["k"][i, :, :s] = k
        cache["blocks"]["v"][i, :, :s] = v
    # the norm is per position: normalising the last one alone is the same
    x = apply_norm(x[:, -1:], params["final_norm"], cfg.norm)
    return logits_fn(params, cfg, x)[:, 0], cache


# --------------------------------------------------------------------------- #
# decode: one token for the whole batch
# --------------------------------------------------------------------------- #
def _decode_attn_dense(x, p, cfg: TransformerConfig, layer_cache, pos,
                       positions, cur_len, window):
    """x: [B,1,d]; cache {k,v}: [B,S,KV,hd], written at ``pos`` in place."""
    b = x.shape[0]
    q, k, v = project_qkv(x, p, cfg, positions)
    k_cache, v_cache = update_kv_cache(layer_cache["k"], layer_cache["v"],
                                       k, v, pos)
    o = decode_attention(q[:, 0], k_cache, v_cache, cur_len, window=window,
                         logit_cap=cfg.attn_softcap, scale=cfg.attn_scale)
    hd_all = cfg.n_heads * cfg.hd
    out = o.reshape(b, hd_all) @ p["wo"].to(o.dtype).reshape(hd_all, -1)
    return out[:, None]


def _decode_block(x, lp, cfg: TransformerConfig, layer_cache, pos, positions,
                  cur_len, window):
    h = apply_norm(x, lp["ln1"], cfg.norm)
    x = x + _decode_attn_dense(h, lp["attn"], cfg, layer_cache, pos,
                               positions, cur_len, window)
    h = apply_norm(x, lp["ln2"], cfg.norm)
    return x + dense_ffn(h, lp["mlp"], cfg)


def decode_step(params: Params, cfg: TransformerConfig, cache: Any,
                tokens: torch.Tensor, pos: int):
    """One decode step. tokens: [B] int; pos: host int, shared by the batch.

    Returns (logits [B,V] float32, cache): the cache is the one given,
    updated in place at ``pos``.  Attention sees ``pos + 1`` entries.
    """
    check_supported(cfg)
    x = embed_tokens(params, cfg, tokens[:, None])            # [B,1,d]
    pos = int(pos)
    # fills on the device: no host-to-device copy, no sync
    positions = torch.full((1,), pos, device=x.device)
    cur_len = torch.full((), pos + 1, dtype=torch.int32, device=x.device)
    windows = cfg.windows()
    kc, vc = cache["blocks"]["k"], cache["blocks"]["v"]
    for i in range(cfg.n_layers):
        x = _decode_block(x, layer(params["blocks"], i), cfg,
                          {"k": kc[i], "v": vc[i]}, pos, positions, cur_len,
                          int(windows[i]))
    x = apply_norm(x, params["final_norm"], cfg.norm)
    return logits_fn(params, cfg, x)[:, 0], cache
