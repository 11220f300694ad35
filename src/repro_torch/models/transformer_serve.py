"""Serving paths for the transformer: prefill + single-token decode.

The cache has the reference's trees, each leaf with a leading layer axis:
``{"blocks": {"k", "v"}}`` [L, B, S, KV, hd], or for MLA the latent
``{"blocks": {"ckv", "kr"}}`` [L, B, S, kv_lora] and [L, B, S, rope] (the
paper-exact memory saving); DeepSeek-V2's leading dense layers have their
own ``"lead"`` tree of the same kind.  Layer i reads and writes views of
those tensors.  Decode writes the new entry into them in place, so
:func:`decode_step` returns the very cache tensors it was given (the
reference returns new arrays).  Decode attention is the K3 kernel
(``models/attention.py``), prefill attention K1.  MLA decodes in the
absorbed form: W_uk folds into the query and W_uv into the output, so the
scores and the context live in the latent space and no per-step K/V is
decompressed; that is plain torch, as it is XLA in the reference, with bf16
operands and float32 accumulation.
"""

from __future__ import annotations

from typing import Any

import torch

from .attention import decode_attention, update_kv_cache, write_at
from .common import Params, apply_norm, softcap
from .transformer import (
    TransformerConfig,
    block_forward,
    embed_prefix,
    embed_tokens,
    ffn_forward,
    layer_at,
    logits_fn,
    n_lead,
    project_mla,
    project_qkv,
)

__all__ = ["cache_spec", "init_cache", "prefill", "decode_step"]

NEG_INF = -2.0e38


# --------------------------------------------------------------------------- #
# cache specs
# --------------------------------------------------------------------------- #
def cache_spec(cfg: TransformerConfig, batch: int, max_len: int,
               dtype=torch.bfloat16) -> Any:
    """The cache's shapes and dtype as tensors on the ``meta`` device (the
    reference's ``ShapeDtypeStruct`` tree); leading axis = layer."""
    if cfg.mla is not None:
        m = cfg.mla
        shapes = {"ckv": (batch, max_len, m.kv_lora),
                  "kr": (batch, max_len, m.rope_head_dim)}
    else:
        shapes = dict.fromkeys(("k", "v"), (batch, max_len, cfg.n_kv, cfg.hd))

    def group(n):
        return {name: torch.empty((n, *shape), dtype=dtype, device="meta")
                for name, shape in shapes.items()}

    nl = n_lead(cfg)
    out = {"blocks": group(cfg.n_layers - nl)}
    if nl:
        out["lead"] = group(nl)
    return out


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device: str | torch.device = "cuda") -> Any:
    return {g: {name: torch.zeros(t.shape, dtype=t.dtype, device=device)
                for name, t in tree.items()}
            for g, tree in cache_spec(cfg, batch, max_len, dtype).items()}


def _layer_cache(cache: Any, group: str, j: int) -> dict:
    return {name: t[j] for name, t in cache[group].items()}


# --------------------------------------------------------------------------- #
# prefill: full forward that also fills the cache
# --------------------------------------------------------------------------- #
def prefill(params: Params, cfg: TransformerConfig, tokens: torch.Tensor, *,
            prefix_embeds: torch.Tensor | None = None,
            cache_dtype=torch.bfloat16, max_len: int | None = None):
    """Returns (last-position logits [B, V] float32, cache sized for ``max_len``).

    ``tokens`` are ids [B,S], or embeddings [B,S,d] for a config with
    ``embed_inputs``; ``prefix_embeds`` [B,P,prefix_dim] are projected and
    put before them.  ``max_len`` defaults to the sequence length; serving
    must pass prompt + decode budget so decode steps have free cache slots
    (a write past the end clamps to the last slot, as in the reference).
    The cache holds what each layer's attention used (post-RoPE k and v, or
    MLA's latent and rope key), in ``cache_dtype`` whatever the param dtype,
    zero past the prompt.
    """
    x = tokens if cfg.embed_inputs else embed_tokens(params, cfg, tokens)
    if prefix_embeds is not None:
        x = embed_prefix(params, prefix_embeds, x)
    b, s, _ = x.shape
    cache = init_cache(cfg, b, max(s, max_len or s), cache_dtype, x.device)
    for i in range(cfg.n_layers):
        lp, lcfg, window, group, j = layer_at(params, cfg, i)
        x, kv = block_forward(x, lp, lcfg, window=window, return_kv=True)
        for name, t in kv.items():
            cache[group][name][j, :, :s] = t
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


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of two same-dtype batches with float32 accumulation and a
    float32 result, the reference's ``preferred_element_type=float32``: on
    the card one product on bf16 operands as they are (no float32 copy of
    the cache), else a float32 product (bf16 products are exact in
    float32)."""
    if a.device.type == "cuda" and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _decode_attn_mla(x, p, cfg: TransformerConfig, layer_cache, pos,
                     positions, cur_len, window):
    """Absorbed MLA decode: scores and context in the kv_lora-wide latent
    space, over the latent cache {ckv [B,S,L], kr [B,S,R]} written at
    ``pos`` in place.  Like the reference it masks by position only (MLA
    configs have no window)."""
    del window
    m = cfg.mla
    b, h = x.shape[0], cfg.n_heads
    q_nope, q_rope, ckv_new, kr_new = project_mla(x, p, cfg, positions)
    ckv = write_at(layer_cache["ckv"], ckv_new, pos)
    kr = write_at(layer_cache["kr"], kr_new, pos)
    # absorb W_uk into q: q_lat[b,h,l] = q_nope[b,h,n] . wuk[l,h,n]
    q_lat = torch.einsum("bhn,lhn->bhl", q_nope[:, 0],
                         p["wuk"].to(q_nope.dtype))
    s_nope = _bmm_f32(q_lat.to(ckv.dtype), ckv.transpose(1, 2))      # [B,h,S]
    s_rope = _bmm_f32(q_rope[:, 0].to(kr.dtype), kr.transpose(1, 2))
    scores = (s_nope + s_rope) * (m.nope_head_dim + m.rope_head_dim) ** -0.5
    if cfg.attn_softcap:
        scores = softcap(scores, cfg.attn_softcap)
    valid = torch.arange(ckv.shape[1], device=x.device) < cur_len
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctx = _bmm_f32(probs.to(ckv.dtype), ckv)                          # [B,h,L]
    # absorb W_uv on the way out: v[b,h,v] = ctx[b,h,l] . wuv[l,h,v]
    vout = torch.einsum("bhl,lhv->bhv", ctx.to(x.dtype), p["wuv"].to(x.dtype))
    out = vout.reshape(b, h * m.v_head_dim) @ \
        p["wo"].to(vout.dtype).reshape(h * m.v_head_dim, -1)
    return out[:, None]


def _decode_block(x, lp, cfg: TransformerConfig, layer_cache, pos, positions,
                  cur_len, window):
    h = apply_norm(x, lp["ln1"], cfg.norm)
    fn = _decode_attn_mla if cfg.mla is not None else _decode_attn_dense
    attn = fn(h, lp["attn"], cfg, layer_cache, pos, positions, cur_len, window)
    if cfg.post_norm:
        attn = apply_norm(attn, lp["ln1_post"], cfg.norm)
    if cfg.parallel_block:
        return x + attn + ffn_forward(h, lp, cfg)
    x = x + attn
    f = ffn_forward(apply_norm(x, lp["ln2"], cfg.norm), lp, cfg)
    if cfg.post_norm:
        f = apply_norm(f, lp["ln2_post"], cfg.norm)
    return x + f


def decode_step(params: Params, cfg: TransformerConfig, cache: Any,
                tokens: torch.Tensor, pos: int):
    """One decode step. tokens: [B] int (or [B,d] embeddings with
    ``embed_inputs``); pos: host int, shared by the batch.

    Returns (logits [B,V] float32, cache): the cache is the one given,
    updated in place at ``pos``.  Attention sees ``pos + 1`` entries.
    """
    if cfg.embed_inputs:
        x = tokens[:, None, :]
    else:
        x = embed_tokens(params, cfg, tokens[:, None])          # [B,1,d]
    pos = int(pos)
    # fills on the device: no host-to-device copy, no sync
    positions = torch.full((1,), pos, device=x.device)
    cur_len = torch.full((), pos + 1, dtype=torch.int32, device=x.device)
    for i in range(cfg.n_layers):
        lp, lcfg, window, group, j = layer_at(params, cfg, i)
        x = _decode_block(x, lp, lcfg, _layer_cache(cache, group, j), pos,
                          positions, cur_len, window)
    x = apply_norm(x, params["final_norm"], cfg.norm)
    return logits_fn(params, cfg, x)[:, 0], cache
