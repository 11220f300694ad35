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

Tensor-parallel serving (dense GQA configs, in a region of
``distributed/context.py``): each rank holds its block of the cache, as
``cache_pspecs`` lays it out.  Where the kv heads divide the "model" axis
the rank holds its kv heads and K3 runs on its query heads against them.
Else the cache's sequence axis is sharded (the distributed flash-decoding
layout): the rank holds slots ``[r n, (r + 1) n)`` of every kv head;
decode gathers q over the axis, runs K3's partial form on its slots for
every head (masked by global position, with each head's log-sum-exp), and
the ranks merge their (o, lse) pairs through one all-gather; only the rank
that owns slot ``pos`` writes the new entry.
"""

from __future__ import annotations

from typing import Any

import torch

from ..distributed.context import (
    all_gather_model,
    all_reduce_model,
    current_region,
    to_hidden,
)
from ..distributed.sharding import shard_shape
from ..kernels.decode_attention import combine_partials
from .attention import decode_attention, update_kv_cache, write_at
from .common import Params, apply_norm, softcap
from .transformer import (
    TransformerConfig,
    block_forward,
    embed_prefix,
    embed_tokens,
    ffn_forward,
    heads_of,
    last_position,
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


def seq_sharded_cache(cfg: TransformerConfig) -> bool:
    """Whether this rank's cache block shards the sequence (a
    tensor-parallel region whose "model" axis the kv heads do not divide)."""
    return current_region() is not None and not heads_of(cfg).kv_sharded


def _local_shape(cfg: TransformerConfig, shape: tuple[int, ...]) -> tuple[int, ...]:
    """This rank's block of a cache leaf [L, B, S, KV, hd] whose batch is
    already the rank's: kv heads or the sequence over "model" (an uneven
    split of the sequence raises, as the reference's ``NamedSharding``)."""
    r = current_region()
    if r is None:
        return shape
    if seq_sharded_cache(cfg):
        return shard_shape(shape, (None, None, "model", None, None), r.sizes)
    return shard_shape(shape, (None, None, None, "model", None), r.sizes)


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device: str | torch.device = "cuda") -> Any:
    """A zero cache; in a tensor-parallel region this rank's block of it
    (``batch`` is the rank's rows)."""
    return {g: {name: torch.zeros(_local_shape(cfg, tuple(t.shape)),
                                  dtype=t.dtype, device=device)
                for name, t in tree.items()}
            for g, tree in cache_spec(cfg, batch, max_len, dtype).items()}


def _fill(cfg: TransformerConfig, dst: torch.Tensor, t: torch.Tensor) -> None:
    """Write prefill entries t [B,S,...] at positions [0, S) into this
    rank's cache block dst [B,n,...]: the positions its slots hold (slot 0
    is position r n where the sequence is sharded, else 0)."""
    n, s = dst.shape[1], t.shape[1]
    start = current_region().rank * n if seq_sharded_cache(cfg) else 0
    stop = min(start + n, s)
    if stop > start:
        dst[:, :stop - start] = t[:, start:stop]


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

    In a tensor-parallel region the inputs are the rank's rows, and the
    logits and the cache come back as its blocks (module docstring).
    """
    x = to_hidden(tokens, partial=False) if cfg.embed_inputs \
        else embed_tokens(params, cfg, tokens)
    s = tokens.shape[1]
    if prefix_embeds is not None:
        x = embed_prefix(params, prefix_embeds, x, seq=s)
        s += prefix_embeds.shape[1]
    b = x.shape[0]
    cache = init_cache(cfg, b, max(s, max_len or s), cache_dtype, x.device)
    for i in range(cfg.n_layers):
        lp, lcfg, window, group, j = layer_at(params, cfg, i)
        x, kv = block_forward(x, lp, lcfg, window=window, return_kv=True, seq=s)
        for name, t in kv.items():
            _fill(lcfg, cache[group][name][j], t)
    # the norm is per position: normalising the last one alone is the same
    x = apply_norm(last_position(x, s), params["final_norm"], cfg.norm)
    return logits_fn(params, cfg, x)[:, 0], cache


# --------------------------------------------------------------------------- #
# decode: one token for the whole batch
# --------------------------------------------------------------------------- #
def _decode_attn_dense(x, p, cfg: TransformerConfig, layer_cache, pos,
                       positions, cur_len, window):
    """x: [B,1,d]; cache {k,v}: [B,S,KV,hd], written at ``pos`` in place.
    In a tensor-parallel region the rank's query heads attend over its
    block of the cache, which holds its kv heads or its slots of all."""
    b = x.shape[0]
    q, k, v = project_qkv(x, p, cfg, positions)
    lh = heads_of(cfg)
    if current_region() is None or lh.kv_sharded:
        k_cache, v_cache = update_kv_cache(layer_cache["k"], layer_cache["v"],
                                           k, v, pos)
        o = decode_attention(q[:, 0], k_cache, v_cache, cur_len, window=window,
                             logit_cap=cfg.attn_softcap, scale=cfg.attn_scale)
    else:
        o = _decode_attn_slots(q[:, 0], k, v, cfg, layer_cache, pos, cur_len,
                               window, lh)
    hd_all = lh.h * cfg.hd
    out = o.reshape(b, hd_all) @ p["wo"].to(o.dtype).reshape(hd_all, -1)
    # hidden is replicated at S = 1: a partial sum over the heads is all-reduced
    return (all_reduce_model(out) if lh.q_sharded else out)[:, None]


def _decode_attn_slots(q, k, v, cfg: TransformerConfig, layer_cache, pos,
                       cur_len, window, lh):
    """Decode attention over a sequence-sharded cache: q [B,H_loc,hd], the
    new k/v [B,1,KV,hd] (every kv head) -> this rank's heads' output
    [B,H_loc,hd]."""
    r = current_region()
    k_cache, v_cache = layer_cache["k"], layer_cache["v"]
    n = k_cache.shape[1]
    # write_at's placement over the global S = n * tp: the owner writes
    s = n * r.tp
    at = min(max(pos + s if pos < 0 else pos, 0), s - 1)
    if at // n == r.rank:
        update_kv_cache(k_cache, v_cache, k, v, at - r.rank * n)
    if lh.q_sharded:                       # every head's q, in head order
        q = all_gather_model(q).transpose(0, 1).reshape(q.shape[0], -1, q.shape[2])
    o, lse = decode_attention(q, k_cache, v_cache, cur_len, window=window,
                              logit_cap=cfg.attn_softcap, scale=cfg.attn_scale,
                              start=r.rank * n, return_lse=True)
    parts = all_gather_model(torch.cat([o.float(), lse[..., None]], dim=-1))
    o = combine_partials(parts[..., :-1], parts[..., -1]).to(q.dtype)
    return o[:, lh.q0:lh.q0 + lh.h]


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
    updated in place at ``pos``.  Attention sees ``pos + 1`` entries.  In
    a tensor-parallel region the tokens are the rank's rows, the cache its
    block, and the logits come back as its block.
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
