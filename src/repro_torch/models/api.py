"""Unified model API: one ModelBundle per architecture family.

Downstream code (training step, serving engine, orchestrator graph
extraction) goes through this interface.  The port's bundle carries the
config, a param initializer, the training loss (every family: K1's, K4's
and K5's backward kernels carry the gradients on the card), prefill and
decode over the family's cache (KV cache, SSM state, or LRU state plus a
ring of the attention window), and the computational graph the orchestrator
partitions.

Under a mesh (``training.make_serve_fns``, ``training.make_train_step``)
``prefill``, ``decode`` and ``loss`` run in a tensor-parallel region on
each rank's blocks of the params, the inputs and the cache (the dense
transformers; ``distributed/context.py``; the loss's cross-entropy over a
vocabulary sharded over "model" never gathers the logits), while
``cache_spec``, ``input_specs`` and ``param_specs`` stay global: the
policy's specs are read off them.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.graph import GraphNode, ModelGraph
from ..distributed.context import all_reduce_model, current_region, gather_seq
from . import griffin, mamba2, transformer, transformer_serve
from .common import apply_norm, layer

__all__ = ["ModelBundle", "bundle_for", "softmax_xent", "chunked_softmax_xent",
           "SHAPES", "ShapeSpec"]


@dataclass(frozen=True)
class ShapeSpec:
    """An input shape of the reference's LM families: seq_len x global_batch."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


# --------------------------------------------------------------------------- #
# losses
# --------------------------------------------------------------------------- #
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean masked token xent; labels < 0 are ignored. logits [B,S,V]."""
    mask = labels >= 0
    safe = labels.clamp_min(0).long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, safe[..., None])[..., 0]
    per_tok = (lse - ll) * mask
    return per_tok.sum() / mask.sum().clamp_min(1)


def _vocab_parallel_lse_ll(logits: torch.Tensor, safe: torch.Tensor):
    """(logsumexp, the label's logit) over the vocabulary, from this rank's
    block of it: the max and the sum of exponentials reduced over "model"
    (the max detached: the logsumexp does not depend on it), the label's
    logit taken on the rank whose rows hold it and summed over the axis."""
    import torch.distributed as dist

    r = current_region()
    n = logits.shape[-1]
    m = logits.detach().amax(dim=-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=r.group)
    lse = m + torch.log(all_reduce_model(
        torch.exp(logits - m[..., None]).sum(dim=-1)))
    local = safe - r.rank * n
    inside = (local >= 0) & (local < n)
    ll = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    return lse, all_reduce_model(torch.where(inside, ll, 0.0))


def _xent_chunk(hx, w_head, lx, final_softcap, vocab):
    """(summed xent, token count) of one sequence chunk: logits [B,c,V] in
    float32, soft-capped, labels < 0 masked.  Where ``w_head`` holds this
    rank's block of the ``vocab`` columns (a tensor-parallel region), the
    logits are that block [B,c,V/tp] and the logsumexp is reduced over
    "model" (``_vocab_parallel_lse_ll``)."""
    logits = (hx @ w_head.to(hx.dtype)).float()
    if final_softcap:
        logits = final_softcap * torch.tanh(logits / final_softcap)
    mask = lx >= 0
    safe = lx.clamp_min(0).long()
    if logits.shape[-1] != vocab:
        lse, ll = _vocab_parallel_lse_ll(logits, safe)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, safe[..., None])[..., 0]
    return ((lse - ll) * mask).sum(), mask.sum(dtype=torch.int32)


def chunked_softmax_xent(h: torch.Tensor, w_head: torch.Tensor,
                         labels: torch.Tensor, *, chunk: int = 512,
                         final_softcap: float = 0.0,
                         vocab: int | None = None) -> torch.Tensor:
    """Sequence-chunked xent: logits never materialize beyond [B,chunk,V].

    S is padded to a multiple of the chunk with labels -1; the chunks' sums
    and counts add in order, as the reference's scan does.  Under grad mode
    each chunk is checkpointed, so its logits are recomputed in the backward
    instead of kept.  In a tensor-parallel region ``w_head`` may be this
    rank's block of the ``vocab`` columns (default: its own width): each
    chunk's logits are then that block only, never gathered.
    """
    b, s, d = h.shape
    vocab = w_head.shape[-1] if vocab is None else vocab
    c = min(chunk, s)
    pad = (-s) % c
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.int32, device=h.device)
    for i in range(0, h.shape[1], c):
        hx, lx = h[:, i:i + c], labels[:, i:i + c]
        if torch.is_grad_enabled():
            part, n = checkpoint(_xent_chunk, hx, w_head, lx, final_softcap,
                                 vocab, use_reentrant=False,
                                 preserve_rng_state=False)
        else:
            part, n = _xent_chunk(hx, w_head, lx, final_softcap, vocab)
        tot, cnt = tot + part, cnt + n
    return tot / cnt.clamp_min(1)


# --------------------------------------------------------------------------- #
# bundle
# --------------------------------------------------------------------------- #
@dataclass
class ModelBundle:
    arch: str
    cfg: Any
    family: str
    init: Callable[..., Any]                  # (generator, device, dtype) -> params
    prefill: Callable[..., tuple]             # (params, batch, max_len) -> (logits, cache)
    decode: Callable[..., tuple]              # (params, cache, tokens, pos)
    cache_spec: Callable[..., Any]            # (batch, max_len) -> meta-tensor tree
    model_graph: Callable[[], ModelGraph]
    loss: Callable[..., torch.Tensor] | None = None   # (params, batch) -> scalar

    def param_specs(self, dtype=torch.float32) -> Any:
        """The param tree as ``meta`` tensors (shapes and dtypes, no data)."""
        return self.init(torch.Generator(), "meta", dtype)

    def num_params(self) -> int:
        return self.cfg.num_params()

    def num_active_params(self) -> int:
        fn = getattr(self.cfg, "num_active_params", None)
        return fn() if fn else self.cfg.num_params()

    def input_specs(self, shape: ShapeSpec) -> dict[str, Any]:
        """The inputs of one step at ``shape`` as ``meta`` tensors, as the
        reference's: token ids (and labels for training) with room left for
        a modality prefix, whose embeddings come beside them in bf16; for
        decode the cache, one token per row and the position."""
        s, b = shape.seq_len, shape.global_batch
        prefix = getattr(self.cfg, "prefix_tokens", 0)

        def meta(*dims, dtype=torch.int32):
            return torch.empty(dims, dtype=dtype, device="meta")

        if shape.kind in ("train", "prefill"):
            spec = {"tokens": meta(b, s - prefix)}
            if shape.kind == "train":
                spec["labels"] = meta(b, s)
            if prefix:
                spec["prefix_embeds"] = meta(b, prefix, self.cfg.prefix_dim,
                                             dtype=torch.bfloat16)
            return spec
        return {"cache": self.cache_spec(b, s), "tokens": meta(b),
                "pos": meta()}


def _graph_from_blocks(name: str, n_layers: int, d_model: int,
                       flops_per_block: float, bytes_per_block: float,
                       embed_bytes: float, head_bytes: float,
                       head_flops: float) -> ModelGraph:
    units = [GraphNode("embed", 2.0 * d_model, embed_bytes, 2.0 * d_model,
                       privacy_critical=True)]
    units += [GraphNode(f"block_{i}", flops_per_block, bytes_per_block,
                        2.0 * d_model) for i in range(n_layers)]
    units += [GraphNode("lm_head", head_flops, head_bytes, 0.0,
                        privacy_critical=True)]
    return ModelGraph(name, units)


def _lm_loss(module, cfg: Any, params: dict, batch: dict) -> torch.Tensor:
    """Mean next-token xent of ``batch`` ({"tokens" [B,S-P], "labels"
    [B,S], and for a transformer an optional "prefix_embeds" [B,P,
    prefix_dim]}) through ``module``'s embedding, its checkpointed
    ``forward_hidden`` and the tied or untied head, with the family's final
    soft-cap (0 for none).  Activations are bf16, the families'
    ``embed_tokens`` default, as the reference's: attention runs K1's bf16
    forward and backward, the SSD and the RG-LRU scan in float32 inside
    (K4's and K5's float32 kernels), as the reference's do."""
    region = current_region() is not None
    if region and module is not transformer:
        raise NotImplementedError(
            f"the {cfg.name} loss on a 'model' axis above 1: tensor-parallel "
            "training runs the dense GQA transformers (ROADMAP, Queue 1)")
    tokens = batch["tokens"]
    x = module.embed_tokens(params, cfg, tokens)
    s = tokens.shape[1]
    prefix = batch.get("prefix_embeds")
    if prefix is not None:
        x = module.embed_prefix(params, prefix, x, seq=s)
        s += prefix.shape[1]
    # in a region: hidden in its layout, gathered whole for the head
    h = gather_seq(module.forward_hidden(params, cfg, x, seq=s), s) if region \
        else module.forward_hidden(params, cfg, x)
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return chunked_softmax_xent(h, w, batch["labels"],
                                final_softcap=getattr(cfg, "final_softcap", 0.0),
                                vocab=cfg.vocab)


def _transformer_bundle(arch: str, cfg: transformer.TransformerConfig) -> ModelBundle:
    def prefill(params, batch, max_len=None):
        return transformer_serve.prefill(
            params, cfg, batch["tokens"],
            prefix_embeds=batch.get("prefix_embeds"), max_len=max_len)

    def decode(params, cache, tokens, pos):
        return transformer_serve.decode_step(params, cfg, cache, tokens, pos)

    # weight and activation bytes are counted at 2 bytes an element (bf16)
    emb_b = 2.0 * cfg.vocab * cfg.d_model
    return ModelBundle(
        arch=arch, cfg=cfg, family="transformer",
        init=partial(transformer.init_params, cfg),
        prefill=prefill, decode=decode,
        cache_spec=partial(transformer_serve.cache_spec, cfg),
        loss=partial(_lm_loss, transformer, cfg),
        model_graph=lambda: _graph_from_blocks(
            arch, cfg.n_layers, cfg.d_model,
            2.0 * cfg.active_params_per_block, 2.0 * cfg.params_per_block,
            emb_b, 0.0 if cfg.tie_embeddings else emb_b,
            2.0 * cfg.vocab * cfg.d_model),
    )


def _mamba2_bundle(arch: str, cfg: mamba2.Mamba2Config) -> ModelBundle:
    def prefill(params, batch, max_len=None):
        """Last-position logits and the decode state {"ssm", "conv"}, conv in
        bf16; the state's size does not depend on ``max_len``."""
        del max_len
        x = mamba2.embed_tokens(params, cfg, batch["tokens"])
        b = x.shape[0]
        cache = mamba2.init_cache(cfg, b, 0, device=x.device)
        for i in range(cfg.n_layers):
            x, (ssm, conv) = mamba2.block_forward(
                x, layer(params["blocks"], i), cfg, return_state=True)
            cache["ssm"][i] = ssm
            cache["conv"][i] = conv
        x = apply_norm(x[:, -1:], params["final_norm"], cfg.norm)
        return mamba2.logits_fn(params, cfg, x)[:, 0], cache

    def decode(params, cache, tokens, pos):
        return mamba2.decode_step(params, cfg, cache, tokens, pos)

    emb_b = 2.0 * cfg.vocab * cfg.d_model
    return ModelBundle(
        arch=arch, cfg=cfg, family="mamba2",
        init=partial(mamba2.init_params, cfg),
        prefill=prefill, decode=decode,
        cache_spec=partial(mamba2.cache_spec, cfg),
        loss=partial(_lm_loss, mamba2, cfg),
        model_graph=lambda: _graph_from_blocks(
            arch, cfg.n_layers, cfg.d_model,
            2.0 * cfg.params_per_block, 2.0 * cfg.params_per_block,
            emb_b, 0.0 if cfg.tie_embeddings else emb_b,
            2.0 * cfg.vocab * cfg.d_model),
    )


def _griffin_bundle(arch: str, cfg: griffin.GriffinConfig) -> ModelBundle:
    def prefill(params, batch, max_len=None):
        """Last-position logits and the decode cache: per recurrent layer the
        LRU state and conv tail, per attention layer a ring of ``w =
        min(window, max_len)`` slots holding the last min(S, w) post-RoPE
        k/v at slot ``pos % w``, and ``slot_pos``; layers in global order,
        which is the reference's group-major order."""
        x = griffin.embed_tokens(params, cfg, batch["tokens"])
        b, s, _ = x.shape
        w = min(cfg.window, max_len or s)                # ring size
        m = min(s, w)                                    # tail tokens kept
        cache = griffin.init_cache(cfg, b, w, device=x.device)
        tail_pos = torch.arange(s - m, s, device=x.device)
        slots = tail_pos % w
        cache["slot_pos"][:, slots] = tail_pos.to(torch.int32)
        ri = ai = 0
        for li in range(cfg.n_layers):
            kind, tm, mp = griffin.layer_params(params, cfg, li)
            if kind == "rec":
                x, (lru, conv) = griffin.rec_forward(x, tm, cfg,
                                                     return_state=True)
                cache["lru"][ri] = lru
                cache["conv"][ri] = conv
                ri += 1
            else:
                x, (k, v) = griffin.attn_forward(x, tm, cfg, return_kv=True)
                cache["k"][ai][:, slots] = k[:, s - m:].to(torch.bfloat16)
                cache["v"][ai][:, slots] = v[:, s - m:].to(torch.bfloat16)
                ai += 1
            x = griffin.mlp_forward(x, mp, cfg)
        x = apply_norm(x[:, -1:], params["final_norm"], cfg.norm)
        return griffin.logits_fn(params, cfg, x)[:, 0], cache

    def decode(params, cache, tokens, pos):
        return griffin.decode_step(params, cfg, cache, tokens, pos)

    emb_b = 2.0 * cfg.vocab * cfg.d_model
    mean_block = float(np.mean([cfg.params_per_layer(k)
                                for k in cfg.layer_kinds()]))
    return ModelBundle(
        arch=arch, cfg=cfg, family="griffin",
        init=partial(griffin.init_params, cfg),
        prefill=prefill, decode=decode,
        cache_spec=partial(griffin.cache_spec, cfg),
        loss=partial(_lm_loss, griffin, cfg),
        model_graph=lambda: _graph_from_blocks(
            arch, cfg.n_layers, cfg.d_model, 2.0 * mean_block, 2.0 * mean_block,
            emb_b, 0.0 if cfg.tie_embeddings else emb_b,
            2.0 * cfg.vocab * cfg.d_model),
    )


def bundle_for(arch: str, cfg: Any) -> ModelBundle:
    if isinstance(cfg, transformer.TransformerConfig):
        return _transformer_bundle(arch, cfg)
    if isinstance(cfg, mamba2.Mamba2Config):
        return _mamba2_bundle(arch, cfg)
    if isinstance(cfg, griffin.GriffinConfig):
        return _griffin_bundle(arch, cfg)
    raise TypeError(f"config type {type(cfg).__name__} is not ported yet")
