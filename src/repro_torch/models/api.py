"""Unified model API: one ModelBundle per architecture family.

Downstream code (serving engine, orchestrator graph extraction) goes through
this interface.  The port's bundle carries what serving needs: the config,
a param initializer, prefill and decode over a KV cache, and the
computational graph the orchestrator partitions.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable

from ..core.graph import GraphNode, ModelGraph
from . import transformer, transformer_serve

__all__ = ["ModelBundle", "bundle_for"]


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

    def num_params(self) -> int:
        return self.cfg.num_params()


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


def _transformer_bundle(arch: str, cfg: transformer.TransformerConfig) -> ModelBundle:
    def prefill(params, batch, max_len=None):
        return transformer_serve.prefill(params, cfg, batch["tokens"],
                                         max_len=max_len)

    def decode(params, cache, tokens, pos):
        return transformer_serve.decode_step(params, cfg, cache, tokens, pos)

    # weight and activation bytes are counted at 2 bytes an element (bf16)
    emb_b = 2.0 * cfg.vocab * cfg.d_model
    return ModelBundle(
        arch=arch, cfg=cfg, family="transformer",
        init=partial(transformer.init_params, cfg),
        prefill=prefill, decode=decode,
        cache_spec=partial(transformer_serve.cache_spec, cfg),
        model_graph=lambda: _graph_from_blocks(
            arch, cfg.n_layers, cfg.d_model,
            2.0 * cfg.active_params_per_block, 2.0 * cfg.params_per_block,
            emb_b, 0.0 if cfg.tie_embeddings else emb_b,
            2.0 * cfg.vocab * cfg.d_model),
    )


def bundle_for(arch: str, cfg: Any) -> ModelBundle:
    if isinstance(cfg, transformer.TransformerConfig):
        return _transformer_bundle(arch, cfg)
    raise TypeError(f"config type {type(cfg).__name__} is not ported yet")
