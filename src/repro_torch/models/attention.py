"""Attention cores of the model families.

:func:`chunked_attention` is the prefill attention of every transformer
layer.  In the reference it is an XLA online-softmax scan; here it is a call
into the K1 flash kernel (``kernels/flash_attention.py``), whose arithmetic
follows the reference's TPU kernel: q is scaled and the probabilities are
multiplied into V in float32, where the reference's XLA path scales q and
casts the probabilities to the activation dtype (bf16) first.
"""

from __future__ import annotations

import torch

from ..kernels import ops as kops

__all__ = ["chunked_attention"]


def chunked_attention(
    q: torch.Tensor,             # [B, S, H, hd]
    k: torch.Tensor,             # [B, S, KV, hd]
    v: torch.Tensor,             # [B, S, KV, hd]
    *,
    causal: bool = True,
    window: int = 0,             # 0 = global; >0 = sliding window
    logit_cap: float = 0.0,
    scale: float | None = None,
) -> torch.Tensor:
    """Prefill attention over the whole sequence. Returns [B, S, H, hd]."""
    return kops.flash_attention(q, k, v, causal=causal, window=int(window),
                                logit_cap=logit_cap, scale=scale)
