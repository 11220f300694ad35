"""Attention cores of the model families.

:func:`chunked_attention` is the prefill attention of every transformer
layer, :func:`decode_attention` the one-token attention of every decode
step.  In the reference both are XLA code; here they call the K1 flash
kernel (``kernels/flash_attention.py``) and the K3 decode kernel
(``kernels/decode_attention.py``).  K1's bf16 instance rounds the
probabilities to bf16 before P·V, as the reference's XLA path casts them to
the value dtype (``src/repro/models/attention.py``), with float32
accumulation; its float32 instance and K3 multiply them into V in float32,
as the reference's TPU kernels do.
"""

from __future__ import annotations

import torch

from ..kernels import ops as kops

__all__ = ["chunked_attention", "decode_attention", "update_kv_cache",
           "write_at"]


def chunked_attention(
    q: torch.Tensor,             # [B, S, H, hd]
    k: torch.Tensor,             # [B, S, KV, hd]
    v: torch.Tensor,             # [B, S, KV, hd_v]
    *,
    causal: bool = True,
    window: int = 0,             # 0 = global; >0 = sliding window
    logit_cap: float = 0.0,
    scale: float | None = None,
) -> torch.Tensor:
    """Prefill attention over the whole sequence. Returns [B, S, H, hd_v].

    v may be narrower than q and k (MLA: qk 192, v 128); K1 takes the pair.
    """
    return kops.flash_attention(q, k, v, causal=causal, window=int(window),
                                logit_cap=logit_cap, scale=scale)


def decode_attention(
    q: torch.Tensor,             # [B, H, hd] — one new token per sequence
    k_cache: torch.Tensor,       # [B, S, KV, hd]
    v_cache: torch.Tensor,       # [B, S, KV, hd]
    cur_len,                     # int, or int tensor [] or [B]: valid entries
    *,
    window: int = 0,
    logit_cap: float = 0.0,
    scale: float | None = None,
    start=0,                     # global position of the cache's slot 0
    return_lse: bool = False,
):
    """Single-step GQA attention over the cache. Returns [B, H, hd], and
    with ``return_lse`` the float32 log-sum-exp [B, H] beside it (K3's
    partial form, for a cache whose sequence axis is sharded)."""
    return kops.decode_attention(q, k_cache, v_cache, cur_len,
                                 window=int(window), logit_cap=logit_cap,
                                 scale=scale, start=start,
                                 return_lse=return_lse)


def update_kv_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor, pos):
    """Write [B, KV, hd] (or [B,1,KV,hd]) entries at ``pos``, in place.

    Returns the same two tensors it was given.  ``pos`` (a host int) is
    placed as JAX's ``dynamic_update_slice`` places it in the reference: a
    negative one counts from the end (+S), then it clamps to [0, S-1], so a
    write past the end overwrites the last slot.
    """
    if k_new.ndim == 3:
        k_new, v_new = k_new[:, None], v_new[:, None]
    return write_at(k_cache, k_new, pos), write_at(v_cache, v_new, pos)


def write_at(cache: torch.Tensor, new: torch.Tensor, pos) -> torch.Tensor:
    """cache[:, pos] = new[:, 0] in place (new [B,1,...]); returns cache.

    ``pos`` (a host int) is placed as JAX's ``dynamic_update_slice``: a
    negative one counts from the end, then it clamps to [0, S-1].
    """
    s = cache.shape[1]
    p = int(pos)
    p = min(max(p + s if p < 0 else p, 0), s - 1)
    cache[:, p:p + 1] = new
    return cache
