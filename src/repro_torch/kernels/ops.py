"""Model-layout entry points of the Hopper kernels.

Model code calls these.  Unlike the reference's ``ops``, nothing is padded,
transposed or repeated here: the kernels take the model layout ([B,S,H,hd]
for prefill attention, q [B,H,hd] against [B,S,KV,hd] caches for decode
attention, x [B,S,H,P] with grouped B/C [B,S,G,N] for the SSD scan,
[B,S,W] for the RG-LRU scan, [N,D] for int8 rows) and mask ragged edges
themselves.  Each entry point takes its kernel's plain version for CPU
tensors only.
"""

from __future__ import annotations

from .decode_attention import decode_attention
from .flash_attention import flash_attention
from .int8_transfer import dequantize_int8, quantize_int8, row_absmax
from .rglru import rglru, rglru_bwd
from .ssd_chunk import ssd, ssd_bwd

__all__ = ["decode_attention", "flash_attention", "quantize_int8",
           "dequantize_int8", "row_absmax", "rglru", "rglru_bwd", "ssd",
           "ssd_bwd"]
