"""Model-layout entry points of the Hopper kernels.

Model code calls these.  Unlike the reference's ``ops``, nothing is padded
or transposed here: the kernels take the model layout ([B,S,H,hd] for
attention, [N,D] for int8 rows) and mask ragged edges themselves.  Each
entry point takes its kernel's plain version for CPU tensors only.
"""

from __future__ import annotations

from .flash_attention import flash_attention
from .int8_transfer import dequantize_int8, quantize_int8

__all__ = ["flash_attention", "quantize_int8", "dequantize_int8"]
