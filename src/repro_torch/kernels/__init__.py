"""Hand-written Hopper kernels (CUDA C++ for sm_90a) and their plain versions.

Layout: ``csrc/*.cu`` holds the kernels, ``build.py`` compiles them at first
use and binds them with ctypes, ``<name>.py`` holds each kernel's wrapper
(with its launch counter) beside a plain PyTorch version of the same
function, ``ops.py`` the model-layout entry points and ``ref.py`` oracles in
the TPU kernels' layout.  Nothing is compiled at import time.

  K1  flash_attention               prefill attention (every transformer
                                    layer, Griffin's local attention)
  K3  decode_attention              one-token attention vs the KV cache
                                    (every layer of every decode step)
  K2  quantize_int8/dequantize_int8 boundary-activation compression
  K4  ssd                           Mamba-2 SSD chunk scan (every layer)
      ssd_bwd                       its gradient (training; no TPU kernel)
  K5  rglru                         Griffin RG-LRU scan (every recurrent
                                    layer)
      rglru_bwd                     its gradient (training; no TPU kernel)
"""

from . import ops, ref

__all__ = ["ops", "ref"]
