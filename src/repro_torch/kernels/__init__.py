"""Hand-written Hopper kernels (CUDA C++ for sm_90a) and their plain versions.

Layout: ``csrc/*.cu`` holds the kernels, ``build.py`` compiles them at first
use and binds them with ctypes, ``<name>.py`` holds each kernel's wrapper
(with its launch counter) beside a plain PyTorch version of the same
function, ``ops.py`` the model-layout entry points and ``ref.py`` oracles in
the TPU kernels' layout.  Nothing is compiled at import time.

  K1  flash_attention               prefill attention (every layer)
  K2  quantize_int8/dequantize_int8 boundary-activation compression
"""

from . import ops, ref

__all__ = ["ops", "ref"]
