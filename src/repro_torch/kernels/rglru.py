"""K5, the RG-LRU scan: the Hopper kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/rglru.py::rglru_scan``
(``_rglru_kernel``) together with its wrapper ``ops.rglru``: the linear
recurrence ``h_t = a_t ⊙ h_{t-1} + x_t`` over [B, S, W], float32 carry,
output in x's dtype.  Beyond the TPU kernel, which starts from zero, it
starts from ``h0`` [B, W] when given, as the model path
(``models/griffin.py::rglru``) needs for chunked prefill.

What bounds it on the H100: bytes.  At the Griffin prefill shape ([1, 512,
4096] float32) a and x are 16.8 MB read and h 8.4 MB written, 7.5 us at
3.35 TB/s.  The kernel (``csrc/rglru.cu``) gives a thread to each (lane,
64-step chunk), 32,768 threads at that shape, in two passes: chunk
products and local end states, then each chunk again from its carry-in.

The wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from . import build

__all__ = ["rglru", "rglru_plain"]

_DTYPES = (torch.float32, torch.bfloat16)


def _check(a, x, h0) -> None:
    if a.ndim != 3 or a.shape != x.shape:
        raise ValueError(f"want a, x [B,S,W] of one shape; got "
                         f"{tuple(a.shape)}, {tuple(x.shape)}")
    if a.dtype != x.dtype or a.device != x.device:
        raise ValueError("a and x must share dtype and device")
    if h0 is not None and (tuple(h0.shape) != (x.shape[0], x.shape[2])
                           or h0.device != x.device):
        raise ValueError(f"h0 must be [B, W] = {(x.shape[0], x.shape[2])} on "
                         f"{x.device}; got {tuple(h0.shape)} on {h0.device}")


def rglru_plain(a, x, h0=None) -> torch.Tensor:
    """Sequential recurrence in float32: a, x [B,S,W], h0 [B,W] or None
    -> h [B,S,W] in x's dtype."""
    _check(a, x, h0)
    b, s, w = x.shape
    h = (torch.zeros((b, w), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    out = torch.empty((b, s, w), dtype=x.dtype, device=x.device)
    for t in range(s):
        h = a[:, t].float() * h + x[:, t].float()
        out[:, t] = h
    return out


@functools.lru_cache(maxsize=None)
def _chunk_steps() -> int:
    return int(build.load().rglru_chunk_steps())


def rglru(a, x, h0=None) -> torch.Tensor:
    """RG-LRU scan: a, x [B,S,W] -> h [B,S,W] in x's dtype; ``h0`` [B,W]
    float32 is the carried state before step 0 (zero when None).

    CPU tensors take :func:`rglru_plain`; CUDA tensors launch the Hopper
    kernel (contiguous float32 or bfloat16 a and x, contiguous float32 h0)
    or raise.  ``rglru.launches`` counts kernel launches.
    """
    _check(a, x, h0)
    if x.device.type == "cpu":
        return rglru_plain(a, x, h0)
    if x.device.type != "cuda":
        raise ValueError(f"no RG-LRU kernel for device {x.device}")
    if x.dtype not in _DTYPES or not (a.is_contiguous() and x.is_contiguous()):
        raise ValueError(f"kernel takes contiguous a, x in {_DTYPES}; got "
                         f"{x.dtype}")
    if h0 is not None and (h0.dtype != torch.float32 or not h0.is_contiguous()):
        raise ValueError(f"kernel takes a contiguous float32 h0; got {h0.dtype}")
    b, s, w = x.shape
    if x.numel() == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")
    n_chunks = -(-s // _chunk_steps())
    ws = torch.empty(2 * b * n_chunks * w, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    lib = build.load()
    err = lib.rglru_fwd(a.data_ptr(), x.data_ptr(),
                        None if h0 is None else h0.data_ptr(), ws.data_ptr(),
                        out.data_ptr(), int(x.dtype == torch.bfloat16), b, s, w,
                        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "rglru")
    rglru.launches += 1
    return out


rglru.launches = 0
