"""K2, int8 boundary transfer: the Hopper kernels' wrappers and plain versions.

Replaces the Pallas TPU kernels ``repro/kernels/int8_transfer.py::
quantize_int8`` (``_quant_kernel``) and ``::dequantize_int8``
(``_dequant_kernel``): symmetric per-row int8 with one float32 scale per
row, ``scale = max(absmax, 1e-12) / 127``, ``q = clip(round(x / scale),
±127)`` (round half to even), and ``x' = (q · scale)`` cast to the output
dtype.  Split inference quantizes every boundary activation before it
crosses a link and dequantizes it on the other side.

What bounds them on the H100: a few operations per byte, so bytes.  At the
serving shape ([512, 4096] bf16) quantize reads 4.2 MB and writes 2.1 MB
of int8 plus 2 KB of scales, dequantize the reverse: 6.3 MB each, 1.9 us
at 3.35 TB/s.  The kernels (``csrc/int8_transfer.cu``) give each row its
own block of 256 threads (512 blocks over 132 SMs), read each input once
from device memory (quantize reads its row a second time, from L2) and
write each output once.  The divisions are IEEE, so ``q`` and the scales
are bit-identical to the plain versions and to the reference.

The wrappers take the plain versions only for tensors on the CPU; for a CUDA
tensor they launch the kernel or raise.
"""

from __future__ import annotations

import torch

from . import build

__all__ = ["quantize_int8", "dequantize_int8", "quantize_int8_plain",
           "dequantize_int8_plain"]

_DTYPES = (torch.float32, torch.bfloat16)


def quantize_int8_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [N, D] -> (int8 [N, D], float32 scales [N, 1])."""
    xf = x.float()
    absmax = xf.abs().amax(dim=1, keepdim=True)
    # a tensor divisor: PyTorch turns division by a Python scalar into a
    # multiplication by its reciprocal on CUDA, which is not the IEEE quotient
    scale = torch.clamp_min(absmax, 1e-12) / torch.full_like(absmax, 127.0)
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8_plain(q: torch.Tensor, scales: torch.Tensor,
                          dtype=torch.bfloat16) -> torch.Tensor:
    """int8 [N, D], float32 scales [N, 1] -> [N, D] in ``dtype``."""
    return (q.float() * scales).to(dtype)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [N, D] (float32 or bfloat16) -> (int8 [N, D], float32 scales [N, 1]).

    ``quantize_int8.launches`` counts kernel launches.
    """
    if x.ndim != 2:
        raise ValueError(f"want x [N, D], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return quantize_int8_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 kernel for device {x.device}")
    if x.dtype not in _DTYPES or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"kernel takes non-empty contiguous {_DTYPES}; "
                         f"got {x.dtype}, {tuple(x.shape)}")
    n, d = x.shape
    q = torch.empty((n, d), dtype=torch.int8, device=x.device)
    scales = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    lib = build.load()
    err = lib.quantize_int8_fwd(x.data_ptr(), q.data_ptr(), scales.data_ptr(),
                                int(x.dtype == torch.bfloat16), n, d, _stream(x))
    build.check(lib, err, "quantize_int8")
    quantize_int8.launches += 1
    return q, scales


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """int8 [N, D], float32 scales [N, 1] -> [N, D] in ``dtype``.

    ``dequantize_int8.launches`` counts kernel launches.
    """
    if q.ndim != 2 or q.dtype != torch.int8 or scales.shape != (q.shape[0], 1) \
            or scales.dtype != torch.float32 or scales.device != q.device:
        raise ValueError(f"want int8 [N, D] and float32 [N, 1] on one device; "
                         f"got {q.dtype} {tuple(q.shape)}, "
                         f"{scales.dtype} {tuple(scales.shape)}")
    if q.device.type == "cpu":
        return dequantize_int8_plain(q, scales, dtype)
    if q.device.type != "cuda":
        raise ValueError(f"no int8 kernel for device {q.device}")
    if dtype not in _DTYPES or not (q.is_contiguous() and scales.is_contiguous()) \
            or q.numel() == 0:
        raise ValueError(f"kernel writes {_DTYPES} from non-empty contiguous "
                         f"inputs; got {dtype}, {tuple(q.shape)}")
    n, d = q.shape
    x = torch.empty((n, d), dtype=dtype, device=q.device)
    lib = build.load()
    err = lib.dequantize_int8_fwd(q.data_ptr(), scales.data_ptr(), x.data_ptr(),
                                  int(dtype == torch.bfloat16), n, d, _stream(q))
    build.check(lib, err, "dequantize_int8")
    dequantize_int8.launches += 1
    return x


quantize_int8.launches = 0
dequantize_int8.launches = 0
