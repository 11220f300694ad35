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
at 3.35 TB/s.  Quantize (``csrc/int8_transfer.cu``, ``quantize_rows_vec``)
gives each row four warps that load the whole row in 16-byte vectors
into registers before anything else, reduce its absmax with warp shuffles
and a named barrier of the row's warps, and store 8 codes a lane at a
time: one pass over device memory.  Rows whose width is not a
multiple of 16 bytes, or above 16,384 bf16 / 8,192 float32 elements, take
the general instance (a block a row, two passes).  Dequantize gives each
row a block of 256 threads.  The per-row scale is an IEEE division; the
per-element quotient is an IEEE division for float32 input and, for bf16,
a reciprocal product corrected by one FMA that equals the IEEE quotient for
every finite bf16 input (``bf16_domain_rows`` generates that domain, and
the card tests sweep all of it).  So ``q`` and the scales are bit-identical
to the plain versions and to the reference.

The wrappers take the plain versions only for tensors on the CPU; for a CUDA
tensor they launch the kernel or raise.
"""

from __future__ import annotations

import torch

from . import build

__all__ = ["quantize_int8", "dequantize_int8", "quantize_int8_plain",
           "dequantize_int8_plain", "bf16_domain_rows", "BF16_FINITE"]

_DTYPES = (torch.float32, torch.bfloat16)
BF16_FINITE = 0x7F80    # bit patterns 0 .. 0x7F7F: +0 to the largest finite bf16


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


def bf16_domain_rows(absmax_bits=None, width: int = 4096, rows: int = 8192,
                     device="cpu"):
    """The bf16 quantizer's whole input domain, as rows of bf16 [rows, width].

    A row's quantization depends only on its absmax ``a`` and each of its
    elements ``x``, with ``|x| <= a``, so the domain is every pair of
    finite bf16 values (a >= 0, |x| <= a): ~1.07e9 pairs for all 32,640
    absmax values.  For each absmax bit pattern in ``absmax_bits`` (default:
    every finite non-negative bf16, 0 to 0x7F7F), this yields rows that
    start with ``a`` followed by every x from +0 up to a and from -0 down to
    -a, in order, ``width - 1`` a row, zero-padded; the last chunk is padded
    with rows of zeros, so every chunk has the same shape.
    """
    ia = (torch.arange(BF16_FINITE, dtype=torch.int32, device=device)
          if absmax_bits is None else
          torch.as_tensor(absmax_bits, dtype=torch.int32, device=device))
    per = width - 1
    count = 2 * ia + 2                          # +0..a and -0..-a
    nrows = (count + per - 1) // per
    ends = torch.cumsum(nrows, 0, dtype=torch.int32)
    cols = torch.arange(per, dtype=torch.int32, device=device)
    for r0 in range(0, int(ends[-1]), rows):
        r = torch.arange(r0, r0 + rows, dtype=torch.int32, device=device)
        j = torch.searchsorted(ends, r, right=True)
        pad = j >= ia.numel()
        j = j.clamp_max(ia.numel() - 1)
        a = ia[j][:, None]
        t = (r - ends[j] + nrows[j])[:, None] * per + cols  # index into the x set
        xb = torch.where(t <= a, t, (t - a - 1) | 0x8000)
        xb = torch.where(t < 2 * a + 2, xb, 0)
        bits = torch.where(pad[:, None], 0, torch.cat([a, xb], 1))
        # 16-bit patterns as int16 (two's complement), seen as bf16
        yield (bits - ((bits >> 15) << 16)).to(torch.int16).view(torch.bfloat16)


def _no_grad(*tensors) -> None:
    """Raise where grad mode is on and an input requires a gradient: the
    int8 kernels have no backward, and their result would be detached."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError("the int8 kernels have no backward: call them on "
                         "tensors that do not require a gradient, or under "
                         "torch.no_grad()")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [N, D] (float32 or bfloat16) -> (int8 [N, D], float32 scales [N, 1]).

    ``quantize_int8.launches`` counts kernel launches.  The kernel has no
    backward: a CUDA call raises where grad mode is on and x requires a
    gradient.
    """
    if x.ndim != 2:
        raise ValueError(f"want x [N, D], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return quantize_int8_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 kernel for device {x.device}")
    _no_grad(x)
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

    ``dequantize_int8.launches`` counts kernel launches.  The kernel has
    no backward: a CUDA call raises where grad mode is on and the scales
    require a gradient.
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
    _no_grad(q, scales)
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
