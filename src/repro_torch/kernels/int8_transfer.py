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

from . import build, cost

__all__ = ["quantize_int8", "dequantize_int8", "row_absmax", "quantize_int8_plain",
           "dequantize_int8_plain", "row_absmax_plain", "bf16_domain_rows",
           "BF16_FINITE"]

_DTYPES = (torch.float32, torch.bfloat16)
BF16_FINITE = 0x7F80    # bit patterns 0 .. 0x7F7F: +0 to the largest finite bf16


def row_absmax_plain(x: torch.Tensor) -> torch.Tensor:
    """x [N, D] -> each row's absmax, float32 [N, 1]."""
    return x.float().abs().amax(dim=1, keepdim=True)


def quantize_int8_plain(x: torch.Tensor, absmax: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [N, D] -> (int8 [N, D], float32 scales [N, 1]); ``absmax`` [N, 1]
    replaces each row's own (a row that several ranks hold pieces of)."""
    xf = x.float()
    if absmax is None:
        absmax = row_absmax_plain(xf)
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


def _check_rows(x: torch.Tensor) -> None:
    if x.ndim != 2:
        raise ValueError(f"want x [N, D], got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no int8 kernel for device {x.device}")
    if x.device.type != "cpu":
        _no_grad(x)
        if x.dtype not in _DTYPES or not x.is_contiguous() or x.numel() == 0:
            raise ValueError(f"kernel takes non-empty contiguous {_DTYPES}; "
                             f"got {x.dtype}, {tuple(x.shape)}")


def quantize_int8(x: torch.Tensor, absmax: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [N, D] (float32 or bfloat16) -> (int8 [N, D], float32 scales [N, 1]).

    ``absmax`` (float32 [N, 1]) gives each row's absmax instead of the
    kernel reducing its own (the kernel's given-absmax mode): a rank
    quantizing its piece of rows that other ranks hold pieces of passes the
    rows' absmax over all pieces (:func:`row_absmax`, reduced by MAX), and
    its codes and scales are then the whole rows'.

    ``quantize_int8.launches`` counts kernel launches, and
    ``quantize_int8.given_launches`` those of them in the given-absmax
    mode.  The kernel has no backward: a CUDA call raises where grad mode
    is on and x requires a gradient.
    """
    _check_rows(x)
    if absmax is not None and (absmax.shape != (x.shape[0], 1)
                               or absmax.dtype != torch.float32
                               or absmax.device != x.device):
        raise ValueError(f"want absmax float32 [{x.shape[0]}, 1] on {x.device}; "
                         f"got {absmax.dtype} {tuple(absmax.shape)}")
    if x.device.type == "cpu":
        return quantize_int8_plain(x, absmax)
    n, d = x.shape
    q = torch.empty((n, d), dtype=torch.int8, device=x.device)
    scales = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    if x.device.type == "meta":          # the dry-run's count, no launch
        cost.record("quantize_int8", cost.quantize_ops(n, d), cost.nbytes(x, q, scales))
        return q, scales
    lib = build.load()
    bf16 = int(x.dtype == torch.bfloat16)
    if absmax is None:
        err = lib.quantize_int8_fwd(x.data_ptr(), q.data_ptr(), scales.data_ptr(),
                                    bf16, n, d, _stream(x))
    else:
        err = lib.quantize_int8_given_fwd(
            x.data_ptr(), absmax.contiguous().data_ptr(), q.data_ptr(),
            scales.data_ptr(), bf16, n, d, _stream(x))
    build.check(lib, err, "quantize_int8")
    quantize_int8.launches += 1
    if absmax is not None:
        quantize_int8.given_launches += 1
    return q, scales


def row_absmax(x: torch.Tensor) -> torch.Tensor:
    """x [N, D] (float32 or bfloat16) -> each row's absmax, float32 [N, 1]:
    K2a's first pass alone (its absmax mode), for rows that several ranks
    hold pieces of.  ``row_absmax.launches`` counts kernel launches."""
    _check_rows(x)
    if x.device.type == "cpu":
        return row_absmax_plain(x)
    n, d = x.shape
    amax = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    if x.device.type == "meta":
        cost.record("row_absmax", float(n * d), cost.nbytes(x, amax))
        return amax
    lib = build.load()
    err = lib.row_absmax_fwd(x.data_ptr(), amax.data_ptr(),
                             int(x.dtype == torch.bfloat16), n, d, _stream(x))
    build.check(lib, err, "row_absmax")
    row_absmax.launches += 1
    return amax


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
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"no int8 kernel for device {q.device}")
    _no_grad(q, scales)
    if dtype not in _DTYPES or not (q.is_contiguous() and scales.is_contiguous()) \
            or q.numel() == 0:
        raise ValueError(f"kernel writes {_DTYPES} from non-empty contiguous "
                         f"inputs; got {dtype}, {tuple(q.shape)}")
    n, d = q.shape
    x = torch.empty((n, d), dtype=dtype, device=q.device)
    if q.device.type == "meta":          # the dry-run's count, no launch
        cost.record("dequantize_int8", cost.dequantize_ops(n, d),
                    cost.nbytes(q, scales, x))
        return x
    lib = build.load()
    err = lib.dequantize_int8_fwd(q.data_ptr(), scales.data_ptr(), x.data_ptr(),
                                  int(dtype == torch.bfloat16), n, d, _stream(q))
    build.check(lib, err, "dequantize_int8")
    dequantize_int8.launches += 1
    return x


quantize_int8.launches = 0
quantize_int8.given_launches = 0
dequantize_int8.launches = 0
row_absmax.launches = 0
