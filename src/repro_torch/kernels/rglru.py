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

Training differentiates it: for CUDA tensors that need a gradient the
wrapper runs the float32 kernel through an autograd function that saves a,
h0 and its float32 output h, and whose backward is a kernel of its own
(``rglru_bwd`` in the same source), which replaces no TPU kernel (the
reference differentiates ``models/griffin.py::rglru``, an associative
scan): the reverse recurrence g_t = dy_t + a_{t+1} g_{t+1}, dx_t = g_t,
da_t = g_t h_{t-1}, dh0 = a_0 g_0.  What bounds it: bytes.  At Griffin's
training shape ([2, 512, 4096] float32) it reads dy, a and h and writes dx
and da, 83.9 MB, 25.0 us at 3.35 TB/s.  Its design is the forward's
reversed: per (lane, 64-step chunk) the chunk's local reverse carry and
its product of a, then each chunk again from the carry handed back by the
chunks after it.

The wrapper takes the plain version only for tensors on the CPU (where
autograd differentiates it); for a CUDA tensor it launches the kernels or
raises.
"""

from __future__ import annotations

import functools

import torch

from . import build

__all__ = ["rglru", "rglru_plain", "rglru_bwd", "rglru_bwd_plain"]

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


def rglru_bwd_plain(a, h, dy, h0=None):
    """The VJP of :func:`rglru_plain` from its float32 output ``h``, in
    float32: (da, dx, dh0 or None) with g_t = dy_t + a_{t+1} g_{t+1} (g past
    the end 0), dx_t = g_t, da_t = g_t h_{t-1} (h_{-1} = h0 or 0) and dh0 =
    a_0 g_0."""
    _check(a, h, h0)
    if tuple(dy.shape) != tuple(h.shape):
        raise ValueError(f"dy {tuple(dy.shape)} is not h's {tuple(h.shape)}")
    b, s, w = h.shape
    af, hf, dyf = a.float(), h.float(), dy.float()
    hprev = torch.cat([torch.zeros((b, 1, w), dtype=torch.float32, device=h.device)
                       if h0 is None else h0.float()[:, None], hf[:, :-1]], dim=1)
    dx = torch.empty((b, s, w), dtype=torch.float32, device=h.device)
    carry = torch.zeros((b, w), dtype=torch.float32, device=h.device)
    for t in reversed(range(s)):
        g = dyf[:, t] + carry
        dx[:, t] = g
        carry = af[:, t] * g
    return dx * hprev, dx, None if h0 is None else carry


@functools.lru_cache(maxsize=None)
def _chunk_steps() -> int:
    return int(build.load().rglru_chunk_steps())


def rglru(a, x, h0=None) -> torch.Tensor:
    """RG-LRU scan: a, x [B,S,W] -> h [B,S,W] in x's dtype; ``h0`` [B,W]
    float32 is the carried state before step 0 (zero when None).

    CPU tensors take :func:`rglru_plain`; CUDA tensors launch the Hopper
    kernel (contiguous float32 or bfloat16 a and x, contiguous float32 h0)
    or raise.  Where grad mode is on and an input requires a gradient, a
    CUDA call runs the float32 kernel through :class:`_RGLRU`, whose
    backward is :func:`rglru_bwd`, and raises for bfloat16.
    ``rglru.launches`` counts forward kernel launches.
    """
    _check(a, x, h0)
    if x.device.type == "cpu":
        return rglru_plain(a, x, h0)
    if x.device.type != "cuda":
        raise ValueError(f"no RG-LRU kernel for device {x.device}")
    _check_kernel_inputs(a, x, h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, x, h0)):
        if x.dtype != torch.float32:
            raise ValueError(f"no RG-LRU backward kernel for {x.dtype}: it "
                             "takes float32")
        return _RGLRU.apply(a, x, h0)
    return _launch(a, x, h0)


rglru.launches = 0


def _check_kernel_inputs(a, x, h0) -> None:
    if x.dtype not in _DTYPES or not (a.is_contiguous() and x.is_contiguous()):
        raise ValueError(f"kernel takes contiguous a, x in {_DTYPES}; got "
                         f"{x.dtype}")
    if h0 is not None and (h0.dtype != torch.float32 or not h0.is_contiguous()):
        raise ValueError(f"kernel takes a contiguous float32 h0; got {h0.dtype}")
    if x.numel() == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")


def _launch(a, x, h0) -> torch.Tensor:
    b, s, w = x.shape
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


def rglru_bwd(a, h, dy, h0=None):
    """(da, dx, dh0 or None) of the RG-LRU scan from its float32 output
    ``h`` and the cotangent ``dy``, all [B,S,W] (h0 [B,W]).

    CPU tensors take :func:`rglru_bwd_plain`; CUDA tensors launch the
    backward kernel (contiguous float32) or raise.  ``rglru_bwd.launches``
    counts its calls (one or two launches each: the chunk pass is skipped
    when S fits one chunk).
    """
    _check(a, h, h0)
    if h.device.type == "cpu":
        return rglru_bwd_plain(a, h, dy, h0)
    if h.device.type != "cuda":
        raise ValueError(f"no RG-LRU kernel for device {h.device}")
    if tuple(dy.shape) != tuple(h.shape) or dy.device != h.device:
        raise ValueError(f"dy {tuple(dy.shape)} on {dy.device} is not h's "
                         f"{tuple(h.shape)} on {h.device}")
    tensors = [t for t in (a, h, dy, h0) if t is not None]
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in tensors):
        raise ValueError("the backward kernel takes contiguous float32 a, h, "
                         "dy and h0")
    if h.numel() == 0:
        raise ValueError(f"empty input {tuple(h.shape)}")
    b, s, w = h.shape
    n_chunks = -(-s // _chunk_steps())
    ws = torch.empty(2 * b * n_chunks * w, dtype=torch.float32, device=h.device)
    da, dx = torch.empty_like(h), torch.empty_like(h)
    dh0 = None if h0 is None else torch.empty_like(h0)
    lib = build.load()
    err = lib.rglru_bwd(a.data_ptr(), h.data_ptr(), dy.data_ptr(),
                        None if h0 is None else h0.data_ptr(), ws.data_ptr(),
                        da.data_ptr(), dx.data_ptr(),
                        None if dh0 is None else dh0.data_ptr(), b, s, w,
                        torch.cuda.current_stream(h.device).cuda_stream)
    build.check(lib, err, "rglru_bwd")
    rglru_bwd.launches += 1
    return da, dx, dh0


rglru_bwd.launches = 0


class _RGLRU(torch.autograd.Function):
    """K5 with its gradient on CUDA tensors: the float32 forward saves a, h0
    and its output h; the backward is :func:`rglru_bwd`."""

    @staticmethod
    def forward(ctx, a, x, h0):
        out = _launch(a, x, h0)
        ctx.save_for_backward(a, out, h0)
        return out

    @staticmethod
    def backward(ctx, dy):
        a, out, h0 = ctx.saved_tensors
        da, dx, dh0 = rglru_bwd(a, out, dy.contiguous(), h0)
        return da, dx, dh0
