"""K4, the Mamba-2 SSD chunk scan: the Hopper kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_chunk.py::ssd_chunk``
(``_ssd_kernel``) together with the model-layout wrapper ``ops.ssd``: per
chunk of Q steps, ``cums = cumsum(dt·A)``, ``L = tril(exp(cums_i −
cums_j))``, ``y = ((C Bᵀ)∘L)(dt·x) + (C∘e^{cums}) S`` and the float32
state ``S ← S·e^{cums[-1]} + (B∘e^{cums[-1]−cums})ᵀ(dt·x)`` carried across
chunks.  Beyond the TPU kernel it seeds S from ``state_in`` and returns the
final S, as the model path (``models/mamba2.py::ssd_chunked``) needs for
chunked prefill and decode.  B and C are per group; head h reads group
h // (H / G), in the kernel, with no repeat.

What bounds it on the H100: at the Mamba-2 prefill shape (B=1, S=512,
H=64, P=64, G=1, N=128, chunk 256, bf16, final state returned) it moves
10.8 MB (3.2 us at 3.35 TB/s) against ~1.6 GFLOP of products that this
input needs (the lower triangles, C Bᵀ once per group).  The kernel
(``csrc/ssd_chunk.cu``) computes C Bᵀ once per (batch, group, chunk), then
runs one block per (batch·head, 16 state columns), 256 blocks at that
shape, each walking its chunks with its slice of S in shared memory; its
products are float32 FMAs, as the TPU kernel computes in float32.

The wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build

__all__ = ["ssd", "ssd_plain"]

_DTYPES = (torch.float32, torch.bfloat16)
MAX_STATE = 256       # the kernel keeps up to 16 x 16 state rows per thread
MAX_CHUNK = 1024      # its chunk buffers must fit in a block's shared memory


def _check(x, dt, A, Bm, Cm, state_in) -> None:
    if x.ndim != 4 or dt.ndim != 3 or A.ndim != 1 or Bm.ndim != 4 \
            or Bm.shape != Cm.shape:
        raise ValueError(f"want x [B,S,H,P], dt [B,S,H], A [H], B/C [B,S,G,N]; "
                         f"got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}, {tuple(Bm.shape)}, {tuple(Cm.shape)}")
    b, s, h, p = x.shape
    if tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,) \
            or tuple(Bm.shape[:2]) != (b, s):
        raise ValueError(f"dt {tuple(dt.shape)}, A {tuple(A.shape)} or B/C "
                         f"{tuple(Bm.shape)} do not match x {tuple(x.shape)}")
    if h % Bm.shape[2]:
        raise ValueError(f"{h} heads are not a multiple of {Bm.shape[2]} groups")
    if state_in is not None and tuple(state_in.shape) != (b, h, Bm.shape[3], p):
        raise ValueError(f"state_in {tuple(state_in.shape)} is not "
                         f"{(b, h, Bm.shape[3], p)}")
    tensors = [t for t in (x, dt, A, Bm, Cm, state_in) if t is not None]
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, dt, A, B, C and state_in must share a device")


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """L[i,j] = sum_{j<k<=i} x[k] for i>=j else -inf.  x: [..., Q]."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_plain(x, dt, A, Bm, Cm, *, chunk: int, state_in=None,
              return_state: bool = False):
    """Chunked SSD in float32, the reference model path's arithmetic.

    x [B,S,H,P], dt [B,S,H], A [H], Bm/Cm [B,S,G,N], optional state_in
    [B,H,N,P] -> y [B,S,H,P] in x's dtype (and the float32 final state).
    The ragged S edge is zero-padded with dt = 0, which leaves the state as
    it is.
    """
    _check(x, dt, A, Bm, Cm, state_in)
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    nc = x.shape[1] // q
    xc = x.reshape(b, nc, q, h, p).float()
    dtc = dt.reshape(b, nc, q, h).float()
    Bc = Bm.reshape(b, nc, q, g, n).repeat_interleave(rep, dim=3).float()
    Cc = Cm.reshape(b, nc, q, g, n).repeat_interleave(rep, dim=3).float()
    state = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
             if state_in is None else state_in.float())
    A = A.float()
    ys = []
    for c in range(nc):
        xq, dtq, Bq, Cq = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        dtA = dtq * A[None, None, :]                          # [B,q,H]
        cums = torch.cumsum(dtA, dim=1)
        L = torch.exp(_segsum(dtA.transpose(1, 2)))           # [B,H,q,q]
        scores = torch.einsum("bihn,bjhn->bhij", Cq, Bq) * L
        xbar = xq * dtq[..., None]
        y_intra = torch.einsum("bhij,bjhp->bihp", scores, xbar)
        decay_i = torch.exp(cums)                             # [B,q,H]
        y_inter = torch.einsum("bihn,bhnp->bihp", Cq * decay_i[..., None], state)
        decay_out = torch.exp(cums[:, -1:, :] - cums)
        state_c = torch.einsum("bjhn,bjhp->bhnp", Bq * decay_out[..., None], xbar)
        state = state * torch.exp(cums[:, -1, :])[:, :, None, None] + state_c
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, nc * q, h, p)[:, :s].to(x.dtype)
    return (y, state) if return_state else y


def _last_two_contiguous(t: torch.Tensor) -> bool:
    return t.stride(3) == 1 and t.stride(2) == t.shape[3]


def ssd(x, dt, A, Bm, Cm, *, chunk: int = 256, state_in=None,
        return_state: bool = False):
    """SSD: x [B,S,H,P], dt [B,S,H] float32, A [H] float32, Bm/Cm [B,S,G,N]
    -> y [B,S,H,P] in x's dtype, and the float32 final state [B,H,N,P] if
    ``return_state``; ``state_in`` [B,H,N,P] float32 seeds the state.

    CPU tensors take :func:`ssd_plain`; CUDA tensors launch the Hopper
    kernel (x, B, C float32 or bfloat16 with their last two dims contiguous;
    N <= 256, chunk <= 1024) or raise.  ``ssd.launches`` counts kernel
    launches.
    """
    _check(x, dt, A, Bm, Cm, state_in)
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if x.device.type == "cpu":
        return ssd_plain(x, dt, A, Bm, Cm, chunk=chunk, state_in=state_in,
                         return_state=return_state)
    if x.device.type != "cuda":
        raise ValueError(f"no SSD kernel for device {x.device}")
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    q = min(chunk, s)
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"kernel takes x, B, C of one dtype in {_DTYPES}; got "
                         f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32 or (
            state_in is not None and state_in.dtype != torch.float32):
        raise ValueError("kernel takes dt, A and state_in in float32")
    if not (_last_two_contiguous(x) and _last_two_contiguous(Bm)
            and _last_two_contiguous(Cm) and dt.is_contiguous()
            and A.is_contiguous()
            and (state_in is None or state_in.is_contiguous())):
        raise ValueError("kernel takes x, B, C with contiguous last two dims "
                         "and contiguous dt, A, state_in")
    if n > MAX_STATE or q > MAX_CHUNK or b == 0 or s == 0:
        raise ValueError(f"kernel takes 0 < N <= {MAX_STATE}, chunk <= "
                         f"{MAX_CHUNK} and a non-empty input; got N={n}, "
                         f"chunk {q}, {tuple(x.shape)}")
    nc = -(-s // q)
    cb = torch.empty(b * g * nc * q * q, dtype=torch.float32, device=x.device)
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state_out = (torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
                 if return_state else None)
    lib = build.load()
    err = lib.ssd_chunk_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        None if state_in is None else state_in.data_ptr(), y.data_ptr(),
        None if state_out is None else state_out.data_ptr(), cb.data_ptr(),
        int(x.dtype == torch.bfloat16), b, s, h, g, n, p, q,
        x.stride(0), x.stride(1), Bm.stride(0), Bm.stride(1), Cm.stride(0),
        Cm.stride(1), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "ssd")
    ssd.launches += 1
    return (y, state_out) if return_state else y


ssd.launches = 0
