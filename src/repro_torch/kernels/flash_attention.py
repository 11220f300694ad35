"""K1, flash prefill attention: the Hopper kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py::
flash_attention`` (``_flash_kernel``): online-softmax attention over KV
blocks with float32 accumulation, causal mask, sliding ``window``, tanh
``logit_cap`` and grouped-query heads (query head h reads KV head
h // (H / KV)), fully masked blocks skipped.

What bounds it on the H100: at the serving shape (B=1, S=512, H=32, KV=8,
hd=128, bf16) the function reads q, k, v and writes o, 10.5 MB, 3.1 us at
3.35 TB/s; its causal products are 2.15 GFLOP, 2.2 us at the bf16 tensor
rate.  Bytes bound it on paper.  The kernel (``csrc/flash_attention.cu``)
keeps the whole softmax state in registers and never writes the S x S score
matrix, so it moves only those bytes; its products are float32 FMAs from
shared memory, as the TPU kernel computes in float32, so in practice the
CUDA cores' float32 rate bounds this first version, not memory.

The wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import build

__all__ = ["flash_attention", "flash_attention_plain"]

NEG_INF = -2.0e38
_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (16, 32, 64, 128)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B,S,H,hd], k/v [B,S,KV,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, hd = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != hd:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of {k.shape[2]} KV heads")
    if not (q.dtype == k.dtype == v.dtype) or not (q.device == k.device == v.device):
        raise ValueError("q, k and v must share dtype and device")


def flash_attention_plain(q, k, v, *, causal=True, window=0, logit_cap=0.0,
                          scale=None) -> torch.Tensor:
    """Direct softmax attention in float32; same function as the kernel.

    q [B,S,H,hd], k/v [B,S,KV,hd] -> [B,S,H,hd] in q's dtype.  q is scaled in
    float32 before the product, as the TPU kernel does.
    """
    _check(q, k, v)
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    sc = hd ** -0.5 if scale is None else scale
    qf = q.float().transpose(1, 2) * sc                        # [B,H,S,hd]
    kf = k.float().repeat_interleave(g, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(g, dim=2).transpose(1, 2)
    sim = qf @ kf.transpose(-1, -2)                            # [B,H,S,S]
    if logit_cap:
        sim = logit_cap * torch.tanh(sim / logit_cap)
    pos = torch.arange(s, device=q.device)
    qp, kp = pos[:, None], pos[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window > 0:
        mask &= kp > qp - window
    sim = sim.masked_fill(~mask, NEG_INF)
    out = torch.softmax(sim, dim=-1) @ vf                      # [B,H,S,hd]
    return out.transpose(1, 2).to(q.dtype)


def flash_attention(q, k, v, *, causal=True, window=0, logit_cap=0.0,
                    scale=None) -> torch.Tensor:
    """Prefill attention: q [B,S,H,hd], k/v [B,S,KV,hd] -> [B,S,H,hd].

    CPU tensors take :func:`flash_attention_plain`; CUDA tensors launch the
    Hopper kernel (contiguous float32 or bfloat16, hd in 16/32/64/128) or
    raise.  ``flash_attention.launches`` counts kernel launches.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     logit_cap=logit_cap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for device {q.device}")
    b, s, h, hd = q.shape
    if q.dtype not in _DTYPES or hd not in _HEAD_DIMS:
        raise ValueError(f"kernel takes {_DTYPES} with hd in {_HEAD_DIMS}; "
                         f"got {q.dtype}, hd={hd}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("kernel takes contiguous q, k, v")
    if s == 0 or b == 0:
        raise ValueError("empty batch or sequence")
    sc = hd ** -0.5 if scale is None else scale
    o = torch.empty_like(q)
    lib = build.load()
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        int(q.dtype == torch.bfloat16), b, s, h, k.shape[2], hd, int(causal),
        int(window), float(logit_cap), float(sc),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
