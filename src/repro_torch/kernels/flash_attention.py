"""K1, flash prefill attention: the Hopper kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py::
flash_attention`` (``_flash_kernel``): online-softmax attention over KV
blocks with float32 accumulation, causal mask, sliding ``window``, tanh
``logit_cap`` and grouped-query heads (query head h reads KV head
h // (H / KV)), fully masked blocks skipped.

What bounds it on the H100: at the serving shape (B=1, S=512, H=32, KV=8,
hd=128, bf16) the function reads q, k, v and writes o, 10.5 MB, 3.1 us at
3.35 TB/s; its causal products are 2.15 GFLOP, 2.2 us at the bf16 tensor
rate.  The kernel (``csrc/flash_attention.cu``) keeps the whole softmax
state in registers and never writes the S x S score matrix, so it moves only
those bytes.  Its bfloat16 instance (the model path) computes both products
on the tensor cores with ``wgmma`` (Q K^T from shared memory, P V with P in
registers, float32 accumulation) and streams K/V tiles through a 2-stage
``cp.async`` ring; its float32 instance keeps float32 FMAs from shared
memory (TF32 tensor cores could not meet the float32 tolerance).  Griffin's
local attention runs it at hd=256 (B=1, S=512, H=16, KV=1, window 2048),
Gemma-2 at hd=256 (H=16, KV=8, soft-cap 50, windows 4,096 and 0), MLA
(DeepSeek-V2) with a qk head dim of 192 against a v head dim of 128.

Training differentiates it: for CUDA tensors that need a gradient the
wrapper runs the float32 instance through an autograd function whose
forward also writes the rows' log-sum-exp and whose backward is a kernel of
its own (``csrc/flash_attention_bwd.cu``, head dims 8 to 128, hd = hd_v).
What bounds the backward: at Llama-3-8B's training shape (B=2, S=512,
H=32, KV=8, hd=128) its five products of the causal pairs are 10.8 GFLOP,
161 us at the float32 CUDA-core rate, against 84 MB moved (q, k, v, o, dO
and lse read once, dq, dk and dv written once; 25 us).

The wrapper takes the plain version only for tensors on the CPU (where
autograd differentiates it); for a CUDA tensor it launches the kernels or
raises.
"""

from __future__ import annotations

import torch

from . import build

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_lse",
           "flash_attention_bwd", "flash_attention_bwd_plain", "supported",
           "supported_bwd"]

NEG_INF = -2.0e38
_DTYPES = (torch.float32, torch.bfloat16)
# the kernel's instances: q, k and v of one head dim (8: the reduced
# deepseek-coder-33b, musicgen-medium and internvl2-1b; 256: Gemma-2,
# Griffin), and MLA's (qk head dim, v head dim) pairs, (192, 128) at full
# width and (24, 16) reduced
_HEAD_DIMS = (8, 16, 32, 64, 128, 256)
_QK_V_PAIRS = ((192, 128), (24, 16))
# the backward's instances: float32, hd = hd_v
_BWD_HEAD_DIMS = (8, 16, 32, 64, 128)


def supported(hd: int, hd_v: int) -> bool:
    """Whether the kernel is built for q/k of head dim ``hd`` and v of
    ``hd_v``."""
    return (hd == hd_v and hd in _HEAD_DIMS) or (hd, hd_v) in _QK_V_PAIRS


def supported_bwd(hd: int, hd_v: int, dtype) -> bool:
    """Whether the backward kernel is built for these head dims and dtype."""
    return dtype == torch.float32 and hd == hd_v and hd in _BWD_HEAD_DIMS


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"want q [B,S,H,hd], k [B,S,KV,hd], v [B,S,KV,hd_v]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, hd = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of {k.shape[2]} KV heads")
    if not (q.dtype == k.dtype == v.dtype) or not (q.device == k.device == v.device):
        raise ValueError("q, k and v must share dtype and device")


def _scores_plain(q, k, causal, window, logit_cap, scale):
    """Float32 scores [B,H,S,S] of the kernel's function: q scaled in
    float32, soft-capped, masked to NEG_INF; also tanh(raw / cap) (None
    without a cap) and the mask [S,S]."""
    s, hd = q.shape[1], q.shape[3]
    g = q.shape[2] // k.shape[2]
    sc = hd ** -0.5 if scale is None else scale
    qf = q.float().transpose(1, 2) * sc                        # [B,H,S,hd]
    kf = k.float().repeat_interleave(g, dim=2).transpose(1, 2)
    sim = qf @ kf.transpose(-1, -2)                            # [B,H,S,S]
    t = None
    if logit_cap:
        t = torch.tanh(sim / logit_cap)
        sim = logit_cap * t
    pos = torch.arange(s, device=q.device)
    qp, kp = pos[:, None], pos[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window > 0:
        mask &= kp > qp - window
    return sim.masked_fill(~mask, NEG_INF), t, mask


def flash_attention_plain(q, k, v, *, causal=True, window=0, logit_cap=0.0,
                          scale=None) -> torch.Tensor:
    """Direct softmax attention in float32; same function as the kernel.

    q [B,S,H,hd], k [B,S,KV,hd], v [B,S,KV,hd_v] -> [B,S,H,hd_v] in q's
    dtype.  q is scaled in float32 before the product, as the TPU kernel
    does.
    """
    _check(q, k, v)
    g = q.shape[2] // k.shape[2]
    sim, _, _ = _scores_plain(q, k, causal, window, logit_cap, scale)
    vf = v.float().repeat_interleave(g, dim=2).transpose(1, 2)
    out = torch.softmax(sim, dim=-1) @ vf                      # [B,H,S,hd]
    return out.transpose(1, 2).to(q.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal=True, window=0,
                              logit_cap=0.0, scale=None):
    """The backward kernel's formula in plain float32 PyTorch.

    From the forward's output ``o`` [B,S,H,hd] and row log-sum-exp ``lse``
    [B,H,S] and the output gradient ``do``: P = exp(s - lse) on the mask,
    D = rowsum(dO o), dV = P^T dO, dS = P (dO V^T - D) (1 - tanh^2 where
    soft-capped), dQ = scale dS K, dK = dS^T (scale q), dK and dV summed
    over the query heads of each KV head.  Returns (dq, dk, dv) in the
    dtypes of q, k, v.
    """
    _check(q, k, v)
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    sc = hd ** -0.5 if scale is None else scale
    sim, t, mask = _scores_plain(q, k, causal, window, logit_cap, scale)
    p = torch.exp(sim - lse.float()[..., None]).masked_fill(~mask, 0.0)
    dof = do.float().transpose(1, 2)                           # [B,H,S,hd_v]
    of = o.float().transpose(1, 2)
    delta = (dof * of).sum(-1, keepdim=True)                   # [B,H,S,1]
    qf = q.float().transpose(1, 2) * sc
    kf = k.float().repeat_interleave(g, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(g, dim=2).transpose(1, 2)
    dv = p.transpose(-1, -2) @ dof                             # [B,H,S,hd_v]
    ds = p * (dof @ vf.transpose(-1, -2) - delta)
    if t is not None:
        ds = ds * (1.0 - t * t)
    dq = (ds @ kf) * sc
    dk = ds.transpose(-1, -2) @ qf

    def heads_to_kv(x):                                        # [B,H,S,d] -> [B,S,KV,d]
        return x.reshape(b, kv, g, s, x.shape[-1]).sum(2).transpose(1, 2)

    return (dq.transpose(1, 2).to(q.dtype), heads_to_kv(dk).to(k.dtype),
            heads_to_kv(dv).to(v.dtype))


def _launch_fwd(q, k, v, causal, window, logit_cap, scale, with_lse: bool):
    """The forward kernel on CUDA tensors: o, and lse [B,H,S] (float32
    instance only) when ``with_lse``."""
    b, s, h, hd = q.shape
    hd_v = v.shape[3]
    if q.dtype not in _DTYPES or not supported(hd, hd_v):
        raise ValueError(f"kernel takes {_DTYPES} with hd = hd_v in "
                         f"{_HEAD_DIMS} or (hd, hd_v) in {_QK_V_PAIRS}; got "
                         f"{q.dtype}, hd={hd}, hd_v={hd_v}")
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for device {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("kernel takes contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("kernel takes 16-byte aligned q, k, v")
    if s == 0 or b == 0:
        raise ValueError("empty batch or sequence")
    if with_lse and q.dtype != torch.float32:
        raise ValueError("only the float32 instance writes lse")
    o = q.new_empty((b, s, h, hd_v))
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) \
        if with_lse else None
    lib = build.load()
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        int(q.dtype == torch.bfloat16), b, s, h, k.shape[2], hd, hd_v, int(causal),
        int(window), float(logit_cap), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return o, lse


def flash_attention_lse(q, k, v, *, causal=True, window=0, logit_cap=0.0,
                        scale=None):
    """(o, lse): the forward and its rows' log-sum-exp [B,H,S], float32.

    CPU tensors take the plain version; CUDA tensors launch the float32
    forward with its lse output (counted in ``flash_attention.launches``).
    """
    _check(q, k, v)
    sc = q.shape[3] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        sim, _, _ = _scores_plain(q, k, causal, window, logit_cap, sc)
        return (flash_attention_plain(q, k, v, causal=causal, window=window,
                                      logit_cap=logit_cap, scale=sc),
                torch.logsumexp(sim, dim=-1))
    return _launch_fwd(q, k, v, causal, window, logit_cap, sc, True)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, window=0,
                        logit_cap=0.0, scale=None):
    """(dq, dk, dv) of K1's function from the forward's o and lse.

    CPU tensors take :func:`flash_attention_bwd_plain`; CUDA tensors launch
    the backward kernel (contiguous float32, hd = hd_v in 8..128) or raise.
    ``flash_attention_bwd.launches`` counts its launches (one a call: the
    D, dK/dV and dQ kernels).
    """
    _check(q, k, v)
    b, s, h, hd = q.shape
    sc = hd ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=window, logit_cap=logit_cap,
                                         scale=sc)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for device {q.device}")
    if not supported_bwd(hd, v.shape[3], q.dtype):
        raise ValueError(f"the backward kernel takes float32 with hd = hd_v in "
                         f"{_BWD_HEAD_DIMS}; got {q.dtype}, hd={hd}, "
                         f"hd_v={v.shape[3]}")
    for name, t, shape, dt in (("o", o, q.shape, q.dtype), ("do", do, q.shape, q.dtype),
                               ("lse", lse, (b, h, s), torch.float32)):
        if tuple(t.shape) != tuple(shape) or t.dtype != dt or t.device != q.device:
            raise ValueError(f"{name}: want {dt} {tuple(shape)} on {q.device}; "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not all(t.is_contiguous() for t in (q, k, v, o, lse, do)):
        raise ValueError("the backward kernel takes contiguous tensors")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = build.load()
    err = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        do.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, s, h, k.shape[2], hd, int(causal), int(window),
        float(logit_cap), float(sc), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K1 with its gradient on CUDA tensors: the float32 forward saves o and
    lse; the backward is the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_cap, scale):
        o, lse = _launch_fwd(q, k, v, causal, window, logit_cap, scale, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, window=window, logit_cap=logit_cap,
                        scale=scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal=True, window=0, logit_cap=0.0,
                    scale=None) -> torch.Tensor:
    """Prefill attention: q [B,S,H,hd], k [B,S,KV,hd], v [B,S,KV,hd_v] ->
    [B,S,H,hd_v].

    CPU tensors take :func:`flash_attention_plain`; CUDA tensors launch the
    Hopper kernel (contiguous float32 or bfloat16, head dims that
    :func:`supported` names) or raise.  Where grad mode is on and an input
    requires a gradient, a CUDA call runs the float32 forward with lse and
    the backward kernel (:func:`supported_bwd`), and raises for any other
    dtype or head dims.  ``flash_attention.launches`` counts kernel
    launches.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     logit_cap=logit_cap, scale=scale)
    sc = q.shape[3] ** -0.5 if scale is None else scale
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if not supported_bwd(q.shape[3], v.shape[3], q.dtype):
            raise ValueError(f"no backward kernel for {q.dtype}, hd={q.shape[3]}, "
                             f"hd_v={v.shape[3]}: it takes float32 with hd = "
                             f"hd_v in {_BWD_HEAD_DIMS}")
        return _FlashAttention.apply(q, k, v, bool(causal), int(window),
                                     float(logit_cap), float(sc))
    return _launch_fwd(q, k, v, causal, window, logit_cap, sc, False)[0]


flash_attention.launches = 0
flash_attention_bwd.launches = 0
