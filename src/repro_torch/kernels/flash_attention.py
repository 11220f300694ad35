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
those bytes.  Its bfloat16 instance (the model path, serving and
training) computes both products on the tensor cores with ``wgmma`` (Q K^T
from shared memory, P V with P in registers, float32 accumulation) and
streams K/V tiles through a 2-stage ``cp.async`` ring.  Its float32
instance (float32 training and every float32 check) is bound by its
products: 4.30 GFLOP at Llama-3-8B's training shape (B=2, S=512), 64 us on
the float32 CUDA cores, 26 us as 3xTF32 on the tensor cores.  One TF32
product misses the float32 tolerance, so it runs
both products as ``mma.sync`` TF32 in the 3xTF32 split of
``csrc/tf32x3.cuh``, as the backward does: q scaled and split once per
block, K and V split as loaded, streamed through ``cp.async`` copies that
overlap the products, P passed from the score accumulators to P V in
registers, the longest causal query tiles first.  Griffin's local attention runs it at hd=256 (B=1, S=512, H=16, KV=1, window
2048), Gemma-2 at hd=256 (H=16, KV=8, soft-cap 50, windows 4,096 and 0),
MLA (DeepSeek-V2) with a qk head dim of 192 against a v head dim of 128.

Training differentiates it: for CUDA tensors that need a gradient the
wrapper runs the forward of the inputs' dtype through an autograd function
whose forward also writes the rows' log-sum-exp (both instances write it)
and whose backward is a kernel of its own (``csrc/flash_attention_bwd.cu``,
float32 and bf16, at every pair the forward builds: hd = hd_v in 8 to 256
and MLA's (192, 128) and (24, 16)), which replaces no TPU kernel (the
reference differentiates its XLA attention).  Training runs bf16
activations, as the reference does, so the bf16 instances are its path; the
float32 ones serve float32 training and every float32 check.  What bounds
the backward: at Llama-3-8B's training shape (B=2, S=512, H=32, KV=8,
hd=128) its five products of the causal pairs are 10.76 GFLOP, 10.9 us at
the bf16 tensor rate against 42.1 MB moved in bf16 (q, k, v, o, dO read
once, lse float32, dq, dk and dv written once; 12.6 us): the bf16 instance
is bound by its bytes.  In float32 the same products, float32-accurate, are
161 us at the float32 CUDA-core rate or 65 us as 3xTF32 on the tensor cores
(3 TF32 products each, at 495 TFLOP/s), against 84.0 MB (25 us); Gemma-2's
and Griffin's training shapes at hd 256 (H=16) need the same 10.76 GFLOP,
MLA's (H=16, qk 192, v 128) 6.99.  The float32 instance runs every product
with ``mma.sync`` TF32 fragments in a 3xTF32 split (``csrc/tf32x3.cuh``: one
TF32 product misses the float32 tolerance, the split keeps float32 accuracy
at 2.5x the CUDA-core rate; ``wgmma`` would take TF32 operands only K-major
from shared memory, and the products read q, k, dO, P and dS in both
orientations); its dK/dV kernel walks the work items of
:func:`bwd_work_table`, one per (batch, query head, 64-key tile), longest
first, and the G query heads of a KV head write float32 partials that a
second pass sums in the order g = 0 .. G - 1.  Where one warp cannot hold
its rows' dK and dV (hd 256) two warps share each 16 rows by role.  The
bf16 instance runs every product on ``wgmma`` from 128-byte-swizzled
shared-memory tiles, as the forward does: s^T, dP^T (dK/dV) and s, dP (dQ)
with both operands in shared memory, dV, dK and dQ with P^T, dS^T or dS
rounded to bf16 in registers and dO, q or k read MN-major; 64-row steps
through a two-stage ``cp.async`` ring, each step's s and dP issued while
the last step's dV and dK (dQ) still run.  Its work items walk
:func:`bwd_heads_per_item` query heads of one KV head each, summing their
dK and dV in registers, so only the G / heads groups write float32
partials; the heads an item are the most that still leave
``BWD_MIN_ITEMS`` items to fill the card (measured: at Llama-3-8B's
training shape two heads an item beat one, twice the partials, and four,
too few items for the causal imbalance).  Where one
warpgroup cannot hold a tile's accumulators ((192, 128) and 256 in the
dK/dV kernel, 256 in the dQ kernel) two warpgroups share the tile by role.
Every output is written once after sums in a fixed order: the same bits
from run to run, no float atomics.

The wrapper takes the plain version only for tensors on the CPU (where
autograd differentiates it); for a CUDA tensor it launches the kernels or
raises.
"""

from __future__ import annotations

import functools

import torch

from . import build, cost

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_lse",
           "flash_attention_bwd", "flash_attention_bwd_plain", "bwd_work_table",
           "bwd_heads_per_item", "supported", "supported_bwd"]

NEG_INF = -2.0e38
_DTYPES = (torch.float32, torch.bfloat16)
# the kernel's instances: q, k and v of one head dim (8: the reduced
# deepseek-coder-33b, musicgen-medium and internvl2-1b; 256: Gemma-2,
# Griffin), and MLA's (qk head dim, v head dim) pairs, (192, 128) at full
# width and (24, 16) reduced
_HEAD_DIMS = (8, 16, 32, 64, 128, 256)
_QK_V_PAIRS = ((192, 128), (24, 16))
_BWD_TILE = 64                      # keys and query rows per tile of the backward
_BWD_TABLES: dict = {}              # (device, b, s, h, kv, causal, window, heads) -> table
# the fewest dK/dV work items the bf16 backward leaves when it gives an item
# more query heads (bwd_heads_per_item): one an SM; chosen by measurement
# against 1 (whole KV heads), 264 and one head an item (kernel_ab.py
# --sweep, PERF.md)
BWD_MIN_ITEMS = 132


def supported(hd: int, hd_v: int) -> bool:
    """Whether the kernel is built for q/k of head dim ``hd`` and v of
    ``hd_v``."""
    return (hd == hd_v and hd in _HEAD_DIMS) or (hd, hd_v) in _QK_V_PAIRS


def supported_bwd(hd: int, hd_v: int, dtype) -> bool:
    """Whether the backward kernel is built for these head dims and dtype:
    float32 or bfloat16, at every pair of :func:`supported`."""
    return dtype in _DTYPES and supported(hd, hd_v)


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

    From the forward's output ``o`` [B,S,H,hd_v] and row log-sum-exp ``lse``
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


def bwd_heads_per_item(b: int, s: int, h: int, kv: int) -> int:
    """Query heads a dK/dV work item of the bf16 backward walks: the largest
    divisor of G = h / kv that still leaves ``BWD_MIN_ITEMS`` items (b x kv
    x G / heads x 64-key tiles) to spread over the card, else 1.  More heads
    an item means fewer float32 partials (none at G); fewer heads, more
    items to fill the SMs under the causal imbalance."""
    g = h // kv
    n_items = b * kv * -(-s // _BWD_TILE)
    for heads in range(g, 0, -1):
        if g % heads == 0 and n_items * (g // heads) >= BWD_MIN_ITEMS:
            return heads
    return 1


@functools.lru_cache(maxsize=None)
def bwd_work_table(b: int, s: int, h: int, kv: int, causal: bool,
                   window: int, heads: int = 1) -> torch.Tensor:
    """The backward's dK/dV work items: int32 [n, 5] on the CPU, one row
    (b, first query head h0, key tile, first query tile, end query tile) per
    (b, group of ``heads`` query heads h0 .. h0 + heads - 1 of one KV head,
    64-key tile); the float32 kernel takes heads = 1.  The query tiles
    [first, end) are those that hold a (query, key) pair the mask keeps with
    a key of the tile, none other, the same for every head of the group.
    Rows come longest first (a stable sort: equal lengths in (key tile, b,
    h0) order, so the groups of a KV head run side by side)."""
    if b <= 0 or s <= 0 or h <= 0 or kv <= 0 or h % kv or heads <= 0 \
            or (h // kv) % heads:
        raise ValueError(f"no work table for b={b}, s={s}, h={h}, kv={kv}, "
                         f"heads={heads}")
    kt = torch.arange(-(-s // _BWD_TILE))
    first = kt * _BWD_TILE                                 # the tile's first key
    last = torch.clamp(first + _BWD_TILE - 1, max=s - 1)   # and its last
    # the queries a key k can see: [k (causal) or 0, k + window - 1 or S - 1]
    lo = first if causal else torch.zeros_like(first)
    hi = torch.clamp(last + window - 1, max=s - 1) if window > 0 else \
        torch.full_like(first, s - 1)
    q_begin, q_end = lo // _BWD_TILE, hi // _BWD_TILE + 1
    kt = kt[torch.argsort(q_begin - q_end, stable=True)]
    bb, hh, tt = torch.meshgrid(torch.arange(b), torch.arange(0, h, heads), kt,
                                indexing="ij")
    bb, hh, tt = (x.permute(2, 0, 1).reshape(-1) for x in (bb, hh, tt))
    return torch.stack([bb, hh, tt, q_begin[tt], q_end[tt]], 1).to(torch.int32)


def _bwd_table_on(device, b, s, h, kv, causal, window, heads) -> torch.Tensor:
    """:func:`bwd_work_table` on ``device``, copied there once."""
    key = (device, b, s, h, kv, bool(causal), int(window), heads)
    table = _BWD_TABLES.get(key)
    if table is None:
        table = bwd_work_table(b, s, h, kv, bool(causal), int(window), heads).to(device)
        _BWD_TABLES[key] = table
    return table


def _launch_fwd(q, k, v, causal, window, logit_cap, scale, with_lse: bool):
    """The forward kernel on CUDA tensors: o, and the float32 lse [B,H,S]
    when ``with_lse`` (either instance writes it)."""
    b, s, h, hd = q.shape
    hd_v = v.shape[3]
    if q.dtype not in _DTYPES or not supported(hd, hd_v):
        raise ValueError(f"kernel takes {_DTYPES} with hd = hd_v in "
                         f"{_HEAD_DIMS} or (hd, hd_v) in {_QK_V_PAIRS}; got "
                         f"{q.dtype}, hd={hd}, hd_v={hd_v}")
    if q.device.type == "meta":          # the dry-run's count, no launch
        o = q.new_empty((b, s, h, hd_v))
        lse = q.new_empty((b, h, s), dtype=torch.float32) if with_lse else None
        cost.record("flash_attention", cost.flash_attention_ops(
            b, s, h, hd, hd_v, causal, window), cost.nbytes(q, k, v, o, lse))
        return o, lse
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for device {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("kernel takes contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("kernel takes 16-byte aligned q, k, v")
    if s == 0 or b == 0:
        raise ValueError("empty batch or sequence")
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

    CPU tensors take the plain version; CUDA tensors launch the forward
    (float32 or bfloat16) with its lse output (counted in
    ``flash_attention.launches``).
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
    the backward kernel (q, k, v, o and do contiguous and of one dtype,
    float32 or bfloat16, lse float32; q, k, v, o and do 16-byte aligned; head
    dims that :func:`supported_bwd` names) or raise.  dq, dk and dv come
    out in q's dtype.
    ``flash_attention_bwd.launches`` counts its launches (one a call: the
    D, dK/dV, partial-sum (G > 1) and dQ kernels).
    """
    _check(q, k, v)
    b, s, h, hd = q.shape
    hd_v = v.shape[3]
    sc = hd ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=window, logit_cap=logit_cap,
                                         scale=sc)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"no flash attention kernel for device {q.device}")
    if not supported_bwd(hd, hd_v, q.dtype):
        raise ValueError(f"the backward kernel takes {_DTYPES} with hd = hd_v "
                         f"in {_HEAD_DIMS} or (hd, hd_v) in {_QK_V_PAIRS}; got "
                         f"{q.dtype}, hd={hd}, hd_v={hd_v}")
    for name, t, shape, dt in (("o", o, (b, s, h, hd_v), q.dtype),
                               ("do", do, (b, s, h, hd_v), q.dtype),
                               ("lse", lse, (b, h, s), torch.float32)):
        if tuple(t.shape) != tuple(shape) or t.dtype != dt or t.device != q.device:
            raise ValueError(f"{name}: want {dt} {tuple(shape)} on {q.device}; "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if q.device.type == "meta":          # the dry-run's count, no launch
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        cost.record("flash_attention_bwd", cost.flash_attention_bwd_ops(
            b, s, h, hd, hd_v, causal, window),
            cost.nbytes(q, k, v, o, lse, do, dq, dk, dv))
        return dq, dk, dv
    if not all(t.is_contiguous() for t in (q, k, v, o, lse, do)):
        raise ValueError("the backward kernel takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in (q, k, v, o, do)):
        raise ValueError("the backward kernel takes 16-byte aligned q, k, v, o, do")
    kv = k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    heads = bwd_heads_per_item(b, s, h, kv) if q.dtype == torch.bfloat16 else 1
    items = _bwd_table_on(q.device, b, s, h, kv, causal, window, heads)
    # the partials of the G / heads groups: dK [G / heads, B, S, KV, hd], then
    # dV [G / heads, B, S, KV, hd_v] (one group writes dk, dv directly)
    parts = h // kv // heads
    scratch = torch.empty(parts * b * s * kv * (hd + hd_v), dtype=torch.float32,
                          device=q.device) if parts > 1 else None
    lib = build.load()
    err = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        do.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), items.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        int(q.dtype == torch.bfloat16), b, s, h, kv, hd, hd_v,
        int(causal), int(window), items.shape[0], heads, float(logit_cap), float(sc),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K1 with its gradient on CUDA tensors: the forward (float32 or
    bfloat16) saves o and lse; the backward is the backward kernel of the
    same dtype."""

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
    requires a gradient, a CUDA call runs the forward with lse and the
    backward kernel of its dtype (:func:`supported_bwd`: bf16 training runs
    the bf16 instances, never the float32 ones), and raises for head dims
    no instance is built for.  ``flash_attention.launches`` counts kernel
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
                             f"hd_v={v.shape[3]}: it takes {_DTYPES} with hd = "
                             f"hd_v in {_HEAD_DIMS} or (hd, hd_v) in "
                             f"{_QK_V_PAIRS}")
        return _FlashAttention.apply(q, k, v, bool(causal), int(window),
                                     float(logit_cap), float(sc))
    return _launch_fwd(q, k, v, causal, window, logit_cap, sc, False)[0]


flash_attention.launches = 0
flash_attention_bwd.launches = 0
