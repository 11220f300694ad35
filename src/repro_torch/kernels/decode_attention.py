"""K3, decode attention: the Hopper kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py::
decode_attention`` (``_decode_kernel``): one query token per sequence, q
[B,H,hd], against KV caches [B,S,KV,hd]; query head h reads KV head
h // (H / KV); keys at ``k_pos < cur_len`` count, and with a sliding
``window`` only those with ``k_pos > cur_len - 1 - window``; optional
``logit_cap * tanh(s / logit_cap)``; online softmax in float32; output
``acc / max(l, 1e-30)`` in q's dtype (0 where no key is valid).

``cur_len`` is a scalar or one value per row.  The Pallas kernel takes a
scalar only; the model path passes either (``pos + 1`` in decode).  The
kernel reads it from an int32 tensor on the card, so a decode step makes no
host sync for it.

What bounds it on the H100, on paper: bytes.  At the decode shape of the
generation path (B=8, cur_len 576, KV=8, hd=128, bf16) the cache read alone
is 18.9 MB, 5.6 us at 3.35 TB/s, against 75 MFLOP; measured, a fixed cost
per call and each block's per-stage reduction take more (PERF.md).  The
kernel (``csrc/decode_attention.cu``) is split-KV (flash-decoding) in one
launch: the grid is chunks of the cache x head groups x B, so the 64
(batch, KV head) pairs of that shape become 256 blocks, one wave of 2 an
SM; each block streams its chunk through a 4-stage ``cp.async`` ring,
writes a float32 partial, and the last block of each (batch, head group) to
finish combines the partials.  Chunks past ``cur_len`` or before the window
load nothing.

At hd 256 (Gemma-2's decode) a 16 KB stage holds 16 keys (a warp a bf16
row), the ring stays 4 stages deep and 2 blocks still fit an SM.  A block
takes at most 4 query heads (``heads_per_block``): at hd 256 8 heads'
float32 partials would outgrow the ring that the fold reuses, and at hd
128 8 heads' registers leave one block an SM, slower than two blocks of 4
(qwen3-moe's decode, G = 8; PERF.md).  At hd 8 one lane holds a bf16 key
row.

The wrapper keeps one zeroed counter buffer per card for those tickets (the
kernel leaves it at 0), so calls on one card must be ordered on one stream
(as the model path is), and a CUDA graph captures the call without a
memset.

The wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import functools
import math

import torch

from . import build, cost

__all__ = ["decode_attention", "decode_attention_plain", "split_plan"]

NEG_INF = -2.0e38
_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (8, 16, 32, 64, 128, 256)
SPLIT_MIN_KEYS = 64      # no chunk shorter than this many cache entries
BLOCKS_PER_SM = 2        # kernel blocks resident on an SM: one wave of them


def _check(q, k_cache, v_cache, cur_len) -> None:
    if q.ndim != 3 or k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"want q [B,H,hd], caches [B,S,KV,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    b, h, hd = q.shape
    if k_cache.shape[0] != b or k_cache.shape[3] != hd:
        raise ValueError(f"caches {tuple(k_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if h % k_cache.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of "
                         f"{k_cache.shape[2]} KV heads")
    if not (q.dtype == k_cache.dtype == v_cache.dtype) or \
            not (q.device == k_cache.device == v_cache.device):
        raise ValueError("q and the caches must share dtype and device")
    if isinstance(cur_len, torch.Tensor):
        if cur_len.dtype.is_floating_point or cur_len.dtype == torch.bool:
            raise ValueError(f"cur_len must be an integer tensor, not {cur_len.dtype}")
        if cur_len.ndim > 1 or (cur_len.ndim == 1 and cur_len.shape[0] != b):
            raise ValueError(f"cur_len must be a scalar or [{b}]; got "
                             f"{tuple(cur_len.shape)}")
        if cur_len.device != q.device:
            raise ValueError(f"cur_len lies on {cur_len.device}, q on {q.device}")


def decode_attention_plain(q, k_cache, v_cache, cur_len, *, window=0,
                           logit_cap=0.0, scale=None) -> torch.Tensor:
    """Direct softmax attention in float32; same function as the kernel.

    q [B,H,hd], caches [B,S,KV,hd], ``cur_len`` an int or an integer tensor
    of shape [] or [B] -> [B,H,hd] in q's dtype.
    """
    _check(q, k_cache, v_cache, cur_len)
    b, h, hd = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    sc = hd ** -0.5 if scale is None else scale
    qf = q.float().reshape(b, kv, h // kv, hd) * sc
    sim = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float())
    if logit_cap:
        sim = logit_cap * torch.tanh(sim / logit_cap)
    cur = torch.as_tensor(cur_len, device=q.device).long().reshape(-1, 1)
    pos = torch.arange(s, device=q.device)[None, :]
    mask = pos < cur
    if window > 0:
        mask &= pos > cur - 1 - window
    mask = mask.expand(b, s)[:, None, None, :]
    sim = sim.masked_fill(~mask, NEG_INF)
    # masked keys weigh exactly 0, also in a row with no valid key (-> 0)
    p = torch.exp(sim - sim.amax(dim=-1, keepdim=True)) * mask
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    out = out / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(b, h, hd).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def heads_per_block(g: int) -> int:
    """The kernel's GB, the query heads one block takes, passed to it: the
    largest of 4, 2, 1 that divides the group size g = H / KV."""
    return next(x for x in (4, 2, 1) if g % x == 0)


def split_plan(b: int, h: int, kv: int, s: int, n_sm: int) -> tuple[int, int]:
    """(n_split, chunk): how the kernel cuts the cache axis.

    As many chunks as one wave of ``BLOCKS_PER_SM`` blocks per SM holds (a
    second wave would wait for the first), none shorter than
    ``SPLIT_MIN_KEYS`` keys; chunk lengths are multiples of 16.  It depends
    on the shapes only, never on ``cur_len``'s value.
    """
    blocks = b * h // heads_per_block(h // kv)
    want = BLOCKS_PER_SM * n_sm // blocks
    n_split = max(1, min(want, math.ceil(s / SPLIT_MIN_KEYS)))
    chunk = 16 * math.ceil(math.ceil(s / n_split) / 16)
    return math.ceil(s / chunk), chunk


def _cur_len_tensor(cur_len, b: int, device: torch.device) -> torch.Tensor:
    if isinstance(cur_len, torch.Tensor):
        return cur_len.to(torch.int32).contiguous()
    # a fill on the card, not a host-to-device copy
    return torch.full((), int(cur_len), dtype=torch.int32, device=device)


def decode_attention(q, k_cache, v_cache, cur_len, *, window=0, logit_cap=0.0,
                     scale=None) -> torch.Tensor:
    """Decode attention: q [B,H,hd] vs caches [B,S,KV,hd] -> [B,H,hd].

    CPU tensors take :func:`decode_attention_plain`; CUDA tensors launch the
    Hopper kernel (contiguous float32 or bfloat16, hd in 8/16/32/64/128/256,
    ``cur_len`` an int or an integer tensor on q's card) or raise.
    ``decode_attention.launches`` counts kernel launches.  The kernel has
    no backward: a CUDA call raises where grad mode is on and q or a cache
    requires a gradient.
    """
    _check(q, k_cache, v_cache, cur_len)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cur_len,
                                      window=window, logit_cap=logit_cap,
                                      scale=scale)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"no decode attention kernel for device {q.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k_cache, v_cache)):
        raise ValueError("the decode attention kernel has no backward: call "
                         "it on tensors that do not require a gradient, or "
                         "under torch.no_grad()")
    b, h, hd = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    if q.dtype not in _DTYPES or hd not in _HEAD_DIMS:
        raise ValueError(f"kernel takes {_DTYPES} with hd in {_HEAD_DIMS}; "
                         f"got {q.dtype}, hd={hd}")
    if q.device.type == "meta":          # the dry-run's count, no launch
        # a meta cur_len has no value: the whole cache is counted, as at the
        # dry-run's decode position (the cache's last entry)
        cur = s if isinstance(cur_len, torch.Tensor) else int(cur_len)
        cur = min(cur, window) if window > 0 else cur
        o = torch.empty_like(q)
        cost.record("decode_attention", cost.decode_attention_ops(b, h, cur, hd),
                    cost.decode_attention_bytes(b, cur, kv, hd, q.numel(),
                                                q.element_size()))
        return o
    if not (q.is_contiguous() and k_cache.is_contiguous()
            and v_cache.is_contiguous()):
        raise ValueError("kernel takes contiguous q and caches")
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("kernel takes 16-byte aligned q and caches")
    if b == 0 or s == 0:
        raise ValueError("empty batch or cache")
    cur = _cur_len_tensor(cur_len, b, q.device)
    device = q.device
    gb = heads_per_block(h // kv)
    n_split, chunk = split_plan(b, h, kv, s, _sm_count(device.index))
    o = torch.empty_like(q)
    ws_ml = ws_acc = counters = 0                  # one split: no workspace
    if n_split > 1:
        rows = b * h * n_split
        ws = torch.empty(rows * (hd + 2), dtype=torch.float32, device=device)
        ws_acc, ws_ml = ws.data_ptr(), ws[rows * hd:].data_ptr()
        counters = build.counters("decode_attention", device, b * h).data_ptr()
    sc = hd ** -0.5 if scale is None else scale
    lib = build.load()
    err = lib.decode_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), cur.data_ptr(),
        int(cur.ndim == 1), o.data_ptr(), ws_ml, ws_acc, counters,
        int(q.dtype == torch.bfloat16), b, s, h, kv, hd, gb, n_split, chunk,
        int(window), float(logit_cap), float(sc),
        torch.cuda.current_stream(device).cuda_stream)
    build.check(lib, err, "decode_attention")
    decode_attention.launches += 1
    return o


decode_attention.launches = 0
