"""Oracles in the TPU kernels' own layout ([B·H, S, ·] rows, [B, S, W] for
the RG-LRU), as written in the reference's ``kernels/ref.py``; tests hold the
kernels' plain versions against these as well as against the reference."""

from __future__ import annotations

import torch

NEG_INF = -2.0e38


def flash_attention_ref(q, k, v, *, n_heads, n_kv, causal=True, window=0,
                        logit_cap=0.0, scale=None):
    """q: [BH, S, hd]; k/v: [BKV, S, hd] — direct softmax attention."""
    bh, s, hd = q.shape
    g = n_heads // n_kv
    sc = (hd ** -0.5) if scale is None else scale
    kk = torch.repeat_interleave(k, g, dim=0).float()
    vv = torch.repeat_interleave(v, g, dim=0).float()
    sim = torch.einsum("bqh,bkh->bqk", q.float() * sc, kk)
    if logit_cap:
        sim = logit_cap * torch.tanh(sim / logit_cap)
    qp = torch.arange(s)[:, None]
    kp = torch.arange(s)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    sim = torch.where(mask[None].to(sim.device), sim, NEG_INF)
    p = torch.softmax(sim, dim=-1)
    return torch.einsum("bqk,bkh->bqh", p, vv).to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, cur_len, *, window=0,
                         logit_cap=0.0, scale=None):
    """q: [B,H,hd]; caches [B,S,KV,hd] — the reference model path's math.

    As the reference's oracle (its ``models.attention.decode_attention``):
    q is scaled in its own dtype and the probabilities are cast to the
    cache dtype before P·V, with float32 accumulation; ``cur_len`` is a
    scalar or [B].
    """
    b, s, kv, hd = k_cache.shape
    h = q.shape[1]
    sc = (hd ** -0.5) if scale is None else scale
    qg = q.reshape(b, kv, h // kv, hd) * torch.tensor(sc, dtype=q.dtype)
    sim = torch.einsum("bkgh,bskh->bkgs", qg.float(), k_cache.float())
    if logit_cap:
        sim = logit_cap * torch.tanh(sim / logit_cap)
    pos = torch.arange(s)
    cur = torch.as_tensor(cur_len).reshape(-1, 1)
    mask = pos[None, :] < cur
    if window > 0:
        mask &= pos[None, :] > cur - 1 - window
    mask = mask.expand(b, s).to(q.device)
    sim = torch.where(mask[:, None, None, :], sim, NEG_INF)
    p = torch.softmax(sim, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, h, hd).to(q.dtype)


def ssd_chunk_ref(x, dt, a, bm, cm):
    """x: [BH,S,P], dt: [BH,S], a: [BH], bm/cm: [BH,S,N] — O(S²) SSD."""
    dta = dt * a[:, None]                                  # [BH,S]
    cums = torch.cumsum(dta, dim=1)
    diff = cums[:, :, None] - cums[:, None, :]             # [BH,i,j]
    s = x.shape[1]
    tri = torch.tril(torch.ones((s, s), dtype=torch.bool, device=x.device))
    L = torch.where(tri[None], torch.exp(diff), 0.0)
    scores = torch.einsum("bin,bjn->bij", cm.float(), bm.float()) * L
    xbar = x.float() * dt[..., None]
    return torch.einsum("bij,bjp->bip", scores, xbar).to(x.dtype)


def rglru_ref(a, x):
    """Sequential recurrence h_t = a_t h_{t-1} + x_t. a/x: [B,S,W]."""
    h = torch.zeros((a.shape[0], a.shape[2]), dtype=torch.float32,
                    device=a.device)
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t].float() * h + x[:, t].float()
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype)


def quantize_int8_ref(x):
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=1, keepdim=True), 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8_ref(q, scales, dtype=torch.bfloat16):
    return (q.float() * scales).to(dtype)
