"""Oracles in the TPU kernels' own layout ([B·H, S, hd] rows), as written in
the reference's ``kernels/ref.py``; tests hold the kernels' plain versions
against these as well as against the reference."""

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


def quantize_int8_ref(x):
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=1, keepdim=True), 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8_ref(q, scales, dtype=torch.bfloat16):
    return (q.float() * scales).to(dtype)
