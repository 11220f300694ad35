"""K1's backward kernel, its plan and its arithmetic, on the CPU.

The kernel (``csrc/flash_attention_bwd.cu``) runs only on the card; what
decides its result besides the card's arithmetic is checked here:

- the dK/dV work table (``flash_attention.bwd_work_table``): every (b, h,
  key tile, query tile) pair the mask keeps appears in exactly one item, no
  dead tile appears, and items come longest first;
- the table executed item by item with the plain formulas, the G partials
  of a KV head summed in the order g = 0 .. G - 1, equals
  ``flash_attention_bwd_plain`` to 1e-6 of the largest gradient;
- the 3xTF32 split the kernel runs its five products in, emulated in torch
  (TF32 keeps 10 mantissa bits; rounding to nearest, ties away from zero,
  is ``cvt.rna.tf32.f32``'s), meets the kernel's tolerance, 1e-4 of the
  largest gradient against float64, where one TF32 product (rounded to
  nearest) does not: at Llama-3-8B's hd 128, Gemma-2's hd 256 (soft-cap 50)
  and MLA's qk 192 / v 128;
- the bf16 instance's arithmetic (bf16 operands, P and dS rounded to bf16
  as operands, float32 sums, outputs rounded once), emulated, meets its
  bf16 tolerance, 2e-2 of the largest gradient against float64, and not
  the float32 one, at hd 128, hd 256 with the soft-cap and both MLA pairs;
- the rule that picks one warp or a pair of warps a 16-row group for each
  type (read from the source) is the measured one.

At hd 256 the kernel's two warps of a 16-row group split the work by role
(one computes P and dV, the other dP, dS and dK; in the dQ kernel each keeps
half of dQ's columns): every sum runs over the same terms in the same order
as with one warp, so the walk checked here is the same.

The card holds the kernel itself against the plain version
(tests/test_torch_kernels_cuda.py::test_flash_bwd_kernel_matches_plain).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as k1

TILE = 64
# (b, s, h, kv, hd, hd_v, causal, window, cap, scale): the card test's eight
# shapes, then S = 512 at G = 4 and S = 1, then the wide instances: hd 256
# GQA with Gemma-2's soft-cap and scale, hd 256 MQA at G = 16 with a window
# (Griffin), MLA's qk 192 / v 128 and, ragged at G = 3, 24 / 16
SHAPES = [
    (2, 512, 32, 8, 128, 128, True, 0, 0.0, None),
    (8, 256, 8, 8, 64, 64, True, 0, 0.0, None),
    (2, 100, 4, 2, 32, 32, True, 16, 50.0, 16.0 ** -0.5),
    (2, 77, 7, 1, 8, 8, True, 0, 0.0, None),
    (1, 130, 4, 2, 16, 16, True, 48, 0.0, None),
    (2, 96, 4, 4, 64, 64, False, 0, 30.0, None),
    (1, 200, 8, 2, 128, 128, True, 64, 20.0, None),
    (1, 65, 2, 1, 32, 32, False, 24, 0.0, None),
    (1, 512, 8, 2, 64, 64, True, 0, 0.0, None),
    (2, 1, 4, 2, 16, 16, True, 0, 0.0, None),
    (2, 192, 8, 4, 256, 256, True, 100, 50.0, 224.0 ** -0.5),
    (1, 200, 16, 1, 256, 256, True, 64, 0.0, None),
    (2, 160, 4, 4, 192, 128, True, 0, 0.0, None),
    (2, 77, 6, 2, 24, 16, True, 0, 0.0, None),
]


def _mask(s, causal, window):
    pos = torch.arange(s)
    qp, kp = pos[:, None], pos[None, :]
    keep = torch.ones((s, s), dtype=torch.bool)
    if causal:
        keep &= kp <= qp
    if window > 0:
        keep &= kp > qp - window
    return keep


def _inputs(b, s, h, kv, hd, seed, hd_v=None):
    """q, k [.., hd], v and dO [.., hd_v] (hd_v = hd by default)."""
    rng = np.random.default_rng(seed)
    hd_v = hd if hd_v is None else hd_v
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd_v),
                          (b, s, h, hd_v))]


@pytest.mark.parametrize("b,s,h,kv,hd,hd_v,causal,window,cap,scale", SHAPES)
def test_work_table_covers_live_tiles_longest_first(b, s, h, kv, hd, hd_v, causal,
                                                    window, cap, scale):
    table = k1.bwd_work_table(b, s, h, kv, causal, window)
    n_t = -(-s // TILE)
    assert table.dtype == torch.int32 and tuple(table.shape) == (b * h * n_t, 5)
    # tile (query tile, key tile) is live iff it holds a pair the mask keeps
    keep = torch.zeros((n_t * TILE, n_t * TILE), dtype=torch.bool)
    keep[:s, :s] = _mask(s, causal, window)
    live = keep.reshape(n_t, TILE, n_t, TILE).any(3).any(1)     # [qt, kt]
    want = {(bi, hi, kt, qt) for bi in range(b) for hi in range(h)
            for qt, kt in live.nonzero().tolist()}
    got = [(bi, hi, kt, qt) for bi, hi, kt, q0, q1 in table.tolist()
           for qt in range(q0, q1)]
    assert len(got) == len(set(got))                    # each pair once
    assert set(got) == want                             # every live one, no dead one
    items = {(bi, hi, kt) for bi, hi, kt, _, _ in table.tolist()}
    assert len(items) == b * h * n_t                    # one item per (b, h, key tile)
    lengths = (table[:, 4] - table[:, 3]).tolist()
    assert lengths == sorted(lengths, reverse=True)     # longest first
    assert min(lengths) >= 1


def _run_table(q, k, v, o, lse, do, causal, window, cap, scale):
    """dK, dV from the work table, item by item with the plain formulas:
    each item writes the partials of its keys for its query head's slot g
    of the scratches [G, B, S, KV, hd] and [G, B, S, KV, hd_v], then the G
    slots are summed in the order g = 0 .. G - 1."""
    b, s, h, hd = q.shape
    kv, hd_v = k.shape[2], v.shape[3]
    g = h // kv
    sc = hd ** -0.5 if scale is None else scale
    keep = _mask(s, causal, window)
    delta = (do * o).sum(-1)                                  # [b, s, h]
    part = [torch.zeros((g, b, s, kv, hd)), torch.zeros((g, b, s, kv, hd_v))]
    written = torch.zeros((g, b, s, kv), dtype=torch.int64)
    for bi, hi, kt, q0, q1 in k1.bwd_work_table(b, s, h, kv, causal, window).tolist():
        keys = slice(kt * TILE, min(s, kt * TILE + TILE))
        rows = slice(q0 * TILE, min(s, q1 * TILE))
        qh, doh = q[bi, rows, hi], do[bi, rows, hi]
        kh, vh = k[bi, keys, hi // g], v[bi, keys, hi // g]
        raw = (qh * sc) @ kh.T
        dcap = torch.ones_like(raw)
        if cap:
            t = torch.tanh(raw / cap)
            raw, dcap = cap * t, 1.0 - t * t
        p = torch.exp(raw - lse[bi, hi, rows][:, None]).masked_fill(~keep[rows, keys], 0.0)
        ds = p * dcap * (doh @ vh.T - delta[bi, rows, hi][:, None])
        part[0][hi % g, bi, keys, hi // g] = ds.T @ (qh * sc)
        part[1][hi % g, bi, keys, hi // g] = p.T @ doh
        written[hi % g, bi, keys, hi // g] += 1
    assert bool((written == 1).all())                   # every partial row once
    dk, dv = part[0][0].clone(), part[1][0].clone()
    for gi in range(1, g):
        dk, dv = dk + part[0][gi], dv + part[1][gi]
    return dk, dv


@pytest.mark.parametrize("b,s,h,kv,hd,hd_v,causal,window,cap,scale", SHAPES)
def test_work_table_executed_on_cpu_equals_plain(b, s, h, kv, hd, hd_v, causal,
                                                 window, cap, scale):
    q, k, v, do = _inputs(b, s, h, kv, hd, seed=s + h, hd_v=hd_v)
    kw = dict(causal=causal, window=window, logit_cap=cap, scale=scale)
    o, lse = k1.flash_attention_lse(q, k, v, **kw)
    _, dk_want, dv_want = k1.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    dk, dv = _run_table(q, k, v, o, lse, do, causal, window, cap, scale)
    # the largest gradient of the two: at S = 1, dK is 0 up to rounding
    largest = max(float(dk_want.abs().max()), float(dv_want.abs().max()))
    for got, want in ((dk, dk_want), (dv, dv_want)):
        assert float((got - want).abs().max()) <= 1e-6 * largest


def _tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest, ties away from
    zero: cvt.rna.tf32.f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x, kernel):
    """(big, small), x ~= big + small, both TF32.  The kernel's split
    (tf32x3.cuh) clears big's low 13 bits and rounds small to nearest (half
    a TF32 ulp added, the tensor core truncating); the other rounds both
    to nearest, as cvt.rna does."""
    big = (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32) \
        if kernel else _tf32(x)
    return big, _tf32(x - big)


def _product(a, b, mode):
    """a @ b in float64, float32, one TF32 product, a 3xTF32 split (the
    two cross terms first, then big * big): the kernel's, or both parts
    rounded to nearest; or with both operands rounded to bf16 and float32
    sums (the bf16 instance's mma.sync.m16n8k16)."""
    if mode in ("f64", "f32"):
        return a @ b
    if mode == "bf16":
        return a.bfloat16().float() @ b.bfloat16().float()
    if mode == "tf32":
        return _tf32(a) @ _tf32(b)
    (a_big, a_small), (b_big, b_small) = (_split(x, mode == "3xtf32") for x in (a, b))
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def _emulated_bwd(q, k, v, o, lse, do, scale, mode, cap=0.0):
    """The kernel's backward for one head group (q [H, S, hd], o, do
    [H, S, hd_v]; k [S, hd], v [S, hd_v]; lse [H, S]; causal, soft-capped at
    ``cap`` if set) with its five products in ``mode``."""
    dt = torch.float64 if mode == "f64" else torch.float32
    q, k, v, o, lse, do = (x.to(dt) for x in (q, k, v, o, lse, do))
    s = q.shape[1]
    keep = _mask(s, True, 0)
    raw = scale * _product(q, k.T, mode)                        # [H, S, S]
    dcap = 1.0
    if cap:
        t = torch.tanh(raw / cap)
        raw, dcap = cap * t, 1.0 - t * t
    p = torch.exp(raw - lse[..., None]).masked_fill(~keep, 0.0)
    delta = (do * o).sum(-1, keepdim=True)
    ds = p * dcap * (_product(do, v.T, mode) - delta)
    dv = _product(p.transpose(1, 2), do, mode).sum(0)
    dk = scale * _product(ds.transpose(1, 2), q, mode).sum(0)
    dq = scale * _product(ds, k, mode)
    if mode == "bf16":                        # rounded once, when stored
        return tuple(x.bfloat16() for x in (dq, dk, dv))
    return dq, dk, dv


@pytest.mark.parametrize("mode,meets", [("3xtf32", True), ("3xtf32 rna", True),
                                        ("f32", True), ("tf32", False)])
def test_3xtf32_products_meet_the_gradient_tolerance(mode, meets):
    """Llama-3-8B's training shape cut to one head group (S=512, hd 128,
    G=4, causal), unit-normal inputs, against float64: the kernel's 3xTF32
    split, the split with both parts rounded to nearest, and float32 meet
    the kernel's 1e-4 of the largest gradient (all near 6e-7); one TF32
    product misses it (3e-4 to 8e-4), which is why the kernel splits."""
    q, k, v, do = _inputs(1, 512, 4, 1, 128, seed=7)
    o, lse = k1.flash_attention_lse(q, k, v)
    scale = 128 ** -0.5
    args = (q[0].transpose(0, 1), k[0, :, 0], v[0, :, 0], o[0].transpose(0, 1),
            lse[0], do[0].transpose(0, 1), scale)
    truth = _emulated_bwd(*args, "f64")
    got = _emulated_bwd(*args, mode)
    err = max(float((g.double() - t).abs().max() / t.abs().max())
              for g, t in zip(got, truth))
    assert (err <= 1e-4) == meets, err


@pytest.mark.parametrize("mode,meets", [("3xtf32", True), ("tf32", False)])
@pytest.mark.parametrize("g,hd,hd_v,cap,scale", [
    (2, 256, 256, 50.0, 224.0 ** -0.5),       # Gemma-2-9B: G = 2, soft-cap 50
    (1, 192, 128, 0.0, 192 ** -0.5),          # DeepSeek-V2-Lite's MLA
], ids=["gemma2-hd256", "mla-192-128"])
def test_3xtf32_products_meet_the_gradient_tolerance_at_wide_heads(
        g, hd, hd_v, cap, scale, mode, meets):
    """The wide instances' training shapes cut to one head group (S=512,
    causal), unit-normal inputs, against float64: the kernel's 3xTF32 split
    meets 1e-4 of each gradient's largest value; one TF32 product misses
    it."""
    q, k, v, do = _inputs(1, 512, g, 1, hd, seed=11, hd_v=hd_v)
    kw = dict(logit_cap=cap, scale=scale)
    o, lse = k1.flash_attention_lse(q, k, v, **kw)
    args = (q[0].transpose(0, 1), k[0, :, 0], v[0, :, 0], o[0].transpose(0, 1),
            lse[0], do[0].transpose(0, 1), scale)
    truth = _emulated_bwd(*args, "f64", cap=cap)
    got = _emulated_bwd(*args, mode, cap=cap)
    err = max(float((u.double() - t).abs().max() / t.abs().max())
              for u, t in zip(got, truth))
    assert (err <= 1e-4) == meets, err


@pytest.mark.parametrize("g,hd,hd_v,cap,scale", [
    (4, 128, 128, 0.0, 128 ** -0.5),          # Llama-3-8B: G = 4
    (2, 256, 256, 50.0, 224.0 ** -0.5),       # Gemma-2-9B: soft-cap 50
    (1, 192, 128, 0.0, 192 ** -0.5),          # DeepSeek-V2-Lite's MLA
    (2, 24, 16, 0.0, 24 ** -0.5),             # MLA reduced (qk padded to 32)
], ids=["llama-hd128", "gemma2-hd256", "mla-192-128", "mla-24-16"])
def test_bf16_products_meet_the_bf16_tolerance(g, hd, hd_v, cap, scale):
    """The bf16 instance's arithmetic, emulated: q, k, v, dO (and o) in
    bf16, every product with bf16 operands and float32 sums (P and dS
    rounded to bf16 as operands), dq, dk, dv rounded once.  Against float64
    from the same bf16 inputs, S=512 causal, it meets the kernel's bf16
    tolerance, 2e-2 of each gradient's largest value, and not the float32
    one (1e-4): bf16 training is held to its own tolerance.  The zero
    columns the kernel pads head dims with (24 -> 32) add nothing to a
    product, so the padded walk is this one."""
    q, k, v, do = (x.bfloat16().float()
                   for x in _inputs(1, 512, g, 1, hd, seed=13, hd_v=hd_v))
    kw = dict(logit_cap=cap, scale=scale)
    o, lse = k1.flash_attention_lse(q, k, v, **kw)
    o = o.bfloat16().float()                  # the bf16 forward's output
    args = (q[0].transpose(0, 1), k[0, :, 0], v[0, :, 0], o[0].transpose(0, 1),
            lse[0], do[0].transpose(0, 1), scale)
    truth = _emulated_bwd(*args, "f64", cap=cap)
    got = _emulated_bwd(*args, "bf16", cap=cap)
    err = max(float((u.double() - t).abs().max() / t.abs().max())
              for u, t in zip(got, truth))
    assert 1e-4 < err <= 2e-2, err


def test_each_type_splits_rows_where_it_measured_faster():
    """The kernel's ``n_split`` (read from csrc/flash_attention_bwd.cu):
    float32 pairs two warps on 16 rows only at hd 256, bf16 from qk 192 on
    (kernel_ab.py against builds with the rule changed, PERF.md); every
    instance's dQ columns divide between the pair."""
    src = (pathlib.Path(k1.__file__).with_name("csrc") /
           "flash_attention_bwd.cu").read_text()
    bf16_from, f32_from = map(int, re.search(
        r"constexpr int n_split\(\) \{\s*return sizeof\(T\) == 2 \? "
        r"\(DQK > (\d+) \? 2 : 1\) : \(DQK > (\d+) \? 2 : 1\);", src).groups())

    def split(bf16, dqk):
        return 2 if dqk > (bf16_from if bf16 else f32_from) else 1

    pairs = [(8, 8), (16, 16), (32, 32), (64, 64), (128, 128), (256, 256),
             (192, 128), (24, 16)]
    got = {(bf16, dqk): split(bf16, dqk) for bf16 in (False, True) for dqk, _ in pairs}
    assert [dqk for (bf16, dqk), n in got.items() if n == 2 and not bf16] == [256]
    assert sorted(dqk for (bf16, dqk), n in got.items() if n == 2 and bf16) == [192, 256]
    assert all(dqk // 8 % n == 0 for (_, dqk), n in got.items())
