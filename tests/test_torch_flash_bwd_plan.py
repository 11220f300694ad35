"""K1's backward kernel, its plan and its arithmetic, on the CPU.

The kernel (``csrc/flash_attention_bwd.cu``) runs only on the card; what
decides its result besides the card's arithmetic is checked here:

- the dK/dV work table (``flash_attention.bwd_work_table``), with one query
  head an item (the float32 kernel), the bf16 wrapper's choice
  (``bwd_heads_per_item``) and a whole KV head's G query heads an item:
  every (b, h, key tile, query tile) pair the mask keeps appears in exactly
  one item, no dead tile appears, and items come longest first;
- the table executed item by item with the plain formulas, each item
  summing its heads' dK and dV in the order of its heads and the G / heads
  groups' partials summed in the order of the groups, equals
  ``flash_attention_bwd_plain`` to 1e-6 of the largest gradient;
- the bf16 wrapper's heads an item: a divisor of G, the largest that leaves
  ``BWD_MIN_ITEMS`` items;
- every bf16 instance's shared memory (the kernel's ``WgBwd``, written out
  here) fits a Hopper block;
- the 3xTF32 split the float32 kernel runs its five products in, emulated
  in torch (TF32 keeps 10 mantissa bits; rounding to nearest, ties away
  from zero, is ``cvt.rna.tf32.f32``'s), meets the kernel's tolerance, 1e-4
  of the largest gradient against float64, where one TF32 product (rounded
  to nearest) does not: at Llama-3-8B's hd 128, Gemma-2's hd 256 (soft-cap
  50) and MLA's qk 192 / v 128;
- the bf16 instance's arithmetic (wgmma: bf16 operands, float32 sums; P
  and dS rounded to bf16 as operands, outputs rounded once), emulated, meets
  its bf16 tolerance, 2e-2 of the largest gradient against float64, and
  not the float32 one, at hd 128, hd 256 with the soft-cap and both MLA
  pairs;
- the rules that split a tile's work between two warps (float32) or two
  warpgroups (bf16) by role (read from the source) are the stated ones.

Where two warps (float32) or two warpgroups (bf16) share a tile by role
(one computes P and keeps dV, the other dP and dS and keeps dK; in the dQ
kernel each keeps half of dQ's columns), every sum runs over the same terms
in the same order as with one, so the walk checked here is the same.

The card holds the kernel itself against the plain version
(tests/test_torch_kernels_cuda.py::test_flash_bwd_kernel_matches_plain and
test_flash_bf16_bwd_kernel_matches_plain).
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


SMEM_LIMIT = 232448            # bytes of shared memory a Hopper block may use
CSRC = pathlib.Path(k1.__file__).with_name("csrc") / "flash_attention_bwd.cu"
HEADS = ["one", "bf16", "whole"]   # query heads an item: 1, the bf16 wrapper's, G


def _heads(which, b, s, h, kv):
    return {"one": 1, "bf16": k1.bwd_heads_per_item(b, s, h, kv),
            "whole": h // kv}[which]


@pytest.mark.parametrize("which", HEADS)
@pytest.mark.parametrize("b,s,h,kv,hd,hd_v,causal,window,cap,scale", SHAPES)
def test_work_table_covers_live_tiles_longest_first(b, s, h, kv, hd, hd_v, causal,
                                                    window, cap, scale, which):
    heads = _heads(which, b, s, h, kv)
    table = k1.bwd_work_table(b, s, h, kv, causal, window, heads)
    n_t = -(-s // TILE)
    assert table.dtype == torch.int32
    assert tuple(table.shape) == (b * h // heads * n_t, 5)
    # tile (query tile, key tile) is live iff it holds a pair the mask keeps
    keep = torch.zeros((n_t * TILE, n_t * TILE), dtype=torch.bool)
    keep[:s, :s] = _mask(s, causal, window)
    live = keep.reshape(n_t, TILE, n_t, TILE).any(3).any(1)     # [qt, kt]
    want = {(bi, hi, kt, qt) for bi in range(b) for hi in range(h)
            for qt, kt in live.nonzero().tolist()}
    got = [(bi, hi, kt, qt) for bi, h0, kt, q0, q1 in table.tolist()
           for hi in range(h0, h0 + heads) for qt in range(q0, q1)]
    assert len(got) == len(set(got))                    # each pair once
    assert set(got) == want                             # every live one, no dead one
    items = {(bi, h0, kt) for bi, h0, kt, _, _ in table.tolist()}
    assert len(items) == b * h // heads * n_t           # one per (b, group, key tile)
    # a group's heads share one KV head
    assert all(h0 % heads == 0 and h0 // (h // kv) == (h0 + heads - 1) // (h // kv)
               for _, h0, _, _, _ in table.tolist())
    lengths = (table[:, 4] - table[:, 3]).tolist()
    assert lengths == sorted(lengths, reverse=True)     # longest first
    assert min(lengths) >= 1


def _run_table(q, k, v, o, lse, do, causal, window, cap, scale, heads=1):
    """dK, dV from the work table, item by item with the plain formulas:
    each item sums the dK and dV of its keys over its heads h0 .. h0 +
    heads - 1, in that order, and writes them to its group's slot of the
    scratches [G / heads, B, S, KV, hd] and [G / heads, B, S, KV, hd_v];
    then the slots are summed in the order of the groups."""
    b, s, h, hd = q.shape
    kv, hd_v = k.shape[2], v.shape[3]
    g = h // kv
    sc = hd ** -0.5 if scale is None else scale
    keep = _mask(s, causal, window)
    delta = (do * o).sum(-1)                                  # [b, s, h]
    parts = g // heads
    part = [torch.zeros((parts, b, s, kv, hd)), torch.zeros((parts, b, s, kv, hd_v))]
    written = torch.zeros((parts, b, s, kv), dtype=torch.int64)
    table = k1.bwd_work_table(b, s, h, kv, causal, window, heads)
    for bi, h0, kt, q0, q1 in table.tolist():
        keys = slice(kt * TILE, min(s, kt * TILE + TILE))
        rows = slice(q0 * TILE, min(s, q1 * TILE))
        kh, vh = k[bi, keys, h0 // g], v[bi, keys, h0 // g]
        dk = torch.zeros((kh.shape[0], hd))
        dv = torch.zeros((kh.shape[0], hd_v))
        for hi in range(h0, h0 + heads):
            qh, doh = q[bi, rows, hi], do[bi, rows, hi]
            raw = (qh * sc) @ kh.T
            dcap = torch.ones_like(raw)
            if cap:
                t = torch.tanh(raw / cap)
                raw, dcap = cap * t, 1.0 - t * t
            p = torch.exp(raw - lse[bi, hi, rows][:, None]).masked_fill(
                ~keep[rows, keys], 0.0)
            ds = p * dcap * (doh @ vh.T - delta[bi, rows, hi][:, None])
            dk = dk + ds.T @ (qh * sc)
            dv = dv + p.T @ doh
        slot = h0 % g // heads
        part[0][slot, bi, keys, h0 // g] = dk
        part[1][slot, bi, keys, h0 // g] = dv
        written[slot, bi, keys, h0 // g] += 1
    assert bool((written == 1).all())                   # every partial row once
    dk, dv = part[0][0].clone(), part[1][0].clone()
    for gi in range(1, parts):
        dk, dv = dk + part[0][gi], dv + part[1][gi]
    return dk, dv


@pytest.mark.parametrize("which", HEADS)
@pytest.mark.parametrize("b,s,h,kv,hd,hd_v,causal,window,cap,scale", SHAPES)
def test_work_table_executed_on_cpu_equals_plain(b, s, h, kv, hd, hd_v, causal,
                                                 window, cap, scale, which):
    q, k, v, do = _inputs(b, s, h, kv, hd, seed=s + h, hd_v=hd_v)
    kw = dict(causal=causal, window=window, logit_cap=cap, scale=scale)
    o, lse = k1.flash_attention_lse(q, k, v, **kw)
    _, dk_want, dv_want = k1.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    dk, dv = _run_table(q, k, v, o, lse, do, causal, window, cap, scale,
                        _heads(which, b, s, h, kv))
    # the largest gradient of the two: at S = 1, dK is 0 up to rounding
    largest = max(float(dk_want.abs().max()), float(dv_want.abs().max()))
    for got, want in ((dk, dk_want), (dv, dv_want)):
        assert float((got - want).abs().max()) <= 1e-6 * largest


@pytest.mark.parametrize("b,s,h,kv", [
    (2, 512, 32, 8), (8, 256, 8, 8), (2, 256, 7, 1), (2, 512, 16, 1),
    (2, 512, 16, 8), (4, 384, 16, 4), (1, 512, 16, 1), (2, 1, 4, 2)])
def test_bf16_heads_per_item_is_the_largest_that_fills_the_card(b, s, h, kv):
    """The bf16 wrapper's heads an item divide G, leave at least
    ``BWD_MIN_ITEMS`` items (or are 1), and no larger divisor does."""
    g = h // kv
    heads = k1.bwd_heads_per_item(b, s, h, kv)

    def n_items(x):
        return b * kv * (g // x) * -(-s // TILE)

    assert g % heads == 0
    assert heads == 1 or n_items(heads) >= k1.BWD_MIN_ITEMS
    assert all(n_items(x) < k1.BWD_MIN_ITEMS for x in range(heads + 1, g + 1)
               if g % x == 0)


def _bf16_rules():
    """(kv_roles's DQK + DV bound, q_roles's DQK bound) of the bf16 kernels."""
    src = CSRC.read_text()
    kv = int(re.search(r"constexpr int kv_roles\(\) \{ return DQK \+ DV > (\d+) \? 2 : 1; \}",
                       src).group(1))
    q = int(re.search(r"constexpr int q_roles\(\) \{ return DQK > (\d+) \? 2 : 1; \}",
                      src).group(1))
    return kv, q


PAIRS = [(8, 8), (16, 16), (32, 32), (64, 64), (128, 128), (256, 256), (192, 128),
         (24, 16)]


@pytest.mark.parametrize("dqk,dv", PAIRS)
def test_bf16_instance_shared_memory_fits_a_block(dqk, dv):
    """The bf16 kernels' shared memory (``WgBwd``: 64-row sw128 tiles of
    head dims stored in 64-column panels, bf16; k and v (dK/dV) or q and dO
    (dQ) resident and two stages of the streamed pair; the dK/dV stages'
    lse and D; the roles' float32 exchanges; 1,024 bytes of alignment) fits
    the 232,448 bytes a Hopper block may use, at every pair built; hd <= 128
    leaves room for two dK/dV and two dQ blocks an SM."""
    kv_bound, q_bound = _bf16_rules()
    kv_roles = 2 if dqk + dv > kv_bound else 1
    q_roles = 2 if dqk > q_bound else 1

    def panels(d):
        return 64 if d < 64 else -(-d // 64) * 64

    tiles = 64 * 2 * (panels(dqk) + panels(dv))
    kv_smem = 1024 + 3 * tiles + 2 * 2 * 64 * 4 + (kv_roles - 1) * 64 * 64 * 4
    q_smem = 1024 + 3 * tiles + (q_roles - 1) * 2 * 64 * 64 * 4
    assert kv_smem <= SMEM_LIMIT and q_smem <= SMEM_LIMIT, (kv_smem, q_smem)
    if dqk <= 128 and dv <= 128:
        assert 2 * (kv_smem + 1024) <= 233472 and 2 * (q_smem + 1024) <= 233472


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
    sums (the bf16 instance's wgmma)."""
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
    """The kernels' rules (read from csrc/flash_attention_bwd.cu): float32
    (``n_split``) pairs two warps on 16 rows only at hd 256, by measurement
    (kernel_ab.py against builds with the rule changed, PERF.md); bf16 gives
    a 64-row tile two warpgroups by role where one cannot hold the tile's
    accumulators: the dK/dV kernel (``kv_roles``) at (192, 128) and 256,
    the dQ kernel (``q_roles``) at 256.  Every float32 instance's dQ
    columns divide between the pair, every bf16 one's into 64-column
    panels."""
    src = CSRC.read_text()
    f32_from = int(re.search(r"constexpr int n_split\(\) \{\s*return DQK > (\d+) \? 2 : 1;",
                             src).group(1))
    kv_bound, q_bound = _bf16_rules()
    f32 = {dqk: 2 if dqk > f32_from else 1 for dqk, _ in PAIRS}
    kv = {(dqk, dv): 2 if dqk + dv > kv_bound else 1 for dqk, dv in PAIRS}
    q = {dqk: 2 if dqk > q_bound else 1 for dqk, _ in PAIRS}
    assert [dqk for dqk, n in f32.items() if n == 2] == [256]
    assert all(dqk // 8 % n == 0 for dqk, n in f32.items())
    assert sorted(pair for pair, n in kv.items() if n == 2) == [(192, 128), (256, 256)]
    assert [dqk for dqk, n in q.items() if n == 2] == [256]
    assert all(dqk // n % 64 == 0 for dqk, n in q.items() if n == 2)
