"""K1's float32 forward kernel, its plan and its arithmetic, on the CPU.

The kernel (``csrc/flash_attention.cu``, ``flash_fwd_f32_mma_kernel``) runs
only on the card; what decides its result besides the card's arithmetic is
checked here:

- its dispatch table sends every (qk, v) head-dim pair the wrapper builds
  to the float32 kernel, with a block of 64 or 128 query rows and K/V
  buffers whose shared memory fits a block;
- its grid hands out each (b, h, query tile) once, the last tile first,
  which under a causal mask is the longest first; each warp (16 query rows)
  runs exactly the 32-key tiles that hold a (query, key) pair the mask
  keeps for one of its rows;
- its walk (the online softmax over 32-key tiles, scores scaled by log2 e
  after the product, ``exp2``, lse = m ln 2 + log l) run in float32 equals
  ``flash_attention_plain`` to 1e-6;
- the same walk with both products in the kernel's 3xTF32 split (emulated
  by ``_split`` / ``_product`` of tests/test_torch_flash_bwd_plan.py)
  meets the card tests' tolerances against float64, 2e-5 on o and 1e-5 on
  lse, at the card tests' soft-caps (30, 50), windows, hd 8, (24, 16),
  (192, 128) and 256, where one TF32 product does not.

The card holds the kernel itself against the plain version
(tests/test_torch_kernels_cuda.py::test_flash_f32_forward_matches_plain_and_repeats).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as k1
from test_torch_flash_bwd_plan import _mask, _product

BK = 32                        # keys per K/V tile
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
SMEM_LIMIT = 232448            # bytes of shared memory a Hopper block may use
CSRC = pathlib.Path(k1.__file__).with_name("csrc") / "flash_attention.cu"


def _dispatch_table():
    """{(qk, v): (query rows a block, K/V stages)} of the float32 instance,
    read from the kernel's dispatch table."""
    rows = re.findall(r"^\s*REPRO_FLASH_PAIR\((\d+), (\d+), (\d+), (\d+)\)",
                      CSRC.read_text(), flags=re.M)
    return {(int(a), int(b)): (int(c), int(d)) for a, b, c, d in rows}


def test_dispatch_table_covers_every_pair_within_shared_memory():
    table = _dispatch_table()
    built = {(d, d) for d in k1._HEAD_DIMS} | set(k1._QK_V_PAIRS)
    assert set(table) == built and all(k1.supported(*pair) for pair in table)
    for (dqk, dv), (bq, stages) in table.items():
        # F32Cfg::SMEM: two Q planes of row stride dqk + 4, and the stages of
        # a K (dqk + 4) and a V (dv + 4) tile of BK rows
        smem = 4 * (2 * bq * (dqk + 4) + stages * BK * (dqk + 4 + dv + 4))
        assert bq in (64, 128) and stages in (1, 2) and smem <= SMEM_LIMIT, (dqk, dv)


def _block_tiles(q0, bq, s, causal, window):
    """The block's loop over KV tiles [kt_begin, kt_end) (the kernel's rule)."""
    n_t = -(-s // BK)
    kt_end = min(n_t, min(s - 1, q0 + bq - 1) // BK + 1) if causal else n_t
    lo = q0 - window - BK + 1
    kt_begin = 0 if window <= 0 or lo < 0 else lo // BK + 1
    return kt_begin, kt_end


def _warp_runs(wr0, k0, s, causal, window):
    """Whether the warp of rows [wr0, wr0 + 15] runs the tile at key k0."""
    wr1 = min(s - 1, wr0 + 15)
    return not ((causal and k0 > wr1) or (window > 0 and k0 + BK - 1 <= wr0 - window))


def _grid_order(b, s, h, bq):
    """(b, h, query tile) of each block in launch order: blockIdx.x = b H + h
    runs fastest, query tile = gridDim.y - 1 - blockIdx.y."""
    n_t = -(-s // bq)
    return [(x // h, x % h, n_t - 1 - y) for y in range(n_t) for x in range(b * h)]


# (b, s, h, causal, window)
ORDERS = [(2, 512, 32, True, 0), (8, 256, 8, True, 0), (2, 333, 4, True, 0),
          (1, 130, 4, True, 48), (2, 200, 4, True, 48), (2, 96, 4, False, 0),
          (1, 65, 2, False, 24), (2, 1, 4, True, 0)]


@pytest.mark.parametrize("bq", [64, 128])
@pytest.mark.parametrize("b,s,h,causal,window", ORDERS)
def test_grid_covers_query_tiles_once_longest_first(b, s, h, causal, window, bq):
    order = _grid_order(b, s, h, bq)
    n_t = -(-s // bq)
    assert sorted(order) == [(bi, hi, t) for bi in range(b) for hi in range(h)
                             for t in range(n_t)]
    lengths = [np.subtract(*_block_tiles(t * bq, bq, s, causal, window)[::-1])
               for _, _, t in order]
    assert min(lengths) >= 1
    if causal and window == 0:
        assert lengths == sorted(lengths, reverse=True)      # longest first


@pytest.mark.parametrize("bq", [64, 128])
@pytest.mark.parametrize("b,s,h,causal,window", ORDERS)
def test_warps_run_exactly_the_live_key_tiles(b, s, h, causal, window, bq):
    n_t = -(-s // BK)
    keep = torch.zeros((s, n_t * BK), dtype=torch.bool)
    keep[:, :s] = _mask(s, causal, window)
    for q0 in range(0, s, bq):
        kt_begin, kt_end = _block_tiles(q0, bq, s, causal, window)
        for wr0 in range(q0, min(q0 + bq, s), 16):
            rows = keep[wr0:wr0 + 16].reshape(-1, n_t, BK)
            live = {kt for kt in range(n_t) if bool(rows[:, kt].any())}
            runs = {kt for kt in range(kt_begin, kt_end)
                    if _warp_runs(wr0, kt * BK, s, causal, window)}
            assert runs == live, (q0, wr0)


def _walk(q, k, v, causal, window, cap, scale, bq, mode):
    """The kernel's walk on [B, S, H, hd] inputs with its products in
    ``mode`` (f64: float64 throughout, the truth; f32: float32 products;
    3xtf32, tf32): per block of ``bq`` query rows, the KV tiles of
    ``_block_tiles`` in order; q scaled before the product, scores times
    log2 e (soft-capped first), masked to -2e38, the online softmax with
    exp2; o = acc / l, lse = m ln 2 + log l.  A tile that holds no key of a
    row leaves it exactly as it was, so all rows of a block walk together."""
    dt = torch.float64 if mode == "f64" else torch.float32
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    qh = (q.to(dt) * scale).transpose(1, 2)                        # [B, H, S, hd]
    kh = k.to(dt).repeat_interleave(g, 2).transpose(1, 2)
    vh = v.to(dt).repeat_interleave(g, 2).transpose(1, 2)
    keep = _mask(s, causal, window)
    o = torch.zeros((b, h, s, v.shape[3]), dtype=dt)
    lse = torch.zeros((b, h, s), dtype=dt)
    neg = torch.tensor(k1.NEG_INF, dtype=dt)
    for q0 in range(0, s, bq):
        rows = slice(q0, min(s, q0 + bq))
        m = torch.full(lse[..., rows].shape, k1.NEG_INF, dtype=dt)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(o[..., rows, :])
        for kt in range(*_block_tiles(q0, bq, s, causal, window)):
            keys = slice(kt * BK, min(s, kt * BK + BK))
            sc = _product(qh[..., rows, :], kh[..., keys, :].transpose(-1, -2), mode)
            sc = cap * LOG2E * torch.tanh(sc / cap) if cap else sc * LOG2E
            sc = torch.where(keep[rows, keys], sc, neg)
            m_new = torch.maximum(m, sc.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(sc - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + _product(p, vh[..., keys, :], mode)
            m = m_new
        o[..., rows, :] = acc / l[..., None]
        lse[..., rows] = m * LN2 + torch.log(l)
    return o.transpose(1, 2), lse


def _inputs(b, s, h, kv, hd, hd_v, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd_v))]


def _within(got, want, tol):
    """torch.testing.assert_close's rule, |got - want| <= tol + tol |want|,
    as the largest ratio of the two sides."""
    return float(((got.double() - want.double()).abs()
                  / (tol + tol * want.double().abs())).max())


# the card tests' cases at reduced heads: (b, s, h, kv, hd, hd_v, causal,
# window, cap); Llama-3-8B's and the quickstart's training shapes first
WALKS = [
    (1, 512, 4, 1, 128, 128, True, 0, 0.0),       # llama3-8b training, G = 4
    (1, 256, 2, 2, 64, 64, True, 0, 0.0),         # quickstart
    (2, 333, 2, 1, 128, 128, True, 0, 0.0),       # ragged S
    (1, 130, 4, 2, 16, 16, True, 0, 30.0),        # soft-cap 30
    (1, 512, 2, 1, 256, 256, True, 4096, 50.0),   # gemma2-9b prefill: soft-cap 50
    (2, 200, 4, 1, 32, 32, True, 48, 0.0),        # sliding window, MQA
    (2, 130, 7, 1, 8, 8, True, 0, 0.0),           # hd 8, G = 7
    (1, 70, 4, 4, 24, 16, True, 16, 30.0),        # reduced MLA: window, soft-cap
    (1, 512, 2, 2, 192, 128, True, 0, 0.0),       # MLA prefill
    (2, 96, 4, 4, 64, 64, False, 0, 30.0),        # non-causal, soft-cap
]


@pytest.mark.parametrize("b,s,h,kv,hd,hd_v,causal,window,cap", WALKS)
def test_walk_in_float32_equals_plain(b, s, h, kv, hd, hd_v, causal, window, cap):
    q, k, v = _inputs(b, s, h, kv, hd, hd_v, seed=s + hd)
    bq = _dispatch_table()[(hd, hd_v)][0]
    o, lse = _walk(q, k, v, causal, window, cap, hd ** -0.5, bq, "f32")
    kw = dict(causal=causal, window=window, logit_cap=cap, scale=hd ** -0.5)
    sim, _, _ = k1._scores_plain(q, k, causal, window, cap, hd ** -0.5)
    assert _within(o, k1.flash_attention_plain(q, k, v, **kw), 1e-6) <= 1
    assert _within(lse, torch.logsumexp(sim, -1), 1e-6) <= 1


@pytest.mark.parametrize("mode,meets", [("3xtf32", True), ("tf32", False)])
@pytest.mark.parametrize("b,s,h,kv,hd,hd_v,causal,window,cap", WALKS)
def test_3xtf32_walk_meets_the_float32_tolerance(b, s, h, kv, hd, hd_v, causal,
                                                 window, cap, mode, meets):
    """o within 2e-5 and lse within 1e-5 of the float64 walk with the
    kernel's 3xTF32 products; one TF32 product misses o's tolerance."""
    q, k, v = _inputs(b, s, h, kv, hd, hd_v, seed=s + hd)
    bq = _dispatch_table()[(hd, hd_v)][0]
    args = (q, k, v, causal, window, cap, hd ** -0.5, bq)
    o64, lse64 = _walk(*args, "f64")
    o, lse = _walk(*args, mode)
    r_o, r_lse = _within(o, o64, 2e-5), _within(lse, lse64, 1e-5)
    assert (r_o <= 1 and r_lse <= 1) == meets, (r_o, r_lse)
