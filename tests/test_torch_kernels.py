"""The port's kernel modules against the reference's Pallas kernels, on the CPU.

On the CPU each wrapper runs its kernel's plain version, so these tests hold
that arithmetic against the reference's Pallas kernels run in interpret mode,
over the shape / window / cap / GQA / dtype grid of tests/test_kernels.py.
Inputs are made from numpy seeds and handed to both packages.  The Hopper
kernels themselves are held against the plain versions on the card
(tests/test_torch_kernels_cuda.py and chip_smoke.py).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import flash_attention as k1
from repro_torch.kernels import int8_transfer as k2
from repro_torch.kernels import ops, ref

_DT = {"float32": (jnp.float32, torch.float32, np.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, ml_dtypes.bfloat16)}


def _inputs(shape_list, dtype, seed):
    """Seeded normals rounded to ``dtype`` once, as (jax arrays, torch tensors)."""
    jdt, tdt, ndt = _DT[dtype]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32).astype(ndt) for s in shape_list]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a.astype(np.float32)).to(tdt) for a in arrs])


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32), np.float32)


# the grid of tests/test_kernels.py::test_flash_attention_vs_ref; tolerances
# are that test's: 2e-5 float32, 2e-2 bfloat16 (the output is rounded to bf16)
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("s,h,kv,hd,window,cap", [
    (64, 4, 4, 32, 0, 0.0),        # MHA global
    (96, 8, 2, 64, 0, 0.0),        # GQA, non-divisible block edge (96/32)
    (64, 4, 1, 32, 0, 0.0),        # MQA
    (64, 4, 2, 32, 24, 0.0),       # sliding window
    (64, 4, 2, 32, 0, 30.0),       # softcap
    (33, 4, 2, 32, 16, 50.0),      # ragged seq + window + cap
])
def test_flash_plain_matches_pallas_kernel(s, h, kv, hd, window, cap, dtype, tol):
    b = 2
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)], dtype, seed=s + h + hd)
    want = jax_ops.flash_attention(jq, jk, jv, window=window, logit_cap=cap,
                                   block_q=32, block_k=32, interpret=True)
    got = ops.flash_attention(tq, tk, tv, window=window, logit_cap=cap)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,h,kv,hd,window,cap,scale", [
    (40, 4, 2, 16, 0, 0.0, None),
    (48, 6, 3, 32, 20, 0.0, 0.3),
    (33, 4, 1, 32, 8, 25.0, None),
])
def test_flash_plain_matches_kernel_layout_refs(s, h, kv, hd, window, cap,
                                                scale, causal):
    """Plain version vs the port's and the reference's [B·H,S,hd] oracles,
    float32, causal and not, explicit ``scale``: 2e-5 (summation order)."""
    b = 2
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)], "float32", seed=7)
    got = k1.flash_attention_plain(tq, tk, tv, causal=causal, window=window,
                                   logit_cap=cap, scale=scale)

    def rows(x):   # [B,S,heads,hd] -> [B·heads,S,hd]
        return x.transpose(1, 2).reshape(-1, s, hd)

    mine = ref.flash_attention_ref(rows(tq), rows(tk), rows(tv), n_heads=h,
                                   n_kv=kv, causal=causal, window=window,
                                   logit_cap=cap, scale=scale)
    theirs = jax_ref.flash_attention_ref(
        *(jnp.asarray(rows(t).numpy()) for t in (tq, tk, tv)), n_heads=h,
        n_kv=kv, causal=causal, window=window, logit_cap=cap, scale=scale)
    np.testing.assert_allclose(_np(rows(got)), _np(mine), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(mine), _np(theirs), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n,d", [(64, 128), (33, 256), (16, 4096)])
def test_int8_plain_bit_identical_to_pallas_kernel(n, d, dtype):
    """Stated tolerance: q bit-identical; scales ≤ 1 ulp from the Pallas
    kernel, bit-identical to its oracle; dequantization bit-identical.

    q is bit-identical to the reference kernel.  The scales are bit-identical
    to the reference's oracle (``ref.quantize_int8_ref``: an IEEE division by
    127) and within one unit in the last place of the Pallas kernel run under
    jit, where XLA turns the division by the constant 127 into a
    multiplication by its rounded reciprocal (e.g. one row of [64, 128],
    seed 8192, differs by 1.9e-9).  The port follows the oracle.  This is a
    float output within its tolerance, not a fault of either package.
    Dequantization of the same (q, scales) is bit-identical.
    """
    (jx,), (tx,) = _inputs([(n, d)], dtype, seed=n * d)
    jq, js = jax_ops.quantize_int8(jx, block_rows=16, interpret=True)
    tq, ts = ops.quantize_int8(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == (n, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    _, oracle_s = jax_ref.quantize_int8_ref(jx)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(oracle_s))
    np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js), maxulp=1)
    jdt, tdt, _ = _DT[dtype]
    jy = jax_ops.dequantize_int8(jnp.asarray(tq.numpy()), jnp.asarray(ts.numpy()),
                                 jdt, block_rows=16, interpret=True)
    ty = ops.dequantize_int8(tq, ts, tdt)
    assert ty.dtype == tdt
    np.testing.assert_array_equal(_np(ty), _np(jy))
    rq, rs = ref.quantize_int8_ref(tx)
    assert torch.equal(rq, tq) and torch.equal(rs, ts)
    assert torch.equal(ref.dequantize_int8_ref(rq, rs, tdt), ty)


def test_int8_ties_round_half_to_even():
    """x/scale landing exactly on .5 rounds to even, as jnp.round does."""
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.0]])
    q, s = k2.quantize_int8_plain(x)
    assert float(s) == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2, -2, 3]]
    jq, _ = jax_ops.quantize_int8(jnp.asarray(x.numpy()), interpret=True)
    assert np.asarray(jq).tolist() == q.tolist()


def _bf16_bits(v: float) -> int:
    return int(torch.tensor([v]).to(torch.bfloat16).view(torch.int16)) & 0xFFFF


# 64 absmax bit patterns: zero, the subnormals' edges, the smallest normal,
# both sides of the 1e-12 clamp, 1.0, 127 (scale 1), the largest finite
# bf16, and seeded draws over the rest
_CLAMP = _bf16_bits(1e-12)
_ABSMAX = sorted(set(
    [0, 1, 2, 0x7F, 0x80, 0x81, _CLAMP - 2, _CLAMP - 1, _CLAMP, _CLAMP + 1,
     _CLAMP + 2, 0x3F7F, _bf16_bits(1.0), 0x3F81, _bf16_bits(127.0),
     _bf16_bits(0.5), 0x7F7E, k2.BF16_FINITE - 1]
    + np.random.default_rng(64).choice(k2.BF16_FINITE, 46, replace=False).tolist()))[:64]


def _jax_bf16(x: torch.Tensor):
    return jnp.asarray(x.view(torch.int16).numpy().view(ml_dtypes.bfloat16))


@pytest.mark.parametrize("absmax", _ABSMAX, ids=hex)
def test_int8_plain_bit_identical_to_reference_over_bf16_absmax(absmax):
    """Every finite bf16 x with |x| <= a for one absmax a, both signs, in
    rows that start with a: q and the scales of the plain version equal the
    reference's oracle (eager, no Pallas) bit for bit."""
    assert len(_ABSMAX) == 64
    (x,) = k2.bf16_domain_rows([absmax], width=4096, rows=16)
    q, s = k2.quantize_int8_plain(x)
    jq, js = jax_ref.quantize_int8_ref(_jax_bf16(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert float(s[0, 0]) == max(float(x[0, 0]), np.float32(1e-12)) / np.float32(127)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_int8_dequant_plain_bit_identical_to_reference_over_codes(dtype):
    """All 255 codes against the scales of the 64 absmax values above."""
    jdt, tdt, _ = _DT[dtype]
    a = torch.tensor(_ABSMAX, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    _, scales = k2.quantize_int8_plain(a[:, None])
    q = torch.arange(-127, 128, dtype=torch.int8).repeat(len(_ABSMAX), 1)
    got = k2.dequantize_int8_plain(q, scales, tdt)
    want = jax_ref.dequantize_int8_ref(jnp.asarray(q.numpy()),
                                       jnp.asarray(scales.numpy()), jdt)
    assert got.dtype == tdt and got.shape == (64, 255)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_wrappers_count_only_kernel_launches():
    """On CPU tensors the wrappers run the plain versions: no launch counted."""
    before = (k1.flash_attention.launches, k2.quantize_int8.launches,
              k2.dequantize_int8.launches)
    q = torch.zeros(1, 8, 2, 16)
    ops.flash_attention(q, q[:, :, :1], q[:, :, :1])
    qq, sc = ops.quantize_int8(torch.ones(4, 8))
    ops.dequantize_int8(qq, sc)
    assert (k1.flash_attention.launches, k2.quantize_int8.launches,
            k2.dequantize_int8.launches) == before


@pytest.mark.parametrize("bad", ["shape", "heads", "dtype"])
def test_flash_rejects_malformed_inputs(bad):
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    if bad == "shape":
        k = torch.zeros(1, 7, 2, 16)
    elif bad == "heads":
        k = torch.zeros(1, 8, 3, 16)
    else:
        k = k.to(torch.bfloat16)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, k)
