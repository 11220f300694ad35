"""K2a's arithmetic over the whole bf16 input domain, on the CPU.

A row's int8 codes depend only on its absmax ``a`` and each element ``x``
(``|x| <= a``), so every finite bf16 input is covered by the ~1.07e9 pairs
(a, x).  Two checks, each over all of them:

- the port's plain version (the kernel's oracle on the card) against the
  reference's oracle ``repro.kernels.ref.quantize_int8_ref`` (eager, no
  Pallas), on the rows that the card sweep quantizes;
- the bf16 kernel's quotient, emulated exactly in numpy, against the IEEE
  quotient: ``y = x * r`` with ``r = rcp_rn(scale)``, ``e = fma(-y, scale,
  x)``, ``y' = fma(e, r, y)``, then clip and round by adding 1.5 * 2^23
  (csrc/int8_transfer.cu).

The card runs the kernel itself over the same domain
(tests/test_torch_kernels_cuda.py::test_int8_quantize_exhaustive_bf16).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

from repro.kernels import ref as jax_ref
from repro_torch.kernels import int8_transfer as k2

F32 = np.float32


def test_int8_plain_bit_identical_to_reference_over_whole_bf16_domain():
    pairs = 0
    for x in k2.bf16_domain_rows(width=4096, rows=2048):
        q, s = k2.quantize_int8_plain(x)
        jx = jnp.asarray(x.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
        jq, js = jax_ref.quantize_int8_ref(jx)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        pairs += x.numel()
    assert pairs > 1.07e9


def _fma32(a, b, c):
    """float32 fma(a, b, c) rounded once: the float64 product is exact and
    TwoSum gives s + t == a*b + c exactly; rounding s to float32 is right
    unless s is a float32 midpoint, where t breaks the tie."""
    p = a.astype(np.float64) * b
    c = c.astype(np.float64)
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)
    r = s.astype(F32)
    d = s - r
    k = np.flatnonzero((t != 0) & (d != 0))
    if k.size:
        nb = np.nextafter(r[k], np.where(d[k] > 0, F32(np.inf), F32(-np.inf)))
        mid = (r[k].astype(np.float64) + nb) * 0.5 == s[k]
        away = mid & ((t[k] > 0) == (d[k] > 0))
        r[k[away]] = nb[away]
    return r


def test_fma32_emulation_rounds_once():
    """A case where rounding the float64 sum to float32 (a second rounding)
    is wrong: a*b + c = 1 + 3 * 2^-24 - 2^-70 lies just under the midpoint
    of 1 + 2^-23 and 1 + 2^-22, which the float64 sum lands on."""
    a = np.array([F32(2.0 ** -24 * (1 + 2.0 ** -23))])
    b = np.array([F32(1 - 2.0 ** -23)])
    c = np.array([F32(1 + 2.0 ** -23)])
    assert (a.astype(np.float64) * b + c).astype(F32)[0] == F32(1 + 2.0 ** -22)
    assert _fma32(a, b, c)[0] == F32(1 + 2.0 ** -23)
    assert _fma32(np.array([F32(3)]), np.array([F32(5)]), np.array([F32(-1)]))[0] == 14


def test_int8_bf16_quotient_exact_over_whole_bf16_domain():
    """Every (a, x >= 0) pair: the emulated kernel's code equals
    clip(rint(x / scale)).  Negative x needs no run: each step is odd in x
    (the products, the FMAs and round-half-even negate exactly)."""
    pairs = bad = 0
    for c0 in range(0, k2.BF16_FINITE, 256):
        ia = np.arange(c0, min(c0 + 256, k2.BF16_FINITE), dtype=np.uint32)
        cnt = ia + 1
        a = np.repeat((ia << 16).view(F32), cnt)
        xi = (np.arange(cnt.sum(), dtype=np.uint32)
              - np.repeat(np.cumsum(cnt) - cnt, cnt).astype(np.uint32))
        x = (xi << 16).view(F32)
        scale = np.maximum(a, F32(1e-12)) / F32(127)
        rcp = F32(1) / scale
        y = x * rcp
        y = _fma32(_fma32(-y, scale, x), rcp, y)
        code = ((np.clip(y, F32(-127), F32(127)) + F32(12582912.0)).view(np.uint32)
                & 0xFF).astype(np.uint8).view(np.int8)
        want = np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
        bad += int((code != want).sum())
        pairs += x.size
    assert pairs == k2.BF16_FINITE * (k2.BF16_FINITE + 1) // 2
    assert bad == 0
