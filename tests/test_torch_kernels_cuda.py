"""The Hopper kernels against their plain versions, on the card.

Every test here needs an sm_90 card and ``nvcc``; the ``hopper_card``
fixture skips them elsewhere, with the reason.  The file imports no JAX, so
it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Tolerances are those of tests/test_kernels.py for attention (2e-5 float32,
2e-2 bfloat16); int8 is held bit for bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as k1
from repro_torch.kernels import int8_transfer as k2


@pytest.fixture
def hopper_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the Hopper kernels run only there)")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an sm_90 (Hopper) card")
    return torch.device("cuda")


def _normal(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    return x.to(device="cuda", dtype=dtype)


pytestmark = pytest.mark.usefixtures("hopper_card")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,h,kv,hd,window,cap,causal", [
    (1, 512, 32, 8, 128, 0, 0.0, True),    # llama3-8b prefill shape
    (2, 77, 8, 2, 64, 0, 0.0, True),       # ragged S
    (2, 200, 4, 1, 32, 48, 0.0, True),     # sliding window, MQA
    (1, 130, 4, 2, 16, 0, 30.0, True),     # soft-cap
    (2, 96, 4, 4, 128, 0, 0.0, False),     # non-causal
])
def test_flash_kernel_matches_plain(b, s, h, kv, hd, window, cap, causal,
                                    dtype, tol):
    q = _normal((b, s, h, hd), dtype, 1)
    k = _normal((b, s, kv, hd), dtype, 2)
    v = _normal((b, s, kv, hd), dtype, 3)
    before = k1.flash_attention.launches
    got = k1.flash_attention(q, k, v, causal=causal, window=window, logit_cap=cap)
    torch.cuda.synchronize()
    assert k1.flash_attention.launches == before + 1
    want = k1.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    logit_cap=cap)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,d", [(512, 4096), (33, 100), (1, 7)])
def test_int8_kernels_bit_identical_to_plain(n, d, dtype):
    x = _normal((n, d), dtype, n + d) * 3
    q, s = k2.quantize_int8(x)
    torch.cuda.synchronize()
    pq, ps = k2.quantize_int8_plain(x)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    y = k2.dequantize_int8(q, s, dtype)
    assert torch.equal(y, k2.dequantize_int8_plain(q, s, dtype))


def test_flash_kernel_rejects_unsupported_head_dim():
    q = _normal((1, 8, 2, 48), torch.bfloat16, 0)
    with pytest.raises(ValueError, match="hd"):
        k1.flash_attention(q, q, q)
