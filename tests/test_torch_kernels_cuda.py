"""The Hopper kernels against their plain versions, on the card.

Every test here needs an sm_90 card and ``nvcc``; the ``hopper_card``
fixture skips them elsewhere, with the reason.  The file imports no JAX, so
it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Tolerances are those of tests/test_kernels.py: attention 2e-5 float32 (K1's
float32 forward runs 3xTF32 products on the tensor cores, emulated on the
CPU in tests/test_torch_flash_fwd_plan.py; its lse 1e-5), 2e-2
bfloat16 (K1's backward: 1e-4 of the largest reference gradient, with window,
soft-cap, GQA and ragged S at every head dim 8 to 128; its 3xTF32 products
are emulated on the CPU in tests/test_torch_flash_bwd_plan.py) (K1 also at MLA's qk 192 / v 128 and 24 / 16 and at hd 8, K3 at hd
8 and 256); K1's bf16 backward 2e-2 of the largest reference gradient, bit
for bit on repeat; SSD (K4) 1e-4 float32 for y and the float32 state (also
in bf16), 2e-2 for bf16 outputs; RG-LRU (K5) 1e-5 float32, 2e-2 bf16; int8
is held bit for bit, bf16 quantize over every finite input.  Training
gradients card vs CPU: float32 (``_f32_port``) at the stated leaf
tolerances; bf16 (the training path) within 3 times the CPU's own
bf16-vs-float32 gap plus 1e-3 of each leaf's max.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_bundle
from repro_torch.kernels import decode_attention as k3
from repro_torch.kernels import flash_attention as k1
from repro_torch.kernels import int8_transfer as k2
from repro_torch.kernels import rglru as k5
from repro_torch.kernels import ssd_chunk as k4
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.models.common import tree_flatten, tree_map, tree_unflatten
from repro_torch.serving import Request, WaveBatcher
from repro_torch.training import AdamWConfig, TrainStepConfig, make_train_step


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


@pytest.fixture
def _f32_port(monkeypatch):
    """bundle.loss with float32 activations (each family's ``embed_tokens``
    compute dtype): the float32 training path; without it the loss embeds
    in bf16, as the reference's."""
    from repro_torch.models import griffin, mamba2, transformer

    for mod in (transformer, mamba2, griffin):
        monkeypatch.setattr(mod, "embed_tokens", functools.partial(
            mod.embed_tokens, compute_dtype=torch.float32))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,h,kv,hd,window,cap,causal", [
    (1, 512, 32, 8, 128, 0, 0.0, True),    # llama3-8b prefill shape
    (2, 77, 8, 2, 64, 0, 0.0, True),       # ragged S
    (2, 200, 4, 1, 32, 48, 0.0, True),     # sliding window, MQA
    (1, 130, 4, 2, 16, 0, 30.0, True),     # soft-cap
    (2, 96, 4, 4, 128, 0, 0.0, False),     # non-causal
    (1, 512, 16, 1, 256, 2048, 0.0, True),  # recurrentgemma-9b local attention
    (1, 4096, 16, 1, 256, 2048, 0.0, True), # hd 256 where the window bites
    (2, 70, 4, 1, 256, 24, 0.0, True),     # hd 256, ragged S, small window
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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,h,kv,hd,window", [
    (1, 1, 32, 8, 128, 0),        # one query row
    (1, 63, 32, 8, 128, 0),       # one under a 64-row tile
    (1, 65, 32, 8, 128, 0),       # one over
    (2, 127, 16, 4, 128, 0),      # one under two tiles
    (2, 129, 16, 4, 128, 0),      # one over
    (8, 512, 32, 8, 128, 0),      # WaveBatcher prefill shape (8 slots)
    (1, 300, 32, 4, 128, 0),      # G = 8
    (1, 300, 8, 2, 128, 64),      # window on a tile boundary
    (1, 300, 8, 2, 128, 65),      # one past it
    (1, 200, 4, 1, 256, 64),      # hd 256, window on a tile boundary
    (2, 150, 8, 2, 16, 0),        # small head dims (one 64-column panel)
    (2, 150, 8, 2, 32, 33),
    (2, 150, 8, 2, 64, 0),
])
def test_flash_kernel_tile_edges(b, s, h, kv, hd, window, dtype, tol):
    """Shapes that cross the bf16 kernel's 64-row query and 64-key tiles,
    its window tile rule and its padded head dims."""
    q = _normal((b, s, h, hd), dtype, 4)
    k = _normal((b, s, kv, hd), dtype, 5)
    v = _normal((b, s, kv, hd), dtype, 6)
    got = k1.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    want = k1.flash_attention_plain(q, k, v, window=window)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,h,kv,dqk,dv,window,cap", [
    (1, 512, 16, 16, 192, 128, 0, 0.0),   # deepseek-v2-lite MLA prefill
    (2, 77, 16, 16, 192, 128, 0, 0.0),    # MLA, ragged S
    (2, 150, 4, 4, 24, 16, 0, 0.0),       # reduced MLA (qk 24 = 16 + 8 rope)
    (1, 70, 4, 4, 24, 16, 16, 30.0),      # reduced MLA, window and soft-cap
    (2, 130, 7, 1, 8, 8, 0, 0.0),         # reduced deepseek-coder / internvl2
    (2, 150, 6, 6, 8, 8, 16, 0.0),        # reduced musicgen, windowed
    (1, 65, 4, 2, 8, 8, 0, 50.0),         # hd 8 over a tile edge, soft-cap
    (1, 512, 16, 8, 256, 256, 4096, 50.0),  # gemma2-9b prefill: soft-cap 50
    (1, 512, 32, 32, 80, 80, 0, 0.0),     # stablelm-3b prefill (hd 80, MHA)
    (2, 77, 8, 2, 80, 80, 48, 30.0),      # hd 80: GQA, ragged S, window, cap
    (2, 130, 4, 4, 80, 80, 0, 0.0),       # hd 80 over two 64-row tiles
])
def test_flash_kernel_new_head_dims(b, s, h, kv, dqk, dv, window, cap, dtype, tol):
    """K1 at MLA's qk head dim wider than its v head dim, at hd 8 and at
    hd 80: the zero-padded k-steps of Q K^T, the narrow P V panel and, at
    80, the 128-column tiles whose columns past 80 P V drops."""
    q = _normal((b, s, h, dqk), dtype, 7)
    k = _normal((b, s, kv, dqk), dtype, 8)
    v = _normal((b, s, kv, dv), dtype, 9)
    sc = dqk ** -0.5
    before = k1.flash_attention.launches
    got = k1.flash_attention(q, k, v, window=window, logit_cap=cap, scale=sc)
    torch.cuda.synchronize()
    assert k1.flash_attention.launches == before + 1
    assert got.shape == (b, s, h, dv) and bool(torch.isfinite(got).all())
    want = k1.flash_attention_plain(q, k, v, window=window, logit_cap=cap, scale=sc)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_flash_kernel_rejects_unbuilt_pairs():
    q = _normal((1, 8, 2, 192), torch.bfloat16, 0)
    with pytest.raises(ValueError, match="hd_v"):
        k1.flash_attention(q, q, q[..., :64].contiguous())


def _int8_rows(n, d, dtype, seed):
    """Seeded normals x 3, with the first row on exact ties (absmax 127, so
    scale 1 and x / scale = ±(k + 0.5)) and, for n > 1, the last all zeros."""
    x = _normal((n, d), dtype, seed) * 3
    k = torch.arange(d - 1, device="cuda") % 127
    ties = (k + 0.5) * (1 - 2 * (torch.arange(d - 1, device="cuda") % 2))
    x[0, 0] = 127.0
    x[0, 1:] = ties.to(dtype)
    if n > 1:
        x[-1] = 0
    return x


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [7, 100, 2048, 2560, 3584, 4096, 7168, 12288,
                               16384, 16392])
@pytest.mark.parametrize("n", [1, 33, 512])
def test_int8_kernels_bit_identical_to_plain(n, d, dtype):
    """Every width the model variants bring (fast instance: D a multiple of
    16 bytes up to 16,384 bf16 / 8,192 float32), the tests' ragged widths
    and one past the fast instance (general instance); ties and zero rows."""
    x = _int8_rows(n, d, dtype, n + d)
    before = k2.quantize_int8.launches
    q, s = k2.quantize_int8(x)
    torch.cuda.synchronize()
    assert k2.quantize_int8.launches == before + 1
    pq, ps = k2.quantize_int8_plain(x)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    y = k2.dequantize_int8(q, s, dtype)
    assert torch.equal(y, k2.dequantize_int8_plain(q, s, dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_quantize_unaligned_rows(dtype):
    """A contiguous view that starts 2 bytes into its storage takes the
    general instance; it quantizes bit for bit too."""
    n, d = 33, 4096
    flat = _normal((n * d + 1,), dtype, 9) * 3
    x = flat[1:].view(n, d)
    q, s = k2.quantize_int8(x)
    torch.cuda.synchronize()
    pq, ps = k2.quantize_int8_plain(x)
    assert torch.equal(q, pq) and torch.equal(s, ps)


@pytest.mark.parametrize("width", [4096, 4095], ids=["fast", "general"])
def test_int8_quantize_exhaustive_bf16(width):
    """K2a bit for bit against its plain version over the whole bf16 domain:
    every finite absmax a (0, the subnormals, the 1e-12 clamp, up to
    3.39e38) and, for each, every bf16 x with |x| <= a, both signs, packed
    ``width`` to a row that starts with a (~1.07e9 pairs), through the fast
    instance (4,096) and the general one (4,095: not a multiple of 8)."""
    pairs = 0
    for x in k2.bf16_domain_rows(width=width, rows=32768, device="cuda"):
        q, s = k2.quantize_int8(x)
        pq, ps = k2.quantize_int8_plain(x)
        assert torch.equal(s, ps)
        bad = (q != pq).nonzero()
        assert bad.numel() == 0, \
            [(x[r, 0].item(), x[r, c].item(), q[r, c].item(), pq[r, c].item())
             for r, c in bad[:5].tolist()]
        pairs += x.numel()
    assert pairs > 1.07e9


def _ssd_inputs(b, s, h, g, n, p, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h), dtype=np.float32)))
    a = -np.exp(np.linspace(0.0, 1.0, h, dtype=np.float32))
    bm = rng.standard_normal((b, s, g, n), dtype=np.float32) * 0.3
    cm = rng.standard_normal((b, s, g, n), dtype=np.float32) * 0.3
    st = rng.standard_normal((b, h, n, p), dtype=np.float32)

    def card(v, dt_=torch.float32):
        return torch.from_numpy(v).to(device="cuda", dtype=dt_)

    return (card(x, dtype), card(dt), card(a), card(bm, dtype), card(cm, dtype),
            card(st))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,h,g,n,p,chunk,with_state", [
    (1, 512, 64, 1, 128, 64, 256, True),   # mamba2-1.3b prefill shape
    (2, 300, 8, 1, 128, 64, 256, True),    # ragged S (second chunk of 44)
    (2, 64, 4, 2, 16, 8, 16, False),       # G=2 groups, P below a column tile
    (1, 48, 4, 1, 16, 16, 16, True),       # 3 chunks of 16
    (2, 513, 64, 1, 128, 64, 256, True),   # one step past two chunks
    (1, 100, 2, 1, 8, 24, 64, True),       # N=8, P=24 (one and a half tiles)
    (1, 2048, 8, 1, 128, 64, 256, True),   # 8 chunks: the state carried 7 times
])
def test_ssd_kernel_matches_plain(b, s, h, g, n, p, chunk, with_state, dtype, tol):
    x, dt, a, bm, cm, st = _ssd_inputs(b, s, h, g, n, p, dtype, s + h)
    state_in = st if with_state else None
    before = k4.ssd.launches
    y, state = k4.ssd(x, dt, a, bm, cm, chunk=chunk, state_in=state_in,
                      return_state=True)
    torch.cuda.synchronize()
    assert k4.ssd.launches == before + 1
    assert y.dtype == dtype and state.dtype == torch.float32
    want_y, want_state = k4.ssd_plain(x, dt, a, bm, cm, chunk=chunk,
                                      state_in=state_in, return_state=True)
    torch.testing.assert_close(y.float(), want_y.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(state, want_state, atol=1e-4, rtol=1e-4)


def test_ssd_kernel_reads_strided_views():
    """x, B, C as slices of one conv output (the model path's layout)."""
    b, s, h, g, n, p = 1, 200, 8, 1, 32, 16
    rng = np.random.default_rng(0)
    conv = torch.from_numpy(rng.standard_normal((b, s, h * p + 2 * g * n),
                                                dtype=np.float32) * 0.5).cuda()
    x = conv[..., :h * p].unflatten(-1, (h, p))
    bm = conv[..., h * p:h * p + g * n].unflatten(-1, (g, n))
    cm = conv[..., h * p + g * n:].unflatten(-1, (g, n))
    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal(
        (b, s, h), dtype=np.float32)))).cuda()
    a = -torch.linspace(1.0, 2.0, h, device="cuda")
    got = k4.ssd(x, dt, a, bm, cm, chunk=64)
    want = k4.ssd_plain(x, dt, a, bm, cm, chunk=64)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    x_cols = x.transpose(2, 3).contiguous().transpose(2, 3)   # p not innermost
    with pytest.raises(ValueError, match="contiguous"):
        k4.ssd(x_cols, dt, a, bm, cm, chunk=64)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.bfloat16, 2e-2)])
def test_ssd_kernel_at_wrapper_limits(dtype, tol):
    """chunk 1024 and N 256, the largest the wrapper takes, over two chunks
    with state_in.  bf16 is held as everywhere (y 2e-2, state 1e-4).  In
    float32, cums grows to |cums| ~ 10^3 over 1024 steps; its float32
    rounding (~6e-5) moves e^(cums_i - cums_j) by ~1e-4 relative, and the
    kernel and its plain version sum cums in different orders, so y and the
    state are held at 1e-3 here (up to 4.3e-4 measured on an H100)."""
    x, dt, a, bm, cm, st = _ssd_inputs(1, 1100, 4, 1, 256, 64, dtype, 1104)
    y, state = k4.ssd(x, dt, a, bm, cm, chunk=1024, state_in=st, return_state=True)
    torch.cuda.synchronize()
    want_y, want_state = k4.ssd_plain(x, dt, a, bm, cm, chunk=1024, state_in=st,
                                      return_state=True)
    torch.testing.assert_close(y.float(), want_y.float(), atol=tol, rtol=tol)
    stol = 1e-4 if dtype == torch.bfloat16 else tol
    torch.testing.assert_close(state, want_state, atol=stol, rtol=stol)


@pytest.mark.parametrize("dtype,ytol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("b,s,h,g,n,p,chunk,with_state", [
    (1, 512, 64, 1, 128, 64, 256, False),  # mamba2-1.3b prefill shape
    (1, 300, 64, 1, 128, 64, 256, True),   # ragged S with state_in
    (2, 200, 4, 2, 32, 64, 64, True),      # G=2, 4 chunks
    (1, 100, 2, 1, 8, 24, 64, True),       # N=8, P=24
])
def test_ssd_stage_kernels_match_plain_stages(b, s, h, g, n, p, chunk, with_state,
                                              dtype, ytol):
    """Each kernel stage against its plain stage on the same inputs: the
    chunk states (cums, S^) from x, dt, A, B; the carry (S_in per chunk, in
    bf16 as its two bf16 halves; the final state) from the kernel's S^ (in
    float32, whose carry writes S_in over S^, from the plain S^) and
    cums[-1]; the chunk scan (y) from the kernel's cums and S_in.  cums and
    states are float32 (1e-4; cums are sums of up to 256 steps of |dt A| ~ 1,
    summed in another order); y is held at its dtype's tolerance (bf16 2e-2,
    float32 1e-4)."""
    x, dt, a, bm, cm, st = _ssd_inputs(b, s, h, g, n, p, dtype, s + n)
    state_in = st if with_state else None
    got = k4.ssd_stages(x, dt, a, bm, cm, chunk=chunk, state_in=state_in)
    torch.cuda.synchronize()
    cums, shat = k4.ssd_chunk_state_plain(x, dt, a, bm, chunk=chunk)
    torch.testing.assert_close(got["cums"], cums, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got["last"], cums[..., -1], atol=1e-4, rtol=1e-4)
    if dtype == torch.float32:
        assert got["shat"] is None
    else:
        torch.testing.assert_close(got["shat"], shat, atol=1e-4, rtol=1e-4)
        shat = got["shat"]
    s_in, final = k4.ssd_state_pass_plain(shat, got["last"], state_in)
    torch.testing.assert_close(got["s_in"], s_in, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got["state"], final, atol=1e-4, rtol=1e-4)
    y = k4.ssd_chunk_scan_plain(x, dt, bm, cm, got["cums"], got["s_in"], chunk=chunk)
    torch.testing.assert_close(got["y"].float(), y.float(), atol=ytol, rtol=ytol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_kernel_repeats_bit_identical(with_state, dtype):
    """Two calls in a row and three replays of a captured CUDA graph give the
    same bits: no atomics in the sums, and the carry's ticket counters are
    left at 0 for the next call or replay."""
    x, dt, a, bm, cm, st = _ssd_inputs(1, 512, 64, 1, 128, 64, dtype, 3)
    state_in = st if with_state else None
    first = k4.ssd(x, dt, a, bm, cm, chunk=256, state_in=state_in, return_state=True)
    second = k4.ssd(x, dt, a, bm, cm, chunk=256, state_in=state_in, return_state=True)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(first, second))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k4.ssd(x, dt, a, bm, cm, chunk=256, state_in=state_in, return_state=True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = k4.ssd(x, dt, a, bm, cm, chunk=256, state_in=state_in, return_state=True)
    for _ in range(3):
        for t in out:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(out, first))


def _ssd_call(shape, dtype, backward):
    """One K4 call (forward with the final state, or the backward) on inputs
    drawn from ``shape``; returns its outputs."""
    b, s, h, g, n, p, chunk = shape
    x, dt, a, bm, cm, st = _ssd_inputs(b, s, h, g, n, p, dtype, s + h)
    if backward:
        dy = _normal((b, s, h, p), torch.float32, 8)
        ds = _normal((b, h, n, p), torch.float32, 9)
        return [t for t in k4.ssd_bwd(x, dt, a, bm, cm, dy, chunk=chunk, state_in=st,
                                      dstate=ds) if t is not None]
    return list(k4.ssd(x, dt, a, bm, cm, chunk=chunk, state_in=st, return_state=True))


@pytest.mark.parametrize("calls", [
    [((1, 512, 64, 1, 128, 64, 256), torch.float32, False),
     ((2, 300, 8, 2, 32, 24, 64), torch.float32, False)],
    [((1, 512, 64, 1, 128, 64, 256), torch.bfloat16, False),
     ((1, 512, 64, 1, 128, 64, 256), torch.float32, False),
     ((2, 333, 8, 1, 64, 64, 128), torch.float32, True)],
], ids=["two shapes", "bf16, float32, backward"])
def test_ssd_calls_alternating_on_one_stream_repeat_bit_identical(calls):
    """Calls that alternate shapes, dtypes and the backward share the
    "ssd" ticket counters on one stream: each call leaves them at 0, so the
    second round repeats the first bit for bit (a ticket left behind would
    end a carry early or never)."""
    first = [_ssd_call(*call) for call in calls]
    second = [_ssd_call(*call) for call in calls]
    torch.cuda.synchronize()
    for u, v in zip(first, second):
        assert all(torch.equal(a, b) for a, b in zip(u, v))


def test_ssd_float32_with_more_chunk_blocks_than_sms():
    """More (batch * head, chunk) blocks than the card has SMs (B=2, S=1024,
    H=64: 512): the float32 forward and the backward hold their plain
    versions, and the carries by the last block of each head are complete."""
    b, s, h, g, n, p, chunk = 2, 1024, 64, 1, 128, 64, 256
    assert b * h * (s // chunk) > torch.cuda.get_device_properties(0).multi_processor_count
    x, dt, a, bm, cm, st = _ssd_inputs(b, s, h, g, n, p, torch.float32, 11)
    y, state = k4.ssd(x, dt, a, bm, cm, chunk=chunk, state_in=st, return_state=True)
    dy = _normal((b, s, h, p), torch.float32, 12)
    ds = _normal((b, h, n, p), torch.float32, 13)
    got = k4.ssd_bwd(x, dt, a, bm, cm, dy, chunk=chunk, state_in=st, dstate=ds)
    torch.cuda.synchronize()
    want_y, want_state = k4.ssd_plain(x, dt, a, bm, cm, chunk=chunk, state_in=st,
                                      return_state=True)
    torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(state, want_state, atol=1e-4, rtol=1e-4)
    want = k4.ssd_bwd_plain(x, dt, a, bm, cm, dy, chunk=chunk, state_in=st, dstate=ds)
    for u, w in zip(got, want):
        assert _max_rel(u, w) <= 1e-4


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_ssd_kernel_reads_unaligned_views(dtype, tol):
    """x, B, C as slices of a conv output that starts one element in and has
    an odd row width: no view is 16-byte aligned, so the kernels load element
    by element; the results are held as the aligned ones are."""
    b, s, h, g, n, p = 2, 300, 8, 1, 128, 64
    rng = np.random.default_rng(5)
    width = 1 + h * p + 2 * g * n + 1
    conv = torch.from_numpy(rng.standard_normal((b, s, width), dtype=np.float32)
                            * 0.3).to("cuda", dtype)
    x = conv[..., 1:1 + h * p].unflatten(-1, (h, p))
    bm = conv[..., 1 + h * p:1 + h * p + g * n].unflatten(-1, (g, n))
    cm = conv[..., 1 + h * p + g * n:-1].unflatten(-1, (g, n))
    assert x.data_ptr() % 16 and x.stride(1) % 8
    _, dt, a, _, _, st = _ssd_inputs(b, s, h, g, n, p, dtype, 6)
    got_y, got_st = k4.ssd(x, dt, a, bm, cm, chunk=128, state_in=st, return_state=True)
    torch.cuda.synchronize()
    want_y, want_st = k4.ssd_plain(x, dt, a, bm, cm, chunk=128, state_in=st,
                                   return_state=True)
    torch.testing.assert_close(got_y.float(), want_y.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(got_st, want_st, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,w,with_h0", [
    (1, 512, 4096, True),       # recurrentgemma-9b prefill shape
    (1, 512, 4096, False),
    (2, 33, 100, True),         # ragged W, one chunk
    (3, 200, 130, True),        # ragged S over 4 chunks
    (1, 1, 16, True),           # one step
])
def test_rglru_kernel_matches_plain(b, s, w, with_h0, dtype, tol):
    rng = np.random.default_rng(s + w)
    a = torch.from_numpy(1 / (1 + np.exp(-rng.standard_normal((b, s, w),
                                                              dtype=np.float32))))
    x = torch.from_numpy(rng.standard_normal((b, s, w), dtype=np.float32))
    a, x = a.to("cuda", dtype), x.to("cuda", dtype)
    h0 = (torch.from_numpy(rng.standard_normal((b, w), dtype=np.float32)).cuda()
          if with_h0 else None)
    before = k5.rglru.launches
    got = k5.rglru(a, x, h0)
    torch.cuda.synchronize()
    assert k5.rglru.launches == before + 1 and got.dtype == dtype
    want = k5.rglru_plain(a, x, h0)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_flash_kernel_rejects_unsupported_head_dim():
    q = _normal((1, 8, 2, 48), torch.bfloat16, 0)
    with pytest.raises(ValueError, match="hd"):
        k1.flash_attention(q, q, q)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,h,kv,hd,cur,window,cap", [
    (8, 640, 32, 8, 128, 576, 0, 0.0),        # generation path shape
    (8, 640, 32, 8, 128, 513, 0, 0.0),        # cur_len one past a split edge
    (2, 100, 8, 2, 64, 100, 0, 0.0),          # ragged S, full cache
    (4, 640, 32, 8, 128, [1, 128, 300, 640], 0, 0.0),   # cur_len per row
    (8, 640, 32, 8, 128, 576, 128, 0.0),      # sliding window
    (8, 640, 32, 8, 128, 576, 0, 50.0),       # soft-cap
    (2, 96, 8, 1, 32, 77, 16, 30.0),          # MQA (G=8) + window + cap
    (2, 64, 4, 4, 16, 33, 0, 0.0),            # MHA, smallest head dim
    (3, 200, 32, 1, 64, [5, 199, 120], 0, 0.0),  # G=32: four head groups
    (1, 32768, 32, 8, 128, 30001, 0, 0.0),    # long cache, many splits
    (2, 64, 32, 8, 128, 50, 0, 0.0),          # one split: no combine
    (8, 640, 32, 8, 128, 1, 0, 0.0),          # one valid key
    (8, 640, 32, 8, 128, 640, 0, 0.0),        # the whole cache
    (8, 640, 32, 8, 128, [576, 1, 640, 128, 129, 64, 65, 2], 0, 0.0),
])
def test_decode_kernel_matches_plain(b, s, h, kv, hd, cur, window, cap, dtype, tol):
    q = _normal((b, h, hd), dtype, 1)
    kc = _normal((b, s, kv, hd), dtype, 2)
    vc = _normal((b, s, kv, hd), dtype, 3)
    cur_len = torch.tensor(cur, dtype=torch.int32, device="cuda")
    n_split, _ = k3.split_plan(b, h, kv, s, torch.cuda.get_device_properties(0)
                               .multi_processor_count)
    before = k3.decode_attention.launches
    got = k3.decode_attention(q, kc, vc, cur_len, window=window, logit_cap=cap)
    torch.cuda.synchronize()
    assert k3.decode_attention.launches == before + 1
    want = k3.decode_attention_plain(q, kc, vc, cur_len, window=window,
                                     logit_cap=cap)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if s == 32768:
        assert n_split > 8
    if s == 64:
        assert n_split == 1


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,h,kv,hd,cur,window,cap", [
    (8, 640, 16, 8, 256, 576, 0, 50.0),     # gemma2-9b decode (G=2), soft-cap
    (8, 640, 16, 8, 256, 576, 4096, 50.0),  # gemma2's local layers
    (2, 100, 8, 1, 256, 77, 16, 30.0),      # hd 256, G=8: 4 heads a block
    (1, 32768, 16, 8, 256, 30001, 0, 0.0),  # hd 256, many splits
    (3, 200, 16, 8, 256, [5, 199, 120], 0, 0.0),  # hd 256, cur_len per row
    (2, 64, 7, 1, 8, 33, 0, 0.0),           # hd 8, G=7
    (4, 640, 6, 6, 8, [1, 128, 300, 640], 0, 0.0),  # hd 8 MHA, per row
    (2, 100, 8, 8, 8, 100, 12, 0.0),        # hd 8, window
    (8, 640, 32, 32, 80, 576, 0, 0.0),      # stablelm-3b decode (hd 80, MHA)
    (3, 200, 8, 2, 80, [5, 199, 120], 16, 30.0),  # hd 80, per row, window, cap
    (2, 100, 8, 1, 80, 77, 0, 0.0),         # hd 80, G=8: 4 heads a block
    (1, 32768, 32, 32, 80, 30001, 0, 0.0),  # hd 80, many splits
    (4, 640, 32, 32, 80, [1, 128, 300, 640], 0, 0.0),  # hd 80, ragged cur_len
])
def test_decode_kernel_new_head_dims(b, s, h, kv, hd, cur, window, cap, dtype, tol):
    """K3 at hd 256 (a warp a bf16 key row, two pieces a lane in float32, at
    most 4 heads a block), hd 8 (one or two lanes a row) and hd 80 (16 or 32
    lanes a row, of which 10 or 20 hold a piece)."""
    q = _normal((b, h, hd), dtype, 1)
    kc = _normal((b, s, kv, hd), dtype, 2)
    vc = _normal((b, s, kv, hd), dtype, 3)
    cur_len = torch.tensor(cur, dtype=torch.int32, device="cuda")
    before = k3.decode_attention.launches
    got = k3.decode_attention(q, kc, vc, cur_len, window=window, logit_cap=cap)
    torch.cuda.synchronize()
    assert k3.decode_attention.launches == before + 1
    want = k3.decode_attention_plain(q, kc, vc, cur_len, window=window,
                                     logit_cap=cap)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("cur", [576, [576, 1, 640, 300, 129, 128, 2, 513]])
def test_decode_kernel_repeats_bit_identical(cur):
    """Two calls in a row and three replays of a captured CUDA graph give the
    same bits: the last block of each head group combines the chunks in split
    order and leaves its ticket counter at 0 for the next call or replay."""
    b, s, h, kv, hd = 8, 640, 32, 8, 128
    q = _normal((b, h, hd), torch.bfloat16, 7)
    kc = _normal((b, s, kv, hd), torch.bfloat16, 8)
    vc = _normal((b, s, kv, hd), torch.bfloat16, 9)
    cur_len = torch.tensor(cur, dtype=torch.int32, device="cuda")
    first = k3.decode_attention(q, kc, vc, cur_len)
    second = k3.decode_attention(q, kc, vc, cur_len)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k3.decode_attention(q, kc, vc, cur_len)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = k3.decode_attention(q, kc, vc, cur_len)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first)
    want = k3.decode_attention_plain(q, kc, vc, cur_len)
    torch.testing.assert_close(first.float(), want.float(), atol=2e-2, rtol=2e-2)


def test_decode_kernel_int_cur_len_and_rejects():
    q = _normal((2, 8, 64), torch.bfloat16, 4)
    kc = _normal((2, 50, 2, 64), torch.bfloat16, 5)
    got = k3.decode_attention(q, kc, kc, 37)
    want = k3.decode_attention_plain(q, kc, kc, 37)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    with pytest.raises(ValueError, match="hd"):
        k3.decode_attention(q[..., :48].contiguous(), kc[..., :48].contiguous(),
                            kc[..., :48].contiguous(), 3)
    strided = torch.empty(2, 2, 50, 64, dtype=torch.bfloat16,
                          device="cuda").transpose(1, 2)     # [2,50,2,64] view
    with pytest.raises(ValueError, match="contiguous"):
        k3.decode_attention(q, strided, strided, 3)
    with pytest.raises(ValueError, match="lies on"):
        k3.decode_attention(q, kc, kc, torch.tensor(3))


LSE_TOL = 1e-4   # K3's lse is float32 arithmetic in both dtypes


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,h,kv,hd,cur,window,cap,ranks", [
    (8, 640, 32, 8, 128, 576, 0, 0.0, 4),       # llama3-8b decode, 4 slices
    (8, 640, 32, 8, 128, [576, 1, 640, 128, 129, 64, 65, 2], 0, 0.0, 2),
    (8, 640, 16, 8, 256, 576, 0, 50.0, 4),      # gemma2-9b, soft-cap
    (8, 640, 16, 8, 256, 576, 200, 50.0, 4),    # a window across 2 slices
    (8, 640, 32, 32, 80, 576, 0, 0.0, 4),       # stablelm-3b's hd 80
    (3, 200, 8, 2, 80, [5, 199, 120], 16, 30.0, 2),
    (1, 32768, 32, 8, 128, 30001, 0, 0.0, 4),   # many splits a slice
])
def test_decode_kernel_partial_form(b, s, h, kv, hd, cur, window, cap, ranks,
                                    dtype, tol):
    """K3's partial form: on each of ``ranks`` slot ranges of the cache
    (slot 0 at ``start``) o matches the plain version's at the output's
    tolerance and lse, a float32 result in both dtypes, at 1e-4 (absolute
    and relative); a range with no valid slot gives o = 0 and lse = -inf;
    the ranges combined by lse match the whole cache."""
    q = _normal((b, h, hd), dtype, 1)
    kc = _normal((b, s, kv, hd), dtype, 2)
    vc = _normal((b, s, kv, hd), dtype, 3)
    cur_len = torch.tensor(cur, dtype=torch.int32, device="cuda")
    n = s // ranks
    outs, lses = [], []
    for r in range(ranks):
        part = (kc[:, r * n:(r + 1) * n].contiguous(),
                vc[:, r * n:(r + 1) * n].contiguous())
        before = k3.decode_attention.launches
        o, lse = k3.decode_attention(q, *part, cur_len, window=window,
                                     logit_cap=cap, start=r * n, return_lse=True)
        torch.cuda.synchronize()
        assert k3.decode_attention.launches == before + 1
        wo, wl = k3.decode_attention_plain(q, *part, cur_len, window=window,
                                           logit_cap=cap, start=r * n,
                                           return_lse=True)
        torch.testing.assert_close(o.float(), wo.float(), atol=tol, rtol=tol)
        empty = torch.isinf(wl)
        assert torch.equal(torch.isinf(lse), empty)
        assert not o[empty].any()
        torch.testing.assert_close(lse[~empty], wl[~empty], atol=LSE_TOL,
                                   rtol=LSE_TOL)
        outs.append(o)
        lses.append(lse)
    got = k3.combine_partials(torch.stack(outs), torch.stack(lses))
    want = k3.decode_attention_plain(q, kc, vc, cur_len, window=window,
                                     logit_cap=cap)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _recording(bundle, logits_log):
    def prefill(params, batch, max_len=None):
        logits, cache = bundle.prefill(params, batch, max_len=max_len)
        logits_log.append([logits.cpu().numpy()])
        return logits, cache

    def decode(params, cache, tokens, pos):
        logits, cache = bundle.decode(params, cache, tokens, pos)
        logits_log[-1].append(logits.cpu().numpy())
        return logits, cache

    return dataclasses.replace(bundle, prefill=prefill, decode=decode)


def test_wave_batcher_card_matches_cpu():
    """Greedy generation on the reduced model: the card (K1, K3 kernels)
    and the CPU (plain versions) give the same stats and the same tokens,
    except where the CPU's top-2 margin at that step is under 10 % of the
    logit scale (bf16 activations round differently on the two devices)."""
    bundle = get_bundle("llama3-8b", reduced=True)
    cpu_params = bundle.init(torch.Generator().manual_seed(0), "cpu",
                             torch.float32)
    gpu_params = tree_map(lambda a: a.to("cuda"), cpu_params)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, bundle.cfg.vocab, 9 + 3 * i, dtype=np.int32)
               for i in range(7)]
    runs = []
    for params in (cpu_params, gpu_params):
        log = []
        wb = WaveBatcher(_recording(bundle, log), params, max_batch=4,
                         max_len=64)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=12)
                for i, p in enumerate(prompts)]
        for r in reqs:
            wb.submit(r)
        k1_0, k3_0 = k1.flash_attention.launches, k3.decode_attention.launches
        stats = wb.run()
        runs.append((stats, reqs, log, k1.flash_attention.launches - k1_0,
                     k3.decode_attention.launches - k3_0))
    (cs, creqs, clog, _, _), (gs, greqs, _, k1_n, k3_n) = runs
    assert vars(gs) == vars(cs) and gs.waves == 2
    n_layers = bundle.cfg.n_layers
    assert k1_n == n_layers * gs.waves and k3_n == n_layers * gs.decode_steps
    for i, (cr, gr) in enumerate(zip(creqs, greqs)):
        assert len(gr.output) == len(cr.output) == 12
        w, row = divmod(i, 4)
        for step, (a, g) in enumerate(zip(cr.output, gr.output)):
            if a != g:
                top = np.sort(clog[w][step][row])
                assert top[-1] - top[-2] < 0.10 * np.abs(top).max(), (i, step)
                break


FLEET_PROBES = {"kernel": ("migrate_fixed_point", "migrate"),
                "splitter": ("solve_batch",),
                "repairer": ("repair_and_price_batch",)}


def _tensors(x, f):
    """``x`` with ``f`` applied to every tensor inside it."""
    if isinstance(x, torch.Tensor):
        return f(x)
    if dataclasses.is_dataclass(x):
        x = {k.name: getattr(x, k.name) for k in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _tensors(v, f) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return [_tensors(v, f) for v in x]
    return x


def _same(a, b, exact):
    """Bit for bit (``exact``), else integers identical, floats to 1e-9."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k], exact)
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y, exact)
    elif isinstance(a, (np.ndarray, float)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        if exact or a.dtype.kind != "f":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-9, atol=0)
    else:
        assert a == b


def _fleet_run(device, n_sessions=16, cycles=8, spike=False):
    """The reference benchmark's saturated fleet on ``device``; ``spike``
    saturates the home MEC two cycles in eight, so that moves commit.
    Returns the decisions and latencies per cycle, every candidate that the
    fixed point, migration DP, re-split DP and repair pass computed, and
    the resident rows."""
    from repro_torch.core import (CapacityProfiler, FleetOrchestrator,
                                  InProcessAgent, ReconfigurationBroadcast,
                                  Thresholds, Workload)
    from repro_torch.edgesim import (MECScenarioParams, base_system_state,
                                     fleet_model_catalog)

    state = base_system_state(MECScenarioParams())
    orch = FleetOrchestrator(
        profiler=CapacityProfiler(base_state=state),
        broadcast=ReconfigurationBroadcast(
            [InProcessAgent(i) for i in range(state.num_nodes)]),
        thresholds=Thresholds(cooldown_s=0.5), solve_backoff_s=0.0,
        device=device)
    rng = np.random.default_rng(0)
    catalog = fleet_model_catalog()
    for _ in range(n_sessions):
        _, graph = catalog[int(rng.integers(len(catalog)))]
        wl = Workload(tokens_in=int(rng.integers(32, 96)),
                      tokens_out=int(rng.integers(8, 16)),
                      arrival_rate=float(rng.uniform(2.0, 5.0)))
        orch.admit(graph, wl, source_node=int(rng.integers(0, 3)), now=0.0)
    probes = []
    for part, names in FLEET_PROBES.items():
        obj = getattr(orch, part)
        for name in names:
            def call(*a, _fn=getattr(obj, name), **k):
                out = _fn(*a, **k)
                probes.append(_tensors(out, torch.clone))
                return out
            setattr(obj, name, call)
    decisions, lats = [], []
    for c in range(cycles):
        if spike:
            state.background_util[0] = 0.85 if c % 8 in (5, 6) else 0.35
        fd = orch.step(now=float(c))
        decisions.append((fd.n_keep, fd.n_migrate, fd.n_resplit,
                          fd.n_cooldown, fd.fixed_point_sweeps,
                          fd.fixed_point_aborts, tuple(
                              (sid, d.kind.value, d.config.boundaries,
                               d.config.assignment)
                              for sid, d in fd.per_session.items())))
        lats.append([d.predicted_latency_s for d in fd.per_session.values()])
    buf = orch._buffers
    tables = {k: getattr(buf, k).cpu() for k in (
        "seg_flops", "seg_wbytes", "seg_node", "valid", "n_segs", "lam",
        "source", "active")}
    cands = _tensors(probes, lambda x: x.cpu().numpy())
    return decisions, np.array(lats), tables, cands


def _assert_fleet_runs_agree(**kw):
    d1, l1, t1, c1 = _fleet_run("cuda", **kw)
    d2, l2, t2, c2 = _fleet_run("cuda", **kw)
    dc, lc, tc, cc = _fleet_run("cpu", **kw)
    assert d1 == d2 == dc
    np.testing.assert_array_equal(l1, l2)
    np.testing.assert_allclose(l1, lc, rtol=1e-9, atol=0)
    _same(c1, c2, exact=True)
    _same(c1, cc, exact=False)
    for k in t1:
        assert torch.equal(t1[k], t2[k]), k
        assert torch.equal(t1[k], tc[k]), k
    return d1


def test_fleet_runs_are_bit_identical_on_the_card_and_match_the_cpu():
    """Two card runs of one fleet give bit-identical resident tables,
    decisions and candidates (no atomic float accumulation on the path);
    both equal the CPU run, latencies and candidates to 1e-9 relative."""
    _assert_fleet_runs_agree()


def test_fleet_moves_commit_identically_on_the_card_and_the_cpu():
    """The saturated fleets keep every session; at 8 sessions a home-MEC
    spike makes migrations and re-splits commit, and the card's commits,
    candidates and resident rows equal the CPU's."""
    d = _assert_fleet_runs_agree(n_sessions=8, cycles=12, spike=True)
    assert sum(c[1] + c[2] for c in d) > 0


def _admission_run(device, journal, ticks=20, crash_at=8.0):
    """A 16-session admission stream on the §IV cluster on ``device``:
    heartbeats, forecast on, MEC-1 down from tick 10 to 15, transport faults
    in ticks 3-6, and one controller crash at ``crash_at`` restored from the
    journal saved at the end of every tick.  Returns every verdict (kind,
    sid, reason, latency), each step's decisions and latencies, the
    preemptions, the defer queue and the final kpis."""
    from repro_torch.core import (AdmissionRequest, CapacityForecaster,
                                  CapacityProfiler, FlakyAgent,
                                  FleetAdmissionController, FleetOrchestrator,
                                  ForecastConfig, InProcessAgent, QOS_CLASSES,
                                  ReconfigurationBroadcast, Thresholds,
                                  Workload)
    from repro_torch.distributed import HeartbeatRegistry
    from repro_torch.edgesim import (MECScenarioParams, base_system_state,
                                     fleet_model_catalog)

    base = base_system_state(MECScenarioParams())
    agents = [FlakyAgent(InProcessAgent(i), seed=9000 + i, drop_p=0.2,
                         dup_p=0.15, delay_p=0.1, windows=((3.0, 7.0),))
              for i in range(base.num_nodes)]

    def fresh():
        orch = FleetOrchestrator(
            profiler=CapacityProfiler(base_state=base.copy()),
            broadcast=ReconfigurationBroadcast(list(agents)),
            thresholds=Thresholds(cooldown_s=2.0),
            forecaster=CapacityForecaster(ForecastConfig(
                horizon_steps=8, season_steps=8), device=device),
            heartbeats=HeartbeatRegistry(list(range(base.num_nodes))),
            device=device)
        return orch, FleetAdmissionController(
            orch, max_sessions=16, queue_cap=8, preempt_patience_s=20.0)

    orch, ctrl = fresh()
    rng = np.random.default_rng(4)
    catalog = fleet_model_catalog()
    log = []
    for tick in range(ticks):
        t = float(tick)
        if t == crash_at:
            orch, ctrl = fresh()
            orch.load(journal, admission=ctrl, claim_epoch=True)
        for a in agents:
            a.now = t
        state = base.copy()
        down = 10.0 <= t < 15.0
        if down:
            state.mem_bytes[1] = 0.0
            state.background_util[1] = 0.99
            state.link_bw[1, :] = state.link_bw[:, 1] = 1.0
            state.link_bw[1, 1] = np.inf
        orch.profiler.base_state = state
        for node in range(base.num_nodes):
            if not (down and node == 1):
                orch.heartbeats.beat(node)
        if tick % 7 == 6 and orch.sessions:
            orch.depart(min(orch.sessions))
        for _, v in ctrl.poll(t):
            log.append((v.kind.value, v.sid, v.reason, v.predicted_latency_s))
        for _ in range(int(rng.poisson(8.0 if tick == 0 else 2.0))):
            arch, graph = catalog[int(rng.integers(len(catalog)))]
            req = AdmissionRequest(
                graph, Workload(int(rng.integers(16, 97)),
                                int(rng.integers(4, 17)),
                                float(rng.uniform(0.3, 2.0))),
                source_node=int(rng.integers(3)), arch=arch,
                qos=QOS_CLASSES[("interactive", "standard", "batch")[
                    int(rng.integers(3))]], t_submit=t)
            v = ctrl.request(req, now=t)
            log.append((v.kind.value, v.sid, v.reason, v.predicted_latency_s))
        if orch.sessions:
            fd = orch.step(now=t)
            log.append(tuple((sid, d.kind.value, d.reasons, d.config.version,
                              d.config.assignment, d.predicted_latency_s)
                             for sid, d in fd.per_session.items()))
            if fd.infeasible_sids:
                log.append(tuple(s.sid for s, _ in
                                 ctrl.preempt_overload(t, state=state)))
        log.append(tuple((d, r.workload.arrival_rate, r.preempted)
                         for d, r, _ in ctrl._queue))
        orch.save(journal, admission=ctrl)
    log.append(ctrl.kpis())
    return log


def _floats_close(a, b, rtol):
    """Nested equality, floats to ``rtol`` relative (0: bit for bit)."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or abs(a - b) <= rtol * max(abs(a), abs(b))
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            _floats_close(x, y, rtol) for x, y in zip(a, b))
    if isinstance(a, dict):
        return list(a) == list(b) and all(
            _floats_close(a[k], b[k], rtol) for k in a)
    return a == b


def test_admission_stream_with_a_crash_is_bit_identical_and_matches_the_cpu(
        tmp_path):
    """Two card runs of an admission stream with one crash and restore are
    bit-identical; the run equals the CPU run (verdicts exact, latencies
    1e-9 relative)."""
    a = _admission_run("cuda", tmp_path / "a.npz")
    b = _admission_run("cuda", tmp_path / "b.npz")
    cpu = _admission_run("cpu", tmp_path / "c.npz")
    assert _floats_close(a, b, 0.0)
    assert _floats_close(a, cpu, 1e-9)
    kinds = {x[0] for x in a if isinstance(x, tuple) and x
             and x[0] in ("accept", "defer", "reject")}
    assert kinds == {"accept", "defer", "reject"}


def _sharded_run(device):
    """A 3-region sharded fleet on ``device``: 4 sessions a region, region
    1's MEC nodes saturated from the second cycle until sessions move to
    other regions.  Returns every cycle's decisions and latencies, every
    screen's outputs, the final resident tables, the sids by region, the
    cross moves and the orchestrator."""
    from repro_torch.core import (QOS_INTERACTIVE, Workload,
                                  make_transformer_graph)
    from repro_torch.edgesim import (MECScenarioParams,
                                     build_regional_orchestrator)

    w = build_regional_orchestrator(MECScenarioParams(), 3, device=device)
    g = make_transformer_graph(
        name="tiny", num_layers=8, d_model=256, flops_per_layer_token=4e9,
        weight_bytes_per_layer=3e8, embed_weight_bytes=1e8,
        head_weight_bytes=1e8, head_flops_token=2e8)
    for r in range(3):
        for i in range(4):
            w.admit(g, Workload(48, 8, 0.8), source_node=4 * r + i % 3,
                    now=0.0, qos=QOS_INTERACTIVE)
    screens = []
    screen = w._shstate.screen

    def probe(states, **kw):
        out = screen(states, **kw)
        screens.append(dataclasses.astuple(out))
        return out

    w._shstate.screen = probe
    log = []
    for t in range(1, 24):
        if t == 2:
            w.inners[1].profiler.base_state.background_util[:3] = 0.97
        fd = w.step(float(t))
        log.append((fd.n_keep, fd.n_migrate, fd.n_resplit, fd.n_cooldown,
                    tuple((sid, d.kind.value, d.config.assignment,
                           d.predicted_latency_s)
                          for sid, d in fd.per_session.items())))
    tables = [{k: getattr(o._buffers, k).cpu() for k in (
        "seg_flops", "seg_wbytes", "seg_node", "valid", "n_segs", "lam",
        "source", "active")} for o in w.inners]
    return (log, screens, tables, [sorted(o.sessions) for o in w.inners],
            w.cross_migrations, w)


def test_sharded_fleet_is_bit_identical_on_the_card_and_matches_the_cpu():
    """Two card runs of a 3-region sharded fleet give bit-identical
    decisions, screens and resident tables, and equal the CPU run (floats
    to 1e-9 relative); sessions leave the saturated region; a screen
    equals each shard's own price on the card to 1e-12."""
    a = _sharded_run("cuda")
    b = _sharded_run("cuda")
    cpu = _sharded_run("cpu")
    assert _floats_close(a[0], b[0], 0.0) and _floats_close(a[0], cpu[0],
                                                              1e-9)
    assert a[3] == b[3] == cpu[3] and a[4] == b[4] == cpu[4] > 0
    for sa, sb, sc in zip(a[1], b[1], cpu[1]):
        for x, y, z in zip(sa, sb, sc):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_allclose(z, x, rtol=1e-9, atol=0)
    for ta, tb, tc in zip(a[2], b[2], cpu[2]):
        for k in ta:
            assert torch.equal(ta[k], tb[k]) and torch.equal(ta[k], tc[k]), k
    # the screen's row block s is shard s's own price on the card (1e-12)
    w = a[5]
    sh = w._sharded()
    states = [o.profiler.system_state() for o in w.inners]
    scr = sh.screen(states, weights=w.inners[0].weights,
                    bw_floor=w.inners[0].bw_floor_frac)
    for s, o in enumerate(w.inners):
        p = o.kernel.price(o._buffers, states[s], weights=o.weights,
                           bw_floor=o.bw_floor_frac)
        for f in ("lat", "max_util", "min_bw", "tot_node", "tot_w"):
            np.testing.assert_allclose(getattr(scr, f)[s],
                                       getattr(p, f).cpu().numpy(),
                                       rtol=1e-12, atol=0, err_msg=f)


def _storm_sim_run(device):
    """tests/test_fault_tolerance.py's 30 s cap-8 storm through the port's
    FleetSimulator: MEC-1 and MEC-2 dead from 8 s for 14 s."""
    from repro_torch.edgesim import (FailureSpec, FleetScenarioParams,
                                     FleetSimConfig, build_fleet_scenario)

    p = FleetScenarioParams(sim=FleetSimConfig(
        duration_s=30.0, tick_s=0.5, monitor_interval_s=2.0, max_sessions=8,
        initial_sessions=4, session_arrival_per_s=0.3, mean_lifetime_s=40.0,
        seed=7, failures=FailureSpec(seed=3, blast_at_s=8.0,
                                     blast_nodes=(1, 2), blast_mttr_s=14.0),
        preempt_patience_s=20.0))
    sim = build_fleet_scenario(p, device=device)
    assert sim.device.type == device
    res = sim.run()
    ticks = [(m.t, m.n_sessions, m.admitted, m.departed, m.rejected,
              m.deferred, m.n_migrate, m.n_resplit, m.n_dead_nodes,
              m.preempted, m.recovered, m.mem_violation_bytes)
             for m in res.ticks]
    floats = [(m.latencies, m.node_rho) for m in res.ticks]
    return res.session_log, ticks, floats


def test_storm_simulation_is_bit_identical_on_the_card_and_matches_the_cpu():
    """Two card runs of the cap-8 storm give the same session log, tick
    counts, latencies and node rho bit for bit; the CPU run gives the same
    log and counts, floats to 1e-9 relative."""
    a = _storm_sim_run("cuda")
    b = _storm_sim_run("cuda")
    cpu = _storm_sim_run("cpu")
    assert a[0] == b[0] == cpu[0]
    assert a[1] == b[1] == cpu[1]
    assert any(t[8] == 2 for t in a[1])            # the blast was seen
    for (la, ra), (lb, rb), (lc, rc) in zip(a[2], b[2], cpu[2]):
        np.testing.assert_array_equal(la, lb)
        np.testing.assert_array_equal(ra, rb)
        np.testing.assert_allclose(lc, la, rtol=1e-9, atol=0)
        np.testing.assert_allclose(rc, ra, rtol=1e-9, atol=0)


# --------------------------------------------------------------------------- #
# K1's backward (training)
# --------------------------------------------------------------------------- #
def _max_rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


BWD_CASES = [
    (2, 512, 32, 8, 128, 128, True, 0, 0.0, None),     # llama3-8b's training shape
    (8, 256, 8, 8, 64, 64, True, 0, 0.0, None),        # the quickstart recipe
    (2, 100, 4, 2, 32, 32, True, 16, 50.0, 16.0 ** -0.5),  # reduced gemma2
    (2, 77, 7, 1, 8, 8, True, 0, 0.0, None),           # hd 8, G = 7, ragged S
    (1, 130, 4, 2, 16, 16, True, 48, 0.0, None),       # hd 16, window, ragged S
    (2, 96, 4, 4, 64, 64, False, 0, 30.0, None),       # non-causal, soft-cap
    (1, 200, 8, 2, 128, 128, True, 64, 20.0, None),    # hd 128: window and cap
    (1, 65, 2, 1, 32, 32, False, 24, 0.0, None),       # non-causal window, 2 tiles
    (1, 512, 8, 2, 64, 64, True, 0, 0.0, None),        # G = 4: partials, fixed-order sum
    (2, 192, 4, 4, 128, 128, True, 0, 0.0, None),      # G = 1: no scratch
    (2, 40, 6, 2, 32, 32, True, 0, 0.0, None),         # S < 64: one tile
    (4, 384, 16, 4, 64, 64, True, 0, 0.0, None),       # 384 work items, > 132 SMs
    (2, 512, 16, 8, 256, 256, True, 4096, 50.0, 224.0 ** -0.5),  # gemma2-9b local
    (2, 512, 16, 8, 256, 256, True, 0, 50.0, 224.0 ** -0.5),     # gemma2-9b global
    (2, 512, 16, 1, 256, 256, True, 2048, 0.0, None),  # recurrentgemma-9b, G = 16
    (2, 333, 16, 8, 256, 256, True, 0, 50.0, None),    # hd 256, ragged S
    (1, 200, 4, 2, 256, 256, False, 40, 30.0, None),   # hd 256: non-causal window
    (2, 512, 16, 16, 192, 128, True, 0, 0.0, 192 ** -0.5),  # deepseek-v2-lite MLA
    (1, 130, 4, 2, 192, 128, True, 48, 20.0, None),    # (192, 128): G = 2, window, cap
    (2, 256, 4, 4, 24, 16, True, 0, 0.0, 24 ** -0.5),  # MLA reduced
    (2, 77, 6, 2, 24, 16, False, 24, 30.0, None),      # (24, 16): G = 3, ragged
    (2, 512, 32, 32, 80, 80, True, 0, 0.0, None),      # stablelm-3b's training shape
    (1, 130, 8, 2, 80, 80, True, 48, 20.0, None),      # hd 80: G = 4, window, cap
    (2, 77, 4, 4, 80, 80, False, 0, 0.0, None),        # hd 80: non-causal, ragged
]


@pytest.mark.parametrize("b,s,h,kv,hd,hd_v,causal,window,cap,scale", BWD_CASES)
def test_flash_bwd_kernel_matches_plain(b, s, h, kv, hd, hd_v, causal, window,
                                        cap, scale):
    """dQ, dK, dV of the backward kernel against ``flash_attention_bwd_plain``
    on the same o and lse: max |diff| <= 1e-4 of the largest reference
    gradient (3xTF32 products on the tensor cores against float32 matmuls in
    another order), at every built (qk, v) pair."""
    q = _normal((b, s, h, hd), torch.float32, 1)
    k = _normal((b, s, kv, hd), torch.float32, 2)
    v = _normal((b, s, kv, hd_v), torch.float32, 3)
    do = _normal((b, s, h, hd_v), torch.float32, 4)
    kw = dict(causal=causal, window=window, logit_cap=cap, scale=scale)
    o, lse = k1.flash_attention_lse(q, k, v, **kw)
    before = k1.flash_attention_bwd.launches
    got = k1.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert k1.flash_attention_bwd.launches == before + 1
    want = k1.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape
        assert _max_rel(g, w) <= 1e-4, name
    again = k1.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    for g, a in zip(got, again):                       # no float atomics
        assert torch.equal(g, a)


def test_flash_bwd_kernel_two_shapes_alternately():
    """Two shapes called in turns (G = 4 then G = 7 at another S): each call
    equals the first call of its shape bit for bit and the plain version, so
    no work table is taken from the other shape's cache entry and no scratch
    state carries over."""
    runs = []
    for b, s, h, kv, hd in ((1, 320, 8, 2, 64), (2, 77, 7, 1, 64)):
        q = _normal((b, s, h, hd), torch.float32, 12)
        k = _normal((b, s, kv, hd), torch.float32, 13)
        v = _normal((b, s, kv, hd), torch.float32, 14)
        do = _normal((b, s, h, hd), torch.float32, 15)
        o, lse = k1.flash_attention_lse(q, k, v)
        runs.append(((q, k, v, o, lse, do),
                     k1.flash_attention_bwd_plain(q, k, v, o, lse, do)))
    first = [k1.flash_attention_bwd(*args) for args, _ in runs]
    for _ in range(2):
        for (args, want), ref in zip(runs, first):
            got = k1.flash_attention_bwd(*args)
            torch.cuda.synchronize()
            for g, r, w in zip(got, ref, want):
                assert torch.equal(g, r)
                assert _max_rel(g, w) <= 1e-4


# the bf16 kernels' edges: S not a multiple of their 64-row steps at hd 256
# and at (192, 128) (two warpgroups by role), a single 64-row tile
BWD_BF16_EDGES = [
    (1, 100, 4, 2, 256, 256, True, 0, 0.0, None),
    (1, 100, 4, 4, 192, 128, True, 0, 0.0, None),
    (2, 64, 4, 1, 128, 128, True, 0, 0.0, None),
    (1, 30, 4, 2, 256, 256, True, 0, 0.0, None),
]


@pytest.mark.parametrize("b,s,h,kv,hd,hd_v,causal,window,cap,scale",
                         BWD_CASES + BWD_BF16_EDGES)
def test_flash_bf16_bwd_kernel_matches_plain(b, s, h, kv, hd, hd_v, causal,
                                             window, cap, scale):
    """The bf16 instance of the backward kernel (wgmma, P and dS rounded to
    bf16 as operands, float32 accumulators) against
    ``flash_attention_bwd_plain`` (float32 from the same bf16 inputs) on the
    same o and lse, from the bf16 forward with lse: max |diff| <= 2e-2 of
    the largest reference gradient (the bf16 tolerance of
    tests/test_kernels.py), dq, dk, dv in bf16, the same bits on repeat, at
    every case of the float32 test above and at the bf16 kernels' edges."""
    q = _normal((b, s, h, hd), torch.bfloat16, 1)
    k = _normal((b, s, kv, hd), torch.bfloat16, 2)
    v = _normal((b, s, kv, hd_v), torch.bfloat16, 3)
    do = _normal((b, s, h, hd_v), torch.bfloat16, 4)
    kw = dict(causal=causal, window=window, logit_cap=cap, scale=scale)
    o, lse = k1.flash_attention_lse(q, k, v, **kw)
    before = k1.flash_attention_bwd.launches
    got = k1.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = k1.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert k1.flash_attention_bwd.launches == before + 2
    want = k1.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for name, g, w, a in zip("qkv", got, want, again):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        assert _max_rel(g, w) <= 2e-2, name
        assert torch.equal(g, a)                       # no float atomics


# the tensor-parallel training ranks' shapes: Llama-3-8B at B=2, S=512 with
# its 32 query and 8 kv heads split over model 4 (8 / 2 a rank) and model 2
# (16 / 4)
BWD_TP_RANKS = [
    (2, 512, 8, 2, 128, 128, True, 0, 0.0, None),
    (2, 512, 16, 4, 128, 128, True, 0, 0.0, None),
]


@pytest.mark.parametrize("b,s,h,kv,hd,hd_v,causal,window,cap,scale", BWD_TP_RANKS,
                         ids=["model-4-rank", "model-2-rank"])
def test_flash_bf16_bwd_kernel_at_tensor_parallel_rank_shapes(
        b, s, h, kv, hd, hd_v, causal, window, cap, scale):
    """K1's bf16 backward on one rank's heads of the tensor-parallel train
    step, against its plain version as above."""
    test_flash_bf16_bwd_kernel_matches_plain(b, s, h, kv, hd, hd_v, causal,
                                             window, cap, scale)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,d,pieces", [(33, 3584, 4), (512, 4096, 2),
                                        (7, 32064, 4), (5, 100, 2)])
def test_int8_absmax_and_given_absmax_modes_match_plain(n, d, pieces, dtype):
    """K2a's absmax mode (``row_absmax``) equals the plain row absmax; its
    given-absmax mode equals the plain quantizer given the same absmax
    (here up to 3x the row's own, as another rank's piece may hold), and a
    row cut in pieces, each quantized with the pieces' reduced absmax,
    gives the whole row's codes and scales bit for bit (the fast instance,
    the general one past 8,192 float32 or at a ragged width)."""
    x = _int8_rows(n, d, dtype, n + d + pieces)
    before = (k2.row_absmax.launches, k2.quantize_int8.launches,
              k2.quantize_int8.given_launches)
    amax = k2.row_absmax(x)
    torch.cuda.synchronize()
    assert torch.equal(amax, k2.row_absmax_plain(x))
    bigger = amax * torch.linspace(1.0, 3.0, n, device="cuda")[:, None]
    q, s = k2.quantize_int8(x, absmax=bigger)
    pq, ps = k2.quantize_int8_plain(x, bigger)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    whole_q, whole_s = k2.quantize_int8(x)
    cut = [x[:, i * d // pieces:(i + 1) * d // pieces].contiguous()
           for i in range(pieces)]
    reduced = torch.stack([k2.row_absmax(c) for c in cut]).amax(0)
    parts = [k2.quantize_int8(c, absmax=reduced) for c in cut]
    assert torch.equal(torch.cat([p[0] for p in parts], 1), whole_q)
    assert all(torch.equal(p[1], whole_s) for p in parts)
    assert (k2.row_absmax.launches, k2.quantize_int8.launches,
            k2.quantize_int8.given_launches) == \
        (before[0] + 1 + pieces, before[1] + 2 + pieces, before[2] + 1 + pieces)


@pytest.mark.parametrize("case,min_items,heads", [
    ((2, 512, 16, 1, 256, 256, True, 2048, 0.0, None), 64, 4),   # MQA: 4 groups
    ((2, 512, 16, 1, 256, 256, True, 2048, 0.0, None), 1, 16),   # one group
    ((2, 512, 32, 8, 128, 128, True, 0, 0.0, None), 132, 2),     # 2 groups
    ((2, 512, 32, 8, 128, 128, True, 0, 0.0, None), 1, 4),       # one group
    ((2, 77, 6, 2, 24, 16, False, 24, 30.0, None), 1, 3),
    ((1, 200, 8, 2, 64, 64, True, 64, 20.0, None), 1, 4),
], ids=["mqa-4-groups", "mqa-one-group", "llama-2-groups", "llama-one-group",
        "24-16-one-group", "hd64-one-group"])
def test_flash_bf16_bwd_groups_of_heads_match_plain(case, min_items, heads,
                                                    monkeypatch):
    """dK/dV work items that walk several query heads of one KV head (the
    bf16 wrapper's ``bwd_heads_per_item``, here forced by
    ``BWD_MIN_ITEMS``): with several groups the partials go through the
    fixed-order sum, with one group the items store dk, dv in bf16; both
    against the plain version (2e-2), the same bits on repeat."""
    b, s, h, kv, hd, hd_v, causal, window, cap, scale = case
    monkeypatch.setattr(k1, "BWD_MIN_ITEMS", min_items)
    assert k1.bwd_heads_per_item(b, s, h, kv) == heads
    q = _normal((b, s, h, hd), torch.bfloat16, 1)
    k = _normal((b, s, kv, hd), torch.bfloat16, 2)
    v = _normal((b, s, kv, hd_v), torch.bfloat16, 3)
    do = _normal((b, s, h, hd_v), torch.bfloat16, 4)
    kw = dict(causal=causal, window=window, logit_cap=cap, scale=scale)
    o, lse = k1.flash_attention_lse(q, k, v, **kw)
    got = k1.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = k1.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    want = k1.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for name, g, w, a in zip("qkv", got, want, again):
        assert g.dtype == torch.bfloat16 and _max_rel(g, w) <= 2e-2, name
        assert torch.equal(g, a)


@pytest.mark.parametrize("hd,hd_v", [(8, 8), (16, 16), (32, 32), (64, 64), (80, 80),
                                     (128, 128), (256, 256), (192, 128), (24, 16)])
def test_flash_bf16_fwd_lse_equals_forward_and_plain(hd, hd_v):
    """The bf16 forward with lse writes the same o, bit for bit, as without
    (the serving call); its lse (float32, natural log) equals the plain
    log-sum-exp of the same bf16 inputs to 1e-5, at every built pair."""
    q = _normal((2, 150, 4, hd), torch.bfloat16, 5)
    k = _normal((2, 150, 2, hd), torch.bfloat16, 6)
    v = _normal((2, 150, 2, hd_v), torch.bfloat16, 7)
    for kw in (dict(), dict(window=40, logit_cap=30.0), dict(causal=False)):
        o0 = k1.flash_attention(q, k, v, **kw)
        o1, lse = k1.flash_attention_lse(q, k, v, **kw)
        torch.cuda.synchronize()
        assert torch.equal(o0, o1) and lse.dtype == torch.float32
        sim, _, _ = k1._scores_plain(q, k, kw.get("causal", True),
                                     kw.get("window", 0), kw.get("logit_cap", 0.0),
                                     None)
        torch.testing.assert_close(lse, torch.logsumexp(sim, -1), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("hd,hd_v", [(8, 8), (16, 16), (32, 32), (64, 64), (80, 80),
                                     (128, 128), (256, 256), (192, 128), (24, 16)])
def test_flash_fwd_lse_equals_forward_and_plain(hd, hd_v):
    """The float32 forward with lse writes the same o, bit for bit, as
    without; lse equals the plain log-sum-exp to 1e-5; at every built
    (qk, v) pair."""
    q = _normal((2, 150, 4, hd), torch.float32, 5)
    k = _normal((2, 150, 2, hd), torch.float32, 6)
    v = _normal((2, 150, 2, hd_v), torch.float32, 7)
    for kw in (dict(), dict(window=40, logit_cap=30.0), dict(causal=False)):
        o0 = k1.flash_attention(q, k, v, **kw)
        o1, lse = k1.flash_attention_lse(q, k, v, **kw)
        torch.cuda.synchronize()
        assert torch.equal(o0, o1)
        sim, _, _ = k1._scores_plain(q, k, kw.get("causal", True),
                                     kw.get("window", 0), kw.get("logit_cap", 0.0),
                                     None)
        torch.testing.assert_close(lse, torch.logsumexp(sim, -1), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("b,s,h,kv,hd,hd_v,window,cap", [
    (2, 512, 32, 8, 128, 128, 0, 0.0),    # llama3-8b's training shape
    (8, 256, 8, 8, 64, 64, 0, 0.0),       # the quickstart recipe's
    (2, 333, 32, 8, 128, 128, 0, 0.0),    # ragged S
    (2, 333, 8, 2, 64, 64, 100, 50.0),    # ragged S, window, soft-cap
    (1, 300, 4, 2, 8, 8, 0, 0.0),
    (1, 300, 4, 2, 16, 16, 0, 30.0),
    (1, 300, 4, 2, 32, 32, 70, 0.0),
    (1, 300, 4, 2, 256, 256, 0, 50.0),
    (1, 300, 4, 4, 192, 128, 0, 0.0),
    (1, 300, 4, 4, 24, 16, 33, 30.0),
])
def test_flash_f32_forward_matches_plain_and_repeats(b, s, h, kv, hd, hd_v,
                                                    window, cap):
    """K1's float32 forward (3xTF32 on the tensor cores) against the plain
    version at 2e-5 and its lse against the plain log-sum-exp at 1e-5, at
    the training shapes, ragged S and every built (qk, v) pair; a second
    call gives the same bits (no atomics)."""
    q = _normal((b, s, h, hd), torch.float32, 31)
    k = _normal((b, s, kv, hd), torch.float32, 32)
    v = _normal((b, s, kv, hd_v), torch.float32, 33)
    kw = dict(window=window, logit_cap=cap, scale=hd ** -0.5)
    before = k1.flash_attention.launches
    o, lse = k1.flash_attention_lse(q, k, v, **kw)
    o2, lse2 = k1.flash_attention_lse(q, k, v, **kw)
    torch.cuda.synchronize()
    assert k1.flash_attention.launches == before + 2
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    want = k1.flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(o, want, atol=2e-5, rtol=2e-5)
    sim, _, _ = k1._scores_plain(q, k, True, window, cap, hd ** -0.5)
    torch.testing.assert_close(lse, torch.logsumexp(sim, -1), atol=1e-5, rtol=1e-5)


def test_flash_autograd_launches_forward_and_backward_kernels():
    q = _normal((2, 64, 4, 32), torch.float32, 8).requires_grad_()
    k = _normal((2, 64, 2, 32), torch.float32, 9).requires_grad_()
    v = _normal((2, 64, 2, 32), torch.float32, 10).requires_grad_()
    f0, b0 = k1.flash_attention.launches, k1.flash_attention_bwd.launches
    o = k1.flash_attention(q, k, v, window=20)
    do = _normal(tuple(o.shape), torch.float32, 11)
    got = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    assert k1.flash_attention.launches == f0 + 1
    assert k1.flash_attention_bwd.launches == b0 + 1
    want = torch.autograd.grad(
        k1.flash_attention_plain(q, k, v, window=20), (q, k, v), do)
    for g, w in zip(got, want):
        assert _max_rel(g, w) <= 1e-4
    with torch.no_grad():                                 # serving: no lse
        k1.flash_attention(q, k, v)
    assert k1.flash_attention_bwd.launches == b0 + 1


@pytest.mark.parametrize("hd,hd_v,window,cap", [(256, 256, 20, 50.0),
                                                (192, 128, 0, 0.0),
                                                (24, 16, 0, 30.0)])
def test_flash_autograd_runs_the_wide_backward_instances(hd, hd_v, window, cap):
    """Autograd through ``flash_attention`` at hd 256 and MLA's pairs: one
    forward and one backward launch, gradients within 1e-4 of the plain
    version's autograd."""
    q = _normal((2, 96, 4, hd), torch.float32, 8).requires_grad_()
    k = _normal((2, 96, 2, hd), torch.float32, 9).requires_grad_()
    v = _normal((2, 96, 2, hd_v), torch.float32, 10).requires_grad_()
    kw = dict(window=window, logit_cap=cap)
    f0, b0 = k1.flash_attention.launches, k1.flash_attention_bwd.launches
    o = k1.flash_attention(q, k, v, **kw)
    do = _normal(tuple(o.shape), torch.float32, 11)
    got = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    assert k1.flash_attention.launches == f0 + 1
    assert k1.flash_attention_bwd.launches == b0 + 1
    want = torch.autograd.grad(k1.flash_attention_plain(q, k, v, **kw), (q, k, v), do)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _max_rel(g, w) <= 1e-4


@pytest.mark.parametrize("dtype,hd,hd_v", [(torch.bfloat16, 48, 48),
                                           (torch.float32, 48, 48),
                                           (torch.float32, 128, 64)])
def test_flash_autograd_rejects_unsupported(dtype, hd, hd_v):
    """Pairs no instance builds raise under grad, in bf16 as in float32:
    nothing falls back to the plain version."""
    q = _normal((1, 64, 2, hd), dtype, 1).requires_grad_()
    k = _normal((1, 64, 2, hd), dtype, 2)
    v = _normal((1, 64, 2, hd_v), dtype, 3)
    with pytest.raises(ValueError, match="no backward kernel.*float32"):
        k1.flash_attention(q, k, v)


@pytest.mark.parametrize("hd,hd_v,window,cap", [(64, 64, 20, 0.0),
                                                (256, 256, 20, 50.0),
                                                (192, 128, 0, 0.0),
                                                (24, 16, 0, 30.0)])
def test_flash_bf16_autograd_runs_the_bf16_instances(hd, hd_v, window, cap):
    """bf16 inputs under grad run the bf16 forward with lse and the bf16
    backward (one launch each), never the float32 ones; the gradients come
    out in bf16 within 2e-2 of the plain version's autograd."""
    q = _normal((2, 96, 4, hd), torch.bfloat16, 8).requires_grad_()
    k = _normal((2, 96, 2, hd), torch.bfloat16, 9).requires_grad_()
    v = _normal((2, 96, 2, hd_v), torch.bfloat16, 10).requires_grad_()
    kw = dict(window=window, logit_cap=cap)
    f0, b0 = k1.flash_attention.launches, k1.flash_attention_bwd.launches
    o = k1.flash_attention(q, k, v, **kw)
    do = _normal(tuple(o.shape), torch.bfloat16, 11)
    got = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    assert o.dtype == torch.bfloat16
    assert (k1.flash_attention.launches - f0, k1.flash_attention_bwd.launches - b0) \
        == (1, 1)
    want = torch.autograd.grad(k1.flash_attention_plain(q, k, v, **kw), (q, k, v), do)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert _max_rel(g, w) <= 2e-2


def _reduced_train_run(device, steps=3, compression=True):
    bundle = get_bundle("llama3-8b", reduced=True)
    params = bundle.init(torch.Generator().manual_seed(0), "cpu", torch.float32)
    params = tree_map(lambda t: t.to(device), params)
    step_fn, init_state = make_train_step(
        bundle, TrainStepConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=2),
                                grad_compression=compression), device)
    state = init_state(params=params)
    data = SyntheticTokens(DataConfig(vocab=bundle.cfg.vocab, batch=2, seq_len=64))
    losses = []
    for step in range(steps):
        state, m = step_fn(state, data.batch_at(step))
        losses.append(float(m["loss"]))
    return losses, tree_map(lambda t: t.cpu(), state["params"])


@pytest.mark.usefixtures("_f32_port")
@pytest.mark.parametrize("compression", [False, True])
def test_reduced_train_steps_on_the_card_repeat_and_match_the_cpu(compression):
    """Three steps: two card runs bit for bit; the CPU run (plain versions)
    within 1e-4 on the loss; every param within 3 lr and the mean gap under
    0.05 lr (chip_smoke.py's TRAIN_MEAN_LR: Adam's ratio m / sqrt(v) carries
    the float32 noise of a gradient element that is tiny next to its leaf's
    maximum into an lr-sized step, and an int8 code at a rounding tie flips;
    a wrong update would move every element by the order of lr)."""
    f0, b0 = k1.flash_attention.launches, k1.flash_attention_bwd.launches
    q0 = k2.quantize_int8.launches
    la, pa = _reduced_train_run("cuda", compression=compression)
    assert k1.flash_attention_bwd.launches - b0 == 3 * 2       # 2 layers
    assert k1.flash_attention.launches - f0 == 3 * 2 * 2       # + recompute
    assert (k2.quantize_int8.launches - q0 > 0) == compression
    lb, pb = _reduced_train_run("cuda", compression=compression)
    lc, pc = _reduced_train_run("cpu", compression=compression)
    assert la == lb
    np.testing.assert_allclose(la, lc, rtol=1e-4)
    lr = 1e-3
    gaps = []
    for a, b, c in zip(*(tree_flatten(x)[0] for x in (pa, pb, pc))):
        assert torch.equal(a, b)
        gaps.append((a.float() - c.float()).abs().flatten() / lr)
    gaps = torch.cat(gaps)
    assert float(gaps.max()) <= 3 and float(gaps.mean()) <= 0.05


@pytest.mark.usefixtures("_f32_port")
@pytest.mark.parametrize("arch,tol", [("llama3-8b", 5e-4),
                                      ("qwen3-moe-30b-a3b", 1e-4),
                                      ("deepseek-v2-lite-16b", 1e-4),
                                      ("gemma2-9b", 1.2e-3)])
def test_reduced_gradients_on_the_card_match_the_cpu(arch, tol):
    """Step-0 gradients, card vs CPU, within ``tol`` of each leaf's max
    (float32 in other orders; reduced llama3-8b's init saturates its
    softmax, whose gradients cancel: chip_smoke.py's TRAIN_GRAD_TOL; reduced
    gemma2 is ill-conditioned in float32: either package's gradients lie
    2e-4 to 6e-4 of the leaf max from a float64 evaluation,
    tests/test_torch_training.py's GRAD_TOL, so two float32 evaluations may
    lie twice that apart); K1's backward runs once a layer (deepseek-v2-lite:
    the (24, 16) instance, gemma2: hd 32 with the soft-cap)."""
    bundle = get_bundle(arch, reduced=True)
    params = bundle.init(torch.Generator().manual_seed(0), "cpu",
                         torch.float32)
    batch = SyntheticTokens(DataConfig(vocab=bundle.cfg.vocab, batch=2,
                                       seq_len=64)).batch_at(0)
    grads = []
    for dev in ("cuda", "cpu"):
        leaves, structure = tree_flatten(tree_map(lambda a: a.to(dev), params))
        ws = [p.clone().requires_grad_(True) for p in leaves]
        b0 = k1.flash_attention_bwd.launches
        loss = bundle.loss(tree_unflatten(structure, ws),
                           {k: torch.as_tensor(v, device=dev)
                            for k, v in batch.items()})
        grads.append([g.cpu() for g in torch.autograd.grad(loss, ws)])
        if dev == "cuda":
            assert k1.flash_attention_bwd.launches - b0 == bundle.cfg.n_layers
    for a, c in zip(*grads):
        assert float((a - c).abs().max()) <= tol * float(c.abs().max())


def _loss_grads(bundle, params, batch, dev):
    leaves, structure = tree_flatten(tree_map(lambda a: a.to(dev), params))
    ws = [p.clone().requires_grad_(True) for p in leaves]
    loss = bundle.loss(tree_unflatten(structure, ws),
                       {k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
    return [g.cpu() for g in torch.autograd.grad(loss, ws)]


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen3-moe-30b-a3b",
                                  "deepseek-v2-lite-16b", "gemma2-9b",
                                  "mamba2-1.3b", "recurrentgemma-9b"])
def test_reduced_bf16_gradients_on_the_card_match_the_cpu(arch, monkeypatch):
    """Step-0 gradients of the bf16 training path, card vs CPU: each leaf
    within 3 times the CPU's own bf16-vs-float32 gap on that leaf plus 1e-3
    of its largest magnitude (chip_smoke.py's TRAIN_BF16_C and
    TRAIN_BF16_FLOOR, tests/test_torch_training.py's rule for the port
    against the reference: the reduced models are ill-conditioned in bf16);
    K1's bf16 backward runs once a layer, the float32 one never."""
    from repro_torch.models import griffin, mamba2, transformer

    bundle = get_bundle(arch, reduced=True)
    params = bundle.init(torch.Generator().manual_seed(0), "cpu", torch.float32)
    batch = SyntheticTokens(DataConfig(vocab=bundle.cfg.vocab, batch=2,
                                       seq_len=64)).batch_at(0)
    seen = []
    bwd = k1.flash_attention_bwd

    def spy(q, *args, **kw):
        seen.append(q.dtype)
        return bwd(q, *args, **kw)

    spy.launches = bwd.launches
    monkeypatch.setattr(k1, "flash_attention_bwd", spy)
    card = _loss_grads(bundle, params, batch, "cuda")
    monkeypatch.setattr(k1, "flash_attention_bwd", bwd)
    cpu = _loss_grads(bundle, params, batch, "cpu")
    with monkeypatch.context() as m:
        for mod in (transformer, mamba2, griffin):
            m.setattr(mod, "embed_tokens", functools.partial(
                mod.embed_tokens, compute_dtype=torch.float32))
        cpu32 = _loss_grads(bundle, params, batch, "cpu")
    n_attn = 0 if bundle.family == "mamba2" else \
        getattr(bundle.cfg, "n_attn", bundle.cfg.n_layers)
    assert seen == [torch.bfloat16] * n_attn
    for a, b, c in zip(card, cpu, cpu32):
        limit = 3 * float((b - c).abs().max()) + 1e-3 * float(b.abs().max())
        assert float((a - b).abs().max()) <= limit


def test_reduced_bf16_train_steps_on_the_card_repeat():
    """Three bf16 steps of reduced llama3-8b with int8 gradients: two card
    runs give the same losses and params bit for bit (no float atomics on
    the path), the losses finite; K1's bf16 backward runs 3 x 2 times."""
    b0 = k1.flash_attention_bwd.launches
    la, pa = _reduced_train_run("cuda")
    assert k1.flash_attention_bwd.launches - b0 == 3 * 2
    lb, pb = _reduced_train_run("cuda")
    assert la == lb and all(np.isfinite(la))
    for a, b in zip(tree_flatten(pa)[0], tree_flatten(pb)[0]):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# K4's and K5's backward (training)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dt_scale", [1.0, 0.01], ids=["fast", "slow-decay"])
@pytest.mark.parametrize("b,s,h,g,n,p,chunk,with_state", [
    (2, 512, 64, 1, 128, 64, 256, False),   # mamba2-1.3b's training shape
    (2, 333, 64, 1, 128, 64, 256, True),    # ragged S, state_in, dS_final
    (2, 200, 4, 2, 32, 64, 64, True),       # G = 2
    (1, 2048, 64, 1, 128, 64, 256, True),   # 8 chunks
    (2, 37, 4, 2, 16, 16, 16, True),        # small P and N, ragged chunk
    (1, 100, 2, 1, 256, 32, 128, False),    # N = 256, S < chunk
])
def test_ssd_bwd_kernel_matches_plain(b, s, h, g, n, p, chunk, with_state,
                                      dt_scale):
    """Every output of the backward kernels within 1e-4 of the largest
    plain value (float32 sums in other orders), bit for bit on repeat.
    ``slow-decay`` scales dt so that e^{cums} stays near 1 over a chunk:
    the carried states and the far off-diagonal pairs weigh in."""
    x, dt, a, bm, cm, st = _ssd_inputs(b, s, h, g, n, p, torch.float32, 7)
    dt = dt * dt_scale
    st = st if with_state else None
    dy = _normal((b, s, h, p), torch.float32, 8)
    ds = _normal((b, h, n, p), torch.float32, 9) if with_state else None
    before = k4.ssd_bwd.launches
    got = k4.ssd_bwd(x, dt, a, bm, cm, dy, chunk=chunk, state_in=st, dstate=ds)
    again = k4.ssd_bwd(x, dt, a, bm, cm, dy, chunk=chunk, state_in=st, dstate=ds)
    torch.cuda.synchronize()
    assert k4.ssd_bwd.launches == before + 2
    want = k4.ssd_bwd_plain(x, dt, a, bm, cm, dy, chunk=chunk, state_in=st,
                            dstate=ds)
    assert (got[5] is None) == (not with_state)
    for u, v, w in zip(got, again, want):
        if w is not None:
            assert _max_rel(u, w) <= 1e-4
            assert torch.equal(u, v)


def test_ssd_bwd_kernel_reads_strided_views():
    """x, B and C as the model hands them: views of one conv output."""
    b, s, h, g, n, p = 2, 130, 4, 1, 32, 16
    conv = _normal((b, s, h * p + 2 * g * n), torch.float32, 3)
    x = conv[..., :h * p].unflatten(-1, (h, p))
    bm = conv[..., h * p:h * p + g * n].unflatten(-1, (g, n))
    cm = conv[..., h * p + g * n:].unflatten(-1, (g, n))
    _, dt, a, _, _, _ = _ssd_inputs(b, s, h, g, n, p, torch.float32, 4)
    dy = _normal((b, s, h, p), torch.float32, 5)
    got = k4.ssd_bwd(x, dt, a, bm, cm, dy, chunk=64)
    want = k4.ssd_bwd_plain(x.contiguous(), dt, a, bm.contiguous(),
                            cm.contiguous(), dy, chunk=64)
    for u, w in zip(got[:5], want[:5]):
        assert _max_rel(u, w) <= 1e-4


@pytest.mark.parametrize("a_lo", [0.0, 0.99], ids=["sigmoid", "near-one"])
@pytest.mark.parametrize("b,s,w,with_h0", [
    (2, 512, 4096, True), (2, 512, 4096, False), (2, 200, 4000, True),
    (1, 64, 33, True), (3, 1, 128, True)])
def test_rglru_bwd_kernel_matches_plain(b, s, w, with_h0, a_lo):
    """da, dx, dh0 within 1e-5 of the largest plain value, bit for bit on
    repeat.  ``near-one`` puts a in (0.99, 1): the carry handed back across
    64-step chunks then weighs as much as a chunk's own sum."""
    a = a_lo + (1.0 - a_lo) * torch.sigmoid(_normal((b, s, w), torch.float32, 1))
    x = _normal((b, s, w), torch.float32, 2)
    h0 = _normal((b, w), torch.float32, 3) if with_h0 else None
    hs = k5.rglru(a, x, h0)
    dy = _normal((b, s, w), torch.float32, 4)
    before = k5.rglru_bwd.launches
    got = k5.rglru_bwd(a, hs, dy, h0)
    again = k5.rglru_bwd(a, hs, dy, h0)
    torch.cuda.synchronize()
    assert k5.rglru_bwd.launches == before + 2
    want = k5.rglru_bwd_plain(a, hs, dy, h0)
    assert (got[2] is None) == (not with_h0)
    for u, v, wv in zip(got, again, want):
        if wv is not None:
            assert _max_rel(u, wv) <= 1e-5
            assert torch.equal(u, v)


@pytest.mark.parametrize("return_state", [False, True])
def test_ssd_autograd_runs_the_backward_kernel(return_state):
    """``ssd`` under grad mode: every input's gradient from the backward
    kernel, within 1e-4 of autograd of the plain version; the forward
    kernel once, the backward once; without grad nothing changes."""
    b, s, h, g, n, p = 2, 100, 4, 2, 16, 16
    ins = [t.requires_grad_() for t in _ssd_inputs(b, s, h, g, n, p,
                                                   torch.float32, 11)]
    cy = _normal((b, s, h, p), torch.float32, 12)
    cs = _normal((b, h, n, p), torch.float32, 13)

    def loss(fn):
        out = fn(*ins[:5], chunk=32, state_in=ins[5], return_state=return_state)
        if not return_state:
            return (out * cy).sum()
        return (out[0] * cy).sum() + (out[1] * cs).sum()

    f0, b0 = k4.ssd.launches, k4.ssd_bwd.launches
    got = torch.autograd.grad(loss(k4.ssd), ins)
    torch.cuda.synchronize()
    assert (k4.ssd.launches - f0, k4.ssd_bwd.launches - b0) == (1, 1)
    want = torch.autograd.grad(loss(k4.ssd_plain), ins)
    for u, w in zip(got, want):
        assert _max_rel(u, w) <= 1e-4
    with torch.no_grad():
        k4.ssd(*ins[:5], chunk=32)
    assert k4.ssd_bwd.launches - b0 == 1


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_autograd_runs_the_backward_kernel(with_h0):
    a = torch.sigmoid(_normal((2, 150, 64), torch.float32, 1)).requires_grad_()
    x = _normal((2, 150, 64), torch.float32, 2).requires_grad_()
    h0 = _normal((2, 64), torch.float32, 3).requires_grad_() if with_h0 else None
    ins = [t for t in (a, x, h0) if t is not None]
    dy = _normal((2, 150, 64), torch.float32, 4)
    f0, b0 = k5.rglru.launches, k5.rglru_bwd.launches
    got = torch.autograd.grad(k5.rglru(a, x, h0), ins, dy)
    torch.cuda.synchronize()
    assert (k5.rglru.launches - f0, k5.rglru_bwd.launches - b0) == (1, 1)
    want = torch.autograd.grad(k5.rglru_plain(a, x, h0), ins, dy)
    for u, w in zip(got, want):
        assert _max_rel(u, w) <= 1e-5


def test_scan_autograd_rejects_bf16():
    """K5 has no bf16 backward: bf16 under grad raises (no model path gives
    it bf16 under grad: ``_lru_gates`` hands it float32, as the
    reference's)."""
    av = torch.sigmoid(_normal((1, 8, 16), torch.bfloat16, 2))
    with pytest.raises(ValueError, match="backward"):
        k5.rglru(av, _normal((1, 8, 16), torch.bfloat16, 3).requires_grad_())


@pytest.mark.parametrize("return_state", [False, True])
def test_ssd_autograd_runs_bf16_through_the_float32_kernels(return_state):
    """bf16 x, B and C under grad: cast to float32 and run through K4's
    float32 forward and K4 bwd (one launch each, as the launch counters
    show), as the reference's ssd_chunked scans in float32; y comes back in
    bf16 and equals the float32 kernels' y on the cast inputs, rounded; the
    gradients (in x's, B's and C's dtype) match the float32 plain version's
    autograd on the cast inputs within 2e-2."""
    x, dt, a, bm, cm, st = _ssd_inputs(2, 150, 4, 1, 32, 32, torch.bfloat16, 1)
    ins = [x.requires_grad_(), dt.requires_grad_(), a.requires_grad_(),
           bm.requires_grad_(), cm.requires_grad_()]
    f0, b0 = k4.ssd.launches, k4.ssd_bwd.launches
    out = k4.ssd(*ins, chunk=64, return_state=return_state)
    y, state = out if return_state else (out, None)
    dy = _normal(tuple(y.shape), torch.bfloat16, 7)
    loss = (y.float() * dy.float()).sum()
    if return_state:
        loss = loss + (state * _normal(tuple(state.shape), torch.float32, 8)).sum()
    got = torch.autograd.grad(loss, ins)
    torch.cuda.synchronize()
    assert (k4.ssd.launches - f0, k4.ssd_bwd.launches - b0) == (1, 1)
    assert y.dtype == torch.bfloat16
    with torch.no_grad():
        y32 = k4.ssd(x.float(), dt, a, bm.float(), cm.float(), chunk=64,
                     return_state=return_state)
    y32 = y32[0] if return_state else y32
    assert torch.equal(y, y32.to(torch.bfloat16))
    f32 = [x.detach().float().requires_grad_(), dt.detach().requires_grad_(),
           a.detach().requires_grad_(), bm.detach().float().requires_grad_(),
           cm.detach().float().requires_grad_()]
    ref = k4.ssd_plain(*f32, chunk=64, return_state=return_state)
    yr, sr = ref if return_state else (ref, None)
    lref = (yr * dy.float()).sum()
    if return_state:
        lref = lref + (sr * _normal(tuple(sr.shape), torch.float32, 8)).sum()
    want = torch.autograd.grad(lref, f32)
    for g, w, t in zip(got, want, ins):
        assert g.dtype == t.dtype
        assert _max_rel(g, w) <= 2e-2


def test_int8_and_decode_kernels_refuse_inputs_that_need_a_gradient():
    """K2a, K2b and K3 have no backward: under grad mode they raise rather
    than return a detached result; without grad, or under no_grad, they
    launch."""
    x = _normal((4, 64), torch.float32, 1).requires_grad_()
    with pytest.raises(ValueError, match="no backward"):
        k2.quantize_int8(x)
    q, scale = k2.quantize_int8(x.detach())
    with pytest.raises(ValueError, match="no backward"):
        k2.dequantize_int8(q, scale.requires_grad_(), torch.float32)
    with torch.no_grad():
        k2.dequantize_int8(q, scale, torch.float32)
        k2.quantize_int8(x)
    qd = _normal((2, 4, 64), torch.float32, 2).requires_grad_()
    kc = _normal((2, 32, 2, 64), torch.float32, 3)
    vc = _normal((2, 32, 2, 64), torch.float32, 4)
    with pytest.raises(ValueError, match="no backward"):
        k3.decode_attention(qd, kc, vc, 20)
    with torch.no_grad():
        k3.decode_attention(qd, kc, vc, 20)


def _block_grads(fn, params, x, device):
    """Gradients of sum(fn(x, params) * c) w.r.t. x and every param leaf."""
    leaves, structure = tree_flatten(tree_map(lambda t: t.to(device), params))
    ws = [t.clone().requires_grad_(True) for t in leaves]
    xi = x.to(device).requires_grad_(True)
    out = fn(xi, tree_unflatten(structure, ws))
    c = torch.from_numpy(np.random.default_rng(5).standard_normal(
        tuple(out.shape), dtype=np.float32)).to(device)
    return [g.cpu() for g in torch.autograd.grad((out * c).sum(), [xi] + ws)]


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_scan_blocks_on_the_card_give_every_parameter_its_gradient(arch):
    """A Mamba-2 block (K4) and a Griffin recurrent block (K5) of the reduced
    models: the input's and every parameter's gradient on the card within
    1e-4 of the largest CPU value (the plain versions' autograd).  Without
    an autograd function around the kernels the scan's output would be
    detached: the gradients through it (in_proj's B, C, dt columns, A_log,
    dt_bias; gate_a, gate_x, lam, wx, conv) would be wrong or zero."""
    from repro_torch.models import griffin, mamba2
    from repro_torch.models.common import layer

    bundle = get_bundle(arch, reduced=True)
    cfg = bundle.cfg
    params = bundle.init(torch.Generator().manual_seed(0), "cpu", torch.float32)
    x = _normal((2, 40, cfg.d_model), torch.float32, 6).cpu()
    if arch == "mamba2-1.3b":
        lp = layer(params["blocks"], 0)

        def fn(xi, p):
            return mamba2.block_forward(xi, p, cfg)
    else:
        lp = layer(params["groups"]["t0"], 0)

        def fn(xi, p):
            return griffin.rec_forward(xi, p, cfg)
    lp = tree_map(lambda t: t.clone(), lp)
    counter = k4.ssd_bwd if arch == "mamba2-1.3b" else k5.rglru_bwd
    before = counter.launches
    card = _block_grads(fn, lp, x, "cuda")
    assert counter.launches == before + 1
    cpu = _block_grads(fn, lp, x, "cpu")
    for u, w in zip(card, cpu):
        assert _max_rel(u, w) <= 1e-4


@pytest.mark.parametrize("arch", ["gemma2-9b", "recurrentgemma-9b"])
def test_full_width_attention_block_gradients_on_the_card_match_the_cpu(arch):
    """One full-width attention block at S = 512 through autograd: gemma2-9b's
    local block (hd 256, GQA 16/8, soft-cap 50, scale 224^-1/2, window
    4,096, its FFN and sandwich norms) and recurrentgemma-9b's local MQA
    attention block (hd 256, G = 16, window 2,048).  K1's forward and
    backward run once each on the card; the input's and every parameter's
    gradient within 1e-4 of the largest CPU value (the plain versions'
    autograd).  wq and wk are rescaled for unit-variance scores, as
    chip_smoke.py's ``conditioned``: the reference's ``dense_init`` takes
    their fan-in from H and KV, so at full width the scores' std is ~256,
    the softmax is an argmax, and float32 order alone parts card from CPU
    by 1.2e-4 (gemma2) and 1.1e-3 (Griffin) of a leaf's max (this test on
    those weights, on an H100)."""
    from repro_torch.configs import get
    from repro_torch.models import griffin, transformer

    cfg = get(arch)
    gen = torch.Generator().manual_seed(0)
    if arch == "gemma2-9b":
        lp = transformer._block_params(cfg, gen, "cpu", torch.float32)
        attn, n_kv = lp["attn"], cfg.n_kv
        window = int(cfg.windows()[0])

        def fn(xi, p):
            return transformer.block_forward(xi, p, cfg, window=window)
    else:
        lp = attn = griffin._attn_params(cfg, gen, "cpu", torch.float32)
        n_kv = 1

        def fn(xi, p):
            return griffin.attn_forward(xi, p, cfg)
    attn["wq"] = attn["wq"] * (cfg.n_heads / cfg.d_model) ** 0.5
    attn["wk"] = attn["wk"] * (n_kv / cfg.d_model) ** 0.5
    x = _normal((1, 512, cfg.d_model), torch.float32, 7).cpu()
    f0, b0 = k1.flash_attention.launches, k1.flash_attention_bwd.launches
    card = _block_grads(fn, lp, x, "cuda")
    assert k1.flash_attention.launches == f0 + 1
    assert k1.flash_attention_bwd.launches == b0 + 1
    cpu = _block_grads(fn, lp, x, "cpu")
    for u, w in zip(card, cpu):
        assert _max_rel(u, w) <= 1e-4
