"""MLA and the widened attention kernels' plain versions, on the CPU.

K1's plain version (what the wrapper runs on CPU tensors) at MLA's qk head
dim wider than its v head dim (192/128 at full width, 24/16 reduced) and
at hd 8, against the reference's ``models/attention.py::chunked_attention``;
K3's plain version at hd 8 and 256 against the reference's
``models/attention.py::decode_attention`` and its Pallas decode kernel in
interpret mode.  Then MLA itself: the prefill attention and the absorbed
latent decode of the reduced deepseek-v2-lite against the reference's.
The Hopper kernels at these shapes are held against the plain versions on
the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).

Tolerances: kernel level those of tests/test_kernels.py, 2e-5 float32 and
2e-2 bfloat16; MLA layers at float32, 1e-5 (summation order only).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_bundle as jax_get_bundle
from repro.kernels import ops as jax_ops
from repro.models import attention as jax_attention
from repro.models import transformer as jax_transformer
from repro.models import transformer_serve as jax_serve
from repro_torch.configs import get_bundle
from repro_torch.kernels import decode_attention as k3
from repro_torch.kernels import flash_attention as k1
from repro_torch.models import transformer, transformer_serve
from repro_torch.models.common import layer
from repro_torch.models.convert import params_from_jax

ARCH = "deepseek-v2-lite-16b"
_DT = {"float32": (jnp.float32, torch.float32, np.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, ml_dtypes.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(shapes, dtype, seed):
    jdt, tdt, ndt = _DT[dtype]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32).astype(ndt) for s in shapes]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a.astype(np.float32)).to(tdt) for a in arrs])


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32), np.float32)


# ---------------------------------------------------------------------------
# K1's plain version at qk hd != v hd and at hd 8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,dqk,dv,window,cap", [
    (1, 96, 4, 4, 24, 16, 0, 0.0),       # reduced deepseek-v2-lite MLA
    (1, 80, 2, 2, 192, 128, 0, 0.0),     # full-width MLA head dims
    (2, 70, 4, 4, 24, 16, 16, 30.0),     # with a window and a soft-cap
    (2, 40, 7, 1, 8, 8, 0, 0.0),         # reduced deepseek-coder / internvl2
    (2, 40, 6, 6, 8, 8, 12, 0.0),        # reduced musicgen, windowed
])
def test_flash_plain_matches_reference_attention(b, s, h, kv, dqk, dv, window,
                                                 cap, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(b, s, h, dqk), (b, s, kv, dqk), (b, s, kv, dv)], dtype, seed=s + dqk)
    scale = dqk ** -0.5
    want = jax_attention.chunked_attention(jq, jk, jv, causal=True, window=window,
                                           logit_cap=cap, kv_block=32, scale=scale)
    got = k1.flash_attention(tq, tk, tv, window=window, logit_cap=cap, scale=scale)
    assert got.shape == (b, s, h, dv) and got.dtype == tq.dtype
    # the reference's model path casts P to bf16 before P·V; in bf16 that is
    # the kernel-level tolerance
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dqk,dv", [(48, 48), (192, 64), (24, 24), (16, 8),
                                    (128, 192)])
def test_flash_kernel_pairs_are_exact(dqk, dv):
    """The wrapper names exactly the (qk, v) pairs the kernel is built for
    and refuses any other pair before a launch.  Tensors off the CPU take
    that check first, so ``meta`` tensors show it here, where there is no
    card; a supported pair on them passes it and gets the dry-run's count
    (an empty result of the kernel's output shape, no launch)."""
    assert not k1.supported(dqk, dv)
    q = torch.empty(1, 8, 2, dqk, device="meta", dtype=torch.bfloat16)
    v = torch.empty(1, 8, 2, dv, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="hd_v"):
        k1.flash_attention(q, q, v)
    q = torch.empty(1, 8, 2, 192, device="meta", dtype=torch.bfloat16)
    v = torch.empty(1, 8, 2, 128, device="meta", dtype=torch.bfloat16)
    before = k1.flash_attention.launches
    out = k1.flash_attention(q, q, v)
    assert out.is_meta and out.shape == (1, 8, 2, 128)
    assert k1.flash_attention.launches == before


def test_flash_rejects_mismatched_shapes():
    q = torch.zeros(1, 8, 4, 24)
    with pytest.raises(ValueError, match="does not match"):
        k1.flash_attention(q, torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 4, 16))
    with pytest.raises(ValueError):
        k1.flash_attention(q, q, torch.zeros(1, 7, 4, 16))


# ---------------------------------------------------------------------------
# K3's plain version at hd 8 and 256
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,hd,cur,window,cap", [
    (2, 64, 7, 1, 8, 33, 0, 0.0),        # deepseek-coder / internvl2 reduced
    (2, 64, 6, 6, 8, 64, 16, 0.0),       # musicgen reduced, windowed
    (2, 96, 16, 8, 256, 77, 0, 50.0),    # gemma2 decode: G=2, soft-cap 50
    (1, 96, 16, 8, 256, 90, 32, 50.0),   # gemma2's local layers
    (2, 64, 8, 1, 256, 40, 0, 0.0),      # hd 256, G=8 (4 heads a block)
])
def test_decode_plain_matches_reference_and_pallas(b, s, h, kv, hd, cur, window,
                                                   cap, dtype):
    tol = TOL[dtype]
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(b, h, hd), (b, s, kv, hd), (b, s, kv, hd)], dtype, seed=hd + cur)
    got = k3.decode_attention(tq, tk, tv, torch.tensor(cur), window=window,
                              logit_cap=cap)
    want = jax_attention.decode_attention(jq, jk, jv, jnp.asarray(cur),
                                          window=window, logit_cap=cap)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    pallas = jax_ops.decode_attention(jq, jk, jv, jnp.asarray(cur), window=window,
                                      logit_cap=cap, block_k=32, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=tol, rtol=tol)


@pytest.mark.parametrize("g,hd,gb", [(8, 128, 4), (8, 256, 4), (2, 256, 2),
                                     (7, 8, 1), (16, 256, 4), (1, 8, 1)])
def test_decode_heads_per_block(g, hd, gb):
    """A block takes at most 4 query heads at every head dim (at hd 256 8
    would outgrow the ring for the fold; at hd 128 8 leave one block an SM);
    split_plan counts blocks with it."""
    assert k3.heads_per_block(g) == gb
    n_split, chunk = k3.split_plan(8, 16, 8, 640, 132)
    assert n_split * chunk >= 640 and chunk % 16 == 0
    # gemma2's decode shape: 8 x 8 blocks of 2 heads, 4 splits fill one wave
    assert (n_split, chunk) == (4, 160)


# ---------------------------------------------------------------------------
# MLA layers against the reference
# ---------------------------------------------------------------------------

def _mla_layer(seed=0):
    jb = jax_get_bundle(ARCH, reduced=True)
    jparams = jb.init(jax.random.PRNGKey(seed), jnp.float32)
    tb = get_bundle(ARCH, reduced=True)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tb.cfg, device="cpu")
    return jb, jparams, tb, tparams


def test_mla_prefill_attention_matches_reference():
    """q_nope/q_rope, the normalised latent, the shared rope key, k = [k_nope,
    rope key] and v from wuv, scale (nope + rope)^-0.5, through K1's plain
    version at qk 24 / v 16; and the latent cache entries it returns."""
    jb, jparams, tb, tparams = _mla_layer()
    x = np.random.default_rng(0).standard_normal((2, 20, tb.cfg.d_model)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"])["attn"]
    want = jax_transformer.attn_forward(jnp.asarray(x), jp, jb.cfg, window=0)
    out, kv = transformer.attn_forward(torch.from_numpy(x),
                                       layer(tparams["blocks"], 0)["attn"],
                                       tb.cfg, window=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    ref_kv = jax_serve._project_kv(jnp.asarray(x), jp, jb.cfg, jnp.arange(20))
    assert set(kv) == {"ckv", "kr"}
    for name in kv:
        np.testing.assert_allclose(kv[name].numpy(), np.asarray(ref_kv[name]),
                                   atol=1e-6, rtol=1e-6)


def test_mla_absorbed_decode_matches_reference():
    """One absorbed decode step of an MLA layer against the reference's
    ``_decode_attn_mla`` on the same float32 latent cache: output and the
    cache entries written at pos."""
    jb, jparams, tb, tparams = _mla_layer(seed=1)
    cfg, m = tb.cfg, tb.cfg.mla
    rng = np.random.default_rng(1)
    b, s, pos = 2, 24, 17
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.standard_normal((b, s, m.kv_lora)).astype(np.float32)
    kr = rng.standard_normal((b, s, m.rope_head_dim)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[1], jparams["blocks"])["attn"]
    want, wc = jax_serve._decode_attn_mla(
        jnp.asarray(x), jp, jb.cfg, {"ckv": jnp.asarray(ckv), "kr": jnp.asarray(kr)},
        jnp.asarray(pos, jnp.int32), 0)
    cache = {"ckv": torch.from_numpy(ckv.copy()), "kr": torch.from_numpy(kr.copy())}
    out = transformer_serve._decode_attn_mla(
        torch.from_numpy(x), layer(tparams["blocks"], 1)["attn"], cfg, cache, pos,
        torch.full((1,), pos), torch.tensor(pos + 1, dtype=torch.int32), 0)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    for name in cache:
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(wc[name]),
                                   atol=1e-6, rtol=1e-6)


def test_mla_cache_is_latent_with_a_lead_group():
    """The cache of deepseek-v2-lite holds the latent and the rope key only,
    with the dense lead layer in its own group, as the reference's."""
    tb = get_bundle(ARCH, reduced=False)
    spec = tb.cache_spec(8, 640)
    assert set(spec) == {"blocks", "lead"}
    assert tuple(spec["blocks"]["ckv"].shape) == (26, 8, 640, 512)
    assert tuple(spec["blocks"]["kr"].shape) == (26, 8, 640, 64)
    assert tuple(spec["lead"]["ckv"].shape) == (1, 8, 640, 512)
