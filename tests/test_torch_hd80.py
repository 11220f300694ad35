"""Head dim 80 (stablelm-3b: d 2,560 over 32 heads), on the CPU.

K1, K1's backward and K3 are built at hd 80 (StableLM's head dim); what the
port runs on CPU tensors, their plain versions, is held here against the
reference:

- K1's plain version at (80, 80) against the reference's
  ``models/attention.py::chunked_attention`` and its Pallas
  ``flash_attention`` in interpret mode: causal, windowed, soft-capped,
  GQA and MHA, float32 and bf16 (2e-5 / 2e-2, tests/test_kernels.py's
  attention tolerances);
- K3's plain version at hd 80 against the reference's Pallas
  ``decode_attention`` in interpret mode, with a ragged ``cur_len`` (one
  Pallas call a row: its kernel takes one scalar), 2e-5 / 2e-2;
- K1's backward (autograd through the plain version and
  ``flash_attention_bwd_plain``) against ``jax.grad`` of the reference's
  float32 ``chunked_attention`` at 1e-5, and against ``jax.vjp`` of its
  bf16 ``chunked_attention`` at 2e-2 of each gradient's largest magnitude,
  as tests/test_torch_training.py holds every other head dim;
- a two-layer stablelm-shaped model at hd 80 (d 160, 2 heads, ``rope_frac``
  0.25: rotary over 20 of the 80 dims, LayerNorm), the reference's weights
  carried across by ``models/convert.py``: the float32 prefill's logits and
  cache and one decode step (1e-4 of the logits, the algorithm's
  summation order only), and ``bundle.loss`` with every gradient leaf
  (float32 activations on both sides: 1e-5 of the loss; each leaf within
  1e-5 of its largest magnitude on unit-variance attention scores, 5e-4 on
  the reference's init, whose saturated softmax amplifies float32 rounding:
  the reasons beside the test);
- the kernels name the pair as built: ``supported(80, 80)`` and
  ``supported_bwd(80, 80, bf16)``, and a ``meta`` call counts at hd 80
  with no launch.

The Hopper kernels themselves are held against these plain versions on
the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.models import api as jax_api
from repro.models import attention as jax_attention
from repro.models import transformer as jax_transformer
from repro.models import transformer_serve as jax_serve
from repro_torch.configs import get as port_get
from repro_torch.kernels import cost
from repro_torch.kernels import decode_attention as k3
from repro_torch.kernels import flash_attention as k1
from repro_torch.models import api as port_api
from repro_torch.models import transformer as port_transformer
from repro_torch.models import transformer_serve
from repro_torch.models.common import tree_flatten, tree_unflatten
from repro_torch.models.convert import params_from_jax

HD = 80
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
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# the kernels' tables
# ---------------------------------------------------------------------------

def test_hd80_is_built_in_k1_k1_bwd_and_k3():
    assert k1.supported(HD, HD)
    assert all(k1.supported_bwd(HD, HD, dt) for dt in (torch.bfloat16, torch.float32))
    assert HD in k3._HEAD_DIMS
    assert port_get("stablelm-3b").hd == HD


def test_meta_calls_at_hd80_count_without_a_launch():
    """The dry-run's branch: a ``meta`` call at hd 80 returns the kernel's
    output shape and records K1's, K1 backward's and K3's counts
    (``kernels/cost.py``) with no launch."""
    b, s, h = 1, 64, 32
    q = torch.empty(b, s, h, HD, device="meta", dtype=torch.bfloat16)
    lse = torch.empty(b, h, s, device="meta", dtype=torch.float32)
    before = (k1.flash_attention.launches, k1.flash_attention_bwd.launches,
              k3.decode_attention.launches)
    with cost.kernel_tally() as tally:
        o = k1.flash_attention(q, q, q)
        grads = k1.flash_attention_bwd(q, q, q, q, lse, q)
        d = k3.decode_attention(q[:, 0], q, q, torch.empty((), device="meta",
                                                           dtype=torch.int32))
    assert o.is_meta and o.shape == q.shape and d.shape == (b, h, HD)
    assert all(g.shape == q.shape for g in grads)
    assert tally["flash_attention"]["ops"] == cost.flash_attention_ops(
        b, s, h, HD, HD, True, 0)
    assert tally["flash_attention_bwd"]["ops"] == cost.flash_attention_bwd_ops(
        b, s, h, HD, HD, True, 0)
    assert tally["decode_attention"]["ops"] == cost.decode_attention_ops(b, h, s, HD)
    assert (k1.flash_attention.launches, k1.flash_attention_bwd.launches,
            k3.decode_attention.launches) == before


# ---------------------------------------------------------------------------
# K1's plain version against chunked_attention and Pallas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,window,cap", [
    (1, 96, 4, 4, 0, 0.0),        # MHA, stablelm's attention
    (2, 70, 4, 2, 0, 0.0),        # GQA, ragged S
    (1, 130, 4, 4, 32, 0.0),      # sliding window over three tiles
    (2, 64, 4, 1, 0, 30.0),       # MQA, soft-cap
    (1, 77, 6, 2, 24, 50.0),      # window and soft-cap
])
def test_flash_plain_matches_reference_and_pallas(b, s, h, kv, window, cap, dtype):
    tol = TOL[dtype]
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(b, s, h, HD), (b, s, kv, HD), (b, s, kv, HD)], dtype, seed=s + h)
    got = k1.flash_attention(tq, tk, tv, window=window, logit_cap=cap)
    assert got.shape == (b, s, h, HD) and got.dtype == tq.dtype
    want = jax_attention.chunked_attention(jq, jk, jv, causal=True, window=window,
                                           logit_cap=cap, kv_block=32)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    pallas = jax_ops.flash_attention(jq, jk, jv, causal=True, window=window,
                                     logit_cap=cap, block_q=32, block_k=32,
                                     interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# K3's plain version against Pallas, ragged cur_len
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,cur,window,cap", [
    (3, 96, 4, 4, [5, 96, 61], 0, 0.0),      # MHA (stablelm), a row per length
    (2, 64, 8, 2, [33, 1], 0, 0.0),          # G = 4
    (2, 96, 8, 1, [96, 47], 16, 0.0),        # MQA (G = 8), window
    (3, 64, 4, 2, [64, 20, 9], 0, 30.0),     # soft-cap
    (2, 96, 4, 4, 70, 0, 0.0),               # one scalar for the batch
])
def test_decode_plain_matches_pallas_ragged(b, s, h, kv, cur, window, cap, dtype):
    tol = TOL[dtype]
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(b, h, HD), (b, s, kv, HD), (b, s, kv, HD)], dtype, seed=s + b)
    got = k3.decode_attention(tq, tk, tv, torch.tensor(cur, dtype=torch.int32),
                              window=window, logit_cap=cap)
    assert got.shape == (b, h, HD) and got.dtype == tq.dtype
    lens = cur if isinstance(cur, list) else [cur] * b
    for i, n in enumerate(lens):
        pallas = jax_ops.decode_attention(
            jq[i:i + 1], jk[i:i + 1], jv[i:i + 1], jnp.asarray(n, jnp.int32),
            window=window, logit_cap=cap, block_k=32, interpret=True)
        np.testing.assert_allclose(_np(got[i:i + 1]), _np(pallas), atol=tol, rtol=tol)
    want = jax_attention.decode_attention(
        jq, jk, jv, jnp.asarray(cur, jnp.int32), window=window, logit_cap=cap)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# K1's backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,causal,window,cap", [
    (2, 40, 4, 4, True, 0, 0.0),        # MHA, causal
    (1, 37, 4, 2, True, 9, 0.0),        # GQA, window, ragged
    (2, 33, 4, 1, True, 0, 50.0),       # MQA, soft-cap
    (1, 29, 2, 2, False, 0, 30.0),      # non-causal, soft-cap
])
def test_attention_grads_match_reference(b, s, h, kv, causal, window, cap, dtype):
    """float32: ``jax.grad`` of the reference's ``chunked_attention`` at
    1e-5; bf16: ``jax.vjp`` of its bf16 ``chunked_attention`` on the same
    bf16 inputs at 2e-2 of each gradient's largest magnitude.  Both through
    the port's autograd (the plain version's) and
    ``flash_attention_bwd_plain`` (the backward kernel's formula)."""
    rng = np.random.default_rng(s + h)
    q = rng.standard_normal((b, s, h, HD), dtype=np.float32)
    k = rng.standard_normal((b, s, kv, HD), dtype=np.float32)
    v = rng.standard_normal((b, s, kv, HD), dtype=np.float32)
    do = rng.standard_normal((b, s, h, HD), dtype=np.float32)
    kw = dict(causal=causal, window=window, logit_cap=cap)
    if dtype == "float32":
        def ref(q, k, v):
            return jnp.sum(jax_attention.chunked_attention(q, k, v, **kw) * do)

        want = jax.grad(ref, argnums=(0, 1, 2))(q, k, v)
        tdt = torch.float32
    else:
        _, vjp = jax.vjp(lambda q, k, v: jax_attention.chunked_attention(q, k, v, **kw),
                         *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
        want = [x.astype(jnp.float32) for x in vjp(jnp.asarray(do, jnp.bfloat16))]
        tdt = torch.bfloat16
    ins = [torch.tensor(x).to(tdt) for x in (q, k, v)]
    dot = torch.tensor(do).to(tdt)
    qt, kt, vt = (x.clone().requires_grad_(True) for x in ins)
    got = torch.autograd.grad(k1.flash_attention(qt, kt, vt, **kw), (qt, kt, vt), dot)
    o, lse = k1.flash_attention_lse(*ins, **kw)
    plain = k1.flash_attention_bwd_plain(*ins, o, lse, dot, **kw)
    for name, w, g, p in zip("qkv", want, got, plain):
        w = np.asarray(w, np.float32)
        assert g.dtype == p.dtype == tdt and g.shape == w.shape
        tol = 1e-5 if dtype == "float32" else 2e-2 * np.abs(w).max()
        for what, x in (("autograd", g), ("bwd_plain", p)):
            err = np.abs(_np(x) - w).max()
            if dtype == "float32":
                np.testing.assert_allclose(_np(x), w, atol=tol, rtol=tol,
                                           err_msg=f"d{name} ({what})")
            else:
                assert err <= tol, (f"d{name} ({what})", err, tol)


# ---------------------------------------------------------------------------
# a two-layer stablelm-shaped model at hd 80
# ---------------------------------------------------------------------------

def _configs():
    """StableLM's block (LayerNorm, SwiGLU, partial RoPE at 25 %, MHA,
    untied embeddings) at d 160 and 2 heads: hd 80, rotary over 20 dims."""
    kw = dict(name="stablelm-hd80", vocab=96, d_model=160, n_layers=2, n_heads=2,
              n_kv=2, d_ff=192, act="silu", glu=True, norm="ln", rope_frac=0.25,
              rope_theta=10_000.0)
    return (jax_transformer.TransformerConfig(**kw),
            port_transformer.TransformerConfig(**kw))


@functools.lru_cache(maxsize=None)
def _params(unit_scores: bool = False):
    """The reference's init (seed 3) in both packages; with ``unit_scores``
    wq and wk scaled by sqrt(H / d), so the attention scores have unit
    variance (chip_smoke.py's ``conditioned``): the reference's
    ``dense_init`` takes their fan-in from H = 2, not d = 160, which puts
    the scores near an argmax."""
    jcfg, tcfg = _configs()
    jparams = jax_transformer.init_params(jcfg, jax.random.PRNGKey(3), jnp.float32)
    if unit_scores:
        attn = dict(jparams["blocks"]["attn"])
        for name in ("wq", "wk"):
            attn[name] = attn[name] * (jcfg.n_heads / jcfg.d_model) ** 0.5
        jparams = {**jparams, "blocks": {**jparams["blocks"], "attn": attn}}
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jparams, tparams


def test_stablelm_shape_is_hd80_with_20_rotary_dims():
    jcfg, tcfg = _configs()
    assert tcfg.hd == jcfg.hd == HD
    assert int(tcfg.hd * tcfg.rope_frac) == 20


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape, dtype=np.int32)


@pytest.fixture
def _f32_embeddings(monkeypatch):
    """Both packages embed in float32 (their ``embed_tokens`` compute dtype),
    so bundle.loss compares the algorithm in float32."""
    monkeypatch.setattr(jax_transformer, "embed_tokens", functools.partial(
        jax_transformer.embed_tokens, compute_dtype=jnp.float32))
    monkeypatch.setattr(port_transformer, "embed_tokens", functools.partial(
        port_transformer.embed_tokens, compute_dtype=torch.float32))


def test_stablelm_shape_prefill_and_decode_match_reference():
    """Float32 prefill on embeddings (both packages' ``embed_inputs``) with
    float32 caches, then one decode step: logits within 1e-4, the caches'
    keys (rotated over 20 of 80 dims) and values within 1e-5 of their
    largest magnitude."""
    jcfg, tcfg = _configs()
    jcfg, tcfg = (dataclasses.replace(c, embed_inputs=True) for c in (jcfg, tcfg))
    jparams, tparams = _params()
    toks = _tokens(tcfg.vocab, (2, 21), seed=5)
    x = np.asarray(jax_transformer.embed_tokens(jparams, _configs()[0],
                                                jnp.asarray(toks),
                                                compute_dtype=jnp.float32))
    jl, jc = jax_serve.prefill(jparams, jcfg, jnp.asarray(x[:, :-1]),
                               cache_dtype=jnp.float32, max_len=24)
    tl, tc = transformer_serve.prefill(tparams, tcfg, torch.tensor(x[:, :-1]),
                                       cache_dtype=torch.float32, max_len=24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    for name in ("k", "v"):
        want = np.asarray(jc["blocks"][name])
        got = tc["blocks"][name].numpy()
        assert got.shape == want.shape and want.shape[-1] == HD
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)
    jd, _ = jax_serve.decode_step(jparams, jcfg, jc, jnp.asarray(x[:, -1]), 20)
    td, _ = transformer_serve.decode_step(tparams, tcfg, tc, torch.tensor(x[:, -1]),
                                          20)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4, rtol=0)


# (unit-variance scores, tolerance of each leaf's max): on unit-variance
# scores the two packages' float32 gradients agree to 1.5e-6 of a leaf's max
# (summation order only); on the reference's init the softmax saturates and
# float32 rounding in either package moves a leaf by up to 2.7e-4 of its max
# (measured: both packages lie that far from the port run with float64
# weights and activations outside attention, and from each other), so that
# case is held at 5e-4, as tests/test_torch_training.py holds its
# ill-conditioned gemma2 at 2e-4
@pytest.mark.usefixtures("_f32_embeddings")
@pytest.mark.parametrize("unit_scores,tol", [(True, 1e-5), (False, 5e-4)],
                         ids=["unit-variance-scores", "reference-init"])
def test_stablelm_shape_loss_and_every_grad_leaf_match_reference(unit_scores, tol):
    jcfg, tcfg = _configs()
    jparams, tparams = _params(unit_scores)
    jb, tb = jax_api.bundle_for("stablelm-3b", jcfg), port_api.bundle_for(
        "stablelm-3b", tcfg)
    toks = _tokens(tcfg.vocab, (2, 24), seed=8)
    labels = np.concatenate([toks[:, 1:], np.full((2, 1), -1, np.int32)], axis=1)
    batch = {"tokens": toks, "labels": labels}
    jloss, jgrads = jax.value_and_grad(jb.loss)(
        jparams, jax.tree_util.tree_map(jnp.asarray, batch))
    leaves, structure = tree_flatten(tparams)
    ws = [p.clone().requires_grad_(True) for p in leaves]
    loss = tb.loss(tree_unflatten(structure, ws),
                   {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, ws, allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = [np.asarray(w) for w in jax.tree_util.tree_leaves(jgrads)]
    assert len(want) == len(grads)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert g.shape == w.shape, i
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(_np(g) - w).max()) <= tol * scale, i
