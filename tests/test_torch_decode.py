"""The port's generation path against the reference's, on the CPU.

K3's plain version (what the wrapper runs on CPU tensors) against the
reference's Pallas decode kernel in interpret mode and against both
packages' oracles; the port's ``update_kv_cache``, ``prefill``,
``decode_step`` and ``WaveBatcher`` against the reference's on the reduced
llama3-8b (2 layers, d=64, 4 heads, GQA kv=2, hd=16).  Weights come from
the reference's ``init`` and cross with ``params_from_jax``; inputs come
from numpy seeds.  The Hopper kernel itself is held against the plain
version on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).

Tolerances.  Kernel level: those of tests/test_kernels.py, 2e-5 float32
and 2e-2 bfloat16.  Model level: activations are bf16 in both packages, and
the port's attention follows the TPU kernels (q scaled and P·V in float32)
where the reference's model path scales q and casts P to bf16 first; so
logits agree to bf16 level: |Δ| ≤ 5 % of the logit scale, mean ≤ 0.5 %
(as tests/test_torch_model.py's chain test).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_bundle as jax_get_bundle
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models import attention as jax_attention
from repro.serving import Request as JaxRequest
from repro.serving import WaveBatcher as JaxWaveBatcher
from repro_torch.configs import get_bundle
from repro_torch.kernels import decode_attention as k3
from repro_torch.kernels import ops, ref
from repro_torch.models import attention, transformer_serve
from repro_torch.models.convert import params_from_jax
from repro_torch.models.common import tree_map
from repro_torch.serving import Request, WaveBatcher

ARCH = "llama3-8b"
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


def _both(seed=0):
    jb = jax_get_bundle(ARCH, reduced=True)
    jparams = jb.init(jax.random.PRNGKey(seed), jnp.float32)
    tb = get_bundle(ARCH, reduced=True)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tb.cfg, device="cpu")
    return jb, jparams, tb, tparams


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape, dtype=np.int32)


def _assert_bf16_close(out, ref_, max_frac=0.05, mean_frac=0.005):
    scale = float(np.abs(ref_).max())
    d = np.abs(np.asarray(out, np.float32) - np.asarray(ref_, np.float32))
    assert float(d.max()) <= max_frac * scale, (float(d.max()), scale)
    assert float(d.mean()) <= mean_frac * scale, (float(d.mean()), scale)


# ---------------------------------------------------------------------------
# (a) K3's plain version vs the Pallas kernel and the oracles
# ---------------------------------------------------------------------------

# the grid of tests/test_kernels.py::test_decode_attention_vs_ref, plus a
# soft-capped case
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("s,h,kv,hd,cur,window,cap", [
    (64, 8, 2, 32, 64, 0, 0.0),
    (64, 8, 2, 32, 17, 0, 0.0),
    (64, 8, 1, 64, 40, 16, 0.0),
    (96, 4, 4, 32, 96, 0, 0.0),
    (64, 8, 2, 32, 50, 0, 30.0),
])
def test_decode_plain_matches_pallas_kernel_and_oracles(s, h, kv, hd, cur,
                                                        window, cap, dtype, tol):
    b = 2
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(b, h, hd), (b, s, kv, hd), (b, s, kv, hd)], dtype, seed=s + h + cur)
    want = jax_ops.decode_attention(jq, jk, jv, jnp.asarray(cur), window=window,
                                    logit_cap=cap, block_k=32, interpret=True)
    got = ops.decode_attention(tq, tk, tv, torch.tensor(cur), window=window,
                               logit_cap=cap)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    # the port's oracle (the reference's model-path math) against the
    # reference's, and against the kernel's plain version
    mine = ref.decode_attention_ref(tq, tk, tv, cur, window=window, logit_cap=cap)
    theirs = jax_ref.decode_attention_ref(jq, jk, jv, jnp.asarray(cur),
                                          window=window, logit_cap=cap)
    np.testing.assert_allclose(_np(mine), _np(theirs), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), _np(mine), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# (b) cur_len per row, against the reference's model path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("window", [0, 8])
def test_decode_per_row_cur_len_matches_reference_model_path(window, dtype, tol):
    b, s, h, kv, hd = 4, 48, 8, 2, 16
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(b, h, hd), (b, s, kv, hd), (b, s, kv, hd)], dtype, seed=11 + window)
    cur = np.array([1, 17, 32, 48], np.int32)
    want = jax_attention.decode_attention(jq, jk, jv, jnp.asarray(cur),
                                          window=window)
    got = attention.decode_attention(tq, tk, tv, torch.as_tensor(cur),
                                     window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    # row by row, each with its own scalar cur_len: the same rows
    for i, c in enumerate(cur):
        row = k3.decode_attention_plain(tq[i:i + 1], tk[i:i + 1], tv[i:i + 1],
                                        int(c), window=window)
        assert torch.equal(row[0], got[i])


def test_decode_no_valid_key_gives_zero():
    """cur_len 0: no key counts; the TPU kernel's acc / max(l, 1e-30) = 0."""
    (jq, jk, jv), (tq, tk, tv) = _inputs([(1, 4, 16), (1, 32, 2, 16),
                                          (1, 32, 2, 16)], "float32", seed=5)
    want = jax_ops.decode_attention(jq, jk, jv, jnp.asarray(0), block_k=16,
                                    interpret=True)
    got = k3.decode_attention_plain(tq, tk, tv, 0)
    assert not got.any()
    np.testing.assert_array_equal(_np(got), _np(want))


# ---------------------------------------------------------------------------
# (g) the cache write places pos as dynamic_update_slice; the wrapper's checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos", [0, 5, 7, 8, 12, -3, -20])
def test_update_kv_cache_clamps_like_reference(pos):
    b, s, kv, hd = 2, 8, 2, 4
    rng = np.random.default_rng(pos + 20)
    kc, vc = (rng.standard_normal((b, s, kv, hd), dtype=np.float32) for _ in "kv")
    kn, vn = (rng.standard_normal((b, kv, hd), dtype=np.float32) for _ in "kv")
    jk, jvc = jax_attention.update_kv_cache(jnp.asarray(kc), jnp.asarray(vc),
                                            jnp.asarray(kn), jnp.asarray(vn),
                                            jnp.asarray(pos))
    tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    out_k, out_v = attention.update_kv_cache(tkc, tvc, torch.from_numpy(kn),
                                             torch.from_numpy(vn), pos)
    assert out_k is tkc and out_v is tvc          # written in place
    np.testing.assert_array_equal(out_k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(out_v.numpy(), np.asarray(jvc))
    slot = min(max(pos + s if pos < 0 else pos, 0), s - 1)
    np.testing.assert_array_equal(out_k[:, slot].numpy(), kn)


def test_decode_wrapper_counts_only_kernel_launches():
    """On CPU tensors the wrapper runs the plain version: no launch counted."""
    before = k3.decode_attention.launches
    q = torch.zeros(2, 4, 16)
    c = torch.zeros(2, 8, 2, 16)
    ops.decode_attention(q, c, c, 3)
    ops.decode_attention(q, c, c, torch.tensor([1, 8]))
    assert k3.decode_attention.launches == before


@pytest.mark.parametrize("bad", ["q_rank", "cache_shape", "heads", "dtype",
                                 "cur_shape", "cur_float"])
def test_decode_rejects_malformed_inputs(bad):
    q = torch.zeros(2, 4, 16)
    k = torch.zeros(2, 8, 2, 16)
    v = k
    cur = torch.tensor(3)
    if bad == "q_rank":
        q = q[None]
    elif bad == "cache_shape":
        v = torch.zeros(2, 7, 2, 16)
    elif bad == "heads":
        k = v = torch.zeros(2, 8, 3, 16)
    elif bad == "dtype":
        k = k.to(torch.bfloat16)
    elif bad == "cur_shape":
        cur = torch.tensor([3, 4, 5])
    else:
        cur = torch.tensor(3.0)
    with pytest.raises(ValueError):
        ops.decode_attention(q, k, v, cur)


@pytest.mark.parametrize("b,h,kv,s", [(8, 32, 8, 640), (1, 32, 8, 32768),
                                      (2, 8, 2, 64), (3, 32, 1, 1000),
                                      (1, 4, 4, 17)])
def test_split_plan_covers_the_cache(b, h, kv, s):
    n_split, chunk = k3.split_plan(b, h, kv, s, 132)
    assert n_split >= 1 and chunk % 16 == 0
    assert n_split * chunk >= s > (n_split - 1) * chunk
    if (b, h, kv, s) == (8, 32, 8, 640):     # the generation path's shape:
        assert (n_split, chunk) == (4, 160)  # 256 blocks, one wave of 2 an SM


# ---------------------------------------------------------------------------
# (c)-(e) prefill and decode against the reference
# ---------------------------------------------------------------------------

def test_cache_spec_matches_reference():
    jb, _, tb, _ = _both()
    want = jb.cache_spec(3, 40)
    got = tb.cache_spec(3, 40)
    for name in ("k", "v"):
        assert tuple(got["blocks"][name].shape) == want["blocks"][name].shape
        assert got["blocks"][name].dtype == torch.bfloat16
    cache = transformer_serve.init_cache(tb.cfg, 3, 40, device="cpu")
    assert not cache["blocks"]["k"].any()


def test_prefill_matches_reference():
    """Last-position logits and the bf16 cache.  Layer 0's k/v come from the
    embeddings through the same products: bit-identical.  Deeper layers see
    the attention difference stated above: bf16-close.  Past the prompt the
    cache is zero in both."""
    jb, jparams, tb, tparams = _both()
    toks = _tokens(tb.cfg.vocab, (2, 24))
    jl, jc = jb.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len=40)
    tl, tc = tb.prefill(tparams, {"tokens": torch.as_tensor(toks)}, max_len=40)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, tb.cfg.vocab)
    _assert_bf16_close(tl.numpy(), np.asarray(jl))
    for name in ("k", "v"):
        got, want = tc["blocks"][name], jc["blocks"][name]
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        got, want = _np(got), _np(want)
        np.testing.assert_array_equal(got[0], want[0])
        _assert_bf16_close(got[1:], want[1:])
        assert not got[:, :, 24:].any() and not want[:, :, 24:].any()


def test_prefill_writes_cache_dtype_from_bf16_params():
    _, _, tb, tparams = _both()
    bf16 = tree_map(lambda a: a.to(torch.bfloat16), tparams)
    toks = torch.as_tensor(_tokens(tb.cfg.vocab, (1, 9)))
    logits, cache = transformer_serve.prefill(bf16, tb.cfg, toks,
                                              cache_dtype=torch.float32)
    assert logits.dtype == torch.float32
    assert cache["blocks"]["k"].dtype == torch.float32
    assert cache["blocks"]["k"].shape[2] == 9     # max_len defaults to S


def test_decode_teacher_forced_matches_reference():
    """8 decode steps, both fed the reference's greedy tokens: the port's
    logits stay bf16-close to the reference's at every step."""
    jb, jparams, tb, tparams = _both()
    toks = _tokens(tb.cfg.vocab, (2, 24), seed=4)
    jl, jc = jb.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len=40)
    _, tc = tb.prefill(tparams, {"tokens": torch.as_tensor(toks)}, max_len=40)
    for step in range(8):
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        pos = 24 + step
        jl, jc = jb.decode(jparams, jc, jnp.asarray(tok), jnp.asarray(pos, jnp.int32))
        tl, tc2 = tb.decode(tparams, tc, torch.as_tensor(tok), pos)
        assert tc2 is tc                      # the cache is updated in place
        _assert_bf16_close(tl.numpy(), np.asarray(jl))


def test_prefill_decode_matches_full_forward_in_port():
    """The counterpart of tests/test_serving.py::
    test_prefill_decode_matches_full_forward, in the port: rel < 2e-2."""
    _, _, tb, tparams = _both()
    B, S = 2, 33
    toks = torch.as_tensor(_tokens(tb.cfg.vocab, (B, S), seed=7))
    logits_full, _ = tb.prefill(tparams, {"tokens": toks})
    _, cache = tb.prefill(tparams, {"tokens": toks[:, :-1]}, max_len=S)
    logits_dec, _ = tb.decode(tparams, cache, toks[:, -1], S - 1)
    a, d = logits_full.numpy(), logits_dec.numpy()
    rel = np.max(np.abs(a - d)) / (np.max(np.abs(a)) + 1e-9)
    assert rel < 2e-2, rel


# ---------------------------------------------------------------------------
# (f) WaveBatcher against the reference's
# ---------------------------------------------------------------------------

MARGIN_TOL = 0.10   # of the row's logit scale: two logits that each move by
                    # up to 5 % of it (bf16-close, above) can swap order only
                    # when their gap is under 10 %


def _requests(cls, vocab):
    rng = np.random.default_rng(1)
    return [cls(rid=i, prompt=rng.integers(0, vocab, 9 + i, dtype=np.int32),
                max_new_tokens=5) for i in range(7)]


def test_wave_batcher_matches_reference():
    """The setup of tests/test_serving.py::test_wave_batcher_completes_all
    (params from PRNGKey(7)): equal stats, and equal tokens except where the
    reference's own top-2 margin at that step is under MARGIN_TOL."""
    jb, jparams, tb, tparams = _both(seed=7)
    jwb = JaxWaveBatcher(jb, jparams, max_batch=3, max_len=64)
    calls = []                       # the reference's logits, in call order

    def recorded(fn, kind):
        def run(*args):
            logits, cache = fn(*args)
            calls.append((kind, np.asarray(logits, np.float32)))
            return logits, cache
        return run

    jwb._prefill = recorded(jwb._prefill, "prefill")
    jwb._decode = recorded(jwb._decode, "decode")
    twb = WaveBatcher(tb, tparams, max_batch=3, max_len=64)
    jreqs, treqs = _requests(JaxRequest, jb.cfg.vocab), _requests(Request, tb.cfg.vocab)
    for jr, tr in zip(jreqs, treqs):
        jwb.submit(jr)
        twb.submit(tr)
    jstats, tstats = jwb.run(), twb.run()
    assert vars(tstats) == vars(jstats)
    assert tstats.completed == 7 and tstats.waves == 3

    waves, wave_logits = [], None     # per wave: the logits of each step
    for kind, logits in calls:
        if kind == "prefill":
            wave_logits = []
            waves.append(wave_logits)
        wave_logits.append(logits)
    assert len(waves) == 3
    for r_i, (jr, tr) in enumerate(zip(jreqs, treqs)):
        assert tr.done and len(tr.output) == len(jr.output)
        assert all(0 <= t < tb.cfg.vocab for t in tr.output)
        w, row = divmod(r_i, 3)
        for step, (a, b) in enumerate(zip(jr.output, tr.output)):
            if a == b:
                continue
            top = np.sort(waves[w][step][row])
            margin = top[-1] - top[-2]
            assert margin < MARGIN_TOL * np.abs(top).max(), (r_i, step, margin)
            break                    # later tokens follow another history
