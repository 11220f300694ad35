"""The port's Mamba-2 slice against the reference, on the CPU.

K4's plain version (what the wrapper runs on CPU tensors) against the
reference's Pallas SSD kernel in interpret mode, its oracle and its model
path ``ssd_chunked`` (with ``state_in`` and the final state); then the
port's Mamba-2 model, bundle, segments, generation and serving against the
reference's on the reduced mamba2-1.3b (2 layers, d=64, 8 SSD heads of
P=16, N=16, one group, chunk 16).  Weights come from the reference's
``init`` and cross with ``params_from_jax``; inputs come from numpy seeds.
The Hopper kernel itself is held against the plain version on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).

Tolerances.  Kernel level: those of tests/test_kernels.py (1e-4 against
the Pallas kernel and the O(S²) oracle, 1e-5 against the model path, whose
chunked arithmetic the plain version repeats).  Model level with float32
activations: 1e-4 (summation order).  With the bundle's bf16 activations:
|Δ| ≤ 5 % of the scale, mean ≤ 0.5 %, as the transformer's tests state
(each product rounds to 8 bits of mantissa; the two frameworks round at
other places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_bundle as jax_get_bundle
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.launch import serve as jax_serve
from repro.models import mamba2 as jax_mamba2
from repro.serving import ActivationTransport as JaxTransport
from repro.serving import Request as JaxRequest
from repro.serving import SegmentChain as JaxSegmentChain
from repro.serving import WaveBatcher as JaxWaveBatcher
from repro_torch.configs import get_bundle
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import ssd_chunk as k4
from repro_torch.launch import serve
from repro_torch.models import mamba2
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import (ActivationTransport, Request, SegmentChain,
                                 SegmentRunner, WaveBatcher, split_params)

ARCH = "mamba2-1.3b"


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32), np.float32)


def _ssd_inputs(b, s, h, g, n, p, seed):
    """The distributions of tests/test_kernels.py::test_ssd_vs_ref, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h), dtype=np.float32)))
    a = -np.exp(np.linspace(0.0, 1.0, h, dtype=np.float32))
    bm = rng.standard_normal((b, s, g, n), dtype=np.float32) * 0.3
    cm = rng.standard_normal((b, s, g, n), dtype=np.float32) * 0.3
    arrs = (x, dt, a, bm, cm)
    return [jnp.asarray(v) for v in arrs], [torch.from_numpy(v) for v in arrs]


# ---------------------------------------------------------------------------
# K4's plain version vs the Pallas kernel, the oracles and the model path
# ---------------------------------------------------------------------------

# the grid of tests/test_kernels.py::test_ssd_vs_ref
@pytest.mark.parametrize("s,h,g,n,p,chunk", [
    (64, 4, 2, 16, 8, 16),
    (48, 4, 1, 16, 16, 16),       # 3 chunks of 16
    (64, 2, 2, 8, 8, 64),         # single chunk
])
def test_ssd_plain_matches_pallas_kernel_and_oracles(s, h, g, n, p, chunk):
    b = 2
    (jx, jdt, ja, jb, jc), (tx, tdt, ta, tb, tc) = _ssd_inputs(b, s, h, g, n, p,
                                                               seed=s + h + n)
    want = jax_ops.ssd(jx, jdt, ja, jb, jc, chunk=chunk, interpret=True)
    got = ops.ssd(tx, tdt, ta, tb, tc, chunk=chunk)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)
    # the kernel-layout oracles ([B·H, S, ·] rows), port and reference
    rep = h // g

    def rows(t, last):
        return t.transpose(1, 2).reshape(b * h, s, last)

    def grouped(t):
        return rows(t.repeat_interleave(rep, dim=2), n)

    args = (rows(tx, p), tdt.transpose(1, 2).reshape(b * h, s), ta.repeat(b),
            grouped(tb), grouped(tc))
    mine = ref.ssd_chunk_ref(*args)
    theirs = jax_ref.ssd_chunk_ref(*(jnp.asarray(t.numpy()) for t in args))
    np.testing.assert_allclose(_np(mine), _np(theirs), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(rows(got, p)), _np(mine), atol=1e-4, rtol=1e-4)
    # the port's O(S²) model oracle
    np.testing.assert_allclose(_np(mamba2.ssd_reference(tx, tdt, ta, tb, tc)),
                               _np(got), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("s,chunk,with_state", [
    (64, 16, True), (50, 16, True), (40, 64, False), (33, 8, True)])
def test_ssd_plain_matches_reference_model_path_with_state(s, chunk, with_state):
    """y and the final state against ``ssd_chunked`` (1e-5), with a carried
    ``state_in``, a ragged S edge (50, 33) and a single chunk (40 < 64)."""
    b, h, g, n, p = 2, 4, 2, 16, 8
    (jx, jdt, ja, jb, jc), (tx, tdt, ta, tb, tc) = _ssd_inputs(b, s, h, g, n, p,
                                                               seed=s + chunk)
    s0 = np.random.default_rng(9).standard_normal((b, h, n, p), dtype=np.float32)
    jstate = jnp.asarray(s0) if with_state else None
    tstate = torch.from_numpy(s0) if with_state else None
    jy, jst = jax_mamba2.ssd_chunked(jx, jdt, ja, jb, jc, chunk=chunk,
                                     state_in=jstate, return_state=True)
    ty, tst = ops.ssd(tx, tdt, ta, tb, tc, chunk=chunk, state_in=tstate,
                      return_state=True)
    assert tst.dtype == torch.float32 and tuple(tst.shape) == (b, h, n, p)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(tst), _np(jst), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("s,chunk,with_state", [
    (64, 16, True), (50, 16, True), (40, 64, False), (200, 64, True),
    (300, 256, True), (520, 256, False)])
def test_ssd_stage_plains_compose_to_reference_model_path(s, chunk, with_state):
    """The three plain stages of the bf16 kernels (chunk states, carry, chunk
    scan) composed give ``ssd_chunked``'s y and final state: ragged S edges
    (50, 300, 520), a carried ``state_in``, G=2, chunks of 16, 64 and 256.
    Float32 throughout, 1e-5 against the port's oracle ``ssd_plain`` and,
    for chunks up to 64, against the reference.  At chunk 256 the float32
    sums over 256 steps, taken in another order, already put ``ssd_plain``
    2e-5 from the reference, so there the reference is held at
    tests/test_kernels.py's SSD tolerance (1e-4)."""
    b, h, g, n, p = 2, 4, 2, 16, 8
    (jx, jdt, ja, jb, jc), (tx, tdt, ta, tb, tc) = _ssd_inputs(b, s, h, g, n, p,
                                                               seed=s + chunk + 1)
    s0 = np.random.default_rng(11).standard_normal((b, h, n, p), dtype=np.float32)
    jstate = jnp.asarray(s0) if with_state else None
    tstate = torch.from_numpy(s0) if with_state else None
    jy, jst = jax_mamba2.ssd_chunked(jx, jdt, ja, jb, jc, chunk=chunk,
                                     state_in=jstate, return_state=True)
    cums, shat = k4.ssd_chunk_state_plain(tx, tdt, ta, tb, chunk=chunk)
    nc = -(-s // min(chunk, s))
    assert tuple(cums.shape) == (b, h, nc, min(chunk, s))
    assert tuple(shat.shape) == (b, h, nc, n, p)
    s_in, final = k4.ssd_state_pass_plain(shat, cums[..., -1], tstate)
    y = k4.ssd_chunk_scan_plain(tx, tdt, tb, tc, cums, s_in, chunk=chunk)
    py, pst = k4.ssd_plain(tx, tdt, ta, tb, tc, chunk=chunk, state_in=tstate,
                           return_state=True)
    np.testing.assert_allclose(_np(y), _np(py), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(final), _np(pst), atol=1e-5, rtol=1e-5)
    tol = 1e-5 if chunk <= 64 else 1e-4
    np.testing.assert_allclose(_np(y), _np(jy), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(final), _np(jst), atol=tol, rtol=tol)


def test_ssd_stages_take_only_cuda_bf16():
    """The stage view of the kernels runs on the card only (no plain fallback)."""
    (_, _, _, _, _), (tx, tdt, ta, tb, tc) = _ssd_inputs(1, 16, 2, 1, 8, 8, 7)
    with pytest.raises(ValueError, match="CUDA"):
        k4.ssd_stages(tx.bfloat16(), tdt, ta, tb.bfloat16(), tc.bfloat16(), chunk=8)


def test_ssd_state_carries_across_calls():
    """Two calls, the second seeded with the first's final state, give the
    one-call result: what chunked prefill relies on."""
    (_, _, _, _, _), (tx, tdt, ta, tb, tc) = _ssd_inputs(1, 48, 4, 1, 16, 8, 3)
    y, st = ops.ssd(tx, tdt, ta, tb, tc, chunk=16, return_state=True)
    y1, st1 = ops.ssd(tx[:, :20], tdt[:, :20], ta, tb[:, :20], tc[:, :20],
                      chunk=16, return_state=True)
    y2, st2 = ops.ssd(tx[:, 20:], tdt[:, 20:], ta, tb[:, 20:], tc[:, 20:],
                      chunk=16, state_in=st1, return_state=True)
    np.testing.assert_allclose(_np(torch.cat([y1, y2], 1)), _np(y),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(st2), _np(st), atol=1e-5, rtol=1e-5)


def test_ssd_bf16_output_dtype():
    (_, _, _, _, _), (tx, tdt, ta, tb, tc) = _ssd_inputs(1, 32, 4, 1, 16, 8, 4)
    got = ops.ssd(tx.bfloat16(), tdt, ta, tb.bfloat16(), tc.bfloat16(), chunk=16)
    want = ops.ssd(tx.bfloat16().float(), tdt, ta, tb.bfloat16().float(),
                   tc.bfloat16().float(), chunk=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=2e-2)


def test_ssd_wrapper_counts_only_kernel_launches():
    """On CPU tensors the wrapper runs the plain version: no launch counted."""
    (_, _, _, _, _), (tx, tdt, ta, tb, tc) = _ssd_inputs(1, 16, 2, 1, 8, 8, 5)
    before = k4.ssd.launches
    ops.ssd(tx, tdt, ta, tb, tc, chunk=8)
    mamba2.ssd_chunked(tx, tdt, ta, tb, tc, chunk=8, return_state=True)
    assert k4.ssd.launches == before


@pytest.mark.parametrize("bad", ["x_rank", "dt_shape", "A_shape", "groups",
                                 "bc_shape", "state_shape", "chunk", "device"])
def test_ssd_rejects_malformed_inputs(bad):
    (_, _, _, _, _), (tx, tdt, ta, tb, tc) = _ssd_inputs(1, 16, 4, 2, 8, 8, 6)
    state, chunk = None, 8
    if bad == "x_rank":
        tx = tx[0]
    elif bad == "dt_shape":
        tdt = tdt[:, :-1]
    elif bad == "A_shape":
        ta = ta[:-1]
    elif bad == "groups":
        tb, tc = tb.repeat(1, 1, 3, 1)[:, :, :3], tc.repeat(1, 1, 3, 1)[:, :, :3]
    elif bad == "bc_shape":
        tc = tc[..., :-1]
    elif bad == "state_shape":
        state = torch.zeros(1, 4, 8, 7)
    elif bad == "chunk":
        chunk = 0
    else:
        tx = tx.to("meta")
    with pytest.raises(ValueError):
        ops.ssd(tx, tdt, ta, tb, tc, chunk=chunk, state_in=state)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A CUDA tensor reaches ``build.load``; without nvcc the build raises,
    so a wrapper never falls back to its plain version on the card."""
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()


# ---------------------------------------------------------------------------
# the model, against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def both():
    jb = jax_get_bundle(ARCH, reduced=True)
    jparams = jb.init(jax.random.PRNGKey(0), jnp.float32)
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    tb = get_bundle(ARCH, reduced=True)
    tparams = params_from_jax(np_tree, tb.cfg, device="cpu")
    return jb, jparams, np_tree, tb, tparams


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape, dtype=np.int32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _assert_bf16_close(out, ref_, max_frac=0.05, mean_frac=0.005):
    scale = float(np.abs(ref_).max())
    d = np.abs(_np(out) - _np(ref_))
    assert float(d.max()) <= max_frac * scale, (float(d.max()), scale)
    assert float(d.mean()) <= mean_frac * scale, (float(d.mean()), scale)


def test_params_from_jax_round_trip(both):
    """Every leaf crosses bit-exactly (float32 both ways; no tolerance)."""
    _, _, np_tree, _, tparams = both
    a, b = dict(_leaves(np_tree)), dict(_leaves(tparams))
    assert a.keys() == b.keys()
    for k in a:
        assert b[k].dtype == torch.float32
        np.testing.assert_array_equal(b[k].numpy(), a[k], err_msg=k)


def test_init_params_matches_reference_tree(both):
    """The port's own init: the reference's structure, shapes, dtypes and
    scale (stds within 25 %); A_log = log(1..H) within one float32 ulp
    (torch's and XLA's log round differently)."""
    _, _, np_tree, tb, _ = both
    mine = tb.init(torch.Generator().manual_seed(0), "cpu", torch.bfloat16)
    ref_bf16 = jax.tree_util.tree_map(
        np.asarray, jax_get_bundle(ARCH, reduced=True).init(
            jax.random.PRNGKey(0), jnp.bfloat16))
    a, b, r16 = dict(_leaves(np_tree)), dict(_leaves(mine)), dict(_leaves(ref_bf16))
    assert a.keys() == b.keys()
    for k in a:
        assert tuple(b[k].shape) == a[k].shape, k
        assert (b[k].dtype == torch.float32) == (r16[k].dtype == np.float32), k
        sa, sb = float(a[k].std()), float(b[k].float().std())
        assert sb == pytest.approx(sa, rel=0.25, abs=1e-6), k
    np.testing.assert_array_max_ulp(b["/blocks/A_log"].numpy(), a["/blocks/A_log"],
                                    maxulp=1)


def test_forward_float32_matches_reference(both):
    """With float32 activations the forwards agree to 1e-4."""
    jb, jparams, _, tb, tparams = both
    toks = _tokens(tb.cfg.vocab, (2, 40))
    x = jax_mamba2.embed_tokens(jparams, jb.cfg, jnp.asarray(toks),
                                compute_dtype=jnp.float32)
    want = jax_mamba2.logits_fn(jparams, jb.cfg, jax_mamba2.forward_hidden(
        jparams, jb.cfg, x, remat=False))
    xt = mamba2.embed_tokens(tparams, tb.cfg, torch.as_tensor(toks),
                             compute_dtype=torch.float32)
    got = mamba2.logits_fn(tparams, tb.cfg, mamba2.forward_hidden(tparams, tb.cfg, xt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


# the cut sets of tests/test_serving.py::test_split_chain_equals_monolith
@pytest.mark.parametrize("cuts", ["(0, 1, L)", "(0, L // 2, L)", "(0, 1, L - 1, L)",
                                  "(0, 2, 3, L - 1, L)"])
def test_segment_chain_matches_reference_and_monolith(both, cuts):
    """Port chain vs the reference's chain (bf16-close), and split ==
    monolith inside the port (< 1e-4; the same ops run in the same order)."""
    jb, jparams, _, tb, tparams = both
    L = len(tb.model_graph())
    bounds = tuple(sorted(set(min(max(x, 0), L) for x in eval(cuts))))
    toks = _tokens(tb.cfg.vocab, (2, 24))
    got = SegmentChain(tb, tparams, bounds)(torch.as_tensor(toks))
    want = JaxSegmentChain(jb, jparams, bounds)(jnp.asarray(toks))
    assert tuple(got.shape) == (2, 24, tb.cfg.vocab)
    _assert_bf16_close(got.numpy(), np.asarray(want))
    mono = SegmentRunner(tb, 0, L)(tparams, torch.as_tensor(toks))
    assert float((got - mono).abs().max()) < 1e-4


def test_compressed_chain_accounts_bytes_like_reference(both):
    jb, jparams, _, tb, tparams = both
    toks = _tokens(tb.cfg.vocab, (1, 16), seed=3)
    L = len(tb.model_graph())
    jt, tt = JaxTransport(compress=True), ActivationTransport(compress=True)
    want = JaxSegmentChain(jb, jparams, (0, 2, 3, L), transfer_hook=jt)(
        jnp.asarray(toks))
    got = SegmentChain(tb, tparams, (0, 2, 3, L), transfer_hook=tt)(
        torch.as_tensor(toks))
    _assert_bf16_close(got.numpy(), np.asarray(want), max_frac=0.10)
    assert tt.stats.transfers == jt.stats.transfers == 2
    assert tt.stats.raw_bytes == jt.stats.raw_bytes
    assert tt.stats.wire_bytes == jt.stats.wire_bytes


def test_split_params_are_views(both):
    _, _, _, tb, tparams = both
    L = len(tb.model_graph())
    base = dict(_leaves(tparams))
    for seg in split_params(tb, tparams, (0, 2, 3, L)):
        for name, t in _leaves(seg):
            assert t.untyped_storage().data_ptr() == \
                base[name].untyped_storage().data_ptr(), name


def test_model_graph_and_cache_spec_match_reference():
    for reduced in (True, False):
        jb, tb = jax_get_bundle(ARCH, reduced=reduced), get_bundle(ARCH, reduced=reduced)
        jg, tg = jb.model_graph(), tb.model_graph()
        assert [u.name for u in jg.nodes] == [u.name for u in tg.nodes]
        for attr in ("flops", "weight_bytes", "act_out_bytes", "privacy"):
            np.testing.assert_array_equal(getattr(jg, attr), getattr(tg, attr))
        assert tb.num_params() == jb.num_params()
        want, got = jb.cache_spec(3, 40), tb.cache_spec(3, 40)
        assert want.keys() == got.keys()
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, k
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
            assert got[k].device.type == "meta"


def test_prefill_matches_reference(both):
    """Last-position logits and both state leaves, bf16-close; the SSM state
    float32 and the conv tail bf16, as in the reference."""
    jb, jparams, _, tb, tparams = both
    toks = _tokens(tb.cfg.vocab, (2, 40), seed=2)
    jl, jc = jb.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len=64)
    tl, tc = tb.prefill(tparams, {"tokens": torch.as_tensor(toks)}, max_len=64)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, tb.cfg.vocab)
    _assert_bf16_close(tl.numpy(), np.asarray(jl))
    assert tc["ssm"].dtype == torch.float32 and tc["conv"].dtype == torch.bfloat16
    for name in ("ssm", "conv"):
        assert tuple(tc[name].shape) == jc[name].shape
        _assert_bf16_close(tc[name], jc[name])


def test_decode_teacher_forced_matches_reference(both):
    """8 decode steps, both fed the reference's greedy tokens; the port
    updates the state in place."""
    jb, jparams, _, tb, tparams = both
    toks = _tokens(tb.cfg.vocab, (2, 24), seed=4)
    jl, jc = jb.prefill(jparams, {"tokens": jnp.asarray(toks)})
    _, tc = tb.prefill(tparams, {"tokens": torch.as_tensor(toks)})
    for step in range(8):
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        pos = 24 + step
        jl, jc = jb.decode(jparams, jc, jnp.asarray(tok), jnp.asarray(pos, jnp.int32))
        tl, tc2 = tb.decode(tparams, tc, torch.as_tensor(tok), pos)
        assert tc2 is tc
        _assert_bf16_close(tl.numpy(), np.asarray(jl))
    _assert_bf16_close(tc["ssm"], jc["ssm"])


def test_prefill_decode_matches_full_forward_in_port(both):
    """The counterpart of tests/test_serving.py::
    test_prefill_decode_matches_full_forward for this family: rel < 5e-2."""
    _, _, _, tb, tparams = both
    B, S = 2, 33
    toks = torch.as_tensor(_tokens(tb.cfg.vocab, (B, S), seed=7))
    logits_full, _ = tb.prefill(tparams, {"tokens": toks})
    _, cache = tb.prefill(tparams, {"tokens": toks[:, :-1]}, max_len=S)
    logits_dec, _ = tb.decode(tparams, cache, toks[:, -1], S - 1)
    a, d = logits_full.numpy(), logits_dec.numpy()
    rel = np.max(np.abs(a - d)) / (np.max(np.abs(a)) + 1e-9)
    assert rel < 5e-2, rel


MARGIN_TOL = 0.10   # two logits that each move by up to 5 % of the scale
                    # can swap order only when their gap is under 10 %


def test_wave_batcher_matches_reference():
    """Equal stats, and equal tokens except where the reference's own top-2
    margin at that step is under MARGIN_TOL."""
    jb = jax_get_bundle(ARCH, reduced=True)
    jparams = jb.init(jax.random.PRNGKey(7), jnp.float32)
    tb = get_bundle(ARCH, reduced=True)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tb.cfg, device="cpu")
    jwb = JaxWaveBatcher(jb, jparams, max_batch=3, max_len=64)
    calls = []

    def recorded(fn, kind):
        def run(*args):
            logits, cache = fn(*args)
            calls.append((kind, np.asarray(logits, np.float32)))
            return logits, cache
        return run

    jwb._prefill = recorded(jwb._prefill, "prefill")
    jwb._decode = recorded(jwb._decode, "decode")
    twb = WaveBatcher(tb, tparams, max_batch=3, max_len=64)

    def requests(cls):
        rng = np.random.default_rng(1)
        return [cls(rid=i, prompt=rng.integers(0, tb.cfg.vocab, 9 + i,
                                               dtype=np.int32),
                    max_new_tokens=5) for i in range(7)]

    jreqs, treqs = requests(JaxRequest), requests(Request)
    for jr, tr in zip(jreqs, treqs):
        jwb.submit(jr)
        twb.submit(tr)
    jstats, tstats = jwb.run(), twb.run()
    assert vars(tstats) == vars(jstats) and tstats.waves == 3
    waves = []
    for kind, logits in calls:
        if kind == "prefill":
            waves.append([])
        waves[-1].append(logits)
    for r_i, (jr, tr) in enumerate(zip(jreqs, treqs)):
        assert tr.done and len(tr.output) == len(jr.output)
        assert all(0 <= t < tb.cfg.vocab for t in tr.output)
        w, row = divmod(r_i, 3)
        for step, (a, b) in enumerate(zip(jr.output, tr.output)):
            if a != b:
                top = np.sort(waves[w][step][row])
                assert top[-1] - top[-2] < MARGIN_TOL * np.abs(top).max(), (r_i, step)
                break


@pytest.mark.parametrize("argv", [
    ["--arch", ARCH, "--requests", "3", "--compress"],
    ["--arch", ARCH, "--requests", "4", "--prompt-len", "40",
     "--backhaul-mbps", "20"],
])
def test_serve_summary_equals_reference(argv):
    ref_out = jax_serve.main(argv)
    out = serve.main(argv + ["--device", "cpu"])
    assert out == ref_out


def test_unported_families_still_raise(both):
    """Transformer, Mamba-2 and Griffin are ported; other config types and
    families raise where they enter the port."""
    import dataclasses

    from repro_torch.models.api import bundle_for

    with pytest.raises(TypeError, match="not ported yet"):
        bundle_for("x", object())
    tb = both[3]
    other = dataclasses.replace(tb, family="encoder-decoder")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        SegmentRunner(other, 0, 2)(both[4], torch.zeros(1, 4, dtype=torch.int32))
