"""The port's transformer data plane against the reference, on the CPU.

Weights come from the reference's ``init`` and are carried across with
``params_from_jax``; tokens come from a numpy seed.  Both packages run the
reduced llama3-8b (2 layers, d=64, 4 heads, GQA kv=2, hd=16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_bundle as jax_get_bundle
from repro.core.broadcast import PartitionConfig as JaxPartitionConfig
from repro.serving import ActivationTransport as JaxTransport
from repro.serving import SegmentChain as JaxSegmentChain
from repro.serving import SplitInferenceEngine as JaxEngine
from repro_torch.configs import ALL_ARCHS, get_bundle
from repro_torch.core import PartitionConfig
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import (ActivationTransport, SegmentChain,
                                 SegmentRunner, SplitInferenceEngine,
                                 split_params)

ARCH = "llama3-8b"


def _both(seed=0):
    jb = jax_get_bundle(ARCH, reduced=True)
    jparams = jb.init(jax.random.PRNGKey(seed), jnp.float32)
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
    else:
        yield prefix, tree


def test_params_from_jax_round_trip():
    """Every leaf crosses bit-exactly (float32 both ways; no tolerance)."""
    _, _, np_tree, _, tparams = _both()
    a = dict(_leaves(np_tree))
    b = dict(_leaves(tparams))
    assert a.keys() == b.keys()
    for k in a:
        assert b[k].dtype == torch.float32
        np.testing.assert_array_equal(b[k].numpy(), a[k], err_msg=k)


def test_init_params_matches_reference_tree():
    """The port's own init has the reference's structure, shapes and scale."""
    jb = jax_get_bundle(ARCH, reduced=True)
    ref = jax.tree_util.tree_map(np.asarray, jb.init(jax.random.PRNGKey(0),
                                                     jnp.float32))
    tb = get_bundle(ARCH, reduced=True)
    mine = tb.init(torch.Generator().manual_seed(0), "cpu", torch.float32)
    a, b = dict(_leaves(ref)), dict(_leaves(mine))
    assert a.keys() == b.keys()
    for k in a:
        assert tuple(b[k].shape) == a[k].shape, k
        # same distribution: stds within 25 % (norm scales are exactly 1)
        sa, sb = float(a[k].std()), float(b[k].std())
        assert sb == pytest.approx(sa, rel=0.25, abs=1e-6), k


def test_init_params_requires_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the cuda default is valid here")
    tb = get_bundle(ARCH, reduced=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tb.init(torch.Generator().manual_seed(0))


def _assert_bf16_close(out, ref, max_frac=0.05, mean_frac=0.005):
    """Logits of a bf16 forward: |Δ| ≤ 5 % of the logit scale, mean ≤ 0.5 %.

    Activations are bf16 in both packages, so each matrix product rounds to
    8 bits of mantissa, and the two frameworks accumulate in other orders;
    the logits themselves are bf16 products (one unit in the last place is
    0.03 at magnitude 4).  The attention arithmetic also differs on purpose:
    the port follows the TPU flash kernel (q scaled and P·V in float32)
    while the reference's model path scales q in bf16 and casts P to bf16
    before P·V.  Two layers of that give differences of a few units in the
    last place; the float32 test below holds the same code to 1e-4.
    """
    scale = float(np.abs(ref).max())
    d = np.abs(out - ref)
    assert float(d.max()) <= max_frac * scale, (float(d.max()), scale)
    assert float(d.mean()) <= mean_frac * scale, (float(d.mean()), scale)


def test_forward_float32_matches_reference():
    """With float32 activations the two forwards agree to 1e-4 (summation
    order only): the port's layers compute the reference's function."""
    from repro.models import transformer as jax_transformer

    jb, jparams, _, tb, tparams = _both()
    toks = _tokens(tb.cfg.vocab, (2, 24))
    x = jax_transformer.embed_tokens(jparams, jb.cfg, jnp.asarray(toks),
                                     compute_dtype=jnp.float32)
    ref = jax_transformer.logits_fn(
        jparams, jb.cfg, jax_transformer.forward_hidden(jparams, jb.cfg, x,
                                                        remat=False))
    xt = transformer.embed_tokens(tparams, tb.cfg, torch.as_tensor(toks),
                                  compute_dtype=torch.float32)
    out = transformer.logits_fn(tparams, tb.cfg,
                                transformer.forward_hidden(tparams, tb.cfg, xt))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("bounds", [(0, 4), (0, 2, 4), (0, 1, 3, 4),
                                    (0, 1, 2, 3, 4)])
def test_segment_chain_logits_match_reference(bounds):
    """Port chain logits vs reference chain logits, fp32 weights, bf16
    activations (tolerance: see ``_assert_bf16_close``)."""
    jb, jparams, _, tb, tparams = _both()
    toks = _tokens(tb.cfg.vocab, (2, 24))
    ref = np.asarray(JaxSegmentChain(jb, jparams, bounds)(jnp.asarray(toks)))
    out = SegmentChain(tb, tparams, bounds)(torch.as_tensor(toks)).numpy()
    assert out.shape == ref.shape == (2, 24, tb.cfg.vocab)
    _assert_bf16_close(out, ref)


def test_compressed_chain_matches_reference_and_accounts_bytes():
    """int8 at the boundaries: same wire bytes as the reference, logits close.

    Quantization itself is bit-identical (tests/test_torch_kernels.py), but a
    bf16 activation that differs in the last place (see the uncompressed
    chain) can round to the neighbouring int8 step, 1/127 of its row's
    absmax, and the next layers carry that on.  So |Δ| ≤ 10 % of the logit
    scale, mean ≤ 0.5 %: inside the int8 error the reference itself accepts
    at the logits (35 % relative, tests/test_serving.py).
    """
    jb, jparams, _, tb, tparams = _both()
    toks = _tokens(tb.cfg.vocab, (1, 16), seed=3)
    jt, tt = JaxTransport(compress=True), ActivationTransport(compress=True)
    ref = np.asarray(JaxSegmentChain(jb, jparams, (0, 2, 3, 4),
                                     transfer_hook=jt)(jnp.asarray(toks)))
    out = SegmentChain(tb, tparams, (0, 2, 3, 4),
                       transfer_hook=tt)(torch.as_tensor(toks)).numpy()
    _assert_bf16_close(out, ref, max_frac=0.10)
    assert tt.stats.transfers == jt.stats.transfers == 2
    assert tt.stats.raw_bytes == jt.stats.raw_bytes
    assert tt.stats.wire_bytes == jt.stats.wire_bytes


@pytest.mark.parametrize("bounds", [(0, 1, 4), (0, 2, 4), (0, 1, 3, 4),
                                    (0, 3, 4)])
def test_split_equals_monolith_in_port(bounds):
    """Inside the port a split changes where layers run, not what they
    compute: the same ops run in the same order, so the logits are equal."""
    _, _, _, tb, tparams = _both(seed=1)
    toks = torch.as_tensor(_tokens(tb.cfg.vocab, (2, 16), seed=1))
    n = len(tb.model_graph())
    mono = SegmentRunner(tb, 0, n)(tparams, toks)
    split = SegmentChain(tb, tparams, bounds)(toks)
    assert torch.equal(mono, split)


def test_engine_reconfigure_matches_reference_engine():
    jb, jparams, _, tb, tparams = _both(seed=2)
    toks = _tokens(tb.cfg.vocab, (1, 16), seed=2)
    L = len(tb.model_graph())
    eng = SplitInferenceEngine(tb, tparams)
    ref = JaxEngine(jb, jparams)
    for version, (b, a) in enumerate([((0, 2, L), (0, 3)),
                                      ((0, 1, 3, L), (1, 2, 0))], start=1):
        eng.apply_config(PartitionConfig(version, b, a))
        ref.apply_config(JaxPartitionConfig(version, b, a))
        out = eng.infer_logits(torch.as_tensor(toks)).numpy()
        _assert_bf16_close(out, np.asarray(ref.infer_logits(jnp.asarray(toks))))
        assert eng.staged_bytes_per_node() == ref.staged_bytes_per_node()
    assert eng.reconfigurations == ref.reconfigurations == 1


def test_split_params_are_views():
    """Staging a split must not copy weights (16 GB at full width)."""
    _, _, _, tb, tparams = _both()
    L = len(tb.model_graph())
    for seg in split_params(tb, tparams, (0, 2, 3, L)):
        for name, t in _leaves(seg):
            base = dict(_leaves(tparams))[name]
            assert t.untyped_storage().data_ptr() == \
                base.untyped_storage().data_ptr(), name


def test_model_graph_matches_reference():
    for reduced in (True, False):
        jg = jax_get_bundle(ARCH, reduced=reduced).model_graph()
        tg = get_bundle(ARCH, reduced=reduced).model_graph()
        assert [u.name for u in jg.nodes] == [u.name for u in tg.nodes]
        np.testing.assert_array_equal(jg.flops, tg.flops)
        np.testing.assert_array_equal(jg.weight_bytes, tg.weight_bytes)
        np.testing.assert_array_equal(jg.act_out_bytes, tg.act_out_bytes)
        np.testing.assert_array_equal(jg.privacy, tg.privacy)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_arch_builds_reduced_on_cpu(arch):
    """Every architecture of the reference builds in the port: its reduced
    model initialises on the CPU and serves one finite prefill."""
    tb = get_bundle(arch, reduced=True)
    params = tb.init(torch.Generator().manual_seed(0), "cpu", torch.float32)
    toks = torch.as_tensor(_tokens(tb.cfg.vocab, (1, 12), seed=9))
    logits, _ = tb.prefill(params, {"tokens": toks}, max_len=16)
    assert tuple(logits.shape) == (1, tb.cfg.vocab)
    assert bool(torch.isfinite(logits).all())
