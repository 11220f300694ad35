"""The rest of the transformer zoo in the port against the reference, on the CPU.

The eight transformer configs that the first slices left out: qwen3-moe
(MoE, QK-norm), deepseek-v2-lite (MLA, MoE with a shared expert and a dense
lead block), gemma2 (sandwich norms, soft-caps, alternating windows),
stablelm (partial RoPE, LayerNorm), deepseek-coder and musicgen (hd 8, the
latter a plain GELU MLP), command-r-plus (the parallel block) and internvl2
(a projected modality prefix, hd 8), each at its reduced size.  Weights come
from the reference's ``init`` and cross with ``params_from_jax``; tokens
come from numpy seeds.

Tolerances.  Where the two packages are compared on float32 activations
(the forward, the segment chain from unit 1, prefill and decode through
``embed_inputs``) they agree to 1e-4: summation order only.  With bf16
activations, as the serving paths run from token ids, both packages round
each product to 8 bits of mantissa in other orders, and the port's
attention follows the TPU kernels (q scaled and P·V in float32) where the
reference's model path scales q and casts P to bf16 first; there the
checks are the port's own (split == monolith, prefill + decode == full
forward at the reference's gates), the embedding-input path at bf16 level
(|Δ| ≤ 5 % of the logit scale, mean ≤ 0.5 %, as tests/test_torch_model.py's
chain test) and the WaveBatcher's tokens up to near-ties.  Discrete outputs
(the init tree, model graphs, MoE routing in tests/test_torch_moe.py) are
equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_bundle as jax_get_bundle
from repro.models import transformer as jax_transformer
from repro.models import transformer_serve as jax_serve
from repro.serving import Request as JaxRequest
from repro.serving import SegmentChain as JaxSegmentChain
from repro.serving import WaveBatcher as JaxWaveBatcher
from repro_torch.configs import get_bundle
from repro_torch.core.graph import ModelGraph
from repro_torch.models import transformer, transformer_serve
from repro_torch.models.api import SHAPES, bundle_for
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import Request, SegmentChain, SegmentRunner, WaveBatcher

NEW_ARCHS = ("qwen3-moe-30b-a3b", "deepseek-v2-lite-16b", "gemma2-9b",
             "stablelm-3b", "deepseek-coder-33b", "musicgen-medium",
             "command-r-plus-104b", "internvl2-1b")
# two boundary sets per arch over its L + 2 units; deepseek-v2-lite's first
# set cuts right after its dense lead block (unit 1), the second inside the
# stacked blocks
BOUNDS = {
    "deepseek-v2-lite-16b": [(0, 1, 2, 5), (0, 3, 4, 5)],
    "gemma2-9b": [(0, 2, 4, 6), (0, 1, 3, 5, 6)],
}


def _bounds(arch, L):
    return BOUNDS.get(arch, [(0, 2, L + 2), (0, 1, 2, L + 2)])


def _both(arch, seed=0):
    jb = jax_get_bundle(arch, reduced=True)
    jparams = jb.init(jax.random.PRNGKey(seed), jnp.float32)
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    tb = get_bundle(arch, reduced=True)
    return jb, jparams, np_tree, tb, params_from_jax(np_tree, tb.cfg, device="cpu")


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


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32), np.float32)


def _assert_bf16_close(out, ref, max_frac=0.05, mean_frac=0.005):
    scale = float(np.abs(ref).max())
    d = np.abs(_np(out) - _np(ref))
    assert float(d.max()) <= max_frac * scale, (float(d.max()), scale)
    assert float(d.mean()) <= mean_frac * scale, (float(d.mean()), scale)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_init_tree_matches_reference(arch):
    """The port's own init: the reference's keys, shapes and scales; the MoE
    router stays float32 under a bf16 init, as in the reference."""
    jb = jax_get_bundle(arch, reduced=True)
    ref = dict(_leaves(jax.tree_util.tree_map(
        np.asarray, jb.init(jax.random.PRNGKey(0), jnp.float32))))
    tb = get_bundle(arch, reduced=True)
    mine = dict(_leaves(tb.init(torch.Generator().manual_seed(0), "cpu")))
    assert ref.keys() == mine.keys()
    for k in ref:
        assert tuple(mine[k].shape) == ref[k].shape, k
        sa, sb = float(ref[k].std()), float(mine[k].std())
        assert sb == pytest.approx(sa, rel=0.25, abs=1e-6), k
    bf16 = dict(_leaves(tb.init(torch.Generator().manual_seed(0), "cpu",
                                torch.bfloat16)))
    for k, t in bf16.items():
        assert t.dtype == (torch.float32 if k.endswith("/router")
                           else torch.bfloat16), k


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_params_from_jax_round_trip(arch):
    """Every leaf, lead blocks and prefix projection included, crosses bit
    for bit."""
    _, _, np_tree, _, tparams = _both(arch)
    a, b = dict(_leaves(np_tree)), dict(_leaves(tparams))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(b[k].numpy(), a[k], err_msg=k)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_float32_matches_reference(arch):
    jb, jparams, _, tb, tparams = _both(arch)
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


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_segment_chain_matches_reference(arch, which):
    """The port's chain (each segment on its split_params view) against the
    reference's at the same boundaries.  The chains start at unit 1 on
    float32 embeddings, so both run float32 activations and agree to 1e-4;
    the whole bf16 chain from the token ids equals the port's own monolith
    (same ops in the same order)."""
    jb, jparams, _, tb, tparams = _both(arch)
    L = len(tb.model_graph()) - 2
    bounds = _bounds(arch, L)[which]
    toks = _tokens(tb.cfg.vocab, (2, 24), seed=1)
    x = jax_transformer.embed_tokens(jparams, jb.cfg, jnp.asarray(toks),
                                     compute_dtype=jnp.float32)
    from_1 = (1,) + tuple(u for u in bounds if u > 1)
    ref = np.asarray(JaxSegmentChain(jb, jparams, from_1)(x))
    out = SegmentChain(tb, tparams, from_1)(torch.from_numpy(np.array(x)))
    assert tuple(out.shape) == ref.shape == (2, 24, tb.cfg.vocab)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)
    split = SegmentChain(tb, tparams, bounds)(torch.as_tensor(toks))
    mono = SegmentRunner(tb, 0, L + 2)(tparams, torch.as_tensor(toks))
    assert torch.equal(mono, split)


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_model_graph_matches_reference(arch, reduced):
    jg = jax_get_bundle(arch, reduced=reduced).model_graph()
    tg = get_bundle(arch, reduced=reduced).model_graph()
    assert isinstance(tg, ModelGraph)
    assert [u.name for u in jg.nodes] == [u.name for u in tg.nodes]
    for field in ("flops", "weight_bytes", "act_out_bytes", "privacy"):
        np.testing.assert_array_equal(getattr(jg, field), getattr(tg, field))
    jc, tc = jax_get_bundle(arch, reduced).cfg, get_bundle(arch, reduced).cfg
    assert tc.params_per_block == jc.params_per_block
    assert tc.active_params_per_block == jc.active_params_per_block
    assert tc.num_params() == jc.num_params()


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_cache_and_input_specs_match_reference(arch):
    jb = jax_get_bundle(arch, reduced=True)
    tb = get_bundle(arch, reduced=True)
    want = dict(_leaves(jb.cache_spec(3, 40)))
    got = dict(_leaves(tb.cache_spec(3, 40)))
    assert want.keys() == got.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].dtype == torch.bfloat16
    for shape in SHAPES.values():
        js = dict(_leaves(jb.input_specs(shape)))
        ts = dict(_leaves(tb.input_specs(shape)))
        assert js.keys() == ts.keys()
        for k in js:
            assert tuple(ts[k].shape) == js[k].shape, (shape.name, k)


def _f32_serving(arch, seed=0):
    """Both packages' serving functions on float32 activations: the configs
    take embeddings (``embed_inputs``), made from the token ids in float32,
    and the caches are float32, so the comparison is the algorithm's."""
    jb, jparams, _, tb, tparams = _both(arch, seed)
    jcfg = dataclasses.replace(jb.cfg, embed_inputs=True)
    tcfg = dataclasses.replace(tb.cfg, embed_inputs=True)

    def embed(tok):
        return np.array(jax_transformer.embed_tokens(
            jparams, jb.cfg, jnp.asarray(tok), compute_dtype=jnp.float32))
    return jparams, jcfg, tparams, tcfg, embed


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_decode_teacher_forced_matches_reference(arch):
    """Prefill and 6 decode steps, both fed the reference's greedy tokens, in
    float32: last-position logits within 1e-4, every cache leaf within 5e-5
    of its largest magnitude (gemma2's keys reach ~17: the embeddings are
    scaled by sqrt(d))."""
    jparams, jcfg, tparams, tcfg, embed = _f32_serving(arch)
    toks = _tokens(tcfg.vocab, (2, 20), seed=4)
    x = embed(toks)
    jl, jc = jax_serve.prefill(jparams, jcfg, jnp.asarray(x),
                               cache_dtype=jnp.float32, max_len=32)
    tl, tc = transformer_serve.prefill(tparams, tcfg, torch.from_numpy(x),
                                       cache_dtype=torch.float32, max_len=32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    for step in range(6):
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        e = embed(tok[:, None])[:, 0]
        pos = 20 + step
        jl, jc = jax_serve.decode_step(jparams, jcfg, jc, jnp.asarray(e),
                                       jnp.asarray(pos, jnp.int32))
        tl, tc2 = transformer_serve.decode_step(tparams, tcfg, tc,
                                                torch.from_numpy(e), pos)
        assert tc2 is tc
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    got = dict(_leaves(tc))
    for name, want in _leaves(jc):
        want = np.asarray(want)
        assert got[name].dtype == torch.float32
        np.testing.assert_allclose(got[name].numpy(), want, rtol=0,
                                   atol=5e-5 * np.abs(want).max(), err_msg=name)
        assert not got[name][:, :, 26:].any()


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_decode_matches_full_forward_in_port(arch):
    """The reference's tests/test_serving.py::
    test_prefill_decode_matches_full_forward in the port, with its setup and
    gate: B=2, S=33 (a modality prefix included), MoE capacity factor 64 so
    that routing is the same in both paths, bf16; rel < 5e-2 for MLA (the
    absorbed decode reassociates the products) and soft-capped attention,
    2e-2 otherwise."""
    jb = jax_get_bundle(arch, reduced=True)
    tb = get_bundle(arch, reduced=True)
    cfg = tb.cfg
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=64.0))
        tb = bundle_for(arch, cfg)
    tparams = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jb.init(jax.random.PRNGKey(7), jnp.float32)), cfg, device="cpu")
    B, S, prefix = 2, 33, cfg.prefix_tokens
    toks = torch.as_tensor(_tokens(cfg.vocab, (B, S - prefix), seed=7))
    full_b, pre_b = {"tokens": toks}, {"tokens": toks[:, :-1]}
    if prefix:
        pe = torch.from_numpy(np.random.default_rng(7).standard_normal(
            (B, prefix, cfg.prefix_dim)).astype(np.float32)).bfloat16()
        full_b["prefix_embeds"] = pre_b["prefix_embeds"] = pe
    full, _ = tb.prefill(tparams, full_b)
    _, cache = tb.prefill(tparams, pre_b, max_len=S)
    dec, _ = tb.decode(tparams, cache, toks[:, -1], S - 1)
    a, d = full.numpy(), dec.numpy()
    tol = 5e-2 if cfg.mla is not None or cfg.attn_softcap else 2e-2
    assert np.max(np.abs(a - d)) / np.max(np.abs(a)) < tol


def test_prefill_with_modality_prefix_matches_reference():
    """internvl2: 8 projected patch embeddings ahead of 12 text positions,
    float32, through both packages' serving prefill and one decode step."""
    jparams, jcfg, tparams, tcfg, embed = _f32_serving("internvl2-1b")
    toks = _tokens(tcfg.vocab, (2, 12), seed=5)
    pe = np.random.default_rng(6).standard_normal(
        (2, tcfg.prefix_tokens, tcfg.prefix_dim)).astype(np.float32)
    x = embed(toks)
    jl, jc = jax_serve.prefill(jparams, jcfg, jnp.asarray(x),
                               prefix_embeds=jnp.asarray(pe),
                               cache_dtype=jnp.float32, max_len=24)
    tl, tc = transformer_serve.prefill(tparams, tcfg, torch.from_numpy(x),
                                       prefix_embeds=torch.from_numpy(pe),
                                       cache_dtype=torch.float32, max_len=24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    k = tc["blocks"]["k"].numpy()
    assert np.abs(k[:, :, :20]).max(axis=(0, 1, 3, 4)).min() > 0
    assert not k[:, :, 20:].any()
    want = np.asarray(jc["blocks"]["k"])
    np.testing.assert_allclose(k, want, atol=5e-5 * np.abs(want).max(), rtol=0)
    e = embed(np.asarray(jnp.argmax(jl, -1), np.int32)[:, None])[:, 0]
    jl, _ = jax_serve.decode_step(jparams, jcfg, jc, jnp.asarray(e),
                                  jnp.asarray(20, jnp.int32))
    tl, _ = transformer_serve.decode_step(tparams, tcfg, tc, torch.from_numpy(e), 20)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)


def test_embedding_inputs_serve_like_the_reference():
    """A config with ``embed_inputs``: prefill and decode take bf16
    embeddings [B,S,d] in place of token ids, as in the reference."""
    arch = "llama3-8b"
    jb, jparams, _, tb, tparams = _both(arch)
    jcfg = dataclasses.replace(jb.cfg, embed_inputs=True)
    tcfg = dataclasses.replace(tb.cfg, embed_inputs=True)
    x = np.random.default_rng(8).standard_normal((2, 10, tcfg.d_model)).astype(
        np.float32)
    jl, jc = jax_serve.prefill(jparams, jcfg, jnp.asarray(x, jnp.bfloat16),
                               max_len=12)
    tl, tc = transformer_serve.prefill(tparams, tcfg,
                                       torch.from_numpy(x).bfloat16(), max_len=12)
    _assert_bf16_close(tl, jl)
    step = x[:, 0]
    jl, _ = jax_serve.decode_step(jparams, jcfg, jc, jnp.asarray(step, jnp.bfloat16),
                                  jnp.asarray(10, jnp.int32))
    tl, _ = transformer_serve.decode_step(tparams, tcfg, tc,
                                          torch.from_numpy(step).bfloat16(), 10)
    _assert_bf16_close(tl, jl)


MARGIN_TOL = 0.10   # as tests/test_torch_decode.py: two bf16-close logits
                    # can swap order only when their gap is under 10 %


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_wave_batcher_matches_reference(arch):
    """7 requests over 3 slots: equal stats, and equal tokens except where
    the reference's own top-2 margin at that step is under MARGIN_TOL."""
    jb, jparams, _, tb, tparams = _both(arch, seed=7)
    jwb = JaxWaveBatcher(jb, jparams, max_batch=3, max_len=40)
    calls = []

    def recorded(fn, kind):
        def run(*args):
            logits, cache = fn(*args)
            calls.append((kind, np.asarray(logits, np.float32)))
            return logits, cache
        return run

    jwb._prefill = recorded(jwb._prefill, "prefill")
    jwb._decode = recorded(jwb._decode, "decode")
    twb = WaveBatcher(tb, tparams, max_batch=3, max_len=40)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tb.cfg.vocab, 7 + i, dtype=np.int32) for i in range(7)]
    jreqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    treqs = [Request(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    for jr, tr in zip(jreqs, treqs):
        jwb.submit(jr)
        twb.submit(tr)
    assert vars(twb.run()) == vars(jwb.run())
    waves = []
    for kind, logits in calls:
        if kind == "prefill":
            waves.append([])
        waves[-1].append(logits)
    for r_i, (jr, tr) in enumerate(zip(jreqs, treqs)):
        assert tr.done and len(tr.output) == len(jr.output) == 4
        w, row = divmod(r_i, 3)
        for step, (a, b) in enumerate(zip(jr.output, tr.output)):
            if a == b:
                continue
            top = np.sort(waves[w][step][row])
            assert top[-1] - top[-2] < MARGIN_TOL * np.abs(top).max(), (r_i, step)
            break
