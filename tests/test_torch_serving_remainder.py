"""The port's serving and placement remainder against the reference, on the CPU.

``run_chain`` (``SegmentChain(slice_params=False)``) against the
reference's ``run_chain`` with float32 activations on both sides, 1e-4 (the
tolerance of tests/test_serving.py's split == monolith); the two binding
modes bit for bit; the transport hook's accounting; ``greedy_placement``'s
solution identical and its cost within 1e-12 (relative) on seeded
instances; the ``models`` exports.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jax_models
from repro.configs import get_bundle as jax_get_bundle
from repro.core import greedy_placement as jax_greedy
from repro.core import local_search as jax_local_search
from repro.models import mamba2 as jax_mamba2
from repro.models import transformer as jax_transformer
from repro.serving import ActivationTransport as JaxTransport
from repro.serving import run_chain as jax_run_chain
import repro_torch.models as port_models
from repro_torch.configs import get_bundle
from repro_torch.core import evaluate, greedy_placement, local_search
from repro_torch.models import mamba2 as port_mamba2
from repro_torch.models import transformer as port_transformer
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import ActivationTransport, SegmentChain, run_chain

from test_core_solvers import _random_instance
from test_torch_control import SEEDS, _port

CHAIN_TOL = 1e-4


def _both(arch, seed=0):
    jb = jax_get_bundle(arch, reduced=True)
    jparams = jb.init(jax.random.PRNGKey(seed), jnp.float32)
    tb = get_bundle(arch, reduced=True)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tb.cfg, device="cpu")
    return jb, jparams, tb, tparams


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape, dtype=np.int32)


@pytest.fixture
def _f32_activations(monkeypatch):
    """Both packages' embeddings (hence every activation) in float32."""
    for mod, dt in ((jax_transformer, jnp.float32), (jax_mamba2, jnp.float32),
                    (port_transformer, torch.float32), (port_mamba2, torch.float32)):
        monkeypatch.setattr(mod, "embed_tokens", functools.partial(
            mod.embed_tokens, compute_dtype=dt))


def _bounds(n):
    """tests/test_serving.py's candidate splits of n units, deduplicated."""
    out = []
    for c in [(0, n), (0, 1, n), (0, n // 2, n), (0, 1, n - 1, n),
              (0, 2, 3, n - 1, n)]:
        b = tuple(sorted(set(c)))
        if b not in out:
            out.append(b)
    return out


@pytest.mark.usefixtures("_f32_activations")
@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-1.3b"])
def test_run_chain_matches_reference(arch):
    jb, jparams, tb, tparams = _both(arch)
    n = len(tb.model_graph())
    toks = _tokens(tb.cfg.vocab, (2, 24))
    mono = run_chain(tb, tparams, (0, n), torch.as_tensor(toks))
    for bounds in _bounds(n):
        ref = np.asarray(jax_run_chain(jb, jparams, bounds, jnp.asarray(toks)))
        out = run_chain(tb, tparams, bounds, torch.as_tensor(toks))
        assert out.shape == ref.shape == (2, 24, tb.cfg.vocab)
        np.testing.assert_allclose(out.numpy(), ref, atol=CHAIN_TOL, rtol=0)
        assert float((out - mono).abs().max()) < CHAIN_TOL, bounds


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-1.3b",
                                  "recurrentgemma-9b", "deepseek-v2-lite-16b"])
def test_full_tree_binding_equals_sliced_bit_for_bit(arch):
    """``slice_params=False`` (the full tree, global indexing) and the
    default sliced views run the same ops in the same order."""
    _, _, tb, tparams = _both(arch, seed=1)
    n = len(tb.model_graph())
    toks = torch.as_tensor(_tokens(tb.cfg.vocab, (2, 16), seed=1))
    for bounds in _bounds(n):
        full = SegmentChain(tb, tparams, bounds, slice_params=False)
        assert all(seg.params is tparams for seg in full.segments)
        sliced = SegmentChain(tb, tparams, bounds)(toks)
        assert torch.equal(full(toks), sliced), bounds
        assert torch.equal(run_chain(tb, tparams, bounds, toks), sliced), bounds


def test_run_chain_transfer_hook_matches_reference():
    """tests/test_serving.py's accounting case on both packages: the same
    transfers and bytes; compression costs bounded accuracy at the logits
    (the reference's 0.35 relative), and the port's compressed chain lies
    within 10 % of the logit scale of the reference's (a bf16 activation
    one ulp apart can round to the neighbouring int8 step;
    tests/test_torch_model.py)."""
    jb, jparams, tb, tparams = _both("llama3-8b")
    n = len(tb.model_graph())
    toks = _tokens(tb.cfg.vocab, (2, 16), seed=2)
    jt = JaxTransport(compress=True)
    ref_c = np.asarray(jax_run_chain(jb, jparams, (0, 2, n), jnp.asarray(toks),
                                     transfer_hook=jt))
    raw, comp = ActivationTransport(compress=False), ActivationTransport(compress=True)
    t = torch.as_tensor(toks)
    run_chain(tb, tparams, (0, 2, n), t, transfer_hook=raw)
    out_c = run_chain(tb, tparams, (0, 2, n), t, transfer_hook=comp)
    out_r = run_chain(tb, tparams, (0, 2, n), t)
    assert comp.stats.transfers == jt.stats.transfers == 1
    assert (comp.stats.raw_bytes, comp.stats.wire_bytes) == \
        (jt.stats.raw_bytes, jt.stats.wire_bytes)
    assert comp.stats.compression_ratio > 1.7
    assert raw.stats.compression_ratio == 1.0
    rel = float((out_c - out_r).abs().max() / out_r.abs().max())
    assert rel < 0.35
    scale = float(np.abs(ref_c).max())
    assert float(np.abs(out_c.numpy() - ref_c).max()) <= 0.10 * scale


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n_units,n_nodes,k", [(5, 3, 2), (8, 3, 3), (12, 6, 4)])
def test_greedy_placement_matches_reference(seed, n_units, n_nodes, k):
    """The same assignment (ties keep the first node, as the reference's
    strict ``<``) and the cost within 1e-12; (8, 3, 3) is
    tests/test_core_solvers.py's local-search seed, whose refinement from
    the greedy start must agree too."""
    g, state, wl = _random_instance(seed, n_units=n_units, n_nodes=n_nodes)
    bounds = g.even_split(k).boundaries
    ref = jax_greedy(g, bounds, state, wl)
    pg, ps, pw = _port(g, state, wl)
    mine = greedy_placement(pg, bounds, ps, pw)
    assert (mine.boundaries, mine.assignment) == (ref.boundaries, ref.assignment)
    assert abs(mine.cost - ref.cost) <= 1e-12 * max(1.0, abs(ref.cost))
    ref_ls = jax_local_search(g, ref, state, wl, max_rounds=10)
    mine_ls = local_search(pg, mine, ps, pw, max_rounds=10)
    assert (mine_ls.boundaries, mine_ls.assignment) == \
        (ref_ls.boundaries, ref_ls.assignment)
    assert mine_ls.cost <= mine.cost + 1e-12


def test_greedy_placement_ties_keep_the_first_node():
    """Two identical nodes, both trusted, one link rate: all on node 0 and
    all on node 1 cost the same, and the greedy keeps node 0, as the
    reference's does."""
    g, state, wl = _random_instance(3, n_units=6, n_nodes=2)
    for f in ("flops_per_s", "mem_bytes", "background_util", "mem_bw"):
        getattr(state, f)[1] = getattr(state, f)[0]
    state.trusted[:] = True
    state.link_bw[:] = 1e7
    np.fill_diagonal(state.link_bw, np.inf)
    bounds = g.even_split(2).boundaries
    ref = jax_greedy(g, bounds, state, wl)
    pg, ps, pw = _port(g, state, wl)
    mine = greedy_placement(pg, bounds, ps, pw)
    assert evaluate(pg, bounds, [1, 1], ps, pw) == evaluate(pg, bounds, [0, 0], ps, pw)
    assert mine.assignment == ref.assignment == (0, 0)


def test_models_exports_match_reference():
    assert set(jax_models.__all__) <= set(port_models.__all__)
    assert port_models.SHAPES.keys() == jax_models.SHAPES.keys()
    for name, spec in jax_models.SHAPES.items():
        mine = port_models.SHAPES[name]
        assert isinstance(mine, port_models.ShapeSpec)
        assert (mine.name, mine.seq_len, mine.global_batch, mine.kind) == \
            (spec.name, spec.seq_len, spec.global_batch, spec.kind)
    assert port_models.griffin.GriffinConfig and port_models.mamba2.Mamba2Config
