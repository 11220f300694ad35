"""The port's MoE layer against the reference's, on the CPU.

Routing is a discrete output: each token's experts, their slots inside the
experts' capacity and the dropped choices must be the reference's, bit for
bit, or a split, a replay or a comparison with the reference would route
tokens elsewhere.  The reference's routing is recomputed here from the lines
of its ``models/transformer.py::moe_ffn`` (it returns no routing), on the
same float32 inputs; the layer's output is held to the reference's
``moe_ffn`` at float32 (summation order only: the reference scatter-adds
the expert outputs, the port gathers each token's k outputs and sums them
in k order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import transformer as jax_transformer
from repro_torch.configs import get_reduced
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_jax

MOE_ARCHS = ("qwen3-moe-30b-a3b", "deepseek-v2-lite-16b")


def _ref_routing(xf, router, moe):
    """The reference moe_ffn's routing lines: (tope, slot per flat choice in
    expert-sorted order mapped back, idx [E, cap], wmat [E, cap], cap)."""
    t = xf.shape[0]
    logits = xf.astype(jnp.float32) @ router.astype(jnp.float32)
    gates = jax.nn.softmax(logits, axis=-1)
    topv, tope = jax.lax.top_k(gates, moe.top_k)
    if moe.router_scale:
        topv = topv / jnp.maximum(topv.sum(-1, keepdims=True), 1e-9)
    e_flat = tope.reshape(-1)
    tok_flat = jnp.repeat(jnp.arange(t), moe.top_k)
    cap = max(int(np.ceil(t * moe.top_k / moe.num_experts * moe.capacity_factor)), 4)
    order = jnp.argsort(e_flat, stable=True)
    e_sorted, tok_sorted, w_sorted = e_flat[order], tok_flat[order], topv.reshape(-1)[order]
    counts = jnp.bincount(e_flat, length=moe.num_experts)
    offsets = jnp.concatenate([jnp.zeros(1, counts.dtype), jnp.cumsum(counts)[:-1]])
    slot = jnp.arange(t * moe.top_k) - offsets[e_sorted]
    slot_c = jnp.minimum(slot, cap)
    idx = jnp.zeros((moe.num_experts, cap + 1), jnp.int32).at[e_sorted, slot_c].set(
        tok_sorted.astype(jnp.int32))
    wmat = jnp.zeros((moe.num_experts, cap + 1), jnp.float32).at[e_sorted, slot_c].set(
        w_sorted)
    slot_flat = np.empty(t * moe.top_k, np.int64)
    slot_flat[np.asarray(order)] = np.asarray(slot)
    return (np.asarray(tope), np.asarray(topv), slot_flat.reshape(t, moe.top_k),
            np.asarray(idx[:, :cap]), np.asarray(wmat[:, :cap]), cap)


def _layer(arch, seed=0, **moe_changes):
    """A reduced MoE block's moe params from the reference's init, both ways."""
    jcfg = jax_get_reduced(arch)
    if moe_changes:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe_changes))
    jparams = jax_transformer.init_params(jcfg, jax.random.PRNGKey(seed))
    jmoe = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]["moe"])
    tcfg = dataclasses.replace(get_reduced(arch), moe=transformer.MoEConfig(
        **dataclasses.asdict(jcfg.moe)))
    tmoe = params_from_jax(jax.tree_util.tree_map(np.asarray, jmoe), tcfg,
                           device="cpu")
    return jcfg, jmoe, tcfg, tmoe


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _assert_routing_equal(xf, jmoe, tmoe, jcfg, tcfg):
    want = _ref_routing(jnp.asarray(xf), jmoe["router"], jcfg.moe)
    got = transformer.moe_route(torch.from_numpy(xf), tmoe["router"], tcfg.moe)
    tope, topv, slot, idx, wmat, cap = want
    assert got.cap == cap
    np.testing.assert_array_equal(got.experts.numpy(), tope)
    np.testing.assert_array_equal(got.slot.numpy(), slot)
    np.testing.assert_array_equal(got.idx.numpy(), idx)
    np.testing.assert_allclose(got.weights.numpy(), topv, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.wmat.numpy(), wmat, rtol=1e-6, atol=1e-7)
    return got


@pytest.mark.parametrize("t", [1, 8, 48])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_routing_bit_identical(arch, t):
    jcfg, jmoe, tcfg, tmoe = _layer(arch)
    xf = _x((t, tcfg.d_model), seed=t)
    _assert_routing_equal(xf, jmoe, tmoe, jcfg, tcfg)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_routing_ties_go_to_the_lower_expert(arch):
    """Equal router columns give equal gates: jax.lax.top_k takes the lower
    expert id first, and so does the port."""
    jcfg, jmoe, tcfg, tmoe = _layer(arch)
    r = np.asarray(jmoe["router"]).copy()
    r[:, 5] = r[:, 2]
    r[:, 7] = r[:, 2]
    r[:, 3] = r[:, 1]
    jmoe = {**jmoe, "router": jnp.asarray(r)}
    tmoe = {**tmoe, "router": torch.from_numpy(r)}
    xf = _x((32, tcfg.d_model), seed=3)
    got = _assert_routing_equal(xf, jmoe, tmoe, jcfg, tcfg)
    e = got.experts.numpy()
    # wherever a tied pair is chosen together, the lower id comes first
    for lo_e, hi_e in ((2, 5), (2, 7), (5, 7), (1, 3)):
        both = (e == lo_e).any(1) & (e == hi_e).any(1)
        for row in np.nonzero(both)[0]:
            assert list(e[row]).index(lo_e) < list(e[row]).index(hi_e)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_routing_overflow_drops_like_the_reference(arch):
    """One expert's router column dominates: every token picks it first, its
    capacity overflows, and the same choices are dropped in both packages;
    the layer's output still agrees."""
    jcfg, jmoe, tcfg, tmoe = _layer(arch)
    r = np.asarray(jmoe["router"]).copy()
    xf = np.abs(_x((40, tcfg.d_model), seed=4))
    r[:, 6] = 10.0 / tcfg.d_model
    jmoe = {**jmoe, "router": jnp.asarray(r)}
    tmoe = {**tmoe, "router": torch.from_numpy(r)}
    got = _assert_routing_equal(xf, jmoe, tmoe, jcfg, tcfg)
    assert (got.experts[:, 0] == 6).all()
    # expert 6 keeps its first cap tokens (in token order) and drops the rest
    assert got.slot[:, 0].tolist() == list(range(40))
    assert int((got.slot[:, 0] >= got.cap).sum()) == 40 - got.cap
    want = jax_transformer.moe_ffn(jnp.asarray(xf)[None], jmoe, jcfg)
    out = transformer.moe_ffn(torch.from_numpy(xf)[None], tmoe, tcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("t", [1, 8, 48])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_reference(arch, t):
    """Experts, weights and (deepseek) the shared expert: float32, 1e-5."""
    jcfg, jmoe, tcfg, tmoe = _layer(arch, seed=1)
    x = _x((1, t, tcfg.d_model), seed=10 + t)
    want = jax_transformer.moe_ffn(jnp.asarray(x), jmoe, jcfg)
    out = transformer.moe_ffn(torch.from_numpy(x), tmoe, tcfg)
    assert out.shape == x.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_moe_ffn_capacity_floor_and_no_router_scale():
    """A one-token batch has capacity 4 (the floor); without router_scale the
    gate weights are the raw softmax values."""
    jcfg, jmoe, tcfg, tmoe = _layer("qwen3-moe-30b-a3b", router_scale=False)
    assert transformer.moe_capacity(1, tcfg.moe) == 4
    x = _x((1, 3, tcfg.d_model), seed=12)
    _assert_routing_equal(x[0], jmoe, tmoe, jcfg, tcfg)
    want = jax_transformer.moe_ffn(jnp.asarray(x), jmoe, jcfg)
    out = transformer.moe_ffn(torch.from_numpy(x), tmoe, tcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_moe_ffn_is_deterministic_in_bf16():
    """The combine gathers and sums in a fixed order: two calls on bf16
    inputs give the same bits (a float scatter-add would not promise it on
    the card)."""
    _, _, tcfg, tmoe = _layer("deepseek-v2-lite-16b", seed=2)
    bf = {k: (v.to(torch.bfloat16) if k != "router" else v) if
          isinstance(v, torch.Tensor) else
          {kk: vv.to(torch.bfloat16) for kk, vv in v.items()}
          for k, v in tmoe.items()}
    x = torch.from_numpy(_x((2, 16, tcfg.d_model), seed=13)).bfloat16()
    a = transformer.moe_ffn(x, bf, tcfg)
    b = transformer.moe_ffn(x, bf, tcfg)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
