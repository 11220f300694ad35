"""Training in the port against the reference, on the CPU.

K1's gradient (the plain version's autograd and ``flash_attention_bwd_plain``,
the formula the backward kernel computes) against ``jax.grad`` of the
reference's ``chunked_attention``; the chunked cross-entropy; ``bundle.loss``
and every gradient leaf of four reduced transformers; AdamW; int8
error-feedback compression; whole train steps; a loss that falls.

Weights come from the reference's ``init`` through ``params_from_jax`` and
batches from ``SyntheticTokens``.  The reference side is
``jax.value_and_grad(bundle.loss)`` -> ``compress_grads_int8`` ->
``adamw_update``, called outside any mesh (inside ``make_small_mesh(1, 1)``
this jax raises in ``with_sharding_constraint``).  The port trains with
float32 activations (bf16 training waits for a bf16 backward of K1); the
reference's loss embeds tokens in bf16, so on its side the tests set its
``embed_tokens``'s compute dtype to float32 (``_f32_reference``) and compare
like with like.

Tolerances: attention gradients 1e-5 (float32, summation order only); the
loss 1e-5 relative and each gradient leaf 1e-4 of its largest magnitude
(float32 sums over the whole model in other orders), 2e-4 for gemma2 (its
reduced model is ill-conditioned in float32: either package's float32
gradients lie 2e-4 to 6e-4 of the leaf maximum from a float64 evaluation of
the same loss, and the two packages differ by up to 1.14e-4, on
``ln1_post.scale``); AdamW 1e-6; compression bit for bit (the reference's
eager quantizer divides by 127 as the port's does); three train steps 1e-5
on the params at lr 1e-4.  Adam's step is lr m / sqrt(v): an element whose
gradient is tiny next to its leaf's maximum carries a large relative error
into the ratio, so two float32 orders of summation can differ there by a
fair part of lr (2-3e-5 at lr 1e-3, on a handful of elements); at lr 1e-4
that stays under 1e-5, while a wrong update (of the order of lr) would not.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_bundle as jax_get_bundle
from repro.models import api as jax_api
from repro.models import griffin as jax_griffin
from repro.models import mamba2 as jax_mamba2
from repro.models import transformer as jax_transformer
from repro.models.attention import chunked_attention as jax_chunked_attention
from repro.training import AdamWConfig as JaxAdamWConfig
from repro.training import adamw_init as jax_adamw_init
from repro.training import adamw_update as jax_adamw_update
from repro.training import compress_grads_int8 as jax_compress
from repro_torch.configs import get_bundle
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.kernels import flash_attention as k1
from repro_torch.models import api
from repro_torch.models.common import (
    count_params,
    tree_flatten,
    tree_map,
    tree_unflatten,
)
from repro_torch.models.convert import params_from_jax
from repro_torch.training import (
    AdamWConfig,
    TrainStepConfig,
    adamw_init,
    adamw_update,
    compress_grads_int8,
    make_train_step,
)

ARCHS = ("llama3-8b", "gemma2-9b", "qwen3-moe-30b-a3b", "internvl2-1b",
         "deepseek-v2-lite-16b")
GRAD_TOL = {"gemma2-9b": 2e-4}           # of each leaf's max; 1e-4 elsewhere


@pytest.fixture
def _f32_reference(monkeypatch):
    """The reference's bundle.loss with float32 activations (every family's
    ``embed_tokens``)."""
    for mod in (jax_transformer, jax_mamba2, jax_griffin):
        monkeypatch.setattr(mod, "embed_tokens", functools.partial(
            mod.embed_tokens, compute_dtype=jnp.float32))


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _leaves(tree):
    return [_np(x) for x in tree_flatten(tree)[0]]


def _jax_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _batch(cfg, b=2, s=24, seed=0):
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, batch=b, seq_len=s, seed=seed))
    batch = data.batch_at(0)
    if cfg.prefix_tokens:
        p = cfg.prefix_tokens
        rng = np.random.default_rng(seed + 1)
        batch = {"tokens": batch["tokens"][:, : s - p].copy(),
                 "labels": batch["labels"],
                 "prefix_embeds": rng.standard_normal(
                     (b, p, cfg.prefix_dim), dtype=np.float32)}
    return batch


def _both(arch, seed=0):
    jb = jax_get_bundle(arch, reduced=True)
    jparams = jb.init(jax.random.PRNGKey(seed), jnp.float32)
    tb = get_bundle(arch, reduced=True)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tb.cfg, device="cpu")
    return jb, jparams, tb, tparams


# --------------------------------------------------------------------------- #
# K1's gradient
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("b,s,h,kv,hd,hd_v,causal,window,cap,scale", [
    (2, 40, 4, 2, 16, 16, True, 0, 0.0, None),      # causal GQA
    (1, 37, 6, 2, 8, 8, True, 7, 0.0, None),        # window, ragged, hd 8
    (2, 33, 4, 2, 32, 32, True, 16, 50.0, 16.0 ** -0.5),  # gemma2: cap, window, scale
    (1, 29, 7, 1, 8, 8, True, 0, 0.0, None),        # MQA at G = 7 (internvl2)
    (2, 24, 4, 4, 16, 16, False, 0, 30.0, None),    # non-causal, soft-cap
    (1, 45, 8, 1, 256, 256, True, 20, 0.0, None),   # Griffin: hd 256 MQA, window
    (2, 38, 4, 2, 256, 256, True, 16, 50.0, 224.0 ** -0.5),  # gemma2-9b's hd 256
    (2, 35, 4, 4, 192, 128, True, 0, 0.0, 192 ** -0.5),  # MLA at full width
    (2, 31, 4, 4, 24, 16, True, 0, 0.0, 24 ** -0.5),     # MLA reduced
])
def test_attention_grads_match_reference(b, s, h, kv, hd, hd_v, causal, window,
                                         cap, scale):
    rng = np.random.default_rng(s)
    q = rng.standard_normal((b, s, h, hd), dtype=np.float32)
    k = rng.standard_normal((b, s, kv, hd), dtype=np.float32)
    v = rng.standard_normal((b, s, kv, hd_v), dtype=np.float32)
    do = rng.standard_normal((b, s, h, hd_v), dtype=np.float32)

    def ref(q, k, v):
        o = jax_chunked_attention(q, k, v, causal=causal, window=window,
                                  logit_cap=cap, scale=scale)
        return jnp.sum(o * do)

    want = jax.grad(ref, argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o = k1.flash_attention(qt, kt, vt, causal=causal, window=window,
                           logit_cap=cap, scale=scale)
    got = torch.autograd.grad(o, (qt, kt, vt), torch.tensor(do))
    o2, lse = k1.flash_attention_lse(*(torch.tensor(x) for x in (q, k, v)),
                                     causal=causal, window=window,
                                     logit_cap=cap, scale=scale)
    plain = k1.flash_attention_bwd_plain(
        *(torch.tensor(x) for x in (q, k, v)), o2, lse, torch.tensor(do),
        causal=causal, window=window, logit_cap=cap, scale=scale)
    for name, w, g, p in zip("qkv", want, got, plain):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-5, rtol=1e-5,
                                   err_msg=f"d{name} (autograd)")
        np.testing.assert_allclose(_np(p), np.asarray(w), atol=1e-5, rtol=1e-5,
                                   err_msg=f"d{name} (bwd_plain)")


def test_lse_is_the_forward_log_normaliser():
    rng = np.random.default_rng(3)
    q, k, v = (torch.tensor(rng.standard_normal((2, 21, 4, 16), dtype=np.float32))
               for _ in range(3))
    o, lse = k1.flash_attention_lse(q, k, v, window=5, logit_cap=20.0)
    assert torch.equal(o, k1.flash_attention(q, k, v, window=5, logit_cap=20.0))
    sim, _, _ = k1._scores_plain(q, k, True, 5, 20.0, None)
    assert lse.shape == (2, 4, 21)
    np.testing.assert_allclose(_np(torch.softmax(sim, -1).sum(-1)), 1.0, rtol=1e-6)
    p = torch.exp(sim - lse[..., None])
    np.testing.assert_allclose(_np(p.sum(-1)), 1.0, rtol=1e-5)


# --------------------------------------------------------------------------- #
# losses
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("s,chunk,cap", [(37, 16, 0.0), (37, 16, 30.0),
                                         (24, 512, 0.0), (40, 8, 5.0)])
def test_chunked_xent_value_and_grads_match_reference(s, chunk, cap):
    rng = np.random.default_rng(s + chunk)
    b, d, vocab = 2, 16, 50
    h = rng.standard_normal((b, s, d), dtype=np.float32)
    w = rng.standard_normal((d, vocab), dtype=np.float32) * 0.5
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels[0, :5] = -1
    labels[1, -3:] = -1

    ref = jax.value_and_grad(
        lambda h, w: jax_api.chunked_softmax_xent(h, w, labels, chunk=chunk,
                                                  final_softcap=cap),
        argnums=(0, 1))
    (want, (wh, ww)) = ref(h, w)
    ht, wt = torch.tensor(h, requires_grad=True), torch.tensor(w, requires_grad=True)
    got = api.chunked_softmax_xent(ht, wt, torch.tensor(labels), chunk=chunk,
                                   final_softcap=cap)
    gh, gw = torch.autograd.grad(got, (ht, wt))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(_np(gh), np.asarray(wh), atol=1e-6)
    np.testing.assert_allclose(_np(gw), np.asarray(ww), atol=1e-6)

    logits = h @ w
    if cap:
        logits = cap * np.tanh(logits / cap)
    np.testing.assert_allclose(
        float(api.softmax_xent(torch.tensor(logits), torch.tensor(labels))),
        float(jax_api.softmax_xent(jnp.asarray(logits), labels)), rtol=1e-6)


# --------------------------------------------------------------------------- #
# bundle.loss and its gradients
# --------------------------------------------------------------------------- #
@pytest.mark.usefixtures("_f32_reference")
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_grad_leaf_match_reference(arch):
    jb, jparams, tb, tparams = _both(arch)
    batch = _batch(tb.cfg)
    jloss, jgrads = jax.value_and_grad(jb.loss)(
        jparams, jax.tree_util.tree_map(jnp.asarray, batch))

    leaves, structure = tree_flatten(tparams)
    ws = [p.clone().requires_grad_(True) for p in leaves]
    loss = tb.loss(tree_unflatten(structure, ws),
                   {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, ws, allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = _jax_leaves(jgrads)
    assert len(want) == len(grads)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert g.shape == w.shape, i
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(_np(g) - w).max())
        assert err <= GRAD_TOL.get(arch, 1e-4) * scale, (arch, i, err, scale)


def test_bundle_specs_and_counts():
    for arch in ARCHS:
        jb, tb = jax_get_bundle(arch, reduced=True), get_bundle(arch, reduced=True)
        specs = tb.param_specs()
        jspecs = jb.param_specs()
        assert [tuple(x.shape) for x in tree_flatten(specs)[0]] == \
            [tuple(x.shape) for x in jax.tree_util.tree_leaves(jspecs)]
        assert all(x.device.type == "meta" for x in tree_flatten(specs)[0])
        assert count_params(specs) == sum(
            int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jspecs))
        assert tb.num_active_params() == jb.num_active_params()
    # every family has a training loss (Mamba-2 and Griffin through K4's
    # and K5's backward kernels)
    for arch in ("mamba2-1.3b", "recurrentgemma-9b"):
        assert get_bundle(arch, reduced=True).loss is not None


# --------------------------------------------------------------------------- #
# AdamW and compression
# --------------------------------------------------------------------------- #
def test_adamw_single_step_math():
    cfg = AdamWConfig(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0,
                      grad_clip=0.0, warmup_steps=0, total_steps=10**9)
    params = {"w": torch.ones((2, 2))}
    grads = {"w": torch.full((2, 2), 0.5)}
    state = adamw_init(params)
    new_p, new_s, _ = adamw_update(cfg, params, grads, state)
    np.testing.assert_allclose(_np(new_p["w"]), 1.0 - 0.1, rtol=1e-5)
    assert int(new_s["step"]) == 1


@pytest.mark.parametrize("clip,wd", [(1.0, 0.1), (0.0, 0.1), (0.5, 0.0)])
def test_adamw_random_tree_matches_reference(clip, wd):
    rng = np.random.default_rng(7)
    tree = {"a": rng.standard_normal((3, 5, 4), dtype=np.float32),
            "b": {"s": rng.standard_normal((6,), dtype=np.float32),
                  "w": rng.standard_normal((4, 7), dtype=np.float32)},
            "lst": [rng.standard_normal((2, 3), dtype=np.float32)]}
    kw = dict(lr=3e-2, b1=0.9, b2=0.95, eps=1e-8, weight_decay=wd,
              grad_clip=clip, warmup_steps=2, total_steps=6)
    jcfg, tcfg = JaxAdamWConfig(**kw), AdamWConfig(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jax_adamw_init(jp)
    tp = tree_map(lambda x: torch.tensor(x), tree)
    tstate = adamw_init(tp)
    for step in range(4):
        g = jax.tree_util.tree_map(
            lambda x: rng.standard_normal(x.shape, dtype=np.float32) * 3, tree)
        jp, jstate, jm = jax_adamw_update(jcfg, jp, jax.tree_util.tree_map(
            jnp.asarray, g), jstate)
        tp, tstate, tm = adamw_update(tcfg, tp, tree_map(torch.tensor, g), tstate)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-6)
        for a, b in zip(_leaves(tp), _jax_leaves(jp)):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)
        for a, b in zip(_leaves(tstate["mu"]) + _leaves(tstate["nu"]),
                        _jax_leaves(jstate["mu"]) + _jax_leaves(jstate["nu"])):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1


def test_compress_grads_bit_identical_and_conserving():
    rng = np.random.default_rng(0)
    grads = {"w": rng.standard_normal((8, 16), dtype=np.float32),
             "s": rng.standard_normal((33,), dtype=np.float32) * 1e-3,
             "big": rng.standard_normal((2, 3, 300), dtype=np.float32) * 50,
             "z": np.zeros((4, 4), np.float32)}
    residual = jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape, dtype=np.float32) * 1e-2, grads)
    jdeq, jres = jax_compress(jax.tree_util.tree_map(jnp.asarray, grads),
                              jax.tree_util.tree_map(jnp.asarray, residual))
    tres = tree_map(torch.tensor, residual)
    tdeq, tres2 = compress_grads_int8(tree_map(torch.tensor, grads), tres)
    assert tres2 is tres                       # the residual is updated in place
    for a, b in zip(_leaves(tdeq) + _leaves(tres2),
                    _jax_leaves(jdeq) + _jax_leaves(jres)):
        np.testing.assert_array_equal(a, b)
    # error feedback conserves mass: decompressed + residual == g + r
    for key in grads:
        np.testing.assert_allclose(_np(tdeq[key]) + _np(tres2[key]),
                                   grads[key] + residual[key], atol=1e-5, rtol=1e-6)


# --------------------------------------------------------------------------- #
# whole steps
# --------------------------------------------------------------------------- #
def _port_grads(tb, params, batch):
    leaves, structure = tree_flatten(params)
    ws = [p.detach().clone().requires_grad_(True) for p in leaves]
    loss = tb.loss(tree_unflatten(structure, ws),
                   {k: torch.as_tensor(v) for k, v in batch.items()})
    return torch.autograd.grad(loss, ws), structure


@pytest.mark.usefixtures("_f32_reference")
@pytest.mark.parametrize("compression", [False, True])
def test_three_train_steps_match_reference(compression):
    """Three steps of ``make_train_step`` against the reference's chain.

    Without compression the params agree to 1e-5.  With it, an int8 code
    can round the other way where the two packages' g + r differ in the
    last float32 bits at a rounding tie (one element of 16,384 in one leaf
    here), and that element's Adam step changes by up to lr: so at most one
    element in 10^4 may exceed 1e-5, none may exceed 3 lr, and the port's
    step must also equal the reference's ``compress_grads_int8`` and
    ``adamw_update`` applied to the port's own gradients to 1e-6.
    """
    arch = "llama3-8b"
    jb, jparams, tb, tparams = _both(arch)
    kw = dict(lr=1e-4, warmup_steps=2, total_steps=20)
    jcfg = JaxAdamWConfig(**kw)
    step_fn, init_state = make_train_step(
        tb, TrainStepConfig(opt=AdamWConfig(**kw), grad_compression=compression),
        "cpu")
    state = init_state(params=tparams)

    def jax_state(params):
        s = {"params": params, "opt": jax_adamw_init(params)}
        if compression:
            s["residual"] = jax.tree_util.tree_map(jnp.zeros_like, params)
        return s

    def jax_step(s, grads):
        if compression:
            grads, s["residual"] = jax_compress(grads, s["residual"])
        s["params"], s["opt"], m = jax_adamw_update(jcfg, s["params"], grads,
                                                    s["opt"])
        return m

    jstate = jax_state(jparams)
    chain = jax_state(jparams)       # the reference's chain on the port's grads
    vg = jax.jit(jax.value_and_grad(jb.loss))
    data = SyntheticTokens(DataConfig(vocab=tb.cfg.vocab, batch=2, seq_len=32))
    for step in range(3):
        batch = data.batch_at(step)
        jloss, jg = vg(jstate["params"], jax.tree_util.tree_map(jnp.asarray, batch))
        jm = jax_step(jstate, jg)
        pg, structure = _port_grads(tb, state["params"], batch)
        jax_step(chain, jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jparams), [jnp.asarray(_np(g)) for g in pg]))
        state, m = step_fn(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-4)
    got = _leaves(state["params"])
    for a, b in zip(got, _jax_leaves(chain["params"])):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)
    over, total = 0, 0
    for a, b in zip(got, _jax_leaves(jstate["params"])):
        if not compression:
            np.testing.assert_allclose(a, b, atol=1e-5)
        err = np.abs(a - b)
        assert err.max() <= 3 * kw["lr"]
        over += int((err > 1e-5).sum())
        total += err.size
    assert over <= total * 1e-4, (over, total)


def test_loss_decreases_small_model():
    """The counterpart of the reference's test of the same name."""
    bundle = get_bundle("llama3-8b", reduced=True)
    cfg = TrainStepConfig(opt=AdamWConfig(lr=1e-2, warmup_steps=5,
                                          total_steps=80))
    step_fn, init_state = make_train_step(bundle, cfg, "cpu")
    data = SyntheticTokens(DataConfig(vocab=bundle.cfg.vocab, batch=4,
                                      seq_len=64))
    state = init_state(0)
    losses = []
    for _ in range(80):
        state, m = step_fn(state, next(data))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.25


def test_training_needs_a_loss_and_a_device():
    lossless = dataclasses.replace(get_bundle("recurrentgemma-9b", reduced=True),
                                   loss=None)
    with pytest.raises(ValueError, match="no training loss"):
        make_train_step(lossless, TrainStepConfig(), "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_train_step(get_bundle("llama3-8b", reduced=True))


def test_moe_and_prefix_train_steps_run():
    """qwen3-moe (routing under autograd) and internvl2 (prefix) take steps
    with compression; every leaf stays finite and moves."""
    for arch in ("qwen3-moe-30b-a3b", "internvl2-1b"):
        _, _, tb, tparams = _both(arch)
        before = [x.clone() for x in tree_flatten(tparams)[0]]
        step_fn, init_state = make_train_step(
            tb, TrainStepConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=0),
                                grad_compression=True), "cpu")
        state = init_state(params=tparams)
        for step in range(2):
            state, m = step_fn(state, _batch(tb.cfg, seed=step))
            assert np.isfinite(float(m["loss"]))
        moved = [not torch.equal(a, b) for a, b in
                 zip(before, tree_flatten(state["params"])[0])]
        assert all(torch.isfinite(x).all() for x in tree_flatten(state["params"])[0])
        assert sum(moved) >= len(moved) - 1, (arch, moved)
