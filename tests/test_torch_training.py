"""Training in the port against the reference, on the CPU.

K1's gradient (the plain version's autograd and ``flash_attention_bwd_plain``,
the formula the backward kernel computes) against ``jax.grad`` of the
reference's ``chunked_attention``, in float32 and in bf16; the chunked
cross-entropy; ``bundle.loss`` and every gradient leaf of five reduced
transformers; AdamW; int8 error-feedback compression; whole train steps; a
loss that falls.

Weights come from the reference's ``init`` through ``params_from_jax`` and
batches from ``SyntheticTokens``.  The reference side is
``jax.value_and_grad(bundle.loss)`` -> ``compress_grads_int8`` ->
``adamw_update``, called outside any mesh (inside ``make_small_mesh(1, 1)``
this jax raises in ``with_sharding_constraint``).  Both packages' losses
embed tokens in bf16 (each family's ``embed_tokens`` default), so attention
and the SSD see bf16 activations on both sides (pinned by spies on the
calls).  The bf16 tests compare the two packages as they train; the float32
tests set both packages' ``embed_tokens`` compute dtype to float32
(``_f32_reference`` and its port-side twin ``_f32_port``) and hold the
algorithm tightly.

Tolerances (float32): attention gradients 1e-5 (summation order only); the
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

Tolerances (bf16): attention gradients 2e-2 of the largest gradient (the
bf16 tolerance of tests/test_kernels.py; the reference scales q and rounds P
to bf16, the port's plain version computes in float32 from the bf16
inputs).  The two packages round in other places (q's scale, P, the
matmuls' outputs), and the reduced models are ill-conditioned in bf16 (the
reference init's attention scores saturate the softmax): the reference's own
bf16 gradients lie 7e-3 to 2.3 of a leaf's maximum from its float32 ones.
So each bf16 quantity X is held against the reference's bf16 value by

    |X_port - X_ref,bf16| <= BF16_C |X_ref,bf16 - X_ref,f32| + BF16_FLOOR |X_ref,bf16|

(per gradient leaf in max norms, relative to the leaf's largest magnitude;
per loss and grad norm as numbers), with BF16_C = 3 and BF16_FLOOR = 1e-3.
Measured over the seven reduced archs of this file and
tests/test_torch_recurrent_training.py: the largest ratio of the port's gap
to the reference's own gap on any leaf is 1.89 (recurrentgemma-9b; 1.52
deepseek-v2-lite, 1.31 mamba2-1.3b, 1.07 gemma2, under 0.9 elsewhere), and
the largest loss gap 6.9e-4 relative (deepseek-v2-lite, whose own gap is
1.1e-3); recurrentgemma-9b's loss gap 2.2e-4 where its own is 1.9e-6 needs
the floor.  Three bf16 train steps (lr 1e-4) hold each step's loss and
grad norm by the same rule, the reference's own gap the largest of the
three steps' (one step's may be small by chance: llama3-8b's grad norm
gaps are 0.27, 0.28 and 3.2e-3 of it, the port's third 5.4e-2), and each
leaf's params after them in units of
lr: the max gap within BF16_C times the reference's own plus
BF16_STEP_FLOOR = 1.5 (an element whose gradient sits near 0 may step
either way in either package: the largest gap the rule leaves unexplained
is 0.75 lr, on mamba2-1.3b), the mean gap within BF16_C times the
reference's own plus BF16_FLOOR (none needed); the port's step equals the
reference's compress + AdamW applied to the port's own gradients to 1e-6,
as in float32.
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
from repro.models import attention as jax_attention
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
from repro_torch.kernels import ops as kops
from repro_torch.models import api
from repro_torch.models import griffin as port_griffin
from repro_torch.models import mamba2 as port_mamba2
from repro_torch.models import transformer as port_transformer
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
BF16_C = 3.0                             # x the reference's own bf16-vs-f32 gap
BF16_FLOOR = 1e-3                        # + this, relative (module docstring)
BF16_STEP_FLOOR = 1.5                    # + this x lr on a leaf's max param gap


def _f32_activations(monkeypatch, mods, dtype):
    for mod in mods:
        monkeypatch.setattr(mod, "embed_tokens", functools.partial(
            mod.embed_tokens, compute_dtype=dtype))


@pytest.fixture
def _f32_reference(monkeypatch):
    """The reference's bundle.loss with float32 activations (every family's
    ``embed_tokens``)."""
    _f32_activations(monkeypatch, (jax_transformer, jax_mamba2, jax_griffin),
                     jnp.float32)


@pytest.fixture
def _f32_port(monkeypatch):
    """The port's bundle.loss with float32 activations: the twin of
    ``_f32_reference``."""
    _f32_activations(monkeypatch, (port_transformer, port_mamba2, port_griffin),
                     torch.float32)


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _leaves(tree):
    return [_np(x) for x in tree_flatten(tree)[0]]


def _jax_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _batch(cfg, b=2, s=24, seed=0):
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, batch=b, seq_len=s, seed=seed))
    batch = data.batch_at(0)
    if getattr(cfg, "prefix_tokens", 0):
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
ATTN_CASES = [
    (2, 40, 4, 2, 16, 16, True, 0, 0.0, None),      # causal GQA
    (1, 37, 6, 2, 8, 8, True, 7, 0.0, None),        # window, ragged, hd 8
    (2, 33, 4, 2, 32, 32, True, 16, 50.0, 16.0 ** -0.5),  # gemma2: cap, window, scale
    (1, 29, 7, 1, 8, 8, True, 0, 0.0, None),        # MQA at G = 7 (internvl2)
    (2, 24, 4, 4, 16, 16, False, 0, 30.0, None),    # non-causal, soft-cap
    (1, 45, 8, 1, 256, 256, True, 20, 0.0, None),   # Griffin: hd 256 MQA, window
    (2, 38, 4, 2, 256, 256, True, 16, 50.0, 224.0 ** -0.5),  # gemma2-9b's hd 256
    (2, 35, 4, 4, 192, 128, True, 0, 0.0, 192 ** -0.5),  # MLA at full width
    (2, 31, 4, 4, 24, 16, True, 0, 0.0, 24 ** -0.5),     # MLA reduced
]


@pytest.mark.parametrize("b,s,h,kv,hd,hd_v,causal,window,cap,scale,dtype", [
    pytest.param(*case, dtype, id="-".join(map(str, case)) + suffix)
    for dtype, suffix in (("float32", ""), ("bfloat16", "-bf16"))
    for case in ATTN_CASES])
def test_attention_grads_match_reference(b, s, h, kv, hd, hd_v, causal, window,
                                         cap, scale, dtype):
    """float32: ``jax.grad`` of the reference at 1e-5.  bf16: the same
    inputs rounded to bf16 through ``jax.vjp`` of the reference's bf16
    ``chunked_attention`` and the port's plain version (the CPU's K1), at 2e-2
    of each gradient's largest magnitude."""
    rng = np.random.default_rng(s)
    q = rng.standard_normal((b, s, h, hd), dtype=np.float32)
    k = rng.standard_normal((b, s, kv, hd), dtype=np.float32)
    v = rng.standard_normal((b, s, kv, hd_v), dtype=np.float32)
    do = rng.standard_normal((b, s, h, hd_v), dtype=np.float32)
    kw = dict(causal=causal, window=window, logit_cap=cap, scale=scale)

    if dtype == "float32":
        def ref(q, k, v):
            return jnp.sum(jax_chunked_attention(q, k, v, **kw) * do)

        want = jax.grad(ref, argnums=(0, 1, 2))(q, k, v)
        tdt = torch.float32
    else:
        _, vjp = jax.vjp(lambda q, k, v: jax_chunked_attention(q, k, v, **kw),
                         *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
        want = [x.astype(jnp.float32) for x in vjp(jnp.asarray(do, jnp.bfloat16))]
        tdt = torch.bfloat16
    ins = [torch.tensor(x).to(tdt) for x in (q, k, v)]
    dot = torch.tensor(do).to(tdt)
    qt, kt, vt = (x.clone().requires_grad_(True) for x in ins)
    o = k1.flash_attention(qt, kt, vt, **kw)
    got = torch.autograd.grad(o, (qt, kt, vt), dot)
    o2, lse = k1.flash_attention_lse(*ins, **kw)
    plain = k1.flash_attention_bwd_plain(*ins, o2, lse, dot, **kw)
    for name, w, g, p in zip("qkv", want, got, plain):
        assert g.dtype == p.dtype == tdt
        w = np.asarray(w)
        if dtype == "float32":
            np.testing.assert_allclose(_np(g), w, atol=1e-5, rtol=1e-5,
                                       err_msg=f"d{name} (autograd)")
            np.testing.assert_allclose(_np(p), w, atol=1e-5, rtol=1e-5,
                                       err_msg=f"d{name} (bwd_plain)")
        else:
            tol = 2e-2 * np.abs(w).max()
            for what, x in (("autograd", g), ("bwd_plain", p)):
                err = np.abs(_np(x.float()) - w).max()
                assert err <= tol, (f"d{name} ({what})", err, tol)


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
@pytest.mark.usefixtures("_f32_reference", "_f32_port")
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


def _bf16_bound(own, scale):
    """The bf16 tolerance of the module docstring: BF16_C times the
    reference's own bf16-vs-float32 gap ``own`` plus BF16_FLOOR of
    ``scale`` (a leaf's largest magnitude, or the number itself)."""
    return BF16_C * own + BF16_FLOOR * scale


def _ref_value_and_grad(monkeypatch, jb, jparams, batch, dtype):
    """The reference's loss and gradient leaves with ``dtype`` activations."""
    with monkeypatch.context() as m:
        if dtype == jnp.float32:
            _f32_activations(m, (jax_transformer, jax_mamba2, jax_griffin), dtype)
        loss, grads = jax.value_and_grad(jb.loss)(
            jparams, jax.tree_util.tree_map(jnp.asarray, batch))
    return float(loss), _jax_leaves(grads)


def check_bf16_loss_and_grads(monkeypatch, arch, jb, jparams, tb, tparams, batch):
    """bundle.loss and every gradient leaf of the port (bf16 activations)
    against the reference's bf16 ones by the module docstring's rule."""
    l16, g16 = _ref_value_and_grad(monkeypatch, jb, jparams, batch, jnp.bfloat16)
    l32, g32 = _ref_value_and_grad(monkeypatch, jb, jparams, batch, jnp.float32)
    leaves, structure = tree_flatten(tparams)
    ws = [p.clone().requires_grad_(True) for p in leaves]
    loss = tb.loss(tree_unflatten(structure, ws),
                   {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, ws, allow_unused=True,
                                materialize_grads=True)
    assert abs(float(loss.detach()) - l16) <= _bf16_bound(abs(l16 - l32), abs(l16))
    assert len(grads) == len(g16) == len(g32)
    for i, (g, w, w32) in enumerate(zip(grads, g16, g32)):
        assert g.shape == w.shape and g.dtype == torch.float32, i
        scale = max(float(np.abs(w).max()), 1e-30)
        own = float(np.abs(w - w32).max())
        err = float(np.abs(_np(g) - w).max())
        assert err <= _bf16_bound(own, scale), (arch, i, err, own, scale)


_SPIED = {"transformer": ((jax_transformer, "chunked_attention"),
                          (kops, "flash_attention")),
          "mamba2": ((jax_mamba2, "ssd_chunked"), (kops, "ssd")),
          "griffin": ((jax_attention, "chunked_attention"),
                      (kops, "flash_attention"))}


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-1.3b", "recurrentgemma-9b"])
def test_loss_runs_bf16_activations_like_the_reference(arch, monkeypatch):
    """Inside bundle.loss, and its gradient, attention (K1) and the SSD (K4)
    receive bf16 activations in both packages: spies on the calls record the
    dtype of their first argument (q, or x)."""
    jb, jparams, tb, tparams = _both(arch)
    batch = _batch(tb.cfg)
    (ref_mod, ref_name), (port_mod, port_name) = _SPIED[tb.family]
    seen = {"ref": [], "port": []}

    def spy(side, fn):
        def wrapped(*args, **kw):
            seen[side].append(str(args[0].dtype).replace("torch.", ""))
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(ref_mod, ref_name, spy("ref", getattr(ref_mod, ref_name)))
    monkeypatch.setattr(port_mod, port_name, spy("port", getattr(port_mod, port_name)))
    jax.value_and_grad(jb.loss)(jparams, jax.tree_util.tree_map(jnp.asarray, batch))
    leaves, structure = tree_flatten(tparams)
    ws = [p.clone().requires_grad_(True) for p in leaves]
    loss = tb.loss(tree_unflatten(structure, ws),
                   {k: torch.as_tensor(v) for k, v in batch.items()})
    torch.autograd.grad(loss, ws, allow_unused=True)
    assert seen["ref"] and set(seen["ref"]) == {"bfloat16"}, seen
    assert seen["port"] and set(seen["port"]) == {"bfloat16"}, seen


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_and_every_grad_leaf_match_reference(arch, monkeypatch):
    jb, jparams, tb, tparams = _both(arch)
    check_bf16_loss_and_grads(monkeypatch, arch, jb, jparams, tb, tparams,
                              _batch(tb.cfg))


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


@pytest.mark.usefixtures("_f32_reference", "_f32_port")
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


def check_bf16_train_steps(monkeypatch, jb, jparams, tb, tparams, compression):
    """Three steps of ``make_train_step`` (bf16 activations) against the
    reference's chain in bf16 and in float32 (its own bf16 gap): the loss
    and grad norm of each step and, per leaf, the params' max and mean
    distance after the three steps (in units of lr) by the module
    docstring's rule; the port's params equal the reference's compress +
    AdamW applied to the port's own gradients to 1e-6."""
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
        return float(m["grad_norm"])

    ref = {dt: jax_state(jparams) for dt in (jnp.bfloat16, jnp.float32)}
    chain = jax_state(jparams)       # the reference's chain on the port's grads
    vg = {dt: jax.jit(jax.value_and_grad(jb.loss)) for dt in ref}
    treedef = jax.tree_util.tree_structure(jparams)
    data = SyntheticTokens(DataConfig(vocab=tb.cfg.vocab, batch=2, seq_len=32))
    trail = []                       # per step: (port, ref bf16, ref float32)
    for step in range(3):
        batch = data.batch_at(step)
        got = {}
        for dt, s in ref.items():
            with monkeypatch.context() as m:
                if dt == jnp.float32:
                    _f32_activations(m, (jax_transformer, jax_mamba2, jax_griffin), dt)
                loss, g = vg[dt](s["params"], jax.tree_util.tree_map(jnp.asarray, batch))
            got[dt] = (float(loss), jax_step(s, g))
        pg, _ = _port_grads(tb, state["params"], batch)
        jax_step(chain, jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(_np(g)) for g in pg]))
        state, m = step_fn(state, batch)
        trail.append([(float(m[key]), got[jnp.bfloat16][i], got[jnp.float32][i])
                      for i, key in enumerate(("loss", "grad_norm"))])
    # the loss and the grad norm: the reference's own relative gap is taken
    # over the three steps (a single step's can be small by chance: 0.27,
    # 0.28, then 3.2e-3 on llama3-8b's grad norm)
    for i in range(2):
        own = max(abs(r16 - r32) / abs(r16) for r16, r32 in
                  ((row[i][1], row[i][2]) for row in trail))
        for step, (x, r16, _) in enumerate(row[i] for row in trail):
            assert abs(x - r16) <= _bf16_bound(own * abs(r16), abs(r16)), \
                (step, i, x, r16, own)
    lr = kw["lr"]
    leaves = [_jax_leaves(s["params"]) for s in (ref[jnp.bfloat16], ref[jnp.float32])]
    for a, b, c in zip(_leaves(state["params"]), *leaves):
        for norm, floor in ((np.max, BF16_STEP_FLOOR), (np.mean, BF16_FLOOR)):
            err, own = norm(np.abs(a - b)) / lr, norm(np.abs(b - c)) / lr
            assert err <= BF16_C * own + floor, (norm.__name__, err, own)
    for a, b in zip(_leaves(state["params"]), _jax_leaves(chain["params"])):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("compression", [False, True])
def test_three_bf16_train_steps_match_reference(compression, monkeypatch):
    jb, jparams, tb, tparams = _both("llama3-8b")
    check_bf16_train_steps(monkeypatch, jb, jparams, tb, tparams, compression)


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
