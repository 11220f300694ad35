"""Mamba-2 and Griffin training in the port against the reference, on the CPU.

The backward kernels' plain versions (``ssd_bwd_plain``, ``rglru_bwd_plain``:
the formulas K4's and K5's backward kernels compute) against autograd of
the port's plain forwards and ``jax.vjp`` of the reference's model
functions (``repro.models.mamba2.ssd_chunked``, ``repro.models.griffin.
rglru``); ``bundle.loss`` and every gradient leaf of reduced mamba2-1.3b and
recurrentgemma-9b against ``jax.value_and_grad`` of the reference's loss;
three train steps of each family against the reference's chain, with
int8 gradients off and on; ``launch/train.main`` on each family, killed
and resumed.

Weights come from the reference's ``init`` through ``params_from_jax``.
Both packages' losses embed tokens in bf16 and scan in float32 inside (the
reference's ``ssd_chunked`` casts x, B and C to float32; ``_lru_gates``
gives the RG-LRU float32 inputs), as the port's K4 and K5 do.  The bf16
tests compare the two packages as they train, by the rule of
tests/test_torch_training.py (``BF16_C`` times the reference's own
bf16-vs-float32 gap plus ``BF16_FLOOR``); the float32 tests set both
packages' ``embed_tokens`` compute dtype to float32 (``_f32_reference`` and
the port-side twin ``_f32_port``) and compare like with like.

Tolerances: the plain backward versions 1e-5 of each output's largest
magnitude (float32, sums in other orders); the loss 1e-5 relative and each
gradient leaf 1e-4 of its largest magnitude; three train steps at lr 1e-4
as the transformer's (``tests/test_torch_training.py``): the params within
1e-6 of the reference's compress + AdamW applied to the port's own
gradients, within 1e-5 of the reference's own run (with compression at
most one element in 10^4 beyond it, none beyond 3 lr: an int8 code at a
rounding tie may flip).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_bundle as jax_get_bundle
from repro.models import griffin as jax_griffin
from repro.models import mamba2 as jax_mamba2
from repro.training import AdamWConfig as JaxAdamWConfig
from repro.training import adamw_init as jax_adamw_init
from repro.training import adamw_update as jax_adamw_update
from repro.training import compress_grads_int8 as jax_compress
from repro_torch.checkpoint import latest_step
from repro_torch.configs import get_bundle
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.kernels import rglru as k5
from repro_torch.kernels import ssd_chunk as k4
from repro_torch.launch import train
from repro_torch.models.common import tree_flatten, tree_unflatten
from repro_torch.models.convert import params_from_jax
from repro_torch.training import AdamWConfig, TrainStepConfig, make_train_step
from test_torch_training import _f32_port  # noqa: F401 (a fixture)
from test_torch_training import check_bf16_loss_and_grads, check_bf16_train_steps

ARCHS = ("mamba2-1.3b", "recurrentgemma-9b")


@pytest.fixture
def _f32_reference(monkeypatch):
    """The reference's Mamba-2 and Griffin losses with float32 activations."""
    for mod in (jax_mamba2, jax_griffin):
        monkeypatch.setattr(mod, "embed_tokens", functools.partial(
            mod.embed_tokens, compute_dtype=jnp.float32))


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(_np(got) - want).max() / max(np.abs(want).max(), 1e-30))


def _both(arch, seed=0):
    jb = jax_get_bundle(arch, reduced=True)
    jparams = jb.init(jax.random.PRNGKey(seed), jnp.float32)
    tb = get_bundle(arch, reduced=True)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tb.cfg, device="cpu")
    return jb, jparams, tb, tparams


# --------------------------------------------------------------------------- #
# the backward kernels' plain versions
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dt_scale", [1.0, 0.02], ids=["fast", "slow-decay"])
@pytest.mark.parametrize("with_dstate", [False, True])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("s", [37, 64])
def test_ssd_bwd_plain_matches_autograd_and_reference_vjp(s, g, with_state,
                                                          with_dstate, dt_scale):
    """``slow-decay`` scales dt so that e^{cums} stays near 1 across a chunk
    and the carried-state terms weigh as much as the in-chunk ones."""
    b, h, n, p, chunk = 2, 4, 8, 8, 16
    rng = np.random.default_rng(s + 10 * g)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32) * 0.5
    dt = dt_scale * np.log1p(np.exp(rng.standard_normal((b, s, h), dtype=np.float32)))
    a = -np.exp(np.linspace(0.0, 1.0, h, dtype=np.float32))
    bm = rng.standard_normal((b, s, g, n), dtype=np.float32) * 0.3
    cm = rng.standard_normal((b, s, g, n), dtype=np.float32) * 0.3
    st = rng.standard_normal((b, h, n, p), dtype=np.float32) if with_state else None
    dy = rng.standard_normal((b, s, h, p), dtype=np.float32)
    ds = rng.standard_normal((b, h, n, p), dtype=np.float32) if with_dstate \
        else np.zeros((b, h, n, p), np.float32)
    ins = [x, dt, a, bm, cm] + ([st] if with_state else [])

    got = k4.ssd_bwd_plain(*map(torch.tensor, (x, dt, a, bm, cm, dy)), chunk=chunk,
                           state_in=None if st is None else torch.tensor(st),
                           dstate=torch.tensor(ds) if with_dstate else None)
    got = got if with_state else got[:5]

    ts = [torch.tensor(t, requires_grad=True) for t in ins]
    y, state = k4.ssd_plain(*ts[:5], chunk=chunk,
                            state_in=ts[5] if with_state else None,
                            return_state=True)
    auto = torch.autograd.grad((y * torch.tensor(dy)).sum()
                               + (state * torch.tensor(ds)).sum(), ts)

    def ref(*args):
        return jax_mamba2.ssd_chunked(*args[:5], chunk=chunk,
                                      state_in=args[5] if with_state else None,
                                      return_state=True)

    _, vjp = jax.vjp(ref, *map(jnp.asarray, ins))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    for name, mine, a_g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dstate_in"),
                                  got, auto, want):
        assert _rel(mine, w) <= 1e-5, (name, _rel(mine, w))
        assert _rel(mine, _np(a_g)) <= 1e-5, (name, _rel(mine, _np(a_g)))


@pytest.mark.parametrize("a_lo", [0.0, 0.98], ids=["sigmoid", "near-one"])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [1, 37, 130])
def test_rglru_bwd_plain_matches_autograd_and_reference_vjp(s, with_h0, a_lo):
    """``near-one`` puts a in (0.98, 1), so the carry reaches across the
    whole sequence."""
    b, w = 2, 24
    rng = np.random.default_rng(s)
    a = a_lo + (1.0 - a_lo) / (1.0 + np.exp(-rng.standard_normal((b, s, w),
                                                                 dtype=np.float32)))
    a = a.astype(np.float32)
    x = rng.standard_normal((b, s, w), dtype=np.float32)
    h0 = rng.standard_normal((b, w), dtype=np.float32) if with_h0 else None
    dy = rng.standard_normal((b, s, w), dtype=np.float32)
    ins = [a, x] + ([h0] if with_h0 else [])

    h = k5.rglru_plain(torch.tensor(a), torch.tensor(x),
                       None if h0 is None else torch.tensor(h0))
    got = k5.rglru_bwd_plain(torch.tensor(a), h, torch.tensor(dy),
                             None if h0 is None else torch.tensor(h0))
    got = got if with_h0 else got[:2]

    ts = [torch.tensor(t, requires_grad=True) for t in ins]
    auto = torch.autograd.grad(k5.rglru_plain(*ts), ts, torch.tensor(dy))
    _, vjp = jax.vjp(lambda *args: jax_griffin.rglru(*args), *map(jnp.asarray, ins))
    want = vjp(jnp.asarray(dy))
    for name, mine, a_g, wv in zip(("da", "dx", "dh0"), got, auto, want):
        assert _rel(mine, wv) <= 1e-5, (name, _rel(mine, wv))
        assert _rel(mine, _np(a_g)) <= 1e-5, (name, _rel(mine, _np(a_g)))


def test_rglru_bwd_plain_is_the_formula():
    """g_t = dy_t + a_{t+1} g_{t+1}, dx = g, da_t = g_t h_{t-1}, dh0 = a_0 g_0,
    written out step by step in float64."""
    rng = np.random.default_rng(3)
    a, x, dy = (rng.uniform(0.1, 0.9, (1, 6, 3)), rng.standard_normal((1, 6, 3)),
                rng.standard_normal((1, 6, 3)))
    h0 = rng.standard_normal((1, 3))
    h = np.zeros((1, 6, 3))
    prev = h0
    for t in range(6):
        prev = a[:, t] * prev + x[:, t]
        h[:, t] = prev
    g = np.zeros((1, 6, 3))
    for t in reversed(range(6)):
        g[:, t] = dy[:, t] + (a[:, t + 1] * g[:, t + 1] if t < 5 else 0.0)
    hprev = np.concatenate([h0[:, None], h[:, :-1]], 1)
    da, dx, dh0 = k5.rglru_bwd_plain(*(torch.tensor(v, dtype=torch.float32)
                                       for v in (a, h, dy, h0)))
    np.testing.assert_allclose(_np(dx), g, rtol=1e-6)
    np.testing.assert_allclose(_np(da), g * hprev, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(dh0), a[:, 0] * g[:, 0], rtol=1e-6)


# --------------------------------------------------------------------------- #
# bundle.loss and its gradients
# --------------------------------------------------------------------------- #
def _batch(cfg, b=2, s=40, seed=0):
    return SyntheticTokens(DataConfig(vocab=cfg.vocab, batch=b, seq_len=s,
                                      seed=seed)).batch_at(0)


@pytest.mark.usefixtures("_f32_reference", "_f32_port")
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_grad_leaf_match_reference(arch):
    """S = 40 runs three of reduced Mamba-2's chunks of 16 (the last
    ragged) and wraps reduced Griffin's window of 16."""
    jb, jparams, tb, tparams = _both(arch)
    batch = _batch(tb.cfg)
    jloss, jgrads = jax.value_and_grad(jb.loss)(
        jparams, jax.tree_util.tree_map(jnp.asarray, batch))
    leaves, structure = tree_flatten(tparams)
    ws = [p.clone().requires_grad_(True) for p in leaves]
    loss = tb.loss(tree_unflatten(structure, ws),
                   {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, ws)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jgrads)]
    assert len(want) == len(grads)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert g.shape == w.shape, i
        assert _rel(g, w) <= 1e-4, (arch, i, _rel(g, w))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_and_every_grad_leaf_match_reference(arch, monkeypatch):
    """bf16 activations on both sides, S = 40 as above."""
    jb, jparams, tb, tparams = _both(arch)
    check_bf16_loss_and_grads(monkeypatch, arch, jb, jparams, tb, tparams,
                              _batch(tb.cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_losses_checkpoint_blocks_and_leave_serving_alone(arch):
    """Under grad mode the blocks (Mamba-2) or groups (Griffin) are
    checkpointed, and a loss under ``torch.no_grad`` equals one with grad;
    every leaf gets a gradient."""
    bundle = get_bundle(arch, reduced=True)
    params = bundle.init(torch.Generator().manual_seed(1), "cpu", torch.float32)
    batch = {k: torch.as_tensor(v) for k, v in _batch(bundle.cfg, s=24).items()}
    leaves, structure = tree_flatten(params)
    ws = [p.clone().requires_grad_(True) for p in leaves]
    loss = bundle.loss(tree_unflatten(structure, ws), batch)
    with torch.no_grad():
        plain = bundle.loss(params, batch)
    assert float(loss.detach()) == pytest.approx(float(plain), rel=1e-6)
    grads = torch.autograd.grad(loss, ws)
    assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads)


# --------------------------------------------------------------------------- #
# whole steps
# --------------------------------------------------------------------------- #
@pytest.mark.usefixtures("_f32_reference", "_f32_port")
@pytest.mark.parametrize("compression", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_reference(arch, compression):
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

    jstate, chain = jax_state(jparams), jax_state(jparams)
    vg = jax.jit(jax.value_and_grad(jb.loss))
    data = SyntheticTokens(DataConfig(vocab=tb.cfg.vocab, batch=2, seq_len=32))
    treedef = jax.tree_util.tree_structure(jparams)
    for step in range(3):
        batch = data.batch_at(step)
        jloss, jg = vg(jstate["params"], jax.tree_util.tree_map(jnp.asarray, batch))
        jm = jax_step(jstate, jg)
        leaves, structure = tree_flatten(state["params"])
        ws = [p.detach().clone().requires_grad_(True) for p in leaves]
        pg = torch.autograd.grad(tb.loss(tree_unflatten(structure, ws), {
            k: torch.as_tensor(v) for k, v in batch.items()}), ws)
        jax_step(chain, jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(_np(g)) for g in pg]))
        state, m = step_fn(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-4)
    got = [_np(x) for x in tree_flatten(state["params"])[0]]
    for a, b in zip(got, jax.tree_util.tree_leaves(chain["params"])):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=1e-6)
    over, total = 0, 0
    for a, b in zip(got, jax.tree_util.tree_leaves(jstate["params"])):
        err = np.abs(a - np.asarray(b))
        if not compression:
            assert err.max() <= 1e-5
        assert err.max() <= 3 * kw["lr"]
        over += int((err > 1e-5).sum())
        total += err.size
    assert over <= total * 1e-4, (over, total)


@pytest.mark.parametrize("compression", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_three_bf16_train_steps_match_reference(arch, compression, monkeypatch):
    jb, jparams, tb, tparams = _both(arch)
    check_bf16_train_steps(monkeypatch, jb, jparams, tb, tparams, compression)


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_trains_each_family_and_round_trips_its_checkpoint(
        arch, tmp_path):
    """``launch/train.main`` on the family: killed at step 4 (exit 42) and
    resumed to 8, it lands on the uninterrupted run's loss and state bit
    for bit."""
    argv = ["--arch", arch, "--device", "cpu", "--steps", "8", "--batch", "2",
            "--seq", "32", "--ckpt-every", "4", "--log-every", "100",
            "--grad-compression", "--lr", "3e-3"]
    full = train.main(argv + ["--ckpt-dir", str(tmp_path / "full")])
    with pytest.raises(SystemExit) as exc:
        train.main(argv + ["--ckpt-dir", str(tmp_path / "drill"),
                           "--kill-at-step", "4"])
    assert exc.value.code == 42
    assert latest_step(tmp_path / "drill") == 4
    resumed = train.main(argv + ["--ckpt-dir", str(tmp_path / "drill")])
    assert resumed["steps_run"] == 4 and full["steps_run"] == 8
    assert resumed["last_loss"] == full["last_loss"]
    for sub in ("full", "drill"):
        assert latest_step(tmp_path / sub) == 8
    with np.load(tmp_path / "full" / "step_000000008" / "arrays.npz") as fa, \
            np.load(tmp_path / "drill" / "step_000000008" / "arrays.npz") as fb:
        assert sorted(fa.files) == sorted(fb.files)
        for key in fa.files:
            np.testing.assert_array_equal(fa[key], fb[key], err_msg=key)
    assert np.isfinite(full["last_loss"])


@pytest.mark.parametrize("arch", ARCHS + ("llama3-8b",))
def test_train_step_leaves_no_tensor_in_a_reference_cycle(arch):
    """A step's gradients are freed when the step returns, not when the
    garbage collector next runs: no tensor is left in cyclic garbage (the
    tree helpers once held every leaf they flattened in a closure cycle)."""
    import gc

    bundle = get_bundle(arch, reduced=True)
    step_fn, init_state = make_train_step(
        bundle, TrainStepConfig(grad_compression=True), "cpu")
    state = init_state(0)
    data = SyntheticTokens(DataConfig(vocab=bundle.cfg.vocab, batch=2, seq_len=32))
    state, _ = step_fn(state, data.batch_at(0))
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        state, _ = step_fn(state, data.batch_at(1))
        gc.collect()
        leaked = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.garbage.clear()
        gc.set_debug(0)
        gc.enable()
    assert leaked == []
