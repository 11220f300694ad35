"""The port's train step and serving functions on a mesh, on the CPU.

Two gloo processes on a data 2 × model 1 mesh run three steps of the
reduced llama3-8b with int8 gradient compression on a batch whose ranks
count different numbers of tokens (rank 1's rows have masked labels), and
``make_serve_fns``' prefill and two decode steps.  They must equal the
one-process step on the whole batch and the one-process ``bundle.prefill``
/ ``bundle.decode``: float32 activations on both sides, loss and logits
within 1e-5; the params within 1e-5 but where an int8 code rounds the
other way at a tie (the rule of tests/test_torch_training.py's three
steps: at most one element in 10^4 over 1e-5, none over 3 lr).  Both ranks
hold the same params and int8 residual bit for bit (every rank compresses
the one all-reduced gradient).  The residual is not held against the
one-process run element by element: where a row's gradient is 0 (a token
absent from the batch) the row quantizes its own residual, whose codes sit
at rounding ties, so a last-bit difference moves an element by a whole
quantization step; the params, which the compressed gradient moves, are
held.  A model axis of 2 raises.  In one
process a 1 × 1 mesh runs the mesh-less step and serving calls, bit for
bit, and a mesh larger than the process group raises as the reference's
does.
"""

import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_bundle
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.launch.mesh import make_production_mesh, make_small_mesh
from repro_torch.models import griffin, mamba2, transformer
from repro_torch.models.api import ShapeSpec
from repro_torch.models.common import tree_flatten, tree_map
from repro_torch.training import (AdamWConfig, TrainStepConfig, make_serve_fns,
                                  make_train_step)

import _torch_dist_workers as workers

TOL = 1e-5
OPT = dict(lr=1e-4, warmup_steps=2, total_steps=20)


@pytest.fixture
def _f32_port(monkeypatch):
    for mod in (transformer, mamba2, griffin):
        monkeypatch.setattr(mod, "embed_tokens", functools.partial(
            mod.embed_tokens, compute_dtype=torch.float32))


@pytest.fixture
def one_process_group():
    """The one-process group ``make_small_mesh(1, 1)`` makes, torn down
    after the test (unless the process had one before)."""
    had = dist.is_initialized()
    yield
    if dist.is_initialized() and not had:
        dist.destroy_process_group()


def _params(bundle, seed=0):
    return bundle.init(torch.Generator().manual_seed(seed), "cpu", torch.float32)


def _batches(vocab, n=3, b=4, s=16):
    """Seeded batches whose rows 2-3 (rank 1's) mask 5 labels a row."""
    data = SyntheticTokens(DataConfig(vocab=vocab, batch=b, seq_len=s, seed=3))
    out = []
    for i in range(n):
        batch = {k: torch.as_tensor(v) for k, v in data.batch_at(i).items()}
        batch["labels"][2:, 3:8] = -1
        out.append(batch)
    return out


def _hold_params(got, want, lr):
    """tests/test_torch_training.py's rule for steps with compression."""
    over = total = 0
    for a, b in zip(tree_flatten(got)[0], tree_flatten(want)[0]):
        err = (a - b).abs()
        assert float(err.max()) <= 3 * lr
        over += int((err > TOL).sum())
        total += err.numel()
    assert over <= total * 1e-4, (over, total)


def _close(a, b):
    np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=TOL, rtol=TOL)


@pytest.mark.usefixtures("_f32_port")
def test_data_parallel_step_and_serve_fns_on_two_processes(tmp_path):
    bundle = get_bundle("llama3-8b", reduced=True)
    params, serve_params = _params(bundle), _params(bundle, seed=5)
    torch.save(params, tmp_path / "params.pt")
    torch.save(serve_params, tmp_path / "serve_params.pt")
    batches = _batches(bundle.cfg.vocab)
    rng = np.random.default_rng(11)
    toks = torch.as_tensor(rng.integers(0, bundle.cfg.vocab, (4, 12), dtype=np.int32))
    nxt = [torch.as_tensor(rng.integers(0, bundle.cfg.vocab, (4,), dtype=np.int32))
           for _ in range(2)]
    _, cache0 = bundle.prefill(serve_params, {"tokens": toks}, 14)
    serve = {"tokens": toks, "cache": tree_map(torch.clone, cache0), "next": nxt}
    ranks = workers.run(workers.mesh_step_case, 2, tmp_path, OPT, batches, serve)

    # the one-process references
    step_fn, init_state = make_train_step(bundle, TrainStepConfig(
        opt=AdamWConfig(**OPT), grad_compression=True), "cpu")
    state = init_state(params=tree_map(torch.clone, params))
    losses, gnorms = [], []
    for batch in batches:
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    logits, pcache = bundle.prefill(serve_params, {"tokens": toks})
    dec, cache = [], cache0
    for i, tok in enumerate(nxt):
        dl, cache = bundle.decode(serve_params, cache, tok, 12 + i)
        dec.append(dl)

    counted = [int((b["labels"][r] >= 0).sum()) for b in batches[:1] for r in (0, 2)]
    assert counted[0] != counted[1]
    for out in ranks:
        np.testing.assert_allclose(out["loss"], losses, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(out["grad_norm"], gnorms, rtol=TOL)
        _hold_params(out["params"], state["params"], OPT["lr"])
        _close(out["prefill"], logits)
        for k in ("k", "v"):
            _close(out["prefill_cache"][k], pcache["blocks"][k])
            _close(out["decode_cache"][k], cache["blocks"][k])
        for a, b in zip(out["decode"], dec):
            _close(a, b)
        assert out["tp_refused"] == [True, True]
    a, b = ranks
    assert a["loss"] == b["loss"]
    for name in ("params", "residual"):
        for x, y in zip(tree_flatten(a[name])[0], tree_flatten(b[name])[0]):
            assert torch.equal(x, y), name


@pytest.mark.usefixtures("one_process_group")
def test_one_device_mesh_is_the_mesh_less_step_bit_for_bit():
    bundle = get_bundle("llama3-8b", reduced=True)
    mesh = make_small_mesh(1, 1, device_type="cpu")
    cfg = TrainStepConfig(opt=AdamWConfig(**OPT), grad_compression=True)
    runs = []
    for m in (None, mesh):
        step_fn, init_state = make_train_step(bundle, cfg, "cpu", mesh=m)
        state = init_state(params=_params(bundle))
        losses = [float(step_fn(state, b)[1]["loss"])
                  for b in _batches(bundle.cfg.vocab)]
        runs.append((losses, tree_flatten(state["params"])[0]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(x, y) for x, y in zip(runs[0][1], runs[1][1]))

    params = _params(bundle, seed=5)
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, bundle.cfg.vocab, (2, 12), dtype=np.int32))
    fn, ispecs = make_serve_fns(bundle, mesh, ShapeSpec("p", 12, 2, "prefill"), "cpu")
    assert tuple(ispecs["tokens"].shape) == (2, 12)
    got, _ = fn(params, {"tokens": toks})
    want, cache = bundle.prefill(params, {"tokens": toks}, 16)
    assert torch.equal(got.to_local(), want)
    dfn, _ = make_serve_fns(bundle, mesh, ShapeSpec("d", 16, 2, "decode"), "cpu")
    mine = tree_map(torch.clone, cache)
    tok = toks[:, -1]
    got, mine = dfn(params, mine, tok, 12)
    want, cache = bundle.decode(params, cache, tok, 12)
    assert torch.equal(got.to_local(), want)
    assert torch.equal(mine["blocks"]["k"].to_local(), cache["blocks"]["k"])


def test_mesh_larger_than_the_process_group_raises():
    if dist.is_initialized():
        have = dist.get_world_size()
    else:
        have = 1
    with pytest.raises(RuntimeError, match=f"need 4 devices for mesh \\(2, 2\\); have {have}"):
        make_small_mesh(2, 2, device_type="cpu")
    with pytest.raises(RuntimeError, match="need 256 devices for mesh \\(16, 16\\)"):
        make_production_mesh(device_type="cpu")
