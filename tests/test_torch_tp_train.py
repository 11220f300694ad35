"""Tensor-parallel training of the dense transformers, on the CPU.

``make_train_step`` on meshes of data 1 x model 2, 1 x 4 and 2 x 2, one
gloo process a device (``_torch_dist_workers.tp_train_case``, the three
meshes started at once while this process runs the references), with int8
gradient compression and float32 activations in both packages (every
``embed_tokens``), so the comparison is the algorithm's.  The state is
stored FSDP x TP under ``param_pspecs``.  The cases cover what the policy
and the region do to a gradient: kv heads over "model" (llama3-8b at model
2), Command-R's parallel block and tied embedding (the head is the
embedding's vocabulary block), heads that do not divide the axis and run
whole on every rank (deepseek-coder-33b's 7, internvl2-1b's 7 with its
modality prefix), Gemma-2's soft-caps (the final one in the loss), window
and post-norms, StableLM's partial RoPE and MHA, a vocabulary that does
not divide the axis (511) with a sequence that does not either (15: hidden
replicated), and on 2 x 2 FSDP with rows that count different numbers of
tokens and a batch of 3 that "data" does not divide (every dp rank runs
it whole).

The weights are the reference's init (``params_from_jax``) on
unit-variance attention scores (``unit_scores``, as
tests/test_torch_tp_serve.py: on the init's near-argmax scores float32
reassociation between two correct computations reaches 5.6e-5 of a
gradient leaf's max on gemma2-9b at model 4, and 1e-4 of the grad norm on
command-r at model 2, before any int8 step).  Each case holds:

* against the one-process port: the step-0 loss and grad norm at 1e-5
  (relative) and every gradient leaf, gathered whole, at 1e-5 of its max;
* against the reference's ``jax.value_and_grad(bundle.loss)`` on the same
  weights: the loss at 1e-5 and each leaf at 1e-4 of its max (2e-4 on
  gemma2, as tests/test_torch_training.py);
* three steps with int8 gradients at lr 1e-4 against the one-process
  port's, by the rule of test_three_train_steps_match_reference: the
  losses at 1e-5, the params within 3 lr and at most one element in 10^4
  over 1e-5;
* each rank's blocks of the state (params, AdamW's moments, the residual)
  are exactly ``local_slices`` of the gathered state under
  ``param_pspecs``.

Also: the compression of a rank's block equals the global leaf's
``compress_grads_int8`` bit for bit (codes, scales, the decompressed
gradient and the residual) on leaves whose rows the mesh splits, with
each row's largest magnitude on one rank only; a 2 x 2 checkpoint (the
whole tree) restores in one process and through the reference's
``restore``; ``launch/train.py --mesh-model 2``, and ``--mesh-data 2``, in
two processes, killed at step 4 and resumed, gives the uninterrupted run's
losses and checkpoint.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as jax_transformer
from repro.checkpoint import restore as jax_restore
from repro.configs import get_reduced as jax_get_reduced
from repro.models.api import bundle_for as jax_bundle_for
from repro_torch.checkpoint import latest_step, restore
from repro_torch.configs import get_reduced
from repro_torch.distributed import param_pspecs
from repro_torch.kernels import ops
from repro_torch.models import griffin, mamba2, transformer
from repro_torch.models.api import bundle_for
from repro_torch.models.common import tree_flatten, tree_map, tree_unflatten
from repro_torch.models.convert import params_from_jax
from repro_torch.training import (AdamWConfig, TrainStepConfig,
                                  compress_grads_int8, make_train_step)

import _torch_dist_workers as workers

TOL = 1e-5
REF_TOL = {"gemma2-9b": 2e-4}            # of each leaf's max; 1e-4 elsewhere
LR = workers.TRAIN_OPT["lr"]
# mesh: [(case id, arch, batch, sequence, vocab)]
MESHES = {
    (1, 2): [("kv-heads", "llama3-8b", 2, 16, None),
             ("parallel-block-tied", "command-r-plus-104b", 2, 16, None),
             ("whole-heads", "deepseek-coder-33b", 2, 16, None),
             ("vocab-511-ragged", "llama3-8b", 2, 15, 511)],
    (1, 4): [("softcap-window", "gemma2-9b", 2, 24, None),
             ("prefix-whole-heads", "internvl2-1b", 2, 24, None),
             ("partial-rope-mha", "stablelm-3b", 2, 16, None)],
    (2, 2): [("token-counts", "llama3-8b", 4, 16, None),
             ("batch-whole", "command-r-plus-104b", 3, 16, None)],
}
CASES = [(m, c[0]) for m, cases in MESHES.items() for c in cases]
IDS = [f"{m[0]}x{m[1]}-{c}" for m, c in CASES]


def _cfgs(arch, vocab):
    t, j = get_reduced(arch), jax_get_reduced(arch)
    if vocab:
        t, j = dataclasses.replace(t, vocab=vocab), dataclasses.replace(j, vocab=vocab)
    return t, j


def _batches(cfg, b, s, seed):
    """Three seeded batches; the second half of the rows mask 4 labels."""
    rng = np.random.default_rng(seed)
    pre = cfg.prefix_tokens
    out = []
    for _ in range(3):
        labels = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
        labels[b // 2:, 3:7] = -1
        batch = {"tokens": rng.integers(0, cfg.vocab, (b, s - pre), dtype=np.int32),
                 "labels": labels}
        if pre:
            batch["prefix_embeds"] = rng.standard_normal((b, pre, cfg.prefix_dim),
                                                         dtype=np.float32)
        out.append(batch)
    return out


def _case(i, arch, b, s, vocab, tmp, ckpt):
    """The reference's init on unit-variance scores, in both packages; the
    port's saved for the workers."""
    cfg, jcfg = _cfgs(arch, vocab)
    jparams = jax_bundle_for(arch, jcfg).init(jax.random.PRNGKey(i), jnp.float32)
    whole = workers.unit_scores(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu"), cfg)
    torch.save(whole, tmp / f"whole{i}.pt")
    batches = [{k: torch.as_tensor(v) for k, v in bt.items()}
               for bt in _batches(cfg, b, s, 200 + i)]
    return dict(arch=arch, cfg=cfg, jcfg=jcfg, batches=batches,
                whole=f"whole{i}.pt", ckpt=ckpt), whole


def _one_process(case, whole):
    """Step-0 loss and gradients, then three int8 steps, of the one-process
    port (float32 activations)."""
    bundle = bundle_for(case["arch"], case["cfg"])
    leaves, structure = tree_flatten(whole)
    ws = [p.clone().requires_grad_(True) for p in leaves]
    loss = bundle.loss(tree_unflatten(structure, ws), case["batches"][0])
    grads = torch.autograd.grad(loss, ws, allow_unused=True, materialize_grads=True)
    step_fn, init_state = make_train_step(bundle, TrainStepConfig(
        opt=AdamWConfig(**workers.TRAIN_OPT), grad_compression=True), "cpu")
    state = init_state(params=tree_map(torch.clone, whole))
    out = {"loss0": float(loss.detach()), "grads": list(grads), "loss": [], "grad_norm": []}
    for batch in case["batches"]:
        state, m = step_fn(state, batch)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    out["state"] = state
    return out


def _reference(case, whole):
    """``jax.value_and_grad`` of the reference's loss on the same weights
    and batch, float32 activations."""
    jb = jax_bundle_for(case["arch"], case["jcfg"])
    params = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), whole)
    batch = {k: jnp.asarray(v.numpy()) for k, v in case["batches"][0].items()}
    loss, grads = jax.value_and_grad(jb.loss)(params, batch)
    return float(loss), [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per mesh and case: the ranks' results, the one-process port's and
    the reference's (float32 activations in both packages, restored
    after)."""
    saved = [(m, m.embed_tokens) for m in (transformer, mamba2, griffin,
                                           jax_transformer)]
    workers.f32_activations()
    jax_transformer.embed_tokens = functools.partial(
        jax_transformer.embed_tokens, compute_dtype=jnp.float32)
    try:
        started, out = {}, {}
        for mesh, specs in MESHES.items():
            tmp = tmp_path_factory.mktemp(f"tptrain{mesh[0]}x{mesh[1]}")
            cases = [_case(i, *spec[1:], tmp, ckpt=mesh == (2, 2) and i == 0)
                     for i, spec in enumerate(specs)]
            started[mesh] = (tmp, cases, workers.start(
                workers.tp_train_case, mesh[0] * mesh[1], tmp, mesh[0], mesh[1],
                [c for c, _ in cases]))
        for mesh, specs in MESHES.items():
            sizes = {"data": mesh[0], "model": mesh[1]}
            out[mesh] = {}
            for (cid, *_), (case, whole) in zip(specs, started[mesh][1]):
                out[mesh][cid] = dict(case=case, whole=whole, sizes=sizes,
                                      tmp=started[mesh][0],
                                      port=_one_process(case, whole),
                                      ref=_reference(case, whole))
        for mesh, specs in MESHES.items():
            tmp, _, procs = started[mesh]
            ranks = workers.finish(procs, tmp)
            for i, (cid, *_) in enumerate(specs):
                out[mesh][cid]["ranks"] = [(r["coord"], r["cases"][i]) for r in ranks]
        yield out
    finally:
        for mod, fn in saved:
            mod.embed_tokens = fn


def _rel_leaves(got, want):
    """The largest max |got - want| / max |want| over paired leaves."""
    return max(float(np.abs(np.asarray(a) - np.asarray(b)).max()
                     / max(float(np.abs(np.asarray(b)).max()), 1e-30))
               for a, b in zip(got, want))


@pytest.mark.parametrize("mesh,cid", CASES, ids=IDS)
def test_step0_loss_and_grads_match_one_process(runs, mesh, cid):
    r = runs[mesh][cid]
    port = r["port"]
    for _, out in r["ranks"]:
        np.testing.assert_allclose(out["loss0"], port["loss0"], rtol=TOL)
        np.testing.assert_allclose(out["loss"][0], port["loss"][0], rtol=TOL)
        np.testing.assert_allclose(out["grad_norm"][0], port["grad_norm"][0],
                                   rtol=TOL)
        grads = tree_flatten(out["grads"])[0]
        assert [g.shape for g in grads] == [g.shape for g in port["grads"]]
        assert _rel_leaves(grads, port["grads"]) <= TOL


@pytest.mark.parametrize("mesh,cid", CASES, ids=IDS)
def test_step0_loss_and_grads_match_reference(runs, mesh, cid):
    r = runs[mesh][cid]
    loss, grads = r["ref"]
    tol = REF_TOL.get(r["case"]["arch"], 1e-4)
    for _, out in r["ranks"]:
        np.testing.assert_allclose(out["loss0"], loss, rtol=TOL)
        assert _rel_leaves(tree_flatten(out["grads"])[0], grads) <= tol


@pytest.mark.parametrize("mesh,cid", CASES, ids=IDS)
def test_three_int8_steps_match_one_process(runs, mesh, cid):
    r = runs[mesh][cid]
    port = r["port"]
    want = tree_flatten(port["state"]["params"])[0]
    for _, out in r["ranks"]:
        np.testing.assert_allclose(out["loss"], port["loss"], rtol=TOL)
        over = total = 0
        for a, b in zip(tree_flatten(out["whole"]["params"])[0], want):
            err = (a - b).abs()
            assert float(err.max()) <= 3 * LR
            over += int((err > TOL).sum())
            total += err.numel()
        assert over <= total * 1e-4, (over, total)


@pytest.mark.parametrize("mesh,cid", CASES, ids=IDS)
def test_state_blocks_are_local_slices(runs, mesh, cid):
    """Each rank's blocks of params, mu, nu and residual are its
    ``local_slices`` of the gathered whole under ``param_pspecs``; the
    ranks gathered the same whole."""
    r = runs[mesh][cid]
    sizes = r["sizes"]
    workers.check_local_slices(r["ranks"], param_pspecs(
        bundle_for(r["case"]["arch"], r["case"]["cfg"]).param_specs(torch.float32),
        sizes), sizes)


def test_checkpoint_of_a_2x2_mesh_restores_in_one_process_and_in_the_reference(runs):
    r = runs[(2, 2)]["token-counts"]
    ckpt = r["tmp"] / "ckpt"
    assert latest_step(ckpt) == 3
    whole = r["ranks"][0][1]["whole"]
    like = {"params": whole["params"], "residual": whole["residual"],
            "opt": {"mu": whole["mu"], "nu": whole["nu"],
                    "step": torch.zeros((), dtype=torch.int32)}}
    got = restore(ckpt, 3, like, "cpu")
    assert int(got["opt"]["step"]) == 3
    for key in ("params", "residual"):
        for a, b in zip(tree_flatten(got[key])[0], tree_flatten(whole[key])[0]):
            assert torch.equal(a, b), key
    for key in ("mu", "nu"):
        for a, b in zip(tree_flatten(got["opt"][key])[0], tree_flatten(whole[key])[0]):
            assert torch.equal(a, b), key
    ref = jax_restore(ckpt, 3, jax.tree_util.tree_map(lambda t: np.asarray(t.numpy()),
                                                      like))
    for a, b in zip(jax.tree_util.tree_leaves(ref["params"]),
                    tree_flatten(whole["params"])[0]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# leaves of a 2 x 2 mesh whose rows the mesh splits: wi's ff over
# ("model", "data"), wq's head dim over data, a norm's single row replicated
COMPRESS_LEAVES = [((2, 6, 16), (None, None, ("model", "data"))),
                   ((2, 6, 4, 8), (None, None, "model", ("data",))),
                   ((12, 8), ("model", ("data",))),
                   ((16,), (None,))]


def test_sharded_compression_is_the_global_compression_bit_for_bit(tmp_path):
    rng = np.random.default_rng(5)
    leaves = []
    for shape, spec in COMPRESS_LEAVES:
        g = rng.standard_normal(shape).astype(np.float32)
        flat = g.reshape(-1, shape[-1])
        # each row's largest magnitude on one piece only, 10x the rest
        cols = rng.integers(0, shape[-1], flat.shape[0])
        flat[np.arange(flat.shape[0]), cols] *= 10.0
        r = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
        leaves.append((torch.as_tensor(g), torch.as_tensor(r), spec))
    ranks = workers.run(workers.compress_case, 4, tmp_path, leaves)
    split = 0
    for i, (g, r, _) in enumerate(leaves):
        deq, res = compress_grads_int8([g], [r.clone()])
        flat = (g + r).reshape(-1, g.shape[-1])
        q, scale = ops.quantize_int8(flat)
        rows = torch.arange(flat.shape[0]).reshape(g.shape[:-1] or (1,))
        for out in (rank[i] for rank in ranks):
            sl = out["slices"]
            assert torch.equal(out["deq"], deq[0][sl]), i
            assert torch.equal(out["residual"], res[0][sl]), i
            local_rows = rows[sl[:-1]].reshape(-1) if g.ndim > 1 else rows
            assert torch.equal(out["q"], q[local_rows][:, sl[-1]]), i
            assert torch.equal(out["scale"], scale[local_rows]), i
            split += out["split"]
    assert split == 4 * 3                    # every rank split the first three


def _kill_and_resume(tmp_path, mesh_flag):
    """``launch/train.py`` in two processes with ``mesh_flag`` (a mesh axis
    of 2): killed at step 4 and resumed from its checkpoint, against the
    uninterrupted run's losses and final checkpoint."""
    argv = ["--device", "cpu", mesh_flag, "2", "--steps", "8", "--batch",
            "2", "--seq", "32", "--ckpt-every", "4", "--log-every", "100",
            "--grad-compression"]
    for d in ("full", "drill", "resume"):
        (tmp_path / d).mkdir()
    full = workers.start(workers.train_launch_case, 2, tmp_path / "full",
                         argv + ["--ckpt-dir", str(tmp_path / "ckpt_full")])
    killed = workers.run(workers.train_launch_case, 2, tmp_path / "drill",
                         argv + ["--ckpt-dir", str(tmp_path / "ckpt_drill"),
                                 "--kill-at-step", "4"])
    assert [k["exit"] for k in killed] == [42, 42]
    assert latest_step(tmp_path / "ckpt_drill") == 4
    resumed = workers.run(workers.train_launch_case, 2, tmp_path / "resume",
                          argv + ["--ckpt-dir", str(tmp_path / "ckpt_drill")])
    whole = workers.finish(full, tmp_path / "full")
    for a, b in zip(resumed, whole):
        assert a["result"]["steps_run"] == 4 and b["result"]["steps_run"] == 8
        assert a["result"]["losses"] == b["result"]["losses"][4:]
    one, two = (np.load(tmp_path / d / "step_000000008" / "arrays.npz")
                for d in ("ckpt_full", "ckpt_drill"))
    assert sorted(one.files) == sorted(two.files)
    for key in one.files:
        np.testing.assert_array_equal(one[key], two[key], err_msg=key)


def test_train_driver_kill_and_resume_on_a_model_axis_of_two(tmp_path):
    _kill_and_resume(tmp_path, "--mesh-model")


def test_train_driver_kill_and_resume_on_a_data_axis_of_two(tmp_path):
    """The same on data 2 x model 1: the data-parallel step's state is
    stored FSDP as well, every rank calls the checkpoint's save and rank 0
    alone writes."""
    _kill_and_resume(tmp_path, "--mesh-data")
